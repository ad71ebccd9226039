"""Box derivation utilities, host-side numpy (copy of
``gapro_tpu/labeler/boxes.py``).

Semantics follow the reference's per-scene preparation:
  * ``instance_info``      — gapro/gen_ps_utils.py:195-239 (`getInstanceInfo`)
  * ``floor_box``          — gapro/gen_ps_utils.py:317-326
  * ``wall_boxes_from_planes`` — gapro/scannet_planes.py:101-230
    (`get_box_from_quad` / `get_wall_boxes`): ScanNet plane-annotation quads
    filtered to coplanar vertical quads, each converted to an axis-aligned
    wall box labeled as background class.
"""

from __future__ import annotations

import numpy as np


def instance_info(xyz, instance_label, semantic_label, dataset_name="scannetv2",
                  with_corners=True):
    """Axis-aligned box, class, volume per GT instance + per-point corner offsets.

    Returns (num_instances, cls [K], boxes [K,6], volumes [K], corners [N,6])
    or None if no instances. For scannetv2, semantic ids get the -2 remap
    (classes 2..19 -> 0..17) the reference applies.

    ``with_corners=False`` skips the per-point corner-offset scatter and
    returns the all- -100 corners array (the labeler never reads corners).
    """
    xyz = np.asarray(xyz, np.float32)
    instance_label = np.asarray(instance_label)
    semantic_label = np.asarray(semantic_label)
    n_inst = int(instance_label.max()) + 1 if instance_label.size else 0
    corners = np.full((xyz.shape[0], 6), -100.0, dtype=np.float32)
    if n_inst <= 0:
        return None

    # one stable sort segments all instances at once (numpy uses radix
    # sort for stable integer sorts — O(N))
    fg = np.nonzero(instance_label >= 0)[0]
    il = instance_label[fg]
    order = np.argsort(il, kind="stable")
    idx_s = fg[order]
    il_s = il[order]
    bounds = np.searchsorted(il_s, np.arange(n_inst + 1))
    starts, ends = bounds[:-1], bounds[1:]
    nonempty = ends > starts
    if not nonempty.any():
        return None
    s_ne = starts[nonempty]
    pts_s = xyz[idx_s]
    # reduceat is only defined on non-empty segments; empty instances are
    # dropped from the lists exactly like the loop form did
    mins = np.minimum.reduceat(pts_s, s_ne, axis=0)
    maxs = np.maximum.reduceat(pts_s, s_ne, axis=0)
    if with_corners:
        # per-point corner offsets: broadcast each instance's box to its rows
        seg_of = np.cumsum(nonempty)[il_s] - 1  # row in mins/maxs per point
        corners[idx_s, :3] = mins[seg_of] - pts_s
        corners[idx_s, 3:] = maxs[seg_of] - pts_s

    cls = semantic_label[idx_s[s_ne]]  # first (original-order) point's sem
    boxes = np.concatenate([mins, maxs], axis=1).astype(np.float32)
    vols = np.prod(np.clip(maxs - mins, 0.0, None), axis=1).astype(np.float32)
    if dataset_name == "scannetv2":
        cls = cls.copy()
        cls[cls != -100] -= 2
    return n_inst, cls, boxes, vols, corners


def floor_box(coords, ground_h=0.1):
    """One background box covering the lowest `ground_h` slab of the scene."""
    mn = coords.min(0)
    mx = coords.max(0)
    box = np.array([mn[0], mn[1], mn[2], mx[0], mx[1], mn[2] + ground_h], np.float32)
    vol = float(np.prod(np.clip(box[3:] - box[:3], 1e-3, None)))
    return box[None, :], np.array([vol], np.float32)


def _quad_normal(quad_vert):
    """Normal of a quad via LS plane fit (z = ax + by + c), or vertical fit."""
    A = np.concatenate([quad_vert[:, :2], np.ones((4, 1))], axis=1)
    b = quad_vert[:, 2:3]
    AtA = A.T @ A
    if abs(np.linalg.det(AtA)) > 1e-10:
        fit = np.linalg.solve(AtA, A.T @ b).ravel()
        # plane: fit0*x + fit1*y + fit2 = z  ->  normal direction
        a_ = fit[0] / fit[2] if abs(fit[2]) > 1e-12 else fit[0] * 1e12
        b_ = fit[1] / fit[2] if abs(fit[2]) > 1e-12 else fit[1] * 1e12
        c_ = -1.0 / fit[2] if abs(fit[2]) > 1e-12 else -1e12
        n = np.array([a_, b_, c_])
    else:  # vertical plane: fit a*x + b*y + 1 = 0
        A2 = quad_vert[:, :2]
        b2 = -np.ones((4, 1))
        fit = np.linalg.lstsq(A2, b2, rcond=None)[0].ravel()
        n = np.array([fit[0], fit[1], 0.0])
    return n / max(np.linalg.norm(n), 1e-12)


def _coplanar(quad, err=100.0):
    s1, s2, s3 = quad[1] - quad[0], quad[2] - quad[0], quad[3] - quad[0]
    det = np.linalg.det(np.stack([s1, s2, s3]))
    return -err <= det <= err


def _box_from_quad(quad_vert):
    center = quad_vert.mean(0)
    n = _quad_normal(quad_vert)
    vn = np.array([n[0], n[1], 0.0])
    vn = vn / max(np.linalg.norm(vn), 1e-6)

    edge = quad_vert[0] - quad_vert[1]
    cos_theta = edge[2] / max(np.linalg.norm(edge), 1e-12)
    l1 = np.linalg.norm(quad_vert[0] - quad_vert[1])
    l2 = np.linalg.norm(quad_vert[1] - quad_vert[2])
    l3 = np.linalg.norm(quad_vert[2] - quad_vert[3])
    l4 = np.linalg.norm(quad_vert[3] - quad_vert[0])
    l5, l6 = (l1 + l3) / 2, (l2 + l4) / 2
    if abs(cos_theta) > 0.5:  # first edge is mostly vertical
        height, width = l5, l6
    else:
        height, width = l6, l5

    x1 = center[0] + width * vn[1] / 2
    x2 = center[0] - width * vn[1] / 2
    y1 = center[1] - width * vn[0] / 2
    y2 = center[1] + width * vn[0] / 2
    h1 = center[2] + height / 2
    h2 = center[2] - height / 2
    return np.array(
        [min(x1, x2), min(y1, y2), min(h1, h2), max(x1, x2), max(y1, y2), max(h1, h2)],
        np.float32,
    )


def wall_boxes_from_planes(plane_dict, axis_align_matrix=None, bg_class=18):
    """Wall AABBs from a ScanNet `scannet_planes/<scan>.json` dict.

    Args:
      plane_dict: {"verts": [[x,y,z],...], "quads": [[i,j,k,l],...]}.
      axis_align_matrix: optional 4x4 applied to verts (after the reference's
        (y,z) -> (-z, y) axis swap).
      bg_class: class id assigned to walls (18 = ScanNet background).

    Returns (cls [K], boxes [K,6], volumes [K]) — possibly empty arrays.
    """
    verts = np.asarray(plane_dict["verts"], np.float64).copy()
    # reference swaps: new_y = -z, new_z = old_y
    y = verts[:, 1].copy()
    verts[:, 1] = -verts[:, 2]
    verts[:, 2] = y

    if axis_align_matrix is not None:
        pts = np.concatenate([verts, np.ones((len(verts), 1))], axis=1)
        verts = (pts @ np.asarray(axis_align_matrix).T)[:, :3]

    quads = [q for q in plane_dict["quads"] if len(q) == 4]
    if not quads:
        return (np.zeros(0, np.int64), np.zeros((0, 6), np.float32), np.zeros(0, np.float32))
    quad_verts = np.stack([verts[list(q)] for q in quads])

    quad_verts = [q for q in quad_verts if _coplanar(q)]
    quad_verts = [q for q in quad_verts if abs(_quad_normal(q)[2]) < 0.2]  # vertical only
    if not quad_verts:
        return (np.zeros(0, np.int64), np.zeros((0, 6), np.float32), np.zeros(0, np.float32))

    boxes = np.stack([_box_from_quad(q) for q in quad_verts])
    cls = np.full(len(boxes), bg_class, np.int64)
    vols = np.prod(np.clip(boxes[:, 3:] - boxes[:, :3], 0.0, None), axis=-1).astype(np.float32)
    return cls, boxes.astype(np.float32), vols


def box_giou_cross(boxes1, boxes2):
    """Pairwise IoU and gIoU of AABBs (gapro/gen_ps_utils.py:33-61). numpy."""
    b1 = boxes1[:, None, :]
    b2 = boxes2[None, :, :]
    inter = np.prod(
        np.clip(np.minimum(b1[..., 3:], b2[..., 3:]) - np.maximum(b1[..., :3], b2[..., :3]), 0.0, None),
        axis=-1,
    )
    v1 = np.prod(np.clip(b1[..., 3:] - b1[..., :3], 0.0, None), axis=-1)
    v2 = np.prod(np.clip(b2[..., 3:] - b2[..., :3], 0.0, None), axis=-1)
    union = v1 + v2 - inter
    iou = inter / (union + 1e-6)
    bound = np.prod(
        np.clip(np.maximum(b1[..., 3:], b2[..., 3:]) - np.minimum(b1[..., :3], b2[..., :3]), 0.0, None),
        axis=-1,
    )
    giou = iou - (bound - union) / (bound + 1e-6)
    return iou, giou


def is_box1_in_box2(box1, box2, offset=0.05):
    return bool(np.all(box1[:3] + offset >= box2[:3]) and np.all(box1[3:] - offset <= box2[3:]))
