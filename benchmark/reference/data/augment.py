# Frozen copy of gapro_tpu_torch/data/augment.py; it does not follow later changes
# to the port.
"""Training and test augmentations (numpy copy of ``gapro_tpu/data/augment.py``).

Host-side numpy and scipy, run in the data workers: jitter (a random 3x3
perturbation), z-rotation (or the fixed 0.35*pi test-time rotation, a quirk
the reference keeps), axis flips, two-scale elastic distortion, and a crop
to ``max_npoint`` with instance-id compaction. The same generator state
gives the same arrays as the JAX package.
"""

from __future__ import annotations

import math

import numpy as np


def augment_xyz(xyz, rng: np.random.Generator, jitter=False, flip=False,
                rot=False, prob=1.0):
    """Random rigid-ish transform. When `rot` is off, applies the fixed
    0.35*pi rotation the reference always uses at test time."""
    m = np.eye(3)
    if jitter and rng.random() < prob:
        m = m + rng.normal(0, 0.1, (3, 3))
    if rot and rng.random() < prob:
        theta = rng.random() * 2 * math.pi
    else:
        theta = 0.35 * math.pi
    c, s = math.cos(theta), math.sin(theta)
    m = m @ np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    out = xyz @ m
    if flip:
        for i in (0, 1):
            if rng.random() < 0.5:
                out[:, i] = -out[:, i]
    return out


def elastic(x, gran, mag, rng: np.random.Generator):
    """Two-pass blurred-noise elastic distortion (custom.py:50-69)."""
    import scipy.ndimage

    blurs = [
        np.ones((3, 1, 1), np.float32) / 3,
        np.ones((1, 3, 1), np.float32) / 3,
        np.ones((1, 1, 3), np.float32) / 3,
    ]
    bb = np.abs(x).max(0).astype(np.int32) // gran + 3
    noise = [rng.normal(size=tuple(bb)).astype(np.float32) for _ in range(3)]
    for _ in range(2):
        for b in blurs:
            noise = [scipy.ndimage.convolve(n, b, mode="constant", cval=0) for n in noise]
    ax = [np.linspace(-(b - 1) * gran, (b - 1) * gran, b) for b in bb]
    from scipy.interpolate import RegularGridInterpolator

    interp = [RegularGridInterpolator(ax, n, bounds_error=False, fill_value=0) for n in noise]
    g = np.stack([i(x) for i in interp], axis=1)
    return x + g * mag


def crop_to_max_npoint(xyz, max_npoint, spatial_shape, rng: np.random.Generator,
                       step=32, min_npoint=5000, max_tries=5):
    """Random spatial crop until <= max_npoint points survive
    (custom.py:98-112 + retry loop :138-146). Returns (xyz_shifted, keep)."""
    for _ in range(max_tries):
        shape = np.array([spatial_shape] * 3, np.float64)
        xyz_off = xyz.copy()
        keep = xyz_off.min(1) >= 0
        room = xyz.max(0) - xyz.min(0)
        while keep.sum() > max_npoint:
            st = step * 2 if keep.sum() > 1e6 else step
            offset = np.clip(shape - room + 0.001, None, 0) * rng.random(3)
            xyz_off = xyz + offset
            keep = (xyz_off.min(1) >= 0) & ((xyz_off < shape).sum(1) == 3)
            shape[:2] -= st
        if keep.sum() >= min_npoint:
            return xyz_off, keep
    return xyz_off, keep


def compact_instance_ids(instance_label):
    """Relabel instance ids to a dense 0..K-1 range, keeping -100."""
    out = np.asarray(instance_label).copy()
    ids = np.unique(out[out >= 0])
    remap = {int(v): i for i, v in enumerate(ids)}
    for v, i in remap.items():
        out[instance_label == v] = i
    return out


def transform_train(scene: dict, voxel_scale, spatial_shape, max_npoint,
                    rng: np.random.Generator, aug_prob=1.0, min_npoint=5000,
                    use_elastic=True):
    """Full train-time transform (custom.py:123-156). scene keys: xyz, rgb,
    spp, semantic, instance [, prob, mu, var]. Returns a new scene dict with
    'xyz' quantization-ready (scaled, min 0) in 'xyz_scaled'."""
    xyz_middle = augment_xyz(scene["xyz"], rng, True, True, True, aug_prob)
    xyz = xyz_middle * voxel_scale
    if use_elastic and rng.random() < aug_prob:
        xyz = elastic(xyz, 6, 40.0, rng)
        xyz = elastic(xyz, 20, 160.0, rng)
    xyz = xyz - xyz.min(0)
    xyz, keep = crop_to_max_npoint(xyz, max_npoint, spatial_shape, rng,
                                   min_npoint=min_npoint)
    if keep.sum() < min_npoint:
        return None
    out = {}
    for k, v in scene.items():
        if isinstance(v, np.ndarray) and len(v) == len(keep):
            out[k] = v[keep]
        else:
            out[k] = v
    out["xyz"] = xyz_middle[keep]
    out["xyz_scaled"] = xyz[keep]
    out["instance"] = compact_instance_ids(out["instance"])
    return out


def transform_test(scene: dict, voxel_scale):
    """Test-time transform: fixed 0.35*pi rotation, scale, shift to min 0."""
    rng = np.random.default_rng(0)
    xyz_middle = augment_xyz(scene["xyz"], rng, False, False, False)
    xyz = xyz_middle * voxel_scale
    xyz = xyz - xyz.min(0)
    out = dict(scene)
    out["xyz"] = xyz_middle
    out["xyz_scaled"] = xyz
    return out
