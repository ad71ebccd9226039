"""Box -> pseudo-mask GP labeling pipeline (``gapro_tpu/labeler/pipeline.py``,
the reference's ``gen_pseudo_label_gaussian_process``).

The work is split as in the JAX package:

  device: the point-in-box test over all points x boxes and the superpoint
          means of the GP features and of the occupancy, thresholded at
          ``thresh_spp_occu`` (``_occupancy_and_pool``); the pooled features
          stay on the device;
  host:   the serial ambiguity resolution in numpy. Its set of GP fits is
          fixed by the occupancy alone: GP outputs only decide label writes,
          never which pairs get fit (train sets are one-box superpoints,
          intersections multi-box ones);
  device: every fit of a window in one batched ``fit_gp_batch`` call per
          (train, test) bucket, the rows gathered on the device from the
          pooled features by one index tensor per group.

The write-back replays the reference loop's order, so the labels follow its
serial semantics (a later pair overwrites when it is more confident).

The sweep (``generate_scene_labels_stream``) spreads scenes and fit
groups round-robin over a list of devices, every visible card unless the
caller names them, as the JAX stage spreads them over ``jax.devices()``.
The next window is submitted on a background thread while the host
enumerates this one, its scenes through a small pool of threads;
``batch_submit`` makes one upload and one occupancy pass per same-shape
group of a window (``submit_scenes_batched``). The JAX stage's
environment switches are keyword arguments here, with its defaults.

The JAX stage's relay transport is not carried over: it cut bytes and
round trips to a remote TPU, and the cards are local. The arrays are
uploaded as they are: no rgb packed into one f32 column with a host-built
table (its point was to rebuild the host's ``u / 127.5 - 1`` bit for bit,
which the unpacked features are), no flat single-buffer upload, no
bit-packed occupancy, no merged fit-and-occupancy fetch and no
one-bucket switch. Uploads are pinned and asynchronous and each result
comes back by an asynchronous copy with its own event, so the host waits
for what it reads and for nothing queued after it.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.bucketing import next_bucket
from ..core.segment import segment_count, segment_mean, segment_sum
from ..device import resolve_device
from ..gp import fit_gp_batch
from .boxes import box_giou_cross, is_box1_in_box2

_MAXDET = 1_000_000


@dataclass(frozen=True)
class LabelerConfig:
    instance_classes: int = 18
    ground_h: float = 0.1
    training_iter: int = 50
    lr: float = 0.1
    thresh_spp_occu: float = 0.999
    box_margin: float = 0.005
    in_box_offset: float = 0.1
    iou_skip: float = 0.6
    iou_overlap_min: float = 1e-4
    max_train: int = 512  # cap on GP train size (subsampled beyond this)
    max_test: int = 1024
    # inducing-point cap (the sparse-SVGP approximation: the Cholesky is
    # O(M^3) while the ELBO sums over all train points)
    n_inducing: int = 128


# Cumulative overflow counters ("no silent caps"): GP jobs whose train rows
# were subsampled beyond max_train, and whose intersection was truncated
# beyond max_test. Reset with reset_overflow_stats().
OVERFLOW_STATS = {"gp_train_subsampled": 0, "gp_test_truncated": 0}

# Host-clock seconds of the sweep's phases: submit (box assembly, uploads,
# the occupancy launch), occ_fetch (waiting for the occupancy), enumerate
# (host resolution), gp_submit (index buffers and the fit launches),
# gp_fetch (waiting for the fits), writeback (labels, and the caller's work
# between yields).
PHASE_STATS = {"submit": 0.0, "occ_fetch": 0.0, "enumerate": 0.0,
               "gp_submit": 0.0, "gp_fetch": 0.0, "writeback": 0.0}


def reset_overflow_stats():
    for k in OVERFLOW_STATS:
        OVERFLOW_STATS[k] = 0
    for k in PHASE_STATS:
        PHASE_STATS[k] = 0.0


class _GPJob(NamedTuple):
    b1: int
    b2: int
    b1_inds: np.ndarray
    b2_inds: np.ndarray
    intersect_inds: np.ndarray
    scene: int = 0  # index into the window's feats list


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``dev``; to the card through pinned memory
    and without blocking, so the host does not wait for the queued work."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _on(dev: torch.device):
    """Make ``dev`` the current card (its stream takes the copies and the
    events); nothing for the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _devices(device=None, devices=None) -> list:
    """The sweep's device list: ``devices``, else ``[device]``, else every
    visible card (``resolve_device`` raises where there is none). A card
    named without an index is the current one, so that two spellings of
    one card compare equal."""
    if devices is None:
        if device is not None:
            devices = [device]
        else:
            resolve_device(None)
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("the device list is empty")
    return out


class _HostCopy:
    """A device tensor's copy to the host, in flight. ``numpy()`` waits for
    this copy alone (its event), not for work queued after it."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            with _on(t.device):
                self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self._host.copy_(t, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record()
        else:
            self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _gather_rows(ibuf, flat, tb: int):
    """A fit group's (tx, ty, tm, qx, qm), gathered on the device from the
    window's pooled features ``flat`` [S, D].

    ``ibuf`` is [B, tb + qb] int64: train slots hold sign(y) * (row + 1)
    (0 is padding; box 1's rows are -1, box 2's +1), test slots row + 1."""
    tr = ibuf[:, :tb]
    te = ibuf[:, tb:]
    ty = torch.where(tr < 0, -1.0, 1.0)
    tx = flat[torch.clamp_min(torch.abs(tr) - 1, 0)]
    qx = flat[torch.clamp_min(te - 1, 0)]
    return tx, ty, tr != 0, qx, te != 0


def _fit_gp_batch_indexed(ibuf, flat, tb: int, qb: int, iters: int, lr: float,
                          n_inducing):
    """One fit group (see ``_gather_rows``). Returns [3, B, qb]: probs, mu,
    var (labels and confidences are recomputed on the host from the same
    fp32 probs)."""
    r = fit_gp_batch(*_gather_rows(ibuf, flat, tb), iters, lr, n_inducing)
    return torch.stack([r.probs, r.mu, r.var])


def _occupancy_and_pool(coords, feats, spp_inverse, boxes, n_spps: int, margin: float,
                        thresh: float):
    """Device stage: the [N, B] point-in-box test (boxes grown by
    ``margin``), then superpoint means. Returns the pooled GP features
    [S, D] and the occupancy [S, B] thresholded at ``thresh``.

    The feature sums run in fp64 and the mean is rounded to fp32 once, so
    the pooled features do not depend on the order of the sums: the same on
    the card and on the CPU (where ``index_put_`` accumulates in an order
    that changes from run to run) and from call to call. The 50-step fits
    amplify a one-ulp change of their inputs to about the size of their
    cross-implementation bound (``PERF.md`` §6). The occupancy means are
    exact in fp32 (sums of ones)."""
    inside = (torch.all(coords[:, None, :] >= boxes[None, :, :3] - margin, dim=-1)
              & torch.all(coords[:, None, :] <= boxes[None, :, 3:] + margin, dim=-1))
    count = segment_count(spp_inverse, n_spps, dtype=torch.float64)
    sums = segment_sum(feats.double(), spp_inverse, n_spps)
    feats_spp = (sums / torch.clamp_min(count, 1.0)[:, None]).float()
    occ_spp = segment_mean(inside.float(), spp_inverse, n_spps)
    return feats_spp, occ_spp >= thresh


def _occupancy_and_pool_batched(coords, feats, spp_inverse, boxes, s_cap: int, margin: float,
                                thresh: float):
    """``_occupancy_and_pool`` over K scenes padded to one shape: coords
    [K, N, 3], feats [K, N, D], spp_inverse [K, N] (-1 for padding), boxes
    [K, B, 6] (padding boxes contain nothing). Returns the pooled features
    [K, s_cap, D] and the occupancy [K, s_cap, B]. Every superpoint's sum
    runs over the same points in the same order as one scene's would, so
    each scene's rows equal its ``_occupancy_and_pool``'s."""
    k, n, d = feats.shape
    inside = (torch.all(coords[:, :, None, :] >= boxes[:, None, :, :3] - margin, dim=-1)
              & torch.all(coords[:, :, None, :] <= boxes[:, None, :, 3:] + margin, dim=-1))
    base = torch.arange(k, device=coords.device)[:, None] * s_cap
    seg = torch.where(spp_inverse >= 0, spp_inverse + base, -1).reshape(-1)
    count = segment_count(seg, k * s_cap, dtype=torch.float64)
    sums = segment_sum(feats.reshape(k * n, d).double(), seg, k * s_cap)
    feats_spp = (sums / torch.clamp_min(count, 1.0)[:, None]).float()
    occ_spp = segment_mean(inside.reshape(k * n, -1).float(), seg, k * s_cap)
    return feats_spp.view(k, s_cap, d), (occ_spp >= thresh).view(k, s_cap, -1)


def _count_overflows(jobs, cfg: LabelerConfig):
    n_sub = sum(1 for j in jobs if len(j.b1_inds) + len(j.b2_inds) > cfg.max_train)
    n_trunc = sum(1 for j in jobs if len(j.intersect_inds) > cfg.max_test)
    if n_sub or n_trunc:
        OVERFLOW_STATS["gp_train_subsampled"] += n_sub
        OVERFLOW_STATS["gp_test_truncated"] += n_trunc
        logging.getLogger(__name__).info(
            "GP caps hit: %d/%d jobs train-subsampled (>%d), %d truncated (>%d)",
            n_sub, len(jobs), cfg.max_train, n_trunc, cfg.max_test)


def _job_buckets(jobs, cfg: LabelerConfig):
    """Group job indices by (train_bucket, test_bucket), coarse powers of two
    (min 256 and 128), in first-seen order."""
    groups = {}
    for j, job in enumerate(jobs):
        t = min(len(job.b1_inds) + len(job.b2_inds), cfg.max_train)
        q = min(len(job.intersect_inds), cfg.max_test)
        key = (next_bucket(t, min_size=256, granularity=1),
               next_bucket(q, min_size=128, granularity=1))
        groups.setdefault(key, []).append(j)
    return groups


def _subsampled_job_rows(job, tb, qb, j):
    """Per-job row selection: proportional train subsample beyond the cap,
    test truncation, and the inducing shuffle (the first n_inducing rows
    become the inducing set, so they must be a random mix of both boxes).
    The rng is seeded by the job's position ``j`` in the list handed to the
    fit, so the draws do not depend on the groups' order."""
    rng = np.random.default_rng(j)
    b1i, b2i = job.b1_inds, job.b2_inds
    if len(b1i) + len(b2i) > tb:  # cap: subsample proportionally
        keep1 = max(1, int(tb * len(b1i) / (len(b1i) + len(b2i))))
        keep2 = tb - keep1
        b1i = rng.choice(b1i, size=min(keep1, len(b1i)), replace=False)
        b2i = rng.choice(b2i, size=min(keep2, len(b2i)), replace=False)
    qi = job.intersect_inds
    if len(qi) > qb:
        qi = qi[:qb]
    perm = rng.permutation(len(b1i) + len(b2i))
    return b1i, b2i, qi, perm


def _group_index(jobs, idxs, tb: int, qb: int, offsets) -> np.ndarray:
    """The [B, tb + qb] index buffer of the fit group ``idxs`` (see
    ``_gather_rows``); rows are offset by their scene's ``offsets`` entry in
    the window's concatenated features. B is a bucket of the group's size:
    padded lanes have every mask false and are dropped on the host."""
    ibuf = np.zeros((next_bucket(len(idxs), min_size=4), tb + qb), np.int64)
    for bi, j in enumerate(idxs):
        job = jobs[j]
        b1i, b2i, qi, perm = _subsampled_job_rows(job, tb, qb, j)
        t = len(b1i) + len(b2i)
        base = offsets[job.scene]
        rows = base + np.concatenate([b1i, b2i]).astype(np.int64)
        sign = np.ones(t, np.int64)
        sign[: len(b1i)] = -1
        ibuf[bi, :t] = ((rows + 1) * sign)[perm]
        ibuf[bi, tb: tb + len(qi)] = base + np.asarray(qi) + 1
    return ibuf


def _fit_jobs_submit(jobs, feats_list, cfg: LabelerConfig, devices=None):
    """Launch every fit group of ``jobs`` without waiting for any. Rows index
    the concatenation of ``feats_list`` (one [S_i, D] device tensor per
    scene, ``job.scene`` picks one). Group g runs on ``devices[g % len]``
    (default: the first scene's device), the window's features copied
    there once. The groups, their lanes and each job's row draw are those
    of one device whatever the list, so a fit gives the same result on
    whichever device runs it. (The JAX stage splits a group by the device
    of each scene's features instead; the copy here is the window's pooled
    features, [S, D] a scene.) Returns the pending state for ``_fit_jobs_fetch``."""
    if not jobs:
        return [], 0
    t0 = time.perf_counter()
    _count_overflows(jobs, cfg)
    devs = list(devices) if devices else [feats_list[0].device]
    offsets = np.cumsum([0] + [f.shape[0] for f in feats_list])
    flats = {}
    pending = []
    for g, ((tb, qb), idxs) in enumerate(_job_buckets(jobs, cfg).items()):
        dev = devs[g % len(devs)]
        with _on(dev):
            if dev not in flats:
                parts = [f.to(dev) for f in feats_list]
                flats[dev] = parts[0] if len(parts) == 1 else torch.cat(parts)
            nqs = [min(len(jobs[j].intersect_inds), qb) for j in idxs]
            res = _fit_gp_batch_indexed(
                _upload(_group_index(jobs, idxs, tb, qb, offsets), dev), flats[dev], tb, qb,
                cfg.training_iter, cfg.lr, min(cfg.n_inducing, tb) if cfg.n_inducing else None)
            pending.append((idxs, nqs, _HostCopy(res)))
    PHASE_STATS["gp_submit"] += time.perf_counter() - t0
    return pending, len(jobs)


def _fit_jobs_fetch(state):
    """Wait for each launched group and cut its [3, B, qb] result into the
    jobs' (probs, probs_new, labels, mu, var) numpy arrays, in job order."""
    pending, n_jobs = state
    t0 = time.perf_counter()
    results = [None] * n_jobs
    for idxs, nqs, copy in pending:
        probs, mu, var = copy.numpy()
        labels = probs >= 0.5
        probs_new = np.where(labels, probs, np.float32(1.0) - probs)
        for bi, (j, nq) in enumerate(zip(idxs, nqs)):
            results[j] = (probs[bi, :nq], probs_new[bi, :nq], labels[bi, :nq], mu[bi, :nq],
                          var[bi, :nq])
    PHASE_STATS["gp_fetch"] += time.perf_counter() - t0
    return results


def _fit_jobs_batched(jobs, feats_spp, cfg: LabelerConfig):
    """All GP jobs through the bucketed batched fits; ``feats_spp`` is one
    [S, D] device tensor or a list indexed by ``job.scene``. Returns a list
    aligned with ``jobs`` of (probs, probs_new, labels, mu, var)."""
    feats_list = list(feats_spp) if isinstance(feats_spp, (list, tuple)) else [feats_spp]
    return _fit_jobs_fetch(_fit_jobs_submit(jobs, feats_list, cfg))


class _SceneHandle(NamedTuple):
    feats: torch.Tensor  # [S, D] pooled GP features, on the device
    occ: _HostCopy  # [S, B] bool occupancy on its way to the host
    spp_inverse: np.ndarray
    n_spps: int
    n_boxes: int
    n_fg: int
    boxes: np.ndarray
    boxes_cls: np.ndarray
    boxes_volume: np.ndarray


def _scene_boxes(coords, instance_cls, instance_box, instance_box_volume, wall_box,
                 wall_box_volume, cfg: LabelerConfig):
    """The box set: instances, then walls, then the floor slab (the last two
    of the background class)."""
    ccls = cfg.instance_classes
    mn, mx = coords.min(0), coords.max(0)
    fbox = np.array([mn[0], mn[1], mn[2], mx[0], mx[1], mn[2] + cfg.ground_h], np.float32)
    fvol = np.prod(np.clip(fbox[3:] - fbox[:3], 1e-3, None))
    if wall_box is not None and len(wall_box) > 0:
        boxes = np.concatenate([instance_box, wall_box, fbox[None]], 0)
        boxes_cls = np.concatenate(
            [instance_cls, np.full(len(wall_box) + 1, ccls, instance_cls.dtype)], 0)
        boxes_volume = np.concatenate([instance_box_volume, wall_box_volume, [fvol]], 0)
    else:
        boxes = np.concatenate([instance_box, fbox[None]], 0)
        boxes_cls = np.concatenate([instance_cls, np.full(1, ccls, instance_cls.dtype)], 0)
        boxes_volume = np.concatenate([instance_box_volume, [fvol]], 0)
    return boxes, boxes_cls, boxes_volume


def _dense_spp(spp):
    """Superpoint ids -> (inverse [N] int64, count). Ids from the prep
    pipelines are already 0..K-1, which bincount checks in O(N); others go
    through ``np.unique``."""
    spp = np.asarray(spp)
    mx = int(spp.max()) if spp.size else -1
    if spp.size and spp.min() >= 0 and mx < 2 * len(spp) and (
            np.bincount(spp.ravel(), minlength=mx + 1) > 0).all():
        return spp.astype(np.int64, copy=False), mx + 1
    uniq, inverse = np.unique(spp, return_inverse=True)
    return inverse.astype(np.int64, copy=False), len(uniq)


class _HostScene(NamedTuple):
    """A scene's host half of the submit: its arrays and boxes."""

    coords: np.ndarray
    gp_feats: np.ndarray
    spp_inverse: np.ndarray
    n_spps: int
    n_fg: int
    boxes: np.ndarray
    boxes_cls: np.ndarray
    boxes_volume: np.ndarray

    def handle(self, feats, occ: _HostCopy) -> _SceneHandle:
        return _SceneHandle(feats, occ, self.spp_inverse, self.n_spps, len(self.boxes),
                            self.n_fg, self.boxes, self.boxes_cls, self.boxes_volume)


def _host_scene(coords, gp_feats, spp, instance_cls, instance_box, instance_box_volume,
                wall_box=None, wall_box_volume=None,
                cfg: LabelerConfig = LabelerConfig()) -> _HostScene:
    coords = np.asarray(coords, np.float32)
    boxes, boxes_cls, boxes_volume = _scene_boxes(
        coords, instance_cls, instance_box, instance_box_volume, wall_box, wall_box_volume, cfg)
    return _HostScene(coords, np.asarray(gp_feats, np.float32), *_dense_spp(spp),
                      len(instance_box), boxes, boxes_cls, boxes_volume)


def submit_scene(coords, gp_feats, spp, instance_cls, instance_box, instance_box_volume,
                 wall_box=None, wall_box_volume=None, cfg: LabelerConfig = LabelerConfig(),
                 device=None) -> _SceneHandle:
    """Phase 1: assemble the boxes on the host, upload the scene and launch
    the occupancy and pooling on ``device`` (``cuda`` unless named) without
    waiting for them."""
    dev = resolve_device(device)
    h = _host_scene(coords, gp_feats, spp, instance_cls, instance_box, instance_box_volume,
                    wall_box, wall_box_volume, cfg)
    with _on(dev):
        feats, occ = _occupancy_and_pool(
            _upload(h.coords, dev), _upload(h.gp_feats, dev), _upload(h.spp_inverse, dev),
            _upload(h.boxes.astype(np.float32), dev), h.n_spps, cfg.box_margin,
            cfg.thresh_spp_occu)
        return h.handle(feats, _HostCopy(occ))


class _LaneCopy:
    """One scene's occupancy [S, B] out of its group's [K, s_cap, b_cap]
    copy in flight (one copy to the host for the group)."""

    def __init__(self, group: _HostCopy, lane: int, n_spps: int, n_boxes: int):
        self._group, self._lane, self._shape = group, lane, (n_spps, n_boxes)

    def numpy(self) -> np.ndarray:
        s, b = self._shape
        return self._group.numpy()[self._lane, :s, :b]


def submit_scenes_batched(scene_kwargs, cfg: LabelerConfig = LabelerConfig(),
                          device=None) -> list:
    """``submit_scene`` for a window of scenes (dicts of its arguments) with
    one upload and one occupancy and pooling pass per same-shape group:
    points, superpoints and boxes padded to buckets (``next_bucket``), the
    group's scenes stacked on the host and copied to ``device`` at once.
    Returns handles aligned with ``scene_kwargs``, each scene's results
    equal to its ``submit_scene``'s."""
    dev = resolve_device(device)
    hosts = [_host_scene(cfg=cfg, **kw) for kw in scene_kwargs]
    groups = {}
    for i, h in enumerate(hosts):
        key = (next_bucket(len(h.coords), min_size=1024), next_bucket(h.n_spps, min_size=128),
               next_bucket(len(h.boxes), min_size=8), h.gp_feats.shape[1])
        groups.setdefault(key, []).append(i)
    handles = [None] * len(hosts)
    for (n_cap, s_cap, b_cap, d), idxs in groups.items():
        k = len(idxs)
        coords = np.zeros((k, n_cap, 3), np.float32)
        feats = np.zeros((k, n_cap, d), np.float32)
        spp = np.full((k, n_cap), -1, np.int64)
        boxes = np.zeros((k, b_cap, 6), np.float32)
        boxes[:, :, :3] = 1.0  # min above max: contains nothing
        for j, i in enumerate(idxs):
            h = hosts[i]
            n = len(h.coords)
            coords[j, :n], feats[j, :n], spp[j, :n] = h.coords, h.gp_feats, h.spp_inverse
            boxes[j, :len(h.boxes)] = h.boxes
        with _on(dev):
            feats_spp, occ = _occupancy_and_pool_batched(
                _upload(coords, dev), _upload(feats, dev), _upload(spp, dev),
                _upload(boxes, dev), s_cap, cfg.box_margin, cfg.thresh_spp_occu)
            occ_host = _HostCopy(occ)
        for j, i in enumerate(idxs):
            h = hosts[i]
            handles[i] = h.handle(feats_spp[j, :h.n_spps],
                                  _LaneCopy(occ_host, j, h.n_spps, len(h.boxes)))
    return handles


class _SceneResolution(NamedTuple):
    """Host state between job enumeration and GP write-back."""

    inst: np.ndarray
    det: np.ndarray
    prob: np.ndarray
    mu: np.ndarray
    var: np.ndarray
    occ_spp: np.ndarray
    n_bbs_per_spp: np.ndarray
    feats_spp: torch.Tensor
    ops_list: list
    jobs: list
    handle: _SceneHandle


def enumerate_scene(h: _SceneHandle, cfg: LabelerConfig = LabelerConfig(),
                    occupancy_np=None) -> _SceneResolution:
    """Read the occupancy and enumerate the GP work exactly as the
    reference's serial loop would (the fits are fixed by the occupancy, see
    the module's note). ``occupancy_np`` supplies the [S, B] bool occupancy
    already on the host."""
    n_spps, n_boxes, boxes = h.n_spps, h.n_boxes, h.boxes
    occ_spp = h.occ.numpy() if occupancy_np is None else occupancy_np
    n_bbs_per_spp = occ_spp.sum(1)

    inst = np.full(n_spps, -100, np.int64)
    det = np.zeros(n_spps, np.int64)
    prob = np.zeros(n_spps, np.float32)
    mu = np.full(n_spps, -100.0, np.float32)
    var = np.full(n_spps, -100.0, np.float32)

    one = n_bbs_per_spp == 1
    inst[one] = np.argmax(occ_spp[one], axis=1)
    prob[one] = 1.0
    det[one] = _MAXDET
    zero = n_bbs_per_spp == 0
    inst[zero] = -1
    prob[zero] = 1.0
    det[zero] = _MAXDET

    iou, _ = box_giou_cross(boxes, boxes)
    np.fill_diagonal(iou, 0.0)
    visited = np.zeros(n_boxes, bool)

    # ops: ("assign", spp_inds, box) for in-box shortcuts, ("gp", job index)
    ops_list = []
    jobs = []
    for b1 in range(n_boxes):
        overlap_inds = np.nonzero((iou[b1] > cfg.iou_overlap_min) & ~visited)[0]
        if len(overlap_inds) == 0:
            visited[b1] = True
            continue
        for b2 in overlap_inds:
            inter = np.nonzero(occ_spp[:, b1] & occ_spp[:, b2])[0]
            if len(inter) == 0:
                continue
            if is_box1_in_box2(boxes[b1], boxes[b2], offset=cfg.in_box_offset):
                ops_list.append(("assign", inter, b1))
                visited[b1] = True
                break
            if is_box1_in_box2(boxes[b2], boxes[b1], offset=cfg.in_box_offset):
                ops_list.append(("assign", inter, b2))
                visited[b2] = True
                continue
            if iou[b1, b2] >= cfg.iou_skip:
                continue
            b1_inds = np.nonzero((inst == b1) & one)[0]
            b2_inds = np.nonzero((inst == b2) & one)[0]
            if len(b1_inds) == 0 or len(b2_inds) == 0:
                continue
            jobs.append(_GPJob(b1, b2, b1_inds, b2_inds, inter))
            ops_list.append(("gp", len(jobs) - 1))
        visited[b1] = True

    return _SceneResolution(inst=inst, det=det, prob=prob, mu=mu, var=var, occ_spp=occ_spp,
                            n_bbs_per_spp=n_bbs_per_spp, feats_spp=h.feats, ops_list=ops_list,
                            jobs=jobs, handle=h)


def writeback_scene(res: _SceneResolution, gp_results, cfg: LabelerConfig = LabelerConfig()):
    """Apply the writes in the reference loop's serial order, give leftover
    multi-box superpoints their smallest-volume box, and expand to points."""
    h = res.handle
    inst, det, prob, mu, var = res.inst, res.det, res.prob, res.mu, res.var
    occ_spp, n_bbs_per_spp = res.occ_spp, res.n_bbs_per_spp
    ccls = cfg.instance_classes

    for op in res.ops_list:
        if op[0] == "assign":
            _, inter, b = op
            inst[inter] = b
            det[inter] = _MAXDET
            prob[inter] = 1.0
        else:
            job = res.jobs[op[1]]
            probs, probs_new, labels, mu_j, var_j = gp_results[op[1]]
            inter = job.intersect_inds[: len(probs)]
            ow = prob[inter] < probs_new
            sel = inter[ow]
            lab = labels[ow]
            inst[sel[lab]] = job.b2
            inst[sel[~lab]] = job.b1
            prob[sel] = probs_new[ow]
            mu[sel] = mu_j[ow]
            var[sel] = var_j[ow]
            det[sel] = len(job.intersect_inds)

    # leftover multi-box, undetermined -> smallest-volume box
    left = (n_bbs_per_spp > 1) & (det == 0)
    if left.any():
        li = np.nonzero(left)[0]
        vols = np.where(occ_spp[li], h.boxes_volume[None, :], np.inf)
        inst[li] = np.argmin(vols, axis=1)
        prob[li] = 1.0

    sem_spp = np.full(h.n_spps, -100, np.int32)
    inst_spp = np.full(h.n_spps, -100, np.int32)
    fg = inst >= 0
    sem_spp[fg] = h.boxes_cls[inst[fg]].astype(np.int32)
    sem_spp[inst == -1] = ccls
    inst_spp[fg] = inst[fg].astype(np.int32)
    bgbox = inst_spp >= h.n_fg  # wall and floor boxes are background, not instances
    inst_spp[bgbox] = -100
    sem_spp[bgbox] = ccls

    spp_inverse = h.spp_inverse
    return sem_spp[spp_inverse], inst_spp[spp_inverse], prob[spp_inverse], mu, var, spp_inverse


def resolve_scene(h: _SceneHandle, cfg: LabelerConfig = LabelerConfig()):
    """Phase 2: read the occupancy, resolve on the host, run the batched GP
    fits and write the labels back. Returns generate_scene_labels' tuple."""
    res = enumerate_scene(h, cfg)
    return writeback_scene(res, _fit_jobs_batched(res.jobs, res.feats_spp, cfg), cfg)


def generate_scene_labels(coords, gp_feats, spp, instance_cls, instance_box,
                          instance_box_volume, wall_box=None, wall_box_volume=None,
                          cfg: LabelerConfig = LabelerConfig(), device=None):
    """(sem, inst, prob, mu, var, spp_inverse) pseudo labels for one scene.

    Args (numpy): coords [N, 3] axis-aligned xyz; gp_feats [N, D] GP input
    features (xyz+rgb, or deep mask features for self-training); spp [N]
    superpoint ids (any ints); the foreground boxes from ``instance_info``;
    optional background wall boxes. Runs on ``device`` (``cuda`` unless
    named).

    Returns sem [N] int32 (-100 ignore, class ids, ``instance_classes`` for
    background), inst [N] int32 (-100 ignore), prob [N] f32, mu and var per
    superpoint (-100 where no fit wrote), and the point -> superpoint map.
    """
    handle = submit_scene(coords, gp_feats, spp, instance_cls, instance_box,
                          instance_box_volume, wall_box, wall_box_volume, cfg, device)
    return resolve_scene(handle, cfg)


def generate_scene_labels_stream(scene_iter, cfg: LabelerConfig = LabelerConfig(),
                                 window: int = 4, device=None, devices=None,
                                 batch_submit: bool = False, submit_threads: int = 4):
    """Windowed sweep over ``scene_iter``, spread over ``devices`` (every
    visible card unless named; ``device`` names one).

    Scenes go in windows of ``window``, round-robin over the devices by
    their position in the sweep. Window w + 1 is submitted on a background
    thread (its scenes through a pool of ``submit_threads``, or with
    ``batch_submit`` one ``submit_scenes_batched`` call per device) while
    the host enumerates window w; all fits of a window go into one
    cross-scene bucketed set of launches (the jobs numbered across the
    window, which seeds their row draws), the groups round-robin over the
    devices, and they run while the host enumerates window w + 1. The
    labels do not depend on the device list.

    ``scene_iter`` yields dicts of ``submit_scene``'s arguments (coords,
    gp_feats, spp, instance_cls, instance_box, instance_box_volume [,
    wall_box, wall_box_volume]); yields (scene_dict, labels_tuple) in order.
    """
    devs = _devices(device, devices)
    it = iter(scene_iter)
    window = max(window, 1)

    def take():
        out = []
        for _ in range(window):
            s = next(it, None)
            if s is None:
                break
            out.append(s)
        return out

    def submit_window(scenes, base):
        t0 = time.perf_counter()
        on = [devs[(base + i) % len(devs)] for i in range(len(scenes))]
        if batch_submit:
            handles = [None] * len(scenes)
            for dev in dict.fromkeys(on):
                idxs = [i for i, d in enumerate(on) if d == dev]
                for i, h in zip(idxs, submit_scenes_batched([scenes[i] for i in idxs], cfg, dev)):
                    handles[i] = h
        else:
            handles = list(pool.map(lambda i: submit_scene(cfg=cfg, device=on[i], **scenes[i]),
                                    range(len(scenes))))
        PHASE_STATS["submit"] += time.perf_counter() - t0
        return handles

    def enumerate_and_submit(handles):
        t0 = time.perf_counter()
        occs = [h.occ.numpy() for h in handles]
        t1 = time.perf_counter()
        PHASE_STATS["occ_fetch"] += t1 - t0
        resolutions = [enumerate_scene(h, cfg, occupancy_np=o) for h, o in zip(handles, occs)]
        jobs = [j._replace(scene=si) for si, res in enumerate(resolutions) for j in res.jobs]
        PHASE_STATS["enumerate"] += time.perf_counter() - t1
        return resolutions, _fit_jobs_submit(jobs, [r.feats_spp for r in resolutions], cfg, devs)

    # The scene iterator stays on this thread; the pools only submit.
    with ThreadPoolExecutor(max_workers=1) as ahead, \
            ThreadPoolExecutor(max_workers=max(1, min(window, submit_threads))) as pool:
        base = 0
        cur_scenes = take()
        cur_handles = submit_window(cur_scenes, base)
        prev = None  # previous window: (scenes, resolutions, fits in flight)
        while cur_scenes or prev is not None:
            if cur_scenes:
                base += len(cur_scenes)
                nxt_scenes = take()
                nxt = ahead.submit(submit_window, nxt_scenes, base)
                cur_state = (cur_scenes, *enumerate_and_submit(cur_handles))
            else:
                nxt_scenes, nxt, cur_state = [], None, None
            if prev is not None:
                prev_scenes, prev_res, prev_pending = prev
                results = _fit_jobs_fetch(prev_pending)
                t0 = time.perf_counter()
                off = 0
                for scene, res in zip(prev_scenes, prev_res):
                    k = len(res.jobs)
                    yield scene, writeback_scene(res, results[off:off + k], cfg)
                    off += k
                PHASE_STATS["writeback"] += time.perf_counter() - t0
            prev = cur_state
            cur_scenes, cur_handles = nxt_scenes, (nxt.result() if nxt is not None else [])
