"""Datasets and the loader (``gapro_tpu/data/dataset.py``), host side.

* ``ScanNetDataset``: ``<prefix>/<scan>_inst_nostuff.pth`` scenes, their
  superpoints, and pseudo labels from a ``label_type`` directory, with a
  repeat factor for training.
* ``S3DISDataset``: ``preprocess/<prefix>*_inst_nostuff.pth`` rooms with
  their 13 classes kept as training ids, a 25% subsample of each training
  room, and ``split_pieces``, the test-time split of a room into 4
  interleaved pieces.
* ``SyntheticDataset``: fabricated rooms, for machines without the data.
* ``build_dataloader``: shuffles, applies ``transform_train`` /
  ``transform_test`` and collates with ``models/prepare.py:
  points_to_batch_np`` into bucketed point batches.

Scene ``i`` of epoch ``e`` draws its augmentation from its own generator,
seeded from (seed, e, i), so the batches do not depend on the number of
workers or on the order in which they finish. The workers are forked and
do numpy and scipy work only (load and augment): the parent may already
hold a CUDA context, which a forked child must never touch, so the collate
and everything after it runs in the parent.
"""

from __future__ import annotations

import os.path as osp
from dataclasses import dataclass
from glob import glob
from typing import Iterator, List, Tuple

import numpy as np

from ..models.prepare import PointBatch, points_to_batch_np
from .augment import transform_test, transform_train
from .scannet_io import (load_pseudo_labels, load_scene, load_superpoints,
                         remap_semantic_for_training)
from .synthetic import make_synthetic_scene

_SUFFIX = "_inst_nostuff.pth"
_PREFETCH_BATCHES = 2  # batches the workers run ahead of the consumer


@dataclass
class VoxelCfg:
    scale: float = 50.0
    spatial_shape: Tuple[int, int] = (128, 512)
    max_npoint: int = 250_000
    min_npoint: int = 5_000


class ScanNetDataset:
    """ScanNet v2 scenes with optional GP pseudo labels (``label_type``)."""

    def __init__(self, data_root, prefix="train", label_type=None, training=True, repeat=1,
                 voxel_cfg: VoxelCfg = VoxelCfg()):
        self.data_root = data_root
        self.prefix = prefix
        self.training = training
        self.repeat = repeat
        self.voxel_cfg = voxel_cfg
        self.label_type = label_type
        self.files = sorted(glob(osp.join(data_root, prefix, "*" + _SUFFIX)))

    def __len__(self):
        return len(self.files) * (self.repeat if self.training else 1)

    @staticmethod
    def remap_semantic(sem):
        """Raw semantic ids -> training ids."""
        return remap_semantic_for_training(sem)

    def scan_id(self, index):
        f = self.files[index % len(self.files)]
        return osp.basename(f).replace(_SUFFIX, "")

    def load(self, index) -> dict:
        f = self.files[index % len(self.files)]
        scan = self.scan_id(index)
        xyz, rgb, sem, inst = load_scene(f)
        spp = load_superpoints(osp.join(self.data_root, "superpoints", scan + ".pth"))
        n = len(xyz)
        prob = np.ones(n, np.float32)
        mu = np.full(n, -100.0, np.float32)
        var = np.full(n, -100.0, np.float32)
        if self.training and self.label_type:
            # pseudo labels replace the ground truth; mu and var are saved
            # per superpoint and expanded through the scene's superpoint ids
            ps = osp.join(self.data_root, self.label_type, scan + ".pth")
            sem, inst, prob, mu_spp, var_spp = load_pseudo_labels(ps)
            _, spp_c = np.unique(spp, return_inverse=True)
            mu = mu_spp[spp_c].astype(np.float32)
            var = var_spp[spp_c].astype(np.float32)
        else:
            sem = self.remap_semantic(sem)
        return dict(xyz=xyz, rgb=rgb, semantic=sem.astype(np.int64),
                    instance=inst.astype(np.int64), spp=spp, prob=prob, mu=mu, var=var,
                    scan_id=scan)


class S3DISDataset(ScanNetDataset):
    """S3DIS rooms: ``prefix`` is a filename prefix inside ``preprocess/``
    (comma-separated for several, e.g. the training areas); the semantic
    ids are the 13 training classes as they stand, every class an instance
    class. A training room keeps a 25% random subsample of its points, drawn
    from ``np.random.default_rng(index)``."""

    def __init__(self, *args, subsample_train=0.25, **kw):
        super().__init__(*args, **kw)
        self.subsample_train = subsample_train
        if not self.files:
            self.files = sorted(
                f for p in str(self.prefix).split(",")
                for f in glob(osp.join(self.data_root, "preprocess", p.strip() + "*" + _SUFFIX)))

    @staticmethod
    def remap_semantic(sem):
        return np.asarray(sem).astype(np.int64)

    def load(self, index) -> dict:
        scene = super().load(index)
        if self.training and self.subsample_train < 1.0:
            keep = np.random.default_rng(index).random(len(scene["xyz"])) < self.subsample_train
            for k in ("xyz", "rgb", "semantic", "instance", "spp", "prob", "mu", "var"):
                scene[k] = scene[k][keep]
        return scene

    @staticmethod
    def split_pieces(scene, n_pieces=4):
        """The room's points sorted stably by x and dealt round-robin into
        ``n_pieces`` interleaved pieces; each piece keeps its indices into
        the room under ``piece_indices``."""
        order = np.argsort(scene["xyz"][:, 0], kind="stable")
        pieces = []
        for p in range(n_pieces):
            idx = order[p::n_pieces]
            piece = {k: (v[idx] if isinstance(v, np.ndarray) and len(v) == len(order) else v)
                     for k, v in scene.items()}
            piece["piece_indices"] = idx
            pieces.append(piece)
        return pieces


class SyntheticDataset:
    """Fabricated ScanNet-like rooms; ``scene_kw`` goes to
    ``make_synthetic_scene``."""

    def __init__(self, n_scenes=8, training=True, voxel_cfg: VoxelCfg = VoxelCfg(), repeat=1,
                 **scene_kw):
        self.n = n_scenes
        self.training = training
        self.repeat = repeat
        self.voxel_cfg = voxel_cfg
        self.scene_kw = scene_kw

    def __len__(self):
        return self.n * (self.repeat if self.training else 1)

    def scan_id(self, index):
        return f"synthetic{index % self.n:04d}"

    def load(self, index) -> dict:
        s = make_synthetic_scene(seed=index % self.n, **self.scene_kw)
        n = len(s.xyz)
        return dict(xyz=s.xyz, rgb=s.rgb, semantic=remap_semantic_for_training(s.semantic_label),
                    instance=s.instance_label.astype(np.int64), spp=s.spp,
                    prob=np.ones(n, np.float32), mu=np.full(n, -100.0, np.float32),
                    var=np.full(n, -100.0, np.float32), scan_id=self.scan_id(index))


@dataclass
class LoaderBatch:
    points: PointBatch
    scan_ids: List[str]
    scenes: List[dict]  # the scenes after their transform, for evaluation
    batch_size: int


def _prep_scene(dataset, training, vc, seed, epoch, i):
    """Load and augment one scene from its own generator."""
    scene = dataset.load(int(i))
    rng = np.random.default_rng((seed + epoch) * 1_000_003 + int(i))
    if training:
        return transform_train(scene, vc.scale, vc.spatial_shape[1], vc.max_npoint, rng,
                               min_npoint=vc.min_npoint)
    return transform_test(scene, vc.scale)


# the worker's arguments, set once in each forked worker by its initializer
_WORKER_CTX: dict = {}


def _worker_init(dataset, training, vc, seed, epoch):
    _WORKER_CTX.update(dataset=dataset, training=training, vc=vc, seed=seed, epoch=epoch)


def _worker_prep(i):
    c = _WORKER_CTX
    return _prep_scene(c["dataset"], c["training"], c["vc"], c["seed"], c["epoch"], i)


def build_dataloader(dataset, batch_size=4, training=True, seed=0, drop_last=True, epoch=0,
                     num_workers=0) -> Iterator[LoaderBatch]:
    """Shuffling batch iterator -> ``LoaderBatch`` with a bucketed numpy
    ``PointBatch``.

    ``num_workers > 0`` loads and augments in that many forked processes,
    ``_PREFETCH_BATCHES`` batches ahead and in order, so that the host's
    augmentation overlaps the card's step; the batches equal the serial
    path's. A scene the crop leaves too small is skipped.
    """
    rng = np.random.default_rng(seed + epoch)
    order = np.arange(len(dataset))
    if training:
        rng.shuffle(order)
    vc = dataset.voxel_cfg

    def emit(results):
        batch_scenes: List[dict] = []
        ids: List[str] = []
        for t in results:
            if t is None:
                continue
            batch_scenes.append(t)
            ids.append(t.get("scan_id", ""))
            if len(batch_scenes) == batch_size:
                pb = points_to_batch_np(batch_scenes, voxel_scale=vc.scale)
                yield LoaderBatch(points=pb, scan_ids=ids, scenes=batch_scenes,
                                  batch_size=batch_size)
                batch_scenes, ids = [], []
        if batch_scenes and not drop_last:
            pb = points_to_batch_np(batch_scenes, voxel_scale=vc.scale)
            yield LoaderBatch(points=pb, scan_ids=ids, scenes=batch_scenes,
                              batch_size=len(batch_scenes))

    if num_workers <= 0:
        yield from emit(_prep_scene(dataset, training, vc, seed, epoch, i) for i in order)
        return

    import multiprocessing as mp
    from collections import deque
    from concurrent.futures import ProcessPoolExecutor

    window = max(num_workers, batch_size * _PREFETCH_BATCHES)
    with ProcessPoolExecutor(max_workers=num_workers, mp_context=mp.get_context("fork"),
                             initializer=_worker_init,
                             initargs=(dataset, training, vc, seed, epoch)) as pool:
        def results():
            pending: deque = deque()
            it = iter(order)
            for i in it:
                pending.append(pool.submit(_worker_prep, int(i)))
                if len(pending) >= window:
                    break
            while pending:
                fut = pending.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(_worker_prep, int(nxt)))
                yield fut.result()

        yield from emit(results())
