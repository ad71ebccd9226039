"""The port's data modules against the JAX package's: file readers, the
augmentations, the datasets and the loader (serial and with forked
workers). Both are numpy on the host, so every array must be equal."""

import os.path as osp

import numpy as np
import pytest

from gapro_tpu.data import augment as jax_augment
from gapro_tpu.data import dataset as jax_dataset
from gapro_tpu.data import scannet_io as jax_io
from gapro_tpu_torch.data import augment, dataset, scannet_io

FIX = osp.join(osp.dirname(__file__), "fixtures", "scannetv2")
SMALL = dict(n_objects=3, points_per_object=300, n_floor=400, n_wall=300)


def _assert_scenes_equal(got, want):
    if want is None:
        assert got is None
        return
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def test_scannet_readers_match_jax(tmp_path):
    scene = osp.join(FIX, "train", "scene0000_00_inst_nostuff.pth")
    for g, w in zip(scannet_io.load_scene(scene), jax_io.load_scene(scene)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    spp = osp.join(FIX, "superpoints", "scene0000_00.pth")
    np.testing.assert_array_equal(scannet_io.load_superpoints(spp), jax_io.load_superpoints(spp))
    rng = np.random.default_rng(0)
    ps = str(tmp_path / "ps" / "scene.pth")
    jax_io.save_pseudo_labels(ps, rng.integers(0, 18, 50), rng.integers(-1, 4, 50),
                              rng.random(50), rng.normal(size=7), rng.random(7))
    for g, w in zip(scannet_io.load_pseudo_labels(ps), jax_io.load_pseudo_labels(ps)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("label_type", [None, "ps"])
def test_scannet_dataset_matches_jax(tmp_path, label_type):
    """The fixture split, with ground truth or with pseudo labels (mu and
    var per superpoint, expanded to points)."""
    root = tmp_path / "scannetv2"
    (root / "train").mkdir(parents=True)
    (root / "superpoints").mkdir()
    for sub, name in (("train", "scene0000_00_inst_nostuff.pth"),
                      ("superpoints", "scene0000_00.pth")):
        (root / sub / name).write_bytes(open(osp.join(FIX, sub, name), "rb").read())
    spp = jax_io.load_superpoints(str(root / "superpoints" / "scene0000_00.pth"))
    n, n_spp = len(spp), len(np.unique(spp))
    rng = np.random.default_rng(1)
    jax_io.save_pseudo_labels(str(root / "ps" / "scene0000_00.pth"), rng.integers(0, 18, n),
                              rng.integers(-1, 4, n), rng.random(n), rng.normal(size=n_spp),
                              rng.random(n_spp))
    kw = dict(prefix="train", label_type=label_type, training=True, repeat=2)
    got = dataset.ScanNetDataset(str(root), **kw)
    want = jax_dataset.ScanNetDataset(str(root), **kw)
    assert len(got) == len(want) == 2 and got.scan_id(1) == want.scan_id(1)
    _assert_scenes_equal(got.load(1), want.load(1))


def test_transforms_match_jax():
    scene = dataset.SyntheticDataset(n_scenes=1, **SMALL).load(0)
    for seed in range(3):
        got = augment.transform_train(dict(scene), 20, 512, 2000, np.random.default_rng(seed),
                                      min_npoint=100)
        want = jax_augment.transform_train(dict(scene), 20, 512, 2000,
                                           np.random.default_rng(seed), min_npoint=100)
        _assert_scenes_equal(got, want)
    _assert_scenes_equal(augment.transform_test(dict(scene), 50),
                         jax_augment.transform_test(dict(scene), 50))


def _batches(mod, num_workers, training):
    ds = mod.SyntheticDataset(n_scenes=6, training=training,
                              voxel_cfg=mod.VoxelCfg(scale=20, max_npoint=2500, min_npoint=100),
                              **SMALL)
    return list(mod.build_dataloader(ds, batch_size=2 if training else 1, training=training,
                                     seed=3, epoch=1, drop_last=not training,
                                     num_workers=num_workers))


@pytest.mark.parametrize("num_workers,training", [(0, True), (2, True), (2, False)])
def test_dataloader_matches_jax(num_workers, training):
    """The same batches as the JAX package's serial loader, in the same
    order, from the serial path and from two forked workers."""
    got, want = _batches(dataset, num_workers, training), _batches(jax_dataset, 0, training)
    assert len(got) == len(want) == (3 if training else 6)
    for g, w in zip(got, want):
        assert g.scan_ids == w.scan_ids and g.batch_size == w.batch_size
        for name, a, b in zip(w.points._fields, g.points, w.points):
            np.testing.assert_array_equal(a, b, err_msg=name)
        for a, b in zip(g.scenes, w.scenes):
            _assert_scenes_equal(a, b)


class _Skipping:
    """``mod``'s synthetic dataset with the scenes ``small`` cut to 50
    points, too few for the crop (``min_npoint`` 100): the loaders skip
    them."""

    def __init__(self, mod, small):
        self.inner = mod.SyntheticDataset(
            n_scenes=7, training=True,
            voxel_cfg=mod.VoxelCfg(scale=20, max_npoint=2500, min_npoint=100), **SMALL)
        self.voxel_cfg, self.small = self.inner.voxel_cfg, small

    def __len__(self):
        return len(self.inner)

    def load(self, index):
        s = self.inner.load(index)
        if index in self.small:
            s = {k: v[:50] if isinstance(v, np.ndarray) else v for k, v in s.items()}
        return s


def _rank_loads(ds, world, drop_last, num_workers):
    """Every rank's list of ``build_rank_loader`` items, the ranks run as
    threads whose ``exchange`` all-gathers through a barrier."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    slots, barrier = [None] * world, threading.Barrier(world, timeout=120)

    def run(rank):
        def exchange(n):
            slots[rank] = n
            barrier.wait()
            got = list(slots)
            barrier.wait()
            return got

        return list(dataset.build_rank_loader(ds, world, rank, exchange, seed=3, epoch=1,
                                              drop_last=drop_last, num_workers=num_workers))

    with ThreadPoolExecutor(world) as pool:
        return [f.result() for f in [pool.submit(run, r) for r in range(world)]]


@pytest.mark.parametrize("world,small,drop_last,num_workers", [
    (2, (), True, 0), (2, (1, 4), True, 0), (3, (0, 2, 3), True, 0), (3, (0, 2, 3), False, 0),
    (2, (), True, 1)])
def test_rank_loader_matches_jax_world_batches(world, small, drop_last, num_workers):
    """Each data-parallel rank, loading only its own scene, gets scene
    ``rank`` of each of the JAX package's loader batches of ``world``
    scenes (the train CLI's ``--dp`` batches), with skipped scenes, a
    short last batch's filler (scene ``rank % n``, weight 0) and a spawned
    worker; and the batch's largest point count, which sets the capacity."""
    got = _rank_loads(_Skipping(dataset, set(small)), world, drop_last, num_workers)
    want = list(jax_dataset.build_dataloader(_Skipping(jax_dataset, set(small)), world,
                                             training=True, seed=3, epoch=1,
                                             drop_last=drop_last))
    assert len(want) >= 1 and (drop_last or len(want[-1].scenes) < world)
    for rank in range(world):
        assert len(got[rank]) == len(want)
        for (scene, n_max, weight), w in zip(got[rank], want):
            n = len(w.scenes)
            _assert_scenes_equal(scene, w.scenes[rank % n])
            assert n_max == max(len(s["xyz"]) for s in w.scenes)
            assert weight == (1.0 if rank < n else 0.0)
