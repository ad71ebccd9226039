"""The traffic generator, the counts and the reference's independence."""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from benchmark.lib import counts, feed, traffic
from benchmark.tests import tiny


def test_pool_is_deterministic_by_seed():
    pool = tiny.POOL
    a, b = traffic.make_pool(2 ** 31 + 7, pool), traffic.make_pool(2 ** 31 + 7, pool)
    c = traffic.make_pool(2 ** 31 + 8, pool)
    for x, y in zip(a, b):
        for k in x:
            assert np.array_equal(x[k], y[k]) if isinstance(x[k], np.ndarray) else x[k] == y[k]
    assert not np.array_equal(a[0]["xyz"], c[0]["xyz"])
    # every seed gets the same object counts, in its own order
    assert sorted(traffic.pool_objects(1, pool)) == sorted(traffic.pool_objects(2, pool))


def test_training_batches_are_the_loaders_own_shuffle():
    from gapro_tpu_torch.data.dataset import build_dataloader

    from benchmark.drivers import train

    cfg, mix = tiny.config("isbnet_scannet"), tiny.mix("train")
    p = train.plan(cfg, mix, 2 ** 31 + 5)
    ds = feed.PoolDataset(p["pool"], p["sequence"], cfg)
    loader = build_dataloader(ds, p["batch"], training=True, seed=2 ** 31 + 5, epoch=train.EPOCH)
    for bt, lb in zip(p["batches"][:6], loader):
        assert lb.scan_ids == [p["pool"][i]["scan_id"] for i in bt]
    assert len(p["batches"]) == mix["epoch_batches"]
    # the pool repeated: each scene as often as every other
    assert sorted(p["sequence"]) == sorted(list(range(len(p["pool"]))) * (
        len(p["sequence"]) // len(p["pool"])))


def test_warm_up_reaches_every_bucket_of_the_epoch():
    from benchmark.drivers import train
    from benchmark.reference import build

    cfg, mix = tiny.config("isbnet_scannet"), tiny.mix("train")
    pool = dict(tiny.POOL, objects=[2, 2, 3, 3, 9, 9, 14, 14])
    p = train.plan(cfg, dict(mix, pool=pool), 2 ** 31 + 9)
    size = lambda bt: build.bucket(sum(len(p["pool"][i]["xyz"]) for i in bt))
    reached = sorted({size(bt) for bt in p["batches"]})
    assert len(reached) > 1
    assert p["buckets"] == reached
    assert sorted(size(g) for g in p["warm"]) == reached


def test_feed_serves_the_sequence():
    pool = traffic.make_pool(3, tiny.POOL)
    seq = [3, 1, 0, 2, 2, 0, 1, 3]
    ds = feed.PoolDataset(pool, seq, tiny.config("isbnet_scannet"))
    assert len(ds) == len(seq)
    assert [ds.load(i)["scan_id"] for i in range(len(ds))] == [pool[i]["scan_id"] for i in seq]


def test_subm_counts_on_a_tiny_plan():
    # 3 valid rows of capacity 4; row 0 has 2 neighbours, row 1 has 3, row 2
    # has 1, the invalid row 3 (padding) holds one entry and is not counted
    nbr = -torch.ones(4, 27, dtype=torch.int32)
    nbr[0, :2] = torch.tensor([0, 1])
    nbr[1, :3] = torch.tensor([0, 1, 2])
    nbr[2, 13] = 2
    nbr[3, 13] = 3
    valid = torch.tensor([True, True, True, False])
    pairs = int(((nbr >= 0) & valid[:, None]).sum())
    assert pairs == 6
    rows = int(valid.sum())
    (ops, nbytes), = counts.subm_counts(rows, pairs, 8, 16, backward=False)
    assert ops == 2 * 6 * 8 * 16
    table, feats, w, out = 3 * 27 * 4 + 3, 3 * 8 * 4, 27 * 8 * 16 * 4, 3 * 16 * 4
    assert nbytes == table + feats + w + out
    parts = counts.subm_counts(rows, pairs, 8, 16, backward=True)
    assert [p[0] for p in parts] == [ops] * 3
    assert parts[1][1] == table + out + w + feats  # dfeats: dout in, dfeats out
    assert parts[2][1] == table + feats + out + w  # dW: feats and dout in, dW out


def test_rule_fps_and_dyco_counts():
    (ops, nbytes), = counts.rule_counts(10, 3, 24, 7, 4, 8, backward=False)
    assert ops == 2 * 7 * 4 * 8 and nbytes == 24 * 4 + 10 * 4 * 4 + 8 * 4 * 8 * 4 + 3 * 8 * 4
    assert counts.fps_ops(100, 11) == 10 * 100 * 10
    assert counts.fps_bytes(150, 2, 11) == 150 * 12 + 150 + 2 * 11 * 4
    # K5: 2 (M + 6) M + 2 M H + 2 H a pair at M = 8, H = 4
    assert counts.dyco_ops(5, 8) == 5 * (2 * 14 * 8 + 2 * 8 * 4 + 2 * 4)
    assert counts.least_s(495e12, 0) == pytest.approx(1.0)
    assert counts.least_s(0, 3.35e12) == pytest.approx(1.0)


def test_reference_imports_nothing_of_the_port():
    root = os.path.join(tiny.ROOT, "benchmark", "reference")
    for dp, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dp, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops = [a.name.split(".")[0] for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    tops = [node.module.split(".")[0]]
                else:
                    continue
                for t in tops:
                    assert t not in ("gapro_tpu_torch", "gapro_tpu", "jax", "jaxlib", "flax"), (
                        f"{f} imports {t}")


def test_dense_operations_count_at_the_valid_share():
    from types import SimpleNamespace

    from benchmark.lib.probes import Probes

    pr = Probes(backward=False)
    # 16 point rows, 12 valid; 8 voxel rows, 6 valid; spp_cap 32, 4 ids used
    batch = SimpleNamespace(valid=torch.tensor([True] * 6 + [False] * 2),
                            spp=torch.tensor([0, 0, 1, 2, 3, -1, 5, 5]), n_spp=32)
    pr.set_unit(np.arange(16) < 12, batch)
    assert pr.shares == {16: 0.75, 8: 0.75, 32: 4 / 32}
    with pr.count():
        torch.randn(8, 5) @ torch.randn(5, 3)  # 240 operations over 8 voxel rows
        torch.randn(32, 5) @ torch.randn(5, 3)  # 960 over 32 superpoint rows
        torch.randn(7, 5) @ torch.randn(5, 3)  # 210, no capacity
    assert pr.tally["dense"]["ops"] == pytest.approx(240 * 0.75 + 960 / 8 + 210)
