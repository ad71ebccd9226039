"""The S3DIS x4 request of the test CLI (``tools/test.py``): its tracing
(``utils/profiling.py``), the spans ``x4.split`` (``split_room``),
``x4.merge`` (``room_point2voxel``) and ``instances.sem2ins`` (the
``sem2ins_classes`` branch of ``models/inference.py:get_instances``) and
the counters ``x4.room_points`` and ``fps.spill_points``
(``ops/fps.py:fps_cuda``, from the launch's shape), each recorded with
tracing on and nothing with it off; ``serve_room``'s records against
decoding each mask in the pieces' order, permuting it and encoding it
again; and ``prepare``'s ``ovf_spp_ids``, the superpoint ids past
``spp_cap``, which the request reports (``overflows``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gapro_tpu_torch.data.augment import transform_test
from gapro_tpu_torch.data.synthetic import make_synthetic_scene
from gapro_tpu_torch.ops import fps as fps_ops
from gapro_tpu_torch.tools import test as cli
from gapro_tpu_torch.tools import train as trainer
from gapro_tpu_torch.train.config import AttrDict
from gapro_tpu_torch.utils import profiling
from gapro_tpu_torch.utils.rle import rle_decode, rle_encode

SCALE = 20
CFG = {
    "model": {"type": "isbnet", "channels": 8, "num_blocks": 3, "instance_classes": 13,
              "semantic_classes": 13, "semantic_only": False, "with_coords": True,
              "filter_bg_thresh": 0.0, "dec_dim": 32, "n_sample_pa1": 64, "n_queries": 16,
              "radius_scale": 1.5, "neighbor": 8, "mask_dim_out": 8, "spp_cap": 2048},
    "data": {"type": "s3dis", "plan_shrink": 1.0,
             "voxel": {"scale": SCALE, "spatial_shape": [128, 512], "max_npoint": 20000,
                       "min_npoint": 500}},
    "test": {"x4_split": True, "sem2ins_classes": [0, 1], "score_thresh": 0.0,
             "npoint_thresh": 10, "topk": 8, "label_offset": 3, "instance_classes": 13},
}


@pytest.fixture(autouse=True)
def _tracing_off():
    profiling.enable(False)
    profiling.drain()
    yield
    profiling.enable(False)
    profiling.set_unit(None)
    profiling.drain()


def _room(seed: int = 3) -> dict:
    s = make_synthetic_scene(seed=seed, n_objects=4, points_per_object=300, n_floor=600,
                             n_wall=400, room=3.0)
    return transform_test(dict(xyz=s.xyz, rgb=s.rgb, spp=s.spp), SCALE)


@torch.no_grad()
def _serve(room):
    cfg = AttrDict.wrap(CFG)
    model, _ = trainer.build_model(cfg, torch.device("cpu"), seed=0)
    model.inst_conf_head.dense2.bias += 1.5  # confident proposals: instances are kept
    model.eval()
    return cli.serve_room(model, cfg, room, trainer.make_prepare(cfg, torch.device("cpu")),
                          SCALE, "room")


def test_x4_request_records_its_spans_and_counters():
    room = _room()
    profiling.enable(True)
    stages = []
    cfg = AttrDict.wrap(CFG)
    model, _ = trainer.build_model(cfg, torch.device("cpu"), seed=0)
    model.eval()
    with torch.no_grad():
        *_, insts = cli.serve_room(model, cfg, room,
                                   trainer.make_prepare(cfg, torch.device("cpu")), SCALE,
                                   "room", stage=stages.append)
    record = profiling.drain()
    names = [s.name for s in record["spans"]]
    for name in ("x4.split", "x4.merge", "instances.sem2ins"):
        assert names.count(name) == 1, names
    assert stages == ["split", "prepare", "forward", "merge", "instances"]
    assert record["counts"]["x4.room_points"] == len(room["xyz"])
    assert "fps.spill_points" in record["counts"]
    # the spans lie side by side: none opens inside another of this thread
    spans = sorted(record["spans"], key=lambda s: s.start_ns)
    for a, b in zip(spans, spans[1:]):
        assert a.end_ns <= b.start_ns, (a.name, b.name)
    assert [r["label_id"] for r in insts[:2]] == [1, 2]


def test_nothing_is_recorded_with_tracing_off():
    _serve(_room())
    record = profiling.drain()
    assert record == dict(spans=[], counts={})


@pytest.mark.parametrize("b,n", [(2, fps_ops.BLOCK_POINTS * fps_ops.MAX_CLUSTER + 3001),
                                 (3, 5000)])
def test_spill_points_count_the_launch_shape(b, n):
    """``B * max(N - on_chip, 0)`` of the launch's shape: past the largest
    cluster's capacity, and within it (0)."""
    on_chip = fps_ops.launch_shape(n)["on_chip"]
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand((b, n, 3), generator=g)
    valid = torch.rand((b, n), generator=g) < 0.9
    profiling.enable(True)
    idx, ok = fps_ops.fps(xyz, valid, 3)
    record = profiling.drain()
    assert record["counts"]["fps.spill_points"] == b * max(n - on_chip, 0)
    assert (n > on_chip) == (n > fps_ops.BLOCK_POINTS * fps_ops.MAX_CLUSTER)
    assert idx.shape == (b, 3) and bool(ok.all())


def _with_spp_cap(cap: int) -> AttrDict:
    cfg = AttrDict.wrap(CFG)
    cfg.model.spp_cap = cap
    return cfg


def test_prepare_counts_the_superpoint_ids_past_the_cap():
    """``ovf_spp_ids``: the x4 batch's distinct voxel superpoint ids past
    ``spp_cap``, which the segment ops drop; 0 within it."""
    points = cli.split_room(_room(), SCALE)[0]
    prepared = trainer.make_prepare(AttrDict.wrap(CFG), torch.device("cpu"))(points, 4)
    n_ids = int(prepared.batch.spp.max()) + 1
    assert prepared.batch.ovf_spp_ids == 0 and 100 < n_ids <= CFG["model"]["spp_cap"]
    for cap in (n_ids, n_ids - 1, n_ids - 37):
        got = trainer.make_prepare(_with_spp_cap(cap), torch.device("cpu"))(points, 4)
        assert got.batch.ovf_spp_ids == n_ids - cap


def test_x4_request_reports_the_dropped_superpoint_ids(caplog):
    """``overflows``: the outputs' ``ovf_*`` counters and ``prepare``'s
    ``ovf_spp_ids``; the test CLI warns of a request that drops data."""
    from gapro_tpu_torch.train.config import load_config
    from tests.test_torch_trainer import TINY

    room = _room()
    prepared, out, _ = _serve(room)
    n_ids = int(prepared.batch.spp.max()) + 1
    ovf = cli.overflows(prepared, out)
    assert set(ovf) == {k for k in out if k.startswith("ovf_")} | {"ovf_spp_ids"}
    assert not any(ovf.values())
    cfg = _with_spp_cap(n_ids - 5)
    model, _ = trainer.build_model(cfg, torch.device("cpu"), seed=0)
    model.eval()
    with torch.no_grad():
        prepared, out, _ = cli.serve_room(model, cfg, room,
                                          trainer.make_prepare(cfg, torch.device("cpu")),
                                          SCALE, "room")
    assert cli.overflows(prepared, out)["ovf_spp_ids"] == 5

    cfg = load_config(TINY)
    cfg.model.spp_cap = 4
    model, _ = trainer.build_model(cfg, "cpu", seed=0)
    with caplog.at_level("WARNING", logger="test"):
        cli.run_test(cfg, device="cpu", synthetic=1, model=model, evaluate=False)
    assert "capacities exceeded" in caplog.text and "ovf_spp_ids" in caplog.text


@pytest.mark.parametrize("seed", [3, 4])
def test_room_order_records_are_the_permuted_pieces_records(seed):
    """The records ``serve_room`` builds in the room's order equal those
    built in the pieces' order (the points left in the batch's order),
    each mask decoded, permuted into the room's order and encoded again."""
    from gapro_tpu_torch.eval.runner import infer_scene_instances

    room = _room(seed)
    perm = cli.split_room(room, SCALE)[1]
    spp = np.asarray(room["spp"])[perm]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    prepared, out, got = _serve(room)
    want = infer_scene_instances("isbnet", out, prepared.batch, spp, prepared.point2voxel,
                                 len(perm), "room", CFG["test"])
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert (g["label_id"], g["conf"]) == (w["label_id"], w["conf"])
        np.testing.assert_array_equal(g["pred_mask"]["counts"],
                                      rle_encode(rle_decode(w["pred_mask"])[inv])["counts"])
