"""The S3DIS x4 request of the test CLI (``tools/test.py``): the room
split on the device (``split_room``) equal field for field to the host's
collation of ``S3DISDataset.split_pieces``, on the CPU and (``gpu``) on
the card, and the merge's inverse built there; ``upload_point_batch``'s
pass-through of a batch already on its device (``prepare.on_device``);
its tracing (``utils/profiling.py``), the spans ``x4.split`` (``split_room``),
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
from gapro_tpu_torch.data.dataset import S3DISDataset
from gapro_tpu_torch.data.synthetic import make_synthetic_scene
from gapro_tpu_torch.models.prepare import points_to_batch_np, upload_point_batch
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


def _room(seed: int = 3, labels: bool = False) -> dict:
    s = make_synthetic_scene(seed=seed, n_objects=4, points_per_object=300, n_floor=600,
                             n_wall=400, room=3.0)
    room = dict(xyz=s.xyz, rgb=s.rgb, spp=s.spp)
    if labels:
        room.update(semantic=s.semantic_label, instance=s.instance_label.astype(np.int64))
    return transform_test(room, SCALE)


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
    perm = cli.split_room(room, SCALE)[1].numpy()
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


def _host_split(scene, scale=SCALE):
    """The host's split: ``split_pieces`` collated by ``points_to_batch_np``."""
    pieces = S3DISDataset.split_pieces(scene, cli.X4_PIECES)
    return (points_to_batch_np(pieces, voxel_scale=scale),
            np.concatenate([p["piece_indices"] for p in pieces]))


def _assert_split_equal(scene, device, scale=SCALE):
    want, want_perm = _host_split(scene, scale)
    got, perm = cli.split_room(scene, scale, device)
    assert perm.device.type == torch.device(device).type
    np.testing.assert_array_equal(perm.cpu().numpy(), want_perm)
    for name, g, w in zip(want._fields, got, want):
        assert g.device.type == torch.device(device).type, name
        g = g.cpu().numpy()
        assert (g.dtype, g.shape) == (w.dtype, w.shape), name
        np.testing.assert_array_equal(g, w, err_msg=name)
    return got, want


def _ties(room):  # x to the centimetre: many equal keys, kept in the room's order
    room["xyz"] = room["xyz"].copy()
    room["xyz"][:, 0] = np.round(room["xyz"][:, 0], 2)
    return room


def _odd(room):  # a point count that is not a multiple of 4
    return {k: v[:len(v) - 3] if isinstance(v, np.ndarray) else v for k, v in room.items()}


def _sparse_ids(room):  # superpoint ids spread far wider than the room: the sorted path
    return dict(room, spp=np.asarray(room["spp"]) * 1_000_003 + 7)


def _one_superpoint(room):  # each piece's one id follows the last piece's, equal to it
    return dict(room, spp=np.full(len(room["xyz"]), 7, np.int64))


def _piece_unlabelled(room):  # one piece's instances all -100
    order = np.argsort(room["xyz"][:, 0], kind="stable")
    inst = np.arange(len(order)) % 9
    inst[order[2::cli.X4_PIECES]] = -100
    return dict(room, instance=inst, semantic=inst % 13)


def _unscaled(room):  # no xyz_scaled: xyz * scale in float32
    return {k: v for k, v in room.items() if k != "xyz_scaled"}


@pytest.fixture(scope="module")
def fixture_room(tmp_path_factory):
    """The real-format fixture room (``tests/fixtures/s3dis_raw``) through
    the port's ``prepare_s3dis`` and a test load, transformed for the test."""
    import os.path as osp

    from gapro_tpu_torch.tools import prepare_s3dis

    out = str(tmp_path_factory.mktemp("s3dis"))
    raw = osp.join(osp.dirname(osp.abspath(__file__)), "fixtures", "s3dis_raw")
    assert prepare_s3dis.main(["--data_dir", raw, "--out", out, "--areas", "5"]) == 0
    ds = S3DISDataset(out, prefix="Area_5", training=False)
    return transform_test(ds.load(0), SCALE)


@pytest.mark.parametrize("case", ["ties", "odd", "sparse_ids", "one_superpoint",
                                  "piece_unlabelled", "unscaled", "fixture"])
def test_split_room_equals_the_host_split(case, request):
    """``split_room`` on the CPU: the batch equals ``points_to_batch_np`` of
    ``split_pieces`` field for field (dtype and padding included), and
    ``perm`` the pieces' ``piece_indices`` in order."""
    if case == "fixture":
        scene = request.getfixturevalue("fixture_room")
        assert {"prob", "mu", "var"} <= set(scene)
    else:
        scene = dict(ties=_ties, odd=_odd, sparse_ids=_sparse_ids, one_superpoint=_one_superpoint,
                     piece_unlabelled=_piece_unlabelled, unscaled=_unscaled)[case](
            _room(5, labels=True))
    got, want = _assert_split_equal(scene, "cpu")
    assert int(want.valid.sum()) == len(scene["xyz"]) < len(want.valid)
    if case == "ties":
        assert len(np.unique(scene["xyz"][:, 0])) < len(scene["xyz"]) // 4
    if case == "piece_unlabelled":  # 4 | n here: pieces of equal length
        k = len(scene["xyz"]) // cli.X4_PIECES
        assert k * cli.X4_PIECES == len(scene["xyz"])
        assert (want.instance[2 * k:3 * k] == -100).all() and (want.instance[3 * k:] > 8).any()


@pytest.mark.gpu
def test_split_room_on_the_card_equals_the_host_split():
    """As on the CPU, on the card: a room of ~0.9 M points at the S3DIS
    cell's scale (x to the centimetre for ties, a count not a multiple of
    4), and the merge's inverse built there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(11)
    n = 900_003
    xyz = rng.uniform(0.0, 8.0, (n, 3))
    xyz[:, 0] = np.round(xyz[:, 0], 2)
    room = transform_test(dict(
        xyz=xyz.astype(np.float32), rgb=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        semantic=rng.integers(0, 13, n), instance=rng.integers(-1, 40, n),
        spp=rng.integers(0, 8000, n)), 50)
    _assert_split_equal(room, "cuda", 50)
    _assert_split_equal(_unscaled(room), "cuda", 50)
    perm = cli.split_room(room, 50, "cuda")[1]
    p2v = torch.arange(n + 77, device="cuda") * 3
    inv = np.empty(n, np.int64)
    inv[perm.cpu().numpy()] = np.arange(n)
    np.testing.assert_array_equal(cli.room_point2voxel(p2v, perm).cpu().numpy(),
                                  p2v.cpu().numpy()[inv])


@pytest.mark.parametrize("on_device", [False, True])
def test_room_point2voxel_equals_the_host_inverse(on_device):
    """The merge with ``perm`` a tensor (the split's) or an array: the x4
    batch's ``point2voxel`` taken through the host's inverse permutation."""
    room = _room(4)
    perm = cli.split_room(room, SCALE)[1]
    n = len(perm)
    p2v = torch.randperm(n + 50, generator=torch.Generator().manual_seed(0))
    inv = np.empty(n, np.int64)
    inv[perm.numpy()] = np.arange(n)
    got = cli.room_point2voxel(p2v, perm if on_device else perm.numpy())
    np.testing.assert_array_equal(got.numpy(), p2v.numpy()[inv])


def test_prepare_counts_a_batch_already_on_its_device():
    """``prepare.on_device`` counts 1 for the split's batch, passed through
    as it is; a numpy batch is uploaded (``prepare.upload``), counted 0."""
    room = _room()
    points = cli.split_room(room, SCALE)[0]
    profiling.enable(True)
    assert upload_point_batch(points, "cpu") is points
    assert profiling.drain()["counts"] == {"prepare.on_device": 1}
    host = _host_split(room)[0]
    got = upload_point_batch(host, "cpu")
    record = profiling.drain()
    assert "prepare.on_device" not in record["counts"]
    assert [s.name for s in record["spans"]] == ["prepare.upload"]
    for g, w in zip(got, points):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_save_pointwise_writes_the_room_order(tmp_path):
    """``save_pointwise`` with the split's ``perm`` (a tensor): each point
    takes its voxel's heads in the room's order, as the host's inverse
    permutation of the pieces' points gives them."""
    room = _room(4)
    perm = cli.split_room(room, SCALE)[1]
    n = len(perm)
    g = torch.Generator().manual_seed(1)
    p2v = torch.randint(0, 300, (n + 20,), generator=g)
    outputs = dict(semantic_scores=torch.randn(300, 13, generator=g),
                   corners_offset=torch.randn(300, 6, generator=g))
    cli.save_pointwise(str(tmp_path), "room", outputs, p2v, n, perm)
    inv = np.empty(n, np.int64)
    inv[perm.numpy()] = np.arange(n)
    voxel = p2v.numpy()[:n][inv]
    corners = outputs["corners_offset"].numpy()[voxel]
    np.testing.assert_array_equal(np.load(tmp_path / "semantic_pred" / "room.npy"),
                                  outputs["semantic_scores"].argmax(1).numpy()[voxel])
    np.testing.assert_array_equal(np.load(tmp_path / "offset_vertices_pred" / "room.npy"), corners)
    np.testing.assert_array_equal(np.load(tmp_path / "offset_pred" / "room.npy"),
                                  (corners[:, :3] + corners[:, 3:]) / 2)
