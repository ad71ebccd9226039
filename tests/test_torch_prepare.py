"""The port's offline data preparation against the JAX package's, on the
CPU: ``data/ply.py``, the native segmentator (``native/``), and the
``prepare_scannet`` and ``prepare_s3dis`` tools.

Everything here is host numpy and C++, so every comparison is exact:
``read_ply``'s arrays, ``segment_mesh``'s labels, and the prepared files
(xyz, rgb, sem, inst and superpoints) array for array. The port's
segmentator is built from its own source into ``gapro_tpu_torch/_build/``
(the JAX wrapper builds beside its source).
"""

import importlib.util
import os.path as osp
import runpy
import sys

import numpy as np
import pytest
import torch

from gapro_tpu.data.dataset import S3DISDataset as JaxS3DIS
from gapro_tpu.data.dataset import ScanNetDataset as JaxScanNet
from gapro_tpu.data.ply import read_ply as jax_read_ply
from gapro_tpu.native.segmentator import segment_mesh as jax_segment_mesh
from gapro_tpu_torch.data.dataset import S3DISDataset, ScanNetDataset
from gapro_tpu_torch.data.ply import read_ply
from gapro_tpu_torch.native import segmentator
from gapro_tpu_torch.tools import prepare_s3dis, prepare_scannet

from tests.test_segmentator import _grid_plate

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
RAW = osp.join(REPO, "tests", "fixtures", "raw_scans")
S3DIS_RAW = osp.join(REPO, "tests", "fixtures", "s3dis_raw")
PLY = osp.join(RAW, "scene0000_00_vh_clean_2.ply")
TSV = osp.join(RAW, "scannetv2-labels.combined.tsv")


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  osp.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_ply(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", ["scene0000_00_vh_clean_2.ply",
                                  "scene0000_00_vh_clean_2.labels.ply"])
def test_read_ply_binary_matches_jax(name):
    _same_ply(read_ply(osp.join(RAW, name)), jax_read_ply(osp.join(RAW, name)))


def test_read_ply_ascii_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(7, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (7, 3))
    faces = rng.integers(0, 7, (5, 3))
    lines = ["ply", "format ascii 1.0", "element vertex 7", "property float x",
             "property float y", "property float z", "property uchar red",
             "property uchar green", "property uchar blue", "element face 5",
             "property list uchar int vertex_indices", "end_header"]
    lines += [" ".join([*(repr(float(v)) for v in p), *(str(int(c)) for c in q)])
              for p, q in zip(xyz, rgb)]
    lines += ["3 " + " ".join(str(int(i)) for i in f) for f in faces]
    path = tmp_path / "ascii.ply"
    path.write_text("\n".join(lines) + "\n")
    got = read_ply(str(path))
    _same_ply(got, jax_read_ply(str(path)))
    np.testing.assert_array_equal(got["face"], faces)
    np.testing.assert_array_equal(np.stack([got["vertex"][c] for c in "xyz"], 1), xyz)


def _fixture_mesh():
    mesh = read_ply(PLY)
    v = mesh["vertex"]
    xyz = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    return xyz - xyz.mean(0), mesh["face"]


def _plates(n=12):
    v1, f1 = _grid_plate(n, n, lambda i, j: (i * 0.1, j * 0.1, 0.0))
    v2, f2 = _grid_plate(n, n, lambda i, j: ((n - 1) * 0.1, j * 0.1, i * 0.1))
    return np.concatenate([v1, v2]), np.concatenate([f1, f2 + len(v1)])


@pytest.mark.parametrize("case,kw", [("fixture mesh", {}), ("plates", dict(kthr=0.5, seg_min=10)),
                                     ("one plate", dict(kthr=0.5, seg_min=5))])
def test_segment_mesh_matches_jax(case, kw):
    if case == "fixture mesh":
        verts, faces = _fixture_mesh()
    elif case == "plates":
        verts, faces = _plates()
    else:
        verts, faces = _grid_plate(10, 10, lambda i, j: (i * 0.1, j * 0.1, 0.0))
    got = segmentator.segment_mesh(verts, faces, **kw)
    assert got.dtype == np.int32 and got.shape == (len(verts),)
    np.testing.assert_array_equal(got, jax_segment_mesh(verts, faces, **kw))
    if case == "plates":  # the crease splits them
        n = len(verts) // 2
        assert np.bincount(got[:n]).argmax() != np.bincount(got[n:]).argmax()


def test_segmentator_builds_into_the_build_directory():
    lib = segmentator.build()
    assert lib.parent == segmentator.BUILD_DIR and lib.name == "libsegmentator.so"
    assert lib.exists() and not osp.exists(osp.join(osp.dirname(segmentator.SRC),
                                                    "libsegmentator.so"))


def _load_pth(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def _same_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_prepare_scan_matches_jax():
    jt = _jax_tool("prepare_scannet")
    raw2name = prepare_scannet.load_raw2name(TSV)
    assert raw2name == jt.load_raw2name(TSV)
    for test_mode in (True, False):
        scan, tup, spp = prepare_scannet.prepare_scan(PLY, raw2name, test_mode=test_mode)
        jscan, jtup, jspp = jt.prepare_scan(PLY, raw2name, test_mode=test_mode)
        assert scan == jscan == "scene0000_00"
        _same_arrays(tup, jtup)
        _same_arrays([spp], [jspp])
    assert (tup[3] >= 0).any()  # some instance survives the wall and floor drop


@pytest.fixture(scope="module")
def prepared_scannet(tmp_path_factory):
    """The scan through the port's CLI and through the JAX tool's."""
    out, jout = tmp_path_factory.mktemp("torch_scannet"), tmp_path_factory.mktemp("jax_scannet")
    assert prepare_scannet.main(["--scans_dir", RAW, "--out", str(out), "--split", "train",
                                 "--labels_tsv", TSV]) == 0
    argv = sys.argv
    sys.argv = ["prepare_scannet.py", "--scans_dir", RAW, "--out", str(jout), "--split", "train",
                "--labels_tsv", TSV]
    try:
        runpy.run_path(osp.join(REPO, "tools", "prepare_scannet.py"), run_name="__main__")
    finally:
        sys.argv = argv
    return out, jout


def test_prepare_scannet_cli_matches_jax(prepared_scannet):
    out, jout = prepared_scannet
    for rel in ("train/scene0000_00_inst_nostuff.pth", "superpoints/scene0000_00.pth"):
        got, want = _load_pth(out / rel), _load_pth(jout / rel)
        _same_arrays(got if isinstance(got, tuple) else [got],
                     want if isinstance(want, tuple) else [want])


def test_prepared_scan_loads_as_in_jax(prepared_scannet):
    out, jout = prepared_scannet
    got = ScanNetDataset(str(out), prefix="train", training=False).load(0)
    want = JaxScanNet(str(jout), prefix="train", training=False).load(0)
    assert got["scan_id"] == want["scan_id"] == "scene0000_00"
    for k in ("xyz", "rgb", "semantic", "instance", "spp"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def _room_dir():
    return osp.join(S3DIS_RAW, "Area_5", "office_1")


def test_prepare_room_and_superpoints_match_jax():
    jt = _jax_tool("prepare_s3dis")
    room = prepare_s3dis.prepare_room(_room_dir())
    _same_arrays(room, jt.prepare_room(_room_dir()))
    spp = prepare_s3dis.geometric_superpoints(room[0])
    _same_arrays([spp], [jt.geometric_superpoints(room[0])])
    assert len(np.unique(spp)) > 1


def test_prepare_s3dis_cli_matches_jax_and_loads(tmp_path):
    out, jout = tmp_path / "torch", tmp_path / "jax"
    assert prepare_s3dis.main(["--data_dir", S3DIS_RAW, "--out", str(out), "--areas", "5"]) == 0
    argv = sys.argv
    sys.argv = ["prepare_s3dis.py", "--data_dir", S3DIS_RAW, "--out", str(jout), "--areas", "5"]
    try:
        runpy.run_path(osp.join(REPO, "tools", "prepare_s3dis.py"), run_name="__main__")
    finally:
        sys.argv = argv
    for rel in ("preprocess/Area_5_office_1_inst_nostuff.pth", "superpoints/Area_5_office_1.pth"):
        got, want = _load_pth(out / rel), _load_pth(jout / rel)
        _same_arrays(got if isinstance(got, tuple) else [got],
                     want if isinstance(want, tuple) else [want])
    for training in (False, True):
        got = S3DISDataset(str(out), prefix="Area_5", training=training).load(0)
        want = JaxS3DIS(str(jout), prefix="Area_5", training=training).load(0)
        for k in ("xyz", "rgb", "semantic", "instance", "spp"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
