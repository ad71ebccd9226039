"""On the card (``gpu``), the paths the port's last modules added; this
file imports no JAX, so that the card's machine, which has none, runs it:

    python -m pytest --noconftest -m gpu tests/test_torch_card_tools.py

* the native segmentator built from its source into an empty build
  directory and run (two plates joined at a crease split);
* the GP labeler's sweep over two devices (every card, or ``cuda:0``
  twice) and with ``batch_submit``, equal bit for bit to one card's;
* ``chip_smoke.py``'s checkpoint phase: full-width fake reference
  checkpoints of ISBNet and SPFormer through ``convert_torch_ckpt``'s CLI,
  loaded by ``load_model_weights``, and one request each through the
  kernels, held against the plain versions;
* ``device_memory_stats``'s keys on the card, and ``to_host``'s counts.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gapro_tpu_torch.data import make_synthetic_scene
from gapro_tpu_torch.labeler import LabelerConfig, generate_scene_labels_stream, instance_info
from gapro_tpu_torch.native import segmentator
from gapro_tpu_torch.utils import profiling


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _plate(nx, ny, at):
    verts = np.array([at(i, j) for i in range(nx) for j in range(ny)], np.float32)
    a = np.array([i * ny + j for i in range(nx - 1) for j in range(ny - 1)])
    faces = np.concatenate([np.stack([a, a + 1, a + ny], 1), np.stack([a + 1, a + ny + 1, a + ny],
                                                                      1)])
    return verts, faces


@pytest.mark.gpu
def test_segmentator_builds_from_a_clean_build_directory(card, tmp_path, monkeypatch):
    monkeypatch.setattr(segmentator, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(segmentator, "LIB", tmp_path / "libsegmentator.so")
    monkeypatch.setattr(segmentator, "_lib", None)
    v1, f1 = _plate(12, 12, lambda i, j: (i * 0.1, j * 0.1, 0.0))
    v2, f2 = _plate(12, 12, lambda i, j: (1.1, j * 0.1, i * 0.1))
    labels = segmentator.segment_mesh(np.concatenate([v1, v2]),
                                      np.concatenate([f1, f2 + len(v1)]), kthr=0.5, seg_min=10)
    assert (tmp_path / "libsegmentator.so").exists()
    n = len(v1)
    assert np.bincount(labels[:n]).argmax() != np.bincount(labels[n:]).argmax()


def _scenes(n):
    out = []
    for seed in range(n):
        sc = make_synthetic_scene(seed=seed, n_objects=4, points_per_object=300, n_floor=800,
                                  n_wall=500, room=5.0)
        _, cls, boxes, vols, _ = instance_info(sc.xyz, sc.instance_label, sc.semantic_label)
        out.append(dict(coords=sc.xyz, gp_feats=np.concatenate([sc.xyz, sc.rgb], 1),
                        spp=sc.spp, instance_cls=cls, instance_box=boxes,
                        instance_box_volume=vols))
    return out


@pytest.mark.gpu
def test_stream_across_cards_equals_one_card(card):
    n = torch.cuda.device_count()
    many = [torch.device("cuda", i) for i in range(n)] if n > 1 else ["cuda:0", "cuda:0"]
    scenes = _scenes(5)

    def sweep(**kw):
        return [lab for _, lab in generate_scene_labels_stream(
            iter(scenes), LabelerConfig(training_iter=20), window=2, **kw)]

    one = sweep(devices=["cuda:0"])
    for kw in (dict(devices=many), dict(devices=many, batch_submit=True)):
        for g, w in zip(sweep(**kw), one):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_converted_full_width_checkpoints_serve(card, tmp_path):
    out = chip_smoke.ckpt_phase(card, chip_smoke.scene_inputs(0), str(tmp_path))
    assert out["isbnet"]["launches"]["fps"] == 4 and out["isbnet"]["launches"]["dyco"] == 3
    assert out["spformer"]["launches"]["subm_conv"] > 0


@pytest.mark.gpu
def test_device_memory_stats_on_the_card(card):
    x = torch.empty(2**20, device=card)
    mem = profiling.device_memory_stats(card)
    assert list(mem) == ["bytes_in_use", "peak_bytes_in_use", "bytes_limit", "bytes_reserved"]
    assert mem["peak_bytes_in_use"] >= mem["bytes_in_use"] >= x.numel() * 4
    assert mem["bytes_limit"] > mem["bytes_reserved"] > 0


@pytest.mark.gpu
def test_to_host_counts_the_card_reads(card):
    """``profiling.to_host`` reads a card tensor back and counts the read
    and its bytes, in all and by site; off, it counts nothing."""
    x = torch.arange(1000, dtype=torch.float32, device=card)
    profiling.enable(True)
    try:
        profiling.drain()
        assert torch.equal(profiling.to_host(x, "a"), x.cpu())
        profiling.to_host(x[:10].int(), "b")
        counts = profiling.drain()["counts"]
    finally:
        profiling.enable(False)
    assert counts == {"host_syncs": 2, "host_syncs.a": 1, "host_syncs.b": 1,
                      "d2h_bytes": 4040, "d2h_bytes.a": 4000, "d2h_bytes.b": 40}
    profiling.to_host(x, "a")
    assert profiling.drain()["counts"] == {}
