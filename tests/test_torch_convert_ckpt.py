"""The port's loader of the reference's checkpoints
(``gapro_tpu_torch/tools/convert_torch_ckpt.py``) against the JAX
package's converter (``tools/convert_torch_ckpt.py``), on the CPU.

* ISBNet (tiny, full-size as ``tests/test_convert_ckpt.py``'s, and
  ``semantic_only``) and SPFormer (tiny and full-size): the port's
  ``state_dict`` equals ``convert.flax_to_state_dict`` of the JAX
  converter's tree key for key and bit for bit, the reports are equal, and
  the port's model of that configuration loads it strictly.
* The port's backbone with the converted weights against
  ``tests/test_convert_ckpt.py``'s dense numpy oracle of the reference
  backbone, within that test's 1e-3 (fp32 sums in another order through
  3 levels of 27-tap convs).
* Tap calibration recovers a planted z-mirror with the port's model as the
  probe (as ``tests/test_convert_ckpt.py:test_tap_calibration_recovers_
  planted_mirror``).
* The CLI turns a ``.pth`` (a ``module.``-prefixed ``state_dict`` under
  ``state_dict``, or SPFormer's under ``net``) into a checkpoint that
  ``load_model_weights`` loads entry for entry.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gapro_tpu_torch import convert
from gapro_tpu_torch.data import make_synthetic_scene
from gapro_tpu_torch.models import isbnet, prepare
from gapro_tpu_torch.models.spformer import SPFormer, SPFormerConfig
from gapro_tpu_torch.tools import convert_torch_ckpt as cc
from gapro_tpu_torch.train.checkpoint import load_checkpoint, load_model_weights

from tests.test_convert_ckpt import C, DD, M, NB, _fake_state_dict, _oracle_backbone
import convert_torch_ckpt as jcc  # noqa: E402  (tools/ on the path: tests/test_convert_ckpt.py)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _isbnet_cfg(c=C, nb=NB, dd=DD, m=M, **kw):
    return isbnet.ISBNetConfig(channels=c, num_blocks=nb, n_sample_pa1=64, n_queries=16,
                               neighbor=8, dec_dim=dd, mask_dim_out=m, spp_cap=256, **kw)


def _same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


ISBNET_CASES = {"tiny": dict(seed=0), "full size": dict(seed=1, C=32, NB=7, DD=128, M=32),
                "semantic_only": dict(seed=2, semantic_only=True)}


@pytest.mark.parametrize("case", list(ISBNET_CASES))
def test_isbnet_state_dict_matches_jax(case):
    kw = dict(ISBNET_CASES[case])
    seed, semantic_only = kw.pop("seed"), kw.pop("semantic_only", False)
    sd = _fake_state_dict(np.random.default_rng(seed), **kw)
    got, report = cc.convert_state_dict(sd, semantic_only=semantic_only)
    tree, want_report = jcc.convert_state_dict(sd, semantic_only=semantic_only)
    assert report == want_report and not report["missing_torch_keys"]
    assert bool(report["unused_torch_keys"]) == semantic_only  # the instance heads
    _same_state(got, convert.flax_to_state_dict(tree))
    dims = dict(c=kw.get("C", C), nb=kw.get("NB", NB), dd=kw.get("DD", DD), m=kw.get("M", M))
    model = isbnet.ISBNet(_isbnet_cfg(**dims, semantic_only=semantic_only), device="cpu")
    model.load_state_dict(got, strict=True)


SPF_CASES = {"tiny": dict(media=8, nb=3, d_model=32, nhead=4, num_layer=2, num_query=16,
                          hidden=64, num_class=18),
             "full size": chip_smoke.CKPT_SPFORMER}


@pytest.mark.parametrize("case", list(SPF_CASES))
def test_spformer_state_dict_matches_jax(case):
    dims = SPF_CASES[case]
    sd = chip_smoke.fake_reference("spformer", 3, **dims)
    got, report = cc.convert_spformer_state_dict(sd, nhead=dims["nhead"])
    tree, want_report = jcc.convert_spformer_state_dict(sd, nhead=dims["nhead"])
    assert report == want_report
    assert not report["missing_torch_keys"] and not report["unused_torch_keys"]
    _same_state(got, convert.flax_to_state_dict(tree))
    model = SPFormer(SPFormerConfig(media=dims["media"], blocks=dims["nb"],
                                    num_class=dims["num_class"], num_layer=dims["num_layer"],
                                    num_query=dims["num_query"], d_model=dims["d_model"],
                                    nhead=dims["nhead"], hidden_dim=dims["hidden"]), device="cpu")
    model.load_state_dict(got, strict=True)


def _prepared(seed):
    s = make_synthetic_scene(seed=seed, n_objects=3, points_per_object=200, n_floor=300,
                             n_wall=200)
    pb = prepare.points_to_batch_np([dict(xyz=s.xyz, rgb=s.rgb, spp=s.spp,
                                          semantic=s.semantic_label,
                                          instance=s.instance_label)], voxel_scale=10)
    return prepare.prepare_voxel_batch(prepare.upload_point_batch(pb, "cpu"), pb.coords.shape[0],
                                       1, NB, 256, 0.7)


def _tiny_model(sd):
    model = isbnet.ISBNet(_isbnet_cfg(), device="cpu")
    model.load_state_dict(cc.convert_state_dict(sd)[0], strict=True)
    return model.eval()


@torch.no_grad()
def test_backbone_matches_the_dense_oracle():
    sd = _fake_state_dict(np.random.default_rng(1))
    batch = _prepared(3).batch
    model = _tiny_model(sd)
    nv = batch.plan.levels[0].grid.num_voxels
    mine = model.backbone(model.backbone_input(batch), batch.plan)[:nv].numpy()
    coords = batch.plan.levels[0].grid.coords[:nv, 1:].numpy()
    in_feats = torch.cat([batch.feats, batch.coords_float], 1)[:nv].numpy()
    np.testing.assert_allclose(mine, _oracle_backbone(sd, coords, in_feats), rtol=1e-3,
                               atol=1e-3)


def test_tap_calibration_recovers_a_planted_mirror(monkeypatch):
    sd = _fake_state_dict(np.random.default_rng(3))
    batch = _prepared(5).batch
    model = isbnet.ISBNet(_isbnet_cfg(), device="cpu").eval()

    @torch.no_grad()
    def run_feats(state):
        model.load_state_dict(state, strict=True)
        out, _ = model.trunk(batch)
        return model.run_mask_tower(out["voxel_feats"], batch.valid).numpy()

    planted = dict(cc.tap_candidates())["flips(z,y,x)=(1, 0, 0)"]
    assert [p for _, p in cc.tap_candidates(True)] == [p for _, p in jcc.tap_candidates(True)]
    monkeypatch.setattr(cc, "TAP_PERM", planted)
    ref = run_feats(cc.convert_state_dict(sd)[0])
    monkeypatch.setattr(cc, "TAP_PERM", None)
    results = cc.calibrate_tap_perm(sd, run_feats, ref)
    corr, _, perm = results[0]
    assert perm == planted and corr > 0.999, results[:3]
    assert results[1][0] < 0.99, results[:3]
    assert cc.TAP_PERM is None


def test_cli_round_trip(tmp_path, capsys):
    sd = _fake_state_dict(np.random.default_rng(4))
    ref = tmp_path / "isbnet.pth"
    torch.save({"state_dict": {"module." + k: torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}, ref)
    out = tmp_path / "isbnet_converted.pth"
    assert cc.main([str(ref), str(out)]) == 0
    assert "unused: 0, missing: 0" in capsys.readouterr().out
    model = isbnet.ISBNet(_isbnet_cfg(), seed=7, device="cpu")
    saved = load_checkpoint(str(out))["model"]
    assert set(saved) == set(model.state_dict())
    load_model_weights(str(out), model)
    _same_state(model.state_dict(), saved)
    _same_state(saved, convert.flax_to_state_dict(jcc.convert_state_dict(sd)[0]))

    dims = SPF_CASES["tiny"]
    ref = tmp_path / "spformer.pth"
    torch.save({"net": {k: torch.from_numpy(np.asarray(v)) for k, v in
                        chip_smoke.fake_reference("spformer", 5, **dims).items()}}, ref)
    assert cc.main([str(ref), str(tmp_path / "spformer_converted.pth"), "--nhead", "4"]) == 0
    assert "(spformer, unet levels: 3, unused: 0, missing: 0)" in capsys.readouterr().out
