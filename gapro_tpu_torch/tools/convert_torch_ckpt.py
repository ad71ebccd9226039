"""Load a reference torch checkpoint (a spconv ``.pth`` ``state_dict``)
into the port: the logic of ``tools/convert_torch_ckpt.py`` without jax or
flax, straight to the port's ``state_dict``. ISBNet checkpoints map to
``gapro_tpu_torch.models.isbnet.ISBNet``, SPFormer checkpoints (detected by
``decoder.query.weight``) to ``gapro_tpu_torch.models.spformer.SPFormer``.

    python -m gapro_tpu_torch.tools.convert_torch_ckpt ref_ckpt.pth out.pth \
        [--semantic-only] [--model auto|isbnet|spformer] [--nhead 8]

The output is a checkpoint that ``train/checkpoint.py:load_model_weights``
loads, so ``tools/train.py --pretrain out.pth`` and ``tools/test.py CONFIG
out.pth`` take it. The reference file is read with ``torch.load(...,
weights_only=False)`` (it holds numpy and plain objects beside tensors), so
name only a file you trust.

Key-name map: the reference module tree (ISBNet/isbnet/model/isbnet.py:
89-209, blocks.py:137-255, module_utils.py:9-170) is walked into the JAX
package's flax names, and ``convert.flax_to_state_dict`` takes them to the
port's. Layouts:

  * spconv 2.x kernels are KRSC ``(out, kd, kh, kw, in)``; spconv 1.x used
    ``(kd, kh, kw, in, out)``. Both are detected by shape and normalized to
    ``[k^3, in, out]`` with row-major (dz, dy, dx) taps (``TAP_PERM``
    reorders the taps; ``--calibrate-scene`` selects it from data).
  * torch Linear ``(out, in)`` / ConvNd-1x1 ``(out, in, 1...)`` -> the port's
    ``weight`` (out, in), by way of the flax kernel ``(in, out)``.
  * BatchNorm weight/bias/running_mean/running_var -> the same names.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..convert import flax_to_state_dict

# tap-order permutation applied to spconv spatial taps; identity = row-major
# (dz, dy, dx) matching sparse/plan.py.  Never hand-edit: run
# --calibrate-scene/--calibrate-feats (below) to select it from data.
TAP_PERM = None


def _tap(w27):
    if TAP_PERM is None or len(w27) != 27:  # 1x1x1 kernels have no taps
        return w27
    return w27[np.asarray(TAP_PERM)]


def tap_candidates(include_transposes=False):
    """Candidate spconv->ours tap reorderings for --calibrate-taps.

    Our tap index k encodes row-major (dz, dy, dx) offsets
    (sparse/plan.py:_SUBM_OFFSETS). If spconv's enumeration
    (ISBNet/isbnet/model/blocks.py:183-233 consumes [27, Cin, Cout])
    mirrors an axis, the weight for our (dz, dy, dx) lives at spconv row
    (2-dz, dy, dx) etc. — 8 sign combinations; --calibrate-transposes
    adds the 6 axis orderings (48 candidates total) in case the
    (kD, kH, kW) <-> (z, y, x) naming is permuted, not just flipped.

    Yields (name, perm) with perm[k] = source spconv row for our tap k;
    the identity candidate is named "identity" and yields perm=None.
    """
    import itertools

    k = np.arange(27)
    comp = [k // 9, (k // 3) % 3, k % 3]  # dz, dy, dx of OUR tap k
    orders = (itertools.permutations((0, 1, 2)) if include_transposes
              else [(0, 1, 2)])
    for order in orders:
        for flips in itertools.product((0, 1), repeat=3):
            src = [comp[order[i]] for i in range(3)]
            src = [2 - s if f else s for s, f in zip(src, flips)]
            perm = src[0] * 9 + src[1] * 3 + src[2]
            if order == (0, 1, 2) and flips == (0, 0, 0):
                yield "identity", None
            else:
                name = f"flips(z,y,x)={flips}"
                if order != (0, 1, 2):
                    name = f"axes={order} " + name
                yield name, perm.tolist()


def calibrate_tap_perm(sd, run_feats, ref_feats, model="isbnet",
                       include_transposes=False, nhead=8,
                       semantic_only=False):
    """Select TAP_PERM by activation correlation against reference features
    (the reference exports per-point mask-tower deep features via
    ISBNet/tools/export_features.py + isbnet.py save_deepfeatures_path).

    ``run_feats(state_dict) -> [N, D]`` runs the port's feature probe on one
    scene with a converted ``state_dict``; ``ref_feats`` is the reference's
    [N, D] export for the same scene. Every candidate reordering converts +
    runs + correlates; a correct tap order shows corr ~= 1.0 and the mirrors
    fall well below. Returns results sorted best-first: [(corr, name,
    perm), ...].
    """
    global TAP_PERM
    ref = np.asarray(ref_feats, np.float64).ravel()
    ref = (ref - ref.mean()) / (ref.std() + 1e-12)
    saved, results = TAP_PERM, []
    try:
        for name, perm in tap_candidates(include_transposes):
            TAP_PERM = perm
            if model == "spformer":
                state, _ = convert_spformer_state_dict(sd, nhead=nhead)
            else:
                state, _ = convert_state_dict(sd, semantic_only=semantic_only)
            got = np.asarray(run_feats(state), np.float64).ravel()
            got = (got - got.mean()) / (got.std() + 1e-12)
            results.append((float(np.dot(ref, got) / len(ref)), name, perm))
    finally:
        TAP_PERM = saved
    results.sort(key=lambda r: r[0], reverse=True)
    return results


def spconv_kernel(w) -> np.ndarray:
    """spconv conv weight -> [k^3, in, out] (row-major (dz, dy, dx) taps)."""
    w = np.asarray(w)
    assert w.ndim == 5, w.shape
    if w.shape[0] == w.shape[1] == w.shape[2]:  # spconv1: (kd, kh, kw, in, out)
        k3 = w.shape[0] * w.shape[1] * w.shape[2]
        return _tap(w.reshape(k3, w.shape[3], w.shape[4]))
    # spconv2 KRSC: (out, kd, kh, kw, in)
    assert w.shape[1] == w.shape[2] == w.shape[3], w.shape
    k3 = w.shape[1] * w.shape[2] * w.shape[3]
    return _tap(np.transpose(w, (1, 2, 3, 4, 0)).reshape(k3, w.shape[4], w.shape[0]))


def linear(w) -> np.ndarray:
    """torch Linear/Conv1d(1)/Conv2d(1x1) weight -> flax Dense kernel [in, out]."""
    w = np.asarray(w)
    w = w.reshape(w.shape[0], w.shape[1])  # drop trailing 1-dims
    return np.ascontiguousarray(w.T)


def conv1x1(w) -> np.ndarray:
    """spconv 1x1 kernel (either layout) -> [in, out]."""
    w = np.asarray(w)
    if w.ndim == 5:
        w = spconv_kernel(w)[0]
        return w
    return linear(w)


class _Tree:
    """Param/batch_stats accumulator with missing/unused-key accounting."""

    def __init__(self, sd):
        self.sd = {k: np.asarray(v) for k, v in sd.items()}
        self.used = set()
        self.params: dict = {}
        self.stats: dict = {}
        self.missing: list = []

    def t(self, key):
        if key not in self.sd:
            self.missing.append(key)
            return None
        self.used.add(key)
        return self.sd[key]

    def _set(self, root, path, leaf):
        d = root
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = leaf

    def put(self, path, value):
        if value is not None:
            self._set(self.params, path, value)

    def bn(self, torch_prefix, *flax_path):
        w = self.t(f"{torch_prefix}.weight")
        b = self.t(f"{torch_prefix}.bias")
        rm = self.t(f"{torch_prefix}.running_mean")
        rv = self.t(f"{torch_prefix}.running_var")
        self.t(f"{torch_prefix}.num_batches_tracked")  # consume silently
        if w is not None:
            self._set(self.params, flax_path + ("scale",), w)
            self._set(self.params, flax_path + ("bias",), b)
            self._set(self.stats, flax_path + ("mean",), rm)
            self._set(self.stats, flax_path + ("var",), rv)

    def dense(self, torch_prefix, *flax_path, bias=True):
        w = self.t(f"{torch_prefix}.weight")
        if w is not None:
            self._set(self.params, flax_path + ("kernel",), linear(w))
        if bias:
            b = self.t(f"{torch_prefix}.bias")
            if b is not None:
                self._set(self.params, flax_path + ("bias",), b)


def _convert_unet(tr: _Tree, prefix, flax_path, n_levels):
    """Recursive UBlock (blocks.py:198-255) -> sparse/unet.py UBlock names."""

    def res_block(tp, fp):
        tr.bn(f"{tp}.conv_branch.0", *fp, "bn0")
        w = tr.t(f"{tp}.conv_branch.2.weight")
        if w is not None:
            tr.put(fp + ("conv0", "kernel"), spconv_kernel(w))
        tr.bn(f"{tp}.conv_branch.3", *fp, "bn1")
        w = tr.t(f"{tp}.conv_branch.5.weight")
        if w is not None:
            tr.put(fp + ("conv1", "kernel"), spconv_kernel(w))
        w = tr.sd.get(f"{tp}.i_branch.0.weight")
        if w is not None:
            tr.used.add(f"{tp}.i_branch.0.weight")
            tr.put(fp + ("i_branch", "Dense_0", "kernel"), conv1x1(w))

    for i in range(2):
        res_block(f"{prefix}.blocks.block{i}", flax_path + (f"block{i}",))
    if n_levels > 1:
        tr.bn(f"{prefix}.conv.0", *flax_path, "conv_bn")
        w = tr.t(f"{prefix}.conv.2.weight")
        if w is not None:
            tr.put(flax_path + ("down_kernel",), spconv_kernel(w))
        _convert_unet(tr, f"{prefix}.u", flax_path + ("u",), n_levels - 1)
        tr.bn(f"{prefix}.deconv.0", *flax_path, "deconv_bn")
        w = tr.t(f"{prefix}.deconv.2.weight")
        if w is not None:
            tr.put(flax_path + ("up_kernel",), spconv_kernel(w))
        for i in range(2):
            res_block(f"{prefix}.blocks_tail.block{i}", flax_path + (f"tail_block{i}",))


def _convert_mlp(tr: _Tree, prefix, flax_path, num_layers):
    """reference MLP (blocks.py:137-154): [Linear, BN, ReLU]*(n-1) + Linear."""
    ti = 0
    for i in range(num_layers - 1):
        tr.dense(f"{prefix}.{ti}", *flax_path, f"Dense_{i}")
        tr.bn(f"{prefix}.{ti + 1}", *flax_path, f"bn{i}")
        ti += 3
    tr.dense(f"{prefix}.{ti}", *flax_path, f"Dense_{num_layers - 1}")


def _convert_generic_mlp(tr: _Tree, prefix, flax_path, n_hidden,
                         output_use_norm=False):
    """reference GenericMLP (blocks.py:51-123) with norm: hidden
    [Conv, BN, ReLU]*, then output Conv (+BN if output_use_norm)."""
    ti = 0
    for i in range(n_hidden):
        tr.dense(f"{prefix}.layers.{ti}", *flax_path, f"Dense_{i}", bias=False)
        tr.bn(f"{prefix}.layers.{ti + 1}", *flax_path, f"bn{i}")
        ti += 3
    tr.dense(f"{prefix}.layers.{ti}", *flax_path, f"Dense_{n_hidden}")
    if output_use_norm:
        tr.bn(f"{prefix}.layers.{ti + 1}", *flax_path, "bn_out")


def _convert_shared_mlp(tr: _Tree, prefix, flax_path, n_layers):
    """pointnet-style SharedMLP (module_utils.py:9-33): layer{i}.conv/.bn.bn."""
    for i in range(n_layers):
        tr.dense(f"{prefix}.layer{i}.conv", *flax_path, f"Dense_{i}", bias=False)
        tr.bn(f"{prefix}.layer{i}.bn.bn", *flax_path, f"bn{i}")


def _convert_aggregator(tr: _Tree, prefix, flax_path):
    _convert_shared_mlp(tr, f"{prefix}.mlp_module1", flax_path + ("mlp1",), 2)
    _convert_shared_mlp(tr, f"{prefix}.mlp_module2", flax_path + ("mlp2",), 1)
    tr.dense(f"{prefix}.mlp_module3.0.conv", *flax_path, "mlp3a", "Dense_0", bias=False)
    tr.bn(f"{prefix}.mlp_module3.0.bn.bn", *flax_path, "mlp3a", "bn")
    tr.dense(f"{prefix}.mlp_module3.1.conv", *flax_path, "mlp3b", "Dense_0", bias=False)
    tr.bn(f"{prefix}.mlp_module3.1.bn.bn", *flax_path, "mlp3b", "bn")


def _isbnet_tree(sd, semantic_only=False):
    """torch state_dict (str -> array-like) -> {"params": ..., "batch_stats": ...},
    the flax-named tree of the JAX package's ISBNet. Returns (variables,
    report) where report lists unused torch keys and missing expected keys."""
    sd = {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}
    # infer depth from unet key nesting
    n_levels = 1
    probe = "unet"
    while f"{probe}.u.blocks.block0.conv_branch.2.weight" in sd:
        n_levels += 1
        probe = f"{probe}.u"

    tr = _Tree(sd)
    w = tr.t("input_conv.0.weight")
    if w is not None:
        tr.put(("backbone", "input_conv", "kernel"), spconv_kernel(w))
    _convert_unet(tr, "unet", ("backbone", "unet"), n_levels)
    tr.bn("output_layer.0", "backbone", "output_bn")

    _convert_mlp(tr, "semantic_linear", ("semantic_linear",), 2)
    _convert_mlp(tr, "offset_vertices_linear", ("offset_vertices_linear",), 2)
    _convert_mlp(tr, "box_conf_linear", ("box_conf_linear",), 2)

    if not semantic_only:
        _convert_mlp(tr, "mu_linear", ("mu_linear",), 3)
        _convert_mlp(tr, "logvar_linear", ("logvar_linear",), 3)
        _convert_aggregator(tr, "point_aggregator1", ("point_aggregator1",))
        _convert_aggregator(tr, "point_aggregator2", ("point_aggregator2",))
        _convert_generic_mlp(tr, "inst_shared_mlp", ("inst_shared_mlp",), 1,
                             output_use_norm=True)
        _convert_generic_mlp(tr, "inst_sem_head", ("inst_sem_head",), 2)
        _convert_generic_mlp(tr, "inst_conf_head", ("inst_conf_head",), 2)
        _convert_generic_mlp(tr, "inst_box_head", ("inst_box_head",), 2)
        for i in range(3):
            tr.dense(f"mask_tower.{i}.0.conv", f"mask_tower{i}", "Dense_0", bias=False)
            tr.bn(f"mask_tower.{i}.1", f"mask_tower{i}", "bn")
        tr.dense("mask_tower.3", "mask_out")
        for i in range(2):
            tr.dense(f"inst_mask_head.{i}.0.conv", f"inst_mask_head{i}", "Dense_0",
                     bias=False)
            tr.bn(f"inst_mask_head.{i}.1", f"inst_mask_head{i}", "bn")
        tr.dense("inst_mask_head.2", "controller")

    unused = sorted(set(sd) - tr.used)
    report = dict(unused_torch_keys=unused, missing_torch_keys=sorted(tr.missing),
                  n_levels=n_levels)
    return {"params": tr.params, "batch_stats": tr.stats}, report


# --------------------------------------------------------------------------- #
# SPFormer tree (SPFormer/spformer/model/spformer.py:38-69,
# backbone.py:91-219, query_decoder.py:101-138)
# --------------------------------------------------------------------------- #


def _ln(tr: _Tree, torch_prefix, *flax_path):
    """torch LayerNorm -> flax LayerNorm {scale, bias} (params only)."""
    w = tr.t(f"{torch_prefix}.weight")
    b = tr.t(f"{torch_prefix}.bias")
    if w is not None:
        tr.put(flax_path + ("scale",), w)
        tr.put(flax_path + ("bias",), b)


def _mha(tr: _Tree, torch_prefix, flax_path, nhead):
    """torch nn.MultiheadAttention -> flax MultiHeadDotProductAttention.

    in_proj_weight [3d, d] packs q/k/v each (out, in); flax kernels are
    [in, H, dh] with head-major packing, biases [H, dh]; out_proj (d, d)
    (out, in) -> out kernel [H, dh, d]. Both libraries scale attention
    logits by 1/sqrt(head_dim), so the split is a pure relayout.
    """
    w = tr.t(f"{torch_prefix}.in_proj_weight")
    b = tr.t(f"{torch_prefix}.in_proj_bias")
    ow = tr.t(f"{torch_prefix}.out_proj.weight")
    ob = tr.t(f"{torch_prefix}.out_proj.bias")
    if w is None:
        return
    d = w.shape[1]
    dh = d // nhead
    fp = flax_path + ("MultiHeadDotProductAttention_0",)
    for j, name in enumerate(("query", "key", "value")):
        tr.put(fp + (name, "kernel"),
               np.ascontiguousarray(w[j * d:(j + 1) * d].T.reshape(d, nhead, dh)))
        tr.put(fp + (name, "bias"), b[j * d:(j + 1) * d].reshape(nhead, dh))
    tr.put(fp + ("out", "kernel"),
           np.ascontiguousarray(ow.T.reshape(nhead, dh, d)))
    tr.put(fp + ("out", "bias"), ob)


def _spformer_tree(sd, nhead=8):
    """torch SPFormer state_dict -> {"params", "batch_stats"}, the
    flax-named tree of the JAX package's SPFormer. Returns (variables,
    report)."""
    sd = {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}
    n_levels = 1
    probe = "unet"
    while f"{probe}.u.blocks.block0.conv_branch.2.weight" in sd:
        n_levels += 1
        probe = f"{probe}.u"
    num_layer = 0
    while f"decoder.cross_attn_layers.{num_layer}.attn.in_proj_weight" in sd:
        num_layer += 1

    tr = _Tree(sd)
    w = tr.t("input_conv.0.weight")
    if w is not None:
        tr.put(("backbone", "input_conv", "kernel"), spconv_kernel(w))
    _convert_unet(tr, "unet", ("backbone", "unet"), n_levels)
    tr.bn("output_layer.0", "backbone", "output_bn")
    _convert_mlp(tr, "mu_linear", ("mu_linear",), 3)
    _convert_mlp(tr, "logvar_linear", ("logvar_linear",), 3)

    dec = ("decoder",)
    tr.dense("decoder.input_proj.0", *dec, "input_proj_dense")
    _ln(tr, "decoder.input_proj.1", *dec, "input_proj_norm")
    q = tr.t("decoder.query.weight")
    if q is not None:
        tr.put(dec + ("query",), q)
    tr.dense("decoder.x_mask.0", *dec, "x_mask_0")
    tr.dense("decoder.x_mask.2", *dec, "x_mask_1")
    for i in range(num_layer):
        _mha(tr, f"decoder.cross_attn_layers.{i}.attn", dec + (f"cross{i}",), nhead)
        # the reference CrossAttentionLayer's norm is created but its result
        # discarded (query_decoder.py:39-41) — consume, map to nothing
        tr.t(f"decoder.cross_attn_layers.{i}.norm.weight")
        tr.t(f"decoder.cross_attn_layers.{i}.norm.bias")
        _mha(tr, f"decoder.self_attn_layers.{i}.attn", dec + (f"self{i}",), nhead)
        _ln(tr, f"decoder.self_attn_layers.{i}.norm",
            *dec, f"self{i}", "LayerNorm_0")
        tr.dense(f"decoder.ffn_layers.{i}.net.0", *dec, f"ffn{i}", "Dense_0")
        tr.dense(f"decoder.ffn_layers.{i}.net.3", *dec, f"ffn{i}", "Dense_1")
        _ln(tr, f"decoder.ffn_layers.{i}.norm", *dec, f"ffn{i}", "LayerNorm_0")
    _ln(tr, "decoder.out_norm", *dec, "out_norm")
    tr.dense("decoder.out_cls.0", *dec, "out_cls_0")
    tr.dense("decoder.out_cls.2", *dec, "out_cls_1")
    tr.dense("decoder.out_score.0", *dec, "out_score_0")
    tr.dense("decoder.out_score.2", *dec, "out_score_1")

    unused = sorted(set(sd) - tr.used)
    report = dict(unused_torch_keys=unused, missing_torch_keys=sorted(tr.missing),
                  n_levels=n_levels, num_layer=num_layer)
    return {"params": tr.params, "batch_stats": tr.stats}, report


def convert_state_dict(sd, semantic_only=False):
    """A reference ISBNet ``state_dict`` (str -> array-like) -> (the port's
    ``state_dict``, report); the report lists unused torch keys, missing
    expected keys and the U-Net's depth."""
    variables, report = _isbnet_tree(sd, semantic_only)
    return flax_to_state_dict(variables), report


def convert_spformer_state_dict(sd, nhead=8):
    """A reference SPFormer ``state_dict`` -> (the port's ``state_dict``,
    report)."""
    variables, report = _spformer_tree(sd, nhead)
    return flax_to_state_dict(variables), report


def mask_feature_runner(cfg, scene_path, device=None):
    """``run_feats`` for ``calibrate_tap_perm``: the port's ISBNet (``cfg``,
    a loaded config) in eval mode, its trunk and mask tower on ONE prepared
    ``*_inst_nostuff.pth`` scene, each point taking its voxel's row (the
    artifact the reference exports per scene via save_deepfeatures_path).
    Returns (run_feats, scan_id)."""
    import os.path as osp

    from ..data.dataset import ScanNetDataset, build_dataloader
    from ..device import resolve_device
    from .train import build_model, make_prepare

    if cfg.model.type != "isbnet":
        raise ValueError("tap calibration uses the ISBNet probe")
    dev = resolve_device(device)
    model, _ = build_model(cfg, dev)
    model.eval()
    split_dir = osp.dirname(osp.abspath(scene_path))
    ds = ScanNetDataset(osp.dirname(split_dir), prefix=osp.basename(split_dir), training=False)
    ds.files = [osp.abspath(scene_path)]
    lb = next(iter(build_dataloader(ds, 1, training=False, drop_last=False)))
    n_points = len(lb.scenes[0]["xyz"])
    prepared = make_prepare(cfg, dev)(lb.points, 1)
    p2v = prepared.point2voxel[:n_points].long().clamp(min=0)

    @torch.no_grad()
    def run_feats(state_dict):
        model.load_state_dict({k: v.to(dev) for k, v in state_dict.items()}, strict=True)
        out, _ = model.trunk(prepared.batch)
        return model.run_mask_tower(out["voxel_feats"], prepared.batch.valid)[p2v].cpu().numpy()

    return run_feats, lb.scan_ids[0]


def read_reference(path):
    """A reference ``.pth`` -> its ``state_dict`` as numpy arrays (under
    ``net`` or ``state_dict`` where the file nests it)."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("net", raw.get("state_dict", raw)) if isinstance(raw, dict) else raw
    return {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}


def model_family(sd) -> str:
    """"spformer" when the checkpoint has ``decoder.query.weight``, else
    "isbnet"."""
    keys = {k[7:] if k.startswith("module.") else k for k in sd}
    return "spformer" if "decoder.query.weight" in keys else "isbnet"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("gapro_tpu_torch convert_torch_ckpt")
    ap.add_argument("ckpt")
    ap.add_argument("out")
    ap.add_argument("--semantic-only", action="store_true")
    ap.add_argument("--model", choices=["auto", "isbnet", "spformer"], default="auto")
    ap.add_argument("--nhead", type=int, default=8,
                    help="decoder heads (spformer; boxsup_spf_scannet.yaml: 8)")
    ap.add_argument("--calibrate-scene", default=None, metavar="SCENE_PTH",
                    help="one prepared *_inst_nostuff.pth scene: select the spconv tap order "
                         "by feature correlation before converting")
    ap.add_argument("--calibrate-feats", default=None, metavar="FEATS_PTH",
                    help="the reference's exported per-point deep features for that scene "
                         "(ISBNet save_deepfeatures_path)")
    ap.add_argument("--calibrate-config", default="configs/isbnet_scannetv2.yaml",
                    help="model config for the calibration probe")
    ap.add_argument("--calibrate-transposes", action="store_true",
                    help="also try the 6 axis orderings (48 candidates)")
    ap.add_argument("--device", default="cuda",
                    help="where the calibration probe runs: cuda (default) or cpu")
    args = ap.parse_args(argv)

    global TAP_PERM
    sd = read_reference(args.ckpt)
    model = model_family(sd) if args.model == "auto" else args.model
    if args.calibrate_scene:
        if not args.calibrate_feats:
            ap.error("--calibrate-scene needs --calibrate-feats")
        if model != "isbnet":
            ap.error("calibration probes the ISBNet mask tower; the selected TAP_PERM "
                     "applies to the shared backbone of both families")
        from ..train.config import load_config

        run_feats, scan = mask_feature_runner(load_config(args.calibrate_config),
                                              args.calibrate_scene, args.device)
        ref = torch.load(args.calibrate_feats, map_location="cpu", weights_only=False)
        ref = ref.numpy() if hasattr(ref, "numpy") else np.asarray(ref)
        results = calibrate_tap_perm(sd, run_feats, ref, model=model,
                                     include_transposes=args.calibrate_transposes,
                                     nhead=args.nhead, semantic_only=args.semantic_only)
        for corr, name, _ in results:
            print(f"[calibrate] corr={corr:+.4f}  {name}")
        corr, name, perm = results[0]
        print(f"[calibrate] scene {scan}: selected '{name}' (corr {corr:.4f})")
        if corr < 0.99:
            print("[calibrate] WARNING: best correlation < 0.99: the mismatch is NOT a "
                  "tap-order mirror; check the scene/feature pairing and the checkpoint "
                  "geometry")
        TAP_PERM = perm

    if model == "spformer":
        state, report = convert_spformer_state_dict(sd, nhead=args.nhead)
    else:
        state, report = convert_state_dict(sd, semantic_only=args.semantic_only)
    for k in report["unused_torch_keys"]:
        print(f"[unused] {k}")
    for k in report["missing_torch_keys"]:
        print(f"[MISSING] {k}")
    torch.save(dict(model=state, step=0, epoch=0), args.out)
    print(f"wrote {args.out} ({model}, unet levels: {report['n_levels']}, "
          f"unused: {len(report['unused_torch_keys'])}, "
          f"missing: {len(report['missing_torch_keys'])})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
