"""SPFormer: the superpoint transformer (``gapro_tpu/models/spformer.py``).

Sparse U-Net backbone -> superpoint pooling -> a DETR-style decoder: learned
queries, then per layer masked cross-attention over the superpoints,
self-attention and an FFN, with prediction heads before the first layer and
after each (``labels``, ``scores``, ``masks``, stacked over the L + 1 heads),
and the ``mu`` / ``logvar`` heads of the GP-uncertainty loss.

As in the JAX package:

* superpoints lie in dense padded [B, S, C] views with validity masks, and
  each decoder layer is one batched attention;
* superpoint pooling is at point resolution: each voxel's feature enters its
  superpoint's mean weighted by its member points (``vox_npoints``);
  ``pool="max"`` takes the voxel-level max;
* the cross-attention mask is ``sigmoid(mask) >= 0.5``, a row with nothing
  to attend to attends everywhere, and masked logits are set to
  ``finfo(float32).min`` (flax), not ``-inf``: a row with no valid key, as
  in a batch item with no valid superpoint, then softmaxes to a uniform row
  instead of NaN;
* the cross-attention is residual only, without its norm (the reference
  discards the norm's result);
* attention scales the query by ``1/sqrt(d/h)`` before the product; the
  LayerNorms take flax's epsilon 1e-6; GELU is the exact (erf) form.

The attention is plain PyTorch: the JAX package computes it outside any
Pallas kernel. The backbone runs the sparse-conv kernels. Module names
follow the flax tree; ``convert.py`` maps the auto-named
``MultiHeadDotProductAttention_0`` / ``LayerNorm_0`` / ``Dense_i`` to
``attn`` / ``norm`` / ``dense{i}``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn

from ..core.batching import flat_to_dense_index, gather_dense
from ..core.segment import segment_max, segment_weighted_mean
from ..device import resolve_device
from ..sparse.unet import SparseUNetBackbone
from ..utils import profiling
from .common import MLP, seeded_init_
from .isbnet import VoxelBatch

_LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (PyTorch's default is 1e-5)
_BACKBONE_NAMES = ("backbone", "input_conv", "unet", "output_layer")


@dataclass(frozen=True)
class SPFormerConfig:
    """Defaults are the full width of ``configs/spformer_scannetv2.yaml``."""

    media: int = 32
    blocks: int = 5
    num_class: int = 18
    num_layer: int = 6
    num_query: int = 400
    d_model: int = 256
    nhead: int = 8
    hidden_dim: int = 1024
    activation: str = "gelu"
    iter_pred: bool = True
    attn_mask: bool = True
    with_coords: bool = True
    # "mean": the point-weighted superpoint mean; "max": the voxel-level max
    pool: str = "mean"
    spp_cap: int = 4096
    # frozen modules: the backbone's reference names run in eval mode with
    # their output detached, and stay out of the optimizer
    fixed_modules: tuple = ()

    @property
    def unet_width(self) -> int:
        """The U-Net's first-level width."""
        return self.media

    @property
    def unet_levels(self) -> int:
        """The U-Net's levels."""
        return self.blocks


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (no dropout): per-head
    projections ``query`` / ``key`` / ``value`` and ``out``, as
    ``nn.Linear`` layers over the flattened heads."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, q_in, kv_in, mask=None):
        """q_in [B, Lq, d], kv_in [B, Lk, d], mask [B, 1, Lq, Lk] bool (True
        attends) -> [B, Lq, d]."""
        b, lq, d = q_in.shape
        h = self.nhead
        q = self.query(q_in).reshape(b, lq, h, d // h)
        k = self.key(kv_in).reshape(b, -1, h, d // h)
        v = self.value(kv_in).reshape(b, -1, h, d // h)
        q = q / math.sqrt(d // h)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            w = torch.where(mask, w, torch.finfo(w.dtype).min)
        w = torch.softmax(w, -1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, lq, d))


class CrossAttention(nn.Module):
    """Masked cross-attention, residual only (the reference discards its
    norm)."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.attn = MultiHeadAttention(d_model, nhead)

    def forward(self, query, source, mask):
        return self.attn(query, source, mask) + query


class SelfAttention(nn.Module):
    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.attn = MultiHeadAttention(d_model, nhead)
        self.norm = nn.LayerNorm(d_model, eps=_LN_EPS)

    def forward(self, x):
        return self.norm(self.attn(x, x) + x)


class FFN(nn.Module):
    def __init__(self, d_model: int, hidden_dim: int, activation: str = "gelu"):
        super().__init__()
        self.dense0 = nn.Linear(d_model, hidden_dim)
        self.dense1 = nn.Linear(hidden_dim, d_model)
        self.norm = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.act = nn.GELU() if activation == "gelu" else nn.ReLU()

    def forward(self, x):
        return self.norm(self.dense1(self.act(self.dense0(x))) + x)


class QueryDecoder(nn.Module):
    """The iterative-prediction decoder: sp_feats [B, S, media] and
    sp_valid [B, S] -> labels [L+1, B, Q, C+1], scores [L+1, B, Q] and
    masks [L+1, B, Q, S]."""

    def __init__(self, cfg: SPFormerConfig):
        super().__init__()
        c = cfg
        d = c.d_model
        self.cfg = cfg
        self.input_proj_dense = nn.Linear(c.media, d)
        self.input_proj_norm = nn.LayerNorm(d, eps=_LN_EPS)
        self.x_mask_0 = nn.Linear(c.media, d)
        self.x_mask_1 = nn.Linear(d, d)
        self.query = nn.Parameter(torch.zeros(c.num_query, d))
        self.out_norm = nn.LayerNorm(d, eps=_LN_EPS)
        self.out_cls_0 = nn.Linear(d, d)
        self.out_cls_1 = nn.Linear(d, c.num_class + 1)
        self.out_score_0 = nn.Linear(d, d)
        self.out_score_1 = nn.Linear(d, 1)
        for i in range(c.num_layer):
            setattr(self, f"cross{i}", CrossAttention(d, c.nhead))
            setattr(self, f"self{i}", SelfAttention(d, c.nhead))
            setattr(self, f"ffn{i}", FFN(d, c.hidden_dim, c.activation))

    def head(self, q, mask_feats, sp_valid):
        """The prediction heads on queries ``q``, and the next layer's
        cross-attention mask [B, 1, Q, S]."""
        qn = self.out_norm(q)
        labels = self.out_cls_1(torch.relu(self.out_cls_0(qn)))
        scores = self.out_score_1(torch.relu(self.out_score_0(qn)))[..., 0]
        masks = torch.einsum("bqd,bsd->bqs", qn, mask_feats)
        key_valid = sp_valid[:, None, None, :]
        if self.cfg.attn_mask:
            with torch.no_grad():
                am = torch.sigmoid(masks) >= 0.5  # True attends
                # rows with nothing to attend to fall back to everything
                empty = ~(am & sp_valid[:, None, :]).any(-1, keepdim=True)
                bias = (am | empty)[:, None] & key_valid
        else:
            bias = key_valid.expand(-1, 1, masks.shape[1], -1)
        return labels, scores, masks, bias

    def forward(self, sp_feats, sp_valid) -> Dict[str, torch.Tensor]:
        c = self.cfg
        inst_feats = torch.relu(self.input_proj_norm(self.input_proj_dense(sp_feats)))
        mask_feats = self.x_mask_1(torch.relu(self.x_mask_0(sp_feats)))
        query = self.query[None].expand(sp_feats.shape[0], -1, -1)
        lab, sc, mk, bias = self.head(query, mask_feats, sp_valid)
        labels_l, scores_l, masks_l = [lab], [sc], [mk]
        for i in range(c.num_layer):
            query = getattr(self, f"cross{i}")(query, inst_feats, bias)
            query = getattr(self, f"self{i}")(query)
            query = getattr(self, f"ffn{i}")(query)
            lab, sc, mk, bias = self.head(query, mask_feats, sp_valid)
            labels_l.append(lab)
            scores_l.append(sc)
            masks_l.append(mk)
        return dict(labels=torch.stack(labels_l), scores=torch.stack(scores_l),
                    masks=torch.stack(masks_l))


class SPFormer(nn.Module):
    def __init__(self, cfg: SPFormerConfig = SPFormerConfig(), seed: int = 0, device=None):
        """Build the model with weights drawn from ``seed`` on ``device``
        (``cuda`` unless the caller names another)."""
        super().__init__()
        self.cfg = cfg
        self.backbone = SparseUNetBackbone(cfg.media, cfg.blocks, 6 if cfg.with_coords else 3)
        self.mu_linear = MLP(cfg.media, 1, 3)
        self.logvar_linear = MLP(cfg.media, 1, 3)
        self.decoder = QueryDecoder(cfg)
        seeded_init_(self, seed)
        self.to(resolve_device(device))
        self.eval()

    def _backbone_frozen(self) -> bool:
        return bool(set(self.cfg.fixed_modules) & set(_BACKBONE_NAMES))

    def train(self, mode: bool = True):
        """As ``nn.Module.train``, but a frozen backbone stays in eval mode."""
        super().train(mode)
        if self._backbone_frozen():
            self.backbone.eval()
        return self

    def _pool(self, x, batch: VoxelBatch, weights):
        """Superpoint pooling of voxel rows ``x`` [V, C] -> [S, C]."""
        if self.cfg.pool == "max":
            neg = -1e10
            out = segment_max(torch.where(batch.valid[:, None], x, neg), batch.spp, batch.n_spp)
            return torch.where(out <= neg, 0.0, out)
        return segment_weighted_mean(x, batch.spp, weights, batch.n_spp)

    def forward(self, batch: VoxelBatch) -> Dict[str, object]:
        """Voxel batch -> every decoder head's outputs, the superpoint heads,
        the dense superpoint layout and the ``ovf_*`` counters. It records a
        graph only in training mode. Spans ``model.backbone``,
        ``model.decoder``, and ``model.heads`` for the rest."""
        with torch.set_grad_enabled(self.training and torch.is_grad_enabled()):
            return self._forward(batch)

    def _forward(self, batch: VoxelBatch) -> Dict[str, object]:
        c = self.cfg
        B, S = batch.batch_size, batch.n_spp
        with profiling.span("model.backbone"):
            in_feats = batch.feats
            if c.with_coords:
                in_feats = torch.cat([in_feats, batch.coords_float], 1)
            feats = self.backbone(in_feats, batch.plan)  # [V, media]
            if self._backbone_frozen():
                feats = feats.detach()

        with profiling.span("model.heads"):
            w = batch.vox_npoints
            if w is None:
                w = torch.ones(feats.shape[:1], dtype=torch.float32, device=feats.device)
            sp_feats = self._pool(feats, batch, w)
            sp_batch = segment_max(torch.where(batch.valid, batch.batch_idx, -1), batch.spp, S)
            sp_valid = sp_batch >= 0

            mu_pred = self.mu_linear(sp_feats, sp_valid)[..., 0]
            logvar_pred = self.logvar_linear(sp_feats, sp_valid)[..., 0]

            _, sp_dense_idx, sp_dense_valid = flat_to_dense_index(
                sp_batch.clamp(min=0), sp_valid, B, c.spp_cap)
            d_sp_feats = gather_dense(sp_feats, sp_dense_idx)
            d_sp_coords = gather_dense(self._pool(batch.coords_float, batch, w), sp_dense_idx)
        with profiling.span("model.decoder"):
            dec = self.decoder(d_sp_feats, sp_dense_valid)
        with profiling.span("model.heads"):
            count = lambda m: int(profiling.to_host(m.sum(), "spformer.ovf"))
            ovf_spp_slots = count(sp_valid) - count(sp_dense_valid)
        return dict(
            ovf_spp_slots=ovf_spp_slots,
            ovf_plan_voxels=sum(lvl.dropped_next for lvl in batch.plan.levels),
            ovf_window_escapees=batch.plan.ovf_window_escapees,
            labels=dec["labels"], scores=dec["scores"], masks=dec["masks"],
            mu_pred=mu_pred, logvar_pred=logvar_pred, sp_dense_idx=sp_dense_idx,
            sp_dense_valid=sp_dense_valid, sp_valid=sp_valid, sp_batch=sp_batch,
            sp_coords_dense=d_sp_coords, voxel_feats=feats)
