"""ISBNet (``gapro_tpu/models/isbnet.py``).

Sparse U-Net backbone -> point-wise heads (semantics, box-corner offsets,
box confidence) -> background filter on superpoint-pooled semantics -> two
local aggregators producing instance queries -> query heads and controller
-> dynamic-conv masks over superpoint-pooled features. Static capacities and
validity masks as in the JAX package; every ``ovf_*`` counter stays in the
output.

``forward`` is the JAX module's ``__call__``: the one-shot pass that the
training step differentiates (``model.train()``; BatchNorm takes batch
statistics) and that runs without a graph in eval mode.
``forward_inference`` is iterative sampling with visited-superpoint masking;
with ``x4_split`` it serves an S3DIS room split into 4 interleaved pieces.
``cfg.fixed_modules`` freezes modules as the JAX package does: a frozen
backbone or point-wise head stays in eval mode under ``model.train()`` and
its output is detached; ``train/state.py`` leaves every frozen module out of
the optimizer. ``cfg.semantic_only`` is the backbone pre-training stage:
the model holds only the backbone and the point-wise heads, and ``forward``
returns their outputs (``semantic_scores``, ``corners_offset``,
``box_conf``, ``box_preds``, ``voxel_feats``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core.batching import flat_to_dense_index, gather_dense
from ..core.segment import segment_max, segment_mean
from ..device import resolve_device
from ..sparse.plan import UNetPlan
from ..sparse.unet import SparseUNetBackbone
from ..utils import profiling
from .aggregator import LocalAggregator
from .common import MLP, ConvBlock1d, GenericMLP, seeded_init_
from .dyco import dyco_mlp


@dataclass(frozen=True)
class ISBNetConfig:
    """Defaults are the full width of ``configs/isbnet_scannetv2.yaml``."""

    channels: int = 32
    num_blocks: int = 7
    instance_classes: int = 18
    semantic_classes: int = 19
    with_coords: bool = True
    semantic_only: bool = False
    mask_dim_out: int = 32
    dec_dim: int = 128
    n_sample_pa1: int = 2048
    n_queries: int = 256
    radius_scale: float = 1.0
    neighbor: int = 32
    filter_bg_thresh: float = 0.1
    # reference names (input_conv / unet / output_layer are all ``backbone``)
    # or the model's own module names; see ``train/state.py``
    fixed_modules: tuple = ()
    spp_cap: int = 4096
    fg_cap_ratio: float = 1.0

    @property
    def unet_width(self) -> int:
        """The U-Net's first-level width."""
        return self.channels

    @property
    def unet_levels(self) -> int:
        """The U-Net's levels."""
        return self.num_blocks


# Modules whose output the JAX model gates when frozen, with the names that
# freeze each (``ISBNet._frozen`` in the JAX package).
_GATED = {
    "backbone": ("backbone", "input_conv", "unet", "output_layer"),
    "semantic_linear": ("semantic_linear",),
    "offset_vertices_linear": ("offset_vertices_linear", "offset_linear"),
    "box_conf_linear": ("box_conf_linear",),
}


@dataclass
class VoxelBatch:
    """Voxel-level model inputs (static shapes).

    feats [V, 3] rgb; coords_float [V, 3]; batch_idx/valid [V]; spp [V]
    compact global superpoint ids (-1 invalid); plan: UNetPlan;
    ovf_spp_ids: the superpoint ids past ``n_spp``, which the segment ops
    drop (an ``ovf_*`` counter, known on the host).
    """

    feats: torch.Tensor
    coords_float: torch.Tensor
    batch_idx: torch.Tensor
    valid: torch.Tensor
    spp: torch.Tensor
    plan: UNetPlan
    batch_size: int
    n_spp: int
    vox_npoints: Optional[torch.Tensor] = None
    ovf_spp_ids: int = 0


class ISBNet(nn.Module):
    def __init__(self, cfg: ISBNetConfig = ISBNetConfig(), seed: int = 0, device=None):
        """Build the model with weights drawn from ``seed`` on ``device``
        (``cuda`` unless the caller names another)."""
        super().__init__()
        self.cfg = cfg
        c = cfg.channels
        self.backbone = SparseUNetBackbone(c, cfg.num_blocks, 6 if cfg.with_coords else 3)
        self.semantic_linear = MLP(c, cfg.semantic_classes, 2)
        self.offset_vertices_linear = MLP(c, 6, 2)
        self.box_conf_linear = MLP(c, 1, 2)
        if not cfg.semantic_only:
            self._build_instance_modules(cfg)
        seeded_init_(self, seed)
        self.to(resolve_device(device))
        self.eval()

    def _build_instance_modules(self, cfg: ISBNetConfig) -> None:
        """Everything after the point-wise heads: the superpoint heads, the
        aggregators, the query heads and the dynamic mask head."""
        c = cfg.channels
        self.mu_linear = MLP(c, 1, 3)
        self.logvar_linear = MLP(c, 1, 3)
        rs = cfg.radius_scale
        self.point_aggregator1 = LocalAggregator(
            c, mlp_dim=c, n_sample=cfg.n_sample_pa1, radius=0.2 * rs,
            n_neighbor=cfg.neighbor, n_neighbor_post=cfg.neighbor * 2)
        self.point_aggregator2 = LocalAggregator(
            2 * c, mlp_dim=2 * c, n_sample=cfg.n_queries, radius=0.4 * rs,
            n_neighbor=cfg.neighbor, n_neighbor_post=cfg.neighbor)
        dd = cfg.dec_dim
        self.inst_shared_mlp = GenericMLP(4 * c, (4 * c,), dd, hidden_use_bias=False,
                                          output_use_activation=True, output_use_norm=True)
        self.inst_sem_head = GenericMLP(dd, (dd, dd), cfg.instance_classes + 1)
        self.inst_conf_head = GenericMLP(dd, (dd, dd), 1)
        self.inst_box_head = GenericMLP(dd, (dd, dd), 6)
        m = cfg.mask_dim_out
        self.mask_tower0 = ConvBlock1d(c, c)
        self.mask_tower1 = ConvBlock1d(c, c)
        self.mask_tower2 = ConvBlock1d(c, c)
        self.mask_out = nn.Linear(c, m)
        self.weight_nums = [(m + 6) * m, m * (m // 2), (m // 2) * 1]
        self.bias_nums = [m, m // 2, 1]
        self.inst_mask_head0 = ConvBlock1d(dd, dd)
        self.inst_mask_head1 = ConvBlock1d(dd, dd)
        self.controller = nn.Linear(dd, sum(self.weight_nums) + sum(self.bias_nums))

    # ------------------------------------------------------------------ #

    def _frozen(self, name: str) -> bool:
        return bool(set(self.cfg.fixed_modules) & set(_GATED[name]))

    def _gated(self, name: str, *args):
        """Run module ``name``; a frozen one's output is detached (it runs in
        eval mode, see ``train``)."""
        out = getattr(self, name)(*args)
        return out.detach() if self._frozen(name) else out

    def train(self, mode: bool = True):
        """As ``nn.Module.train``, but frozen gated modules stay in eval mode,
        so their BatchNorms neither use batch statistics nor update."""
        super().train(mode)
        for name in _GATED:
            if self._frozen(name):
                getattr(self, name).eval()
        return self

    def pointwise_head(self, feats, valid):
        sem = self._gated("semantic_linear", feats, valid)
        corners = self._gated("offset_vertices_linear", feats, valid)
        conf = self._gated("box_conf_linear", feats, valid)[..., 0]
        return sem, corners, conf

    def run_mask_tower(self, x, valid):
        for blk in (self.mask_tower0, self.mask_tower1, self.mask_tower2):
            x = blk(x, valid)
        return torch.where(valid[..., None], self.mask_out(x), 0.0)

    def dynamic_mask_head(self, controllers, queries_locs, queries_boxes, sp_mask_feats,
                          sp_coords, sp_boxes, sp_valid):
        """Batched dynamic conv: controllers [B, Q, P] -> mask logits [B, Q, S]."""
        m = self.cfg.mask_dim_out
        splits = torch.split(controllers, self.weight_nums + self.bias_nums, dim=-1)
        bq = controllers.shape[:2]
        w0 = splits[0].reshape(*bq, m + 6, m)
        w1 = splits[1].reshape(*bq, m, m // 2)
        w2 = splits[2].reshape(*bq, m // 2, 1)
        b0, b1 = splits[3], splits[4]  # the last layer has no bias
        qdims = queries_boxes[..., 3:] - queries_boxes[..., :3]
        sdims = sp_boxes[..., 3:] - sp_boxes[..., :3]
        return dyco_mlp(w0, w1, w2, b0, b1, queries_locs, qdims,
                        sp_mask_feats, sp_coords, sdims, sp_valid)

    def query_heads(self, query_feats, q_valid):
        qf = self.inst_shared_mlp(query_feats, q_valid)
        cls_logits = self.inst_sem_head(qf, q_valid)
        conf_logits = self.inst_conf_head(qf, q_valid)[..., 0]
        box_offsets = self.inst_box_head(qf, q_valid)
        x = self.inst_mask_head1(self.inst_mask_head0(qf, q_valid), q_valid)
        return cls_logits, conf_logits, box_offsets, self.controller(x)

    def run_queries(self, agg2, d_sp_mask_feats, d_sp_coords, d_sp_boxes, sp_dense_valid):
        with profiling.span("model.heads"):
            cls_logits, conf_logits, box_offsets, controllers = self.query_heads(agg2.feats,
                                                                                 agg2.valid)
            query_box_preds = box_offsets + agg2.locs.repeat(1, 1, 2)
        with profiling.span("model.mask_head"):
            mask_logits = self.dynamic_mask_head(controllers, agg2.locs, query_box_preds,
                                                 d_sp_mask_feats, d_sp_coords, d_sp_boxes,
                                                 sp_dense_valid)
        return cls_logits, conf_logits, query_box_preds, mask_logits

    # ------------------------------------------------------------------ #

    def backbone_input(self, batch: VoxelBatch):
        """The backbone's input features: colours, and the coordinates where
        the config says so."""
        if self.cfg.with_coords:
            return torch.cat([batch.feats, batch.coords_float], 1)
        return batch.feats

    def trunk(self, batch: VoxelBatch, feats=None):
        """Backbone -> pointwise heads -> bg filter -> superpoint pooling ->
        dense views -> stage-1 aggregator. ``feats`` (the backbone's output)
        skips the backbone: the x4_split path runs it on the pieces."""
        cfg = self.cfg
        B = batch.batch_size
        V = batch.feats.shape[0]
        S = batch.n_spp

        if feats is None:
            with profiling.span("model.backbone"):
                feats = self._gated("backbone", self.backbone_input(batch), batch.plan)  # [V, C]
        with profiling.span("model.heads"):
            sem_scores, corners_offset, box_conf = self.pointwise_head(feats, batch.valid)
            box_preds = corners_offset + batch.coords_float.repeat(1, 2)
            out: Dict[str, object] = dict(
                semantic_scores=sem_scores, corners_offset=corners_offset, box_conf=box_conf,
                box_preds=box_preds, voxel_feats=feats)
            if cfg.semantic_only:
                return out, None

            # background filter on superpoint-pooled semantics
            sem_sm = torch.softmax(sem_scores, 1)
            spp_sem = segment_mean(sem_sm, batch.spp, S)
            spp_fg = (spp_sem[:, :-1] >= cfg.filter_bg_thresh).any(-1)
            # compact ids past the spp capacity read the last row, as the JAX
            # package's clamped gathers do
            fg_mask = spp_fg[batch.spp.clamp(0, S - 1).long()] & batch.valid

            # superpoint pooling (dyco domain)
            sp_coords = segment_mean(batch.coords_float, batch.spp, S)
            sp_feats = segment_mean(feats, batch.spp, S)
            sp_boxes = segment_mean(box_preds, batch.spp, S)
            sp_batch = segment_max(torch.where(batch.valid, batch.batch_idx, -1), batch.spp, S)
            sp_valid = sp_batch >= 0

            sp_mask_feats = self.run_mask_tower(sp_feats, sp_valid)
            mu_pred = self.mu_linear(sp_feats, sp_valid)[..., 0]
            logvar_pred = self.logvar_linear(sp_feats, sp_valid)[..., 0]

            _, sp_dense_idx, sp_dense_valid = flat_to_dense_index(
                sp_batch.clamp(min=0), sp_valid, B, cfg.spp_cap)
            d_sp_coords = gather_dense(sp_coords, sp_dense_idx)
            d_sp_boxes = gather_dense(sp_boxes, sp_dense_idx)
            d_sp_mask_feats = gather_dense(sp_mask_feats, sp_dense_idx)

            # aggregator over foreground voxels (dense views)
            nf = int(V * cfg.fg_cap_ratio)
            _, fg_dense_idx, fg_dense_valid = flat_to_dense_index(batch.batch_idx, fg_mask, B, nf)
            d_locs = gather_dense(batch.coords_float, fg_dense_idx)
            d_feats = gather_dense(feats, fg_dense_idx)
            d_boxes = gather_dense(box_preds, fg_dense_idx)
        with profiling.span("model.aggregator"):
            agg1 = self.point_aggregator1(d_locs, d_feats, d_boxes, fg_dense_valid)
        with profiling.span("model.heads"):
            mid = dict(agg1=agg1, fg_dense_idx=fg_dense_idx, d_sp_coords=d_sp_coords,
                       d_sp_boxes=d_sp_boxes, d_sp_mask_feats=d_sp_mask_feats)

            # overflow counters ("no silent caps")
            count = lambda m: int(profiling.to_host(m.sum(), "isbnet.ovf"))
            out.update(
                ovf_fg_voxels=count(fg_mask) - count(fg_dense_valid),
                ovf_spp_slots=count(sp_valid) - count(sp_dense_valid),
                ovf_plan_voxels=sum(lvl.dropped_next for lvl in batch.plan.levels),
                ovf_window_escapees=batch.plan.ovf_window_escapees,
                mu_pred=mu_pred, logvar_pred=logvar_pred,
                sp_dense_idx=sp_dense_idx, sp_dense_valid=sp_dense_valid, sp_valid=sp_valid,
                sp_coords=sp_coords, sp_coords_dense=d_sp_coords, sp_batch=sp_batch,
                fg_mask=fg_mask, agg1_inds=agg1.inds, agg1_valid=agg1.valid,
            )
        return out, mid

    def forward(self, batch: VoxelBatch) -> Dict[str, object]:
        """One-shot forward: the stage-2 aggregator over the stage-1 samples
        (``sampled_before``), as in training. It records a graph only in
        training mode; in eval mode it runs under ``no_grad``. Spans
        ``model.backbone``, ``model.aggregator``, ``model.mask_head``, and
        ``model.heads`` for the rest."""
        with torch.set_grad_enabled(self.training and torch.is_grad_enabled()):
            out, mid = self.trunk(batch)
            if self.cfg.semantic_only:
                return out
            agg1 = mid["agg1"]
            with profiling.span("model.aggregator"):
                agg2 = self.point_aggregator2(agg1.locs, agg1.feats, agg1.boxes, agg1.valid,
                                              sampled_before=True)
            cls_logits, conf_logits, query_box_preds, mask_logits = self.run_queries(
                agg2, mid["d_sp_mask_feats"], mid["d_sp_coords"], mid["d_sp_boxes"],
                out["sp_dense_valid"])
        out.update(cls_logits=cls_logits, conf_logits=conf_logits,
                   query_box_preds=query_box_preds, query_valid=agg2.valid,
                   mask_logits=mask_logits)
        return out

    @torch.no_grad()
    def forward_inference(self, batch: VoxelBatch, n_sample_arr: Tuple[int, ...] = (192, 128, 64),
                          x4_split: bool = False) -> Dict[str, object]:
        """Iterative sampling: rounds of FPS with shrinking sample counts,
        masking out stage-1 candidates whose superpoint a predicted mask of
        an earlier round already covers. Proposals are concatenated over
        rounds (P = sum(n_sample_arr)).

        ``x4_split`` (S3DIS rooms): the batch's items are the interleaved
        pieces of one room; the backbone runs them as batch items (the plan
        never crosses items), and everything after it sees one merged scene
        (``batch_idx`` 0, batch size 1). Spans as ``forward``'s."""
        if self.cfg.semantic_only:
            raise ValueError("a semantic_only model has no instance path: call forward")
        if x4_split:
            with profiling.span("model.backbone"):
                feats = self.backbone(self.backbone_input(batch), batch.plan)
            batch = replace(batch, batch_idx=torch.zeros_like(batch.batch_idx), batch_size=1)
            out, mid = self.trunk(batch, feats=feats)
        else:
            out, mid = self.trunk(batch)
        agg1 = mid["agg1"]
        B = agg1.valid.shape[0]
        S = self.cfg.spp_cap
        dev = agg1.valid.device

        with profiling.span("model.heads"):
            # dense superpoint slot of each stage-1 candidate
            flat_vox = torch.gather(mid["fg_dense_idx"], 1, agg1.inds.long())
            q1_spp = batch.spp[flat_vox.clamp(min=0).long()]
            slot_of = torch.full((batch.n_spp,), -1, dtype=torch.int32, device=dev)
            dv = out["sp_dense_valid"]
            slots = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
            slot_of[out["sp_dense_idx"][dv].long()] = slots[dv]
            q1_slot = slot_of[q1_spp.clamp(0, batch.n_spp - 1).long()]
            q1_slot_safe = q1_slot.clamp(min=0).long()

        valid1 = agg1.valid
        cls_l, conf_l, mask_l, box_l, valid_l = [], [], [], [], []
        for r in n_sample_arr:
            with profiling.span("model.aggregator"):
                agg2 = self.point_aggregator2(agg1.locs, agg1.feats, agg1.boxes, valid1,
                                              sampled_before=False, n_sample=r)
            cls_r, conf_r, box_r, mask_r = self.run_queries(
                agg2, mid["d_sp_mask_feats"], mid["d_sp_coords"], mid["d_sp_boxes"],
                out["sp_dense_valid"])
            cls_l.append(cls_r)
            conf_l.append(conf_r)
            mask_l.append(mask_r)
            box_l.append(box_r)
            valid_l.append(agg2.valid)
            with profiling.span("model.heads"):
                covered = ((mask_r > 0) & agg2.valid[..., None]).any(1)  # [B, S]
                hit = torch.gather(covered, 1, q1_slot_safe) & (q1_slot >= 0)
                valid1 = valid1 & ~hit

        with profiling.span("model.heads"):
            out.update(cls_logits=torch.cat(cls_l, 1), conf_logits=torch.cat(conf_l, 1),
                       mask_logits=torch.cat(mask_l, 1), query_box_preds=torch.cat(box_l, 1),
                       query_valid=torch.cat(valid_l, 1))
        return out
