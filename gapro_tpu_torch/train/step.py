"""The single-device training steps (``gapro_tpu/train/step.py``).

``make_train_step(model, crit_cfg)`` returns ``step(state, prepared, lr) ->
(state, losses)`` for ISBNet: the training-mode forward (which moves every
BatchNorm's running statistics once), the targets, Hungarian matching and the
criterion, the backward (the sparse convs' through
``sparse/conv.py:SubmConvFn``) and one AdamW update. With
``crit_cfg.semantic_only`` (the backbone pre-training stage) the targets are
the corner-offset labels alone and nothing is matched.
``make_spformer_train_step`` is the same for SPFormer, whose targets pool
the labels at point resolution (``vox_weights``) and by the model's
``pool``. ``make_dp_train_step`` is the data-parallel step, one scene a
rank: each rank's gradients, BatchNorm statistics and losses are reduced
over the group before the same AdamW update on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..losses.criterion import (CriterionConfig, PointwiseTargets, build_targets,
                                corner_labels_only, isbnet_loss, match)
from ..utils import profiling


def _no_mark(name: str) -> None:
    pass


def _targets(prepared, outputs, inst_cap: int, **kw):
    """``build_targets`` for the model outputs of ``prepared``'s batch."""
    b = prepared.batch
    if "sp_dense_idx" not in outputs:
        # the JAX package fails here with a KeyError: --only_backbone makes
        # the model semantic_only but sets the criterion's flag only where
        # the config has the key (tools/train.py:128-133)
        raise ValueError(
            "the model is semantic_only (no superpoint outputs) but the criterion is not: "
            "set criterion.semantic_only in the config (--only_backbone sets it only where "
            "the config has the key)")
    return build_targets(
        prepared.voxel_instance, prepared.voxel_semantic, b.coords_float, b.spp, b.batch_idx,
        b.valid, outputs["sp_dense_idx"], b.n_spp, inst_cap, voxel_prob=prepared.voxel_prob,
        voxel_mu=prepared.voxel_mu, voxel_var=prepared.voxel_var, voxel_rgb=prepared.voxel_rgb,
        **kw)


def _loss_fn(model, prepared, crit_cfg: CriterionConfig, assign=None, mark=_no_mark):
    """Forward (in the model's mode), targets, matching and criterion.
    Returns ``(loss, (losses, aux))``; ``aux`` holds the ``outputs``, the
    ``targets`` and the assignment used (``assign``, or the matcher's; None
    with ``semantic_only``). ``mark`` is called after the forward and after
    targets and matching. Spans ``step.targets``, ``step.match`` and
    ``step.loss``."""
    b = prepared.batch
    outputs = model(b)
    mark("forward")
    if crit_cfg.semantic_only:
        with profiling.span("step.targets"):
            targets = PointwiseTargets(corner_labels_only(
                prepared.voxel_instance, b.coords_float, b.valid, crit_cfg.inst_cap))
        assign = None
    else:
        with profiling.span("step.targets"):
            targets = _targets(prepared, outputs, crit_cfg.inst_cap)
        if assign is None:
            with profiling.span("step.match"):
                assign = match(outputs, targets)
    mark("targets")
    with profiling.span("step.loss"):
        losses = isbnet_loss(outputs, prepared, targets, crit_cfg, assign=assign)
    return losses["loss"], (losses, dict(outputs=outputs, targets=targets, assign=assign))


def _spformer_loss_fn(model, prepared, crit_cfg, assign=None, mark=_no_mark):
    """SPFormer's ``_loss_fn``: ``assign`` is an optional [L+1, B, I]
    assignment, one per decoder layer (``spformer_match_layers``)."""
    from ..losses.spformer_criterion import spformer_match_layers, spformer_loss

    outputs = model(prepared.batch)
    mark("forward")
    # point-resolution label pooling, as the model pools its features
    with profiling.span("step.targets"):
        targets = _targets(prepared, outputs, crit_cfg.inst_cap,
                           vox_weights=prepared.batch.vox_npoints, pool=model.cfg.pool)
    if assign is None:
        with profiling.span("step.match"):
            assign = spformer_match_layers(outputs, targets, crit_cfg)
    mark("targets")
    with profiling.span("step.loss"):
        losses = spformer_loss(outputs, targets, crit_cfg, assign=assign)
    return losses["loss"], (losses, dict(outputs=outputs, targets=targets, assign=assign))


def _make_step(loss_fn, model, crit_cfg, on_stage) -> Callable:
    mark = on_stage or _no_mark

    def step(state, prepared, lr):
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, (losses, _) = loss_fn(model, prepared, crit_cfg, mark=mark)
        with profiling.span("step.backward"):
            loss.backward()
        mark("backward")
        with profiling.span("step.optimizer"):
            state = state.apply_gradients(lr=lr)
        mark("optimizer")
        return state, {k: v.detach() for k, v in losses.items()}

    return step


def make_train_step(model, crit_cfg: CriterionConfig,
                    on_stage: Optional[Callable[[str], None]] = None) -> Callable:
    """Single-device ISBNet step: ``(state, prepared, lr) -> (state,
    losses)``, the losses detached. ``on_stage(name)``, if given, is called
    as each stage ends: ``forward``, ``targets`` (targets and matching),
    ``backward`` and ``optimizer``. Spans: the model's, ``_loss_fn``'s,
    ``step.backward`` and ``step.optimizer``."""
    return _make_step(_loss_fn, model, crit_cfg, on_stage)


def make_spformer_train_step(model, crit_cfg,
                             on_stage: Optional[Callable[[str], None]] = None) -> Callable:
    """Single-device SPFormer step, as ``make_train_step``; frozen modules
    (``model.cfg.fixed_modules``) run in eval mode with their output
    detached, and ``train/state.py`` leaves them out of the optimizer."""
    return _make_step(_spformer_loss_fn, model, crit_cfg, on_stage)


def make_dp_train_step(model, crit_cfg, group, loss_fn=_loss_fn,
                       prepare_fn: Optional[Callable] = None,
                       on_stage: Optional[Callable[[str], None]] = None) -> Callable:
    """The data-parallel step of ``gapro_tpu/train/step.py``, one scene a
    rank of ``group`` (``parallel/mesh.py:DataParallelGroup``):
    ``step(state, shard, lr, weight=1.0) -> (state, losses)``.

    Each rank runs ``loss_fn`` (``_loss_fn``, or ``_spformer_loss_fn``) and
    its backward on its own scene, matching included. Then the gradients of
    the optimizer's parameters, every floating-point buffer (the BatchNorm
    running statistics as the forward left them) and the losses are each
    reduced as ``sum(w * x) / max(sum(w), 1e-6)`` over the ranks, in one
    sum of one flat buffer; ``weight`` is 1 for a real scene and 0 for a
    filler that only keeps the group's shape. Every rank then makes the
    same AdamW update from the reduced gradients (frozen modules are not in
    the optimizer, as in ``make_train_step``). ``prepare_fn``, if given,
    turns ``shard`` (the packed [N, 17] buffer of ``models/prepare.py:
    pack_point_batch_np``) into the rank's prepared batch, so each rank
    voxelizes and plans its own scene. ``on_stage`` is called as in
    ``make_train_step``, with ``prepare`` first where ``prepare_fn`` is
    given and ``reduce`` after ``backward``; spans as ``make_train_step``'s,
    with ``step.reduce``."""
    mark = on_stage or _no_mark

    def step(state, shard, lr, weight=1.0):
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        prepared = shard
        if prepare_fn is not None:
            prepared = prepare_fn(shard)
            mark("prepare")
        loss, (losses, _) = loss_fn(model, prepared, crit_cfg, mark=mark)
        with profiling.span("step.backward"):
            loss.backward()
        mark("backward")
        with profiling.span("step.reduce"):
            params = [p for g in state.optimizer.param_groups for p in g["params"]]
            stats = [b for b in model.buffers() if b.is_floating_point()]
            keys = sorted(losses)
            w = torch.tensor([float(weight)], device=group.device)
            flat = torch.cat(
                [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                 for p in params]
                + [b.reshape(-1) for b in stats]
                + [torch.stack([losses[k].detach().float().reshape(()) for k in keys])]) * w
            flat = group.all_reduce_sum(torch.cat([flat, w]))
            flat = flat[:-1] / flat[-1:].clamp(min=1e-6)
            at = 0
            with torch.no_grad():
                for p in params:
                    p.grad = flat[at:at + p.numel()].view_as(p)
                    at += p.numel()
                for b in stats:
                    b.copy_(flat[at:at + b.numel()].view_as(b))
                    at += b.numel()
            reduced = {k: flat[at + i] for i, k in enumerate(keys)}
        mark("reduce")
        with profiling.span("step.optimizer"):
            state = state.apply_gradients(lr=lr)
        mark("optimizer")
        return state, reduced

    return step
