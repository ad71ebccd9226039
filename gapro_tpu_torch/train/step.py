"""The single-device ISBNet training step (``gapro_tpu/train/step.py``).

``make_train_step(model, crit_cfg)`` returns ``step(state, prepared, lr) ->
(state, losses)``: the training-mode forward (which moves every BatchNorm's
running statistics once), the targets, Hungarian matching and the criterion,
the backward (the sparse convs' through ``sparse/conv.py:SubmConvFn``) and
one AdamW update. The SPFormer step and the data-parallel step are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..losses.criterion import CriterionConfig, build_targets, isbnet_loss, match


def _no_mark(name: str) -> None:
    pass


def _loss_fn(model, prepared, crit_cfg: CriterionConfig, assign=None, mark=_no_mark):
    """Forward (in the model's mode), targets, matching and criterion.
    Returns ``(loss, (losses, aux))``; ``aux`` holds the ``outputs``, the
    ``targets`` and the assignment used (``assign``, or the matcher's).
    ``mark`` is called after the forward and after targets and matching."""
    b = prepared.batch
    outputs = model(b)
    mark("forward")
    targets = build_targets(
        prepared.voxel_instance, prepared.voxel_semantic, b.coords_float, b.spp, b.batch_idx,
        b.valid, outputs["sp_dense_idx"], b.n_spp, crit_cfg.inst_cap,
        voxel_prob=prepared.voxel_prob, voxel_mu=prepared.voxel_mu,
        voxel_var=prepared.voxel_var, voxel_rgb=prepared.voxel_rgb)
    if assign is None:
        assign = match(outputs, targets)
    mark("targets")
    losses = isbnet_loss(outputs, prepared, targets, crit_cfg, assign=assign)
    return losses["loss"], (losses, dict(outputs=outputs, targets=targets, assign=assign))


def make_train_step(model, crit_cfg: CriterionConfig,
                    on_stage: Optional[Callable[[str], None]] = None) -> Callable:
    """Single-device step: ``(state, prepared, lr) -> (state, losses)``, the
    losses detached. ``on_stage(name)``, if given, is called as each stage
    ends: ``forward``, ``targets`` (targets and matching), ``backward`` and
    ``optimizer``."""
    mark = on_stage or _no_mark

    def step(state, prepared, lr):
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, (losses, _) = _loss_fn(model, prepared, crit_cfg, mark=mark)
        loss.backward()
        mark("backward")
        state = state.apply_gradients(lr=lr)
        mark("optimizer")
        return state, {k: v.detach() for k, v in losses.items()}

    return step
