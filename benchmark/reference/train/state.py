# Frozen copy of gapro_tpu_torch/train/state.py; it does not follow later changes
# to the port.
"""Training state: the model (parameters and BatchNorm statistics) and AdamW
(``gapro_tpu/train/state.py``).

AdamW with lr 1e-3 and weight decay 1e-4 (``configs/isbnet_scannetv2.yaml``),
beta 0.9 / 0.999 and eps 1e-8: ``torch.optim.AdamW`` makes the update of
``optax.adamw``, weight decay on every trained parameter included (one the
loss did not reach takes a zero gradient, as ``jax.grad`` gives). The
learning rate is set on the parameter groups before each update, as
``optax.inject_hyperparams`` feeds it in the JAX package. Frozen modules
(``fixed_modules``) are left out of the optimizer, which is what the JAX
package's ``optax.masked(set_to_zero)`` amounts to: no update and no decay.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


def cosine_lr_after_step(base_lr, epoch, step_epoch, total_epochs, clip=1e-6):
    """Constant until ``step_epoch``, then cosine down to ``clip``."""
    if epoch < step_epoch:
        return base_lr
    t = (epoch - step_epoch) / max(total_epochs - step_epoch, 1)
    return clip + 0.5 * (base_lr - clip) * (1 + math.cos(math.pi * t))


def poly_lr(base_lr, epoch, max_epochs, power: float = 0.9):
    """PolyLR (SPFormer's schedule): base * (1 - epoch / max)^power."""
    return base_lr * max(1.0 - epoch / max(max_epochs, 1), 0.0) ** power


# reference fixed_modules names -> the model's top-level modules
_FIXED_NAME_MAP = {
    "input_conv": "backbone",
    "unet": "backbone",
    "output_layer": "backbone",
    "offset_linear": "offset_vertices_linear",
}


def fixed_param_keys(fixed_modules) -> frozenset:
    return frozenset(_FIXED_NAME_MAP.get(m, m) for m in fixed_modules)


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def apply_gradients(self, lr=None) -> "TrainState":
        """One AdamW update from the gradients held in the parameters'
        ``.grad``; ``lr`` replaces the learning rate first. A trained
        parameter the loss did not reach (``.grad`` None) takes a zero
        gradient, as ``jax.grad`` gives it: AdamW then decays it as
        ``optax.adamw`` does, and every rank of a data-parallel step (which
        sums a gradient for every parameter) makes the same update."""
        for group in self.optimizer.param_groups:
            if lr is not None:
                group["lr"] = float(lr)
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.step += 1
        return self


def create_train_state(model: torch.nn.Module, lr=1e-3, weight_decay=1e-4,
                       fixed_modules=()) -> TrainState:
    """AdamW over the parameters of every module not in ``fixed_modules``
    (reference names or the model's top-level module names)."""
    frozen = fixed_param_keys(fixed_modules)
    top = {name.split(".")[0] for name, _ in model.named_parameters()}
    missing = frozen - top
    if missing:
        raise ValueError(f"fixed_modules not in params: {sorted(missing)}")
    params = [p for name, p in model.named_parameters() if name.split(".")[0] not in frozen]
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return TrainState(model=model, optimizer=opt)
