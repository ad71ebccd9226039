# Frozen copy of gapro_tpu_torch/models/common.py; it does not follow later changes
# to the port.
"""Shared building blocks (``gapro_tpu/models/common.py``).

* ``BatchNorm``: flax ``nn.BatchNorm`` (momentum 0.9) over the last axis,
  ``(x - mean) * (scale * rsqrt(var + eps)) + bias``. In eval mode it reads
  the running statistics; in training mode it takes the batch statistics
  over the rows ``mask`` selects and updates the running ones (see
  ``BatchNorm.forward``).
* ``MLP`` (eps 1e-4), ``GenericMLP``, ``SharedMLP`` and ``ConvBlock1d``
  (eps 1e-5), with the JAX package's masking: every BatchNorm takes its
  statistics over the ``valid`` rows, and rows outside ``valid`` come out
  as 0.
* ``jabs`` and ``jmax0``: ``abs`` and ``max(x, 0)`` with JAX's gradient at
  0, where PyTorch's differs.

Module and attribute names follow the flax tree (``bn0``, ``bn_out``; flax's
auto-named ``Dense_i`` is ``dense{i}`` here), so ``convert.py`` maps the
weights by name. Linear layers are ``torch.nn.Linear`` ([out, in] weights).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def jabs(x):
    """``abs`` with ``jnp.abs``'s gradient: +1 at 0, where ``torch.abs``
    gives 0. A point's distance to itself is exactly 0 in the aggregator."""
    return torch.where(x >= 0, x, -x)


def jmax0(x):
    """``max(x, 0)`` with ``jnp.maximum``'s gradient: half to each side on a
    tie, where ``torch.clamp`` passes all of it."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mask_of(x, valid):
    """``valid`` reshaped to broadcast over the trailing axes of ``x``."""
    if valid is None:
        return None
    return valid.reshape(valid.shape + (1,) * (x.ndim - valid.ndim))


def masked(x, valid):
    """Zero the rows of ``x`` outside ``valid`` (broadcast over trailing axes)."""
    if valid is None:
        return x
    return torch.where(mask_of(x, valid), x, 0.0)


class BatchNorm(nn.Module):
    MOMENTUM = 0.9  # flax's convention: ra = 0.9 * ra + 0.1 * batch statistic

    def __init__(self, num_features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, mask=None):
        """Normalise over the last axis. In training mode the statistics are
        flax's ``_compute_stats``: the mean and ``max(0, E[x^2] - E[x]^2)``
        (biased) over the entries ``mask`` (broadcast to ``x``) selects, so
        a row repeated in ``x`` counts as often as it appears; gradients
        flow through both. The running statistics then move once, outside
        the graph. ``torch.nn.functional.batch_norm`` can neither mask nor
        take this variance."""
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.ndim - 1))
            if mask is None:
                mean, mean2 = x.mean(axes), (x * x).mean(axes)
            else:
                m = mask.expand_as(x)
                cnt = m.sum(axes).to(x.dtype)
                mean = torch.where(m, x, 0.0).sum(axes) / cnt
                mean2 = torch.where(m, x * x, 0.0).sum(axes) / cnt
            var = jmax0(mean2 - mean * mean)
            with torch.no_grad():
                mom = self.MOMENTUM
                self.running_mean.copy_(mom * self.running_mean + (1 - mom) * mean)
                self.running_var.copy_(mom * self.running_var + (1 - mom) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class MLP(nn.Module):
    """(Linear + BN(eps 1e-4) + ReLU)^(n-1) + Linear."""

    def __init__(self, in_dim: int, out_dim: int, num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers - 1):
            setattr(self, f"dense{i}", nn.Linear(in_dim, in_dim))
            setattr(self, f"bn{i}", BatchNorm(in_dim, 1e-4))
        setattr(self, f"dense{num_layers - 1}", nn.Linear(in_dim, out_dim))

    def forward(self, x, valid=None):
        mask = mask_of(x, valid)
        for i in range(self.num_layers - 1):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"dense{i}")(x), mask))
        return masked(getattr(self, f"dense{self.num_layers - 1}")(x), valid)


class GenericMLP(nn.Module):
    def __init__(self, in_dim: int, hidden_dims, out_dim: int, use_norm: bool = True,
                 hidden_use_bias: bool = False, output_use_bias: bool = True,
                 output_use_activation: bool = False, output_use_norm: bool = False):
        super().__init__()
        self.n_hidden = len(hidden_dims)
        self.use_norm = use_norm
        self.output_use_activation = output_use_activation
        d = in_dim
        for i, h in enumerate(hidden_dims):
            setattr(self, f"dense{i}", nn.Linear(d, h, bias=hidden_use_bias))
            if use_norm:
                setattr(self, f"bn{i}", BatchNorm(h, 1e-5))
            d = h
        setattr(self, f"dense{self.n_hidden}", nn.Linear(d, out_dim, bias=output_use_bias))
        self.bn_out = BatchNorm(out_dim, 1e-5) if output_use_norm else None

    def forward(self, x, valid=None):
        mask = mask_of(x, valid)
        for i in range(self.n_hidden):
            x = getattr(self, f"dense{i}")(x)
            if self.use_norm:
                x = getattr(self, f"bn{i}")(x, mask)
            x = torch.relu(x)
        x = getattr(self, f"dense{self.n_hidden}")(x)
        if self.bn_out is not None:
            x = self.bn_out(x, mask)
        if self.output_use_activation:
            x = torch.relu(x)
        return masked(x, valid)


class SharedMLP(nn.Module):
    """(Linear(no bias) + BN + ReLU) stacks over the last axis."""

    def __init__(self, in_dim: int, dims, final_activation: bool = True):
        super().__init__()
        self.n = len(dims)
        self.final_activation = final_activation
        d = in_dim
        for i, o in enumerate(dims):
            setattr(self, f"dense{i}", nn.Linear(d, o, bias=False))
            setattr(self, f"bn{i}", BatchNorm(o, 1e-5))
            d = o

    def forward(self, x, valid=None):
        mask = mask_of(x, valid)
        for i in range(self.n):
            x = getattr(self, f"bn{i}")(getattr(self, f"dense{i}")(x), mask)
            if i < self.n - 1 or self.final_activation:
                x = torch.relu(x)
        return masked(x, valid)


class ConvBlock1d(nn.Module):
    """Linear(no bias) + BN + optional ReLU."""

    def __init__(self, in_dim: int, out_dim: int, activation: bool = True):
        super().__init__()
        self.activation = activation
        self.dense0 = nn.Linear(in_dim, out_dim, bias=False)
        self.bn = BatchNorm(out_dim, 1e-5)

    def forward(self, x, valid=None):
        x = self.bn(self.dense0(x), mask_of(x, valid))
        if self.activation:
            x = torch.relu(x)
        return masked(x, valid)


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter and BN statistic of ``module`` from one
    ``torch.Generator``: weights uniform with variance 1/fan_in, biases and
    BN shifts small, BN scales and variances in [0.5, 1.5]. The port does
    not reproduce flax's initialisers; trained weights come through
    ``convert.py``."""
    g = torch.Generator().manual_seed(seed)

    def uniform_(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=g) * (hi - lo) + lo)

    for name, t in sorted(list(module.named_parameters()) + list(module.named_buffers())):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("running_var",) or (leaf == "weight" and t.dim() == 1):
            uniform_(t, 0.5, 1.5)
        elif leaf in ("bias", "running_mean"):
            uniform_(t, -0.1, 0.1)
        else:
            # Linear weight [out, in]; conv kernels [taps, Cin, Cout]
            fan_in = t.shape[1] if t.dim() == 2 else t.shape[0] * t.shape[1]
            bound = math.sqrt(3.0 / fan_in)
            uniform_(t, -bound, bound)
    return module
