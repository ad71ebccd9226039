"""The weights both sides run: drawn from the seed on the device, in one
call, for every floating-point parameter and statistic of the model.

The rule per leaf is that of the port's ``models/common.py:seeded_init_``
(frozen here): weights uniform with variance 1/fan_in (a Linear weight
[out, in]; a conv kernel [taps, Cin, Cout]), biases and BatchNorm means in
[-0.1, 0.1], BatchNorm scales and variances in [0.5, 1.5]. A config's
``assumed.bias_shift`` then adds to named biases.
"""

from __future__ import annotations

import math

import torch


def leaves(model) -> list:
    """(name, shape) of every floating-point parameter and buffer, by name."""
    named = list(model.named_parameters()) + list(model.named_buffers())
    return sorted((n, tuple(t.shape)) for n, t in named if t.is_floating_point())


def _range(name: str, shape: tuple):
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var" or (leaf == "weight" and len(shape) == 1):
        return 0.5, 1.5
    if leaf in ("bias", "running_mean"):
        return -0.1, 0.1
    fan_in = shape[1] if len(shape) == 2 else shape[0] * shape[1]
    b = math.sqrt(3.0 / fan_in)
    return -b, b


def draw(layout: list, seed: int, device, shifts: dict) -> dict:
    """name -> tensor on ``device`` for the ``leaves`` layout, from one
    ``torch.rand`` of a generator on ``device`` seeded with ``seed``."""
    total = sum(math.prod(s) for _, s in layout)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=g, device=device)
    sizes, bounds, spans, at = [], [], [], 0
    for name, shape in layout:
        n = math.prod(shape)
        sizes.append(n)
        bounds.append(_range(name, shape))
        spans.append((name, shape, at, n))
        at += n
    sizes = torch.tensor(sizes, device=device)
    lo, hi = (torch.repeat_interleave(torch.tensor(col, device=device), sizes, output_size=total)
              for col in zip(*bounds))
    flat = flat * (hi - lo) + lo
    out = {name: flat[at:at + n].view(shape) for name, shape, at, n in spans}
    for name, shift in shifts.items():
        out[name] = out[name] + shift
    return out


@torch.no_grad()
def load(model, state: dict) -> None:
    """Copy ``state`` into ``model``'s leaves; the names must be the same."""
    named = dict(list(model.named_parameters()) + list(model.named_buffers()))
    mine = {n for n, t in named.items() if t.is_floating_point()}
    if mine != set(state):
        raise KeyError(f"weights and model differ: {sorted(mine ^ set(state))[:8]}")
    for n, v in state.items():
        named[n].copy_(v)
