"""Weight bridge between a flax ISBNet variable tree and the port's
``state_dict``, both ways.

The tree comes as nested numpy dicts with the collections ``params`` and
``batch_stats``. Module names carry over unchanged except flax's auto-named
``Dense_i``, which is ``dense{i}`` in the port. Leaves map as:

* ``nn.Dense`` kernel [in, out] -> ``weight`` [out, in] (transposed);
* SubMConv ``kernel`` [27, Cin, Cout], ``down_kernel`` / ``up_kernel``
  [8, Cin, Cout] -> the same name and layout;
* BatchNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``; batch stats
  ``mean`` / ``var`` -> ``running_mean`` / ``running_var``.

``load_flax_variables`` loads strictly, so a missing, extra or misshapen
entry raises. ``to_flax_variables`` maps back, from the parameters and
buffers of a model or from its parameters' ``.grad``, so the tests can hold
gradients and updated weights against the JAX package leaf by leaf.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_LEAF = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _module_name(name: str) -> str:
    return re.sub(r"^Dense_(\d+)$", r"dense\1", name)


def _flax_module_name(name: str) -> str:
    return re.sub(r"^dense(\d+)$", r"Dense_\1", name)


def flax_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """Nested numpy dicts {"params": ..., "batch_stats": ...} -> state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path, coll):
        for key, val in tree.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                walk(val, path + (_module_name(key),), coll)
                continue
            arr = np.asarray(val, np.float32)
            if coll == "params" and key == "kernel" and arr.ndim == 2:
                leaf, arr = "weight", arr.T
            elif coll == "params" and key in ("kernel", "down_kernel", "up_kernel"):
                leaf = key
            else:
                leaf = _LEAF[(coll, key)]
            out[".".join(path + (leaf,))] = torch.tensor(arr)

    for coll in ("params", "batch_stats"):
        walk(variables.get(coll, {}), (), coll)
    return out


def load_flax_variables(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Load a flax variable tree into ``model`` (strict)."""
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model


def to_flax_variables(model: torch.nn.Module, grads: bool = False):
    """The port's parameters and BatchNorm statistics as a flax tree of
    nested numpy dicts (the inverse of ``flax_to_state_dict``). With
    ``grads`` the tree holds each parameter's ``.grad`` (zeros where it is
    None) and only the ``params`` collection."""
    inv = {v: k for k, v in _LEAF.items()}
    out: Dict[str, dict] = {"params": {}} if grads else {"params": {}, "batch_stats": {}}
    named = list(model.named_parameters())
    if not grads:
        named += list(model.named_buffers())
    for name, t in named:
        *path, leaf = name.split(".")
        if grads:
            t = t.grad if t.grad is not None else torch.zeros_like(t)
        arr = t.detach().cpu().numpy()
        if leaf in ("kernel", "down_kernel", "up_kernel"):
            coll, key = "params", leaf
        elif leaf == "weight" and arr.ndim == 2:
            coll, key, arr = "params", "kernel", arr.T
        else:
            coll, key = inv[leaf]
        node = out[coll]
        for p in path:
            node = node.setdefault(_flax_module_name(p), {})
        node[key] = np.ascontiguousarray(arr)
    return out
