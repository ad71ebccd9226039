"""Weight bridge between a flax ISBNet or SPFormer variable tree and the
port's ``state_dict``, both ways.

The tree comes as nested numpy dicts with the collections ``params`` and
``batch_stats``. Module names carry over unchanged except flax's auto-named
modules: ``Dense_i`` is ``dense{i}`` in the port,
``MultiHeadDotProductAttention_0`` is ``attn`` and ``LayerNorm_0`` is
``norm``. Leaves map as:

* ``nn.Dense`` kernel [in, out] -> ``weight`` [out, in] (transposed);
* the attention's ``query`` / ``key`` / ``value`` kernels [d, h, d/h] ->
  ``weight`` [h * d/h, d], their biases [h, d/h] -> [h * d/h]; its ``out``
  kernel [h, d/h, d] -> ``weight`` [d, h * d/h];
* SubMConv ``kernel`` [27, Cin, Cout], ``down_kernel`` / ``up_kernel``
  [8, Cin, Cout] -> the same name and layout;
* BatchNorm and LayerNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
  batch stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
* SPFormer's learned queries ``decoder/query`` [Q, d] -> the same.

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


_AUTO_NAMES = {"MultiHeadDotProductAttention_0": "attn", "LayerNorm_0": "norm"}
_ATTN_PROJ = ("query", "key", "value")


def _module_name(name: str) -> str:
    return _AUTO_NAMES.get(name, re.sub(r"^Dense_(\d+)$", r"dense\1", name))


def _flax_module_name(name: str) -> str:
    inv = {v: k for k, v in _AUTO_NAMES.items()}
    return inv.get(name, re.sub(r"^dense(\d+)$", r"Dense_\1", name))


def _attn_leaf(path, key: str, arr):
    """An attention projection's flax leaf -> its port layout, or None if
    ``path`` is not an attention projection."""
    if len(path) < 2 or path[-2] != "attn" or path[-1] not in _ATTN_PROJ + ("out",):
        return None
    if key == "kernel":
        if path[-1] == "out":  # [h, d/h, d] -> [d, h * d/h]
            return "weight", arr.reshape(-1, arr.shape[-1]).T
        return "weight", arr.reshape(arr.shape[0], -1).T  # [d, h, d/h] -> [h * d/h, d]
    return "bias", arr.reshape(-1)


def flax_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """Nested numpy dicts {"params": ..., "batch_stats": ...} -> state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path, coll):
        for key, val in tree.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                walk(val, path + (_module_name(key),), coll)
                continue
            arr = np.asarray(val, np.float32)
            attn = _attn_leaf(path, key, arr) if coll == "params" else None
            if attn is not None:
                leaf, arr = attn
            elif coll == "params" and key == "query":
                leaf = key
            elif coll == "params" and key == "kernel" and arr.ndim == 2:
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
        if len(path) >= 2 and path[-2] == "attn":
            h = model.get_submodule(".".join(path[:-1])).nhead
            coll, key = "params", "kernel" if leaf == "weight" else "bias"
            if leaf == "bias" and path[-1] != "out":
                arr = arr.reshape(h, -1)
            elif leaf == "weight" and path[-1] == "out":  # [d, h * d/h] -> [h, d/h, d]
                arr = arr.T.reshape(h, -1, arr.shape[0])
            elif leaf == "weight":  # [h * d/h, d] -> [d, h, d/h]
                arr = arr.T.reshape(arr.shape[1], h, -1)
        elif leaf == "query":
            coll, key = "params", leaf
        elif leaf in ("kernel", "down_kernel", "up_kernel"):
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
