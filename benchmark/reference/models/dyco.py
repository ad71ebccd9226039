# Frozen copy of gapro_tpu_torch/models/dyco.py, its CUDA kernels taken out (plain PyTorch only); it does not follow later changes
# to the port.
"""Dynamic-conv mask head (``gapro_tpu/models/dyco.py``).

Each query applies its own 3-layer MLP, whose weights the controller
predicts, to every superpoint: ``relu(W0 [q_loc - sp_coord; |q_dim -
sp_dim|; feat] + b0)`` -> ``relu(W1 . + b1)`` -> ``W2 .``, with -1e4 where
the superpoint is invalid.

* ``dyco_mlp_plain``: the batched-einsum form (``dyco_mlp_xla``), the plain
  PyTorch version of kernel K5.
* ``dyco_mlp``: the plain version under autograd.
"""

from __future__ import annotations

import torch

from .common import jabs

_NEG = -1e4  # invalid-superpoint logit fill


def dyco_mlp_plain(w0, w1, w2, b0, b1, q_locs, q_dims, sp_feats, sp_coords, sp_dims, sp_valid):
    """w0 [B,Q,m+6,m] (rows 0-5 geometry, 6: feats), w1 [B,Q,m,h],
    w2 [B,Q,h,1], b0 [B,Q,m], b1 [B,Q,h]; q_locs/q_dims [B,Q,3];
    sp_feats [B,S,m]; sp_coords/sp_dims [B,S,3]; sp_valid [B,S]
    -> mask logits [B,Q,S]."""
    rel_coords = q_locs[:, :, None, :] - sp_coords[:, None, :, :]
    rel_dims = jabs(q_dims[:, :, None, :] - sp_dims[:, None, :, :])
    rel_geo = torch.cat([rel_coords, rel_dims], -1)  # [B,Q,S,6]
    x = torch.relu(torch.einsum("bqsc,bqcd->bqsd", rel_geo, w0[:, :, :6, :])
                   + torch.einsum("bsc,bqcd->bqsd", sp_feats, w0[:, :, 6:, :])
                   + b0[:, :, None, :])
    x = torch.relu(torch.einsum("bqsc,bqcd->bqsd", x, w1) + b1[:, :, None, :])
    x = torch.einsum("bqsc,bqcd->bqsd", x, w2)[..., 0]  # no bias on the last layer
    return torch.where(sp_valid[:, None, :], x, _NEG)


def dyco_mlp(w0, w1, w2, b0, b1, q_locs, q_dims, sp_feats, sp_coords, sp_dims, sp_valid):
    """The mask head as the model calls it: the plain version under autograd."""
    return dyco_mlp_plain(w0, w1, w2, b0, b1, q_locs, q_dims, sp_feats, sp_coords, sp_dims,
                          sp_valid)
