"""Dynamic-conv mask head (``gapro_tpu/models/dyco.py``).

Only the batched-einsum formulation ``dyco_mlp_xla`` is ported: the fused
TPU kernel (K5, ``_dyco_kernel``) is opt-in there and off by default, so it
is not on this path.
"""

from __future__ import annotations

import torch

_NEG = -1e4  # invalid-superpoint logit fill


def dyco_mlp(w0, w1, w2, b0, b1, q_locs, q_dims, sp_feats, sp_coords, sp_dims, sp_valid):
    """w0 [B,Q,m+6,m] (rows 0-5 geometry, 6: feats), w1 [B,Q,m,h],
    w2 [B,Q,h,1], b0 [B,Q,m], b1 [B,Q,h]; q_locs/q_dims [B,Q,3];
    sp_feats [B,S,m]; sp_coords/sp_dims [B,S,3]; sp_valid [B,S]
    -> mask logits [B,Q,S]."""
    rel_coords = q_locs[:, :, None, :] - sp_coords[:, None, :, :]
    rel_dims = torch.abs(q_dims[:, :, None, :] - sp_dims[:, None, :, :])
    rel_geo = torch.cat([rel_coords, rel_dims], -1)  # [B,Q,S,6]
    x = torch.relu(torch.einsum("bqsc,bqcd->bqsd", rel_geo, w0[:, :, :6, :])
                   + torch.einsum("bsc,bqcd->bqsd", sp_feats, w0[:, :, 6:, :])
                   + b0[:, :, None, :])
    x = torch.relu(torch.einsum("bqsc,bqcd->bqsd", x, w1) + b1[:, :, None, :])
    x = torch.einsum("bqsc,bqcd->bqsd", x, w2)[..., 0]  # no bias on the last layer
    return torch.where(sp_valid[:, None, :], x, _NEG)
