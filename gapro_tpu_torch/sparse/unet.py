"""Sparse residual U-Net backbone (``gapro_tpu/sparse/unet.py``).

A SubMConv stem, then a recursive UBlock: per level two pre-activation
residual blocks, a stride-2 down conv, the next level, an inverse conv, the
skip concat and two tail residual blocks; channels c, 2c, ..., 7c. BatchNorm
eps 1e-4; in training mode each takes its statistics over the valid voxels
of its own level. Every conv reads the precomputed ``UNetPlan``. Kernels
keep the JAX layout: SubMConv [27, Cin, Cout], down/up [8, Cin, Cout].
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.common import BatchNorm
from .conv import down_conv, inverse_conv, subm_conv_auto
from .plan import UNetPlan

_EPS = 1e-4


class SubMConv(nn.Module):
    """3x3x3 submanifold conv over a level's neighbour table."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(27, in_dim, out_dim))

    def forward(self, feats, level_plan):
        return subm_conv_auto(feats, level_plan, self.kernel)


class Conv1x1(nn.Module):
    """1x1 sparse conv: a dense projection on valid rows."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.dense0 = nn.Linear(in_dim, out_dim, bias=False)

    def forward(self, feats, valid):
        return torch.where(valid[:, None], self.dense0(feats), 0.0)


class ResidualBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.i_branch = Conv1x1(in_dim, out_dim) if in_dim != out_dim else None
        self.bn0 = BatchNorm(in_dim, _EPS)
        self.conv0 = SubMConv(in_dim, out_dim)
        self.bn1 = BatchNorm(out_dim, _EPS)
        self.conv1 = SubMConv(out_dim, out_dim)

    def forward(self, feats, level_plan):
        valid = level_plan.grid.valid
        mask = valid[:, None]
        identity = feats if self.i_branch is None else self.i_branch(feats, valid)
        x = self.conv0(torch.relu(self.bn0(feats, mask)), level_plan)
        x = self.conv1(torch.relu(self.bn1(x, mask)), level_plan)
        return x + identity


class UBlock(nn.Module):
    def __init__(self, n_planes, block_reps: int = 2):
        super().__init__()
        c = n_planes[0]
        self.block_reps = block_reps
        for i in range(block_reps):
            setattr(self, f"block{i}", ResidualBlock(c, c))
        self.deeper = len(n_planes) > 1
        if self.deeper:
            self.conv_bn = BatchNorm(c, _EPS)
            self.down_kernel = nn.Parameter(torch.zeros(8, c, n_planes[1]))
            self.u = UBlock(n_planes[1:], block_reps)
            self.deconv_bn = BatchNorm(n_planes[1], _EPS)
            self.up_kernel = nn.Parameter(torch.zeros(8, n_planes[1], c))
            for i in range(block_reps):
                setattr(self, f"tail_block{i}", ResidualBlock(2 * c if i == 0 else c, c))

    def forward(self, feats, plan: UNetPlan, level: int):
        lp = plan.levels[level]
        x = feats
        for i in range(self.block_reps):
            x = getattr(self, f"block{i}")(x, lp)
        if not self.deeper:
            return x
        nxt = plan.levels[level + 1]
        y = torch.relu(self.conv_bn(x, lp.grid.valid[:, None]))
        y = down_conv(y, lp.down_child, self.down_kernel, out_valid=nxt.grid.valid)
        y = self.u(y, plan, level + 1)
        y = torch.relu(self.deconv_bn(y, nxt.grid.valid[:, None]))
        y = inverse_conv(y, lp.parent, lp.offset_id, self.up_kernel, lp.grid.valid)
        x = torch.cat([x, y], 1)
        for i in range(self.block_reps):
            x = getattr(self, f"tail_block{i}")(x, lp)
        return x


class SparseUNetBackbone(nn.Module):
    """SubMConv stem + UBlock + output BN/ReLU."""

    def __init__(self, channels: int = 32, num_blocks: int = 7, in_channels: int = 6):
        super().__init__()
        planes = tuple(channels * (i + 1) for i in range(num_blocks))
        self.input_conv = SubMConv(in_channels, channels)
        self.unet = UBlock(planes)
        self.output_bn = BatchNorm(channels, _EPS)

    def forward(self, feats, plan: UNetPlan):
        valid = plan.levels[0].grid.valid
        x = self.input_conv(feats, plan.levels[0])
        x = self.unet(x, plan, 0)
        x = torch.relu(self.output_bn(x, valid[:, None]))
        return torch.where(valid[:, None], x, 0.0)
