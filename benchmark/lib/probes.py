"""Probes the benchmark puts around the port's entry points from outside,
in a traced run only: a named profiler range around each call (so that the
reduction can give each range the device time of the kernels it and its
autograd backward launched), and, in a counting pass, the operations and
bytes of each call from its shapes and tables.

The entry points are looked up by name where the port calls them:
``sparse/unet.py``'s ``subm_conv_auto``, ``down_conv`` and
``inverse_conv``; ``ops/fps.py:fps``, which ``models/aggregator.py``
calls through its module; ``models/isbnet.py``'s ``dyco_mlp``; and the
``decoder`` module of an SPFormer.

The dense layers' operations are those of every aten call that
``torch.utils.flop_counter`` has a rule for, each scaled to what the
inputs need: a dimension of a call's tensors whose size is a capacity of
the unit (the points' bucket, the voxels', ``spp_cap``) counts at its
valid share, once a call. Where two capacities have one size, the smaller
share is taken, so that padding never counts as work.
"""

from __future__ import annotations

import contextlib
import importlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from . import counts

CONV = "bench.conv"
FPS = "bench.fps"
DYCO = "bench.dyco"
DECODER = "bench.decoder"


class Probes:
    """Install with ``install(model)``; ``counting`` makes each probe add
    its call's operations and bytes to ``self.tally`` (a host sync a call,
    so only outside a timed or profiled stretch)."""

    def __init__(self, backward: bool):
        self.backward = backward
        self.counting = False
        self.flops = None  # a _DenseFlops while counting
        self.shares = {}  # capacity -> its valid share, for the unit being counted
        self.tally = {}
        self._undo = []

    def add(self, key: str, ops: float, nbytes: float, least: float) -> None:
        t = self.tally.setdefault(key, dict(ops=0.0, bytes=0.0, least_s=0.0, calls=0))
        t["ops"] += ops
        t["bytes"] += nbytes
        t["least_s"] += least
        t["calls"] += 1

    def _patch(self, module, name: str, make):
        orig = getattr(module, name)
        setattr(module, name, make(orig))
        self._undo.append((module, name, orig))

    @contextlib.contextmanager
    def _aten_flops_left_out(self):
        """While counting, the dense operations the call runs (a plain
        stride-2 conv's matmuls) are taken back out of the dense count: the
        probe counts the call itself."""
        before = self.flops.get_total_flops() if self.flops is not None else 0
        yield
        if self.flops is not None:
            self.tally.setdefault("aten_in_probes", dict(ops=0.0))
            self.tally["aten_in_probes"]["ops"] += self.flops.get_total_flops() - before

    def _conv_probe(self, orig, kind: str):
        probes = self

        def probe(*args, **kw):
            with torch.profiler.record_function(CONV), probes._aten_flops_left_out():
                out = orig(*args, **kw)
            if probes.counting:
                probes._count_conv(kind, args, kw, out)
            return out

        return probe

    def _count_conv(self, kind, args, kw, out) -> None:
        if kind == "subm":
            feats, lp, w = args
            nbr, valid = lp.subm_nbr, lp.grid.valid
            pairs = int(((nbr >= 0) & valid[:, None]).sum())
            parts = counts.subm_counts(int(valid.sum()), pairs, w.shape[1], w.shape[2],
                                       self.backward)
        elif kind == "down":
            feats, child, w = args[:3]
            ov = kw.get("out_valid", args[3] if len(args) > 3 else None)
            ok = child >= 0
            if ov is not None:
                ok = ok & ov[:, None]
            rows = ok.any(1)
            parts = counts.rule_counts(int(torch.unique(child[ok]).numel()), int(rows.sum()),
                                       8 * int(rows.sum()), int(ok.sum()), w.shape[1],
                                       w.shape[2], self.backward)
        else:
            coarse, parent, offset_id, w, valid = args
            ok = (parent >= 0) & valid
            pairs = int(ok.sum())
            parts = counts.rule_counts(int(torch.unique(parent[ok]).numel()), pairs, 2 * pairs,
                                       pairs, w.shape[1], w.shape[2], self.backward)
        for ops, nbytes in parts:
            self.add("conv", ops, nbytes, counts.least_s(ops, nbytes))

    def _fps_probe(self, orig):
        probes = self

        def probe(xyz, valid, n_sample):
            with torch.profiler.record_function(FPS):
                out = orig(xyz, valid, n_sample)
            if probes.counting:
                ops = counts.fps_ops(int(valid.sum()), n_sample)
                nbytes = counts.fps_bytes(int(valid.sum()), xyz.shape[0], n_sample)
                probes.add("fps", ops, nbytes, counts.least_s(ops, nbytes, counts.FP32_FLOPS))
            return out

        return probe

    def _dyco_probe(self, orig):
        probes = self

        def probe(*args):
            with torch.profiler.record_function(DYCO), probes._aten_flops_left_out():
                out = orig(*args)
            if probes.counting:
                w0, sp_feats, sp_valid = args[0], args[7], args[10]
                b, q = w0.shape[:2]
                m = sp_feats.shape[-1]
                pairs = q * int(sp_valid.sum())
                ops = counts.dyco_ops(pairs, m)
                nbytes = counts.dyco_bytes(b, q, int(sp_valid.sum()) / b, m)
                probes.add("dyco", ops, nbytes, counts.least_s(ops, nbytes))
            return out

        return probe

    def install(self, model) -> "Probes":
        unet = importlib.import_module("gapro_tpu_torch.sparse.unet")
        self._patch(unet, "subm_conv_auto", lambda f: self._conv_probe(f, "subm"))
        self._patch(unet, "down_conv", lambda f: self._conv_probe(f, "down"))
        self._patch(unet, "inverse_conv", lambda f: self._conv_probe(f, "inverse"))
        fps = importlib.import_module("gapro_tpu_torch.ops.fps")
        self._patch(fps, "fps", self._fps_probe)
        isbnet = importlib.import_module("gapro_tpu_torch.models.isbnet")
        self._patch(isbnet, "dyco_mlp", self._dyco_probe)
        decoder = getattr(model, "decoder", None)
        if decoder is not None:
            orig = decoder.forward

            def forward(*args, **kw):
                with torch.profiler.record_function(DECODER):
                    return orig(*args, **kw)

            decoder.forward = forward
            self._undo.append((decoder, "forward", None))
        return self

    def remove(self) -> None:
        for module, name, orig in reversed(self._undo):
            if orig is None:
                delattr(module, name)
            else:
                setattr(module, name, orig)
        self._undo = []

    def set_unit(self, points_valid, batch) -> None:
        """The valid shares of the next counted unit's capacities: its point
        batch's validity (host or device) and its voxel batch."""
        shares = {}

        def put(size: int, n: int) -> None:
            shares[int(size)] = min(shares.get(int(size), 1.0), min(int(n), size) / size)

        pv = torch.as_tensor(points_valid)
        put(pv.shape[0], int(pv.sum()))
        put(batch.valid.shape[0], int(batch.valid.sum()))
        spp = batch.spp[batch.valid]
        put(batch.n_spp, int(torch.unique(spp[spp >= 0]).numel()))
        self.shares = shares

    @contextlib.contextmanager
    def count(self):
        """Count operations and bytes; the dense layers' operations by
        ``torch.utils.flop_counter``'s rules per operation (the probed
        calls' own left out)."""
        self.tally = {}
        self.counting = True
        self.flops = _DenseFlops(self)
        try:
            with self.flops:
                yield self
        finally:
            self.counting = False
            dense = self.flops.get_total_flops() - self.tally.get("aten_in_probes",
                                                                   {}).get("ops", 0.0)
            self.tally["dense"] = dict(ops=float(dense))
            self.flops = None
            self.shares = {}


class _DenseFlops(TorchDispatchMode):
    """The operations of every aten call that ``torch.utils.flop_counter``
    has a rule for (matmuls, convolutions, attention), each at the valid
    share of the capacities among its tensors' sizes, summed."""

    def __init__(self, probes: Probes):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.probes = probes
        self.total = 0.0

    def get_total_flops(self) -> float:
        return self.total

    def _share(self, args, kwargs) -> float:
        shares = self.probes.shares
        sizes = set()
        for a in tree_leaves((args, kwargs)):
            if isinstance(a, torch.Tensor):
                sizes.update(int(d) for d in a.shape)
        out = 1.0
        for size in sizes & set(shares):
            out *= shares[size]
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rule = self.registry.get(func._overloadpacket)
        if rule is not None:
            self.total += rule(*args, **kwargs, out_val=out) * self._share(args, kwargs)
        return out
