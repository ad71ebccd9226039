"""The numbers that decide ``correct``, each the side under test's against
the plain reference's.

Training (the first three steps of the one training object):
* ``loss_gap``: the first step's |loss - ref| / |ref| (the later steps'
  gaps are printed beside it, not compared: Adam's first update moves
  every element by about the learning rate whatever its gradient's size,
  so the sign of a gradient at rounding level sets where a parameter goes,
  and the steps after the first drift apart by far more than the first);
* ``grad_gap``: the first gradient as the optimizer got it (AdamW's first
  moment after one step over 1 - beta1), leaf by leaf: the gap between the
  two norms over the larger of the reference's norm and the median leaf's;
* ``change_gap``: the same gap for each parameter's change over the three
  steps, at the median leaf (the worst leaf's, a small bias moved by the
  later steps' drift, is printed beside it), leaving out the leaves whose
  reference gradient is under a thousandth of the median leaf's (they move
  under Adam by round-off);
* ``turn_gap``: the direction of that change, 1 - the cosine between the
  two sides' changes of a leaf, at the median of the same leaves (2 for a
  change turned round, 1 for a leaf left unmoved on one side).

Inference (the records of a sample of the window's requests): each served
instance is paired with the unpaired reference instance of its label with
the largest mask IoU, at IoU 0.5 or more, in order of confidence;
``conf_gap`` is the largest |conf - ref| of a pair, ``mask_gap`` the
largest 1 - IoU (``conf_gap_median`` and ``mask_gap_mean`` beside them),
``unpaired`` the number of both sides' instances left unpaired.
"""

from __future__ import annotations

import numpy as np
import torch

BETA1 = 0.9
EXCLUDE_SHARE = 1e-3


@torch.no_grad()
def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


@torch.no_grad()
def first_gradient(state) -> dict:
    """name -> the gradient AdamW took at its first step, from its first
    moment."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    out = {}
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            m = state.optimizer.state.get(p, {}).get("exp_avg")
            out[names[id(p)]] = torch.zeros_like(p) if m is None else m / (1.0 - BETA1)
    return out


def _gaps(got: dict, want: dict, keys) -> dict:
    """Each leaf's gap between the two norms over the larger of the
    reference's norm and the median leaf's."""
    keys = list(keys)
    if not keys:
        return {}
    med = float(np.median([want[k] for k in keys]))
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys}


def train_numbers(got: dict, want: dict) -> dict:
    """``got``/``want``: dict(losses=[...], grad={leaf: norm}, change={leaf:
    norm})."""
    if set(got["grad"]) != set(want["grad"]):
        raise KeyError("the two sides' parameters differ")
    steps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], want["losses"])]
    grad = _gaps(got["grad"], want["grad"], want["grad"])
    med = float(np.median(list(want["grad"].values())))
    moved = [k for k, v in want["grad"].items() if v >= EXCLUDE_SHARE * med]
    change = _gaps(got["change"], want["change"], moved)
    grad_at = max(grad, key=grad.get)
    change_at = max(change, key=change.get)
    turns = {}
    if "change_vec" in got and "change_vec" in want:
        turns = {k: _turn(got["change_vec"][k], want["change_vec"][k]) for k in moved}
    return dict(loss_gap=steps[0], later_loss_gaps=steps[1:], grad_gap=grad[grad_at],
                grad_at=grad_at, grad_gap_median=float(np.median(list(grad.values()))),
                grad_gap_q90=float(np.quantile(list(grad.values()), 0.9)), change_gap=float(np.median(list(change.values()))),
                worst_change_gap=change[change_at], change_at=change_at,
                left_out=len(want["grad"]) - len(moved),
                **(dict(turn_gap=float(np.median(list(turns.values()))),
                        worst_turn_gap=max(turns.values())) if turns else {}))


@torch.no_grad()
def _turn(a: torch.Tensor, b: torch.Tensor) -> float:
    """1 - the cosine between two changes of one leaf (1 where either is
    nought)."""
    a, b = a.double().flatten().cpu(), b.double().flatten().cpu()
    na, nb = float(torch.linalg.vector_norm(a)), float(torch.linalg.vector_norm(b))
    if na == 0.0 or nb == 0.0:
        return 1.0
    return 1.0 - float(a @ b) / (na * nb)


def _decode(rle: dict) -> np.ndarray:
    counts = np.asarray(rle["counts"].split(), np.int64) if isinstance(rle["counts"], str) \
        else np.asarray(rle["counts"], np.int64)
    mask = np.zeros(int(rle["length"]), bool)
    starts, lengths = counts[0::2] - 1, counts[1::2]
    for s, n in zip(starts, lengths):
        mask[s:s + n] = True
    return mask


def infer_numbers(got: list, want: list) -> dict:
    """``got``/``want``: per request, the list of instance records."""
    confs, masks = [], []
    unpaired = total = 0
    for g, w in zip(got, want):
        gm = [_decode(r["pred_mask"]) for r in g]
        wm = [_decode(r["pred_mask"]) for r in w]
        free = set(range(len(w)))
        for i in sorted(range(len(g)), key=lambda i: -g[i]["conf"]):
            best, at = 0.0, None
            for j in free:
                if w[j]["label_id"] != g[i]["label_id"]:
                    continue
                union = np.count_nonzero(gm[i] | wm[j])
                iou = np.count_nonzero(gm[i] & wm[j]) / union if union else 1.0
                if iou > best:
                    best, at = iou, j
            if at is None or best < 0.5:
                unpaired += 1
                continue
            free.discard(at)
            confs.append(abs(g[i]["conf"] - w[at]["conf"]))
            masks.append(1.0 - best)
        unpaired += len(free)
        total += len(g) + len(w)
    med = lambda v: float(np.median(v)) if v else 0.0
    return dict(conf_gap=max(confs, default=0.0), mask_gap=max(masks, default=0.0),
                conf_gap_median=med(confs), mask_gap_mean=float(np.mean(masks)) if masks
                else 0.0, unpaired=unpaired, instances=total)


def worst_leaves(got: dict, want: dict, n: int = 5) -> dict:
    """The ``n`` worst leaves of each of the gradient and the change, with
    both sides' norms (a diagnosis)."""
    out = {}
    for key in ("grad", "change"):
        med = float(np.median(list(want[key].values())))
        rows = sorted(((abs(got[key][k] - want[key][k]) / max(want[key][k], med, 1e-30), k,
                        got[key][k], want[key][k]) for k in want[key]), reverse=True)[:n]
        out[key] = [[k, g, w, gap] for gap, k, g, w in rows]
    return out
