"""S3DIS instance metrics: mCov, mWCov, mPrec and mRec (numpy, host side),
as ``gapro_tpu/eval/s3dis_eval.py`` computes them.

Per room: the predictions are painted onto the points in ascending
confidence (a point keeps the most confident mask that holds it); each
ground-truth and predicted instance takes the majority semantic class of
its points (ties to the lower class); per class, a ground-truth
instance's coverage is its best IoU with a predicted instance of its
class, and a prediction is a true positive where that IoU reaches 0.5.
mCov and mWCov (weighted by the instance's points) average the coverage
over a class's rooms and then over the classes; precision and recall are
pooled over the rooms.

All IoUs of a room come from one bincount of (ground truth, prediction)
pairs, where the JAX package intersects mask by mask; the numbers are the
same.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..utils.rle import rle_decode
from .instance_eval import S3DIS_INSTANCE_CLASSES


def _instances(ins_map, sem_map, skip: int):
    """The instances of a point map (ids other than ``skip``), ascending:
    (their majority semantic class, their point counts, each point's
    instance index or -1)."""
    keep = ins_map != skip
    ids, inv = np.unique(ins_map[keep], return_inverse=True)
    sems, sinv = np.unique(sem_map[keep], return_inverse=True)
    votes = np.bincount(inv * len(sems) + sinv,
                        minlength=len(ids) * len(sems)).reshape(len(ids), len(sems))
    index = np.full(len(ins_map), -1, np.int64)
    index[keep] = inv
    return sems[votes.argmax(1)] if len(ids) else sems[:0], votes.sum(1), index


class S3DISEval:
    CLASSES = S3DIS_INSTANCE_CLASSES

    def __init__(self, num_classes: int = 13, iou_thresh: float = 0.5):
        self.num_classes = num_classes
        self.at = iou_thresh
        self.cov: List[List[float]] = [[] for _ in range(num_classes)]
        self.wcov: List[List[float]] = [[] for _ in range(num_classes)]
        self.tp = np.zeros(num_classes)
        self.fp = np.zeros(num_classes)
        self.n_gt = np.zeros(num_classes)

    def _scene(self, preds, gt_sem, gt_ins):
        gt_sem = np.asarray(gt_sem).copy()
        gt_ins = np.asarray(gt_ins).copy()
        ignore = (gt_ins < 0) | (gt_sem < 0)
        gt_sem[ignore] = -1
        gt_ins[ignore] = -1

        n = len(gt_sem)
        pred_ins = np.zeros(n, np.int64)
        pred_sem = np.zeros(n, np.int64)
        order = np.argsort([p["conf"] for p in preds])  # ascending: the most confident wins
        for rank, pi in enumerate(order):
            m = preds[pi]["pred_mask"]
            m = (rle_decode(m) if isinstance(m, dict) else np.asarray(m)) != 0
            pred_ins[m] = rank + 1
            pred_sem[m] = int(preds[pi]["label_id"]) - 1

        g_cls, g_size, g_idx = _instances(gt_ins, gt_sem, -1)
        p_cls, p_size, p_idx = _instances(pred_ins, pred_sem, 0)
        both = (g_idx >= 0) & (p_idx >= 0)
        inter = np.bincount(g_idx[both] * len(p_cls) + p_idx[both],
                            minlength=len(g_cls) * len(p_cls)).reshape(len(g_cls), len(p_cls))

        for c in range(self.num_classes):
            gi, pi = np.flatnonzero(g_cls == c), np.flatnonzero(p_cls == c)
            self.n_gt[c] += len(gi)
            if not len(gi):
                self.fp[c] += len(pi)
                continue
            i = inter[np.ix_(gi, pi)]
            ious = i / np.maximum(g_size[gi][:, None] + p_size[pi][None, :] - i, 1)
            best = ious.max(1) if len(pi) else np.zeros(len(gi))
            sizes = g_size[gi].astype(np.float64)
            self.cov[c].append(float(best.mean()))
            self.wcov[c].append(float((best * sizes).sum() / sizes.sum()))
            hits = int((ious.max(0) >= self.at).sum()) if len(pi) else 0
            self.tp[c] += hits
            self.fp[c] += len(pi) - hits

    def evaluate(self, pred_list, gt_sem_list, gt_ins_list):
        """Per-room predictions, semantic and instance labels -> (mCov,
        mWCov, mPrec, mRec)."""
        for preds, sem, ins in zip(pred_list, gt_sem_list, gt_ins_list):
            self._scene(preds, sem, ins)
        mucov = np.array([np.mean(c) if c else np.nan for c in self.cov])
        mwcov = np.array([np.mean(c) if c else np.nan for c in self.wcov])
        with np.errstate(divide="ignore", invalid="ignore"):
            prec = self.tp / (self.tp + self.fp)
            rec = np.minimum(1.0, self.tp / self.n_gt)
        return (float(np.nanmean(mucov)), float(np.nanmean(mwcov)), float(np.nanmean(prec)),
                float(np.nanmean(rec)))
