"""ScanNet instance-segmentation AP (numpy copy of
``gapro_tpu/eval/instance_eval.py``), host side.

The ScanNet benchmark's rules as the reference applies them:

* ground truth encoded as ``code = sem' * 1000 + inst'``, void 0 (sem + 1,
  the background class 19 -> 0);
* greedy matching per IoU threshold with one visited set over all
  predictions; a second match of one ground-truth instance demotes the
  lower-confidence prediction to a false positive;
* an unmatched prediction counts as a false positive unless it mostly
  covers void or small ground truth;
* AP integrates the precision-recall curve with the [-0.5, 0, 0.5] step
  rule over IoU 0.5:0.05:0.9, plus 0.25.

Intersections are one bincount per predicted mask. The box AP of SPFormer
(``evaluate_box``) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from ..utils.rle import rle_decode

SCANNET_INSTANCE_CLASSES = (
    "cabinet", "bed", "chair", "sofa", "table", "door", "window", "bookshelf",
    "picture", "counter", "desk", "curtain", "refrigerator", "shower curtain",
    "toilet", "sink", "bathtub", "otherfurniture",
)

S3DIS_INSTANCE_CLASSES = (
    "ceiling", "floor", "wall", "beam", "column", "window", "door", "chair",
    "table", "bookcase", "sofa", "board", "clutter",
)


@dataclass
class _GT:
    instance_id: int  # encoded sem*1000+inst
    vert_count: int
    matched: List[dict] = field(default_factory=list)  # {pred_idx, iou, conf, intersection}


@dataclass
class _Pred:
    pred_idx: int  # global index (greedy-visited key)
    vert_count: int
    confidence: float
    void_intersection: int
    matched: List[dict] = field(default_factory=list)  # {gt_code, iou, intersection, gt_vert_count}


class ScanNetEval:
    """evaluate(pred_insts, sem_labels, inst_labels) -> metric dict."""

    def __init__(self, class_labels: Sequence[str] = SCANNET_INSTANCE_CLASSES,
                 dataset_name: str = "scannetv2", min_region_size: int = 100):
        self.dataset_name = dataset_name
        self.class_labels = list(class_labels)
        self.class_ids = np.arange(len(class_labels)) + 1  # label_id convention
        self.ious = np.append(np.arange(0.5, 0.95, 0.05), 0.25)
        self.min_region_size = min_region_size

    # ------------------------------------------------------------------ #

    def _encode_gt(self, sem, inst):
        sem = np.asarray(sem).copy() + 1
        if self.dataset_name == "scannetv2":
            sem[sem == 19] = 0  # background class -> void
        sem[sem < 0] = 0
        inst = np.asarray(inst).copy() + 1
        code = sem * 1000 + inst
        code[inst <= 0] = 0
        return code

    def assign_scene(self, preds: List[dict], sem, inst, offset: int):
        """Per-scene cross-intersections. Returns per-class (gts, preds)."""
        code = self._encode_gt(sem, inst)
        void = ~np.isin(code // 1000, self.class_ids)

        uniq, counts = np.unique(code, return_counts=True)
        is_inst = (uniq % 1000 >= 1) & np.isin(uniq // 1000, self.class_ids)
        gt_codes = uniq[is_inst]
        gt_counts = counts[is_inst]

        per_class_gts: Dict[str, List[_GT]] = {ln: [] for ln in self.class_labels}
        gt_by_code: Dict[int, _GT] = {}
        for c, n in zip(gt_codes, gt_counts):
            g = _GT(instance_id=int(c), vert_count=int(n))
            per_class_gts[self.class_labels[int(c) // 1000 - 1]].append(g)
            gt_by_code[int(c)] = g

        # dense reindex of codes for bincount-based intersections
        code_rank = np.searchsorted(uniq, code)

        per_class_preds: Dict[str, List[_Pred]] = {ln: [] for ln in self.class_labels}
        k = offset
        for pred in preds:
            label_id = int(pred["label_id"])
            if not (1 <= label_id <= len(self.class_labels)):
                continue
            mask = pred["pred_mask"]
            if isinstance(mask, dict):
                mask = rle_decode(mask)
            mask = np.asarray(mask) != 0
            num = int(mask.sum())
            if num < self.min_region_size:
                continue
            label_name = self.class_labels[label_id - 1]

            inter = np.bincount(code_rank[mask], minlength=len(uniq))
            p = _Pred(
                pred_idx=k,
                vert_count=num,
                confidence=float(pred["conf"]),
                void_intersection=int(mask[void].sum()),
            )
            same_cls = gt_codes // 1000 == label_id
            for c, gn in zip(gt_codes[same_cls], gt_counts[same_cls]):
                ii = int(inter[np.searchsorted(uniq, c)])
                if ii > 0:
                    iou = ii / (gn + num - ii)
                    p.matched.append(dict(gt_code=int(c), iou=iou,
                                          intersection=ii, gt_vert_count=int(gn)))
                    gt_by_code[int(c)].matched.append(
                        dict(pred_idx=k, iou=iou, conf=p.confidence, intersection=ii)
                    )
            per_class_preds[label_name].append(p)
            k += 1
        return per_class_gts, per_class_preds, k

    # ------------------------------------------------------------------ #

    def _ap_single(self, scenes, label_name, iou_th, n_preds_total):
        """One (class, iou threshold) AP/RC following the benchmark greedy rules."""
        visited = np.zeros(n_preds_total, dtype=bool)
        y_true, y_score = [], []
        hard_fn = 0
        has_gt = has_pred = False

        for gts_c, preds_c in scenes:
            gts = [g for g in gts_c[label_name] if g.vert_count >= self.min_region_size]
            preds = preds_c[label_name]
            has_gt |= bool(gts)
            has_pred |= bool(preds)

            cur_true, cur_score = [], []
            for g in gts:
                # matches iterate in pred insertion order; only the FIRST
                # match marks the pred visited, later ones demote the
                # lower-confidence score to an FP (benchmark semantics)
                found = False
                gt_slot = -1
                for m in g.matched:
                    if visited[m["pred_idx"]] or m["iou"] <= iou_th:
                        continue
                    if found:
                        hi = max(cur_score[gt_slot], m["conf"])
                        lo = min(cur_score[gt_slot], m["conf"])
                        cur_score[gt_slot] = hi
                        cur_true.append(0)
                        cur_score.append(lo)
                    else:
                        found = True
                        cur_true.append(1)
                        cur_score.append(m["conf"])
                        gt_slot = len(cur_score) - 1
                        visited[m["pred_idx"]] = True
                if not found:
                    hard_fn += 1

            for p in preds:
                if any(m["iou"] > iou_th for m in p.matched):
                    continue
                ignore = p.void_intersection
                for m in p.matched:
                    if m["gt_vert_count"] < self.min_region_size:
                        ignore += m["intersection"]
                if ignore / p.vert_count <= iou_th:
                    cur_true.append(0)
                    cur_score.append(p.confidence)

            y_true.extend(cur_true)
            y_score.extend(cur_score)

        if not has_gt:
            return np.nan, np.nan
        if not has_pred:
            return 0.0, 0.0

        y_true = np.asarray(y_true, np.float64)
        y_score = np.asarray(y_score, np.float64)
        order = np.argsort(y_score)
        y_true, y_score = y_true[order], y_score[order]
        if len(y_true) == 0:
            return 0.0, 0.0

        cum = np.cumsum(y_true)
        thresholds, first_idx = np.unique(y_score, return_index=True)
        n_pr = len(first_idx) + 1
        n_ex = len(y_score)
        n_true = cum[-1]
        precision = np.zeros(n_pr)
        recall = np.zeros(n_pr)
        cum_pad = np.append(cum, 0)
        for r, i in enumerate(first_idx):
            csum = cum_pad[i - 1]
            tp = n_true - csum
            fp = n_ex - i - tp
            fn = csum + hard_fn
            precision[r] = tp / (tp + fp)
            recall[r] = tp / (tp + fn) if (tp + fn) > 0 else 0.0
        rc0 = recall[0]
        precision[-1] = 1.0
        recall[-1] = 0.0
        rconv = np.concatenate([[recall[0]], recall, [0.0]])
        step = np.convolve(rconv, [-0.5, 0, 0.5], "valid")
        return float(np.dot(precision, step)), float(rc0)

    # ------------------------------------------------------------------ #

    def evaluate(self, pred_insts, sem_labels, inst_labels) -> dict:
        """pred_insts: per-scene lists of {label_id, conf, pred_mask};
        sem/inst_labels: per-scene arrays. Returns the averages dict
        (all_ap, all_ap_50%, all_ap_25%, per-class entries)."""
        scenes = []
        offset = 0
        for preds, sem, inst in zip(pred_insts, sem_labels, inst_labels):
            gts_c, preds_c, offset = self.assign_scene(preds, sem, inst, offset)
            scenes.append((gts_c, preds_c))
        return self._aggregate(scenes, offset)

    def _aggregate(self, scenes, offset) -> dict:
        n_cls, n_iou = len(self.class_labels), len(self.ious)
        ap = np.zeros((n_cls, n_iou))
        rc = np.zeros((n_cls, n_iou))
        for li, ln in enumerate(self.class_labels):
            for oi, th in enumerate(self.ious):
                ap[li, oi], rc[li, oi] = self._ap_single(scenes, ln, th, offset)

        import warnings

        o50 = np.isclose(self.ious, 0.5)
        o25 = np.isclose(self.ious, 0.25)
        main = ~o25
        with warnings.catch_warnings():
            # classes absent from the GT are all-nan by design
            warnings.filterwarnings("ignore", message="Mean of empty slice")
            out = dict(
                all_ap=float(np.nanmean(ap[:, main])),
                **{"all_ap_50%": float(np.nanmean(ap[:, o50])),
                   "all_ap_25%": float(np.nanmean(ap[:, o25])),
                   "all_rc": float(np.nanmean(rc[:, main])),
                   "all_rc_50%": float(np.nanmean(rc[:, o50])),
                   "all_rc_25%": float(np.nanmean(rc[:, o25]))},
                classes={},
            )
            for li, ln in enumerate(self.class_labels):
                out["classes"][ln] = dict(
                    ap=float(np.nanmean(ap[li, main])),
                    ap50=float(np.nanmean(ap[li, o50])),
                    ap25=float(np.nanmean(ap[li, o25])),
                )
        return out
