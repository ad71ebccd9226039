"""Point-wise semantic and box-offset evaluation (numpy copy of
``gapro_tpu/eval/point_wise_eval.py``), host side: the confusion matrix's
mIoU, the overall semantic accuracy, and the mean absolute error of the
predicted box-corner offsets over the instance points. It validates the
backbone pre-training stage (``semantic_only``).
"""

from __future__ import annotations

import numpy as np


class PointWiseEval:
    def __init__(self, num_classes: int = 20, ignore_label: int = -100):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.conf = np.zeros((num_classes, num_classes), np.int64)
        self._correct = 0
        self._total = 0
        self._mae_sum = 0.0
        self._mae_count = 0

    def update(self, pred_sem, pred_corners_offset, gt_sem, gt_corners_offset, gt_instance):
        pred_sem = np.asarray(pred_sem)
        gt_sem = np.asarray(gt_sem)
        keep = gt_sem != self.ignore_label
        p, g = pred_sem[keep], gt_sem[keep]
        self._correct += int((p == g).sum())
        self._total += int(keep.sum())
        flat = p + self.num_classes * g
        self.conf += np.bincount(flat, minlength=self.num_classes**2).reshape(
            self.num_classes, self.num_classes
        )

        inst_keep = np.asarray(gt_instance) != self.ignore_label
        if pred_corners_offset is not None and inst_keep.any():
            d = np.abs(
                np.asarray(pred_corners_offset)[inst_keep]
                - np.asarray(gt_corners_offset)[inst_keep]
            )
            self._mae_sum += float(d.sum())
            self._mae_count += int(inst_keep.sum())

    def get_eval(self, logger=None):
        tp = np.diag(self.conf).astype(np.float64)
        fp = self.conf.sum(0) - tp
        fn = self.conf.sum(1) - tp
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = tp / (tp + fp + fn) * 100
        miou = float(np.nanmean(iou))
        acc = float(self._correct / max(self._total, 1) * 100)
        mae = float(self._mae_sum / max(self._mae_count, 1))
        if logger is not None:
            logger.info(
                "Class-wise mIoU: " + " ".join(f"{x:.1f}" for x in iou)
            )
            logger.info(f"mIoU: {miou:.1f}  Acc: {acc:.1f}  Offset MAE: {mae:.3f}")
        return miou, acc, mae
