"""Pseudo-label quality metrics, numpy (copy of ``gapro_tpu/eval/pseudo.py``;
the reference's ``eval_ps_labels.py`` and ``eval_ap_ps_labels.py``).

* ``pseudo_label_miou_scene``: per GT instance, the largest IoU with a
  pseudo instance of the same class, for GT instances with a valid class.
* ``semantic_confusion``: semantic confusion-matrix counts.
* ``pseudo_label_ap``: the pseudo instances scored as predictions of
  confidence 1 by the ScanNet AP harness (``ScanNetEval``).
"""

from __future__ import annotations

import numpy as np

from ..utils.rle import rle_encode
from .instance_eval import ScanNetEval


def _instance_cls(sem, inst, n_inst):
    cls = np.full(n_inst, -1.0, np.float32)
    for i in range(n_inst):
        idx = np.nonzero(inst == i)[0]
        if len(idx):
            cls[i] = sem[idx[0]]
    return cls


def pseudo_label_miou_scene(semantic_label, instance_label, ps_semantic_label, ps_instance_label):
    """Max class-matched IoU per GT instance. Returns [n_valid_gt] float array."""
    sem = np.asarray(semantic_label)
    inst = np.asarray(instance_label)
    ps_sem = np.asarray(ps_semantic_label)
    ps_inst = np.asarray(ps_instance_label)

    n_inst = int(inst.max()) + 1 if inst.size else 0
    n_ps = int(ps_inst.max()) + 1 if ps_inst.size else 0
    if n_inst <= 0:
        return np.zeros(0, np.float32)

    gt_cls = _instance_cls(sem, inst, n_inst)
    if n_ps <= 0:
        return np.zeros((gt_cls >= 0).sum(), np.float32)
    ps_cls = _instance_cls(ps_sem, ps_inst, n_ps)

    gt_onehot = np.zeros((n_inst, len(inst)), np.float32)
    valid_gt = inst >= 0
    gt_onehot[inst[valid_gt], np.nonzero(valid_gt)[0]] = 1.0
    ps_onehot = np.zeros((n_ps, len(ps_inst)), np.float32)
    valid_ps = ps_inst >= 0
    ps_onehot[ps_inst[valid_ps], np.nonzero(valid_ps)[0]] = 1.0

    inter = gt_onehot @ ps_onehot.T
    a = gt_onehot.sum(1)[:, None]
    b = ps_onehot.sum(1)[None, :]
    ious = inter / (a + b - inter + 1e-4)
    ious *= (gt_cls[:, None] == ps_cls[None, :]).astype(np.float32)
    return ious.max(1)[gt_cls >= 0]


def semantic_confusion(semantic_label, ps_semantic_label, n_classes: int):
    """Confusion counts [n_classes, n_classes]; ignores labels < 0."""
    sem = np.asarray(semantic_label)
    ps = np.asarray(ps_semantic_label)
    valid = (sem >= 0) & (ps >= 0) & (sem < n_classes) & (ps < n_classes)
    conf = np.zeros((n_classes, n_classes), np.int64)
    np.add.at(conf, (sem[valid], ps[valid]), 1)
    return conf


def pseudo_labels_as_predictions(ps_sem, ps_inst, scan_id="scene"):
    """Pseudo labels -> benchmark-format prediction dicts of confidence 1:
    each pseudo instance becomes a prediction labeled by its class."""
    ps_sem = np.asarray(ps_sem)
    ps_inst = np.asarray(ps_inst)
    preds = []
    for uid in np.unique(ps_inst):
        if uid < 0:
            continue
        mask = ps_inst == uid
        cls = int(ps_sem[mask][0])
        if cls < 0 or cls >= 18:
            continue
        preds.append(dict(scan_id=scan_id, label_id=cls + 1, conf=1.0,
                          pred_mask=rle_encode(mask)))
    return preds


def pseudo_label_ap(scenes):
    """AP of pseudo labels against GT over (gt_sem_remapped, gt_inst,
    ps_sem, ps_inst) tuples. Returns the ScanNetEval averages dict."""
    preds, sems, insts = [], [], []
    for i, (gt_sem, gt_inst, ps_sem, ps_inst) in enumerate(scenes):
        preds.append(pseudo_labels_as_predictions(ps_sem, ps_inst, f"s{i:04d}"))
        sems.append(gt_sem)
        insts.append(gt_inst)
    return ScanNetEval().evaluate(preds, sems, insts)
