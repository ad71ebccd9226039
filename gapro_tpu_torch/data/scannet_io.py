"""ScanNet v2 files and label conventions (numpy copy of the part of
``gapro_tpu/data/scannet_io.py`` the port needs).

The reference's preprocessed layout:

* ``<root>/{train,val}/<scan>_inst_nostuff.pth`` -> (xyz, rgb, sem, inst);
* ``<root>/superpoints/<scan>.pth`` -> superpoint ids;
* ``<root>/scans_transform/<scan>/<scan>.txt`` -> the ``axisAlignment`` line;
* ``<root>/scannet_planes/<scan>.json`` -> wall quads;
* ``<root>/<label_type>/<scan>.pth`` -> GP pseudo labels (sem, inst, prob,
  mu, var), mu and var per superpoint.

The files are torch pickles; ``torch.load`` reads them on the CPU and
everything is handed on as numpy.
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
import torch


def _torch_load(path):
    # the files hold numpy arrays and tuples, which the weights-only
    # unpickler refuses
    return torch.load(path, map_location="cpu", weights_only=False)


def load_scene(path):
    """``<scan>_inst_nostuff.pth`` -> (xyz, rgb, sem, inst) numpy arrays."""
    xyz, rgb, sem, inst = _torch_load(path)
    return (np.asarray(xyz, np.float32), np.asarray(rgb, np.float32),
            np.asarray(sem).astype(np.int64), np.asarray(inst).astype(np.int64))


def load_superpoints(path):
    return np.asarray(_torch_load(path)).astype(np.int64)


def load_pseudo_labels(path):
    """A pseudo-label file -> (sem, inst, prob, mu, var)."""
    sem, inst, prob, mu, var = _torch_load(path)
    return (np.asarray(sem).astype(np.int64), np.asarray(inst).astype(np.int64),
            np.asarray(prob, np.float32), np.asarray(mu, np.float32),
            np.asarray(var, np.float32))


def remap_semantic_for_training(sem, label_shift: int = 2, background_class: int = 18):
    """Raw ScanNet semantics -> training ids: raw 2..19 foreground -> 0..17,
    raw 0/1 (wall/floor) -> ``background_class``, -100 stays ignore."""
    sem = np.asarray(sem).astype(np.int64)
    out = np.full_like(sem, -100)
    out[(sem >= 0) & (sem < label_shift)] = background_class
    fg = sem >= label_shift
    out[fg] = sem[fg] - label_shift
    return out


def load_axis_align_matrix(meta_file):
    """The ``axisAlignment`` row-major 4x4 of a scans_transform txt (identity
    when the file is absent)."""
    if not osp.exists(meta_file):
        return np.eye(4)
    with open(meta_file) as f:
        for line in f:
            if "axisAlignment" in line:
                vals = [float(x) for x in line.rstrip().strip("axisAlignment = ").split(" ")]
                return np.array(vals).reshape(4, 4)
    return np.eye(4)


def apply_axis_align(xyz, matrix):
    pts = np.concatenate([xyz, np.ones((len(xyz), 1))], axis=1)
    return (pts @ np.asarray(matrix).T)[:, :3].astype(np.float32)


def load_plane_quads(path):
    """A scannet_planes json dict, or None when the file is absent."""
    if not osp.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_pseudo_labels(path, sem, inst, prob, mu, var):
    """Save the 5-tuple the reference saves: sem, inst, prob per point; mu,
    var per superpoint."""
    os.makedirs(osp.dirname(path), exist_ok=True)
    torch.save((np.asarray(sem, np.int32), np.asarray(inst, np.int32),
                np.asarray(prob, np.float32), np.asarray(mu, np.float32),
                np.asarray(var, np.float32)), path)
