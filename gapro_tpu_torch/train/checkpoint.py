"""Checkpoints with the reference's retention (``gapro_tpu/train/checkpoint.py``).

* ``epoch_<e>`` is written every epoch and ``latest`` links to it; the
  previous epoch's file is removed unless ``is_keep_epoch`` (a power of two
  or a multiple of ``save_freq``; the trainer validates on the same
  epochs);
* ``best`` is written when the validation metric improves;
* loading against a target keeps the target's value for every key that is
  missing from the file or has another shape (backbone pre-training ->
  full model, fine-tuning with frozen modules).

A checkpoint is one ``torch.save`` of a dict: ``model`` (the
``state_dict``, BatchNorm statistics included), ``optimizer`` (its
``state_dict``), ``step`` and ``epoch``.
"""

from __future__ import annotations

import logging
import os
import os.path as osp

import torch


def is_keep_epoch(epoch: int, save_freq: int) -> bool:
    return epoch % save_freq == 0 or (epoch & (epoch - 1)) == 0


def _replace(path: str) -> None:
    if osp.islink(path) or osp.exists(path):
        os.unlink(path)


def save_checkpoint(work_dir: str, state: dict, epoch: int, save_freq: int = 16,
                    best: bool = False) -> str:
    """Write ``state`` as ``epoch_<epoch>``, point ``latest`` at it, write
    ``best`` too if ``best``, and prune the previous epoch. Returns the path."""
    os.makedirs(work_dir, exist_ok=True)
    name = f"epoch_{epoch:05d}"
    path = osp.join(work_dir, name)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)  # a reader never sees half a file
    latest = osp.join(work_dir, "latest")
    _replace(latest)
    os.symlink(name, latest)
    if best:
        torch.save(state, tmp)
        os.replace(tmp, osp.join(work_dir, "best"))
    prev = epoch - 1
    prev_path = osp.join(work_dir, f"epoch_{prev:05d}")
    if prev > 0 and not is_keep_epoch(prev, save_freq) and osp.exists(prev_path):
        os.unlink(prev_path)
    return path


def load_checkpoint(path: str) -> dict:
    """The dict a ``save_checkpoint`` wrote, its tensors on the CPU."""
    # the file holds the optimizer's state and plain numbers beside tensors,
    # all written by save_checkpoint
    return torch.load(osp.realpath(path), map_location="cpu", weights_only=False)


def merge_state_dict(target: dict, loaded: dict) -> dict:
    """``target`` with every entry of ``loaded`` whose key and shape match;
    the target's value stays for the rest."""
    merged, skipped = {}, []
    for key, tval in target.items():
        lval = loaded.get(key)
        if lval is not None and tuple(lval.shape) == tuple(tval.shape):
            merged[key] = lval
        else:
            merged[key] = tval
            skipped.append(key)
    if skipped:
        logging.getLogger(__name__).info(
            "load_checkpoint: kept %d target entries (missing/mismatched): %s",
            len(skipped), ", ".join(skipped[:8]))
    return merged


def load_model_weights(path: str, model: torch.nn.Module) -> None:
    """Load a checkpoint's model weights into ``model``, shape-checked
    (``merge_state_dict``)."""
    sd = model.state_dict()
    merged = merge_state_dict(sd, load_checkpoint(path)["model"])
    model.load_state_dict({k: v.to(sd[k].device) for k, v in merged.items()})
