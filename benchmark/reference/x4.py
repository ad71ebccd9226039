"""The reference's x4 request on an S3DIS room, plainly: the room's points
sorted stably by x and dealt round-robin into 4 interleaved pieces, the
pieces served as the 4 items of one batch by ISBNet's
``forward_inference(x4_split=True)`` and ``get_instances`` in the pieces'
point order, and each mask decoded, put back into the room's point order
through the inverse permutation and encoded again on the host. Written
from the x4 split's description (``S3DISDataset.split_pieces``, the test
CLI's ``serve_room``), not copied from the port."""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .models.inference import TestConfig, get_instances
from .utils.rle import rle_decode, rle_encode

PIECES = 4


def split_room(scene: dict, pieces: int = PIECES):
    """(the pieces, each a dict of the room's per-point fields, their
    superpoint ids in the batch's order, the room's index of each point of
    the batch)."""
    n = len(scene["xyz"])
    order = np.argsort(scene["xyz"][:, 0], kind="stable")
    idx = [order[p::pieces] for p in range(pieces)]
    out = [{k: (v[i] if isinstance(v, np.ndarray) and len(v) == n else v)
            for k, v in scene.items()} for i in idx]
    perm = np.concatenate(idx)
    return out, np.asarray(scene["spp"])[perm], perm


def to_room_order(records: list, perm) -> list:
    """The records with each mask in the room's point order: the batch's
    point ``j`` is the room's point ``perm[j]``."""
    out = []
    for r in records:
        mask = np.zeros(len(perm), bool)
        mask[perm] = rle_decode(r["pred_mask"])
        out.append(dict(r, pred_mask=rle_encode(mask)))
    return out


@torch.no_grad()
def request(config: dict, model, room: dict, scan_id: str, device) -> list:
    """One room's instance records, in the room's point order."""
    scene = build.test_scene(config, dict(room))
    pieces, spp, perm = split_room(scene)
    prepared = build.prepare(config, build.batch(config, pieces), PIECES, device)
    model.eval()
    out = model.forward_inference(prepared.batch, x4_split=True)
    records = get_instances(scan_id, out, prepared.batch, spp, prepared.point2voxel, len(perm),
                            TestConfig.from_dict(config.get("test", {})))
    return to_room_order(records, perm)
