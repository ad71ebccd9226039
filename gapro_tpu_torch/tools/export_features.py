"""Export per-point mask-tower features for self-training: the port of
``tools/export_features.py``.

    python -m gapro_tpu_torch.tools.export_features configs/isbnet_scannetv2.yaml \\
        runs/isbnet/best --save_dir dataset/scannetv2/pretrain_maskfeats
    python -m gapro_tpu_torch.tools.export_features configs/tiny_synthetic.yaml \\
        --synthetic 2 --device cpu

For each scene of the config's validation split (ISBNet only, as in the
JAX tool) the model runs its trunk in eval mode, then the mask tower on the
voxel features (``run_mask_tower``, as the reference runs it before
superpoint pooling), and each point takes its voxel's row through
``point2voxel``. Each scan's ``[n_points, mask_dim_out]`` float32 array is
written with ``torch.save`` as ``<save_dir>/<scan>.pth``: the files that
``gen_ps --use_deepfeat`` reads in place of xyz and rgb as the GP's inputs,
which closes GaPro's self-training loop (``docs/TRAIN.md``).
"""

from __future__ import annotations

import argparse
import logging
import os
import os.path as osp
from typing import Optional

import numpy as np
import torch

from ..data.dataset import build_dataloader
from ..device import resolve_device
from ..train.checkpoint import load_model_weights
from ..train.config import load_config
from .train import build_dataset, build_model, make_prepare


@torch.no_grad()
def export_features(cfg, checkpoint: Optional[str] = None, save_dir: str = "maskfeats", *,
                    device=None, synthetic: int = 0) -> list:
    """Write each scene's per-point mask-tower features under ``save_dir``
    on ``device`` (``cuda`` unless named), the weights from ``checkpoint``
    (else drawn from seed 0). Returns ``(scan_id, path, shape)`` for each
    scene written."""
    if cfg.model.type != "isbnet":
        raise ValueError("feature export is an ISBNet path")
    log = logging.getLogger("export")
    dev = resolve_device(device)
    model, _ = build_model(cfg, dev)
    if checkpoint:
        load_model_weights(checkpoint, model)
        log.info("loaded %s", checkpoint)
    model.eval()
    dataset = build_dataset(cfg, synthetic, training=False)
    prepare = make_prepare(cfg, dev)
    os.makedirs(save_dir, exist_ok=True)
    written = []
    for lb in build_dataloader(dataset, 1, training=False, drop_last=False):
        scan_id, n_points = lb.scan_ids[0], len(lb.scenes[0]["xyz"])
        prepared = prepare(lb.points, 1)
        out, _ = model.trunk(prepared.batch)
        vf = model.run_mask_tower(out["voxel_feats"], prepared.batch.valid)  # [V, M]
        p2v = prepared.point2voxel[:n_points].long().clamp(min=0)
        feats = vf[p2v].cpu().numpy().astype(np.float32)
        path = osp.join(save_dir, scan_id + ".pth")
        torch.save(feats, path)
        log.info("%s -> %s (%s)", scan_id, path, feats.shape)
        written.append((scan_id, path, feats.shape))
    return written


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("gapro_tpu_torch export_features")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--save_dir", default="maskfeats")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    export_features(load_config(args.config), args.checkpoint, args.save_dir,
                    device=args.device, synthetic=args.synthetic)


if __name__ == "__main__":
    main()
