"""Stage-3 occupancy CLI (presight_tpu/scripts/train_occ.py), its evaluation
branch: load an ``occ-step-*.pkl`` checkpoint that the JAX CLI wrote,
forward every batch, take the argmax over the classes and report the Occ3D
per-class IoU and mIoU (``utils/occ_metrics.MetricMIoU``).

Usage:
  python -m presight_tpu_torch.scripts.train_occ --eval-ckpt occ-step-000000050.pkl \\
      [--config bevdet-occ-r50d-8x4-24e_wcamprior_randomdrop] [--eval-params ema|raw] \\
      [--data-dir npz_dir]

Without --data-dir it evaluates the toy batches of --seed (numpy
RandomState, the JAX CLI's arrays); an .npz sample holds imgs, sensor2ego,
cam2imgs, post_rots, post_trans, bda, voxel_semantics and optionally
mask_camera and prior_feats / prior_coords / prior_valid. The checkpoint is
a pickle of numpy trees (``{"params", "ema", "ema_updates", "iters"}``), read
without jax. A stereo model returns three outputs; the occupancy logits are
the first. Runs on the CUDA card; ``main(argv, device=...)`` takes another
device. Not served yet, each with its ROADMAP Queue 1 item 3 entry:
training (no --eval-ckpt), --infos / --prior-root (the stage-3 data
pipeline) and --bf16.
"""

from __future__ import annotations

import argparse
import dataclasses
import pickle
from pathlib import Path

import numpy as np
import torch

GRID = {
    "x": (-8.0, 8.0, 0.8),
    "y": (-8.0, 8.0, 0.8),
    "z": (-1.0, 3.0, 0.5),
    "depth": (1.0, 9.0, 0.5),
}
INPUT_SIZE = (32, 64)


def toy_batch(seed: int, B: int = 1, N: int = 2, input_size=INPUT_SIZE, grid=GRID):
    """The JAX CLI's toy batch of ``seed`` as numpy arrays (train_occ.py:38-62)."""
    rng = np.random.RandomState(seed)
    s2e = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    s2e[..., :3, 3] = rng.randn(B, N, 3) * 0.5
    intrins = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    intrins[..., 0, 0] = intrins[..., 1, 1] = 40.0 / 64 * input_size[1]
    intrins[..., 0, 2] = input_size[1] / 2.0
    intrins[..., 1, 2] = input_size[0] / 2.0
    post_rots = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    post_trans = np.zeros((B, N, 3), np.float32)
    bda = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    nvox = [round((grid[k][1] - grid[k][0]) / grid[k][2]) for k in "xyz"]
    return dict(
        imgs=rng.rand(B, N, 3, *input_size).astype(np.float32),
        sensor2ego=s2e, cam2imgs=intrins, post_rots=post_rots, post_trans=post_trans, bda=bda,
        voxel_semantics=rng.randint(0, 18, (B, nvox[0], nvox[1], nvox[2])),
    )


def load_batches(data_dir: Path):
    batches = []
    for f in sorted(data_dir.glob("*.npz")):
        with np.load(f) as d:
            batches.append({k: d[k] for k in d.files})
    if not batches:
        raise SystemExit(f"no .npz samples under {data_dir}")
    return batches


def build_config(args):
    from ..configs.stage3_configs import occ_configs
    from ..occupancy import BEVDetOccConfig

    if args.config is not None:
        cfg = occ_configs[args.config]()
        if args.temporal and not cfg.temporal:
            cfg = dataclasses.replace(cfg, temporal=True)
        return cfg
    return BEVDetOccConfig(
        grid_config=GRID, input_size=INPUT_SIZE, downsample=16, view_out_channels=16,
        img_widths=(8, 16, 16, 32), neck_channels=32, bev_widths=(16, 32), bev_out_channels=16,
        occ_out_dim=16, num_classes=18, temporal=args.temporal, backbone=args.backbone,
        resnet_base_width=args.resnet_base_width, bev_neck=args.bev_neck)


_MODEL_INPUTS = ("imgs", "sensor2ego", "cam2imgs", "post_rots", "post_trans", "bda")
_PRIOR_INPUTS = ("prior_feats", "prior_coords", "prior_valid")


def main(argv=None, device=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight-decay", type=float, default=1e-2)
    parser.add_argument("--grad-clip", type=float, default=5.0)
    parser.add_argument("--ema-decay", type=float, default=0.9990)
    parser.add_argument("--ema-init-updates", type=int, default=0)
    parser.add_argument("--data-dir", type=Path, default=None)
    parser.add_argument("--infos", type=Path, default=None)
    parser.add_argument("--prior-root", type=Path, default=None)
    parser.add_argument("--prior-city-parts", default=None)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--out", type=Path, default=Path("outputs/occ"))
    parser.add_argument("--temporal", action="store_true")
    parser.add_argument("--config", default=None,
                        help="named config from configs/stage3_configs.py; overrides the "
                             "width flags below")
    parser.add_argument("--backbone", choices=["simple", "resnet"], default="simple")
    parser.add_argument("--resnet-base-width", type=int, default=8)
    parser.add_argument("--bev-neck", choices=["simple", "lssfpn3d"], default="simple")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval-ckpt", type=Path, default=None,
                        help="evaluate a saved occ-step-*.pkl: per-class IoU + mIoU")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--eval-params", choices=["ema", "raw"], default="ema",
                        help="which weights to evaluate; the reference evaluates the EMA")
    args = parser.parse_args(argv)

    if args.eval_ckpt is None:
        raise SystemExit("train_occ: training is not ported yet (ROADMAP Queue 1 item 3: "
                         "occ_loss, EMA, AdamW with clipping, BN train-mode statistics); "
                         "pass --eval-ckpt to evaluate a checkpoint")
    if args.infos is not None or args.prior_root is not None:
        raise SystemExit("train_occ: --infos / --prior-root need data/stage3_pipeline.py, "
                         "which is not ported yet (ROADMAP Queue 1 item 3)")
    if args.bf16:
        raise SystemExit("train_occ: --bf16 (utils/deploy.py) is not ported yet "
                         "(ROADMAP Queue 1 item 3)")

    from ..bridge import occ_state_from_flax
    from ..occupancy import BEVDetOcc
    from ..utils.occ_metrics import MetricMIoU

    dev = torch.device("cuda" if device is None else device)
    cfg = build_config(args)
    batches = (load_batches(args.data_dir) if args.data_dir
               else [toy_batch(args.seed + i, input_size=cfg.input_size, grid=cfg.grid_config)
                     for i in range(4)])
    with_priors = "prior_feats" in batches[0]
    model = BEVDetOcc(cfg, device=dev, with_prior_fusion=with_priors)
    with open(args.eval_ckpt, "rb") as f:
        ckpt = pickle.load(f)
    occ_state_from_flax(ckpt["ema"] if args.eval_params == "ema" else ckpt["params"], model)

    metric = MetricMIoU(num_classes=cfg.num_classes,
                        use_image_mask=any("mask_camera" in b for b in batches))
    for b in batches:
        inputs = [torch.as_tensor(np.asarray(b[k]), device=dev) for k in _MODEL_INPUTS]
        priors = ({k: torch.as_tensor(np.asarray(b[k]), device=dev) for k in _PRIOR_INPUTS}
                  if with_priors else {})
        with torch.no_grad():
            occ = model(*inputs, **priors)[0]
        metric.add_batch(occ.argmax(dim=-1).cpu().numpy(), np.asarray(b["voxel_semantics"]),
                         mask_camera=np.asarray(b["mask_camera"]) if "mask_camera" in b else None)
    for c, v in enumerate(metric.per_class_iou()):
        print(f"class {c:2d} IoU {v:.4f}")
    print(f"mIoU (excl. free): {metric.miou():.4f} over {len(batches)} batches "
          f"({args.eval_params} weights)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
