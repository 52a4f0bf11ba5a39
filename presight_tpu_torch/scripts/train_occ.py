"""Stage-3 occupancy CLI, the port of presight_tpu/scripts/train_occ.py:
train BEVDet-Occ, or evaluate a checkpoint with --eval-ckpt.

Training (train_occ.py:269-320 of the JAX package): each step is a
train-mode forward (BatchNorm on the batch's statistics), the masked
cross-entropy ``occ_loss``, the backward (S1b for the lift-splat on the
card), global-norm clipping written as optax's rule, AdamW over the
parameters, and the MEGVII EMA over the parameters and BatchNorm statistics
(``utils/ema.py``). It writes ``occ-step-<iters>.pkl`` with the JAX CLI's
tree, leaf names, shapes and dtypes (``{"params", "ema", "ema_updates",
"iters"}``, numpy trees), which either CLI's --eval-ckpt reads. The initial
weights come from ``init_weights`` with a ``torch.Generator`` seeded by
--seed: flax's init from ``jax.random.PRNGKey(seed)`` cannot be reproduced
without jax, so the two CLIs start from different weights of the same
distributions. Two defects of the JAX step are not copied: it discards
flax's updated ``batch_stats`` (and AdamW decays the statistics as if they
were parameters), and with ``stereo`` it fails to unpack the model's three
outputs; here the running statistics update and ``occ`` is the first
output.

Evaluation (--eval-ckpt): load an ``occ-step-*.pkl`` (written by either
CLI), forward every batch, take the argmax over the classes and report the
Occ3D per-class IoU and mIoU (``utils/occ_metrics.MetricMIoU``).

Usage:
  python -m presight_tpu_torch.scripts.train_occ --iters 50 --out outputs/occ \\
      [--config bevdet-occ-r50d-8x4-24e_wcamprior_randomdrop] [--data-dir npz_dir]
  python -m presight_tpu_torch.scripts.train_occ --eval-ckpt occ-step-000000050.pkl \\
      [--config ...] [--eval-params ema|raw] [--data-dir npz_dir]

Without --data-dir both use the toy batches of --seed (numpy RandomState,
the JAX CLI's arrays); an .npz sample holds imgs, sensor2ego, cam2imgs,
post_rots, post_trans, bda, voxel_semantics and optionally mask_camera and
prior_feats / prior_coords / prior_valid. A stereo model returns three
outputs; the occupancy logits are the first. Runs on the CUDA card;
``main(argv, device=...)`` takes another device. Not ported yet:
--infos / --prior-root (the stage-3 data pipeline, ROADMAP Queue 1 item
4(a)) and --bf16 (item 4(b)).
"""

from __future__ import annotations

import argparse
import dataclasses
import pickle
import time
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


def to_device(batch, device) -> dict:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}


def make_optimizer(model: torch.nn.Module, lr: float, weight_decay: float):
    """AdamW over the model's parameters (not its BatchNorm statistics).
    torch.optim.AdamW does optax.adamw's arithmetic (betas 0.9 and 0.999,
    eps 1e-8 added to the root of the bias-corrected second moment, and
    decoupled decay ``lr * weight_decay * p`` taken from the parameter
    before the step): the two differ only in rounding."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place on the gradients: all of them
    scaled by max_norm / ||g|| where the global norm ||g|| >= max_norm, else
    left as they are (clip_grad_norm_ would add 1e-6 to the norm). On the
    device: no host sync. Returns the norm."""
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def train_step(model, optimizer, ema, batch, grad_clip: float = 5.0, ema_decay: float = 0.9990):
    """One training step (train_occ.py:279-299 of the JAX package): the
    train-mode forward (``occ`` is the first output), ``occ_loss``, the
    backward (convolutions in IEEE f32, as the forward's), a zero gradient
    for a parameter the graph did not reach (as JAX's would be),
    global-norm clipping, AdamW, then the EMA. ``batch`` holds tensors on
    the model's device. Returns (the loss as a device tensor, the EMA state)."""
    from ..occupancy import occ_loss
    from ..utils.ema import ema_update
    from ..utils.precision import ieee_convolutions
    from ..utils.profiler import span

    with span("occ.train_step"):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        priors = {k: batch[k] for k in _PRIOR_INPUTS if k in batch}
        occ = model(*[batch[k] for k in _MODEL_INPUTS], **priors)[0]
        loss = occ_loss(occ, batch["voxel_semantics"], batch.get("mask_camera"))
        with ieee_convolutions():
            loss.backward()
        with span("occ.optimizer"):
            params = list(model.parameters())
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            clip_by_global_norm_(params, grad_clip)
            optimizer.step()
            return loss.detach(), ema_update(ema, model, ema_decay)


def checkpoint(model, ema, iters: int) -> dict:
    """The JAX CLI's pickle (train_occ.py:311-316): the variables and the
    EMA as flax numpy trees, the EMA's update count and the iterations."""
    from ..bridge import occ_state_to_flax

    return {"params": occ_state_to_flax(model), "ema": occ_state_to_flax(model, ema.params),
            "ema_updates": int(ema.updates), "iters": iters}


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

    if args.infos is not None or args.prior_root is not None:
        raise SystemExit("train_occ: --infos / --prior-root need data/stage3_pipeline.py, "
                         "which is not ported yet (ROADMAP Queue 1 item 4(a))")
    if args.bf16:
        raise SystemExit("train_occ: --bf16 (utils/deploy.py) is not ported yet "
                         "(ROADMAP Queue 1 item 4(b))")

    from ..bridge import occ_state_from_flax
    from ..models.layers import init_weights
    from ..occupancy import BEVDetOcc
    from ..utils.ema import ema_init
    from ..utils.occ_metrics import MetricMIoU

    dev = torch.device("cuda" if device is None else device)
    cfg = build_config(args)
    batches = (load_batches(args.data_dir) if args.data_dir
               else [toy_batch(args.seed + i, input_size=cfg.input_size, grid=cfg.grid_config)
                     for i in range(4)])
    with_priors = "prior_feats" in batches[0]
    model = BEVDetOcc(cfg, device=dev, with_prior_fusion=with_priors)

    if args.eval_ckpt is None:
        init_weights(model, torch.Generator().manual_seed(args.seed))
        optimizer = make_optimizer(model, args.lr, args.weight_decay)
        ema = ema_init(model, init_updates=args.ema_init_updates)
        on_device = [to_device(b, dev) for b in batches]
        args.out.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        loss = torch.tensor(float("nan"))
        for i in range(args.iters):
            loss, ema = train_step(model, optimizer, ema, on_device[i % len(on_device)],
                                   args.grad_clip, args.ema_decay)
            if i % 10 == 0 or i + 1 == args.iters:
                print(f"iter {i:5d} | loss={float(loss):.4f} | "
                      f"{(time.perf_counter() - t0):.1f}s", flush=True)
        path = args.out / f"occ-step-{args.iters:09d}.pkl"
        with open(path, "wb") as f:
            pickle.dump(checkpoint(model, ema, args.iters), f)
        print(f"saved {path} (final loss {float(loss):.4f})")
        return 0

    with open(args.eval_ckpt, "rb") as f:
        ckpt = pickle.load(f)
    occ_state_from_flax(ckpt["ema"] if args.eval_params == "ema" else ckpt["params"], model)
    metric = MetricMIoU(num_classes=cfg.num_classes,
                        use_image_mask=any("mask_camera" in b for b in batches))
    for b in batches:
        t = to_device(b, dev)
        with torch.no_grad():
            occ = model(*[t[k] for k in _MODEL_INPUTS],
                        **{k: t[k] for k in _PRIOR_INPUTS if k in t})[0]
        metric.add_batch(occ.argmax(dim=-1).cpu().numpy(), np.asarray(b["voxel_semantics"]),
                         mask_camera=np.asarray(b["mask_camera"]) if "mask_camera" in b else None)
    for c, v in enumerate(metric.per_class_iou()):
        print(f"class {c:2d} IoU {v:.4f}")
    print(f"mIoU (excl. free): {metric.miou():.4f} over {len(batches)} batches "
          f"({args.eval_params} weights)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
