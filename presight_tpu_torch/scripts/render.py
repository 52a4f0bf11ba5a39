"""`ns-render` equivalent (presight_tpu/scripts/render.py): re-render
dataset cameras of a run to PNGs (RGB, depth and, with semantics, the DINO
feature PCA).

Usage:
  python -m presight_tpu_torch.scripts.render <run_dir> --output-dir renders/ \
      [--indices 0 1 2] [--downscale 2]

Runs on the CUDA card; ``main(argv, device=...)`` takes another device.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None, device=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("run_dir", type=Path)
    parser.add_argument("--output-dir", type=Path, required=True)
    parser.add_argument("--indices", type=int, nargs="*", default=[0])
    parser.add_argument("--downscale", type=float, default=1.0)
    parser.add_argument("--num-devices", type=int, default=None,
                        help="devices to render on; the port runs on one")
    args = parser.parse_args(argv)

    from ..data.cameras import CameraParams
    from ..engine.evaluator import ImageRenderer
    from ..engine.trainer import eval_setup
    from ..utils.colormaps import apply_feature_colormap
    from ..utils.png import write_png

    _, trainer = eval_setup(args.run_dir / "config.yml", num_devices=args.num_devices,
                            device=device)
    try:
        renderer = ImageRenderer(trainer.model_config)
        args.output_dir.mkdir(parents=True, exist_ok=True)
        cameras = trainer.cameras
        if args.downscale != 1.0:
            s = 1.0 / args.downscale
            cameras = CameraParams(c2w=cameras.c2w, fx=cameras.fx * s, fy=cameras.fy * s,
                                   cx=cameras.cx * s, cy=cameras.cy * s,
                                   video_ids=cameras.video_ids)
        prop_grid = trainer.model.make_prop_grid()
        dino_to_rgb = trainer.train_outputs.dino_to_rgb
        for i in args.indices:
            item = trainer.train_outputs.items[i]
            H, W = int(item.H / args.downscale), int(item.W / args.downscale)
            out = renderer.render(trainer.model, cameras, i, H, W, prop_grid=prop_grid)
            # Truncation to uint8, as the JAX package quantises.
            rgb = (np.clip(out["rgb"], 0, 1) * 255).astype(np.uint8)
            write_png(args.output_dir / f"render_{i:05d}_rgb.png", rgb)
            depth = out["expected_depth"]
            dnorm = (depth - depth.min()) / max(depth.max() - depth.min(), 1e-6)
            write_png(args.output_dir / f"render_{i:05d}_depth.png",
                      (dnorm * 255).astype(np.uint8))
            if "semantics" in out and dino_to_rgb is not None:
                pca = apply_feature_colormap(out["semantics"], dino_to_rgb)
                write_png(args.output_dir / f"render_{i:05d}_dino.png",
                          (pca * 255).astype(np.uint8))
            print(f"rendered camera {i} -> {args.output_dir}")
    finally:
        trainer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
