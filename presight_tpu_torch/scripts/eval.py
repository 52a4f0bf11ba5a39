"""`ns-eval` equivalent (presight_tpu/scripts/eval.py): load a run, render
its eval images, report PSNR, SSIM and LPIPS.

Usage:
  python -m presight_tpu_torch.scripts.eval <run_dir> [--max-images N] [--output-path metrics.json]

Runs on the CUDA card; ``main(argv, device=...)`` takes another device.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None, device=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("run_dir", type=Path)
    parser.add_argument("--max-images", type=int, default=-1)
    parser.add_argument("--output-path", type=Path, default=None)
    parser.add_argument("--no-lpips", action="store_true")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="devices to render on; the port runs on one")
    args = parser.parse_args(argv)

    from ..data.dataparser import make_camera_params
    from ..engine.evaluator import evaluate_images
    from ..engine.trainer import eval_setup

    _, trainer = eval_setup(args.run_dir / "config.yml", num_devices=args.num_devices,
                            device=device)
    try:
        # Eval split images (the train images when the split is empty, e.g.
        # train_split_fraction=1.0 as in the tile configs).
        items = trainer.eval_items or trainer.train_outputs.items
        cameras = make_camera_params(items, trainer.device)
        n = len(items) if args.max_images < 0 else min(args.max_images, len(items))
        metrics = evaluate_images(trainer.model, trainer.model_config, cameras, items,
                                  indices=range(n), with_lpips=not args.no_lpips)
    finally:
        trainer.close()
    print(json.dumps(metrics, indent=2))
    if args.output_path:
        args.output_path.write_text(json.dumps(metrics, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
