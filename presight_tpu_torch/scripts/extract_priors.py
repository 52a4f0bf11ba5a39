"""Prior-extraction CLI (presight_tpu/scripts/extract_priors.py): a run
directory -> eval_setup -> extract_voxels -> extracted_priors.pkl and
priors_for_vis.ply.

Usage:
  python -m presight_tpu_torch.scripts.extract_priors <run_dir> \
      [--downscale 5] [--interval 8] [--output-dir DIR] \
      [--voxel-size 0.4] [--depth-type depth|expected_depth]

Runs on the CUDA card; ``main(argv, device=...)`` takes another device.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None, device=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("run_dir", type=Path, help="training run dir (contains config.yml)")
    parser.add_argument("--output-dir", type=Path, default=None)
    parser.add_argument("--downscale", type=float, default=5.0,
                        help="camera resolution downscale divisor")
    parser.add_argument("--interval", type=int, default=8, help="frame interval")
    parser.add_argument("--voxel-size", type=float, default=0.4)
    parser.add_argument("--max-depth", type=float, default=50.0)
    parser.add_argument("--min-depth", type=float, default=0.5)
    parser.add_argument("--hit-thr-ratio", type=float, default=0.2)
    parser.add_argument("--density-threshold", type=float, default=1.0,
                        help="keep hit points with mean density above this "
                        "(reference extract_priors.py:157 fixes it at 1.0)")
    parser.add_argument("--depth-type", default="depth",
                        choices=["depth", "expected_depth"])
    parser.add_argument("--no-seg-mask", action="store_true")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="devices to extract on; the port runs on one")
    args = parser.parse_args(argv)

    from ..engine.trainer import eval_setup
    from ..prior.extraction import extract_voxels

    _, trainer = eval_setup(args.run_dir / "config.yml", num_devices=args.num_devices,
                            device=device)
    out_dir = args.output_dir or args.run_dir
    try:
        outputs = trainer.train_outputs
        extract_voxels(
            trainer.model, outputs.items, trainer.cameras,
            pose_scale_factor=outputs.pose_scale_factor,
            origin=outputs.pose_transformation,
            dino_to_rgb=outputs.dino_to_rgb,
            output_dir=out_dir,
            frame_interval=args.interval,
            camera_scaling_factor=1.0 / args.downscale,
            voxel_size=args.voxel_size,
            max_depth=args.max_depth,
            min_depth=args.min_depth,
            hit_thr_ratio=args.hit_thr_ratio,
            depth_type=args.depth_type,
            use_segmentation_mask=not args.no_seg_mask,
            density_threshold=args.density_threshold,
        )
    finally:
        trainer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
