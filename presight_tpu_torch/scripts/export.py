"""`ns-export` equivalent (presight_tpu/scripts/export.py): artifacts of a
trained run.

  * ``pointcloud``: render random training rays in chunks, backproject the
    expected depth into coloured world points in metric units (divided by
    pose_scale_factor), keep those in the depth band and the optional
    bounding box, drop statistical outliers with a scipy cKDTree (the mean
    distance to the ``--nb-points`` nearest neighbours above mean +
    ``--std-ratio`` std), write a PLY. The rays are the JAX package's:
    camera, row and column drawn from ``np.random.RandomState(0)`` in its
    order.
  * ``cameras``: the train cameras' metric c2w and intrinsics as JSON.

The mesh subcommands (tsdf / poisson / marching-cubes) are generic
nerfstudio tooling that PreSight never invokes and that needs open3d: the
CLI reports them as out of scope, as the JAX package does.

Usage:
  python -m presight_tpu_torch.scripts.export pointcloud <run_dir> --output-dir exports/
  python -m presight_tpu_torch.scripts.export cameras <run_dir> --output-dir exports/

Runs on the CUDA card; ``main(argv, device=...)`` takes another device.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def _export_pointcloud(args, device) -> int:
    import torch
    from scipy.spatial import cKDTree

    from ..data.cameras import generate_rays
    from ..engine.evaluator import ImageRenderer
    from ..engine.trainer import eval_setup
    from ..prior.extraction import write_ply

    _, trainer = eval_setup(args.run_dir / "config.yml", device=device)
    try:
        psf = trainer.train_outputs.pose_scale_factor
        renderer = ImageRenderer(trainer.model_config)
        model = trainer.model
        prop_grid = model.make_prop_grid()
        items = trainer.train_outputs.items
        cameras = trainer.cameras
        # Camera indices drawn below index trainer.cameras directly, which is
        # only valid because the dataparser renumbers train items 0..N-1 to
        # match the train camera table: make that coupling loud.
        n_cams = cameras.num_cameras
        assert len(items) == n_cams and all(
            it.image_index == i for i, it in enumerate(items)
        ), (
            f"train items ({len(items)}) must be renumbered 0..N-1 against the "
            f"train camera table ({n_cams}); the dataparser split contract "
            "changed under this exporter"
        )
        rng = np.random.RandomState(0)
        chunk = renderer.chunk
        pts, cols = [], []
        n_have = 0
        max_batches = max(64, 20 * (args.num_points // chunk + 1))
        n_batches = 0
        while n_have < args.num_points:
            n_batches += 1
            if n_batches > max_batches:
                print(f"warning: stopping after {max_batches} ray batches with "
                      f"only {n_have}/{args.num_points} points — the depth band "
                      f"/ bounding box rejects almost every ray")
                break
            cam = rng.randint(0, len(items), chunk)
            row = rng.randint(0, 2**31 - 1, chunk)
            col = rng.randint(0, 2**31 - 1, chunk)
            H = np.asarray([items[c].H for c in cam])
            W = np.asarray([items[c].W for c in cam])
            ray_index = np.stack([cam, row % H, col % W], axis=-1).astype(np.int32)
            out = renderer.render_rays(model, cameras, ray_index, prop_grid)
            depth = out[args.depth_output_name].reshape(-1) / psf
            rgb = out[args.rgb_output_name]
            bundle = generate_rays(cameras, torch.from_numpy(ray_index).to(cameras.c2w.device))
            origins = bundle.origins.cpu().numpy() / psf
            dirs = bundle.directions.cpu().numpy()
            world = origins + dirs * depth[:, None]
            keep = (depth > args.min_depth) & (depth < args.max_depth)
            if args.use_bounding_box:
                lo = np.asarray(args.bounding_box_min)
                hi = np.asarray(args.bounding_box_max)
                keep &= np.all((world >= lo) & (world <= hi), axis=-1)
            pts.append(world[keep].astype(np.float32))
            cols.append(np.clip(rgb[keep], 0, 1).astype(np.float32))
            n_have += int(keep.sum())
    finally:
        trainer.close()
    points = np.concatenate(pts)[: args.num_points]
    colors = np.concatenate(cols)[: args.num_points]

    if args.remove_outliers and len(points) > args.nb_points:
        tree = cKDTree(points)
        d, _ = tree.query(points, k=args.nb_points + 1)
        mean_d = d[:, 1:].mean(axis=1)
        thresh = mean_d.mean() + args.std_ratio * mean_d.std()
        inlier = mean_d <= thresh
        points, colors = points[inlier], colors[inlier]

    args.output_dir.mkdir(parents=True, exist_ok=True)
    out_path = args.output_dir / "point_cloud.ply"
    write_ply(points, colors, out_path)
    print(f"wrote {len(points)} points to {out_path}")
    return 0


def _export_cameras(args, device) -> int:
    from ..engine.trainer import eval_setup

    _, trainer = eval_setup(args.run_dir / "config.yml", device=device)
    trainer.close()
    psf = trainer.train_outputs.pose_scale_factor
    cameras = trainer.cameras.to("cpu")
    c2w = cameras.c2w.numpy().copy()
    c2w[:, :3, 3] /= psf  # back to metric translation
    frames = [
        dict(
            camera_to_world=c2w[i].tolist(),
            fx=float(cameras.fx[i]), fy=float(cameras.fy[i]),
            cx=float(cameras.cx[i]), cy=float(cameras.cy[i]),
            video_id=int(cameras.video_ids[i]),
        )
        for i in range(c2w.shape[0])
    ]
    args.output_dir.mkdir(parents=True, exist_ok=True)
    out_path = args.output_dir / "camera_poses.json"
    out_path.write_text(json.dumps({"frames": frames}, indent=1))
    print(f"wrote {len(frames)} camera poses to {out_path}")
    return 0


def main(argv=None, device=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    pc = sub.add_parser("pointcloud", help="colored point cloud PLY")
    pc.add_argument("run_dir", type=Path)
    pc.add_argument("--output-dir", type=Path, required=True)
    pc.add_argument("--num-points", type=int, default=1_000_000)
    pc.add_argument("--min-depth", type=float, default=0.5)
    pc.add_argument("--max-depth", type=float, default=50.0)
    pc.add_argument("--rgb-output-name", default="rgb")
    pc.add_argument("--depth-output-name", default="expected_depth")
    pc.add_argument("--use-bounding-box", action="store_true")
    pc.add_argument("--bounding-box-min", type=float, nargs=3,
                    default=(-1e9, -1e9, -1e9))
    pc.add_argument("--bounding-box-max", type=float, nargs=3,
                    default=(1e9, 1e9, 1e9))
    pc.add_argument("--remove-outliers", action="store_true", default=True)
    pc.add_argument("--no-remove-outliers", dest="remove_outliers",
                    action="store_false")
    pc.add_argument("--nb-points", type=int, default=20)
    pc.add_argument("--std-ratio", type=float, default=10.0)
    pc.set_defaults(fn=_export_pointcloud)

    cams = sub.add_parser("cameras", help="camera poses JSON")
    cams.add_argument("run_dir", type=Path)
    cams.add_argument("--output-dir", type=Path, required=True)
    cams.set_defaults(fn=_export_cameras)

    for name in ("tsdf", "poisson", "marching-cubes"):
        mesh = sub.add_parser(
            name, help="not implemented (generic nerfstudio mesh tooling, "
                       "off the PreSight path; needs open3d)")
        mesh.set_defaults(fn=None, mesh_name=name)

    args = parser.parse_args(argv)
    if args.fn is None:
        parser.error(
            f"'{args.mesh_name}' export is generic nerfstudio mesh tooling "
            "that PreSight never invokes and it depends on open3d; use "
            "'pointcloud' or ns-extract-priors instead.")
    return args.fn(args, device)


if __name__ == "__main__":
    raise SystemExit(main())
