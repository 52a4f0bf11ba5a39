#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (presight_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the result lines are printed):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from presight_tpu_torch/csrc and time the build;
  3. check each kernel (K1-K4) against its plain PyTorch version on the card
     at the main path's shapes, with the stated tolerances, and time both
     with CUDA events (median of several launches);
  4. serve: initialise boston-seaport-camera-dino-c0-tpu at full width from
     a seed, build the cached proposal grid, render one 450x800 camera with
     ImageRenderer (11 chunks of 32768 rays) and extract priors from one
     6-camera frame at downscale 5; check finite outputs, the pickle schema,
     and that every kernel was launched on this path;
  5. hold the kernel path against the plain path (the same model on the
     CPU): the full-width cached grid, and a small render with each
     device's own grid (median depths may differ only at threshold ties).
The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.
Writes the prior pickle under outputs/chip_smoke/.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

SEED = 0
NUM_CAMERAS, NUM_VIDEOS = 1536, 12  # init_model's embedding sizes, as bench.py:191
OUT_DIR = Path(__file__).resolve().parent / "outputs" / "chip_smoke"

KERNEL_INFO = {
    "hash_encode_fwd": ("presight_tpu_torch/csrc/hash_encode.cu",
                        "presight_tpu/ops/hash_encoding.py:343"),
    "mlp_blocks_fwd": ("presight_tpu_torch/csrc/mlp_blocks.cu",
                       "presight_tpu/ops/mlp.py:184"),
    "volume_render_fwd": ("presight_tpu_torch/csrc/volume_render.cu",
                          "presight_tpu/ops/rays.py:68"),
    "prop_grid_density_fwd": ("presight_tpu_torch/csrc/prop_grid.cu",
                              "presight_tpu/fields/prop_field.py:160"),
}


def time_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of fn() on the current stream, by CUDA events."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Checker:
    """Collects per-kernel errors and times; a failure is recorded and
    reported, and makes the run fail at the end of the phase."""

    def __init__(self):
        self.errors = {name: 0.0 for name in KERNEL_INFO}
        self.times = {}
        self.failures = []

    def close(self, kernel, case, got, want, atol, rtol):
        got, want = got.float(), want.float()
        err = (got - want).abs()
        max_abs = float(err.max()) if err.numel() else 0.0
        bad = int((err > atol + rtol * want.abs()).sum())
        finite = bool(torch.isfinite(got).all())
        self.errors[kernel] = max(self.errors[kernel], max_abs)
        status = "ok" if bad == 0 and finite else "FAIL"
        print(f"  {kernel} {case}: max_abs_err={max_abs:.3e} "
              f"max_rel_err={float((err / want.abs().clamp_min(1e-30)).max()):.3e} "
              f"tol=atol {atol:g} + rtol {rtol:g} -> {status}")
        if status != "ok":
            self.failures.append(f"{kernel} {case}: {bad} elements out of tolerance, "
                                 f"finite={finite}")


def median_depth_check(chk, case, got, want, weights, threshold, atol):
    """The median depth is a step of the ray; kernel and plain version may
    pick neighbouring steps only where the plain cumulative weight lies
    within 1e-5 of the threshold (a tie under summation order)."""
    err = (got - want).abs()
    cum = torch.cumsum(weights, dim=-1)
    tie = ((cum - threshold).abs() < 1e-5).any(dim=-1)
    bad = int(((err > atol) & ~tie).sum())
    ties = int(((err > atol) & tie).sum())
    chk.errors["volume_render_fwd"] = max(chk.errors["volume_render_fwd"],
                                          float(torch.where(tie, 0.0, err).max()))
    print(f"  volume_render_fwd {case}: median depth off on {bad} rays "
          f"(+{ties} threshold ties) -> {'ok' if bad == 0 else 'FAIL'}")
    if bad:
        chk.failures.append(f"volume_render_fwd {case}: {bad} median depths differ")


def median_depth_ties(model, model_cpu, cams, grid, grid_cpu, depth_gpu, depth_cpu,
                      chunk: int, tol: float = 1e-4):
    """Median depths of a render on the card and on the CPU may differ only
    on rays where the two final cumulative weights fall on opposite sides
    of 0.5 at some step, within ``tol`` of it (a threshold tie). The
    weights come from the forward pass of each render chunk."""
    from presight_tpu_torch.data.cameras import generate_rays

    H, W = depth_gpu.shape
    rows, cols = np.mgrid[0:H, 0:W]
    ray_index = np.stack([np.zeros(H * W, np.int32), rows.reshape(-1).astype(np.int32),
                          cols.reshape(-1).astype(np.int32)], -1)
    tie = []
    for s in range(0, H * W, chunk):
        idx = torch.from_numpy(ray_index[s:s + chunk])
        w_cpu = model_cpu(generate_rays(cams, idx), prop_grid=grid_cpu)["weights_list"][-1]
        w_gpu = model(generate_rays(cams.to(grid.device), idx.to(grid.device)),
                      prop_grid=grid)["weights_list"][-1].cpu()
        cum_cpu, cum_gpu = torch.cumsum(w_cpu, -1), torch.cumsum(w_gpu, -1)
        straddle = (cum_cpu < 0.5) != (cum_gpu < 0.5)
        tie.append((straddle & ((cum_cpu - 0.5).abs() <= tol)).any(-1).numpy())
    tie = np.concatenate(tie).reshape(H, W)
    off = np.abs(depth_gpu - depth_cpu) > tol
    bad = int((off & ~tie).sum())
    print(f"  depth (median): {int(off.sum())} of {H * W} pixels differ by > {tol:g}, "
          f"{int((off & tie).sum())} of them threshold ties -> {'ok' if bad == 0 else 'FAIL'}")
    return [f"small render median depth differs on {bad} pixels"] if bad else []


def scene(num_experts: int):
    """Expert centroids on a 4x4 grid, 10 units (200 m at pose scale 0.05)
    apart, each with a +-10 x +-10 x +-2.5 AABB; six cameras at 1.5 m
    height in the tile centre looking around the horizon (nuScenes-like
    1600x900 intrinsics)."""
    side = int(np.ceil(np.sqrt(num_experts)))
    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    cent = np.stack([xs.ravel(), ys.ravel(), np.zeros(side * side)], -1)[:num_experts]
    cent = ((cent - (side - 1) / 2.0) * 10.0).astype(np.float32)
    half = np.array([10.0, 10.0, 2.5], np.float32)
    aabbs = np.stack([np.stack([c - half, c + half]) for c in cent]).astype(np.float32)
    c2w = np.zeros((6, 3, 4), np.float32)
    for i in range(6):
        yaw = 2 * np.pi * i / 6
        # camera looks along -z; rotate so -z points at (cos yaw, sin yaw, 0)
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        c2w[i, :, 0], c2w[i, :, 1], c2w[i, :, 2] = right, up, -fwd
        c2w[i, :, 3] = [1.0, 2.0, 0.075]
    from presight_tpu_torch.data.cameras import CameraParams

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    cams = CameraParams(c2w=t(c2w), fx=t([1266.0] * 6), fy=t([1266.0] * 6),
                        cx=t([800.0] * 6), cy=t([450.0] * 6),
                        video_ids=torch.zeros(6, dtype=torch.int32))
    return aabbs, cent, cams


def check_kernels(model, grid, chk: Checker):
    from presight_tpu_torch.configs import tile_model_config
    from presight_tpu_torch.fields import prop_field as PF
    from presight_tpu_torch.fields.router import build_padded_routing
    from presight_tpu_torch.ops import hash_encoding as HE
    from presight_tpu_torch.ops import mlp as M
    from presight_tpu_torch.ops import renderers as VR
    from presight_tpu_torch.ops.mlp import GROUP_BLOCK

    cfg = model.config
    params = model.params()
    dev = grid.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    E = params["field"]["centroids"].shape[0]
    n_rays = cfg.eval_num_rays_per_chunk
    n_main = n_rays * cfg.num_nerf_samples_per_ray
    routing = build_padded_routing(
        torch.randint(0, E, (n_main,), generator=gen, device=dev, dtype=torch.int32), E,
        GROUP_BLOCK)
    n_pad = routing.to_slot.shape[0]

    # K1: main field (n_pad slots, 4 x 10 F, 2^17 rows) and fine proposal field.
    fcfg = cfg.field.hash
    pos = torch.rand((n_pad, 3), generator=gen, device=dev)
    args = (params["field"]["hash_table"], pos, fcfg, routing.expert_of_slot)
    chk.close("hash_encode_fwd", f"main field N={n_pad}", HE.hash_encode(*args),
              HE.hash_encode_plain(*args), 1e-7, 1e-5)
    chk.times["hash_encode_fwd"] = (time_ms(lambda: HE.hash_encode(*args)),
                                    time_ms(lambda: HE.hash_encode_plain(*args)))
    n_prop = n_rays * cfg.num_proposal_samples_per_ray[1]
    pargs = (params["props"][0]["hash_table"], torch.rand((n_prop, 3), generator=gen, device=dev),
             cfg.prop(1).hash, torch.randint(0, E, (n_prop,), generator=gen, device=dev,
                                             dtype=torch.int32))
    chk.close("hash_encode_fwd", f"proposal field N={n_prop}", HE.hash_encode(*pargs),
              HE.hash_encode_plain(*pargs), 1e-7, 1e-5)

    # K1's other table layouts, off the served path: 'corner' (the main field
    # of the reference profile) and 'cell', with and without expert ids, at
    # random points and at grid nodes of every level (where ceil == floor).
    for hcfg in (tile_model_config("boston-seaport", 0, "camera", tpu=False).field.hash,
                 dataclasses.replace(fcfg, storage="cell")):
        table = torch.rand((E * hcfg.num_levels * hcfg.table_size, hcfg.row_features),
                           generator=gen, device=dev) * 2.0 - 1.0
        nodes = [torch.randint(0, int(sc) + 1, (1024, 3), generator=gen, device=dev) / sc
                 for sc in hcfg.scalings().tolist()]
        hpos = torch.cat([torch.rand((n_rays, 3), generator=gen, device=dev), *nodes])
        for eids in (None, torch.randint(0, E, (hpos.shape[0],), generator=gen, device=dev,
                                         dtype=torch.int32)):
            hargs = (table, hpos, hcfg, eids)
            chk.close("hash_encode_fwd",
                      f"{hcfg.storage} {hcfg.num_levels}x{hcfg.features_per_level} "
                      f"2^{hcfg.log2_hashmap_size} N={hpos.shape[0]} "
                      f"{'experts' if eids is not None else 'single'}",
                      HE.hash_encode(*hargs), HE.hash_encode_plain(*hargs), 1e-7, 1e-5)
    del table

    # K2: every MLP stack of the path at its shapes.
    f = params["field"]
    geo = cfg.field.geo_feat_dim
    cases = [
        ("base 40-64-80", f["base_mlp"], fcfg.out_dim, routing.block_expert, False),
        ("rgb 47-64-64-3 sigmoid", f["rgb_head"], 16 + geo + cfg.appearance_dim,
         routing.block_expert, True),
        ("semantic 64-64-64-64", f["semantic_head"], cfg.semantic_dim, routing.block_expert,
         False),
    ]
    sky_routing = build_padded_routing(
        torch.randint(0, E, (n_rays,), generator=gen, device=dev, dtype=torch.int32), E,
        GROUP_BLOCK)
    sky = params["sky"]
    cases += [
        ("sky rgb 32-32-32-3 sigmoid", sky["rgb_head"], 16 + cfg.appearance_dim,
         sky_routing.block_expert, True),
        ("sky semantic 16-32-32-64", sky["semantic_head"], 16, sky_routing.block_expert, False),
    ]
    for name, layers, in_dim, be, sig in cases:
        h = torch.randn((be.shape[0] * GROUP_BLOCK, in_dim), generator=gen, device=dev)
        chk.close("mlp_blocks_fwd", f"{name} N={h.shape[0]}",
                  M.apply_mlp_blocks(layers, h, be, sig),
                  M.apply_mlp_blocks_plain(layers, h, be, sig), 1e-5, 1e-4)
        if name.startswith("base"):
            chk.times["mlp_blocks_fwd"] = (
                time_ms(lambda: M.apply_mlp_blocks(layers, h, be, sig)),
                time_ms(lambda: M.apply_mlp_blocks_plain(layers, h, be, sig)))
    prop_mlp = params["props"][0]["mlp"]
    h = torch.randn((n_prop, cfg.prop(1).hash.out_dim), generator=gen, device=dev)
    chk.close("mlp_blocks_fwd", f"proposal 8-64-1 N={n_prop}", M.apply_mlp(prop_mlp, h),
              M.apply_mlp_blocks_plain(prop_mlp, h, None), 1e-5, 1e-4)

    # K3: final render with the rgb+semantics payload in padded slots, and the
    # two weights-only proposal rounds.
    S = cfg.num_nerf_samples_per_ray
    deltas = torch.rand((n_rays, S), generator=gen, device=dev) * 0.05
    dens = torch.exp(torch.randn((n_rays, S), generator=gen, device=dev) * 2.0) * 4.0
    steps = torch.cumsum(deltas, -1) + 0.005
    payload = torch.rand((n_pad, 3 + cfg.semantic_dim), generator=gen, device=dev)
    vargs = (deltas, dens, steps, payload, routing.from_slot)
    got, want = VR.volume_render(*vargs), VR.volume_render_plain(*vargs)
    for key in ("weights", "accumulation", "composite"):
        chk.close("volume_render_fwd", f"{key} R={n_rays} S={S}", got[key], want[key],
                  1e-5, 1e-5)
    chk.close("volume_render_fwd", f"expected_depth R={n_rays} S={S}",
              got["expected_depth"], want["expected_depth"], 1e-5, 1e-5)
    median_depth_check(chk, f"depth R={n_rays} S={S}", got["depth"], want["depth"],
                       want["weights"], 0.5, 1e-6)
    chk.times["volume_render_fwd"] = (time_ms(lambda: VR.volume_render(*vargs)),
                                      time_ms(lambda: VR.volume_render_plain(*vargs)))
    for S in cfg.num_proposal_samples_per_ray:
        d = torch.rand((n_rays, S), generator=gen, device=dev) * 0.05
        s = torch.exp(torch.randn((n_rays, S), generator=gen, device=dev) * 2.0) * 4.0
        chk.close("volume_render_fwd", f"weights R={n_rays} S={S}",
                  VR.volume_render(d, s)["weights"], VR.volume_render_plain(d, s)["weights"],
                  1e-5, 1e-5)

    # K4: the cached grid (E * 64^3 rows) at the first round's sample count,
    # positions spread over the tile and beyond it.
    n_grid = n_rays * cfg.num_proposal_samples_per_ray[0]
    buf = params["props"][0]
    gpos = (torch.rand((n_grid, 3), generator=gen, device=dev) - 0.5) * torch.tensor(
        [60.0, 60.0, 8.0], device=dev)
    kargs = (grid, buf["centroids"], buf["aabbs"], gpos, cfg.prop_grid_res)
    chk.close("prop_grid_density_fwd", f"N={n_grid} E={E} G={cfg.prop_grid_res}",
              PF.prop_grid_density(*kargs), PF.prop_grid_density_plain(*kargs), 1e-6, 1e-5)
    chk.times["prop_grid_density_fwd"] = (
        time_ms(lambda: PF.prop_grid_density(*kargs)),
        time_ms(lambda: PF.prop_grid_density_plain(*kargs)))


def main() -> int:
    # Phase 1: the card.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from presight_tpu_torch import kernels
    from presight_tpu_torch.configs import TILES, tile_model_config
    from presight_tpu_torch.engine.evaluator import ImageRenderer
    from presight_tpu_torch.models.nerfacto_ms import init_model
    from presight_tpu_torch.prior.extraction import extract_voxels

    # Phase 2: build.
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.lib()
    print(f"phase 2: kernels built in {time.perf_counter() - t0:.2f} s -> {lib_path.name}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    # Phase 4 set-up first: the kernel checks use the model's own tables.
    config = tile_model_config("boston-seaport", 0, "camera")
    num_experts = TILES["boston-seaport"][1]
    aabbs, cent, cams = scene(num_experts)
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    model_cpu = init_model(gen, config, aabbs, cent, NUM_CAMERAS, NUM_VIDEOS)
    model = init_model(torch.Generator().manual_seed(SEED), config, aabbs, cent,
                       NUM_CAMERAS, NUM_VIDEOS).cuda()
    cams_gpu = cams.to("cuda")
    print(f"model boston-seaport-camera-dino-c0-tpu: {num_experts} experts, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters, "
          f"init {time.perf_counter() - t0:.2f} s")
    grid = model.make_prop_grid()
    torch.cuda.synchronize()

    # Phase 3: kernels against their plain versions.
    print("phase 3: kernels vs plain PyTorch on the card")
    chk = Checker()
    check_kernels(model, grid, chk)
    torch.cuda.synchronize()
    for name, (k_ms, p_ms) in chk.times.items():
        print(f"  time {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    if chk.failures:
        print("phase 3 FAILED:\n  " + "\n  ".join(chk.failures), file=sys.stderr)
        return 1

    # Phase 4: the main path, counted.
    print("phase 4: serve")
    renderer = ImageRenderer(config)
    H, W = 450, 800
    render_cams = cams_gpu.to("cuda")
    render_cams.fx, render_cams.fy = render_cams.fx * 0.5, render_cams.fy * 0.5
    render_cams.cx, render_cams.cy = render_cams.cx * 0.5, render_cams.cy * 0.5
    items = [SimpleNamespace(H=900, W=1600, seg_path=None) for _ in range(6)]
    dino_rng = np.random.RandomState(SEED)
    dino_to_rgb = {"reduction_matrix": dino_rng.randn(config.semantic_dim, 3).astype(np.float32),
                   "mean": np.full(config.semantic_dim, 0.5, np.float32),
                   "rgb_min": np.full(3, -2.0, np.float32),
                   "rgb_max": np.full(3, 2.0, np.float32)}
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    grid = model.make_prop_grid()
    img = renderer.render(model, render_cams, 0, H, W, prop_grid=grid)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = extract_voxels(
        model, items, cams_gpu, pose_scale_factor=config.pose_scale_factor,
        origin=np.zeros(3, np.float32), dino_to_rgb=dino_to_rgb, output_dir=OUT_DIR,
        camera_scaling_factor=0.2, min_depth=0.0, max_depth=1e9, density_threshold=1e-6,
        z_bounds=(-1e9, 1e9), use_segmentation_mask=False)
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_rays = H * W
    print(f"  render {H}x{W}: {n_rays} rays in {t_render:.3f} s "
          f"({n_rays / t_render:.1f} rays/s, grid refresh included; "
          f"{-(-n_rays // renderer.chunk)} chunks of {renderer.chunk})")
    print(f"  extraction: 6 cameras at downscale 5 in {t_extract:.3f} s, "
          f"{len(result['points'])} voxels")
    print(f"  launches on the main path: {launches}")

    problems = []
    for key, v in img.items():
        if not np.isfinite(v).all():
            problems.append(f"render {key} not finite")
    if img["rgb"].shape != (H, W, 3) or img["semantics"].shape != (H, W, config.semantic_dim):
        problems.append(f"render shapes {img['rgb'].shape} {img['semantics'].shape}")
    want = {"points": (np.float32, 3), "features": (np.float16, config.semantic_dim),
            "colors": (np.float32, 3)}
    if set(result) != {"points", "features", "colors", "hits", "origin"}:
        problems.append(f"pickle keys {sorted(result)}")
    for key, (dtype, width) in want.items():
        if result[key].dtype != dtype or result[key].shape != (len(result["points"]), width):
            problems.append(f"pickle {key} {result[key].dtype} {result[key].shape}")
        if not np.isfinite(result[key].astype(np.float32)).all():
            problems.append(f"pickle {key} not finite")
    if len(result["points"]) == 0 or result["origin"].dtype != np.float32:
        problems.append("pickle empty or origin not float32")
    for name in kernels.KERNELS:
        if launches[name] <= 0:
            problems.append(f"{name} was not launched on the main path")
    if problems:
        print("phase 4 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1
    # Second render, the grid reused: steady-state rays/s.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renderer.render(model, render_cams, 0, H, W, prop_grid=grid)
    torch.cuda.synchronize()
    t_render2 = time.perf_counter() - t0
    print(f"  render again (grid reused): {t_render2:.3f} s ({n_rays / t_render2:.1f} rays/s)")

    # Phase 5: kernel path against the plain path (the same weights on the
    # CPU): the full-width cached grid, then a 16 x 32 render of camera 0 at
    # the same field of view, each device with its own grid.
    print("phase 5: kernel path vs plain path")
    t0 = time.perf_counter()
    grid_cpu = model_cpu.make_prop_grid()
    print(f"  plain grid built on the CPU in {time.perf_counter() - t0:.2f} s")
    err = (grid.cpu() - grid_cpu).abs()
    bad = int((err > 1e-5 + 1e-4 * grid_cpu.abs()).sum())
    print(f"  make_prop_grid {tuple(grid.shape)}: max_abs_err={float(err.max()):.3e} "
          f"tol=atol 1e-05 + rtol 0.0001 -> {'ok' if bad == 0 else 'FAIL'}")
    if bad:
        problems.append(f"cached grid: {bad} values out of tolerance")
    small = ImageRenderer(config, chunk=256)
    small_cams = cams.to("cpu")
    scale = 16 / 900
    small_cams.fx, small_cams.fy = small_cams.fx * scale, small_cams.fy * scale
    small_cams.cx, small_cams.cy = small_cams.cx * scale, small_cams.cy * scale
    out_gpu = small.render(model, small_cams.to("cuda"), 0, 16, 32, prop_grid=grid)
    out_cpu = small.render(model_cpu, small_cams, 0, 16, 32, prop_grid=grid_cpu)
    for key in ("rgb", "accumulation", "expected_depth", "semantics"):
        err = float(np.abs(out_gpu[key] - out_cpu[key]).max())
        ok = err <= 1e-4
        print(f"  {key}: max_abs_err={err:.3e} (tol 1e-4) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            problems.append(f"small render {key} differs by {err}")
    problems += median_depth_ties(model, model_cpu, small_cams, grid, grid_cpu,
                                  out_gpu["depth"], out_cpu["depth"], small.chunk)
    if problems:
        print("phase 5 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": chk.errors[name],
         "ms": chk.times[name][0], "plain_ms": chk.times[name][1]}
        for name, (src, replaces) in KERNEL_INFO.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
