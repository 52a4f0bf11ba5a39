#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (presight_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the result lines are printed):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from presight_tpu_torch/csrc (one nvcc per
     source, in parallel), time the build, print ptxas's registers and
     spills and each __global__'s SASS instruction count (the SASS goes to
     outputs/chip_smoke/sass.txt);
  3. check each forward kernel (K1-K4) against its plain PyTorch version on
     the card at the main path's shapes, with the stated tolerances, and
     time both with CUDA events (median of 10 calls after warm-up;
     time_ms), the kernel also by its device time (torch.profiler, the
     host's share left out; device_ms); K2 also as a chain of one-layer
     launches, which must equal the fused launch bitwise, and its ReLU
     masks against the plain forward's (flips only at ties: RELU_TIE_ATOL,
     RELU_TIE_SHARE); K1 also with 2^14-row tables, every row in L2 (its
     L2-resident floor); K4 also with a G = 16 grid, every row in L2, and on
     positions inside the experts' AABBs; K3 also on rays of 1024 samples
     whose 67-wide payload rows do not fit in shared memory;
  4. serve: initialise boston-seaport-camera-dino-c0-tpu at full width from
     a seed, build the cached proposal grid, render one 450x800 camera with
     ImageRenderer (11 chunks of 32768 rays), recording the inputs of K1 on
     the main field, of K3's final render and of K4 in its sixth chunk, and
     extract priors from one 6-camera frame at downscale 5; check finite
     outputs, the pickle schema, and that K1-K4 were launched on this path;
     render twice more, the second time under torch.profiler (between spin
     kernels, and profiled again where the profiler lost a kernel's events;
     device busy, each kernel's device time and launches in the render: render_ms,
     render_launches; the table goes to
     outputs/chip_smoke/render_profile.txt); check and time K1, K3 and K4
     (K4 also with a G = 16 grid) on the recorded chunk as phase 3 does
     (failing if nothing was recorded);
  5. hold the kernel path against the plain path (the same model on the
     CPU): the full-width cached grid, and a small render with each
     device's own grid (median depths may differ only at threshold ties);
  6. check the backward kernels (K1b, K2b, K3b, K5) against their plain
     versions on the card at the training path's shapes (K2b on K2's own
     ReLU masks; two calls of K2b, K3b and K5 bitwise equal), K5 through
     the sort's permutation into a non-zero prior gradient and also against
     one index_add_ call, and time kernel, plain and library the same way
     (K5 on random keys is printed only: its JSON numbers come from phase 7);
     K3b also on the long rays of phase 3;
  7. train: the Trainer on a synthetic in-memory dataset (six 225x400
     cameras), 5 full-width steps of 65,536 rays in microbatches of 1024;
     print each step's losses, seconds, rays/s and grid refresh, and the
     peak device memory; fail on a non-finite loss or parameter, or if any
     of the eight kernels was not launched on the training path; check and
     time K5 on the inputs of a training microbatch as phase 6 does (failing
     if no microbatch's inputs were recorded), and the chain torch.sort + K5
     against index_add_ on the unsorted pairs; then
     one more step under torch.profiler (as the render in phase 4): the
     device's busy time and idle
     share, each kernel's device time and launches in the step (step_ms,
     step_launches), the hash backward's and AccumulateGrad's device time,
     and a check that AccumulateGrad never ran on a hash table (the table
     goes to outputs/chip_smoke/train_profile.txt);
  8. hold the training kernel path against the plain path for one step on
     the same weights, 2048-ray batch and draws (the plain path on the CPU):
     losses, every gradient leaf and the updated parameters.
The line before the last is a JSON object with each kernel's launches (on
the serving and the training path), error, times (ms, plain_ms and
library_ms by CUDA events; device_ms by the profiler), bound, and device
time and launches in one training step (step_ms, step_launches) and in one
450x800 render (render_ms, render_launches); the last line is {"ok": true,
"device": {...}}. Writes the prior pickle and the profile tables under
outputs/chip_smoke/.
"""

from __future__ import annotations

import collections
import contextlib
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
    "hash_encode_bwd": ("presight_tpu_torch/csrc/hash_encode_bwd.cu",
                        "presight_tpu/ops/hash_encoding.py:294"),
    "mlp_blocks_bwd": ("presight_tpu_torch/csrc/mlp_blocks_bwd.cu",
                       "presight_tpu/ops/mlp.py:184"),
    "volume_render_bwd": ("presight_tpu_torch/csrc/volume_render_bwd.cu",
                          "presight_tpu/ops/rays.py:68"),
    "sorted_accum": ("presight_tpu_torch/csrc/sorted_accum.cu",
                     "scripts_dev/pallas_accum.py:30"),
}
# The __global__ kernels each wrapper launches, as the profiler names them.
KERNEL_GLOBALS = {
    "hash_encode_fwd": ("hash_encode_fwd_kernel",),
    "mlp_blocks_fwd": ("mlp_blocks_fwd_kernel",),
    "volume_render_fwd": ("volume_render_fwd_kernel",),
    "prop_grid_density_fwd": ("prop_grid_density_kernel",),
    "hash_encode_bwd": ("hash_encode_bwd_kernel",),
    "mlp_blocks_bwd": ("mlp_blocks_bwd_kernel", "mlp_blocks_bwd_index_kernel",
                       "mlp_blocks_bwd_reduce_kernel"),
    "volume_render_bwd": ("volume_render_bwd_kernel",),
    "sorted_accum": ("sorted_accum_tiles", "sorted_accum_carry"),
}
SERVE_KERNELS = ("hash_encode_fwd", "mlp_blocks_fwd", "volume_render_fwd",
                 "prop_grid_density_fwd")
# Published peaks of one H100 SXM at 700 W: HBM bandwidth, f32 outside the
# tensor cores, and f32-accurate products on the tensor cores: 3xTF32 takes
# three TF32 products (495 TFLOP/s dense) for each f32 one, so 495/3. K2
# and K2b are bound at that rate, the other kernels at the f32 one.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TC_F32_FLOPS_PER_S = 495e12 / 3
# A ReLU mask of K2 (3xTF32) may differ from the plain forward's only
# where the plain pre-activation is within this of 0, on at most this
# share of the hidden pre-activations.
RELU_TIE_ATOL = 1e-5
RELU_TIE_SHARE = 1e-4
TRAIN_STEPS = 5
TRAIN_HW = (225, 400)


def sass_report(lib_path: Path) -> None:
    """Dump the library's SASS (cuobjdump, beside nvcc) to OUT_DIR/sass.txt
    and print each __global__'s instruction count: the static count, which
    with a kernel's loop trip counts gives its instructions per item."""
    import re

    from presight_tpu_torch import kernels

    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "sass.txt").write_text(dump)
    for chunk in dump.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        count = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+[^N\s]", chunk))
        print(f"  sass: {name} {count} instructions (NOPs left out)")


def time_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of fn() on the current stream, by CUDA events
    around each call: where the host takes longer to launch a call's
    kernels than the card to run them, this times the host."""
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


SPIN = "spin_kernel"  # torch.cuda._sleep's kernel: the padding of a profile


def device_events(fn, reps: int = 10, pad: int = 4):
    """The device events (kernels, memsets, copies) of ``reps`` calls of
    fn() after two warm-up calls, by torch.profiler. The profiler has
    dropped records of a session's last launches (always one of ten
    index_add_ calls on a training microbatch's rows, in three sessions
    running), so the calls sit between ``pad`` short spin kernels on each
    side, which are left out."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        for _ in range(pad):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type.name == "CUDA" and SPIN not in e.name]


def device_ms(fn, reps: int = 10, kernel: str = "", tries: int = 5) -> float:
    """Device milliseconds per call of fn(): the summed durations of the
    kernels, memsets and copies it runs on the card over ``reps`` calls,
    over ``reps``. The host's share of a call (Python, a wrapper's checks and
    allocations, the launch), which time_ms counts, is left out. Where the
    profiler still lost events (a K3 call once summed to 0.06 ms, under half
    its bound) -- some name's events are not a multiple of ``reps``, or the
    main __global__ of ``kernel`` (a KERNEL_GLOBALS key) has none -- the
    calls are profiled again, up to ``tries`` runs in all, and then it
    raises."""
    must = KERNEL_GLOBALS[kernel][:1] if kernel else ()
    for _ in range(tries):
        events = device_events(fn, reps)
        counts = collections.Counter(e.name for e in events)
        short = {name[:60]: n for name, n in counts.items() if n % reps}
        missing = [g for g in must if not any(g in name for name in counts)]
        if not short and not missing:
            return sum(e.time_range.end - e.time_range.start for e in events) / reps / 1e3
        print(f"  (the profiler lost device events of {reps} calls: {short or missing}; "
              "profiling again)")
    raise RuntimeError(f"device_ms: the profiler lost device events in {tries} runs")


def bound(bytes_moved: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    """(ms, 'bytes' or 'operations'): the least time the card could take,
    the larger of the bytes over the HBM rate and the f32 operations over
    the peak rate for them."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def mlp_work(layers, n: int, factor: int):
    """(bytes, flops) of an MLP over n rows: each row's input and output and
    every expert's weights once; factor 2 (forward) or 6 (backward: the
    recomputed forward and the dX and dW products) flops per multiply-add,
    plus dX and the weight gradients written for the backward."""
    dims = [layers[0][0].shape[-2]] + [w.shape[-1] for w, _ in layers]
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    weights = sum(w.numel() + b.numel() for w, b in layers) * 4
    rows = n * (dims[0] + dims[-1]) * 4
    if factor == 2:
        return rows + weights, 2 * n * macs
    return rows + n * dims[0] * 4 + 2 * weights, factor * n * macs


class Checker:
    """Collects per-kernel errors, times and bounds; a failure is recorded
    and reported, and makes the run fail at the end of the phase."""

    def __init__(self):
        self.errors = {name: 0.0 for name in KERNEL_INFO}
        self.times = {}
        self.device = {}
        self.library = {}
        self.bounds = {}
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

    def time(self, kernel, run, plain):
        """The wrapper run() and the plain version plain(), each by time_ms
        (the kernels JSON line's ms and plain_ms), and run() by device_ms."""
        self.times[kernel] = (time_ms(run), time_ms(plain))
        self.device[kernel] = device_ms(run, kernel=kernel)


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


def k2_chain(layers, h, be, sigmoid):
    """K2 as a chain of one-layer launches with the ReLU in torch between
    them: (output, hidden pre-activations). Stacked (E, in, out) layers;
    be None for one expert."""
    from presight_tpu_torch.ops import mlp as M

    pres, x = [], h
    for i, (w, b) in enumerate(layers):
        if i == len(layers) - 1:
            return M.mlp_blocks_fwd([(w, b)], x, be, sigmoid), pres
        pres.append(M.mlp_blocks_fwd([(w, b)], x, be))
        x = torch.relu(pres[-1])


def k2_masks(chk, case, layers, h, be, sigmoid):
    """K2's own ReLU masks, with the checks that make them K2's: the chain
    of one-layer launches equals the fused launch bitwise (every layer runs
    the same fragment arithmetic), and the masks differ from the plain
    forward's only at ties (RELU_TIE_ATOL, RELU_TIE_SHARE)."""
    from presight_tpu_torch.ops import mlp as M

    fused = M.mlp_blocks_fwd(layers, h, be, sigmoid)
    out, pres = k2_chain(layers, h, be, sigmoid)
    if not torch.equal(out, fused):
        chk.failures.append(f"mlp_blocks_fwd {case}: the chained layers differ from the fused "
                            f"kernel on {int((out != fused).sum())} outputs")
    flips = bad = total = 0
    x = h
    for (w, b), pre in zip(layers, pres):
        plain = M.apply_mlp_blocks_plain([(w, b)], x, be)
        flip = (pre > 0) != (plain > 0)
        flips += int(flip.sum())
        bad += int((flip & (plain.abs() > RELU_TIE_ATOL)).sum())
        total += plain.numel()
        x = torch.relu(plain)
    ok = bad == 0 and flips <= RELU_TIE_SHARE * total
    print(f"  mlp_blocks_fwd {case}: chained == fused {torch.equal(out, fused)}; ReLU masks "
          f"differ from the plain forward's on {flips} of {total} hidden pre-activations, "
          f"{bad} of them beyond {RELU_TIE_ATOL:g} of 0 -> {'ok' if ok else 'FAIL'}")
    if not ok:
        chk.failures.append(f"mlp_blocks_fwd {case}: {flips} ReLU mask flips, {bad} not ties")
    return [pre > 0 for pre in pres]


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


def k1_bound(pos, hcfg, eids):
    """K1's bound: positions and expert ids read, each distinct table row
    these inputs touch read once, the output written."""
    from presight_tpu_torch.ops import hash_encoding as HE

    n = pos.shape[0]
    rows_read = HE.hash_keys(pos, hcfg, eids).unique().numel()
    return bound(n * 16 + rows_read * hcfg.row_features * 4 + n * hcfg.out_dim * 4,
                 n * hcfg.num_levels * (hcfg.features_per_level * 16 + 30))


def k3_bound(deltas, dens, steps, payload, index):
    """K3's bound: per sample delta, sigma, t, the payload index and the
    weight written, and its payload row read; per ray its outputs."""
    R, S = deltas.shape
    C = payload.shape[1]
    return bound(R * S * (4 * 5 + C * 4) + R * (C + 3) * 4, R * S * (12 + 2 * C))


def check_k3(chk, case, vargs):
    """K3 with steps and a payload against its plain version: weights,
    accumulation, composite and expected depth at 1e-5; the median depth off
    only at threshold ties."""
    from presight_tpu_torch.ops import renderers as VR

    got, want = VR.volume_render(*vargs), VR.volume_render_plain(*vargs)
    for key in ("weights", "accumulation", "composite", "expected_depth"):
        chk.close("volume_render_fwd", f"{key} {case}", got[key], want[key], 1e-5, 1e-5)
    median_depth_check(chk, f"depth {case}", got["depth"], want["depth"], want["weights"], 0.5,
                       1e-6)


def k4_bound(grid, centroids, aabbs, pos, G):
    """K4's bound: positions read and densities written once, each distinct
    cell row these inputs touch read once, the centroids and AABBs; the
    operations of routing (E x 8) and of contraction and blend (~60)."""
    from presight_tpu_torch.fields.router import assign_experts
    from presight_tpu_torch.ops.math import contract_positions

    n, E = pos.shape[0], centroids.shape[0]
    eids = assign_experts(pos, centroids).long()
    cell = torch.clamp(torch.floor(contract_positions(pos, aabbs[eids])[0] * G), 0, G - 1).long()
    cells = ((eids * G + cell[:, 0]) * G + cell[:, 1]) * G + cell[:, 2]
    return bound(n * 16 + cells.unique().numel() * 32 + E * 36 * 4, n * (E * 8 + 60))


def k4_reading(chk, label, kargs, small_grid: bool = True):
    """K4 on one input against its plain version, timed (CUDA events and
    device time) beside its bound; and, with small_grid, on the same
    positions with a random G = 16 grid (2 MB for 16 experts: every row in
    L2), whose difference from the G = 64 reading is the gather's share of
    the time."""
    from presight_tpu_torch.fields import prop_field as PF

    grid, cent, aabbs, pos, G = kargs
    runs = [(f"G={G}", kargs)]
    if small_grid:
        gen = torch.Generator(device=pos.device).manual_seed(SEED + 4)
        small = torch.rand((cent.shape[0] * 16 ** 3, 8), generator=gen, device=pos.device)
        runs.append(("G=16 L2-resident", (small, cent, aabbs, pos, 16)))
    for grid_label, args in runs:
        chk.close("prop_grid_density_fwd", f"{label} N={pos.shape[0]} {grid_label}",
                  PF.prop_grid_density(*args), PF.prop_grid_density_plain(*args), 1e-6, 1e-5)
        b = k4_bound(*args)
        print(f"  prop_grid_density_fwd reading {label} {grid_label}: kernel "
              f"{time_ms(lambda: PF.prop_grid_density(*args)):.4f} ms (device "
              f"{device_ms(lambda: PF.prop_grid_density(*args), kernel='prop_grid_density_fwd'):.4f}"
              f" ms), bound {b[0]:.4f} ms ({b[1]})")


@contextlib.contextmanager
def recording_render_chunk(field_hash, chunk: int = 5):
    """Keep a copy of the inputs of K1 on the main field, of K3 with a
    payload (the final render) and of K4 (the first proposal round) in the
    ``chunk``-th render chunk: the positions of a render chunk lie along
    rays and the payload rows in the padded slots of real routing, unlike
    phase 3's uniform draws."""
    from presight_tpu_torch.models import nerfacto_ms as NM
    from presight_tpu_torch.ops import hash_encoding as HE
    from presight_tpu_torch.ops import renderers as VR

    real_k1, real_k3, real_k4 = HE.hash_encode_fwd, VR.volume_render_fwd, NM.prop_grid_density
    recorded, seen = {}, {"k1": 0, "k3": 0, "k4": 0}

    def k1(table, positions, config, expert_ids=None, **kw):
        if config == field_hash:
            if seen["k1"] == chunk:
                recorded["k1"] = (table, positions.clone(), config,
                                  None if expert_ids is None else expert_ids.clone())
            seen["k1"] += 1
        return real_k1(table, positions, config, expert_ids, **kw)

    def k3(deltas, density, steps=None, payload=None, payload_index=None, *a, **kw):
        if payload is not None:
            if seen["k3"] == chunk:
                recorded["k3"] = tuple(t.clone() for t in (deltas, density, steps, payload,
                                                            payload_index))
            seen["k3"] += 1
        return real_k3(deltas, density, steps, payload, payload_index, *a, **kw)

    def k4(grid, centroids, aabbs, positions, res):
        if seen["k4"] == chunk:
            recorded["k4"] = (grid, centroids, aabbs, positions.reshape(-1, 3).clone(), res)
        seen["k4"] += 1
        return real_k4(grid, centroids, aabbs, positions, res)

    HE.hash_encode_fwd, VR.volume_render_fwd, NM.prop_grid_density = k1, k3, k4
    try:
        yield recorded
    finally:
        HE.hash_encode_fwd, VR.volume_render_fwd, NM.prop_grid_density = real_k1, real_k3, real_k4


@torch.no_grad()
def check_render_chunk(recorded, chk: Checker):
    """K1, K3 and K4 on the recorded render chunk against their plain
    versions, timed by CUDA events and by device time, beside their bounds
    over this chunk's inputs (K1's and K4's over the distinct rows they
    read); K4 also with a G = 16 grid. Returns problems."""
    from presight_tpu_torch.ops import hash_encoding as HE
    from presight_tpu_torch.ops import renderers as VR

    if sorted(recorded) != ["k1", "k3", "k4"]:
        return [f"render chunk not recorded (got {sorted(recorded)})"]
    failures = len(chk.failures)
    args = recorded["k1"]
    n = args[1].shape[0]
    chk.close("hash_encode_fwd", f"render chunk N={n}", HE.hash_encode(*args),
              HE.hash_encode_plain(*args), 1e-7, 1e-5)
    b = k1_bound(*args[1:])
    print(f"  render chunk hash_encode_fwd N={n}: kernel "
          f"{time_ms(lambda: HE.hash_encode(*args)):.4f} ms (device "
          f"{device_ms(lambda: HE.hash_encode(*args), kernel='hash_encode_fwd'):.4f} ms), bound "
          f"{b[0]:.4f} ms ({b[1]})")
    vargs = recorded["k3"]
    R, S = vargs[0].shape
    check_k3(chk, f"render chunk R={R} S={S}", vargs)
    b = k3_bound(*vargs)
    print(f"  render chunk volume_render_fwd R={R} S={S} C={vargs[3].shape[1]}: kernel "
          f"{time_ms(lambda: VR.volume_render(*vargs)):.4f} ms (device "
          f"{device_ms(lambda: VR.volume_render(*vargs), kernel='volume_render_fwd'):.4f} ms), "
          f"bound {b[0]:.4f} ms ({b[1]})")
    k4_reading(chk, "render chunk", recorded["k4"])
    return chk.failures[failures:]


@torch.no_grad()
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
    chk.time("hash_encode_fwd", lambda: HE.hash_encode(*args),
             lambda: HE.hash_encode_plain(*args))
    chk.bounds["hash_encode_fwd"] = k1_bound(*args[1:])
    # The same gather with every row in L2: 2^14-row tables (5 MB a level).
    small = dataclasses.replace(fcfg, log2_hashmap_size=14)
    l2gen = torch.Generator(device=dev).manual_seed(SEED + 3)  # phase 3's other draws stay
    l2args = ([torch.rand((small.table_size, small.row_features), generator=l2gen, device=dev)
               for _ in range(small.num_levels)], pos, small, routing.expert_of_slot)
    chk.close("hash_encode_fwd", f"L2-resident 2^14 rows N={n_pad}", HE.hash_encode(*l2args),
              HE.hash_encode_plain(*l2args), 1e-7, 1e-5)
    print(f"  hash_encode_fwd L2-resident floor: N={n_pad}, {small.num_levels} x "
          f"{small.features_per_level}F x 2^14 rows "
          f"({small.table_size * small.row_features * 4 / 1e6:.1f} MB a level): kernel "
          f"{time_ms(lambda: HE.hash_encode(*l2args)):.4f} ms (device "
          f"{device_ms(lambda: HE.hash_encode(*l2args), kernel='hash_encode_fwd'):.4f} ms)")
    del l2args
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
        k2_masks(chk, name, [(w.detach(), b.detach()) for w, b in layers], h, be, sig)
        if name.startswith("base"):
            chk.time("mlp_blocks_fwd", lambda: M.apply_mlp_blocks(layers, h, be, sig),
                     lambda: M.apply_mlp_blocks_plain(layers, h, be, sig))
            chk.bounds["mlp_blocks_fwd"] = bound(*mlp_work(layers, h.shape[0], 2),
                                                 TC_F32_FLOPS_PER_S)
    prop_mlp = params["props"][0]["mlp"]
    h = torch.randn((n_prop, cfg.prop(1).hash.out_dim), generator=gen, device=dev)
    chk.close("mlp_blocks_fwd", f"proposal 8-64-1 N={n_prop}", M.apply_mlp(prop_mlp, h),
              M.apply_mlp_blocks_plain(prop_mlp, h, None), 1e-5, 1e-4)
    k2_masks(chk, "proposal 8-64-1", [(w.detach()[None], b.detach()[None]) for w, b in prop_mlp],
             h, None, False)

    # K3: final render with the rgb+semantics payload in padded slots, and the
    # two weights-only proposal rounds.
    S = cfg.num_nerf_samples_per_ray
    deltas = torch.rand((n_rays, S), generator=gen, device=dev) * 0.05
    dens = torch.exp(torch.randn((n_rays, S), generator=gen, device=dev) * 2.0) * 4.0
    steps = torch.cumsum(deltas, -1) + 0.005
    payload = torch.rand((n_pad, 3 + cfg.semantic_dim), generator=gen, device=dev)
    vargs = (deltas, dens, steps, payload, routing.from_slot)
    check_k3(chk, f"R={n_rays} S={S}", vargs)
    chk.time("volume_render_fwd", lambda: VR.volume_render(*vargs),
             lambda: VR.volume_render_plain(*vargs))
    chk.bounds["volume_render_fwd"] = k3_bound(*vargs)
    for S in cfg.num_proposal_samples_per_ray:
        d = torch.rand((n_rays, S), generator=gen, device=dev) * 0.05
        s = torch.exp(torch.randn((n_rays, S), generator=gen, device=dev) * 2.0) * 4.0
        chk.close("volume_render_fwd", f"weights R={n_rays} S={S}",
                  VR.volume_render(d, s)["weights"], VR.volume_render_plain(d, s)["weights"],
                  1e-5, 1e-5)

    # K4: the cached grid (E * 64^3 rows) at the first round's sample count,
    # positions spread over the tile and beyond it; then the same count of
    # positions inside the experts' AABBs, which read far more distinct
    # cells; each also with a G = 16 grid.
    n_grid = n_rays * cfg.num_proposal_samples_per_ray[0]
    buf = params["props"][0]
    gpos = (torch.rand((n_grid, 3), generator=gen, device=dev) - 0.5) * torch.tensor(
        [60.0, 60.0, 8.0], device=dev)
    kargs = (grid, buf["centroids"], buf["aabbs"], gpos, cfg.prop_grid_res)
    k4_reading(chk, "phase 3", kargs)
    chk.time("prop_grid_density_fwd", lambda: PF.prop_grid_density(*kargs),
             lambda: PF.prop_grid_density_plain(*kargs))
    chk.bounds["prop_grid_density_fwd"] = k4_bound(*kargs)
    lo, hi = buf["aabbs"][:, 0].amin(0), buf["aabbs"][:, 1].amax(0)
    inside = lo + torch.rand((n_grid, 3), generator=gen, device=dev) * (hi - lo)
    k4_reading(chk, "inside the AABBs", (grid, buf["centroids"], buf["aabbs"], inside,
                                         cfg.prop_grid_res))

    # K3 on rays whose payload rows do not fit in shared memory.
    long = long_rays(gen, 1024, 3 + cfg.semantic_dim)[:5]
    check_k3(chk, f"long rays R={long[0].shape[0]} S={long[0].shape[1]}", long)
    print(f"  volume_render_fwd long rays R={long[0].shape[0]} S={long[0].shape[1]}: kernel "
          f"{time_ms(lambda: VR.volume_render(*long)):.4f} ms (device "
          f"{device_ms(lambda: VR.volume_render(*long), kernel='volume_render_fwd'):.4f} ms), "
          f"bound {k3_bound(*long)[0]:.4f} ms")


def long_rays(gen, S, C, R: int = 256):
    """K3's and K3b's inputs for R rays of S samples with a C-wide payload in
    padded slots: (deltas, density, steps, payload, index, dL/dw, dL/dacc,
    dL/dexpected, dL/dcomposite)."""
    dev = gen.device
    deltas = torch.rand((R, S), generator=gen, device=dev) * (0.24 / S)
    dens = torch.exp(torch.randn((R, S), generator=gen, device=dev) * 2.0) * 4.0
    steps = torch.cumsum(deltas, -1) + 0.005
    payload = torch.rand((R * S + 512, C), generator=gen, device=dev)
    index = torch.randperm(R * S + 512, generator=gen, device=dev)[:R * S].to(torch.int32)
    ups = [torch.randn(shape, generator=gen, device=dev) for shape in ((R, S), (R,), (R,), (R, C))]
    return (deltas, dens, steps, payload, index, *ups)


def backward_cases(model):
    """The training path's shapes of one 1024-ray microbatch: the main
    field's padded slots (48 samples per ray, 512-row expert blocks), the
    fine proposal field's 32 samples per ray, the sky heads' padded ray
    routing."""
    from presight_tpu_torch.fields.router import build_padded_routing
    from presight_tpu_torch.ops.mlp import GROUP_BLOCK

    cfg = model.config
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    E = model.params()["field"]["centroids"].shape[0]
    rays = 1024
    main = build_padded_routing(torch.randint(0, E, (rays * cfg.num_nerf_samples_per_ray,),
                                              generator=gen, device=dev, dtype=torch.int32),
                                E, GROUP_BLOCK)
    sky = build_padded_routing(torch.randint(0, E, (rays,), generator=gen, device=dev,
                                             dtype=torch.int32), E, GROUP_BLOCK)
    return gen, E, rays, main, sky


@torch.no_grad()
def check_backward_kernels(model, chk: Checker):
    from presight_tpu_torch.configs import tile_model_config
    from presight_tpu_torch.ops import hash_encoding as HE
    from presight_tpu_torch.ops import mlp as M
    from presight_tpu_torch.ops import renderers as VR

    cfg, params = model.config, model.params()
    gen, E, rays, main, sky = backward_cases(model)
    dev = main.to_slot.device
    n_main = main.to_slot.shape[0]
    n_prop = rays * cfg.num_proposal_samples_per_ray[1]

    # K1b and K5: the table gradient of the main field (57,344 slots x 4
    # levels, 80-wide rows) and of the fine proposal field (32,768 samples x
    # 2 levels, 32-wide rows), 'shared' storage with experts; K1b also on
    # 'cell' and 'corner' storage, with and without experts.
    fcfg, pcfg = cfg.field.hash, cfg.prop(1).hash
    ref_cfg = tile_model_config("boston-seaport", 0, "camera", tpu=False).field.hash
    cases = [("main field shared", fcfg, n_main, main.expert_of_slot),
             ("proposal field shared", pcfg, n_prop,
              torch.randint(0, E, (n_prop,), generator=gen, device=dev, dtype=torch.int32))]
    for hcfg in (dataclasses.replace(fcfg, storage="cell"), ref_cfg):
        for eids in (None, main.expert_of_slot):
            cases.append((f"{hcfg.storage} {hcfg.num_levels}x{hcfg.features_per_level} "
                          f"{'experts' if eids is not None else 'single'}", hcfg, n_main, eids))
    for name, hcfg, n, eids in cases:
        pos = torch.rand((n, 3), generator=gen, device=dev)
        g = torch.randn((n, hcfg.out_dim), generator=gen, device=dev) * 1e-3
        keys, rows = HE.hash_encode_bwd(pos, hcfg, eids, g)
        pkeys, prows = HE.hash_encode_bwd_plain(pos, hcfg, eids, g)
        bad_keys = int((keys != pkeys).sum())
        print(f"  hash_encode_bwd {name} N={n}: keys differ on {bad_keys} -> "
              f"{'ok' if bad_keys == 0 else 'FAIL'}")
        if bad_keys:
            chk.failures.append(f"hash_encode_bwd {name}: {bad_keys} keys differ")
        chk.close("hash_encode_bwd", f"{name} rows", rows, prows, 1e-9, 1e-6)
        if hcfg.storage != "shared":
            continue
        skeys, order = torch.sort(keys, stable=True)
        prior = prior_gradient(skeys, order, rows, hcfg.num_levels * hcfg.table_size)
        check_sorted_accum(chk, f"{name} N={keys.numel()} C={rows.shape[1]} "
                           f"T={hcfg.num_levels}x{hcfg.table_size}", skeys, order, rows, prior,
                           hcfg.table_size)
        if name.startswith("main"):
            chk.time("hash_encode_bwd", lambda: HE.hash_encode_bwd(pos, hcfg, eids, g),
                     lambda: HE.hash_encode_bwd_plain(pos, hcfg, eids, g))
            chk.bounds["hash_encode_bwd"] = bound(n * 16 + g.numel() * 4 + keys.numel() * 4
                                                  + rows.numel() * 4, rows.numel() * 2)
            time_sorted_accum(skeys, order, rows, prior, hcfg.table_size, " on random keys")

    # K2b: the six MLP stacks of the training path, against the plain
    # backward on K2's own ReLU masks (a 3xTF32 pre-activation within
    # rounding of 0 may take the other side; a flipped mask moves a row of
    # dX and the dW columns it touches by more than the tolerance).
    f, s_ = params["field"], params["sky"]
    stacks = [("base 40-64-80", f["base_mlp"], main.block_expert, False),
              ("rgb 47-64-64-3 sigmoid", f["rgb_head"], main.block_expert, True),
              ("semantic 64-64-64-64", f["semantic_head"], main.block_expert, False),
              ("sky rgb 32-32-32-3 sigmoid", s_["rgb_head"], sky.block_expert, True),
              ("sky semantic 16-32-32-64", s_["semantic_head"], sky.block_expert, False),
              ("proposal 8-64-1", [(w[None], b[None]) for w, b in params["props"][0]["mlp"]],
               None, False)]
    for name, layers, be, sig in stacks:
        n = n_prop if be is None else be.shape[0] * 512
        h = torch.randn((n, layers[0][0].shape[-2]), generator=gen, device=dev)
        g = torch.randn((n, layers[-1][0].shape[-1]), generator=gen, device=dev)
        layers = [(w.detach(), b.detach()) for w, b in layers]
        masks = k2_masks(chk, name, layers, h, be, sig)
        dx, grads = M.mlp_blocks_bwd(layers, h, be, sig, g)
        pdx, pgrads = M.mlp_blocks_bwd_plain(layers, h, be, sig, g, relu_masks=masks)
        dx2, grads2 = M.mlp_blocks_bwd(layers, h, be, sig, g)
        same = torch.equal(dx, dx2) and all(torch.equal(a, c) and torch.equal(b_, d)
                                            for (a, b_), (c, d) in zip(grads, grads2))
        print(f"  mlp_blocks_bwd {name}: two calls bitwise equal {same} -> "
              f"{'ok' if same else 'FAIL'}")
        if not same:
            chk.failures.append(f"mlp_blocks_bwd {name}: two calls differ")
        chk.close("mlp_blocks_bwd", f"{name} N={n} dX", dx, pdx, 1e-5 * float(pdx.abs().max()),
                  1e-4)
        for i, ((dw, db), (pw, pb)) in enumerate(zip(grads, pgrads)):
            chk.close("mlp_blocks_bwd", f"{name} dW[{i}]", dw, pw,
                      1e-5 * float(pw.abs().max()), 1e-4)
            chk.close("mlp_blocks_bwd", f"{name} db[{i}]", db, pb,
                      1e-5 * float(pb.abs().max()), 1e-4)
        if name.startswith("base"):
            chk.time("mlp_blocks_bwd", lambda: M.mlp_blocks_bwd(layers, h, be, sig, g),
                     lambda: M.mlp_blocks_bwd_plain(layers, h, be, sig, g))
            chk.bounds["mlp_blocks_bwd"] = bound(*mlp_work(layers, n, 6), TC_F32_FLOPS_PER_S)

    # K3b: the final render (48 samples, the 67-wide payload in padded slots)
    # with every upstream gradient non-zero, saturated and empty rays among
    # them; and the fine proposal round (32 samples, weights only).
    S = cfg.num_nerf_samples_per_ray
    deltas = torch.rand((rays, S), generator=gen, device=dev) * 0.05
    dens = torch.exp(torch.randn((rays, S), generator=gen, device=dev) * 2.0) * 4.0
    dens[:8, 5] = 1e30  # saturated: accumulation exactly 1
    dens[8:16] = 0.0  # empty: accumulation exactly 0
    steps = torch.cumsum(deltas, -1) + 0.005
    C = 3 + cfg.semantic_dim
    payload = torch.rand((n_main, C), generator=gen, device=dev)
    index = main.from_slot
    ups = [torch.randn(shape, generator=gen, device=dev) for shape in ((rays, S), (rays,), (rays,),
                                                                       (rays, C))]
    fwd = VR.volume_render(deltas, dens, steps, payload, index)
    sat = int((fwd["accumulation"] == 1.0).sum())
    empty = int((fwd["accumulation"] == 0.0).sum())
    vargs = (deltas, dens, steps, payload, index, fwd["weights"], *ups)
    clip = VR.step_bounds(steps)  # the forward's, as the autograd Function hands it on
    got, want = VR.volume_render_bwd(*vargs, clip), VR.volume_render_bwd_plain(*vargs)
    print(f"  volume_render_bwd: {sat} saturated and {empty} empty rays of {rays}")
    if sat == 0 or empty == 0:
        chk.failures.append("volume_render_bwd: no saturated or no empty ray in the check")
    chk.close("volume_render_bwd", f"d density R={rays} S={S}", got[0], want[0],
              1e-5 * float(want[0].abs().max()), 1e-4)
    chk.close("volume_render_bwd", f"d payload P={n_main} C={C}", got[1], want[1],
              1e-5 * float(want[1].abs().max()), 1e-4)
    same = all(torch.equal(a, b) for a, b in zip(got, VR.volume_render_bwd(*vargs, clip)))
    print(f"  volume_render_bwd: two calls bitwise equal {same} -> {'ok' if same else 'FAIL'}")
    if not same:
        chk.failures.append("volume_render_bwd: two calls differ")
    chk.time("volume_render_bwd", lambda: VR.volume_render_bwd(*vargs, clip),
             lambda: VR.volume_render_bwd_plain(*vargs))
    # Per sample: delta, sigma, t, w, dL/dw, the payload index and d sigma, and
    # the payload row read; per ray the upstream gradients; every row of
    # d_payload written (the padding slots' zeros too).
    chk.bounds["volume_render_bwd"] = bound(
        rays * S * (4 * 7 + C * 4) + n_main * C * 4 + rays * (C + 2) * 4,
        rays * S * (30 + 4 * C))
    Sp = cfg.num_proposal_samples_per_ray[1]
    d = torch.rand((rays, Sp), generator=gen, device=dev) * 0.05
    sg = torch.exp(torch.randn((rays, Sp), generator=gen, device=dev) * 2.0) * 4.0
    w = VR.volume_render(d, sg)["weights"]
    gw = torch.randn((rays, Sp), generator=gen, device=dev)
    args = (d, sg, None, None, None, w, gw, None, None, None)
    want = VR.volume_render_bwd_plain(*args)[0]
    chk.close("volume_render_bwd", f"d density R={rays} S={Sp} weights only",
              VR.volume_render_bwd(*args, None)[0], want, 1e-5 * float(want.abs().max()), 1e-4)
    check_k3b_long_rays(chk, long_rays(gen, 1024, C))


def check_k3b_long_rays(chk, args):
    """K3b against its plain version on long_rays' inputs (payload rows read
    from device memory), at the tolerances of the main-path check."""
    from presight_tpu_torch.ops import renderers as VR

    R, S = args[0].shape
    vargs = (*args[:5], VR.volume_render(*args[:5])["weights"], *args[5:])
    got = VR.volume_render_bwd(*vargs, VR.step_bounds(args[2]))
    want = VR.volume_render_bwd_plain(*vargs)
    for i, name in enumerate(("d density", "d payload")):
        chk.close("volume_render_bwd", f"{name} long rays R={R} S={S} C={args[3].shape[1]}",
                  got[i], want[i], 1e-5 * float(want[i].abs().max()), 1e-4)
    clip = VR.step_bounds(args[2])
    print(f"  volume_render_bwd long rays R={R} S={S}: kernel "
          f"{time_ms(lambda: VR.volume_render_bwd(*vargs, clip)):.4f} ms (device "
          f"{device_ms(lambda: VR.volume_render_bwd(*vargs, clip), kernel='volume_render_bwd'):.4f}"
          " ms)")


def synthetic_dataset(cams, num_features: int):
    """Six 225x400 views of scene()'s cameras: gradient rgb, the top quarter
    sky, low-rank f16 features (as presight_tpu/data/synthetic.py draws
    them, without image files); intrinsics scaled to the image size."""
    H, W = TRAIN_HW
    rng = np.random.RandomState(SEED)
    n = cams.num_cameras
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    rgb = np.zeros((n, H, W, 3), np.float32)
    feats = np.zeros((n, H, W, num_features), np.float16)
    for i in range(n):
        yaw = 2 * np.pi * i / n
        rgb[i] = np.stack([0.5 + 0.4 * np.sin(xx / W * 3 + yaw),
                           0.5 + 0.4 * np.cos(yy / H * 2 + i * 0.3),
                           0.4 + 0.3 * np.sin((xx + yy) / (W + H) * 4)], -1)
        basis = rng.randn(4, num_features).astype(np.float32) * 0.2 + 0.5
        coefs = np.stack([np.sin(xx / W * 2), np.cos(yy / H * 2), np.zeros_like(xx),
                          np.full_like(xx, np.sin(yaw))], -1)
        feats[i] = np.clip(coefs @ basis * 0.25 + 0.4, 0, 1).astype(np.float16)
    sky = np.zeros((n, H, W), np.float32)
    sky[:, :H // 4] = 1.0
    depth = np.full((n, H, W), -1.0, np.float32)
    scale = H / 900.0
    train_cams = dataclasses.replace(cams, fx=cams.fx * scale, fy=cams.fy * scale,
                                     cx=cams.cx * scale, cy=cams.cy * scale)
    return rgb, sky, depth, feats, train_cams


@contextlib.contextmanager
def recording_sorted_accum():
    """Keep a copy of the inputs of the last K5 launch on the main field's
    table gradient (the largest of a microbatch): the keys of a training
    microbatch cluster (a ray's samples share coarse cells), so K5's run
    lengths, and its time, differ from those of random keys."""
    from presight_tpu_torch.ops import hash_encoding as HE

    real = HE.sorted_accum
    recorded = {}

    def record(keys, rows, out, order):
        if not recorded or rows.numel() >= recorded["rows"].numel():
            parts = out if isinstance(out, (list, tuple)) else [out]
            recorded.update(keys=keys.clone(), order=order.clone(), rows=rows.clone(),
                            parts=len(parts), part_rows=parts[0].shape[0])
        return real(keys, rows, out, order)

    HE.sorted_accum = record
    try:
        yield recorded
    finally:
        HE.sorted_accum = real


def prior_gradient(keys, order, rows, num_rows):
    """A gradient for K5 to accumulate into, of the scale of the rows: half
    the table gradient of the same pairs (the plain version's), as an
    earlier microbatch over the same cells would leave. index_add_ adds the
    rows one by one into it, so a prior much larger than the rows would
    measure index_add_'s rounding, not K5's."""
    from presight_tpu_torch.ops import hash_encoding as HE

    prior = torch.zeros((num_rows, rows.shape[1]), device=rows.device)
    HE.sorted_accum_plain(keys, rows, prior, order)
    return prior.mul_(0.5)


def check_sorted_accum(chk: Checker, case, keys, order, rows, prior, part_rows):
    """K5 (sorted keys, rows through the sort's permutation, into the level
    parts of a non-zero prior gradient) against its plain version and one
    index_add_ call; two launches bitwise equal."""
    from presight_tpu_torch.ops import hash_encoding as HE

    got = prior.clone()
    HE.sorted_accum(keys, rows, list(got.split(part_rows)), order)
    want = prior.clone()
    HE.sorted_accum_plain(keys, rows, list(want.split(part_rows)), order)
    chk.close("sorted_accum", case, got, want, 1e-9, 1e-5)
    lib = prior.clone().index_add_(0, keys.long(), rows.index_select(0, order))
    chk.close("sorted_accum", f"{case} vs index_add_", got, lib, 1e-9, 1e-5)
    again = prior.clone()
    HE.sorted_accum(keys, rows, list(again.split(part_rows)), order)
    same = torch.equal(got, again)
    print(f"  sorted_accum {case}: two calls bitwise equal {same} -> {'ok' if same else 'FAIL'}")
    if not same:
        chk.failures.append(f"sorted_accum {case}: two calls differ")


def time_sorted_accum(keys, order, rows, prior, part_rows, label):
    """K5, its plain version and one index_add_ call on the same inputs, each
    accumulating into an existing output (no zero fill timed), by time_ms and
    K5 and index_add_ also by device_ms; index_add_ reads the rows already
    sorted. Also the chain torch.sort + K5 against index_add_ on K1b's
    unsorted pairs. Prints them and returns (ms, plain ms, device ms, library
    ms, bound). The bound: keys, permutation and rows read once, each
    distinct key's output row read and written."""
    from presight_tpu_torch.ops import hash_encoding as HE

    parts = list(prior.clone().split(part_rows))
    plain_parts = list(prior.clone().split(part_rows))
    lib_out = prior.clone()
    keys64, srows = keys.long(), rows.index_select(0, order)

    def kernel():
        HE.sorted_accum(keys, rows, parts, order)

    def library():
        lib_out.index_add_(0, keys64, srows)

    k_ms, p_ms = time_ms(kernel), time_ms(lambda: HE.sorted_accum_plain(keys, rows, plain_parts,
                                                                        order))
    lib_ms, lib_dev = time_ms(library), device_ms(library)
    k_dev = device_ms(kernel, kernel="sorted_accum")
    runs = torch.unique_consecutive(keys, return_counts=True)[1]
    n, C = rows.shape
    b = bound(n * 4 + n * 8 + n * C * 4 + 2 * runs.numel() * C * 4, n * C)
    unsorted = torch.empty_like(keys)
    unsorted[order] = keys
    unsorted64 = unsorted.long()

    def chain():
        k, o = torch.sort(unsorted, stable=True)
        HE.sorted_accum(k, rows, parts, o)

    reps = 10
    by_kernel = {name: 0.0 for name in KERNEL_GLOBALS["sorted_accum"]}
    for e in device_events(kernel, reps):
        for name in by_kernel:
            if name in e.name:
                by_kernel[name] += (e.time_range.end - e.time_range.start) / reps / 1e3
    chain_ms = time_ms(chain)
    lib_unsorted_ms = time_ms(lambda: lib_out.index_add_(0, unsorted64, rows))
    print(f"  sorted_accum{label}: {runs.numel()} runs of {n} rows of {C}, longest "
          f"{int(runs.max())}; kernel {k_ms:.4f} ms (device {k_dev:.4f} ms), plain {p_ms:.4f} "
          f"ms, index_add_ (sorted rows) {lib_ms:.4f} ms (device {lib_dev:.4f} ms), bound "
          f"{b[0]:.4f} ms ({b[0] / k_ms:.3f} of the kernel's ms, {b[0] / k_dev:.3f} of its "
          f"device ms); torch.sort + kernel {chain_ms:.4f} ms vs index_add_ on the unsorted "
          f"pairs {lib_unsorted_ms:.4f} ms; by kernel (device): "
          + ", ".join(f"{name} {ms:.4f} ms" for name, ms in by_kernel.items()))
    return k_ms, p_ms, k_dev, lib_ms, b


def hash_tables(tree):
    """The hash tables (leaves under a 'hash_table' key) of a parameter tree."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            if key == "hash_table":
                yield from (value if isinstance(value, (list, tuple)) else [value])
            else:
                yield from hash_tables(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from hash_tables(value)


def train_phase(aabbs, cent, cams, chk: Checker):
    """Phase 7. Returns (trainer, launches on the training path, {kernel:
    (device ms, launches) of the profiled step}, problems)."""
    from presight_tpu_torch import kernels
    from presight_tpu_torch.configs import tile_trainer_config
    from presight_tpu_torch.data.device_store import DeviceRayStore
    from presight_tpu_torch.engine.trainer import Trainer

    config = tile_trainer_config("boston-seaport", 0, "camera")
    rgb, sky, depth, feats, train_cams = synthetic_dataset(cams, config.pipeline.model.semantic_dim)
    t0 = time.perf_counter()
    store = DeviceRayStore(rgb, sky, depth, feats)
    trainer = Trainer(config, store, train_cams, aabbs, cent, num_train_cameras=len(rgb),
                      num_train_videos=1)
    torch.cuda.synchronize()
    print(f"  set-up: {len(store)} rays on the card, model and Adam state in "
          f"{time.perf_counter() - t0:.2f} s; {config.pipeline.datamanager.train_num_rays_per_batch}"
          f" rays per step in microbatches of {config.microbatch_rays}")
    problems = []
    log = []

    def report(step, m):
        rays = config.pipeline.datamanager.train_num_rays_per_batch
        losses = {k: v for k, v in m.items() if k.endswith("loss")}
        print(f"  step {step}: {m['step_seconds']:.3f} s, {rays / m['step_seconds']:.1f} rays/s, "
              f"grid refreshed={bool(m['grid_refreshed'])}, psnr={m['psnr']:.3f}, "
              + ", ".join(f"{k}={v:.6g}" for k, v in losses.items()))
        log.append(m)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with recording_sorted_accum() as recorded:
        trainer.train(num_steps=TRAIN_STEPS, callback=report)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"  launches on the training path: {launches}")
    steady = [m["step_seconds"] for m in log[1:]]
    print(f"  steady step (steps 1-{TRAIN_STEPS - 1}): median {statistics.median(steady):.4f} s, "
          f"{config.pipeline.datamanager.train_num_rays_per_batch / statistics.median(steady):.1f}"
          " rays/s")
    for m in log:
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad:
            problems.append(f"non-finite metrics {bad}")
    for name, p in trainer.model.named_parameters():
        if not bool(torch.isfinite(p).all()):
            problems.append(f"parameter {name} not finite")
    for name in KERNEL_INFO:
        if launches[name] <= 0:
            problems.append(f"{name} was not launched on the training path")
    if not recorded:
        problems.append("no K5 launch on a training microbatch was recorded")
        return trainer, launches, {}, problems
    keys, order, rows = recorded["keys"], recorded["order"], recorded["rows"]
    prior = prior_gradient(keys, order, rows, recorded["parts"] * recorded["part_rows"])
    check_sorted_accum(chk, f"training keys N={keys.numel()} C={rows.shape[1]} "
                       f"T={recorded['parts']}x{recorded['part_rows']}", keys, order, rows,
                       prior, recorded["part_rows"])
    k_ms, p_ms, k_dev, chk.library["sorted_accum"], chk.bounds["sorted_accum"] = (
        time_sorted_accum(keys, order, rows, prior, recorded["part_rows"], " on training keys"))
    chk.times["sorted_accum"], chk.device["sorted_accum"] = (k_ms, p_ms), k_dev
    problems += chk.failures
    # The tables' gradients come from K5 adding into .grad: their
    # AccumulateGrad nodes must never run.
    fired = []
    hooks = [t.register_post_accumulate_grad_hook(lambda t: fired.append(t))
             for t in hash_tables(trainer.model.params())]
    step_profile = profile_device("profiled step", lambda: trainer.train(num_steps=1),
                                  "train_profile.txt")
    step_launches = dict(kernels.LAUNCHES)
    for h in hooks:
        h.remove()
    print(f"  profiled step: AccumulateGrad ran {len(fired)} times on the {len(hooks)} hash "
          f"tables -> {'ok' if not fired else 'FAIL'}")
    if fired:
        problems.append(f"AccumulateGrad ran {len(fired)} times on the hash tables")
    step = {name: (step_profile[name][0], step_launches[name]) for name in KERNEL_INFO}
    return trainer, launches, step, problems


def profile_device(label, fn, out_name, tries: int = 5):
    """fn() under torch.profiler, between spin kernels as in device_events:
    the device's busy time and idle share of the traced wall time; the
    device time and kernel launches of each kernel of KERNEL_INFO (by its
    __global__ names, KERNEL_GLOBALS) and of memsets; the device time of the
    hash backward's and AccumulateGrad's autograd nodes (the kernels they
    launch); and the table of device time by op (written to OUT_DIR /
    out_name). Where the profiler lost events -- some kernel's main
    __global__ ran fewer or more times than its wrapper counted launches --
    fn() runs and is profiled again, up to ``tries`` runs in all, and then
    it raises. Returns {kernel: (device ms, kernel launches)}; LAUNCHES
    holds the wrapper counts of the last run."""
    from torch.profiler import ProfilerActivity, profile

    from presight_tpu_torch import kernels

    for _ in range(tries):
        torch.cuda.synchronize()
        kernels.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for _ in range(4):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type.name == "CUDA" and SPIN not in e.name]
        mains = {name: sum(KERNEL_GLOBALS[name][0] in e.name for e in events)
                 for name in KERNEL_INFO}
        lost = {name: (n, kernels.LAUNCHES[name]) for name, n in mains.items()
                if n != kernels.LAUNCHES[name]}
        if not lost:
            break
        print(f"  {label}: the profiler lost device events (kernel: (profiled, launched)) "
              f"{lost}; profiling again")
    else:
        raise RuntimeError(f"profile_device {label}: the profiler lost device events in "
                           f"{tries} runs")
    intervals = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -1.0
    for a, b in intervals:  # union of kernel intervals, us
        if b > end:
            busy += b - max(a, end)
            end = b
    print(f"  {label}: wall {wall:.3f} s (traced), device busy {busy / 1e6:.4f} s, "
          f"idle share {1.0 - busy / 1e6 / wall:.3f}")
    by_kernel = {name: [0.0, 0] for name in [*KERNEL_INFO, "memset"]}
    for e in events:
        name = next((k for k, names in KERNEL_GLOBALS.items() if any(g in e.name for g in names)),
                    "memset" if "Memset" in e.name else None)
        if name is not None:
            by_kernel[name][0] += (e.time_range.end - e.time_range.start) / 1e3
            by_kernel[name][1] += 1
    for name, (ms, calls) in by_kernel.items():
        print(f"  {label}: {name} {ms:.3f} ms device time in {calls} kernel launches "
              f"({ms / 1e3 / max(busy / 1e6, 1e-12):.3f} of device busy)")
    for avg in prof.key_averages():
        if "evaluate_function" in avg.key and ("_HashEncodeBackward" in avg.key
                                               or "AccumulateGrad" in avg.key):
            dev_us = getattr(avg, "device_time_total", None)
            dev_us = avg.cuda_time_total if dev_us is None else dev_us
            print(f"  {label}: {avg.key}: {dev_us / 1e3:.3f} ms device time in {avg.count} calls")
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    out = OUT_DIR / out_name
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(table)
    for line in table.splitlines()[:30]:
        print("   ", line)
    return {name: tuple(v) for name, v in by_kernel.items()}


def _to_cpu(obj):
    """A RayBundle or RaySamples with every tensor moved to the CPU."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).cpu() for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


@contextlib.contextmanager
def replaying_samples(mode: str, recorded: list):
    """mode 'record': keep each microbatch's ray bundle and proposal
    sampling result; 'replay': hand them, moved to the CPU, to the CPU path,
    which computes every proposal round's densities and weights itself from
    those bins. The bins are stop-gradient, so every quantity that carries
    a gradient is still computed by each path on its own."""
    from presight_tpu_torch.engine import train_step as TS
    from presight_tpu_torch.models import nerfacto_ms as NM
    from presight_tpu_torch.ops.renderers import volume_render

    real_rays, real_sample = TS.generate_rays, NM.proposal_sample

    def record_rays(cameras, ray_index):
        recorded.append(real_rays(cameras, ray_index))
        return recorded[-1]

    def record_sample(*a, **k):
        recorded.append(real_sample(*a, **k))
        return recorded[-1]

    def replay_rays(cameras, ray_index):
        return _to_cpu(recorded.pop(0))

    def replay_sample(bundle, density_fns, *a, stop_prop_grad=False, **k):
        final, _, rounds = recorded.pop(0)
        weights, samples = [], []
        for fn, rs in zip(density_fns, rounds):
            rs = _to_cpu(rs)
            density = fn(rs.positions())
            if stop_prop_grad:
                density = density.detach()
            weights.append(volume_render(rs.deltas().contiguous(), density.contiguous())["weights"])
            samples.append(rs)
        return _to_cpu(final), weights, samples

    TS.generate_rays, NM.proposal_sample = ((record_rays, record_sample) if mode == "record"
                                            else (replay_rays, replay_sample))
    try:
        yield
    finally:
        TS.generate_rays, NM.proposal_sample = real_rays, real_sample


def path_vs_plain_phase(trainer):
    """Phase 8: one step of 2048 rays (2 microbatches of 1024) on the same
    weights, batch and draws through the kernels (card) and the plain
    versions (CPU). The CPU path replays the card's ray bundles and sample
    bins: otherwise the PDF resampled from K3's weights (summed in another
    order) moves samples by rounding, and a sample within rounding of a
    hash-cell face reads the neighbouring cell (the first full run of this
    phase measured 12% relative L2 difference on the finest level's table
    gradient from that alone). The rays are ground pixels: on a sky pixel
    the sky loss is -log(1 - acc), and where a ray's accumulation is within
    1e-5 of 1 that log turns the f32 rounding of acc into a 1e-3 change of
    the loss (the first two runs of this phase: sky_loss 2.1e-3 apart,
    finest-level table gradient 9.5% in L2). Tolerances: losses rtol 1e-4,
    except the sky loss rtol 1e-3 (on ground rays it is -log(acc), about
    1 - acc for a ray within 1e-3 of saturating, so the 6e-8 rounding of acc
    is 6e-5 of it; measured 1.2e-4) and the interlevel loss rtol 2e-3 (a
    cumsum of a cumsum of the blurred histogram, with cancellation, divided
    by the proposal weight + 1e-5; the CPU tests hold the blurred values
    against JAX at 1e-5 of their largest; measured 8.0e-4);
    each gradient leaf within 1e-3 of its norm (relative L2; sums in other
    orders, and a ReLU or clip whose input sits within rounding of its
    kink), the proposal field's leaves within 1e-2 (their gradient is the
    interlevel loss's); updated parameters, where |g| is over 1e-3 of the
    leaf's largest, atol 1e-6 + rtol 1e-6 on at least 99.9% of them (the
    first Adam step is lr * sign(g + wd p))."""
    from presight_tpu_torch import bridge
    from presight_tpu_torch.engine.optimizers import make_optimizers
    from presight_tpu_torch.engine.train_step import StepScalars, train_step
    from presight_tpu_torch.models.nerfacto_ms import NerfactoNuscMS

    config = trainer.config
    mcfg = config.pipeline.model
    tree = bridge.to_numpy(trainer.model.params())
    grid = trainer.model.make_prop_grid()
    rng = np.random.RandomState(SEED + 2)
    ground = np.flatnonzero(trainer.store.sky.cpu().numpy() == 0.0)
    rows = rng.choice(ground, 2048, replace=False)
    batch = trainer.store.batch(trainer.store.ray_index(rows), with_features=True)
    draws = [[torch.from_numpy(rng.rand(1024, 1).astype(np.float32)) for _ in range(3)]
             for _ in range(2)]
    results, recorded = {}, []
    for device, mode in (("cuda", "record"), ("cpu", "replay")):
        model = NerfactoNuscMS(mcfg, bridge.from_jax_params(tree)).to(device)
        opts = make_optimizers(model.groups(), config.optimizers)
        t0 = time.perf_counter()
        with replaying_samples(mode, recorded):
            metrics = train_step(model, opts, trainer.cameras.to(device),
                                 {k: v.to(device) for k, v in batch.items()},
                                 StepScalars(0.5, 5.0, 0.0), stop_prop_grad=False,
                                 microbatch_rays=1024, prop_grid=grid.to(device),
                                 draws=[[u.to(device) for u in d] for d in draws])
        if device == "cuda":
            torch.cuda.synchronize()
        print(f"  {device}: step in {time.perf_counter() - t0:.2f} s")
        leaves = [(p.grad.cpu() if p.grad is not None else None, p.detach().cpu())
                  for p in model.leaves]
        results[device] = (metrics, leaves)
    (m_gpu, l_gpu), (m_cpu, l_cpu) = results["cuda"], results["cpu"]
    problems = []
    for key, v in m_cpu.items():
        err = abs(m_gpu[key] - v) / max(abs(v), 1e-12)
        ok = err <= {"interlevel_loss": 2e-3, "sky_loss": 1e-3}.get(key, 1e-4)
        print(f"  {key}: card {m_gpu[key]:.7g} cpu {v:.7g} rel err {err:.2e} -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            problems.append(f"{key} differs by {err:.2e}")
    worst_g, compared, off = {}, 0, 0
    labels = trainer.model.labels
    for i, ((g_gpu, p_gpu), (g_cpu, p_cpu)) in enumerate(zip(l_gpu, l_cpu)):
        if g_cpu is None:
            if g_gpu is not None or not torch.equal(p_gpu, p_cpu):
                problems.append(f"frozen leaf {i} changed")
            continue
        rel = float((g_gpu - g_cpu).norm() / g_cpu.norm().clamp_min(1e-30))
        worst_g[labels[i]] = max(worst_g.get(labels[i], 0.0), rel)
        if rel > (1e-2 if labels[i] == "proposal_networks" else 1e-3):
            problems.append(f"gradient leaf {i} {tuple(g_cpu.shape)}: relative L2 error {rel:.2e}")
        sel = g_cpu.abs() > 1e-3 * g_cpu.abs().max()
        diff = (p_gpu - p_cpu).abs()[sel]
        compared += int(sel.sum())
        off += int((diff > 1e-6 + 1e-6 * p_cpu.abs()[sel]).sum())
    print("  gradients, worst leaf relative L2 error by group: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst_g.items())
          + " (tol: fields 1e-3, proposal_networks 1e-2)")
    print(f"  updated parameters: {off} of {compared} compared elements out of tolerance "
          f"({off / max(compared, 1):.2e}, tol 1e-3)")
    if off > 1e-3 * compared:
        problems.append(f"{off} of {compared} updated parameters differ")
    return problems


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

    from presight_tpu_torch import kernels, native
    from presight_tpu_torch.configs import TILES, tile_model_config
    from presight_tpu_torch.engine.evaluator import ImageRenderer
    from presight_tpu_torch.models.nerfacto_ms import init_model
    from presight_tpu_torch.prior.extraction import extract_voxels

    # Phase 2: build.
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.lib()
    native.lib()
    print(f"phase 2: kernels (and the host voxel accumulator) built in "
          f"{time.perf_counter() - t0:.2f} s -> {lib_path.name}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    sass_report(lib_path)

    # Phase 4 set-up first: the kernel checks use the model's own tables.
    config = tile_model_config("boston-seaport", 0, "camera")
    num_experts = TILES["boston-seaport"][1]
    aabbs, cent, cams = scene(num_experts)
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    model_cpu = init_model(gen, config, aabbs, cent, NUM_CAMERAS, NUM_VIDEOS, device="cpu")
    model = init_model(torch.Generator().manual_seed(SEED), config, aabbs, cent,
                       NUM_CAMERAS, NUM_VIDEOS)
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
        print(f"  time {name}: kernel {k_ms:.4f} ms (device {chk.device[name]:.4f} ms), plain "
              f"{p_ms:.4f} ms")
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
    with recording_render_chunk(config.field.hash) as chunk_inputs:
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
    print(f"  launches on the serving path: {launches}")

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
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            problems.append(f"{name} was not launched on the serving path")
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
    render_profile = profile_device("profiled render",
                                    lambda: renderer.render(model, render_cams, 0, H, W,
                                                            prop_grid=grid),
                                    "render_profile.txt")
    render = {name: (render_profile[name][0], kernels.LAUNCHES[name]) for name in KERNEL_INFO}
    problems = check_render_chunk(chunk_inputs, chk)
    del chunk_inputs
    if problems:
        print("phase 4 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1

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
    serve_launches = launches
    del model_cpu, grid_cpu

    # Phase 6: the backward kernels against their plain versions.
    print("phase 6: backward kernels vs plain PyTorch on the card")
    check_backward_kernels(model, chk)
    torch.cuda.synchronize()
    for name, (k_ms, p_ms) in chk.times.items():
        lib = chk.library.get(name)
        b_ms, b_by = chk.bounds[name]
        print(f"  time {name}: kernel {k_ms:.4f} ms (device {chk.device[name]:.4f} ms), plain "
              f"{p_ms:.4f} ms, library {'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{b_ms:.4f} ms ({b_by})")
    if chk.failures:
        print("phase 6 FAILED:\n  " + "\n  ".join(chk.failures), file=sys.stderr)
        return 1
    del model, grid
    torch.cuda.empty_cache()

    # Phase 7: train, counted.
    print("phase 7: train")
    trainer, train_launches, step, problems = train_phase(aabbs, cent, cams, chk)
    if problems:
        print("phase 7 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1

    # Phase 8: the training kernel path against the plain path.
    print("phase 8: train step, kernel path vs plain path")
    problems = path_vs_plain_phase(trainer)
    if problems:
        print("phase 8 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": serve_launches[name] + train_launches[name],
         "launches_by_path": {"serve": serve_launches[name], "train": train_launches[name]},
         "max_abs_err": chk.errors[name], "ms": chk.times[name][0],
         "device_ms": chk.device[name], "plain_ms": chk.times[name][1],
         "bound_ms": chk.bounds[name][0],
         "bound_by": chk.bounds[name][1], "library_ms": chk.library.get(name),
         "step_ms": step[name][0], "step_launches": step[name][1],
         "render_ms": render[name][0], "render_launches": render[name][1]}
        for name, (src, replaces) in KERNEL_INFO.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
