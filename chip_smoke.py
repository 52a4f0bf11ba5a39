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
     time_ms), the kernel also by its device time (CUDA events around ten
     calls queued behind a spin kernel, the host's share left out;
     device_ms); K2 also as a chain of one-layer
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
     render twice more, the second time under torch.profiler (padded_profile,
     and profiled again where the profiler lost a kernel's events;
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
     against index_add_ on the unsorted pairs;
  8. hold the training kernel path against the plain path for one step on
     the same weights, 2048-ray batch and draws (the plain path on the CPU):
     losses, every gradient leaf and the updated parameters.
Phases 9-12 drive the reference architecture (a hash-field first proposal
round, per-expert proposal MLPs, 'corner' tables: the JAX package's
defaults):
  9. the executed reference golden (tests/goldens/full_model.npz) imported
     onto the card by engine/import_reference.py: the eval forward through
     K1-K3 under tests/test_full_model_parity.py's quantile checks, and the
     field queries at its tolerances;
 10. serve boston-seaport-camera-dino-c0 at full width from a seed, in
     scene_at_camera_height() (centroids at the cameras' height, so samples
     fall inside the experts' AABBs): one 450x800 render and one 6-camera
     extraction frame at downscale 5, as phase 4; K1-K3 launched and K4
     not; a second render, then one under torch.profiler (render_reference_ms,
     render_reference_launches); K1 (round 0's proposal field at F = 1, the
     main field at F = 4), K2 (round 0's grouped proposal MLP) and K3 (round
     0's weights at S = 128, the final render) checked and timed on the
     inputs recorded from the sixth render chunk; a 16 x 32 render against
     the same model's plain path on the CPU;
 11. train it: 5 steps of 65,536 rays in microbatches of 4096 as phase 7
     (K1, K1b, K2, K2b, K3, K3b and K5 launched, K4 not); K1b, K2b and K3b
     checked and timed on the first microbatch's recorded inputs (K3b's d
     density against the float64 formula within an f32 error bound that
     planted faults must fail: check_k3b_density), K5 on the
     recorded main-field (C = 4) and proposal-field (C = 1) pairs against
     its plain version and index_add_;
 12. one 4096-ray step (two microbatches of 2048) of it against the plain
     path on the CPU, as phase 8;
 13. one more training step of each profile under torch.profiler: the
     device's busy time and idle share, each kernel's device
     time and launches in the step (step_ms and step_launches,
     step_reference_ms and step_reference_launches), the hash backward's and
     AccumulateGrad's device time, and a check that AccumulateGrad never ran
     on a hash table (the tables go to outputs/chip_smoke/train_profile.txt
     and train_reference_profile.txt).
Phases 14-16 drive the data path from disk (everything under
outputs/chip_smoke/):
 14. the JPEG codec (presight_tpu_torch/native/jpeg.cpp) built by g++ on
     the card's host; the checked-in goldens (tests/goldens/jpeg/, written
     by tests/make_jpeg_goldens.py with Pillow) decoded to Pillow's pixels;
     the decode time of one 1600x900 image, alone and in the data
     manager's pool of threads;
 15. the 45x80 fixture written by the port's generate_scene; the
     demo-scale -tpu profile of tests/test_quality_floor.py trained 60 steps
     from it through Trainer(config) (the whole set in the device store);
     held-out PSNR >= 12 and depth RMSE <= 8 m from evaluate_images; every
     kernel launched on this path;
 16. a 180x320 fixture with 64-wide features (over the 512-MB whole-set
     cap, so the ChunkDeviceStore); scripts.train.main on
     boston-seaport-camera-dino-c0-tpu pointed at it: 3 steps saving every
     2, then resumed to 5; config.yml read back, the checkpoints saved (2,
     3, 4, 5; keep-only-latest leaves 5), finite losses, the first batch on
     the card against the CPU DataManager's rows, the resumed start step
     (3) and chunk step (seed + 3); every kernel launched on this path; the
     fixture's write time, a chunk load, the steady step from disk beside
     phase 7's in-memory step; one more step from disk under
     torch.profiler (step_disk_ms, step_disk_launches; the table goes to
     outputs/chip_smoke/train_disk_profile.txt).
 17. serve phase 16's run directory through the port's CLIs, as a user
     calls them, under torch's default TF32 flags and with LPIPS from random
     weights written in the official state_dict layout: extract_priors at
     --downscale 1, eval, render of camera 0, export pointcloud and cameras,
     each timed; the prior pickle's schema, the metrics, every PNG decoded
     by the port's reader, the PLY and the camera JSON; K1-K4 launched on
     this path; extract_priors on one frame at --downscale 2 on the card
     against the CPU (compare_priors), and LPIPS of the rendered camera
     against its image on the card against the CPU (rtol 1e-5).
 18. stage-3 occupancy serving: BEVDet-Occ at the full width of
     bevdet-occ-r50d-8x4-24e_wcamprior_randomdrop (ResNet-50 + CustomFPN,
     LSS with stereo and temporal align, 88 depth bins, a 200x200x16 grid,
     voxel prior fusion, CustomResNet3D + LSSFPN3D, 18 classes) with random
     weights from a seed, on six 256x704 cameras of a nuScenes-like rig
     (occ_rig: yaw 0, +-55, +-110 and 180 degrees, horizontal at 1.5 m) and
     priors from a dense synthetic city-prior pickle cropped and voxelized
     to the 20,000-voxel cap. Frame 1 (no history), then frame 2 (frame 1's
     stereo features, an ego motion, a seeded previous BEV), counted: S1
     (bev_pool_fwd) and S2 (stereo_cost_volume_fwd) launched; shapes,
     finite values; frame 2 against the same frame with S1's and S2's plain
     versions on the card (OCC_* tolerances, argmax agreement); S1 and S2
     checked and timed on frame 2's recorded inputs (S1's voxel set by
     points per voxel; S2's bias mask exactly, costs and softmax), beside
     their bounds (S2's from the corners this grid puts inside) and S1's
     index_add_; S1's occupied voxels and largest interval, the corner
     rows S2 loads under its reuse rule (stereo_row_fetches), and readings
     that isolate parts of their time (S1 without the nearest bins and with
     every point outside, S2 without reloads); per-frame ms (median of 5),
     peak memory and a profiled frame 2 (frame_ms, frame_launches, each
     S1 __global__'s share); phase 17's extracted_priors.pkl
     through CityPriors and VoxelizePriorPoints into one forward; the
     port's train_occ --eval-ckpt on a checkpoint in the JAX CLI's schema
     written through the inverse bridge, over 2 npz samples with priors.
     ``python3 chip_smoke.py --occupancy-only`` runs phases 1, 2, 18 and
     19 alone (the synthetic pickle standing in for phase 17's).
 19. stage-3 occupancy training: the same model in train mode from the same
     seed, on one batch of the rig (6 x 256 x 704, a seeded label volume
     with a camera mask, phase 18's synthetic priors; no previous frame, as
     the JAX CLI trains, so S2 does not run): one train_step's loss and
     every clipped gradient with the kernels against the same train_step
     under kernels.plain_versions() (OCC_* tolerances; bev_pool_v2's output
     has a grad_fn); then
     the main path, counted: 10 steps of scripts.train_occ.train_step
     (train-mode BatchNorm, occ_loss, S1b in the backward, optax's
     global-norm clipping, AdamW, the EMA), the loss falling, S1 and S1b
     launched once a step; the steady step (host clock to a synchronize,
     median of steps 2-5) and peak memory; S1b checked against
     bev_pool_v2_bwd_plain on the first step's recorded inputs and g
     (S1B_* tolerances), timed beside its bound, its plain version and
     index_select of the gathered rows; one profiled step (step_ms, step_launches); the CLI
     (train_occ --config <reference> --iters 2, then --eval-ckpt on its
     pickle).
 20. stage-3 online mapping serving: StreamMapNet at the published widths
     of smn_wcamprior_480_100x50_24e_randomdrop (6 x 480 x 800, ResNet-50
     with DCNv2 on stages 3-4, FPN, one BEVFormer layer, ConvGRU,
     PriorFusion2D, 6 decoder layers, 85.09 M parameters) with weights from
     a seed (offset biases N(0, 1), so taps fall between pixel centres), on
     phase 18's rig resized to 480x800 and 20,000 random prior voxels.
     Frame 1 from scratch, then frame 2 from its BEV and hand-off with
     every S3 launch recorded; frame 2 again, counted: msda_fwd 8 and
     deform_im2col_fwd 2 launches, nothing else; shapes and finite values;
     both frames against the same frames with S3's plain versions on the
     card (kernels.plain_versions(); MAP_REL_GAP, and equal top-k choices); each of the
     10 recorded calls (TSA, SCA, six decoder layers; the two DCNs)
     against its plain version at the cuda tests' tolerances, two calls
     bitwise equal, timed (ms, device_ms, plain_ms) beside its bound
     (s3_work), and summed for a frame; per-frame ms (median of 5), peak
     memory and a profiled frame (frame_ms, frame_launches; the SCA's
     counters, overflow 0). The forward's convolutions run on the cuDNN
     engines timed fastest at each shape; then both frames in a fresh process
     with cuDNN's heuristic choosing every engine (heuristic_mapping),
     against the tuned frames (MAP_REL_GAP, equal top-k choices), its
     per-frame ms beside, and each image-encoder convolution shape timed
     on the heuristic's plan and the tuned one (events_ms, TFLOP/s).
     ``python3 chip_smoke.py --mapping-only`` runs phases 1, 2 and 20
     alone.
Phase 3 also checks and times K1, K1b and K5 with 'shared' tables of 2^19
rows a level (bench.py's cap-log2-19 rung), K5 also against index_add_.
The line before the last is a JSON object with each kernel's launches (in
all, and by path: serve, train, serve_reference, train_reference,
train_quality, train_disk, serve_cli), error,
times (ms, plain_ms and library_ms by CUDA events around one call;
device_ms by CUDA events around ten calls queued behind a spin), bound,
and device time (torch.profiler) and launches in one training step and in
one 450x800 render of each profile, and for S1 and S2 their launches on
phase 18's frames (serve_occ) and CLI (serve_occ_cli) and their device time
in a profiled frame (frame_ms, frame_launches), and with S1b their launches
in phase 19's steps (train_occ) and CLI (train_occ_cli) and their device
time in a profiled step (step_ms, step_launches), and for S3 its launches in
phase 20's counted frame (serve_map) and its device time in a profiled
frame (frame_ms, frame_launches); the last line is {"ok": true,
"device": {...}}. Writes the prior pickles, the profile tables and phase
17's outputs under outputs/chip_smoke/.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import re
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
    # S1: the sum kernel runs once a call, after the count, scan and place passes.
    "bev_pool_fwd": ("bev_pool_sum_kernel", "bev_pool_count_kernel", "bev_pool_scan_kernel",
                     "bev_pool_place_kernel"),
    "stereo_cost_volume_fwd": ("stereo_cost_volume_kernel",),
    # S1b: one gather a call.
    "bev_pool_bwd": ("bev_pool_bwd_kernel",),
    # S3: one launch a call each.
    "msda_fwd": ("msda_fwd_kernel",),
    "deform_im2col_fwd": ("deform_im2col_kernel",),
}
# Stage 3 (occupancy serving, phase 18, and training, phase 19): hand
# kernels for the JAX package's XLA stand-ins of the reference's own CUDA
# kernels (no TPU kernel); S1b is the autodiff of S1's site.
OCC_KERNEL_INFO = {
    "bev_pool_fwd": ("presight_tpu_torch/csrc/bev_pool.cu",
                     "presight_tpu/occupancy/bev_pool.py:29"),
    "stereo_cost_volume_fwd": ("presight_tpu_torch/csrc/stereo_cost.cu",
                               "presight_tpu/occupancy/view_transformer.py:168"),
    "bev_pool_bwd": ("presight_tpu_torch/csrc/bev_pool.cu",
                     "presight_tpu/occupancy/bev_pool.py:29"),
}
OCC_SERVE_KERNELS = ("bev_pool_fwd", "stereo_cost_volume_fwd")
# Stage-3 online mapping (serving, phase 20): S3 for the JAX package's XLA
# gathers (no TPU kernel), standing in for mmcv's MSDA and DCNv2.
MAP_KERNEL_INFO = {
    "msda_fwd": ("presight_tpu_torch/csrc/deformable.cu",
                 "presight_tpu/mapping/bev_encoder.py:90"),
    "deform_im2col_fwd": ("presight_tpu_torch/csrc/deformable.cu",
                          "presight_tpu/mapping/bev_encoder.py:108"),
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
RENDER_HW = (450, 800)


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
# Host time that pads each end of a profiler session. The profiler keeps a
# device event only inside the session's window on the host's clock, and
# on an H100 it placed device events up to 13 ms before their launches in
# some sessions (launch_lead_us): sessions padded by spin kernels alone (a
# few microseconds) lost one of ten calls' events, again and again.
WINDOW_PAD_S = 0.05


def _pad_window():
    for _ in range(4):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(WINDOW_PAD_S)


@contextlib.contextmanager
def padded_profile():
    """A torch.profiler session of the CPU and the card whose calls sit
    between spin kernels (left out of every reading) and WINDOW_PAD_S of
    host time at each end."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _pad_window()
        yield prof
        torch.cuda.synchronize()
        _pad_window()


def device_of(prof):
    """A session's device events (kernels, memsets, copies), spins left out."""
    return [e for e in prof.events() if e.device_type.name == "CUDA" and SPIN not in e.name]


def launch_lead_us(prof):
    """The least time in microseconds from a host-side launch call to the
    start of the device event it launched (pairs by correlation id), over a
    session: a negative value means the profiler placed the device's clock
    ahead of the host's by at least that much. None without pairs."""
    launches = {e.id: e.time_range.start for e in prof.events()
                if e.device_type.name == "CPU" and ("Launch" in e.name or "Memset" in e.name
                                                    or "Memcpy" in e.name)}
    leads = [e.time_range.start - launches[e.id] for e in prof.events()
             if e.device_type.name == "CUDA" and e.id in launches]
    return min(leads) if leads else None


# The spin that device_ms queues its calls behind, in clock cycles
# (about 5 ms on an H100): longer than the host takes to queue ten calls.
QUEUE_SPIN_CYCLES = 10**7


def device_ms(fn, reps: int = 10, tries: int = 4) -> float:
    """Device milliseconds per call of fn(): CUDA events around ``reps``
    calls that the host queued while the card was still running a spin
    kernel, so that the card runs them back to back without waiting for the
    host. The host's share of a call (Python, a wrapper's checks and
    allocations, the launch), which time_ms counts, is left out; the gaps
    between one call's kernels on the card are counted. Where the spin had
    ended before the last call was queued (fn() waited for the card, or the
    host was slow), the spin is made four times longer, up to ``tries``
    runs, and then it raises. No profiler is involved: torch.profiler lost
    some of ten calls' device events in whole sessions, again and again."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    cycles = QUEUE_SPIN_CYCLES
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        print(f"  (device_ms: the card had finished a spin of {cycles} cycles before the host "
              f"queued {reps} calls; again with a longer spin)")
        cycles *= 4
    raise RuntimeError(f"device_ms: the card caught up with the host in {tries} runs")


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
        self.errors = {name: 0.0 for name in [*KERNEL_INFO, *OCC_KERNEL_INFO, *MAP_KERNEL_INFO]}
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
        self.device[kernel] = device_ms(run)


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
        dev = next(model.parameters()).device
        w_gpu = model(generate_rays(cams.to(dev), idx.to(dev)),
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


def k1b_bound(pos, g, keys, rows):
    """K1b's bound: positions, expert ids and the upstream gradient read,
    keys and rows written; two operations a row element."""
    return bound(pos.shape[0] * 16 + g.numel() * 4 + keys.numel() * 4 + rows.numel() * 4,
                 rows.numel() * 2)


def check_k1b(chk, case, pos, hcfg, eids, g):
    """K1b against its plain version: keys exact, rows within atol 1e-9 +
    rtol 1e-6. Returns K1b's (keys, rows)."""
    from presight_tpu_torch.ops import hash_encoding as HE

    keys, rows = HE.hash_encode_bwd(pos, hcfg, eids, g)
    pkeys, prows = HE.hash_encode_bwd_plain(pos, hcfg, eids, g)
    bad = int((keys != pkeys).sum())
    print(f"  hash_encode_bwd {case}: keys differ on {bad} of {keys.numel()} (largest key "
          f"{int(keys.max())}) -> {'ok' if bad == 0 else 'FAIL'}")
    if bad:
        chk.failures.append(f"hash_encode_bwd {case}: {bad} keys differ")
    chk.close("hash_encode_bwd", f"{case} rows", rows, prows, 1e-9, 1e-6)
    return keys, rows


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
              f"{device_ms(lambda: PF.prop_grid_density(*args)):.4f}"
              f" ms), bound {b[0]:.4f} ms ({b[1]})")


@contextlib.contextmanager
def recording_calls(specs):
    """specs: {label: (module, function name, keep, index)}. While active,
    keep a copy of the arguments of the index-th call of module.function
    for which keep(*args) is true, under its label: tensors cloned, except
    parameters (the tables), which are kept with lists and the rest as they
    are. The wrappers' call sites pass their arguments by position."""
    recorded, seen, patched = {}, collections.Counter(), []

    def wrap(label, fn, keep, index):
        def call(*args, **kwargs):
            if keep(*args):
                if seen[label] == index:
                    recorded[label] = tuple(
                        a.clone() if isinstance(a, torch.Tensor)
                        and not isinstance(a, torch.nn.Parameter) else a for a in args)
                seen[label] += 1
            return fn(*args, **kwargs)
        return call

    for label, (module, name, keep, index) in specs.items():
        real = getattr(module, name)
        patched.append((module, name, real))
        setattr(module, name, wrap(label, real, keep, index))
    try:
        yield recorded
    finally:
        for module, name, real in reversed(patched):
            setattr(module, name, real)


def plainly(fn, *args, **kwargs):
    """fn(*args, **kwargs) with the plain versions (kernels.plain_versions())."""
    from presight_tpu_torch import kernels

    with kernels.plain_versions():
        return fn(*args, **kwargs)


def recording_render_chunk(field_hash, chunk: int = 5):
    """Keep a copy of the inputs of K1 on the main field, of K3 with a
    payload (the final render) and of K4 (the first proposal round) in the
    ``chunk``-th render chunk: the positions of a render chunk lie along
    rays and the payload rows in the padded slots of real routing, unlike
    phase 3's uniform draws."""
    from presight_tpu_torch.models import nerfacto_ms as NM
    from presight_tpu_torch.ops import hash_encoding as HE
    from presight_tpu_torch.ops import renderers as VR

    return recording_calls({
        "k1": (HE, "hash_encode_fwd", lambda table, pos, cfg, *a: cfg == field_hash, chunk),
        "k3": (VR, "volume_render_fwd", lambda d, s, t=None, payload=None, *a: payload is not None,
               chunk),
        "k4": (NM, "prop_grid_density", lambda *a: True, chunk),
    })


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
          f"{device_ms(lambda: HE.hash_encode(*args)):.4f} ms), bound "
          f"{b[0]:.4f} ms ({b[1]})")
    vargs = recorded["k3"][:5]
    R, S = vargs[0].shape
    check_k3(chk, f"render chunk R={R} S={S}", vargs)
    b = k3_bound(*vargs)
    print(f"  render chunk volume_render_fwd R={R} S={S} C={vargs[3].shape[1]}: kernel "
          f"{time_ms(lambda: VR.volume_render(*vargs)):.4f} ms (device "
          f"{device_ms(lambda: VR.volume_render(*vargs)):.4f} ms), "
          f"bound {b[0]:.4f} ms ({b[1]})")
    grid, cent, aabbs, pos, res = recorded["k4"]
    k4_reading(chk, "render chunk", (grid, cent, aabbs, pos.reshape(-1, 3), res))
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
          f"{device_ms(lambda: HE.hash_encode(*l2args)):.4f} ms)")
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
          f"{device_ms(lambda: VR.volume_render(*long)):.4f} ms), "
          f"bound {k3_bound(*long)[0]:.4f} ms")


@torch.no_grad()
def check_deploy_capacity(model, chk: Checker):
    """Phase 3: K1, K1b and K5 with 'shared' tables of 2^19 rows a level
    (bench.py's cap-log2-19 rung: the -tpu main field at deploy capacity),
    against their plain versions, K5 also against index_add_; K1 at a render
    chunk's padded slots, K1b and K5 at a 1,024-ray microbatch's. Random
    tables and positions, from their own generator."""
    from presight_tpu_torch.fields.router import build_padded_routing
    from presight_tpu_torch.ops import hash_encoding as HE
    from presight_tpu_torch.ops.mlp import GROUP_BLOCK

    cfg = model.config
    cap = dataclasses.replace(cfg.field.hash, log2_hashmap_size=19)
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    E = model.params()["field"]["centroids"].shape[0]
    tables = [torch.rand((cap.table_size, cap.row_features), generator=gen, device=dev) * 2 - 1
              for _ in range(cap.num_levels)]
    label = f"shared {cap.num_levels}x{cap.features_per_level} 2^19"

    def slots(rays):
        routing = build_padded_routing(
            torch.randint(0, E, (rays * cfg.num_nerf_samples_per_ray,), generator=gen,
                          device=dev, dtype=torch.int32), E, GROUP_BLOCK)
        return (torch.rand((routing.to_slot.shape[0], 3), generator=gen, device=dev),
                routing.expert_of_slot)

    pos, eids = slots(cfg.eval_num_rays_per_chunk)
    args = (tables, pos, cap, eids)
    chk.close("hash_encode_fwd", f"{label} N={pos.shape[0]}", HE.hash_encode(*args),
              HE.hash_encode_plain(*args), 1e-7, 1e-5)
    time_line(f"hash_encode_fwd {label} N={pos.shape[0]}", lambda: HE.hash_encode(*args),
              lambda: HE.hash_encode_plain(*args), k1_bound(pos, cap, eids))

    pos, eids = slots(1024)
    n = pos.shape[0]
    g = torch.randn((n, cap.out_dim), generator=gen, device=dev) * 1e-3
    keys, rows = check_k1b(chk, f"{label} N={n}", pos, cap, eids, g)
    time_line(f"hash_encode_bwd {label} N={n}", lambda: HE.hash_encode_bwd(pos, cap, eids, g),
              lambda: HE.hash_encode_bwd_plain(pos, cap, eids, g),
              k1b_bound(pos, g, keys, rows))
    skeys, order = torch.sort(keys, stable=True)
    prior = prior_gradient(skeys, order, rows, cap.num_levels * cap.table_size)
    check_sorted_accum(chk, f"{label} N={keys.numel()} C={rows.shape[1]}", skeys, order, rows,
                       prior, cap.table_size)
    time_sorted_accum(skeys, order, rows, prior, cap.table_size, f" {label}")


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
        keys, rows = check_k1b(chk, f"{name} N={n}", pos, hcfg, eids, g)
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
            chk.bounds["hash_encode_bwd"] = k1b_bound(pos, g, keys, rows)
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
          f"{device_ms(lambda: VR.volume_render_bwd(*vargs, clip)):.4f}"
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
    """Keep a copy of the inputs of the largest K5 launch of each row width
    C (the main field's table gradient, and a proposal field's where its C
    differs): the keys of a training microbatch cluster (a ray's samples
    share coarse cells), so K5's run lengths, and its time, differ from
    those of random keys."""
    from presight_tpu_torch.ops import hash_encoding as HE

    real = HE.sorted_accum
    recorded = {}

    def record(keys, rows, out, order):
        C = rows.shape[1]
        if C not in recorded or rows.numel() >= recorded[C]["rows"].numel():
            parts = out if isinstance(out, (list, tuple)) else [out]
            recorded[C] = dict(keys=keys.clone(), order=order.clone(), rows=rows.clone(),
                               parts=len(parts), part_rows=parts[0].shape[0])
        return real(keys, rows, out, order)

    HE.sorted_accum = record
    try:
        yield recorded
    finally:
        HE.sorted_accum = real


def check_recorded_sorted_accum(chk: Checker, rec, label):
    """K5 on recorded training pairs against its plain version and one
    index_add_ call, timed (time_sorted_accum). Returns time_sorted_accum's
    numbers."""
    keys, order, rows = rec["keys"], rec["order"], rec["rows"]
    prior = prior_gradient(keys, order, rows, rec["parts"] * rec["part_rows"])
    check_sorted_accum(chk, f"{label} N={keys.numel()} C={rows.shape[1]} "
                       f"T={rec['parts']}x{rec['part_rows']}", keys, order, rows, prior,
                       rec["part_rows"])
    return time_sorted_accum(keys, order, rows, prior, rec["part_rows"], f" on {label}")


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
    k_dev = device_ms(kernel)
    runs = torch.unique_consecutive(keys, return_counts=True)[1]
    n, C = rows.shape
    b = bound(n * 4 + n * 8 + n * C * 4 + 2 * runs.numel() * C * 4, n * C)
    unsorted = torch.empty_like(keys)
    unsorted[order] = keys
    unsorted64 = unsorted.long()

    def chain():
        k, o = torch.sort(unsorted, stable=True)
        HE.sorted_accum(k, rows, parts, o)

    chain_ms = time_ms(chain)
    lib_unsorted_ms = time_ms(lambda: lib_out.index_add_(0, unsorted64, rows))
    print(f"  sorted_accum{label}: {runs.numel()} runs of {n} rows of {C}, longest "
          f"{int(runs.max())}; kernel {k_ms:.4f} ms (device {k_dev:.4f} ms), plain "
          f"{p_ms:.4f} ms, index_add_ (sorted rows) {lib_ms:.4f} ms (device {lib_dev:.4f} ms), "
          f"bound {b[0]:.4f} ms ({b[0] / k_ms:.3f} of the kernel's ms, {b[0] / k_dev:.3f} of its "
          f"device ms); torch.sort + kernel {chain_ms:.4f} ms vs index_add_ on the unsorted "
          f"pairs {lib_unsorted_ms:.4f} ms")
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


def train_phase(config, aabbs, cent, cams, expected, record_specs=None):
    """Phases 7 and 11: TRAIN_STEPS steps of the Trainer on the synthetic
    set. Fails unless every kernel of ``expected`` was launched on the
    training path and no other. Returns (trainer, launches on the training
    path, the recorded K5 inputs by row width, the calls recorded by
    ``record_specs`` (recording_calls), problems, the median steady step in
    seconds)."""
    from presight_tpu_torch import kernels
    from presight_tpu_torch.data.device_store import DeviceRayStore
    from presight_tpu_torch.engine.trainer import Trainer

    rgb, sky, depth, feats, train_cams = synthetic_dataset(cams, config.pipeline.model.semantic_dim)
    t0 = time.perf_counter()
    store = DeviceRayStore(rgb, sky, depth, feats)
    trainer = Trainer.in_memory(config, store, train_cams, aabbs, cent,
                                num_train_cameras=len(rgb),
                      num_train_videos=1)
    torch.cuda.synchronize()
    rays = config.pipeline.datamanager.train_num_rays_per_batch
    print(f"  set-up: {len(store)} rays on the card, model and Adam state in "
          f"{time.perf_counter() - t0:.2f} s; {rays} rays per step in microbatches of "
          f"{config.microbatch_rays}")
    problems = []
    log = []

    def report(step, m):
        losses = {k: v for k, v in m.items() if k.endswith("loss")}
        print(f"  step {step}: {m['step_seconds']:.3f} s, {rays / m['step_seconds']:.1f} rays/s, "
              f"grid refreshed={bool(m['grid_refreshed'])}, psnr={m['psnr']:.3f}, "
              + ", ".join(f"{k}={v:.6g}" for k, v in losses.items()))
        log.append(m)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with recording_sorted_accum() as recorded, recording_calls(record_specs or {}) as calls:
        trainer.train(num_steps=TRAIN_STEPS, callback=report)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"  launches on the training path: {launches}")
    steady = [m["step_seconds"] for m in log[1:]]
    print(f"  steady step (steps 1-{TRAIN_STEPS - 1}): median {statistics.median(steady):.4f} s, "
          f"{rays / statistics.median(steady):.1f} rays/s")
    for m in log:
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad:
            problems.append(f"non-finite metrics {bad}")
    for name, p in trainer.model.named_parameters():
        if not bool(torch.isfinite(p).all()):
            problems.append(f"parameter {name} not finite")
    for name in KERNEL_INFO:
        if (launches[name] > 0) != (name in expected):
            problems.append(f"{name} was launched {launches[name]} times on the training path")
    if not recorded:
        problems.append("no K5 launch on a training microbatch was recorded")
    return trainer, launches, recorded, calls, problems, statistics.median(steady)


def profile_step(trainer, label, out_name):
    """One more training step under torch.profiler (``label``; the table
    goes to OUT_DIR/out_name), with a check that AccumulateGrad never ran on
    a hash table. Returns ({kernel: (device ms, launches) of the
    step}, problems)."""
    from presight_tpu_torch import kernels

    # The tables' gradients come from K5 adding into .grad: their
    # AccumulateGrad nodes must never run.
    fired = []
    hooks = [t.register_post_accumulate_grad_hook(lambda t: fired.append(t))
             for t in hash_tables(trainer.model.params())]
    step_profile = profile_device(f"profiled {label}", lambda: trainer.train(num_steps=1),
                                  out_name)
    step_launches = dict(kernels.LAUNCHES)
    for h in hooks:
        h.remove()
    print(f"  profiled {label}: AccumulateGrad ran {len(fired)} times on the {len(hooks)} hash "
          f"tables -> {'ok' if not fired else 'FAIL'}")
    problems = [f"AccumulateGrad ran {len(fired)} times on the hash tables"] if fired else []
    return {name: (step_profile[name][0], step_launches[name]) for name in KERNEL_INFO}, problems


def profile_device(label, fn, out_name, tries: int = 5, names=tuple(KERNEL_INFO)):
    """fn() in a padded_profile session:
    the device's busy time and idle share of the traced wall time; the
    device time and kernel launches of each kernel of ``names`` (stage 2's
    KERNEL_INFO by default; by its __global__ names, KERNEL_GLOBALS) and of
    memsets; the device time of the
    hash backward's and AccumulateGrad's autograd nodes (the kernels they
    launch); and the table of device time by op (written to OUT_DIR /
    out_name). Where the profiler lost events -- some kernel's main
    __global__ ran fewer or more times than its wrapper counted launches --
    fn() runs and is profiled again, up to ``tries`` runs in all, and then
    it raises. Returns {kernel: (device ms, kernel launches)}; LAUNCHES
    holds the wrapper counts of the last run."""
    from presight_tpu_torch import kernels

    for _ in range(tries):
        torch.cuda.synchronize()
        kernels.reset_launches()
        with padded_profile() as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = device_of(prof)
        mains = {name: sum(KERNEL_GLOBALS[name][0] in e.name for e in events) for name in names}
        lost = {name: (n, kernels.LAUNCHES[name]) for name, n in mains.items()
                if n != kernels.LAUNCHES[name]}
        if not lost:
            break
        print(f"  {label}: the profiler lost device events (kernel: (profiled, launched)) "
              f"{lost}; least launch-to-start lead {launch_lead_us(prof)} us; profiling again")
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
          f"idle share {1.0 - busy / 1e6 / wall:.3f}; least launch-to-start lead "
          f"{launch_lead_us(prof)} us")
    by_kernel = {name: [0.0, 0] for name in [*names, "memset"]}
    for e in events:
        name = next((k for k in names if any(g in e.name for g in KERNEL_GLOBALS[k])),
                    "memset" if "Memset" in e.name else None)
        if name is not None:
            by_kernel[name][0] += (e.time_range.end - e.time_range.start) / 1e3
            by_kernel[name][1] += 1
    for name, (ms, calls) in by_kernel.items():
        print(f"  {label}: {name} {ms:.3f} ms device time in {calls} kernel launches "
              f"({ms / 1e3 / max(busy / 1e6, 1e-12):.3f} of device busy)")
    parts = collections.defaultdict(lambda: [0.0, 0])  # a wrapper's time by __global__
    for e in events:
        name = next((k for k in names if any(g in e.name for g in KERNEL_GLOBALS[k])), None)
        found = re.search(r"(\w+)(?:<[^>]*>)?\(", e.name)
        if name is not None and found:
            parts[name, found.group(1)][0] += (e.time_range.end - e.time_range.start) / 1e3
            parts[name, found.group(1)][1] += 1
    for name in names:
        mine = {g: v for (k, g), v in parts.items() if k == name}
        if len(mine) > 1:
            print(f"  {label}: {name} by __global__: " + ", ".join(
                f"{g} {ms:.4f} ms / {calls}" for g, (ms, calls) in sorted(mine.items())))
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


def path_vs_plain_phase(trainer, rays: int, micro: int):
    """Phases 8 and 12: one step of ``rays`` rays (microbatches of
    ``micro``) on the same weights, batch and draws through the kernels
    (card) and the plain versions (CPU). The CPU path replays the card's ray bundles and sample
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
    rows = rng.choice(ground, rays, replace=False)
    batch = trainer.store.batch(trainer.store.ray_index(rows), with_features=True)
    rounds = len(mcfg.num_proposal_samples_per_ray) + 1
    draws = [[torch.from_numpy(rng.rand(micro, 1).astype(np.float32)) for _ in range(rounds)]
             for _ in range(rays // micro)]
    results, recorded = {}, []
    for device, mode in (("cuda", "record"), ("cpu", "replay")):
        model = NerfactoNuscMS(mcfg, bridge.from_jax_params(tree)).to(device)
        opts = make_optimizers(model.groups(), config.optimizers)
        t0 = time.perf_counter()
        with replaying_samples(mode, recorded):
            metrics = train_step(model, opts, trainer.cameras.to(device),
                                 {k: v.to(device) for k, v in batch.items()},
                                 StepScalars(0.5, 5.0, 0.0), stop_prop_grad=False,
                                 microbatch_rays=micro,
                                 prop_grid=None if grid is None else grid.to(device),
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


# The executed reference golden and its generator's config
# (tests/test_full_model_parity.py; tests/test_torch_reference_model.py).
REFERENCE_KERNELS = ("hash_encode_fwd", "mlp_blocks_fwd", "volume_render_fwd", "hash_encode_bwd",
                     "mlp_blocks_bwd", "volume_render_bwd", "sorted_accum")


@torch.no_grad()
def golden_phase():
    """Phase 9: the executed reference golden imported onto the card by the
    port's importer; the eval forward through the kernels under the golden
    test's quantile checks, and the field queries at its rtol and atol (the
    card tests' helpers, tests/test_torch_cuda.py, hold both). Returns
    (launches of the forward, problems)."""
    from presight_tpu_torch import kernels
    from presight_tpu_torch.engine.import_reference import import_reference_state_dict
    from presight_tpu_torch.models.nerfacto_ms import NerfactoNuscMS

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda import (golden_bundle, golden_forward_report, golden_query_report,
                                 load_golden)

    state, io, cfg = load_golden()
    model = NerfactoNuscMS(cfg, import_reference_state_dict(state, cfg))
    bundle = golden_bundle(io, "cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = model(bundle, train=False, stop_prop_grad=True)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"  {len(io['origins'])} rays, {cfg.prop(0).hash.num_levels}-level proposal fields with "
          f"per-expert {cfg.prop(0).hash.out_dim}-64-1 MLPs, 'corner' tables; launches of the "
          f"forward: {launches}")
    out = {k: v.cpu().numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}
    report = golden_forward_report(out, io, cfg.far_plane) + golden_query_report(model, io)
    for line, ok in report:
        print(f"  {line} -> {'ok' if ok else 'FAIL'}")
    problems = [line for line, ok in report if not ok]
    for name in ("hash_encode_fwd", "mlp_blocks_fwd", "volume_render_fwd"):
        if launches[name] <= 0:
            problems.append(f"{name} was not launched on the golden's forward")
    return launches, problems


def scene_at_camera_height(num_experts: int):
    """scene() with every centroid and AABB raised to the cameras' height,
    so that the rays' samples fall inside the experts' AABBs."""
    aabbs, cent, cams = scene(num_experts)
    shift = np.array([0.0, 0.0, float(cams.c2w[0, 2, 3]) - float(cent[0, 2])], np.float32)
    return aabbs + shift, cent + shift, cams


def extraction_inputs(config):
    """Six 1600x900 cameras' items and a random DINO-to-RGB projection, the
    inputs of extract_voxels besides the model and cameras."""
    items = [SimpleNamespace(H=900, W=1600, seg_path=None) for _ in range(6)]
    dino_rng = np.random.RandomState(SEED)
    dino_to_rgb = {"reduction_matrix": dino_rng.randn(config.semantic_dim, 3).astype(np.float32),
                   "mean": np.full(config.semantic_dim, 0.5, np.float32),
                   "rgb_min": np.full(3, -2.0, np.float32),
                   "rgb_max": np.full(3, 2.0, np.float32)}
    return items, dino_to_rgb


def serve_problems(img, result, config, H, W):
    """Finite render outputs of the expected shapes, and the prior pickle's
    schema with finite values."""
    problems = []
    for key, v in img.items():
        if not np.isfinite(v).all():
            problems.append(f"render {key} not finite")
    if img["rgb"].shape != (H, W, 3) or img["semantics"].shape != (H, W, config.semantic_dim):
        problems.append(f"render shapes {img['rgb'].shape} {img['semantics'].shape}")
    return problems + pickle_problems(result, config)


def pickle_problems(result, config):
    """The prior pickle's schema, finite values, not empty."""
    problems = []
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
    return problems


def time_line(label, run, plain, b):
    """One kernel's times on recorded inputs: CUDA events and device time of
    the wrapper, events of the plain version, beside its bound."""
    print(f"  {label}: kernel {time_ms(run):.4f} ms (device "
          f"{device_ms(run):.4f} ms), plain {time_ms(plain):.4f} ms, "
          f"bound {b[0]:.4f} ms ({b[1]})")


@torch.no_grad()
def check_reference_chunk(recorded, chk: Checker):
    """K1 (round 0's proposal field at F = 1, the main field at F = 4), K2
    (round 0's grouped proposal MLP) and K3 (round 0's weights at S = 128,
    the final render with its payload) on the inputs recorded from one
    render chunk of the reference architecture, against their plain
    versions, timed beside their bounds. Returns problems."""
    from presight_tpu_torch.ops import hash_encoding as HE
    from presight_tpu_torch.ops import mlp as M
    from presight_tpu_torch.ops import renderers as VR

    labels = ["k1_main", "k1_round0", "k2_round0", "k3_round0", "k3_final"]
    if sorted(recorded) != sorted(labels):
        return [f"reference render chunk not recorded (got {sorted(recorded)})"]
    failures = len(chk.failures)
    for label in ("k1_round0", "k1_main"):
        args = recorded[label]
        hcfg, n = args[2], args[1].shape[0]
        case = f"reference chunk {label} {hcfg.num_levels}x{hcfg.features_per_level}F N={n}"
        chk.close("hash_encode_fwd", case, HE.hash_encode(*args), HE.hash_encode_plain(*args),
                  1e-7, 1e-5)
        time_line(f"hash_encode_fwd {case}", lambda: HE.hash_encode(*args),
                  lambda: HE.hash_encode_plain(*args), k1_bound(*args[1:]))
    layers, h, be, sig = recorded["k2_round0"]
    layers = [(w.detach(), b.detach()) for w, b in layers]
    case = (f"reference chunk round-0 proposal {h.shape[1]}-64-1 N={h.shape[0]} "
            f"E={layers[0][0].shape[0]}")
    chk.close("mlp_blocks_fwd", case, M.mlp_blocks_fwd(layers, h, be, sig),
              M.apply_mlp_blocks_plain(layers, h, be, sig), 1e-5, 1e-4)
    k2_masks(chk, case, layers, h, be, sig)
    time_line(f"mlp_blocks_fwd {case}", lambda: M.mlp_blocks_fwd(layers, h, be, sig),
              lambda: M.apply_mlp_blocks_plain(layers, h, be, sig),
              bound(*mlp_work(layers, h.shape[0], 2), TC_F32_FLOPS_PER_S))
    d, sg = recorded["k3_round0"][:2]
    case = f"reference chunk round-0 weights R={d.shape[0]} S={d.shape[1]}"
    chk.close("volume_render_fwd", case, VR.volume_render(d, sg)["weights"],
              VR.volume_render_plain(d, sg)["weights"], 1e-5, 1e-5)
    R, S = d.shape
    time_line(f"volume_render_fwd {case}", lambda: VR.volume_render(d, sg),
              lambda: VR.volume_render_plain(d, sg),
              bound(R * S * 12, R * S * 12))
    vargs = recorded["k3_final"][:5]
    R, S = vargs[0].shape
    case = f"reference chunk final R={R} S={S} C={vargs[3].shape[1]}"
    check_k3(chk, case, vargs)
    time_line(f"volume_render_fwd {case}", lambda: VR.volume_render(*vargs),
              lambda: VR.volume_render_plain(*vargs), k3_bound(*vargs))
    return chk.failures[failures:]


def serve_reference_phase(chk: Checker):
    """Phase 10: boston-seaport-camera-dino-c0 (the reference architecture)
    at full width from a seed, in scene_at_camera_height(): render one
    450x800 camera (recording the inputs of K1, K2 and K3 in its sixth
    chunk) and extract one 6-camera frame at downscale 5; finite outputs,
    the pickle schema, K1-K3 launched and K4 not; render again, then under
    torch.profiler; the kernels on the recorded chunk; a 16 x 32 render
    against the same model's plain path on the CPU. Returns ({kernel:
    (device ms, launches) of the profiled render}, launches on the serving
    path, problems)."""
    from presight_tpu_torch import kernels
    from presight_tpu_torch.configs import TILES, tile_model_config
    from presight_tpu_torch.engine.evaluator import ImageRenderer
    from presight_tpu_torch.models import nerfacto_ms as NM
    from presight_tpu_torch.ops import hash_encoding as HE
    from presight_tpu_torch.ops import mlp as M
    from presight_tpu_torch.ops import renderers as VR
    from presight_tpu_torch.prior.extraction import extract_voxels

    config = tile_model_config("boston-seaport", 0, "camera", tpu=False)
    aabbs, cent, cams = scene_at_camera_height(TILES["boston-seaport"][1])
    t0 = time.perf_counter()
    model = NM.init_model(torch.Generator().manual_seed(SEED), config, aabbs, cent, NUM_CAMERAS,
                          NUM_VIDEOS)
    torch.cuda.synchronize()
    print(f"  model boston-seaport-camera-dino-c0: {cent.shape[0]} experts, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters, init "
          f"{time.perf_counter() - t0:.2f} s; centroids at z = {float(cent[0, 2]):g}")
    renderer = ImageRenderer(config)
    H, W = RENDER_HW
    render_cams = cams.to("cuda")
    render_cams.fx, render_cams.fy = render_cams.fx * 0.5, render_cams.fy * 0.5
    render_cams.cx, render_cams.cy = render_cams.cx * 0.5, render_cams.cy * 0.5
    items, dino_to_rgb = extraction_inputs(config)
    chunk, prop_in = 5, config.prop(0).hash.out_dim
    specs = {
        "k1_main": (HE, "hash_encode_fwd", lambda t, p, c, *a: c == config.field.hash, chunk),
        "k1_round0": (HE, "hash_encode_fwd", lambda t, p, c, *a: c == config.prop(0).hash, chunk),
        # rounds 0 and 1 alternate: the (2 chunk)-th is round 0 of the chunk
        "k2_round0": (M, "mlp_blocks_fwd", lambda layers, h, be, *a: (
            be is not None and h.shape[1] == prop_in and layers[-1][0].shape[-1] == 1), 2 * chunk),
        "k3_round0": (VR, "volume_render_fwd", lambda d, s, t=None, payload=None, *a: (
            payload is None and d.shape[1] == config.num_proposal_samples_per_ray[0]), chunk),
        "k3_final": (VR, "volume_render_fwd", lambda d, s, t=None, payload=None, *a: (
            payload is not None), chunk),
    }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with recording_calls(specs) as recorded:
        img = renderer.render(model, render_cams, 0, H, W)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = extract_voxels(
        model, items, cams.to("cuda"), pose_scale_factor=config.pose_scale_factor,
        origin=np.zeros(3, np.float32), dino_to_rgb=dino_to_rgb, output_dir=OUT_DIR / "reference",
        camera_scaling_factor=0.2, min_depth=0.0, max_depth=1e9, density_threshold=1e-6,
        z_bounds=(-1e9, 1e9), use_segmentation_mask=False)
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_rays = H * W
    print(f"  render {H}x{W}: {n_rays} rays in {t_render:.3f} s ({n_rays / t_render:.1f} rays/s; "
          f"{-(-n_rays // renderer.chunk)} chunks of {renderer.chunk})")
    print(f"  extraction: 6 cameras at downscale 5 in {t_extract:.3f} s, "
          f"{len(result['points'])} voxels")
    print(f"  launches on the reference serving path: {launches}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    problems = serve_problems(img, result, config, H, W)
    for name in SERVE_KERNELS:
        if (launches[name] > 0) != (name != "prop_grid_density_fwd"):
            problems.append(f"{name} was launched {launches[name]} times on the serving path")
    if problems:
        return {}, launches, problems
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renderer.render(model, render_cams, 0, H, W)
    torch.cuda.synchronize()
    t_render2 = time.perf_counter() - t0
    print(f"  render again: {t_render2:.3f} s ({n_rays / t_render2:.1f} rays/s)")
    profile = profile_device("profiled reference render",
                             lambda: renderer.render(model, render_cams, 0, H, W),
                             "render_reference_profile.txt")
    render = {name: (profile[name][0], kernels.LAUNCHES[name]) for name in KERNEL_INFO}
    problems = check_reference_chunk(recorded, chk)
    del recorded
    # The kernel path against the plain path: a 16 x 32 render of camera 0
    # at the same field of view, the same weights on the CPU.
    t0 = time.perf_counter()
    model_cpu = NM.init_model(torch.Generator().manual_seed(SEED), config, aabbs, cent,
                              NUM_CAMERAS, NUM_VIDEOS, device="cpu")
    small = ImageRenderer(config, chunk=256)
    small_cams = cams.to("cpu")
    scale = 16 / 900
    small_cams.fx, small_cams.fy = small_cams.fx * scale, small_cams.fy * scale
    small_cams.cx, small_cams.cy = small_cams.cx * scale, small_cams.cy * scale
    out_gpu = small.render(model, small_cams.to("cuda"), 0, 16, 32)
    out_cpu = small.render(model_cpu, small_cams, 0, 16, 32)
    print(f"  small render on the CPU (plain path) in {time.perf_counter() - t0:.2f} s, "
          "model init included")
    for key in ("rgb", "accumulation", "expected_depth", "semantics"):
        err = float(np.abs(out_gpu[key] - out_cpu[key]).max())
        ok = err <= 1e-4
        print(f"  {key}: max_abs_err={err:.3e} (tol 1e-4) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            problems.append(f"small render {key} differs by {err}")
    problems += median_depth_ties(model, model_cpu, small_cams, None, None, out_gpu["depth"],
                                  out_cpu["depth"], small.chunk)
    return render, launches, problems


U32 = 2.0 ** -24  # f32's unit roundoff


def k3b_density_bound(deltas, density, steps, payload, payload_index, weights, g_weights,
                      g_acc, g_expected, g_composite):
    """(d density by the plain formula in float64, a bound on each element's
    error in any f32 evaluation). d sigma_j = delta_j (gw_j T_j e_j -
    sum_{s>j} gw_s alpha_s T_s), e = exp(-dd), alpha = 1 - e: each of gw's
    C + 4 addends, the suffix sum's S terms and T_s = exp(-sum_{k<s} dd_k)
    are rounded, so to first order the error is at most (S + C + 8) u times
    the same formula over absolute values, with gw's addends taken by their
    absolute values, T's relative error scaled by (1 + its exponent) and
    alpha's absolute error (u e) counted, plus (S + C + 8) times the
    absolute error of values flushed below f32's normal range. On a
    saturated sky ray a large
    dL/dacc makes the two sums cancel to ~1e-7 of their terms, and there the
    bound exceeds the value: no f32 evaluation can be held closer."""
    from presight_tpu_torch.ops import renderers as VR

    args = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a
            for a in (deltas, density, steps, payload, payload_index, weights, g_weights,
                      g_acc, g_expected, g_composite)]
    exact = VR.volume_render_bwd_plain(*args)[0]
    deltas, density, steps, payload, payload_index, weights, g_weights, g_acc, g_expected, \
        g_composite = args
    r, s = deltas.shape
    dd = deltas * density
    e = torch.exp(-dd)
    alpha = 1.0 - e
    csum = torch.cat([torch.zeros_like(dd[:, :1]), torch.cumsum(dd[:, :-1], -1)], -1)
    trans = torch.exp(-csum)
    gabs = g_weights.abs()
    if steps is not None:
        b = weights.sum(-1) + 1e-10
        a = (weights * steps).sum(-1)
        lo, hi = torch.aminmax(steps)
        ge = (g_expected * VR._clip_grad(a / b, lo, hi)).abs()
        gabs = gabs + (g_acc.abs() + ge * a.abs() / (b * b))[:, None] + (ge / b)[:, None] * steps.abs()
    c = 0
    if payload is not None:
        c = payload.shape[1]
        index = (torch.arange(r * s, device=deltas.device) if payload_index is None
                 else payload_index.long())
        gabs = gabs + (payload[index].reshape(r, s, c) * g_composite[:, None, :]).abs().sum(-1)
    gabs = torch.where(torch.isfinite(alpha * trans), gabs, torch.zeros_like(gabs))
    # T_s is 0 wherever its exponent is huge: (1 + csum) T then is 0 too.
    own = torch.nan_to_num(gabs * trans * e * (1.0 + csum + dd))
    q = torch.nan_to_num(gabs * trans * (alpha * (1.0 + csum) + e))
    def suffix(x):  # sum over s > j
        x = torch.flip(torch.cumsum(torch.flip(x[:, 1:], [-1]), -1), [-1])
        return torch.cat([x, torch.zeros_like(x[:, :1])], -1)

    # Where T or a product leaves f32's normal range, it may flush to 0: an
    # absolute error of up to 2^-126 in each.
    floor = 2.0 ** -126 * (1.0 + deltas.abs() * (gabs + suffix(gabs)))
    return exact, (s + c + 8) * (U32 * deltas.abs() * (own + suffix(q)) + floor)


def check_k3b_density(chk, case, args, got):
    """K3b's d density ``got`` on the plain version's arguments ``args``
    against the float64 formula, element by element within
    k3b_density_bound. The plain f32 version must meet the bound too (a
    second witness that it is not too tight), and planted faults must each
    fail it: d density x 0.9, zeros, and every value moved one sample along
    its ray. Failures go to chk."""
    from presight_tpu_torch.ops import renderers as VR

    exact, tol = k3b_density_bound(*args)
    plain = VR.volume_render_bwd_plain(*args)[0]

    def out_of_bound(x):
        return int(((x.double() - exact).abs() > tol).sum())

    n = exact.numel()
    blind = (exact.abs() <= tol)
    err = (got.double() - exact).abs()
    chk.errors["volume_render_bwd"] = max(chk.errors["volume_render_bwd"], float(err.max()))
    print(f"  volume_render_bwd d density {case} vs float64: largest |d density| "
          f"{float(exact.abs().max()):.3e}; the bound is under |d density| on {n - int(blind.sum())} "
          f"of {n} elements (a zero passes on {int(blind.sum())}, on "
          f"{int(blind.any(-1).sum())} of {exact.shape[0]} rays)")
    for name, x, must_pass in (("kernel", got, True), ("plain f32 version", plain, True),
                               ("planted fault x 0.9", got * 0.9, False),
                               ("planted fault zeros", torch.zeros_like(got), False),
                               ("planted fault one sample along", torch.roll(got, 1, -1), False)):
        bad = out_of_bound(x)
        ratio = float(((x.double() - exact).abs() / tol.clamp_min(1e-300)).max())
        ok = (bad == 0) == must_pass
        print(f"  volume_render_bwd d density {case}: {name} out of the bound on {bad} elements "
              f"(largest error / bound {ratio:.3g}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            chk.failures.append(f"volume_render_bwd d density {case}: {name} "
                                f"{'fails' if must_pass else 'passes'} the float64 check")


@torch.no_grad()
def check_recorded_backward(calls, chk: Checker):
    """K1b (the main field's 'corner' table gradient), K2b (a grouped
    proposal MLP, on K2's own ReLU masks) and K3b (the final render) on the
    inputs recorded from the first microbatch of the reference training
    path, against their plain versions, timed. Returns problems."""
    from presight_tpu_torch.ops import hash_encoding as HE
    from presight_tpu_torch.ops import mlp as M
    from presight_tpu_torch.ops import renderers as VR

    if sorted(calls) != ["k1b", "k2b", "k3b"]:
        return [f"reference training microbatch not recorded (got {sorted(calls)})"]
    failures = len(chk.failures)
    pos, hcfg, eids, g = calls["k1b"]
    case = (f"reference microbatch {hcfg.storage} {hcfg.num_levels}x{hcfg.features_per_level}F "
            f"N={pos.shape[0]}")
    keys, rows = check_k1b(chk, case, pos, hcfg, eids, g)
    time_line(f"hash_encode_bwd {case}", lambda: HE.hash_encode_bwd(pos, hcfg, eids, g),
              lambda: HE.hash_encode_bwd_plain(pos, hcfg, eids, g),
              k1b_bound(pos, g, keys, rows))
    layers, h, be, sig, g = calls["k2b"]
    layers = [(w.detach(), b.detach()) for w, b in layers]
    case = (f"reference microbatch proposal {h.shape[1]}-64-1 N={h.shape[0]} "
            f"E={layers[0][0].shape[0]}")
    masks = k2_masks(chk, case, layers, h, be, sig)
    dx, grads = M.mlp_blocks_bwd(layers, h, be, sig, g)
    pdx, pgrads = M.mlp_blocks_bwd_plain(layers, h, be, sig, g, relu_masks=masks)
    chk.close("mlp_blocks_bwd", f"{case} dX", dx, pdx, 1e-5 * float(pdx.abs().max()), 1e-4)
    for i, ((dw, db), (pw, pb)) in enumerate(zip(grads, pgrads)):
        chk.close("mlp_blocks_bwd", f"{case} dW[{i}]", dw, pw, 1e-5 * float(pw.abs().max()), 1e-4)
        chk.close("mlp_blocks_bwd", f"{case} db[{i}]", db, pb, 1e-5 * float(pb.abs().max()), 1e-4)
    time_line(f"mlp_blocks_bwd {case}", lambda: M.mlp_blocks_bwd(layers, h, be, sig, g),
              lambda: M.mlp_blocks_bwd_plain(layers, h, be, sig, g),
              bound(*mlp_work(layers, h.shape[0], 6), TC_F32_FLOPS_PER_S))
    vargs = calls["k3b"]
    got, want = VR.volume_render_bwd(*vargs), VR.volume_render_bwd_plain(*vargs[:-1])
    R, S = vargs[0].shape
    C = vargs[3].shape[1]
    case = f"reference microbatch final R={R} S={S} C={C}"
    check_k3b_density(chk, case, vargs[:-1], got[0])
    chk.close("volume_render_bwd", f"d payload {case}", got[1], want[1],
              1e-5 * float(want[1].abs().max()), 1e-4)
    time_line(f"volume_render_bwd {case}", lambda: VR.volume_render_bwd(*vargs),
              lambda: VR.volume_render_bwd_plain(*vargs[:-1]),
              bound(R * S * (4 * 7 + C * 4) + vargs[3].shape[0] * C * 4 + R * (C + 2) * 4,
                    R * S * (30 + 4 * C)))
    return chk.failures[failures:]


def train_reference_phase(chk: Checker):
    """Phase 11: the Trainer on boston-seaport-camera-dino-c0 at full width
    (65,536 rays a step in microbatches of 4096) in scene_at_camera_height(),
    as phase 7 trains the -tpu profile; K1b, K2b and K3b checked on the
    first microbatch's recorded inputs, K5 on the recorded main-field (C =
    4) and proposal-field (C = 1) pairs, against plain and index_add_.
    Returns (trainer, launches on the training path, problems)."""
    from presight_tpu_torch.configs import TILES, tile_trainer_config
    from presight_tpu_torch.ops import hash_encoding as HE
    from presight_tpu_torch.ops import mlp as M
    from presight_tpu_torch.ops import renderers as VR

    config = tile_trainer_config("boston-seaport", 0, "camera", tpu=False)
    mcfg = config.pipeline.model
    aabbs, cent, cams = scene_at_camera_height(TILES["boston-seaport"][1])
    prop_in = mcfg.prop(0).hash.out_dim
    specs = {
        "k1b": (HE, "hash_encode_bwd", lambda p, c, *a: c == mcfg.field.hash, 0),
        "k2b": (M, "mlp_blocks_bwd", lambda layers, h, be, *a: (
            be is not None and h.shape[1] == prop_in and layers[-1][0].shape[-1] == 1), 0),
        "k3b": (VR, "volume_render_bwd", lambda d, s, t, payload, *a: payload is not None, 0),
    }
    trainer, launches, recorded, calls, problems, _ = train_phase(
        config, aabbs, cent, cams, REFERENCE_KERNELS, specs)
    if problems:
        return trainer, launches, problems
    failures = len(chk.failures)
    check_recorded_backward(calls, chk)
    problems = []
    del calls
    widths = {mcfg.field.hash.features_per_level, mcfg.prop(0).hash.features_per_level}
    if set(recorded) != widths:
        problems.append(f"K5 inputs recorded at C = {sorted(recorded)}, not {sorted(widths)}")
    for C in sorted(recorded, reverse=True):
        check_recorded_sorted_accum(chk, recorded.pop(C), f"reference training keys C={C}")
        torch.cuda.empty_cache()
    return trainer, launches, problems + chk.failures[failures:]


# Phases 14-16: the data path from disk (image codec, chunked dataset, data
# manager, device stores, config.yml, checkpoints and the train CLI).
REPO = Path(__file__).resolve().parent
GOLDENS = REPO / "tests" / "goldens" / "jpeg"
NUSCENES_HW = (900, 1600)
QUALITY_ITERS = 60
# The demo-scale -tpu profile of the quality floor (tests/test_quality_floor.py:
# presight_tpu/scripts/quality_study.py variant_model(synthetic-demo's model,
# "grid-n48-cap4x-p64x32")), held against it by tests/test_torch_trainer_disk.py.
QUALITY_VARIANT = dict(
    num_levels=4, features_per_level=3, num_proposal_samples_per_ray=(64, 32),
    num_nerf_samples_per_ray=48,
    proposal_net_args_list=(
        dict(features_per_level=4, log2_hashmap_size=10, num_levels=2, base_res=16,
             max_res=256),
        dict(features_per_level=4, log2_hashmap_size=10, num_levels=2, base_res=16,
             max_res=512)),
    prop_shared_mlp=True, prop_grid_res=64, hash_storage="shared")
DISK_FIXTURE = dict(height=180, width=320, feature_dim=64)
DISK_METHOD = "boston-seaport-camera-dino-c0-tpu"


def codec_phase():
    """Phase 14: the JPEG codec on the card's host: g++ build, the checked-in
    goldens decoded to Pillow's pixels (by the data manager's thread pool,
    all at once), and the decode time of one 1600x900 image at Pillow's
    default settings, alone and in the pool. Returns problems."""
    from concurrent.futures import ThreadPoolExecutor

    from presight_tpu_torch.configs import DataManagerConfig
    from presight_tpu_torch.native import jpeg

    t0 = time.perf_counter()
    jpeg.lib()
    print(f"  codec built by g++ in {time.perf_counter() - t0:.2f} s")
    problems = []
    want = np.load(GOLDENS / "pixels.npz")
    threads = DataManagerConfig().num_threads
    # The process's first decodes: every golden twice, by the pool's threads at once.
    names = sorted(want.files) * 2
    with ThreadPoolExecutor(threads) as pool:
        decoded = list(pool.map(lambda name: jpeg.decode(GOLDENS / f"{name}.jpg"), names))
    for name, got in zip(names, decoded):
        same = got.shape == want[name].shape and np.array_equal(got, want[name])
        print(f"  golden {name} {want[name].shape} (pool of {threads} threads): "
              f"{'identical' if same else 'DIFFERENT'} pixels")
        if not same:
            problems.append(f"golden {name} decodes to other pixels than Pillow's")
    H, W = NUSCENES_HW
    rng = np.random.RandomState(SEED)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(xx / W * 9), 0.5 + 0.4 * np.cos(yy / H * 7),
                    0.4 + 0.3 * np.sin((xx + yy) / (W + H) * 12)], -1)
    img = (np.clip(img + rng.randn(H, W, 3).astype(np.float32) * 0.05, 0, 1) * 255)
    data = jpeg.encode(img.astype(np.uint8))
    jpeg.decode(data)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        jpeg.decode(data)
        times.append(time.perf_counter() - t0)
    n = 64
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(jpeg.decode, [data] * threads))
        t0 = time.perf_counter()
        list(pool.map(jpeg.decode, [data] * n))
        pooled = time.perf_counter() - t0
    single = statistics.median(times)
    print(f"  decode {W}x{H} (quality 75, 4:2:0, {len(data)} bytes): single thread median "
          f"{single * 1e3:.2f} ms; pool of {threads} threads {pooled / n * 1e3:.2f} ms an image "
          f"({single * n / pooled:.2f}x)")
    return problems


def quality_config(data_dir: Path, out_dir: Path):
    """The quality floor's run (quality_study.run_variant at QUALITY_ITERS
    iterations, seed 42) over the fixture at ``data_dir``."""
    from presight_tpu_torch.configs.method_configs import method_configs

    iters = QUALITY_ITERS
    base = method_configs["synthetic-demo"]
    model = dataclasses.replace(
        base.pipeline.model, **QUALITY_VARIANT, eval_num_rays_per_chunk=1 << 12,
        proposal_warmup=iters // 4, proposal_weights_anneal_max_num_iters=iters // 4,
        line_of_sight_start_step=iters // 4, line_of_sight_end_step=iters,
        line_of_sight_decay_steps=iters)
    pipeline = dataclasses.replace(
        base.pipeline, model=model,
        dataparser=dataclasses.replace(base.pipeline.dataparser, data_dir=data_dir,
                                       centroids_dir=data_dir / "centroids"))
    return dataclasses.replace(
        base, max_num_iterations=iters, device_ray_store_mb=2048,
        steps_per_save=max(iters, 100), steps_per_eval_batch=0, steps_per_eval_image=10 ** 9,
        seed=42, experiment_name="quality-grid-n48-cap4x-p64x32-s42", output_dir=out_dir,
        timestamp="study", pipeline=pipeline)


def quality_phase():
    """Phase 15: the fixture written by the port (45x80), the demo-scale -tpu
    profile trained QUALITY_ITERS steps from it through Trainer(config)
    (the whole set in the device store), held-out PSNR and depth RMSE from
    evaluate_images against tests/test_quality_floor.py's floors. Returns
    (launches on the path, problems)."""
    import shutil

    from presight_tpu_torch import kernels
    from presight_tpu_torch.data.synthetic import generate_scene
    from presight_tpu_torch.engine.evaluator import evaluate_images
    from presight_tpu_torch.engine.trainer import Trainer

    root = OUT_DIR / "fixture_45x80"
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(OUT_DIR / "quality", ignore_errors=True)
    t0 = time.perf_counter()
    generate_scene(root)
    print(f"  fixture 45x80 written in {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    kernels.reset_launches()
    trainer = Trainer(quality_config(root, OUT_DIR / "quality"))
    trainer.setup()
    problems = [] if trainer.store is not None else ["the quality run did not stage its set"]
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = evaluate_images(trainer.model, trainer.model_config, trainer.eval_cameras,
                        trainer.eval_items, with_lpips=False, with_depth=True)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"  {QUALITY_ITERS} steps in {wall:.2f} s; held-out ({len(trainer.eval_items)} images) "
          f"psnr {m['psnr']:.3f} (floor 12), ssim {m['ssim']:.4f}, depth_rmse "
          f"{m['depth_rmse']:.3f} m (ceiling 8)")
    print(f"  launches on the quality path: {launches}")
    if not (np.isfinite(m["psnr"]) and m["psnr"] >= 12.0):
        problems.append(f"held-out PSNR {m['psnr']} under the floor of 12")
    if not (np.isfinite(m["depth_rmse"]) and m["depth_rmse"] <= 8.0):
        problems.append(f"held-out depth RMSE {m['depth_rmse']} m over the ceiling of 8 m")
    for name in KERNEL_INFO:
        if launches[name] <= 0:
            problems.append(f"{name} was not launched on the quality path")
    return launches, problems


@contextlib.contextmanager
def recording_trainer_runs():
    """While active, keep each Trainer that runs setup() with its start step
    and chunk step after setup, each training step's metrics and seconds
    (from the batch fetch to the step's end, synchronised: the Trainer's
    step_seconds) and the seconds its batch fetch took (waiting on the
    prefetched chunk included), the first batch each trainer hands its
    step, and the step of each checkpoint saved."""
    from presight_tpu_torch.data.datamanager import DataManager
    from presight_tpu_torch.engine import trainer as T

    rec = SimpleNamespace(trainers=[], setups=[], metrics=[], seconds=[], waits=[],
                          first_batch={}, saves=[], t0=None)
    real = (T.Trainer.setup, T.train_step, T.save_checkpoint, T.Trainer._make_batch,
            DataManager.next_batch)

    def setup(self, *args, **kwargs):
        real[0](self, *args, **kwargs)
        rec.trainers.append(self)
        rec.setups.append((self.start_step, self.datamanager._chunk_step))

    def step(*args, **kwargs):
        out = real[1](*args, **kwargs)
        torch.cuda.synchronize()
        rec.seconds.append(time.perf_counter() - rec.t0)
        rec.metrics.append(dict(out))
        return out

    def save(run_dir, step, *args, **kwargs):
        rec.saves.append(step)
        return real[2](run_dir, step, *args, **kwargs)

    def make_batch(self, batch, use_store=True):
        out = real[3](self, batch, use_store)
        if use_store and id(self) not in rec.first_batch:
            rec.first_batch[id(self)] = {k: v.cpu() for k, v in out.items()}
        return out

    def next_batch(self):
        rec.t0 = time.perf_counter()
        out = real[4](self)
        rec.waits.append(time.perf_counter() - rec.t0)
        return out

    (T.Trainer.setup, T.train_step, T.save_checkpoint, T.Trainer._make_batch,
     DataManager.next_batch) = (setup, step, save, make_batch, next_batch)
    try:
        yield rec
    finally:
        (T.Trainer.setup, T.train_step, T.save_checkpoint, T.Trainer._make_batch,
         DataManager.next_batch) = real


def disk_cli_phase(memory_step_s: float):
    """Phase 16: a 180x320 fixture with 64-wide features (72 images, over
    the 512-MB whole-set cap, so the ChunkDeviceStore), written by the port;
    ``scripts.train.main`` on boston-seaport-camera-dino-c0-tpu pointed at
    it: 3 steps saving every 2, then resumed to 5. Checks config.yml, the
    checkpoints, finite losses, the first batch against the CPU
    DataManager's rows and the resume offsets; times the fixture, a chunk
    load and the steady step from disk beside phase 7's in-memory step;
    profiles one more step from disk. Returns (launches on the path, the
    profiled step, problems, the run directory)."""
    import shutil

    from presight_tpu_torch import kernels
    from presight_tpu_torch.configs.config_io import (apply_overrides, load_config,
                                                      parse_cli_overrides)
    from presight_tpu_torch.configs.method_configs import method_configs
    from presight_tpu_torch.data.datamanager import DataManager
    from presight_tpu_torch.data.synthetic import generate_scene
    from presight_tpu_torch.engine.trainer import Trainer
    from presight_tpu_torch.scripts import train as train_cli

    root = OUT_DIR / "fixture_180x320"
    runs = OUT_DIR / "runs"
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(runs, ignore_errors=True)
    t0 = time.perf_counter()
    generate_scene(root, **DISK_FIXTURE)
    print(f"  fixture {DISK_FIXTURE['height']}x{DISK_FIXTURE['width']} with "
          f"{DISK_FIXTURE['feature_dim']}-wide features written in "
          f"{time.perf_counter() - t0:.2f} s")
    overrides = ["--pipeline.dataparser.data-dir", str(root),
                 "--pipeline.dataparser.centroids-dir", str(root / "centroids"),
                 "--pipeline.dataparser.location", "synthetic-city",
                 "--output-dir", str(runs), "--timestamp", "cli", "--steps-per-save", "2"]
    torch.cuda.synchronize()
    kernels.reset_launches()
    with recording_trainer_runs() as rec:
        for end in (3, 5):
            t0 = time.perf_counter()
            rc = train_cli.main([DISK_METHOD, *overrides, "--max-num-iterations", str(end)])
            torch.cuda.synchronize()
            print(f"  train CLI to step {end}: exit {rc} in {time.perf_counter() - t0:.2f} s")
            if rc != 0:
                return dict(kernels.LAUNCHES), None, [f"the train CLI exited {rc}"], None
    launches = dict(kernels.LAUNCHES)
    print(f"  launches on the from-disk CLI path: {launches}")
    problems = [f"{name} was not launched on the from-disk CLI path"
                for name in KERNEL_INFO if launches[name] <= 0]
    first, resumed = rec.trainers
    # Each run writes config.yml; the resumed one's is there at the end.
    config = apply_overrides(method_configs[DISK_METHOD],
                             parse_cli_overrides(overrides + ["--max-num-iterations", "5"]))
    same = load_config(first.run_dir / "config.yml") == config
    print(f"  config.yml reads back {'equal' if same else 'DIFFERENT'}")
    if not same:
        problems.append("config.yml does not read back to the run's config")
    ckpts = sorted(p.name for p in (first.run_dir / "nerfstudio_models").iterdir())
    print(f"  checkpoints saved at steps {rec.saves}; on disk at the end {ckpts}")
    if rec.saves != [2, 3, 4, 5] or ckpts != ["step-000000005.ckpt"]:
        problems.append(f"checkpoints saved at {rec.saves}, on disk {ckpts}")
    store = first._chunk_store
    print(f"  store: whole set {first.store is not None}, chunk store "
          f"{store is not None and store.enabled}")
    if store is None or not store.enabled or first.store is not None:
        problems.append("the from-disk run did not go through the ChunkDeviceStore")
    for step, m in enumerate(rec.metrics):
        losses = {k: v for k, v in m.items() if k.endswith("loss")}
        print(f"  step {step}: {rec.seconds[step]:.3f} s (batch fetch {rec.waits[step]:.3f} s), "
              + ", ".join(f"{k}={v:.6g}" for k, v in losses.items()))
        if not all(np.isfinite(v) for v in m.values()):
            problems.append(f"step {step}: non-finite metrics")
    if len(rec.metrics) != 5:
        problems.append(f"{len(rec.metrics)} training steps, not 5")
    print(f"  resumed: start step {rec.setups[1][0]}, chunk step {rec.setups[1][1]} "
          f"(seed {config.seed})")
    if rec.setups[1] != (3, config.seed + 3):
        problems.append(f"resumed at (start step, chunk step) {rec.setups[1]}, not "
                        f"(3, {config.seed + 3})")
    cpu_dm = DataManager(first.dataset, config.pipeline.datamanager.train_num_rays_per_batch,
                         seed=config.seed)
    try:
        host = cpu_dm.next_batch()
    finally:
        cpu_dm.close()
    card = rec.first_batch[id(first)]
    same = sorted(card) == sorted(host) and all(
        np.array_equal(card[k].numpy(), host[k]) for k in host)
    print(f"  first batch on the card ({len(host['rgb'])} rays, {sorted(host)}) vs the CPU "
          f"DataManager's rows: {'identical' if same else 'DIFFERENT'}")
    if not same:
        problems.append("the first batch on the card differs from the CPU DataManager's rows")
    t0 = time.perf_counter()
    chunk = first.dataset.load_chunk(config.seed)
    print(f"  chunk load: {len(chunk)} rows from {len(first.dataset.items)} images in "
          f"{time.perf_counter() - t0:.3f} s ({first.dataset.num_threads} threads)")
    rays = config.pipeline.datamanager.train_num_rays_per_batch
    steady = statistics.median(rec.seconds[1:3] + rec.seconds[4:])
    print(f"  steady step from disk (steps 1, 2 and 4): median {steady:.4f} s "
          f"({rays / steady:.1f} rays/s); in memory (phase 7): {memory_step_s:.4f} s "
          f"({rays / memory_step_s:.1f} rays/s); ratio {steady / memory_step_s:.3f}")
    # One more step from disk, profiled after an unprofiled one (which
    # loads the first chunk and starts the prefetch of the second).
    trainer = Trainer(dataclasses.replace(config, max_num_iterations=10))
    trainer.setup(write_config=False)
    try:
        trainer.train(num_steps=1)
        profiled = profile_device("profiled step from disk",
                                  lambda: trainer.train(num_steps=1), "train_disk_profile.txt")
        # Device ms from the profile, launches as the wrappers counted them
        # (as profile_step reports a step).
        profiled = {name: (profiled[name][0], kernels.LAUNCHES[name]) for name in KERNEL_INFO}
        # The same steps with the loader's work taken out: every chunk is
        # the one already loaded (staging and gathers unchanged).
        trainer.dataset.load_chunk = lambda step: chunk
        idle = []
        trainer.train(num_steps=3, callback=lambda step, m: idle.append(m["step_seconds"]))
        print(f"  steps from disk with the chunk loader idle (the same chunk each step): "
              + ", ".join(f"{t:.4f}" for t in idle) + f" s; median of the last two "
              f"{statistics.median(idle[1:]):.4f} s")
    finally:
        trainer.close()
    return launches, profiled, problems, first.run_dir


# Phase 17: extract_priors keeps hit points of mean density above this (the
# CLI's default, 1.0, may keep none after a few steps).
SERVE_DENSITY_THRESHOLD = 0.0
# Card against CPU, extract_priors on one frame at --downscale 2: the voxel
# counts within this share; each voxel of one side has one of the other
# within SERVE_VOXEL_ATOL m with the same hits, but for SERVE_UNMATCHED of
# them (a point that rounds to the other side of a voxel face, or a median
# depth at a threshold tie, moves between voxels); on matched voxels the
# f16 features and the colours within these.
SERVE_COUNT_RTOL = 0.01
SERVE_VOXEL_ATOL = 1e-3
SERVE_UNMATCHED = 0.01
SERVE_FEATURE_ATOL = 2e-3
SERVE_COLOR_ATOL = 1e-3
# LPIPS on the card against the CPU (IEEE f32 convolutions: ~1e-7; TF32
# would give ~1e-4).
SERVE_LPIPS_RTOL = 1e-5


def compare_priors(card, cpu):
    """Problems of the card's prior pickle against the CPU's (the
    SERVE_* tolerances), and the line that reports them."""
    from scipy.spatial import cKDTree

    problems = []
    n_card, n_cpu = len(card["points"]), len(cpu["points"])
    if abs(n_card - n_cpu) > SERVE_COUNT_RTOL * n_cpu or not np.array_equal(card["origin"],
                                                                             cpu["origin"]):
        problems.append(f"voxels {n_card} on the card, {n_cpu} on the CPU; origins "
                        f"{card['origin']} {cpu['origin']}")
    if n_card == 0 or n_cpu == 0:
        return problems + ["an empty pickle"], ""
    shares, errs = [], {"point": 0.0, "feature": 0.0, "color": 0.0}
    for a, b in ((card, cpu), (cpu, card)):
        dist, j = cKDTree(b["points"]).query(a["points"])
        match = (dist <= SERVE_VOXEL_ATOL) & (a["hits"] == b["hits"][j])
        shares.append(float(match.mean()))
        errs["point"] = max(errs["point"], float(dist[match].max(initial=0.0)))
        errs["feature"] = max(errs["feature"], float(np.abs(
            a["features"][match].astype(np.float32) - b["features"][j[match]].astype(np.float32)
        ).max(initial=0.0)))
        errs["color"] = max(errs["color"], float(np.abs(
            a["colors"][match] - b["colors"][j[match]]).max(initial=0.0)))
    if min(shares) < 1.0 - SERVE_UNMATCHED:
        problems.append(f"matched voxels: {shares[0]:.4f} of the card's, {shares[1]:.4f} of "
                        "the CPU's")
    if errs["feature"] > SERVE_FEATURE_ATOL or errs["color"] > SERVE_COLOR_ATOL:
        problems.append(f"matched voxels' features differ by {errs['feature']:.3e}, colours by "
                        f"{errs['color']:.3e}")
    return problems, (f"{n_card} voxels on the card, {n_cpu} on the CPU; matched "
                      f"{shares[0]:.4f} of the card's, {shares[1]:.4f} of the CPU's (same hits, "
                      f"within {SERVE_VOXEL_ATOL:g} m; at most {SERVE_UNMATCHED:g} unmatched); on "
                      f"them points {errs['point']:.3e} m apart, features {errs['feature']:.3e} "
                      f"(tol {SERVE_FEATURE_ATOL:g}), colours {errs['color']:.3e} (tol "
                      f"{SERVE_COLOR_ATOL:g})")


def serve_cli_phase(run_dir: Path, card: str):
    """Phase 17: phase 16's run directory served on the card through the
    port's four CLIs, as a user calls them, with torch's default TF32 flags
    (the earlier phases turned TF32 off) and LPIPS from random weights in
    the official state_dict layout (an .npz through $PRESIGHT_LPIPS_WEIGHTS):
    extract_priors at --downscale 1 (frames 0 and 8, the default interval),
    eval of every image, render of camera 0, export pointcloud and cameras,
    each timed. Checks the prior pickle (pickle_problems), the metrics, every
    PNG decoded back by the port's reader, the PLY and the camera JSON, and
    that K1-K4 ran on this path; then extract_priors on one frame at
    --downscale 2 on the card against the same CLI on the CPU
    (compare_priors), and LPIPS of the rendered camera 0 against its image,
    on the card against the CPU (SERVE_LPIPS_RTOL). Returns (launches on the
    path, problems)."""
    import os
    import pickle
    import shutil

    from presight_tpu_torch import kernels
    from presight_tpu_torch.configs.config_io import load_config
    from presight_tpu_torch.data.dataparser import parse
    from presight_tpu_torch.data.image_metadata import read_png
    from presight_tpu_torch.scripts import eval as eval_cli
    from presight_tpu_torch.scripts import export as export_cli
    from presight_tpu_torch.scripts import extract_priors as extract_cli
    from presight_tpu_torch.scripts import render as render_cli
    from presight_tpu_torch.utils import lpips as L
    from presight_tpu_torch.utils import metrics as M

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda import lpips_state_dict

    out = OUT_DIR / "serve_cli"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    weights = out / "lpips_random.npz"
    np.savez(weights, **lpips_state_dict(SEED))
    config = load_config(run_dir / "config.yml")
    env_before = os.environ.get("PRESIGHT_LPIPS_WEIGHTS")
    os.environ["PRESIGHT_LPIPS_WEIGHTS"] = str(weights)
    M._LPIPS_CACHE.clear()
    torch.backends.cudnn.allow_tf32 = True  # torch's default; matmul's is False
    problems, times = [], {}
    try:
        print(f"  TF32 flags: cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
              f"cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}; LPIPS weights "
              f"{weights.name} (random, seed {SEED})")

        def run(label, main, argv, device=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = main([str(a) for a in argv], device=device)
            torch.cuda.synchronize()
            times[label] = time.perf_counter() - t0
            print(f"  {label}: exit {rc} in {times[label]:.2f} s")
            if rc != 0:
                problems.append(f"{label} exited {rc}")

        kernels.reset_launches()
        run("extract_priors", extract_cli.main,
            [run_dir, "--downscale", 1, "--density-threshold", SERVE_DENSITY_THRESHOLD,
             "--output-dir", out / "priors"])
        run("eval", eval_cli.main, [run_dir, "--output-path", out / "metrics.json"])
        run("render", render_cli.main, [run_dir, "--output-dir", out / "renders", "--indices", 0])
        run("export pointcloud", export_cli.main,
            ["pointcloud", run_dir, "--output-dir", out / "export", "--num-points", 200_000])
        run("export cameras", export_cli.main, ["cameras", run_dir, "--output-dir", out / "export"])
        launches = dict(kernels.LAUNCHES)
        print(f"  launches on the serving CLI path: {launches}")
        print(f"  CLI wall times ({card}): "
              + ", ".join(f"{k} {v:.2f} s" for k, v in times.items()))
        problems += [f"{name} was not launched on the serving CLI path"
                     for name in SERVE_KERNELS if launches[name] <= 0]
        if problems:
            return launches, problems

        with open(out / "priors" / "extracted_priors.pkl", "rb") as f:
            result = pickle.load(f)
        print(f"  prior pickle: {len(result['points'])} voxels (density threshold "
              f"{SERVE_DENSITY_THRESHOLD})")
        problems += pickle_problems(result, config.pipeline.model)
        metrics = json.loads((out / "metrics.json").read_text())
        print(f"  eval metrics: {metrics}")
        if set(metrics) != {"psnr", "ssim", "lpips"} or not all(
                np.isfinite(v) for v in metrics.values()):
            problems.append(f"eval metrics {metrics}")
        items = parse(config.pipeline.dataparser, split="train").items
        H, W = items[0].H, items[0].W
        for name, shape in (("rgb", (H, W, 3)), ("depth", (H, W)), ("dino", (H, W, 3))):
            img = read_png(out / "renders" / f"render_00000_{name}.png")
            print(f"  render_00000_{name}.png: {img.dtype} {img.shape}")
            if img.dtype != np.uint8 or img.shape != shape:
                problems.append(f"render_00000_{name}.png decodes to {img.dtype} {img.shape}")
        ply = (out / "export" / "point_cloud.ply").read_text().splitlines()
        n = int(next(line for line in ply if line.startswith("element vertex")).split()[-1])
        body = np.array([[float(v) for v in line.split()]
                         for line in ply[ply.index("end_header") + 1:]])
        frames = json.loads((out / "export" / "camera_poses.json").read_text())["frames"]
        print(f"  point_cloud.ply: {n} points; camera_poses.json: {len(frames)} cameras")
        if not (0 < n == len(body)) or not np.isfinite(body).all():
            problems.append(f"point_cloud.ply: {n} points, {len(body)} rows")
        if len(frames) != len(items) or np.asarray(frames[0]["camera_to_world"]).shape != (3, 4):
            problems.append(f"camera_poses.json: {len(frames)} cameras, not {len(items)}")

        # The card against the CPU: extract_priors on one frame (six cameras).
        one_frame = ["--downscale", 2, "--interval", 1000, "--density-threshold",
                     SERVE_DENSITY_THRESHOLD]
        run("extract_priors, one frame, card", extract_cli.main,
            [run_dir, *one_frame, "--output-dir", out / "frame_card"])
        run("extract_priors, one frame, CPU", extract_cli.main,
            [run_dir, *one_frame, "--output-dir", out / "frame_cpu"], device="cpu")
        pickles = []
        for name in ("frame_card", "frame_cpu"):
            with open(out / name / "extracted_priors.pkl", "rb") as f:
                pickles.append(pickle.load(f))
        bad, line = compare_priors(*pickles)
        print(f"  extract_priors card vs CPU: {line}")
        problems += bad

        # LPIPS of camera 0's render against its image, card against CPU,
        # and the same trunk left to the TF32 flags (the hazard's size).
        pred = read_png(out / "renders" / "render_00000_rgb.png").astype(np.float32) / 255.0
        gt = items[0].load_image()
        card_lpips = M.lpips_fn("cuda")(pred, gt)
        cpu_lpips = M.lpips_fn("cpu")(pred, gt)
        params = L.to_device(L.load_torch_state_dict(lpips_state_dict(SEED)), "cuda")
        with torch.no_grad():
            tf32 = float(L.distance(params, torch.from_numpy(pred).cuda(),
                                    torch.from_numpy(np.ascontiguousarray(gt)).cuda()))
        rel = abs(card_lpips - cpu_lpips) / abs(cpu_lpips)
        print(f"  LPIPS of render 0 vs its image: card {card_lpips:.9g}, CPU {cpu_lpips:.9g} "
              f"(rel {rel:.3e}, tol {SERVE_LPIPS_RTOL:g}); the trunk under TF32 {tf32:.9g} "
              f"(rel {abs(tf32 - cpu_lpips) / abs(cpu_lpips):.3e})")
        if not rel <= SERVE_LPIPS_RTOL:
            problems.append(f"LPIPS on the card {card_lpips} vs the CPU {cpu_lpips}")
        # Where eval's time goes, per image: its metrics on the host clock
        # (LPIPS synchronised), beside eval's wall time over its images.
        parts = {"image load": lambda: items[0].load_image(),
                 "psnr": lambda: M.psnr(pred, gt), "ssim (float64, host)": lambda: M.ssim(pred, gt),
                 "lpips (card)": lambda: M.lpips_fn("cuda")(pred, gt)}
        line = []
        for label, fn in parts.items():
            fn()
            t0 = time.perf_counter()
            fn()
            line.append(f"{label} {time.perf_counter() - t0:.4f} s")
        n_eval = len(parse(config.pipeline.dataparser, split="val").items) or len(items)
        print(f"  eval per image ({H}x{W}; {times['eval'] / n_eval:.4f} s each over {n_eval} "
              "images): " + ", ".join(line))
    finally:
        torch.backends.cudnn.allow_tf32 = False
        if env_before is None:
            os.environ.pop("PRESIGHT_LPIPS_WEIGHTS", None)
        else:
            os.environ["PRESIGHT_LPIPS_WEIGHTS"] = env_before
        M._LPIPS_CACHE.clear()
    return launches, problems


OCC_CONFIG = "bevdet-occ-r50d-8x4-24e_wcamprior_randomdrop"
OCC_CITY = "boston-seaport"
# nuScenes CAM_FRONT intrinsics, and the reference's image pipeline for
# 1600x900: resize by 704 / 1600, crop the top 140 rows (256x704 left).
OCC_INTRINSICS = ((1266.417, 0.0, 816.267), (0.0, 1266.417, 491.507), (0.0, 0.0, 1.0))
OCC_RESIZE, OCC_CROP_TOP = 0.44, 140.0
OCC_YAWS_DEG = (0.0, -55.0, 55.0, -110.0, 110.0, 180.0)
OCC_EGO_MOTION = (1.0, 0.05, 2.0)  # metres forward, left, degrees of yaw between frames
OCC_PRIOR_POINTS = 400_000
# Frame 2 with the kernels against frame 2 with their plain versions, on
# the card: the same weights and inputs; S1 sums in point order against
# index_add_'s atomics and S2 over channels in another order, through a
# 50-layer network in IEEE f32.
OCC_LOGIT_ATOL, OCC_LOGIT_RTOL = 1e-4, 1e-4
OCC_DEPTH_ATOL = 1e-4
OCC_ARGMAX_AGREE = 0.999
# S1 against its plain version on the recorded inputs: a voxel's sum of up
# to hundreds of products in another order.
S1_ATOL, S1_RTOL = 1e-5, 1e-4
# S2: costs are sums of 256 |differences| (tens), taken in another order;
# the softmax moves by its value times the cost's error.
S2_COST_ATOL, S2_COST_RTOL, S2_PROB_ATOL = 1e-4, 1e-5, 1e-5


def occ_rig(cfg, device):
    """A nuScenes-like rig at batch 1: six cameras at yaw 0, +-55, +-110 and
    180 degrees, optical axes horizontal, 1.5 m above the ground, the
    intrinsics and image augmentation of a 1600x900 camera cut to 256x704,
    and the two frames' ego motion (OCC_EGO_MOTION). Returns (geometry
    tensors, k2s_sensor, prev2curr)."""
    n = len(OCC_YAWS_DEG)
    cam_to_ego = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)  # x right, y down, z ahead
    s2e = np.tile(np.eye(4), (1, n, 1, 1))
    for i, yaw in enumerate(np.radians(OCC_YAWS_DEG)):
        rz = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        s2e[0, i, :3, :3] = rz @ cam_to_ego
        s2e[0, i, :3, 3] = [0.8 * np.cos(yaw) + 0.5, 0.5 * np.sin(yaw), 1.5]
    intr = np.tile(np.asarray(OCC_INTRINSICS), (1, n, 1, 1))
    post_rots = np.tile(np.diag([OCC_RESIZE, OCC_RESIZE, 1.0]), (1, n, 1, 1))
    post_trans = np.tile([0.0, -OCC_CROP_TOP, 0.0], (1, n, 1))
    bda = np.eye(4)[None]
    fwd, left, yaw = OCC_EGO_MOTION
    a = np.radians(yaw)
    curr_in_prev = np.eye(4)  # the current ego pose in the previous ego frame
    curr_in_prev[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    curr_in_prev[:2, 3] = [fwd, left]
    k2s = np.stack([np.linalg.inv(s2e[0, i]) @ curr_in_prev @ s2e[0, i] for i in range(n)])[None]
    prev_to_curr = np.linalg.inv(curr_in_prev)
    p2c = np.eye(3)
    p2c[:2, :2], p2c[:2, 2] = prev_to_curr[:2, :2], prev_to_curr[:2, 3]
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    return [t(x) for x in (s2e, intr, post_rots, post_trans, bda)], t(k2s), t(p2c[None])


def write_city_prior(root: Path, rng, centre):
    """A dense synthetic city-prior pickle in the extraction schema (points
    f32 in nerfstudio's x/y-negated frame minus the origin, features f16,
    colours f32, hits, origin) over a 100 x 100 x 9 m block around
    ``centre``: dense enough that the ego crop fills the 20,000-voxel cap.
    Written to <root>/camera_priors/<city>/<city>-c0.pkl."""
    import pickle

    n = OCC_PRIOR_POINTS
    origin = np.array([12.5, -7.25, 0.0], np.float32)
    world = rng.uniform([-50, -50, -2.5], [50, 50, 6.5], (n, 3)) + np.asarray(centre)
    points = (world * [-1, -1, 1] - origin).astype(np.float32)  # CityPriors adds origin, negates x/y
    out = root / "camera_priors" / OCC_CITY / f"{OCC_CITY}-c0.pkl"
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump({"points": points, "features": rng.randn(n, 64).astype(np.float16),
                     "colors": rng.rand(n, 3).astype(np.float32),
                     "hits": rng.randint(1, 50, n).astype(np.int64), "origin": origin}, f)
    return out


def occ_priors(root: Path, cfg, translation, device, label):
    """CityPriors + VoxelizePriorPoints (first-come, C++) of the pickle under
    ``root`` around the ego pose (translation, no rotation), padded to
    max_voxels: the model's prior inputs on ``device``."""
    from presight_tpu_torch.prior.consume import CityPriors, VoxelizePriorPoints, pad_prior_voxels

    t0 = time.perf_counter()
    priors = CityPriors(str(root), {OCC_CITY: 1}, cfg.prior_pc_range)
    pts = priors.get_prior_points(OCC_CITY, translation, [1.0, 0.0, 0.0, 0.0])
    voxelizer = VoxelizePriorPoints(pc_range=cfg.prior_pc_range, voxel_size=cfg.prior_voxel_size)
    vox = voxelizer(pts, rng=np.random.RandomState(SEED))
    padded = pad_prior_voxels([vox], pad_to=voxelizer.max_voxels)
    print(f"  priors ({label}): {len(priors.priors[OCC_CITY])} points loaded, {len(pts)} in the "
          f"crop, {len(vox['prior_voxels'])} voxels (cap {voxelizer.max_voxels}) in "
          f"{time.perf_counter() - t0:.3f} s")
    return ({k: torch.as_tensor(v, device=device) for k, v in padded.items()},
            len(vox["prior_voxels"]))


def s2_bound(grid, BN, Hs, Ws, C, D):
    """S2's least time: the bytes (prev and curr once, the grid, the output)
    against the operations this grid needs (per (pixel, bin) and channel: a
    blend of the k corners inside, 2k - 1, and |difference| summed, 3)."""
    H, W = Hs, Ws
    x = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    ins = 0
    for dx in (0, 1):
        for dy in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            ins = ins + ((xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)).long()
    flops = float(((2 * ins - 1).clamp_min(0) + 3).sum()) * C
    nbytes = 4.0 * (2 * BN * Hs * Ws * C + grid.numel() + BN * Hs * Ws * D)
    return bound(nbytes, flops), flops, int(ins.sum())


@torch.no_grad()
def occupancy_phase(chk: Checker, card: str, stage2_pickle):
    """Phase 18: BEVDet-Occ serving at the reference width (see the module
    docstring). Returns (launches on the main path, launches on the CLI
    path, {kernel: (device ms, launches) of a profiled frame}, problems)."""
    import pickle
    import shutil

    from presight_tpu_torch import bridge, kernels
    from presight_tpu_torch.configs.stage3_configs import occ_configs
    from presight_tpu_torch.models.layers import init_weights
    from presight_tpu_torch.occupancy import BEVDetOcc
    from presight_tpu_torch.occupancy import bev_pool as PB
    from presight_tpu_torch.occupancy import view_transformer as PV
    from presight_tpu_torch.scripts import train_occ

    problems = []
    out = OUT_DIR / "occupancy"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    dev = torch.device("cuda")
    cfg = occ_configs[OCC_CONFIG]()
    t0 = time.perf_counter()
    model = init_weights(BEVDetOcc(cfg, device=dev), torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    print(f"  {OCC_CONFIG}: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters, "
          f"init {time.perf_counter() - t0:.2f} s; input 6 x 256 x 704, grid "
          f"{cfg.grid_size()} at 0.4 m, 88 depth bins, prior grid 200 x 200 x 20")
    geo, k2s, p2c = occ_rig(cfg, dev)
    rng = np.random.RandomState(SEED)
    H, W = cfg.input_size
    imgs = [torch.as_tensor(rng.rand(1, 6, 3, H, W).astype(np.float32), device=dev)
            for _ in range(2)]
    gx, gy, gz = cfg.grid_size()
    prev_bev = torch.as_tensor(rng.randn(1, cfg.view_out_channels, gz, gy, gx).astype(np.float32),
                               device=dev)
    ego = [1200.0, 850.0, 0.0]  # the ego's translation in the city frame
    write_city_prior(out / "synthetic", rng, ego)
    priors, n_vox = occ_priors(out / "synthetic", cfg, ego, dev, "synthetic city")
    if n_vox < 20000:
        problems.append(f"the synthetic prior crop gave {n_vox} voxels, not the cap")

    def frame1():
        return model(imgs[0], *geo, **priors, k2s_sensor=k2s)

    def frame2(stereo):
        return model(imgs[1], *geo, **priors, prev_bev=prev_bev, prev2curr=p2c,
                     prev_stereo_feat=stereo, k2s_sensor=k2s)

    # The main path, counted: frame 1 (no history), then frame 2 (frame 1's
    # stereo features, the ego motion, a seeded previous BEV).
    specs = {"bev_pool": (PV, "bev_pool_v2", lambda *a: True, 1),
             "stereo": (PV, "stereo_cost_volume", lambda *a: True, 0)}
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with recording_calls(specs) as rec:
        occ1, depth1, stereo1 = frame1()
        occ2, depth2, stereo2 = frame2(stereo1)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    print(f"  frames 1 and 2 (first run): {t_first:.3f} s; launches "
          f"{ {k: launches[k] for k in OCC_KERNEL_INFO} }")
    for name in OCC_SERVE_KERNELS:
        if launches[name] <= 0:
            problems.append(f"{name} was not launched on the occupancy path")
    shapes = {"occ": (tuple(occ2.shape), (1, gx, gy, gz, 18)),
              "depth": (tuple(depth2.shape), (6, 88, 16, 44)),
              "stereo": (tuple(stereo2.shape), (1, 6, 64, 176, 256))}
    for key, (got, want) in shapes.items():
        if got != want:
            problems.append(f"{key} has shape {got}, not {want}")
    for key, t in (("occ 1", occ1), ("depth 1", depth1), ("occ 2", occ2), ("depth 2", depth2),
                   ("stereo 2", stereo2)):
        if not bool(torch.isfinite(t).all()):
            problems.append(f"{key} is not finite")
    sums = depth2.sum(1)
    if float((sums - 1).abs().max()) > 1e-4:
        problems.append("depth does not sum to 1 over the bins")
    print(f"  occ logits: mean {float(occ2.mean()):.4f} std {float(occ2.std()):.4f}; classes "
          f"predicted {int(occ2.argmax(-1).unique().numel())}; frame 2 - frame 1 max "
          f"{float((occ2 - occ1).abs().max()):.4e}")

    # S1's inputs: the share of the frustum points in the grid.
    depth_in, feat_in, coor_in = rec["bev_pool"][:3]
    lb, iv = rec["bev_pool"][3], rec["bev_pool"][4]
    ranks = PB.voxel_ranks(coor_in, lb, iv, (gx, gy, gz))
    inside = int((ranks < gx * gy * gz).sum())
    per_voxel = torch.bincount(ranks[ranks < gx * gy * gz].long(), minlength=gx * gy * gz)
    occupied = int((per_voxel > 0).sum())
    print(f"  rig: {inside} of {ranks.numel()} frustum points in the grid "
          f"({inside / ranks.numel():.4f}), {occupied} voxels occupied; S1's intervals: "
          f"{inside / max(occupied, 1):.3f} points an occupied voxel, the largest "
          f"{int(per_voxel.max())}")
    if inside < ranks.numel() // 4:
        problems.append(f"only {inside} frustum points land in the grid")

    # Frame 2 with the plain versions on the card.
    with kernels.plain_versions():
        occ_p, depth_p, _ = frame2(stereo1)
    torch.cuda.synchronize()
    err = (occ2 - occ_p).abs()
    bad = int((err > OCC_LOGIT_ATOL + OCC_LOGIT_RTOL * occ_p.abs()).sum())
    derr = float((depth2 - depth_p).abs().max())
    agree = float((occ2.argmax(-1) == occ_p.argmax(-1)).float().mean())
    ok = bad == 0 and derr <= OCC_DEPTH_ATOL and agree >= OCC_ARGMAX_AGREE
    print(f"  frame 2, kernels vs plain versions on the card: occ max_abs_err "
          f"{float(err.max()):.3e} ({bad} out of atol {OCC_LOGIT_ATOL:g} + rtol "
          f"{OCC_LOGIT_RTOL:g}), depth max_abs_err {derr:.3e} (tol {OCC_DEPTH_ATOL:g}), argmax "
          f"agreement {agree:.6f} (>= {OCC_ARGMAX_AGREE}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        problems.append("frame 2 with the kernels differs from the plain versions")
    del occ_p, depth_p

    # S1 on the recorded inputs (not counted: after the main path).
    chk.close("bev_pool_fwd", "frame 2 (rig)", PB.bev_pool_v2(*rec["bev_pool"]),
              plainly(PB.bev_pool_v2, *rec["bev_pool"]), S1_ATOL, S1_RTOL)
    ones = (torch.ones_like(depth_in), torch.ones_like(feat_in[..., :1]), coor_in)
    counts = PB.bev_pool_v2(*ones, lb, iv, (gx, gy, gz))
    counts_plain = plainly(PB.bev_pool_v2, *ones, lb, iv, (gx, gy, gz))
    same = torch.equal(counts, counts_plain)
    print(f"  bev_pool_fwd points per voxel (the voxel set): {'equal' if same else 'DIFFER'} "
          f"({int((counts > 0).sum())} voxels, {int(counts.sum())} points)")
    if not same:
        problems.append("S1 puts points in other voxels than its plain version")
    s1 = lambda: PB.bev_pool_v2(*rec["bev_pool"])  # noqa: E731
    chk.time("bev_pool_fwd", s1, lambda: plainly(PB.bev_pool_v2, *rec["bev_pool"]))
    C = feat_in.shape[-1]
    rows = (depth_in[..., None] * feat_in[:, :, None]).reshape(-1, C)
    flat = torch.zeros((gx * gy * gz + 1, C), device=dev)
    idx = ranks.reshape(-1).long()
    chk.library["bev_pool_fwd"] = time_ms(lambda: flat.index_add_(0, idx, rows))
    nbytes = 4.0 * (depth_in.numel() + feat_in.numel() + coor_in.numel() + gx * gy * gz * C)
    chk.bounds["bev_pool_fwd"] = bound(nbytes, 2.0 * inside * C)
    del rows, flat, idx
    # Readings that isolate parts of S1's time: without the nearest 8 depth
    # bins (< 5 m, the heavy voxels next to the cameras), and with every
    # point outside the grid (the ordering passes and the zero write).
    near_out, all_out = coor_in.clone(), torch.full_like(coor_in, 1e4)
    near_out[:, :, :8] = 1e4
    readings = []
    for label, c in (("nearest 8 bins outside", near_out), ("every point outside", all_out)):
        ms = device_ms(lambda c=c: PB.bev_pool_v2(depth_in, feat_in, c, lb, iv, (gx, gy, gz)))
        readings.append(f"{label} {ms:.4f} ms")
    print(f"  bev_pool_fwd reading ({card}), device: " + ", ".join(readings))
    del near_out, all_out

    # S2 on frame 2's recorded stereo features.
    prev_s, curr_s, grid_s, D, bias = rec["stereo"][:5]
    prob, cost, mask = PV.stereo_cost_volume(prev_s, curr_s, grid_s, D, bias, return_cost=True)
    prob_p, cost_p, mask_p = plainly(PV.stereo_cost_volume, prev_s, curr_s, grid_s, D, bias,
                                     return_cost=True)
    flips = int((mask != mask_p).sum())
    print(f"  stereo_cost_volume_fwd bias mask: {int(mask.sum())} of {mask.numel()} samples "
          f"invalid, {flips} differ from the plain version's")
    if flips:
        problems.append(f"S2's bias mask differs from its plain version's at {flips} samples")
    chk.close("stereo_cost_volume_fwd", "frame 2 costs", cost, cost_p, S2_COST_ATOL,
              S2_COST_RTOL)
    chk.close("stereo_cost_volume_fwd", "frame 2 softmax", prob, prob_p, S2_PROB_ATOL, 0.0)
    BN, Hs, Ws, Cs = curr_s.shape
    chk.time("stereo_cost_volume_fwd",
             lambda: PV.stereo_cost_volume(prev_s, curr_s, grid_s, D, bias),
             lambda: plainly(PV.stereo_cost_volume, prev_s, curr_s, grid_s, D, bias))
    chk.library["stereo_cost_volume_fwd"] = None  # no single PyTorch call computes it
    # A reading without reloads: bin 0's position in every bin of a pixel
    # (the same corner rows throughout), S2's blending and reduction alone.
    one = grid_s.reshape(BN, D, Hs * Ws, 2)[:, :1].expand(-1, D, -1, -1).reshape(BN, -1, 2)
    one = one.contiguous()
    print(f"  stereo_cost_volume_fwd reading ({card}), device: one block a pixel (no reloads) "
          f"{device_ms(lambda: PV.stereo_cost_volume(prev_s, curr_s, one, D, bias)):.4f} ms")
    del one
    chk.bounds["stereo_cost_volume_fwd"], s2_flops, n_inside = s2_bound(grid_s, BN, Hs, Ws, Cs, D)
    print(f"  stereo_cost_volume_fwd work: {BN * Hs * Ws * D} (pixel, bin) samples, {n_inside} "
          f"corners inside, {s2_flops / 1e9:.2f} GFLOP")
    if hasattr(PV, "stereo_row_fetches"):  # not in trees older than S2's row reuse
        reuse = PV.stereo_row_fetches(grid_s, Hs, Ws, D)
        print(f"  stereo_cost_volume_fwd corner rows under the reuse rule: {reuse['fetches']} "
              f"fetches, {reuse['fetches'] / reuse['samples']:.3f} a (pixel, bin) (every inside "
              f"corner each bin: {reuse['corners'] / reuse['samples']:.3f}); bins keeping all "
              f"four rows {reuse['same']}, stepping one pixel {reuse['step']}, loading all four "
              f"{reuse['jump']}")
    del prob, cost, mask, prob_p, cost_p, mask_p, rec
    for name in OCC_SERVE_KERNELS:
        k_ms, p_ms = chk.times[name]
        lib = chk.library[name]
        b_ms, b_by = chk.bounds[name]
        print(f"  time {name} ({card}): kernel {k_ms:.4f} ms (device {chk.device[name]:.4f} "
              f"ms), plain {p_ms:.4f} ms, library {'none' if lib is None else f'{lib:.4f} ms'}, "
              f"bound {b_ms:.4f} ms ({b_by}), share {b_ms / chk.device[name]:.3f}")

    # Per-frame times (host clock, synchronised), peak memory, a profile.
    def timed(fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    # The checks above leave hundreds of MB cached (the recorded inputs,
    # stereo_row_fetches' temporaries): hand them back, so that the frames
    # are timed with the allocator as a served model would have it.
    torch.cuda.empty_cache()
    f1 = timed(frame1)
    f2 = timed(lambda: frame2(stereo1))
    torch.cuda.reset_peak_memory_stats()
    frame2(stereo1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  forward per frame ({card}), host clock, synchronised, median of 5: frame 1 "
          f"{statistics.median(f1) * 1e3:.1f} ms {[round(t * 1e3, 1) for t in f1]}, frame 2 "
          f"{statistics.median(f2) * 1e3:.1f} ms {[round(t * 1e3, 1) for t in f2]}; peak memory "
          f"of frame 2 {peak:.3f} GiB")
    frame = profile_device("profiled frame 2", lambda: frame2(stereo1), "occ_frame_profile.txt",
                           names=tuple(OCC_KERNEL_INFO))
    frame = {name: (frame[name][0], kernels.LAUNCHES[name]) for name in OCC_KERNEL_INFO}
    if frame["bev_pool_bwd"][1]:
        problems.append("S1b ran in a served frame")

    # The stage-2 -> stage-3 contract: an extract_priors pickle, through
    # CityPriors and VoxelizePriorPoints, into one forward.
    stage2_pickle = Path(stage2_pickle or out / "synthetic" / "camera_priors" / OCC_CITY
                         / f"{OCC_CITY}-c0.pkl")
    contract = out / "stage2"
    dst = contract / "camera_priors" / OCC_CITY / f"{OCC_CITY}-c0.pkl"
    dst.parent.mkdir(parents=True)
    shutil.copy(stage2_pickle, dst)
    with open(dst, "rb") as f:
        p = pickle.load(f)
    xyz = (p["points"].astype(np.float32) + p["origin"].astype(np.float32)) * [-1, -1, 1]
    centre = [float(np.median(xyz[:, 0])), float(np.median(xyz[:, 1])),
              float(np.median(xyz[:, 2])) - 2.0]
    s2_priors, n2 = occ_priors(contract, cfg, centre, dev, f"stage 2's {stage2_pickle.name}")
    occ_c = model(imgs[0], *geo, **s2_priors, k2s_sensor=k2s)[0]
    finite = bool(torch.isfinite(occ_c).all())
    print(f"  stage-2 pickle ({len(p['points'])} points) -> {n2} prior voxels -> occ "
          f"{tuple(occ_c.shape)}, finite {finite}")
    if n2 == 0 or not finite:
        problems.append(f"the stage-2 contract gave {n2} voxels, finite {finite}")

    # The CLI on a checkpoint in the JAX CLI's schema, from the port's
    # weights through the inverse bridge, over 2 npz samples with priors.
    ckpt = out / "occ-step-000000000.pkl"
    variables = bridge.occ_state_to_flax(model)
    with open(ckpt, "wb") as f:
        pickle.dump({"params": variables, "ema": variables, "ema_updates": 0, "iters": 0}, f)
    data = out / "npz"
    data.mkdir()
    for i in range(2):
        sample = {k: t.cpu().numpy() for k, t in
                  zip(("sensor2ego", "cam2imgs", "post_rots", "post_trans", "bda"), geo)}
        sample.update({k: v.cpu().numpy() for k, v in priors.items()})
        sample["imgs"] = imgs[i].cpu().numpy()
        sample["voxel_semantics"] = rng.randint(0, 18, (1, gx, gy, gz)).astype(np.uint8)
        sample["mask_camera"] = (rng.rand(1, gx, gy, gz) > 0.3).astype(np.uint8)
        np.savez(data / f"sample_{i}.npz", **sample)
    del model
    torch.cuda.empty_cache()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = train_occ.main(["--config", OCC_CONFIG, "--eval-ckpt", str(ckpt), "--data-dir",
                         str(data)])
    torch.cuda.synchronize()
    cli_launches = dict(kernels.LAUNCHES)
    print(f"  train_occ --eval-ckpt ({card}): exit {rc} in {time.perf_counter() - t0:.2f} s "
          f"(2 samples, model build and checkpoint load included); launches "
          f"{ {k: cli_launches[k] for k in OCC_KERNEL_INFO} }")
    if rc != 0 or any(cli_launches[k] <= 0 for k in ("bev_pool_fwd",)):
        problems.append(f"train_occ --eval-ckpt exited {rc} or launched no S1")
    return launches, cli_launches, frame, problems


# Phase 19: S1b against its plain version on a training step's recorded
# inputs: d feat sums a pixel's 88 products in bin order as the plain
# version does, d depth is a dot product over 32 channels in another order.
S1B_RTOL, S1B_ATOL_FRAC = 1e-5, 1e-6  # atol: this fraction of the largest gradient
# One training step with the kernels against the same step with the plain
# versions, from the same weights on the same batch: S1 sums in point order
# against index_add_'s atomics (whose order changes from run to run) and
# S1b gathers against index_select, and cuDNN's backward sums in its own
# orders, through a 50-layer network whose train-mode BatchNorm
# renormalises every layer. Each leaf is held within OCC_GRAD_RTOL_FRAC of
# its largest element plus OCC_GRAD_ATOL_FRAC of the largest gradient, and
# the spread between two plain steps is printed beside it as the noise
# floor. On an H100 a first reading put leaves 3.5e-3 of their largest
# element apart; two plain steps then differed by 1.7e-5 of the largest
# gradient in a conv bias that a BatchNorm follows (DepthNet's first
# cost-volume conv over the zero cost volume: a gradient of rounding
# noise, 0 in exact arithmetic), which the atol covers six times over. The
# loss within OCC_LOSS_RTOL.
OCC_GRAD_RTOL_FRAC, OCC_GRAD_ATOL_FRAC, OCC_LOSS_RTOL = 1e-2, 1e-4, 1e-5
OCC_TRAIN_STEPS = 10


def occupancy_train_phase(chk: Checker, card: str):
    """Phase 19: BEVDet-Occ trained at the reference width (see the module
    docstring). Returns (launches on the training path, launches on the
    training CLI, {kernel: (device ms, launches) of a profiled step},
    problems)."""
    import io
    import shutil

    from presight_tpu_torch import kernels
    from presight_tpu_torch.configs.stage3_configs import occ_configs
    from presight_tpu_torch.models.layers import init_weights
    from presight_tpu_torch.occupancy import BEVDetOcc
    from presight_tpu_torch.occupancy import bev_pool as PB
    from presight_tpu_torch.occupancy import view_transformer as PV
    from presight_tpu_torch.scripts import train_occ
    from presight_tpu_torch.utils.ema import ema_init

    problems = []
    out = OUT_DIR / "occupancy_train"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    dev = torch.device("cuda")
    cfg = occ_configs[OCC_CONFIG]()
    model = init_weights(BEVDetOcc(cfg, device=dev), torch.Generator().manual_seed(SEED))
    geo, _, _ = occ_rig(cfg, dev)
    rng = np.random.RandomState(SEED + 19)
    H, W = cfg.input_size
    gx, gy, gz = cfg.grid_size()
    prior_root = OUT_DIR / "occupancy" / "synthetic"
    if not prior_root.exists():
        write_city_prior(prior_root, rng, [1200.0, 850.0, 0.0])
    priors, _ = occ_priors(prior_root, cfg, [1200.0, 850.0, 0.0], dev, "phase 18's synthetic city")
    batch = dict(zip(train_occ._MODEL_INPUTS,
                     [torch.as_tensor(rng.rand(1, 6, 3, H, W).astype(np.float32), device=dev),
                      *geo]), **priors)
    batch["voxel_semantics"] = torch.as_tensor(rng.randint(0, 18, (1, gx, gy, gz)), device=dev)
    batch["mask_camera"] = torch.as_tensor((rng.rand(1, gx, gy, gz) > 0.3).astype(np.uint8),
                                           device=dev)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {OCC_CONFIG} in train mode: {n_params / 1e6:.2f} M parameters; batch 1 of 6 x "
          f"{H} x {W}, labels {gx} x {gy} x {gz} with a camera mask, "
          f"{int(priors['prior_valid'].sum())} prior voxels; no previous frame (the JAX "
          "step's single-frame training: S2 not run)")

    # (b) One step of the CLI's train_step with the kernels against the same
    # step with the plain versions (kernels.plain_versions()), each from the same weights:
    # its loss and the clipped gradients it leaves in p.grad; bev_pool_v2's
    # output carries a grad_fn.
    grad_fns = []

    def watched(*args, **kwargs):
        result = real_pool(*args, **kwargs)
        grad_fns.append(result.grad_fn is not None)
        return result

    def step_from_state0(plain):
        model.load_state_dict(state0)
        with kernels.plain_versions(plain):
            loss, _ = train_occ.train_step(model, train_occ.make_optimizer(model, 1e-4, 1e-2),
                                           ema_init(model), batch)
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        return float(loss), grads

    real_pool = PV.bev_pool_v2
    PV.bev_pool_v2 = watched
    try:
        loss_k, grads_k = step_from_state0(False)
    finally:
        PV.bev_pool_v2 = real_pool
    loss_p, grads_p = step_from_state0(True)
    _, grads_p2 = step_from_state0(True)
    torch.cuda.synchronize()
    largest = max(float(g.abs().max()) for g in grads_p.values())

    def worst_leaf(grads, label):
        worst, worst_name, bad = 0.0, None, []
        for name, gp in grads_p.items():
            g = grads.get(name)
            if g is None:
                bad.append(f"{name} has no gradient {label}")
                continue
            err = float((g - gp).abs().max())
            tol = OCC_GRAD_RTOL_FRAC * float(gp.abs().max()) + OCC_GRAD_ATOL_FRAC * largest
            if err / tol > worst:
                worst, worst_name = err / tol, name
            if not err <= tol:
                bad.append(f"{name}: max_abs_err {err:.3e} > {tol:.3e}")
        return worst, worst_name, bad

    worst, worst_name, bad = worst_leaf(grads_k, "with the kernels")
    spread, spread_name, _ = worst_leaf(grads_p2, "in a second plain step")
    loss_ok = abs(loss_k - loss_p) <= OCC_LOSS_RTOL * abs(loss_p)
    ok = not bad and loss_ok and set(grads_k) == set(grads_p) and grad_fns == [True]
    print(f"  one step, kernels vs plain versions on the card: loss {loss_k:.7f} vs "
          f"{loss_p:.7f} (rtol {OCC_LOSS_RTOL:g}); {len(grads_p)} gradient leaves, largest "
          f"{largest:.3e}, worst leaf {worst_name} at {worst:.4f} of its tolerance (rtol "
          f"{OCC_GRAD_RTOL_FRAC:g} of the leaf's largest + {OCC_GRAD_ATOL_FRAC:g} of the largest); "
          f"two plain steps: worst leaf {spread_name} at {spread:.4f}; bev_pool_v2 output "
          f"grad_fn {grad_fns} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        problems.append("one step with the kernels differs from the plain step: "
                        + "; ".join(bad[:5] or [f"loss {loss_k} vs {loss_p}, grad_fn {grad_fns}"]))
    del grads_k, grads_p, grads_p2

    # The main path, counted: OCC_TRAIN_STEPS steps of the CLI's train_step
    # on the fixed batch from the seeded weights, the first recording S1b's
    # inputs; each step timed on the host clock to a synchronize.
    model.load_state_dict(state0)
    optimizer = train_occ.make_optimizer(model, 1e-4, 1e-2)
    ema = ema_init(model)
    losses, times = [], []
    torch.cuda.synchronize()
    kernels.reset_launches()
    with recording_calls({"s1b": (PB, "bev_pool_bwd", lambda *a: True, 0)}) as rec:
        for i in range(OCC_TRAIN_STEPS):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, ema = train_occ.train_step(model, optimizer, ema, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = statistics.median(times[1:5])
    print(f"  {OCC_TRAIN_STEPS} steps on one batch: losses "
          f"{[round(v, 5) for v in losses]}; launches "
          f"{ {k: launches[k] for k in OCC_KERNEL_INFO} }")
    print(f"  training step ({card}), host clock to a synchronize: first {times[0] * 1e3:.1f} ms, "
          f"steady {steady * 1e3:.1f} ms (median of steps 2-5: "
          f"{[round(t * 1e3, 1) for t in times[1:5]]}); peak memory {peak:.3f} GiB")
    finite = all(np.isfinite(losses)) and all(bool(torch.isfinite(p).all())
                                              for p in model.parameters())
    if not finite or not losses[-1] < losses[0]:
        problems.append(f"the loss did not fall over {OCC_TRAIN_STEPS} steps, or a value is not "
                        f"finite: {losses}")
    for name in ("bev_pool_fwd", "bev_pool_bwd"):
        if launches[name] != OCC_TRAIN_STEPS:
            problems.append(f"{name} launched {launches[name]} times in {OCC_TRAIN_STEPS} steps")
    if launches["stereo_cost_volume_fwd"]:
        problems.append("S2 ran in single-frame training")

    # (a) S1b against its plain version on the first step's recorded inputs.
    if "s1b" not in rec:
        problems.append("no S1b inputs were recorded")
        return launches, {}, {}, problems
    args = rec["s1b"][:7]
    depth_in, feat_in, coor_in, g_in, lb, iv, grid = args
    got = PB.bev_pool_bwd(*args)
    want = PB.bev_pool_v2_bwd_plain(*args)
    for label, a, b in (("d depth", got[0], want[0]), ("d feat", got[1], want[1])):
        chk.close("bev_pool_bwd", f"training step {label}", a, b,
                  S1B_ATOL_FRAC * float(b.abs().max()), S1B_RTOL)
    ranks = PB.voxel_ranks(coor_in, lb, iv, grid)
    cells = gx * gy * gz
    inside = int((ranks < cells).sum())
    outside_zero = bool((got[0][ranks == cells] == 0).all())
    if not outside_zero:
        problems.append("S1b gave a point outside the grid a nonzero d depth")
    occupied = int(torch.unique(ranks[ranks < cells]).numel())
    C = feat_in.shape[-1]
    print(f"  bev_pool_bwd inputs: g {tuple(g_in.shape)} (largest {float(g_in.abs().max()):.3e}), "
          f"{inside} of {ranks.numel()} points in the grid over {occupied} voxels; outside "
          f"points' d depth all 0: {outside_zero}")
    chk.time("bev_pool_bwd", lambda: PB.bev_pool_bwd(*args),
             lambda: PB.bev_pool_v2_bwd_plain(*args))
    flat = torch.cat([g_in.permute(0, 2, 3, 4, 1).reshape(-1, C), g_in.new_zeros((1, C))])
    idx = ranks.reshape(-1).long()
    chk.library["bev_pool_bwd"] = time_ms(lambda: flat.index_select(0, idx))
    # The bytes it must move: depth, feat and coor once, g's rows at the
    # occupied voxels, d depth and d feat; 4 flops a point inside and channel.
    nbytes = 4.0 * (2 * depth_in.numel() + 2 * feat_in.numel() + coor_in.numel()
                    + occupied * C)
    chk.bounds["bev_pool_bwd"] = bound(nbytes, 4.0 * inside * C)
    k_ms, p_ms = chk.times["bev_pool_bwd"]
    b_ms, b_by = chk.bounds["bev_pool_bwd"]
    print(f"  time bev_pool_bwd ({card}): kernel {k_ms:.4f} ms (device "
          f"{chk.device['bev_pool_bwd']:.4f} ms), plain {p_ms:.4f} ms, library (index_select of "
          f"the rows) {chk.library['bev_pool_bwd']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), share "
          f"{b_ms / chk.device['bev_pool_bwd']:.3f}")
    del rec, args, got, want, flat, idx, ranks, depth_in, feat_in, coor_in, g_in

    # (d) One profiled step.
    torch.cuda.empty_cache()
    step = profile_device("profiled training step",
                          lambda: train_occ.train_step(model, optimizer, ema, batch),
                          "occ_train_profile.txt", names=("bev_pool_bwd", "bev_pool_fwd"))
    step = {name: (step.get(name, (0.0, 0))[0], kernels.LAUNCHES[name])
            for name in OCC_KERNEL_INFO}
    del model, optimizer, ema, batch, state0
    torch.cuda.empty_cache()

    # (e) The CLI as a user calls it: 2 iterations at the reference config
    # on the toy batches of its seed, then --eval-ckpt on the pickle.
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_occ.main(["--config", OCC_CONFIG, "--iters", "2", "--out", str(out / "cli")])
    torch.cuda.synchronize()
    cli_launches = dict(kernels.LAUNCHES)
    lines = buf.getvalue().splitlines()
    ckpt = out / "cli" / "occ-step-000000002.pkl"
    print(f"  train_occ --config {OCC_CONFIG} --iters 2 ({card}): exit {rc} in "
          f"{time.perf_counter() - t0:.2f} s; {lines}; launches "
          f"{ {k: cli_launches[k] for k in OCC_KERNEL_INFO} }")
    if rc != 0 or not ckpt.exists() or any(cli_launches[k] != 2 for k in ("bev_pool_fwd",
                                                                           "bev_pool_bwd")):
        problems.append(f"train_occ training exited {rc}, wrote no {ckpt.name} or did not "
                        "launch S1 and S1b twice")
        return launches, cli_launches, step, problems
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_occ.main(["--config", OCC_CONFIG, "--eval-ckpt", str(ckpt)])
    lines = buf.getvalue().splitlines()
    print(f"  train_occ --eval-ckpt on it: exit {rc}; {lines[-1] if lines else None}")
    if rc != 0 or len(lines) != 19 or not lines[-1].startswith("mIoU"):
        problems.append(f"train_occ --eval-ckpt on the trained pickle exited {rc}: {lines[-2:]}")
    return launches, cli_launches, step, problems


MAP_CONFIG = "smn_wcamprior_480_100x50_24e_randomdrop"
MAP_SOURCE_HW = (900, 1600)  # nuScenes images, resized to the model's input without a crop
MAP_PRIOR_VOXELS = 20_000  # the prior contract's cap
MAP_EMBEDDINGS = ("bev_queries", "pos_row", "pos_col", "bev_pos", "queries", "query_pos")
MAP_OFFSET_BIAS_STD = 1.0
# S3 against its plain version on a frame's recorded inputs, at the cuda
# tests' tolerances: msda_fwd within MSDA_ATOL_FRAC of the plain output's
# largest value + MSDA_RTOL (one fused chain of corner and attention
# weights against the corners blended first); deform_im2col_fwd within
# IM2COL_ATOL_FRAC of the input's largest value + IM2COL_RTOL (fmaf blends).
MSDA_RTOL, MSDA_ATOL_FRAC = 1e-5, 1e-5
IM2COL_RTOL, IM2COL_ATOL_FRAC = 1e-5, 1e-6
# Whole frames with the kernels against the same frames with S3's plain
# versions (kernels.plain_versions()) on the card, as max |gap| over the plain output's
# largest value: the same convolutions and products, S3's sums in other
# orders, carried through the encoder, the ConvGRU, the prior fusion and
# six decoder layers. The port against the benchmark's reference on the
# card reads up to 3.6e-5 (scores) and 1.7e-6 (BEV) over 22 runs: these
# limits are ~5x and ~10x that, and half the cell's own.
MAP_REL_GAP = {"scores": 2e-4, "lines": 2e-4, "bev": 2e-5, "prop_queries": 2e-4}


def map_weights(model, seed: int):
    """Weights in flax's default draws, from one CPU generator in state_dict
    order (kernels N(0, 1 / fan-in), biases 0, norms at identity,
    embeddings N(0, 0.02^2)), but for the biases of every sampling-offset
    projection and of DCNv2's (dy, dx) taps, N(0, 1): the taps land between
    pixel centres, one to two cells away, where flax's zero init would put
    every DCN tap on a centre."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            leaf, shape = name.rsplit(".", 1)[-1], tuple(t.shape)
            if leaf in MAP_EMBEDDINGS:
                v = torch.randn(shape, generator=g) * 0.02
            elif leaf == "kernel_w":  # DCNv2's (k*k*C, F) kernel: fan-in on the first axis
                v = torch.randn(shape, generator=g) / shape[0] ** 0.5
            elif len(shape) >= 2:
                v = torch.randn(shape, generator=g) / float(np.prod(shape[1:])) ** 0.5
            else:
                v = torch.zeros(shape)
                if name.endswith("sampling_offsets.bias"):
                    v = torch.randn(shape, generator=g) * MAP_OFFSET_BIAS_STD
                elif name.endswith("offset_mask.bias"):  # (dy, dx) of the k*k taps, then masks
                    taps = shape[0] // 3
                    v[:2 * taps] = torch.randn((2 * taps,), generator=g) * MAP_OFFSET_BIAS_STD
                elif leaf in ("weight", "running_var"):  # a norm's scale or variance
                    v.fill_(1.0)
            t.copy_(v.to(t.dtype))
    return model


def map_rig(img_hw, device):
    """Phase 18's rig (occ_rig) for the mapping model: lidar2img (6, 4, 4)
    of each 1600x900 camera resized to ``img_hw`` without a crop, and the
    2D ego motion prev2curr (3, 3)."""
    (s2e, *_), _, p2c = occ_rig(None, "cpu")
    H, W = img_hw
    scale = np.diag([W / MAP_SOURCE_HW[1], H / MAP_SOURCE_HW[0], 1.0, 1.0])
    viewpad = np.eye(4)
    viewpad[:3, :3] = np.asarray(OCC_INTRINSICS, np.float64)
    s2e = s2e[0].double().numpy()
    l2i = np.stack([scale @ viewpad @ np.linalg.inv(s2e[i]) for i in range(len(s2e))])
    return torch.as_tensor(l2i.astype(np.float32), device=device), p2c[0].to(device)


def map_priors(cfg, rng, device):
    """MAP_PRIOR_VOXELS distinct voxels of the prior grid, (z, y, x), with
    68 standard-normal channels: the padded prior contract, full."""
    lo, hi = np.asarray(cfg.prior_pc_range[:3]), np.asarray(cfg.prior_pc_range[3:])
    X, Y, Z = (int(v) for v in np.ceil((hi - lo) / np.asarray(cfg.prior_voxel_size)))
    cells = rng.permutation(X * Y * Z)[:MAP_PRIOR_VOXELS]
    coords = np.stack([cells // (Y * X), (cells // X) % Y, cells % X], -1).astype(np.int32)
    feats = rng.randn(MAP_PRIOR_VOXELS, cfg.prior_voxel_channels).astype(np.float32)
    return {"prior_feats": torch.as_tensor(feats, device=device),
            "prior_coords": torch.as_tensor(coords, device=device),
            "prior_valid": torch.ones(MAP_PRIOR_VOXELS, dtype=torch.bool, device=device)}


@contextlib.contextmanager
def recording_s3(deformable):
    """While active, keep a copy of the arguments of every S3 launch
    (msda_fwd, deform_im2col_fwd), in order, as (name, args)."""
    calls, real = [], {n: getattr(deformable, n) for n in MAP_KERNEL_INFO}

    def wrap(name, fn):
        def call(*args):
            calls.append((name, tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                      for a in args)))
            return fn(*args)
        return call

    for name, fn in real.items():
        setattr(deformable, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(deformable, name, fn)


def s3_work(name, args):
    """(bytes, FLOPs) of one S3 call, as the benchmark counts them
    (portbench/counts/map.py): msda_fwd reads the value rows, the locations
    and weights once and writes the output, 8 FLOPs a tap and channel;
    deform_im2col_fwd reads x, the offsets and the mask once and writes the
    columns, 9 FLOPs a column entry."""
    if name == "msda_fwd":
        value, _, _, attn = args
        B, Q, Hh, L, T = attn.shape
        R, D = value.shape[1:]
        taps = B * Q * Hh * L * T
        return 4.0 * (B * R * D + 3 * taps + B * Q * D), 8.0 * B * Q * D * L * T
    x, offsets, _, k = args[:4]
    B, H, W, C = x.shape
    entries = B * offsets.shape[1] * offsets.shape[2] * k * k
    return 4.0 * (B * H * W * C + 3 * entries + entries * C), 9.0 * entries * C


MAP_FRAME_KEYS = ("scores", "lines", "bev", "prop_queries", "prop_ref_pts", "prop_index", "keep")


def map_setup(dev):
    """Phase 20's model (weights from SEED), rig, and two frames' images
    and priors: the same in every process."""
    from presight_tpu_torch.configs.stage3_configs import map_configs
    from presight_tpu_torch.mapping import StreamMapNet

    cfg = map_configs[MAP_CONFIG]()
    model = map_weights(StreamMapNet(cfg, device=dev), SEED).eval()
    l2i, p2c = map_rig(cfg.img_size, dev)
    rng = np.random.RandomState(SEED)
    H, W = cfg.img_size
    imgs = [torch.as_tensor(rng.randn(6, 3, H, W).astype(np.float32), device=dev)
            for _ in range(2)]
    priors = [map_priors(cfg, rng, dev) for _ in range(2)]

    def frame(i, carried=None):
        history = {} if carried is None else dict(
            prev_bev=carried["bev"], prev2curr=p2c, prev_queries=carried["prop_queries"],
            prev_ref_pts=carried["prop_ref_pts"])
        return model(imgs[i], l2i, **priors[i], **history)

    return cfg, model, imgs, frame


@contextlib.contextmanager
def recording_conv2d():
    """While active, each F.conv2d call's (input shape, weight shape,
    stride, padding), in order: what cuDNN is handed."""
    import torch.nn.functional as F

    calls, real = [], F.conv2d

    def conv2d(x, w, bias=None, stride=1, padding=0, *args):
        pads = tuple(padding) if isinstance(padding, (list, tuple)) else (padding,) * 2
        calls.append((tuple(x.shape), tuple(w.shape), stride, pads))
        return real(x, w, bias, stride, padding, *args)

    F.conv2d = conv2d
    try:
        yield calls
    finally:
        F.conv2d = real


def conv_flops(key) -> float:
    """2 x output elements x (input channels x kernel taps) of one call."""
    (n, _, h, w), (co, ci, kh, kw), stride, (ph, pw) = key
    ho, wo = (h + 2 * ph - kh) // stride + 1, (w + 2 * pw - kw) // stride + 1
    return 2.0 * n * co * ho * wo * ci * kh * kw


def events_ms(fn, reps: int = 10) -> float:
    """Milliseconds per call of fn(), by CUDA events around ``reps`` calls
    in a row after two more: device_ms without its spin, for calls that
    wait for the card themselves (device_ms refused F.conv2d on the
    heuristic's plans), and so counting the host's share where it exceeds
    the card's."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def conv_shape_ms(keys):
    """events_ms of one convolution of each key (random operands, no
    bias), IEEE f32, on the plan cuDNN holds for the key in this process:
    the one its first call chose (under cuDNN's timing if active then)."""
    import torch.nn.functional as F

    from presight_tpu_torch.utils.precision import ieee_convolutions

    out = []
    with torch.no_grad(), ieee_convolutions():
        for xs, ws, stride, pads in keys:
            x = torch.randn(xs, device="cuda")
            w = torch.randn(ws, device="cuda")
            out.append(events_ms(lambda: F.conv2d(x, w, None, stride, pads)))
            del x, w
    return out


def heuristic_mapping(keys):
    """Phase 20's frames in a fresh process with the forward's
    ``tuned_convolutions`` off, so that cuDNN's heuristic picks every
    engine: frame 1 from scratch and frame 2 from it (outputs as numpy),
    frame 2's host-clock ms (synchronised, 5 times), and conv_shape_ms of
    ``keys`` on the heuristic's plans."""
    from presight_tpu_torch.mapping import stream_mapnet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stream_mapnet.tuned_convolutions = contextlib.nullcontext
    with torch.no_grad():
        _, _, _, frame = map_setup(torch.device("cuda"))
        out1 = frame(0)
        out2 = frame(1, out1)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(1, out1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        outs = [{k: o[k].cpu().numpy() for k in MAP_FRAME_KEYS if k in o} for o in (out1, out2)]
    return outs, times, conv_shape_ms(keys)


def in_fresh_process(fn, *args):
    """fn(*args) in a spawned process (a new cuDNN plan cache), its result."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(fn, args)


@torch.no_grad()
def mapping_phase(chk: Checker, card: str):
    """Phase 20: StreamMapNet serving at the published widths (see the
    module docstring). Returns (launches on the main path's frame,
    {kernel: (device ms, launches) of a profiled frame}, problems)."""
    from presight_tpu_torch import kernels
    from presight_tpu_torch.mapping import deformable as DF
    from presight_tpu_torch.utils.precision import ieee_convolutions, tuned_convolutions
    from presight_tpu_torch.utils.profiler import COUNTS

    problems = []
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, model, imgs, frame = map_setup(dev)
    torch.cuda.synchronize()
    H, W = cfg.img_size
    print(f"  {MAP_CONFIG}: {sum(p.numel() for p in model.parameters())} parameters, init "
          f"{time.perf_counter() - t0:.2f} s; 6 x {H} x {W}, BEV {cfg.bev_hw}, "
          f"{cfg.num_queries} queries x {cfg.num_points} points, top-{cfg.topk_propagate}, "
          f"{MAP_PRIOR_VOXELS} prior voxels")

    # Frame 1 from scratch, then frame 2 from its BEV and hand-off with every
    # S3 launch recorded; then the main path, counted: frame 2 again. cuDNN
    # times each convolution's engines on its shape's first call, so frames
    # 1 and 2 tune, and the counted frame does not.
    t0 = time.perf_counter()
    out1 = frame(0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    with recording_s3(DF) as rec:
        out2 = frame(1, out1)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    again = frame(1, out1)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"  frame 1: {first_s:.2f} s (tuning included); frame 2 (counted): "
          f"{time.perf_counter() - t0:.3f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    expect = {"msda_fwd": 2 * cfg.enc_layers + cfg.dec_layers, "deform_im2col_fwd": 2}
    for name, n in launches.items():
        if n != expect.get(name, 0):
            problems.append(f"{name} launched {n} times in a mapped frame, not "
                            f"{expect.get(name, 0)}")
    P, D = cfg.num_points, cfg.embed_dim
    shapes = {"scores": (cfg.num_queries, cfg.num_classes), "lines": (cfg.num_queries, P, 2),
              "bev": (D, *cfg.bev_hw), "prop_queries": (cfg.topk_propagate, D),
              "prop_ref_pts": (cfg.topk_propagate, P, 2)}
    for key, want in shapes.items():
        for label, out in (("frame 1", out1), ("frame 2", out2)):
            if tuple(out[key].shape) != want:
                problems.append(f"{label} {key} has shape {tuple(out[key].shape)}, not {want}")
            if not bool(torch.isfinite(out[key]).all()):
                problems.append(f"{label} {key} is not finite")
    same = all(torch.equal(again[k], out2[k]) for k in shapes)
    print(f"  frame 2 twice from the same state: {'bitwise equal' if same else 'differs'}; "
          f"BEV frame 2 - frame 1 max {float((out2['bev'] - out1['bev']).abs().max()):.4e}")

    # Both frames with S3's plain versions on the card, from the same state.
    with kernels.plain_versions():
        plain = [frame(0), frame(1, out1)]
    for label, got, want in (("frame 1", out1, plain[0]), ("frame 2", out2, plain[1])):
        gaps = {k: float((got[k].double() - want[k].double()).abs().max()
                         / want[k].double().abs().max()) for k in MAP_REL_GAP}
        choices = all(torch.equal(got[k], want[k]) for k in ("prop_index", "keep") if k in got)
        ok = choices and all(gaps[k] <= lim for k, lim in MAP_REL_GAP.items())
        print(f"  {label}, kernels vs plain versions on the card: " + ", ".join(
            f"{k} {v:.3e} (<= {MAP_REL_GAP[k]:g})" for k, v in gaps.items())
            + f"; top-k choices {'equal' if choices else 'DIFFER'} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            problems.append(f"{label} with the kernels differs from the plain versions")
    del plain, again

    # Each recorded S3 call against its plain version on the same inputs,
    # checked and timed, beside its bound.
    sites = (["tsa", "sca"] * cfg.enc_layers + [f"decoder {i}" for i in range(cfg.dec_layers)])
    labels = {"msda_fwd": iter(sites), "deform_im2col_fwd": iter(["dcn stage 3", "dcn stage 4"])}
    plain_fn = {"msda_fwd": DF.msda_plain, "deform_im2col_fwd": DF.deform_im2col_plain}
    totals = {name: [0.0, 0.0, 0.0, 0.0, set()] for name in MAP_KERNEL_INFO}
    for name, args in rec:
        site = next(labels[name], "extra")
        kernel = getattr(DF, name)
        got, want = kernel(*args), plain_fn[name](*args)
        if name == "msda_fwd":
            atol, rtol = MSDA_ATOL_FRAC * float(want.abs().max()), MSDA_RTOL
        else:
            atol, rtol = IM2COL_ATOL_FRAC * float(args[0].abs().max()), IM2COL_RTOL
        chk.close(name, f"frame 2 {site}", got, want, atol, rtol)
        if not torch.equal(got, kernel(*args)):
            problems.append(f"{name} {site}: two calls differ")
        del got, want
        k_ms = time_ms(lambda: kernel(*args))
        p_ms = time_ms(lambda: plain_fn[name](*args))
        d_ms = device_ms(lambda: kernel(*args))
        nbytes, flops = s3_work(name, args)
        b_ms, b_by = bound(nbytes, flops)
        print(f"  time {name} {site} ({card}): kernel {k_ms:.4f} ms (device {d_ms:.4f} ms), "
              f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), share {b_ms / d_ms:.3f}")
        t = totals[name]
        t[0], t[1], t[2], t[3] = t[0] + k_ms, t[1] + p_ms, t[2] + d_ms, t[3] + b_ms
        t[4].add(b_by)
    for name, (k_ms, p_ms, d_ms, b_ms, by) in totals.items():
        chk.times[name], chk.device[name] = (k_ms, p_ms), d_ms
        chk.library[name] = None  # no PyTorch call computes it
        chk.bounds[name] = (b_ms, " and ".join(sorted(by)))
        print(f"  time {name}, a frame's {expect[name]} calls ({card}): kernel {k_ms:.4f} ms "
              f"(device {d_ms:.4f} ms), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms, share "
              f"{b_ms / max(d_ms, 1e-12):.3f}")
    recorded = collections.Counter(n for n, _ in rec)
    if recorded != collections.Counter(expect):
        problems.append(f"S3 calls recorded in frame 2: {dict(recorded)}, not {expect}")
    del rec

    # Per-frame times (host clock, synchronised), peak memory, a profile
    # (whose frame also counts the SCA's slots: profiling() is true).
    torch.cuda.empty_cache()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame(1, out1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    frame(1, out1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  forward per frame ({card}), host clock, synchronised, median of 5: frame 2 "
          f"{statistics.median(times) * 1e3:.1f} ms {[round(t * 1e3, 1) for t in times]}; "
          f"peak memory {peak:.3f} GiB")
    counters = ("map.sca_pairs", "map.sca_slots", "map.sca_overflow")
    before = {k: COUNTS[k] for k in counters}
    frame_prof = profile_device("profiled mapped frame 2", lambda: frame(1, out1),
                                "map_frame_profile.txt", names=tuple(MAP_KERNEL_INFO))
    frame_prof = {name: (frame_prof[name][0], kernels.LAUNCHES[name]) for name in MAP_KERNEL_INFO}
    counted = {k: COUNTS[k] - before[k] for k in counters}
    print(f"  SCA counters of the profiled frame(s): {counted} (sca_fill "
          f"{100.0 * counted['map.sca_pairs'] / max(counted['map.sca_slots'], 1):.2f}%)")
    if counted["map.sca_slots"] <= 0 or counted["map.sca_overflow"] != 0:
        problems.append(f"the profiled frame's SCA counters read {counted}: nothing counted, "
                        "or the rig overflowed the capacity")

    # The same frames with cuDNN's heuristic choosing every convolution's
    # engine, in a fresh process (cuDNN keeps one plan a key for a
    # process's life), against these; and each image-encoder convolution
    # shape timed on either plan.
    with recording_conv2d() as calls, ieee_convolutions(), tuned_convolutions():
        model.backbone.image_features(imgs[1])
    keys = list(collections.Counter(calls).items())
    heuristic, h_times, h_ms = in_fresh_process(heuristic_mapping, [k for k, _ in keys])
    print(f"  forward per frame ({card}), cuDNN's heuristic engines, median of 5: frame 2 "
          f"{statistics.median(h_times) * 1e3:.1f} ms {[round(t * 1e3, 1) for t in h_times]}")
    for label, got, want in (("frame 1", out1, heuristic[0]), ("frame 2", out2, heuristic[1])):
        gaps = {k: float((got[k].double().cpu() - torch.as_tensor(want[k]).double()).abs().max()
                         / torch.as_tensor(want[k]).double().abs().max()) for k in MAP_REL_GAP}
        choices = all(torch.equal(got[k].cpu(), torch.as_tensor(want[k]))
                      for k in ("prop_index", "keep") if k in got)
        ok = choices and all(gaps[k] <= lim for k, lim in MAP_REL_GAP.items())
        print(f"  {label}, tuned vs heuristic convolution engines: " + ", ".join(
            f"{k} {v:.3e} (<= {MAP_REL_GAP[k]:g})" for k, v in gaps.items())
            + f"; top-k choices {'equal' if choices else 'DIFFER'} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            problems.append(f"{label} with tuned convolution engines differs from the heuristic's")
    t_ms = conv_shape_ms([k for k, _ in keys])
    sums = [0.0, 0.0, 0.0]
    for (key, n), h, t in zip(keys, h_ms, t_ms):
        flops = conv_flops(key)
        sums = [sums[0] + n * h, sums[1] + n * t, sums[2] + n * flops]
        print(f"  conv x {key[0]} w {key[1]} stride {key[2]} pad {key[3]}, {n} a frame "
              f"({card}): heuristic {h:.4f} ms ({flops / h * 1e-9:.2f} TFLOP/s), tuned "
              f"{t:.4f} ms ({flops / t * 1e-9:.2f} TFLOP/s)")
    print(f"  the image encoder's {sum(n for _, n in keys)} convolutions a frame "
          f"({len(keys)} keys, {sums[2] * 1e-9:.1f} GFLOP): heuristic {sums[0]:.3f} ms "
          f"({sums[2] / sums[0] * 1e-9:.2f} TFLOP/s), tuned {sums[1]:.3f} ms "
          f"({sums[2] / sums[1] * 1e-9:.2f} TFLOP/s)")
    return launches, frame_prof, problems


def map_entries(chk: Checker, launches, frame):
    """The kernels JSON line's entries of S3: launches in the main path's
    frame (serve_map), device time and launches in a profiled frame."""
    return [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
             "launches": launches.get(name, 0), "launches_by_path": {
                 "serve_map": launches.get(name, 0)},
             "max_abs_err": chk.errors[name], "ms": chk.times[name][0],
             "device_ms": chk.device[name], "plain_ms": chk.times[name][1],
             "bound_ms": chk.bounds[name][0], "bound_by": chk.bounds[name][1],
             "library_ms": chk.library.get(name), "frame_ms": frame[name][0],
             "frame_launches": frame[name][1]}
            for name, (src, replaces) in MAP_KERNEL_INFO.items()]


def occ_entries(chk: Checker, paths, frame, step):
    """The kernels JSON line's entries of S1, S2 and S1b: launches in all
    and by path (serve_occ, serve_occ_cli, train_occ, train_occ_cli), and
    device time and launches in a profiled frame (serving) and step
    (training)."""
    return [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
             "launches": sum(counts.get(name, 0) for counts in paths.values()),
             "launches_by_path": {path: counts.get(name, 0) for path, counts in paths.items()},
             "max_abs_err": chk.errors[name], "ms": chk.times[name][0],
             "device_ms": chk.device[name], "plain_ms": chk.times[name][1],
             "bound_ms": chk.bounds[name][0], "bound_by": chk.bounds[name][1],
             "library_ms": chk.library.get(name), "frame_ms": frame[name][0],
             "frame_launches": frame[name][1], "step_ms": step[name][0],
             "step_launches": step[name][1]}
            for name, (src, replaces) in OCC_KERNEL_INFO.items()]


def main() -> int:
    t_start = time.perf_counter()
    # Phase 1: the card.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from presight_tpu_torch import kernels, native
    from presight_tpu_torch.configs import TILES, tile_model_config, tile_trainer_config
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
    if "--mapping-only" in sys.argv[1:]:
        print(f"phase 20 alone (--mapping-only): {MAP_CONFIG} served on the card")
        chk = Checker()
        map_launches, map_frame, problems = mapping_phase(chk, card)
        problems += chk.failures
        if problems:
            print("phase 20 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
            return 1
        print(f"phases 1, 2 and 20 passed in {time.perf_counter() - t_start:.0f} s")
        print(json.dumps({"kernels": map_entries(chk, map_launches, map_frame)}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if "--occupancy-only" in sys.argv[1:]:
        print("phases 18 and 19 alone (--occupancy-only): occupancy serving and training")
        chk = Checker()
        occ_launches, occ_cli_launches, frame, problems = occupancy_phase(chk, card, None)
        problems += chk.failures
        if problems:
            print("phase 18 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
            return 1
        torch.cuda.empty_cache()
        print(f"phase 19: {OCC_CONFIG} trained on the card "
              f"({time.perf_counter() - t_start:.0f} s in)")
        train_launches, train_cli_launches, step, problems = occupancy_train_phase(chk, card)
        problems += chk.failures
        if problems:
            print("phase 19 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
            return 1
        print(f"phases 1, 2, 18 and 19 passed in {time.perf_counter() - t_start:.0f} s")
        occ_paths = {"serve_occ": occ_launches, "serve_occ_cli": occ_cli_launches,
                     "train_occ": train_launches, "train_occ_cli": train_cli_launches}
        print(json.dumps({"kernels": occ_entries(chk, occ_paths, frame, step)}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

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
    check_deploy_capacity(model, chk)
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
    H, W = RENDER_HW
    render_cams = cams_gpu.to("cuda")
    render_cams.fx, render_cams.fy = render_cams.fx * 0.5, render_cams.fy * 0.5
    render_cams.cx, render_cams.cy = render_cams.cx * 0.5, render_cams.cy * 0.5
    items, dino_to_rgb = extraction_inputs(config)
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

    problems = serve_problems(img, result, config, H, W)
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
    trainer, train_launches, recorded, _, problems, memory_step_s = train_phase(
        tile_trainer_config("boston-seaport", 0, "camera"), aabbs, cent, cams, KERNEL_INFO)
    if not problems:
        largest = max(recorded.values(), key=lambda rec: rec["rows"].numel())
        del recorded
        k_ms, p_ms, k_dev, chk.library["sorted_accum"], chk.bounds["sorted_accum"] = (
            check_recorded_sorted_accum(chk, largest, "training keys"))
        chk.times["sorted_accum"], chk.device["sorted_accum"] = (k_ms, p_ms), k_dev
        problems = chk.failures
    if problems:
        print("phase 7 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1

    # Phase 8: the training kernel path against the plain path.
    print("phase 8: train step, kernel path vs plain path")
    problems = path_vs_plain_phase(trainer, 2048, 1024)
    if problems:
        print("phase 8 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1
    del largest
    torch.cuda.empty_cache()

    # Phases 9-12: the reference architecture (hash-field first proposal
    # round, per-expert proposal MLPs, 'corner' tables).
    print(f"phase 9: the executed reference golden on the card ({time.perf_counter() - t_start:.0f}"
          " s in)")
    _, problems = golden_phase()
    if problems:
        print("phase 9 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1

    print(f"phase 10: serve boston-seaport-camera-dino-c0 "
          f"({time.perf_counter() - t_start:.0f} s in)")
    render_ref, serve_ref_launches, problems = serve_reference_phase(chk)
    if problems:
        print("phase 10 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1
    torch.cuda.empty_cache()

    print(f"phase 11: train boston-seaport-camera-dino-c0 "
          f"({time.perf_counter() - t_start:.0f} s in)")
    trainer_ref, train_ref_launches, problems = train_reference_phase(chk)
    if problems:
        print("phase 11 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1

    print("phase 12: reference train step, kernel path vs plain path "
          f"({time.perf_counter() - t_start:.0f} s in)")
    problems = path_vs_plain_phase(trainer_ref, 4096, 2048)
    if problems:
        print("phase 12 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1

    # Phase 13: one profiled training step of each profile, after every
    # kernel timing (profile_step).
    print(f"phase 13: profiled training steps ({time.perf_counter() - t_start:.0f} s in)")
    step, problems = profile_step(trainer, "step", "train_profile.txt")
    step_ref, ref_problems = profile_step(trainer_ref, "reference step",
                                          "train_reference_profile.txt")
    if problems or ref_problems:
        print("phase 13 FAILED:\n  " + "\n  ".join(problems + ref_problems), file=sys.stderr)
        return 1
    del trainer, trainer_ref
    torch.cuda.empty_cache()

    # Phases 14-16: the data path from disk.
    print(f"phase 14: the JPEG codec on the card's host ({time.perf_counter() - t_start:.0f} s in)")
    problems = codec_phase()
    if problems:
        print("phase 14 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1
    print(f"phase 15: quality floor, trained from disk ({time.perf_counter() - t_start:.0f} s in)")
    quality_launches, problems = quality_phase()
    if problems:
        print("phase 15 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1
    torch.cuda.empty_cache()
    print(f"phase 16: {DISK_METHOD} from disk through the train CLI "
          f"({time.perf_counter() - t_start:.0f} s in)")
    disk_launches, step_disk, problems, run_dir = disk_cli_phase(memory_step_s)
    if problems:
        print("phase 16 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1
    torch.cuda.empty_cache()
    print(f"phase 17: phase 16's run served through the four CLIs "
          f"({time.perf_counter() - t_start:.0f} s in)")
    serve_cli_launches, problems = serve_cli_phase(run_dir, card)
    if problems:
        print("phase 17 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1
    torch.cuda.empty_cache()
    print(f"phase 18: {OCC_CONFIG} served on the card ({time.perf_counter() - t_start:.0f} s in)")
    occ_launches, occ_cli_launches, frame, problems = occupancy_phase(
        chk, card, OUT_DIR / "serve_cli" / "priors" / "extracted_priors.pkl")
    problems += chk.failures
    if problems:
        print("phase 18 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1
    torch.cuda.empty_cache()
    print(f"phase 19: {OCC_CONFIG} trained on the card ({time.perf_counter() - t_start:.0f} s in)")
    train_occ_launches, train_occ_cli_launches, occ_step, problems = occupancy_train_phase(
        chk, card)
    problems += chk.failures
    if problems:
        print("phase 19 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1
    torch.cuda.empty_cache()
    print(f"phase 20: {MAP_CONFIG} served on the card ({time.perf_counter() - t_start:.0f} s in)")
    map_launches, map_frame, problems = mapping_phase(chk, card)
    problems += chk.failures
    if problems:
        print("phase 20 FAILED:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1
    print(f"all phases passed in {time.perf_counter() - t_start:.0f} s")

    paths = {"serve": serve_launches, "train": train_launches,
             "serve_reference": serve_ref_launches, "train_reference": train_ref_launches,
             "train_quality": quality_launches, "train_disk": disk_launches,
             "serve_cli": serve_cli_launches}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": sum(counts[name] for counts in paths.values()),
         "launches_by_path": {path: counts[name] for path, counts in paths.items()},
         "max_abs_err": chk.errors[name], "ms": chk.times[name][0],
         "device_ms": chk.device[name], "plain_ms": chk.times[name][1],
         "bound_ms": chk.bounds[name][0],
         "bound_by": chk.bounds[name][1], "library_ms": chk.library.get(name),
         "step_ms": step[name][0], "step_launches": step[name][1],
         "render_ms": render[name][0], "render_launches": render[name][1],
         "step_reference_ms": step_ref[name][0], "step_reference_launches": step_ref[name][1],
         "render_reference_ms": render_ref[name][0],
         "render_reference_launches": render_ref[name][1],
         "step_disk_ms": step_disk[name][0], "step_disk_launches": step_disk[name][1]}
        for name, (src, replaces) in KERNEL_INFO.items()]
        + occ_entries(chk, {"serve_occ": occ_launches, "serve_occ_cli": occ_cli_launches,
                            "train_occ": train_occ_launches,
                            "train_occ_cli": train_occ_cli_launches}, frame, occ_step)
        + map_entries(chk, map_launches, map_frame)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
