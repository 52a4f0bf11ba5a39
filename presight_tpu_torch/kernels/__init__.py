"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each source is compiled for sm_90a by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), keyed on a hash
of the sources and placed under ``<repo>/build/kernels/``. The library is
built at first use and loaded with ctypes; nothing here runs when the module
is imported, so machines without nvcc (and the CPU tests) import it freely.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``. :func:`launch` is the one way to call one: it passes
the current stream, raises on a nonzero code and counts the launch in
``LAUNCHES``, so a run can show that its main path went through them.

:func:`use_plain` is the one rule that picks a hand kernel or its plain
version: the plain version on a CPU tensor, and on any tensor (or for the
host libraries, on none) inside :func:`plain_versions`, the scope a check
on the card runs the plain versions under.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
_ARGTYPES = {
    # pos, expert, tables (host array), scales (host array), n, L, F,
    # log2T, storage, expert_stride_rows, out, stream
    "hash_encode_fwd": [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I64, _P, _P],
    # h, block_expert, n, rows_per_group, rows_per_cta, weights (host array),
    # biases (host array), dims (host array), n_layers, sigmoid, out, stream
    "mlp_blocks_fwd": [_P, _P, _I64, _I64, _I64, _P, _P, _P, _I, _I, _P, _P],
    # deltas, density, steps, clip, payload, payload_index, R, S, C,
    # threshold, weights, acc, depth, expected, composite, stream
    "volume_render_fwd": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _F,
                          _P, _P, _P, _P, _P, _P],
    # pos, centroids, aabbs, grid, n, E, G, out, stream
    "prop_grid_density_fwd": [_P, _P, _P, _P, _I64, _I, _I, _P, _P],
    # pos, expert, grad, scales (host array), n, L, F, log2T, storage, keys,
    # rows, stream
    "hash_encode_bwd": [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _P, _P, _P],
    # h, block_expert, dout, n, rows_per_group, rows_per_cta, E, weights,
    # biases (host arrays), dims (host array), n_layers, sigmoid, dx,
    # dweights, dbiases (host arrays), partial, index, stream
    "mlp_blocks_bwd": [_P, _P, _P, _I64, _I64, _I64, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                       _P, _P],
    # deltas, density, steps, clip, payload, payload_index, weights, g_w,
    # g_acc, g_exp, g_comp, R, S, C, P, d_density, d_payload, scratch, stream
    "volume_render_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I64,
                          _P, _P, _P, _P],
    # keys, order, rows, n, C, out parts (host array), num_parts, part_rows,
    # vec, scratch, flags, stream
    "sorted_accum": [_P, _P, _P, _I64, _I, _P, _I, _I64, _I, _P, _P, _P],
    # depth, feat, coor, n, points per batch, D*H*W, H*W, C, B, lb (x, y, z),
    # interval (x, y, z), X, Y, Z, scratch, out, stream
    "bev_pool_fwd": [_P, _P, _P, _I64, _I64, _I64, _I64, _I, _I, _F, _F, _F, _F, _F, _F,
                     _I, _I, _I, _P, _P, _P],
    # prev, curr, grid, BN, H, W, C, D, bias, out, cost, invalid, stream
    "stereo_cost_volume_fwd": [_P, _P, _P, _I64, _I, _I, _I, _I, _F, _P, _P, _P, _P],
    # depth, feat, coor, g, B, N, D, H*W, C, lb (x, y, z), interval (x, y, z),
    # X, Y, Z, d_depth, d_feat, stream
    "bev_pool_bwd": [_P, _P, _P, _P, _I, _I, _I, _I64, _I, _F, _F, _F, _F, _F, _F, _I, _I, _I,
                     _P, _P, _P],
    # value, loc, attn, levels (host array of 3 * L int64: h, w, first row),
    # B, Q, R, D, heads, L, T, out, stream
    "msda_fwd": [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _P, _P],
    # x (NHWC), offsets, mask, B, H, W, C, Ho, Wo, k, stride, cols, stream
    "deform_im2col_fwd": [_P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I, _P, _P],
}

# C functions that launch nothing: (argtypes, restype).
_QUERIES = {
    # R, S, C, with_payload -> floats of K3b's scratch buffer
    "volume_render_bwd_scratch_floats": ([_I64, _I, _I, _I], _I64),
    # points, voxels -> int32 words of S1's scratch buffer
    "bev_pool_scratch_ints": ([_I64, _I64], _I64),
}

KERNELS = tuple(_ARGTYPES)
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_lib: Optional[ctypes.CDLL] = None
# A module flag, not a thread-local one: autograd runs a CUDA backward on its
# own thread.
_plain = False


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libpresight_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile each ``csrc/*.cu`` in its own nvcc process, all at once, and
    link the objects into one shared library, unless the library for these
    exact sources exists. Returns its path; the compiler's reports
    (registers, shared memory, spills) go to ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for src, proc in zip(sorted(CSRC.glob("*.cu")), procs):
        text = proc.communicate()[0]
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{text[-3000:]}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr[-3000:]}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, (argtypes, restype) in _QUERIES.items():
            fn = getattr(handle, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = handle
    return _lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` with ``args`` on the current stream; raise on
    its error code, else count it."""
    code = getattr(lib(), name)(*args, stream())
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")
    LAUNCHES[name] += 1


def use_plain(t: Optional[torch.Tensor] = None) -> bool:
    """The plain version runs, not the hand kernel: on a CPU tensor, and on
    any tensor or none inside :func:`plain_versions`."""
    return _plain or (t is not None and t.device.type == "cpu")


@contextlib.contextmanager
def plain_versions(on: bool = True):
    """Inside the block every wrapper runs its plain version (with ``on``
    false: its kernel on CUDA tensors), the setting before the block
    restored after it, also when the block raises."""
    global _plain
    before = _plain
    _plain = on
    try:
        yield
    finally:
        _plain = before


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def host_ptrs(values) -> ctypes.Array:
    return (ctypes.c_void_p * len(values))(*values)
