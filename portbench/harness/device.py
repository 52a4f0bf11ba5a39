"""The card the run measures: presence, name, power limit, peak memory,
and the guard against JAX in the process."""

from __future__ import annotations

import shutil
import subprocess
import sys
from typing import Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "presight_tpu")


def require_cards(count: int) -> None:
    """Exit with code 2, printing no result, without ``count`` CUDA cards."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        print(f"portbench: the cell needs {count} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        sys.exit(2)


def power_limit_w() -> float:
    """The first card's power limit in watts (nvidia-smi), or -1 unread."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return -1.0
    try:
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (subprocess.SubprocessError, ValueError, IndexError, OSError):
        return -1.0


def device_info(count: int) -> Dict:
    import torch

    torch.cuda.synchronize()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(count)),
            "power_limit_w": power_limit_w()}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax, optax, orbax
    or the JAX package, compared whole (presight_tpu_torch is not
    presight_tpu)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))
