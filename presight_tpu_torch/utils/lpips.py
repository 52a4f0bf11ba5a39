"""LPIPS, Learned Perceptual Image Patch Similarity (presight_tpu/utils/lpips.py).

The VGG16 variant that torchmetrics' ``LearnedPerceptualImagePatchSimilarity
(normalize=True)`` computes for the reference's eval images:

  * input RGB in [0, 1] -> [-1, 1], then the LPIPS scaling layer (a fixed
    shift and scale per channel);
  * the VGG16 trunk (``F.conv2d``, ``F.max_pool2d``, NCHW), its activations
    tapped at relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3;
  * per tap: unit-normalise over channels, squared difference, the learned
    non-negative 1x1 head (a dot over channels), spatial mean;
  * the sum over the five taps, the mean over the batch.

The convolutions run in full f32 whatever the process's TF32 settings:
PyTorch lets cuDNN convolve in TF32 by default, ~1e-3 relative on the card.

Weights are a dict ``{"convs": [{"w": (out, in, 3, 3), "b": (out,)}, ...],
"lins": [(C,), ...]}``: the JAX package's tree with its HWIO kernels in
torch's OIHW layout. The published VGG16 + LPIPS weights are not shipped;
``load_torch_state_dict`` reads the official ``lpips`` package's state_dict
or torchmetrics' ``net.``-prefixed one, and ``random_weights`` draws the
same shapes from a generator (for tests).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .precision import ieee_convolutions

# VGG16 conv plan: (out_channels, convs in the block); a 2x2 max pool
# between blocks.
_VGG_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

# LPIPS ScalingLayer constants (official lpips package, lpips/lpips.py).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def conv_channel_plan() -> List[Tuple[int, int]]:
    """(in, out) channels of each conv in trunk order."""
    chans = []
    c_in = 3
    for c_out, n in _VGG_PLAN:
        for _ in range(n):
            chans.append((c_in, c_out))
            c_in = c_out
    return chans


def random_weights(generator: torch.Generator) -> Dict:
    """Random weights of the LPIPS-VGG shapes, drawn from ``generator`` as
    the JAX package draws its own: kernels N(0, 1/(9 in)), biases N(0,
    1e-4), heads |N(0, 0.01)|."""
    convs = []
    for c_in, c_out in conv_channel_plan():
        w = torch.randn((c_out, c_in, 3, 3), generator=generator) / math.sqrt(9 * c_in)
        b = torch.randn((c_out,), generator=generator) * 0.01
        convs.append({"w": w, "b": b})
    lins = [torch.randn((c_out,), generator=generator).abs() * 0.1 for c_out, _ in _VGG_PLAN]
    return {"convs": convs, "lins": lins}


def load_torch_state_dict(state: Mapping[str, object]) -> Dict:
    """A torch LPIPS state_dict (numpy arrays or tensors) -> the weights.

    Accepts the official ``lpips`` package's layout (``net.sliceK.<i>.weight``
    and ``linK.model.1.weight``) and torchmetrics' ``net.``-prefixed one;
    matches keys as the JAX loader does and raises ValueError on anything
    that does not give 13 convs and 5 heads."""
    state = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32) for k, v in state.items()}
    convs = []
    for s in range(1, 6):
        idxs = sorted({int(k.split(".")[-2]) for k in state
                       if f"slice{s}." in k and k.endswith(".weight")})
        for i in idxs:
            w = b = None
            for k, v in state.items():
                if f"slice{s}.{i}.weight" in k:
                    w = v
                if f"slice{s}.{i}.bias" in k:
                    b = v
            if w is None or w.ndim != 4:
                continue  # ReLU and pool entries have no weights
            convs.append({"w": w, "b": b})
    lins = []
    for li in range(5):
        for k, v in state.items():
            if f"lin{li}." in k and k.endswith(".weight"):
                lins.append(v.reshape(-1))  # (1, C, 1, 1)
                break
    if len(convs) != len(conv_channel_plan()) or len(lins) != 5:
        raise ValueError(f"unrecognized LPIPS state_dict: {len(convs)} convs, "
                         f"{len(lins)} lin heads")
    return {"convs": convs, "lins": lins}


def to_device(params: Dict, device) -> Dict:
    return {"convs": [{k: v.to(device) for k, v in c.items()} for c in params["convs"]],
            "lins": [v.to(device) for v in params["lins"]]}


def vgg_features(params: Dict, x: torch.Tensor) -> List[torch.Tensor]:
    """Trunk forward: x (N, 3, H, W) scaled input -> the five tapped
    activations."""
    feats = []
    ci = 0
    for bi, (_c, n) in enumerate(_VGG_PLAN):
        if bi > 0:
            x = F.max_pool2d(x, 2, 2)
        for _ in range(n):
            p = params["convs"][ci]
            x = F.relu(F.conv2d(x, p["w"], p["b"], padding=1))
            ci += 1
        feats.append(x)
    return feats


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt(torch.sum(f ** 2, dim=1, keepdim=True)) + eps)


def distance(params: Dict, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """LPIPS of (H, W, 3) or (N, H, W, 3) images in [0, 1], convolving in
    whatever precision the process's settings give (``lpips`` is the
    metric)."""
    if pred.ndim == 3:
        pred, gt = pred[None], gt[None]
    shift = torch.tensor(_SHIFT, device=pred.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=pred.device).view(1, 3, 1, 1)

    def scaled(img):
        return (img.permute(0, 3, 1, 2) * 2.0 - 1.0 - shift) / scale

    total = 0.0
    for a, b, lin in zip(vgg_features(params, scaled(pred)), vgg_features(params, scaled(gt)),
                         params["lins"]):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2  # (N, C, H, W)
        # The learned head is a 1x1 conv to one channel: a dot over C.
        per_pixel = torch.sum(d * lin.view(1, -1, 1, 1), dim=1)  # (N, H, W)
        total = total + torch.mean(per_pixel, dim=(1, 2))
    return torch.mean(total)


@torch.no_grad()
def lpips(params: Dict, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """LPIPS of (H, W, 3) or (N, H, W, 3) images in [0, 1] (the reference's
    ``normalize=True``), the convolutions in IEEE f32."""
    with ieee_convolutions():
        return distance(params, pred, gt)
