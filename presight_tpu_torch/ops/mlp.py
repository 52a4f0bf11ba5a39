"""Small MLPs, single-expert and expert-grouped (presight_tpu/ops/mlp.py).

Weights keep the JAX layout: W (in, out) or stacked (E, in, out), b (out,)
or (E, out). ``apply_mlp_blocks`` and ``apply_mlp`` run a
``torch.autograd.Function`` whose forward is kernel K2 (csrc/mlp_blocks.cu)
and whose backward is kernel K2b (csrc/mlp_blocks_bwd.cu): dX, and dW, db
per expert, with the ReLU masks and the sigmoid epilogue differentiated
inside. Both run every product on the tensor cores in 3xTF32 (f32
accuracy). The kernels launch, or the plain PyTorch versions run where
``kernels.use_plain`` says so (CPU tensors; the backward's formula written
out, not autograd); the Function's backward follows its forward.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from .. import kernels

Params = List[Tuple[torch.Tensor, torch.Tensor]]

GROUP_BLOCK = 512  # rows per expert block of the grouped layout
_MAX_LAYERS = 4
_MAX_WIDTH = 80  # widest layer K2 and K2b take
_TILE = 64  # a CUDA block's rows are a multiple of it; must divide the expert block
_ROWS_PER_CTA = (512, 256, 128)  # the choices above _TILE, largest first
_CTAS_PER_SM = 2  # the least launch the rows per block are chosen for


def mlp_layer_dims(in_dim: int, num_layers: int, layer_width: int,
                   out_dim: int) -> List[Tuple[int, int]]:
    if num_layers == 1:
        return [(in_dim, out_dim)]
    dims = [(in_dim, layer_width)]
    dims += [(layer_width, layer_width)] * (num_layers - 2)
    dims += [(layer_width, out_dim)]
    return dims


def init_mlp(generator: torch.Generator, in_dim: int, num_layers: int,
             layer_width: int, out_dim: int, num_experts: int = 0) -> Params:
    """torch.nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    weight and bias; num_experts=0 gives unstacked layers."""
    params: Params = []
    for fan_in, fan_out in mlp_layer_dims(in_dim, num_layers, layer_width, out_dim):
        bound = 1.0 / math.sqrt(fan_in)
        lead = (num_experts,) if num_experts else ()
        w = (torch.rand(lead + (fan_in, fan_out), generator=generator) * 2 - 1) * bound
        b = (torch.rand(lead + (fan_out,), generator=generator) * 2 - 1) * bound
        params.append((w, b))
    return params


def block_offsets(group_sizes: torch.Tensor, block: int):
    """Per-expert (padded_sizes, pad_offsets, orig_offsets) of the
    block-aligned slab layout -- the one definition of the padding rule."""
    padded_sizes = ((group_sizes + block - 1) // block) * block
    zero = torch.zeros((1,), dtype=group_sizes.dtype, device=group_sizes.device)
    pad_offsets = torch.cat([zero, torch.cumsum(padded_sizes, 0)[:-1]])
    orig_offsets = torch.cat([zero, torch.cumsum(group_sizes, 0)[:-1]])
    return padded_sizes, pad_offsets, orig_offsets


def _blocked_layout(group_sizes: torch.Tensor, n: int, block: int):
    """Padded block layout of rows sorted by expert. Returns (dest (N,),
    src (n_pad,), slot_valid (n_pad,), block_expert (n_pad // block,),
    n_pad): dest maps sorted row -> padded slot, src padded slot -> sorted
    row (clipped on padding slots, where slot_valid is False)."""
    e = group_sizes.shape[0]
    device = group_sizes.device
    n_pad = (-(-n // block) + e) * block
    group_sizes = group_sizes.to(torch.int64)
    padded_sizes, pad_offsets, orig_offsets = block_offsets(group_sizes, block)
    row_ids = torch.arange(n, device=device)
    expert_of_row = torch.searchsorted(orig_offsets + group_sizes, row_ids, right=True)
    expert_of_row = torch.clamp(expert_of_row, max=e - 1)
    dest = pad_offsets[expert_of_row] + (row_ids - orig_offsets[expert_of_row])

    num_blocks = n_pad // block
    block_starts = torch.arange(num_blocks, device=device) * block
    block_expert = torch.searchsorted(pad_offsets + padded_sizes, block_starts, right=True)
    block_expert = torch.clamp(block_expert, max=e - 1)

    e_slot = torch.repeat_interleave(block_expert, block)
    slot_off = torch.arange(n_pad, device=device) - pad_offsets[e_slot]
    src = orig_offsets[e_slot] + slot_off
    slot_valid = (slot_off >= 0) & (slot_off < group_sizes[e_slot])
    src = torch.clamp(src, 0, max(n - 1, 0))
    return (dest.to(torch.int32), src.to(torch.int32), slot_valid,
            block_expert.to(torch.int32), n_pad)


def apply_mlp_blocks_plain(params: Params, h: torch.Tensor,
                           block_expert: Optional[torch.Tensor],
                           sigmoid: bool = False) -> torch.Tensor:
    """Plain version of K2: per-block batched matmuls with each block's
    expert weights; block_expert None means one expert (unstacked or E=1)."""
    n_layers = len(params)
    for i, (w, b) in enumerate(params):
        if block_expert is None:
            w2 = w if w.dim() == 2 else w[0]
            b2 = b if b.dim() == 1 else b[0]
            h = h @ w2 + b2
        else:
            num_blocks = block_expert.shape[0]
            hb = h.reshape(num_blocks, h.shape[0] // num_blocks, -1)
            be = block_expert.long()
            hb = torch.bmm(hb, w[be]) + b[be][:, None, :]
            h = hb.reshape(h.shape[0], -1)
        if i < n_layers - 1:
            h = torch.relu(h)
    if sigmoid:
        h = torch.sigmoid(h)
    return h


def _check_mlp(name: str, params: Params, h: torch.Tensor,
               block_expert: Optional[torch.Tensor], *extra: torch.Tensor):
    """Validate a K2/K2b launch; returns (dims, rows_per_group)."""
    n = h.shape[0]
    if not 1 <= len(params) <= _MAX_LAYERS:
        raise ValueError(f"{name}: 1..{_MAX_LAYERS} layers, got {len(params)}")
    dims = [h.shape[1]]
    for w, b in params:
        if w.dim() != 3 or w.shape[-2] != dims[-1] or b.shape[-1] != w.shape[-1]:
            raise ValueError(f"{name}: layer shapes do not chain")
        dims.append(w.shape[-1])
    if not all(1 <= d <= _MAX_WIDTH for d in dims):
        raise ValueError(f"{name}: layer widths {dims} outside 1..{_MAX_WIDTH}")
    tensors = [h, *extra] + [t for wb in params for t in wb]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32 activations and weights")
    rows_per_group = 0
    if block_expert is not None:
        if block_expert.dtype != torch.int32 or n % block_expert.shape[0]:
            raise ValueError(f"{name}: int32 block_expert must divide the rows")
        rows_per_group = n // block_expert.shape[0]
        if rows_per_group % _TILE:
            raise ValueError(f"{name}: expert block {rows_per_group} not a multiple of {_TILE}")
        tensors.append(block_expert)
    kernels.require_cuda(name, *tensors)
    return dims, rows_per_group


def choose_rows_per_cta(n: int, rows_per_group: int, num_sms: int) -> int:
    """Rows of one CUDA block of K2/K2b: the largest of 512, 256, 128 that
    divides the expert block (any, for one expert) and still gives the
    launch two blocks per SM, else 64. Each block loads its expert's
    weights once for all of its rows."""
    for rows in _ROWS_PER_CTA:
        if (rows_per_group == 0 or rows_per_group % rows == 0) \
                and -(-n // rows) >= _CTAS_PER_SM * num_sms:
            return rows
    return _TILE


_SM_COUNT: dict = {}


def _launch_rows(n: int, rows_per_group: int, device: torch.device) -> int:
    if device not in _SM_COUNT:
        _SM_COUNT[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return choose_rows_per_cta(n, rows_per_group, _SM_COUNT[device])


def _mlp_kernel(params: Params, h: torch.Tensor, block_expert: Optional[torch.Tensor],
                sigmoid: bool) -> torch.Tensor:
    n = h.shape[0]
    dims, rows_per_group = _check_mlp("mlp_blocks_fwd", params, h, block_expert)
    rows = _launch_rows(n, rows_per_group, h.device)
    out = torch.empty((n, dims[-1]), dtype=torch.float32, device=h.device)
    kernels.launch("mlp_blocks_fwd", h.data_ptr(), kernels.ptr(block_expert), n,
                   rows_per_group, rows, kernels.host_ptrs([w.data_ptr() for w, _ in params]),
                   kernels.host_ptrs([b.data_ptr() for _, b in params]),
                   (ctypes.c_int * len(dims))(*dims), len(params), int(sigmoid), out.data_ptr())
    return out


def mlp_blocks_fwd(params: Params, h: torch.Tensor, block_expert: Optional[torch.Tensor],
                   sigmoid: bool = False) -> torch.Tensor:
    """Wrapper of K2 on stacked (E, in, out) weights: the kernel, or the
    plain version where ``kernels.use_plain``."""
    if kernels.use_plain(h):
        return apply_mlp_blocks_plain(params, h, block_expert, sigmoid)
    return _mlp_kernel(params, h, block_expert, sigmoid)


def mlp_blocks_bwd_plain(params: Params, h: torch.Tensor,
                         block_expert: Optional[torch.Tensor], sigmoid: bool,
                         grad: torch.Tensor,
                         relu_masks: Optional[List[torch.Tensor]] = None):
    """Plain version of K2b on stacked (E, in, out) weights: recompute the
    forward, then per layer from the last dPre = dAct * relu'(act) (and
    sigmoid' on the output), dW = act^T dPre and db = sum dPre per block,
    summed per expert, and dAct = dPre W^T. Returns (dX, [(dW, db), ...]).
    relu_masks, one bool (n, out) tensor per hidden layer, replaces act > 0
    as the ReLU's gate (to hold K2b against the plain backward on K2's own
    masks)."""
    n_layers = len(params)
    num_blocks = 1 if block_expert is None else block_expert.shape[0]
    be = torch.zeros((1,), dtype=torch.long, device=h.device) if block_expert is None \
        else block_expert.long()
    acts = [h]
    x = h
    for i, (w, b) in enumerate(params):
        xb = x.reshape(num_blocks, -1, x.shape[1])
        x = (torch.bmm(xb, w[be]) + b[be][:, None, :]).reshape(x.shape[0], -1)
        if i < n_layers - 1:
            x = torch.relu(x)
        acts.append(x)
    d = grad
    if sigmoid:
        s = torch.sigmoid(acts[-1])
        d = d * (s * (1.0 - s))
    grads = []
    for i in range(n_layers - 1, -1, -1):
        w, b = params[i]
        if i < n_layers - 1:
            mask = acts[i + 1] > 0 if relu_masks is None else relu_masks[i]
            d = torch.where(mask, d, torch.zeros_like(d))
        a = acts[i].reshape(num_blocks, -1, acts[i].shape[1])
        db_ = d.reshape(num_blocks, -1, d.shape[1])
        dw = torch.zeros_like(w).index_add_(0, be, torch.bmm(a.transpose(1, 2), db_))
        dbias = torch.zeros_like(b).index_add_(0, be, db_.sum(dim=1))
        grads.insert(0, (dw, dbias))
        d = torch.bmm(db_, w[be].transpose(1, 2)).reshape(d.shape[0], -1)
    return d, grads


def mlp_blocks_bwd(params: Params, h: torch.Tensor, block_expert: Optional[torch.Tensor],
                   sigmoid: bool, grad: torch.Tensor):
    """Wrapper of K2b (see mlp_blocks_bwd_plain for the contract)."""
    if kernels.use_plain(h):
        return mlp_blocks_bwd_plain(params, h, block_expert, sigmoid, grad)
    n = h.shape[0]
    dims, rows_per_group = _check_mlp("mlp_blocks_bwd", params, h, block_expert, grad)
    if grad.shape != (n, dims[-1]):
        raise ValueError("mlp_blocks_bwd: grad must be (n, out)")
    rows = _launch_rows(n, rows_per_group, h.device)
    num_experts = params[0][0].shape[0]
    dx = torch.empty_like(h)
    grads = [(torch.empty_like(w), torch.empty_like(b)) for w, b in params]
    partial_size = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    num_ctas = -(-n // rows)
    partial = torch.empty((num_ctas, partial_size), dtype=torch.float32, device=h.device)
    # the reduction's index, filled on the device by the kernel's counting sort
    index = torch.empty((num_ctas + num_experts + 1,), dtype=torch.int32, device=h.device)
    kernels.launch("mlp_blocks_bwd", h.data_ptr(), kernels.ptr(block_expert), grad.data_ptr(),
                   n, rows_per_group, rows, num_experts,
                   kernels.host_ptrs([w.data_ptr() for w, _ in params]),
                   kernels.host_ptrs([b.data_ptr() for _, b in params]),
                   (ctypes.c_int * len(dims))(*dims), len(params), int(sigmoid), dx.data_ptr(),
                   kernels.host_ptrs([dw.data_ptr() for dw, _ in grads]),
                   kernels.host_ptrs([db.data_ptr() for _, db in grads]), partial.data_ptr(),
                   index.data_ptr())
    return dx, grads


def _apply(h: torch.Tensor, block_expert: Optional[torch.Tensor], sigmoid: bool,
           flat: List[torch.Tensor]) -> torch.Tensor:
    """K2 through the autograd Function when a gradient is wanted, else
    straight through K2's wrapper."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h, *flat)):
        return _MlpBlocks.apply(h, block_expert, sigmoid, *flat)
    return mlp_blocks_fwd(list(zip(flat[0::2], flat[1::2])), h, block_expert, sigmoid)


class _MlpBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, block_expert, sigmoid, *flat):
        params = list(zip(flat[0::2], flat[1::2]))
        ctx.sigmoid, ctx.plain = sigmoid, kernels.use_plain(h)
        ctx.save_for_backward(h, block_expert, *flat)
        return mlp_blocks_fwd(params, h, block_expert, sigmoid)

    @staticmethod
    def backward(ctx, grad):
        h, block_expert, *flat = ctx.saved_tensors
        params = list(zip(flat[0::2], flat[1::2]))
        with kernels.plain_versions(ctx.plain):
            dx, grads = mlp_blocks_bwd(params, h, block_expert, ctx.sigmoid, grad.contiguous())
        return (dx if ctx.needs_input_grad[0] else None, None, None,
                *[t for pair in grads for t in pair])


def apply_mlp_blocks(params: Params, h: torch.Tensor, block_expert: torch.Tensor,
                     sigmoid: bool = False) -> torch.Tensor:
    """Expert-grouped MLP on an already block-padded batch (n_pad, in) with
    stacked (E, in, out) weights; the expert block is n_pad / num_blocks.
    Differentiable in h and the weights (K2 forward, K2b backward)."""
    return _apply(h, block_expert, sigmoid, [t for wb in params for t in wb])


def apply_mlp(params: Params, x: torch.Tensor, sigmoid: bool = False) -> torch.Tensor:
    """One unstacked MLP (ReLU between layers, optional sigmoid) through
    K2/K2b as a single expert."""
    return _apply(x, None, sigmoid, [t for w, b in params for t in (w.unsqueeze(0), b.unsqueeze(0))])


def apply_mlp_grouped(params: Params, x: torch.Tensor, group_sizes: torch.Tensor,
                      sigmoid: bool = False, block: int = GROUP_BLOCK) -> torch.Tensor:
    """Expert-grouped MLP over rows sorted by expert: pad into per-expert
    block-aligned slabs, run K2, gather back."""
    n = x.shape[0]
    dest, src, slot_valid, block_expert, _ = _blocked_layout(group_sizes, n, block)
    h = x[src.long()] * slot_valid[:, None].to(x.dtype)
    h = apply_mlp_blocks(params, h, block_expert)
    out = h[dest.long()]
    if sigmoid:
        out = torch.sigmoid(out)
    return out
