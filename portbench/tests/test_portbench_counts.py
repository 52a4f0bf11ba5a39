"""The work counts agree with torch.utils.flop_counter.FlopCounterMode over
the frozen references at a small size."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from tiny import SEED, nerf, occ

from counts import conv as C
from counts import nerf as N
from harness.opcount import count
from reference import nerf as RN
from reference import occ as RO
from traffic import nerf as TN


@pytest.mark.parametrize("proposal_grad", [True, False])
def test_nerf_step_flops_match_the_flop_counter(proposal_grad):
    cell, cfg = nerf()
    model, E, R = cfg["model"], cfg["num_experts"], 64
    aabbs, cent, c2w = TN.scene(E, 1, 0.1)
    shapes = RN.param_shapes(model, E, 6, 1)
    P = TN.weights(SEED, shapes, aabbs, cent, "cpu")
    for path, leaf in RN.leaf_paths(P):
        if not path.endswith(("aabbs", "centroids")):
            leaf.requires_grad_(True)
    cams = TN.cameras(c2w, 18, 32, "cpu")
    g = torch.Generator().manual_seed(0)
    idx = torch.stack([torch.randint(0, 6, (R,), generator=g), torch.randint(0, 18, (R,), generator=g),
                       torch.randint(0, 32, (R,), generator=g)], -1).to(torch.int32)
    batch = {"rgb": torch.rand(R, 3, generator=g), "sky": (torch.rand(R, generator=g) < 0.3).float(),
             "features": torch.rand(R, model["semantic_dim"], generator=g)}
    uniforms = [torch.rand((R, 1), generator=g) for _ in range(3)]
    with FlopCounterMode(display=False) as counter:
        o, d, cam, vid = RN.generate_rays(cams, idx)
        out = RN.forward(P, model, o, d, cam, vid, uniforms, 1.0, not proposal_grad)
        sum(RN.losses(out, batch, model).values()).backward()
    rays_einsum = 2 * 3 * 3 * R  # generate_rays' rotation, not a model FLOP
    assert counter.get_total_flops() - rays_einsum == N.train_step_flops(model, R, proposal_grad)


def test_occ_counts_match_the_flop_counter():
    cell, cfg = occ("occ-train-b4")
    from drivers.occ_train import batches, ref_config, state_spec, weights

    model = RO.BEVDetOcc(ref_config(cfg), device="cpu", with_prior_fusion=True)
    model.load_state_dict(weights(SEED, state_spec(cfg), "cpu"))
    opt = RO.AdamW(list(model.parameters()), 1e-4, 1e-2)
    ema = {k: v.clone() for k, v in model.state_dict().items() if v.is_floating_point()}
    batch = batches(SEED, cfg, 1, "cpu")[0]

    def step():
        RO.train_step(model, opt, ema, 1, batch, 5.0, 0.999)

    mine = count(step)
    with FlopCounterMode(display=False) as counter:
        step()
    assert mine["conv_fwd_flops"] > 0 and mine["conv_bwd_flops"] > mine["conv_fwd_flops"]
    total = mine["conv_fwd_flops"] + mine["conv_bwd_flops"] + mine["matmul_flops"]
    assert total == counter.get_total_flops()


def test_conv_bytes_and_flops_from_shapes():
    # a 3x3 conv, 8 -> 16 channels, 10x10 -> 10x10, batch 2
    b, f = C.conv_fwd((2, 8, 10, 10), (16, 8, 3, 3), (2, 16, 10, 10), bias=True)
    assert f == 2 * 2 * 16 * 100 * 8 * 9
    assert b == 4 * (2 * 8 * 100 + 16 * 8 * 9 + 2 * 16 * 100 + 16)
    b2, f2 = C.conv_bwd((2, 8, 10, 10), (16, 8, 3, 3), (2, 16, 10, 10), False, True)
    assert f2 == f and b2 == 4 * (2 * 16 * 100 + 2 * 8 * 100 + 16 * 8 * 9)


def test_table_grad_rows_are_bounded_by_the_grid_and_the_samples():
    # one level at resolution 16 of one expert holds at most 17^3 corners
    by, fl = N.table_grad_work(10_000, 1, 1, 4, 20, 16, 16)
    assert by == 10_000 * (12 + 4 + 16) + 17 ** 3 * 16
    assert fl == 10_000 * 8 * 6
