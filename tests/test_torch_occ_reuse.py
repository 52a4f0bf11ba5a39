"""The inputs that the card tests of S1 and S2 (tests/test_torch_cuda.py)
build to reach every path of the kernels, and S2's reuse rule as
``stereo_row_fetches`` counts it, on the CPU (no jax, no card):

  * stereo_row_fetches against a loop that holds the four corner rows as
    the kernel's registers do, on the smooth epipolar grids and on random
    ones: the same loads, bin for bin;
  * the smooth grids step by sub-pixel amounts, by exactly one pixel, back,
    and by many pixels, sit on exact integer coordinates, leave the image
    and come back, and carry -2 samples;
  * S1's heavy inputs put over 256 points in a voxel, and the one-voxel
    inputs every point of a batch in one voxel.
"""

import numpy as np
import pytest
import torch

from presight_tpu_torch.occupancy import bev_pool as PB
from presight_tpu_torch.occupancy.view_transformer import stereo_row_fetches
from test_torch_cuda import S1_CASES, S1_GRID, S1_IV, S1_LB, s1_points, smooth_epipolar_grid


def _held_rows_loop(grid, Hs, Ws, D):
    """stereo_row_fetches by a loop over pixels and bins that keeps the
    four rows' corners as the kernel keeps the rows, and checks that every
    row held after a bin is the one the bin needs."""
    BN = grid.shape[0]
    g = grid.reshape(BN, D, Hs * Ws, 2).astype(np.float32)
    x = (g[..., 0] + np.float32(1)) * np.float32(0.5) * np.float32(Ws - 1)
    y = (g[..., 1] + np.float32(1)) * np.float32(0.5) * np.float32(Hs - 1)
    kx = np.clip(np.floor(x), -2, Ws).astype(int)
    ky = np.clip(np.floor(y), -2, Hs).astype(int)
    counts = {"samples": 0, "fetches": 0, "corners": 0, "same": 0, "step": 0, "jump": 0}
    inside = lambda cx, cy: 0 <= cx <= Ws - 1 and 0 <= cy <= Hs - 1  # noqa: E731
    for bn in range(BN):
        for p in range(Hs * Ws):
            held, rows = None, [None] * 4  # rows: the corners the slots 00, 10, 01, 11 hold
            for d in range(D):
                nx, ny = int(kx[bn, d, p]), int(ky[bn, d, p])
                want = [(nx, ny), (nx + 1, ny), (nx, ny + 1), (nx + 1, ny + 1)]
                counts["samples"] += 1
                counts["corners"] += sum(inside(*c) for c in want)
                if held == (nx, ny):
                    counts["same"] += 1
                    continue
                dx, dy = (nx - held[0], ny - held[1]) if held else (9, 9)
                near = abs(dx) <= 1 and abs(dy) <= 1
                counts["step" if near else "jump"] += 1
                if near:
                    if dx == 1:
                        rows[0], rows[2] = rows[1], rows[3]
                    elif dx == -1:
                        rows[1], rows[3] = rows[0], rows[2]
                    if dy == 1:
                        rows[0], rows[1] = rows[2], rows[3]
                    elif dy == -1:
                        rows[2], rows[3] = rows[0], rows[1]
                loads = [not near or dx == -1 or dy == -1, not near or dx == 1 or dy == -1,
                         not near or dx == -1 or dy == 1, not near or dx == 1 or dy == 1]
                for k in range(4):
                    if loads[k]:
                        rows[k] = want[k]
                        counts["fetches"] += inside(*want[k])
                assert rows == want
                held = (nx, ny)
    return counts


@pytest.mark.parametrize("kind", ["smooth", "random"])
def test_stereo_row_fetches_follows_the_kernel_rule(kind):
    rng = np.random.RandomState(3)
    BN, Hs, Ws, D = 2, 9, 17, 40
    if kind == "smooth":
        grid = smooth_epipolar_grid(rng, BN, Hs, Ws, D)
    else:
        grid = (rng.rand(BN, D * Hs * Ws, 2) * 2.6 - 1.3).astype(np.float32)
        grid[:, ::7] = -2.0
    got = stereo_row_fetches(torch.from_numpy(grid), Hs, Ws, D)
    assert got == _held_rows_loop(grid, Hs, Ws, D)
    assert got["samples"] == BN * D * Hs * Ws
    if kind == "smooth":
        assert got["same"] > got["samples"] // 10 and got["step"] > 0 and got["jump"] > 0
        assert got["fetches"] < got["corners"] // 2
    else:
        assert got["same"] < got["samples"] // 10


def test_smooth_epipolar_grid_reaches_every_case():
    rng = np.random.RandomState(1)
    BN, Hs, Ws, D = 2, 17, 33, 88
    grid = smooth_epipolar_grid(rng, BN, Hs, Ws, D).reshape(BN, D, Hs * Ws, 2)
    x = (grid[..., 0] + np.float32(1)) * np.float32(0.5) * np.float32(Ws - 1)
    behind = (grid == -2.0).all(-1)
    x = np.where(behind, np.nan, x)
    step = np.diff(x, axis=1)
    assert behind.mean() > 0.05 and behind[:, :3, ::8].all()
    for value in (1 / 32, 1.0, -1.0, -0.25, 3.0, -6.0):
        assert (step == value).any(), value
    on_integer = x == np.floor(x)
    assert 0.15 < on_integer.mean() < 0.5
    inside = (x >= 0) & (x <= Ws - 1)
    leaves = inside[:, :-1] & ~inside[:, 1:] & ~behind[:, 1:]
    enters = ~inside[:, :-1] & inside[:, 1:] & ~behind[:, :-1]
    assert leaves.any() and enters.any()


@pytest.mark.parametrize("kind,B,N,D,H,W,C",
                         [c for c in S1_CASES if c[0] in ("heavy", "one_voxel")])
def test_s1_heavy_inputs_fill_the_voxels_they_name(kind, B, N, D, H, W, C):
    depth, feat, coor = s1_points(np.random.RandomState(0), kind, B, N, D, H, W, C)
    ranks = PB.voxel_ranks(torch.from_numpy(coor), S1_LB, S1_IV, S1_GRID).reshape(-1)
    cells = B * int(np.prod(S1_GRID))
    counts = torch.bincount(ranks[ranks < cells], minlength=cells)
    if kind == "one_voxel":
        assert int((counts > 0).sum()) == B and int(counts.max()) == N * D * H * W
    else:
        assert int(counts.max()) > 256 and int((counts >= 150).sum()) >= 3 * B
    out = PB.bev_pool_v2(*(torch.from_numpy(a) for a in (depth, feat, coor)), S1_LB, S1_IV,
                         S1_GRID)
    assert torch.equal((out[:, 0] > 0).reshape(-1), counts > 0)
