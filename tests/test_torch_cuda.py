"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a CUDA device). This file imports no jax, so it runs on the GPU
machine, which has none:

    python3 -m pytest tests/test_torch_cuda.py --noconftest -q

The golden (tests/goldens/full_model.npz) on the card is held to
test_full_model_parity.py's quantile checks and field-query tolerances.

Tolerances: as chip_smoke.py -- K1 atol 1e-7 + rtol 1e-5 (its two orders
of (sample, level) pairs and two calls bitwise equal); K2 atol 1e-5 +
rtol 1e-4 (3xTF32 products; its ReLU masks may differ from the plain
forward's only at ties, and K2b is held against the plain backward on
K2's own masks); K3 and the rendered image atol 1e-5 + rtol 1e-5 (K3's
median depth exact but at threshold ties; two K3 calls bitwise equal); K4
atol 1e-6 + rtol 1e-5; K1b keys exact, rows atol 1e-7 + rtol 1e-6; K5 and the table
gradient atol 1e-5 + rtol 1e-5 (run sums in one order against
segment_reduce's; two K5 calls bitwise equal); K2b and K3b atol 1e-5 of the largest gradient + rtol
1e-4 (per-tile against per-block partial sums; warp scans against cumsum).
Sums are taken in other orders than the plain versions'; expert routing is
exact.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from presight_tpu_torch import kernels
from presight_tpu_torch.configs import HashEncodingConfig, NerfactoNuscMSConfig, OptimizerGroupConfig
from presight_tpu_torch.data.cameras import CameraParams
from presight_tpu_torch.engine.evaluator import ImageRenderer
from presight_tpu_torch.fields import prop_field as PF
from presight_tpu_torch.engine.import_reference import import_reference_state_dict
from presight_tpu_torch.fields.router import build_padded_routing, build_routing
from presight_tpu_torch.models.nerfacto_ms import NerfactoNuscMS, init_model
from presight_tpu_torch.ops import hash_encoding as HE
from presight_tpu_torch.ops import mlp as M
from presight_tpu_torch.ops import renderers as VR
from presight_tpu_torch.ops.rays import RayBundle

pytestmark = pytest.mark.cuda

GOLD = Path(__file__).parent / "goldens" / "full_model.npz"
# The executed reference golden's generator config (test_full_model_parity.py).
GOLDEN_CONFIG = dict(
    near_plane=0.05, far_plane=50.0, piecewise_sampler_threshold=5.0,
    num_levels=4, base_res=4, max_res=64, log2_hashmap_size=10,
    features_per_level=2, hidden_dim=16, hidden_dim_color=16,
    num_proposal_samples_per_ray=(12, 6), num_nerf_samples_per_ray=6,
    proposal_net_args_list=(
        dict(features_per_level=1, log2_hashmap_size=9, num_levels=3, base_res=4, max_res=32),
        dict(features_per_level=1, log2_hashmap_size=9, num_levels=3, base_res=4, max_res=64),
    ),
    num_sky_mlp_layers=3, sky_mlp_dims=16, use_semantics=True, semantic_dim=64,
    appearance_embed_dim=4, video_embed_dim=12, hash_storage="corner",
)


def load_golden():
    """(reference state_dict, rays and outputs, the port's config)."""
    data = np.load(GOLD)
    state = {k[len("state::"):]: data[k] for k in data.files if k.startswith("state::")}
    io = {k: data[k] for k in data.files if not k.startswith("state::")}
    return state, io, NerfactoNuscMSConfig(**GOLDEN_CONFIG)


def golden_bundle(io, device):
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    n = len(io["origins"])
    return RayBundle(origins=t(io["origins"]), directions=t(io["directions"]),
                     nears=torch.zeros(n, device=device), fars=torch.zeros(n, device=device),
                     camera_indices=t(io["camera_indices"][:, 0]),
                     video_ids=t(io["video_ids"][:, 0]))


def quantile_report(name, ours, ref, tight=2e-4, tight_frac=0.9, worst=0.08, median_tol=5e-5):
    """test_full_model_parity.py's check: the median ray at fp-accumulation
    level, >= 90% of rays tight, the worst ray within one resampled bin.
    Returns (line, ok)."""
    per_ray = np.abs(np.asarray(ours) - ref).reshape(len(ref), -1).max(-1)
    med, frac, top = float(np.median(per_ray)), float((per_ray < tight).mean()), float(per_ray.max())
    ok = med < median_tol and frac >= tight_frac and top < worst
    return (f"golden {name}: median ray {med:.3e} (< {median_tol:g}), {frac:.3f} of rays within "
            f"{tight:g} (>= {tight_frac:g}), worst {top:.3e} (< {worst:g})", ok)


def golden_forward_report(out, io, far=50.0):
    """An eval forward's outputs (numpy) against the golden, at
    test_full_model_parity.py's tolerances: [(line, ok)]."""
    return [
        quantile_report("rgb", out["rgb"], io["rgb"]),
        quantile_report("accumulation", out["accumulation"][:, None], io["accumulation"],
                        tight=5e-4, median_tol=5e-4, worst=0.01),
        quantile_report("semantics", out["semantics"], io["semantics"], median_tol=2e-4),
        quantile_report("expected_depth", out["expected_depth"][:, None] / far,
                        io["expected_depth"] / far, tight=1e-2, median_tol=5e-3, worst=0.05),
        quantile_report("depth", out["depth"][:, None] / far, io["depth"] / far, tight=1e-2,
                        median_tol=5e-3, worst=0.05),
    ]


@torch.no_grad()
def golden_query_report(model, io):
    """The field queries (field_density, field_semantics, prop_density of
    each round) at the golden's query points against its values, at
    test_full_model_parity.py's rtol and atol: [(line, ok)]."""
    pts = torch.from_numpy(io["query_points"]).to(next(model.parameters()).device)
    props = model.params()["props"]
    queries = [("field_density", model.field_density(pts), io["query_density"], 2e-4, 1e-5),
               ("field_semantics", model.field_semantics(pts), io["query_semantics"], 1e-3, 2e-5)]
    queries += [(f"prop_density round {i}", PF.prop_density(props[i], model.config.prop(i), pts),
                 io[f"query_prop_density_{i}"], 2e-4, 1e-5) for i in range(len(props))]
    report = []
    for name, got, want, rtol, atol in queries:
        got = got.cpu().numpy()
        err = np.abs(got - want)
        bad = int((~(err <= atol + rtol * np.abs(want))).sum())  # NaN counts as out
        report.append((f"golden {name}: {bad} values out of tolerance, max_abs_err="
                       f"{float(err.max()):.3e}, tol=atol {atol:g} + rtol {rtol:g}",
                       got.shape == want.shape and bad == 0))
    return report


def check_golden_forward(out, io, far=50.0):
    failed = [line for line, ok in golden_forward_report(out, io, far) if not ok]
    assert not failed, failed


def check_golden_queries(model, io):
    failed = [line for line, ok in golden_query_report(model, io) if not ok]
    assert not failed, failed

SMALL = dict(
    near_plane=0.005, far_plane=50.0, piecewise_sampler_threshold=5.0, num_levels=2,
    base_res=4, max_res=64, log2_hashmap_size=10, features_per_level=4, hidden_dim=32,
    hidden_dim_color=32, num_proposal_samples_per_ray=(16, 12), num_nerf_samples_per_ray=8,
    proposal_net_args_list=(dict(features_per_level=2, log2_hashmap_size=8, num_levels=2,
                                 base_res=4, max_res=32),) * 2,
    sky_mlp_dims=16, semantic_dim=64, pose_scale_factor=0.05, hash_storage="shared",
    prop_shared_mlp=True, prop_grid_res=8, remat=False, eval_num_rays_per_chunk=256,
)


@pytest.fixture
def cuda_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = NerfactoNuscMSConfig(**SMALL)
    cent = np.array([[0.0, 0.0, 0.0], [1.0, 0.5, 0.0]], np.float32)
    aabbs = np.stack([np.stack([c - 1.5, c + 1.5]) for c in cent]).astype(np.float32)
    model = init_model(torch.Generator().manual_seed(0), cfg, aabbs, cent, 4, 2, device="cpu")
    params = model.params()
    for table in params["field"]["hash_table"] + params["props"][0]["hash_table"]:
        table.data.mul_(3e3)  # well above the 1e-4 init, so densities vary
    return model


def test_kernels_match_plain_versions(cuda_model):
    model = cuda_model.cuda()
    p, cfg = model.params(), model.config
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels.reset_launches()
    routing = build_padded_routing(
        torch.randint(0, 2, (900,), generator=gen, device=dev, dtype=torch.int32), 2, 512)
    pos = torch.rand((routing.to_slot.shape[0], 3), generator=gen, device=dev)
    for storage_args in ((p["field"]["hash_table"], pos, cfg.field.hash, routing.expert_of_slot),
                         (p["field"]["hash_table"], pos, cfg.field.hash, None)):
        torch.testing.assert_close(HE.hash_encode(*storage_args),
                                   HE.hash_encode_plain(*storage_args), rtol=1e-5, atol=1e-7)
    for layers, sig in ((p["field"]["base_mlp"], False), (p["field"]["semantic_head"], False)):
        h = torch.randn((routing.to_slot.shape[0], layers[0][0].shape[1]), generator=gen,
                        device=dev)
        torch.testing.assert_close(M.apply_mlp_blocks(layers, h, routing.block_expert, sig),
                                   M.apply_mlp_blocks_plain(layers, h, routing.block_expert, sig),
                                   rtol=1e-4, atol=1e-5)
    prop_mlp = p["props"][0]["mlp"]
    x = torch.randn((1000, prop_mlp[0][0].shape[0]), generator=gen, device=dev)
    torch.testing.assert_close(M.apply_mlp(prop_mlp, x),
                               M.apply_mlp_blocks_plain(prop_mlp, x, None),
                               rtol=1e-4, atol=1e-5)
    deltas = torch.rand((70, 40), generator=gen, device=dev) * 0.1
    dens = torch.rand((70, 40), generator=gen, device=dev) * 5
    steps = torch.cumsum(deltas, -1)
    payload = torch.rand((70 * 40, 5), generator=gen, device=dev)
    got = VR.volume_render(deltas, dens, steps, payload)
    want = VR.volume_render_plain(deltas, dens, steps, payload)
    for key in ("weights", "accumulation", "expected_depth", "composite"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=1e-5)
    grid = model.make_prop_grid()
    gpos = torch.randn((1000, 3), generator=gen, device=dev) * 2
    kargs = (grid, p["props"][0]["centroids"], p["props"][0]["aabbs"], gpos, cfg.prop_grid_res)
    torch.testing.assert_close(PF.prop_grid_density(*kargs), PF.prop_grid_density_plain(*kargs),
                               rtol=1e-5, atol=1e-6)
    assert all(kernels.LAUNCHES[name] > 0 for name in ("hash_encode_fwd", "mlp_blocks_fwd",
                                                       "volume_render_fwd", "prop_grid_density_fwd"))


@pytest.mark.parametrize("levels", [1, 2, 4, 16])
@pytest.mark.parametrize("features", [1, 4, 10])
@pytest.mark.parametrize("with_experts", [False, True], ids=["single", "experts"])
@pytest.mark.parametrize("storage", ["corner", "cell", "shared"])
def test_hash_encode_kernel_matches_plain(storage, with_experts, features, levels):
    """K1 on every table layout, with and without expert ids, at random
    points and at grid nodes of every level (where ceil == floor); F = 1 and
    10 take 4-byte copies for 'corner' rows, F = 4 16-byte ones; a sample
    count that is not a multiple of a block's pairs, and none; two calls
    bitwise equal."""
    _need_cuda()
    cfg = HashEncodingConfig(num_levels=levels, min_res=4, max_res=64, log2_hashmap_size=8,
                             features_per_level=features, storage=storage)
    num_experts = 3 if with_experts else 1
    table = HE.init_hash_table(torch.Generator().manual_seed(0), cfg, num_experts)
    # Scale the tables up so the tolerance is not all atol.
    table = ([t.cuda() * 1e4 for t in table] if storage == "shared" else table.cuda() * 1e4)
    rng = np.random.RandomState(1)
    nodes = [rng.randint(0, int(s) + 1, (64, 3)).astype(np.float32) / s for s in cfg.scalings()]
    pos = torch.from_numpy(np.concatenate([rng.rand(2001, 3).astype(np.float32), *nodes])).cuda()
    eids = (torch.from_numpy(rng.randint(0, num_experts, len(pos)).astype(np.int32)).cuda()
            if with_experts else None)
    kernels.reset_launches()
    got = HE.hash_encode(table, pos, cfg, eids)
    assert kernels.LAUNCHES["hash_encode_fwd"] == 1
    torch.testing.assert_close(got, HE.hash_encode_plain(table, pos, cfg, eids),
                               rtol=1e-5, atol=1e-7)
    assert torch.equal(got, HE.hash_encode(table, pos, cfg, eids))
    none = HE.hash_encode(table, pos[:0], cfg, None if eids is None else eids[:0])
    assert none.shape == (0, cfg.out_dim)


@pytest.mark.parametrize("storage", ["cell", "shared"])
def test_hash_encode_kernel_reads_unaligned_tables(storage):
    """Tables that start 4 bytes past a 16-byte boundary: the kernel takes
    4-byte row copies and matches the plain version."""
    _need_cuda()
    cfg = HashEncodingConfig(num_levels=4, min_res=4, max_res=64, log2_hashmap_size=8,
                             features_per_level=4, storage=storage)
    table = HE.init_hash_table(torch.Generator().manual_seed(0), cfg, 2)

    def unaligned(t):
        flat = torch.empty(t.numel() + 1, device="cuda")[1:]
        return flat.copy_(t.reshape(-1).cuda() * 1e4).view(t.shape)

    table = [unaligned(t) for t in table] if storage == "shared" else unaligned(table)
    rng = np.random.RandomState(2)
    pos = torch.from_numpy(rng.rand(1001, 3).astype(np.float32)).cuda()
    eids = torch.from_numpy(rng.randint(0, 2, len(pos)).astype(np.int32)).cuda()
    torch.testing.assert_close(HE.hash_encode(table, pos, cfg, eids),
                               HE.hash_encode_plain(table, pos, cfg, eids), rtol=1e-5, atol=1e-7)


def test_expert_routing_near_bisectors_matches_cpu():
    """Samples within rounding of the bisector of two centroids go to the
    same expert on the card as on the CPU, in the plain router and in K4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from presight_tpu_torch.fields.router import assign_experts

    g = torch.Generator().manual_seed(0)
    xs, ys = torch.meshgrid(torch.arange(4.0), torch.arange(4.0), indexing="ij")
    cent = torch.stack([xs.ravel(), ys.ravel(), torch.zeros(16)], -1) * 10.0 - 15.0
    cent[:, 2] = 0.0
    aabbs = torch.stack([cent - torch.tensor([10.0, 10.0, 2.5]),
                         cent + torch.tensor([10.0, 10.0, 2.5])], 1).contiguous()
    pos = (torch.rand((200000, 3), generator=g) - 0.5) * torch.tensor([60.0, 60.0, 8.0])
    planes = torch.tensor([-10.0, 0.0, 10.0])[torch.randint(0, 3, (200000,), generator=g)]
    pos[:, 0] = planes + (torch.rand(200000, generator=g) - 0.5) * 1e-5
    torch.testing.assert_close(assign_experts(pos.cuda(), cent.cuda()).cpu(),
                               assign_experts(pos, cent), rtol=0, atol=0)
    G = 8
    grid = torch.rand((16 * G ** 3, 8), generator=g)
    kargs = [t.cuda() for t in (grid, cent, aabbs, pos)] + [G]
    torch.testing.assert_close(PF.prop_grid_density(*kargs), PF.prop_grid_density_plain(*kargs),
                               rtol=1e-5, atol=1e-6)


def _k4_scene(E):
    """E experts with integer centroids 8 apart on a square grid and AABBs
    c +- 4 (extent 8): a world offset q from a centroid maps to x = q / 4
    exactly, and with G cells to the face of a cell where q is a multiple
    of 16 / G."""
    side = int(np.ceil(np.sqrt(E)))
    xs, ys = torch.meshgrid(torch.arange(float(side)), torch.arange(float(side)), indexing="ij")
    cent = torch.stack([xs.ravel() * 8.0 - 8.0, ys.ravel() * 8.0 - 8.0, torch.zeros(side * side)],
                       -1)[:E].contiguous()
    aabbs = torch.stack([cent - 4.0, cent + 4.0], 1).contiguous()
    return cent, aabbs


def _k4_positions(cent, G, gen, n_random=1037):
    """Positions on cell faces (inside an AABB, where the contraction is
    the identity), at and within 1e-6 of centroid bisectors (a tie of the
    squared distances goes to the first expert), on AABB faces, outside
    every AABB (and so far out that the selector is 0), and random over and
    around the tile."""
    E = cent.shape[0]
    k = torch.randint(0, E, (4 * n_random,), generator=gen)
    q = torch.randint(-(G // 4), G // 4 + 1, (4 * n_random, 3), generator=gen) * (16.0 / G)
    faces = cent[k] + q
    half = cent[k] + torch.tensor([4.0, 0.0, 0.0])  # the bisector with the next expert in x
    half[:, 1:] += torch.randint(-8, 9, (4 * n_random, 2), generator=gen) * 0.5
    near = half.clone()
    near[:, 0] += (torch.rand(4 * n_random, generator=gen) - 0.5) * 2e-6
    aabb_face = cent[k] + torch.tensor([0.0, 0.0, 4.0]) * torch.where(
        torch.rand(4 * n_random, 1, generator=gen) < 0.5, -1.0, 1.0)
    lo, hi = cent.min(0).values - 4.0, cent.max(0).values + 4.0
    far = lo - 30.0 + torch.rand((n_random, 3), generator=gen) * (hi - lo + 60.0)
    far[:, 2] = torch.where(far[:, 2] < 0, far[:, 2] - 5.0, far[:, 2] + 5.0)  # outside every AABB
    spread = lo - 8.0 + torch.rand((n_random, 3), generator=gen) * (hi - lo + 16.0)
    huge = far[:64] * 1e8  # contracted onto the domain's edge: selector 0
    return torch.cat([faces, half, near, aabb_face, far, spread, huge]).contiguous()


@pytest.mark.parametrize("G", [8, 64])
@pytest.mark.parametrize("E", [1, 16, 64])
def test_prop_grid_kernel_matches_plain(E, G):
    """K4 against its plain version (atol 1e-6 + rtol 1e-5) on a random
    grid, where a sample in another cell or routed to another expert reads
    another row: positions on cell faces, at and near centroid bisectors,
    on AABB faces, outside every AABB and at random; a count that is not a
    multiple of a block's samples; 2^18 + 5 samples (each block loops over
    several tiles), with positions 16-byte aligned and not; two calls
    bitwise equal."""
    _need_cuda()
    gen = torch.Generator().manual_seed(E * 100 + G)
    cent, aabbs = _k4_scene(E)
    pos = _k4_positions(cent, G, gen)
    grid = torch.rand((E * G ** 3, 8), generator=gen)
    args = [t.cuda() for t in (grid, cent, aabbs)]
    wide = pos.repeat((1 << 18) // pos.shape[0] + 1, 1)[:(1 << 18) + 5].cuda()
    shifted = torch.empty(wide.numel() + 1, device="cuda")[1:].view(wide.shape).copy_(wide)
    for x in (pos.cuda(), wide, shifted):
        kernels.reset_launches()
        got = PF.prop_grid_density(*args, x, G)
        assert kernels.LAUNCHES["prop_grid_density_fwd"] == 1
        torch.testing.assert_close(got, PF.prop_grid_density_plain(*args, x, G), rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(got, PF.prop_grid_density(*args, x, G))


def test_render_kernel_path_matches_plain_path(cuda_model):
    """The same small model rendered through the kernels (CUDA tensors) and
    through the plain versions (CPU tensors)."""
    cams = CameraParams(
        c2w=torch.tensor([[[1.0, 0, 0, 0.2], [0, 1.0, 0, 0.1], [0, 0, 1.0, 0.0]]]),
        fx=torch.tensor([8.0]), fy=torch.tensor([8.0]), cx=torch.tensor([10.0]),
        cy=torch.tensor([6.0]), video_ids=torch.zeros(1, dtype=torch.int32))
    renderer = ImageRenderer(cuda_model.config)
    grid = cuda_model.make_prop_grid()
    cpu = renderer.render(cuda_model, cams, 0, 12, 20, prop_grid=grid)
    gpu_model = cuda_model.cuda()
    gpu = renderer.render(gpu_model, cams.to("cuda"), 0, 12, 20, prop_grid=grid.cuda())
    for key in ("rgb", "accumulation", "expected_depth", "semantics"):
        np.testing.assert_allclose(gpu[key], cpu[key], rtol=1e-5, atol=1e-5, err_msg=key)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _close_scaled(got, want, rtol=1e-4, atol_frac=1e-5):
    atol = atol_frac * float(want.abs().max().clamp_min(1e-30))
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("C", [80, 32, 10, 2])
def test_sorted_accum_kernel_matches_plain(C):
    """K5 with the sort's permutation into a non-zero output of two parts:
    one run of 25,000 rows crossing many 64-row tiles, short runs around
    it, a ragged last tile; 16-byte copies for C = 80, 32 and 4-byte ones
    for C = 10, 2; two calls bitwise equal. The rows are drawn in [0, 1):
    a 25,000-row sum of signed rows cancels, and then the rounding of the
    two summation orders, not the kernel, would set the tolerance."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, T = 60000, 700
    keys = torch.randint(0, 2 * T, (n,), generator=gen, device="cuda", dtype=torch.int32)
    keys[1000:26000] = 333  # a run of > 20,000 rows
    keys, order = torch.sort(keys, stable=True)
    rows = torch.rand((n, C), generator=gen, device="cuda")
    base = torch.randn((2 * T, C), generator=gen, device="cuda")
    got, want, again = base.clone(), base.clone(), base.clone()
    kernels.reset_launches()
    HE.sorted_accum(keys, rows, list(got.split(T)), order)
    assert kernels.LAUNCHES["sorted_accum"] == 1
    HE.sorted_accum_plain(keys, rows, list(want.split(T)), order)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    HE.sorted_accum(keys, rows, list(again.split(T)), order)
    assert torch.equal(got, again)
    # rows already in sorted order (the identity permutation), one output part
    flat, flat_want = base.clone(), base.clone()
    srows, ident = rows[order], torch.arange(n, device="cuda")
    HE.sorted_accum(keys, srows, flat, ident)
    HE.sorted_accum_plain(keys, srows, flat_want, ident)
    torch.testing.assert_close(flat, flat_want, rtol=1e-5, atol=1e-5)


def test_sorted_accum_kernel_takes_no_rows():
    _need_cuda()
    out = torch.ones((10, 8), device="cuda")
    HE.sorted_accum(torch.empty((0,), dtype=torch.int32, device="cuda"),
                    torch.empty((0, 8), device="cuda"), out,
                    torch.empty((0,), dtype=torch.int64, device="cuda"))
    torch.cuda.synchronize()
    assert bool((out == 1.0).all())


@pytest.mark.parametrize("with_experts", [False, True], ids=["single", "experts"])
@pytest.mark.parametrize("storage", ["corner", "cell", "shared"])
def test_hash_encode_bwd_kernel_matches_plain(storage, with_experts):
    """K1b's keys and rows, and the table gradient through sort + K5."""
    _need_cuda()
    cfg = HashEncodingConfig(num_levels=3, min_res=4, max_res=64, log2_hashmap_size=8,
                             features_per_level=2, storage=storage)
    num_experts = 3 if with_experts else 1
    rng = np.random.RandomState(2)
    nodes = [rng.randint(0, int(s) + 1, (64, 3)).astype(np.float32) / s for s in cfg.scalings()]
    pos = torch.from_numpy(np.concatenate([rng.rand(3000, 3).astype(np.float32), *nodes])).cuda()
    eids = (torch.from_numpy(rng.randint(0, num_experts, len(pos)).astype(np.int32)).cuda()
            if with_experts else None)
    grad = torch.from_numpy(rng.randn(len(pos), cfg.out_dim).astype(np.float32)).cuda()
    kernels.reset_launches()
    keys, rows = HE.hash_encode_bwd(pos, cfg, eids, grad)
    assert kernels.LAUNCHES["hash_encode_bwd"] == 1
    pkeys, prows = HE.hash_encode_bwd_plain(pos, cfg, eids, grad)
    torch.testing.assert_close(keys, pkeys, rtol=0, atol=0)
    torch.testing.assert_close(rows, prows, rtol=1e-6, atol=1e-7)
    # table_grad adds into the gradient it is given (the level tables' for
    # 'shared' storage), here on top of a non-zero prior gradient.
    num_rows = (1 if storage == "shared" else num_experts) * cfg.num_levels * cfg.table_size
    prior = torch.from_numpy(rng.randn(num_rows, rows.shape[1]).astype(np.float32))

    def parts(flat):
        return list(flat.split(cfg.table_size)) if storage == "shared" else flat

    got = prior.cuda()
    HE.table_grad(pos, cfg, eids, grad, parts(got))
    assert kernels.LAUNCHES["sorted_accum"] == 1
    want = prior.clone()
    HE.table_grad(pos.cpu(), cfg, None if eids is None else eids.cpu(), grad.cpu(), parts(want))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# The MLP stacks of the -tpu profile: widths 47 (the rgb head's input) and
# 1 (the proposal MLP's output) included.
MLP_STACKS = ([40, 64, 80], [47, 64, 64, 3], [64, 64, 64, 64], [16, 32, 32, 64], [8, 64, 1])


def _mlp_layers(gen, dims, num_experts):
    return [(torch.randn((num_experts, a, b), generator=gen, device="cuda") / a ** 0.5,
             torch.randn((num_experts, b), generator=gen, device="cuda") * 0.1)
            for a, b in zip(dims[:-1], dims[1:])]


def _k2_masks(layers, h, be, sigmoid):
    """K2's ReLU masks from a chain of one-layer launches, which must equal
    the fused launch bitwise; the masks may differ from the plain
    forward's only where the plain pre-activation is within 1e-5 of 0, on
    at most 0.01% of the hidden pre-activations (chip_smoke.py's tie rule)."""
    fused = M.mlp_blocks_fwd(layers, h, be, sigmoid)
    x, masks, flips, total = h, [], 0, 0
    plain_x = h
    for i, (w, b) in enumerate(layers):
        last = i == len(layers) - 1
        y = M.mlp_blocks_fwd([(w, b)], x, be, sigmoid and last)
        if last:
            assert torch.equal(y, fused)
            break
        plain = M.apply_mlp_blocks_plain([(w, b)], plain_x, be)
        flip = (y > 0) != (plain > 0)
        assert not bool((flip & (plain.abs() > 1e-5)).any())
        flips, total = flips + int(flip.sum()), total + plain.numel()
        masks.append(y > 0)
        x, plain_x = torch.relu(y), torch.relu(plain)
    assert flips <= 1e-4 * max(total, 1)
    return masks


def _layout_without_expert_1(gen, rows):
    """Three experts, expert 1 owning no block."""
    eids = torch.randint(0, 2, (rows,), generator=gen, device="cuda", dtype=torch.int32) * 2
    return build_padded_routing(eids, 3, 512).block_expert


@pytest.mark.parametrize("C", [4, 1])
def test_sorted_accum_kernel_on_corner_keys_near_2_27(C):
    """K5 on keys of the reference's 'corner' tables: one (E * L * T, C)
    table whose keys reach E * L * T = 1.68e8 on the main field, here keys
    around 2^27 into a 2^27 + 2^16-row output; C = 4 (the main field,
    16-byte copies) and C = 1 (a proposal field, 4-byte copies); a
    10,000-row run and the output's last row; two calls bitwise equal."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    n, num_rows = 300_000, 2 ** 27 + 2 ** 16
    keys = torch.randint(2 ** 27 - 2 ** 16, num_rows, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    keys[:10_000] = 2 ** 27 - 1
    keys[-5:] = num_rows - 1
    keys, order = torch.sort(keys, stable=True)
    rows = torch.rand((n, C), generator=gen, device="cuda")
    got = torch.zeros((num_rows, C), device="cuda")
    want, again = got.clone(), got.clone()
    HE.sorted_accum(keys, rows, got, order)
    HE.sorted_accum_plain(keys, rows, want, order)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert float(got[2 ** 27 - 1].sum()) > 1000.0
    HE.sorted_accum(keys, rows, again, order)
    assert torch.equal(got, again)


@pytest.mark.parametrize("in_dim", [3, 8])
def test_grouped_proposal_mlp_kernels_match_plain(in_dim):
    """K2 and K2b on per-expert proposal MLPs in-64-1 over 16 experts (in =
    3: the golden's, in = 8: the reference tile's) in apply_mlp_grouped's
    block layout, n_pad = (ceil(n / 512) + E) * 512; and apply_mlp_grouped
    on the card against the same call on the CPU."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    E, n = 16, 30_000
    eids = torch.randint(0, E, (n,), generator=gen, device="cuda", dtype=torch.int32)
    eids[eids == 5] = 6  # an expert with no rows
    group_sizes = build_routing(eids, E).group_sizes
    layers = _mlp_layers(gen, [in_dim, 64, 1], E)
    x = torch.randn((n, in_dim), generator=gen, device="cuda")
    _, src, valid, be, n_pad = M._blocked_layout(group_sizes, n, 512)
    assert n_pad == (-(-n // 512) + E) * 512
    h = x[src.long()] * valid[:, None]
    torch.testing.assert_close(M.mlp_blocks_fwd(layers, h, be),
                               M.apply_mlp_blocks_plain(layers, h, be), rtol=1e-4, atol=1e-5)
    grads = _check_bwd(layers, h, be, False,
                       torch.randn((n_pad, 1), generator=gen, device="cuda"))
    assert not bool(grads[0][0][5].any())
    kernels.reset_launches()
    got = M.apply_mlp_grouped(layers, x, group_sizes)
    assert kernels.LAUNCHES["mlp_blocks_fwd"] == 1
    want = M.apply_mlp_grouped([(w.cpu(), b.cpu()) for w, b in layers], x.cpu(),
                               group_sizes.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


def test_golden_on_the_card():
    """The executed reference golden imported onto the card: the eval
    forward through K1, K2 and K3 under the golden test's quantile checks,
    and the field queries at its rtol and atol."""
    _need_cuda()
    state, io, cfg = load_golden()
    model = NerfactoNuscMS(cfg, import_reference_state_dict(state, cfg, device="cuda"))
    kernels.reset_launches()
    out = model(golden_bundle(io, "cuda"), train=False, stop_prop_grad=True)
    for name in ("hash_encode_fwd", "mlp_blocks_fwd", "volume_render_fwd"):
        assert kernels.LAUNCHES[name] > 0, name
    check_golden_forward({k: v.cpu().numpy() for k, v in out.items()
                          if isinstance(v, torch.Tensor)}, io)
    check_golden_queries(model, io)


def test_mlp_blocks_fwd_kernel_matches_plain():
    """K2 on every stack, with an expert that owns no block and on the
    single-expert path (1000 rows: a ragged last block); K2's chained
    layers equal the fused launch bitwise."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(6)
    be = _layout_without_expert_1(gen, 2000)
    for sigmoid in (False, True):
        for dims in MLP_STACKS:
            layers = _mlp_layers(gen, dims, 3)
            h = torch.randn((be.shape[0] * 512, dims[0]), generator=gen, device="cuda")
            kernels.reset_launches()
            got = M.mlp_blocks_fwd(layers, h, be, sigmoid)
            assert kernels.LAUNCHES["mlp_blocks_fwd"] == 1
            torch.testing.assert_close(got, M.apply_mlp_blocks_plain(layers, h, be, sigmoid),
                                       rtol=1e-4, atol=1e-5)
            _k2_masks(layers, h, be, sigmoid)
            one = [(w[:1], b[:1]) for w, b in layers]
            x = torch.randn((1000, dims[0]), generator=gen, device="cuda")
            torch.testing.assert_close(M.mlp_blocks_fwd(one, x, None, sigmoid),
                                       M.apply_mlp_blocks_plain(one, x, None, sigmoid),
                                       rtol=1e-4, atol=1e-5)
            _k2_masks(one, x, None, sigmoid)


def _check_bwd(layers, h, be, sigmoid, g):
    """K2b against the plain backward on K2's own masks, and two K2b calls
    bitwise equal."""
    masks = _k2_masks(layers, h, be, sigmoid)
    kernels.reset_launches()
    dx, grads = M.mlp_blocks_bwd(layers, h, be, sigmoid, g)
    assert kernels.LAUNCHES["mlp_blocks_bwd"] == 1
    pdx, pgrads = M.mlp_blocks_bwd_plain(layers, h, be, sigmoid, g, relu_masks=masks)
    _close_scaled(dx, pdx)
    for (dw, db), (pw, pb) in zip(grads, pgrads):
        _close_scaled(dw, pw)
        _close_scaled(db, pb)
    dx2, grads2 = M.mlp_blocks_bwd(layers, h, be, sigmoid, g)
    assert torch.equal(dx, dx2)
    for (dw, db), (dw2, db2) in zip(grads, grads2):
        assert torch.equal(dw, dw2) and torch.equal(db, db2)
    return grads


@pytest.mark.parametrize("sigmoid", [False, True], ids=["linear", "sigmoid"])
def test_mlp_blocks_bwd_kernel_matches_plain(sigmoid):
    """K2b on every stack, with an expert that owns no block (its dW and db
    are zero) and on the single-expert path; deterministic; held against
    the plain backward on K2's masks."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    be = _layout_without_expert_1(gen, 1500)
    n = be.shape[0] * 512
    for dims in MLP_STACKS:
        layers = _mlp_layers(gen, dims, 3)
        h = torch.randn((n, dims[0]), generator=gen, device="cuda")
        g = torch.randn((n, dims[-1]), generator=gen, device="cuda")
        grads = _check_bwd(layers, h, be, sigmoid, g)
        for dw, db in grads:
            assert not bool(dw[1].any()) and not bool(db[1].any())
    one = _mlp_layers(gen, [8, 64, 1], 1)
    x = torch.randn((1000, 8), generator=gen, device="cuda")
    _check_bwd(one, x, None, sigmoid, torch.randn((1000, 1), generator=gen, device="cuda"))


@pytest.mark.parametrize("rows", [512, 256, 128, 64])
def test_mlp_kernels_at_each_automatic_rows_per_cta(rows):
    """The row counts at which the wrapper picks each rows per CUDA block
    on this card (two blocks per SM), K2 and K2b on the base MLP there."""
    _need_cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = max(2 * sms * rows // 512, 3)
    assert M.choose_rows_per_cta(blocks * 512, 512, sms) == rows
    gen = torch.Generator(device="cuda").manual_seed(7)
    be = torch.sort(torch.randint(0, 16, (blocks,), generator=gen, device="cuda",
                                  dtype=torch.int32))[0]
    layers = _mlp_layers(gen, [40, 64, 80], 16)
    h = torch.randn((blocks * 512, 40), generator=gen, device="cuda")
    g = torch.randn((blocks * 512, 80), generator=gen, device="cuda")
    torch.testing.assert_close(M.mlp_blocks_fwd(layers, h, be), M.apply_mlp_blocks_plain(
        layers, h, be), rtol=1e-4, atol=1e-5)
    _check_bwd(layers, h, be, False, g)


K3B_CASES = ([(S, C, layout) for S in (32, 40, 48, 72) for C in (3, 67)
              for layout in ("padded", "in order")] + [(S, 0, "none") for S in (32, 40, 48, 72)]
             + [(1024, 67, layout) for layout in ("padded", "in order")])


K3_CASES = ([(S, C, layout) for S in (1, 31, 32, 33, 48, 64) for C in (3, 64, 67)
             for layout in ("padded", "in order")] + [(S, 0, "none") for S in (1, 31, 33, 48)]
            + [(1024, 67, layout) for layout in ("padded", "in order")])


@pytest.mark.parametrize("S,C,payload_layout", K3_CASES)
def test_volume_render_kernel_matches_plain(S, C, payload_layout):
    """K3 against its plain version: sample counts below, at and above one
    warp chunk and two; payload rows through a padded index, in sample
    order, or no payload (the weights-only launch of the proposal rounds);
    a ray whose S x C payload does not fit in shared memory (S = 1024, C =
    67: the composite reads the rows from device memory); a ray count that
    is not a multiple of a block's rays; saturated and
    empty rays; two calls bitwise equal. The median depth may differ only
    where the plain cumulative weight lies within 1e-5 of 0.5."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(8)
    R = 301
    deltas = torch.rand((R, S), generator=gen, device="cuda") * 0.05
    dens = torch.exp(torch.randn((R, S), generator=gen, device="cuda") * 2.0) * 4.0
    dens[0, S // 2] = 1e30
    dens[1] = 0.0
    steps = torch.cumsum(deltas, -1) + 0.005
    payload = index = None
    if payload_layout != "none":
        rows = R * S + (512 if payload_layout == "padded" else 0)
        payload = torch.rand((rows, C), generator=gen, device="cuda")
        if payload_layout == "padded":
            index = torch.randperm(rows, generator=gen, device="cuda")[:R * S].to(torch.int32)
    kernels.reset_launches()
    got = VR.volume_render(deltas, dens, steps, payload, index)
    assert kernels.LAUNCHES["volume_render_fwd"] == 1
    want = VR.volume_render_plain(deltas, dens, steps, payload, index)
    keys = ["weights", "accumulation", "expected_depth"] + (["composite"] if C else [])
    for key in keys:
        torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=1e-5)
    tie = ((torch.cumsum(want["weights"], -1) - 0.5).abs() < 1e-5).any(-1)
    assert not bool(((got["depth"] - want["depth"]).abs() > 1e-6)[~tie].any())
    again = VR.volume_render(deltas, dens, steps, payload, index)
    assert all(torch.equal(got[key], again[key]) for key in got)
    only = VR.volume_render(deltas, dens)
    assert set(only) == {"weights"} and torch.equal(only["weights"], got["weights"])


@pytest.mark.parametrize("C", [0, 3])
def test_volume_render_kernels_take_rays_past_shared_memory(C):
    """The lengths K3 refused before its per-sample arrays could live in
    device memory (S = 29,057 with a payload, 58,113 without; one ray a
    block can hold neither's weights and row indices, nor K3b's per-sample
    arrays): K3 and K3b against their plain versions, K3b through its
    scratch buffer, and two calls of each bitwise equal."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(9)
    R, S = 2, (29_057 if C else 58_113)
    deltas = torch.rand((R, S), generator=gen, device="cuda") * 2e-5  # optical depth ~10
    dens = torch.exp(torch.randn((R, S), generator=gen, device="cuda") * 2.0) * 4.0
    steps = torch.cumsum(deltas, -1) + 0.005
    payload = torch.rand((R * S, C), generator=gen, device="cuda") if C else None
    assert kernels.lib().volume_render_bwd_scratch_floats(R, S, C, C > 0) == R * S
    kernels.reset_launches()
    got = VR.volume_render(deltas, dens, steps, payload)
    want = VR.volume_render_plain(deltas, dens, steps, payload)
    for key in ["weights", "accumulation", "expected_depth"] + (["composite"] if C else []):
        torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=1e-5)
    assert all(torch.equal(got[key], again)
               for key, again in VR.volume_render(deltas, dens, steps, payload).items())
    ups = [torch.randn(shape, generator=gen, device="cuda") for shape in ((R, S), (R,), (R,))]
    gcomp = torch.randn((R, C), generator=gen, device="cuda") if C else None
    args = (deltas, dens, steps, payload, None, got["weights"], *ups, gcomp)
    grads = VR.volume_render_bwd(*args, VR.step_bounds(steps))
    want = VR.volume_render_bwd_plain(*args)
    _close_scaled(grads[0], want[0])
    if C:
        _close_scaled(grads[1], want[1])
    again = VR.volume_render_bwd(*args, VR.step_bounds(steps))
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(grads, again))
    assert kernels.LAUNCHES["volume_render_fwd"] == 2
    assert kernels.LAUNCHES["volume_render_bwd"] == 2


@pytest.mark.parametrize("S,C,payload_layout", K3B_CASES)
def test_volume_render_bwd_kernel_matches_plain(S, C, payload_layout):
    """Every upstream gradient non-zero; saturated and empty rays present;
    sample counts that fill one, one and a part, and more than two warp
    chunks; payload rows through a padded index (rows no sample reads get
    zeros), in sample order, or no payload; a ray whose S x C payload does
    not fit in shared memory (S = 1024, C = 67: the rows are read from
    device memory); and the weights-only launch."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    R = 300
    deltas = torch.rand((R, S), generator=gen, device="cuda") * 0.05
    dens = torch.exp(torch.randn((R, S), generator=gen, device="cuda") * 2.0) * 4.0
    dens[0, 3] = 1e30
    dens[1] = 0.0
    steps = torch.cumsum(deltas, -1) + 0.005
    args = [torch.randn(shape, generator=gen, device="cuda") for shape in ((R, S), (R,), (R,))]
    payload = index = gcomp = None
    if payload_layout != "none":
        rows = R * S + (512 if payload_layout == "padded" else 0)
        payload = torch.rand((rows, C), generator=gen, device="cuda")
        gcomp = torch.randn((R, C), generator=gen, device="cuda")
        if payload_layout == "padded":
            index = torch.randperm(rows, generator=gen, device="cuda")[:R * S].to(torch.int32)
    w = VR.volume_render(deltas, dens, steps)["weights"]
    assert float(VR.volume_render(deltas, dens, steps)["accumulation"][1]) == 0.0
    kernels.reset_launches()
    clip = VR.step_bounds(steps)
    got = VR.volume_render_bwd(deltas, dens, steps, payload, index, w, *args, gcomp, clip)
    assert kernels.LAUNCHES["volume_render_bwd"] == 1
    want = VR.volume_render_bwd_plain(deltas, dens, steps, payload, index, w, *args, gcomp)
    _close_scaled(got[0], want[0])
    if payload is not None:
        _close_scaled(got[1], want[1])
    again = VR.volume_render_bwd(deltas, dens, steps, payload, index, w, *args, gcomp, clip)
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(got, again))
    # weights only (the proposal rounds)
    d_only = VR.volume_render_bwd(deltas, dens, None, None, None, w, args[0], None, None, None,
                                  None)
    d_plain = VR.volume_render_bwd_plain(deltas, dens, None, None, None, w, args[0], None, None,
                                         None)
    _close_scaled(d_only[0], d_plain[0])


def test_train_step_kernel_path_matches_plain_path(cuda_model):
    """One training step of the small model through the kernels (CUDA) and
    through the plain versions (CPU): the same weights, batch and draws.
    Losses rtol 1e-4; each gradient leaf within 1e-3 of its norm (relative
    L2), as chip_smoke.py phase 8: the kernel path resamples the PDF from
    K3's weights, summed in another order, so a sample within rounding of a
    cell face can read the neighbouring cell and move its gradient to
    another row."""
    from presight_tpu_torch import bridge
    from presight_tpu_torch.engine.optimizers import make_optimizers
    from presight_tpu_torch.engine.train_step import StepScalars, train_step
    from presight_tpu_torch.models.nerfacto_ms import NerfactoNuscMS

    cams = CameraParams(
        c2w=torch.tensor([[[1.0, 0, 0, 0.2], [0, 1.0, 0, 0.1], [0, 0, 1.0, 0.0]]]),
        fx=torch.tensor([8.0]), fy=torch.tensor([8.0]), cx=torch.tensor([10.0]),
        cy=torch.tensor([6.0]), video_ids=torch.zeros(1, dtype=torch.int32))
    rng = np.random.RandomState(5)
    R = 256
    batch = {"ray_index": torch.from_numpy(np.stack([np.zeros(R), rng.randint(0, 12, R),
                                                     rng.randint(0, 20, R)], -1).astype(np.int32)),
             "rgb": torch.from_numpy(rng.rand(R, 3).astype(np.float32)),
             "sky": torch.from_numpy((rng.rand(R) < 0.3).astype(np.float32)),
             "depth": torch.from_numpy((rng.rand(R) * 40).astype(np.float32)),
             "features": torch.from_numpy(rng.rand(R, 64).astype(np.float32))}
    draws = [[torch.from_numpy(rng.rand(128, 1).astype(np.float32)) for _ in range(3)]
             for _ in range(2)]
    grid = cuda_model.make_prop_grid()
    results = []
    for device in ("cpu", "cuda"):
        tree = bridge.from_jax_params(bridge.to_numpy(cuda_model.params()))
        model = NerfactoNuscMS(cuda_model.config, tree).to(device)
        opts = make_optimizers(model.groups(), {k: OptimizerGroupConfig()
                                                for k in ("fields", "proposal_networks")})
        kernels.reset_launches()
        metrics = train_step(model, opts, cams.to(device), {k: v.to(device) for k, v in batch.items()},
                             StepScalars(0.5, 3.0, 0.05), stop_prop_grad=False, microbatch_rays=128,
                             prop_grid=grid.to(device),
                             draws=[[u.to(device) for u in d] for d in draws])
        if device == "cuda":
            for name in ("hash_encode_bwd", "mlp_blocks_bwd", "volume_render_bwd", "sorted_accum"):
                assert kernels.LAUNCHES[name] > 0, name
        results.append((metrics, [p.grad.cpu() for p in model.leaves if p.grad is not None]))
    (m_cpu, g_cpu), (m_gpu, g_gpu) = results
    for key in m_cpu:
        np.testing.assert_allclose(m_gpu[key], m_cpu[key], rtol=1e-4, err_msg=key)
    assert len(g_gpu) == len(g_cpu)
    for a, b in zip(g_gpu, g_cpu):
        assert float((a - b).norm() / b.norm().clamp_min(1e-30)) <= 1e-3


def lpips_state_dict(seed: int, prefix: str = "") -> dict:
    """Random LPIPS-VGG weights from a numpy seed in the official ``lpips``
    package's state_dict layout (torchvision's vgg16.features numbering in
    ``net.sliceK.<i>``, the heads as ``linK.model.1.weight`` (1, C, 1, 1),
    the scaling layer's buffers); ``prefix="net."`` gives torchmetrics'."""
    rng = np.random.RandomState(seed)
    state = {f"{prefix}scaling_layer.shift": np.array([-0.030, -0.088, -0.188], np.float32
                                                      ).reshape(1, 3, 1, 1),
             f"{prefix}scaling_layer.scale": np.array([0.458, 0.448, 0.450], np.float32
                                                      ).reshape(1, 3, 1, 1)}
    seq, c_in = 0, 3
    for s, (c_out, n) in enumerate(((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)), 1):
        if s > 1:
            seq += 1  # the max pool's slot
        for _ in range(n):
            state[f"{prefix}net.slice{s}.{seq}.weight"] = (
                rng.randn(c_out, c_in, 3, 3) / np.sqrt(9 * c_in)).astype(np.float32)
            state[f"{prefix}net.slice{s}.{seq}.bias"] = (rng.randn(c_out) * 0.01).astype(
                np.float32)
            seq += 2  # the conv and its ReLU
            c_in = c_out
        state[f"{prefix}lin{s - 1}.model.1.weight"] = (
            np.abs(rng.randn(1, c_out, 1, 1)) * 0.1).astype(np.float32)
    return state


def test_lpips_on_the_card_matches_the_cpu_under_default_tf32_flags():
    """LPIPS convolves in IEEE f32 on the card whatever the process's TF32
    flags: under torch's defaults (cuDNN allowed TF32) it is within rtol
    1e-5 of the CPU on a 180x320 pair (IEEE on the card: ~1e-7), while the
    same trunk left to the default flags is not (TF32: ~1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from presight_tpu_torch.utils import lpips as L

    before = torch.backends.cudnn.conv.fp32_precision
    torch.backends.cudnn.conv.fp32_precision = "tf32"  # torch's default for cuDNN convolutions
    try:
        params = L.load_torch_state_dict(lpips_state_dict(0))
        on_card = L.to_device(params, "cuda")
        rng = np.random.RandomState(1)
        a = rng.rand(180, 320, 3).astype(np.float32)
        b = np.clip(a + 0.1 * rng.randn(180, 320, 3), 0, 1).astype(np.float32)
        cpu = float(L.lpips(params, torch.from_numpy(a), torch.from_numpy(b)))
        ga, gb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        card = float(L.lpips(on_card, ga, gb))
        with torch.no_grad():
            tf32 = float(L.distance(on_card, ga, gb))
        assert torch.backends.cudnn.conv.fp32_precision == "tf32"  # restored
    finally:
        torch.backends.cudnn.conv.fp32_precision = before
    np.testing.assert_allclose(card, cpu, rtol=1e-5)
    assert abs(tf32 - cpu) > 1e-5 * cpu, "the TF32 hazard did not show: the test has no teeth"


# Occupancy kernels S1 and S2: inputs that reach every path of their designs.
S1_LB, S1_IV, S1_GRID = [-8.0, -8.0, -1.0], [0.8, 0.8, 0.5], (20, 20, 8)
# 3,087 voxels a batch: runs that straddle the batches, planes not 16-byte
# aligned (S1's store path for any grid).
S1_ODD_GRID = (21, 21, 7)


def s1_points(rng, kind, B, N, D, H, W, C):
    """S1 inputs (depth, feat, coor) as numpy: positive depth and features
    (a voxel is nonzero exactly where a point landed) and a quarter of the
    coordinates on voxel faces. ``random`` (and ``odd_grid``): points over
    the grid and past it. ``heavy``: as random, plus three voxels of each batch given about
    200, 300 and 800 points (past the 256 sorted in shared memory), a tenth
    of their coordinates on the voxels' lower faces. ``one_voxel``: every point of a batch in one voxel
    (inside it, off its faces)."""
    lb, iv = np.float32(S1_LB), np.float32(S1_IV)
    depth = rng.rand(B, N, D, H, W).astype(np.float32)
    feat = (rng.rand(B, N, H, W, C) + 0.1).astype(np.float32)
    if kind == "one_voxel":
        cell = np.array([5, 7, 3])
        frac = rng.uniform(0.05, 0.95, (B, N, D, H, W, 3))
        return depth, feat, (lb + (cell + frac) * iv).astype(np.float32)
    coor = (rng.rand(B, N, D, H, W, 3) * 20 - 10).astype(np.float32)
    faces = rng.rand(B, N, D, H, W, 3) < 0.25
    coor = np.where(faces, lb + rng.randint(-1, 22, coor.shape) * iv, coor).astype(np.float32)
    if kind == "heavy":
        flat = coor.reshape(B, -1, 3)
        for b in range(B):
            picks, start = rng.permutation(flat.shape[1]), 0
            for size, cell in ((200, (3, 4, 2)), (300, (10, 10, 5)), (800, (17, 2, 6))):
                idx, start = picks[start:start + size], start + size
                pts = lb + (np.asarray(cell) + rng.uniform(0.05, 0.95, (size, 3))) * iv
                on_face = rng.rand(size, 3) < 0.1
                flat[b, idx] = np.where(on_face, lb + np.asarray(cell) * iv, pts)
        coor = flat.reshape(coor.shape)
    return depth, feat, coor


S1_CASES = [("random", 2, 3, 7, 5, 6, 32), ("random", 1, 2, 9, 4, 5, 40),
            ("odd_grid", 2, 3, 7, 5, 6, 32),
            ("heavy", 2, 3, 10, 8, 10, 32), ("heavy", 2, 3, 10, 8, 10, 40),
            ("heavy", 2, 3, 10, 8, 10, 64), ("heavy", 2, 3, 10, 8, 10, 96),
            ("one_voxel", 2, 2, 6, 8, 12, 40)]


@pytest.mark.parametrize("kind,B,N,D,H,W,C", S1_CASES)
def test_bev_pool_kernel_matches_plain(kind, B, N, D, H, W, C):
    """S1 against its plain version on the card: the same points per voxel
    (depth and features 1) and so the same occupied voxels, values within
    rtol 1e-5 + atol 1e-6 (sums in point order against index_add_'s
    atomics; rtol 1e-4 + atol 1e-5 for the heavy voxels' sums of hundreds),
    and the same against the plain version on the CPU; a quarter of the
    points lie on voxel faces; two calls bitwise equal. C = 40 takes a
    ragged channel chunk, C = 64 two whole ones, C = 96 the runs of 32
    voxels that wider C takes; ``odd_grid`` writes a grid of 3,087 voxels
    a batch (S1_ODD_GRID) element by element; ``heavy`` and
    ``one_voxel`` sort intervals of hundreds and over a thousand points
    (see s1_points)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from presight_tpu_torch.occupancy import bev_pool as PB

    rng = np.random.RandomState(0)
    lb, iv, gs = S1_LB, S1_IV, S1_ODD_GRID if kind == "odd_grid" else S1_GRID
    rtol, atol = (1e-5, 1e-6) if kind in ("random", "odd_grid") else (1e-4, 1e-5)
    depth, feat, coor = s1_points(rng, kind, B, N, D, H, W, C)
    args = [torch.from_numpy(a).cuda() for a in (depth, feat, coor)]
    got = PB.bev_pool_v2(*args, lb, iv, gs)
    again = PB.bev_pool_v2(*args, lb, iv, gs)
    ones = (torch.ones_like(args[0]), torch.ones_like(args[1][..., :1]), args[2])
    counts = PB.bev_pool_v2(*ones, lb, iv, gs)
    with kernels.plain_versions():
        want = PB.bev_pool_v2(*args, lb, iv, gs)
        counts_plain = PB.bev_pool_v2(*ones, lb, iv, gs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(counts, counts_plain)
    assert torch.equal(got != 0, want != 0)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    if kind == "heavy":
        assert int(counts.max()) > 256
    if kind == "one_voxel":
        assert int((counts > 0).sum()) == B and int(counts.max()) == N * D * H * W
    cpu = PB.bev_pool_v2(*(torch.from_numpy(a) for a in (depth, feat, coor)), lb, iv, gs)
    assert torch.equal(got.cpu() != 0, cpu != 0)  # the f32 voxel arithmetic of the CPU
    torch.testing.assert_close(got.cpu(), cpu, rtol=rtol, atol=atol)


# S1b resolves a pixel's bins 32 at a time: D = 45 and the rig's D = 88
# take two and three rounds, the last one ragged (13 and 24 bins).
S1B_CASES = S1_CASES + [("random", 1, 2, D, 4, 5, C) for D in (45, 88) for C in (32, 40)]


@pytest.mark.parametrize("kind,B,N,D,H,W,C", S1B_CASES)
def test_bev_pool_bwd_kernel_matches_plain(kind, B, N, D, H, W, C):
    """S1b against its plain version (bev_pool_v2_bwd_plain) on the card
    and on the CPU, on S1's inputs (a quarter of the points on voxel faces,
    points outside the grid, voxels of hundreds of points): d depth and d
    feat within rtol 1e-5 + atol 1e-6 of the largest (d feat sums a pixel's
    D products in bin order as the plain version does, d depth a dot
    product over C in another order), d depth exactly 0 outside the grid,
    two calls bitwise equal; C = 40, 64 and 96 take one to three channel
    chunks past the first (ragged, whole, and the kernel's 4-chunk form);
    D = 45 and 88 take later rounds of 32 bins, the last one ragged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from presight_tpu_torch.occupancy import bev_pool as PB

    rng = np.random.RandomState(3)
    gs = S1_ODD_GRID if kind == "odd_grid" else S1_GRID
    depth, feat, coor = s1_points(rng, kind, B, N, D, H, W, C)
    g = rng.randn(B, C, gs[2], gs[1], gs[0]).astype(np.float32)
    args = [torch.from_numpy(a).cuda() for a in (depth, feat, coor, g)]
    got = PB.bev_pool_bwd(*args, S1_LB, S1_IV, gs)
    again = PB.bev_pool_bwd(*args, S1_LB, S1_IV, gs)
    want = PB.bev_pool_v2_bwd_plain(*args, S1_LB, S1_IV, gs)
    cpu = PB.bev_pool_v2_bwd_plain(*(torch.from_numpy(a) for a in (depth, feat, coor, g)),
                                   S1_LB, S1_IV, gs)
    torch.cuda.synchronize()
    outside = PB.voxel_ranks(args[2], S1_LB, S1_IV, gs) == B * gs[0] * gs[1] * gs[2]
    for a, b, w, c in zip(got, again, want, cpu):
        assert torch.equal(a, b)
        _close_scaled(a, w, rtol=1e-5, atol_frac=1e-6)
        _close_scaled(a.cpu(), c, rtol=1e-5, atol_frac=1e-6)
    assert bool(outside.any()) == (kind != "one_voxel")
    assert bool((got[0][outside] == 0).all())


def test_bev_pool_bwd_refuses_more_than_128_channels():
    """S1b holds at most 4 chunks of 32 channels: C = 129 raises before a
    launch, and no launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from presight_tpu_torch.occupancy import bev_pool as PB

    rng = np.random.RandomState(5)
    gx, gy, gz = S1_GRID
    args = [torch.from_numpy(a).cuda() for a in s1_points(rng, "random", 1, 2, 3, 4, 5, 129)]
    g = torch.zeros((1, 129, gz, gy, gx), device="cuda")
    kernels.reset_launches()
    with pytest.raises(ValueError, match="128"):
        PB.bev_pool_bwd(*args, g, S1_LB, S1_IV, S1_GRID)
    assert kernels.LAUNCHES["bev_pool_bwd"] == 0


def test_bev_pool_autograd_on_the_card_runs_s1b():
    """bev_pool_v2 on CUDA tensors that require grad: a grad_fn, one S1 and
    one S1b launch, the incoming gradient a strided slice of torch.cat's
    backward (as the temporal branch gives it), gradients equal to the
    plain path's (the forward under ``kernels.plain_versions()``, the
    backward after the scope: no S1b launch) within rtol 1e-5 + atol 1e-6
    of the largest, and none for coor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from presight_tpu_torch.occupancy import bev_pool as PB

    rng = np.random.RandomState(4)
    depth, feat, coor = s1_points(rng, "heavy", 2, 3, 10, 8, 10, 32)
    gx, gy, gz = S1_GRID
    g = torch.from_numpy(rng.randn(2, 64, gz, gy, gx).astype(np.float32)).cuda()
    grads = []
    for plain in (False, True):
        d, f, c = (torch.from_numpy(a).cuda().requires_grad_() for a in (depth, feat, coor))
        kernels.reset_launches()
        with kernels.plain_versions(plain):
            out = PB.bev_pool_v2(d, f, c, S1_LB, S1_IV, S1_GRID)
        assert out.grad_fn is not None
        (torch.cat([out, torch.zeros_like(out)], dim=1) * g).sum().backward()
        torch.cuda.synchronize()
        launches = (kernels.LAUNCHES["bev_pool_fwd"], kernels.LAUNCHES["bev_pool_bwd"])
        assert launches == ((0, 0) if plain else (1, 1))
        assert c.grad is None
        grads.append((d.grad, f.grad))
    for a, b in zip(*grads):
        _close_scaled(a, b, rtol=1e-5, atol_frac=1e-6)


def smooth_epipolar_grid(rng, BN, Hs, Ws, D):
    """A stereo grid (BN, D * Hs * Ws, 2) whose bins walk a line through the
    previous image as gen_stereo_grid's do, but through every case of S2's
    row reuse: steps of 0, 1/32, 1/16, 1/4, exactly 1 and -1 pixel, -1/4,
    jumps of 3 and -6 pixels, walks that leave the image and re-enter it
    (positions wrap around a band 4-5 pixels past each edge), a fifth of
    the positions on exact integer coordinates, and samples behind the
    camera (-2: 5% of the bins, and the first three bins of an eighth of
    the pixels). Positions are multiples of 1/32 and Ws - 1, Hs - 1 powers
    of two, so the kernel's (g + 1) / 2 * (W - 1) gives them back exactly."""
    P = Hs * Ws
    sx = rng.choice(np.array([0, 1, 2, 8, 32, -32, -8, 96, -192]) / 32.0, (BN, P, D),
                    p=[0.25, 0.15, 0.1, 0.1, 0.12, 0.08, 0.08, 0.06, 0.06])
    sy = rng.choice(np.array([0, 1, -1, 4, 32, -32]) / 32.0, (BN, P, D),
                    p=[0.5, 0.1, 0.1, 0.1, 0.1, 0.1])
    x = rng.randint(-4 * 32, (Ws + 3) * 32, (BN, P, 1)) / 32.0 + np.cumsum(sx, -1)
    y = rng.randint(-3 * 32, (Hs + 2) * 32, (BN, P, 1)) / 32.0 + np.cumsum(sy, -1)
    x = np.mod(x + 5, Ws + 9) - 5
    y = np.mod(y + 4, Hs + 8) - 4
    snap = rng.rand(BN, P, D) < 0.2
    x, y = np.where(snap, np.floor(x), x), np.where(snap, np.floor(y), y)
    g = np.stack([x / (Ws - 1) * 2 - 1, y / (Hs - 1) * 2 - 1], -1)
    behind = rng.rand(BN, P, D) < 0.05
    behind[:, ::8, :3] = True
    g[behind] = -2.0
    return np.ascontiguousarray(g.transpose(0, 2, 1, 3)).reshape(BN, D * P, 2).astype(np.float32)


S2_CASES = [("random", 3, 16, 24, 64, 12), ("random", 2, 9, 13, 37, 45),
            ("smooth", 2, 17, 33, 256, 88), ("smooth", 2, 17, 33, 40, 45),
            ("smooth", 1, 17, 33, 300, 70)]


@pytest.mark.parametrize("kind,BN,Hs,Ws,C,D", S2_CASES)
def test_stereo_cost_volume_kernel_matches_plain(kind, BN, Hs, Ws, C, D):
    """S2 against its plain version (F.grid_sample per bin) on the card:
    post-ReLU features (exact zeros), samples outside the image and behind
    the camera (-2); the bias mask equal, costs within rtol 1e-5 + atol
    1e-4 (sums over channels in other orders), the softmax within atol
    1e-5; two calls bitwise equal. ``random`` grids miss every held row
    (C = 37 and D = 45 take the lanes' ragged ends); ``smooth`` grids keep
    rows, carry two or one, jump and step back (smooth_epipolar_grid): the
    reference width C = 256 and D = 88, a ragged C = 40, and C = 300 in two
    channel chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from presight_tpu_torch.occupancy.view_transformer import (stereo_cost_volume,
                                                               stereo_row_fetches)

    rng = np.random.RandomState(1)
    prev = np.maximum(rng.randn(BN, Hs, Ws, C), 0).astype(np.float32)
    curr = np.maximum(rng.randn(BN, Hs, Ws, C), 0).astype(np.float32)
    if kind == "random":
        grid = (rng.rand(BN, D * Hs * Ws, 2) * 2.6 - 1.3).astype(np.float32)
        grid[:, ::7] = -2.0
    else:
        grid = smooth_epipolar_grid(rng, BN, Hs, Ws, D)
        reuse = stereo_row_fetches(torch.from_numpy(grid), Hs, Ws, D)
        assert min(reuse["same"], reuse["step"], reuse["jump"]) > 0
    args = [torch.from_numpy(a).cuda() for a in (prev, curr, grid)]
    prob, cost, mask = stereo_cost_volume(*args, D, return_cost=True)
    prob2, cost2, mask2 = stereo_cost_volume(*args, D, return_cost=True)
    with kernels.plain_versions():
        want, want_cost, want_mask = stereo_cost_volume(*args, D, return_cost=True)
    torch.cuda.synchronize()
    assert torch.equal(prob, prob2) and torch.equal(cost, cost2) and torch.equal(mask, mask2)
    assert torch.equal(mask, want_mask) and 0 < int(mask.sum()) < mask.numel()
    torch.testing.assert_close(cost, want_cost, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(prob, want, rtol=0, atol=1e-5)


def test_extraction_on_the_card_keeps_numpy_bits_under_tf32(tmp_path):
    """test_torch_extraction.py's comparison on the card, with TF32 matrix
    products turned on for the process: kept points and f16 features bit for
    bit, colours within 1e-6 of numpy's IEEE f32, and the setting restored.
    The setting is live: the same (N, 64) x (64, 3) product, unguarded,
    misses the f64 one by more than the colours are held to."""
    _need_cuda()
    from test_torch_extraction import check_device_path_matches_numpy

    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert check_device_path_matches_numpy(tmp_path, device="cuda") > 0
        assert torch.backends.cuda.matmul.allow_tf32
        gen = torch.Generator().manual_seed(0)
        feats = torch.rand(4096, 64, generator=gen).cuda()
        red = torch.randn(64, 3, generator=gen).cuda()
        tf32 = (feats @ red).double()
        want = feats.double() @ red.double()
        assert float((tf32 - want).abs().max()) > 1e-4
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _msda_inputs(rng, B, Q, Hh, shapes, T, hd=32, same_rows=False):
    """Value rows of ``shapes`` levels (one table shared by every level with
    ``same_rows``, as the temporal self-attention's two queues share it),
    and taps spread one to two cells round random points of each level, with
    exact integers, coordinates outside the map and a share of zero
    weights among them."""
    from presight_tpu_torch.mapping.deformable import level_rows

    levels = ([(H, W, 0) for H, W in shapes] if same_rows else level_rows(shapes))
    R = max(s + H * W for H, W, s in levels)
    L = len(shapes)
    value = rng.randn(B, R, Hh * hd).astype(np.float32)
    dims = np.array([[W, H] for H, W in shapes], np.float32)  # (L, 2) as (x, y)
    loc = (rng.rand(B, Q, Hh, L, T, 2) * (dims[:, None] + 2) - 1
           + rng.randn(B, Q, Hh, L, T, 2) * 1.5).astype(np.float32)
    loc[:, ::5] = np.round(loc[:, ::5])
    loc[:, ::11, :, :, :, 0] = -1.0
    loc[:, ::13, :, :, :, 1] = dims[None, None, None, :, 1, None] - 1.0
    attn = rng.rand(B, Q, Hh, L, T).astype(np.float32)
    attn[:, ::7] = 0.0
    return levels, value, loc, attn


# The three attention sites at the reference shapes: the temporal
# self-attention (two queues over one 50 x 100 table), the spatial
# cross-attention over six cameras' 2,500 compacted slots (3 levels x 8
# taps), a decoder layer's cross-attention (100 queries x 20 points); and a
# head width of 16.
MSDA_CASES = [("tsa", 1, 5000, 8, [(50, 100), (50, 100)], 4, 32, True),
              ("sca", 6, 2500, 8, [(60, 100), (30, 50), (15, 25)], 8, 32, False),
              ("decoder", 1, 100, 8, [(50, 100)], 20, 32, False),
              ("narrow", 2, 300, 4, [(13, 17), (7, 9)], 5, 16, False)]


@pytest.mark.parametrize("site,B,Q,Hh,shapes,T,hd,same_rows", MSDA_CASES)
def test_msda_kernel_matches_plain(site, B, Q, Hh, shapes, T, hd, same_rows):
    """S3 ``msda_fwd`` against its plain version (four gathers a tap) on the
    card, at atol 1e-5 of the largest output + rtol 1e-5: the kernel takes
    each corner's weight times the attention weight and sums the taps and
    corners in one fused chain, the plain version the corners first, then
    the weighted taps; two calls bitwise equal."""
    _need_cuda()
    from presight_tpu_torch.mapping.deformable import msda

    rng = np.random.RandomState(len(site))
    levels, *arrays = _msda_inputs(rng, B, Q, Hh, shapes, T, hd, same_rows)
    value, loc, attn = (torch.from_numpy(a).cuda() for a in arrays)
    with torch.no_grad():
        got = msda(value, levels, loc, attn)
        again = msda(value, levels, loc, attn)
        with kernels.plain_versions():
            want = msda(value, levels, loc, attn)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("B,H,W,C", [(6, 30, 50, 1024), (6, 15, 25, 2048), (2, 9, 11, 37)])
def test_deform_im2col_kernel_matches_plain(B, H, W, C):
    """S3 ``deform_im2col_fwd`` against its plain version on the card: the
    two DCNv2 layers' shapes (float4 lanes) and C = 37 (a float a lane);
    offsets one to two cells, exact integers and taps outside the map;
    within rtol 1e-5 + atol 1e-6 of the largest input (the kernel blends the
    four corners by fmaf); two calls bitwise equal."""
    _need_cuda()
    from presight_tpu_torch.mapping.deformable import deform_im2col

    rng = np.random.RandomState(C)
    x = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32)).cuda()
    off = rng.randn(B, H, W, 9, 2).astype(np.float32) * 1.5
    off[:, ::3] = np.round(off[:, ::3])
    off[:, :, ::4, :, 1] = -3.0
    off = torch.from_numpy(off).cuda()
    mask = torch.from_numpy(rng.rand(B, H, W, 9).astype(np.float32)).cuda()
    with torch.no_grad():
        got = deform_im2col(x, off, mask, 3)
        again = deform_im2col(x, off, mask, 3)
        with kernels.plain_versions():
            want = deform_im2col(x, off, mask, 3)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(x.abs().max()))


def test_s3_kernels_refuse_a_gradient():
    """The kernels are forward only: with autograd on and an input that
    requires a gradient they raise, under no_grad they run."""
    _need_cuda()
    from presight_tpu_torch.mapping.deformable import deform_im2col, msda

    value = torch.randn(1, 20, 64, device="cuda", requires_grad=True)
    loc = torch.rand(1, 3, 2, 1, 2, 2, device="cuda") * 4
    attn = torch.rand(1, 3, 2, 1, 2, device="cuda")
    with pytest.raises(RuntimeError, match="backward"):
        msda(value, [(4, 5, 0)], loc, attn)
    x = torch.randn(1, 4, 5, 8, device="cuda", requires_grad=True)
    off = torch.randn(1, 4, 5, 9, 2, device="cuda")
    with pytest.raises(RuntimeError, match="backward"):
        deform_im2col(x, off, torch.rand(1, 4, 5, 9, device="cuda"), 3)
    with torch.no_grad():
        assert msda(value, [(4, 5, 0)], loc, attn).shape == (1, 3, 64)


def _toy_map_stream(frames=3, seed=0):
    """smn-toy with a prior range (a 24 x 12 x 8 grid of 2.5 x 2.5 x 1 m
    voxels) on the card, its weights drawn from the seed (norms' variances
    1), six cameras round the ego car, the ego motion between two frames,
    and ``frames`` frames of images and 300 prior voxels (a third padding,
    some outside the grid), all on the card."""
    import dataclasses
    import math

    from presight_tpu_torch.configs.stage3_configs import map_configs
    from presight_tpu_torch.mapping import StreamMapNet

    cfg = dataclasses.replace(map_configs["smn-toy"](),
                              prior_pc_range=(-30.0, -15.0, -3.0, 30.0, 15.0, 5.0),
                              prior_voxel_size=(2.5, 2.5, 1.0))
    gen = torch.Generator().manual_seed(seed)
    model = StreamMapNet(cfg)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            t.copy_(torch.ones_like(t) if name.endswith("running_var")
                    else torch.randn(t.shape, generator=gen) * 0.1)
    H, W = cfg.img_size
    K = torch.tensor([[W / 2, 0.0, W / 2], [0.0, W / 2, H / 2], [0.0, 0.0, 1.0]])
    lidar2img = torch.zeros(6, 4, 4)
    for i in range(6):
        yaw = i * math.pi / 3
        c, s = math.cos(yaw), math.sin(yaw)
        # ego (x forward, y left, z up) -> camera (x right, y down, z along the view)
        ego2cam = torch.tensor([[s, -c, 0.0], [0.0, 0.0, -1.0], [c, s, 0.0]])
        lidar2img[i, :3, :3] = K @ ego2cam
        lidar2img[i, :3, 3] = K @ torch.tensor([0.0, 1.5, 0.0])
        lidar2img[i, 3, 3] = 1.0
    yaw = math.radians(2.0)
    prev2curr = torch.tensor([[math.cos(yaw), -math.sin(yaw), -1.0],
                              [math.sin(yaw), math.cos(yaw), -0.05], [0.0, 0.0, 1.0]])
    inputs = []
    for _ in range(frames):
        coords = torch.stack([torch.randint(-1, 9, (300,), generator=gen),
                              torch.randint(0, 13, (300,), generator=gen),
                              torch.randint(0, 25, (300,), generator=gen)], -1).to(torch.int32)
        valid = torch.rand(300, generator=gen) > 0.33
        inputs.append({"imgs": torch.randn(6, 3, H, W, generator=gen),
                       "prior_feats": torch.randn(300, 68, generator=gen),
                       "prior_coords": coords, "prior_valid": valid})
    cuda = [{k: v.cuda() for k, v in f.items()} for f in inputs]
    return model.cuda().eval(), cuda, lidar2img.cuda(), prev2curr.cuda()


def test_streamed_mapped_frame_queues_without_a_host_synchronisation():
    """smn-toy with priors through two warm frames (the kernels' build,
    cuDNN's timing of each shape), then a streamed frame with history and
    priors under ``set_sync_debug_mode("error")``: no operation of the
    forward synchronises the host with the card. The mode is restored
    after."""
    _need_cuda()
    model, frames, lidar2img, prev2curr = _toy_map_stream()

    def serve(frame, last):
        history = {} if last is None else dict(
            prev_bev=last["bev"], prev2curr=prev2curr, prev_queries=last["prop_queries"],
            prev_ref_pts=last["prop_ref_pts"])
        return model(frame["imgs"], lidar2img, prior_feats=frame["prior_feats"],
                     prior_coords=frame["prior_coords"], prior_valid=frame["prior_valid"],
                     **history)

    with torch.no_grad():
        first = serve(frames[0], None)
        last = serve(frames[1], first)
        torch.cuda.synchronize()
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = serve(frames[2], last)
        finally:
            torch.cuda.set_sync_debug_mode(before)
    torch.cuda.synchronize()
    assert torch.cuda.get_sync_debug_mode() == before
    assert "keep" in out and "keep" not in first
    assert all(torch.isfinite(out[k]).all() for k in ("scores", "lines", "bev"))
