"""Each driver at a tiny size on the CPU: set-up, a short window and the
check against its reference; and the check's faults: with the timed path
broken underneath, ``correct`` comes out false, once for each fault the
cell can have (a step that leaves the state unchanged; half of the batch
left out, the mean taken over the rest; an answer altered where it is
produced). One chip, so no cell has an exchange between chips to leave
out."""

from __future__ import annotations

import torch

from tiny import SEED, nerf, occ

from harness import load


def correct(checks) -> bool:
    return all(value <= limit for _, value, limit in checks)


def nerf_session():
    cell, cfg = nerf()
    return load.driver("nerf_train").Session(cell, cfg, SEED, device="cpu", adopt=True)


def occ_session(driver: str, cell: str):
    c, cfg = occ(cell)
    return load.driver(driver).Session(c, cfg, SEED, device="cpu", adopt=True)


def test_nerf_train_matches_its_reference():
    s = nerf_session()
    values, attempted, failed = s.window(0.1)
    assert attempted >= 1 and failed == 0 and values["train_rays_per_s"] > 0
    checks = s.check()
    assert [c[0] for c in checks] == [
        "batch_max_abs", "field_rel_gap", "loss_rel_gap", "first_grad_leaf_gap",
        "change_leaf_gap"]
    assert correct(checks), checks


def test_occ_train_matches_its_reference():
    s = occ_session("occ_train", "occ-train-b4")
    values, attempted, _ = s.window(0.1)
    assert attempted >= 1 and values["occ_train_frames_per_s"] > 0
    assert s.unit_work["conv_bwd_flops"] > 0
    checks = s.check()
    assert correct(checks), checks


def test_occ_serve_matches_its_reference():
    s = occ_session("occ_serve", "occ-serve-stream")
    values, attempted, _ = s.window(0.3)
    assert attempted >= 1 and values["occ_frame_ms_p95"] > 0
    assert s.unit_work["conv_bwd_flops"] == 0 and s.unit_work["conv_fwd_flops"] > 0
    checks = s.check()
    assert correct(checks), checks


def test_nerf_train_fails_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from presight_tpu_torch.engine import optimizers

    monkeypatch.setattr(optimizers.GroupOptimizer, "step", lambda self: None)
    assert not correct(nerf_session().check())


def test_nerf_train_fails_half_the_batch(monkeypatch):
    from presight_tpu_torch.engine import trainer

    step = trainer.train_step

    def half(model, optimizers, cameras, batch, *args, **kwargs):
        n = batch["ray_index"].shape[0] // 2
        return step(model, optimizers, cameras, {k: v[:n] for k, v in batch.items()},
                    *args, **kwargs)

    monkeypatch.setattr(trainer, "train_step", half)
    assert not correct(nerf_session().check())


def test_occ_train_fails_a_step_that_leaves_the_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    assert not correct(occ_session("occ_train", "occ-train-b4").check())


def test_occ_train_fails_half_the_batch(monkeypatch):
    from presight_tpu_torch.scripts import train_occ

    step = train_occ.train_step

    def half(model, optimizer, ema, batch, *args, **kwargs):
        n = batch["imgs"].shape[0] // 2
        return step(model, optimizer, ema, {k: v[:n] for k, v in batch.items()}, *args,
                    **kwargs)

    monkeypatch.setattr(train_occ, "train_step", half)
    assert not correct(occ_session("occ_train", "occ-train-b4").check())


def test_occ_serve_fails_an_altered_answer(monkeypatch):
    from presight_tpu_torch.occupancy import BEVDetOcc

    forward = BEVDetOcc.forward

    def altered(self, *args, **kwargs):
        occ, *rest = forward(self, *args, **kwargs)
        occ = occ.clone()
        occ[0, 0, 0, 0, 0] += 1.0
        return (occ, *rest)

    monkeypatch.setattr(BEVDetOcc, "forward", altered)
    assert not correct(occ_session("occ_serve", "occ-serve-stream").check())


def extract_session():
    cell, cfg = nerf()
    cell = dict(load.cell("nerf-c0-extract"), downscale=100)  # 9 x 16 pixels a camera
    return load.driver("nerf_extract").Session(cell, cfg, SEED, device="cpu", adopt=True)


def test_nerf_extract_matches_its_reference():
    s = extract_session()
    values, attempted, _ = s.window(0.1)
    assert attempted >= 1 and values["extract_frames_per_s"] > 0
    assert len(s.kept[0]["hits"]) > 0
    checks = s.check()
    assert correct(checks), checks


def test_nerf_extract_fails_an_altered_answer(monkeypatch):
    from presight_tpu_torch.prior import extraction

    extract = extraction.extract_voxels

    def altered(*args, **kwargs):
        result = extract(*args, **kwargs)
        result["points"][0] += 0.01  # inside its 0.4-m voxel
        return result

    monkeypatch.setattr(extraction, "extract_voxels", altered)
    assert not correct(extract_session().check())
