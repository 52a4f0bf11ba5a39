"""The control of each cell comes out as not correct: its reference in the
nearest precision below the configuration's float32 (TF32 products and
convolutions), put in the program's place, fails at least one of the
cell's limits. On the card at tiny sizes; the cells' own readings, at
their sizes on three seeds and more, are in PERF.md (calibrate.py)."""

from __future__ import annotations

import pytest
import torch

from tiny import SEED, nerf, occ

from harness import load


def sessions():
    yield "nerf_train", nerf()
    yield "occ_train", occ("occ-train-b4")
    yield "occ_serve", occ("occ-serve-stream")
    cell, cfg = nerf()
    yield "nerf_extract", (dict(load.cell("nerf-c0-extract"), downscale=20), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("driver,cell_config", list(sessions()), ids=lambda x: str(x)[:12])
def test_the_control_is_not_correct(driver, cell_config):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 exists only there")
    cell, cfg = cell_config
    session = load.driver(driver).Session(cell, cfg, SEED, device="cuda", adopt=True)
    if driver in ("occ_serve", "nerf_extract"):
        session.window(0.5)
    control = session.calibration()["control"]
    # Readings without a limit (extraction reports them for calibration)
    # are not compared, as in a run.
    assert not all(value <= limit for _, value, limit in control if limit is not None), control
