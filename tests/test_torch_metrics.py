"""The port's image metrics (presight_tpu_torch/utils/metrics.py) against
the JAX package's on random images: PSNR and SSIM within rtol 1e-5 (the
port sums in float64, JAX in float32 with HIGHEST-precision convolutions);
LPIPS absent (warned once) without weights, and an error when the weights
named cannot be loaded (tests/test_torch_lpips.py holds the scorer)."""

import jax.numpy as jnp
import numpy as np
import pytest

from presight_tpu.utils import metrics as JM
from presight_tpu_torch.utils import metrics as TM


@pytest.mark.parametrize("shape", [(16, 16, 3), (45, 80, 3), (33, 20, 1)])
def test_psnr_ssim_match_jax(shape):
    rng = np.random.RandomState(shape[0])
    gt = rng.rand(*shape).astype(np.float32)
    pred = np.clip(gt + rng.randn(*shape).astype(np.float32) * 0.1, 0, 1)
    np.testing.assert_allclose(TM.psnr(pred, gt), float(JM.psnr(jnp.asarray(pred), jnp.asarray(gt))),
                               rtol=1e-5)
    np.testing.assert_allclose(TM.ssim(pred, gt), float(JM.ssim(jnp.asarray(pred), jnp.asarray(gt))),
                               rtol=1e-5)


def test_lpips_absent_or_refused(monkeypatch):
    monkeypatch.delenv("PRESIGHT_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setattr(TM, "_LPIPS_CACHE", {})
    with pytest.warns(UserWarning, match="LPIPS"):
        assert TM.lpips_fn() is None
    assert TM.lpips_fn() is None  # warned once
    monkeypatch.setenv("PRESIGHT_LPIPS_WEIGHTS", "/nonexistent/lpips.npz")
    with pytest.raises(FileNotFoundError):
        TM.lpips_fn()
