"""Stage-3 occupancy (BEVDet-Occ consuming the city priors), serving and
training, the port of presight_tpu/occupancy over PyTorch, with kernels S1
and S1b (lift-splat pooling and its gradient) and S2 (stereo cost volume)."""

from .bev_pool import bev_pool_v2
from .bevdet_occ import BEVDetOcc, BEVDetOccConfig, occ_loss
from .inference import mapped_apply
from .view_transformer import LSSViewTransformer, stereo_cost_volume

__all__ = ["bev_pool_v2", "BEVDetOcc", "BEVDetOccConfig", "LSSViewTransformer", "mapped_apply",
           "occ_loss", "stereo_cost_volume"]
