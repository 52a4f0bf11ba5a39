"""Stage-3 occupancy serving (BEVDet-Occ consuming the city priors), the
port of presight_tpu/occupancy over PyTorch, with kernels S1 (lift-splat
pooling) and S2 (stereo cost volume)."""

from .bev_pool import bev_pool_v2
from .bevdet_occ import BEVDetOcc, BEVDetOccConfig
from .inference import mapped_apply
from .view_transformer import LSSViewTransformer, stereo_cost_volume

__all__ = ["bev_pool_v2", "BEVDetOcc", "BEVDetOccConfig", "LSSViewTransformer", "mapped_apply",
           "stereo_cost_volume"]
