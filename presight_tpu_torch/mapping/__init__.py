"""Online mapping: StreamMapNet with the city prior, served frame by frame
(the port of presight_tpu/mapping/: the BEVFormer encoder with DCNv2, the
streaming ConvGRU memory, PriorFusion2D and the DETR-style map head, over
kernel S3 for the deformable sampling)."""

from .conv_gru import ConvGRU, warp_bev
from .map_head import MapDetectorHead, select_topk_for_propagation
from .bev_encoder import BEVEncoder
from .stream_mapnet import StreamMapNet, StreamMapNetConfig

__all__ = ["BEVEncoder", "ConvGRU", "warp_bev", "MapDetectorHead",
           "select_topk_for_propagation", "StreamMapNet", "StreamMapNetConfig"]
