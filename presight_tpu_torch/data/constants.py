"""Batch-key constants and class tables.

Reference spec: nerfstudio-0.3.3/nerfstudio/data/PreSight/constants.py.
"""

IMAGE_INDEX = "image_index"
PIXEL_INDEX = "pixel_index"
RGB = "rgb"
DEPTH = "depth"
FEATURES = "features"

RAY_INDEX = "ray_index"
WIDTH = "width"
TIME = "time"
VIDEO_ID = "video_id"

MASK = "mask"
SEG = "seg"

SKY = "sky"

CITYSCAPE_CLASSES = [
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
]

SKY_CLASS_ID = CITYSCAPE_CLASSES.index("sky")

# Dynamic classes masked out of training batches (my_datamanager.py:101-103).
DEFAULT_MASK_SEG_CLASSES = (
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
)

NUSCENES_CAMERAS = (
    "CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
)
