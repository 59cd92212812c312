from .activations import gelu
from .boxes import xywh2xyxy, xywhn2xyxy, clip_coords, box_iou
from .nms import batched_nms, MAX_WH

__all__ = ["gelu", "xywh2xyxy", "xywhn2xyxy", "clip_coords", "box_iou",
           "batched_nms", "MAX_WH"]
