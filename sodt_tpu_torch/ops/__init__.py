from .activations import gelu
from .boxes import (xyxy2xywh, xywh2xyxy, xywhn2xyxy, xyn2xy, clip_coords,
                    scale_coords, bbox_iou, box_iou, wh_iou)
from .letterbox import letterbox_params, letterbox_image
from .nms import batched_nms, single_image_nms, MAX_WH

__all__ = ["gelu", "xyxy2xywh", "xywh2xyxy", "xywhn2xyxy", "xyn2xy",
           "clip_coords", "scale_coords", "bbox_iou", "box_iou", "wh_iou",
           "letterbox_params", "letterbox_image", "batched_nms",
           "single_image_nms", "MAX_WH"]
