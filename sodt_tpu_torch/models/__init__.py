from .compiler import build_model, parse_config
from .model import DetectionModel
from .detect import decode_detections

__all__ = ["build_model", "parse_config", "DetectionModel",
           "decode_detections"]
