from .compiler import build_model, parse_config, MODULE_REGISTRY
from .model import DetectionModel
from .detect import Detect, decode_detections

__all__ = ["build_model", "parse_config", "MODULE_REGISTRY", "DetectionModel",
           "Detect", "decode_detections"]
