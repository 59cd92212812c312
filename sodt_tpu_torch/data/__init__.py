from .synthetic import SyntheticVedai, pad_labels
from .vedai import VedaiDataset, apply_single_cls
from .loader import make_eval_batches

__all__ = ["SyntheticVedai", "VedaiDataset", "apply_single_cls",
           "make_eval_batches", "pad_labels"]
