from .synthetic import SyntheticVedai, pad_labels
from .vedai import (VedaiDataset, apply_single_cls, derive_ir_path,
                    derive_label_path)
from .loader import make_eval_batches, make_train_batches

__all__ = ["SyntheticVedai", "VedaiDataset", "apply_single_cls",
           "derive_ir_path", "derive_label_path", "make_eval_batches",
           "make_train_batches", "pad_labels"]
