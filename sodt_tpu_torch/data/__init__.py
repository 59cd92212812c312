from .synthetic import (SyntheticVedai, apply_single_cls, make_eval_batches,
                        pad_labels)

__all__ = ["SyntheticVedai", "apply_single_cls", "make_eval_batches",
           "pad_labels"]
