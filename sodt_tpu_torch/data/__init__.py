from .synthetic import SyntheticVedai, make_eval_batches, pad_labels

__all__ = ["SyntheticVedai", "make_eval_batches", "pad_labels"]
