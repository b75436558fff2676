"""Evaluation: token accuracy (reference batch_acc semantics), exact match and
edit similarity."""

from texocr_tpu_torch.evaluation.metrics import (  # noqa: F401
    batch_acc,
    edit_similarity,
    exact_match_rate,
)
