"""Serving: the TexOCR inference wrapper (image -> LaTeX)."""

from texocr_tpu_torch.serving.wrapper import TexOCR  # noqa: F401
