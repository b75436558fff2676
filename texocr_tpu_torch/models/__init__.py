"""Hybrid ResNet + ViT encoder, causal cross-attending decoder, greedy decode."""

from texocr_tpu_torch.models.generate import greedy_decode  # noqa: F401
from texocr_tpu_torch.models.ocr_model import OCRModel  # noqa: F401
