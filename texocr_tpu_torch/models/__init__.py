"""Hybrid ResNet + ViT encoder, causal cross-attending decoder; greedy,
sampled and beam decode."""

from texocr_tpu_torch.models.beam import beam_decode  # noqa: F401
from texocr_tpu_torch.models.generate import generate, greedy_decode, sampled_decode  # noqa: F401
from texocr_tpu_torch.models.ocr_model import OCRModel  # noqa: F401
