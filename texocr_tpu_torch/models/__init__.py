"""ViT encoder (hybrid ResNet or patch embed), causal decoder; greedy, sampled
and beam decode."""

from texocr_tpu_torch.models.beam import beam_decode  # noqa: F401
from texocr_tpu_torch.models.generate import (  # noqa: F401
    generate,
    greedy_decode,
    mesh_generate,
    sampled_decode,
)
from texocr_tpu_torch.models.ocr_model import OCRModel, create_model  # noqa: F401
