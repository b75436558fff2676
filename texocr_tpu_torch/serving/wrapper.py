"""Inference wrapper: image -> (token ids, LaTeX string).

``TexOCR(config)`` loads the tokenizer named by ``config['tokenizer_path']``
and a reference-keyed state dict (``config['model_path']``: whatever
``checkpoint.load_weights`` reads, a JAX run's ``checkpoint_e*`` directory
included; or ``state_dict=``), adopting the checkpoint's decoder positional-table length;
without one the weights come from a generator seeded with ``config['seed']``.
Each image goes onto a white uint8 bucket canvas (height a multiple of 16,
width of 64, at most the configured ``img_size``), crosses to the device as
uint8 and becomes ``1 - u8 / 255`` there. Then encode, decode (``greedy``,
``sample``: the reference's top-k/temperature sampling, or ``beam``), and BPE
decode plus ``process_output`` up to EOS or PAD. Sampling draws from a
``torch.Generator`` on the device, seeded with ``config['seed']``, which
advances with every sampled call.

On a CUDA device every batch decodes through CUDA graphs, captured on the
first call of each (canvas, batch, max_len, mode, beam width or temperature)
and replayed after (``models.graphed.make_graphed_generate``), as the JAX
wrapper keeps one jitted program per shape. An engine on the CPU runs the
eager ``generate``; the tokens are the same.

A config whose decoder is ``mla_moe`` keeps its own vocabulary and takes a
state dict's tensors in place (``OCRModel``), so the card holds one copy of
the weights; ``generate_batch`` returns its token ids, and the LaTeX text of
ids beyond the tokenizer's is not defined.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from texocr_tpu_torch import telemetry
from texocr_tpu_torch.checkpoint.convert import POS_EMBED_KEY
from texocr_tpu_torch.checkpoint.io import load_weights
from texocr_tpu_torch.config import ModelConfig, with_defaults
from texocr_tpu_torch.models import OCRModel, generate
from texocr_tpu_torch.models.graphed import GraphedGenerate, make_graphed_generate
from texocr_tpu_torch.tokenizer import RegexBPETokenizer
from texocr_tpu_torch.utils import pad_to_multiple, process_output


class TexOCR:
    def __init__(self, config: dict, device="cuda",
                 state_dict: Optional[Dict[str, torch.Tensor]] = None):
        config = with_defaults(dict(config))
        self.tokenizer = RegexBPETokenizer().load(config["tokenizer_path"])
        # The texocr decoder's vocabulary; the prefix decoder keeps its own.
        config["vocab_size"] = self.tokenizer.vocab_size
        if state_dict is None and config.get("model_path"):
            state_dict = load_weights(config["model_path"])
        if state_dict is not None and POS_EMBED_KEY in state_dict:
            # Adopt the checkpoint's positional-table length.
            config["max_length"] = int(state_dict[POS_EMBED_KEY].shape[0])
        config.setdefault("max_length", 512)
        self.config = config
        self.device = torch.device(device)
        self.model = OCRModel(ModelConfig.from_dict(config), device=self.device,
                              seed=config.get("seed", 42), state_dict=state_dict)
        self.model.eval()
        self.generator = torch.Generator(device=self.device).manual_seed(config.get("seed", 42))
        self._compiled: Dict[Tuple, GraphedGenerate] = {}
        self._compiling = threading.Lock()

    # -- preprocessing ---------------------------------------------------------

    def preprocess(self, img) -> np.ndarray:
        """A PIL image or a 2-D uint8 array -> (1, H', W', 1) uint8 canvas.

        An image larger than the largest canvas is scaled down to fit: a PIL
        image with PIL's bilinear resize, as the JAX wrapper does; an array with
        ``F.interpolate(mode='bilinear', antialias=True)``, which is close to
        but not byte-identical with PIL's."""
        if isinstance(img, np.ndarray):
            if img.ndim != 2 or img.dtype != np.uint8:
                raise ValueError(f"expected a 2-D uint8 array, got {img.dtype} {img.shape}")
            arr = img
        else:
            arr = None
            if img.mode != "L":
                img = img.convert("L")
        h, w = (arr.shape if arr is not None else img.size[::-1])
        max_h, max_w = self.model.config.encoder.img_size
        ch = min(pad_to_multiple(max(h, 16), 16), max_h)
        cw = min(pad_to_multiple(max(w, 64), 64), max_w)
        if h > ch or w > cw:
            scale = min(ch / h, cw / w)
            new_w, new_h = max(1, int(w * scale)), max(1, int(h * scale))
            if arr is None:
                from PIL import Image

                img = img.resize((new_w, new_h), Image.BILINEAR)
            else:
                x = torch.from_numpy(arr.astype(np.float32))[None, None]
                x = F.interpolate(x, size=(new_h, new_w), mode="bilinear",
                                  align_corners=False, antialias=True)
                arr = x[0, 0].round().clamp(0, 255).to(torch.uint8).numpy()
            h, w = new_h, new_w
            # Capped at the largest canvas: a width of 1008 rounds up to 1024,
            # which the positional table does not cover.
            ch = min(pad_to_multiple(max(h, 16), 16), max_h)
            cw = min(pad_to_multiple(max(w, 64), 64), max_w)
        canvas = np.full((ch, cw), 255, np.uint8)
        top, left = (ch - h) // 2, (cw - w) // 2
        canvas[top: top + h, left: left + w] = arr if arr is not None else np.asarray(img)
        return canvas[None, ..., None]

    # -- inference ---------------------------------------------------------------

    def __call__(self, img, max_len: int = 350, temp: float = 0.3, mode: str = "greedy",
                 beam_size: int = 5) -> Tuple[list, str]:
        """(token ids up to and excluding EOS, LaTeX string). ``mode``:
        "greedy", "sample" (at ``temp``) or "beam" (``beam_size`` wide)."""
        tokens = self.generate_batch(self.preprocess(img), max_len=max_len, temp=temp,
                                     mode=mode, beam_size=beam_size)
        return self.postprocess(tokens[0].cpu().numpy())

    def _decode_fn(self, shape: Tuple[int, ...], max_len: int, mode: str, beam_size: int,
                   temp: float) -> GraphedGenerate:
        """The graphs of one key, captured on its first call."""
        batch, h, w = shape[:3]
        key = ((h, w), batch, max_len, mode, beam_size if mode == "beam" else None,
               temp if mode == "sample" else None)
        with self._compiling:
            if key not in self._compiled:
                self._compiled[key] = make_graphed_generate(
                    self.model, batch, (h, w), max_len, mode, beam_size=beam_size,
                    generator=self.generator, temp=temp)
            return self._compiled[key]

    def generate_batch(self, images, max_len: int = 350, temp: float = 0.3,
                       mode: str = "greedy", beam_size: int = 5) -> torch.Tensor:
        """(B, H, W, 1) uint8 canvases (numpy or tensor) -> (B, max_len) int64
        token ids on the model's device, PAD after EOS. A model whose decoder
        has no cross-attention raises ``ValueError`` (``check_mode``)."""
        u8 = torch.as_tensor(images)
        with telemetry.span("engine.call"):
            if self.device.type == "cuda":
                return self._decode_fn(tuple(u8.shape), max_len, mode, beam_size, temp)(u8)
            u8 = u8.to(self.device)
            return generate(self.model, 1.0 - u8.float() / 255.0, max_len=max_len, mode=mode,
                            generator=self.generator, temp=temp, beam_size=beam_size)

    def postprocess(self, row: np.ndarray) -> Tuple[list, str]:
        cfg = self.model.config
        ids = []
        for t in row.tolist():
            if t == cfg.eos_token or t == cfg.pad_token:
                break
            ids.append(int(t))
        return ids, process_output(self.tokenizer.decode(ids))
