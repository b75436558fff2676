"""Cross-attention heatmaps: where the decoder looked for each output token.

Decode an image greedily, then replay [BOS] + the decoded ids teacher-forced
with ``return_attn=True`` and render each output token's cross-attention
distribution over the encoder's token grid as a red overlay on the canvas.
Needs neither PIL nor PyYAML: PNGs are read and written with the standard
library (``serving/image_io.py``) and a ``.json`` config needs no PyYAML.

Usage:
  python -m texocr_tpu_torch.tools.attention_maps eq.png --config cfg.json \\
      [--checkpoint model.pth] --out DIR [--max_len 350] [--layer -1] \\
      [--max_tokens 64] [--device cuda]

Outputs: ``<out>/token_XXX.png`` per decoded token (overlay), and
``<out>/summary.json`` (decoded ids and LaTeX, the grid, each token's
strongest patch and its weight on the CLS token).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from texocr_tpu_torch.config import load_config
from texocr_tpu_torch.serving.image_io import decode_image, encode_png


@torch.inference_mode()
def cross_attention_maps(engine, canvas_u8: np.ndarray, token_ids: List[int]) -> np.ndarray:
    """Teacher-forced replay of [BOS] + ``token_ids`` on a (1, H, W, 1) uint8
    canvas -> (layers, heads, T + 1, N_enc) float32 post-softmax
    cross-attention weights. The replay takes the math path: no flash
    launch."""
    model = engine.model
    cfg = model.config
    images = 1.0 - torch.as_tensor(canvas_u8, device=engine.device).float() / 255.0
    enc = model.encode(images)
    seq = torch.tensor([[cfg.bos_token] + [int(t) for t in token_ids]], device=engine.device)
    _, maps = model.dec(seq, enc, return_attn=True)
    # Sub-layers per decoder layer are (self, cross, mlp): the maps alternate
    # [self, cross]. Without cross-attention the [1::2] slice would mislabel
    # self-attention maps.
    num_layers = cfg.decoder.num_layers
    if len(maps) != 2 * num_layers:
        raise ValueError(
            f"expected [self, cross] maps per layer ({2 * num_layers}), got "
            f"{len(maps)} — is the decoder configured with cross_attend?"
        )
    return torch.stack([m[0] for m in maps[1::2]]).float().cpu().numpy()


def heat_to_overlay(base_l: np.ndarray, heat: np.ndarray) -> np.ndarray:
    """(h, w) uint8 grey canvas + (gh, gw) heat -> (h, w, 3) uint8 RGB
    overlay: the heat, scaled to its peak and cut to uint8, upscaled
    bilinearly (half-pixel centres, edges clamped) and pushed into red."""
    h, w = base_l.shape
    heat = heat / (heat.max() + 1e-9)
    heat_u8 = torch.from_numpy((heat * 255).astype(np.uint8)).float()[None, None]
    up = F.interpolate(heat_u8, size=(h, w), mode="bilinear", align_corners=False)[0, 0]
    heat_arr = up.round().clamp(0, 255).numpy() / 255.0
    base = base_l.astype(np.float32)
    rgb = np.stack(
        [
            base + (255.0 - base) * heat_arr * 0.9,  # push red up in hot spots
            base * (1.0 - 0.6 * heat_arr),
            base * (1.0 - 0.6 * heat_arr),
        ],
        axis=-1,
    )
    return np.clip(rgb, 0, 255).astype(np.uint8)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("image", type=str)
    p.add_argument("--config", type=str, default="config/config.yml")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="a reference state dict (.pth, .pt or .npz)")
    p.add_argument("--out", type=str, default="attn_maps")
    p.add_argument("--max_len", type=int, default=350)
    p.add_argument("--layer", type=int, default=-1,
                   help="decoder layer to visualize (-1 = mean over layers)")
    p.add_argument("--max_tokens", type=int, default=64,
                   help="cap on per-token overlay PNGs written")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    from texocr_tpu_torch.serving import TexOCR

    args = parse_args(argv)
    config = load_config(args.config)
    if args.checkpoint:
        config["model_path"] = args.checkpoint
    engine = TexOCR(config, device=args.device)

    with open(args.image, "rb") as f:
        canvas = engine.preprocess(decode_image(f.read()))
    tokens = engine.generate_batch(canvas, max_len=args.max_len, mode="greedy")[0]
    ids, latex = engine.postprocess(tokens.cpu().numpy())
    if not ids:
        print("decoded zero tokens before EOS; nothing to visualize")
        return 1

    attn = cross_attention_maps(engine, canvas, ids)  # (L, H, T, N)
    layer = attn.mean(axis=0) if args.layer == -1 else attn[args.layer]
    per_token = layer.mean(axis=0)  # (T, N): mean over heads

    gh, gw = engine.model.encoder.feature_grid(*canvas.shape[1:3])
    if per_token.shape[-1] != gh * gw + 1:
        raise ValueError(f"maps over {per_token.shape[-1]} encoder tokens, grid {(gh, gw)}")

    os.makedirs(args.out, exist_ok=True)
    base = canvas[0, ..., 0]
    summary = {"latex": latex, "tokens": ids, "grid": [gh, gw], "per_token": []}
    # Row t of the teacher-forced replay predicts token t of ``ids``: the
    # attention row for ids[t] is position t (BOS occupies the first input).
    for t, tok in enumerate(ids[: args.max_tokens]):
        heat = per_token[t, 1:].reshape(gh, gw)  # drop CLS
        name = f"token_{t:03d}.png"
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(encode_png(heat_to_overlay(base, heat)))
        peak = int(heat.argmax())
        summary["per_token"].append({
            "t": t, "id": int(tok),
            "text": engine.tokenizer.decode([int(tok)]),
            "peak_patch_yx": [peak // gw, peak % gw],
            "cls_weight": float(per_token[t, 0]),
        })
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"decoded: {latex!r}")
    print(f"{min(len(ids), args.max_tokens)} overlays -> {args.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
