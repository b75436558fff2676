"""One-off inference CLI:

    python -m texocr_tpu_torch.serving.cli equation.png --config config.json \\
        [--checkpoint model.pth] [--mode greedy|beam|sample] [--max_len 350] [--device cuda]

The image is opened with PIL where it is installed (as the JAX package does);
without PIL it is read by ``image_io.decode_image`` (PNG needs no PIL).
"""

from __future__ import annotations

import argparse

from texocr_tpu_torch.config import load_config
from texocr_tpu_torch.serving.image_io import decode_image
from texocr_tpu_torch.serving.wrapper import TexOCR


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Image -> LaTeX inference.")
    p.add_argument("image", type=str)
    p.add_argument("--config", type=str, default="config/config.yml",
                   help="configuration file (.yml, or .json without PyYAML)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="reference state dict (.pth/.pt) or .npz")
    p.add_argument("--max_len", type=int, default=350)
    p.add_argument("--temp", type=float, default=0.3)
    p.add_argument("--mode", type=str, default="greedy", choices=["greedy", "beam", "sample"])
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p.parse_args(argv)


def read_image(path: str):
    """A PIL image where PIL is installed, else a uint8 array."""
    try:
        from PIL import Image
    except ImportError:
        with open(path, "rb") as f:
            return decode_image(f.read())
    return Image.open(path)


def main(argv=None) -> None:
    args = parse_args(argv)
    config = load_config(args.config)
    if args.checkpoint:
        config["model_path"] = args.checkpoint
    engine = TexOCR(config, device=args.device)
    tokens, latex = engine(read_image(args.image), max_len=args.max_len, temp=args.temp,
                           mode=args.mode, beam_size=args.beam_size)
    print(f"tokens: {tokens}")
    print(latex)


if __name__ == "__main__":
    main()
