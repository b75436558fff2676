"""Build a demo dataset of seeded equations without external LaTeX binaries.

The counterpart of the JAX package's ``tools/make_demo_dataset.py``: the same
equations for the same ``--seed``, ``--n`` and mode, the same split files
(``{train,test,val}/{labels.txt, ids.txt, images/}``), the same pixels and
the same pickles. Equations render with PIL's bitmap font (the default and
``--realistic``/``--entropic`` profiles) or, with ``--typeset``, with
matplotlib's mathtext through the data factory's ``mathtext_png``, wrapped
at top-level operators onto the realistic profile canvases.

    python -m texocr_tpu_torch.tools.make_demo_dataset --out data_demo --n 2000 \\
        [--simple | --realistic | --entropic] [--typeset] [--seed 42] [--processes N]

PIL is needed in every mode and matplotlib with ``--typeset``; a missing
one raises ``ImportError`` before any file is written. PNGs are written
through a temporary file and a rename, and a build run again over the same
``--out`` renders only the images that do not exist yet (every render is a
function of its equation and, with ``--typeset``, its seed). The typeset
renders run in one pool of spawned processes (``--processes``, default one
per CPU).

The steps are functions of their own: ``demo_equations`` (the label stream
from a generator), ``split_equations``, ``typeset_seeds``, ``write_split``
(one split with a given render function) and ``pickle_splits``.
"""

from __future__ import annotations

import argparse
import contextlib
import multiprocessing
import os
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

SYMBOLS = list("abcdefgxyznmpq") + ["0", "1", "2", "3", "4", "7", "9"]
GREEK = ["\\alpha", "\\beta", "\\gamma", "\\lambda", "\\mu", "\\pi",
         "\\sigma", "\\theta", "\\phi", "\\omega"]
OPS = ["+", "-", "=", "\\cdot", "\\times", "<", ">"]
FUNCS = ["\\sin", "\\cos", "\\log", "\\exp", "\\tan"]

# The realistic profile's canvases (h multiple of 16, w multiple of 64, at
# most (160, 1008)); every render lands on the smallest that fits it.
REALISTIC_PROFILES = [(32, 320), (32, 640), (48, 1008), (96, 1008), (160, 1008)]
SPLITS = ("train", "test", "val")


# -- the label stream ----------------------------------------------------------

def random_atom(rng: np.random.Generator) -> str:
    r = rng.random()
    if r < 0.5:
        return rng.choice(SYMBOLS)
    if r < 0.75:
        return rng.choice(GREEK)
    return f"{rng.choice(FUNCS)} {rng.choice(SYMBOLS)}"


def random_term(rng: np.random.Generator, depth: int = 0, flat: bool = False) -> str:
    """A nested term (fractions, scripts, roots, integrals) or, with ``flat``,
    one atom, drawn without the nesting draw."""
    if flat:
        return random_atom(rng)
    r = rng.random()
    a = random_atom(rng)
    if r < 0.25 and depth < 2:
        return f"\\frac {{ {random_term(rng, depth + 1)} }} {{ {random_term(rng, depth + 1)} }}"
    if r < 0.45:
        return f"{a} ^ {{ {rng.choice(SYMBOLS)} }}"
    if r < 0.6:
        return f"{a} _ {{ {rng.choice(SYMBOLS)} }}"
    if r < 0.7 and depth < 2:
        return f"\\sqrt {{ {random_term(rng, depth + 1)} }}"
    if r < 0.78 and depth < 1:
        return (f"\\int _ {{ {rng.choice(SYMBOLS)} }} ^ "
                f"{{ {rng.choice(SYMBOLS)} }} {random_term(rng, depth + 1)}")
    return a


def _join_terms(rng: np.random.Generator, n_terms: int, flat: bool) -> str:
    parts = [random_term(rng, flat=flat)]
    for _ in range(n_terms - 1):
        parts.append(rng.choice(OPS))
        parts.append(random_term(rng, flat=flat))
    return " ".join(parts)


def random_equation(rng: np.random.Generator, max_terms: int = 5, flat: bool = False) -> str:
    return _join_terms(rng, rng.integers(2, max(3, max_terms)), flat)


def realistic_equation(rng: np.random.Generator, term_scale: int = 1, flat: bool = False) -> str:
    """A mixture of lengths: about 30% short, 40% medium and 30% long (the
    long tail gives BPE labels of 100-300 tokens). ``term_scale`` makes up
    for flat atoms compressing about 4x better under BPE than nested terms."""
    r = rng.random()
    if r < 0.3:
        n_terms = int(rng.integers(2, 7)) * term_scale
    elif r < 0.7:
        n_terms = int(rng.integers(8, 20)) * term_scale
    else:
        n_terms = int(rng.integers(20, 29)) * term_scale
    return _join_terms(rng, n_terms, flat)


def demo_equations(rng: np.random.Generator, n: int, simple: bool = False,
                   realistic: bool = False, entropic: bool = False) -> List[str]:
    """The build's ``n`` equations, drawn from ``rng`` in the JAX tool's
    order: flat atoms for ``simple`` and ``entropic``; realistic lengths for
    ``realistic`` and (three times the terms) ``entropic``."""
    flat = simple or entropic
    if entropic:
        return [realistic_equation(rng, term_scale=3, flat=flat) for _ in range(n)]
    if realistic:
        return [realistic_equation(rng, flat=flat) for _ in range(n)]
    return [random_equation(rng, max_terms=3 if simple else 5, flat=flat) for _ in range(n)]


def split_equations(eqs: Sequence[str]) -> Dict[str, List[str]]:
    """train, test and val: the first 80%, the next 15% and the rest."""
    n = len(eqs)
    return {"train": list(eqs[: int(n * 0.8)]),
            "test": list(eqs[int(n * 0.8): int(n * 0.95)]),
            "val": list(eqs[int(n * 0.95):])}


def typeset_seeds(rng: np.random.Generator, splits: Dict[str, List[str]]) -> Dict[str, List[int]]:
    """One render seed per label, drawn split by split after every label."""
    return {split: [int(rng.integers(0, 2**31)) for _ in labels]
            for split, labels in splits.items()}


def image_ids(n: int) -> List[str]:
    return [f"eq_{i:05d}.png" for i in range(n)]


# -- renders -------------------------------------------------------------------

def _pil():
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise ImportError("the demo renders need PIL (the Pillow package)") from e
    return Image, ImageDraw, ImageFont


def check_renderer(typeset: bool = False) -> None:
    """Raises ``ImportError`` naming the package a build's renders lack: PIL
    always, matplotlib with ``typeset``."""
    _pil()
    if typeset:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise ImportError("--typeset renders with matplotlib's mathtext: install "
                              "matplotlib") from e


def _display(eq: str) -> str:
    return eq.replace("\\", "").replace("{", "(").replace("}", ")")


def render(eq: str, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """The equation in PIL's default font on a white canvas 32 high and a
    multiple of 192 wide (at most 960), centred and downscaled to fit.
    Backslashes are dropped and braces drawn as parentheses; the label keeps
    them. Returns an (H, W) uint8 array."""
    Image, ImageDraw, ImageFont = _pil()
    font = ImageFont.load_default()
    display = _display(eq)
    probe = Image.new("L", (8, 8), 255)
    bbox = ImageDraw.Draw(probe).textbbox((0, 0), display, font=font)
    w, h = bbox[2] - bbox[0] + 12, bbox[3] - bbox[1] + 12
    w, h = min(max(w, 32), 1008), min(max(h, 16), 160)
    img = Image.new("L", (w, h), 255)
    ImageDraw.Draw(img).text((6, 4), display, font=font, fill=0)

    new_h = 32
    new_w = min(-(-w // 192) * 192, 960)
    if h > new_h or w > new_w:
        scale = min(new_h / h, new_w / w)
        img = img.resize((max(1, int(w * scale)), max(1, int(h * scale))), Image.BILINEAR)
    return _centre(np.asarray(img), new_h, new_w)


def render_realistic(eq: str, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """The display string wrapped at 160 characters a line, in PIL's default
    font, on the smallest profile canvas that fits it (downscaled into the
    largest when none does). Returns an (H, W) uint8 array."""
    Image, ImageDraw, ImageFont = _pil()
    font = ImageFont.load_default()
    lines, cur = [], ""
    for word in _display(eq).split():
        if len(cur) + len(word) + 1 > 160 and cur:
            lines.append(cur)
            cur = word
        else:
            cur = f"{cur} {word}".strip()
    lines.append(cur)
    text = "\n".join(lines)

    probe = Image.new("L", (8, 8), 255)
    bbox = ImageDraw.Draw(probe).multiline_textbbox((0, 0), text, font=font)
    w, h = bbox[2] - bbox[0] + 12, bbox[3] - bbox[1] + 10
    img = Image.new("L", (max(w, 32), max(h, 16)), 255)
    ImageDraw.Draw(img).multiline_text((6, 4), text, font=font, fill=0)
    return _on_profile(np.asarray(img))


def _centre(img: np.ndarray, ch: int, cw: int) -> np.ndarray:
    """``img`` on a white (ch, cw) canvas, centred as PIL's paste places it
    (the odd pixel at the bottom and the right)."""
    canvas = np.full((ch, cw), 255, np.uint8)
    h, w = img.shape
    top, left = (ch - h) // 2, (cw - w) // 2
    canvas[top: top + h, left: left + w] = img
    return canvas


def _on_profile(img: np.ndarray) -> np.ndarray:
    """``img`` centred on the smallest profile canvas that fits it, or
    downscaled (PIL's bilinear filter) into the largest."""
    h, w = img.shape
    for ph, pw in REALISTIC_PROFILES:
        if h <= ph and w <= pw:
            return _centre(img, ph, pw)
    Image, _, _ = _pil()
    ch, cw = REALISTIC_PROFILES[-1]
    scale = min(ch / h, cw / w)
    small = Image.fromarray(img).resize((max(1, int(w * scale)), max(1, int(h * scale))),
                                        Image.BILINEAR)
    return _centre(np.asarray(small), ch, cw)


def wrap_top_level(eq: str, char_budget: int) -> List[str]:
    """The token stream split into lines at operators outside every brace
    (so each line is valid LaTeX alone), at most ``char_budget`` displayed
    characters a line (backslashes and braces draw no glyph)."""
    def display_len(s):
        return len(s.replace("\\", "").replace("{", "").replace("}", ""))

    segs, cur, depth = [], [], 0
    for tok in eq.split():
        if tok in OPS and depth == 0 and cur:
            segs.append(" ".join(cur))
            cur = [tok]
        else:
            cur.append(tok)
        if tok == "{":
            depth += 1
        elif tok == "}":
            depth -= 1
    if cur:
        segs.append(" ".join(cur))

    lines, line = [], ""
    for seg in segs:
        cand = f"{line} {seg}".strip()
        if line and display_len(cand) > char_budget:
            lines.append(line)
            line = seg
        else:
            line = cand
    if line:
        lines.append(line)
    return lines


def render_realistic_typeset(eq: str, rng: np.random.Generator) -> np.ndarray:
    """The equation typeset by mathtext at a dpi drawn from ``rng`` in
    [100, 150], one image per wrapped line, stacked 4 pixels from the top and
    left with a gap of dpi // 25 (at least 2) and a 4-pixel margin below and
    right, then placed on the profile canvases as ``render_realistic``.
    Returns an (H, W) uint8 array."""
    from texocr_tpu_torch.data.factory.render_data import mathtext_png

    dpi = int(rng.integers(100, 151))
    # About 10 pixels a glyph at dpi 125: a line budget for the 1008-wide canvas.
    lines = wrap_top_level(eq, char_budget=int(88 * 125 / dpi))
    imgs = [mathtext_png(line, dpi) for line in lines]
    gap = max(2, dpi // 25)
    w = max(im.shape[1] for im in imgs) + 8
    h = sum(im.shape[0] for im in imgs) + gap * (len(imgs) - 1) + 8
    img = np.full((h, w), 255, np.uint8)
    y = 4
    for im in imgs:
        img[y: y + im.shape[0], 4: 4 + im.shape[1]] = im
        y += im.shape[0] + gap
    return _on_profile(img)


# -- writing a build -----------------------------------------------------------

def write_png(path: str, img: np.ndarray) -> None:
    """``img`` as a PNG at ``path``, through a temporary file and a rename,
    so a build that is killed leaves no truncated file for a resume to skip."""
    from texocr_tpu_torch.serving.image_io import encode_png

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(encode_png(img))
    os.replace(tmp, path)


def _typeset_task(task) -> None:
    """Pool worker: renders one equation at its seed unless its file exists."""
    eq, path, seed = task
    if not os.path.exists(path):
        write_png(path, render_realistic_typeset(eq, np.random.default_rng(seed)))


def write_split(root: str, labels: Sequence[str],
                render_fn: Callable[[str, np.random.Generator], np.ndarray] = render,
                rng: Optional[np.random.Generator] = None,
                seeds: Optional[Sequence[int]] = None, pool=None) -> None:
    """``root/{labels.txt, ids.txt, images/eq_NNNNN.png}`` for ``labels``.
    With ``seeds``, each image is ``render_realistic_typeset`` at its seed, in
    ``pool`` (a ``multiprocessing`` pool); else ``render_fn(eq, rng)`` in this
    process. An image whose file exists is kept."""
    images = os.path.join(root, "images")
    os.makedirs(images, exist_ok=True)
    ids = image_ids(len(labels))
    paths = [os.path.join(images, name) for name in ids]
    if seeds is not None:
        tasks = list(zip(labels, paths, seeds))
        for i, _ in enumerate(pool.imap(_typeset_task, tasks, 64)):
            if (i + 1) % 5000 == 0:
                print(f"  typeset {i + 1}/{len(tasks)}")
    else:
        for eq, path in zip(labels, paths):
            if not os.path.exists(path):
                write_png(path, render_fn(eq, rng))
    with open(os.path.join(root, "labels.txt"), "w") as f:
        f.write("\n".join(labels) + "\n")
    with open(os.path.join(root, "ids.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")


def pickle_splits(out: str, splits: Sequence[str], dataset_size: int) -> dict:
    """``out/{split}/{split}set.pkl`` for each split, built by
    ``ImageDataset`` from the split's directory with at most
    ``dataset_size`` rows; prints each split's rows, label length, buckets
    and BPE lengths. Returns the datasets by split."""
    from texocr_tpu_torch.data.dataset import ImageDataset
    from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH

    datasets = {}
    for split in splits:
        ds = ImageDataset(os.path.join(out, split), DEFAULT_VOCAB_PATH, dataset_size=dataset_size)
        ds.save(os.path.join(out, split, f"{split}set.pkl"))
        lens = sorted(len(t) for t in ds.token_ids)
        med = lens[len(lens) // 2] if lens else 0
        print(f"{split}: pickled ({len(ds)} items, max_seq_len {ds.max_seq_len}, "
              f"{len(ds.sizes)} shape buckets, BPE len p50={med} "
              f"max={lens[-1] if lens else 0})")
        if split == "train":
            shapes = Counter({(h, w): len(idxs) for (w, h), idxs in ds.sizes.items()})
            print(f"  bucket sizes (h, w): {dict(shapes)}")
        datasets[split] = ds
    return datasets


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=str, default="data_demo")
    p.add_argument("--n", type=int, default=2000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--simple", action="store_true",
                   help="short flat equations (easier image grounding demo)")
    p.add_argument("--realistic", action="store_true",
                   help="long labels (100-300 BPE tokens) on buckets up to the (160, 1008) "
                        "canvas")
    p.add_argument("--entropic", action="store_true",
                   help="realistic lengths, canvases and wrapping with flat atoms drawn near "
                        "uniformly, so the loss can fall only by reading glyphs")
    p.add_argument("--typeset", action="store_true",
                   help="typeset with matplotlib's mathtext (fraction bars, radicals, "
                        "kerning, invisible grouping braces) instead of PIL's bitmap font")
    p.add_argument("--processes", type=int, default=None,
                   help="render pool size for --typeset (default: all CPUs)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    check_renderer(args.typeset)
    rng = np.random.default_rng(args.seed)
    splits = split_equations(demo_equations(rng, args.n, args.simple, args.realistic,
                                            args.entropic))
    seeds = typeset_seeds(rng, splits) if args.typeset else {}
    render_fn = render_realistic if (args.realistic or args.entropic) else render
    # One pool of spawned workers renders every split's typeset images.
    ctx = multiprocessing.get_context("spawn")
    pool = (ctx.Pool(args.processes or multiprocessing.cpu_count()) if args.typeset
            else contextlib.nullcontext())
    with pool as workers:
        for split, labels in splits.items():
            write_split(os.path.join(args.out, split), labels, render_fn, rng, seeds.get(split),
                        workers)
            print(f"{split}: {len(labels)} rendered")
    pickle_splits(args.out, splits, args.n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
