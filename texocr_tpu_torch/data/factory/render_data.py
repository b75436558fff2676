"""Render LaTeX equations to PNGs (latex/dvipng/ImageMagick, or mathtext).

    python -m texocr_tpu_torch.data.factory.render_data data/train -c config/data_config.yml [--renderer auto|latex|mathtext]

As the JAX package's factory: each equation becomes a standalone
``$\\displaystyle eq$`` document, compiled by ``latex``, rasterised by
``dvipng`` at a random dpi in [100, 150] drawn per task from
``random.Random(task index)`` (the config's dpi is unused, as in the
reference), then centre-padded by ImageMagick ``convert`` to a canvas whose
height is a multiple of ``patch_size`` and width a multiple of
``4 * patch_size``. Failures go to ``failed.txt`` and ``prune_equations``
drops them from the labels and ids.

The ``mathtext`` backend typesets with matplotlib (imported only there) and
no external binary: the same dpi draw, a tight crop and the same centred
padding, done with numpy and written by ``serving.image_io.encode_png``, so
its pixels equal the JAX backend's PIL output. An equation outside
mathtext's TeX subset takes the failure path. ``--renderer auto`` uses latex
where its binaries exist, else mathtext.

The tasks run in a pool of spawned processes (``num_processes``, else one per
CPU), so a parent holding threads or a CUDA context forks nothing.
"""

from __future__ import annotations

import argparse
import functools
import io
import multiprocessing
import random
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from texocr_tpu_torch.config import load_config
from texocr_tpu_torch.serving.image_io import decode_png, encode_png, png_size

REQUIRED_BINARIES = ("latex", "dvipng", "convert")

TEX_TEMPLATE = """
    \\documentclass[preview,border=1mm]{{standalone}}
    \\usepackage{{amsmath}}
    \\usepackage{{amsfonts}}
    \\usepackage{{amssymb}}
    \\usepackage[total={{16in, 8in}}]{{geometry}}
    \\begin{{document}}
    $\\displaystyle {equation}$
    \\end{{document}}
    """


def check_binaries() -> Optional[str]:
    """None when latex, dvipng and convert are on PATH, else a message
    naming the missing ones."""
    missing = [b for b in REQUIRED_BINARIES if shutil.which(b) is None]
    if missing:
        return (
            f"missing external renderers: {', '.join(missing)} — install "
            "texlive (latex, dvipng) and ImageMagick (convert) to run the "
            "data factory."
        )
    return None


def _png_size(path: Path) -> Tuple[int, int]:
    """(w, h) from the PNG's header."""
    with open(path, "rb") as f:
        head = f.read(24)
    try:
        return png_size(head)
    except ValueError:
        raise ValueError(f"not a PNG: {path}") from None


def _pad_extents(w: int, h: int, patch_size: int) -> Tuple[int, int]:
    """The canvas ``convert -extent`` pads to: height up to a multiple of
    ``patch_size``, width up to a multiple of ``4 * patch_size``."""
    new_h = h + (patch_size - h % patch_size) % patch_size
    w_interval = 4 * patch_size
    new_w = w + (w_interval - w % w_interval) % w_interval
    return new_w, new_h


# TeX ignores whitespace between math tokens, so latex renders the label
# `2 ^ { b }` as `2^{b}`. mathtext does not: after a digit it parses
# `2 ^ { b }` as the number 2 and a bare group, dropping the script, so sub-
# and superscripts of digits would render alike. compact_latex removes the
# spaces TeX ignores, keeping one after an alphabetic \command before a
# letter (`\sin x`, not `\sinx`).
_CMD_SPACE = re.compile(r"(\\[A-Za-z]+)\s+(?=[A-Za-z])")


def compact_latex(equation: str) -> str:
    """Inter-token whitespace removed as TeX ignores it, except the one space
    between an alphabetic ``\\command`` and a following letter."""
    eq = _CMD_SPACE.sub("\\1\x00", equation)
    eq = re.sub(r"\s+", "", eq)
    return eq.replace("\x00", " ")


_MATHTEXT_CACHES_INSTALLED = False


def _install_shared_mathtext_caches() -> None:
    """Shares matplotlib's glyph-metric caches across renders (speed only).

    matplotlib builds a new ``Fonts`` object for every ``math_to_image``
    call, and its metric caches live on that instance, so every render
    recomputes every glyph's metrics. The values cached here are pure
    functions of (fontset class, default font file, load flags, arguments),
    and the fonts behind them are already shared process-wide, so sharing
    them leaves the pixels unchanged. Only glyph-free float results are
    shared: a ``FontInfo`` holds a live glyph slot that a later draw
    invalidates. On any mismatch with the installed matplotlib the stock
    path stays.
    """
    global _MATHTEXT_CACHES_INSTALLED
    if _MATHTEXT_CACHES_INSTALLED:
        return
    _MATHTEXT_CACHES_INSTALLED = True
    try:
        import matplotlib as mpl
        from matplotlib import _mathtext as _mt

        metrics_cache: dict = {}
        xheight_cache: dict = {}
        sized_cache: dict = {}

        tt = _mt.TruetypeFonts
        raw_get_xheight = tt.get_xheight
        raw_get_metrics = tt.get_metrics

        def _fontset_key(self):
            default = self._fonts.get("default")
            fname = getattr(default, "fname", None)
            return (type(self).__qualname__, fname, self.load_glyph_flags)

        @functools.wraps(raw_get_metrics)
        def shared_get_metrics(self, font, font_class, sym, fontsize, dpi):
            key = (_fontset_key(self), font, font_class, sym, fontsize, dpi)
            hit = metrics_cache.get(key)
            if hit is None:
                hit = metrics_cache[key] = raw_get_metrics(
                    self, font, font_class, sym, fontsize, dpi)
            return hit

        @functools.wraps(raw_get_xheight)
        def shared_get_xheight(self, fontname, fontsize, dpi):
            key = (_fontset_key(self), fontname, fontsize, dpi,
                   mpl.rcParams["mathtext.default"])
            hit = xheight_cache.get(key)
            if hit is None:
                hit = xheight_cache[key] = raw_get_xheight(self, fontname, fontsize, dpi)
            return hit

        # functools.cache on this method keys on ``self``, a new instance per
        # render: re-key it on the class (it reads only class-fixed fonts).
        raw_sized = _mt.StixFonts.get_sized_alternatives_for_symbol.__wrapped__

        @functools.wraps(raw_sized)
        def shared_sized(self, fontname, sym):
            key = (type(self).__qualname__, fontname, sym)
            hit = sized_cache.get(key)
            if hit is None:
                hit = sized_cache[key] = raw_sized(self, fontname, sym)
            return hit

        tt.get_metrics = shared_get_metrics
        tt.get_xheight = shared_get_xheight
        _mt.StixFonts.get_sized_alternatives_for_symbol = shared_sized
    except (ImportError, AttributeError):  # another matplotlib: the stock path
        pass


def mathtext_png(equation: str, dpi: int) -> np.ndarray:
    """One equation typeset by matplotlib's mathtext -> a tight-cropped
    (H, W) uint8 grey array (dvipng's ``-T tight``; no padding). Raises on
    TeX outside the mathtext subset."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    from matplotlib import mathtext

    _install_shared_mathtext_caches()
    buf = io.BytesIO()
    mathtext.math_to_image(f"${compact_latex(equation)}$", buf, dpi=dpi, format="png")
    arr = decode_png(buf.getvalue())
    # Crop the margin math_to_image leaves, so the pad rule sees the ink.
    ink = np.argwhere(arr < 250)
    if ink.size:
        (y0, x0), (y1, x1) = ink.min(0), ink.max(0) + 1
        arr = arr[y0:y1, x0:x1]
    return arr


def render_one_mathtext(task) -> None:
    """The mathtext backend for one task: typeset at the task's random dpi,
    centre-pad onto a white canvas of the pad rule, write the PNG. A parse
    error takes the failure path, as a latex compile error does."""
    equation, data_dir, image_id, patch_size, failed, seed = task
    equation = equation.strip()
    if not equation:
        return

    image_dir = Path(data_dir) / "images"
    image_dir.mkdir(parents=True, exist_ok=True)
    base = image_id[:-4]
    png = image_dir / f"{base}.png"
    try:
        # A generator per task: workers would otherwise share one sequence.
        img = mathtext_png(equation, random.Random(seed).randint(100, 150))
        h, w = img.shape
        new_w, new_h = _pad_extents(w, h, patch_size)
        canvas = np.full((new_h, new_w), 255, np.uint8)
        top, left = (new_h - h) // 2, (new_w - w) // 2
        canvas[top: top + h, left: left + w] = img
        png.write_bytes(encode_png(canvas))
    except Exception:  # mathtext raises many kinds on TeX it cannot parse
        failed.append((base, equation))
        png.unlink(missing_ok=True)


def render_one(task) -> None:
    """The latex chain for one task: latex, dvipng at the task's random dpi,
    convert to the pad rule's canvas."""
    equation, data_dir, image_id, patch_size, failed, seed = task
    equation = equation.strip()
    if not equation:
        return

    image_dir = Path(data_dir) / "images"
    image_dir.mkdir(parents=True, exist_ok=True)
    base = image_id[:-4]
    paths = {ext: image_dir / f"{base}.{ext}" for ext in ("tex", "dvi", "png", "log", "aux")}

    paths["tex"].write_text(TEX_TEMPLATE.format(equation=equation), encoding="utf-8")
    try:
        subprocess.run(
            ["latex", "-interaction=nonstopmode", "-output-directory",
             str(image_dir), str(paths["tex"])],
            check=True, capture_output=True,
        )
        dpi = random.Random(seed).randint(100, 150)
        subprocess.run(
            ["dvipng", "-D", str(dpi), "-T", "tight", "-o", str(paths["png"]),
             str(paths["dvi"])],
            check=True, capture_output=True,
        )
    except subprocess.CalledProcessError:
        failed.append((base, equation))
    finally:
        for ext in ("tex", "dvi", "log", "aux"):
            paths[ext].unlink(missing_ok=True)

    if paths["png"].exists():
        new_w, new_h = _pad_extents(*_png_size(paths["png"]), patch_size)
        subprocess.run(
            ["convert", str(paths["png"]), "-gravity", "center",
             "-extent", f"{new_w}x{new_h}", str(paths["png"])],
            check=True, capture_output=True,
        )


def render_images(data_dir: str, num_processes: Optional[int] = None,
                  patch_size: int = 16, renderer: str = "latex") -> None:
    """Renders ``data_dir/labels.txt`` into ``data_dir/images/<id>``, the
    failures into ``data_dir/failed.txt``."""
    root = Path(data_dir)
    equations = [line for line in (root / "labels.txt").read_text().splitlines() if line.strip()]
    ids = [line for line in (root / "ids.txt").read_text().splitlines() if line.strip()]
    render_fn = render_one_mathtext if renderer == "mathtext" else render_one

    ctx = multiprocessing.get_context("spawn")
    with ctx.Manager() as manager:
        failed = manager.list()
        tasks = [(eq, data_dir, ids[i], patch_size, failed, i) for i, eq in enumerate(equations)]
        with ctx.Pool(processes=num_processes or multiprocessing.cpu_count()) as pool:
            for i, _ in enumerate(pool.imap(render_fn, tasks)):
                if (i + 1) % 500 == 0:
                    print(f"rendered {i + 1}/{len(tasks)}")
        print(f"Rendered {len(tasks)} equations, {len(failed)} failures.")
        if failed:
            with open(root / "failed.txt", "w", encoding="utf-8") as f:
                for base, eq in failed:
                    f.write(f"{base}: {eq}\n")


def prune_equations(data_dir: str) -> None:
    """Drops the failed renders from labels and ids into
    ``labels_pruned.txt`` and ``ids_pruned.txt``, which the dataset prefers."""
    root = Path(data_dir)
    failed_file = root / "failed.txt"
    if not failed_file.exists():
        return
    failed_ids = {line.split(":")[0] + ".png" for line in failed_file.read_text().splitlines()}
    ids = root.joinpath("ids.txt").read_text().splitlines()
    labels = root.joinpath("labels.txt").read_text().splitlines()
    kept = [(i, label) for i, label in zip(ids, labels) if i not in failed_ids]
    (root / "ids_pruned.txt").write_text("\n".join(i for i, _ in kept))
    (root / "labels_pruned.txt").write_text("\n".join(label for _, label in kept))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Render LaTeX equations to images.")
    p.add_argument("data_dir", type=str)
    p.add_argument("-c", "--config", type=str, default="config/data_config.yml")
    p.add_argument("--renderer", choices=["auto", "latex", "mathtext"], default="auto",
                   help="latex = the reference's subprocess chain; mathtext = matplotlib's "
                        "TeX subset, no binaries needed; auto = latex when installed, else "
                        "mathtext")
    args = p.parse_args(argv)

    renderer = args.renderer
    if renderer == "auto":
        renderer = "mathtext" if check_binaries() else "latex"
        print(f"renderer: {renderer} (auto-detected)")
    elif renderer == "latex":
        err = check_binaries()
        if err:
            print(err, file=sys.stderr)
            sys.exit(2)

    config = load_config(args.config)
    render_images(args.data_dir, num_processes=config.get("num_processes"),
                  patch_size=config.get("patch_size", 16), renderer=renderer)
    prune_equations(args.data_dir)


if __name__ == "__main__":
    main()
