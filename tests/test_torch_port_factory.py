"""The port's data factory and directory datasets against the JAX package's,
which runs here: split_data's files, the latex chain (stub latex, dvipng and
convert on PATH), the mathtext backend's pixels, prune_equations,
pickle_data, ImageDataset(root_dir=...) eager and lazy with pickles loaded
across the packages, and decode_png at every PNG bit depth against PIL."""

import io
import json
import os
import random
import shutil
import stat
import struct
import textwrap
import zlib

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from tests.tiny import synthetic_dataset_dir
from texocr_tpu.data.dataset import ImageDataset as JaxImageDataset
from texocr_tpu.data.factory import render_data as jax_render
from texocr_tpu.data.factory import split_data as jax_split
from texocr_tpu_torch.data.dataset import ImageDataset
from texocr_tpu_torch.data.factory import pickle_data, render_data, split_data
from texocr_tpu_torch.serving.image_io import (
    PNG_SIGNATURE,
    UnsupportedPNG,
    decode_image,
    decode_png,
    png_size,
)
from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH

torch.set_num_threads(1)


# -- split ------------------------------------------------------------------------

def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("n_lines, cap, seed, splits", [
    (100, 100, 1, (0.8, 0.15, 0.05)),
    (50, 20, 7, (0.8, 0.15, 0.05)),
    (1234, 400, 0, (0.64, 0.04, 0.32)),
])
def test_split_data_files_equal_jax(tmp_path, n_lines, cap, seed, splits):
    master = tmp_path / "master.txt"
    master.write_text("\n".join(f"x ^ {{ {i} }} + \\alpha" for i in range(n_lines)) + "\n")
    split_data.split_data(str(master), splits, str(tmp_path / "port"), cap, seed=seed,
                          verbose=False)
    jax_split.split_data(str(master), splits, str(tmp_path / "jax"), cap, seed=seed,
                         verbose=False)
    port, jax = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert port == jax and len(port) == 6


def test_split_cli_reads_a_json_config_as_jax_reads_the_yaml(tmp_path, monkeypatch):
    master = tmp_path / "master.txt"
    master.write_text("\n".join(f"eq {i}" for i in range(60)) + "\n")
    config = {"num_equations": 40, "seed": 3, "splits": {"train": 0.5, "test": 0.25, "val": 0.25}}
    (tmp_path / "data.json").write_text(json.dumps(config))
    (tmp_path / "data.yml").write_text(yaml.safe_dump(config, sort_keys=False))
    split_data.main([str(master), str(tmp_path / "port"), "-c", str(tmp_path / "data.json")])
    monkeypatch.setattr("sys.argv", ["split", str(master), str(tmp_path / "jax"), "-c",
                                     str(tmp_path / "data.yml")])
    jax_split.main()
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


# -- render -------------------------------------------------------------------------

_PNG_HELPERS = r'''
import pathlib, struct, sys, zlib

def chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

def write_grey(path, rows):  # rows: list of bytes objects, one per row
    w, h = len(rows[0]), len(rows)
    raw = b"".join(b"\x00" + r for r in rows)
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))

def read_grey(path):  # only what write_grey writes
    data = path.read_bytes()
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 33, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos: pos + 8])
        if kind == b"IDAT":
            idat += data[pos + 8: pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    return [raw[y * (w + 1) + 1: (y + 1) * (w + 1)] for y in range(h)]
'''


def _write_stub(path, body):
    path.write_text("#!/usr/bin/env python3\n" + _PNG_HELPERS + textwrap.dedent(body))
    path.chmod(path.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)


def install_render_stubs(bin_dir):
    """latex, dvipng and convert with the call shapes render_one drives,
    written with the standard library only: latex fails on FAILME, dvipng
    writes a black grey PNG whose width follows the equation, convert
    centre-pads it with white to -extent."""
    bin_dir.mkdir(exist_ok=True)
    _write_stub(bin_dir / "latex", r"""
        tex = pathlib.Path(sys.argv[-1])
        out_dir = pathlib.Path(sys.argv[sys.argv.index("-output-directory") + 1])
        src = tex.read_text()
        if "FAILME" in src:
            sys.exit(1)
        (out_dir / (tex.stem + ".dvi")).write_text(src)
    """)
    _write_stub(bin_dir / "dvipng", r"""
        out = pathlib.Path(sys.argv[sys.argv.index("-o") + 1])
        dpi = int(sys.argv[sys.argv.index("-D") + 1])
        n = len(pathlib.Path(sys.argv[-1]).read_text())
        write_grey(out, [bytes([dpi]) + bytes(36 + n)] * 23)
    """)
    _write_stub(bin_dir / "convert", r"""
        src, out = pathlib.Path(sys.argv[1]), pathlib.Path(sys.argv[-1])
        w, h = map(int, sys.argv[sys.argv.index("-extent") + 1].split("x"))
        rows = read_grey(src)
        top, left = (h - len(rows)) // 2, (w - len(rows[0])) // 2
        blank = b"\xff" * w
        canvas = [blank] * top + [b"\xff" * left + r + b"\xff" * (w - left - len(r))
                                  for r in rows]
        write_grey(out, canvas + [blank] * (h - len(canvas)))
    """)


def _render_dir(root, eqs):
    root.mkdir()
    (root / "labels.txt").write_text("\n".join(eqs) + "\n")
    (root / "ids.txt").write_text("\n".join(f"eq_{i}.png" for i in range(1, len(eqs) + 1)) + "\n")
    return root


def test_latex_chain_with_stub_binaries_equals_jax(tmp_path, monkeypatch):
    install_render_stubs(tmp_path / "bin")
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    assert render_data.check_binaries() is None
    eqs = ["x + 1", "FAILME \\badmacro", "\\int_0^1 x^2 dx", "y FAILME", "\\frac{a}{b}"]
    for name, module in (("port", render_data), ("jax", jax_render)):
        root = _render_dir(tmp_path / name, eqs)
        module.render_images(str(root), num_processes=2, patch_size=16, renderer="latex")
        module.prune_equations(str(root))
    port, jax = tmp_path / "port", tmp_path / "jax"
    assert sorted((port / "failed.txt").read_text().splitlines()) == sorted(
        (jax / "failed.txt").read_text().splitlines()) == ["eq_2: FAILME \\badmacro",
                                                           "eq_4: y FAILME"]
    for name in ("ids_pruned.txt", "labels_pruned.txt"):
        assert (port / name).read_bytes() == (jax / name).read_bytes()
    assert (port / "ids_pruned.txt").read_text().splitlines() == ["eq_1.png", "eq_3.png",
                                                                  "eq_5.png"]
    images = {p.name: p.read_bytes() for p in (port / "images").iterdir()}
    assert images == {p.name: p.read_bytes() for p in (jax / "images").iterdir()}
    assert sorted(images) == ["eq_1.png", "eq_3.png", "eq_5.png"]  # no .tex/.dvi/.log left
    for name, data in images.items():
        w, h = png_size(data)
        assert h % 16 == 0 and w % 64 == 0, (name, w, h)
        # The stub dvipng's first column holds the dpi: the task's own draw.
        row = decode_png(data)[h // 2]
        dpi = random.Random(int(name[3:-4]) - 1).randint(100, 150)
        assert row[np.argmax(row < 255)] == dpi, name
    assert len(ImageDataset(str(port), DEFAULT_VOCAB_PATH, dataset_size=10)) == 3


def test_mathtext_pngs_equal_jax_pixels(tmp_path):
    eqs = [r"\int _ { 0 } ^ { 1 } x ^ { 2 } d x", r"\notarealcommandxyz { q }",
           r"\frac { a + b } { c }", r"2 ^ { b } + \sin x", r"\sqrt { y } \alpha _ { 1 }"]
    for name, module in (("port", render_data), ("jax", jax_render)):
        root = _render_dir(tmp_path / name, eqs)
        module.render_images(str(root), num_processes=2, patch_size=16, renderer="mathtext")
        module.prune_equations(str(root))
    port, jax = tmp_path / "port", tmp_path / "jax"
    assert (port / "failed.txt").read_bytes() == (jax / "failed.txt").read_bytes()
    assert (port / "ids_pruned.txt").read_bytes() == (jax / "ids_pruned.txt").read_bytes()
    names = sorted(p.name for p in (jax / "images").iterdir())
    assert names == sorted(p.name for p in (port / "images").iterdir()) == [
        "eq_1.png", "eq_3.png", "eq_4.png", "eq_5.png"]
    for name in names:
        with Image.open(jax / "images" / name) as im:
            want = np.asarray(im.convert("L"))
        got = decode_png((port / "images" / name).read_bytes())
        np.testing.assert_array_equal(got, want)
        assert (got < 128).any()


@pytest.mark.parametrize("dpi", [100, 125, 150])
def test_mathtext_png_equals_jax(dpi):
    eq = r"\sum _ { i = 1 } ^ { n } \frac { 1 } { i ^ { 2 } }"
    np.testing.assert_array_equal(render_data.mathtext_png(eq, dpi),
                                  np.asarray(jax_render.mathtext_png(eq, dpi)))
    assert render_data.compact_latex(eq) == jax_render.compact_latex(eq)


@pytest.mark.parametrize("failed", [None, "eq_2: b\neq_4: d\n"])
def test_prune_equations_equals_jax(tmp_path, failed):
    for name, module in (("port", render_data), ("jax", jax_render)):
        d = tmp_path / name
        d.mkdir()
        (d / "ids.txt").write_text("eq_1.png\neq_2.png\neq_3.png\neq_4.png")
        (d / "labels.txt").write_text("a\nb\nc\nd")
        if failed:
            (d / "failed.txt").write_text(failed)
        module.prune_equations(str(d))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert (tmp_path / "port" / "ids_pruned.txt").exists() == bool(failed)


@pytest.mark.parametrize("w, h, patch", [(37, 23, 16), (64, 16, 16), (129, 33, 8), (1, 1, 16)])
def test_pad_extents_equal_jax(w, h, patch):
    assert render_data._pad_extents(w, h, patch) == jax_render._pad_extents(w, h, patch)


# -- PNG bit depths -------------------------------------------------------------------

def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(samples, depth, colour, palette=None, interlace=0):
    """(H, W, C) samples -> PNG bytes at ``depth``, rows filtered None, Sub,
    Up, Average and Paeth in turn."""
    h, w, _ = samples.shape
    if depth == 16:
        raw = samples.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        raw = samples.astype(np.uint8).reshape(h, -1)
    else:  # packed, most significant bits first
        per = 8 // depth
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = samples[..., 0]
        padded = padded.reshape(h, -1, per)
        raw = np.zeros(padded.shape[:2], np.uint8)
        for i in range(per):
            raw |= (padded[..., i] << (8 - depth * (i + 1))).astype(np.uint8)
    bpp = max(1, depth * samples.shape[2] // 8)
    raw, prev, rows = raw.astype(np.int64), np.zeros(raw.shape[1], np.int64), []
    for y in range(h):
        x, kind = raw[y], y % 5
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [0, left, prev, (left + prev) // 2, _paeth(left, prev, upleft)][kind]
        rows.append(bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes())
        prev = x
    data = PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0,
                                                       interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return data + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b"")


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]  # every (colour type, depth) PNG allows


def random_png(rng, colour, depth, h, w):
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    if colour == 3:
        palette = rng.integers(0, 256, (1 << depth, 3))
        return write_png(rng.integers(0, 1 << depth, (h, w, 1)), depth, colour, palette)
    samples = rng.integers(0, 1 << depth, (h, w, channels))
    if depth == 16 and colour == 0:
        samples[0, :5, 0] = [0, 100, 255, 256, 300][:w]  # PIL clips 16-bit grey at 255
    return write_png(samples, depth, colour)


@pytest.mark.parametrize("colour, depth", PNG_KINDS)
@pytest.mark.parametrize("h, w", [(7, 13), (5, 1), (3, 64)])
def test_decode_png_equals_pil_at_every_depth(colour, depth, h, w):
    data = random_png(np.random.default_rng(colour * 100 + depth), colour, depth, h, w)
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("L"))
    got = decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (h, w)
    np.testing.assert_array_equal(got, want)
    assert png_size(data) == (w, h)


def test_interlaced_png_goes_to_pil():
    data = write_png(np.zeros((4, 4, 1), np.int64), 8, 0, interlace=1)
    with pytest.raises(UnsupportedPNG, match="interlace 1"):
        decode_png(data)
    with pytest.raises(UnsupportedPNG, match="bit depth 16, colour type 3"):
        decode_png(write_png(np.zeros((2, 2, 1), np.int64), 16, 3))
    img = Image.fromarray(np.arange(64, dtype=np.uint8).reshape(8, 8))
    buf = io.BytesIO()
    img.save(buf, format="PNG", interlace=1)
    np.testing.assert_array_equal(decode_image(buf.getvalue()), np.asarray(img))


# -- directory datasets -------------------------------------------------------------

def _mixed_png_dir(tmp_path):
    """A render directory holding PNGs of every kind, with a pruned list."""
    root = synthetic_dataset_dir(tmp_path, None, sizes=((64, 32), (128, 32)), per_size=3)
    rng = np.random.default_rng(1)
    names = (root / "ids.txt").read_text().splitlines()
    labels = (root / "labels.txt").read_text().splitlines()
    for i, (colour, depth) in enumerate(PNG_KINDS):
        name = f"kind_{i:02d}.png"
        h, w = ((32, 64), (48, 64), (32, 128))[i % 3]
        (root / "images" / name).write_bytes(random_png(rng, colour, depth, h, w))
        names.append(name)
        labels.append(f"x _ {{ {i} }} + \\frac {{ a }} {{ {depth} }}")
    (root / "ids.txt").write_text("\n".join(names) + "\n")
    (root / "labels.txt").write_text("\n".join(labels) + "\n")
    return root


def assert_same_dataset(port, jax):
    assert port.labels == jax.labels and port.image_ids == jax.image_ids
    assert port.token_ids == jax.token_ids
    assert dict(port.sizes) == dict(jax.sizes)
    assert (port.max_seq_len, port.max_height, port.max_width) == (
        jax.max_seq_len, jax.max_height, jax.max_width)
    assert len(port) == len(jax) > 0
    for i in range(len(jax)):
        got, want = port[i], jax[i]
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("dataset_size", [100, 5])
@pytest.mark.parametrize("pruned", [False, True])
def test_directory_dataset_equals_jax(tmp_path, lazy, dataset_size, pruned):
    root = _mixed_png_dir(tmp_path)
    if pruned:
        (root / "failed.txt").write_text("eq_0001: x\nkind_03: y\n")
        render_data.prune_equations(str(root))
    port = ImageDataset(str(root), DEFAULT_VOCAB_PATH, dataset_size=dataset_size, lazy=lazy)
    jax = JaxImageDataset(str(root), DEFAULT_VOCAB_PATH, dataset_size=dataset_size, lazy=lazy)
    assert_same_dataset(port, jax)
    assert port.lazy == lazy and (port.images[0] is None) == lazy
    assert len(port) == min(dataset_size, 6 + len(PNG_KINDS) - 2 * pruned)


@pytest.mark.parametrize("lazy", [False, True])
def test_directory_pickles_load_in_either_package(tmp_path, lazy):
    root = _mixed_png_dir(tmp_path)
    port = ImageDataset(str(root), DEFAULT_VOCAB_PATH, dataset_size=100, lazy=lazy)
    jax = JaxImageDataset(str(root), DEFAULT_VOCAB_PATH, dataset_size=100, lazy=lazy)
    port.save(str(tmp_path / "port.pkl"))
    jax.save(str(tmp_path / "jax.pkl"))
    assert_same_dataset(JaxImageDataset.load(str(tmp_path / "port.pkl")), jax)
    assert_same_dataset(ImageDataset.load(str(tmp_path / "jax.pkl")), jax)
    assert_same_dataset(ImageDataset.load(str(tmp_path / "port.pkl")), jax)
    sizes = {name: os.path.getsize(tmp_path / name) for name in ("port.pkl", "jax.pkl")}
    assert (sizes["port.pkl"] < 20_000) == lazy, sizes


@pytest.mark.parametrize("lazy", [False, True])
def test_pickle_data_cli_equals_the_jax_dataset(tmp_path, capsys, lazy):
    root = _mixed_png_dir(tmp_path)
    config = {"train_dir": str(root), "tokenizer_path": DEFAULT_VOCAB_PATH, "num_equations": 9}
    (tmp_path / "data.json").write_text(json.dumps(config))
    save = tmp_path / "trainset.pkl"
    argv = ["-c", str(tmp_path / "data.json"), "--split", "train", "-s", str(save)]
    pickle_data.main(pickle_data.parse_args(argv + ["--lazy"] * lazy))
    assert "Pickled 9-item train dataset" in capsys.readouterr().out
    jax = JaxImageDataset(str(root), DEFAULT_VOCAB_PATH, dataset_size=9, lazy=lazy)
    loaded = JaxImageDataset.load(str(save))
    assert loaded.lazy == lazy
    assert_same_dataset(loaded, jax)


def test_lazy_dataset_reads_moved_pixels_at_access(tmp_path):
    """A lazy dataset holds no pixels: it decodes the file at each access."""
    root = _mixed_png_dir(tmp_path)
    ds = ImageDataset(str(root), DEFAULT_VOCAB_PATH, dataset_size=3, lazy=True)
    first = ds[0][0].copy()
    shutil.copy(root / "images" / ds.image_ids[1], root / "images" / ds.image_ids[0])
    np.testing.assert_array_equal(ds[0][0], ds[1][0])
    assert not np.array_equal(first, ds[0][0])
