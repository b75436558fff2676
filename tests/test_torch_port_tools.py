"""The port's data tools against the JAX package's (tools/*.py) on the CPU:
make_demo_dataset's label stream, renders, split files and pickles;
pickle_partial_typeset's splits and pickles; the ambiguity scan's JSON,
and its pinned divergence where matplotlib cannot be imported. Every
comparison is exact (tolerance 0): the same strings, pixels and ids."""

import json
import multiprocessing
import os
import sys

import numpy as np
import pytest
import torch

from texocr_tpu_torch.data.dataset import ImageDataset as PortDataset
from texocr_tpu_torch.serving.image_io import decode_png, encode_png
from texocr_tpu_torch.tools import ambiguity_scan as port_scan
from texocr_tpu_torch.tools import make_demo_dataset as port_demo
from texocr_tpu_torch.tools import pickle_partial_typeset as port_partial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
sys.path.insert(0, TOOLS)

import ambiguity_scan as jax_scan  # noqa: E402
import make_demo_dataset as jax_demo  # noqa: E402
import pickle_partial_typeset as jax_partial  # noqa: E402
from PIL import Image  # noqa: E402

from texocr_tpu.data.dataset import ImageDataset as JaxDataset  # noqa: E402

torch.set_num_threads(1)

MODES = {"default": [], "simple": ["--simple"], "realistic": ["--realistic"],
         "entropic": ["--entropic"], "simple realistic": ["--simple", "--realistic"]}


class _Stop(Exception):
    pass


class _RecordingPool:
    """multiprocessing.Pool's stand-in for the JAX tool's main: records the
    typeset tasks (equation, path, seed) and renders nothing."""

    tasks = []

    def __init__(self, processes=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def imap(self, fn, tasks, chunksize=1):
        tasks = list(tasks)
        _RecordingPool.tasks += tasks
        return iter([None] * len(tasks))


class _SerialPool(_RecordingPool):
    """multiprocessing.Pool's stand-in that runs each task in this process."""

    def imap(self, fn, tasks, chunksize=1):
        return map(fn, tasks)


class _Unsaved:
    def save(self, path):
        pass


@pytest.fixture
def jax_main(monkeypatch):
    """Runs the JAX tool's main on argv up to its pickles, rendering nothing,
    and returns the labels by split and the typeset seeds by split. The
    global that main rebinds for --simple and --entropic is restored after
    the test."""
    import texocr_tpu.data.dataset as jax_dataset_module

    monkeypatch.setattr(jax_demo, "random_term", jax_demo.random_term)
    monkeypatch.setattr(jax_demo, "render", lambda eq, rng: _Unsaved())
    monkeypatch.setattr(jax_demo, "render_realistic", lambda eq, rng: _Unsaved())
    monkeypatch.setattr(multiprocessing, "Pool", _RecordingPool)

    def stop(*args, **kwargs):
        raise _Stop

    monkeypatch.setattr(jax_dataset_module, "ImageDataset", stop)

    def run(out, argv):
        _RecordingPool.tasks = []
        monkeypatch.setattr(sys, "argv", ["make_demo_dataset.py", "--out", str(out)] + argv)
        with pytest.raises(_Stop):
            jax_demo.main()
        labels = {s: (out / s / "labels.txt").read_text() for s in port_demo.SPLITS}
        seeds = {s: [seed for _, path, seed in _RecordingPool.tasks
                     if os.path.basename(os.path.dirname(os.path.dirname(path))) == s]
                 for s in port_demo.SPLITS}
        return labels, seeds

    return run


@pytest.mark.parametrize("typeset", [False, True], ids=["pil", "typeset"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n,seed", [(40, 0), (40, 42), (200, 0), (200, 42)])
def test_label_stream_equals_jax(jax_main, tmp_path, n, seed, mode, typeset):
    """The JAX tool's main (its global patch for --simple and --entropic
    included) and the port's equation, split and seed steps give the same
    labels string for string and, with --typeset, the same per-item seeds."""
    argv = ["--n", str(n), "--seed", str(seed)] + MODES[mode] + ["--typeset"] * typeset
    want_labels, want_seeds = jax_main(tmp_path, argv)

    args = port_demo.parse_args(argv)
    rng = np.random.default_rng(seed)
    splits = port_demo.split_equations(port_demo.demo_equations(
        rng, n, args.simple, args.realistic, args.entropic))
    seeds = port_demo.typeset_seeds(rng, splits) if typeset else {s: [] for s in splits}
    assert {s: "\n".join(labels) + "\n" for s, labels in splits.items()} == want_labels
    assert seeds == want_seeds
    assert sum(map(len, seeds.values())) == (n if typeset else 0)


def test_flat_terms_skip_the_nesting_draw():
    """A flat term is one atom drawn without random_term's first draw, as
    the JAX tool's rebound global draws it."""
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    assert port_demo.random_term(a, flat=True) == jax_demo.random_atom(b)
    assert a.random() == b.random()


def test_pil_renders_equal_jax():
    """render and render_realistic decode to the JAX tool's PIL pixels, on
    equations of every grammar (wrapped and downscaled ones among them)."""
    rng = np.random.default_rng(11)
    eqs = (port_demo.demo_equations(rng, 12) + port_demo.demo_equations(rng, 12, simple=True)
           + port_demo.demo_equations(rng, 12, realistic=True)
           + port_demo.demo_equations(rng, 6, entropic=True))
    for eq in eqs:
        for port_fn, jax_fn in ((port_demo.render, jax_demo.render),
                                (port_demo.render_realistic, jax_demo.render_realistic)):
            got = port_fn(eq, None)
            want = np.asarray(jax_fn(eq, None))
            assert got.dtype == np.uint8 and got.shape == want.shape, eq
            assert np.array_equal(got, want), eq


def test_typeset_render_equals_jax():
    """render_realistic_typeset at the same per-item seed gives the JAX
    tool's pixels: one line, several wrapped lines, and an assembly taller
    than the largest canvas (downscaled with PIL's bilinear filter)."""
    from texocr_tpu_torch.data.factory.render_data import mathtext_png

    eqs = sorted(port_demo.demo_equations(np.random.default_rng(5), 40, realistic=True), key=len)
    cases = {"one line": (eqs[0], 1), "wrapped": (eqs[20], 2),
             "oversized": (" + ".join(eqs[-3:]), 3)}
    for name, (eq, seed) in cases.items():
        dpi = int(np.random.default_rng(seed).integers(100, 151))
        lines = port_demo.wrap_top_level(eq, int(88 * 125 / dpi))
        assert lines == jax_demo._wrap_top_level(eq, int(88 * 125 / dpi))
        got = port_demo.render_realistic_typeset(eq, np.random.default_rng(seed))
        want = np.asarray(jax_demo.render_realistic_typeset(eq, np.random.default_rng(seed)))
        assert np.array_equal(got, want), name
        assert (len(lines) == 1) == (name == "one line"), (name, len(lines))
        if name == "oversized":
            height = sum(mathtext_png(line, dpi).shape[0] for line in lines)
            assert height > 160 and got.shape == (160, 1008)


def _pixels(path):
    return np.asarray(Image.open(path).convert("L"))


@pytest.mark.parametrize("argv", [["--n", "40", "--seed", "3"],
                                  ["--n", "40", "--seed", "3", "--typeset"]],
                         ids=["pil", "typeset"])
def test_whole_build_equals_jax(tmp_path, monkeypatch, argv):
    """A whole build by each tool's main (the JAX tool's typeset workers run
    in this process): equal labels.txt and ids.txt, PNGs of the same pixels,
    pickles that load in either package with equal token_ids, sizes and
    images; a second run after deleting one PNG renders only that one."""
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(jax_demo, "random_term", jax_demo.random_term)
    monkeypatch.setattr(multiprocessing, "Pool", _SerialPool)
    monkeypatch.setattr(sys, "argv", ["make_demo_dataset.py", "--out", str(jax_out)] + argv)
    jax_demo.main()
    monkeypatch.undo()
    assert port_demo.main(["--out", str(port_out), "--processes", "2"] + argv) == 0

    for split in port_demo.SPLITS:
        for name in ("labels.txt", "ids.txt"):
            assert (port_out / split / name).read_bytes() == (jax_out / split / name).read_bytes()
        ids = (port_out / split / "ids.txt").read_text().split()
        for image_id in ids:
            got = decode_png((port_out / split / "images" / image_id).read_bytes())
            assert np.array_equal(got, _pixels(jax_out / split / "images" / image_id)), image_id
        port_pkl, jax_pkl = (str(out / split / f"{split}set.pkl") for out in (port_out, jax_out))
        for got, want in ((JaxDataset.load(port_pkl), JaxDataset.load(jax_pkl)),
                          (PortDataset.load(jax_pkl), PortDataset.load(port_pkl))):
            assert got.token_ids == want.token_ids and dict(got.sizes) == dict(want.sizes)
            assert got.labels == want.labels and got.max_seq_len == want.max_seq_len
            assert all(np.array_equal(a, b) for a, b in zip(got.images, want.images))

    images = port_out / "train" / "images"
    before = {p.name: p.stat().st_mtime_ns for p in images.iterdir()}
    pixels = decode_png((images / "eq_00007.png").read_bytes())
    (images / "eq_00007.png").unlink()
    assert port_demo.main(["--out", str(port_out), "--processes", "2"] + argv) == 0
    after = {p.name: p.stat().st_mtime_ns for p in images.iterdir()}
    assert sorted(after) == sorted(before)
    assert [k for k in before if after[k] != before[k]] == ["eq_00007.png"]
    assert np.array_equal(decode_png((images / "eq_00007.png").read_bytes()), pixels)
    assert not any(p.name.endswith(".tmp") for p in images.iterdir())


def test_missing_renderer_raises_before_writing(tmp_path, monkeypatch):
    """Without PIL the renders and main raise ImportError naming it, and main
    writes nothing; with --typeset and no matplotlib, main names matplotlib."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        port_demo.render("x + y", None)
    with pytest.raises(ImportError, match="PIL"):
        port_demo.main(["--out", str(tmp_path / "a"), "--n", "8"])
    assert not (tmp_path / "a").exists()
    monkeypatch.delitem(sys.modules, "PIL")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        port_demo.main(["--out", str(tmp_path / "b"), "--n", "8", "--typeset"])
    assert not (tmp_path / "b").exists()


def _realistic_build(root, n, seed, rendered):
    """A --realistic build's train split with only its first ``rendered``
    images present (a torn tail); the images are ink on canvases of two
    sizes."""
    rng = np.random.default_rng(seed)
    eqs = port_demo.split_equations(port_demo.demo_equations(
        np.random.default_rng(seed), n, realistic=True))
    images = root / "train" / "images"
    images.mkdir(parents=True)
    for i in range(rendered):
        img = np.where(rng.random((32, 320 if i % 3 else 640)) < 0.05, 0, 255).astype(np.uint8)
        (images / f"eq_{i:05d}.png").write_bytes(encode_png(img))
    return eqs


def test_pickle_partial_typeset_equals_jax(tmp_path, monkeypatch):
    """The two tools on a build with a torn train tail: the same take, split
    files and pickles; both stop with SystemExit below 2 x holdout rows."""
    src = tmp_path / "src"
    eqs = _realistic_build(src, 100, 23, 50)
    common = ["--src", str(src), "--n", "100", "--seed", "23", "--holdout", "10"]
    monkeypatch.setattr(sys, "argv", ["pickle_partial_typeset.py", "--out",
                                      str(tmp_path / "jax")] + common)
    assert jax_partial.main() == 0
    assert port_partial.main(["--out", str(tmp_path / "port")] + common) == 0

    rows = 0
    for split in ("train", "val", "test"):
        jax_dir, port_dir = tmp_path / "jax" / split, tmp_path / "port" / split
        for name in ("labels.txt", "ids.txt"):
            assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes()
        assert os.path.samefile(port_dir / "images", src / "train" / "images")
        got = PortDataset.load(str(port_dir / f"{split}set.pkl"))
        want = JaxDataset.load(str(jax_dir / f"{split}set.pkl"))
        assert got.token_ids == want.token_ids and dict(got.sizes) == dict(want.sizes)
        assert all(np.array_equal(a, b) for a, b in zip(got.images, want.images))
        assert got.labels == eqs["train"][rows: rows + len(got)]
        rows += len(got)
    assert rows == 50

    short = common[:-1] + ["30"]
    monkeypatch.setattr(sys, "argv", ["pickle_partial_typeset.py", "--out",
                                      str(tmp_path / "jax2")] + short)
    with pytest.raises(SystemExit, match="only 50 rendered rows; need >= 60"):
        jax_partial.main()
    with pytest.raises(SystemExit, match="only 50 rendered rows; need >= 60"):
        port_partial.main(["--out", str(tmp_path / "port2")] + short)


@pytest.fixture(scope="module")
def scan_labels(tmp_path_factory):
    """About 30 labels: short demo equations, a repeated one, and labels with
    a digit-base script beside their flipped twins (raw mathtext renders
    some pairs alike)."""
    eqs = port_demo.demo_equations(np.random.default_rng(7), 22)
    scripted = [eq for eq in port_demo.demo_equations(np.random.default_rng(9), 200)
                if port_scan.flip_one_digit_script(eq.split(" "))][:4]
    twins = [" ".join(port_scan.flip_one_digit_script(eq.split(" "))) for eq in scripted]
    path = tmp_path_factory.mktemp("scan") / "labels.txt"
    path.write_text("\n".join(eqs + [eqs[0]] + scripted + twins) + "\n")
    return path


@pytest.mark.parametrize("extra", [[], ["--raw"], ["--fliptest"]],
                         ids=["compacted", "raw", "fliptest"])
def test_ambiguity_scan_prints_jaxs_json(scan_labels, extra, monkeypatch, capsys):
    argv = ["--labels", str(scan_labels)] + extra
    monkeypatch.setattr(sys, "argv", ["ambiguity_scan.py"] + argv)
    assert jax_scan.main() == 0
    want = capsys.readouterr().out
    assert port_scan.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    result = json.loads(got.splitlines()[-1])
    assert result["failed"] == 0
    if extra == ["--raw"]:
        assert result["ambiguous_groups"] >= 1  # a digit-base script and its flip
    if extra == ["--fliptest"]:
        assert result["fliptest_labels"] >= 8 and result["flip_renders_identical"] == 0


def test_ambiguity_scan_without_matplotlib_is_the_pinned_divergence(
        scan_labels, monkeypatch, capsys):
    """With matplotlib unimportable the JAX tool counts every label as
    failed and reports a ceiling from no render; the port raises
    ImportError naming matplotlib."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.mathtext", None)
    monkeypatch.setattr(sys, "argv", ["ambiguity_scan.py", "--labels", str(scan_labels)])
    assert jax_scan.main() == 0
    jax_result = json.loads(capsys.readouterr().out.splitlines()[-1])
    n = len(scan_labels.read_text().split("\n")) - 1
    assert jax_result["failed"] == jax_result["labels"] == n and jax_result["rendered"] == 0
    with pytest.raises(ImportError, match="matplotlib"):
        port_scan.main(["--labels", str(scan_labels)])


def test_ambiguity_scan_counts_parse_errors_as_failed(tmp_path, capsys):
    """A label mathtext cannot parse is a failed label in both tools."""
    path = tmp_path / "labels.txt"
    path.write_text("x + y\n\\frac { x\n")
    assert port_scan.main(["--labels", str(path)]) == 0
    result = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert result["failed"] == 1 and result["rendered"] == 1

