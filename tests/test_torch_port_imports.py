"""The PyTorch port stands alone: it imports nothing of JAX or texocr_tpu, and
its serving path (greedy, sample, beam, int8 caches, the HTTP server and the
serving CLI on PNG bytes), its evaluation CLI, its attention-maps tool, its
training path on a pickled dataset, its data path (tokenizer encode, train
and CLI, split, the latex render chain, prune, pickle, directory datasets
eager and lazy into training), chip_smoke.py and tools/flash_kernel_ab.py
need neither PIL, PyYAML nor regex, none of which a port module imports at
module level; nor does any port module import msgpack (the card's machine
has none: the port reads flax's msgpack with the standard library)."""

import os
import re
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "texocr_tpu_torch")

_BLOCKER = textwrap.dedent(
    """
    import importlib, importlib.util, pkgutil, sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "texocr_tpu",
               "PIL", "yaml", "regex", "msgpack"}

    class Blocker:
        # Compares the exact top-level name: texocr_tpu_torch starts with
        # texocr_tpu and must not be blocked.
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Blocker())
    """
)

_CHILD = _BLOCKER + textwrap.dedent(
    """
    import numpy as np
    import torch
    import texocr_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(texocr_tpu_torch.__path__,
                                                   "texocr_tpu_torch.")]
    # Every module, the compiled decode's and the attention-maps tool's included.
    assert "texocr_tpu_torch.models.graphed" in names, names
    assert "texocr_tpu_torch.tools.attention_maps" in names, names
    for name in names:
        importlib.import_module(name)
    for script in ("chip_smoke.py", "tools/flash_kernel_ab.py"):
        spec = importlib.util.spec_from_file_location(script[:-3].split("/")[-1], script)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)  # defines main() without running it
        assert callable(module.main)

    # The serving path on a uint8 array touches none of the blocked modules.
    from texocr_tpu_torch.serving import TexOCR
    from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH

    config = {
        "tokenizer_path": DEFAULT_VOCAB_PATH, "img_size": (32, 64), "patch_size": 16,
        "glu": True, "bos_token": 998, "eos_token": 997, "trg_pad_idx": 999,
        "dtype": "float32",
        "encoder": {"n_channels": 1, "embed_dim": 32, "num_layers": 1, "heads": 2,
                    "resnet_depths": (1, 1, 1), "resnet_channels": (128, 128, 128),
                    "stem_channels": 32},
        "decoder": {"embed_dim": 32, "num_layers": 1, "heads": 2, "exp_factor": 4},
    }
    ids, latex = TexOCR(config, device="cpu")(np.full((20, 40), 255, np.uint8), max_len=3)
    assert isinstance(latex, str)

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("imported", len(names), "modules")
    """
)


def test_port_and_chip_smoke_import_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[1])
    assert n_modules >= 15, proc.stdout


def test_no_jax_or_reference_imports_in_port_sources():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|texocr_tpu)(\.|\s|$)",
        re.MULTILINE,
    )
    offenders = []
    for root, _, files in os.walk(PORT_DIR):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    if pattern.search(f.read()):
                        offenders.append(os.path.relpath(path, REPO))
    for script in ("chip_smoke.py", "tools/flash_kernel_ab.py"):
        with open(os.path.join(REPO, script)) as f:
            if pattern.search(f.read()):
                offenders.append(script)
    assert not offenders, offenders


_TRAIN_CHILD = _BLOCKER + textwrap.dedent(
    """
    import os, tempfile
    import numpy as np
    import torch
    from texocr_tpu_torch.data.dataset import ImageDataset, load_datasets
    from texocr_tpu_torch.training.loop import train_model

    rng = np.random.default_rng(0)
    images = [np.where(rng.random((32, 64)) < 0.1, 0, 255).astype(np.uint8) for _ in range(4)]
    tokens = [list(rng.integers(0, 990, 5)) for _ in range(4)]
    tmp = tempfile.mkdtemp()
    for split in ("train", "val", "test"):
        os.makedirs(os.path.join(tmp, split))
        ImageDataset.from_arrays(images, tokens).save(os.path.join(tmp, split, split + "set.pkl"))
    train, val, _ = load_datasets(tmp)
    train.augment = True
    config = {
        "img_size": (32, 64), "patch_size": 16, "glu": True, "bos_token": 998,
        "eos_token": 997, "trg_pad_idx": 999, "dtype": "float32", "batch_size": 2,
        "n_epochs": 1, "optimizer": "Adam", "optimizer_args": {"lr": 1e-3},
        "save_dir": os.path.join(tmp, "ckpt"), "seq_pad_multiple": 8,
        "encoder": {"n_channels": 1, "embed_dim": 32, "num_layers": 1, "heads": 2,
                    "resnet_depths": (1, 1, 1), "resnet_channels": (128, 128, 128),
                    "stem_channels": 32},
        "decoder": {"embed_dim": 32, "num_layers": 1, "heads": 2, "exp_factor": 4,
                    "dropout": 0.1},
    }
    _, state, history = train_model(train, val, config, verbose=False, device="cpu")
    assert state.step == 2 and np.isfinite(history).all(), history

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("trained", state.step, "steps")
    """
)


_SERVE_CHILD = _BLOCKER + textwrap.dedent(
    """
    import json, os, struct, tempfile, urllib.request, zlib
    import numpy as np
    from texocr_tpu_torch.data.dataset import ImageDataset
    from texocr_tpu_torch.evaluation import cli as eval_cli
    from texocr_tpu_torch.serving import TexOCR, cli as serving_cli
    from texocr_tpu_torch.serving.batcher import ServingBatcher
    from texocr_tpu_torch.serving.http_server import make_server, serve_in_thread
    from texocr_tpu_torch.serving.image_io import decode_image
    from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH

    def png(arr):  # an 8-bit grey PNG, every row unfiltered
        def chunk(kind, body):
            return struct.pack(">I", len(body)) + kind + body + struct.pack(
                ">I", zlib.crc32(kind + body))
        h, w = arr.shape
        rows = b"".join(b"\\x00" + arr[y].tobytes() for y in range(h))
        return (b"\\x89PNG\\r\\n\\x1a\\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))

    tmp = tempfile.mkdtemp()
    config = {
        "tokenizer_path": DEFAULT_VOCAB_PATH, "img_size": [32, 64], "patch_size": 16,
        "glu": True, "bos_token": 998, "eos_token": 997, "trg_pad_idx": 999,
        "dtype": "float32", "kv_quant": "int8", "self_kv_quant": "int8", "batch_size": 2,
        "encoder": {"n_channels": 1, "embed_dim": 32, "num_layers": 1, "heads": 2,
                    "resnet_depths": [1, 1, 1], "resnet_channels": [128, 128, 128],
                    "stem_channels": 32},
        "decoder": {"embed_dim": 32, "num_layers": 1, "heads": 2, "exp_factor": 4},
    }
    cfg_path = os.path.join(tmp, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    rng = np.random.default_rng(0)
    arr = np.where(rng.random((20, 40)) < 0.1, 0, 255).astype(np.uint8)
    data = png(arr)
    assert (decode_image(data) == arr).all()

    engine = TexOCR(config, device="cpu")
    for mode in ("greedy", "sample", "beam"):
        ids, latex = engine(arr, max_len=3, mode=mode, beam_size=2)
        assert isinstance(latex, str), mode

    batcher = ServingBatcher(engine, max_batch=2, max_len=3)
    server = make_server(batcher, port=0)
    serve_in_thread(server)
    host, port = server.server_address[:2]
    req = urllib.request.Request(f"http://{host}:{port}/ocr", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        assert "latex" in json.loads(r.read())
    server.shutdown()
    batcher.shutdown()

    img_path = os.path.join(tmp, "eq.png")
    with open(img_path, "wb") as f:
        f.write(data)
    serving_cli.main([img_path, "--config", cfg_path, "--max_len", "3", "--device", "cpu"])

    os.makedirs(os.path.join(tmp, "test"))
    ImageDataset.from_arrays([arr, arr], [[5, 6], [7]]).save(
        os.path.join(tmp, "test", "testset.pkl"))
    out = eval_cli.main(eval_cli.parse_args(
        ["-d", tmp, "--config", cfg_path, "--max_len", "4", "--device", "cpu",
         "--decode", "beam", "--beam_size", "2"]))
    assert out["batches"] == 1, out

    from texocr_tpu_torch.serving.image_io import decode_png
    from texocr_tpu_torch.tools import attention_maps

    maps_dir = os.path.join(tmp, "maps")
    rc = attention_maps.main([img_path, "--config", cfg_path, "--out", maps_dir,
                              "--max_len", "4", "--device", "cpu"])
    assert rc == 0, rc
    with open(os.path.join(maps_dir, "token_000.png"), "rb") as f:
        assert decode_png(f.read()).shape == (32, 64)
    with open(os.path.join(maps_dir, "summary.json")) as f:
        assert sorted(json.load(f)) == ["grid", "latex", "per_token", "tokens"]

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("served and evaluated")
    """
)


def test_serving_and_evaluation_run_with_jax_pil_yaml_and_regex_blocked():
    """Every decode mode with int8 caches, an HTTP POST of PNG bytes, the
    serving CLI on a PNG file, the evaluation CLI and the attention-maps tool
    with a .json config on the CPU, with the blocked modules unimportable."""
    proc = subprocess.run(
        [sys.executable, "-c", _SERVE_CHILD], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "served and evaluated" in proc.stdout


def test_no_module_level_pil_yaml_or_regex_imports():
    """PIL, PyYAML and regex are imported inside the functions that need
    them, never at the top of a port module or chip_smoke.py."""
    pattern = re.compile(r"^(import|from)\s+(PIL|yaml|regex)(\.|\s|$)", re.MULTILINE)
    offenders = []
    for root, _, files in os.walk(PORT_DIR):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    if pattern.search(f.read()):
                        offenders.append(os.path.relpath(path, REPO))
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        if pattern.search(f.read()):
            offenders.append("chip_smoke.py")
    assert not offenders, offenders


def test_training_runs_with_jax_pil_yaml_and_regex_blocked():
    """A pickled dataset loads and trains one epoch (two steps, augmentation
    on) on the CPU with the blocked modules unimportable."""
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN_CHILD], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "trained 2 steps" in proc.stdout


_DATA_CHILD = _BLOCKER + textwrap.dedent(
    """
    import json, os, sys, tempfile
    import numpy as np
    import torch
    from texocr_tpu_torch.data.dataset import ImageDataset
    from texocr_tpu_torch.data.factory import pickle_data, render_data, split_data
    from texocr_tpu_torch.tokenizer import (DEFAULT_SPECIAL_TOKENS_PATH, DEFAULT_VOCAB_PATH,
                                            RegexBPETokenizer, cli, load_default_tokenizer, native)
    from texocr_tpu_torch.training.loop import train_model

    with open("tests/goldens/tokenizer_encode.json") as f:
        goldens = json.load(f)
    with open("tests/goldens/tokenizer_train.json") as f:
        golden_train = json.load(f)
    tok = load_default_tokenizer()
    texts = [c["text"] for c in goldens]
    assert [tok.encode(t) for t in texts] == [c["ids"] for c in goldens]
    assert tok.encode_batch(texts) == [c["ids"] for c in goldens]
    assert native.native_available() and native.NativeBPEEncoder.calls == 1
    corpus = "\\n".join(t for t in texts if t) * golden_train["corpus_repeats"]
    trained = RegexBPETokenizer(300, dict(golden_train["special_tokens"]))
    trained.train(corpus)
    assert trained.bp_merges == {tuple(k): v for k, v in golden_train["merges"]}

    tmp = tempfile.mkdtemp()
    with open(os.path.join(tmp, "corpus.txt"), "w") as f:
        f.write(corpus)
    cli.main(cli.parse_args(["-t", "-v", "300", "-d", os.path.join(tmp, "corpus.txt"),
                             "-s", os.path.join(tmp, "tok.txt"), "--special",
                             DEFAULT_SPECIAL_TOKENS_PATH]))
    assert RegexBPETokenizer().load(os.path.join(tmp, "tok.txt")).bp_merges == trained.bp_merges
    cli.main(cli.parse_args(["-l", DEFAULT_VOCAB_PATH, "-v", "1000", "--test_str", "x ^ 2"]))

    # Equations of one length render to one canvas (the stub dvipng's width
    # follows the document's length): one batch per split.
    eqs = [f"x + {i}" for i in range(10)] + ["FAILME"]
    with open(os.path.join(tmp, "master.txt"), "w") as f:
        f.write("\\n".join(eqs) + "\\n")
    data_dir = os.path.join(tmp, "data")
    config = {"num_equations": 11, "seed": 0, "num_processes": 2, "patch_size": 16,
              "splits": {"train": 0.55, "test": 0.0, "val": 0.45},
              "tokenizer_path": DEFAULT_VOCAB_PATH}
    for split in ("train", "val"):
        config[split + "_dir"] = os.path.join(data_dir, split)
    cfg_path = os.path.join(tmp, "data.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    split_data.main([os.path.join(tmp, "master.txt"), data_dir, "-c", cfg_path])
    for split in ("train", "val"):
        render_data.main([config[split + "_dir"], "-c", cfg_path, "--renderer", "latex"])
    pruned = [s for s in ("train", "val")
              if os.path.exists(os.path.join(data_dir, s, "labels_pruned.txt"))]
    assert len(pruned) == 1, pruned  # FAILME failed in one split and was pruned there

    sets = {}
    for lazy in (False, True):
        for split in ("train", "val"):
            path = os.path.join(tmp, f"{split}{lazy}.pkl")
            pickle_data.main(pickle_data.parse_args(["-c", cfg_path, "--split", split, "-s", path]
                                                    + ["--lazy"] * lazy))
            sets[split, lazy] = ImageDataset.load(path)
    train_eager, train_lazy = sets["train", False], sets["train", True]
    assert train_lazy.lazy and not train_eager.lazy
    assert len(train_eager.sizes) == len(sets["val", False].sizes) == 1
    for i in range(len(train_eager)):
        assert (train_eager[i][0] == train_lazy[i][0]).all()
    n_train = len(train_eager)
    h, w = train_eager.max_height, train_eager.max_width
    model_config = {
        "img_size": (h, w), "patch_size": 16, "glu": True, "bos_token": 998,
        "eos_token": 997, "trg_pad_idx": 999, "dtype": "float32", "batch_size": n_train,
        "n_epochs": 1, "optimizer": "Adam", "optimizer_args": {"lr": 1e-3},
        "save_checkpoint": False, "seq_pad_multiple": 8,
        "encoder": {"n_channels": 1, "embed_dim": 32, "num_layers": 1, "heads": 2,
                    "resnet_depths": (1, 1, 1), "resnet_channels": (128, 128, 128),
                    "stem_channels": 32},
        "decoder": {"embed_dim": 32, "num_layers": 1, "heads": 2, "exp_factor": 4},
    }
    for lazy in (False, True):
        _, state, history = train_model(sets["train", lazy], sets["val", lazy], model_config,
                                        verbose=False, device="cpu")
        assert state.step == 1 and np.isfinite(history).all(), history

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("data path ran on", n_train, "train rows at", (h, w))
    """
)


def test_data_path_runs_with_jax_pil_yaml_and_regex_blocked(tmp_path):
    """Tokenizer encode, train and CLI; split_data and render_data's CLIs
    with a .json config and stub latex, dvipng and convert on PATH;
    prune_equations; pickle_data eager and lazy; the directory datasets
    through one train_model step each on the CPU."""
    from tests.test_torch_port_factory import install_render_stubs

    install_render_stubs(tmp_path / "bin")
    env = dict(os.environ, PATH=f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    proc = subprocess.run(
        [sys.executable, "-c", _DATA_CHILD], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "data path ran on" in proc.stdout


_TOOLS_CHILD = _BLOCKER.replace('"msgpack"}', '"msgpack", "matplotlib"}') + textwrap.dedent(
    """
    import contextlib, io, json, os, tempfile
    import numpy as np
    import torch
    from texocr_tpu_torch.serving.image_io import encode_png
    from texocr_tpu_torch.tools import (ambiguity_scan, demo_train, make_demo_dataset,
                                        pickle_partial_typeset, train_curriculum)

    tmp = tempfile.mkdtemp()
    for call in (lambda: make_demo_dataset.render("x", None),
                 lambda: make_demo_dataset.main(["--out", os.path.join(tmp, "none"), "--n", "8"])):
        try:
            call()
            raise AssertionError("rendered without PIL")
        except ImportError as e:
            assert "PIL" in str(e), e
    assert not os.path.exists(os.path.join(tmp, "none"))

    # The tool's equation, split and pickle steps, with ink drawn here.
    build = os.path.join(tmp, "demo")
    rng = np.random.default_rng(0)
    splits = make_demo_dataset.split_equations(
        make_demo_dataset.demo_equations(np.random.default_rng(4), 40, realistic=True))
    for split, labels in splits.items():
        make_demo_dataset.write_split(
            os.path.join(build, split), labels,
            lambda eq, r: np.where(r.random((32, 320)) < 0.05, 0, 255).astype(np.uint8), rng)
    make_demo_dataset.pickle_splits(build, splits, 40)
    os.remove(os.path.join(build, "train", "images", "eq_00031.png"))
    pickle_partial_typeset.main(["--src", build, "--out", os.path.join(tmp, "partial"),
                                 "--n", "40", "--seed", "4", "--holdout", "4"])

    try:
        ambiguity_scan.main(["--labels", os.path.join(build, "test", "labels.txt")])
        raise AssertionError("scanned without matplotlib")
    except ImportError as e:
        assert "matplotlib" in str(e), e

    args = demo_train.parse_args(["--data", build, "--epochs", "1", "--batch_size", "4",
                                  "--save_dir", os.path.join(tmp, "ck"), "--eval_batches", "1",
                                  "--device", "cpu", "--device_data", "--remat"])
    config = dict(demo_train.build_config(args), img_size=(32, 320), dtype="float32",
                  encoder={"n_channels": 1, "embed_dim": 32, "num_layers": 1, "heads": 2,
                           "resnet_depths": (1, 1, 1), "resnet_channels": (128, 128, 128),
                           "stem_channels": 32},
                  decoder={"embed_dim": 32, "num_layers": 1, "heads": 2, "exp_factor": 4})
    final = demo_train.run(args, config)
    assert np.isfinite(final["history"]).all() and final["batches"] == 1, final

    with contextlib.redirect_stdout(io.StringIO()) as out:
        train_curriculum.main(["--dry_run", "--base_dir", tmp, "--stages", "A-W"])
    assert out.getvalue().count("-m texocr_tpu_torch.tools.demo_train") == 11

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("tools ran")
    """
)


def test_tools_run_with_pil_and_matplotlib_blocked():
    """The data tools and demo_train on a machine like the card's: the
    renders and main raise ImportError naming PIL and write nothing; the
    equation, split and pickle steps build a dataset with ink drawn by the
    caller; pickle_partial_typeset, the ambiguity scan's ImportError naming
    matplotlib, demo_train at tiny widths with remat on resident data, and
    the curriculum's dry run; no blocked module is loaded."""
    proc = subprocess.run(
        [sys.executable, "-c", _TOOLS_CHILD], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "tools ran" in proc.stdout


def test_no_module_level_matplotlib_imports():
    """matplotlib is imported inside the functions that typeset, never at the
    top of a port module or chip_smoke.py."""
    pattern = re.compile(r"^(import|from)\s+matplotlib(\.|\s|$)", re.MULTILINE)
    paths = [os.path.join(root, name) for root, _, files in os.walk(PORT_DIR)
             for name in files if name.endswith(".py")]
    offenders = []
    for path in paths + [os.path.join(REPO, "chip_smoke.py")]:
        with open(path) as f:
            if pattern.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders
