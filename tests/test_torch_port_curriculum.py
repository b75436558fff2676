"""The port's demo_train and curriculum tools against the JAX package's
(tools/demo_train_tpu.py, tools/train_curriculum.py) on the CPU: the config
demo_train passes to train_model, its body at tiny widths, the stage
recipes and grammar, the chained commands; and the utils helpers and the
dry run's default device that came with them."""

import inspect
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import texocr_tpu.utils as jax_utils
from texocr_tpu_torch import utils as port_utils
from texocr_tpu_torch.data.dataset import ImageDataset
from texocr_tpu_torch.parallel.dryrun import dryrun_multichip
from texocr_tpu_torch.tools import demo_train as port_demo_train
from texocr_tpu_torch.tools import make_demo_dataset as port_demo
from texocr_tpu_torch.tools import train_curriculum as port_curriculum

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
sys.path.insert(0, TOOLS)

import train_curriculum as jax_curriculum  # noqa: E402

torch.set_num_threads(1)

# The keys of the JAX tool's --metrics_out: the run's arguments, the last
# epoch's loss and test_model's metrics.
METRICS_KEYS = {"args", "final_train_loss", "token_acc", "exact_match", "edit_similarity",
                "batches"}
TINY_WIDTHS = {
    "img_size": (32, 960), "dtype": "float32",
    "encoder": {"n_channels": 1, "embed_dim": 32, "num_layers": 1, "heads": 2,
                "resnet_depths": (1, 1, 1), "resnet_channels": (128, 128, 128),
                "stem_channels": 32},
    "decoder": {"embed_dim": 32, "num_layers": 1, "heads": 2, "cross_attend": True,
                "dropout": 0.1, "exp_factor": 4},
}


def _stage_argv(stage, data, save_dir, metrics_out, init_from=None):
    """The demo_train arguments the curriculum gives ``stage``."""
    argv = (["--data", data, "--device_data", "--augment", "--batch_size", "32", "--save_dir",
             save_dir, "--metrics_out", metrics_out] + jax_curriculum.STAGES[stage]["train"])
    return argv + (["--init_from", init_from] if init_from else [])


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    """train/val/test pickles of a small default demo build."""
    out = tmp_path_factory.mktemp("demo")
    assert port_demo.main(["--out", str(out), "--n", "40", "--seed", "1"]) == 0
    return out


@pytest.mark.parametrize("stage", ["A", "W"])
def test_config_equals_the_dict_jax_passes_to_train_model(pickles, tmp_path, monkeypatch, stage):
    """The JAX tool's main, up to train_model (recorded and stopped there),
    and the port's build_config on the curriculum's stage argv: equal dicts,
    the tokenizer being each package's copy of the same vocabulary."""
    import importlib

    import texocr_tpu.training.loop as jax_loop

    monkeypatch.setattr(jax_utils, "enable_compile_cache", lambda path=None: None)
    jax_demo_train = importlib.import_module("demo_train_tpu")
    seen = {}

    class Stop(Exception):
        pass

    def record(train_set, val_set, config, *args, **kwargs):
        seen["config"] = config
        raise Stop

    monkeypatch.setattr(jax_loop, "train_model", record)
    argv = _stage_argv(stage, str(pickles), str(tmp_path / "ckpts"), str(tmp_path / "m.json"),
                       init_from=str(tmp_path / "prev") if stage == "W" else None)
    monkeypatch.setattr(sys, "argv", ["demo_train_tpu.py"] + argv)
    with pytest.raises(Stop):
        jax_demo_train.main()
    want = dict(seen["config"])
    got = port_demo_train.build_config(port_demo_train.parse_args(argv))
    with open(want.pop("tokenizer_path")) as f, open(got.pop("tokenizer_path")) as g:
        assert f.read() == g.read()
    assert got == want
    if stage == "W":
        assert got["remat"] and got["device_data_pack_bits"] == 4 and not got["device_data_val"]
        assert got["optimizer_args"]["lr_schedule"] == {"warmup_steps": 200,
                                                        "decay_steps": 100000}


@pytest.mark.parametrize("knobs", [[], ["--device_data", "--augment", "--remat", "--pack_bits",
                                        "4", "--host_val"]], ids=["host", "stage_w_knobs"])
def test_body_trains_evaluates_and_writes_jaxs_keys(pickles, tmp_path, capsys, knobs):
    """demo_train's run at tiny widths on the CPU: one epoch, the decode
    budget clamped to the positional table, test_model, and --metrics_out
    with the JAX tool's keys; the second setting warm-starts from a first
    run, with stage W's knobs."""
    first = tmp_path / "first"
    argv = ["--data", str(pickles), "--epochs", "1", "--batch_size", "4", "--save_dir",
            str(first), "--eval_batches", "1", "--eval_batch_size", "2", "--eval_max_len",
            "600", "--keep_small", "--device", "cpu", "--metrics_out", str(tmp_path / "m.json")]
    if knobs:
        args = port_demo_train.parse_args(argv)
        port_demo_train.run(args, {**port_demo_train.build_config(args), **TINY_WIDTHS})
        argv = [a if a != str(first) else str(tmp_path / "second") for a in argv]
        argv += knobs + ["--init_from", str(first)]
    args = port_demo_train.parse_args(argv)
    config = {**port_demo_train.build_config(args), **TINY_WIDTHS}
    final = port_demo_train.run(args, config)

    with open(tmp_path / "m.json") as f:
        record = json.load(f)
    assert set(record) == METRICS_KEYS
    assert record["args"]["device"] == "cpu" and record["args"]["remat"] == bool(knobs)
    assert len(final["history"]) == 1 and np.isfinite(final["history"]).all()
    assert record["final_train_loss"] == final["history"][-1]
    assert record["batches"] == final["batches"] == 1
    assert 0.0 <= record["token_acc"] <= 1.0
    # The positional table covers the labels padded to --seq_pad (128 rows
    # here), and the 600-step budget was clamped to it.
    train = ImageDataset.load(str(pickles / "train" / "trainset.pkl"))
    assert train.max_seq_len <= 128
    assert "decode budget 600 exceeds the checkpoint's positional table (128 rows); " \
        "clamping to 127" in capsys.readouterr().out


def test_stages_and_grammar_equal_jax():
    assert port_curriculum.STAGES == jax_curriculum.STAGES
    assert port_curriculum.ORDER == jax_curriculum.ORDER
    for spec in ("A-F", "A-C,F", "f,g", "B", "A-W", "T,U-W", "a-b, c", ""):
        assert port_curriculum.parse_stages(spec) == jax_curriculum.parse_stages(spec), spec
    for bad in ("A-Z", "Q", "C-A", " a - b "):
        with pytest.raises(SystemExit) as port_err:
            port_curriculum.parse_stages(bad)
        with pytest.raises(SystemExit) as jax_err:
            jax_curriculum.parse_stages(bad)
        assert str(port_err.value) == str(jax_err.value)


def _dry_run(argv, capsys, monkeypatch=None, jax=False):
    if jax:
        monkeypatch.setattr(sys, "argv", ["train_curriculum.py"] + argv)
        jax_curriculum.main()
    else:
        port_curriculum.main(argv)
    return [line[2:].split() for line in capsys.readouterr().out.splitlines()
            if line.startswith("+ ")]


def test_dry_run_chains_warm_starts_through_the_ports_modules(tmp_path, capsys, monkeypatch):
    """Stage A trains from scratch, B from A's checkpoints, C from B's; each
    command is the JAX tool's with the port's module in place of the
    script, --device added and the metrics under --results_dir."""
    base = str(tmp_path)
    results = str(tmp_path / "results")
    port = _dry_run(["--dry_run", "--base_dir", base, "--stages", "A-C", "--results_dir",
                     results], capsys)
    jax = _dry_run(["--dry_run", "--base_dir", base, "--stages", "A-C"], capsys, monkeypatch,
                   jax=True)
    trains = [c for c in port if c[1:3] == ["-m", "texocr_tpu_torch.tools.demo_train"]]
    builds = [c for c in port if c[1:3] == ["-m", "texocr_tpu_torch.tools.make_demo_dataset"]]
    assert len(trains) == 3 and len(builds) == 3 and len(port) == len(jax) == 6
    assert "--init_from" not in trains[0]
    assert trains[1][trains[1].index("--init_from") + 1] == f"{base}/stageA_ckpts"
    assert trains[2][trains[2].index("--init_from") + 1] == f"{base}/stageB_ckpts"
    for cmd in trains:
        assert "--device_data" in cmd and "--augment" in cmd
    for name, p, j in zip("AABBCC", port, jax):
        assert p[0] == j[0] == sys.executable
        assert j[1].endswith("make_demo_dataset.py") or j[1].endswith("demo_train_tpu.py")
        p_args, j_args = p[3:], j[2:]
        if "--metrics_out" in p_args:
            i = p_args.index("--metrics_out")
            assert p_args[i + 1] == os.path.join(results, f"stage_{name}.json")
            assert j_args[i + 1].endswith(os.path.join("results", f"stage_{name}.json"))
            assert p_args[i + 2: i + 4] == ["--device", "cuda"]
            p_args = p_args[:i + 1] + p_args[i + 4:]
            j_args = j_args[:i + 1] + j_args[i + 2:]
        assert p_args == j_args


def test_default_results_dir_is_results_torch(tmp_path, capsys):
    cmds = _dry_run(["--dry_run", "--base_dir", str(tmp_path), "--stages", "A"], capsys)
    metrics = cmds[-1][cmds[-1].index("--metrics_out") + 1]
    assert metrics == os.path.join(REPO, "results", "torch", "stage_A.json")


def test_mid_chain_start_requires_warm_start(tmp_path, capsys):
    with pytest.raises(SystemExit, match="warm start"):
        port_curriculum.main(["--dry_run", "--base_dir", str(tmp_path), "--stages", "F"])
    os.makedirs(tmp_path / "stageE_ckpts")
    cmds = _dry_run(["--dry_run", "--base_dir", str(tmp_path), "--stages", "F"], capsys)
    assert cmds[-1][cmds[-1].index("--init_from") + 1] == str(tmp_path / "stageE_ckpts")


def test_existing_pickles_skip_the_build(tmp_path, capsys):
    os.makedirs(tmp_path / "data_simple" / "train")
    (tmp_path / "data_simple" / "train" / "trainset.pkl").write_bytes(b"")
    port_curriculum.main(["--dry_run", "--base_dir", str(tmp_path), "--stages", "A"])
    out = capsys.readouterr().out
    assert "dataset" in out and "skipping build" in out and "make_demo_dataset" not in out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_max_negative_val_equals_jax(dtype):
    assert port_utils.max_negative_val(getattr(torch, dtype)) == jax_utils.max_negative_val(
        getattr(jnp, dtype))


def test_padding_helpers_equal_jax():
    for k in (1, 2, 3, 5, 7):
        for s in (1, 2, 3):
            for d in (1, 2, 3):
                assert port_utils.get_padding(k, s, d) == jax_utils.get_padding(k, s, d)
                assert port_utils.is_static_pad(k, s, d) == jax_utils.is_static_pad(k, s, d)
                for x in (1, 7, 16, 31, 64, 160, 1008):
                    assert (port_utils.get_same_padding(x, k, s, d)
                            == jax_utils.get_same_padding(x, k, s, d))
                    assert (port_utils.same_pad_lo_hi(x, k, s, d)
                            == jax_utils.same_pad_lo_hi(x, k, s, d))


def test_exact_match_equals_jax():
    for pred, target in (([1, 2, 3], [1, 2, 3]), ([1, 2], (1, 2)), ([1, 2], [1, 2, 3]),
                         ([], []), (np.array([4, 5]), [4, 5]), ([4, 5], [5, 4])):
        assert port_utils.exact_match(pred, target) == jax_utils.exact_match(pred, target)


def test_dryrun_multichip_defaults_to_cuda():
    assert inspect.signature(dryrun_multichip).parameters["device"].default == "cuda"
