"""The whole run on the CPU at tiny sizes: the reference against the port,
sound runs correct, each fault a cell can have and each control read as not
correct, and a cell added by files alone."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

PB = Path(__file__).parents[1]
TINY = Path(__file__).parent / "tiny"
sys.path.insert(0, str(PB))

import run as bench  # noqa: E402
from portbench import calibrate  # noqa: E402
from portbench.reference import model as ref  # noqa: E402
from portbench.reference import train as ref_train  # noqa: E402

SEED = 2 ** 31 + 99


def tiny(cell, seed=SEED, faults=None, data=TINY, trace=False):
    return bench.run_cell(cell, seed, 1.0, trace, "cpu", bench_path=data / "BENCHMARK.json",
                          data_dir=data, faults=faults)


@pytest.mark.parametrize("config", ["tiny", "tiny-int8kv"])
def test_reference_matches_the_port_in_float32(config):
    from texocr_tpu_torch.models.generate import greedy_decode
    from texocr_tpu_torch.models.ocr_model import create_model

    cfg = json.loads((TINY / "configs" / f"{config}.json").read_text())["model"]
    arch = ref.Arch.from_config(cfg)
    p = ref.make_params(arch, SEED, "cpu")
    model = create_model(cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in p.items()}
    assert {n for n, _ in model.named_parameters()} == set(ref.leaves(arch))
    model.load_state_dict(p, strict=True)
    x = ref.model_input(torch.randint(0, 256, (3, 32, 128), dtype=torch.uint8))
    with torch.no_grad():
        enc = ref.encode(x, p, arch)
        prog_enc = model.encode(x[..., None])
        assert torch.allclose(enc, prog_enc, atol=1e-4)
        tokens, logits = greedy_decode(model, prog_enc, bos_token=arch.bos, eos_token=-1,
                                       pad_token=arch.pad, max_len=38, return_logits=True)
        inp = torch.cat([torch.full((3, 1), arch.bos), tokens[:, :-1]], 1)
        assert torch.allclose(ref.decode_logits(inp, enc, p, arch), logits, atol=1e-3)
        labels = ref_train.label_rows([[5, 6, 7], list(range(20)), [1]], arch, 8)
        labels = torch.from_numpy(labels)
        prog, _ = model(x[..., None], labels)
        inp = labels[:, :-1]
        mine = ref.decode_logits(inp, enc, p, arch, mask=inp != arch.pad)
        keep = labels[:, 1:] != arch.pad
        assert torch.allclose(prog[keep], mine[keep], atol=1e-4)


@pytest.mark.parametrize("cell", ["tiny.serve", "tiny.batch", "tiny8.batch", "tiny.train"])
def test_sound_runs_are_correct(cell):
    out = tiny(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert list(out)[-1] == "checks"


def test_a_traced_run_needs_a_card():
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        tiny("tiny.batch", trace=True)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.serve", "tokens"), ("tiny.batch", "tokens"), ("tiny8.batch", "tokens"),
    ("tiny.train", "half_batch"), ("tiny.train", "frozen")])
def test_each_fault_reads_not_correct(cell, fault):
    planted = {"tokens": calibrate.alter_tokens} if fault == "tokens" else {fault: True}
    out = tiny(cell, faults=planted)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell,control", [
    ("tiny.batch", "fp8"), ("tiny8.batch", "int4_cache"), ("tiny.serve", "fp8")])
def test_the_served_controls_read_above_the_limit(cell, control):
    out = tiny(cell, faults={"in_place": control})
    assert not out["correct"], out["checks"]


def test_the_training_control_reads_above_the_limits():
    run = calibrate.one(bench_cell("tiny.train"), SEED, 1.0, {"controls": ["fp8"]}, device="cpu")
    assert run["correct"], run["checks"]
    assert run["in_place_correct"] == {"program": True, "fp8": False}


def bench_cell(name):
    from portbench import harness

    return harness.load_cell(name, TINY / "BENCHMARK.json", TINY)


def test_a_cell_added_by_files_alone(tmp_path):
    data = tmp_path / "tiny"
    shutil.copytree(TINY, data)
    mix = json.loads((data / "traffic" / "serve.json").read_text())
    (data / "traffic" / "serve_burst.json").write_text(json.dumps(dict(mix, rate_per_s=30.0)))
    (data / "limits" / "tiny.serve_burst.json").write_text(
        (data / "limits" / "tiny.serve.json").read_text())
    bench_file = json.loads((data / "BENCHMARK.json").read_text())
    bench_file["workloads"].append({"name": "tiny.serve_burst", "config": "tiny",
                                    "traffic": "serve_burst", "chips": 1})
    for m in bench_file["end_to_end"]:
        if "tiny.serve" in m.get("workloads", []):
            m["workloads"].append("tiny.serve_burst")
    (data / "BENCHMARK.json").write_text(json.dumps(bench_file))
    out = tiny("tiny.serve_burst", data=data)
    assert out["correct"] and out["attempted"] == 30
    assert set(out["metrics"]) == {"latency_p50_s", "latency_p95_s", "setup_s"}
