"""The two cells added with the ``mla_moe`` decoder, rehearsed on the CPU at
tiny sizes (files under ``tiny/``, entries added to a copy of the tiny
benchmark): sound runs correct, the routed-row count held, a planted fault
and the fp8 control read not correct; the burst mix's send times; the
configuration's numbers against the catalog's and the FLOP and byte counts
against hand counts."""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

PB = Path(__file__).parents[1]
TINY = Path(__file__).parent / "tiny"
sys.path.insert(0, str(PB))

import run as bench  # noqa: E402
from portbench import calibrate, flops_kimivl, roofline_kimivl  # noqa: E402
from portbench.drivers import fixed_batch_prefix, open_loop_burst  # noqa: E402
from portbench.reference import kimivl  # noqa: E402

SEED = 2 ** 31 + 777


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The tiny benchmark with ``tiny.kimivl`` and ``tiny.serve_burst``."""
    out = tmp_path_factory.mktemp("bench") / "tiny"
    shutil.copytree(TINY, out)
    bench_file = json.loads((out / "BENCHMARK.json").read_text())
    bench_file["configs"].append({"name": "tiny-kimivl", "file": "configs/tiny-kimivl.json"})
    bench_file["workloads"] += [
        {"name": "tiny.kimivl", "config": "tiny-kimivl", "traffic": "batch_prefix", "chips": 1},
        {"name": "tiny.serve_burst", "config": "tiny", "traffic": "serve_burst", "chips": 1}]
    for m in bench_file["end_to_end"]:
        if "tiny.batch" in m.get("workloads", []):
            m["workloads"].append("tiny.kimivl")
        if "tiny.serve" in m.get("workloads", []):
            m["workloads"].append("tiny.serve_burst")
    (out / "BENCHMARK.json").write_text(json.dumps(bench_file))
    return out


def tiny(data, cell, faults=None, seed=SEED):
    return bench.run_cell(cell, seed, 1.0, False, "cpu", bench_path=data / "BENCHMARK.json",
                          data_dir=data, faults=faults)


def test_the_batch_cell_is_correct_and_counts_every_routed_row(data):
    out = tiny(data, "tiny.kimivl")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["attempted"] % 4 == 0
    assert set(out["metrics"]) == {"batch_images_per_s", "setup_s"}


def test_a_wrong_routed_row_count_fails_the_run(data, monkeypatch):
    monkeypatch.setattr(fixed_batch_prefix, "expected_rows", lambda *a: 1)
    with pytest.raises(RuntimeError, match="moe.expert_rows counted"):
        tiny(data, "tiny.kimivl")


def test_an_eos_in_the_window_fails_the_run(data, monkeypatch):
    """A decode that ends a row early is caught: the run needs every row to
    decode to ``max_len``."""
    made = kimivl.make_params

    def unpinned(arch, seed, device, eos_logit=None):
        params = made(arch, seed, device)
        params[kimivl.LM + "lm_head.weight"][arch.eos] = 1.0
        return params

    monkeypatch.setattr(kimivl, "make_params", unpinned)
    with pytest.raises(RuntimeError, match="served tokens are EOS"):
        tiny(data, "tiny.kimivl")


@pytest.mark.parametrize("faults", [{"tokens": calibrate.alter_tokens}, {"in_place": "fp8"}])
def test_a_fault_or_the_fp8_control_reads_not_correct(data, faults):
    out = tiny(data, "tiny.kimivl", faults=faults)
    assert not out["correct"], out["checks"]


def test_the_burst_cell_is_correct(data):
    out = tiny(data, "tiny.serve_burst")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"latency_p50_s", "latency_p95_s", "setup_s"}


def test_bursts_send_at_their_rate_only_in_their_on_phases():
    mix = json.loads((PB / "traffic" / "serve_burst.json").read_text())
    phases = open_loop_burst.on_phases(mix, 30.0)
    times = np.array([r["t"] for r in open_loop_burst.requests(mix, SEED, 30.0)])
    assert all(any(a <= t < b for a, b in phases) for t in times)
    on_total = sum(b - a for a, b in phases)
    assert len(times) == round(54.0 * on_total)
    assert all(b - a <= 1.0 + 1e-9 for a, b in phases) and len(phases) == 10
    again = np.array([r["t"] for r in open_loop_burst.requests(mix, SEED + 1, 30.0)])
    assert np.array_equal(times, again)          # every seed meets the same bursts
    start = open_loop_burst.traced_start(mix, 30.0) * 30.0
    assert start >= 0.25 * 30.0 and any(abs(start - a) < 1e-9 for a, _ in phases)
    with pytest.raises(ValueError, match="average"):
        open_loop_burst.cycle(dict(mix, rate_per_s=20.0))


def test_the_configuration_holds_the_catalogs_numbers():
    cfg = json.loads((PB / "configs" / "kimi-vl-a3b.json").read_text())
    dec = cfg["model"]["decoder"]
    for key, value in cfg.items():
        if key in dec:
            assert dec[key] == value, key
    assert cfg["reduced"] == [] and dec["kind"] == "mla_moe"
    arch = kimivl.Arch.from_config(cfg["model"])
    assert kimivl.parameter_count(arch) == 15_966_406_272
    assert arch.prefix(160, 1008) == 160


def test_flop_and_byte_counts_by_hand():
    cfg = json.loads((PB / "configs" / "kimi-vl-a3b.json").read_text())["model"]
    arch = kimivl.Arch.from_config(cfg)
    # Per token: attention 2 x (2048 x 3072 + 2048 x 576 + 512 x 4096 + 2048 x 2048) a layer,
    # the dense layer 2 x 3 x 2048 x 11264, each expert layer the router and 8 experts.
    attn = 2 * (2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048)
    moe = 2 * 2048 * 64 + 8 * 2 * 3 * 2048 * 1408
    assert flops_kimivl.token_flops(arch) == 27 * attn + 2 * 3 * 2048 * 11264 + 26 * moe
    assert flops_kimivl.pair_flops(arch) == 27 * 2 * 16 * 320
    # A decode launch pair at batch 256 with every expert touched is bound by
    # the 64 experts' weights, 64 x 3 x 1408 x 2048 bf16 values, and its
    # 1,536 rows: 256 x 2048 in, 1536 x 1408 out and in again, 1536 x 2048
    # float32 out, 1536 weights.
    moved = (64 * 3 * 1408 * 2048 * 2 + 256 * 2048 * 2 + 2 * 1536 * 1408 * 2
             + 1536 * 2048 * 4 + 1536 * 4)
    assert roofline_kimivl.launch_ms(arch, 256, 64) == pytest.approx(moved / 3.35e12 * 1e3)
    # The prefill's 40,960 tokens are bound by their operations.
    ops = 2 * 40960 * 6 * 2048 * 1408 * 3
    assert roofline_kimivl.launch_ms(arch, 40960, 64) == pytest.approx(ops / 989e12 * 1e3)


def test_the_reference_makes_weights_in_their_type_and_slices():
    cfg = json.loads((TINY / "configs" / "tiny-kimivl.json").read_text())["model"]
    arch = kimivl.Arch.from_config(dict(cfg, param_dtype="bfloat16"))
    p = kimivl.make_params(arch, SEED, "cpu", eos_logit=0.0)
    head = p["language_model.lm_head.weight"]
    assert head.dtype == torch.bfloat16 and not head[arch.eos].any() and head[0].any()
    e0 = p["language_model.model.layers.1.mlp.experts.0.gate_proj.weight"]
    e1 = p["language_model.model.layers.1.mlp.experts.1.gate_proj.weight"]
    assert e1.data_ptr() == e0.data_ptr() + e0.numel() * e0.element_size()
    assert p["encoder.cls_token"].dtype == torch.float32
    with pytest.raises(ValueError, match="pinned at 0"):
        kimivl.make_params(arch, SEED, "cpu", eos_logit=-50.0)
