"""The decode-attention readers (``decode.attn_ms.batch``,
``decode_attn_roofline.batch``) on synthetic traced batches: what they read
where the kernel ran, and nothing where it did not (a program without it)."""

import json
import types
from pathlib import Path

import pytest

from portbench.trace import Slice
from portbench.tests.test_portbench_spans import reader

PB = Path(__file__).parents[1]
MIX = json.loads((PB / "traffic" / "batch_fixed.json").read_text())


def config(name):
    return json.loads((PB / "configs" / f"{name}.json").read_text())["model"]


def make_run(cfg, kernels, steps=MIX["max_len"], us=1000):
    """A traced batch whose device ran ``kernels`` decode-attention kernels of
    ``us`` microseconds each, beside one other kernel."""
    sl = Slice(sync=False)
    sl.device = [("void (anonymous namespace)::decode_attention_step<__nv_bfloat16, 0, 1>"
                  "(Params)", 10 * i * us * 1000, (10 * i + 1) * us * 1000)
                 for i in range(kernels)]
    sl.device.append(("gemv", 0, 5))
    sl.window_s = 1.0
    return types.SimpleNamespace(slice=sl, counters={"decode_steps": steps},
                                 cell=types.SimpleNamespace(mix=MIX), model_config=cfg)


@pytest.mark.parametrize("name", ["texocr-base", "texocr-int8kv"])
def test_readers_read_the_kernels(name):
    steps = MIX["max_len"]
    run = make_run(config(name), 8 * steps)
    assert reader("decode.attn_ms.batch")(run) == pytest.approx(8.0)
    share = reader("decode_attn_roofline.batch")(run)
    gb_a_step = {"texocr-base": 1.597, "texocr-int8kv": 0.8237}[name]
    # 8 ms a step against the bytes of a step at 3.35 TB/s
    assert share == pytest.approx(100 * gb_a_step / 3.35 / 8.0, rel=1e-3)


def test_nothing_without_the_kernel():
    for metric in ("decode.attn_ms.batch", "decode_attn_roofline.batch"):
        assert reader(metric)(make_run(config("texocr-base"), 0)) is None


def test_roofline_needs_two_kernels_a_layer_a_step():
    run = make_run(config("texocr-base"), 8 * MIX["max_len"] - 1)
    assert reader("decode_attn_roofline.batch")(run) is None
    assert reader("decode.attn_ms.batch")(run) is not None
