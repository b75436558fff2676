"""The FLOP count and the kernel bound against counts made another way."""

import json
import math
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, roofline
from portbench.reference import model as ref

TINY = Path(__file__).parent / "tiny"


def tiny_arch():
    return ref.Arch.from_config(json.loads((TINY / "configs" / "tiny.json").read_text())["model"])


def counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("canvas", [(32, 128), (16, 64), (17, 70)])
def test_encoder_flops_equal_the_counted_products(canvas):
    arch = tiny_arch()
    p = ref.make_params(arch, 3, "cpu")
    x = torch.rand(1, *canvas)
    with torch.no_grad():
        total = counted(lambda: ref.encode(x, p, arch))
    assert flops.encoder_flops(arch, *canvas) == total


@pytest.mark.parametrize("positions", [1, 9, 24])
def test_decoder_flops_count_the_causal_half(positions):
    arch = tiny_arch()
    p = ref.make_params(arch, 4, "cpu")
    nk = flops.encoder_tokens(arch, 32, 128)
    enc = torch.rand(1, nk, arch.enc_dim)
    tokens = torch.zeros(1, positions, dtype=torch.long)
    with torch.no_grad():
        total = counted(lambda: ref.decode_logits(tokens, enc, p, arch))
    # The counter sees every (query, key) pair of the causal self-attention;
    # the model FLOPs count the pairs a query may attend.
    inner = arch.dec_heads * ref.DIM_HEAD
    masked = arch.dec_layers * 4 * inner * (positions * positions - positions * (positions + 1) // 2)
    assert flops.decoder_flops(arch, positions, nk) == total - masked


def test_flagship_by_hand():
    cfg = json.loads((Path(__file__).parents[1] / "configs" / "texocr-base.json").read_text())
    arch = ref.Arch.from_config(cfg["model"])
    assert flops.encoder_tokens(arch, 160, 1008) == 10 * 63 + 1
    assert flops.encoder_tokens(arch, 64, 512) == 4 * 32 + 1
    # One decode position: logits 2 * 256 * 1000, and per layer q/k/v and
    # fc_out of self and cross, the MLP, attention over 1 and over 631 keys.
    d, inner, hidden, nk = 256, 512, 1024, 631
    per_layer = (3 * 2 * d * inner + 4 * 1 * inner + 2 * inner * 2 * d
                 + 2 * d * inner + 2 * 2 * nk * d * inner + 4 * nk * inner + 2 * inner * 2 * d
                 + 2 * d * 2 * hidden + 2 * hidden * d)
    assert flops.decoder_flops(arch, 1, nk) == 4 * per_layer + 2 * d * 1000
    # The stem at (160, 1008): 80 x 504 outputs x 64 channels x 49 taps.
    stem = 2 * 80 * 504 * 64 * 49
    assert flops.backbone_flops(arch, 160, 1008)[0] > stem
    assert flops.train_flops(arch, 160, 1008, 352) == 3 * (
        flops.encoder_flops(arch, 160, 1008) + flops.decoder_flops(arch, 351, nk))


def test_attention_bound_at_the_training_shape():
    ms, what = roofline.attention_bound_ms((128, 8, 631, 64), 631, bf16=True)
    assert what == "operations"
    assert ms == pytest.approx(4 * 128 * 8 * 631 * 631 * 64 / 989e12 * 1e3, rel=1e-12)
    assert round(ms, 4) == 0.1055
    f32, _ = roofline.attention_bound_ms((128, 8, 631, 64), 631, bf16=False)
    assert f32 == pytest.approx(3 * ms * 989 / 495)


def test_attention_bound_counts_valid_keys():
    whole, _ = roofline.attention_bound_ms((2, 8, 631, 64), 631, bf16=True)
    same, _ = roofline.attention_bound_ms((2, 8, 631, 64), 631, bf16=True, kv_lens=[631, 631])
    assert same == whole
    long, _ = roofline.attention_bound_ms((2, 8, 2000, 64), 2000, bf16=True)
    fewer, what = roofline.attention_bound_ms((2, 8, 2000, 64), 2000, bf16=True,
                                              kv_lens=[2000, 1000])
    assert what == "operations"
    assert fewer == pytest.approx(long * 3 / 4)
    # A single query reads more than it computes.
    _, what = roofline.attention_bound_ms((1, 8, 1, 64), 631, bf16=True)
    assert what == "bytes"
    assert math.isfinite(whole)
