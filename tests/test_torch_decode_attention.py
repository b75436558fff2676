"""The decode step's attention (``texocr_tpu_torch/ops/decode_attention.py``):
its plain version against the formulas the step used before it, its
argument checks, and, on a CUDA device, the kernel against the plain version.

CPU: the plain version is bit-equal to those formulas, copied below as they
stood (``math_attention`` of ``ops/attention_core.py`` and
``_attend_split`` and ``attend_cached_kv``'s int8 expression of
``models/attention.py``), for every call site: bf16 and int8 cross
attention, beam 1 and 5, with and without a key mask (one row with every key
masked), the plain self cache at t = 0, 31, 32, 100, and the int8 split at
t0 = 0, 32, 96.

Card (marked ``card``; each test skips without a CUDA device, decided inside
the test): the kernel against the plain version at the main path's calls
(``ops.bench.DECODE_CASES``, which ``chip_smoke.py`` phase 3b checks too)
and a few more edge cases, under ``ops.bench.decode_gaps``'s limits: the two
differ only in the order of their float32 sums (the dot products, the
softmax's sum and P V), so a rounding to bf16 can land one unit in the last
place (ulp) either side. Through the whole bf16 decoder step (4 layers, 48
teacher-forced steps) those roundings feed the next layer and the next
step's cache, so there the step logits are held by scale: their RMS gap from
the plain version's is at most half the RMS gap between the plain version in
bf16 and in float32 (what bf16 itself moves them by; on an H100 the kernel's
gap read 0.27 and 0.29 of it, bf16 and int8 caches). On the card:

    python -m pytest tests/test_torch_decode_attention.py -m card --noconftest -q

(``--noconftest``: the repository's conftest imports JAX, which that
machine does not have; this file does not.)
"""

import pytest
import torch

from texocr_tpu_torch import telemetry
from texocr_tpu_torch.ops import decode_attention as da
from texocr_tpu_torch.ops.bench import (DECODE_CASES, bf16_ulps, decode_case, decode_cross_inputs,
                                        decode_gaps, decode_self_inputs)

torch.set_num_threads(1)

HEADS, DH, SCALE = 8, 64, 64 ** -0.5
MASK_VALUE = -torch.finfo(torch.float32).max


# -- the formulas the decode step used before the kernel, copied as they stood ------------


def parent_math_attention(q, k, v, *, scale, allowed=None):
    raw = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = allowed
    logits = raw if mask is None else raw.masked_fill(~mask, MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(q.dtype).float(), v.to(q.dtype).float()).to(q.dtype)


def parent_attend_split(q, cache, t0, t, scale):
    dtype = q.dtype
    qf = q.float()
    s_hot = torch.matmul(qf, cache["k"][:, :, t0: t + 1].float().transpose(-1, -2)) * scale
    s_big = torch.matmul(qf, cache["k8"][:, :, :t0].to(dtype).float().transpose(-1, -2)) * scale
    s_big = s_big * cache["sk"][:, :, None, :t0].float()
    probs = torch.softmax(torch.cat([s_big, s_hot], dim=-1), dim=-1)
    p_big = probs[..., :t0].to(dtype) * cache["sv"][:, :, None, :t0]
    p_hot = probs[..., t0:].to(dtype)
    out = (torch.matmul(p_big.float(), cache["v8"][:, :, :t0].to(dtype).float())
           + torch.matmul(p_hot.float(), cache["v"][:, :, t0: t + 1].float()))
    return out.to(dtype)


def parent_cross(q, kv, key_mask=None):
    allowed = None if key_mask is None else key_mask[:, None, None, :]
    if "k8" in kv:
        return parent_math_attention(q * kv["sk"], kv["k8"].to(q.dtype), kv["v8"].to(q.dtype),
                                     scale=SCALE, allowed=allowed) * kv["sv"]
    return parent_math_attention(q, kv["k"], kv["v"], scale=SCALE, allowed=allowed)


def parent_self(q, cache, t, t0):
    if "k8" in cache:
        return parent_attend_split(q, cache, t0, t, SCALE)
    return parent_math_attention(q, cache["k"][:, :, : t + 1], cache["v"][:, :, : t + 1],
                                 scale=SCALE)


# -- CPU: the plain version is the old formulas, bit for bit --------------------------------

CROSS_CASES = [(int8, beam, mask) for int8 in (False, True) for beam in (1, 5)
               for mask in (False, True)]


@pytest.mark.parametrize("int8,beam,mask", CROSS_CASES)
def test_cross_plain_is_the_old_formula(int8, beam, mask):
    gen = torch.Generator().manual_seed(1 + 4 * int8 + beam + 2 * mask)
    q, kv, key_mask = decode_cross_inputs(gen, 3, 37, beam, int8, mask=mask)
    got = da.cross_attention(q, kv, scale=SCALE, key_mask=key_mask)
    assert got.shape == (3, HEADS, beam, DH) and got.dtype == torch.bfloat16
    assert torch.equal(got, parent_cross(q, kv, key_mask))


SELF_CASES = [("plain", t, None, rows) for t in (0, 31, 32, 100) for rows in (1, 5)]
SELF_CASES += [("split", t0 + 5, t0, rows) for t0 in (0, 32, 96) for rows in (1, 5)]


@pytest.mark.parametrize("kind,t,t0,rows", SELF_CASES)
def test_self_plain_is_the_old_formula(kind, t, t0, rows):
    gen = torch.Generator().manual_seed(7 + t + rows)
    q, cache = decode_self_inputs(gen, rows, t, t0)
    got = da.self_attention(q, cache, t, t0 or 0, scale=SCALE)
    assert got.shape == (rows, HEADS, 1, DH)
    assert torch.equal(got, parent_self(q, cache, t, t0 or 0))


def test_masked_row_averages_v():
    gen = torch.Generator().manual_seed(3)
    q, kv, key_mask = decode_cross_inputs(gen, 2, 9, dtype=torch.float32, mask=True)
    got = da.cross_attention(q, kv, scale=SCALE, key_mask=key_mask)
    torch.testing.assert_close(got[0], kv["v"][0].mean(dim=1, keepdim=True).expand_as(got[0]),
                               rtol=1e-6, atol=1e-6)


# -- CPU: what the kernel takes --------------------------------------------------------------


def _bad_calls():
    gen = torch.Generator().manual_seed(5)
    q, kv, mask = decode_cross_inputs(gen, 2, 11, mask=True)
    q8, kv8, _ = decode_cross_inputs(gen, 2, 11, int8=True)
    qs, cache = decode_self_inputs(gen, 2, 40, t0=32)
    cases = {
        "q float16": lambda: da.cross_call(q.half(), kv),
        "q rank 3": lambda: da.cross_call(q[0], kv),
        "q head dim 32": lambda: da.cross_call(q[..., :32], kv),
        "k float32 under bf16 q": lambda: da.cross_call(q, {"k": kv["k"].float(),
                                                          "v": kv["v"].float()}),
        "k rank 3": lambda: da.cross_call(q, {"k": kv["k"][0], "v": kv["v"][0]}),
        "k head dim 32": lambda: da.cross_call(q, {"k": kv["k"][..., :32], "v": kv["v"][..., :32]}),
        "k off 16 bytes": lambda: da.cross_call(q, {"k": _shifted(kv["k"]),
                                                   "v": _shifted(kv["v"])}),
        "no keys": lambda: da.cross_call(q, {"k": kv["k"][:, :, :0], "v": kv["v"][:, :, :0]}),
        "4097 keys": lambda: da.cross_call(q, {"k": torch.zeros(2, HEADS, 4097, DH,
                                                                dtype=torch.bfloat16),
                                               "v": torch.zeros(2, HEADS, 4097, DH,
                                                                dtype=torch.bfloat16)}),
        "int8 k as int16": lambda: da.cross_call(q8, dict(kv8, k8=kv8["k8"].short(),
                                                          v8=kv8["v8"].short())),
        "int8 scales float32": lambda: da.cross_call(q8, dict(kv8, sk=kv8["sk"].float(),
                                                              sv=kv8["sv"].float())),
        "mask of the wrong shape": lambda: da.cross_call(q, kv, mask[:, :5]),
        "mask of bytes": lambda: da.cross_call(q, kv, mask.to(torch.uint8)),
        "self with two query rows": lambda: da.self_call(qs.expand(2, HEADS, 2, DH), cache,
                                                         40, 32),
        "self past the cache": lambda: da.self_call(qs, cache, 48, 32),
        "self prefix past t": lambda: da.self_call(qs, cache, 40, 41),
        "self int8 of another length": lambda: da.self_call(
            qs, dict(cache, k8=cache["k8"][:, :, :40], v8=cache["v8"][:, :, :40]), 39, 32),
    }
    return cases


def _shifted(x):
    """x's values in a buffer whose rows start 2 bytes off 16."""
    b, h, n, d = x.shape
    buf = torch.empty(b * h * n * d + 1, dtype=x.dtype)[1:].view(b, h, n, d)
    buf.copy_(x)
    return buf


BAD = list(_bad_calls())


@pytest.mark.parametrize("name", BAD)
def test_checks_refuse(name):
    with pytest.raises(ValueError):
        _bad_calls()[name]()


def test_checks_take_the_call_sites():
    gen = torch.Generator().manual_seed(6)
    q, kv, mask = decode_cross_inputs(gen, 2, 631, beam=5, mask=True)
    call = da.cross_call(q, kv, mask)
    assert (call["mode"], call["n"], call["n8"]) == (da.PLAIN, 631, 0)
    q, kv, _ = decode_cross_inputs(gen, 2, 129, int8=True)
    call = da.cross_call(q, kv)
    assert (call["mode"], call["n"], call["n8"]) == (da.CROSS8, 129, 129)
    q, cache = decode_self_inputs(gen, 3, 255, t0=224, size=256)
    call = da.self_call(q, cache, 255, 224)
    assert (call["mode"], call["n"], call["n8"]) == (da.SPLIT, 256, 224)
    call = da.self_call(q, {"k": cache["k"], "v": cache["v"]}, 0, 0)
    assert (call["mode"], call["n"], call["n8"]) == (da.PLAIN, 1, 0)


def test_kernel_refuses_a_cpu_launch():
    gen = torch.Generator().manual_seed(8)
    q, kv, _ = decode_cross_inputs(gen, 1, 5)
    with pytest.raises(ValueError, match="CUDA"):
        da._launch(q, SCALE, da.cross_call(q, kv))


GAP_CASES = {  # (dtype, the output's first element moved by, within the limits)
    "equal": (torch.bfloat16, 0.0, True),
    "one ulp of the row maximum": (torch.bfloat16, 2 ** -7, True),
    "two ulps of the row maximum": (torch.bfloat16, 2 ** -6, False),
    "not finite": (torch.bfloat16, float("nan"), False),
    "float32 within 2e-6": (torch.float32, 1e-6, True),
    "float32 past 2e-6": (torch.float32, 1e-5, False),
}


@pytest.mark.parametrize("name", GAP_CASES)
def test_gap_rule(name):
    dtype, moved, ok = GAP_CASES[name]
    want = torch.linspace(-0.5, 1.0, 64).to(dtype).view(1, 1, 1, 64)  # row maximum 1.0
    got = want.clone()
    got[..., -1] += moved
    gaps = decode_gaps(got, want)
    assert gaps["ok"] == ok, gaps
    if dtype == torch.bfloat16 and moved == moved:
        assert gaps["max_row_gap_ulps"] == moved * 2 ** 7
        assert gaps["share_over_1_ulp"] == (1 / 64 if moved > 2 ** -7 else 0)


# -- the card: the kernel against the plain version ------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: The main path's calls and a few more: beam 11, a masked beam over int8, the
#: flash gate's 4096 keys at beam 8, int8 cross in float32, self at t = 0 and
#: a split just past its first chunk.
CARD_CASES = dict(DECODE_CASES, **{
    "cross beam 11 over (2, 8, 631)": ("cross", dict(b=2, nk=631, beam=11)),
    "cross masked beam 5 int8": ("cross", dict(b=8, nk=631, beam=5, int8=True, mask=True)),
    "cross (4, 8, 4096) beam 8": ("cross", dict(b=4, nk=4096, beam=8)),
    "cross (16, 8, 631) int8 float32": ("cross", dict(b=16, nk=631, int8=True,
                                                      dtype=torch.float32)),
    "self (80, 8) t 0": ("self", dict(rows=80, t=0, size=350)),
    "self (80, 8) t 37 split 32": ("self", dict(rows=80, t=37, t0=32, size=350)),
    "self (16, 8) t 100 float32": ("self", dict(rows=16, t=100, dtype=torch.float32)),
})


def launches() -> int:
    return telemetry.counters().get("decode_attention.launches", 0)


def check_card_case(cuda, name):
    kind, args = CARD_CASES[name]
    gen = torch.Generator(device=cuda).manual_seed(len(name))
    _, _, kernel, plain, _ = decode_case(gen, kind, args, SCALE)
    before = launches()
    got = kernel()
    assert launches() == before + 1
    want = plain()
    assert got.shape == want.shape and got.dtype == want.dtype
    gaps = decode_gaps(got, want)
    assert gaps["ok"], gaps


@pytest.mark.card
@pytest.mark.parametrize("name", [n for n, (kind, _) in CARD_CASES.items() if kind == "cross"])
def test_card_cross(cuda, name):
    check_card_case(cuda, name)


@pytest.mark.card
@pytest.mark.parametrize("name", [n for n, (kind, _) in CARD_CASES.items() if kind == "self"])
def test_card_self(cuda, name):
    check_card_case(cuda, name)


@pytest.mark.card
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_card_decoder_step_logits(cuda, quant, monkeypatch):
    """The flagship decoder (seeded weights) over random encoder output, 48
    teacher-forced steps: the bf16 step logits through the kernel against
    those through the plain version, measured against what bf16 itself
    moves them by (the plain version in float32, the same weights)."""
    from texocr_tpu_torch.config import FLAGSHIP, ModelConfig
    from texocr_tpu_torch.models import OCRModel
    from texocr_tpu_torch.models.attention import chunk_start

    batch, steps = 16, 48
    gen = torch.Generator(device=cuda).manual_seed(11)
    enc = torch.randn(batch, 631, 256, generator=gen, device=cuda).to(torch.bfloat16)
    tokens = torch.randint(0, 997, (batch, steps), generator=gen, device=cuda)

    def run(dtype, plain):
        model = OCRModel(ModelConfig.from_dict(dict(FLAGSHIP, dtype=dtype, kv_quant=quant,
                                                    self_kv_quant=quant)),
                         device="cuda", seed=0)
        with monkeypatch.context() as m, torch.inference_mode():
            if plain:
                m.setattr(da, "cross_attention", da.cross_attention_plain)
                m.setattr(da, "self_attention", da.self_attention_plain)
            cross_kv = model.decoder_cross_kv(enc.to(model.dec.attn_layers.dtype))
            cache = model.decoder_init_cache(batch, steps, cuda)
            out = []
            for t in range(steps):
                t0 = chunk_start(cache, t, 32)
                out.append(model.decoder_step(tokens[:, t], t, cache, cross_kv, t0=t0))
            return torch.stack(out)

    before = launches()
    got = run("bfloat16", plain=False)
    assert launches() - before == steps * 2 * 4
    want, ref = run("bfloat16", plain=True), run("float32", plain=True).float()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()

    def rms(x):
        return float(x.float().pow(2).mean().sqrt())

    kernel_gap = rms(got.float() - want.float()) / rms(ref)
    bf16_gap = rms(want.float() - ref) / rms(ref)
    share = float((bf16_ulps(got, want) > 1).float().mean())
    print(f"[decoder step logits] caches {quant}: kernel gap {kernel_gap:.3e}, bf16 gap "
          f"{bf16_gap:.3e}, share over one ulp {share:.3e}")
    assert kernel_gap <= 0.5 * bf16_gap, (kernel_gap, bf16_gap, share)
