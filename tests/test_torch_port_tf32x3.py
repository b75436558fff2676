"""The float32 flash kernel's 3xTF32 arithmetic, emulated on the CPU.

On the card the float32 kernel (``flash_fwd_f32`` in
``texocr_tpu_torch/csrc/flash_attention.cu``) runs both of its products on the
TF32 tensor cores, each split into three: x = big + small with
big = tf32(x) and small = tf32(x - big), and A B = As Bb + Ab Bs + Ab Bb,
summed in float32 in that order. Here ``tf32_rna`` rounds float32 to TF32 as
``cvt.rna.tf32.f32`` does, by integer operations on the bits, and
``flash_attention_3xtf32`` applies the split product to both matmuls of a copy
of ``flash_attention_plain``. It is held to float64, to the Pallas kernel in
interpret mode and to the JAX goldens, so that the arithmetic is known to keep
float32 accuracy before the kernel meets the card.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texocr_tpu.ops.flash_attention import flash_attention as jax_flash
from texocr_tpu_torch.checkpoint import load_state
from texocr_tpu_torch.config import ModelConfig
from texocr_tpu_torch.models import OCRModel, greedy_decode
from texocr_tpu_torch.ops import flash_attention as fa
from texocr_tpu_torch.ops.attention_core import MASK_VALUE, combined_mask

from test_torch_port_goldens import CONFIG, GOLDEN, STATE

torch.set_num_threads(1)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32``: to 10 mantissa bits,
    ties away from zero, the low 13 bits zero. Adding 2^12 to the bits adds
    half a TF32 step to the magnitude whatever the sign (a carry into the
    exponent is the right rounding up); infinities and NaN stay as they are."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel forms it: As Bb + Ab Bs + Ab Bb in float32. Each
    TF32 product of two TF32 values is exact in float32; only the sums round."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    out = torch.matmul(a_small, b_big)
    out = out + torch.matmul(a_big, b_small)
    return out + torch.matmul(a_big, b_big)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product would form it."""
    return torch.matmul(tf32_rna(a), tf32_rna(b))


def flash_attention_3xtf32(q, k, v, *, scale, causal=False, kv_lens=None, matmul=matmul_3xtf32):
    """``flash_attention_plain`` (float32) with both products formed by
    ``matmul``: the float32 kernel's arithmetic, up to the order of the sums."""
    fa._check(q, k, v, causal, kv_lens)
    allowed = None
    if kv_lens is not None:
        cols = torch.arange(k.shape[2])
        allowed = (cols[None, :] < kv_lens[:, None])[:, None, None, :]
    logits = matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = combined_mask(q.shape[-2], k.shape[-2], allowed=allowed, causal=causal)
    if mask is not None:
        logits = logits.masked_fill(~mask, MASK_VALUE)
    return matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)


def attention_f64(q, k, v, *, scale, causal=False, kv_lens=None):
    """The same function in float64 (numpy inputs), masks as the math path's."""
    q, k, v = (torch.from_numpy(x).double() for x in (q, k, v))
    allowed = None
    if kv_lens is not None:
        cols = torch.arange(k.shape[2])
        allowed = (cols[None, :] < torch.from_numpy(kv_lens)[:, None])[:, None, None, :]
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    mask = combined_mask(q.shape[-2], k.shape[-2], allowed=allowed, causal=causal)
    if mask is not None:
        logits = logits.masked_fill(~mask, MASK_VALUE)
    return torch.matmul(torch.softmax(logits, dim=-1), v).numpy()


def _qkv(seed, b, h, nq, nk, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, n, dh)).astype(np.float32) for n in (nq, nk, nk))


@pytest.mark.parametrize(
    "x, want",
    [
        (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),  # a tie: away from zero (ties-to-even gives 1)
        (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
        (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),  # just under the tie
        (2.0 - 2.0 ** -12, 2.0),  # carries into the exponent
        (-1.5 * 2.0 ** -100, -1.5 * 2.0 ** -100),  # exact in TF32
        (float("inf"), float("inf")),
    ],
)
def test_tf32_rna_rounds_like_cvt_rna(x, want):
    got = tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want
    assert int(got.view(torch.int32).item()) & 0x1FFF == 0


@pytest.mark.parametrize(
    "shape, dh, causal, lens",
    [
        ((2, 2, 131, 131), 32, False, None),  # ragged: 131 = 2 * 64 + 3
        ((2, 2, 131, 131), 64, False, None),
        ((1, 2, 131, 131), 128, False, None),
        ((2, 2, 131, 131), 64, True, None),
        ((3, 2, 96, 160), 64, False, [160, 100, 1]),
        ((2, 2, 70, 70), 128, True, [0, 7]),
    ],
)
def test_3xtf32_keeps_float32_accuracy(shape, dh, causal, lens):
    """Unit-normal q, k, v: the emulation within 1e-5 of float64. The logits
    are sums of dh products of size about 1 times dh^-0.5; each split product
    is off by about 2^-21 of |q||k| (the dropped small x small term and the
    TF32 rounding of the small parts), so the logits by under 1e-6, and the
    float32 sums of the softmax and of P V add errors of the same order: 1e-5
    leaves a margin of ten. One TF32 product (operands rounded to 2^-11) is
    off by more than the bound, so the bound tells the two apart."""
    b, h, nq, nk = shape
    q, k, v = _qkv(21, b, h, nq, nk, dh)
    kv_lens = None if lens is None else np.asarray(lens, np.int32)
    torch_lens = None if lens is None else torch.from_numpy(kv_lens)
    scale = dh ** -0.5
    want = attention_f64(q, k, v, scale=scale, causal=causal, kv_lens=kv_lens)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    got = flash_attention_3xtf32(qt, kt, vt, scale=scale, causal=causal, kv_lens=torch_lens)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5
    plain = fa.flash_attention_plain(qt, kt, vt, scale=scale, causal=causal, kv_lens=torch_lens)
    assert np.abs(plain.numpy() - want).max() <= 1e-5
    one_pass = flash_attention_3xtf32(qt, kt, vt, scale=scale, causal=causal, kv_lens=torch_lens,
                                      matmul=matmul_tf32)
    assert np.abs(one_pass.numpy() - want).max() > 1e-5


@pytest.mark.parametrize(
    "shape, causal, lens",
    [
        ((2, 3, 200, 200), False, None),
        ((2, 3, 200, 200), True, None),
        ((3, 3, 96, 160), False, [160, 100, 1]),
    ],
)
def test_3xtf32_matches_pallas_interpret(shape, causal, lens):
    """The emulation against the Pallas kernel in interpret mode, at atol 2e-5,
    the tolerance tests/test_torch_port_attention.py holds the plain version to."""
    b, h, nq, nk = shape
    q, k, v = _qkv(22, b, h, nq, nk, 64)
    kv_lens = None if lens is None else np.asarray(lens, np.int32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.125, causal=causal,
                     kv_lens=None if lens is None else jnp.asarray(kv_lens), interpret=True)
    got = flash_attention_3xtf32(*(torch.from_numpy(x) for x in (q, k, v)), scale=0.125,
                                 causal=causal,
                                 kv_lens=None if lens is None else torch.from_numpy(kv_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_golden_model_is_exact_under_3xtf32(monkeypatch):
    """The golden model with its encoder self-attention routed to the flash
    wrapper, whose CPU path is swapped for the emulation: the JAX goldens'
    greedy tokens exactly, and their encoder output within 1e-4, as
    chip_smoke.py holds the kernel to them on the card."""
    calls = []

    def emulated(*args, **kwargs):
        calls.append(args[0].shape)
        return flash_attention_3xtf32(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_plain", emulated)
    golden = np.load(os.path.join(GOLDEN, "model_io.npz"))
    model = OCRModel(ModelConfig.from_dict(dict(CONFIG, use_flash_attention=True)), device="cpu")
    model.load_state_dict(load_state(STATE), strict=True)
    images = torch.from_numpy(golden["images"]).permute(0, 2, 3, 1).contiguous()
    with torch.no_grad():
        enc = model.encode(images)
    assert len(calls) == CONFIG["encoder"]["num_layers"]
    np.testing.assert_allclose(enc.numpy(), golden["enc_out"], rtol=1e-4, atol=1e-4)
    tokens = greedy_decode(model, enc, bos_token=48, eos_token=-1, pad_token=49,
                           max_len=golden["greedy_tokens"].shape[1] - 1)
    np.testing.assert_array_equal(tokens.numpy(), golden["greedy_tokens"][:, 1:])
