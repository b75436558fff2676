"""Port attention against the JAX package: the flash kernel's plain version
against the Pallas kernel in interpret mode, the gate, and the math path
against xla_attention with dense and right-aligned causal masks.

Tolerance: atol 2e-5, the one tests/test_flash_attention.py holds the Pallas
kernel to; both sides compute float32 logits and softmax on the same inputs.
The bfloat16 cases state their own tolerance (``test_bf16_plain_matches_pallas``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from texocr_tpu.ops.attention_core import xla_attention
from texocr_tpu.ops.flash_attention import flash_attention as jax_flash
from texocr_tpu.ops.flash_attention import flash_attention_supported as jax_flash_supported
from texocr_tpu_torch.ops.attention_core import attention_core
from texocr_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    flash_attention_supported,
)

torch.set_num_threads(1)
ATOL = 2e-5


def _qkv(seed, b=2, h=3, nq=200, nk=200, dh=64):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, n, dh)).astype(np.float32) for n in (nq, nk, nk))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize(
    "shape, causal, lens",
    [
        ((2, 3, 200, 200), False, None),
        ((2, 3, 200, 200), True, None),
        ((2, 3, 64, 300), False, None),
        ((3, 3, 96, 160), False, [160, 100, 1]),
    ],
)
def test_flash_matches_pallas_interpret(shape, causal, lens):
    b, h, nq, nk = shape
    q, k, v = _qkv(1, b, h, nq, nk)
    kv_lens = None if lens is None else np.asarray(lens, np.int32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.125,
                     causal=causal, kv_lens=None if lens is None else jnp.asarray(kv_lens),
                     interpret=True)
    got = flash_attention(*_t(q, k, v), scale=0.125, causal=causal,
                          kv_lens=None if lens is None else torch.from_numpy(kv_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize(
    "shape, dh, causal, lens",
    [
        ((2, 2, 131, 131), 64, False, None),  # ragged: 131 = 2 * 64 + 3
        ((1, 2, 131, 131), 32, False, None),
        ((1, 2, 131, 131), 128, False, None),
        ((2, 2, 131, 131), 64, True, None),
        ((3, 2, 96, 160), 64, False, [160, 100, 1]),
    ],
)
def test_bf16_plain_matches_pallas(shape, dh, causal, lens):
    """bfloat16, the serving type: the plain version (what the CUDA kernel is
    held to on the card) against the Pallas kernel in interpret mode, on the
    same numpy inputs rounded to bfloat16 on both sides.

    Each is held to the float32 result on the same bfloat16 inputs within what
    its two roundings allow: half a bfloat16 step of the output (2^-8
    relative) plus P's rounding, 2^-9 relative on weights that sum to 1
    (2^-9 * max|V|). Both round the normalised P and the output at the same
    points, so they differ only where float32 sums taken in another order
    round to neighbouring bfloat16 values: they must be closer to each other
    than the Pallas kernel is to float32."""
    b, h, nq, nk = shape
    q, k, v = _qkv(11, b, h, nq, nk, dh)
    scale = dh ** -0.5
    kv_lens = None if lens is None else np.asarray(lens, np.int32)
    want = jax_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), scale=scale,
                     causal=causal, kv_lens=None if lens is None else jnp.asarray(kv_lens),
                     interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    qb, kb, vb = (t.to(torch.bfloat16) for t in _t(q, k, v))
    torch_lens = None if lens is None else torch.from_numpy(kv_lens)
    got = flash_attention(qb, kb, vb, scale=scale, causal=causal, kv_lens=torch_lens)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ref = flash_attention_plain(qb.float(), kb.float(), vb.float(), scale=scale, causal=causal,
                                kv_lens=torch_lens).numpy()
    tol = 2.0 ** -8 * np.abs(ref) + 2.0 ** -9 * np.abs(vb.float().numpy()).max()
    assert np.all(np.abs(got - ref) <= tol)
    assert np.all(np.abs(want - ref) <= tol)
    assert np.abs(got - want).max() <= np.abs(want - ref).max()


def test_zero_kv_len_follows_the_math_path():
    """kv_lens[b] == 0: every key masked, softmax uniform over all Nk keys, as
    xla_attention computes (the Pallas kernel averages over padded keys)."""
    q, k, v = _qkv(2, 2, 2, 40, 70)
    lens = np.asarray([0, 30], np.int32)
    allowed = (np.arange(70)[None, :] < lens[:, None])[:, None, None, :]
    want = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.2,
                         allowed=jnp.asarray(allowed))
    got = flash_attention(*_t(q, k, v), scale=0.2, kv_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(v[0].mean(1, keepdims=True),
                                                               got[0].shape), atol=ATOL)


def test_supported_gate():
    q, k, _ = _t(*_qkv(3))
    assert flash_attention_supported(q, k)
    assert flash_attention_supported(q, k, causal=True)
    assert not flash_attention_supported(q, k, allowed=torch.ones(2, 1, 1, 1, dtype=torch.bool))
    assert not flash_attention_supported(q[:, :, :1], k)  # single-query decode step
    assert not flash_attention_supported(q[:, :, :64], k, causal=True)  # Nq != Nk causal
    assert not flash_attention_supported(torch.zeros(1, 1, 4, 160), torch.zeros(1, 1, 4, 160))
    assert not flash_attention_supported(q, torch.zeros(1, 1, 4097, 64))
    assert not flash_attention_supported(q.half(), k.half())


def _offset_by_one(b, h, n, dh):
    """A (B, H, N, dh) bfloat16 tensor whose data starts 2 bytes past the
    allocation, so no row starts on 16 bytes."""
    return torch.zeros(b * h * n * dh + 1, dtype=torch.bfloat16)[1:].view(b, h, n, dh)


def _split(b, h, n, dh):
    return torch.zeros(b, n, h * dh, dtype=torch.bfloat16).view(b, n, h, dh).transpose(1, 2)


@pytest.mark.parametrize(
    "make_q, make_k, expected",
    [
        # bfloat16 rows off the 16-byte grid: the kernel takes them all
        (lambda: torch.zeros(2, 2, 70, 36, dtype=torch.bfloat16),
         lambda: torch.zeros(2, 2, 90, 36, dtype=torch.bfloat16), True),
        (lambda: _split(2, 4, 130, 36), lambda: _split(2, 4, 130, 36), True),
        (lambda: torch.zeros(2, 2, 70, 40, dtype=torch.bfloat16)[..., :36],
         lambda: torch.zeros(2, 2, 90, 40, dtype=torch.bfloat16)[..., :36], True),
        (lambda: _offset_by_one(2, 3, 130, 64), lambda: _offset_by_one(2, 3, 130, 64), True),
        (lambda: torch.zeros(1, 2, 70, 100, dtype=torch.bfloat16),
         lambda: torch.zeros(1, 2, 90, 100, dtype=torch.bfloat16), True),
        (lambda: torch.zeros(1, 2, 70, 64), lambda: torch.zeros(1, 2, 90, 64), True),
        # outside the gate in both packages
        (lambda: torch.zeros(1, 2, 70, 160, dtype=torch.bfloat16),
         lambda: torch.zeros(1, 2, 90, 160, dtype=torch.bfloat16), False),
        (lambda: torch.zeros(1, 2, 1, 36, dtype=torch.bfloat16),
         lambda: torch.zeros(1, 2, 90, 36, dtype=torch.bfloat16), False),
        (lambda: torch.zeros(1, 1, 8, 36, dtype=torch.bfloat16),
         lambda: torch.zeros(1, 1, 4097, 36, dtype=torch.bfloat16), False),
    ],
)
def test_gate_equals_the_jax_gate(make_q, make_k, expected):
    """The port routes to the kernel exactly the calls the JAX package routes
    to its Pallas kernel, whatever the head dim, strides or alignment of the
    bfloat16 rows (the kernel loads rows off 16 bytes element by element)."""
    q, k = make_q(), make_k()
    want = jax_flash_supported(jnp.zeros(q.shape, jnp.bfloat16), jnp.zeros(k.shape, jnp.bfloat16))
    assert want == expected
    assert flash_attention_supported(q, k) == expected


def test_flash_rejects_what_the_kernel_does_not_take():
    q, k, v = _t(*_qkv(4, nq=64, nk=300))
    with pytest.raises(ValueError, match="Nq == Nk"):
        flash_attention(q, k, v, scale=0.1, causal=True)
    with pytest.raises(ValueError, match="kv_lens"):
        flash_attention(q, k, v, scale=0.1, kv_lens=torch.zeros(3, dtype=torch.int32))


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor reaches the plain version: any other device gets the
    kernel or an error (here: a meta tensor, which no kernel takes)."""
    q = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q, scale=0.1)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("nq, nk", [(12, 12), (5, 9)])
def test_attention_core_matches_xla_attention(causal, nq, nk):
    q, k, v = _qkv(5, 2, 2, nq, nk, 32)
    rng = np.random.default_rng(6)
    allowed = rng.random((2, 1, nq, nk)) > 0.3
    allowed[0, 0, 1] = False  # a fully masked row: uniform softmax
    want = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.3,
                         allowed=jnp.asarray(allowed), causal=causal)
    got = attention_core(*_t(q, k, v), scale=0.3, allowed=torch.from_numpy(allowed),
                         causal=causal, use_flash=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("nq, nk", [(16, 16), (5, 9)])
def test_unmasked_attention_core_routes_alike(nq, nk):
    """Unmasked causal calls: flash for Nq == Nk, the right-aligned math path
    otherwise; both equal xla_attention."""
    q, k, v = _qkv(7, 1, 2, nq, nk, 64)
    want = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.125,
                         causal=True)
    got = attention_core(*_t(q, k, v), scale=0.125, causal=True, use_flash=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if nq == nk:
        np.testing.assert_array_equal(
            got.numpy(), flash_attention_plain(*_t(q, k, v), scale=0.125, causal=True).numpy()
        )
