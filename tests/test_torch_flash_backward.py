"""The flash attention backward (``texocr_tpu_torch/ops/flash_attention.py``):
its plain version, its route, and, on a CUDA device, the kernel.

CPU: ``flash_attention_backward_plain`` is bit-equal to autograd's VJP of
``math_attention`` (float32 and bfloat16, Nq = Nk = 631, Nq = 379, Nq off the
64-row tile, dh 64 and 48, causal and not), and ``FlashAttentionFunction`` on
CPU tensors returns exactly the gradients its backward returned before the
kernel (that code is copied below as it stood). With a stub library, on
``meta`` tensors (which no kernel takes; the wrappers' device check is
stepped around, so that they reach ``launch`` and ``launch_backward``): under
``no_grad`` or ``inference_mode`` the forward asks for no row statistics and
calls the library exactly as before; with gradients a bfloat16 call at
dh <= 64 asks for them and its backward launches the kernel once, while
float32 and dh > 64 keep the math path's VJP.

Card (marked ``card``; each test skips without a CUDA device, decided inside
the test): the kernel against the plain version at the training shapes under
``ops.bench.backward_gaps``'s limits, which ``chip_smoke.py`` phase 3d shares.
On the card:

    python -m pytest tests/test_torch_flash_backward.py -m card --noconftest -q

(``--noconftest``: the repository's conftest imports JAX, which that machine
does not have; this file does not.)
"""

import types

import pytest
import torch

from texocr_tpu_torch import telemetry
from texocr_tpu_torch.ops import flash_attention as fa
from texocr_tpu_torch.ops.attention_core import math_attention
from texocr_tpu_torch.ops.bench import backward_gaps

torch.set_num_threads(1)

# (B, H, Nq, Nk, dh): the encoder's full canvas and (96, 1008) rows at one
# image, Nq and Nk off the 64-row tile, dh 48.
SHAPES = [(1, 2, 631, 631, 64), (1, 2, 379, 379, 64), (2, 2, 70, 90, 64),
          (2, 3, 130, 130, 48)]
CASES = [(shape, causal) for shape in SHAPES for causal in (False, True)
         if not causal or shape[2] == shape[3]]


def operands(shape, dtype, seed=0):
    b, h, nq, nk, dh = shape
    gen = torch.Generator().manual_seed(seed)

    def randn(n):
        return torch.randn(b, h, n, dh, generator=gen).to(dtype)

    return randn(nq), randn(nk), randn(nk), randn(nq)


def autograd_of_math(q, k, v, grad, scale, causal):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    return torch.autograd.grad(math_attention(q, k, v, scale=scale, causal=causal),
                               (q, k, v), grad)


# -- FlashAttentionFunction's backward before the kernel, copied as it stood ----------------


class ParentFlashAttentionFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        ctx.scale, ctx.causal = scale, causal
        ctx.save_for_backward(q, k, v)
        return fa.flash_attention(q, k, v, scale=scale, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = math_attention(q, k, v, scale=ctx.scale, causal=ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad_out)
        return dq, dk, dv, None, None


# -- CPU ---------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape, causal", CASES)
def test_plain_backward_is_autograd_of_math_attention(shape, causal, dtype):
    q, k, v, grad = operands(shape, dtype)
    scale = shape[-1] ** -0.5
    got = fa.flash_attention_backward_plain(q, k, v, grad, scale=scale, causal=causal)
    want = autograd_of_math(q, k, v, grad, scale, causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape, causal", [CASES[0], CASES[1], CASES[-1]])
def test_function_on_cpu_returns_the_gradients_it_returned_before(shape, causal, dtype):
    q, k, v, grad = operands(shape, dtype, seed=1)
    scale = shape[-1] ** -0.5
    grads = []
    for function in (fa.FlashAttentionFunction, ParentFlashAttentionFunction):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = function.apply(*leaves, scale, causal)
        out.backward(grad)
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        assert torch.equal(g, w)


def test_cpu_backward_wrapper_takes_the_plain_version():
    q, k, v, grad = operands(SHAPES[2], torch.bfloat16)
    got = fa.flash_attention_backward(q, k, v, None, None, grad, scale=0.125)
    for g, w in zip(got, autograd_of_math(q, k, v, grad, 0.125, False)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype, dh, expected", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 48, True), (torch.bfloat16, 8, True),
    (torch.bfloat16, 65, False), (torch.bfloat16, 128, False),
    (torch.float32, 64, False), (torch.float32, 32, False),
])
def test_routing_rule(dtype, dh, expected):
    """bfloat16 with dh <= 64 goes to the kernel; float32 or dh > 64 to the
    math path's VJP."""
    assert fa.flash_backward_supported(torch.empty(1, 2, 3, dh, dtype=dtype)) is expected


@pytest.mark.parametrize("nq, rows", [(1, 64), (63, 64), (64, 64), (379, 384), (631, 640)])
def test_lse_rows_round_up_to_the_tile(nq, rows):
    assert fa.lse_rows(nq) == rows


def test_row_statistics_are_refused_where_they_cannot_be_kept():
    q, k, v, _ = operands(SHAPES[2], torch.bfloat16)
    lse = torch.empty(2, 2, 128)
    with pytest.raises(ValueError, match="plain version keeps no row statistics"):
        fa.flash_attention(q, k, v, scale=0.125, lse=lse)
    fa._check_lse(q, lse)  # the shape the kernel fills
    with pytest.raises(ValueError, match="contiguous float32"):
        fa._check_lse(q, torch.empty(2, 2, 70))
    with pytest.raises(ValueError, match="bfloat16 calls with dh <= 64"):
        fa._check_lse(q.float(), lse)
    with pytest.raises(ValueError, match="bfloat16 calls with dh <= 64"):
        fa._check_lse(torch.empty(2, 2, 70, 96, dtype=torch.bfloat16), lse)


# -- the route, with a stub library --------------------------------------------------------


class StubLibrary:
    """Records each call of the library's entry points and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("texocr_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.fixture
def stub(monkeypatch):
    """A stub library behind the wrappers, whose device check is stepped
    around so that meta tensors reach ``launch`` and ``launch_backward``;
    records the keyword arguments of every ``launch`` and the plain
    backward's calls."""
    lib = StubLibrary()
    record = types.SimpleNamespace(lib=lib, launch_kwargs=[], plain_backward=0)
    inner_launch = fa.launch

    def launch(lib_, q, k, v, **kw):
        record.launch_kwargs.append(kw)
        return inner_launch(lib_, q, k, v, **kw)

    def plain(q, k, v, grad_out, **kw):
        record.plain_backward += 1
        return tuple(torch.empty_like(t) for t in (q, k, v))

    monkeypatch.setattr(fa, "launch", launch)
    monkeypatch.setattr(fa, "_library", lambda: lib)
    monkeypatch.setattr(fa, "_check_cuda", lambda name, *tensors: None)
    monkeypatch.setattr(fa, "flash_attention_backward_plain", plain)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=7))
    return record


def backward_launches() -> int:
    return telemetry.counters().get("flash_attention_backward.launches", 0)


def meta_operands(dtype=torch.bfloat16, dh=64, n=631):
    """Split-head views of (2, n, 8 * dh), as the encoder makes them."""
    return [torch.empty(2, n, 8 * dh, device="meta", dtype=dtype).view(2, n, 8, dh)
            .transpose(1, 2).requires_grad_() for _ in "qkv"]


def todays_forward_args(q, k, v, out, scale, causal):
    """The library arguments of a forward launch before the backward kernel."""
    b, h, nq, dh = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, b, h, nq,
            k.shape[2], dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], float(scale), int(causal), 1, 7)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no operand needs a gradient"])
def test_forward_without_gradients_launches_as_before(stub, mode):
    q, k, v = meta_operands()
    context = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
               "no operand needs a gradient": torch.enable_grad}[mode]
    if mode == "no operand needs a gradient":
        q, k, v = (t.detach() for t in (q, k, v))
    with context():
        out = fa.FlashAttentionFunction.apply(q, k, v, 0.125, True)
    assert stub.launch_kwargs == [{"scale": 0.125, "causal": True, "kv_lens": None}]
    assert stub.lib.calls == [("texocr_flash_attention_fwd",
                               todays_forward_args(q, k, v, out, 0.125, True))]


def test_bf16_with_gradients_keeps_row_statistics_and_takes_the_kernel(stub):
    q, k, v = meta_operands()
    before = backward_launches()
    out = fa.FlashAttentionFunction.apply(q, k, v, 0.125, False)
    (name, args), = stub.lib.calls
    assert name == "texocr_flash_attention_fwd_lse"
    assert args[:-2] == todays_forward_args(q, k, v, out, 0.125, False)[:-1]
    lse_args = stub.launch_kwargs[0]
    assert set(lse_args) == {"scale", "causal", "kv_lens", "lse"}
    assert lse_args["lse"].shape == (2, 8, 640) and lse_args["lse"].dtype == torch.float32
    grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert backward_launches() == before + 1
    assert stub.plain_backward == 0
    name, args = stub.lib.calls[-1]
    assert name == "texocr_flash_attention_bwd" and len(args) == 42
    assert args[10:15] == (2, 8, 631, 631, 64)
    # Each gradient keeps its operand's strides, so the heads merge back without a copy.
    assert [g.stride() for g in grads] == [t.stride() for t in (q, k, v)]
    assert args[15:18] == q.stride()[:3]


@pytest.mark.parametrize("dtype, dh", [(torch.float32, 64), (torch.bfloat16, 96)])
def test_float32_and_wide_heads_keep_the_math_vjp(stub, dtype, dh):
    q, k, v = meta_operands(dtype, dh)
    before = backward_launches()
    out = fa.FlashAttentionFunction.apply(q, k, v, 0.125, False)
    assert stub.launch_kwargs == [{"scale": 0.125, "causal": False, "kv_lens": None}]
    torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert backward_launches() == before
    assert stub.plain_backward == 1
    assert [name for name, _ in stub.lib.calls] == ["texocr_flash_attention_fwd"]


# -- the card: the kernel against the plain version ------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(128, 8, 631, 64), (128, 8, 379, 64), (64, 8, 631, 64),
                                   (32, 4, 631, 64), (2, 3, 130, 48)],
                         ids=lambda s: "x".join(map(str, s)))
def test_card_backward_matches_the_plain_version(cuda, shape, causal):
    b, h, n, dh = shape
    gen = torch.Generator(device=cuda).manual_seed(n + dh)

    def split(rows):  # (B, H, N, dh) views of (B, N, H * dh), as the encoder makes them
        x = torch.randn(b, rows, h * dh, device=cuda, generator=gen).to(torch.bfloat16)
        return x.view(b, rows, h, dh).transpose(1, 2)

    q, k, v, grad = split(n), split(n), split(n), split(n)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = backward_launches()
    got = torch.autograd.grad(fa.FlashAttentionFunction.apply(*leaves, dh ** -0.5, causal),
                              leaves, grad)
    assert backward_launches() == before + 1
    plain = fa.flash_attention_backward_plain(q, k, v, grad, scale=dh ** -0.5, causal=causal)
    ref = fa.flash_attention_backward_plain(q.float(), k.float(), v.float(), grad.float(),
                                            scale=dh ** -0.5, causal=causal)
    gaps = backward_gaps(got, plain, ref)
    assert gaps["ok"], gaps
    assert [g.stride() for g in got] == [t.stride() for t in (q, k, v)]
