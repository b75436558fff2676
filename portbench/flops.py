"""Model FLOPs from shapes, for the ``mfu.*`` metrics.

Counted: dense products 2 * m * n * k, convolutions by their kernels
(2 * output positions * C_out * C_in * kh * kw), attention
4 * H * Nq * Nk * dh at the valid lengths (a causal query at position i
sees i + 1 keys). Norms, activations, pooling and the softmax are not
counted. Nothing here depends on how the program computes: a kernel that
replaces another leaves these numbers as they are.
"""

from __future__ import annotations

from portbench.reference.model import DIM_HEAD, Arch


def _same_out(size: int, stride: int) -> int:
    return -(-size // stride)


def backbone_flops(arch: Arch, height: int, width: int) -> float:
    """The ResNet backbone of one (height, width) image, and its (h, w)."""
    h, w = _same_out(height, 2), _same_out(width, 2)
    total = 2.0 * h * w * arch.stem * arch.in_channels * 49
    h, w = _same_out(h, 2), _same_out(w, 2)  # max pool
    cin, stride_so_far = arch.stem, 4
    for i, (depth, cout) in enumerate(zip(arch.depths, arch.channels)):
        stage_stride = 1 if i == 0 or stride_so_far >= 32 else 2
        stride_so_far *= stage_stride
        mid = cout // 4
        for j in range(depth):
            s = stage_stride if j == 0 else 1
            c_in = cin if j == 0 else cout
            h_out, w_out = _same_out(h, s), _same_out(w, s)
            if j == 0:
                total += 2.0 * h_out * w_out * cout * c_in
            total += 2.0 * h * w * mid * c_in                # 1x1 at the input grid
            total += 2.0 * h_out * w_out * mid * mid * 9      # 3x3, strided
            total += 2.0 * h_out * w_out * cout * mid         # 1x1
            h, w = h_out, w_out
        cin = cout
    return total, (h, w)


def encoder_tokens(arch: Arch, height: int, width: int) -> int:
    _, (h, w) = backbone_flops(arch, height, width)
    return h * w + 1


def encoder_flops(arch: Arch, height: int, width: int) -> float:
    """One image through the encoder: backbone, projection, the stack."""
    total, (h, w) = backbone_flops(arch, height, width)
    n = h * w + 1
    d, inner = arch.enc_dim, arch.enc_heads * DIM_HEAD
    total += 2.0 * h * w * arch.channels[-1] * d
    per_layer = (3 * 2.0 * n * d * inner + 4.0 * n * n * inner + 2.0 * n * inner * 2 * d
                 + 2.0 * n * d * 2 * 4 * d + 2.0 * n * 4 * d * d)
    return total + arch.enc_layers * per_layer


def decoder_flops(arch: Arch, positions: int, enc_tokens: int) -> float:
    """``positions`` decoder positions of one sequence against
    ``enc_tokens`` encoder outputs, teacher-forced or step by step (the same
    products): the cross-attention K/V once, causal self-attention over the
    positions before and at each one, the logits at every position."""
    t, nk = positions, enc_tokens
    d, inner, hidden = arch.dec_dim, arch.dec_heads * DIM_HEAD, arch.dec_dim * arch.exp_factor
    causal_pairs = t * (t + 1) / 2
    per_layer = (
        3 * 2.0 * t * d * inner + 4.0 * causal_pairs * inner + 2.0 * t * inner * 2 * d  # self
        + 2.0 * t * d * inner + 2 * 2.0 * nk * d * inner + 4.0 * t * nk * inner       # cross
        + 2.0 * t * inner * 2 * d
        + 2.0 * t * d * 2 * hidden + 2.0 * t * hidden * d                              # MLP
    )
    return arch.dec_layers * per_layer + 2.0 * t * d * arch.vocab


def serve_flops(arch: Arch, height: int, width: int, decode_steps: int) -> float:
    """One image encoded and decoded for ``decode_steps`` steps."""
    return (encoder_flops(arch, height, width)
            + decoder_flops(arch, decode_steps, encoder_tokens(arch, height, width)))


def train_flops(arch: Arch, height: int, width: int, label_len: int) -> float:
    """One image of a training step whose label rows are ``label_len`` long
    (the decoder reads label_len - 1 positions): three times the forward."""
    return 3.0 * (encoder_flops(arch, height, width)
                  + decoder_flops(arch, label_len - 1, encoder_tokens(arch, height, width)))
