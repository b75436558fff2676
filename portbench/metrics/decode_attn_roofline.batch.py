"""The decode-attention kernel's share of its roofline in the traced batch:
the least time of its work, its bytes at 3.35 TB/s (``portbench/roofline.py``),
over the device time of the kernels whose name contains ``decode_attention``.

The bytes come from the configuration and the mix, for every step t and
every decoder layer, each counted once: the cross-attention K/V in their
stored type with their int8 scales; the self-attention cache's positions
0..t in their stored type (with int8 self caches the prefix below
t0 = t - t mod chunk as int8 with one K and one V scale a position, and the
positions from t0 in the compute type); q and the output of both attentions.
Nothing when the kernels are not a multiple of 2 x layers x steps, or the mix
decodes other than greedily."""

from portbench import flops
from portbench.reference.model import CHUNK, DIM_HEAD, Arch
from portbench.roofline import H100_BYTES_PER_S

ELEMENT = {"bfloat16": 2, "float32": 4}


def decode_bytes(cfg: dict, mix: dict) -> float:
    """Bytes the decode attention needs over a batch of ``mix``'s steps."""
    arch = Arch.from_config(cfg)
    elem = ELEMENT[cfg.get("dtype", "bfloat16")]
    rows, steps = mix["batch"], mix["max_len"]
    chunk = min(CHUNK, steps)
    heads, nk = arch.dec_heads, flops.encoder_tokens(arch, *mix["canvas"])
    row = rows * heads * DIM_HEAD  # elements of one position of one cache, all heads
    if arch.kv_bits:
        cross = 2 * row * nk + 2 * rows * heads * DIM_HEAD * elem
    else:
        cross = 2 * row * nk * elem
    total = 0.0
    for t in range(steps):
        if arch.self_kv_bits:
            t0 = t - t % chunk
            own = 2 * row * t0 + 2 * rows * heads * t0 * elem + 2 * row * (t + 1 - t0) * elem
        else:
            own = 2 * row * (t + 1) * elem
        total += arch.dec_layers * (cross + own + 2 * 2 * row * elem)
    return total


def read(run):
    steps = run.counters.get("decode_steps")
    if run.slice is None or not steps or run.cell.mix.get("mode") != "greedy":
        return None
    kernels = run.slice.kernels("decode_attention")
    layers = Arch.from_config(run.model_config).dec_layers
    if not kernels or len(kernels) % (2 * layers * steps):
        return None
    device_ms = sum(b - a for _, a, b in kernels) * 1e-6
    least_ms = decode_bytes(run.model_config, run.cell.mix) / H100_BYTES_PER_S * 1e3
    return 100.0 * least_ms / device_ms
