#!/usr/bin/env python3
"""Gates the PyTorch/CUDA port (texocr_tpu_torch) on one NVIDIA GPU, and times
its kernels for PERF.md's kernel table.

    python3 chip_smoke.py

End-to-end numbers (latency, images/s, step time, MFU, idle share) come from
portbench/ alone; this script times only kernels. Phases, each fatal on
failure (phases 15-18 run before 14):
  1. device: a CUDA device must be present; prints its name and power limit.
  2. build: compiles the flash source and counts tensor-core instructions in
     the built library (cuobjdump -sass): all twelve instantiations of the
     flash kernels must hold as many HGMMA (wgmma) instructions as their
     loops issue (HGMMA below): the bfloat16 forward (head dim 64 or 128;
     rows on 16 bytes or not; at 64 also with the row statistics the
     backward reads), float32 (3xTF32; head dim 64 or 128), and the
     bfloat16 backward's two launches (rows on 16 bytes or not). Prints
     ptxas's registers, spills and warnings and the blocks per SM.
  3. kernels: the flash forward against its plain version at test shapes
     (masks, ragged tiles, head dims, row alignments) and at every shape of
     the serving, training, per-rank and curriculum paths: float32 within
     F32_TOL, bfloat16 within max(2 x the plain bf16 version's error from
     float32, BF16_FLOOR), any other layout bit-equal to contiguous copies.
     Table: at each FLASH_TIMED shape, the kernel's, the plain version's
     and scaled_dot_product_attention's ms, L2-warm and cold, beside the
     bound and the library's kernels.
 3d. flash backward: the bf16 backward kernel through FlashAttentionFunction
     against the plain bf16 VJP and the float32 VJP of the same operands at
     BACKWARD_SHAPES, causal and not, and at edge cases (ragged tiles,
     Nq != Nk, dh 48, 40 and 36, rows off 16 bytes), within
     ops.bench.backward_gaps's limits; one backward launch a call, the
     forward's output unchanged by its statistics, gradients in their
     operands' strides, row statistics within LSE_TOL of float32's. Table:
     at BACKWARD_TIMED, its ms beside its bound, the plain version (the math
     path's VJP), the forward with and without statistics and
     scaled_dot_product_attention's backward.
 3b. decode attention: the decode step's kernel against its plain version
     at ops.bench.DECODE_CASES, each on DA_SEEDS seeds, within
     ops.bench.decode_gaps's limits, one launch a call. Prints ptxas's
     registers per instantiation. Table: at DA_TIMED, its ms beside its
     bound (bytes), the plain version and scaled_dot_product_attention.
 3c. routed experts: the Triton expert kernels against the expert loop at
     decode's (1,536 rows) and prefill's (245,760) shapes within MOE_TOL; a
     3-layer model at Kimi-VL-A3B's widths whose 8-chunk graphs' tokens are
     bit-equal to the eager decode's, 2 launches an expert layer a step and
     prefill and every routed row counted; kimivl.batch's own path (TexOCR
     with portbench/configs/kimi-vl-a3b.json whole, its state dict taken in
     place, generate_batch on 256 full canvases x 256 steps): a replayed
     call launches 2 x 26 x (1 + 256) times, routes 256 x (160 + 256) x 6 x
     26 rows and serves no EOS. Table: the kernels' ms beside their bound,
     routed_plain's at decode and the expert loop's.
  4. golden: the committed reference goldens in float32 on the kernel path:
     exact greedy tokens, encoder output within 1e-4; the float32 kernel's
     launches.
  5. serve: TexOCR (the flagship at full width, bf16, seeded weights) on
     single requests of three bucket sizes and a batch of 8 full canvases,
     each key captured first and then replayed once: valid ids, 4 flash
     launches an encode and 8 decode attention launches a decoded step.
 6b. graphs: make_graphed_generate on the serving batch in greedy, int8,
     beam 5 and sampling: tokens (and beam's scores) bit-equal to the eager
     decode's from the same generator state, two sampled calls that differ,
     4 flash launches an encode on replays; the float32 golden model's
     greedy tokens exact through the float-input graphs.
  7. encoder: the full-canvas float32 encoder, kernel path against plain.
  8. train: train_model on the flagship in bf16 with config/config.yml's
     training keys on a synthetic dataset, 2 epochs: encoder gradients on
     the kernel path against the plain path (float32 within GRAD_TOL, bf16
     within max(2 x the bf16 plain path's distance, BF16_FLOOR)), finite
     epoch losses that fall, 4 flash launches a train and eval step and 4
     backward launches a train step, two steps after loading the checkpoint
     equal to two without the save.
 8b. device data: train_model with the dataset resident on the card and
     augmented there: finite falling losses, the launches of phase 8, a
     resume with the same step and weights; then RESIDENT_ROWS full
     canvases staged at pack_bits 8 and 4, each beside one finite call of
     DD_STEPS_PER_CALL steps, the 4-bit gather within PACK4_TOL of the 8-bit
     one and exact at 0 and 1.
  9. int8: int8 cross and self caches on 8 full canvases: step logits within
     INT8_BUDGET of the unquantized caches', 4 flash launches and 8 decode
     attention launches a decoded step.
 10. sample: float32 at temperature 1e-4 leaves greedy only where the top
     two logits lie within 20 x temp; bf16 at 0.3: every token in its step's
     top TOPK; 4 flash launches an encode.
 11. beam: bf16 beam 5 through the graphs (4 flash launches); float32 with
     and without int8 self-KV: beam 1 equals greedy, beam 5's scores equal
     its tokens' log-prob within SCORE_RTOL.
 12. http: the HTTP server over the micro-batcher: a solo POST equals
     engine(img), 32 POSTs (grey and RGB PNGs filtered as PIL writes them)
     at concurrency 8 answer valid JSON, decode_image gives back each
     canvas, /healthz and a 400 for no image; 4 flash launches an encode.
 13. eval: test_model greedy and beam 5 through its CUDA graphs: metrics
     equal to generate_batch's on the same batches, pairs_out tokens
     bit-equal to the eager generate's, 4 flash launches an encode (replays
     and each key's capture warm-up).
 13b. variants: patch and glu false through the graphs, bit-equal to eager,
     4 launches an encode, float32 encode within F32_TOL of the plain path;
     no cross: finite train losses, no flash launch, every decode entry
     point raises ValueError; maps: the cross maps' shape, rows summing to 1,
     no flash launch; the attention-maps tool writes its overlays.
 15. data (no PIL, PyYAML or regex): the g++-built BPE encoder on the
     goldens in one native call, a retrain equal to the golden merges, the
     native ids equal to pure Python's on ENCODE_LABELS labels; split_data,
     render_data, prune_equations, pickle_data eager and lazy; training.cli
     on each: one epoch, finite losses, 4 flash launches an encode, lazy
     batches equal to eager.
 16. parallel: (a) an NCCL world of one: phase 8's losses within
     WORLD1_RTOL, 4 launches a step; (b) two ranks on cuda:0 over gloo:
     losses within PARALLEL_BF16_RTOL of one process's under {data: 2} and
     {model: 2}, 4 launches a step, the kernel at each rank's shapes, the
     float32 decodes' tokens equal to one process's with 4 launches; (c)
     dryrun_multichip(2).
 17. tools: make_demo_dataset's ImportErrors and build, pickle_partial_typeset
     on a torn build; a fixed batch without and with remat: losses within
     BF16_FLOOR, 4 and 8 flash launches a step, 4 backward in both;
     demo_train plain and stage W: finite losses, its launches a train step
     and 4 an encode in test_model, the JAX tool's metrics keys;
     train_curriculum --dry_run chains the port's tools.
 18. orbax: the JAX-written fixture bit-equal to its seed; phase 8's
     checkpoint in the JAX layout read back bit-equal; train_model resumed
     from it and from state.pt with equal losses and 4 launches a step;
     TexOCR from each serving bit-equal tokens with 4 launches.
 14. launched shapes: every flash launch signature that phases 4-18 made
     and phase 3 did not check, held against the plain version here.
Launch gates read changes of the program's telemetry counters (COUNTED)
across the calls they count; a CUDA graph's replay adds the counts its
capture held back. Then the seconds each phase took, one JSON line of the
table's numbers and launch counts (``kernels``), the card's name and power
limit, and the last line {"ok": true, "device": {...}}.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
from texocr_tpu_torch import telemetry  # noqa: E402
from texocr_tpu_torch.ops.bench import (  # noqa: E402
    SERVING_SHAPES,
    attention_bound_ms,
    attention_f64,
    device_kernel_names,
    split_heads,
    time_ms,
)

# HGMMA per instantiation of the flash kernels, by head dim D: one per wgmma of
# the unrolled loops. bfloat16 forward (<D, VEC, LSE>; LSE, the row statistics
# for the backward, only at D = 64): Q K^T in D / 16 k-steps, P V in 4 k-steps
# x D / 64 column blocks. float32: three TF32 products each, Q K^T in D / 8
# k-steps, P V in 8 k-steps x D / 64 column blocks. bfloat16 backward (<VEC>,
# D = 64): 4 k-steps a product, three in the dQ launch (S, dP, dQ) and four in
# the dK, dV launch (S^T, dP^T, dV, dK).
HGMMA = {
    **{f"flash_fwd_bf16<{d}, {vec}, {lse}>": d // 16 + 4 * d // 64
       for d in (64, 128) for vec in ("true", "false") for lse in ("true", "false")
       if d == 64 or lse == "false"},
    **{f"flash_fwd_f32<{d}>": 3 * (d // 8 + 8 * d // 64) for d in (64, 128)},
    **{f"flash_bwd_dq_bf16<{vec}>": 3 * 4 for vec in ("true", "false")},
    **{f"flash_bwd_dkdv_bf16<{vec}>": 4 * 4 for vec in ("true", "false")},
}
BATCH = 8  # full canvases per batch
DECODE_STEPS = 350  # the serving default max_len; random weights never emit EOS
TRAIN_BATCH = 128  # config/config.yml batch_size
TRAIN_BUCKETS = (((160, 1008), 2), ((64, 512), 1))  # (canvas, batches) of the train split
TRAIN_EPOCHS = 2
DD_BUCKETS = (((160, 1008), 8), ((64, 512), 2))  # phase 8b's train split: 10 steps an epoch
DD_STEPS_PER_CALL = 16  # device_data_steps_per_call, and the steps beside the resident bucket
RESIDENT_ROWS = 50_000  # phase 8b's staged (160, 1008) bucket
RESIDENT_DISTINCT = 256  # distinct canvases among its rows
PACK4_TOL = 15.5 / 255  # 4-bit gather against the 8-bit one (tests/test_device_data.py)
GRAD_IMAGES = 8  # full canvases of the kernel-path against plain-path gradient check
GRAD_TOL = 1e-4  # relative L2 error of every encoder parameter's float32 gradient
BF16_FLOOR = 2e-2  # least bfloat16 tolerance: kernel outputs and gradients
F32_TOL = 1e-4  # float32 kernel output against its plain version
RESUME_RTOL = 1e-4  # two steps after a checkpoint load against two without the save
N_LAYERS = 4  # the flagship encoder's self-attention layers: flash launches per encode
INT8_BUDGET = 0.05  # int8 step logits: max error / max |logit| (tests/test_generate.py)
SAMPLE_CHECK_STEPS = 64  # float32 sampling at temperature 1e-4 against greedy
TOPK = 99  # topk_filter's k at V = 1000
BEAM = 5
BEAM_CHECK_STEPS = 64  # two whole chunks: a beam's score covers exactly its tokens
SCORE_RTOL = 2e-4  # beam score against its tokens' log-prob (tests/test_generate.py)
HTTP_REQUESTS = 32
HTTP_CONCURRENCY = 8
EVAL_BATCH = 8
EVAL_MAX_LEN = 276  # evaluation's decode budget (test_model's default)
VARIANT_TRAIN_STEPS = 3  # the no-cross variant's train steps
MAPS_TOKENS = DECODE_STEPS + 1  # BOS and a full decode, as the attention-maps tool replays it
MAPS_PNGS = 8  # the attention-maps tool's --max_tokens on the card
PARALLEL_STEPS = 2  # train steps per mesh of phase 16b
PARALLEL_BATCHES = {"data": 128, "model": 32}  # phase 16b's global batch per mesh
PARALLEL_DECODE = (2, 32)  # phase 16b's float32 decode: full canvases, steps
WORLD1_RTOL = 5e-4  # phase 16a's epoch losses against phase 8's (bf16; atomics reorder sums)
PARALLEL_BF16_RTOL = 1e-3  # phase 16b's bf16 losses against the single process's
PARALLEL_SAMPLE_SEED = 16  # phase 16b's sampling generator, the same in every process
# Phase 16b's float32 decodes: greedy, sampling at 0.3, beam 5, and greedy
# with int8 cross and self caches.
PARALLEL_DECODE_MODES = ("greedy", "sample", "beam", "int8")
# Phase 3's timed flash forward shapes (B, H, N, dh), split-head: the
# serving path's in both types; in bfloat16 also the training batch, phase
# 16's ranks ({data: 2} at batch 128, {model: 2} at 32) and phase 17's
# curriculum batch.
FLASH_TIMED = {torch.bfloat16: [*SERVING_SHAPES, (128, 8, 631, 64), (64, 8, 631, 64),
                                (32, 4, 631, 64), (32, 8, 631, 64)],
               torch.float32: SERVING_SHAPES}
EAGER_ITERS = 3  # timed eager calls of what a CUDA graph cannot capture
# The telemetry counters the launch gates read, by short name.
COUNTED = {"flash": "flash_attention.launches", "backward": "flash_attention_backward.launches",
           "decode": "decode_attention.launches", "moe": "moe_experts.launches",
           "keys": "graphs.keys"}
# The backward kernel's shapes, (B, H, N) at dh 64: base.train's full
# canvases and (96, 1008) rows, phase 16's ranks; the first two are timed.
BACKWARD_SHAPES = ((128, 8, 631), (128, 8, 379), (64, 8, 631), (32, 4, 631))
BACKWARD_TIMED = BACKWARD_SHAPES[:2]
LSE_TOL = 1e-4  # the kernel's base-2 row log-sum-exp against float32's (ex2.approx, sums)
# Phase 16's per-rank encoder attention, (B, H, N, dtype): {data: 2} at batch
# 128, {model: 2} at batch 32, the float32 decodes' encode of 2 canvases
# under {model: 2} and of 1 under {data: 2}, and the dry run's 32 x 64 images
# on 2 ranks.
RANK_SHAPES = ((64, 8, 631, torch.bfloat16), (32, 4, 631, torch.bfloat16),
               (2, 4, 631, torch.float32), (1, 8, 631, torch.float32),
               (2, 8, 9, torch.float32))
# Phase 3b: the DECODE_CASES calls timed, and the seeds each call is checked on.
DA_TIMED = ("cross (256, 8, 631) bf16", "cross (256, 8, 631) int8", "self (256, 8) t 255",
            "self (256, 8) t 255 split 224", "cross (16, 8, 631) bf16", "cross (16, 8, 631) int8",
            "cross (16, 8, 129) bf16")
DA_SEEDS = 6
# Phase 3c: the routed-expert kernels at Kimi-VL-A3B's widths (64 experts of
# 1408 over hidden 2048, 6 chosen a token): decode's 256 tokens (1,536 rows)
# and prefill's 256 x 160 (245,760 rows); the gate on the kernels against
# their plain arithmetic (max |difference| / max |output|: float32 sums in
# another order, the intermediate rounded to bfloat16 on both sides); and the
# 8-chunk graphs of a 3-layer model at those widths (1 dense, 2 expert layers).
MOE_SHAPES = {"decode": 256, "prefill": 256 * 160}
MOE_WIDTHS = (64, 1408, 2048, 6)  # experts, expert width, hidden, chosen a token
MOE_TOL = 5e-3
MOE_GRAPH_LAYERS = 3
MOE_GRAPH_BATCH = 8
MOE_GRAPH_STEPS = 256
# kimivl.batch's shape through TexOCR.generate_batch: 256 canvases of
# (160, 1008), 256 greedy steps; a replayed call checked.
MOE_MAIN_BATCH = 256
MOE_MAIN_STEPS = 256
ORBAX_FIXTURE = os.path.join(REPO, "tests", "goldens", "jax_orbax_fixture")
ORBAX_FIXTURE_SEED = 13
ORBAX_RESUME_RTOL = RESUME_RTOL  # phase 18's resumed epoch from the JAX layout against state.pt's


def orbax_fixture_tree(seed=ORBAX_FIXTURE_SEED) -> dict:
    """The tree of tests/goldens/jax_orbax_fixture/checkpoint_e3, from
    ``seed`` with numpy alone, as the port's orbax reader gives it back.
    JAX's orbax_io.save_checkpoint wrote it (tests/test_torch_port_orbax.py,
    ``write_fixture``) with ``sharded`` over a 2 x 2 mesh (four chunks),
    ``half`` as bfloat16 (these uint16 bits: the port reads a
    ``torch.bfloat16`` view of them), ``table`` past the store's inline limit
    (its chunk lies in a data file), and ``opt_state`` as the state of Adam
    with a global-norm clip and a schedule (``EmptyState`` is None)."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    params = {"dense": {"kernel": f32(4, 8), "bias": f32(8)}, "sharded": f32(8, 16),
              "table": f32(32, 64), "half": (f32(6, 5).view(np.uint32) >> 16).astype(np.uint16),
              "ids": rng.integers(-2 ** 31, 2 ** 31 - 1, (3, 4), dtype=np.int32),
              "wide": rng.integers(-2 ** 62, 2 ** 62, (5,), dtype=np.int64)}
    moments = [{"kernel": f32(4, 8), "bias": f32(8)} for _ in range(2)]
    count = np.asarray(5, np.int32)
    adam = {"count": count, "mu": {"dense": moments[0]},
            "nu": {"dense": {k: np.abs(v) for k, v in moments[1].items()}}}
    return {"params": params, "epoch": 3, "opt_state": [None, adam, {"count": count.copy()}],
            "step": 1234}


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def sass_ops(library) -> dict:
    """Per kernel in the built library, its count of tensor-core (HGMMA:
    wgmma; HMMA: mma.sync) and float32 FMA instructions (cuobjdump -sass)."""
    from texocr_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library)], check=True, capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :", 1)[1].strip()
            m = re.search(r"(flash_(?:fwd|bwd)_\w+?)I((?:L[ib]\d+E)+)E", mangled)
            name = mangled
            if m:  # e.g. flash_fwd_bf16<D, VEC, LSE>, flash_fwd_f32<D>, flash_bwd_dq_bf16<VEC>
                args = [v if t == "i" else ("true" if v == "1" else "false")
                        for t, v in re.findall(r"L([ib])(\d+)E", m.group(2))]
                name = f"{m.group(1)}<{', '.join(args)}>"
            counts[name] = dict.fromkeys(("HGMMA", "HMMA", "FFMA"), 0)
        elif name is not None:
            for op in re.findall(r"\b(HGMMA|HMMA|FFMA)\b", line):
                counts[name][op] += 1
    return counts


def flash_inputs(gen, b, h, nq, nk, dh, dtype, layout):
    """q, k, v on the card. ``dense``: contiguous (B, H, N, dh). ``split``:
    views split from (B, N, H * dh), as the encoder makes them. ``slice``:
    the first dh columns of a (B, H, N, dh rounded up to 8) tensor, so rows
    start on 16 bytes but the last 16-byte chunk of a row is partly outside
    dh. ``offset``: dense q and k, and a v that starts one element (2 or 4
    bytes) past a 16-byte boundary."""
    if layout == "split":
        return tuple(split_heads(gen, b, h, n, dh, dtype) for n in (nq, nk, nk))
    if layout == "slice":
        pad = -(-dh // 8) * 8
        return tuple(torch.randn(b, h, n, pad, device="cuda", generator=gen).to(dtype)[..., :dh]
                     for n in (nq, nk, nk))
    q, k, v = (torch.randn(b, h, n, dh, device="cuda", generator=gen).to(dtype)
               for n in (nq, nk, nk))
    if layout == "offset":
        v = torch.randn(v.numel() + 1, device="cuda", generator=gen).to(dtype)[1:].view(v.shape)
    return q, k, v


def check_flash_kernel(fa, gen) -> dict:
    """Kernel vs plain on the card; returns each dtype's error at the serving
    shape (8, 8, 631, 64) in the split-head layout.

    Every layout but ``dense`` (``flash_inputs``) must also give exactly what
    the kernel gives on contiguous copies of the same values: its arithmetic
    depends neither on the strides nor on which loader (16-byte copies, or
    element by element for rows off 16 bytes) the launch picks. float32
    (3xTF32 on the tensor cores) is held to 1e-4 of the plain version, and at
    the serving shape its error against float64 is printed beside the plain
    float32 version's; bfloat16 is held with the plain bf16 version to the
    float32 plain version on the same bf16 inputs: max(2 x plain error, 2e-2)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # (B, H, Nq, Nk, dh, causal, kv_lens, dtype, layout)
        (2, 3, 200, 200, 64, False, None, f32, "dense"),
        (2, 3, 200, 200, 64, True, None, f32, "dense"),
        (2, 3, 64, 300, 64, False, None, f32, "dense"),
        (3, 3, 96, 160, 64, False, [160, 100, 1], f32, "dense"),
        (2, 2, 130, 130, 64, True, [0, 7], f32, "dense"),
        (2, 2, 70, 90, 128, False, None, f32, "dense"),
        (8, 8, 631, 631, 64, False, None, f32, "dense"),
        (8, 8, 631, 631, 64, False, None, bf16, "dense"),
        (8, 8, 631, 631, 64, False, None, f32, "split"),
        (8, 8, 631, 631, 64, False, None, bf16, "split"),  # serving: 8 full canvases
        # bfloat16 masks, ragged tiles and head dims
        (2, 3, 130, 130, 64, True, None, bf16, "dense"),
        (3, 3, 96, 160, 64, False, [160, 100, 1], bf16, "dense"),
        (2, 2, 130, 130, 64, True, [0, 7], bf16, "dense"),
        (2, 3, 64, 300, 64, False, None, bf16, "dense"),
        (2, 2, 70, 90, 32, False, None, bf16, "dense"),
        (2, 2, 70, 90, 128, False, None, bf16, "dense"),
        (2, 4, 200, 200, 128, True, None, bf16, "split"),
        # bfloat16 rows off the 16-byte grid (element-wise loader) and row
        # tails inside a 16-byte chunk (16-byte loader, partial last copy)
        (2, 2, 70, 90, 36, False, None, bf16, "dense"),
        (2, 2, 70, 90, 40, False, None, bf16, "dense"),
        (2, 4, 130, 130, 36, True, None, bf16, "split"),
        (2, 2, 70, 90, 36, False, [90, 5], bf16, "slice"),
        (2, 2, 70, 90, 100, False, None, bf16, "dense"),
        (2, 2, 70, 90, 100, False, None, bf16, "slice"),
        (2, 3, 130, 130, 64, True, None, bf16, "offset"),
        # float32 head dims, rows off 16 bytes (element-wise loader) and row
        # tails inside a 16-byte chunk
        (2, 2, 70, 90, 36, False, None, f32, "dense"),
        (2, 2, 70, 90, 32, False, None, f32, "dense"),
        (2, 2, 70, 90, 33, False, [90, 5], f32, "dense"),
        (2, 2, 70, 90, 34, False, [90, 5], f32, "slice"),
        (2, 4, 200, 200, 128, True, None, f32, "split"),
        (2, 3, 130, 130, 64, True, None, f32, "offset"),
        (2, 2, 70, 90, 100, False, None, f32, "offset"),
        # the serving path's single requests at the three buckets
        (1, 8, 631, 631, 64, False, None, bf16, "split"),
        (1, 8, 193, 193, 64, False, None, bf16, "split"),
        (1, 8, 17, 17, 64, False, None, bf16, "split"),
        (1, 8, 631, 631, 64, False, None, f32, "split"),
        (1, 8, 193, 193, 64, False, None, f32, "split"),
        (1, 8, 17, 17, 64, False, None, f32, "split"),
        # the training path's batches: full canvases and the (64, 512) bucket
        (128, 8, 631, 631, 64, False, None, bf16, "split"),
        (128, 8, 129, 129, 64, False, None, bf16, "split"),
        # phase 16's per-rank shapes: {data: 2} at batch 128, {model: 2} at
        # batch 32 and its float32 decode of 2 canvases, the dry run's encode
        *((b, h, n, n, 64, False, None, dtype, "split") for b, h, n, dtype in RANK_SHAPES),
        # phase 17's curriculum batch of 32 full canvases
        (32, 8, 631, 631, 64, False, None, bf16, "split"),
    ]
    errors = {}
    for b, h, nq, nk, dh, causal, lens, dtype, layout in cases:
        q, k, v = flash_inputs(gen, b, h, nq, nk, dh, dtype, layout)
        kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        scale = dh ** -0.5
        got, plain, err, ok, note = hold_kernel(fa, q, k, v, scale, causal, kv_lens)
        if dtype == f32 and layout == "split" and (b, h, nq, dh) == SERVING_SHAPES[0]:
            exact = attention_f64(q, k, v, scale)
            note += (f"; max|kernel-f64| {(got.double() - exact).abs().max().item():.3e}, "
                     f"max|plain-f64| {(plain.double() - exact).abs().max().item():.3e}")
        if layout != "dense":
            dense = fa.flash_attention(*(t.clone(memory_format=torch.contiguous_format)
                                         for t in (q, k, v)),
                                       scale=scale, causal=causal, kv_lens=kv_lens)
            stride_diff = (got.float() - dense.float()).abs().max().item()
            ok = ok and stride_diff == 0
            note += f"; max|{layout}-contiguous| {stride_diff:.3e} (must be 0)"
        log(f"[kernels] flash_attention {(b, h, nq, nk, dh)} causal={causal} "
            f"kv_lens={lens} {str(dtype)[6:]} {layout} strides={q.stride()}/{v.stride()} "
            f"v%16={v.data_ptr() % 16}: {note} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash attention kernel disagrees with its plain version")
        if layout == "split" and (b, h, nq, dh) == SERVING_SHAPES[0]:
            errors[dtype] = err
    return errors


def hold_kernel(fa, q, k, v, scale, causal=False, kv_lens=None):
    """The kernel against its plain version on the same operands: float32
    within F32_TOL, bfloat16 as ``hold_bf16`` holds it. Returns (the kernel's
    output, the plain version's, the error, whether it holds, a note)."""
    got = fa.flash_attention(q, k, v, scale=scale, causal=causal, kv_lens=kv_lens)
    torch.cuda.synchronize()
    plain = fa.flash_attention_plain(q, k, v, scale=scale, causal=causal, kv_lens=kv_lens)
    if q.dtype == torch.float32:
        err = (got - plain).abs().max().item()
        ok, note = err <= F32_TOL, f"max|kernel-plain| {err:.3e} (tol {F32_TOL:g})"
    else:
        err, tol, note = hold_bf16(fa, got, plain, q, k, v, scale, causal, kv_lens)
        ok = err <= tol
    return got, plain, err, ok and bool(torch.isfinite(got).all()), note


class LaunchLog:
    """Every flash launch's operands, by the phase that made it: ``fa.launch``
    is wrapped so that each launch records its signature (shapes, type,
    strides, alignment, scale, causal, kv_lens) under ``phase``. The wrapper's
    own count is untouched. ``check_launched`` then holds the kernel against
    its plain version at every signature a driven path launched."""

    def __init__(self, fa):
        self.phase = None
        self.seen = {}  # signature -> [phases, first kv_lens]
        original = fa.launch

        def launch(lib, q, k, v, *, scale, causal=False, kv_lens=None, **kw):
            key = (tuple(q.shape), k.shape[2], str(q.dtype)[6:], float(scale), bool(causal),
                   tuple(t.stride() for t in (q, k, v)),
                   tuple(t.data_ptr() % 16 // t.element_size() for t in (q, k, v)),
                   kv_lens is not None)
            entry = self.seen.setdefault(
                key, [set(), None if kv_lens is None else kv_lens.clone()])
            entry[0].add(self.phase)
            return original(lib, q, k, v, scale=scale, causal=causal, kv_lens=kv_lens, **kw)

        fa.launch = launch


def strided_operand(gen, shape, stride, offset, dtype) -> torch.Tensor:
    """Random values on the card in a tensor of exactly these strides, that
    starts ``offset`` elements past a 16-byte boundary."""
    span = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
    base = torch.empty(span + offset, dtype=dtype, device="cuda")
    t = base.as_strided(shape, stride, offset)
    t.copy_(torch.randn(shape, device="cuda", generator=gen).to(dtype))
    return t


def check_launched(fa, gen, launch_log) -> dict:
    """Phase 14: the kernel against its plain version at every launch
    signature of the later phases that phase 3 did not check, on fresh operands of
    the same shapes, strides and alignment. Returns, per type, the count of
    signatures launched, those phase 3 checked and those checked here."""
    driven = {key: entry for key, entry in launch_log.seen.items() if entry[0] - {"kernels"}}
    summary = {}
    for key, (phases, lens) in sorted(driven.items(), key=str):
        shape, nk, dtype, scale, causal, strides, offsets, _ = key
        row = summary.setdefault(dtype, {"launched": 0, "checked_in_phase_3": 0,
                                         "checked_here": 0})
        row["launched"] += 1
        where = sorted(phases - {"kernels"})
        if "kernels" in phases:
            row["checked_in_phase_3"] += 1
            log(f"[launched] {shape} x Nk {nk} {dtype} strides {strides} (by {where}): "
                f"checked in phase 3")
            continue
        b, h, _, dh = shape
        operands = [strided_operand(gen, (b, h, n, dh), st, off, getattr(torch, dtype))
                    for n, st, off in zip((shape[2], nk, nk), strides, offsets)]
        _, _, _, ok, note = hold_kernel(fa, *operands, scale, causal, lens)
        row["checked_here"] += 1
        log(f"[launched] {shape} x Nk {nk} {dtype} strides {strides} offsets {offsets} "
            f"causal={causal} kv_lens={None if lens is None else lens.tolist()} (by {where}): "
            f"{note} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash attention kernel disagrees with its plain version at "
                                 "a shape a driven path launched")
    return summary


def hold_bf16(fa, got, plain, q, k, v, scale, causal=False, kv_lens=None):
    """The bf16 kernel's output ``got`` and the plain bf16 version's ``plain``
    against the plain float32 version on the same bf16 inputs: (the kernel's
    error, its tolerance max(2 x the plain bf16 error, BF16_FLOOR), a note)."""
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), scale=scale,
                                   causal=causal, kv_lens=kv_lens)
    err = (got.float() - ref).abs().max().item()
    plain_err = (plain.float() - ref).abs().max().item()
    tol = max(2 * plain_err, BF16_FLOOR)
    vs_plain = (got.float() - plain.float()).abs().max().item()
    note = (f"max|kernel-f32| {err:.3e}, max|plain-f32| {plain_err:.3e} (tol {tol:.3e}); "
            f"max|kernel-plain| {vs_plain:.3e}, max|f32| {ref.abs().max().item():.3e}")
    return err, tol, note


def kernel_ms(calls, eager=(), cold=False) -> dict:
    """Device ms of one call of each of ``calls`` (name -> function): CUDA-graph
    replays of 30 calls (``ops.bench.time_ms``), L2-warm, and with ``cold``
    also L2-cold under ``{name}_l2_cold``; the names in ``eager``, calls a
    graph cannot capture (host reads, autograd), over EAGER_ITERS eager calls
    between two CUDA events, after one call to warm up."""
    out = {}
    for name, fn in calls.items():
        if name not in eager:
            out[name] = time_ms(fn)
            if cold:
                out[name + "_l2_cold"] = time_ms(fn, cold=True)
            continue
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(EAGER_ITERS):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(stop) / EAGER_ITERS
    return out


def time_flash(fa, gen) -> dict:
    """Phase 3's table: per type, at each FLASH_TIMED shape (split-head,
    unmasked), the kernel's, the plain version's and
    scaled_dot_product_attention's ms (a yardstick the port never calls),
    L2-warm and cold, beside the bound and the library call's kernels."""
    timings = {}
    for dtype, shapes in FLASH_TIMED.items():
        rows = []
        for b, h, n, dh in shapes:
            q, k, v = (split_heads(gen, b, h, n, dh, dtype) for _ in range(3))
            scale = dh ** -0.5
            calls = {
                "ms": lambda: fa.flash_attention(q, k, v, scale=scale),
                "plain_ms": lambda: fa.flash_attention_plain(q, k, v, scale=scale),
                "library_ms": lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, scale=scale),
            }
            bound, bound_by = attention_bound_ms(q, k)
            row = {"shape": [b, h, n, dh], "bound_ms": bound, "bound_by": bound_by,
                   "library_kernels": device_kernel_names(calls["library_ms"]),
                   **kernel_ms(calls, cold=True)}
            rows.append(row)
            log(f"[kernels] flash_attention {str(dtype)[6:]} {(b, h, n, dh)} split-head timing: "
                + json.dumps(row))
            del q, k, v, calls
            torch.cuda.empty_cache()
        timings[dtype] = rows
    return timings


def golden_model():
    """The goldens' float32 model on the card, its weights loaded, and the
    goldens' inputs and outputs."""
    from texocr_tpu_torch.checkpoint import load_state
    from texocr_tpu_torch.config import ModelConfig
    from texocr_tpu_torch.models import OCRModel

    config = {
        "img_size": (48, 128), "patch_size": 16, "vocab_size": 50, "max_length": 32,
        "glu": True, "bos_token": 48, "eos_token": 47, "trg_pad_idx": 49,
        "dtype": "float32",
        "encoder": {"n_channels": 1, "embed_dim": 64, "num_layers": 2, "heads": 2,
                    "resnet_depths": (1, 1, 1), "resnet_channels": (128, 128, 128),
                    "stem_channels": 32},
        "decoder": {"embed_dim": 64, "num_layers": 2, "heads": 2, "cross_attend": True,
                    "dropout": 0.0, "exp_factor": 4},
    }
    goldens = os.path.join(REPO, "tests", "goldens")
    model = OCRModel(ModelConfig.from_dict(config), device="cuda")
    model.load_state_dict(load_state(os.path.join(goldens, "model_state.npz")), strict=True)
    return model, np.load(os.path.join(goldens, "model_io.npz"))


def golden_images(io) -> torch.Tensor:
    return torch.from_numpy(io["images"]).permute(0, 2, 3, 1).contiguous().cuda()


def check_golden():
    """The committed reference goldens through the port on the card."""
    from texocr_tpu_torch.models import greedy_decode

    model, io = golden_model()
    images = golden_images(io)
    with counted() as n, torch.inference_mode():
        enc = model.encode(images)
        tokens = greedy_decode(model, enc, bos_token=48, eos_token=-1, pad_token=49,
                               max_len=io["greedy_tokens"].shape[1] - 1)
    launches = n["flash"]  # all float32: the float32 kernel's
    enc_ok = np.allclose(enc.cpu().numpy(), io["enc_out"], rtol=1e-4, atol=1e-4)
    enc_err = float(np.abs(enc.cpu().numpy() - io["enc_out"]).max())
    tokens_ok = np.array_equal(tokens.cpu().numpy(), io["greedy_tokens"][:, 1:])
    log(f"[golden] enc_out max err {enc_err:.3e} (rtol/atol 1e-4) {'ok' if enc_ok else 'FAIL'}; "
        f"greedy tokens {'exact' if tokens_ok else 'DIFFER'}; flash launches {launches}")
    if not (enc_ok and tokens_ok and launches > 0):
        raise AssertionError("golden check failed on the card")
    return launches


def canvas(rng, h, w) -> np.ndarray:
    """A white uint8 canvas with dark strokes, like a rendered equation."""
    img = np.full((h, w), 255, np.uint8)
    for _ in range(max(4, w // 40)):
        r, c = rng.integers(0, h - 6), rng.integers(0, w - 30)
        img[r: r + 3, c: c + int(rng.integers(8, 30))] = 0
    return img


def flagship_engine(**overrides):
    """TexOCR on the card: the flagship at full width, bf16 unless
    ``overrides`` say otherwise, weights from seed 0 (the same in every
    engine)."""
    from texocr_tpu_torch.config import FLAGSHIP
    from texocr_tpu_torch.serving import TexOCR
    from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH

    return TexOCR(dict(FLAGSHIP, tokenizer_path=DEFAULT_VOCAB_PATH, seed=0, **overrides),
                  device="cuda")


@contextlib.contextmanager
def counted():
    """Yields a dict that, when the block ends, holds the change of each
    COUNTED telemetry counter over the block, by short name. The counters
    are the program's own, read and never written."""
    before, out = telemetry.counters(), {}
    yield out
    after = telemetry.counters()
    out.update({k: after.get(name, 0) - before.get(name, 0) for k, name in COUNTED.items()})


def expect_launches(n, encodes, what) -> int:
    """``n["flash"]``, a block's flash launches (``counted``): N_LAYERS per
    encode."""
    if n["flash"] != N_LAYERS * encodes:
        raise AssertionError(f"{what}: expected {N_LAYERS} flash launches per encode, got "
                             f"{n['flash']} for {encodes} encodes")
    return n["flash"]


def to_input(batch) -> torch.Tensor:
    """uint8 canvases -> the model's input on the card, as TexOCR makes it."""
    return 1.0 - torch.from_numpy(batch).cuda().float() / 255.0


def serve(rng):
    """Phase 5: the flagship model at full width, bf16, seeded random
    weights, through TexOCR (see the module docstring)."""
    engine = flagship_engine()
    requests = [canvas(rng, 160, 1008), canvas(rng, 96, 512), canvas(rng, 32, 128)]
    batch = np.stack([canvas(rng, 160, 1008) for _ in range(BATCH)])[..., None]
    # The first call of a key captures its CUDA graphs (after one eager run);
    # the counted calls replay them.
    for img in requests:
        engine(img, max_len=DECODE_STEPS)
    engine.generate_batch(batch, max_len=DECODE_STEPS)
    steps = 0  # decoded, over every request and the batch below
    with counted() as n:
        for img in requests:
            ids, latex = engine(img)
            if not all(0 <= i < 1000 for i in ids) or not isinstance(latex, str):
                raise AssertionError(f"bad request output: {ids[:10]} {latex!r}")
            steps += request_steps(engine, ids)
            log(f"[serve] request {img.shape}: {len(ids)} tokens, latex {latex[:40]!r}")
        tokens = engine.generate_batch(batch, max_len=DECODE_STEPS)
        torch.cuda.synchronize()
        steps += batch_steps(engine, tokens)
    decode_launches = expect_decode_launches(engine, n, steps, "serve")
    tokens = tokens.cpu().numpy()
    if tokens.shape != (BATCH, DECODE_STEPS) or tokens.min() < 0 or tokens.max() >= 1000:
        raise AssertionError(f"bad batch tokens: shape {tokens.shape}")
    for row in tokens:
        engine.postprocess(row)  # the strings decode
    encodes = len(requests) + 1
    log(f"[serve] batch of {BATCH} (160, 1008) decoded; flash launches {n['flash']} for "
        f"{encodes} encodes; decode attention launches {n['decode']} over {steps} decoded "
        f"steps")
    launches = expect_launches(n, encodes, "serve")  # all bfloat16: the bfloat16 kernel's
    return {"launches": launches, "encodes": encodes, "decode_launches": decode_launches,
            "engine": engine, "batch": batch}


def graphs_phase(engine, batch) -> dict:
    """Phase 6b: the compiled decode (models.graphed.make_graphed_generate)
    against the eager path on the serving batch, in every mode (see the
    module docstring)."""
    from texocr_tpu_torch.models.attention import decode_chunks
    from texocr_tpu_torch.models.generate import decode_state
    from texocr_tpu_torch.models.graphed import make_graphed_generate

    x = to_input(batch)
    result = {}
    for name in ("greedy", "int8", "beam", "sample"):
        model = (flagship_engine(kv_quant="int8", self_kv_quant="int8").model if name == "int8"
                 else engine.model)
        mode = name if name in ("beam", "sample") else "greedy"
        gen = torch.Generator(device="cuda").manual_seed(0)
        args = dict(max_len=DECODE_STEPS, mode=mode, generator=gen, temp=0.3, beam_size=BEAM)
        graphed = make_graphed_generate(model, BATCH, batch.shape[1:3], DECODE_STEPS, mode,
                                        beam_size=BEAM, generator=gen, temp=0.3)

        # Bit-equal to the eager decode, the generator in the same state.
        gen.manual_seed(1)
        with counted() as n:
            tokens = graphed(batch)
        launches = expect_launches(n, 1, f"graphed {name}")
        with torch.inference_mode():
            cross_kv = model.decoder_cross_kv(model.encode(x))
            gen.manual_seed(1)
            state = decode_state(model, cross_kv, **args)
            decode_chunks(state, state.run_chunk)
        same = torch.equal(tokens, state.result())
        note = f"tokens {'bit-equal to' if same else 'DIFFER FROM'} the eager path's"
        if mode == "beam":
            score, want = (s.result(return_scores=True)[1] for s in (graphed.state, state))
            same = same and torch.equal(score, want)
            note += f", best scores {'bit-equal' if torch.equal(score, want) else 'DIFFER'}"
        if mode == "sample":  # the generator advances: the next calls draw anew
            again = graphed(batch)
            differ = not torch.equal(again, graphed(batch))
            same = same and differ
            note += f"; two successive calls {'differ' if differ else 'DRAW THE SAME'}"
        log(f"[graphs] {name}: {note}; flash launches {launches} for 1 encode")
        if not same:
            raise AssertionError(f"the graphed {name} decode differs from the eager one")
        result[name] = {"launches": launches, "encodes": 1}
        del state, graphed, model
        torch.cuda.empty_cache()

    # The float32 golden model through the graphs, from its float inputs.
    golden, io = golden_model()
    want = io["greedy_tokens"][:, 1:]
    graphed = make_graphed_generate(golden, want.shape[0], io["images"].shape[2:],
                                    want.shape[1], "greedy", float_input=True)
    graphed.images.copy_(golden_images(io))
    with counted() as n:
        graphed.encode()
        graphed.decode()
    exact = np.array_equal(graphed.state.result().cpu().numpy(), want)
    log(f"[graphs] golden float32 model through the graphs: greedy tokens "
        f"{'exact' if exact else 'DIFFER'}; flash launches {n['flash']} (2 layers) for 1 encode")
    if not (exact and n["flash"] == 2):
        raise AssertionError("the golden tokens differ through the graphs")
    return result


def check_encoder_paths(rng) -> float:
    """Full-canvas flagship encoder, float32: kernel path against plain path;
    returns the largest difference."""
    err = encode_paths_err(rng, {})
    tol = 1e-3
    log(f"[encoder] full canvas f32, kernel vs plain path: max err {err:.3e} (tol {tol:g}) "
        f"{'ok' if err <= tol else 'FAIL'}")
    if not err <= tol:
        raise AssertionError("encoder kernel path disagrees with the plain path")
    return err


def encode_paths_err(rng, overrides) -> float:
    """The full-canvas encoder of the flagship with ``overrides`` in float32
    (TF32 off), kernel path against plain path on 2 canvases: the largest
    absolute difference. Fails on a non-finite kernel-path output."""
    from texocr_tpu_torch.config import FLAGSHIP, ModelConfig
    from texocr_tpu_torch.models import OCRModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images = np.stack([canvas(rng, 160, 1008) for _ in range(2)])[..., None]
    outs = []
    for use_flash in (True, False):
        cfg = dict(FLAGSHIP, dtype="float32", use_flash_attention=use_flash, **overrides)
        model = OCRModel(ModelConfig.from_dict(cfg), device="cuda", seed=0)
        with torch.inference_mode():
            outs.append(model.encode(to_input(images)))
        del model
    if not torch.isfinite(outs[0]).all():
        raise AssertionError("non-finite float32 encode on the kernel path")
    return (outs[0] - outs[1]).abs().max().item()


def train_tokens(rng, n) -> list:
    """``n`` token-id sequences of 40-250 ids, drawn with a 1/rank skew over
    the 997 ids below the specials (LaTeX tokens are skewed so; the loss can
    fall below the uniform ln 997 in a few steps)."""
    p = 1.0 / np.arange(1, 998)
    p /= p.sum()
    order = rng.permutation(997)
    return [order[rng.choice(997, size=int(rng.integers(40, 251)), p=p)].tolist()
            for _ in range(n)]


def write_split(root, split, buckets, rng) -> str:
    """``root/{split}/{split}set.pkl`` in the JAX package's payload format:
    ``buckets`` of ((H, W), images), with train_tokens labels."""
    from texocr_tpu_torch.data.dataset import ImageDataset

    images = [canvas(rng, h, w) for (h, w), n in buckets for _ in range(n)]
    os.makedirs(os.path.join(root, split))
    path = os.path.join(root, split, f"{split}set.pkl")
    ImageDataset.from_arrays(images, train_tokens(rng, len(images))).save(path)
    return path


def write_train_data(root, rng, train_buckets=TRAIN_BUCKETS) -> None:
    """train/val/test pickles under ``root``: the train split holds
    ``train_buckets`` ((canvas, batches) pairs), val one full batch of full
    canvases, test eight small canvases (unused)."""
    splits = {"train": [(hw, n * TRAIN_BATCH) for hw, n in train_buckets],
              "val": [((160, 1008), TRAIN_BATCH)], "test": [((64, 512), 8)]}
    for split, buckets in splits.items():
        write_split(root, split, buckets, rng)


def train_config(save_dir) -> dict:
    """The flagship with config/config.yml's training keys; max_length and
    vocab_size come from the dataset, as for the training CLI."""
    from texocr_tpu_torch.config import FLAGSHIP

    config = {k: v for k, v in FLAGSHIP.items() if k not in ("max_length", "vocab_size")}
    config.update(
        batch_size=TRAIN_BATCH, batch_shuffle=True, id_shuffle=True, drop_last=True,
        keep_small=False, n_epochs=TRAIN_EPOCHS, optimizer="Adam",
        optimizer_args={"lr": 0.0005, "weight_decay": 0.0}, loss_fn="CrossEntropyLoss",
        save_checkpoint=True, save_dir=save_dir, save_freq=1, val_freq=1, seed=42,
        mask_pad_loss=True, seq_pad_multiple=32, dtype="bfloat16",
    )
    return config


def check_train_grads(rng) -> dict:
    """One loss and backward on the same GRAD_IMAGES full canvases through
    the flagship from the same weights, in float32 and in bfloat16, each
    with flash on (FlashAttentionFunction: the kernel forward; the backward
    kernel in bfloat16, the math path's VJP in float32) and off (the math
    path both ways); TF32 is off and cuDNN
    deterministic. Fatal: a float32 encoder parameter's gradient on the
    kernel path more than GRAD_TOL (relative L2) from the plain path's; a
    bfloat16 one further from the float32 plain path's than max(2 x the
    bfloat16 plain path's distance, BF16_FLOOR). Returns the worst of each."""
    from texocr_tpu_torch.config import FLAGSHIP, ModelConfig
    from texocr_tpu_torch.data.dataset import BatchCollator
    from texocr_tpu_torch.models import OCRModel
    from texocr_tpu_torch.training.losses import sequence_ce_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    batch = [(1.0 - canvas(rng, 160, 1008)[..., None].astype(np.float32) / 255.0, ids)
             for ids in train_tokens(rng, GRAD_IMAGES)]
    images, labels = BatchCollator(999, 998, 997, seq_pad_multiple=32)(batch)
    images, labels = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    grads = {}
    for dtype in ("float32", "bfloat16"):
        for use_flash in (True, False):
            cfg = ModelConfig.from_dict(dict(FLAGSHIP, dtype=dtype, use_flash_attention=use_flash))
            model = OCRModel(cfg, device="cuda", seed=0)
            with counted() as n:
                logits, shifted = model(images, labels)
                sequence_ce_loss(logits, shifted, pad_token=999).backward()
            # The backward kernel takes the bfloat16 calls; float32 keeps the math path's VJP.
            backward = N_LAYERS if use_flash and dtype == "bfloat16" else 0
            if n["flash"] != (N_LAYERS if use_flash else 0) or n["backward"] != backward:
                raise AssertionError(f"{dtype} flash={use_flash}: {n['flash']} launches, "
                                     f"{n['backward']} backward")
            grads[dtype, use_flash] = {k: p.grad.double()
                                       for k, p in model.encoder.named_parameters()}
            del model, logits
    torch.backends.cudnn.deterministic = False

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()

    exact = grads["float32", False]
    worst = {"float32": (0.0, None, GRAD_TOL), "bfloat16": (0.0, None, BF16_FLOOR)}  # err, key, tol
    failed = []
    for key, ref in exact.items():
        err = rel(grads["float32", True][key], ref)
        if not err <= GRAD_TOL:
            failed.append(("float32", key, err, GRAD_TOL))
        if not np.isfinite(err) or err > worst["float32"][0]:
            worst["float32"] = (err, key, GRAD_TOL)
        err = rel(grads["bfloat16", True][key], ref)
        tol = max(2 * rel(grads["bfloat16", False][key], ref), BF16_FLOOR)
        if not err <= tol:
            failed.append(("bfloat16", key, err, tol))
        if not np.isfinite(err) or err / tol > worst["bfloat16"][0] / worst["bfloat16"][2]:
            worst["bfloat16"] = (err, key, tol)
    f32, bf16 = worst["float32"], worst["bfloat16"]
    log(f"[train] encoder gradients on {GRAD_IMAGES} full canvases over {len(exact)} tensors, "
        f"relative L2: float32 kernel path vs plain path, worst {f32[0]:.3e} ({f32[1]}; tol "
        f"{GRAD_TOL:g}); bfloat16 kernel path vs float32 plain path, nearest its tolerance "
        f"{bf16[0]:.3e} ({bf16[1]}; tol {bf16[2]:.3e} = max(2 x bfloat16 plain path's, "
        f"{BF16_FLOOR:g})) {'FAIL ' + str(failed[:4]) if failed else 'ok'}")
    if failed:
        raise AssertionError("kernel-path gradients differ from the plain path")
    return {"float32": f32[0], "bfloat16": bf16[0], "bfloat16_tol": bf16[2]}


def decode_attention_phase() -> dict:
    """Phase 3b: the decode-attention kernel (csrc/decode_attention.cu). Its
    build (ptxas registers and spills per instantiation); each DECODE_CASES
    call against its plain version on the card, on DA_SEEDS seeds, and its
    worst reading over them; the DA_TIMED calls timed (``kernel_ms``) beside
    their bound (bytes at 3.35 TB/s), the plain version and
    scaled_dot_product_attention where one computes the same (the
    compute-type caches). The main path's launches are counted in serve()
    and int8_phase()."""
    from texocr_tpu_torch.ops import bench, build
    from texocr_tpu_torch.ops import decode_attention as da

    _, build_log = build.build(da.SOURCE)
    for line in build_log.splitlines():
        if any(word in line for word in ("entry function", "registers", "spill", "warning")):
            log(f"[decode attention]   {line.strip()}")
    scale = 64 ** -0.5
    rows = {}
    for name, (kind, args) in bench.DECODE_CASES.items():
        worst = {}
        for seed in range(DA_SEEDS):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            q, call, kernel, plain, keys = bench.decode_case(gen, kind, args, scale)
            with counted() as n:
                got, want = kernel(), plain()
            torch.cuda.synchronize()
            if n["decode"] != 1:
                raise AssertionError(f"decode attention {name}: {n['decode']} launches")
            gaps = bench.decode_gaps(got, want)
            if not gaps.pop("ok"):
                raise AssertionError(f"decode attention kernel disagrees with its plain version: "
                                     f"{name}, seed {seed}: {json.dumps(gaps)}")
            worst = {key: max(value, worst.get(key, value)) for key, value in gaps.items()}
        row = dict(worst, seeds=DA_SEEDS)
        log(f"[decode attention] {name}, kernel vs plain, worst of {DA_SEEDS} seeds: "
            f"{json.dumps(worst)} ok")
        if name in DA_TIMED:
            calls = {"ms": kernel, "plain_ms": plain}
            if keys is not None:
                sdpa = torch.nn.functional.scaled_dot_product_attention
                calls["library_ms"] = lambda: sdpa(q, *keys, scale=scale)
            row.update(shape=list(q.shape), keys=call["n"], int8_keys=call["n8"],
                       bound_ms=bench.decode_attention_bound_ms(q, call), **kernel_ms(calls))
            row["bound_share"] = row["bound_ms"] / row["ms"]
            log(f"[decode attention] {name} timing: " + json.dumps(row))
        rows[name] = row
    return rows


def moe_loop(x, ids, w, wg, wu, wd) -> torch.Tensor:
    """The routed product one expert at a time, with the kernels' roundings:
    float32 products of the bfloat16 values, silu(gate) * up rounded to
    bfloat16, the weighted down product summed in float32."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(wg.shape[0]):
        rows, slot = (ids == e).nonzero(as_tuple=True)
        if rows.numel():
            a = x[rows].float()
            h = (torch.nn.functional.silu(a @ wg[e].float().t()) * (a @ wu[e].float().t()))
            y = h.to(x.dtype).float() @ wd[e].float().t()
            out.index_add_(0, rows, y * w[rows, slot][:, None])
    return out


def moe_graph_check() -> dict:
    """A 3-layer mla_moe model at Kimi-VL-A3B's widths, drawn on the card:
    its 8-chunk graphs' tokens against the eager decode's (bit-equal), the
    launches a replayed call counts (2 an expert layer for the prefill and
    every step), and the rows it adds to ``moe.expert_rows``."""
    from texocr_tpu_torch.models import generate
    from texocr_tpu_torch.models.graphed import make_graphed_generate
    from texocr_tpu_torch.models.moe import EXPERT_ROWS
    from texocr_tpu_torch.models.ocr_model import create_model

    cfg = json.load(open(os.path.join(REPO, "portbench", "configs", "kimi-vl-a3b.json")))["model"]
    cfg = dict(cfg, decoder=dict(cfg["decoder"], num_hidden_layers=MOE_GRAPH_LAYERS))
    model = create_model(cfg, device="cuda", seed=3).eval()
    gen = torch.Generator(device="cuda").manual_seed(31)
    u8 = torch.randint(0, 256, (MOE_GRAPH_BATCH, 160, 1008, 1), dtype=torch.uint8,
                       device="cuda", generator=gen)
    engine = make_graphed_generate(model, MOE_GRAPH_BATCH, (160, 1008), MOE_GRAPH_STEPS)
    rows = telemetry.device_counters()[EXPERT_ROWS]
    with counted() as n:
        graphed = engine(u8)
    torch.cuda.synchronize()
    routed = int((telemetry.device_counters()[EXPERT_ROWS] - rows).sum())
    with torch.inference_mode():
        eager = generate(model, 1.0 - u8.float() / 255.0, max_len=MOE_GRAPH_STEPS)
    moe_layers = MOE_GRAPH_LAYERS - cfg["decoder"]["first_k_dense_replace"]
    want = 2 * moe_layers * (1 + MOE_GRAPH_STEPS)
    want_rows = MOE_GRAPH_BATCH * (160 + MOE_GRAPH_STEPS) * MOE_WIDTHS[3] * moe_layers
    if n["moe"] != want or routed != want_rows:
        raise AssertionError(f"moe graphs: {n['moe']} launches and {routed} routed rows a "
                             f"call, expected {want} and {want_rows}")
    if not torch.equal(graphed, eager):
        raise AssertionError("moe graphs: graphed tokens differ from the eager decode's")
    out = {"launches_per_call": n["moe"], "routed_rows": routed, "chunks": engine.state.n_chunks}
    del engine, model
    torch.cuda.empty_cache()
    return out


def routed_rows_now() -> int:
    """The program's ``moe.expert_rows`` summed (0 before its first add)."""
    from texocr_tpu_torch import telemetry
    from texocr_tpu_torch.models.moe import EXPERT_ROWS

    rows = telemetry.device_counters().get(EXPERT_ROWS)
    return 0 if rows is None else int(rows.sum())


def moe_main_path() -> dict:
    """kimivl.batch's path: ``TexOCR`` with the kimi-vl-a3b configuration
    whole, its state dict (drawn on the card, EOS's head row zeroed) taken in
    place, ``generate_batch`` at the cell's shape. The first call captures;
    the replayed call after it must count 2 x expert layers x (1 + steps)
    launches: the prefill and every step, through the graphs' replay
    counts."""
    from texocr_tpu_torch.models.ocr_model import create_model
    from texocr_tpu_torch.serving.wrapper import TexOCR

    cfg = json.load(open(os.path.join(REPO, "portbench", "configs", "kimi-vl-a3b.json")))["model"]
    dec = cfg["decoder"]
    moe_layers = dec["num_hidden_layers"] - dec["first_k_dense_replace"]
    head = "language_model.lm_head.weight"
    params = create_model(cfg, device="cuda", seed=11).state_dict()
    params[head][cfg["eos_token"]].zero_()
    engine = TexOCR(cfg, device="cuda", state_dict=params)
    if engine.model.language_model.lm_head.weight.data_ptr() != params[head].data_ptr():
        raise AssertionError("moe main path: the engine copied the state dict")
    del params
    gen = torch.Generator(device="cuda").manual_seed(41)
    u8 = torch.randint(0, 256, (MOE_MAIN_BATCH, 160, 1008, 1), dtype=torch.uint8,
                       device="cuda", generator=gen)
    want = 2 * moe_layers * (1 + MOE_MAIN_STEPS)
    (h, w), (mh, mw) = engine.model.encoder.feature_grid(160, 1008), dec["merge"]
    prefix = -(-h // mh) * -(-w // mw)  # 160 image tokens
    want_rows = (MOE_MAIN_BATCH * (prefix + MOE_MAIN_STEPS) * dec["num_experts_per_tok"]
                 * moe_layers)
    engine.generate_batch(u8, max_len=MOE_MAIN_STEPS).cpu()  # the key's capture
    rows = routed_rows_now()
    with counted() as n:
        tokens = engine.generate_batch(u8, max_len=MOE_MAIN_STEPS).cpu()
    routed = routed_rows_now() - rows
    if n["moe"] != want or routed != want_rows:
        raise AssertionError(f"moe main path: {n['moe']} launches and {routed} routed rows "
                             f"a call, expected {want} and {want_rows}")
    if bool((tokens == cfg["eos_token"]).any()):
        raise AssertionError("moe main path: a row served EOS with its logit pinned at 0")
    del engine
    torch.cuda.empty_cache()
    return {"shape": [MOE_MAIN_BATCH, 160, 1008, MOE_MAIN_STEPS], "launches": n["moe"],
            "routed_rows": routed}


def moe_experts_phase() -> dict:
    """Phase 3c: the routed-expert kernels (``ops/moe_experts.py``, Triton)
    at Kimi-VL-A3B's widths, decode's and prefill's row counts: each against
    the expert loop with the kernels' roundings (``MOE_TOL``), the kernels'
    time (their two launches alone, and ``routed`` whole) beside their bound,
    the expert loop's and at decode the plain version's; then
    ``moe_graph_check`` and ``moe_main_path``."""
    from texocr_tpu_torch.ops import moe_experts
    from texocr_tpu_torch.ops.bench import moe_bound_ms

    n_experts, inter, hidden, k = MOE_WIDTHS
    gen = torch.Generator(device="cuda").manual_seed(7)
    weights = [(torch.randn(shape, generator=gen, device="cuda") * 0.02).bfloat16()
               for shape in ((n_experts, inter, hidden), (n_experts, inter, hidden),
                             (n_experts, hidden, inter))]
    rows = {}
    for name, tokens in MOE_SHAPES.items():
        x = torch.randn(tokens, hidden, generator=gen, device="cuda").bfloat16()
        scores = torch.randn(tokens, n_experts, generator=gen, device="cuda")
        ids = torch.topk(scores, k, dim=-1).indices
        w = torch.softmax(scores.gather(1, ids), -1) * 2.446
        got, counts = moe_experts.routed(x, ids, w, *weights)
        want = moe_loop(x, ids, w, *weights)
        gap = float((got - want).abs().max() / want.abs().max())
        if gap > MOE_TOL:
            raise AssertionError(f"moe experts {name}: kernels vs loop {gap:.3g} > {MOE_TOL}")
        tile = moe_experts.tiles(tokens * k, n_experts)
        aligned = moe_experts.align(ids, n_experts, tile["gate_up"][0])
        calls = {"ms": lambda: moe_experts.launch(x, w, *weights, aligned, tile),
                 "routed_ms": lambda: moe_experts.routed(x, ids, w, *weights),
                 "loop_ms": lambda: moe_loop(x, ids, w, *weights)}
        if name == "decode":
            calls["plain_ms"] = lambda: moe_experts.routed_plain(x, ids, w, *weights,
                                                                 block=tile["down"][0])
        bound_ms, bound_by = moe_bound_ms(tokens, int((counts > 0).sum()), inter, hidden, k)
        row = {"tokens": tokens, "rows": tokens * k, "gap": gap, "bound_ms": bound_ms,
               "bound_by": bound_by, **kernel_ms(calls, eager=("loop_ms", "plain_ms"))}
        row["bound_share"] = bound_ms / row["ms"]
        log(f"[moe experts] {name}: " + json.dumps(row))
        rows[name] = row
    rows["graphs"] = moe_graph_check()
    log("[moe experts] graphs: " + json.dumps(rows["graphs"]))
    rows["main path"] = moe_main_path()
    log("[moe experts] main path: " + json.dumps(rows["main path"]))
    return rows


def expect_decode_launches(engine, n, steps, what) -> dict:
    """``n["decode"]``, a block's decode attention launches (``counted``): 2
    a decoder layer a decoded step (self and cross attention)."""
    expected = 2 * engine.model.config.decoder.num_layers * steps
    if n["decode"] != expected:
        raise AssertionError(f"{what}: expected {expected} decode attention launches over "
                             f"{steps} decoded steps, got {n['decode']}")
    return {"launches": n["decode"], "steps": steps}


def batch_steps(engine, tokens) -> int:
    """The steps the engine's chunked decode ran, from its (B, max_len) tokens."""
    from texocr_tpu_torch.models.attention import chunk_size

    cfg = engine.model.config
    chunk = chunk_size(tokens.shape[1], cfg.decoder.max_length)[1]
    return decoded_steps(tokens, cfg.eos_token, chunk)


def request_steps(engine, ids) -> int:
    """The steps a served request's decode ran, from its token ids (up to and
    excluding EOS; DECODE_STEPS without one)."""
    row = torch.full((1, DECODE_STEPS), engine.model.config.eos_token)
    row[0, :len(ids)] = torch.tensor(ids, dtype=row.dtype)
    return batch_steps(engine, row)


def decoded_steps(tokens, eos, chunk) -> int:
    """The steps a chunked decode ran for these tokens: it stops after the
    first chunk at whose end every row has emitted EOS."""
    steps = tokens.shape[1]
    hit = (tokens == eos)
    if not bool(hit.any(1).all()):
        return steps
    first = hit.int().argmax(1)
    return min(steps, (int(first.max()) // chunk + 1) * chunk)


def backward_operands(gen, b, h, nq, nk, dh, layout):
    """q, k, v (``flash_inputs``) and an output gradient in bf16 on the card;
    in the split-head layout the gradient is split from (B, Nq, H * dh) too,
    as autograd hands it back through the encoder's head merge."""
    q, k, v = flash_inputs(gen, b, h, nq, nk, dh, torch.bfloat16, layout)
    if layout == "split":
        grad = split_heads(gen, b, h, nq, dh, torch.bfloat16)
    else:
        grad = torch.randn(q.shape, device="cuda", generator=gen).to(torch.bfloat16)
    return q, k, v, grad


def hold_backward(fa, q, k, v, grad, causal) -> dict:
    """One call through FlashAttentionFunction (the forward with row
    statistics, then the backward kernel) against the plain bf16 VJP and the
    float32 VJP of the same bf16 operands, under ``backward_gaps``'s limits
    (the kernel rounds dS to bf16 where the plain version rounds dP). Also
    fatal: a backward launch other than one, an output other than the
    forward's without statistics, a gradient with other strides than its
    operand, row statistics off the float32 log-sum-exp by more than
    LSE_TOL."""
    from texocr_tpu_torch.ops.bench import backward_gaps

    scale = q.shape[-1] ** -0.5
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    with counted() as n:
        out = fa.FlashAttentionFunction.apply(qg, kg, vg, scale, causal)
        got = torch.autograd.grad(out, (qg, kg, vg), grad)
    torch.cuda.synchronize()
    launches = n["backward"]
    plain = fa.flash_attention_backward_plain(q, k, v, grad, scale=scale, causal=causal)
    ref = fa.flash_attention_backward_plain(q.float(), k.float(), v.float(), grad.float(),
                                            scale=scale, causal=causal)
    gaps = backward_gaps(got, plain, ref)
    forward_gap = (out.float() - fa.flash_attention(q, k, v, scale=scale, causal=causal)
                   .float()).abs().max().item()
    lse = torch.empty(q.shape[0], q.shape[1], fa.lse_rows(q.shape[2]), device="cuda")
    fa.flash_attention(q, k, v, scale=scale, causal=causal, lse=lse)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        logits = logits.masked_fill(torch.ones_like(logits, dtype=torch.bool).triu(1),
                                    -float("inf"))
    lse_gap = (lse[..., :q.shape[2]] - torch.logsumexp(logits, -1) / np.log(2)).abs().max().item()
    strides = all(g.stride() == t.stride() for g, t in zip(got, (q, k, v)))
    gaps.update(launches=launches, forward_gap=forward_gap, lse_gap=lse_gap, strides=strides)
    gaps["ok"] = (gaps["ok"] and launches == 1 and forward_gap == 0 and lse_gap <= LSE_TOL
                  and strides)
    return gaps


def flash_backward_phase(fa, gen) -> dict:
    """Phase 3d: the bf16 backward kernel against its plain version
    (``hold_backward``) at the training shapes of BACKWARD_SHAPES, causal and
    not, and at edge cases (ragged tiles, Nq != Nk, dh 48 and 36, rows off 16
    bytes); then its time at BACKWARD_TIMED beside its bound, the plain
    version (the math path's VJP, which the backward ran before), the
    forward with and without row statistics, and
    scaled_dot_product_attention's backward (a yardstick the port never
    calls)."""
    from texocr_tpu_torch.ops.bench import attention_backward_bound_ms

    cases = [(b, h, n, n, 64, causal, "split") for b, h, n in BACKWARD_SHAPES
             for causal in (False, True)]
    cases += [
        (2, 3, 200, 200, 64, True, "dense"),
        (2, 2, 70, 90, 64, False, "dense"),
        (3, 2, 17, 17, 64, True, "split"),
        (2, 3, 130, 130, 48, False, "split"),
        (2, 2, 70, 90, 36, False, "dense"),
        (2, 2, 129, 129, 40, True, "slice"),
        (2, 3, 130, 130, 64, True, "offset"),
    ]
    worst = {}
    for b, h, nq, nk, dh, causal, layout in cases:
        q, k, v, grad = backward_operands(gen, b, h, nq, nk, dh, layout)
        gaps = hold_backward(fa, q, k, v, grad, causal)
        log(f"[backward] {(b, h, nq, nk, dh)} causal={causal} {layout}: "
            + json.dumps(gaps) + (" ok" if gaps["ok"] else " FAIL"))
        if not gaps["ok"]:
            raise AssertionError("the flash backward kernel disagrees with its plain version")
        for name in ("dq", "dk", "dv"):
            worst[name] = max(worst.get(name, 0.0), gaps[name]["kernel"])
        del q, k, v, grad
        torch.cuda.empty_cache()

    rows = []
    for b, h, n in BACKWARD_TIMED:
        q, k, v, grad = backward_operands(gen, b, h, n, n, 64, "split")
        scale = 64 ** -0.5
        lse = torch.empty(b, h, fa.lse_rows(n), device="cuda")
        out = fa.flash_attention(q, k, v, scale=scale, lse=lse)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, scale=scale)

        def library():
            torch.autograd.grad(lib_out, (ql, kl, vl), grad, retain_graph=True)

        calls = {"ms": lambda: fa.flash_attention_backward(q, k, v, out, lse, grad,
                                                           scale=scale),
                 "plain_ms": lambda: fa.flash_attention_backward_plain(q, k, v, grad,
                                                                       scale=scale),
                 "library_ms": library,
                 "forward_ms": lambda: fa.flash_attention(q, k, v, scale=scale),
                 "forward_lse_ms": lambda: fa.flash_attention(q, k, v, scale=scale, lse=lse)}
        bound, bound_by = attention_backward_bound_ms(q, k)
        row = {"shape": [b, h, n, 64], "bound_ms": bound, "bound_by": bound_by,
               "library_kernels": device_kernel_names(library),
               **kernel_ms(calls, eager=("plain_ms", "library_ms"))}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        log(f"[backward] timing {(b, h, n, 64)} split-head: " + json.dumps(row))
        rows.append(row)
        del q, k, v, grad, out, lib_out, ql, kl, vl, calls
        torch.cuda.empty_cache()
    return {"worst": worst, "timings": rows}


def train(rng, data_dir=None) -> dict:
    """Phase 8: the training path on the card (see the module docstring).
    ``data_dir``: where to write the dataset and leave it (phases 16 and 18
    train on it again); by default a temporary directory."""
    from texocr_tpu_torch.checkpoint.io import latest_checkpoint, load_checkpoint
    from texocr_tpu_torch.data.dataset import create_dataloader, load_datasets
    from texocr_tpu_torch.models import OCRModel
    from texocr_tpu_torch.training.loop import train_model
    from texocr_tpu_torch.training.optimizers import get_optimizer
    from texocr_tpu_torch.training.train_step import (
        create_train_state,
        make_train_step,
        put_batch,
    )

    grad_errors = check_train_grads(rng)

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = data_dir or tmp
        write_train_data(data_dir, rng)
        train_set, val_set, _ = load_datasets(data_dir)
        train_set.augment = True  # as the training CLI sets it
        config = train_config(os.path.join(data_dir, "checkpoints"))
        metrics = os.path.join(tmp, "metrics.jsonl")
        with counted() as n:
            model, state, history = train_model(train_set, val_set, config,
                                                metrics_path=metrics, device="cuda")
        launches, backward_launches = n["flash"], n["backward"]
        with open(metrics) as f:
            records = [json.loads(line) for line in f]
        train_steps = sum(r["steps"] for r in records if r["event"] == "train_epoch")
        eval_steps = TRAIN_EPOCHS * len(create_dataloader(val_set, config))
        log(f"[train] train_model: {TRAIN_EPOCHS} epochs, {train_steps} train and {eval_steps} "
            f"eval steps; epoch losses {history}; flash launches {launches}, backward "
            f"{backward_launches}")
        if not (len(history) == TRAIN_EPOCHS and np.isfinite(history).all()):
            raise AssertionError(f"non-finite training loss: {history}")
        if not history[1] < history[0]:
            raise AssertionError(f"the loss did not fall: {history}")
        if launches != 4 * (train_steps + eval_steps):
            raise AssertionError(f"expected 4 flash launches per step, got {launches} for "
                                 f"{train_steps} train and {eval_steps} eval steps")
        if backward_launches != 4 * train_steps:
            raise AssertionError(f"expected 4 flash backward launches per train step, got "
                                 f"{backward_launches} for {train_steps} train steps")

        # Resume: two steps from the checkpoint against two more on the state.
        train_step = make_train_step(mask_pad=True)
        small = next(b for b in create_dataloader(train_set, config)
                     if b[0].shape[1:3] == TRAIN_BUCKETS[1][0])
        images, labels = put_batch(*small, "cuda")
        restored = load_checkpoint(latest_checkpoint(config["save_dir"]))
        model2 = OCRModel(model.config, device="cuda", seed=1)
        model2.load_state_dict(restored["model"])
        opt2 = get_optimizer("Adam", config["optimizer_args"], model2.parameters())
        opt2.load_state_dict(restored["optimizer"])
        state2 = create_train_state(model2, opt2, seed=config["seed"])
        state2.step = restored["step"]
        resumed = [train_step(state2, images, labels)["loss"].item() for _ in range(2)]
        del model2, opt2, state2, restored
        kept = [train_step(state, images, labels)["loss"].item() for _ in range(2)]
        ok = np.allclose(resumed, kept, rtol=RESUME_RTOL, atol=0)
        log(f"[train] resume: losses of two steps after loading the checkpoint {resumed}, "
            f"without the save {kept} (rtol {RESUME_RTOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("resumed training differs from uninterrupted training")
    del model, state
    torch.cuda.empty_cache()
    return {"epoch_losses": history, "launches": launches,
            "launches_per_step": launches / (train_steps + eval_steps),
            "backward_launches": backward_launches,
            "backward_launches_per_train_step": backward_launches / train_steps,
            "grad_rel_l2": grad_errors, "data_dir": data_dir, "config": config}


def gray_edges(img) -> np.ndarray:
    """``img`` with antialiased stroke edges: gray 128 right of a stroke and
    192 below it, as a renderer leaves them (so that a 4-bit bucket loses
    something)."""
    right = np.roll(img, 1, axis=1) // 2 + 128
    below = np.roll(img, 1, axis=0) // 4 + 192
    return np.minimum(np.minimum(img, right), below)


def device_data_phase(rng) -> dict:
    """Phase 8b: device-resident training (see the module docstring)."""
    from texocr_tpu_torch.checkpoint.io import latest_checkpoint
    from texocr_tpu_torch.data.dataset import ImageDataset, load_datasets
    from texocr_tpu_torch.training.device_data import (
        DeviceResidentData,
        epoch_permutation,
        gather_batch,
        make_chunk_train_step,
    )
    from texocr_tpu_torch.training.loop import train_model

    h, w = DD_BUCKETS[0][0]
    tag = h * 4096 + w  # the loop's bucket tag
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        write_train_data(tmp, rng, DD_BUCKETS)
        train_set, val_set, _ = load_datasets(tmp)
        config = dict(train_config(os.path.join(tmp, "resident")), device_data=True,
                      device_data_augment=True, device_data_steps_per_call=DD_STEPS_PER_CALL)
        metrics = os.path.join(tmp, "resident.jsonl")
        with counted() as n:
            _, state, history = train_model(train_set, val_set, config, metrics_path=metrics,
                                            device="cuda")
        launches, backward_launches = n["flash"], n["backward"]
        with open(metrics) as f:
            records = [json.loads(line) for line in f]
        train_steps = sum(r["steps"] for r in records if r["event"] == "train_epoch")
        eval_steps = sum(1 for r in records if r["event"] == "val")  # one val batch each
        log(f"[device data] train_model, device_data on, augmentation on the device: "
            f"{TRAIN_EPOCHS} epochs, {train_steps} train and {eval_steps // TRAIN_EPOCHS} eval "
            f"steps; epoch losses {history}; flash launches {launches}, backward "
            f"{backward_launches}")
        if not (len(history) == TRAIN_EPOCHS and np.isfinite(history).all()):
            raise AssertionError(f"non-finite device-resident training loss: {history}")
        if not history[1] < history[0]:
            raise AssertionError(f"the device-resident loss did not fall: {history}")
        per_epoch = sum(batches for _, batches in DD_BUCKETS)
        if train_steps != TRAIN_EPOCHS * per_epoch:
            raise AssertionError(f"expected {per_epoch} steps an epoch")
        if launches != N_LAYERS * (train_steps + eval_steps):
            raise AssertionError(f"expected {N_LAYERS} flash launches per step, got {launches} for "
                                 f"{train_steps} train and {eval_steps} eval steps")
        if backward_launches != N_LAYERS * train_steps:
            raise AssertionError(f"expected {N_LAYERS} flash backward launches per train step, "
                                 f"got {backward_launches} for {train_steps} train steps")

        # A checkpoint of this path resumes with its step count and weights.
        _, resumed, _ = train_model(train_set, val_set, dict(config, resume=True),
                                    verbose=False, device="cuda")
        trained = state.model.state_dict()
        same = all(torch.equal(v, trained[k]) for k, v in resumed.model.state_dict().items())
        log(f"[device data] resume from {latest_checkpoint(config['save_dir'])}: step "
            f"{resumed.step} (trained {state.step}), weights "
            f"{'equal to the trained ones' if same else 'DIFFER'}")
        if not (resumed.step == state.step and same):
            raise AssertionError("a device-resident checkpoint does not resume")
        del resumed, trained

        # A resident size users run: one full-canvas bucket of RESIDENT_ROWS rows.
        ids = train_set.sizes[(w, h)][:RESIDENT_DISTINCT]
        distinct = [gray_edges(train_set.images[i]) for i in ids]
        big = ImageDataset.from_arrays(
            [distinct[i % len(ids)] for i in range(RESIDENT_ROWS)],
            [train_set.token_ids[ids[i % len(ids)]] for i in range(RESIDENT_ROWS)])
        run = make_chunk_train_step(TRAIN_BATCH, augment=True)
        idx = torch.arange(0, RESIDENT_ROWS, RESIDENT_ROWS // TRAIN_BATCH,
                           device="cuda")[:TRAIN_BATCH]
        gathered = {}
        for pack_bits in (8, 4):
            torch.cuda.empty_cache()
            staged = DeviceResidentData.from_dataset(big, seq_pad_multiple=32, device="cuda",
                                                     pack_bits=pack_bits)
            bucket = staged.buckets[(h, w)]
            gathered[pack_bits] = gather_batch(bucket, idx)[0]
            perm = epoch_permutation(bucket.n, 42, 0, tag, "cuda")
            loss = run(state, bucket, perm, DD_STEPS_PER_CALL, 0)["loss"].item()
            log(f"[device data] {bucket.n} resident {(h, w)} rows at pack_bits {pack_bits}, "
                f"{bucket.images.nbytes / 1e9:.3f} GB of images; one call of "
                f"{DD_STEPS_PER_CALL} steps beside it, loss {loss:.4f}")
            if not np.isfinite(loss):
                raise AssertionError(f"non-finite loss beside the resident bucket: {loss}")
            del staged, bucket, perm
        err = (gathered[4] - gathered[8]).abs()
        exact = (gathered[8] == 0) | (gathered[8] == 1)
        err_max, exact_max = err.max().item(), err[exact].max().item()
        ok = err_max <= PACK4_TOL and exact_max == 0
        log(f"[device data] pack-4 gather against pack-8 on the card: max err {err_max:.4f} "
            f"(tol {PACK4_TOL:.4f}), at 0 and 1 {exact_max:g} (must be 0) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the 4-bit gather departs from the 8-bit one")
        del gathered, big, state
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_per_step": launches / (train_steps + eval_steps),
            "backward_launches_per_train_step": backward_launches / train_steps}


def int8_phase(batch) -> dict:
    """Phase 9: int8 cross- and self-attention K/V on 8 full canvases."""
    from texocr_tpu_torch.models import greedy_decode

    engine = flagship_engine(kv_quant="int8", self_kv_quant="int8")
    engine.generate_batch(batch, max_len=DECODE_STEPS)  # the key's capture
    with counted() as n:
        tokens = engine.generate_batch(batch, max_len=DECODE_STEPS)
        torch.cuda.synchronize()
    launches = expect_launches(n, 1, "int8 generate_batch")
    decode_launches = expect_decode_launches(engine, n, batch_steps(engine, tokens),
                                             "int8 generate_batch")
    if tokens.shape != (BATCH, DECODE_STEPS):
        raise AssertionError(f"int8 tokens of shape {tuple(tokens.shape)}")

    model, cfg = engine.model, engine.model.config
    ref = flagship_engine().model  # the same weights, unquantized caches
    common = dict(bos_token=cfg.bos_token, eos_token=-1, pad_token=cfg.pad_token,
                  max_len=DECODE_STEPS)
    with torch.inference_mode():
        enc = ref.encode(to_input(batch))
    tok_ref, logits_ref = greedy_decode(ref, enc, return_logits=True, **common)
    tok8, logits8 = greedy_decode(model, enc, return_logits=True, **common)
    differ = tok_ref != tok8
    first = torch.where(differ.any(1), differ.int().argmax(1), DECODE_STEPS - 1)
    same_prefix = torch.arange(DECODE_STEPS, device=first.device)[None] <= first[:, None]
    err = ((logits8 - logits_ref).abs().amax(-1) * same_prefix).max().item()
    scale = logits_ref.abs().amax(-1)[same_prefix].max().item()
    agree = 1.0 - differ.float().mean().item()
    ok = err / scale < INT8_BUDGET and bool(torch.isfinite(logits8).all())
    log(f"[int8] batch {BATCH} (160, 1008) bf16, kv_quant and self_kv_quant int8, "
        f"{DECODE_STEPS} steps: max|logit err| {err:.4f} / max|logit| {scale:.4f} = "
        f"{err / scale:.5f} (budget {INT8_BUDGET}) over each row's steps up to its first "
        f"differing token (first differences {first.tolist()}); tokens agreeing "
        f"{100 * agree:.1f}%; flash launches {launches} for 1 encode; decode attention "
        f"launches {decode_launches['launches']} over {decode_launches['steps']} decoded steps "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("int8 decode logits outside the int8 budget")
    return {"launches": launches, "encodes": 1, "decode_launches": decode_launches}


def sample_phase(batch) -> dict:
    """Phase 10: sampled decode, its limits and its filter."""
    from texocr_tpu_torch.models import greedy_decode, sampled_decode

    temp = 1e-4
    f32 = flagship_engine(dtype="float32").model
    cfg = f32.config
    common = dict(bos_token=cfg.bos_token, eos_token=-1, pad_token=cfg.pad_token)
    with torch.inference_mode():
        enc = f32.encode(to_input(batch[:2]))
    greedy, logits = greedy_decode(f32, enc, max_len=SAMPLE_CHECK_STEPS, return_logits=True,
                                   **common)
    gen = torch.Generator(device=enc.device).manual_seed(0)
    sampled = sampled_decode(f32, enc, gen, temp=temp, max_len=SAMPLE_CHECK_STEPS, **common)
    exact_rows, departures = 0, []
    for row in range(2):
        differ = (sampled[row] != greedy[row]).nonzero()
        if len(differ) == 0:
            exact_rows += 1
            continue
        t = int(differ[0])  # the prefixes agree up to here: so do the step logits
        step = logits[row, t]
        departures.append((row, t, (step.max() - step[sampled[row, t]]).item()))
    del f32
    ok_limit = all(gap <= 20 * temp for _, _, gap in departures)
    log(f"[sample] float32, 2 full canvases, {SAMPLE_CHECK_STEPS} steps at temp {temp:g}: "
        f"{exact_rows} of 2 rows equal greedy's tokens; departures (row, step, top logit - "
        f"sampled token's logit) {departures} (each within 20 x temp) "
        f"{'ok' if ok_limit else 'FAIL'}")
    if not ok_limit:
        raise AssertionError("sampling at a tiny temperature left greedy's argmax")

    engine = flagship_engine()
    engine.generate_batch(batch, max_len=DECODE_STEPS, mode="sample")  # the key's capture
    with counted() as n:
        engine.generate_batch(batch, max_len=DECODE_STEPS, mode="sample")
    launches = expect_launches(n, 1, "sample generate_batch")
    model = engine.model
    with torch.inference_mode():
        enc = model.encode(to_input(batch))
    gen = torch.Generator(device=enc.device).manual_seed(1)
    tokens, logits = sampled_decode(model, enc, gen, temp=0.3, max_len=DECODE_STEPS,
                                    return_logits=True, **common)
    above = (logits > logits.gather(-1, tokens[..., None])).sum(-1)  # (B, steps)
    ok = bool((above < TOPK).all())
    log(f"[sample] bf16, batch {BATCH} (160, 1008), temp 0.3, {DECODE_STEPS} steps: every "
        f"token in its step's top {TOPK} ({int(above.max())} logits above the worst) "
        f"{'ok' if ok else 'FAIL'}; generate_batch's flash launches {launches} for 1 encode")
    if not ok:
        raise AssertionError("a sampled token lies outside the top-k filter")
    return {"launches": launches, "encodes": 1}


def beam_phase(batch) -> dict:
    """Phase 11: beam search through the graphs in bf16, checked in float32."""
    from texocr_tpu_torch.models import beam_decode, greedy_decode
    from texocr_tpu_torch.models.beam import sequence_logprob

    engine = flagship_engine()
    engine.generate_batch(batch, max_len=DECODE_STEPS, mode="beam", beam_size=BEAM)  # capture
    with counted() as n:
        engine.generate_batch(batch, max_len=DECODE_STEPS, mode="beam", beam_size=BEAM)
    launches = expect_launches(n, 1, "beam generate_batch")
    log(f"[beam] bf16, batch {BATCH} x beam {BEAM} (160, 1008), {DECODE_STEPS} tokens through "
        f"the graphs: flash launches {launches} for 1 encode")
    del engine

    for quant in ("none", "int8"):
        m = flagship_engine(dtype="float32", self_kv_quant=quant).model
        c = m.config
        common = dict(bos_token=c.bos_token, eos_token=c.eos_token, pad_token=c.pad_token,
                      max_len=BEAM_CHECK_STEPS)
        with torch.inference_mode():
            enc = m.encode(to_input(batch[:2]))
        greedy = greedy_decode(m, enc, **common)
        beam1 = beam_decode(m, enc, beam_size=1, **common)
        tokens, scores = beam_decode(m, enc, beam_size=BEAM, return_scores=True, **common)
        score = dict(bos_token=c.bos_token, eos_token=c.eos_token)
        forced = sequence_logprob(m, enc, tokens, cached=True, **score)
        ok = (torch.equal(beam1, greedy)
              and torch.allclose(scores, forced, rtol=SCORE_RTOL, atol=SCORE_RTOL))
        note = (f"beam 1 {'equals' if torch.equal(beam1, greedy) else 'DIFFERS FROM'} greedy; "
                f"beam {BEAM} scores {scores.tolist()}, its tokens through the cached step "
                f"{forced.tolist()}")
        if quant == "none":
            tf = sequence_logprob(m, enc, tokens, **score)
            ok = ok and torch.allclose(scores, tf, rtol=SCORE_RTOL, atol=SCORE_RTOL)
            note += f", teacher-forced {tf.tolist()}"
        log(f"[beam] float32, 2 full canvases, {BEAM_CHECK_STEPS} steps, self_kv_quant "
            f"{quant}: {note} (rtol {SCORE_RTOL:g}) {'ok' if ok else 'FAIL'}")
        del m
        if not ok:
            raise AssertionError(f"beam search check failed (self_kv_quant {quant})")
    return {"launches": launches, "encodes": 1}


def png_bytes(img: np.ndarray, rgb: bool = False) -> bytes:
    """An 8-bit PNG of a 2-D uint8 array, grey or (``rgb``) its grey copied
    into R, G and B, with each row's filter chosen as PIL's and libpng's
    encoders choose it: of None, Sub, Up, Average and Paeth, the one whose
    filtered bytes, read as signed, have the least sum of magnitudes (the
    lowest type on a tie). Stdlib and numpy only."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    h, w = img.shape
    bpp = 3 if rgb else 1
    x = np.repeat(img, bpp, axis=1).astype(np.int32)  # (H, W * bpp) scanlines
    up = np.vstack([np.zeros_like(x[:1]), x[:-1]])
    left = np.hstack([np.zeros_like(x[:, :bpp]), x[:, :-bpp]])
    upleft = np.hstack([np.zeros_like(up[:, :bpp]), up[:, :-bpp]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    filtered = np.stack([x, x - left, x - up, x - (left + up) // 2, x - paeth]) & 0xFF
    cost = np.abs(filtered.astype(np.uint8).view(np.int8).astype(np.int32)).sum(-1)  # (5, H)
    kind = cost.argmin(0)
    rows = np.hstack([kind[:, None], filtered[kind, np.arange(h)]]).astype(np.uint8)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if rgb else 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


def http_phase(rng) -> dict:
    """Phase 12: the HTTP server over the micro-batcher, greedy."""
    from texocr_tpu_torch.serving.batcher import ServingBatcher
    from texocr_tpu_torch.serving.http_server import make_server, serve_in_thread
    from texocr_tpu_torch.serving.image_io import decode_image

    sizes = ((160, 1008), (96, 512), (32, 128))
    engine = flagship_engine()
    batcher = ServingBatcher(engine, max_batch=HTTP_CONCURRENCY, max_len=DECODE_STEPS)
    server = make_server(batcher, port=0)
    serve_in_thread(server)
    host, port = server.server_address[:2]
    url = f"http://{host}:{port}"
    # Each batch the batcher forms: (rows after padding, requests). The
    # padding canvases are all zero; a request's canvas never is.
    formed = []
    generate_batch = engine.generate_batch

    def recording(canvases, **kw):
        formed.append((len(canvases), int((canvases.reshape(len(canvases), -1).max(1) > 0).sum())))
        return generate_batch(canvases, **kw)

    try:
        batcher.warmup(sizes)

        def post(data, timeout=600):
            req = urllib.request.Request(f"{url}/ocr", data=data, method="POST",
                                         headers={"Content-Type": "image/png"})
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return json.loads(r.read())

        solo = canvas(rng, *sizes[0])
        want_ids, _ = engine(solo, max_len=DECODE_STEPS)
        engine.generate_batch = recording
        with counted() as n:
            if post(png_bytes(solo))["tokens"] != want_ids:
                raise AssertionError("a solo POST differs from engine(img) on the same canvas")
            # Every other request is RGB: the server turns it to grey.
            images = [canvas(rng, *sizes[i % 3]) for i in range(HTTP_REQUESTS)]
            bodies = [png_bytes(img, rgb=i % 2 == 1) for i, img in enumerate(images)]
            for img, body in zip(images, bodies):
                if not np.array_equal(decode_image(body), img):
                    raise AssertionError("decode_image does not return the canvas it was given")
            with ThreadPoolExecutor(max_workers=HTTP_CONCURRENCY) as ex:
                results = list(ex.map(post, bodies))
        launches = expect_launches(n, len(formed), "http")
        for payload in results:
            if not (isinstance(payload.get("latex"), str) and payload["tokens"]
                    and all(isinstance(t, int) and 0 <= t < 1000 for t in payload["tokens"])):
                raise AssertionError(f"bad /ocr response: {str(payload)[:200]}")
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        if not (health["status"] == "ok" and health["warm"] and health["max_batch"] == 8):
            raise AssertionError(f"bad /healthz: {health}")
        try:
            post(b"this is not an image", timeout=30)
            raise AssertionError("a body that is no image was accepted")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                raise AssertionError(f"a body that is no image gave {e.code}, not 400") from None
    finally:
        server.shutdown()
        server.server_close()
        batcher.shutdown()
    log(f"[http] solo POST equals engine(img); {HTTP_REQUESTS} POSTs of {len(sizes)} canvas "
        f"sizes (grey and RGB PNGs, rows filtered as PIL writes them) at concurrency "
        f"{HTTP_CONCURRENCY}, max_len {DECODE_STEPS}; decode_image gives back every canvas; "
        f"formed batches (rows, requests) {formed[1:]}; /healthz ok, 400 for no image; flash "
        f"launches {launches} for {len(formed)} encodes ok")
    return {"launches": launches, "encodes": len(formed)}


def eval_phase(rng) -> dict:
    """Phase 13: test_model through the CUDA graphs on a pickled split of two
    full batches, greedy and beam 5 (see the module docstring)."""
    from texocr_tpu_torch.data.dataset import ImageDataset, create_dataloader
    from texocr_tpu_torch.evaluation.evaluate import test_model
    from texocr_tpu_torch.evaluation.metrics import batch_acc, edit_similarity, exact_match_rate
    from texocr_tpu_torch.models import generate

    engine = flagship_engine()
    model = engine.model
    config = {"batch_size": EVAL_BATCH, "seq_pad_multiple": 32, "seed": 42}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = write_split(tmp, "test", [((160, 1008), 2 * EVAL_BATCH)], rng)
        test_set = ImageDataset.load(path)
        loader = create_dataloader(test_set, config)
        batches = []
        for ids in loader.sampler:
            images, labels = loader.collate([test_set[i] for i in ids])
            u8 = np.stack([test_set.images[i] for i in ids])[..., None]
            batches.append((images, labels, u8))
        for mode in ("greedy", "beam"):
            pairs = os.path.join(tmp, f"pairs_{mode}.jsonl")
            with counted() as n:
                got = test_model(test_set, model, config, max_len=EVAL_MAX_LEN, verbose=False,
                                 decode_mode=mode, beam_size=BEAM, pairs_out=pairs)
            # Each key's capture runs one eager encode first (its warm-up).
            encodes = got["batches"] + n["keys"]
            launches = expect_launches(n, encodes, f"eval {mode}")

            # The same collated float batches through the eager generate.
            with open(pairs) as f:
                written = [json.loads(line)["pred"] for line in f]
            eager_rows = []
            for images, _, _ in batches:
                pred = generate(model, torch.from_numpy(images).cuda(), max_len=EVAL_MAX_LEN,
                                mode=mode, beam_size=BEAM)
                eager_rows += [[int(t) for t in row if t != 999] for row in pred.cpu().numpy()]
            same = written == eager_rows

            accs, ems, sims = [], [], []
            for _, labels, u8 in batches:
                pred = engine.generate_batch(u8, max_len=EVAL_MAX_LEN, mode=mode,
                                             beam_size=BEAM).cpu().numpy()
                target = labels[:, 1:]
                accs.append(batch_acc(pred, target, 999))
                ems.append(exact_match_rate(pred, target, 999))
                sims.append(edit_similarity(pred, target, 999))
            want = {"token_acc": float(np.mean(accs)), "exact_match": float(np.mean(ems)),
                    "edit_similarity": float(np.mean(sims)), "batches": len(accs)}
            ok = got == want and got["batches"] == 2 and same
            log(f"[eval] test_model {mode} through the graphs: {got}; from generate_batch on "
                f"the same batches {want}; pairs_out tokens "
                f"{'bit-equal to' if same else 'DIFFER FROM'} the eager generate's; flash "
                f"launches {launches} for {encodes} encodes ({got['batches']} replays, "
                f"{n['keys']} capture warm-ups) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"test_model's {mode} decode through the graphs differs")
            out[mode] = {"launches": launches, "encodes": encodes}
    return out


def variant_overrides(name) -> dict:
    """The config keys of a model variant, over the flagship's."""
    from texocr_tpu_torch.config import FLAGSHIP

    return {"patch": {"encoder": dict(FLAGSHIP["encoder"], embed_layer="patch")},
            "glu false": {"glu": False},
            "no cross": {"decoder": dict(FLAGSHIP["decoder"], cross_attend=False)}}[name]


def serve_variant(name, batch, rng, flagship_encode_err) -> dict:
    """A variant's greedy generate_batch through the CUDA graphs against the
    eager generate, its launches and its float32 encode on both paths. A
    variant that keeps the flagship's encoder (``glu`` reaches only the
    decoder) reuses phase 7's reading of that encoder,
    ``flagship_encode_err``, instead of encoding again."""
    from texocr_tpu_torch.models import generate

    overrides = variant_overrides(name)
    engine = flagship_engine(**overrides)
    engine.generate_batch(batch, max_len=DECODE_STEPS)  # the key's capture
    with counted() as n:
        tokens = engine.generate_batch(batch, max_len=DECODE_STEPS)
        torch.cuda.synchronize()
    launches = expect_launches(n, 1, f"{name} generate_batch")
    with torch.inference_mode():
        eager = generate(engine.model, to_input(batch), max_len=DECODE_STEPS)
    same = tokens.shape == (BATCH, DECODE_STEPS) and torch.equal(tokens, eager)
    own_encoder = "encoder" in overrides
    err = encode_paths_err(rng, overrides) if own_encoder else flagship_encode_err
    ok = same and err <= F32_TOL
    log(f"[variants] {name}: batch {BATCH} (160, 1008) bf16 greedy {DECODE_STEPS} tokens "
        f"through the graphs, tokens {'bit-equal to' if same else 'DIFFER FROM'} the eager "
        f"generate's; flash launches {launches} for 1 encode; float32 encode kernel vs plain "
        f"path max err {err:.3e} "
        f"({'this encoder' if own_encoder else 'the flagship encoder, phase 7'}; tol "
        f"{F32_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {name} variant failed on the card")
    return {"launches": launches, "encodes": 1}


def no_cross_variant(rng) -> dict:
    """The decoder without cross-attention: VARIANT_TRAIN_STEPS train steps
    at batch TRAIN_BATCH on full canvases, and every decode entry point
    refusing it."""
    from texocr_tpu_torch.config import FLAGSHIP, ModelConfig
    from texocr_tpu_torch.models import OCRModel
    from texocr_tpu_torch.models.graphed import make_graphed_generate
    from texocr_tpu_torch.training.optimizers import get_optimizer
    from texocr_tpu_torch.training.train_step import create_train_state, make_train_step, put_batch

    overrides = variant_overrides("no cross")
    model = OCRModel(ModelConfig.from_dict(dict(FLAGSHIP, **overrides)), device="cuda", seed=0)
    state = create_train_state(model, get_optimizer("Adam", {"lr": 0.0005}, model.parameters()),
                               seed=42)
    train_step = make_train_step()
    images = 1.0 - np.stack([canvas(rng, 160, 1008) for _ in range(TRAIN_BATCH)])[
        ..., None].astype(np.float32) / 255.0
    rows = train_tokens(rng, TRAIN_BATCH)
    labels = np.full((TRAIN_BATCH, -(-(max(map(len, rows)) + 2) // 32) * 32), 999, np.int64)
    for i, row in enumerate(rows):
        labels[i, : len(row) + 2] = [998, *row, 997]
    x, y = put_batch(images, labels, "cuda")
    with counted() as n:
        losses = [float(train_step(state, x, y)["loss"]) for _ in range(VARIANT_TRAIN_STEPS)]
    launches = n["flash"]
    refused = []
    engine = flagship_engine(**overrides)
    for what, call in (
        ("TexOCR.generate_batch", lambda: engine.generate_batch(np.full((1, 160, 1008, 1), 255,
                                                                        np.uint8))),
        ("make_graphed_generate", lambda: make_graphed_generate(model, 1, (160, 1008),
                                                                DECODE_STEPS)),
    ):
        try:
            call()
        except ValueError as e:
            refused.append(what if "cross_attend: false" in str(e) else f"{what}: {e}")
    ok = (np.isfinite(losses).all() and launches == 0
          and refused == ["TexOCR.generate_batch", "make_graphed_generate"])
    log(f"[variants] no cross: {VARIANT_TRAIN_STEPS} train steps at batch {TRAIN_BATCH} "
        f"{labels.shape[1]} tokens, full canvases, bf16: losses {losses}; flash launches "
        f"{launches} (the decoder reads no encoder output, "
        f"so the step does not encode); ValueError from {refused} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the no-cross variant failed on the card")
    return {"launches": launches, "encodes": 0}


def maps_variant(batch, rng) -> dict:
    """A teacher-forced decoder(..., return_attn=True) replay at batch BATCH x
    MAPS_TOKENS on the flagship, then the attention-maps tool's main on one
    full-canvas PNG."""
    from texocr_tpu_torch.config import FLAGSHIP
    from texocr_tpu_torch.serving.image_io import decode_png, encode_png
    from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH
    from texocr_tpu_torch.tools import attention_maps

    model = flagship_engine().model
    n_layers = FLAGSHIP["decoder"]["num_layers"]
    seq = torch.from_numpy(rng.integers(0, 997, (BATCH, MAPS_TOKENS))).cuda()
    seq[:, 0] = 998
    with torch.inference_mode():
        enc = model.encode(to_input(batch))
        with counted() as n:
            logits, maps = model.dec(seq, enc, return_attn=True)
        launches = n["flash"]
        cross = maps[1::2]
        shapes = sorted({tuple(m.shape) for m in cross})
        row_err = max((m.sum(-1) - 1).abs().max().item() for m in maps)
    want = (BATCH, 8, MAPS_TOKENS, enc.shape[1])
    ok = (len(maps) == 2 * n_layers and shapes == [want] and row_err <= F32_TOL
          and launches == 0 and bool(torch.isfinite(logits).all()))
    log(f"[variants] maps: decoder(return_attn=True) at batch {BATCH} x {MAPS_TOKENS} tokens, "
        f"bf16: {len(maps)} maps, cross maps {shapes} float32, rows sum to 1 within "
        f"{row_err:.2e} (tol {F32_TOL:g}); flash launches {launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the attention maps failed on the card")
    del logits, maps, cross, enc

    with tempfile.TemporaryDirectory() as tmp:
        png, cfg, out = (os.path.join(tmp, name) for name in ("eq.png", "cfg.json", "maps"))
        with open(png, "wb") as f:
            f.write(encode_png(canvas(rng, 160, 1008)))
        with open(cfg, "w") as f:
            json.dump(dict(FLAGSHIP, tokenizer_path=DEFAULT_VOCAB_PATH, seed=0), f)
        with counted() as n:
            rc = attention_maps.main([png, "--config", cfg, "--out", out, "--max_len",
                                      str(DECODE_STEPS), "--max_tokens", str(MAPS_PNGS),
                                      "--device", "cuda"])
        # The capture's eager warm-up, the graph replay and the maps replay's.
        tool_launches = expect_launches(n, 3, "attention-maps tool")
        with open(os.path.join(out, "summary.json")) as f:
            summary = json.load(f)
        names = sorted(os.listdir(out))
        with open(os.path.join(out, "token_000.png"), "rb") as f:
            overlay = decode_png(f.read())
    n_png = min(len(summary["tokens"]), MAPS_PNGS)
    ok = (rc == 0 and sorted(summary) == ["grid", "latex", "per_token", "tokens"]
          and summary["grid"] == [10, 63] and len(summary["per_token"]) == n_png
          and names == sorted([f"token_{t:03d}.png" for t in range(n_png)] + ["summary.json"])
          and overlay.shape == (160, 1008))
    log(f"[variants] attention-maps tool on a (160, 1008) PNG: rc {rc}, "
        f"{len(summary['tokens'])} tokens decoded, {n_png} overlays read back at "
        f"{overlay.shape}, grid {summary['grid']}; flash launches {tool_launches} for 3 "
        f"encodes (the capture's warm-up, the graph replay, the maps replay) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the attention-maps tool failed on the card")
    return {"replay": {"launches": launches, "encodes": 0},
            "tool": {"launches": tool_launches, "encodes": 3}}


def variants_phase(batch, rng, flagship_encode_err) -> dict:
    """Phase 13b: the model variants and the attention maps (see the module
    docstring); ``flagship_encode_err``: phase 7's float32 encoder reading.
    Returns each path's launches and encodes."""
    out = {name: serve_variant(name, batch, rng, flagship_encode_err)
           for name in ("patch", "glu false")}
    out["no cross"] = no_cross_variant(rng)
    maps = maps_variant(batch, rng)
    out["maps replay"], out["maps tool"] = maps["replay"], maps["tool"]
    return out


DATA_CANVAS = (160, 1008)  # phase 15 pads every render onto the flagship's canvas
DATA_SPLITS = {"train": 2 * TRAIN_BATCH, "test": 16, "val": TRAIN_BATCH}  # rows per split
ENCODE_LABELS = 20_000  # labels through encode_batch, native against pure Python
LABEL_SYMBOLS = ("x", "y", "z", "a", "b", "n", "k", "\\alpha", "\\beta", "\\theta", "\\pi",
                 "\\lambda")


def latex_labels(rng, n) -> list:
    """``n`` seeded LaTeX labels in the reference's spaced token style: one to
    three terms (scripts, fractions, roots, integrals, functions) joined by
    operators, all inside the TeX subset that mathtext typesets."""
    def term():
        s, t = (LABEL_SYMBOLS[i] for i in rng.integers(len(LABEL_SYMBOLS), size=2))
        d = int(rng.integers(0, 100))
        return (f"{s} ^ {{ {d} }}", f"{s} _ {{ {t} }}", f"\\frac {{ {s} }} {{ {d} }}",
                f"\\sqrt {{ {s} + {d} }}", f"\\sin {s}", f"{d} {s}",
                f"\\int _ {{ 0 }} ^ {{ {d} }} {s} d {t}",
                f"( {s} - {t} ) ^ {{ 2 }}")[int(rng.integers(8))]

    ops = ("+", "-", "=", "\\cdot")
    labels = []
    for _ in range(n):
        parts = [term()]
        for _ in range(int(rng.integers(0, 3))):
            parts += [ops[int(rng.integers(len(ops)))], term()]
        labels.append(" ".join(parts))
    return labels


def tokenizer_check(rng) -> None:
    """Phase 15a: the g++-built native encoder, the goldens through encode
    and encode_batch, a retrain on the golden corpus, and encode_batch's
    native ids against pure Python's."""
    from texocr_tpu_torch.ops import build
    from texocr_tpu_torch.tokenizer import RegexBPETokenizer, load_default_tokenizer, native

    library, _ = build.build(native.SOURCE)
    if not native.native_available():
        raise AssertionError(f"the native BPE encoder did not load: {native.native_error()}")
    log(f"[data] {native.SOURCE} built by {build.host_compiler_path()} ({library.name})")

    with open(os.path.join(REPO, "tests", "goldens", "tokenizer_encode.json")) as f:
        goldens = json.load(f)
    with open(os.path.join(REPO, "tests", "goldens", "tokenizer_train.json")) as f:
        golden_train = json.load(f)
    tok = load_default_tokenizer()
    texts, want = [c["text"] for c in goldens], [c["ids"] for c in goldens]
    calls = native.NativeBPEEncoder.calls
    batch = tok.encode_batch(texts)
    native_calls = native.NativeBPEEncoder.calls - calls
    ok = [tok.encode(t) for t in texts] == want and batch == want and native_calls == 1
    log(f"[data] goldens: {len(texts)} texts through encode and encode_batch ({native_calls} "
        f"native call) {'exact' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the tokenizer's ids differ from the goldens, or encode_batch "
                             "did not run natively")
    corpus = "\n".join(t for t in texts if t) * golden_train["corpus_repeats"]
    trained = RegexBPETokenizer(golden_train["vocab_size"], dict(golden_train["special_tokens"]))
    trained.train(corpus)
    golden_merges = {tuple(k): v for k, v in golden_train["merges"]}
    ok = trained.bp_merges == golden_merges
    log(f"[data] retrain on the golden corpus ({golden_train['vocab_size']} tokens, x"
        f"{golden_train['corpus_repeats']}): {len(trained.bp_merges)} merges, "
        f"{'equal to' if ok else 'FAIL: not'} the golden {len(golden_merges)}")
    if not ok:
        raise AssertionError("retrained merges differ from the golden")

    labels = latex_labels(rng, ENCODE_LABELS)
    calls = native.NativeBPEEncoder.calls
    fast = tok.encode_batch(labels)
    if native.NativeBPEEncoder.calls != calls + 1:
        raise AssertionError("encode_batch did not run natively")
    if fast != [tok.encode(t) for t in labels]:
        raise AssertionError("encode_batch's native ids differ from encode's")
    log(f"[data] encode_batch of {ENCODE_LABELS} seeded labels: native ids equal to pure "
        f"Python's")


def renderer_choice() -> str:
    """latex where its binaries are, else mathtext where matplotlib imports,
    else "written" (the phase writes the PNGs itself)."""
    from texocr_tpu_torch.data.factory.render_data import check_binaries

    missing = check_binaries()
    if missing is None:
        return "latex"
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return "written"
    return "mathtext"


def build_data(rng, root) -> dict:
    """Phase 15b: split, render, prune, pad to DATA_CANVAS, then pickle every
    split eager and lazy through pickle_data with a .json data config."""
    from texocr_tpu_torch.data.factory import pickle_data, render_data, split_data
    from texocr_tpu_torch.serving.image_io import decode_png, encode_png
    from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH

    total = sum(DATA_SPLITS.values())
    master = os.path.join(root, "master.txt")
    with open(master, "w") as f:
        f.write("\n".join(latex_labels(rng, total)) + "\n")
    data_dir = os.path.join(root, "data")
    config = {"num_equations": total, "seed": 42, "patch_size": 16,
              "num_processes": os.cpu_count(), "tokenizer_path": DEFAULT_VOCAB_PATH,
              "splits": {s: DATA_SPLITS[s] / total for s in ("train", "test", "val")},
              **{f"{s}_dir": os.path.join(data_dir, s) for s in DATA_SPLITS}}
    cfg_path = os.path.join(root, "data.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    split_data.main([master, data_dir, "-c", cfg_path])

    renderer = renderer_choice()
    log(f"[data] renderer: {renderer} ("
        + {"latex": "latex, dvipng and convert found",
           "mathtext": "no latex chain (" + str(render_data.check_binaries()) + "); matplotlib "
                       "typesets",
           "written": "neither the latex chain nor matplotlib: the phase writes each PNG at the "
                      "canvas rule with encode_png"}[renderer] + ")")
    for split in DATA_SPLITS:
        split_dir = config[f"{split}_dir"]
        if renderer == "written":
            os.makedirs(os.path.join(split_dir, "images"))
            with open(os.path.join(split_dir, "ids.txt")) as f:
                for image_id in f.read().split():
                    h, w = 16 * int(rng.integers(2, 7)), 64 * int(rng.integers(2, 9))
                    with open(os.path.join(split_dir, "images", image_id), "wb") as g:
                        g.write(encode_png(canvas(rng, h, w)))
        else:
            render_data.render_images(split_dir, num_processes=config["num_processes"],
                                      patch_size=config["patch_size"], renderer=renderer)
        render_data.prune_equations(split_dir)

    # Every render onto the full canvas, centred as convert -gravity center pads.
    sizes, rows = {}, {}
    for split in DATA_SPLITS:
        images = os.path.join(config[f"{split}_dir"], "images")
        names = sorted(os.listdir(images))
        rows[split] = len(names)
        for name in names:
            with open(os.path.join(images, name), "rb") as f:
                img = decode_png(f.read())
            h, w = img.shape
            sizes[(h, w)] = sizes.get((h, w), 0) + 1
            if h > DATA_CANVAS[0] or w > DATA_CANVAS[1]:
                raise AssertionError(f"{name} renders at {(h, w)}, beyond {DATA_CANVAS}")
            full = np.full(DATA_CANVAS, 255, np.uint8)
            top, left = (DATA_CANVAS[0] - h) // 2, (DATA_CANVAS[1] - w) // 2
            full[top: top + h, left: left + w] = img
            with open(os.path.join(images, name), "wb") as f:
                f.write(encode_png(full))
    if rows["train"] < DATA_SPLITS["train"] or rows["val"] < DATA_SPLITS["val"]:
        raise AssertionError(f"rendered rows {rows}, fewer than {DATA_SPLITS}")
    log(f"[data] split {total} equations, rendered ({renderer}): rows {rows}, rendered sizes "
        f"(h, w) from {min(sizes)} to {max(sizes)} over {len(sizes)} sizes, padded to "
        f"{DATA_CANVAS}")

    for lazy in (False, True):
        kind = "lazy" if lazy else "eager"
        for split in DATA_SPLITS:
            os.makedirs(os.path.join(root, kind, split))
            pickle_data.main(pickle_data.parse_args(
                ["-c", cfg_path, "--split", split, "-s",
                 os.path.join(root, kind, split, f"{split}set.pkl")] + ["--lazy"] * lazy))


def data_phase(rng) -> dict:
    """Phase 15: the data path on the card's machine, then the flagship
    trained on what it built (see the module docstring)."""
    from texocr_tpu_torch.data.dataset import create_dataloader, load_datasets
    from texocr_tpu_torch.training import cli as train_cli

    tokenizer_check(rng)
    out = {}
    with tempfile.TemporaryDirectory() as root:
        build_data(rng, root)
        config = train_config(os.path.join(root, "checkpoints"))
        config["n_epochs"] = 1
        cfg_path = os.path.join(root, "train.json")
        with open(cfg_path, "w") as f:
            json.dump(config, f)

        for kind in ("eager", "lazy"):
            metrics = os.path.join(root, f"{kind}.jsonl")
            with counted() as n:
                train_cli.main(train_cli.parse_args(["-d", os.path.join(root, kind), "--config",
                                                     cfg_path, "--metrics", metrics,
                                                     "--device", "cuda"]))
            launches = n["flash"]
            with open(metrics) as f:
                records = [json.loads(line) for line in f]
            epochs = [r for r in records if r["event"] == "train_epoch"]
            vals = [r for r in records if r["event"] == "val"]
            steps = sum(r["steps"] for r in epochs)
            val_steps = DATA_SPLITS["val"] // TRAIN_BATCH
            losses = [r["loss"] for r in epochs + vals]
            ok = (len(epochs) == 1 and steps == DATA_SPLITS["train"] // TRAIN_BATCH
                  and np.isfinite(losses).all() and launches == N_LAYERS * (steps + val_steps))
            log(f"[data] {kind}: training.cli, 1 epoch at batch {TRAIN_BATCH} on {DATA_CANVAS}: "
                f"{steps} train and {val_steps} val steps, losses {losses}, flash launches "
                f"{launches} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{kind} training: expected {N_LAYERS} flash launches per "
                                     "encode, finite losses and one epoch")
            out[kind] = {"launches": launches, "encodes": int(steps) + val_steps}

        # The lazy pickle's batches are the eager one's (augmentation off).
        eager, lazy = load_datasets(os.path.join(root, "eager")), load_datasets(
            os.path.join(root, "lazy"))
        n_batches = 0
        for e_set, l_set in zip(eager, lazy):
            if not l_set.lazy or e_set.lazy:
                raise AssertionError("the lazy pickle loaded eager, or the eager one lazy")
            for (ei, el), (li, ll) in zip(create_dataloader(e_set, config),
                                          create_dataloader(l_set, config), strict=True):
                if not (np.array_equal(ei, li) and np.array_equal(el, ll)):
                    raise AssertionError("a lazy batch differs from the eager one")
                n_batches += 1
        log(f"[data] lazy and eager batches equal, augmentation off ({n_batches} batches)")
    return out


def world1_phase(trained) -> dict:
    """Phase 16a: phase 8's train_model, data and seed on a process group of
    one rank over NCCL (the whole distributed path: the mesh, the global
    loss's count and the gradients' all-reduce on the card). Fatal: epoch
    losses beyond WORLD1_RTOL of phase 8's, other than 4 flash launches per
    step."""
    import torch.distributed as dist

    from texocr_tpu_torch.data.dataset import create_dataloader, load_datasets
    from texocr_tpu_torch.training.loop import train_model

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1,
                                rank=0)
        try:
            train_set, val_set, _ = load_datasets(trained["data_dir"])
            train_set.augment = True  # as phase 8
            config = train_config(os.path.join(tmp, "checkpoints"))
            with counted() as n:
                model, state, history = train_model(train_set, val_set, config, verbose=False,
                                                    device="cuda")
            launches = n["flash"]
            eval_steps = TRAIN_EPOCHS * len(create_dataloader(val_set, config))
            if launches != 4 * (state.step + eval_steps):
                raise AssertionError(f"world of 1: {launches} flash launches for {state.step} "
                                     f"train and {eval_steps} eval steps")
            want = trained["epoch_losses"]
            err = float(np.max(np.abs(np.array(history) - want) / np.abs(want)))
            log(f"[parallel] (a) NCCL world of 1, mesh {{data: 1, model: 1}}: train_model "
                f"epoch losses {history} against phase 8's {want}: max relative difference "
                f"{err:.3e} (tol {WORLD1_RTOL:g}) {'ok' if err <= WORLD1_RTOL else 'FAIL'}; "
                f"flash launches {launches}")
            if not err <= WORLD1_RTOL:
                raise AssertionError("the world-of-1 run's losses differ from phase 8's")
        finally:
            dist.destroy_process_group()
    del model, state
    torch.cuda.empty_cache()
    return {"launches": launches}


def parallel_batch(seed, n):
    """Global batch ``seed`` of ``n`` full canvases, as the host collator
    makes it: the same arrays in every process that asks."""
    from texocr_tpu_torch.data.dataset import BatchCollator

    rng = np.random.default_rng(1600 + seed)
    batch = [(1.0 - canvas(rng, 160, 1008)[..., None].astype(np.float32) / 255.0, ids)
             for ids in train_tokens(rng, n)]
    return BatchCollator(999, 998, 997, seq_pad_multiple=32)(batch)


def flagship_model(dtype, mesh=None, **overrides):
    from texocr_tpu_torch.config import FLAGSHIP, ModelConfig
    from texocr_tpu_torch.models import OCRModel

    return OCRModel(ModelConfig.from_dict(dict(FLAGSHIP, dtype=dtype, **overrides)),
                    device="cuda", seed=0, mesh=mesh)


def parallel_steps(axis, sharded) -> dict:
    """PARALLEL_STEPS Adam steps of the bf16 flagship on the global batches
    of PARALLEL_BATCHES[axis] rows, on the mesh ``{axis: 2}`` if
    ``sharded`` (else in one process): each step's global loss and this
    rank's flash launches."""
    from texocr_tpu_torch.parallel.mesh import create_mesh
    from texocr_tpu_torch.parallel.sharding import batch_rows
    from texocr_tpu_torch.training.optimizers import get_optimizer
    from texocr_tpu_torch.training.train_step import create_train_state, make_train_step

    mesh = create_mesh({axis: 2}, device="cuda") if sharded else None
    model = flagship_model("bfloat16", mesh)
    state = create_train_state(model, get_optimizer("Adam", {"lr": 5e-4}, model.parameters(),
                                                    model.tp), seed=42)
    step = make_train_step(mask_pad=True)
    out = {"losses": [], "launches": []}
    for i in range(PARALLEL_STEPS):
        images, labels = parallel_batch(i, PARALLEL_BATCHES[axis])
        rows = batch_rows(len(images), mesh)
        images, labels = (torch.from_numpy(x[rows]).cuda() for x in (images, labels))
        with counted() as n:
            out["losses"].append(step(state, images, labels)["loss"].item())
        out["launches"].append(n["flash"])
    del model, state
    torch.cuda.empty_cache()
    return out


def parallel_decode(mesh=None) -> dict:
    """Float32 mesh_generate of PARALLEL_DECODE's full canvases (one process,
    or the whole batch under ``mesh``) in each of PARALLEL_DECODE_MODES
    ("int8": greedy with int8 cross and self caches; sampling from a
    generator seeded with PARALLEL_SAMPLE_SEED): per mode (tokens, flash
    launches)."""
    from texocr_tpu_torch.models.generate import mesh_generate

    n_images, steps = PARALLEL_DECODE
    images = torch.from_numpy(parallel_batch(99, n_images)[0]).cuda()
    models = {"plain": flagship_model("float32", mesh),
              "int8": flagship_model("float32", mesh, kv_quant="int8", self_kv_quant="int8")}
    out = {}
    for mode in PARALLEL_DECODE_MODES:
        model = models["int8" if mode == "int8" else "plain"]
        gen = torch.Generator(device="cuda").manual_seed(PARALLEL_SAMPLE_SEED)
        with counted() as n:
            tokens = mesh_generate(model, images, mesh, max_len=steps,
                                   mode="greedy" if mode == "int8" else mode, generator=gen,
                                   temp=0.3, beam_size=BEAM)
        out[mode] = (tokens.cpu().numpy(), n["flash"])
    del models
    torch.cuda.empty_cache()
    return out


def parallel_rank() -> dict:
    """Phase 16b on one of two ranks sharing cuda:0 over gloo: {data: 2} and
    {model: 2} training steps, the kernel at this rank's shapes against its
    plain version, and the float32 decodes under {model: 2} and {data: 2}."""
    import torch.distributed as dist

    from texocr_tpu_torch.ops import flash_attention as fa
    from texocr_tpu_torch.parallel.mesh import create_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent runs float32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(16 + dist.get_rank())
    out = {"kernels": []}
    for axis in PARALLEL_BATCHES:
        out[axis] = parallel_steps(axis, True)
        dist.barrier()
    for b, h, n, dtype in RANK_SHAPES[:4]:
        q, k, v = (split_heads(gen, b, h, n, 64, dtype) for _ in range(3))
        _, _, err, ok, note = hold_kernel(fa, q, k, v, 64 ** -0.5)
        out["kernels"].append({"shape": [b, h, n, 64], "dtype": str(dtype)[6:], "ok": ok,
                               "max_abs_err": err, "note": note})
    out["decode"] = {axis: parallel_decode(create_mesh({axis: 2}, device="cuda"))
                     for axis in ("model", "data")}
    return out


def parallel_phase(trained) -> dict:
    """Phase 16: parallelism on the card (see the module docstring). These
    are correctness phases: gloo stages CUDA tensors through the host and
    the two ranks of (b) time-share one card."""
    from texocr_tpu_torch.parallel.dryrun import dryrun_multichip, spawn

    world1 = world1_phase(trained)
    single = {axis: parallel_steps(axis, False) for axis in PARALLEL_BATCHES}
    single_decode = parallel_decode()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn(parallel_rank, 2, (), store_dir=tmp)
    failed = []
    for axis, batch in PARALLEL_BATCHES.items():
        want = single[axis]["losses"]
        for rank, r in enumerate(ranks):
            got = r[axis]
            err = float(np.max(np.abs(np.array(got["losses"]) - want) / np.abs(want)))
            ok = err <= PARALLEL_BF16_RTOL and got["launches"] == [N_LAYERS] * PARALLEL_STEPS
            log(f"[parallel] (b) rank {rank} of 2 on cuda:0 over gloo, {{{axis}: 2}} at global "
                f"batch {batch}: losses {got['losses']} against one process's {want}, max "
                f"relative difference {err:.3e} (tol {PARALLEL_BF16_RTOL:g}); flash launches "
                f"per step {got['launches']} {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{axis} rank {rank}")
    for rank, r in enumerate(ranks):
        for row in r["kernels"]:
            log(f"[parallel] (b) rank {rank}: flash_attention {row['dtype']} {row['shape']} "
                f"split-head, kernel vs plain: {row['note']} {'ok' if row['ok'] else 'FAIL'}")
            if not row["ok"]:
                failed.append(f"kernel {row['shape']} rank {rank}")
        for axis, decodes in r["decode"].items():
            for mode, (tokens, launches) in decodes.items():
                same = np.array_equal(tokens, single_decode[mode][0])
                log(f"[parallel] (b) rank {rank}: float32 {mode} decode of {PARALLEL_DECODE[0]} "
                    f"full canvases x {PARALLEL_DECODE[1]} steps under {{{axis}: 2}}: tokens "
                    f"{'equal to' if same else 'DIFFER from'} one process's; flash launches "
                    f"{launches} for 1 encode")
                if not (same and launches == N_LAYERS):
                    failed.append(f"{mode} decode {axis} rank {rank}")
    if failed:
        raise AssertionError(f"phase 16b failed: {failed}")

    with tempfile.TemporaryDirectory() as tmp:
        dry = dryrun_multichip(2, device="cuda", store_dir=tmp)
    log(f"[parallel] (c) dryrun_multichip(2) on cuda:0: loss {dry['loss']:.4f}")
    return {"launches": {"a": world1["launches"],
                         **{f"b {axis} rank {i}": sum(r[axis]["launches"])
                            for i, r in enumerate(ranks) for axis in PARALLEL_BATCHES},
                         **{f"b decode {axis} {mode} rank {i}": d[1]
                            for i, r in enumerate(ranks) for axis, decodes in r["decode"].items()
                            for mode, d in decodes.items()}}}


DEMO_N = 640  # phase 17's --realistic demo build: 512 train, 96 test, 32 val rows
DEMO_SEED = 13
DEMO_BATCH = 32  # the curriculum's batch, for training and evaluation
DEMO_STAGE = "D"  # the curriculum stage whose training arguments phase 17 cuts down
DEMO_CUTS = ["--epochs", "2", "--eval_batches", "2", "--save_freq", "1", "--val_freq", "1"]
DEMO_STAGE_W = ["--remat", "--pack_bits", "4", "--host_val"]  # stage W's knobs
DEMO_TORN = 40  # train images deleted from the build's tail before the partial pickles
DEMO_HOLDOUT = 64  # pickle_partial_typeset's --holdout on the torn build
METRICS_KEYS = {"args", "final_train_loss", "token_acc", "exact_match", "edit_similarity",
                "batches"}  # the keys of the JAX tool's --metrics_out


def demo_canvas(split, i):
    """Phase 17's canvas of row ``i``: (160, 1008), but every 8th train row
    (96, 1008), so the train split has two buckets of full batches."""
    return (96, 1008) if split == "train" and i % 8 == 7 else (160, 1008)


def build_demo(rng, root) -> dict:
    """Phase 17 (a): the demo tool's renders raise ImportError naming the
    package that is missing (PIL; matplotlib with --typeset) and its main
    then writes nothing, or, where the packages are there, render onto a
    profile canvas; the tool's equations, split writer (with ink the phase
    draws) and pickles, on a DEMO_N --realistic build; then
    pickle_partial_typeset on the build with its train tail torn."""
    from texocr_tpu_torch.tools import make_demo_dataset as mdd
    from texocr_tpu_torch.tools import pickle_partial_typeset

    build = os.path.join(root, "demo")
    found = {name: importlib.util.find_spec(name) is not None for name in ("PIL", "matplotlib")}
    eq, notes = "x ^ { 2 } + \\frac { a } { b }", []
    entries = (
        ("render_realistic", lambda: mdd.render_realistic(eq), ("PIL",)),
        ("render_realistic_typeset",
         lambda: mdd.render_realistic_typeset(eq, np.random.default_rng(0)), ("matplotlib",)),
        ("main", lambda: mdd.main(["--out", build, "--n", "8", "--realistic"]), ("PIL",)),
        ("main --typeset", lambda: mdd.main(["--out", build, "--n", "8", "--typeset"]),
         ("PIL", "matplotlib")),
    )
    for name, call, needs in entries:
        missing = [package for package in needs if not found[package]]
        if not missing:
            if not name.startswith("main"):
                img = call()
                if not (img.dtype == np.uint8 and img.shape in mdd.REALISTIC_PROFILES):
                    raise AssertionError(f"{name} gave {img.dtype} {img.shape}")
                notes.append(f"{name} renders onto {img.shape}")
            continue
        try:
            call()
        except ImportError as e:
            if missing[0] not in str(e):
                raise AssertionError(f"{name}'s ImportError does not name {missing[0]}: {e}") from e
        else:
            raise AssertionError(f"make_demo_dataset's {name} ran without {missing}")
        if os.path.exists(build):
            raise AssertionError(f"make_demo_dataset's {name} wrote files before its ImportError")
        notes.append(f"{name} raises ImportError naming {missing[0]} and writes no file")
    log(f"[tools] make_demo_dataset: importable {found}; " + "; ".join(notes)
        + "; the phase draws each image's ink")

    eqs = mdd.demo_equations(np.random.default_rng(DEMO_SEED), DEMO_N, realistic=True)
    splits = mdd.split_equations(eqs)
    for split, labels in splits.items():
        shapes = iter([demo_canvas(split, i) for i in range(len(labels))])
        mdd.write_split(os.path.join(build, split), labels,
                        lambda eq, r: canvas(r, *next(shapes)), rng)
    sets = mdd.pickle_splits(build, splits, DEMO_N)
    rows = {split: len(ds) for split, ds in sets.items()}
    if rows != {split: len(labels) for split, labels in splits.items()}:
        raise AssertionError(f"pickled rows {rows}")
    buckets = {split: {f"{h}x{w}": len(i) for (w, h), i in ds.sizes.items()}
               for split, ds in sets.items()}
    log(f"[tools] demo build: {DEMO_N} --realistic equations (seed {DEMO_SEED}), rows {rows}, "
        f"buckets {buckets}, max_seq_len {sets['train'].max_seq_len}")

    images = os.path.join(build, "train", "images")
    left = rows["train"] - DEMO_TORN
    for i in range(left, rows["train"]):
        os.remove(os.path.join(images, f"eq_{i:05d}.png"))
    partial = os.path.join(root, "partial")
    pickle_partial_typeset.main(["--src", build, "--out", partial, "--n", str(DEMO_N),
                                 "--seed", str(DEMO_SEED), "--holdout", str(DEMO_HOLDOUT)])
    from texocr_tpu_torch.data.dataset import ImageDataset

    parts = [ImageDataset.load(os.path.join(partial, s, f"{s}set.pkl"))
             for s in ("train", "val", "test")]
    took = sum(len(p) for p in parts)
    labels = [label for p in parts for label in p.labels]
    ok = took == left and labels == splits["train"][:left]
    log(f"[tools] pickle_partial_typeset after deleting the last {DEMO_TORN} train images: "
        f"take {took} (rows left {left}), splits {[len(p) for p in parts]}, labels "
        f"{'equal to' if labels == splits['train'][:left] else 'DIFFER from'} the build's row "
        f"for row {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("pickle_partial_typeset disagrees with the build")
    return {"build": build, "rows": rows}


def remat_steps(config, train_set) -> dict:
    """Phase 17 (b): one fixed full-canvas batch of DEMO_BATCH through the
    flagship from the same weights, without and with remat: the first two
    steps' losses and each step's flash and backward launches."""
    from texocr_tpu_torch.config import ModelConfig, with_defaults
    from texocr_tpu_torch.data.dataset import create_dataloader
    from texocr_tpu_torch.models import OCRModel
    from texocr_tpu_torch.training.optimizers import get_optimizer
    from texocr_tpu_torch.training.train_step import (
        create_train_state,
        make_train_step,
        put_batch,
    )
    from texocr_tpu_torch.utils import pad_to_multiple

    config = with_defaults(dict(config, max_length=pad_to_multiple(
        train_set.max_seq_len, config["seq_pad_multiple"]), vocab_size=1000))
    batch = next(b for b in create_dataloader(train_set, config) if b[0].shape[1:3] == (160, 1008))
    images, labels = put_batch(*batch, "cuda")
    train_step = make_train_step(mask_pad=True)
    out = {}
    for remat in (False, True):
        model = OCRModel(ModelConfig.from_dict(dict(config, remat=remat)), device="cuda",
                         seed=config["seed"])
        state = create_train_state(
            model, get_optimizer("Adam", config["optimizer_args"], model.parameters()),
            config["seed"])
        row = out["remat" if remat else "plain"] = {
            "losses": [], "launches_per_step": [], "backward_launches_per_step": []}
        for _ in range(2):
            with counted() as n:
                row["losses"].append(train_step(state, images, labels)["loss"].item())
            row["launches_per_step"].append(n["flash"])
            row["backward_launches_per_step"].append(n["backward"])
        del model, state
        torch.cuda.empty_cache()
    return out


def demo_train_run(argv, root, name) -> dict:
    """Runs demo_train's main on ``argv`` with its train_model and test_model
    wrapped to count, per run, the flash launches and steps of training
    (with the epochs' records) and the flash launches and graph keys of the
    test split's decode."""
    from texocr_tpu_torch.evaluation import evaluate
    from texocr_tpu_torch.tools import demo_train
    from texocr_tpu_torch.training import loop

    rec = {}
    metrics = os.path.join(root, f"{name}.jsonl")
    originals = loop.train_model, evaluate.test_model

    def train_model(*args, **kwargs):
        with counted() as n:
            model, state, history = originals[0](*args, metrics_path=metrics, **kwargs)
        rec.update(train_launches=n["flash"], steps=state.step)
        return model, state, history

    def test_model(*args, **kwargs):
        with counted() as n:
            got = originals[1](*args, **kwargs)
        rec.update(test_launches=n["flash"], keys=n["keys"])
        return got

    loop.train_model, evaluate.test_model = train_model, test_model
    try:
        demo_train.main(argv)
    finally:
        loop.train_model, evaluate.test_model = originals
    with open(metrics) as f:
        records = [json.loads(line) for line in f]
    rec["epochs"] = [r for r in records if r["event"] == "train_epoch"]
    rec["val_events"] = sum(r["event"] == "val" for r in records)
    with open(argv[argv.index("--metrics_out") + 1]) as f:
        rec["metrics"] = json.load(f)
    return rec


def tools_phase(rng) -> dict:
    """Phase 17: the data tools and demo_train on the card (see the module
    docstring)."""
    from texocr_tpu_torch.data.dataset import ImageDataset
    from texocr_tpu_torch.tools import demo_train, train_curriculum

    out = {}
    with tempfile.TemporaryDirectory() as root:
        out["build"] = build = build_demo(rng, root)

        base = ["--data", build["build"], "--device_data", "--augment", "--batch_size",
                str(DEMO_BATCH), "--device", "cuda"] + train_curriculum.STAGES[DEMO_STAGE][
                    "train"] + DEMO_CUTS
        plain_ck, remat_ck = os.path.join(root, "plain_ckpts"), os.path.join(root, "remat_ckpts")
        argvs = {
            "plain": base + ["--save_dir", plain_ck, "--metrics_out",
                             os.path.join(root, "results", "plain.json")],
            "remat": base + DEMO_STAGE_W + ["--init_from", plain_ck, "--save_dir", remat_ck,
                                            "--metrics_out",
                                            os.path.join(root, "results", "remat.json")],
        }
        train_set = ImageDataset.load(os.path.join(build["build"], "train", "trainset.pkl"))
        out["steps"] = steps = remat_steps(
            demo_train.build_config(demo_train.parse_args(argvs["plain"])), train_set)
        rel = max(abs(a - b) / abs(b) for a, b in zip(steps["remat"]["losses"],
                                                      steps["plain"]["losses"]))
        per_step = {k: sorted(set(r["launches_per_step"])) for k, r in steps.items()}
        backward = {k: sorted(set(r["backward_launches_per_step"])) for k, r in steps.items()}
        ok = (rel <= BF16_FLOOR and per_step == {"plain": [N_LAYERS], "remat": [2 * N_LAYERS]}
              and backward == {"plain": [N_LAYERS], "remat": [N_LAYERS]})
        log(f"[tools] fixed batch of {DEMO_BATCH} full canvases, the flagship from one seed: "
            f"losses of two steps without remat {steps['plain']['losses']}, with remat "
            f"{steps['remat']['losses']}, max relative difference {rel:.3e} (tol "
            f"{BF16_FLOOR:g}); flash launches per step {per_step} (expected {N_LAYERS} and "
            f"{2 * N_LAYERS}: remat recomputes each encoder sub-layer's forward), backward "
            f"launches {backward} (expected {N_LAYERS} in both) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("remat changes the loss or the launches per step")

        for name, argv in argvs.items():
            run = demo_train_run(argv, root, name)
            expected = 2 * N_LAYERS if name == "remat" else N_LAYERS
            train_per_step = (run["train_launches"] - N_LAYERS * run["val_events"]) / run["steps"]
            decodes = run["metrics"]["batches"] + run["keys"]
            losses = [r["loss"] for r in run["epochs"]]
            ok = (train_per_step == expected and run["test_launches"] == N_LAYERS * decodes
                  and set(run["metrics"]) == METRICS_KEYS and run["metrics"]["batches"] == 2
                  and np.isfinite(losses).all() and len(losses) == 2)
            log(f"[tools] demo_train {name} ({' '.join(argv[argv.index('--device') + 2:])}): "
                f"{run['steps']} train steps, epoch losses {losses}; flash launches "
                f"{run['train_launches']} in training ({train_per_step:g} a train step with "
                f"{run['val_events']} val steps, expected {expected}), {run['test_launches']} "
                f"in test_model for {decodes} encodes ({run['keys']} keys captured); metrics "
                f"keys {sorted(run['metrics'])} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"demo_train {name} failed its checks")
            out[name] = {"train_launches": run["train_launches"],
                         "train_launches_per_step": train_per_step, "steps": run["steps"],
                         "val_events": run["val_events"], "test_launches": run["test_launches"],
                         "encodes": decodes}

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_curriculum.main(["--dry_run", "--stages", "A-C", "--base_dir",
                                   os.path.join(root, "curriculum"), "--results_dir",
                                   os.path.join(root, "results")])
        lines = [line for line in buf.getvalue().splitlines() if line.startswith("+")]
        trains = [line for line in lines if "-m texocr_tpu_torch.tools.demo_train " in line]
        builds = [line for line in lines if "-m texocr_tpu_torch.tools.make_demo_dataset " in line]
        ckpt = os.path.join(root, "curriculum", "stage{}_ckpts")
        ok = (len(trains) == 3 and len(builds) == 3 and "--init_from" not in trains[0]
              and f"--init_from {ckpt.format('A')}" in trains[1]
              and f"--init_from {ckpt.format('B')}" in trains[2]
              and all(os.path.join(root, "results", f"stage_{s}.json") in line
                      for s, line in zip("ABC", trains)))
        log(f"[tools] train_curriculum --dry_run --stages A-C: {len(builds)} builds and "
            f"{len(trains)} trainings through the port's modules, warm starts chained "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("train_curriculum's commands do not chain the port's tools")
    return out


def leaves(tree, path="tree"):
    """(path, leaf) of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}.{i}")
    else:
        yield path, tree


def leaf_bits(leaf):
    """A leaf's dtype, shape and bytes (bfloat16 tensors as their bits)."""
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16).numpy().view(np.uint16)
        else:
            leaf = leaf.numpy()
    if isinstance(leaf, np.ndarray):
        return leaf.dtype.str, leaf.shape, leaf.tobytes()
    return type(leaf).__name__, (), repr(leaf)


def tree_mismatches(got, want) -> list:
    """Paths where ``got`` and ``want`` differ in structure or in any bit."""
    a, b = dict(leaves(got)), dict(leaves(want))
    if sorted(a) != sorted(b):
        return sorted(set(a) ^ set(b))
    return [k for k in a if leaf_bits(a[k]) != leaf_bits(b[k])]


def orbax_phase(trained, device="cuda") -> dict:
    """Phase 18: the JAX package's orbax checkpoints on the card's
    installation (see the module docstring). ``trained``: phase 8's result,
    whose checkpoints it converts."""
    from texocr_tpu_torch.checkpoint import convert, io, orbax, zstd
    from texocr_tpu_torch.config import ModelConfig
    from texocr_tpu_torch.data.dataset import load_datasets
    from texocr_tpu_torch.models import OCRModel
    from texocr_tpu_torch.parallel.mesh import create_mesh
    from texocr_tpu_torch.parallel.sharding import shard_optimizer_state
    from texocr_tpu_torch.serving import TexOCR
    from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH
    from texocr_tpu_torch.training.loop import train_model

    # (a) Format coverage: the committed fixture, JAX-written, against its seed.
    fixture = orbax.load_checkpoint(os.path.join(ORBAX_FIXTURE, "checkpoint_e3"))
    want = orbax_fixture_tree()
    half = want["params"]["half"]
    want["params"]["half"] = torch.from_numpy(half.view(np.int16)).view(torch.bfloat16)
    bad = tree_mismatches(fixture, want)
    n_leaves = len(list(leaves(want)))
    log(f"[orbax] (a) {ORBAX_FIXTURE}: {n_leaves} leaves (f32, bf16, int32, int64, scalars, a "
        f"2x2-sharded leaf in 4 chunks, one out of line, Adam with clip and schedule) "
        f"{'bit-equal to the seed' if not bad else 'DIFFER at ' + str(bad)}; zstd through "
        f"ctypes from {zstd.library_path()}")
    if bad:
        raise AssertionError(f"the orbax fixture differs from its seed at {bad}")

    # (b) Phase 8's flagship checkpoint in the JAX layout, written and read back.
    config = trained["config"]
    src = io.latest_checkpoint(config["save_dir"])
    state = io.load_checkpoint(src)
    model_config = {**config, "max_length": int(state["model"][convert.POS_EMBED_KEY].shape[0]),
                    "vocab_size": int(state["model"]["decoder.net.to_logits.bias"].shape[0])}
    keys = OCRModel(ModelConfig.from_dict(model_config), device="meta").parameter_keys()
    work = os.path.dirname(config["save_dir"])
    jax_dir = os.path.join(work, "jax_layout")
    params = convert.jax_from_state_dict(state["model"])
    opt_state = convert.jax_opt_state(state["optimizer"], keys, config["optimizer"],
                                      config["optimizer_args"])
    jax_ckpt = orbax.save_checkpoint(jax_dir, state["epoch"], params, opt_state,
                                     extra={"step": state["step"]})
    del params, opt_state
    back = io.load_checkpoint(jax_ckpt)
    mesh = create_mesh()
    numbered = shard_optimizer_state(back["optimizer"], keys, mesh)["optimizer"]["state"]
    saved = state["optimizer"]["optimizer"]["state"]
    bad = (tree_mismatches(back["model"], state["model"])
           + tree_mismatches({str(k): v for k, v in numbered.items()},
                             {str(k): v for k, v in saved.items()})
           + [k for k in ("epoch", "step") if back[k] != state[k]])
    log(f"[orbax] (b) {src} (state.pt) in the JAX layout, written by orbax.save_checkpoint "
        f"and read back through io.load_checkpoint: "
        + ("bit-equal to state.pt (model, moments, steps, epoch, step)" if not bad
           else f"DIFFER at {bad[:5]}"))
    if bad:
        raise AssertionError(f"the JAX layout read back differs from state.pt at {bad[:5]}")
    del back, numbered, state

    # Resume train_model for one epoch of phase 8's data from each directory.
    train_set, val_set, _ = load_datasets(trained["data_dir"])  # augmentation off: same batches
    port_dir = os.path.join(work, "state_pt")
    shutil.copytree(src, os.path.join(port_dir, os.path.basename(src)))
    resumed = {}
    for name, save_dir in (("jax layout", jax_dir), ("state.pt", port_dir)):
        metrics = os.path.join(work, f"metrics_{name.replace(' ', '_')}.jsonl")
        run = dict(config, save_dir=save_dir, resume=True, save_checkpoint=False,
                   n_epochs=TRAIN_EPOCHS + 1)
        with counted() as n:
            _, st, history = train_model(train_set, val_set, run, verbose=False, device=device,
                                         metrics_path=metrics)
        launches = n["flash"]
        with open(metrics) as f:
            records = [json.loads(line) for line in f]
        epoch = next(r for r in records if r["event"] == "train_epoch")
        epoch["steps"] = int(epoch["steps"])
        val = [r["loss"] for r in records if r["event"] == "val"]
        n_val = len(val)
        resumed[name] = {"losses": history, "val": val, "launches": launches,
                         "steps": epoch["steps"], "step": st.step}
        log(f"[orbax] resume from the {name}: epoch {TRAIN_EPOCHS + 1} of {epoch['steps']} "
            f"steps from step {st.step - epoch['steps']}, loss {history}, val {val}; flash "
            f"launches {launches}")
        if launches != N_LAYERS * (epoch["steps"] + n_val):
            raise AssertionError(f"resume from the {name}: {launches} flash launches for "
                                 f"{epoch['steps']} train and {n_val} val steps")
        del st
        torch.cuda.empty_cache()
    a, b = resumed["jax layout"], resumed["state.pt"]
    same = a["losses"] + a["val"] == b["losses"] + b["val"]
    pairs = zip(a["losses"] + a["val"], b["losses"] + b["val"])
    rel = max(abs(x - y) / abs(y) for x, y in pairs)
    ok = a["step"] == b["step"] and (same or rel <= ORBAX_RESUME_RTOL)
    differ = f"differ by {rel:.3g} relative (rtol {ORBAX_RESUME_RTOL:g})"
    log(f"[orbax] resume: the JAX layout's losses against state.pt's "
        f"{'bit-equal' if same else differ} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the resume from the JAX layout differs from the resume from "
                             "state.pt")

    # Serve batch 8 through the CUDA graphs from each directory.
    rng = np.random.default_rng(18)
    h, w = TRAIN_BUCKETS[0][0]
    batch = np.stack([canvas(rng, h, w) for _ in range(BATCH)])[..., None]
    served = {}
    for name, path in (("jax layout", jax_ckpt), ("state.pt", src)):
        engine = TexOCR({**{k: v for k, v in model_config.items()
                            if k not in ("max_length", "vocab_size")},
                         "tokenizer_path": DEFAULT_VOCAB_PATH, "model_path": path},
                        device=device)
        engine.generate_batch(batch, max_len=DECODE_STEPS)  # the key's capture
        with counted() as n:
            tokens = engine.generate_batch(batch, max_len=DECODE_STEPS)
        served[name] = {"tokens": tokens.cpu().numpy(), "launches": n["flash"]}
        del engine
        torch.cuda.empty_cache()
        log(f"[orbax] serve from the {name}: batch {BATCH} x {tokens.shape[1]} tokens (max_len "
            f"{DECODE_STEPS} within the checkpoint's positional table) through the graphs, "
            f"flash launches {served[name]['launches']}")
        if served[name]["launches"] != N_LAYERS:
            raise AssertionError(f"serve from the {name}: {served[name]['launches']} flash "
                                 "launches for one encode")
    equal = np.array_equal(served["jax layout"]["tokens"], served["state.pt"]["tokens"])
    log(f"[orbax] serve: tokens from the JAX layout {'bit-equal to' if equal else 'DIFFER from'}"
        f" state.pt's ({served['state.pt']['tokens'].shape})")
    if not equal:
        raise AssertionError("TexOCR from the JAX layout gives other tokens than from state.pt")
    return {"resume": {k: {"launches": v["launches"], "steps": v["steps"]}
                       for k, v in resumed.items()},
            "serve": {k: {"launches": v["launches"]} for k, v in served.items()}}


def build_phase(fa) -> None:
    """Phase 2: builds the flash source and prints ptxas's registers, spills
    and warnings per kernel, each kernel's tensor-core instructions, and
    the occupancy calculator's blocks per SM; fatal unless every
    instantiation of HGMMA holds its count."""
    from texocr_tpu_torch.ops import build

    library, build_log = build.build(fa.SOURCE)
    for line in build_log.splitlines():
        if any(word in line for word in ("entry function", "registers", "spill", "warning",
                                         "wgmma")):
            log(f"[build]   {line.strip()}")
    sass = sass_ops(library)
    for name, ops in sass.items():
        log(f"[build] sass {name}: {ops}")
    for name, count in HGMMA.items():
        got = sass.get(name, {}).get("HGMMA", 0)
        if got != count:
            raise AssertionError(f"{name} must run on the tensor cores: {count} HGMMA "
                                 f"expected, {got} found")
    lib = fa.bind(library)
    log("[build] blocks per SM (occupancy calculator): " + ", ".join(
        f"{dtype} dh {dh}: {lib.texocr_flash_attention_blocks_per_sm(code, dh)}"
        for dtype, code in (("float32", 0), ("bfloat16", 1)) for dh in (64, 128)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from texocr_tpu_torch.ops import flash_attention as fa

    log(f"[device] {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase_s = {}
    launch_log = LaunchLog(fa)

    def phase(name, fn, *args):
        t = time.perf_counter()
        launch_log.phase = name
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    phase("build", build_phase, fa)
    gen = torch.Generator(device="cuda").manual_seed(0)
    errors = phase("kernels", check_flash_kernel, fa, gen)
    timings = phase("kernel timing", time_flash, fa, gen)
    backward = phase("flash backward", flash_backward_phase, fa, gen)
    decoded = phase("decode attention", decode_attention_phase)
    routed = phase("moe experts", moe_experts_phase)
    f32_launches = phase("golden", check_golden)
    rng = np.random.default_rng(0)
    served = phase("serve", serve, rng)
    batch = served.pop("batch")
    paths = {f"graphs {mode}": r
             for mode, r in phase("graphs", graphs_phase, served.pop("engine"), batch).items()}
    encode_err = phase("encoder", check_encoder_paths, rng)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    trained = phase("train", train, rng, os.path.join(work, "phase8"))
    resident = phase("device data", device_data_phase, rng)
    paths.update({"int8": phase("int8", int8_phase, batch),
                  "sample": phase("sample", sample_phase, batch),
                  "beam": phase("beam", beam_phase, batch),
                  "http": phase("http", http_phase, rng)})
    paths.update({f"eval {mode}": r for mode, r in phase("eval", eval_phase, rng).items()})
    paths.update({f"variants {name}": r for name, r in
                  phase("variants", variants_phase, batch, rng, encode_err).items()})
    paths.update({f"data {kind}": r for kind, r in phase("data", data_phase, rng).items()})
    parallel = phase("parallel", parallel_phase, trained)
    tools = phase("tools", tools_phase, rng)
    interchange = phase("orbax", orbax_phase, trained)
    shutil.rmtree(work)
    launched = phase("launched shapes", check_launched, fa, gen, launch_log)
    log("[time] seconds per phase " + json.dumps(phase_s))

    kernels = []
    for dtype, name, instruction, launches, path in (
        (torch.bfloat16, "flash_attention_bf16", "wgmma (HGMMA)", served["launches"],
         "serve (bfloat16 flagship)"),
        (torch.float32, "flash_attention_f32", "wgmma tf32 x3 (HGMMA)", f32_launches,
         "golden (float32)"),
    ):
        serving_shape = timings[dtype][0]
        kernels.append(dict(
            name=name,
            route="cuda",
            source="texocr_tpu_torch/csrc/flash_attention.cu",
            replaces="texocr_tpu/ops/flash_attention.py:62",
            instruction=instruction,
            launches=launches,
            launches_path=path,
            launch_signatures=launched.get(str(dtype)[6:], {}),
            max_abs_err=errors[dtype],
            **{key: serving_shape[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_kernels",
                "ms_l2_cold", "plain_ms_l2_cold", "library_ms_l2_cold")},
            shapes=timings[dtype],
        ))
    kernels[0].update(
        train_launches=trained["launches"], train_launches_per_step=trained["launches_per_step"],
        device_data_launches=resident["launches"],
        device_data_launches_per_step=resident["launches_per_step"],
        launches_per_path={"serve": {"launches": served["launches"],
                                     "encodes": served["encodes"]}, **paths},
        parallel_launches={k: v for k, v in parallel["launches"].items() if "decode" not in k},
        tools_launches={name: tools[name] for name in ("plain", "remat")},
        tools_fixed_batch_launches_per_step={name: r["launches_per_step"]
                                             for name, r in tools["steps"].items()},
        orbax_launches={
            **{f"resume from the {k}": {"launches": v["launches"], "train_steps": v["steps"]}
               for k, v in interchange["resume"].items()},
            **{f"serve from the {k}": {"launches": v["launches"], "encodes": 1}
               for k, v in interchange["serve"].items()}})
    kernels[1].update(parallel_launches={k: v for k, v in parallel["launches"].items()
                                         if "decode" in k})
    kernels.append(dict(
        name="flash_attention_backward_bf16",
        route="cuda",
        source="texocr_tpu_torch/csrc/flash_attention.cu",
        replaces=None,  # the JAX package takes XLA's VJP of the math path
        instruction="wgmma (HGMMA)",
        launches={"train a train step": trained["backward_launches_per_train_step"],
                  "device data a train step":
                      resident["backward_launches_per_train_step"],
                  "tools a step without and with remat":
                      {k: tools["steps"][k]["backward_launches_per_step"]
                       for k in ("plain", "remat")}},
        worst_gap=backward["worst"],
        shapes=backward["timings"],
    ))
    kernels.append(dict(
        name="decode_attention",
        route="cuda",
        source="texocr_tpu_torch/csrc/decode_attention.cu",
        replaces=None,  # JAX's decode attention is XLA einsum
        launches={"serve (bfloat16 caches)": served["decode_launches"],
                  "int8 (int8 caches)": paths["int8"]["decode_launches"]},
        calls=decoded,
    ))
    kernels.append(dict(
        name="moe_expert_gate_up, moe_expert_down",
        route="triton",
        source="texocr_tpu_torch/ops/moe_experts.py",
        replaces=None,  # the JAX package has no expert layer
        launches={"kimivl.batch path (TexOCR.generate_batch, 256 x 256 steps), a call":
                  routed["main path"]["launches"],
                  "3-layer graphed call": routed["graphs"]["launches_per_call"]},
        calls={k: v for k, v in routed.items() if k not in ("graphs", "main path")},
    ))
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
