#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (texocr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: a CUDA device must be present; prints its name and power limit.
  2. build: compiles every CUDA kernel of the serving path from csrc/, and
     counts tensor-core instructions in the built library (cuobjdump -sass):
     all six instantiations of the flash kernel must hold as many HGMMA
     (wgmma) instructions as their loops issue: bfloat16 (head dim 64 or 128;
     rows on 16 bytes or not) and float32 (3xTF32; head dim 64 or 128).
  3. kernels: each kernel against its plain PyTorch version on the card, at
     test shapes (masks, ragged tiles, head dims, row alignments) and at the
     serving path's shapes; then timings of the kernel, the plain version and one PyTorch
     library call as a yardstick, at the four shapes of the serving path,
     with L2-warm and L2-cold inputs; and at phase 16's per-rank training
     shapes (RANK_SHAPES: (64, 8, 631, 64) and (32, 4, 631, 64) in bf16),
     checked and timed beside the bound and the library call.
  4. golden: the committed reference goldens through the port on the card in
     float32 (kernel path): exact greedy tokens, encoder output within 1e-4;
     the float32 kernel's launch count is read from this phase.
  5. serve: the flagship configuration at full width in bfloat16 with seeded
     random weights, answering single requests of three bucket sizes and
     batches of 8 full canvases through TexOCR, whose CUDA engine decodes
     through CUDA graphs: each key's first call (its capture) comes first, and
     each is timed REPEATS times (median); launch counts are read from this
     phase only.
  6. profile: where the eager path's serving time goes, for a batch of 8 full
     canvases: encode and a DECODE_STEPS-step greedy decode, wall time (host
     clock) and device kernels (torch.profiler, CUDA activity).
 6b. graphs: models.graphed.make_graphed_generate on the serving batch (8 full
     canvases, bf16, DECODE_STEPS tokens) in greedy, int8 (both caches), beam
     5 and sampling at 0.3, each beside the eager path. Fatal: tokens
     bit-equal to the eager path's (the generator reseeded alike), beam's best
     scores too, two successive sampled calls that differ, 4 flash launches
     per encode counted on replays, and the float32 golden model's greedy
     tokens exact through the graphs (the package's float-input engine,
     make_graphed_generate(..., float_input=True)). Prints per mode, eager and graph in this
     call: decode wall (median of REPEATS), device time, kernels a step, busy
     share; the capture's seconds and the memory the key holds; encode wall
     and device time for both (phase 6's eager numbers for greedy and
     encode).
  7. encoder: kernel path against the plain path at the full canvas, float32.
  8. train: texocr_tpu_torch.training.loop.train_model on the card, the
     flagship at full width in bfloat16 with config/config.yml's training keys
     (batch 128, Adam at lr 5e-4, seq_pad_multiple 32, masked loss, shuffles,
     seed 42), on a synthetic pickled dataset (two full batches of (160, 1008)
     canvases and one of (64, 512), a val split of one full batch), 2 epochs
     with a checkpoint each, augmentation on as the training CLI has it. Fatal
     checks: finite epoch losses (a non-finite step would make its epoch's
     mean non-finite), the second epoch's below the first's, exactly 4 flash
     launches per train step and per eval step, encoder gradients on the kernel
     path against the plain path (float32 and bfloat16, 8 full canvases), the
     bf16 kernel against its plain version at the training shape (phase 3
     holds it at both training buckets too), and the losses of two steps
     after loading the checkpoint against two steps without the save. Prints
     step time (median, least and most per bucket), images/s, the host
     loader's time per batch alone, peak memory, a profiled step (device time
     over that call's own wall time) and the kernel at the training shape
     beside its bound, the library call and the math-path backward.
 8b. device data: train_model with device_data and device_data_augment on
     (the dataset resident on the card as uint8, batches picked and augmented
     there, 16 steps a call), the flagship as in phase 8 on 8 full-canvas
     batches and 2 of (64, 512) (10 steps an epoch), 2 epochs, val resident.
     Fatal: finite epoch losses, the second below the first, 4 flash launches
     per train and eval step, a resume from its checkpoint with the same step
     count and weights. Prints both epochs' wall time beside the host
     loader's on the same data in the same run (augmentation on the host),
     the synchronised full-canvas step, images/s, a profiled call's device-busy
     share and peak memory. Then one (160, 1008) bucket of RESIDENT_ROWS rows
     (RESIDENT_DISTINCT distinct canvases with gray stroke edges, repeated)
     staged at pack_bits 8 and then 4, each beside one call of 16 steps:
     staging time, resident GB, peak memory and step time; fatal: finite
     losses, the 4-bit gather within 15.5/255 of the 8-bit one and exact at
     0 and 1.
  9. int8: a batch of 8 full canvases with kv_quant and self_kv_quant int8,
     DECODE_STEPS steps without EOS, through TexOCR.generate_batch. Fatal:
     the int8 caches' step logits within 5% of the largest |logit| of the
     unquantized cache's, over each row's steps up to its first differing
     token. Prints the share of tokens that agree (the decode's times are
     phase 6b's).
 10. sample: float32, 2 full canvases, SAMPLE_CHECK_STEPS steps at temperature
     1e-4 against greedy (a row may leave greedy only at a step whose top two
     logits lie within 20 x temp, where the Gumbel noise can decide); bf16, 8
     full canvases, temperature 0.3, DECODE_STEPS steps: every sampled token
     in the top 99 of its step's logits. Prints generate_batch's time.
 11. beam: bf16, 8 full canvases x beam 5, DECODE_STEPS steps (generate_batch's
     time and images/s); float32 at 2 full canvases and
     BEAM_CHECK_STEPS steps (two chunks, across an int8 merge), with and
     without int8 self-KV: beam 1 equals greedy, and beam 5's best score
     equals the log-prob of its tokens fed through the same cache (and,
     unquantized, the teacher-forced forward's; models.beam.sequence_logprob)
     within rtol 2e-4.
 12. http: ServingBatcher(max_batch=8) behind make_server(port=0), PNG bytes
     from a stdlib encoder that filters rows as PIL does: a solo POST returns
     engine(img)'s ids, then 32 POSTs (grey and RGB) of three canvas sizes at
     concurrency 8 (JSON contract, /healthz, a 400 for a body that is no
     image). Prints p50 and p99 latency, decode_image's time per request and
     the batches formed.
 13. eval: evaluation.evaluate.test_model on a pickled test split of two
     batches of 8 full canvases, greedy and beam 5, on the CUDA model: each
     batch decodes through the CUDA graphs of its key (float input), the
     first batch of a key capturing them. Fatal unless its metrics equal
     those computed from TexOCR.generate_batch on the same collated batches,
     its pairs_out tokens equal, bit for bit, an eager generate on the same
     collated float batches, and the flash kernel launched 4 times per
     encode (each replay, and each capture's eager warm-up encode). Prints
     per mode the keys, the first key's capture seconds, each batch's wall
     time on the graphs after capture beside the eager wall time of the same
     batch, and from how many batches of a key the graphs win.
 13b. variants: the model variants at the flagship's full width, bf16, seeded
     random weights, on the serving batch of 8 full canvases. patch
     (encoder.embed_layer: patch) and glu false (the decoder's dense + gelu
     MLP): a greedy TexOCR.generate_batch of DECODE_STEPS tokens through the
     CUDA graphs, fatal unless bit-equal to the eager generate, with 4 flash
     launches per encode and the float32 encode on the kernel path within
     F32_TOL of the plain path (glu false keeps the flagship's encoder, so
     phase 7's reading stands for it); prints encode and decode wall (graph
     replays). no cross (decoder.cross_attend: false): VARIANT_TRAIN_STEPS
     train steps at batch TRAIN_BATCH on full canvases, fatal unless the
     losses are finite and no flash kernel launches (the step does not encode:
     the decoder reads no encoder output), and unless TexOCR.generate_batch
     and make_graphed_generate raise ValueError; prints step time and peak
     memory. maps: a teacher-forced decoder(..., return_attn=True) at batch 8
     x MAPS_TOKENS, fatal unless its cross maps are (8, 8, MAPS_TOKENS, 631),
     every row sums to 1 within F32_TOL and no flash kernel launches (the maps
     take the math path); then the attention-maps tool's main on one
     full-canvas PNG, fatal unless it writes its overlays and summary.json and
     an overlay reads back through decode_png at (160, 1008).
 15. data (run before 14, which then holds its launches too): the data path
     on the card's machine, which has no PIL, PyYAML or regex. (a) The BPE
     encoder built from csrc/bpe_encoder.cpp by g++ and loaded; the 15
     golden texts of tests/goldens/tokenizer_encode.json exact through encode
     and encode_batch, which must make one native call; a retrain on the
     golden corpus (tokenizer_train.json: 300 tokens, x20) equal to its 41
     merges; encode_batch's labels/s on ENCODE_LABELS seeded labels, native
     against pure Python, ids equal. (b) split_data on a seeded master file
     (DATA_SPLITS rows) with a .json data config; render_data with the latex
     chain where its binaries are, else mathtext where matplotlib imports,
     else the phase writes each PNG at the canvas rule with encode_png (the
     line says which); prune_equations; every PNG centred on a DATA_CANVAS
     canvas; pickle_data per split, eager and lazy. (c) training.cli on each
     set of pickles: the flagship at full width, config/config.yml's training
     keys (batch 128), 1 epoch of 2 train steps and 1 val step. Fatal: a
     build or golden mismatch, fewer rendered rows than DATA_SPLITS, a
     non-finite loss, other than 4 flash launches per encode, and a lazy
     batch (augmentation off) unequal to the eager one. Prints the host
     times with the host CPU's model and the card's name and power limit:
     build s, retrain s, labels/s, render s, each pickle's build s and MB,
     each epoch's wall time.
 16. parallel (run before 14): the data x model process mesh on the card,
     the bf16 flagship at full width unless said, fatal on every check.
     (a) A process group of one rank over NCCL: train_model with phase 8's
     keys, data and seed under mesh {data: -1, model: 1} (the mesh, the
     global loss's count and the gradients' all-reduce run on the card):
     epoch losses within WORLD1_RTOL of phase 8's, 4 flash launches per
     step; prints the synchronised full-canvas step beside phase 8's and the
     gradient all-reduce's bytes and time, read from a trace written by
     telemetry.profile_trace. (b) Two ranks sharing cuda:0 over gloo (NCCL
     refuses two ranks on one GPU), spawned by parallel.dryrun.spawn:
     PARALLEL_STEPS Adam steps under {data: 2} at global batch 128 and under
     {model: 2} at 32, losses within PARALLEL_BF16_RTOL of one process's on
     the same global batches, 4 flash launches per step; each rank holds the
     kernel at its shapes against its plain version; float32 mesh_generate
     of 2 full canvases x 32 steps under {model: 2} and under {data: 2}, in
     greedy, sampling at 0.3 from one seed, beam 5, and greedy with int8
     cross and self caches: tokens equal to one process's, 4 flash launches
     per encode; prints per rank the step times, peak memory, a profiled
     step's share in collectives and each decode's seconds. (c)
     dryrun_multichip(2) on cuda:0. These are correctness phases: gloo
     stages CUDA tensors through the host and the ranks time-share one
     card, so no time here is a parallel speed.
 17. tools (run before 14): the data tools and the training tool they
     chain (texocr_tpu_torch/tools/). (a) make_demo_dataset's entry points
     raise an ImportError naming the package they miss (PIL for the bitmap
     renders and main, matplotlib for the typeset render and main
     --typeset) and write no file, and where the package is there render
     onto a profile canvas (the card's machine has PIL, not matplotlib); its
     equations (DEMO_N --realistic, seed DEMO_SEED), split writer (ink drawn
     by the phase: (160, 1008) canvases, every 8th train row (96, 1008)) and
     pickles build the dataset; pickle_partial_typeset on the build with
     its last DEMO_TORN train images deleted must take exactly the rows
     left, with the build's labels row for row. (b) One fixed batch of
     DEMO_BATCH full canvases through the flagship from one seed without
     and with remat: the first two steps' losses within BF16_FLOOR
     (relative), 4 and 8 flash launches a step (the backward recomputes
     each encoder sub-layer's forward); prints the synchronised step time,
     peak memory and a profiled step (device time, busy share) of each. (c) demo_train on the build at the flagship's
     full width with stage DEMO_STAGE's curriculum arguments cut to 2
     epochs and 2 test batches (--device_data --augment --batch_size 32
     --eval_batch_size 32 --eval_max_len 475), then again with stage W's
     --remat --pack_bits 4 --host_val, warm-started from the first run's
     checkpoints: fatal unless the epoch losses are finite, the training's
     flash launches are 4 (8 with remat) a train step and 4 a val step,
     test_model launches 4 per encode through the CUDA graphs (each replay
     and the capture's warm-up), and the metrics file has the JAX tool's
     keys; prints per run the steps, epoch losses and seconds, peak memory,
     the test split's capture and replay times. (d) train_curriculum
     --dry_run --stages A-C: 3 builds and 3 trainings through the port's
     modules, the warm starts chained, the metrics under --results_dir.
     (e) The bf16 kernel at DEMO_SHAPE against its plain version, and
     timed as phase 3 times its shapes, beside the bound and the library.
 18. orbax (run before 14): the JAX package's orbax checkpoints, read and
     written by the port without JAX (checkpoint/zstd.py, ocdbt.py,
     orbax.py). (a) tests/goldens/jax_orbax_fixture, written by JAX's
     orbax_io (f32, bf16, int32, int64 and scalar leaves, one sharded 2 x 2
     into four chunks, one stored out of line, Adam's state with a clip and
     a schedule), read on the card's installation: every leaf bit-equal to
     orbax_fixture_tree's seed; prints the libzstd it loaded. (b) Phase 8's
     latest checkpoint converted to the JAX layout (jax_from_state_dict,
     jax_opt_state) and written by orbax.save_checkpoint, read back through
     io.load_checkpoint bit-equal to state.pt (model, Adam moments and
     steps, epoch, step); train_model resumed from it and from a copy of the
     state.pt directory for one more epoch of phase 8's data (augmentation
     off): equal losses (bit-equal expected, else within ORBAX_RESUME_RTOL)
     and 4 flash launches per train and val step; TexOCR(model_path=...)
     from each serving a batch of 8 full canvases x DECODE_STEPS through the
     CUDA graphs: bit-equal tokens, 4 launches a replay. Prints write and
     read s and MB/s, the resumed epoch's s a step and the launches.
 14. launched shapes: every flash launch from phase 3 on is recorded (shapes,
     type, strides, alignment, scale, causal, kv_lens) by the phase that made
     it; each signature that phases 4-13b and 15-18 launched and phase 3 did
     not check (the batcher's padded batches, the float32 checks at 2
     canvases, the golden model's, evaluation's captures, phase 17's batches
     of 32) is held against the plain version here, on fresh
     operands of the same strides and alignment, as phase 3 holds its cases.
Every phase that encodes asserts 4 flash launches per encode on its main
path; a CUDA graph's replay counts the launches its capture made, and a
capture counts none; phase 15 trains through training.cli. Phases 5, 9-13
and 13b decode through TexOCR, and phase 13's test_model through its own
float-input engines, so through CUDA graphs; the eager checks of phases 4,
9-11, 13 and 13b and phase 16's decodes stay eager. Then the seconds each phase took, one
JSON line of per-kernel numbers, the card's name and power limit, and the last
line {"ok": true, "device": {...}}.
"""

import contextlib
import importlib.util
import io
import json
import os
import platform
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
from texocr_tpu_torch.ops.bench import (  # noqa: E402
    SERVING_SHAPES,
    attention_bound_ms,
    attention_f64,
    device_kernel_names,
    split_heads,
    time_ms,
)

# HGMMA per instantiation of the flash kernel, by head dim D: one per wgmma of
# the unrolled loops. bfloat16: Q K^T in D / 16 k-steps, P V in 4 k-steps x
# D / 64 column blocks. float32: three TF32 products each, Q K^T in D / 8
# k-steps, P V in 8 k-steps x D / 64 column blocks.
HGMMA = {
    **{f"flash_fwd_bf16<{d}, {vec}>": d // 16 + 4 * d // 64
       for d in (64, 128) for vec in ("true", "false")},
    **{f"flash_fwd_f32<{d}>": 3 * (d // 8 + 8 * d // 64) for d in (64, 128)},
}
REPEATS = 3  # timed runs per request and per batch; the median is reported
BATCH = 8  # full canvases per batch
DECODE_STEPS = 350  # the serving default max_len; random weights never emit EOS
TRAIN_BATCH = 128  # config/config.yml batch_size
TRAIN_BUCKETS = (((160, 1008), 2), ((64, 512), 1))  # (canvas, batches) of the train split
TRAIN_EPOCHS = 2
TIMED_EPOCHS = 4  # further epochs, each step synchronised, for the step time
TRAIN_SHAPE = (TRAIN_BATCH, 8, 631, 64)  # the encoder's self-attention, full canvases
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
PARALLEL_TIMED = 4  # phase 16a's synchronised full-canvas steps
WORLD1_RTOL = 5e-4  # phase 16a's epoch losses against phase 8's (bf16; atomics reorder sums)
PARALLEL_BF16_RTOL = 1e-3  # phase 16b's bf16 losses against the single process's
PARALLEL_SAMPLE_SEED = 16  # phase 16b's sampling generator, the same in every process
# Phase 16b's float32 decodes: greedy, sampling at 0.3, beam 5, and greedy
# with int8 cross and self caches.
PARALLEL_DECODE_MODES = ("greedy", "sample", "beam", "int8")
# Phase 16's per-rank encoder attention, (B, H, N, dtype): {data: 2} at batch
# 128, {model: 2} at batch 32, the float32 decodes' encode of 2 canvases
# under {model: 2} and of 1 under {data: 2}, and the dry run's 32 x 64 images
# on 2 ranks.
RANK_SHAPES = ((64, 8, 631, torch.bfloat16), (32, 4, 631, torch.bfloat16),
               (2, 4, 631, torch.float32), (1, 8, 631, torch.float32),
               (2, 8, 9, torch.float32))
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
            m = re.search(r"(flash_fwd_\w+?)ILi(\d+)E(?:Lb([01])E)?", mangled)
            name = mangled
            if m:  # flash_fwd_bf16<D, VEC> or flash_fwd_f32<D>
                vec = "" if m.group(3) is None else (", true" if m.group(3) == "1" else ", false")
                name = f"{m.group(1)}<{m.group(2)}{vec}>"
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

        def launch(lib, q, k, v, *, scale, causal=False, kv_lens=None):
            key = (tuple(q.shape), k.shape[2], str(q.dtype)[6:], float(scale), bool(causal),
                   tuple(t.stride() for t in (q, k, v)),
                   tuple(t.data_ptr() % 16 // t.element_size() for t in (q, k, v)),
                   kv_lens is not None)
            entry = self.seen.setdefault(
                key, [set(), None if kv_lens is None else kv_lens.clone()])
            entry[0].add(self.phase)
            return original(lib, q, k, v, scale=scale, causal=causal, kv_lens=kv_lens)

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


def time_flash(fa, gen) -> dict:
    """Per dtype, per serving shape (split-head layout, unmasked): the
    kernel's, the plain version's and scaled_dot_product_attention's time
    (a yardstick the port never calls), L2-warm and L2-cold, beside the
    bound; and the device kernels that the library call ran (its backend)."""
    timings = {}
    for dtype in (torch.bfloat16, torch.float32):
        rows = []
        for b, h, n, dh in SERVING_SHAPES:
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
                   "library_kernels": device_kernel_names(calls["library_ms"])}
            for key, fn in calls.items():
                row[key] = time_ms(fn)
                row[key + "_l2_cold"] = time_ms(fn, cold=True)
            rows.append(row)
            log(f"[kernels] flash_attention {str(dtype)[6:]} {(b, h, n, dh)} split-head timing: "
                + json.dumps(row))
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


def check_golden(fa):
    """The committed reference goldens through the port on the card."""
    from texocr_tpu_torch.models import greedy_decode

    model, io = golden_model()
    images = golden_images(io)
    fa.flash_attention.launches = 0
    with torch.inference_mode():
        enc = model.encode(images)
    tokens = greedy_decode(model, enc, bos_token=48, eos_token=-1, pad_token=49,
                           max_len=io["greedy_tokens"].shape[1] - 1)
    launches = fa.flash_attention.launches  # all float32: the float32 kernel's
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


def expect_launches(fa, encodes, what) -> int:
    """The flash launches counted since the reset: N_LAYERS per encode."""
    launches = fa.flash_attention.launches
    if launches != N_LAYERS * encodes:
        raise AssertionError(f"{what}: expected {N_LAYERS} flash launches per encode, got "
                             f"{launches} for {encodes} encodes")
    return launches


def wall_s(fn) -> float:
    """Median host-clock time of ``fn`` over REPEATS synchronised calls."""
    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def to_input(batch) -> torch.Tensor:
    """uint8 canvases -> the model's input on the card, as TexOCR makes it."""
    return 1.0 - torch.from_numpy(batch).cuda().float() / 255.0


def serve(fa, rng):
    """The flagship model at full width, bf16, seeded random weights."""
    from texocr_tpu_torch.config import FLAGSHIP

    engine = flagship_engine()
    requests = [canvas(rng, 160, 1008), canvas(rng, 96, 512), canvas(rng, 32, 128)]
    batch = np.stack([canvas(rng, 160, 1008) for _ in range(BATCH)])[..., None]
    # Warm-up at every key timed below, before the counted run: the first
    # call of a key captures its CUDA graphs (after one eager run, which pays
    # for cuDNN's choice of convolution algorithms).
    t0 = time.perf_counter()
    for img in requests:
        engine(img, max_len=DECODE_STEPS)
    engine.generate_batch(batch, max_len=DECODE_STEPS)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0

    fa.flash_attention.launches = 0
    request_s = []
    for img in requests:
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            ids, latex = engine(img)
            times.append(time.perf_counter() - t0)
            if not all(0 <= i < 1000 for i in ids) or not isinstance(latex, str):
                raise AssertionError(f"bad request output: {ids[:10]} {latex!r}")
        request_s.append(float(np.median(times)))
        log(f"[serve] request {img.shape}: {len(ids)} tokens, median {request_s[-1] * 1e3:.1f} ms "
            f"of {[round(t * 1e3, 1) for t in times]} ms, latex {latex[:40]!r}")
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        tokens = engine.generate_batch(batch, max_len=DECODE_STEPS)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    batch_s = float(np.median(times))
    launches = fa.flash_attention.launches  # all bfloat16: the bfloat16 kernel's
    tokens = tokens.cpu().numpy()
    if tokens.shape != (BATCH, DECODE_STEPS) or tokens.min() < 0 or tokens.max() >= 1000:
        raise AssertionError(f"bad batch tokens: shape {tokens.shape}")
    for row in tokens:
        engine.postprocess(row)  # the strings decode
    encodes = REPEATS * (len(requests) + 1)
    n_layers = FLAGSHIP["encoder"]["num_layers"]
    log(f"[serve] batch of {BATCH} (160, 1008): median {batch_s:.3f} s of "
        f"{[round(t, 3) for t in times]} s, {BATCH / batch_s:.2f} img/s; "
        f"flash launches {launches} for {encodes} encodes; the 4 keys' first calls (CUDA "
        f"graph capture) {capture_s:.1f} s")
    if launches != n_layers * encodes:
        raise AssertionError(f"expected {n_layers} flash launches per encode, got {launches}")
    return {"request_s": request_s, "batch_s": batch_s, "launches": launches,
            "first_calls_s": capture_s, "engine": engine, "batch": batch}


def device_kernels(fn, span=None) -> dict:
    """One call of ``fn`` under torch.profiler (CUDA activity): its wall time
    (host clock, profiled), the device time summed over its kernels (those a
    CUDA graph replays included), their count, and the 8 kernels that take
    the most device time. With ``span``, host events are recorded too, and
    the result also holds the device time of the kernels run under host-side
    events whose name ends with it, summed per event name."""
    from torch.profiler import ProfilerActivity, profile

    # Host events only where a span needs them: they cost the profile most
    # of its time at a decode's 100,000 kernels.
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if span else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name = {}
    count = 0
    spans = {}
    if span is None:
        # The raw events: prof.events() would build a Python object, and a
        # tree, for each of a decode's 100,000 kernels.
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() * 1e-9
                count += 1
    for e in prof.events() if span is not None else ():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
            count += 1
        elif e.name.endswith(span):
            spans[e.name] = spans.get(e.name, 0.0) + e.device_time_total * 1e-6
    if count == 0:
        raise AssertionError("torch.profiler recorded no device kernels")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    result = {"profiled_wall_s": wall_s, "device_s": sum(by_name.values()), "kernels": count,
              "top": [{"name": n[:90], "s": s} for n, s in top]}
    if span is not None:
        result["span_device_s"] = spans
    return result


def profile_serving(engine, batch) -> dict:
    """Where a batch's serving time goes: encode, then a DECODE_STEPS-step
    greedy decode (no early stop), each timed unprofiled on the host clock
    (median of REPEATS, synchronised) and then profiled once."""
    from texocr_tpu_torch.models import greedy_decode

    model, cfg = engine.model, engine.model.config
    x = to_input(batch)
    result = {}
    with torch.inference_mode():
        enc = model.encode(x)

        def decode():
            greedy_decode(model, enc, bos_token=cfg.bos_token, eos_token=-1,
                          pad_token=cfg.pad_token, max_len=DECODE_STEPS)

        for name, fn in (("encode", lambda: model.encode(x)), ("decode", decode)):
            wall = wall_s(fn)
            prof = device_kernels(fn)
            result[name] = {"wall_s": wall, "device_busy_share": prof["device_s"] / wall, **prof}
    result["decode"]["steps"] = DECODE_STEPS
    result["decode"]["wall_s_per_step"] = result["decode"]["wall_s"] / DECODE_STEPS
    result["decode"]["kernels_per_step"] = result["decode"]["kernels"] / DECODE_STEPS
    log(f"[profile] batch {BATCH} (160, 1008) bf16: encode {result['encode']['wall_s'] * 1e3:.2f} ms "
        f"wall, {result['encode']['device_s'] * 1e3:.2f} ms on the device; decode "
        f"{DECODE_STEPS} steps {result['decode']['wall_s']:.3f} s wall, "
        f"{result['decode']['device_s']:.3f} s on the device, "
        f"{result['decode']['kernels_per_step']:.1f} kernels per step")
    log("[profile] " + json.dumps(result))
    return result


def graphs_phase(fa, engine, batch, profiled) -> dict:
    """Phase 6b: the compiled decode (models.graphed.make_graphed_generate)
    against the eager path on the serving batch, in every mode (see the
    module docstring). ``profiled``: phase 6's eager encode and greedy
    decode, the eager half of greedy's pair."""
    from texocr_tpu_torch.models.attention import decode_chunks
    from texocr_tpu_torch.models.generate import decode_state
    from texocr_tpu_torch.models.graphed import make_graphed_generate

    x = to_input(batch)
    result = {}
    for name in ("greedy", "int8", "beam", "sample"):
        model = (flagship_engine(kv_quant="int8", self_kv_quant="int8").model if name == "int8"
                 else engine.model)
        mode = name if name in ("beam", "sample") else "greedy"
        steps = -(-DECODE_STEPS // 32) * 32 if mode == "beam" else DECODE_STEPS
        gen = torch.Generator(device="cuda").manual_seed(0)
        args = dict(max_len=DECODE_STEPS, mode=mode, generator=gen, temp=0.3, beam_size=BEAM)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        graphed = make_graphed_generate(model, BATCH, batch.shape[1:3], DECODE_STEPS, mode,
                                        beam_size=BEAM, generator=gen, temp=0.3)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        key_gb = (torch.cuda.memory_reserved() - reserved) / 1e9

        # Bit-equal to the eager decode, the generator in the same state.
        gen.manual_seed(1)
        fa.flash_attention.launches = 0
        tokens = graphed(batch)
        launches = expect_launches(fa, 1, f"graphed {name}")
        with torch.inference_mode():
            cross_kv = model.decoder_cross_kv(model.encode(x))

            def eager_decode():
                state = decode_state(model, cross_kv, **args)
                decode_chunks(state, state.run_chunk)
                return state

            gen.manual_seed(1)
            state = eager_decode()
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
        del state
        log(f"[graphs] {name}: capture {capture_s:.2f} s, {key_gb:.3f} GB reserved for the "
            f"key; {note}; flash launches {launches} for 1 encode")
        if not same:
            raise AssertionError(f"the graphed {name} decode differs from the eager one")

        # Paired, in this call: eager (phase 6's for greedy) and graph.
        if name == "greedy":
            eager = {k: profiled["decode"][k] for k in ("wall_s", "device_s", "kernels",
                                                         "kernels_per_step",
                                                         "device_busy_share")}
        else:
            with torch.inference_mode():
                eager = decode_profile(eager_decode, steps)
        graph = decode_profile(graphed.decode, steps)
        result[name] = {"capture_s": capture_s, "key_gb": key_gb, "launches": launches,
                        "encodes": 1, "steps": steps, "eager": eager, "graph": graph}
        log(f"[graphs] {name}, {steps} steps, eager -> graph: wall {eager['wall_s']:.3f} -> "
            f"{graph['wall_s']:.3f} s, device {eager['device_s']:.3f} -> {graph['device_s']:.3f} "
            f"s, kernels a step {eager['kernels_per_step']:.1f} -> "
            f"{graph['kernels_per_step']:.1f}, busy {100 * eager['device_busy_share']:.1f}% -> "
            f"{100 * graph['device_busy_share']:.1f}%")
        if name == "greedy":
            graphed.images.copy_(torch.from_numpy(batch))
            prof = device_kernels(graphed.encode)
            result["encode"] = {
                "eager": {k: profiled["encode"][k] for k in ("wall_s", "device_s", "kernels")},
                "graph": {"wall_s": wall_s(graphed.encode), "device_s": prof["device_s"],
                          "kernels": prof["kernels"]}}
            eager_enc, graph_enc = result["encode"]["eager"], result["encode"]["graph"]
            log(f"[graphs] encode, eager -> graph: wall {eager_enc['wall_s'] * 1e3:.2f} -> "
                f"{graph_enc['wall_s'] * 1e3:.2f} ms, device {eager_enc['device_s'] * 1e3:.2f} "
                f"-> {graph_enc['device_s'] * 1e3:.2f} ms, kernels {eager_enc['kernels']} -> "
                f"{graph_enc['kernels']}")
        del graphed, model
    torch.cuda.empty_cache()

    # The float32 golden model through the graphs, from its float inputs.
    golden, io = golden_model()
    want = io["greedy_tokens"][:, 1:]
    graphed = make_graphed_generate(golden, want.shape[0], io["images"].shape[2:],
                                    want.shape[1], "greedy", float_input=True)
    graphed.images.copy_(golden_images(io))
    fa.flash_attention.launches = 0
    graphed.encode()
    graphed.decode()
    exact = np.array_equal(graphed.state.result().cpu().numpy(), want)
    log(f"[graphs] golden float32 model through the graphs: greedy tokens "
        f"{'exact' if exact else 'DIFFER'}; flash launches {fa.flash_attention.launches} "
        f"(2 layers) for 1 encode")
    if not (exact and fa.flash_attention.launches == 2):
        raise AssertionError("the golden tokens differ through the graphs")
    log("[graphs] " + json.dumps(result))
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


def event_ms(fn, iters=5) -> float:
    """Device time of one call of ``fn`` between two CUDA events over
    ``iters`` calls, after one call to warm up: for calls long enough that
    the host's launch cost does not count (autograd cannot be graph-captured
    here)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


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


def check_train_grads(fa, rng) -> dict:
    """One loss and backward on the same GRAD_IMAGES full canvases through
    the flagship from the same weights, in float32 and in bfloat16, each
    with flash on (FlashAttentionFunction: the kernel forward, the math-path
    backward) and off (the math path both ways); TF32 is off and cuDNN
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
            fa.flash_attention.launches = 0
            logits, shifted = model(images, labels)
            sequence_ce_loss(logits, shifted, pad_token=999).backward()
            if fa.flash_attention.launches != (4 if use_flash else 0):
                raise AssertionError(f"flash={use_flash}: {fa.flash_attention.launches} launches")
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


def time_train_attention(fa, gen) -> dict:
    """The bf16 kernel at TRAIN_SHAPE (split-head, L2-warm, CUDA-graph
    replays) beside its bound, the plain version, scaled_dot_product_attention
    and the math-path backward that FlashAttentionFunction runs there."""
    from texocr_tpu_torch.ops.attention_core import math_attention

    b, h, n, dh = TRAIN_SHAPE
    q, k, v = (split_heads(gen, b, h, n, dh, torch.bfloat16) for _ in range(3))
    scale = dh ** -0.5
    err, tol, note = hold_bf16(fa, fa.flash_attention(q, k, v, scale=scale),
                               fa.flash_attention_plain(q, k, v, scale=scale), q, k, v, scale)
    log(f"[train] flash_attention bf16 {TRAIN_SHAPE} split-head, kernel vs plain: {note} "
        f"{'ok' if err <= tol else 'FAIL'}")
    if not err <= tol:
        raise AssertionError("flash attention kernel disagrees with its plain version")
    bound, bound_by = attention_bound_ms(q, k)
    row = {"shape": list(TRAIN_SHAPE), "max_abs_err": err, "bound_ms": bound, "bound_by": bound_by,
           "ms": time_ms(lambda: fa.flash_attention(q, k, v, scale=scale)),
           "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, scale=scale), iters=5),
           "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
               q, k, v, scale=scale))}
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    grad_out = torch.randn(q.shape, device="cuda", generator=gen).to(torch.bfloat16)

    def backward():
        out = math_attention(qg, kg, vg, scale=scale)
        torch.autograd.grad(out, (qg, kg, vg), grad_out)

    row["math_backward_ms"] = event_ms(backward)
    log(f"[train] flash_attention bf16 {TRAIN_SHAPE} split-head: " + json.dumps(row))
    return row


def time_rank_shapes(fa, gen) -> list:
    """Phase 3 at phase 16's per-rank training shapes (bfloat16, split-head,
    L2-warm, CUDA-graph replays): the kernel against its plain version, and
    its time beside the bound, the plain version and
    scaled_dot_product_attention."""
    rows = []
    for b, h, n, dtype in RANK_SHAPES:
        if dtype != torch.bfloat16:
            continue
        q, k, v = (split_heads(gen, b, h, n, 64, dtype) for _ in range(3))
        scale = 64 ** -0.5
        err, tol, note = hold_bf16(fa, fa.flash_attention(q, k, v, scale=scale),
                                   fa.flash_attention_plain(q, k, v, scale=scale), q, k, v,
                                   scale)
        log(f"[kernels] flash_attention bf16 {(b, h, n, 64)} split-head (a phase 16 rank's "
            f"shape), kernel vs plain: {note} {'ok' if err <= tol else 'FAIL'}")
        if not err <= tol:
            raise AssertionError("flash attention kernel disagrees with its plain version")
        bound, bound_by = attention_bound_ms(q, k)
        row = {"shape": [b, h, n, 64], "max_abs_err": err, "bound_ms": bound,
               "bound_by": bound_by,
               "ms": time_ms(lambda: fa.flash_attention(q, k, v, scale=scale)),
               "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, scale=scale),
                                   iters=5),
               "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, scale=scale))}
        log(f"[kernels] flash_attention bf16 {(b, h, n, 64)} split-head timing: "
            + json.dumps(row))
        rows.append(row)
    return rows


def train(fa, rng, data_dir=None) -> dict:
    """Phase 8: the training path on the card (see the module docstring).
    ``data_dir``: where to write the dataset and leave it (phase 16 trains
    on it again); by default a temporary directory."""
    from texocr_tpu_torch.checkpoint.io import latest_checkpoint, load_checkpoint
    from texocr_tpu_torch.data.dataset import create_dataloader, load_datasets, prefetch
    from texocr_tpu_torch.models import OCRModel
    from texocr_tpu_torch.telemetry import step_timer
    from texocr_tpu_torch.training.loop import train_model
    from texocr_tpu_torch.training.optimizers import get_optimizer
    from texocr_tpu_torch.training.train_step import (
        create_train_state,
        make_eval_step,
        make_train_step,
        put_batch,
    )

    grad_errors = check_train_grads(fa, rng)

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = data_dir or tmp
        write_train_data(data_dir, rng)
        train_set, val_set, _ = load_datasets(data_dir)
        train_set.augment = True  # as the training CLI sets it
        config = train_config(os.path.join(data_dir, "checkpoints"))
        metrics = os.path.join(tmp, "metrics.jsonl")
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        model, state, history = train_model(train_set, val_set, config, metrics_path=metrics,
                                            device="cuda")
        run_s = time.perf_counter() - t0
        launches = fa.flash_attention.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with open(metrics) as f:
            records = [json.loads(line) for line in f]
        train_steps = sum(r["steps"] for r in records if r["event"] == "train_epoch")
        eval_steps = TRAIN_EPOCHS * len(create_dataloader(val_set, config))
        log(f"[train] train_model: {TRAIN_EPOCHS} epochs, {train_steps} train and {eval_steps} "
            f"eval steps in {run_s:.1f} s; epoch losses {history}; flash launches {launches}; "
            f"peak memory {peak_gb:.2f} GB")
        if not (len(history) == TRAIN_EPOCHS and np.isfinite(history).all()):
            raise AssertionError(f"non-finite training loss: {history}")
        if not history[1] < history[0]:
            raise AssertionError(f"the loss did not fall: {history}")
        if launches != 4 * (train_steps + eval_steps):
            raise AssertionError(f"expected 4 flash launches per step, got {launches} for "
                                 f"{train_steps} train and {eval_steps} eval steps")

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

        # The host loader alone (augmentation and collation, no device), one pass.
        t0 = time.perf_counter()
        n_loaded = sum(1 for _ in create_dataloader(train_set, config, seed_offset=TRAIN_EPOCHS))
        loader_s = (time.perf_counter() - t0) / n_loaded

        # Step time: further epochs, each step synchronised (data waits excluded).
        by_bucket = {}
        loader = create_dataloader(train_set, config, seed_offset=TRAIN_EPOCHS + 1)
        for _ in range(TIMED_EPOCHS):
            for host_images, host_labels in prefetch(iter(loader)):
                images, labels = put_batch(host_images, host_labels, "cuda")
                torch.cuda.synchronize()
                fa.flash_attention.launches = 0
                timed = {}
                with step_timer(timed, sync=images):
                    loss = train_step(state, images, labels)["loss"]
                if fa.flash_attention.launches != 4 or not torch.isfinite(loss):
                    raise AssertionError(f"train step: {fa.flash_attention.launches} launches, "
                                         f"loss {loss.item()}")
                by_bucket.setdefault(tuple(images.shape[1:3]), []).append(timed["seconds"])
        full = tuple(TRAIN_BUCKETS[0][0])
        step_s = {f"{h}x{w}": {"median": float(np.median(t)), "min": min(t), "max": max(t),
                           "steps": len(t)} for (h, w), t in by_bucket.items()}
        eval_step = make_eval_step(mask_pad=True)
        host_images, host_labels = next(iter(create_dataloader(val_set, config)))
        val_images, val_labels = put_batch(host_images, host_labels, "cuda")
        fa.flash_attention.launches = 0
        eval_step(state.model, val_images, val_labels).item()
        if fa.flash_attention.launches != 4:
            raise AssertionError(f"eval step: {fa.flash_attention.launches} flash launches")

        # One profiled full-canvas step.
        full_batch = next(b for b in create_dataloader(train_set, config)
                          if b[0].shape[1:3] == full)
        images, labels = put_batch(*full_batch, "cuda")
        prof = device_kernels(lambda: train_step(state, images, labels),
                              span="FlashAttentionFunctionBackward")
        backward_s = max(prof["span_device_s"].values(), default=0.0)
        median_full = float(np.median(by_bucket[full]))
        result = {
            "train_model_s": run_s, "epoch_losses": history, "epochs": records,
            "launches": launches, "launches_per_step": launches / (train_steps + eval_steps),
            "peak_memory_gb": peak_gb, "grad_rel_l2": grad_errors,
            "step_s": step_s, "images_per_s_full": TRAIN_BATCH / median_full,
            "loader_s_per_batch": loader_s,
            "profile": {**prof,
                        "device_busy_share": prof["device_s"] / prof["profiled_wall_s"],
                        "math_backward_share": backward_s / prof["device_s"]},
            "resume_losses": [resumed, kept], "data_dir": data_dir, "config": config,
        }
    log(f"[train] step (synchronised, over {TIMED_EPOCHS} epochs) {step_s} s, "
        f"{TRAIN_BATCH / median_full:.1f} images/s at (160, 1008); host loader alone "
        f"{loader_s:.3f} s per batch; peak memory {peak_gb:.2f} GB; profiled full step "
        f"{prof['device_s'] * 1e3:.1f} ms on the device in {prof['profiled_wall_s'] * 1e3:.1f} "
        f"ms wall, {100 * result['profile']['device_busy_share']:.1f}% busy, attention's "
        f"math-path backward {100 * result['profile']['math_backward_share']:.1f}%")
    log("[train] " + json.dumps({k: v for k, v in result.items()
                                 if k not in ("data_dir", "config")}))
    return result


def gray_edges(img) -> np.ndarray:
    """``img`` with antialiased stroke edges: gray 128 right of a stroke and
    192 below it, as a renderer leaves them (so that a 4-bit bucket loses
    something)."""
    right = np.roll(img, 1, axis=1) // 2 + 128
    below = np.roll(img, 1, axis=0) // 4 + 192
    return np.minimum(np.minimum(img, right), below)


def mem_available_gb() -> float:
    """The host's MemAvailable, in GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise AssertionError("no MemAvailable in /proc/meminfo")


def device_data_phase(fa, rng) -> dict:
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

    (h, w), full_batches = DD_BUCKETS[0]
    tag = h * 4096 + w  # the loop's bucket tag
    torch.cuda.empty_cache()
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_train_data(tmp, rng, DD_BUCKETS)
        train_set, val_set, _ = load_datasets(tmp)
        config = dict(train_config(os.path.join(tmp, "resident")), device_data=True,
                      device_data_augment=True, device_data_steps_per_call=DD_STEPS_PER_CALL)
        metrics = os.path.join(tmp, "resident.jsonl")
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        _, state, history = train_model(train_set, val_set, config, metrics_path=metrics,
                                        device="cuda")
        run_s = time.perf_counter() - t0
        launches = fa.flash_attention.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with open(metrics) as f:
            records = [json.loads(line) for line in f]
        epochs = [r for r in records if r["event"] == "train_epoch"]
        train_steps = sum(r["steps"] for r in epochs)
        eval_steps = sum(1 for r in records if r["event"] == "val")  # one val batch each
        log(f"[device data] train_model, device_data on, augmentation on the device: "
            f"{TRAIN_EPOCHS} epochs, {train_steps} train and {eval_steps // TRAIN_EPOCHS} eval "
            f"steps in {run_s:.1f} s; epoch s {[r['seconds'] for r in epochs]}; epoch losses "
            f"{history}; flash launches {launches}; peak memory {peak_gb:.2f} GB")
        if not (len(history) == TRAIN_EPOCHS and np.isfinite(history).all()):
            raise AssertionError(f"non-finite device-resident training loss: {history}")
        if not history[1] < history[0]:
            raise AssertionError(f"the device-resident loss did not fall: {history}")
        if train_steps != TRAIN_EPOCHS * sum(n for _, n in DD_BUCKETS):
            raise AssertionError(f"expected {sum(n for _, n in DD_BUCKETS)} steps an epoch")
        if launches != N_LAYERS * (train_steps + eval_steps):
            raise AssertionError(f"expected {N_LAYERS} flash launches per step, got {launches} for "
                                 f"{train_steps} train and {eval_steps} eval steps")

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

        # The host loader on the same data, host augmentation on as the CLI sets it.
        train_set.augment = True
        host_metrics = os.path.join(tmp, "host.jsonl")
        train_model(train_set, val_set, dict(config, device_data=False,
                                             save_dir=os.path.join(tmp, "host")),
                    metrics_path=host_metrics, verbose=False, device="cuda")
        with open(host_metrics) as f:
            host_epochs = [json.loads(line) for line in f]
        host_epochs = [r for r in host_epochs if r["event"] == "train_epoch"]
        train_set.augment = False
        torch.cuda.empty_cache()

        # Synchronised steps and a profiled call on the full-canvas bucket.
        data = DeviceResidentData.from_dataset(train_set, seq_pad_multiple=32, device="cuda")
        full = data.buckets[(h, w)]
        run = make_chunk_train_step(TRAIN_BATCH, augment=True)
        perm = epoch_permutation(full.n, 42, 0, tag, "cuda")
        step_s = []
        for s in range(full_batches):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = run(state, full, perm, 1, s)["loss"].item()
            step_s.append(time.perf_counter() - t)
            if not np.isfinite(loss):
                raise AssertionError(f"non-finite loss {loss}")
        prof = device_kernels(lambda: run(state, full, perm, 4, 0))
        del data, full
        median = float(np.median(step_s))
        result.update(
            train_model_s=run_s, epoch_losses=history, epochs=epochs, host_epochs=host_epochs,
            launches=launches, launches_per_step=launches / (train_steps + eval_steps),
            peak_memory_gb=peak_gb, step_s={"median": median, "min": min(step_s),
                                            "max": max(step_s), "steps": len(step_s)},
            images_per_s_full=TRAIN_BATCH / median,
            profile={**prof, "device_busy_share": prof["device_s"] / prof["profiled_wall_s"]})
        log(f"[device data] epoch wall s: device-resident {[r['seconds'] for r in epochs]}, "
            f"host loader {[r['seconds'] for r in host_epochs]} (same data, same run); "
            f"full-canvas step (synchronised) median {median:.4f} s of {len(step_s)}, "
            f"{TRAIN_BATCH / median:.1f} images/s; profiled 4-step call "
            f"{prof['device_s'] * 1e3:.1f} ms on the device in {prof['profiled_wall_s'] * 1e3:.1f} "
            f"ms wall, {100 * result['profile']['device_busy_share']:.1f}% busy")

        # A resident size users run: one full-canvas bucket of RESIDENT_ROWS rows.
        log(f"[device data] host MemAvailable {mem_available_gb():.2f} GB")
        ids = train_set.sizes[(w, h)][:RESIDENT_DISTINCT]
        distinct = [gray_edges(train_set.images[i]) for i in ids]
        big = ImageDataset.from_arrays(
            [distinct[i % len(ids)] for i in range(RESIDENT_ROWS)],
            [train_set.token_ids[ids[i % len(ids)]] for i in range(RESIDENT_ROWS)])
        run = make_chunk_train_step(TRAIN_BATCH, augment=True)
        idx = torch.arange(0, RESIDENT_ROWS, RESIDENT_ROWS // TRAIN_BATCH,
                           device="cuda")[:TRAIN_BATCH]
        gathered = {}
        result["resident"] = {}
        for pack_bits in (8, 4):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            staged = DeviceResidentData.from_dataset(big, seq_pad_multiple=32, device="cuda",
                                                     pack_bits=pack_bits)
            torch.cuda.synchronize()
            stage_s = time.perf_counter() - t
            bucket = staged.buckets[(h, w)]
            gathered[pack_bits] = gather_batch(bucket, idx)[0]
            perm = epoch_permutation(bucket.n, 42, 0, tag, "cuda")
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = run(state, bucket, perm, DD_STEPS_PER_CALL, 0)["loss"].item()
            call_s = time.perf_counter() - t
            row = {"rows": bucket.n, "resident_gb": bucket.images.nbytes / 1e9,
                   "labels_gb": bucket.labels.nbytes / 1e9, "staging_s": stage_s,
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "step_s": call_s / DD_STEPS_PER_CALL, "loss": loss}
            result["resident"][pack_bits] = row
            log(f"[device data] {bucket.n} resident {(h, w)} rows at pack_bits {pack_bits}: "
                f"staged in {stage_s:.1f} s, {row['resident_gb']:.3f} GB of images; one call of "
                f"{DD_STEPS_PER_CALL} steps beside it {call_s:.2f} s "
                f"({row['step_s']:.4f} s a step), loss {loss:.4f}; peak memory "
                f"{row['peak_memory_gb']:.2f} GB")
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
        result["pack4_gather_max_err"] = err_max
        del gathered, big, state
    torch.cuda.empty_cache()
    log("[device data] " + json.dumps(result))
    return result


def decode_profile(fn, steps) -> dict:
    """A decode's wall time (median of REPEATS) and one profiled call's
    device time and kernels per step."""
    wall = wall_s(fn)
    prof = device_kernels(fn)
    return {"wall_s": wall, "device_s": prof["device_s"], "kernels": prof["kernels"],
            "kernels_per_step": prof["kernels"] / steps, "steps": steps,
            "device_busy_share": prof["device_s"] / wall, "top": prof["top"][:4]}


def int8_phase(fa, batch) -> dict:
    """Phase 9: int8 cross- and self-attention K/V on 8 full canvases."""
    from texocr_tpu_torch.models import greedy_decode

    engine = flagship_engine(kv_quant="int8", self_kv_quant="int8")
    engine.generate_batch(batch, max_len=DECODE_STEPS)  # the key's capture
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    tokens = engine.generate_batch(batch, max_len=DECODE_STEPS)
    torch.cuda.synchronize()
    launches = expect_launches(fa, 1, "int8 generate_batch")
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
        f"{100 * agree:.1f}%; flash launches {launches} for 1 encode (decode times: phase 6b) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("int8 decode logits outside the int8 budget")
    return {"launches": launches, "encodes": 1, "err_ratio": err / scale,
            "tokens_agree": agree, "first_difference": first.tolist()}


def sample_phase(fa, batch) -> dict:
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
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    wall = wall_s(lambda: engine.generate_batch(batch, max_len=DECODE_STEPS, mode="sample"))
    launches = expect_launches(fa, REPEATS, "sample generate_batch")
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
        f"{'ok' if ok else 'FAIL'}; generate_batch median {wall:.3f} s, "
        f"{BATCH / wall:.2f} img/s (decode times: phase 6b); flash launches {launches} for "
        f"{REPEATS} encodes")
    if not ok:
        raise AssertionError("a sampled token lies outside the top-k filter")
    return {"launches": launches, "encodes": REPEATS, "generate_batch_s": wall,
            "tiny_temp_exact_rows": exact_rows, "departures": departures}


def beam_phase(fa, batch) -> dict:
    """Phase 11: beam search, timed in bf16 and checked in float32."""
    from texocr_tpu_torch.models import beam_decode, greedy_decode
    from texocr_tpu_torch.models.beam import sequence_logprob
    from texocr_tpu_torch.models.generate import DECODE_CHUNK

    engine = flagship_engine()
    engine.generate_batch(batch, max_len=DECODE_STEPS, mode="beam", beam_size=BEAM)  # capture
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    wall = wall_s(lambda: engine.generate_batch(batch, max_len=DECODE_STEPS, mode="beam",
                                                beam_size=BEAM))
    launches = expect_launches(fa, REPEATS, "beam generate_batch")
    steps = -(-DECODE_STEPS // DECODE_CHUNK) * DECODE_CHUNK  # whole chunks (models/beam.py)
    log(f"[beam] bf16, batch {BATCH} x beam {BEAM} (160, 1008), {DECODE_STEPS} tokens "
        f"({steps} steps): generate_batch median {wall:.3f} s, {BATCH / wall:.2f} img/s "
        f"(decode times: phase 6b); flash launches {launches} for {REPEATS} encodes")
    del engine

    checks = {}
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
        checks[quant] = {"scores": scores.tolist(), "forced": forced.tolist()}
        log(f"[beam] float32, 2 full canvases, {BEAM_CHECK_STEPS} steps, self_kv_quant "
            f"{quant}: {note} (rtol {SCORE_RTOL:g}) {'ok' if ok else 'FAIL'}")
        del m
        if not ok:
            raise AssertionError(f"beam search check failed (self_kv_quant {quant})")
    return {"launches": launches, "encodes": REPEATS, "generate_batch_s": wall,
            "images_per_s": BATCH / wall, "checks": checks}


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


def http_phase(fa, rng) -> dict:
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
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=timeout) as r:
                payload = json.loads(r.read())
            return payload, time.perf_counter() - t0

        solo = canvas(rng, *sizes[0])
        want_ids, _ = engine(solo, max_len=DECODE_STEPS)
        engine.generate_batch = recording
        fa.flash_attention.launches = 0
        payload, _ = post(png_bytes(solo))
        if payload["tokens"] != want_ids:
            raise AssertionError("a solo POST differs from engine(img) on the same canvas")
        # Every other request is RGB: the server turns it to grey.
        images = [canvas(rng, *sizes[i % 3]) for i in range(HTTP_REQUESTS)]
        bodies = [png_bytes(img, rgb=i % 2 == 1) for i, img in enumerate(images)]
        decode_ms = {"grey": [], "rgb": []}
        for i, (img, body) in enumerate(zip(images, bodies)):
            t0 = time.perf_counter()
            grey = decode_image(body)
            decode_ms["rgb" if i % 2 else "grey"].append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(grey, img):
                raise AssertionError("decode_image does not return the canvas it was given")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=HTTP_CONCURRENCY) as ex:
            results = list(ex.map(post, bodies))
        total_s = time.perf_counter() - t0
        launches = expect_launches(fa, len(formed), "http")
        for payload, _ in results:
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
    latency = [s for _, s in results]
    requests = [n for _, n in formed[1:]]
    result = {"requests": HTTP_REQUESTS, "concurrency": HTTP_CONCURRENCY,
              "p50_s": float(np.percentile(latency, 50)),
              "p99_s": float(np.percentile(latency, 99)), "total_s": total_s,
              "requests_per_s": HTTP_REQUESTS / total_s, "batches_formed": formed[1:],
              "mean_batch": float(np.mean(requests)), "launches": launches,
              "encodes": len(formed),
              "decode_image_ms": {kind: {"median": float(np.median(ms)), "max": max(ms)}
                                  for kind, ms in decode_ms.items()}}
    log(f"[http] solo POST equals engine(img); {HTTP_REQUESTS} POSTs of {len(sizes)} canvas "
        f"sizes (grey and RGB PNGs, rows filtered as PIL writes them) at concurrency "
        f"{HTTP_CONCURRENCY}, max_len {DECODE_STEPS}: p50 {result['p50_s']:.3f} s, p99 "
        f"{result['p99_s']:.3f} s, {result['requests_per_s']:.2f} req/s; decode_image alone "
        f"(ms, median and max of {HTTP_REQUESTS // 2} each) {result['decode_image_ms']}; formed "
        f"batches (rows, requests) {formed[1:]} (mean {result['mean_batch']:.2f} requests); "
        f"/healthz ok, 400 for no image; flash launches {launches} for {len(formed)} encodes ok")
    return result


def eval_phase(fa, rng) -> dict:
    """Phase 13: test_model through the CUDA graphs on a pickled split of two
    full batches, greedy and beam 5 (see the module docstring)."""
    from texocr_tpu_torch.data.dataset import ImageDataset, create_dataloader
    from texocr_tpu_torch.evaluation.evaluate import graph_engines, test_model
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
            timed = {"keys": [], "capture_s": [], "graph_s": []}
            build = graph_engines(model)

            def factory(batch, canvas, max_len, mode_, beam_size):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                graphed = build(batch, canvas, max_len, mode_, beam_size)
                torch.cuda.synchronize()
                timed["capture_s"].append(time.perf_counter() - t0)
                timed["keys"].append([batch, *canvas, max_len, mode_, beam_size])

                def replay(images):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    tokens = graphed(images)
                    torch.cuda.synchronize()
                    timed["graph_s"].append(time.perf_counter() - t1)
                    return tokens

                return replay

            pairs = os.path.join(tmp, f"pairs_{mode}.jsonl")
            fa.flash_attention.launches = 0
            t0 = time.perf_counter()
            got = test_model(test_set, model, config, max_len=EVAL_MAX_LEN, verbose=False,
                             decode_mode=mode, beam_size=BEAM, pairs_out=pairs,
                             engine_factory=factory)
            seconds = time.perf_counter() - t0
            # Each key's capture runs one eager encode first (its warm-up).
            encodes = got["batches"] + len(timed["keys"])
            launches = expect_launches(fa, encodes, f"eval {mode}")

            # The same collated float batches through the eager generate.
            with open(pairs) as f:
                written = [json.loads(line)["pred"] for line in f]
            eager_s, eager_rows = [], []
            for images, _, _ in batches:
                x = torch.from_numpy(images).cuda()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                pred = generate(model, x, max_len=EVAL_MAX_LEN, mode=mode, beam_size=BEAM)
                torch.cuda.synchronize()
                eager_s.append(time.perf_counter() - t1)
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
            gain = float(np.mean(eager_s)) - float(np.mean(timed["graph_s"]))
            wins_from = int(np.floor(timed["capture_s"][0] / gain)) + 1 if gain > 0 else None
            log(f"[eval] test_model {mode} through the graphs: {got} in {seconds:.1f} s; from "
                f"generate_batch on the same batches {want}; pairs_out tokens "
                f"{'bit-equal to' if same else 'DIFFER FROM'} the eager generate's; flash "
                f"launches {launches} for {encodes} encodes ({got['batches']} replays, "
                f"{len(timed['keys'])} capture warm-ups) {'ok' if ok else 'FAIL'}")
            log(f"[eval] {mode}: keys {timed['keys']}; first key's capture "
                f"{timed['capture_s'][0]:.2f} s; wall s per batch, graphs after capture "
                f"{[round(t, 4) for t in timed['graph_s']]} against eager "
                f"{[round(t, 4) for t in eager_s]} on the same batches; the graphs win from "
                f"{wins_from} batches of a key on")
            if not ok:
                raise AssertionError(f"test_model's {mode} decode through the graphs differs")
            out[mode] = {**got, "seconds": seconds, "launches": launches, "encodes": encodes,
                         "keys": timed["keys"], "capture_s": timed["capture_s"],
                         "graph_s": timed["graph_s"], "eager_s": eager_s,
                         "graphs_win_from_batches": wins_from}
    return out


def variant_overrides(name) -> dict:
    """The config keys of a model variant, over the flagship's."""
    from texocr_tpu_torch.config import FLAGSHIP

    return {"patch": {"encoder": dict(FLAGSHIP["encoder"], embed_layer="patch")},
            "glu false": {"glu": False},
            "no cross": {"decoder": dict(FLAGSHIP["decoder"], cross_attend=False)}}[name]


def serve_variant(fa, name, batch, rng, flagship_encode_err) -> dict:
    """A variant's greedy generate_batch through the CUDA graphs against the
    eager generate, its launches, its float32 encode on both paths and its
    encode and decode wall times. A variant that keeps the flagship's
    encoder (``glu`` reaches only the decoder) reuses phase 7's reading of
    that encoder, ``flagship_encode_err``, instead of encoding again."""
    from texocr_tpu_torch.models import generate

    overrides = variant_overrides(name)
    engine = flagship_engine(**overrides)
    t0 = time.perf_counter()
    engine.generate_batch(batch, max_len=DECODE_STEPS)  # the key's capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    fa.flash_attention.launches = 0
    tokens = engine.generate_batch(batch, max_len=DECODE_STEPS)
    torch.cuda.synchronize()
    launches = expect_launches(fa, 1, f"{name} generate_batch")
    with torch.inference_mode():
        eager = generate(engine.model, to_input(batch), max_len=DECODE_STEPS)
    same = tokens.shape == (BATCH, DECODE_STEPS) and torch.equal(tokens, eager)
    graphed = engine._decode_fn(tuple(batch.shape), DECODE_STEPS, "greedy", BEAM, 0.3)
    encode_s, decode_s = wall_s(graphed.encode), wall_s(graphed.decode)
    own_encoder = "encoder" in overrides
    err = encode_paths_err(rng, overrides) if own_encoder else flagship_encode_err
    ok = same and err <= F32_TOL
    log(f"[variants] {name}: batch {BATCH} (160, 1008) bf16 greedy {DECODE_STEPS} tokens "
        f"through the graphs, tokens {'bit-equal to' if same else 'DIFFER FROM'} the eager "
        f"generate's; flash launches {launches} for 1 encode; encode {encode_s * 1e3:.2f} ms, "
        f"decode {decode_s:.3f} s wall (graph replays, median of {REPEATS}); capture "
        f"{capture_s:.2f} s; float32 encode kernel vs plain path max err {err:.3e} "
        f"({'this encoder' if own_encoder else 'the flagship encoder, phase 7'}; tol "
        f"{F32_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {name} variant failed on the card")
    return {"launches": launches, "encodes": 1, "encode_s": encode_s, "decode_s": decode_s,
            "capture_s": capture_s, "f32_encode_err": err}


def no_cross_variant(fa, rng) -> dict:
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0
    losses, step_s = [], []
    for _ in range(VARIANT_TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(train_step(state, x, y)["loss"]))  # the read synchronises
        step_s.append(time.perf_counter() - t0)
    launches = fa.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
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
        f"{labels.shape[1]} tokens, full canvases, bf16: losses {losses}, step s "
        f"{[round(t, 4) for t in step_s]} (the first pays the warm-up), peak memory "
        f"{peak_gb:.2f} GB; flash launches {launches} (the decoder reads no encoder output, "
        f"so the step does not encode); ValueError from {refused} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the no-cross variant failed on the card")
    return {"launches": launches, "encodes": 0, "losses": losses, "step_s": step_s,
            "peak_memory_gb": peak_gb, "tokens": int(labels.shape[1])}


def maps_variant(fa, batch, rng) -> dict:
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
        torch.cuda.synchronize()
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        logits, maps = model.dec(seq, enc, return_attn=True)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        launches = fa.flash_attention.launches
        cross = maps[1::2]
        shapes = sorted({tuple(m.shape) for m in cross})
        row_err = max((m.sum(-1) - 1).abs().max().item() for m in maps)
    want = (BATCH, 8, MAPS_TOKENS, enc.shape[1])
    ok = (len(maps) == 2 * n_layers and shapes == [want] and row_err <= F32_TOL
          and launches == 0 and bool(torch.isfinite(logits).all()))
    log(f"[variants] maps: decoder(return_attn=True) at batch {BATCH} x {MAPS_TOKENS} tokens, "
        f"bf16: {len(maps)} maps, cross maps {shapes} float32, rows sum to 1 within "
        f"{row_err:.2e} (tol {F32_TOL:g}); flash launches {launches}; {replay_s * 1e3:.1f} ms "
        f"wall {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the attention maps failed on the card")
    del logits, maps, cross, enc

    with tempfile.TemporaryDirectory() as tmp:
        png, cfg, out = (os.path.join(tmp, name) for name in ("eq.png", "cfg.json", "maps"))
        with open(png, "wb") as f:
            f.write(encode_png(canvas(rng, 160, 1008)))
        with open(cfg, "w") as f:
            json.dump(dict(FLAGSHIP, tokenizer_path=DEFAULT_VOCAB_PATH, seed=0), f)
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        rc = attention_maps.main([png, "--config", cfg, "--out", out, "--max_len",
                                  str(DECODE_STEPS), "--max_tokens", str(MAPS_PNGS),
                                  "--device", "cuda"])
        tool_s = time.perf_counter() - t0
        # The capture's eager warm-up, the graph replay and the maps replay's.
        tool_launches = expect_launches(fa, 3, "attention-maps tool")
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
        f"encodes (the capture's warm-up, the graph replay, the maps replay); {tool_s:.1f} s "
        f"with the key's capture "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the attention-maps tool failed on the card")
    return {"replay": {"launches": launches, "encodes": 0, "seconds": replay_s,
                       "row_err": row_err},
            "tool": {"launches": tool_launches, "encodes": 3, "seconds": tool_s}}


def variants_phase(fa, batch, rng, flagship_encode_err) -> dict:
    """Phase 13b: the model variants and the attention maps (see the module
    docstring); ``flagship_encode_err``: phase 7's float32 encoder reading."""
    out = {name: serve_variant(fa, name, batch, rng, flagship_encode_err)
           for name in ("patch", "glu false")}
    out["no cross"] = no_cross_variant(fa, rng)
    maps = maps_variant(fa, batch, rng)
    out["maps replay"], out["maps tool"] = maps["replay"], maps["tool"]
    log("[variants] " + json.dumps(out))
    return out


DATA_CANVAS = (160, 1008)  # phase 15 pads every render onto the flagship's canvas
DATA_SPLITS = {"train": 2 * TRAIN_BATCH, "test": 16, "val": TRAIN_BATCH}  # rows per split
ENCODE_LABELS = 20_000  # labels timed through encode_batch, native and pure Python
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


def host_cpu() -> str:
    """The host CPU's model and its count of CPUs, from /proc/cpuinfo: its
    model name, or where that is missing or "unknown" (a virtualised kernel
    may hide it; an Arm host has none) the machine and the fields that name
    the part."""
    with open("/proc/cpuinfo") as f:
        fields = dict(line.split(":", 1) for line in f if ":" in line)
    fields = {k.strip(): v.strip() for k, v in fields.items()}
    name = fields.get("model name", "unknown")
    if name in ("", "unknown"):
        keys = ("vendor_id", "cpu family", "model", "cpu MHz", "CPU implementer", "CPU part")
        name = ", ".join([platform.machine()] + [f"{k} {fields[k]}" for k in keys if k in fields])
    return f"{name} x {os.cpu_count()}"


def tokenizer_check(rng, card, cpu) -> dict:
    """Phase 15a: the g++-built native encoder, the goldens through encode
    and encode_batch, a retrain on the golden corpus, and encode_batch's
    labels/s native against pure Python."""
    from texocr_tpu_torch.ops import build
    from texocr_tpu_torch.tokenizer import RegexBPETokenizer, load_default_tokenizer, native

    t0 = time.perf_counter()
    library, _ = build.build(native.SOURCE)
    build_s = time.perf_counter() - t0
    if not native.native_available():
        raise AssertionError(f"the native BPE encoder did not load: {native.native_error()}")
    log(f"[data] {native.SOURCE} built by {build.host_compiler_path()} in {build_s:.2f} s "
        f"({library.name})")

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
    t0 = time.perf_counter()
    trained.train(corpus)
    train_s = time.perf_counter() - t0
    golden_merges = {tuple(k): v for k, v in golden_train["merges"]}
    ok = trained.bp_merges == golden_merges
    log(f"[data] retrain on the golden corpus ({golden_train['vocab_size']} tokens, x"
        f"{golden_train['corpus_repeats']}): {len(trained.bp_merges)} merges in {train_s:.2f} s, "
        f"{'equal to' if ok else 'FAIL: not'} the golden {len(golden_merges)}")
    if not ok:
        raise AssertionError("retrained merges differ from the golden")

    labels = latex_labels(rng, ENCODE_LABELS)
    calls = native.NativeBPEEncoder.calls
    t0 = time.perf_counter()
    fast = tok.encode_batch(labels)
    native_s = time.perf_counter() - t0
    if native.NativeBPEEncoder.calls != calls + 1:
        raise AssertionError("encode_batch did not run natively")
    t0 = time.perf_counter()
    slow = [tok.encode(t) for t in labels]
    python_s = time.perf_counter() - t0
    if fast != slow:
        raise AssertionError("encode_batch's native ids differ from encode's")
    rates = {"native": ENCODE_LABELS / native_s, "python": ENCODE_LABELS / python_s}
    log(f"[data] encode_batch of {ENCODE_LABELS} seeded labels: native {native_s:.3f} s "
        f"({rates['native']:.0f} labels/s), pure Python {python_s:.3f} s "
        f"({rates['python']:.0f} labels/s), ids equal; host {cpu}; {card}")
    return {"build_s": build_s, "retrain_s": train_s, "encode_s": {"native": native_s,
                                                                    "python": python_s},
            "labels_per_s": rates}


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


def build_data(rng, root, cpu) -> dict:
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
    t0 = time.perf_counter()
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
    render_s = time.perf_counter() - t0

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
    log(f"[data] split {total} equations, rendered ({renderer}) in {render_s:.2f} s: rows "
        f"{rows}, rendered sizes (h, w) from {min(sizes)} to {max(sizes)} over {len(sizes)} "
        f"sizes, padded to {DATA_CANVAS}; host {cpu}")

    pickles = {}
    for lazy in (False, True):
        kind = "lazy" if lazy else "eager"
        for split in DATA_SPLITS:
            os.makedirs(os.path.join(root, kind, split))
            path = os.path.join(root, kind, split, f"{split}set.pkl")
            t0 = time.perf_counter()
            pickle_data.main(pickle_data.parse_args(
                ["-c", cfg_path, "--split", split, "-s", path] + ["--lazy"] * lazy))
            pickles[kind, split] = {"build_s": time.perf_counter() - t0,
                                    "mb": os.path.getsize(path) / 1e6}
    log("[data] pickles (build s, MB): " + json.dumps(
        {f"{kind} {split}": [round(r["build_s"], 3), round(r["mb"], 3)]
         for (kind, split), r in pickles.items()}) + f"; host {cpu}")
    return {"renderer": renderer, "render_s": render_s, "rows": rows, "pickles": pickles,
            "config": config}


def data_phase(fa, rng) -> dict:
    """Phase 15: the data path on the card's machine, then the flagship
    trained on what it built (see the module docstring)."""
    from texocr_tpu_torch.data.dataset import create_dataloader, load_datasets
    from texocr_tpu_torch.training import cli as train_cli

    card, cpu = card_line(), host_cpu()
    out = {"tokenizer": tokenizer_check(rng, card, cpu)}
    with tempfile.TemporaryDirectory() as root:
        out["factory"] = build_data(rng, root, cpu)
        config = train_config(os.path.join(root, "checkpoints"))
        config["n_epochs"] = 1
        cfg_path = os.path.join(root, "train.json")
        with open(cfg_path, "w") as f:
            json.dump(config, f)

        for kind in ("eager", "lazy"):
            metrics = os.path.join(root, f"{kind}.jsonl")
            fa.flash_attention.launches = 0
            t0 = time.perf_counter()
            train_cli.main(train_cli.parse_args(["-d", os.path.join(root, kind), "--config",
                                                 cfg_path, "--metrics", metrics,
                                                 "--device", "cuda"]))
            run_s = time.perf_counter() - t0
            launches = fa.flash_attention.launches
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
                f"{launches}, epoch wall {epochs[0]['seconds']:.3f} s, run {run_s:.1f} s; "
                f"pickle {out['factory']['pickles'][kind, 'train']['mb']:.3f} MB built in "
                f"{out['factory']['pickles'][kind, 'train']['build_s']:.3f} s; host {cpu}; "
                f"{card} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{kind} training: expected {N_LAYERS} flash launches per "
                                     "encode, finite losses and one epoch")
            out[kind] = {"launches": launches, "encodes": int(steps) + val_steps,
                         "epoch_s": epochs[0]["seconds"], "run_s": run_s, "losses": losses}

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
    out["factory"].pop("config")
    out["factory"]["pickles"] = {f"{k} {s}": r for (k, s), r in out["factory"]["pickles"].items()}
    return out


def trace_times(path) -> dict:
    """From a Chrome trace that ``telemetry.profile_trace`` wrote: the host
    time (ms) of each collective span of ``parallel/layers.py``, summed per
    name, and the device time of the NCCL kernels (gloo runs its collectives
    on the host, staging CUDA tensors through host memory)."""
    from texocr_tpu_torch.parallel import layers

    out = dict.fromkeys((layers.GRAD_SPAN, layers.MODEL_SPAN, layers.SUM_SPAN, layers.ROWS_SPAN,
                         "nccl_kernels"), 0.0)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    for e in events:
        if e.get("ph") != "X":
            continue
        name, ms = e.get("name", ""), e.get("dur", 0) / 1e3
        if e.get("cat") == "user_annotation" and name in out:
            out[name] += ms
        elif e.get("cat") == "kernel" and "nccl" in name.lower():
            out["nccl_kernels"] += ms
    return {f"{k}_ms": v for k, v in out.items()}


def profiled_step(fn, logdir, name) -> dict:
    """One synchronised call of ``fn`` under ``telemetry.profile_trace``: its
    wall time, the collectives' times from the trace and their share of the
    wall time."""
    from texocr_tpu_torch.telemetry import profile_trace

    with profile_trace(logdir, name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = trace_times(os.path.join(logdir, f"{name}.json"))
    host_ms = sum(v for k, v in spans.items() if k != "nccl_kernels_ms")
    return {"profiled_wall_ms": wall_ms, **spans,
            "collective_share": (host_ms + spans["nccl_kernels_ms"]) / wall_ms}


def world1_phase(fa, trained) -> dict:
    """Phase 16a: phase 8's train_model, data and seed on a process group of
    one rank over NCCL (the whole distributed path: the mesh, the global
    loss's count and the gradients' all-reduce on the card). Fatal: epoch
    losses beyond WORLD1_RTOL of phase 8's, other than 4 flash launches per
    step. Prints the synchronised full-canvas step beside phase 8's and the
    gradient all-reduce's bytes and time."""
    import torch.distributed as dist

    from texocr_tpu_torch.data.dataset import create_dataloader, load_datasets
    from texocr_tpu_torch.training.loop import train_model
    from texocr_tpu_torch.training.train_step import make_train_step, put_batch

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1,
                                rank=0)
        try:
            train_set, val_set, _ = load_datasets(trained["data_dir"])
            train_set.augment = True  # as phase 8
            config = train_config(os.path.join(tmp, "checkpoints"))
            fa.flash_attention.launches = 0
            t0 = time.perf_counter()
            model, state, history = train_model(train_set, val_set, config, verbose=False,
                                                device="cuda")
            run_s = time.perf_counter() - t0
            launches = fa.flash_attention.launches
            eval_steps = TRAIN_EPOCHS * len(create_dataloader(val_set, config))
            if launches != 4 * (state.step + eval_steps):
                raise AssertionError(f"world of 1: {launches} flash launches for {state.step} "
                                     f"train and {eval_steps} eval steps")
            want = trained["epoch_losses"]
            err = float(np.max(np.abs(np.array(history) - want) / np.abs(want)))
            log(f"[parallel] (a) NCCL world of 1, mesh {{data: 1, model: 1}}: train_model "
                f"epoch losses {history} against phase 8's {want}: max relative difference "
                f"{err:.3e} (tol {WORLD1_RTOL:g}) {'ok' if err <= WORLD1_RTOL else 'FAIL'}; "
                f"flash launches {launches}; {run_s:.1f} s")
            if not err <= WORLD1_RTOL:
                raise AssertionError("the world-of-1 run's losses differ from phase 8's")

            train_step = make_train_step(mask_pad=True)
            full = [b for b in create_dataloader(train_set, config, seed_offset=TRAIN_EPOCHS)
                    if b[0].shape[1:3] == TRAIN_BUCKETS[0][0]]
            times = []
            for i in range(PARALLEL_TIMED):
                images, labels = put_batch(*full[i % len(full)], "cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_step(state, images, labels)["loss"].item()
                times.append(time.perf_counter() - t0)
            profile = profiled_step(lambda: train_step(state, images, labels), tmp, "world1")
            grad_bytes = sum(p.grad.numel() * p.grad.element_size()
                             for p in model.parameters() if p.grad is not None)
        finally:
            dist.destroy_process_group()
    phase8 = trained["step_s"]["x".join(map(str, TRAIN_BUCKETS[0][0]))]["median"]
    result = {"epoch_losses": history, "max_rel_diff": err, "launches": launches,
              "step_s_median": float(np.median(times)), "phase8_step_s_median": phase8,
              "grad_bytes": grad_bytes, **profile}
    log(f"[parallel] (a) full-canvas step {result['step_s_median']:.4f} s (median of "
        f"{PARALLEL_TIMED}, synchronised) against phase 8's {phase8:.4f} s; gradient "
        f"all-reduce {grad_bytes / 1e6:.1f} MB a step: {profile['grad_all_reduce_ms']:.3f} ms "
        f"on the host, {profile['nccl_kernels_ms']:.3f} ms of NCCL kernels; collectives "
        f"{100 * profile['collective_share']:.2f}% of a profiled step "
        f"({profile['profiled_wall_ms']:.1f} ms)")
    del model, state
    torch.cuda.empty_cache()
    return result


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


def parallel_steps(axis, sharded, logdir=None) -> dict:
    """PARALLEL_STEPS Adam steps of the bf16 flagship on the global batches
    of PARALLEL_BATCHES[axis] rows, on the mesh ``{axis: 2}`` if
    ``sharded`` (else in one process): each step's global loss, this rank's
    synchronised step times and flash launches, its peak memory and, with
    ``logdir``, a further profiled step."""
    from texocr_tpu_torch.ops import flash_attention as fa
    from texocr_tpu_torch.parallel.mesh import create_mesh
    from texocr_tpu_torch.parallel.sharding import batch_rows
    from texocr_tpu_torch.training.optimizers import get_optimizer
    from texocr_tpu_torch.training.train_step import create_train_state, make_train_step

    mesh = create_mesh({axis: 2}, device="cuda") if sharded else None
    torch.cuda.reset_peak_memory_stats()
    model = flagship_model("bfloat16", mesh)
    state = create_train_state(model, get_optimizer("Adam", {"lr": 5e-4}, model.parameters(),
                                                    model.tp), seed=42)
    step = make_train_step(mask_pad=True)
    out = {"losses": [], "step_s": [], "launches": []}
    for i in range(PARALLEL_STEPS):
        images, labels = parallel_batch(i, PARALLEL_BATCHES[axis])
        rows = batch_rows(len(images), mesh)
        images, labels = (torch.from_numpy(x[rows]).cuda() for x in (images, labels))
        fa.flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["losses"].append(step(state, images, labels)["loss"].item())
        out["step_s"].append(time.perf_counter() - t0)
        out["launches"].append(fa.flash_attention.launches)
    if logdir is not None:
        out["profile"] = profiled_step(lambda: step(state, images, labels), logdir,
                                       f"{axis}_rank{torch.distributed.get_rank()}")
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model, state
    torch.cuda.empty_cache()
    return out


def parallel_decode(mesh=None) -> dict:
    """Float32 mesh_generate of PARALLEL_DECODE's full canvases (one process,
    or the whole batch under ``mesh``) in each of PARALLEL_DECODE_MODES
    ("int8": greedy with int8 cross and self caches; sampling from a
    generator seeded with PARALLEL_SAMPLE_SEED): per mode (tokens,
    synchronised seconds, flash launches)."""
    from texocr_tpu_torch.models.generate import mesh_generate
    from texocr_tpu_torch.ops import flash_attention as fa

    n, steps = PARALLEL_DECODE
    images = torch.from_numpy(parallel_batch(99, n)[0]).cuda()
    models = {"plain": flagship_model("float32", mesh),
              "int8": flagship_model("float32", mesh, kv_quant="int8", self_kv_quant="int8")}
    out = {}
    for mode in PARALLEL_DECODE_MODES:
        model = models["int8" if mode == "int8" else "plain"]
        gen = torch.Generator(device="cuda").manual_seed(PARALLEL_SAMPLE_SEED)
        fa.flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = mesh_generate(model, images, mesh, max_len=steps,
                               mode="greedy" if mode == "int8" else mode, generator=gen,
                               temp=0.3, beam_size=BEAM)
        torch.cuda.synchronize()
        out[mode] = (tokens.cpu().numpy(), time.perf_counter() - t0,
                     fa.flash_attention.launches)
    del models
    torch.cuda.empty_cache()
    return out


def parallel_rank(logdir) -> dict:
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
        out[axis] = parallel_steps(axis, True, logdir)
        dist.barrier()
    for b, h, n, dtype in RANK_SHAPES[:4]:
        q, k, v = (split_heads(gen, b, h, n, 64, dtype) for _ in range(3))
        _, _, err, ok, note = hold_kernel(fa, q, k, v, 64 ** -0.5)
        out["kernels"].append({"shape": [b, h, n, 64], "dtype": str(dtype)[6:], "ok": ok,
                               "max_abs_err": err, "note": note})
    out["decode"] = {axis: parallel_decode(create_mesh({axis: 2}, device="cuda"))
                     for axis in ("model", "data")}
    return out


def parallel_phase(fa, trained) -> dict:
    """Phase 16: parallelism on the card (see the module docstring). These
    are correctness phases: gloo stages CUDA tensors through the host and
    the two ranks of (b) time-share one card, so no time here is a data- or
    tensor-parallel speed."""
    from texocr_tpu_torch.parallel.dryrun import dryrun_multichip, spawn

    t = {}
    t0 = time.perf_counter()
    world1 = world1_phase(fa, trained)
    t["a"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    single = {axis: parallel_steps(axis, False) for axis in PARALLEL_BATCHES}
    single_decode = parallel_decode()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn(parallel_rank, 2, (tmp,), store_dir=tmp)
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
                f"per step {got['launches']}; step s {got['step_s']} (one process: "
                f"{single[axis]['step_s']}); peak memory {got['peak_memory_gb']:.2f} GB (one "
                f"process: {single[axis]['peak_memory_gb']:.2f}); profiled step "
                + json.dumps(got["profile"]) + f" {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{axis} rank {rank}")
    for rank, r in enumerate(ranks):
        for row in r["kernels"]:
            log(f"[parallel] (b) rank {rank}: flash_attention {row['dtype']} {row['shape']} "
                f"split-head, kernel vs plain: {row['note']} {'ok' if row['ok'] else 'FAIL'}")
            if not row["ok"]:
                failed.append(f"kernel {row['shape']} rank {rank}")
        for axis, decodes in r["decode"].items():
            for mode, (tokens, decode_s, launches) in decodes.items():
                want, want_s, _ = single_decode[mode]
                same = np.array_equal(tokens, want)
                log(f"[parallel] (b) rank {rank}: float32 {mode} decode of {PARALLEL_DECODE[0]} "
                    f"full canvases x {PARALLEL_DECODE[1]} steps under {{{axis}: 2}}: tokens "
                    f"{'equal to' if same else 'DIFFER from'} one process's; {decode_s:.2f} s "
                    f"(one process: {want_s:.2f} s); flash launches {launches} for 1 encode")
                if not (same and launches == N_LAYERS):
                    failed.append(f"{mode} decode {axis} rank {rank}")
    t["b"] = time.perf_counter() - t0
    if failed:
        raise AssertionError(f"phase 16b failed: {failed}")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dry = dryrun_multichip(2, device="cuda", store_dir=tmp)
    t["c"] = time.perf_counter() - t0
    log(f"[parallel] (c) dryrun_multichip(2) on cuda:0: loss {dry['loss']:.4f}; seconds per "
        f"sub-phase " + json.dumps(t) + " (correctness phases: gloo stages CUDA tensors "
        "through the host and the ranks time-share one card; not a parallel speed)")
    return {"world1": world1, "single": single, "ranks": [
        {axis: r[axis] for axis in PARALLEL_BATCHES} for r in ranks],
        "launches": {"a": world1["launches"],
                     **{f"b {axis} rank {i}": sum(r[axis]["launches"])
                        for i, r in enumerate(ranks) for axis in PARALLEL_BATCHES},
                     **{f"b decode {axis} {mode} rank {i}": d[2]
                        for i, r in enumerate(ranks) for axis, decodes in r["decode"].items()
                        for mode, d in decodes.items()}},
        "seconds": t}


DEMO_N = 640  # phase 17's --realistic demo build: 512 train, 96 test, 32 val rows
DEMO_SEED = 13
DEMO_BATCH = 32  # the curriculum's batch, for training and evaluation
DEMO_SHAPE = (DEMO_BATCH, 8, 631, 64)  # its encoder self-attention on full canvases
DEMO_STAGE = "D"  # the curriculum stage whose training arguments phase 17 cuts down
DEMO_CUTS = ["--epochs", "2", "--eval_batches", "2", "--save_freq", "1", "--val_freq", "1"]
DEMO_STAGE_W = ["--remat", "--pack_bits", "4", "--host_val"]  # stage W's knobs
DEMO_TORN = 40  # train images deleted from the build's tail before the partial pickles
DEMO_HOLDOUT = 64  # pickle_partial_typeset's --holdout on the torn build
REMAT_TIMED = 8  # synchronised fixed-batch steps per remat setting
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

    t0 = time.perf_counter()
    eqs = mdd.demo_equations(np.random.default_rng(DEMO_SEED), DEMO_N, realistic=True)
    splits = mdd.split_equations(eqs)
    for split, labels in splits.items():
        shapes = iter([demo_canvas(split, i) for i in range(len(labels))])
        mdd.write_split(os.path.join(build, split), labels,
                        lambda eq, r: canvas(r, *next(shapes)), rng)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sets = mdd.pickle_splits(build, splits, DEMO_N)
    pickle_s = time.perf_counter() - t0
    rows = {split: len(ds) for split, ds in sets.items()}
    if rows != {split: len(labels) for split, labels in splits.items()}:
        raise AssertionError(f"pickled rows {rows}")
    buckets = {split: {f"{h}x{w}": len(i) for (w, h), i in ds.sizes.items()}
               for split, ds in sets.items()}
    log(f"[tools] demo build: {DEMO_N} --realistic equations (seed {DEMO_SEED}), rows {rows}, "
        f"buckets {buckets}, max_seq_len {sets['train'].max_seq_len}; written in {write_s:.2f} "
        f"s, pickled in {pickle_s:.2f} s")

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
    return {"build": build, "rows": rows, "buckets": buckets, "write_s": write_s,
            "pickle_s": pickle_s, "partial_take": took}


def remat_steps(fa, config, train_set) -> dict:
    """Phase 17 (b): one fixed full-canvas batch of DEMO_BATCH through the
    flagship from the same weights, without and with remat: the first two
    steps' losses, the flash launches of each step, the synchronised step
    time (median of REMAT_TIMED), the peak memory and a profiled step (device
    time, kernels, busy share) of each."""
    from texocr_tpu_torch.config import ModelConfig, with_defaults
    from texocr_tpu_torch.data.dataset import create_dataloader
    from texocr_tpu_torch.models import OCRModel
    from texocr_tpu_torch.telemetry import step_timer
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
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, launches, times = [], [], []
        for i in range(2 + REMAT_TIMED):
            fa.flash_attention.launches = 0
            timed = {}
            with step_timer(timed, sync=images):
                loss = train_step(state, images, labels)["loss"]
            launches.append(fa.flash_attention.launches)
            (losses if i < 2 else times).append(loss.item() if i < 2 else timed["seconds"])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prof = device_kernels(lambda: train_step(state, images, labels))
        out["remat" if remat else "plain"] = {
            "losses": losses, "launches_per_step": launches, "step_s": float(np.median(times)),
            "peak_memory_gb": peak_gb,
            "profile": {**prof, "device_busy_share": prof["device_s"] / prof["profiled_wall_s"]}}
        log(f"[tools] profiled step {'with' if remat else 'without'} remat: "
            + json.dumps(out["remat" if remat else "plain"]["profile"]))
        del model, state
        torch.cuda.empty_cache()
    return out


def demo_train_run(fa, argv, root, name) -> dict:
    """Runs demo_train's main on ``argv`` with its train_model, test_model and
    graph engines wrapped to record, per run, the flash launches, seconds
    and peak memory of training (with the epochs' records) and of the test
    split's decode (each key's capture and each replay)."""
    from texocr_tpu_torch.evaluation import evaluate
    from texocr_tpu_torch.tools import demo_train
    from texocr_tpu_torch.training import loop

    rec = {"capture_s": [], "replay_s": [], "keys": []}
    metrics = os.path.join(root, f"{name}.jsonl")
    originals = loop.train_model, evaluate.test_model, evaluate.graph_engines

    def train_model(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        model, state, history = originals[0](*args, metrics_path=metrics, **kwargs)
        torch.cuda.synchronize()
        rec.update(train_s=time.perf_counter() - t0, train_launches=fa.flash_attention.launches,
                   train_peak_gb=torch.cuda.max_memory_allocated() / 1e9, steps=state.step)
        return model, state, history

    def test_model(*args, **kwargs):
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        got = originals[1](*args, **kwargs)
        rec.update(test_s=time.perf_counter() - t0, test_launches=fa.flash_attention.launches)
        return got

    def graph_engines(model):
        build = originals[2](model)

        def factory(batch, canvas_hw, max_len, mode, beam_size):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graphed = build(batch, canvas_hw, max_len, mode, beam_size)
            torch.cuda.synchronize()
            rec["capture_s"].append(time.perf_counter() - t0)
            rec["keys"].append([batch, *canvas_hw, max_len, mode])

            def replay(images):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                tokens = graphed(images)
                torch.cuda.synchronize()
                rec["replay_s"].append(time.perf_counter() - t1)
                return tokens

            return replay

        return factory

    loop.train_model, evaluate.test_model, evaluate.graph_engines = (
        train_model, test_model, graph_engines)
    try:
        t0 = time.perf_counter()
        demo_train.main(argv)
        rec["run_s"] = time.perf_counter() - t0
    finally:
        loop.train_model, evaluate.test_model, evaluate.graph_engines = originals
    with open(metrics) as f:
        records = [json.loads(line) for line in f]
    rec["epochs"] = [r for r in records if r["event"] == "train_epoch"]
    rec["val_events"] = sum(r["event"] == "val" for r in records)
    with open(argv[argv.index("--metrics_out") + 1]) as f:
        rec["metrics"] = json.load(f)
    return rec


def time_demo_shape(fa, gen) -> dict:
    """Phase 3 at DEMO_SHAPE (bfloat16, split-head, CUDA-graph replays,
    L2-warm and cold): the kernel against its plain version, and its time
    beside the bound, the plain version and scaled_dot_product_attention."""
    b, h, n, dh = DEMO_SHAPE
    q, k, v = (split_heads(gen, b, h, n, dh, torch.bfloat16) for _ in range(3))
    scale = dh ** -0.5
    err, tol, note = hold_bf16(fa, fa.flash_attention(q, k, v, scale=scale),
                               fa.flash_attention_plain(q, k, v, scale=scale), q, k, v, scale)
    log(f"[tools] flash_attention bf16 {DEMO_SHAPE} split-head, kernel vs plain: {note} "
        f"{'ok' if err <= tol else 'FAIL'}")
    if not err <= tol:
        raise AssertionError("flash attention kernel disagrees with its plain version")
    bound, bound_by = attention_bound_ms(q, k)
    calls = {"ms": lambda: fa.flash_attention(q, k, v, scale=scale),
             "plain_ms": lambda: fa.flash_attention_plain(q, k, v, scale=scale),
             "library_ms": lambda: torch.nn.functional.scaled_dot_product_attention(
                 q, k, v, scale=scale)}
    row = {"shape": list(DEMO_SHAPE), "max_abs_err": err, "bound_ms": bound,
           "bound_by": bound_by}
    for key, fn in calls.items():
        iters = 5 if key == "plain_ms" else 30
        row[key] = time_ms(fn, iters=iters)
        row[key + "_l2_cold"] = time_ms(fn, iters=iters, cold=True)
    log(f"[tools] flash_attention bf16 {DEMO_SHAPE} split-head timing: " + json.dumps(row))
    return row


def tools_phase(fa, rng, gen) -> dict:
    """Phase 17: the data tools and demo_train on the card (see the module
    docstring)."""
    from texocr_tpu_torch.data.dataset import ImageDataset
    from texocr_tpu_torch.tools import demo_train, train_curriculum

    card = card_line()
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
            fa, demo_train.build_config(demo_train.parse_args(argvs["plain"])), train_set)
        rel = max(abs(a - b) / abs(b) for a, b in zip(steps["remat"]["losses"],
                                                      steps["plain"]["losses"]))
        per_step = {k: sorted(set(r["launches_per_step"])) for k, r in steps.items()}
        ok = rel <= BF16_FLOOR and per_step == {"plain": [N_LAYERS], "remat": [2 * N_LAYERS]}
        log(f"[tools] fixed batch of {DEMO_BATCH} full canvases, the flagship from one seed: "
            f"losses of two steps without remat {steps['plain']['losses']}, with remat "
            f"{steps['remat']['losses']}, max relative difference {rel:.3e} (tol "
            f"{BF16_FLOOR:g}); flash launches per step {per_step} (expected {N_LAYERS} and "
            f"{2 * N_LAYERS}: remat recomputes each encoder sub-layer's forward); step s "
            f"{steps['plain']['step_s']:.4f} without, {steps['remat']['step_s']:.4f} with "
            f"remat; peak memory {steps['plain']['peak_memory_gb']:.2f} GB without, "
            f"{steps['remat']['peak_memory_gb']:.2f} GB with; {card} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("remat changes the loss or the launches per step")

        for name, argv in argvs.items():
            run = demo_train_run(fa, argv, root, name)
            expected = 2 * N_LAYERS if name == "remat" else N_LAYERS
            train_per_step = (run["train_launches"] - N_LAYERS * run["val_events"]) / run["steps"]
            decodes = run["metrics"]["batches"] + len(run["keys"])
            losses = [r["loss"] for r in run["epochs"]]
            step_s = [r["seconds"] / r["steps"] for r in run["epochs"]]
            ok = (train_per_step == expected and run["test_launches"] == N_LAYERS * decodes
                  and set(run["metrics"]) == METRICS_KEYS and run["metrics"]["batches"] == 2
                  and np.isfinite(losses).all() and len(losses) == 2)
            log(f"[tools] demo_train {name} ({' '.join(argv[argv.index('--device') + 2:])}): "
                f"{run['steps']} train steps, epoch losses {losses}, epoch s "
                f"{[round(r['seconds'], 3) for r in run['epochs']]} ({np.median(step_s):.4f} s "
                f"a step, median over epochs, data included), train_model {run['train_s']:.1f} "
                f"s, peak memory {run['train_peak_gb']:.2f} GB; flash launches {run['train_launches']} "
                f"in training ({train_per_step:g} a train step with {run['val_events']} val "
                f"steps, expected {expected}), {run['test_launches']} in test_model for "
                f"{decodes} encodes; test split keys {run['keys']}, capture s "
                f"{[round(t, 3) for t in run['capture_s']]}, replay s "
                f"{[round(t, 4) for t in run['replay_s']]}, test_model {run['test_s']:.1f} s; "
                f"metrics keys {sorted(run['metrics'])}; {card} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"demo_train {name} failed its checks")
            run["step_s_median"] = float(np.median(step_s))
            run["train_launches_per_step"] = train_per_step
            run["encodes"] = decodes
            out[name] = run

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
    out["shape"] = time_demo_shape(fa, gen)
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


def orbax_phase(fa, trained, device="cuda") -> dict:
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
    t0 = time.perf_counter()
    params = convert.jax_from_state_dict(state["model"])
    opt_state = convert.jax_opt_state(state["optimizer"], keys, config["optimizer"],
                                      config["optimizer_args"])
    to_jax_s = time.perf_counter() - t0
    mb = {name: sum(np.asarray(v).nbytes for _, v in leaves(tree) if v is not None) / 1e6
          for name, tree in (("params", params), ("opt_state", opt_state))}
    t0 = time.perf_counter()
    jax_ckpt = orbax.save_checkpoint(jax_dir, state["epoch"], params, opt_state,
                                     extra={"step": state["step"]})
    write_s = time.perf_counter() - t0
    disk_mb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(jax_ckpt)
                  for f in fs) / 1e6
    del params, opt_state
    t0 = time.perf_counter()
    tree = orbax.load_checkpoint(jax_ckpt)
    read_s = time.perf_counter() - t0
    del tree
    t0 = time.perf_counter()
    back = io.load_checkpoint(jax_ckpt)
    load_s = time.perf_counter() - t0
    mesh = create_mesh()
    numbered = shard_optimizer_state(back["optimizer"], keys, mesh)["optimizer"]["state"]
    saved = state["optimizer"]["optimizer"]["state"]
    bad = (tree_mismatches(back["model"], state["model"])
           + tree_mismatches({str(k): v for k, v in numbered.items()},
                             {str(k): v for k, v in saved.items()})
           + [k for k in ("epoch", "step") if back[k] != state[k]])
    total_mb = mb["params"] + mb["opt_state"]
    log(f"[orbax] (b) {src} (state.pt) in the JAX layout: params {mb['params']:.1f} MB, Adam "
        f"moments {mb['opt_state']:.1f} MB ({disk_mb:.1f} MB on disk); conversion "
        f"{to_jax_s:.3f} s, orbax write {write_s:.3f} s ({total_mb / write_s:.1f} MB/s), read "
        f"{read_s:.3f} s ({total_mb / read_s:.1f} MB/s), read and converted to the port's "
        f"payload {load_s:.3f} s; "
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
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        _, st, history = train_model(train_set, val_set, run, verbose=False, device=device,
                                     metrics_path=metrics)
        seconds = time.perf_counter() - t0
        launches = fa.flash_attention.launches
        with open(metrics) as f:
            records = [json.loads(line) for line in f]
        epoch = next(r for r in records if r["event"] == "train_epoch")
        epoch["steps"] = int(epoch["steps"])
        val = [r["loss"] for r in records if r["event"] == "val"]
        n_val = len(val)
        resumed[name] = {"losses": history, "val": val, "seconds": seconds,
                         "launches": launches, "steps": epoch["steps"], "step": st.step,
                         "step_s": epoch["seconds"] / epoch["steps"]}
        log(f"[orbax] resume from the {name}: epoch {TRAIN_EPOCHS + 1} of {epoch['steps']} "
            f"steps from step {st.step - epoch['steps']}, loss {history}, val {val}, "
            f"{seconds:.2f} s ({resumed[name]['step_s']:.4f} s a step over the epoch); flash "
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
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        tokens = engine.generate_batch(batch, max_len=DECODE_STEPS)
        if device == "cuda":
            torch.cuda.synchronize()
        served[name] = {"tokens": tokens.cpu().numpy(), "seconds": time.perf_counter() - t0,
                        "launches": fa.flash_attention.launches}
        del engine
        torch.cuda.empty_cache()
        log(f"[orbax] serve from the {name}: batch {BATCH} x {tokens.shape[1]} tokens (max_len "
            f"{DECODE_STEPS} within the checkpoint's positional table) "
            f"{served[name]['seconds']:.3f} s (graph replay), flash launches "
            f"{served[name]['launches']}")
        if served[name]["launches"] != N_LAYERS:
            raise AssertionError(f"serve from the {name}: {served[name]['launches']} flash "
                                 "launches for one encode")
    equal = np.array_equal(served["jax layout"]["tokens"], served["state.pt"]["tokens"])
    log(f"[orbax] serve: tokens from the JAX layout {'bit-equal to' if equal else 'DIFFER from'}"
        f" state.pt's ({served['state.pt']['tokens'].shape})")
    if not equal:
        raise AssertionError("TexOCR from the JAX layout gives other tokens than from state.pt")
    return {"fixture_leaves": n_leaves, "params_mb": mb["params"],
            "opt_state_mb": mb["opt_state"], "disk_mb": disk_mb, "to_jax_s": to_jax_s,
            "write_s": write_s, "read_s": read_s, "load_s": load_s,
            "write_mb_s": total_mb / write_s, "read_mb_s": total_mb / read_s,
            "resume": {k: {x: v[x] for x in ("losses", "val", "seconds", "launches", "steps",
                                             "step_s")} for k, v in resumed.items()},
            "resume_bit_equal": same, "resume_max_rel": rel,
            "serve": {k: {"seconds": v["seconds"], "launches": v["launches"]}
                      for k, v in served.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from texocr_tpu_torch.ops import build
    from texocr_tpu_torch.ops import flash_attention as fa

    card = card_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    library, build_log = build.build(fa.SOURCE)
    log(f"[build] {fa.SOURCE} built in {time.perf_counter() - t0:.1f} s")
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

    phase_s = {"build": time.perf_counter() - t0}
    launch_log = LaunchLog(fa)

    def phase(name, fn, *args):
        t = time.perf_counter()
        launch_log.phase = name
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    errors = phase("kernels", check_flash_kernel, fa, gen)
    timings = phase("kernel timing", time_flash, fa, gen)
    rank_rows = phase("rank shape timing", time_rank_shapes, fa, gen)
    f32_launches = phase("golden", check_golden, fa)
    rng = np.random.default_rng(0)
    served = phase("serve", serve, fa, rng)
    profiled = phase("profile", profile_serving, served["engine"], served["batch"])
    graphed = phase("graphs", graphs_phase, fa, served["engine"], served["batch"], profiled)
    del served["engine"]
    encode_err = phase("encoder", check_encoder_paths, rng)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    trained = phase("train", train, fa, rng, os.path.join(work, "phase8"))
    train_row = phase("train timing", time_train_attention, fa, gen)
    resident = phase("device data", device_data_phase, fa, rng)
    paths = {"int8": phase("int8", int8_phase, fa, served["batch"]),
             "sample": phase("sample", sample_phase, fa, served["batch"]),
             "beam": phase("beam", beam_phase, fa, served["batch"]),
             "http": phase("http", http_phase, fa, rng)}
    evaluated = phase("eval", eval_phase, fa, rng)
    paths.update({f"eval {mode}": r for mode, r in evaluated.items()})
    variants = phase("variants", variants_phase, fa, served["batch"], rng, encode_err)
    paths.update({f"variants {name}": {"launches": r["launches"], "encodes": r["encodes"]}
                  for name, r in variants.items()})
    paths.update({f"graphs {mode}": graphed[mode] for mode in ("greedy", "int8", "beam", "sample")})
    data = phase("data", data_phase, fa, rng)
    paths.update({f"data {kind}": {"launches": data[kind]["launches"],
                                   "encodes": data[kind]["encodes"]} for kind in ("eager", "lazy")})
    parallel = phase("parallel", parallel_phase, fa, trained)
    tools = phase("tools", tools_phase, fa, rng, gen)
    interchange = phase("orbax", orbax_phase, fa, trained)
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
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "ms_l2_cold", "plain_ms_l2_cold", "library_ms_l2_cold")},
            shapes=timings[dtype],
        ))
    kernels[0].update(train_launches_per_step=trained["launches_per_step"],
                      train_launches=trained["launches"], train_shape=train_row,
                      device_data_launches=resident["launches"],
                      device_data_launches_per_step=resident["launches_per_step"],
                      launches_per_path={name: {"launches": r["launches"], "encodes": r["encodes"]}
                                         for name, r in paths.items()},
                      rank_shapes=rank_rows,
                      parallel_launches={k: v for k, v in parallel["launches"].items()
                                         if "decode" not in k})
    kernels[0].update(tools_launches={name: {
        key: tools[name][key] for key in ("train_launches", "train_launches_per_step", "steps",
                                          "val_events", "test_launches", "encodes")}
        for name in ("plain", "remat")},
        tools_fixed_batch_launches_per_step={name: r["launches_per_step"]
                                             for name, r in tools["steps"].items()},
        tools_shape=tools["shape"])
    kernels[1].update(parallel_launches={k: v for k, v in parallel["launches"].items()
                                         if "decode" in k})
    kernels[0].update(orbax_launches={
        **{f"resume from the {k}": {"launches": v["launches"], "train_steps": v["steps"]}
           for k, v in interchange["resume"].items()},
        **{f"serve from the {k}": {"launches": v["launches"], "encodes": 1}
           for k, v in interchange["serve"].items()}})
    log(json.dumps({"kernels": kernels}))
    log(f"[serve] median per-request s {served['request_s']}, batch img/s "
        f"{BATCH / served['batch_s']} on {card}")
    log(f"[decode] batch {BATCH} x {DECODE_STEPS} tokens on {card}, wall s eager and graph: "
        + json.dumps({mode: [graphed[mode]["eager"]["wall_s"], graphed[mode]["graph"]["wall_s"]]
                      for mode in ("greedy", "int8", "sample", "beam")})
        + f"; encode wall s {graphed['encode']['eager']['wall_s']} and "
        f"{graphed['encode']['graph']['wall_s']}; http p50 {paths['http']['p50_s']} s, "
        f"p99 {paths['http']['p99_s']} s")
    log(f"[train] step s {trained['step_s']}, {trained['images_per_s_full']} images/s at "
        f"(160, 1008), peak memory {trained['peak_memory_gb']} GB on {card}")
    log(f"[device data] epoch s {[r['seconds'] for r in resident['epochs']]} against the host "
        f"loader's {[r['seconds'] for r in resident['host_epochs']]}, step "
        f"{resident['step_s']['median']} s, peak memory {resident['peak_memory_gb']} GB; "
        f"50k resident rows: " + json.dumps(resident["resident"]) + f" on {card}")
    log(f"[variants] encode and decode wall s (graph replays, batch {BATCH} x {DECODE_STEPS} "
        f"tokens): " + json.dumps({name: [variants[name]["encode_s"], variants[name]["decode_s"]]
                                   for name in ("patch", "glu false")})
        + f"; no cross train step s {variants['no cross']['step_s']}, peak memory "
        f"{variants['no cross']['peak_memory_gb']} GB; maps replay "
        f"{variants['maps replay']['seconds']} s, tool {variants['maps tool']['seconds']} s "
        f"on {card}")
    log(f"[data] native encode_batch {data['tokenizer']['labels_per_s']['native']:.0f} labels/s, "
        f"pure Python {data['tokenizer']['labels_per_s']['python']:.0f} on {host_cpu()}; "
        f"epoch wall s eager {data['eager']['epoch_s']:.3f}, lazy {data['lazy']['epoch_s']:.3f} "
        f"on {card}")
    world1 = parallel["world1"]
    log(f"[parallel] (a) NCCL world of 1: step {world1['step_s_median']} s against phase 8's "
        f"{world1['phase8_step_s_median']} s, gradient all-reduce {world1['grad_bytes']} bytes "
        f"in {world1['grad_all_reduce_ms']} ms; (b) peak memory per rank GB "
        + json.dumps({axis: [r[axis]["peak_memory_gb"] for r in parallel["ranks"]]
                      for axis in PARALLEL_BATCHES})
        + f"; seconds {parallel['seconds']} on {card}")
    log(f"[tools] batch {DEMO_BATCH} full-canvas step s without and with remat "
        f"{tools['steps']['plain']['step_s']:.4f}, {tools['steps']['remat']['step_s']:.4f}, peak "
        f"memory GB {tools['steps']['plain']['peak_memory_gb']:.2f}, "
        f"{tools['steps']['remat']['peak_memory_gb']:.2f}; demo_train step s (epoch means) "
        f"{tools['plain']['step_s_median']:.4f}, {tools['remat']['step_s_median']:.4f}; "
        f"flash bf16 {DEMO_SHAPE} {tools['shape']['ms']:.5f} ms against the library's "
        f"{tools['shape']['library_ms']:.5f} on {card}")
    log(f"[orbax] flagship checkpoint in the JAX layout ({interchange['params_mb']:.1f} MB "
        f"params, {interchange['opt_state_mb']:.1f} MB moments): write "
        f"{interchange['write_s']:.3f} s ({interchange['write_mb_s']:.1f} MB/s), read "
        f"{interchange['read_s']:.3f} s ({interchange['read_mb_s']:.1f} MB/s), resumed step s "
        + json.dumps({k: v["step_s"] for k, v in interchange["resume"].items()})
        + f", resume losses bit-equal {interchange['resume_bit_equal']} on {card}")
    log(card_line())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
