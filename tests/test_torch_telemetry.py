"""The port's spans and counters (``texocr_tpu_torch.telemetry``) on the CPU at
a tiny size: the profiler's gate and clock, nesting, and the spans and
counters at the decode loop, the training step and the micro-batcher, with
the numbers those paths give bit-equal with and without a profile running."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from texocr_tpu_torch import telemetry
from texocr_tpu_torch.config import ModelConfig
from texocr_tpu_torch.data.dataset import ImageDataset
from texocr_tpu_torch.evaluation.evaluate import GraphCache
from texocr_tpu_torch.models import OCRModel
from texocr_tpu_torch.models.attention import decode_chunks
from texocr_tpu_torch.serving import TexOCR
from texocr_tpu_torch.serving.batcher import ServingBatcher
from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH
from texocr_tpu_torch.training.device_data import DeviceResidentData, make_chunk_train_step
from texocr_tpu_torch.training.optimizers import get_optimizer
from texocr_tpu_torch.training.train_step import create_train_state

torch.set_num_threads(1)

CONFIG = {
    "img_size": (32, 128), "patch_size": 16, "vocab_size": 1000, "max_length": 80,
    "glu": True, "bos_token": 998, "eos_token": 997, "trg_pad_idx": 999,
    "dtype": "float32", "use_flash_attention": False, "seed": 5,
    "tokenizer_path": DEFAULT_VOCAB_PATH,
    "encoder": {"n_channels": 1, "embed_dim": 32, "num_layers": 1, "heads": 2,
                "resnet_depths": (1, 1, 1), "resnet_channels": (128, 128, 128),
                "stem_channels": 32},
    "decoder": {"embed_dim": 32, "num_layers": 1, "heads": 2, "cross_attend": True,
                "dropout": 0.1, "exp_factor": 4},
}
MAX_LEN = 70  # three chunks of at most 32 steps


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def fresh_record():
    telemetry.reset()
    yield
    telemetry.reset()


def names():
    return [s.name for s in telemetry.spans()]


def test_no_profile_records_nothing_and_returns_the_shared_noop():
    a = telemetry.span("a", device=torch.zeros(1))
    b = telemetry.span("b")
    assert a is b
    with a:
        with telemetry.span("inner"):
            pass
    assert telemetry.spans() == []


def test_a_thread_that_is_not_profiling_stays_off():
    seen, started, release = {}, threading.Event(), threading.Event()

    def other():
        started.wait(timeout=30)
        with telemetry.span("other") as s:
            seen["ctx"] = s
        release.set()

    thread = threading.Thread(target=other)
    thread.start()
    with cpu_profile():
        with telemetry.span("main"):
            started.set()
            assert release.wait(timeout=30)
    thread.join(timeout=30)
    assert not thread.is_alive()
    assert seen["ctx"] is None  # nullcontext yields None
    assert names() == ["main"]


def within(inner, outer):
    return outer[1] <= inner[1] <= inner[2] <= outer[2]


def twins(prof, names):
    """The profile's events named ``names``: (name, start ns, end ns), in
    the order they started."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events() if e.name() in names),
                  key=lambda t: t[1])


def test_spans_nest_in_the_profile():
    with cpu_profile() as prof:
        with telemetry.span("outer"):
            with telemetry.span("mid"):
                with telemetry.span("leaf"):
                    torch.ones(4).add_(1)
            with telemetry.span("second"):
                pass
    assert names() == ["outer", "mid", "leaf", "second"]
    outer, mid, leaf, second = twins(prof, set(names()))
    assert [outer[0], mid[0], leaf[0], second[0]] == names()
    assert within(mid, outer) and within(leaf, mid) and within(second, outer)
    assert mid[2] <= second[1]
    assert all(s.device_ms is None for s in telemetry.spans())


def test_each_span_holds_the_counters_from_when_it_opened():
    telemetry.count("calls", 2)
    with cpu_profile() as prof:
        for i in range(3):
            with telemetry.span("step"):
                torch.ones(64, 64).sum()
            telemetry.count("calls")
    assert [s.counters for s in telemetry.spans()] == [{"calls": 2}, {"calls": 3}, {"calls": 4}]
    assert len(twins(prof, {"step"})) == 3


class _State:
    """A decode state of ``n_chunks`` whose rows are all done after chunk
    ``done_after``."""

    def __init__(self, n_chunks, done_after):
        self.n_chunks, self.done_after = n_chunks, done_after
        self.done = torch.zeros(2, dtype=torch.bool)
        self.ran = []

    def run_chunk(self, c):
        self.ran.append(c)
        if c >= self.done_after:
            self.done[:] = True


@pytest.mark.parametrize("n_chunks,done_after,ran,checks",
                         [(3, 9, [0, 1, 2], 2), (4, 1, [0, 1], 2), (1, 0, [0], 0)])
def test_decode_chunks_spans_each_chunk_and_each_flag_read(n_chunks, done_after, ran, checks):
    state = _State(n_chunks, done_after)
    with cpu_profile():
        decode_chunks(state, state.run_chunk)
    assert state.ran == ran
    assert names() == (["decode.chunk", "decode.check"] * len(ran))[:len(ran) + checks]


def _engine():
    return TexOCR(CONFIG, device="cpu")


def _canvases(rng, n):
    img = np.full((n, 32, 128, 1), 255, np.uint8)
    img[:, 8:24, 10:100, 0] = rng.integers(0, 256, (n, 16, 90), dtype=np.uint8)
    return img


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_eager_decode_under_a_profile_is_bit_equal_and_spanned(mode):
    engine = _engine()
    batch = _canvases(np.random.default_rng(0), 3)
    plain = engine.generate_batch(batch, max_len=MAX_LEN, mode=mode, beam_size=2)
    assert telemetry.spans() == []
    with cpu_profile() as prof:
        traced = engine.generate_batch(batch, max_len=MAX_LEN, mode=mode, beam_size=2)
    assert torch.equal(plain, traced)
    # No row ends before MAX_LEN (these weights): three chunks, a read of
    # the flags after each but the last, inside the engine's call.
    assert names() == ["engine.call", "decode.chunk", "decode.check", "decode.chunk",
                       "decode.check", "decode.chunk"]
    call, *steps = twins(prof, set(names()))
    assert call[0] == "engine.call" and all(within(t, call) for t in steps)
    assert all(s.device_ms is None for s in telemetry.spans())


def _train_setup():
    rng = np.random.default_rng(3)
    images, tokens = [], []
    for _ in range(6):
        img = np.full((32, 64), 255, np.uint8)
        img[rng.integers(0, 32, 40), rng.integers(0, 64, 40)] = 0
        images.append(img)
        tokens.append(rng.integers(0, 900, rng.integers(3, 12)).tolist())
    ds = ImageDataset.from_arrays(images, tokens, tokenizer_path=DEFAULT_VOCAB_PATH)
    data = DeviceResidentData.from_dataset(ds, seq_pad_multiple=8, device="cpu")
    (bucket,) = data.buckets.values()
    return bucket


def _train(bucket, traced: bool):
    model = OCRModel(ModelConfig.from_dict(CONFIG), device="cpu", seed=7)
    state = create_train_state(model, get_optimizer("Adam", {"lr": 1e-3}, model.parameters()),
                               seed=11)
    run = make_chunk_train_step(2, augment=True)
    perm = torch.arange(bucket.n)
    prof = None
    if traced:
        with cpu_profile() as prof:
            metrics = run(state, bucket, perm, 2, 0)
    else:
        metrics = run(state, bucket, perm, 2, 0)
    return metrics, {n: p.detach().clone() for n, p in model.named_parameters()}, prof


def test_training_steps_under_a_profile_are_bit_equal_and_phased():
    bucket = _train_setup()
    plain, plain_params, _ = _train(bucket, traced=False)
    assert telemetry.spans() == []
    traced, traced_params, prof = _train(bucket, traced=True)
    assert torch.equal(plain["loss"], traced["loss"])
    assert torch.equal(plain["token_acc"], traced["token_acc"])
    assert all(torch.equal(plain_params[n], traced_params[n]) for n in plain_params)
    phases = [n for n in names() if n.startswith("train.")]
    assert phases == ["train.forward", "train.backward", "train.optimizer"] * 2
    steps = twins(prof, set(phases))
    assert [t[0] for t in steps] == phases
    assert all(a[2] <= b[1] for a, b in zip(steps, steps[1:]))  # no overlap


def _serve_six(engine, start_profile_at=None):
    """Six requests through a batcher whose engine's ``generate_batch`` is
    wrapped the benchmark's way: on the worker, it counts each call's real
    rows and, at call ``start_profile_at``, starts a profile that it stops
    at the start of the next call. Returns those counts."""
    gate, entered = threading.Event(), threading.Event()
    fills, inner = [], engine.generate_batch
    prof = cpu_profile()

    def generate_batch(images, **kw):
        if len(fills) == start_profile_at:
            prof.start()
        elif start_profile_at is not None and len(fills) == start_profile_at + 1:
            prof.stop()
        entered.set()
        assert gate.wait(timeout=60)
        fills.append(int((np.asarray(images).reshape(len(images), -1).max(axis=1) > 0).sum()))
        return inner(images, **kw)

    engine.generate_batch = generate_batch
    batcher = ServingBatcher(engine, max_batch=4, max_wait_ms=50.0, max_len=6,
                             batch_sizes=(1, 4))
    rng = np.random.default_rng(1)
    small = rng.integers(0, 200, (20, 60), dtype=np.uint8)
    large = rng.integers(0, 200, (30, 120), dtype=np.uint8)
    try:
        futures = [batcher.submit(small)]
        assert entered.wait(timeout=60)  # the worker holds the first group
        futures += [batcher.submit(im) for im in (small, small, small, large, large)]
        gate.set()
        for f in futures:
            f.result(timeout=120)
    finally:
        batcher.shutdown()
    # Calls: the first request alone; a drain of 4 (3 small padded to 4, 1
    # large); the last large request alone.
    assert fills == [1, 3, 1, 1]
    return fills


def test_batcher_counters_match_a_harness_style_count():
    fills = _serve_six(_engine())
    got = telemetry.counters()
    assert got["batcher.rows"] == sum(fills) == 6
    assert got["batcher.groups"] == len(fills) == 4
    assert got["batcher.rows"] / got["batcher.groups"] == sum(fills) / len(fills)
    # The drain's five requests waited out the first call at least.
    assert got["batcher.wait_s"] > 0 and got["batcher.service_s"] > 0
    assert telemetry.spans() == []


def test_a_profiles_first_span_holds_the_counts_from_before_it():
    fills = _serve_six(_engine(), start_profile_at=2)
    first = telemetry.spans()[0]
    assert first.name == "engine.call"  # the third call's, inside the benchmark's wrapper
    assert first.counters["batcher.groups"] == 2
    assert first.counters["batcher.rows"] == sum(fills[:2])
    assert 0 < first.counters["batcher.wait_s"] < telemetry.counters()["batcher.wait_s"]
    assert telemetry.counters()["batcher.groups"] == 4


def test_batcher_warmup_counts_nothing():
    batcher = ServingBatcher(_engine(), max_batch=2, max_len=4)
    try:
        batcher.warmup([(32, 128)])
    finally:
        batcher.shutdown()
    assert not any(k.startswith("batcher.") for k in telemetry.counters())


def test_count_adds_and_reset_forgets():
    telemetry.count("a")
    telemetry.count("a", 2)
    telemetry.count("b", 0.5)
    telemetry.count("b", 0.25)
    assert telemetry.counters() == {"a": 3, "b": 0.75}
    with pytest.raises(TypeError):
        telemetry.count("a", "1")
    with cpu_profile():
        with telemetry.span("s"):
            pass
    assert len(telemetry.spans()) == 1
    telemetry.reset()
    assert telemetry.counters() == {} and telemetry.spans() == []


def test_deferred_holds_this_threads_counts_in_its_dict():
    telemetry.count("a")
    with telemetry.deferred() as held:
        telemetry.count("a", 2)
        telemetry.count("flash_attention.launches", 4)
    assert held == {"a": 2, "flash_attention.launches": 4}
    assert telemetry.counters() == {"a": 1}


def test_deferred_leaves_other_threads_counting_directly():
    done = threading.Event()

    def other():
        telemetry.count("batcher.rows", 3)
        done.set()

    with telemetry.deferred() as held:
        thread = threading.Thread(target=other)
        thread.start()
        assert done.wait(timeout=30)
        thread.join(timeout=30)
    assert held == {} and telemetry.counters() == {"batcher.rows": 3}


def test_after_deferred_counting_is_direct_again():
    with pytest.raises(RuntimeError):
        with telemetry.deferred():
            telemetry.count("a")
            raise RuntimeError("the block fails")
    telemetry.count("a", 5)
    assert telemetry.counters() == {"a": 5}


def test_a_graph_replay_adds_its_captures_counts_once():
    """``GraphedGenerate`` keeps each graph with the counts its capture held
    back and adds them at every replay (a stub graph: no CUDA here)."""
    from texocr_tpu_torch.models.graphed import GraphedGenerate

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    with telemetry.deferred() as held:
        telemetry.count("decode_attention.launches", 8)
        telemetry.count("moe.layers", 2)
    entry = (Graph(), held)
    for _ in range(3):
        GraphedGenerate._replay(entry)
    assert Graph.replays == 3
    assert telemetry.counters() == {"decode_attention.launches": 24, "moe.layers": 6}


def test_a_device_counter_made_under_inference_mode_adds_and_resets_in_place():
    """A decode under ``inference_mode`` may be the first to ask for a device
    counter; ``reset`` after it, outside that mode, still zeroes the same
    tensor (graphs that captured its adds keep its address)."""
    with torch.inference_mode():
        counts = telemetry.device_counter("t.rows", (2, 3), "cpu")
        counts[1].add_(torch.tensor([1, 0, 2]))
    assert telemetry.device_counter("t.rows", (2, 3), "cpu") is counts
    assert telemetry.device_counters()["t.rows"].tolist() == [[0, 0, 0], [1, 0, 2]]
    telemetry.reset()
    assert telemetry.device_counter("t.rows", (2, 3), "cpu") is counts
    assert counts.tolist() == [[0, 0, 0], [0, 0, 0]]


def test_graph_cache_prints_the_engines_capture_time(capsys):
    class Engine:
        capture_s = 1.25

        def __call__(self, images):
            return images

    cache = GraphCache(lambda *key: Engine(), verbose=True)
    cache(torch.zeros(2, 8, 16, 1), max_len=4, mode="greedy", beam_size=1)
    assert "captured in 1.25 s" in capsys.readouterr().out
    # Any callable is an engine; one without a capture time is said to be built.
    cache = GraphCache(lambda *key: (lambda images: images), verbose=True)
    cache(torch.zeros(2, 8, 16, 1), max_len=4, mode="greedy", beam_size=1)
    assert ": built (1 held, 1 built)" in capsys.readouterr().out
