"""The one traffic generator: a mix file's parameters and a seed in,
requests, batches or training rows out.

Every seed gets the same multiset of sizes, lengths and gaps, drawn as
quantiles of the mix's distributions, and only their order and the ink
differ: two seeds do the same work in another order.

A mix file (``portbench/traffic/<mix>.json``) names its ``driver`` and the
parameters that driver reads:

- ``classes``: image classes, each ``{"share", "height": [lo, hi],
  "width": [lo, hi]}``; a class's images have sizes uniform in its ranges.
- ``rate_per_s`` and ``schedule_seed``: an open loop's Poisson requests,
  their send times and class order drawn once from ``schedule_seed``.
- ``ink``: ``{"cell", "density", "darkest", "lightest"}``, ink drawn on
  white in square cells of ``cell`` pixels, a cell inked with probability
  ``density`` at a gray level between the two bounds.
- ``label_length``: ``{"median", "sigma", "min", "max"}``, a log-normal
  clipped to [min, max], its largest quantile set to ``max``.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def _words(seed: int, tags) -> list:
    return [int(seed) % 2 ** 64, *(int(t) % 2 ** 64 for t in tags)]


def rng(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator for one stream of the run's seed."""
    return np.random.default_rng(_words(seed, tags))


def torch_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for a torch generator, one per stream of the run's seed."""
    return int(np.random.SeedSequence(_words(seed, tags)).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def quantiles(n: int) -> np.ndarray:
    """n evenly spaced probabilities in (0, 1)."""
    return (np.arange(n) + 0.5) / n


def class_counts(classes: Sequence[dict], n: int) -> List[int]:
    """Rows of each class among n, by largest remainder."""
    raw = [c["share"] * n for c in classes]
    counts = [int(math.floor(r)) for r in raw]
    order = sorted(range(len(raw)), key=lambda i: counts[i] - raw[i])
    for i in order[: n - sum(counts)]:
        counts[i] += 1
    return counts


def sizes(classes: Sequence[dict], n: int, gen: np.random.Generator) -> List[Tuple[int, int]]:
    """n (height, width) pairs, each class's exact count, in a seeded order."""
    out = []
    for c, count in zip(classes, class_counts(classes, n)):
        (h0, h1), (w0, w1) = c["height"], c["width"]
        hs = gen.integers(h0, h1 + 1, count)
        ws = gen.integers(w0, w1 + 1, count)
        out += list(zip(hs.tolist(), ws.tolist()))
    return [out[i] for i in gen.permutation(len(out))]


def ink_image(h: int, w: int, ink: dict, gen: np.random.Generator) -> np.ndarray:
    """One (h, w) uint8 image: white, with inked cells."""
    c = ink["cell"]
    gh, gw = -(-h // c), -(-w // c)
    inked = gen.random((gh, gw)) < ink["density"]
    level = gen.integers(ink["darkest"], ink["lightest"] + 1, (gh, gw), dtype=np.uint8)
    cells = np.where(inked, level, np.uint8(255)).astype(np.uint8)
    return np.repeat(np.repeat(cells, c, axis=0), c, axis=1)[:h, :w]


def ink_batch(n: int, h: int, w: int, ink: dict, seed: int, device) -> torch.Tensor:
    """(n, h, w) uint8 images made on ``device`` from one torch generator:
    what ``ink_image`` draws, in bulk."""
    c = ink["cell"]
    gen = torch.Generator(device=device).manual_seed(seed)
    gh, gw = -(-h // c), -(-w // c)
    inked = torch.rand((n, gh, gw), generator=gen, device=device) < ink["density"]
    level = torch.randint(ink["darkest"], ink["lightest"] + 1, (n, gh, gw), generator=gen,
                          device=device, dtype=torch.uint8)
    cells = torch.where(inked, level, torch.full_like(level, 255))
    return cells.repeat_interleave(c, 1).repeat_interleave(c, 2)[:, :h, :w].contiguous()


def arrival_offsets(rate: float, seconds: float, gen: np.random.Generator) -> np.ndarray:
    """Send times in [0, seconds) of an open loop at ``rate``: round(rate *
    seconds) requests whose gaps are the exponential distribution's
    quantiles in a seeded order, scaled to span the window."""
    n = max(1, round(rate * seconds))
    gaps = -np.log1p(-quantiles(n)) / rate
    gaps = gaps[gen.permutation(n)]
    times = np.cumsum(gaps) - gaps[0]
    return times * (seconds * (1 - 0.5 / n) / max(times[-1], 1e-9)) if n > 1 else times


def open_loop(mix: dict, seed: int, seconds: float) -> List[Dict]:
    """The requests of one window: [{"t": send offset s, "image": uint8
    (h, w)}]. The send times and the order of the classes are the mix's own
    (drawn from its ``schedule_seed``), the same for every run, so that
    every seed meets the same queue; the sizes within each class and the
    ink are the run seed's."""
    schedule = rng(mix["schedule_seed"], 1)
    times = arrival_offsets(mix["rate_per_s"], seconds, schedule)
    classes = mix["classes"]
    order = [i for i, count in enumerate(class_counts(classes, len(times))) for _ in range(count)]
    order = [order[j] for j in schedule.permutation(len(order))]
    gen = rng(seed, 1)
    out = []
    for t, i in zip(times, order):
        (h0, h1), (w0, w1) = classes[i]["height"], classes[i]["width"]
        h, w = int(gen.integers(h0, h1 + 1)), int(gen.integers(w0, w1 + 1))
        out.append({"t": float(t), "image": ink_image(h, w, mix["ink"], gen)})
    return out


def label_lengths(spec: dict, n: int, gen: np.random.Generator) -> np.ndarray:
    """n label lengths: the clipped log-normal's quantiles, the largest set
    to ``max``, in a seeded order."""
    normal = statistics.NormalDist()
    z = np.array([normal.inv_cdf(q) for q in quantiles(n)])
    lengths = np.clip(np.round(spec["median"] * np.exp(spec["sigma"] * z)), spec["min"],
                      spec["max"]).astype(int)
    lengths[-1] = spec["max"]
    return lengths[gen.permutation(n)]


def training_rows(mix: dict, seed: int, vocab_ids: int, device) -> Tuple[List[np.ndarray],
                                                                      List[List[int]]]:
    """The training set of a resident mix: ``rows`` images of the classes'
    sizes, each size's images made in bulk on ``device`` and brought to the
    host, with labels of ``label_length`` tokens uniform in [0, vocab_ids)."""
    n = mix["rows"]
    gen = rng(seed, 2)
    shapes = sizes(mix["classes"], n, gen)
    lengths = label_lengths(mix["label_length"], n, gen)
    labels = [gen.integers(0, vocab_ids, int(L)).tolist() for L in lengths]
    images: List[np.ndarray] = [None] * n
    for h, w in sorted(set(shapes)):
        rows = [i for i, s in enumerate(shapes) if s == (h, w)]
        block = ink_batch(len(rows), h, w, mix["ink"], torch_seed(seed, 3, h, w), device)
        for i, img in zip(rows, block.cpu().numpy()):
            images[i] = img
    return images, labels
