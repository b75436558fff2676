"""The generator: seeded, reproducible, and the mixes as their files state."""

import collections
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import traffic

MIXES = Path(__file__).parents[1] / "traffic"
BIG = 2 ** 31 + 12345


def mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


def canvas_class(img):
    return "small" if img.shape[0] <= 64 else "large"


def test_open_loop_is_reproducible_and_seeded():
    m = mix("serve_open")
    a, b = traffic.open_loop(m, BIG, 10), traffic.open_loop(m, BIG, 10)
    assert [r["t"] for r in a] == [r["t"] for r in b]
    assert all(np.array_equal(x["image"], y["image"]) for x, y in zip(a, b))
    # Another seed: the same queue (send times, canvas order), other images.
    c = traffic.open_loop(m, BIG + 1, 10)
    assert [r["t"] for r in a] == [r["t"] for r in c]
    assert [canvas_class(x["image"]) for x in a] == [canvas_class(x["image"]) for x in c]
    assert not all(np.array_equal(x["image"], y["image"]) for x, y in zip(a, c))
    # Another schedule: another queue.
    d = traffic.open_loop(dict(m, schedule_seed=m["schedule_seed"] + 1), BIG, 10)
    assert [r["t"] for r in a] != [r["t"] for r in d]


@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 40 + 3])
def test_open_loop_rate_and_size_mix(seed):
    m = mix("serve_open")
    seconds = 30
    reqs = traffic.open_loop(m, seed, seconds)
    assert len(reqs) == round(m["rate_per_s"] * seconds)
    times = np.array([r["t"] for r in reqs])
    assert times[0] == 0 and np.all(np.diff(times) >= 0) and times[-1] < seconds
    counts = collections.Counter(canvas_class(r["image"]) for r in reqs)
    assert counts == {"small": round(0.6 * len(reqs)), "large": round(0.4 * len(reqs))}
    for r in reqs:
        h, w = r["image"].shape
        assert (49 <= h <= 64 and 449 <= w <= 512) or (145 <= h <= 160 and 961 <= w <= 1008)
        assert r["image"].dtype == np.uint8 and r["image"].max() == 255
    # Exponential gaps: their mean is the rate's inverse, their spread too.
    gaps = np.diff(times)
    assert np.mean(gaps) == pytest.approx(1 / m["rate_per_s"], rel=0.02)
    assert np.std(gaps) == pytest.approx(1 / m["rate_per_s"], rel=0.15)


def test_every_schedule_gets_the_same_gaps_in_another_order():
    m = mix("serve_open")
    a = np.sort(np.diff([r["t"] for r in traffic.open_loop(m, 1, 30)]))
    b = np.sort(np.diff([r["t"] for r in traffic.open_loop(dict(m, schedule_seed=5), 2, 30)]))
    assert np.allclose(a, b, rtol=0.05, atol=1e-3)


def test_training_rows_mix_and_lengths():
    m = dict(mix("train_resident"), rows=256)
    images, labels = traffic.training_rows(m, BIG, 997, "cpu")
    again, labels2 = traffic.training_rows(m, BIG, 997, "cpu")
    assert labels == labels2 and all(np.array_equal(x, y) for x, y in zip(images, again))
    shapes = collections.Counter(im.shape for im in images)
    assert shapes == {(160, 1008): 224, (96, 1008): 32}
    lengths = sorted(len(t) for t in labels)
    other = sorted(len(t) for t in traffic.training_rows(m, 5, 997, "cpu")[1])
    assert lengths == other
    assert lengths[0] >= 8 and lengths[-1] == 350
    assert 40 <= lengths[len(lengths) // 2] <= 56
    assert all(0 <= t < 997 for row in labels for t in row)


def test_ink_batch_is_seeded_and_inked():
    ink = mix("batch_fixed")["ink"]
    a = traffic.ink_batch(3, 160, 1008, ink, 11, "cpu")
    assert torch.equal(a, traffic.ink_batch(3, 160, 1008, ink, 11, "cpu"))
    assert not torch.equal(a, traffic.ink_batch(3, 160, 1008, ink, 12, "cpu"))
    assert a.shape == (3, 160, 1008) and a.dtype == torch.uint8
    share = (a < 255).float().mean().item()
    assert ink["density"] * 0.8 < share < ink["density"] * 1.2


def test_class_counts_by_largest_remainder():
    classes = [{"share": 0.6}, {"share": 0.4}]
    assert traffic.class_counts(classes, 7) == [4, 3]
    assert traffic.class_counts(classes, 540) == [324, 216]
