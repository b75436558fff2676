"""Device-resident training data: each shape bucket is uploaded once as
uint8, and batches are picked, unpacked, normalised and augmented on the
device, so a training step needs no host batch.

- ``DeviceResidentData.from_dataset`` stages every (h, w) bucket of an
  ``ImageDataset`` on the device, with the JAX package's knobs
  (``seq_pad_multiple``, ``min_bucket_items``, ``max_canvas``,
  ``size_round``, ``bucket_cap``, ``pack_bits``). Images are copied up in row
  chunks into one preallocated tensor and packed to 4 bits on the device
  chunk by chunk, so the host never holds more than a chunk. Rows keep their
  true width and labels their true length: the TPU package's lane padding
  exists for its gather and has no use here.
- ``plan`` splits one epoch into (bucket, steps, start) calls.
- ``gather_batch`` takes rows on the device and computes the host collator's
  ``1 - u8/255``; for 8-bit buckets it equals ``BatchCollator`` bit for bit.
- ``augment_batch`` is the on-device augmentation: per-sample scale,
  translation and brightness, resampled as
  ``jax.image.scale_and_translate(method="linear")`` does
  (``scale_translate``).
- ``make_chunk_train_step`` and ``make_chunk_eval_step`` run a call's steps.
  The train runner reads rows ``perm[((start + s) * B + j) % n]`` of one
  permutation per (seed, epoch, bucket) (``epoch_permutation``), so the calls
  of an epoch make one pass without replacement whatever the chunking. No
  step reads anything back to the host. On a mesh every rank holds every
  bucket and draws the same permutation, and a step gathers only its data
  rank's ``rows`` of the batch (the augmentation's draws are the whole
  batch's, of which it keeps those rows).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from texocr_tpu_torch.data.dataset import BOS_CHAR, EOS_CHAR, PAD_CHAR, ImageDataset
from texocr_tpu_torch.training.train_step import (
    TrainState,
    make_eval_step,
    seeded_generator,
    update,
)
from texocr_tpu_torch.utils import pad_to_multiple

# Stream tags: the permutation's and the augmentation's generators are seeded
# apart from dropout's (seed, step), as the JAX package folds these tags into
# its keys.
PERM_TAG = 0x5E1EC7
AUGMENT_TAG = 0xA06
# Host bytes staged per upload chunk.
UPLOAD_CHUNK_BYTES = 1 << 28


class DeviceBucket:
    """One (h, w) shape bucket resident on the device.

    ``images`` is uint8 (N, h, w), or with ``pack_bits=4`` (N, h, ceil(w/2))
    holding two horizontally adjacent pixels a byte (the even pixel in the
    high nibble; an odd width is padded with white). ``labels`` is int32
    (N, L) of BOS, tokens, EOS, PAD rows. N may exceed ``n``, the real row
    count: ``size_round`` repeats rows to fill it, and they are never drawn.
    """

    def __init__(self, images: torch.Tensor, labels: torch.Tensor, n: int, true_w: int,
                 pack_bits: int = 8):
        self.images = images
        self.labels = labels
        self.n = n
        self.true_w = true_w
        self.pack_bits = pack_bits

    @property
    def shape(self) -> Tuple[int, int]:
        return self.images.shape[1], self.true_w

    @property
    def seq_len(self) -> int:
        return self.labels.shape[1]


def _pack_labels(token_ids: Sequence[List[int]], pad: int, bos: int, eos: int,
                 seq_pad_multiple: int) -> np.ndarray:
    """Rows of [BOS, seq..., EOS, PAD...] as long as the bucket's longest + 2,
    rounded up to ``seq_pad_multiple``: BatchCollator's layout over the whole
    bucket."""
    max_len = pad_to_multiple(max((len(s) for s in token_ids), default=0) + 2,
                              seq_pad_multiple)
    out = np.full((len(token_ids), max_len), pad, dtype=np.int32)
    for i, s in enumerate(token_ids):
        out[i, 0] = bos
        out[i, 1: len(s) + 1] = s
        out[i, len(s) + 1] = eos
    return out


def pack4(images: torch.Tensor) -> torch.Tensor:
    """uint8 (N, h, w) -> (N, h, ceil(w/2)): each pixel rounded to the nearest
    of 16 gray levels, min((x + 8) >> 4, 15), two a byte, the even pixel in
    the high nibble; an odd width is padded with white (255 -> 15)."""
    q = ((images.to(torch.int16) + 8) >> 4).clamp_(max=15)
    if q.shape[2] % 2:
        q = torch.cat([q, q.new_full((*q.shape[:2], 1), 15)], dim=2)
    return ((q[:, :, 0::2] << 4) | q[:, :, 1::2]).to(torch.uint8)


def _upload_images(ds: ImageDataset, rows: List[int], h: int, w: int, pack_bits: int,
                   device) -> torch.Tensor:
    """The images of ``rows`` in one device tensor, copied up (and packed)
    chunk by chunk."""
    stored_w = (w + 1) // 2 if pack_bits == 4 else w
    out = torch.empty((len(rows), h, stored_w), dtype=torch.uint8, device=device)
    chunk = max(1, UPLOAD_CHUNK_BYTES // (h * w))
    for i in range(0, len(rows), chunk):
        part = torch.from_numpy(np.stack([ds._load_array(r) for r in rows[i: i + chunk]]))
        part = part.to(device)
        out[i: i + len(part)] = pack4(part) if pack_bits == 4 else part
    return out


class DeviceResidentData:
    """The shape buckets of an :class:`ImageDataset`, resident on a device."""

    def __init__(self, buckets: Dict[Tuple[int, int], DeviceBucket]):
        self.buckets = buckets

    @classmethod
    def from_dataset(cls, ds: ImageDataset, seq_pad_multiple: int = 1,
                     min_bucket_items: int = 1, device="cuda",
                     max_canvas: Optional[Sequence[int]] = None, size_round: int = 1,
                     bucket_cap: Optional[int] = None,
                     pack_bits: int = 8) -> "DeviceResidentData":
        """Buckets keyed (h, w), in the order of sorted (w, h).

        A bucket with fewer than ``min_bucket_items`` rows, or larger than
        ``max_canvas`` (h, w), is left out. ``size_round`` rounds each
        bucket's row count up to a multiple, repeating rows modulo the real
        count. ``bucket_cap`` stages at most that many rows of a bucket: a
        seeded subset, the same on every run, with the dropped rows reported.
        ``pack_bits=4`` halves the image bytes (16 gray levels; ink and
        background survive exactly)."""
        if pack_bits not in (8, 4):
            raise ValueError(f"device_data_pack_bits must be 8 or 4, got {pack_bits}")
        special = ds.tokenizer.special_tokens
        pad, bos, eos = special[PAD_CHAR], special[BOS_CHAR], special[EOS_CHAR]
        buckets: Dict[Tuple[int, int], DeviceBucket] = {}
        for (w, h), idxs in sorted(ds.sizes.items()):
            if len(idxs) < min_bucket_items:
                continue
            if max_canvas is not None and (h > max_canvas[0] or w > max_canvas[1]):
                continue
            if bucket_cap is not None and len(idxs) > bucket_cap:
                rng = np.random.default_rng(h * 1_000_003 + w)
                keep = np.sort(rng.choice(len(idxs), size=bucket_cap, replace=False))
                print(f"  bucket ({h}, {w}): bucket_cap {bucket_cap} keeps "
                      f"{bucket_cap}/{len(idxs)} rows "
                      f"({len(idxs) - bucket_cap} dropped, seeded subset)")
                idxs = [idxs[i] for i in keep]
            n = len(idxs)
            rows = idxs + [idxs[i % n] for i in range(pad_to_multiple(n, size_round) - n)]
            labels = _pack_labels([ds.token_ids[i] for i in rows], pad, bos, eos,
                                  seq_pad_multiple)
            buckets[(h, w)] = DeviceBucket(
                _upload_images(ds, rows, h, w, pack_bits, device),
                torch.from_numpy(labels).to(device), n, true_w=w, pack_bits=pack_bits)
        return cls(buckets)

    def plan(self, batch_size: int, steps_cap: int = 32) -> List[Tuple[Tuple[int, int], int, int]]:
        """One epoch as a list of (bucket_key, steps, start) calls. Each call
        runs up to ``steps_cap`` steps from batch offset ``start`` of the
        bucket's permutation, so the steps of a bucket add up to one pass
        without replacement (floor(n / batch), at least 1)."""
        out = []
        for key, b in self.buckets.items():
            total = max(b.n // batch_size, 1)
            start = 0
            while total > 0:
                take = min(total, steps_cap)
                out.append((key, take, start))
                total -= take
                start += take
        return out


def gather_batch(bucket: DeviceBucket, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows ``idx`` of ``bucket`` as the model's input: (float32 (B, h, w, 1)
    images, 1 - u8/255, and int32 (B, L) labels), all on the device."""
    images = bucket.images.index_select(0, idx)
    labels = bucket.labels.index_select(0, idx)
    if bucket.pack_bits == 4:
        # x 17 maps code 15 to 255 and 0 to 0 exactly (ink and background).
        b, h, wp = images.shape
        images = torch.stack([(images >> 4) * 17, (images & 15) * 17], dim=-1)
        images = images.reshape(b, h, 2 * wp)[:, :, : bucket.true_w]
    return (1.0 - images.float() / 255.0)[..., None], labels


def _weight_mat(size: int, scale: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """Per sample, the (in, out) linear resampling weights of one axis,
    float32: jax.image's ``compute_weight_mat`` with the triangle kernel and
    antialiasing (the kernel widened by 1/scale when scale < 1), weights
    renormalised over the taps inside the image, and 0 for outputs whose
    sample point falls outside [-0.5, size - 0.5]."""
    inv_scale = 1.0 / scale
    kernel_scale = inv_scale.clamp(min=1.0)
    pos = torch.arange(size, dtype=torch.float32, device=scale.device)
    sample_f = ((pos[None, :] + 0.5) * inv_scale[:, None]
                - (translation * inv_scale)[:, None] - 0.5)  # (B, out)
    x = (sample_f[:, None, :] - pos[None, :, None]).abs() / kernel_scale[:, None, None]
    weights = (1 - x).clamp_(min=0)  # (B, in, out)
    total = weights.sum(dim=1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= size - 0.5)
    return weights * inside[:, None, :]


def scale_translate(images: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    dx: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) float32, each sample scaled by ``scale`` about its centre
    and shifted by (dy, dx) pixels, resampled as
    ``jax.image.scale_and_translate(method="linear")``: outside the image
    the result is 0 (the background in ink space). One (H, H) and one
    (W, W) weight matrix per sample, applied as two batched products."""
    _, h, w, _ = images.shape
    wh = _weight_mat(h, scale, (1.0 - scale) * h * 0.5 + dy)
    ww = _weight_mat(w, scale, (1.0 - scale) * w * 0.5 + dx)
    out = torch.bmm(wh.transpose(1, 2), images[..., 0])
    return torch.bmm(out, ww)[..., None]


def augment_batch(images: torch.Tensor, generator: torch.Generator,
                  rows: Optional[slice] = None, batch: Optional[int] = None) -> torch.Tensor:
    """Train-time augmentation on the device, in ink space (0 = background),
    after the gather: per sample a scale U(0.85, 1.05) about the centre, a
    shift dy U(-3, 3) and dx U(-8, 8) pixels, and a brightness factor
    U(0.9, 1.1), then clipped to [0, 1]. ``generator`` lives on the images'
    device and makes all the draws. ``images`` may be ``rows`` of a batch of
    ``batch`` samples: the draws are then the whole batch's, and these rows'
    are used."""
    u = torch.rand((4, batch or images.shape[0]), generator=generator, device=images.device)
    if rows is not None:
        u = u[:, rows]
    scale, dy, dx, bright = (lo + (hi - lo) * r for (lo, hi), r in zip(
        ((0.85, 1.05), (-3.0, 3.0), (-8.0, 8.0), (0.9, 1.1)), u))
    out = scale_translate(images, scale, dy, dx)
    return (out * bright[:, None, None, None]).clamp_(0.0, 1.0)


def epoch_permutation(n: int, seed: int, epoch: int, bucket_tag: int, device) -> torch.Tensor:
    """The random order of a bucket's ``n`` real rows for one epoch, on the
    device: one per (seed, epoch, bucket), shared by every call of that
    bucket in the epoch."""
    generator = seeded_generator(device, seed, epoch, bucket_tag, PERM_TAG)
    return torch.randperm(n, generator=generator, device=device)


def make_chunk_train_step(batch_size: int, *, mask_pad: bool = True, augment: bool = False,
                          rows: Optional[slice] = None):
    """(state, bucket, perm, n_steps, start) -> {"loss", "token_acc"}, the
    means over ``n_steps`` optimizer steps as device scalars. Step ``s``
    trains on rows ``perm[((start + s) * batch_size + j) % bucket.n]``,
    augmented with a generator seeded from (seed, step) when ``augment``;
    dropout is the train step's own. ``rows``: this data rank's j of the
    ``batch_size`` (all of them by default)."""

    def run(state: TrainState, bucket: DeviceBucket, perm: torch.Tensor, n_steps: int,
            start: int) -> Dict[str, torch.Tensor]:
        device = bucket.images.device
        offsets = torch.arange(batch_size, device=device)[rows or slice(None)]
        loss = torch.zeros((), device=device)
        acc = torch.zeros((), device=device)

        def batch(s):
            idx = perm[((start + s) * batch_size + offsets) % bucket.n]
            images, labels = gather_batch(bucket, idx)
            if augment:
                images = augment_batch(
                    images, seeded_generator(device, state.seed, state.step, AUGMENT_TAG),
                    rows, batch_size)
            return images, labels

        for s in range(n_steps):
            metrics = update(state, lambda: batch(s), device, mask_pad)
            loss += metrics["loss"]
            acc += metrics["token_acc"]
        return {"loss": loss / max(n_steps, 1), "token_acc": acc / max(n_steps, 1)}

    return run


def make_chunk_eval_step(batch_size: int, *, mask_pad: bool = True,
                         rows: Optional[slice] = None):
    """(model, bucket, n_steps, start) -> the mean loss, a device scalar,
    over ``n_steps`` batches that walk the bucket in storage order from batch
    offset ``start``, without dropout; ``rows`` as for the train runner."""
    eval_step = make_eval_step(mask_pad=mask_pad)

    def run(model, bucket: DeviceBucket, n_steps: int, start: int) -> torch.Tensor:
        device = bucket.images.device
        offsets = torch.arange(batch_size, device=device)[rows or slice(None)]
        total = torch.zeros((), device=device)
        for s in range(n_steps):
            idx = ((start + s) * batch_size + offsets) % bucket.n
            total += eval_step(model, *gather_batch(bucket, idx))
        return total / max(n_steps, 1)

    return run
