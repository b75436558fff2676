"""Dataset, shape-bucket batching and collation on the host.

Batches form only within identical (w, h) image sizes, and label padding is
rounded up to ``seq_pad_multiple``, as in the JAX package. The sampler and the
collator draw from the global ``random`` module with the JAX package's seeds
and calls (reseeded on every pass, never restored), so the batch order and the
arrays are the same.

``ImageDataset(root_dir, tokenizer_path, dataset_size)`` builds a dataset
from a directory of rendered images, as the data factory writes it
(``labels.txt``, ``ids.txt``, ``images/``; the pruned files where they
exist), with the JAX package's contents: the labels and ids cut at
``dataset_size``, every label encoded once by ``encode_batch``, the pixels
through ``serving.image_io`` (no PIL for a PNG) equal to PIL's
``convert("L")``. A lazy dataset (``lazy=True``) reads only each PNG's
header (its images must be PNGs) and decodes the pixels at each access. ``ImageDataset.load`` reads
the JAX package's pickle payload (a plain dict of numpy arrays and Python
lists, eager or lazy) through an unpickler that admits nothing else, and
``save`` writes the same payload.
"""

from __future__ import annotations

import os
import pickle
import queue
import random
import threading
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from texocr_tpu_torch.data.transforms import img_transform
from texocr_tpu_torch.serving.image_io import decode_image, png_size
from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH, RegexBPETokenizer
from texocr_tpu_torch.utils import pad_to_multiple

PAD_CHAR, BOS_CHAR, EOS_CHAR = "<PAD>", "<BOS>", "<EOS>"

# What a payload pickle may construct: numpy arrays and scalars.
_ALLOWED_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
}


class _PayloadUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) not in _ALLOWED_GLOBALS:
            raise pickle.UnpicklingError(f"dataset payload may not hold {module}.{name}")
        return super().find_class(module, name)


class ImageDataset:
    """In-memory dataset of rendered-equation images (uint8) and their token ids."""

    def __init__(self, root_dir: Optional[str] = None, tokenizer_path: Optional[str] = None,
                 dataset_size: Optional[int] = None, augment: bool = False,
                 lazy: bool = False):
        """``lazy=True`` keeps only the file names and sizes and decodes each
        PNG at each access: the memory plan at 100k full canvases, where the
        eager uint8 arrays take about 16 GB and the pickle as much. Without
        all three of ``root_dir``, ``tokenizer_path`` and ``dataset_size``,
        a bare instance (for ``load`` and ``from_arrays``)."""
        self.augment = augment
        self.lazy = lazy
        if not (root_dir and tokenizer_path and dataset_size):
            return

        self.tokenizer_path = tokenizer_path
        self.tokenizer = RegexBPETokenizer().load(tokenizer_path)
        root = Path(root_dir)
        self.root_dir = root
        if (root / "labels_pruned.txt").exists():  # render failures dropped
            label_path, id_path = root / "labels_pruned.txt", root / "ids_pruned.txt"
        else:
            label_path, id_path = root / "labels.txt", root / "ids.txt"
        self.labels = label_path.read_text().splitlines()[:dataset_size]
        self.image_ids = id_path.read_text().splitlines()[:dataset_size]
        self.dataset_size = len(self.labels)

        self.images: List[Optional[np.ndarray]] = []
        self.sizes: Dict[Tuple[int, int], List[int]] = defaultdict(list)
        heights, widths = [], []
        for i, image_id in enumerate(self.image_ids):
            path = root / "images" / image_id
            if lazy:  # the PNG header's size; the pixels wait for an access
                with open(path, "rb") as f:
                    w, h = png_size(f.read(24))
                self.images.append(None)
            else:
                arr = decode_image(path.read_bytes())
                h, w = arr.shape
                self.images.append(arr)
            heights.append(h)
            widths.append(w)
            self.sizes[(w, h)].append(i)

        self.token_ids = self.tokenizer.encode_batch(self.labels)  # once, without BOS/EOS
        self.max_seq_len = max((len(t) for t in self.token_ids), default=0) + 2
        self.max_height = max(heights, default=0)
        self.max_width = max(widths, default=0)

    @classmethod
    def from_arrays(cls, images: Sequence[np.ndarray], token_ids: Sequence[List[int]],
                    tokenizer_path: str = DEFAULT_VOCAB_PATH,
                    labels: Optional[List[str]] = None, augment: bool = False) -> "ImageDataset":
        """An eager dataset of (H, W) uint8 images and their token ids (without
        BOS/EOS)."""
        ds = cls(augment=augment)
        ds.tokenizer_path = tokenizer_path
        ds.tokenizer = RegexBPETokenizer().load(tokenizer_path)
        ds.images = [np.asarray(im, np.uint8) for im in images]
        ds.token_ids = [list(map(int, t)) for t in token_ids]
        ds.labels = labels if labels is not None else [""] * len(ds.images)
        ds.image_ids = [f"{i:06d}.png" for i in range(len(ds.images))]
        ds.dataset_size = len(ds.images)
        ds.sizes = defaultdict(list)
        for i, arr in enumerate(ds.images):
            h, w = arr.shape
            ds.sizes[(w, h)].append(i)
        ds.max_seq_len = max((len(t) for t in ds.token_ids), default=0) + 2
        ds.max_height = max((im.shape[0] for im in ds.images), default=0)
        ds.max_width = max((im.shape[1] for im in ds.images), default=0)
        return ds

    # -- sample access -------------------------------------------------------

    def __len__(self) -> int:
        return self.dataset_size

    def _load_array(self, idx: int) -> np.ndarray:
        if self.images[idx] is not None:
            return self.images[idx]
        return decode_image((Path(self.root_dir) / "images" / self.image_ids[idx]).read_bytes())

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, List[int]]:
        """(float32 (H, W, 1) preprocessed image, token id list)."""
        arr = self._load_array(idx)
        if self.augment:
            return img_transform(arr, rng=self._rng(), augment=True), self.token_ids[idx]
        return (1.0 - arr.astype(np.float32) / 255.0)[..., None], self.token_ids[idx]

    _aug_rng: Optional[np.random.Generator] = None

    def _rng(self) -> np.random.Generator:
        if self._aug_rng is None:
            self._aug_rng = np.random.default_rng()
        return self._aug_rng

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> None:
        """The JAX package's payload: either package loads it."""
        payload = {
            "tokenizer_path": self.tokenizer_path,
            "labels": self.labels,
            "image_ids": self.image_ids,
            "images": None if self.lazy else self.images,
            "lazy": self.lazy,
            "root_dir": str(self.root_dir) if self.lazy else None,
            "sizes": dict(self.sizes) if self.lazy else None,
            "token_ids": self.token_ids,
            "max_seq_len": self.max_seq_len,
            "max_height": self.max_height,
            "max_width": self.max_width,
            "augment": self.augment,
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    @classmethod
    def load(cls, path: str) -> "ImageDataset":
        """A dataset from a payload pickle. Its tokenizer is the file the
        payload names or, where that file does not exist, the port's copy of
        the shipped vocabulary."""
        with open(path, "rb") as f:
            payload = _PayloadUnpickler(f).load()
        ds = cls()
        ds.tokenizer_path = payload["tokenizer_path"]
        vocab = ds.tokenizer_path
        if not (vocab and os.path.exists(vocab)):
            vocab = DEFAULT_VOCAB_PATH
        ds.tokenizer = RegexBPETokenizer().load(vocab)
        ds.labels = payload["labels"]
        ds.image_ids = payload["image_ids"]
        ds.lazy = payload.get("lazy", False)
        ds.token_ids = payload["token_ids"]
        ds.max_seq_len = payload["max_seq_len"]
        ds.max_height = payload["max_height"]
        ds.max_width = payload["max_width"]
        ds.augment = payload["augment"]
        ds.dataset_size = len(ds.labels)
        if ds.lazy:
            ds.root_dir = Path(payload["root_dir"])
            ds.images = [None] * ds.dataset_size
            ds.sizes = defaultdict(list, payload["sizes"])
        else:
            ds.images = payload["images"]
            ds.sizes = defaultdict(list)
            for i, arr in enumerate(ds.images):
                h, w = arr.shape
                ds.sizes[(w, h)].append(i)
        return ds

    def __repr__(self) -> str:
        return f"ImageDataset with {len(self)} samples."


class BucketBatchSampler:
    """Batches indices only within identical (w, h) size groups; drops
    remainders unless ``keep_small``; shuffles the batch order with a seed
    that grows by one per pass."""

    def __init__(self, sizes: Dict[Tuple[int, int], List[int]], batch_size: int,
                 drop_last: bool = True, shuffle: bool = False, keep_small: bool = False,
                 seed: int = 42):
        self.sizes = sizes
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.keep_small = keep_small
        self.shuffle = shuffle
        self.seed = seed

    def __iter__(self) -> Iterator[List[int]]:
        batches = []
        for _, ids in self.sizes.items():
            for i in range(0, len(ids), self.batch_size):
                batch = ids[i: i + self.batch_size]
                if len(batch) == self.batch_size or self.keep_small:
                    batches.append(batch)
        if self.shuffle:
            random.seed(self.seed)
            random.shuffle(batches)
            self.seed += 1
        yield from batches

    def __len__(self) -> int:
        full = sum(len(ids) // self.batch_size for ids in self.sizes.values())
        if self.keep_small:
            full += sum(1 for ids in self.sizes.values() if len(ids) % self.batch_size)
        return full


class BatchCollator:
    """Stacks images; pads labels to the batch's longest + 2 (rounded up to
    ``seq_pad_multiple``) with PAD, BOS at 0 and EOS after each sequence."""

    def __init__(self, pad_token: int, bos_token: int, eos_token: int, shuffle: bool = False,
                 seed: int = 42, seq_pad_multiple: int = 1):
        self.pad_token = pad_token
        self.bos_token = bos_token
        self.eos_token = eos_token
        self.shuffle = shuffle
        self.seed = seed
        self.seq_pad_multiple = seq_pad_multiple

    def __call__(self, batch: List[Tuple[np.ndarray, List[int]]]) -> Tuple[np.ndarray, np.ndarray]:
        if self.shuffle:
            random.seed(self.seed)
            indices = list(range(len(batch)))
            random.shuffle(indices)
            self.seed += 1
            batch = [batch[i] for i in indices]

        images = np.stack([im for im, _ in batch]).astype(np.float32)
        seqs = [ids for _, ids in batch]
        max_len = pad_to_multiple(max(len(s) for s in seqs) + 2, self.seq_pad_multiple)
        labels = np.full((len(seqs), max_len), self.pad_token, dtype=np.int32)
        for i, s in enumerate(seqs):
            labels[i, 0] = self.bos_token
            labels[i, 1: len(s) + 1] = s
            labels[i, len(s) + 1] = self.eos_token
        return images, labels


class _Loader:
    """Re-iterable (images, labels) batches: one pass per epoch."""

    def __init__(self, dataset: ImageDataset, sampler: BucketBatchSampler,
                 collate: BatchCollator):
        self.dataset = dataset
        self.sampler = sampler
        self.collate = collate

    def __iter__(self):
        for batch_ids in self.sampler:
            yield self.collate([self.dataset[i] for i in batch_ids])

    def __len__(self):
        return len(self.sampler)


def create_dataloader(dataset: ImageDataset, config: dict,
                      seed_offset: int = 0) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
    """Reference-format config -> re-iterable of numpy (images, labels)
    batches. Build it once and iterate once per epoch: the seeds grow per
    pass, so batches differ between epochs; ``seed_offset`` advances them (a
    resumed run passes its first epoch)."""
    special = dataset.tokenizer.special_tokens
    collate = BatchCollator(
        special[PAD_CHAR], special[BOS_CHAR], special[EOS_CHAR],
        shuffle=config.get("id_shuffle", False),
        seed=config.get("seed", 42) + seed_offset,
        seq_pad_multiple=config.get("seq_pad_multiple", 1),
    )
    sampler = BucketBatchSampler(
        dataset.sizes,
        batch_size=config["batch_size"],
        drop_last=config.get("drop_last", True),
        shuffle=config.get("batch_shuffle", False),
        keep_small=config.get("keep_small", False),
        seed=config.get("seed", 42) + seed_offset,
    )
    return _Loader(dataset, sampler, collate)


def load_datasets(data_dir: str):
    """(train, val, test) from the standard layout:
    ``{train/trainset, val/valset, test/testset}.pkl`` under ``data_dir``."""
    return tuple(ImageDataset.load(os.path.join(data_dir, split, f"{split}set.pkl"))
                 for split in ("train", "val", "test"))


def prefetch(iterable: Iterable, size: int = 2) -> Iterator:
    """Runs ``iterable`` in a background thread, ``size`` items ahead, so that
    host collation overlaps the device's work. An exception in the thread is
    raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()
    failure = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # handed to the consumer, which raises it
            failure.append(e)
        finally:
            q.put(done)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            if failure:
                raise failure[0]
            return
        yield item
