"""Dataset loading and the host input pipeline, the JAX package's
``training/data.py``: for one seed the split and the batch order are the
same in both packages.

- :class:`PairedSegmentationData`: image/mask pairs by identical file
  name, BGR->RGB, INTER_AREA resize for images and INTER_NEAREST for
  masks, /255 (cv2 imported at the first load).
- :func:`train_val_split`: a seeded shuffled split.
- :func:`epoch_order`: full batches, the ragged last one filled by
  repeating the epoch's permutation cyclically (the JAX package needs
  static shapes; the port keeps the same batches).
- :class:`Batches` / :class:`StreamingBatches`: epoch iterators over
  in-memory arrays and over files, each decoding ahead on a background
  thread. Each seeds its order from ``seed`` when it is made (``rng``);
  the trainer puts a checkpoint's order state back into it on resume.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


class PairedSegmentationData:
    """File-pair dataset (reference: SegmentationDataset,
    train_segmenter.py:66-100)."""

    def __init__(self, dataset_dir: str | Path, img_size: int = 256):
        self.root = Path(dataset_dir)
        self.img_size = img_size
        img_dir = self.root / "images"
        mask_dir = self.root / "masks"
        if not img_dir.is_dir() or not mask_dir.is_dir():
            raise FileNotFoundError(
                f"dataset at {self.root} needs images/ and masks/ subdirs "
                "(generate one with training.synthetic.generate_dataset)"
            )
        mask_names = {p.name for p in mask_dir.iterdir()}
        self.names = sorted(p.name for p in img_dir.iterdir() if p.name in mask_names)
        if not self.names:
            raise FileNotFoundError(f"no paired image/mask files in {self.root}")

    def __len__(self) -> int:
        return len(self.names)

    def load(self, name: str):
        import cv2

        img = cv2.imread(str(self.root / "images" / name), cv2.IMREAD_COLOR)
        mask = cv2.imread(str(self.root / "masks" / name), cv2.IMREAD_GRAYSCALE)
        if img is None or mask is None:
            raise IOError(f"failed to read pair {name!r}")
        s = self.img_size
        img = cv2.resize(img, (s, s), interpolation=cv2.INTER_AREA)[..., ::-1]
        mask = cv2.resize(mask, (s, s), interpolation=cv2.INTER_NEAREST)
        x = img.astype(np.float32) / 255.0
        y = (mask.astype(np.float32) / 255.0)[..., None]
        return x, y

    def as_arrays(self, names=None):
        names = self.names if names is None else names
        xs = np.zeros((len(names), self.img_size, self.img_size, 3), np.float32)
        ys = np.zeros((len(names), self.img_size, self.img_size, 1), np.float32)
        for i, n in enumerate(names):
            xs[i], ys[i] = self.load(n)
        return xs, ys


def train_val_split(n: int, val_fraction: float, seed: int = 0):
    """Deterministic shuffled split (reference uses torch random_split 80/20,
    train_segmenter.py:134-136)."""
    order = np.random.default_rng(seed).permutation(n)
    n_val = max(1, int(round(n * val_fraction))) if n > 1 else 0
    return order[n_val:], order[:n_val]


def _check_divisor(batch_size: int, divisor: int) -> None:
    if divisor > 1 and batch_size % divisor:
        raise ValueError(
            f"batch_size {batch_size} must be divisible by the "
            f"data-parallel world size {divisor}"
        )


def epoch_order(n: int, batch_size: int, shuffle: bool,
                rng: np.random.Generator) -> np.ndarray:
    """(n_batches, batch_size) index matrix covering [0, n) with wrap-around
    tail padding so every batch is full."""
    order = np.arange(n)
    if shuffle:
        rng.shuffle(order)
    n_batches = max(1, int(np.ceil(n / batch_size)))
    if n_batches * batch_size != n:
        # np.resize repeats the permutation cyclically, so splits smaller
        # than the pad amount still fill every slot
        order = np.resize(order, n_batches * batch_size)
    return order.reshape(n_batches, batch_size)


def _prefetched(producer_batches, make_item, prefetch: int):
    """Run ``make_item`` over ``producer_batches`` in a daemon thread, keeping
    up to ``prefetch`` finished batches queued ahead of the consumer.

    Producer errors re-raise on the consumer side; if the consumer abandons
    the iterator mid-epoch (train step raised, caller broke out), the
    ``cancel`` event unblocks the producer so the thread and its queued
    batches are released instead of pinned for the process lifetime."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = object()
    cancel = threading.Event()
    err: list[BaseException] = []

    def _put(item) -> bool:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in producer_batches:
                if cancel.is_set() or not _put(make_item(b)):
                    return
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            _put(stop)

    worker = threading.Thread(target=producer, name="batch-prefetch",
                              daemon=True)
    worker.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                if err:
                    raise err[0]
                break
            yield item
    finally:
        cancel.set()
        # the cancel event unblocks a producer stuck on a full queue, so
        # this join is bounded: the thread (and its queued batches) is
        # actually released before the consumer moves on, instead of
        # lingering for the process lifetime
        worker.join(timeout=5)


class Batches:
    """Epoch iterator over in-memory arrays with shuffling, an optional
    world-size divisibility check, and background prefetch."""

    def __init__(self, xs, ys, batch_size: int, shuffle: bool = True,
                 seed: int = 0, divisor: int = 1, prefetch: int = 2):
        if len(xs) == 0:
            raise ValueError("empty dataset")
        _check_divisor(batch_size, divisor)
        self.xs, self.ys = xs, ys
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch

    def __iter__(self):
        batches = epoch_order(len(self.xs), self.batch_size, self.shuffle,
                              self.rng)
        if self.prefetch <= 0:
            for idx in batches:
                yield self.xs[idx], self.ys[idx]
            return
        yield from _prefetched(
            batches, lambda idx: (self.xs[idx], self.ys[idx]), self.prefetch
        )

    def __len__(self):
        return max(1, int(np.ceil(len(self.xs) / self.batch_size)))


class StreamingBatches:
    """Decode-on-the-fly epoch iterator over a file-backed dataset subset.

    Constant-memory replacement for ``dataset.as_arrays()`` + ``Batches``:
    only ``prefetch + 1`` decoded batches exist at any moment, so dataset
    size is bounded by disk, not host RAM. A thread pool decodes/resizes the
    next batches (``load`` is OpenCV → releases the GIL) while the device
    runs the current step — the async host input pipeline the reference
    lacks (its loader is synchronous in-loop with ``num_workers=0``,
    train_segmenter.py:138-139; SURVEY.md Phase 5 "per-host sharded input
    pipeline").

    Same epoch semantics as ``Batches``: shuffled wrap-around-padded full
    batches, divisor-aware for data-parallel sharding.
    """

    def __init__(self, dataset: PairedSegmentationData, indices,
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 divisor: int = 1, prefetch: int = 2, workers: int = 4):
        indices = np.asarray(indices)
        if len(indices) == 0:
            raise ValueError("empty dataset subset")
        _check_divisor(batch_size, divisor)
        self.dataset = dataset
        self.names = [dataset.names[i] for i in indices]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.prefetch = max(1, prefetch)
        self.workers = max(1, workers)

    def _decode_batch(self, pool: ThreadPoolExecutor, idx: np.ndarray):
        s = self.dataset.img_size
        xs = np.empty((len(idx), s, s, 3), np.float32)
        ys = np.empty((len(idx), s, s, 1), np.float32)
        loaded = pool.map(self.dataset.load, (self.names[i] for i in idx))
        for i, (x, y) in enumerate(loaded):
            xs[i], ys[i] = x, y
        return xs, ys

    def __iter__(self):
        batches = epoch_order(len(self.names), self.batch_size, self.shuffle,
                              self.rng)
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            yield from _prefetched(
                batches, lambda idx: self._decode_batch(pool, idx),
                self.prefetch,
            )

    def __len__(self):
        return max(1, int(np.ceil(len(self.names) / self.batch_size)))
