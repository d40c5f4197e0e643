"""Fixed-shape batches (``gan_image_captioning_tpu/data/loader.py``).

Every batch is padded to one width, ``seq_len = max_seq_len + 2`` (or its
length bucket's bound): captions wrapped ``<S> tokens… <E>`` then
``<PAD>``-padded, and a final partial batch padded with zero-weighted
rows.  :class:`Batcher` iterates a dataset in the JAX ``Batcher``'s order
(the same seeded shuffles, so the same batches); it builds them in the
caller's thread.

* Length buckets (``--length-buckets``, ``bucket_bounds``): each item
  goes to the first bucket whose bound holds its wrapped caption (an
  over-long one clips to the top bucket and is truncated there); each
  batch draws from one bucket and is padded to its bound; with
  ``shuffle`` the buckets' members and then the batches are shuffled by
  the epoch's generator.
* Precollation (``--precollate``): the whole dataset is collated into
  dense arrays once, at the widest width, and every batch is a row gather
  of them.  ``auto`` turns it on when the captions and the images of
  ``sample(0)``'s size times ``len(dataset)`` fit ``PRECOLLATE_BUDGET``
  bytes (``$GIC_PRECOLLATE_BUDGET``, default 1 GiB); ``on`` and ``off``
  force it.  The collation is kept on the dataset object, by width, so the
  Batchers of one dataset share it.
* :func:`stack_batches` groups K batches for ``--steps-per-call``.

Host sharding (``--mesh``) is not ported (``ROADMAP.md`` queue 1, item
4).
"""

from __future__ import annotations

import os
import threading
from typing import Iterator, Optional

import numpy as np

from gan_image_captioning_tpu_torch.data.vocab import END, PAD, START

PRECOLLATE_BUDGET = 1 << 30     # bytes, unless $GIC_PRECOLLATE_BUDGET says

# serialises the creation of each dataset's precollation lock
_PRE_LOCK_GUARD = threading.Lock()


def _dataset_lock(dataset) -> threading.Lock:
    """The lock of ``dataset``'s shared precollation (kept on the dataset
    object, so its lifetime is the dataset's)."""
    with _PRE_LOCK_GUARD:
        if getattr(dataset, "_gic_precollate_lock", None) is None:
            dataset._gic_precollate_lock = threading.Lock()
        return dataset._gic_precollate_lock


def make_batch(captions_list, images_list, seq_len: int,
               batch_size: Optional[int] = None):
    """One batch dict of numpy arrays: ``captions [B, seq_len]`` int32,
    ``lengths [B]`` int32, ``weights [B]`` float32 (0 on pad rows).

    ``captions_list``: 1-D int arrays (token ids, no specials), truncated
    to ``seq_len - 2``.  ``images_list``: None (unconditional), or one
    array per row: ``[3, S, S]`` float32 → ``images``, ``[3, S, S]`` uint8
    → ``images_u8`` (normalized on the device), ``[F]`` → cached
    ``backbone_feats`` (``--cache-features``, ``data/feature_cache.py``).
    Pad rows get zero images."""
    n = len(captions_list)
    batch_size = batch_size or n
    captions = np.full((batch_size, seq_len), PAD, dtype=np.int32)
    lengths = np.zeros((batch_size,), np.int32)
    weights = np.zeros((batch_size,), np.float32)
    for i, toks in enumerate(captions_list):
        toks = np.asarray(toks, np.int32)[: seq_len - 2]
        captions[i, 0] = START
        captions[i, 1: 1 + len(toks)] = toks
        captions[i, 1 + len(toks)] = END
        lengths[i] = len(toks) + 2
        weights[i] = 1.0
    batch = {"captions": captions, "lengths": lengths, "weights": weights}
    if images_list is not None and images_list[0] is not None:
        img_shape = images_list[0].shape
        dtype = np.asarray(images_list[0]).dtype
        images = np.zeros((batch_size,) + img_shape, dtype)
        for i, im in enumerate(images_list):
            images[i] = im
        if len(img_shape) == 1:
            batch["backbone_feats"] = images
        elif dtype == np.uint8:
            batch["images_u8"] = images
        else:
            batch["images"] = images
    return batch


def stack_batches(iterable, k: int):
    """Groups of ``k`` consecutive batches for ``--steps-per-call``: each
    array gains a leading step axis ``[k, ...]``.  Yields ``(stacked,
    count)``; the epoch's last group may hold fewer, and a group ends
    early where the next batch's keys or shapes differ (length buckets:
    one stack holds one shape)."""
    buf = []

    def flush():
        return {key: np.stack([b[key] for b in buf]) for key in buf[0]}, \
            len(buf)

    def matches(batch):
        first = buf[0]
        return (batch.keys() == first.keys()
                and all(np.shape(batch[key]) == np.shape(first[key])
                        for key in first))

    for batch in iterable:
        if buf and not matches(batch):
            yield flush()
            buf = []
        buf.append(batch)
        if len(buf) == k:
            yield flush()
            buf = []
    if buf:
        yield flush()


class Batcher:
    """Iterable over fixed-shape batches of ``dataset`` (``__len__`` and
    ``sample(i) -> (token_ids, image_or_None)``; ``caption_length(i)``
    when it has one).

    Each iteration is one epoch.  Without buckets the order is
    ``arange(n)``, shuffled by ``numpy.random.default_rng(seed + epoch)``
    when ``shuffle``, cut into ``batch_size`` slices (the last one dropped
    under ``drop_last``, else padded with zero-weighted rows).  With
    ``bucket_bounds`` each bucket's members are shuffled and cut likewise
    and the batches then shuffled, by the same generator (the module
    docstring).  ``epoch`` counts the iterations started: a resumed run
    sets it from the schedule sidecar's ``loader_epochs`` before its first
    iteration (``train/schedule.py``), and :meth:`iter_from` skips the
    batches a broken sweep applied.  Each batch also carries ``index
    [B]``, the dataset row of each batch row (pad rows repeat the
    first)."""

    def __init__(self, dataset, batch_size: int, seq_len: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, bucket_bounds=None,
                 precollate="auto"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        # upper bounds of the wrapped width (tokens + <S>/<E>)
        self.bucket_bounds = (sorted(int(b) for b in bucket_bounds)
                              if bucket_bounds else None)
        self._lengths = None
        self.precollate = precollate
        self._pre = None
        self._pre_resolved = False

    def __len__(self):
        """Batches an epoch without buckets (with them, as the JAX
        ``Batcher`` counts too: the temperature ramp and the sidecar's
        ``num_train_batches`` read this)."""
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _caption_lengths(self):
        if self._lengths is None:
            get = getattr(self.dataset, "caption_length", None)
            if get is None:
                get = lambda i: len(self.dataset.sample(i)[0])  # noqa: E731
            self._lengths = np.asarray(
                [get(i) for i in range(len(self.dataset))])
        return self._lengths

    def _bounds(self):
        bounds = list(self.bucket_bounds)
        if bounds[-1] < self.seq_len:
            bounds.append(self.seq_len)
        return bounds

    def _index_batches(self):
        """This epoch's ``(indices, width)`` per batch."""
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + self.epoch)
        if not self.bucket_bounds:
            order = np.arange(n)
            if self.shuffle:
                rng.shuffle(order)
            out = []
            for start in range(0, n, self.batch_size):
                idx = order[start: start + self.batch_size]
                if len(idx) < self.batch_size and self.drop_last:
                    break
                out.append((idx, self.seq_len))
            return out
        lengths = self._caption_lengths() + 2           # wrapped width
        bounds = self._bounds()
        # over-long captions clip to the top bucket (truncated there)
        assignment = np.minimum(np.searchsorted(bounds, lengths),
                                len(bounds) - 1)
        out = []
        for b, bound in enumerate(bounds):
            members = np.nonzero(assignment == b)[0]
            if self.shuffle:
                rng.shuffle(members)
            for start in range(0, len(members), self.batch_size):
                idx = members[start: start + self.batch_size]
                if len(idx) < self.batch_size and self.drop_last:
                    break
                out.append((idx, bound))
        if self.shuffle:
            rng.shuffle(out)
        return out

    def _pre_width(self) -> int:
        """The cache's width: wide enough for every bucket."""
        w = self.seq_len
        if self.bucket_bounds:
            w = max(w, self.bucket_bounds[-1])
        return w

    def _ensure_precollated(self):
        """Resolve the ``precollate`` gate and, when on, collate the whole
        dataset once (or take the collation another Batcher of the same
        dataset made at this width)."""
        if self._pre_resolved:
            return
        self._pre_resolved = True
        if self.precollate in (False, "off", "0"):
            return
        n = len(self.dataset)
        if n == 0:
            return
        width = self._pre_width()
        with _dataset_lock(self.dataset):
            cache = getattr(self.dataset, "_gic_precollated", None)
            if isinstance(cache, dict) and width in cache:
                self._pre = cache[width]
                return
            budget = int(os.environ.get("GIC_PRECOLLATE_BUDGET",
                                        PRECOLLATE_BUDGET))
            tok0, img0 = self.dataset.sample(0)
            est = n * (width * 4 + 12)
            if img0 is not None:
                est += np.asarray(img0).nbytes * n
            if self.precollate == "auto" and est > budget:
                return
            samples = [(tok0, img0)] + [self.dataset.sample(i)
                                        for i in range(1, n)]
            caps = [c for c, _ in samples]
            imgs = None if img0 is None else [im for _, im in samples]
            self._pre = make_batch(caps, imgs, width)
            if not isinstance(cache, dict):
                cache = self.dataset._gic_precollated = {}
            cache[width] = self._pre

    def _gather(self, idx, width):
        """A batch from the precollated arrays: what :meth:`_build` makes,
        by row gathers."""
        pre, n, bs = self._pre, len(idx), self.batch_size
        captions = np.full((bs, width), PAD, np.int32)
        captions[:n] = pre["captions"][idx, :width]
        lengths = np.zeros((bs,), np.int32)
        lengths[:n] = pre["lengths"][idx]
        weights = np.zeros((bs,), np.float32)
        weights[:n] = pre["weights"][idx]
        batch = {"captions": captions, "lengths": lengths, "weights": weights}
        for key in ("backbone_feats", "images_u8", "images"):
            if key in pre:
                src = pre[key]
                out = np.zeros((bs,) + src.shape[1:], src.dtype)
                out[:n] = src[idx]
                batch[key] = out
        return batch

    def _build(self, idx, width):
        if self._pre is not None:
            batch = self._gather(idx, width)
        else:
            samples = [self.dataset.sample(int(i)) for i in idx]
            caps = [s[0] for s in samples]
            imgs = [s[1] for s in samples]
            batch = make_batch(caps, None if imgs[0] is None else imgs,
                               width, self.batch_size)
        index = np.full((batch["captions"].shape[0],), int(idx[0]), np.int32)
        index[: len(idx)] = idx
        batch["index"] = index
        return batch

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[dict]:
        """This epoch's batches from batch ``start_batch`` on: the order is
        built in full (the same shuffles as a whole epoch), and the
        skipped batches are not built."""
        batches = self._index_batches()[start_batch:]
        self.epoch += 1
        self._ensure_precollated()
        for idx, width in batches:
            yield self._build(idx, width)
