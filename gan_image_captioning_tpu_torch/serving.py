"""Serving engine: cross-connection coalescing
(``gan_image_captioning_tpu/serving.py:CoalescingBatcher``).

One dispatcher thread owns the device; requests from any connection or
thread enqueue and are drained into shared fixed-shape decode batches, so
K concurrent one-caption requests cost about one decode, not K.  The
continuous (slot-pool) engine is not ported yet.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future

import numpy as np
import torch


class EngineOverloaded(RuntimeError):
    """Admission control: the engine's pending queue is at ``max_pending``.

    Raised by ``submit()`` so the caller fails fast instead of joining a
    queue it would only time out of."""


def _to_host(parts):
    """``[(ids, lps), …]`` per dispatched chunk → host arrays, one copy of
    each for the whole drain."""
    ids = torch.cat([torch.as_tensor(p[0]) for p in parts]).cpu().numpy()
    lps = torch.cat([torch.as_tensor(p[1]) for p in parts]).cpu().numpy()
    return ids, lps


class CoalescingBatcher:
    """Single dispatcher thread draining a cross-connection request queue
    into shared fixed-shape decode batches.

    ``decode_fn(feats [b, E] float32 ndarray) → (ids [b, T], logprobs
    [b])`` as tensors (on any device) or arrays.  ``bucket_sizes`` (optional,
    ascending) lets each chunk of a drain run at the smallest bucket that
    fits instead of padding to ``batch_size``; pad rows replicate the
    chunk's first row.  ``max_pending`` > 0 bounds the queue."""

    def __init__(self, decode_fn, batch_size: int, feat_dim: int,
                 bucket_sizes=None, max_pending: int = 0):
        self._decode = decode_fn
        self.batch_size = batch_size
        self.feat_dim = feat_dim
        self.max_pending = int(max_pending)  # 0 = unbounded
        self.rejected = 0
        if bucket_sizes:
            bs = sorted(set(int(b) for b in bucket_sizes) | {batch_size})
            if bs[-1] != batch_size:
                raise ValueError(
                    f"bucket_sizes {bucket_sizes} exceed batch_size "
                    f"{batch_size}")
            self.bucket_sizes = bs
        else:
            self.bucket_sizes = [batch_size]
        self._q: "queue.Queue" = queue.Queue()
        self.device_calls = 0
        self.requests = 0
        self.rows_dispatched = 0            # incl. padding rows
        self.rows_requested = 0
        # serializes submit() vs close(): a submit that wins the lock has
        # its item queued before close() drains; one that loses raises
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="coalescing-dispatcher")
        self._stop = False
        self._thread.start()

    def stats(self) -> dict:
        """Dispatcher-side counters (host only, no device sync).
        ``padding_frac`` is the share of dispatched rows that were pad
        replicas."""
        rd, rq = self.rows_dispatched, self.rows_requested
        return {
            "requests": self.requests,
            "device_calls": self.device_calls,
            "rows_requested": rq,
            "rows_dispatched": rd,
            "padding_frac": round(max(0.0, 1.0 - rq / rd), 4) if rd else 0.0,
            "rejected": self.rejected,
        }

    def _bucket_for(self, n: int) -> int:
        for b in self.bucket_sizes:
            if b >= n:
                return b
        return self.bucket_sizes[-1]

    def submit(self, feats_rows: np.ndarray) -> Future:
        """Enqueue one request's feature rows [n, E]; resolves to
        ``(ids [n, T], logprobs [n])`` host arrays."""
        feats_rows = np.asarray(feats_rows)
        if (feats_rows.ndim != 2 or feats_rows.shape[0] < 1
                or feats_rows.shape[1] != self.feat_dim):
            raise ValueError(f"feature rows of shape {feats_rows.shape}, "
                             f"expected [n >= 1, {self.feat_dim}]")
        with self._submit_lock:
            if self._stop:
                raise RuntimeError("CoalescingBatcher closed")
            if self.max_pending and self._q.qsize() >= self.max_pending:
                self.rejected += 1
                raise EngineOverloaded(
                    f"coalescing queue at max_pending={self.max_pending}")
            fut: Future = Future()
            self.requests += 1
            self._q.put((feats_rows, fut))
            return fut

    def close(self):
        """Stop the dispatcher and fail every request it never took."""
        with self._submit_lock:
            self._stop = True
        self._q.put(None)
        self._thread.join(timeout=5)
        exc = RuntimeError("CoalescingBatcher closed")
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(exc)

    def _loop(self):
        while not self._stop:
            item = self._q.get()
            if item is None:
                continue
            # drain whatever else is already queued (the coalescing window
            # is "everything that arrived while the device was busy")
            pending = [item]
            rows = item[0].shape[0]
            while rows < self.batch_size:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    continue
                pending.append(nxt)
                rows += nxt[0].shape[0]
            # one bad request fails ITS futures, never the dispatcher thread
            try:
                feats = np.concatenate([f for f, _ in pending], axis=0
                                       ).astype(np.float32, copy=False)
                n = feats.shape[0]
                self.rows_requested += n
                # enqueue every chunk, then ONE host copy for the drain;
                # each chunk runs at the smallest bucket that fits
                parts = []
                off = 0
                while off < n:
                    b = self._bucket_for(n - off)
                    chunk = feats[off:off + b]
                    pad = b - chunk.shape[0]
                    if pad:
                        chunk = np.concatenate(
                            [chunk, np.repeat(chunk[:1], pad, axis=0)])
                    parts.append(self._decode(chunk))
                    self.device_calls += 1
                    self.rows_dispatched += b
                    off += b
                ids, lps = _to_host(parts)
                ids, lps = ids[:n], lps[:n]
            except Exception as exc:
                for _, fut in pending:
                    if not fut.done():
                        fut.set_exception(exc)
                continue
            off = 0
            for f, fut in pending:
                k = f.shape[0]
                fut.set_result((ids[off:off + k], lps[off:off + k]))
                off += k
