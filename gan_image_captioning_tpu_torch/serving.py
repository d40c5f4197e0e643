"""Serving engines (``gan_image_captioning_tpu/serving.py``).

* :class:`CoalescingBatcher`: one dispatcher thread owns the device;
  requests from any connection or thread enqueue and are drained into
  shared fixed-shape decode batches, so K concurrent one-caption requests
  cost about one decode, not K.
* :class:`ContinuousBatcher`: a pool of decode slots advances
  ``chunk_steps`` tokens per device call with the LSTM state ``(h, c)``
  and the next input ``x`` carried on the device; new requests take free
  slots at chunk boundaries instead of waiting for a whole batch.  Each
  chunk is one call of the carried-state serve decode (dense or
  quantized: the kernel on the card, its plain version on the CPU).

Both return per-caption greedy log-probabilities with
``eval/decode.py:sequence_logprob``'s mask (up to and including the first
``<E>``).  Not ported: the speculative draft slots, transformer slots and
``--mesh``.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future

import numpy as np
import torch

from gan_image_captioning_tpu_torch.data.vocab import END
from gan_image_captioning_tpu_torch.eval import decode as decode_lib
from gan_image_captioning_tpu_torch.ops import quantize as q_lib


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


def _masked_logprob_sum(ids: np.ndarray, lps: np.ndarray) -> np.ndarray:
    """``sequence_logprob``'s keep-mask on the host: positions up to and
    including the FIRST <E>."""
    is_end = ids == END
    ncum = np.cumsum(is_end, axis=1)
    keep = (ncum == 0) | (is_end & (ncum == 1))
    return (lps * keep).sum(axis=1)


class ContinuousBatcher:
    """Slot-pool continuous batching over the greedy LSTM decode.

    One device call per chunk, :meth:`_advance`: an admission prologue
    (slots marked ``fresh`` get their state zeroed and their feature row
    installed as the t = 0 input) followed by ``chunk_steps`` greedy tokens
    for ALL slots — one :func:`eval.decode.decode_chunk` call, the
    carried-state serve decode of the dense or quantized decoder.  Free
    slots keep computing (their output is ignored).

    ``generator``: a port ``Generator`` or its quantized twin
    (``ops/quantize.py:quantize_generator``); the device is the one its
    weights lie on.  ``early_exit``: a slot whose chunk emitted ``<E>``
    frees at that chunk boundary and its ids after the first ``<E>`` are
    ``<PAD>``; ``False`` runs every slot the full T steps, so ids equal
    the full batch greedy decode (``--serve-exact``).  ``max_pending`` > 0
    bounds the queue (:class:`EngineOverloaded`).
    """

    def __init__(self, generator, config, num_slots: int = 8,
                 chunk_steps: int = 8, early_exit: bool = True,
                 max_pending: int = 0):
        if config.gen_arch != "lstm":
            raise NotImplementedError(
                f"continuous batching with --gen-arch {config.gen_arch}: "
                "only LSTM slots are ported")
        self.max_pending = int(max_pending)  # 0 = unbounded
        self.rejected = 0
        self.config = config
        self.T = config.seq_len
        self.B = int(num_slots)
        self.K = min(int(chunk_steps), self.T)
        self.early_exit = early_exit
        self._dec = decode_lib.decoder_of(generator)
        stepper = decode_lib.make_stepper(generator, config)
        self._h, self._c = stepper.init_state(self.B)
        self.device = self._h.device
        embed = (self._dec["embed"].scale if q_lib.is_quantized(self._dec)
                 else self._dec.embed.weight)
        self._feat_dim = embed.shape[-1]
        # x in the state's dtype (the JAX engine's x_dtype): bfloat16 in a
        # bfloat16 quantized decode
        self._x = torch.zeros((self.B, self._feat_dim), dtype=self._h.dtype,
                              device=self.device)
        # host-side slot bookkeeping
        self._slot_t = np.full((self.B,), -1, np.int32)   # -1 = free
        self._slot_fut: list = [None] * self.B
        self._slot_cb: list = [None] * self.B   # per-slot streaming hook
        self._ids = np.zeros((self.B, self.T), np.int32)
        self._lps = np.zeros((self.B, self.T), np.float32)

        self._q: "queue.Queue" = queue.Queue()
        self.device_calls = 0
        self.completed = 0
        self.slot_chunks = 0      # sum over chunks of active-slot count
        self._stop = False
        self._wake = threading.Event()
        # serializes submit() vs close() (see CoalescingBatcher)
        self._submit_lock = threading.Lock()
        # serializes slot bookkeeping between the dispatcher's commit loop
        # and close()'s _fail_active_slots (close's bounded join may time
        # out while the dispatcher is still inside _advance)
        self._slot_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="continuous-dispatcher")
        self._thread.start()

    def stats(self) -> dict:
        """Host-side pool counters.  ``occupancy`` is the mean share of
        slots doing useful work per device call."""
        dc = self.device_calls
        return {
            "device_calls": dc,
            "completed": self.completed,
            "queue_depth": self._q.qsize(),
            "active_slots": int((self._slot_t >= 0).sum()),
            "occupancy": round(self.slot_chunks / (dc * self.B), 4)
            if dc else 0.0,
            "rejected": self.rejected,
        }

    def submit(self, feats_row: np.ndarray, on_tokens=None) -> Future:
        """One caption request (a feature row [E]); resolves to ``(ids [T],
        logprob)``.  ``on_tokens(ids_so_far, done)`` (optional) streams
        progress after every chunk that commits tokens for it, from the
        dispatcher thread (keep it non-blocking); its exceptions are
        swallowed."""
        wrapped = (None if on_tokens is None
                   else (lambda j, ids, done: on_tokens(ids, done)))
        return self.submit_many([feats_row], on_tokens=wrapped)[0]

    def submit_many(self, feats_rows, on_tokens=None) -> list:
        """Admit a multi-row request atomically: every row gets a queue
        entry or none does.  ``on_tokens(row_index, ids_so_far, done)``
        streams per-row progress (see :meth:`submit`)."""
        with self._submit_lock:
            if self._stop:
                raise RuntimeError("ContinuousBatcher closed")
            if (self.max_pending
                    and self._q.qsize() + len(feats_rows) > self.max_pending):
                self.rejected += len(feats_rows)
                raise EngineOverloaded(
                    f"slot queue at max_pending={self.max_pending}")
            futs = []
            for j, row in enumerate(feats_rows):
                fut: Future = Future()
                cb = (None if on_tokens is None else
                      (lambda ids, done, j=j: on_tokens(j, ids, done)))
                self._q.put((np.asarray(row), fut, cb))
                futs.append(fut)
            self._wake.set()
            return futs

    def close(self):
        """Stop the dispatcher and fail every request it will not finish:
        active slots and queued requests."""
        with self._submit_lock:
            self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)
        exc = RuntimeError("ContinuousBatcher closed")
        self._fail_active_slots(exc)
        while True:
            try:
                _, fut, _ = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(exc)

    def _fill_free_slots(self):
        """Assign queued requests to free slots on the host: returns
        ``(fresh [B] bool, feats [B, E] f32)`` for the admission prologue."""
        fresh = np.zeros((self.B,), bool)
        feats_new = np.zeros((self.B, self._feat_dim), np.float32)
        with self._slot_lock:
            for i in range(self.B):
                if self._slot_t[i] >= 0:
                    continue
                try:
                    feats, fut, cb = self._q.get_nowait()
                except queue.Empty:
                    break
                try:
                    row = np.asarray(feats, np.float32)
                    if row.shape != (self._feat_dim,):
                        raise ValueError(
                            f"feature row shape {row.shape} != "
                            f"({self._feat_dim},)")
                    feats_new[i] = row
                except Exception as exc:
                    # a mis-shaped row fails ITS request; the slot stays free
                    if not fut.done():
                        fut.set_exception(exc)
                    continue
                fresh[i] = True
                self._slot_t[i] = 0
                self._slot_fut[i] = fut
                self._slot_cb[i] = cb
        return fresh, feats_new

    def _fail_active_slots(self, exc: Exception):
        """Resolve every active slot's future with ``exc`` and free it."""
        with self._slot_lock:
            for i in range(self.B):
                fut = self._slot_fut[i]
                if self._slot_t[i] >= 0 and fut is not None:
                    if not fut.done():
                        fut.set_exception(exc)
                    self._slot_t[i] = -1
                    self._slot_fut[i] = None
                    self._slot_cb[i] = None

    def _advance(self, fresh: np.ndarray, feats_new: np.ndarray):
        """Admission prologue + one chunk → host ``(ids [B, K],
        lps [B, K])``; the carried state stays on the device."""
        if fresh.any():
            mask = torch.from_numpy(fresh).to(self.device)
            feats = torch.from_numpy(feats_new).to(self.device,
                                                   self._x.dtype)
            zero = torch.zeros((), device=self.device)
            self._h = torch.where(mask[None, :, None], zero, self._h)
            self._c = torch.where(mask[None, :, None], zero, self._c)
            self._x = torch.where(mask[:, None], feats, self._x)
        ids, lps, (self._h, self._c, self._x) = decode_lib.decode_chunk(
            self._dec, self._x, self._h, self._c, self.K)
        # one device-to-host copy for both (the logprobs' bits as int32)
        both = torch.cat([ids, lps.view(torch.int32)], dim=1).cpu().numpy()
        return both[:, :self.K], both[:, self.K:].view(np.float32)

    def _loop(self):
        while not self._stop:
            if not (self._slot_t >= 0).any() and self._q.empty():
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            fresh, feats_new = self._fill_free_slots()
            if not (self._slot_t >= 0).any():
                continue
            try:
                ids_k, lps_k = self._advance(fresh, feats_new)
            except Exception as exc:
                self._fail_active_slots(exc)
                continue
            self.device_calls += 1
            self.slot_chunks += int((self._slot_t >= 0).sum())
            with self._slot_lock:  # close() may be failing slots meanwhile
                for i in range(self.B):
                    if self._slot_t[i] >= 0 and self._slot_fut[i] is not None:
                        self._commit(i, ids_k[i], lps_k[i])

    def _commit(self, i: int, ids_k: np.ndarray, lps_k: np.ndarray):
        """Slot ``i``'s chunk: store its tokens, stream them, and resolve
        the request when it is done (T tokens, or ``<E>`` under early
        exit)."""
        t = int(self._slot_t[i])
        k = min(self.K, self.T - t)
        self._ids[i, t:t + k] = ids_k[:k]
        self._lps[i, t:t + k] = lps_k[:k]
        done = t + k >= self.T
        if self.early_exit and not done:
            ends = np.flatnonzero(ids_k[:k] == END)
            if ends.size:
                # keep through the first <E>; void the tail
                cut = t + int(ends[0]) + 1
                self._ids[i, cut:] = 0
                self._lps[i, cut:] = 0.0
                done = True
        t += k
        if self._slot_cb[i] is not None and k:
            ids_now = self._ids[i, :t]
            ends = np.flatnonzero(ids_now == END)
            if ends.size:
                ids_now = ids_now[:int(ends[0]) + 1]
            try:
                self._slot_cb[i](ids_now.copy(), bool(done))
            except Exception:
                pass     # a stream consumer's error never touches the slot
        if done:
            lp = _masked_logprob_sum(self._ids[i:i + 1],
                                     self._lps[i:i + 1])[0]
            self._slot_fut[i].set_result((self._ids[i].copy(), float(lp)))
            self._slot_t[i] = -1
            self._slot_fut[i] = None
            self._slot_cb[i] = None
            self.completed += 1
        else:
            self._slot_t[i] = t
