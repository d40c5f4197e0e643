"""Serving engines (``gan_image_captioning_tpu/serving.py``).

* :class:`CoalescingBatcher`: one dispatcher thread owns the device;
  requests from any connection or thread enqueue and are drained into
  shared fixed-shape decode batches, so K concurrent one-caption requests
  cost about one decode, not K.
* :class:`ContinuousBatcher`: a pool of decode slots advances
  ``chunk_steps`` tokens per device call with each slot's decoder state
  carried on the device; new requests take free slots at chunk
  boundaries instead of waiting for a whole batch.  LSTM slots carry
  ``(h, c)`` and the next input ``x``, and a chunk is one call of the
  carried-state serve decode (dense or quantized: the kernel on the card,
  its plain version on the CPU).  Transformer slots carry a KV cache and a
  position per slot (``models/transformer.py:decode_step_slots``), a
  conditional transformer's slot its grid's cross-attention keys and
  values too.  Speculative slots (``draft_params``) commit 1 to K + 1
  target-exact tokens a slot per chunk (``eval/speculative.py``'s block).

Both return per-caption greedy log-probabilities with
``eval/decode.py:sequence_logprob``'s mask (up to and including the first
``<E>``).  Not ported: ``--mesh``.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future

import numpy as np
import torch

from gan_image_captioning_tpu_torch.data.vocab import END
from gan_image_captioning_tpu_torch.eval import decode as decode_lib
from gan_image_captioning_tpu_torch.eval import speculative as spec_lib
from gan_image_captioning_tpu_torch.models import lstm as lstm_lib
from gan_image_captioning_tpu_torch.models import transformer as tf_lib
from gan_image_captioning_tpu_torch.models.discriminator import params_of
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


def _greedy_pick(logits):
    """argmax ids and their float32 log-probabilities of ``[B, V]``
    logits."""
    ids = torch.argmax(logits, dim=-1)
    lp = torch.log_softmax(logits, dim=-1).gather(1, ids[:, None])[:, 0]
    return ids, lp.to(torch.float32)


class _LstmSlots:
    """LSTM slots: the carried ``(h, c, x)``; a chunk is one
    :func:`eval.decode.decode_chunk` call (the carried-state serve kernel,
    dense or quantized).  Fresh slots get a zero state and their feature
    row as the t = 0 input."""

    def __init__(self, generator, config, num_slots: int, chunk: int):
        self.dec = decode_lib.decoder_of(generator)
        self.h, self.c = decode_lib.make_stepper(
            generator, config).init_state(num_slots)
        self.device = self.h.device
        embed = (self.dec["embed"].scale if q_lib.is_quantized(self.dec)
                 else self.dec.embed.weight)
        self.row_dim = embed.shape[-1]
        # x in the state's dtype (the JAX engine's x_dtype): bfloat16 in a
        # bfloat16 quantized decode
        self.x = torch.zeros((num_slots, self.row_dim), dtype=self.h.dtype,
                             device=self.device)
        self.chunk = chunk

    def advance(self, fresh: np.ndarray, rows: np.ndarray):
        if fresh.any():
            mask = torch.from_numpy(fresh).to(self.device)
            feats = torch.from_numpy(rows).to(self.device, self.x.dtype)
            zero = torch.zeros((), device=self.device)
            self.h = torch.where(mask[None, :, None], zero, self.h)
            self.c = torch.where(mask[None, :, None], zero, self.c)
            self.x = torch.where(mask[:, None], feats, self.x)
        ids, lps, (self.h, self.c, self.x) = decode_lib.decode_chunk(
            self.dec, self.x, self.h, self.c, self.chunk)
        return ids, lps, None


class _TransformerSlots:
    """Transformer slots (the JAX engine's transformer branch): a fixed KV
    cache ``[layers, B, T + 1, heads, head_dim]`` and a position per slot;
    a chunk is ``chunk`` steps of :func:`models.transformer.
    decode_step_slots`.  Admission installs the feature row as the t = 0
    input and rewinds the position; the cache is not zeroed (the mask
    attends only positions the occupant has written), and a free slot's
    position stops at the cache's last one.  A conditional transformer's
    row carries its grid after the features (``context_shape [P, C]``):
    its cross-attention keys and values are made once, at admission, into
    the slot's own buffers (:func:`models.transformer.cross_kv` after the
    ``ctx_proj`` shape rule)."""

    def __init__(self, generator, config, num_slots: int, chunk: int,
                 context_shape=None):
        self.p = params_of(decode_lib.decoder_of(generator))
        self.config, self.chunk = config, chunk
        embed = self.p["embed"]
        self.device, dtype = embed.device, embed.dtype
        self.d = embed.shape[-1]
        self.k, self.v = tf_lib.init_slot_cache(config, num_slots, dtype,
                                                self.device)
        self.tv = torch.zeros(num_slots, dtype=torch.long,
                              device=self.device)
        self.x = torch.zeros((num_slots, self.d), dtype=dtype,
                             device=self.device)
        self.context_shape = context_shape
        self.cross = None
        self.row_dim = self.d
        if context_shape is not None:
            h = config.gen_num_heads
            shape = (num_slots, context_shape[0], h, self.d // h)
            self.cross = [(torch.zeros(shape, dtype=dtype, device=self.device),
                           torch.zeros(shape, dtype=dtype, device=self.device))
                          for _ in range(config.gen_num_layers)]
            self.row_dim += int(np.prod(context_shape))

    def buffer_bytes(self) -> int:
        """Bytes the pool's caches hold (keys, values, cross keys and
        values)."""
        bufs = [self.k, self.v] + [t for kv in self.cross or () for t in kv]
        return sum(t.numel() * t.element_size() for t in bufs)

    def advance(self, fresh: np.ndarray, rows: np.ndarray):
        p, d = self.p, self.d
        if fresh.any():
            mask = torch.from_numpy(fresh).to(self.device)
            feats = torch.from_numpy(rows).to(self.device, self.x.dtype)
            self.x = torch.where(mask[:, None], feats[:, :d], self.x)
            self.tv = torch.where(mask, 0, self.tv)
            if self.cross is not None:
                idx = torch.from_numpy(np.flatnonzero(fresh)).to(self.device)
                ctx = feats[idx, d:].reshape(-1, *self.context_shape)
                made = tf_lib.cross_kv(
                    p, tf_lib.project_context(p, ctx, d),
                    self.config.gen_num_heads)
                for (ck, cv), (nk, nv) in zip(self.cross, made):
                    ck[idx] = nk
                    cv[idx] = nv
        last = self.k.shape[2] - 1
        ids, lps = [], []
        for _ in range(self.chunk):
            logits, self.k, self.v = tf_lib.decode_step_slots(
                p, self.config, self.x, self.k, self.v, self.tv, self.cross)
            ids_t, lp = _greedy_pick(logits)
            ids.append(ids_t.to(torch.int32))
            lps.append(lp)
            self.tv = torch.clamp(self.tv + 1, max=last)
            self.x = p["embed"][ids_t]
        return torch.stack(ids, dim=1), torch.stack(lps, dim=1), None


class _SpeculativeSlots:
    """Speculative slots (the JAX engine's ``draft_params`` branch), LSTM
    target only: per chunk each slot's draft proposes ``chunk`` tokens
    from its last committed token (K + 1 draft steps), the target runs its
    recurrence over them and projects all K + 1 hidden states in one
    product, and the accepted prefix plus the corrected or bonus token
    commit: 1 to K + 1 tokens a slot.  Both states roll back to the
    accepted prefix per slot.  A fresh slot's first block starts from its
    feature row (the un-speculated t = 0 step folded in)."""

    def __init__(self, generator, draft, config, num_slots: int,
                 chunk: int):
        spec_lib.check_pair(generator, draft)
        self.target = spec_lib.Verifier(generator.decoder)
        self.draft = decode_lib.make_stepper(draft, config)
        emb = self.target.embed
        self.device = emb.device
        self.S = lstm_lib.zero_state(self.target.layers, num_slots,
                                     self.target.hidden, emb.dtype,
                                     self.device)
        self.D = self.draft.init_state(num_slots)
        self.y = torch.zeros(num_slots, dtype=torch.long, device=self.device)
        self.row_dim = emb.shape[-1]
        self.chunk = chunk

    def advance(self, fresh: np.ndarray, rows: np.ndarray):
        x_t = self.target.embed[self.y]
        x_d = self.draft.embed(self.y)
        if fresh.any():
            mask = torch.from_numpy(fresh).to(self.device)
            feats = torch.from_numpy(rows).to(self.device)
            zero = torch.zeros((), device=self.device)
            self.S = tuple(torch.where(mask[None, :, None], zero, s)
                           for s in self.S)
            self.D = tuple(torch.where(mask[None, :, None], zero, s)
                           for s in self.D)
            self.y = torch.where(mask, 0, self.y)
            x_t = torch.where(mask[:, None], feats.to(x_t.dtype), x_t)
            x_d = torch.where(mask[:, None], feats.to(x_d.dtype), x_d)
        d_toks, d_states = spec_lib.draft_block(self.draft, self.D, x_d,
                                                self.chunk)
        block, logp, n, t_states = self.target.run(self.S, x_t, d_toks)
        blk_lp = logp.gather(2, block[..., None])[..., 0]
        self.S = tuple(spec_lib.select_rows(s, n) for s in t_states)
        self.D = tuple(spec_lib.select_rows(s, n) for s in d_states)
        self.y = block.gather(0, n[None])[0]
        return (block.T.to(torch.int32), blk_lp.T.to(torch.float32),
                (n + 1).to(torch.int32))


class ContinuousBatcher:
    """Slot-pool continuous batching over the greedy decode.

    One device call per chunk, :meth:`_advance`: an admission prologue
    (slots marked ``fresh`` take their feature row as the t = 0 input)
    followed by a chunk of greedy tokens for ALL slots.  Free slots keep
    computing (their output is ignored).

    ``generator``: a port ``Generator`` or its quantized twin
    (``ops/quantize.py:quantize_generator``), or a ``TransformerGenerator``
    (its fake-quantized twin too); the device is the one its weights lie
    on.  LSTM slots decode ``chunk_steps`` tokens per chunk with the
    carried-state serve decode, transformer slots ``chunk_steps`` steps of
    :func:`models.transformer.decode_step_slots` (``context_shape``: a
    conditional transformer's grid ``[P, C]``, carried in each row after
    the features).  ``draft_params``: speculative slots over a
    full-precision LSTM target, ``chunk_steps`` draft tokens a block
    (:class:`_SpeculativeSlots`).  ``early_exit``: a slot whose chunk
    emitted ``<E>`` frees at that chunk boundary and its ids after the
    first ``<E>`` are ``<PAD>``; ``False`` runs every slot the full T
    steps, so ids equal the full batch greedy decode (``--serve-exact``).
    ``max_pending`` > 0 bounds the queue (:class:`EngineOverloaded`).
    """

    def __init__(self, generator, config, num_slots: int = 8,
                 chunk_steps: int = 8, early_exit: bool = True,
                 max_pending: int = 0, draft_params=None,
                 context_shape=None):
        self.max_pending = int(max_pending)  # 0 = unbounded
        self.rejected = 0
        self.config = config
        self.T = config.seq_len
        self.B = int(num_slots)
        self.K = min(int(chunk_steps), self.T)
        self.early_exit = early_exit
        transformer = isinstance(decode_lib.decoder_of(generator),
                                 tf_lib.TransformerDecoder)
        if context_shape is not None and not transformer:
            raise ValueError("a grid in the slot rows needs a conditional "
                             "transformer generator")
        self._speculative = draft_params is not None
        if self._speculative:
            # the JAX refusals: speculation needs a full-precision LSTM
            # target (spec_lib.check_pair raises for the rest)
            self._slots = _SpeculativeSlots(generator, draft_params, config,
                                            self.B, self.K)
        elif transformer:
            self._slots = _TransformerSlots(generator, config, self.B, self.K,
                                            context_shape)
        else:
            self._slots = _LstmSlots(generator, config, self.B, self.K)
        self.device = self._slots.device
        self._feat_dim = self._slots.row_dim
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
        self.tokens_committed = 0
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
        slots doing useful work per device call; speculative slots add
        ``tokens_committed`` and ``tokens_per_slot_chunk`` (1 to K + 1: the
        speculation's gain over one token a step)."""
        dc = self.device_calls
        out = {
            "device_calls": dc,
            "completed": self.completed,
            "queue_depth": self._q.qsize(),
            "active_slots": int((self._slot_t >= 0).sum()),
            "occupancy": round(self.slot_chunks / (dc * self.B), 4)
            if dc else 0.0,
            "rejected": self.rejected,
        }
        if self._speculative:
            out["tokens_committed"] = self.tokens_committed
            if self.slot_chunks:
                out["tokens_per_slot_chunk"] = round(
                    self.tokens_committed / self.slot_chunks, 3)
        return out

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
        """Admission prologue + one chunk → host ``(ids [B, W], lps
        [B, W], counts [B])``, each slot's first ``counts`` tokens
        committed; the carried state stays on the device."""
        ids, lps, counts = self._slots.advance(fresh, feats_new)
        w = ids.shape[1]
        parts = [ids.to(torch.int32), lps.view(torch.int32)]
        if counts is not None:
            parts.append(counts[:, None])
        # one device-to-host copy for all (the logprobs' bits as int32)
        host = torch.cat(parts, dim=1).cpu().numpy()
        counts = (host[:, 2 * w] if counts is not None
                  else np.full((self.B,), w, np.int32))
        return host[:, :w], host[:, w:2 * w].view(np.float32), counts

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
                ids_k, lps_k, counts = self._advance(fresh, feats_new)
            except Exception as exc:
                self._fail_active_slots(exc)
                continue
            self.device_calls += 1
            self.slot_chunks += int((self._slot_t >= 0).sum())
            with self._slot_lock:  # close() may be failing slots meanwhile
                for i in range(self.B):
                    if self._slot_t[i] >= 0 and self._slot_fut[i] is not None:
                        self._commit(i, ids_k[i], lps_k[i], int(counts[i]))

    def _commit(self, i: int, ids_k: np.ndarray, lps_k: np.ndarray,
                count: int):
        """Slot ``i``'s chunk: store its first ``count`` tokens, stream
        them, and resolve the request when it is done (T tokens, or
        ``<E>`` under early exit)."""
        t = int(self._slot_t[i])
        k = min(count, self.T - t)
        self.tokens_committed += k
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
