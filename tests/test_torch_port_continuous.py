"""The port's ``ContinuousBatcher`` (on the CPU: the plain carried-state
decodes), after the JAX package's engine tests
(``tests/test_serving_engine.py``, ``tests/test_serve_kernel.py``), on a
dense and on an int8 decoder.  The expected ids and logprobs come from the
JAX package's batch decode run in this (main) thread: ``greedy`` and
``sequence_logprob`` for the dense decoder, ``decode_sample_q_serve``
(interpret mode) for the quantized one.  Only the port's own torch
dispatcher threads are started here, never a JAX engine."""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.vocab import END
from gan_image_captioning_tpu.eval import decode as jdecode
from gan_image_captioning_tpu.kernels.decode_sample import (
    decode_sample_q_serve as jq_serve)
from gan_image_captioning_tpu.models import generator as jgen
from gan_image_captioning_tpu.ops import quantize as jq
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.eval import decode as tdecode
from gan_image_captioning_tpu_torch.interop import (generator_from_jax,
                                                    qdec_from_jax)
from gan_image_captioning_tpu_torch.serving import (ContinuousBatcher,
                                                    EngineOverloaded)

KINDS = ["dense", "int8"]
LP_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("GIC_KERNEL_INTERPRET", "1")


class Case:
    """One decoder on both sides: ``params`` (port) for the engine and
    ``reference(feats)`` → the JAX batch decode's ``(ids [b, T], lp [b])``
    as numpy."""

    def __init__(self, kind, b=6, end_bias=0.0, V=128, E=16, H=32,
                 max_seq_len=7, seed=11):
        kw = dict(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                  gen_num_layers=2, max_seq_len=max_seq_len)
        self.jconfig, self.config = JConfig(**kw), Config(**kw)
        jdec = jgen.init_decoder_params(jax.random.PRNGKey(seed),
                                        self.jconfig)
        tree = jax.tree_util.tree_map(np.asarray, {"decoder": jdec})
        bias = tree["decoder"]["linear"]["b"].copy()
        bias[END] += end_bias
        tree["decoder"]["linear"]["b"] = bias
        jdec = dict(jdec, linear=dict(jdec["linear"], b=jnp.asarray(bias)))
        self.feats = (np.random.default_rng(3).standard_normal((b, E))
                      * 0.5).astype(np.float32)
        if kind == "dense":
            self.jparams = {"decoder": jdec}
            self.params = generator_from_jax(tree, self.config)
        else:
            jqdec = jq.quantize_lstm_decoder(jdec, bits=8)
            self.jqdec = jqdec
            self.params = {"decoder": qdec_from_jax(
                jax.tree_util.tree_map(np.asarray, jqdec))}
        self.kind = kind
        self.T = self.config.seq_len

    def reference(self, feats=None):
        feats = jnp.asarray(self.feats if feats is None else feats)
        if self.kind == "dense":
            ids = jdecode.greedy(self.jparams, feats, self.jconfig)
            lp = jdecode.sequence_logprob(self.jparams, feats, ids,
                                          self.jconfig)
        else:
            ids, lps = jq_serve(feats, self.jqdec, self.T)
            lp = jdecode.masked_logprob_sum(ids, lps)
        return np.asarray(ids), np.asarray(lp)

    def engine(self, **kw):
        return ContinuousBatcher(self.params, self.config, **kw)


@pytest.fixture
def engines():
    """Closes every engine a test made, and checks its thread ended."""
    made = []

    def make(case, **kw):
        eng = case.engine(**kw)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.close()
        assert not eng._thread.is_alive()


def _result(fut, timeout=60):
    return fut.result(timeout=timeout)


@pytest.mark.parametrize("kind", KINDS)
def test_continuous_matches_batch_greedy(kind, engines):
    case = Case(kind, b=6)
    ref_ids, ref_lp = case.reference()
    assert len(np.unique(ref_ids)) > 3
    eng = engines(case, num_slots=3, chunk_steps=4)
    futs = []
    for i in range(6):   # more requests than slots, arriving over time
        futs.append(eng.submit(case.feats[i]))
        if i == 2:
            time.sleep(0.05)     # let the pool start mid-flight
    for i, fut in enumerate(futs):
        ids, lp = _result(fut)
        np.testing.assert_array_equal(ids[:_upto(ids)],
                                      ref_ids[i][:_upto(ids)])
        np.testing.assert_allclose(lp, ref_lp[i], atol=LP_ATOL)


def _upto(ids):
    """Positions up to and including the first <E> (all when none)."""
    ends = np.flatnonzero(np.asarray(ids) == END)
    return int(ends[0]) + 1 if ends.size else len(ids)


@pytest.mark.parametrize("kind", KINDS)
def test_continuous_reuses_slots(kind, engines):
    case = Case(kind, b=8)
    ref_ids, _ = case.reference()
    eng = engines(case, num_slots=2, chunk_steps=7, early_exit=False)
    futs = [eng.submit(case.feats[i]) for i in range(8)]
    for i, fut in enumerate(futs):
        np.testing.assert_array_equal(_result(fut)[0], ref_ids[i])
    stats = eng.stats()
    assert stats["completed"] == 8 and stats["active_slots"] == 0
    # 8 captions of T = 9 tokens at 7 per chunk: 2 chunks each, 2 slots
    assert stats["device_calls"] >= 8 and 0.0 < stats["occupancy"] <= 1.0


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_slots_match_batch_greedy(kind, engines):
    """``tests/test_serve_kernel.py``'s geometry (B = 4, T = 8, V = 256,
    E = H = 32): 4 slots, 3-step chunks, exact mode."""
    case = Case(kind, b=4, V=256, E=32, H=32, max_seq_len=6, seed=3)
    ref_ids, _ = case.reference()
    eng = engines(case, num_slots=4, chunk_steps=3, early_exit=False)
    futs = [eng.submit(case.feats[i]) for i in range(4)]
    got = np.stack([_result(f)[0] for f in futs])
    np.testing.assert_array_equal(got, ref_ids)


@pytest.mark.parametrize("kind", KINDS)
def test_continuous_early_exit_releases_slots(kind, engines):
    """Captions that end at t = 0 free their slot after one chunk: N
    requests cost about N chunks, not N * ceil(T / K); the tail is <PAD>
    and the logprob is the reference's masked sum."""
    case = Case(kind, b=3, end_bias=100.0)
    _, ref_lp = case.reference()
    eng = engines(case, num_slots=1, chunk_steps=2)
    futs = [eng.submit(case.feats[i]) for i in range(3)]
    for i, fut in enumerate(futs):
        ids, lp = _result(fut)
        assert ids[0] == END
        np.testing.assert_array_equal(ids[1:], 0)
        np.testing.assert_allclose(lp, ref_lp[i], atol=LP_ATOL)
    assert eng.device_calls <= 6, eng.stats()
    assert eng.stats()["completed"] == 3


@pytest.mark.parametrize("kind", KINDS)
def test_continuous_exact_mode_bit_identity(kind, engines):
    """early_exit=False runs every slot the full T steps: ids equal the
    batch greedy decode's even when <E> comes at t = 0."""
    case = Case(kind, b=2, end_bias=100.0)
    ref_ids, _ = case.reference()
    eng = engines(case, num_slots=2, chunk_steps=3, early_exit=False)
    futs = [eng.submit(case.feats[i]) for i in range(2)]
    for i, fut in enumerate(futs):
        np.testing.assert_array_equal(_result(fut)[0], ref_ids[i])


def _hold(eng):
    """Make ``eng._advance`` wait on the returned event (set = go)."""
    release, entered = threading.Event(), threading.Event()
    real = eng._advance

    def held(*args):
        entered.set()
        assert release.wait(timeout=30)
        return real(*args)

    eng._advance = held
    return release, entered


@pytest.mark.parametrize("kind", KINDS)
def test_close_fails_stranded_requests(kind, engines):
    """close() resolves the request in a slot and the queued one with an
    error: a client waiting on result() does not hang to its timeout."""
    case = Case(kind, b=2)
    eng = engines(case, num_slots=1, chunk_steps=2, early_exit=False)
    release, entered = _hold(eng)
    running = eng.submit(case.feats[0])
    assert entered.wait(timeout=30)
    queued = eng.submit(case.feats[1])
    closer = threading.Thread(target=eng.close)
    closer.start()
    deadline = time.monotonic() + 30
    while not eng._stop and time.monotonic() < deadline:
        time.sleep(0.01)
    release.set()
    closer.join(timeout=30)
    assert not closer.is_alive()
    for fut in (running, queued):
        with pytest.raises(RuntimeError, match="closed"):
            _result(fut, timeout=10)


@pytest.mark.parametrize("kind", KINDS)
def test_submit_after_close_raises_immediately(kind, engines):
    case = Case(kind, b=1)
    eng = engines(case, num_slots=1, chunk_steps=2)
    _result(eng.submit(case.feats[0]))
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(case.feats[0])
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit_many([case.feats[0]])


@pytest.mark.parametrize("kind", KINDS)
def test_admission_control_rejects_fast(kind, engines):
    """max_pending: a multi-row request that does not fit is rejected
    whole (none of its rows queued); one that fits completes."""
    case = Case(kind, b=1)
    eng = engines(case, num_slots=1, chunk_steps=2, max_pending=2)
    rows = [case.feats[0]] * 3
    with pytest.raises(EngineOverloaded):
        eng.submit_many(rows)
    assert eng.stats()["queue_depth"] == 0 and eng.stats()["rejected"] == 3
    for fut in eng.submit_many(rows[:2]):
        _result(fut)
    assert eng.stats()["completed"] == 2


@pytest.mark.parametrize("kind", KINDS)
def test_streaming_callback_progress(kind, engines):
    """on_tokens streams per-chunk progress: prefix-monotone snapshots, an
    intermediate (done=False) event, the last snapshot equal to the
    resolved caption through its first <E>; callback errors never touch
    the future."""
    case = Case(kind, b=2)
    eng = engines(case, num_slots=2, chunk_steps=2)
    events = []

    def on_tokens(j, ids, done):
        events.append((j, np.asarray(ids).copy(), done))
        raise RuntimeError("stream consumer bug")   # must be swallowed

    futs = eng.submit_many([case.feats[0], case.feats[1]],
                           on_tokens=on_tokens)
    results = [_result(f) for f in futs]
    for j in range(2):
        evs = [(ids, done) for (r, ids, done) in events if r == j]
        assert evs and any(not done for _, done in evs)
        for (a, _), (b, _) in zip(evs, evs[1:]):
            np.testing.assert_array_equal(a, b[:len(a)])
        assert evs[-1][1] is True
        final = results[j][0]
        np.testing.assert_array_equal(evs[-1][0], final[:_upto(final)])


@pytest.mark.parametrize("kind", KINDS)
def test_bad_row_and_failed_chunk_fail_only_their_requests(kind, engines,
                                                           monkeypatch):
    case = Case(kind, b=2)
    ref_ids, _ = case.reference()
    eng = engines(case, num_slots=2, chunk_steps=4, early_exit=False)
    with pytest.raises(ValueError, match="shape"):
        _result(eng.submit(np.zeros(5, np.float32)))
    real = tdecode.decode_chunk
    calls = []

    def flaky(*args):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("device fault")
        return real(*args)

    monkeypatch.setattr(tdecode, "decode_chunk", flaky)
    with pytest.raises(RuntimeError, match="device fault"):
        _result(eng.submit(case.feats[0]))
    np.testing.assert_array_equal(_result(eng.submit(case.feats[1]))[0],
                                  ref_ids[1])
    assert eng.stats()["active_slots"] == 0


def test_many_submitting_threads_get_their_own_rows(engines):
    """More submitters than cores, with a short switch interval: every
    request resolves to its own row's caption and no counter loses an
    update."""
    case = Case("dense", b=6)
    ref_ids, _ = case.reference()
    eng = engines(case, num_slots=4, chunk_steps=3)
    n_threads, per_thread = 12, 3
    errors = []

    def client(tid):
        try:
            for i in range(per_thread):
                row = (tid + i) % len(case.feats)
                ids, _ = _result(eng.submit(case.feats[row]))
                np.testing.assert_array_equal(ids[:_upto(ids)],
                                              ref_ids[row][:_upto(ids)])
        except Exception as exc:  # reported below, in the main thread
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    stats = eng.stats()
    assert stats["completed"] == n_threads * per_thread
    assert stats["active_slots"] == 0 and stats["queue_depth"] == 0


def test_continuous_refuses_transformer_slots():
    case = Case("dense", b=1)
    with pytest.raises(NotImplementedError, match="LSTM"):
        ContinuousBatcher(case.params,
                          case.config.replace(gen_arch="transformer"))
