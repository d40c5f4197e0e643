"""Speculative greedy decoding in the port against the JAX package on the
CPU (``tests/test_speculative.py``, ``tests/test_serving_engine.py:
211-283``), at narrow widths (2 layers, E = 10, H = 14, V = 35):
``speculative_greedy``'s ids and acceptance stats equal the JAX function's
and the port's greedy ids for the int8, a garbage and the self draft, any
``draft_len`` (past T too), and under ``early_stop``; it refuses a
non-LSTM target.  The speculative slots of ``ContinuousBatcher`` give the
JAX batch greedy captions (logprobs within 1e-4, the JAX test's
tolerance), every block commits K + 1 tokens with the self draft.  The
JAX reference runs in this (main) thread; no JAX engine is started.

The draft is the port's ``quantize_generator`` twin, whose payloads are
the JAX twin's byte for byte (``test_torch_port_quantize.py``)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.vocab import END, PAD
from gan_image_captioning_tpu.eval import decode as jdecode
from gan_image_captioning_tpu.eval.speculative import (
    speculative_greedy as jspec)
from gan_image_captioning_tpu.models import api as japi
from gan_image_captioning_tpu.ops.quantize import (
    quantize_generator as jquantize)
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.eval import decode as tdecode
from gan_image_captioning_tpu_torch.eval.speculative import (
    speculative_greedy)
from gan_image_captioning_tpu_torch.models.transformer import (
    init_transformer_generator_params)
from gan_image_captioning_tpu_torch.ops.quantize import quantize_generator
from gan_image_captioning_tpu_torch.serving import ContinuousBatcher

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

KW = dict(vocab_size=35, gen_embed_dim=10, gen_hidden_dim=14,
          gen_num_layers=2, max_seq_len=10)
LP_ATOL = 1e-4


def _pair(seed, **over):
    """(JAX params, JAX config, port generator, port config, features)."""
    kw = dict(KW, **over)
    jconfig, config = JConfig(**kw), Config(**kw)
    gp = japi.init_generator(jax.random.PRNGKey(seed), jconfig)
    gen = interop.generator_from_jax(jax.tree_util.tree_map(np.asarray, gp),
                                     config).requires_grad_(False)
    feats = np.random.default_rng(seed).standard_normal(
        (6, kw["gen_embed_dim"])).astype(np.float32)
    return gp, jconfig, gen, config, feats


def _drafts(kind, gp, jconfig, gen, config):
    """The same draft on both sides: the int8 twin, an unrelated random
    model, or the target itself."""
    if kind == "int8":
        return jquantize(gp, jconfig), quantize_generator(gen, config)
    if kind == "garbage":
        jd = japi.init_generator(jax.random.PRNGKey(999), jconfig)
        return jd, interop.generator_from_jax(
            jax.tree_util.tree_map(np.asarray, jd), config)
    return gp, gen


def _check(gp, jconfig, gen, config, feats, jdraft, tdraft, **kw):
    want, wstats = jspec(gp, jdraft, jnp.asarray(feats), jconfig,
                         return_stats=True, **kw)
    got, stats = speculative_greedy(gen, tdraft, torch.from_numpy(feats),
                                    config, return_stats=True, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == {k: int(v) for k, v in wstats.items()}
    return got.numpy(), stats


@pytest.mark.parametrize("draft_len", [1, 3, 4, 8])
def test_int8_draft_matches_jax_and_greedy(draft_len):
    gp, jconfig, gen, config, feats = _pair(0)
    jd, td = _drafts("int8", gp, jconfig, gen, config)
    got, stats = _check(gp, jconfig, gen, config, feats, jd, td,
                        draft_len=draft_len)
    greedy = tdecode.greedy(gen, torch.from_numpy(feats), config).numpy()
    np.testing.assert_array_equal(got, greedy)
    np.testing.assert_array_equal(got, np.asarray(jdecode.greedy(
        gp, jnp.asarray(feats), jconfig)))
    assert stats["proposed"] > 0 and stats["accepted"] > 0


@pytest.mark.parametrize("kind", ["garbage", "self"])
def test_any_draft_gives_the_greedy_ids(kind):
    """A garbage draft degenerates to one corrected token a block, the
    self draft accepts every proposal: the ids stay the greedy ones."""
    gp, jconfig, gen, config, feats = _pair(1)
    jd, td = _drafts(kind, gp, jconfig, gen, config)
    got, stats = _check(gp, jconfig, gen, config, feats, jd, td,
                        draft_len=5 if kind == "self" else 4)
    np.testing.assert_array_equal(
        got, tdecode.greedy(gen, torch.from_numpy(feats), config).numpy())
    if kind == "self":
        assert stats["accepted"] == stats["proposed"]
    else:
        assert stats["accepted"] < stats["proposed"]


def test_draft_len_exceeds_seq_len():
    gp, jconfig, gen, config, feats = _pair(3, max_seq_len=4)   # T = 6
    jd, td = _drafts("int8", gp, jconfig, gen, config)
    got, _ = _check(gp, jconfig, gen, config, feats, jd, td, draft_len=9)
    np.testing.assert_array_equal(
        got, tdecode.greedy(gen, torch.from_numpy(feats), config).numpy())


def test_early_stop_matches_jax():
    """``early_stop``: the caption through the first <E> unchanged, <PAD>
    past the ending block, both the JAX function's ids and stats; without
    it the full-T ids.  The decoder's <E> is boosted so that rows end at
    different steps."""
    gp, jconfig, gen, config, feats = _pair(0)
    b = np.asarray(gp["decoder"]["linear"]["b"]).copy()
    b[END] += 2.0
    gp = dict(gp, decoder=dict(gp["decoder"], linear=dict(
        gp["decoder"]["linear"], b=jnp.asarray(b))))
    gen = interop.generator_from_jax(jax.tree_util.tree_map(np.asarray, gp),
                                     config)
    jd, td = _drafts("int8", gp, jconfig, gen, config)
    full, _ = _check(gp, jconfig, gen, config, feats, jd, td, draft_len=3)
    early, _ = _check(gp, jconfig, gen, config, feats, jd, td, draft_len=3,
                      early_stop=True)
    ended = 0
    for f, e in zip(full, early):
        hits = np.flatnonzero(f == END)
        if hits.size:
            ended += 1
            cut = hits[0] + 1
            np.testing.assert_array_equal(e[:cut], f[:cut])
            np.testing.assert_array_equal(e[min(cut + 3, len(f)):], PAD)
        else:
            np.testing.assert_array_equal(e, f)
    assert ended >= 2


def test_rejects_non_lstm_target():
    config = Config(**dict(KW, gen_arch="transformer", gen_num_heads=2,
                           gen_embed_dim=16, gen_hidden_dim=32))
    tgen = init_transformer_generator_params(torch.Generator(), config)
    with pytest.raises(ValueError, match="LSTM"):
        speculative_greedy(tgen, tgen, torch.zeros(2, 16), config)
    _, _, gen, lconfig, _ = _pair(0)
    with pytest.raises(ValueError, match="LSTM"):
        speculative_greedy(gen, tgen, torch.zeros(2, 10), lconfig)
    with pytest.raises(ValueError, match="draft_len"):
        speculative_greedy(gen, gen, torch.zeros(2, 10), lconfig,
                           draft_len=0)


# ------------------------------------------------------- speculative slots

@pytest.fixture
def engines():
    made = []

    def make(*args, **kw):
        eng = ContinuousBatcher(*args, **kw)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.close()
        assert not eng._thread.is_alive()


def _jax_reference(gp, jconfig, feats):
    ids = jdecode.greedy(gp, jnp.asarray(feats), jconfig)
    lp = jdecode.sequence_logprob(gp, jnp.asarray(feats), ids, jconfig)
    return np.asarray(ids), np.asarray(lp)


@pytest.mark.parametrize("kind", ["self", "garbage"])
def test_speculative_slots_match_batch_greedy(engines, kind):
    """Target-exact for any draft, requests joining mid-flight (exact
    mode: all T ids)."""
    gp, jconfig, gen, config, feats = _pair(11)
    _, td = _drafts(kind, gp, jconfig, gen, config)
    ref_ids, ref_lp = _jax_reference(gp, jconfig, feats)
    eng = engines(gen, config, num_slots=3, chunk_steps=3, early_exit=False,
                  draft_params=td)
    futs = []
    for i in range(feats.shape[0]):
        futs.append(eng.submit(feats[i]))
        if i == 2:
            time.sleep(0.05)     # join mid-flight
    for i, fut in enumerate(futs):
        ids, lp = fut.result(timeout=60)
        np.testing.assert_array_equal(ids, ref_ids[i])
        np.testing.assert_allclose(lp, ref_lp[i], atol=LP_ATOL)


def test_speculative_slots_perfect_draft_accepts_all(engines):
    gp, jconfig, gen, config, feats = _pair(11)
    eng = engines(gen, config, num_slots=4, chunk_steps=2, early_exit=False,
                  draft_params=gen)
    for fut in eng.submit_many(list(feats[:4])):
        fut.result(timeout=60)
    st = eng.stats()
    assert st["tokens_per_slot_chunk"] == 3.0       # K + 1 every block
    assert st["tokens_committed"] == 4 * config.seq_len


def test_speculative_slots_int8_draft_early_exit(engines):
    """The serving pairing: the int8 twin drafts, early exit on: the
    greedy caption through its first <E>, then <PAD>."""
    gp, jconfig, gen, config, feats = _pair(11)
    ref_ids, ref_lp = _jax_reference(gp, jconfig, feats)
    eng = engines(gen, config, num_slots=2, chunk_steps=4,
                  draft_params=quantize_generator(gen, config))
    for i, fut in enumerate([eng.submit(f) for f in feats[:5]]):
        ids, lp = fut.result(timeout=60)
        want = ref_ids[i].copy()
        hits = np.flatnonzero(want == END)
        if hits.size:
            want[hits[0] + 1:] = PAD
        np.testing.assert_array_equal(ids, want)
        np.testing.assert_allclose(lp, ref_lp[i], atol=LP_ATOL)
    assert 1.0 <= eng.stats()["tokens_per_slot_chunk"] <= 5.0
