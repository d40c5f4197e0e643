"""Transformer serving in the port against the JAX package on the CPU, at
narrow widths (2 layers, 2 heads, E = 32, V = 48): ``decode_step_slots``
step by step at mixed positions (with and without a context); the
continuous engine's transformer slots (exact and early-exit modes, after
``tests/test_serving_engine.py:33-150``) and a conditional transformer's
slots carrying their grid; the transformer's adaptive decode (after
``tests/test_decode.py:196``); ``fake_quantize_tree`` and the quantized
transformer (after ``tests/test_quantize.py:182``).  The JAX reference
runs in this (main) thread: no JAX serving engine is started.

Weights are the JAX package's initial ones scaled by ``PEAK`` (as in
``test_torch_port_cond_transformer.py``) so that no greedy step is a
near-tie.  Tolerance: logits and caches atol 1e-5 / rtol 1e-5 (float32
sums in another order), sequence logprobs atol 1e-5, ids equal,
``fake_quantize_tree`` bit-equal."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.vocab import END, PAD
from gan_image_captioning_tpu.eval import decode as jdecode
from gan_image_captioning_tpu.models import api as japi
from gan_image_captioning_tpu.models import transformer as jtf
from gan_image_captioning_tpu.ops import quantize as jq
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.eval import decode as tdecode
from gan_image_captioning_tpu_torch.models import transformer as ttf
from gan_image_captioning_tpu_torch.ops import quantize as tq
from gan_image_captioning_tpu_torch.serving import ContinuousBatcher

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

V, E, P, C = 48, 32, 4, 512
PEAK = 8.0
KW = dict(vocab_size=V, gen_arch="transformer", gen_embed_dim=E,
          gen_hidden_dim=128, gen_num_layers=2, gen_num_heads=2,
          max_seq_len=6)
VAL = dict(atol=1e-5, rtol=1e-5)
LP_ATOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rig_end(gp, boost=100.0):
    """``<E>`` the argmax at every step (``tests/test_decode.py``)."""
    b = np.asarray(gp["decoder"]["linear"]["b"]).copy()
    b[END] += boost
    dec = dict(gp["decoder"], linear=dict(gp["decoder"]["linear"],
                                          b=jnp.asarray(b)))
    return dict(gp, decoder=dec)


def _models(seed=0, rig=False):
    """(JAX params, JAX config, port generator, port config)."""
    jconfig, config = JConfig(**KW), Config(**KW)
    gp = jax.tree_util.tree_map(
        lambda a: a * PEAK, japi.init_generator(jax.random.PRNGKey(seed),
                                                jconfig))
    if rig:
        gp = _rig_end(gp)
    gen = interop.transformer_generator_from_jax(_np(gp), config)
    return gp, jconfig, gen.requires_grad_(False), config


@pytest.fixture(scope="module")
def models():
    return _models()


def _inputs(n, seed=1):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, E)).astype(np.float32)
    ctx = rng.standard_normal((n, P, C)).astype(np.float32)
    return feats, ctx


def _reference(gp, jconfig, feats, ctx=None):
    """The JAX batch greedy decode's ids and sequence logprobs."""
    jc = None if ctx is None else jnp.asarray(ctx)
    ids, lp = jdecode.greedy_with_logprobs(gp, jnp.asarray(feats), jconfig,
                                           context=jc, allow_kernel=False)
    return np.asarray(ids), np.asarray(lp)


def _canon(ids):
    """Everything after each row's first <E> voided."""
    ids = np.asarray(ids).copy()
    for row in ids:
        hits = np.flatnonzero(row == END)
        if hits.size:
            row[hits[0] + 1:] = PAD
    return ids


# ------------------------------------------------------- decode_step_slots

# positions per step for 4 rows: rows start apart, row 2 is re-admitted at
# step 4 (back to 0 over a cache holding its old keys), rows stop at the
# cache's last position
SCHEDULE = np.array([[0, 2, 1, 4], [1, 3, 2, 5], [2, 4, 3, 6],
                     [3, 5, 4, 6], [4, 6, 0, 6], [5, 6, 1, 6],
                     [6, 6, 2, 6]], np.int32)


@pytest.mark.parametrize("context", [False, True], ids=["plain", "context"])
def test_decode_step_slots_matches_jax_step_by_step(models, context):
    gp, jconfig, gen, config = models
    n = SCHEDULE.shape[1]
    feats, ctx = _inputs(n, 2)
    jdec = gp["decoder"]
    jctx = cross = None
    if context:
        jctx = jtf.dense(jdec["ctx_proj"], jnp.asarray(ctx))
        p = ttf.params_of(gen.decoder)
        cross = ttf.cross_kv(p, ttf.project_context(p, torch.from_numpy(ctx),
                                                    E), config.gen_num_heads)
    jk, jv = jtf._init_kv_cache(jconfig, n, jnp.float32)
    k, v = ttf.init_slot_cache(config, n)
    assert k.shape == jk.shape == (2, n, config.seq_len + 1, 2, E // 2)
    rng = np.random.default_rng(3)
    step = jax.jit(lambda x, k_, v_, t: jtf.decode_step_slots(
        jdec, jconfig, x, k_, v_, t, jctx))
    for t_vec in SCHEDULE:
        x = rng.standard_normal((n, E)).astype(np.float32)
        jl, jk, jv = step(jnp.asarray(x), jk, jv, jnp.asarray(t_vec))
        logits, k, v = ttf.decode_step_slots(
            gen.decoder, config, torch.from_numpy(x), k, v,
            torch.from_numpy(t_vec), cross)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **VAL)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), **VAL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **VAL)


def test_decode_step_slots_at_one_position_is_decode_step(models):
    """At one position for every row, the slot step is the growing-cache
    step: the masked positions weigh nothing."""
    _, _, gen, config = models
    feats, _ = _inputs(3, 4)
    k, v = ttf.init_slot_cache(config, 3)
    gk, gv = ttf._init_kv_cache(config, 3)
    x = torch.from_numpy(feats)
    for t in range(3):
        a, k, v = ttf.decode_step_slots(gen.decoder, config, x, k, v,
                                        torch.full((3,), t))
        b, gk, gv = ttf.decode_step(gen.decoder, config, x, gk, gv, t)
        torch.testing.assert_close(a, b, **VAL)
        x = gen.decoder.embed[torch.argmax(a, dim=-1)]


# ---------------------------------------------------- transformer slots

def _engine(gen, config, **kw):
    return ContinuousBatcher(gen, config, **kw)


@pytest.fixture
def engines():
    """Closes every engine a test made, and checks its thread ended."""
    made = []

    def make(*args, **kw):
        eng = _engine(*args, **kw)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.close()
        assert not eng._thread.is_alive()


@pytest.mark.parametrize("early_exit", [False, True], ids=["exact", "early"])
def test_transformer_slots_match_jax_greedy(models, engines, early_exit):
    """More requests than slots, joining mid-flight: each caption is the
    JAX batch greedy decode of its row (exact mode: all T ids; early exit:
    through the first <E>, then <PAD>), logprobs within LP_ATOL."""
    gp, jconfig, gen, config = models
    feats, _ = _inputs(6, 5)
    ref_ids, ref_lp = _reference(gp, jconfig, feats)
    assert len(np.unique(ref_ids)) > 3
    eng = engines(gen, config, num_slots=3, chunk_steps=4,
                  early_exit=early_exit)
    futs = []
    for i in range(6):
        futs.append(eng.submit(feats[i]))
        if i == 2:
            time.sleep(0.05)     # let the pool start mid-flight
    want = ref_ids if not early_exit else _canon(ref_ids)
    for i, fut in enumerate(futs):
        ids, lp = fut.result(timeout=60)
        np.testing.assert_array_equal(ids, want[i])
        np.testing.assert_allclose(lp, ref_lp[i], atol=LP_ATOL)
    assert eng.stats()["completed"] == 6


def test_transformer_slots_reuse_and_early_release(engines):
    """An <E>-rigged decoder on one slot: every caption is [<E>, <PAD> …]
    and a slot frees after its first chunk (N requests in about N calls,
    not N · ceil(T / K)); exact mode still gives all T ids."""
    gp, jconfig, gen, config = _models(seed=1, rig=True)
    feats, _ = _inputs(3, 6)
    ref_ids, ref_lp = _reference(gp, jconfig, feats)
    eng = engines(gen, config, num_slots=1, chunk_steps=2)
    futs = [eng.submit(feats[i]) for i in range(3)]
    for i, fut in enumerate(futs):
        ids, lp = fut.result(timeout=60)
        assert ids[0] == END
        np.testing.assert_array_equal(ids[1:], PAD)
        np.testing.assert_allclose(lp, ref_lp[i], atol=LP_ATOL)
    assert eng.device_calls <= 6, eng.stats()
    exact = engines(gen, config, num_slots=2, chunk_steps=3, early_exit=False)
    for i, fut in enumerate([exact.submit(feats[i]) for i in range(2)]):
        np.testing.assert_array_equal(fut.result(timeout=60)[0], ref_ids[i])


def test_conditional_slots_carry_their_grid(engines):
    """A conditional transformer's slot rows are ``[features | grid]``:
    the captions are the JAX batch greedy decode over each row's grid (the
    512-wide grid through ``ctx_proj``), equal to the port's coalescing
    decode, and unlike the same rows decoded without their grid."""
    gp, jconfig, gen, config = _models(seed=2)
    feats, ctx = _inputs(5, 7)
    ref_ids, ref_lp = _reference(gp, jconfig, feats, ctx)
    ids_c, lp_c = tdecode.greedy_with_logprobs(
        gen, torch.from_numpy(feats), config, context=torch.from_numpy(ctx))
    np.testing.assert_array_equal(ids_c.numpy(), ref_ids)
    bare, _ = _reference(gp, jconfig, feats)
    assert (bare != ref_ids).any()
    eng = engines(gen, config, num_slots=2, chunk_steps=3, early_exit=False,
                  context_shape=(P, C))
    rows = np.concatenate([feats, ctx.reshape(5, -1)], axis=1)
    futs = eng.submit_many(list(rows))
    for i, fut in enumerate(futs):
        ids, lp = fut.result(timeout=60)
        np.testing.assert_array_equal(ids, ref_ids[i])
        np.testing.assert_allclose(lp, ref_lp[i], atol=LP_ATOL)
        np.testing.assert_allclose(lp, lp_c[i].item(), atol=LP_ATOL)
    with pytest.raises(ValueError, match="shape"):
        eng.submit(feats[0]).result(timeout=60)   # a row without its grid


# --------------------------------------------------------- adaptive decode

@pytest.mark.parametrize("case", ["plain", "context", "rigged"])
def test_adaptive_transformer_matches_jax(case):
    """The transformer's early-stopping decode against the JAX
    ``greedy_with_logprobs_adaptive`` (its stepper branch) and the full
    greedy decode: ids through each row's first <E> then <PAD>, the
    sequence logprobs within LP_ATOL."""
    gp, jconfig, gen, config = _models(seed=3, rig=case == "rigged")
    feats, ctx = _inputs(4, 8)
    use_ctx = ctx if case == "context" else None
    jc = None if use_ctx is None else jnp.asarray(use_ctx)
    tc = None if use_ctx is None else torch.from_numpy(use_ctx)
    want_ids, want_lp = jdecode.greedy_with_logprobs_adaptive(
        gp, jnp.asarray(feats), jconfig, context=jc, chunk=4)
    ids, lp = tdecode.greedy_with_logprobs_adaptive(
        gen, torch.from_numpy(feats), config, context=tc, chunk=4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), atol=LP_ATOL)
    full_ids, full_lp = tdecode.greedy_with_logprobs(
        gen, torch.from_numpy(feats), config, context=tc)
    np.testing.assert_array_equal(ids.numpy(), _canon(full_ids.numpy()))
    np.testing.assert_allclose(lp.numpy(), full_lp.numpy(), atol=LP_ATOL)
    if case == "rigged":
        assert (ids.numpy()[:, 0] == END).all()
        np.testing.assert_array_equal(ids.numpy()[:, 1:], PAD)


# ------------------------------------------------------ fake quantization

@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quantize_tree_is_bit_equal_to_jax(bits):
    """Nested dicts, lists and tuples; matrices above and below
    ``min_size``, a vector, an integer leaf, a zero channel and a
    bfloat16 leaf: every leaf bit-equal to the JAX function's."""
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((96, 64)).astype(np.float32) * 3.0
    w[:, 5] = 0.0                                     # a zero channel
    tree = {"a": w, "b": [rng.standard_normal((8, 8)).astype(np.float32),
                          (rng.standard_normal((3, 40, 40)).astype(
                              np.float32),)],
            "v": rng.standard_normal(5000).astype(np.float32),
            "i": np.arange(4096, dtype=np.int32).reshape(64, 64),
            "h": rng.standard_normal((80, 64)).astype(np.float32)}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jtree["h"] = jtree["h"].astype(jnp.bfloat16)
    ttree = {"a": torch.from_numpy(w),
             "b": [torch.from_numpy(tree["b"][0]),
                   (torch.from_numpy(tree["b"][1][0]),)],
             "v": torch.from_numpy(tree["v"]),
             "i": torch.from_numpy(tree["i"]),
             "h": torch.from_numpy(tree["h"]).to(torch.bfloat16)}
    want = jq.fake_quantize_tree(jtree, min_size=1024, bits=bits)
    got = tq.fake_quantize_tree(ttree, min_size=1024, bits=bits)
    assert isinstance(got["b"], list) and isinstance(got["b"][1], tuple)
    pairs = [(got["a"], want["a"]), (got["b"][0], want["b"][0]),
             (got["b"][1][0], want["b"][1][0]), (got["v"], want["v"]),
             (got["i"], want["i"])]
    for g, w_ in pairs:
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert got["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["h"].float().numpy(),
                                  np.asarray(want["h"], np.float32))
    assert not np.array_equal(got["a"].numpy(), w)      # it quantized
    assert torch.equal(got["b"][0], ttree["b"][0])      # below min_size
    assert torch.equal(got["v"], ttree["v"])            # a vector


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantized_transformer_decodes_the_jax_ids(engines, quantize):
    """``quantize_generator`` on a transformer: a fake-quantized decoder
    (the JAX twin's weights bit for bit), the encoder shared, the
    original untouched; the coalescing decode and the slots decode the
    JAX ids of the JAX twin."""
    gp, jconfig, gen, config = _models(seed=4)
    jconfig = JConfig(**KW, quantize=quantize)
    config = config.replace(quantize=quantize)
    jtwin = jq.quantize_generator(gp, jconfig)
    assert not jq.is_quantized(jtwin["decoder"])
    before = {k: t.clone() for k, t in gen.state_dict().items()}
    twin = tq.quantize_generator(gen, config)
    assert isinstance(twin, ttf.TransformerGenerator)
    assert twin.encoder is gen.encoder and twin.decoder is not gen.decoder
    want = interop.flatten_jax({"decoder": _np(jtwin["decoder"])})
    got = twin.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    changed = [k for k in want if not torch.equal(got[k], before[k])]
    assert "decoder.blocks.0.mlp.fc1.w" in changed
    assert "decoder.linear.b" not in changed
    for k, t in gen.state_dict().items():
        assert torch.equal(t, before[k]), k
    feats, _ = _inputs(4, 9)
    ref_ids, ref_lp = _reference(jtwin, jconfig, feats)
    ids, lp = tdecode.greedy_with_logprobs(twin, torch.from_numpy(feats),
                                           config)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    np.testing.assert_allclose(lp.numpy(), ref_lp, atol=LP_ATOL)
    eng = engines(twin, config, num_slots=2, chunk_steps=4, early_exit=False)
    for i, fut in enumerate(eng.submit_many(list(feats))):
        np.testing.assert_array_equal(fut.result(timeout=60)[0], ref_ids[i])
