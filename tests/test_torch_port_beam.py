"""The port's beam search (``eval/decode.py``: ``beam_topk``,
``beam_search``, ``diverse_beam_search``) against the JAX package's on the
CPU, on the same weights (converted by ``interop``) and feature rows: the
dense LSTM, the transformer (its KV lists reindexed by the stepper's
gather) and the int8 LSTM.  Ids equal, scores within 1e-5.  Then the
properties of ``tests/test_decode.py`` on the port: beam 1 is greedy, a
wider beam scores no worse, early stop changes nothing, ``min_length``,
the length penalty, diverse search at one group is vanilla, and diverse
scores are true log-probabilities.

The initial weights are scaled by ``PEAK`` so that each step's
distribution is peaked, as a trained model's is: at their initial scale
the logits of a step lie within about 1e-6 of each other, and the order of
float32 sums (XLA's or PyTorch's) decides between near-equal beams."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.eval import decode as jdecode
from gan_image_captioning_tpu.models import api as japi
from gan_image_captioning_tpu.ops import quantize as jq
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.vocab import END, PAD
from gan_image_captioning_tpu_torch.eval import decode as tdecode
from gan_image_captioning_tpu_torch.eval.metrics import strip_caption

B = 4
PEAK = 8.0
SCORE_ATOL = 1e-5
KW = dict(vocab_size=41, gen_embed_dim=16, gen_hidden_dim=24,
          gen_num_layers=2, gen_num_heads=4, max_seq_len=7)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def peaked(tree):
    """Every weight of ``tree`` times :data:`PEAK`."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a) * PEAK, tree)


def build(arch, seed=0):
    """``(JAX params, JAX config, port generator, port config, feats)``;
    arch ``lstm``, ``transformer`` or ``int8`` (the LSTM's quantized
    decoder on both sides)."""
    kw = dict(KW, gen_arch="transformer" if arch == "transformer"
              else "lstm")
    jconfig, config = JConfig(**kw), Config(**kw)
    gp = peaked(japi.init_generator(jax.random.PRNGKey(seed), jconfig))
    if arch == "transformer":
        gen = interop.transformer_generator_from_jax(_np(gp), config)
    else:
        gen = interop.generator_from_jax(_np(gp), config)
    gen = gen.requires_grad_(False)
    if arch == "int8":
        gp = jq.quantize_generator(gp, jconfig)
        gen = {"decoder": interop.qdec_from_jax(_np(gp)["decoder"])}
    feats = np.random.default_rng(seed + 1).standard_normal(
        (B, config.gen_embed_dim)).astype(np.float32)
    return gp, jconfig, gen, config, feats


@pytest.fixture(scope="module", params=["lstm", "transformer", "int8"])
def model(request):
    return build(request.param)


def _assert_beam(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=SCORE_ATOL, rtol=0)


def test_beam_topk_matches_lax_top_k_with_ties():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 97)).astype(np.float32)
    x[0, 10] = x[0, 50] = x[0, 3]
    x[2, :] = 1.25                              # a whole row tied
    x[3, 7] = x[3, 8] = x[3, 9] = x[3].max() + 1.0
    x[4, ::3] = -1e9                            # NEG_INF entries tied
    x[5, 60:] = x[5].max() + 2.0                # ties at the top
    for k in (1, 4, 7, 40):
        v_ref, i_ref = jax.lax.top_k(jnp.asarray(x), k)
        v, i = tdecode.beam_topk(torch.from_numpy(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    x3 = x.reshape(2, 3, 97)
    v_ref, i_ref = jax.lax.top_k(jnp.asarray(x3), 5)
    v, i = tdecode.beam_topk(torch.from_numpy(x3), 5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("beam,lp,min_len", [(4, 0.0, 0), (3, 0.6, 0),
                                             (4, 0.0, 3)])
def test_beam_search_matches_jax(model, beam, lp, min_len):
    gp, jconfig, gen, config, feats = model
    want = jdecode.beam_search(gp, jnp.asarray(feats), jconfig,
                               beam_size=beam, length_penalty=lp,
                               min_length=min_len)
    got = tdecode.beam_search(gen, torch.from_numpy(feats), config,
                              beam_size=beam, length_penalty=lp,
                              min_length=min_len)
    _assert_beam(got, want)
    assert got[0].dtype == torch.int32


@pytest.mark.parametrize("groups,lam,lp,min_len", [(2, 0.5, 0.0, 0),
                                                   (4, 100.0, 0.6, 2)])
def test_diverse_beam_search_matches_jax(model, groups, lam, lp, min_len):
    gp, jconfig, gen, config, feats = model
    want = jdecode.diverse_beam_search(
        gp, jnp.asarray(feats), jconfig, beam_size=4, num_groups=groups,
        diversity_strength=lam, length_penalty=lp, min_length=min_len)
    got = tdecode.diverse_beam_search(
        gen, torch.from_numpy(feats), config, beam_size=4, num_groups=groups,
        diversity_strength=lam, length_penalty=lp, min_length=min_len)
    assert tuple(got[0].shape) == (B, groups, config.seq_len)
    _assert_beam(got, want)


@pytest.mark.parametrize("arch", ["lstm", "transformer"])
def test_beam_size_1_equals_greedy(arch):
    _, _, gen, config, feats = build(arch, seed=2)
    x = torch.from_numpy(feats)
    greedy = tdecode.greedy(gen, x, config)
    beam, _ = tdecode.beam_search(gen, x, config, beam_size=1)
    for g, b in zip(greedy.numpy(), beam.numpy()):
        assert strip_caption(g) == strip_caption(b)


@pytest.mark.parametrize("arch", ["lstm", "transformer", "int8"])
def test_beam_score_at_least_greedy(arch):
    _, _, gen, config, feats = build(arch, seed=3)
    x = torch.from_numpy(feats)
    greedy = tdecode.greedy(gen, x, config)
    beam_ids, beam_scores = tdecode.beam_search(gen, x, config, beam_size=4)
    lp_greedy = tdecode.sequence_logprob(gen, x, greedy, config)
    lp_beam = tdecode.sequence_logprob(gen, x, beam_ids, config)
    assert (lp_beam >= lp_greedy - 1e-4).all()
    # the beam's score is its sequence log-probability (no length penalty)
    np.testing.assert_allclose(beam_scores.numpy(), lp_beam.numpy(),
                               atol=1e-4)


def test_beam_width_monotonic_quality():
    _, _, gen, config, feats = build("lstm", seed=4)
    prev = None
    for k in (1, 2, 4, 8):
        _, scores = tdecode.beam_search(gen, torch.from_numpy(feats), config,
                                        beam_size=k)
        if prev is not None:
            assert (scores >= prev - 1e-4).all(), (k, scores, prev)
        prev = scores


def _rig_end(gen, boost=100.0):
    gen.decoder.linear.bias[END] += boost
    return gen


@pytest.mark.parametrize("rig", [True, False])
def test_beam_early_stop_exact_equivalence(rig, monkeypatch):
    """Early stop (every DONE_READ_EVERY steps, or every step) equals the
    full-T beam bit for bit, and the JAX package's full-T beam; after
    <E> a beam holds <PAD>."""
    gp, jconfig, gen, config, feats = build("lstm", seed=5)
    if rig:
        gen = _rig_end(gen)
        b = np.asarray(gp["decoder"]["linear"]["b"]).copy()
        b[END] += 100.0
        gp = {"decoder": dict(gp["decoder"], linear=dict(
            gp["decoder"]["linear"], b=jnp.asarray(b)))}
    x = torch.from_numpy(feats)
    want = tdecode.beam_search(gen, x, config, beam_size=3, early_stop=False)
    for every in (1, 3, tdecode.DONE_READ_EVERY):
        monkeypatch.setattr(tdecode, "DONE_READ_EVERY", every)
        got = tdecode.beam_search(gen, x, config, beam_size=3)
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    _assert_beam(want, jdecode.beam_search(gp, jnp.asarray(feats), jconfig,
                                           beam_size=3, early_stop=False))
    for row in want[0].numpy():
        if END in row:
            assert (row[list(row).index(END) + 1:] == PAD).all()
    if rig:
        assert (want[0].numpy()[:, 0] == END).all()


def test_min_length_blocks_early_end():
    _, _, gen, config, feats = build("lstm", seed=9)
    gen = _rig_end(gen, boost=5.0)
    x, m = torch.from_numpy(feats), 4
    ids_b, _ = tdecode.beam_search(gen, x, config, beam_size=3, min_length=m)
    ids_d, _ = tdecode.diverse_beam_search(gen, x, config, beam_size=4,
                                           num_groups=2, min_length=m)
    ids_s, _ = tdecode.sample_decode(gen, x, config,
                                     torch.Generator().manual_seed(0),
                                     min_length=m)
    for ids in (ids_b, ids_d.reshape(-1, config.seq_len), ids_s):
        assert not (ids[:, :m] == END).any()
    # the rigged <E> wins right at min_length
    assert (ids_b[:, m] == END).all()


def test_length_penalty_changes_only_the_ranking():
    """alpha > 0 divides each beam's score by ((5 + len) / 6) ** alpha: the
    reported score is the best beam's normalized one."""
    _, _, gen, config, feats = build("lstm", seed=6)
    x = torch.from_numpy(feats)
    ids, scores = tdecode.beam_search(gen, x, config, beam_size=4,
                                      length_penalty=1.0)
    raw = tdecode.sequence_logprob(gen, x, ids, config)
    lengths = torch.tensor([len(strip_caption(r)) + (END in r.tolist())
                            for r in ids], dtype=torch.float32)
    np.testing.assert_allclose(scores.numpy(),
                               (raw / ((5.0 + lengths) / 6.0)).numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("arch", ["lstm", "transformer", "int8"])
def test_diverse_beam_one_group_equals_vanilla(arch):
    _, _, gen, config, feats = build(arch, seed=7)
    x = torch.from_numpy(feats)
    want_ids, want_s = tdecode.beam_search(gen, x, config, beam_size=4)
    got_ids, got_s = tdecode.diverse_beam_search(
        gen, x, config, beam_size=4, num_groups=1, diversity_strength=0.0)
    np.testing.assert_array_equal(got_ids[:, 0].numpy(), want_ids.numpy())
    np.testing.assert_allclose(got_s[:, 0].numpy(), want_s.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_diverse_beam_scores_are_true_logprobs_and_groups_diverge():
    _, _, gen, config, feats = build("lstm", seed=8)
    x = torch.from_numpy(feats)
    ids, scores = tdecode.diverse_beam_search(
        gen, x, config, beam_size=4, num_groups=4, diversity_strength=100.0)
    for b in range(B):
        assert len(set(ids[b, :, 0].tolist())) == 4
    for g in range(4):
        want = tdecode.sequence_logprob(gen, x, ids[:, g], config)
        np.testing.assert_allclose(scores[:, g].numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        tdecode.diverse_beam_search(gen, x, config, beam_size=4,
                                    num_groups=3)


def test_context_is_refused():
    """A cross-attention context needs a transformer: the LSTM's searches
    refuse one (the conditional transformer's decodes are held against
    the JAX package in test_torch_port_cond_transformer.py)."""
    _, _, gen, config, feats = build("lstm")
    x = torch.from_numpy(feats)
    ctx = torch.zeros(B, 3, config.gen_embed_dim)
    for fn in (tdecode.beam_search, tdecode.diverse_beam_search,
               tdecode.sample_decode):
        with pytest.raises(ValueError, match="context"):
            fn(gen, x, config, context=ctx)
