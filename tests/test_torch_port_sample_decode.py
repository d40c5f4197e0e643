"""The port's sampled decode (``eval/decode.py``: ``filter_logits``,
``_ngram_ban``, ``sample_decode``) against the JAX package's on the CPU.

``jax.random.categorical(key, x)`` is ``argmax(x + gumbel(key,
x.shape))``, so the port is fed the JAX key chain's Gumbel draws:
``rng, k0 = split(rng)`` for t = 0, then ``rng, key = split(rng)`` at
each step, ``gumbel(key, (B, V), float32)``.  Ids must be equal and the
reported log-probabilities within 1e-5, with each selection knob and
without, for the dense LSTM, the transformer and the int8 LSTM (weights
scaled by ``PEAK`` as in ``test_torch_port_beam.py``).  ``top_p`` keeps a
token while ``cum - prob < top_p`` in float32, which depends on the order
of the sum: the ``filter_logits`` inputs below are checked to lie at least
1e-4 from that boundary, and the decodes' nucleus cases use ``top_p``
values whose cuts the seeded models do not come near."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.eval import decode as jdecode
from gan_image_captioning_tpu_torch.data.vocab import END, PAD
from gan_image_captioning_tpu_torch.eval import decode as tdecode
from test_torch_port_beam import B, build

LP_ATOL = 1e-5


def jax_noise(seed, T, B, V):
    """The Gumbel draws JAX's ``sample_decode`` makes from
    ``PRNGKey(seed)``, one ``[B, V]`` per step → ``[T, B, V]``."""
    rng = jax.random.PRNGKey(seed)
    rng, key = jax.random.split(rng)
    out = []
    for _ in range(T):
        out.append(np.asarray(jax.random.gumbel(key, (B, V), jnp.float32)))
        rng, key = jax.random.split(rng)
    return np.stack(out)


@pytest.fixture(scope="module", params=["lstm", "transformer", "int8"])
def model(request):
    return build(request.param, seed=11)


def _logits(seed, n=6, v=32, scale=2.0):
    return (np.random.default_rng(seed).standard_normal((n, v))
            * scale).astype(np.float32)


def _off_top_p_boundary(logits, temperature, top_p):
    x = np.sort(logits / np.float32(temperature), axis=-1)[:, ::-1]
    p = np.exp(x - x.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.abs(np.cumsum(p, -1) - p - top_p).min() > 1e-4


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 0, 1.0), (1.3, 5, 1.0), (1.0, 0, 0.9),
    (0.8, 6, 0.75), (1.0, 1, 1.0), (0.0, 0, 1.0)])
def test_filter_logits_matches_jax(temperature, top_k, top_p):
    for seed in range(3):
        x = _logits(seed)
        if top_p < 1.0:
            assert _off_top_p_boundary(x, temperature, top_p)
        want = jdecode.filter_logits(jnp.asarray(x), temperature, top_k,
                                     top_p)
        got = tdecode.filter_logits(torch.from_numpy(x), temperature, top_k,
                                    top_p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [2, 3])
def test_ngram_ban_matches_jax(n):
    rng = np.random.default_rng(n)
    V, T = 7, 10
    buf = rng.integers(0, 4, (5, T)).astype(np.int32)      # many repeats
    for t in range(1, T):
        last = buf[:, t - 1]
        want = jdecode._ngram_ban(jnp.asarray(buf), jnp.asarray(t),
                                  jnp.asarray(last), n, V)
        got = tdecode._ngram_ban(torch.from_numpy(buf), t,
                                 torch.from_numpy(last), n, V)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.bool and tuple(got.shape) == (5, V)


KNOBS = [dict(), dict(temperature=0.7), dict(top_k=5),
         dict(top_p=0.9, temperature=0.8), dict(repetition_penalty=1.3),
         dict(no_repeat_ngram=2), dict(no_repeat_ngram=3),
         dict(min_length=3), dict(early_stop=True),
         dict(top_k=8, top_p=0.95, repetition_penalty=1.2,
              no_repeat_ngram=3, min_length=2, early_stop=True)]


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: ",".join(k) or "plain")
def test_sample_decode_matches_jax(model, knobs):
    gp, jconfig, gen, config, feats = model
    seed = 21
    want = jdecode.sample_decode(gp, jnp.asarray(feats), jconfig,
                                 jax.random.PRNGKey(seed), **knobs)
    noise = jax_noise(seed, config.seq_len, B, config.vocab_size)
    got = tdecode.sample_decode(gen, torch.from_numpy(feats), config,
                                noise=torch.from_numpy(noise), **knobs)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=LP_ATOL, rtol=0)


def test_early_stop_prefix_identical(monkeypatch):
    """early_stop keeps every row's ids through its first <E> (the noise
    is positional), <PAD> after, and the masked logprob; reading the done
    flags every step or every DONE_READ_EVERY steps gives the same."""
    _, _, gen, config, feats = build("lstm", seed=12)
    gen.decoder.linear.bias[END] += 3.0         # rows end at several steps
    x = torch.from_numpy(feats)
    noise = torch.from_numpy(jax_noise(3, config.seq_len, B,
                                       config.vocab_size))
    full = tdecode.sample_decode(gen, x, config, noise=noise)
    ends = []
    for every in (1, 2, tdecode.DONE_READ_EVERY):
        monkeypatch.setattr(tdecode, "DONE_READ_EVERY", every)
        ids, lp = tdecode.sample_decode(gen, x, config, noise=noise,
                                        early_stop=True)
        np.testing.assert_array_equal(lp.numpy(), full[1].numpy())
        for a, b in zip(ids.numpy(), full[0].numpy()):
            k = list(b).index(END) if END in b else len(b) - 1
            np.testing.assert_array_equal(a[:k + 1], b[:k + 1])
            assert (a[k + 1:] == PAD).all()
            ends.append(k)
    assert len(set(ends)) > 1


@pytest.mark.parametrize("arch", ["lstm", "transformer", "int8"])
def test_top_k_one_is_greedy(arch):
    _, _, gen, config, feats = build(arch, seed=13)
    x = torch.from_numpy(feats)
    ids, lp = tdecode.sample_decode(gen, x, config,
                                    torch.Generator().manual_seed(0),
                                    top_k=1)
    greedy = tdecode.greedy(gen, x, config)
    np.testing.assert_array_equal(ids.numpy(), greedy.numpy())
    np.testing.assert_allclose(
        lp.numpy(), tdecode.sequence_logprob(gen, x, greedy, config).numpy(),
        atol=1e-5)


def test_generator_draws_are_seeded():
    _, _, gen, config, feats = build("lstm", seed=14)
    x = torch.from_numpy(feats)

    def run(seed):
        return tdecode.sample_decode(gen, x, config,
                                     torch.Generator().manual_seed(seed),
                                     temperature=1.5)[0]

    np.testing.assert_array_equal(run(1).numpy(), run(1).numpy())
    assert not torch.equal(run(1), run(2))


def test_no_repeat_trigram_property():
    _, _, gen, config, feats = build("lstm", seed=15)
    x = torch.from_numpy(feats)
    for seed in range(3):
        ids, _ = tdecode.sample_decode(gen, x, config,
                                       torch.Generator().manual_seed(seed),
                                       top_k=2, no_repeat_ngram=3)
        for row in ids.tolist():
            grams = [tuple(row[i:i + 3]) for i in range(len(row) - 2)]
            assert len(grams) == len(set(grams)), row
