"""The port's ``eval/decode.py`` against the JAX package's: greedy,
``greedy_with_logprobs``, ``sequence_logprob`` and ``masked_logprob_sum``
on the same weights and random feature rows (CPU: the plain composition
on both sides).  Ids exact; logprobs within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.vocab import END as JEND
from gan_image_captioning_tpu.eval import decode as jdecode
from gan_image_captioning_tpu.models import generator as jgen
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.vocab import END
from gan_image_captioning_tpu_torch.eval import decode as tdecode
from gan_image_captioning_tpu_torch.interop import generator_from_jax

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

B, T, V, H, E = 5, 8, 256, 32, 24


@pytest.fixture(scope="module")
def setup():
    kw = dict(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
              gen_num_layers=2, max_seq_len=T - 2)
    jconfig, config = JConfig(**kw), Config(**kw)
    gen_params = {"decoder": jgen.init_decoder_params(jax.random.PRNGKey(11),
                                                      jconfig)}
    tree = jax.tree_util.tree_map(np.asarray, gen_params)
    gen = generator_from_jax(tree, config).requires_grad_(False)
    feats = np.random.default_rng(5).standard_normal((B, E)).astype(
        np.float32)
    return gen_params, jconfig, gen, config, feats


def test_end_token_matches():
    assert END == JEND == 2


def test_greedy_matches_jax(setup):
    gen_params, jconfig, gen, config, feats = setup
    want = jdecode.greedy(gen_params, jnp.asarray(feats), jconfig)
    got = tdecode.greedy(gen, torch.from_numpy(feats), config)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # random rows, un-swept weights: the rows decode differently
    assert len({tuple(r) for r in np.asarray(want).tolist()}) > 1


def test_greedy_with_logprobs_matches_jax(setup):
    gen_params, jconfig, gen, config, feats = setup
    ids_j, lp_j = jdecode.greedy_with_logprobs(gen_params, jnp.asarray(feats),
                                               jconfig)
    ids, lp = tdecode.greedy_with_logprobs(gen, torch.from_numpy(feats),
                                           config)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), atol=1e-4,
                               rtol=1e-4)


def test_sequence_logprob_matches_jax_with_end_tokens(setup):
    """Teacher-forced ids with <E> placed early, late and twice: the mask
    keeps positions up to and including the first <E>."""
    gen_params, jconfig, gen, config, feats = setup
    ids = np.random.default_rng(9).integers(3, V, (B, T)).astype(np.int32)
    ids[0, 2] = END
    ids[1, T - 1] = END
    ids[2, 1] = ids[2, 4] = END
    want = jdecode.sequence_logprob(gen_params, jnp.asarray(feats),
                                    jnp.asarray(ids), jconfig)
    got = tdecode.sequence_logprob(gen, torch.from_numpy(feats),
                                   torch.from_numpy(ids), config)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_masked_logprob_sum_matches_jax():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 5, (16, T)).astype(np.int32)
    lps = -rng.random((16, T)).astype(np.float32)
    want = jdecode.masked_logprob_sum(jnp.asarray(ids), jnp.asarray(lps))
    got = tdecode.masked_logprob_sum(torch.from_numpy(ids),
                                     torch.from_numpy(lps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_kernel_path_only_for_cuda_tensors():
    assert not tdecode.kernel_serve_available(torch.zeros(2, 3))
