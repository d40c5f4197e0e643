"""The port's ``decode_sample`` (serve, greedy, sample and pretrain modes;
on CPU tensors its plain PyTorch version) against the JAX package's
``decode_sample`` run in interpret mode, on the same weights and random
feature rows.  Ids exact; logprobs within atol = rtol = 1e-4, the JAX package's
own tolerance for this kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.kernels.decode_sample import (
    decode_sample as jdecode_sample)
from gan_image_captioning_tpu.models import generator as jgen
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.interop import generator_from_jax
from gan_image_captioning_tpu_torch.kernels.decode_sample import (
    decode_sample, decode_sample_plain)
from gan_image_captioning_tpu_torch.models import generator as tgen

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

B, T, V, H, E = 4, 8, 256, 32, 32


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("GIC_KERNEL_INTERPRET", "1")


@pytest.fixture(scope="module")
def setup():
    jconfig = JConfig(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                      gen_num_layers=2, max_seq_len=T - 2)
    jdec = jgen.init_decoder_params(jax.random.PRNGKey(3), jconfig)
    tree = jax.tree_util.tree_map(np.asarray, {"decoder": jdec})
    config = Config(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                    gen_num_layers=2, max_seq_len=T - 2)
    gen = generator_from_jax(tree, config).requires_grad_(False)
    feats = np.random.default_rng(7).standard_normal((B, E)).astype(
        np.float32)
    return jdec, gen, feats


def _jax_serve(jdec, feats):
    ids, lps = jdecode_sample(jnp.asarray(feats), jdec["lstm"],
                              jdec["linear"]["w"], jdec["linear"]["b"],
                              jdec["embed"], T, mode="serve")
    return np.asarray(ids), np.asarray(lps)


def _port_args(gen, feats):
    dec = gen.decoder
    return (torch.from_numpy(feats), dec.lstm.layers(), dec.linear.weight,
            dec.linear.bias, dec.embed.weight, T)


def test_serve_mode_matches_jax(setup):
    jdec, gen, feats = setup
    ids_j, lps_j = _jax_serve(jdec, feats)
    ids, lps = decode_sample(*_port_args(gen, feats), mode="serve")
    assert ids.dtype == torch.int32 and lps.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    np.testing.assert_allclose(lps.numpy(), lps_j, atol=1e-4, rtol=1e-4)
    # random rows, un-swept weights: the comparison sees many tokens
    assert len(np.unique(ids_j)) > B


def test_greedy_mode_matches_jax(setup):
    jdec, gen, feats = setup
    ids_j, _ = _jax_serve(jdec, feats)
    ids = decode_sample(*_port_args(gen, feats), mode="greedy")
    np.testing.assert_array_equal(ids.numpy(), ids_j)


def test_plain_version_matches_generator_sample(setup):
    _, gen, feats = setup
    ids, _ = decode_sample_plain(*_port_args(gen, feats))
    _, ids_ref = tgen.sample(gen.decoder, torch.from_numpy(feats), T)
    assert torch.equal(ids, ids_ref)


def test_cpu_call_counts_no_launch(setup):
    _, gen, feats = setup
    before = decode_sample.launches
    decode_sample(*_port_args(gen, feats), mode="serve")
    assert decode_sample.launches == before


# the carried state is ported for mode "serve" only
# (tests/test_torch_port_qserve.py holds it against the JAX package)
def test_unported_variants_raise(setup):
    _, gen, feats = setup
    with pytest.raises(NotImplementedError):
        decode_sample(*_port_args(gen, feats), mode="greedy", init_state=())


# modes sample (zero uniforms: the interpreter's PRNG draws zeros) and
# pretrain; tests/test_torch_port_decode_modes.py holds every mode
@pytest.mark.parametrize("mode", ["sample", "pretrain"])
def test_sample_and_pretrain_plain_versions_match_jax(setup, mode):
    jdec, gen, feats = setup
    want = jdecode_sample(jnp.asarray(feats), jdec["lstm"],
                          jdec["linear"]["w"], jdec["linear"]["b"],
                          jdec["embed"], T, mode=mode)
    got = decode_sample(*_port_args(gen, feats), mode=mode,
                        uniforms=torch.zeros(T, B, V))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-4, rtol=1e-4)


def test_rejects_bad_inputs(setup):
    _, gen, feats = setup
    args = list(_port_args(gen, feats))
    with pytest.raises(TypeError):
        decode_sample(args[0].double(), *args[1:], mode="serve")
    with pytest.raises(ValueError):
        decode_sample(args[0][:, :E - 1].contiguous(), *args[1:])
    with pytest.raises(ValueError):
        decode_sample(args[0], args[1], args[2].T.contiguous().T, *args[3:])
    with pytest.raises(ValueError):
        decode_sample(args[0].to("meta"), *args[1:])
