"""The bfloat16 instantiations' plain versions of the BPTT chain, the
reverse BPTT and the ``mxu`` conv banks (``--dtype bfloat16``) against
the JAX package's kernels run in interpret mode on the same bfloat16
inputs (numpy, from a seed):

* the chain reads the decode's bfloat16 gates and cells as float32 (its
  weights and ``d_hs`` are float32, as the JAX caller casts them) and
  returns float32 ``d_pre``;
* the reverse widens all five bfloat16 inputs and returns float32;
* the conv forward computes in float32 from bfloat16 inputs and stores the
  pooled features in bfloat16; its backward accumulates in float32 and
  returns the gradients in the inputs' dtype, bfloat16.

Tolerances: the BPTT outputs are float32 arithmetic on the same bfloat16
values, held as their float32 versions are (atol = rtol = 1e-5); the
conv's bfloat16 outputs are the same float32 value rounded on both sides,
within one bfloat16 step of each entry (2^-7 of its magnitude: 2 units of
2^-8), and argmax rows equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.kernels import disc_conv as jdc
from gan_image_captioning_tpu.kernels import lstm_bptt as jbptt
from gan_image_captioning_tpu.models import discriminator as jdisc
from gan_image_captioning_tpu_torch.kernels import disc_conv
from gan_image_captioning_tpu_torch.kernels.lstm_bptt import (
    lstm_bptt_chain, lstm_bptt_reverse)

T, B, H = 6, 3, 16
BF = torch.bfloat16
F32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("GIC_KERNEL_INTERPRET", "1")


def _rows(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bf16(a):
    """A float32 array rounded to bfloat16: (JAX array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(BF)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("nl", [1, 2])
def test_chain_reads_bf16_residuals_as_jax(nl):
    rng = np.random.default_rng(nl)
    w_hhs = _rows(rng, nl, H, 4 * H, scale=0.3)
    w_ihs = _rows(rng, max(nl - 1, 1), H, 4 * H, scale=0.3)
    d_hs = _rows(rng, T, B, H)
    gates_j, gates = _bf16(_rows(rng, T, nl, B, 4 * H))
    cs_j, cs = _bf16(_rows(rng, T, nl, B, H))
    want = jbptt.lstm_bptt_chain(jnp.asarray(w_hhs), jnp.asarray(w_ihs),
                                 jnp.asarray(d_hs), gates_j, cs_j)
    got = lstm_bptt_chain(torch.from_numpy(w_hhs), torch.from_numpy(w_ihs),
                          torch.from_numpy(d_hs), gates, cs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_reverse_widens_bf16_inputs_as_jax():
    rng = np.random.default_rng(7)
    pairs = [_bf16(a) for a in (_rows(rng, H, 4 * H, scale=0.3),
                                _rows(rng, T, B, H), _rows(rng, T, B, 4 * H),
                                _rows(rng, T, B, H), _rows(rng, T, B, H))]
    want = jax.jit(jbptt.lstm_bptt_reverse)(*(j for j, _ in pairs))
    got = lstm_bptt_reverse(*(t for _, t in pairs))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


def test_mxu_conv_bf16_value_and_vjp_match_jax():
    config = JConfig(vocab_size=40, disc_embed_dim=16, disc_num_rep=16,
                     disc_filter_sizes=(2, 3, 4), disc_num_filters=(5, 6, 7),
                     max_seq_len=4)
    params = jdisc.init_discriminator_params(jax.random.PRNGKey(0), config)
    rng = np.random.default_rng(0)
    emb_j, emb = _bf16(_rows(rng, 4, config.seq_len, 16))
    probe = _rows(rng, 4 * 16, config.disc_feature_dim)
    convs_j = [{"w": jnp.asarray(c["w"], jnp.bfloat16),
                "b": jnp.asarray(c["b"], jnp.bfloat16)}
               for c in params["convs"]]

    def jloss(convs, e):
        out = jdc.pooled_features(convs, e, 1, impl="mxu").reshape(
            -1, config.disc_feature_dim)
        return jnp.sum(out * probe), out

    (_, want), (g_convs, g_emb) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(convs_j, emb_j)
    assert want.dtype == jnp.bfloat16
    convs = [(torch.from_numpy(_f32(c["w"])).to(BF).requires_grad_(True),
              torch.from_numpy(_f32(c["b"])).to(BF).requires_grad_(True))
             for c in convs_j]
    e = emb.clone().requires_grad_(True)
    out = disc_conv.pooled_features(convs, e, 1).reshape(
        -1, config.disc_feature_dim)
    (out * torch.from_numpy(probe)).sum().backward()
    assert out.dtype == BF and e.grad.dtype == BF

    def close(a, b, what):
        a, b = _f32(a), _f32(b)
        np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=1e-30,
                                   err_msg=what)

    close(out, want, "pooled")
    close(e.grad, g_emb, "d_emb")
    for (w, b), g in zip(convs, g_convs):
        close(w.grad, g["w"], "dW")
        close(b.grad, g["b"], "db")
