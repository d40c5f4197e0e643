"""The port's adversarial sample — the ``sample_resid`` decode (its plain
version on CPU tensors) and the autograd Function around it — and its
pretrain sample, teacher forcing and ``lstm_seq_tm``, against the JAX
package on the same weights, features and noise:

* ``decode_sample(mode="sample_resid")`` and ``jax.vjp`` of
  ``_kernel_sample_soft`` in interpret mode with the chained BPTT kernel
  (``GIC_KERNEL_INTERPRET=1 GIC_BPTT_CHAIN=1``), whose noise is zero — the
  port is fed zero uniforms;
* ``_sample_fused`` with the uniforms ``jax.random`` draws from the
  per-step keys ``jax.random.split(rng, T)``, fed to the port.

Tolerance: ids exact; values atol = rtol = 1e-5 and gradients atol 1e-5,
rtol 1e-4 (float32 sums in another order; the backward sums over T·B
rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.kernels.decode_sample import (
    decode_sample as jdecode_sample)
from gan_image_captioning_tpu.models import generator as jgen
from gan_image_captioning_tpu.models import lstm as jlstm
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.interop import generator_from_jax
from gan_image_captioning_tpu_torch.kernels.decode_sample import (
    decode_sample, decode_sample_resid)
from gan_image_captioning_tpu_torch.models import generator as tgen
from gan_image_captioning_tpu_torch.models import lstm as tlstm

B, T, V, E, H, NL = 4, 6, 64, 8, 16, 2
TEMP = 2.0
VAL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("GIC_KERNEL_INTERPRET", "1")
    monkeypatch.setenv("GIC_BPTT_CHAIN", "1")


@pytest.fixture(scope="module")
def setup():
    kw = dict(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
              gen_num_layers=NL, max_seq_len=T - 2)
    jdec = jgen.init_decoder_params(jax.random.PRNGKey(11), JConfig(**kw))
    gen = generator_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    {"decoder": jdec}),
                             Config(**kw))
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((B, E)).astype(np.float32)
    probe = rng.standard_normal((T, B, V)).astype(np.float32)
    return jdec, gen, feats, probe


def _port_grads(gen, feats, loss_fn):
    gen.zero_grad()
    f = torch.from_numpy(feats).requires_grad_(True)
    loss_fn(gen.decoder, f).backward()
    grads = {"embed": gen.decoder.embed.weight.grad,
             "w": gen.decoder.linear.weight.grad,
             "b": gen.decoder.linear.bias.grad, "features": f.grad}
    for l, lp in enumerate(gen.decoder.lstm.layers()):
        for k, p in lp.items():
            grads[f"{l}.{k}"] = p.grad
    return grads


def _jax_grads(jdec, feats, loss_fn):
    g_dec, g_f = jax.grad(loss_fn, argnums=(0, 1))(jdec, jnp.asarray(feats))
    grads = {"embed": g_dec["embed"], "w": g_dec["linear"]["w"],
             "b": g_dec["linear"]["b"], "features": g_f}
    for l, lp in enumerate(g_dec["lstm"]):
        for k, v in lp.items():
            grads[f"{l}.{k}"] = v
    return grads


def _assert_grads(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), err_msg=k, **GRAD)


def _port_args(gen, feats):
    dec = gen.decoder
    return (torch.from_numpy(feats), dec.lstm.layers(), dec.linear.weight,
            dec.linear.bias, dec.embed.weight, T)


def test_sample_resid_plain_matches_jax_kernel(setup):
    jdec, gen, feats, _ = setup
    want = jdecode_sample(jnp.asarray(feats), jdec["lstm"],
                          jdec["linear"]["w"], jdec["linear"]["b"],
                          jdec["embed"], T, mode="sample_resid", seed=3,
                          temperature=TEMP)
    with torch.no_grad():
        got = decode_sample(*_port_args(gen, feats), mode="sample_resid",
                            temperature=TEMP, uniforms=torch.zeros(T, B, V))
    names = ("ids", "soft", "hs", "cs", "gates")
    for name, a, b in zip(names, got, want):
        assert tuple(a.shape) == tuple(b.shape), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **VAL)
    assert got[0].dtype == torch.int32


def test_sample_soft_vjp_matches_jax_kernel_vjp(setup):
    jdec, gen, feats, probe = setup

    def jloss(dec, f):
        soft, _ = jgen._kernel_sample_soft(dec, f, jnp.float32(TEMP),
                                           jnp.int32(5), T)
        return jnp.sum(soft * probe)

    def tloss(dec, f):
        soft, _ = tgen.sample_soft(dec, f, T, TEMP,
                                   uniforms=torch.zeros(T, B, V))
        return (soft.transpose(0, 1) * torch.from_numpy(probe)).sum()

    _assert_grads(_port_grads(gen, feats, tloss),
                  _jax_grads(jdec, feats, jloss))


def _fused_uniforms(rng):
    keys = jax.random.split(rng, T)
    return np.stack([np.asarray(jax.random.uniform(k, (B, V), jnp.float32))
                     for k in keys])


def test_sample_soft_matches_sample_fused_with_fed_uniforms(setup):
    jdec, gen, feats, probe = setup
    rng = jax.random.PRNGKey(21)
    u = torch.from_numpy(_fused_uniforms(rng))
    soft_j, ids_j = jgen._sample_fused(jdec, jnp.asarray(feats), rng,
                                       jnp.float32(TEMP), T)
    with torch.no_grad():
        soft, ids = tgen.sample(gen.decoder, torch.from_numpy(feats), T,
                                pretrain=False, temperature=TEMP, uniforms=u)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(soft.numpy(), np.asarray(soft_j), **VAL)
    assert len(np.unique(np.asarray(ids_j))) > B   # many tokens compared

    def jloss(dec, f):
        soft, _ = jgen._sample_fused(dec, f, rng, jnp.float32(TEMP), T)
        return jnp.sum(jnp.swapaxes(soft, 0, 1) * probe)

    def tloss(dec, f):
        soft, _ = tgen.sample(dec, f, T, pretrain=False, temperature=TEMP,
                              uniforms=u)
        return (soft.transpose(0, 1) * torch.from_numpy(probe)).sum()

    _assert_grads(_port_grads(gen, feats, tloss),
                  _jax_grads(jdec, feats, jloss))


def test_pretrain_sample_matches_sample_fused(setup):
    """Greedy ids from the decode, then the teacher-forced rescore: the
    same logits and gradients as the JAX package's differentiable scan."""
    jdec, gen, feats, probe = setup
    logits_j, ids_j = jgen._sample_fused(jdec, jnp.asarray(feats),
                                         jax.random.PRNGKey(0), 1.0, T,
                                         pretrain=True)
    with torch.no_grad():
        logits, ids = tgen.sample(gen.decoder, torch.from_numpy(feats), T)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **VAL)
    probe_bt = np.swapaxes(probe, 0, 1)

    def jloss(dec, f):
        out, _ = jgen._sample_fused(dec, f, jax.random.PRNGKey(0), 1.0, T,
                                    pretrain=True)
        return jnp.sum(out * probe_bt)

    def tloss(dec, f):
        out, _ = tgen.sample(dec, f, T)
        return (out * torch.from_numpy(probe_bt)).sum()

    _assert_grads(_port_grads(gen, feats, tloss),
                  _jax_grads(jdec, feats, jloss))


def test_teacher_forced_matches_jax(setup):
    jdec, gen, feats, _ = setup
    caps = np.random.default_rng(2).integers(0, V, (B, T - 1)).astype(
        np.int32)
    want, _ = jgen.teacher_forced(jdec, jnp.asarray(feats), jnp.asarray(caps),
                                  pretrain=True)
    with torch.no_grad():
        got = tgen.teacher_forced(gen.decoder, torch.from_numpy(feats),
                                  torch.from_numpy(caps))
    assert got.shape == (B, T, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)


def test_lstm_seq_tm_matches_jax(setup):
    jdec, gen, _, _ = setup
    xs = np.random.default_rng(4).standard_normal((T, B, E)).astype(
        np.float32)
    probe = np.random.default_rng(6).standard_normal((T, B, H)).astype(
        np.float32)
    want, g_want = jax.value_and_grad(
        lambda p, x: jnp.sum(jlstm.lstm_seq_tm(p, x) * probe),
        argnums=(0, 1))(jdec["lstm"], jnp.asarray(xs))
    x = torch.from_numpy(xs).requires_grad_(True)
    got = (tlstm.lstm_seq_tm(gen.decoder.lstm.layers(), x)
           * torch.from_numpy(probe)).sum()
    gen.zero_grad()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **VAL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_want[1]), **GRAD)
    for lp, jp in zip(gen.decoder.lstm.layers(), g_want[0]):
        for k in jp:
            np.testing.assert_allclose(lp[k].grad.numpy(), np.asarray(jp[k]),
                                       err_msg=k, **GRAD)


def test_cpu_sample_resid_draws_from_the_seed(setup):
    _, gen, feats, _ = setup
    before = decode_sample_resid.launches
    with torch.no_grad():
        u_out = torch.empty(T, B, V)
        a = decode_sample_resid(*_port_args(gen, feats), seed=7,
                                temperature=TEMP, uniforms_out=u_out)
        b = decode_sample_resid(*_port_args(gen, feats), seed=7,
                                temperature=TEMP)
        c = decode_sample_resid(*_port_args(gen, feats), seed=8,
                                temperature=TEMP)
        fed = decode_sample_resid(*_port_args(gen, feats), temperature=TEMP,
                                  uniforms=u_out)
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])
    assert torch.equal(a[1], fed[1]) and torch.equal(a[0], fed[0])
    assert 0.0 <= float(u_out.min()) and float(u_out.max()) < 1.0
    assert decode_sample_resid.launches == before


def test_sample_resid_rejects_bad_uniforms(setup):
    _, gen, feats, _ = setup
    args = _port_args(gen, feats)
    with pytest.raises(ValueError):
        decode_sample_resid(*args, uniforms=torch.zeros(T, B, V - 1))
    with pytest.raises(TypeError):
        decode_sample_resid(*args, uniforms=torch.zeros(T, B, V,
                                                        dtype=torch.float64))
    with pytest.raises(TypeError):
        decode_sample_resid(args[0].double(), *args[1:])
