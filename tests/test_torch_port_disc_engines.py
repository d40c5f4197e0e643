"""The conv-bank engines of ``--disc-engine`` (``kernels/disc_conv.py``,
their plain versions on CPU tensors) against the JAX package's: the
per-batch-row engine (``conv_relu_maxpool``, Pallas in interpret mode),
the hybrid one, the MXU engine's DXS backward (``GIC_MXU_DX=0``), the
discriminator under each engine value, and an adversarial step with
``disc_engine="pallas"``.  Sizes: B = 4, L = 9 real time rows, R = 4,
eds = 2, banks of 8 and 6 filters of 3 and 4 taps.

Tolerance: values atol = rtol = 1e-5, gradients atol 1e-5 and rtol 1e-4
(float32 products summed in another order); step metrics rtol 1e-5,
parameters atol 1e-5, rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.loader import make_batch as jmake_batch
from gan_image_captioning_tpu.kernels import disc_conv as jdc
from gan_image_captioning_tpu.models import discriminator as jdisc
from gan_image_captioning_tpu.models.torch_export import (
    discriminator_to_torch)
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu.train.state import (
    create_train_state as jcreate_train_state)
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.interop import (discriminator_from_jax,
                                                    disc_params_from_jax,
                                                    params_from_jax,
                                                    train_state_from_jax)
from gan_image_captioning_tpu_torch.kernels import disc_conv
from gan_image_captioning_tpu_torch.models import discriminator as tdisc
from gan_image_captioning_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

VAL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)
B = 4
DISC = dict(disc_embed_dim=8, disc_num_rep=4, disc_filter_sizes=(3, 4),
            disc_num_filters=(8, 6), max_seq_len=7)


def _setup(seed=0):
    config = JConfig(vocab_size=40, **DISC)
    params = jdisc.init_discriminator_params(jax.random.PRNGKey(seed), config)
    # larger weights than the init sweep's, so that ReLU passes some
    params = jax.tree_util.tree_map(lambda x: x * 20.0, params)
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, config.seq_len, config.disc_embed_dim))
    probe = rng.standard_normal((B * config.disc_num_rep,
                                 config.disc_feature_dim))
    return config, params, emb.astype(np.float32), probe.astype(np.float32)


# (JAX impl of pooled_features, GIC_MXU_DX, the port's engine)
PAIRS = [("pallas", "1", "pallas"), ("hybrid", "1", "hybrid"),
         ("mxu", "0", "mxu_dxs")]


@pytest.mark.parametrize("impl,mxu_dx,engine", PAIRS)
def test_engine_value_and_vjp_match_jax(monkeypatch, impl, mxu_dx, engine):
    monkeypatch.setenv("GIC_MXU_DX", mxu_dx)
    config, params, emb, probe = _setup()
    eds = config.emb_dim_single

    def jloss(convs, e):
        out = jdc.pooled_features(convs, e, eds, impl=impl)
        out = out.reshape(-1, config.disc_feature_dim)
        return jnp.sum(out * probe), out

    (_, want), (g_convs, g_emb) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params["convs"],
                                             jnp.asarray(emb))
    convs = [(torch.tensor(np.asarray(c["w"]), requires_grad=True),
              torch.tensor(np.asarray(c["b"]), requires_grad=True))
             for c in params["convs"]]
    e = torch.from_numpy(emb).requires_grad_(True)
    out = disc_conv.pooled_features(convs, e, eds, engine)
    out = out.reshape(-1, config.disc_feature_dim)
    (out * torch.from_numpy(probe)).sum().backward()
    assert 0.0 < float((out > 0).float().mean()) < 1.0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **VAL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(g_emb), **GRAD)
    for (w, b), g in zip(convs, g_convs):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(g["w"]), **GRAD)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(g["b"]), **GRAD)


def _bank_inputs():
    config, params, emb, _ = _setup(1)
    eds, R = config.emb_dim_single, config.disc_num_rep
    convs = [(torch.tensor(np.asarray(c["w"])),
              torch.tensor(np.asarray(c["b"]))) for c in params["convs"]]
    w_all, b_all, banks = disc_conv.fuse_bank_params(convs, eds)
    emb_pad = torch.nn.functional.pad(torch.from_numpy(emb),
                                      (0, 0, 0, 3)).contiguous()
    pooled, idxs = disc_conv.conv_relu_maxpool_plain(emb_pad, w_all, b_all,
                                                     banks, R, eds)
    d_pooled = torch.from_numpy(np.random.default_rng(2).standard_normal(
        pooled.shape).astype(np.float32))
    return emb_pad, w_all.contiguous(), banks, R, eds, pooled, idxs, d_pooled


def test_dxs_overlap_add_equals_the_dx_backward():
    emb_pad, w_all, banks, R, eds, pooled, idxs, d_pooled = _bank_inputs()
    dpms, _ = disc_conv._masked(pooled, d_pooled, banks)
    dxss, dw = disc_conv.conv_dxs_plain(emb_pad, w_all, banks, R, eds, idxs,
                                        dpms)
    L = emb_pad.shape[1] - 3
    assert [tuple(d.shape) for d in dxss] == [
        (L - f + 1, B * R, f * eds) for _, f in banks]
    d_emb = disc_conv.overlap_add(dxss, banks, emb_pad.shape, R, eds)
    want_emb, want_dw = disc_conv.conv_bwd_dx_plain(emb_pad, w_all, banks, R,
                                                    eds, idxs, dpms)
    torch.testing.assert_close(d_emb, want_emb, **GRAD)
    torch.testing.assert_close(dw, want_dw, **GRAD)


def test_wrappers_count_no_launch_on_cpu_and_reject_bad_inputs():
    emb_pad, w_all, banks, R, eds, pooled, idxs, d_pooled = _bank_inputs()
    b_all = torch.zeros(w_all.shape[0])
    fns = (disc_conv.conv_rows_forward, disc_conv.conv_rows_backward,
           disc_conv.conv_bank_dxs)
    before = [f.launches for f in fns]
    dpms, _ = disc_conv._masked(pooled, d_pooled, banks)
    disc_conv.conv_rows_forward(emb_pad, w_all, b_all, banks, R, eds)
    got = disc_conv.conv_rows_backward(emb_pad, w_all, banks, R, eds, pooled,
                                       idxs, d_pooled)
    want = disc_conv.conv_rows_backward_plain(emb_pad, w_all, banks, R, eds,
                                              pooled, idxs, d_pooled)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)
    disc_conv.conv_bank_dxs(emb_pad, w_all, banks, R, eds, idxs, dpms)
    assert [f.launches for f in fns] == before
    with pytest.raises(TypeError):
        disc_conv.conv_rows_forward(emb_pad.double(), w_all, b_all, banks, R,
                                    eds)
    with pytest.raises(ValueError):
        disc_conv.conv_rows_backward(emb_pad, w_all, banks, R, eds,
                                     pooled[:, :2], idxs, d_pooled)
    with pytest.raises(ValueError):
        disc_conv.conv_bank_dxs(emb_pad, w_all, banks, R, eds, idxs,
                                [d[:, :, :2] for d in dpms])
    with pytest.raises(ValueError, match="engine"):
        disc_conv.conv_relu_maxpool(emb_pad, w_all, b_all, banks, R, eds,
                                    "dxs")


# every --disc-engine value, and the port's mxu_dxs as the JAX package's
# mxu under GIC_MXU_DX=0
ENGINE_CASES = [("auto", "auto", "1"), ("xla", "xla", "1"),
                ("pallas", "pallas", "1"), ("hybrid", "hybrid", "1"),
                ("mxu", "mxu", "1"), ("mxu_dxs", "mxu", "0")]


@pytest.mark.parametrize("engine,jengine,mxu_dx", ENGINE_CASES)
def test_discriminator_apply_matches_jax_under_each_engine(
        monkeypatch, engine, jengine, mxu_dx):
    monkeypatch.delenv("GIC_DISC_KERNEL", raising=False)
    monkeypatch.setenv("GIC_MXU_DX", mxu_dx)
    config = JConfig(vocab_size=40, disc_engine=jengine, **DISC)
    tconfig = Config(vocab_size=40, disc_engine=engine, **DISC)
    params = jdisc.init_discriminator_params(jax.random.PRNGKey(2), config)
    params = jax.tree_util.tree_map(lambda x: x * 20.0, params)
    rng = np.random.default_rng(3)
    soft = rng.random((B, config.seq_len, 40)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    want, g_want = jax.value_and_grad(
        lambda prm: jnp.sum(jdisc.apply(prm, jnp.asarray(soft), config) ** 2))(
        params)
    disc = discriminator_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                  tconfig)
    got = (tdisc.apply(tdisc.params_of(disc), torch.from_numpy(soft),
                       tconfig) ** 2).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **VAL)
    g_torch = discriminator_to_torch(g_want)
    for k, v in disc.named_parameters():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(g_torch[k]),
                                   err_msg=k, **GRAD)


V, TEMP = 64, 2.0
KW = dict(vocab_size=V, gen_embed_dim=8, gen_hidden_dim=16, gen_num_layers=2,
          max_seq_len=4, disc_embed_dim=8, disc_num_rep=4,
          disc_filter_sizes=(2, 3), disc_num_filters=(5, 6), gen_lr=1e-3,
          disc_lr=1e-3, disc_engine="pallas")


@pytest.fixture
def no_state_shardings():
    """The JAX step without process-wide state shardings: the ZeRO-1
    instructor test (``tests/test_parallel.py``) leaves them set on its
    worker, and the steps here run without a mesh."""
    prev = jsteps._STATE_SHARDINGS
    jsteps.set_state_shardings(None)
    yield
    jsteps.set_state_shardings(prev)


def test_adversarial_step_with_the_pallas_engine_matches_jax(
        monkeypatch, no_state_shardings):
    monkeypatch.delenv("GIC_DISC_KERNEL", raising=False)
    jconfig = JConfig(**KW, decode_impl="fused")
    jstate = jcreate_train_state(jconfig, jax.random.PRNGKey(0))
    config = Config(**KW)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 config)
    rng = np.random.default_rng(0)
    caps = [rng.integers(4, V, size=rng.integers(1, 5)) for _ in range(B)]
    T = config.seq_len
    jbatch = {k: jnp.asarray(v) for k, v in jmake_batch(caps, None, T).items()}
    batch = tsteps.batch_to(make_batch(caps, None, T), "cpu")
    # the JAX step's draws (train/steps.py:597,398-399)
    _, rng_step = jax.random.split(jstate.rng)
    _, r_sample, r1, r2, r3, _ = jax.random.split(rng_step, 6)
    u = np.stack([np.asarray(jax.random.uniform(k, (B, V), jnp.float32))
                  for k in jax.random.split(r_sample, T)])
    keep = [torch.from_numpy(np.array(jax.random.bernoulli(
        k, 0.8, (B * config.disc_num_rep, config.disc_feature_dim))))
        for k in (r1, r2, r3)]
    noise = {"uniforms": torch.from_numpy(u), "keep": keep}
    jstate, jm = jsteps.make_adv_step(jconfig)(jstate, jbatch, TEMP)
    state, m = tsteps.make_adv_step(config)(state, batch, TEMP, noise)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    want = {**{"g." + k: v for k, v in
               params_from_jax(jstate.gen_params).items()},
            **{"d." + k: v for k, v in
               disc_params_from_jax(jstate.disc_params).items()}}
    got = {**{"g." + k: v for k, v in state.gen.state_dict().items()},
           **{"d." + k: v for k, v in state.disc.state_dict().items()}}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **GRAD)
