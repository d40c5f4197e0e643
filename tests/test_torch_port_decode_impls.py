"""The decode routes of the port's ``decode_route(config)``:
``kernel_rescore`` (the JAX ``--decode-impl kernel`` with
``GIC_KERNEL_VJP=0``), ``kernel_embed`` (the JAX ``--decode-impl kernel``
with ``GIC_FUSE_EMBED=1``) and ``decoupled``.

* Samples and their gradients against the JAX package's routes on the same
  weights: ``_sample_kernel`` under ``GIC_KERNEL_VJP=0`` in interpret mode
  (zero noise: the port is fed zero uniforms), ``_sample_decoupled`` with
  the uniforms ``jax.random`` draws from its per-step keys.
* The adversarial and MLE steps of each route against the port's default
  route on the same state and fed noise (the default is held against the
  JAX steps in ``test_torch_port_steps.py``); one decoupled MLE and
  adversarial step against the JAX package's; ``main.py --decode-impl
  decoupled``.

Tolerance: ids exact; values atol = rtol = 1e-5; gradients atol 1e-5,
rtol 1e-4; step metrics rtol 1e-5 and parameters atol 1e-5, rtol 1e-4, as
``test_torch_port_steps.py`` holds them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.loader import make_batch as jmake_batch
from gan_image_captioning_tpu.models import generator as jgen
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu.train.state import (
    create_train_state as jcreate_train_state)
from gan_image_captioning_tpu_torch import main as tmain
from gan_image_captioning_tpu_torch.config import Config, decode_route
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.interop import (disc_params_from_jax,
                                                    generator_from_jax,
                                                    params_from_jax,
                                                    train_state_from_jax)
from gan_image_captioning_tpu_torch.models import generator as tgen
from gan_image_captioning_tpu_torch.train import steps as tsteps
from gan_image_captioning_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

B, T, V, E, H, NL = 4, 6, 64, 8, 16, 2
TEMP = 2.0
VAL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)
KW = dict(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
          gen_num_layers=NL, max_seq_len=T - 2, disc_embed_dim=8,
          disc_num_rep=4, disc_filter_sizes=(2, 3), disc_num_filters=(5, 6),
          disc_train_freq=2, label_smoothing=0.1, noisy_labels=0.25,
          gen_lr=1e-3, disc_lr=1e-3)
ROUTES = ("kernel_rescore", "kernel_embed", "decoupled")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("GIC_KERNEL_INTERPRET", "1")
    monkeypatch.setenv("GIC_BPTT_CHAIN", "1")


@pytest.fixture(scope="module")
def setup():
    kw = dict(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
              gen_num_layers=NL, max_seq_len=T - 2)
    jdec = jgen.init_decoder_params(jax.random.PRNGKey(13), JConfig(**kw))
    gen = generator_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    {"decoder": jdec}),
                             Config(**kw))
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((B, E)).astype(np.float32)
    probe = rng.standard_normal((B, T, V)).astype(np.float32)
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


def _check_route(setup, jsample, route, pretrain, uniforms):
    """Values and gradients of the port's sample on ``route`` against the
    JAX ``jsample(dec, features)``."""
    jdec, gen, feats, probe = setup
    out_j, ids_j = jsample(jdec, jnp.asarray(feats))
    with torch.no_grad():
        out, ids = tgen.sample(gen.decoder, torch.from_numpy(feats), T,
                               pretrain, TEMP, uniforms=uniforms,
                               route=route)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **VAL)
    assert len(np.unique(np.asarray(ids_j))) > 2   # not one token

    def jloss(dec, f):
        return jnp.sum(jsample(dec, f)[0] * probe)

    def tloss(dec, f):
        out, _ = tgen.sample(dec, f, T, pretrain, TEMP, uniforms=uniforms,
                             route=route)
        return (out * torch.from_numpy(probe)).sum()

    _assert_grads(_port_grads(gen, feats, tloss),
                  _jax_grads(jdec, feats, jloss))


def test_kernel_rescore_matches_jax_sample_kernel(setup, monkeypatch):
    monkeypatch.setenv("GIC_KERNEL_VJP", "0")
    rng = jax.random.PRNGKey(4)
    _check_route(setup, lambda d, f: jgen._sample_kernel(
        d, f, rng, jnp.float32(TEMP), T, False, None), "kernel_rescore",
        False, torch.zeros(T, B, V))


def _step_uniforms(rng):
    """The uniforms of ``jax.random.split(rng, T)``, one [B, V] per step."""
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(k, (B, V), jnp.float32))
        for k in jax.random.split(rng, T)]))


@pytest.mark.parametrize("pretrain", [False, True])
def test_decoupled_matches_jax_sample_decoupled(setup, pretrain):
    rng = jax.random.PRNGKey(22)
    _check_route(setup, lambda d, f: jgen._sample_decoupled(
        d, f, rng, jnp.float32(TEMP), T, pretrain, None), "decoupled",
        pretrain, None if pretrain else _step_uniforms(rng))


def test_decode_route_names():
    config = Config(**KW)
    assert decode_route(config) == "kernel"
    for impl in ("kernel", "kernel_rescore", "kernel_embed", "decoupled",
                 "plain"):
        assert decode_route(config.replace(decode_impl=impl)) == impl
    # the fused embed path needs an LSTM generator and the CNN discriminator
    tf = config.replace(decode_impl="kernel_embed", disc_arch="transformer")
    assert decode_route(tf) == "kernel"


def _port_setup(caps_seed=0):
    config = Config(**KW)
    rng = np.random.default_rng(caps_seed)
    caps = [rng.integers(4, V, size=rng.integers(1, 5)) for _ in range(B)]
    batch = tsteps.batch_to(make_batch(caps, None, config.seq_len), "cpu")
    g = torch.Generator().manual_seed(3)
    noise = {"uniforms": torch.rand((config.seq_len, B, V), generator=g),
             "keep": [torch.rand((B * 4, 11), generator=g) < 0.8
                      for _ in range(3)],
             "flip": torch.tensor([True, False, False, True])}
    return config, batch, noise


def _assert_same_grads(got, want, tag):
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-7,
                                   err_msg=tag)
    for side in (2, 3):
        assert got[side].keys() == want[side].keys()
        for k in want[side]:
            np.testing.assert_allclose(got[side][k].numpy(),
                                       want[side][k].numpy(),
                                       err_msg=f"{tag}: {k}", **GRAD)


@pytest.mark.parametrize("route", ROUTES)
def test_route_steps_match_the_default_route(route):
    """Losses and every gradient of one adversarial and one MLE pass equal
    the default route's; then the route's steps train."""
    config, batch, noise = _port_setup()
    cfg = config.replace(decode_impl=route)
    state = create_train_state(config, 0)
    _assert_same_grads(tsteps.adv_grads(cfg, state, batch, TEMP, noise),
                       tsteps.adv_grads(config, state, batch, TEMP, noise),
                       f"{route} adv")
    for mle_cfg in (cfg, cfg.replace(mle_objective="teacher")):
        got = tsteps._grads(tsteps.mle_loss(mle_cfg, state, batch),
                            state.gen)[0]
        want = tsteps._grads(tsteps.mle_loss(
            config.replace(mle_objective=mle_cfg.mle_objective), state,
            batch), state.gen)[0]
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       err_msg=f"{route} mle {k}", **GRAD)
    state, m = tsteps.make_mle_step(cfg)(state, batch)
    assert np.isfinite(float(m["gen_pretrain_loss"]))
    state, m = tsteps.make_adv_step(cfg)(state, batch, TEMP, noise)
    _, m_eval = tsteps.make_adv_eval_step(cfg)(state, batch, TEMP, noise)
    assert all(np.isfinite(float(v)) for v in [*m.values(),
                                               *m_eval.values()])
    assert (state.gen_steps, state.disc_steps) == (1, 1)


@pytest.fixture
def no_state_shardings():
    """The JAX step without process-wide state shardings: the ZeRO-1
    instructor test (``tests/test_parallel.py``) leaves them set on its
    worker, and the steps here run without a mesh."""
    prev = jsteps._STATE_SHARDINGS
    jsteps.set_state_shardings(None)
    yield
    jsteps.set_state_shardings(prev)


def test_decoupled_steps_match_jax(monkeypatch, no_state_shardings):
    """One MLE and one adversarial step under ``--decode-impl decoupled``
    against the JAX package's, from the same state, with the JAX
    adversarial step's draws fed to the port."""
    monkeypatch.delenv("GIC_KERNEL_INTERPRET")
    jconfig = JConfig(**KW, decode_impl="decoupled")
    jstate = jcreate_train_state(jconfig, jax.random.PRNGKey(0))
    config = Config(**KW, decode_impl="decoupled")
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 config)
    rng = np.random.default_rng(0)
    caps = [rng.integers(4, V, size=rng.integers(1, 5)) for _ in range(B)]
    jbatch = {k: jnp.asarray(v) for k, v in
              jmake_batch(caps, None, config.seq_len).items()}
    batch = tsteps.batch_to(make_batch(caps, None, config.seq_len), "cpu")

    jstate, jm = jsteps.make_mle_step(jconfig)(jstate, jbatch)
    state, m = tsteps.make_mle_step(config)(state, batch)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=f"mle {k}")

    _, rng_step = jax.random.split(jstate.rng)
    _, r_sample, r1, r2, r3, r_flip = jax.random.split(rng_step, 6)
    keep = [torch.from_numpy(np.array(jax.random.bernoulli(
        k, 0.8, (B * 4, config.disc_feature_dim)))) for k in (r1, r2, r3)]
    flip = torch.from_numpy(np.array(jax.random.bernoulli(r_flip, 0.25,
                                                          (B,))))
    noise = {"uniforms": _step_uniforms(r_sample), "keep": keep,
             "flip": flip}
    jstate, jm = jsteps.make_adv_step(jconfig)(jstate, jbatch, TEMP)
    state, m = tsteps.make_adv_step(config)(state, batch, TEMP, noise)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=f"adv {k}")
    want = {**{"g." + k: v for k, v in params_from_jax(jax.tree_util.tree_map(
                np.asarray, jstate.gen_params)).items()},
            **{"d." + k: v for k, v in disc_params_from_jax(
                jax.tree_util.tree_map(np.asarray,
                                       jstate.disc_params)).items()}}
    got = {**{"g." + k: v for k, v in state.gen.state_dict().items()},
           **{"d." + k: v for k, v in state.disc.state_dict().items()}}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, atol=1e-5, rtol=1e-4)


TINY = ["--dataset", "synthetic", "--synthetic-items", "16",
        "--gen-embed-dim", "8", "--gen-hidden-dim", "8",
        "--gen-num-layers", "1", "--max-seq-len", "5",
        "--disc-embed-dim", "4", "--disc-num-rep", "4",
        "--disc-filter-sizes", "2,3", "--disc-num-filters", "3,3",
        "--pre-train-batch-size", "8", "--pre-eval-batch-size", "8",
        "--adv-train-batch-size", "8", "--adv-eval-batch-size", "8",
        "--pretrain-epochs", "1", "--adv-epochs", "1", "--device", "cpu"]


def test_main_trains_with_decode_impl_decoupled(tmp_path):
    inst = tmain.main([*TINY, "--decode-impl", "decoupled", "--save-dir",
                       str(tmp_path / "s")])
    assert decode_route(inst.config) == "decoupled"
    assert inst.state.gen_steps > 0
    assert (tmp_path / "s").exists()
