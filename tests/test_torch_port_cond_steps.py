"""The conditional training steps of the port against the JAX package's
(``decode_impl="fused"``, the XLA discriminator engine), from the same
state (``train_state_from_jax``) and batch: the MLE step (``free`` and
``teacher``) and the adversarial step on ``images`` (normalized float) and
``images_u8`` (normalized by ``image_norm`` inside the step) batches, with
the JAX adversarial step's draws fed to the port (as
``tests/test_torch_port_steps.py`` does).  After each step the losses and
metrics, every parameter and every BatchNorm running statistic must agree.
The eval steps move no statistic, and every step runs the encoder once.

Tolerance: metrics rtol 1e-5, atol 1e-7; parameters and running
statistics atol 1e-5, rtol 1e-4.  Images are 32 x 32, 8 per batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.loader import make_batch as jmake_batch
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu.train.state import (
    create_train_state as jcreate_train_state)
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.interop import (disc_params_from_jax,
                                                    params_from_jax,
                                                    train_state_from_jax)
from gan_image_captioning_tpu_torch.kernels import image_norm
from gan_image_captioning_tpu_torch.models import encoder as tenc
from gan_image_captioning_tpu_torch.train import steps as tsteps
from gan_image_captioning_tpu_torch.train.state import (create_train_state,
                                                        trainable_parameters)

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

B, V, S, TEMP, FLIP = 8, 40, 32, 2.0, 0.25
KW = dict(vocab_size=V, gen_embed_dim=16, gen_hidden_dim=16, gen_num_layers=2,
          max_seq_len=4, disc_embed_dim=8, disc_num_rep=4,
          disc_filter_sizes=(2, 3), disc_num_filters=(5, 6),
          disc_train_freq=2, label_smoothing=0.1, noisy_labels=FLIP,
          gen_lr=1e-3, disc_lr=1e-3, conditional_gan=1, image_size=S)
METRIC = dict(rtol=1e-5, atol=1e-7)
PARAM = dict(atol=1e-5, rtol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(kind, seed=0):
    rng = np.random.default_rng(seed)
    caps = [rng.integers(4, V, size=rng.integers(1, 5)) for _ in range(B)]
    if kind == "images_u8":
        imgs = [rng.integers(0, 256, (3, S, S)).astype(np.uint8)
                for _ in range(B)]
    else:
        imgs = [(rng.standard_normal((3, S, S)) * rng.uniform(0.5, 2)
                 + rng.uniform(-1, 1, (3, 1, 1))).astype(np.float32)
                for _ in range(B)]
    return caps, imgs


def _start(kind, **kw):
    """(jconfig, config, jstate, state, jbatch, batch) — a fresh JAX state
    per call: the JAX steps donate theirs."""
    jconfig = JConfig(**KW, decode_impl="fused", **kw)
    config = Config(**KW, **kw)
    jstate = jcreate_train_state(jconfig, jax.random.PRNGKey(0))
    state = train_state_from_jax(_np(jstate), config)
    caps, imgs = _data(kind)
    jbatch = {k: jnp.asarray(v)
              for k, v in jmake_batch(caps, imgs, config.seq_len).items()}
    batch = tsteps.batch_to(make_batch(caps, imgs, config.seq_len), "cpu")
    assert kind in batch and kind in jbatch
    return jconfig, config, jstate, state, jbatch, batch


def _assert_same_state(state, jstate, tag):
    """Every parameter and running statistic (the generator's state_dict
    includes the encoder's buffers)."""
    want = {**{"g." + k: v for k, v in
               params_from_jax(_np(jstate.gen_params)).items()},
            **{"d." + k: v for k, v in
               disc_params_from_jax(_np(jstate.disc_params)).items()}}
    got = {**{"g." + k: v for k, v in state.gen.state_dict().items()},
           **{"d." + k: v for k, v in state.disc.state_dict().items()}}
    assert got.keys() == want.keys()
    assert sum("running_var" in k for k in got) == 21
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=f"{tag}: {k}", **PARAM)


def _jax_adv_noise(jstate, seq_len, num_rep, feature_dim):
    """The draws of the JAX adversarial step from ``jstate.rng``."""
    _, rng_step = jax.random.split(jstate.rng)
    _, r_sample, r1, r2, r3, r_flip = jax.random.split(rng_step, 6)
    u = np.stack([np.asarray(jax.random.uniform(k, (B, V), jnp.float32))
                  for k in jax.random.split(r_sample, seq_len)])
    keep = [torch.from_numpy(np.array(jax.random.bernoulli(
        k, 0.8, (B * num_rep, feature_dim)))) for k in (r1, r2, r3)]
    flip = torch.from_numpy(np.array(jax.random.bernoulli(r_flip, FLIP, (B,))))
    return {"uniforms": torch.from_numpy(u), "keep": keep, "flip": flip}


@pytest.mark.parametrize("objective,kind", [
    ("free", "images"), ("free", "images_u8"), ("teacher", "images"),
    ("teacher", "images_u8")])
def test_mle_steps_match_jax(objective, kind):
    jconfig, config, jstate, state, jbatch, batch = _start(
        kind, mle_objective=objective)
    jmle, mle = jsteps.make_mle_step(jconfig), tsteps.make_mle_step(config)
    for i in range(2):
        jstate, jm = jmle(jstate, jbatch)
        state, m = mle(state, batch)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=f"mle {i}: {k}", **METRIC)
        _assert_same_state(state, jstate, f"mle {i}")


@pytest.mark.parametrize("kind", ["images", "images_u8"])
def test_adv_steps_match_jax(kind):
    jconfig, config, jstate, state, jbatch, batch = _start(kind)
    jadv, adv = jsteps.make_adv_step(jconfig), tsteps.make_adv_step(config)
    for i in range(2):
        noise = _jax_adv_noise(jstate, config.seq_len, config.disc_num_rep,
                               config.disc_feature_dim)
        jstate, jm = jadv(jstate, jbatch, TEMP)
        state, m = adv(state, batch, TEMP, noise)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=f"adv {i}: {k}", **METRIC)
        _assert_same_state(state, jstate, f"adv {i}")
    assert (state.gen_steps, state.disc_steps) == (2, 1)


def test_trainable_backbone_mle_step_matches_jax():
    jconfig, config, jstate, state, jbatch, batch = _start(
        "images", trainable_backbone=1, mle_objective="teacher")
    assert "encoder.resnet.conv1.weight" in state.pretrain_opt.mu
    jstate, jm = jsteps.make_mle_step(jconfig)(jstate, jbatch)
    state, m = tsteps.make_mle_step(config)(state, batch)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   rtol=1e-4)
    _assert_same_state(state, jstate, "trainable")


def test_eval_steps_match_jax_and_move_nothing():
    jconfig, config, jstate, state, jbatch, batch = _start("images_u8")
    before = {k: v.clone() for k, v in state.gen.state_dict().items()}
    noise = _jax_adv_noise(jstate, config.seq_len, config.disc_num_rep,
                           config.disc_feature_dim)
    _, jm = jsteps.make_mle_eval_step(jconfig)(jstate, jbatch)
    _, m = tsteps.make_mle_eval_step(config)(state, batch)
    np.testing.assert_allclose(float(m["gen_pretrain_loss"]),
                               float(jm["gen_pretrain_loss"]), **METRIC)
    _, jm = jsteps.make_adv_eval_step(jconfig)(jstate, jbatch, TEMP)
    _, m = tsteps.make_adv_eval_step(config)(state, batch, TEMP, noise)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   **METRIC)
    after = state.gen.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in before.items())


@pytest.mark.parametrize("step", ["mle_free", "mle_teacher", "adv"])
def test_each_step_runs_the_encoder_once(monkeypatch, step):
    """One train-mode encoder pass per step: every running statistic moves
    by exactly one momentum update (the decode and its rescore read the
    features and never re-run the encoder)."""
    objective = "teacher" if step == "mle_teacher" else "free"
    config = Config(**dict(KW, gen_embed_dim=8, gen_hidden_dim=8),
                    mle_objective=objective)
    state = create_train_state(config, 0)
    caps, imgs = _data("images_u8", 1)
    batch = tsteps.batch_to(make_batch(caps, imgs, config.seq_len), "cpu")
    calls = []
    real = tenc.encode
    monkeypatch.setattr(tenc, "encode",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    # the statistics one train-mode pass moves them to
    probe = create_train_state(config, 0)
    with torch.no_grad():
        real(probe.gen.encoder, image_norm.normalize_images(
            batch["images_u8"]), config, True)
    if step == "adv":
        tsteps.make_adv_step(config)(state, batch, TEMP)
    else:
        tsteps.make_mle_step(config)(state, batch)
    assert len(calls) == 1
    want = {k: v for k, v in probe.gen.encoder.state_dict().items()
            if "running" in k}
    got = state.gen.encoder.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_frozen_backbone_is_kept_out_of_the_optimizer():
    """The JAX Adam sees zero gradients under stop_gradient and moves a
    frozen backbone by exactly zero; the port keeps it out of the
    optimizer, so no moments exist for it and no update touches it."""
    config = Config(**KW)
    state = create_train_state(config, 0)
    for opt in (state.pretrain_opt, state.gen_opt):
        assert not any(k.startswith("encoder.resnet.") for k in opt.mu)
        assert "encoder.linear.weight" in opt.mu
        assert "encoder.bn.weight" in opt.mu
        assert opt.mu.keys() == trainable_parameters(state.gen).keys()
    caps, imgs = _data("images", 2)
    batch = tsteps.batch_to(make_batch(caps, imgs, config.seq_len), "cpu")
    w = state.gen.encoder.resnet.conv1.weight.clone()
    head = state.gen.encoder.linear.weight.clone()
    tsteps.make_mle_step(config)(state, batch)
    assert torch.equal(state.gen.encoder.resnet.conv1.weight, w)
    assert not torch.equal(state.gen.encoder.linear.weight, head)


def test_train_state_from_jax_drops_the_frozen_backbone_moments():
    jconfig = JConfig(**KW, decode_impl="fused")
    jstate = jcreate_train_state(jconfig, jax.random.PRNGKey(1))
    caps, imgs = _data("images", 3)
    jbatch = {k: jnp.asarray(v)
              for k, v in jmake_batch(caps, imgs, jconfig.seq_len).items()}
    jstate, _ = jsteps.make_mle_step(jconfig)(jstate, jbatch)
    adam = jstate.pretrain_opt_state[1][0]
    # the JAX moments of a frozen backbone are exact zeros
    assert not np.asarray(adam.mu["encoder"]["backbone"]["conv1"]["w"]).any()
    state = train_state_from_jax(_np(jstate), Config(**KW))
    assert state.pretrain_opt.count == 1
    assert state.pretrain_opt.mu.keys() == trainable_parameters(
        state.gen).keys()
    want = params_from_jax(_np(adam.nu))
    for k, v in state.pretrain_opt.nu.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy())
    # the trainable backbone keeps its moments
    state = train_state_from_jax(_np(jstate),
                                 Config(**KW, trainable_backbone=1))
    assert "encoder.resnet.conv1.weight" in state.pretrain_opt.mu


def test_cached_backbone_features_train_the_head():
    """Refused until the slice that ported ``--cache-features``: a batch of
    cached backbone features (``backbone_feats [B, 512]``) trains the
    head alone (``encoder.project_head``), as the JAX step does: the MLE
    step's metrics, parameters and running statistics match (the
    backbone's statistics do not move)."""
    jconfig, config, jstate, state, _, _ = _start("images")
    rng = np.random.default_rng(4)
    caps = [rng.integers(4, V, size=rng.integers(1, 5)) for _ in range(B)]
    feats = [rng.standard_normal(512).astype(np.float32) for _ in range(B)]
    jbatch = {k: jnp.asarray(v)
              for k, v in jmake_batch(caps, feats, config.seq_len).items()}
    batch = tsteps.batch_to(make_batch(caps, feats, config.seq_len), "cpu")
    assert "backbone_feats" in batch and "backbone_feats" in jbatch
    before = {k: v.clone() for k, v in tenc.bn_stats(state.gen.encoder)
              .items() if k.startswith("resnet.")}
    jstate, jm = jsteps.make_mle_step(jconfig)(jstate, jbatch)
    state, m = tsteps.make_mle_step(config)(state, batch)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   **METRIC)
    _assert_same_state(state, jstate, "cached")
    after = tenc.bn_stats(state.gen.encoder)
    assert len(before) == 40
    assert all(torch.equal(v, after[k]) for k, v in before.items())
