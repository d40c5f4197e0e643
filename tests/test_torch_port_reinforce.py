"""The port's REINFORCE objective (``train/reinforce.py``) and the
transformer GAN's steps against the JAX package on the CPU, from the same
state (``train_state_from_jax``) and batch, with every random draw of the
JAX functions reproduced from their keys and fed to the port: the sample's
Gumbel uniforms (``jax.random.split(rng_sample, T)``), the rollouts'
uniforms (``split(rng_roll, P)``, then ``split(rng_p, T)`` over ``B·K``
rows), the dropout keep masks.  Covered: ``position_reward_index``,
``rollout_rewards`` (transformer and LSTM generators; transformer,
autoregressive and CNN discriminators), ``sequence_log_probs`` and its
gradient, ``reinforce_losses`` with both baselines (losses and both
gradient sets), and whole steps: the transformer MLE step with lengths,
two REINFORCE steps and a Gumbel adversarial step.

Tolerance: losses and rewards rtol 1e-5 / atol 1e-6; gradients atol 1e-5 /
rtol 1e-4; parameters after a step atol 1e-5 / rtol 1e-4 (float32 sums in
another order, through Adam's normalised updates)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.loader import make_batch as jmake_batch
from gan_image_captioning_tpu.models import api as japi
from gan_image_captioning_tpu.train import reinforce as jrl
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu.train.state import (
    create_train_state as jcreate_train_state)
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.models import api as tapi
from gan_image_captioning_tpu_torch.train import reinforce as trl
from gan_image_captioning_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

B, V = 3, 32
KW = dict(vocab_size=V, gen_arch="transformer", disc_arch="transformer",
          gen_embed_dim=16, gen_hidden_dim=16, gen_num_layers=1,
          gen_num_heads=2, max_seq_len=5, disc_embed_dim=8,
          disc_hidden_dim=16, disc_num_heads=2, disc_num_layers=1,
          adv_objective="reinforce", rollout_num=2, rollout_stride=3,
          gen_lr=1e-3, disc_lr=1e-3, disc_num_rep=4,
          disc_filter_sizes=(2, 3), disc_num_filters=(5, 6))
VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(atol=1e-5, rtol=1e-4)
PARAM = dict(atol=1e-5, rtol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(seed=0, **over):
    jconfig = JConfig(**KW, decode_impl="fused").replace(**over)
    config = Config(**KW).replace(**over)
    jstate = jcreate_train_state(jconfig, jax.random.PRNGKey(seed))
    state = interop.train_state_from_jax(_np(jstate), config)
    rng = np.random.default_rng(seed)
    caps = [rng.integers(4, V, size=rng.integers(1, 6)) for _ in range(B)]
    T = config.seq_len
    jbatch = {k: jnp.asarray(v) for k, v in jmake_batch(caps, None, T).items()}
    batch = tsteps.batch_to(make_batch(caps, None, T), "cpu")
    return jconfig, config, jstate, state, jbatch, batch


def _flat(config, tree, gen: bool):
    if gen:
        return (interop.flatten_jax({"decoder": _np(tree)["decoder"]})
                if config.gen_arch == "transformer"
                else interop.params_from_jax(_np(tree)))
    return (interop.flatten_jax(_np(tree)) if config.disc_arch != "cnn"
            else interop.disc_params_from_jax(_np(tree)))


def _uniforms(key, t, rows):
    return np.stack([np.array(jax.random.uniform(k, (rows, V), jnp.float32))
                     for k in jax.random.split(key, t)])


def _rollout_uniforms(config, key, t):
    p = len(range(config.rollout_stride, t, config.rollout_stride))
    rows = B * config.rollout_num
    return [torch.from_numpy(_uniforms(k, t, rows))
            for k in jax.random.split(key, p)]


def _reinforce_noise(config, key, t):
    """The draws of JAX ``reinforce_losses(rng=key, train=True)``."""
    r_sample, r_roll, r_d1, r_d2, _ = jax.random.split(key, 5)
    shape = tapi.disc_keep_shape(config, B)
    return {"uniforms": torch.from_numpy(_uniforms(r_sample, t, B)),
            "rollout_uniforms": _rollout_uniforms(config, r_roll, t),
            "keep": [torch.from_numpy(np.array(jax.random.bernoulli(
                k, 0.8, shape))) for k in (r_d1, r_d2)],
            "seed": 0}


def test_position_reward_index_matches_jax():
    for t, stride, n in [(9, 3, 2), (7, 3, 2), (4, 8, 0), (36, 4, 8)]:
        np.testing.assert_array_equal(
            trl.position_reward_index(t, stride, n).numpy(),
            np.asarray(jrl.position_reward_index(t, stride, n)))


@pytest.mark.parametrize("gen_arch,disc_arch", [
    ("transformer", "transformer"), ("transformer", "ar_transformer"),
    ("lstm", "cnn")])
def test_rollout_rewards_match_jax(gen_arch, disc_arch):
    jconfig, config, jstate, state, jbatch, _ = _setup(
        1, gen_arch=gen_arch, disc_arch=disc_arch)
    T = config.seq_len
    ids = np.random.default_rng(2).integers(0, V, (B, T)).astype(np.int32)
    feats = np.array(japi.generator_condition(
        jconfig, jstate.gen_params, jbatch, False)[0]["features"])
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda g, d: jrl.rollout_rewards(
        jconfig, g, d, {"features": jnp.asarray(feats), "context": None},
        jnp.asarray(ids), key))(jstate.gen_params, jstate.disc_params)
    got = trl.rollout_rewards(
        config, state.gen, tsteps.params_of(state.disc),
        torch.from_numpy(feats), torch.from_numpy(ids),
        _rollout_uniforms(config, key, T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)
    assert got.shape == (B, T) and not got.requires_grad


def test_sequence_log_probs_and_gradient_match_jax():
    jconfig, config, jstate, state, jbatch, _ = _setup(2)
    T = config.seq_len
    ids = np.random.default_rng(4).integers(0, V, (B, T)).astype(np.int32)
    g = np.random.default_rng(5).standard_normal((B, T)).astype(np.float32)
    feats_fn = lambda gp: japi.generator_condition(  # noqa: E731
        jconfig, gp, jbatch, False)[0]

    def jloss(gp):
        return jnp.sum(jrl.sequence_log_probs(jconfig, gp, feats_fn(gp),
                                              jnp.asarray(ids)) * g)

    want = jrl.sequence_log_probs(jconfig, jstate.gen_params,
                                  feats_fn(jstate.gen_params),
                                  jnp.asarray(ids))
    jgrads = _flat(config, jax.jit(jax.grad(jloss))(jstate.gen_params), True)
    cond, _ = tapi.generator_condition(config, state.gen,
                                       {"captions": torch.zeros((B, T))})
    got = trl.sequence_log_probs(config, state.gen, cond["features"],
                                 torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL)
    params = dict(state.gen.named_parameters())
    grads = torch.autograd.grad(got, list(params.values()),
                                torch.from_numpy(g), allow_unused=True)
    for (name, p), gr in zip(params.items(), grads):
        gr = torch.zeros_like(p) if gr is None else gr
        np.testing.assert_allclose(gr.numpy(), jgrads[name].numpy(),
                                   err_msg=name, **GRAD)


@pytest.mark.parametrize("baseline", ["greedy", "batch_mean"])
def test_reinforce_losses_and_gradients_match_jax(baseline):
    jconfig, config, jstate, state, jbatch, batch = _setup(
        3, rl_baseline=baseline)
    key = jax.random.PRNGKey(6)

    def losses(gp, dp):
        return jrl.reinforce_losses(jconfig, gp, dp, jbatch, key, 1.0, True)

    g_loss, d_loss, aux = jax.jit(losses)(jstate.gen_params,
                                          jstate.disc_params)
    gg = jax.jit(jax.grad(lambda gp: losses(gp, jstate.disc_params)[0]))(
        jstate.gen_params)
    dg = jax.jit(jax.grad(lambda dp: losses(jstate.gen_params, dp)[1]))(
        jstate.disc_params)
    noise = _reinforce_noise(config, key, config.seq_len)
    got = tsteps.adv_grads(config, state, batch, 1.0, noise)
    np.testing.assert_array_equal(got[4]["gen_ids"].numpy(),
                                  np.asarray(aux["gen_ids"]))
    np.testing.assert_allclose(float(got[0]), float(g_loss), **VAL)
    np.testing.assert_allclose(float(got[1]), float(d_loss), **VAL)
    np.testing.assert_allclose(float(got[4]["mean_reward"]),
                               float(aux["mean_reward"]), **VAL)
    for side, want in ((got[2], _flat(config, gg, True)),
                       (got[3], _flat(config, dg, False))):
        for name, gr in side.items():
            np.testing.assert_allclose(gr.numpy(), want[name].numpy(),
                                       err_msg=name, **GRAD)


def _assert_same_params(config, state, jstate, tag):
    for mod, tree, gen in ((state.gen, jstate.gen_params, True),
                           (state.disc, jstate.disc_params, False)):
        want = _flat(config, tree, gen)
        got = mod.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       err_msg=f"{tag}: {k}", **PARAM)


def test_mle_and_reinforce_steps_match_jax():
    jconfig, config, jstate, state, jbatch, batch = _setup(4)
    jmle, mle = jsteps.make_mle_step(jconfig), tsteps.make_mle_step(config)
    for i in range(2):
        jstate, jm = jmle(jstate, jbatch)
        state, m = mle(state, batch)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=f"mle {i}: {k}", **VAL)
        _assert_same_params(config, state, jstate, f"mle {i}")
    jadv, adv = jsteps.make_adv_step(jconfig), tsteps.make_adv_step(config)
    for i in range(2):
        _, rng_step = jax.random.split(jstate.rng)
        noise = _reinforce_noise(config, rng_step, config.seq_len)
        jstate, jm = jadv(jstate, jbatch, 1.0)
        state, m = adv(state, batch, 1.0, noise)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=f"adv {i}: {k}", **VAL)
        _assert_same_params(config, state, jstate, f"adv {i}")
    assert (state.gen_steps, state.disc_steps) == (2, 2)


def test_gumbel_adversarial_step_with_transformers_matches_jax():
    """``--adv-objective gumbel`` with the transformer generator and
    discriminator: the fused sampler's backward through the cache decode,
    three discriminator passes."""
    jconfig, config, jstate, state, jbatch, batch = _setup(
        5, adv_objective="gumbel")
    T, temp = config.seq_len, 2.0
    _, rng_step = jax.random.split(jstate.rng)
    _, r_sample, r1, r2, r3, _ = jax.random.split(rng_step, 6)
    shape = tapi.disc_keep_shape(config, B)
    noise = {"uniforms": torch.from_numpy(_uniforms(r_sample, T, B)),
             "keep": [torch.from_numpy(np.array(jax.random.bernoulli(
                 k, 0.8, shape))) for k in (r1, r2, r3)]}
    jstate, jm = jsteps.make_adv_step(jconfig)(jstate, jbatch, temp)
    state, m = tsteps.make_adv_step(config)(state, batch, temp, noise)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   **VAL)
    _assert_same_params(config, state, jstate, "gumbel")
