"""The port's ``make_mle_step`` and ``make_adv_step`` against the JAX
package's jitted steps (``decode_impl="fused"``, the XLA discriminator
engine), from the same state (``train_state_from_jax``) and batch, with
every random draw of the JAX adversarial step reproduced from its key
tree (``train/steps.py:597,398-399``) and fed to the port: the Gumbel
uniforms of the per-step keys, the three dropout keep masks and the
noisy-label flips.  Three MLE steps, then three adversarial steps with
``disc_train_freq = 2``, label smoothing and noisy labels.

Tolerance: losses and metrics rtol 1e-5, atol 1e-7; every parameter after
each step atol 1e-5, rtol 1e-4 (float32 sums in another order, through
Adam's normalised updates)."""

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
from gan_image_captioning_tpu_torch.train import steps as tsteps
from gan_image_captioning_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

B, V, TEMP, FLIP = 4, 64, 2.0, 0.25
KW = dict(vocab_size=V, gen_embed_dim=8, gen_hidden_dim=16, gen_num_layers=2,
          max_seq_len=4, disc_embed_dim=8, disc_num_rep=4,
          disc_filter_sizes=(2, 3), disc_num_filters=(5, 6),
          disc_train_freq=2, label_smoothing=0.1, noisy_labels=FLIP,
          gen_lr=1e-3, disc_lr=1e-3)
METRIC = dict(rtol=1e-5, atol=1e-7)
PARAM = dict(atol=1e-5, rtol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def start():
    """A fresh JAX state per test: the JAX steps donate theirs."""
    jconfig = JConfig(**KW, decode_impl="fused")
    jstate = jcreate_train_state(jconfig, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    caps = [rng.integers(4, V, size=rng.integers(1, 5)) for _ in range(B)]
    return jconfig, jstate, caps


def _assert_same_params(state, jstate, tag):
    want = {**{"g." + k: v for k, v in
               params_from_jax(_np(jstate.gen_params)).items()},
            **{"d." + k: v for k, v in
               disc_params_from_jax(_np(jstate.disc_params)).items()}}
    got = {**{"g." + k: v for k, v in state.gen.state_dict().items()},
           **{"d." + k: v for k, v in state.disc.state_dict().items()}}
    assert got.keys() == want.keys()
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


def test_mle_then_adv_steps_match_jax(start):
    jconfig, jstate, caps = start
    config = Config(**KW)
    state = train_state_from_jax(_np(jstate), config)
    T = config.seq_len
    jbatch = {k: jnp.asarray(v) for k, v in
              jmake_batch(caps, None, T).items()}
    batch = tsteps.batch_to(make_batch(caps, None, T), "cpu")

    jmle, mle = jsteps.make_mle_step(jconfig), tsteps.make_mle_step(config)
    for i in range(3):
        jstate, jm = jmle(jstate, jbatch)
        state, m = mle(state, batch)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=f"mle {i}: {k}", **METRIC)
        _assert_same_params(state, jstate, f"mle {i}")

    jadv, adv = jsteps.make_adv_step(jconfig), tsteps.make_adv_step(config)
    for i in range(3):
        noise = _jax_adv_noise(jstate, T, config.disc_num_rep,
                               config.disc_feature_dim)
        jstate, jm = jadv(jstate, jbatch, TEMP)
        state, m = adv(state, batch, TEMP, noise)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=f"adv {i}: {k}", **METRIC)
        _assert_same_params(state, jstate, f"adv {i}")
    assert (state.gen_steps, state.disc_steps) == (3, 2)
    assert (int(jstate.gen_steps), int(jstate.disc_steps)) == (3, 2)
    assert state.temperature == TEMP


def test_train_state_from_jax_carries_the_optimizer_state(start):
    jconfig, jstate, caps = start
    jbatch = {k: jnp.asarray(v) for k, v in
              jmake_batch(caps, None, jconfig.seq_len).items()}
    jstate, _ = jsteps.make_mle_step(jconfig)(jstate, jbatch)
    state = train_state_from_jax(_np(jstate), Config(**KW))
    adam = jstate.pretrain_opt_state[1][0]
    assert state.pretrain_opt.count == int(adam.count) == 1
    assert state.gen_opt.count == state.disc_opt.count == 0
    want = params_from_jax(_np(adam.nu))
    for k, v in state.pretrain_opt.nu.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy())
    assert state.pretrain_opt.mu.keys() == dict(
        state.gen.named_parameters()).keys()
    assert state.disc_opt.mu.keys() == dict(
        state.disc.named_parameters()).keys()


def test_make_batch_matches_jax():
    caps = [np.arange(4, 9), np.arange(10, 60), np.array([5])]
    want = jmake_batch(caps, None, 12, batch_size=4)
    got = make_batch(caps, None, 12, batch_size=4)
    assert got.keys() == {"captions", "lengths", "weights"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_noisy_label_flip_matches_jax():
    real = np.arange(12, dtype=np.float32)
    fake = -real
    key = jax.random.PRNGKey(4)
    flip = np.array(jax.random.bernoulli(key, 0.5, (3,)))
    want = jsteps.noisy_label_flip(key, jnp.asarray(real), jnp.asarray(fake),
                                   0.5, 4)
    got = tsteps.noisy_label_flip(torch.from_numpy(flip),
                                  torch.from_numpy(real),
                                  torch.from_numpy(fake), 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_steps_draw_their_own_noise_and_train():
    """Without fed noise the adversarial step draws from the state's
    generator: two states seeded alike stay equal, and the losses are
    finite."""
    config = Config(**KW)
    batch = tsteps.batch_to(make_batch([np.arange(4, 8)] * B, None,
                                       config.seq_len), "cpu")
    a, b = create_train_state(config, 3), create_train_state(config, 3)
    adv = tsteps.make_adv_step(config)
    for _ in range(2):
        a, ma = adv(a, batch, TEMP)
        b, mb = adv(b, batch, TEMP)
        assert all(np.isfinite(float(v)) for v in ma.values())
        assert {k: float(v) for k, v in ma.items()} == {
            k: float(v) for k, v in mb.items()}
    for x, y in zip(a.gen.parameters(), b.gen.parameters()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("override", [
    {"dtype": "bfloat16", "decode_impl": "decoupled"},
    {"disc_arch": "bilstm"}])
def test_ported_training_options_take_a_step(override):
    """Refused until this slice, honoured now: the bfloat16 decoupled
    route and the BiLSTM discriminator each take an MLE and an
    adversarial step with finite losses (their values are held against
    the JAX package in tests/test_torch_port_bf16_routes.py and
    tests/test_torch_port_extras.py)."""
    config = Config(**KW).replace(**override)
    state = create_train_state(config, 3)
    host = make_batch([np.arange(4, 8)] * 4, None, config.seq_len)
    batch = tsteps.batch_to(host, "cpu")
    state, m = tsteps.make_mle_step(config)(state, batch)
    state, m2 = tsteps.make_adv_step(config)(state, batch, TEMP)
    assert all(np.isfinite(float(v)) for v in (*m.values(), *m2.values()))


def test_teacher_mle_objective_matches_jax(start):
    jconfig, jstate, caps = start
    jconfig = jconfig.replace(mle_objective="teacher")
    config = Config(**KW, mle_objective="teacher")
    state = train_state_from_jax(_np(jstate), config)
    jbatch = {k: jnp.asarray(v) for k, v in
              jmake_batch(caps, None, jconfig.seq_len).items()}
    batch = tsteps.batch_to(make_batch(caps, None, config.seq_len), "cpu")
    jstate, jm = jsteps.make_mle_step(jconfig)(jstate, jbatch)
    state, m = tsteps.make_mle_step(config)(state, batch)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   **METRIC)
    _assert_same_params(state, jstate, "teacher")


@pytest.mark.parametrize("override", [
    {"gen_arch": "gpt2"}, {"gen_arch": "transformer", "conditional_gan": 1},
    {"conditional_gan": 1, "encoder_arch": "vit"},
    {"gen_arch": "gpt2", "conditional_gan": 1, "encoder_arch": "vit",
     "dtype": "bfloat16"}])
def test_config5_training_options_build(override):
    """The options refused until the conditional transformer was ported:
    every step builds (``gen_arch="gpt2"`` expanded as
    ``config_from_args`` expands it); their steps run against the JAX
    package in test_torch_port_cond_transformer.py."""
    from gan_image_captioning_tpu_torch.config import GPT2_GEOMETRY

    config = Config(**KW).replace(**override)
    if config.gen_arch == "gpt2":
        config = config.replace(**GPT2_GEOMETRY)
    for make in (tsteps.make_adv_step, tsteps.make_mle_step,
                 tsteps.make_mle_eval_step, tsteps.make_adv_eval_step):
        assert callable(make(config))
