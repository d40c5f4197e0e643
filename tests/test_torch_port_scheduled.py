"""``--mle-objective scheduled`` (scheduled sampling, Bengio et al. 2015)
of the port against the JAX package on the CPU, as
``tests/test_mle_objectives.py`` holds the JAX one: the port's
``generator.scheduled_sample`` fed the JAX function's per-step coins
(``bernoulli(k_t, p, (B,))`` over ``jax.random.split(rng, T)``) at p = 0,
0.5 and 1, its logits and their gradient; p = 0 is the teacher-forced
pass and p = 1 the free-running greedy sample in the port too; the MLE
step (with and without ``--grad-accum 2``) and the eval step against the
JAX steps; the transformer keeps its teacher-forced MLE; and the
instructor's per-epoch ramp, the JAX instructor's ``ss_max_prob · epoch /
max(1, epochs − 1)``, fed to the train and val steps.

The model's own argmax feeds the next step, so a near-tie of two logits
could send the two packages down different inputs: the JAX weights are
scaled by ``PEAK`` = 8 (as ``tests/test_torch_port_beam.py`` does), which
parts the logits far beyond float32 rounding.

Tolerance: logits and losses rtol 1e-5, atol 1e-5; gradients and
parameters after a step atol 1e-5, rtol 1e-4."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.models import api as japi
from gan_image_captioning_tpu.models import generator as jgen
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu.train.state import (
    create_train_state as jcreate_train_state)
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.data.synthetic import SyntheticCaptions
from gan_image_captioning_tpu_torch.models import api as tapi
from gan_image_captioning_tpu_torch.models import generator as tgen
from gan_image_captioning_tpu_torch.train import steps as tsteps
from gan_image_captioning_tpu_torch.train.instructor import GANInstructor
from gan_image_captioning_tpu_torch.train.state import create_train_state

B, V, PEAK = 4, 32, 8.0
KW = dict(vocab_size=V, gen_embed_dim=8, gen_hidden_dim=12,
          gen_num_layers=2, max_seq_len=5, mle_objective="scheduled",
          pretrain_lr=1e-3)
VAL = dict(rtol=1e-5, atol=1e-5)
PARAM = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture
def no_state_shardings():
    """No process-wide JAX state shardings: the ZeRO-1 instructor test
    (``tests/test_parallel.py``) leaves them set on its worker."""
    prev = jsteps._STATE_SHARDINGS
    jsteps.set_state_shardings(None)
    yield
    jsteps.set_state_shardings(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _peaked(tree):
    return jax.tree_util.tree_map(lambda a: a * PEAK, tree)


def _coins(key, p, t, b):
    """The JAX ``scheduled_sample``'s coins ``[T, B]`` for ``key``."""
    return torch.from_numpy(np.stack([np.array(jax.random.bernoulli(
        k, p, (b,))) for k in jax.random.split(key, t)]))


def _captions(config, seed, rows=B):
    rng = np.random.default_rng(seed)
    caps = [rng.integers(4, V, size=rng.integers(1, config.max_seq_len + 1))
            for _ in range(rows)]
    return make_batch(caps, None, config.seq_len)


@pytest.fixture(scope="module")
def models():
    jconfig, config = JConfig(**KW), Config(**KW)
    gp = _peaked(japi.init_generator(jax.random.PRNGKey(0), jconfig))
    gen = interop.generator_from_jax(_np(gp), config)
    host = _captions(config, 1)
    caps = jnp.asarray(host["captions"])
    feats = np.asarray(japi.generator_condition(
        jconfig, gp, {"captions": caps}, False)[0]["features"])
    return jconfig, config, gp, gen, host, feats


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_scheduled_sample_and_gradient_match_jax(models, p):
    jconfig, config, gp, gen, host, feats = models
    key = jax.random.PRNGKey(7)
    T = config.seq_len
    g = np.random.default_rng(2).standard_normal((B, T, V)).astype(np.float32)

    def jloss(dec):
        logits = jgen.scheduled_sample(dec, jnp.asarray(feats),
                                       jnp.asarray(host["captions"]), key,
                                       jnp.float32(p))
        return jnp.sum(logits * g), logits

    (_, want), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        gp["decoder"])
    coins = _coins(key, p, T, B)
    gen.zero_grad()
    got = tgen.scheduled_sample(gen.decoder, torch.from_numpy(feats),
                                torch.from_numpy(host["captions"]), p, coins)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL)
    want_grad = interop.params_from_jax(_np({"decoder": jgrad}))
    for k, prm in gen.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want_grad[k].numpy(),
                                   err_msg=k, **PARAM)
    assert coins.dtype == torch.bool and coins.shape == (T, B)


def test_p0_is_teacher_forcing_and_p1_the_free_sample(models):
    """In the port alone: at p = 0 the teacher-forced pass, at p = 1 the
    free objective's logits (the greedy ids' rescore); the draw at p = 0.5
    is the generator's (equal draws, equal logits)."""
    _, config, _, gen, host, feats = models
    feats, caps = torch.from_numpy(feats), torch.from_numpy(host["captions"])
    cond = {"features": feats, "context": None}
    with torch.no_grad():
        teacher = tgen.teacher_forced(gen.decoder, feats, caps)
        free = tapi.generator_mle_outputs(
            gen, cond, caps, config.replace(mle_objective="free"))
        p0 = tapi.generator_mle_outputs(gen, cond, caps, config,
                                        sample_prob=0.0)
        p1 = tapi.generator_mle_outputs(gen, cond, caps, config,
                                        sample_prob=1.0)
        half = [tapi.generator_mle_outputs(
            gen, cond, caps, config, sample_prob=0.5,
            draw=torch.Generator().manual_seed(3)) for _ in range(2)]
    np.testing.assert_allclose(p0.numpy(), teacher[:, :caps.shape[1]].numpy(),
                               **VAL)
    np.testing.assert_allclose(p1.numpy(), free.numpy(), **VAL)
    assert torch.equal(half[0], half[1])
    assert not torch.allclose(half[0], p0)


def _jax_start(kw, seed):
    jconfig, config = JConfig(**kw, decode_impl="fused"), Config(**kw)
    jstate = jax.jit(lambda k: jcreate_train_state(jconfig, k))(
        jax.random.PRNGKey(seed))
    jstate = jstate._replace(gen_params=_peaked(jstate.gen_params))
    state = interop.train_state_from_jax(_np(jstate), config)
    host = _captions(config, seed)
    return jconfig, config, jstate, state, host


def _step_coins(jstate, config, p):
    """The coins of the JAX MLE step's ``mle_loss`` keys, one ``[T, B/k]``
    a microbatch (``split(rng_step, k)``, then ``split(rng)[1]``)."""
    _, rng_step = jax.random.split(jstate.rng)
    k = config.grad_accum
    keys = [rng_step] if k == 1 else jax.random.split(rng_step, k)
    noise = [{"coins": _coins(jax.random.split(r)[1], p, config.seq_len,
                              B // k)} for r in keys]
    return noise[0] if k == 1 else noise


@pytest.mark.parametrize("accum", [1, 2])
def test_scheduled_mle_steps_match_jax(no_state_shardings, accum):
    p = 0.5
    jconfig, config, jstate, state, host = _jax_start(
        dict(KW, grad_accum=accum), 3)
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    batch = tsteps.batch_to(host, "cpu")
    jstep, step = jsteps.make_mle_step(jconfig), tsteps.make_mle_step(config)
    for i in range(2):
        noise = _step_coins(jstate, config, p)
        jstate, jm = jstep(jstate, jbatch, p)
        state, m = step(state, batch, p, noise)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=f"step {i}: {k}", **VAL)
        want = interop.params_from_jax(_np(jstate.gen_params))
        for k, v in state.gen.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       err_msg=f"step {i}: {k}", **PARAM)


def test_scheduled_eval_step_matches_jax(no_state_shardings):
    p = 1.0
    jconfig, config, jstate, state, host = _jax_start(KW, 4)
    noise = _step_coins(jstate, config, p)
    _, jm = jsteps.make_mle_eval_step(jconfig)(
        jstate, {k: jnp.asarray(v) for k, v in host.items()}, p)
    _, m = tsteps.make_mle_eval_step(config)(
        state, tsteps.batch_to(host, "cpu"), p, noise)
    np.testing.assert_allclose(float(m["gen_pretrain_loss"]),
                               float(jm["gen_pretrain_loss"]), **VAL)


def test_transformer_keeps_teacher_forced_mle():
    kw = dict(vocab_size=V, gen_arch="transformer", gen_embed_dim=8,
              gen_hidden_dim=8, gen_num_layers=1, gen_num_heads=2,
              max_seq_len=4)
    config = Config(**kw, mle_objective="scheduled")
    state = create_train_state(config, 0)
    batch = tsteps.batch_to(_captions(config, 5), "cpu")
    with torch.no_grad():
        got = tsteps.mle_loss(config, state, batch, train=False,
                              sample_prob=1.0)
        want = tsteps.mle_loss(config.replace(mle_objective="teacher"),
                               state, batch, train=False)
    assert torch.equal(got, want)


def _instructor(tmp_path, epochs, ss):
    kw = dict(KW, ss_max_prob=ss, pretrain_epochs=epochs, adv_epochs=0,
              pre_train_batch_size=8, pre_eval_batch_size=8,
              vocab_size=SyntheticCaptions("train", num_items=16).vocab_size)
    return GANInstructor(Config(device="cpu", save_dir=str(tmp_path),
                                model_dir=str(tmp_path / "models"),
                                log_file=str(tmp_path / "log"), **kw),
                         SyntheticCaptions("train", num_items=16),
                         SyntheticCaptions("val", num_items=8))


@pytest.mark.parametrize("epochs,ss", [(3, 0.6), (1, 1.0), (4, 0.9)])
def test_instructor_ramp_is_the_jax_formula(tmp_path, epochs, ss):
    """The JAX instructor's ramp (``instructor.py:523-527``): epoch e of
    the pretrain phase runs its train and val sweeps at ``ss_max_prob · e
    / max(1, epochs - 1)``."""
    inst = _instructor(tmp_path, epochs, ss)
    probs = []

    def fake_loop(what, start_batch=0):
        probs.append((what, inst._ss_prob))
        return [1.0]

    inst.genpretrain_loop = fake_loop
    inst.pretrain_generator(epochs)
    inst._restore_signal_handlers()
    want = [ss * e / max(1, epochs - 1) for e in range(epochs)]
    assert probs == [(w, p) for p in want for w in ("train", "val")]
    assert os.path.isdir(inst.model_dir)


def test_instructor_feeds_the_ramp_to_both_mle_steps(tmp_path):
    """The port's sweeps hand ``_ss_prob`` to the train and val steps."""
    ti = _instructor(tmp_path, 2, 0.8)
    fed = []
    for name in ("mle_step", "mle_eval_step"):
        inner = getattr(ti, name)

        def wrapped(state, batch, p=0.0, _inner=inner, _name=name):
            fed.append((_name, p))
            return _inner(state, batch, p)

        setattr(ti, name, wrapped)
    ti.pretrain_generator(2)
    ti._restore_signal_handlers()
    assert {p for n, p in fed if n == "mle_step"} == {0.0, 0.8}
    assert {p for n, p in fed if n == "mle_eval_step"} == {0.0, 0.8}
