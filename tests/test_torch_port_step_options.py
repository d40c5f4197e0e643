"""The port's step options against the JAX package on the CPU: the
learning-rate schedules (``state.lr_at`` against ``lr_schedule_fn`` at
every count, and its refusals), clipped Adam under a schedule against the
optax chain, the EMA against ``_ema_update``, and whole steps with
``--grad-accum 2``, ``--ema-decay`` and ``--skip-nonfinite-grads 1``
(a batch whose weights are NaN between two finite ones: parameters, Adam
moments and count, EMA and running statistics kept, counters advanced)
against ``make_mle_step`` / ``make_adv_step``: the LSTM MLE step, the LSTM
Gumbel adversarial step (every microbatch's draws reproduced from its key
and fed) and the transformer REINFORCE step, from the same state
(``train_state_from_jax``); and the conditional step's BatchNorm
statistics: the JAX encoder's over the last microbatch, from the old
ones.

Tolerance: lr rtol 1e-6 (float32, an ulp of ``cos`` apart at most);
losses and metrics rtol 1e-5, atol 1e-7; parameters, moments, EMA and
running statistics after each step atol 1e-5, rtol 1e-4 (float32 sums in
another order, through Adam's normalised updates)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.loader import make_batch as jmake_batch
from gan_image_captioning_tpu.models import api as japi
from gan_image_captioning_tpu.models.torch_import import generator_from_torch
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu.train.state import (
    create_train_state as jcreate_train_state)
from gan_image_captioning_tpu.train.state import lr_schedule_fn
from gan_image_captioning_tpu.train.state import make_optimizer
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.models import api as tapi
from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib
from gan_image_captioning_tpu_torch.train import state as tstate
from gan_image_captioning_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

B, V, TEMP, FLIP = 4, 32, 2.0, 0.25
LSTM = dict(vocab_size=V, gen_embed_dim=8, gen_hidden_dim=16,
            gen_num_layers=2, max_seq_len=4, disc_embed_dim=8,
            disc_num_rep=4, disc_filter_sizes=(2, 3), disc_num_filters=(5, 6),
            gen_lr=1e-3, disc_lr=1e-3, pretrain_lr=1e-2)
OPTIONS = dict(grad_accum=2, ema_decay=0.9, skip_nonfinite_grads=1)
LR = dict(rtol=1e-6, atol=1e-12)
METRIC = dict(rtol=1e-5, atol=1e-7)
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


# ----------------------------------------------------------- lr schedules

SCHEDULES = [
    dict(lr_schedule="constant", lr_warmup_steps=3),
    dict(lr_schedule="cosine", lr_decay_steps=7, lr_min_ratio=0.1),
    dict(lr_schedule="cosine", lr_decay_steps=7, lr_min_ratio=0.0,
         lr_warmup_steps=4),
    dict(lr_schedule="linear", lr_decay_steps=6, lr_min_ratio=0.2),
    dict(lr_schedule="linear", lr_decay_steps=5, lr_min_ratio=0.0,
         lr_warmup_steps=2),
    dict(lr_schedule="exponential", lr_decay_steps=4, lr_min_ratio=0.5),
    dict(lr_schedule="exponential", lr_decay_steps=3, lr_min_ratio=0.3,
         lr_warmup_steps=5)]


@pytest.mark.parametrize("sched", SCHEDULES)
def test_lr_at_every_count_matches_lr_schedule_fn(sched):
    base = 3e-3
    want_fn = lr_schedule_fn(base, JConfig(**sched))
    config = Config(**sched)
    got = [tstate.lr_at(base, config, c) for c in range(16)]
    want = [float(want_fn(jnp.asarray(c, jnp.int32))) for c in range(16)]
    np.testing.assert_allclose(got, want, **LR)
    if sched.get("lr_warmup_steps"):
        assert got[0] == 0.0        # optax reads the count before the update


def test_constant_lr_stays_the_plain_float():
    assert tstate.lr_at(0.01, Config(), 12) == 0.01
    assert lr_schedule_fn(0.01, JConfig()) == 0.01


@pytest.mark.parametrize("sched", [
    dict(lr_schedule="cosine"), dict(lr_schedule="linear"),
    dict(lr_schedule="exponential", lr_decay_steps=5, lr_min_ratio=0.0),
    dict(lr_schedule="exponential", lr_decay_steps=5, lr_min_ratio=1.0)])
def test_invalid_schedules_raise_the_jax_errors(sched):
    with pytest.raises(ValueError) as want:
        lr_schedule_fn(1.0, JConfig(**sched))
    with pytest.raises(ValueError) as got:
        tstate.lr_at(1.0, Config(**sched), 0)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):                 # refused up front
        tsteps.make_mle_step(Config(**LSTM, **sched))


def test_clip_adam_under_a_schedule_matches_the_optax_chain():
    sched = dict(lr_schedule="cosine", lr_decay_steps=4, lr_min_ratio=0.1,
                 lr_warmup_steps=2)
    rng = np.random.default_rng(0)
    params = {"weight": rng.standard_normal((4, 3)).astype(np.float32),
              "bias": rng.standard_normal(4).astype(np.float32)}
    tx = make_optimizer(0.05, 1.0, JConfig(**sched))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt = tx.init(jparams)
    module = torch.nn.Linear(3, 4)
    with torch.no_grad():
        for k, v in params.items():
            getattr(module, k).copy_(torch.from_numpy(v))
    adam = tstate.adam_init(module)
    config = Config(**sched)
    for i in range(8):
        # norms above and below the clip
        grads = {k: (rng.standard_normal(v.shape) * (0.2 + i % 3)).astype(
            np.float32) for k, v in params.items()}
        updates, opt = tx.update({k: jnp.asarray(v) for k, v in
                                  grads.items()}, opt, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        tstate.clip_adam_update(module, {k: torch.from_numpy(v) for k, v in
                                         grads.items()}, adam, 0.05, 1.0,
                                config=config)
        for k in params:
            np.testing.assert_allclose(
                getattr(module, k).detach().numpy(), np.asarray(jparams[k]),
                err_msg=f"update {i}: {k}", **PARAM)
    assert adam.count == int(opt[1][0].count) == 8
    if sched["lr_warmup_steps"]:
        assert tstate.lr_at(0.05, config, 0) == 0.0


def test_ema_update_matches_jax():
    jconfig = JConfig(**LSTM, ema_decay=0.75)
    config = Config(**LSTM, ema_decay=0.75)
    state = tstate.create_train_state(config, 1)
    assert state.ema_gen.keys() == state.gen.state_dict().keys()
    ema = generator_from_torch(state.ema_gen, config.gen_num_layers)
    with torch.no_grad():
        for p in state.gen.parameters():
            p.mul_(1.5).add_(0.25)
    new = generator_from_torch(state.gen.state_dict(), config.gen_num_layers)
    # read JAX's result before the in-place update: its inputs may share
    # memory with the tensors that the update writes
    want = interop.params_from_jax(_np(jsteps._ema_update(jconfig, ema,
                                                          new)))
    tstate.ema_update(config, state.ema_gen, state.gen)
    for k, v in state.ema_gen.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k,
                                   **PARAM)
    assert tstate.create_train_state(Config(**LSTM), 0).ema_gen is None


def test_indivisible_batch_raises_the_jax_error():
    batch = {"captions": torch.zeros((5, 6), dtype=torch.int32)}
    with pytest.raises(ValueError) as want:
        jsteps._split_micro({"captions": jnp.zeros((5, 6), jnp.int32)}, 2)
    with pytest.raises(ValueError) as got:
        tsteps.split_micro(batch, 2)
    assert str(got.value) == str(want.value)
    parts = tsteps.split_micro({"captions": torch.arange(12).view(6, 2)}, 3)
    assert [p["captions"][:, 0].tolist() for p in parts] == [[0, 2], [4, 6],
                                                             [8, 10]]


# -------------------------------------------------------------- whole steps

def _assert_same(config, state, jstate, tag):
    """Parameters and running statistics of both models, the three Adam
    states (count and moments) and the EMA."""
    if config.gen_arch == "transformer":
        def gen(tree):
            return interop.flatten_jax({"decoder": tree["decoder"]})
    else:
        gen = interop.params_from_jax
    disc = (interop.disc_params_from_jax if config.disc_arch == "cnn"
            else interop.flatten_jax)
    pairs = [("gen", state.gen.state_dict(), gen(_np(jstate.gen_params))),
             ("disc", state.disc.state_dict(),
              disc(_np(jstate.disc_params)))]
    for name, jname, rename in (("pretrain_opt", "pretrain_opt_state", gen),
                                ("gen_opt", "gen_opt_state", gen),
                                ("disc_opt", "disc_opt_state", disc)):
        adam = getattr(jstate, jname)[1][0]
        mine = getattr(state, name)
        assert mine.count == int(adam.count), f"{tag}: {name} count"
        pairs += [(name + ".mu", mine.mu, rename(_np(adam.mu))),
                  (name + ".nu", mine.nu, rename(_np(adam.nu)))]
    if jstate.ema_gen_params is not None:
        pairs.append(("ema", state.ema_gen,
                      gen(_np(jstate.ema_gen_params))))
    for name, got, want in pairs:
        for k, v in got.items():
            if v.is_floating_point():
                np.testing.assert_allclose(
                    v.detach().numpy(), want[k].numpy(),
                    err_msg=f"{tag}: {name}.{k}", **PARAM)
    assert (state.gen_steps, state.disc_steps) == (
        int(jstate.gen_steps), int(jstate.disc_steps)), tag


def _setup(kw, seed=0):
    jconfig = JConfig(**kw, decode_impl="fused")
    config = Config(**kw)
    # one compiled program: faster than the init's eager operations
    jstate = jax.jit(lambda key: jcreate_train_state(jconfig, key))(
        jax.random.PRNGKey(seed))
    state = interop.train_state_from_jax(_np(jstate), config)
    rng = np.random.default_rng(seed)
    caps = [rng.integers(4, V, size=rng.integers(1, 5)) for _ in range(B)]
    host = make_batch(caps, None, config.seq_len)
    assert all(np.array_equal(v, jmake_batch(caps, None, config.seq_len)[k])
               for k, v in host.items())
    return jconfig, config, jstate, state, host


def _batches(host):
    """The finite batch, then the same with NaN weights: (jax, port)
    pairs."""
    poisoned = dict(host, weights=np.full_like(host["weights"], np.nan))
    return [({k: jnp.asarray(v) for k, v in b.items()},
             tsteps.batch_to(b, "cpu")) for b in (host, poisoned, host)]


def _gumbel_noise(config, key, b):
    """The draws of JAX ``adv_losses(rng=key)`` over a microbatch of
    ``b`` rows."""
    _, r_sample, r1, r2, r3, r_flip = jax.random.split(key, 6)
    u = np.stack([np.asarray(jax.random.uniform(k, (b, V), jnp.float32))
                  for k in jax.random.split(r_sample, config.seq_len)])
    shape = tapi.disc_keep_shape(config, b)
    return {"uniforms": torch.from_numpy(u),
            "keep": [torch.from_numpy(np.array(jax.random.bernoulli(
                k, 0.8, shape))) for k in (r1, r2, r3)],
            "flip": torch.from_numpy(np.array(
                jax.random.bernoulli(r_flip, FLIP, (b,))))}


def _reinforce_noise(config, key, b):
    """The draws of JAX ``reinforce_losses(rng=key, train=True)``."""
    r_sample, r_roll, r1, r2, _ = jax.random.split(key, 5)
    T = config.seq_len

    def uniforms(k, rows):
        return torch.from_numpy(np.stack([np.array(jax.random.uniform(
            kt, (rows, V), jnp.float32)) for kt in jax.random.split(k, T)]))

    p = len(range(config.rollout_stride, T, config.rollout_stride))
    shape = tapi.disc_keep_shape(config, b)
    return {"uniforms": uniforms(r_sample, b),
            "rollout_uniforms": [uniforms(k, b * config.rollout_num)
                                 for k in jax.random.split(r_roll, p)],
            "keep": [torch.from_numpy(np.array(jax.random.bernoulli(
                k, 0.8, shape))) for k in (r1, r2)], "seed": 0}


def _micro_noise(jstate, config, draws):
    """One noise dict a microbatch, from the keys of the JAX step's
    ``split(rng_step, grad_accum)``."""
    _, rng_step = jax.random.split(jstate.rng)
    k = config.grad_accum
    return [draws(config, r, B // k) for r in jax.random.split(rng_step, k)]


def _run_steps(kind, jconfig, config, jstate, state, host, draws=None):
    make_j = jsteps.make_mle_step if kind == "mle" else jsteps.make_adv_step
    make_t = tsteps.make_mle_step if kind == "mle" else tsteps.make_adv_step
    jstep, step = make_j(jconfig), make_t(config)
    for i, (jb, tb) in enumerate(_batches(host)):
        if kind == "mle":
            jstate, jm = jstep(jstate, jb)
            state, m = step(state, tb)
        else:
            noise = _micro_noise(jstate, config, draws)
            jstate, jm = jstep(jstate, jb, TEMP)
            state, m = step(state, tb, TEMP, noise)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=f"{kind} {i}: {k}", **METRIC)
        _assert_same(config, state, jstate, f"{kind} step {i}")
        if i == 1:      # the poisoned batch: every update skipped
            assert not np.isfinite(float(m[next(iter(m))]))
    return state, jstate


def test_lstm_mle_step_with_step_options_matches_jax(no_state_shardings):
    kw = dict(LSTM, **OPTIONS, lr_schedule="cosine", lr_decay_steps=3,
              lr_warmup_steps=1, lr_min_ratio=0.1)
    state, _ = _run_steps("mle", *_setup(kw))
    assert state.pretrain_opt.count == 2        # the skipped update kept it


def test_lstm_gumbel_adv_step_with_step_options_matches_jax(
        no_state_shardings):
    kw = dict(LSTM, **OPTIONS, disc_train_freq=2, label_smoothing=0.1,
              noisy_labels=FLIP, lr_schedule="linear", lr_decay_steps=4,
              lr_min_ratio=0.5)
    state, _ = _run_steps("adv", *_setup(kw, seed=1), draws=_gumbel_noise)
    # the discriminator updates at gen_steps 0 and 2, both finite
    assert (state.gen_steps, state.disc_steps) == (3, 2)
    assert (state.gen_opt.count, state.disc_opt.count) == (2, 2)


def test_transformer_reinforce_step_with_step_options_matches_jax(
        no_state_shardings):
    kw = dict(vocab_size=V, gen_arch="transformer", disc_arch="transformer",
              gen_embed_dim=16, gen_hidden_dim=16, gen_num_layers=1,
              gen_num_heads=2, max_seq_len=3, disc_embed_dim=8,
              disc_hidden_dim=16, disc_num_heads=2, disc_num_layers=1,
              adv_objective="reinforce", rollout_num=2, rollout_stride=3,
              gen_lr=1e-3, disc_lr=1e-3, **OPTIONS)
    state, _ = _run_steps("adv", *_setup(kw, seed=2),
                          draws=_reinforce_noise)
    assert (state.gen_opt.count, state.disc_opt.count) == (2, 2)


@pytest.mark.parametrize("kind", ["mle", "adv"])
def test_conditional_accumulated_step_keeps_the_last_microbatch_stats(kind):
    """A conditional ``--grad-accum 2`` MLE or adversarial step leaves the
    encoder's running statistics the JAX step keeps: those of the JAX
    encoder's train-mode pass over the LAST microbatch from the
    statistics before the step (``steps.py:285-292,665``), not two
    momentum updates; the guard then keeps them on a poisoned batch.  The
    JAX side is its ``generator_condition`` alone, on the port's weights
    (the whole JAX conditional step compiles for tens of seconds)."""
    kw = dict(LSTM, **OPTIONS, conditional_gan=1, image_size=16,
              gen_embed_dim=16, gen_hidden_dim=16, mle_objective="teacher")
    config, jconfig = Config(**kw), JConfig(**kw)
    state = tstate.create_train_state(config, 5)
    jparams = generator_from_torch(
        {k: v.numpy() for k, v in
         ckpt_lib.generator_state_dict(state.gen).items()},
        config.gen_num_layers)
    rng = np.random.default_rng(5)
    caps = [rng.integers(4, V, size=rng.integers(1, 5)) for _ in range(8)]
    imgs = [(rng.standard_normal((3, 16, 16)) * rng.uniform(0.5, 2)
             + rng.uniform(-1, 1, (3, 1, 1))).astype(np.float32)
            for _ in range(8)]
    host = make_batch(caps, imgs, config.seq_len)
    last = {k: jnp.asarray(v[4:]) for k, v in host.items()}
    new_stats = jax.jit(lambda gp, b: japi.generator_condition(
        jconfig, gp, b, True)[1])(jparams, last)
    want = interop.params_from_jax(_np(dict(jparams, encoder=dict(
        jparams["encoder"], bn_stats=new_stats))))
    if kind == "mle":
        step = tsteps.make_mle_step(config)
    else:
        adv = tsteps.make_adv_step(config)

        def step(state, batch):
            return adv(state, batch, TEMP)
    (_, batch), (_, poisoned), _ = _batches(host)
    state, m = step(state, batch)
    got = state.gen.state_dict()
    stats = [k for k in got if "running" in k]
    assert len(stats) == 42
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **PARAM)
    before = {k: v.clone() for k, v in got.items()}
    ema = {k: v.clone() for k, v in state.ema_gen.items()}
    state, m = step(state, poisoned)
    assert not np.isfinite(float(m["gen_grad_norm"]))
    after = state.gen.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(torch.equal(ema[k], state.ema_gen[k]) for k in ema)
    opt = state.pretrain_opt if kind == "mle" else state.gen_opt
    assert opt.count == 1
