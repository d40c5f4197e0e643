"""``--dtype bfloat16`` training steps of the port against the JAX
package's on the CPU, from the same state (``train_state_from_jax``) and
batch: one free-running MLE step, then one Gumbel adversarial step (both
updates), with ``GIC_BF16_MU`` off and on (``Config.bf16_mu``) and
``--grad-accum`` 1 and 2, and conditional on ``images_u8``.  The JAX
side runs the slice's kernels in interpret mode (``decode_impl="kernel"`` with the BPTT chain and the
reverse kernel, ``disc_engine="mxu"``); the interpret-mode decode draws
zero uniforms, so the port is fed zeros, and the dropout masks and label
flips of the JAX key tree.  (The conditional JAX MLE step cannot run
the BPTT reverse kernel in bfloat16: the kernel's VJP hands the
bfloat16 features a float32 cotangent, which the encoder head's
BatchNorm backward refuses with a TypeError, so that case runs the JAX
reverse through XLA.)  Compared: the losses and gradient norms, the
gradients (through Adam's first moment after the first update, which is
``(1 - b1) · clip · g``), the parameters after each update and the
moments' dtypes.  Also: the bfloat16-rounded temperature, the
conditional encoder pass in bfloat16 (features and running statistics),
SCST staying float32, clipped Adam with a bfloat16 first moment under an
lr schedule against the optax chain, mu's dtype through the full-state
checkpoint and ``train_state_from_jax``, and the routes refused in
bfloat16.

Tolerances, in bfloat16 units (2^-8 of the largest entry of the tensor
compared): the two frameworks round the bfloat16 forward at other
places (XLA rounds a fused chain of elementwise operations once, PyTorch
after each operation), so a step's activations part by a unit here and
there and the gradients, sums over the batch and T steps of products of
them, by more.  Losses: 4 units; gradients (the first moments) and
their squares: 16 and 32 units of each tensor's largest entry;
parameters after an update: 2 units of the tensor's largest entry plus
the updates' own sizes (one Adam step moves an entry by at most the
learning rate, and an entry whose gradient is within rounding of 0 may
move either way: the generator's two updates, the MLE step's and the
adversarial step's, add up).  One thing the units do not cover: XLA on
the CPU sums a bias gradient (the transpose of a broadcast add) in
bfloat16, one rounding per row, where PyTorch and the TPU accumulate in
float32; over the discriminator's B·R rows with cancelling signs that
leaves the JAX package's gradients of the dense layers' biases tens of
units off, and likewise those of the conditional encoder's head, whose
train-mode BatchNorm makes the gradient a difference of batch sums (its
linear bias's is 0 but for rounding).  Those leaves alone
(``SUMMED_IN_BF16``: their moments and their parameters after the
update), the discriminator's gradient norm that sums them, and the
running statistics (see ``_stats_misses``), pass outside their units
where the port's values are at least as close (L2, plus the units'
tolerance per entry) as the JAX package's to the same step run in
float32 (the port's float32 step, which the float32 tests hold to the
JAX package within 1e-5).

That the comparison tells bfloat16 from float32 is checked too: the
float32 step, put through the same comparison in the port's place, must
fail it, on the adversarial step's gradients of both sides (there the
float32 step is tens of units off, the bfloat16 one within a unit or
two; the MLE step's gradients part by a few units either way).  And
every kernel wrapper the steps reach (the decode, the BPTT chain and
reverse, the conv bank) must be handed bfloat16, where the float32 step
hands them float32."""

import contextlib

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
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.kernels import build as kbuild
from gan_image_captioning_tpu_torch.models import api as tapi
from gan_image_captioning_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

B, V, TEMP = 4, 32, 2.0
UNIT = 2.0 ** -8
LOSS_UNITS, GRAD_UNITS, PARAM_UNITS = 4, 16, 2
# the discriminator's dense-layer biases and the conditional encoder's
# head (a linear layer into a train-mode BatchNorm), whose JAX gradient
# XLA on the CPU sums in bfloat16 (module docstring)
SUMMED_IN_BF16 = ("highway.bias", "feature2out.bias", "out2logits.bias",
                  "encoder.linear.weight", "encoder.linear.bias",
                  "encoder.bn.weight", "encoder.bn.bias")
# every kernel wrapper of the slice's steps, by the name it checks dtypes
# under (``kernels/build.py:compute_dtype``)
STEP_WRAPPERS = {"mle": {"decode_sample", "lstm_bptt_reverse"},
                 "adv": {"decode_sample", "lstm_bptt_chain", "disc_conv"}}
KW = dict(vocab_size=V, gen_embed_dim=8, gen_hidden_dim=16,
          gen_num_layers=2, max_seq_len=4, disc_embed_dim=8,
          disc_num_rep=4, disc_filter_sizes=(2, 3), disc_num_filters=(5, 6),
          gen_lr=1e-3, disc_lr=1e-3, pretrain_lr=1e-2, dtype="bfloat16")


@pytest.fixture
def env(monkeypatch):
    """The slice's kernels on the JAX side, in interpret mode; no
    process-wide JAX state shardings (``tests/test_parallel.py`` leaves
    them set on its worker)."""
    for var in ("GIC_KERNEL_INTERPRET", "GIC_BPTT_KERNEL", "GIC_BPTT_CHAIN"):
        monkeypatch.setenv(var, "1")
    prev = jsteps._STATE_SHARDINGS
    jsteps.set_state_shardings(None)
    yield monkeypatch
    jsteps.set_state_shardings(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, units, tag, extra=0.0, ref=None):
    """Assert :func:`_miss` finds nothing."""
    miss = _miss(got, want, units, tag, extra, ref)
    assert miss is None, miss


def _miss(got, want, units, tag, extra=0.0, ref=None):
    """None where ``got`` is within ``units`` of ``want`` (plus
    ``extra``), else what is off; with a float32 ``ref`` (only where the
    module docstring says), a tensor with an entry outside is
    within where it is at least as close to ``ref`` as ``want`` is:
    ``|got - ref| <= |want - ref| + tol·sqrt(n)`` in L2 over its n
    entries."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = units * UNIT * float(np.max(np.abs(want), initial=0.0)) + extra
    err = float(np.max(np.abs(got - want), initial=0.0))
    if err <= tol:
        return None
    if ref is not None:
        ref = np.asarray(ref, np.float32)
        ours = float(np.linalg.norm((got - ref).ravel()))
        theirs = float(np.linalg.norm((want - ref).ravel()))
        if ours <= theirs + tol * np.sqrt(got.size):
            return None
        return f"{tag}: {ours} from float32, the JAX package's {theirs}"
    return f"{tag}: {err} > {tol}"


def _summed(key):
    return key.endswith(SUMMED_IN_BF16) or key == "disc_grad_norm"


def _setup(kw, monkeypatch, bf16_mu: bool, seed=0):
    monkeypatch.setenv("GIC_BF16_MU", "1" if bf16_mu else "0")
    jconfig = JConfig(**kw, decode_impl="kernel", disc_engine="mxu")
    config = Config(**kw, bf16_mu=bf16_mu)
    jstate = jax.jit(lambda key: jcreate_train_state(jconfig, key))(
        jax.random.PRNGKey(seed))
    state = interop.train_state_from_jax(_np(jstate), config)
    rng = np.random.default_rng(seed)
    caps = [rng.integers(4, V, size=rng.integers(1, 5)) for _ in range(B)]
    imgs = None
    if config.conditional_gan:
        s = config.image_size
        imgs = [rng.integers(0, 256, (3, s, s)).astype(np.uint8)
                for _ in range(B)]
    host = make_batch(caps, imgs, config.seq_len)
    jbatch = {k: jnp.asarray(v) for k, v in
              jmake_batch(caps, imgs, config.seq_len).items()}
    return jconfig, config, jstate, state, jbatch, tsteps.batch_to(host,
                                                                   "cpu")


def _adv_noise(config, key, b):
    """The draws of the JAX ``adv_losses(rng=key)`` over ``b`` rows: zero
    uniforms (the interpret-mode decode's), the three dropout masks."""
    _, _, r1, r2, r3, _ = jax.random.split(key, 6)
    shape = tapi.disc_keep_shape(config, b)
    return {"uniforms": torch.zeros(config.seq_len, b, V),
            "keep": [torch.from_numpy(np.array(jax.random.bernoulli(
                k, 0.8, shape))) for k in (r1, r2, r3)]}


def _noise(jstate, config):
    _, rng_step = jax.random.split(jstate.rng)
    k = config.grad_accum
    if k == 1:
        return _adv_noise(config, rng_step, B)
    return [_adv_noise(config, r, B // k)
            for r in jax.random.split(rng_step, k)]


def _compare(state, jstate, ref, opt, jopt, side, lr, tag):
    """What is off in the moments (the gradients after a first update)
    against the JAX state's (a leaf of ``SUMMED_IN_BF16`` may instead be
    as close as those to the float32 ``ref`` state's), and in the
    parameters."""
    rename = (interop.params_from_jax if side == "gen"
              else interop.disc_params_from_jax)
    adam = getattr(jstate, jopt)[1][0]
    mine, theirs32 = getattr(state, opt), getattr(ref, opt)
    assert mine.count == int(adam.count), tag
    mu, nu = rename(_np(adam.mu)), rename(_np(adam.nu))
    out = []
    for k, v in mine.mu.items():
        assert v.dtype == mu[k].dtype, f"{tag}: mu {k} dtype"
        summed = _summed(k)
        out.append(_miss(_f32(v), _f32(mu[k]), GRAD_UNITS, f"{tag}: mu.{k}",
                         ref=_f32(theirs32.mu[k]) if summed else None))
        out.append(_miss(_f32(mine.nu[k]), _f32(nu[k]), 2 * GRAD_UNITS,
                         f"{tag}: nu.{k}",
                         ref=_f32(theirs32.nu[k]) if summed else None))
    model = state.gen if side == "gen" else state.disc
    params = rename(_np(getattr(jstate, f"{side}_params")))
    params32 = dict((ref.gen if side == "gen" else ref.disc)
                    .named_parameters())
    for k, v in model.named_parameters():
        out.append(_miss(_f32(v), _f32(params[k]), PARAM_UNITS,
                         f"{tag}: {k}", extra=1.01 * lr,
                         ref=_f32(params32[k]) if _summed(k) else None))
    return out


def _stats_misses(state, jstate, ref, tag, updated):
    """The conditional encoder's running statistics, bfloat16 on both
    sides, against the JAX state's: within 4 units; a running mean, or
    any statistic of a forward that read an ``updated`` encoder head
    (``SUMMED_IN_BF16``), may instead be as close as the JAX package's to
    the float32 ``ref`` state's (a deep layer's batch mean sums
    activations of both signs that 17 bfloat16 convolutions have rounded,
    each framework in its own places: it is off by units of the
    activations, not of the mean)."""
    want = interop.params_from_jax(_np(jstate.gen_params))
    theirs32 = ref.gen.state_dict()
    out = []
    for k, v in state.gen.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert v.dtype == want[k].dtype == torch.bfloat16, k
            loose = updated or k.endswith("running_mean")
            out.append(_miss(_f32(v), _f32(want[k]), LOSS_UNITS,
                             f"{tag}: {k}",
                             ref=_f32(theirs32[k]) if loose else None))
    assert out, "no running statistics"
    return out


def _metric_misses(m, jm, m32, tag):
    return [_miss(float(m[k]), float(jm[k]), LOSS_UNITS, f"{tag} {k}",
                  ref=float(m32[k]) if _summed(k) else None) for k in jm]


@contextlib.contextmanager
def _wrapper_dtypes(monkeypatch):
    """The ``(wrapper, dtype)`` pairs the kernel wrappers check within."""
    seen, real = set(), kbuild.compute_dtype

    def spy(fn, t, bf16=True):
        seen.add((fn, t.dtype))
        return real(fn, t, bf16)

    monkeypatch.setattr(kbuild, "compute_dtype", spy)
    try:
        yield seen
    finally:
        monkeypatch.setattr(kbuild, "compute_dtype", real)


def _steps(step, state, ref, args32, monkeypatch, phase):
    """``step`` of the bfloat16 and the float32 config, each on its state;
    checks that the bfloat16 step hands every wrapper of ``phase``
    bfloat16 and the float32 one float32."""
    out = []
    for make, st, want in ((step[0], state, torch.bfloat16),
                           (step[1], ref, torch.float32)):
        with _wrapper_dtypes(monkeypatch) as seen:
            out.append(make(st, *args32))
        assert {fn for fn, _ in seen} == STEP_WRAPPERS[phase], (phase, seen)
        assert {dt for _, dt in seen} == {want}, (phase, seen)
    return out


@pytest.mark.parametrize("bf16_mu,accum,cond", [
    (False, 1, False), (True, 2, False), (True, 1, True)])
def test_mle_then_adv_step_match_jax(env, bf16_mu, accum, cond):
    """Unconditional, and conditional on 32 x 32 ``images_u8`` (through
    ``image_norm`` into bfloat16 and the bfloat16 ResNet-18 encoder in
    train mode; its running statistics, stored in bfloat16 as the JAX
    step merges its bfloat16 ``new_stats``, within 4 units of the JAX
    package's)."""
    kw = dict(KW, grad_accum=accum, disc_train_freq=1)
    if cond:
        kw.update(conditional_gan=1, image_size=32)
        env.delenv("GIC_BPTT_KERNEL")
    jconfig, config, jstate, state, jbatch, batch = _setup(kw, env, bf16_mu)
    config32 = Config(**dict(kw, dtype="float32"))
    ref = interop.train_state_from_jax(_np(jstate), config32)
    port, control = [], []

    jstate, jm = jsteps.make_mle_step(jconfig)(jstate, jbatch)
    (state, m), (ref, m32) = _steps(
        (tsteps.make_mle_step(config), tsteps.make_mle_step(config32)),
        state, ref, (batch,), env, "mle")
    if cond:
        port += _stats_misses(state, jstate, ref, "mle", False)
    for cand, mc, sink in ((state, m, port), (ref, m32, control)):
        sink += _metric_misses(mc, jm, m32, "mle")
        sink += _compare(cand, jstate, ref, "pretrain_opt",
                         "pretrain_opt_state", "gen", config.pretrain_lr,
                         "mle")

    noise = _noise(jstate, config)
    jstate, jm = jsteps.make_adv_step(jconfig)(jstate, jbatch, TEMP)
    (state, m), (ref, m32) = _steps(
        (tsteps.make_adv_step(config), tsteps.make_adv_step(config32)),
        state, ref, (batch, TEMP, noise), env, "adv")
    if cond:
        port += _stats_misses(state, jstate, ref, "adv", True)
    for cand, mc, sink in ((state, m, port), (ref, m32, control)):
        sink += _metric_misses(mc, jm, m32, "adv")
        sink += _compare(cand, jstate, ref, "gen_opt", "gen_opt_state",
                         "gen", config.pretrain_lr + config.gen_lr,
                         "adv gen")
        sink += _compare(cand, jstate, ref, "disc_opt", "disc_opt_state",
                         "disc", config.disc_lr, "adv disc")
    port = [x for x in port if x]
    assert not port, port
    # the control: the float32 step fails the same comparison, on
    # gradients of both sides that no fallback covers
    control = [x for x in control if x]
    for side in ("adv gen: mu.", "adv disc: mu."):
        assert any(x.startswith(side) for x in control), (side, control)
    # the masters stay float32
    assert all(p.dtype == torch.float32 for p in state.gen.parameters())
    assert all(p.dtype == torch.float32 for p in state.disc.parameters())


def test_temperature_is_rounded_to_bfloat16():
    """The JAX step keeps the temperature in the compute dtype
    (``train/steps.py:406-410``): the sample reads its bfloat16 value."""
    got = tsteps.compute_temperature(Config(**KW), 1.2345)
    assert got == float(jnp.asarray(1.2345, jnp.bfloat16))
    assert got != float(np.float32(1.2345))
    assert tsteps.compute_temperature(Config(**dict(KW, dtype="float32")),
                                      1.2345) == float(np.float32(1.2345))


def test_conditional_encoder_pass_matches_jax(env):
    """The conditional step's encoder pass under ``--dtype bfloat16``:
    ``images_u8`` through ``image_norm`` into bfloat16, the bfloat16
    encoder in train mode; its features and the running statistics it
    leaves (stored in bfloat16, as the JAX step merges its bfloat16
    ``new_stats``) against the JAX ``generator_condition`` on the
    bfloat16-cast parameters.  Features (through train-mode BatchNorm of
    a bfloat16 head): 16 units; running statistics: 4 units, or, as the
    module docstring says, at least as close as the JAX package's to the
    float32 pass (a deep layer's batch means sum activations of both
    signs that 17 bfloat16 convolutions have rounded, each framework in
    its own places)."""
    from gan_image_captioning_tpu.models import api as japi

    kw = dict(KW, conditional_gan=1, image_size=32)
    jconfig, config, jstate, state, _, _ = _setup(kw, env, False)
    u8 = np.random.default_rng(3).integers(0, 256, (B, 3, 32, 32),
                                           dtype=np.uint8)
    jparams = tsteps_cast(jstate.gen_params)
    jcond, jstats = jax.jit(lambda p, x: japi.generator_condition(
        jconfig, p, {"images_u8": x, "captions": jnp.zeros((B, 4),
                                                           jnp.int32)},
        True))(jparams, jnp.asarray(u8))
    batch = {"images_u8": torch.from_numpy(u8),
             "captions": torch.zeros(B, 4, dtype=torch.int32)}
    with tsteps.compute_cast(config, state.gen, train=True):
        cond, _ = tapi.generator_condition(config, state.gen,
                                           tsteps.cast_batch(config, batch),
                                           train=True)
    config32 = Config(**dict(kw, dtype="float32"))
    ref = interop.train_state_from_jax(_np(jstate), config32)
    tapi.generator_condition(config32, ref.gen, batch, train=True)
    ref_stats = ref.gen.state_dict()
    assert cond["features"].dtype == torch.bfloat16
    _close(_f32(cond["features"]), _f32(jcond["features"]), GRAD_UNITS,
           "features")
    want = interop.params_from_jax(_np(dict(jparams, encoder=dict(
        jparams["encoder"], bn_stats=jstats))))
    stats = {k: v for k, v in state.gen.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert stats and all(v.dtype == torch.bfloat16 for v in stats.values())
    assert all(p.dtype == torch.float32 for p in state.gen.parameters())
    for k, v in stats.items():
        assert want[k].dtype == torch.bfloat16, k
        _close(_f32(v), _f32(want[k]), LOSS_UNITS, k, ref=_f32(ref_stats[k]))


def tsteps_cast(tree):
    """The JAX ``_compute_cast`` of a parameter tree to bfloat16."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def test_scst_stays_float32():
    """SCST takes no compute cast (the JAX ``train/scst.py``): its update
    under ``--dtype bfloat16`` is bit-equal to the float32 one."""
    from gan_image_captioning_tpu_torch.train import scst
    from gan_image_captioning_tpu_torch.train.state import create_train_state

    out = []
    for dtype in ("bfloat16", "float32"):
        config = Config(**dict(KW, dtype=dtype))
        state = create_train_state(config, 5)
        batch = tsteps.batch_to(make_batch([np.arange(4, 8)] * B, None,
                                           config.seq_len), "cpu")
        _, update, greedy_only = scst.make_scst_programs(config)
        ids = greedy_only(state.gen, batch)
        state, loss = update(state, batch, ids, torch.linspace(-1, 1, B))
        out.append((ids, loss, [p.clone() for p in state.gen.parameters()]))
    (ids, loss, params), (ids32, loss32, params32) = out
    assert torch.equal(ids, ids32) and torch.equal(loss, loss32)
    assert all(torch.equal(a, b) for a, b in zip(params, params32))


def test_bf16_mu_adam_under_a_schedule_matches_the_optax_chain(env):
    """Clipped Adam with a bfloat16 first moment (``GIC_BF16_MU``: optax
    ``mu_dtype``) on both update paths, the constant lr and a warmup +
    cosine schedule (``lr_at``), against the JAX ``make_optimizer``
    chain, jitted as the JAX steps run it: mu stays bfloat16 and within 1
    unit, nu float32, the parameters within 1e-6 plus lr·2^-8 (the update
    is float32 from the same moments; a moment that rounds to the
    neighbouring bfloat16 moves its update by at most that much)."""
    from gan_image_captioning_tpu.train.state import make_optimizer
    from gan_image_captioning_tpu_torch.train import state as tstate

    env.setenv("GIC_BF16_MU", "1")
    for sched in ({}, dict(lr_schedule="cosine", lr_decay_steps=4,
                           lr_min_ratio=0.1, lr_warmup_steps=2)):
        rng = np.random.default_rng(0)
        params = {"weight": rng.standard_normal((4, 3)).astype(np.float32),
                  "bias": rng.standard_normal(4).astype(np.float32)}
        tx = make_optimizer(0.05, 1.0, JConfig(**sched))
        update = jax.jit(tx.update)     # as the JAX steps run it
        jparams = {k: jnp.asarray(v) for k, v in params.items()}
        opt = tx.init(jparams)
        module = torch.nn.Linear(3, 4)
        with torch.no_grad():
            for k, v in params.items():
                getattr(module, k).copy_(torch.from_numpy(v))
        config = Config(**sched, bf16_mu=True)
        adam = tstate.adam_init(module, config)
        for i in range(6):
            grads = {k: (rng.standard_normal(v.shape) * (0.2 + i % 3))
                     .astype(np.float32) for k, v in params.items()}
            updates, opt = update({k: jnp.asarray(v) for k, v in
                                   grads.items()}, opt, jparams)
            jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                             updates)
            tstate.clip_adam_update(module, {k: torch.from_numpy(v) for k, v
                                             in grads.items()}, adam, 0.05,
                                    1.0, config=config)
            jadam = opt[1][0]
            for k in params:
                assert adam.mu[k].dtype == torch.bfloat16
                assert adam.nu[k].dtype == torch.float32
                _close(_f32(adam.mu[k]), np.asarray(
                    jadam.mu[k].astype(jnp.float32)), 1, f"{i}: mu {k}")
                np.testing.assert_allclose(
                    getattr(module, k).detach().numpy(),
                    np.asarray(jparams[k]), atol=1e-6 + 0.05 * UNIT, rtol=0,
                    err_msg=f"update {i}: {k}")


def test_bf16_mu_survives_checkpoint_and_interop(env, tmp_path):
    """mu's dtype through ``train_state_from_jax`` (a JAX state under
    ``GIC_BF16_MU=1``) and the full-state checkpoint; the EMA stays
    float32."""
    from gan_image_captioning_tpu_torch.train import checkpoint as ckpt
    from gan_image_captioning_tpu_torch.train.state import create_train_state

    kw = dict(KW, ema_decay=0.5)
    _, config, jstate, state, _, _ = _setup(kw, env, True)
    assert jstate.gen_opt_state[1][0].mu["decoder"]["embed"].dtype == \
        jnp.bfloat16
    for opt in (state.pretrain_opt, state.gen_opt, state.disc_opt):
        assert all(v.dtype == torch.bfloat16 for v in opt.mu.values())
        assert all(v.dtype == torch.float32 for v in opt.nu.values())
    path = str(tmp_path / "state.ckpt")
    ckpt.save_state(path, state, sync=True)
    back = ckpt.load_state(path, create_train_state(config, 9))
    for name in ("pretrain_opt", "gen_opt", "disc_opt"):
        for k, v in getattr(state, name).mu.items():
            assert torch.equal(getattr(back, name).mu[k], v), (name, k)
    assert all(v.dtype == torch.float32 for v in back.ema_gen.values())


@pytest.mark.parametrize("override", [
    {"decode_impl": "kernel_rescore"},
    {"decode_impl": "kernel_embed"}, {"decode_impl": "decoupled"},
    {"disc_engine": "hybrid"}, {"disc_engine": "mxu_dxs"}])
def test_unported_bfloat16_routes_raise(override):
    """A bfloat16 route without bfloat16 kernels raises
    ``NotImplementedError`` naming the ROADMAP item; it never runs in
    float32 instead."""
    config = Config(**dict(KW, **override))
    for make in (tsteps.make_mle_step, tsteps.make_adv_step):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make(config)


@pytest.mark.parametrize("override", [
    {}, {"disc_engine": "pallas"}, {"disc_engine": "xla"},
    {"decode_impl": "plain", "disc_engine": "plain"},
    {"gen_arch": "transformer", "disc_arch": "transformer"},
    {"disc_arch": "transformer"}])
def test_ported_bfloat16_routes_build(override):
    config = Config(**dict(KW, **override))
    tsteps.make_mle_step(config)
    tsteps.make_adv_step(config)


def test_guard_and_accumulation_keep_working_in_bfloat16():
    """``--skip-nonfinite-grads 1`` and ``--grad-accum 2`` under ``--dtype
    bfloat16`` with ``bf16_mu``: a batch of NaN weights leaves the
    parameters, the bfloat16 first moments and the counts as they were,
    the step counters advance; a finite batch then updates them."""
    from gan_image_captioning_tpu_torch.train.state import create_train_state

    config = Config(**dict(KW, skip_nonfinite_grads=1, grad_accum=2),
                    bf16_mu=True)
    state = create_train_state(config, 3)
    host = make_batch([np.arange(4, 8)] * B, None, config.seq_len)
    bad = dict(host, weights=np.full_like(host["weights"], np.nan))
    step = tsteps.make_adv_step(config)

    def snapshot():
        return ([p.detach().clone() for m in (state.gen, state.disc)
                 for p in m.parameters()],
                [v.clone() for opt in (state.gen_opt, state.disc_opt)
                 for v in opt.mu.values()])

    before = snapshot()
    state, m = step(state, tsteps.batch_to(bad, "cpu"), TEMP)
    assert not np.isfinite(float(m["gen_grad_norm"]))
    after = snapshot()
    assert all(torch.equal(a, b) for a, b in zip(before[0] + before[1],
                                                 after[0] + after[1]))
    assert (state.gen_opt.count, state.disc_opt.count) == (0, 0)
    assert state.gen_steps == 1
    state, m = step(state, tsteps.batch_to(host, "cpu"), TEMP)
    assert np.isfinite(float(m["gen_grad_norm"]))
    assert state.gen_opt.count == 1
    assert all(v.dtype == torch.bfloat16 for v in state.gen_opt.mu.values())
    assert any(not torch.equal(a, b) for a, b in zip(after[0],
                                                     snapshot()[0]))
