"""What ``tests/test_torch_port_bf16_transformer.py`` and
``tests/test_torch_port_bf16_reinforce.py`` share: the small config4-shaped
models, the JAX package's draws reproduced from its keys, and the
comparisons in bfloat16 units.  (Not a test file: nothing here is
collected.)

Tolerances.  A bfloat16 kernel output against the JAX kernel on the same
bfloat16 inputs: both round float32 values that differ by float32 sums in
another order, so each entry is equal or one bfloat16 step apart (2^-7 of
its magnitude), plus F32_FLOOR (1e-5) of the tensor's largest entry where
a sum cancels to far below its terms (the float32 kernels' own
tolerance); ids equal.  Whole losses and gradients, in bfloat16 units
(2^-8 of the largest entry of the tensor compared), as
``tests/test_torch_port_bf16_steps.py`` holds the LSTM steps: the two
frameworks round the bfloat16 forward at other places (PyTorch rounds each
operation's float32 result once, XLA on the CPU at other points of a
chain, and sums a broadcast parameter's gradient in bfloat16), so
activations part by a unit here and there and gradients, sums of their
products, by more: losses 4 units, gradients 16 units of each tensor's
largest entry.  A gradient tensor outside its units passes where the
port's is at least as close (L2, plus the units' tolerance per entry) to
the same step run in float32 as the JAX package's is (the port's float32
step, which the float32 tests hold to the JAX package within 1e-5); so
the tests also check that the port's step is a bfloat16 computation
(every kernel wrapper handed bfloat16, results that are not the float32
step's).  ``grad_misses(fallback=False)`` holds a side without that
fallback.  No unit is wider than the LSTM steps'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.loader import make_batch as jmake_batch
from gan_image_captioning_tpu.ops import gumbel as jgumbel
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu.train.state import (
    create_train_state as jcreate_train_state)
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.kernels import build as kbuild
from gan_image_captioning_tpu_torch.models import api as tapi
from gan_image_captioning_tpu_torch.train import steps as tsteps

BF = torch.bfloat16
UNIT = 2.0 ** -8
STEP = 2.0 ** -7
F32_FLOOR = 1e-5
LOSS_UNITS, GRAD_UNITS = 4, 16
B, V, TEMP = 4, 64, 2.0
# config4's models at small width
KW = dict(vocab_size=V, gen_arch="transformer", disc_arch="transformer",
          gen_embed_dim=32, gen_hidden_dim=32, gen_num_layers=2,
          gen_num_heads=2, max_seq_len=8, disc_embed_dim=16,
          disc_hidden_dim=32, disc_num_heads=2, disc_num_layers=2,
          rollout_num=2, rollout_stride=4, gen_lr=1e-3, disc_lr=1e-3,
          dtype="bfloat16")


@pytest.fixture
def env(monkeypatch):
    """The JAX package's kernels in interpret mode; no process-wide JAX
    state shardings (another test file may leave them set on its
    worker); the fused sampler's routing put back after the test."""
    monkeypatch.setenv("GIC_KERNEL_INTERPRET", "1")
    monkeypatch.setattr(jgumbel, "_USE_PALLAS", False)
    prev = jsteps._STATE_SHARDINGS
    jsteps.set_state_shardings(None)
    yield monkeypatch
    jsteps.set_state_shardings(prev)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def bf16_pair(a):
    """A float32 array rounded to bfloat16: (JAX array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(f32(j))).to(BF)


def steps_apart(got, want, what):
    """Each entry equal or one bfloat16 step apart, plus F32_FLOOR of the
    largest entry."""
    got, want = f32(got), f32(want)
    tol = (STEP * np.maximum(np.abs(got), np.abs(want))
           + F32_FLOOR * float(np.max(np.abs(want), initial=0.0)))
    bad = np.abs(got - want) > tol
    assert not bad.any(), (what, float(np.max(np.abs(got - want))),
                           int(bad.sum()))


def miss(got, want, units, tag, ref=None, scale=None):
    """None where ``got`` is within ``units`` of ``want``'s largest entry
    (or of ``scale``), or (with the float32 ``ref``) at least as close to
    it as ``want`` is (L2, plus the units' tolerance per entry); else what
    is off."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if scale is None:
        scale = float(np.max(np.abs(want), initial=0.0))
    tol = units * UNIT * scale
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


_JSTATES = {}


def jax_state(jconfig, seed):
    """The JAX initial state of ``jconfig``'s models (cached per whole
    config and seed: the JAX functions here only read it, and two configs
    that differ in anything, an initialization flag included, never share
    one)."""
    key = (jconfig, seed)
    if key not in _JSTATES:
        _JSTATES[key] = jax.jit(lambda k: jcreate_train_state(
            jconfig, k))(jax.random.PRNGKey(seed))
    return _JSTATES[key]


def sharpened(jstate, gain):
    """``jstate`` with its discriminator's output weights times ``gain``
    (the CNN's ``out2logits``, the transformers' ``head``): a
    discriminator whose scores of different sequences lie far apart."""
    disc = dict(jstate.disc_params)
    name = "head" if "head" in disc else "out2logits"
    disc[name] = dict(disc[name], w=disc[name]["w"] * gain)
    return jstate._replace(disc_params=disc)


def setup(env, route, seed=0, disc_gain=None, **over):
    """JAX config (the route's flags in the environment) and state; the
    port's bfloat16 and float32 states from it; the batch on both sides.
    ``route``: ``"kernel"`` (the port's flash kernels and fused sampler;
    the JAX package's flash kernels under ``GIC_FLASH_ATTN=1`` and its
    fused sampler, ``set_use_pallas(True)``) or ``"plain"`` (the port's
    ``attn_impl`` and ``decode_impl`` plain; the JAX package's dense
    attention and ``add_gumbel``).  ``disc_gain``: the discriminator
    :func:`sharpened` by that gain on both sides."""
    kw = dict(KW, **over)
    if kw["gen_arch"] == "lstm":
        jconfig = JConfig(**kw, decode_impl="kernel", disc_engine="mxu")
        for var in ("GIC_BPTT_KERNEL", "GIC_BPTT_CHAIN"):
            env.setenv(var, "1")
    else:
        jconfig = JConfig(**kw)
    env.setenv("GIC_FLASH_ATTN", "1" if route == "kernel" else "0")
    env.setattr(jgumbel, "_USE_PALLAS", route == "kernel")
    port = {} if route == "kernel" else dict(attn_impl="plain",
                                            decode_impl="plain")
    config = Config(**kw, **port)
    jstate = jax_state(jconfig, seed)
    if disc_gain is not None:
        jstate = sharpened(jstate, disc_gain)
    state = interop.train_state_from_jax(np_tree(jstate), config)
    ref = interop.train_state_from_jax(np_tree(jstate), config.replace(
        dtype="float32"))
    rng = np.random.default_rng(seed)
    T = config.seq_len
    caps = [rng.integers(4, V, size=rng.integers(1, T)) for _ in range(B)]
    jbatch = {k: jnp.asarray(v) for k, v in
              jmake_batch(caps, None, T).items()}
    batch = tsteps.batch_to(make_batch(caps, None, T), "cpu")
    return jconfig, config, jstate, state, ref, jbatch, batch


def flat(config, tree, gen: bool):
    """A JAX parameter (or gradient) tree under the port's names."""
    if gen:
        return (interop.flatten_jax({"decoder": np_tree(tree)["decoder"]})
                if config.gen_arch == "transformer"
                else interop.params_from_jax(np_tree(tree)))
    return (interop.flatten_jax(np_tree(tree)) if config.disc_arch != "cnn"
            else interop.disc_params_from_jax(np_tree(tree)))


@jax.jit
def _twin_uniforms(keys, like):
    """The fused sampler's off-TPU twin, per step key: ``randint`` seeds
    ``jax.random.uniform`` (float32)."""
    def one(k):
        seed = jax.random.randint(k, (), 0, jnp.iinfo(jnp.int32).max,
                                  dtype=jnp.int32)
        return jax.random.uniform(jax.random.PRNGKey(seed), like.shape,
                                  jnp.float32)
    return jax.vmap(one)(keys)


@jax.jit
def _gumbel_uniforms(keys, like):
    """``add_gumbel``'s uniforms per step key, in the bfloat16 logits'
    dtype."""
    return jax.vmap(lambda k: jax.random.uniform(k, like.shape,
                                                 jnp.bfloat16))(keys)


def sample_uniforms(route, key, t, rows):
    """The uniforms of a JAX sample's ``t`` steps (``split(key, t)``) over
    ``rows``: the fused sampler's twin's (float32) on the kernel route,
    ``add_gumbel``'s (bfloat16) on the plain one."""
    keys, like = jax.random.split(key, t), jnp.zeros((rows, V))
    if route == "kernel":
        return torch.from_numpy(np.array(_twin_uniforms(keys, like)))
    return torch.from_numpy(np.array(f32(_gumbel_uniforms(keys, like)))).to(BF)


def keeps(config, keys):
    """The dropout keep masks the JAX discriminator passes draw."""
    shape = tapi.disc_keep_shape(config, B)
    return [torch.from_numpy(np.array(jax.random.bernoulli(k, 0.8, shape)))
            for k in keys]


def grad_misses(config, got, got32, jg, tag, gen, fallback=True):
    """Each gradient tensor against the JAX package's, or (``fallback``)
    at least as close to the float32 step's ``got32`` as the JAX
    package's.  A tensor
    whose float32 gradient stays below F32_FLOOR of its side's largest
    entry is below what a bfloat16 step resolves (at initialization the
    attention's query and key projections: their gradient passes through
    the softmax of nearly equal scores, and the key bias's is zero but for
    rounding, the softmax being invariant to a shift of a row of scores):
    it is held in units of the side's largest entry."""
    want = flat(config, jg, gen)
    side = max(float(np.max(np.abs(f32(w)))) for w in want.values())
    out = []
    for name, g in got.items():
        ref = f32(got32[name])
        small = float(np.max(np.abs(ref), initial=0.0)) < F32_FLOOR * side
        out.append(miss(f32(g), f32(want[name]), GRAD_UNITS,
                        f"{tag}: {name}", ref=ref if fallback else None,
                        scale=side if small else None))
    return out


def value_misses(pairs, tag, scales=None):
    """Each ``(port, jax)`` scalar within LOSS_UNITS of the JAX value, or
    of its ``scales`` entry."""
    scales = scales or {}
    return [miss(float(a), float(b), LOSS_UNITS, f"{tag}: {k}",
                 scale=scales.get(k)) for k, (a, b) in pairs.items()]


def spy_dtypes(monkeypatch):
    """Record the ``(wrapper, dtype)`` pairs the kernel wrappers check
    (``kernels/build.py:compute_dtype``)."""
    seen, real = set(), kbuild.compute_dtype

    def spy(fn, t, bf16=True):
        seen.add((fn, t.dtype))
        return real(fn, t, bf16)

    monkeypatch.setattr(kbuild, "compute_dtype", spy)
    return seen


def jax_adv(losses, jstate):
    """``(g_loss, d_loss, aux, gen grads, disc grads)`` of a JAX
    adversarial objective whose ``g_loss`` reaches only the generator and
    ``d_loss`` only the discriminator: one jitted pullback of their sum
    gives both gradient sets."""
    def total(gp, dp):
        g, d, aux = losses(gp, dp)
        return g + d, (g, d, aux)

    (_, (g, d, aux)), (jgg, jdg) = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True))(jstate.gen_params,
                                              jstate.disc_params)
    return g, d, aux, jgg, jdg


def replay_ids(env, jids):
    """The port's transformer samples take the JAX package's ids, step by
    step, where the two differ only at a tie: the JAX package's id must
    have a soft value within a bfloat16 step of the port's row maximum
    (the plain route samples the argmax of a bfloat16 soft row, and the
    two packages round its logits at other places).  Returns the wrapper:
    ``.step`` is the next step (set it to 0 before another sample),
    ``.replayed`` the ``(step, rows)`` replayed."""
    from gan_image_captioning_tpu_torch.models import transformer as ttf

    real = ttf.gumbel_softmax

    def shared(logits, temperature, *args, **kwargs):
        soft, ids = real(logits, temperature, *args, **kwargs)
        t = shared.step
        shared.step += 1
        want = torch.from_numpy(np.array(jids)[:, t]).to(ids.dtype)
        rows = (ids != want).nonzero()[:, 0]
        if len(rows):
            s = soft[rows].to(torch.float32)
            top = s.max(dim=-1).values
            theirs = s.gather(1, want[rows].long()[:, None])[:, 0]
            assert bool((top - theirs <= STEP * top).all()), (t, rows)
            shared.replayed.append((t, rows.tolist()))
        return soft, want

    shared.step, shared.replayed = 0, []
    env.setattr(ttf, "gumbel_softmax", shared)
    return shared
