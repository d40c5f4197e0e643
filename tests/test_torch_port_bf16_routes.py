"""The rest of ``--dtype bfloat16`` against the JAX package on the CPU: the
decode routes ``kernel_rescore`` (``GIC_KERNEL_VJP=0``), ``kernel_embed``
(``GIC_FUSE_EMBED=1``) and ``decoupled``, the conv engines ``hybrid`` and
``mxu_dxs`` (``GIC_MXU_DX=0``), ``Config.bf16_grads``
(``GIC_BF16_GRADS=1``) and ``Config.int8_dtype`` (``GIC_INT8_DTYPE``).

* The bfloat16 instantiations' plain versions (decode modes ``sample`` and
  ``sample_embed``, the embed backward, the conv engines' backward) on
  bfloat16 inputs against the JAX kernels in interpret mode, as
  ``tests/test_torch_port_bf16_decode.py`` holds the other modes: ids
  equal; float32 results within 1 bfloat16 unit (2^-8 of the largest
  entry compared), bfloat16 outputs within 2.
* One free-running MLE step, then one adversarial step, of each route
  (and of ``bf16_grads``), from the same state, batch and draws, as
  ``tests/test_torch_port_bf16_steps.py`` holds the kernel route and with
  its tolerances and helpers (the MLE step moves the generator off its
  initialization, where its adversarial gradients are too small for the
  comparison to resolve; and the discriminator is drawn with
  ``disc_init="normal"`` and its output weights scaled by ``DISC_GAIN`` on
  both sides, as ``tests/test_torch_port_bf16_reinforce.py`` draws it: at
  the default initialization it scores every sample alike, and the
  generator's adversarial gradient is a difference of nearly equal
  bfloat16 terms, rounding in either framework, on the routes whose
  softmax both frameworks differentiate in bfloat16): losses 4 units, gradients (Adam's first
  moments) 16, parameters 2 plus the updates' sizes; the leaves XLA sums
  in bfloat16 (``SUMMED_IN_BF16``) may instead be as close as the JAX
  package's to the float32 step.  The JAX side runs the slice's kernels in
  interpret mode (zero uniforms: the port is fed zeros); the decoupled
  route's noise is the JAX package's bfloat16 ``add_gumbel`` uniforms of
  the step's key, fed to the port.  As there, the float32 step put
  through the same comparison must fail it (on the generator's side), and
  every kernel wrapper the step reaches must be handed bfloat16.
* ``int8_dtype``: the compute dtype of the quantized decodes against
  ``_int8_dtype`` under ``GIC_INT8_DTYPE`` on both ``--dtype``s, and the
  quantized greedy decode in bfloat16 at ``--dtype float32`` against the
  JAX package's (the ids and tolerances of
  ``tests/test_torch_port_bf16_decode.py``)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_bf16_decode as bd
import test_torch_port_bf16_steps as bs
from torch_bf16_parity import sharpened
from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.eval import decode as jdecode
from gan_image_captioning_tpu.kernels import decode_sample as jkernel
from gan_image_captioning_tpu.kernels import disc_conv as jdc
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu.train.state import (
    create_train_state as jcreate_train_state)
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.eval import decode as tdecode
from gan_image_captioning_tpu_torch.kernels import build as kbuild
from gan_image_captioning_tpu_torch.kernels import decode_sample as tks
from gan_image_captioning_tpu_torch.kernels import disc_conv
from gan_image_captioning_tpu_torch.models import api as tapi
from gan_image_captioning_tpu_torch.train import steps as tsteps
from gan_image_captioning_tpu_torch.train.state import trainable_parameters

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

BF = torch.bfloat16
UNIT = 2.0 ** -8
F32_UNITS, BF16_UNITS = 1, 2
B, V, TEMP = bs.B, bs.V, bs.TEMP
DISC_GAIN = 10.0

# route → (the JAX config's decode_impl and disc_engine, the environment
# switches that pick the JAX route, the port's Config overrides, the
# kernel wrappers the port's adversarial step hands bfloat16)
ROUTES = {
    "kernel_rescore": (("kernel", "mxu"), {"GIC_KERNEL_VJP": "0"},
                       {"decode_impl": "kernel_rescore"},
                       {"decode_sample", "lstm_bptt_reverse", "disc_conv"}),
    "kernel_embed": (("kernel", "mxu"), {"GIC_FUSE_EMBED": "1"},
                     {"decode_impl": "kernel_embed"},
                     {"decode_sample", "decode_sample_embed_bwd",
                      "lstm_bptt_chain", "disc_conv"}),
    "decoupled": (("decoupled", "mxu"), {}, {"decode_impl": "decoupled"},
                  {"lstm_bptt_reverse", "disc_conv"}),
    "hybrid": (("kernel", "hybrid"), {}, {"disc_engine": "hybrid"},
               {"decode_sample", "lstm_bptt_chain", "disc_conv"}),
    "mxu_dxs": (("kernel", "mxu"), {"GIC_MXU_DX": "0"},
                {"disc_engine": "mxu_dxs"},
                {"decode_sample", "lstm_bptt_chain", "disc_conv"}),
}
# the wrappers of the MLE step, where they are not the kernel route's
MLE_WRAPPERS = {"decoupled": {"lstm_bptt_reverse"}}
# the kernel route, as the bf16_grads step runs it
KERNEL = (("kernel", "mxu"), {}, {},
          {"decode_sample", "lstm_bptt_chain", "disc_conv"})


@pytest.fixture
def env(monkeypatch):
    """The JAX package's kernels in interpret mode, its BPTT kernels on,
    no Adam mu in bfloat16, and no process-wide JAX state shardings
    (another test file may leave them set on its worker)."""
    for var in ("GIC_KERNEL_INTERPRET", "GIC_BPTT_KERNEL", "GIC_BPTT_CHAIN"):
        monkeypatch.setenv(var, "1")
    monkeypatch.setenv("GIC_BF16_MU", "0")
    prev = jsteps._STATE_SHARDINGS
    jsteps.set_state_shardings(None)
    yield monkeypatch
    jsteps.set_state_shardings(prev)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, units, what):
    want = _f32(want)
    np.testing.assert_allclose(
        _f32(got), want, rtol=0, err_msg=what,
        atol=units * UNIT * float(np.max(np.abs(want), initial=0.0)))


# ------------------------------------------- the plain versions' dtypes

def _decoder_args(seed):
    jdec, gen = bd._decoders(seed)
    feats = bd._rows(seed + 1, (bd.B, bd.E))
    return bd._jax_bf16_args(jdec, feats), (
        torch.from_numpy(feats).to(BF), *bd._bf16_layers(gen))


def test_sample_bf16_plain_matches_jax(env):
    """Mode ``sample`` on bfloat16 weights: the ids of the float32 scores
    and the noise stored in bfloat16 (zero uniforms on both sides)."""
    jargs, targs = _decoder_args(31)
    T = bd.T
    ids_j, noise_j = jkernel.decode_sample(*jargs, T, mode="sample")
    ids, noise = tks.decode_sample(*targs, T, mode="sample",
                                   uniforms=torch.zeros(T, bd.B, bd.V))
    assert noise.dtype == BF and noise_j.dtype == jnp.bfloat16
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    _close(noise, noise_j, BF16_UNITS, "noise")


def test_sample_embed_bf16_plain_matches_jax(env):
    """Mode ``sample_embed`` on bfloat16 weights and a bfloat16
    discriminator embedding: ids, the embedding of the soft sample, the
    soft sample and the residuals, all bfloat16."""
    jargs, targs = _decoder_args(37)
    T, ed = bd.T, 8
    wd = (np.random.default_rng(3).standard_normal((ed, bd.V)) * 0.3
          ).astype(np.float32)
    jwd, twd = _pair(wd)
    temp = float(jnp.asarray(2.0, jnp.bfloat16))
    want = jkernel.decode_sample(*jargs, T, mode="sample_embed",
                                 temperature=temp, disc_embed=jwd)
    got = tks.decode_sample(*targs, T, mode="sample_embed", temperature=temp,
                            uniforms=torch.zeros(T, bd.B, bd.V),
                            disc_embed=twd)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for name, a, b in zip(("emb", "soft", "hs", "cs", "gates"), got[1:],
                          want[1:]):
        assert a.dtype == BF and b.dtype == jnp.bfloat16, name
        _close(a, b, BF16_UNITS, name)


def _pair(a):
    """A float32 array rounded to bfloat16: (JAX array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(_f32(j))).to(BF)


def test_embed_bwd_bf16_plain_matches_jax(env):
    """The embed backward on bfloat16 inputs (``_embed_bwd_kernel`` under
    ``dt = bfloat16``): dWp and dbp float32, d_htop bfloat16."""
    rng = np.random.default_rng(9)
    T, Bb, H, Vv, ed = 5, 4, 16, 48, 8
    logits = rng.standard_normal((T, Bb, Vv)).astype(np.float32) * 3.0
    soft = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    pairs = [_pair(a) for a in (
        rng.standard_normal((T, Bb, H)).astype(np.float32), soft,
        rng.standard_normal((T, Bb, ed)).astype(np.float32),
        (rng.standard_normal((Vv, H)) * 0.3).astype(np.float32),
        (rng.standard_normal((ed, Vv)) * 0.3).astype(np.float32))]
    temp = float(jnp.asarray(1.75, jnp.bfloat16))
    want = jkernel.decode_sample_embed_bwd(*(p[0] for p in pairs), temp)
    got = tks.decode_sample_embed_bwd(*(p[1] for p in pairs), temp)
    for name, a, b, units, dt in zip(
            ("dWp", "dbp", "d_htop"), got, want,
            (F32_UNITS, F32_UNITS, BF16_UNITS),
            (torch.float32, torch.float32, BF)):
        assert a.dtype == dt and tuple(a.shape) == tuple(b.shape), name
        _close(a, b, units, name)


@pytest.mark.parametrize("impl,mxu_dx,engine", [("hybrid", "1", "hybrid"),
                                                ("mxu", "0", "mxu_dxs")])
def test_conv_engines_bf16_match_jax(env, impl, mxu_dx, engine):
    """The ``hybrid`` (plain forward, the per-batch-row backward) and
    ``mxu_dxs`` (the DXS backward, the overlap-add rounded once) engines
    on bfloat16 embeddings and banks: pooled features and the three
    gradients, bfloat16 on both sides."""
    env.setenv("GIC_MXU_DX", mxu_dx)
    config, params, emb, probe = _disc_setup()
    eds = config.emb_dim_single
    jconvs = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                    params["convs"])
    jemb, temb = _pair(emb)

    def jloss(convs, e):
        out = jdc.pooled_features(convs, e, eds, impl=impl)
        out = out.reshape(-1, config.disc_feature_dim)
        return jnp.sum(out.astype(jnp.float32) * probe), out

    (_, want), (g_convs, g_emb) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jconvs, jemb)
    convs = [(torch.from_numpy(np.array(_f32(c["w"]))).to(BF).requires_grad_(True),
              torch.from_numpy(np.array(_f32(c["b"]))).to(BF).requires_grad_(True))
             for c in jconvs]
    e = temb.clone().requires_grad_(True)
    out = disc_conv.pooled_features(convs, e, eds, engine)
    out = out.reshape(-1, config.disc_feature_dim)
    (out.float() * torch.from_numpy(probe)).sum().backward()
    assert out.dtype == BF and e.grad.dtype == BF
    _close(out, want, BF16_UNITS, "pooled")
    _close(e.grad, g_emb, BF16_UNITS, "d_emb")
    for k, ((w, b), g) in enumerate(zip(convs, g_convs)):
        _close(w.grad, g["w"], BF16_UNITS, f"dw {k}")
        _close(b.grad, g["b"], BF16_UNITS, f"db {k}")


def _disc_setup(seed=0):
    from gan_image_captioning_tpu.models import discriminator as jdisc

    config = JConfig(vocab_size=40, disc_embed_dim=8, disc_num_rep=4,
                     disc_filter_sizes=(3, 4), disc_num_filters=(8, 6),
                     max_seq_len=7)
    params = jdisc.init_discriminator_params(jax.random.PRNGKey(seed), config)
    # larger weights than the init sweep's, so that ReLU passes some
    params = jax.tree_util.tree_map(lambda x: x * 20.0, params)
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, config.seq_len, config.disc_embed_dim))
    probe = rng.standard_normal((B * config.disc_num_rep,
                                 config.disc_feature_dim))
    return config, params, emb.astype(np.float32), probe.astype(np.float32)


# ------------------------------------------------ the routes' steps

# the JAX side's initial state and its state and metrics after the MLE
# step, shared by the tests of this module: neither depends on the
# switches that pick an adversarial route, and the MLE step is the kernel
# route's on every route but decoupled (numpy leaves: the JAX steps donate
# their inputs)
_JAX = {}


def _jax_init(jconfig):
    if "init" not in _JAX:
        _JAX["init"] = bs._np(sharpened(jax.jit(lambda key: jcreate_train_state(
            jconfig, key))(jax.random.PRNGKey(0)), DISC_GAIN))
    return jax.tree_util.tree_map(jnp.asarray, _JAX["init"])


def _jax_mle(jconfig, jstate, jbatch):
    key = "mle_" + jconfig.decode_impl
    if key not in _JAX:
        jstate, jm = jsteps.make_mle_step(jconfig)(jstate, jbatch)
        _JAX[key] = bs._np((jstate, jm))
    jstate, jm = _JAX[key]
    return jax.tree_util.tree_map(jnp.asarray, jstate), jm


def _setup(env, spec, **over):
    (jimpl, jengine), switches, port, _ = spec
    for k, v in switches.items():
        env.setenv(k, v)
    kw = dict(bs.KW, disc_train_freq=1, disc_init="normal")
    jconfig = JConfig(**kw, decode_impl=jimpl, disc_engine=jengine)
    config = Config(**kw, **port, **over)
    jstate = _jax_init(jconfig)
    state = interop.train_state_from_jax(bs._np(jstate), config)
    ref = interop.train_state_from_jax(bs._np(jstate),
                                       config.replace(dtype="float32"))
    rng = np.random.default_rng(0)
    caps = [rng.integers(4, V, size=rng.integers(1, 5)) for _ in range(B)]
    from gan_image_captioning_tpu.data.loader import make_batch as jmb
    from gan_image_captioning_tpu_torch.data.loader import make_batch

    jbatch = {k: jnp.asarray(v) for k, v in
              jmb(caps, None, config.seq_len).items()}
    batch = tsteps.batch_to(make_batch(caps, None, config.seq_len), "cpu")
    return jconfig, config, jstate, state, ref, jbatch, batch


def _decoupled_uniforms(jstate, config):
    """The JAX decoupled sample's ``add_gumbel`` uniforms (bfloat16, one
    key a step of ``split(rng_sample, T)``) of the next adversarial
    step."""
    _, rng_step = jax.random.split(jstate.rng)
    rng_sample = jax.random.split(rng_step, 6)[1]
    keys = jax.random.split(rng_sample, config.seq_len)
    u = jax.vmap(lambda k: jax.random.uniform(k, (B, V), jnp.bfloat16))(keys)
    return torch.from_numpy(np.array(_f32(u))).to(BF)


@contextlib.contextmanager
def _seen(monkeypatch):
    seen, real = set(), kbuild.compute_dtype

    def spy(fn, t, bf16=True):
        seen.add((fn, t.dtype))
        return real(fn, t, bf16)

    monkeypatch.setattr(kbuild, "compute_dtype", spy)
    try:
        yield seen
    finally:
        monkeypatch.setattr(kbuild, "compute_dtype", real)


def _both(steps, state, ref, args, monkeypatch, wrappers):
    """The bfloat16 and float32 steps, each on its state; every wrapper of
    ``wrappers`` handed bfloat16 by the first, float32 by the second."""
    out = []
    for make, st, want in ((steps[0], state, BF),
                           (steps[1], ref, torch.float32)):
        with _seen(monkeypatch) as seen:
            out.append(make(st, *args))
        assert {fn for fn, _ in seen} == wrappers, seen
        assert {dt for _, dt in seen} == {want}, seen
    return out


def _mle_then_adv(env, spec, jconfig, config, jstate, state, ref, jbatch,
                  batch, port, control):
    """The MLE step, then the adversarial step, on both sides; what is off
    appended to ``port`` (the bfloat16 step) and ``control`` (the float32
    one)."""
    config32 = config.replace(dtype="float32")
    jstate, jm = _jax_mle(jconfig, jstate, jbatch)
    (state, m), (ref, m32) = _both(
        (tsteps.make_mle_step(config), tsteps.make_mle_step(config32)),
        state, ref, (batch,), env,
        MLE_WRAPPERS.get(config.decode_impl,
                         {"decode_sample", "lstm_bptt_reverse"}))
    for cand, mc, sink in ((state, m, port), (ref, m32, control)):
        sink += bs._metric_misses(mc, jm, m32, "mle")
        sink += bs._compare(cand, jstate, ref, "pretrain_opt",
                            "pretrain_opt_state", "gen", config.pretrain_lr,
                            "mle")
    noise = bs._noise(jstate, config)
    if config.decode_impl == "decoupled":
        noise["uniforms"] = _decoupled_uniforms(jstate, config)
    jstate, jm = jsteps.make_adv_step(jconfig)(jstate, jbatch, TEMP)
    (state, m), (ref, m32) = _both(
        (tsteps.make_adv_step(config), tsteps.make_adv_step(config32)),
        state, ref, (batch, TEMP, noise), env, spec[3])
    for cand, mc, sink in ((state, m, port), (ref, m32, control)):
        sink += _adv_metric_misses(mc, jm, m32)
        sink += bs._compare(cand, jstate, ref, "gen_opt", "gen_opt_state",
                            "gen", config.pretrain_lr + config.gen_lr,
                            "adv gen")
        sink += bs._compare(cand, jstate, ref, "disc_opt", "disc_opt_state",
                            "disc", config.disc_lr, "adv disc")
    return state


def _adv_metric_misses(m, jm, m32):
    """The adversarial step's metrics as ``bs._metric_misses`` holds them,
    but for the two mean logits: a mean over logits of both signs can
    cancel far below them, so each is held in units of the larger of the
    two JAX means (the logits' scale), not of its own size."""
    scale = max(abs(float(jm["d_real_mean"])), abs(float(jm["d_fake_mean"])))
    out = []
    for k in jm:
        if k in ("d_real_mean", "d_fake_mean"):
            tol = bs.LOSS_UNITS * UNIT * scale
            err = abs(float(m[k]) - float(jm[k]))
            out.append(None if err <= tol else f"adv {k}: {err} > {tol}")
        else:
            out += bs._metric_misses({k: m[k]}, {k: jm[k]}, m32, "adv")
    return out


def _assert_port_and_control(port, control):
    """Nothing off in the port's step; the float32 step off on the
    generator's adversarial gradients (its discriminator gradients can
    fall within the units under the sharpened discriminator)."""
    port = [x for x in port if x]
    assert not port, port
    control = [x for x in control if x]
    assert any(x.startswith("adv gen: mu.") for x in control), control


@pytest.mark.parametrize("route", list(ROUTES))
def test_bf16_route_step_matches_jax(env, route):
    """The MLE step and one adversarial step of ``route`` in bfloat16
    against the JAX package's."""
    spec = ROUTES[route]
    jconfig, config, jstate, state, ref, jbatch, batch = _setup(env, spec)
    port, control = [], []
    state = _mle_then_adv(env, spec, jconfig, config, jstate, state, ref,
                          jbatch, batch, port, control)
    _assert_port_and_control(port, control)
    assert all(p.dtype == torch.float32 for p in state.gen.parameters())
    assert all(p.dtype == torch.float32 for p in state.disc.parameters())


def test_bf16_grads_step_matches_jax(env):
    """``Config.bf16_grads`` against the JAX step under
    ``GIC_BF16_GRADS=1``: the port differentiates with respect to
    bfloat16 leaves (every trainable tensor ``_grads`` reads is bfloat16)
    and the updates and moments stay float32."""
    env.setenv("GIC_BF16_GRADS", "1")
    jconfig, config, jstate, state, ref, jbatch, batch = _setup(
        env, KERNEL, bf16_grads=True)
    dtypes, real = [], tsteps._grads

    def spy(loss, *modules):
        dtypes.append({p.dtype for m in modules
                       for p in trainable_parameters(m).values()})
        return real(loss, *modules)

    env.setattr(tsteps, "_grads", spy)
    port, control = [], []
    state = _mle_then_adv(env, KERNEL, jconfig, config, jstate, state, ref,
                          jbatch, batch, port, control)
    # per backward, the dtypes of the trainable tensors it reads: the MLE
    # steps' float32 masters (read through the cast), then the adversarial
    # steps', the bfloat16 step's leaves and the float32 control's masters
    assert dtypes == [{torch.float32}, {torch.float32}, {BF},
                      {torch.float32}], dtypes
    _assert_port_and_control(port, control)
    for opt in (state.gen_opt, state.disc_opt):
        assert all(v.dtype == torch.float32 for v in opt.mu.values())
    assert all(p.dtype == torch.float32 for p in state.gen.parameters())


# --------------------------------------------------------- int8_dtype

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("switch", ["", "float32", "bfloat16"])
def test_int8_dtype_follows_the_jax_switch(monkeypatch, dtype, switch):
    monkeypatch.setenv("GIC_INT8_DTYPE", switch)
    want = jdecode._int8_dtype(JConfig(dtype=dtype))
    got = tdecode.int8_dtype(Config(dtype=dtype, int8_dtype=switch))
    assert str(got).split(".")[-1] == jnp.dtype(want).name


def test_int8_bfloat16_decode_at_float32_matches_jax(monkeypatch):
    """``int8_dtype="bfloat16"`` at ``--dtype float32`` (the JAX
    ``GIC_INT8_DTYPE=bfloat16``): the quantized greedy decode computes in
    bfloat16 on both sides."""
    monkeypatch.setenv("GIC_KERNEL_INTERPRET", "1")
    monkeypatch.setenv("GIC_INT8_DTYPE", "bfloat16")
    jconfig, config = bd._configs("float32")
    config = config.replace(int8_dtype="bfloat16")
    jdec, _ = bd._decoders(seed=7)
    jqdec, qdec = bd._quantized(jdec, 8)
    feats = bd._rows(21, (bd.B, bd.E))
    ids_j, lp_j = jdecode.greedy_with_logprobs(
        {"decoder": jqdec}, jnp.asarray(feats), jconfig)
    ids, lp = tdecode.greedy_with_logprobs({"decoder": qdec},
                                           torch.from_numpy(feats), config)
    _, lps_j = jkernel.decode_sample_q_serve(
        jnp.asarray(feats, jnp.bfloat16), jqdec, bd.T - 2, bits=8)
    _, lps = tks.decode_sample_q_serve(torch.from_numpy(feats).to(BF), qdec,
                                       bd.T - 2, bits=8)
    ids_j, lp_j = np.asarray(ids_j), np.asarray(lp_j)
    bd.assert_ids_agree(ids.numpy(), ids_j, lps.numpy(), np.asarray(lps_j),
                        bd._tol(lps_j))
    same = (ids.numpy() == ids_j).all(axis=1)
    assert same.sum() >= bd.B - 1
    np.testing.assert_allclose(lp.numpy()[same], lp_j[same], rtol=0,
                               atol=bd._tol(lps_j))
    # the float32 decode of the same weights parts from it
    lp32 = tdecode.greedy_with_logprobs(
        {"decoder": qdec}, torch.from_numpy(feats),
        config.replace(int8_dtype="float32"))[1]
    assert not np.allclose(lp32.numpy(), lp_j, rtol=0, atol=bd._tol(lps_j))


def test_int8_dtype_reaches_the_service():
    """``CaptionService(args, int8_dtype=...)``: the service's quantized
    decode computes in that dtype at ``--dtype float32`` (its stepper's
    state bfloat16), and its captions are the quantized greedy decode's
    in bfloat16."""
    from gan_image_captioning_tpu_torch import serve

    args = serve.parse_args(["--init-seed", "0", "--dataset", "synthetic",
                             "--device", "cpu", "--gen-embed-dim", "16",
                             "--gen-hidden-dim", "16", "--gen-num-layers",
                             "2", "--quantize", "int8"])
    service = serve.CaptionService(args, int8_dtype="bfloat16")
    try:
        assert (service.config.dtype, service.config.int8_dtype) == (
            "float32", "bfloat16")
        resp = service.handle_request({"n": 2})
        state = tdecode.make_stepper(service.dec_params,
                                     service.config).init_state(1)
        assert state[0].dtype == BF
        row = tapi.start_token_features(service.config, service.generator,
                                        1)
        ids, _ = tdecode.greedy_with_logprobs(service.dec_params, row,
                                              service.config)
        assert resp["captions"] == [service._caption(ids[0].tolist())] * 2
    finally:
        service.close()


def test_embed_bwd_plan_of_both_dtypes():
    """The bfloat16 backward's plan: splits of its own tiles (se two
    blocks an SM, d_htop's wgmma blocks of 128 x 256, each within one wave;
    float32 keeps its own), six launches (dbp summed in the dWp launch), and a scratch of the
    bfloat16 d_logits, inner, the se partials, the column sums of each
    64-row tile and the d_htop partials (split or not), each from a
    multiple of 4 floats."""
    R, H, Vv, Ed, n_sm = 36 * 64, 512, 11008, 64, 132
    f32 = tks.embed_bwd_plan(R, H, Vv, Ed, n_sm)
    bf = tks.embed_bwd_plan(R, H, Vv, Ed, n_sm, True)
    assert (f32["se"]["splits"], f32["d_htop"]["splits"]) == (22, 11)
    assert (bf["se"]["splits"], bf["d_htop"]["splits"]) == (14, 3)
    assert bf["d_htop"]["tiles"] == 18 * 2
    assert (f32["launches"], bf["launches"]) == (
        5 + (f32["d_htop"]["splits"] > 1), 6)

    def pad4(n):
        return -(-n // 4) * 4
    s0, s3 = bf["se"]["splits"], bf["d_htop"]["splits"]
    assert bf["scratch_floats"] == (pad4(-(-R * Vv // 2)) + pad4(R)
                                    + pad4(s0 * R * Ed)
                                    + pad4(-(-R // 64) * Vv) + s3 * R * H)
    assert bf["ints"][4] == bf["scratch_floats"]
