"""The conditional transformer under ``--dtype bfloat16`` (config5's
compute) against the JAX package's bfloat16 steps on the CPU, on the
kernel route (the port's flash and fused-sampler wrappers, whose plain
versions run on CPU tensors; the JAX flash kernels in interpret mode and
its fused sampler's twin, as ``tests/torch_bf16_parity.py`` sets them):
the MLE loss and gradients on the ResNet-18 grid; the Gumbel adversarial
losses and both gradient sets on the ResNet-18 and the ViT grid (the
default CNN discriminator, as config5 has); REINFORCE on the ResNet grid.
The CNN discriminator of the adversarial tests is drawn
``disc_init="normal"``, so that its scores of different sequences differ
by more than bfloat16 steps (its probabilities 0.01-0.1): at the default
initialization it scores every sequence alike and the generator's
gradients are rounding (1e-8).  The ViT runs two of its twelve blocks here (its
width is ViT-B's; ``test_torch_port_vit.py`` holds all twelve).  The
models are the GPT-2 family cut small (d 64, 2 layers, 4 heads, V 64); images 64 × 64 (ResNet) and 32 × 32 (ViT), B = 4.

Tolerances are ``tests/torch_bf16_parity.py``'s: losses within 4
bfloat16 units, each gradient tensor within 16 units of its largest entry
or at least as close to the port's float32 step as the JAX package's is;
ids equal.  Each check also requires the port's step to be a bfloat16
computation (the wrappers handed bfloat16, gradients not the float32
step's).  A frozen ViT is left out of the gradients on the port's side
(``test_torch_port_vit.py`` says why)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.loader import make_batch as jmake_batch
from gan_image_captioning_tpu.models import api as japi
from gan_image_captioning_tpu.models import vit as jvit
from gan_image_captioning_tpu.ops import gumbel as jgumbel
from gan_image_captioning_tpu.train import reinforce as jrl
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.models import vit as tvit
from gan_image_captioning_tpu_torch.train import steps as tsteps
from gan_image_captioning_tpu_torch.train.state import create_train_state
from torch_bf16_parity import (B, BF, F32_FLOOR, GRAD_UNITS, TEMP, V,  # noqa: F401
                               env, f32, jax_adv, keeps, miss,
                               sample_uniforms, spy_dtypes, value_misses)

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

SIZE = {"resnet18": 64, "vit": 32}
VIT_DEPTH = 2
KW = dict(vocab_size=V, gen_arch="transformer", disc_arch="cnn",
          gen_embed_dim=64, gen_hidden_dim=128, gen_num_layers=2,
          gen_num_heads=4, max_seq_len=6, disc_embed_dim=8, disc_num_rep=4,
          disc_filter_sizes=(2, 3), disc_num_filters=(5, 6),
          conditional_gan=1, rollout_num=2, rollout_stride=4,
          gen_lr=1e-3, disc_lr=1e-3, dtype="bfloat16")
_PARAMS = {}


def _params(jconfig):
    """The JAX generator (cached per encoder) and discriminator (per
    init): jitted inits, built once a module, as the JAX functions here
    only read them."""
    keys = ("gen", jconfig.encoder_arch), ("disc", jconfig.disc_init)
    if keys[0] not in _PARAMS:
        _PARAMS[keys[0]] = jax.jit(lambda k: japi.init_generator(
            k, jconfig))(jax.random.PRNGKey(0))
    if keys[1] not in _PARAMS:
        _PARAMS[keys[1]] = jax.jit(lambda k: japi.init_discriminator(
            k, jconfig))(jax.random.PRNGKey(1))
    return _PARAMS[keys[0]], _PARAMS[keys[1]]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(env, encoder, **over):
    """JAX config and params; the port's bfloat16 state and its float32
    twin from them; the conditional batch on both sides."""
    kw = dict(KW, encoder_arch=encoder, image_size=SIZE[encoder], **over)
    jconfig, config = JConfig(**kw), Config(**kw)
    if encoder == "vit":
        # two of ViT-B's twelve blocks on both sides (the width stays
        # ViT-B's): the bfloat16 step's rounding, at a CPU test's cost;
        # test_torch_port_vit.py holds all twelve
        env.setattr(jvit, "DEPTH", VIT_DEPTH)
        env.setattr(tvit, "DEPTH", VIT_DEPTH)
    env.setenv("GIC_FLASH_ATTN", "1")
    env.setattr(jgumbel, "_USE_PALLAS", True)
    gp, dp = _params(jconfig)

    def state(cfg):
        return create_train_state(
            cfg, 0, gen=interop.transformer_generator_from_jax(_np(gp), cfg),
            disc=interop.discriminator_from_jax(_np(dp), cfg))

    rng = np.random.default_rng(0)
    T, S = config.seq_len, SIZE[encoder]
    caps = [rng.integers(4, V, size=rng.integers(1, T)) for _ in range(B)]
    imgs = [(rng.standard_normal((3, S, S)) * rng.uniform(0.5, 2)
             + rng.uniform(-1, 1, (3, 1, 1))).astype(np.float32)
            for _ in range(B)]
    jbatch = {k: jnp.asarray(v) for k, v in
              jmake_batch(caps, imgs, T).items()}
    batch = tsteps.batch_to(make_batch(caps, imgs, T), "cpu")
    return (jconfig, config, gp, dp, state(config),
            state(config.replace(dtype="float32")), jbatch, batch)


def _grad_misses(got, got32, want, tag):
    """``torch_bf16_parity.grad_misses`` over the port's names (the
    conditional generator's encoder included)."""
    side = max(float(np.max(np.abs(f32(w)))) for w in want.values())
    out = []
    for name, g in got.items():
        ref = f32(got32[name])
        small = float(np.max(np.abs(ref), initial=0.0)) < F32_FLOOR * side
        out.append(miss(f32(g), f32(want[name]), GRAD_UNITS,
                        f"{tag}: {name}", ref=ref,
                        scale=side if small else None))
    return [m for m in out if m]


def _gen(tree):
    return interop._transformer_gen_params(_np(tree))


def test_mle_matches_jax(env):
    jconfig, config, gp, _, state, ref, jbatch, batch = _setup(
        env, "resnet18")
    key = jax.random.PRNGKey(5)
    jloss, jg = jax.jit(jax.value_and_grad(lambda p: jsteps.mle_loss(
        jconfig, p, jbatch, key, train=True)[0]))(gp)
    seen = spy_dtypes(env)
    loss, grads = tsteps.mle_grads(config, state, batch)
    assert seen == {("flash_attention", BF)}, seen
    _, grads32 = tsteps.mle_grads(ref_config(config), ref, batch)
    misses = value_misses({"loss": (loss, jloss)}, "mle")
    misses += _grad_misses(grads, grads32, _gen(jg), "mle")
    misses = [m for m in misses if m]
    assert not misses, misses
    assert any(not torch.equal(grads[k], grads32[k]) for k in grads)


def ref_config(config):
    return config.replace(dtype="float32")


@pytest.mark.parametrize("encoder", ["resnet18", "vit"])
def test_gumbel_adversarial_matches_jax(env, encoder):
    jconfig, config, gp, dp, state, ref, jbatch, batch = _setup(
        env, encoder, disc_init="normal")
    key = jax.random.PRNGKey(7)
    g_loss, d_loss, aux, jgg, jdg = jax_adv(
        lambda g, d: jsteps.adv_losses(jconfig, g, d, jbatch, key, TEMP,
                                       True, grad_side="both"),
        _Pair(gp, dp))
    _, r_sample, r1, r2, r3, _ = jax.random.split(key, 6)
    noise = {"uniforms": sample_uniforms("kernel", r_sample, config.seq_len,
                                         B),
             "keep": keeps(config, (r1, r2, r3))}
    seen = spy_dtypes(env)
    got = tsteps.adv_grads(config, state, batch, TEMP, noise)
    # the cache decode is dense: the sampler and the conv banks launch
    assert {("gumbel_sample", BF), ("disc_conv", BF)} <= seen, seen
    assert {dt for _, dt in seen} == {BF}, seen
    got32 = tsteps.adv_grads(ref_config(config), ref, batch, TEMP, noise)
    np.testing.assert_array_equal(got[4]["gen_ids"].numpy(),
                                  np.asarray(aux["gen_ids"]))
    want_g = _gen(jgg)
    if encoder == "vit":
        # frozen: the port's ViT has no gradient, the JAX package's has one
        assert not any(k.startswith("encoder.vit.") for k in got[2])
        assert any(float(want_g[k].abs().max()) > 0 for k in want_g
                   if k.startswith("encoder.vit."))
    misses = value_misses({"g_loss": (got[0], g_loss),
                           "d_loss": (got[1], d_loss)}, "gumbel")
    misses += _grad_misses(got[2], got32[2], want_g, "gen")
    misses += _grad_misses(got[3], got32[3],
                           interop.disc_params_from_jax(_np(jdg)), "disc")
    misses = [m for m in misses if m]
    assert not misses, misses
    assert any(not torch.equal(got[2][k], got32[2][k]) for k in got[2])


class _Pair:
    """What ``torch_bf16_parity.jax_adv`` reads of a JAX state."""

    def __init__(self, gen_params, disc_params):
        self.gen_params, self.disc_params = gen_params, disc_params


def test_reinforce_matches_jax(env):
    """REINFORCE over the ResNet grid: the sample, the rollouts (the grid
    repeated K times), the greedy baseline and the log-probability pass in
    bfloat16; losses, the mean reward and both gradient sets."""
    jconfig, config, gp, dp, state, ref, jbatch, batch = _setup(
        env, "resnet18", adv_objective="reinforce", disc_init="normal")
    key = jax.random.PRNGKey(6)
    g_loss, d_loss, aux, jgg, jdg = jax_adv(
        lambda g, d: jrl.reinforce_losses(jconfig, g, d, jbatch, key, 1.0,
                                          True), _Pair(gp, dp))
    r_sample, r_roll, r_d1, r_d2, _ = jax.random.split(key, 5)
    T = config.seq_len
    npos = len(range(config.rollout_stride, T, config.rollout_stride))
    noise = {"uniforms": sample_uniforms("kernel", r_sample, T, B),
             "rollout_uniforms": [
                 sample_uniforms("plain", k, T, B * config.rollout_num)
                 for k in jax.random.split(r_roll, npos)],
             "keep": keeps(config, (r_d1, r_d2)), "seed": 0}
    got = tsteps.adv_grads(config, state, batch, 1.0, noise)
    got32 = tsteps.adv_grads(ref_config(config), ref, batch, 1.0, noise)
    np.testing.assert_array_equal(got[4]["gen_ids"].numpy(),
                                  np.asarray(aux["gen_ids"]))
    misses = value_misses({
        "g_loss": (got[0], g_loss), "d_loss": (got[1], d_loss),
        "mean_reward": (got[4]["mean_reward"], aux["mean_reward"])},
        "reinforce")
    misses += _grad_misses(got[2], got32[2], _gen(jgg), "gen")
    misses += _grad_misses(got[3], got32[3],
                           interop.disc_params_from_jax(_np(jdg)), "disc")
    misses = [m for m in misses if m]
    assert not misses, misses
    assert float(got[1]) != float(got32[1])
