"""``--dtype bfloat16`` for the transformer family on the CPU, against the
JAX package on the same inputs (numpy, from seeds) and the same weights
(``interop.train_state_from_jax``):

* the flash attention's bfloat16 plain version (the arithmetic of the
  kernels' bfloat16 instantiations: inputs widened, float32 inside, out,
  dq, dk and dv rounded once, delta from the stored out) against the JAX
  flash kernels in interpret mode on bfloat16 inputs, for the four mask
  forms;
* the fused Gumbel sampler's plain version on bfloat16 logits (soft, ids
  and its VJP) against the JAX kernel's off-TPU twin on the uniforms it
  draws; the plain draw in the logits' dtype;
* config4-shaped MLE and MLE eval losses and gradients, and the Gumbel
  adversarial losses and gradients with the transformer generator, in
  bfloat16 against the JAX package's: through the port's kernel route
  (flash attention and the fused sampler; the JAX package under
  ``GIC_FLASH_ATTN=1`` in interpret mode and ``set_use_pallas(True)``)
  and its plain route (dense attention and the plain Gumbel draw in
  bfloat16; the JAX package's defaults), with the transformer
  discriminator, and through the kernel route with the autoregressive
  one.  The REINFORCE steps are in
  ``tests/test_torch_port_bf16_reinforce.py``.

Every random draw of the JAX functions is reproduced from its keys and
fed to the port.  The tolerances, in bfloat16 steps and units, and their
reasons are those of ``tests/torch_bf16_parity.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.kernels import flash_attention as jfa
from gan_image_captioning_tpu.kernels import gumbel_sample as jgs
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu_torch.kernels import flash_attention as tfa
from gan_image_captioning_tpu_torch.kernels import gumbel_sample as tgs
from gan_image_captioning_tpu_torch.ops import gumbel as tgumbel
from gan_image_captioning_tpu_torch.train import steps as tsteps
from torch_bf16_parity import (B, BF, TEMP, bf16_pair, env, grad_misses,  # noqa: F401
                               jax_adv, keeps, replay_ids, sample_uniforms,
                               setup, spy_dtypes, steps_apart, value_misses)

MASKS = [(True, True), (True, False), (False, False), (False, True)]


# ------------------------------------------------------------- the kernels

@pytest.mark.parametrize("causal,with_lengths", MASKS)
def test_flash_bf16_matches_jax_kernel(env, causal, with_lengths):
    """The port's CPU route in bfloat16 (the kernels' plain version)
    against the JAX flash kernels in interpret mode: out and dq, dk, dv
    bfloat16, each entry within a bfloat16 step."""
    rng = np.random.default_rng(11)
    shape = (2, 12, 2, 16)
    (qj, q), (kj, k), (vj, v), (gj, g) = (
        bf16_pair(rng.standard_normal(shape).astype(np.float32))
        for _ in range(4))
    lens = np.array([12, 5], np.int32) if with_lengths else None
    jl = None if lens is None else jnp.asarray(lens)
    tl = None if lens is None else torch.from_numpy(lens)

    def jloss(a, b, c):
        return jnp.sum(jfa.flash_attention(a, b, c, causal, jl)
                       .astype(jnp.float32) * gj.astype(jnp.float32))

    j_out = jfa.flash_attention(qj, kj, vj, causal, jl)
    j_grads = jax.grad(jloss, (0, 1, 2))(qj, kj, vj)
    assert j_out.dtype == jnp.bfloat16
    tq, tk, tv = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal, tl)
    grads = torch.autograd.grad(out, (tq, tk, tv), g)
    assert out.dtype == BF and all(x.dtype == BF for x in grads)
    steps_apart(out, j_out, "out")
    for name, a, b in zip("qkv", grads, j_grads):
        steps_apart(a, b, f"d{name}")


@pytest.mark.parametrize("v_cols,temp", [(64, 1.0), (61, 2.0)])
def test_gumbel_sampler_bf16_matches_jax_twin(env, v_cols, temp):
    """Soft (bfloat16), ids and the VJP (bfloat16) of the fused sampler's
    plain version on bfloat16 logits against the JAX kernel's off-TPU twin
    (``fused_gumbel_sample``) on the uniforms it draws."""
    rng = np.random.default_rng(v_cols)
    lj, logits = bf16_pair(rng.standard_normal((5, v_cols)).astype(
        np.float32) * 3)
    dj, d = bf16_pair(rng.standard_normal((5, v_cols)).astype(np.float32))
    seed = 1234
    u = torch.from_numpy(np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), (5, v_cols), jnp.float32)))

    def jsoft(x):
        return jgs.fused_gumbel_sample(x, seed, jnp.float32(temp))[0]

    j_soft, j_ids = jgs.fused_gumbel_sample(lj, seed, jnp.float32(temp))
    _, vjp = jax.vjp(jsoft, lj)
    j_dlogits, = vjp(dj)
    x = logits.clone().requires_grad_(True)
    soft, ids = tgs.fused_gumbel_sample(x, seed, temp, uniforms=u)
    dlogits, = torch.autograd.grad(soft, x, d)
    assert soft.dtype == BF and dlogits.dtype == BF
    assert j_soft.dtype == jnp.bfloat16
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    steps_apart(soft, j_soft, "soft")
    steps_apart(dlogits, j_dlogits, "d_logits")


def test_plain_gumbel_draws_in_the_logits_dtype():
    """The plain route computes its noise in the logits' dtype, fed
    uniforms rounded to it (the JAX ``add_gumbel``)."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((3, 40)).astype(
        np.float32)).to(BF)
    u = torch.from_numpy(rng.random((3, 40)).astype(np.float32))
    soft, ids = tgumbel.gumbel_softmax(logits, 2.0, u=u)
    assert soft.dtype == BF
    ub = u.to(BF)
    want = torch.softmax((logits + (-torch.log(-torch.log(ub + 1e-10)
                                               + 1e-10))) * 2.0, dim=-1)
    assert torch.equal(soft, want)


# --------------------------------------------------------------- the steps

@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_mle_and_eval_match_jax(env, route):
    """The transformer's MLE loss (the causal pass over the captions with
    their lengths' key masks) and its gradients, and the eval loss."""
    jconfig, config, jstate, state, ref, jbatch, batch = setup(env, route)
    key = jax.random.PRNGKey(5)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda gp: jsteps.mle_loss(jconfig, gp, jbatch, key, train=True),
        has_aux=True))(jstate.gen_params)
    jeval, _ = jax.jit(lambda gp: jsteps.mle_loss(
        jconfig, gp, jbatch, key, train=False))(jstate.gen_params)
    seen = spy_dtypes(env)
    loss, grads = tsteps.mle_grads(config, state, batch)
    _, m = tsteps.make_mle_eval_step(config)(state, batch)
    assert seen == ({("flash_attention", BF)} if route == "kernel"
                    else set()), seen
    _, grads32 = tsteps.mle_grads(config.replace(dtype="float32"), ref,
                                  batch)
    misses = value_misses({"loss": (loss, jloss),
                           "eval": (m["gen_pretrain_loss"], jeval)}, "mle")
    misses += grad_misses(config, grads, grads32, jg, "mle", True)
    misses = [x for x in misses if x]
    assert not misses, misses
    assert any(not torch.equal(grads[k], grads32[k]) for k in grads)


@pytest.mark.parametrize("route,disc", [
    ("kernel", "transformer"), ("plain", "transformer"),
    ("kernel", "ar_transformer")])
def test_gumbel_adversarial_matches_jax(env, route, disc):
    """The Gumbel adversarial objective with the transformer generator:
    the sample through the fused sampler (kernel route) or the plain draw
    in bfloat16, its backward through the cache decode, the soft sample
    through the discriminator's embedding, three discriminator passes;
    both losses and both gradient sets."""
    jconfig, config, jstate, state, ref, jbatch, batch = setup(
        env, route, disc_arch=disc, adv_objective="gumbel")
    key = jax.random.PRNGKey(7)
    g_loss, d_loss, aux, jgg, jdg = jax_adv(
        lambda gp, dp: jsteps.adv_losses(jconfig, gp, dp, jbatch, key, TEMP,
                                         True, grad_side="both"), jstate)
    _, r_sample, r1, r2, r3, _ = jax.random.split(key, 6)
    noise = {"uniforms": sample_uniforms(route, r_sample, config.seq_len, B),
             "keep": keeps(config, (r1, r2, r3))}
    replay = replay_ids(env, aux["gen_ids"]) if route == "plain" else None
    seen = spy_dtypes(env)
    got = tsteps.adv_grads(config, state, batch, TEMP, noise)
    assert seen == ({("flash_attention", BF), ("gumbel_sample", BF)}
                    if route == "kernel" else set()), seen
    if replay is not None:
        replay.step = 0
    got32 = tsteps.adv_grads(config.replace(dtype="float32"), ref, batch,
                             TEMP, noise)
    np.testing.assert_array_equal(got[4]["gen_ids"].numpy(),
                                  np.asarray(aux["gen_ids"]))
    misses = value_misses({"g_loss": (got[0], g_loss),
                           "d_loss": (got[1], d_loss)}, "gumbel")
    misses += grad_misses(config, got[2], got32[2], jgg, "gen", True)
    misses += grad_misses(config, got[3], got32[3], jdg, "disc", False)
    misses = [x for x in misses if x]
    assert not misses, misses
    assert any(not torch.equal(got[3][k], got32[3][k]) for k in got[3])
