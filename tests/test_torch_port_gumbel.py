"""The port's fused Gumbel sampler (``kernels/gumbel_sample.py``) and the
``ops/gumbel.py`` kernel route on the CPU against the JAX package: its
``fused_gumbel_sample`` off the TPU (the jnp twin on the uniforms of
``jax.random.uniform(PRNGKey(seed))``) with those uniforms fed to the
port, forward and the custom-VJP backward; and its ``gumbel_softmax`` (the
jnp path) with the uniforms of its key.

Tolerance: soft rows and gradients atol 1e-6 / rtol 1e-5 (float32 softmax
in another order); ids equal, except (against the jnp path, whose ids are
the argmax of the soft row) where the top two ``x`` lie within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.kernels import gumbel_sample as jgs
from gan_image_captioning_tpu.ops import gumbel as jgumbel
from gan_image_captioning_tpu_torch.kernels import gumbel_sample as tgs
from gan_image_captioning_tpu_torch.ops import gumbel as tgumbel

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

TOL = dict(atol=1e-6, rtol=1e-5)


def _logits(b, v, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((b, v))
            * scale).astype(np.float32)


@pytest.mark.parametrize("b,v,temp", [(4, 37, 1.0), (3, 300, 10.0),
                                      (2, 50, 100.0), (5, 9, 0.5)])
def test_forward_matches_jax_twin(b, v, temp):
    logits, seed = _logits(b, v, v), 17
    soft_j, ids_j = jgs.fused_gumbel_sample(jnp.asarray(logits), seed,
                                            jnp.float32(temp))
    u = np.array(jax.random.uniform(jax.random.PRNGKey(seed), (b, v),
                                    jnp.float32))
    before = tgs.gumbel_sample.launches
    soft, ids = tgs.gumbel_sample(torch.from_numpy(logits), temp,
                                  uniforms=torch.from_numpy(u))
    assert tgs.gumbel_sample.launches == before      # the CPU runs no kernel
    np.testing.assert_allclose(soft.numpy(), np.asarray(soft_j), **TOL)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    assert ids.dtype == torch.int32


def test_backward_matches_jax_custom_vjp():
    logits, seed, temp = _logits(3, 40, 2), 5, 2.5
    d = np.random.default_rng(9).standard_normal((3, 40)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jgs.fused_gumbel_sample(x, seed,
                                                       jnp.float32(temp))[0],
                     jnp.asarray(logits))
    want, = vjp(jnp.asarray(d))
    u = np.array(jax.random.uniform(jax.random.PRNGKey(seed), (3, 40),
                                    jnp.float32))
    x = torch.from_numpy(logits).requires_grad_(True)
    soft, _ = tgs.fused_gumbel_sample(x, 0, temp, uniforms=torch.from_numpy(u))
    got, = torch.autograd.grad(soft, x, torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("temp", [1.0, 3.0, 50.0])
def test_kernel_route_matches_jax_gumbel_softmax(temp):
    key = jax.random.PRNGKey(3)
    logits = _logits(6, 80, 1)
    soft_j, ids_j = jgumbel.gumbel_softmax(key, jnp.asarray(logits), temp)
    u = np.array(jax.random.uniform(key, (6, 80), jnp.float32))
    soft, ids = tgumbel.gumbel_softmax(torch.from_numpy(logits), temp,
                                       u=torch.from_numpy(u), kernel=True)
    np.testing.assert_allclose(soft.detach().numpy(), np.asarray(soft_j),
                               **TOL)
    x = (logits + np.asarray(jgumbel.gumbel_noise(key, (6, 80)))) * temp
    top = np.sort(x, axis=-1)[:, -2:]
    differ = ids.numpy() != np.asarray(ids_j)
    assert ((top[:, 1] - top[:, 0])[differ] <= 1e-5 * temp).all()
    # the plain route is unchanged: ids of the soft row, as JAX's
    _, ids_plain = tgumbel.gumbel_softmax(torch.from_numpy(logits), temp,
                                          u=torch.from_numpy(u))
    np.testing.assert_array_equal(ids_plain.numpy(), np.asarray(ids_j))


def test_seeded_draws_are_reproducible_per_step_on_the_cpu():
    logits = torch.from_numpy(_logits(4, 30, 0))
    a = tgs.gumbel_sample(logits, 1.0, seed=3, step=2)
    b = tgs.gumbel_sample(logits, 1.0, seed=3, step=2)
    c = tgs.gumbel_sample(logits, 1.0, seed=3, step=5)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
    assert not torch.equal(a[0], c[0])
    u_out = torch.empty((4, 30))
    d = tgs.gumbel_sample(logits, 1.0, seed=3, step=2, uniforms_out=u_out)
    assert torch.equal(d[0], tgs.gumbel_sample(logits, 1.0,
                                               uniforms=u_out)[0])


def test_malformed_calls_raise():
    x = torch.zeros((2, 5))
    with pytest.raises(ValueError):
        tgs.gumbel_sample(x[0], 1.0)
    with pytest.raises(ValueError):
        tgs.gumbel_sample(x, 1.0, uniforms=torch.zeros((2, 4)))
