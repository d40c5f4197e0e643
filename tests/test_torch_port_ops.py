"""The port's ops against the JAX package's (``ops/losses.py``,
``ops/gumbel.py``, ``ops/temperature.py``) on the same numpy inputs.

Tolerance: atol = rtol = 1e-6 for the float32 losses (elementwise math and
one mean in another order), 1e-6 for the Gumbel noise and soft samples,
exact for the ids and for the temperature policies (float64 host math)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.ops import gumbel as jgumbel
from gan_image_captioning_tpu.ops import losses as jlosses
from gan_image_captioning_tpu.ops.temperature import (
    get_fixed_temperature as jtemperature)
from gan_image_captioning_tpu_torch.ops import gumbel, losses
from gan_image_captioning_tpu_torch.ops.temperature import (
    ADAPT_TYPES, get_fixed_temperature)

TOL = dict(atol=1e-6, rtol=1e-6)


def _logits(seed, *shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 2).astype(
        np.float32)


@pytest.mark.parametrize("loss_type", losses.LOSS_TYPES)
@pytest.mark.parametrize("weighted", [False, True])
def test_gan_losses_match_jax(loss_type, weighted):
    real, fake, gen = _logits(0, 12), _logits(1, 12), _logits(2, 12)
    w = (np.random.default_rng(3).integers(0, 2, 12).astype(np.float32)
         if weighted else None)
    want = jlosses.gan_losses(real, fake, gen, loss_type, real_label=0.9,
                              weights=w)
    got = losses.gan_losses(*map(torch.from_numpy, (real, fake, gen)),
                            loss_type, real_label=0.9,
                            weights=None if w is None else torch.from_numpy(w))
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), **TOL)


def test_unknown_loss_type_raises():
    x = torch.zeros(3)
    with pytest.raises(NotImplementedError):
        losses.gan_losses(x, x, x, "wasserstein")


def test_bce_matches_torch_module():
    x, z = _logits(4, 20), (np.arange(20) % 2).astype(np.float32)
    want = torch.nn.BCEWithLogitsLoss()(torch.from_numpy(x),
                                        torch.from_numpy(z))
    np.testing.assert_allclose(
        float(losses.bce_with_logits(torch.from_numpy(x), torch.from_numpy(z))),
        float(want), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    logits = _logits(5, 3, 6, 11)
    targets = np.random.default_rng(6).integers(0, 11, (3, 6)).astype(np.int32)
    mask = (np.random.default_rng(7).integers(0, 2, (3, 6)).astype(np.float32)
            if masked else None)
    want = jlosses.cross_entropy_loss(logits, targets, mask)
    got = losses.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(targets),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_gumbel_noise_and_softmax_match_jax_with_fed_uniforms():
    key = jax.random.PRNGKey(3)
    logits = _logits(8, 4, 9)
    u = np.array(jax.random.uniform(key, (4, 9), jnp.float32))
    np.testing.assert_allclose(
        gumbel.gumbel_noise((4, 9), u=torch.from_numpy(u)).numpy(),
        np.asarray(jgumbel.gumbel_noise(key, (4, 9))), **TOL)
    soft_j, ids_j = jgumbel.gumbel_softmax(key, jnp.asarray(logits), 3.0)
    soft, ids = gumbel.gumbel_softmax(torch.from_numpy(logits), 3.0,
                                      u=torch.from_numpy(u))
    np.testing.assert_allclose(soft.numpy(), np.asarray(soft_j), **TOL)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))


def test_gumbel_draws_from_the_generator():
    a = gumbel.gumbel_noise((500,), torch.Generator().manual_seed(1))
    b = gumbel.gumbel_noise((500,), torch.Generator().manual_seed(1))
    c = gumbel.gumbel_noise((500,), torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # Gumbel(0, 1): mean = Euler's constant 0.5772, sd = pi/sqrt(6) = 1.28
    big = gumbel.gumbel_noise((200_000,), torch.Generator().manual_seed(3))
    assert abs(float(big.mean()) - 0.5772) < 0.02


@pytest.mark.parametrize("adapt", ADAPT_TYPES)
def test_temperature_policies_match_jax(adapt):
    for i in (0, 1, 7, 19):
        assert get_fixed_temperature(100, i, 20, adapt) == pytest.approx(
            jtemperature(100, i, 20, adapt), rel=1e-12)
    with pytest.raises(Exception):
        get_fixed_temperature(100, 1, 20, "cubic")
