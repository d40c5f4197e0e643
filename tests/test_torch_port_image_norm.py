"""The port's ``image_norm`` plain version against the JAX package's
``normalize_images`` (its CPU twin, ``(u8 / 255 - mean) / std``, as
``tests/test_pallas_kernels.py`` runs it) on the same uint8 images, within
2e-6 absolute; and bit-equal to the TPU kernel's arithmetic
(``u8 * scale[c] + shift[c]`` with float32 constants); the bfloat16
output is that result rounded once.  On CPU tensors the
wrapper runs the plain version and launches nothing; malformed input
raises before any launch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.kernels import image_norm as jnorm
from gan_image_captioning_tpu_torch.kernels import image_norm as tnorm

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

ATOL = 2e-6
# an odd plane (37 x 37: H*W % 4 == 1), a one-pixel plane, a wide one
SHAPES = [(2, 3, 8, 16), (3, 3, 37, 37), (4, 3, 1, 1), (1, 3, 5, 130)]


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax(shape):
    u8 = _u8(shape, sum(shape))
    want = np.asarray(jnorm.normalize_images(jnp.asarray(u8)))
    got = tnorm.normalize_images_plain(torch.from_numpy(u8))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_every_byte_value_matches_jax():
    u8 = np.broadcast_to(np.arange(256, dtype=np.uint8), (1, 3, 1, 256))
    u8 = np.ascontiguousarray(u8)
    want = np.asarray(jnorm.normalize_images(jnp.asarray(u8)))
    got = tnorm.normalize_images_plain(torch.from_numpy(u8)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_plain_is_the_tpu_kernel_arithmetic():
    """``x * scale[c] + shift[c]`` in float32, each operation rounded
    once, with the constants computed in double and rounded as the JAX
    package rounds them (``kernels/image_norm.py:47-48``)."""
    scale = np.float32([1.0 / (255.0 * s) for s in jnorm.STD])
    shift = np.float32([-m / s for m, s in zip(jnorm.MEAN, jnorm.STD)])
    assert np.array_equal(np.float32(tnorm.SCALE), scale)
    assert np.array_equal(np.float32(tnorm.SHIFT), shift)
    u8 = _u8((2, 3, 7, 9), 1)
    want = (u8.astype(np.float32) * scale.reshape(1, 3, 1, 1)
            + shift.reshape(1, 3, 1, 1))
    got = tnorm.normalize_images_plain(torch.from_numpy(u8)).numpy()
    assert np.array_equal(got, want)


def test_cpu_tensor_runs_the_plain_version_without_launching():
    u8 = torch.from_numpy(_u8((2, 3, 5, 5), 2))
    before = tnorm.normalize_images.launches
    out = tnorm.normalize_images(u8)
    assert tnorm.normalize_images.launches == before
    assert torch.equal(out, tnorm.normalize_images_plain(u8))


def test_constants_match_the_host_preprocessing():
    from gan_image_captioning_tpu_torch.data import images

    np.testing.assert_array_equal(np.float32(tnorm.MEAN), images.IMAGENET_MEAN)
    np.testing.assert_array_equal(np.float32(tnorm.STD), images.IMAGENET_STD)


@pytest.mark.parametrize("make,err", [
    (lambda: torch.zeros(2, 3, 4, 4), TypeError),
    (lambda: torch.zeros(2, 3, 4, 4, dtype=torch.int32), TypeError),
    (lambda: torch.zeros(2, 4, 4, 4, dtype=torch.uint8), ValueError),
    (lambda: torch.zeros(3, 4, 4, dtype=torch.uint8), ValueError),
    (lambda: torch.zeros(2, 4, 4, 3, dtype=torch.uint8).permute(0, 3, 1, 2),
     ValueError)])
def test_malformed_input_raises(make, err):
    before = tnorm.normalize_images.launches
    with pytest.raises(err):
        tnorm.normalize_images(make())
    assert tnorm.normalize_images.launches == before


@pytest.mark.parametrize("shape", SHAPES)
def test_bfloat16_output_matches_jax(shape):
    """``--dtype bfloat16``: the same float32 map rounded once to bfloat16
    (the TPU kernel's ``.astype(out_ref.dtype)``), bit-equal to rounding
    the float32 plain version, and within one bfloat16 step (2^-7 of the
    largest |entry|) of the JAX package's bfloat16 images: its CPU twin
    divides where the kernel multiplies, so a float32 result on a
    rounding boundary may round to the neighbouring bfloat16."""
    u8 = _u8(shape, 7 + sum(shape))
    want = np.asarray(jnorm.normalize_images(jnp.asarray(u8), jnp.bfloat16)
                      .astype(jnp.float32))
    got = tnorm.normalize_images(torch.from_numpy(u8), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    f32 = tnorm.normalize_images_plain(torch.from_numpy(u8))
    assert torch.equal(got, f32.to(torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())
