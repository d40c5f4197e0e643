"""The port's ResNet-18 backbone and image encoder against the JAX
package's ``resnet18`` / ``encoder.encode`` on the same weights
(``interop.encoder_from_jax``) and the same images: outputs and the new
BatchNorm running statistics in eval and train mode, and the gradients of
a frozen and of a trainable backbone against ``jax.grad`` (mirroring
``tests/test_encoder.py``).

Tolerance: rtol 1e-4, atol 1e-5 (float32 convolutions and batch
reductions in another order).  Train-mode BatchNorm divides by the batch's
spread, which magnifies rounding where that spread is small, so the
images are 8 per batch, 64 x 64, each with its own scale and colour
offset, as real images differ."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.models import encoder as jenc
from gan_image_captioning_tpu.models import resnet as jres
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.interop import (encoder_from_jax,
                                                    encoder_params_from_jax)
from gan_image_captioning_tpu_torch.models import encoder as tenc
from gan_image_captioning_tpu_torch.models import resnet as tres

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

TOL = dict(rtol=1e-4, atol=1e-5)
B, S, E = 8, 64, 24
KW = dict(vocab_size=40, gen_embed_dim=E, gen_hidden_dim=16,
          conditional_gan=1, image_size=S)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, 3, s, s)) * rng.uniform(0.5, 2, (b, 1, 1, 1))
         + rng.uniform(-1, 1, (b, 3, 1, 1)))
    return x.astype(np.float32)


# float64 comparisons need no well-conditioned batch: a smaller one
B64, S64 = 4, 32


@pytest.fixture(scope="module")
def jparams():
    return jenc.init_encoder_params(jax.random.PRNGKey(3), JConfig(**KW))


def _assert_stats(enc, jtree, new_stats):
    """The port encoder's running statistics against the JAX
    ``new_stats`` tree."""
    want = encoder_params_from_jax(_np(dict(jtree, bn_stats=new_stats)),
                                   prefix="")
    got = enc.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * (1 + 4 * 2 * 2 + 3 + 1)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_resnet18_matches_jax(jparams, train):
    x = _images()
    config = Config(**KW)
    enc = encoder_from_jax(_np(jparams), config)
    want, new = jres.resnet18(jparams["backbone"],
                              jparams["bn_stats"]["backbone"], jnp.asarray(x),
                              train)
    with torch.no_grad():
        got = enc.resnet(torch.from_numpy(x), train)
    assert got.shape == (B, tres.FEATURE_DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_stats(enc, jparams,
                  {"backbone": new, "head": jparams["bn_stats"]["head"]})


@contextlib.contextmanager
def _jax_float64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("trainable", [0, 1])
@pytest.mark.parametrize("train", [False, True])
def test_encode_matches_jax(jparams, train, trainable):
    """float32: the running statistics, and the features in eval mode.
    Train mode's features are held to the same tolerance in float64 on
    both sides: in float32 two correct implementations differ there by up
    to 4e-5 on features near 1 (each 1-2e-5 from the float64 result,
    measured at this size), more than atol 1e-5 allows for the small
    ones."""
    x = _images(1)
    jconfig = JConfig(**KW, trainable_backbone=trainable)
    config = Config(**KW, trainable_backbone=trainable)
    enc = encoder_from_jax(_np(jparams), config)
    want, new = jenc.encode(jparams, jnp.asarray(x), jconfig, train)
    with torch.no_grad():
        got = tenc.encode(enc, torch.from_numpy(x), config, train)
    assert got.shape == (B, E) and got.dtype == torch.float32
    _assert_stats(enc, jparams, new)
    moved = not np.array_equal(np.asarray(new["head"]["mean"]),
                               np.asarray(jparams["bn_stats"]["head"]["mean"]))
    assert moved == train
    if not train:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    x = _images(1, B64, S64)
    p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                 _np(jparams))
    with _jax_float64():
        want64, _ = jenc.encode(jax.tree_util.tree_map(jnp.asarray, p64),
                                jnp.asarray(x.astype(np.float64)), jconfig,
                                train)
        want64 = np.asarray(want64)
    assert want64.dtype == np.float64
    enc64 = encoder_from_jax(_np(jparams), config).double()
    with torch.no_grad():
        got64 = tenc.encode(enc64, torch.from_numpy(x).double(), config,
                            train)
    np.testing.assert_allclose(got64.numpy(), want64, **TOL)


def _jax_grads64(jparams, x, ct, trainable):
    jconfig = JConfig(**KW, trainable_backbone=trainable)
    p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                 _np(jparams))
    with _jax_float64():
        def loss(p):
            feats, _ = jenc.encode(p, jnp.asarray(x, jnp.float64), jconfig,
                                   train=True)
            return jnp.sum(feats * jnp.asarray(ct, jnp.float64))

        grads = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, p64))
        return _np(grads)


def _port_grads(jparams, x, ct, config, dtype):
    enc = encoder_from_jax(_np(jparams), config).to(dtype)
    feats = tenc.encode(enc, torch.from_numpy(x).to(dtype), config,
                        train=True)
    (feats * torch.from_numpy(ct).to(dtype)).sum().backward()
    return dict(enc.named_parameters())


@pytest.mark.parametrize("trainable", [0, 1])
def test_gradients_frozen_and_trainable_match_jax(jparams, trainable):
    """In float64 on both sides (rtol 1e-4, atol 1e-5): in float32 the JAX
    package's CPU convolution gradients are 0.6 % off the float64 result
    at conv1, the port's 4e-6.  The port's float32 gradients are held
    within 1e-4 of their tensor's largest float64 gradient, on the
    8 x 64 x 64 batch (train-mode BatchNorm over fewer, smaller images
    magnifies float32 rounding past that)."""
    config = Config(**KW, trainable_backbone=trainable)
    x = _images(2, B64, S64)
    ct = np.random.default_rng(4).standard_normal((B64, E))
    jg = _jax_grads64(jparams, x, ct, trainable)
    assert jg["proj"]["w"].dtype == np.float64
    params = _port_grads(jparams, x, ct, config, torch.float64)
    want = encoder_params_from_jax(dict(_np(jparams), backbone=jg["backbone"],
                                        proj=jg["proj"],
                                        head_bn=jg["head_bn"]), prefix="")
    backbone = [k for k in params if k.startswith("resnet.")]
    assert len(backbone) == 1 + 2 + 4 * 2 * 6 + 3 * 3
    x, ct = _images(3), np.random.default_rng(5).standard_normal((B, E))
    ref64 = _port_grads(jparams, x, ct, config, torch.float64)
    params32 = _port_grads(jparams, x, ct, config, torch.float32)
    for k, p in params.items():
        w = want[k].numpy()
        if k.startswith("resnet.") and not trainable:
            # stop_gradient in JAX: exact zeros; the port keeps the
            # frozen backbone out of autograd entirely
            assert not p.requires_grad and p.grad is None
            assert not params32[k].requires_grad
            assert not w.any(), k
            continue
        assert p.requires_grad, k
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        r = ref64[k].grad.numpy()
        err32 = float(np.abs(params32[k].grad.double().numpy() - r).max())
        # the head bias's gradient is zero (train-mode BatchNorm removes
        # the batch mean): rounding only
        scale = float(np.abs(r).max()) if k != "linear.bias" else 1.0
        assert err32 <= 1e-4 * scale, k


def test_frozen_backbone_still_moves_its_statistics_in_train_mode(jparams):
    config = Config(**KW)
    enc = encoder_from_jax(_np(jparams), config)
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    tenc.encode(enc, torch.from_numpy(_images(5)), config, train=True)
    after = enc.state_dict()
    for k, v in before.items():
        changed = not torch.equal(v, after[k])
        assert changed == k.endswith(("running_mean", "running_var")), k
    # eval mode reads the statistics and moves nothing
    frozen = {k: v.clone() for k, v in after.items()}
    tenc.encode(enc, torch.from_numpy(_images(6)), config, train=False)
    assert all(torch.equal(v, enc.state_dict()[k]) for k, v in frozen.items())


def test_torchvision_names_and_buffers():
    config = Config(**KW)
    enc = tenc.Encoder(config)
    sd = enc.state_dict()
    for key in ("resnet.conv1.weight", "resnet.bn1.running_var",
                "resnet.layer1.0.conv1.weight", "resnet.layer1.1.bn2.bias",
                "resnet.layer2.0.downsample.0.weight",
                "resnet.layer2.0.downsample.1.num_batches_tracked",
                "resnet.layer4.1.conv2.weight", "linear.weight",
                "linear.bias", "bn.running_mean"):
        assert key in sd, key
    assert "resnet.layer1.0.downsample.0.weight" not in sd
    names = dict(enc.named_parameters())
    assert not any("running" in k or "num_batches" in k for k in names)
    assert enc.bn.momentum == tenc.HEAD_BN_MOMENTUM == jenc.HEAD_BN_MOMENTUM
    assert enc.resnet.bn1.momentum == tres.BN_MOMENTUM == jres.BN_MOMENTUM
    assert enc.resnet.bn1.eps == enc.bn.eps == 1e-5


def test_init_follows_the_jax_distributions():
    """Kaiming-normal fan-out convolutions, N(0, 1)/sqrt(512) projection,
    BatchNorm ones and zeros, running mean 0 and variance 1."""
    config = Config(**KW)
    enc = tenc.init_encoder_params(torch.Generator().manual_seed(0),
                                   tenc.Encoder(config))
    w = enc.resnet.layer3[0].conv1.weight.detach()
    np.testing.assert_allclose(float(w.std()), (2.0 / (256 * 9)) ** 0.5,
                               rtol=0.02)
    np.testing.assert_allclose(float(enc.linear.weight.detach().std()),
                               512 ** -0.5, rtol=0.05)
    assert not enc.linear.bias.any()
    for name, buf in enc.named_buffers():
        if name.endswith("running_mean"):
            assert not buf.any()
        elif name.endswith("running_var"):
            assert torch.equal(buf, torch.ones_like(buf))
    again = tenc.init_encoder_params(torch.Generator().manual_seed(0),
                                     tenc.Encoder(config))
    assert all(torch.equal(a, b) for a, b in zip(enc.parameters(),
                                                 again.parameters()))


def test_vit_encoder_is_built():
    """``--encoder-arch vit``: the ViT-B/16 backbone under ``vit``, the
    768 → E projection, frozen unless ``--trainable-backbone 1`` (its
    features are held against the JAX package in
    test_torch_port_vit.py)."""
    config = Config(**{**KW, "image_size": 32}, encoder_arch="vit")
    enc = tenc.init_encoder_params(torch.Generator().manual_seed(0),
                                   tenc.Encoder(config))
    assert enc.backbone is enc.vit and not hasattr(enc, "resnet")
    assert enc.linear.weight.shape == (config.gen_embed_dim, 768)
    assert enc.vit.pos.shape == (5, 768)
    assert not any(p.requires_grad for p in enc.vit.parameters())
    assert tenc.grid_shape(config) == (4, 768)
    trainable = tenc.Encoder(config.replace(trainable_backbone=1))
    assert all(p.requires_grad for p in trainable.vit.parameters())
