"""The port's ViT-B/16 encoder (``models/vit.py``, the ViT branch of
``models/encoder.py``) against the JAX package on the CPU, at 32 × 32
images (4 patches and the CLS token; the width is ViT-B's, fixed by the
module), B = 4, the JAX parameters built once per module: ``_patchify``,
``vit`` and ``vit_grid`` in float32 and bfloat16, ``encode`` and
``encode_with_grid`` (train and eval mode), and the decision the port
makes on purpose about a frozen ViT (``--trainable-backbone 0``).

The JAX package's ``encode_grid`` stops the ResNet grid's gradient but not
the ViT grid's, so its conditional transformer differentiates into a
frozen ViT and its optimizer updates it.  The port keeps the flag's
contract: its frozen ViT gets no gradient and stays out of the optimizer.
So under ``0`` every gradient but the backbone's is held against the JAX
step's (the backbone's are nonzero there, absent here), and under ``1``
every gradient, the ViT's included; both from one JAX gradient, which is
the same function under either flag.

``vit`` and ``vit_grid`` in float32 run all twelve blocks; the other
tests run two of them at ViT-B's width (each block computes and rounds
alike).

Tolerance: float32 features atol 2e-5 / rtol 1e-4 (twelve blocks of
768-wide float32 sums in another order); gradients atol 1e-5 / rtol 1e-4
(the ViT's atol 2e-5); bfloat16 in bfloat16 units of the largest entry
(``tests/torch_bf16_parity.py``: 4 for the features, which pass blocks
that the two frameworks round at other places)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.loader import make_batch as jmake_batch
from gan_image_captioning_tpu.models import api as japi
from gan_image_captioning_tpu.models import encoder as jenc
from gan_image_captioning_tpu.models import vit as jvit
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.models import encoder as tenc
from gan_image_captioning_tpu_torch.models import vit as tvit
from gan_image_captioning_tpu_torch.train import steps as tsteps
from gan_image_captioning_tpu_torch.train.state import create_train_state
from torch_bf16_parity import f32, miss

B, S, V = 4, 32, 48
FEAT = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=1e-5, rtol=1e-4)
KW = dict(vocab_size=V, gen_arch="transformer", gen_embed_dim=64,
          gen_hidden_dim=128, gen_num_layers=2, gen_num_heads=4,
          max_seq_len=5, disc_embed_dim=8, disc_num_rep=4,
          disc_filter_sizes=(2, 3), disc_num_filters=(5, 6),
          conditional_gan=1, image_size=S, encoder_arch="vit",
          gen_lr=1e-3, disc_lr=1e-3)


@pytest.fixture(autouse=True)
def no_state_shardings():
    prev = jsteps._STATE_SHARDINGS
    jsteps.set_state_shardings(None)
    yield
    jsteps.set_state_shardings(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 3, S, S)) * rng.uniform(0.5, 2, (B, 1, 1, 1))
            + rng.uniform(-1, 1, (B, 3, 1, 1))).astype(np.float32)


@pytest.fixture(scope="module")
def encoder():
    """(JAX encoder tree, port encoder, config) of a ViT encoder."""
    jconfig = JConfig(**KW)
    tree = jax.jit(lambda k: jenc.init_encoder_params(k, jconfig))(
        jax.random.PRNGKey(0))
    config = Config(**KW)
    return tree, interop.encoder_from_jax(_np(tree), config), config


SHORT_DEPTH = 2     # of the ViT's twelve blocks, where depth is not the point


@pytest.fixture
def short_encoder(encoder, monkeypatch):
    """:func:`encoder` cut to its first SHORT_DEPTH blocks (the JAX trunk
    runs the blocks its tree holds; the port's is built that deep)."""
    tree, _, config = encoder
    tree = {**tree, "backbone": {**tree["backbone"], "blocks":
                                 tree["backbone"]["blocks"][:SHORT_DEPTH]}}
    monkeypatch.setattr(tvit, "DEPTH", SHORT_DEPTH)
    return tree, interop.encoder_from_jax(_np(tree), config), config


def test_patchify_is_the_jax_order():
    x = np.arange(2 * 3 * 32 * 48, dtype=np.float32).reshape(2, 3, 32, 48)
    np.testing.assert_array_equal(tvit._patchify(torch.from_numpy(x)).numpy(),
                                  np.asarray(jvit._patchify(jnp.asarray(x))))


def test_vit_and_grid_match_jax(encoder):
    tree, enc, _ = encoder
    images = _images()
    cls_j, _ = jax.jit(jvit.vit)(tree["backbone"], {}, jnp.asarray(images))
    grid_j, _ = jax.jit(jvit.vit_grid)(tree["backbone"], {},
                                        jnp.asarray(images))
    x = torch.from_numpy(images)
    with torch.no_grad():
        np.testing.assert_allclose(tvit.vit(enc.vit, x).numpy(),
                                   np.asarray(cls_j), **FEAT)
        np.testing.assert_allclose(tvit.vit_grid(enc.vit, x).numpy(),
                                   np.asarray(grid_j), **FEAT)


def test_vit_rounds_in_bfloat16_as_jax(short_encoder):
    """bfloat16 weights and images: the grid within 4 bfloat16 units of
    the JAX package's largest feature, or at least as close to the
    float32 grid as the JAX package's is (``torch_bf16_parity.miss``:
    XLA on the CPU rounds a fused chain once where PyTorch rounds each
    operation, and blocks compound it); and not the float32 grid.  Every
    block rounds alike, so two of them are held here."""
    tree, enc, _ = short_encoder
    images = _images(1)
    bf = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                tree["backbone"])
    want = f32(jax.jit(jvit.vit_grid)(bf, {}, jnp.asarray(
        images, jnp.bfloat16))[0])
    p = {k: v.to(torch.bfloat16) for k, v in enc.vit.state_dict().items()}
    x = torch.from_numpy(np.array(f32(jnp.asarray(images, jnp.bfloat16)))
                         ).to(torch.bfloat16)
    with torch.no_grad():
        got = f32(tvit.vit_grid(p, x))
        ref = f32(tvit.vit_grid(enc.vit, torch.from_numpy(images)))
    assert miss(got, want, 4, "vit_grid bfloat16", ref=ref) is None
    assert miss(got, ref, 1, "vit_grid against float32") is not None


@pytest.mark.parametrize("train", [True])
def test_encode_and_encode_with_grid_match_jax(short_encoder, train):
    """The CLS features (``encode``) and, from one pass, the patch grid
    with the features of its mean (``encode_with_grid``: not the CLS
    row); in train mode the head BatchNorm's statistics move alike (two
    of the ViT's blocks: the twelve are held above)."""
    tree, enc, config = short_encoder
    jconfig = JConfig(**KW)
    images = _images(2)
    jf, _ = jax.jit(lambda t, x: jenc.encode(t, x, jconfig, train))(
        tree, jnp.asarray(images))
    jfg, jg, jstats = jax.jit(lambda t, x: jenc.encode_with_grid(
        t, x, jconfig, train))(tree, jnp.asarray(images))
    x = torch.from_numpy(images)
    fresh = interop.encoder_from_jax(_np(tree), config)
    with torch.no_grad():
        f = tenc.encode(fresh, x, config, train)
        fresh = interop.encoder_from_jax(_np(tree), config)
        fg, g = tenc.encode_with_grid(fresh, x, config, train)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **FEAT)
    np.testing.assert_allclose(fg.numpy(), np.asarray(jfg), **FEAT)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **FEAT)
    np.testing.assert_allclose(fresh.bn.running_mean.numpy(),
                               np.asarray(jstats["head"]["mean"]), **FEAT)
    assert not torch.allclose(f, fg)


# ------------------------------------------------ the frozen ViT (decision)

D1_DEPTH = 2        # of the ViT's twelve blocks, for the decision's tests


@pytest.fixture(scope="module")
def jax_grads():
    """The JAX MLE loss and gradients of a conditional transformer on the
    ViT grid (the same under either ``--trainable-backbone``: the JAX
    package differentiates into the ViT in both); two of the ViT's blocks
    at its width, as the decision is the same for every block."""
    jconfig = JConfig(**KW, decode_impl="fused")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jvit, "DEPTH", D1_DEPTH)
        gp = jax.jit(lambda k: japi.init_generator(k, jconfig))(
            jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    T = KW["max_seq_len"] + 2
    caps = [rng.integers(4, V, size=rng.integers(1, 6)) for _ in range(B)]
    imgs = list(_images(3))
    jbatch = {k: jnp.asarray(v) for k, v in
              jmake_batch(caps, imgs, T).items()}
    key = jax.random.PRNGKey(5)
    loss, g = jax.jit(jax.value_and_grad(lambda gp: jsteps.mle_loss(
        jconfig, gp, jbatch, key, True)[0]))(gp)
    batch = tsteps.batch_to(make_batch(caps, imgs, T), "cpu")
    return _np(gp), batch, float(loss), interop._transformer_gen_params(
        _np(g))


def _state(gp, config):
    """The port's state around the JAX generator's weights."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tvit, "DEPTH", D1_DEPTH)
        gen = interop.transformer_generator_from_jax(gp, config)
        return create_train_state(config, 0, gen=gen)


@pytest.mark.parametrize("trainable", [0, 1])
def test_mle_gradients_follow_the_trainable_backbone_flag(jax_grads,
                                                          trainable):
    gp, batch, jloss, want = jax_grads
    config = Config(**KW, trainable_backbone=trainable)
    state = _state(gp, config)
    loss, grads = tsteps.mle_grads(config, state, batch)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5, atol=1e-6)
    backbone = {k for k in want if k.startswith("encoder.vit.")}
    assert backbone and any(want[k].abs().max() > 0 for k in backbone)
    if trainable:
        assert backbone <= set(grads)
    else:
        assert not backbone & set(grads)
        assert not any(k.startswith("encoder.vit.")
                       for k in state.pretrain_opt.mu)
    for name, gr in grads.items():
        tol = dict(GRAD, atol=2e-5) if name in backbone else GRAD
        np.testing.assert_allclose(gr.numpy(), want[name].numpy(),
                                   err_msg=name, **tol)


def test_frozen_vit_is_unchanged_by_steps(jax_grads):
    """Two MLE steps and an adversarial step under ``--trainable-backbone
    0``: the ViT's weights are bit-unchanged, the head's move."""
    gp, batch, _, _ = jax_grads
    config = Config(**KW)
    state = _state(gp, config)
    vit0 = {k: v.clone() for k, v in state.gen.encoder.vit.state_dict().items()}
    head0 = state.gen.encoder.linear.weight.clone()
    mle, adv = tsteps.make_mle_step(config), tsteps.make_adv_step(config)
    for _ in range(2):
        state, _ = mle(state, batch)
    state, m = adv(state, batch, 2.0)
    assert np.isfinite(float(m["gen_adv_loss"]))
    for k, v in state.gen.encoder.vit.state_dict().items():
        assert torch.equal(v, vit0[k]), k
    assert not torch.equal(state.gen.encoder.linear.weight, head0)


def test_full_state_checkpoint_round_trips_the_vit(tmp_path, monkeypatch):
    """A conditional transformer on the ViT (two of its blocks here) in a
    full-state checkpoint: saved, loaded into a fresh state from the same
    config, every tensor and moment equal; the generator checkpoint of
    the plain form loads back conditional."""
    from gan_image_captioning_tpu_torch.train import checkpoint as ckpt

    monkeypatch.setattr(tvit, "DEPTH", 2)
    config = Config(**KW)
    state = create_train_state(config, 3)
    path = str(tmp_path / "state.ckpt")
    ckpt.save_state(path, state, sync=True)
    back = ckpt.load_state(path, create_train_state(config, 4))
    for a, b in ((state.gen, back.gen), (state.disc, back.disc)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert any(k.startswith("encoder.vit.blocks.1.") for k in
               back.gen.state_dict())
    assert back.pretrain_opt.mu.keys() == state.pretrain_opt.mu.keys()
    gen_path = str(tmp_path / "gen.ckpt")
    ckpt.save_generator_checkpoint(gen_path, state.gen)
    gen, _ = ckpt.load_generator_checkpoint(gen_path, config)
    assert torch.equal(gen.encoder.vit.pos, state.gen.encoder.vit.pos)
