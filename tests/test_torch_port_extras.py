"""The data and model extras of the port against the JAX package on the
CPU, float32:

* image augmentation (``ops/augment.py``, ``--random-flip`` /
  ``--random-crop-pad``): the JAX ``augment_images``' coins and offsets,
  drawn by JAX and fed, give the same images (float and uint8: exact);
  a conditional MLE step on ``images_u8`` with both flags matches the JAX
  step (``tests/test_augment.py``'s step, with the step's draws fed;
  ``tests/test_torch_port_cond_steps.py``'s tolerances), and the
  adversarial step's augmented batch the JAX one's;
* the BiLSTM discriminator (``models/discriminator_bilstm.py``): logits
  of ids and soft input, in eval and train mode (the JAX dropout mask
  fed), and the gradients of parameters and input, against
  ``tests/test_discriminator_bilstm.py``'s model; its backward runs the
  reverse BPTT wrapper once a layer a direction; an adversarial step
  against the JAX step (``tests/test_torch_port_steps.py``'s
  tolerances);
* cached backbone features (``--cache-features``,
  ``data/feature_cache.py``): the precomputed features against the JAX
  ``precompute_backbone_features`` on the same encoder, and the cached
  run of ``tests/test_instructor.py:98``;
* ``--encoder-init natural``: the init sweep skips the whole encoder, as
  the JAX ``init_generator_params`` does, and eval-mode features then
  differ between distinct images (under the sweep they all but vanish);
* rematerialization: ``tf_remat`` (``tests/test_transformer.py:179``,
  ``tests/test_flash_attention.py:132``), ``disc_remat`` and
  ``scan_remat`` give the gradients of the plain passes (bit-equal: the
  recompute runs the same operations on the same inputs), and the
  transformer's match the JAX package's under ``GIC_TF_REMAT=1``.

Tolerances: values atol = rtol = 1e-5; gradients atol 1e-5, rtol 1e-4;
step metrics rtol 1e-5, atol 1e-7, parameters atol 1e-5, rtol 1e-4."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_cond_steps as cs
from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.feature_cache import (
    precompute_backbone_features as jprecompute)
from gan_image_captioning_tpu.data.loader import make_batch as jmake_batch
from gan_image_captioning_tpu.data.synthetic import (
    SyntheticCaptions as JSynthetic)
from gan_image_captioning_tpu.models import api as japi
from gan_image_captioning_tpu.models import encoder as jenc
from gan_image_captioning_tpu.models import generator as jgen
from gan_image_captioning_tpu.models import transformer as jtf
from gan_image_captioning_tpu.ops.augment import augment_images as jaugment
from gan_image_captioning_tpu.ops.losses import (
    cross_entropy_loss as jcross_entropy)
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu.train.state import (
    create_train_state as jcreate_train_state)
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.feature_cache import (
    CachedFeatureDataset, precompute_backbone_features)
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.data.synthetic import SyntheticCaptions
from gan_image_captioning_tpu_torch.models import api as tapi
from gan_image_captioning_tpu_torch.models import discriminator as tdisc
from gan_image_captioning_tpu_torch.models import encoder as tenc
from gan_image_captioning_tpu_torch.models import generator as tgen
from gan_image_captioning_tpu_torch.models import lstm as tlstm
from gan_image_captioning_tpu_torch.models import transformer as ttf
from gan_image_captioning_tpu_torch.ops.augment import augment_images
from gan_image_captioning_tpu_torch.ops.losses import cross_entropy_loss
from gan_image_captioning_tpu_torch.train import steps as tsteps
from gan_image_captioning_tpu_torch.train.instructor import GANInstructor
from gan_image_captioning_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

VAL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def no_state_shardings():
    """No process-wide JAX state shardings around a JAX step: the ZeRO-1
    instructor test (``tests/test_parallel.py``) leaves them set on its
    worker."""
    prev = jsteps._STATE_SHARDINGS
    jsteps.set_state_shardings(None)
    yield
    jsteps.set_state_shardings(prev)


# ---------------------------------------------------------- augmentation

def _jax_draws(key, b, flip, pad):
    """The coins and offsets ``augment_images(images, key, ...)`` draws."""
    k_flip, k_h, k_w = jax.random.split(key, 3)
    out = {}
    if flip:
        out["coin"] = torch.from_numpy(np.array(
            jax.random.bernoulli(k_flip, 0.5, (b,))))
    if pad:
        out["oy"] = torch.from_numpy(np.array(
            jax.random.randint(k_h, (b,), 0, 2 * pad + 1)))
        out["ox"] = torch.from_numpy(np.array(
            jax.random.randint(k_w, (b,), 0, 2 * pad + 1)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("flip,pad", [(1, 0), (0, 2), (1, 1)])
def test_augment_images_matches_jax(dtype, flip, pad):
    rng = np.random.default_rng(flip + 3 * pad)
    imgs = (rng.integers(0, 256, (8, 3, 7, 6)).astype(np.uint8)
            if dtype == "uint8" else
            rng.standard_normal((8, 3, 7, 6)).astype(np.float32))
    key = jax.random.PRNGKey(5 + pad)
    want = np.asarray(jaugment(jnp.asarray(imgs), key, flip=bool(flip),
                               crop_pad=pad))
    d = _jax_draws(key, 8, flip, pad)
    got = augment_images(torch.from_numpy(imgs), bool(flip), pad,
                         d.get("coin"), d.get("oy"), d.get("ox"))
    assert got.dtype == torch.from_numpy(imgs).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if flip:   # the coins vary, and the draw moved some images
        assert 0 < int(d["coin"].sum()) < 8
    assert not np.array_equal(got.numpy(), imgs)


def test_augmentation_draws_only_when_on():
    """Eval steps, unconditional batches, cached features and both flags
    off take the batch as it is and draw nothing; a train step draws its
    coins and offsets from a generator seeded from ``state.generator``."""
    config = Config(vocab_size=40, conditional_gan=1, image_size=8,
                    random_flip=1, random_crop_pad=1, gen_embed_dim=8,
                    gen_hidden_dim=8, disc_embed_dim=8, disc_num_rep=4,
                    disc_filter_sizes=(2,), disc_num_filters=(4,),
                    max_seq_len=4)
    state = create_train_state(config, 0)
    batch = {"images": torch.randn(4, 3, 8, 8),
             "captions": torch.zeros(4, 6, dtype=torch.int32)}
    before = state.generator.get_state()
    for cfg, b, train in ((config, batch, False),
                          (config.replace(random_flip=0, random_crop_pad=0),
                           batch, True),
                          (config, {"backbone_feats": torch.zeros(4, 512)},
                           True)):
        assert tsteps.augment_batch(cfg, state, b, train) is b
    assert torch.equal(state.generator.get_state(), before)
    out = tsteps.augment_batch(config, state, batch, True)
    assert out["images"].shape == batch["images"].shape
    assert not torch.equal(state.generator.get_state(), before)


def test_conditional_steps_with_augmentation_match_jax(no_state_shardings):
    """``tests/test_augment.py``'s conditional step on ``images_u8``: the
    MLE step (teacher objective) with ``--random-flip 1
    --random-crop-pad 2``, the JAX step's augmentation draws
    (``split(rng_step)[0]``) fed to the port; then the adversarial step's
    augmented batch (its draws ``fold_in(rng_feat, 7)``) against the JAX
    ``_augment_batch`` of the same key, bit for bit (the rest of that
    step is the one ``tests/test_torch_port_cond_steps.py`` holds)."""
    aug = dict(random_flip=1, random_crop_pad=2, mle_objective="teacher")
    jconfig, config, jstate, state, jbatch, batch = cs._start("images_u8",
                                                             **aug)
    _, rng_step = jax.random.split(jstate.rng)
    key = jax.random.split(rng_step)[0]
    noise = {"augment": _jax_draws(key, cs.B, 1, 2)}
    jstate, jm = jsteps.make_mle_step(jconfig)(jstate, jbatch)
    state, m = tsteps.make_mle_step(config)(state, batch, noise=noise)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   **cs.METRIC)
    cs._assert_same_state(state, jstate, "mle")

    _, rng_step = jax.random.split(jstate.rng)
    key = jax.random.fold_in(jax.random.split(rng_step, 6)[0], 7)
    want = jsteps._augment_batch(jconfig, jbatch, key, True)["images_u8"]
    got = tsteps.augment_batch(config, state, batch, True,
                               {"augment": _jax_draws(key, cs.B, 1, 2)})
    np.testing.assert_array_equal(got["images_u8"].numpy(), np.asarray(want))


# ------------------------------------------------ BiLSTM discriminator

BI_KW = dict(vocab_size=37, max_seq_len=8, disc_embed_dim=6,
             disc_hidden_dim=5, disc_num_layers=2, disc_arch="bilstm",
             gen_embed_dim=8, gen_hidden_dim=8, disc_init="normal")


def _bilstm():
    jconfig = JConfig(**BI_KW)
    jparams = japi.init_discriminator(jax.random.PRNGKey(2), jconfig)
    disc = interop.bilstm_discriminator_from_jax(_np(jparams),
                                                 Config(**BI_KW))
    return jconfig, Config(**BI_KW), jparams, disc


def test_bilstm_discriminator_matches_jax():
    jconfig, config, jparams, disc = _bilstm()
    B, L, V = 3, config.seq_len, config.vocab_size
    ids = np.random.default_rng(0).integers(0, V, (B, L))
    soft = np.asarray(jax.nn.softmax(jax.random.normal(
        jax.random.PRNGKey(3), (B, L, V)) * 2.0))
    probe = np.random.default_rng(1).standard_normal(B).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    keep = torch.from_numpy(np.array(jax.random.bernoulli(
        rng, 0.8, tapi.disc_keep_shape(config, B))))
    p = dict(disc.named_parameters())
    # int ids in eval mode, soft input in train mode (the gradients below)
    for inp, train in ((ids, False), (soft, True)):
        want = japi.discriminator_apply(jparams, jnp.asarray(inp), jconfig,
                                        rng, train)
        got = tapi.discriminator_apply(p, torch.from_numpy(inp), config,
                                       train, keep if train else None)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **VAL)

    def jloss(params, x):
        return jnp.sum(japi.discriminator_apply(params, x, jconfig, rng,
                                                True) * probe)

    g_params, g_soft = jax.grad(jloss, argnums=(0, 1))(jparams,
                                                      jnp.asarray(soft))
    x = torch.from_numpy(soft).requires_grad_(True)
    (tapi.discriminator_apply(p, x, config, True, keep)
     * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_soft), **GRAD)
    want = interop.flatten_jax(_np(g_params))
    for k, v in p.items():
        np.testing.assert_allclose(v.grad.numpy(), want[k].numpy(),
                                   err_msg=k, **GRAD)


def test_bilstm_backward_runs_the_reverse_bptt(monkeypatch):
    """Each direction of each layer is one teacher-forced pass whose
    backward calls the reverse BPTT wrapper (the CUDA kernel on the
    card)."""
    _, config, _, disc = _bilstm()
    calls, real = [], tlstm.lstm_bptt_reverse

    def spy(*args):
        calls.append(args[1].shape)
        return real(*args)

    monkeypatch.setattr(tlstm, "lstm_bptt_reverse", spy)
    ids = torch.randint(0, config.vocab_size, (2, config.seq_len))
    tapi.discriminator_apply(dict(disc.named_parameters()), ids,
                             config).sum().backward()
    assert len(calls) == 2 * config.disc_num_layers


def test_adv_step_with_bilstm_matches_jax(no_state_shardings):
    """``--disc-arch bilstm`` in the adversarial step (the JAX fused decode
    and its draws fed, as ``tests/test_torch_port_steps.py`` does)."""
    kw = dict(BI_KW, gen_num_layers=2, gen_hidden_dim=16, disc_lr=1e-3,
              gen_lr=1e-3, max_seq_len=4)
    jconfig = JConfig(**kw, decode_impl="fused")
    config = Config(**kw)
    jstate = jcreate_train_state(jconfig, jax.random.PRNGKey(0))
    state = interop.train_state_from_jax(_np(jstate), config)
    B, V, T = 4, config.vocab_size, config.seq_len
    rng = np.random.default_rng(0)
    caps = [rng.integers(4, V, size=rng.integers(1, 5)) for _ in range(B)]
    jbatch = {k: jnp.asarray(v) for k, v in jmake_batch(caps, None, T).items()}
    batch = tsteps.batch_to(make_batch(caps, None, T), "cpu")
    _, rng_step = jax.random.split(jstate.rng)
    _, r_sample, r1, r2, r3, _ = jax.random.split(rng_step, 6)
    u = np.stack([np.asarray(jax.random.uniform(k, (B, V), jnp.float32))
                  for k in jax.random.split(r_sample, T)])
    noise = {"uniforms": torch.from_numpy(u), "keep": [
        torch.from_numpy(np.array(jax.random.bernoulli(
            k, 0.8, tapi.disc_keep_shape(config, B)))) for k in (r1, r2, r3)]}
    jstate, jm = jsteps.make_adv_step(jconfig)(jstate, jbatch, 2.0)
    state, m = tsteps.make_adv_step(config)(state, batch, 2.0, noise)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   rtol=1e-5, atol=1e-7)
    want = interop.flatten_jax(_np(jstate.disc_params))
    for k, v in state.disc.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k,
                                   atol=1e-5, rtol=1e-4)
    want = interop.params_from_jax(_np(jstate.gen_params))
    for k, v in state.gen.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k,
                                   atol=1e-5, rtol=1e-4)


# ------------------------------------------------------ cached features

CACHE_KW = dict(gen_embed_dim=12, gen_hidden_dim=16, max_seq_len=9,
                disc_embed_dim=8, disc_num_rep=4, disc_filter_sizes=(2, 3),
                disc_num_filters=(6, 6), pre_train_batch_size=8,
                pre_eval_batch_size=8, adv_train_batch_size=8,
                adv_eval_batch_size=8, pretrain_epochs=1, adv_epochs=1,
                num_workers=1, conditional_gan=1, image_size=32)


def test_precomputed_features_match_jax():
    """The frozen backbone's eval-mode features, once per image, against
    the JAX ``precompute_backbone_features`` on the same encoder."""
    jds = JSynthetic("train", num_items=5, image_size=32, conditional=True)
    ds = SyntheticCaptions("train", num_items=5, image_size=32,
                           conditional=True)
    jconfig = JConfig(vocab_size=jds.vocab_size, **CACHE_KW)
    jparams = jgen.init_generator_params(jax.random.PRNGKey(1), jconfig)
    want = jprecompute(jds, jparams["encoder"], jconfig, batch_size=4)
    encoder = interop.encoder_from_jax(_np(jparams["encoder"]),
                                       Config(vocab_size=ds.vocab_size,
                                              **CACHE_KW))
    got = precompute_backbone_features(ds, encoder, batch_size=4)
    assert got.shape == want.shape == (5, 512)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_cached_features_run(tmp_path):
    """``tests/test_instructor.py:98``: ``--cache-features`` runs the
    frozen backbone once per image; training then feeds ``[B, 512]``
    feature batches through the trainable head only."""
    train = SyntheticCaptions("train", num_items=16, image_size=32,
                              conditional=True)
    val = SyntheticCaptions("val", num_items=8, image_size=32,
                            conditional=True)
    save = os.path.join(str(tmp_path), "save")
    cfg = Config(vocab_size=train.vocab_size, cache_features=1, device="cpu",
                 save_dir=save, model_dir=os.path.join(save, "models"),
                 log_file=os.path.join(save, "log"), **CACHE_KW)
    inst = GANInstructor(cfg, train, val)
    assert isinstance(inst.train_dataset, CachedFeatureDataset)
    assert inst.train_dataset.features.shape == (16, 512)
    batch = next(iter(inst.pre_train_loader))
    assert "backbone_feats" in batch and "images" not in batch
    before = {k: v.clone() for k, v in
              tenc.bn_stats(inst.state.gen.encoder).items()
              if k.startswith("resnet.")}
    inst._run()
    assert os.path.isdir(os.path.join(cfg.model_dir, "adv_model.ckpt")) or \
        os.path.exists(os.path.join(cfg.model_dir, "adv_model.ckpt"))
    after = tenc.bn_stats(inst.state.gen.encoder)
    assert all(torch.equal(v, after[k]) for k, v in before.items())


# -------------------------------------------------- --encoder-init natural

def test_encoder_init_natural_skips_the_encoder():
    """Under ``natural`` the sweep leaves every encoder parameter at its
    own initialization and sweeps the decoder as before; the JAX
    ``init_generator_params`` skips the same parameters."""
    kw = dict(vocab_size=30, gen_embed_dim=8, gen_hidden_dim=8,
              conditional_gan=1, image_size=32)
    seeded = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    nat = tgen.init_generator_params(seeded(), Config(**kw,
                                                      encoder_init="natural"))
    swept = tgen.init_generator_params(seeded(), Config(**kw))
    raw = tgen.init_generator_params(seeded(), Config(**kw), sweep=False)
    for k, v in nat.state_dict().items():
        want = (raw if k.startswith("encoder.") else swept).state_dict()[k]
        assert torch.equal(v, want), k
    assert float(swept.encoder.resnet.conv1.weight.abs().max()) <= 0.05
    # the JAX package skips the same leaves: its natural encoder is the
    # encoder's own initialization, drawn from the second key
    j_nat = jgen.init_generator_params(jax.random.PRNGKey(0),
                                       JConfig(**kw, encoder_init="natural"))
    k_enc = jax.random.split(jax.random.PRNGKey(0), 3)[1]
    j_raw = jenc.init_encoder_params(k_enc, JConfig(**kw))
    for a, b in zip(jax.tree_util.tree_leaves(j_nat["encoder"]),
                    jax.tree_util.tree_leaves(j_raw)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_natural_encoder_features_differ_between_images():
    """Eval-mode features of distinct images: under the sweep they all but
    coincide (the sweep's scales numerically kill the backbone), under
    ``natural`` they part."""
    kw = dict(vocab_size=30, gen_embed_dim=8, gen_hidden_dim=8,
              conditional_gan=1, image_size=32)
    images = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 3, 32, 32)).astype(np.float32))
    spread = {}
    for init in ("sweep", "natural"):
        config = Config(**kw, encoder_init=init)
        gen = tgen.init_generator_params(torch.Generator().manual_seed(4),
                                         config)
        with torch.no_grad():
            feats = tenc.encode(gen.encoder, images, config, train=False)
        spread[init] = float(feats.std(dim=0).mean())
    assert spread["natural"] > 1e-2
    assert spread["natural"] > 1e3 * spread["sweep"]


# ----------------------------------------------------- rematerialization

def _grads_of(loss_fn, params):
    for p in params.values():
        p.grad = None
    loss = loss_fn()
    loss.backward()
    return float(loss), {k: p.grad.clone() for k, p in params.items()
                         if p.grad is not None}


def test_tf_remat_grads_identical_and_match_jax(monkeypatch):
    """``tests/test_transformer.py:179``: the MLE loss and generator
    gradients with ``tf_remat`` equal the plain ones (bit-equal here) and
    the JAX package's under ``GIC_TF_REMAT=1``."""
    kw = dict(vocab_size=40, gen_embed_dim=16, gen_hidden_dim=32,
              gen_arch="transformer", gen_num_layers=2, gen_num_heads=2,
              max_seq_len=8)
    jconfig = JConfig(**kw)
    jparams = japi.init_generator(jax.random.PRNGKey(2), jconfig)
    caps = jax.random.randint(jax.random.PRNGKey(3), (4, jconfig.seq_len),
                              0, 40)
    jbatch = {"captions": caps, "weights": jnp.ones((4,), jnp.float32)}

    def jloss(p):
        cond, _ = japi.generator_condition(jconfig, p, jbatch, train=False)
        logits = japi.generator_mle_outputs(p, cond, caps,
                                            jax.random.PRNGKey(0), jconfig)
        return jcross_entropy(logits, caps, None)

    monkeypatch.setenv("GIC_TF_REMAT", "1")
    jl, jg = jax.value_and_grad(jloss)(jparams)
    gen = interop.transformer_generator_from_jax(_np(jparams), Config(**kw))
    params = dict(gen.named_parameters())
    tcaps = torch.from_numpy(np.asarray(caps))
    out = []
    for remat in (False, True):
        config = Config(**kw, tf_remat=remat)

        def loss():
            cond, _ = tapi.generator_condition(config, gen,
                                               {"captions": tcaps})
            logits = tapi.generator_mle_outputs(gen, cond, tcaps, config)
            return cross_entropy_loss(logits, tcaps)

        out.append(_grads_of(loss, params))
    (l0, g0), (l1, g1) = out
    assert l0 == l1 and g0.keys() == g1.keys()
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    np.testing.assert_allclose(l1, float(jl), rtol=1e-6)
    want = interop.flatten_jax(_np({"decoder": jg["decoder"]}))
    for k, g in g1.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k,
                                   rtol=1e-4, atol=1e-6)


def test_flash_under_remat_matches_jax(monkeypatch):
    """``tests/test_flash_attention.py:132``: one block under ``remat``
    with the flash route (its plain version on the CPU; the recompute
    re-runs the flash forward) against the dense block without it, and
    the JAX package's flash block under ``GIC_TF_REMAT=1``."""
    d_model, heads, t = 32, 2, 64
    blk = jtf.init_block(jax.random.PRNGKey(0), d_model, d_model,
                         jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, t, d_model))
    monkeypatch.setenv("GIC_FLASH_ATTN", "1")
    monkeypatch.setenv("GIC_KERNEL_INTERPRET", "1")
    monkeypatch.setenv("GIC_TF_REMAT", "1")
    want = jax.grad(lambda x: jnp.sum(jtf.remat_block_apply(
        blk, x, heads, jtf.causal_mask(t), flash_causal=True) ** 2))(x)
    p = {f"b.{k}": v for k, v in interop.flatten_jax(_np(blk)).items()}
    mask = ttf.causal_mask(t)
    grads = []
    for remat, impl in ((False, "plain"), (True, "kernel")):
        xt = torch.from_numpy(np.asarray(x)).requires_grad_(True)
        (ttf.remat_block_apply(p, "b", xt, heads, mask, flash_causal=True,
                               attn_impl=impl, remat=remat) ** 2
         ).sum().backward()
        grads.append(xt.grad)
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(want), **GRAD)


def test_disc_and_scan_remat_grads_identical():
    """``disc_remat`` (the CNN's conv trunk, and under ``tf_remat`` the
    transformer discriminator's blocks) and ``scan_remat`` (the scheduled
    sample's steps) give the plain passes' losses and gradients,
    bit-equal."""
    kw = dict(vocab_size=30, gen_embed_dim=8, gen_hidden_dim=8,
              gen_num_layers=2, max_seq_len=6, disc_embed_dim=8,
              disc_num_rep=4, disc_filter_sizes=(2, 3),
              disc_num_filters=(5, 6), disc_init="normal",
              disc_hidden_dim=16, disc_num_heads=2, disc_num_layers=2)
    rng = np.random.default_rng(0)
    soft = torch.softmax(torch.from_numpy(rng.standard_normal(
        (3, 8, 30)).astype(np.float32)) * 3, -1)
    caps = torch.from_numpy(rng.integers(4, 30, (3, 8)))
    coins = torch.from_numpy(rng.random((8, 3)) < 0.5)
    for arch, field in (("cnn", "disc_remat"), ("transformer", "tf_remat")):
        disc = tapi.init_discriminator(torch.Generator().manual_seed(1),
                                       Config(**kw, disc_arch=arch))
        params = dict(disc.named_parameters())
        out = [_grads_of(lambda: tapi.discriminator_apply(
            params, soft, Config(**kw, disc_arch=arch, **{field: r})).sum(),
            params) for r in (False, True)]
        assert out[0][0] == out[1][0], arch
        assert all(torch.equal(out[0][1][k], out[1][1][k])
                   for k in out[0][1]), arch
    gen = tgen.init_generator_params(torch.Generator().manual_seed(2),
                                     Config(**kw))
    params = dict(gen.named_parameters())
    feats = torch.randn(3, 8)
    out = [_grads_of(lambda: tgen.scheduled_sample(
        gen.decoder, feats, caps, coins=coins, remat=r).sum(), params)
        for r in (False, True)]
    assert out[0][0] == out[1][0]
    assert out[0][1].keys() == out[1][1].keys()
    assert all(torch.equal(out[0][1][k], out[1][1][k]) for k in out[0][1])


def test_remat_recompute_counts_the_conv_forward_twice(monkeypatch):
    """Under ``disc_remat`` the backward re-runs the conv forward (its
    wrapper is called again, inside the checkpoint)."""
    kw = dict(vocab_size=30, max_seq_len=6, disc_embed_dim=8,
              disc_num_rep=4, disc_filter_sizes=(2, 3),
              disc_num_filters=(5, 6))
    calls, real = [], tdisc.conv_pooled

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(tdisc, "conv_pooled", spy)
    disc = tapi.init_discriminator(torch.Generator().manual_seed(1),
                                   Config(**kw))
    params = dict(disc.named_parameters())
    ids = torch.randint(0, 30, (2, 8))
    for remat, want in ((False, 1), (True, 2)):
        calls.clear()
        tapi.discriminator_apply(params, ids, Config(**kw, disc_remat=remat)
                                 ).sum().backward()
        assert len(calls) == want, remat
