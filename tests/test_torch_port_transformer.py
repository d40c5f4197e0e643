"""The port's transformer generator and discriminators against the JAX
package's (``models/transformer.py``, ``models/discriminator_transformer.py``)
on the CPU: weights carried over by ``interop``, the same numpy inputs and
fed noise (the Gumbel uniforms of ``jax.random.split(rng, T)``, the dropout
keep masks of ``jax.random.bernoulli``).  Covered: the teacher-forced pass
(with and without lengths, flash and dense routes on both sides) and its
gradients; the KV-cache decode against the parallel pass; the free-running
sample (greedy, and Gumbel with fed uniforms); both discriminators on int
and soft input, in train mode, and their gradients; the greedy decode with
logprobs; checkpoints; serving ``{"n": k}``; and what still raises.

Tolerance: values atol 1e-5 / rtol 1e-5, gradients atol 1e-5 / rtol 1e-4
(float32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.eval import decode as jdecode
from gan_image_captioning_tpu.models import api as japi
from gan_image_captioning_tpu.models import discriminator_transformer as jdt
from gan_image_captioning_tpu.models import transformer as jtf
from gan_image_captioning_tpu_torch import interop, serve
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.eval import decode as tdecode
from gan_image_captioning_tpu_torch.models import api as tapi
from gan_image_captioning_tpu_torch.models import (
    discriminator_transformer as tdt)
from gan_image_captioning_tpu_torch.models import transformer as ttf
from gan_image_captioning_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

V = 40
KW = dict(vocab_size=V, gen_arch="transformer", disc_arch="transformer",
          gen_embed_dim=16, gen_hidden_dim=24, gen_num_layers=2,
          gen_num_heads=2, max_seq_len=5, disc_embed_dim=8,
          disc_hidden_dim=16, disc_num_heads=2, disc_num_layers=2)
VAL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)
B = 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    jconfig, config = JConfig(**KW), Config(**KW)
    gp = japi.init_generator(jax.random.PRNGKey(0), jconfig)
    dp = japi.init_discriminator(jax.random.PRNGKey(1), jconfig)
    gen = interop.transformer_generator_from_jax(_np(gp), config)
    disc = interop.transformer_discriminator_from_jax(_np(dp), config)
    return jconfig, config, gp, dp, gen, disc


def _inputs(config, seed=0):
    rng = np.random.default_rng(seed)
    caps = rng.integers(0, V, (B, config.seq_len)).astype(np.int32)
    lens = np.array([config.seq_len, 3, 0], np.int32)
    feats = rng.standard_normal((B, config.gen_embed_dim)).astype(np.float32)
    return caps, lens, feats


def test_tree_names_and_init_shapes_match_jax(models):
    jconfig, config, gp, dp, gen, disc = models
    assert set(gen.state_dict()) == set(interop.flatten_jax(
        {"decoder": _np(gp)["decoder"]}))
    fresh = tapi.init_generator(torch.Generator().manual_seed(0), config)
    assert {k: v.shape for k, v in fresh.state_dict().items()} == {
        k: v.shape for k, v in gen.state_dict().items()}
    fresh_d = tapi.init_discriminator(torch.Generator().manual_seed(0),
                                      config)
    assert {k: v.shape for k, v in fresh_d.state_dict().items()} == {
        k: v.shape for k, v in disc.state_dict().items()}


@pytest.mark.parametrize("flash", ["0", "1"])
@pytest.mark.parametrize("with_lengths", [True, False])
def test_teacher_forced_and_gradients_match_jax(models, monkeypatch, flash,
                                                with_lengths):
    jconfig, config, gp, _, gen, _ = models
    monkeypatch.setenv("GIC_FLASH_ATTN", flash)
    caps, lens, feats = _inputs(config)
    jl = jnp.asarray(lens) if with_lengths else None
    g = np.random.default_rng(2).standard_normal(
        (B, config.seq_len + 1, V)).astype(np.float32)

    def jloss(dec):
        return jnp.sum(jtf.teacher_forced(dec, jnp.asarray(feats),
                                          jnp.asarray(caps), jconfig,
                                          lengths=jl) * g)

    want = np.asarray(jax.jit(lambda d: jtf.teacher_forced(
        d, jnp.asarray(feats), jnp.asarray(caps), jconfig, lengths=jl))(
        gp["decoder"]))
    jgrads = interop.flatten_jax({"decoder": _np(jax.jit(jax.grad(jloss))(
        gp["decoder"]))})
    cfg = config.replace(attn_impl="kernel" if flash == "1" else "plain")
    got = ttf.teacher_forced(gen.decoder, torch.from_numpy(feats),
                             torch.from_numpy(caps), cfg,
                             lengths=(torch.from_numpy(lens)
                                      if with_lengths else None))
    np.testing.assert_allclose(got.detach().numpy(), want, **VAL)
    params = dict(gen.named_parameters())
    grads = torch.autograd.grad(got, list(params.values()),
                                torch.from_numpy(g), allow_unused=True)
    for (name, p), gr in zip(params.items(), grads):
        gr = torch.zeros_like(p) if gr is None else gr
        np.testing.assert_allclose(gr.numpy(), jgrads[name].numpy(),
                                   err_msg=name, **GRAD)


def test_kv_cache_decode_matches_the_parallel_pass(models):
    """``decode_step`` position by position equals ``teacher_forced`` on
    the same tokens (JAX ``test_kv_cache_decode_matches_parallel``)."""
    _, config, _, _, gen, _ = models
    caps, _, feats = _inputs(config, 3)
    p = ttf.params_of(gen.decoder)
    par = ttf.teacher_forced(p, torch.from_numpy(feats),
                             torch.from_numpy(caps), config)
    k, v = ttf._init_kv_cache(config, B)
    x = torch.from_numpy(feats)
    for t in range(config.seq_len):
        logits, k, v = ttf.decode_step(p, config, x, k, v, t)
        np.testing.assert_allclose(logits.detach().numpy(),
                                   par[:, t].detach().numpy(), **VAL)
        x = p["embed"][torch.from_numpy(caps[:, t]).long()]
    assert k[0].shape == (B, config.seq_len, 2, 8)


def test_greedy_sample_matches_jax(models):
    jconfig, config, gp, _, gen, _ = models
    _, _, feats = _inputs(config, 4)
    out_j, ids_j = jax.jit(lambda d: jtf.sample(
        d, jnp.asarray(feats), jax.random.PRNGKey(0), 1.0, config.seq_len,
        pretrain=True, config=jconfig))(gp["decoder"])
    out, ids = ttf.sample(gen.decoder, torch.from_numpy(feats),
                          config.seq_len, True, config)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **VAL)


@pytest.mark.parametrize("decode_impl", ["kernel", "plain"])
def test_gumbel_sample_with_fed_uniforms_matches_jax(models, decode_impl):
    jconfig, config, gp, _, gen, _ = models
    _, _, feats = _inputs(config, 5)
    rng, temp, T = jax.random.PRNGKey(7), 3.0, config.seq_len
    soft_j, ids_j = jax.jit(lambda d: jtf.sample(
        d, jnp.asarray(feats), rng, temp, T, pretrain=False,
        config=jconfig))(gp["decoder"])
    u = np.stack([np.array(jax.random.uniform(k, (B, V), jnp.float32))
                  for k in jax.random.split(rng, T)])
    cfg = config.replace(decode_impl=decode_impl)
    soft, ids = ttf.sample(gen.decoder, torch.from_numpy(feats), T, False,
                           cfg, temp, uniforms=torch.from_numpy(u))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(soft.detach().numpy(), np.asarray(soft_j),
                               **VAL)
    # and its gradient: the fused sampler's VJP through the cache decode
    g = np.random.default_rng(8).standard_normal(soft.shape).astype(
        np.float32)
    want = interop.flatten_jax({"decoder": _np(jax.jit(jax.grad(
        lambda d: jnp.sum(jtf.sample(d, jnp.asarray(feats), rng, temp, T,
                                     pretrain=False, config=jconfig)[0] * g)))(
        gp["decoder"]))})
    params = dict(gen.named_parameters())
    grads = torch.autograd.grad(soft, list(params.values()),
                                torch.from_numpy(g), allow_unused=True)
    for (name, p), gr in zip(params.items(), grads):
        gr = torch.zeros_like(p) if gr is None else gr
        np.testing.assert_allclose(gr.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD)


@pytest.mark.parametrize("arch", ["transformer", "ar_transformer"])
@pytest.mark.parametrize("soft_input", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_discriminators_match_jax(models, monkeypatch, arch, soft_input,
                                  train):
    jconfig, config, _, dp, _, disc = models
    monkeypatch.setenv("GIC_FLASH_ATTN", "1")
    jconfig, config = (jconfig.replace(disc_arch=arch),
                       config.replace(disc_arch=arch))
    caps, _, _ = _inputs(config, 6)
    rng = np.random.default_rng(9)
    inp = (rng.random((B, config.seq_len, V)).astype(np.float32)
           if soft_input else caps)
    key = jax.random.PRNGKey(11)
    shape = tapi.disc_keep_shape(config, B)
    keep = torch.from_numpy(np.array(jax.random.bernoulli(key, 0.8, shape)))
    g = rng.standard_normal(B * tapi.disc_logits_per_sample(config)).astype(
        np.float32)

    def jout(params):
        return japi.discriminator_apply(params, jnp.asarray(inp), jconfig,
                                        key, train)

    want = np.asarray(jax.jit(jout)(dp))
    jgrads = interop.flatten_jax(_np(jax.jit(jax.grad(
        lambda p: jnp.sum(jout(p) * g)))(dp)))
    params = dict(disc.named_parameters())
    got = tapi.discriminator_apply(params, torch.from_numpy(inp), config,
                                   train, keep)
    np.testing.assert_allclose(got.detach().numpy(), want, **VAL)
    grads = torch.autograd.grad(got, list(params.values()),
                                torch.from_numpy(g))
    for name, gr in zip(params, grads):
        np.testing.assert_allclose(gr.numpy(), jgrads[name].numpy(),
                                   err_msg=name, **GRAD)


def test_masked_pooling_matches_jax(models):
    jconfig, config, _, dp, _, disc = models
    caps, lens, _ = _inputs(config, 12)
    want = np.asarray(jax.jit(lambda p: jdt.apply(
        p, jnp.asarray(caps), jconfig, lengths=jnp.asarray(lens)))(dp))
    got = tdt.apply(dict(disc.named_parameters()), torch.from_numpy(caps),
                    config,
                    lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(got.detach().numpy(), want, **VAL)


def test_greedy_with_logprobs_matches_jax(models):
    jconfig, config, gp, _, gen, _ = models
    _, _, feats = _inputs(config, 13)
    ids_j, lp_j = jdecode.greedy_with_logprobs(gp, jnp.asarray(feats),
                                               jconfig)
    ids, lp = tdecode.greedy_with_logprobs(gen, torch.from_numpy(feats),
                                           config)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), **VAL)
    np.testing.assert_allclose(
        tdecode.sequence_logprob(gen, torch.from_numpy(feats), ids,
                                 config).numpy(), np.asarray(lp_j), **VAL)
    assert torch.equal(tdecode.greedy(gen, torch.from_numpy(feats), config),
                       ids)


def test_checkpoint_round_trip_and_arch_check(models, tmp_path):
    _, config, _, _, gen, disc = models
    plain, adv = str(tmp_path / "pre.ckpt"), str(tmp_path / "adv.ckpt")
    ckpt.save_generator_checkpoint(plain, gen)
    ckpt.save_generator_checkpoint(adv, gen, disc.state_dict())
    for path in (plain, adv):
        loaded, d = ckpt.load_generator_checkpoint(path, config)
        assert isinstance(loaded, ttf.TransformerGenerator)
        for k, v in gen.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v)
        with pytest.raises(ValueError, match="gen-arch"):
            ckpt.load_generator_checkpoint(path, config.replace(
                gen_arch="lstm"))
    assert torch.load(adv, weights_only=True)["gen_arch"] == "transformer"


FLAGS = ["--dataset", "synthetic", "--gen-arch", "transformer",
         "--gen-embed-dim", "16", "--gen-hidden-dim", "24",
         "--gen-num-layers", "2", "--gen-num-heads", "2", "--max-seq-len",
         "5", "--device", "cpu"]


def test_service_answers_from_a_transformer(tmp_path):
    service = serve.CaptionService(serve.parse_args(["--init-seed", "3",
                                                     *FLAGS]))
    try:
        for n in (1, 8):
            resp = service.handle_request({"n": n})
            assert len(resp["captions"]) == n
            feats = torch.from_numpy(service._features_unconditional(n))
            ids, lp = tdecode.greedy_with_logprobs(service.generator, feats,
                                                   service.config)
            assert resp["captions"] == [service._caption(r.tolist())
                                        for r in ids]
            np.testing.assert_allclose(resp["logprobs"], lp.numpy(),
                                       atol=1e-4)
    finally:
        service.close()


@pytest.mark.parametrize("extra", [
    ["--serve-continuous"], ["--serve-adaptive-chunk", "4"],
    ["--quantize", "int8"]])
def test_unported_transformer_serving_raises(extra):
    """The continuous engine, the adaptive decode and ``--quantize`` serve
    a transformer now: the captions of the greedy decode of the service's
    decode weights (the fake-quantized twin under ``--quantize``).  What
    still raises with each: ``--decode-mode speculative`` (LSTM only, as
    in the JAX package)."""
    service = serve.CaptionService(serve.parse_args(["--init-seed", "0",
                                                     *FLAGS, *extra]))
    try:
        resp = service.handle_request({"n": 2})
        feats = torch.from_numpy(service._features_unconditional(2))
        ids, lp = tdecode.greedy_with_logprobs(service.dec_params, feats,
                                               service.config)
        assert resp["captions"] == [service._caption(r.tolist())
                                    for r in ids]
        np.testing.assert_allclose(resp["logprobs"], lp.numpy(), atol=1e-4)
        assert (service.continuous is not None) == (
            "--serve-continuous" in extra)
    finally:
        service.close()
    with pytest.raises(SystemExit, match="LSTM"):
        serve.CaptionService(serve.parse_args(
            ["--init-seed", "0", *FLAGS, *extra, "--decode-mode",
             "speculative"]))


@pytest.mark.parametrize("override", [{"disc_arch": "bilstm"}])
def test_models_refused_until_ported_build(override):
    """The BiLSTM discriminator, refused until its port: a transformer
    generator's config builds both models."""
    config = Config(**KW).replace(**override)
    tapi.init_generator(torch.Generator(), config)
    disc = tapi.init_discriminator(torch.Generator(), config)
    assert type(disc).__name__ == "BiLSTMDiscriminator"


def test_conditional_transformer_serving_captions_images():
    """``--conditional-gan 1`` on a transformer, refused until its port:
    ``{"image"}`` rows carry the features and the ResNet grid, and the
    service's captions are the greedy decode over that context; ``{"n"}``
    is answered with an error."""
    service = serve.CaptionService(serve.parse_args(
        ["--init-seed", "3", *FLAGS, "--conditional-gan", "1",
         "--image-size", "64"]))
    try:
        assert service.context_shape == (4, 512)
        images = np.random.default_rng(1).standard_normal(
            (3, 3, 64, 64)).astype(np.float32)
        resp = service.caption_images(images)
        cond, _ = tapi.generator_condition(
            service.config, service.generator,
            {"images": torch.from_numpy(images)})
        ids, lp = tdecode.greedy_with_logprobs(
            service.generator, cond["features"], service.config,
            context=cond["context"])
        assert resp["captions"] == [service._caption(r.tolist())
                                    for r in ids]
        np.testing.assert_allclose(resp["logprobs"], lp.numpy(), atol=1e-4)
        assert "error" in service.handle_request({"n": 1})
    finally:
        service.close()


@pytest.mark.parametrize("override", [{"gen_arch": "gpt2"},
                                      {"conditional_gan": 1}])
def test_config5_models_build(override):
    """Refused until the conditional transformer's port: the GPT-2
    geometry (``config_from_args`` expands ``--gen-arch gpt2``) and a
    conditional transformer, whose encoder and ``ctx_proj`` (ResNet grid
    512 → d) are in its tree (built on the meta device: the tree's
    shapes, without drawing GPT-2's weights)."""
    from gan_image_captioning_tpu_torch.config import GPT2_GEOMETRY

    config = Config(**KW).replace(**override, image_size=32)
    if config.gen_arch == "gpt2":
        config = config.replace(**GPT2_GEOMETRY)
    tapi.require_ported(config)
    gen = ttf.TransformerGenerator(config, device="meta")
    assert gen.decoder.ctx_proj.w.shape == (512, config.gen_embed_dim)
    assert len(gen.decoder.blocks) == config.gen_num_layers
    assert (gen.encoder is not None) == bool(config.conditional_gan)
