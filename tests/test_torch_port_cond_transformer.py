"""The port's conditional transformer (cross-attention over the encoder's
grid) against the JAX package on the CPU, in float32, at the GPT-2
family's shape cut small (d 64, MLP 128, 2 layers, 4 heads, V 48).

Decoder level (a fed grid, weights scaled by ``PEAK`` for the decodes as
in ``test_torch_port_beam.py``): the teacher-forced logits and their
gradients (flash and dense routes), the KV-cache decode against the
parallel pass, the free-running sample (greedy, and Gumbel on fed
uniforms), greedy with log-probabilities, beam search and sampled
decoding over a context, and the ``ctx_proj`` shape rule: applied when the
grid's width differs from the model's (512 → 64), skipped when equal
(64 = 64: its gradient is zero on both sides).  Step level, on the
ResNet-18 grid of 64 × 64 images (a 2 × 2 grid, 512 channels): the MLE,
Gumbel adversarial and REINFORCE losses and both gradient sets on the JAX
draws, ``generator_condition``'s one backbone pass, and a frozen backbone
that gets no gradient.  (The ViT grid: ``test_torch_port_vit.py``;
bfloat16: ``test_torch_port_cond_transformer_bf16.py``.)

Tolerance: values atol 1e-5 / rtol 1e-5; losses rtol 1e-5 / atol 1e-6;
gradients atol 1e-5 / rtol 1e-4 (float32 sums in another order); ids
equal; decode scores within 1e-5."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.loader import make_batch as jmake_batch
from gan_image_captioning_tpu.eval import decode as jdecode
from gan_image_captioning_tpu.models import api as japi
from gan_image_captioning_tpu.models import transformer as jtf
from gan_image_captioning_tpu.train import reinforce as jrl
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.eval import decode as tdecode
from gan_image_captioning_tpu_torch.models import api as tapi
from gan_image_captioning_tpu_torch.models import transformer as ttf
from gan_image_captioning_tpu_torch.train import steps as tsteps
from gan_image_captioning_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

B, V, P, S = 4, 48, 4, 64
PEAK = 8.0
DEC = dict(vocab_size=V, gen_arch="transformer", gen_embed_dim=64,
           gen_hidden_dim=128, gen_num_layers=2, gen_num_heads=4,
           max_seq_len=5)
KW = dict(DEC, disc_embed_dim=8, disc_num_rep=4, disc_filter_sizes=(2, 3),
          disc_num_filters=(5, 6), conditional_gan=1, image_size=S,
          rollout_num=2, rollout_stride=3, gen_lr=1e-3, disc_lr=1e-3)
VAL = dict(atol=1e-5, rtol=1e-5)
LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def no_state_shardings():
    """No process-wide JAX state shardings (another file may leave them
    set on this worker)."""
    prev = jsteps._STATE_SHARDINGS
    jsteps.set_state_shardings(None)
    yield
    jsteps.set_state_shardings(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _decoder(d=64, seed=0, peak=1.0, **over):
    """(JAX params, JAX config, port generator, port config) of an
    unconditional-tree transformer whose decodes are fed a context."""
    kw = dict(DEC, gen_embed_dim=d, **over)
    jconfig, config = JConfig(**kw), Config(**kw)
    gp = japi.init_generator(jax.random.PRNGKey(seed), jconfig)
    if peak != 1.0:
        gp = jax.tree_util.tree_map(lambda a: a * peak, gp)
    gen = interop.transformer_generator_from_jax(_np(gp), config)
    return gp, jconfig, gen.requires_grad_(False), config


def _inputs(d, seed=1, ctx_dim=512):
    rng = np.random.default_rng(seed)
    caps = rng.integers(0, V, (B, DEC["max_seq_len"] + 2)).astype(np.int32)
    lens = np.array([7, 3, 0, 5], np.int32)
    feats = rng.standard_normal((B, d)).astype(np.float32)
    ctx = rng.standard_normal((B, P, ctx_dim)).astype(np.float32)
    return caps, lens, feats, ctx


@pytest.fixture(scope="module")
def decoder():
    return _decoder()


@pytest.fixture(scope="module")
def peaked():
    return _decoder(seed=2, peak=PEAK)


@pytest.mark.parametrize("flash", ["0", "1"])
def test_teacher_forced_over_a_context_and_gradients(decoder, monkeypatch,
                                                     flash):
    gp, jconfig, gen, config = decoder
    monkeypatch.setenv("GIC_FLASH_ATTN", flash)
    caps, lens, feats, ctx = _inputs(64)
    g = np.random.default_rng(5).standard_normal(
        (B, caps.shape[1] + 1, V)).astype(np.float32)

    def fwd(dec, c):
        return jtf.teacher_forced(dec, jnp.asarray(feats), jnp.asarray(caps),
                                  jconfig, lengths=jnp.asarray(lens),
                                  context=c)

    want = np.asarray(jax.jit(fwd)(gp["decoder"], jnp.asarray(ctx)))
    jg, jgc = jax.jit(jax.grad(lambda d, c: jnp.sum(fwd(d, c) * g),
                               argnums=(0, 1)))(gp["decoder"],
                                                jnp.asarray(ctx))
    jgrads = interop.flatten_jax({"decoder": _np(jg)})
    cfg = config.replace(attn_impl="kernel" if flash == "1" else "plain")
    params = dict(gen.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    c = torch.from_numpy(ctx).requires_grad_(True)
    got = ttf.teacher_forced(gen.decoder, torch.from_numpy(feats),
                             torch.from_numpy(caps), cfg,
                             lengths=torch.from_numpy(lens), context=c)
    np.testing.assert_allclose(got.detach().numpy(), want, **VAL)
    grads = torch.autograd.grad(got, [*params.values(), c],
                                torch.from_numpy(g), allow_unused=True)
    for p in params.values():
        p.requires_grad_(False)
    for (name, p), gr in zip(params.items(), grads):
        gr = torch.zeros_like(p) if gr is None else gr
        np.testing.assert_allclose(gr.numpy(), jgrads[name].numpy(),
                                   err_msg=name, **GRAD)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgc), **GRAD)
    # the context went through ctx_proj (512 → 64): its weight has gradient
    assert float(np.abs(jgrads["decoder.ctx_proj.w"].numpy()).max()) > 0


def test_kv_cache_decode_over_a_context_matches_the_parallel_pass(decoder):
    _, _, gen, config = decoder
    caps, _, feats, ctx = _inputs(64, 3)
    p = ttf.params_of(gen.decoder)
    c = torch.from_numpy(ctx)
    par = ttf.teacher_forced(p, torch.from_numpy(feats),
                             torch.from_numpy(caps), config, context=c)
    cross = ttf.cross_kv(p, ttf.project_context(p, c, 64), 4)
    k, v = ttf._init_kv_cache(config, B)
    x = torch.from_numpy(feats)
    for t in range(config.seq_len):
        logits, k, v = ttf.decode_step(p, config, x, k, v, t, cross)
        np.testing.assert_allclose(logits.numpy(), par[:, t].numpy(), **VAL)
        x = p["embed"][torch.from_numpy(caps[:, t]).long()]


def test_ctx_proj_is_skipped_at_equal_widths(decoder):
    """The JAX shape rule: a grid as wide as the model (64 here, as
    config5's 768-wide ViT grid into its 768-wide GPT-2) skips
    ``ctx_proj`` (its gradient is zero on both sides), and the logits
    agree."""
    gp, jconfig, gen, config = decoder
    caps, _, feats, ctx = _inputs(64, 4, ctx_dim=64)
    want, jg = jax.jit(jax.value_and_grad(lambda d: jnp.sum(jtf.teacher_forced(
        d, jnp.asarray(feats), jnp.asarray(caps), jconfig,
        context=jnp.asarray(ctx)) ** 2)))(gp["decoder"])
    gen.requires_grad_(True)
    try:
        got = (ttf.teacher_forced(gen.decoder, torch.from_numpy(feats),
                                  torch.from_numpy(caps), config,
                                  context=torch.from_numpy(ctx)) ** 2).sum()
        gw, = torch.autograd.grad(got, [gen.decoder.ctx_proj.w],
                                  allow_unused=True)
    finally:
        gen.requires_grad_(False)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert gw is None
    assert not np.asarray(jg["ctx_proj"]["w"]).any()
    p = ttf.params_of(gen.decoder)
    assert torch.equal(ttf.project_context(p, torch.from_numpy(ctx), 64),
                       torch.from_numpy(ctx))


def test_greedy_and_gumbel_samples_over_a_context_match_jax(decoder):
    gp, jconfig, gen, config = decoder
    _, _, feats, ctx = _inputs(64, 6)
    T, temp = config.seq_len, 2.0
    key = jax.random.PRNGKey(7)
    for pretrain in (True, False):
        out_j, ids_j = jax.jit(lambda d: jtf.sample(
            d, jnp.asarray(feats), key, temp, T, pretrain=pretrain,
            config=jconfig, context=jnp.asarray(ctx)))(gp["decoder"])
        u = None if pretrain else torch.from_numpy(np.stack([
            np.asarray(jax.random.uniform(k, (B, V), jnp.float32))
            for k in jax.random.split(key, T)]))
        out, ids = ttf.sample(gen.decoder, torch.from_numpy(feats), T,
                              pretrain, config, temp, uniforms=u,
                              context=torch.from_numpy(ctx))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **VAL)


def _jax_gumbel(seed, T):
    """``sample_decode``'s draws from ``PRNGKey(seed)`` → ``[T, B, V]``."""
    rng = jax.random.PRNGKey(seed)
    rng, key = jax.random.split(rng)
    out = []
    for _ in range(T):
        out.append(np.asarray(jax.random.gumbel(key, (B, V), jnp.float32)))
        rng, key = jax.random.split(rng)
    return np.stack(out)


@pytest.mark.parametrize("mode", ["greedy", "beam", "sample"])
def test_decodes_over_a_context_match_jax(peaked, mode):
    gp, jconfig, gen, config = peaked
    _, _, feats, ctx = _inputs(64, 8)
    jf, jc = jnp.asarray(feats), jnp.asarray(ctx)
    f, c = torch.from_numpy(feats), torch.from_numpy(ctx)
    if mode == "greedy":
        want = jdecode.greedy_with_logprobs(gp, jf, jconfig, context=jc,
                                            allow_kernel=False)
        got = tdecode.greedy_with_logprobs(gen, f, config, context=c)
        lp = tdecode.sequence_logprob(gen, f, got[0], config, c)
        np.testing.assert_allclose(lp.numpy(), got[1].numpy(), atol=1e-5)
    elif mode == "beam":
        want = jdecode.beam_search(gp, jf, jconfig, beam_size=3,
                                   context=jc, length_penalty=0.6)
        got = tdecode.beam_search(gen, f, config, beam_size=3, context=c,
                                  length_penalty=0.6)
    else:
        want = jdecode.sample_decode(gp, jf, jconfig, jax.random.PRNGKey(9),
                                     context=jc, temperature=0.8, top_k=5)
        got = tdecode.sample_decode(gen, f, config, context=c,
                                    temperature=0.8, top_k=5,
                                    noise=torch.from_numpy(_jax_gumbel(
                                        9, config.seq_len)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-5, rtol=0)


# ------------------------------------------------------------------- steps

class _Params(NamedTuple):
    gen_params: dict
    disc_params: dict


@pytest.fixture(scope="module")
def jax_state():
    """The JAX generator and discriminator of the conditional transformer
    on the ResNet-18 grid (built once, by jitted inits: the JAX functions
    below only read them)."""
    jconfig = JConfig(**KW, decode_impl="fused")
    return jconfig, _Params(
        jax.jit(lambda k: japi.init_generator(k, jconfig))(
            jax.random.PRNGKey(0)),
        jax.jit(lambda k: japi.init_discriminator(k, jconfig))(
            jax.random.PRNGKey(1)))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    T = DEC["max_seq_len"] + 2
    caps = [rng.integers(4, V, size=rng.integers(1, 6)) for _ in range(B)]
    imgs = [(rng.standard_normal((3, S, S)) * rng.uniform(0.5, 2)
             + rng.uniform(-1, 1, (3, 1, 1))).astype(np.float32)
            for _ in range(B)]
    jbatch = {k: jnp.asarray(v) for k, v in
              jmake_batch(caps, imgs, T).items()}
    return jbatch, tsteps.batch_to(make_batch(caps, imgs, T), "cpu")


def _port_state(jstate, config):
    return create_train_state(
        config, 0, gen=interop.transformer_generator_from_jax(
            _np(jstate.gen_params), config),
        disc=interop.discriminator_from_jax(_np(jstate.disc_params), config))


def _gen_flat(tree):
    return interop._transformer_gen_params(_np(tree))


def _assert_grads(got, want, tag):
    for name, gr in got.items():
        np.testing.assert_allclose(gr.numpy(), want[name].numpy(),
                                   err_msg=f"{tag}: {name}", **GRAD)


def _uniforms(key, t, rows):
    return np.stack([np.array(jax.random.uniform(k, (rows, V), jnp.float32))
                     for k in jax.random.split(key, t)])


def test_condition_gives_features_and_grid_from_one_pass(jax_state):
    """One ResNet trunk pass gives both: the grid (the final stage, 2 × 2
    × 512 here) and the features of its mean through the head (the JAX
    ``encode_with_grid``; the losses below hold both against the JAX
    package)."""
    _, jstate = jax_state
    config = Config(**KW)
    state = _port_state(jstate, config)
    _, batch = _batch(1)
    enc = state.gen.encoder
    resnet, calls = enc.resnet, []
    trunk = resnet.trunk
    resnet.trunk = lambda *a: calls.append(1) or trunk(*a)
    with torch.no_grad():
        cond, _ = tapi.generator_condition(config, state.gen, batch)
    del resnet.trunk
    assert len(calls) == 1
    assert cond["context"].shape == (B, P, 512)
    with torch.no_grad():
        grid = trunk(batch["images"], False).flatten(2).transpose(1, 2)
        feats = enc.bn(enc.linear(grid.mean(dim=1)), False)
    assert torch.equal(cond["context"], grid)
    np.testing.assert_allclose(cond["features"].numpy(), feats.numpy(),
                               **VAL)


def test_mle_loss_and_gradients_match_jax(jax_state):
    jconfig, jstate = jax_state
    config = Config(**KW)
    state = _port_state(jstate, config)
    jbatch, batch = _batch(2)
    key = jax.random.PRNGKey(3)
    jloss, jg = jax.jit(jax.value_and_grad(lambda gp: jsteps.mle_loss(
        jconfig, gp, jbatch, key, True)[0]))(jstate.gen_params)
    loss, grads = tsteps.mle_grads(config, state, batch)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS)
    _assert_grads(grads, _gen_flat(jg), "mle")
    # a frozen ResNet backbone: no gradient on either side
    assert not any(k.startswith("encoder.resnet.") for k in grads)
    assert not any(np.asarray(v).any() for v in jax.tree_util.tree_leaves(
        jg["encoder"]["backbone"]))


def test_gumbel_adversarial_losses_and_gradients_match_jax(jax_state):
    jconfig, jstate = jax_state
    config = Config(**KW)
    state = _port_state(jstate, config)
    jbatch, batch = _batch(3)
    key, temp = jax.random.PRNGKey(4), 2.0

    def total(gp, dp):
        g, d, aux = jsteps.adv_losses(jconfig, gp, dp, jbatch, key, temp,
                                      True, grad_side="both")
        return g + d, (g, d, aux["gen_ids"])

    (_, (jgl, jdl, jids)), (jgg, jdg) = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True))(jstate.gen_params,
                                              jstate.disc_params)
    _, r_sample, r1, r2, r3, _ = jax.random.split(key, 6)
    shape = tapi.disc_keep_shape(config, B)
    noise = {"uniforms": torch.from_numpy(_uniforms(r_sample,
                                                    config.seq_len, B)),
             "keep": [torch.from_numpy(np.array(jax.random.bernoulli(
                 k, 0.8, shape))) for k in (r1, r2, r3)]}
    gl, dl, gg, dg, aux = tsteps.adv_grads(config, state, batch, temp, noise)
    np.testing.assert_array_equal(aux["gen_ids"].numpy(), np.asarray(jids))
    np.testing.assert_allclose(float(gl), float(jgl), **LOSS)
    np.testing.assert_allclose(float(dl), float(jdl), **LOSS)
    _assert_grads(gg, _gen_flat(jgg), "gen")
    _assert_grads(dg, interop.disc_params_from_jax(_np(jdg)), "disc")


def test_reinforce_losses_and_gradients_match_jax(jax_state):
    """REINFORCE's rollouts and log-probabilities over the grid: the
    rollouts repeat it K times with the features."""
    jconfig, jstate = jax_state
    over = dict(adv_objective="reinforce")
    jconfig, config = jconfig.replace(**over), Config(**KW, **over)
    state = _port_state(jstate, config)
    jbatch, batch = _batch(4)
    key = jax.random.PRNGKey(6)

    def total(gp, dp):
        g, d, aux = jrl.reinforce_losses(jconfig, gp, dp, jbatch, key, 1.0,
                                         True)
        return g + d, (g, d, aux["gen_ids"], aux["mean_reward"])

    (_, (jgl, jdl, jids, jr)), (jgg, jdg) = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True))(jstate.gen_params,
                                              jstate.disc_params)
    T = config.seq_len
    r_sample, r_roll, r_d1, r_d2, _ = jax.random.split(key, 5)
    npos = len(range(config.rollout_stride, T, config.rollout_stride))
    shape = tapi.disc_keep_shape(config, B)
    noise = {"uniforms": torch.from_numpy(_uniforms(r_sample, T, B)),
             "rollout_uniforms": [
                 torch.from_numpy(_uniforms(k, T, B * config.rollout_num))
                 for k in jax.random.split(r_roll, npos)],
             "keep": [torch.from_numpy(np.array(jax.random.bernoulli(
                 k, 0.8, shape))) for k in (r_d1, r_d2)],
             "seed": 0}
    gl, dl, gg, dg, aux = tsteps.adv_grads(config, state, batch, 1.0, noise)
    np.testing.assert_array_equal(aux["gen_ids"].numpy(), np.asarray(jids))
    np.testing.assert_allclose(float(aux["mean_reward"]), float(jr), **LOSS)
    np.testing.assert_allclose(float(gl), float(jgl), **LOSS)
    np.testing.assert_allclose(float(dl), float(jdl), **LOSS)
    _assert_grads(gg, _gen_flat(jgg), "gen")
    _assert_grads(dg, interop.disc_params_from_jax(_np(jdg)), "disc")
