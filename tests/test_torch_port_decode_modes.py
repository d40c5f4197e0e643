"""The port's decode modes ``sample``, ``pretrain`` and ``sample_embed``
(their plain versions, on CPU tensors), the fused-embed backward
``decode_sample_embed_bwd`` and the autograd Function of the fused
sample→disc-embed path against the JAX package's kernels run in interpret
mode (``GIC_KERNEL_INTERPRET=1``, chained BPTT), on the same weights.  The
interpreter's PRNG draws zeros, so the port is fed zero uniforms.

Tolerance: ids exact; values atol = rtol = 1e-5; gradients atol 1e-5,
rtol 1e-4 (float32 sums in another order over T·B rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.kernels import decode_sample as jkernel
from gan_image_captioning_tpu.models import generator as jgen
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.interop import generator_from_jax
from gan_image_captioning_tpu_torch.kernels.decode_sample import (
    decode_sample, decode_sample_embed, decode_sample_embed_bwd,
    decode_sample_logits, decode_sample_noise)
from gan_image_captioning_tpu_torch.models import generator as tgen

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

B, T, V, E, H, NL, ED = 4, 6, 64, 8, 16, 2, 8
TEMP = 2.0
VAL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("GIC_KERNEL_INTERPRET", "1")
    monkeypatch.setenv("GIC_BPTT_CHAIN", "1")


@pytest.fixture(scope="module")
def setup():
    kw = dict(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
              gen_num_layers=NL, max_seq_len=T - 2)
    jdec = jgen.init_decoder_params(jax.random.PRNGKey(12), JConfig(**kw))
    gen = generator_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    {"decoder": jdec}),
                             Config(**kw))
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((B, E)).astype(np.float32)
    wd = (rng.standard_normal((ED, V)) * 0.3).astype(np.float32)
    probe = rng.standard_normal((T, B, ED)).astype(np.float32)
    return jdec, gen, feats, wd, probe


def _port_args(gen, feats):
    dec = gen.decoder
    return (torch.from_numpy(feats), dec.lstm.layers(), dec.linear.weight,
            dec.linear.bias, dec.embed.weight, T)


def _jax_decode(jdec, feats, mode, **kw):
    return jkernel.decode_sample(jnp.asarray(feats), jdec["lstm"],
                                 jdec["linear"]["w"], jdec["linear"]["b"],
                                 jdec["embed"], T, mode=mode, seed=3, **kw)


def _assert_outputs(got, want, names):
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        assert tuple(a.shape) == tuple(b.shape), name
        if name == "ids":
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       err_msg=name, **VAL)


@pytest.mark.parametrize("mode,names", [("sample", ("ids", "noise")),
                                        ("pretrain", ("ids", "logits"))])
def test_sample_and_pretrain_modes_match_jax(setup, mode, names):
    jdec, gen, feats, _, _ = setup
    with torch.no_grad():
        got = decode_sample(*_port_args(gen, feats), mode=mode,
                            uniforms=torch.zeros(T, B, V))
    _assert_outputs(got, _jax_decode(jdec, feats, mode), names)
    # random rows, un-swept weights: many tokens compared
    assert len(np.unique(got[0].numpy())) > B


def test_sample_embed_mode_matches_jax(setup):
    jdec, gen, feats, wd, _ = setup
    want = _jax_decode(jdec, feats, "sample_embed", temperature=TEMP,
                       disc_embed=jnp.asarray(wd))
    with torch.no_grad():
        got = decode_sample(*_port_args(gen, feats), mode="sample_embed",
                            temperature=TEMP, uniforms=torch.zeros(T, B, V),
                            disc_embed=torch.from_numpy(wd))
    _assert_outputs(got, want, ("ids", "emb", "soft", "hs", "cs", "gates"))


def test_embed_bwd_matches_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((T, B, V)).astype(np.float32) * 3.0
    soft = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    args = [rng.standard_normal((T, B, H)).astype(np.float32), soft,
            rng.standard_normal((T, B, ED)).astype(np.float32),
            (rng.standard_normal((V, H)) * 0.3).astype(np.float32),
            (rng.standard_normal((ED, V)) * 0.3).astype(np.float32)]
    want = jkernel.decode_sample_embed_bwd(*map(jnp.asarray, args), TEMP)
    got = decode_sample_embed_bwd(*map(torch.from_numpy, args), TEMP)
    assert decode_sample_embed_bwd.launches == 0
    for name, a, b in zip(("dWp", "dbp", "d_htop"), got, want):
        assert tuple(a.shape) == tuple(b.shape), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GRAD)


def _port_embed(gen, feats, wd_t, role):
    """The port's fused sample with ``emb`` of ``role`` (``gen`` or
    ``fake``) as the output."""
    emb_gen, emb_fake, ids = tgen.sample_embed(
        gen.decoder, feats, T, TEMP, wd_t, uniforms=torch.zeros(T, B, V))
    return (emb_gen if role == "gen" else emb_fake).transpose(0, 1), ids


def test_sample_embed_forward_matches_jax(setup):
    jdec, gen, feats, wd, _ = setup
    want, ids_j = jgen._kernel_sample_embed(
        jdec, jnp.asarray(feats), jnp.float32(TEMP), jnp.int32(5),
        jnp.asarray(wd), T, "gen")
    with torch.no_grad():
        for role in ("gen", "fake"):
            emb, ids = _port_embed(gen, torch.from_numpy(feats),
                                   torch.from_numpy(wd), role)
            np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
            np.testing.assert_allclose(emb.numpy(), np.asarray(want), **VAL)


def test_sample_embed_vjp_matches_jax(setup):
    """``emb_gen``'s cotangent reaches the generator and the features and
    not the embedding weight (JAX ``wrt="gen"``); ``emb_fake``'s reaches
    the embedding weight only (``wrt="disc"``)."""
    jdec, gen, feats, wd, probe = setup

    def jloss(dec, f, w, wrt):
        emb, _ = jgen._kernel_sample_embed(dec, f, jnp.float32(TEMP),
                                           jnp.int32(5), w, T, wrt)
        return jnp.sum(emb * probe)

    g_dec, g_f = jax.grad(jloss, argnums=(0, 1))(
        jdec, jnp.asarray(feats), jnp.asarray(wd), "gen")
    g_wd = jax.grad(jloss, argnums=2)(jdec, jnp.asarray(feats),
                                      jnp.asarray(wd), "disc")
    want = {"embed": g_dec["embed"], "w": g_dec["linear"]["w"],
            "b": g_dec["linear"]["b"], "features": g_f}
    for l, lp in enumerate(g_dec["lstm"]):
        for k, v in lp.items():
            want[f"{l}.{k}"] = v

    dec = gen.decoder
    params = {"embed": dec.embed.weight, "w": dec.linear.weight,
              "b": dec.linear.bias}
    for l, lp in enumerate(dec.lstm.layers()):
        for k, v in lp.items():
            params[f"{l}.{k}"] = v
    f = torch.from_numpy(feats).requires_grad_(True)
    wd_t = torch.from_numpy(wd).requires_grad_(True)
    grads = {}
    for role in ("gen", "fake"):
        emb, _ = _port_embed(gen, f, wd_t, role)
        loss = (emb * torch.from_numpy(probe)).sum()
        flat = [*params.values(), f, wd_t]
        grads[role] = dict(zip([*params, "features", "wd"], torch.autograd
                               .grad(loss, flat, allow_unused=True)))
    assert grads["gen"]["wd"] is None
    assert all(grads["fake"][k] is None for k in want)
    for k in want:
        np.testing.assert_allclose(grads["gen"][k].numpy(),
                                   np.asarray(want[k]), err_msg=k, **GRAD)
    np.testing.assert_allclose(grads["fake"]["wd"].numpy(), np.asarray(g_wd),
                               **GRAD)


def test_cpu_modes_draw_from_the_seed_and_count_no_launch(setup):
    _, gen, feats, wd, _ = setup
    args = _port_args(gen, feats)
    fns = (decode_sample_noise, decode_sample_logits, decode_sample_embed)
    before = [f.launches for f in fns]
    with torch.no_grad():
        a = decode_sample_noise(*args, seed=7)
        b = decode_sample_noise(*args, seed=7)
        c = decode_sample_noise(*args, seed=8)
        resid = decode_sample(*args, mode="sample_resid", seed=7)
        emb = decode_sample_embed(*args, torch.from_numpy(wd), seed=7)
        decode_sample_logits(*args)
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])
    assert torch.equal(a[0], resid[0]) and torch.equal(emb[0], resid[0])
    assert torch.equal(emb[2], resid[1])
    assert [f.launches for f in fns] == before


def test_modes_reject_bad_inputs(setup):
    _, gen, feats, wd, _ = setup
    args = _port_args(gen, feats)
    with pytest.raises(ValueError):
        decode_sample(*args, mode="sample", uniforms=torch.zeros(T, B, V - 1))
    with pytest.raises(ValueError):
        decode_sample(*args, mode="sample_embed")
    with pytest.raises(ValueError):
        decode_sample_embed(*args, torch.from_numpy(wd)[:, :V - 1])
    with pytest.raises(TypeError):
        decode_sample_logits(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        decode_sample(*args, mode="beam")
