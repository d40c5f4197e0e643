"""The port's conv banks (``conv_relu_maxpool``, its plain versions on
CPU tensors) and CNN discriminator against the JAX package's: the MXU
engine run in interpret mode (value and gradients, including exact ties
over time), the XLA path for a representation width eds > 1, and
``discriminator.apply`` with a fed dropout keep mask.

Tolerance: values atol = rtol = 1e-5, gradients atol 1e-5 and rtol 1e-4
(float32 products summed in another order); argmax rows exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.kernels import disc_conv as jdc
from gan_image_captioning_tpu.models import discriminator as jdisc
from gan_image_captioning_tpu.models.torch_export import (
    discriminator_to_torch)
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.interop import discriminator_from_jax
from gan_image_captioning_tpu_torch.kernels import disc_conv
from gan_image_captioning_tpu_torch.models import discriminator as tdisc

VAL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)

# (embed, num_rep, filter sizes, filters, max_seq_len, batch); eds = E/R
CONFIGS = {
    "eds1": dict(disc_embed_dim=16, disc_num_rep=16,
                 disc_filter_sizes=(2, 3, 4), disc_num_filters=(5, 6, 7),
                 max_seq_len=4),
    "single_bank": dict(disc_embed_dim=8, disc_num_rep=8,
                        disc_filter_sizes=(3,), disc_num_filters=(9,),
                        max_seq_len=3),
    "eds4": dict(disc_embed_dim=24, disc_num_rep=6,
                 disc_filter_sizes=(3, 5), disc_num_filters=(4, 8),
                 max_seq_len=4),
}


def _setup(name, seed=0, B=4, ties=False):
    config = JConfig(vocab_size=40, **CONFIGS[name])
    params = jdisc.init_discriminator_params(jax.random.PRNGKey(seed), config)
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, config.seq_len, config.disc_embed_dim))
    if ties:     # every time row equal: each max over time is a full tie
        emb[:] = emb[:, :1]
    probe = rng.standard_normal((B * config.disc_num_rep,
                                 config.disc_feature_dim))
    return config, params, emb.astype(np.float32), probe.astype(np.float32)


def _jax_pooled(params, emb, config, impl):
    eds = config.emb_dim_single
    if impl == "xla":
        return jdisc.conv_pooled(params, emb, config)
    out = jdc.pooled_features(params["convs"], emb, eds, impl=impl)
    return out.reshape(-1, config.disc_feature_dim)


@pytest.mark.parametrize("name,impl,ties", [
    ("eds1", "mxu", False), ("single_bank", "mxu", False),
    ("eds1", "mxu", True), ("eds4", "xla", False)])
def test_conv_pooled_value_and_vjp_match_jax(name, impl, ties):
    config, params, emb, probe = _setup(name, ties=ties)

    def jloss(convs, e):
        out = _jax_pooled(dict(params, convs=convs), e, config, impl)
        return jnp.sum(out * probe), out

    (_, want), (g_convs, g_emb) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params["convs"],
                                             jnp.asarray(emb))
    convs = [(torch.tensor(np.asarray(c["w"]), requires_grad=True),
              torch.tensor(np.asarray(c["b"]), requires_grad=True))
             for c in params["convs"]]
    e = torch.from_numpy(emb).requires_grad_(True)
    out = disc_conv.pooled_features(convs, e, config.emb_dim_single)
    out = out.reshape(-1, config.disc_feature_dim)
    (out * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **VAL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(g_emb), **GRAD)
    for (w, b), g in zip(convs, g_convs):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(g["w"]), **GRAD)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(g["b"]), **GRAD)


def test_ties_take_the_first_time_row():
    config, params, emb, _ = _setup("eds1", ties=True)
    convs = [(torch.tensor(np.asarray(c["w"])), torch.tensor(np.asarray(c["b"])))
             for c in params["convs"]]
    w_all, b_all, banks = disc_conv.fuse_bank_params(convs, 1)
    emb_pad = torch.nn.functional.pad(torch.from_numpy(emb), (0, 0, 0, 3))
    pooled, idxs = disc_conv.conv_bank_forward(
        emb_pad.contiguous(), w_all.contiguous(), b_all, banks,
        config.disc_num_rep, 1)
    assert all(int(i.max()) == 0 for i in idxs)
    assert float(pooled.min()) >= 0.0


def _disc_inputs(config, seed=1):
    rng = np.random.default_rng(seed)
    B, L, V = 3, config.seq_len, config.vocab_size
    soft = rng.random((B, L, V)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    return soft, ids


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_apply_matches_jax(train):
    config = JConfig(vocab_size=40, **CONFIGS["eds1"])
    tconfig = Config(vocab_size=40, **CONFIGS["eds1"])
    params = jdisc.init_discriminator_params(jax.random.PRNGKey(2), config)
    # larger weights than the init sweep's, so the logits carry signal
    params = jax.tree_util.tree_map(lambda x: x * 20.0, params)
    soft, ids = _disc_inputs(config)
    key = jax.random.PRNGKey(9)
    keep = np.array(jax.random.bernoulli(
        key, 0.8, (3 * config.disc_num_rep, config.disc_feature_dim)))
    disc = discriminator_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                  tconfig)
    p = tdisc.params_of(disc)
    for inp in (soft, ids):
        want, g_want = jax.value_and_grad(
            lambda prm: jnp.sum(jdisc.apply(prm, jnp.asarray(inp), config,
                                            rng=key, train=train) ** 2))(
            params)
        disc.zero_grad()
        got = (tdisc.apply(p, torch.from_numpy(inp), tconfig, train=train,
                           keep=torch.from_numpy(keep)) ** 2).sum()
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), **VAL)
        g_torch = discriminator_to_torch(g_want)
        for k, v in disc.named_parameters():
            np.testing.assert_allclose(v.grad.numpy(), np.asarray(g_torch[k]),
                                       err_msg=k, **GRAD)


def test_embed_tokens_gather_equals_one_hot_product():
    tconfig = Config(vocab_size=40, **CONFIGS["eds1"])
    disc = tdisc.init_discriminator_params(torch.Generator().manual_seed(0),
                                           tconfig)
    ids = torch.randint(0, 40, (3, 6), generator=torch.Generator()
                        .manual_seed(1))
    p = tdisc.params_of(disc, detach=True)
    one_hot = torch.nn.functional.one_hot(ids.long(), 40).float()
    torch.testing.assert_close(tdisc.embed_tokens(p, ids),
                               tdisc.embed_tokens(p, one_hot))


def test_init_and_state_dict_layout_match_the_reference():
    config = JConfig(vocab_size=40, **CONFIGS["eds4"])
    tconfig = Config(vocab_size=40, **CONFIGS["eds4"])
    params = jdisc.init_discriminator_params(jax.random.PRNGKey(0), config)
    want = discriminator_to_torch(params)
    disc = tdisc.init_discriminator_params(torch.Generator().manual_seed(0),
                                           tconfig)
    sd = disc.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert max(float(v.abs().max()) for v in sd.values()) <= 0.05
    loaded = discriminator_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           params), tconfig)
    for k, v in loaded.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))


def test_argmax_replay_reports_no_gap_on_the_same_inputs():
    config, params, emb, probe = _setup("eds1")
    convs = [(torch.tensor(np.asarray(c["w"])), torch.tensor(np.asarray(c["b"])))
             for c in params["convs"]]
    e = torch.from_numpy(emb)
    with disc_conv.argmax_record() as rows:
        a = disc_conv.pooled_features(convs, e, 1)
    with disc_conv.argmax_replay(rows) as report:
        b = disc_conv.pooled_features(convs, e, 1, engine="plain")
    assert torch.equal(a, b) and report == [(0.0, 0)]


def test_conv_wrappers_count_no_launch_on_cpu_and_reject_bad_inputs():
    config, params, emb, _ = _setup("eds1")
    convs = [(torch.tensor(np.asarray(c["w"])), torch.tensor(np.asarray(c["b"])))
             for c in params["convs"]]
    w_all, b_all, banks = disc_conv.fuse_bank_params(convs, 1)
    emb_pad = torch.nn.functional.pad(torch.from_numpy(emb),
                                      (0, 0, 0, 3)).contiguous()
    before = (disc_conv.conv_bank_forward.launches,
              disc_conv.conv_bank_backward.launches)
    _, idxs = disc_conv.conv_bank_forward(emb_pad, w_all, b_all, banks, 16, 1)
    dpms = [torch.ones(4, 16, n) for n, _ in banks]
    disc_conv.conv_bank_backward(emb_pad, w_all, banks, 16, 1, idxs, dpms)
    assert (disc_conv.conv_bank_forward.launches,
            disc_conv.conv_bank_backward.launches) == before
    with pytest.raises(TypeError):
        disc_conv.conv_bank_forward(emb_pad.double(), w_all, b_all, banks,
                                    16, 1)
    with pytest.raises(ValueError):
        disc_conv.conv_bank_forward(emb_pad, w_all, b_all, banks, 8, 1)
    with pytest.raises(ValueError):
        disc_conv.conv_bank_backward(emb_pad, w_all, banks, 16, 1, idxs,
                                     [d[:, :8] for d in dpms])
