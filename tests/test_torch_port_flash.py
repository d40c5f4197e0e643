"""The port's ``kernels/flash_attention.py`` on the CPU against the JAX
package's ``flash_attention`` (its Pallas kernels in interpret mode, as
``tests/test_flash_attention.py`` runs them) and ``attention_reference``:
the same numpy inputs, the three masks the transformer family builds
(causal with lengths, causal, full; and full with lengths), ragged T (35,
37, 200), head dims 16 and 64, outputs and the gradients of q, k and v.  On the CPU the wrapper
runs its plain version, the dense attention that the card's kernels are
held against.

Tolerance: outputs atol 5e-6 / rtol 1e-5, gradients atol 2e-5 / rtol 1e-4
(the JAX package's own flash tolerances: float32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.kernels import flash_attention as jfa
from gan_image_captioning_tpu.models import transformer as jtf
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.kernels import flash_attention as tfa
from gan_image_captioning_tpu_torch.models import transformer as ttf

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

OUT = dict(atol=5e-6, rtol=1e-5)
GRAD = dict(atol=2e-5, rtol=1e-4)
MASKS = [(True, True), (True, False), (False, False), (False, True)]


def _inputs(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((b, t, h, d)).astype(np.float32)
           for _ in range(3)]
    lengths = rng.integers(1, t + 1, b).astype(np.int32)
    return qkv, lengths


@pytest.mark.parametrize("t", [35, 37, 200])
@pytest.mark.parametrize("causal,with_lengths", MASKS)
def test_forward_and_gradients_match_jax(t, causal, with_lengths):
    _match_jax(t, 16, causal, with_lengths)


def test_forward_and_gradients_match_jax_at_gpt2_head_dim():
    """config5's mask (causal with lengths) at GPT-2's head dim 64, the
    column-half kernels' shapes on the card."""
    assert tfa.flash_bwd_plan(37, 2, 64)["split"] == "columns"
    _match_jax(37, 64, True, True)


def _match_jax(t, d, causal, with_lengths):
    (q, k, v), lens = _inputs(2, t, 2, d, t)
    lens = lens if with_lengths else None
    g = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)

    def jloss(fn):
        return lambda *a: jnp.sum(fn(*a, causal, None if lens is None else
                                     jnp.asarray(lens)) * g)

    j_out = np.asarray(jfa.flash_attention(q, k, v, causal, None if lens is
                                           None else jnp.asarray(lens)))
    j_ref = np.asarray(jfa.attention_reference(q, k, v, causal, None if lens
                                               is None else jnp.asarray(lens)))
    j_grads = jax.grad(jloss(jfa.flash_attention), (0, 1, 2))(q, k, v)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    before = tfa.flash_fwd.launches
    out = tfa.flash_attention(tq, tk, tv, causal, None if lens is None
                              else torch.from_numpy(lens))
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    assert tfa.flash_fwd.launches == before       # the CPU runs no kernel
    np.testing.assert_allclose(out.detach().numpy(), j_out, **OUT)
    np.testing.assert_allclose(out.detach().numpy(), j_ref, **OUT)
    for a, b in zip(grads, j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


def test_supported_predicate_matches_jax():
    for t, d in [(36, 16), (37, 32), (35, 12), (1, 256), (9, 264), (4, 8)]:
        assert tfa.supported(t, d) == jfa.supported(t, d), (t, d)
    q = torch.zeros((1, 4, 1, 12))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, True)


def _block(d=16, d_mlp=24, seed=0):
    """A JAX block's params, and the port's flat dict of them."""
    p = jtf.init_block(jax.random.PRNGKey(seed), d, d_mlp, jnp.float32)
    flat = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                flat[prefix + key] = torch.from_numpy(np.array(val))

    walk(p, "blocks.0.")
    return p, flat


@pytest.mark.parametrize("causal,with_lengths", MASKS)
def test_block_routes_match_jax_flash_and_dense(monkeypatch, causal,
                                                 with_lengths):
    """``block_apply`` through the flash route and the dense route, against
    the JAX block with GIC_FLASH_ATTN=1 (interpret) and 0."""
    jp, flat = _block()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 37, 16)).astype(np.float32)
    lens = np.array([37, 20, 1], np.int32) if with_lengths else None
    t = x.shape[1]
    mask = jnp.tril(jnp.ones((t, t), bool))[None, None] if causal else \
        jnp.ones((1, 1, t, t), bool)
    if lens is not None:
        mask = mask & (jnp.arange(t)[None, :] < lens[:, None])[:, None, None]
    jl = None if lens is None else jnp.asarray(lens)
    want = {}
    for flash in ("0", "1"):
        monkeypatch.setenv("GIC_FLASH_ATTN", flash)
        want[flash] = np.asarray(jtf.block_apply(jp, jnp.asarray(x), 2, mask,
                                                 flash_causal=causal,
                                                 flash_lengths=jl))
    tmask = torch.from_numpy(np.array(mask))
    tl = None if lens is None else torch.from_numpy(lens)
    for impl, key in (("kernel", "1"), ("plain", "0")):
        got = ttf.block_apply(flat, "blocks.0", torch.from_numpy(x), 2, tmask,
                              flash_causal=causal, flash_lengths=tl,
                              attn_impl=impl)
        np.testing.assert_allclose(got.numpy(), want[key], **OUT)


def test_attn_impl_is_validated():
    _, flat = _block()
    x = torch.zeros((1, 4, 16))
    with pytest.raises(ValueError):
        ttf.block_apply(flat, "blocks.0", x, 2, flash_causal=True,
                        attn_impl="fused")
    assert Config().attn_impl == "kernel"
