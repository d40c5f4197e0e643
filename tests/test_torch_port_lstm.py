"""The port's LSTM step functions against the JAX package's
(``models/lstm.py``), on the same numpy inputs; atol 1e-5 (float32 sums
in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.models import lstm as jlstm
from gan_image_captioning_tpu_torch.models import lstm as tlstm

B, E, H, NL = 4, 24, 32, 2
ATOL = 1e-5


def _layers(seed):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    return [{name: (rng.uniform(-k, k, shape)).astype(np.float32)
             for name, shape in (("w_ih", (4 * H, E if l == 0 else H)),
                                 ("w_hh", (4 * H, H)), ("b_ih", (4 * H,)),
                                 ("b_hh", (4 * H,)))}
            for l in range(NL)]


def _as(layers, fn):
    return [{k: fn(v) for k, v in lp.items()} for lp in layers]


@pytest.mark.parametrize("fused", [False, True])
def test_lstm_cell_matches_jax(fused):
    layers = _layers(0)
    rng = np.random.default_rng(1)
    x, h, c = (rng.standard_normal((B, n)).astype(np.float32)
               for n in (E, H, H))
    jl, tl = _as(layers, jnp.asarray), _as(layers, torch.from_numpy)
    if fused:
        jl, tl = jlstm.fuse_layer_params(jl), tlstm.fuse_layer_params(tl)
    hj, cj = jlstm.lstm_cell(jl[0], jnp.asarray(x), jnp.asarray(h),
                             jnp.asarray(c))
    ht, ct = tlstm.lstm_cell(tl[0], torch.from_numpy(x), torch.from_numpy(h),
                             torch.from_numpy(c))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=ATOL, rtol=0)


def test_lstm_step_matches_jax_over_steps():
    layers = _layers(2)
    rng = np.random.default_rng(3)
    jl = jlstm.fuse_layer_params(_as(layers, jnp.asarray))
    tl = tlstm.fuse_layer_params(_as(layers, torch.from_numpy))
    js = jlstm.zero_state(NL, B, H)
    ts = tlstm.zero_state(NL, B, H)
    for _ in range(5):
        x = rng.standard_normal((B, E)).astype(np.float32)
        hj, js = jlstm.lstm_step(jl, jnp.asarray(x), js)
        ht, ts = tlstm.lstm_step(tl, torch.from_numpy(x), ts)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=ATOL,
                                   rtol=0)
    for got, want in zip(ts, js):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def test_lstm_container_uses_nn_lstm_names_and_default_init():
    ours = tlstm.LSTM(E, H, NL)
    ref = torch.nn.LSTM(E, H, NL)
    want = {k: v.shape for k, v in ref.state_dict().items()}
    assert {k: v.shape for k, v in ours.state_dict().items()} == want
    tlstm.init_lstm_params(torch.Generator().manual_seed(0), ours)
    bound = 1.0 / np.sqrt(H)
    for p in ours.parameters():
        p = p.detach()
        assert float(p.abs().max()) <= bound
        assert float(p.std()) > 0.3 * bound     # spread over U(-k, k)


def test_zero_state_shape_and_device():
    h, c = tlstm.zero_state(NL, B, H)
    assert h.shape == c.shape == (NL, B, H)
    assert not h.any() and not c.any()
