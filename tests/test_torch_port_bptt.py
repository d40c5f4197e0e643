"""The port's ``lstm_bptt_chain`` (its plain version on CPU tensors)
against the JAX package's chained BPTT kernel run in interpret mode, on
the same random weights, cotangents, gates and cell states, for 1-, 2- and
3-layer stacks.

Tolerance: atol = rtol = 1e-5 (float32; the products of the recurrence
sum in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.kernels.lstm_bptt import (
    lstm_bptt_chain as jchain)
from gan_image_captioning_tpu_torch.kernels.lstm_bptt import (
    lstm_bptt_chain, lstm_bptt_chain_plain)

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

T, B, H = 6, 3, 16


def _inputs(nl, seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return (f(nl, H, 4 * H, scale=0.3), f(max(nl - 1, 1), H, 4 * H, scale=0.3),
            f(T, B, H), f(T, nl, B, 4 * H), f(T, nl, B, H))


@pytest.mark.parametrize("nl", [1, 2, 3])
def test_chain_matches_jax_kernel(nl):
    args = _inputs(nl, seed=nl)
    want = np.asarray(jchain(*map(jnp.asarray, args)))
    got = lstm_bptt_chain(*map(torch.from_numpy, args))
    assert got.shape == (T, nl, B, 4 * H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_cpu_call_is_the_plain_version_and_counts_no_launch():
    args = [torch.from_numpy(a) for a in _inputs(2)]
    before = lstm_bptt_chain.launches
    assert torch.equal(lstm_bptt_chain(*args), lstm_bptt_chain_plain(*args))
    assert lstm_bptt_chain.launches == before


def test_rejects_bad_inputs():
    w_hhs, w_ihs, d_hs, gates, cs = [torch.from_numpy(a)
                                     for a in _inputs(2)]
    with pytest.raises(TypeError):
        lstm_bptt_chain(w_hhs, w_ihs, d_hs.double(), gates, cs)
    with pytest.raises(ValueError):
        lstm_bptt_chain(w_hhs, w_ihs, d_hs[:, :2].contiguous(), gates, cs)
    with pytest.raises(ValueError):
        lstm_bptt_chain(w_hhs, w_ihs, d_hs, gates, cs.transpose(2, 3)
                        .contiguous().transpose(2, 3))
    with pytest.raises(ValueError):
        lstm_bptt_chain(w_hhs, w_ihs[:, :, :8].contiguous(), d_hs, gates, cs)
    with pytest.raises(ValueError):
        lstm_bptt_chain(w_hhs, w_ihs, d_hs.to("meta"), gates.to("meta"),
                        cs.to("meta"))
