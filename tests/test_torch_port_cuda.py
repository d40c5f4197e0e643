"""The port's CUDA decode kernel against its plain PyTorch version, on the
card.  Every test skips without CUDA.  This file imports torch and the port
only, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch.kernels.decode_sample import (
    decode_sample, decode_sample_plain)

LP_ATOL = 1e-4  # float32 sums in another order than the plain version's


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _weights(rng, V, E, H, nl, device):
    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(device)

    k = 1.0 / np.sqrt(H)
    layers = [{"w_ih": t(4 * H, E if l == 0 else H, scale=k),
               "w_hh": t(4 * H, H, scale=k), "b_ih": t(4 * H, scale=k),
               "b_hh": t(4 * H, scale=k)} for l in range(nl)]
    return layers, t(V, H, scale=k), t(V, scale=0.1), t(V, E)


# odd shapes: a batch tile edge (33), a vocabulary tile edge (300 = 4*64 + 44),
# E != H (the layer-0 [x | h] split inside a K tile), H % 4 != 0
@pytest.mark.parametrize("B,V,E,H,nl,T", [(1, 300, 48, 40, 2, 7),
                                          (5, 256, 32, 32, 1, 9),
                                          (33, 300, 48, 42, 3, 6)])
def test_kernel_matches_plain(device, B, V, E, H, nl, T):
    rng = np.random.default_rng(B * 1000 + V)
    layers, w, b, emb = _weights(rng, V, E, H, nl, device)
    feats = torch.from_numpy(rng.standard_normal((B, E)).astype(
        np.float32)).to(device)
    ids, lps = decode_sample(feats, layers, w, b, emb, T, mode="serve")
    ids_p, lps_p = decode_sample_plain(feats, layers, w, b, emb, T)
    torch.cuda.synchronize()
    assert torch.equal(ids, ids_p)
    torch.testing.assert_close(lps, lps_p, atol=LP_ATOL, rtol=0)
    assert torch.equal(decode_sample(feats, layers, w, b, emb, T), ids)


def test_argmax_ties_take_the_first_index(device):
    """Equal logits inside one vocabulary tile and across tiles: the kernel
    keeps the lowest index, as torch.argmax and jnp.argmax do."""
    V, E, H, T = 300, 16, 16, 3
    rng = np.random.default_rng(0)
    layers, _, _, emb = _weights(rng, V, E, H, 1, device)
    w = torch.zeros(V, H, device=device)
    b = torch.zeros(V, device=device)
    b[[5, 200, 299]] = 2.0          # tie across tiles 0, 3 and 4
    feats = torch.zeros(1, E, device=device)
    ids, lps = decode_sample(feats, layers, w, b, emb, T, mode="serve")
    assert ids.tolist() == [[5] * T]
    b[[70, 71]] = 3.0               # tie inside tile 1, above the others
    ids, _ = decode_sample(feats, layers, w, b, emb, T, mode="serve")
    ids_p, lps_p = decode_sample_plain(feats, layers, w, b, emb, T)
    assert ids.tolist() == ids_p.tolist() == [[70] * T]


def test_counts_launches_and_rejects_bad_inputs(device):
    V, E, H, T = 128, 16, 16, 4
    rng = np.random.default_rng(1)
    layers, w, b, emb = _weights(rng, V, E, H, 1, device)
    feats = torch.zeros(2, E, device=device)
    before = decode_sample.launches
    decode_sample(feats, layers, w, b, emb, T)
    assert decode_sample.launches == before + 1
    with pytest.raises(TypeError):
        decode_sample(feats.double(), layers, w, b, emb, T)
    with pytest.raises(ValueError):
        decode_sample(feats, layers, w.T.contiguous().T, b, emb, T)
    with pytest.raises(ValueError):
        decode_sample(feats, layers, w, b.cpu(), emb, T)
    assert decode_sample.launches == before + 1
