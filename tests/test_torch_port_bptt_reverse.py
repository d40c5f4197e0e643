"""The teacher-forced LSTM's backward (``models/lstm.py:_LayerSeq``) and
its reverse recurrence (``kernels/lstm_bptt.py:lstm_bptt_reverse``, the
plain version on CPU tensors) against the JAX package's: the reverse
kernel ``lstm_bptt_reverse`` in interpret mode, ``lstm_seq_tm``'s
gradients under ``GIC_BPTT_KERNEL=1`` (the kernel) and ``0`` (the scan),
each from a non-zero initial state, and two teacher-forced MLE steps
(``make_mle_step``).

Tolerance: d_pre, dh0, dc0 and gradients atol 1e-5, rtol 1e-4 (float32
products summed in another order); step metrics rtol 1e-5 and parameters
atol 1e-5, rtol 1e-4, as ``test_torch_port_steps.py`` holds them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.loader import make_batch as jmake_batch
from gan_image_captioning_tpu.kernels import lstm_bptt as jbptt
from gan_image_captioning_tpu.models import lstm as jlstm
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu.train.state import (
    create_train_state as jcreate_train_state)
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.interop import (params_from_jax,
                                                    train_state_from_jax)
from gan_image_captioning_tpu_torch.kernels import lstm_bptt
from gan_image_captioning_tpu_torch.models import lstm as tlstm
from gan_image_captioning_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

T, B, H, E, NL = 7, 3, 16, 8, 2
TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("GIC_KERNEL_INTERPRET", "1")


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_reverse_plain_matches_jax_kernel(interpret):
    rng = _rng(0)
    w_hh = _f32(rng, (H, 4 * H), 0.3)
    d_hs = _f32(rng, (T, B, H))
    gates = _f32(rng, (T, B, 4 * H))
    cs = _f32(rng, (T, B, H))
    # the cell state entering t = 0 is not zero
    c_prev = np.concatenate([_f32(rng, (1, B, H)), cs[:-1]])
    want = jax.jit(jbptt.lstm_bptt_reverse)(w_hh, d_hs, gates, c_prev, cs)
    args = [torch.from_numpy(a) for a in (w_hh, d_hs, gates, c_prev, cs)]
    before = lstm_bptt.lstm_bptt_reverse.launches
    for fn in (lstm_bptt.lstm_bptt_reverse_plain, lstm_bptt.lstm_bptt_reverse):
        got = fn(*args)
        for name, a, b in zip(("d_pre", "dh0", "dc0"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                       **TOL)
    assert lstm_bptt.lstm_bptt_reverse.launches == before   # no CPU launch


def _stack_params(rng):
    params = []
    for layer in range(NL):
        in_dim = E if layer == 0 else H
        params.append({"w_ih": _f32(rng, (4 * H, in_dim), 0.3),
                       "w_hh": _f32(rng, (4 * H, H), 0.3),
                       "b_ih": _f32(rng, (4 * H,), 0.1),
                       "b_hh": _f32(rng, (4 * H,), 0.1)})
    return params


@pytest.mark.parametrize("jax_kernel", ["1", "0"])
@pytest.mark.parametrize("plain", [False, True])
def test_lstm_seq_tm_gradients_match_jax(monkeypatch, interpret, jax_kernel,
                                         plain):
    monkeypatch.setenv("GIC_BPTT_KERNEL", jax_kernel)
    rng = _rng(1)
    params = _stack_params(rng)
    xs = _f32(rng, (T, B, E))
    h0, c0 = _f32(rng, (NL, B, H), 0.5), _f32(rng, (NL, B, H), 0.5)
    probe = _f32(rng, (T, B, H))

    def jloss(p, x, h, c):
        return jnp.sum(jlstm.lstm_seq_tm(p, x, (h, c)) * probe)

    want = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3)))(
        params, xs, h0, c0)
    tp = [{k: torch.tensor(v, requires_grad=True) for k, v in lp.items()}
          for lp in params]
    tx, th, tc = (torch.tensor(a, requires_grad=True) for a in (xs, h0, c0))
    loss = (tlstm.lstm_seq_tm(tp, tx, (th, tc), plain=plain)
            * torch.from_numpy(probe)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want[0]), **TOL)
    g_params, g_x, g_h, g_c = want[1]
    for layer, lp in enumerate(tp):
        for k, v in lp.items():
            np.testing.assert_allclose(v.grad.numpy(),
                                       np.asarray(g_params[layer][k]),
                                       err_msg=f"{layer}.{k}", **TOL)
    for name, a, b in (("xs", tx, g_x), ("h0", th, g_h), ("c0", tc, g_c)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   err_msg=name, **TOL)


V = 64
KW = dict(vocab_size=V, gen_embed_dim=8, gen_hidden_dim=16, gen_num_layers=2,
          max_seq_len=5, mle_objective="teacher", pretrain_lr=1e-2)


@pytest.fixture
def no_state_shardings():
    """The JAX step without process-wide state shardings: the ZeRO-1
    instructor test (``tests/test_parallel.py``) leaves them set on its
    worker, and the steps here run without a mesh."""
    prev = jsteps._STATE_SHARDINGS
    jsteps.set_state_shardings(None)
    yield
    jsteps.set_state_shardings(prev)


def test_teacher_mle_steps_match_jax(monkeypatch, no_state_shardings,
                                     interpret):
    monkeypatch.setenv("GIC_BPTT_KERNEL", "1")
    jconfig = JConfig(**KW)
    jstate = jcreate_train_state(jconfig, jax.random.PRNGKey(0))
    config = Config(**KW)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 config)
    rng = _rng(2)
    caps = [rng.integers(4, V, size=rng.integers(1, 6)) for _ in range(B)]
    jbatch = {k: jnp.asarray(v) for k, v in
              jmake_batch(caps, None, config.seq_len).items()}
    batch = tsteps.batch_to(make_batch(caps, None, config.seq_len), "cpu")
    jmle, mle = jsteps.make_mle_step(jconfig), tsteps.make_mle_step(config)
    for i in range(2):
        jstate, jm = jmle(jstate, jbatch)
        state, m = mle(state, batch)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i}: {k}")
        want = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      jstate.gen_params))
        for k, v in state.gen.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       err_msg=f"step {i}: {k}", **TOL)
