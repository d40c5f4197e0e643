"""``--adv-objective reinforce --dtype bfloat16`` on the CPU against the
JAX package's ``reinforce_losses``, which casts the models and the batch
to bfloat16 (``_compute_cast``): the sampled ids, both losses, the mean
reward and both gradient sets, with every draw of the JAX function
reproduced from its keys (the sample's, the rollouts' in the bfloat16
logits' dtype, the dropout masks) and the same weights.

* config4's transformer generator and discriminator at small width,
  through the port's kernel route (flash attention, the fused sampler)
  and its plain route (dense attention, the plain Gumbel draw);
* config3's LSTM generator and CNN discriminator at small width: the
  REINFORCE losses ran in float32 in the port before (no compute cast;
  the step the JAX package runs in bfloat16), so the test checks that
  every kernel wrapper of the step is handed bfloat16 and that the
  results are not the float32 step's;
* ``main.py --preset config4 --dtype bfloat16`` (REINFORCE) at tiny
  width, with and without ``Config.bf16_mu``: an epoch of each phase,
  full-state snapshots loaded back.

The discriminator is drawn with ``disc_init="normal"`` and its output
weights scaled by DISC_GAIN on both sides (``torch_bf16_parity.
sharpened``): at the default initialization it scores every sequence
alike, the advantages lie below a bfloat16 step of a reward, and the
generator's loss and gradients are rounding.  Here the advantages are
0.1-0.5, far above a reward's bfloat16 step (2^-9), so the generator loss
is held in LOSS_UNITS of its own size and every generator gradient in
GRAD_UNITS of its own largest entry, with no fallback to the float32
step (``grad_misses(fallback=False)``); the discriminator's side keeps
the rules of ``tests/torch_bf16_parity.py``.

A bfloat16 log-softmax or sigmoid moves the step by less than those
units, so the two float32 points of the JAX function are checked where
they are computed (:func:`_point_misses`): the log-probabilities of the
sampled ids (``log_softmax(logits.astype(float32))``) and the
discriminator's probabilities of the sample and of the greedy baseline
(``sigmoid(logits.astype(float32))``), each against the JAX package's
within what the two packages' bfloat16 inputs allow, a control with the
port's own inputs run through a bfloat16 log-softmax (and, for the
transformer's discriminator, a bfloat16 sigmoid) outside it.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.models import api as japi
from gan_image_captioning_tpu.train import reinforce as jrl
from gan_image_captioning_tpu_torch.models import api as tapi
from gan_image_captioning_tpu_torch.train import reinforce as trl
from gan_image_captioning_tpu_torch.train import steps as tsteps
from torch_bf16_parity import (B, BF, F32_FLOOR, V, env,  # noqa: F401
                               f32, grad_misses, jax_adv, keeps, replay_ids,
                               sample_uniforms, setup, spy_dtypes,
                               value_misses)

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

# config3's models at small width (the LSTM generator, the CNN
# discriminator), as tests/test_torch_port_bf16_steps.py builds them
LSTM_KW = dict(gen_arch="lstm", disc_arch="cnn", gen_embed_dim=8,
               gen_hidden_dim=16, disc_embed_dim=8, disc_num_rep=4,
               disc_filter_sizes=(2, 3), disc_num_filters=(5, 6),
               max_seq_len=4, rollout_stride=2)
# the discriminator the generator's side is held under (module docstring)
SHARP = dict(disc_init="normal")
DISC_GAIN = 10.0


@pytest.fixture(autouse=True)
def own_jax_states(monkeypatch):
    """``torch_bf16_parity.jax_state`` caches a JAX initial state per
    architecture and seed, not per ``disc_init``: the states drawn here
    (``SHARP``) are kept apart from those another file on the same worker
    drew with the default initialization, in both directions."""
    import torch_bf16_parity

    monkeypatch.setattr(torch_bf16_parity, "_JSTATES", {})


def _noise(config, route, key):
    """The draws of the JAX ``reinforce_losses(rng=key, train=True)``: the
    sample's (zeros for the LSTM: the interpret-mode decode draws zero
    uniforms), the rollouts' (``add_gumbel``: bfloat16), the dropout
    masks."""
    r_sample, r_roll, r_d1, r_d2, _ = jax.random.split(key, 5)
    t = config.seq_len
    p = len(range(config.rollout_stride, t, config.rollout_stride))
    u = (torch.zeros(t, B, V) if config.gen_arch == "lstm"
         else sample_uniforms(route, r_sample, t, B))
    rows = B * config.rollout_num
    return {"uniforms": u,
            "rollout_uniforms": [sample_uniforms("plain", k, t, rows)
                                 for k in jax.random.split(r_roll, p)],
            "keep": keeps(config, (r_d1, r_d2)), "seed": 0}


def _record_port_points(m, seen):
    """Record the inputs and outputs of both float32 points of the port's
    REINFORCE forward into ``seen``: every ``[B, T, V]`` log-softmax
    (``logits``: ``(input, output)``) and every ``_disc_prob`` (``disc``:
    ``(float32 logits, probability)``, the logits taken again by the same
    call)."""
    real_ls, real_dp = torch.log_softmax, trl._disc_prob

    def log_softmax(x, *args, **kwargs):
        out = real_ls(x, *args, **kwargs)
        if x.dim() == 3:
            seen["logits"].append((x.detach(), out.detach()))
        return out

    def disc_prob(config, disc_params, ids):
        logits = tapi.discriminator_apply(disc_params, ids, config,
                                          train=False).float()
        prob = real_dp(config, disc_params, ids)
        seen["disc"].append((logits, prob))
        return prob

    m.setattr(torch, "log_softmax", log_softmax)
    m.setattr(trl, "_disc_prob", disc_prob)


def _record_jax_points(m, seen):
    """:func:`_record_port_points` for the JAX package's forward (traced
    values, returned through the loss's aux)."""
    real_ls, real_dp = jax.nn.log_softmax, jrl._disc_prob

    def log_softmax(x, *args, **kwargs):
        out = real_ls(x, *args, **kwargs)
        if x.ndim == 3:
            seen["logits"].append((x, out))
        return out

    def disc_prob(config, disc_params, ids):
        logits = japi.discriminator_apply(disc_params, ids, config, None,
                                          train=False).astype(jnp.float32)
        prob = real_dp(config, disc_params, ids)
        seen["disc"].append((logits, prob))
        return prob

    m.setattr(jax.nn, "log_softmax", log_softmax)
    m.setattr(jrl, "_disc_prob", disc_prob)


def _points(seen):
    """The log-softmax of the log-probability pass (the last) and the
    discriminator's probabilities of the sample (the first call) and of
    the greedy baseline (the last): the rollouts' calls sit in the JAX
    package's ``lax.map`` body, out of reach."""
    return {"logits": seen["logits"][-1],
            "disc": [seen["disc"][0], seen["disc"][-1]]}


def _tensor(x):
    return torch.from_numpy(np.array(f32(x)))


def _point_misses(config, ids, port, jax_pts, control=None):
    """The port's float32 points against the JAX package's.  log π of the
    sampled ids: within twice the largest difference of the two packages'
    bfloat16 logits in its row (a log-softmax moves by at most twice the
    largest move of its inputs), plus F32_FLOOR of the largest |log π|
    (float32 rounding).  Each probability: within a quarter of the largest
    difference of its logits (the sigmoid's slope is at most 1/4), plus
    F32_FLOOR.  ``control``: ``"log_softmax"`` or ``"sigmoid"`` recomputes
    that point of the port in bfloat16 from the port's own logits."""
    idx = ids.long()[..., None]
    logits, logp = port["logits"]
    jlogits, jlogp = (_tensor(x) for x in jax_pts["logits"])
    if control == "log_softmax":
        logp = torch.log_softmax(logits.to(BF), dim=-1).float()
    got = logp.gather(-1, idx)[..., 0]
    want = jlogp.gather(-1, idx)[..., 0]
    bound = (2 * (logits - jlogits).abs().amax(dim=-1)
             + F32_FLOOR * float(want.abs().max()))
    out = [f"log pi: {int(((got - want).abs() > bound).sum())} entries"
           f" past the bound"] if ((got - want).abs() > bound).any() else []
    per = tapi.disc_logits_per_sample(config)
    for tag, (lg, prob), (jlg, jprob) in zip(("sample", "greedy"),
                                             port["disc"], jax_pts["disc"]):
        if control == "sigmoid":
            prob = torch.sigmoid(lg.to(BF)).float().reshape(-1, per).mean(-1)
        jlg, jprob = _tensor(jlg), _tensor(jprob)
        bound = 0.25 * (lg - jlg).abs().reshape(-1, per).amax(-1) + F32_FLOOR
        if ((prob - jprob).abs() > bound).any():
            out.append(f"{tag} probability: {(prob - jprob).tolist()} past"
                       f" {bound.tolist()}")
    return out


def _check(env, route, key, over, sigmoid_control):
    """The port's REINFORCE losses, gradients and float32 points against
    the JAX package's (and the float32 step's for the discriminator's
    fallback) → the set of ``(wrapper, dtype)`` the port's kernel
    wrappers were handed."""
    jconfig, config, jstate, state, ref, jbatch, batch = setup(
        env, route, adv_objective="reinforce", disc_gain=DISC_GAIN,
        **SHARP, **over)
    jseen = {"logits": [], "disc": []}

    def losses(gp, dp):
        g, d, aux = jrl.reinforce_losses(jconfig, gp, dp, jbatch, key, 1.0,
                                         True)
        return g, d, dict(aux, points=_points(jseen))

    with pytest.MonkeyPatch.context() as m:
        _record_jax_points(m, jseen)
        g_loss, d_loss, aux, jgg, jdg = jax_adv(losses, jstate)
    noise = _noise(config, route, key)
    replay = replay_ids(env, aux["gen_ids"]) if route == "plain" else None
    seen, pseen = spy_dtypes(env), {"logits": [], "disc": []}
    with pytest.MonkeyPatch.context() as m:
        _record_port_points(m, pseen)
        got = tsteps.adv_grads(config, state, batch, 1.0, noise)
    seen = set(seen)
    if replay is not None:
        replay.step = 0
    got32 = tsteps.adv_grads(config.replace(dtype="float32"), ref, batch,
                             1.0, noise)
    ids = got[4]["gen_ids"]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(aux["gen_ids"]))
    misses = value_misses({
        "g_loss": (got[0], g_loss), "d_loss": (got[1], d_loss),
        "mean_reward": (got[4]["mean_reward"], aux["mean_reward"])},
        "reinforce")
    misses += grad_misses(config, got[2], got32[2], jgg, "gen", True,
                          fallback=False)
    misses += grad_misses(config, got[3], got32[3], jdg, "disc", False)
    port_pts, jax_pts = _points(pseen), aux["points"]
    misses += _point_misses(config, ids, port_pts, jax_pts)
    misses = [x for x in misses if x]
    assert not misses, misses
    # the checks see a float32 point computed in bfloat16
    assert _point_misses(config, ids, port_pts, jax_pts, "log_softmax")
    if sigmoid_control:
        assert _point_misses(config, ids, port_pts, jax_pts, "sigmoid")
    # a bfloat16 computation, not the float32 step's
    assert float(got[1]) != float(got32[1])
    for side in (2, 3):
        assert any(not torch.equal(got[side][k], got32[side][k])
                   for k in got[side])
    return seen


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_transformer_reinforce_matches_jax(env, route):
    """REINFORCE with rollouts and the greedy baseline, config4's
    transformer generator and discriminator."""
    seen = _check(env, route, jax.random.PRNGKey(6), {}, True)
    assert seen == ({("flash_attention", BF), ("gumbel_sample", BF)}
                    if route == "kernel" else set()), seen


def test_lstm_reinforce_runs_in_the_compute_cast(env):
    """config3's LSTM generator and CNN discriminator: the sample, the
    greedy baseline, the reverse BPTT of the log-probability pass and the
    conv banks are handed bfloat16 and the losses, gradients and float32
    points match the JAX package's bfloat16 step.  (No sigmoid control:
    the CNN's logits of the two packages part by several bfloat16 steps,
    more than a bfloat16 sigmoid moves a probability.)"""
    seen = _check(env, "kernel", jax.random.PRNGKey(8), LSTM_KW, False)
    assert {dt for _, dt in seen} == {BF}, seen
    assert {"decode_sample", "lstm_bptt_reverse", "disc_conv"} <= {
        fn for fn, _ in seen}, seen


LOOP_FLAGS = ["--preset", "config4", "--dataset", "synthetic",
              "--synthetic-items", "16", "--gen-embed-dim", "16",
              "--gen-hidden-dim", "16", "--gen-num-layers", "1",
              "--gen-num-heads", "2", "--disc-embed-dim", "8",
              "--disc-hidden-dim", "16", "--disc-num-heads", "2",
              "--disc-num-layers", "1", "--max-seq-len", "6",
              "--rollout-num", "2", "--rollout-stride", "3",
              *(x for f in ("pre-train", "pre-eval", "adv-train", "adv-eval")
                for x in (f"--{f}-batch-size", "8")),
              "--pretrain-epochs", "1", "--adv-epochs", "1",
              "--checkpoint-every", "1", "--dtype", "bfloat16",
              "--device", "cpu", "--num-workers", "0",
              "--device-prefetch", "0"]


@pytest.mark.parametrize("bf16_mu", [False, True])
def test_main_config4_bfloat16_trains_snapshots_and_reloads(
        monkeypatch, tmp_path, bf16_mu):
    """``main.py --preset config4 --dtype bfloat16`` with and without
    ``Config.bf16_mu`` (a field, as the JAX ``GIC_BF16_MU`` is no flag):
    one pretrain and one REINFORCE epoch, every logged value finite, a
    full-state snapshot loaded back with bfloat16 first moments under
    ``bf16_mu`` (float32 otherwise) and float32 masters."""
    from gan_image_captioning_tpu_torch import main as tmain
    from gan_image_captioning_tpu_torch.train import checkpoint as ckpt
    from gan_image_captioning_tpu_torch.train.state import create_train_state

    real = tmain.config_from_args
    monkeypatch.setattr(tmain, "config_from_args",
                        lambda args: real(args).replace(bf16_mu=bf16_mu))
    inst = tmain.main([*LOOP_FLAGS, "--save-dir", str(tmp_path),
                       "--expt-name", "bf16"])
    assert inst.config.dtype == "bfloat16"
    assert inst.config.adv_objective == "reinforce"
    assert inst.pretrain_steps > 0 and inst.state.gen_steps > 0
    rows = [json.loads(ln) for ln in
            open(Path(inst.config.save_dir) / "metrics.jsonl")]
    assert rows and all(np.isfinite(r["value"]) for r in rows)
    snaps = sorted(Path(inst.config.model_dir).glob("state_*.ckpt"))
    assert snaps
    back = ckpt.load_state(str(snaps[-1]), create_train_state(inst.config,
                                                              0))
    want = torch.bfloat16 if bf16_mu else torch.float32
    assert all(v.dtype == want for opt in (back.pretrain_opt, back.gen_opt,
                                           back.disc_opt)
               for v in opt.mu.values())
    assert all(p.dtype == torch.float32 for m in (back.gen, back.disc)
               for p in m.parameters())
