"""The port's SCST (``train/scst.py``, ``--scst-epochs``) against the JAX
package's on the CPU.

* Rewards: ``sentence_bleu`` and ``CiderScorer`` give the JAX values on
  the same id rows; so do ``batch_advantage``, ``batch_reward`` and
  ``build_row_references`` (single and multi-reference, synthetic and
  mini-COCO).
* Rollout: fed the Gumbel draws of the JAX key chain
  (``rng, key = split(rng)`` per step, as
  ``test_torch_port_sample_decode.py`` feeds them), the sampled and greedy
  ids equal the JAX rollout's (weights scaled by ``PEAK`` as in
  ``test_torch_port_beam.py``, so that no step is a near-tie).
* log π: the port's differentiable ``sequence_logprob`` (the LSTM's
  rescore, the transformer's causal pass) equals the JAX
  ``eval/decode.sequence_logprob`` (a stepper scan) within 1e-5, and so do
  its gradients, the embedding's included: the fed-back embedding rows
  take gradient in both (``models/generator.py:rescore``).
* One update, from ``train_state_from_jax`` of the same JAX state with the
  same sampled ids and advantage: loss, gradients and updated generator
  parameters within 1e-5 of the JAX update's, LSTM and transformer; a
  zero advantage changes no parameter.
* The phase end to end (CIDEr, BLEU, ``--scst-multi-ref``): SCST scalars
  logged, ``scst_model.ckpt`` written and served by the port."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.coco import CocoCaptions as JCoco
from gan_image_captioning_tpu.data.synthetic import (
    SyntheticCaptions as JSynthetic)
from gan_image_captioning_tpu.eval import bleu as jbleu
from gan_image_captioning_tpu.eval import cider as jcider
from gan_image_captioning_tpu.eval import decode as jdecode
from gan_image_captioning_tpu.models import api as japi
from gan_image_captioning_tpu.train import scst as jscst
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu.train.state import (
    create_train_state as jcreate_train_state)
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch import main as tmain
from gan_image_captioning_tpu_torch import serve
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.coco import CocoCaptions
from gan_image_captioning_tpu_torch.data.synthetic import SyntheticCaptions
from gan_image_captioning_tpu_torch.data.vocab import END
from gan_image_captioning_tpu_torch.eval import bleu as tbleu
from gan_image_captioning_tpu_torch.eval import cider as tcider
from gan_image_captioning_tpu_torch.models import api
from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib
from gan_image_captioning_tpu_torch.train import scst
from gan_image_captioning_tpu_torch.train.state import trainable_parameters
from gan_image_captioning_tpu_torch.train.steps import _grads

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

B, PEAK = 8, 8.0
TOL = dict(atol=1e-5, rtol=1e-5)
MINI_COCO = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "mini_coco")


@pytest.fixture
def no_state_shardings():
    """No process-wide JAX state shardings: the ZeRO-1 instructor test
    (``tests/test_parallel.py``) leaves them set on its worker."""
    prev = jsteps._STATE_SHARDINGS
    jsteps.set_state_shardings(None)
    yield
    jsteps.set_state_shardings(prev)


# ------------------------------------------------------------------ rewards

def _rows(seed, n=24, vocab=30):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(3, vocab, size=int(rng.integers(0, 9))))
            for _ in range(n)]


def test_sentence_bleu_matches_jax():
    cands, refs = _rows(0), _rows(1)
    extra = _rows(2)
    for c, r, r2 in zip(cands, refs, extra):
        for ref_set in ([r], [r, r2], [r2, c], []):
            assert tbleu.sentence_bleu(c, ref_set) == \
                jbleu.sentence_bleu(c, ref_set)


def test_cider_scorer_matches_jax():
    corpus = [[r] for r in _rows(3, n=40)] + [_rows(4, n=3)]
    t, j = tcider.CiderScorer(corpus), jcider.CiderScorer(corpus)
    for c, refs in zip(_rows(5, n=40), corpus):
        assert t.score(c, refs) == j.score(c, refs)


def _batch_rows(seed, T=11):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 30, size=(B, T)).astype(np.int32)
    ids[:, 5] = np.where(rng.random(B) < 0.5, END, ids[:, 5])
    return ids


@pytest.mark.parametrize("reward", ["cider", "bleu"])
@pytest.mark.parametrize("multi", [False, True])
def test_advantage_and_reward_match_jax(reward, multi):
    kw = dict(scst_reward=reward, scst_multi_ref=multi)
    train_t = SyntheticCaptions("train", num_items=32)
    train_j = JSynthetic("train", num_items=32)
    refs_t = scst.build_row_references(train_t, multi)
    refs_j = jscst.build_row_references(train_j, multi)
    assert refs_t == refs_j
    fn_t = scst.build_reward_fn(Config(**kw), train_t,
                                refs_t if multi else None)
    fn_j = jscst.build_reward_fn(JConfig(**kw), train_j,
                                 refs_j if multi else None)
    sampled, greedy, caps = _batch_rows(6), _batch_rows(7), _batch_rows(8)
    index = np.arange(3, 3 + B)
    weights = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
    for row_refs_t, row_refs_j, idx in ((None, None, None),
                                        (refs_t, refs_j, index)):
        got = scst.batch_advantage(fn_t, sampled, greedy, caps,
                                   row_refs=row_refs_t, index=idx)
        want = jscst.batch_advantage(fn_j, sampled, greedy, caps,
                                     row_refs=row_refs_j, index=idx)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert (scst.batch_reward(fn_t, greedy, caps, row_refs_t, idx,
                                  weights)
                == jscst.batch_reward(fn_j, greedy, caps, row_refs_j, idx,
                                      weights))


def test_multi_ref_row_references_match_jax_on_mini_coco():
    tds = CocoCaptions(os.path.join(MINI_COCO, "dataset_coco.json"),
                       MINI_COCO, "train", 48, captions_per_image=5,
                       conditional=False)
    jds = JCoco(os.path.join(MINI_COCO, "dataset_coco.json"), MINI_COCO,
                "train", 48, captions_per_image=5, conditional=False)
    for multi in (False, True):
        got = scst.build_row_references(tds, multi)
        assert got == jscst.build_row_references(jds, multi)
        assert all(len(r) == (5 if multi else 1) for r in got)


# ---------------------------------------------------------------- programs

KW = dict(vocab_size=37, gen_embed_dim=12, gen_hidden_dim=16,
          gen_num_layers=2, gen_num_heads=2, max_seq_len=9, scst_lr=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(arch, **kw):
    kw = dict(KW, gen_arch=arch, **kw)
    if arch == "transformer":
        kw.update(gen_embed_dim=16, gen_hidden_dim=32)
    return JConfig(**kw), Config(device="cpu", **kw)


def _models(arch, peak=1.0, seed=0):
    """``(JAX params, JAX config, port generator, port config)``."""
    jconfig, config = _configs(arch)
    gp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a) * peak,
        japi.init_generator(jax.random.PRNGKey(seed), jconfig))
    conv = (interop.transformer_generator_from_jax if arch == "transformer"
            else interop.generator_from_jax)
    return gp, jconfig, conv(_np(gp), config), config


def _batch(config):
    caps = _batch_rows(9, config.seq_len)
    return ({"captions": jnp.asarray(caps),
             "weights": jnp.ones((B,), jnp.float32)},
            {"captions": torch.from_numpy(caps),
             "weights": torch.ones(B)})


def jax_rollout_noise(key, T, V):
    """The Gumbel draws JAX's ``sample_decode`` makes from ``key``."""
    rng, k = jax.random.split(key)
    out = []
    for _ in range(T):
        out.append(np.asarray(jax.random.gumbel(k, (B, V), jnp.float32)))
        rng, k = jax.random.split(rng)
    return torch.from_numpy(np.stack(out))


@pytest.mark.parametrize("arch", ["lstm", "transformer"])
def test_rollout_ids_match_jax(arch):
    gp, jconfig, gen, config = _models(arch, PEAK)
    jbatch, tbatch = _batch(config)
    jroll, _, jgreedy_only = jscst.make_scst_programs(jconfig)
    roll, _, greedy_only = scst.make_scst_programs(config)
    for seed in (1, 2):
        k1 = jax.random.PRNGKey(seed)
        want_s, want_g = jroll(gp, jbatch, k1)
        noise = jax_rollout_noise(k1, config.seq_len, config.vocab_size)
        got_s, got_g = roll(gen, tbatch, None, noise=noise)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    assert not np.array_equal(got_s.numpy(), got_g.numpy())
    np.testing.assert_array_equal(greedy_only(gen, tbatch).numpy(),
                                  np.asarray(jgreedy_only(gp, jbatch)))


def test_rollout_noise_is_seeded_by_seed_and_step():
    _, _, gen, config = _models("lstm", PEAK)
    _, tbatch = _batch(config)
    roll, _, _ = scst.make_scst_programs(config)

    def draw(seed, step):
        return roll(gen, tbatch, scst.rollout_generator(seed, step,
                                                        "cpu"))[0]

    assert torch.equal(draw(5, 3), draw(5, 3))
    assert not torch.equal(draw(5, 3), draw(5, 4))
    assert not torch.equal(draw(5, 3), draw(6, 3))


def _sampled(gp, jconfig, jbatch):
    roll, _, _ = jscst.make_scst_programs(jconfig)
    return np.array(roll(gp, jbatch, jax.random.PRNGKey(4))[0])


@pytest.mark.parametrize("arch", ["lstm", "transformer"])
def test_sequence_logprob_and_gradients_match_jax(arch):
    gp, jconfig, gen, config = _models(arch)
    jbatch, tbatch = _batch(config)
    ids = _sampled(gp, jconfig, jbatch)
    probe = np.linspace(-1.0, 1.0, B).astype(np.float32)

    def jloss(p):
        feats = japi.generator_condition(jconfig, p, jbatch,
                                       False)[0]["features"]
        lp = jdecode.sequence_logprob(p, feats, jnp.asarray(ids), jconfig)
        return jnp.sum(lp * probe), lp

    (_, want_lp), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        gp)
    feats = api.generator_condition(config, gen, tbatch)[0]["features"]
    lp = scst.sequence_logprob(config, gen, feats, torch.from_numpy(ids))
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(want_lp),
                               **TOL)
    grads, = _grads((lp * torch.from_numpy(probe)).sum(), gen)
    flat = (interop._transformer_gen_params(want_g) if arch == "transformer"
            else interop.params_from_jax(want_g))
    assert grads.keys() == flat.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), flat[k].numpy(), err_msg=k,
                                   **TOL)
    embed = "decoder.embed.weight" if arch == "lstm" else "decoder.embed"
    # the feedback path reaches the embedding beyond the <S> row
    fed = np.unique(ids[:, :-1])
    assert np.abs(grads[embed].numpy()[fed]).max() > 0


def _update_pair(arch, advantage):
    """The JAX update and the port's from one state, ids and advantage →
    ``(JAX state, JAX loss, port state, port loss)``."""
    jconfig, config = _configs(arch)
    jstate = jcreate_train_state(jconfig, jax.random.PRNGKey(0))
    state = interop.train_state_from_jax(_np(jstate), config)
    jbatch, tbatch = _batch(config)
    ids = _sampled(jstate.gen_params, jconfig, jbatch)
    adv = np.asarray(advantage, np.float32)
    _, jupdate, _ = jscst.make_scst_programs(jconfig)
    jnew, jloss = jupdate(jstate, jbatch, jnp.asarray(ids), jnp.asarray(adv),
                          jax.random.PRNGKey(2))
    _, update, _ = scst.make_scst_programs(config)
    state, tloss = update(state, tbatch, torch.from_numpy(ids),
                          torch.from_numpy(adv))
    return _np(jnew), float(jloss), state, float(tloss)


@pytest.mark.parametrize("arch", ["lstm", "transformer"])
def test_one_update_matches_jax(no_state_shardings, arch):
    adv = np.linspace(-0.8, 1.2, B)
    jnew, jloss, state, loss = _update_pair(arch, adv)
    np.testing.assert_allclose(loss, jloss, **TOL)
    want = interop.train_state_from_jax(jnew, _configs(arch)[1])
    moved = 0
    for k, p in trainable_parameters(state.gen).items():
        w = trainable_parameters(want.gen)[k]
        np.testing.assert_allclose(p.detach().numpy(), w.detach().numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(state.gen_opt.mu[k].numpy(),
                                   want.gen_opt.mu[k].numpy(), err_msg=k,
                                   **TOL)
        moved += int(torch.count_nonzero(state.gen_opt.mu[k]))
    assert moved > 0
    assert state.gen_steps == want.gen_steps == 1
    assert state.gen_opt.count == want.gen_opt.count == 1
    assert state.pretrain_opt.count == 0          # the gen chain only


@pytest.mark.parametrize("arch", ["lstm", "transformer"])
def test_zero_advantage_is_a_no_op(no_state_shardings, arch):
    jconfig, config = _configs(arch)
    jstate = jcreate_train_state(jconfig, jax.random.PRNGKey(0))
    state = interop.train_state_from_jax(_np(jstate), config)
    before = {k: v.clone() for k, v in state.gen.state_dict().items()}
    _, tbatch = _batch(config)
    roll, update, _ = scst.make_scst_programs(config)
    sampled, _ = roll(state.gen, tbatch, scst.rollout_generator(0, 0, "cpu"))
    state, loss = update(state, tbatch, sampled, torch.zeros(B))
    assert float(loss) == 0.0
    for k, v in state.gen.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert state.gen_steps == 1


# -------------------------------------------------------------- the phase

FLAGS = ["--dataset", "synthetic", "--synthetic-items", "16",
         "--gen-embed-dim", "12", "--gen-hidden-dim", "16",
         "--gen-num-layers", "1", "--max-seq-len", "7",
         "--pre-train-batch-size", "8", "--pre-eval-batch-size", "8",
         "--adv-train-batch-size", "8", "--adv-eval-batch-size", "8",
         "--device", "cpu"]


@pytest.mark.parametrize("extra", [[], ["--scst-reward", "bleu"],
                                   ["--scst-multi-ref", "--scst-lr", "1e-3"]],
                         ids=["cider", "bleu", "multi_ref"])
def test_scst_phase_writes_and_serves_scst_model(tmp_path, extra):
    inst = tmain.main([*FLAGS, "--pretrain-epochs", "1", "--scst-epochs",
                       "2", "--adv-epochs", "0", *extra, "--save-dir",
                       str(tmp_path), "--expt-name", "scst"])
    assert inst._scst_step == 4 and inst.state.gen_steps == 4
    assert inst.state.gen_opt.count == 4
    with open(os.path.join(inst.config.save_dir, "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    rewards = [r["value"] for r in rows if r["tag"] == "SCST_val_reward"]
    losses = [r["value"] for r in rows if r["tag"] == "SCST_train_loss"]
    assert len(rewards) == len(losses) == 2
    assert all(np.isfinite(rewards + losses))
    path = os.path.join(inst.config.model_dir, "scst_model.ckpt")
    gen, disc = ckpt_lib.load_generator_checkpoint(path, inst.config)
    assert disc is None
    service = serve.CaptionService(serve.parse_args(
        ["--checkpoint", path, *FLAGS]))
    try:
        resp = service.handle_request({"n": 2})
    finally:
        service.close()
    assert len(resp["captions"]) == 2 and all(np.isfinite(resp["logprobs"]))
