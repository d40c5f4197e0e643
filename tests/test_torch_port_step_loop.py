"""The step options in the port's training loop (``main.py`` →
``train/instructor.py``) on the CPU, at tiny widths:

* ``--steps-per-call 3`` (4 batches an epoch: a group of 3 and one of 1)
  ends bit-equal to per-batch stepping, its metrics too; an interrupt
  lands after the group in flight, and the resumed run ends bit-equal;
* ``--ema-decay``: ``pretrained_model_ema.ckpt`` / ``adv_model_ema.ckpt``
  beside the best-val saves, in the reference layout, served by
  ``serve.py`` and captioned by ``caption.py``; the full state carries the
  EMA (a state file without it, written before the EMA existed, loads
  into a run without EMA; a mismatch raises); ``train_state_from_jax`` carries the
  JAX ``ema_gen_params``;
* ``--profile-dir``: a Chrome trace of adversarial epoch 0;
* ``--debug-nans``: ``FloatingPointError`` naming the non-finite loss, the
  module output or the backward function, with the anomaly mode and the
  hooks put back when the run ends;
* ``--length-buckets`` / ``--precollate`` reach the four loaders, and a
  bucketed run trains.

Tolerance: bit-equal (``torch.equal``) wherever two runs of the port are
compared; the EMA against JAX atol 1e-6."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.train.state import (
    create_train_state as jcreate_train_state)
from gan_image_captioning_tpu_torch import caption as tcaption
from gan_image_captioning_tpu_torch import interop
from gan_image_captioning_tpu_torch import main as tmain
from gan_image_captioning_tpu_torch import serve
from gan_image_captioning_tpu_torch.config import (Config, build_parser,
                                                   config_from_args)
from gan_image_captioning_tpu_torch.data.synthetic import SyntheticCaptions
from gan_image_captioning_tpu_torch.models import api
from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib
from gan_image_captioning_tpu_torch.train import steps as tsteps
from gan_image_captioning_tpu_torch.train.instructor import GANInstructor
from gan_image_captioning_tpu_torch.train.state import create_train_state

MODEL = ["--dataset", "synthetic", "--gen-embed-dim", "8",
         "--gen-hidden-dim", "12", "--gen-num-layers", "1",
         "--max-seq-len", "7", "--disc-embed-dim", "8",
         "--disc-num-rep", "4", "--disc-filter-sizes", "2,3",
         "--disc-num-filters", "4,4", "--device", "cpu"]
FLAGS = [*MODEL, "--synthetic-items", "32",
         "--pre-train-batch-size", "8", "--pre-eval-batch-size", "8",
         "--adv-train-batch-size", "8", "--adv-eval-batch-size", "8",
         "--pretrain-epochs", "1", "--adv-epochs", "2",
         "--disc-train-freq", "2"]


def _run(tmp_path, tag, *extra):
    return tmain.main([*FLAGS, *extra, "--save-dir", str(tmp_path / tag)])


def _states_equal(a, b):
    for x, y in ((a.gen, b.gen), (a.disc, b.disc)):
        sa, sb = x.state_dict(), y.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for name in ("pretrain_opt", "gen_opt", "disc_opt"):
        oa, ob = getattr(a, name), getattr(b, name)
        assert oa.count == ob.count
        assert all(torch.equal(oa.mu[k], ob.mu[k]) for k in oa.mu)
    assert (a.gen_steps, a.disc_steps, a.temperature) == (
        b.gen_steps, b.disc_steps, b.temperature)


def _metrics(inst):
    with open(os.path.join(inst.config.save_dir, "metrics.jsonl")) as f:
        return [(r["tag"], r["step"], r["value"])
                for r in map(json.loads, f) if r["tag"] != "adv_steps_per_sec"]


def test_steps_per_call_matches_per_batch_stepping(tmp_path):
    ref = _run(tmp_path, "seq")
    multi = _run(tmp_path, "multi", "--steps-per-call", "3")
    assert multi.pretrain_steps == ref.pretrain_steps == 4
    assert multi.state.gen_steps == ref.state.gen_steps == 8
    _states_equal(ref.state, multi.state)
    assert _metrics(multi) == _metrics(ref)


def test_interrupt_under_steps_per_call_lands_on_a_group(tmp_path):
    ref = _run(tmp_path, "ref", "--steps-per-call", "3")
    argv = [*FLAGS, "--steps-per-call", "3", "--save-dir",
            str(tmp_path / "b"), "--expt-name", "b"]
    args = build_parser().parse_args(argv)
    from gan_image_captioning_tpu_torch.config import make_experiment_dirs

    args = make_experiment_dirs(args)
    config = config_from_args(args).replace(
        vocab_size=SyntheticCaptions("train", num_items=4).vocab_size)
    train = SyntheticCaptions("train", num_items=32)
    val = SyntheticCaptions("val", num_items=16)
    inst = GANInstructor(config, train, val)
    inner = inst.adv_step

    def once(state, batch, temperature):
        inst._request_interrupt()         # lands after this group of 3
        return inner(state, batch, temperature)

    inst.adv_step = once
    inst._run()
    path = os.path.join(config.model_dir, "interrupt_state.ckpt")
    with open(path + ".schedule.json") as f:
        side = json.load(f)
    assert (side["phase"], side["epoch"], side["batches_done"]) == (
        "adv", 0, 3)
    resumed = GANInstructor(config.replace(resume=path), train, val)
    resumed._run()
    _states_equal(ref.state, resumed.state)


def test_ema_checkpoints_are_served_and_captioned(tmp_path):
    inst = _run(tmp_path, "ema", "--ema-decay", "0.5")
    mdir = inst.config.model_dir
    for name in ("pretrained_model", "adv_model"):
        assert os.path.isfile(os.path.join(mdir, name + "_ema.ckpt"))
    ema_path = os.path.join(mdir, "adv_model_ema.ckpt")
    config = inst.config
    gen, disc = ckpt_lib.load_generator_checkpoint(ema_path, config)
    plain, _ = ckpt_lib.load_generator_checkpoint(
        os.path.join(mdir, "adv_model.ckpt"), config)
    assert disc is None
    assert not torch.equal(gen.decoder.linear.weight,
                           plain.decoder.linear.weight)
    service = serve.CaptionService(serve.parse_args(
        [*MODEL, "--checkpoint", ema_path]))
    out = service.handle_request({"n": 2})
    assert len(out["captions"]) == 2
    cap = str(tmp_path / "caps.jsonl")
    tcaption.main([*MODEL, "--checkpoint", ema_path, "--output", cap,
                   "--num-samples", "3"])
    with open(cap) as f:
        assert len(f.readlines()) == 3


def test_full_state_carries_the_ema(tmp_path):
    config = Config(vocab_size=30, gen_embed_dim=8, gen_hidden_dim=12,
                    ema_decay=0.9)
    state = create_train_state(config, 0)
    with torch.no_grad():
        for v in state.ema_gen.values():
            v.add_(1.0)
    path = str(tmp_path / "s.ckpt")
    ckpt_lib.save_state(path, state, sync=True)
    back = ckpt_lib.load_state(path, create_train_state(config, 1))
    assert all(torch.equal(back.ema_gen[k], state.ema_gen[k])
               for k in state.ema_gen)
    with pytest.raises(ValueError, match="ema-decay"):
        ckpt_lib.load_state(path, create_train_state(
            config.replace(ema_decay=0.0), 1))
    # a state file written before the EMA existed: no "ema_gen" entry
    old = ckpt_lib.state_dict_of(create_train_state(
        config.replace(ema_decay=0.0), 2))
    del old["ema_gen"]
    torch.save(old, str(tmp_path / "old.ckpt"))
    back = ckpt_lib.load_state(str(tmp_path / "old.ckpt"), create_train_state(
        config.replace(ema_decay=0.0), 3))
    assert back.ema_gen is None
    with pytest.raises(ValueError, match="ema-decay"):
        ckpt_lib.load_state(str(tmp_path / "old.ckpt"),
                            create_train_state(config, 3))


def test_train_state_from_jax_carries_the_ema():
    kw = dict(vocab_size=30, gen_embed_dim=8, gen_hidden_dim=12,
              disc_embed_dim=8, disc_num_rep=4, disc_filter_sizes=(2,),
              disc_num_filters=(4,), ema_decay=0.99)
    jstate = jax.jit(lambda k: jcreate_train_state(JConfig(**kw), k))(
        jax.random.PRNGKey(0))
    jstate = jstate._replace(ema_gen_params=jax.tree_util.tree_map(
        lambda a: a + 0.5, jstate.ema_gen_params))
    state = interop.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate), Config(**kw))
    want = interop.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate.ema_gen_params))
    assert state.ema_gen.keys() == set(want)
    for k, v in state.ema_gen.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6)
    no_ema = interop.train_state_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate._replace(ema_gen_params=None)), Config(**kw))
    assert no_ema.ema_gen is None


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    prof = tmp_path / "prof"
    _run(tmp_path, "prof", "--profile-dir", str(prof), "--adv-epochs", "1")
    with open(prof / "adv_epoch0.trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]


def _poisoned_instructor(tmp_path, *extra):
    args = build_parser().parse_args([*FLAGS, *extra, "--save-dir",
                                      str(tmp_path)])
    config = config_from_args(args).replace(
        vocab_size=SyntheticCaptions("train", num_items=4).vocab_size,
        model_dir=str(tmp_path / "models"), log_file=str(tmp_path / "log"))
    inst = GANInstructor(config, SyntheticCaptions("train", num_items=32),
                         SyntheticCaptions("val", num_items=16))
    with torch.no_grad():
        inst.state.gen.decoder.linear.bias[3] = float("nan")
    return inst


def test_debug_nans_names_the_loss_and_puts_everything_back(tmp_path):
    inst = _poisoned_instructor(tmp_path, "--debug-nans")
    with pytest.raises(FloatingPointError, match="loss gen_pretrain_loss"):
        inst._run()
    assert not torch.is_anomaly_enabled()
    assert not any(m._forward_hooks for m in inst.state.gen.modules())
    assert not any(m._forward_hooks for m in inst.state.disc.modules())


def test_skip_nonfinite_keeps_the_poisoned_run_going(tmp_path):
    """The same poisoned generator without --debug-nans, guarded: every
    generator update is skipped, the counters run on."""
    inst = _poisoned_instructor(tmp_path, "--skip-nonfinite-grads", "1")
    before = {k: v.clone() for k, v in inst.state.gen.state_dict().items()}
    inst._run()
    assert inst.state.pretrain_opt.count == inst.state.gen_opt.count == 0
    assert inst.state.gen_steps == 8 and inst.pretrain_steps == 4
    after = inst.state.gen.state_dict()
    assert all(torch.equal(before[k], after[k]) or torch.isnan(
        before[k]).any() for k in before)


def test_debug_nans_names_a_module_output_and_a_backward():
    config = Config(vocab_size=30, gen_embed_dim=8, gen_hidden_dim=12,
                    conditional_gan=1, image_size=16, debug_nans=True)
    state = create_train_state(config, 0)
    with torch.no_grad():
        state.gen.encoder.linear.weight[0, 0] = float("nan")
    images = torch.randn(2, 3, 16, 16)
    with pytest.raises(FloatingPointError, match="module gen.encoder.linear"):
        with tsteps.debug_nans(state):
            api.generator_condition(config, state.gen, {
                "images": images, "captions": torch.zeros(2, 9).int()},
                train=True)
    x = torch.zeros((), requires_grad=True)
    with pytest.raises(FloatingPointError, match="non-finite gradient"):
        with tsteps.debug_nans(state):
            (torch.sqrt(x) * 0.0).backward()
    assert not torch.is_anomaly_enabled()
    with pytest.raises(FloatingPointError, match="gradient disc.w"):
        tsteps.check_finite(config, "gradient", {
            "disc.v": torch.ones(2), "disc.w": torch.tensor([1.0, np.inf])})
    tsteps.check_finite(config.replace(debug_nans=False), "gradient",
                        {"w": torch.tensor(np.nan)})


def test_buckets_and_precollate_reach_the_loaders(tmp_path):
    inst = _run(tmp_path, "buckets", "--length-buckets", "5,7",
                "--precollate", "on", "--grad-accum", "2",
                "--use-pallas", "off")
    for name in ("pre_train", "pre_eval", "adv_train", "adv_eval"):
        loader = getattr(inst, name + "_loader")
        assert loader.bucket_bounds == [5, 7]
        assert loader.precollate == "on" and loader._pre is not None
    assert inst.state.gen_steps == 8
