"""Interrupt and resume of the port's training loop on the CPU
(``train/instructor.py``, ``train/schedule.py``), as
``tests/test_resume_schedule.py`` holds the JAX package's: a run
interrupted in the middle of a train sweep (pretrain, SCST, adversarial),
or restarted from a ``--checkpoint-every`` snapshot, then resumed from
the saved state and its sidecar, ends with the uninterrupted run's
parameters, Adam moments, counters, temperature and generator state,
each equal by ``torch.equal``.  Also: an adversarial sidecar skips SCST,
a changed batch count degrades a mid-sweep resume to the next epoch,
``main.main --resume auto`` restarts a run from the same command line,
an interrupt anywhere (a few seeds) resumes bit-exactly, and config4's
transformer REINFORCE step and the conditional generator resume too.

Small widths as in the JAX tests: E = 12, H = 16, max_seq_len 9, B = 8,
32 / 16 synthetic items."""

import json
import os

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch import main as tmain
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.synthetic import SyntheticCaptions
from gan_image_captioning_tpu_torch.train import scst as scst_lib
from gan_image_captioning_tpu_torch.train.instructor import GANInstructor
from test_torch_port_checkpoint_state import assert_states_equal

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

ITEMS, VAL_ITEMS, BS = 32, 16, 8


def _config(root, **kw):
    base = dict(vocab_size=SyntheticCaptions("train", num_items=4).vocab_size,
                gen_embed_dim=12, gen_hidden_dim=16, gen_num_layers=1,
                max_seq_len=9, disc_embed_dim=8, disc_num_rep=4,
                disc_filter_sizes=(2, 3), disc_num_filters=(6, 6),
                pre_train_batch_size=BS, pre_eval_batch_size=BS,
                adv_train_batch_size=BS, adv_eval_batch_size=BS,
                pretrain_epochs=2, adv_epochs=2, device="cpu",
                save_dir=os.path.join(root, "save"),
                model_dir=os.path.join(root, "save", "models"),
                log_file=os.path.join(root, "save", "log"))
    base.update(kw)
    return Config(**base)


def _datasets(config, items=ITEMS):
    kw = dict(image_size=config.image_size, conditional=config.cgan)
    return (SyntheticCaptions("train", num_items=items, **kw),
            SyntheticCaptions("val", num_items=VAL_ITEMS, **kw))


def _run(config, interrupt=None, items=ITEMS):
    """One instructor run; ``interrupt(inst)`` arms an interrupt first."""
    inst = GANInstructor(config, *_datasets(config, items))
    if interrupt is not None:
        interrupt(inst)
    inst._run()
    return inst


def after_calls(attrs, n, monkeypatch=None):
    """Arm an interrupt after the ``n``-th call, counted over the step
    attributes ``attrs`` (a stand-in for a SIGTERM in that batch), and,
    given ``monkeypatch``, over the SCST batches (their rewards) too."""
    def arm(inst):
        calls = [0]

        def counted(fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                calls[0] += 1
                if calls[0] == n:
                    inst._request_interrupt()
                return out
            return wrapped

        for attr in attrs:
            setattr(inst, attr, counted(getattr(inst, attr)))
        if monkeypatch is not None:
            monkeypatch.setattr(scst_lib, "batch_advantage",
                                counted(scst_lib.batch_advantage))
    return arm


def _interrupt_and_resume(tmp_path, interrupt, items=ITEMS, **kw):
    """``(uninterrupted, interrupted, resumed, sidecar)``."""
    ref = _run(_config(str(tmp_path / "a"), **kw), items=items)
    cfg_b = _config(str(tmp_path / "b"), **kw)
    cut = _run(cfg_b, interrupt, items=items)
    ckpt = os.path.join(cfg_b.model_dir, "interrupt_state.ckpt")
    assert os.path.isfile(ckpt)
    with open(ckpt + ".schedule.json") as f:
        side = json.load(f)
    resumed = _run(_config(str(tmp_path / "b"), resume=ckpt, **kw),
                   items=items)
    assert resumed.pretrain_steps == ref.pretrain_steps
    assert resumed._scst_step == ref._scst_step
    assert resumed.adv_batch_steps == ref.adv_batch_steps
    assert_states_equal(resumed.state, ref.state)
    return ref, cut, resumed, side


def test_midpretrain_interrupt_resume_bitexact(tmp_path):
    _, cut, resumed, side = _interrupt_and_resume(
        tmp_path, after_calls(["mle_step"], 2))
    assert side["phase"] == "pretrain" and side["epoch"] == 0
    assert side["batches_done"] == 2 and side["pretrain_steps"] == 2
    assert side["loader_epochs"]["pre_train"] == 0   # replay epoch 0
    assert cut.state.gen_steps == 0                  # nothing ran past it


def test_midadv_interrupt_resume_bitexact(tmp_path):
    ref, cut, resumed, side = _interrupt_and_resume(
        tmp_path, after_calls(["adv_step"], 3))
    assert (side["phase"], side["epoch"], side["batches_done"]) == (
        "adv", 0, 3)
    assert cut.state.gen_steps == 3
    assert resumed.state.temperature == ref.state.temperature


def test_midscst_interrupt_resume_bitexact(tmp_path, monkeypatch):
    """The rollout noise is seeded by the global SCST step, so the resumed
    sweep draws what the uninterrupted one drew."""
    # pretrain 4 batches, then the second SCST batch
    _, cut, _, side = _interrupt_and_resume(
        tmp_path, after_calls(["mle_step"], 6, monkeypatch),
        pretrain_epochs=1, adv_epochs=1, scst_epochs=2, scst_reward="bleu")
    assert (side["phase"], side["epoch"], side["batches_done"]) == (
        "scst", 0, 2)
    assert side["scst_step"] == 2 and cut._scst_step == 2


def test_periodic_snapshot_resume_bitexact(tmp_path):
    """A crash without an interrupt save resumes from the newest snapshot
    and its sidecar with no flag edited."""
    kw = dict(checkpoint_every=1, adv_epochs=3, scst_epochs=1,
              keep_checkpoints=2)
    cfg_a = _config(str(tmp_path / "a"), **kw)
    ref = _run(cfg_a)
    names = sorted(os.listdir(cfg_a.model_dir))
    assert [n for n in names if n.startswith("state_") and
            n.endswith(".ckpt")] == ["state_1.ckpt", "state_2.ckpt",
                                     "state_pre_0.ckpt", "state_pre_1.ckpt"]
    assert "scst_model.ckpt" in names
    for ckpt, phase, epoch in (("state_1.ckpt", "adv", 2),
                               ("state_pre_1.ckpt", "pretrain", 2),
                               ("state_pre_0.ckpt", "pretrain", 1)):
        path = os.path.join(cfg_a.model_dir, ckpt)
        with open(path + ".schedule.json") as f:
            side = json.load(f)
        assert (side["phase"], side["epoch"], side["batches_done"]) == (
            phase, epoch, 0)
        resumed = _run(_config(str(tmp_path / ckpt), resume=path, **kw))
        assert_states_equal(resumed.state, ref.state)


def test_scst_skipped_on_adv_resume(tmp_path, monkeypatch):
    kw = dict(checkpoint_every=1, pretrain_epochs=1, scst_epochs=1,
              adv_epochs=2)
    cfg_a = _config(str(tmp_path / "a"), **kw)
    ref = _run(cfg_a)
    called = []
    monkeypatch.setattr(scst_lib, "make_scst_programs",
                        lambda *a: called.append(a))
    resumed = _run(_config(str(tmp_path / "b"), resume=os.path.join(
        cfg_a.model_dir, "state_0.ckpt"), **kw))
    assert called == []                    # no SCST program was built
    assert resumed.pretrain_steps == ref.pretrain_steps
    assert_states_equal(resumed.state, ref.state)


def test_midsweep_resume_with_changed_geometry_degrades(tmp_path):
    cfg_b = _config(str(tmp_path / "b"), pretrain_epochs=3, adv_epochs=1)
    _run(cfg_b, after_calls(["mle_step"], 2))       # 2 of 4 batches
    ckpt = os.path.join(cfg_b.model_dir, "interrupt_state.ckpt")
    # batch size 4: 8 train batches an epoch, where the sidecar says 4
    cfg_c = _config(str(tmp_path / "b"), resume=ckpt, pretrain_epochs=3,
                    adv_epochs=1, pre_train_batch_size=4)
    resumed = GANInstructor(cfg_c, *_datasets(cfg_c))
    assert resumed.pretrain_steps == 2
    resumed._run()
    # epochs 1 and 2 ran, 8 batches each; the broken epoch 0 was skipped
    assert resumed.pretrain_steps == 2 + 2 * 8
    assert resumed.pre_train_loader.epoch == 3
    assert resumed.state.gen_steps == 4


def test_resume_schedule_0_restores_the_state_only(tmp_path):
    cfg_b = _config(str(tmp_path / "b"), pretrain_epochs=1, adv_epochs=1)
    cut = _run(cfg_b, after_calls(["adv_step"], 1))
    ckpt = os.path.join(cfg_b.model_dir, "interrupt_state.ckpt")
    cfg_c = _config(str(tmp_path / "c"), resume=ckpt, resume_schedule=0,
                    pretrain_epochs=1, adv_epochs=1)
    resumed = GANInstructor(cfg_c, *_datasets(cfg_c))
    assert resumed._schedule is None and resumed.pretrain_steps == 0
    assert_states_equal(resumed.state, cut.state)
    resumed._run()                       # the whole schedule once more
    assert resumed.pretrain_steps == 4
    assert resumed.state.gen_steps == cut.state.gen_steps + 4


AUTO = ["--dataset", "synthetic", "--synthetic-items", str(ITEMS),
        "--max-seq-len", "8", "--gen-embed-dim", "8",
        "--gen-hidden-dim", "12", "--gen-num-layers", "1",
        "--disc-embed-dim", "8", "--disc-num-rep", "4",
        "--disc-filter-sizes", "2,3", "--disc-num-filters", "6,6",
        "--pre-train-batch-size", "8", "--pre-eval-batch-size", "8",
        "--adv-train-batch-size", "8", "--adv-eval-batch-size", "8",
        "--pretrain-epochs", "2", "--scst-epochs", "1", "--adv-epochs", "2",
        "--checkpoint-every", "1", "--resume", "auto", "--device", "cpu"]


def test_auto_resume_through_main(tmp_path, monkeypatch):
    """The same command line with ``--resume auto``: a fresh start, then
    a run killed in its adversarial phase restarts from its interrupt
    save and ends where an uninterrupted run ends."""
    ref = tmain.main([*AUTO, "--save-dir", str(tmp_path / "ref"),
                      "--expt-name", "auto"])
    assert ref.config.resume == ""
    argv = [*AUTO, "--save-dir", str(tmp_path / "save"), "--expt-name",
            "auto"]
    real_init = GANInstructor.__init__

    def interrupted_init(self, *a, **k):
        real_init(self, *a, **k)
        after_calls(["adv_step"], 6)(self)           # adv epoch 1, batch 2

    monkeypatch.setattr(GANInstructor, "__init__", interrupted_init)
    first = tmain.main(argv)
    monkeypatch.setattr(GANInstructor, "__init__", real_init)
    assert first.config.resume == "" and first._interrupt_saved
    second = tmain.main(argv)
    assert second.config.resume == os.path.join(
        first.config.model_dir, "interrupt_state.ckpt")
    assert second._schedule["phase"] == "adv"
    assert second.config.save_dir.endswith("auto_2")
    assert_states_equal(second.state, ref.state)
    # a third identical command finds the finished run's last snapshot
    third = tmain.main(argv)
    assert third.config.resume == os.path.join(second.config.model_dir,
                                               "state_1.ckpt")
    assert third.state.gen_steps == ref.state.gen_steps


FUZZ_ROUTES = ("fused", "decoupled", "kernel_rescore", "kernel_embed")


@pytest.mark.parametrize("seed", range(len(FUZZ_ROUTES)))
def test_fuzz_interrupt_anywhere_resume_bitexact(tmp_path, monkeypatch,
                                                 seed):
    """A random small schedule and conv engine, each decode route, and a
    random interrupt point anywhere in it (any phase, any batch), resume
    bit-exactly."""
    rng = np.random.default_rng(200 + seed)
    kw = dict(pretrain_epochs=int(rng.integers(1, 3)),
              scst_epochs=int(rng.integers(0, 2)),
              adv_epochs=int(rng.integers(1, 3)),
              disc_train_freq=int(rng.integers(1, 3)),
              label_smoothing=float(rng.choice([0.0, 0.1])),
              noisy_labels=float(rng.choice([0.0, 0.2])),
              checkpoint_every=int(rng.choice([0, 1])),
              mle_objective=str(rng.choice(["free", "teacher"])),
              decode_impl=FUZZ_ROUTES[seed],
              disc_engine=str(rng.choice(["auto", "pallas", "hybrid"])))
    items = 24
    nb = items // BS
    total = (kw["pretrain_epochs"] + kw["scst_epochs"]
             + kw["adv_epochs"]) * nb
    cut = int(rng.integers(1, total))
    _interrupt_and_resume(
        tmp_path, after_calls(["mle_step", "adv_step"], cut, monkeypatch),
        items=items, **kw)


def test_transformer_reinforce_resume_bitexact(tmp_path):
    """config4's transformer generator and REINFORCE step."""
    kw = dict(gen_arch="transformer", gen_embed_dim=16, gen_hidden_dim=16,
              gen_num_layers=1, gen_num_heads=2, disc_arch="transformer",
              disc_embed_dim=8, disc_hidden_dim=16, disc_num_heads=2,
              disc_num_layers=1, adv_objective="reinforce", rollout_num=2,
              rollout_stride=4, max_seq_len=6, pretrain_epochs=1,
              adv_epochs=1, scst_epochs=1)
    _, _, _, side = _interrupt_and_resume(
        tmp_path, after_calls(["adv_step"], 2), items=24, **kw)
    assert (side["phase"], side["batches_done"]) == ("adv", 2)


def test_conditional_gumbel_resume_bitexact(tmp_path):
    """The conditional generator: its BatchNorm statistics resume too."""
    kw = dict(conditional_gan=1, image_size=32, pretrain_epochs=1,
              adv_epochs=1, disc_train_freq=2)
    _, _, _, side = _interrupt_and_resume(
        tmp_path, after_calls(["mle_step", "adv_step"], 3), items=16, **kw)
    assert (side["phase"], side["batches_done"]) == ("adv", 1)
