"""The port's full training state, its asynchronous writer, schedule
sidecars, ``--resume auto``, snapshot pruning and early stop
(``train/checkpoint.py``, ``train/schedule.py``, ``config.py``,
``train/instructor.py``) against the JAX package's on the CPU.

* Sidecars: the port's ``save_sidecar`` writes the same bytes as the JAX
  one for the same dict; ``phase_start`` / ``phase_completed`` give the
  same answers over every pair of phases; a torn or invalid file loads as
  None.
* ``resolve_auto_resume`` picks the same file on the same trees.
* The writer: an asynchronous save loads back; it does not wait for a
  slow writer; a writer error comes out at ``wait_for_checkpoints``; two
  saves to one path leave the second; and (the port alone: its steps
  update in place) changing the parameters right after an asynchronous
  save does not change what loads.
* ``prune_checkpoints`` keeps the names the JAX function keeps on the
  same listing, and drops their sidecars.
* Early stop: on the scripted val losses of ``tests/test_early_stop.py``
  the port's instructor stops at the JAX instructor's epoch (both driven
  through monkeypatched sweeps: no JAX training runs)."""

import argparse
import os
import threading

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.config import (
    resolve_auto_resume as jresolve_auto_resume)
from gan_image_captioning_tpu.data.synthetic import (
    SyntheticCaptions as JSynthetic)
from gan_image_captioning_tpu.train import checkpoint as jckpt
from gan_image_captioning_tpu.train import schedule as jsched
from gan_image_captioning_tpu.train import steps as jsteps
from gan_image_captioning_tpu.train.instructor import (
    GANInstructor as JInstructor)
from gan_image_captioning_tpu_torch.config import Config, resolve_auto_resume
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.data.synthetic import SyntheticCaptions
from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib
from gan_image_captioning_tpu_torch.train import schedule as sched_lib
from gan_image_captioning_tpu_torch.train.instructor import GANInstructor
from gan_image_captioning_tpu_torch.train.state import create_train_state
from gan_image_captioning_tpu_torch.train.steps import (batch_to,
                                                        make_adv_step,
                                                        make_mle_step)

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves


@pytest.fixture
def no_state_shardings():
    """No process-wide JAX state shardings: the ZeRO-1 instructor test
    (``tests/test_parallel.py``) leaves them set on its worker."""
    prev = jsteps._STATE_SHARDINGS
    jsteps.set_state_shardings(None)
    yield
    jsteps.set_state_shardings(prev)


# ------------------------------------------------------------------ sidecars

SIDECARS = [
    {"phase": "pretrain", "epoch": 1, "batches_done": 3,
     "loader_epochs": {"pre_train": 1, "pre_eval": 2, "adv_train": 0,
                       "adv_eval": 0},
     "best": {"pretrain": {"loss": 0.25, "since": 1, "total": 3.5},
              "scst": {"reward": None}, "adv": {"loss": None, "since": 0}}},
    {"phase": "scst", "epoch": 0, "batches_done": 2, "scst_step": 2,
     "num_train_batches": 4, "pretrain_steps": 8, "adv_batch_steps": 0},
    {"phase": "adv", "epoch": 2, "batches_done": 0,
     "best": {"adv": {"loss": 0.6931471805599453, "since": 2}}},
]


@pytest.mark.parametrize("info", SIDECARS, ids=["pretrain", "scst", "adv"])
def test_sidecar_bytes_equal_jax(tmp_path, info):
    for side in ("p", "j"):
        os.makedirs(tmp_path / side)
    port = sched_lib.save_sidecar(str(tmp_path / "p" / "x.ckpt"), info)
    ref = jsched.save_sidecar(str(tmp_path / "j" / "x.ckpt"), info)
    assert port.endswith("x.ckpt" + sched_lib.SIDECAR_SUFFIX)
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert sched_lib.load_sidecar(str(tmp_path / "p" / "x.ckpt")) == info


@pytest.mark.parametrize("at", [None, *sched_lib.PHASES])
def test_phase_answers_match_jax(at):
    assert sched_lib.PHASES == jsched.PHASES
    info = None if at is None else {"phase": at, "epoch": 3,
                                    "batches_done": 2}
    for phase in sched_lib.PHASES:
        assert (sched_lib.phase_completed(info, phase)
                == jsched.phase_completed(info, phase))
        assert (sched_lib.phase_start(info, phase)
                == jsched.phase_start(info, phase))


@pytest.mark.parametrize("text", ["{ not json", "", '{"phase": "nope"}',
                                  '{"epoch": 1}', "[1, 2]"])
def test_torn_or_invalid_sidecar_loads_as_none(tmp_path, text):
    ckpt = str(tmp_path / "x.ckpt")
    with open(sched_lib.sidecar_path(ckpt), "w") as f:
        f.write(text)
    assert sched_lib.load_sidecar(ckpt) is None
    if text != "[1, 2]":        # the JAX loader expects an object there
        assert jsched.load_sidecar(ckpt) is None


def test_sidecar_refuses_an_unknown_phase_and_a_missing_file(tmp_path):
    ckpt = str(tmp_path / "x.ckpt")
    assert sched_lib.load_sidecar(ckpt) is None
    with pytest.raises(ValueError):
        sched_lib.save_sidecar(ckpt, {"phase": "nope"})
    assert not os.path.exists(sched_lib.sidecar_path(ckpt))


# ---------------------------------------------------------- --resume auto

def _touch(path, mtime=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, "w").close()
    if mtime is not None:
        os.utime(path, (mtime, mtime))


TREES = {
    "empty": [],
    "newest_wins": [("demo_1/models/state_0.ckpt", 100),
                    ("demo_2/models/interrupt_state.ckpt", 300),
                    ("demo_2/models/state_pre_4.ckpt", 200)],
    "other_experiment_ignored": [("demo_1/models/state_1.ckpt", 100),
                                 ("demonot_3/models/state_9.ckpt", 900),
                                 ("demo_x/models/state_2.ckpt", 800)],
    "best_val_files_ignored": [("demo_1/models/adv_model.ckpt", 900),
                               ("demo_1/models/scst_model.ckpt", 900),
                               ("demo_1/models/state_pre_0.ckpt", 100),
                               ("demo_1/models/state_0.ckpt.schedule.json",
                                950)],
    "no_candidate": [("demo_1/models/pretrained_model.ckpt", 100)],
}


def _args(root, resume="auto"):
    return argparse.Namespace(save_dir=root, expt_name="demo",
                              model_dir="models", resume=resume)


@pytest.mark.parametrize("root_name", ["save", "runs[2026]"])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_resolve_auto_resume_matches_jax(tmp_path, tree, root_name):
    root = str(tmp_path / root_name / "out")
    os.makedirs(root)
    for rel, mtime in TREES[tree]:
        _touch(os.path.join(root, rel), mtime)
    got = resolve_auto_resume(_args(root)).resume
    assert got == jresolve_auto_resume(_args(root)).resume
    assert (got == "") == (tree in ("empty", "no_candidate"))


def test_resolve_auto_resume_passes_other_values(tmp_path):
    for value in ("", "/explicit/path.ckpt"):
        assert resolve_auto_resume(_args(str(tmp_path), value)).resume == \
            value
    # a save dir that does not exist yet: a fresh start
    assert resolve_auto_resume(_args(str(tmp_path / "none"))).resume == ""


# ------------------------------------------------------------ the writer

def test_async_save_then_load_roundtrip(tmp_path):
    path = str(tmp_path / "p.ckpt")
    obj = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(7),
           "n": 3, "nested": {"v": torch.zeros(2, dtype=torch.int32)}}
    ckpt_lib.save_object(path, obj)              # asynchronous
    ckpt_lib.wait_for_checkpoints()
    back = torch.load(path, weights_only=True)
    assert back["n"] == 3
    for key in ("w", "b"):
        assert torch.equal(back[key], obj[key])
    assert torch.equal(back["nested"]["v"], obj["nested"]["v"])


@pytest.fixture
def gated_writer(monkeypatch):
    """The writer thread held at the start of each write until the test
    opens the gate."""
    gate, started = threading.Event(), threading.Event()
    real = ckpt_lib._write

    def gated(path, host_obj):
        started.set()
        assert gate.wait(30), "the test never opened the gate"
        real(path, host_obj)

    monkeypatch.setattr(ckpt_lib, "_write", gated)
    yield gate, started
    gate.set()
    ckpt_lib.wait_for_checkpoints()


def test_save_does_not_block_on_a_slow_writer(tmp_path, gated_writer):
    gate, started = gated_writer
    path = str(tmp_path / "nb.ckpt")
    ckpt_lib.save_object(path, {"w": torch.zeros(4, 4)})
    assert started.wait(30)                # the write has begun, and waits
    assert not os.path.exists(path)
    assert ckpt_lib.pending_checkpoints() >= 1
    gate.set()
    ckpt_lib.wait_for_checkpoints()
    assert ckpt_lib.pending_checkpoints() == 0
    assert torch.equal(torch.load(path, weights_only=True)["w"],
                       torch.zeros(4, 4))


def test_writer_error_surfaces_at_the_barrier(tmp_path, monkeypatch):
    def boom(path, host_obj):
        raise RuntimeError("disk on fire")

    monkeypatch.setattr(ckpt_lib, "_write", boom)
    ckpt_lib.save_object(str(tmp_path / "x.ckpt"), {"a": torch.ones(2)})
    with pytest.raises(RuntimeError, match="disk on fire"):
        ckpt_lib.wait_for_checkpoints()
    assert ckpt_lib.pending_checkpoints() == 0     # drained all the same


def test_sync_save_is_on_disk_at_return(tmp_path):
    path = str(tmp_path / "s.ckpt")
    ckpt_lib.save_object(path, {"w": torch.full((2, 2), 3.0)}, sync=True)
    assert os.path.isfile(path) and not os.path.exists(path + ".tmp")
    assert torch.equal(torch.load(path, weights_only=True)["w"],
                       torch.full((2, 2), 3.0))


def test_ordered_saves_leave_the_last_writers_file(tmp_path):
    path = str(tmp_path / "o.ckpt")
    ckpt_lib.save_object(path, {"v": torch.zeros(3)})
    ckpt_lib.save_object(path, {"v": torch.ones(3)})
    ckpt_lib.wait_for_checkpoints()
    assert torch.equal(torch.load(path, weights_only=True)["v"],
                       torch.ones(3))


# ------------------------------------------------------- the full state

KW = dict(gen_embed_dim=12, gen_hidden_dim=16, max_seq_len=9,
          disc_embed_dim=8, disc_num_rep=4, disc_filter_sizes=(2, 3),
          disc_num_filters=(6, 6), device="cpu")


def _stepped_state(seed=0, **kw):
    """A state after one MLE and one adversarial step: every Adam state
    but the discriminator's has moments, the generator has drawn."""
    kw = {**KW, **kw}
    ds = SyntheticCaptions("train", num_items=16,
                           image_size=kw.get("image_size", 32),
                           conditional=bool(kw.get("conditional_gan", 0)))
    config = Config(vocab_size=ds.vocab_size, **kw)
    state = create_train_state(config, seed)
    rows = [ds.sample(i) for i in range(8)]
    batch = batch_to(make_batch([r[0] for r in rows],
                                [r[1] for r in rows] if config.cgan else None,
                                config.seq_len), "cpu")
    state, _ = make_mle_step(config)(state, batch)
    state, _ = make_adv_step(config)(state, batch, 3.0)
    return config, state


def assert_states_equal(a, b):
    """Every tensor, moment, counter and the generator state equal."""
    for name in ("gen", "disc"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), f"{name}.{k}"
    for name in ("pretrain_opt", "gen_opt", "disc_opt"):
        oa, ob = getattr(a, name), getattr(b, name)
        assert oa.count == ob.count, name
        for moments in ("mu", "nu"):
            ma, mb = getattr(oa, moments), getattr(ob, moments)
            assert ma.keys() == mb.keys()
            for k in ma:
                assert torch.equal(ma[k], mb[k]), f"{name}.{moments}.{k}"
    for name in ("pretrain_steps", "gen_steps", "disc_steps", "temperature"):
        assert getattr(a, name) == getattr(b, name), name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("sync", [True, False])
def test_full_state_round_trip(tmp_path, sync):
    config, state = _stepped_state()
    state.pretrain_steps = 5
    path = str(tmp_path / "state_0.ckpt")
    ckpt_lib.save_state(path, state, sync=sync)
    fresh = create_train_state(config, 7)
    loaded = ckpt_lib.load_state(path, fresh)
    assert loaded is fresh
    assert_states_equal(loaded, state)
    # the loaded generator continues the saved stream
    assert torch.equal(torch.rand(5, generator=loaded.generator),
                       torch.rand(5, generator=state.generator))


def test_full_state_carries_batchnorm_statistics(tmp_path):
    config, state = _stepped_state(conditional_gan=1, image_size=32)
    stats = {k: v for k, v in state.gen.state_dict().items()
             if "running_" in k}
    assert stats
    path = str(tmp_path / "cond.ckpt")
    ckpt_lib.save_state(path, state, sync=True)
    loaded = ckpt_lib.load_state(path, create_train_state(config, 3))
    assert_states_equal(loaded, state)


def test_in_place_step_after_async_save_keeps_the_snapshot(tmp_path,
                                                           gated_writer):
    gate, started = gated_writer
    config, state = _stepped_state()
    before = ckpt_lib._host_copy(ckpt_lib.state_dict_of(state))
    path = str(tmp_path / "snap.ckpt")
    ckpt_lib.save_state(path, state)              # asynchronous
    assert started.wait(30)
    # the next step updates parameters and moments in place while the
    # writer still waits
    ds = SyntheticCaptions("train", num_items=16)
    batch = batch_to(make_batch([ds.sample(i)[0] for i in range(8, 16)],
                                None, config.seq_len), "cpu")
    make_adv_step(config)(state, batch, 5.0)
    with torch.no_grad():
        for p in state.gen.parameters():
            p.add_(1.0)
    gate.set()
    loaded = ckpt_lib.load_state(path, create_train_state(config, 1))
    for k, v in before["gen"].items():
        assert torch.equal(loaded.gen.state_dict()[k], v), k
        assert not torch.equal(state.gen.state_dict()[k], v), k
    for k, v in before["gen_opt"]["mu"].items():
        assert torch.equal(loaded.gen_opt.mu[k], v), k
    assert loaded.gen_steps == before["gen_steps"] == state.gen_steps - 1


def test_load_state_refuses_a_generator_checkpoint(tmp_path):
    config, state = _stepped_state()
    path = str(tmp_path / "gen.ckpt")
    ckpt_lib.save_generator_checkpoint(path, state.gen)
    with pytest.raises(ValueError, match="full training state"):
        ckpt_lib.load_state(path, create_train_state(config, 0))


def test_async_generator_checkpoint_loads(tmp_path):
    config, state = _stepped_state()
    path = str(tmp_path / "adv_model.ckpt")
    ckpt_lib.save_generator_checkpoint(path, state.gen,
                                       state.disc.state_dict(), sync=False)
    gen, disc = ckpt_lib.load_generator_checkpoint(path, config)
    for k, v in state.gen.state_dict().items():
        assert torch.equal(gen.state_dict()[k], v)
    assert disc.keys() == state.disc.state_dict().keys()


# --------------------------------------------------------------- pruning

LISTING = ["state_0.ckpt", "state_1.ckpt", "state_2.ckpt", "state_10.ckpt",
           "state_pre_0.ckpt", "state_pre_3.ckpt", "state_pre_7.ckpt",
           "adv_model.ckpt", "pretrained_model.ckpt", "state_x.ckpt",
           "interrupt_state.ckpt"]


@pytest.mark.parametrize("prefix", ["state_", "state_pre_"])
@pytest.mark.parametrize("keep", [0, 1, 2, 5])
def test_prune_keeps_the_jax_names(tmp_path, prefix, keep):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for name in LISTING:
        os.makedirs(jdir / name)                 # JAX: Orbax directories
        _touch(str(tdir / name))                 # the port: files
        _touch(str(tdir / name) + sched_lib.SIDECAR_SUFFIX)
    want = jckpt.prune_checkpoints(str(jdir), prefix, keep)
    got = ckpt_lib.prune_checkpoints(str(tdir), prefix, keep)
    assert ([os.path.basename(p) for p in got]
            == [os.path.basename(p) for p in want])
    assert sorted(os.listdir(jdir)) == sorted(
        n for n in os.listdir(tdir) if not n.endswith(".json"))
    for name in os.listdir(tdir):
        if name.endswith(sched_lib.SIDECAR_SUFFIX):
            # a sidecar goes with its checkpoint
            assert os.path.exists(tdir / name[:-len(
                sched_lib.SIDECAR_SUFFIX)])


# ------------------------------------------------------------ early stop

def _early_cfgs(tmp_path, **kw):
    ds = SyntheticCaptions("train", num_items=16)
    base = dict(vocab_size=ds.vocab_size, gen_embed_dim=8, gen_hidden_dim=12,
                max_seq_len=6, disc_embed_dim=8, disc_num_rep=2,
                disc_filter_sizes=(2,), disc_num_filters=(6,),
                pre_train_batch_size=8, pre_eval_batch_size=8,
                adv_train_batch_size=8, adv_eval_batch_size=8, **kw)
    dirs = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side)
        dirs[side] = dict(save_dir=root,
                          model_dir=os.path.join(root, "models"),
                          log_file=os.path.join(root, "log"))
    return (JConfig(num_workers=1, **base, **dirs["jax"]),
            Config(device="cpu", **base, **dirs["port"]))


def _instructors(tmp_path, **kw):
    jcfg, cfg = _early_cfgs(tmp_path, **kw)
    ji = JInstructor(jcfg, JSynthetic("train", num_items=16),
                     JSynthetic("val", num_items=8), silent=True)
    ti = GANInstructor(cfg, SyntheticCaptions("train", num_items=16),
                       SyntheticCaptions("val", num_items=8))
    return ji, ti


PRE_VAL = [0.9, 0.5, 0.6, 0.7, 0.4, 0.3, 0.2, 0.1, 0.1, 0.1]


@pytest.mark.parametrize("patience", [1, 2, 3])
def test_pretrain_early_stop_matches_jax(tmp_path, no_state_shardings,
                                         patience):
    ji, ti = _instructors(tmp_path, pretrain_epochs=10, adv_epochs=0,
                          early_stop_patience=patience)
    calls = {}
    for name, inst in (("jax", ji), ("port", ti)):
        count = {"train": 0, "val": 0}

        def fake_loop(what, start_batch=0, _count=count):
            i = _count[what]
            _count[what] += 1
            return [1.0 if what == "train" else PRE_VAL[i]]

        inst.genpretrain_loop = fake_loop
        inst.pretrain_generator(10)
        calls[name] = count
    jckpt.wait_for_checkpoints()
    ckpt_lib.wait_for_checkpoints()
    assert calls["port"] == calls["jax"]
    assert calls["port"]["val"] == {1: 3, 2: 4, 3: 10}[patience]
    assert ti._best["pretrain"]["loss"] == ji._best["pretrain"]["loss"]
    assert os.path.isfile(os.path.join(ti.model_dir,
                                       "pretrained_model.ckpt"))


ADV_VAL = [0.9, 0.8, 0.85, 0.9, 0.95, 0.2, 0.2, 0.2, 0.2, 0.2]


@pytest.mark.parametrize("patience", [2, 3])
def test_adv_early_stop_matches_jax(tmp_path, no_state_shardings, patience):
    ji, ti = _instructors(tmp_path, pretrain_epochs=0, adv_epochs=10,
                          early_stop_patience=patience)
    runs = {}
    for name, inst in (("jax", ji), ("port", ti)):
        epochs = []

        def fake_adv_loop(what, adv_epoch, start_batch=0, _epochs=epochs):
            if what == "val":
                _epochs.append(adv_epoch)
                return ADV_VAL[adv_epoch], 1.0
            return 1.0, 1.0

        inst.adv_loop = fake_adv_loop
        inst._run()
        runs[name] = epochs
    assert runs["port"] == runs["jax"] == list(range(2 + patience))
    assert ti._best["adv"] == ji._best["adv"]
