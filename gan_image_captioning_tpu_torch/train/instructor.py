"""GANInstructor: the training loop
(``gan_image_captioning_tpu/train/instructor.py``).

Drives the reference's schedule (``training.py:15-235``) over the port's
steps, with the JAX package's SCST phase between the two:

* MLE pre-training (:meth:`GANInstructor.pretrain_generator`): per epoch a
  train sweep and a val sweep; the best val loss writes
  ``pretrained_model.ckpt``.
* SCST (:meth:`GANInstructor.scst_finetune`, ``--scst-epochs``):
  ``train/scst.py``'s rollout, host reward and update per train batch of
  the pretrain loader, a val sweep of the greedy reward; the best val
  reward writes ``scst_model.ckpt`` (the generator in the reference
  layout).
* Adversarial training (:meth:`GANInstructor._run`, :meth:`adv_loop`): one
  step per train batch with the temperature ramped over fractional epochs
  (``training.py:183``, the global batch index), the discriminator updated
  every ``disc_train_freq`` generator steps; the best val generator loss
  writes ``adv_model.ckpt`` (generator, discriminator and the
  ``conditional`` flag).

With ``--eval-bleu-every N`` the adversarial epochs 0, N, 2N, ... end
with :meth:`GANInstructor.evaluate_quality` (NLL_gen, BLEU-4 and self-BLEU
on the val set, logged as ``[EVAL]`` and written as ``NLL_gen``,
``BLEU4`` and ``SelfBLEU4``).

Interrupt and resume (``train/schedule.py``).  SIGTERM and SIGINT (their
handlers are installed when the instructor is built in the main thread,
and the previous ones put back when :meth:`_run` ends) set a flag; the
running train sweep stops after its batch in flight, and the full state
is saved synchronously to ``interrupt_state.ckpt`` with a sidecar that
records the phase, epoch and batches applied.  ``--checkpoint-every N``
saves ``state_pre_<epoch>.ckpt`` / ``state_<epoch>.ckpt`` snapshots
(asynchronously, pruned to ``--keep-checkpoints`` per phase) with
sidecars that point at the next epoch.  ``--resume <ckpt>`` loads the
state and, with a sidecar (unless ``--resume-schedule 0``), skips the
completed phases and epochs and re-enters a broken train sweep at its
next batch with the same shuffle order; if the loader's batch count
changed since, it resumes at the next epoch instead.  The per-phase best
values and patience counters (``--early-stop-patience``) are part of the
sidecar.  Since every draw comes from the state's generator or, in SCST,
from ``(seed, scst_step)``, a resumed run on the CPU ends bit-equal to
the uninterrupted one.

As in the JAX package, the temperature and the step counters do not
advance during val sweeps.  Scalars go to ``metrics.jsonl`` with the JAX
package's tags; each sweep's metrics are read from the device once, at
its end.  Batches are built in this thread and copied to the device before
their step (``--num-workers`` / ``--device-prefetch`` are accepted and
change nothing but overlap in the JAX package).

Step options and batching (the JAX instructor's):

* ``--steps-per-call K``: the train sweeps take their batches in groups
  of K (``data/loader.stack_batches``, one copy to the device a group)
  and run each group's steps one by one, as ``steps.make_multi_step``
  does in one call; an interrupt lands after the group in flight.
* ``--length-buckets`` / ``--precollate``: the four loaders' buckets and
  shared precollation (``data/loader.py``).
* ``--cache-features 1`` (conditional LSTM, frozen backbone): the train
  and dev sets' backbone features are computed once
  (``data/feature_cache.py``) and the loaders carry them in place of the
  images; augmentation then has nothing to act on, and a warning says so.
* ``--mle-objective scheduled``: the pretrain epoch e feeds the train and
  val MLE steps the model-feedback probability ``ss_max_prob · e /
  max(1, epochs − 1)``.
* ``--ema-decay``: each best-val save of ``pretrained_model.ckpt`` and
  ``adv_model.ckpt`` writes the EMA beside it as ``pretrained_model_ema
  .ckpt`` / ``adv_model_ema.ckpt`` (plain reference form; ``evaluate.py
  --checkpoint``, ``caption.py`` and ``serve.py`` load it).
* ``--profile-dir``: ``torch.profiler`` over the first adversarial
  epoch's train sweep, its Chrome trace written into the directory when
  the sweep ends, an interrupted one included.
* ``--debug-nans``: ``steps.debug_nans`` around :meth:`_run` (forward
  hooks, anomaly mode; put back when it ends) and the steps' own checks.

Meshes are not ported (``ROADMAP.md`` queue 1, item 4): their flags
raise (``config.require_ported_flags``).
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
import time

import numpy as np
import torch

from gan_image_captioning_tpu_torch.config import (Config, require_ported_flags,
                                                   resolve_device)
from gan_image_captioning_tpu_torch.data.feature_cache import (
    CachedFeatureDataset, precompute_backbone_features)
from gan_image_captioning_tpu_torch.data.loader import Batcher, stack_batches
from gan_image_captioning_tpu_torch.eval import decode as decode_lib
from gan_image_captioning_tpu_torch.eval.diversity import self_bleu
from gan_image_captioning_tpu_torch.eval.metrics import (bleu4_from_batches,
                                                         caption_text,
                                                         strip_caption,
                                                         text_vocab)
from gan_image_captioning_tpu_torch.models import api
from gan_image_captioning_tpu_torch.ops.temperature import get_fixed_temperature
from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib
from gan_image_captioning_tpu_torch.train import schedule as sched_lib
from gan_image_captioning_tpu_torch.train import scst as scst_lib
from gan_image_captioning_tpu_torch.train.state import (create_train_state,
                                                        with_generator)
from gan_image_captioning_tpu_torch.train.steps import (
    batch_to, debug_nans, make_adv_eval_step, make_adv_step,
    make_mle_eval_step, make_mle_step)
from gan_image_captioning_tpu_torch.utils.logging import (MetricWriter,
                                                          create_logger)

# the train loader of each phase, by its attribute prefix
_TRAIN_LOADER = {"pretrain": "pre_train", "scst": "pre_train",
                 "adv": "adv_train"}
_LOADERS = ("pre_train", "pre_eval", "adv_train", "adv_eval")


class GANInstructor:
    """Mirrors reference ``GANInstructor(args, train_dataset, dev_dataset)``
    (training.py:16-46).  ``config.device`` names the device (a missing
    CUDA device raises)."""

    def __init__(self, config: Config, train_dataset, dev_dataset):
        require_ported_flags(config)
        self.config = config
        self.device = resolve_device(config.device)
        self.train_dataset = train_dataset
        self.dev_dataset = dev_dataset
        self.model_dir = config.model_dir
        os.makedirs(self.model_dir, exist_ok=True)
        self.log = create_logger(__name__, config.log_file + ".txt")
        self.writer = MetricWriter(config.save_dir)
        if config.num_workers > 1 or config.device_prefetch > 0:
            self.log.info(
                "--num-workers %d / --device-prefetch %d: the loader is "
                "single-threaded; batches are built and copied to the device "
                "before each step" % (config.num_workers,
                                      config.device_prefetch))

        self.state = create_train_state(config, config.seed, self.device)
        if config.resume:
            self.state = ckpt_lib.load_state(config.resume, self.state)
            self.log.info("Resumed the training state from %s (gen_steps=%d)"
                          % (config.resume, self.state.gen_steps))
        elif config.init_gen_ckpt:
            # warm-start the generator only (optimizers and counters fresh)
            gen, _ = ckpt_lib.load_generator_checkpoint(
                config.init_gen_ckpt, config, self.device)
            self.state = with_generator(self.state, gen, config)
            self.log.info("Initialized generator params from %s"
                          % config.init_gen_ckpt)

        self.mle_step = make_mle_step(config)
        self.mle_eval_step = make_mle_eval_step(config)
        self.adv_step = make_adv_step(config)
        self.adv_eval_step = make_adv_eval_step(config)
        self.steps_per_call = max(1, int(config.steps_per_call))

        if (config.cache_features and config.cgan
                and not config.trainable_backbone
                and config.gen_arch == "lstm"):
            if config.random_flip or config.random_crop_pad:
                self.log.warning(
                    "--cache-features precomputes backbone features from "
                    "unaugmented images; --random-flip/--random-crop-pad "
                    "will have no effect on this run")
            self.log.info("Caching frozen-backbone features (one pass per "
                          "image)...")
            for name in ("train_dataset", "dev_dataset"):
                base = getattr(self, name)
                setattr(self, name, CachedFeatureDataset(
                    base, precompute_backbone_features(
                        base, self.state.gen.encoder)))
            train_dataset, dev_dataset = self.train_dataset, self.dev_dataset

        seq = config.seq_len
        kw = dict(bucket_bounds=config.bucket_bounds,
                  precollate=config.precollate)
        self.pre_train_loader = Batcher(
            train_dataset, config.pre_train_batch_size, seq, shuffle=True,
            seed=config.seed, drop_last=True, **kw)
        self.pre_eval_loader = Batcher(dev_dataset, config.pre_eval_batch_size,
                                       seq, **kw)
        self.adv_train_loader = Batcher(
            train_dataset, config.adv_train_batch_size, seq, shuffle=True,
            seed=config.seed + 1, drop_last=True, **kw)
        self.adv_eval_loader = Batcher(dev_dataset, config.adv_eval_batch_size,
                                       seq, **kw)
        self.pretrain_steps = 0
        self._ss_prob = 0.0     # scheduled sampling's feedback probability
        self.adv_batch_steps = 0
        self._scst_step = 0
        # per-phase best values and patience counters: state, so that an
        # interrupt save records them and a resumed run continues them
        self._best = {"pretrain": {"loss": None, "since": 0, "total": 0.0},
                      "scst": {"reward": None},
                      "adv": {"loss": None, "since": 0}}

        # the sidecar's host-side schedule position (train/schedule.py)
        self._schedule = None
        if config.resume and config.resume_schedule:
            self._schedule = sched_lib.load_sidecar(config.resume)
        if self._schedule:
            s = self._schedule
            for name, ep in s.get("loader_epochs", {}).items():
                loader = getattr(self, name + "_loader", None)
                if loader is not None:
                    loader.epoch = int(ep)
            self.pretrain_steps = int(s.get("pretrain_steps", 0))
            self.adv_batch_steps = int(s.get("adv_batch_steps", 0))
            self._scst_step = int(s.get("scst_step", 0))
            for phase, vals in (s.get("best") or {}).items():
                if phase in self._best:
                    self._best[phase].update(vals)
            self.log.info(
                "Schedule sidecar: fast-forwarding to %s epoch %d, batch %d"
                % (s["phase"], int(s.get("epoch", 0)),
                   int(s.get("batches_done", 0))))

        # SIGTERM / SIGINT: save a resumable state after the batch in flight
        self._interrupted = False
        self._interrupt_saved = False
        self._sweep_break = None
        self._prev_handlers = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev_handlers[sig] = signal.signal(
                        sig, lambda *_: self._request_interrupt())
                except (ValueError, OSError):
                    pass

    def _request_interrupt(self):
        self._interrupted = True

    def _restore_signal_handlers(self):
        for sig, handler in self._prev_handlers.items():
            signal.signal(sig, handler)
        self._prev_handlers = {}

    # ------------------------------------------------ interrupt and resume

    def _schedule_info(self, phase: str, epoch: int,
                       batches_done: int = 0) -> dict:
        """The host-side schedule position for a sidecar.  A save in the
        middle of a train sweep (``batches_done > 0``) rewinds that
        loader's shuffle-epoch counter by one, since the sweep's start
        advanced it: the resumed sweep replays the same order."""
        loader_epochs = {name: getattr(self, name + "_loader").epoch
                         for name in _LOADERS}
        if batches_done > 0:
            loader_epochs[_TRAIN_LOADER[phase]] -= 1
        train_loader = getattr(self, _TRAIN_LOADER[phase] + "_loader")
        return {"phase": phase, "epoch": int(epoch),
                "batches_done": int(batches_done),
                "num_train_batches": len(train_loader),
                "pretrain_steps": int(self.pretrain_steps),
                "adv_batch_steps": int(self.adv_batch_steps),
                "scst_step": int(self._scst_step),
                "loader_epochs": loader_epochs,
                "best": self._best}

    def _phase_resume_point(self, phase: str, train_loader) -> tuple:
        """``(start_epoch, start_batch)`` of ``phase``.  A mid-sweep resume
        whose loader no longer has the batch count the sidecar recorded
        (batch size or dataset changed) would skip the wrong batches: it
        resumes at the next epoch instead."""
        epoch, batch = sched_lib.phase_start(self._schedule, phase)
        if batch > 0:
            n = (self._schedule or {}).get("num_train_batches")
            if n is not None and int(n) != len(train_loader):
                self.log.warning(
                    "schedule sidecar recorded %s train batches/epoch but "
                    "the loader now yields %d: resuming at the next epoch "
                    "boundary (%d) instead of mid-sweep"
                    % (n, len(train_loader), epoch + 1))
                # the rewound counter of the broken epoch moves past it
                train_loader.epoch += 1
                return epoch + 1, 0
        return epoch, batch

    def _save_resumable(self, path: str, phase: str, epoch: int,
                        batches_done: int = 0, sync: bool = False):
        """The full state and its sidecar: what ``--resume`` needs to
        continue exactly here."""
        ckpt_lib.save_state(path, self.state, sync=sync)
        sched_lib.save_sidecar(
            path, self._schedule_info(phase, epoch, batches_done))

    def _save_interrupt(self, phase: str, epoch: int, batches_done: int = 0):
        path = os.path.join(self.model_dir, "interrupt_state.ckpt")
        # the process is about to end: the save must be on disk now
        self._save_resumable(path, phase, epoch, batches_done, sync=True)
        self._interrupt_saved = True
        self.log.info(
            "Interrupted: resumable state saved to %s at %s epoch %d batch "
            "%d (restart with --resume %s or --resume auto)"
            % (path, phase, epoch, batches_done, path))

    def _save_ema(self, name: str) -> None:
        """The EMA twin of a best-val save (``--ema-decay``)."""
        if self.state.ema_gen is not None:
            ckpt_lib.save_ema_checkpoint(os.path.join(self.model_dir, name),
                                         self.state, sync=False)

    def _checkpoint_if_interrupted(self, phase: str, epoch: int) -> bool:
        if not self._interrupted:
            return False
        self._save_interrupt(phase, epoch)
        return True

    def _device_batches(self, it):
        for batch in it:
            yield batch_to(batch, self.device)

    def _train_batches(self, it):
        """``(batch on the device, ends its group)`` of a train sweep: the
        batches in groups of ``--steps-per-call`` (``stack_batches``, one
        copy to the device a group), one at a time."""
        if self.steps_per_call == 1:
            for batch in self._device_batches(it):
                yield batch, True
            return
        for stacked, count in stack_batches(it, self.steps_per_call):
            stacked = batch_to(stacked, self.device)
            for j in range(count):
                yield {k: v[j] for k, v in stacked.items()}, j == count - 1

    # ----------------------------------------------------------- MLE phase

    def genpretrain_loop(self, what: str, start_batch: int = 0):
        """One sweep — reference ``genpretrain_loop`` (training.py:48-97).
        Returns the sweep's per-batch losses.  A train sweep starts at
        ``start_batch`` (the same shuffle order) and stops after the
        ``--steps-per-call`` group in flight when an interrupt is
        requested, leaving the batches applied in ``self._sweep_break``."""
        train = what == "train"
        loader = self.pre_train_loader if train else self.pre_eval_loader
        pending = []                    # (loss, grad_norm | None, step)
        self._sweep_break = None
        p = self._ss_prob
        batches = (self._train_batches(loader.iter_from(start_batch))
                   if train else
                   ((b, False) for b in self._device_batches(loader)))
        for off, (batch, group_end) in enumerate(batches):
            if train:
                self.state, metrics = self.mle_step(self.state, batch, p)
                self.pretrain_steps += 1
            else:
                self.state, metrics = self.mle_eval_step(self.state, batch, p)
            pending.append((metrics["gen_pretrain_loss"],
                            metrics.get("gen_grad_norm"),
                            self.pretrain_steps))
            if group_end and self._interrupted:
                self._sweep_break = start_batch + off + 1
                break
        tag = ("GenPreTraining_train_loss" if train
               else "GenPreTraining_val_loss")
        losses = []
        for loss, gnorm, step in _fetch(pending):
            losses.append(loss)
            self.writer.add_scalar(tag, loss, step)
            if gnorm is not None:
                self.writer.add_scalar("GenPreTraining_grad_norm", gnorm, step)
        return losses

    def pretrain_generator(self, epochs: int):
        """Reference ``pretrain_generator`` (training.py:99-126), with the
        resume point, snapshots and early stop."""
        best = self._best["pretrain"]
        if sched_lib.phase_completed(self._schedule, "pretrain"):
            return 0.0
        start_epoch, start_batch = self._phase_resume_point(
            "pretrain", self.pre_train_loader)
        self.log.info("Pretraining Generator")
        for epoch in range(start_epoch, epochs):
            if self._checkpoint_if_interrupted("pretrain", epoch):
                break
            if self.config.mle_objective == "scheduled":
                # the linear per-epoch ramp 0 → ss_max_prob
                self._ss_prob = (self.config.ss_max_prob * epoch
                                 / max(1, epochs - 1))
            sb = start_batch if epoch == start_epoch else 0
            train_loss = float(np.mean(
                self.genpretrain_loop("train", start_batch=sb) or [0]))
            if self._sweep_break is not None:
                self._save_interrupt("pretrain", epoch, self._sweep_break)
                break
            best["total"] += train_loss
            val_loss = float(np.mean(self.genpretrain_loop("val") or [0]))
            if best["loss"] is None or val_loss < best["loss"]:
                best["loss"] = val_loss
                best["since"] = 0
                ckpt_lib.save_generator_checkpoint(
                    os.path.join(self.model_dir, "pretrained_model.ckpt"),
                    self.state.gen, sync=False)
                self._save_ema("pretrained_model_ema.ckpt")
                self.log.info("Saving Best model [Gen Loss = {}] at Epoch {}"
                              .format(best["loss"], epoch))
            else:
                best["since"] += 1
            if (self.config.checkpoint_every
                    and epoch % self.config.checkpoint_every == 0):
                self._save_resumable(
                    os.path.join(self.model_dir, f"state_pre_{epoch}.ckpt"),
                    "pretrain", epoch + 1)
                ckpt_lib.prune_checkpoints(self.model_dir, "state_pre_",
                                           self.config.keep_checkpoints)
            if epoch % self.config.pre_log_step == 0:
                self.log.info("Epoch {}: \n \t Train: {} \n\t Val: {} "
                              .format(epoch, train_loss, val_loss))
            if (self.config.early_stop_patience
                    and best["since"] >= self.config.early_stop_patience):
                self.log.info(
                    "Early stop: pretrain val loss has not improved for %d "
                    "epochs (best %.6f)" % (best["since"], best["loss"]))
                break
        return best["total"] / epochs if epochs else 0

    # ---------------------------------------------------------- SCST phase

    def scst_finetune(self, epochs: int):
        """Self-critical sequence training (``--scst-epochs``,
        ``train/scst.py``): per train batch a rollout, the host reward and
        one update; per epoch a val sweep of the greedy reward.  The best
        val reward writes ``scst_model.ckpt``."""
        if epochs <= 0 or sched_lib.phase_completed(self._schedule, "scst"):
            return
        config = self.config
        start_epoch, start_batch = self._phase_resume_point(
            "scst", self.pre_train_loader)
        self.log.info("SCST finetuning (%d epochs, reward=%s)"
                      % (epochs, config.scst_reward))
        train_refs = val_refs = None
        if config.scst_multi_ref:
            train_refs = scst_lib.build_row_references(self.train_dataset,
                                                       True)
            val_refs = scst_lib.build_row_references(self.dev_dataset, True)
        reward_fn = scst_lib.build_reward_fn(config, self.train_dataset,
                                             row_refs=train_refs)
        rollout, update, greedy_only = scst_lib.make_scst_programs(config)
        best = self._best["scst"]
        for epoch in range(start_epoch, epochs):
            if self._checkpoint_if_interrupted("scst", epoch):
                break
            t0 = time.time()
            advs, losses = [], []
            sb = start_batch if epoch == start_epoch else 0
            interrupted_at = None
            for off, batch in enumerate(self.pre_train_loader.iter_from(sb)):
                dev = batch_to(batch, self.device)
                # the global SCST step seeds the noise: a resumed run
                # draws what the uninterrupted one drew
                rng = scst_lib.rollout_generator(config.seed,
                                                 self._scst_step, self.device)
                sampled, greedy = rollout(self.state.gen, dev, rng)
                adv = scst_lib.batch_advantage(
                    reward_fn, sampled.cpu().numpy(), greedy.cpu().numpy(),
                    batch["captions"], row_refs=train_refs,
                    index=batch.get("index"))
                adv *= batch["weights"]     # pad rows: no gradient
                self.state, loss = update(
                    self.state, dev, sampled,
                    torch.from_numpy(adv).to(self.device))
                advs.append(float(adv.mean()))
                losses.append(loss)
                self._scst_step += 1
                if self._interrupted:
                    interrupted_at = sb + off + 1
                    break
            if interrupted_at is not None:
                self._save_interrupt("scst", epoch, interrupted_at)
                break
            val_sum, val_n = 0.0, 0
            for batch in self.pre_eval_loader:
                greedy = greedy_only(self.state.gen,
                                     batch_to(batch, self.device))
                s, c = scst_lib.batch_reward(
                    reward_fn, greedy.cpu().numpy(), batch["captions"],
                    row_refs=val_refs, index=batch.get("index"),
                    weights=batch["weights"])
                val_sum += s
                val_n += c
            val_r = val_sum / max(val_n, 1)
            train_loss = (float(torch.stack(losses).mean()) if losses
                          else 0.0)
            self.writer.add_scalar("SCST_val_reward", val_r, self._scst_step)
            self.writer.add_scalar("SCST_train_loss", train_loss,
                                   self._scst_step)
            if best["reward"] is None or val_r > best["reward"]:
                best["reward"] = val_r
                ckpt_lib.save_generator_checkpoint(
                    os.path.join(self.model_dir, "scst_model.ckpt"),
                    self.state.gen, sync=False)
                self.log.info("Saving Best SCST model [val %s = %.4f] at "
                              "Epoch %d" % (config.scst_reward,
                                            best["reward"], epoch))
            self.log.info(
                "[SCST] epoch %d: val %s %.4f | mean advantage %.4f | "
                "loss %.5f  [%.1fs]" % (
                    epoch, config.scst_reward, val_r,
                    float(np.mean(advs or [0])), train_loss,
                    time.time() - t0))

    # ---------------------------------------------------- adversarial phase

    def _temperature(self, adv_epoch: int, batch_frac: float) -> float:
        """Reference ramp (training.py:183,190-191): fractional-epoch
        progress over N = adv_epochs."""
        return get_fixed_temperature(
            self.config.temperature, adv_epoch + batch_frac,
            self.config.adv_epochs, self.config.temp_adpt)

    def adv_loop(self, what: str, adv_epoch: int, start_batch: int = 0):
        """One sweep — reference ``adv_loop`` (training.py:128-188).
        Returns the mean generator and discriminator losses.  Train
        sweeps resume at ``start_batch`` and stop on an interrupt as
        :meth:`genpretrain_loop` does; the temperature ramp reads the
        global batch index, so a resumed epoch continues it."""
        train = what == "train"
        loader = self.adv_train_loader if train else self.adv_eval_loader
        num_batches = max(len(loader), 1)
        temp = float(self.state.temperature) or 1.0
        step = self.state.gen_steps
        pending = []         # (g_loss, d_loss, g_norm | None, d_norm | None,
        #                       step)
        t_sweep = time.time()
        self._sweep_break = None
        batches = (self._train_batches(loader.iter_from(start_batch))
                   if train else
                   ((b, False) for b in self._device_batches(loader)))
        for off, (batch, group_end) in enumerate(batches):
            if train:
                temp = self._temperature(
                    adv_epoch, (start_batch + off + 1) / num_batches)
                self.state, metrics = self.adv_step(self.state, batch, temp)
                self.adv_batch_steps += 1
                step += 1
            else:
                self.state, metrics = self.adv_eval_step(self.state, batch,
                                                         temp)
            pending.append((metrics["gen_adv_loss"], metrics["disc_adv_loss"],
                            metrics.get("gen_grad_norm"),
                            metrics.get("disc_grad_norm"), step))
            if group_end and self._interrupted:
                self._sweep_break = start_batch + off + 1
                break
        g_tag, d_tag = (("Generator_train_loss", "Discriminator_train_loss")
                        if train else
                        ("Generator_val_loss", "Discriminator_val_loss"))
        g_losses, d_losses = [], []
        for g, d, gn, dn, s in _fetch(pending):
            g_losses.append(g)
            d_losses.append(d)
            self.writer.add_scalar(d_tag, d, s)
            self.writer.add_scalar(g_tag, g, s)
            if gn is not None:
                self.writer.add_scalar("Generator_grad_norm", gn, s)
                self.writer.add_scalar("Discriminator_grad_norm", dn, s)
        if train and g_losses:
            rate = len(g_losses) / max(time.time() - t_sweep, 1e-9)
            self.writer.add_scalar("adv_steps_per_sec", rate, step)
        return float(np.mean(g_losses or [0])), float(np.mean(d_losses or [0]))

    # ------------------------------------------------------- quality eval

    @torch.no_grad()
    def _quality_decode(self, batch):
        """The eval decode's ids: beam search when ``beam_size > 1``, else
        greedy (in early-stopping chunks under ``eval_adaptive_chunk``)."""
        config, gen = self.config, self.state.gen
        cond, _ = api.generator_condition(config, gen, batch, train=False)
        feats, ctx = cond["features"], cond["context"]
        if config.beam_size > 1:
            return decode_lib.beam_search(
                gen, feats, config, beam_size=config.beam_size,
                length_penalty=config.length_penalty, context=ctx)[0]
        if config.eval_adaptive_chunk > 0:
            return decode_lib.greedy_with_logprobs_adaptive(
                gen, feats, config, context=ctx,
                chunk=config.eval_adaptive_chunk)[0]
        return decode_lib.greedy(gen, feats, config, context=ctx)

    def evaluate_quality(self, max_batches=None):
        """NLL_gen, BLEU-4 and self-BLEU on the dev set (the report's
        metrics, NLP_Report.pdf §4.3), with two decoded captions in the log
        as ``[SAMPLE]`` lines.  The losses and ids are read from the device
        once, after the sweep."""
        nll_dev, gen_dev, real_batches, weight_batches = [], [], [], []
        for i, batch in enumerate(self.pre_eval_loader):
            if max_batches is not None and i >= max_batches:
                break
            batch_dev = batch_to(batch, self.device)
            self.state, metrics = self.mle_eval_step(self.state, batch_dev)
            nll_dev.append(metrics["gen_pretrain_loss"])
            gen_dev.append(self._quality_decode(batch_dev))
            real_batches.append(batch["captions"])
            weight_batches.append(batch.get("weights"))
        nll = torch.stack(nll_dev).tolist() if nll_dev else []
        gen_batches = [ids.cpu().numpy() for ids in gen_dev]
        bleu4 = bleu4_from_batches(gen_batches, real_batches, weight_batches)
        # mode-collapse probe: self-BLEU of the generated corpus (1.0 =
        # every caption identical)
        gen_caps = [strip_caption(row)
                    for ids_b, w_b in zip(gen_batches, weight_batches)
                    for row, w in zip(ids_b, w_b if w_b is not None
                                      else [1] * len(ids_b)) if w != 0]
        if getattr(self.dev_dataset, "index_to_word", None) and gen_batches:
            vocab = text_vocab(self.dev_dataset)
            for row, ref in list(zip(gen_batches[0], real_batches[0]))[:2]:
                self.log.info("[SAMPLE] gen: %s | ref: %s" % (
                    caption_text(row, vocab), caption_text(ref, vocab)))
        return {"nll_gen": float(np.mean(nll or [0])), "bleu4": bleu4,
                "self_bleu4": self_bleu(gen_caps)}

    @contextlib.contextmanager
    def _profiling(self, adv_epoch: int):
        """``--profile-dir``: ``torch.profiler`` (CPU and, on the card,
        CUDA activity) around the train sweep of adversarial epoch 0; its
        Chrome trace is written into the directory as
        ``adv_epoch0.trace.json`` when the sweep ends, however it ends."""
        if not self.config.profile_dir or adv_epoch != 0:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.config.profile_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.__enter__()
        try:
            yield
        finally:
            prof.__exit__(None, None, None)
            path = os.path.join(self.config.profile_dir,
                                "adv_epoch0.trace.json")
            prof.export_chrome_trace(path)
            self.log.info("Profiler trace of adversarial epoch 0 written to "
                          "%s" % path)

    def _run(self):
        """The full schedule — reference ``_run`` (training.py:201-235), with
        the SCST phase and the resume point of each phase.  Ends with the
        checkpoint barrier, the metric file closed and the previous signal
        handlers back."""
        nans = (debug_nans(self.state) if self.config.debug_nans
                else contextlib.nullcontext())
        try:
            with nans:
                self._run_phases()
        finally:
            self._restore_signal_handlers()
            ckpt_lib.wait_for_checkpoints()
            self.writer.close()

    def _run_phases(self):
        config = self.config
        self.pretrain_generator(config.pretrain_epochs)
        if self._interrupted:
            if not self._interrupt_saved:
                # the signal came in the phase's last val sweep: resume at
                # the next phase's start
                self._save_interrupt(
                    "scst" if config.scst_epochs > 0 else "adv", 0)
            return
        self.scst_finetune(config.scst_epochs)
        if self._interrupted:
            if not self._interrupt_saved:
                self._save_interrupt("adv", 0)
            return

        start_epoch, start_batch = self._phase_resume_point(
            "adv", self.adv_train_loader)
        self.log.info("Starting Adversarial Training...")
        best = self._best["adv"]
        next_epoch = start_epoch
        for adv_epoch in range(start_epoch, config.adv_epochs):
            if self._checkpoint_if_interrupted("adv", adv_epoch):
                break
            t_start = time.time()
            sb = start_batch if adv_epoch == start_epoch else 0
            with self._profiling(adv_epoch):
                train_g, train_d = self.adv_loop("train", adv_epoch,
                                                 start_batch=sb)
            if self._sweep_break is not None:
                self._save_interrupt("adv", adv_epoch, self._sweep_break)
                break
            next_epoch = adv_epoch + 1
            val_g, val_d = self.adv_loop("val", adv_epoch)
            if best["loss"] is None or val_g < best["loss"]:
                best["loss"] = val_g
                best["since"] = 0
                ckpt_lib.save_generator_checkpoint(
                    os.path.join(self.model_dir, "adv_model.ckpt"),
                    self.state.gen, self.state.disc.state_dict(), sync=False)
                self._save_ema("adv_model_ema.ckpt")
                self.log.info("Saving Best model [Gen Loss = {}] at Epoch {}"
                              .format(best["loss"], adv_epoch))
            else:
                best["since"] += 1
            if (config.checkpoint_every
                    and adv_epoch % config.checkpoint_every == 0):
                self._save_resumable(
                    os.path.join(self.model_dir, f"state_{adv_epoch}.ckpt"),
                    "adv", adv_epoch + 1)
                ckpt_lib.prune_checkpoints(self.model_dir, "state_",
                                           config.keep_checkpoints)
            if (adv_epoch % config.adv_log_step == 0
                    or adv_epoch == config.adv_epochs - 1):
                self.log.info(
                    "[ADV] epoch %d (temperature: %.4f):\n\t g_loss: %.4f | "
                    "%.4f \n\t d_loss: %.4f | %.4f  [%.1fs]" % (
                        adv_epoch, self.state.temperature, train_g, val_g,
                        train_d, val_d, time.time() - t_start))
            if (config.eval_bleu_every
                    and adv_epoch % config.eval_bleu_every == 0):
                q = self.evaluate_quality()
                step = int(self.state.gen_steps)
                self.writer.add_scalar("NLL_gen", q["nll_gen"], step)
                self.writer.add_scalar("BLEU4", q["bleu4"], step)
                self.writer.add_scalar("SelfBLEU4", q["self_bleu4"], step)
                self.log.info("[EVAL] NLL_gen %.4f | BLEU-4 %.5f | "
                              "self-BLEU %.4f"
                              % (q["nll_gen"], q["bleu4"], q["self_bleu4"]))
            if (config.early_stop_patience
                    and best["since"] >= config.early_stop_patience):
                self.log.info(
                    "Early stop: adversarial val g_loss has not improved "
                    "for %d epochs (best %.6f)" % (best["since"],
                                                   best["loss"]))
                break
        if self._interrupted and not self._interrupt_saved:
            # the signal came in a val sweep or after the last epoch: the
            # finished train sweeps are kept
            self._save_interrupt("adv", next_epoch)


def _fetch(pending):
    """Each row's 0-d tensors as floats (None stays None), read from the
    device in one copy."""
    flat = [v for row in pending for v in row[:-1] if v is not None]
    values = iter(torch.stack(flat).tolist() if flat else [])
    return [tuple(None if v is None else next(values) for v in row[:-1])
            + (row[-1],) for row in pending]
