"""GANInstructor: the training loop
(``gan_image_captioning_tpu/train/instructor.py``).

Drives the reference's two-phase schedule (``training.py:15-235``) over the
port's steps:

* MLE pre-training (:meth:`GANInstructor.pretrain_generator`): per epoch a
  train sweep and a val sweep; the best val loss writes
  ``pretrained_model.ckpt``.
* Adversarial training (:meth:`GANInstructor._run`, :meth:`adv_loop`): one
  step per train batch with the temperature ramped over fractional epochs
  (``training.py:183``), the discriminator updated every
  ``disc_train_freq`` generator steps; the best val generator loss writes
  ``adv_model.ckpt`` (generator, discriminator and the ``conditional``
  flag).

With ``--eval-bleu-every N`` the adversarial epochs 0, N, 2N, ... end
with :meth:`GANInstructor.evaluate_quality` (NLL_gen, BLEU-4 and self-BLEU
on the val set, logged as ``[EVAL]`` and written as ``NLL_gen``,
``BLEU4`` and ``SelfBLEU4``).

As in the JAX package, the temperature and the step counters do not
advance during val sweeps.  Scalars go to ``metrics.jsonl`` with the JAX
package's tags; each sweep's metrics are read from the device once, at
its end.  Batches are built in this thread and copied to the device before
their step (``--num-workers`` / ``--device-prefetch`` are accepted and
change nothing but overlap in the JAX package).  Interrupt and resume,
snapshots, early stop, SCST, multi-step calls, meshes,
cached features and EMA are not ported: their flags raise
(``config.require_ported_flags``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gan_image_captioning_tpu_torch.config import (Config, require_ported_flags,
                                                   resolve_device)
from gan_image_captioning_tpu_torch.data.loader import Batcher
from gan_image_captioning_tpu_torch.eval import decode as decode_lib
from gan_image_captioning_tpu_torch.eval.diversity import self_bleu
from gan_image_captioning_tpu_torch.eval.metrics import (bleu4_from_batches,
                                                         ids_to_words,
                                                         strip_caption)
from gan_image_captioning_tpu_torch.models import api
from gan_image_captioning_tpu_torch.ops.temperature import get_fixed_temperature
from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib
from gan_image_captioning_tpu_torch.train.state import (create_train_state,
                                                        with_generator)
from gan_image_captioning_tpu_torch.train.steps import (
    batch_to, make_adv_eval_step, make_adv_step, make_mle_eval_step,
    make_mle_step)
from gan_image_captioning_tpu_torch.utils.logging import (MetricWriter,
                                                          create_logger)


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
        if config.init_gen_ckpt:
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

        seq = config.seq_len
        self.pre_train_loader = Batcher(
            train_dataset, config.pre_train_batch_size, seq, shuffle=True,
            seed=config.seed, drop_last=True)
        self.pre_eval_loader = Batcher(dev_dataset, config.pre_eval_batch_size,
                                       seq)
        self.adv_train_loader = Batcher(
            train_dataset, config.adv_train_batch_size, seq, shuffle=True,
            seed=config.seed + 1, drop_last=True)
        self.adv_eval_loader = Batcher(dev_dataset, config.adv_eval_batch_size,
                                       seq)
        self.pretrain_steps = 0
        self.adv_batch_steps = 0

    def _device_batches(self, it):
        for batch in it:
            yield batch_to(batch, self.device)

    # ----------------------------------------------------------- MLE phase

    def genpretrain_loop(self, what: str):
        """One sweep — reference ``genpretrain_loop`` (training.py:48-97).
        Returns the sweep's per-batch losses."""
        train = what == "train"
        loader = self.pre_train_loader if train else self.pre_eval_loader
        pending = []                    # (loss, grad_norm | None, step)
        for batch in self._device_batches(iter(loader)):
            if train:
                self.state, metrics = self.mle_step(self.state, batch)
                self.pretrain_steps += 1
            else:
                self.state, metrics = self.mle_eval_step(self.state, batch)
            pending.append((metrics["gen_pretrain_loss"],
                            metrics.get("gen_grad_norm"),
                            self.pretrain_steps))
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
        """Reference ``pretrain_generator`` (training.py:99-126)."""
        self.log.info("Pretraining Generator")
        best, total = None, 0.0
        for epoch in range(epochs):
            train_loss = float(np.mean(self.genpretrain_loop("train") or [0]))
            total += train_loss
            val_loss = float(np.mean(self.genpretrain_loop("val") or [0]))
            if best is None or val_loss < best:
                best = val_loss
                ckpt_lib.save_generator_checkpoint(
                    os.path.join(self.model_dir, "pretrained_model.ckpt"),
                    self.state.gen)
                self.log.info("Saving Best model [Gen Loss = {}] at Epoch {}"
                              .format(best, epoch))
            if epoch % self.config.pre_log_step == 0:
                self.log.info("Epoch {}: \n \t Train: {} \n\t Val: {} "
                              .format(epoch, train_loss, val_loss))
        return total / epochs if epochs else 0

    # ---------------------------------------------------- adversarial phase

    def _temperature(self, adv_epoch: int, batch_frac: float) -> float:
        """Reference ramp (training.py:183,190-191): fractional-epoch
        progress over N = adv_epochs."""
        return get_fixed_temperature(
            self.config.temperature, adv_epoch + batch_frac,
            self.config.adv_epochs, self.config.temp_adpt)

    def adv_loop(self, what: str, adv_epoch: int):
        """One sweep — reference ``adv_loop`` (training.py:128-188).
        Returns the mean generator and discriminator losses."""
        train = what == "train"
        loader = self.adv_train_loader if train else self.adv_eval_loader
        num_batches = max(len(loader), 1)
        temp = float(self.state.temperature) or 1.0
        step = self.state.gen_steps
        pending = []         # (g_loss, d_loss, g_norm | None, d_norm | None,
        #                       step)
        t_sweep = time.time()
        for i, batch in enumerate(self._device_batches(iter(loader))):
            if train:
                temp = self._temperature(adv_epoch, (i + 1) / num_batches)
                self.state, metrics = self.adv_step(self.state, batch, temp)
                self.adv_batch_steps += 1
                step += 1
            else:
                self.state, metrics = self.adv_eval_step(self.state, batch,
                                                         temp)
            pending.append((metrics["gen_adv_loss"], metrics["disc_adv_loss"],
                            metrics.get("gen_grad_norm"),
                            metrics.get("disc_grad_norm"), step))
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
        feats = cond["features"]
        if config.beam_size > 1:
            return decode_lib.beam_search(
                gen, feats, config, beam_size=config.beam_size,
                length_penalty=config.length_penalty)[0]
        if config.eval_adaptive_chunk > 0:
            return decode_lib.greedy_with_logprobs_adaptive(
                gen, feats, config, chunk=config.eval_adaptive_chunk)[0]
        return decode_lib.greedy(gen, feats, config)

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
        i2w = getattr(self.dev_dataset, "index_to_word", None)
        if i2w and gen_batches:
            for row, ref in list(zip(gen_batches[0], real_batches[0]))[:2]:
                self.log.info("[SAMPLE] gen: %s | ref: %s" % (
                    " ".join(ids_to_words(strip_caption(row), i2w)),
                    " ".join(ids_to_words(strip_caption(ref), i2w))))
        return {"nll_gen": float(np.mean(nll or [0])), "bleu4": bleu4,
                "self_bleu4": self_bleu(gen_caps)}

    def _run(self):
        """The full schedule — reference ``_run`` (training.py:201-235)."""
        self.pretrain_generator(self.config.pretrain_epochs)
        self.log.info("Starting Adversarial Training...")
        best = None
        for adv_epoch in range(self.config.adv_epochs):
            t_start = time.time()
            train_g, train_d = self.adv_loop("train", adv_epoch)
            val_g, val_d = self.adv_loop("val", adv_epoch)
            if best is None or val_g < best:
                best = val_g
                ckpt_lib.save_generator_checkpoint(
                    os.path.join(self.model_dir, "adv_model.ckpt"),
                    self.state.gen, self.state.disc.state_dict())
                self.log.info("Saving Best model [Gen Loss = {}] at Epoch {}"
                              .format(best, adv_epoch))
            if (adv_epoch % self.config.adv_log_step == 0
                    or adv_epoch == self.config.adv_epochs - 1):
                self.log.info(
                    "[ADV] epoch %d (temperature: %.4f):\n\t g_loss: %.4f | "
                    "%.4f \n\t d_loss: %.4f | %.4f  [%.1fs]" % (
                        adv_epoch, self.state.temperature, train_g, val_g,
                        train_d, val_d, time.time() - t_start))
            if (self.config.eval_bleu_every
                    and adv_epoch % self.config.eval_bleu_every == 0):
                q = self.evaluate_quality()
                step = int(self.state.gen_steps)
                self.writer.add_scalar("NLL_gen", q["nll_gen"], step)
                self.writer.add_scalar("BLEU4", q["bleu4"], step)
                self.writer.add_scalar("SelfBLEU4", q["self_bleu4"], step)
                self.log.info("[EVAL] NLL_gen %.4f | BLEU-4 %.5f | "
                              "self-BLEU %.4f"
                              % (q["nll_gen"], q["bleu4"], q["self_bleu4"]))
        self.writer.close()


def _fetch(pending):
    """Each row's 0-d tensors as floats (None stays None), read from the
    device in one copy."""
    flat = [v for row in pending for v in row[:-1] if v is not None]
    values = iter(torch.stack(flat).tolist() if flat else [])
    return [tuple(None if v is None else next(values) for v in row[:-1])
            + (row[-1],) for row in pending]
