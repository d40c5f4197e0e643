"""The MLE and adversarial training steps
(``gan_image_captioning_tpu/train/steps.py``).

* :func:`make_mle_step` — free-running pretrain sample (greedy ids from
  the decode kernel, then the differentiable teacher-forced rescore) or
  teacher forcing, cross-entropy over all positions, clipped Adam at
  ``pretrain_lr``.
* Conditional (``--conditional-gan 1``): each step runs the image encoder
  exactly once, in train mode (``api.generator_condition``), so every
  BatchNorm running statistic moves once per step, as the JAX steps merge
  one ``new_stats`` per step (``steps.py:230,292,411,665``); the decode
  and its rescore read the features and never re-run it.  ``images_u8``
  batches go through the ``image_norm`` kernel first.  A conditional
  transformer gets the encoder's grid from the same pass and every
  decode, teacher-forced pass and rollout cross-attends over it.
* :func:`make_mle_eval_step` / :func:`make_adv_eval_step` — the losses in
  eval mode (running statistics read, not moved; no dropout, no label
  noise; no update), without gradients.
* The transformer generator's MLE step is the parallel causal pass with
  the keys past each caption's ``lengths`` masked (flash attention).
* ``--adv-objective reinforce`` (``train/reinforce.py``): the sampled ids,
  rollout rewards, the REINFORCE generator loss and the discriminator's
  loss on real against sampled ids; one backward of ``g_loss + d_loss``
  gives both gradient sets there too, since no cross term exists.
* :func:`make_adv_step` — one Gumbel-softmax sample, the reference's three
  discriminator passes (real, detached fake, generator), both losses and
  ONE backward of ``g_loss + d_loss`` that gives both gradient sets (the
  JAX ``adv_losses(grad_side="both")`` single-forward pullback): the fake
  pass reads ``soft.detach()``, the generator pass runs with detached
  discriminator parameters and ``g_loss`` reads a detached ``d_real``, so
  no cross term reaches either side.  The sample takes the decode route
  of ``decode_route(config)``; under ``kernel_embed`` it arrives already
  embedded by the CNN discriminator, as two tensors of one value, the
  fake pass's (gradient to the embedding weight only) and the generator
  pass's (gradient to the generator only): the same cut, made at the
  embedding.  The discriminator updates when
  ``gen_steps % disc_train_freq == 0``; the generator every step.

Batches are dicts of tensors on the models' device: ``captions [B, L]``
int, optionally ``lengths [B]`` and ``weights [B]`` (0 on pad rows).
Every random draw of a step can be fed through ``noise``: ``uniforms [T,
B, V]`` (the Gumbel uniforms), ``keep`` (the dropout keep masks, real /
fake / generator pass, of ``api.disc_keep_shape``: ``[B·R, F]`` for the
CNN) and ``flip [B]`` (the noisy-label swap), and for REINFORCE
``rollout_uniforms`` and a ``seed`` (``train/reinforce.py``); what is not
fed is drawn from ``state.generator``.  A step updates the state in
place and returns it with its metrics (0-d tensors).

Step options (the JAX ``make_mle_step`` / ``make_adv_step`` options):

* ``--grad-accum k``: the batch is cut into k contiguous microbatches
  (:func:`split_micro`, the JAX ``_split_micro``); each runs its own
  forward and backward with its own noise (``noise``: a sequence of k
  dicts, one a microbatch, or draws from ``state.generator`` in turn);
  the gradients are summed in microbatch order and divided by k, the
  losses likewise, and ONE clipped Adam update follows.  A conditional
  generator's BatchNorm statistics are those of the last microbatch, each
  computed from the running statistics before the step (the JAX scan
  keeps the last microbatch's ``new_stats``): the running buffers are put
  back before every microbatch after the first, since each train-mode
  forward moves them in place.
* ``--skip-nonfinite-grads 1`` (the JAX ``_guard_nonfinite``): a side
  whose pre-clip gradient norm is not finite keeps its parameters, Adam
  state (its count included) and the EMA, and a conditional generator
  its running statistics; the step counters advance.  The norms are read
  on the host once a step (one ``.tolist()`` of both, a device sync);
  with the flag off a step reads nothing.
* ``--ema-decay d``: after each generator update ``state.ema_gen`` moves
  towards the generator (``state.ema_update``).
* ``--lr-schedule`` and its warmup: every update takes its lr from
  ``state.lr_at`` at the optimizer's count.
* ``--mle-objective scheduled``: the MLE steps take ``sample_prob``, the
  model-feedback probability, and the per-step coins ``[T, B]``
  (``noise["coins"]``, else drawn from ``state.generator``).
* ``--debug-nans``: a step raises ``FloatingPointError`` naming the first
  non-finite loss, and then the first non-finite gradient by parameter
  name (:func:`check_finite`); :func:`debug_nans` adds forward hooks on
  every submodule and autograd's anomaly mode around a run.
* :func:`make_multi_step` (``--steps-per-call K``): K steps in one call
  over batches stacked ``[K, ...]``, metrics stacked ``[K]``; a loop over
  the single step, so its state after the call is the state after K
  single steps.

``--dtype bfloat16`` (the JAX ``_compute_cast``): the MLE, Gumbel
adversarial and REINFORCE losses, and their eval steps, run inside
:func:`compute_cast`, for either generator and any discriminator — every
floating parameter of both models and every floating batch entry the
generator is conditioned on reads as a bfloat16 copy made by a cast that
autograd differentiates, so the gradients come back through it to the
float32 masters, which the Adam states and the checkpoints keep.  The
losses are reduced in float32 (the MLE logits, the discriminator outputs
and REINFORCE's log-softmax are cast first), the Gumbel temperature is
rounded to bfloat16 before the sample reads it, and a conditional
generator's BatchNorm running statistics are kept in bfloat16 once a
bfloat16 train step has moved them (the JAX steps merge the bfloat16
``new_stats`` of the encoder pass into the state).  SCST stays float32,
as in the JAX package (``train/scst.py`` takes no cast).
``Config.bf16_grads`` (the JAX ``GIC_BF16_GRADS=1``, under ``--dtype
bfloat16``): the adversarial step differentiates with respect to
bfloat16 copies of the parameters (:func:`bf16_grad_leaves`), so every
gradient accumulates in bfloat16, then casts it to the float32 master;
master weights and Adam moments stay float32.

Augmentation (``--random-flip`` / ``--random-crop-pad``, the JAX
``_augment_batch``): a conditional train step flips and translates its
``images`` or ``images_u8`` (``ops/augment.py``) after the cast and
before the encoder; ``noise["augment"]`` feeds the coins and offsets
(``{"coin", "oy", "ox"}``), else they are drawn from a device generator
seeded from ``state.generator``.  With both flags off nothing is drawn.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from gan_image_captioning_tpu_torch.config import (Config, compute_dtype,
                                                   decode_route)
from gan_image_captioning_tpu_torch.models import api
from gan_image_captioning_tpu_torch.models import discriminator as disc_cnn
from gan_image_captioning_tpu_torch.models import encoder as encoder_lib
from gan_image_captioning_tpu_torch.models import generator as gen_lstm
from gan_image_captioning_tpu_torch.models.discriminator import params_of
from gan_image_captioning_tpu_torch.ops.augment import augment_images
from gan_image_captioning_tpu_torch.ops.losses import (cross_entropy_loss,
                                                        gan_losses)
from gan_image_captioning_tpu_torch.train.reinforce import reinforce_losses
from gan_image_captioning_tpu_torch.train.state import (
    TrainState, clip_adam_update, ema_update, global_norm,
    require_ported_training, trainable_parameters)


def _running_stats(module: torch.nn.Module):
    """``(submodule, name)`` of every floating running statistic of
    ``module`` (the BatchNorm buffers)."""
    return [(m, n) for m in module.modules()
            for n, b in m._buffers.items()
            if b is not None and b.is_floating_point()]


@contextlib.contextmanager
def compute_cast(config: Config, *modules: torch.nn.Module,
                 train: bool = True):
    """``--dtype bfloat16``: inside the block every floating parameter of
    ``modules`` reads as its bfloat16 copy, ``p.to(torch.bfloat16)``, one
    cast per parameter that autograd differentiates (the gradient of the
    float32 master is the bfloat16 gradient of its copy, widened); the
    masters are put back on exit, so an optimizer, the EMA and a
    checkpoint see them unchanged.  The running statistics read as
    bfloat16 too: a train-mode block (``train``) stores them in bfloat16
    for good, since its forward moves them, as the JAX steps keep the
    bfloat16 statistics of their encoder pass; an eval-mode one reads
    bfloat16 copies and puts the buffers back.  float32: nothing
    changes."""
    dtype = compute_dtype(config)
    if dtype == torch.float32:
        yield
        return
    swapped, casts = [], {}
    for module in modules:
        for m in module.modules():
            for name, p in m._parameters.items():
                if p is not None and p.is_floating_point():
                    if id(p) not in casts:
                        casts[id(p)] = p.to(dtype)
                    swapped.append((m._parameters, name, p, casts[id(p)]))
        for m, name in _running_stats(module):
            buf = m._buffers[name]
            if train:
                m._buffers[name] = buf.to(dtype)
            else:
                swapped.append((m._buffers, name, buf, buf.to(dtype)))
    for table, name, _, cast in swapped:
        table[name] = cast
    try:
        yield
    finally:
        for table, name, master, _ in swapped:
            table[name] = master


def cast_batch(config: Config, batch: Dict[str, torch.Tensor]):
    """The batch with every floating entry in bfloat16 under ``--dtype
    bfloat16`` (the JAX ``_compute_cast`` of the batch: images), else
    itself; captions, lengths and uint8 images keep their dtype."""
    dtype = compute_dtype(config)
    if dtype == torch.float32:
        return batch
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in batch.items()}


@contextlib.contextmanager
def bf16_grad_leaves(config: Config, *modules: torch.nn.Module):
    """``Config.bf16_grads`` under ``--dtype bfloat16`` (the JAX
    ``_grad_boundary``): inside the block every floating parameter of
    ``modules`` is a bfloat16 leaf, a detached copy that requires
    gradients as its master does, so a backward run there accumulates
    bfloat16 gradients (:func:`compute_cast` then reads the leaves as they
    are); the masters are put back on exit.  Yields whether it swapped:
    the caller casts the gradients to the masters' dtype.  Otherwise
    nothing changes."""
    if not (config.bf16_grads and compute_dtype(config) == torch.bfloat16):
        yield False
        return
    swapped = []
    for module in modules:
        for m in module.modules():
            for name, p in m._parameters.items():
                if p is not None and p.is_floating_point():
                    leaf = p.detach().to(torch.bfloat16).requires_grad_(
                        p.requires_grad)
                    swapped.append((m._parameters, name, p))
                    m._parameters[name] = leaf
    try:
        yield True
    finally:
        for table, name, master in swapped:
            table[name] = master


def augment_batch(config: Config, state: TrainState, batch,
                  train: bool = True, noise=None):
    """The JAX ``_augment_batch``: a conditional train step's ``images``
    or ``images_u8`` through ``ops/augment.augment_images`` under
    ``--random-flip`` / ``--random-crop-pad``, with the coins and offsets
    of ``noise["augment"]`` or drawn from a device generator seeded from
    ``state.generator``; else (eval, unconditional, both flags off, cached
    features) the batch itself, and nothing is drawn."""
    if not (train and config.cgan
            and (config.random_flip or config.random_crop_pad)):
        return batch
    key = next((k for k in ("images", "images_u8") if k in batch), None)
    if key is None:
        return batch
    fed = (noise or {}).get("augment") or {}
    imgs = batch[key]
    draw = None
    if any(fed.get(k) is None for k in ("coin", "oy", "ox")):
        draw = torch.Generator(device=imgs.device).manual_seed(
            _draw_seed(state))
    return dict(batch, **{key: augment_images(
        imgs, bool(config.random_flip), int(config.random_crop_pad),
        fed.get("coin"), fed.get("oy"), fed.get("ox"), draw)})


def compute_temperature(config: Config, temperature) -> float:
    """The Gumbel temperature the sample reads: rounded to bfloat16 under
    ``--dtype bfloat16`` (the JAX step keeps it in the compute dtype, and
    its kernel gets that value as a float32 scalar), else float32."""
    return float(torch.tensor(float(temperature),
                              dtype=compute_dtype(config)))


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A :func:`~gan_image_captioning_tpu_torch.data.loader.make_batch`
    dict as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _grads(loss, *modules) -> List[Dict[str, torch.Tensor]]:
    """One backward of ``loss``; per module, the gradients of its trainable
    parameters by name (zeros where a parameter does not reach the
    loss)."""
    params = [trainable_parameters(m) for m in modules]
    flat = [p for ps in params for p in ps.values()]
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    return [{k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(ps.items(), grads)} for ps in params]


def _draw_seed(state: TrainState) -> int:
    return int(torch.randint(2 ** 62, (), generator=state.generator))


def split_micro(batch: Dict[str, torch.Tensor],
                k: int) -> List[Dict[str, torch.Tensor]]:
    """``--grad-accum k``: the batch as k contiguous microbatches of B / k
    rows (views), the JAX ``_split_micro``'s ``[k, B/k, ...]`` reshape."""
    for v in batch.values():
        if v.shape[0] % k != 0:
            raise ValueError("--grad-accum %d does not divide batch size %d"
                             % (k, v.shape[0]))
    if k == 1:
        return [batch]
    return [{key: v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))[i]
             for key, v in batch.items()} for i in range(k)]


def _micro_noise(noise, k: int) -> list:
    """One noise dict (or None) a microbatch: ``noise`` itself when k is
    1, else a sequence of k dicts."""
    if k == 1:
        return [noise]
    if noise is None:
        return [None] * k
    if len(noise) != k:
        raise ValueError(f"--grad-accum {k}: expected {k} noise dicts, one "
                         f"a microbatch, got {len(noise)}")
    return list(noise)


def _stats_snapshot(state: TrainState):
    """A copy of the conditional generator's BatchNorm running statistics
    (None for an unconditional generator)."""
    enc = getattr(state.gen, "encoder", None)
    if enc is None:
        return None
    return {k: v.clone() for k, v in encoder_lib.bn_stats(enc).items()}


@torch.no_grad()
def _stats_restore(state: TrainState, snapshot) -> None:
    if snapshot is None:
        return
    stats = encoder_lib.bn_stats(state.gen.encoder)
    for k, v in snapshot.items():
        stats[k].copy_(v)


def _finite(*norms) -> List[bool]:
    """Whether each 0-d norm is finite: one read from the device."""
    return torch.isfinite(torch.stack(norms)).tolist()


def check_finite(config: Config, kind: str,
                 values: Dict[str, torch.Tensor]) -> None:
    """``--debug-nans``: raise ``FloatingPointError`` naming the first
    entry of ``values`` (losses, or gradients by parameter name) that has
    a non-finite element.  Nothing is read when the flag is off."""
    if not config.debug_nans:
        return
    for name, v in values.items():
        if not bool(torch.isfinite(v).all()):
            raise FloatingPointError(f"--debug-nans: non-finite {kind} "
                                     f"{name}")


@contextlib.contextmanager
def debug_nans(state: TrainState):
    """``--debug-nans`` around a run: a forward hook on every submodule of
    the generator and the discriminator raises ``FloatingPointError``
    naming the first module whose output is not finite, and autograd's
    anomaly mode names the backward function that first returns a NaN
    (as ``FloatingPointError``).  The hooks and the anomaly mode's
    previous setting are put back on exit."""
    def hook(name):
        def check(_module, _inputs, output):
            outs = output if isinstance(output, (tuple, list)) else (output,)
            for o in outs:
                if (isinstance(o, torch.Tensor) and o.is_floating_point()
                        and not bool(torch.isfinite(o).all())):
                    raise FloatingPointError(
                        f"--debug-nans: non-finite output of module {name}")
        return check

    handles = [m.register_forward_hook(hook(f"{side}.{n}" if n else side))
               for side, root in (("gen", state.gen), ("disc", state.disc))
               for n, m in root.named_modules()]
    was = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    except RuntimeError as exc:
        if "returned nan" in str(exc):
            raise FloatingPointError(
                f"--debug-nans: non-finite gradient: {exc}") from exc
        raise
    finally:
        torch.autograd.set_detect_anomaly(was)
        for h in handles:
            h.remove()


def _accumulate(total, part):
    """``total + part`` per gradient name (``part`` when ``total`` is
    None).  Out of place: autograd may hand back one tensor for two
    parameters (an LSTM layer's two biases)."""
    if total is None:
        return part
    return {k: total[k] + g for k, g in part.items()}


def noisy_label_flip(flip, d_real, d_fake, num_rep: int):
    """Swap real and fake logits of the samples where ``flip [B]`` is set;
    a sample's ``num_rep`` logits (contiguous) flip together."""
    flip = flip.repeat_interleave(num_rep)
    return (torch.where(flip, d_fake, d_real),
            torch.where(flip, d_real, d_fake))


def _rep_weights(batch, num_rep: int):
    w = batch.get("weights")
    return None if w is None else w.repeat_interleave(num_rep)


def _scheduled_coins(config: Config, state: TrainState, captions,
                     sample_prob: float, noise):
    """Scheduled sampling's per-step model-feedback coins ``[T, B]``: fed
    (``noise["coins"]``) or drawn ``uniform < sample_prob`` from a device
    generator seeded from ``state.generator``; None for any other
    objective (the transformer's MLE is always teacher-forced)."""
    if config.mle_objective != "scheduled" or config.gen_arch != "lstm":
        return None
    coins = (noise or {}).get("coins")
    if coins is not None:
        return coins
    draw = torch.Generator(device=captions.device).manual_seed(
        _draw_seed(state))
    return torch.rand(captions.shape[::-1], generator=draw,
                      device=captions.device) < sample_prob


def mle_loss(config: Config, state: TrainState, batch, train: bool = True,
             sample_prob: float = 0.0, noise: Optional[Dict[str, Any]] = None):
    """The MLE objective: cross-entropy of the ``--mle-objective`` logits
    against the captions, over all positions (weighted by ``weights``);
    ``sample_prob`` and the coins of ``noise`` feed scheduled sampling.
    Under ``--dtype bfloat16`` the generator runs in :func:`compute_cast`
    and the logits are cast to float32 before the cross-entropy."""
    captions = batch["captions"]
    with compute_cast(config, state.gen, train=train):
        cond, _ = api.generator_condition(
            config, state.gen, augment_batch(config, state,
                                             cast_batch(config, batch),
                                             train, noise), train=train)
        logits = api.generator_mle_outputs(
            state.gen, cond, captions, config, lengths=batch.get("lengths"),
            sample_prob=sample_prob,
            coins=_scheduled_coins(config, state, captions, sample_prob,
                                   noise))
    w = batch.get("weights")
    mask = None if w is None else w[:, None].expand(captions.shape)
    return cross_entropy_loss(logits.to(torch.float32), captions, mask)


def mle_grads(config: Config, state: TrainState, batch,
              sample_prob: float = 0.0, noise=None, stats=None):
    """``(loss, gradients by name)`` of the MLE objective: one backward a
    ``--grad-accum`` microbatch, the gradients and losses summed in
    microbatch order and divided by k (with k = 1, the one backward's).
    ``stats``: the running statistics to put back before each microbatch
    after the first (a snapshot is taken here when needed and not
    given).  The state is not changed beyond drawing from
    ``state.generator`` and moving the running statistics."""
    accum = max(1, int(config.grad_accum))
    micro = split_micro(batch, accum)
    if stats is None and accum > 1:
        stats = _stats_snapshot(state)
    loss = grads = None
    for i, (mb, nz) in enumerate(zip(micro, _micro_noise(noise, accum))):
        if i:
            _stats_restore(state, stats)
        mb_loss = mle_loss(config, state, mb, sample_prob=sample_prob,
                           noise=nz)
        check_finite(config, "loss", {"gen_pretrain_loss": mb_loss})
        g, = _grads(mb_loss, state.gen)
        check_finite(config, "gradient", g)
        loss = mb_loss.detach() if loss is None else loss + mb_loss.detach()
        grads = _accumulate(grads, g)
    if accum > 1:
        loss = loss / accum
        grads = {k: g / accum for k, g in grads.items()}
    return loss, grads


def make_mle_step(config: Config):
    """Pretrain step: :func:`mle_grads` → clip → Adam(``pretrain_lr`` at
    the schedule's count) → EMA, under the non-finite guard.
    ``step(state, batch, sample_prob=0.0, noise=None)``."""
    require_ported_training(config)
    accum = max(1, int(config.grad_accum))
    guard = bool(config.skip_nonfinite_grads)

    def step(state: TrainState, batch, sample_prob: float = 0.0,
             noise=None):
        stats = _stats_snapshot(state) if accum > 1 or guard else None
        loss, grads = mle_grads(config, state, batch, sample_prob, noise,
                                stats)
        gnorm = global_norm(grads)
        if guard and not _finite(gnorm)[0]:
            _stats_restore(state, stats)
        else:
            clip_adam_update(state.gen, grads, state.pretrain_opt,
                             config.pretrain_lr, config.clip_norm, config,
                             gnorm)
            ema_update(config, state.ema_gen, state.gen)
        return state, {"gen_pretrain_loss": loss, "gen_grad_norm": gnorm}

    return step


def make_mle_eval_step(config: Config):
    """Eval-mode MLE loss (reference ``genpretrain_loop('val')``): no
    gradient, no update, running statistics read.
    ``step(state, batch, sample_prob=0.0, noise=None)``."""
    require_ported_training(config)

    @torch.no_grad()
    def step(state: TrainState, batch, sample_prob: float = 0.0,
             noise=None):
        return state, {"gen_pretrain_loss": mle_loss(
            config, state, batch, train=False, sample_prob=sample_prob,
            noise=noise)}

    return step


def adv_losses(config: Config, state: TrainState, batch, temperature,
               noise: Optional[Dict[str, Any]] = None, train: bool = True):
    """One adversarial forward → ``(g_loss, d_loss, aux)`` with the
    cross terms cut as the module docstring says (``train=False``: eval
    mode, no dropout, no label noise)."""
    noise = noise or {}
    if config.adv_objective == "reinforce":
        seed = noise.get("seed")
        # in the compute cast, as the JAX reinforce_losses casts the models
        # and the batch the generator is conditioned on
        with compute_cast(config, state.gen, state.disc, train=train):
            return reinforce_losses(
                config, state, batch,
                _draw_seed(state) if seed is None else seed, noise, train,
                cond_batch=cast_batch(config, batch))
    if config.adv_objective != "gumbel":
        raise ValueError(f"adv_objective {config.adv_objective!r}: expected "
                         "'gumbel' or 'reinforce'")
    captions = batch["captions"]
    device = captions.device
    draw = torch.Generator(device=device).manual_seed(_draw_seed(state))
    keeps = noise.get("keep", (None, None, None))
    with compute_cast(config, state.gen, state.disc, train=train):
        cond, _ = api.generator_condition(
            config, state.gen, augment_batch(config, state,
                                             cast_batch(config, batch),
                                             train, noise), train=train)
        disc_p = params_of(state.disc)
        disc_ng = params_of(state.disc, detach=True)
        sample_kw = dict(temperature=compute_temperature(config,
                                                         temperature),
                         seed=_draw_seed(state),
                         uniforms=noise.get("uniforms"))
        if decode_route(config) == "kernel_embed":
            # the sample arrives embedded: emb_fake carries gradient to the
            # embedding weight only, emb_gen to the generator only
            emb_gen, emb_fake, gen_ids = gen_lstm.sample_embed(
                state.gen.decoder, cond["features"], captions.shape[1],
                disc_embed=disc_p["embeddings.weight"], **sample_kw)
            d_real = api.discriminator_apply(disc_p, captions, config, train,
                                             keeps[0], draw)
            d_fake = disc_cnn.apply_embedded(disc_p, emb_fake, config, train,
                                             keeps[1], draw)
            g_out = disc_cnn.apply_embedded(disc_ng, emb_gen, config, train,
                                            keeps[2], draw)
        else:
            soft, gen_ids = api.generator_sample(
                state.gen, cond, captions.shape[1], False, config,
                **sample_kw)
            d_real = api.discriminator_apply(disc_p, captions, config, train,
                                             keeps[0], draw)
            d_fake = api.discriminator_apply(disc_p, soft.detach(), config,
                                             train, keeps[1], draw)
            g_out = api.discriminator_apply(disc_ng, soft, config, train,
                                            keeps[2], draw)
    # the losses are reduced in float32 (the JAX step's .astype(float32))
    d_real, d_fake, g_out = (d.to(torch.float32)
                             for d in (d_real, d_fake, g_out))

    num_rep = api.disc_logits_per_sample(config)
    if config.noisy_labels > 0.0 and train:
        flip = noise.get("flip")
        if flip is None:
            flip = torch.rand(captions.shape[0], generator=draw,
                              device=device) < config.noisy_labels
        d_real_in, d_fake_in = noisy_label_flip(flip, d_real, d_fake,
                                                num_rep)
    else:
        d_real_in, d_fake_in = d_real, d_fake
    w = _rep_weights(batch, num_rep)
    real_label = 1.0 - config.label_smoothing
    _, d_loss = gan_losses(d_real_in, d_fake_in, g_out, config.adv_loss_type,
                           real_label=real_label, weights=w)
    g_loss, _ = gan_losses(d_real.detach(), g_out, g_out,
                           config.adv_loss_type, real_label=real_label,
                           weights=w)
    aux = {"gen_ids": gen_ids, "d_real_mean": d_real.detach().mean(),
           "d_fake_mean": d_fake.detach().mean()}
    return g_loss, d_loss, aux


def _adv_grads_one(config: Config, state: TrainState, batch, temperature,
                   noise: Optional[Dict[str, Any]] = None):
    with bf16_grad_leaves(config, state.gen, state.disc) as leaves:
        g_loss, d_loss, aux = adv_losses(config, state, batch, temperature,
                                         noise)
        check_finite(config, "loss", {"gen_adv_loss": g_loss,
                                      "disc_adv_loss": d_loss})
        g_grads, d_grads = _grads(g_loss + d_loss, state.gen, state.disc)
    if leaves:   # bfloat16 gradients → the float32 masters' dtype
        g_grads, d_grads = ({k: g.to(torch.float32) for k, g in gs.items()}
                            for gs in (g_grads, d_grads))
    check_finite(config, "gradient", {**{"gen." + k: g for k, g in
                                         g_grads.items()},
                                      **{"disc." + k: g for k, g in
                                         d_grads.items()}})
    return g_loss.detach(), d_loss.detach(), g_grads, d_grads, aux


def adv_grads(config: Config, state: TrainState, batch, temperature,
              noise=None, stats=None):
    """``(g_loss, d_loss, gen_grads, disc_grads, aux)`` from one forward
    and one backward of ``g_loss + d_loss`` a ``--grad-accum``
    microbatch (``noise``: one dict, or with k > 1 a sequence of k),
    summed in microbatch order and divided by k, ``aux``'s means too and
    its ``gen_ids`` joined; the state is not changed (beyond drawing from
    ``state.generator`` and moving the running statistics, put back to
    ``stats`` before each microbatch after the first, as
    :func:`mle_grads`)."""
    accum = max(1, int(config.grad_accum))
    if accum == 1:
        return _adv_grads_one(config, state, batch, temperature, noise)
    if stats is None:
        stats = _stats_snapshot(state)
    scal = g_grads = d_grads = None
    ids = []
    for i, (mb, nz) in enumerate(zip(split_micro(batch, accum),
                                     _micro_noise(noise, accum))):
        if i:
            _stats_restore(state, stats)
        gl, dl, gg, dg, aux = _adv_grads_one(config, state, mb, temperature,
                                             nz)
        part = (gl, dl, aux["d_real_mean"], aux["d_fake_mean"])
        scal = part if scal is None else [a + b for a, b in zip(scal, part)]
        g_grads, d_grads = (_accumulate(g_grads, gg),
                            _accumulate(d_grads, dg))
        ids.append(aux["gen_ids"])
    g_loss, d_loss, d_real, d_fake = (v / accum for v in scal)
    aux = {"gen_ids": torch.cat(ids), "d_real_mean": d_real,
           "d_fake_mean": d_fake}
    return (g_loss, d_loss, {k: g / accum for k, g in g_grads.items()},
            {k: g / accum for k, g in d_grads.items()}, aux)


def make_adv_step(config: Config):
    """The adversarial update: :func:`adv_grads` (both gradients from one
    forward and one backward per ``--grad-accum`` microbatch), the
    discriminator's clipped Adam every ``disc_train_freq`` generator
    steps, the generator's every step and then its EMA, each side under
    the non-finite guard.
    ``step(state, batch, temperature, noise=None)``."""
    require_ported_training(config)
    disc_every = max(1, int(config.disc_train_freq))
    accum = max(1, int(config.grad_accum))
    guard = bool(config.skip_nonfinite_grads)

    def step(state: TrainState, batch, temperature,
             noise: Optional[Dict[str, Any]] = None):
        stats = _stats_snapshot(state) if accum > 1 or guard else None
        g_loss, d_loss, g_grads, d_grads, aux = adv_grads(
            config, state, batch, temperature, noise, stats)
        # pre-clip norms, also on steps that do not update the discriminator
        g_norm, d_norm = global_norm(g_grads), global_norm(d_grads)
        g_ok, d_ok = _finite(g_norm, d_norm) if guard else (True, True)
        if state.gen_steps % disc_every == 0:
            if d_ok:
                clip_adam_update(state.disc, d_grads, state.disc_opt,
                                 config.disc_lr, config.clip_norm, config,
                                 d_norm)
            state.disc_steps += 1
        if g_ok:
            clip_adam_update(state.gen, g_grads, state.gen_opt,
                             config.gen_lr, config.clip_norm, config, g_norm)
            ema_update(config, state.ema_gen, state.gen)
        else:
            _stats_restore(state, stats)
        state.gen_steps += 1
        state.temperature = float(temperature)
        return state, {"gen_adv_loss": g_loss, "disc_adv_loss": d_loss,
                       "d_real_mean": aux["d_real_mean"],
                       "d_fake_mean": aux["d_fake_mean"],
                       "gen_grad_norm": g_norm, "disc_grad_norm": d_norm}

    return step


def make_multi_step(config: Config, kind: str):
    """``--steps-per-call K``: ``multi(state, stacked, scalars,
    noise=None)`` runs K steps of ``kind`` (``"mle"``: ``scalars`` are the
    scheduled-sampling probabilities; ``"adv"``: the temperatures) on the
    batches of ``stacked`` (every tensor ``[K, ...]``) in one call, and
    returns the state and each metric stacked ``[K]``.  A loop over the
    single step (the JAX ``make_multi_step``'s ``lax.scan``): the same
    batches, scalars and draws as K separate calls.  ``noise``: None, or
    one entry per step."""
    if kind == "mle":
        step = make_mle_step(config)
    elif kind == "adv":
        step = make_adv_step(config)
    else:
        raise ValueError(f"unknown multi-step kind: {kind!r}")

    def multi(state: TrainState, batches: Dict[str, torch.Tensor],
              scalars: Sequence[float], noise: Optional[Sequence] = None):
        rows = []
        for j, scalar in enumerate(scalars):
            state, m = step(state, {k: v[j] for k, v in batches.items()},
                            float(scalar),
                            None if noise is None else noise[j])
            rows.append(m)
        return state, {k: torch.stack([m[k] for m in rows])
                       for k in rows[0]}

    return multi


def make_adv_eval_step(config: Config):
    """Eval-mode adversarial losses (reference ``adv_loop('val')``): no
    gradient, no update; the Gumbel sample still draws its noise."""
    require_ported_training(config)

    @torch.no_grad()
    def step(state: TrainState, batch, temperature,
             noise: Optional[Dict[str, Any]] = None):
        g_loss, d_loss, aux = adv_losses(config, state, batch, temperature,
                                         noise, train=False)
        return state, {"gen_adv_loss": g_loss, "disc_adv_loss": d_loss,
                       "d_real_mean": aux["d_real_mean"],
                       "d_fake_mean": aux["d_fake_mean"]}

    return step
