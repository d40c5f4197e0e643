"""Checkpoints in the reference ``state_dict`` layout
(``gan_image_captioning_tpu/train/checkpoint.py:load_generator_checkpoint``).

A checkpoint is a ``torch.save``-d dict with the reference's keys: either
the generator ``state_dict`` itself (``pretrained_model.ckpt`` style) or
``{"generator": …, "discriminator": …, "conditional": bool}``
(``adv_model.ckpt`` style).  Generator keys are ``decoder.embed.weight``,
``decoder.lstm.weight_ih_l{k}``, ``decoder.linear.weight`` … and, for a
conditional generator, ``encoder.resnet.{0,1,4,5,6,7}.*`` (the reference
encoder's ``nn.Sequential`` numbers for torchvision's ``conv1``, ``bn1``,
``layer1``-``layer4``), ``encoder.linear.*`` and ``encoder.bn.*`` with the
BatchNorm running statistics (``models/torch_export.py:43-102``).
``src/export_torch.py`` writes both forms from a JAX checkpoint.  A
checkpoint is conditional when its ``conditional`` flag says so, or, in
the plain form, when it holds encoder keys; loading it under the other
``--conditional-gan`` raises.

A transformer generator (``--gen-arch transformer``) is saved under its
JAX tree paths (``decoder.embed``, ``decoder.blocks.{i}.attn.wq.w`` …); the
adversarial form carries ``"gen_arch": "transformer"``, the plain form is
recognised by its ``decoder.pos`` key, and loading a checkpoint under the
other ``--gen-arch`` raises.

Full training states (``--resume``, ``--checkpoint-every``, the interrupt
save): :func:`save_state` writes the whole :class:`TrainState` as one
``torch.save`` file (both modules' ``state_dict``s, a conditional
generator's BatchNorm running statistics included; the three Adam states;
the step counters and the temperature; the host ``torch.Generator``'s
state), :func:`load_state` reads it back into a state built from the same
config, and :func:`prune_checkpoints` keeps the newest numbered snapshots.

Saves are asynchronous unless ``sync=True``: the caller copies every
tensor to host memory (a copy, also of CPU tensors) before the save
returns, because the steps update parameters and moments in place and the
next step would otherwise change the snapshot; a single writer thread
then writes the file (to a temporary name, renamed into place), in the
order of the saves.  :func:`wait_for_checkpoints` is the barrier: it
re-raises the first writer error, and every load waits on it first.
"""

from __future__ import annotations

import atexit
import os
import re
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List

import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.models.generator import Generator
from gan_image_captioning_tpu_torch.models.transformer import (
    TransformerGenerator)

# torchvision resnet18 module names → the reference Encoder's nn.Sequential
# indices (resnet18 children minus avgpool/fc: conv1, bn1, relu, maxpool,
# layer1..layer4)
_TO_SEQUENTIAL = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5",
                  "layer3": "6", "layer4": "7"}
_FROM_SEQUENTIAL = {v: k for k, v in _TO_SEQUENTIAL.items()}
_RESNET = "encoder.resnet."


def _rename_backbone(key: str, table: Dict[str, str]) -> str:
    if not key.startswith(_RESNET):
        return key
    head, _, tail = key[len(_RESNET):].partition(".")
    return _RESNET + table[head] + "." + tail


_writer_lock = threading.Lock()
_writer: ThreadPoolExecutor = None
_pending: List[Future] = []


def _host_copy(obj):
    """``obj`` with every tensor copied to host memory (a new tensor also
    when it is on the CPU already): what the file will hold, whatever the
    steps do to the originals afterwards."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    return obj


def _write(path: str, host_obj) -> None:
    """``torch.save`` to a temporary name, renamed into place: a reader
    never sees a torn file."""
    tmp = path + ".tmp"
    torch.save(host_obj, tmp)
    os.replace(tmp, path)


def _get_writer() -> ThreadPoolExecutor:
    global _writer
    with _writer_lock:
        if _writer is None:
            _writer = ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="gic-ckpt")
            atexit.register(wait_for_checkpoints)
        return _writer


def wait_for_checkpoints() -> None:
    """Barrier: block until every asynchronous save is written; re-raise
    the first writer error."""
    with _writer_lock:
        pending, _pending[:] = list(_pending), []
    for fut in pending:
        fut.result()


def pending_checkpoints() -> int:
    """The asynchronous saves not known to be written yet."""
    with _writer_lock:
        _pending[:] = [f for f in _pending if not f.done()]
        return len(_pending)


def save_object(path: str, obj: Any, sync: bool = False) -> None:
    """Save ``obj`` (nested dicts of tensors and plain values) with
    ``torch.save``.  The host copy is made here; unless ``sync``, the
    write runs on the writer thread and this returns at once.  Only one
    process writes when ``torch.distributed`` is initialised."""
    from gan_image_captioning_tpu_torch.train.schedule import is_writer

    if not is_writer():
        return
    path = os.path.abspath(path)
    host_obj = _host_copy(obj)
    if sync:
        wait_for_checkpoints()          # keep the order of earlier saves
        _write(path, host_obj)
        return
    fut = _get_writer().submit(_write, path, host_obj)
    with _writer_lock:
        _pending.append(fut)


def generator_state_dict(generator: Generator) -> Dict[str, torch.Tensor]:
    """``generator``'s state under the reference's keys (the tensors
    themselves, detached; :func:`save_object` copies them)."""
    return {_rename_backbone(k, _TO_SEQUENTIAL): v.detach()
            for k, v in generator.state_dict().items()}


def save_generator_checkpoint(path: str, generator: Generator,
                              discriminator_state: dict = None,
                              sync: bool = True) -> None:
    """Write ``generator`` in the reference layout: the plain form, or the
    adversarial form with its ``conditional`` flag when a discriminator
    ``state_dict`` is given.  ``sync=False`` writes on the writer
    thread."""
    gen_sd = generator_state_dict(generator)
    obj = gen_sd if discriminator_state is None else {
        "generator": gen_sd,
        "discriminator": dict(discriminator_state),
        "conditional": generator.encoder is not None,
        "gen_arch": _arch_of(gen_sd)}
    save_object(path, obj, sync=sync)


def _arch_of(gen_sd) -> str:
    return "transformer" if "decoder.pos" in gen_sd else "lstm"


def load_generator_checkpoint(path: str, config: Config, device="cpu"):
    """Load either checkpoint form → ``(Generator on device,
    discriminator state_dict or None)``.  The keys must match the
    configured geometry exactly, and the checkpoint's conditionality
    ``--conditional-gan``."""
    wait_for_checkpoints()      # an asynchronous save may still be landing
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    disc, conditional, arch = None, None, None
    if isinstance(obj.get("generator"), dict):
        disc = obj.get("discriminator")
        conditional = obj.get("conditional")
        arch = obj.get("gen_arch")
        obj = obj["generator"]
    arch = arch or _arch_of(obj)
    if arch != config.gen_arch:
        raise ValueError(f"{path}: a {arch} generator checkpoint does not "
                         f"match --gen-arch {config.gen_arch}")
    if conditional is None:
        conditional = any(k.startswith("encoder.") for k in obj)
    if bool(conditional) != config.cgan:
        raise ValueError(
            f"{path}: checkpoint conditionality ({bool(conditional)}) does "
            f"not match --conditional-gan {config.conditional_gan}")
    state = {_rename_backbone(k, _FROM_SEQUENTIAL): v for k, v in obj.items()
             if k.startswith(("decoder.", "encoder."))}
    gen = (TransformerGenerator(config, device) if arch == "transformer"
           else Generator(config, device))
    gen.load_state_dict(state, strict=True)
    return gen, disc


# ------------------------------------------------------- full training state

STATE_FORMAT = "gic_torch_train_state"
_OPTS = ("pretrain_opt", "gen_opt", "disc_opt")
_COUNTERS = ("pretrain_steps", "gen_steps", "disc_steps")


def state_dict_of(state) -> dict:
    """The whole :class:`TrainState` as one dict of tensors and plain
    values (the tensors themselves; :func:`save_object` copies them)."""
    obj = {"format": STATE_FORMAT,
           "gen": dict(state.gen.state_dict()),
           "disc": dict(state.disc.state_dict()),
           "temperature": float(state.temperature),
           "generator": state.generator.get_state()}
    for name in _OPTS:
        opt = getattr(state, name)
        obj[name] = {"count": int(opt.count), "mu": dict(opt.mu),
                     "nu": dict(opt.nu)}
    for name in _COUNTERS:
        obj[name] = int(getattr(state, name))
    return obj


def save_state(path: str, state, sync: bool = False) -> None:
    """Save the full training state (see :func:`state_dict_of`)."""
    save_object(path, state_dict_of(state), sync=sync)


def load_state(path: str, template):
    """Load a :func:`save_state` file into ``template``, a state built by
    ``create_train_state`` from the same config: the modules' tensors are
    copied into place (on their device), the Adam moments moved to it,
    and the counters, temperature and generator state set.  Returns
    ``template``."""
    from gan_image_captioning_tpu_torch.train.state import AdamState

    wait_for_checkpoints()
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict) or obj.get("format") != STATE_FORMAT:
        raise ValueError(f"{path}: not a full training state written by "
                         "save_state")
    template.gen.load_state_dict(obj["gen"], strict=True)
    template.disc.load_state_dict(obj["disc"], strict=True)
    for name in _OPTS:
        old, new = getattr(template, name), obj[name]
        if set(new["mu"]) != set(old.mu):
            raise ValueError(f"{path}: {name} holds moments of "
                             f"{sorted(set(new['mu']) ^ set(old.mu))} that "
                             "do not match this model's trainable "
                             "parameters")
        setattr(template, name, AdamState(
            int(new["count"]),
            {k: v.to(old.mu[k].device) for k, v in new["mu"].items()},
            {k: v.to(old.nu[k].device) for k, v in new["nu"].items()}))
    for name in _COUNTERS:
        setattr(template, name, int(obj[name]))
    template.temperature = float(obj["temperature"])
    template.generator.set_state(obj["generator"])
    return template


def prune_checkpoints(model_dir: str, prefix: str, keep: int) -> list:
    """Keep the ``keep`` highest-numbered ``{prefix}{N}.ckpt`` files under
    ``model_dir`` and delete the rest with their schedule sidecars
    (``keep <= 0`` keeps all).  Best-val files never match a numbered
    prefix.  Returns the deleted paths."""
    from gan_image_captioning_tpu_torch.train.schedule import sidecar_path

    if keep <= 0:
        return []
    if pending_checkpoints():
        # a snapshot still being written would be listed late
        wait_for_checkpoints()
    pat = re.compile(re.escape(prefix) + r"(\d+)\.ckpt")
    found = sorted((int(m.group(1)), name) for name in os.listdir(model_dir)
                   for m in [pat.fullmatch(name)] if m)
    deleted = []
    for _, name in found[:-keep]:
        path = os.path.join(model_dir, name)
        for doomed in (path, sidecar_path(path)):
            if os.path.exists(doomed):
                os.remove(doomed)
        deleted.append(path)
    return deleted
