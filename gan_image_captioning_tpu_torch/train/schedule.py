"""Schedule sidecars: step-granular restart
(``gan_image_captioning_tpu/train/schedule.py``).

A full-state checkpoint (``train/checkpoint.py:save_state``) restores
everything a step changes: both modules, the three Adam states, the step
counters, the temperature and the host ``torch.Generator`` the steps draw
their noise from.  It does not carry the HOST-side schedule position:
which phase was running, which epoch, how many train batches of it were
applied, and the loaders' shuffle-epoch counters.

A *schedule sidecar* is a small JSON file beside a resumable checkpoint
(``<ckpt>.schedule.json``) that records that host state, with the JAX
package's keys and layout (``indent=1``, sorted keys):

``phase``           "pretrain" | "scst" | "adv"
``epoch``           the epoch to (re-)enter in that phase
``batches_done``    train batches of that epoch already applied; resume
                    skips them with ``Batcher.iter_from`` and replays the
                    same seeded shuffle order for the rest of the epoch
``loader_epochs``   per-loader shuffle-epoch counters, restored before the
                    first resumed iteration (``Batcher`` shuffles with
                    ``seed + epoch``)
``pretrain_steps`` / ``adv_batch_steps`` / ``scst_step``
                    host-side step counters
``best``            per-phase best-val trackers and patience counters, so
                    the best-checkpoint choice and ``--early-stop-patience``
                    continue instead of restarting

Every random draw of a step comes from the state's ``torch.Generator``
(and the SCST rollouts from ``(seed, scst_step)``), so a resume that
replays the same batches from the same state is bit-exact on the CPU.
"""

from __future__ import annotations

import json
import os
from typing import Optional

SIDECAR_SUFFIX = ".schedule.json"

# the order of the training phases (instructor._run): a sidecar at phase p
# means every earlier phase is complete and must be skipped on resume
PHASES = ("pretrain", "scst", "adv")


def sidecar_path(ckpt_path: str) -> str:
    return os.path.abspath(ckpt_path).rstrip("/") + SIDECAR_SUFFIX


def is_writer() -> bool:
    """True unless ``torch.distributed`` is initialised and this is not
    process 0 (one process writes checkpoints and sidecars)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def save_sidecar(ckpt_path: str, info: dict) -> str:
    """Write ``info`` beside ``ckpt_path`` by an atomic rename (a torn
    sidecar must not corrupt a resume)."""
    if info.get("phase") not in PHASES:
        raise ValueError("sidecar phase must be one of %s, got %r"
                         % (PHASES, info.get("phase")))
    path = sidecar_path(ckpt_path)
    if not is_writer():
        return path
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_sidecar(ckpt_path: str) -> Optional[dict]:
    """The sidecar dict of ``ckpt_path``, or None when it is absent or
    unreadable (which degrades to a state-only resume, never a crash)."""
    path = sidecar_path(ckpt_path)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            info = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(info, dict) or info.get("phase") not in PHASES:
        return None
    return info


def phase_completed(info: Optional[dict], phase: str) -> bool:
    """True if ``phase`` finished before the sidecar was written (resume
    skips it)."""
    if info is None:
        return False
    return PHASES.index(info["phase"]) > PHASES.index(phase)


def phase_start(info: Optional[dict], phase: str) -> tuple:
    """``(start_epoch, start_batch)`` of ``phase`` under ``info``."""
    if info is None or info["phase"] != phase:
        return 0, 0
    return int(info.get("epoch", 0)), int(info.get("batches_done", 0))
