"""Logging and the scalar metric stream
(``gan_image_captioning_tpu/utils/logging.py``).

:func:`create_logger` has the reference's call surface (``utils.py:78-103``:
stdout and ``{log_file}.txt``); :class:`MetricWriter` writes one JSON
object per scalar to ``{save_dir}/metrics.jsonl`` with the reference's tag
names (``GenPreTraining_train_loss`` …).  The JAX package's TensorBoard
event files are not written.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time


def create_logger(name, log_file: str):
    """A logger writing each message to stdout and to ``log_file``."""
    log = logging.getLogger(name)
    log.setLevel(logging.DEBUG)
    log.propagate = False
    log.handlers.clear()
    formatter = logging.Formatter(fmt="%(message)s")
    for handler in (logging.StreamHandler(sys.stdout),
                    logging.FileHandler(log_file, mode="w")):
        handler.setFormatter(formatter)
        log.addHandler(handler)
    return log


class MetricWriter:
    """Scalar writer: one JSON line per scalar."""

    def __init__(self, save_dir: str):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        self._jsonl = open(os.path.join(save_dir, "metrics.jsonl"), "a",
                           buffering=1)

    def add_scalar(self, tag: str, value, step: int):
        self._jsonl.write(json.dumps(
            {"t": time.time(), "tag": tag, "value": float(value),
             "step": int(step)}) + "\n")

    def close(self):
        self._jsonl.close()
