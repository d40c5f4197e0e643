"""Weight-init sweep (``gan_image_captioning_tpu/ops/initializers.py``).

The reference re-initializes every parameter of a freshly built model with
either ``uniform(-0.05, 0.05)`` or ``normal(0, 1/sqrt(shape[0]))``.  Here
the sweep runs in place over an ``nn.Module``'s parameters.  Values are
drawn on the CPU from the caller's ``torch.Generator`` and then copied to
each parameter's device, so a seed gives the same weights on every device
(not the JAX package's numbers: its PRNG differs).
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def init_param_tree(generator: torch.Generator, module: nn.Module,
                    strategy: str = "uniform", skip_predicate=None) -> nn.Module:
    """Re-initialize every parameter of ``module`` in place.

    ``uniform`` → U(-0.05, 0.05); ``normal`` → N(0, 1/sqrt(shape[0])).
    Anything else leaves the parameters untouched (the reference's silent
    fall-through).  ``skip_predicate(name, param) -> bool`` keeps a
    parameter as it is.  Returns ``module``."""
    if strategy not in ("uniform", "normal"):
        return module
    for name, p in module.named_parameters():
        if p.ndim == 0 or (skip_predicate is not None
                           and skip_predicate(name, p)):
            continue
        if strategy == "uniform":
            new = torch.empty(p.shape, dtype=p.dtype).uniform_(
                -0.05, 0.05, generator=generator)
        else:
            new = torch.empty(p.shape, dtype=p.dtype).normal_(
                0.0, 1.0 / math.sqrt(p.shape[0]), generator=generator)
        p.copy_(new)
    return module
