"""RelGAN multi-representation CNN discriminator
(``gan_image_captioning_tpu/models/discriminator.py``).

:class:`Discriminator` holds the parameters under the reference's
``state_dict`` names — ``embeddings.weight [Ed, V]``, ``convs.{i}.weight
[n, 1, f, eds]`` / ``.bias``, ``highway.*``, ``feature2out.*``,
``out2logits.*`` — the layout ``models/torch_export.py`` writes.  The
compute is functional over an explicit parameter dict (``dict(
disc.named_parameters())``), so the adversarial step can run the
generator's pass with detached discriminator parameters:

  embed (gather for int ids, product for soft input) → conv banks → ReLU →
  max over time (``kernels/disc_conv.py``, the engine of
  ``--disc-engine``) → highway → dropout(0.2) →
  Linear(F→100) → Linear(100→1), one logit per (sample, representation).

``Config.disc_remat`` (the JAX ``GIC_DISC_REMAT=1``) runs the conv trunk
under ``torch.utils.checkpoint``: the backward runs the engine's forward
again (the same bits: every engine's forward is deterministic) and keeps
only the embeddings in between.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.kernels.disc_conv import (
    ENGINES, pooled_features, replayable_relu)
from gan_image_captioning_tpu_torch.ops.initializers import init_param_tree

DROPOUT = 0.2  # reference discriminator.py:30


class Discriminator(nn.Module):
    """Parameter container with the reference's names.  Parameters are
    allocated uninitialized; :func:`init_discriminator_params` or a
    checkpoint fills them."""

    def __init__(self, config: Config, device="cpu", dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        V, Ed = config.vocab_size, config.disc_embed_dim
        F, eds = config.disc_feature_dim, config.emb_dim_single
        self.embeddings = nn.utils.skip_init(nn.Linear, V, Ed, bias=False,
                                             **kw)
        self.convs = nn.ModuleList(
            nn.utils.skip_init(nn.Conv2d, 1, n, (f, eds), stride=(1, eds),
                               **kw)
            for n, f in zip(config.disc_num_filters, config.disc_filter_sizes))
        self.highway = nn.utils.skip_init(nn.Linear, F, F, **kw)
        self.feature2out = nn.utils.skip_init(nn.Linear, F, 100, **kw)
        self.out2logits = nn.utils.skip_init(nn.Linear, 100, 1, **kw)


@torch.no_grad()
def init_discriminator_params(generator: torch.Generator, config: Config,
                              device="cpu", sweep: bool = True
                              ) -> Discriminator:
    """The JAX package's distributions: every weight N(0, 1)·0.02, every
    bias zero, then (``sweep``) the reference's init sweep
    (``config.disc_init``).  Drawn on the CPU from ``generator``."""
    disc = Discriminator(config, device)
    for name, p in disc.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=generator,
                                dtype=p.dtype) * 0.02)
    if sweep:
        init_param_tree(generator, disc, config.disc_init)
    return disc


def params_of(disc: Discriminator, detach: bool = False):
    """The parameter dict :func:`apply` takes (detached on request)."""
    return {k: (v.detach() if detach else v)
            for k, v in disc.named_parameters()}


def embed_tokens(params, inp):
    """Embeddings ``[B, L, Ed]``: a gather of ``W.T`` for int ids
    ``[B, L]``, ``inp @ W.T`` for soft input ``[B, L, V]`` (equal for
    one-hot rows)."""
    w = params["embeddings.weight"]                       # [Ed, V]
    if not torch.is_floating_point(inp):
        return w.T[inp.long()]
    return inp @ w.T


def conv_engine(config: Config) -> str:
    """The conv-bank engine of ``kernels/disc_conv.py`` that
    ``config.disc_engine`` names (the JAX package's ``_use_conv_kernel``):
    ``auto`` is ``mxu`` (the JAX package's choice on its accelerator),
    ``xla`` the plain versions; ``pallas``, ``hybrid``, ``mxu``,
    ``mxu_dxs`` and ``plain`` name themselves.  No engine falls back to
    another: the CUDA kernels take any row count."""
    engine = {"auto": "mxu", "xla": "plain"}.get(config.disc_engine,
                                                 config.disc_engine)
    if engine not in ENGINES:
        raise ValueError(f"disc_engine {config.disc_engine!r}: expected one "
                         f"of auto, xla, {', '.join(ENGINES)}")
    return engine


def conv_pooled(params, emb, config: Config):
    """Pooled conv features ``[(B·R), F]`` from ``emb [B, L, E]`` through
    :func:`conv_engine`'s engine: its kernels on CUDA tensors, the plain
    versions on CPU ones."""
    convs = [(params[f"convs.{i}.weight"], params[f"convs.{i}.bias"])
             for i in range(len(config.disc_filter_sizes))]
    pooled = pooled_features(convs, emb, config.emb_dim_single,
                             conv_engine(config))
    return pooled.reshape(-1, config.disc_feature_dim)


def _highway(params, pred):
    """``sigmoid(h) * relu(h) + (1 - sigmoid(h)) * x`` with
    ``h = highway(x)`` (reference ``discriminator.py:53-55``); the ReLU
    is replayable (``disc_conv.argmax_replay``) for route comparisons."""
    hw = pred @ params["highway.weight"].T + params["highway.bias"]
    gate = torch.sigmoid(hw)
    return gate * replayable_relu(hw) + (1.0 - gate) * pred


def dropout_keep(shape, generator=None, device="cpu",
                 rate: float = DROPOUT):
    """A keep mask: each entry kept with probability ``1 - rate``."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def apply_embedded(params, emb, config: Config, train: bool = False,
                   keep=None, generator=None, dropout_rate: float = DROPOUT):
    """Trunk from embeddings ``[B, L, E]`` → ``[B·R]`` logits.  With
    ``train``, dropout keeps the entries of ``keep [B·R, F]`` (drawn from
    ``generator`` when not given) and scales them by ``1/(1 - rate)``."""
    if config.disc_remat:
        pooled = torch.utils.checkpoint.checkpoint(
            conv_pooled, params, emb, config, use_reentrant=False)
    else:
        pooled = conv_pooled(params, emb, config)
    pred = _highway(params, pooled)
    if train and dropout_rate > 0.0:
        if keep is None:
            keep = dropout_keep(pred.shape, generator, pred.device,
                                dropout_rate)
        pred = torch.where(keep, pred / (1.0 - dropout_rate),
                           torch.zeros((), device=pred.device))
    pred = pred @ params["feature2out.weight"].T + params["feature2out.bias"]
    logits = pred @ params["out2logits.weight"].T + params["out2logits.bias"]
    return logits[:, 0]


def apply(params, inp, config: Config, train: bool = False, keep=None,
          generator=None, dropout_rate: float = DROPOUT):
    """Discriminator logits ``[B·R]`` of soft ``[B, L, V]`` or int
    ``[B, L]`` input — the reference's ``Discriminator.forward``."""
    return apply_embedded(params, embed_tokens(params, inp), config, train,
                          keep, generator, dropout_rate)
