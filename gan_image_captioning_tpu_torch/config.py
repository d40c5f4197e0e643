"""The serving subset of the flag system.

Counterpart of ``gan_image_captioning_tpu/config.py``: the same flag names
and defaults for what the serving path reads, parsed into a frozen
:class:`Config`.  ``--device`` defaults to ``cuda``; :func:`resolve_device`
turns it into a ``torch.device`` and refuses to fall back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch


def add_model_args(parser):
    """Generator flags (the JAX package's ``add_model_args``)."""
    g = parser.add_argument_group("model")
    g.add_argument("--gen-hidden-dim", type=int, default=512,
                   help="hidden dimension of generator")
    g.add_argument("--gen-embed-dim", type=int, default=32,
                   help="embedding dimension of generator")
    g.add_argument("--gen-num-layers", type=int, default=1,
                   help="number of layers in generator")
    g.add_argument("--gen-init", type=str, default="uniform",
                   choices=["uniform", "normal"],
                   help="Initialization strategy for generator weights")
    g.add_argument("--conditional-gan", type=int, default=0, choices=[0, 1],
                   help="is the gan conditional?")
    g.add_argument("--gen-arch", type=str, default="lstm",
                   choices=["lstm", "transformer", "gpt2"],
                   help="generator architecture")


def add_data_args(parser):
    """Data flags (the JAX package's ``add_data_args`` and ``--dataset``)."""
    g = parser.add_argument_group("data")
    g.add_argument("--max-seq-len", type=int, default=34,
                   help="maximum sequence length of captions")
    g.add_argument("--dataset", type=str, default="coco",
                   choices=["coco", "synthetic"],
                   help="'synthetic' = the deterministic fixture vocabulary")
    g.add_argument("--vocab-multiple", type=int, default=1,
                   help="round the dataset vocab size up to a multiple of "
                        "this; padded ids are never produced by data and "
                        "decode maps them to <UNK>")


def add_global_args(parser):
    g = parser.add_argument_group("global")
    g.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on: 'cuda' (default), "
                        "'cuda:N' or 'cpu'")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("GAN captioning (PyTorch port)")
    add_data_args(parser)
    add_model_args(parser)
    add_global_args(parser)
    return parser


@dataclasses.dataclass(frozen=True)
class Config:
    """Frozen view of the serving flags (field names as in the JAX
    package's ``Config``)."""

    vocab_size: int = -1
    gen_embed_dim: int = 32
    gen_hidden_dim: int = 512
    gen_num_layers: int = 1
    max_seq_len: int = 34
    gen_arch: str = "lstm"
    gen_init: str = "uniform"
    conditional_gan: int = 0

    @property
    def cgan(self) -> bool:
        return self.conditional_gan == 1

    @property
    def seq_len(self) -> int:
        """Static decode length: captions are wrapped ``<S> … <E>``."""
        return self.max_seq_len + 2


def config_from_args(args: argparse.Namespace) -> Config:
    fields = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(args).items() if k in fields})


def padded_vocab_size(vocab_size: int, multiple: int) -> int:
    """``--vocab-multiple`` padding (``src/main.py:inject_vocab_size``)."""
    if multiple > 1:
        return ((vocab_size + multiple - 1) // multiple) * multiple
    return vocab_size


def resolve_device(name: str) -> torch.device:
    """``--device`` → ``torch.device``.  A CUDA device that is not there is
    an error: the port never quietly carries on on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available; pass --device cpu to "
            "run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: expected 'cuda[:N]' or 'cpu'")
    return device
