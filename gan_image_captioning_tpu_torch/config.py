"""The flag system of the port's entry points.

Counterpart of ``gan_image_captioning_tpu/config.py``: the same flag names
and defaults for what the serving path, the training steps and the
training loop read, parsed into a frozen :class:`Config`, with the JAX
package's ``--preset`` bundles ``config1``-``config5`` and its
experiment-dir side effects (:func:`make_experiment_dirs`).  Flags of the
JAX package that the port does not honour yet are parsed and refused when
set (:func:`require_ported_flags`), never ignored.  ``--device`` defaults
to ``cuda``; :func:`resolve_device` turns it into a ``torch.device`` and
refuses to fall back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
from typing import Optional, Tuple

import torch


def _int_list(text):
    """A comma-separated int list, e.g. ``3,4,5`` (the JAX package's
    parser for ``--disc-filter-sizes`` / ``--disc-num-filters``)."""
    if isinstance(text, (list, tuple)):
        return [int(x) for x in text]
    return [int(x) for x in str(text).replace(" ", "").split(",") if x]


# The JAX package's presets (``config.py:PRESETS``) as flag defaults;
# explicit flags still win.
PRESETS = {
    "config1": dict(conditional_gan=1, pretrain_epochs=20, adv_epochs=0,
                    dataset_percent=0.01, captions_per_image=5, beam_size=1,
                    pre_train_batch_size=32, pre_eval_batch_size=32,
                    mle_objective="teacher"),
    "config2": dict(conditional_gan=1, pretrain_epochs=50, adv_epochs=0,
                    captions_per_image=5, beam_size=4,
                    gen_embed_dim=512, gen_num_layers=2),
    "config3": dict(gen_embed_dim=512, gen_num_layers=2, pretrain_epochs=50,
                    adv_epochs=50, pretrain_lr=1e-2, gen_lr=1e-4,
                    disc_lr=1e-4, dataset_percent=0.1, captions_per_image=5),
    "config4": dict(gen_arch="transformer", disc_arch="transformer",
                    gen_embed_dim=256, gen_hidden_dim=256, gen_num_layers=4,
                    gen_num_heads=8, disc_embed_dim=64, disc_hidden_dim=128,
                    disc_num_heads=8, disc_num_layers=4,
                    adv_objective="reinforce", rollout_num=4,
                    rollout_stride=4, pretrain_epochs=50, adv_epochs=50,
                    dataset_percent=0.1, captions_per_image=5),
    # ViT-B/16 encoder + GPT-2-small generator cross-attending over the
    # patch grid, BPE, bfloat16, uint8 images normalized on the device
    "config5": dict(encoder_arch="vit", gen_arch="gpt2", conditional_gan=1,
                    tokenizer="bpe", captions_per_image=5, dtype="bfloat16",
                    device_preprocess=1, pretrain_epochs=50, adv_epochs=50),
}


def _scan_preset(argv) -> Optional[str]:
    if argv is None:
        import sys

        argv = sys.argv[1:]
    for i, tok in enumerate(argv):
        if tok == "--preset":
            return argv[i + 1] if i + 1 < len(argv) else None
        if tok.startswith("--preset="):
            return tok.split("=", 1)[1]
    return None


class _PresetParser(argparse.ArgumentParser):
    """Resolves ``--preset`` as flag defaults before the real parse (the
    JAX package's two-pass ``_PresetParser``)."""

    def parse_known_args(self, args=None, namespace=None):
        name = _scan_preset(args)
        if name is not None:
            if name not in PRESETS:
                self.error(f"unknown --preset {name!r}")
            self.set_defaults(**PRESETS[name])
        return super().parse_known_args(args, namespace)


def add_model_args(parser):
    """Generator and discriminator flags (the JAX package's
    ``add_model_args``)."""
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
                   help="generator architecture; 'gpt2' is the transformer "
                        "at GPT-2-small's geometry (768 / 3072, 12 layers, "
                        "12 heads)")
    g.add_argument("--gen-num-heads", type=int, default=8,
                   help="attention heads for the transformer generator")
    g.add_argument("--disc-arch", type=str, default="cnn",
                   choices=["cnn", "transformer", "ar_transformer", "bilstm"],
                   help="discriminator architecture: the RelGAN CNN, the "
                        "bidirectional or autoregressive transformer, or "
                        "the bidirectional LSTM")
    g.add_argument("--disc-hidden-dim", type=int, default=128,
                   help="hidden dim of the transformer discriminator")
    g.add_argument("--disc-num-heads", type=int, default=8,
                   help="attention heads for the transformer discriminator")
    g.add_argument("--disc-num-layers", type=int, default=4,
                   help="layers of the transformer discriminator")
    g.add_argument("--disc-embed-dim", type=int, default=64,
                   help="embeddings dimension to use in discriminator")
    g.add_argument("--disc-num-rep", type=int, default=64,
                   help="number of representations to use for CNN "
                        "discriminator")
    g.add_argument("--disc-filter-sizes", type=_int_list, default=[3, 4, 5],
                   help="Layer wise filter sizes to use in discriminator")
    g.add_argument("--disc-num-filters", type=_int_list,
                   default=[300, 300, 300],
                   help="number of filters to use in discriminator per layer")
    g.add_argument("--disc-init", type=str, default="uniform",
                   choices=["uniform", "normal"],
                   help="init strategy for discriminator weights")


def add_training_args(parser):
    """Optimizer and adversarial-training flags (the JAX package's
    ``add_training_args`` and stabilization flags)."""
    g = parser.add_argument_group("training")
    g.add_argument("--pretrain-lr", type=float, default=1e-2,
                   help="learning rate for pretraining generator")
    g.add_argument("--gen-lr", type=float, default=1e-4,
                   help="learning rate for adversarial training of generator")
    g.add_argument("--disc-lr", type=float, default=1e-4,
                   help="learning rate for adversarial training of "
                        "discriminator")
    g.add_argument("--disc-train-freq", type=int, default=1,
                   help="generator steps per discriminator step")
    g.add_argument("--adv-loss-type", type=str, default="standard",
                   choices=["standard", "JS", "KL", "hinge", "tv", "rsgan"],
                   help="Loss function to use for adversarial training")
    g.add_argument("--temperature", type=int, default=100,
                   help="Maximum Gumbel temperature for RelGAN training")
    g.add_argument("--temp-adpt", type=str, default="exp",
                   choices=["no", "lin", "exp", "log", "sigmoid", "quad",
                            "sqrt"],
                   help="Temperature adaption strategy")
    g.add_argument("--clip-norm", type=float, default=5.0,
                   help="Gradient clipping threshold (global norm)")
    g.add_argument("--label-smoothing", type=float, default=0.0,
                   help="one-sided label smoothing for the discriminator's "
                        "real targets")
    g.add_argument("--noisy-labels", type=float, default=0.0,
                   help="probability of flipping real/fake labels for the "
                        "discriminator")
    g.add_argument("--adv-objective", type=str, default="gumbel",
                   choices=["gumbel", "reinforce"],
                   help="adversarial generator objective: 'gumbel' = the "
                        "reference's Gumbel-softmax relaxation; 'reinforce' "
                        "= policy gradient with rollout-based rewards")
    g.add_argument("--rollout-num", type=int, default=0,
                   help="Monte-Carlo completions per prefix for rollout "
                        "rewards (reinforce); 0 = terminal-only reward")
    g.add_argument("--rollout-stride", type=int, default=4,
                   help="evaluate rollout rewards every N prefix positions")
    g.add_argument("--rl-baseline", type=str, default="greedy",
                   choices=["greedy", "batch_mean"],
                   help="REINFORCE baseline: 'greedy' = the greedy decode's "
                        "discriminator score, 'batch_mean' = the batch's "
                        "mean reward")
    g.add_argument("--mle-objective", type=str, default="free",
                   choices=["free", "teacher", "scheduled"],
                   help="LSTM pretrain forward: 'free' = the reference's "
                        "free-running sample objective (training.py:71), "
                        "'teacher' = teacher forcing (the reference's unused "
                        "Decoder.forward, generator.py:39-53), 'scheduled' = "
                        "scheduled sampling (Bengio et al. 2015) ramping the "
                        "model-feedback probability 0 → --ss-max-prob over "
                        "the pretrain epochs. Transformers always run the "
                        "report's parallel teacher-forced MLE (§3.2.2)")
    g.add_argument("--ss-max-prob", type=float, default=1.0,
                   help="scheduled sampling: final model-feedback "
                        "probability of the linear per-epoch ramp")
    g.add_argument("--lr-schedule", type=str, default="constant",
                   choices=["constant", "cosine", "linear", "exponential"],
                   help="learning-rate decay shape applied to all three "
                        "optimizers' base LRs (the reference runs fixed LRs "
                        "only, training.py:24-26); pairs with "
                        "--lr-warmup-steps/--lr-decay-steps/--lr-min-ratio")
    g.add_argument("--lr-warmup-steps", type=int, default=0,
                   help="linear warmup 0 → base LR over this many optimizer "
                        "steps before the decay shape starts")
    g.add_argument("--lr-decay-steps", type=int, default=0,
                   help="decay horizon in optimizer steps (required > 0 for "
                        "non-constant --lr-schedule)")
    g.add_argument("--lr-min-ratio", type=float, default=0.0,
                   help="final LR as a fraction of the base LR (cosine alpha "
                        "/ linear end / exponential per-horizon decay rate)")
    g.add_argument("--grad-accum", type=int, default=1,
                   help="split each batch into this many microbatches inside "
                        "the step and apply ONE optimizer update on the "
                        "averaged grads — large effective batches beyond "
                        "device memory")
    g.add_argument("--ema-decay", type=float, default=0.0,
                   help="maintain an exponential moving average of generator "
                        "params with this decay (0 = off); best-val "
                        "checkpoints gain a *_ema.ckpt twin usable with "
                        "evaluate.py --checkpoint")
    g.add_argument("--skip-nonfinite-grads", type=int, default=0,
                   help="skip an optimizer update (params/opt-state/EMA "
                        "unchanged; counters still advance) when that "
                        "side's gradient global norm is non-finite — the "
                        "production guard for long bf16 adversarial runs "
                        "where one poisoned batch would destroy the run. "
                        "0 = reference behavior (apply whatever came back)")
    g.add_argument("--debug-nans", action="store_true",
                   help="fail loudly (FloatingPointError) at the first "
                        "non-finite loss, module output or gradient, under "
                        "autograd's anomaly mode")
    g.add_argument("--steps-per-call", type=int, default=1,
                   help="train steps run in ONE call over K stacked batches "
                        "(one host→device copy of the K batches). "
                        "Interrupt/mid-epoch-checkpoint granularity "
                        "becomes K batches. 1 = reference per-batch stepping")
    g.add_argument("--profile-dir", type=str, default="",
                   help="if set, dump a torch.profiler trace (Chrome JSON) "
                        "for the first adv epoch into this directory")
    g.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype: bfloat16 trains in mixed precision "
                        "(bfloat16 compute over float32 master weights, "
                        "Adam state and checkpoints; losses reduced in "
                        "float32) and runs the quantized decode "
                        "(--quantize) in bfloat16")
    g.add_argument("--pretrain-epochs", type=int, default=0,
                   help="number of epochs for pretraining generator")
    g.add_argument("--pre-train-batch-size", type=int, default=64,
                   help="batch size for pretrain training")
    g.add_argument("--pre-eval-batch-size", type=int, default=64,
                   help="batch size for pretrain evaluation")
    g.add_argument("--adv-epochs", type=int, default=30,
                   help="number of epochs for adversarial training")
    g.add_argument("--adv-train-batch-size", type=int, default=64,
                   help="batch size for adversarial training")
    g.add_argument("--adv-eval-batch-size", type=int, default=64,
                   help="batch size for adversarial evaluation")
    g.add_argument("--seed", type=int, default=1008,
                   help="global seed (reference main.py:14 hardcodes 1008)")
    g.add_argument("--init-gen-ckpt", type=str, default="",
                   help="warm-start the generator from a checkpoint of the "
                        "port (optimizers and counters fresh)")
    g.add_argument("--resume", type=str, default="",
                   help="a full training state (interrupt_state.ckpt, "
                        "state_N.ckpt, state_pre_N.ckpt) to resume from, "
                        "or 'auto': the newest such file under this "
                        "experiment name's earlier run dirs (a fresh start "
                        "when there is none; the same command line "
                        "restarts a killed run)")
    g.add_argument("--resume-schedule", type=int, default=1,
                   help="with --resume, continue the schedule at the "
                        "phase, epoch and batch its sidecar "
                        "(<ckpt>.schedule.json) records (0 = restore the "
                        "state only and run the schedule from the start)")
    g.add_argument("--checkpoint-every", type=int, default=0,
                   help="also save a full resumable training state every N "
                        "pretrain / adversarial epochs (0 = best-val "
                        "checkpoints only)")
    g.add_argument("--keep-checkpoints", type=int, default=0,
                   help="keep only the N newest --checkpoint-every "
                        "snapshots of each phase (0 = keep all); best-val "
                        "checkpoints are never pruned")
    g.add_argument("--early-stop-patience", type=int, default=0,
                   help="stop the pretrain or adversarial phase when its "
                        "best val loss has not improved for this many "
                        "epochs (0 = off)")
    g.add_argument("--scst-epochs", type=int, default=0,
                   help="self-critical sequence training epochs between "
                        "MLE pretraining and adversarial training: "
                        "REINFORCE on a sentence reward with the greedy "
                        "decode as baseline (train/scst.py; 0 = off)")
    g.add_argument("--scst-reward", type=str, default="cider",
                   choices=["cider", "bleu"],
                   help="SCST reward: CIDEr-D with idf fit over the "
                        "training captions, or smoothed sentence BLEU-4")
    g.add_argument("--scst-multi-ref", action="store_true",
                   help="score SCST rewards against every caption of the "
                        "row's image instead of the row's own caption")
    g.add_argument("--scst-lr", type=float, default=0.0,
                   help="SCST learning rate (0 = --gen-lr); the update "
                        "shares the adversarial generator's Adam state")


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
    g.add_argument("--tokenizer", type=str, default="word",
                   choices=["word", "bpe"],
                   help="'word' = the reference's first-appearance word "
                        "vocabulary; 'bpe' = GPT-2 byte-level BPE "
                        "(data/bpe.py) over --bpe-vocab / --bpe-merges, ids "
                        "offset by the 4 specials (COCO only: "
                        "--dataset synthetic keeps its own vocabulary)")
    g.add_argument("--bpe-vocab", type=str, default="",
                   help="path to a GPT-2-format vocab.json (--tokenizer bpe)")
    g.add_argument("--bpe-merges", type=str, default="",
                   help="path to a GPT-2-format merges.txt (--tokenizer bpe)")
    g.add_argument("--image-size", type=int, default=256,
                   help="resize dim of images")
    g.add_argument("--captions-per-image", type=int, default=1,
                   help="no of captions to use per image")
    # the reference's underscore spelling, and the dashed one
    g.add_argument("--dataset_percent", "--dataset-percent", type=float,
                   default=1.0, dest="dataset_percent",
                   help="percentage of dataset to use for training")
    g.add_argument("--synthetic-items", type=int, default=512,
                   help="train items for --dataset synthetic (val gets 1/4)")
    g.add_argument("--device-preprocess", type=int, default=0, choices=[0, 1],
                   help="ship resized uint8 images to the device and "
                        "normalize there (the image_norm kernel)")
    g.add_argument("--length-buckets", type=str, default="",
                   help="comma-separated caption-length bucket upper bounds "
                        "(e.g. '12,20,36'); batches are grouped per bucket "
                        "so short captions don't pay full-width compute. "
                        "Empty = single fixed width (max_seq_len+2).")
    g.add_argument("--precollate", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="collate the whole dataset into dense arrays once "
                        "so every epoch batch is a numpy row-gather "
                        "(removes the per-batch Python collation). auto = "
                        "on when captions + decoded images fit "
                        "$GIC_PRECOLLATE_BUDGET bytes (default 1 GiB); "
                        "the collation is shared by the loaders of a "
                        "dataset, so this is lossless")
    g.add_argument("--num-workers", type=int, default=4,
                   help="accepted; the port's loader is single-threaded "
                        "(this changes overlap, never results)")
    g.add_argument("--device-prefetch", type=int, default=2,
                   help="accepted; batches are copied to the device in the "
                        "step's thread (this changes overlap, never "
                        "results)")


def add_global_args(parser):
    g = parser.add_argument_group("global")
    g.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on: 'cuda' (default), "
                        "'cuda:N' or 'cpu'")
    g.add_argument("--expt-name", type=str, default="debug",
                   help="Name of the experiment")
    g.add_argument("--model-dir", type=str, default="models",
                   help="directory to save models")
    g.add_argument("--data-dir", type=str, default="./data",
                   help="directory where data is stored")
    g.add_argument("--save-dir", type=str, default="./save",
                   help="directory to save the expt logs")
    g.add_argument("--adv-log-step", type=int, default=1,
                   help="Log step frequency for adversarial training")
    g.add_argument("--pre-log-step", type=int, default=1,
                   help="Log step frequency for pretraining")
    g.add_argument("--log-file", type=str, default="log",
                   help="Log file to save logs")


def add_extension_args(parser):
    """The decode extensions of the JAX package's ``add_tpu_args`` that
    the port has."""
    g = parser.add_argument_group("extensions")
    g.add_argument("--quantize", type=str, default="none",
                   choices=["none", "int8", "int4"],
                   help="weight-only quantization of the decode path "
                        "(serve): int8 stores the decoder (embedding, LSTM "
                        "stack, vocab projection) as symmetric "
                        "per-channel int8, int4 as int4 packed two per "
                        "byte (ops/quantize.py); training stays float32")
    g.add_argument("--encoder-arch", type=str, default="resnet18",
                   choices=["resnet18", "vit"],
                   help="image encoder backbone: ResNet-18 or ViT-B/16")
    g.add_argument("--trainable-backbone", type=int, default=0,
                   choices=[0, 1],
                   help="train the image backbone instead of freezing it")
    g.add_argument("--beam-size", type=int, default=1,
                   help="beam width for caption decoding at eval and in "
                        "serving (1 = greedy; eval/decode.py:beam_search)")
    g.add_argument("--length-penalty", type=float, default=0.0,
                   help="GNMT length-penalty alpha for beam-search final "
                        "ranking, ((5+len)/6)^alpha (0 = rank by pure "
                        "log-probability); used by every beam surface "
                        "(caption/evaluate/serve/instructor BLEU eval)")
    g.add_argument("--eval-bleu-every", type=int, default=0,
                   help="compute BLEU-4/NLL_gen/self-BLEU on val every N "
                        "adversarial epochs (0 = off)")
    g.add_argument("--preset", type=str, default=None,
                   choices=sorted(PRESETS),
                   help="a named benchmark configuration as flag defaults")
    g.add_argument("--disc-engine", type=str, default="auto",
                   choices=["auto", "xla", "pallas", "hybrid", "mxu"],
                   help="discriminator conv/ReLU/max-pool engine: 'auto' "
                        "= 'mxu' (the matmul-formulated kernels, "
                        "csrc/disc_conv.cu); 'xla' = the plain PyTorch "
                        "versions; 'pallas' = the per-batch-row engine, "
                        "which runs the 'mxu' kernels forward and backward "
                        "(csrc/disc_conv.cu) behind counters of its own; "
                        "'hybrid' = the plain forward (cuDNN conv, ReLU, "
                        "max) and that engine's backward kernel.  CPU "
                        "tensors always take the plain versions")
    g.add_argument("--decode-impl", type=str, default="fused",
                   choices=["fused", "decoupled", "kernel"],
                   help="LSTM decode route: 'fused' and 'kernel' (the "
                        "same function in the JAX package) both take the "
                        "decode, BPTT and sampler kernels on CUDA tensors; "
                        "'decoupled' samples the ids with a gradient-free "
                        "loop of PyTorch operations, then rescores them "
                        "(its backward through the reverse BPTT kernel)")
    g.add_argument("--use-pallas", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="route Gumbel sampling through the fused sampler "
                        "kernel (auto = on, as on CUDA tensors). Its PRNG "
                        "stream differs from the plain draw's, so runs are "
                        "not bit-comparable with --use-pallas off.")
    g.add_argument("--no-jit", action="store_true",
                   help="accepted: the port runs eagerly, as the JAX "
                        "package does under this flag")
    # parsed as the JAX package parses them; neither package reads them
    # (--vocab-size is overwritten by the dataset's vocabulary)
    g.add_argument("--vocab-size", type=int, default=-1,
                   help="accepted; set from the dataset")
    g.add_argument("--padding-idx", type=int, default=0,
                   help="accepted; <PAD> is id 0")
    g.add_argument("--device-ids", type=int, default=0,
                   help="accepted; pick a card with --device cuda:N")
    g.add_argument("--test-log-step", type=int, default=1,
                   help="accepted; no test phase logs")
    g.add_argument("--random-flip", type=int, default=0, choices=[0, 1],
                   help="train-time random horizontal image flip, on the "
                        "device inside the step (ops/augment.py; the "
                        "reference's transform chain is deterministic)")
    g.add_argument("--random-crop-pad", type=int, default=0,
                   help="train-time random translation: reflect-pad images "
                        "by N pixels then crop back to size at a random "
                        "offset per image (0 = off)")
    g.add_argument("--encoder-init", type=str, default="sweep",
                   choices=["sweep", "natural"],
                   help="'sweep' = reference parity: the init sweep "
                        "overwrites every encoder weight, BatchNorm scales "
                        "included; 'natural' keeps the encoder's own "
                        "kaiming / BatchNorm-ones initialization")
    g.add_argument("--cache-features", type=int, default=0, choices=[0, 1],
                   help="precompute the frozen backbone's pooled features "
                        "once per image (eval-mode BatchNorm) and train "
                        "the head on them; conditional LSTM generator with "
                        "a frozen backbone only (data/feature_cache.py)")
    # The JAX package's flags that the port does not honour yet: each is
    # parsed with its JAX default and refused when set
    # (require_ported_flags).
    for flag, kw, _ in _UNPORTED_FLAG_ARGS:
        g.add_argument(flag, **kw, help="not ported yet: raises when set")


# flag → (argparse keywords with the JAX name, type and default; the
# values the port honours, None for the default only)
# (ROADMAP.md queue 1, item 4: parallelism)
_UNPORTED_FLAG_ARGS = (
    ("--mesh", dict(type=str, default=""), None),
    ("--cp-mode", dict(type=str, default="gspmd",
                       choices=["gspmd", "ring", "ulysses"]), None),
    ("--pp-microbatches", dict(type=int, default=4), None),
    ("--zero1", dict(action="store_true"), None),
)


def refuse_unported(table, values, item: str = "4: parallelism") -> None:
    """Raise ``NotImplementedError`` for each flag of ``table`` (entries as
    in ``_UNPORTED_FLAG_ARGS``) whose value on ``values`` (a Config or a
    parsed namespace) is not one the port honours, naming ``ROADMAP.md``
    queue 1's ``item``."""
    for flag, kw, honoured in table:
        value = getattr(values, flag[2:].replace("-", "_"))
        if value not in (honoured or (kw.get("default", False),)):
            raise NotImplementedError(f"{flag} {value}: not ported yet "
                                      f"(ROADMAP.md queue 1, item {item})")


DECODE_ROUTES = ("kernel", "kernel_rescore", "kernel_embed", "decoupled",
                 "plain")


def decode_route(config) -> str:
    """The LSTM decode route that ``config.decode_impl`` names, one of
    :data:`DECODE_ROUTES`; every caller that picks a decode, sampler or
    BPTT route asks here.

    * ``kernel``: the JAX package's ``fused`` and ``kernel`` (the same
      function there), the default: the ``sample_resid`` decode with the
      manual backward through the BPTT chain; greedy decode + rescore in
      the MLE step;
    * ``kernel_rescore`` (``Config`` value, the JAX ``--decode-impl kernel``
      with ``GIC_KERNEL_VJP=0``): the mode ``sample`` decode, then the
      differentiable rescore;
    * ``kernel_embed`` (``Config`` value, the JAX ``--decode-impl kernel``
      with ``GIC_FUSE_EMBED=1``): the ``sample_embed`` decode fused into
      the CNN discriminator's embedding; only for an LSTM generator with
      the CNN discriminator, as the JAX package's ``_fuse_embed_active``,
      else ``kernel``;
    * ``decoupled``: the JAX ``_sample_decoupled``, a gradient-free loop of
      PyTorch operations, then the rescore;
    * ``plain`` (the port's own): the plain PyTorch versions on any
      device, to compare a step through the kernels with the same step
      without them.
    """
    impl = {"fused": "kernel"}.get(config.decode_impl, config.decode_impl)
    if impl not in DECODE_ROUTES:
        raise ValueError(f"decode_impl {config.decode_impl!r}: expected "
                         "'fused', 'decoupled', 'kernel' or one of "
                         f"{', '.join(DECODE_ROUTES)}")
    if impl == "kernel_embed" and (config.gen_arch != "lstm"
                                   or config.disc_arch != "cnn"):
        return "kernel"
    return impl


def build_parser() -> argparse.ArgumentParser:
    parser = _PresetParser("GAN captioning (PyTorch port)")
    add_data_args(parser)
    add_model_args(parser)
    add_training_args(parser)
    add_extension_args(parser)
    add_global_args(parser)
    return parser


@dataclasses.dataclass(frozen=True)
class Config:
    """Frozen view of the flags (field names and defaults as in the JAX
    package's ``Config``, with the port's own values of the kernel routes
    below).

    ``decode_impl``: the JAX package's ``"fused"`` (the default),
    ``"kernel"`` and ``"decoupled"``, and the port's ``"kernel_rescore"``,
    ``"kernel_embed"`` and ``"plain"``, each a route of
    :func:`decode_route`.  The kernel routes call the decode, BPTT (the
    stacked chain and the single-layer reverse of the teacher-forced
    pass) and Gumbel-sampler wrappers, which launch the CUDA kernels on
    CUDA tensors and run the plain versions on CPU ones; ``"plain"`` runs
    the plain PyTorch versions on any device, to compare a step through
    the kernels with the same step without them.

    ``disc_engine`` (the conv banks, ``kernels/disc_conv.py``): ``"auto"``
    (the default) is ``"mxu"``, the matmul-formulated forward and
    backward-dX kernels; ``"pallas"`` the per-batch-row forward and
    backward kernels; ``"hybrid"`` the plain forward (cuDNN) with the
    per-batch-row backward kernel; ``"mxu_dxs"`` (not a CLI choice: the
    JAX package's ``GIC_MXU_DX=0``) the ``mxu`` forward with the DXS
    backward kernel and the overlap-add in torch; ``"xla"`` and the port's
    ``"plain"`` the plain versions on any device.  Every engine takes the
    plain versions on CPU tensors.

    ``bf16_mu`` (the JAX package's ``GIC_BF16_MU=1``): every Adam first
    moment is stored in bfloat16.  ``bf16_grads`` (``GIC_BF16_GRADS=1``,
    under ``--dtype bfloat16`` only): the adversarial step differentiates
    with respect to bfloat16 copies of the parameters, so the gradients
    accumulate in bfloat16, and casts them to the float32 masters.
    ``int8_dtype`` (``GIC_INT8_DTYPE``): the compute dtype of the quantized
    decodes, ``"float32"`` or ``"bfloat16"``; ``""`` follows ``--dtype``.
    ``tf_remat`` (``GIC_TF_REMAT=1``), ``scan_remat``
    (``GIC_SCAN_REMAT=1``) and ``disc_remat`` (``GIC_DISC_REMAT=1``):
    ``torch.utils.checkpoint`` around each transformer block, the
    scheduled-sampling decode's per-step cell and the CNN discriminator's
    conv trunk, which then keep only their inputs and recompute the rest
    in the backward.

    ``image_norm_impl`` does what ``"kernel"`` / ``"plain"`` do above for
    the ``image_norm`` kernel of ``images_u8`` batches, and ``attn_impl``
    for the flash-attention kernels of the transformers' self-attention
    (``"plain"``: the dense attention with an explicit mask, the JAX
    package's path without ``GIC_FLASH_ATTN``)."""

    vocab_size: int = -1
    gen_embed_dim: int = 32
    gen_hidden_dim: int = 512
    gen_num_layers: int = 1
    max_seq_len: int = 34
    gen_arch: str = "lstm"
    gen_num_heads: int = 8
    gen_init: str = "uniform"
    conditional_gan: int = 0
    # image encoder
    encoder_arch: str = "resnet18"
    trainable_backbone: int = 0
    image_size: int = 256
    device_preprocess: int = 0
    # discriminator
    disc_arch: str = "cnn"
    disc_embed_dim: int = 64
    disc_num_rep: int = 64
    disc_filter_sizes: Tuple[int, ...] = (3, 4, 5)
    disc_num_filters: Tuple[int, ...] = (300, 300, 300)
    disc_init: str = "uniform"
    disc_hidden_dim: int = 128
    disc_num_heads: int = 8
    disc_num_layers: int = 4
    # training
    pretrain_lr: float = 1e-2
    gen_lr: float = 1e-4
    disc_lr: float = 1e-4
    disc_train_freq: int = 1
    adv_loss_type: str = "standard"
    temperature: int = 100
    temp_adpt: str = "exp"
    clip_norm: float = 5.0
    label_smoothing: float = 0.0
    noisy_labels: float = 0.0
    mle_objective: str = "free"
    adv_objective: str = "gumbel"
    rollout_num: int = 0
    rollout_stride: int = 4
    rl_baseline: str = "greedy"
    dtype: str = "float32"
    lr_schedule: str = "constant"
    grad_accum: int = 1
    ema_decay: float = 0.0
    quantize: str = "none"
    beam_size: int = 1
    length_penalty: float = 0.0
    # the training loop's quality eval (GANInstructor.evaluate_quality):
    # every N adversarial epochs, and its greedy decode in chunks of this
    # many steps that stop once every row has emitted <E> (0: the full-T
    # decode; the JAX package's GIC_EVAL_ADAPTIVE)
    eval_bleu_every: int = 0
    eval_adaptive_chunk: int = 0
    # the training loop (train/instructor.py, main.py)
    dataset: str = "coco"
    captions_per_image: int = 1
    dataset_percent: float = 1.0
    synthetic_items: int = 512
    pretrain_epochs: int = 0
    pre_train_batch_size: int = 64
    pre_eval_batch_size: int = 64
    adv_epochs: int = 30
    adv_train_batch_size: int = 64
    adv_eval_batch_size: int = 64
    seed: int = 1008
    init_gen_ckpt: str = ""
    num_workers: int = 4
    device_prefetch: int = 2
    device: str = "cuda"
    expt_name: str = "debug"
    model_dir: str = "models"
    data_dir: str = "./data"
    save_dir: str = "./save"
    adv_log_step: int = 1
    pre_log_step: int = 1
    log_file: str = "log"
    # parsed, read by neither package
    no_jit: bool = False
    padding_idx: int = 0
    device_ids: int = 0
    test_log_step: int = 1
    # the resume, snapshot, early-stop and SCST options
    resume: str = ""
    resume_schedule: int = 1
    checkpoint_every: int = 0
    keep_checkpoints: int = 0
    early_stop_patience: int = 0
    scst_epochs: int = 0
    scst_reward: str = "cider"
    scst_multi_ref: bool = False
    scst_lr: float = 0.0
    # step options and batching (train/state.py, train/steps.py,
    # data/loader.py, train/instructor.py)
    lr_warmup_steps: int = 0
    lr_decay_steps: int = 0
    lr_min_ratio: float = 0.0
    skip_nonfinite_grads: int = 0
    ss_max_prob: float = 1.0
    debug_nans: bool = False
    steps_per_call: int = 1
    length_buckets: str = ""
    precollate: str = "auto"
    profile_dir: str = ""
    use_pallas: str = "auto"
    # train-time augmentation (ops/augment.py) and the frozen backbone's
    # cached features (data/feature_cache.py)
    random_flip: int = 0
    random_crop_pad: int = 0
    cache_features: int = 0
    # the JAX package's options that are not ported (require_ported_flags)
    mesh: str = ""
    cp_mode: str = "gspmd"
    pp_microbatches: int = 4
    zero1: bool = False
    tokenizer: str = "word"
    bpe_vocab: str = ""
    bpe_merges: str = ""
    encoder_init: str = "sweep"
    # the JAX package's environment switches, as fields (no flags: every
    # flag of the port is one of the JAX package's)
    bf16_mu: bool = False
    bf16_grads: bool = False
    int8_dtype: str = ""
    tf_remat: bool = False
    scan_remat: bool = False
    disc_remat: bool = False
    # kernel routes (see the class docstring)
    decode_impl: str = "fused"
    disc_engine: str = "auto"
    image_norm_impl: str = "kernel"
    attn_impl: str = "kernel"

    @property
    def cgan(self) -> bool:
        return self.conditional_gan == 1

    @property
    def seq_len(self) -> int:
        """Static decode length: captions are wrapped ``<S> … <E>``."""
        return self.max_seq_len + 2

    @property
    def disc_feature_dim(self) -> int:
        """sum(num_filters) — reference ``discriminator.py:16``."""
        return int(sum(self.disc_num_filters))

    @property
    def emb_dim_single(self) -> int:
        """Per-representation embedding width — ``discriminator.py:17``."""
        return self.disc_embed_dim // self.disc_num_rep

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def bucket_bounds(self):
        """``--length-buckets`` as ints (None when empty)."""
        return [int(b) for b in self.length_buckets.split(",") if b] or None


# --gen-arch gpt2: the transformer generator at GPT-2-small's geometry
GPT2_GEOMETRY = dict(gen_arch="transformer", gen_embed_dim=768,
                     gen_hidden_dim=3072, gen_num_layers=12, gen_num_heads=12)


def config_from_args(args: argparse.Namespace) -> Config:
    """A parsed namespace → :class:`Config`; ``--gen-arch gpt2`` expands
    to :data:`GPT2_GEOMETRY` (the JAX ``config_from_args``), overriding
    the width flags."""
    fields = {f.name for f in dataclasses.fields(Config)}
    config = Config(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in vars(args).items() if k in fields})
    if config.gen_arch == "gpt2":
        config = config.replace(**GPT2_GEOMETRY)
    return config


def require_ported_arch(config: Config) -> None:
    """Raise for a model the port does not have.  (``--gen-arch gpt2``
    reaches here expanded to the transformer by :func:`config_from_args`;
    a ``Config`` built by hand with ``gen_arch="gpt2"`` must be expanded
    the same way.)"""
    if config.gen_arch not in ("lstm", "transformer"):
        raise ValueError(f"gen_arch {config.gen_arch!r}: expected 'lstm' "
                         "or 'transformer' (config_from_args expands "
                         "'gpt2')")
    if config.disc_arch not in ("cnn", "transformer", "ar_transformer",
                                "bilstm"):
        raise ValueError(f"--disc-arch {config.disc_arch!r}: expected cnn, "
                         "transformer, ar_transformer or bilstm")
    if config.encoder_arch not in ("resnet18", "vit"):
        raise ValueError(f"--encoder-arch {config.encoder_arch!r}: expected "
                         "resnet18 or vit")
    if config.encoder_init not in ("sweep", "natural"):
        raise ValueError(f"--encoder-init {config.encoder_init!r}: expected "
                         "sweep or natural")


INT8_DTYPES = ("", "float32", "bfloat16")


def compute_dtype(config: Config) -> torch.dtype:
    """The dtype ``--dtype`` computes in: bfloat16 under ``--dtype
    bfloat16``, else float32 (the JAX ``_compute_cast``)."""
    return torch.bfloat16 if config.dtype == "bfloat16" else torch.float32


def require_ported_dtype(config: Config) -> None:
    """Raise ValueError for a ``--dtype`` other than float32 and bfloat16,
    and for an ``int8_dtype`` other than ``""``, ``"float32"`` and
    ``"bfloat16"``.  Every decode route and every conv engine runs in
    bfloat16: through the kernels' bfloat16 instantiations, or on the
    plain and decoupled routes through PyTorch's bfloat16 operations."""
    if config.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"--dtype {config.dtype!r}: expected float32 or "
                         "bfloat16")
    if config.int8_dtype not in INT8_DTYPES:
        raise ValueError(f"int8_dtype {config.int8_dtype!r}: expected '', "
                         "'float32' or 'bfloat16'")


def require_ported_flags(config: Config) -> None:
    """Raise for a flag of the JAX package that the port parses but does
    not honour yet, when it is set; for a model :func:`require_ported_arch`
    refuses; and for an unknown ``decode_impl``."""
    refuse_unported(_UNPORTED_FLAG_ARGS, config)
    decode_route(config)
    require_ported_arch(config)


def resolve_auto_resume(args: argparse.Namespace) -> argparse.Namespace:
    """``--resume auto``: the newest resumable state among this experiment
    name's earlier run dirs (``{save_dir}/{expt_name}_{n}/{model_dir}``):
    ``interrupt_state.ckpt`` (a SIGTERM / SIGINT save) and the
    ``state_N.ckpt`` / ``state_pre_N.ckpt`` snapshots; the newest mtime
    wins, and none means a fresh start (``resume = ""``).  Runs before
    :func:`make_experiment_dirs` rewrites ``save_dir`` and ``expt_name``.
    The directories are listed and matched by regular expressions, not
    glob: a save dir such as ``runs[2026]`` is not a character class."""
    if getattr(args, "resume", "") != "auto":
        return args
    run_re = re.compile(re.escape(args.expt_name) + r"_\d+")
    ckpt_re = re.compile(r"(interrupt_state|state_(pre_)?\d+)\.ckpt")
    candidates = []
    try:
        run_dirs = os.listdir(args.save_dir)
    except OSError:
        run_dirs = []
    for run in run_dirs:
        if not run_re.fullmatch(run):
            continue
        mdir = os.path.join(args.save_dir, run, args.model_dir)
        try:
            names = os.listdir(mdir)
        except OSError:
            continue
        candidates.extend(os.path.join(mdir, n) for n in names
                          if ckpt_re.fullmatch(n))
    args.resume = (max(candidates, key=os.path.getmtime)
                   if candidates else "")
    return args


def make_experiment_dirs(args: argparse.Namespace) -> argparse.Namespace:
    """The reference's experiment dirs (``args.py:261-273``): the first free
    ``{save_dir}/{expt_name}_{n}`` and its ``{model_dir}``; ``save_dir``,
    ``model_dir``, ``expt_name`` and ``log_file`` are rewritten into it.
    ``--resume auto`` is resolved first (:func:`resolve_auto_resume`)."""
    resolve_auto_resume(args)
    n = 1
    while os.path.exists(os.path.join(args.save_dir, f"{args.expt_name}_{n}")):
        n += 1
    args.expt_name = f"{args.expt_name}_{n}"
    args.save_dir = os.path.join(args.save_dir, args.expt_name)
    os.makedirs(args.save_dir)
    args.model_dir = os.path.join(args.save_dir, args.model_dir)
    os.makedirs(args.model_dir)
    args.log_file = os.path.join(args.save_dir, args.log_file)
    return args


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
