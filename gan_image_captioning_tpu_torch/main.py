"""Training entry point — the port of ``src/main.py``.

    python -m gan_image_captioning_tpu_torch.main --dataset synthetic \\
        --conditional-gan 1 --image-size 64 --pretrain-epochs 1 \\
        --adv-epochs 1 --device cpu

Sequence (reference ``main.py:10-48``): parse the flags and refuse the ones
not ported yet → resolve ``--resume auto`` and create the experiment dirs
(``config.make_experiment_dirs``) → build the train/val
datasets → inject ``vocab_size`` (with ``--vocab-multiple`` padding) →
dump ``config.json`` → ``GANInstructor(...)._run()``.  ``--device``
defaults to ``cuda`` and raises when CUDA is missing; ``--device cpu``
runs the plain PyTorch versions of the kernels.

A killed run restarts from its newest interrupt save or snapshot when the
same command line carries ``--resume auto`` (add ``--checkpoint-every N``
so that a hard kill finds a snapshot); ``--resume <ckpt>`` names the file.
"""

from __future__ import annotations

import json
import os

from gan_image_captioning_tpu_torch.config import (build_parser,
                                                   config_from_args,
                                                   make_experiment_dirs,
                                                   padded_vocab_size,
                                                   require_ported_flags,
                                                   resolve_device)


def build_datasets(args):
    """``(train, val)`` datasets of ``--dataset`` (``src/main.py``):
    COCO with the word vocabulary or, under ``--tokenizer bpe``, GPT-2's
    BPE over ``--bpe-vocab`` / ``--bpe-merges``; ``--dataset synthetic``
    keeps its own vocabulary whatever ``--tokenizer`` says."""
    conditional = args.conditional_gan == 1
    if args.dataset == "synthetic":
        from gan_image_captioning_tpu_torch.data.synthetic import (
            SyntheticCaptions)

        n = args.synthetic_items
        train = SyntheticCaptions("train", num_items=n,
                                  image_size=args.image_size,
                                  conditional=conditional, seed=args.seed)
        val = SyntheticCaptions("val", num_items=max(n // 4, 16),
                                image_size=args.image_size,
                                conditional=conditional, seed=args.seed)
        return train, val

    from gan_image_captioning_tpu_torch.data.coco import CocoCaptions

    captions_path = os.path.join(args.data_dir, "dataset_coco.json")
    device_pre = bool(args.device_preprocess)
    bpe = None
    if args.tokenizer == "bpe":
        from gan_image_captioning_tpu_torch.data.bpe import BPETokenizer

        if not (args.bpe_vocab and args.bpe_merges):
            raise ValueError("--tokenizer bpe needs --bpe-vocab and "
                             "--bpe-merges")
        bpe = BPETokenizer(args.bpe_vocab, args.bpe_merges)
    train = CocoCaptions(captions_path, args.data_dir, "train",
                         args.image_size, args.captions_per_image,
                         dataset_percent=args.dataset_percent,
                         conditional=conditional,
                         device_preprocess=device_pre, bpe_tokenizer=bpe)
    val = CocoCaptions(captions_path, args.data_dir, "val", args.image_size,
                       args.captions_per_image,
                       vocab_dicts=(train.word_to_index, train.index_to_word),
                       dataset_percent=args.dataset_percent,
                       conditional=conditional, device_preprocess=device_pre,
                       bpe_tokenizer=bpe)
    return train, val


def inject_vocab_size(args, train_dataset):
    """Reference ``main.py:38`` with the ``--vocab-multiple`` padding."""
    args.vocab_size = padded_vocab_size(train_dataset.vocab_size,
                                        args.vocab_multiple)
    return args


def main(argv=None):
    args = build_parser().parse_args(argv)
    # refuse what is not ported, and a missing CUDA device, before any
    # directory is made
    require_ported_flags(config_from_args(args))
    resolve_device(args.device)
    make_experiment_dirs(args)

    train_dataset, val_dataset = build_datasets(args)
    inject_vocab_size(args, train_dataset)
    config = config_from_args(args)
    with open(os.path.join(args.save_dir, "config.json"), "w") as f:
        json.dump({k: (v if isinstance(v, (int, float, str, bool, list,
                                           type(None))) else str(v))
                   for k, v in sorted(vars(args).items())}, f, indent=1)

    from gan_image_captioning_tpu_torch.train.instructor import GANInstructor

    inst = GANInstructor(config, train_dataset, val_dataset)
    inst._run()
    return inst


if __name__ == "__main__":
    main()
