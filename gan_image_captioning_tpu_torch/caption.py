"""Caption inference entry point — the port of ``src/caption.py``.

    python -m gan_image_captioning_tpu_torch.caption \\
        --checkpoint save/debug_1/models/pretrained_model.ckpt \\
        --dataset synthetic --beam-size 4 --num-samples 16

Loads a generator checkpoint (``pretrained_model.ckpt``, or the generator
of ``adv_model.ckpt``), decodes the first ``--num-samples`` rows of a
split and writes one JSON line per caption (``caption``, ``logprob``,
``reference``; diverse beam search writes ``captions`` and ``logprobs``,
one per group) to stdout or ``--output``, and returns the decoded id rows.
Under ``--tokenizer bpe`` the captions are the BPE's text, as
``serve.py``'s.  ``--decode-mode``: ``greedy``
(the serve/greedy kernel on the card, ``--adaptive-chunk K`` its
early-stopping chunks), ``beam`` (``--beam-groups`` above 1: diverse),
``sample`` (the sampling flags; noise from ``--sample-seed``, one
generator a batch), ``speculative`` (LSTM only: the greedy ids through
``eval/speculative.py``, the quantized twin drafting ``--draft-len``
tokens a block, and the logprobs of a rescoring pass), or ``auto`` (beam
when ``--beam-size`` is above 1).
``--quantize int8|int4`` decodes the quantized decoder.  ``--device``
defaults to ``cuda`` and raises without a card.  ``--exported`` and
``--mesh`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import json
import sys

import torch

from gan_image_captioning_tpu_torch.config import (build_parser,
                                                   config_from_args,
                                                   require_ported_flags,
                                                   resolve_device)
from gan_image_captioning_tpu_torch.serve import (add_decode_mode_args,
                                                  add_sampling_args,
                                                  decode_mode,
                                                  sample_generator)


def parse_args(argv=None):
    parser = build_parser()
    parser.add_argument("--checkpoint", type=str, default="",
                        help="path to pretrained_model.ckpt or adv_model.ckpt")
    parser.add_argument("--exported", type=str, default="",
                        help="not ported yet: raises when set")
    parser.add_argument("--split", type=str, default="val",
                        choices=["train", "val", "test"])
    parser.add_argument("--num-samples", type=int, default=32,
                        help="how many captions to generate")
    parser.add_argument("--output", type=str, default="",
                        help="write captions as JSONL here (default: stdout)")
    parser.add_argument("--beam-groups", type=int, default=1,
                        help="beam mode: diverse beam search with G groups "
                             "(G distinct captions per sample; 1 = vanilla "
                             "beam)")
    parser.add_argument("--diversity-strength", type=float, default=0.5,
                        help="diverse beam: penalty per same-step token "
                             "reuse across groups")
    parser.add_argument("--adaptive-chunk", type=int, default=0,
                        help="greedy mode: decode K-step blocks that stop "
                             "once every row emitted <E> (0 = the full-T "
                             "decode)")
    add_sampling_args(parser)
    add_decode_mode_args(parser)
    args = parser.parse_args(argv)
    if args.exported:
        raise NotImplementedError("--exported: decoding from an exported "
                                  "artifact is not ported yet")
    if not args.checkpoint:
        parser.error("--checkpoint is required")
    return args


def main(argv=None):
    args = parse_args(argv)
    require_ported_flags(config_from_args(args))
    device = resolve_device(args.device)

    from gan_image_captioning_tpu_torch.data.loader import Batcher
    from gan_image_captioning_tpu_torch.eval import decode as decode_lib
    from gan_image_captioning_tpu_torch.eval.metrics import (caption_text,
                                                             text_vocab)
    from gan_image_captioning_tpu_torch.eval.speculative import (
        speculative_greedy)
    from gan_image_captioning_tpu_torch.main import (build_datasets,
                                                     inject_vocab_size)
    from gan_image_captioning_tpu_torch.models import api
    from gan_image_captioning_tpu_torch.ops.quantize import (
        quantize_generator)
    from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib
    from gan_image_captioning_tpu_torch.train.steps import batch_to

    train_ds, val_ds = build_datasets(args)
    ds = {"train": train_ds, "val": val_ds, "test": val_ds}[args.split]
    inject_vocab_size(args, train_ds)
    config = config_from_args(args)
    beam = max(1, config.beam_size)
    mode = decode_mode(args, config)
    if mode == "speculative" and config.gen_arch != "lstm":
        raise SystemExit("--decode-mode speculative requires the LSTM "
                         "generator (deferred-projection verify)")
    gen, _ = ckpt_lib.load_generator_checkpoint(args.checkpoint, config,
                                                device)
    gen.requires_grad_(False)
    # --quantize: the encoder stays full precision, the decode reads the
    # quantized decoder; speculative mode: that twin (int8 under
    # --quantize none) is the draft and gen the verify target
    dec = (quantize_generator(gen, config)
           if config.quantize != "none" or mode == "speculative" else gen)

    @torch.no_grad()
    def decode_batch(batch, call):
        cond = api.generator_condition(config, gen, batch, train=False)[0]
        feats, ctx = cond["features"], cond["context"]
        if mode == "beam" and args.beam_groups > 1:
            return decode_lib.diverse_beam_search(
                dec, feats, config, beam_size=beam,
                num_groups=args.beam_groups,
                diversity_strength=args.diversity_strength,
                length_penalty=config.length_penalty,
                min_length=args.min_length, context=ctx)
        if mode == "beam":
            return decode_lib.beam_search(
                dec, feats, config, beam_size=beam,
                length_penalty=config.length_penalty,
                min_length=args.min_length, context=ctx)
        if mode == "sample":
            return decode_lib.sample_decode(
                dec, feats, config,
                sample_generator(args.sample_seed, call, device),
                temperature=args.sample_temperature, top_k=args.top_k,
                top_p=args.top_p,
                repetition_penalty=args.repetition_penalty,
                no_repeat_ngram=args.no_repeat_ngram,
                min_length=args.min_length, context=ctx)
        if mode == "speculative":
            ids = speculative_greedy(gen, dec, feats, config,
                                     draft_len=args.draft_len)
            return ids, decode_lib.sequence_logprob(gen, feats, ids, config,
                                                    ctx)
        if args.adaptive_chunk > 0:
            return decode_lib.greedy_with_logprobs_adaptive(
                dec, feats, config, context=ctx, chunk=args.adaptive_chunk)
        ids = decode_lib.greedy(dec, feats, config, context=ctx)
        return ids, decode_lib.sequence_logprob(dec, feats, ids, config, ctx)

    vocab = text_vocab(ds)

    def words(ids):
        return caption_text(ids, vocab)

    out_f = open(args.output, "w") if args.output else sys.stdout
    batch_size = min(args.num_samples, config.pre_eval_batch_size)
    emitted, decoded = 0, []
    for call, batch in enumerate(Batcher(ds, batch_size, config.seq_len)):
        ids, scores = decode_batch(batch_to(batch, device), call)
        ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
        for i in range(ids.shape[0]):
            if batch["weights"][i] == 0 or emitted >= args.num_samples:
                break
            reference = words(batch["captions"][i])
            if ids.ndim == 3:
                # diverse beam: one row per sample, G captions in it
                caps = [words(row) for row in ids[i]]
                row = {"caption": caps[0], "captions": caps,
                       "logprobs": [float(s) for s in scores[i]],
                       "reference": reference}
            else:
                row = {"caption": words(ids[i]),
                       "logprob": float(scores[i]), "reference": reference}
            out_f.write(json.dumps(row) + "\n")
            decoded.append(ids[i])
            emitted += 1
        if emitted >= args.num_samples:
            break
    if args.output:
        out_f.close()
        print(f"wrote {emitted} captions to {args.output}")
    return decoded


if __name__ == "__main__":
    main()
