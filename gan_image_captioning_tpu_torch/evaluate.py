"""Evaluation entry point — the port of ``src/evaluate.py``: NLL_gen and
BLEU-4 of a checkpoint on a split, with the optional caption-quality and
diversity metrics.

    python -m gan_image_captioning_tpu_torch.evaluate \\
        --checkpoint save/debug_1/models/adv_model.ckpt --dataset synthetic \\
        --beam-size 4 --diversity --cider --rouge --meteor --disc-score

* NLL_gen: the free-running generator's cross-entropy against the real
  captions (``--mle-objective``'s logits; the mode ``pretrain`` decode
  kernel on the card for the LSTM), with the full-precision weights.
* The decode: diverse beam search (``--beam-size`` above 1 and
  ``--beam-groups`` above 1), beam search (``--beam-size`` above 1), the
  early-stopping greedy decode (``--adaptive-chunk K``) or the greedy
  decode (the serve/greedy kernel on the card), of the quantized decoder
  under ``--quantize int8|int4``.
* ``--disc-score``: the discriminator's mean sigmoid on generated and on
  real captions (an ``adv_model.ckpt`` holds the discriminator; the CNN's
  conv forward kernel on the card).
* ``--diversity`` (self-BLEU, distinct-1/2), ``--cider`` (CIDEr-D),
  ``--rouge`` (ROUGE-L), ``--meteor`` (exact-match METEOR), each row against
  its own reference, or with ``--multi-ref`` one candidate per image
  against all of its references (``bleu4_multiref``).

Prints one JSON line with the JAX entry point's keys and rounding.
``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the plain versions.  ``--mesh`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from gan_image_captioning_tpu_torch.config import (build_parser,
                                                   config_from_args,
                                                   require_ported_flags,
                                                   resolve_device)


def parse_args(argv=None):
    parser = build_parser()
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--split", type=str, default="val",
                        choices=["train", "val", "test"])
    parser.add_argument("--max-batches", type=int, default=0,
                        help="0 = full split")
    parser.add_argument("--disc-score", action="store_true",
                        help="also report the discriminator's mean sigmoid "
                             "score on generated vs real captions (needs an "
                             "adv_model.ckpt)")
    parser.add_argument("--diversity", action="store_true",
                        help="also report self-BLEU (1.0 = all captions "
                             "identical) and distinct-1/2 over the "
                             "generated corpus")
    parser.add_argument("--cider", action="store_true",
                        help="also report CIDEr-D")
    parser.add_argument("--rouge", action="store_true",
                        help="also report ROUGE-L (beta = 1.2)")
    parser.add_argument("--meteor", action="store_true",
                        help="also report METEOR (exact-match stage)")
    parser.add_argument("--multi-ref", action="store_true",
                        help="score ONE candidate per image against ALL of "
                             "its reference captions (the coco-caption "
                             "protocol); default: each row against its own "
                             "reference")
    parser.add_argument("--beam-groups", type=int, default=1,
                        help="with --beam-size > 1: diverse beam search with "
                             "G groups; adds bleu4_oracle (best of G per "
                             "sample)")
    parser.add_argument("--diversity-strength", type=float, default=0.5,
                        help="diverse beam Hamming penalty")
    parser.add_argument("--adaptive-chunk", type=int, default=0,
                        help="greedy decode in K-step blocks that stop once "
                             "every row emitted <E> (0 = the full-T decode)")
    return parser.parse_args(argv)


def _discriminator(state_dict, config, device):
    from gan_image_captioning_tpu_torch.models import api

    disc = api.init_discriminator(torch.Generator().manual_seed(0), config,
                                  device, sweep=False)
    disc.load_state_dict(state_dict, strict=True)
    return disc.requires_grad_(False)


def rows_of(gen_b, real_b, w_b):
    """``(candidates, [reference])`` of every weighted row, stripped."""
    from gan_image_captioning_tpu_torch.eval.metrics import strip_caption

    cands, refs = [], []
    for gen_ids, real_ids, w in zip(gen_b, real_b, w_b):
        for j in range(gen_ids.shape[0]):
            if w is not None and w[j] == 0:
                continue
            cands.append(strip_caption(gen_ids[j]))
            refs.append([strip_caption(real_ids[j])])
    return cands, refs


def rows_by_image(ds, gen_b, real_b, w_b):
    """The coco-caption grouping: the first row's candidate of each image
    (``ds.image_key`` of the row's dataset index; rows arrive in dataset
    order) against every reference of that image."""
    from gan_image_captioning_tpu_torch.eval.metrics import strip_caption

    by_img, row = {}, 0
    for gen_ids, real_ids, w in zip(gen_b, real_b, w_b):
        for j in range(gen_ids.shape[0]):
            if w is not None and w[j] == 0:
                row += 1
                continue
            key = ds.image_key(row)
            row += 1
            ref = strip_caption(real_ids[j])
            if key in by_img:
                by_img[key][1].append(ref)
            else:
                by_img[key] = [strip_caption(gen_ids[j]), [ref]]
    return ([c for c, _ in by_img.values()],
            [r for _, r in by_img.values()])


def main(argv=None):
    args = parse_args(argv)
    require_ported_flags(config_from_args(args))
    device = resolve_device(args.device)

    from gan_image_captioning_tpu_torch.data.loader import Batcher
    from gan_image_captioning_tpu_torch.eval import decode as decode_lib
    from gan_image_captioning_tpu_torch.eval.bleu import (corpus_bleu,
                                                          oracle_bleu4)
    from gan_image_captioning_tpu_torch.eval.metrics import (
        bleu4_from_batches, strip_caption)
    from gan_image_captioning_tpu_torch.main import (build_datasets,
                                                     inject_vocab_size)
    from gan_image_captioning_tpu_torch.models import api
    from gan_image_captioning_tpu_torch.models.discriminator import params_of
    from gan_image_captioning_tpu_torch.ops.losses import cross_entropy_loss
    from gan_image_captioning_tpu_torch.ops.quantize import (
        quantize_generator)
    from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib
    from gan_image_captioning_tpu_torch.train.steps import batch_to

    train_ds, val_ds = build_datasets(args)
    ds = {"train": train_ds, "val": val_ds, "test": val_ds}[args.split]
    inject_vocab_size(args, train_ds)
    config = config_from_args(args)

    gen, disc_sd = ckpt_lib.load_generator_checkpoint(args.checkpoint,
                                                      config, device)
    gen.requires_grad_(False)
    if args.disc_score and disc_sd is None:
        print("warning: --disc-score needs an adv_model.ckpt "
              "(generator+discriminator); skipping", file=sys.stderr)
    disc_p = (params_of(_discriminator(disc_sd, config, device))
              if args.disc_score and disc_sd is not None else None)
    # --quantize: the decode reads the quantized decoder; NLL_gen stays
    # full precision (teacher-forced scoring is a training-path pass)
    dec = (quantize_generator(gen, config) if config.quantize != "none"
           else gen)
    diverse = config.beam_size > 1 and args.beam_groups > 1

    @torch.no_grad()
    def eval_batch(batch):
        cond, _ = api.generator_condition(config, gen, batch, train=False)
        feats, ctx, captions = (cond["features"], cond["context"],
                                batch["captions"])
        logits = api.generator_mle_outputs(gen, cond, captions, config,
                                           lengths=batch.get("lengths"))
        w = batch.get("weights")
        mask = None if w is None else w[:, None].expand(captions.shape)
        nll = cross_entropy_loss(logits, captions, mask)
        groups = None
        if diverse:
            # group 0 feeds the headline metrics, all G bleu4_oracle
            groups, _ = decode_lib.diverse_beam_search(
                dec, feats, config, beam_size=config.beam_size,
                num_groups=args.beam_groups,
                diversity_strength=args.diversity_strength,
                length_penalty=config.length_penalty, context=ctx)
            ids = groups[:, 0]
        elif config.beam_size > 1:
            ids, _ = decode_lib.beam_search(
                dec, feats, config, beam_size=config.beam_size,
                length_penalty=config.length_penalty, context=ctx)
        elif args.adaptive_chunk > 0:
            ids, _ = decode_lib.greedy_with_logprobs_adaptive(
                dec, feats, config, context=ctx, chunk=args.adaptive_chunk)
        else:
            ids = decode_lib.greedy(dec, feats, config, context=ctx)
        d_gen = d_real = torch.zeros((), device=device)
        if disc_p is not None:
            d_gen = torch.sigmoid(api.discriminator_apply(
                disc_p, ids, config, train=False)).mean()
            d_real = torch.sigmoid(api.discriminator_apply(
                disc_p, captions, config, train=False)).mean()
        return nll, ids, d_gen, d_real, groups

    loader = Batcher(ds, config.pre_eval_batch_size, config.seq_len)
    pending, real_b, w_b, n = [], [], [], 0
    for i, batch in enumerate(loader):
        if args.max_batches and i >= args.max_batches:
            break
        pending.append(eval_batch(batch_to(batch, device)))
        real_b.append(batch["captions"])
        w_b.append(batch.get("weights"))
        n += int(batch["weights"].sum())
    # one read from the device after the sweep
    nlls = torch.stack([p[0] for p in pending]).tolist()
    gen_b = [p[1].cpu().numpy() for p in pending]
    d_gen_scores = torch.stack([p[2] for p in pending]).tolist()
    d_real_scores = torch.stack([p[3] for p in pending]).tolist()
    result = {"nll_gen": round(float(np.mean(nlls)), 4),
              "bleu4": round(bleu4_from_batches(gen_b, real_b, w_b), 5),
              "num_samples": n}
    if diverse:
        cand_groups, refs_o = [], []
        for p, real_ids, w in zip(pending, real_b, w_b):
            g3 = p[4].cpu().numpy()
            for j in range(g3.shape[0]):
                if w is not None and w[j] == 0:
                    continue
                cand_groups.append([strip_caption(g3[j, k])
                                    for k in range(g3.shape[1])])
                refs_o.append([strip_caption(real_ids[j])])
        result["bleu4_oracle"] = round(oracle_bleu4(cand_groups, refs_o), 5)
    if disc_p is not None:
        result["disc_score_generated"] = round(float(np.mean(d_gen_scores)),
                                               4)
        result["disc_score_real"] = round(float(np.mean(d_real_scores)), 4)
    if args.multi_ref:
        cands, refs = rows_by_image(ds, gen_b, real_b, w_b)
        result["num_images"] = len(cands)
        result["bleu4_multiref"] = round(corpus_bleu(cands, refs), 5)
    else:
        cands, refs = rows_of(gen_b, real_b, w_b)
    if args.diversity:
        from gan_image_captioning_tpu_torch.eval.diversity import (distinct_n,
                                                                   self_bleu)

        result["self_bleu4"] = round(self_bleu(cands), 5)
        result["distinct1"] = round(distinct_n(cands, 1), 5)
        result["distinct2"] = round(distinct_n(cands, 2), 5)
    if args.cider:
        from gan_image_captioning_tpu_torch.eval.cider import cider_d

        result["cider_d"] = round(cider_d(cands, refs), 5)
    if args.rouge:
        from gan_image_captioning_tpu_torch.eval.rouge import rouge_l

        result["rouge_l"] = round(rouge_l(cands, refs), 5)
    if args.meteor:
        from gan_image_captioning_tpu_torch.eval.meteor import meteor

        result["meteor"] = round(meteor(cands, refs), 5)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
