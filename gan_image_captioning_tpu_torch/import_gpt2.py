"""Import pretrained GPT-2 weights into the port's transformer generator
(the port of ``src/import_gpt2.py``; preset ``config5``'s generator).

    python -m gan_image_captioning_tpu_torch.import_gpt2 --hf-dir gpt2/ \\
        --output gpt2_gen.ckpt [--max-seq-len 34] [--conditional-gan 1 \\
        --encoder-arch vit]

``--hf-dir`` is a local HuggingFace checkpoint directory holding
``pytorch_model.bin`` (read by ``torch.load``; the ``transformers`` package
is not needed); ``--state-dict`` names such a file directly.  A directory
with only ``model.safetensors`` is refused: convert it to a
``pytorch_model.bin`` first.  The weights map as
``models/torch_import.py:gpt2_decoder_from_torch`` says (4 special rows
prepended, tied head, ``wpe`` cut to ``T + 1``).  The cross-attention
blocks and ``ctx_proj`` (and the image encoder under ``--conditional-gan
1``) come from a fresh generator seeded by ``--seed``: GPT-2 has none.
The output is a generator checkpoint (the plain reference form) that
``main.py --init-gen-ckpt`` loads with the same model flags:

    python -m gan_image_captioning_tpu_torch.main --gen-arch gpt2 \\
        --tokenizer bpe --bpe-vocab gpt2/vocab.json \\
        --bpe-merges gpt2/merges.txt --init-gen-ckpt gpt2_gen.ckpt …
"""

from __future__ import annotations

import os

import torch


def add_source_args(parser):
    parser.add_argument("--hf-dir", type=str, default="",
                        help="local HuggingFace checkpoint directory "
                             "(pytorch_model.bin)")
    parser.add_argument("--state-dict", type=str, default="",
                        help="a torch state_dict file (alternative)")
    parser.add_argument("--output", type=str, required=True)


def load_state_dict(args) -> dict:
    """``--state-dict``, or ``pytorch_model.bin`` under ``--hf-dir``, read
    by ``torch.load`` onto the CPU."""
    path = args.state_dict
    if not path:
        if not args.hf_dir:
            raise SystemExit("--hf-dir or --state-dict is required")
        path = os.path.join(args.hf_dir, "pytorch_model.bin")
        if not os.path.exists(path):
            if os.path.exists(os.path.join(args.hf_dir, "model.safetensors")):
                raise ValueError(
                    f"{args.hf_dir} holds model.safetensors only: this "
                    "importer reads pytorch_model.bin with torch.load and "
                    "does not depend on the safetensors package; save the "
                    "state_dict with torch.save and pass --state-dict")
            raise FileNotFoundError(f"no pytorch_model.bin in {args.hf_dir}")
    return torch.load(path, map_location="cpu", weights_only=True)


def main(argv=None):
    from gan_image_captioning_tpu_torch.config import (build_parser,
                                                       config_from_args,
                                                       require_ported_flags)
    from gan_image_captioning_tpu_torch.models import api
    from gan_image_captioning_tpu_torch.models.torch_import import (
        gpt2_decoder_from_torch)
    from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib

    parser = build_parser()
    add_source_args(parser)
    args = parser.parse_args(argv)
    dec = gpt2_decoder_from_torch(load_state_dict(args),
                                  seq_len_plus_1=args.max_seq_len + 3)
    args.vocab_size, d = dec["embed"].shape
    if args.gen_arch == "lstm":
        args.gen_arch = "gpt2"          # the GPT-2 geometry by default
    n_layers = 0
    while f"blocks.{n_layers}.ln1.scale" in dec:
        n_layers += 1
    config = config_from_args(args).replace(
        gen_arch="transformer", gen_embed_dim=d, gen_num_layers=n_layers,
        gen_hidden_dim=int(dec["blocks.0.mlp.fc1.w"].shape[1]))
    require_ported_flags(config)
    gen = api.init_generator(torch.Generator().manual_seed(config.seed),
                             config)
    sd = gen.decoder.state_dict()
    missing = set(dec) - set(sd)
    if missing:
        raise ValueError(f"GPT-2 entries without a place in the decoder: "
                         f"{sorted(missing)[:5]}")
    sd.update(dec)
    gen.decoder.load_state_dict(sd, strict=True)
    ckpt_lib.save_generator_checkpoint(os.path.abspath(args.output), gen)
    print(f"imported GPT-2 ({n_layers} layers, d={d}, vocab="
          f"{args.vocab_size} with the 4 specials) -> {args.output}")
    return gen


if __name__ == "__main__":
    main()
