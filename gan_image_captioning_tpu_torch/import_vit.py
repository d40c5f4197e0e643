"""Import pretrained ViT weights into the port's image encoder (the port of
``src/import_vit.py``; preset ``config5``'s encoder).

    python -m gan_image_captioning_tpu_torch.import_vit --hf-dir vit/ \\
        --base-ckpt gpt2_gen.ckpt --output vit_gpt2_gen.ckpt \\
        --preset config5 [--image-size 256]

``--hf-dir`` (``pytorch_model.bin``, read by ``torch.load``) or
``--state-dict`` as for ``import_gpt2``.  The backbone maps as
``models/torch_import.py:vit_from_torch`` says (the position rows resized
bilinearly to the ``--image-size`` grid).  Everything else (projection
head, decoder) is a fresh generator seeded by ``--seed``, or, with
``--base-ckpt``, that generator checkpoint (e.g. ``import_gpt2``'s output,
made with ``--conditional-gan 1 --encoder-arch vit``).  The output is a
conditional generator checkpoint for ``main.py --init-gen-ckpt``.
"""

from __future__ import annotations

import os

import torch

from gan_image_captioning_tpu_torch.import_gpt2 import (add_source_args,
                                                        load_state_dict)


def main(argv=None):
    from gan_image_captioning_tpu_torch.config import (build_parser,
                                                       config_from_args,
                                                       require_ported_flags)
    from gan_image_captioning_tpu_torch.models import api
    from gan_image_captioning_tpu_torch.models.torch_import import (
        vit_from_torch)
    from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib

    parser = build_parser()
    add_source_args(parser)
    parser.add_argument("--base-ckpt", type=str, default="",
                        help="a generator checkpoint to graft the ViT "
                             "backbone into (default: a fresh generator)")
    args = parser.parse_args(argv)
    sd = load_state_dict(args)
    args.conditional_gan, args.encoder_arch = 1, "vit"
    if args.base_ckpt:
        # the base checkpoint's vocabulary: its embedding rows
        obj = torch.load(args.base_ckpt, map_location="cpu",
                         weights_only=True)
        obj = obj.get("generator", obj)
        key = ("decoder.embed" if "decoder.embed" in obj
               else "decoder.embed.weight")
        args.vocab_size = int(obj[key].shape[0])
    elif args.vocab_size <= 0:
        args.vocab_size = 256   # a placeholder: --init-gen-ckpt loads shapes
    config = config_from_args(args)
    require_ported_flags(config)
    if args.base_ckpt:
        gen, _ = ckpt_lib.load_generator_checkpoint(args.base_ckpt, config)
    else:
        gen = api.init_generator(torch.Generator().manual_seed(config.seed),
                                 config)
    gen.encoder.vit.load_state_dict(
        vit_from_torch(sd, image_size=config.image_size), strict=True)
    ckpt_lib.save_generator_checkpoint(os.path.abspath(args.output), gen)
    print(args.output)
    return gen


if __name__ == "__main__":
    main()
