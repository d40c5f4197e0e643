"""The port's GPT-2 byte-level BPE (``data/bpe.py``, standard library only)
against the JAX package's ``BPETokenizer`` (which needs ``regex``) on
fabricated format-identical ``vocab.json`` / ``merges.txt`` files (all 256
byte symbols and a few ranked merges, as ``tests/test_gpt2_import.py``
makes them): the pre-tokenizer's pieces against the JAX pattern's
``findall`` (letters and digits of other scripts, contractions, whitespace
runs, the byte map), ids and decodes equal on fixed and
hypothesis-drawn text; the ``--tokenizer bpe`` data path; ``caption.py``
and ``serve.py`` writing one checkpoint's captions as the same BPE text;
and ``--preset config5`` / ``--gen-arch gpt2`` parsed field by field
against the JAX ``Config``.

Hypothesis draws characters that Python's Unicode database assigns
(category not ``Cn``): the third-party ``regex`` package carries a newer
database, and the two disagree only on characters the older one leaves
unassigned."""

import json
import os

import numpy as np
import pytest
import regex
from hypothesis import given, settings
from hypothesis import strategies as st

from gan_image_captioning_tpu.config import build_parser as jbuild_parser
from gan_image_captioning_tpu.config import config_from_args as jconfig_from_args
from gan_image_captioning_tpu.data import bpe as jbpe
import torch

from gan_image_captioning_tpu_torch import caption as tcaption
from gan_image_captioning_tpu_torch import main as tmain
from gan_image_captioning_tpu_torch import serve as tserve
from gan_image_captioning_tpu_torch.config import (build_parser,
                                                   config_from_args,
                                                   require_ported_flags)
from gan_image_captioning_tpu_torch.data import bpe as tbpe
from gan_image_captioning_tpu_torch.eval.metrics import (ids_to_words,
                                                         strip_caption)
from gan_image_captioning_tpu_torch.models import api as tapi
from gan_image_captioning_tpu_torch.train.checkpoint import (
    save_generator_checkpoint)

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

MERGES = ["t h", "th e", "a n", "an d", "i n", "Ġ th", "Ġth e", "o n", "e r",
          "Ġ a", "r e", "Ġ and", "Ġ c", "Ġc a", "Ġca t"]
TEXTS = ["the man and the dog", "a cat, on the mat!", "it's the 42nd time",
         "We're HERE  now\n\tand   then", "naïve café — 東京 ٣٤ x²",
         "'s'S 'll'LL don't", "   leading and trailing   ", "a b c",
         "tabs\t\tnewline\n\n end", "", " ", "Ünïcödé ΣΑΣ ℕ 𝔘 ⅫⅦ 12,345.6",
         "\x1c\x1d sep \x1f", "emoji 🙂🙂 ok!!"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    byte_syms = list(tbpe.bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(
        byte_syms + [m.replace(" ", "") for m in MERGES])}
    vf, mf = str(d / "vocab.json"), str(d / "merges.txt")
    with open(vf, "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(mf, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    return vf, mf


@pytest.fixture(scope="module")
def tokenizers(files):
    return tbpe.BPETokenizer(*files), jbpe.BPETokenizer(*files)


def _jax_pieces(text):
    return regex.compile(jbpe._PAT).findall(text)


def test_byte_map_is_the_jax_one():
    assert tbpe.bytes_to_unicode() == jbpe.bytes_to_unicode()


@pytest.mark.parametrize("text", TEXTS)
def test_pieces_ids_and_decode_match_jax(tokenizers, text):
    ours, theirs = tokenizers
    assert tbpe.pre_tokenize(text) == _jax_pieces(text)
    ids = ours.encode(text)
    assert ids == theirs.encode(text)
    assert min(ids, default=ours.offset) >= ours.offset
    assert ours.decode(ids) == theirs.decode(ids) == text
    assert ours.vocab_size == theirs.vocab_size


_ASSIGNED = st.characters(
    blacklist_categories=("Cn", "Cs"))


@settings(max_examples=300, deadline=None)
@given(st.text(alphabet=st.one_of(
    _ASSIGNED, st.sampled_from(list(" \t\n'sStTrRvVmMlLdD0123456789"))),
    max_size=40))
def test_drawn_text_matches_jax(tokenizers, text):
    ours, theirs = tokenizers
    assert tbpe.pre_tokenize(text) == _jax_pieces(text)
    assert ours.encode(text) == theirs.encode(text)


def test_coco_captions_tokenize_through_bpe(files):
    """``--tokenizer bpe`` on ``data/mini_coco``: the vocabulary is the
    BPE's (with the 4 specials), every caption the JAX tokenizer's ids of
    its joined tokens; ``--dataset synthetic`` keeps its own vocabulary."""
    vf, mf = files
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = build_parser().parse_args(
        ["--dataset", "coco", "--data-dir", os.path.join(repo, "data",
                                                         "mini_coco"),
         "--captions-per-image", "5", "--tokenizer", "bpe", "--bpe-vocab",
         vf, "--bpe-merges", mf])
    train, val = tmain.build_datasets(args)
    theirs = jbpe.BPETokenizer(vf, mf)
    assert train.vocab_size == val.vocab_size == theirs.vocab_size
    for i in range(0, len(train), max(1, len(train) // 7)):
        rec = train.captions[i]
        np.testing.assert_array_equal(
            train.sample(i)[0], theirs.encode(" ".join(rec["tokens"])))
    args = build_parser().parse_args(["--dataset", "synthetic",
                                      "--tokenizer", "bpe"])
    syn, _ = tmain.build_datasets(args)
    assert syn.vocab_size < 64
    with pytest.raises(ValueError, match="bpe-vocab"):
        tmain.build_datasets(build_parser().parse_args(
            ["--dataset", "coco", "--tokenizer", "bpe"]))


def test_caption_and_serve_write_the_same_bpe_text(files, tmp_path):
    """``--tokenizer bpe`` on ``data/mini_coco``: ``caption.py`` and
    ``serve.py`` turn one checkpoint's greedy ids into the same text, the
    BPE's decode of the ids (not the words of COCO's word vocabulary at
    those ids)."""
    vf, mf = files
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    flags = ["--dataset", "coco", "--data-dir",
             os.path.join(repo, "data", "mini_coco"), "--captions-per-image",
             "5", "--tokenizer", "bpe", "--bpe-vocab", vf, "--bpe-merges", mf,
             "--gen-arch", "transformer", "--gen-embed-dim", "16",
             "--gen-hidden-dim", "24", "--gen-num-layers", "2",
             "--gen-num-heads", "4", "--max-seq-len", "7", "--device", "cpu"]
    args = build_parser().parse_args(flags)
    tok = tbpe.BPETokenizer(vf, mf)
    args.vocab_size = tok.vocab_size
    gen = tapi.init_generator(torch.Generator().manual_seed(5),
                              config_from_args(args))
    ckpt = str(tmp_path / "gen.ckpt")
    save_generator_checkpoint(ckpt, gen)
    out = str(tmp_path / "captions.jsonl")
    ids = tcaption.main([*flags, "--checkpoint", ckpt, "--num-samples", "2",
                         "--output", out])
    rows = [json.loads(ln) for ln in open(out)]
    service = tserve.CaptionService(tserve.parse_args(
        [*flags, "--checkpoint", ckpt]))
    try:
        served = service.handle_request({"n": 2})["captions"]
    finally:
        service.close()
    train, val = tmain.build_datasets(args)
    text = tok.decode(strip_caption(ids[0]))
    assert text and text != " ".join(ids_to_words(strip_caption(ids[0]),
                                                  train.index_to_word))
    assert [r["caption"] for r in rows] == served == [text, text]
    # the reference: the first caption's BPE ids, cut to the sequence
    # length, decoded back to a prefix of its text
    assert rows[0]["reference"] and " ".join(
        val.captions[0]["tokens"]).startswith(rows[0]["reference"])


@pytest.mark.parametrize("argv", [["--preset", "config5"],
                                  ["--gen-arch", "gpt2"],
                                  ["--preset", "config4", "--gen-arch", "gpt2",
                                   "--gen-embed-dim", "32"]])
def test_config5_and_gpt2_parse_as_jax(argv):
    """Every field the two ``Config``s share, equal (the GPT-2 expansion
    overrides width flags, as the JAX ``config_from_args`` does)."""
    config = config_from_args(build_parser().parse_args(argv))
    jconfig = jconfig_from_args(jbuild_parser().parse_args(argv))
    shared = set(config.__dataclass_fields__) & set(
        jconfig.__dataclass_fields__)
    assert {"encoder_arch", "gen_arch", "gen_embed_dim", "tokenizer",
            "dtype", "device_preprocess", "conditional_gan"} <= shared
    for k in sorted(shared):
        assert getattr(config, k) == getattr(jconfig, k), k
    require_ported_flags(config)
