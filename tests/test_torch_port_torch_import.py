"""The port's GPT-2 and ViT importers (``models/torch_import.py``, without
``transformers``) against the JAX package's on fabricated HuggingFace
``state_dict``s built with numpy (``GPT2LMHeadModel`` and ``ViTModel``
key names and layouts, with entries the importers must ignore): every
entry of the imported trees equal, the ViT position rows resized 14 → 16
(and 14 → 12) within 1e-5 of ``jax.image.resize`` (whose einsum rounds
differently; the port's interpolation weights are the JAX ones, and the
port is checked against a float64 evaluation at 1e-6); and the entry
points ``import_gpt2`` / ``import_vit``: ``--state-dict`` and ``--hf-dir``
(``pytorch_model.bin``) read by ``torch.load``, a directory with only
``model.safetensors`` refused, fresh cross blocks, ``ctx_proj`` and an
encoder grafted, and checkpoints that ``load_generator_checkpoint`` (the
``--init-gen-ckpt`` path) loads into the configured model."""

import os

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.models import torch_import as jti
from gan_image_captioning_tpu_torch import import_gpt2, import_vit, interop
from gan_image_captioning_tpu_torch.config import build_parser, config_from_args
from gan_image_captioning_tpu_torch.models import torch_import as tti
from gan_image_captioning_tpu_torch.models import vit as tvit
from gan_image_captioning_tpu_torch.train import checkpoint as ckpt_lib


def _t(rng, *shape, scale=0.1):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32))


def fake_gpt2(vocab=40, d=32, layers=2, positions=16, seed=0):
    """A ``GPT2LMHeadModel.state_dict()`` in its names and layouts
    (``Conv1D`` weights ``[in, out]``), with the causal-mask buffers and
    the tied head the importer skips."""
    rng = np.random.default_rng(seed)
    sd = {"transformer.wte.weight": _t(rng, vocab, d),
          "transformer.wpe.weight": _t(rng, positions, d),
          "transformer.ln_f.weight": 1 + _t(rng, d),
          "transformer.ln_f.bias": _t(rng, d)}
    for i in range(layers):
        h = f"transformer.h.{i}."
        sd.update({h + "ln_1.weight": 1 + _t(rng, d), h + "ln_1.bias": _t(rng, d),
                   h + "attn.c_attn.weight": _t(rng, d, 3 * d),
                   h + "attn.c_attn.bias": _t(rng, 3 * d),
                   h + "attn.c_proj.weight": _t(rng, d, d),
                   h + "attn.c_proj.bias": _t(rng, d),
                   h + "attn.bias": torch.tril(torch.ones(
                       1, 1, positions, positions)),
                   h + "ln_2.weight": 1 + _t(rng, d), h + "ln_2.bias": _t(rng, d),
                   h + "mlp.c_fc.weight": _t(rng, d, 4 * d),
                   h + "mlp.c_fc.bias": _t(rng, 4 * d),
                   h + "mlp.c_proj.weight": _t(rng, 4 * d, d),
                   h + "mlp.c_proj.bias": _t(rng, d)})
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def fake_vit(d=32, layers=2, grid=14, seed=0):
    """A ``ViTModel.state_dict()`` (``nn.Linear`` weights ``[out, in]``,
    the patch convolution ``[d, 3, 16, 16]``) with its pooler, which the
    importer skips."""
    rng = np.random.default_rng(seed)
    v = "vit."
    sd = {v + "embeddings.cls_token": _t(rng, 1, 1, d),
          v + "embeddings.position_embeddings": _t(rng, 1, grid * grid + 1, d),
          v + "embeddings.patch_embeddings.projection.weight":
              _t(rng, d, 3, 16, 16),
          v + "embeddings.patch_embeddings.projection.bias": _t(rng, d),
          v + "layernorm.weight": 1 + _t(rng, d),
          v + "layernorm.bias": _t(rng, d),
          "pooler.dense.weight": _t(rng, d, d)}
    for i in range(layers):
        p = f"{v}encoder.layer.{i}."
        for name, (o, n) in {"attention.attention.query": (d, d),
                             "attention.attention.key": (d, d),
                             "attention.attention.value": (d, d),
                             "attention.output.dense": (d, d),
                             "intermediate.dense": (4 * d, d),
                             "output.dense": (d, 4 * d)}.items():
            sd[p + name + ".weight"] = _t(rng, o, n)
            sd[p + name + ".bias"] = _t(rng, o)
        for ln in ("layernorm_before", "layernorm_after"):
            sd[p + ln + ".weight"] = 1 + _t(rng, d)
            sd[p + ln + ".bias"] = _t(rng, d)
    return sd


def _same(got, want, skip=()):
    assert set(got) == set(want)
    for k in want:
        if k not in skip:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("seq_len_plus_1", [8, 20])
def test_gpt2_import_equals_jax(seq_len_plus_1):
    """wte with 4 special rows prepended (the same seeded draws), the tied
    head, ``wpe`` cut (8) or zero-padded (20) to T + 1, ``c_attn`` split by
    column, nothing transposed; with or without the ``transformer.``
    prefix."""
    sd = fake_gpt2()
    want = interop.flatten_jax(jti.gpt2_decoder_from_torch(
        sd, seq_len_plus_1, specials_seed=3))
    _same(tti.gpt2_decoder_from_torch(sd, seq_len_plus_1, specials_seed=3),
          want)
    bare = {k[len("transformer."):]: v for k, v in sd.items()
            if k.startswith("transformer.")}
    _same(tti.gpt2_decoder_from_torch(bare, seq_len_plus_1,
                                      specials_seed=3), want)


@pytest.mark.parametrize("image_size", [224, 256, 192])
def test_vit_import_equals_jax(image_size):
    """Transposed dense weights, the patch convolution in (kh, kw, c, out)
    order, CLS kept; the position rows equal at the source grid (224 / 16
    = 14) and resized on the 2-D grid to 16 × 16 (256) or 12 × 12 (192:
    shrinking, the antialiased triangle kernel)."""
    sd = fake_vit()
    jw, _ = jti.vit_from_torch(sd, image_size=image_size)
    want = interop.flatten_jax(jw)
    got = tti.vit_from_torch(sd, image_size=image_size)
    _same(got, want, skip=("pos",))
    np.testing.assert_allclose(got["pos"].numpy(), want["pos"].numpy(),
                               atol=1e-5, rtol=0)
    grid = sd["vit.embeddings.position_embeddings"][0, 1:].numpy()
    ref = _float64_resize(grid.reshape(14, 14, -1), image_size // 16)
    np.testing.assert_allclose(got["pos"][1:].numpy().reshape(ref.shape),
                               ref, atol=1e-6, rtol=0)


def _float64_resize(grid, n):
    """``jax.image.resize``'s "linear" resize evaluated in float64 from its
    definition: half-pixel centres, a triangle kernel widened by the
    shrink factor, weights normalized per output."""
    def weights(m):
        scale = n / m
        kscale = max(1.0 / scale, 1.0)
        x = (np.arange(n) + 0.5) / scale - 0.5
        w = np.maximum(0.0, 1 - np.abs(x[None, :] - np.arange(m)[:, None])
                       / kscale)
        return w / w.sum(axis=0, keepdims=True)
    w = weights(grid.shape[0])
    return np.einsum("hwd,ho,wp->opd", grid.astype(np.float64), w, w)


def test_vit_import_loads_into_the_port_vit(monkeypatch):
    """A ViT-B-wide checkpoint (two blocks here) loads into the port's
    ViT under ``load_state_dict(strict=True)``."""
    monkeypatch.setattr(tvit, "DEPTH", 2)
    vit = tvit.ViT(256)
    vit.load_state_dict(tti.vit_from_torch(fake_vit(d=768), 256),
                        strict=True)
    assert vit.pos.shape == (257, 768)


MODEL = ["--gen-arch", "transformer", "--gen-num-heads", "4",
         "--max-seq-len", "5", "--dataset", "synthetic"]


def test_import_gpt2_cli_writes_a_loadable_checkpoint(tmp_path):
    sd = fake_gpt2()
    torch.save(sd, tmp_path / "gpt2.pt")
    out = str(tmp_path / "gen.ckpt")
    import_gpt2.main(["--state-dict", str(tmp_path / "gpt2.pt"), "--output",
                      out, *MODEL])
    config = config_from_args(build_parser().parse_args(
        [*MODEL, "--gen-embed-dim", "32", "--gen-hidden-dim", "128",
         "--gen-num-layers", "2", "--vocab-size", "44"])).replace(
             vocab_size=44)
    gen, _ = ckpt_lib.load_generator_checkpoint(out, config)
    dec = gen.decoder.state_dict()
    for k, v in tti.gpt2_decoder_from_torch(sd, 8).items():
        assert torch.equal(dec[k], v), k
    # fresh cross blocks and ctx_proj, not zeros
    assert dec["blocks.0.cross.wq.w"].abs().max() > 0
    assert gen.encoder is None


def test_import_gpt2_then_vit_for_config5(tmp_path, monkeypatch):
    """config5's recipe: GPT-2 into a conditional generator on the ViT
    (``--hf-dir`` with ``pytorch_model.bin``), then the ViT grafted into
    that checkpoint (``--base-ckpt``); the decoder stays the import's."""
    monkeypatch.setattr(tvit, "DEPTH", 2)
    hf = tmp_path / "gpt2"
    hf.mkdir()
    torch.save(fake_gpt2(), hf / "pytorch_model.bin")
    cond = ["--conditional-gan", "1", "--encoder-arch", "vit",
            "--image-size", "32"]
    base = str(tmp_path / "gpt2_gen.ckpt")
    gen = import_gpt2.main(["--hf-dir", str(hf), "--output", base, *MODEL,
                            *cond])
    torch.save(fake_vit(d=768, grid=2), tmp_path / "vit.pt")
    out = str(tmp_path / "vit_gpt2_gen.ckpt")
    widths = ["--gen-embed-dim", "32", "--gen-hidden-dim", "128",
              "--gen-num-layers", "2"]
    import_vit.main(["--state-dict", str(tmp_path / "vit.pt"), "--base-ckpt",
                     base, "--output", out, *MODEL, *widths, *cond])
    config = config_from_args(build_parser().parse_args(
        [*MODEL, *cond, *widths])).replace(vocab_size=44)
    loaded, _ = ckpt_lib.load_generator_checkpoint(out, config)
    for k, v in gen.decoder.state_dict().items():
        assert torch.equal(loaded.decoder.state_dict()[k], v), k
    for k, v in tti.vit_from_torch(fake_vit(d=768, grid=2), 32).items():
        assert torch.equal(loaded.encoder.vit.state_dict()[k], v), k


def test_a_safetensors_only_directory_is_refused(tmp_path):
    (tmp_path / "model.safetensors").write_bytes(b"")
    with pytest.raises(ValueError, match="safetensors"):
        import_gpt2.main(["--hf-dir", str(tmp_path), "--output",
                          str(tmp_path / "x.ckpt"), *MODEL])
    assert not os.path.exists(tmp_path / "x.ckpt")
