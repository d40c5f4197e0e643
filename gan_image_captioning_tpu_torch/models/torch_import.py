"""Pretrained GPT-2 and ViT weights from HuggingFace-format ``state_dict``s
(``gan_image_captioning_tpu/models/torch_import.py:gpt2_decoder_from_torch``
and ``vit_from_torch``), without the ``transformers`` package: the input is
the plain ``{name: tensor}`` dict that ``torch.load`` reads from a
``pytorch_model.bin``.  Each returns ``{name: tensor}`` under the port's
module names (the JAX tree paths), ready for ``load_state_dict`` of the
transformer decoder or of the ViT backbone.

GPT-2 (``GPT2LMHeadModel``): the ``Conv1D`` weights are ``[in, out]``, the
port's dense layout, so nothing is transposed; ``c_attn [d, 3d]`` splits
into q, k, v by column; 4 rows for ``<PAD> <S> <E> <UNK>`` drawn N(0,
0.02²) from ``numpy.random.RandomState(specials_seed)`` are prepended to
``wte`` (the BPE ids are offset by 4, ``data/bpe.py``); the head is tied
(``linear.w`` = the same matrix, ``linear.b`` zero); ``wpe`` fills the
first ``T + 1`` positions (zero rows past GPT-2's own).  The cross
blocks, their layer norms and ``ctx_proj`` have no GPT-2 counterpart and
are not returned.

ViT (``ViTModel``): ``nn.Linear`` weights ``[out, in]`` are transposed;
the patch convolution ``[d, 3, 16, 16]`` is permuted to (kh, kw, c, out),
the order ``vit._patchify`` flattens patches in; the position rows of the
patch grid are resized bilinearly on the 2-D grid when the image size
gives another grid (:func:`resize_linear`, ``jax.image.resize``'s
``"linear"`` method: half-pixel centres, and a triangle kernel widened by
the scale when shrinking, its antialiasing), the CLS row kept.  HF's ViT
uses the exact (erf) GELU, the block stack the tanh approximation, as in
the JAX package.

Both accept keys with or without their model prefix (``transformer.``,
``vit.``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _a(v) -> np.ndarray:
    """A tensor or array leaf → numpy (float32 for a bfloat16 tensor)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def _strip(sd: Dict, prefix: str) -> Dict:
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}
    return sd


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def gpt2_decoder_from_torch(sd: Dict, seq_len_plus_1: int,
                            num_specials: int = 4,
                            specials_seed: int = 0) -> Dict[str, torch.Tensor]:
    """An HF GPT-2 ``state_dict`` → the transformer decoder's entries
    (``embed``, ``pos``, ``blocks.{i}.{ln1, attn, ln2, mlp}.*``, ``ln_f``,
    ``linear``)."""
    sd = _strip(sd, "transformer.")
    wte = _a(sd["wte.weight"])
    d = wte.shape[1]
    rng = np.random.RandomState(specials_seed)
    specials = (rng.standard_normal((num_specials, d)) * 0.02).astype(
        wte.dtype)
    wte_x = np.concatenate([specials, wte], axis=0)
    wpe = _a(sd["wpe.weight"])
    rows = min(seq_len_plus_1, wpe.shape[0])
    pos = np.zeros((seq_len_plus_1, d), wpe.dtype)
    pos[:rows] = wpe[:rows]
    out = {"embed": _t(wte_x), "pos": _t(pos), "linear.w": _t(wte_x.copy()),
           "linear.b": _t(np.zeros((wte_x.shape[0],), wte_x.dtype))}

    def copy(dst: str, src: str, names=("w", "b")):
        out[f"{dst}.{names[0]}"] = _t(_a(sd[src + ".weight"]))
        out[f"{dst}.{names[1]}"] = _t(_a(sd[src + ".bias"]))

    ln = ("scale", "bias")

    i = 0
    while f"h.{i}.ln_1.weight" in sd:
        src, dst = f"h.{i}", f"blocks.{i}"
        copy(dst + ".ln1", src + ".ln_1", ln)
        copy(dst + ".ln2", src + ".ln_2", ln)
        w, b = _a(sd[src + ".attn.c_attn.weight"]), _a(
            sd[src + ".attn.c_attn.bias"])
        for j, name in enumerate(("wq", "wk", "wv")):
            out[f"{dst}.attn.{name}.w"] = _t(w[:, j * d:(j + 1) * d])
            out[f"{dst}.attn.{name}.b"] = _t(b[j * d:(j + 1) * d])
        copy(dst + ".attn.wo", src + ".attn.c_proj")
        copy(dst + ".mlp.fc1", src + ".mlp.c_fc")
        copy(dst + ".mlp.fc2", src + ".mlp.c_proj")
        i += 1
    copy("ln_f", "ln_f", ln)
    return out


def _linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """``[in, out]`` weights of ``jax.image.resize(..., "linear")`` along
    one axis (``jax.image._scale_and_translate``'s weight matrix with
    antialiasing, in float32)."""
    scale = np.float32(out_size / in_size)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]
               ) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_linear(grid: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``[h, w, d]`` → ``[out_h, out_w, d]``, bilinear as
    ``jax.image.resize(grid, (out_h, out_w, d), "linear")``."""
    grid = grid.astype(np.float32)
    if grid.shape[0] != out_h:
        grid = np.einsum("hwd,ho->owd", grid,
                         _linear_weights(grid.shape[0], out_h))
    if grid.shape[1] != out_w:
        grid = np.einsum("hwd,wo->hod", grid,
                         _linear_weights(grid.shape[1], out_w))
    return grid


def vit_from_torch(sd: Dict, image_size: int = 224
                   ) -> Dict[str, torch.Tensor]:
    """An HF ``ViTModel`` ``state_dict`` → the ViT backbone's entries
    (``patch_embed``, ``cls``, ``pos``, ``blocks.{i}.*``, ``ln_f``)."""
    sd = _strip(sd, "vit.")
    cls = _a(sd["embeddings.cls_token"])                       # [1, 1, d]
    d = cls.shape[-1]
    pw = _a(sd["embeddings.patch_embeddings.projection.weight"])
    patch = pw.shape[-1]
    out = {"patch_embed.w": _t(np.transpose(pw, (2, 3, 1, 0)).reshape(-1, d)),
           "patch_embed.b": _t(_a(
               sd["embeddings.patch_embeddings.projection.bias"])),
           "cls": _t(cls)}
    pos = _a(sd["embeddings.position_embeddings"])[0]          # [P + 1, d]
    src = int(round((pos.shape[0] - 1) ** 0.5))
    dst = image_size // patch
    if dst != src:
        grid = resize_linear(pos[1:].reshape(src, src, d), dst, dst)
        pos = np.concatenate([pos[:1], grid.reshape(dst * dst, d)
                              .astype(pos.dtype)], axis=0)
    out["pos"] = _t(pos)

    def lin(dst_name: str, src_name: str):
        out[dst_name + ".w"] = _t(_a(sd[src_name + ".weight"]).T)
        out[dst_name + ".b"] = _t(_a(sd[src_name + ".bias"]))

    def ln(dst_name: str, src_name: str):
        out[dst_name + ".scale"] = _t(_a(sd[src_name + ".weight"]))
        out[dst_name + ".bias"] = _t(_a(sd[src_name + ".bias"]))

    i = 0
    while f"encoder.layer.{i}.layernorm_before.weight" in sd:
        src, dst_b = f"encoder.layer.{i}", f"blocks.{i}"
        ln(dst_b + ".ln1", src + ".layernorm_before")
        lin(dst_b + ".attn.wq", src + ".attention.attention.query")
        lin(dst_b + ".attn.wk", src + ".attention.attention.key")
        lin(dst_b + ".attn.wv", src + ".attention.attention.value")
        lin(dst_b + ".attn.wo", src + ".attention.output.dense")
        ln(dst_b + ".ln2", src + ".layernorm_after")
        lin(dst_b + ".mlp.fc1", src + ".intermediate.dense")
        lin(dst_b + ".mlp.fc2", src + ".output.dense")
        i += 1
    ln("ln_f", "layernorm")
    return out
