"""Weight-only int8 / int4 quantization of the LSTM decode
(``gan_image_captioning_tpu/ops/quantize.py``).

Symmetric per-output-channel scales: ``x @ W ≈ (x @ Q) * s`` with ``Q``
int8 and ``s`` a ``[1, out]`` float32 row (the JAX package's shapes, so
that its quantized trees convert as they are).  Rounding is
half-to-even on both sides (``torch.round`` / ``jnp.round``), so a payload
is byte for byte the JAX package's.

int4 is always the row-packed int8 carrier (torch has no int4 compute
dtype; it is the form the JAX package's quantized serve kernel reads):
packed row ``r`` holds row ``r`` in its low nibble and row ``r + R`` in its
high nibble, ``R`` the packed row count (:func:`quantize_packed_int4`,
:func:`unpack_int4_rows`).

:func:`quantize_generator` turns a port :class:`Generator` into
``{"decoder": qdec}`` with ``qdec = {"embed": QTensor [V, E] (per-E
scales), "lstm_q": [{"w": QTensor [in+H, 4H], "b": [4H]}, …],
"linear": {"w": QTensor [H, V] (pre-transposed), "b": [V]}}`` — the layout
``eval/decode.py`` and ``kernels/decode_sample.py:decode_sample_q_serve``
read.  A transformer generator's twin is fake-quantized instead
(:func:`fake_quantize_tree`): the same module with each large weight
rounded to its intN grid, decoded in full precision.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import torch


class QTensor(NamedTuple):
    """Symmetric per-channel quantized tensor: ``q`` int8 payload,
    ``scale`` float32 broadcastable against ``q`` (size-1 axes except the
    channel axis)."""

    q: torch.Tensor
    scale: torch.Tensor


def _scale(w, channel_axis: int, qmax: int):
    axes = tuple(a for a in range(w.ndim) if a != channel_axis % w.ndim)
    amax = w.abs().amax(dim=axes, keepdim=True)
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax))


def quantize(w, channel_axis: int = -1, bits: int = 8) -> QTensor:
    """Symmetric per-channel intN: ``scale = max|w| / qmax`` along every
    axis except ``channel_axis`` (zero channels get scale 1).  ``bits`` 8
    (qmax 127) or 4 (qmax 7, unpacked: one value per int8)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qmax = (1 << (bits - 1)) - 1
    w = w.detach().to(torch.float32).contiguous()
    scale = _scale(w, channel_axis, qmax)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    return QTensor(q, scale)


def dequantize(qt: QTensor, dtype=torch.float32):
    return (qt.q.to(torch.float32) * qt.scale).to(dtype)


def pack_int4_rows(q):
    """Int4 values held in int8 ``[2r, C]`` → packed int8 ``[r, C]``: rows
    ``[0:r)`` in the low nibbles, rows ``[r:2r)`` in the high nibbles."""
    q = q.to(torch.int8)
    r = q.shape[0] // 2
    if 2 * r != q.shape[0]:
        raise ValueError(f"packed int4 needs an even row count, got "
                         f"{q.shape[0]}")
    return ((q[r:].to(torch.int16) << 4)
            | (q[:r].to(torch.int16) & 0x0F)).to(torch.int8)


def unpack_int4_rows(q):
    """Inverse of :func:`pack_int4_rows`: int8 ``[r, C]`` → int8 ``[2r, C]``
    nibble values in ``[-7, 7]`` (each nibble sign-extended)."""
    p = q.to(torch.int32)
    low = ((p & 0x0F) ^ 8) - 8
    high = p >> 4                      # arithmetic: the sign comes along
    return torch.cat([low, high]).to(torch.int8)


def quantize_packed_int4(w, channel_axis: int = -1,
                         pad_odd: bool = False) -> QTensor:
    """Symmetric per-channel int4, packed two per int8 along axis 0
    (:func:`pack_int4_rows`).  The row count must be even; ``pad_odd``
    appends one zero row first — only for a table whose rows are selected
    (the embedding: the pad row is never chosen), never for a matrix
    whose row count is a contraction dimension."""
    w = w.detach().to(torch.float32).contiguous()
    if pad_odd and w.shape[0] % 2:
        w = torch.cat([w, w.new_zeros((1,) + tuple(w.shape[1:]))])
    scale = _scale(w, channel_axis, 7)
    q = torch.clamp(torch.round(w / scale), -7, 7).to(torch.int8)
    return QTensor(pack_int4_rows(q), scale)


def payload_bits(qdec: dict) -> int:
    """4 iff the decoder's payloads are row-packed int4 carriers, else 8:
    a packed ``linear.w`` has H/2 rows."""
    h = qdec["lstm_q"][0]["w"].q.shape[1] // 4
    return 4 if qdec["linear"]["w"].q.shape[0] * 2 == h else 8


def qmatmul(x, qt: QTensor):
    """``x @ W`` with ``W`` stored ``[in, out]`` int8 and its per-column
    scales applied after the product."""
    return (x @ qt.q.to(x.dtype)) * qt.scale.reshape(1, -1).to(x.dtype)


def config_bits(config) -> int:
    """``--quantize int8|int4`` → payload bits."""
    return 4 if getattr(config, "quantize", "none") == "int4" else 8


def is_quantized(dec) -> bool:
    return isinstance(dec, dict) and "lstm_q" in dec


def quantize_lstm_decoder(decoder, bits: int = 8) -> dict:
    """A port ``Decoder`` → the quantized decoder dict (module docstring):
    the fused ``[in+H, 4H]`` gate weights, the pre-transposed ``[H, V]``
    projection and the per-E-scaled embedding, quantized once.  ``bits``
    4 packs every payload (the embedding pads an odd vocabulary with one
    zero row)."""
    from gan_image_captioning_tpu_torch.models import lstm as lstm_lib

    with torch.no_grad():
        fused = lstm_lib.fuse_layer_params(decoder.lstm.layers())
        if bits == 4:
            qfn = quantize_packed_int4

            def qembed(w):
                return quantize_packed_int4(w, pad_odd=True)
        else:
            def qfn(w):
                return quantize(w, bits=bits)
            qembed = qfn
        return {
            "embed": qembed(decoder.embed.weight),
            "lstm_q": [{"w": qfn(lp["w"]),
                        "b": lp["b"].detach().to(torch.float32).contiguous()}
                       for lp in fused],
            "linear": {"w": qfn(decoder.linear.weight.T),
                       "b": decoder.linear.bias.detach().to(
                           torch.float32).contiguous()},
        }


def fake_quantize_tree(tree, channel_axis: int = -1, min_size: int = 4096,
                       bits: int = 8):
    """Quantize then dequantize every floating leaf of ``tree`` (tensors in
    nested dicts, lists and tuples) that has two or more axes and at least
    ``min_size`` elements, back in its own dtype; the rest (biases, small
    tensors) stays as it is.  The intN storage fidelity of a decoder that
    computes in full precision (the JAX ``fake_quantize_tree``: the same
    scales and the same half-to-even rounding, so the values are the JAX
    function's bit for bit)."""
    if isinstance(tree, dict):
        return {k: fake_quantize_tree(v, channel_axis, min_size, bits)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fake_quantize_tree(v, channel_axis, min_size, bits)
                          for v in tree)
    if (isinstance(tree, torch.Tensor) and tree.is_floating_point()
            and tree.ndim >= 2 and tree.numel() >= min_size):
        return dequantize(quantize(tree, channel_axis, bits), tree.dtype)
    return tree


def quantize_generator(generator, config):
    """A port generator → its decode-quantized twin at ``--quantize``'s bits
    (int8 when unset, as for the speculative draft).

    * LSTM: ``{"decoder": qdec}`` (:func:`quantize_lstm_decoder`), read by
      the quantized stepper and serve kernel.
    * Transformer: a ``TransformerGenerator`` whose decoder is a
      fake-quantized copy (:func:`fake_quantize_tree` over its
      ``state_dict``: intN storage fidelity, full-precision compute), so it
      decodes through the normal stepper; the encoder is shared, not
      copied."""
    from gan_image_captioning_tpu_torch.models.transformer import (
        TransformerDecoder, TransformerGenerator)

    if not isinstance(generator.decoder, TransformerDecoder):
        return {"decoder": quantize_lstm_decoder(generator.decoder,
                                                 config_bits(config))}

    decoder = copy.deepcopy(generator.decoder)
    with torch.no_grad():
        decoder.load_state_dict(fake_quantize_tree(
            decoder.state_dict(), bits=config_bits(config)))
    twin = TransformerGenerator.__new__(TransformerGenerator)
    torch.nn.Module.__init__(twin)
    twin.decoder, twin.encoder = decoder, generator.encoder
    return twin


def quantized_lstm_step(qdec: dict, x, state):
    """One stacked-LSTM step against the quantized fused weights
    (``models/lstm.py:lstm_step`` with :func:`qmatmul`); ``state`` =
    ``(h, c)`` each [L, B, H]; returns ``(h_top, (h, c))``."""
    h_all, c_all = state
    new_h, new_c = [], []
    inp = x
    for layer, lq in enumerate(qdec["lstm_q"]):
        gates = qmatmul(torch.cat([inp, h_all[layer]], dim=-1),
                        lq["w"]) + lq["b"].to(x.dtype)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c_all[layer] + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        new_h.append(h_new)
        new_c.append(c_new)
        inp = h_new
    return inp, (torch.stack(new_h), torch.stack(new_c))


def quantized_embed(qdec: dict, ids):
    """Embedding rows from the int8 (unpacked) table, columns scaled."""
    qe = qdec["embed"]
    return qe.q[ids.long()].to(torch.float32) * qe.scale.reshape(1, -1)
