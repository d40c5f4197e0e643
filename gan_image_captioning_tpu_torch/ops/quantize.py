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
read.
"""

from __future__ import annotations

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


def quantize_generator(generator, config) -> dict:
    """A port ``Generator`` → ``{"decoder": qdec}`` at ``--quantize``'s
    bits.  LSTM only: the JAX package's transformer branch (fake
    quantization) belongs to the transformer family, which is not
    ported."""
    if getattr(config, "gen_arch", "lstm") != "lstm":
        raise NotImplementedError(
            f"--quantize with --gen-arch {config.gen_arch}: only the LSTM "
            "decoder is ported")
    return {"decoder": quantize_lstm_decoder(generator.decoder,
                                             config_bits(config))}


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
