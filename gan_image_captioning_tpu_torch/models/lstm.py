"""Multi-layer LSTM (``gan_image_captioning_tpu/models/lstm.py``).

Weight layout and gate order (i, f, g, o) are ``torch.nn.LSTM``'s:
``w_ih [4H, in]``, ``w_hh [4H, H]``, ``b_ih``/``b_hh [4H]``.  :class:`LSTM`
holds the parameters under ``nn.LSTM``'s names (``weight_ih_l{k}`` …), so a
reference ``state_dict`` loads into it as it is; the step functions below
are the plain math the decode uses.  :func:`lstm_seq_tm`, the
teacher-forced pass, has the JAX package's deferred-gradient backward
(:class:`_LayerSeq`) through the reverse BPTT kernel; so does each
direction of :func:`bilstm_forward`.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn

from gan_image_captioning_tpu_torch.kernels.lstm_bptt import (
    lstm_bptt_reverse, lstm_bptt_reverse_plain)


class LSTM(nn.Module):
    """Parameter container of a stacked LSTM with ``nn.LSTM``'s names."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int,
                 device="cpu", dtype=torch.float32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        for k in range(num_layers):
            in_dim = input_dim if k == 0 else hidden_dim
            kw = dict(device=device, dtype=dtype)
            self.register_parameter(f"weight_ih_l{k}", nn.Parameter(
                torch.empty(4 * hidden_dim, in_dim, **kw)))
            self.register_parameter(f"weight_hh_l{k}", nn.Parameter(
                torch.empty(4 * hidden_dim, hidden_dim, **kw)))
            self.register_parameter(f"bias_ih_l{k}", nn.Parameter(
                torch.empty(4 * hidden_dim, **kw)))
            self.register_parameter(f"bias_hh_l{k}", nn.Parameter(
                torch.empty(4 * hidden_dim, **kw)))

    def layers(self) -> List[dict]:
        """Per-layer ``{w_ih, w_hh, b_ih, b_hh}`` — the JAX package's
        param-list form, which the step functions and the kernel take."""
        return [{"w_ih": getattr(self, f"weight_ih_l{k}"),
                 "w_hh": getattr(self, f"weight_hh_l{k}"),
                 "b_ih": getattr(self, f"bias_ih_l{k}"),
                 "b_hh": getattr(self, f"bias_hh_l{k}")}
                for k in range(self.num_layers)]


@torch.no_grad()
def init_lstm_params(generator: torch.Generator, lstm: LSTM) -> LSTM:
    """Torch-default initialization: U(-k, k) with k = 1/sqrt(hidden_dim)."""
    k = 1.0 / math.sqrt(lstm.hidden_dim)
    for layer in lstm.layers():
        for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
            p = layer[name]
            p.copy_(torch.empty(p.shape, dtype=p.dtype).uniform_(
                -k, k, generator=generator))
    return lstm


def fuse_layer_params(params: List[dict]) -> List[dict]:
    """Fuse each layer's input and recurrent weights into one
    ``[in+H, 4H]`` matrix and one bias, once per call."""
    return [{"w": torch.cat([lp["w_ih"], lp["w_hh"]], dim=1).T,
             "b": lp["b_ih"] + lp["b_hh"]} for lp in params]


def lstm_cell(layer_params: dict, x, h, c):
    """One LSTM cell step.  ``x``: [B, in], ``h``/``c``: [B, H].  Accepts
    raw (``w_ih`` …) or fused (``w``, ``b``) layer params."""
    if "w" in layer_params:
        gates = torch.cat([x, h], dim=-1) @ layer_params["w"] + layer_params["b"]
    else:
        gates = (x @ layer_params["w_ih"].T + layer_params["b_ih"]
                 + h @ layer_params["w_hh"].T + layer_params["b_hh"])
    i, f, g, o = gates.chunk(4, dim=-1)  # torch gate order
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_step(params: List[dict], x, state: Tuple[torch.Tensor, torch.Tensor]):
    """Advance the stack one timestep: ``state`` = ``(h, c)`` each
    [num_layers, B, H]; returns ``(h_top [B, H], (h, c))``."""
    h_all, c_all = state
    new_h, new_c = [], []
    inp = x
    for layer, lp in enumerate(params):
        h_new, c_new = lstm_cell(lp, inp, h_all[layer], c_all[layer])
        new_h.append(h_new)
        new_c.append(c_new)
        inp = h_new
    return inp, (torch.stack(new_h), torch.stack(new_c))


def zero_state(num_layers: int, batch: int, hidden_dim: int,
               dtype=torch.float32, device=None):
    """Zero ``(h, c)``, torch's default when no state is given."""
    shape = (num_layers, batch, hidden_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _layer_seq_scan(w_fused, b_fused, xs, h0, c0):
    """One layer over the time-major ``xs [T, B, in]`` → ``(hs, cs,
    gates)``: each step one product of ``[x | h]`` with the fused
    ``[in+H, 4H]`` weight (:func:`lstm_cell`'s arithmetic)."""
    h, c = h0, c0
    hs, cs, gates = [], [], []
    for x_t in xs:
        g = torch.cat([x_t, h], dim=-1) @ w_fused + b_fused
        i, f, gg, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
        gates.append(g)
    return torch.stack(hs), torch.stack(cs), torch.stack(gates)


class _LayerSeq(torch.autograd.Function):
    """One teacher-forced layer, ``xs [T, B, in]`` → ``hs [T, B, H]``, with
    the JAX package's deferred-gradient backward (``_layer_seq``): the
    reverse recurrence carries only ``(dh, dc)`` and emits the gate
    gradients ``d_pre`` (:func:`lstm_bptt_reverse`: the CUDA kernel on CUDA
    tensors, unless ``plain``), then every weight and input gradient is one
    product over the stacked sequence."""

    @staticmethod
    def forward(ctx, w_fused, b_fused, xs, h0, c0, plain):
        hs, cs, gates = _layer_seq_scan(w_fused, b_fused, xs, h0, c0)
        ctx.save_for_backward(w_fused, xs, h0, c0, hs, cs, gates)
        ctx.plain = plain
        return hs

    @staticmethod
    def backward(ctx, d_hs):
        w_fused, xs, h0, c0, hs, cs, gates = ctx.saved_tensors
        in_dim = xs.shape[-1]
        h_prev = torch.cat([h0[None], hs[:-1]])
        c_prev = torch.cat([c0[None], cs[:-1]])
        reverse = lstm_bptt_reverse_plain if ctx.plain else lstm_bptt_reverse
        d_pre, dh0, dc0 = reverse(w_fused[in_dim:].contiguous(),
                                  d_hs.contiguous(), gates, c_prev, cs)
        T, B = d_pre.shape[:2]
        d2 = d_pre.reshape(T * B, -1)   # float32
        # bfloat16 (--dtype bfloat16): the products in float32, as the JAX
        # backward promotes them; autograd rounds each gradient to its
        # input's dtype
        xh = torch.cat([xs, h_prev], dim=-1).reshape(T * B, -1).to(d2.dtype)
        dw = xh.T @ d2                  # one [in+H, 4H] product
        db = d2.sum(dim=0)
        dxs = (d2 @ w_fused[:in_dim].T.to(d2.dtype)).reshape(xs.shape)
        return dw, db, dxs, dh0, dc0, None


def lstm_seq_tm(params: List[dict], xs_tm, state=None, plain: bool = False):
    """Teacher-forced stacked LSTM over a time-major sequence:
    ``xs_tm [T, B, in]`` → top-layer outputs ``[T, B, H]``, in the dtype
    of the weights and inputs (bfloat16 under ``--dtype bfloat16``: each
    operation of the forward rounds to bfloat16, the backward's reverse
    kernel reads the bfloat16 residuals as float32).

    Layer by layer over the whole sequence (:class:`_LayerSeq`), as the
    JAX package's ``lstm_seq_tm``; each layer's backward runs the reverse
    BPTT kernel on CUDA tensors, its plain version on CPU ones or with
    ``plain``.  Gradients reach the torch-layout parameters through the
    concatenation that fuses them."""
    batch = xs_tm.shape[1]
    hidden_dim = params[0]["w_hh"].shape[1]
    if state is None:
        state = zero_state(len(params), batch, hidden_dim, xs_tm.dtype,
                           xs_tm.device)
    h0, c0 = state
    x = xs_tm
    for layer, lp in enumerate(fuse_layer_params(params)):
        x = _LayerSeq.apply(lp["w"], lp["b"], x, h0[layer], c0[layer], plain)
    return x


def bilstm_forward(fwd_params: List[dict], bwd_params: List[dict], xs,
                   plain: bool = False):
    """Bidirectional stacked LSTM over a batch-major sequence ``xs [B, T,
    in]`` → ``[B, T, 2H]``, the forward stack's outputs then the backward
    stack's (run over the time-reversed sequence, flipped back), the JAX
    ``bilstm_forward``.  Each direction is one :func:`lstm_seq_tm`, so its
    backward runs the reverse BPTT kernel on CUDA tensors (unless
    ``plain``)."""
    xs_tm = xs.transpose(0, 1)
    fwd = lstm_seq_tm(fwd_params, xs_tm, plain=plain)
    bwd = lstm_seq_tm(bwd_params, xs_tm.flip(0), plain=plain).flip(0)
    return torch.cat([fwd, bwd], dim=-1).transpose(0, 1)
