"""Multi-layer LSTM (``gan_image_captioning_tpu/models/lstm.py``).

Weight layout and gate order (i, f, g, o) are ``torch.nn.LSTM``'s:
``w_ih [4H, in]``, ``w_hh [4H, H]``, ``b_ih``/``b_hh [4H]``.  :class:`LSTM`
holds the parameters under ``nn.LSTM``'s names (``weight_ih_l{k}`` …), so a
reference ``state_dict`` loads into it as it is; the step functions below
are the plain math the decode uses.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn


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


def lstm_seq_tm(params: List[dict], xs_tm, state=None):
    """Teacher-forced stacked LSTM over a time-major sequence:
    ``xs_tm [T, B, in]`` → top-layer outputs ``[T, B, H]``.

    Layer by layer over the whole sequence, each step one product of
    ``[x | h]`` with the layer's fused ``[in+H, 4H]`` weight, as the JAX
    package's ``lstm_seq_tm`` computes its forward; its gradient is plain
    autograd."""
    batch = xs_tm.shape[1]
    hidden_dim = params[0]["w_hh"].shape[1]
    if state is None:
        state = zero_state(len(params), batch, hidden_dim, xs_tm.dtype,
                           xs_tm.device)
    h0, c0 = state
    x = xs_tm
    for layer, lp in enumerate(fuse_layer_params(params)):
        h, c = h0[layer], c0[layer]
        outs = []
        for x_t in x:
            h, c = lstm_cell(lp, x_t, h, c)
            outs.append(h)
        x = torch.stack(outs)
    return x
