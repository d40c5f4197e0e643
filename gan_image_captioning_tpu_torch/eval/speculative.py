"""Speculative greedy decoding: a cheap draft proposes, the target verifies
(``gan_image_captioning_tpu/eval/speculative.py``).

Each block of :func:`speculative_greedy`:

1. **Draft**: the draft (the int8 twin, ``ops/quantize.py``, or any
   LSTM-family decoder) proposes ``K`` tokens one step at a time from the
   last committed token, and one more.
2. **Verify**: the full-precision target runs only its LSTM recurrence
   over the ``K + 1`` inputs, then projects all ``K + 1`` hidden states in
   one ``[(K + 1)·B, H] @ [H, V]`` product (a ``torch.matmul``: the JAX
   package computes it outside any kernel too).
3. **Accept**: the longest prefix of draft tokens equal to the target's
   argmax survives; the first mismatch gives the target's own token, a
   full match a bonus one, so a block commits 1 to ``K + 1`` tokens.

The ids are the target's greedy ids for any draft: every committed token
is an argmax of target logits on the accepted prefix.  The loop is
Python, so a block costs one host read of the rows still decoding (the
JAX ``while_loop`` tests it on the device).  The steppers and the
recurrence are PyTorch, as the JAX function's are ``lax.scan`` over the
plain cell: no kernel runs here.
"""

from __future__ import annotations

import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.vocab import END
from gan_image_captioning_tpu_torch.models import lstm as lstm_lib
from gan_image_captioning_tpu_torch.models.generator import Decoder
from gan_image_captioning_tpu_torch.ops import quantize as q_lib


def check_pair(generator, draft) -> None:
    """The JAX refusals: the target a full-precision LSTM decoder, the
    draft LSTM-family (dense or quantized)."""
    from gan_image_captioning_tpu_torch.eval.decode import decoder_of

    if not isinstance(decoder_of(generator), Decoder):
        raise ValueError("speculative target must be a full-precision LSTM "
                         f"decoder (got {type(decoder_of(generator)).__name__})")
    ddec = decoder_of(draft)
    if not (isinstance(ddec, Decoder) or q_lib.is_quantized(ddec)):
        raise ValueError("speculative draft must be LSTM-family")


def select_rows(stacked, n):
    """``stacked [K + 1, L, B, H]`` → ``[L, B, H]``, row b taken at step
    ``n[b]``."""
    rows = torch.arange(stacked.shape[2], device=stacked.device)
    return stacked[n, :, rows].transpose(0, 1)


class Verifier:
    """The target's side of a block: its fused LSTM weights, embedding and
    projection; :meth:`run` takes the draft's tokens and returns the
    block."""

    def __init__(self, decoder: Decoder):
        layers = decoder.lstm.layers()
        self.fused = lstm_lib.fuse_layer_params(layers)
        self.layers, self.hidden = len(layers), layers[0]["w_hh"].shape[1]
        self.embed = decoder.embed.weight
        self.w, self.b = decoder.linear.weight, decoder.linear.bias

    def run(self, S, x0, d_toks):
        """The recurrence from ``S`` over ``[x0, embed(d_1 .. d_K)]``, one
        projection of the ``K + 1`` hidden states, and the accepted prefix
        → ``(block [K + 1, B], logp [K + 1, B, V], n [B], states
        (h, c) each [K + 1, L, B, H])``."""
        K = d_toks.shape[0] - 1
        xs = torch.cat([x0[None], self.embed[d_toks[:K].long()]], dim=0)
        hs, hh, cc = [], [], []
        for x in xs:
            h_top, S = lstm_lib.lstm_step(self.fused, x, S)
            hs.append(h_top)
            hh.append(S[0])
            cc.append(S[1])
        logits = torch.stack(hs) @ self.w.T + self.b           # [K+1, B, V]
        p = torch.argmax(logits, dim=-1)
        acc = torch.cumprod((d_toks[:K] == p[:K]).to(torch.int32), dim=0)
        n = acc.sum(dim=0)                                      # [B] in 0..K
        jidx = torch.arange(K + 1, device=n.device)[:, None]
        block = torch.where(jidx < n[None], d_toks, p)
        return (block, torch.log_softmax(logits, dim=-1), n,
                (torch.stack(hh), torch.stack(cc)))


def draft_block(draft, D, x, K: int):
    """``K + 1`` greedy draft steps from the input ``x`` → ``(tokens
    [K + 1, B], states (h, c) each [K + 1, L, B, H])``; state j is the one
    after consuming the input and the first j tokens."""
    toks, hh, cc = [], [], []
    for _ in range(K + 1):
        logits, D = draft.step(D, x, 0)
        nxt = torch.argmax(logits, dim=-1)
        toks.append(nxt)
        hh.append(D[0])
        cc.append(D[1])
        x = draft.embed(nxt)
    return torch.stack(toks), (torch.stack(hh), torch.stack(cc))


@torch.no_grad()
def speculative_greedy(generator, draft, features, config: Config,
                       seq_len: int = None, draft_len: int = 4,
                       early_stop: bool = False, return_stats: bool = False):
    """Greedy ids ``[B, T]`` int32, equal to the target's greedy decode,
    made draft-first.

    ``generator``: the target, a port ``Generator`` (LSTM).  ``draft``: a
    port ``Generator`` or a quantized twin (``{"decoder": qdec}``).
    ``draft_len``: K, the tokens proposed a block.  ``early_stop``: stop
    once every row has committed an ``<E>``; the caption through it is
    unchanged and the positions past the ending block are ``<PAD>``.
    ``return_stats``: also ``{"accepted", "proposed"}``, draft tokens
    accepted and proposed over the rows still decoding."""
    from gan_image_captioning_tpu_torch.eval.decode import make_stepper

    check_pair(generator, draft)
    T = seq_len or config.seq_len
    K = int(draft_len)
    if K < 1:
        raise ValueError("draft_len must be >= 1")
    target = Verifier(generator.decoder)
    dstep = make_stepper(draft, config)
    B, device = features.shape[0], features.device
    Tbuf = T + K + 1           # writes past T land in a junk region
    rows = torch.arange(B, device=device)[:, None]
    jidx = torch.arange(K + 1, device=device)

    # token 0: no speculation (both models consume the features)
    S = lstm_lib.zero_state(target.layers, B, target.hidden, features.dtype,
                            device)
    h0, S = lstm_lib.lstm_step(target.fused, features, S)
    y = torch.argmax(h0 @ target.w.T + target.b, dim=-1)
    D = dstep.step(dstep.init_state(B), features, 0)[1]
    buf = torch.zeros((B, Tbuf), dtype=torch.int32, device=device)
    buf[:, 0] = y
    pos = torch.ones(B, dtype=torch.long, device=device)
    ended = y == END
    stats = torch.zeros(2, dtype=torch.long, device=device)
    while True:
        live_rows = pos < T
        if early_stop:
            live_rows &= ~ended
        if not bool(live_rows.any()):   # the one host read of the block
            break
        d_toks, d_states = draft_block(dstep, D, dstep.embed(y), K)
        block, _, n, t_states = target.run(S, target.embed[y], d_toks)
        valid = jidx[:, None] <= n[None]                      # [K+1, B]
        S = tuple(select_rows(s, n) for s in t_states)
        D = tuple(select_rows(s, n) for s in d_states)
        y = block.gather(0, n[None])[0]
        positions = pos[:, None] + jidx[None, :]               # [B, K+1]
        if early_stop:
            live = valid.T & ~ended[:, None]
            pos2 = torch.where(ended, pos, torch.clamp(pos + n + 1, max=T))
        else:
            live = valid.T
            pos2 = torch.clamp(pos + n + 1, max=T)
        wpos = torch.where(live, torch.clamp(positions, max=Tbuf - 2),
                           Tbuf - 1)
        buf[rows, wpos] = block.T.to(torch.int32)
        ended = ended | (valid.T & (block.T == END)).any(dim=1)
        stats += torch.stack([torch.where(live_rows, n, 0).sum(),
                              K * live_rows.sum()])
        pos = pos2
    if return_stats:
        acc, prop = stats.tolist()
        return buf[:, :T], {"accepted": acc, "proposed": prop}
    return buf[:, :T]
