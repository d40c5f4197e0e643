#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives ``gan_image_captioning_tpu_torch`` at the full serving width of
preset config3 with the bench's vocabulary (2-layer LSTM, E = H = 512,
V = 11008, T = 36, float32) and prints one JSON line per phase:

1. ``device``  — the card (``nvidia-smi`` name and power limit).
2. ``build``   — every kernel built from ``kernels/csrc`` with nvcc
   (sm_90a), with ptxas's register and shared-memory report.
3. ``kernel``  — the decode kernel against its plain PyTorch version at
   B = 1, 8, 64 on the same inputs: ids equal (where a row differs, each
   kernel id must lie within 1e-4 of the plain max logit when the plain
   version is teacher-forced on the kernel's ids), per-token logprobs
   within 1e-4 and sequence sums within 1e-3 (float32 sums run in another
   order).
4. ``service`` — the serve entry point's request loop
   (``serve.main``) on a seeded checkpoint written in the reference
   layout: ``{"n": 1}``, ``{"n": 8}``, ``{"n": 20}``, ``{"stats": true}``.
   Captions must match the plain decode, logprobs must be finite, and the
   kernel's launch count must equal the service's ``device_calls``.
5. ``timing``  — kernel and plain times (CUDA events) at B = 8 and 64,
   the host time of one kernel call, the service's request latency, and
   the least time the card could take.
6. ``profile`` — device time per CUDA kernel (torch.profiler) and the
   device's busy share over a few decode calls at B = 8 and 64.

Then the ``kernels`` line and, last, ``{"ok": true, "device": …}``.  Any
failed phase raises, so the script exits non-zero; without CUDA it exits
non-zero before printing a result.  The plain version's matrix products
run in full float32: TF32 is switched off below.
"""

import contextlib
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
V, E, H, NL, MAX_SEQ_LEN = 11008, 512, 512, 2, 34
T = MAX_SEQ_LEN + 2
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOP_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
LP_ATOL, SEQ_ATOL, ID_ATOL = 1e-4, 1e-3, 1e-4
TPU_KERNEL = "gan_image_captioning_tpu/kernels/decode_sample.py:121"
MODEL_FLAGS = ["--dataset", "synthetic", "--vocab-multiple", str(V),
               "--gen-embed-dim", str(E), "--gen-hidden-dim", str(H),
               "--gen-num-layers", str(NL), "--max-seq-len", str(MAX_SEQ_LEN)]


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of ``fn`` per call (CUDA events over ``reps``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def decode_work(B):
    """Bytes the decode must move (each input read once, each output
    written once) and its float operations, at batch B."""
    layer_w = sum(4 * H * ((E if l == 0 else H) + H) + 2 * 4 * H
                  for l in range(NL))
    weights = layer_w + V * H + V
    inputs = 4 * (weights + B * E + B * T * E)   # + embedding rows gathered
    outputs = 4 * B * T * 2                      # ids int32, lps float32
    matmul = 2 * B * T * (sum(4 * H * ((E if l == 0 else H) + H)
                              for l in range(NL)) + V * H)
    return inputs + outputs, matmul


def bound_ms(B):
    nbytes, flops = decode_work(B)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def teacher_forced_logits(dec, feats, ids):
    """Plain logits [B, T, V] with the input at step t+1 = embed[ids[:, t]]."""
    from gan_image_captioning_tpu_torch.models import lstm

    fused = lstm.fuse_layer_params(dec.lstm.layers())
    state = lstm.zero_state(NL, feats.shape[0], H, feats.dtype, feats.device)
    x, out = feats, []
    for t in range(ids.shape[1]):
        h_top, state = lstm.lstm_step(fused, x, state)
        out.append(h_top @ dec.linear.weight.T + dec.linear.bias)
        x = dec.embed.weight[ids[:, t].long()]
    return torch.stack(out, dim=1)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build():
    from gan_image_captioning_tpu_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build(["decode_serve"])
    ptxas = [ln.strip() for log in build.BUILD_LOGS.values()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": [str(p.relative_to(ROOT)) for p in libs.values()],
          "ptxas": ptxas})


def full_width_generator(device):
    from gan_image_captioning_tpu_torch.config import Config
    from gan_image_captioning_tpu_torch.models.generator import (
        init_generator_params)

    config = Config(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                    gen_num_layers=NL, max_seq_len=MAX_SEQ_LEN)
    # un-swept initial weights: the sweep's U(-0.05, 0.05) makes greedy
    # decode repeat one token, which would check almost nothing
    gen = init_generator_params(torch.Generator().manual_seed(0), config,
                                device, sweep=False)
    return gen.requires_grad_(False)


def decode_args(dec, feats):
    return (feats, dec.lstm.layers(), dec.linear.weight, dec.linear.bias,
            dec.embed.weight, T)


def phase_kernel(dec, device):
    from gan_image_captioning_tpu_torch.eval.decode import masked_logprob_sum
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample, decode_sample_plain)

    rows = []
    for B in (1, 8, 64):
        feats = torch.from_numpy(np.random.default_rng(B).standard_normal(
            (B, E)).astype(np.float32)).to(device)
        ids_k, lps_k = decode_sample(*decode_args(dec, feats), mode="serve")
        ids_g = decode_sample(*decode_args(dec, feats), mode="greedy")
        torch.cuda.synchronize()
        ids_p, _ = decode_sample_plain(*decode_args(dec, feats))
        ids_equal = bool(torch.equal(ids_k, ids_p))
        # the plain version teacher-forced on the kernel's ids: equal to
        # the free-running one where the ids agree
        logits = teacher_forced_logits(dec, feats, ids_k)
        chosen = logits.gather(2, ids_k.long()[..., None])[..., 0]
        id_gap = float((logits.max(dim=2).values - chosen).max())
        lps_p = chosen - torch.logsumexp(logits, dim=2)
        lp_diff = float((lps_k - lps_p).abs().max())
        seq_diff = float((masked_logprob_sum(ids_k, lps_k)
                          - masked_logprob_sum(ids_k, lps_p)).abs().max())
        row = {"B": B, "ids_equal": ids_equal,
               "rows_differing": int((ids_k != ids_p).any(dim=1).sum()),
               "distinct_ids": int(ids_k.unique().numel()),
               "greedy_mode_equal": bool(torch.equal(ids_g, ids_k)),
               "max_id_gap": id_gap, "max_abs_lp_diff": lp_diff,
               "max_abs_seq_diff": seq_diff,
               "lps_finite": bool(torch.isfinite(lps_k).all())}
        rows.append(row)
        emit({"phase": "kernel", **row})
        check(row["greedy_mode_equal"], f"B={B}: greedy mode ids != serve ids")
        check(row["lps_finite"], f"B={B}: non-finite kernel logprobs")
        check(id_gap <= ID_ATOL, f"B={B}: kernel id {id_gap} below the max")
        check(lp_diff <= LP_ATOL, f"B={B}: per-token lp diff {lp_diff}")
        check(seq_diff <= SEQ_ATOL, f"B={B}: sequence lp diff {seq_diff}")
    return rows


def phase_service(gen, workdir):
    """The serving entry point's stdin request loop, in this process so
    the kernel's launch count can be read."""
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.data.synthetic import synthetic_vocab
    from gan_image_captioning_tpu_torch.eval.decode import masked_logprob_sum
    from gan_image_captioning_tpu_torch.eval.metrics import (ids_to_words,
                                                             strip_caption)
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample, decode_sample_plain)
    from gan_image_captioning_tpu_torch.models.generator import (
        start_token_features)
    from gan_image_captioning_tpu_torch.train.checkpoint import (
        save_generator_checkpoint)

    ckpt = workdir / "gen_full_width.ckpt"
    save_generator_checkpoint(str(ckpt), gen)
    reqs = [{"n": 1}, {"n": 8}, {"n": 20}, {"stats": True}]
    stdin = io.StringIO("".join(json.dumps(r) + "\n" for r in reqs))
    out = io.StringIO()
    argv = ["--checkpoint", str(ckpt), *MODEL_FLAGS]
    old_stdin = sys.stdin
    decode_sample.launches = 0
    t0 = time.perf_counter()
    try:
        sys.stdin = stdin
        with contextlib.redirect_stdout(out):
            serve.main(argv)
    finally:
        sys.stdin = old_stdin
    seconds = time.perf_counter() - t0
    launches = decode_sample.launches
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    ready, resps, stats = lines[0], lines[1:4], lines[4]["coalescing"]
    check(ready.get("status") == "ready", f"service not ready: {ready}")

    # the reference: plain greedy decode of one <S> row (every row of an
    # unconditional request is the same row)
    feats = start_token_features(gen.decoder, 1)
    ids_p, lps_p = decode_sample_plain(*decode_args(gen.decoder, feats))
    want_cap = " ".join(ids_to_words(strip_caption(ids_p[0].tolist()),
                                     synthetic_vocab()[1]))
    want_lp = float(masked_logprob_sum(ids_p, lps_p)[0])
    for req, resp in zip(reqs, resps):
        check("captions" in resp, f"{req}: {resp}")
        check(len(resp["captions"]) == req["n"]
              and len(resp["logprobs"]) == req["n"], f"{req}: row count")
        check(all(math.isfinite(x) for x in resp["logprobs"]),
              f"{req}: non-finite logprob")
        check(all(c == want_cap for c in resp["captions"]),
              f"{req}: caption differs from the plain decode")
        check(all(abs(x - want_lp) <= SEQ_ATOL for x in resp["logprobs"]),
              f"{req}: logprob differs from the plain decode")
    check(launches > 0, "the service never launched the decode kernel")
    check(launches == stats["device_calls"],
          f"kernel launches {launches} != device_calls "
          f"{stats['device_calls']}")
    row = {"phase": "service", "requests": reqs[:3],
           "latency_ms": [r["latency_ms"] for r in resps],
           "caption": want_cap, "logprob": want_lp, "stats": stats,
           "kernel_launches": launches, "seconds": round(seconds, 3)}
    emit(row)
    return row


def phase_timing(dec, device, workdir):
    from gan_image_captioning_tpu_torch import serve
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample, decode_sample_plain)

    out = {}
    for B in (8, 64):
        feats = torch.from_numpy(np.random.default_rng(B).standard_normal(
            (B, E)).astype(np.float32)).to(device)
        args = decode_args(dec, feats)
        plain_a = cuda_ms(lambda: decode_sample_plain(*args), reps=5)
        kern_a = cuda_ms(lambda: decode_sample(*args, mode="serve"), reps=30)
        kern_b = cuda_ms(lambda: decode_sample(*args, mode="serve"), reps=30)
        plain_b = cuda_ms(lambda: decode_sample_plain(*args), reps=5)
        torch.cuda.synchronize()
        enqueue = []
        for _ in range(10):     # host time of the call alone: no sync inside
            t0 = time.perf_counter()
            decode_sample(*args, mode="serve")
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        b_ms, b_by, nbytes, flops = bound_ms(B)
        out[B] = {"kernel_ms": [kern_a, kern_b], "plain_ms": [plain_a, plain_b],
                  "host_enqueue_ms": float(np.median(enqueue)),
                  "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                  "flop": flops}
        emit({"phase": "timing", "B": B, **out[B]})

    args = serve.parse_args(["--checkpoint",
                             str(workdir / "gen_full_width.ckpt"),
                             *MODEL_FLAGS])
    service = serve.CaptionService(args)
    try:
        lat = {}
        for n in (1, 8):
            ms = [service.handle_request({"n": n})["latency_ms"]
                  for _ in range(60)]
            lat[n] = {"p50_ms": float(np.percentile(ms, 50)),
                      "p90_ms": float(np.percentile(ms, 90)),
                      "samples": len(ms)}
    finally:
        service.close()
    emit({"phase": "timing", "service_request_latency": lat,
          "note": "sequential requests, host clock, batch 8"})
    out["service"] = lat
    return out


def phase_profile(dec, device, calls=3):
    """Device time by kernel (torch.profiler, CUPTI) over a few decode
    calls, and the device's busy share of that window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample)

    names = ("lstm_layer_kernel", "proj_kernel", "finalize_kernel")
    rows = {}
    for B in (8, 64):
        feats = torch.from_numpy(np.random.default_rng(B).standard_normal(
            (B, E)).astype(np.float32)).to(device)
        args = decode_args(dec, feats)
        decode_sample(*args, mode="serve")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                decode_sample(*args, mode="serve")
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        us, count = {}, {}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            key = next((n for n in names if n in ev.key), ev.key[:40])
            us[key] = us.get(key, 0.0) + ev.self_device_time_total / calls
            count[key] = count.get(key, 0) + ev.count / calls
        busy = sum(us.values()) * calls
        row = ({"device_us_per_call": us, "launches_per_call": count,
                "device_busy_share": busy / wall_us,
                "wall_ms_per_call": wall_us / calls / 1e3}
               if us else {"device_time": "not measured"})
        rows[B] = row
        emit({"phase": "profile", "B": B, **row})
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    # the port must be importable before anything is printed: a copy of
    # this script without the repository fails here
    import gan_image_captioning_tpu_torch  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    workdir = ROOT / "build" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    smi = phase_device()
    phase_build()
    gen = full_width_generator(device)
    kernel_rows = phase_kernel(gen.decoder, device)
    service = phase_service(gen, workdir)
    times = phase_timing(gen.decoder, device, workdir)
    phase_profile(gen.decoder, device)

    t8 = times[8]
    emit({"kernels": [{
        "name": "decode_serve", "route": "cuda",
        "source": "gan_image_captioning_tpu_torch/kernels/csrc/decode_serve.cu",
        "replaces": TPU_KERNEL,
        "launches": service["kernel_launches"],
        "max_abs_err": max(r["max_abs_lp_diff"] for r in kernel_rows),
        "ms": min(t8["kernel_ms"]), "plain_ms": min(t8["plain_ms"]),
        "bound_ms": t8["bound_ms"], "bound_by": t8["bound_by"],
        "library_ms": None,
        "B": 8, "ms_b64": min(times[64]["kernel_ms"]),
        "plain_ms_b64": min(times[64]["plain_ms"]),
        "bound_ms_b64": times[64]["bound_ms"],
        "ids_equal": {str(r["B"]): r["ids_equal"] for r in kernel_rows},
        "max_abs_lp_diff": {str(r["B"]): r["max_abs_lp_diff"]
                            for r in kernel_rows},
        "card": smi}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
