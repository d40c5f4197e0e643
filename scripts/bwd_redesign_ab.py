"""Times the port's bfloat16 embed backward and its flash backward at the
long-caption shapes, beside the library calls, for one or more checkouts
of the repository in turns, on one CUDA card.

Each checkout's ``gan_image_captioning_tpu_torch`` runs in a process of
its own (its kernels built from its own sources), through the wrappers'
public signatures only, so a parent commit unpacked beside this one
(``git archive``) is measured by the same code:

* ``decode_sample_embed_bwd`` in bfloat16 at config3's [36 x 64 rows,
  V = 11008, H = 512, Ed = 64]: its device time, its device time split by
  kernel (torch.profiler) and the three cuBLAS bfloat16 products that
  compute the same (d_soft = d_emb @ wd, dWp = h_top^T @ dl, d_htop =
  dl @ w_proj);
* ``flash_bwd`` (the whole backward, on the route its plan picks) in
  float32 and bfloat16, with and without key lengths, at the shapes that
  ``--max-seq-len 126`` gives (seq_len 128): config4's generator [64, 129,
  8, 32] causal, its discriminator [64, 128, 8, 16] full and the
  rollouts' [256, 128, 8, 16], config5's generator [64, 129, 12, 64]
  causal; beside ``scaled_dot_product_attention``'s backward alone
  (boolean mask), and its kernels by name (torch.profiler).

Times are device milliseconds a call: calls queued behind a spin kernel
(``torch.cuda._sleep``) and timed with CUDA events.  One JSON line a
measurement, then the card's name and power limit:

    python scripts/bwd_redesign_ab.py --roots build/parent,.,.,build/parent
"""

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPIN_CYCLES = 100_000_000
# (name, [B, T, H, D], causal): the long-caption shapes of --max-seq-len 126
FLASH_SHAPES = [("c4_gen", (64, 129, 8, 32), True),
                ("c4_disc", (64, 128, 8, 16), False),
                ("c4_rollout", (256, 128, 8, 16), False),
                ("c5_gen", (64, 129, 12, 64), True)]
EMBED = (36, 64, 512, 11008, 64)      # T, B, H, V, Ed


def device_ms(torch, fn, calls=20):
    """Device ms a call of ``fn``: ``calls`` calls enqueued behind a spin
    kernel, timed with CUDA events; measured once more behind a longer
    spin where enqueueing outlasted it."""
    fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(3):
        spin0, start, end = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        spin0.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        spin_ms = spin0.elapsed_time(start)
        if host_ms < spin_ms:
            return start.elapsed_time(end) / calls
        cycles = int(cycles * 2 * host_ms / spin_ms) + 1
    raise RuntimeError(f"enqueueing outlasted the spin: {host_ms} ms")


def kernel_split(torch, fn, calls=5):
    """Mean device µs a call by kernel name, and events a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                out[ev.key[:100]] = {
                    "us_per_call": ev.self_device_time_total / calls,
                    "events_per_call": ev.count / calls}
        if out:
            return out
    return "not measured"


def seeded(torch, np, shape, seed, device, scale=1.0, dtype=None):
    x = torch.from_numpy((np.random.default_rng(seed).standard_normal(shape)
                          * scale).astype(np.float32)).to(device)
    return x if dtype is None else x.to(dtype)


def child(root, tag):
    """Every measurement on the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import torch.nn.functional as F

    from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
    from gan_image_captioning_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16

    def emit(obj):
        print(json.dumps({"tree": tag, **obj}), flush=True)

    # --- the bfloat16 embed backward and its three cuBLAS products
    T, B, H, V, Ed = EMBED
    args = (seeded(torch, np, (T, B, H), 93, dev, 1.0, bf),
            torch.softmax(seeded(torch, np, (T, B, V), 94, dev, 3.0),
                          dim=-1).to(bf),
            seeded(torch, np, (T, B, Ed), 92, dev, 1.0, bf),
            seeded(torch, np, (V, H), 95, dev, 1 / math.sqrt(H), bf),
            seeded(torch, np, (Ed, V), 91, dev, 0.1, bf), 10.0)
    fn = lambda: ds.decode_sample_embed_bwd(*args)  # noqa: E731
    h2, e2 = args[0].reshape(T * B, H), args[2].reshape(T * B, Ed)
    dl = seeded(torch, np, (T * B, V), 96, dev, 1e-3, bf)
    wd, wp = args[4], args[3]
    products = {"d_soft": lambda: e2 @ wd, "dwp": lambda: h2.T @ dl,
                "d_htop": lambda: dl @ wp}

    def lib():
        for f in products.values():
            f()

    ms = {"kernel": [], "library": []}
    for _ in range(2):
        ms["kernel"].append(device_ms(torch, fn))
        ms["library"].append(device_ms(torch, lib))
    emit({"what": "embed_bwd_bf16", "shape": [T * B, V, H, Ed], "ms": ms,
          "library_by_product_ms": {n: device_ms(torch, f)
                                    for n, f in products.items()},
          "launches_a_call": _launches(ds.decode_sample_embed_bwd, fn),
          "split": kernel_split(torch, fn)})

    # --- the flash backward at the long-caption shapes, and SDPA's
    rng = np.random.default_rng(57)
    for name, shape, causal in FLASH_SHAPES:
        b, t, h, d = shape
        lens_all = torch.from_numpy(rng.integers(3, t + 1, b).astype(
            np.int32)).to(dev)
        for dtype in (torch.float32, bf):
            for lens in (None, lens_all):
                q, k, v, g = (seeded(torch, np, shape, 60 + i, dev, 1.0,
                                     dtype) for i in range(4))
                out, lse = fa.flash_fwd(q, k, v, causal, lens)
                kfn = lambda: fa.flash_bwd(q, k, v, out, g, lse,  # noqa
                                           causal, lens)
                mask = torch.ones((1, 1, t, t), dtype=torch.bool,
                                  device=dev)
                if causal:
                    mask = torch.tril(mask)
                if lens is not None:
                    mask = mask & (torch.arange(t, device=dev)[None, :]
                                   < lens[:, None])[:, None, None, :]
                qt, kt, vt = (x.transpose(1, 2).contiguous()
                              .requires_grad_(True) for x in (q, k, v))
                gt = g.transpose(1, 2).contiguous()
                lo = F.scaled_dot_product_attention(qt, kt, vt,
                                                    attn_mask=mask)
                lfn = lambda: torch.autograd.grad(  # noqa: E731
                    lo, (qt, kt, vt), gt, retain_graph=True)
                ms = {"kernel": [], "sdpa_bwd": []}
                for _ in range(2):
                    ms["kernel"].append(device_ms(torch, kfn, 10))
                    ms["sdpa_bwd"].append(device_ms(torch, lfn, 10))
                emit({"what": "flash_bwd", "case": name, "shape": list(shape),
                      "dtype": str(dtype).split(".")[-1], "causal": causal,
                      "lengths": lens is not None, "ms": ms,
                      "route": fa.flash_bwd_plan(t, h, d)["route"],
                      "kernels": kernel_split(torch, kfn, 3),
                      "sdpa_kernels": kernel_split(torch, lfn, 3)})
                del lo, qt, kt, vt


def _launches(fn_obj, fn):
    before = fn_obj.launches
    fn()
    return fn_obj.launches - before


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", default=".",
                    help="checkouts to time, comma-separated, in turns")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tag", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(Path(args.child).resolve(), args.tag)
        return 0
    rc = 0
    for i, root in enumerate(args.roots.split(",")):
        path = (ROOT / root).resolve()
        tag = f"{i}:{root}"
        print(json.dumps({"turn": i, "root": root}), flush=True)
        rc |= subprocess.run([sys.executable, __file__, "--child", str(path),
                              "--tag", tag], cwd=path).returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
