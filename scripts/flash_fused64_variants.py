"""Times the port's fused flash kernels at head dim 64 under other launch
plans, beside the tiled route and PyTorch's SDPA, on one CUDA card.

At config5's MLE shape [64, 37, 12, 64], or the shapes given (causal
with the captions' lengths + 1, and causal alone; bfloat16 and float32),
it runs, in turns (every variant, then again in reverse order):

* the forward and the backward of ``kernels/flash_attention.py`` on
  every plan of G heads a block that the card takes (the plan of
  ``flash_fwd_plan`` / ``flash_bwd_plan`` with ``heads``, ``threads`` and
  ``smem`` for that G), each held against the plain version and checked
  bit-equal to the planned G's outputs;
* the tiled kernels (the tiled forward, and the tiled backward's one
  launch) at the same shape;
* ``scaled_dot_product_attention`` forward, and its backward alone.

``--set NAME=VALUE`` (repeatable) times a build of ``flash_attention.cu``
with those ``constexpr int`` constants set to other values (for instance
``STAGE_U=4``, the bfloat16 staging's rounds of loads), loaded in place of
the committed build.  Times are ``chip_smoke.device_ms`` (calls queued
behind a spin kernel, CUDA events).  It prints one JSON line a case, then
the ptxas report of ``flash_attention.cu`` and the card's name and power
limit:

    python scripts/flash_fused64_variants.py [--shapes 64,37,12,64 ...] \
        [--set NAME=VALUE ...]
"""

import argparse
import contextlib
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gan_image_captioning_tpu_torch.kernels import build  # noqa: E402
from gan_image_captioning_tpu_torch.kernels import flash_attention as fa  # noqa: E402,E501


def with_heads(plan, g, t):
    """``plan`` re-made for G = g heads a block."""
    per_head = plan["smem"] // plan["heads"]
    return {**plan, "heads": g, "threads": -(-g * plan["slices"] * t // 32)
            * 32, "smem": g * per_head}


@contextlib.contextmanager
def planned(kind, plan):
    """Within it, the wrapper's ``kind`` plan is ``plan``."""
    name = f"flash_{kind}_plan"
    real = getattr(fa, name)
    setattr(fa, name, lambda t, h, d: plan)
    try:
        yield
    finally:
        setattr(fa, name, real)


def use_variant(sets):
    """Build ``flash_attention.cu`` with each ``constexpr int NAME`` of
    ``sets`` (``NAME=VALUE`` strings) set to its value, and make the
    wrapper load that library."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    for item in sets:
        name, value = item.split("=")
        src, n = re.subn(rf"constexpr int {name} = [^;]+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise SystemExit(f"flash_attention.cu has no constant {name}")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / ("flash_attention_variant_"
                            + hashlib.sha1(src.encode()).hexdigest()[:12]
                            + ".cu")
    cu.write_text(src)
    so = cu.with_suffix(".so")
    done = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(done.stdout + done.stderr)
    build.BUILD_LOGS["flash_attention"] = done.stdout + done.stderr
    variant, real = ctypes.CDLL(str(so)), build.load
    build.load = lambda name: variant if name == "flash_attention" else \
        real(name)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shapes", nargs="+", default=["64,37,12,64"])
    parser.add_argument("--set", action="append", default=[],
                        metavar="NAME=VALUE")
    args = parser.parse_args()
    shapes = [tuple(map(int, x.split(","))) for x in args.shapes]
    if not torch.cuda.is_available():
        print("flash_fused64_variants: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.set:
        use_variant(args.set)
    for shape in shapes:
        time_shape(shape, torch.device("cuda", 0), args.set)
    print(json.dumps({"ptxas": build.BUILD_LOGS.get("flash_attention",
                                                    "").splitlines()}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


def time_shape(shape, device, sets):
    b, t, h, d = shape
    rng = np.random.default_rng(561)
    lens = torch.from_numpy(rng.integers(3, t, b).astype(np.int32)
                            + 1).to(device)
    fwd_plan, bwd_plan = fa.flash_fwd_plan(t, h, d), fa.flash_bwd_plan(t, h,
                                                                        d)
    heads = [g for g in (1, 2, 4) if g <= h]
    for dt_name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for case, ln in (("mle", lens), ("causal", None)):
            q, k, v, g = (cs.seeded(shape, 560 + i, device).to(dt)
                          for i in range(4))
            out, lse = fa.flash_fwd(q, k, v, True, ln)
            grads = fa.flash_bwd(q, k, v, out, g, lse, True, ln)
            p_out, _ = fa.flash_fwd_plain(q, k, v, True, ln)
            p_grads = fa.flash_bwd_plain(q, k, v, out, g, lse, True, ln)
            row = {"case": case, "dtype": dt_name, "shape": list(shape),
                   "set": sets,
                   "plans": {"fwd": fwd_plan, "bwd": bwd_plan},
                   "max_abs_diff": {
                       n: float((a.float() - r.float()).abs().max())
                       for n, a, r in zip(("out", "dq", "dk", "dv"),
                                          (out, *grads), (p_out, *p_grads))}}
            fns, bit_equal = {}, {}
            for gh in heads:
                fp, bp = with_heads(fwd_plan, gh, t), with_heads(bwd_plan,
                                                                 gh, t)
                if fp["threads"] <= fp["most_threads"]:
                    def fwd(fp=fp):
                        with planned("fwd", fp):
                            return fa.flash_fwd(q, k, v, True, ln)
                    bit_equal[f"fwd_g{gh}"] = all(
                        torch.equal(a, r) for a, r in zip(fwd(), (out, lse)))
                    fns[f"fwd_g{gh}"] = fwd
                if bp["threads"] <= bp["most_threads"]:
                    def bwd(bp=bp):
                        with planned("bwd", bp):
                            return fa.flash_bwd(q, k, v, out, g, lse, True,
                                                ln)
                    bit_equal[f"bwd_g{gh}"] = all(
                        torch.equal(a, r) for a, r in zip(bwd(), grads))
                    fns[f"bwd_g{gh}"] = bwd

            def tiled_fwd():
                with planned("fwd", {"route": "tiled"}):
                    return fa.flash_fwd(q, k, v, True, ln)

            def tiled_bwd():
                with planned("bwd", fa._tiled_bwd(t, d)):
                    return fa.flash_bwd(q, k, v, out, g, lse, True, ln)

            fns.update(tiled_fwd=tiled_fwd, tiled_bwd=tiled_bwd)
            mask = torch.tril(torch.ones((1, 1, t, t), dtype=torch.bool,
                                         device=device))
            if ln is not None:
                mask = mask & (torch.arange(t, device=device)[None, :]
                               < ln[:, None])[:, None, None, :]
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                          for x in (q, k, v))
            gt = g.transpose(1, 2).contiguous()
            lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            fns["sdpa_fwd"] = lambda: F.scaled_dot_product_attention(
                qt.detach(), kt.detach(), vt.detach(), attn_mask=mask)
            fns["sdpa_bwd"] = lambda: torch.autograd.grad(
                lib, (qt, kt, vt), gt, retain_graph=True)
            ms = {n: [] for n in fns}
            for order in (list(fns), list(reversed(fns))):
                for n in order:
                    with torch.no_grad() if n != "sdpa_bwd" else \
                            torch.enable_grad():
                        ms[n].append(cs.device_ms(fns[n]))
            pairs = cs.attention_pairs(b, t, h, True, ln)
            width = 2 if dt == torch.bfloat16 else 4
            x, vec = width * b * t * h * d, 4 * b * t * h
            row.update(bit_equal_across_heads=bit_equal, ms=ms, pairs=pairs,
                       bound_ms={
                           "fwd": cs.bound(4 * x + vec, 4 * d * pairs)[0],
                           "bwd": cs.bound(8 * x + vec, 10 * d * pairs)[0]})
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())
