"""Times the port's flash kernels under other launch plans, beside
PyTorch's SDPA, on one CUDA card: the fused kernels at head dim 64, and
the tiled kernels past the fused shapes.

At config5's MLE shape [64, 37, 12, 64], or the shapes given (causal
with the captions' lengths + 1, and causal alone; with ``--all-masks``
also non-causal with and without lengths; bfloat16 and float32), it
runs, in turns (every variant, then again in reverse order):

* the forward and the backward of ``kernels/flash_attention.py`` on
  every plan of G heads a block that the card takes (the plan of
  ``flash_fwd_plan`` / ``flash_bwd_plan`` with ``heads``, ``threads`` and
  ``smem`` for that G), each held against the plain version and checked
  bit-equal to the planned G's outputs;
* the tiled kernels (the tiled forward, and the tiled backward's one
  launch) at the same shape;
* ``scaled_dot_product_attention`` forward, and its backward alone.

The float32 out is also held against the dense answer in float64
(``out_f64``).  ``--set NAME=VALUE`` (repeatable) times a build of
``flash_attention.cu`` with those ``constexpr int`` constants set to
other values (for instance ``STAGE_U=4``, the bfloat16 staging's rounds
of loads, or ``TF_KROWS=64``, the tiled forward's key tiles, which the
wrapper's plans then follow), loaded in place of the committed build.
Times are ``chip_smoke.device_ms`` (calls queued behind a spin kernel,
CUDA events).  It prints one JSON line a case, then the ptxas report of
``flash_attention.cu`` and the card's name and power limit:

    python scripts/flash_fused64_variants.py [--shapes 64,37,12,64 ...] \
        [--all-masks] [--set NAME=VALUE ...]
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
        if hasattr(fa, name):   # the wrapper plans by its copy (TF_KROWS)
            setattr(fa, name, int(value))
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
    parser.add_argument("--all-masks", action="store_true")
    args = parser.parse_args()
    shapes = [tuple(map(int, x.split(","))) for x in args.shapes]
    if not torch.cuda.is_available():
        print("flash_fused64_variants: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.set:
        use_variant(args.set)
    for shape in shapes:
        time_shape(shape, torch.device("cuda", 0), args.set, args.all_masks)
    print(json.dumps({"ptxas": build.BUILD_LOGS.get("flash_attention",
                                                    "").splitlines()}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


def time_shape(shape, device, sets, all_masks=False):
    b, t, h, d = shape
    rng = np.random.default_rng(561)
    lens = torch.from_numpy(rng.integers(3, t, b).astype(np.int32)
                            + 1).to(device)
    fwd_plan, bwd_plan = fa.flash_fwd_plan(t, h, d), fa.flash_bwd_plan(t, h,
                                                                        d)
    tiled = fwd_plan["route"] == "tiled"
    heads = [] if tiled else [g for g in (1, 2, 4) if g <= h]
    cases = [("mle", lens, True), ("causal", None, True)]
    if all_masks:
        cases += [("lengths", lens, False), ("full", None, False)]
    for dt_name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for case, ln, causal in cases:
            q, k, v, g = (cs.seeded(shape, 560 + i, device).to(dt)
                          for i in range(4))
            out, lse = fa.flash_fwd(q, k, v, causal, ln)
            grads = fa.flash_bwd(q, k, v, out, g, lse, causal, ln)
            p_out, _ = fa.flash_fwd_plain(q, k, v, causal, ln)
            p_grads = fa.flash_bwd_plain(q, k, v, out, g, lse, causal, ln)
            row = {"case": case, "dtype": dt_name, "shape": list(shape),
                   "causal": causal, "set": sets,
                   "plans": {"fwd": fwd_plan, "bwd": bwd_plan},
                   "max_abs_diff": {
                       n: float((a.float() - r.float()).abs().max())
                       for n, a, r in zip(("out", "dq", "dk", "dv"),
                                          (out, *grads), (p_out, *p_grads))}}
            if dt == torch.float32:     # and from the answer in float64
                row["max_abs_diff"]["out_f64"] = float((
                    out - fa.attention_plain(q.double(), k.double(),
                                             v.double(), causal, ln)
                ).abs().max())
            fns, bit_equal = {}, {}
            for gh in heads:
                fp, bp = with_heads(fwd_plan, gh, t), with_heads(bwd_plan,
                                                                 gh, t)
                if fp["threads"] <= fp["most_threads"]:
                    def fwd(fp=fp):
                        with planned("fwd", fp):
                            return fa.flash_fwd(q, k, v, causal, ln)
                    bit_equal[f"fwd_g{gh}"] = all(
                        torch.equal(a, r) for a, r in zip(fwd(), (out, lse)))
                    fns[f"fwd_g{gh}"] = fwd
                if bp["threads"] <= bp["most_threads"]:
                    def bwd(bp=bp):
                        with planned("bwd", bp):
                            return fa.flash_bwd(q, k, v, out, g, lse, causal,
                                                ln)
                    bit_equal[f"bwd_g{gh}"] = all(
                        torch.equal(a, r) for a, r in zip(bwd(), grads))
                    fns[f"bwd_g{gh}"] = bwd

            def tiled_fwd():
                with planned("fwd", fa._tiled_fwd(t, d)):
                    return fa.flash_fwd(q, k, v, causal, ln)

            def tiled_bwd():
                with planned("bwd", fa._tiled_bwd(t, d)):
                    return fa.flash_bwd(q, k, v, out, g, lse, causal, ln)

            fns.update(tiled_fwd=tiled_fwd, tiled_bwd=tiled_bwd)
            mask = torch.ones((1, 1, t, t), dtype=torch.bool, device=device)
            if causal:
                mask = torch.tril(mask)
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
            pairs = cs.attention_pairs(b, t, h, causal, ln)
            bf = dt == torch.bfloat16
            width = 2 if bf else 4
            x, vec = width * b * t * h * d, 4 * b * t * h
            row.update(bit_equal_across_heads=bit_equal, ms=ms, pairs=pairs,
                       bound_ms={
                           "fwd": cs.bound(4 * x + vec, 4 * d * pairs)[0],
                           "bwd": cs.bound(8 * x + vec, 10 * d * pairs)[0]})
            if tiled:
                row["bound_ms"]["fwd"] = cs.tiled_fwd_bound(b, t, h, d,
                                                            pairs, bf)[0]
                row["bound_ms"]["bwd"] = cs.tiled_bwd_bound(b, t, h, d,
                                                            pairs, bf)[0]
            print(json.dumps(row), flush=True)
            del lib, qt, kt, vt, gt


if __name__ == "__main__":
    sys.exit(main())
