"""Times the bfloat16 embed backward (``csrc/decode_embed_bwd.cu``,
``decode_sample_embed_bwd`` on bfloat16 tensors) built with other tilings,
in turns, on one CUDA card.

Each ``--variant`` is a comma-separated list of ``NAME=VALUE``: a build of
``decode_embed_bwd.cu`` with those ``constexpr int`` constants set (for
instance ``WG_HT_HALVES=1`` or ``WG_DWP_N=128,WG_DWP_STAGES=6``);
``base`` is the source as committed.  All variants are built at once (one
nvcc each), then each runs the wrapper at
config3's [36 x 64 rows, V = 11008, H = 512, Ed = 64] (or ``--shape
T,B,H,V,Ed``): held against the plain version (dWp and dbp within 1e-4 of
their largest entry, d_htop within 2 bfloat16 units), a second call
bit-equal, its device time (calls queued behind a spin kernel, CUDA
events) in turns (every variant, then again in reverse order), and its
device time split by kernel (torch.profiler).  One JSON line a variant and
turn, then each build's ptxas report and the card's name and power limit:

    python scripts/embed_bwd_variants.py --variant base \\
        --variant WG_DWP_N=128,WG_DWP_STAGES=6
"""

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import bwd_redesign_ab as ab  # noqa: E402
from gan_image_captioning_tpu_torch.kernels import build  # noqa: E402
from gan_image_captioning_tpu_torch.kernels import decode_sample as ds  # noqa: E402,E501


def variant_source(spec):
    src = (build.CSRC / "decode_embed_bwd.cu").read_text()
    if spec == "base":
        return src
    for item in spec.split(","):
        name, value = item.split("=")
        src, n = re.subn(rf"constexpr int {name} = [^;]+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise SystemExit(f"decode_embed_bwd.cu has no constant {name}")
    return src


def build_all(specs):
    """One library a variant, all nvcc runs started together."""
    out_dir = build.BUILD_DIR / "embed_bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for spec in specs:
        src = variant_source(spec)
        cu = out_dir / ("v_" + hashlib.sha1(src.encode()).hexdigest()[:12]
                        + ".cu")
        cu.write_text(src)
        so = cu.with_suffix(".so")
        procs[spec] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs, logs = {}, {}
    for spec, (proc, so) in procs.items():
        log, _ = proc.communicate()
        logs[spec] = [ln for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "error" in ln.lower()]
        if proc.returncode:
            print(json.dumps({"variant": spec, "build": "failed",
                              "log": log[-4000:]}), flush=True)
            continue
        lib = ctypes.CDLL(str(so))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gic_decode_embed_bwd.argtypes = (
            [vp] * 5 + [i] * 5 + [ctypes.c_float, ctypes.POINTER(i)]
            + [vp] * 5)
        lib.gic_decode_embed_bwd.restype = i
        lib.gic_error_string.argtypes = [ctypes.c_int]
        lib.gic_error_string.restype = ctypes.c_char_p
        lib._gic_typed = True
        libs[spec] = lib
    return libs, logs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--shape", default="36,64,512,11008,64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("embed_bwd_variants: needs a CUDA card", file=sys.stderr)
        return 1
    specs = args.variant or ["base"]
    T, B, H, V, Ed = map(int, args.shape.split(","))
    dev, bf = torch.device("cuda", 0), torch.bfloat16
    libs, logs = build_all(specs)
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0, dtype=bf):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev, dtype)

    bargs = (t(T, B, H, scale=0.5),
             torch.softmax(t(T, B, V, scale=3.0, dtype=torch.float32),
                           dim=-1).to(bf),
             t(T, B, Ed, scale=0.1), t(V, H, scale=H ** -0.5),
             t(Ed, V, scale=0.02), 1.75)
    want = ds.decode_sample_embed_bwd_plain(*bargs)
    real = ds._bwd_library
    order = [s for s in specs if s in libs]
    rows = {s: {"variant": s, "ms": []} for s in order}
    for turn, seq in enumerate((order, order[::-1])):
        for spec in seq:
            ds._bwd_library = lambda spec=spec: libs[spec]
            fn = lambda: ds.decode_sample_embed_bwd(*bargs)  # noqa: E731
            if turn == 0:
                got, again = fn(), fn()
                r = rows[spec]
                for n, a, b in (("dwp", got[0], want[0]),
                                ("dbp", got[1], want[1])):
                    r[f"{n}_rel"] = float((a - b).abs().max()
                                          / b.abs().max())
                r["d_htop_units"] = float(
                    (got[2].float() - want[2].float()).abs().max()
                    / (2.0 ** -8 * want[2].float().abs().max()))
                r["bit_equal_repeat"] = all(torch.equal(a, b)
                                            for a, b in zip(got, again))
                r["ok"] = (r["dwp_rel"] <= 1e-4 and r["dbp_rel"] <= 1e-4
                           and r["d_htop_units"] <= 2
                           and r["bit_equal_repeat"])
                r["split"] = ab.kernel_split(torch, fn)
                r["plan"] = ds.embed_bwd_plan(T * B, H, V, Ed,
                                              ds._sm_count(dev), True)["ints"]
            rows[spec]["ms"].append(ab.device_ms(torch, fn))
    ds._bwd_library = real
    for spec in order:
        print(json.dumps(rows[spec]), flush=True)
    for spec in specs:
        print(json.dumps({"variant": spec, "ptxas": logs.get(spec)}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0 if all(rows[s]["ok"] for s in order) else 1


if __name__ == "__main__":
    sys.exit(main())
