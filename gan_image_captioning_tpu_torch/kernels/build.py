"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at first use, into ``build/gic_torch_kernels/`` beside the
package (``.gitignore`` lists ``build/``).  The library's file name carries
a hash of its source, the shared ``csrc/*.cuh`` headers and the flags, so
an edited source is rebuilt and a stale library is never loaded.  Nothing
is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gic_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# compiler output (ptxas register / shared-memory / spill report) per source
BUILD_LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels are built on the machine with "
                           "the card")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    # the shared headers count as source of every library
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no current library, one
    ``nvcc`` per source, all started together.  Raises with the compiler's
    output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        lib = library_path(name)
        out[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed.  Every
    library exports ``gic_error_string(int) -> const char*``."""
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(build([name])[name]))
            lib.gic_error_string.argtypes = [ctypes.c_int]
            lib.gic_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


def raise_on_error(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel failed: CUDA error {rc} "
                           f"({lib.gic_error_string(rc).decode()})")


_LIMITS: Dict[int, tuple] = {}


def device_limits(lib: ctypes.CDLL, device) -> tuple:
    """``(SM count, opt-in shared memory bytes per block)`` of a CUDA
    device, from a library that exports ``gic_device_limits`` (the ones
    with a persistent kernel); cached per device."""
    import torch

    idx = device.index if device.index is not None else 0
    with _LOCK:
        if idx not in _LIMITS:
            fn = lib.gic_device_limits
            fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
            fn.restype = ctypes.c_int
            n_sm, smem = ctypes.c_int(), ctypes.c_int()
            with torch.cuda.device(device):
                raise_on_error(lib, fn(ctypes.byref(n_sm), ctypes.byref(smem)),
                               "device limits")
            _LIMITS[idx] = (n_sm.value, smem.value)
        return _LIMITS[idx]


def compute_dtype(fn: str, t, bf16: bool = True):
    """The compute dtype a kernel takes from its leading tensor ``t``:
    float32, or bfloat16 where the kernel has a bfloat16 instantiation
    (``bf16``).  TypeError for any other."""
    import torch

    allowed = (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
    if t.dtype not in allowed:
        names = " or ".join(str(d) for d in allowed)
        raise TypeError(f"{fn}: {names} expected, got {t.dtype}")
    return t.dtype


def check_tensor(fn: str, name: str, t, shape, device, dtype=None) -> None:
    """What every kernel wrapper asks of a tensor before it passes a
    pointer: ``device``, ``dtype`` (float32 unless given), ``shape`` and
    contiguity.  TypeError for the dtype, ValueError otherwise."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")
