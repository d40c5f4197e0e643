"""Device-side image normalization: the CUDA kernel and its plain version.

Counterpart of ``gan_image_captioning_tpu/kernels/image_norm.py``
(``normalize_images``): resized CHW uint8 images, shipped to the device at
a quarter of float32's bytes, become the normalized float32 (or, under
``--dtype bfloat16``, bfloat16: the same float32 map rounded once) the
encoder reads, ``u8 * scale[c] + shift[c]`` with ``scale = 1/(255 std)`` and
``shift = -mean/std`` (ImageNet constants, reference ``tasks.py:97-98``)
computed in Python double and rounded to float32, as the JAX package does.

* On CUDA tensors :func:`normalize_images` launches the hand-written
  kernel (``csrc/image_norm.cu``, built at first use) or raises.
* On CPU tensors it runs :func:`normalize_images_plain`.

``normalize_images.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from gan_image_captioning_tpu_torch.kernels import build

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
SCALE = tuple(1.0 / (255.0 * s) for s in STD)
SHIFT = tuple(-m / s for m, s in zip(MEAN, STD))

_count_lock = threading.Lock()


def _affine(device):
    shape = (1, 3, 1, 1)
    return (torch.tensor(SCALE, dtype=torch.float32, device=device)
            .reshape(shape),
            torch.tensor(SHIFT, dtype=torch.float32, device=device)
            .reshape(shape))


def normalize_images_plain(u8, dtype=torch.float32):
    """Plain PyTorch version: ``u8.float() * scale + shift`` with the same
    float32 constants → ``[B, 3, H, W]`` in ``dtype`` (float32, or
    bfloat16: the float32 result rounded)."""
    scale, shift = _affine(u8.device)
    return (u8.to(torch.float32) * scale + shift).to(dtype)


def _validate(u8, dtype):
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"normalize_images: {dtype} output: float32 or "
                        "bfloat16 expected")
    if u8.dtype != torch.uint8:
        raise TypeError(f"normalize_images: images must be uint8, got "
                        f"{u8.dtype}")
    if u8.ndim != 4 or u8.shape[1] != 3:
        raise ValueError("normalize_images: images must be [B, 3, H, W], got "
                         f"{tuple(u8.shape)}")
    if not u8.is_contiguous():
        raise ValueError("normalize_images: images must be contiguous")


def _library() -> ctypes.CDLL:
    lib = build.load("image_norm")
    if not getattr(lib, "_gic_typed", False):
        vp, f = ctypes.c_void_p, ctypes.c_float
        lib.gic_image_norm.argtypes = ([vp, vp, ctypes.c_longlong,
                                        ctypes.c_int] + [f] * 6
                                       + [ctypes.c_int, vp])
        lib.gic_image_norm.restype = ctypes.c_int
        lib._gic_typed = True
    return lib


def normalize_images(u8, dtype=torch.float32):
    """``[B, 3, H, W]`` uint8 → normalized ``[B, 3, H, W]`` ``dtype``
    (float32, or bfloat16: the kernel's bfloat16 instantiation)."""
    _validate(u8, dtype)
    device = u8.device
    if device.type == "cpu":
        return normalize_images_plain(u8, dtype)
    if device.type != "cuda":
        raise ValueError(f"normalize_images: unsupported device {device}")
    out = torch.empty(u8.shape, dtype=dtype, device=device)
    if u8.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gic_image_norm(u8.data_ptr(), out.data_ptr(), u8.numel(),
                                u8.shape[2] * u8.shape[3], *SCALE, *SHIFT,
                                int(dtype == torch.bfloat16), stream)
    build.raise_on_error(lib, rc, "normalize_images")
    with _count_lock:
        normalize_images.launches += 1
        if dtype == torch.bfloat16:
            normalize_images.bf16_launches += 1
    return out


normalize_images.launches = normalize_images.bf16_launches = 0
