"""Host-side image preprocessing (``gan_image_captioning_tpu/data/
images.py``): the reference transform chain (``tasks.py:92-100``) — resize
to ``(image_size, image_size)`` bilinear, scale to [0, 1], grayscale →
three channels, ImageNet mean/std — as CHW arrays.

Pillow decodes the files and is imported inside the functions: without it
an image request or an image dataset raises ``ImportError``.  The JAX
package's native C++ decoder (``data/native.py``) is not ported
(``ROADMAP.md`` queue 1, item 5).
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)  # tasks.py:97
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)   # tasks.py:98


def _pil_image():
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError("decoding images needs Pillow (the PIL package), "
                          "which is not installed") from exc
    return Image


def _load_resized(path: str, image_size: int, dtype) -> np.ndarray:
    """The file at ``path`` resized, as HWC with three channels."""
    Image = _pil_image()
    with Image.open(path) as im:
        im = im.resize((image_size, image_size), Image.BILINEAR)
        arr = np.asarray(im, dtype=dtype)
    if arr.ndim == 2:  # grayscale → repeat to 3 channels (tasks.py:96)
        arr = np.stack([arr] * 3, axis=-1)
    elif arr.shape[-1] == 4:  # RGBA → drop alpha
        arr = arr[..., :3]
    return arr


def load_and_preprocess(path: str, image_size: int) -> np.ndarray:
    """JPEG → normalized CHW float32, reference ``tasks.py:92-100``."""
    arr = _load_resized(path, image_size, np.float32) / 255.0
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return np.transpose(arr, (2, 0, 1)).copy()  # HWC → CHW


def load_resize_u8(path: str, image_size: int) -> np.ndarray:
    """JPEG → resized CHW uint8; the device normalizes it
    (``kernels/image_norm.py``)."""
    arr = _load_resized(path, image_size, np.uint8)
    return np.transpose(arr, (2, 0, 1)).copy()
