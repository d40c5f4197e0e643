"""Train-time image augmentation on the device
(``gan_image_captioning_tpu/ops/augment.py``, ``--random-flip`` /
``--random-crop-pad``).

The reference's transform chain is deterministic (resize and normalize);
these are the JAX package's shape-preserving extensions, applied to the
batch inside the training step:

* a horizontal flip of each image whose coin is set;
* a translation: reflect-pad by ``crop_pad`` pixels, then crop each image
  back to its size at its own offset ``(oy, ox)`` in ``[0, 2·crop_pad]``.

Both work on either layout the step receives, ``images [B, C, H, W]``
float and ``images_u8`` before ``image_norm`` (flip and crop commute with
the per-pixel normalization).  The coins and offsets can be fed (the
tests feed the JAX package's draws); what is not fed is drawn from
``generator`` on the images' device.
"""

from __future__ import annotations

import torch


def augment_images(images, flip: bool = True, crop_pad: int = 0, coin=None,
                   oy=None, ox=None, generator=None):
    """Randomly flip and translate ``images [B, C, H, W]`` (any dtype).
    ``coin [B]`` bool (flip where set), ``oy`` / ``ox [B]`` int offsets
    into the padded image; each drawn from ``generator`` when ``None``
    (coins fair, offsets uniform)."""
    b, _, h, w = images.shape
    device = images.device
    if flip:
        if coin is None:
            coin = torch.rand(b, generator=generator, device=device) < 0.5
        coin = torch.as_tensor(coin, device=device).bool()
        images = torch.where(coin[:, None, None, None],
                             images.flip(-1), images)
    if crop_pad > 0:
        p = int(crop_pad)
        if oy is None:
            oy = torch.randint(0, 2 * p + 1, (b,), generator=generator,
                               device=device)
        if ox is None:
            ox = torch.randint(0, 2 * p + 1, (b,), generator=generator,
                               device=device)
        oy = torch.as_tensor(oy, device=device).long()
        ox = torch.as_tensor(ox, device=device).long()
        # reflect padding of an integer tensor is not implemented: pad
        # through an index gather, which is exact for any dtype
        rows = _reflect_index(h, p, device)
        cols = _reflect_index(w, p, device)
        ry = (oy[:, None] + torch.arange(h, device=device)[None])   # [B, h]
        rx = (ox[:, None] + torch.arange(w, device=device)[None])   # [B, w]
        iy, ix = rows[ry], cols[rx]
        bidx = torch.arange(b, device=device)[:, None, None]
        images = images.permute(0, 2, 3, 1)[bidx, iy[:, :, None],
                                            ix[:, None, :]]
        images = images.permute(0, 3, 1, 2).contiguous()
    return images


def _reflect_index(n: int, p: int, device):
    """Source index of each of the ``n + 2p`` positions of a reflect-padded
    axis (``numpy.pad(mode="reflect")``: the edge is not repeated)."""
    idx = torch.arange(-p, n + p, device=device)
    idx = idx.abs()
    return torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)
