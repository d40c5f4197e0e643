"""ResNet-18 backbone (``gan_image_captioning_tpu/models/resnet.py``).

torchvision's ``resnet18`` minus the FC, with torchvision's parameter names
(``conv1``, ``bn1``, ``layer{1..4}.{0,1}.{conv1,bn1,conv2,bn2}``,
``downsample.{0,1}``), so the reference checkpoint's ``encoder.resnet.
{0..7}.*`` keys are a rename (``train/checkpoint.py``).  The convolutions,
the max-pool and BatchNorm are ``F.conv2d`` / ``F.max_pool2d`` /
``F.batch_norm`` (cuDNN on the card): the JAX package runs them in XLA,
outside any Pallas kernel.

BatchNorm keeps the reference's semantics (``resnet.py:39-67``): train mode
normalizes with the biased batch statistics and moves the running
statistics by ``momentum`` with the unbiased variance, in place; eval mode
normalizes with the running statistics.  The running statistics are
buffers, not parameters.  Every ``forward`` takes ``train`` explicitly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.1  # torch BatchNorm2d default (the backbone)
# ResNet-18: 4 stages × 2 BasicBlocks, widths 64/128/256/512.
STAGES = ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2))
FEATURE_DIM = 512


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of ``[N, C, ...]`` with torch's buffer names
    (``num_batches_tracked`` is kept for the reference layout; the momentum
    is always set, so nothing reads it)."""

    def __init__(self, channels: int, momentum: float = BN_MOMENTUM,
                 eps: float = 1e-5, device="cpu", dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels, **kw))
        self.bias = nn.Parameter(torch.zeros(channels, **kw))
        self.register_buffer("running_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    def forward(self, x, train: bool):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, train, self.momentum,
                            self.eps)


class Conv(nn.Module):
    """Bias-free 2-D convolution, weight ``[O, I, k, k]`` (allocated
    uninitialized: :func:`init_resnet18_params` or a checkpoint fills
    it)."""

    def __init__(self, in_c: int, out_c: int, k: int, stride: int = 1,
                 padding: int = 0, device="cpu", dtype=torch.float32):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(out_c, in_c, k, k,
                                               device=device, dtype=dtype))

    def forward(self, x):
        return F.conv2d(x, self.weight, None, self.stride, self.padding)


class BasicBlock(nn.Module):
    def __init__(self, in_c: int, width: int, stride: int, **kw):
        super().__init__()
        self.conv1 = Conv(in_c, width, 3, stride, 1, **kw)
        self.bn1 = BatchNorm(width, **kw)
        self.conv2 = Conv(width, width, 3, 1, 1, **kw)
        self.bn2 = BatchNorm(width, **kw)
        self.downsample = (nn.Sequential(Conv(in_c, width, 1, stride, 0, **kw),
                                         BatchNorm(width, **kw))
                           if stride != 1 or in_c != width else None)

    def forward(self, x, train: bool):
        out = F.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        if self.downsample is not None:
            conv, bn = self.downsample
            x = bn(conv(x), train)
        return F.relu(out + x)


class ResNet18(nn.Module):
    def __init__(self, device="cpu", dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1 = Conv(3, 64, 7, 2, 3, **kw)
        self.bn1 = BatchNorm(64, **kw)
        in_c = 64
        for s, (width, blocks, stride) in enumerate(STAGES, start=1):
            layer = []
            for b in range(blocks):
                layer.append(BasicBlock(in_c, width, stride if b == 0 else 1,
                                        **kw))
                in_c = width
            setattr(self, f"layer{s}", nn.Sequential(*layer))

    def trunk(self, images, train: bool):
        """``[B, 3, H, W]`` → ``[B, 512, h, w]`` (before the global pool)."""
        x = F.relu(self.bn1(self.conv1(images), train))
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(1, len(STAGES) + 1):
            for block in getattr(self, f"layer{s}"):
                x = block(x, train)
        return x

    def forward(self, images, train: bool = False):
        """``[B, 3, H, W]`` → ``[B, 512]`` pooled features."""
        return self.trunk(images, train).mean(dim=(2, 3))


def resnet18_grid(resnet: ResNet18, images, train: bool = False):
    """``[B, 3, H, W]`` → ``[B, h·w, 512]``: the final stage's feature grid,
    the grid the conditional transformer cross-attends over."""
    x = resnet.trunk(images, train)
    return x.flatten(2).transpose(1, 2)


@torch.no_grad()
def init_resnet18_params(generator: torch.Generator,
                         resnet: ResNet18) -> ResNet18:
    """The JAX package's distributions: every conv weight kaiming-normal
    with fan_out (``std = sqrt(2 / (O k k))``), BatchNorm scale 1, bias 0,
    running mean 0, running variance 1.  Drawn on the CPU from
    ``generator``."""
    for m in resnet.modules():
        if isinstance(m, Conv):
            w = m.weight
            out_c, _, k, _ = w.shape
            std = (2.0 / (out_c * k * k)) ** 0.5
            w.copy_(torch.randn(w.shape, generator=generator,
                                dtype=w.dtype) * std)
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
    return resnet
