"""ResNet-50/101 backbone with frozen BatchNorm (the port of the JAX package's
models/resnet.py; reference models/GroundingDINO/backbone/backbone.py:33-143).

The torchvision v1.5 bottleneck trunk (stride on the 3x3 conv),
FrozenBatchNorm2d everywhere (eps 1e-5 added before the rsqrt), optional
last-stage dilation (replace_stride_with_dilation) and the intermediate maps
of `out_indices`.  Images come in and maps go out channel-last (B, H, W, C),
as the port's Swin takes and gives them; the convolutions run on the
channel-last memory layout of a permuted view.  Parameter and buffer names
are the reference's under `backbone.0.body.` (`conv1`, `bn1`,
`layer{i}.{b}.conv2`, `layer{i}.{b}.downsample.0`, ...).

FrozenBatchNorm2d keeps weight, bias, running_mean and running_var as
buffers, as torchvision does: the optimizer never sees them, and the bf16
step's parameter cast leaves them f32, so the fold into a scale and shift
runs in f32 and is cast to the activation's dtype.  The reference also
freezes the stem and layer1 (backbone.py:82-89): `frozen_param_keys` names
them for the optimizer's frozen group.  With `use_checkpoint`, a forward in
training mode with gradients on recomputes each bottleneck in the backward
(the JAX package's `nn.remat(Bottleneck)`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

RESNET_VARIANTS = {
    # nano variant for tests only
    "resnet_nano_test": dict(depths=(1, 1, 1, 1), base_width=8),
    "resnet50": dict(depths=(3, 4, 6, 3), base_width=64),
    "resnet101": dict(depths=(3, 4, 23, 3), base_width=64),
}

# the model's key prefix of the trunk (reference backbone.py: BackboneBase.body)
BODY_PREFIX = "backbone.0.body."


@dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet50"
    out_indices: Tuple[int, ...] = (1, 2, 3)
    dilation: bool = False          # replace layer4's stride with dilation
    use_checkpoint: bool = False

    def __post_init__(self):
        if self.name not in RESNET_VARIANTS:
            raise ValueError(f"unknown ResNet backbone {self.name!r}")

    @property
    def depths(self) -> Tuple[int, ...]:
        return tuple(RESNET_VARIANTS[self.name]["depths"])

    @property
    def base_width(self) -> int:
        return int(RESNET_VARIANTS[self.name]["base_width"])

    @property
    def num_features(self) -> Tuple[int, ...]:
        # bottleneck expansion 4
        return tuple(self.base_width * 4 * (2 ** i) for i in range(4))

    @property
    def strides(self) -> Tuple[int, ...]:
        """Each stage's stride: 4 * 2^i, stage 3 keeping 16 when dilated."""
        return tuple(4 * 2 ** min(i, 2) if self.dilation and i == 3 else 4 * 2 ** i
                     for i in range(4))


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm2d with fixed statistics and affine terms, all buffers
    (reference backbone.py:33-71).  Acts on NCHW."""

    def __init__(self, n: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def init_weights_(self, g: torch.Generator) -> None:
        """The identity, as torchvision initialises it."""
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + 1e-5)
        shift = self.bias.float() - self.running_mean.float() * scale
        return (x * scale.to(x.dtype)[:, None, None]) + shift.to(x.dtype)[:, None, None]


class Bottleneck(nn.Module):
    """torchvision Bottleneck (v1.5: stride on conv2), frozen BN."""

    def __init__(self, inplanes: int, width: int, stride: int, dilation: int,
                 downsample: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, 4 * width, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(4 * width)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, 4 * width, 1, stride=stride,
                                                   bias=False),
                                         FrozenBatchNorm2d(4 * width))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idt)


class ResNetBody(nn.Module):
    """The trunk: stem (conv1, bn1, max pool) and layer1..layer4."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        w = cfg.base_width
        self.conv1 = nn.Conv2d(3, w, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(w)
        inplanes, dilation = w, 1
        for i, depth in enumerate(cfg.depths):
            width = w * 2 ** i
            stride = 1 if i == 0 else 2
            prev_dilation = dilation
            if cfg.dilation and i == 3:   # replace_stride_with_dilation
                dilation *= stride
                stride = 1
            blocks = []
            for b in range(depth):
                blocks.append(Bottleneck(inplanes, width, stride if b == 0 else 1,
                                         prev_dilation if b == 0 else dilation, b == 0))
                inplanes = 4 * width
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))


class ResNet(nn.Module):
    """Returns a list of (B, H, W, C) feature maps for cfg.out_indices."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        self.body = ResNetBody(cfg)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        """images: (B, H, W, 3)."""
        body = self.body
        x = F.relu(body.bn1(body.conv1(images.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        remat = self.cfg.use_checkpoint and self.training and torch.is_grad_enabled()
        outs = []
        for i in range(len(self.cfg.depths)):
            for blk in getattr(body, f"layer{i + 1}"):
                x = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
            if i in self.cfg.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return outs


def frozen_param_keys(train_backbone: bool = True) -> Tuple[str, ...]:
    """Name substrings of the parameters the optimizer never changes, the
    reference's requires_grad policy (backbone.py:82-89): the stem and
    layer1 always, the whole trunk when the backbone does not train.  The
    FrozenBN statistics are buffers and never reach the optimizer."""
    if not train_backbone:
        return (BODY_PREFIX,)
    return (BODY_PREFIX + "conv1.", BODY_PREFIX + "layer1.")
