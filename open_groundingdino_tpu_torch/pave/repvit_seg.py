"""RepViT + Semantic-FPN car segmentor for the PAVE crop pipeline: the port of
the JAX package's pave/repvit_seg.py as a torch `nn.Module`.

The reference's single-image PAVE flow first runs an mmseg Semantic-FPN
segmentor with a RepViT backbone over the frame, takes the car-class mask,
and derives a tight bbox that seeds the sliding-crop grid
(reference inference_on_a_image_pave.py:187-283 ``repvit_stuff`` and
:337-357 ``get_tight_bbox``).  The architecture (RepViT, CVPR'24, M1.1
scaling by default):
  stem:   3x3/s2 conv-BN -> GELU -> 3x3/s2 conv-BN            (1/4 scale)
  stages: RepViT blocks = RepVGG-style depthwise token mixer
          (3x3 dw conv-BN + 1x1 dw conv + identity, then BN) -> optional SE
          (every other block) -> residual 2x channel-mixer FFN
  downsample between stages: stride-2 dw conv-BN -> SE -> 1x1 conv-BN to
          the new width, then a residual FFN.
  head:   FPN neck (1x1 laterals, nearest top-down upsample+add, 3x3 outs)
          + mmseg-style FPNHead (per-level 3x3 conv-GN-ReLU scale heads
          upsampled to 1/4 scale, summed, 1x1 classifier).

Inference-only: BN is the frozen affine form `x * scale + bias`.  The modules
compute in NCHW; RepViTBackbone, SemanticFPN and RepViTSegmentor take and
return the JAX package's NHWC shapes.  The two resizes follow
`jax.image.resize`: "nearest" samples at half-pixel centres, with XLA's
rounding (nearest_index), "bilinear" is half-pixel bilinear that
antialiases when it shrinks (`F.interpolate(..., antialias=True)`).

The segmentor's checkpoint is a `torch.save` state dict (save_segmentor /
load_segmentor); utils/convert.repvit_state_dict_from_jax_params carries a
JAX segmentor's parameter tree across.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD


@dataclass(frozen=True)
class RepViTConfig:
    """M1.1 scaling by default: 4 stages, widths x2 per stage, SE on every
    other non-downsample block (paper Table 1)."""

    widths: Tuple[int, ...] = (64, 128, 256, 512)
    depths: Tuple[int, ...] = (2, 2, 12, 2)
    num_classes: int = 2          # background / car
    car_class: int = 1
    fpn_dim: int = 128            # mmseg sem_fpn's default is 256; PAVE's
    # checkpoint config is private, so it stays configurable

    @staticmethod
    def from_name(name: str) -> "RepViTConfig":
        if name in ("m0_9", "repvit_m0_9"):
            return RepViTConfig(widths=(48, 96, 192, 384), depths=(2, 2, 14, 2))
        if name in ("m1_1", "repvit_m1_1"):
            return RepViTConfig()
        if name in ("m1_5", "repvit_m1_5"):
            return RepViTConfig(widths=(64, 128, 256, 512), depths=(4, 4, 24, 4))
        if name in ("m2_3", "repvit_m2_3"):
            return RepViTConfig(widths=(80, 160, 320, 640), depths=(6, 6, 34, 2))
        if name == "nano_test":  # test-sized, mirrors swin_nano_test
            return RepViTConfig(widths=(8, 16, 24, 32), depths=(1, 1, 2, 1), fpn_dim=16)
        raise ValueError(f"unknown RepViT variant {name!r}")


class FrozenBN(nn.Module):
    """Inference BatchNorm as an affine (scale, bias) pair: the deploy form
    after folding the running statistics (fold_torch_bn)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return x * self.scale[:, None, None] + self.bias[:, None, None]


class ConvBN(nn.Sequential):
    """A bias-free conv (symmetric k//2 padding) and its FrozenBN."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=False)
        self.bn = FrozenBN(cout)


class SqueezeExcite(nn.Module):
    """SE with the paper's 1/4 reduction (at least 8 units), ReLU, and a
    hard-sigmoid gate clip(s / 6 + 0.5, 0, 1)."""

    def __init__(self, c: int):
        super().__init__()
        hidden = max(c // 4, 8)
        self.fc1 = nn.Conv2d(c, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, c, 1)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * torch.clamp(s / 6.0 + 0.5, 0.0, 1.0)


class RepVGGDW(nn.Module):
    """Additive 3x3-dw + 1x1-dw + identity token mixer, then a FrozenBN."""

    def __init__(self, c: int):
        super().__init__()
        self.dw3 = ConvBN(c, c, 3, groups=c)
        self.dw1 = nn.Conv2d(c, c, 1, groups=c, bias=False)
        self.out_bn = FrozenBN(c)

    def forward(self, x):
        return self.out_bn(self.dw3(x) + self.dw1(x) + x)


def _ffn(x, up: ConvBN, down: ConvBN):
    """The residual 2x channel-mixer FFN (1x1 conv-BN, exact GELU, 1x1 conv-BN)."""
    return x + down(F.gelu(up(x), approximate="none"))


class RepViTBlock(nn.Module):
    def __init__(self, c: int, use_se: bool):
        super().__init__()
        self.mixer = RepVGGDW(c)
        self.se = SqueezeExcite(c) if use_se else None
        self.ffn_up = ConvBN(c, 2 * c, 1)
        self.ffn_down = ConvBN(2 * c, c, 1)

    def forward(self, x):
        x = self.mixer(x)
        if self.se is not None:
            x = self.se(x)
        return _ffn(x, self.ffn_up, self.ffn_down)


class RepViTDownsample(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.dw = ConvBN(cin, cin, 3, stride=2, groups=cin)
        self.se = SqueezeExcite(cin)
        self.pw = ConvBN(cin, cout, 1)
        self.ffn_up = ConvBN(cout, 2 * cout, 1)
        self.ffn_down = ConvBN(2 * cout, cout, 1)

    def forward(self, x):
        return _ffn(self.pw(self.se(self.dw(x))), self.ffn_up, self.ffn_down)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class RepViTBackbone(nn.Module):
    """Stem, then per stage s a downsample (s > 0) and its blocks
    (`down{s}`, `stage{s}_block{b}`, the JAX package's names)."""

    def __init__(self, cfg: RepViTConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.widths
        self.stem0 = ConvBN(3, w[0] // 2, 3, stride=2)
        self.stem1 = ConvBN(w[0] // 2, w[0], 3, stride=2)
        for s, (width, depth) in enumerate(zip(w, cfg.depths)):
            if s > 0:
                self.add_module(f"down{s}", RepViTDownsample(w[s - 1], width))
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", RepViTBlock(width, b % 2 == 0))

    def features(self, x) -> List[torch.Tensor]:
        """NCHW image -> the 1/4, 1/8, 1/16, 1/32 NCHW feature maps."""
        x = self.stem1(F.gelu(self.stem0(x), approximate="none"))
        feats = []
        for s, depth in enumerate(self.cfg.depths):
            if s > 0:
                x = getattr(self, f"down{s}")(x)
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x)
            feats.append(x)
        return feats

    def forward(self, images):
        """(B, H, W, 3) -> the four (B, h, w, C) NHWC feature maps."""
        return [_nhwc(f) for f in self.features(_nchw(images))]


def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """The input pixel of each output pixel under jax.image.resize(...,
    "nearest"): floor((i + 0.5) * in / out), which XLA computes as
    (i + 0.5) * f32(f32(in) * f32(1 / out)) (its simplifier turns the
    division by a constant into a product with the reciprocal).  Where
    (i + 0.5) * in / out is an integer (the middle pixel of an odd-sized
    upsample of an even size, e.g. 10 -> 19) that can land one pixel lower
    than the exact quotient, and F.interpolate's "nearest-exact" (its scale
    rounded once, in/out) lands elsewhere at other sizes (42 -> 83 among
    others)."""
    scale = np.float32(n_in) * (np.float32(1.0) / np.float32(n_out))
    return np.floor((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * scale).astype(np.int64)


def resize_nearest(x, hw):
    """jax.image.resize(..., "nearest") of an NCHW tensor (nearest_index)."""
    for dim, n_out in ((2, hw[0]), (3, hw[1])):
        if x.shape[dim] != n_out:
            index = torch.from_numpy(nearest_index(x.shape[dim], n_out))
            x = x.index_select(dim, index.to(x.device))
    return x


def resize_bilinear(x, hw):
    """jax.image.resize(..., "bilinear") of an NCHW tensor: half-pixel
    bilinear, antialiased where it shrinks."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                         antialias=True)


class SemanticFPN(nn.Module):
    """mmseg ``sem_fpn``: FPN neck + FPNHead, logits at 1/4 scale."""

    def __init__(self, cfg: RepViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.fpn_dim
        # largest power-of-two divisor of d up to 32, so any fpn_dim works
        groups = math.gcd(d, 32)
        for i, w in enumerate(cfg.widths):
            self.add_module(f"lateral{i}", nn.Conv2d(w, d, 1))
        for i in range(len(cfg.widths)):
            self.add_module(f"fpn_out{i}", nn.Conv2d(d, d, 3, padding=1))
        for i in range(len(cfg.widths)):
            # one conv-GN-ReLU (+2x upsample) per octave above the base scale
            for r in range(max(1, i)):
                self.add_module(f"scale{i}_conv{r}", nn.Conv2d(d, d, 3, padding=1))
                self.add_module(f"scale{i}_gn{r}", nn.GroupNorm(groups, d, eps=1e-5))
        self.cls = nn.Conv2d(d, cfg.num_classes, 1)

    def logits(self, feats: List[torch.Tensor]) -> torch.Tensor:
        """NCHW features -> NCHW logits at the first map's scale."""
        n = len(feats)
        lat = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        for i in range(n - 2, -1, -1):
            lat[i] = lat[i] + resize_nearest(lat[i + 1], lat[i].shape[2:])
        outs = [getattr(self, f"fpn_out{i}")(l) for i, l in enumerate(lat)]
        base = outs[0].shape[2:]
        acc = None
        for i, o in enumerate(outs):
            for r in range(max(1, i)):
                o = F.relu(getattr(self, f"scale{i}_gn{r}")(getattr(self, f"scale{i}_conv{r}")(o)))
                if o.shape[2] != base[0]:
                    o = resize_bilinear(o, (min(base[0], o.shape[2] * 2),
                                            min(base[1], o.shape[3] * 2)))
            acc = o if acc is None else acc + o
        return self.cls(acc)

    def forward(self, feats):
        """NHWC features -> (B, h, w, num_classes) NHWC logits."""
        return _nhwc(self.logits([_nchw(f) for f in feats]))


class RepViTSegmentor(nn.Module):
    """Whole-frame semantic segmentation: logits upsampled to input size."""

    def __init__(self, cfg: Optional[RepViTConfig] = None):
        super().__init__()
        self.cfg = cfg or RepViTConfig()
        self.backbone = RepViTBackbone(self.cfg)
        self.head = SemanticFPN(self.cfg)

    def forward(self, images):
        """(B, H, W, 3) normalized images -> (B, H, W, num_classes) logits."""
        x = _nchw(images)
        logits = self.head.logits(self.backbone.features(x))
        return _nhwc(resize_bilinear(logits, x.shape[2:]))


def init_segmentor(cfg: Optional[RepViTConfig] = None, seed: int = 0,
                   device="cuda") -> RepViTSegmentor:
    """A RepViTSegmentor with torch's default initialisation drawn from
    `seed` on the CPU (the global generator's state is left as it was), in
    eval mode on `device`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = RepViTSegmentor(cfg)
    return model.to(device).eval()


@torch.no_grad()
def segment_car_mask(model: RepViTSegmentor, images) -> torch.Tensor:
    """argmax-class mask (B, H, W) == cfg.car_class of normalized NHWC
    images (a tensor or an array), on the model's device."""
    images = torch.as_tensor(images, dtype=torch.float32,
                             device=next(model.parameters()).device)
    return model(images).argmax(-1) == model.cfg.car_class


def car_mask_to_bbox(mask) -> Optional[Tuple[float, float, float, float]]:
    """Tight bbox over mask-true pixels, (x0, y0, x1, y1) frame pixels.

    The reference's ``get_tight_bbox`` (inference_on_a_image_pave.py:337-357)
    takes per-axis min/max of a masked meshgrid whose "x" axis is the ROW
    axis; this returns the crop_utils (x=col, y=row) ordering the crop grid
    expects, and None for an empty mask (the reference would crash on it)."""
    mask = mask.cpu().numpy() if torch.is_tensor(mask) else np.asarray(mask)
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return None
    return float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())


def frame_input(image: np.ndarray, infer_size: Tuple[int, int], device) -> torch.Tensor:
    """(H, W, 3) uint8 frame -> (1, ih, iw, 3) f32 segmentor input on
    `device`: /255, bilinear resize to infer_size (antialiased), ImageNet
    normalization."""
    x = torch.tensor(np.asarray(image), dtype=torch.float32, device=device)[None] / 255.0
    x = _nhwc(resize_bilinear(_nchw(x), infer_size))
    mean, std = (torch.from_numpy(v).to(device) for v in (IMAGENET_MEAN, IMAGENET_STD))
    return (x - mean) / std


def derive_car_bbox(model: RepViTSegmentor, image: np.ndarray,
                    infer_size: Tuple[int, int] = (512, 1024),
                    ) -> Optional[Tuple[float, float, float, float]]:
    """Frame -> car bbox: resize to the inference size (multiple of 32),
    segment, tight-bbox, rescale to frame pixels."""
    H, W = image.shape[:2]
    ih, iw = infer_size
    x = frame_input(image, infer_size, next(model.parameters()).device)
    bbox = car_mask_to_bbox(segment_car_mask(model, x)[0])
    if bbox is None:
        return None
    sx, sy = W / iw, H / ih
    x0, y0, x1, y1 = bbox
    return x0 * sx, y0 * sy, x1 * sx, y1 * sy


def save_segmentor(model: RepViTSegmentor, path: str) -> None:
    """The segmentor's state dict, by torch.save."""
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)


def load_segmentor(path: str, cfg: Optional[RepViTConfig] = None,
                   device="cuda") -> RepViTSegmentor:
    """A segmentor of `cfg` (M1.1 by default) on `device`, with the state
    dict saved by save_segmentor loaded strictly (names and shapes)."""
    model = RepViTSegmentor(cfg)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True), strict=True)
    return model.to(device).eval()


def fold_torch_bn(state_dict, prefix: str, eps: float = 1e-5):
    """torch BatchNorm at ``prefix`` of a state dict -> FrozenBN {scale,
    bias} (the running statistics folded in)."""
    w = torch.as_tensor(state_dict[f"{prefix}.weight"]).float()
    b = torch.as_tensor(state_dict[f"{prefix}.bias"]).float()
    m = torch.as_tensor(state_dict[f"{prefix}.running_mean"]).float()
    v = torch.as_tensor(state_dict[f"{prefix}.running_var"]).float()
    scale = w / torch.sqrt(v + eps)
    return {"scale": scale, "bias": b - m * scale}
