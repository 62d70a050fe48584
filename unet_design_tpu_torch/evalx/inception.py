"""The FID InceptionV3 (pytorch-fid's ``pt_inception``) on NHWC images.

Port of ``unet_design_tpu/evalx/inception.py``: torchvision's
``inception_v3`` (``num_classes=1008``, no auxiliary head) with the FID
patches of ``diff_cifar/score/inception.py``:

- every convolution is bias-free and followed by an inference BatchNorm
  (``eps=1e-3``, running statistics only) and a ReLU (:class:`BasicConv`);
- InceptionA, InceptionC and Mixed_7b pool 3x3 with
  ``count_include_pad=False``; Mixed_7c pools with a 3x3 stride-1 max;
- ``fc`` has no bias; the outputs are blocks 0-4: the first and second max
  pools, the input of Mixed_7a, the global average (2048 features) and the
  softmax over the 1008 logits.

Module names are the ``pt_inception-2015-12-05`` ``.pth`` keys
(``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_var``,
...), so :func:`load_fid_params` is ``torch.load`` and a strict
``load_state_dict``.  The BatchNorms have no training mode: batch
statistics would silently change FID.  Without weights,
:func:`random_init_` draws the JAX evaluator's distribution (flax's
LeCun-normal kernels x sqrt(2), unit BatchNorm) from a torch generator.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_design_tpu_torch.ops import blocks


class FrozenBatchNorm2d(nn.Module):
    """Inference BatchNorm: ``(x - running_mean) / sqrt(running_var + eps)
    * weight + bias``; never updates its statistics."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=self.eps)


class BasicConv(nn.Module):
    """Bias-free conv, inference BatchNorm(eps=1e-3), ReLU."""

    def __init__(self, c_in: int, c_out: int, kernel=(3, 3), stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = FrozenBatchNorm2d(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_nocount(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(c_in, 64, 1)
        self.branch5x5_1 = BasicConv(c_in, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(c_in, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_nocount(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = BasicConv(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, c_in: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv(c_in, 192, 1)
        self.branch7x7_1 = BasicConv(c_in, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(c_in, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(c_in, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                      self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool_nocount(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(c_in, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(c_in, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3,
                      self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    """``pool_mode`` 'avg' (Mixed_7b) or 'max' (Mixed_7c, the FID patch)."""

    def __init__(self, c_in: int, pool_mode: str):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv(c_in, 320, 1)
        self.branch3x3_1 = BasicConv(c_in, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(c_in, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(c_in, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = (_avg_pool_nocount(x) if self.pool_mode == "avg"
              else F.max_pool2d(x, 3, 1, 1))
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """Bilinear resize of an NCHW batch to 299x299 with half-pixel centres
    (``jax.image.resize(method="bilinear")`` when enlarging)."""
    return F.interpolate(x, size=(299, 299), mode="bilinear",
                         align_corners=False)


class InceptionV3FID(nn.Module):
    """``forward(x)``: ``x`` (N, H, W, 3) in [0, 1], resized to 299x299
    unless ``resize_input`` is off and mapped to [-1, 1] -> the list of
    ``output_blocks`` in ascending order; blocks 0-2 NHWC maps, block 3
    (N, 2048) features, block 4 (N, 1008) probabilities.  Every layer is
    built whatever the blocks asked for, so any of them loads the whole
    ``.pth``; the forward stops at the last block asked for."""

    def __init__(self, output_blocks: Sequence[int] = (3,),
                 resize_input: bool = True):
        super().__init__()
        self.output_blocks = tuple(sorted(output_blocks))
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, 1008, bias=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        last = max(self.output_blocks)
        outs: Dict[int, torch.Tensor] = {}
        x = x.permute(0, 3, 1, 2)
        if self.resize_input:
            x = resize_299(x)
        x = 2.0 * x - 1.0
        x = x.contiguous(memory_format=torch.channels_last)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        outs[0] = x
        if last >= 1:
            x = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
            outs[1] = x
        if last >= 2:
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                         "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
                x = getattr(self, name)(x)
            outs[2] = x
        if last >= 3:
            x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
            x = x.mean(dim=(2, 3))
            outs[3] = x
        if last >= 4:
            outs[4] = torch.softmax(self.fc(x), dim=-1)
        return [outs[i].permute(0, 2, 3, 1) if i < 3 else outs[i]
                for i in self.output_blocks]


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX evaluator's random network, redrawn: conv and ``fc`` kernels
    flax LeCun-normal (truncated at two standard deviations) times sqrt(2),
    BatchNorm scale 1, bias 0, mean 0, variance 1
    (``unet_design_tpu/evalx/fid.py:143-157``).  Without the sqrt(2), ~90
    ReLU layers halve the variance and the pool features collapse to
    constants."""
    blocks.flax_default_init_(model, generator)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.weight.mul_(math.sqrt(2.0))
        elif isinstance(m, FrozenBatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return model


def load_fid_params(pth_path: str) -> Dict[str, torch.Tensor]:
    """The ``pt_inception`` ``.pth`` as this module's state dict: ``fc.bias``
    (the FID model has none), ``AuxLogits.*`` and BatchNorm batch counters
    dropped."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items()
            if k != "fc.bias" and not k.startswith("AuxLogits.")
            and not k.endswith("num_batches_tracked")}


def fid_inception(state_dict: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> InceptionV3FID:
    """The evaluator's network (blocks 3 and 4) with ``state_dict`` loaded
    strictly, or else :func:`random_init_` from seed 0."""
    model = InceptionV3FID((3, 4))
    if state_dict is None:
        random_init_(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.requires_grad_(False)
