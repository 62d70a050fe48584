"""Legacy WMH-challenge U-Net (the 2017 challenge-winning ensemble member).

Port of ``unet_design_tpu/models/wmh_legacy.py`` (``_crop_like``,
``WMHLegacyUnet``), itself a re-design of the reference's Keras network
(``wmh/train_leave_one_out.py:56-113``), the model of the legacy
leave-one-out protocol.  Channel plan 64/96/128/256/512; ``first5`` sets the
kernel of the first two convolutions (5, else 3), the ensemble's two arms.
Kept as in the JAX model:

- the second convolution of ``c4`` has kernel 4 with TF-style 'SAME'
  padding, one row and column before and two after, padded explicitly;
- max-pools are VALID (floor), so 200 -> 100 -> 50 -> 25 -> 12; on the way
  up each skip is cropped to the upsampled map, an odd difference taking
  the extra row or column from the end; the last map is zero-padded back
  to the input size, the extra row or column at the end;
- a one-channel sigmoid head, computed in fp32.

I/O is NHWC ``(B, H, W, 2) -> (B, H, W, 1)``; inside, NCHW.  The 19
convolutions are ``convs.0`` .. ``convs.18`` in the order flax creates them
(``Conv_0`` .. ``Conv_18``, all at the top level), which is how
``models/convert.py`` maps the JAX parameters.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_design_tpu_torch.models import common


def _crop_like(target: torch.Tensor, refer: torch.Tensor) -> torch.Tensor:
    """Keras ``Cropping2D(get_crop_shape(target, refer))`` on NCHW: trim
    ``target`` (the skip) to ``refer``'s H, W, an odd difference cropping
    one extra row or column from the end (``train_leave_one_out.py:39-54``)."""
    dh = target.shape[2] - refer.shape[2]
    dw = target.shape[3] - refer.shape[3]
    if dh < 0 or dw < 0:
        raise ValueError(f"cannot crop {tuple(target.shape)} to "
                         f"{tuple(refer.shape)}")
    h0, w0 = dh // 2, dw // 2
    return target[:, :, h0:h0 + refer.shape[2], w0:w0 + refer.shape[3]]


def _same_pad(k: int):
    """flax / TF 'SAME' at stride 1: ``k - 1`` in all, the larger half
    after."""
    lo = (k - 1) // 2
    return lo, k - 1 - lo


class WMHLegacyUnet(nn.Module):
    """4-level crop-concat U-Net, channels (64, 96, 128, 256, 512)."""

    FLAX_ROOT_PREFIXES = {"Conv_": "convs."}   # see models/convert.py

    def __init__(self, first5: bool = True, in_channels: int = 2):
        super().__init__()
        k1 = 5 if first5 else 3
        # (in, out, kernel) in flax's creation order
        plan = [(in_channels, 64, k1), (64, 64, k1), (64, 96, 3),
                (96, 96, 3), (96, 128, 3), (128, 128, 3), (128, 256, 3),
                (256, 256, 4), (256, 512, 3), (512, 512, 3),
                (512 + 256, 256, 3), (256, 256, 3), (256 + 128, 128, 3),
                (128, 128, 3), (128 + 96, 96, 3), (96, 96, 3),
                (96 + 64, 64, 3), (64, 64, 3), (64, 1, 1)]
        self.kernels = [k for _, _, k in plan]
        # an odd kernel pads evenly inside the convolution; the even one
        # is padded before it, unevenly
        self.convs = nn.ModuleList(
            nn.Conv2d(i, o, k, padding=k // 2 if k % 2 else 0)
            for i, o, k in plan)

    def _cbr(self, i: int, h: torch.Tensor) -> torch.Tensor:
        k = self.kernels[i]
        if k % 2 == 0:
            lo, hi = _same_pad(k)
            h = F.pad(h, (lo, hi, lo, hi))
        return F.relu(self.convs[i](h))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pool = lambda h: F.max_pool2d(h, 2)
        up = lambda h: F.interpolate(h, scale_factor=2, mode="nearest")
        h_in = common.to_nchw(x.float())
        c1 = self._cbr(1, self._cbr(0, h_in))
        c2 = self._cbr(3, self._cbr(2, pool(c1)))
        c3 = self._cbr(5, self._cbr(4, pool(c2)))
        c4 = self._cbr(7, self._cbr(6, pool(c3)))   # kernel-4 quirk kept
        h = self._cbr(9, self._cbr(8, pool(c4)))
        for i, skip in zip((10, 12, 14, 16), (c4, c3, c2, c1)):
            u = up(h)
            h = torch.cat([u, _crop_like(skip, u)], dim=1)
            h = self._cbr(i + 1, self._cbr(i, h))
        dh = x.shape[1] - h.shape[2]
        dw = x.shape[2] - h.shape[3]
        h = F.pad(h, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        out = self.convs[18](h)
        return torch.sigmoid(out.float()).permute(0, 2, 3, 1)
