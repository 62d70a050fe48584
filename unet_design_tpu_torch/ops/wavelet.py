"""Haar wavelet (DWT) primitives on NHWC tensors.

Port of ``unet_design_tpu/ops/wavelet.py``.  One octave of the Haar LL band,
rescaled by ``1/2`` back to the data range, is a zero-padded 2x2 average
pooling, so J octaves are J chained 2x2 means (odd sizes are zero-padded on
the bottom/right first, and the zeros take part in the mean: the reference's
'zero' boundary mode).  These are plain tensor ops; the one kernel of this
module's family, the multi-level pyramid for the multi-resolution-loss
targets, lives in :mod:`unet_design_tpu_torch.ops.haar` and plugs in through
the ``pyramid_fn`` hook of :func:`multires_targets_traj`.

All functions take NHWC ``(B, H, W, C)`` tensors, the JAX package's layout.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F


def _pad_to_even(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad H and W (bottom/right) to even sizes ('zero' boundary mode)."""
    ph, pw = x.shape[1] % 2, x.shape[2] % 2
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    return x


def haar_downsample_once(x: torch.Tensor) -> torch.Tensor:
    """One octave of Haar LL downsampling: the zero-padded 2x2 mean, taken in
    fp32 and cast back.  ``(B, H, W, C) -> (B, ceil(H/2), ceil(W/2), C)``."""
    x = _pad_to_even(x)
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.float().mean(dim=(2, 4)).to(x.dtype)


def haar_downsample(x: torch.Tensor, octaves: int) -> torch.Tensor:
    """J-octave Haar LL downsample with the ``1/2^J`` rescale; J=0 is the
    identity."""
    for _ in range(octaves):
        x = haar_downsample_once(x)
    return x


def haar_upsample_once(ll: torch.Tensor) -> torch.Tensor:
    """Haar synthesis from the LL band only: each pixel fills its 2x2 block."""
    b, h, w, c = ll.shape
    x = ll[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)


def channel_tile(x: torch.Tensor, out_channels: int) -> torch.Tensor:
    """Tile channels to ``out_channels``: whole-tensor channel tiling, then
    truncation (the reference's ``repeat(1, C_out // C_in + 1, 1, 1)[:, :C_out]``),
    so widths that are not a multiple work too."""
    c = x.shape[-1]
    if c == out_channels:
        return x
    reps = out_channels // c + 1
    return x.repeat(1, 1, 1, reps)[..., :out_channels]


def dwt_block(x: torch.Tensor, octaves: int, out_channels: int
              ) -> torch.Tensor:
    """The reference ``DWTBlock``: J-octave LL downsample, channel tiling."""
    return channel_tile(haar_downsample(x, octaves), out_channels)


def dwt_pyramid(x: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """All LL bands ``[x, down(x, 1), ..., down(x, n_levels - 1)]``, each
    level from the previous one, fine to coarse."""
    out = [x]
    for _ in range(n_levels - 1):
        out.append(haar_downsample_once(out[-1]))
    return out


def multires_targets(x: torch.Tensor, n_levels: int, n_downsample: int = 0
                     ) -> List[torch.Tensor]:
    """Per-level multi-resolution-loss targets in decoder order (coarsest
    first): ``x`` downsampled by ``k - n_downsample`` octaves for
    ``k = n_levels-1 .. 0``, negative counts dropped."""
    ks = [k - n_downsample for k in reversed(range(n_levels))]
    ks = [k for k in ks if k >= 0]
    if not ks:
        return []
    pyr = dwt_pyramid(x, max(ks) + 1)
    return [pyr[k] for k in ks]


# ----------------------------------------------------------------------------
# 5-D trajectory helpers (PDE workloads): (B, T, H, W, C)
# ----------------------------------------------------------------------------

def haar_downsample_traj(x: torch.Tensor, octaves: int) -> torch.Tensor:
    """J-octave Haar downsample of every frame of ``(B, T, H, W, C)``."""
    b, t = x.shape[:2]
    y = haar_downsample(x.reshape(b * t, *x.shape[2:]), octaves)
    return y.reshape(b, t, *y.shape[1:])


PyramidFn = Callable[[torch.Tensor, int], List[torch.Tensor]]


def multires_targets_traj(y: torch.Tensor, n_levels: int, n_downsample: int,
                          pyramid_fn: Optional[PyramidFn] = None
                          ) -> List[torch.Tensor]:
    """Decoder-order multi-res targets for a trajectory ``(B, T, H, W, C)``:
    octaves ``n_downsample .. n_levels-1`` of ``y``, coarsest first.

    ``y`` is first downsampled by ``n_downsample`` octaves, then the
    incremental pyramid is taken with ``pyramid_fn`` (default
    :func:`dwt_pyramid`; the trainer passes ``ops.haar.haar_pyramid``, whose
    CUDA kernel needs a contiguous input).
    """
    base = haar_downsample_traj(y, n_downsample)
    n = n_levels - n_downsample
    b, t = base.shape[:2]
    frames = base.reshape(b * t, *base.shape[2:]).contiguous()
    pyr = (pyramid_fn or dwt_pyramid)(frames, n)
    pyr = [p.reshape(b, t, *p.shape[1:]) for p in pyr]
    return pyr[::-1]
