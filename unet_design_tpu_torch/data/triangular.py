"""Triangular-domain MNIST: IFS address maps and square<->triangle swapping.

The port's own copy of ``unet_design_tpu/data/triangular.py`` (pure numpy,
so it computes the same arrays bit for bit), itself a port of
``diff_mnist/data.py:17-214``: the MNIST digit is embedded in a 64x64
triangular domain; an iterated-function-system (IFS) address grid maps
pixel coordinates between the unit square and the Sierpinski-style
triangle, and ``scipy.interpolate.griddata`` (nearest) resamples the image
between the two coordinate systems ("square-swap").  Offline
preprocessing, vectorised over all 4^J addresses; scipy is imported only
by the square-swap, which the default dataset does not use.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

# The two IFS systems (data.py:96-110): four affine maps each.
# Maps are applied innermost-digit-first over the address string.


def _apply_square(digit: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Square IFS: quadrant subdivision."""
    out = x / 2.0
    out[..., 0] += 0.5 * np.isin(digit, (2, 3))
    out[..., 1] += 0.5 * np.isin(digit, (1, 3))
    return out


def _apply_tri(digit: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Triangle IFS: three quadrants plus one flipped center map."""
    flip = digit == 3
    out = np.where(flip[..., None], -x / 2.0 + 0.5, x / 2.0)
    out[..., 0] += 0.5 * (digit == 2)
    out[..., 1] += 0.5 * (digit == 1)
    return out


def address_digit_grid(J: int) -> np.ndarray:
    """The (2^J, 2^J, J) grid of address digits.

    Equivalent to ``get_addresses`` (``data.py:182-194``): the J-fold string
    Kronecker product of [['0','1'],['2','3']], with digit k of the string at
    depth k (outermost first).
    """
    n = 2 ** J
    rows = np.arange(n)
    cols = np.arange(n)
    digits = np.empty((n, n, J), dtype=np.int8)
    for k in range(J):
        # depth k selects bit (J-1-k) of (row, col)
        rbit = (rows >> (J - 1 - k)) & 1
        cbit = (cols >> (J - 1 - k)) & 1
        digits[:, :, k] = (rbit[:, None] * 2 + cbit[None, :]).astype(np.int8)
    return digits


def eval_points(apply_map: Callable, J: int,
                x_center: Sequence[float]) -> np.ndarray:
    """Evaluate the IFS at every address (``get_eval_points``, data.py:131-151).

    The reference applies maps innermost (last) digit first.
    """
    digits = address_digit_grid(J)
    n = 2 ** J
    x = np.broadcast_to(np.asarray(x_center, np.float64), (n, n, 2)).copy()
    for k in range(J - 1, -1, -1):
        x = apply_map(digits[:, :, k], x)
    return x


def swap_array(img: np.ndarray, in_array: np.ndarray, out_array: np.ndarray,
               method: str = "nearest") -> np.ndarray:
    """Resample img from in_array coordinates onto out_array coordinates
    (``data.py:153-166``)."""
    from scipy.interpolate import griddata
    m = out_array.shape[0]
    src = in_array.reshape(-1, 2)
    vals = img.reshape(-1)
    dst = out_array.reshape(-1, 2)
    out = griddata(src, vals, dst, method=method)
    return out.reshape(m, m)


class TriangularPreprocessor:
    """``Preprocess_triangular`` (``data.py:91-129``)."""

    def __init__(self, J: int):
        self.J = J
        self.square_array = eval_points(_apply_square, J, (0.5, 0.5))
        self.tri_array = eval_points(_apply_tri, J, (1 / 3, 1 / 3))

    def to_square(self, img: np.ndarray) -> np.ndarray:
        """Triangular-domain image -> square-domain (process_mnist_triangular)."""
        image = np.rot90(img, 3)
        return swap_array(image, self.square_array, self.tri_array)

    def to_triangle(self, img: np.ndarray) -> np.ndarray:
        """Inverse resampling (square-domain -> triangular-domain)."""
        out = swap_array(img, self.tri_array, self.square_array)
        return np.rot90(out, 1)


def make_triangular_dataset(mnist_images: np.ndarray, size: int = 64,
                            shift: int = 5, gray: float = 0.5,
                            to_square_preprocess: bool = False) -> np.ndarray:
    """Embed MNIST digits in the triangular domain (``data.py:17-88``).

    Args:
      mnist_images: (N, 28, 28) uint8 or float array.
    Returns:
      (N, size, size, 1) float32 in [0, 1].
    """
    imgs = np.asarray(mnist_images, np.float32)
    if imgs.max() > 1.5:
        imgs = imgs / 255.0
    background = float(imgs[:, 0:2, 0:2].mean())
    n = imgs.shape[0]
    data = np.full((n, size, size), background, np.float32)
    data[:, size - shift - 28: size - shift, shift: shift + 28] = imgs
    # gray out the upper-right half above the diagonal
    for i in range(size):
        data[:, i, i:] = gray
    if to_square_preprocess:
        pre = TriangularPreprocessor(J=int(np.log2(size)))
        data = np.stack([pre.to_square(im) for im in data]).astype(np.float32)
    return data[..., None]
