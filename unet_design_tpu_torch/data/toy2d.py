"""2D toy datasets for the MLP score network.

Port of ``unet_design_tpu/data/toy2d.py`` (itself
``torch_ddpm/ddpm/data/two_dim.py``): mixture, scurve, swiss, moon,
circle, checker, pinwheel, 8gaussians, returned as ``(N, 2)`` float32
samples scaled as in the reference.  No entry point of either package
calls it; it is kept for parity.

The JAX module draws the S curve, Swiss roll, moons and circles with
scikit-learn's ``make_*`` generators; here they are written out in numpy,
with the ``np.random.RandomState(seed)`` that scikit-learn builds from an
integer seed and the same draws in the same order (the shuffle of moons
and circles and the zero-scaled noise included), so no scikit-learn is
needed.
"""

from __future__ import annotations

import numpy as np


def _shuffle_and_noise(X: np.ndarray, gen: np.random.RandomState
                       ) -> np.ndarray:
    """scikit-learn's ``shuffle=True`` (a permutation of the row indices),
    then its ``noise=0.0`` draw, which adds zeros."""
    idx = np.arange(len(X))
    gen.shuffle(idx)
    X = X[idx]
    return X + gen.normal(scale=0.0, size=X.shape)


def _s_curve(n: int, gen: np.random.RandomState) -> np.ndarray:
    """``sklearn.datasets.make_s_curve(n, noise=0.0)``'s points (n, 3)."""
    t = 3 * np.pi * (gen.uniform(size=(1, n)) - 0.5)
    X = np.empty((n, 3), np.float64)
    X[:, 0] = np.sin(t)
    X[:, 1] = 2.0 * gen.uniform(size=n)
    X[:, 2] = np.sign(t) * (np.cos(t) - 1)
    return X + 0.0 * gen.standard_normal(size=(3, n)).T


def _swiss_roll(n: int, gen: np.random.RandomState) -> np.ndarray:
    """``sklearn.datasets.make_swiss_roll(n, noise=0.0)``'s points (n, 3)."""
    t = 1.5 * np.pi * (1 + 2 * gen.uniform(size=n))
    y = 21 * gen.uniform(size=n)
    X = np.vstack((t * np.cos(t), y, t * np.sin(t)))
    return (X + 0.0 * gen.standard_normal(size=(3, n))).T


def _moons(n: int, gen: np.random.RandomState) -> np.ndarray:
    """``sklearn.datasets.make_moons(n, noise=0.0)``'s points (n, 2)."""
    n_out, n_in = n // 2, n - n // 2
    a_out, a_in = np.linspace(0, np.pi, n_out), np.linspace(0, np.pi, n_in)
    X = np.vstack([np.append(np.cos(a_out), 1 - np.cos(a_in)),
                   np.append(np.sin(a_out), 1 - np.sin(a_in) - 0.5)]).T
    return _shuffle_and_noise(X, gen)


def _circles(n: int, gen: np.random.RandomState,
             factor: float) -> np.ndarray:
    """``sklearn.datasets.make_circles(n, noise=0.0, factor=factor)``'s
    points (n, 2)."""
    n_out, n_in = n // 2, n - n // 2
    a_out = np.linspace(0, 2 * np.pi, n_out, endpoint=False)
    a_in = np.linspace(0, 2 * np.pi, n_in, endpoint=False)
    X = np.vstack([np.append(np.cos(a_out), np.cos(a_in) * factor),
                   np.append(np.sin(a_out), np.sin(a_in) * factor)]).T
    return _shuffle_and_noise(X, gen)


def two_dim(npar: int, data: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if data == "mixture":
        x = rng.standard_normal((npar, 2))
        p = npar // 2
        x[:p, 0] -= 7.0
        x[p:, 0] += 7.0
        return x.astype(np.float32)
    if data in ("scurve", "swiss", "moon", "circle"):
        gen = np.random.RandomState(seed)
        if data in ("scurve", "swiss"):
            X = (_s_curve if data == "scurve" else _swiss_roll)(npar, gen)
            x = X[:, [0, 2]]
            x = (x - x.mean()) / x.std() * 7
        elif data == "moon":
            X = _moons(npar, gen)
            x = (X - X.mean()) / X.std() * 7.0
        else:
            x = _circles(npar, gen, factor=0.5) * 10
        return np.asarray(x, np.float32)
    if data == "checker":
        x1 = rng.random(npar) * 4 - 2
        x2_ = rng.random(npar) - rng.integers(0, 2, npar) * 2
        x2 = x2_ + (np.floor(x1) % 2)
        return (np.stack([x1, x2], axis=1) * 7.5).astype(np.float32)
    if data == "pinwheel":
        radial_std, tangential_std = 0.3, 0.1
        num_classes, rate = 5, 0.25
        num_per_class = npar // num_classes
        rads = np.linspace(0, 2 * np.pi, num_classes, endpoint=False)
        features = rng.standard_normal((num_classes * num_per_class, 2)) \
            * np.array([radial_std, tangential_std])
        features[:, 0] += 1.0
        labels = np.repeat(np.arange(num_classes), num_per_class)
        angles = rads[labels] + rate * np.exp(features[:, 0])
        rotations = np.stack([np.cos(angles), -np.sin(angles),
                              np.sin(angles), np.cos(angles)])
        rotations = rotations.T.reshape(-1, 2, 2)
        x = 7.5 * rng.permutation(
            np.einsum("ti,tij->tj", features, rotations))
        return x.astype(np.float32)
    if data == "8gaussians":
        scale = 4.0
        centers = [(1, 0), (-1, 0), (0, 1), (0, -1),
                   (1 / np.sqrt(2), 1 / np.sqrt(2)),
                   (1 / np.sqrt(2), -1 / np.sqrt(2)),
                   (-1 / np.sqrt(2), 1 / np.sqrt(2)),
                   (-1 / np.sqrt(2), -1 / np.sqrt(2))]
        centers = scale * np.asarray(centers)
        idx = rng.integers(0, 8, npar)
        x = rng.standard_normal((npar, 2)) * 0.5 + centers[idx]
        return (x / 1.414).astype(np.float32)
    raise ValueError(f"unknown 2D toy dataset {data!r}")
