"""FID, KID and Inception Score of generated images.

Port of ``unet_design_tpu/evalx/fid.py``: activation statistics of the FID
InceptionV3's pool features, the Frechet distance through the Newton-Schulz
matrix square root (fp32 products on the evaluator's device, 100
iterations) with ``scipy.linalg.sqrtm`` in float64 as the fallback, the
unbiased KID and the Inception Score in float64 numpy, and a stats cache
in the reference's ``.npz`` layout (``mu``, ``sigma``; here also ``acts``
for KID and ``feature_version``).

The cache's ``feature_version`` names the network that wrote it; a cache
from another network is refused.  Given weights are ``pretrained``, as in
the JAX package.  The random network is ``random-he-sqrt2-torch``: the same
distribution as the JAX package's ``random-he-sqrt2`` but another draw
(JAX's PRNG cannot be replayed without JAX), so neither reads the other's
cache.  Scores from random weights carry a warning.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch

from unet_design_tpu_torch.evalx.inception import fid_inception
from unet_design_tpu_torch.utils.device import resolve_device

RANDOM_FEATURES = "random-he-sqrt2-torch"
PRETRAINED = "pretrained"
KID_MAX_REF = 10_000      # reference activations a cache keeps for KID


def activation_statistics(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(mu, sigma)`` in float64, ``np.cov`` over rows."""
    return np.mean(acts, axis=0), np.cov(acts, rowvar=False)


def sqrt_newton_schulz(a: torch.Tensor, num_iters: int = 100
                       ) -> torch.Tensor:
    """Matrix square root by the Newton-Schulz iteration, in ``a``'s dtype
    and on its device, in the JAX package's update order."""
    norm_a = torch.linalg.matrix_norm(a)
    y = a / norm_a
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    z = eye
    for _ in range(num_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    return y * torch.sqrt(norm_a)


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6,
                     device: Union[str, torch.device] = "cpu") -> float:
    """``|mu1 - mu2|^2 + Tr(s1 + s2 - 2 sqrt(s1 s2))``.  The square root is
    Newton-Schulz on the fp32 product (on ``device``); where that is not
    finite (a singular or ill-conditioned product), scipy's ``sqrtm`` of
    the float64 product, retried with ``eps`` on the diagonals, real
    part."""
    s1 = torch.as_tensor(sigma1, dtype=torch.float32, device=device)
    s2 = torch.as_tensor(sigma2, dtype=torch.float32, device=device)
    covmean = sqrt_newton_schulz(s1 @ s2).cpu().numpy()
    if not np.isfinite(covmean).all():
        import scipy.linalg
        covmean = np.asarray(scipy.linalg.sqrtm(sigma1 @ sigma2))
        if not np.isfinite(covmean).all():
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
        if np.iscomplexobj(covmean):
            covmean = covmean.real
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def kernel_inception_distance(acts1: np.ndarray, acts2: np.ndarray,
                              n_subsets: int = 100, subset_size: int = 1000,
                              seed: int = 0) -> Tuple[float, float]:
    """Unbiased KID (Binkowski et al. 2018): MMD^2 with the kernel
    ``(x.y / d + 1)^3`` over ``n_subsets`` subsets of ``min(subset_size,
    n1, n2)`` rows drawn by ``RandomState(seed)``, as ``(mean, std)``.  When
    the subsets are the whole sets every draw gives the same value: one
    subset, std 0."""
    d = float(acts1.shape[1])
    m = min(subset_size, len(acts1), len(acts2))
    if m < 2:
        raise ValueError("KID needs at least 2 activations per set")
    if m == len(acts1) and m == len(acts2):
        n_subsets = 1
    rng = np.random.RandomState(seed)
    scores = []
    for _ in range(n_subsets):
        x = acts1[rng.choice(len(acts1), m, replace=False)].astype(np.float64)
        y = acts2[rng.choice(len(acts2), m, replace=False)].astype(np.float64)
        kxx = (x @ x.T / d + 1.0) ** 3
        kyy = (y @ y.T / d + 1.0) ** 3
        kxy = (x @ y.T / d + 1.0) ** 3
        e_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
        e_yy = (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
        scores.append(e_xx + e_yy - 2.0 * kxy.mean())
    std = float(np.std(scores)) if len(scores) > 1 else 0.0
    return float(np.mean(scores)), std


def inception_score_from_probs(probs: np.ndarray, splits: int = 10
                               ) -> Tuple[float, float]:
    """``exp(E_x KL(p(y|x) || p(y)))`` over ``min(splits, n)`` chunks, as
    ``(mean, std)``."""
    scores = []
    n = probs.shape[0]
    splits = max(1, min(splits, n))
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        kl = part * (np.log(part + 1e-16)
                     - np.log(np.mean(part, axis=0, keepdims=True) + 1e-16))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))


class FIDEvaluator:
    """IS, and FID / KID against a stats cache, of images ``(N, H, W, 3)``
    in [0, 1] (``get_inception_and_fid_score``, ``both.py:14-116``).

    Args:
      state_dict: the FID Inception's weights (``inception.load_fid_params``
        of the ``pt_inception`` ``.pth``); ``None`` draws the random network,
        whose scores are not comparable to published ones.
      stats_cache: a ``.npz`` with ``mu`` and ``sigma`` (and ``acts`` for
        KID); an error if it is named and missing, or if another feature
        network wrote it.
      batch_size: images per Inception forward.
      device: where Inception and the Newton-Schulz products run (a CUDA
        device with TF32 off, which would move FID).
    """

    def __init__(self, state_dict: Optional[Mapping[str, torch.Tensor]]
                 = None, stats_cache: Optional[str] = None,
                 batch_size: int = 50,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self._have_weights = state_dict is not None
        self.feature_version = (PRETRAINED if self._have_weights
                                else RANDOM_FEATURES)
        self.ref_stats = None
        self.ref_acts = None
        if stats_cache:
            if not os.path.exists(stats_cache):
                raise FileNotFoundError(f"stats cache {stats_cache!r}: no "
                                        "such file (write it with "
                                        "tasks.compute_fid_stats)")
            d = np.load(stats_cache)
            # the reference's own mu/sigma npz has no tag: pretrained
            tag = (str(d["feature_version"]) if "feature_version" in d
                   else PRETRAINED)
            if tag != self.feature_version:
                raise ValueError(
                    f"stats cache {stats_cache!r} was computed with feature "
                    f"network {tag!r}, evaluator uses "
                    f"{self.feature_version!r}; regenerate the stats "
                    f"(save_reference_stats) - mixing feature spaces makes "
                    f"FID meaningless")
            self.ref_stats = (d["mu"][:], d["sigma"][:])
            self.ref_acts = d["acts"][:] if "acts" in d else None
        self.model = fid_inception(state_dict).to(self.device)

    @torch.no_grad()
    def activations(self, images) -> Tuple[np.ndarray, np.ndarray]:
        """``images`` (N, H, W, 3) in [0, 1], numpy or a tensor on any
        device -> ``(pool features (N, 2048), probabilities (N, 1008))``
        as float32 numpy."""
        feats, probs = [], []
        for s in range(0, len(images), self.batch_size):
            batch = torch.as_tensor(images[s:s + self.batch_size]).to(
                self.device, torch.float32)
            f, p = self.model(batch)
            feats.append(f.cpu().numpy())
            probs.append(p.cpu().numpy())
        return np.concatenate(feats), np.concatenate(probs)

    def compute(self, images) -> dict:
        acts, probs = self.activations(images)
        result = {"inception_score": inception_score_from_probs(probs)}
        if self.ref_stats is not None:
            mu, sigma = activation_statistics(acts)
            result["fid"] = frechet_distance(mu, sigma, *self.ref_stats,
                                             device=self.device)
        if (self.ref_acts is not None and len(acts) >= 2
                and len(self.ref_acts) >= 2):
            result["kid"] = kernel_inception_distance(acts, self.ref_acts)
        if not self._have_weights:
            result["warning"] = ("random InceptionV3 weights - scores are "
                                 "not comparable; provide the FID .pth")
        return result

    def save_reference_stats(self, images, path: str) -> None:
        """Write ``mu``, ``sigma``, up to ``KID_MAX_REF`` activations and
        the ``feature_version`` to ``path`` (``.npz``), and use them."""
        acts, _ = self.activations(images)
        mu, sigma = activation_statistics(acts)
        kid_acts = acts[:KID_MAX_REF].astype(np.float32)
        np.savez(path, mu=mu, sigma=sigma, acts=kid_acts,
                 feature_version=self.feature_version)
        self.ref_stats = (mu, sigma)
        self.ref_acts = kid_acts
