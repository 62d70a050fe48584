"""Discrete-time DDPM: schedule, training loss and three samplers.

Port of the DDPM part of ``unet_design_tpu/process/diffusion.py``
(``diff_cifar/diffusion.py:17-222``): linear betas, the Algorithm-1 loss
with multi-resolution noise targets, the T-step ancestral sampler
(eps / xstart / xprev means, fixedlarge / fixedsmall variances), DDIM over
a sub-sequence of the schedule and DPM-Solver++(2M).  ``VPDiffusion``
(diff_mnist) waits for its slice.

Schedule buffers are computed in float64 numpy and stored as fp32, as in
the JAX package.  The samplers are Python loops over ``model_fn(x, t,
n_levels_used)``, which returns a tensor or, in multi-res mode, a list whose
last entry is the finest.  Their per-step coefficients are 0-dim fp32
tensors on the host, so the coefficient arithmetic rounds as the JAX
package's fp32 arrays do, and PyTorch passes them to the device's kernels
as scalars.  Model outputs are promoted to fp32 before they meet a
coefficient (a bf16 model's output would otherwise pull the product down to
bf16; in JAX the fp32 coefficient array promotes it).

Randomness is explicit: the loss takes its ``t`` and ``noise``, and a
sampler draws each step's noise from ``generator`` or takes it from
``noises`` (one tensor per step, in loop order), so tests can inject the
JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from unet_design_tpu_torch.ops import wavelet

ModelFn = Callable[..., Union[torch.Tensor, List[torch.Tensor]]]


def _extract(v: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-timestep coefficients ``v[t]``, broadcastable to ``ndim``."""
    return v[t].reshape(t.shape[0], *([1] * (ndim - 1)))


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """Discrete DDPM schedule buffers (``diff_cifar/diffusion.py:27-37,
    109-136``), fp32 tensors of length T."""

    betas: torch.Tensor
    sqrt_alphas_bar: torch.Tensor
    sqrt_one_minus_alphas_bar: torch.Tensor
    sqrt_recip_alphas_bar: torch.Tensor
    sqrt_recipm1_alphas_bar: torch.Tensor
    posterior_var: torch.Tensor
    posterior_log_var_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixedlarge_log_var: torch.Tensor

    @property
    def T(self) -> int:
        return self.betas.shape[0]

    @classmethod
    def create(cls, beta_1: float = 1e-4, beta_T: float = 0.02,
               T: int = 1000) -> "DDPMSchedule":
        betas = np.linspace(beta_1, beta_T, T, dtype=np.float64)
        alphas = 1.0 - betas
        alphas_bar = np.cumprod(alphas)
        alphas_bar_prev = np.concatenate([[1.0], alphas_bar[:-1]])
        posterior_var = betas * (1.0 - alphas_bar_prev) / (1.0 - alphas_bar)
        post_log_var = np.log(
            np.concatenate([posterior_var[1:2], posterior_var[1:]]))
        fixedlarge_log_var = np.log(
            np.concatenate([posterior_var[1:2], betas[1:]]))

        def f32(a):
            return torch.from_numpy(np.asarray(a, np.float32))
        return cls(
            betas=f32(betas),
            sqrt_alphas_bar=f32(np.sqrt(alphas_bar)),
            sqrt_one_minus_alphas_bar=f32(np.sqrt(1.0 - alphas_bar)),
            sqrt_recip_alphas_bar=f32(np.sqrt(1.0 / alphas_bar)),
            sqrt_recipm1_alphas_bar=f32(np.sqrt(1.0 / alphas_bar - 1.0)),
            posterior_var=f32(posterior_var),
            posterior_log_var_clipped=f32(post_log_var),
            posterior_mean_coef1=f32(
                np.sqrt(alphas_bar_prev) * betas / (1.0 - alphas_bar)),
            posterior_mean_coef2=f32(
                np.sqrt(alphas) * (1.0 - alphas_bar_prev)
                / (1.0 - alphas_bar)),
            fixedlarge_log_var=f32(fixedlarge_log_var),
        )

    def to(self, device) -> "DDPMSchedule":
        return DDPMSchedule(**{f.name: getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)})


def ddpm_forward_noise(schedule: DDPMSchedule, x0: torch.Tensor,
                       t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0):  sqrt(a-bar) x0 + sqrt(1 - a-bar) eps."""
    nd = x0.ndim
    return (_extract(schedule.sqrt_alphas_bar, t, nd) * x0
            + _extract(schedule.sqrt_one_minus_alphas_bar, t, nd) * noise)


def ddpm_loss(model_fn: ModelFn, schedule: DDPMSchedule, x0: torch.Tensor,
              t: torch.Tensor, noise: torch.Tensor, n_levels_used: int,
              n_levels: int, n_downsample: int = 0,
              multi_res_loss: bool = False, sequ_train_algo: bool = False,
              pyramid_fn: Optional[wavelet.PyramidFn] = None
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Algorithm-1 training loss (``diff_cifar/diffusion.py:38-91``) for
    the given timesteps ``t (B,)`` and ``noise`` (``x0``'s shape).

    ``x0`` is the (already stage-downsampled) NHWC batch.  With
    ``multi_res_loss`` the targets are the Haar pyramid of the noise in
    decoder order, taken with ``pyramid_fn`` (default the plain
    :func:`~unet_design_tpu_torch.ops.wavelet.dwt_pyramid`), truncated to
    the levels the decoder emitted; the loss is the unweighted sum of the
    per-level MSEs.
    """
    x_t = ddpm_forward_noise(schedule, x0, t, noise)
    model_out = model_fn(x_t, t, n_levels_used)
    if multi_res_loss:
        targets = wavelet.multires_targets(
            noise, n_levels, n_downsample if sequ_train_algo else 0,
            pyramid_fn)
        targets = targets[-len(model_out):]
        loss = 0.0
        loss_list = []
        for out, tgt in zip(model_out, targets):
            l = ((out - tgt) ** 2).mean()
            loss = loss + l
            loss_list.append(l)
        return loss, loss_list
    return ((model_out - noise) ** 2).mean(), []


def _finest(out) -> torch.Tensor:
    return (out[-1] if isinstance(out, (list, tuple)) else out).float()


def _step_noise(noises: Optional[Sequence[torch.Tensor]], i: int,
                x: torch.Tensor, generator: Optional[torch.Generator]
                ) -> torch.Tensor:
    if noises is not None:
        return noises[i]
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


@torch.no_grad()
def ddpm_sample(model_fn: ModelFn, schedule: DDPMSchedule, x_T: torch.Tensor,
                n_levels_used: int, mean_type: str = "epsilon",
                var_type: str = "fixedlarge", clip: bool = True,
                generator: Optional[torch.Generator] = None,
                noises: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
    """Ancestral sampler over all T steps (``diff_cifar/diffusion.py:
    169-222``).  The posterior mean comes from the unclipped x0, as in the
    reference (its clip of x0 sits after the mean and has no effect); only
    the final sample is clipped.  ``noises[i]`` is step ``i``'s noise
    (step ``T-1`` takes none)."""
    if mean_type not in ("xprev", "xstart", "epsilon"):
        raise ValueError(f"mean_type {mean_type!r}")
    if var_type not in ("fixedlarge", "fixedsmall"):
        raise ValueError(f"var_type {var_type!r}")
    sch = schedule.to("cpu")
    log_var_buf = (sch.fixedlarge_log_var if var_type == "fixedlarge"
                   else sch.posterior_log_var_clipped)
    b = x_T.shape[0]
    x = x_T
    for i, time_step in enumerate(range(sch.T - 1, -1, -1)):
        t = torch.full((b,), time_step, dtype=torch.long, device=x.device)
        out = _finest(model_fn(x, t, n_levels_used))
        if mean_type == "xprev":
            mean = out
        else:
            x0 = out if mean_type == "xstart" else (
                sch.sqrt_recip_alphas_bar[time_step] * x
                - sch.sqrt_recipm1_alphas_bar[time_step] * out)
            mean = (sch.posterior_mean_coef1[time_step] * x0
                    + sch.posterior_mean_coef2[time_step] * x)
        if time_step > 0:
            std = torch.exp(0.5 * log_var_buf[time_step])
            x = mean + std * _step_noise(noises, i, x, generator)
        else:
            x = mean
    return x.clamp(-1.0, 1.0) if clip else x


def ddim_timesteps(T: int, n_steps: int) -> List[int]:
    """DDIM's sub-sequence, descending: ``round(linspace(0, T-1, n))``
    (fp32, ties to even, as the JAX package computes it)."""
    return np.linspace(0, T - 1, n_steps, dtype=np.float32).round().astype(
        np.int64)[::-1].tolist()


@torch.no_grad()
def ddim_sample(model_fn: ModelFn, schedule: DDPMSchedule, x_T: torch.Tensor,
                n_levels_used: int, n_steps: int = 50, eta: float = 0.0,
                clip: bool = True, generator: Optional[torch.Generator] = None,
                noises: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
    """DDIM over an ``n_steps`` sub-sequence of the T-step schedule:
    deterministic at ``eta == 0``, stochastic above (noise ``noises[i]`` at
    step ``i``, none at the last)."""
    alphas_bar = schedule.sqrt_alphas_bar.cpu() ** 2
    ts = ddim_timesteps(schedule.T, n_steps)
    b = x_T.shape[0]
    one = torch.ones((), dtype=torch.float32)
    x = x_T
    for i, t in enumerate(ts):
        t_prev = ts[i + 1] if i + 1 < len(ts) else -1
        out = _finest(model_fn(x, torch.full((b,), t, dtype=torch.long,
                                             device=x.device), n_levels_used))
        ab_t = alphas_bar[t]
        ab_prev = alphas_bar[t_prev] if t_prev >= 0 else one
        x0 = (x - torch.sqrt(1.0 - ab_t) * out) / torch.sqrt(ab_t)
        if clip:
            x0 = x0.clamp(-1.0, 1.0)
        sigma = (eta * torch.sqrt((1.0 - ab_prev) / (1.0 - ab_t))
                 * torch.sqrt(1.0 - ab_t / ab_prev))
        dir_xt = torch.sqrt(torch.clamp(1.0 - ab_prev - sigma ** 2,
                                        min=0.0)) * out
        x = torch.sqrt(ab_prev) * x0 + dir_xt
        if eta > 0 and t_prev >= 0:
            x = x + sigma * _step_noise(noises, i, x, generator)
    return x.clamp(-1.0, 1.0) if clip else x


def _lam(ab: torch.Tensor) -> torch.Tensor:
    """log(alpha / sigma) of alpha-bar."""
    return 0.5 * (torch.log(ab) - torch.log1p(-ab))


def dpm_solver_timesteps(schedule: DDPMSchedule, n_steps: int) -> List[int]:
    """logSNR-uniform timesteps, descending and clamped to strictly
    decreasing (floored at 0)."""
    T = schedule.T
    lam_all = _lam(schedule.sqrt_alphas_bar.cpu() ** 2)
    targets = torch.linspace(float(lam_all[T - 1]), float(lam_all[0]),
                             n_steps, dtype=torch.float32)
    ts = torch.argmin((lam_all[None, :] - targets[:, None]).abs(), dim=1)
    ts = torch.sort(ts, descending=True).values
    idx = torch.arange(n_steps)
    ts = torch.cummin(ts + idx, dim=0).values - idx
    return ts.clamp(min=0).tolist()


@torch.no_grad()
def dpm_solver_sample(model_fn: ModelFn, schedule: DDPMSchedule,
                      x_T: torch.Tensor, n_levels_used: int,
                      n_steps: int = 20, clip: bool = True) -> torch.Tensor:
    """DPM-Solver++(2M): data-prediction multistep over logSNR-uniform
    steps, deterministic; first order on the first step, and the last step
    jumps to the predicted clean data.

    With ``lambda = log(alpha/sigma)`` and ``h_i = lambda_{i+1} - lambda_i``:
    ``D_i = (1 + 1/(2 r_i)) x0_i - 1/(2 r_i) x0_{i-1}``, ``r_i = h_{i-1} /
    h_i``, and ``x_{i+1} = (sigma_{i+1}/sigma_i) x_i - alpha_{i+1}
    (e^{-h_i} - 1) D_i``; a degenerate previous interval (``h_{i-1} <
    1e-4``) falls back to first order."""
    alphas_bar = schedule.sqrt_alphas_bar.cpu() ** 2
    ts = dpm_solver_timesteps(schedule, n_steps)
    b = x_T.shape[0]
    x, x0_prev, lam_prev = x_T, None, None
    for i, t in enumerate(ts):
        t_prev = ts[i + 1] if i + 1 < len(ts) else -1
        out = _finest(model_fn(x, torch.full((b,), t, dtype=torch.long,
                                             device=x.device), n_levels_used))
        ab_t = alphas_bar[t]
        sig_t = torch.sqrt(1.0 - ab_t)
        x0 = (x - sig_t * out) / torch.sqrt(ab_t)
        if clip:
            x0 = x0.clamp(-1.0, 1.0)
        if t_prev < 0:
            x = x0           # the final jump to clean data
            break
        lam_t = _lam(ab_t)
        ab_next = alphas_bar[t_prev]
        h = _lam(ab_next) - lam_t
        if x0_prev is None:
            d = x0
        else:
            h_last = lam_t - lam_prev
            r = h_last / torch.clamp(h, min=1e-12)
            coef = 1.0 / (2.0 * torch.clamp(r, min=1e-12))
            if h_last < 1e-4:
                coef = torch.zeros_like(coef)
            d = (1.0 + coef) * x0 - coef * x0_prev
        x = (torch.sqrt(1.0 - ab_next) / sig_t * x
             - torch.sqrt(ab_next) * (torch.exp(-h) - 1.0) * d)
        x0_prev, lam_prev = x0, lam_t
    return x.clamp(-1.0, 1.0) if clip else x
