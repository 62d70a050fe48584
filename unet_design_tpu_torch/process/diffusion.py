"""Diffusion processes: the discrete-time DDPM (diff_cifar) and the VP
diffusion (diff_mnist).

Port of ``unet_design_tpu/process/diffusion.py``: for the DDPM
(``diff_cifar/diffusion.py:17-222``) linear betas, the Algorithm-1 loss
with multi-resolution noise targets, the T-step ancestral sampler
(eps / xstart / xprev means, fixedlarge / fixedsmall variances), DDIM over
a sub-sequence of the schedule and DPM-Solver++(2M); and
:class:`VPDiffusion` (``:304-429``, ``torch_ddpm/ddpm/diffusion.py:
41-174``), its staged timestep draw, (weighted) multi-res loss and
reverse-SDE sampler.

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
import warnings
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from unet_design_tpu_torch.ops import wavelet
from unet_design_tpu_torch.parallel import mesh

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
    return mesh.draw_rows(lambda shape: torch.randn(
        shape, generator=generator, device=x.device, dtype=x.dtype), x.shape,
        h_axis=1)


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


# ----------------------------------------------------------------------------
# Continuous-time VP diffusion (diff_mnist)
# ----------------------------------------------------------------------------

def jax_linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in fp32 as XLA computes it on the
    CPU: ``start * (1 - s) + stop * s`` with ``s = i * (1 / (num - 1))``,
    the end point appended.  Bit for bit at the sampler's step counts
    (N = 30 and the tests' few steps); at a thousand steps some values
    differ from XLA's by an ulp."""
    start_t = torch.tensor(start, dtype=torch.float32)
    stop_t = torch.tensor(stop, dtype=torch.float32)
    if num == 1:
        return start_t[None]
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) * (
        1.0 / torch.tensor(div, dtype=torch.float32))
    return torch.cat([start_t * (1 - step) + stop_t * step, stop_t[None]])


@dataclasses.dataclass(frozen=True)
class VPDiffusion:
    """The VP diffusion of diff_mnist (``unet_design_tpu/process/
    diffusion.py:304-429``).  Buffers are fp32 tensors of length N,
    computed in float64 numpy."""

    discrete_betas: torch.Tensor
    alphas: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_1m_alphas_cumprod: torch.Tensor
    N: int
    T: float
    eps: float
    multi_res_loss: bool
    weighted_multi_res_loss: bool

    @classmethod
    def create(cls, beta_min: float = 0.1, beta_max: float = 20.0,
               N: int = 1000, eps: float = 1e-3, T: float = 1.0,
               multi_res_loss: bool = False,
               weighted_multi_res_loss: bool = False) -> "VPDiffusion":
        betas = np.linspace(beta_min / N, beta_max / N, N, dtype=np.float64)
        if betas[-1] >= 1.0:
            warnings.warn(
                f"beta_max/N = {betas[-1]:.3f} >= 1: alpha goes non-positive "
                "and the VP schedule buffers contain NaN (the reference "
                "torch_ddpm/ddpm/diffusion.py:55-69 has the same failure "
                "mode); increase N or lower beta_max.", stacklevel=2)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)

        def f32(a):
            return torch.from_numpy(np.asarray(a, np.float32))
        return cls(discrete_betas=f32(betas), alphas=f32(alphas),
                   sqrt_alphas_cumprod=f32(np.sqrt(acp)),
                   sqrt_1m_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
                   N=N, T=T, eps=eps, multi_res_loss=multi_res_loss,
                   weighted_multi_res_loss=weighted_multi_res_loss)

    def to(self, device) -> "VPDiffusion":
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in (
                "discrete_betas", "alphas", "sqrt_alphas_cumprod",
                "sqrt_1m_alphas_cumprod")})

    def t_range(self, stage: Optional[int] = None,
                n_stages: Optional[int] = None) -> Tuple[int, int]:
        """``[low, high)`` of the timestep indices: all N, or with staged
        training only the stage's top interval (``diffusion.py:71-84``)."""
        if stage is None:
            return 0, self.N
        if n_stages is None:
            raise ValueError("a staged draw needs n_stages")
        return int(self.N * ((n_stages - stage - 1) / n_stages)), self.N

    def sample_t(self, generator: Optional[torch.Generator], batch: int,
                 stage: Optional[int] = None, n_stages: Optional[int] = None,
                 device=None) -> torch.Tensor:
        """Uniform timestep indices ``(batch,)`` from :meth:`t_range`."""
        low, high = self.t_range(stage, n_stages)
        return torch.randint(low, high, (batch,), generator=generator,
                             device=device)

    def sample_x(self, x0: torch.Tensor, t: torch.Tensor,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward noising ``(x_t, noise)`` (``diffusion.py:86-94``); the
        noise is drawn from ``generator`` unless given."""
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator,
                                device=x0.device, dtype=x0.dtype)
        nd = x0.ndim
        x_t = (_extract(self.sqrt_alphas_cumprod, t, nd) * x0
               + _extract(self.sqrt_1m_alphas_cumprod, t, nd) * noise)
        return x_t, noise

    def loss(self, model_output, noise, last_loss_schedule_weight: float = 1.0
             ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(Optionally weighted) multi-res MSE (``diffusion.py:97-134``):
        ``model_output`` and ``noise`` are per-level lists, coarsest first,
        in multi-res mode.  The weights are the intended ``1 / res^2``
        normalised to sum 1 (the reference writes ``^``, an XOR); the last
        level's is scaled by ``last_loss_schedule_weight``."""
        if not self.multi_res_loss:
            return ((model_output - noise) ** 2).mean(), []
        k = len(model_output)
        if self.weighted_multi_res_loss:
            # the global rows of each level (a slab's are a part)
            w = np.array([1.0 / (getattr(n, "spatial_rows", out.shape[1])
                                 ** 2)
                          for out, n in zip(model_output, noise)])
            weights = (w / w.sum()).tolist()
        else:
            weights = [1.0] * k
        loss = 0.0
        loss_list = []
        for i, (out, n) in enumerate(zip(model_output, noise)):
            l = ((out - n) ** 2).mean()
            loss = loss + l * (weights[i] * (last_loss_schedule_weight
                                             if i == k - 1 else 1.0))
            loss_list.append(l)
        return loss, loss_list

    def reverse_mean_scale(self, model_fn: ModelFn, x_t: torch.Tensor,
                           t: torch.Tensor, n_levels_used: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Score-based reverse mean and scale (``diffusion.py:136-151``):
        the model sees the fractional ``t (N - 1) / T``, the schedule is
        indexed at its ``int`` truncation."""
        timestep = t * (self.N - 1) / self.T
        t_label = timestep.long()
        nd = x_t.ndim
        beta = _extract(self.discrete_betas, t_label, nd)
        pred = model_fn(x_t, timestep, n_levels_used)
        if self.multi_res_loss:
            pred = pred[-1]
        std = _extract(self.sqrt_1m_alphas_cumprod, t_label, nd)
        score = -pred / std
        x_mean = (x_t + beta * score) / torch.sqrt(1.0 - beta)
        return x_mean, torch.sqrt(beta)

    @torch.no_grad()
    def reverse_sample(self, model_fn: ModelFn, x_T: torch.Tensor,
                       n_levels_used: int = -1, N: Optional[int] = None,
                       T: Optional[float] = None, eps: Optional[float] = None,
                       generator: Optional[torch.Generator] = None,
                       noises: Optional[Sequence[torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reverse-SDE sampler (``diffusion.py:7-38,153-174``) over
        ``linspace(T, eps, N)``: returns ``(x, x_mean)`` of the last step.
        Step ``i``'s noise is ``noises[i]`` or drawn from ``generator``
        (every step draws, the last one too, as the JAX scan does)."""
        N = N if N is not None else self.N
        T = T if T is not None else self.T
        eps = eps if eps is not None else self.eps
        x = x_mean = x_T
        for i, t in enumerate(jax_linspace(T, eps, N).tolist()):
            t_vec = torch.full((x.shape[0],), t, dtype=torch.float32,
                               device=x.device)
            x_mean, scale = self.reverse_mean_scale(model_fn, x, t_vec,
                                                    n_levels_used)
            x = x_mean + scale * _step_noise(noises, i, x, generator)
        return x, x_mean
