"""The port's CUDA kernel against its plain version, and the diffusion,
WMH and PDE-zoo slices' models, layers and trainers (the PDE trainer in
bf16 with remat too), and the DDPM's
evaluation (Inception, the Newton-Schulz root, ``evaluate``), on the card.

Marked ``cuda``: each test skips where no CUDA device is present (the CPU
tier-1 run).  On a machine with an H100 and ``nvcc``, run
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``
(``--noconftest``: the shared conftest configures JAX, which that machine
need not have).  This file imports no JAX.
"""
import json

import numpy as np
import pytest
import torch

from unet_design_tpu_torch.ops import blocks, haar, wavelet

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _x(shape, dtype, device, seed=0, misalign=0):
    """Seeded data; ``misalign`` elements of storage offset put the tensor
    off a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = x.to(device=device, dtype=dtype)
    if misalign:
        store = torch.empty(x.numel() + misalign, dtype=dtype, device=device)
        store[misalign:] = x.flatten()
        x = store[misalign:].view(shape)
        assert x.is_contiguous() and x.data_ptr() % 16
    return x


@pytest.mark.parametrize("shape,n_levels,dtype", [
    ((8, 128, 128, 3), 4, torch.float32),
    ((8, 64, 64, 3), 3, torch.float32),
    ((8, 32, 32, 3), 2, torch.float32),
    ((8, 128, 128, 3), 4, torch.bfloat16),
    ((2, 32, 64, 5), 4, torch.float32),
    ((3, 40, 24, 40), 4, torch.float32),   # generic channel count, ragged
    ((128, 32, 32, 3), 4, torch.float32),  # CIFAR
    ((128, 32, 32, 3), 4, torch.bfloat16),
    ((1, 64, 64, 2), 6, torch.float32),    # levels past the warp shuffles
    ((128, 64, 64, 1), 4, torch.float32),  # diff_mnist, one channel
    ((128, 32, 32, 1), 3, torch.float32),
    ((128, 16, 16, 1), 2, torch.float32),
    ((128, 64, 64, 3), 4, torch.float32),  # diff_mnist on CelebA64, RGB
    ((128, 32, 32, 3), 3, torch.float32),
    ((128, 16, 16, 3), 2, torch.float32),
    ((128, 64, 64, 3), 4, torch.bfloat16),
    ((128, 32, 32, 3), 3, torch.bfloat16),
    ((128, 16, 16, 3), 2, torch.bfloat16),
    ((32, 200, 200, 2), 4, torch.float32),  # WMH image, stages 0, 1, 2
    ((32, 200, 200, 2), 3, torch.float32),
    ((32, 200, 200, 2), 2, torch.float32),
    ((32, 200, 200, 1), 4, torch.float32),  # WMH mask, stages 0, 1, 2
    ((32, 200, 200, 1), 3, torch.float32),
    ((32, 200, 200, 1), 2, torch.float32),
])
def test_kernel_matches_plain(cuda, shape, n_levels, dtype):
    _check_kernel(_x(shape, dtype, cuda), n_levels)


@pytest.mark.parametrize("shape,n_levels,dtype,misalign", [
    ((2, 24, 40, 3), 4, torch.float32, 1),   # input and level spans
    ((2, 6, 6, 1), 2, torch.bfloat16, 3),
])
def test_kernel_unaligned_spans(cuda, shape, n_levels, dtype, misalign):
    _check_kernel(_x(shape, dtype, cuda, misalign=misalign), n_levels)


@pytest.mark.parametrize("shape,n_levels,dtype", [
    ((1, 16, 2048, 3), 4, torch.float32),
    ((2, 8, 1000, 5), 4, torch.bfloat16),    # ragged last segment
    ((1, 32, 400, 3), 4, torch.float32),
    ((1, 4, 8, 3000), 2, torch.float32),     # more than 48 KB of shared
])
def test_kernel_split_width(cuda, shape, n_levels, dtype):
    assert haar.plan(shape, dtype, n_levels).n_seg > 1
    _check_kernel(_x(shape, dtype, cuda, misalign=1), n_levels)


def _check_kernel(x, n_levels):
    before = haar.launches
    out = haar.haar_pyramid(x, n_levels)
    torch.cuda.synchronize()
    assert haar.launches == before + 1
    ref = haar.haar_pyramid_reference(x, n_levels)
    assert out[0] is x
    for a, b in zip(out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        # same additions in the same order: equal bit for bit
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_single_level_launches_nothing(cuda):
    x = _x((2, 16, 16, 3), torch.float32, cuda)
    before = haar.launches
    assert haar.haar_pyramid(x, 1)[0] is x
    assert haar.launches == before


def test_rejects_what_the_kernel_does_not_take(cuda):
    with pytest.raises(TypeError):
        haar.haar_pyramid(torch.zeros(1, 8, 8, 1, device=cuda,
                                      dtype=torch.float16), 2)
    with pytest.raises(ValueError):
        haar.haar_pyramid(torch.zeros(1, 8, 8, 2, device=cuda)
                          .transpose(1, 2), 2)
    with pytest.raises(ValueError):
        haar.haar_pyramid(torch.zeros(1, 12, 8, 1, device=cuda), 4)


def test_multires_targets_traj_through_kernel(cuda):
    y = _x((8, 1, 128, 128, 3), torch.float32, cuda, seed=1)
    ref = wavelet.multires_targets_traj(y, 4, 1)
    out = wavelet.multires_targets_traj(y, 4, 1,
                                        pyramid_fn=haar.haar_pyramid)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_plan_is_made_once_and_launch_floor_runs(cuda):
    x = _x((8, 32, 32, 3), torch.float32, cuda)
    haar.haar_pyramid(x, 2)
    p = haar.plan(x.shape, x.dtype, 2, x.get_device())
    assert p.launch is not None           # bound at the first launch
    out = haar.haar_pyramid(x, 2)
    assert haar.plan(x.shape, x.dtype, 2, x.get_device()) is p
    torch.testing.assert_close(out[1], haar.haar_pyramid_reference(x, 2)[1],
                               rtol=0, atol=0)
    before = haar.launches
    haar.launch_empty(p)
    torch.cuda.synchronize()
    assert haar.launches == before


@pytest.mark.parametrize("shape,n_downsample", [
    ((128, 8, 8, 3), 2),      # CIFAR, stage 1 of 4: L2
    ((128, 16, 16, 3), 1),    # stage 2: L3
    ((128, 32, 32, 3), 0),    # stage 3: L4
    ((128, 16, 16, 1), 2),    # MNIST-Triangular, stage 1 of 4: L2
    ((128, 32, 32, 1), 1),    # stage 2: L3
    ((128, 64, 64, 1), 0)])   # stage 3: L4
def test_multires_targets_through_kernel(cuda, shape, n_downsample):
    """The diffusion losses' noise targets at the staged shapes of CIFAR
    and of MNIST-Triangular: one launch, the plain ``dwt_pyramid``'s values
    (it takes a mean where the kernel adds in pairs, hence 1e-6)."""
    noise = torch.randn(shape, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))
    before = haar.launches
    out = wavelet.multires_targets(noise, 4, n_downsample,
                                   pyramid_fn=haar.haar_pyramid)
    assert haar.launches == before + 1
    ref = wavelet.multires_targets(noise, 4, n_downsample)
    assert len(out) == len(ref) == 4 - n_downsample
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def _small_multires(dtype):
    from unet_design_tpu_torch.models.multires_unet import MultiResUNet
    m = MultiResUNet(ch=32, ch_mult=(1, 2, 2, 2), attn=(1,),
                     num_res_blocks=2, dropout=0.0, dwt_encoder=True,
                     multi_res_loss=True, dtype=dtype)
    # LeCun-normal kernels: O(1) outputs (the DDPM init's 1e-5 gains on
    # the last convs would make them ~1e-5)
    return blocks.flax_default_init_(m, torch.Generator().manual_seed(0))


def test_bf16_multires_unet_forward_matches_cpu(cuda):
    """bf16 on the card (cuDNN) against bf16 on the CPU: both round at
    every layer but accumulate in other orders; held at 0.03 of the output
    scale, the tolerance of the bf16 comparison with the JAX package
    (``tests/test_torch_multires_unet.py``)."""
    m = _small_multires(torch.bfloat16).eval()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    t = torch.tensor([0, 10, 500, 999])
    with torch.no_grad():
        ref = m(x, t)
        out = m.to(cuda)(x.to(cuda), t.to(cuda))
    for a, b in zip(out, ref, strict=True):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
        scale = float(b.float().abs().max())
        err = float((a.cpu().float() - b.float()).abs().max())
        assert err <= 0.03 * scale, (err, scale)


def test_full_width_ddpm_train_step(cuda, tmp_path):
    """One step of ``configs/diff_cifar_staged.yaml``'s model (ch 128,
    bf16) at full depth, batch 128: a finite loss, one kernel launch."""
    from unet_design_tpu_torch.tasks import diff_cifar
    cfg = diff_cifar.Config()
    cfg.model.dwt_encoder = True
    cfg.model.multi_res_loss = True
    cfg.model.use_bf16 = True
    cfg.train.num_iterations_list = [1]
    cfg.train.metrics_every_iters = 1
    cfg.train.logdir = str(tmp_path)
    before = haar.launches
    state = diff_cifar.train(cfg)
    assert haar.launches == before + 1 and state.step == 1
    rec = json.loads(open(tmp_path / "metrics.jsonl").readline())
    assert np.isfinite(rec["train/loss"]) and np.isfinite(
        rec["train/grad_norm"])


def test_full_width_bf16_remat_pde_train_step(cuda, tmp_path):
    """One step of the full-width ``Unetbase-64_G`` (hidden 64, 128x128,
    batch 8, DWT encoder, multi-res loss) with ``model.use_bf16`` and
    ``model.remat``: a finite loss, fp32 parameters, one kernel launch
    (the fp32 multi-res targets)."""
    from unet_design_tpu_torch.tasks import pde
    cfg = pde.Config()
    cfg.model.dwt_encoder = True
    cfg.model.multi_res_loss = True
    cfg.model.use_bf16 = True
    cfg.model.remat = True
    cfg.data.n_synthetic = 8
    cfg.data.train_cycles = 1
    cfg.train.num_epochs_list = [1]
    cfg.train.val_every_epochs = 2
    cfg.train.logdir = str(tmp_path)
    before = haar.launches
    state = pde.train(cfg)
    assert haar.launches == before + 1 and state.step == 1
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    recs = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert np.isfinite([r["train/loss_mean"] for r in recs
                        if "train/loss_mean" in r]).all()


def test_full_width_diff_mnist_train_step(cuda, tmp_path):
    """One step of ``configs/diff_mnist_triangular.yaml``'s model (ch 32 x
    [2, 2, 2, 2], fp32) at full depth, 64x64, batch 128: a finite loss per
    level, one kernel launch."""
    from unet_design_tpu_torch.tasks import diff_mnist
    cfg = diff_mnist.Config()
    cfg.model.channel_mult = [2, 2, 2, 2]
    cfg.model.dwt_encoder = True
    cfg.model.multi_res_loss = True
    cfg.data.resolution = 64
    cfg.train.num_iterations_list = [1]
    cfg.train.metrics_every_iters = 1
    cfg.train.logdir = str(tmp_path)
    before = haar.launches
    state = diff_mnist.train(cfg)
    assert haar.launches == before + 1 and state.step == 1
    rec = json.loads(open(tmp_path / "metrics.jsonl").readline())
    assert [k for k in rec if k.startswith("train/res_")] == [
        "train/res_8_loss", "train/res_16_loss", "train/res_32_loss",
        "train/res_64_loss"]
    assert all(np.isfinite(v) for k, v in rec.items() if k != "step")


@pytest.mark.parametrize("shape,n_downsample", [
    ((32, 200, 200, 2), 3),   # WMH image, stages 0, 1, 2 of 4
    ((32, 200, 200, 2), 2),
    ((32, 200, 200, 2), 1),
    ((32, 200, 200, 1), 3),   # mask
    ((32, 200, 200, 1), 2),
    ((32, 200, 200, 1), 1)])
def test_wmh_stage_downsample_through_kernel(cuda, shape, n_downsample):
    """The WMH trainer's stage downsample: one launch, the plain chain's
    values (a mean where the kernel adds in pairs: within one ulp of the
    data's scale), exactly on a binary mask, and the same re-binarized
    mask."""
    from unet_design_tpu_torch.tasks import wmh
    x = _x(shape, torch.float32, cuda, seed=2)
    if shape[-1] == 1:
        x = (x > 1.0).float()
    route, down = wmh.stage_downsampler(shape[1:3], n_downsample)
    assert route == "kernel"
    before = haar.launches
    out = down(x)
    assert haar.launches == before + 1
    ref = wavelet.haar_downsample(x, n_downsample)
    tol = 0.0 if shape[-1] == 1 else float(np.spacing(np.float32(
        x.abs().max().item())))
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)
    torch.testing.assert_close((out > 0.5).float(), (ref > 0.5).float(),
                               rtol=0, atol=0)


def test_wmh_train_on_the_card(cuda, tmp_path):
    """A tiny staged WMH run on the card: [1, 1] epochs at 48x48, 10
    training slices in batches of 4 (3 steps) and one validation batch;
    stage 0 launches the kernel for the image and the mask of each (8),
    stage 1 and the test none; finite losses, 9 thresholds."""
    from unet_design_tpu_torch.tasks import wmh
    cfg = wmh.Config()
    cfg.data.synthetic_size = 12
    cfg.data.resolution = 48
    cfg.data.batch_size = 4
    cfg.model.hidden_channels = 4
    cfg.model.dwt_encoder = True
    cfg.model.multi_res_loss = True
    cfg.train.num_epochs_list = [1, 1]
    cfg.train.freeze_lower_res = True
    cfg.train.logdir = str(tmp_path)
    before = haar.launches
    best, sweep = wmh.train(cfg)
    assert haar.launches == before + 8
    assert len(sweep) == 9 and all(v.is_cuda for v in best.values())
    recs = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    losses = [r[k] for r in recs for k in ("train/loss", "valid/loss")
              if k in r]
    assert len(losses) == 4 and np.isfinite(losses).all()


@pytest.mark.parametrize("name", ["Unetmod-64", "U-FNet2-16m", "FNO-128-8m",
                                  "Unet2015-64", "UNO-64"])
def test_zoo_forward_matches_cpu(cuda, name):
    """A full-width zoo model's fp32 forward on the card (TF32 off) within
    1e-4 relative of the same weights on the CPU."""
    from unet_design_tpu_torch.models import registry
    from unet_design_tpu_torch.tasks import pde
    pde.resolve_device("cuda")
    m = registry.build_model(name, 1, 1, 4, 1)
    blocks.flax_default_init_(m, torch.Generator().manual_seed(0))
    m.eval()
    x = _x((1, 4, 128, 128, 3), torch.float32, "cpu", seed=3)
    with torch.no_grad():
        ref = m(x)
        out = m.to(cuda)(x.to(cuda)).cpu()
    assert torch.isfinite(out).all()
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("shape,modes", [((8, 137, 137, 128), (8, 8)),
                                         ((8, 128, 128, 64), (16, 16)),
                                         ((2, 24, 40, 5), (4, 6))])
def test_spectral_routes_agree_on_the_card(cuda, shape, modes):
    """The truncated-DFT products and cuFFT give the same layer, forward
    and gradients, at 1e-5 of the output's scale."""
    from unet_design_tpu_torch.ops.spectral import SpectralConv2d
    from unet_design_tpu_torch.tasks import pde
    pde.resolve_device("cuda")
    b, h, w, c = shape
    conv = SpectralConv2d(c, c, *modes)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    conv.to(cuda)
    x = _x((b, c, h, w), torch.float32, cuda, seed=4).requires_grad_(True)
    outs, grads = [], []
    for route in ("dft", "fft"):
        y = conv(x, route=route)
        (gx,) = torch.autograd.grad(y.square().sum(), x)
        outs.append(y.detach())
        grads.append(gx)
    scale = float(outs[1].abs().max())
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-5 * scale
    gscale = float(grads[1].abs().max())
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-4 * gscale


@pytest.mark.parametrize("kind", ["cond", "uno"])
def test_cond_and_uno_spectral_routes_agree_on_the_card(cuda, kind):
    """The conditioned FNO's layer at (8, 137, 137, 128) with 16 modes and
    UNO-64's first at 128 -> 96 with 18: both routes give the same layer,
    forward and gradients, at 1e-5 and 1e-4 of the scale."""
    from unet_design_tpu_torch.ops import spectral
    from unet_design_tpu_torch.tasks import pde
    pde.resolve_device("cuda")
    if kind == "cond":
        conv = spectral.CondSpectralConv2d(128, 128, 512, 16, 16)
        x = _x((8, 128, 137, 137), torch.float32, cuda, seed=5)
        extra = (_x((8, 512), torch.float32, cuda, seed=6),)
    else:
        conv = spectral.SpectralConv2dUno(64, 96, 18, 18)
        x = _x((8, 64, 128, 128), torch.float32, cuda, seed=5)
        extra = ((96, 96),)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    conv.to(cuda)
    x.requires_grad_(True)
    outs, grads = [], []
    for route in ("dft", "fft"):
        y = conv(x, *extra, route=route)
        (gx,) = torch.autograd.grad(y.square().sum(), x)
        outs.append(y.detach())
        grads.append(gx)
    scale = float(outs[1].abs().max())
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-5 * scale
    gscale = float(grads[1].abs().max())
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-4 * gscale


def test_unetmod_train_step_at_shallow_water_shape(cuda):
    """One AdamW step of the shallow-water yaml's ``Unetmod-64`` at full
    width, 96x192, batch 16 (time_history 2): a finite loss, the
    parameters updated, no Haar launch."""
    from unet_design_tpu_torch.process import losses
    from unet_design_tpu_torch.tasks import pde
    from unet_design_tpu_torch.train import trainer
    pde.resolve_device("cuda")
    cfg = pde.Config()
    cfg.model.name = "Unetmod-64"
    cfg.data.time_history = 2
    m = pde.build_model(cfg)
    blocks.flax_default_init_(m, torch.Generator().manual_seed(0))
    m.to(cuda)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    opt = trainer.make_optimizer(m.parameters(), 1e-3, "adamw", 0.01)
    x = _x((16, 2, 96, 192, 3), torch.float32, cuda, seed=5)
    y = _x((16, 1, 96, 192, 3), torch.float32, cuda, seed=6)
    launches = haar.launches
    loss = losses.custom_mse_loss(m(x), y)
    loss.backward()
    opt.step()
    assert np.isfinite(float(loss)) and haar.launches == launches
    moved = [k for k, v in m.state_dict().items()
             if not torch.equal(before[k], v)]
    assert "image_proj.weight" in moved and "final.weight" in moved
    assert len(moved) >= 0.9 * len(before)


def test_inception_on_the_card_matches_cpu(cuda):
    """The FID Inception (random network, seed 0) on 8 CIFAR-sized images:
    blocks 3 and 4 on the card within 1e-4 of the output scale of the CPU's
    (TF32 off)."""
    from unet_design_tpu_torch.evalx import inception
    from unet_design_tpu_torch.tasks import pde
    pde.resolve_device("cuda")
    x = torch.from_numpy(np.random.default_rng(7).uniform(
        size=(8, 32, 32, 3)).astype(np.float32))
    cpu = inception.fid_inception()
    card = inception.fid_inception().to(cuda)
    with torch.no_grad():
        want, got = cpu(x), card(x.to(cuda))
    for a, b in zip(got, want, strict=True):
        assert torch.isfinite(a).all()
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())


def test_newton_schulz_on_the_card_matches_scipy(cuda):
    """The 100-iteration root of an fp32 product of two 2048 x 2048
    covariances on the card: its trace within 1e-3 of scipy's float64
    ``sqrtm``."""
    import scipy.linalg
    from unet_design_tpu_torch.evalx import fid
    from unet_design_tpu_torch.tasks import pde
    pde.resolve_device("cuda")
    rng = np.random.default_rng(0)
    s1 = fid.activation_statistics(rng.standard_normal((6144, 2048)))[1]
    s2 = fid.activation_statistics(
        1.5 * rng.standard_normal((6144, 2048)) + 0.3)[1]
    prod = (torch.as_tensor(s1, dtype=torch.float32, device=cuda)
            @ torch.as_tensor(s2, dtype=torch.float32, device=cuda))
    got = float(fid.sqrt_newton_schulz(prod).double().trace())
    want = float(np.trace(scipy.linalg.sqrtm(s1 @ s2).real))
    assert abs(got - want) <= 1e-3 * abs(want)


def test_evaluate_on_the_card(cuda, tmp_path):
    """``diff_cifar.evaluate`` of a narrow bf16 model on the card: 8
    DPM-Solver samples scored by the random Inception against a cache that
    ``tasks.compute_fid_stats`` writes: IS, FID and KID finite, flagged
    untrusted."""
    from unet_design_tpu_torch.process import diffusion
    from unet_design_tpu_torch.tasks import compute_fid_stats, diff_cifar
    from unet_design_tpu_torch.train import trainer
    cache = compute_fid_stats.main(["--synthetic-size", "16", "--out",
                                    str(tmp_path / "stats.npz")])
    cfg = diff_cifar.Config()
    cfg.diffusion.sampler, cfg.diffusion.sample_steps = "dpm_solver", 5
    cfg.train.fid_stats_cache = cache
    m = _small_multires(torch.bfloat16).to(cuda)
    sch = diffusion.DDPMSchedule.create(1e-4, 0.02, 1000).to(cuda)
    ema = {k: v.detach().clone() for k, v in m.named_parameters()}
    scores = diff_cifar.evaluate(cfg, m, ema, sch, 4, 32, num_images=8,
                                 generator=trainer.seeded_generator(cuda, 0))
    assert set(scores) == {"IS", "IS_std", "FID", "KID", "KID_std",
                           "untrusted_random_inception_weights"}
    assert all(np.isfinite(v) for v in scores.values())
    assert scores["untrusted_random_inception_weights"] == 1.0


@pytest.mark.parametrize("solver", ["ns", "sw", "maxwell"])
def test_datagen_on_the_card_matches_cpu(cuda, solver):
    """The same initial state stepped on the card and on the CPU: within
    1e-4 of each field's scale after a few steps (the fp32 differences of
    cuFFT / cuBLAS and the CPU libraries carried forward)."""
    import dataclasses
    from unet_design_tpu_torch.datagen import maxwell, navier_stokes as ns
    from unet_design_tpu_torch.datagen import shallow_water as sw
    from unet_design_tpu_torch.datagen import pde_configs
    from unet_design_tpu_torch.tasks import pde
    pde.resolve_device("cuda")
    if solver == "ns":
        cfg = pde_configs.NavierStokes2D(nx=32, ny=32, nt=8)
        noise = torch.stack([ns.draw_noise(ns.trajectory_generator(
            0, "train", i), 32, 32) for i in range(2)])

        def run(dev):
            return ns.simulate(*ns.initial_state(noise.to(dev), cfg), cfg)
    elif solver == "sw":
        cfg = pde_configs.ShallowWaterWeather(nt=2, nx=24, ny=48)
        noise = torch.stack([sw.draw_noise(ns.trajectory_generator(
            0, "train", i), cfg) for i in range(2)])

        def run(dev):
            return sw.simulate(noise.to(dev), cfg)
    else:
        cfg = dataclasses.replace(pde_configs.Maxwell3D(), nx=8, ny=8, nz=8,
                                  skip_nt=20, nt=3)
        srcs = maxwell.trajectory_sources(cfg, "train", 2, 0)

        def run(dev):
            return maxwell.simulate(maxwell.stack_sources(srcs, dev), cfg)
    for card, cpu in zip(run(cuda), run("cpu")):
        assert torch.isfinite(card).all()
        scale = float(cpu.abs().max())
        assert float((card.cpu() - cpu).abs().max()) <= 1e-4 * scale


def test_streamed_training_on_the_card(cuda, tmp_path):
    """The tiny staged Multi-ResNet trained on the card from the host (both
    splits streamed through pinned buffers) and from the device: the same
    windows, per-epoch losses within 1e-4, and the Haar kernel launched
    once a multi-res step on both."""
    from unet_design_tpu_torch.tasks import pde
    losses, launches = {}, {}
    for name, device_cache in (("staged", True), ("streamed", False)):
        cfg = pde.Config()
        cfg.data.resolution = 16
        cfg.data.trajlen = 6
        cfg.data.n_synthetic = 4
        cfg.data.batch_size = 2
        cfg.data.max_num_steps = 2
        cfg.data.train_cycles = 1
        cfg.data.device_cache = device_cache
        cfg.model.hidden_channels = 8
        cfg.model.dwt_encoder = True
        cfg.model.multi_res_loss = True
        cfg.train.num_epochs_list = [1, 1]
        cfg.train.logdir = str(tmp_path / name)
        haar.launches = 0
        pde.train(cfg)
        launches[name] = haar.launches
        with open(tmp_path / name / "metrics.jsonl") as f:
            losses[name] = [json.loads(l)["train/loss_mean"] for l in f
                            if "train/loss_mean" in l]
    assert launches["staged"] == launches["streamed"] == 4
    np.testing.assert_allclose(losses["streamed"], losses["staged"],
                               rtol=1e-4)


def _small_pde(tmp_path, name, data):
    from unet_design_tpu_torch.tasks import pde
    cfg = pde.Config()
    cfg.data.resolution = 16
    cfg.data.trajlen = 6
    cfg.data.n_synthetic = 4
    cfg.data.batch_size = 2
    cfg.data.max_num_steps = 2
    cfg.data.train_cycles = 1
    cfg.model.hidden_channels = 8
    cfg.model.dwt_encoder = True
    cfg.model.multi_res_loss = True
    cfg.train.num_epochs_list = [1, 1]
    cfg.train.freeze_lower_res = True
    cfg.train.logdir = str(tmp_path / name)
    cfg.parallel.data = data
    return cfg


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """``parallel.data=2`` on one card (two ranks over gloo: NCCL refuses
    two ranks on one device): the tiny staged Multi-ResNet's logged series
    against one rank's at rtol 2e-4."""
    import _torch_parallel_runs as runs
    from unet_design_tpu_torch.parallel import mesh
    from unet_design_tpu_torch.tasks import pde
    pde.train(_small_pde(tmp_path, "one", 1))
    two = _small_pde(tmp_path, "two", 2)
    out = mesh.launch(runs.run_arms, {"pde": ("pde", two, None)},
                      parallel=mesh.ParallelConfig(data=2), device="cuda",
                      backend="gloo")
    assert out["pde"] == 4   # 2 epochs of 2 steps

    def series(name):
        with open(tmp_path / name / "metrics.jsonl") as f:
            recs = [json.loads(l) for l in f]
        return {k: [r[k] for r in recs if k in r]
                for k in ("train/loss_mean", "valid/loss/mse",
                          "valid/unrolled_loss_mean")}
    one, got = series("one"), series("two")
    for k in one:
        assert len(one[k]) == 2, k
        np.testing.assert_allclose(got[k], one[k], rtol=2e-4, err_msg=k)


def test_nccl_group_helpers(cuda):
    """The group helpers over NCCL, one rank a card (two where two cards
    are visible): ``chip_smoke.py``'s phase-13 check."""
    import chip_smoke
    from unet_design_tpu_torch.parallel import mesh
    n = min(2, torch.cuda.device_count())
    out = mesh.launch(chip_smoke._nccl_rank,
                      parallel=mesh.ParallelConfig(data=n), device="cuda")
    assert out == {"backend": "nccl", "world": n, "ok": True}
