"""Each plain reference against the program at small widths on the CPU:
the same weights give the same forward; three training steps (loss,
gradients, optimizer update) and two DPM-Solver steps agree through the
harness's own comparison; and each configuration's control, the reference
in the next precision below the configuration's, comes out not correct
under the committed limits (TF32 exists only on the card: that control's
test carries the ``cuda`` marker)."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _h100bench_small import DDPM, PDE  # noqa: E402
from h100bench import compare, harness  # noqa: E402
from h100bench.reference import _plain  # noqa: E402


def _context(cell, overrides, device="cpu"):
    _, driver, ctx = harness.make_context(
        cell, 3000000777, 0, False, require_cuda=device != "cpu",
        overrides=overrides)
    return driver, ctx


def test_unetbase_g_forward_matches_the_program():
    from unet_design_tpu_torch.tasks import pde
    from unet_design_tpu_torch.utils.config import from_dict
    driver, ctx = _context("ns2d.train_last_stage", PDE)
    inp = driver.make_inputs(ctx)
    prog = pde.build_model(from_dict(pde.Config, ctx.config["program"]))
    prog.load_state_dict(inp["start"])
    ref = ctx.reference.build_model(ctx.config)
    ref.load_state_dict(inp["start"])
    x = inp["fields"][:2, :4]
    with torch.no_grad():
        for a, b in zip(prog(x, n_levels_used=4), ref(x, 4)):
            assert torch.allclose(a, b, rtol=1e-5, atol=1e-5 * b.abs().max())


def test_multires_unet_forward_matches_the_program():
    from unet_design_tpu_torch.tasks import diff_cifar
    from unet_design_tpu_torch.utils.config import from_dict
    driver, ctx = _context("cifar.train_last_stage", DDPM)
    inp = driver.make_inputs(ctx)
    prog = diff_cifar.build_model(from_dict(diff_cifar.Config,
                                            ctx.config["program"]))
    prog.load_state_dict(inp["start"])
    ref = ctx.reference.build_model(ctx.config)
    ref.load_state_dict(inp["start"])
    x, t = inp["images"][:2], torch.tensor([5, 900])
    with torch.no_grad():
        for a, b in zip(prog(x, t, n_levels_used=2), ref(x, t, 2)):
            assert torch.allclose(a, b, rtol=1e-4, atol=1e-4 * b.abs().max())


def _limits(cell):
    return harness.load_cell(cell)[0]["limits"]


@pytest.mark.parametrize("cell", ["cifar.train_last_stage",
                                  "cifar.sample_dpm20"])
def test_fp8_control_is_not_correct(cell):
    driver, ctx = _context(cell, DDPM)
    low = _plain.Precision(ctx.config["control_precision"])
    assert low.name == "fp8"
    inp = driver.make_inputs(ctx)
    if cell.endswith("sample_dpm20"):
        numbers = compare.images(driver.reference_images(ctx, inp, 0, low),
                                 driver.reference_images(ctx, inp, 0))
    else:
        numbers = compare.training(driver.reference_readings(ctx, inp, low),
                                   driver.reference_readings(ctx, inp))
    assert not all(c["ok"] for c in compare.judge(numbers, _limits(cell)))


@pytest.mark.cuda
def test_tf32_control_is_not_correct(cuda):
    driver, ctx = _context("ns2d.train_last_stage", PDE, device="cuda")
    low = _plain.Precision(ctx.config["control_precision"])
    assert low.name == "tf32"
    inp = driver.make_inputs(ctx)
    numbers = compare.training(driver.reference_readings(ctx, inp, low),
                               driver.reference_readings(ctx, inp))
    assert not all(c["ok"] for c in compare.judge(
        numbers, _limits("ns2d.train_last_stage")))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (TF32 exists only there)")
    return torch.device("cuda")
