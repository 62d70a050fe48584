"""The operation counts from the references' shapes against
``torch.utils.flop_counter.FlopCounterMode`` on the program's models
(small widths, forward and backward, with the recipe's frozen set), and
the byte counts of GroupNorm and the Haar pyramid from shapes."""

import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from h100bench import counts, harness  # noqa: E402

PDE_SMALL = {"config": {"program": {"model": {"hidden_channels": 8},
                                    "data": {"resolution": 32}}}}
DDPM_SMALL = {"config": {"n_levels": 2, "program": {
    "model": {"ch": 32, "ch_mult": [1, 2], "attn": [1],
              "num_res_blocks": 1, "use_bf16": False},
    "data": {"batch_size": 2},
    "train": {"num_iterations_list": [0, 10]}}}}


def _ref(name):
    return harness.load_module(
        os.path.join(ROOT, "h100bench", "reference", f"{name}.py"),
        f"h100bench.reference.{name}")


def _flop_counter(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_unetbase_g_step_matches_flop_counter():
    from unet_design_tpu_torch.tasks import pde
    from unet_design_tpu_torch.utils.config import from_dict
    _, cfgj = harness.load_cell("ns2d.train_last_stage", PDE_SMALL)
    ref = _ref("unetbase64g_ns2d")
    cfg = from_dict(pde.Config, cfgj["program"])
    model = pde.build_model(cfg)
    names = [n for n, _ in model.named_parameters()]
    keep = ref.trainable(names, 4, 4)
    assert 0 < len(keep) < len(names)
    for n, p in model.named_parameters():
        p.requires_grad_(n in keep)
    x = torch.randn(2, 4, 32, 32, 3)

    def step():
        out = model(x, n_levels_used=4)
        sum(o.square().mean() for o in out).backward()
    want = _flop_counter(step)
    got = counts.step_counts(ref, cfgj, 2)
    assert got.total_ops == want
    assert got.ops["conv"] == want


def test_multires_unet_step_and_forward_match_flop_counter():
    from unet_design_tpu_torch.tasks import diff_cifar
    from unet_design_tpu_torch.utils.config import from_dict
    _, cfgj = harness.load_cell("cifar.train_last_stage", DDPM_SMALL)
    ref = _ref("multiresunet_cifar10")
    model = diff_cifar.build_model(from_dict(diff_cifar.Config,
                                             cfgj["program"]))
    x = torch.randn(2, 32, 32, 3)
    t = torch.tensor([3, 700])

    def step():
        out = model(x, t, n_levels_used=2)
        sum(o.square().mean() for o in out).backward()
    want = _flop_counter(step)
    got = counts.step_counts(ref, cfgj, 2)
    assert got.total_ops == want
    assert got.ops["attn"] > 0 and got.ops["dense"] > 0
    with torch.no_grad():
        fwd = _flop_counter(lambda: model(x, t, n_levels_used=2))
    assert counts.step_counts(ref, cfgj, 2, train=False).total_ops == fwd


def test_frozen_set_removes_weight_gradients_only():
    _, cfgj = harness.load_cell("ns2d.train_last_stage", PDE_SMALL)
    ref = _ref("unetbase64g_ns2d")
    c = counts.step_counts(ref, cfgj, 2)
    fwd = c.fwd_ops["conv"]
    # every conv but the first takes an input gradient; only the
    # trainable ones a weight gradient
    assert fwd < c.ops["conv"] < 3 * fwd


@pytest.mark.parametrize("requires_x,requires_w,want", [
    (True, True, (2 * 4 + 8, 3 * 4 + 16)),
    (False, True, (2 * 4 + 8, 2 * 4 + 16)),
    (False, False, (2 * 4 + 8, 0)),
])
def test_groupnorm_bytes(requires_x, requires_w, want):
    x = torch.zeros(1, 2, 1, 1, requires_grad=requires_x)   # 2 values
    w = torch.zeros(1, requires_grad=requires_w)
    # 2 values x 2 bytes = 4 per pass; scale and shift 2 x 4 bytes
    assert counts.groupnorm_bytes(x, w, 2) == want


def test_pyramid_bytes():
    x = torch.zeros(8, 128, 128, 3)
    levels = [torch.zeros(8, 128 >> k, 128 >> k, 3) for k in (1, 2, 3)]
    # the kernel table's (8,128,128,3) L4 figure
    assert counts.pyramid_bytes(x, levels, 4) == 2_088_960


def test_conv_dense_and_bmm_formulas():
    x = torch.zeros(2, 3, 8, 8, requires_grad=True)
    w = torch.zeros(5, 3, 3, 3)
    y = torch.zeros(2, 5, 8, 8)
    assert counts.conv_flops(x, w, y) == (2 * 2 * 5 * 64 * 27, 2 * 5 * 64
                                          * 27 * 2)
    a = torch.zeros(4, 6, 7)
    b = torch.zeros(4, 7, 9, requires_grad=True)
    assert counts.bmm_flops(a, b, None) == (2 * 4 * 6 * 7 * 9,
                                            2 * 4 * 6 * 7 * 9)
    xd = torch.zeros(3, 10)
    wd = torch.zeros(4, 10, requires_grad=True)
    assert counts.dense_flops(xd, wd, None) == (2 * 3 * 10 * 4,
                                                2 * 3 * 10 * 4)
