"""On the card only: the traced stretch finds device time for the
convolutions, for GroupNorm (forward and backward) and for the program's
Haar kernel, through the launches and the spans, and its busy share stays
within the stretch's wall."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from h100bench import devtrace, spans  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_traced_stretch_attributes_layers(cuda):
    from unet_design_tpu_torch.ops import haar
    conv = torch.nn.Conv2d(16, 16, 3, padding=1).to(cuda)
    norm = torch.nn.GroupNorm(1, 16).to(cuda)
    x = torch.randn(8, 16, 64, 64, device=cuda)

    def step():
        y = norm(conv(x))
        y.square().mean().backward()
        haar.haar_pyramid(x.permute(0, 2, 3, 1).contiguous(), 3)
    for _ in range(3):
        step()
    traced = devtrace.Traced(
        3, torch.cuda.synchronize,
        lambda: spans.layer_spans({
            "groupnorm": "torch.nn:GroupNorm",
            "haar": "unet_design_tpu_torch.ops.haar:haar_pyramid"}))
    traced.begin()
    while True:
        step()
        if traced.step():
            break
    r = traced.read()
    for layer in ("conv", "groupnorm", "haar"):
        assert r["layers"].get(layer, 0) > 0, r["layers"]
    assert 0 < r["busy_s"] <= r["window_s"]
    assert r["breakdown"]["device_ops"]
