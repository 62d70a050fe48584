"""The rest of a run, on the CPU at a small size, with the timed path sound
and then broken underneath: the sound run comes out correct under the
committed limits, and each fault the cell can have makes ``correct``
false.

Faults: a step that returns its state unchanged (the optimizer steps, then
the parameters are put back); half of the batch left out, the mean taken
over the rest; a sampler's image altered where it is produced."""

import io
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _h100bench_small import DDPM, PDE  # noqa: E402
from h100bench import harness  # noqa: E402

SIZES = {"ns2d.train_last_stage": PDE, "cifar.train_last_stage": DDPM,
         "cifar.sample_dpm20": DDPM}


def run_cell(cell):
    out = io.StringIO()
    rc = harness.run(["--workload", cell, "--seed", "3000000123",
                      "--seconds", "0.3", "--trace", "0"],
                     require_cuda=False, overrides=SIZES[cell], out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def unchanged(monkeypatch):
    """Every optimizer step puts the parameters back as they were (the
    unhooked step inside, so the step hooks see what it returns)."""
    for cls in (torch.optim.Adam, torch.optim.AdamW):
        step = getattr(cls.step, "__wrapped__", cls.step)

        def put_back(self, *a, _step=step, **k):
            saved = [p.detach().clone() for g in self.param_groups
                     for p in g["params"]]
            out = _step(self, *a, **k)
            with torch.no_grad():
                for p, s in zip((p for g in self.param_groups
                                 for p in g["params"]), saved):
                    p.copy_(s)
            return out
        monkeypatch.setattr(cls, "step", put_back)


def half_batch_pde(monkeypatch):
    from unet_design_tpu_torch.tasks import pde
    gather = pde._gather_windows

    def half(*a, **k):
        x, y = gather(*a, **k)
        return x[: len(x) // 2], y[: len(y) // 2]
    monkeypatch.setattr(pde, "_gather_windows", half)


def half_batch_ddpm(monkeypatch):
    from unet_design_tpu_torch.data import image
    flip = image.horizontal_flip
    monkeypatch.setattr(image, "horizontal_flip",
                        lambda x, f: flip(x, f)[: len(x) // 2])


def altered_image(monkeypatch):
    from unet_design_tpu_torch.tasks import diff_cifar
    make = diff_cifar.make_sampler

    def make_altered(*a, **k):
        sampler = make(*a, **k)

        def altered(x_T, generator=None):
            out = sampler(x_T, generator)
            out[0] = -out[0]
            return out
        return altered
    monkeypatch.setattr(diff_cifar, "make_sampler", make_altered)


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_sound_run_is_correct(cell):
    line = run_cell(cell)
    assert line["correct"], line["compared"]
    assert list(line)[-1] == "compared"
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("cell,fault", [
    ("ns2d.train_last_stage", unchanged),
    ("ns2d.train_last_stage", half_batch_pde),
    ("cifar.train_last_stage", unchanged),
    ("cifar.train_last_stage", half_batch_ddpm),
    ("cifar.sample_dpm20", altered_image),
], ids=lambda v: getattr(v, "__name__", v))
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    fault(monkeypatch)
    line = run_cell(cell)
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_traced_run_ends_cleanly(cell):
    """A traced run reads its stretches and prints them; its profiler
    sessions start and stop outside the optimizer's profiler scope (inside
    it the CPU profiler corrupts its heap now and then)."""
    out = io.StringIO()
    rc = harness.run(["--workload", cell, "--seed", "3000000124",
                      "--seconds", "0.3", "--trace", "1"],
                     require_cuda=False, overrides=SIZES[cell], out=out)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
