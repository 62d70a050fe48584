"""The window over a trainer that runs in its own loop.

The harness counts the trainer's optimizer steps from outside it, through
PyTorch's global optimizer-step post-hook: one CUDA event a step, no
synchronisation.  The first ``warmup`` steps are set-up (the first three
also feed the output check); then the window opens, and once it has run
its seconds the hook ends the trainer by raising :class:`WindowClosed`, so
the trainer's own epoch ends, validation and checkpoints never fall in the
window.  In a traced run the two profiled stretches of
``devtrace.Traced`` follow the window, started and stopped at the first
module call of a step, before the harness raises.

What the output check reads of the first steps, without the program's
help: the loss each step returned (the driver wraps the loss function the
trainer calls), the norm of each leaf's first gradient as the optimizer got
it (worked out from Adam's first moment after step 1: ``m_1 = (1 - beta1)
g_1``), and the norm of each leaf's change after three steps.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from h100bench import compare, counts, devtrace

CHECK_STEPS = 3


class WindowClosed(Exception):
    """Raised from the step hook to end the trainer."""


class Capture:
    """The readings of the trainer's first :data:`CHECK_STEPS` steps."""

    def __init__(self, start: Dict[str, torch.Tensor]):
        self.start = start           # the parameters handed to the trainer
        self.model: Optional[torch.nn.Module] = None
        self.losses: List[torch.Tensor] = []
        self.grad1: Dict[str, torch.Tensor] = {}
        self.change: Dict[str, torch.Tensor] = {}

    def wrap_build(self, build: Callable) -> Callable:
        """``build`` (the trainer's model builder), remembering its model."""
        def wrapped(*a, **k):
            self.model = build(*a, **k)
            return self.model
        return wrapped

    def wrap_loss(self, fn: Callable, pick=lambda out: out) -> Callable:
        """``fn`` (the loss the trainer calls once a step), remembering the
        first steps' losses (``pick`` takes the loss from its result)."""
        def wrapped(*a, **k):
            out = fn(*a, **k)
            if len(self.losses) < CHECK_STEPS:
                self.losses.append(pick(out).detach().float().clone())
            return out
        return wrapped

    @torch.no_grad()
    def on_step(self, k: int, opt: torch.optim.Optimizer) -> None:
        if k == 1:
            names = {id(p): n for n, p in self.model.named_parameters()}
            beta1 = opt.param_groups[0]["betas"][0]
            for group in opt.param_groups:
                for p in group["params"]:
                    m = opt.state[p]["exp_avg"]
                    self.grad1[names[id(p)]] = (
                        torch.linalg.vector_norm(m.double()) / (1 - beta1))
        if k == CHECK_STEPS:
            for n, p in self.model.named_parameters():
                self.change[n] = torch.linalg.vector_norm(
                    (p.detach() - self.start[n].to(p.device)).double())

    def readings(self) -> Dict[str, object]:
        """The captured numbers as floats (this synchronises)."""
        return {"loss": [float(v) for v in self.losses],
                "grad1": {n: float(v) for n, v in self.grad1.items()},
                "change": {n: float(v) for n, v in self.change.items()}}


class Clock:
    """Step marks on the device (CUDA events) or, on the CPU, the host."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def intervals_ms(self, marks) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]


class TrainWindow:
    """Warm-up, window and (traced) stretches over a trainer's steps."""

    def __init__(self, seconds: float, warmup: int, device: torch.device,
                 capture: Capture, trace: bool = False,
                 stretch_steps: int = 20, spans: Optional[Callable] = None):
        if warmup < CHECK_STEPS + 1:
            raise ValueError("the warm-up holds the checked steps")
        self.seconds, self.warmup = seconds, warmup
        self.clock = Clock(device)
        self.capture = capture
        self.trace, self.stretch_steps = trace, stretch_steps
        self.steps = 0
        self.marks: list = []
        self.t0 = self.t_end = self.t0_boot = None
        self.window_steps = 0
        # spans: () -> context manager of the layer spans
        self.traced = devtrace.Traced(stretch_steps, self.clock.sync, spans)
        self._handles = []
        self._due = False    # a traced step is due at the next forward
        # ended inside an optimizer step (else at the next step's start)
        self.ended_in_step = False

    def __enter__(self):
        from torch.optim.optimizer import register_optimizer_step_post_hook
        self._handles = [register_optimizer_step_post_hook(self._hook)]
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self.traced.close()
        return exc[0] is WindowClosed

    def _traced_step(self, module, args) -> None:
        """The traced stretches start and stop at the first module call of
        a step (a forward pre-hook): the optimizer's post-hooks run inside
        its ``Optimizer.step`` profiler scope, and a profiler session must
        not start or stop inside an open scope."""
        if not self._due:
            return
        self._due = False
        if self.traced.count == 0 and self.traced.device.t0 is None:
            self.traced.begin()
        elif self.traced.step():
            raise WindowClosed

    def _hook(self, opt, args, kwargs) -> None:
        self.steps += 1
        if self.steps <= CHECK_STEPS:
            self.capture.on_step(self.steps, opt)
        if self.steps < self.warmup:
            return
        if self.steps == self.warmup:
            self.clock.sync()
            self.t0_boot = time.clock_gettime(time.CLOCK_BOOTTIME)
            self.t0 = time.perf_counter()
            self.marks = [self.clock.mark()]
            return
        if self.t_end is None:
            self.marks.append(self.clock.mark())
            if time.perf_counter() - self.t0 < self.seconds:
                return
            self.clock.sync()
            self.t_end = time.perf_counter()
            self.window_steps = self.steps - self.warmup
            if not self.trace:
                self.ended_in_step = True
                raise WindowClosed
            self._handles.append(
                torch.nn.modules.module.register_module_forward_pre_hook(
                    self._traced_step))
        self._due = True

    @property
    def closed(self) -> bool:
        return self.t_end is not None

    def results(self, batch: int) -> Dict[str, object]:
        """``train_samples_per_s``: the global batch times the steps
        completed in the window over its seconds, from the first timed
        step's start to the device's completion of the last step that
        started inside it; ``train_step_ms_p95``: the 95th percentile of
        the intervals between the steps' marks."""
        iv = self.clock.intervals_ms(self.marks)
        secs = self.t_end - self.t0
        return {"train_samples_per_s": batch * self.window_steps / secs,
                "train_step_ms_p95": float(np.percentile(iv, 95)),
                "window_s": secs, "window_steps": self.window_steps,
                "stretch_steps": self.stretch_steps if self.trace else 0}


@contextlib.contextmanager
def patched(patches):
    """Set ``(module, name, value)`` attributes for the run, restoring the
    program's own after."""
    saved = [(m, k, getattr(m, k)) for m, k, _ in patches]
    try:
        for m, k, v in patches:
            setattr(m, k, v)
        yield
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


def finish(ctx, win: TrainWindow, batch: int,
           reference_readings: Callable[[], dict]) -> dict:
    """The driver's result once the trainer has been ended: the window's
    metrics; the card's peak, read before the reference runs; the
    reference's readings of the same steps (``reference_readings``, called
    once the program's model is let go) against the program's; in a traced
    run, what the per-layer metrics read."""
    if not win.closed or (win.trace and not win.traced.done):
        raise RuntimeError("the trainer ended before the window closed")
    res = win.results(batch)
    ctx.read_memory_peak()
    prog = win.capture.readings()
    win.capture.model = None
    win.capture = None
    ctx.free()
    numbers = compare.training(prog, reference_readings())
    out = {"e2e": {k: res[k] for k in ("train_samples_per_s",
                                       "train_step_ms_p95")},
           "window_open_boot": win.t0_boot,
           "attempted": res["window_steps"], "failed": 0, "numbers": numbers,
           "compared": compare.judge(numbers, ctx.cell["limits"])}
    if win.trace:
        cfg = ctx.config
        c = counts.step_counts(ctx.reference, cfg, batch)
        out["reading"] = {
            "ops_per_step": c.total_ops, "ops": c.ops, "bytes": c.bytes,
            "window_s": res["window_s"], "window_steps": res["window_steps"],
            "stretch_steps": res["stretch_steps"],
            "stretch": win.traced.read(), "peaks": ctx.peaks(),
            "dtype": cfg["compute_dtype"]}
    return out
