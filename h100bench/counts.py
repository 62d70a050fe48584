"""Operations and bytes from shapes, and the card's peaks.

The counts come from the plain reference of a configuration, run on the
meta device at the cell's batch with the recipe's gradient flags
(``reference/<config>.py``'s ``meta_step``): the same work whatever kernel
the program runs it with.  Each product and norm is seen through
``reference/_plain.OBSERVER``; the formulas are beside each below.  An
operation is a multiply or an add, so a multiply-add counts two.
Recomputation (rematerialisation) never counts.  Extended from
``unet_design_tpu_torch/benchmark/probe.py::conv_flops``, which counted
forward convolutions only.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from h100bench.reference import _plain

# NVIDIA H100 SXM5 80GB (the data sheet): dense operations per second and
# memory bandwidth.  "fp32" is outside the tensor cores (TF32 off).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32": 67e12, "bf16": 989e12,
                              "bytes_per_s": 3.35e12},
}


def peaks(device_name: str):
    """The card's row of :data:`PEAKS`, or None for a card not in it."""
    return PEAKS.get(device_name)


def conv_flops(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor):
    """``(forward, backward)`` of a 2-D convolution (groups 1):
    forward ``2 * numel(y) * C_in * kh * kw``; the input gradient, where a
    gradient reaches the input, and the weight gradient, where the weight
    takes one, each as many again."""
    fwd = 2 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3]
    return fwd, fwd * (int(x.requires_grad) + int(w.requires_grad))


def dense_flops(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor):
    """``(forward, backward)`` of ``x @ w.T``: forward ``2 * rows * in *
    out``; each gradient as many again, as for a convolution."""
    fwd = 2 * (x.numel() // x.shape[-1]) * w.shape[1] * w.shape[0]
    return fwd, fwd * (int(x.requires_grad) + int(w.requires_grad))


def bmm_flops(a: torch.Tensor, b: torch.Tensor, y: torch.Tensor):
    """``(forward, backward)`` of a batched product ``(n, i, k) @ (n, k,
    j)``: forward ``2 * n * i * k * j``; the gradient of each operand that
    takes one as many again."""
    fwd = 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return fwd, fwd * (int(a.requires_grad) + int(b.requires_grad))


def groupnorm_bytes(x: torch.Tensor, w: torch.Tensor, act_bytes: int):
    """``(forward, backward)`` bytes GroupNorm needs at the activation
    dtype's ``act_bytes``: forward reads the input and writes the output;
    the backward, where it runs, reads the output's gradient and the
    input, and writes the input's gradient where the input takes one.  The
    scale and shift (float32) are read once each way, and their gradients
    written once."""
    n = x.numel() * act_bytes
    p = 2 * w.numel() * 4
    fwd = 2 * n + p
    backward = x.requires_grad or w.requires_grad
    bwd = (2 * n + int(x.requires_grad) * n + 2 * p) if backward else 0
    return fwd, bwd


def pyramid_bytes(x: torch.Tensor, levels, elem_bytes: int) -> int:
    """Bytes of the Haar pyramid: the input read once and every level below
    it written once, ``elem_bytes`` each (the dtype the program's pyramid
    takes)."""
    return (x.numel() + sum(v.numel() for v in levels)) * elem_bytes


class Counter:
    """Sums :func:`conv_flops` and the rest over what the reference runs,
    by class: ``conv``, ``dense``, ``attn`` operations (forward and
    backward) and ``groupnorm``, ``pyramid`` bytes."""

    def __init__(self, act_bytes: int = 4, pyramid_elem_bytes: int = 4):
        self.act_bytes = act_bytes
        self.pyramid_elem_bytes = pyramid_elem_bytes
        self.ops: Dict[str, int] = {"conv": 0, "dense": 0, "attn": 0}
        self.fwd_ops: Dict[str, int] = {"conv": 0, "dense": 0, "attn": 0}
        self.bytes: Dict[str, int] = {"groupnorm": 0, "pyramid": 0}

    def __call__(self, kind: str, *t) -> None:
        # no backward where gradients are off (a sampler's forward)
        grad = torch.is_grad_enabled()
        if kind in ("conv", "dense", "bmm"):
            f, b = {"conv": conv_flops, "dense": dense_flops,
                    "bmm": bmm_flops}[kind](*t)
            key = "attn" if kind == "bmm" else kind
            self.fwd_ops[key] += f
            self.ops[key] += f + b * grad
        elif kind == "groupnorm":
            f, b = groupnorm_bytes(t[0], t[1], self.act_bytes)
            self.bytes["groupnorm"] += f + b * grad
        elif kind == "pyramid":
            self.bytes["pyramid"] += pyramid_bytes(t[0], t[1:],
                                                   self.pyramid_elem_bytes)

    @property
    def total_ops(self) -> int:
        return sum(self.ops.values())


@contextlib.contextmanager
def observing(counter: Counter):
    _plain.OBSERVER[0] = counter
    try:
        yield counter
    finally:
        _plain.OBSERVER[0] = None


def step_counts(reference, cfg: dict, batch: int, **kw) -> Counter:
    """The operations and bytes of one step of ``reference`` (its
    ``meta_step``) at ``batch``."""
    c = Counter(act_bytes=cfg["activation_bytes"],
                pyramid_elem_bytes=cfg.get("pyramid_bytes", 4))
    with observing(c):
        reference.meta_step(cfg, batch, **kw)
    return c
