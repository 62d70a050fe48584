"""The numbers that decide ``correct``: what the timed path produced against
the plain reference's own computation of it.

Training (the first three steps of the trainer's own run): each step's
loss; the norm of each trainable leaf's first gradient as the optimizer got
it; the norm of each leaf's change after the three steps.  A gap of norms
is ``|program - reference|`` over the reference's norm of that leaf or of
the median leaf, whichever is larger; the worst leaf, and the median leaf,
give the numbers.  A cell's ``limits`` name the numbers it compares.
A trainable leaf whose reference gradient is under a thousandth of the
median leaf's is left out of the change (it moves by rounding alone).

Sampling: the images of a sample of the finished batches against the
reference's from the same noise and weights: the worst image's RMS
difference.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence

GRAD_FLOOR = 1e-3


def _gaps(prog: Dict[str, float], ref: Dict[str, float],
          names: Sequence[str]) -> List[float]:
    """Each leaf's gap of norms over the reference's norm of that leaf or
    of the median leaf, whichever is larger."""
    if not names:
        return [math.inf]
    med = statistics.median(ref[n] for n in names)
    out = []
    for n in names:
        p = prog.get(n)
        if p is None or not math.isfinite(p):
            return [math.inf]
        den = max(ref[n], med)
        out.append(abs(p - ref[n]) / den if den > 0 else abs(p))
    return out


def training(prog: Dict[str, object], ref: Dict[str, object]
             ) -> Dict[str, float]:
    """``loss`` (the worst step), ``loss1`` (the first step), ``grad1`` and
    ``change`` (the worst leaf), ``grad1_median`` and ``change_median``
    (the median leaf's gap): see the module."""
    lp, lr = prog["loss"], ref["loss"]
    if len(lp) != len(lr):
        steps = [math.inf]
    else:
        steps = [abs(a - b) / abs(b) for a, b in zip(lp, lr)]
    g_ref = ref["grad1"]
    # the optimizer must hold exactly the leaves the recipe trains
    if set(prog["grad1"]) != set(g_ref):
        grad1 = [math.inf]
    else:
        grad1 = _gaps(prog["grad1"], g_ref, list(g_ref))
    floor = GRAD_FLOOR * statistics.median(
        ref["grad_ref"][n] for n in g_ref)
    counted = [n for n in ref["change"]
               if not (n in g_ref and ref["grad_ref"][n] < floor)]
    change = dict(zip(counted, _gaps(prog["change"], ref["change"],
                                     counted)))
    trained = [change.get(n, math.inf) for n in counted if n in g_ref]
    return {"loss": max(steps), "loss1": steps[0], "grad1": max(grad1),
            "grad1_median": statistics.median(grad1),
            "change": max(change.values(), default=math.inf),
            "change_median": statistics.median(trained or [math.inf])}


def images(prog, ref) -> Dict[str, float]:
    """``image_rms``: the largest RMS difference of one image (NHWC
    batches in [-1, 1])."""
    d = (prog.float() - ref.float()).reshape(len(ref), -1)
    return {"image_rms": float(d.square().mean(dim=1).sqrt().max())}


def judge(numbers: Dict[str, float], limits: Dict[str, Optional[float]]
          ) -> List[dict]:
    """Each number the cell's ``limits`` name, beside its limit; one that
    is missing, not finite or without a limit fails."""
    out = []
    for name, lim in limits.items():
        v = numbers.get(name, math.inf)
        ok = lim is not None and math.isfinite(v) and v <= lim
        out.append({"name": name, "value": v, "limit": lim, "ok": ok})
    return out
