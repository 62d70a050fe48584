"""The readings that the output check's limits are set from, on the chip
at the cell's own size, in one process:

    python3 h100bench/calibrate.py --workload <cell> --program <seeds>
        --control <seeds> [--seconds 1] [--out <file>]

- ``--program``: a short run of the cell for each seed (the window's length
  is ``--seconds``); its compared numbers are the program's (the lower
  reading is the largest of them).
- ``--control``: for each seed, the plain reference put in the program's
  place and computed in the configuration's ``control_precision`` (TF32
  for a float32 configuration, float8 operands for a bfloat16 one), and,
  for a training cell, the reference with each fault of its ``faults``
  planted (a step that returns its state unchanged; half of the batch left
  out, the mean taken over the rest), each against the float32 reference.

Prints one JSON line per reading and appends them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from h100bench import compare, harness  # noqa: E402
from h100bench.reference import _plain  # noqa: E402

FAULTS = ("unchanged", "half_batch")


def _emit(rec: dict, out) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def control(workload: str, seed: int, out, require_cuda=True,
            overrides=None) -> None:
    _, driver, ctx = harness.make_context(workload, seed, 0, False,
                                          require_cuda, overrides)
    low = _plain.Precision(ctx.config["control_precision"])
    inp = driver.make_inputs(ctx)
    if hasattr(driver, "reference_images"):
        ref = driver.reference_images(ctx, inp, 0)
        got = driver.reference_images(ctx, inp, 0, prec=low)
        _emit({"cell": workload, "seed": seed, "kind": "control",
               "numbers": compare.images(got, ref)}, out)
        return
    ref = driver.reference_readings(ctx, inp)
    for kind, kw in [("control", {"prec": low})] + [
            (f"fault:{f}", {"fault": f}) for f in FAULTS]:
        got = driver.reference_readings(ctx, inp, **kw)
        _emit({"cell": workload, "seed": seed, "kind": kind,
               "numbers": compare.training(got, ref)}, out)


def program(workload: str, seed: int, seconds: float, out,
            require_cuda=True, overrides=None) -> None:
    _, driver, ctx = harness.make_context(workload, seed, seconds, False,
                                          require_cuda, overrides)
    try:
        res = driver.run(ctx)
    finally:
        shutil.rmtree(ctx.logdir, ignore_errors=True)
    _emit({"cell": workload, "seed": seed, "kind": "program",
           "numbers": res["numbers"],
           "e2e": res["e2e"]}, out)
    ctx.free()


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--program", default="")
    p.add_argument("--control", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    harness.setup_env()
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    for s in filter(None, a.control.split(",")):
        control(a.workload, int(s), a.out)
    for s in filter(None, a.program.split(",")):
        program(a.workload, int(s), a.seconds, a.out)


if __name__ == "__main__":
    main()
