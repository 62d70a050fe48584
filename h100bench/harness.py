"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Everything that belongs to one cell, configuration, driver or per-layer
metric sits in a file of its own, found by name:

- ``h100bench/cells/<cell>.json``: the configuration, the driver, the
  traffic's parameters, overrides of the program's settings, the limits
  of the output check;
- ``h100bench/configs/<config>.json``: the program's settings, the
  compute dtype, the spans, the source and what was cut;
- ``h100bench/drivers/<driver>.py``: one kind of traffic, which drives the
  program's own entry point (``run(ctx)``);
- ``h100bench/metrics/<metric>.py`` (or ``<base>.py``, the name before its
  first dot): a per-layer metric's reader (``read(r)``: a number, or None
  where it finds nothing to read);
- ``h100bench/reference/<config>.py``: the configuration's plain
  reference.

The run exits with another code than 0 and prints no result without the
cards the cell asks for, or when ``jax``, ``jaxlib``, ``flax``, ``optax``
or the JAX package are loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import copy
import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "h100bench")
BANNED = ("jax", "jaxlib", "flax", "optax", "unet_design_tpu")


def process_start() -> float:
    """This process's start on ``CLOCK_BOOTTIME`` (from ``/proc``), or now
    where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        return int(fields[19]) / ticks
    except (OSError, ValueError, IndexError):
        return boot_clock()


def boot_clock() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def banned_loaded() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`BANNED`,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def deep_merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    for base in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{base}.py")
        if os.path.exists(path):
            return load_module(path, f"h100bench_metric_{base}")
    raise FileNotFoundError(f"no reader for metric {name!r}")


def cell_metrics(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's metrics of ``BENCHMARK.json``: the end-to-end ones
    (``trace`` off) or the per-layer ones."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key]
            if "workloads" not in m or cell in m["workloads"]]


class Context:
    """What a driver is handed."""

    def __init__(self, cell: dict, config: dict, seed: int, seconds: float,
                 trace: bool, device, logdir: str, reference):
        self.cell, self.config = cell, config
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.logdir, self.reference = device, logdir, reference
        self.memory_peak_bytes = 0

    def read_memory_peak(self) -> None:
        """The process's peak on the card, read before the reference
        runs (a process's peak never falls again)."""
        import torch
        if self.device.type == "cuda":
            self.memory_peak_bytes = max(
                torch.cuda.max_memory_reserved(i)
                for i in range(torch.cuda.device_count()))

    def peaks(self):
        """The card's peaks (``counts.PEAKS``), None off the card."""
        import torch
        from h100bench import counts
        if self.device.type != "cuda":
            return None
        return counts.peaks(torch.cuda.get_device_name(0))

    def free(self) -> None:
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def setup_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no JAX
    through ``transformers``; one host thread for the CPU's own kernels
    (the loop that feeds the card is one thread, and a pool of spinning
    workers beside it on a shared host only adds noise)."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    cache = os.path.join(ROOT, ".h100bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_cell(name: str, overrides: Optional[dict] = None):
    cell = _json(os.path.join(HERE, "cells", f"{name}.json"))
    config = _json(os.path.join(HERE, "configs", f"{cell['config']}.json"))
    config["program"] = deep_merge(config["program"],
                                   cell.get("program", {}))
    if overrides:
        cell = deep_merge(cell, overrides.get("cell", {}))
        config = deep_merge(config, overrides.get("config", {}))
    return cell, config


def make_context(workload: str, seed: int, seconds: float, trace: bool,
                 require_cuda: bool = True,
                 overrides: Optional[dict] = None):
    """The manifest, the cell's driver and the context it is handed; None
    for the driver where the cards the cell asks for are not there."""
    manifest = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config = load_cell(workload, overrides)
    # a cell file that BENCHMARK.json does not list yet runs on one card
    entry = {w["name"]: w for w in manifest["workloads"]}.get(
        workload, {"config": cell["config"], "chips": 1})
    import torch
    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < entry["chips"]):
        print(f"needs {entry['chips']} CUDA device(s)", file=sys.stderr)
        return manifest, None, None
    device = torch.device("cuda" if require_cuda else "cpu")
    reference = load_module(
        os.path.join(HERE, "reference", f"{entry['config']}.py"),
        f"h100bench.reference.{entry['config']}")
    driver = load_module(os.path.join(HERE, "drivers",
                                      f"{cell['driver']}.py"),
                         f"h100bench_driver_{cell['driver']}")
    ctx = Context(cell, config, seed, seconds, trace, device,
                  tempfile.mkdtemp(prefix="h100bench-"), reference)
    ctx.chips = entry["chips"]
    return manifest, driver, ctx


def run(argv=None, *, require_cuda: bool = True,
        overrides: Optional[dict] = None, out=None) -> int:
    """One run of a cell: set-up, window, output check; prints the result
    line and returns the exit code.  ``require_cuda`` off and
    ``overrides`` (``{"cell": ..., "config": ...}``) are for the
    benchmark's own tests on the CPU."""
    t_boot = process_start()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    out = out or sys.stdout
    setup_env()
    manifest, driver, ctx = make_context(a.workload, a.seed, a.seconds,
                                         bool(a.trace), require_cuda,
                                         overrides)
    if driver is None:
        return 3
    try:
        res = driver.run(ctx)
    finally:
        shutil.rmtree(ctx.logdir, ignore_errors=True)
    res["setup_s"] = res["window_open_boot"] - t_boot
    found = banned_loaded()
    if found:
        print(f"loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 4
    return report(a, manifest, ctx, res, out)


def report(a, manifest: dict, ctx: Context, res: dict, out) -> int:
    import torch
    metrics = {}
    for m in cell_metrics(manifest, a.workload, bool(a.trace)):
        if a.trace:
            v = metric_reader(m["name"]).read(res["reading"])
        elif m["name"] == "setup_s":
            v = res["setup_s"]
        else:
            # the cell's "e2e" maps a metric's name to its driver's key
            v = res["e2e"].get(ctx.cell.get("e2e", {}).get(m["name"],
                                                         m["name"]))
        if v is None:
            continue
        if not math.isfinite(v):
            raise ValueError(f"{m['name']} = {v}")
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    compared = res["compared"]
    cuda = ctx.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": ctx.chips,
              "memory_peak_bytes": ctx.memory_peak_bytes}
    line = {"correct": all(c["ok"] for c in compared),
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if a.trace:
        st = res["reading"]["stretch"]
        device["busy_s"] = st["busy_s"]
        device["window_s"] = st["window_s"]
        line["breakdown"] = st["breakdown"]
    line["compared"] = {c["name"]: {"value": c["value"],
                                    "limit": c["limit"]} for c in compared}
    for c in compared:
        print(f"compared {c['name']}: {c['value']!r} limit {c['limit']!r}"
              f" {'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    out.write(json.dumps(line) + "\n")
    out.flush()
    return 0


def main() -> None:
    sys.exit(run())
