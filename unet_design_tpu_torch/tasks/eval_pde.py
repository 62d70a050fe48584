"""Score a trained PDE checkpoint on a held-out split.

Port of ``scripts/eval_pde.py`` (``:21-85``), the analog of the
reference's ``trainer.test(ckpt_path="best")`` after fit
(``pdearena/scripts/train.py:82``): it loads the best-validation checkpoint
(``<logdir>/ckpt``) or the latest full-state one (``<logdir>/ckpt_latest``)
that ``tasks/pde.py`` wrote, puts the split on the device, and reports the
one-step and unrolled-rollout losses with bootstrap statistics, through the
trainer's own ``validate_device`` at full resolution (a ``_G`` model with
all its levels; a BatchNorm model on the running statistics that its
checkpoint carries).  The JSON has the JAX script's keys: ``valid/``
renamed to ``<split>/``, plus ``checkpoint_step``.

    python -m unet_design_tpu_torch.tasks.eval_pde --config <yaml> \\
        [key=value ...] [--ckpt best|latest] [--split test] [--out path]

Runs on ``device`` (default ``cuda``); pass ``device=cpu`` for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Sequence

import torch

from unet_design_tpu_torch.data import pde as pde_data
from unet_design_tpu_torch.tasks import pde as pde_task
from unet_design_tpu_torch.train.checkpoint import CheckpointManager
from unet_design_tpu_torch.utils.config import parse_cli


def evaluate(cfg: pde_task.Config, ckpt: str = "best", split: str = "test",
             out: Optional[str] = None) -> Dict[str, float]:
    """Score ``cfg``'s ``ckpt`` checkpoint on ``split``; write the JSON to
    ``out`` (default ``<logdir>/<split>_metrics.json``) and return it."""
    if ckpt not in ("best", "latest"):
        raise ValueError(f"ckpt {ckpt!r}: best or latest")
    device = pde_task.resolve_device(cfg.device)
    model = pde_task.build_model(cfg)
    pde = pde_task.pde_config(cfg.data)

    sub = "ckpt" if ckpt == "best" else "ckpt_latest"
    mgr = CheckpointManager(os.path.join(cfg.train.logdir, sub))
    step = mgr.latest_step()
    model.load_state_dict(mgr.restore(step)["model"], strict=True)
    model.to(device)
    print(f"loaded {ckpt} checkpoint step {step} from "
          f"{cfg.train.logdir}/{sub}", flush=True)

    opener = pde_data.cached_opener(
        pde_task.open_trajectories(cfg.data, split),
        pde.n_scalar_components, pde_task.stack_cache_dir(cfg.data))
    fields = torch.from_numpy(opener.stacked_fields()).to(device)
    print(f"{split} set staged: {tuple(fields.shape)}", flush=True)

    n_levels_used = (getattr(model, "n_levels", None)
                     if pde_task.is_g_model(cfg.model.name) else None)
    result = pde_task.validate_device(cfg, model, pde, n_levels_used, 0,
                                      fields)
    result = {k.replace("valid/", f"{split}/"): float(v)
              for k, v in result.items()}
    result["checkpoint_step"] = int(step)
    print(json.dumps(result, indent=1), flush=True)
    out = out or os.path.join(cfg.train.logdir, f"{split}_metrics.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", out, flush=True)
    return result


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", default="best", choices=["best", "latest"])
    p.add_argument("--split", default="test")
    p.add_argument("--out", default=None,
                   help="JSON output path (default "
                        "<logdir>/<split>_metrics.json)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    cfg = parse_cli(pde_task.Config, ["--config", args.config]
                    + args.overrides)
    return evaluate(cfg, args.ckpt, args.split, args.out)


if __name__ == "__main__":
    main()
