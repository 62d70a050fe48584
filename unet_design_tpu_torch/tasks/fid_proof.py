"""The FID milestone curve of the CIFAR DDPM: train, and score the EMA at
milestones against the dataset's statistics.

Port of ``scripts/fid_proof.py``.  The dataset's Inception statistics are
written with :class:`~unet_design_tpu_torch.evalx.fid.FIDEvaluator`
(``dataset_stats.npz``); the untrained model (initialised from seed 123)
is scored once (``fid_before.json``); then ``tasks.diff_cifar.train``
trains to each milestone in turn, resuming in between, and
``diff_cifar.evaluate`` scores the EMA there (a fresh generator seeded 7
for every score).  Every point is written to ``fid_proof.json``
(``fid_curve``, ``kid_curve``, ``staged_curve``, ``fid_decreased``, ...)
as soon as it is scored.

Modes: ``--steps N`` (one milestone), ``--milestones a,b,...``
(cumulative steps), ``--stages a,b,...`` (the staged schedule's per-stage
steps: each stage boundary is scored at that stage's resolution and level
count against ``dataset_stats_res<r>.npz``, the dataset Haar-downsampled
to it), ``--resume`` (continue the logdir's run and curve),
``--eval-only`` (score the latest checkpoint) and ``--rescore`` (score the
kept ``--milestones`` checkpoints at ``--images`` into
``fid_proof_rescore_<images>.json``, the main artifact untouched).

Unlike the JAX script, a checkpoint that sits exactly at a milestone is
restored and scored, not trained from (there ``latest > m`` sent it into
``train``, and every ``--resume`` from that state crashed), and the stop
files between milestones are the DDPM trainer's (``train.trainer.
STOP_FILES`` in the logdir).

Without the ``pt_inception`` weights the Inception network is random
(``random-he-sqrt2-torch``): a valid two-sample discrepancy that must
shrink as the samples approach the data, but not comparable to published
FIDs; the artifact says so.

  python -m unet_design_tpu_torch.tasks.fid_proof --steps 3000 --images 1024
  python -m unet_design_tpu_torch.tasks.fid_proof --stages 750,750,750,750
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Mapping

import numpy as np
import torch

from unet_design_tpu_torch.data import image as image_data
from unet_design_tpu_torch.evalx import fid
from unet_design_tpu_torch.ops import blocks, wavelet
from unet_design_tpu_torch.process import diffusion
from unet_design_tpu_torch.tasks import diff_cifar
from unet_design_tpu_torch.train import checkpoint, trainer
from unet_design_tpu_torch.utils.device import resolve_device

NOTE = ("random seeded Inception weights (random-he-sqrt2-torch; the "
        "pt_inception .pth is not available); absolute FID not comparable "
        "to published numbers")
STAGED_NOTE = ("sequential NUM_ITERATIONS_LIST schedule (the reference's "
               "4-stage recipe, scaled); intermediate stages are scored at "
               "their own resolution against same-resolution "
               "Haar-downsampled dataset stats, so only same-resolution "
               "points are mutually comparable")
RESCORE_NOTE = ("random-feature FID at a larger sample count; variance "
                "check on the main curve's tail")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--images", type=int, default=1024)
    p.add_argument("--dataset-size", type=int, default=4096)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--sample-steps", type=int, default=25)
    p.add_argument("--logdir", default="runs/fid_proof")
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "cifar10"])
    p.add_argument("--ch", type=int, default=128,
                   help="model width (128 = the reference 35.7M config)")
    p.add_argument("--eval-batch", type=int, default=256)
    p.add_argument("--eval-only", action="store_true",
                   help="re-score an existing run's checkpoint (no training)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the logdir's latest checkpoint")
    p.add_argument("--rescore", action="store_true",
                   help="no training: re-score the kept --milestones "
                        "checkpoints at the current --images count, writing "
                        "fid_proof_rescore_<images>.json (the main artifact "
                        "is left untouched: different sample counts are "
                        "not comparable points on one curve)")
    p.add_argument("--milestones", default=None,
                   help="comma-separated cumulative step counts; train to "
                        "each in turn (resuming in between) and score FID "
                        "at every milestone, recording the full curve")
    p.add_argument("--stages", default=None,
                   help="comma-separated PER-STAGE iteration counts of the "
                        "staged training algorithm (the reference's "
                        "NUM_ITERATIONS_LIST: 4 stages, DWT / freezing / "
                        "multi-res loss off).  Each stage boundary is "
                        "scored at that stage's own resolution against "
                        "same-resolution Haar-downsampled dataset stats; "
                        "the final stage runs at full resolution.  "
                        "Exclusive with --milestones.")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda fails without a GPU)")
    args = p.parse_args(argv)
    if args.stages and args.milestones:
        p.error("--stages and --milestones are exclusive")
    if args.rescore and not args.milestones:
        p.error("--rescore needs explicit --milestones")
    args.stage_iters = ([int(s) for s in args.stages.split(",")]
                        if args.stages else None)
    if args.stage_iters:
        args.milestone_list = list(np.cumsum(args.stage_iters).tolist())
    elif args.milestones:
        args.milestone_list = [int(s) for s in args.milestones.split(",")]
        if args.milestone_list != sorted(args.milestone_list):
            p.error(f"--milestones must increase: {args.milestones}")
    else:
        args.milestone_list = [args.steps]
    return args


def make_config(args: argparse.Namespace) -> diff_cifar.Config:
    """The run's DDPM config: ``diff_cifar.Config()`` (DWT encoder,
    multi-res loss and freezing off) at width ``--ch`` in bf16, DPM-Solver
    with ``--sample-steps``, warmup 500."""
    cfg = diff_cifar.Config()
    cfg.data.dataset = args.dataset
    cfg.data.synthetic_size = args.dataset_size
    cfg.data.batch_size = args.batch_size
    cfg.model.ch = args.ch
    cfg.model.use_bf16 = True
    cfg.diffusion.sampler = "dpm_solver"
    cfg.diffusion.sample_steps = args.sample_steps
    cfg.train.num_iterations_list = list(args.stage_iters or [args.steps])
    cfg.train.warmup = 500
    cfg.train.logdir = args.logdir
    cfg.train.metrics_every_iters = 200
    cfg.train.fid_stats_cache = os.path.join(args.logdir,
                                             "dataset_stats.npz")
    cfg.device = args.device
    return cfg


def stage_images(data: np.ndarray, n_downsample: int,
                 device: torch.device) -> np.ndarray:
    """``data`` (N, H, W, C) Haar-downsampled ``n_downsample`` octaves (the
    training batches' resolution at that stage) on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(data)).to(device)
    return wavelet.haar_downsample(x, n_downsample).cpu().numpy()


def _reusable(path: str, device: torch.device) -> bool:
    """``path`` exists and was written by this evaluator's network."""
    if not os.path.exists(path):
        return False
    try:
        fid.FIDEvaluator(stats_cache=path, device=device)
        return True
    except ValueError:
        return False


def save_stats(images: np.ndarray, path: str, device: torch.device) -> None:
    """Inception statistics of ``images`` in [-1, 1], read as [0, 1]."""
    fid.FIDEvaluator(stats_cache=None, batch_size=100,
                     device=device).save_reference_stats(
        (images + 1.0) / 2.0, path)


def _scalars(scores: Mapping) -> Dict[str, float]:
    return {k: v for k, v in scores.items() if np.isscalar(v)}


def main(argv=None):
    args = parse_args(argv)
    milestones = args.milestone_list
    stage_iters = args.stage_iters
    device = resolve_device(args.device)
    cfg = make_config(args)
    stats_path = cfg.train.fid_stats_cache
    os.makedirs(args.logdir, exist_ok=True)
    continuing = args.eval_only or args.resume or args.rescore

    # dataset statistics (images in [0, 1], as the reference feeds
    # Inception); a same-run continuation reuses them
    if args.dataset == "cifar10":
        data, _ = image_data.load_cifar10(cfg.data.root, train=True)
    else:
        data, _ = image_data.synthetic_cifar10(cfg.data.synthetic_size)
    data = data[:args.dataset_size]
    if continuing and _reusable(stats_path, device):
        print("reusing dataset stats:", stats_path, flush=True)
    else:
        save_stats(data, stats_path, device)
        print("dataset stats saved:", stats_path, flush=True)

    model = diff_cifar.build_model(cfg)
    blocks.ddpm_init_(model, torch.Generator().manual_seed(123))
    model.to(device)
    init_params = {n: p.detach() for n, p in model.named_parameters()}
    sch = diffusion.DDPMSchedule.create(cfg.diffusion.beta_1,
                                        cfg.diffusion.beta_T,
                                        cfg.diffusion.T).to(device)

    def score(params, n_levels_used, resolution):
        return diff_cifar.evaluate(
            cfg, model, params, sch, n_levels_used, resolution,
            num_images=args.images, batch_size=args.eval_batch,
            generator=torch.Generator(device).manual_seed(7))

    def restore_ema(ckpt, step):
        return {k: v.to(device)
                for k, v in ckpt.restore(step)["ema"].items()}

    # the untrained model's scores; a continuation of the same run reuses
    # the artifact's, or fid_before.json (written right after scoring, so
    # a stop before the first milestone does not sample it again)
    proof_path = os.path.join(args.logdir, "fid_proof.json")
    before_path = os.path.join(args.logdir, "fid_before.json")
    prev = None
    if continuing and os.path.exists(proof_path):
        with open(proof_path) as f:
            prev = json.load(f)
    before = None
    if prev is not None and prev.get("fid_untrained") is not None:
        before = {"FID": prev["fid_untrained"],
                  "IS": prev.get("is_untrained"),
                  "KID": prev.get("kid_untrained")}
        print("reusing untrained FID from", proof_path, flush=True)
    elif continuing and os.path.exists(before_path):
        with open(before_path) as f:
            before = json.load(f)
        print("reusing untrained FID from", before_path, flush=True)
    if before is None:
        before = _scalars(score(init_params, model.n_levels, 32))
        with open(before_path, "w") as f:
            json.dump(before, f, indent=1)
        print("FID before training:", json.dumps(before), flush=True)

    # a continuation extends the existing curve
    curve: Dict[str, float] = {}
    kcurve: Dict[str, float] = {}
    staged_curve = []
    if prev is not None:
        curve.update(prev.get("fid_curve", {}))
        kcurve.update(prev.get("kid_curve", {}))
        staged_curve = list(prev.get("staged_curve", []))
        if prev.get("train_steps") and prev.get("fid_trained") is not None:
            curve.setdefault(str(prev["train_steps"]), prev["fid_trained"])

    def write_artifact(after, total_steps):
        out = {"fid_untrained": before.get("FID"),
               "fid_trained": after.get("FID"),
               "is_untrained": before.get("IS"),
               "is_trained": after.get("IS"),
               "kid_untrained": before.get("KID"),
               "kid_trained": after.get("KID"),
               "train_steps": total_steps, "n_images": args.images,
               "fid_curve": {k: curve[k] for k in sorted(curve, key=int)},
               "kid_curve": {k: kcurve[k] for k in sorted(kcurve, key=int)},
               "note": NOTE}
        if staged_curve:
            out["staged_curve"] = staged_curve
            out["staged_note"] = STAGED_NOTE
        out["fid_decreased"] = bool(after.get("FID", 1e9)
                                    < before.get("FID", 0.0))
        with open(proof_path, "w") as f:
            json.dump(out, f, indent=1)
        return out

    ckpt_dir = os.path.join(args.logdir, "ckpt")
    if args.rescore:
        src = checkpoint.CheckpointManager(ckpt_dir)
        out_path = os.path.join(args.logdir,
                                f"fid_proof_rescore_{args.images}.json")
        rcurve, rkcurve = {}, {}
        for m in milestones:
            try:
                ema = restore_ema(src, m)
            except FileNotFoundError:
                print(f"rescore: no step-{m} checkpoint kept; skipping",
                      flush=True)
                continue
            r = score(ema, model.n_levels, 32)
            rcurve[str(m)] = r.get("FID")
            if r.get("KID") is not None:
                rkcurve[str(m)] = r["KID"]
            print(f"rescore FID at {m} steps:", json.dumps(_scalars(r)),
                  flush=True)
            with open(out_path, "w") as f:   # each point as it comes
                json.dump({"n_images": args.images,
                           "fid_untrained": before.get("FID"),
                           "fid_curve": rcurve, "kid_curve": rkcurve,
                           "note": RESCORE_NOTE}, f, indent=1)
        print(json.dumps({"fid_curve": rcurve, "n_images": args.images},
                         indent=1))
        return

    if args.eval_only:
        src = checkpoint.CheckpointManager(ckpt_dir)
        total_steps = src.latest_step()
        print("eval-only: restored step", total_steps, flush=True)
        after = score(restore_ema(src, total_steps), model.n_levels, 32)
        curve[str(total_steps)] = after.get("FID")
        if after.get("KID") is not None:
            kcurve[str(total_steps)] = after["KID"]
    else:
        after = before
        # never rewrite the artifact's trained numbers from `before` when
        # every milestone was skipped
        scored_any = False
        total_steps = 0
        cfg.train.resume = args.resume

        def stats_for(nd, res):
            """The dataset statistics at a stage's resolution."""
            if nd == 0:
                return stats_path
            path = os.path.join(args.logdir, f"dataset_stats_res{res}.npz")
            if not _reusable(path, device):
                save_stats(stage_images(data, nd, device), path, device)
                print(f"stage dataset stats saved: {path}", flush=True)
            return path

        for j, m in enumerate(milestones):
            # every milestone so far is persisted: a stop file ends the run
            # here, and --resume continues the curve
            stop = trainer.stop_file_present(diff_cifar.STOP_FILES,
                                             args.logdir)
            if stop:
                print(f"stop file {stop}: exiting before milestone {m} "
                      f"(resume with --resume to continue the curve)",
                      flush=True)
                break
            if stage_iters and len(stage_iters) > 1:
                # stage j trains n_levels_used = j + 1 at 32 >> nd
                # (trainer.StageSpec.from_schedule)
                nl, nd = j + 1, model.n_levels - 1 - j
            else:
                nl, nd = model.n_levels, 0
            res = 32 >> nd
            cfg.train.fid_stats_cache = stats_for(nd, res)
            ckpt = checkpoint.CheckpointManager(ckpt_dir)
            latest = (ckpt.latest_step() or 0) if cfg.train.resume else 0
            if latest >= m:
                # train cannot rewind past the milestone: score the step-m
                # checkpoint if one is kept, never a later step's
                if str(m) in curve:
                    print(f"milestone {m}: already recorded (checkpoint at "
                          f"{latest}), skipping", flush=True)
                    continue
                try:
                    ema = restore_ema(ckpt, m)
                except FileNotFoundError:
                    print(f"milestone {m}: checkpoint already at {latest} "
                          f"and no step-{m} checkpoint kept; skipping "
                          f"(not recorded)", flush=True)
                    continue
                print(f"milestone {m}: restored its checkpoint", flush=True)
                after = score(ema, nl, res)
            else:
                if stage_iters:
                    # the whole schedule, stopped at this stage's boundary
                    # (a one-stage prefix would train at full resolution)
                    cfg.train.num_iterations_list = list(stage_iters)
                    cfg.train.stop_after_steps = m
                else:
                    cfg.train.num_iterations_list = [m]
                state = diff_cifar.train(cfg)
                cfg.train.resume = True  # later milestones continue the run
                cur = checkpoint.CheckpointManager(
                    ckpt_dir).latest_step() or 0
                if cur < m:
                    # a stop file ended the stage early: never record a
                    # state before the milestone under its key
                    print(f"training stopped early at step {cur} < {m}; "
                          f"rerun with --resume to continue the curve",
                          flush=True)
                    break
                after = score(state.ema, nl, res)
            after = _scalars(after)
            curve[str(m)] = after.get("FID")
            if after.get("KID") is not None:
                kcurve[str(m)] = after["KID"]
            if stage_iters:
                staged_curve[:] = [r for r in staged_curve
                                   if r.get("step") != m]
                staged_curve.append({"step": int(m), "stage": j,
                                     "n_levels_used": nl,
                                     "resolution": int(res),
                                     "FID": after.get("FID"),
                                     "KID": after.get("KID"),
                                     "IS": after.get("IS")})
            print(f"FID at {m} steps (res {res}):", json.dumps(after),
                  flush=True)
            total_steps = m
            scored_any = True
            write_artifact(after, m)  # each point as it comes
        if not scored_any:
            print("no milestone scored this run; artifact left untouched",
                  flush=True)
            return
    print("FID after training:", json.dumps(_scalars(after)), flush=True)
    out = write_artifact(_scalars(after), total_steps)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
