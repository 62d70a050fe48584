"""WMH leave-one-out protocol on one GPU.

Port of ``unet_design_tpu/tasks/wmh_leave_one_out.py:33-156``, a re-design
of the reference's legacy challenge pipeline (``wmh/train_leave_one_out.py``
/ ``test_leave_one_out.py``): train one segmentation U-Net per held-out
patient on all the other patients' slices, then score the held-out patient
with the challenge metrics (DSC, H95, lesion recall and F1, AVD); several
parameter sets average their predictions (an ensemble, as the challenge
submission averages its two kernel-scale arms).

Patient slice extents follow the challenge layout: 48 slices a patient for
Utrecht and Singapore (patients 0-39), 83 for GE3T (40-59).

The JAX package draws each patient's initial parameters from its PRNG
chain; the port initialises from ``torch.Generator().manual_seed(seed +
patient)`` unless :func:`leave_one_out` is given the initial parameters,
which is how the parity test replays the JAX init.

Run: ``python -m unet_design_tpu_torch.tasks.wmh_leave_one_out
[--patients-48 2] [--patients-83 1] [--epochs 3] [--size 200] [--hidden 16]
[--model seg_unet|legacy|legacy3] [--out ...] [--device cuda|cpu]``, the
flags of ``scripts/wmh_loo_run.py``: synthetic patients at the challenge's
slice counts, every patient held out once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from unet_design_tpu_torch.data import loader as loader_lib
from unet_design_tpu_torch.data import wmh as wmh_data
from unet_design_tpu_torch.evalx import wmh_metrics
from unet_design_tpu_torch.models.unetbase import WMHSegUnet
from unet_design_tpu_torch.models.wmh_legacy import WMHLegacyUnet
from unet_design_tpu_torch.ops import blocks
from unet_design_tpu_torch.process import losses as losses_lib
from unet_design_tpu_torch.tasks.pde import resolve_device
from unet_design_tpu_torch.train import trainer
from unet_design_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

Params = Mapping[str, torch.Tensor]


def patient_slice_ranges(n_site01: int = 40, n_site2: int = 20,
                         slices01: int = 48, slices2: int = 83
                         ) -> List[Tuple[int, int]]:
    ranges = []
    offset = 0
    for p in range(n_site01 + n_site2):
        n = slices01 if p < n_site01 else slices2
        ranges.append((offset, offset + n))
        offset += n
    return ranges


@dataclasses.dataclass
class LOOConfig:
    model: str = "seg_unet"   # seg_unet | legacy (first-kernel 5) | legacy3
    hidden_channels: int = 16
    activation: str = "gelu"
    dwt_encoder: bool = False
    epochs: int = 5
    lr: float = 1e-4
    batch_size: int = 32
    threshold: float = 0.5
    seed: int = 0
    # torch device; "cuda" fails without a GPU (nothing falls back)
    device: str = "cuda"


def build_loo_model(cfg: LOOConfig) -> nn.Module:
    """``seg_unet``: the Multi-ResNet-capable net of the staged trainer;
    ``legacy`` / ``legacy3``: the challenge-winning Keras net's two
    kernel-scale ensemble arms (``wmh/train_leave_one_out.py:56-113``)."""
    if cfg.model == "seg_unet":
        return WMHSegUnet(hidden_channels=cfg.hidden_channels,
                          activation=cfg.activation,
                          dwt_encoder=cfg.dwt_encoder)
    if cfg.model in ("legacy", "legacy3"):
        return WMHLegacyUnet(first5=cfg.model == "legacy")
    raise ValueError(f"unknown LOO model {cfg.model!r}")


def train_one(cfg: LOOConfig, images: np.ndarray, masks: np.ndarray,
              params: Optional[Params] = None, init_seed: int = 0):
    """Train one model on ``images`` / ``masks`` (NHWC numpy) for
    ``cfg.epochs`` epochs of Adam on the Dice loss, one shuffle stream
    ``default_rng(cfg.seed)`` across epochs; return ``(params, predict)``
    with ``predict(params, x) -> probabilities``.  ``params`` replaces the
    fresh init (flax's defaults, drawn from ``init_seed``)."""
    device = resolve_device(cfg.device)
    model = build_loo_model(cfg)
    blocks.flax_default_init_(model, torch.Generator().manual_seed(init_seed))
    if params is not None:
        model.load_state_dict(params, strict=True)
    model.to(device)
    opt = trainer.make_optimizer(model.parameters(), cfg.lr)
    shuffle = np.random.default_rng(cfg.seed)
    for _ in range(cfg.epochs):
        for bx, by in loader_lib.epoch_batches([images, masks],
                                               cfg.batch_size, shuffle,
                                               drop_last=False):
            x = torch.from_numpy(bx).to(device)
            y = torch.from_numpy(by).to(device)
            loss = losses_lib.dice_coef_loss(model(x), y)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()

    @torch.no_grad()
    def predict(p: Params, x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(model, p, (x,))

    return {k: v.detach().clone() for k, v in model.state_dict().items()}, \
        predict


def evaluate_patient(predict, params_list: Sequence[Params],
                     images: np.ndarray, masks: np.ndarray,
                     threshold: float = 0.5,
                     spacing: Optional[Sequence[float]] = None
                     ) -> Dict[str, float]:
    """Challenge metrics on one patient; more than one parameter set is an
    ensemble (the mean of their probabilities).

    ``spacing`` is the patient's voxel spacing (slice, row, col) in mm, so
    that H95 is in millimetres as in the reference
    (``wmh/evaluation.py:121-137``)."""
    device = next(iter(params_list[0].values())).device
    x = torch.from_numpy(images).to(device)
    preds = np.mean([predict(p, x).cpu().numpy() for p in params_list],
                    axis=0)
    binary = preds[..., 0] >= threshold
    mask = masks[..., 0] >= 0.5
    recall, _, f1 = wmh_metrics.lesion_detection(mask, binary)
    return {
        "dsc": wmh_metrics.dsc(mask, binary),
        "h95": wmh_metrics.hausdorff95(mask, binary, spacing=spacing),
        "avd": wmh_metrics.avd(mask, binary),
        "lesion_recall": recall,
        "lesion_f1": f1,
    }


def default_patient_spacings(n_site01: int = 40, n_site2: int = 20
                             ) -> List[Tuple[float, ...]]:
    """Challenge-nominal spacing per patient: Utrecht (0-19), Singapore
    (20-39), GE3T (40-59) in the standard 60-patient layout."""
    half = n_site01 // 2
    s = wmh_data.CHALLENGE_SPACINGS
    return ([s["utrecht"]] * half + [s["singapore"]] * (n_site01 - half)
            + [s["ge3t"]] * n_site2)


def leave_one_out(cfg: LOOConfig, images: np.ndarray, masks: np.ndarray,
                  slice_ranges: Optional[List[Tuple[int, int]]] = None,
                  patients: Optional[Sequence[int]] = None,
                  spacings: Optional[Sequence[Sequence[float]]] = None,
                  init_params: Optional[Mapping[int, Params]] = None
                  ) -> Dict[int, Dict[str, float]]:
    """Run the protocol; return per-patient challenge metrics.

    ``spacings[p]`` is patient p's voxel spacing (from
    ``read_nifti_with_spacing`` for real data); H95 is in voxels without
    it.  ``init_params[p]``, where given, is the initial ``state_dict`` of
    the model that holds patient p out."""
    ranges = slice_ranges or patient_slice_ranges()
    patients = patients if patients is not None else range(len(ranges))
    results = {}
    for p in patients:
        s, e = ranges[p]
        keep = np.r_[0:s, e:images.shape[0]]
        params, predict = train_one(
            cfg, images[keep], masks[keep],
            params=init_params.get(p) if init_params else None,
            init_seed=cfg.seed + p)
        results[p] = evaluate_patient(
            predict, [params], images[s:e], masks[s:e], cfg.threshold,
            spacing=spacings[p] if spacings is not None else None)
        log.info("patient %d: %s", p, results[p])
    return results


def synthetic_patients(n_48: int, n_83: int, size: int = 200):
    """``(images, masks, ranges, spacings)`` of ``n_48`` Utrecht-like
    patients of 48 slices and ``n_83`` GE3T-like patients of 83, each from
    ``synthetic_wmh(seed=100 + patient)``, images z-normed together."""
    ranges, spacings, imgs, masks = [], [], [], []
    offset = 0
    for pt in range(n_48 + n_83):
        n_slices = 48 if pt < n_48 else 83
        site = "utrecht" if pt < n_48 else "ge3t"
        im, mk = wmh_data.synthetic_wmh(n_slices, size=size, seed=100 + pt)
        imgs.append(im)
        masks.append(mk)
        ranges.append((offset, offset + n_slices))
        spacings.append(wmh_data.CHALLENGE_SPACINGS[site])
        offset += n_slices
    images = wmh_data.normalize_by_train_stats(np.concatenate(imgs))
    return images, np.concatenate(masks), ranges, spacings


def main(argv=None):
    import argparse
    import json
    import os
    p = argparse.ArgumentParser()
    p.add_argument("--patients-48", type=int, default=2)
    p.add_argument("--patients-83", type=int, default=1)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--size", type=int, default=200)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--model", default="seg_unet",
                   choices=["seg_unet", "legacy", "legacy3"],
                   help="legacy/legacy3 = the challenge-winning Keras "
                        "net's kernel-5/kernel-3 ensemble arms")
    p.add_argument("--out", default="runs/wmh_loo/loo_results.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    images, masks, ranges, spacings = synthetic_patients(
        args.patients_48, args.patients_83, args.size)
    n_patients = len(ranges)
    print(f"{n_patients} synthetic patients, {images.shape[0]} slices "
          f"at {args.size}x{args.size}", flush=True)
    cfg = LOOConfig(model=args.model, hidden_channels=args.hidden,
                    epochs=args.epochs, device=args.device)
    results = leave_one_out(cfg, images, masks, slice_ranges=ranges,
                            spacings=spacings)

    artifact = {
        "protocol": {"patients_48": args.patients_48,
                     "patients_83": args.patients_83,
                     "model": args.model,
                     "size": args.size, "epochs": args.epochs,
                     "spacing_mm": {i: list(s)
                                    for i, s in enumerate(spacings)}},
        "per_patient": {str(k): {m: (None if v != v else round(float(v), 4))
                                 for m, v in r.items()}
                        for k, r in results.items()},
    }
    finite = lambda key: [r[key] for r in results.values()
                          if r[key] == r[key]]
    artifact["mean"] = {key: round(float(np.mean(finite(key))), 4)
                        for key in ("dsc", "h95", "avd", "lesion_recall",
                                    "lesion_f1") if finite(key)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact["mean"], indent=1))
    print("wrote", args.out)
    return artifact


if __name__ == "__main__":
    main()
