"""The device an entry point runs on, with TF32 off."""

from __future__ import annotations

import torch

from unet_design_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={name!r} but no CUDA device is "
                               "available (set device=cpu to run on the CPU)")
        # fp32 means fp32, as in the JAX reference: cuDNN would otherwise
        # run fp32 convolutions in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        log.info("TF32 off: fp32 convolutions and matmuls run in full fp32")
    return device
