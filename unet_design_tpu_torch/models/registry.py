"""Model registry: ``MODEL_REGISTRY`` of ``unet_design_tpu/models/registry.py``
(``:38-101``) without ``UNO-*`` and ``Unet2015-*`` (ROADMAP.md, queue A,
item 19): the FNO, Unetbase, modern U-Net, U-FNet, ResNet and DilResNet
names, each with the JAX ``init_args``.

``build_model`` injects the task's arguments where the reference's
``get_model`` does (``pdearena/models/pdemodel.py:26-68``): field counts,
time window and activation, plus overrides such as the Multi-ResNet
options of ``Unetbase-64_G``.  Unlike flax, torch needs the input width at
construction, so ``time_history`` is passed to the model too.  A dotted
name that is not in the registry is built as a user class
(:func:`_build_from_class_path`).
"""

from __future__ import annotations

import importlib
import logging
from typing import Any, Dict

import torch.nn as nn

from unet_design_tpu_torch.models.modern_unet import ModernUnet
from unet_design_tpu_torch.models.resnet import PDEResNet
from unet_design_tpu_torch.models.unetbase import Unetbase, UnetbaseG

log = logging.getLogger(__name__)


def _fourier_resnet(hidden, modes, num_blocks):
    return dict(cls=PDEResNet,
                init_args=dict(hidden_channels=hidden, norm=False,
                               block="fourier", num_blocks=num_blocks,
                               modes1=modes, modes2=modes))


def _funet(hidden=64, modes=16, n_fourier_layers=2, mid_attn=False,
           use1x1=False, mode_scaling=True):
    return dict(cls=ModernUnet,
                init_args=dict(hidden_channels=hidden, norm=True,
                               modes1=modes, modes2=modes,
                               n_fourier_layers=n_fourier_layers,
                               mid_attn=mid_attn, use1x1=use1x1,
                               mode_scaling=mode_scaling))


def _resnet(hidden, norm, block):
    return dict(cls=PDEResNet,
                init_args=dict(hidden_channels=hidden, norm=norm, block=block,
                               num_blocks=(1, 1, 1, 1)))


def _unetmod(**options):
    return dict(cls=ModernUnet,
                init_args=dict(hidden_channels=64, norm=True, **options))


MODEL_REGISTRY: Dict[str, Dict[str, Any]] = {
    # FNO family (ResNet trunk with FourierBasicBlocks)
    "FNO-128-8m": _fourier_resnet(128, 8, (1, 1, 1, 1)),
    "FNO-128-16m": _fourier_resnet(128, 16, (1, 1, 1, 1)),
    "FNOs-128-32m": _fourier_resnet(128, 32, (1, 1)),
    "FNOs-128-16m": _fourier_resnet(128, 16, (1, 1)),
    "FNOs-64-32m": _fourier_resnet(64, 32, (1, 1)),
    "FNOs-96-32m": _fourier_resnet(96, 32, (1, 1)),
    # Unetbase
    "Unetbase-64": dict(cls=Unetbase, init_args=dict(hidden_channels=64)),
    "Unetbase-64_G": dict(cls=UnetbaseG, init_args=dict(hidden_channels=64)),
    "Unetbase-128": dict(cls=Unetbase, init_args=dict(hidden_channels=128)),
    # Modern U-Net
    "Unetmod-64": _unetmod(),
    "Unetmodattn-64": _unetmod(mid_attn=True),
    "Unetmod-64-1x1": _unetmod(use1x1=True),
    "Unetmodattn-64-1x1": _unetmod(mid_attn=True, use1x1=True),
    # U-FNet variants
    "U-FNet1-8m": _funet(modes=8, n_fourier_layers=1),
    "U-FNet1-16m": _funet(modes=16, n_fourier_layers=1),
    "U-FNet1-8m-1x1": _funet(modes=8, n_fourier_layers=1, use1x1=True),
    "U-FNet1-16m-1x1": _funet(modes=16, n_fourier_layers=1, use1x1=True),
    "U-FNet2-8m": _funet(modes=8, n_fourier_layers=2),
    "U-FNet2-8m-1x1": _funet(modes=8, n_fourier_layers=2, use1x1=True),
    "U-FNet2-8mc": _funet(modes=8, n_fourier_layers=2, mode_scaling=False),
    "U-FNet2-16m": _funet(modes=16, n_fourier_layers=2),
    "U-FNet2-16m-1x1": _funet(modes=16, n_fourier_layers=2, use1x1=True),
    "U-FNet3-8m": _funet(modes=8, n_fourier_layers=3),
    "U-FNet3-8m-1x1": _funet(modes=8, n_fourier_layers=3, use1x1=True),
    "U-FNet3-16m": _funet(modes=16, n_fourier_layers=3),
    "U-FNet3-16m-1x1": _funet(modes=16, n_fourier_layers=3, use1x1=True),
    "U-FNet2-16mc": _funet(modes=16, n_fourier_layers=2, mode_scaling=False),
    "U-FNet2attn-16m": _funet(modes=16, n_fourier_layers=2, mid_attn=True),
    "U-FNet2attn-16m-1x1": _funet(modes=16, n_fourier_layers=2, mid_attn=True,
                                  use1x1=True),
    # ResNet family
    "ResNet-128": _resnet(128, True, "basic"),
    "ResNet-256": _resnet(256, True, "basic"),
    "DilResNet-128": _resnet(128, False, "dilated"),
    "DilResNet-128-norm": _resnet(128, True, "dilated"),
}


def _build_from_class_path(name: str, kwargs: Dict[str, Any]) -> nn.Module:
    """The custom-model fallback (``pdemodel.py:56-66``, JAX
    ``registry.py:165-190``): the dotted name is the user class's path; it
    gets the task's arguments and the overrides, with a warning."""
    module_name, _, cls_name = name.rpartition(".")
    try:
        cls = getattr(importlib.import_module(module_name), cls_name)
    except (ImportError, AttributeError) as e:
        raise KeyError(f"Model {name!r} not in registry and not importable "
                       f"as a class path: {e}") from e
    log.warning("Model %r not found in registry. Using class-path fallback. "
                "Best to add your model to the registry.", name)
    return cls(**kwargs)


def build_model(name: str, n_scalar_components: int,
                n_vector_components: int, time_history: int,
                time_future: int, activation: str = "gelu",
                **overrides) -> nn.Module:
    kwargs = dict(n_output_fields=n_scalar_components
                  + 2 * n_vector_components,
                  time_history=time_history, time_future=time_future,
                  activation=activation)
    if name not in MODEL_REGISTRY:
        if "." in name:
            return _build_from_class_path(name, {**kwargs, **overrides})
        raise KeyError(f"Model {name!r} is not in the registry (ported: "
                       f"{sorted(MODEL_REGISTRY)}; UNO-* and Unet2015-* "
                       "wait for ROADMAP.md queue A, item 19); pass a "
                       "dotted 'module.path.Class' name for a user class")
    spec = MODEL_REGISTRY[name]
    return spec["cls"](**{**spec["init_args"], **kwargs, **overrides})
