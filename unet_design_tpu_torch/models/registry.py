"""Model registry: the main-path subset of
``unet_design_tpu/models/registry.py`` (``Unetbase-64``, ``Unetbase-64_G``,
``Unetbase-128``).

``build_model`` injects the task's arguments where the reference's
``get_model`` does (``pdearena/models/pdemodel.py:26-68``): field counts,
time window and activation, plus overrides such as the Multi-ResNet
options of ``Unetbase-64_G``.  Unlike flax, torch needs the input width at
construction, so ``time_history`` is passed to the model too.
"""

from __future__ import annotations

from typing import Any, Dict

import torch.nn as nn

from unet_design_tpu_torch.models.unetbase import Unetbase, UnetbaseG

MODEL_REGISTRY: Dict[str, Dict[str, Any]] = {
    "Unetbase-64": dict(cls=Unetbase, init_args=dict(hidden_channels=64)),
    "Unetbase-64_G": dict(cls=UnetbaseG, init_args=dict(hidden_channels=64)),
    "Unetbase-128": dict(cls=Unetbase, init_args=dict(hidden_channels=128)),
}


def build_model(name: str, n_scalar_components: int,
                n_vector_components: int, time_history: int,
                time_future: int, activation: str = "gelu",
                **overrides) -> nn.Module:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"Model {name!r} is not ported yet (ported: "
                       f"{sorted(MODEL_REGISTRY)}); see ROADMAP.md")
    spec = MODEL_REGISTRY[name]
    kwargs = dict(spec["init_args"])
    kwargs.update(n_output_fields=n_scalar_components
                  + 2 * n_vector_components,
                  time_history=time_history, time_future=time_future,
                  activation=activation)
    kwargs.update(overrides)
    return spec["cls"](**kwargs)
