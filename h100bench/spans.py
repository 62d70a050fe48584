"""The harness's spans around calls into the program's layers, opened only
in a traced stretch.

A configuration's file names them under ``spans``: ``{"layer":
"package.module:function"}`` wraps that function of the program in a
span, and ``{"layer": "package.module:Class"}`` where ``Class`` is a
``torch.nn.Module`` opens a span over each forward of its instances.  The
span's name is ``h100bench::<layer>`` (``devtrace.SPAN``); the device time
of what ran inside it, and of the backward of what ran inside it, is the
layer's.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Dict

import torch

from h100bench import devtrace


def _resolve(path: str):
    mod, _, attr = path.partition(":")
    return importlib.import_module(mod), attr


@contextlib.contextmanager
def layer_spans(spec: Dict[str, str]):
    restore = []
    module_layers = []
    for layer, path in spec.items():
        mod, attr = _resolve(path)
        obj = getattr(mod, attr)
        if isinstance(obj, type) and issubclass(obj, torch.nn.Module):
            module_layers.append((obj, layer))
            continue

        def wrapped(*a, _fn=obj, _layer=layer, **k):
            with devtrace.span(_layer):
                return _fn(*a, **k)
        setattr(mod, attr, wrapped)
        restore.append((mod, attr, obj))
    open_spans = []

    def pre(m, args):
        for cls, layer in module_layers:
            if isinstance(m, cls):
                rf = devtrace.span(layer)
                rf.__enter__()
                open_spans.append((m, rf))

    def post(m, args, out):
        if open_spans and open_spans[-1][0] is m:
            open_spans.pop()[1].__exit__(None, None, None)

    handles = []
    if module_layers:
        handles = [torch.nn.modules.module.register_module_forward_pre_hook(
            pre), torch.nn.modules.module.register_module_forward_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()
        for mod, attr, obj in restore:
            setattr(mod, attr, obj)
