"""Nested dataclass configs from YAML files and dotted CLI overrides.

Port of ``unet_design_tpu/utils/config.py`` (``from_dict``, ``from_yaml``,
``save_yaml``, ``resolve_run_dir``, ``restore_run_config``,
``apply_overrides``, ``parse_cli``): the same files and the same
``section.key=value`` overrides parse the same way.  A run's saved
``config.yaml`` is written as JSON, which is YAML too, so neither writing
nor reading it back needs the ``yaml`` package; ``yaml`` is imported only
to read a file that is not JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Type, TypeVar

T = TypeVar("T")


def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Recursively build a dataclass from a (possibly partial) dict."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, val in (data or {}).items():
        if key not in fields:
            raise KeyError(f"Unknown config key {key!r} for {cls.__name__}")
        sub = _resolve_dataclass(fields[key])
        if sub is not None and isinstance(val, dict):
            kwargs[key] = from_dict(sub, val)
        else:
            kwargs[key] = val
    return cls(**kwargs)


def _resolve_dataclass(field) -> Optional[type]:
    t = field.type
    if isinstance(t, type) and dataclasses.is_dataclass(t):
        return t
    if field.default_factory is not dataclasses.MISSING:
        maybe = field.default_factory()
        if dataclasses.is_dataclass(maybe):
            return type(maybe)
    return None


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def from_yaml(cls: Type[T], path: str) -> T:
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except ValueError:
        import yaml
        data = yaml.safe_load(text)
    return from_dict(cls, data or {})


def save_yaml(cfg: Any, path: str) -> None:
    """Save a config beside a run's artifacts (the reference's
    ``torch.save(H, 'H.dict')``), so the run can be restored by id."""
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=1)


def resolve_run_dir(run_id: str) -> str:
    """A run id is a run directory, or a name under ``runs/``."""
    if not run_id:
        raise ValueError("empty run id")
    if os.path.isdir(run_id):
        return run_id
    cand = os.path.join("runs", run_id)
    if os.path.isdir(cand):
        return cand
    raise FileNotFoundError(f"run id {run_id!r}: no such run directory")


def restore_run_config(cfg: T) -> T:
    """``train_id`` / ``test_id`` restore (``diff_cifar/main.py:115-136``):
    the stored run's ``config.yaml`` replaces the given config wholesale,
    except the restore fields themselves and the fields that belong to the
    new run (its logdir, stop point and device; ``resume`` off)."""
    t = cfg.train
    run_id = getattr(t, "train_id", "") or getattr(t, "test_id", "")
    if not run_id:
        return cfg
    restored = from_yaml(type(cfg), os.path.join(resolve_run_dir(run_id),
                                                 "config.yaml"))
    rt = restored.train
    rt.train_id, rt.test_id = t.train_id, t.test_id
    rt.restore_iter = t.restore_iter
    rt.resume = False
    rt.logdir = t.logdir
    if hasattr(t, "stop_after_steps"):
        rt.stop_after_steps = t.stop_after_steps
    if hasattr(cfg, "device"):
        restored.device = cfg.device
    return restored


def _parse_value(s: str) -> Any:
    try:
        return json.loads(s)
    except ValueError:
        return s


def apply_overrides(cfg: T, overrides: Sequence[str]) -> T:
    """Apply ``section.key=value`` overrides (value parsed as JSON)."""
    data = to_dict(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        path, value = ov.split("=", 1)
        node = data
        keys = path.split(".")
        for k in keys[:-1]:
            node = node[k]
        if keys[-1] not in node:
            raise KeyError(f"Unknown config key {path!r}")
        node[keys[-1]] = _parse_value(value)
    return from_dict(type(cfg), data)


def parse_cli(cls: Type[T], argv: Sequence[str]) -> T:
    """``[--config file.yaml] [key=value ...]`` -> config instance."""
    cfg: Optional[T] = None
    overrides: List[str] = []
    it = iter(argv)
    for arg in it:
        if arg == "--config":
            cfg = from_yaml(cls, next(it))
        elif arg.startswith("--config="):
            cfg = from_yaml(cls, arg.split("=", 1)[1])
        else:
            overrides.append(arg.lstrip("-"))
    if cfg is None:
        cfg = cls()
    return apply_overrides(cfg, overrides)
