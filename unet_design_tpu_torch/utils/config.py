"""Nested dataclass configs from YAML files and dotted CLI overrides.

Port of ``unet_design_tpu/utils/config.py`` (``from_dict``, ``from_yaml``,
``apply_overrides``, ``parse_cli``): the same files and the same
``section.key=value`` overrides parse the same way.  ``yaml`` is imported
only where a file is read.
"""

from __future__ import annotations

import dataclasses
import json
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
    import yaml
    with open(path) as f:
        return from_dict(cls, yaml.safe_load(f) or {})


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
