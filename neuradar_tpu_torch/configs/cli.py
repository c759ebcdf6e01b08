"""A small command line over dataclass trees: ``train <method> --a.b.c value`` (the port's copy of
the JAX package's configs/cli.py, with its coercion rules).

A value is coerced by the field's annotation: bool ("1", "true", "yes", "on" are true), int, float,
str, tuples ("16,8" or "16 8"), and Optional[X] / unions, where "none" or "null" gives None.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple, get_args, get_origin, get_type_hints


def _coerce(value: str, ann: Any) -> Any:
    origin = get_origin(ann)
    if ann is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if ann is int:
        return int(value)
    if ann is float:
        return float(value)
    if ann is str:
        return value
    if ann is tuple or origin is tuple or origin is Tuple:
        args = get_args(ann)
        elem = args[0] if args else None
        parts = [p for p in value.replace(",", " ").split() if p]
        return tuple(_coerce(p, elem if elem is not None else _guess_type(p)) for p in parts)
    if origin is Optional or (origin is type(None)):
        return value
    # Optional[X] / Union: test the None sentinel before the members, since bool coercion never
    # raises and would turn "--x none" into False
    args = get_args(ann)
    if args:
        if type(None) in args and value.lower() in ("none", "null"):
            return None
        for a in args:
            if a is type(None):
                continue
            try:
                return _coerce(value, a)
            except (TypeError, ValueError):
                continue
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    return value


def _guess_type(value: str) -> type:
    try:
        int(value)
        return int
    except ValueError:
        pass
    try:
        float(value)
        return float
    except ValueError:
        return str


def set_by_path(config: Any, path: str, value: str) -> None:
    """Set config.a.b.c = coerce(value) following the dataclass annotations."""
    parts = path.split(".")
    obj = config
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise AttributeError(f"config has no field '{p}' (in --{path})")
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise AttributeError(f"config has no field '{leaf}' (in --{path})")
    ann = None
    if dataclasses.is_dataclass(obj):
        try:
            ann = get_type_hints(type(obj)).get(leaf)
        except (NameError, TypeError):
            ann = None
    current = getattr(obj, leaf)
    if ann is None and current is not None:
        ann = type(current)
    setattr(obj, leaf, _coerce(value, ann) if ann is not None else value)


def parse_overrides(config: Any, argv: List[str]) -> Any:
    """Apply --a.b.c value (or --a.b.c=value) pairs to the config tree; dashes in names read as
    underscores."""
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"unexpected positional argument: {arg}")
        key = arg[2:]
        if "=" in key:
            key, value = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"missing value for --{key}")
            value = argv[i + 1]
            i += 2
        set_by_path(config, key.replace("-", "_"), value)
    return config


def apply_config_dict(config: Any, d: dict) -> Any:
    """Apply a saved config.json dict onto a dataclass tree, recursively (scalar and tuple fields
    only)."""
    for k, v in d.items():
        if not hasattr(config, k):
            continue
        cur = getattr(config, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            apply_config_dict(cur, v)
        elif isinstance(v, list) and isinstance(cur, tuple):
            setattr(config, k, tuple(v))
        elif isinstance(v, (int, float, str, bool)) or v is None:
            if isinstance(cur, bool) and not isinstance(v, bool):
                continue
            if cur is None or isinstance(v, type(cur)) or isinstance(cur, (int, float)) and isinstance(v, (int, float)):
                setattr(config, k, v)
    return config


def describe(config: Any, prefix: str = "", depth: int = 0, max_depth: int = 3) -> List[str]:
    """One '--path (default: value)' line per field, down to ``max_depth`` levels."""
    lines = []
    if not dataclasses.is_dataclass(config) or depth > max_depth:
        return lines
    for f in dataclasses.fields(config):
        val = getattr(config, f.name)
        path = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(val):
            lines.append(f"  --{path}.*")
            lines += describe(val, path + ".", depth + 1, max_depth)
        else:
            shown = val if not isinstance(val, (list, dict)) else type(val).__name__
            lines.append(f"  --{path} (default: {shown})")
    return lines
