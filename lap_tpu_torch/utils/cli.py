"""Dataclass-tree CLI: named configs + ``--path.to.field value`` overrides
(copy of ``lap_tpu/utils/cli.py``, which imports no JAX).

The first positional argument picks a named config, and every
``--a.b.c value`` flag overrides a (possibly nested) dataclass field, parsed
according to the field's annotated type: bools, ints, floats, strings, enums
(by name or value), tuples and lists (JSON or comma-separated), dicts (JSON)
and ``None`` for optional fields. Nothing is left out. One addition: a field
typed as a union of dataclasses (``optimizer: AdamW | SGDConfig``) takes
the name of one of them (``--optimizer SGDConfig``), which sets that class
with its defaults; ``--optimizer.momentum 0.5`` then sets its fields.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import sys
import types
import typing


def _parse_value(raw: str, typ):
    origin = typing.get_origin(typ)
    args = typing.get_args(typ)
    # Optional[T] / unions: try each member type.
    if origin in (typing.Union, types.UnionType):
        if raw.lower() in ("none", "null"):
            if type(None) in args:
                return None
        for sub in args:
            if dataclasses.is_dataclass(sub) and raw.lower() == sub.__name__.lower():
                return sub()
        for sub in args:
            if sub is type(None):
                continue
            try:
                return _parse_value(raw, sub)
            except (ValueError, TypeError):
                continue
        raise ValueError(f"cannot parse {raw!r} as {typ}")
    if typ is bool or typ == "bool":
        if raw.lower() in ("1", "true", "yes", "on"):
            return True
        if raw.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"not a bool: {raw}")
    if typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    if typ is str:
        return raw
    if isinstance(typ, type) and issubclass(typ, enum.Enum):
        try:
            return typ[raw]
        except KeyError:
            return typ(raw)
    if origin in (list, tuple):
        items = json.loads(raw) if raw.startswith("[") else raw.split(",")
        elem = args[0] if args else str
        parsed = [_parse_value(str(i).strip(), elem) for i in items]
        return tuple(parsed) if origin is tuple else parsed
    if origin is dict or typ is dict:
        return json.loads(raw)
    # Fallback: attempt JSON then raw string.
    try:
        return json.loads(raw)
    except (ValueError, TypeError):
        return raw


def _field_type(obj, name: str):
    for f in dataclasses.fields(obj):
        if f.name == name:
            hints = typing.get_type_hints(type(obj))
            return hints.get(name, f.type)
    raise AttributeError(f"{type(obj).__name__} has no field {name!r}")


def _replace_path(config, path: list[str], raw: str):
    """Immutable nested replace: returns config with path set to parsed value."""
    head = path[0]
    if len(path) == 1:
        value = _parse_value(raw, _field_type(config, head))
        return dataclasses.replace(config, **{head: value})
    child = getattr(config, head)
    if not dataclasses.is_dataclass(child):
        raise ValueError(f"cannot descend into non-dataclass field {head!r}")
    return dataclasses.replace(config, **{head: _replace_path(child, path[1:], raw)})


def apply_overrides(config, argv: list[str]):
    """Apply ``--a.b.c value`` (or ``--a.b.c=value``) overrides."""
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"unexpected argument: {arg}")
        key = arg[2:]
        if "=" in key:
            key, raw = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"missing value for {arg}")
            raw = argv[i + 1]
            i += 2
        config = _replace_path(config, key.replace("-", "_").split("."), raw)
    return config


def overridable_config_cli(configs: dict, argv: list[str] | None = None):
    """``prog <config-name> [--field value ...]`` -> resolved config."""
    if argv is None:
        argv = sys.argv[1:]
    if not argv or argv[0].startswith("--"):
        names = ", ".join(sorted(configs))
        raise SystemExit(f"usage: <config-name> [--field value ...]\nconfigs: {names}")
    name, rest = argv[0], argv[1:]
    if name not in configs:
        import difflib

        close = difflib.get_close_matches(name, configs.keys(), n=3, cutoff=0.0)
        raise SystemExit(f"unknown config {name!r}; did you mean {close}?")
    return apply_overrides(configs[name], rest)
