"""A tyro-style CLI over (nested, frozen) dataclasses.

The port's copy of ``perseus_tpu/configs/cli.py``, the same flags for the
same configs: every (possibly nested) field becomes a
``--dotted.kebab-case`` flag (``--dataset-config.dataset-path foo``);
bools accept ``--flag`` / ``--no-flag`` or a value; tuples parse comma- or
space-separated values; ``--a=b`` works; an unknown flag exits with the
generated help, which ``--help`` prints with each flag's default.
"""

from __future__ import annotations

import dataclasses
import sys
import typing
from typing import Any, Sequence, TypeVar

__all__ = ["cli", "parse_config"]

T = TypeVar("T")


def _is_dataclass_type(t: Any) -> bool:
    return dataclasses.is_dataclass(t) and isinstance(t, type)


def _flag_name(path: tuple[str, ...]) -> str:
    return "--" + ".".join(p.replace("_", "-") for p in path)


def _field_types(cls: type) -> dict[str, Any]:
    """Resolved annotations: config modules use `from __future__ import
    annotations`, so `field.type` may be the *string* "int" — always go
    through get_type_hints."""
    try:
        return typing.get_type_hints(cls)
    except Exception:
        return {f.name: f.type for f in dataclasses.fields(cls)}


def _iter_fields(cls: type, path: tuple[str, ...] = ()):
    """Yields (path, field, resolved_type) for every leaf field."""
    hints = _field_types(cls)
    for f in dataclasses.fields(cls):
        sub = path + (f.name,)
        ftype = hints.get(f.name, f.type)
        if _is_dataclass_type(ftype):
            yield from _iter_fields(ftype, sub)
        else:
            yield sub, f, ftype


def _parse_value(raw: str, annotation: Any) -> Any:
    origin = typing.get_origin(annotation)
    if annotation is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if annotation is int:
        return int(raw)
    if annotation is float:
        return float(raw)
    if annotation is str:
        return raw
    if origin in (tuple, list):
        args = typing.get_args(annotation)
        elem = args[0] if args else str
        parts = [p for chunk in raw.split(",") for p in chunk.split() if p]
        vals = [_parse_value(p, elem) for p in parts]
        return tuple(vals) if origin is tuple else vals
    import types

    if origin is typing.Union or origin is types.UnionType:  # Optional[...] / X | None
        args = [a for a in typing.get_args(annotation) if a is not type(None)]
        if raw.lower() in ("none", "null"):
            return None
        return _parse_value(raw, args[0])
    return raw


def _help_text(cls: type) -> str:
    lines = [f"Usage: {sys.argv[0]} [flags]", "", f"Config: {cls.__name__}", ""]
    for path, f, ftype in _iter_fields(cls):
        default = f.default if f.default is not dataclasses.MISSING else (
            f.default_factory() if f.default_factory is not dataclasses.MISSING else "<required>"
        )
        type_name = getattr(ftype, "__name__", str(ftype))
        lines.append(f"  {_flag_name(path)} ({type_name}, default: {default})")
    return "\n".join(lines)


def parse_config(cls: type[T], argv: Sequence[str]) -> T:
    """Builds an instance of (frozen, nested) dataclass `cls` from argv."""
    field_map = {_flag_name(path): (path, ftype) for path, f, ftype in _iter_fields(cls)}
    overrides: dict[tuple[str, ...], Any] = {}

    i = 0
    argv = list(argv)
    while i < len(argv):
        arg = argv[i]
        if arg in ("-h", "--help"):
            print(_help_text(cls))
            sys.exit(0)
        if not arg.startswith("--"):
            raise SystemExit(f"Unexpected argument: {arg}")
        if "=" in arg:
            name, raw = arg.split("=", 1)
            i += 1
        else:
            name = arg
            # bool flags may omit the value: --flag / --no-flag
            stripped = name[2:]
            neg = stripped.startswith("no-") and ("--" + stripped[3:]) in field_map
            probe = "--" + (stripped[3:] if neg else stripped)
            if probe in field_map and field_map[probe][1] is bool and (
                i + 1 >= len(argv) or argv[i + 1].startswith("--")
            ):
                overrides[field_map[probe][0]] = not neg
                i += 1
                continue
            if i + 1 >= len(argv):
                raise SystemExit(f"Missing value for {name}")
            raw = argv[i + 1]
            i += 2
        if name not in field_map:
            raise SystemExit(f"Unknown flag: {name}\n\n{_help_text(cls)}")
        path, ftype = field_map[name]
        overrides[path] = _parse_value(raw, ftype)

    def build(cls_: type, path: tuple[str, ...] = ()):
        kwargs = {}
        hints = _field_types(cls_)
        for f in dataclasses.fields(cls_):
            sub = path + (f.name,)
            ftype = hints.get(f.name, f.type)
            if _is_dataclass_type(ftype):
                # rebuild nested config only if any override touches it
                if any(k[: len(sub)] == sub for k in overrides):
                    kwargs[f.name] = build(ftype, sub)
            elif sub in overrides:
                kwargs[f.name] = overrides[sub]
        return cls_(**kwargs)

    return build(cls)


def cli(cls: type[T], args: Sequence[str] | None = None) -> T:
    """tyro.cli-compatible entry: parse sys.argv[1:] into `cls`."""
    return parse_config(cls, sys.argv[1:] if args is None else args)
