"""Minimal tyro-equivalent CLI for nested dataclass configs.

Counterpart of vhap_tpu/config/cli.py. Maps ``--a.b.c value`` flags onto
nested dataclass fields, with ``--a.b.flag`` / ``--a.b.no-flag`` for
booleans, comma/space-separated tuples, 'None' literals for Optionals, and
``--help`` generation. Keeps the flag surface of the reference's tyro CLIs
(e.g. ``--model.no-use-static-offset``, ``--w.reg_tex_tv 1e4``).

`to_yaml` writes JSON: JSON is valid YAML, so any YAML reader loads the
run's config.yml, and the port needs no YAML library.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import typing
from pathlib import Path
from typing import Any, Optional, get_args, get_origin


def _is_dataclass_type(t) -> bool:
    return dataclasses.is_dataclass(t) and isinstance(t, type)


def _coerce(value: str, typ) -> Any:
    origin = get_origin(typ)
    if origin is typing.Union:
        args = [a for a in get_args(typ) if a is not type(None)]
        if value.lower() in ("none", "null"):
            return None
        return _coerce(value, args[0])
    if origin is tuple or typ is tuple:
        args = get_args(typ)
        elem = args[0] if args else str
        if value.strip() == "":
            return ()
        items = [v for v in value.replace(",", " ").split() if v]
        return tuple(_coerce(v, elem) for v in items)
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if typ is Path:
        return Path(value)
    if get_origin(typ) is typing.Literal:
        lits = get_args(typ)
        for lit in lits:
            if str(lit) == value:
                return lit
        raise ValueError(f"{value!r} not in {lits}")
    return value


def _field_map(cls, prefix=""):
    """flat dot-path -> (owner path, field) map."""
    out = {}
    for f in dataclasses.fields(cls):
        path = f"{prefix}{f.name}"
        typ = f.type
        if isinstance(typ, str):
            hints = typing.get_type_hints(cls)
            typ = hints.get(f.name, str)
        if _is_dataclass_type(typ):
            out.update(_field_map(typ, prefix=f"{path}."))
        else:
            out[path] = typ
    return out


def _set_path(obj, path: str, value):
    parts = path.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    setattr(obj, parts[-1], value)


def _get_type(cls, path: str):
    parts = path.split(".")
    cur = cls
    for p in parts[:-1]:
        hints = typing.get_type_hints(cur)
        cur = hints[p]
    hints = typing.get_type_hints(cur)
    return hints[parts[-1]]


def parse_cli(config_cls, argv: Optional[list] = None):
    """Build config_cls() then apply CLI overrides. Returns the instance."""
    argv = list(sys.argv[1:] if argv is None else argv)
    fmap = _field_map(config_cls)

    if "--help" in argv or "-h" in argv:
        print(f"usage: {config_cls.__name__} [--<path> <value>] ...")
        for path, typ in sorted(fmap.items()):
            print(f"  --{path:45s} {getattr(typ, '__name__', typ)}")
        sys.exit(0)

    overrides = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise SystemExit(f"unexpected argument: {tok}")
        key = tok[2:].replace("-", "_")
        # boolean --x / --no-x forms (tyro style also allows --a.no-b)
        neg = False
        parts = key.split(".")
        if parts[-1].startswith("no_"):
            probe = ".".join(parts[:-1] + [parts[-1][3:]])
            if probe in fmap and fmap[probe] is bool:
                key, neg = probe, True
        if key not in fmap:
            # try dashes inside segment names
            raise SystemExit(f"unknown flag: {tok}")
        typ = fmap[key]
        if typ is bool:
            if neg:
                overrides[key] = False
                i += 1
            elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                overrides[key] = _coerce(argv[i + 1], bool)
                i += 2
            else:
                overrides[key] = True
                i += 1
        else:
            origin = get_origin(typ)
            is_tuple = origin is tuple or (
                origin is typing.Union and any(get_origin(a) is tuple for a in get_args(typ)))
            vals = []
            i += 1
            while i < len(argv) and not argv[i].startswith("--"):
                vals.append(argv[i])
                i += 1
                if not is_tuple:
                    break
            if not vals and not is_tuple:
                raise SystemExit(f"flag {tok} expects a value")
            overrides[key] = _coerce(" ".join(vals), typ)

    cfg = config_cls()
    # __post_init__ already ran once in the constructor and mutated the
    # stage except-lists; restore pristine tables, apply overrides, re-run.
    _reset_stage_tables(cfg)
    for key, value in overrides.items():
        _set_path(cfg, key, value)
    if hasattr(cfg, "__post_init__"):
        cfg.__post_init__()
    return cfg


def _reset_stage_tables(cfg):
    """Re-instantiate the pipeline stage configs so __post_init__ occlusion
    merging does not double-append when run a second time."""
    if hasattr(cfg, "pipeline"):
        pcls = type(cfg.pipeline)
        fresh = pcls()
        for f in dataclasses.fields(pcls):
            cur = getattr(cfg.pipeline, f.name)
            new = getattr(fresh, f.name)
            # keep user overrides on scalar fields, reset the except-lists
            for sf in dataclasses.fields(type(new)):
                if sf.name in ("align_texture_except", "align_boundary_except"):
                    continue
                setattr(new, sf.name, getattr(cur, sf.name))
            setattr(cfg.pipeline, f.name, new)


def to_plain(cfg):
    """The config as a tree of dicts, lists, strings and numbers."""
    def conv(o):
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return {f.name: conv(getattr(o, f.name)) for f in dataclasses.fields(o)}
        if isinstance(o, Path):
            return str(o)
        if isinstance(o, tuple):
            return list(o)
        return o
    return conv(cfg)


def to_yaml(cfg) -> str:
    """The config as YAML text (JSON, a subset of YAML), fields in order."""
    return json.dumps(to_plain(cfg), indent=2)


def save_yaml(cfg, path: Path):
    Path(path).write_text(to_yaml(cfg), "utf8")
