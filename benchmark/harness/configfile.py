"""A configuration file of ``benchmark/configs`` as a ``Config`` of the port
or of the reference.

The file's ``config`` object holds every field of the configuration as it
is run, nested groups whole (``dataclasses.asdict`` of the port's
``Config`` with its sub-configurations resolved). It is rebuilt field by
field from the dataclasses' type hints, so that a later change of the
program's defaults does not change the configuration the benchmark runs.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import typing
from pathlib import Path
from typing import Any, Dict


def load(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _convert(hint, value):
    if value is None:
        return None
    if dataclasses.is_dataclass(hint):
        return build(hint, value)
    origin, args = typing.get_origin(hint), typing.get_args(hint)
    if origin is typing.Union:              # Optional[X]
        inner = [a for a in args if a is not type(None)]
        return _convert(inner[0], value)
    if origin is tuple:
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_convert(args[0], v) for v in value)
        return tuple(_convert(a, v) for a, v in zip(args, value))
    return value


def build(cls, data: Dict[str, Any]):
    """``cls(**data)`` with nested dataclasses and tuples rebuilt; a key the
    dataclass lacks raises."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f'{cls.__name__}: unknown fields {sorted(unknown)}')
    hints = typing.get_type_hints(cls, vars(sys.modules[cls.__module__]))
    return cls(**{k: _convert(hints[k], v) for k, v in data.items()})


def to_dict(cfg) -> Dict[str, Any]:
    """Every field of a ``Config``, its sub-configurations resolved."""
    resolved = cfg.replace(backbone_conf=cfg.get_backbone_conf(), head_conf=cfg.get_head_conf(),
                           lidar_conf=cfg.get_lidar_conf())
    return json.loads(json.dumps(dataclasses.asdict(resolved)))
