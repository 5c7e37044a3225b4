"""Hierarchical configuration and YAML loading (counterpart of
tgt_tpu/core/config.py).

- ``Config`` is a flat dot-keyed mapping with attribute access.
- ``Lazy(fn)`` values are computed from the whole config when read.
- ``override(updates)`` is strict: unknown keys raise, and a dotted key
  matches any config key that ends with it.
- ``resolve()`` returns a SimpleNamespace snapshot, ``to_dict()`` a plain
  dict.

YAML io: ``load_yaml`` reads a file or a string, ``save_yaml`` writes
multi-line strings as block scalars, and ``parse_cli_overrides`` reads the
CLI's inline ``'key: value'`` snippets (reference
lib/training/execute.py:33-52).
"""
from __future__ import annotations

import io
from types import SimpleNamespace
from typing import Any, Callable, Dict, Iterable, Mapping

import yaml


class Lazy:
    """A config value computed from the resolved config."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[["Config"], Any]):
        self.fn = fn


class ConfigError(KeyError):
    pass


class Config:
    """Flat dot-keyed config with attribute access and lazy resolution."""

    def __init__(self, **kwargs: Any):
        object.__setattr__(self, "_store", dict(kwargs))

    def __getattr__(self, key: str) -> Any:
        store = object.__getattribute__(self, "_store")
        if key in store:
            v = store[key]
            return v.fn(self) if isinstance(v, Lazy) else v
        raise AttributeError(key)

    def __setattr__(self, key: str, value: Any) -> None:
        self._store[key] = value

    def __getitem__(self, key: str) -> Any:
        try:
            return getattr(self, key)
        except AttributeError as e:
            raise ConfigError(key) from e

    def __setitem__(self, key: str, value: Any) -> None:
        self._store[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._store

    def keys(self) -> Iterable[str]:
        return self._store.keys()

    def override(self, updates: Mapping[str, Any]) -> "Config":
        """Strictly apply user updates; dotted keys suffix-match existing keys."""
        for key, value in updates.items():
            matches = ([key] if key in self._store
                       else [k for k in self._store if k.endswith("." + key)])
            if not matches:
                raise ConfigError(
                    f"unknown config key '{key}' (no existing key matches)")
            for m in matches:
                self._store[m] = value
        return self

    def resolve(self) -> SimpleNamespace:
        """Resolve lazies and return a snapshot."""
        return SimpleNamespace(**{k: getattr(self, k) for k in self._store})

    def to_dict(self, resolved: bool = True) -> Dict[str, Any]:
        if resolved:
            return {k: getattr(self, k) for k in self._store}
        return dict(self._store)


def _str_presenter(dumper, data):
    if "\n" in data:
        return dumper.represent_scalar("tag:yaml.org,2002:str", data, style="|")
    return dumper.represent_scalar("tag:yaml.org,2002:str", data)


yaml.add_representer(str, _str_presenter, Dumper=yaml.SafeDumper)


def load_yaml(path_or_str: str, from_string: bool = False) -> Dict[str, Any]:
    if from_string:
        return yaml.safe_load(io.StringIO(path_or_str)) or {}
    with open(path_or_str) as f:
        return yaml.safe_load(f) or {}


def save_yaml(obj: Any, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(obj, f, default_flow_style=False, sort_keys=False)


def parse_cli_overrides(args: Iterable[str]) -> Dict[str, Any]:
    """Parse inline ``'key: yamlvalue'`` CLI snippets into one dict; later
    snippets win."""
    out: Dict[str, Any] = {}
    for a in args:
        d = yaml.safe_load(io.StringIO(a))
        if not isinstance(d, dict):
            raise ValueError(f"CLI override must be 'key: value' YAML, got: {a!r}")
        out.update(d)
    return out
