"""Hierarchical configuration and YAML loading (counterpart of
tgt_tpu/core/config.py).

- ``Config`` is a flat dot-keyed mapping with attribute access.
- ``Lazy(fn)`` values are computed from the whole config when read.
- ``override(updates)`` is strict: unknown keys raise, and a dotted key
  matches any config key that ends with it.
- ``resolve()`` returns a SimpleNamespace snapshot.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable, Dict, Mapping

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


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f) or {}
