"""YAML configs (``gapro_tpu/train/config.py``): an attribute dict, so that
a config reads as ``cfg.model.channels``."""

from __future__ import annotations

from typing import Any


class AttrDict(dict):
    def __getattr__(self, k: str) -> Any:
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.wrap(v) for v in obj)
        return obj


def load_config(path: str) -> AttrDict:
    # imported here: a machine without PyYAML can still build a config in
    # code (AttrDict.wrap) and import every module of the port
    import yaml

    with open(path) as f:
        return AttrDict.wrap(yaml.safe_load(f))
