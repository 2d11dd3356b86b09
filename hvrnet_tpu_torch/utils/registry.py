"""Registry + config-driven builders — the port's own copy of
``hvrnet_tpu/utils/registry.py`` (mmdet's registry mechanism): configs are
plain dicts with a ``type`` key; ``build_from_cfg`` resolves the
class/function from a named registry and instantiates it with the remaining
keys.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    def __repr__(self):
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    @property
    def name(self):
        return self._name

    @property
    def module_dict(self):
        return self._module_dict

    def get(self, key: str):
        return self._module_dict.get(key, None)

    def register_module(self, cls=None, *, name: Optional[str] = None, force: bool = False):
        """Usable both as ``@REG.register_module`` and ``@REG.register_module()``."""
        if cls is None:
            def _decorator(c):
                return self.register_module(c, name=name, force=force)
            return _decorator
        if not (inspect.isclass(cls) or inspect.isfunction(cls)):
            raise TypeError(f"module must be a class or function, got {type(cls)}")
        key = name or cls.__name__
        if not force and key in self._module_dict:
            raise KeyError(f"{key} already registered in {self._name}")
        self._module_dict[key] = cls
        return cls


def build_from_cfg(cfg: Dict[str, Any], registry: Registry, default_args: Optional[dict] = None):
    """Instantiate an object from a config dict with a ``type`` key."""
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with 'type', got {cfg!r}")
    args = dict(cfg)
    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not in the {registry.name} registry")
    elif inspect.isclass(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or class, got {obj_type!r}")
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return obj_cls(**args)
