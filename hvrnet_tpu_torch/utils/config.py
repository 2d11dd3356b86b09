"""Python-file config loader — the port's own copy of
``hvrnet_tpu/utils/config.py`` (the port imports nothing of the JAX package).

The shipped configs (``configs/faster_rcnn_r101_{selsa,hrnmp}_c5.py``) are
plain Python modules whose top-level variables become config entries, as with
``mmcv.Config.fromfile``.  This module reproduces that behaviour with
attribute-style access and no mmcv dependency.
"""
from __future__ import annotations

import ast
import os
import sys
import tempfile
import types
from importlib import util as importlib_util
from typing import Any, Dict


class ConfigDict(dict):
    """A dict with attribute access (`cfg.model.backbone.depth`)."""

    def __getattr__(self, name: str):
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return value

    def __setattr__(self, name: str, value):
        self[name] = value

    def __delattr__(self, name: str):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def copy(self):
        return ConfigDict({k: v for k, v in self.items()})

    def get(self, key, default=None):
        return super().get(key, default)


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict) and not isinstance(obj, ConfigDict):
        return ConfigDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, ConfigDict):
        return ConfigDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_wrap(v) for v in obj)
    return obj


def unwrap(obj: Any) -> Any:
    """Recursively convert ConfigDicts back to plain dicts (for serialization)."""
    if isinstance(obj, dict):
        return {k: unwrap(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(unwrap(v) for v in obj)
    return obj


class Config:
    """Executable-Python config with attribute access.

    ``Config.fromfile(path)`` executes the file as a module and collects every
    non-dunder top-level name, mirroring `mmcv.Config` semantics.
    """

    def __init__(self, cfg_dict: Dict[str, Any], filename: str = ""):
        object.__setattr__(self, "_cfg_dict", _wrap(cfg_dict))
        object.__setattr__(self, "_filename", filename)

    @staticmethod
    def fromfile(filename: str) -> "Config":
        filename = os.path.abspath(os.path.expanduser(filename))
        if not os.path.isfile(filename):
            raise FileNotFoundError(filename)
        if not filename.endswith(".py"):
            raise ValueError("Only python-file configs are supported")
        with open(filename) as f:
            ast.parse(f.read(), filename=filename)  # early syntax error report
        spec = importlib_util.spec_from_file_location(
            "_hvrnet_tpu_torch_cfg_" + os.path.splitext(os.path.basename(filename))[0],
            filename,
        )
        mod = importlib_util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        cfg_dict = {
            k: v
            for k, v in mod.__dict__.items()
            if not k.startswith("__") and not isinstance(v, types.ModuleType)
            and not isinstance(v, (types.FunctionType, type))
        }
        sys.modules.pop(spec.name, None)
        return Config(cfg_dict, filename=filename)

    @property
    def filename(self) -> str:
        return self._filename

    @property
    def text(self) -> str:
        if self._filename and os.path.isfile(self._filename):
            with open(self._filename) as f:
                return f.read()
        return repr(self._cfg_dict)

    def __getattr__(self, name: str):
        return getattr(self._cfg_dict, name)

    def __getitem__(self, name: str):
        return self._cfg_dict[name]

    def __setattr__(self, name: str, value):
        self._cfg_dict[name] = _wrap(value)

    def __contains__(self, name: str):
        return name in self._cfg_dict

    def get(self, name: str, default=None):
        return self._cfg_dict.get(name, default)

    def keys(self):
        return self._cfg_dict.keys()

    def as_dict(self) -> Dict[str, Any]:
        return unwrap(self._cfg_dict)
