"""Component registries: a config node ``dict(type="Name", ...)`` builds
the object registered under ``Name``.

Counterpart of ``segdino3d_tpu/registry.py`` with the two registries the
training entry point reads: ``DATASETS`` (the ScanNet readers,
``data.scannet_dataset``) and ``TRANSFORMS`` (the pipeline factories,
``data.transforms``).  The model is built by ``builder.build_model``.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A name -> class/callable registry with ``build`` support."""

    def __init__(self, name: str):
        self.name = name
        self._modules: Dict[str, Callable] = {}

    def register_module(self, name: Optional[str] = None,
                        module: Optional[Callable] = None):
        if module is not None:
            self._register(name or module.__name__, module)
            return module

        def _decorator(cls):
            self._register(name or cls.__name__, cls)
            return cls

        return _decorator

    def _register(self, name: str, module: Callable):
        if name in self._modules and self._modules[name] is not module:
            raise KeyError(f"{name!r} already registered in {self.name}")
        self._modules[name] = module

    def get(self, name: str) -> Callable:
        if name not in self._modules:
            raise KeyError(
                f"{name!r} not found in registry {self.name!r}. "
                f"Available: {sorted(self._modules)}")
        return self._modules[name]

    def __contains__(self, name: str) -> bool:
        return name in self._modules

    def build(self, cfg: Optional[Dict[str, Any]], **extra) -> Any:
        return build_from_cfg(cfg, self, **extra)


def build_from_cfg(cfg: Optional[Dict[str, Any]], registry: Registry,
                   **extra) -> Any:
    """Instantiate ``registry[cfg['type']](**cfg_without_type, **extra)``."""
    if cfg is None:
        return None
    if not isinstance(cfg, dict):
        raise TypeError(f"cfg must be a dict, got {type(cfg)}")
    cfg = dict(cfg)
    obj_type = cfg.pop("type", None)
    if obj_type is None:
        raise KeyError(f"cfg for registry {registry.name!r} has no 'type': "
                       f"{cfg}")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"'type' must be a str or class, got {type(obj_type)}")
    cfg.update(extra)
    return obj_cls(**cfg)


DATASETS = Registry("datasets")
TRANSFORMS = Registry("transforms")
