"""String-typed component registry (the port's copy of the part of
``bonai_tpu/registry.py`` that the detector, dataset and pipeline builders
use)."""

from __future__ import annotations

import inspect


class Registry:
    def __init__(self, name):
        self.name = name
        self.module_dict = {}

    def __contains__(self, key):
        return key in self.module_dict

    def get(self, key):
        return self.module_dict.get(key)

    def register_module(self, name=None):
        """Use as ``@REG.register_module()``."""

        def _decorator(cls):
            if not inspect.isclass(cls):
                raise TypeError(f"module must be a class, got {type(cls)}")
            key = name or cls.__name__
            if key in self.module_dict:
                raise KeyError(f"{key} is already registered in {self.name}")
            self.module_dict[key] = cls
            return cls

        return _decorator


def build_from_cfg(cfg, registry, default_args=None):
    """``registry[cfg['type']](**cfg_without_type, **default_args)``."""
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with the key 'type': {cfg}")
    args = dict(cfg)
    obj_type = args.pop("type")
    obj_cls = registry.get(obj_type) if isinstance(obj_type, str) \
        else obj_type
    if obj_cls is None:
        raise KeyError(f"{obj_type} is not in the {registry.name} registry "
                       f"of bonai_tpu_torch; available: "
                       f"{sorted(registry.module_dict)}")
    for k, v in (default_args or {}).items():
        args.setdefault(k, v)
    return obj_cls(**args)
