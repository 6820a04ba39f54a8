"""String-typed component registry (the port's copy of the part of
``bonai_tpu/registry.py`` that the detector builder uses)."""

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
