"""Tiny name -> build-function registry (reference models/registry.py:12-59)."""
from __future__ import annotations

from typing import Callable, Dict


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._funcs: Dict[str, Callable] = {}

    def registe_with_name(self, module_name: str):  # reference spelling
        def deco(fn):
            if module_name in self._funcs:
                raise KeyError(f"{module_name} already registered in {self.name}")
            self._funcs[module_name] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable:
        return self._funcs[name]


MODULE_BUILD_FUNCS = Registry("model build functions")
