"""Minimal string -> constructor registry (reference: vidgen/utils/registry.py
re-exports fvcore's Registry; we use a plain dict-based one)."""

from typing import Any, Callable, Dict, Iterable, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def register(self, obj: Optional[Any] = None) -> Callable:
        if obj is None:
            def deco(fn_or_class):
                self._do_register(fn_or_class.__name__, fn_or_class)
                return fn_or_class

            return deco
        self._do_register(obj.__name__, obj)
        return obj

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._obj_map:
            raise ValueError(f"'{name}' already registered in {self._name}")
        self._obj_map[name] = obj

    def get(self, name: str) -> Any:
        if name not in self._obj_map:
            raise KeyError(
                f"No object named '{name}' in '{self._name}' registry. "
                f"Available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def keys(self) -> Iterable[str]:
        return self._obj_map.keys()
