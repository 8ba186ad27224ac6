"""Config system: YAML configs with ``_BASE_`` inheritance and dotted CLI overrides.

TPU-native rebuild of the reference yacs/fvcore CfgNode surface
(reference: vidgen/config/config.py:22-107). Same YAML files load unchanged:
nested mappings become attribute-accessible nodes, ``_BASE_`` chains merge
bottom-up, and CLI override lists use dotted keys. Unlike the reference we have
no fvcore dependency: this is a small self-contained implementation on top of
dict, with literal-eval of string values for tuple-typed keys (the reference
relies on yacs' ``_decode_cfg_value``).
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List

import yaml

BASE_KEY = "_BASE_"


class CfgNode(dict):
    """A dict subclass with attribute access and freeze support.

    Mirrors the reference API surface (merge_from_file / merge_from_list /
    freeze / defrost / clone / dump) without yacs.
    """

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict | None = None):
        super().__init__()
        self.__dict__[CfgNode.IMMUTABLE] = False
        if init_dict:
            for k, v in init_dict.items():
                if isinstance(v, dict):
                    v = CfgNode(v)
                super().__setitem__(k, v)

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no attribute '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"Config is frozen; cannot set '{name}'")
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"Config is frozen; cannot set '{name}'")
        super().__setitem__(name, value)

    # -- mutability --------------------------------------------------------
    def freeze(self) -> "CfgNode":
        self.__dict__[CfgNode.IMMUTABLE] = True
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        self.__dict__[CfgNode.IMMUTABLE] = False
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return self.__dict__[CfgNode.IMMUTABLE]

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo) -> "CfgNode":
        out = CfgNode()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, k, copy.deepcopy(v, memo))
        return out

    def __reduce__(self):
        return (CfgNode, (), self.__getstate__())

    def __getstate__(self):
        return {"items": dict(self), "immutable": self.__dict__[CfgNode.IMMUTABLE]}

    def __setstate__(self, state):
        self.__dict__[CfgNode.IMMUTABLE] = False
        for k, v in state["items"].items():
            dict.__setitem__(self, k, v)
        self.__dict__[CfgNode.IMMUTABLE] = state["immutable"]

    # -- merging -----------------------------------------------------------
    def merge_from_file(self, cfg_filename: str, allow_unsafe: bool = True) -> None:
        loaded = _load_yaml_with_base(cfg_filename)
        version = loaded.get("VERSION", None)
        if version is not None and "VERSION" in self and version > self["VERSION"]:
            raise ValueError(
                f"Config {cfg_filename} has VERSION {version}, newer than "
                f"supported {self['VERSION']}"
            )
        _merge_a_into_b(loaded, self, key_path=[])

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_a_into_b(dict(other), self, key_path=[])

    def merge_from_list(self, opts: List[str]) -> None:
        assert len(opts) % 2 == 0, f"Override list must be key-value pairs, got {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            node[leaf] = _coerce_value(value, node[leaf], key)

    # -- serialization -----------------------------------------------------
    def dump(self) -> str:
        def to_plain(node):
            if isinstance(node, CfgNode):
                return {k: to_plain(v) for k, v in node.items()}
            return node

        return yaml.safe_dump(to_plain(self), default_flow_style=False)


def _decode_value(v: Any) -> Any:
    """Interpret string scalar as a Python literal when possible.

    The reference configs write tuples as strings, e.g.
    ``STRIDE: (16, 1, 1)`` or ``TRAIN: ("bair_train",)`` — YAML parses these as
    strings, and yacs literal-evals them. We do the same.
    """
    if not isinstance(v, str):
        return v
    try:
        parsed = ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v
    if isinstance(parsed, (tuple, list, dict, bool, int, float)):
        return parsed
    return v


def _coerce_value(value: str, old: Any, full_key: str) -> Any:
    new = _decode_value(value)
    if old is None:
        return new
    if isinstance(new, str) and not isinstance(old, str):
        # plain scalar typed on the CLI, e.g. "0.001" or "True"
        try:
            new = ast.literal_eval(new)
        except (ValueError, SyntaxError):
            pass
    if isinstance(old, tuple) and isinstance(new, list):
        new = tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        new = list(new)
    if isinstance(old, float) and isinstance(new, int):
        new = float(new)
    if new is not None and type(new) is not type(old):
        # yacs raises at merge time on type drift; silently storing e.g. a
        # typo'd string where an int lived fails minutes later (or trains
        # wrong silently)
        raise ValueError(
            f"Type mismatch for config key {full_key}: cannot replace "
            f"{type(old).__name__} {old!r} with {type(new).__name__} {new!r}")
    return new


def _load_yaml_with_base(filename: str) -> Dict:
    with open(filename, "r") as f:
        cfg = yaml.safe_load(f)
    if cfg is None:
        cfg = {}

    base = cfg.pop(BASE_KEY, None)
    if base is not None:
        if not os.path.isabs(base):
            base = os.path.join(os.path.dirname(filename), base)
        base_cfg = _load_yaml_with_base(base)
        _merge_dicts(cfg, base_cfg)
        return base_cfg
    return cfg


def _merge_dicts(src: Dict, dst: Dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge_dicts(v, dst[k])
        else:
            dst[k] = v


def _merge_a_into_b(a: Dict, b: CfgNode, key_path: List[str]) -> None:
    for k, v_raw in a.items():
        full_key = ".".join(key_path + [k])
        if k not in b:
            raise KeyError(f"Non-existent config key: {full_key}")
        v = _decode_value(v_raw)
        if isinstance(v, dict):
            if not isinstance(b[k], CfgNode):
                raise ValueError(f"Cannot merge dict into non-dict key {full_key}")
            _merge_a_into_b(v, b[k], key_path + [k])
        else:
            dict.__setitem__(b, k, _coerce_value(v_raw if isinstance(v_raw, str) else v, b[k], full_key))


def get_cfg() -> CfgNode:
    """Return a fresh copy of the default config tree."""
    from .defaults import _C

    return _C.clone()


_global_cfg = None


def set_global_cfg(cfg: CfgNode) -> None:
    global _global_cfg
    _global_cfg = cfg


def global_cfg() -> CfgNode:
    return _global_cfg
