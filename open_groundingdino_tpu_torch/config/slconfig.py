"""Python-file experiment configs.

Same *semantics* as the reference's mmcv-style SLConfig (util/slconfig.py):
configs are plain ``.py`` files whose module-level names become config keys,
``_base_`` pulls in parent config files with child-overrides-parent deep
merge, ``merge_from_dict`` applies CLI ``key=value`` overrides with dotted
paths, and values are reachable both as items and attributes.

The implementation is new and much smaller: configs are executed with
``exec`` in an isolated namespace (no temp-module import dance), and the
attribute-dict is a ~30-line class instead of the ``addict`` dependency.
"""
from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, Union

BASE_KEY = "_base_"
DELETE_KEY = "_delete_"
RESERVED = (BASE_KEY, DELETE_KEY)


class ConfigDict(dict):
    """dict with attribute access; missing attributes raise AttributeError."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(f"no config key '{name}'") from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _to_config_dict(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config_dict(v) for v in obj)
    return obj


def _merge(base: Dict, child: Dict) -> Dict:
    """Deep-merge child into base; child wins.  ``_delete_: True`` in a child
    dict replaces instead of merging (reference slconfig.py:118-145)."""
    out = copy.deepcopy(base)
    for k, v in child.items():
        if k in RESERVED:
            continue
        if (
            isinstance(v, dict)
            and isinstance(out.get(k), dict)
            and not v.get(DELETE_KEY, False)
        ):
            out[k] = _merge(out[k], v)
        else:
            if isinstance(v, dict):
                v = {kk: vv for kk, vv in v.items() if kk != DELETE_KEY}
            out[k] = copy.deepcopy(v)
    return out


def _exec_config_file(filename: str) -> Dict[str, Any]:
    filename = os.path.abspath(os.path.expanduser(filename))
    if not os.path.isfile(filename):
        raise FileNotFoundError(filename)
    with open(filename, "r") as f:
        source = f.read()
    # validate it parses (gives good error locations)
    ast.parse(source, filename=filename)
    namespace: Dict[str, Any] = {"__file__": filename}
    exec(compile(source, filename, "exec"), namespace)
    cfg = {
        k: v
        for k, v in namespace.items()
        if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))
    }

    if BASE_KEY in cfg:
        bases = cfg.pop(BASE_KEY)
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        for rel in bases:
            parent = _exec_config_file(os.path.join(os.path.dirname(filename), rel))
            dup = set(merged) & set(parent)
            if dup:
                raise KeyError(f"duplicate keys in multiple _base_ files: {dup}")
            merged.update(parent)
        cfg = _merge(merged, cfg)
    return cfg


def _set_dotted(d: Dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    cur = d
    for k in keys[:-1]:
        cur = cur.setdefault(k, ConfigDict())
    cur[keys[-1]] = value


def parse_override_value(text: str) -> Any:
    """Parse a CLI override value: python literal if possible, else string.
    'true'/'false' (any case) map to bools, bare words stay strings."""
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


class SLConfig:
    """Config object: ``SLConfig.fromfile(path)`` or ``SLConfig(dict)``."""

    def __init__(self, cfg_dict: Union[Dict, None] = None, filename: str = None):
        object.__setattr__(self, "_cfg", _to_config_dict(cfg_dict or {}))
        object.__setattr__(self, "_filename", filename)

    # -- constructors ------------------------------------------------------
    @classmethod
    def fromfile(cls, filename: str) -> "SLConfig":
        return cls(_exec_config_file(filename), filename=filename)

    # -- mapping / attribute protocol --------------------------------------
    @property
    def filename(self):
        return self._filename

    def __getattr__(self, name: str) -> Any:
        return getattr(object.__getattribute__(self, "_cfg"), name)

    def __setattr__(self, name: str, value: Any) -> None:
        self._cfg[name] = _to_config_dict(value)

    def __getitem__(self, key):
        return self._cfg[key]

    def __setitem__(self, key, value):
        self._cfg[key] = _to_config_dict(value)

    def __contains__(self, key):
        return key in self._cfg

    def __iter__(self):
        return iter(self._cfg)

    def keys(self):
        return self._cfg.keys()

    def items(self):
        return self._cfg.items()

    def get(self, key, default=None):
        return self._cfg.get(key, default)

    def to_dict(self) -> Dict[str, Any]:
        def plain(o):
            if isinstance(o, dict):
                return {k: plain(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return type(o)(plain(v) for v in o)
            return o

        return plain(dict(self._cfg))

    # -- merging ------------------------------------------------------------
    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Apply dotted-path overrides, e.g. {'lr': 1e-4, 'model.depth': 3}."""
        incoming: Dict[str, Any] = {}
        for k, v in options.items():
            _set_dotted(incoming, k, v)
        merged = _merge(dict(self._cfg), incoming)
        object.__setattr__(self, "_cfg", _to_config_dict(merged))

    def merge_args(self, args) -> None:
        """Merge config keys into an argparse Namespace; raise on collision
        with an already-set CLI attribute (reference main.py:208-214)."""
        for k, v in self._cfg.items():
            if hasattr(args, k) and getattr(args, k) is not None:
                raise ValueError(f"config key '{k}' collides with CLI argument")
            setattr(args, k, v)

    # -- dump ----------------------------------------------------------------
    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            for k, v in self._cfg.items():
                f.write(f"{k} = {v!r}\n")

    def __repr__(self):
        return f"SLConfig({dict(self._cfg)!r})"
