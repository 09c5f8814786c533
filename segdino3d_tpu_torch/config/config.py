"""Python-file configs with ``_base_`` inheritance.

Counterpart of ``segdino3d_tpu/config/config.py``, reading the same files
(``configs/prototypes/*.py``) to the same dicts:

* a config is a plain ``.py`` file executed in its own namespace;
* a ``_base_`` (str or list) key pulls in base files whose values are
  deep-merged (later files and the child file win);
* inside the child file ``_base_`` is an attribute dict, so overrides such
  as ``_base_.model.decoder_cfg.d_model = 256`` work;
* ``merge_from_options({'a.b.c': v})`` is the CLI's ``--options`` merge;
* ``dump`` writes ``key = value`` lines that ``fromfile`` reads back.
"""
from __future__ import annotations

import copy
import os
import types
from typing import Any, Dict, List, Optional, Union


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo):
        return ConfigDict(
            {copy.deepcopy(k, memo): copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def convert(obj):
        """Recursively convert plain dicts to ConfigDict."""
        if isinstance(obj, dict):
            return ConfigDict({k: ConfigDict.convert(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            converted = [ConfigDict.convert(v) for v in obj]
            return type(obj)(converted) if isinstance(obj, tuple) else converted
        return obj


def _deep_merge(base: Dict, override: Dict) -> Dict:
    """Merge ``override`` into ``base`` (returns new dict). Dicts merge
    recursively; any other value in override replaces the base value.
    A ``{'_delete_': True, ...}`` override replaces the dict wholesale."""
    merged = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and k in merged and isinstance(merged[k], dict):
            v = dict(v)
            if v.pop("_delete_", False):
                merged[k] = v
            else:
                merged[k] = _deep_merge(merged[k], v)
        else:
            merged[k] = v
    return merged


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    filename = os.path.abspath(os.path.expanduser(filename))
    if not os.path.isfile(filename):
        raise FileNotFoundError(filename)
    with open(filename, "r") as f:
        code = f.read()

    namespace: Dict[str, Any] = {"__file__": filename}

    # Resolve _base_ first so the child body can reference `_base_.x.y`.
    base_files: List[str] = []
    # Cheap scan: execute once in a throwaway namespace to discover `_base_`
    # without attribute access to it (config files put `_base_ = [...]` at
    # the top, before any `_base_.attr` usage, so a partial exec works).
    import ast

    tree = ast.parse(code, filename)
    base_expr = None
    kept_body = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "_base_" for t in node.targets
        ):
            base_expr = ast.literal_eval(node.value)
            continue  # drop: the injected ConfigDict must not be rebound
        kept_body.append(node)
    tree.body = kept_body
    if base_expr is not None:
        base_files = [base_expr] if isinstance(base_expr, str) else list(base_expr)

    merged_base: Dict[str, Any] = {}
    cfg_dir = os.path.dirname(filename)
    for bf in base_files:
        base_cfg = _exec_pyfile(os.path.join(cfg_dir, bf))
        merged_base = _deep_merge(merged_base, base_cfg)

    namespace["_base_"] = ConfigDict.convert(merged_base)
    exec(compile(tree, filename, "exec"), namespace)

    cfg = {}
    for k, v in namespace.items():
        if k.startswith("__") or k == "_base_":
            continue
        if isinstance(v, (types.ModuleType, types.FunctionType, type)):
            continue
        cfg[k] = v
    # base values that were only modified through `_base_.x` attribute access
    final = _deep_merge(dict(namespace["_base_"]), cfg)
    return final


class Config(ConfigDict):
    """Top-level config object."""

    @staticmethod
    def fromfile(filename: str) -> "Config":
        return Config(ConfigDict.convert(_exec_pyfile(filename)))

    @staticmethod
    def fromdict(d: Dict[str, Any]) -> "Config":
        return Config(ConfigDict.convert(d))

    def merge_from_options(self, options: Optional[Dict[str, Any]]):
        """Merge ``{'a.b.c': value}`` style overrides (CLI --options)."""
        if not options:
            return self
        for key, value in options.items():
            parts = key.split(".")
            node: Dict = self
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], dict):
                    node[p] = ConfigDict()
                node = node[p]
            node[parts[-1]] = ConfigDict.convert(value)
        return self

    def dump(self, path: str):
        import pprint

        with open(path, "w") as f:
            for k, v in self.items():
                f.write(f"{k} = {pprint.pformat(v, width=100)}\n")
