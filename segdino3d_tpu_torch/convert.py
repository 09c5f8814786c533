"""Weight carrier between the JAX package's ``variables`` and the port's
state dict, both ways.

``variables`` is ``{"params": ..., "batch_stats": ...}`` as nested dicts of
numpy arrays (``jax.device_get`` of a flax tree).  The port's module names
mirror the flax names, so one rule maps every leaf:

* path segments join with ``.``; a trailing ``_<n>`` index becomes a list
  index (``block1_0`` -> ``block1.0``, ``layers_2`` -> ``layers.2``);
* a 2-d ``kernel`` (flax ``Dense``, (in, out)) becomes ``weight``
  transposed to ``nn.Linear``'s (out, in);
* a 3-d ``kernel`` (sparse convs, (k^3, Cin, Cout) in canonical offset
  order) keeps its name and layout;
* ``scale`` (LayerNorm, batch norm) becomes ``weight``;
* ``batch_stats`` ``mean``/``var`` become ``running_mean``/``running_var``.

``load_jax_variables`` raises unless every leaf lands on exactly one key of
the model and every key of the model gets one leaf of the same shape.
``state_dict_to_jax`` is the inverse map (a trained port model's
``params`` and ``batch_stats`` as the JAX package's nested dicts).  A
gradient tree of the JAX package maps through ``jax_to_state_dict``
(``{"params": grads}``) onto the names of the port's ``.grad``s.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_INDEXED = re.compile(r"^(.*)_(\d+)$")
_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _module_path(segments) -> str:
    parts = []
    for seg in segments:
        m = _INDEXED.match(seg)
        parts.extend([m.group(1), m.group(2)] if m else [seg])
    return ".".join(parts)


def jax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Map every leaf of ``variables`` to its port key; raises on a
    collection other than params/batch_stats or on two leaves that map to
    one key."""
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unexpected variable collection {collection!r}")
        for path, leaf in _leaves(tree):
            *mods, name = path
            if collection == "batch_stats":
                if name not in _STATS:
                    raise KeyError(f"unexpected batch stat {'/'.join(path)}")
                name = _STATS[name]
            elif name == "kernel" and leaf.ndim == 2:
                name, leaf = "weight", leaf.T
            elif name == "scale":
                name = "weight"
            key = f"{_module_path(mods)}.{name}" if mods else name
            if key in out:
                raise KeyError(f"two JAX leaves map to {key}")
            out[key] = torch.from_numpy(np.array(leaf, copy=True))
    return out


def state_dict_to_jax(state_dict: Mapping[str, torch.Tensor]
                      ) -> Dict[str, Dict]:
    """The inverse of ``jax_to_state_dict``: {"params", "batch_stats"} as
    nested dicts of numpy arrays."""
    stats = {v: k for k, v in _STATS.items()}
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        *mods, name = key.split(".")
        leaf = value.detach().cpu().numpy()
        if name in stats:
            collection, name = "batch_stats", stats[name]
        else:
            collection = "params"
            if name == "weight" and leaf.ndim == 2:
                name, leaf = "kernel", leaf.T
            elif name == "weight":
                name = "scale"
        path = []
        for seg in mods:
            if seg.isdigit():
                path[-1] = f"{path[-1]}_{seg}"
            else:
                path.append(seg)
        node = out[collection]
        for seg in path:
            node = node.setdefault(seg, {})
        if name in node:
            raise KeyError(f"two port keys map to {'/'.join(path + [name])}")
        node[name] = np.ascontiguousarray(leaf)
    return {k: v for k, v in out.items() if v}


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load ``variables`` into ``model``; every leaf used exactly once."""
    sd = jax_to_state_dict(variables)
    want = model.state_dict()
    extra = sorted(set(sd) - set(want))
    missing = sorted(set(want) - set(sd))
    if extra or missing:
        raise KeyError(f"JAX leaves without a port key: {extra[:10]}; port "
                       f"keys without a JAX leaf: {missing[:10]}")
    for key, value in sd.items():
        if tuple(value.shape) != tuple(want[key].shape):
            raise ValueError(f"{key}: JAX shape {tuple(value.shape)}, port "
                             f"shape {tuple(want[key].shape)}")
    model.load_state_dict(sd, strict=True)
    return model
