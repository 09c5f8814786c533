"""Weight carrier: the JAX package's ``variables`` -> the port's state dict.

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
            key = f"{_module_path(mods)}.{name}"
            if key in out:
                raise KeyError(f"two JAX leaves map to {key}")
            out[key] = torch.from_numpy(np.array(leaf, copy=True))
    return out


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
