"""Padded-batch image container for the 2D path.

Counterpart of ``segdino3d_tpu/data/nested.py``, with the same names, and
through it of the reference's ``NestedTensor`` +
``nested_tensor_from_tensor_list``
(``segdino3d/models/module/nested_tensor.py:6-152``) — a
batch of variable-size images padded to a common shape with a validity
mask.  Vestigial on the 3D path (the padded ``SceneBatch`` plays this role
for point clouds), kept for 2D-feature tooling parity.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np


class NestedTensor(NamedTuple):
    tensors: np.ndarray   # (B, C, H, W)
    mask: np.ndarray      # (B, H, W) bool — True where PADDED (torch conv.)

    def decompose(self):
        return self.tensors, self.mask


def nested_tensor_from_list(images: Sequence[np.ndarray],
                            size_divisibility: int = 1) -> NestedTensor:
    """images: list of (C, H_i, W_i) arrays -> padded NestedTensor."""
    assert len(images) > 0
    c = images[0].shape[0]
    h = max(im.shape[1] for im in images)
    w = max(im.shape[2] for im in images)
    if size_divisibility > 1:
        d = size_divisibility
        h = -(-h // d) * d
        w = -(-w // d) * d
    batch = np.zeros((len(images), c, h, w), images[0].dtype)
    mask = np.ones((len(images), h, w), bool)
    for i, im in enumerate(images):
        _, hi, wi = im.shape
        batch[i, :, :hi, :wi] = im
        mask[i, :hi, :wi] = False
    return NestedTensor(batch, mask)
