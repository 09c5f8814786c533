"""The port's host-plan binding against the JAX package's, on the same points.

Every array must be equal exactly; the port's extra tables (the down conv's
child table and the up conv's row order) must invert the parent links.
"""
import os
import sys

import numpy as np
import pytest

from segdino3d_tpu.ops.host_plan import build_host_plan as jax_build_host_plan
from segdino3d_tpu_torch.ops import host_plan as TH

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402

CAPS = [2048, 1024, 512, 256, 128]


@pytest.fixture(scope="module", autouse=True)
def _jax_library():
    """Load the JAX library once another test worker has finished writing
    it (``test_torch_port_jaxlib.py``)."""
    load_jax_sparseplan()


def _points(seed):
    rng = np.random.RandomState(seed)
    coords = rng.uniform(0, 20, (1500, 3)).astype(np.float32)
    bidx = (np.arange(1500) >= 900).astype(np.int32)   # two scenes
    valid = rng.rand(1500) > 0.05
    return coords, bidx, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_arrays_equal_jax(seed):
    coords, bidx, valid = _points(seed)
    want = jax_build_host_plan(coords, bidx, valid, CAPS, stem_compact=False)
    got = TH.build_host_plan(coords, bidx, valid, CAPS)
    assert got.overflow == want.overflow is False
    np.testing.assert_array_equal(got.inverse_mapping, want.inverse_mapping)
    np.testing.assert_array_equal(got.stem_nbr, want.stem_nbr)
    assert got.stem_nbr.shape == (125, CAPS[0])
    for g, w in zip(got.levels, want.levels, strict=True):
        assert g.num_voxels == w.num_voxels
        np.testing.assert_array_equal(g.subm_nbr, w.subm_nbr)
        for a, b in ((g.parent_idx, w.parent_idx),
                     (g.parent_kpos, w.parent_kpos)):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_child_table_and_up_order_invert_parent_links(seed):
    coords, bidx, valid = _points(seed)
    plan = TH.build_host_plan(coords, bidx, valid, CAPS)
    for fine, coarse in zip(plan.levels[:-1], plan.levels[1:]):
        n = fine.num_voxels
        child = fine.child
        assert child.shape == (8, coarse.subm_nbr.shape[1])
        # every valid fine voxel sits at (kpos, parent) and nowhere else
        k, p = np.nonzero(child >= 0)
        assert sorted(child[k, p].tolist()) == list(range(n))
        np.testing.assert_array_equal(fine.parent_idx[child[k, p]], p)
        np.testing.assert_array_equal(fine.parent_kpos[child[k, p]], k)
        assert (p < coarse.num_voxels).all()
        # up_order: a permutation, valid rows first, grouped by kpos
        order = fine.up_order
        np.testing.assert_array_equal(np.sort(order), np.arange(len(order)))
        assert (order[:n] < n).all()
        kp = fine.parent_kpos[order[:n]]
        assert (np.diff(kp) >= 0).all()
