"""The port's numpy debug modules (``utils/pc_utils.py``,
``utils/pc_debug.py``, ``data/nested.py``) against the JAX package's, on
seeded inputs: equal arrays (the same random draws from equal seeds) and
byte-equal PLY files."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from segdino3d_tpu.data import nested as JN  # noqa: E402
from segdino3d_tpu.utils import pc_debug as JD  # noqa: E402
from segdino3d_tpu.utils import pc_utils as JU  # noqa: E402
from segdino3d_tpu_torch.data import nested as TN  # noqa: E402
from segdino3d_tpu_torch.utils import pc_debug as TD  # noqa: E402
from segdino3d_tpu_torch.utils import pc_utils as TU  # noqa: E402


def _equal(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.asarray(want).dtype


def _cloud(seed, shape=(64, 6)):
    return np.random.RandomState(seed).randn(*shape)


# (name, arguments from a seed, the random generator's constructor or None)
PC_UTILS_CASES = [
    ("random_sampling", lambda s: (_cloud(s), 32), np.random.RandomState),
    ("random_sampling", lambda s: (_cloud(s)[:8], 32), np.random.RandomState),
    ("scale_points", lambda s: (_cloud(s, (2, 5, 3)), np.array([2.0, 3.0])),
     None),
    ("roty", lambda s: (0.3 + s,), None),
    ("rotz", lambda s: (-1.2 + s,), None),
    ("roty_batch", lambda s: (np.array([0.1, 0.7, 2.0]) + s,), None),
    ("rotate_point_cloud", lambda s: (_cloud(s, (20, 3)),),
     np.random.RandomState),
    ("rotate_point_cloud", lambda s: (_cloud(s, (20, 3)), JU.roty(0.77)),
     None),
    ("rotate_pc_along_y", lambda s: (_cloud(s, (20, 3)), 0.77), None),
    ("point_cloud_to_bbox", lambda s: (_cloud(s, (3, 10, 3)),), None),
]

PC_DEBUG_CASES = [
    ("random_sampling", lambda s: (_cloud(s), 32), np.random.default_rng),
    ("random_sampling", lambda s: (_cloud(s)[:8], 32), np.random.default_rng),
    ("rotx", lambda s: (0.4 + s,), None),
    ("roty", lambda s: (0.3 + s,), None),
    ("rotz", lambda s: (-1.2 + s,), None),
    ("roty_batch", lambda s: (np.array([0.1, 0.7, 2.0]) + s,), None),
    ("rotate_point_cloud", lambda s: (_cloud(s, (20, 3)),),
     np.random.default_rng),
    ("rotate_pc_along_y", lambda s: (_cloud(s, (20, 3)), 0.77), None),
    ("point_cloud_to_bbox", lambda s: (_cloud(s, (10, 3)),), None),
    ("point_cloud_to_bbox", lambda s: (_cloud(s, (3, 10, 3)),), None),
]


def _call(module, name, args, rng, seed):
    kw = {} if rng is None else {"rng": rng(seed)}
    if name == "random_sampling":
        kw["return_choices"] = True
    # rotate_pc_along_y in pc_debug writes into its argument: each side
    # gets its own copy
    return getattr(module, name)(*[np.copy(a) if isinstance(a, np.ndarray)
                                   else a for a in args], **kw)


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("case", range(len(PC_UTILS_CASES)))
def test_pc_utils_matches_jax(case, seed):
    name, make, rng = PC_UTILS_CASES[case]
    args = make(seed)
    _equal(_call(TU, name, args, rng, seed), _call(JU, name, args, rng, seed))


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("case", range(len(PC_DEBUG_CASES)))
def test_pc_debug_matches_jax(case, seed):
    name, make, rng = PC_DEBUG_CASES[case]
    args = make(seed)
    _equal(_call(TD, name, args, rng, seed), _call(JD, name, args, rng, seed))


def _boxes(seed, width):
    rng = np.random.RandomState(seed)
    b = rng.uniform(0.1, 2.0, (4, width))
    if width == 7:
        b[:, 6] = rng.uniform(-np.pi, np.pi, 4)
    return b


def _lines(seed):
    return np.random.RandomState(seed).randn(3, 2, 3)


# (writer, its arguments before the file name, keywords)
PLY_CASES = [
    ("write_bbox", lambda s: (_boxes(s, 6),), {}),
    ("write_oriented_bbox", lambda s: (_boxes(s, 7),), {}),
    ("write_oriented_bbox", lambda s: (_boxes(s, 7),),
     {"colors": np.array([255, 0, 10], np.uint8)}),
    ("write_oriented_bbox_camera_coord", lambda s: (_boxes(s, 7),), {}),
    ("write_lines_as_cylinders", lambda s: (_lines(s),), {"res": 16}),
]


@pytest.mark.parametrize("module", ("pc_utils", "pc_debug"))
@pytest.mark.parametrize("case", range(len(PLY_CASES)))
def test_ply_writers_byte_equal(tmp_path, module, case):
    name, make, kw = PLY_CASES[case]
    port, jax_mod = (TU, JU) if module == "pc_utils" else (TD, JD)
    args = make(case)
    getattr(port, name)(*args, str(tmp_path / "port"), **kw)
    getattr(jax_mod, name)(*args, str(tmp_path / "jax"), **kw)
    # pc_debug's cylinder writer appends ".ply" to its name, as the
    # reference's does
    suffix = ".ply" if (module, name) == ("pc_debug",
                                          "write_lines_as_cylinders") else ""
    got = (tmp_path / f"port{suffix}").read_bytes()
    assert len(got) > 0
    assert got == (tmp_path / f"jax{suffix}").read_bytes()


@pytest.mark.parametrize("divisibility", (1, 32))
def test_nested_tensor_matches_jax(divisibility):
    rng = np.random.RandomState(divisibility)
    images = [rng.randn(3, h, w).astype(np.float32)
              for h, w in ((20, 31), (17, 40), (33, 12))]
    got = TN.nested_tensor_from_list(images, divisibility)
    want = JN.nested_tensor_from_list(images, divisibility)
    assert type(got).__name__ == type(want).__name__ == "NestedTensor"
    _equal(tuple(got), tuple(want))
    _equal(got.decompose(), want.decompose())
