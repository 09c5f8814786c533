"""Plain models of the two table passes that K7 and ``block_dilate`` run.

K7 (``csrc/neighbor_table.cu``) probes the first half of a table's offsets
and fills the mirrored half from the hits (``out[n-1-o, j] = i`` for each
hit ``j`` of row ``i`` at offset ``o``), sets the centre to the row's own
id, and, for a k5 stem on level 0, writes the k3 table of the same level
from the k5 probes through ``sparse_conv.subset_offsets``.  ``block_dilate``
(``csrc/block_conv.cu``) builds each halo-padded brick as bit rows along z
from three words of the mask (the brick's own block's and its two
z-neighbours'), dilates it with three 1-D ORs (z, y, x), and counts the
dilated rows of each list block of ``LIST_ROWS`` rows for the list pass.

Here numpy models of that index arithmetic are held to the port's plain
versions (``neighbor_table_plain``, ``occupancy_dilation_plain``,
``occupied_rows_plain``) and to the JAX package (``_neighbor_table``; the
halo-padded dilation of ``test_torch_port_block_occupancy.py``).  Every
comparison is exact: tables, masks and row ids are integers.
"""
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402

from segdino3d_tpu.ops import sparse_conv as JSC  # noqa: E402
from segdino3d_tpu.ops.voxelize import voxelize as jax_voxelize  # noqa: E402
from segdino3d_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from segdino3d_tpu_torch.ops import block_dense as TBD  # noqa: E402
from segdino3d_tpu_torch.ops import keys as TK  # noqa: E402
from segdino3d_tpu_torch.ops import sparse_conv as TSC  # noqa: E402
from segdino3d_tpu_torch.ops.hashing import lookup_hash  # noqa: E402
from segdino3d_tpu_torch.ops.voxelize import voxelize  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _setup():
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# K7: half the probes, the mirrored half from the hits
# ---------------------------------------------------------------------------

def _border_points(seed=0):
    """Two scenes with voxels at every field limit (x = 1023, y = 1023,
    z = 511, and 0), points past z = 511 and the coordinate whose key is
    all ones."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 30, (700, 3)).astype(np.float32)
    base[:40, 0] = 1023
    base[40:80, 1] = 1023
    base[80:120, 2] = 511
    base[120:160, :2] = 1023
    base[160:200] = 0
    base[200:205, 2] = 515
    reps = rng.randint(1, 9, len(base))
    pts = np.repeat(base, reps, 0) + rng.uniform(0, 0.99, (reps.sum(), 3))
    bidx = np.repeat((np.arange(len(base)) % 8 == 7).astype(np.int32) * 7,
                     reps)
    pts = np.concatenate([pts, [[1023.5, 1023.5, 511.5]]]).astype(np.float32)
    bidx = np.concatenate([bidx, [7]]).astype(np.int32)
    valid = rng.rand(len(pts)) > 0.03
    valid[-1] = True
    return pts, bidx, valid


def _scene_points(seed, n_points=2500):
    """One synthetic scene in voxel units, min-shifted as the wrapper does."""
    rec = synthetic_scene(seed, n_points=n_points, n_superpoints=64)
    x = rec["points"][:, :3] / np.float32(0.02)
    pts = (x - np.floor(x.min(0) / 16.0) * 16.0).astype(np.float32)
    return pts, np.zeros(len(pts), np.int32), np.ones(len(pts), bool)


# (points, level caps): the border scene, and a scene of ~1,900 voxels at
# a level-0 cap of 1,024 (ids past the cap dropped at every level)
SCENES = {"border": (_border_points, [2048, 1024, 512, 512, 256]),
          "overflow": (lambda: _scene_points(4), [1024, 512, 256, 128, 64])}


@functools.lru_cache(maxsize=None)
def _pyramids(scene):
    """(JAX levels, port levels, caps) of one scene."""
    make, caps = SCENES[scene]
    pts, bidx, valid = make()
    jg = jax_voxelize(jnp.asarray(bidx), jnp.asarray(pts), None,
                      jnp.asarray(valid), num_voxels_static=caps[0])
    tg = voxelize(torch.from_numpy(bidx), torch.from_numpy(pts),
                  torch.from_numpy(valid), num_voxels_static=caps[0])
    return (JSC.build_conv_plan(jg, 5, caps).levels,
            TSC.build_conv_plan(tg, 5, caps), caps)


def _mirrored_table(level, k, sub=False):
    """The kernel's table pass over one level's hash: probe offsets
    0 .. n/2 - 1 of the live rows (ids at or past V dropped), the centre
    the row's own id while it is live, each hit ``j`` of row ``i`` at
    offset ``o`` written at ``(n-1-o, j)``; with ``sub`` also the k3 table
    that the k^3 probes give through ``subset_offsets(k, 3)``."""
    coords = level.coords_T
    v = coords.shape[1]
    n = k ** 3
    half = n // 2
    rows = np.arange(v)
    live = rows < int(level.num_voxels)
    out = np.full((n, v), -1, np.int64)
    sub_out = np.full((27, v), -1, np.int64)
    sub_of = TSC.subset_offsets(k, 3)
    out[half] = np.where(live, rows, -1)
    sub_out[13] = out[half]
    offsets = TSC.kernel_offsets(k)
    for o in range(half):
        d = offsets[o]
        key = TK.pack_columns_u32(coords[0], coords[1] + int(d[0]),
                                  coords[2] + int(d[1]), coords[3] + int(d[2]),
                                  torch.from_numpy(live))
        ids = lookup_hash(level.hash, key).numpy().astype(np.int64)
        ids = np.where(ids < v, ids, -1)
        hit = ids >= 0
        out[o] = ids
        out[n - 1 - o, ids[hit]] = rows[hit]
        s = sub_of[o]
        if s >= 0:
            sub_out[s] = ids
            sub_out[26 - s, ids[hit]] = rows[hit]
    return out, (sub_out if sub else None)


def test_subset_offsets_name_the_inner_cube():
    """Each k3 offset once, at the k5 offset of the same (dx, dy, dz), and
    the mirror of one the mirror of the other."""
    m = TSC.subset_offsets(5, 3)
    k5, k3 = TSC.kernel_offsets(5), TSC.kernel_offsets(3)
    assert sorted(m[m >= 0].tolist()) == list(range(27))
    for o in range(125):
        if m[o] >= 0:
            np.testing.assert_array_equal(k5[o], k3[m[o]])
            assert m[124 - o] == 26 - m[o]
        else:
            assert np.abs(k5[o]).max() == 2
    # the k3 first half lies in the k5 first half: the stem's probes give
    # every cell of level 0's k3 table
    assert set(m[:62][m[:62] >= 0].tolist()) == set(range(13))
    np.testing.assert_array_equal(TSC.subset_offsets(3, 3), np.arange(27))


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("kernel", [3, 5])
def test_mirrored_table_matches_plain_and_jax(scene, kernel):
    """The half-probe + mirror model equals ``neighbor_table_plain`` at
    every level (k3) or level 0 (k5), with the k5 probes' k3 table equal
    to level 0's k3 table.  On the border scene it equals JAX's
    ``_neighbor_table`` (which mirrors too); past the cap it equals JAX's
    direct lookups with ids at or past the cap dropped, as the port's
    table is defined there (JAX's own mirror puts such a neighbour in the
    wrong row: ``test_wrapper_overflow_matches_jax_engine``)."""
    jlevels, tlevels, caps = _pyramids(scene)
    assert bool(tlevels[0].overflow)
    if scene == "overflow":
        assert int(tlevels[0].num_voxels) > caps[0]
    for li in ((0,) if kernel == 5 else range(5)):
        got, sub = _mirrored_table(tlevels[li], kernel, sub=kernel == 5)
        plain = TSC.neighbor_table_plain(tlevels[li].coords_T,
                                         tlevels[li].num_voxels, kernel)
        np.testing.assert_array_equal(got, plain.numpy(), err_msg=str(li))
        if sub is not None:
            np.testing.assert_array_equal(sub, TSC.neighbor_table_plain(
                tlevels[0].coords_T, tlevels[0].num_voxels, 3).numpy())
        offsets = JSC.kernel_offsets(kernel)
        if scene == "border":
            want = np.asarray(JSC._neighbor_table(jlevels[li], offsets))
        else:
            want = np.asarray(JSC._neighbor_table(jlevels[li], offsets,
                                                  symmetric=False))
            want = np.where(want >= caps[li], -1, want)
        np.testing.assert_array_equal(got, want, err_msg=str(li))
        assert (got[:kernel ** 3 // 2] >= 0).sum() > 0


@pytest.mark.parametrize("stem_kernel", [3, 5])
def test_neighbor_tables_equal_per_table_plain(stem_kernel):
    """``neighbor_tables`` (one launch on the card) on the CPU: each
    level's k3 table and the stem's, equal to ``neighbor_table_plain`` one
    table at a time, on an overflowing pyramid."""
    _, tlevels, _ = _pyramids("overflow")
    k3, stem = TSC.neighbor_tables(tlevels, stem_kernel)
    assert len(k3) == len(tlevels)
    for lv, t in zip(tlevels, k3):
        assert t.dtype == torch.int32 and t.shape == (27, lv.coords_T.shape[1])
        assert torch.equal(t, TSC.neighbor_table_plain(lv.coords_T,
                                                       lv.num_voxels, 3))
    assert torch.equal(stem, TSC.neighbor_table_plain(
        tlevels[0].coords_T, tlevels[0].num_voxels, stem_kernel))
    if stem_kernel == 3:
        assert stem is k3[0]
    with pytest.raises(ValueError):
        TSC.neighbor_tables(tlevels, 4)


@pytest.mark.parametrize("stem_kernel", [3, 5])
def test_one_memset_covers_every_mirrored_half(stem_kernel):
    """The layout of one launch's tables: each view starts 256 bytes past
    the buffer's start (a CUDA allocation starts on 256 bytes),
    and the range from the first table's mirrored half to the end of the
    last table, which the C entry sets to -1, holds every table's
    mirrored half and none of the first table's probed half or centre."""
    _, tlevels, _ = _pyramids("overflow")
    shapes = [(27, lv.coords_T.shape[1]) for lv in tlevels]
    if stem_kernel != 3:
        shapes.insert(0, (stem_kernel ** 3, tlevels[0].coords_T.shape[1]))
    views = TSC._table_buffer(shapes, "cpu")
    base = views[0].data_ptr()
    assert all((v.data_ptr() - base) % 256 == 0 and v.is_contiguous()
               for v in views)
    first = views[0]
    start, end = TSC._mirror_fill([(first, None)] + [(v, None)
                                                     for v in views[1:]])
    for v in views:
        m = v[v.shape[0] // 2 + 1:]
        assert start <= m.data_ptr() and m.data_ptr() + m.numel() * 4 <= end
    assert first[first.shape[0] // 2].data_ptr() + first.shape[1] * 4 \
        == start


# ---------------------------------------------------------------------------
# block_dilate: bit rows of the halo-padded brick, three 1-D ORs
# ---------------------------------------------------------------------------

def _brick_dilation(mask, block_nbr, edge, k):
    """The kernel's pass: (the dilated mask, each list block's count)."""
    h, p = (k - 1) // 2, edge + k - 1
    e3 = edge ** 3
    nb = block_nbr.shape[1]
    cells = mask.reshape(nb, edge, edge, edge)
    src = np.empty((nb, 27), np.int64)
    src[:, 13] = np.arange(nb)
    src[:, :13] = block_nbr[:13].T
    src[:, 14:] = block_nbr[13:].T
    low = (1 << edge) - 1
    out = np.zeros((nb, edge, edge, edge), bool)
    for b in range(nb):
        zrows = np.zeros((p, p), np.int64)       # bit z, dilated along z
        for px in range(p):
            for py in range(p):
                qx, qy = px - h, py - h
                dx = -1 if qx < 0 else (1 if qx >= edge else 0)
                dy = -1 if qy < 0 else (1 if qy >= edge else 0)
                lx, ly = qx - dx * edge, qy - dy * edge
                bits = []
                for dz in range(3):
                    s = src[b, (dx + 1) * 9 + (dy + 1) * 3 + dz]
                    word = cells[s, lx, ly] if s >= 0 else np.zeros(edge,
                                                                    bool)
                    bits.append(int(sum(1 << c for c in range(edge)
                                        if word[c])))
                row = (bits[0] >> (edge - h)) | (bits[1] << h) | \
                    ((bits[2] & ((1 << h) - 1)) << (h + edge))
                d = 0
                for t in range(k):
                    d |= row >> t
                zrows[px, py] = d & low
        yrows = np.zeros((p, edge), np.int64)
        for px in range(p):
            for y in range(edge):
                yrows[px, y] = np.bitwise_or.reduce(zrows[px, y:y + k])
        for x in range(edge):
            for y in range(edge):
                d = int(np.bitwise_or.reduce(yrows[x:x + k, y]))
                out[b, x, y] = [(d >> c) & 1 for c in range(edge)]
    flat = out.reshape(-1)
    per = TBD.LIST_ROWS
    counts = [int(flat[i:i + per].sum()) for i in range(0, len(flat), per)]
    assert len(flat) % e3 == 0
    return flat, counts


@functools.lru_cache(maxsize=None)
def _occupancy(edge):
    from test_torch_port_block_occupancy import _level

    return _level(edge)


@pytest.mark.parametrize("edge", [4, 8])
@pytest.mark.parametrize("k", [3, 5])
def test_brick_dilation_matches_plain_and_jax(edge, k):
    """The separable bit-row dilation equals ``occupancy_dilation_plain``
    and JAX's halo-padded dilation; its per-block counts sum the mask's
    rows of each list block, and the list built from them is
    ``occupied_rows_plain`` of the dilation."""
    from test_torch_port_block_occupancy import _jax_dilation

    t, jocc, jnbr = _occupancy(edge)
    occ = TBD.occupancy(t)
    got, counts = _brick_dilation(occ.numpy(), t.block_nbr.numpy(), edge, k)
    plain = TBD.occupancy_dilation_plain(occ, t.block_nbr, edge, k)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, _jax_dilation(jocc, jnbr, edge, k))
    assert bool((plain & ~occ).any()) and not bool(plain.all())
    # the list pass: each block's rows at the prefix of the counts before it
    per = TBD.LIST_ROWS
    listed = np.concatenate([np.flatnonzero(got[i * per:(i + 1) * per])
                             + i * per for i in range(len(counts))])
    assert [len(np.flatnonzero(got[i * per:(i + 1) * per]))
            for i in range(len(counts))] == counts
    rows, count = TBD.occupied_rows_plain(plain)
    assert int(count) == sum(counts) == len(listed)
    np.testing.assert_array_equal(rows[:len(listed)].numpy(), listed)
    mask, rl = TBD.dilated_rows(occ, t.block_nbr, edge, k)  # the CPU branch
    assert torch.equal(mask, plain) and rl.ws is None
    assert torch.equal(rl.rows, rows) and int(rl.count) == int(count)


def test_forward_and_dx_take_the_cached_lists(monkeypatch):
    """On the card the forward convs take the level's occupancy list and
    the dX convs the dilation's: on the CPU the lists are built once per
    level (and kernel size) and never per call."""
    t, _, _ = _occupancy(4)
    t.dilations.clear()
    t.rows = None
    occ = TBD.occupancy(t)
    built = []
    real = TBD.dilated_rows

    def counted(*args):
        built.append(args[-1])
        return real(*args)

    monkeypatch.setattr(TBD, "dilated_rows", counted)
    rng = np.random.RandomState(23)
    x = torch.where(occ[:, None], torch.from_numpy(
        rng.randn(occ.shape[0], 3).astype(np.float32)), 0.0).requires_grad_()
    y = x
    for _ in range(3):
        w = torch.from_numpy(rng.randn(27, 3, 3).astype(np.float32) * 0.3)
        y = TBD.dense_subm_conv(y, occ, t, w.requires_grad_())
    y.sum().backward()
    assert built == [3] and set(t.dilations) == {3}
    assert t.rows is None          # the CPU forward builds no list
    t.dilations.clear()
