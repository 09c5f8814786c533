"""Plain models of K6's one-launch build and lookup, the probe that K6's
lookup and K7 make in its table, and K5's grouped schedule with the
pool's division folded in, on the CPU.

K6 (``csrc/coord_hash.cu``) keeps a key array and a value array: a
thread claims a slot with a compare-and-swap on the key array (or finds
its own key there), then takes the minimum on the same slot of the value
array, remembers the slot, and after a grid-wide wait reads that value
back as its row's winner.  K7 (``csrc/neighbor_table.cu``) reads a slot's
key a probe step and, on a hit, its value, on the table whose values K8
has remapped to voxel ids.  K5
(``csrc/segment_grad.cu``) gives each voxel a group of G lanes, each lane
runs of 4 columns (1 where the column count is no multiple of 4), loads
the group's members a lane each and adds each member's quotient
``g[s] / count[s]`` in ascending point order.

Here:

* a model of the insert under several seeded interleavings of the threads'
  atomic steps (keys with up to 8 rows, sentinels, a table filled past its
  slots) gives one map whatever the order, equal to ``build_hash_plain`` +
  ``lookup_hash_plain`` and to the JAX ``build_hash`` / ``lookup_hash``;
* a model of the probe equals ``lookup_hash_plain`` on hits, misses and
  sentinels, and, on the model table that K8's plain version remaps, the
  neighbour tables of ``neighbor_table_plain``; the remapped table keeps
  the input's keys and leaves the input's values as they were;
* a model of K5's schedule reading the pool's gradient in place (a column
  slice) equals ``segment_grad_plain`` (1e-6 x max) and the ``jax.vjp`` of
  JAX ``devoxelize`` + ``segment_mean_stack`` (1e-5 x max);
* ``build_and_lookup_plain`` equals ``lookup_hash_plain(build_hash_plain(k),
  k)``.

Tables and maps are integers and compared exactly.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402

from segdino3d_tpu.ops import scatter as JS  # noqa: E402
from segdino3d_tpu.ops.hashing import build_hash as jax_build_hash  # noqa: E402
from segdino3d_tpu.ops.hashing import lookup_hash as jax_lookup_hash  # noqa: E402
from segdino3d_tpu.ops.voxelize import devoxelize as jax_devoxelize  # noqa: E402
from segdino3d_tpu_torch.ops import hashing as TQ  # noqa: E402
from segdino3d_tpu_torch.ops import keys as TK  # noqa: E402
from segdino3d_tpu_torch.ops import scatter as TS  # noqa: E402
from segdino3d_tpu_torch.ops import sparse_conv as TSC  # noqa: E402
from segdino3d_tpu_torch.ops import voxelize as TV  # noqa: E402

EMPTY = 0xFFFFFFFF       # coord_hash::kEmptyKey, the key sentinel
NO_ROW = 0x7FFFFFFF      # an empty slot's value before any insert
K_RUNS = 4               # K5's column runs a lane keeps in registers
REL_PLAIN, REL_JAX = 1e-6, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _setup():
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# K6: build and lookup in one launch
# ---------------------------------------------------------------------------

def _hash_slot(key, mask):
    """coord_hash::hash_slot on uint32 keys held in int64 (scalar or array)."""
    x = (np.asarray(key, np.uint64) * np.uint64(0x9E3779B1)) \
        & np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x2C1B3C6D)) & np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(13)
    return (x & np.uint64(mask)).astype(np.int64)


def _build_lookup_model(keys, t_size, order):
    """K6's build and lookup of ``keys`` (n,) int64 (EMPTY = no row) into
    ``t_size`` slots.  ``order`` picks which live thread takes its next
    atomic step: "ascending" / "descending" run each thread to its end in
    row order, an int seeds a random interleaving of the steps.  Returns
    (tkeys (t_size,) int64, tvals (t_size,) int64, overflow, winner
    (n,))."""
    mask = t_size - 1
    tkeys = np.full(t_size, EMPTY, np.int64)
    tvals = np.full(t_size, NO_ROW, np.int64)
    n = len(keys)
    at = np.full(n, -1, np.int64)
    live = [i for i in range(n) if keys[i] != EMPTY]
    slot = {i: int(_hash_slot(keys[i], mask)) for i in live}
    probes = dict.fromkeys(live, 0)
    claimed, overflow = set(), False
    active = sorted(live, reverse=order == "descending")
    rng = np.random.RandomState(order) if isinstance(order, int) else None
    while active:
        j = rng.randint(len(active)) if rng is not None else 0
        i = active[j]
        done = False
        if i in claimed:                     # atomicMin on the value
            tvals[slot[i]] = min(tvals[slot[i]], i)
            at[i], done = slot[i], True
        else:                                # atomicCAS on the key
            prev = tkeys[slot[i]]
            if prev == EMPTY or prev == keys[i]:
                tkeys[slot[i]] = keys[i]
                claimed.add(i)
            else:
                probes[i] += 1
                if probes[i] > mask:         # no free slot in t_size probes
                    overflow, done = True, True
                else:
                    slot[i] = (slot[i] + 1) & mask
        if done and rng is None:
            active.pop(0)
        elif done:
            active[j] = active[-1]
            active.pop()
    # after the grid-wide wait: the value of the slot each row wrote
    winner = np.where(at >= 0, tvals[np.maximum(at, 0)], -1)
    return tkeys, tvals, overflow, winner


def _probe_model(tkeys, tvals, keys):
    """The probe of K6's lookup and K7: each step reads a slot's key; a
    hit reads the slot's value."""
    mask = len(tkeys) - 1
    keys = np.asarray(keys, np.int64)
    out = np.full(len(keys), -1, np.int64)
    pos = _hash_slot(keys, mask)
    pending = keys != EMPTY
    for _ in range(len(tkeys)):
        if not pending.any():
            break
        k = tkeys[pos]
        hit = pending & (k == keys)
        out[hit] = tvals[pos[hit]]
        pending &= ~hit & (k != EMPTY)
        pos = (pos + 1) & mask
    return out


def _keys(case):
    """(keys (n,) int64, capacity, queries) of one key set."""
    rng = np.random.RandomState({"dup8": 0, "dup3": 1, "overfull": 2}[case])
    if case == "overfull":           # 40 distinct keys, 16 slots
        distinct = rng.choice(1 << 24, 40, replace=False).astype(np.int64)
        keys = np.repeat(distinct, rng.randint(1, 4, 40))
        capacity = 8
    else:
        m = 300
        distinct = rng.choice(1 << 24, m, replace=False).astype(np.int64)
        keys = np.repeat(distinct, rng.randint(1, 9 if case == "dup8" else 4,
                                               m))
        capacity = len(keys)
    rng.shuffle(keys)
    keys[rng.rand(len(keys)) < 0.05] = EMPTY
    queries = np.concatenate([keys, rng.randint(0, 1 << 24, 200), [EMPTY]])
    return keys, capacity, queries


ORDERS = ["ascending", "descending", 0, 1, 2]


@pytest.mark.parametrize("case", ["dup8", "dup3", "overfull"])
@pytest.mark.parametrize("order", ORDERS)
def test_insert_model_matches_plain_and_jax(case, order):
    """One map whatever the threads' order, each key in one slot; equal to
    the plain version and to JAX (the JAX flag also rises on a key of more
    than four rows, so its flag is compared only on the full table)."""
    keys, capacity, _ = _keys(case)
    t_size = TQ.table_size(capacity)
    tkeys, tvals, overflow, winner = _build_lookup_model(keys, t_size,
                                                         order)
    key_t = torch.from_numpy(keys)
    ph, pw = TQ.build_and_lookup_plain(key_t, capacity)
    assert overflow == bool(ph.overflow) == (case == "overfull")
    stored = tkeys[tkeys != EMPTY]
    assert len(np.unique(stored)) == len(stored)          # one slot a key
    valid = keys != EMPTY
    jh = jax_build_hash(jnp.asarray(keys.astype(np.uint32)),
                        jnp.arange(len(keys), dtype=jnp.int32),
                        jnp.asarray(valid), capacity=capacity)
    jw = np.asarray(jax_lookup_hash(jh, jnp.asarray(keys.astype(np.uint32))))
    if case == "overfull":
        # every slot taken; a placed key maps to its smallest row, a key
        # that found no slot to -1
        assert len(stored) == t_size and bool(jh.overflow)
        placed = np.isin(keys, stored)
        np.testing.assert_array_equal(winner[placed], pw.numpy()[placed])
        assert (winner[~placed] == -1).all() and (~placed & valid).any()
    else:
        np.testing.assert_array_equal(winner, pw.numpy())
        np.testing.assert_array_equal(winner, jw)
        np.testing.assert_array_equal(winner,
                                      _probe_model(tkeys, tvals, keys))


@pytest.mark.parametrize("case", ["dup8", "dup3"])
def test_probe_model_matches_plain_lookup(case):
    """Hits, misses and the sentinel."""
    keys, capacity, queries = _keys(case)
    tkeys, tvals = _build_lookup_model(keys, TQ.table_size(capacity), 3)[:2]
    h = TQ.build_hash_plain(torch.from_numpy(keys), capacity)
    want = TQ.lookup_hash_plain(h, torch.from_numpy(queries)).numpy()
    got = _probe_model(tkeys, tvals, queries)
    assert (want == -1).sum() > 100 and (want >= 0).sum() > 300
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["dup8", "overfull"])
def test_build_and_lookup_plain_is_build_then_lookup(case):
    keys, capacity, _ = _keys(case)
    key_t = torch.from_numpy(keys)
    h, w = TQ.build_and_lookup_plain(key_t, capacity)
    h2 = TQ.build_hash_plain(key_t, capacity)
    assert torch.equal(w, TQ.lookup_hash_plain(h2, key_t))
    assert torch.equal(h.keys, h2.keys) and torch.equal(h.vals, h2.vals)
    assert bool(h.overflow) == bool(h2.overflow)
    # the CPU wrapper takes the plain version
    hw, ww = TQ.build_and_lookup(key_t, capacity)
    assert torch.equal(ww, w) and bool(hw.overflow) == bool(h.overflow)


def _model_hash(tkeys, tvals, overflow=False):
    """A CoordHash of K6's two int32 arrays on the CPU."""
    return TQ.CoordHash(
        keys=torch.from_numpy(tkeys.astype(np.uint32).view(np.int32)),
        vals=torch.from_numpy(tvals.astype(np.int32)),
        overflow=torch.tensor(overflow))


def _border_points(seed=0):
    """Two scenes with voxels at every field limit, 1-8 points per voxel,
    points past z = 511 and the coordinate whose key is all ones."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 24, (500, 3)).astype(np.float32)
    base[:30, 0] = 1023
    base[30:60, 1] = 1023
    base[60:90, 2] = 511
    base[90:120] = 0
    base[120:125, 2] = 515
    reps = rng.randint(1, 9, len(base))
    pts = np.repeat(base, reps, 0) + rng.uniform(0, 0.99, (reps.sum(), 3))
    bidx = np.repeat((np.arange(len(base)) % 5 == 4).astype(np.int32), reps)
    pts = np.concatenate([pts, [[1023.5, 1023.5, 511.5]]]).astype(np.float32)
    bidx = np.concatenate([bidx, [7]]).astype(np.int32)
    valid = rng.rand(len(pts)) > 0.03
    valid[-1] = True
    return [torch.from_numpy(a) for a in (bidx, pts, valid)]


def _model_level(cols, key, cap, shift, order):
    """voxelize / downsample on K6's model table: the model's winners and
    table into K8's plain version.  Returns (the compaction, the input
    table)."""
    n = key.shape[0]
    tkeys, tvals, overflow, winner = _build_lookup_model(
        key.numpy(), TQ.table_size(min(cap, n)), order)
    h = _model_hash(tkeys, tvals, overflow)
    comp = TV.voxel_compact_plain(torch.from_numpy(winner).to(torch.int32),
                                  cols, cap, shift, h, shift == 1)
    return comp, h


def _k7_table_model(comp, k):
    """K7's tables by the probe of every offset on the remapped table (ids
    at or past the capacity dropped)."""
    coords = comp.coords_T
    v = coords.shape[1]
    live = torch.arange(v) < comp.num_voxels
    tkeys = comp.hash.keys.numpy().view(np.uint32).astype(np.int64)
    tvals = comp.hash.vals.numpy().astype(np.int64)
    out = []
    for d in TSC.kernel_offsets(k):
        q = TK.pack_columns_u32(coords[0], coords[1] + int(d[0]),
                                coords[2] + int(d[1]), coords[3] + int(d[2]),
                                live)
        ids = _probe_model(tkeys, tvals, q.numpy())
        out.append(np.where(ids < v, ids, -1))
    return np.stack(out)


@pytest.mark.parametrize("v_cap", [2048, 300])
def test_k7_probe_on_remapped_slots_matches_plain_tables(v_cap):
    """Point keys into the model table, K8's plain remap (ids past v_cap
    dropped at 300), then K7's probes: level 0's k3 and k5 tables
    and level 1's k3 table equal ``neighbor_table_plain``, and the
    compactions equal the plain voxelize and downsample."""
    bidx, pts, valid = _border_points()
    cols, key = TV.point_keys(bidx, pts, valid)
    l0 = _model_level(cols, key, v_cap, 0, 1)[0]
    grid = TV.voxelize(bidx, pts, valid, num_voxels_static=v_cap)
    assert torch.equal(l0.inverse, grid.inverse_mapping)
    assert torch.equal(l0.coords_T, grid.coords_T)
    assert int(l0.num_voxels) == int(grid.num_voxels)
    b, x, y, z = l0.coords_T
    key1 = TK.pack_columns_u32(b, x >> 1, y >> 1, z >> 1, l0.valid)
    l1 = _model_level(l0.coords_T, key1, 1024, 1, 2)[0]
    pyr = TSC.build_conv_plan(grid, 2, [v_cap, 1024])
    assert torch.equal(l1.coords_T, pyr[1].coords_T)
    assert torch.equal(l1.inverse, pyr[0].parent)
    for comp, k in ((l0, 3), (l0, 5), (l1, 3)):
        want = TSC.neighbor_table_plain(comp.coords_T, comp.num_voxels, k)
        np.testing.assert_array_equal(_k7_table_model(comp, k), want.numpy())
    if v_cap == 300:
        assert int(l0.num_voxels) > v_cap


@pytest.mark.parametrize("shift", [0, 1])
def test_remapped_table_keeps_keys_and_input(shift):
    """K8's plain version on the model table: the remapped table shares
    the input's keys, maps each key to the voxel id of its winner (the
    model's lookup of a key gives the compaction's inverse), and the input
    table still maps each key to its smallest row."""
    bidx, pts, valid = _border_points(shift + 3)
    cols, key = TV.point_keys(bidx, pts, valid)
    if shift == 1:
        l0 = _model_level(cols, key, 2048, 0, 4)[0]
        cols = l0.coords_T
        b, x, y, z = cols
        key = TK.pack_columns_u32(b, x >> 1, y >> 1, z >> 1, l0.valid)
    comp, h = _model_level(cols, key, 1024, shift, 5)
    vals_before = h.vals.clone()
    assert comp.hash.keys is h.keys and torch.equal(h.vals, vals_before)
    tkeys = h.keys.numpy().view(np.uint32).astype(np.int64)
    ids = _probe_model(tkeys, comp.hash.vals.numpy().astype(np.int64),
                       key.numpy())
    live = key.numpy() != EMPTY
    np.testing.assert_array_equal(ids[live], comp.inverse.numpy()[live])
    rows = _probe_model(tkeys, h.vals.numpy().astype(np.int64), key.numpy())
    want = TQ.build_and_lookup_plain(key, key.shape[0])[1].numpy()
    np.testing.assert_array_equal(rows, want)


# ---------------------------------------------------------------------------
# K5: the pool's backward in one launch, grouped lanes
# ---------------------------------------------------------------------------

def _group(cols):
    """(W columns a run, runs, G lanes a voxel) as K5's launch picks them."""
    w = 4 if cols % 4 == 0 else 1
    runs = cols // w
    g = 1
    while g < 32 and g * K_RUNS < runs:
        g *= 2
    return w, runs, g


def _grad_schedule_model(g, seg, num_segments, vox_offsets, vox_members,
                         sp_offsets, cols):
    """K5's schedule: a group of G lanes a voxel, lane ``lig`` of pass r0
    holding runs r0 + u * G + lig (u < K_RUNS); members loaded a lane each
    in chunks of G and taken in ascending order; each quotient
    g[s] / max(count[s], 1) in fp32 added to the lane's fp32 sums.  ``g``
    is read where it lies (a column slice)."""
    w, runs, grp = _group(cols)
    owner = {}
    for r0 in range(0, runs, grp * K_RUNS):
        for u in range(K_RUNS):
            for lig in range(grp):
                r = r0 + u * grp + lig
                if r < runs:
                    assert r not in owner
                    owner[r] = (r0, u, lig)
    assert sorted(owner) == list(range(runs))          # each run once
    col = np.array([c for r in sorted(owner, key=owner.get)
                    for c in range(r * w, r * w + w)])
    gv = g.numpy()                                     # strided view
    assert gv.strides[0] > cols * 4 or g.shape[0] == 1
    seg = seg.numpy()
    members = vox_members.numpy()
    b, e = vox_offsets.numpy()[:-1], vox_offsets.numpy()[1:]
    cnt = np.maximum(np.diff(sp_offsets.numpy()), 1).astype(np.float32)
    out = np.zeros((len(b), cols), np.float32)
    for p0 in range(0, int((e - b).max()), grp):       # member chunks
        lanes = []
        for lig in range(grp):                          # a member a lane
            has = e - b > p0 + lig
            s = np.full(len(b), -1, np.int64)
            s[has] = seg[members[b[has] + p0 + lig]]
            s[(s < 0) | (s >= num_segments)] = -1
            lanes.append(s)
        for j in range(grp):                            # the broadcasts
            s = lanes[j]
            rows = np.nonzero(s >= 0)[0]
            q = gv[s[rows]][:, col] / cnt[s[rows]][:, None]
            out[rows[:, None], col[None, :]] += q
    return out


def _pool_case(seed, cols, negative_ids):
    rng = np.random.RandomState(seed)
    n, v, s = 3000, 500, 40
    inverse = rng.randint(-1, v, n).astype(np.int32)
    inverse[:400] = 7                                  # a voxel of ~400 rows
    lo = -2 if negative_ids else 0
    seg = rng.randint(lo, s + 2, n).astype(np.int32)
    valid = rng.rand(n) > 0.1
    dmeans = rng.randn(s, cols + 6).astype(np.float32)
    return [torch.from_numpy(a) for a in (inverse, seg, valid, dmeans)] + [v, s]


@pytest.mark.parametrize("cols", [96, 24, 13, 600])
def test_grad_schedule_matches_plain(cols):
    """C = 96 (8 lanes x 3 float4 runs), 24 (2 lanes), 13 (scalar runs), 600
    (two passes of 32 lanes); ids outside [0, S), invalid rows, -1 voxels."""
    inverse, seg, valid, dmeans, v, s = _pool_case(cols, cols, True)
    g = dmeans[:, :cols]
    vox = TS.segment_csr(inverse, v, valid)
    sp = TS.segment_csr(seg, s, valid)
    got = _grad_schedule_model(g, seg, s, vox.offsets, vox.members,
                               sp.offsets, cols)
    want = TS.segment_grad_plain(g, seg, s, sp.offsets, inverse, valid, v)
    # the CPU wrapper, as the pool's backward calls it
    wrapped = TS.segment_grad(g, seg, s, sp.offsets, inverse, valid, vox)
    tol = REL_PLAIN * float(want.abs().max())
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=tol)
    assert torch.equal(wrapped, want)
    assert float(want.abs().max()) > 0


@pytest.mark.parametrize("cols", [96, 13])
def test_grad_schedule_matches_jax_vjp(cols):
    """The model against the ``jax.vjp`` of JAX ``devoxelize`` +
    ``segment_mean_stack`` (the forward's fused pool), whose cotangent is
    the voxel columns of the pool's gradient; superpoint ids in [0, S]
    (JAX clips a negative id to 0, the port drops it)."""
    inverse, seg, valid, dmeans, v, s = _pool_case(cols + 1, cols, False)
    g = dmeans[:, :cols]
    vox = TS.segment_csr(inverse, v, valid)
    sp = TS.segment_csr(seg, s, valid)
    got = _grad_schedule_model(g, seg, s, vox.offsets, vox.members,
                               sp.offsets, cols)
    rng = np.random.RandomState(9)
    vox0 = jnp.asarray(rng.randn(v, cols).astype(np.float32))
    q = jnp.asarray(rng.randn(len(inverse), 3).astype(np.float32))
    ji, js, jv = (jnp.asarray(t.numpy()) for t in (inverse, seg, valid))

    def pool(x):
        pts = jax_devoxelize(x, ji, jv)
        return JS.segment_mean_stack([pts, q], js, s, jv)[0]

    _, vjp = jax.vjp(pool, vox0)
    want = np.asarray(vjp(jnp.asarray(g.numpy()))[0])
    tol = REL_JAX * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
