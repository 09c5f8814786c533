"""The port's on-device plan engine (plain versions, CPU) against the JAX
package's: key packing, the coordinate hash, voxelize, the pyramid and its
neighbour tables; against the port's own host plan; and the backbone
wrapper without a host plan against the JAX wrapper's device branch.

Every index table must be equal.  Voxel means ``1e-6`` (the same sums in
another order); the wrapper's superpoint outputs ``rtol = atol = 1e-4``
(the U-Net's fp32 arithmetic summed in another order, as in
``test_torch_port_model.py``).  Scenes are small (<= 5,000 points): the
JAX CPU voxelize is slow at full size.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import __graft_entry__ as ge  # noqa: E402
from segdino3d_tpu.data import collate as JC  # noqa: E402
from segdino3d_tpu.models.backbone.res16unet import UNetPlan as JUNetPlan  # noqa: E402
from segdino3d_tpu.ops import keys as JK  # noqa: E402
from segdino3d_tpu.ops import sparse_conv as JSC  # noqa: E402
from segdino3d_tpu.ops.hashing import build_hash as jax_build_hash  # noqa: E402
from segdino3d_tpu.ops.hashing import lookup_hash as jax_lookup_hash  # noqa: E402
from segdino3d_tpu.ops.voxelize import voxelize as jax_voxelize  # noqa: E402
from segdino3d_tpu_torch.builder import Capacities, build_model  # noqa: E402
from segdino3d_tpu_torch.convert import load_jax_variables  # noqa: E402
from segdino3d_tpu_torch.data import collate as TC  # noqa: E402
from segdino3d_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from segdino3d_tpu_torch.models.backbone.res16unet import build_unet_plan  # noqa: E402
from segdino3d_tpu_torch.ops import hashing as TQ  # noqa: E402
from segdino3d_tpu_torch.ops import host_plan as TH  # noqa: E402
from segdino3d_tpu_torch.ops import keys as TK  # noqa: E402
from segdino3d_tpu_torch.ops import scatter as TS  # noqa: E402
from segdino3d_tpu_torch.ops import sparse_conv as TSC  # noqa: E402
from segdino3d_tpu_torch.ops import voxelize as TV  # noqa: E402

from test_torch_port_model import (FEAT2D, N_CLS, N_SEM, PORT_CFG,  # noqa: E402
                                   S_CAP, _seeded_variables)

CAPS = [4096, 2048, 1024, 512, 256]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _float32_jax_backbone():
    """``__graft_entry__._build`` reads the backbone dtype from
    ``SEGDINO_COMPUTE_DTYPE``, which the JAX package's export tool sets to
    bfloat16 for the rest of a process where it is unset
    (``tools/export_serving.py``): pin the float32 these comparisons are
    made at, whatever ran before in the process."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEGDINO_COMPUTE_DTYPE", "float32")
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene_points(seeds, n_points=2500):
    """(coords (N, 3) voxel units, min-shifted by a multiple of 16 per scene
    as the wrapper does, bidx, valid, feats (N, 6)) of synthetic scenes,
    padded to ``n_points`` each."""
    coords, bidx, valid, feats = [], [], [], []
    for b, seed in enumerate(seeds):
        rec = synthetic_scene(seed, n_points=n_points - 100, n_superpoints=64)
        c = np.zeros((n_points, 3), np.float32)
        x = rec["points"][:, :3] / np.float32(0.02)
        c[:len(x)] = x - np.floor(x.min(0) / 16.0) * 16.0
        f = np.zeros((n_points, 6), np.float32)
        f[:len(x)] = rec["points"]
        v = np.zeros(n_points, bool)
        v[:len(x)] = True
        coords.append(c)
        feats.append(f)
        valid.append(v)
        bidx.append(np.full(n_points, b, np.int32))
    return (np.concatenate(coords), np.concatenate(bidx),
            np.concatenate(valid), np.concatenate(feats))


def _border_points(seed=0):
    """Two scenes with voxels at every field limit (x = 1023, y = 1023,
    z = 511, and 0), 1-8 points per voxel, a few points past z = 511 and
    the coordinate whose key is all ones."""
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


def _both_grids(coords, bidx, valid, feats=None, cap=CAPS[0]):
    jgrid = jax_voxelize(jnp.asarray(bidx), jnp.asarray(coords),
                         None if feats is None else jnp.asarray(feats),
                         jnp.asarray(valid), num_voxels_static=cap)
    tgrid = TV.voxelize(torch.from_numpy(bidx), torch.from_numpy(coords),
                        torch.from_numpy(valid), num_voxels_static=cap)
    return jax.device_get(jgrid), tgrid


def test_pack_columns_matches_jax():
    rng = np.random.RandomState(0)
    n = 4000
    cols = [rng.randint(-1, 10, n), rng.randint(-3, 1100, n),
            rng.randint(-3, 1100, n), rng.randint(-3, 600, n)]
    cols = [c.astype(np.int32) for c in cols]
    cols[0][:3], cols[1][:3], cols[2][:3], cols[3][:3] = 7, 1023, 1023, 511
    valid = rng.rand(n) > 0.1
    valid[:3] = True
    want = np.asarray(JK.pack_columns_u32(*map(jnp.asarray, cols),
                                          jnp.asarray(valid)))
    got = TK.pack_columns_u32(*map(torch.from_numpy, cols),
                              torch.from_numpy(valid))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert (got[:3] == TK.SENTINEL).all()          # the all-ones alias
    assert (got != TK.SENTINEL).sum() > n // 4


@pytest.mark.parametrize("max_dup", [3, 8])
def test_lookup_hash_matches_jax(max_dup):
    """Each key maps to its smallest row, misses and the sentinel to -1."""
    rng = np.random.RandomState(max_dup)
    distinct = rng.choice(1 << 24, 900, replace=False).astype(np.uint32)
    keys = np.repeat(distinct, rng.randint(1, max_dup + 1, 900))
    rng.shuffle(keys)
    keys[rng.rand(len(keys)) < 0.05] = JK.U32_SENTINEL
    valid = keys != JK.U32_SENTINEL
    queries = np.concatenate([keys, rng.randint(0, 1 << 24, 400).astype(
        np.uint32), [JK.U32_SENTINEL]])
    n = len(keys)
    h = jax_build_hash(jnp.asarray(keys), jnp.arange(n, dtype=jnp.int32),
                       jnp.asarray(valid), capacity=n)
    want = np.asarray(jax_lookup_hash(h, jnp.asarray(queries)))
    th = TQ.build_and_lookup(torch.from_numpy(keys.astype(np.int64)), n)[0]
    got = TQ.lookup_hash(th, torch.from_numpy(queries.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not bool(th.overflow)


@pytest.fixture(scope="module")
def grids():
    coords, bidx, valid, feats = _scene_points((0, 1))
    jgrid, tgrid = _both_grids(coords, bidx, valid, feats)
    return dict(coords=coords, bidx=bidx, valid=valid, feats=feats,
                jgrid=jgrid, tgrid=tgrid)


def test_voxelize_matches_jax(grids):
    jg, tg = grids["jgrid"], grids["tgrid"]
    nv = int(jg.num_voxels)
    assert int(tg.num_voxels) == nv and 1000 < nv < CAPS[0]
    assert not bool(tg.overflow)
    np.testing.assert_array_equal(tg.inverse_mapping.numpy(),
                                  np.asarray(jg.inverse_mapping))
    np.testing.assert_array_equal(tg.coords_T.numpy()[:, :nv],
                                  np.asarray(jg.coords_T)[:, :nv])
    np.testing.assert_array_equal(tg.valid.numpy(), np.asarray(jg.valid))
    # the wrapper's voxel mean (K3's plain version) over the inverse map
    feats = torch.from_numpy(grids["feats"])
    means = TS.segment_mean(feats, tg.inverse_mapping, CAPS[0],
                            torch.from_numpy(grids["valid"]))
    np.testing.assert_allclose(means.numpy()[:nv],
                               np.asarray(jg.feats)[:nv], rtol=1e-6,
                               atol=1e-6)


def test_remapped_hash_lookup_matches_jax(grids):
    """After voxelize both hashes map a key to its voxel id."""
    jg, tg = grids["jgrid"], grids["tgrid"]
    rng = np.random.RandomState(2)
    q = np.concatenate([np.floor(grids["coords"]).astype(np.int32),
                        rng.randint(0, 200, (500, 3)).astype(np.int32)])
    b = np.concatenate([grids["bidx"], rng.randint(0, 2, 500)]).astype(
        np.int32)
    ok = np.ones(len(q), bool)
    jq = JK.pack_columns_u32(jnp.asarray(b), *(jnp.asarray(q[:, d])
                                               for d in range(3)),
                             jnp.asarray(ok))
    tq = TK.pack_columns_u32(torch.from_numpy(b),
                             *(torch.from_numpy(q[:, d]) for d in range(3)),
                             torch.from_numpy(ok))
    want = np.asarray(jax_lookup_hash(jg.hash, jq))
    got = TQ.lookup_hash(tg.hash, tq)
    assert (want >= 0).sum() > len(grids["coords"]) // 2
    np.testing.assert_array_equal(got.numpy(), want)


def test_conv_plan_matches_jax(grids):
    jlevels = JSC.build_conv_plan(grids["jgrid"], 5, CAPS).levels
    tlevels = TSC.build_conv_plan(grids["tgrid"], 5, CAPS)
    for li, (j, t) in enumerate(zip(jlevels, tlevels, strict=True)):
        nv = int(j.num_voxels)
        assert int(t.num_voxels) == nv, li
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
        np.testing.assert_array_equal(t.coords_T.numpy()[:, :nv],
                                      np.asarray(j.coords_T)[:, :nv])
        if li < 4:
            np.testing.assert_array_equal(t.parent.numpy(),
                                          np.asarray(j.parent_idx))
            np.testing.assert_array_equal(t.kpos.numpy(),
                                          np.asarray(j.parent_kpos))
        else:
            assert t.parent is None and j.parent_idx is None


@pytest.mark.parametrize("kernel", [3, 5])
def test_neighbor_tables_match_jax_at_borders(kernel):
    pts, bidx, valid = _border_points()
    jg, tg = _both_grids(pts, bidx, valid, cap=2048)
    jlevels = JSC.build_conv_plan(jg, 5, [2048, 1024, 512, 512, 256]).levels
    tlevels = TSC.build_conv_plan(tg, 5, [2048, 1024, 512, 512, 256])
    assert bool(tg.overflow)            # points past z = 511, the alias
    assert int(tg.num_voxels) == int(jg.num_voxels)
    offsets = JSC.kernel_offsets(kernel)
    levels = (0,) if kernel == 5 else range(5)
    for li in levels:
        want = np.asarray(JSC._neighbor_table(jlevels[li], offsets))
        got = TSC.neighbor_table(tlevels[li], kernel)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(li))
    c0 = tlevels[0].coords_T.numpy()
    at_limit = (c0[1] == 1023) | (c0[2] == 1023) | (c0[3] == 511)
    assert at_limit.sum() >= 100


def _device_and_host_plans(seed, caps):
    coords, bidx, valid, _ = _scene_points((seed, seed + 1))
    host = TH.host_plan_to_device(TH.build_host_plan(
        coords, bidx, valid, caps), "cpu")
    grid = TV.voxelize(torch.from_numpy(bidx), torch.from_numpy(coords),
                       torch.from_numpy(valid), caps[0])
    return build_unet_plan(grid, 5, 5, caps), host


@pytest.mark.parametrize("seed", [0, 3])
def test_device_plan_equals_host_plan(seed):
    (dev, overflow), host = _device_and_host_plans(seed, CAPS)
    assert not bool(overflow)
    np.testing.assert_array_equal(dev.inverse.numpy(), host.inverse.numpy())
    np.testing.assert_array_equal(dev.stem_nbr.numpy(),
                                  host.stem_nbr.numpy())
    for d, h in zip(dev.levels, host.levels, strict=True):
        for k in ("valid", "nbr", "parent", "kpos", "child", "up_order"):
            a, b = getattr(d, k), getattr(h, k)
            if b is None:
                assert a is None, k
            else:
                assert a.dtype == b.dtype, k
                np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                              err_msg=k)


def test_jax_build_hash_flags_dense_voxels():
    """The JAX fault: ``build_hash`` leaves a key's later duplicate rows
    pending, so a voxel of more than 4 points raises its overflow flag
    although every key was placed.  The port's flag stays down and both
    inverse maps agree."""
    rng = np.random.RandomState(1)
    base = rng.randint(0, 50, (400, 3)).astype(np.float32)
    reps = np.ones(400, int)
    reps[:3] = (5, 6, 8)
    pts = (np.repeat(base, reps, 0)
           + rng.uniform(0, 0.99, (reps.sum(), 3))).astype(np.float32)
    bidx = np.zeros(len(pts), np.int32)
    valid = np.ones(len(pts), bool)
    jg, tg = _both_grids(pts, bidx, valid, cap=1024)
    assert bool(jg.overflow) and bool(jg.hash.overflow)
    assert not bool(tg.overflow) and not bool(tg.hash.overflow)
    assert int(tg.num_voxels) == int(jg.num_voxels) == len(
        np.unique(np.floor(pts), axis=0))
    np.testing.assert_array_equal(tg.inverse_mapping.numpy(),
                                  np.asarray(jg.inverse_mapping))


# ---------------------------------------------------------------------------
# the wrapper's device branch against the JAX wrapper's
# ---------------------------------------------------------------------------

SCENE = dict(n_points=2000, n_superpoints=100, n_classes=N_CLS,
             n_queries2d=12, feat_dim_2d=FEAT2D)


@pytest.fixture(scope="module")
def wrapper_pair():
    jmodel, _, _, _, _ = ge._build(
        n_points=2048, s_cap=S_CAP, i_cap=16, k2d=16, num_layers=2,
        d_model=64, n_sem=N_SEM, n_inst_cls=N_CLS, feat2d=FEAT2D,
        init=False)
    jspec = JC.PadSpec(2048, S_CAP, 16, 16, N_SEM)
    tspec = TC.PadSpec(2048, S_CAP, 16, 16, N_SEM)
    rec = synthetic_scene(4, **SCENE)
    jb = JC.collate([rec], jspec)
    variables = _seeded_variables(jmodel, jb)
    tmodel, _ = build_model(PORT_CFG, Capacities(num_superpoints=S_CAP,
                                                 num_voxels=2048),
                            device="cpu")
    load_jax_variables(tmodel, variables)
    return dict(jmodel=jmodel, variables=variables, tmodel=tmodel, jb=jb,
                rec=rec, tb=TC.collate([rec], tspec, "cpu"))


def test_wrapper_device_branch_matches_jax(wrapper_pair):
    """No host plan: both wrappers build the plan on the device.  (The JAX
    overflow flag is up although nothing overflowed: its hash fault,
    ``test_jax_build_hash_flags_dense_voxels``.)"""
    wp = wrapper_pair
    assert wp["jb"].unet_plan is None and wp["tb"].plan is None
    want = jax.device_get(_jax_backbone(wp["jmodel"], wp["variables"],
                                        wp["jb"]))
    with torch.no_grad():
        got = wp["tmodel"].backbone(wp["tb"])
    assert bool(want.overflow) and not bool(got.overflow)
    _assert_backbone_close(got, want)


def test_wrapper_overflow_matches_jax_engine(wrapper_pair):
    """A voxel capacity of 1,024, below the scene's 1,187 voxels: both
    engines flag the overflow and drop the same voxels, and the port's
    outputs agree with the JAX backbone run on the JAX engine's own plan
    with every neighbour looked up directly.  The JAX wrapper's own tables
    differ there: ``_neighbor_table`` mirrors half of the offsets by a
    flattened scatter, and a neighbour id at or past the capacity
    (``o * (V + 1) + j`` with ``j > V``) lands in the next offset's row."""
    wp, cap = wrapper_pair, 1024
    rec, jb = wp["rec"], wp["jb"]
    n = jb.points.shape[1]
    x = rec["points"][:, :3] / np.float32(0.02)
    coords = np.zeros((n, 3), np.float32)
    coords[:len(x)] = x - np.floor(x.min(0) / 16.0) * 16.0
    grid = jax_voxelize(jnp.zeros(n, jnp.int32), jnp.asarray(coords), None,
                        jb.point_valid.reshape(-1), num_voxels_static=cap)
    caps = [cap] + [max(256, -(-int(cap * r) // 256) * 256)
                    for r in (0.7, 0.35, 0.12, 0.05)]
    levels = JSC.build_conv_plan(grid, 5, caps).levels
    k3, k5 = JSC.kernel_offsets(3), JSC.kernel_offsets(5)
    subm = tuple(JSC._neighbor_table(lv, k3, symmetric=False)
                 for lv in levels)
    mirrored = np.asarray(JSC._neighbor_table(levels[0], k3))
    direct = np.asarray(subm[0])
    gone = lambda a: np.where(a >= cap, -1, a)  # noqa: E731
    assert not np.array_equal(gone(mirrored), gone(direct))
    plan = JUNetPlan(levels=levels, subm_nbr=subm,
                     stem_nbr=JSC._neighbor_table(levels[0], k5,
                                                  symmetric=False))
    want = jax.device_get(_jax_backbone(
        wp["jmodel"], wp["variables"],
        jb.replace(unet_plan=plan, plan_inverse_mapping=grid.inverse_mapping)))
    backbone = wp["tmodel"].backbone
    backbone.voxel_cap = cap
    try:
        with torch.no_grad():
            got = backbone(wp["tb"])
    finally:
        backbone.voxel_cap = 2048
    assert int(grid.num_voxels) == 1187
    assert bool(grid.overflow) and bool(got.overflow)
    _assert_backbone_close(got, want)


def _jax_backbone(jmodel, variables, jb):
    return jax.jit(lambda v, b: jmodel.apply(
        v, b, False, method=lambda m, b, t: m.backbone(b, t)))(variables, jb)


def _assert_backbone_close(got, want):
    assert np.abs(np.asarray(want.sp_feats)).mean() > 1e-3
    for key in ("sp_feats", "sp_pos", "sp_pos_wo_elastic", "sp_valid"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)), **TOL,
                                   err_msg=key)
