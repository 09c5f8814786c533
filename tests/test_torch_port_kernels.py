"""Each CUDA kernel of the port against its plain PyTorch version, on the card,
and each autograd Function's backward on the card against its CPU run.

Marked ``cuda``: they skip on a machine without a CUDA device (a CUDA kernel
has no CPU mode).  This file imports no JAX, so it also runs where JAX is
not installed, without the JAX package's test settings (`tests/conftest.py`
imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernels.py

Tolerances: fp32 ``rtol = atol = 1e-4`` (the same fp32 products summed in
another order); bf16 ``1e-2`` (both sides sum in fp32 and round once to
bf16, so they may differ by one bf16 ulp).  The weight gradient (K4) sums
hundreds of rows: its tolerance is ``1e-4`` of ``max |plain|``, as is the
block conv's weight gradient (K11).  The plan engine's kernels (K6-K8) and
the slot gather (K9) move values without arithmetic: they must be equal.
"""
import numpy as np
import pytest
import torch

from segdino3d_tpu_torch.models.backbone.res16unet import build_unet_plan
from segdino3d_tpu_torch.ops import block_dense as TBD
from segdino3d_tpu_torch.ops import hashing as TQ
from segdino3d_tpu_torch.ops import host_plan as TH
from segdino3d_tpu_torch.ops import scatter as TS
from segdino3d_tpu_torch.ops import sparse_conv as TSC
from segdino3d_tpu_torch.ops import voxelize as TV
from segdino3d_tpu_torch.ops.keys import SENTINEL

CAPS = [512, 256, 128, 64, 32]
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.fixture(scope="module")
def levels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return _plan_on("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gather_gemm_conv_k3", "gather_gemm_conv_k5",
                                    "gather_gemm_conv_down", "up_conv",
                                    "segment_mean_gather"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(levels, kernel, dtype):
    dt = getattr(torch, dtype)
    lv = levels.levels
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)

    if kernel.startswith("gather_gemm_conv"):
        nbr, valid, cin, cout = {
            "gather_gemm_conv_k3": (lv[0].nbr, lv[0].valid, 35, 40),
            "gather_gemm_conv_k5": (levels.stem_nbr, lv[0].valid, 70, 24),
            "gather_gemm_conv_down": (lv[0].child, lv[1].valid, 48, 72),
        }[kernel]
        x = randn(CAPS[0], cin)
        w = randn(nbr.shape[0], cin, cout, scale=(nbr.shape[0] * cin) ** -0.5)
        got = TSC.gather_conv(x, nbr, w, valid)
        want = TSC.gather_conv_plain(x, nbr, w, valid)
    elif kernel == "up_conv":
        x, w = randn(CAPS[1], 24), randn(8, 24, 70, scale=0.2)
        got = TSC.up_conv(x, lv[0], w)
        want = TSC.up_conv_plain(x, lv[0].parent, lv[0].kpos, w, lv[0].valid)
    else:
        g, d = randn(CAPS[0], 13), randn(700, 5)
        idx = torch.randint(-1, CAPS[0], (700,), generator=gen,
                            device="cuda", dtype=torch.int32)
        seg = torch.randint(0, 50, (700,), generator=gen, device="cuda",
                            dtype=torch.int32)
        valid = torch.rand(700, generator=gen, device="cuda") > 0.1
        got = TS.segment_mean_gather(seg, 40, valid, g=g, gather_idx=idx, d=d)
        want = TS.segment_mean_gather_plain(seg, 40, valid, g=g,
                                            gather_idx=idx, d=d)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gather_a", "mirror", "gather_b",
                                  "gather_a_rows"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wgrad_kernel_matches_plain(levels, form, dtype):
    dt = getattr(torch, dtype)
    lv = levels.levels
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    if form == "gather_a":       # subm: A = X through nbr, B = dY
        a, b, ia, ib, mirror = randn(CAPS[0], 40), randn(CAPS[0], 24), \
            lv[0].nbr, None, False
    elif form == "mirror":       # stem: the narrow side gathered, mirrored
        a, b, ia, ib, mirror = randn(CAPS[0], 70), randn(CAPS[0], 24), \
            None, levels.stem_nbr, True
    elif form == "gather_b":     # up: A = x_coarse, B = dF through child
        a, b, ia, ib, mirror = randn(CAPS[1], 72), randn(CAPS[0], 48), \
            None, lv[0].child, False
    else:                        # down: A = X_fine through child, B = dY
        a, b, ia, ib, mirror = randn(CAPS[0], 32), randn(CAPS[1], 32), \
            lv[0].child, None, False
    got = TSC.gather_wgrad(a, ia, b, ib, mirror=mirror)
    table = ia if ia is not None else ib
    want = TSC.gather_wgrad_plain(a, ia, b, ib, table.shape[0],
                                  table.shape[1], mirror)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got, want, rtol=0, atol=tol * scale)


@pytest.mark.cuda
def test_segment_grad_kernel_matches_plain(levels):
    gen = torch.Generator(device="cuda").manual_seed(2)
    n, v, s = 900, CAPS[0], 40
    inverse = torch.randint(-1, v, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
    seg = torch.randint(0, s + 3, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    valid = torch.rand(n, generator=gen, device="cuda") > 0.1
    g = torch.randn(s, 24, generator=gen, device="cuda")
    got = TS.segment_grad(g, seg, s, inverse, valid,
                          TS.segment_csr(inverse, v, valid))
    want = TS.segment_grad_plain(g, seg, s, inverse, valid, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["subm_k3", "stem_k5", "down", "up",
                                  "pool"])
def test_backward_on_card_matches_cpu(levels, case):
    """The same Function on the card (K1, K2, K4, K5) and on the CPU
    (plain versions): input and weight gradients."""
    lv = levels.levels
    gen = torch.Generator().manual_seed(3)
    if case == "pool":
        n = 700
        inverse = torch.randint(-1, CAPS[0], (n,), generator=gen,
                                dtype=torch.int32)
        seg = torch.randint(0, 50, (n,), generator=gen, dtype=torch.int32)
        valid = torch.rand(n, generator=gen) > 0.1
        q = torch.randn(n, 3, generator=gen)
        vox = torch.randn(CAPS[0], 24, generator=gen)
        dy = torch.randn(40, 24, generator=gen)
        grads = []
        for dev in ("cuda", "cpu"):
            x = vox.to(dev).requires_grad_()
            out = TS.pool_gathered(x, inverse.to(dev), [q.to(dev)],
                                   seg.to(dev), 40, valid.to(dev))[0]
            out.backward(dy.to(dev))
            grads.append([x.grad.cpu()])
    else:
        if case == "subm_k3":
            v_in, cin, cout, n_off = CAPS[0], 40, 24, 27
            fn = lambda x, w, p: TSC.subm_conv(x, p.levels[0].nbr, w,
                                               p.levels[0].valid)
        elif case == "stem_k5":
            v_in, cin, cout, n_off = CAPS[0], 70, 24, 125
            fn = lambda x, w, p: TSC.subm_conv(x, p.stem_nbr, w,
                                               p.levels[0].valid)
        elif case == "down":
            v_in, cin, cout, n_off = CAPS[0], 32, 48, 8
            fn = lambda x, w, p: TSC.down_conv(x, p.levels[0], p.levels[1], w)
        else:
            v_in, cin, cout, n_off = CAPS[1], 48, 32, 8
            fn = lambda x, w, p: TSC.up_conv(x, p.levels[0], w)
        x0 = torch.randn(v_in, cin, generator=gen)
        w0 = torch.randn(n_off, cin, cout, generator=gen) * cin ** -0.5
        cpu_plan = _plan_on("cpu")
        grads = []
        for dev, plan in (("cuda", levels), ("cpu", cpu_plan)):
            x = x0.to(dev).requires_grad_()
            w = w0.to(dev).requires_grad_()
            out = fn(x, w, plan)
            dy = torch.ones_like(out) * torch.linspace(
                -1, 1, out.shape[1], device=dev)
            out.backward(dy)
            grads.append([x.grad.cpu(), w.grad.cpu()])
    torch.cuda.synchronize()
    for got, want in zip(*grads, strict=True):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)


def _plan_on(device):
    rng = np.random.RandomState(3)
    coords = rng.uniform(0, 12, (600, 3)).astype(np.float32)
    plan = TH.build_host_plan(coords, np.zeros(600, np.int32),
                              np.ones(600, bool), CAPS)
    return TH.host_plan_to_device(plan, device)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [4096, 700])
def test_coord_hash_matches_plain(card, capacity):
    """K6 against its plain version: up to 8 rows per key, keys that collide
    in the table (capacity 700: ~600 distinct keys in 2,048 slots), misses
    and sentinel queries."""
    rng = np.random.RandomState(4)
    distinct = rng.choice(1 << 20, 600, replace=False).astype(np.int64)
    keys = np.repeat(distinct, rng.randint(1, 9, 600))
    rng.shuffle(keys)
    keys[rng.rand(len(keys)) < 0.05] = SENTINEL
    queries = np.concatenate([keys, rng.randint(0, 1 << 20, 500),
                              [SENTINEL]])
    key_t, q_t = (torch.from_numpy(a).to(card) for a in (keys, queries))
    h = TQ.build_hash(key_t, capacity)
    want_h = TQ.build_hash_plain(key_t, capacity)
    got = TQ.lookup_hash(h, q_t)
    want = TQ.lookup_hash_plain(want_h, q_t)
    torch.cuda.synchronize()
    assert h.keys.shape == (TQ.table_size(capacity),)
    assert bool(h.overflow) == bool(want_h.overflow) is False
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_coord_hash_overflow_flag(card):
    """A full table flags the keys it cannot place (plain: more distinct
    keys than slots)."""
    key = torch.arange(40, dtype=torch.int64, device=card) * 977
    assert bool(TQ.build_hash(key, 8).overflow)
    assert bool(TQ.build_hash_plain(key, 8).overflow)


def _border_points(rng, n=3000):
    """Points of two scenes with voxels at every field limit (x = 1023,
    y = 1023, z = 511 and 0), 1-8 points per voxel, and a few past them."""
    base = rng.randint(0, 40, (n // 4, 3)).astype(np.float32)
    base[:40, 0] = 1023
    base[40:80, 1] = 1023
    base[80:120, 2] = 511
    base[120:160] = 0
    base[160:170, 2] = 515                      # past z: dropped
    pts = np.repeat(base, 4, 0) + rng.uniform(0, 0.99, (len(base) * 4, 3))
    bidx = (np.arange(len(pts)) >= len(pts) // 2).astype(np.int32)
    return pts.astype(np.float32), bidx, rng.rand(len(pts)) > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("v_cap", [2048, 500])
def test_voxelize_and_pyramid_match_plain(card, v_cap):
    """K6 + K8 (voxelize, downsample) and K7 (neighbour tables, k3 and k5)
    on the card against the plain versions on the CPU; v_cap 500 is
    smaller than the scene's ~700 voxels (ids past it dropped)."""
    pts, bidx, valid = _border_points(np.random.RandomState(5))
    caps = [v_cap, 1024, 1024, 512, 256]
    out = {}
    for dev in (card, torch.device("cpu")):
        args = [torch.from_numpy(a).to(dev) for a in (bidx, pts, valid)]
        grid = TV.voxelize(*args, num_voxels_static=v_cap)
        plan, overflow = build_unet_plan(grid, 5, 5, caps)
        # the grid's hash maps each point's key to its voxel id
        ids = TQ.lookup_hash(grid.hash, TV.point_keys(*args)[1])
        out[dev.type] = (grid, plan, overflow, ids)
    torch.cuda.synchronize()
    (gg, gp, go, gi), (wg, wp, wo, wi) = out["cuda"], out["cpu"]
    assert bool(go) == bool(wo) is True          # points past z = 511
    assert int(gg.num_voxels) == int(wg.num_voxels)
    torch.testing.assert_close(gi.cpu(), wi, rtol=0, atol=0)
    for a, b in ((gg.inverse_mapping, wg.inverse_mapping),
                 (gg.coords_T, wg.coords_T), (gg.valid, wg.valid),
                 (gp.stem_nbr, wp.stem_nbr)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0)
    for a, b in zip(gp.levels, wp.levels, strict=True):
        for k in ("valid", "nbr", "parent", "kpos", "child", "up_order"):
            x, y = getattr(a, k), getattr(b, k)
            if y is None:
                assert x is None
            else:
                torch.testing.assert_close(x.cpu(), y, rtol=0, atol=0,
                                           msg=k)


@pytest.mark.cuda
def test_voxel_compact_leaves_its_hash(card):
    """K8 returns the remapped hash as a new table: two calls on one hash
    give the same voxel ids, and the hash still holds rows."""
    pts, bidx, valid = _border_points(np.random.RandomState(7))
    cols, key = TV.point_keys(*(torch.from_numpy(a).to(card)
                                for a in (bidx, pts, valid)))
    h = TQ.build_hash(key, key.shape[0])
    rows_before = h.vals.clone()
    winner = TQ.lookup_hash(h, key)
    first, second = (TV.voxel_compact(winner, cols, 4096, 0, h)
                     for _ in range(2))
    torch.cuda.synchronize()
    torch.testing.assert_close(h.vals, rows_before, rtol=0, atol=0)
    for c in (first, second):
        torch.testing.assert_close(TQ.lookup_hash(c.hash, key), c.inverse,
                                   rtol=0, atol=0)


@pytest.mark.cuda
def test_device_plan_matches_host_plan_on_card(card):
    rng = np.random.RandomState(6)
    coords = rng.uniform(0, 30, (5000, 3)).astype(np.float32)
    bidx = (np.arange(5000) >= 3000).astype(np.int32)
    valid = rng.rand(5000) > 0.05
    caps = [8192] * 5
    host = TH.host_plan_to_device(TH.build_host_plan(coords, bidx, valid,
                                                     caps), card)
    grid = TV.voxelize(torch.from_numpy(bidx).to(card),
                       torch.from_numpy(coords).to(card),
                       torch.from_numpy(valid).to(card), caps[0])
    dev, overflow = build_unet_plan(grid, 5, 5, caps)
    torch.cuda.synchronize()
    assert not bool(overflow)
    torch.testing.assert_close(dev.inverse, host.inverse, rtol=0, atol=0)
    torch.testing.assert_close(dev.stem_nbr, host.stem_nbr, rtol=0, atol=0)
    for a, b in zip(dev.levels, host.levels, strict=True):
        for k in ("valid", "nbr", "parent", "kpos", "child", "up_order"):
            x, y = getattr(a, k), getattr(b, k)
            if y is not None:
                torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)


def _block_plan_on(device, edges):
    rng = np.random.RandomState(8)
    coords = rng.uniform(0, 14, (700, 3)).astype(np.float32)
    plan = TH.build_host_plan(coords, np.zeros(700, np.int32),
                              np.ones(700, bool), CAPS, block_edges=edges)
    return TH.host_plan_to_device(plan, device)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [96, 259, 13])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_gather_matches_plain(card, channels, dtype):
    """K9 both ways through a level's tables: voxel rows -> dense rows
    (slot_vox) and back (vox_slot); rows of 16-byte multiples and not."""
    t = _block_plan_on(card, [4] * 5).blocks[0]
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(CAPS[0], channels, generator=gen, device="cuda").to(
        getattr(torch, dtype))
    dense = TBD.slot_gather(x, t.slot_vox)
    back = TBD.slot_gather(dense, t.vox_slot)
    torch.cuda.synchronize()
    torch.testing.assert_close(dense, TBD.slot_gather_plain(x, t.slot_vox),
                               rtol=0, atol=0)
    torch.testing.assert_close(back, TBD.slot_gather_plain(dense, t.vox_slot),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("edge,k", [(4, 3), (4, 5), (8, 3), (8, 5)])
@pytest.mark.parametrize("cout", [40, 96, 128])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_conv_matches_plain(card, edge, k, cout, masked, dtype):
    """K10 with and without the output mask; Cin 35 is no multiple of the
    kernel's 16-channel slices and Cout 40 none of its column tiles."""
    dt = getattr(torch, dtype)
    t = _block_plan_on(card, [edge] * 5).blocks[0]
    gen = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn(t.slot_vox.shape[0], 35, generator=gen, device="cuda")
    x = torch.where(TBD.occupancy(t)[:, None], x, 0.0).to(dt)
    w = (torch.randn(k ** 3, 35, cout, generator=gen, device="cuda")
         * (k ** 3 * 35) ** -0.5).to(dt)
    occ = TBD.occupancy(t) if masked else None
    got = TBD.block_conv(x, t.block_nbr, w, occ, edge)
    want = TBD.dense_subm_conv_plain(x, t.block_nbr, w, occ, edge)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("edge,k", [(4, 3), (4, 5), (8, 3)])
@pytest.mark.parametrize("cin,cout", [(35, 24), (96, 72)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_wgrad_matches_plain(card, edge, k, cin, cout, dtype):
    dt = getattr(torch, dtype)
    t = _block_plan_on(card, [edge] * 5).blocks[0]
    occ = TBD.occupancy(t)
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = t.slot_vox.shape[0]
    x = torch.randn(rows, cin, generator=gen, device="cuda").to(dt)
    dy = torch.randn(rows, cout, generator=gen, device="cuda").to(dt)
    got = TBD.block_wgrad(x, dy, t.block_nbr, occ, edge, k)
    want = TBD.block_wgrad_plain(x, dy, t.block_nbr, occ, edge, k)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got, want, rtol=0, atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5])
def test_dense_backward_on_card_matches_cpu(card, k):
    """The block-dense Functions on the card (K9-K11) and on the CPU (plain
    versions): enter, conv, exit; input and weight gradients."""
    gen = torch.Generator().manual_seed(12)
    x0 = torch.randn(CAPS[0], 24, generator=gen)
    w0 = torch.randn(k ** 3, 24, 40, generator=gen) * 24 ** -0.5
    grads = []
    for dev in ("cuda", "cpu"):
        t = _block_plan_on(dev, [4] * 5).blocks[0]
        x = x0.to(dev).requires_grad_()
        w = w0.to(dev).requires_grad_()
        dense = TBD.scatter_to_dense(x, t)
        out = TBD.gather_from_dense(
            TBD.dense_subm_conv(dense, TBD.occupancy(t), t, w), t)
        out.backward(torch.ones_like(out)
                     * torch.linspace(-1, 1, 40, device=dev))
        grads.append([x.grad.cpu(), w.grad.cpu()])
    torch.cuda.synchronize()
    for got, want in zip(*grads, strict=True):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)


def _compact_plan_on(device, slots):
    rng = np.random.RandomState(13)
    coords = rng.uniform(0, 12, (1500, 3)).astype(np.float32)
    plan = TH.build_host_plan(coords, np.zeros(1500, np.int32),
                              np.ones(1500, bool), CAPS, stem_compact=True,
                              stem_compact_slots=slots)
    return TH.host_plan_to_device(plan, device)


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [32, 40, 128])
@pytest.mark.parametrize("slots", [8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_slot_sum_matches_plain(card, dtype, slots, cout):
    """K12 against its plain version on a compacted-stem plan (D = 8 puts
    most pairs in the overflow, D = 32 few), then the whole compacted stem
    on the card against the CPU's plain version and the gather stem."""
    dt = getattr(torch, dtype)
    plan = _compact_plan_on("cuda", slots)
    slots_t, ov_src, ov_dst = plan.stem_compact
    assert int((ov_src >= 0).sum()) > 0
    valid = plan.levels[0].valid
    gen = torch.Generator(device="cuda").manual_seed(14)
    y2 = torch.randn(CAPS[0] * 125, cout, generator=gen, device="cuda").to(dt)
    got = TSC.stem_slot_sum(y2, slots_t, ov_src, ov_dst, valid)
    want = TSC.stem_slot_sum_plain(y2, slots_t, ov_src, ov_dst, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])

    x = torch.randn(CAPS[0], 19, generator=gen, device="cuda").to(dt)
    w = (torch.randn(125, 19, cout, generator=gen, device="cuda")
         * 0.1).to(dt)
    with torch.no_grad():
        card_out = TSC.stem_compact_conv(x, w, slots_t, ov_src, ov_dst, valid)
        cpu_out = TSC.stem_compact_conv(
            x.cpu(), w.cpu(), *(t.cpu() for t in plan.stem_compact),
            valid.cpu())
    torch.testing.assert_close(card_out.float().cpu(), cpu_out.float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
