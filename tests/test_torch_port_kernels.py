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
from segdino3d_tpu_torch.ops import keys as TK
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
                                    "up_conv_96", "up_conv_256",
                                    "up_conv_down_dx", "segment_mean_gather",
                                    "segment_mean_sources",
                                    "segment_mean_fp16_sources"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(levels, kernel, dtype):
    """Each forward kernel against its plain version; K2 and K3 also give
    bit-equal results in two calls.  K2 at Cout 70, 96 and 256 and as the
    down conv's dX (transposed W); K3 fused with a gather, and from two
    column sources (a column slice of (N, 6) points and (N, 256) 2D
    features in fp32 or fp16, each element rounded to the compute dtype)
    over segments of up to ~1,500 rows (many chunks), empty segments and
    invalid rows."""
    dt = getattr(torch, dtype)
    again = None
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
    elif kernel.startswith("up_conv"):
        cin, cout, fine = {"up_conv": (24, 70, 0), "up_conv_96": (96, 96, 0),
                           "up_conv_256": (256, 256, 1),
                           "up_conv_down_dx": (32, 48, 0)}[kernel]
        f = lv[fine]
        x = randn(CAPS[fine + 1], cin)
        w = randn(8, cin, cout, scale=cin ** -0.5)
        if kernel == "up_conv_down_dx":     # as _DownConv.backward calls it
            w = randn(8, cout, cin, scale=cin ** -0.5).transpose(1, 2) \
                .contiguous()
        got = TSC.up_conv(x, f, w)
        again = TSC.up_conv_rows(x, f.child, f.parent, f.kpos, w, f.valid)
        want = TSC.up_conv_plain(x, f.parent, f.kpos, w, f.valid)
    elif kernel != "segment_mean_gather":
        n, s = 3000, 40
        pts = torch.randn(n, 6, generator=gen, device="cuda")
        f2d = torch.randn(n, 256, generator=gen, device="cuda")
        if kernel == "segment_mean_fp16_sources":
            f2d = f2d.half()
        seg = torch.randint(0, s + 3, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        seg[torch.rand(n, generator=gen, device="cuda") < 0.5] = 3
        seg[seg == 9] = -1                  # segment 9 stays empty
        valid = torch.rand(n, generator=gen, device="cuda") > 0.1
        srcs = [pts[:, 3:], f2d]
        got = TS.segment_mean_gather(seg, s, valid, d=srcs, round_to=dt)
        again = TS.segment_mean_gather(seg, s, valid, d=srcs, round_to=dt)
        want = TS.segment_mean_gather_plain(seg, s, valid, d=srcs,
                                            round_to=dt)
        assert not got[9].any()
    else:
        g, d = randn(CAPS[0], 13), randn(700, 5)
        idx = torch.randint(-1, CAPS[0], (700,), generator=gen,
                            device="cuda", dtype=torch.int32)
        seg = torch.randint(0, 50, (700,), generator=gen, device="cuda",
                            dtype=torch.int32)
        valid = torch.rand(700, generator=gen, device="cuda") > 0.1
        got = TS.segment_mean_gather(seg, 40, valid, g=g, gather_idx=idx, d=d)
        again = TS.segment_mean_gather(seg, 40, valid, g=g, gather_idx=idx,
                                       d=d)
        want = TS.segment_mean_gather_plain(seg, 40, valid, g=g,
                                            gather_idx=idx, d=d)
    torch.cuda.synchronize()
    if again is not None:
        assert torch.equal(got, again)
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
@pytest.mark.parametrize("ids", ["int32", "int64", "int32_no_valid"])
def test_segment_csr_matches_cpu(card, ids):
    """K3's CSR on the card (its two launches around torch.sort) equals the
    CPU's: ids outside [0, S) and invalid rows dropped, members ascending
    in a segment, counters zero, and zero again after K3 has used them on
    segments of many chunks."""
    gen = torch.Generator().manual_seed(5)
    n, s = 5000, 60
    seg = torch.randint(-2, s + 3, (n,), generator=gen)
    seg[torch.rand(n, generator=gen) < 0.4] = 11      # ~63 chunks
    seg = seg.to(getattr(torch, ids.split("_")[0]))
    valid = None if ids.endswith("no_valid") else \
        torch.rand(n, generator=gen) > 0.1
    want = TS.segment_csr(seg, s, valid)
    got = TS.segment_csr(seg.to(card), s,
                         None if valid is None else valid.to(card))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    d = torch.randn(n, 7, generator=gen)
    mean = TS.segment_mean_gather(seg.to(card), s, None if valid is None
                                  else valid.to(card), d=d.to(card), csr=got)
    torch.cuda.synchronize()
    assert not got.counters.any()
    torch.testing.assert_close(mean.cpu(), TS.segment_mean_gather_plain(
        seg, s, valid, d=d), rtol=1e-4, atol=1e-4)


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
    ones = torch.arange(s + 1, dtype=torch.int64, device="cuda")  # counts 1
    got = TS.segment_grad(g, seg, s, ones, inverse, valid,
                          TS.segment_csr(inverse, v, valid))
    want = TS.segment_grad_plain(g, seg, s, ones, inverse, valid, v)
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
    h = TQ.build_and_lookup(key_t, capacity)[0]
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
    assert bool(TQ.build_and_lookup(key, 8)[0].overflow)
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
    h = TQ.build_and_lookup(key, key.shape[0])[0]
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


def _grid_tables(device):
    """BlockTables of 11 edge-4 blocks on a 3 x 2 x 2 grid of block
    positions, the sixth left out (its neighbours see -1)."""
    edge = 4
    dirs = TBD._shell_dirs()
    live = [p for i, p in enumerate(np.ndindex(3, 2, 2)) if i != 5]
    index = {p: i for i, p in enumerate(live)}
    nbr = np.full((26, len(live)), -1, np.int32)
    for i, p in enumerate(live):
        for d, (dx, dy, dz) in enumerate(dirs):
            nbr[d, i] = index.get((p[0] + dx, p[1] + dy, p[2] + dz), -1)
    rows = len(live) * edge ** 3
    return TBD.BlockTables(
        vox_slot=torch.zeros(0, dtype=torch.int32, device=device),
        block_nbr=torch.from_numpy(nbr).to(device),
        slot_vox=torch.full((rows,), -1, dtype=torch.int32, device=device),
        edge=edge)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full_block", "one_cell", "full_level"])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_conv_occupied_rows_match_plain(card, case, k, dtype):
    """K10's row list and tiles at the edges of the mask: a fully occupied
    block beside sparse ones, a block with one occupied cell, and a level
    whose every cell is occupied (the row list at its capacity).  Equal to
    the plain version on every cell, zero outside the mask."""
    dt = getattr(torch, dtype)
    t = _grid_tables(card)
    e3, n = t.edge ** 3, t.slot_vox.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(15)
    occ = torch.rand(n, generator=gen, device="cuda") < 0.2
    if case == "full_block":
        occ[:e3] = True
    elif case == "one_cell":
        occ[e3:2 * e3] = False
        occ[e3 + 21] = True
    else:
        occ[:] = True
    rows, count = TBD.occupied_rows(occ)
    want_rows, want_count = TBD.occupied_rows_plain(occ)
    torch.testing.assert_close(rows, want_rows, rtol=0, atol=0)
    assert int(count) == int(want_count) == int(occ.sum())
    x = torch.where(occ[:, None], torch.randn(n, 35, generator=gen,
                                              device="cuda"), 0.0).to(dt)
    w = (torch.randn(k ** 3, 35, 40, generator=gen, device="cuda")
         * (k ** 3 * 35) ** -0.5).to(dt)
    got = TBD.block_conv(x, t.block_nbr, w, occ, t.edge)
    want = TBD.dense_subm_conv_plain(x, t.block_nbr, w, occ, t.edge)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert not got[~occ].any()


@pytest.mark.cuda
@pytest.mark.parametrize("edge,k", [(4, 3), (4, 5), (8, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_conv_dx_role_under_the_dilation(card, edge, k, dtype):
    """The input gradient's role as the backward runs it: flipped,
    transposed weights on a cotangent that is zero outside the occupancy,
    computed on the occupancy's k-dilation only.  The dilation is not the
    whole grid; the result equals the unmasked plain version on every cell
    and is zero outside the dilation."""
    dt = getattr(torch, dtype)
    t = _block_plan_on(card, [edge] * 5).blocks[0]
    occ = TBD.occupancy(t)
    dil = TBD.dilated_rows(occ, t.block_nbr, edge, k)[0]
    torch.testing.assert_close(
        dil, TBD.occupancy_dilation_plain(occ, t.block_nbr, edge, k),
        rtol=0, atol=0)
    assert bool((dil & ~occ).any()) and not bool(dil.all())
    gen = torch.Generator(device="cuda").manual_seed(16)
    dy = torch.where(occ[:, None], torch.randn(occ.shape[0], 40,
                                               generator=gen, device="cuda"),
                     0.0).to(dt)
    w = (torch.randn(k ** 3, 35, 40, generator=gen, device="cuda")
         * (k ** 3 * 40) ** -0.5).to(dt)
    wt = TSC._transposed(w.flip(0))   # (k^3, 40, 35)
    got = TBD.block_conv(dy, t.block_nbr, wt, dil, edge)
    want = TBD.dense_subm_conv_plain(dy, t.block_nbr, wt, None, edge)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert not got[~dil].any() and not want[~dil].any()


def _compaction_equal(got, want):
    for a, b in ((got.inverse, want.inverse), (got.coords_T, want.coords_T),
                 (got.valid, want.valid), (got.hash.vals, want.hash.vals),
                 (got.num_voxels, want.num_voxels)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (got.kpos is None) == (want.kpos is None)
    if want.kpos is not None:
        torch.testing.assert_close(got.kpos, want.kpos, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,cap", [(3001, 4096), (300000, 65536),
                                   (300000, 2000)])
@pytest.mark.parametrize("shift", [0, 1])
def test_voxel_compact_matches_plain(card, n, cap, shift):
    """K8 on the same winners and hash as its plain version: n no multiple
    of its 1,024-row blocks; 293 blocks, more than the card's SMs; and a
    count past the capacity (ids dropped).  Every output equal."""
    rng = np.random.RandomState(17)
    cols = np.stack([rng.randint(0, 2, n), rng.randint(0, 90, n),
                     rng.randint(0, 90, n), rng.randint(0, 40, n)])
    cols_t = torch.from_numpy(cols.astype(np.int32)).to(card).contiguous()
    valid = torch.from_numpy(rng.rand(n) > 0.05).to(card)
    key = TK.pack_columns_u32(*cols_t, valid)
    h = TQ.build_and_lookup(key, n)[0]
    winner = TQ.lookup_hash(h, key)
    got = TV.voxel_compact(winner, cols_t, cap, shift, h, shift == 1)
    want = TV.voxel_compact_plain(winner, cols_t, cap, shift, h, shift == 1)
    torch.cuda.synchronize()
    if cap == 2000:
        assert int(want.num_voxels) > cap
    _compaction_equal(got, want)


def _run_table(rng, n_off, rows, src_rows, live_share=0.5):
    """(n_off, rows) int32 index table whose live entries come in runs
    (mean length ~50), so that split boundaries cut runs of pairs."""
    flips = rng.rand(n_off, rows) < 1.0 / 50
    live = (np.cumsum(flips, axis=1) % 2 == 0) & \
        (rng.rand(n_off, 1) < 2 * live_share)
    return np.where(live, rng.randint(0, src_rows, (n_off, rows)),
                    -1).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["runs", "two_splits", "dead_offset",
                                  "all_live", "stem_259"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wgrad_pair_list_kernel_matches_plain(card, monkeypatch, case, dtype):
    """K4 over its compacted pair list: runs of live rows cut by split
    boundaries (several splits, or a scratch of two splits so that each
    split holds thousands of pairs), an offset with no live pair, a table
    with every pair live (the list at its capacity), and the stem's
    259 -> 32 at k5, mirrored.  The list equals its plain version, dW its
    plain version over the full table, and two calls are bit-equal."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(18)
    rows, n_off, cin, cout, mirror = 6000, 27, 40, 72, False
    if case == "stem_259":
        n_off, cin, cout, mirror = 125, 259, 32, True
    if case == "two_splits":
        per_split = n_off * cin * cout * 4
        monkeypatch.setattr(TSC, "WGRAD_SCRATCH_BYTES", 2 * per_split)
    table = _run_table(rng, n_off, rows, rows)
    if case == "dead_offset":
        table[[0, 13]] = -1
    if case == "all_live":
        table = rng.randint(0, rows, (n_off, rows)).astype(np.int32)
    ib = torch.from_numpy(table).to(card)
    gen = torch.Generator(device="cuda").manual_seed(19)
    a = torch.randn(rows, cin, generator=gen, device="cuda").to(dt)
    b = torch.randn(rows, cout, generator=gen, device="cuda").to(dt)
    pairs = TSC.gather_pairs(None, ib)
    want_pairs = TSC.gather_pairs_plain(None, ib)
    torch.testing.assert_close(pairs.counts, want_pairs.counts, rtol=0,
                               atol=0)
    live = torch.arange(rows, device="cuda")[None, :] < pairs.counts[:, None]
    torch.testing.assert_close(torch.where(live, pairs.rows, -1),
                               want_pairs.rows, rtol=0, atol=0)
    got = TSC.gather_wgrad(a, None, b, ib, mirror=mirror)
    again = TSC.gather_wgrad(a, None, b, ib, mirror=mirror)
    want = TSC.gather_wgrad_plain(a, None, b, ib, n_off, rows, mirror)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if case == "dead_offset":
        assert not got[n_off - 1 if mirror else 0].any()
    scale = float(want.abs().max())
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got, want, rtol=0, atol=tol * scale)


def _box_tables(device, shape, skip=None):
    """BlockTables of edge-4 blocks at every position of a ``shape`` grid
    but ``skip`` (its neighbours see -1)."""
    edge = 4
    dirs = TBD._shell_dirs()
    live = [p for i, p in enumerate(np.ndindex(*shape)) if i != skip]
    index = {p: i for i, p in enumerate(live)}
    nbr = np.full((26, len(live)), -1, np.int32)
    for i, p in enumerate(live):
        for d, (dx, dy, dz) in enumerate(dirs):
            nbr[d, i] = index.get((p[0] + dx, p[1] + dy, p[2] + dz), -1)
    rows = len(live) * edge ** 3
    return TBD.BlockTables(
        vox_slot=torch.zeros(0, dtype=torch.int32, device=device),
        block_nbr=torch.from_numpy(nbr).to(device),
        slot_vox=torch.full((rows,), -1, dtype=torch.int32, device=device),
        edge=edge)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full_block", "one_cell", "full_level",
                                  "splits", "stem_259"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_wgrad_row_list_matches_plain(card, case, dtype):
    """K11 over the level's cached occupied-row list: a fully occupied
    block beside sparse ones, a block with one occupied cell, a level whose
    every cell is occupied (the list at its capacity), a grid of 216 blocks
    whose thousands of rows run over several splits, and the dense stem's
    259 -> 32 at k5.  The list equals ``occupied_rows_plain``, dW the plain
    version, and two calls are bit-equal."""
    dt = getattr(torch, dtype)
    t = _box_tables(card, (6, 6, 6) if case == "splits" else (3, 2, 2),
                    skip=5)
    e3, n = t.edge ** 3, t.slot_vox.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(20)
    occ = torch.rand(n, generator=gen, device="cuda") < 0.3
    if case == "full_block":
        occ[:e3] = True
    elif case == "one_cell":
        occ[e3:2 * e3] = False
        occ[e3 + 21] = True
    elif case == "full_level":
        occ[:] = True
    k, cin, cout = (5, 259, 32) if case == "stem_259" else (3, 35, 72)
    rows = TBD.row_list(t, occ)
    assert TBD.row_list(t, occ) is rows
    want_rows, want_count = TBD.occupied_rows_plain(occ)
    assert int(rows.count) == int(want_count)
    torch.testing.assert_close(rows.rows[:int(want_count)],
                               want_rows[:int(want_count)], rtol=0, atol=0)
    x = torch.randn(n, cin, generator=gen, device="cuda").to(dt)
    dy = torch.where(occ[:, None], torch.randn(n, cout, generator=gen,
                                               device="cuda"), 0.0).to(dt)
    got = TBD.block_wgrad(x, dy, t.block_nbr, occ, t.edge, k, rows)
    again = TBD.block_wgrad(x, dy, t.block_nbr, occ, t.edge, k, rows)
    want = TBD.block_wgrad_plain(x, dy, t.block_nbr, occ, t.edge, k)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    scale = float(want.abs().max())
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got, want, rtol=0, atol=tol * scale)


def _conv_case(rng, case):
    """(nbr (n_off, V), valid (V,), input rows, Cin, Cout) of a K1 case on
    random tables: rows with holes in ``valid``, a few live entries per
    row unless the case says otherwise."""
    n_off, v, src_rows, cin, cout, share = 27, 700, 700, 40, 72, 0.4
    if case == "stem_all_live":
        n_off, cin, cout, share = 125, 259, 32, 1.0
    elif case == "small_level":
        v = src_rows = 290
        cin, cout = 256, 256
    elif case == "wide_bn64":
        v = src_rows = 40000
        cin, cout = 128, 128
    elif case == "wide_bn96":
        v = src_rows = 40000
        cin = cout = 96
    elif case == "empty_table":
        v = 0
    elif case == "all_live":
        share = 1.0
    live = rng.rand(n_off, v) < share
    nbr = np.where(live, rng.randint(0, src_rows, (n_off, v)), -1)
    valid = rng.rand(v) < 0.9
    if case == "one_live_row":
        nbr[:] = -1
        nbr[[3, 13, 20], 70] = [5, 70, 600]
        valid[:] = True
    elif case == "dead_offset":
        nbr[[0, 13]] = -1
    elif case == "no_valid_row":
        valid[:] = False
    return (nbr.astype(np.int32), valid, src_rows, cin, cout)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_live_row", "dead_offset", "all_live",
                                  "stem_all_live", "empty_table",
                                  "no_valid_row", "small_level",
                                  "wide_bn64", "wide_bn96"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_conv_tiles_match_plain(card, case, dtype):
    """K1 on tables that reach each part of its schedule: offsets with one
    live pair, offsets with none, every pair live (64-pair items whose
    source rows repeat; the stem's 259 -> 32, Cin breaking 16-byte
    copies), an empty table, a mask with no row (pairs computed, rows
    zero), a 290-row level 256 -> 256 (a few hundred items, four column
    tiles each), and levels of 40,000 rows (64- and 96-column tiles).
    Equal to the plain version at the tolerance, zero outside the mask,
    and two calls bit-equal."""
    dt = getattr(torch, dtype)
    nbr, valid, src_rows, cin, cout = _conv_case(np.random.RandomState(21),
                                                 case)
    nbr = torch.from_numpy(nbr).to(card)
    valid = torch.from_numpy(valid).to(card)
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = torch.randn(src_rows, cin, generator=gen, device="cuda").to(dt)
    w = (torch.randn(nbr.shape[0], cin, cout, generator=gen, device="cuda")
         * (nbr.shape[0] * cin) ** -0.5).to(dt)
    got = TSC.gather_conv(x, nbr, w, valid)
    again = TSC.gather_conv(x, nbr, w, valid)
    want = TSC.gather_conv_plain(x, nbr, w, valid)
    torch.cuda.synchronize()
    assert got.shape == (nbr.shape[1], cout)
    assert torch.equal(got, again)
    assert not got[~valid].float().any()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("role", ["stem", "k3", "k3_dx", "down", "up_dx"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_conv_roles_match_plain(levels, role, dtype):
    """K1 in every role of the main path on a small plan's tables: the k5
    stem 259 -> 32, a k3 conv and its dX (flipped, transposed weights), a
    down conv over the child table and an up conv's dX over it (every
    coarse row valid).  Equal to the plain version, and two calls
    bit-equal."""
    dt = getattr(torch, dtype)
    lv = levels.levels
    gen = torch.Generator(device="cuda").manual_seed(23)
    every = torch.ones(CAPS[1], dtype=torch.bool, device="cuda")
    nbr, valid, rows, cin, cout = {
        "stem": (levels.stem_nbr, lv[0].valid, CAPS[0], 259, 32),
        "k3": (lv[2].nbr, lv[2].valid, CAPS[2], 64, 128),
        "k3_dx": (lv[2].nbr, lv[2].valid, CAPS[2], 128, 64),
        "down": (lv[0].child, lv[1].valid, CAPS[0], 32, 64),
        "up_dx": (lv[0].child, every, CAPS[0], 96, 96),
    }[role]
    x = torch.randn(rows, cin, generator=gen, device="cuda").to(dt)
    w = (torch.randn(nbr.shape[0], cin, cout, generator=gen, device="cuda")
         * (nbr.shape[0] * cin) ** -0.5).to(dt)
    if role == "k3_dx":   # the forward's (27, 64, 128) weights, mirrored
        w = w.reshape(-1, cout, cin).flip(0).transpose(1, 2).contiguous()
    got = TSC.gather_conv(x, nbr, w, valid)
    again = TSC.gather_conv(x, nbr, w, valid)
    want = TSC.gather_conv_plain(x, nbr, w, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("v_cap", [2048, 500])
@pytest.mark.parametrize("stem_kernel", [3, 5])
def test_neighbor_tables_match_plain(card, v_cap, stem_kernel):
    """K7's one launch over a whole pyramid (half the offsets probed, the
    rest mirrored, level 0's k3 table from a k5 stem's probes) against
    ``neighbor_table_plain`` one table at a time, on the border scene, with
    ids past the cap dropped at v_cap 500; and K7 for one table."""
    pts, bidx, valid = _border_points(np.random.RandomState(5))
    caps = [v_cap, 1024, 1024, 512, 256]
    pyramids = {}
    for dev in (card, torch.device("cpu")):
        args = [torch.from_numpy(a).to(dev) for a in (bidx, pts, valid)]
        grid = TV.voxelize(*args, num_voxels_static=v_cap)
        pyramids[dev.type] = TSC.build_conv_plan(grid, 5, caps)
    before = TSC.neighbor_tables.launches
    k3, stem = TSC.neighbor_tables(pyramids["cuda"], stem_kernel)
    again = TSC.neighbor_tables(pyramids["cuda"], stem_kernel)[1]
    one = TSC.neighbor_table(pyramids["cuda"][1], 5)
    torch.cuda.synchronize()
    assert TSC.neighbor_tables.launches == before + 2
    plain = pyramids["cpu"]
    for lv, t in zip(plain, k3, strict=True):
        torch.testing.assert_close(t.cpu(), TSC.neighbor_table_plain(
            lv.coords_T, lv.num_voxels, 3), rtol=0, atol=0)
    want = TSC.neighbor_table_plain(plain[0].coords_T, plain[0].num_voxels,
                                    stem_kernel)
    torch.testing.assert_close(stem.cpu(), want, rtol=0, atol=0)
    torch.testing.assert_close(again.cpu(), want, rtol=0, atol=0)
    torch.testing.assert_close(one.cpu(), TSC.neighbor_table_plain(
        plain[1].coords_T, plain[1].num_voxels, 5), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case,edge,k", [
    ("plan", 4, 3), ("plan", 4, 5), ("plan", 8, 3), ("plan", 8, 5),
    ("full_level", 4, 3), ("full_level", 4, 5)])
def test_dilated_rows_match_plain(card, case, edge, k):
    """``block_dilate`` in one pass (the mask and the list pass's counts),
    then the list pass: the mask equals the plain dilation and the list
    its occupied rows, on a plan's level 0 and on a grid of edge-4 blocks
    whose every cell is occupied (the list at its capacity)."""
    if case == "full_level":
        t = _grid_tables(card)
        occ = torch.ones(t.slot_vox.shape[0], dtype=torch.bool, device=card)
    else:
        t = _block_plan_on(card, [edge] * 5).blocks[0]
        occ = TBD.occupancy(t)
    mask, rows = TBD.dilated_rows(occ, t.block_nbr, t.edge, k)
    torch.cuda.synchronize()
    want = TBD.occupancy_dilation_plain(occ.cpu(), t.block_nbr.cpu(), t.edge,
                                        k)
    torch.testing.assert_close(mask.cpu(), want, rtol=0, atol=0)
    want_rows, count = TBD.occupied_rows_plain(want)
    n = int(count)
    assert int(rows.count) == n
    torch.testing.assert_close(rows.rows[:n].cpu(), want_rows[:n], rtol=0,
                               atol=0)
    assert int(rows.ws[occ.shape[0] + 1]) == 0       # the ticket


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_conv_on_cached_lists(card, dtype):
    """K10 on a level's cached lists, as the autograd Function runs it:
    two dX calls in a row on one dilation list, bit-equal to each other
    and to the per-call path (which builds its own list); forward calls on
    the occupancy list before and after K11 reduces over the same list.
    Every call leaves the list's ticket at 0, so no later call skips a
    tile."""
    dt = getattr(torch, dtype)
    t = _block_plan_on(card, [4] * 5).blocks[0]
    occ = TBD.occupancy(t)
    n = occ.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(17)
    dy = torch.where(occ[:, None], torch.randn(n, 40, generator=gen,
                                               device="cuda"), 0.0).to(dt)
    w = (torch.randn(27, 35, 40, generator=gen, device="cuda")
         * (27 * 40) ** -0.5).to(dt)
    wt = TSC._transposed(w.flip(0))
    mask, rows = TBD.dilation(t, occ, 3)
    assert TBD.dilation(t, occ, 3)[1] is rows
    first = TBD.block_conv(dy, t.block_nbr, wt, mask, t.edge, rows)
    second = TBD.block_conv(dy, t.block_nbr, wt, mask, t.edge, rows)
    per_call = TBD.block_conv(dy, t.block_nbr, wt, mask, t.edge)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, per_call)
    assert int(rows.ws[n + 1]) == 0
    tol = TOL[dtype]
    torch.testing.assert_close(
        first.float(), TBD.dense_subm_conv_plain(dy, t.block_nbr, wt, None,
                                                 t.edge).float(),
        rtol=tol, atol=tol)
    x = torch.where(occ[:, None], torch.randn(n, 35, generator=gen,
                                              device="cuda"), 0.0).to(dt)
    occ_rows = TBD.row_list(t, occ)
    fwd = TBD.block_conv(x, t.block_nbr, w, occ, t.edge, occ_rows)
    TBD.block_wgrad(x, dy, t.block_nbr, occ, t.edge, 3, occ_rows)
    fwd2 = TBD.block_conv(x, t.block_nbr, w, occ, t.edge, occ_rows)
    torch.cuda.synchronize()
    assert torch.equal(fwd, fwd2) and int(occ_rows.ws[n + 1]) == 0
    assert torch.equal(fwd, TBD.block_conv(x, t.block_nbr, w, occ, t.edge))
    t.dilations.clear()
    t.rows = None


# the main path's hash sizes: (keys, capacity) of level 0's points and of
# each downsample's voxels, tables of 2^18, 2^17, 2^15, 2^14 and 2^13 slots
HASH_LEVELS = [(120000, 120000), (92160, 36864), (36864, 13824),
               (13824, 5530), (5530, 2304)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,capacity", HASH_LEVELS)
def test_build_and_lookup_matches_plain(card, n, capacity):
    """K6's one launch at each level's table size: the winners, a lookup of
    the same keys and of misses in the table it built, the overflow
    flag."""
    rng = np.random.RandomState(n)
    distinct = rng.choice(1 << 28, capacity, replace=False).astype(np.int64)
    keys = distinct[rng.randint(0, capacity, n)]
    keys[rng.rand(n) < 0.03] = SENTINEL
    misses = rng.randint(1 << 28, 1 << 29, 1000)
    key_t = torch.from_numpy(keys).to(card)
    q_t = torch.from_numpy(np.concatenate([keys, misses])).to(card)
    before = TQ.build_and_lookup.launches
    h, winner = TQ.build_and_lookup(key_t, capacity)
    want_h, want = TQ.build_and_lookup_plain(key_t, capacity)
    got_q = TQ.lookup_hash(h, q_t)
    torch.cuda.synchronize()
    assert TQ.build_and_lookup.launches == before + 1
    assert h.keys.shape == (TQ.table_size(capacity),)
    assert bool(h.overflow) == bool(want_h.overflow) is False
    torch.testing.assert_close(winner, want, rtol=0, atol=0)
    torch.testing.assert_close(got_q, TQ.lookup_hash_plain(want_h, q_t),
                               rtol=0, atol=0)
    again = TQ.build_and_lookup(key_t, capacity)[1]
    assert torch.equal(again, winner)


@pytest.mark.cuda
def test_build_and_lookup_full_table(card):
    """More distinct keys than slots: the flag rises, every slot is taken,
    a placed key maps to its smallest row and the rest to -1."""
    key = torch.arange(40, dtype=torch.int64, device=card).repeat(2) * 977
    h, winner = TQ.build_and_lookup(key, 8)
    want = TQ.lookup_hash_plain(TQ.build_hash_plain(key, 8), key)
    torch.cuda.synchronize()
    assert bool(h.overflow)
    placed = winner >= 0
    assert int((h.keys != -1).sum()) == 16
    assert torch.equal(winner[placed], want[placed])
    assert int(torch.unique(key[placed]).numel()) == 16


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 1])
def test_voxel_compact_remapped_slots_match_plain(card, shift):
    """K8's remapped table after the one-launch build: the input's keys,
    each value the voxel id the plain version gives; the input table
    unchanged; K7's tables on the remapped tables equal the plain
    version's."""
    pts, bidx, valid = _border_points(np.random.RandomState(11))
    args = [torch.from_numpy(a).to(card) for a in (bidx, pts, valid)]
    cols, key = TV.point_keys(*args)
    if shift == 1:
        grid = TV.voxelize(*args, num_voxels_static=2048)
        cols = grid.coords_T
        b, x, y, z = cols
        key = TK.pack_columns_u32(b, x >> 1, y >> 1, z >> 1, grid.valid)
    h, winner = TQ.build_and_lookup(key, key.shape[0])
    keys_before, vals_before = h.keys.clone(), h.vals.clone()
    got = TV.voxel_compact(winner, cols, 1024, shift, h, shift == 1)
    want = TV.voxel_compact_plain(winner, cols, 1024, shift, h, shift == 1)
    torch.cuda.synchronize()
    assert got.hash.keys is h.keys
    assert got.hash.vals.data_ptr() != h.vals.data_ptr()
    _compaction_equal(got, want)
    torch.testing.assert_close(got.hash.keys, h.keys, rtol=0, atol=0)
    torch.testing.assert_close(h.keys, keys_before, rtol=0, atol=0)
    torch.testing.assert_close(h.vals, vals_before, rtol=0, atol=0)
    lv = TSC.PlanLevel(coords_T=got.coords_T, valid=got.valid,
                       hash=got.hash, num_voxels=got.num_voxels,
                       overflow=got.hash.overflow)
    for k in (3, 5):
        torch.testing.assert_close(
            TSC.neighbor_table(lv, k).cpu(),
            TSC.neighbor_table_plain(got.coords_T.cpu(),
                                     got.num_voxels.cpu(), k),
            rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_backward_is_one_launch(card, dtype):
    """The pool's backward on the card (K5 with the count division inside,
    reading the voxel columns of the (S, 102) gradient in place) against
    the same Function on the CPU; one K5 launch a backward, two backwards
    bit-equal."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(12)
    n, v, s = 6000, 1200, 90
    inverse = torch.randint(-1, v, (n,), generator=gen, dtype=torch.int32)
    inverse[:300] = 5                               # a voxel of 300 points
    seg = torch.randint(0, s, (n,), generator=gen, dtype=torch.int32)
    valid = torch.rand(n, generator=gen) > 0.1
    q = [torch.randn(n, 3, generator=gen) for _ in range(2)]
    vox = torch.randn(v, 96, generator=gen).to(dt)
    dy = torch.randn(s, 96, generator=gen)
    grads = {}
    for dev in ("cuda", "cpu"):
        runs = []
        for _ in range(2 if dev == "cuda" else 1):
            x = vox.to(dev).requires_grad_()
            out = TS.pool_gathered(x, inverse.to(dev), [a.to(dev) for a in q],
                                   seg.to(dev), s, valid.to(dev))
            before = TS.segment_grad.launches
            out[0].float().backward(dy.to(dev))
            if dev == "cuda":
                assert TS.segment_grad.launches == before + 1
            runs.append(x.grad)
        grads[dev] = runs
    torch.cuda.synchronize()
    first, second = grads["cuda"]
    assert first.dtype == dt and torch.equal(first, second)
    tol = TOL[dtype]
    torch.testing.assert_close(first.float().cpu(), grads["cpu"][0].float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [96, 24, 13, 600])
def test_segment_grad_division_matches_plain(levels, cols):
    """K5 with the superpoint counts, g a column slice of a wider gradient
    (row strides of 16, 8 and 4 bytes' alignment), column counts that do
    and do not divide by 4, and more columns than one pass of 32 lanes."""
    gen = torch.Generator(device="cuda").manual_seed(cols)
    n, v, s = 2000, CAPS[0], 40
    inverse = torch.randint(-1, v, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
    seg = torch.randint(-2, s + 2, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    valid = torch.rand(n, generator=gen, device="cuda") > 0.1
    vox = TS.segment_csr(inverse, v, valid)
    sp = TS.segment_csr(seg, s, valid).offsets
    for extra in (0, 2, 3):
        g = torch.randn(s, cols + extra, generator=gen,
                        device="cuda")[:, :cols]
        got = TS.segment_grad(g, seg, s, sp, inverse, valid, vox)
        want = TS.segment_grad_plain(g, seg, s, sp, inverse, valid, v)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, TS.segment_grad(g, seg, s, sp, inverse,
                                                valid, vox))
