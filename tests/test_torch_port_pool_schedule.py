"""The schedules of K3 (``csrc/segment_mean_gather.cu``) and K2
(``csrc/up_conv.cu``) in plain PyTorch, on the CPU.

K3 runs one launch a call: a work item is one 32-member block of the
CSR's member array, whose segments' runs it writes as it walks them (a
segment within the block its mean, a longer one a partial row, its chunk);
the item whose arrival completes a segment adds its partials in chunk
order; further items zero the empty segments.  The
columns come from a list of sources read where they lie, each element
rounded to the compute dtype first.  K2 multiplies the child table's pair
list in items of 64 pairs of one slot and stores each product straight
into its fine row; the rows with no pair are written 0.  Here:

* a model of K3's schedule (items taken in a shuffled order) against
  ``segment_mean_gather_plain`` at 1e-6 x max|plain| and against the JAX
  package's ``segment_mean`` / ``segment_mean_stack`` + ``devoxelize`` at
  1e-5 x max, with a superpoint of several thousand points, empty
  segments, ids outside [0, S), invalid rows and gather indices of -1, and
  2D features in fp32, fp16 and bf16 rounded to fp32 or bf16;
* the backbone wrapper's voxel mean from its two column sources against
  the JAX wrapper's concatenated ``feats`` path on a small scene;
* a model of K2's direct-store items, as the up conv and as the down
  conv's dX, on a small host plan and a small device plan, against
  ``up_conv_plain`` (1e-6 x max) and JAX ``up_conv`` / the ``jax.vjp`` of
  ``down_conv`` (1e-5 x max), and the child table holding every live fine
  row once and no other row.
"""
import bisect
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
from segdino3d_tpu.ops import sparse_conv as JSC  # noqa: E402
from segdino3d_tpu.ops.host_plan import \
    build_host_plan as jax_build_host_plan  # noqa: E402
from segdino3d_tpu.ops.host_plan import host_plan_to_device  # noqa: E402
from segdino3d_tpu.ops.voxelize import devoxelize as jax_devoxelize  # noqa: E402
from segdino3d_tpu_torch.models.backbone.res16unet import build_unet_plan  # noqa: E402
from segdino3d_tpu_torch.ops import host_plan as TH  # noqa: E402
from segdino3d_tpu_torch.ops import scatter as TS  # noqa: E402
from segdino3d_tpu_torch.ops import sparse_conv as TSC  # noqa: E402
from segdino3d_tpu_torch.ops import voxelize as TV  # noqa: E402

REL_PLAIN, REL_JAX = 1e-6, 1e-5
CHUNK, ITEM_PAIRS, BK = 32, 64, 32
CAPS = [1024, 512, 256, 128, 64]
DTYPES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _setup():
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * scale, err_msg=what)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def k3_model(seg_ids, num_segments, valid, g=None, gather_idx=None, d=(),
             round_to=None, seed=0):
    """K3 as the kernel schedules it, in fp32: (S, ctot) means, and the
    arrival counters it leaves.  A work item is one 32-member block k of
    the CSR's member array: it walks its members in order and writes each
    segment's run at the run's end, the mean of a segment within the block,
    else a partial row (slot 2 k + 1 if the segment goes on past the block,
    else 2 k); the item that completes a segment's arrivals adds its
    partials in chunk order.  Further items zero the empty segments."""
    cols = []
    if g is not None:
        gf = g.float()
        rows = gf if gather_idx is None else torch.where(
            (gather_idx >= 0)[:, None], gf[gather_idx.clamp(min=0).long()],
            0.0)
        cols.append(rows)
    cols += [(x if round_to is None else x.to(round_to)).float() for x in d]
    x = torch.cat(cols, 1)
    n, ctot = x.shape
    csr = TS.segment_csr(seg_ids, num_segments, valid)
    off, keys = csr.offsets.tolist(), csr.sorted_ids.tolist()
    members = csr.members.tolist()
    n_blocks = -(-n // CHUNK)
    out = torch.full((num_segments, ctot), float("nan"))
    partial = torch.full((2 * n_blocks, ctot), float("nan"))
    counters = [0] * num_segments
    covered = np.zeros(off[-1], int)

    def slot(k, e0):
        return 2 * k + (1 if e0 > (k + 1) * CHUNK else 0)

    def arrive(s):
        b0, e0 = off[s], off[s + 1]
        n_chunks = (e0 - 1) // CHUNK - b0 // CHUNK + 1
        counters[s] += 1
        if counters[s] < n_chunks:
            return
        acc = torch.zeros(ctot)
        for j in range(n_chunks):
            acc = acc + partial[slot(b0 // CHUNK + j, e0)]
        out[s] = acc / (e0 - b0)
        counters[s] = 0

    items = np.random.RandomState(seed).permutation(
        n_blocks + -(-num_segments // 32))
    for item in items.tolist():
        if item >= n_blocks:                 # zero rows of empty segments
            for s in range((item - n_blocks) * 32,
                           min(num_segments, (item - n_blocks + 1) * 32)):
                if off[s] == off[s + 1]:
                    out[s] = 0.0
            continue
        base = item * CHUNK
        if base >= off[-1]:
            continue
        end = min(base + CHUNK, off[-1])
        acc = torch.zeros(ctot)
        for q in range(base, end):
            acc = acc + x[members[q]]
            covered[q] += 1
            s = keys[q]
            if q + 1 < end and keys[q + 1] == s:
                continue
            b0, e0 = off[s], off[s + 1]
            if b0 >= base and e0 <= base + CHUNK:
                out[s] = acc / (e0 - b0)
            else:
                partial[slot(item, e0)] = acc
            acc = torch.zeros(ctot)
        first, last = keys[base], keys[end - 1]
        if off[first] < base or off[first + 1] > base + CHUNK:
            arrive(first)
        if last != first and off[last + 1] > base + CHUNK:
            arrive(last)
    assert (covered == 1).all(), "a member read twice or never"
    assert not torch.isnan(out).any(), "an output row never written"
    return out, counters


def _segments(n=6000, s=48, seed=3):
    """Segment ids with a superpoint of 3,000 points, empty segments, ids
    -1 and >= S, and invalid rows."""
    rng = np.random.RandomState(seed)
    seg = rng.randint(0, s, n).astype(np.int32)
    seg[rng.rand(n) < 0.5] = 5                        # ~3,000 points
    seg[(seg == 7) | (seg == 8)] = s + 2              # 7, 8 stay empty
    seg[rng.rand(n) < 0.02] = -1
    valid = rng.rand(n) > 0.1
    assert (seg == 5).sum() > 2500
    return rng, seg, valid, s


def _jax_ids(seg, s):
    """The ids as JAX's callers pass them: JAX clips a negative id to
    segment 0, so its callers map a dropped row to the sentinel S, which
    the port's K3 does for every id outside [0, S)."""
    return jnp.asarray(np.where(seg < 0, s, seg))


def test_segment_csr_chunks():
    _, seg, valid, s = _segments()
    csr = TS.segment_csr(torch.from_numpy(seg), s, torch.from_numpy(valid))
    kept = valid & (seg >= 0) & (seg < s)
    counts = np.bincount(seg[kept], minlength=s)
    assert csr.offsets.tolist() == [0] + np.cumsum(counts).tolist()
    for i in range(s):
        m = csr.members[csr.offsets[i]:csr.offsets[i + 1]].numpy()
        assert np.array_equal(m, np.nonzero(kept & (seg == i))[0]), i
    assert torch.equal(csr.sorted_ids, torch.from_numpy(np.sort(
        np.where(kept, seg, s)).astype(np.int32)))
    # the big segment spans ~90 of the member array's 32-member blocks
    b0, e0 = int(csr.offsets[5]), int(csr.offsets[6])
    assert -(-e0 // CHUNK) - b0 // CHUNK > 80
    assert csr.members.shape[0] == seg.shape[0]
    assert not csr.counters.any() and csr.counters.dtype == torch.int32


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("feat_dtype", ["float32", "float16", "bfloat16"])
def test_voxel_mean_model(feat_dtype, compute):
    """The voxel mean's two sources: the colour columns 3:6 of the (N, 6)
    points, read in place, and the 2D features in their own dtype."""
    rng, seg, valid, s = _segments()
    n = seg.shape[0]
    pts = rng.randn(n, 6).astype(np.float32)
    f2d = rng.randn(n, 40).astype(np.float32)
    t = torch.from_numpy
    srcs = [t(pts)[:, 3:], t(f2d).to(DTYPES[feat_dtype])]
    cdt = DTYPES[compute]
    got, counters = k3_model(t(seg), s, t(valid), d=srcs, round_to=cdt)
    assert not any(counters)
    plain = TS.segment_mean_gather_plain(t(seg), s, t(valid), d=srcs,
                                         round_to=cdt)
    _close(got, plain, REL_PLAIN, "model vs plain")
    # the JAX wrapper's feats path: concatenate, cast, then segment_mean;
    # fp32 sums of the cast elements
    feats = torch.cat([srcs[0], srcs[1].float()], 1).to(cdt).float()
    want = JS.segment_mean(jnp.asarray(feats.numpy()), _jax_ids(seg, s), s,
                           jnp.asarray(valid))
    _close(got, want, REL_JAX, "model vs JAX")
    _close(TS.segment_mean_columns(srcs, t(seg), s, cdt, t(valid)).float(),
           np.asarray(want).astype(np.float32), 1e-2 if compute ==
           "bfloat16" else REL_JAX, "wrapper vs JAX")


@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
def test_pool_model(g_dtype):
    """The fused devoxelize + superpoint pool: (V, 24) voxel rows gathered
    through the inverse map (-1: no voxel), and two (N, 3) centroid sets."""
    rng, seg, valid, s = _segments(seed=4)
    n = seg.shape[0]
    vox = rng.randn(300, 24).astype(np.float32)
    inverse = rng.randint(-1, 300, n).astype(np.int32)
    q = [rng.randn(n, 3).astype(np.float32) for _ in range(2)]
    t = torch.from_numpy
    g = t(vox).to(DTYPES[g_dtype])
    got, counters = k3_model(t(seg), s, t(valid), g=g, gather_idx=t(inverse),
                             d=[t(a) for a in q], seed=1)
    assert not any(counters)
    plain = TS.segment_mean_gather_plain(t(seg), s, t(valid), g=g,
                                         gather_idx=t(inverse),
                                         d=[t(a) for a in q])
    _close(got, plain, REL_PLAIN, "model vs plain")
    pt = jax_devoxelize(jnp.asarray(g.float().numpy()), jnp.asarray(inverse),
                        jnp.asarray(valid))
    want = JS.segment_mean_stack([pt] + [jnp.asarray(a) for a in q],
                                 _jax_ids(seg, s), s, jnp.asarray(valid))
    _close(got, np.concatenate([np.asarray(w) for w in want], 1), REL_JAX,
           "model vs JAX")


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_wrapper_voxel_mean_matches_jax_feats_path(compute):
    """The backbone wrapper's voxel mean (two column sources, fp16 2D
    features as the ScanNet reader gives them) against the JAX wrapper's
    ``feats`` path: ``concatenate([rgb, 2D features]).astype(dtype)``,
    then ``segment_mean`` over the plan's inverse map.  In bf16 the port's
    rows are at the stem's aligned pitch (``narrow.row_pitch``: 35 -> 40
    columns), zero past the 35 features."""
    from segdino3d_tpu_torch.data.collate import (PadSpec, attach_host_plan,
                                                  collate)
    from segdino3d_tpu_torch.data.synthetic import synthetic_scene
    from segdino3d_tpu_torch.models.backbone.wrapper import \
        SparseBackboneWrapper

    rec = synthetic_scene(2, n_points=1500, n_instances=4, n_superpoints=64,
                          n_classes=18, feat_dim_2d=32)
    rec["points_2dfeats"] = rec["points_2dfeats"].astype(np.float16)
    spec = PadSpec(1536, 64, 16, 16, 20)
    batch = attach_host_plan(collate([rec], spec, "cpu"), [rec], spec,
                             voxel_size=0.02)

    class Capture(torch.nn.Module):
        stem_kernel = 5

        def forward(self, vox_feats, plan):
            self.seen = vox_feats
            return vox_feats.new_zeros(vox_feats.shape[0], 96)

    unet = Capture()
    wrapper = SparseBackboneWrapper(unet, (1.0, 0.5, 0.25, 0.125, 0.06),
                                    s_cap=64, compute_dtype=compute)
    with torch.no_grad():
        wrapper(batch)
    got = unet.seen
    assert got.dtype == DTYPES[compute]

    pts = batch.points.reshape(-1, 6).numpy()
    f2d = batch.points_2dfeats.reshape(pts.shape[0], -1).numpy()
    assert f2d.dtype == np.float16
    jdt = jnp.bfloat16 if compute == "bfloat16" else jnp.float32
    feats = jnp.concatenate([jnp.asarray(pts[:, 3:]), jnp.asarray(f2d)],
                            axis=-1).astype(jdt)
    inverse = batch.plan.inverse.numpy()
    valid0 = batch.plan.levels[0].valid.numpy()
    v0 = valid0.shape[0]
    want = JS.segment_mean(feats, jnp.asarray(np.where(inverse >= 0, inverse,
                                                       v0)), v0,
                           jnp.asarray(batch.point_valid.reshape(-1).numpy()))
    want = np.where(valid0[:, None], np.asarray(want, np.float32), 0.0)
    from segdino3d_tpu_torch.ops.narrow import row_pitch
    c = want.shape[1]
    assert got.shape[1] == row_pitch(c, DTYPES[compute])
    assert not got[:, c:].float().any()
    # bf16: JAX sums in bf16, the port in fp32, each rounded once to bf16
    _close(got[:, :c].float(), want,
           1e-2 if compute == "bfloat16" else REL_JAX)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


def _points(seed=5, n=900, box=16):
    rng = np.random.RandomState(seed)
    coords = rng.uniform(0, box, (n, 3)).astype(np.float32)
    return coords, np.zeros(n, np.int32), rng.rand(n) > 0.05


def _plan(kind, seed=5):
    coords, bidx, valid = _points(seed)
    if kind == "host":
        return TH.host_plan_to_device(
            TH.build_host_plan(coords, bidx, valid, CAPS), "cpu")
    grid = TV.voxelize(torch.from_numpy(bidx), torch.from_numpy(coords),
                       torch.from_numpy(valid), CAPS[0])
    plan, overflow = build_unet_plan(grid, 5, 5, CAPS)
    assert not bool(overflow)
    return plan


def up_model(x, child, parent, valid, w):
    """K2 as the kernel schedules it, in fp32: the rows with no pair
    zeroed, then per slot the child table's pairs in items of 64, each
    product (Cin in ascending 32-channel slices) stored in its fine row if
    that row is valid.  Returns (out, times each row was written)."""
    x, w = x.float(), w.float()
    pairs = TSC.gather_pairs_plain(None, child)
    vf = parent.shape[0]
    out = torch.full((vf, w.shape[2]), float("nan"))
    writes = torch.zeros(vf, dtype=torch.long)
    dead = ~(valid & (parent >= 0))
    out[dead] = 0.0
    writes[dead] += 1
    for k, n in enumerate(pairs.counts.tolist()):
        for j0 in range(0, n, ITEM_PAIRS):
            j = pairs.rows[k, j0:min(n, j0 + ITEM_PAIRS)].long()
            f = child[k, j].long()
            acc = x.new_zeros(j.shape[0], w.shape[2])
            for k0 in range(0, x.shape[1], BK):
                acc = acc + x[j, k0:k0 + BK] @ w[k, k0:k0 + BK]
            keep = valid[f]
            out[f[keep]] = acc[keep]
            writes[f[keep]] += 1
    return out, writes


WIDTHS = [(256, 256, 4), (256, 128, 3), (128, 96, 2), (96, 96, 1)]


@pytest.mark.parametrize("kind", ["host", "device"])
def test_up_model_matches_plain(kind):
    """Both roles on every level: the up convs (decoder widths) and the
    down convs' dX (transposed W, as ``_DownConv.backward`` calls it)."""
    plan = _plan(kind)
    lv = plan.levels
    rng = np.random.RandomState(9)
    for cin, cout, li in WIDTHS:
        fine, coarse_rows = lv[li - 1], lv[li].valid.shape[0]
        # every live fine row has exactly one pair, every other row none
        hits = torch.zeros(fine.valid.shape[0], dtype=torch.long)
        table = fine.child
        live = table >= 0
        hits.index_add_(0, table[live].long(), torch.ones(int(live.sum()),
                                                           dtype=torch.long))
        assert torch.equal(hits, (fine.valid & (fine.parent >= 0)).long()), \
            (kind, li)
        assert not (~fine.valid & (fine.parent >= 0)).any(), (kind, li)
        for role in ("up", "down dX"):
            w = torch.from_numpy((rng.randn(8, cin, cout) / np.sqrt(cin))
                                 .astype(np.float32))
            if role == "down dX":
                w = w.transpose(1, 2).contiguous()
            x = torch.from_numpy(rng.randn(coarse_rows, w.shape[1])
                                 .astype(np.float32))
            got, writes = up_model(x, table, fine.parent, fine.valid, w)
            assert (writes == 1).all(), (kind, li, role)
            want = TSC.up_conv_plain(x, fine.parent, fine.kpos, w,
                                     fine.valid)
            torch.testing.assert_close(
                got, want, rtol=0, atol=REL_PLAIN * float(want.abs().max()),
                msg=lambda m: f"{kind} L{li} {role}: {m}")
            torch.testing.assert_close(
                TSC.up_conv_rows(x, table, fine.parent, fine.kpos, w,
                                 fine.valid), want, rtol=0, atol=0)


@pytest.mark.parametrize("role", ["up", "down dX"])
def test_up_model_matches_jax(role):
    coords, bidx, valid = _points(seed=6)
    jplan, _ = host_plan_to_device(jax_build_host_plan(
        coords, bidx, valid, CAPS, stem_compact=False), device=False)
    tplan = TH.host_plan_to_device(
        TH.build_host_plan(coords, bidx, valid, CAPS), "cpu")
    rng = np.random.RandomState(len(role))
    li = 1                                    # fine L1, coarse L2
    fine = tplan.levels[li]
    if role == "up":
        x = rng.randn(CAPS[li + 1], 128).astype(np.float32)
        w = (rng.randn(8, 128, 96) / np.sqrt(128)).astype(np.float32)
        want = np.asarray(JSC.up_conv(jnp.asarray(x), jplan.levels[li],
                                      jnp.asarray(w)))
        wt = torch.from_numpy(w)
    else:
        # dX of the down conv L1 -> L2 is the up conv of dY with W^T
        xf = rng.randn(CAPS[li], 64).astype(np.float32)
        w = (rng.randn(8, 64, 128) / np.sqrt(8 * 64)).astype(np.float32)
        x = rng.randn(CAPS[li + 1], 128).astype(np.float32)
        x = np.where(np.asarray(jplan.levels[li + 1].valid)[:, None], x, 0.0)
        _, vjp = jax.vjp(lambda f: JSC.down_conv(
            f, jplan.levels[li], jplan.levels[li + 1], jnp.asarray(w)),
            jnp.asarray(xf))
        want = np.asarray(vjp(jnp.asarray(x))[0])
        want = np.where(np.asarray(jplan.levels[li].valid)[:, None], want, 0)
        wt = torch.from_numpy(w).transpose(1, 2).contiguous()
    got, writes = up_model(torch.from_numpy(x), fine.child, fine.parent,
                           fine.valid, wt)
    assert (writes == 1).all()
    _close(got.numpy(), want, REL_JAX)
