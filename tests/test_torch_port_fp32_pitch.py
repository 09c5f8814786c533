"""The fp32 stems at a 16-byte pitch, and K1's and K10's pair-major chunks
sized by live pairs.

The stems' 259 (flagship) and 262 (ScanNet v2) input channels reach the
kernels at ``narrow.row_pitch``: 16-byte rows, zero past Cin (fp32 260 and
264, bf16 264), so that every kernel stages them in 16-byte copies; the
stem pads its weight to match and its parameter keeps its shape.  Here:

* ``row_pitch`` in both dtypes, and every rule keyed by Cin picking for
  260 and 264 what it picks for 259 and 262;
* the padded stem (the plain path) against the unpadded one, forward and
  the parameter's gradient (``1e-6 x max``: the CPU's matmul may sum a
  wider row in another order; the card's kernels add the zero columns'
  +0 in the same order, and ``chip_smoke.py`` holds them equal);
* the Res16UNet34C and the SpConvUNet fed at the pitch against the frozen
  fixture (``backbone_frozen.npz``, ``rtol = atol = 2e-3``, its own
  allowance) and the JAX apply on the same plan and unpadded features
  (``1e-4``);
* K3 writing the fp32 means at the pitch (``segment_mean_gather(...,
  width=)``), zero past the columns;
* ``offset_chunks`` on live counts: consecutive, every offset once, each
  chunk within the budget or a single offset, the fewest chunks, the least
  largest chunk among those, one chunk when all fit, and today's
  cap-sized chunks when every count is the cap;
* ``pair_major_chunks``: the counts read to the host only where the
  cap-sized chunks reach ``COUNT_READ_MIN_CHUNKS`` (not at the batch-1
  headline scene's convs), once per list;
* plain models of K1's and K10's pair-major schedules in live-sized
  chunks (each chunk's products in a buffer of its own live pairs, the
  sums onto an fp32 carry): bit-equal to one chunk.
"""
import itertools
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402

from segdino3d_tpu_torch.models.backbone.res16unet import (  # noqa: E402
    Res16UNet34C, SubMConv)
from segdino3d_tpu_torch.models.backbone.spconv_unet import SpConvUNet  # noqa: E402
from segdino3d_tpu_torch.ops import block_dense as TBD  # noqa: E402
from segdino3d_tpu_torch.ops import host_plan as TH  # noqa: E402
from segdino3d_tpu_torch.ops import narrow as TN  # noqa: E402
from segdino3d_tpu_torch.ops import scatter as TS  # noqa: E402
from segdino3d_tpu_torch.ops import sparse_conv as TSC  # noqa: E402
from segdino3d_tpu_torch.ops.conv_ctx import GatherCtx  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
ENV = "SEGDINO_CONV_CHUNK_MB"
CAPS = [1024, 512, 256, 128, 64]
REL = 1e-6
TOL = dict(rtol=1e-4, atol=1e-4)
ITEM_PAIRS = 64


@pytest.fixture(scope="module", autouse=True)
def _setup():
    """The JAX plan library, and one torch thread: the suite runs several
    test workers at once."""
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed=5, n=900, box=16):
    rng = np.random.RandomState(seed)
    coords = rng.uniform(0, box, (n, 3)).astype(np.float32)
    return coords, np.zeros(n, np.int32), rng.rand(n) > 0.05


def _plan(**kw):
    return TH.host_plan_to_device(
        TH.build_host_plan(*_points(), CAPS, **kw), "cpu")


def _pad(x, width):
    return F.pad(x, (0, width - x.shape[1]))


# --------------------------------------------------------------------------
# the pitch and the rules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cin,dtype,want", [
    (3, F32, 3), (96, F32, 96), (259, F32, 260), (262, F32, 264),
    (3, BF16, 3), (96, BF16, 96), (259, BF16, 264), (262, BF16, 264)])
def test_row_pitch(cin, dtype, want):
    """16-byte rows (fp32 4 elements, bf16 8); the narrow path's Cin <= 4
    and rows already aligned keep Cin."""
    assert TN.row_pitch(cin, dtype) == want


# (the stem's Cin, its fp32 pitch, its offsets)
STEMS = [(259, 260, 125), (262, 264, 27)]
RULE_CAPS = [None, 2304, 36864, 92160, 131072, 262144, 625664]


@pytest.mark.parametrize("cin,pitch,n_off", STEMS)
def test_rules_pick_the_same_at_the_pitch(cin, pitch, n_off):
    """Every rule keyed by Cin picks for the fp32 pitch what it picks for
    Cin: K1's warpgroup stems and form, the narrow and live-pair paths of
    K1, K4, K10 and K11, and the weight gradients' split capacity (the
    flagship's stem at every cap; the v2 stem up to 294 x 1,024 pairs an
    offset, past which 264's wider rows fit 294 splits in the scratch
    against 262's 296)."""
    for dt in (F32, BF16):
        assert TN.wide_stem(pitch, 32, dt) == TN.wide_stem(cin, 32, dt)
        for n in (n_off, 27, 125):
            for wgrad in (False, True):
                assert TN.pick(None, n, pitch, 32, dt, "t", wgrad) == \
                    TN.pick(None, n, cin, 32, dt, "t", wgrad)
                assert TN.pick_live(None, False, n, pitch, 32, dt, True, "t",
                                    wgrad) == TN.pick_live(
                    None, False, n, cin, 32, dt, True, "t", wgrad)
            for cap, dx in itertools.product(RULE_CAPS, (False, True)):
                assert TN.gather_form(n, pitch, 32, dt, cap=cap, dx=dx) == \
                    TN.gather_form(n, cin, 32, dt, cap=cap, dx=dx)
                assert TN.live_path(n, pitch, 32, dt, True, dx=dx,
                                    cap=cap) == TN.live_path(
                    n, cin, 32, dt, True, dx=dx, cap=cap)
    most = None if n_off == 125 else 294 * TSC.WGRAD_MIN_PAIRS
    for cap in RULE_CAPS[1:] + [371712, 10 ** 7]:
        if most is None or cap <= most:
            assert TSC.wgrad_splits(cap, n_off, pitch, 32) == \
                TSC.wgrad_splits(cap, n_off, cin, 32)


# --------------------------------------------------------------------------
# the stem at the pitch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cin,pitch,n_off", STEMS)
def test_padded_stem_matches_the_unpadded_stem(cin, pitch, n_off):
    """``SubMConv`` fed the pitch's zero columns pads its weight inside the
    forward: its output, the input's gradient on the real columns and the
    parameter's gradient (of the parameter's own shape) equal the unpadded
    stem's within ``1e-6 x max``."""
    plan = _plan(stem_kernel=5 if n_off == 125 else 3)
    lv = plan.levels[0]
    nbr = plan.stem_nbr if n_off == 125 else lv.nbr
    rng = np.random.RandomState(cin)
    conv = SubMConv(cin, 32, n_off)
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(
            (rng.randn(n_off, cin, 32) / np.sqrt(n_off * cin)
             ).astype(np.float32)))
    x = torch.from_numpy(rng.randn(lv.valid.shape[0], cin).astype(
        np.float32))
    cot = torch.from_numpy(rng.randn(lv.valid.shape[0], 32).astype(
        np.float32))
    ctx = GatherCtx(nbr, lv.valid)
    outs, grads = [], []
    for width in (cin, pitch):
        xi = _pad(x, width).requires_grad_()
        conv.zero_grad()
        out = conv(xi, ctx)
        (out * cot).sum().backward()
        assert conv.kernel.grad.shape == (n_off, cin, 32)
        assert not xi.grad[:, cin:].any() or width == cin
        outs.append(out.detach())
        grads.append((xi.grad[:, :cin].clone(), conv.kernel.grad.clone()))
    for got, want in [(outs[1], outs[0]), *zip(grads[1], grads[0])]:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=REL * float(want.abs().max()))


class _Pitched:
    """A U-Net whose forward takes its input at Cin and feeds it to the
    stem at the fp32 pitch, as the backbone wrapper does."""

    def forward(self, feats, plan):
        return super().forward(
            _pad(feats, TN.row_pitch(feats.shape[1], feats.dtype)), plan)


class PitchedRes16(_Pitched, Res16UNet34C):
    pass


class PitchedSpConv(_Pitched, SpConvUNet):
    pass


@pytest.mark.parametrize("model", ["res16", "spconv"])
def test_backbones_at_the_pitch_match_the_frozen_fixture(model):
    """The fixture's scenes and reference weights through the port's
    loader (``test_torch_port_spconv.bridged_port_output``), the stem fed
    at the pitch (Res16UNet34C 35 -> 36, SpConvUNet 38 -> 40): within the
    fixture's ``rtol = atol = 2e-3``."""
    from segdino3d_tpu.models.backbone.res16unet import \
        Res16UNet34C as JaxRes16
    from segdino3d_tpu.models.backbone.spconv_unet import \
        SpConvUNet as JaxSpConv
    from test_backbone_frozen_numerics import FIXTURE
    from test_torch_port_spconv import bridged_port_output
    from test_torch_roundtrip import (build_res16_torch_sd,
                                      build_spconv_torch_sd)

    seen = []
    if model == "res16":
        tmodel = PitchedRes16(in_channels=35)
        stem = tmodel.conv0p1s1
    else:
        tmodel = PitchedSpConv(in_channels=38)
        stem = tmodel.input_conv
    handle = stem.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].shape[1]))
    try:
        if model == "res16":
            out = bridged_port_output(JaxRes16(in_channels=35,
                                               out_channels=96), tmodel,
                                      build_res16_torch_sd, 7, 11, 3, 35)
        else:
            out = bridged_port_output(JaxSpConv(in_channels=38), tmodel,
                                      build_spconv_torch_sd, 9, 13, 5, 38,
                                      stem_kernel=3)
    finally:
        handle.remove()
    assert seen == [36 if model == "res16" else 40]
    np.testing.assert_allclose(out, np.load(FIXTURE)[model], rtol=2e-3,
                               atol=2e-3)


def test_res16_at_the_pitch_matches_jax_apply():
    """The bridged Res16UNet34C of ``test_torch_port_backbone.py`` (Cin 35,
    the pitch 36) against the JAX apply on the unpadded features: within
    ``1e-4``."""
    from segdino3d_tpu.ops.host_plan import \
        build_host_plan as jax_build_host_plan
    from segdino3d_tpu.ops.host_plan import host_plan_to_device
    from test_torch_port_backbone import CAPS as BCAPS
    from test_torch_port_backbone import bridged_models

    m = bridged_models()
    coords, bidx, valid = m["points"]
    jplan, _ = host_plan_to_device(jax_build_host_plan(
        coords, bidx, valid, BCAPS, stem_compact=False), device=False)
    tplan = TH.host_plan_to_device(
        TH.build_host_plan(coords, bidx, valid, BCAPS), "cpu")
    want = jax.jit(lambda v, f, p: m["jmodel"].apply(v, f, p, False))(
        m["variables"], jnp.asarray(m["feats"]), jplan)
    x = torch.from_numpy(m["feats"])
    with torch.no_grad():
        got = m["tmodel"](_pad(x, TN.row_pitch(x.shape[1], F32)), tplan)
    mask = tplan.levels[0].valid[:, None].numpy().astype(np.float32)
    want = np.asarray(want) * mask
    assert np.abs(want).mean() > 1e-3
    np.testing.assert_allclose(got.numpy() * mask, want, **TOL)


def test_v2_stem_width_at_the_pitch_matches_jax_apply():
    """A narrow SpConvUNet with the v2 stem's 262 input channels, fed at
    the pitch 264, against the JAX apply on the unpadded features, seeded
    weights: within ``1e-4``."""
    from segdino3d_tpu.models.backbone.spconv_unet import \
        SpConvUNet as JaxSpConv
    from segdino3d_tpu.ops.host_plan import \
        build_host_plan as jax_build_host_plan
    from segdino3d_tpu.ops.host_plan import host_plan_to_device
    from segdino3d_tpu_torch.convert import load_jax_variables
    from test_torch_port_spconv import flax_shapes, seeded_variables

    planes, cin = (8, 12, 16, 20, 24), 262
    coords = np.random.RandomState(0).randint(0, 32, (1200, 3)).astype(
        np.float32)
    bidx, valid = np.zeros(1200, np.int32), np.ones(1200, bool)
    caps = [1280, 1024, 512, 256, 64]
    jplan, _ = host_plan_to_device(jax_build_host_plan(
        coords, bidx, valid, caps, stem_kernel=3), device=False)
    tplan = TH.host_plan_to_device(TH.build_host_plan(
        coords, bidx, valid, caps, stem_kernel=3), "cpu")
    feats = np.random.RandomState(1).randn(caps[0], cin).astype(np.float32)
    jmodel = JaxSpConv(num_planes=planes, in_channels=cin)
    variables = seeded_variables(
        flax_shapes(jmodel, jnp.asarray(feats), jplan), seed=2)
    tmodel = load_jax_variables(SpConvUNet(num_planes=planes,
                                           in_channels=cin), variables)
    want = jax.jit(lambda v, f, p: jmodel.apply(v, f, p, False))(
        variables, jnp.asarray(feats), jplan)
    x = _pad(torch.from_numpy(feats), TN.row_pitch(cin, F32))
    assert x.shape[1] == 264
    with torch.no_grad():
        got = tmodel.eval()(x, tplan)
    mask = tplan.levels[0].valid[:, None].numpy().astype(np.float32)
    want = np.asarray(want) * mask
    assert np.abs(want).mean() > 1e-2
    np.testing.assert_allclose(got.numpy() * mask, want, **TOL)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_voxel_mean_at_the_pitch(dtype):
    """K3's means at a wider row (``width``) are the means, then zero
    columns; the wrapper's column mean at the stem's pitch is the same in
    either dtype; a width below the columns raises."""
    rng = np.random.RandomState(3)
    n, s = 2000, 300
    seg = torch.from_numpy(rng.randint(-1, s, n).astype(np.int32))
    valid = torch.from_numpy(rng.rand(n) > 0.1)
    srcs = [torch.from_numpy(rng.randn(n, 3).astype(np.float32)),
            torch.from_numpy(rng.randn(n, 256).astype(np.float16))]
    width = TN.row_pitch(259, dtype)
    means = TS.segment_mean_gather(seg, s, valid, d=srcs, round_to=dtype)
    wide = TS.segment_mean_gather(seg, s, valid, d=srcs, round_to=dtype,
                                  width=width)
    assert wide.shape == (s, width) and wide.dtype == F32
    assert torch.equal(wide[:, :259], means) and not wide[:, 259:].any()
    cols = TS.segment_mean_columns(srcs, seg, s, dtype, valid, width=width)
    assert cols.dtype == dtype and torch.equal(cols, wide.to(dtype))
    with pytest.raises(ValueError):
        TS.segment_mean_gather(seg, s, valid, d=srcs, width=258)


# --------------------------------------------------------------------------
# chunks sized by live pairs
# --------------------------------------------------------------------------

def set_budget_bytes(monkeypatch, nbytes):
    monkeypatch.setenv(ENV, repr(nbytes / 2 ** 20))


def _sizes(counts, stride, map_rows):
    return [c * stride * 4 + map_rows * 4 for c in counts]


def _fewest(sizes, budget):
    """The fewest consecutive chunks within ``budget`` (an offset past it
    alone), by dynamic programming over the cut points."""
    n = len(sizes)
    best = [0] + [None] * n
    for end in range(1, n + 1):
        for begin in range(end):
            if best[begin] is None:
                continue
            total = sum(sizes[begin:end])
            if total <= budget or end - begin == 1:
                c = best[begin] + 1
                best[end] = c if best[end] is None else min(best[end], c)
    return best[n]


def _least_largest(sizes, n_chunks):
    """The least largest chunk over every cut into ``n_chunks``
    consecutive chunks (small n alone)."""
    n = len(sizes)
    return min(max(sum(sizes[a:b]) for a, b in zip((0,) + cut, cut + (n,)))
               for cut in itertools.combinations(range(1, n), n_chunks - 1))


# (n_off, cap, stride, budget as a multiple of one offset's cap scratch,
# index map rows as a multiple of cap, seed)
LIVE_CASES = [(27, 4096, 96, 1.0, 0, 0), (27, 4096, 96, 2.5, 1, 1),
              (27, 4096, 96, 30.0, 1, 2), (125, 2048, 32, 5.0, 1, 3),
              (125, 2048, 32, 0.5, 0, 4), (8, 1000, 64, 1.5, 1, 5),
              (9, 500, 128, 2.0, 0, 6), (10, 300, 32, 0.7, 1, 7)]


@pytest.mark.parametrize("n_off,cap,stride,per,maps,seed", LIVE_CASES)
def test_offset_chunks_on_live_counts(monkeypatch, n_off, cap, stride, per,
                                      maps, seed):
    """Chunks sized by live counts (some offsets empty, some full): in
    order, every offset once; each chunk within the budget or one offset;
    the fewest such chunks; among those, the least largest chunk (small
    cases, against every cut); one chunk when all fit."""
    rng = np.random.RandomState(seed)
    counts = [int(c) for c in rng.randint(0, cap + 1, n_off)]
    counts[0], counts[-1] = 0, cap
    budget = int(cap * stride * 4 * per)
    set_budget_bytes(monkeypatch, budget)
    map_rows = cap * maps
    chunks = TSC.offset_chunks(n_off, cap, stride, counts, map_rows)
    sizes = _sizes(counts, stride, map_rows)
    assert chunks[0][0] == 0 and chunks[-1][1] == n_off
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(o1 > o0 for o0, o1 in chunks)
    for o0, o1 in chunks:
        assert sum(sizes[o0:o1]) <= budget or o1 - o0 == 1
    assert len(chunks) == _fewest(sizes, budget)
    if sum(sizes) <= budget:
        assert chunks == [(0, n_off)]
    if n_off <= 10:
        assert max(sum(sizes[a:b]) for a, b in chunks) == \
            _least_largest(sizes, len(chunks))


def test_offset_chunks_live_counts_at_the_cap_are_todays(monkeypatch):
    """Every count at the cap, no index map: the cap-sized chunks, even
    in offsets with a shorter last one, on ``test_torch_port_batched``'s
    cases."""
    from test_torch_port_batched import CHUNK_CASES

    for n_off, cap, stride, budget in CHUNK_CASES:
        set_budget_bytes(monkeypatch, budget)
        want = TSC.offset_chunks(n_off, cap, stride)
        assert TSC.offset_chunks(n_off, cap, stride, [cap] * n_off) == want
        per = max(1, budget // (cap * stride * 4))
        size = -(-n_off // -(-n_off // per))
        assert want == [(o, min(o + size, n_off))
                        for o in range(0, n_off, size)]


def test_counts_read_only_where_the_cap_sized_chunks_are_many(monkeypatch):
    """``pair_major_chunks`` keeps the cap-sized chunks, and reads nothing,
    below ``COUNT_READ_MIN_CHUNKS`` of them: every conv of the batch-1
    headline scene at the default budget (the k5 stem and level 0's dX
    96 -> 128, 1.47 and 1.27 GB, in two).  At the batch of 8's caps under
    384 MiB it reads the counts once per list (a second call on the same
    list reads nothing, another list reads again) and sizes the chunks by
    them, its scratch the largest chunk's pairs."""
    monkeypatch.delenv(ENV, raising=False)
    reads = types.SimpleNamespace(launches=0)
    rng = np.random.RandomState(9)
    for n_off, cap, stride in ((125, 92160, 32), (27, 92160, 128),
                               (27, 92160, 96), (27, 36864, 96)):
        counts = torch.from_numpy(rng.randint(0, cap // 3, n_off).astype(
            np.int32))
        chunks, rows = TSC.pair_major_chunks(n_off, cap, stride, counts,
                                             reads, cap)
        assert chunks == TSC.offset_chunks(n_off, cap, stride)
        assert len(chunks) < TSC.COUNT_READ_MIN_CHUNKS
        assert rows == max(b - a for a, b in chunks) * cap
    assert reads.launches == 0
    monkeypatch.setenv(ENV, "384")
    n_off, cap, stride = 125, 625664, 32
    counts = torch.from_numpy(rng.randint(0, cap // 4, n_off).astype(
        np.int32))
    assert len(TSC.offset_chunks(n_off, cap, stride)) >= \
        TSC.COUNT_READ_MIN_CHUNKS
    chunks, rows = TSC.pair_major_chunks(n_off, cap, stride, counts, reads,
                                         cap)
    live = counts.tolist()
    assert reads.launches == 1
    assert chunks == TSC.offset_chunks(n_off, cap, stride, live, cap)
    assert len(chunks) < len(TSC.offset_chunks(n_off, cap, stride))
    assert rows == max(sum(live[a:b]) for a, b in chunks)
    assert TSC.pair_major_chunks(n_off, cap, stride, counts, reads,
                                 cap) == (chunks, rows)
    assert reads.launches == 1
    TSC.pair_major_chunks(n_off, cap, stride, counts.clone(), reads, cap)
    assert reads.launches == 2


def k1_chunked_model(feats, nbr, weights, valid, chunks):
    """K1's pair-major schedule in offset chunks, as the kernel runs them:
    each chunk's live pairs in items of 64 into a buffer of the chunk's
    live pairs alone (offset o's pair j at row ``first[o] + j``) with its
    own index map, then each valid row adds its chunk's products in
    ascending offset order onto the fp32 carry the chunk before left.
    Returns (output, the largest buffer's rows)."""
    x, w = feats.float(), weights.float()
    pairs = TSC.gather_pairs_plain(None, nbr)
    counts = pairs.counts.tolist()
    carry = x.new_zeros(nbr.shape[1], w.shape[2])
    most = 0
    for o0, o1 in chunks:
        first = np.concatenate([[0], np.cumsum(counts[o0:o1])])
        partial = x.new_full((int(first[-1]), w.shape[2]), float("nan"))
        most = max(most, partial.shape[0])
        pos = torch.full((o1 - o0, nbr.shape[1]), -1, dtype=torch.long)
        for o in range(o0, o1):
            n = counts[o]
            for j0 in range(0, n, ITEM_PAIRS):
                rows = pairs.rows[o, j0:min(n, j0 + ITEM_PAIRS)].long()
                at = int(first[o - o0]) + j0 + torch.arange(rows.shape[0])
                partial[at] = x[nbr[o, rows].long()] @ w[o]
                pos[o - o0, rows] = at
        for o in range(o1 - o0):
            live = (pos[o] >= 0) & valid
            carry[live] += partial[pos[o, live]]
    return torch.where(valid[:, None], carry, 0.0).to(feats.dtype), most


def k10_chunked_model(feats, weights, lp, chunks):
    """K10's pair-major form in offset chunks: each chunk's products in a
    buffer of its live pairs (offset o's pair j at ``first[o] + j``), then
    each listed row adds, offset by offset ascending, the product its map
    names (``live_sum_kernel``) onto the fp32 carry."""
    x, w = feats.float(), weights.float()
    counts = lp.counts.tolist()
    n = int(lp.rows.count)
    listed = lp.rows.rows[:n].long()
    carry = x.new_zeros(n, w.shape[2])
    for o0, o1 in chunks:
        first = np.concatenate([[0], np.cumsum(counts[o0:o1])])
        partial = torch.cat([x[lp.src[o, :counts[o]].long()] @ w[o]
                             for o in range(o0, o1)])
        assert partial.shape[0] == first[-1]
        for o in range(o0, o1):
            p = lp.map[o, :n].long()
            hit = p >= 0
            carry[hit] += partial[int(first[o - o0]) + p[hit]]
    out = x.new_zeros(feats.shape[0], w.shape[2])
    out[listed] = carry
    return out.to(feats.dtype)


@pytest.mark.parametrize("role", ["stem", "k3"])
@pytest.mark.parametrize("per", [0.5, 1.0, 3.0])
def test_k1_live_chunks_are_bit_equal_to_one_chunk(monkeypatch, role, per):
    """K1's schedule in chunks sized by the table's live pairs (and the
    index map) under a budget of ``per`` offsets' cap-sized scratch: more
    than one chunk, each buffer no larger than its chunk's pairs, the
    output bit-equal to the schedule in one chunk and within ``1e-6 x
    max`` of ``gather_conv_plain``."""
    from test_torch_port_conv_tiles import _plan as tiles_plan
    from test_torch_port_conv_tiles import pairs_model

    plan = tiles_plan("host")
    lv = plan.levels[0]
    nbr = plan.stem_nbr if role == "stem" else lv.nbr
    cin, cout = (36, 32) if role == "stem" else (40, 96)
    rng = np.random.RandomState(53)
    x = torch.from_numpy(rng.randn(lv.valid.shape[0], cin).astype(
        np.float32))
    w = torch.from_numpy((rng.randn(nbr.shape[0], cin, cout)
                          / np.sqrt(nbr.shape[0] * cin)).astype(np.float32))
    cap, stride = nbr.shape[1], cout
    set_budget_bytes(monkeypatch, int(cap * stride * 4 * per))
    counts = TSC.gather_pairs_plain(None, nbr).counts.tolist()
    chunks = TSC.offset_chunks(nbr.shape[0], cap, stride, counts, cap)
    assert 1 < len(chunks) < len(TSC.offset_chunks(nbr.shape[0], cap,
                                                   stride))
    got, most = k1_chunked_model(x, nbr, w, lv.valid, chunks)
    assert most == max(sum(counts[a:b]) for a, b in chunks)
    want, _ = pairs_model(x, nbr, w, lv.valid)
    assert torch.equal(got, want)
    plain = TSC.gather_conv_plain(x, nbr, w, lv.valid)
    torch.testing.assert_close(got, plain, rtol=0,
                               atol=REL * float(plain.abs().max()))


@pytest.mark.parametrize("k,dx", [(3, False), (3, True), (5, False)])
def test_k10_live_chunks_are_bit_equal_to_one_chunk(monkeypatch, k, dx):
    """K10's pair-major form over a level's live-pair list (the
    occupancy's, the dilation's in the dX role, the dense k5 stem's) in
    chunks sized by its live pairs: bit-equal to one chunk and to
    ``block_conv_live_plain``, and within ``1e-6 x max`` of the dense
    plain conv."""
    t = _plan(block_edges=[4] * 5).blocks[0]
    occ = TBD.occupancy(t)
    if dx:
        mask = TBD.occupancy_dilation_plain(occ, t.block_nbr, t.edge, k)
        rows = TBD.RowList(*TBD.occupied_rows_plain(mask), None)
        row_cap = occ.shape[0]
    else:
        mask, row_cap = occ, None
        rows = TBD.RowList(*TBD.occupied_rows_plain(occ), None)
    cap = TBD.live_capacity(t)
    lp = TBD.live_pairs_plain(rows, occ, t.block_nbr, t.edge, k, cap,
                              row_cap)
    cin, cout = (36, 32) if k == 5 else (40, 96)
    rng = np.random.RandomState(59 + k)
    x = torch.from_numpy(np.where(occ.numpy()[:, None], rng.randn(
        occ.shape[0], cin), 0.0).astype(np.float32))
    w = torch.from_numpy((rng.randn(k ** 3, cin, cout)
                          / np.sqrt(k ** 3 * cin)).astype(np.float32))
    set_budget_bytes(monkeypatch, cap * cout * 4 * 2)
    counts = lp.counts.tolist()
    chunks = TSC.offset_chunks(k ** 3, cap, cout, counts)
    assert len(chunks) > 1
    got = k10_chunked_model(x, w, lp, chunks)
    assert torch.equal(got, k10_chunked_model(x, w, lp, [(0, k ** 3)]))
    assert torch.equal(got, TBD.block_conv_live_plain(x, w, lp))
    dense = TBD.dense_subm_conv_plain(x, t.block_nbr, w,
                                      None if dx else mask, t.edge)
    torch.testing.assert_close(got, torch.where(mask[:, None], dense, 0.0),
                               rtol=0, atol=REL * float(dense.abs().max()))
