"""The narrow-input weight-gradient path of K4 and K11
(``csrc/narrow_wgrad.cuh``) in plain PyTorch, on the CPU.

For a few input channels (the Baseline's rgb k5 stem, 3 -> 32) both
weight gradients reduce dW[o] = sum_r x[src(r, o)]^T @ dY[r] as the
transpose of the im2col form: a work item is a chunk of offsets
(``narrow.wgrad_layout``, the forward's chunks) and a split of the listed
rows (``wgt::split_of``); it walks its rows in tiles of 128, gathers each
tile's im2col block (rows) x (offset, channel) and adds the tile's
products to the chunk's dW block, rows in ascending order; the splits'
partials are then added in ascending order.  K4 lists every row of the
table (its sources the table's entries), K11 the level's occupied rows
(their sources through the block halo).  Here:

* a plain model of that order (``narrow_wgrad_model``) against
  ``gather_wgrad_plain`` and ``block_wgrad_plain`` (on the inputs in
  fp64, so that only the model's fp32 rounding counts) at 1e-6 x max|plain|
  (Cin 1, 2, 3, 4, 8; k 3, 5; K11 edges 4, 8; dY masked by the rows'
  validity or not, on small host plans made from a numpy seed), under
  several split capacities, and in bf16 at 1e-2 x max;
* the model against the JAX package's dW, ``jax.vjp`` of ``subm_conv``
  (its ``_subm_conv_bwd``) and of ``dense_subm_conv`` (its
  ``_chunked_conv_bwd``), at 1e-5 x max|reference| for a few shapes;
* the dispatch rule (``narrow.narrow_wgrad_path``, through ``narrow.pick``
  and the K4 form): narrow for the Baseline's stem dW alone among every
  dW shape of the flagship, v2 and Baseline models;
* the layout: the chunks cover each offset once, and every shape the
  narrow path admits fits in 227 KB.
"""
import itertools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from test_torch_port_jaxlib import load_jax_sparseplan  # noqa: E402

from segdino3d_tpu.ops import block_dense as JBD  # noqa: E402
from segdino3d_tpu.ops import host_plan as JH  # noqa: E402
from segdino3d_tpu.ops import sparse_conv as JSC  # noqa: E402
from segdino3d_tpu_torch.ops import block_dense as TBD  # noqa: E402
from segdino3d_tpu_torch.ops import host_plan as TH  # noqa: E402
from segdino3d_tpu_torch.ops import narrow as TN  # noqa: E402
from segdino3d_tpu_torch.ops import sparse_conv as TSC  # noqa: E402

# 2,600 points in a 20-voxel box: level 0 holds ~2,300 voxels, so the
# kernel's splits of at least 1,024 rows cut it in two or three
CAPS = [4096, 2048, 1024, 512, 256]
CINS = [1, 2, 3, 4, 8]
COUT = 32
REL_PLAIN = 1e-6
REL_JAX = 1e-5
SPLIT_ROWS = 32      # a split's rows are a multiple of this (wgt::BK)


@pytest.fixture(scope="module", autouse=True)
def _setup():
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed=6, n=2600, box=20):
    rng = np.random.RandomState(seed)
    coords = rng.uniform(0, box, (n, 3)).astype(np.float32)
    return coords, np.zeros(n, np.int32), rng.rand(n) > 0.05


_PLANS = {}


def _plan(edge=None):
    """A small host plan: the gather layout (``edge`` None) or block-dense
    levels of that edge."""
    if edge not in _PLANS:
        kw = {} if edge is None else dict(block_edges=[edge] * 5)
        _PLANS[edge] = TH.host_plan_to_device(
            TH.build_host_plan(*_points(), CAPS, **kw), "cpu")
    return _PLANS[edge]


def split_of(count, cap, min_rows=TSC.WGRAD_MIN_PAIRS):
    """``wgt::split_of``: (splits in use, rows a split) of ``count`` rows
    under a capacity of ``cap`` splits."""
    if count <= 0:
        return 0, SPLIT_ROWS
    used = min(-(-count // min_rows), cap)
    per = -(-(-(-count // used)) // SPLIT_ROWS) * SPLIT_ROWS
    return -(-count // per), per


def narrow_wgrad_model(x, src, dy, cap, dtype=torch.float32):
    """The narrow path's sums: ``src`` (n_off, R) the sources of the R
    listed rows (-1: absent, a zero row), ``dy`` (R, Cout) their dY.  Per
    chunk of ``narrow.wgrad_layout``'s g offsets and per split of the rows
    (``split_of`` under ``cap``): each 128-row tile's im2col block A (rows,
    g * Cin) gives A^T @ dY, added to the split's sum in ascending tile
    order; the splits' sums are added in ascending order.  Inputs rounded
    to ``dtype``, sums in fp32.  Returns (n_off, Cin, Cout) fp32."""
    n_off, rows = src.shape
    cin, cout = x.shape[1], dy.shape[1]
    lay = TN.wgrad_layout(n_off, cin, cout, dtype)
    xs, dys = x.to(dtype).float(), dy.to(dtype).float()
    used, per = split_of(rows, cap)
    dw = xs.new_zeros(n_off * cin, cout)
    for c in range(lay.chunks):
        o0 = c * lay.g
        offs = range(o0, min(n_off, o0 + lay.g))
        a = torch.cat([TSC._gather_rows(xs, src[o]) for o in offs], dim=1)
        total = None
        for s in range(max(used, 1)):
            part = xs.new_zeros(a.shape[1], cout)
            end = min(rows, (s + 1) * per)
            for p0 in range(s * per, end, TN.BM):
                p1 = min(p0 + TN.BM, end)
                part += a[p0:p1].T @ dys[p0:p1]
            total = part if total is None else total + part
        dw[o0 * cin:(o0 + len(offs)) * cin] = total
    return dw.reshape(n_off, cin, cout)


def k4_case(cin, k, masked, seed):
    """K4's narrow form on the plan's k5 stem or level 0's k3 table:
    (x, table, dY, plain dW); dY masked by the rows' validity or not.  The
    plain version runs on the inputs in fp64, so that the comparison
    measures the model's fp32 rounding alone (two fp32 sums of thousands
    of rows in different orders differ by ~1e-6 of the largest entry)."""
    plan = _plan()
    nbr = plan.stem_nbr if k == 5 else plan.levels[0].nbr
    rows = nbr.shape[1]
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(rows, cin).astype(np.float32))
    dy = torch.from_numpy(rng.randn(rows, COUT).astype(np.float32))
    if masked:
        dy = torch.where(plan.levels[0].valid[:, None], dy, 0.0)
    return x, nbr, dy, TSC.gather_wgrad_plain(x.double(), nbr, dy.double(),
                                              None, k ** 3, rows)


def k11_sources(t, k, rows):
    """K11's sources of the listed ``rows``: each cell shifted by each
    offset through the block halo."""
    h = (k - 1) // 2
    return torch.stack([TBD.halo_rows_plain(rows, t.block_nbr, t.edge, s)
                        for s in itertools.product(range(-h, h + 1),
                                                   repeat=3)])


def k11_case(cin, k, edge, masked, seed):
    """K11 on level 0's blocks: (x, the occupied rows' sources, their dY,
    plain dW, in fp64 as ``k4_case``'s); x is not zero outside the
    occupancy (the op's contract), and without ``masked`` every cell is
    listed."""
    t = _plan(edge).blocks[0]
    occ = TBD.occupancy(t) if masked else \
        torch.ones(t.slot_vox.shape[0], dtype=torch.bool)
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(occ.shape[0], cin).astype(np.float32))
    dy = torch.where(occ[:, None], torch.from_numpy(
        rng.randn(occ.shape[0], COUT).astype(np.float32)), 0.0)
    rows = torch.nonzero(occ).flatten()
    want = TBD.block_wgrad_plain(x.double(), dy.double(), t.block_nbr, occ,
                                 edge, k)
    return x, k11_sources(t, k, rows), dy[rows], want


def _close(got, want, rel):
    want = torch.as_tensor(np.array(want))
    scale = float(want.float().abs().max())
    assert scale > 0
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=rel * scale)


def test_plans_cut_into_splits():
    """The plans' row counts run over more than one split, so the split
    sum is exercised: level 0's table rows and its occupied cells."""
    rows = _plan().stem_nbr.shape[1]
    occupied = int(TBD.occupancy(_plan(4).blocks[0]).sum())
    for count in (rows, occupied):
        used, per = split_of(count, TSC.wgrad_splits(count, 125, 3, COUT))
        assert used >= 2 and per % SPLIT_ROWS == 0
        assert (used - 1) * per < count <= used * per


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("cin", CINS)
def test_k4_narrow_model_matches_plain(cin, k, masked):
    """K4's narrow order on the k5 stem table and level 0's k3 table
    against the plain version, at the scratch's split capacity."""
    x, nbr, dy, want = k4_case(cin, k, masked, seed=cin * 10 + k)
    cap = TSC.wgrad_splits(nbr.shape[1], k ** 3, cin, COUT)
    _close(narrow_wgrad_model(x, nbr, dy, cap), want, REL_PLAIN)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("edge", [4, 8])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("cin", CINS)
def test_k11_narrow_model_matches_plain(cin, k, edge, masked):
    """K11's narrow order over level 0's occupied rows (masked) or every
    cell, against the plain version."""
    x, src, dy, want = k11_case(cin, k, edge, masked, seed=cin + 10 * k
                                + edge)
    cap = TSC.wgrad_splits(src.shape[1], k ** 3, cin, COUT)
    _close(narrow_wgrad_model(x, src, dy, cap), want, REL_PLAIN)


@pytest.mark.parametrize("cap", [1, 2, 64])
def test_narrow_model_under_split_capacities(cap):
    """The launch cuts the scratch's capacity to one wave of items, so the
    splits in use vary with the card: one split, two, or as many as the
    rows need; each order agrees with the plain version."""
    x, nbr, dy, want = k4_case(3, 5, True, seed=41)
    _close(narrow_wgrad_model(x, nbr, dy, cap), want, REL_PLAIN)
    x, src, dy, want = k11_case(3, 5, 4, True, seed=42)
    _close(narrow_wgrad_model(x, src, dy, cap), want, REL_PLAIN)


@pytest.mark.parametrize("kernel", ["k4", "k11"])
@pytest.mark.parametrize("cin", [1, 3, 8])
def test_narrow_model_bf16_matches_plain(kernel, cin):
    """The bf16 order (inputs rounded to bf16, the MMA's fp32 sums over
    the chunk's packed channels) against the plain version in bf16, at
    1e-2 x max|plain|."""
    if kernel == "k4":
        x, src, dy, _ = k4_case(cin, 5, True, seed=50 + cin)
        want = TSC.gather_wgrad_plain(x.bfloat16(), src, dy.bfloat16(),
                                      None, 125, src.shape[1])
    else:
        t = _plan(4).blocks[0]
        occ = TBD.occupancy(t)
        x, src, dy, _ = k11_case(cin, 5, 4, True, seed=60 + cin)
        dense = torch.zeros(occ.shape[0], COUT)
        dense[torch.nonzero(occ).flatten()] = dy
        want = TBD.block_wgrad_plain(x.bfloat16(), dense.bfloat16(),
                                     t.block_nbr, occ, 4, 5)
    cap = TSC.wgrad_splits(src.shape[1], 125, cin, COUT)
    got = narrow_wgrad_model(x, src, dy, cap, torch.bfloat16)
    _close(got, want, 1e-2)


@pytest.mark.parametrize("k,cin,cout", [(5, 3, 32), (3, 2, 8)])
def test_k4_narrow_model_matches_jax(k, cin, cout):
    """The model against ``jax.vjp`` of the JAX package's ``subm_conv``
    (whose backward is ``_subm_conv_bwd``), on the same host plan built by
    JAX's plan builder."""
    coords, bidx, valid = _points()
    jplan, _ = JH.host_plan_to_device(JH.build_host_plan(
        coords, bidx, valid, CAPS, stem_compact=False), device=False)
    plan = _plan()
    nbr_t = plan.stem_nbr if k == 5 else plan.levels[0].nbr
    nbr_j = jplan.stem_nbr if k == 5 else jplan.subm_nbr[0]
    assert np.array_equal(np.asarray(nbr_j), nbr_t.numpy())
    rows = nbr_t.shape[1]
    rng = np.random.RandomState(70 + k)
    x = rng.randn(rows, cin).astype(np.float32)
    w = (rng.randn(k ** 3, cin, cout) / np.sqrt(k ** 3 * cin)).astype(
        np.float32)
    g = rng.randn(rows, cout).astype(np.float32)
    jvalid = jnp.asarray(jplan.levels[0].valid)
    _, vjp = jax.vjp(lambda wt: JSC.subm_conv(
        jnp.asarray(x), jnp.asarray(nbr_j), wt, jvalid), jnp.asarray(w))
    (want,) = vjp(jnp.asarray(g))
    dy = torch.where(plan.levels[0].valid[:, None], torch.from_numpy(g), 0.0)
    cap = TSC.wgrad_splits(rows, k ** 3, cin, cout)
    _close(narrow_wgrad_model(torch.from_numpy(x), nbr_t, dy, cap), want,
           REL_JAX)


@pytest.mark.parametrize("edge,k,cin", [(4, 5, 3), (8, 3, 2)])
def test_k11_narrow_model_matches_jax(edge, k, cin):
    """The model against ``jax.vjp`` of the JAX package's
    ``dense_subm_conv`` (halo padding and one VALID conv under the
    occupancy; its backward ``_chunked_conv_bwd``), x not zero outside the
    occupancy."""
    t = _plan(edge).blocks[0]
    occ = TBD.occupancy(t)
    rng = np.random.RandomState(80 + edge + k)
    x = rng.randn(occ.shape[0], cin).astype(np.float32)
    w = (rng.randn(k ** 3, cin, COUT) * 0.2).astype(np.float32)
    g = rng.randn(occ.shape[0], COUT).astype(np.float32)
    jt = JBD.BlockTables(jnp.asarray(t.vox_slot.numpy()),
                         jnp.asarray(t.block_nbr.numpy()), edge,
                         jnp.asarray(t.slot_vox.numpy()))
    _, vjp = jax.vjp(lambda wt: JBD.dense_subm_conv(
        jnp.asarray(x), jnp.asarray(occ.numpy()), jt, wt), jnp.asarray(w))
    (want,) = vjp(jnp.asarray(g))
    rows = torch.nonzero(occ).flatten()
    dy = torch.from_numpy(g)[rows]
    cap = TSC.wgrad_splits(rows.shape[0], k ** 3, cin, COUT)
    _close(narrow_wgrad_model(torch.from_numpy(x), k11_sources(t, k, rows),
                              dy, cap), want, REL_JAX)


def _dw_shapes(cfg):
    """(n_off, Cin, Cout) of every conv's dW of a model's backbone."""
    from segdino3d_tpu_torch.builder import Capacities, build_model

    model, _ = build_model(cfg, Capacities(num_superpoints=64,
                                           num_voxels=1024), device="cpu")
    return {tuple(p.shape) for p in model.backbone.parameters()
            if p.dim() == 3}


def k4_takes_narrow(n_off, cin, cout, dtype):
    """Whether K4 runs this conv's dW narrow: the backward's form at Cin <
    Cout (a gathered x, an identity dY, unmirrored; the wider input is
    read without a gather, mirrored, otherwise) and the rule."""
    return cin <= cout and TN.narrow_wgrad_path(n_off, cin, cout, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_narrow_dw_for_the_baseline_stem_only(dtype):
    """Among every dW of the Baseline, the flagship (stem 259 -> 32) and
    the v2 model (k3 stem 262 -> 32), the k3 convs and the down and up
    convs (8 offsets), only the Baseline's k5 stem 3 -> 32 takes the
    narrow path, in K4 (gather layout and device plans) and in K11 (its
    dense stem)."""
    import chip_smoke as C

    shapes = {name: _dw_shapes(cfg) for name, cfg in (
        ("flagship", C.model_cfg()), ("v2", C.v2_model_cfg()),
        ("baseline", C.baseline_model_cfg()))}
    assert (125, 3, 32) in shapes["baseline"]
    assert any(s[0] == 8 for s in shapes["flagship"])
    picked = {(name, s, kernel) for name, group in shapes.items()
              for s in group
              for kernel, rule in (("K4", k4_takes_narrow),
                                   ("K11", TN.narrow_wgrad_path))
              if rule(*s, dtype)}
    assert picked == {("baseline", (125, 3, 32), "K4"),
                      ("baseline", (125, 3, 32), "K11")}


def test_dispatch_threshold_and_forced_paths():
    """Narrow dW up to ``NARROW_WGRAD_MAX_CIN`` input channels (any Cout:
    column tiles), wide above; a forced narrow path the kernel does not
    take (Cin above its registers' 8) raises, and K4's narrow path takes
    only the gathered-x, identity-dY, unmirrored form."""
    assert TN.NARROW_WGRAD_MAX_CIN <= TN.KERNEL_MAX_CIN
    for dtype in (torch.float32, torch.bfloat16):
        for n_off in (8, 27, 125):
            for cin in range(1, 40):
                for cout in (1, 32, 256):
                    assert TN.narrow_wgrad_path(n_off, cin, cout, dtype) \
                        == (cin <= TN.NARROW_WGRAD_MAX_CIN)
    f32 = torch.float32
    assert TN.pick(None, 125, 3, 32, f32, "k", wgrad=True) is True
    assert TN.pick(False, 125, 3, 32, f32, "k", wgrad=True) is False
    assert TN.pick(True, 27, 8, 1024, f32, "k", wgrad=True) is True
    with pytest.raises(ValueError, match="does not take"):
        TN.pick(True, 125, 9, 32, f32, "k", wgrad=True)
    x, nbr, dy, _ = k4_case(3, 5, True, seed=90)
    for a, ia, b, ib, mirror in ((x, None, dy, nbr, False),
                                 (x, nbr, dy, None, True),
                                 (x, nbr, dy, nbr, False)):
        with pytest.raises(ValueError, match="narrow path takes"):
            TSC.gather_wgrad(a, ia, b, ib, mirror, narrow=True)
    # on the CPU a wrapper runs the plain version whatever the path
    assert torch.equal(TSC.gather_wgrad(x, nbr, dy, None, narrow=True),
                       TSC.gather_wgrad_plain(x, nbr, dy, None, 125,
                                              nbr.shape[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_shared_memory_of_every_admitted_shape_fits(dtype):
    """Every shape ``wgrad_fits`` admits needs at most 227 KB a block (at
    most 41,472 bytes: the im2col tile and one dY tile of 32 columns), its
    chunks hold each offset once in the forward's chunks, the bf16 rows are
    whole 16-byte rows at 80 bytes a dY row; the Baseline's stem needs
    41,472 bytes in fp32 and 24,576 in bf16."""
    admitted = 0
    for n_off in (8, 27, 125):
        for cin in range(1, TN.KERNEL_MAX_CIN + 2):
            for cout in (1, 8, 32, 38, 64, 96, 256, 1024):
                lay = TN.wgrad_layout(n_off, cin, cout, dtype)
                fwd = TN.layout(n_off, cin, cout, dtype)
                assert (lay.g, lay.kc, lay.ast, lay.chunks) == \
                    (fwd.g, fwd.kc, fwd.ast, fwd.chunks)
                covered = [o for c in range(lay.chunks)
                           for o in range(c * lay.g,
                                          min(n_off, (c + 1) * lay.g))]
                assert covered == list(range(n_off))
                if dtype == torch.bfloat16:
                    assert lay.kc % 16 == 0 and lay.kc <= 64
                    assert lay.dst == TN.BN + 8 and lay.ast % 8 == 0
                else:
                    assert lay.kc <= 48 and lay.dst == TN.BN
                fits = TN.wgrad_fits(n_off, cin, cout, dtype)
                smem = TN.wgrad_smem_bytes(n_off, cin, cout, dtype)
                assert smem <= 41472
                assert fits == (cin <= TN.KERNEL_MAX_CIN)
                admitted += fits
    assert admitted == 3 * TN.KERNEL_MAX_CIN * 8
    want = 41472 if dtype == torch.float32 else 24576
    assert TN.wgrad_smem_bytes(125, 3, 32, dtype) == want
