"""The narrow-input path of K1 and K10 (``csrc/narrow_tile.cuh``) in plain
PyTorch, on the CPU.

For a few input channels (the Baseline's rgb k5 stem, 3 -> 32) both
kernels stage the whole weight once per thread block and run each tile of
64 output rows through chunks of offsets: a chunk gathers every row's
sources into an im2col tile, (rows) x (offset, channel); in fp32 each
offset's Cin products go into a partial and the partials are added in
ascending offset order, in bf16 the chunk's packed channels go through the
MMA in fp32.  Here:

* a plain model of that schedule (``narrow_model``, over
  ``narrow.layout``'s chunks) against ``gather_conv_plain`` and
  ``dense_subm_conv_plain`` at 1e-6 x max|plain| (Cin 1, 2, 3, 4, 8; k 3,
  5; edges 4, 8; with and without a mask, on a small host plan made from a
  numpy seed), and in bf16 at 1e-2;
* the model against the JAX package's ``_subm_conv_impl`` (its im2col
  branch, K = n_off * Cin) and ``dense_subm_conv`` at 1e-5 x
  max|reference| (the JAX dense conv compiles per shape: a few shapes);
* the dispatch rule (``narrow.narrow_path``, through ``narrow.pick``):
  narrow for the Baseline's stem, wide for every other conv shape of the
  flagship, v2 and Baseline models and its input gradient's role;
* the shared-memory function: the layout's chunks cover each offset once,
  and every shape the rule admits fits in 227 KB.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from segdino3d_tpu.ops import block_dense as JBD  # noqa: E402
from segdino3d_tpu.ops import sparse_conv as JSC  # noqa: E402
from segdino3d_tpu_torch.ops import block_dense as TBD  # noqa: E402
from segdino3d_tpu_torch.ops import host_plan as TH  # noqa: E402
from segdino3d_tpu_torch.ops import narrow as TN  # noqa: E402
from segdino3d_tpu_torch.ops import sparse_conv as TSC  # noqa: E402

CAPS = [1024, 512, 256, 128, 64]
CINS = [1, 2, 3, 4, 8]
COUT = 32
REL_PLAIN = 1e-6
REL_JAX = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed=5, n=900, box=16):
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


def _inputs(rows, cin, n_off, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(rows, cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(n_off, cin, COUT)
                          / np.sqrt(n_off * cin)).astype(np.float32))
    return x, w


def narrow_model(x, src, w, dtype=torch.float32):
    """The narrow core's sums for each output row whose sources are ``src``
    (n_off, R) (-1: absent, zeros), in ``narrow.layout``'s chunks of
    offsets: each chunk's im2col tile A (R, g * Cin); fp32: per offset its
    Cin products into a partial (channels ascending), the partials added in
    ascending offset order; bf16: the chunk's A @ W in fp32 (the MMA's
    sums), rounded to bf16 at the end.  Returns (R, Cout) in ``dtype``."""
    n_off, cin, cout = w.shape
    lay = TN.layout(n_off, cin, cout, dtype)
    xs = x.to(dtype).float()
    ws = w.to(dtype).float()
    acc = xs.new_zeros(src.shape[1], cout)
    for c in range(lay.chunks):
        o0 = c * lay.g
        offs = range(o0, min(n_off, o0 + lay.g))
        a = torch.cat([TSC._gather_rows(xs, src[o]) for o in offs], dim=1)
        if dtype == torch.bfloat16:
            acc += a @ ws[o0:o0 + len(offs)].reshape(-1, cout)
            continue
        for j, o in enumerate(offs):
            part = xs.new_zeros(src.shape[1], cout)
            for ch in range(cin):
                part += a[:, j * cin + ch, None] * ws[o, ch]
            acc += part
    return acc.to(dtype)


def k1_sources(nbr, valid):
    """K1's sources: the table's, none on a row outside ``valid``."""
    return torch.where(valid[None, :], nbr, -1)


def k10_sources(t, k, mask):
    """K10's sources at every dense row: the cell shifted by each offset
    through the block halo; the output rows are the mask's (every row
    without one)."""
    h = (k - 1) // 2
    rows = torch.arange(t.slot_vox.shape[0])
    src = torch.stack([TBD.halo_rows_plain(rows, t.block_nbr, t.edge,
                                           (i - h, j - h, m - h))
                       for i in range(k) for j in range(k)
                       for m in range(k)])
    return src if mask is None else torch.where(mask[None, :], src, -1)


def _close(got, want, rel):
    scale = float(want.float().abs().max())
    assert scale > 0
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=rel * scale)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("cin", CINS)
def test_k1_narrow_model_matches_plain(cin, k, masked):
    """K1's narrow schedule on the k5 stem table and level 0's k3 table
    against the plain version; rows outside ``valid`` (masked: the level's
    valid rows; else every row) are 0."""
    plan = _plan()
    nbr = plan.stem_nbr if k == 5 else plan.levels[0].nbr
    valid = plan.levels[0].valid if masked else \
        torch.ones_like(plan.levels[0].valid)
    x, w = _inputs(CAPS[0], cin, k ** 3, seed=cin * 10 + k)
    got = narrow_model(x, k1_sources(nbr, valid), w)
    want = TSC.gather_conv_plain(x, nbr, w, valid)
    _close(got, want, REL_PLAIN)
    assert not got[~valid].any()


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("edge", [4, 8])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("cin", CINS)
def test_k10_narrow_model_matches_plain(cin, k, edge, masked):
    """K10's narrow schedule on level 0's blocks (its sources through the
    halo) against the plain version, under the occupancy mask or on every
    cell; the input is zero outside the occupancy, as K10's caller has
    it."""
    t = _plan(edge).blocks[0]
    occ = TBD.occupancy(t)
    x, w = _inputs(occ.shape[0], cin, k ** 3, seed=cin * 10 + k + edge)
    x = torch.where(occ[:, None], x, 0.0)
    mask = occ if masked else None
    got = narrow_model(x, k10_sources(t, k, mask), w)
    want = TBD.dense_subm_conv_plain(x, t.block_nbr, w, mask, edge)
    _close(got, want, REL_PLAIN)
    if masked:
        assert not got[~occ].any()


@pytest.mark.parametrize("kernel", ["k1", "k10"])
@pytest.mark.parametrize("cin", [1, 3, 8])
def test_narrow_model_bf16_matches_plain(kernel, cin):
    """The bf16 schedule (packed channels, 16-channel padding, fp32 sums)
    against the plain version in bf16, at the kernels' bf16 tolerance."""
    if kernel == "k1":
        plan = _plan()
        valid = plan.levels[0].valid
        x, w = _inputs(CAPS[0], cin, 125, seed=cin)
        src = k1_sources(plan.stem_nbr, valid)
        want = TSC.gather_conv_plain(x.bfloat16(), plan.stem_nbr,
                                     w.bfloat16(), valid)
    else:
        t = _plan(4).blocks[0]
        occ = TBD.occupancy(t)
        x, w = _inputs(occ.shape[0], cin, 125, seed=cin + 1)
        x = torch.where(occ[:, None], x, 0.0)
        src = k10_sources(t, 5, occ)
        want = TBD.dense_subm_conv_plain(x.bfloat16(), t.block_nbr,
                                         w.bfloat16(), occ, 4)
    got = narrow_model(x, src, w, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("cin", CINS)
def test_k1_narrow_model_matches_jax_im2col(cin, k):
    """The model against the JAX package's ``_subm_conv_impl``, whose
    branch for ``cin <= 2 * cout`` is the im2col GEMM of K = n_off * Cin
    that the narrow path tiles."""
    plan = _plan()
    nbr = plan.stem_nbr if k == 5 else plan.levels[0].nbr
    valid = plan.levels[0].valid
    assert cin <= 2 * COUT
    x, w = _inputs(CAPS[0], cin, k ** 3, seed=100 + cin)
    want = np.array(JSC._subm_conv_impl(
        jnp.asarray(x.numpy()), jnp.asarray(nbr.numpy()),
        jnp.asarray(w.numpy()), jnp.asarray(valid.numpy())))
    _close(narrow_model(x, k1_sources(nbr, valid), w), torch.from_numpy(want),
           REL_JAX)


@pytest.mark.parametrize("edge,k", [(4, 5), (8, 3)])
@pytest.mark.parametrize("cin", [1, 3, 8])
def test_k10_narrow_model_matches_jax_dense_conv(cin, edge, k):
    """The model against the JAX package's ``dense_subm_conv`` (halo
    padding and one VALID conv, under the occupancy)."""
    t = _plan(edge).blocks[0]
    occ = TBD.occupancy(t)
    x, w = _inputs(occ.shape[0], cin, k ** 3, seed=200 + cin + edge + k)
    x = torch.where(occ[:, None], x, 0.0)
    jt = JBD.BlockTables(jnp.asarray(t.vox_slot.numpy()),
                         jnp.asarray(t.block_nbr.numpy()), edge,
                         jnp.asarray(t.slot_vox.numpy()))
    want = np.array(JBD.dense_subm_conv(
        jnp.asarray(x.numpy()), jnp.asarray(occ.numpy()), jt,
        jnp.asarray(w.numpy())))
    _close(narrow_model(x, k10_sources(t, k, occ), w),
           torch.from_numpy(want), REL_JAX)


def _conv_shapes(cfg):
    """(n_off, Cin, Cout) of every conv of a model's backbone, forward."""
    from segdino3d_tpu_torch.builder import Capacities, build_model

    model, _ = build_model(cfg, Capacities(num_superpoints=64,
                                           num_voxels=1024), device="cpu")
    return {tuple(p.shape) for p in model.backbone.parameters()
            if p.dim() == 3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_narrow_for_the_baseline_stem_only(dtype):
    """The rule picks the narrow path for the Baseline's k5 stem (3 -> 32)
    alone: every other conv of the Baseline, the flagship (stem 259 -> 32)
    and the v2 model (k3 stem 262 -> 32), the down convs (8 offsets) and
    every input gradient's role (Cin and Cout swapped) take today's path."""
    import chip_smoke as C

    shapes = {name: _conv_shapes(cfg) for name, cfg in (
        ("flagship", C.model_cfg()), ("v2", C.v2_model_cfg()),
        ("baseline", C.baseline_model_cfg()))}
    assert (125, 3, 32) in shapes["baseline"]
    assert (125, 259, 32) in shapes["flagship"]
    assert (27, 262, 32) in shapes["v2"]
    picked = {(name, s, role) for name, group in shapes.items()
              for n_off, cin, cout in group
              for s, role in (((n_off, cin, cout), "forward"),
                              ((n_off, cout, cin), "dX"))
              if TN.narrow_path(*s, dtype)}
    assert picked == {("baseline", (125, 3, 32), "forward")}


def test_dispatch_threshold():
    """Narrow up to ``NARROW_MAX_CIN`` input channels where the block fits,
    wide above it, at k3 and k5."""
    for dtype in (torch.float32, torch.bfloat16):
        for n_off in (27, 125):
            for cin in range(1, 40):
                assert TN.narrow_path(n_off, cin, 32, dtype) == (
                    cin <= TN.NARROW_MAX_CIN
                    and TN.narrow_fits(n_off, cin, 32, dtype))
    assert TN.narrow_path(125, 3, 32, torch.float32)
    assert not TN.narrow_path(125, 3, 1024, torch.float32)   # 1.5 MB weight


def test_pick_follows_the_rule_unless_forced():
    """The wrappers' choice: the rule by default; a forced path as given,
    and a forced narrow path the kernel does not take (Cin above its
    registers' 8, or a block past 227 KB) raises."""
    f32 = torch.float32
    assert TN.pick(None, 125, 3, 32, f32, "k") is True
    assert TN.pick(None, 125, 259, 32, f32, "k") is False
    assert TN.pick(False, 125, 3, 32, f32, "k") is False
    assert TN.pick(True, 27, 8, 32, f32, "k") is True   # past the rule
    for cin, cout in ((9, 32), (3, 1024)):
        with pytest.raises(ValueError, match="does not take"):
            TN.pick(True, 125, cin, cout, f32, "k")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shared_memory_of_every_admitted_shape_fits(dtype):
    """Every shape ``narrow_fits`` admits needs at most 227 KB a block, and
    its layout's chunks hold each offset once, the bf16 chunks in whole
    16-channel steps and 16-byte rows, the fp32 im2col rows at an odd
    stride; the Baseline's stem needs 74,112 bytes in fp32 and 46,080 in
    bf16."""
    admitted = 0
    for n_off in (8, 27, 125):
        for cin in range(1, TN.KERNEL_MAX_CIN + 2):
            for cout in (1, 8, 24, 32, 40, 64, 96, 128, 256):
                lay = TN.layout(n_off, cin, cout, dtype)
                assert lay.g * (lay.chunks - 1) < n_off <= lay.g * lay.chunks
                assert lay.g <= TN.MAX_G and lay.g * TN.BM <= 16 * 128
                assert lay.kc >= lay.g * cin and lay.wst >= cout
                if dtype == torch.bfloat16:
                    assert lay.kc % 16 == 0 and lay.ast % 8 == 0 \
                        and lay.wst % 8 == 0
                    assert lay.kp == lay.chunks * lay.kc
                else:
                    assert lay.ast % 2 == 1 and lay.kp == n_off * cin
                fits = TN.narrow_fits(n_off, cin, cout, dtype)
                smem = TN.smem_bytes(n_off, cin, cout, dtype)
                assert fits == (cin <= TN.KERNEL_MAX_CIN
                                and smem <= TN.SMEM_LIMIT)
                admitted += fits
    assert admitted > 100
    assert TN.SMEM_LIMIT == 227 * 1024
    want = 74112 if dtype == torch.float32 else 46080
    assert TN.smem_bytes(125, 3, 32, dtype) == want
