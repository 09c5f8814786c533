"""K1's row-group form (``csrc/live_rows.cuh``, ``gather_conv_rows``) in
plain PyTorch, on the CPU.

On the card the row-group form sums every offset's pairs of a group of
consecutive table rows into the group's fp32 accumulator, with no
pair-major buffer: it finds each group's pairs of an offset as one range
of K4's pair list, from the list's per-word bits and starts
(``gather_pairs``; plain ``gather_pairs_plain``).  Here:

* ``gather_pairs_plain``'s bits and starts against a numpy definition, at
  tables of a row count that is no multiple of 32, that cross a count
  pass's thread block (4,096 rows), with an empty offset, with every
  neighbour absent, and at a plan's k5 stem; and the serving op's CPU
  workspace holding the same;
* a model of the kernel's order (groups of ``group_rows`` rows, offsets
  ascending, each offset's range from the bits and starts) bit-equal in
  fp32 to a model of the pair-major form's order and within ``1e-6 x max``
  of ``gather_conv_plain``, in each of K1's roles on a small plan, at
  group sizes from 32 to 320 rows;
* the form rules ``narrow.gather_form`` and ``narrow.live_form`` over
  shape, dtype, role and level size, and the group sizes
  ``narrow.GROUP_ROWS`` within a block's shared memory with two blocks an
  SM;
* ``gather_conv`` and the model on a two-scene batch's tables against the
  JAX package's ``_subm_conv_impl`` (both branches) and its input
  gradient, from numpy inputs made from a seed, ``rtol = atol = 1e-4``.
"""
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

from segdino3d_tpu.ops import sparse_conv as JSC  # noqa: E402
from segdino3d_tpu.ops.host_plan import \
    build_host_plan as jax_build_host_plan  # noqa: E402
from segdino3d_tpu.ops.host_plan import host_plan_to_device  # noqa: E402
from segdino3d_tpu_torch.ops import custom_ops as TCO  # noqa: E402
from segdino3d_tpu_torch.ops import host_plan as TH  # noqa: E402
from segdino3d_tpu_torch.ops import narrow as TN  # noqa: E402
from segdino3d_tpu_torch.ops import sparse_conv as TSC  # noqa: E402

CAPS = [1024, 512, 256, 128, 64]
REL = 1e-6
TOL = dict(rtol=1e-4, atol=1e-4)
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def _setup():
    load_jax_sparseplan()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed, n=900, box=16, scenes=1):
    rng = np.random.RandomState(seed)
    coords = rng.uniform(0, box, (n * scenes, 3)).astype(np.float32)
    bidx = np.repeat(np.arange(scenes, dtype=np.int32), n)
    return coords, bidx, rng.rand(n * scenes) > 0.05


def _plan(seed=5, scenes=1, caps=CAPS):
    coords, bidx, valid = _points(seed, scenes=scenes)
    return TH.host_plan_to_device(
        TH.build_host_plan(coords, bidx, valid, caps), "cpu")


# --------------------------------------------------------------------------
# the pair list's words
# --------------------------------------------------------------------------

def words_numpy(table):
    """(bits, starts) of a (n_off, V) table by their definition: per offset
    and word w of the count passes' 4,096-row blocks (128 words a block,
    whole), bit i of word w set when row 32 w + i has a neighbour, and the
    offset's rows with a neighbour before row 32 w."""
    live = np.asarray(table) >= 0
    n_off, v = live.shape
    words = max(1, -(-v // 4096)) * 128
    bits = np.zeros((n_off, words), np.uint32)
    starts = np.zeros((n_off, words), np.int64)
    for o in range(n_off):
        for w in range(words):
            rows = live[o, 32 * w:32 * w + 32]
            bits[o, w] = sum(1 << i for i in np.nonzero(rows)[0])
            starts[o, w] = live[o, :32 * w].sum()
    return bits, starts


def _tables():
    rng = np.random.RandomState(11)
    out = {}
    t = rng.randint(-1, 50, (27, 1000)).astype(np.int32)
    t[t > 30] = -1
    t[4] = -1                                  # an empty offset
    out["v1000_empty_offset"] = t
    t = rng.randint(-1, 9000, (3, 4097)).astype(np.int32)
    t[t % 3 == 0] = -1                         # crosses a block
    out["v4097_two_blocks"] = t
    out["all_absent"] = np.full((8, 77), -1, np.int32)
    out["stem_k5"] = _plan().stem_nbr.numpy()
    return out


@pytest.mark.parametrize("name", sorted(_tables()))
def test_pair_words_plain_match_definition(name):
    table = _tables()[name]
    pairs = TSC.gather_pairs_plain(None, torch.from_numpy(table))
    bits, starts = words_numpy(table)
    assert pairs.bits.dtype == pairs.starts.dtype == torch.int32
    got_bits = pairs.bits.numpy().view(np.uint32)
    np.testing.assert_array_equal(got_bits, bits)
    np.testing.assert_array_equal(pairs.starts.numpy(), starts)
    # the word of each listed pair: the pair's index within its offset is
    # its word's start plus the set bits below it in the word
    for o in range(table.shape[0]):
        for j, r in enumerate(pairs.rows[o, :int(pairs.counts[o])].tolist()):
            w, i = divmod(r, 32)
            below = bin(int(bits[o, w]) & ((1 << i) - 1)).count("1")
            assert starts[o, w] + below == j


def test_pair_op_workspace_holds_the_words():
    """The serving export's pair-list op (CPU) writes the bits and starts
    into its workspace, where ``pairs_in`` views them."""
    table = torch.from_numpy(_tables()["v1000_empty_offset"])
    ws = TCO.gather_pairs_op(None, table)
    assert ws.shape[0] == TSC.pair_workspace_size(*table.shape)
    got, want = TSC.pairs_in(ws, *table.shape), TSC.gather_pairs_plain(
        None, table)
    for field in ("rows", "counts", "bits", "starts"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


# --------------------------------------------------------------------------
# a model of the kernel's order
# --------------------------------------------------------------------------

def _products(x, nbr, w, pairs):
    """Each offset's products of its listed rows, in list order."""
    return [x[nbr[o, pairs.rows[o, :int(pairs.counts[o])].long()].long()]
            @ w[o] for o in range(nbr.shape[0])]


def pair_major_model(feats, nbr, weights, valid):
    """K1's pair-major order: each offset's listed products, then each
    valid row's products added in ascending offset order."""
    x, w = TSC.as_sum_type(feats), TSC.as_sum_type(weights)
    pairs = TSC.gather_pairs_plain(None, nbr)
    out = x.new_zeros(nbr.shape[1], w.shape[2])
    for o, p in enumerate(_products(x, nbr, w, pairs)):
        out[pairs.rows[o, :p.shape[0]].long()] += p
    return torch.where(valid[:, None], out, 0.0).to(feats.dtype)


def rows_model(feats, nbr, weights, valid, group_rows):
    """The row-group kernel's order: per group of ``group_rows`` rows an
    fp32 accumulator of zeros takes, offset by offset ascending, the
    products of the offset's pair range, which the list's words give (its
    start, its rows at the set bits, in order); then the group's rows are
    written, 0 outside valid."""
    x, w = TSC.as_sum_type(feats), TSC.as_sum_type(weights)
    n_off, v = nbr.shape
    pairs = TSC.gather_pairs_plain(None, nbr)
    prods = _products(x, nbr, w, pairs)
    bits = pairs.bits.long() & 0xFFFFFFFF
    words = group_rows // 32
    out = x.new_zeros(v, w.shape[2])
    shift = torch.arange(32)
    for g0 in range(0, v, group_rows):
        acc = x.new_zeros(group_rows, w.shape[2])
        w0 = g0 // 32
        for o in range(n_off):
            word = bits[o, w0:w0 + words]
            flags = ((word[:, None] >> shift) & 1).reshape(-1)
            at = torch.nonzero(flags).flatten()
            start = int(pairs.starts[o, w0])
            acc[at] += prods[o][start:start + at.shape[0]]
        n = min(group_rows, v - g0)
        out[g0:g0 + n] = torch.where(valid[g0:g0 + n, None], acc[:n], 0.0)
    return out.to(feats.dtype)


def _roles(plan):
    """(name, nbr, valid, input rows, Cin, Cout) of each K1 call that can
    take the row-group form: the stem, each level's k3 conv and its dX
    (the mirror identity), a down conv over the child table."""
    lv = plan.levels
    v = [t.valid.shape[0] for t in lv]
    widths = [(32, 32), (32, 64), (64, 128), (128, 256), (256, 256)]
    roles = [("stem", plan.stem_nbr, lv[0].valid, v[0], 259, 32)]
    for i, t in enumerate(lv):
        cin, cout = widths[i]
        roles += [(f"k3 L{i}", t.nbr, t.valid, v[i], cin, cout),
                  (f"k3 dX L{i}", t.nbr, t.valid, v[i], cout, cin)]
    roles.append(("down L1", lv[1].child, lv[2].valid, v[1], 32, 64))
    return roles


@pytest.mark.parametrize("group_rows", [32, 96, 160, 256, 320])
def test_rows_model_matches_pair_major_and_plain(group_rows):
    plan = _plan()
    rng = np.random.RandomState(group_rows)
    for name, nbr, valid, rows, cin, cout in _roles(plan):
        n_off = nbr.shape[0]
        x = torch.from_numpy(rng.randn(rows, cin).astype(np.float32))
        w = torch.from_numpy((rng.randn(n_off, cin, cout)
                              / np.sqrt(n_off * cin)).astype(np.float32))
        got = rows_model(x, nbr, w, valid, group_rows)
        assert torch.equal(got, pair_major_model(x, nbr, w, valid)), name
        want = TSC.gather_conv_plain(x, nbr, w, valid)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=REL * float(want.abs().max()),
                                   msg=lambda m: f"{name}: {m}")
        assert not got[~valid].any(), name


# --------------------------------------------------------------------------
# the rules
# --------------------------------------------------------------------------

# (n_off, Cin, Cout) of every K1 call of the flagship, v2 and Baseline
# models' wide paths in every role, and of K10's live-pair convs
K1_SHAPES = [(125, 259, 32), (125, 264, 32), (27, 262, 32), (27, 264, 32),
             (27, 96, 96), (27, 128, 96), (27, 32, 32), (27, 64, 64),
             (27, 192, 128), (27, 128, 128), (27, 384, 256), (27, 256, 256),
             (27, 160, 160), (27, 192, 96), (27, 96, 128), (27, 128, 192),
             (27, 256, 384), (8, 32, 32), (8, 128, 160), (8, 96, 96)]


def _caps():
    return [None, 0, 2304, 13824, 36864, 65536, 92160, 180890, 262144,
            625664, 10 ** 7]


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_gather_form_rule(dtype):
    """K1's form by offsets, widths, dtype, role and table rows: the row
    groups exactly where ``K1_ROW_GROUPS_MIN_CAP`` names the shape and the
    table has at least that many rows (never at an unknown size), else the
    pair-major form."""
    for n_off, cin, cout in K1_SHAPES:
        for dx in (False, True):
            least = TN.K1_ROW_GROUPS_MIN_CAP.get(
                (n_off, cin, cout, dtype, "dx" if dx else "forward"))
            for cap in _caps():
                rows = least is not None and cap is not None and cap >= least
                assert TN.gather_form(n_off, cin, cout, dtype, cap=cap,
                                      dx=dx) == (TN.ROW_GROUPS if rows
                                                 else TN.PAIR_MAJOR), \
                    (n_off, cin, cout, dx, cap)


# shapes the paired measurement never put in row groups: the wide stems
# (they lost on either core), the v2 model's 32-channel convs and the
# flagship's narrower levels (not timed at a large table)
UNTIMED = [(125, 259, 32), (125, 264, 32), (27, 262, 32), (27, 264, 32),
           (27, 32, 32), (27, 64, 64), (27, 128, 128), (27, 192, 96),
           (8, 96, 96)]


@pytest.mark.parametrize("shape", UNTIMED)
def test_gather_form_keeps_untimed_shapes_pair_major(shape):
    """A shape the paired measurement did not time in row groups keeps the
    pair-major form at every table size, in both dtypes and roles: the v2
    model's bf16 k3 stem 264 -> 32 at the batch of 8's 625,664 rows
    too."""
    n_off, cin, cout = shape
    for dt in (F32, BF16):
        for dx in (False, True):
            for cap in _caps():
                assert TN.gather_form(n_off, cin, cout, dt, cap=cap,
                                      dx=dx) == TN.PAIR_MAJOR, (dt, dx, cap)
    assert TN.gather_form(27, 264, 32, BF16, cap=625664) == TN.PAIR_MAJOR


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_live_form_rule_by_cap(dtype):
    """K10's form by kernel size, dtype, role and level: the row groups
    where ``ROW_GROUPS_MIN_CAP`` names the key and the level reaches it;
    a forward the row groups take is on the live-pair path."""
    for k in (3, 5):
        assert TN.live_form(k, dtype) == TN.PAIR_MAJOR
        for dx in (False, True):
            least = TN.ROW_GROUPS_MIN_CAP.get(
                (k, dtype, "dx" if dx else "forward"))
            for cap in _caps():
                rows = least is not None and cap is not None and cap >= least
                assert TN.live_form(k, dtype, dx=dx, cap=cap) == (
                    TN.ROW_GROUPS if rows else TN.PAIR_MAJOR), (k, dx, cap)
                if rows and k == 3:
                    ci, co = (96, 96)
                    assert TN.live_path(27, ci, co, dtype, True, dx=dx,
                                        cap=cap)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_group_rows_fit_two_blocks(dtype):
    """Every conv's group (``narrow.GROUP_ROWS``): whole 32-row words and
    64-pair chunks, a block's shared memory within the card's 227 KB and
    two blocks an SM."""
    r = TN.GROUP_ROWS[dtype]
    assert r % 64 == 0
    for n_off, cin, cout in K1_SHAPES + [(125, 3, 32)]:
        smem = TN.rows_smem_bytes(n_off, cout, dtype)
        assert smem <= TN.SMEM_LIMIT
        assert 2 * (smem + TN.BLOCK_RESERVED_SMEM) <= TN.SM_SMEM_BYTES


def test_rows_smem_matches_layout():
    """``rows_smem_bytes`` by its parts at two shapes: fp32 k3 96 -> 96
    (stages of 64 x 36 and 32 x 96 floats, groups of 64) and the bf16 k5
    stem (stages of 64 x 40 and 32 x 40 bf16, groups of 128)."""
    r = 64
    tables = 4 * (27 * (r // 32 + 2 + 1) + r + 256)
    assert TN.rows_smem_bytes(27, 96, F32) == \
        4 * 2 * (64 * 36 + 32 * 96) + 4 * r * 96 + tables
    r = 128
    tables = 4 * (125 * (r // 32 + 2 + 2) + r + 256)
    assert TN.rows_smem_bytes(125, 32, BF16) == \
        2 * 2 * (64 * 40 + 32 * 40) + 4 * r * 32 + tables


# --------------------------------------------------------------------------
# a two-scene batch against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["im2col", "matmul_first", "dx"])
def test_two_scene_batch_matches_jax(case):
    """A batch of two scenes (batch ids 0 and 1, one plan): the port's
    ``gather_conv`` (the plain version on the CPU) and the row-group model
    at the group size the rule gives against JAX's ``_subm_conv_impl``
    (im2col at 96 -> 96, matmul-first at the 259 -> 32 stem) and, as dX,
    against ``jax.vjp`` of it: the flipped, transposed weights on the
    masked cotangent."""
    coords, bidx, valid = _points(9, scenes=2)
    caps = [2048, 1024, 512, 256, 128]
    jplan, _ = host_plan_to_device(jax_build_host_plan(
        coords, bidx, valid, caps, stem_compact=False), device=False)
    tplan = TH.host_plan_to_device(
        TH.build_host_plan(coords, bidx, valid, caps), "cpu")
    rng = np.random.RandomState(sum(map(ord, case)))
    stem = case == "matmul_first"
    cin, cout = (259, 32) if stem else (96, 96)
    nbr_j = jplan.stem_nbr if stem else jplan.subm_nbr[0]
    nbr = tplan.stem_nbr if stem else tplan.levels[0].nbr
    tvalid, jvalid = tplan.levels[0].valid, jplan.levels[0].valid
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(nbr_j))
    x = rng.randn(caps[0], cin).astype(np.float32)
    w = (rng.randn(nbr.shape[0], cin, cout)
         / np.sqrt(nbr.shape[0] * cin)).astype(np.float32)
    if case == "dx":
        g = rng.randn(caps[0], cout).astype(np.float32)
        _, vjp = jax.vjp(lambda a: JSC._subm_conv_impl(
            a, jnp.asarray(nbr_j), jnp.asarray(w), jnp.asarray(jvalid)),
            jnp.asarray(x))
        want = np.asarray(vjp(jnp.asarray(g))[0])
        dy = torch.where(tvalid[:, None], torch.from_numpy(g), 0.0)
        xt, wt = dy, TSC._transposed(torch.from_numpy(w).flip(0))
        gvalid = tvalid
    else:
        want = np.asarray(JSC._subm_conv_impl(
            jnp.asarray(x), jnp.asarray(nbr_j), jnp.asarray(w),
            jnp.asarray(jvalid)))
        xt, wt, gvalid = torch.from_numpy(x), torch.from_numpy(w), tvalid
    r = TN.GROUP_ROWS[F32]
    for got in (TSC.gather_conv(xt, nbr, wt, gvalid, dx=case == "dx"),
                rows_model(xt, nbr, wt, gvalid, r)):
        if case == "dx":
            # JAX's dX is unmasked; the port's is zero outside valid, as
            # the backward masks it (rows outside valid have no sources)
            got = torch.where(tvalid[:, None], got, 0.0)
            want = np.where(np.asarray(jvalid)[:, None], want, 0.0)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
