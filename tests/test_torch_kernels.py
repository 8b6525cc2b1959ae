"""The port's placement kernels against nomad_tpu's, on the CPU.

Every input is made from a seeded numpy generator and handed to both the
JAX function (nomad_tpu.scheduler.tpu, jitted on the CPU backend as the
rest of the suite runs it) and its counterpart in nomad_tpu_torch, whose
wrappers run their plain PyTorch twins on CPU tensors. Placements
(inst, over, used') are held exact (np.testing.assert_array_equal), the
bar tests/test_tpu_solver.py sets for the microsolve, and so are the f32
scores: the twin's exp and score tail round as XLA's CPU backend rounds
them (kernels.xla_exp, kernels.fma_f32). The CUDA kernels themselves run
only on the card and are held against these same twins by
chip_smoke.py.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nomad_tpu.scheduler.tpu import kernels as jk
from nomad_tpu.scheduler.tpu import solver as jsolver
from nomad_tpu_torch.scheduler.gpu import kernels as tk
from nomad_tpu_torch.scheduler.gpu import libkernels

# six xdist workers share the machine: keep torch's intra-op pool small
torch.set_num_threads(2)


def _c1k_problem(rng, n=1024, g=48):
    """The shape of tests/test_tpu_solver.py _c1k_problem: random but
    reproducible padded problem."""
    cap = rng.integers(2000, 8000, size=(n, 3)).astype(np.int32)
    used = (cap * rng.uniform(0.0, 0.5, size=(n, 3))).astype(np.int32)
    asks = rng.integers(100, 600, size=(g, 3)).astype(np.int32)
    counts = rng.integers(1, 120, size=g).astype(np.int32)
    feas = rng.random((g, n)) > 0.15
    bias = (rng.random((g, n)) * 0.2).astype(np.float32)
    ucap = np.full((g, n), 1 << 30, dtype=np.int32)
    return cap, used, asks, counts, feas, bias, ucap


def _compact_args(cap, used, asks, counts, feas, bias, ucap):
    """Dense per-group rows -> the compact kernel's deduped argument
    list (identity row index per group, feasibility bit-packed)."""
    g = asks.shape[0]
    idx = np.arange(g, dtype=np.int32)
    return (cap, used, asks, counts, np.packbits(feas, axis=1), idx,
            bias, idx, ucap, idx)


def _both(args, max_count):
    ji, jo, ju = jk.solve_placement_compact(*args, max_count=max_count)
    ti, to, tu = tk.solve_placement_compact(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in args],
        max_count=max_count,
    )
    return (np.asarray(ji), np.asarray(jo), np.asarray(ju)), (
        ti.numpy(), to.numpy(), tu.numpy()
    )


def _assert_same(ref, got):
    for name, r, t in zip(("inst", "over", "used'"), ref, got):
        np.testing.assert_array_equal(t, r, err_msg=name)


# ---------------------------------------------------------------------------
# pad helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["pad_n", "pad_g", "pad_c"])
def test_pad_helpers_match_reference(fn):
    for x in list(range(0, 5000)) + [10000, 10240, 10241, 50000, 100000]:
        assert getattr(tk, fn)(x) == getattr(jk, fn)(x), (fn, x)


def test_c2m_bucket():
    assert tk.pad_n(10000) == 10240
    assert tk.pad_c(1000) == 1024


# ---------------------------------------------------------------------------
# K1: solve_placement_compact
# ---------------------------------------------------------------------------


def test_compact_matches_reference_c1k_seed0():
    rng = np.random.default_rng(0)
    prob = _c1k_problem(rng)
    maxc = jk.pad_c(int(prob[3].max()))
    ref, got = _both(_compact_args(*prob), maxc)
    _assert_same(ref, got)
    assert (ref[0] >= 0).sum() > 1000  # it placed something real


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_compact_matches_reference_micro_seeds(seed):
    """The micro problems of tests/test_tpu_solver.py:1470 at pad 256:
    small integer caps (i16 unit-cap rows, as the solver ships them)."""
    rng = np.random.default_rng(seed)
    n, g = 24, 5
    np_, gp = jk.pad_n(n), jk.pad_g(g)
    cap = np.zeros((np_, 3), dtype=np.int32)
    used = np.zeros((np_, 3), dtype=np.int32)
    cap[:n] = rng.integers(500, 4000, (n, 3))
    used[:n] = rng.integers(0, 400, (n, 3))
    asks = np.zeros((gp, 3), dtype=np.int32)
    counts = np.zeros(gp, dtype=np.int32)
    feas = np.zeros((gp, np_), dtype=bool)
    bias = np.zeros((gp, np_), dtype=np.float32)
    ucap = np.zeros((gp, np_), dtype=np.int16)
    for i in range(g):
        asks[i] = rng.integers(1, 400, 3)
        counts[i] = int(rng.integers(1, 9))
        feas[i, :n] = rng.random(n) > 0.2
        bias[i, :n] = rng.uniform(0.0, 0.5, n).astype(np.float32)
        ucap[i, :n] = rng.integers(0, 12, n)
    maxc = jk.pad_c(int(counts.max()))
    ref, got = _both(
        _compact_args(cap, used, asks, counts, feas, bias, ucap), maxc
    )
    _assert_same(ref, got)


def test_compact_matches_reference_c2m_shape():
    """The c2m node bucket (pad_n(10000) = 10240) with 64 groups."""
    rng = np.random.default_rng(23)
    n = jk.pad_n(10000)
    prob = _c1k_problem(rng, n=n, g=64)
    maxc = jk.pad_c(int(prob[3].max()))
    ref, got = _both(_compact_args(*prob), maxc)
    _assert_same(ref, got)


def test_compact_negative_free_capacity_floors():
    """used > cap: jnp's '//' floors a negative free count where C's '/'
    truncates toward zero (-1 // 500 == -1, but -1 / 500 == 0 in C).
    Both clamp to 0 units, so no instance may land on such a node; the
    kernel's floor_div (csrc/solve_compact.cu) keeps the floor form."""
    rng = np.random.default_rng(5)
    prob = list(_c1k_problem(rng, n=256, g=8))
    cap, used = prob[0], prob[1]
    over_rows = rng.random(256) < 0.3
    used[over_rows] = cap[over_rows] + rng.integers(1, 700, (int(over_rows.sum()), 3))
    assert (cap - used < 0).any()
    assert ((cap - used) // 500 < 0).any()  # the floor/trunc split exists
    maxc = jk.pad_c(int(prob[3].max()))
    ref, got = _both(_compact_args(*prob), maxc)
    _assert_same(ref, got)
    placed_nodes = set(got[0][got[0] >= 0].tolist())
    assert not placed_nodes & set(np.nonzero(over_rows)[0].tolist())


def test_compact_exact_ties_go_to_lower_index():
    """An all-homogeneous cluster: every node scores the same, so the
    waterfill order is pure tie-breaking (lower node index first)."""
    n, g = 512, 8
    cap = np.full((n, 3), 4000, dtype=np.int32)
    used = np.zeros((n, 3), dtype=np.int32)
    asks = np.tile(np.array([[500, 256, 150]], dtype=np.int32), (g, 1))
    counts = np.array([37, 100, 8, 1, 64, 0, 250, 3], dtype=np.int32)
    feas = np.ones((g, n), dtype=bool)
    bias = np.zeros((g, n), dtype=np.float32)
    ucap = np.full((g, n), 1 << 30, dtype=np.int32)
    maxc = jk.pad_c(int(counts.max()))
    ref, got = _both(
        _compact_args(cap, used, asks, counts, feas, bias, ucap), maxc
    )
    _assert_same(ref, got)
    # the first group packs node 0 full (8 x 500 MHz), then node 1, ...
    assert got[0][0][:9].tolist() == [0] * 8 + [1]


def test_compact_wrapper_runs_twin_on_cpu_without_launching():
    rng = np.random.default_rng(3)
    prob = _c1k_problem(rng, n=256, g=8)
    args = [torch.from_numpy(a) for a in _compact_args(*prob)]
    before = tk.solve_placement_compact.launches
    out = tk.solve_placement_compact(*args, max_count=128)
    plain = tk.solve_placement_compact_plain(*args, max_count=128)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert tk.solve_placement_compact.launches == before
    # used' is fresh: the input usage is committed state
    assert not torch.equal(out[2], args[1])
    assert torch.equal(args[1], torch.from_numpy(prob[1]))


def _ulp_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in units of the last place between two f32 arrays (same
    sign everywhere here)."""
    ai = a.astype(np.float32).view(np.int32).astype(np.int64)
    bi = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def test_exp_within_two_ulp_of_reference():
    """torch's own exp, which the twin does not use, is a different
    implementation from XLA's (1 ulp apart on ~9% of inputs): the reason
    the twin carries xla_exp."""
    import jax

    rng = np.random.default_rng(13)
    x = rng.uniform(-3.0, 2.4, 10**5).astype(np.float32)
    ref = np.asarray(jax.jit(jax.numpy.exp)(x))
    got = torch.exp(torch.from_numpy(x)).numpy()
    assert _ulp_gap(ref, got).max() <= 2


def test_twin_exp_equals_reference():
    """kernels.xla_exp against jax.jit(jnp.exp) on the CPU, bit for bit:
    10^7 seeded arguments over [-88.4, LN10] (the exp's whole input range
    in _score_nodes, subnormal results included, which XLA flushes to
    zero) and every f32 in [0.5, 2.31)."""
    import jax

    rng = np.random.default_rng(17)
    lo = np.float32(0.5).view(np.int32)
    hi = np.float32(2.31).view(np.int32)
    every = np.arange(lo, hi, dtype=np.int32).view(np.float32)
    x = np.concatenate([
        rng.uniform(-88.4, tk.LN10, 10**7).astype(np.float32), every,
    ])
    jexp = jax.jit(jax.numpy.exp)
    chunk = 1 << 21
    for i in range(0, x.shape[0], chunk):
        part = x[i:i + chunk]
        ref = np.asarray(jexp(part))
        got = tk.xla_exp(torch.from_numpy(part)).numpy()
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_scores_within_two_ulp_of_reference():
    """score = clip(20 - 10^fc - 10^fm, 0, 18)/18 + bias in f32, held bit
    for bit to jax.jit(_score_nodes) on the CPU: caps from 0 (the
    max(cap, 1) guard), usage up to 120% of capacity, bias in [0, 0.3)."""
    import jax

    rng = np.random.default_rng(11)
    n = 20000
    cap = rng.integers(0, 9000, (n, 3)).astype(np.float32)
    used = (cap * rng.uniform(0.0, 1.2, (n, 3))).astype(np.int32).astype(
        np.float32
    )
    ask = np.array([250.0, 128.0, 0.0], dtype=np.float32)
    bias = (rng.random(n) * 0.3).astype(np.float32)
    ref = np.asarray(jax.jit(jk._score_nodes)(cap, used, ask, bias))
    got = tk.score_nodes(
        torch.from_numpy(cap), torch.from_numpy(used),
        torch.from_numpy(ask), torch.from_numpy(bias),
    ).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_unpack_rows_msb_first():
    rng = np.random.default_rng(2)
    bits = rng.random((5, 77)) > 0.5
    packed = np.packbits(bits, axis=1)
    got = tk.unpack_rows(torch.from_numpy(packed), 77).numpy()
    np.testing.assert_array_equal(got, bits)


# ---------------------------------------------------------------------------
# K2 / K3: the row scatters
# ---------------------------------------------------------------------------


def _scatter_problem(seed, n=1024, b=300):
    rng = np.random.default_rng(seed)
    used = rng.integers(0, 5000, (n, 3)).astype(np.int32)
    idx = rng.choice(n, size=b, replace=False).astype(np.int32)
    rows = rng.integers(-3000, 3000, (b, 3)).astype(np.int32)
    return used, idx, rows


@pytest.mark.parametrize("donate", [True, False])
def test_scatter_rows_matches_reference(donate):
    used, idx, rows = _scatter_problem(1)
    rows = np.abs(rows)
    ref = np.asarray(
        jsolver._scatter_rows(used.copy(), idx, rows, donate=donate)
    )
    pidx, prows = jsolver._pad_scatter_args(idx, rows)
    assert pidx.shape[0] == 1024 and (pidx[300:] == 1 << 30).all()
    used_t = torch.from_numpy(used.copy())
    out = tk.scatter_rows(
        used_t, torch.from_numpy(pidx), torch.from_numpy(prows), donate
    )
    np.testing.assert_array_equal(out.numpy(), ref)
    if donate:
        assert out is used_t  # written in place
    else:
        np.testing.assert_array_equal(used_t.numpy(), used)


def test_scatter_add_rows_matches_reference():
    used, idx, rows = _scatter_problem(2)
    ref = np.asarray(jsolver._scatter_add_rows(used.copy(), idx, rows))
    assert (ref == 0).any()  # negative deltas hit the clamp
    pidx, prows = jsolver._pad_scatter_args(idx, rows)
    used_t = torch.from_numpy(used.copy())
    out = tk.scatter_add_rows(
        used_t, torch.from_numpy(pidx), torch.from_numpy(prows)
    )
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(used_t.numpy(), used)  # fresh output


def test_scatter_add_clamps_the_whole_array():
    """The reference clamps every row, not just the touched ones."""
    used = np.array([[-5, 3, 0], [7, -1, 2], [1, 1, 1]], dtype=np.int32)
    idx = np.array([2], dtype=np.int32)
    rows = np.array([[-4, 0, 9]], dtype=np.int32)
    ref = np.asarray(jsolver._scatter_add_rows(used, idx, rows))
    pidx, prows = jsolver._pad_scatter_args(idx, rows)
    out = tk.scatter_add_rows(
        torch.from_numpy(used), torch.from_numpy(pidx),
        torch.from_numpy(prows),
    )
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out.numpy().tolist() == [[0, 3, 0], [7, 0, 2], [0, 1, 10]]


def test_scatter_repeated_and_negative_indices():
    """mode="drop" semantics beyond the solver's own use: a negative
    index counts from the end, a repeated one sums in the add flavor."""
    used = np.arange(24, dtype=np.int32).reshape(8, 3)
    idx = np.array([-1, 3, 3, 1 << 30, -9], dtype=np.int32)
    rows = np.full((5, 3), 10, dtype=np.int32)
    ref = np.asarray(jsolver._scatter_add_rows(used, idx, rows))
    out = tk.scatter_add_rows(
        torch.from_numpy(used), torch.from_numpy(idx), torch.from_numpy(rows)
    )
    np.testing.assert_array_equal(out.numpy(), ref)
    ref_set = np.asarray(
        jsolver._scatter_rows(used, idx[:2], rows[:2], donate=False)
    )
    out_set = tk.scatter_rows(
        torch.from_numpy(used.copy()), torch.from_numpy(idx[:2]),
        torch.from_numpy(rows[:2]), donate=False,
    )
    np.testing.assert_array_equal(out_set.numpy(), ref_set)


def _scatter_add_case(name):
    """The cases K3's one-launch kernel (one block per 256-row range of the
    output) routes on, at a small size."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n, b = 1024, 300
    used = rng.integers(0, 5000, (n, 3)).astype(np.int32)
    rows = rng.integers(-3000, 3000, (b, 3)).astype(np.int32)
    if name == "repeated":
        idx = rng.choice(20, size=b).astype(np.int32)
    elif name == "negative":
        idx = rng.integers(-n - 20, 0, b).astype(np.int32)
        idx[:3] = [-n, -1, -n - 1]
    elif name == "pad":
        idx = np.full(b, 1 << 30, dtype=np.int32)
        idx[:100] = rng.choice(n, 100, replace=False)
    elif name == "rows_past_a_block":
        b = 2048
        idx = rng.integers(0, n, b).astype(np.int32)
        rows = rng.integers(-3000, 3000, (b, 3)).astype(np.int32)
    elif name == "untouched_negative":
        used = rng.integers(-3000, 5000, (n, 3)).astype(np.int32)
        idx = rng.choice(n // 2, b, replace=False).astype(np.int32)
    else:  # partial_last_block: 1000 rows, the last range holds 232
        used = used[:1000]
        idx = rng.integers(900, 1000, b).astype(np.int32)
    return used, idx, rows


@pytest.mark.parametrize("name", [
    "repeated", "negative", "pad", "rows_past_a_block", "untouched_negative",
    "partial_last_block",
])
def test_scatter_add_rows_edge_cases_match_reference(name):
    used, idx, rows = _scatter_add_case(name)
    ref = np.asarray(jsolver._scatter_add_rows(used.copy(), idx, rows))
    assert (ref == 0).any()
    out = tk.scatter_add_rows(
        torch.from_numpy(used.copy()), torch.from_numpy(idx),
        torch.from_numpy(rows),
    )
    np.testing.assert_array_equal(out.numpy(), ref)


# ---------------------------------------------------------------------------
# the kernel build
# ---------------------------------------------------------------------------


def test_kernel_sources_and_flags():
    names = {p.name for p in libkernels.sources()}
    assert names == {"solve_compact.cu", "solve_dense.cu", "scatter_rows.cu",
                     "solve_sharded.cu"}
    assert {p.name for p in libkernels.headers()} == {"solve_common.cuh"}
    flags = " ".join(libkernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags and "fast_math" not in flags
    for name in ("solve_compact.cu", "solve_dense.cu", "solve_sharded.cu",
                 "solve_common.cuh"):
        src = (libkernels.CSRC / name).read_text()
        assert "__expf" not in src and "__fdividef" not in src
    # K4 and K5 share one cluster kernel; the add is one kernel, one launch
    dense = (libkernels.CSRC / "solve_dense.cu").read_text()
    assert "solve_placement_kernel" in dense
    assert "solve_dense_kernel" not in dense and "block_argmax" not in dense
    scatter = (libkernels.CSRC / "scatter_rows.cu").read_text()
    add = scatter[scatter.index('"C" int nomad_scatter_add_rows'):]
    assert add.count("<<<") == 1 and "scatter_add_clamp_kernel<<<" in add


def test_launch_counters_reset():
    tk.solve_placement_compact.launches = 3
    tk.sharded_solver.launches = 2
    tk.reset_launch_counts()
    assert [fn.launches for fn in tk.KERNELS] == [0] * 7


# ---------------------------------------------------------------------------
# the waterfill as a unit-weighted radix select (K5's and K7's kernels)
# ---------------------------------------------------------------------------


def _score_key_mirror(x: float) -> int:
    """csrc/solve_common.cuh score_bits written out for one f32."""
    b = int(np.float32(x).view(np.uint32))
    if b & 0x7FFFFFFF == 0:
        b = 0  # -0.0
    return (~b & 0xFFFFFFFF) if b & 0x80000000 else (b | 0x80000000)


def test_score_key_ties_signed_zeros_and_orders_scores():
    """The select's key gives -0.0 the key of +0.0 (better() and the
    stable sort tie them), and orders every other f32 as its value."""
    rng = np.random.default_rng(3)
    vals = np.concatenate([
        np.array([0.0, -0.0, 1e-45, -1e-45, 1.17549435e-38, -np.inf, np.inf,
                  jk.NEG_INF, 1.0, np.nextafter(np.float32(1.0), 2)],
                 dtype=np.float32),
        rng.standard_normal(500).astype(np.float32),
        (rng.random(500) * 1.2).astype(np.float32),
    ])
    keys = tk.score_key(torch.from_numpy(vals)).numpy()
    assert [int(k) for k in keys] == [_score_key_mirror(v) for v in vals]
    assert keys[0] == keys[1] == 0x80000000
    order = np.argsort(vals, kind="stable")
    for a, b in zip(order[:-1], order[1:]):
        assert (keys[a] < keys[b]) == (vals[a] < vals[b])
        assert (keys[a] == keys[b]) == (vals[a] == vals[b])


def _three_waterfills(score, units, count):
    """nomad_tpu's _waterfill (JAX on the CPU), the port's _waterfill and
    waterfill_select_plain on the same inputs."""
    ref = np.asarray(jk._waterfill(jnp.asarray(score), jnp.asarray(units),
                                   jnp.int32(count)))
    ts, tu = torch.from_numpy(score), torch.from_numpy(units)
    port = tk._waterfill(ts, tu, torch.tensor(count, dtype=torch.int32))
    sel = tk.waterfill_select_plain(ts, tu, count)
    return ref, port.numpy(), sel.numpy()


def _waterfill_case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n = 257
    score = rng.choice(np.float32([0.2, 0.5, 0.7, 0.9]), n)
    units = rng.integers(1, 6, n).astype(np.int32)
    count = int(units.sum()) // 2
    if name == "all_tied":
        score[:] = np.float32(0.7)
    elif name == "boundary_inside_tied_run":
        score = np.float32([0.9] * 40 + [0.5] * 177 + [0.1] * 40)
        units = np.full(n, 2, dtype=np.int32)
        count = 80 + 101  # 40 top nodes, then 50.5 of the tied run
    elif name == "one_unit_nodes":
        units[:] = 1
    elif name == "count_past_total":
        count = int(units.sum()) + 10
    elif name == "count_equals_total":
        count = int(units.sum())
    elif name == "count_zero":
        count = 0
    elif name == "neg_inf_without_units":
        units[rng.random(n) < 0.4] = 0
        score[units == 0] = np.float32(jk.NEG_INF)
    elif name == "signed_zero_ties":
        score = rng.choice(np.float32([0.0, -0.0, 0.3]), n)
    elif name == "bin_holds_the_need":
        # the top score's units are exactly the count: the select stops at
        # its bin
        count = int(units[score == score.max()].sum())
    elif name == "spread_scores":
        n = 10240
        score = (rng.random(n) * 1.2).astype(np.float32)
        units = rng.integers(0, 11, n).astype(np.int32)
        score[units == 0] = np.float32(jk.NEG_INF)
        count = int(units.sum()) // 3
    return score, units, count


@pytest.mark.parametrize("name", [
    "all_tied", "boundary_inside_tied_run", "one_unit_nodes",
    "count_past_total", "count_equals_total", "count_zero",
    "neg_inf_without_units", "signed_zero_ties", "bin_holds_the_need",
    "spread_scores",
])
def test_waterfill_select_matches_reference(name):
    ref, port, sel = _three_waterfills(*_waterfill_case(name))
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(sel, ref)


@st.composite
def _waterfill_inputs(draw):
    n = draw(st.integers(1, 80))
    pool = draw(st.lists(st.floats(-2.0, 2.0, width=32), min_size=1,
                         max_size=4)) + [0.0, -0.0]
    score = np.array(draw(st.lists(st.sampled_from(pool), min_size=n,
                                   max_size=n)), dtype=np.float32)
    units = np.array(draw(st.lists(st.integers(0, 9), min_size=n,
                                   max_size=n)), dtype=np.int32)
    if draw(st.booleans()):
        score[units == 0] = np.float32(jk.NEG_INF)
    count = draw(st.integers(0, int(units.sum()) + 3))
    return score, units, count


@settings(max_examples=150, deadline=None)
@given(_waterfill_inputs())
def test_waterfill_select_matches_reference_property(inputs):
    """Scores drawn from a few values and both zeros (long tied runs),
    units from 0 to 9, any count up to past the total."""
    ref, port, sel = _three_waterfills(*inputs)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(sel, ref)
