"""Placement kernels: vectorized ScoreFit + capacity waterfill, on the card.

The batch solver places a whole batch of task groups in one device
program instead of the reference's per-alloc iterator chain (reference:
scheduler/rank.go BinPackIterator.Next :193):

  for each group g (in priority order):
      units[n]  = how many instances of g fit on node n     (int division)
      score[n]  = normalized bin-pack ScoreFit + bias        (vectorized)
      place `count_g` instances onto the best-scored nodes   (waterfill)
      node_used += placed * ask_g

Scores use the reference formula (structs/funcs.go:237):
score = 20 - 10^freeCpu - 10^freeMem, normalized to [0,1]; bias
(affinity/spread) is added on top. All shapes are padded to buckets
(pad_n/pad_g/pad_c) so the solver's shapes stay stable across batches.

Seven kernels, each a hand-written CUDA kernel (csrc/) behind a wrapper
here with a plain PyTorch twin beside it:

  * solve_placement_compact — the scan with a compact [G, maxC] instance
                              readback (csrc/solve_compact.cu);
  * solve_placement         — the scan with the dense [G, N] assignment
                              (csrc/solve_dense.cu): a custom solve_fn
                              and the retry after a preemption batch;
  * solve_placement_preempt — the two-phase scan that places on the
                              preemptible tiers' capacity too
                              (csrc/solve_dense.cu);
  * scatter_rows            — the row set-scatter that keeps the resident
                              usage tensor current (csrc/scatter_rows.cu);
  * scatter_add_rows        — the clamped row scatter-add that applies
                              usage deltas to a chained used' tensor;
  * sharded_solver          — the node-sharded solve of the mesh route
                              (csrc/solve_sharded.cu) in its full, top-k
                              and compact modes;
  * sharded_solver_preempt  — the node-sharded preemption solve
                              (csrc/solve_sharded.cu).

A wrapper runs the plain twin only for tensors on the CPU. For CUDA
tensors it launches its kernel on the current stream or raises; it never
falls back. Each wrapper counts its launches in ``<wrapper>.launches``,
under one lock: solver-pool members in one process launch from several
threads at once, and their counts must come out exact.
"""

from __future__ import annotations

import ctypes
import threading
import time

import torch

from . import libkernels

NUM_RES = 3
NEG_INF = -1e30
LN10 = 2.302585092994046


def _pad_to(x: int, bucket: int) -> int:
    return ((x + bucket - 1) // bucket) * bucket


def pad_n(n: int) -> int:
    """Node-axis bucket: powers of two up to 2048, then multiples of 2048.

    Power-of-two buckets alone waste up to ~2x work at the top (10k nodes
    padded to 16384 is 64% dead lanes on every scan step); 2048-granular
    buckets cap the waste at <20% while staying multiples of 8 devices x
    128 lanes for the sharded solver and the VPU alike. Recompiles happen
    once per bucket and amortize across the server's lifetime exactly as
    before.
    """
    size = 256
    while size < n and size < 2048:
        size *= 2
    if n <= size:
        return size
    return _pad_to(n, 2048)


def pad_g(g: int) -> int:
    """Group-axis bucket: multiples of 8."""
    return max(8, _pad_to(g, 8))


def pad_c(c: int) -> int:
    """Instance-count bucket for the compact readback: power of two >= 16."""
    size = 16
    while size < c:
        size *= 2
    return size


# ---------------------------------------------------------------------------
# K1: the compact placement solve
# ---------------------------------------------------------------------------


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def flush_denormal(x: torch.Tensor) -> torch.Tensor:
    """x with every value below the smallest normal f32 in magnitude made
    +0.0: XLA computes and compares f32 with denormals off, so its sort
    ties a denormal score with zero."""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny,
                       torch.zeros_like(x), x)


def fma_f32(a, b, c):
    """a * b + c on f32 tensors with one rounding, as a fused multiply-add
    (the card's __fmaf_rn) rounds it. The f32 product is exact in f64;
    the f64 sum is rounded to odd (TwoSum gives its error, and an inexact
    sum whose last bit is even moves one f64 ulp toward the exact value),
    so the final f64 -> f32 rounding cannot round twice."""
    p = a.double() * b.double()
    cd = c.double().expand_as(p)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=s.device)
    odd = torch.nextafter(s, torch.where(err > 0, inf, -inf))
    even = (s.view(torch.int64) & 1) == 0
    return torch.where((err != 0) & even, odd, s).float()


# Cephes expf: the exp XLA's CPU backend emits for f32, which jnp.exp
# (and so _score_nodes) computes bit for bit
_EXP_CLAMP = 88.3762626647949
_LOG2E = 1.44269504088896341
_EXP_C1 = -0.693359375
_EXP_C2 = 2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _pow2(e):
    """2.0 ** e as f32 for integer tensors e in [-126, 127]."""
    return ((e + 127) << 23).view(torch.float32)


def xla_exp(x):
    """f32 exp rounded as XLA's CPU backend rounds it: clamp, fx =
    floor(x*log2e + 0.5), a two-step fused reduction, the degree-5
    Horner polynomial with a fused step at each term, ldexp, and results
    below the smallest normal flushed to zero (XLA runs with denormals
    off). csrc/solve_common.cuh xla_expf is the same arithmetic."""
    x = torch.clamp(x, -_EXP_CLAMP, _EXP_CLAMP)
    fx = torch.floor(x * _f32(_LOG2E, x) + _f32(0.5, x))
    r = fma_f32(fx, _f32(_EXP_C1, x), x)
    r = fma_f32(fx, _f32(_EXP_C2, x), r)
    y = _f32(_EXP_POLY[0], x).expand_as(r)
    for p in _EXP_POLY[1:]:
        y = fma_f32(y, r, _f32(p, x))
    y = fma_f32(y, r * r, r) + _f32(1.0, x)
    # ldexp(y, fx) as two exact power-of-two factors built from their bits
    # (fx >= -127 after the clamp): one rounding, and no pow on the card
    e = fx.to(torch.int32)
    half = torch.div(e, 2, rounding_mode="floor")
    out = y * _pow2(half) * _pow2(e - half)
    return torch.where(out < torch.finfo(torch.float32).tiny,
                       torch.zeros_like(out), out)


def score_nodes(cap_f, used_f, ask_f, bias_g):
    """Vectorized ScoreFitBinPack after hypothetically adding one instance
    (nomad_tpu kernels._score_nodes), rounded as XLA compiles it: its exp
    (xla_exp), and the tail clip(20 - total, 0, 18) / 18 + bias computed
    as one fused multiply-add by f32(1/18), as XLA rewrites it.

    cap_f/used_f: [N, R] f32; ask_f: [R] f32; bias_g: [N] f32 -> [N] f32.
    """
    one = _f32(1.0, cap_f)
    ln10 = _f32(LN10, cap_f)
    util = used_f + ask_f[None, :]
    safe_cap = torch.maximum(cap_f, one)
    free = one - util / safe_cap  # [N, R]
    total = xla_exp(free[:, 0] * ln10) + xla_exp(free[:, 1] * ln10)
    clipped = torch.clamp(20.0 - total, 0.0, 18.0)
    return flush_denormal(fma_f32(clipped, _f32(1.0 / 18.0, cap_f), bias_g))


def unpack_rows(packed: torch.Tensor, n: int) -> torch.Tensor:
    """MSB-first bit rows ([U, ceil(n/8)] uint8, np.packbits' layout) to
    [U, n] bool — torch has no unpackbits."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :n].bool()


def _units_for(free, ask, ucap, feas_g, count):
    """How many instances fit per node given free capacity and caps
    (nomad_tpu kernels._units_for, with jnp.clip's min(max(x, lo), hi)).

    free: [N, 3] i32; ask: [3] i32; ucap: [N] i32; feas_g: [N] bool;
    count: 0-d i32 -> [N] i32.
    """
    zero = torch.zeros((), dtype=torch.int32, device=free.device)
    big = torch.full((), 1 << 30, dtype=torch.int32, device=free.device)
    per_res = torch.where(
        ask[None, :] > 0,
        torch.div(free, torch.clamp_min(ask, 1)[None, :],
                  rounding_mode="floor"),
        big,
    )
    units = per_res.min(dim=1).values
    units = torch.minimum(torch.maximum(units, zero), ucap)
    units = torch.where(feas_g, units, zero)
    return torch.minimum(torch.maximum(units, zero), count)


def _waterfill(score, units, count, k=None):
    """Fill the score-sorted node axis until `count` instances are placed
    (nomad_tpu kernels._waterfill; with k, _waterfill_topk): a stable
    descending order, so ties go to the lower node index, and a denormal
    score ties with zero."""
    zero = torch.zeros((), dtype=torch.int32, device=units.device)
    order = torch.argsort(-flush_denormal(score), stable=True)
    if k is not None:
        order = order[:k]
    su = units[order]
    prior = torch.cumsum(su, dim=0, dtype=torch.int32) - su
    take_sorted = torch.minimum(torch.maximum(count - prior, zero), su)
    take = torch.zeros_like(units)
    take[order] = take_sorted
    return take


def score_key(score):
    """csrc/solve_common.cuh score_bits on an f32 tensor: the score's bits
    as an order-preserving unsigned 32-bit key (in int64), larger for a
    larger score, -0.0 given +0.0's key (better() and a stable sort tie
    them)."""
    b = score.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    b = torch.where((b & 0x7FFFFFFF) == 0, torch.zeros_like(b), b)
    return torch.where((b & 0x80000000) != 0, b ^ 0xFFFFFFFF,
                       b | 0x80000000)


def waterfill_select_plain(score, units, count):
    """_waterfill computed as csrc/solve_common.cuh cluster_waterfill
    computes it, a unit-weighted radix select of the boundary node, in
    plain PyTorch: unit-bearing nodes keyed by score_key (a denormal
    score keyed as zero, as score_fit flushes the kernel's), 8-bit digits
    from the top, the shortcut when every unit fits, the early cut when a
    fixed digit's bin holds exactly the need, and the nodes tied at the
    boundary score sharing what is left in node-index order. Sums are in
    int64, so it equals _waterfill wherever _waterfill's int32 cumsum does
    not wrap. For the tests: the port computes the waterfill in its
    kernels and twins."""
    take = torch.zeros_like(units)
    need = int(count)
    live = units > 0
    if need <= 0 or not bool(live.any()):
        return take
    bits = score_key(flush_denormal(score))
    u = torch.where(live, units.long(), torch.zeros_like(bits))
    if int(u.sum()) <= need:
        return torch.where(live, units, take)
    prefix = 0
    for p in range(4):
        shift = 24 - 8 * p
        run = live if p == 0 else live & ((bits >> (shift + 8)) == prefix)
        digit = (bits >> shift) & 0xFF
        hist = torch.zeros(256, dtype=torch.int64, device=units.device)
        hist.index_add_(0, digit[run], u[run])
        at_or_above = hist.flip(0).cumsum(0).flip(0)
        d = int((at_or_above >= need).nonzero().max())
        need -= int(at_or_above[d] - hist[d])
        prefix = (prefix << 8) | d
        if need == int(hist[d]):
            return torch.where(live & (bits >= (prefix << shift)), units,
                               take)
    tied = live & (bits == prefix)
    tu = torch.where(tied, u, torch.zeros_like(u))
    share = torch.minimum(torch.clamp_min(need - (torch.cumsum(tu, 0) - tu),
                                          0), u)
    take = torch.where(live & (bits > prefix), units, take)
    return torch.where(tied, share.to(units.dtype), take)


def _place_scores(cap_f, used, ask, bias_g, units):
    """_score_nodes against `used`, NEG_INF where a node has no units."""
    neg_inf = torch.full((), NEG_INF, dtype=torch.float32, device=used.device)
    score = score_nodes(cap_f, used.float(), ask.float(), bias_g)
    return torch.where(units > 0, score, neg_inf)


def solve_placement_compact_plain(
    cap, used, asks, counts, feas_packed, feas_idx, bias_rows, bias_idx,
    ucap_rows, ucap_idx, *, max_count: int,
):
    """The compact solve in plain PyTorch, written from the JAX kernel:
    the scan is a Python loop over groups, the top-k waterfill a stable
    descending sort (lower node index first on ties, lax.top_k's order)."""
    n = cap.shape[0]
    dev = cap.device
    i32 = torch.int32
    feas_rows = unpack_rows(feas_packed, n)
    k = min(max_count, n)
    cap_f = cap.float()
    used_c = used.clone()
    takes = torch.zeros((asks.shape[0], n), dtype=i32, device=dev)
    for g in range(asks.shape[0]):
        ask = asks[g]
        count = counts[g]
        units = _units_for(cap - used_c, ask,
                           ucap_rows[ucap_idx[g]].to(i32),
                           feas_rows[feas_idx[g]], count)
        score = _place_scores(cap_f, used_c, ask, bias_rows[bias_idx[g]],
                              units)
        take = _waterfill(score, units, count, k)
        used_c = used_c + take[:, None] * ask[None, :]
        takes[g] = take
    cum = torch.cumsum(takes, dim=1, dtype=i32)
    idx = torch.arange(max_count, dtype=i32, device=dev)
    node = torch.searchsorted(
        cum, idx.expand(cum.shape[0], -1).contiguous(), right=True,
        out_int32=True,
    )
    inst = torch.where(idx[None, :] < cum[:, -1:], node,
                       torch.full((), -1, dtype=i32, device=dev))
    placed_res = used_c - used
    over = (placed_res > torch.clamp_min(cap - used, 0)).any(dim=1)
    return inst, over, used_c


def _expect(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# a bare `fn.launches += 1` is a read and a write that two launching
# threads can interleave, losing a count
_COUNT_LOCK = threading.Lock()


def _count(fn, n: int = 1, attr: str = "launches") -> None:
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + n)


def solve_placement_compact(
    cap, used, asks, counts, feas_packed, feas_idx, bias_rows, bias_idx,
    ucap_rows, ucap_idx, *, max_count: int,
):
    """Place all groups and read back compactly.

    cap, used: [Np, 3] i32; asks: [Gp, 3] i32; counts: [Gp] i32;
    feas_packed: [Uf, Np/8] u8 (MSB-first bit rows); bias_rows: [Ub, Np]
    f32; ucap_rows: [Uu, Np] i16 or i32; feas_idx/bias_idx/ucap_idx: [Gp]
    i32 row indices per group. All on one device.

    Returns (inst_node [Gp, max_count] i32 (-1 past each group's placed
    total), over [Np] bool, used' [Np, 3] i32). used' is a fresh tensor:
    ``used`` is never written.
    """
    if cap.device.type == "cpu":
        return solve_placement_compact_plain(
            cap, used, asks, counts, feas_packed, feas_idx, bias_rows,
            bias_idx, ucap_rows, ucap_idx, max_count=max_count,
        )
    dev = cap.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    np_ = cap.shape[0]
    gp = asks.shape[0]
    if np_ % 8 or max_count < 1:
        raise ValueError("Np must be a multiple of 8 and max_count >= 1")
    i32 = torch.int32
    _expect(cap, "cap", i32, (np_, 3), dev)
    _expect(used, "used", i32, (np_, 3), dev)
    _expect(asks, "asks", i32, (gp, 3), dev)
    _expect(counts, "counts", i32, (gp,), dev)
    _expect(feas_packed, "feas_packed", torch.uint8,
            (feas_packed.shape[0], np_ // 8), dev)
    _expect(bias_rows, "bias_rows", torch.float32,
            (bias_rows.shape[0], np_), dev)
    if ucap_rows.dtype not in (torch.int16, i32):
        raise ValueError(f"ucap_rows is {ucap_rows.dtype}, expected i16/i32")
    _expect(ucap_rows, "ucap_rows", ucap_rows.dtype,
            (ucap_rows.shape[0], np_), dev)
    for name, t in (("feas_idx", feas_idx), ("bias_idx", bias_idx),
                    ("ucap_idx", ucap_idx)):
        _expect(t, name, i32, (gp,), dev)
    k = min(max_count, np_)
    inst = torch.empty((gp, max_count), dtype=i32, device=dev)
    over = torch.empty((np_,), dtype=torch.bool, device=dev)
    used_out = torch.empty((np_, 3), dtype=i32, device=dev)
    score = torch.empty((np_,), dtype=torch.float32, device=dev)
    units = torch.empty((np_,), dtype=i32, device=dev)
    # each group's picks and takes [Gp, k], picks and instances per group
    picks = torch.empty((2 * gp * k + 2 * gp,), dtype=i32, device=dev)
    info = (ctypes.c_int * 4)()
    lib = libkernels.library()
    code = lib.nomad_solve_compact(
        cap.data_ptr(), used.data_ptr(), asks.data_ptr(), counts.data_ptr(),
        feas_packed.data_ptr(), feas_idx.data_ptr(), bias_rows.data_ptr(),
        bias_idx.data_ptr(), ucap_rows.data_ptr(),
        int(ucap_rows.dtype == torch.int16), ucap_idx.data_ptr(),
        np_, gp, max_count, k,
        score.data_ptr(), units.data_ptr(), picks.data_ptr(),
        inst.data_ptr(), over.data_ptr(), used_out.data_ptr(),
        info, _stream_ptr(dev),
    )
    libkernels.check(code, "solve_placement_compact")
    _count(solve_placement_compact)
    solve_placement_compact.last_launch = {
        "cluster": info[0], "smem_slices": bool(info[1]),
        "slice": info[2], "smem_bytes": info[3],
    }
    return inst, over, used_out


solve_placement_compact.launches = 0
# the cluster size and slice placement the last launch chose
solve_placement_compact.last_launch = None


# ---------------------------------------------------------------------------
# K4 / K5: the dense and the preemption solves
# ---------------------------------------------------------------------------


def solve_placement_plain(cap, used, asks, counts, feas, bias, units_cap):
    """The dense solve in plain PyTorch, written from the JAX kernel's
    scan step _place_group with the full stable-argsort _waterfill."""
    cap_f = cap.float()
    used_c = used.clone()
    takes = torch.zeros((asks.shape[0], cap.shape[0]), dtype=torch.int32,
                        device=cap.device)
    for g in range(asks.shape[0]):
        ask = asks[g]
        count = counts[g]
        units = _units_for(cap - used_c, ask, units_cap[g], feas[g], count)
        score = _place_scores(cap_f, used_c, ask, bias[g], units)
        take = _waterfill(score, units, count)
        used_c = used_c + take[:, None] * ask[None, :]
        takes[g] = take
    return takes, used_c


def solve_placement_preempt_plain(cap, used_exist, prefix_used, asks,
                                  counts, feas, bias, units_cap, tier_limit):
    """The preemption solve in plain PyTorch, written from the JAX
    kernel's scan step _place_group_preempt: phase 1 on real free
    capacity, phase 2 on free capacity plus the preemptible tiers' usage
    that no earlier group claimed (`freed`). The tier index is read as
    lax.dynamic_index_in_dim reads it: a negative one counts from the
    end, then it is clamped to the prefix's rows."""
    n = cap.shape[0]
    tp = prefix_used.shape[0]
    zero = torch.zeros((), dtype=torch.int32, device=cap.device)
    cap_f = cap.float()
    used_new = torch.zeros_like(used_exist)
    freed = torch.zeros_like(used_exist)
    takes = torch.zeros((asks.shape[0], n), dtype=torch.int32,
                        device=cap.device)
    takes_evict = torch.zeros_like(takes)
    for g in range(asks.shape[0]):
        ask = asks[g]
        count = counts[g]
        ucap = units_cap[g]
        feas_g = feas[g]
        bias_g = bias[g]
        used_total = used_exist - freed + used_new
        # phase 1: normal placement
        units1 = _units_for(cap - used_total, ask, ucap, feas_g, count)
        score1 = _place_scores(cap_f, used_total, ask, bias_g, units1)
        take1 = _waterfill(score1, units1, count)
        used_new = used_new + take1[:, None] * ask[None, :]
        used_total = used_total + take1[:, None] * ask[None, :]
        remaining = count - take1.sum(dtype=torch.int32)
        # phase 2: preemptible capacity (klim = 0: the prefix is all-zero)
        klim = int(tier_limit[g])
        klim = min(max(klim + tp if klim < 0 else klim, 0), tp - 1)
        preemptible = torch.maximum(prefix_used[klim] - freed, zero)
        normal_free = cap - used_total
        units2 = _units_for(normal_free + preemptible, ask, ucap - take1,
                           feas_g, remaining)
        score2 = _place_scores(
            cap_f, torch.maximum(used_total - preemptible, zero), ask,
            bias_g, units2,
        )
        take2 = _waterfill(score2, units2, remaining)
        # what phase 2 ate into victims rather than leftover free capacity
        overflow = torch.maximum(
            take2[:, None] * ask[None, :] - torch.maximum(normal_free, zero),
            zero,
        )
        freed = freed + torch.minimum(overflow, preemptible)
        used_new = used_new + take2[:, None] * ask[None, :]
        takes[g] = take1 + take2
        takes_evict[g] = take2
    return takes, takes_evict, used_exist - freed + used_new


def _check_dense_args(cap, used, asks, counts, feas, bias, units_cap):
    dev = cap.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    np_ = cap.shape[0]
    gp = asks.shape[0]
    i32 = torch.int32
    _expect(cap, "cap", i32, (np_, 3), dev)
    _expect(used, "used", i32, (np_, 3), dev)
    _expect(asks, "asks", i32, (gp, 3), dev)
    _expect(counts, "counts", i32, (gp,), dev)
    _expect(feas, "feas", torch.bool, (gp, np_), dev)
    _expect(bias, "bias", torch.float32, (gp, np_), dev)
    _expect(units_cap, "units_cap", i32, (gp, np_), dev)


def solve_placement(cap, used, asks, counts, feas, bias, units_cap):
    """Place all groups, reading back the dense assignment.

    cap, used: [Np, 3] i32; asks: [Gp, 3] i32; counts: [Gp] i32;
    feas: [Gp, Np] bool; bias: [Gp, Np] f32; units_cap: [Gp, Np] i32.
    All on one device. Returns (assign [Gp, Np] i32, used' [Np, 3] i32);
    used' is a fresh tensor: ``used`` is never written. On CUDA it is one
    launch of one thread-block cluster, the preemption solve's kernel
    without its second phase (csrc/solve_dense.cu); it raises when no
    cluster can be placed on the card.
    """
    if cap.device.type == "cpu":
        return solve_placement_plain(cap, used, asks, counts, feas, bias,
                                     units_cap)
    _check_dense_args(cap, used, asks, counts, feas, bias, units_cap)
    dev = cap.device
    np_, gp = cap.shape[0], asks.shape[0]
    assign = torch.empty((gp, np_), dtype=torch.int32, device=dev)
    used_out = torch.empty((np_, 3), dtype=torch.int32, device=dev)
    # the slices' state where it does not fit in shared memory: score,
    # units and used_new [Np, 3]
    work = torch.empty((5 * np_,), dtype=torch.int32, device=dev)
    info = (ctypes.c_int * 4)()
    code = libkernels.library().nomad_solve_dense(
        cap.data_ptr(), used.data_ptr(), asks.data_ptr(), counts.data_ptr(),
        feas.data_ptr(), bias.data_ptr(), units_cap.data_ptr(), np_, gp,
        work.data_ptr(), assign.data_ptr(), used_out.data_ptr(), info,
        _stream_ptr(dev),
    )
    libkernels.check(code, "solve_placement")
    _count(solve_placement)
    solve_placement.last_launch = {
        "cluster": info[0], "smem_slices": bool(info[1]),
        "slice": info[2], "smem_bytes": info[3],
    }
    return assign, used_out


solve_placement.launches = 0
# the cluster size and slice placement the last launch chose
solve_placement.last_launch = None


def solve_placement_preempt(cap, used_exist, prefix_used, asks, counts, feas,
                            bias, units_cap, tier_limit):
    """Place all groups with preemption tiers.

    As solve_placement, plus prefix_used: [Tp, Np, 3] i32, the cumulative
    usage of the priority tiers (ascending; row k holds the k lowest
    tiers, row 0 is zero), and tier_limit: [Gp] i32, how many tiers each
    group may preempt (0 = none; a negative limit counts from the end,
    then it is clamped to [0, Tp - 1], as the JAX kernel reads it). Returns
    (assign [Gp, Np], assign_evict [Gp, Np] — the phase-2 placements,
    which displace victims — and used' [Np, 3]), all i32. On CUDA it is
    one launch of one thread-block cluster (csrc/solve_dense.cu).
    """
    if cap.device.type == "cpu":
        return solve_placement_preempt_plain(
            cap, used_exist, prefix_used, asks, counts, feas, bias,
            units_cap, tier_limit,
        )
    _check_dense_args(cap, used_exist, asks, counts, feas, bias, units_cap)
    dev = cap.device
    np_, gp = cap.shape[0], asks.shape[0]
    tp = prefix_used.shape[0]
    if tp < 1:
        raise ValueError("prefix_used needs at least one tier row")
    _expect(prefix_used, "prefix_used", torch.int32, (tp, np_, 3), dev)
    _expect(tier_limit, "tier_limit", torch.int32, (gp,), dev)
    assign = torch.empty((gp, np_), dtype=torch.int32, device=dev)
    evict = torch.empty((gp, np_), dtype=torch.int32, device=dev)
    used_out = torch.empty((np_, 3), dtype=torch.int32, device=dev)
    # the slices' state where it does not fit in shared memory
    work = torch.empty((9 * np_,), dtype=torch.int32, device=dev)
    info = (ctypes.c_int * 4)()
    code = libkernels.library().nomad_solve_preempt(
        cap.data_ptr(), used_exist.data_ptr(), prefix_used.data_ptr(), tp,
        asks.data_ptr(), counts.data_ptr(), feas.data_ptr(), bias.data_ptr(),
        units_cap.data_ptr(), tier_limit.data_ptr(), np_, gp,
        work.data_ptr(), assign.data_ptr(), evict.data_ptr(),
        used_out.data_ptr(), info, _stream_ptr(dev),
    )
    libkernels.check(code, "solve_placement_preempt")
    _count(solve_placement_preempt)
    solve_placement_preempt.last_launch = {
        "cluster": info[0], "smem_slices": bool(info[1]),
        "slice": info[2], "smem_bytes": info[3],
    }
    return assign, evict, used_out


solve_placement_preempt.launches = 0
# the cluster size and slice placement the last launch chose
solve_placement_preempt.last_launch = None


# ---------------------------------------------------------------------------
# K2 / K3: row scatters onto the [Np, 3] usage tensor
# ---------------------------------------------------------------------------


def _kept_rows(idx: torch.Tensor, n: int):
    """mode="drop" indexing: negative indices count from the end (jnp
    normalizes them), anything still outside [0, n) is dropped."""
    j = idx.long()
    j = torch.where((j < 0) & (j >= -n), j + n, j)
    keep = (j >= 0) & (j < n)
    return j[keep], keep


def scatter_rows_plain(used, idx, rows, donate: bool = True):
    """used.at[idx].set(rows, mode="drop"); in place when donated. Of
    pairs that share a row, the one with the highest i wins (the order
    a sequential scatter writes in, made explicit so it holds on the
    card too)."""
    out = used if donate else used.clone()
    j, keep = _kept_rows(idx, used.shape[0])
    order = torch.arange(j.numel(), device=j.device)
    last = torch.full((used.shape[0],), -1, dtype=order.dtype,
                      device=j.device)
    last.scatter_reduce_(0, j, order, "amax")
    won = last[j] == order
    out[j[won]] = rows[keep][won]
    return out


def scatter_add_rows_plain(used, idx, rows):
    """max(used.at[idx].add(rows, mode="drop"), 0) onto a fresh tensor."""
    out = used.clone()
    j, keep = _kept_rows(idx, used.shape[0])
    out.index_add_(0, j, rows[keep])
    return out.clamp_min_(0)


def _check_scatter_args(used, idx, rows) -> None:
    dev = used.device
    b = idx.shape[0]
    _expect(used, "used", torch.int32, (used.shape[0], 3), dev)
    _expect(idx, "idx", torch.int32, (b,), dev)
    _expect(rows, "rows", torch.int32, (b, 3), dev)


def scatter_rows(used, idx, rows, donate: bool = True):
    """Row set-scatter onto a [Np, 3] i32 usage tensor: donate=True
    writes ``used`` in place and returns it, donate=False returns a fresh
    tensor and leaves ``used`` intact. idx: [B] i32; rows: [B, 3] i32.
    One launch either way. Not donated, a repeated index keeps the pair
    with the highest i; donated, the callers pass distinct indices."""
    if used.device.type == "cpu":
        return scatter_rows_plain(used, idx, rows, donate)
    _check_scatter_args(used, idx, rows)
    out = used if donate else torch.empty_like(used)
    code = libkernels.library().nomad_scatter_rows(
        used.data_ptr(), out.data_ptr(), idx.data_ptr(), rows.data_ptr(),
        idx.shape[0], used.shape[0], _stream_ptr(used.device),
    )
    libkernels.check(code, "scatter_rows")
    _count(scatter_rows)
    if not donate:
        _count(scatter_rows, attr="launches_copy")
    return out


scatter_rows.launches = 0
# of those, the launches that were not donated (a fresh copy)
scatter_rows.launches_copy = 0


def scatter_add_rows(used, idx, rows):
    """Row scatter-ADD, then clamp the whole tensor at zero, onto a fresh
    tensor (``used`` is left intact). Rows may be negative."""
    if used.device.type == "cpu":
        return scatter_add_rows_plain(used, idx, rows)
    _check_scatter_args(used, idx, rows)
    out = torch.empty_like(used)
    code = libkernels.library().nomad_scatter_add_rows(
        used.data_ptr(), out.data_ptr(), idx.data_ptr(), rows.data_ptr(),
        idx.shape[0], used.shape[0], _stream_ptr(used.device),
    )
    libkernels.check(code, "scatter_add_rows")
    _count(scatter_add_rows)
    return out


scatter_add_rows.launches = 0


# ---------------------------------------------------------------------------
# K6 / K7: the node-sharded solves (the mesh route)
# ---------------------------------------------------------------------------


def _shard_width(np_: int, n_shards: int) -> int:
    if n_shards < 1 or np_ % n_shards:
        raise ValueError(
            f"{np_} node rows do not split into {n_shards} equal shards"
        )
    return np_ // n_shards


def _shard_candidates(score_loc, units_loc, d: int, w: int, k: int):
    """_topk_fill's local step on shard d: its k best rows, best first,
    ties to the lower index (lax.top_k's order) as (score, units, global
    index). A stable sort: torch.topk leaves the tie order open."""
    order = torch.argsort(-flush_denormal(score_loc), stable=True)[:k]
    return (score_loc[order], units_loc[order],
            (order + d * w).to(torch.int32))


def _candidate_fill(vs, us, gs, count, n: int):
    """_topk_fill's replicated step on the gathered [D*k] candidates:
    ordered by global index, then stably by -score, and filled until
    `count` is placed. Returns (take [n], candidate indices in fill
    order, their takes)."""
    zero = torch.zeros((), dtype=torch.int32, device=us.device)
    o0 = torch.argsort(gs, stable=True)
    order = torch.argsort(-flush_denormal(vs[o0]), stable=True)
    su_s = us[o0][order]
    prior = torch.cumsum(su_s, dim=0, dtype=torch.int32) - su_s
    take_sorted = torch.minimum(torch.maximum(count - prior, zero), su_s)
    gs_s = gs[o0][order]
    take = torch.zeros(n, dtype=torch.int32, device=us.device)
    take[gs_s.long()] = take_sorted
    return take, gs_s, take_sorted


def _candidates_to_inst(gs_s, take_sorted, maxc: int):
    """The compact instance list from the candidates (nomad_tpu
    kernels._candidates_to_inst): instances in node-index order, -1 past
    the group's placed total."""
    i32 = torch.int32
    o2 = torch.argsort(gs_s, stable=True)
    gs2 = gs_s[o2]
    cum = torch.cumsum(take_sorted[o2], dim=0, dtype=i32)
    idxv = torch.arange(maxc, dtype=i32, device=gs_s.device)
    pos = torch.searchsorted(cum, idxv, right=True)
    node = gs2[pos.clamp(0, gs2.shape[0] - 1)]
    return torch.where(idxv < cum[-1], node,
                       torch.full((), -1, dtype=i32, device=gs_s.device))


def sharded_solver_plain(cap, used, asks, counts, feas, bias, units_cap, *,
                         n_shards: int, max_count=None, compact=False):
    """The node-sharded solve in plain PyTorch, written from nomad_tpu's
    make_sharded_solver. Shard d owns rows [d*w, (d+1)*w). Each step
    scores every shard on its own rows, then gathers by concatenation:
    the full [Np] score and units (max_count None, _sharded_waterfill),
    or each shard's k = min(max_count, w) best candidates (_topk_fill),
    and runs the waterfill replicated over what was gathered.
    compact=True returns (inst [Gp, max_count], over [Np], used'), the
    other modes (assign [Gp, Np], used')."""
    if compact and max_count is None:
        raise ValueError("compact sharded solver requires max_count")
    np_ = cap.shape[0]
    w = _shard_width(np_, n_shards)
    k = None if max_count is None else min(max_count, w)
    dev = cap.device
    cap_f = cap.float()
    used_c = used.clone()
    gp = asks.shape[0]
    per_group = torch.zeros((gp, max_count) if compact else (gp, np_),
                            dtype=torch.int32, device=dev)
    shards = [slice(d * w, (d + 1) * w) for d in range(n_shards)]
    for g in range(gp):
        ask = asks[g]
        count = counts[g]
        units = [_units_for(cap[s] - used_c[s], ask, units_cap[g, s],
                            feas[g, s], count) for s in shards]
        scores = [_place_scores(cap_f[s], used_c[s], ask, bias[g, s], u)
                  for s, u in zip(shards, units)]
        if k is None:
            take = _waterfill(torch.cat(scores), torch.cat(units), count)
        else:
            cands = [_shard_candidates(scores[d], units[d], d, w, k)
                     for d in range(n_shards)]
            vs, us, gs = (torch.cat(c) for c in zip(*cands))
            take, gs_s, take_sorted = _candidate_fill(vs, us, gs, count, np_)
        used_c = used_c + take[:, None] * ask[None, :]
        per_group[g] = (_candidates_to_inst(gs_s, take_sorted, max_count)
                        if compact else take)
    if not compact:
        return per_group, used_c
    over = ((used_c - used) > torch.clamp_min(cap - used, 0)).any(dim=1)
    return per_group, over, used_c


def sharded_solver_preempt_plain(cap, used_exist, prefix_used, asks, counts,
                                 feas, bias, units_cap, tier_limit, *,
                                 n_shards: int):
    """The node-sharded preemption solve in plain PyTorch, written from
    nomad_tpu's make_sharded_solver_preempt: solve_placement_preempt's
    two phases, each scored shard by shard and filled over the gathered
    [Np] vectors; phase 2's remainder is the count less the sum of every
    shard's phase-1 takes (the reference's psum)."""
    np_ = cap.shape[0]
    w = _shard_width(np_, n_shards)
    tp = prefix_used.shape[0]
    i32 = torch.int32
    zero = torch.zeros((), dtype=i32, device=cap.device)
    cap_f = cap.float()
    used_new = torch.zeros_like(used_exist)
    freed = torch.zeros_like(used_exist)
    takes = torch.zeros((asks.shape[0], np_), dtype=i32, device=cap.device)
    takes_evict = torch.zeros_like(takes)
    shards = [slice(d * w, (d + 1) * w) for d in range(n_shards)]
    for g in range(asks.shape[0]):
        ask = asks[g]
        count = counts[g]
        ucap = units_cap[g]
        feas_g = feas[g]
        bias_g = bias[g]
        used_total = used_exist - freed + used_new
        # phase 1: normal placement, shard by shard, filled replicated
        u1 = [_units_for(cap[s] - used_total[s], ask, ucap[s], feas_g[s],
                         count) for s in shards]
        s1 = [_place_scores(cap_f[s], used_total[s], ask, bias_g[s], u)
              for s, u in zip(shards, u1)]
        take1 = _waterfill(torch.cat(s1), torch.cat(u1), count)
        used_new = used_new + take1[:, None] * ask[None, :]
        used_total = used_total + take1[:, None] * ask[None, :]
        placed1 = sum((take1[s].sum(dtype=i32) for s in shards), zero)
        remaining = count - placed1
        # phase 2: the remainder on the preemptible tiers' capacity
        klim = int(tier_limit[g])
        klim = min(max(klim + tp if klim < 0 else klim, 0), tp - 1)
        preemptible = torch.maximum(prefix_used[klim] - freed, zero)
        normal_free = cap - used_total
        u2 = [_units_for(normal_free[s] + preemptible[s], ask,
                         ucap[s] - take1[s], feas_g[s], remaining)
              for s in shards]
        s2 = [_place_scores(cap_f[s],
                            torch.maximum(used_total[s] - preemptible[s],
                                          zero),
                            ask, bias_g[s], u)
              for s, u in zip(shards, u2)]
        take2 = _waterfill(torch.cat(s2), torch.cat(u2), remaining)
        overflow = torch.maximum(
            take2[:, None] * ask[None, :] - torch.maximum(normal_free, zero),
            zero,
        )
        freed = freed + torch.minimum(overflow, preemptible)
        used_new = used_new + take2[:, None] * ask[None, :]
        takes[g] = take1 + take2
        takes_evict[g] = take2
    return takes, takes_evict, used_exist - freed + used_new


# The candidate fill keeps a list head per shard in shared memory
# (csrc/solve_sharded.cu kMaxShards).
MAX_SHARDS = 1024


def _ptr(t):
    return None if t is None else t.data_ptr()


def _card_parts(x) -> list:
    """A node-axis operand as per-card parts: a tensor holds every shard
    on one card, a list holds one tensor per card, in shard order."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _joined(parts: list, like):
    """Per-card results in the form the node-axis inputs came in."""
    return list(parts) if isinstance(like, (list, tuple)) else parts[0]


def _mesh_cards(n_shards: int, caps: list):
    """(Np, shard width, one dict per card with its device, first shard,
    shard count and rows) for per-card row tensors holding whole shards."""
    if not 1 <= n_shards <= MAX_SHARDS:
        raise ValueError(f"a mesh takes 1 to {MAX_SHARDS} shards, "
                         f"not {n_shards}")
    np_ = sum(p.shape[0] for p in caps)
    w = _shard_width(np_, n_shards)
    cards, s0 = [], 0
    for p in caps:
        rows = p.shape[0]
        if p.device.type != "cuda":
            raise ValueError(f"unsupported device {p.device}")
        if rows % w or rows == 0:
            raise ValueError(f"{rows} rows on {p.device} are not whole "
                             f"shards of {w}")
        cards.append({"dev": p.device, "s0": s0, "nsc": rows // w,
                      "rows": rows})
        s0 += rows // w
    return np_, w, cards


def _exchange(cards: list, names: tuple, unit: int) -> None:
    """The gather between cards: each card's own region of the gathered
    buffers (`unit` entries per shard) goes to every other card, one peer
    copy per buffer. torch's copy_ between two cards orders itself with
    CUDA events against both cards' current streams (the copy waits for
    the destination's queued work, the destination's stream waits for
    the copy), so each card's next launch sees the whole gather. Shards
    of one card share their buffers: nothing to copy."""
    if len(cards) < 2:
        return
    for src in cards:
        lo = src["s0"] * unit
        hi = lo + src["nsc"] * unit
        for dst in cards:
            if dst is not src:
                for name in names:
                    dst[name][lo:hi].copy_(src[name][lo:hi],
                                           non_blocking=True)


def _launch(counter, name: str, dev, *args) -> None:
    """Launch one entry point on dev's current stream; count it on
    `counter` unless that is None (a launch being captured into a graph
    counts when the graph replays)."""
    with torch.cuda.device(dev):
        code = getattr(libkernels.library(), name)(*args, _stream_ptr(dev))
    libkernels.check(code, name)
    if counter is not None:
        _count(counter)


def _card_inputs(c, gp, rows, asks, counts, **parts) -> None:
    """Check one card's operands and put its replicated ones on it."""
    dev = c["dev"]
    i32 = torch.int32
    shapes = {"cap": (i32, (rows, 3)), "used": (i32, (rows, 3)),
              "feas": (torch.bool, (gp, rows)),
              "bias": (torch.float32, (gp, rows)),
              "units_cap": (i32, (gp, rows))}
    for name, t in parts.items():
        if name == "prefix_used":
            _expect(t, name, i32, (t.shape[0], rows, 3), dev)
        else:
            _expect(t, name, *shapes[name], dev)
        c[name] = t
    c["asks"] = asks.to(dev)
    c["counts"] = counts.to(dev)
    _expect(c["asks"], "asks", i32, (gp, 3), dev)
    _expect(c["counts"], "counts", i32, (gp,), dev)


def sharded_solver(cap, used, asks, counts, feas, bias, units_cap, *,
                   n_shards: int, max_count=None, compact=False):
    """The node-sharded solve over n_shards equal shards of the node axis.

    cap, used: [Np, 3] i32 with every shard on one device, or a list of
    per-card [rows, 3] tensors holding whole shards in order; feas [Gp,
    Np] bool, bias [Gp, Np] f32, units_cap [Gp, Np] i32 in the same form
    (per-card [Gp, rows]); asks [Gp, 3] and counts [Gp] i32. max_count
    None: the full gather of [Np] score and units per step; an int: each
    shard's k = min(max_count, w) best candidates (exact when max_count
    bounds every group's receiving node set, as the solver's readback
    bound does). compact=True (needs max_count): returns (inst [Gp,
    max_count], over [Np] bool, used'); else (assign [Gp, Np], used').
    Node-axis results come back in the form the inputs came in.

    On CUDA each scan step launches, per card, the shard scoring
    (csrc/solve_sharded.cu) and then the candidate fill (top-k modes) or
    the gathered waterfill (full mode); compact mode adds one pass for
    `over` and the instance rows. A CPU tensor runs sharded_solver_plain."""
    if not isinstance(cap, (list, tuple)) and cap.device.type == "cpu":
        return sharded_solver_plain(
            cap, used, asks, counts, feas, bias, units_cap,
            n_shards=n_shards, max_count=max_count, compact=compact,
        )
    if compact and max_count is None:
        raise ValueError("compact sharded solver requires max_count")
    caps = _card_parts(cap)
    np_, w, cards = _mesh_cards(n_shards, caps)
    gp = asks.shape[0]
    k = None if max_count is None else min(max_count, w)
    for c, cp, up, fp, bp, ucp in zip(
        cards, caps, _card_parts(used), _card_parts(feas),
        _card_parts(bias), _card_parts(units_cap),
    ):
        dev, rows = c["dev"], c["rows"]
        _card_inputs(c, gp, rows, asks, counts, cap=cp, used=up, feas=fp,
                     bias=bp, units_cap=ucp)

        def empty(shape, dtype=torch.int32, dev=dev):
            return torch.empty(shape, dtype=dtype, device=dev)

        c["out"] = empty((rows, 3))
        c["assign"] = None if compact else empty((gp, rows))
        c["inst"] = empty((gp, max_count)) if compact else None
        c["over"] = empty((rows,), torch.bool) if compact else None
        if k is None:
            c["g_score"] = empty((np_,), torch.float32)
            c["g_units"] = empty((np_,))
            c["g_idx"] = c["score_s"] = c["units_s"] = c["picks"] = None
        else:
            dk = n_shards * k
            c["g_score"] = empty((dk,), torch.float32)
            c["g_units"] = empty((dk,))
            c["g_idx"] = empty((dk,))
            c["score_s"] = empty((rows,), torch.float32)
            c["units_s"] = empty((rows,))
            # compact mode: each group's picks and takes, then per group
            # the picks and the instances placed
            c["picks"] = empty((gp * 2 * dk + 2 * gp,)) if compact else None
    fn = sharded_solver
    for g in range(gp):
        for c in cards:
            _launch(fn, "nomad_shard_score", c["dev"],
                    0 if k is None else 1, g, int(g == 0), _ptr(c["cap"]),
                    _ptr(c["used"]), _ptr(c["out"]), None, None, None, None,
                    0, None, None, _ptr(c["asks"]), _ptr(c["counts"]),
                    _ptr(c["feas"]), _ptr(c["bias"]), _ptr(c["units_cap"]),
                    _ptr(c["assign"]), None, _ptr(c["score_s"]),
                    _ptr(c["units_s"]), _ptr(c["g_score"]),
                    _ptr(c["g_units"]), _ptr(c["g_idx"]), c["nsc"], w,
                    c["s0"], k or 0)
        if k is None:
            _exchange(cards, ("g_score", "g_units"), w)
        else:
            _exchange(cards, ("g_score", "g_units", "g_idx"), k)
        for c in cards:
            if k is None:
                _launch(fn, "nomad_gathered_waterfill", c["dev"], 0, g,
                        _ptr(c["asks"]), _ptr(c["counts"]), None,
                        _ptr(c["g_score"]), _ptr(c["g_units"]), np_,
                        c["s0"] * w, c["rows"], _ptr(c["cap"]),
                        _ptr(c["used"]), _ptr(c["out"]), None, None, None,
                        None, 0, None, _ptr(c["assign"]), None)
            else:
                _launch(fn, "nomad_candidate_fill", c["dev"], g,
                        _ptr(c["asks"]), _ptr(c["counts"]),
                        _ptr(c["g_score"]), _ptr(c["g_units"]),
                        _ptr(c["g_idx"]), n_shards, k, w, c["s0"],
                        c["rows"], _ptr(c["out"]), _ptr(c["assign"]),
                        _ptr(c["inst"]), max_count or 0, _ptr(c["picks"]),
                        gp)
    used_out = _joined([c["out"] for c in cards], cap)
    if not compact:
        return _joined([c["assign"] for c in cards], cap), used_out
    for c in cards:
        _launch(fn, "nomad_shard_finish", c["dev"], 0, _ptr(c["cap"]),
                _ptr(c["used"]), _ptr(c["out"]), None, None, None,
                _ptr(c["over"]), c["rows"], _ptr(c["picks"]), gp,
                n_shards * k, _ptr(c["inst"]), max_count)
    # inst is replicated: every card wrote the same rows
    return cards[0]["inst"], _joined([c["over"] for c in cards], cap), used_out


sharded_solver.launches = 0


# K7's node-axis inputs, and the replicated ones each card holds a copy of
_PREEMPT_INPUTS = ("cap", "used", "prefix_used", "feas", "bias", "units_cap",
                   "asks", "counts", "tier_limit")


def _preempt_buffers(c, gp: int, np_: int) -> None:
    """One card's working and output tensors of K7."""
    dev, rows = c["dev"], c["rows"]

    def empty(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    c.update(used_new=empty((rows, 3)), freed=empty((rows, 3)),
             take1=empty((rows,)), rem=empty((1,)),
             g_score=empty((np_,), torch.float32), g_units=empty((np_,)),
             assign=empty((gp, rows)), evict=empty((gp, rows)),
             out=empty((rows, 3)))


def _preempt_chain(cards: list, np_: int, w: int, gp: int, tp: int,
                   counter) -> int:
    """Queue K7's whole step chain on each card's current stream: per
    group, phase 1's shard scoring and select, then phase 2's, with the
    gathers between cards, and the finish. Returns the launches made."""
    n = 0
    for g in range(gp):
        for score_mode, water_mode in ((2, 1), (3, 2)):
            for c in cards:
                _launch(counter, "nomad_shard_score", c["dev"], score_mode, g,
                        int(g == 0 and score_mode == 2), _ptr(c["cap"]),
                        _ptr(c["used"]), None, _ptr(c["used_new"]),
                        _ptr(c["freed"]), _ptr(c["take1"]),
                        _ptr(c["prefix_used"]), tp, _ptr(c["tier_limit"]),
                        _ptr(c["rem"]), _ptr(c["asks"]), _ptr(c["counts"]),
                        _ptr(c["feas"]), _ptr(c["bias"]),
                        _ptr(c["units_cap"]), _ptr(c["assign"]),
                        _ptr(c["evict"]), None, None, _ptr(c["g_score"]),
                        _ptr(c["g_units"]), None, c["nsc"], w, c["s0"], 0)
            _exchange(cards, ("g_score", "g_units"), w)
            for c in cards:
                _launch(counter, "nomad_gathered_waterfill", c["dev"],
                        water_mode, g, _ptr(c["asks"]), _ptr(c["counts"]),
                        _ptr(c["rem"]), _ptr(c["g_score"]),
                        _ptr(c["g_units"]), np_, c["s0"] * w, c["rows"],
                        _ptr(c["cap"]), _ptr(c["used"]), None,
                        _ptr(c["used_new"]), _ptr(c["freed"]),
                        _ptr(c["take1"]), _ptr(c["prefix_used"]), tp,
                        _ptr(c["tier_limit"]), _ptr(c["assign"]),
                        _ptr(c["evict"]))
            n += 2 * len(cards)
    for c in cards:
        _launch(counter, "nomad_shard_finish", c["dev"], 1, _ptr(c["cap"]),
                _ptr(c["used"]), None, _ptr(c["freed"]), _ptr(c["used_new"]),
                _ptr(c["out"]), None, c["rows"], None, 0, 0, None, 0)
    return n + len(cards)


# graphs kept per shape, oldest dropped first
MAX_PREEMPT_GRAPHS = 8


def _preempt_graph(c: dict, np_: int, w: int, gp: int, tp: int,
                   n_shards: int) -> tuple:
    """K7's cached graph for this shape on c's card: (entry, route). A new
    shape captures the whole chain into a CUDA graph over static buffers;
    a capture or instantiation that fails raises."""
    fn = sharded_solver_preempt
    dev = c["dev"]
    key = (np_, gp, tp, n_shards, dev.index)
    entry = fn.graphs.get(key)
    if entry is not None:
        return entry, "graph_replay"
    t0 = time.perf_counter()
    static = {name: torch.empty_like(c[name]) for name in _PREEMPT_INPUTS}
    static.update(dev=dev, s0=0, nsc=n_shards, rows=np_)
    _preempt_buffers(static, gp, np_)
    lib = libkernels.library()
    with torch.cuda.device(dev):
        # the launch shapes are chosen (and cached) outside the capture
        if not (lib.nomad_shard_cluster(n_shards, w)
                and lib.nomad_water_cluster(np_)):
            raise RuntimeError("sharded_solver_preempt: no cluster shape "
                               f"fits Np {np_} on {dev}")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            launches = _preempt_chain([static], np_, w, gp, tp, None)
    entry = {"graph": graph, "c": static, "launches": launches,
             "done": torch.cuda.Event(),
             "capture_s": time.perf_counter() - t0}
    while len(fn.graphs) >= MAX_PREEMPT_GRAPHS:
        fn.graphs.pop(next(iter(fn.graphs)))
    fn.graphs[key] = entry
    return entry, "graph_capture"


def sharded_solver_preempt(cap, used_exist, prefix_used, asks, counts, feas,
                           bias, units_cap, tier_limit, *, n_shards: int):
    """The node-sharded preemption solve: solve_placement_preempt's
    contract ((assign [Gp, Np], assign_evict [Gp, Np], used')), with the
    node-axis operands in sharded_solver's form and prefix_used [Tp, Np,
    3] (per card [Tp, rows, 3]) sharded alongside cap. A CPU tensor runs
    sharded_solver_preempt_plain.

    On CUDA each scan step launches, per card, phase 1's shard scoring and
    select, then phase 2's, and one pass after the scan writes used'. With
    every shard on one card that chain (4 launches a group and the finish)
    is captured once per (Np, Gp, Tp, shards, card) into a CUDA graph, and
    each solve copies its inputs into the graph's static buffers on the
    card, replays it and copies the outputs out. Shards on several cards
    launch the chain step by step, with the gathers between cards.
    `last_route` says which ran: "graph_capture" (a new shape, captured
    then replayed), "graph_replay" or "stepwise"; `launches` counts the
    kernel launches, a graph's nodes at each replay, and `graph_replays`
    the replays; `graphs` holds the captured graphs by shape, each with
    its capture's seconds."""
    if not isinstance(cap, (list, tuple)) and cap.device.type == "cpu":
        return sharded_solver_preempt_plain(
            cap, used_exist, prefix_used, asks, counts, feas, bias,
            units_cap, tier_limit, n_shards=n_shards,
        )
    caps = _card_parts(cap)
    np_, w, cards = _mesh_cards(n_shards, caps)
    gp = asks.shape[0]
    tp = _card_parts(prefix_used)[0].shape[0]
    if tp < 1:
        raise ValueError("prefix_used needs at least one tier row")
    for c, cp, up, pp, fp, bp, ucp in zip(
        cards, caps, _card_parts(used_exist), _card_parts(prefix_used),
        _card_parts(feas), _card_parts(bias), _card_parts(units_cap),
    ):
        _card_inputs(c, gp, c["rows"], asks, counts, cap=cp, used=up,
                     prefix_used=pp, feas=fp, bias=bp, units_cap=ucp)
        if pp.shape[0] != tp:
            raise ValueError("every card needs the same tier rows")
        c["tier_limit"] = tier_limit.to(c["dev"])
        _expect(c["tier_limit"], "tier_limit", torch.int32, (gp,), c["dev"])
    fn = sharded_solver_preempt
    if len(cards) > 1:
        for c in cards:
            _preempt_buffers(c, gp, np_)
        _preempt_chain(cards, np_, w, gp, tp, fn)
        fn.last_route = "stepwise"
        return (_joined([c["assign"] for c in cards], cap),
                _joined([c["evict"] for c in cards], cap),
                _joined([c["out"] for c in cards], cap))
    c = cards[0]
    with fn.lock:
        entry, route = _preempt_graph(c, np_, w, gp, tp, n_shards)
        static = entry["c"]
        with torch.cuda.device(c["dev"]):
            stream = torch.cuda.current_stream(c["dev"])
            # the last solve on another stream has copied its outputs out
            stream.wait_event(entry["done"])
            for name in _PREEMPT_INPUTS:
                static[name].copy_(c[name], non_blocking=True)
            entry["graph"].replay()
            out = tuple(static[k].clone() for k in ("assign", "evict", "out"))
            entry["done"].record(stream)
        _count(fn, entry["launches"])
        _count(fn, attr="graph_replays")
        fn.last_route = route
    return out


sharded_solver_preempt.launches = 0
sharded_solver_preempt.graph_replays = 0
sharded_solver_preempt.last_route = None
sharded_solver_preempt.graphs = {}
sharded_solver_preempt.lock = threading.Lock()


KERNELS = (solve_placement_compact, solve_placement, solve_placement_preempt,
           scatter_rows, scatter_add_rows, sharded_solver,
           sharded_solver_preempt)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for fn in KERNELS:
            fn.launches = 0
        scatter_rows.launches_copy = 0
        sharded_solver_preempt.graph_replays = 0
