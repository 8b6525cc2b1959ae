// Device helpers shared by the placement scans (solve_compact.cu,
// solve_dense.cu, solve_sharded.cu).
//
// Numerics are the reference kernel's (nomad_tpu/scheduler/tpu/kernels.py
// _units_for :128, _score_nodes :114): integer units with floor division
// and int32 wrap, and the ScoreFit score in f32 rounded as XLA compiles
// it: IEEE '/', XLA's Cephes exp (xla_expf) and the tail fused into one
// multiply-add by f32(1/18). Every fused step is an explicit __fmaf_rn;
// build with --fmad=false and never --use_fast_math, so nvcc contracts
// nothing else: a one-ulp drift flips near-ties. The twin
// (scheduler/gpu/kernels.py score_nodes) is the same arithmetic. Ties
// between equal scores go to the lower node index, the order of a stable
// sort and of lax.top_k.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nomad {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBigUnits = 1 << 30;
constexpr int kNoNode = 0x7fffffff;
constexpr float kLn10 = 2.302585092994046f;  // kernels.py LN10 as f32

__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// jnp's '//' for a positive divisor: rounds toward -inf.
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// int32 arithmetic that wraps like XLA's, without signed-overflow UB.
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// _units_for on one node: instances of `ask` that fit in `free`, clipped
// to [0, ucap], zero where infeasible, then clipped to [0, count].
__device__ __forceinline__ int units_for(const int free[3], const int ask[3],
                                         int ucap, bool feasible, int count) {
  int units = kBigUnits;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    if (ask[r] > 0) units = min(units, floor_div(free[r], ask[r]));
  units = min(max(units, 0), ucap);
  if (!feasible) units = 0;
  return min(max(units, 0), count);
}

// The f32 exp of XLA's CPU backend (Cephes expf): clamp, fx = floor(x *
// log2e + 0.5), a two-step fused reduction, the degree-5 Horner polynomial
// with a fused multiply-add at each step, ldexp, and a result below the
// smallest normal flushed to zero, as XLA runs with denormals off.
__device__ __forceinline__ float xla_expf(float x) {
  x = fminf(fmaxf(x, -88.3762626647949f), 88.3762626647949f);
  const float fx = floorf(x * 1.44269504088896341f + 0.5f);
  float r = __fmaf_rn(fx, -0.693359375f, x);
  r = __fmaf_rn(fx, 2.12194440e-4f, r);
  float y = 1.9875691500e-4f;
  y = __fmaf_rn(y, r, 1.3981999507e-3f);
  y = __fmaf_rn(y, r, 8.3334519073e-3f);
  y = __fmaf_rn(y, r, 4.1665795894e-2f);
  y = __fmaf_rn(y, r, 1.6666665459e-1f);
  y = __fmaf_rn(y, r, 5.0000001201e-1f);
  y = __fmaf_rn(y, r * r, r) + 1.0f;
  // ldexp(y, fx) as two exact power-of-two factors (fx in [-127, 128]
  // after the clamp): one rounding, as the twin computes it
  const int e = (int)fx;
  const int e1 = e >> 1;
  const float out = y * __int_as_float((e1 + 127) << 23) *
                    __int_as_float((e - e1 + 127) << 23);
  return out < 1.17549435e-38f ? 0.0f : out;
}

// _score_nodes on one node: ScoreFitBinPack after adding one instance,
// normalized to [0, 1], plus the group's bias. XLA rewrites the tail
// clip(20 - total, 0, 18) / 18 + bias as fma(clip, f32(1/18), bias), and
// a denormal result is +0.0, as XLA runs with denormals off.
__device__ __forceinline__ float score_fit(int cap0, int cap1, float used0,
                                           float used1, float ask0,
                                           float ask1, float bias) {
  const float cf0 = fmaxf((float)cap0, 1.0f);
  const float cf1 = fmaxf((float)cap1, 1.0f);
  const float free0 = 1.0f - (used0 + ask0) / cf0;
  const float free1 = 1.0f - (used1 + ask1) / cf1;
  const float total = xla_expf(free0 * kLn10) + xla_expf(free1 * kLn10);
  const float clip = fminf(fmaxf(20.0f - total, 0.0f), 18.0f);
  const float s = __fmaf_rn(clip, 1.0f / 18.0f, bias);
  return fabsf(s) < 1.17549435e-38f ? 0.0f : s;
}

// ---------------------------------------------------------------------------
// Cluster-wide top-m selection (K1's waterfill, K6's shard candidates)
// ---------------------------------------------------------------------------
//
// Within a group the scores do not change, so the waterfill's sequential
// picks are the unit-bearing nodes in (score desc, index asc) order, taken
// until their units cover `need` or `kmax` are taken. A subset of the
// nodes (a warp's, a block's, a cluster's) can stop early the same way: a
// later node of the subset has at least the subset's earlier units ahead
// of it, so once those cover `need` it cannot receive an instance. The
// selection builds that prefix from sorted lists of m = 32: each warp
// lists its best by bitonic sorts of its lanes' best offers
// (warp_select), the block keeps the best 32 of its 16 warp lists by four
// rounds of pairwise merges (merge_top), and the cluster's leader merges
// the blocks' lists the same way after they stored them into its shared
// memory (distributed shared memory). A list cut at m entries before it
// covered `need` or ran out is truncated, and its last entry is marked: a
// merge stops after the first marked entry (what its list left out may
// rank next), and the cluster runs another round on what the merged
// prefix did not take. The candidate fill of the sharded solve cuts its
// merge of the shards' lists the same way (take_prefix).

constexpr int kSelThreads = 512;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kSelM = 32;       // entries per warp and per block list
constexpr int kMaxCluster = 16;

struct Cand {
  float s;  // score
  int u;    // units
  int i;    // global node index
  int o;    // the list it came from, | kMark on a truncated list's last
};

constexpr int kMark = 1 << 30;
__device__ __forceinline__ Cand no_cand() {
  return Cand{-INFINITY, 0, kNoNode, 0};
}

enum MergeStatus { kMergeDone = 0, kMergeExhausted = 1, kMergeBlocked = 2 };

// The warp's best (s, i), returned to every lane (xor butterfly).
__device__ __forceinline__ void warp_argmax(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, s, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

// One warp merges L sorted lists, list j held by lane j % 32, until the
// merged units cover `need`, `kmax` entries are out, every list is empty,
// or a truncated list is empty (kMergeBlocked). head(j, p, c) loads entry
// p of list j and returns false past its end; trunc(j) says whether list
// j was cut. emit(n, c, prior) runs on one lane for the n-th merged entry,
// `prior` being the units merged before it. pos[L] (shared) ends holding
// how many entries of each list were consumed. Every lane returns the
// merged count; *status and *covered are set on every lane.
template <class Head, class Trunc, class Emit>
__device__ int warp_merge(int L, int* pos, Head head, Trunc trunc,
                          long long need, int kmax, Emit emit, int* status,
                          long long* covered) {
  const int lane = threadIdx.x & 31;
  for (int j = lane; j < L; j += 32) pos[j] = 0;
  __syncwarp();
  float my_s;
  int my_i, my_j;
  bool my_blocked;
  auto lane_best = [&]() {
    my_s = -INFINITY;
    my_i = kNoNode;
    my_j = -1;
    my_blocked = false;
    for (int j = lane; j < L; j += 32) {
      Cand c;
      if (head(j, pos[j], c)) {
        if (better(c.s, c.i, my_s, my_i)) {
          my_s = c.s;
          my_i = c.i;
          my_j = j;
        }
      } else if (trunc(j)) {
        my_blocked = true;
      }
    }
  };
  lane_best();
  long long cov = 0;
  int out = 0;
  int st;
  while (true) {
    if (cov >= need || out >= kmax) {
      st = kMergeDone;
      break;
    }
    if (__any_sync(0xffffffffu, my_blocked)) {
      st = kMergeBlocked;
      break;
    }
    float bs = my_s;
    int bi = my_i;
    warp_argmax(bs, bi);
    if (bi == kNoNode) {
      st = kMergeExhausted;
      break;
    }
    const unsigned owner_mask = __ballot_sync(0xffffffffu, my_i == bi);
    const int owner = __ffs(owner_mask) - 1;
    int u = 0;
    if (lane == owner) {
      Cand c;
      head(my_j, pos[my_j], c);
      emit(out, c, cov);
      u = c.u;
      pos[my_j] += 1;
      lane_best();
    }
    u = __shfl_sync(0xffffffffu, u, owner);
    cov += u;
    out += 1;
  }
  __syncwarp();
  *status = st;
  *covered = cov;
  return out;
}

// A score's bits in an order-preserving form: a larger score has the
// larger value, and -0.0 has +0.0's, as better() and a sort compare them
// equal. 0 is below every score's.
__device__ __forceinline__ unsigned score_bits(float s) {
  unsigned b = __float_as_uint(s);
  if ((b << 1) == 0) b = 0;  // -0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// (score desc, index asc) as one unsigned key, larger is better: the
// score's bits (score_bits) above the complemented index. 0 is below
// every node's key.
__device__ __forceinline__ unsigned long long cand_key(float s, int i) {
  return ((unsigned long long)score_bits(s) << 32) |
         (0xffffffffu - (unsigned)i);
}
__device__ __forceinline__ float key_score(unsigned long long k) {
  const unsigned hi = (unsigned)(k >> 32);
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
}
__device__ __forceinline__ int key_index(unsigned long long k) {
  return (int)(0xffffffffu - (unsigned)k);
}

// One compare-exchange of a warp's bitonic sort (descending): position p
// against p ^ j in the lane j away, inside runs of k.
__device__ __forceinline__ void bitonic_step(unsigned long long& key,
                                             unsigned& val, int p, int j,
                                             int k) {
  const unsigned long long ok = __shfl_xor_sync(0xffffffffu, key, j);
  const unsigned ov = __shfl_xor_sync(0xffffffffu, val, j);
  const bool keep_larger = ((p & j) == 0) == ((p & k) == 0);
  if (keep_larger ? ok > key : ok < key) {
    key = ok;
    val = ov;
  }
}

// Sorts the warp's 32 (key, val) pairs, descending: lane l holds
// position l.
__device__ __forceinline__ void warp_sort32(unsigned long long& ka,
                                            unsigned& va) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) bitonic_step(ka, va, lane, j, k);
  }
}

// Sorts the warp's 64 (key, val) pairs, descending: lane l holds positions
// l (ka) and l + 32 (kb).
__device__ __forceinline__ void warp_sort64(unsigned long long& ka,
                                            unsigned& va,
                                            unsigned long long& kb,
                                            unsigned& vb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 64; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {  // both positions in this lane; k is 64: descending
        if (kb > ka) {
          const unsigned long long tk = ka;
          const unsigned tv = va;
          ka = kb;
          va = vb;
          kb = tk;
          vb = tv;
        }
      } else {
        bitonic_step(ka, va, lane, j, k);
        bitonic_step(kb, vb, lane + 32, j, k);
      }
    }
  }
}

// One warp's best min(kSelM, kleft) unit-bearing nodes, best first, into
// out[0, n), the rest of its kSelM slots filled with no_cand(). Lane l of
// the warp owns the block-local nodes tid, tid + T, ... (T = kSelThreads),
// whose score and units are in sc/un; a node's global index is idx0 + its
// local index. Each pass every lane offers its best two nodes not yet
// listed, one bitonic sort of the 64 offers orders them, and the sorted
// offers are listed up to the first second offer of a lane that holds a
// third node (which may rank next), as far as the units cover `need`.
// A list cut at kSelM entries before it covered `need`, ran out or
// reached kleft marks its last entry (kMark).
static __device__ void warp_select(const float* sc, const int* un, int n_loc,
                                   int idx0, long long need, int kleft,
                                   Cand* out) {
  const int lane = threadIdx.x & 31;
  const int mlim = min(kSelM, kleft);
  unsigned long long last = ~0ull;  // this lane's listed nodes rank above
  long long cov = 0;
  int cnt = 0;
  bool complete = false;
  while (true) {
    unsigned long long k0 = 0, k1 = 0;
    unsigned u0 = 0, u1 = 0;
    int left = 0;
    for (int l = threadIdx.x; l < n_loc; l += kSelThreads) {
      const int u = un[l];
      if (u <= 0) continue;
      const unsigned long long k = cand_key(sc[l], idx0 + l);
      if (k >= last) continue;
      ++left;
      if (k > k0) {
        k1 = k0;
        u1 = u0;
        k0 = k;
        u0 = (unsigned)u;
      } else if (k > k1) {
        k1 = k;
        u1 = (unsigned)u;
      }
    }
    const unsigned long long my0 = k0, my1 = k1;
    unsigned va = u0, vb = u1 | (left > 2 ? 0x80000000u : 0u);
    // one offer per lane at most: a 32-wide sort
    const bool two = __any_sync(0xffffffffu, k1 != 0);
    if (two) warp_sort64(k0, va, k1, vb);
    else warp_sort32(k0, va);
    const unsigned real_a = __ballot_sync(0xffffffffu, k0 != 0);
    const unsigned real_b = __ballot_sync(0xffffffffu, k1 != 0);
    const int nreal = __popc(real_a) + __popc(real_b);
    const unsigned fa = __ballot_sync(0xffffffffu, va >> 31);
    const unsigned fb = __ballot_sync(0xffffffffu, vb >> 31);
    const int valid = fa ? __ffs(fa) : fb ? 32 + __ffs(fb) : 64;
    const long long ua = va & 0x7fffffffu, ub = vb & 0x7fffffffu;
    long long sa = ua, sb = ub;  // inclusive scans of the units
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long ya = __shfl_up_sync(0xffffffffu, sa, off);
      if (lane >= off) sa += ya;
    }
    if (two) {
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const long long yb = __shfl_up_sync(0xffffffffu, sb, off);
        if (lane >= off) sb += yb;
      }
    }
    const long long tot_a = __shfl_sync(0xffffffffu, sa, 31);
    const long long prior_a = cov + sa - ua;
    const long long prior_b = cov + tot_a + sb - ub;
    const int lim = min(min(valid, nreal), mlim - cnt);
    const bool ta = lane < lim && prior_a < need;
    const bool tb = lane + 32 < lim && prior_b < need;
    const int n = __popc(__ballot_sync(0xffffffffu, ta)) +
                  __popc(__ballot_sync(0xffffffffu, tb));
    if (ta)
      out[cnt + lane] = Cand{key_score(k0), (int)ua, key_index(k0), 0};
    if (tb)
      out[cnt + lane + 32] = Cand{key_score(k1), (int)ub, key_index(k1), 0};
    if (n == 0) {  // no offers: the warp's nodes are all listed
      complete = true;
      break;
    }
    // the last listed offer, and the units listed with it
    const int q = n - 1;
    const unsigned long long kcut = __shfl_sync(
        0xffffffffu, q < 32 ? k0 : k1, q & 31);
    cov = __shfl_sync(0xffffffffu, q < 32 ? prior_a + ua : prior_b + ub,
                      q & 31);
    cnt += n;
    if (my1 != 0 && my1 >= kcut) last = my1;
    else if (my0 != 0 && my0 >= kcut) last = my0;
    if (cov >= need || cnt >= kleft || (n == nreal && !(fa | fb))) {
      complete = true;
      break;
    }
    if (cnt >= mlim) break;  // full: cut
  }
  __syncwarp();
  for (int t = cnt + lane; t < kSelM; t += 32) out[t] = no_cand();
  if (!complete && lane == 0) out[cnt - 1].o |= kMark;
  __syncwarp();
}

// The best kSelM of 16 sorted runs of kSelM candidates (best first,
// no_cand() last) in a[0, 512), sorted, into a[0, kSelM): four rounds
// each merge pairs of runs and keep the best kSelM of each pair. A thread
// places its candidate by a binary search in the partner run (a tie,
// only between no_cand()s, goes to the left run). tmp[512] is scratch.
// Every thread calls it.
static __device__ void merge_top(Cand* a, Cand* tmp) {
  static_assert(kMaxCluster * kSelM == kSelThreads, "one candidate a thread");
  const int t = threadIdx.x;
  Cand* src = a;
  Cand* dst = tmp;
  for (int r = kMaxCluster; r > 1; r >>= 1) {  // r runs in src
    if (t < r * kSelM) {
      const int run = t / kSelM, pos = t % kSelM;
      const Cand c = src[t];
      const Cand* partner = src + (run ^ 1) * kSelM;
      const bool left = (run & 1) == 0;
      int lo = 0, hi = kSelM;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const Cand q = partner[mid];
        const bool before = left ? better(q.s, q.i, c.s, c.i)
                                 : !better(c.s, c.i, q.s, q.i);
        if (before) lo = mid + 1;
        else hi = mid;
      }
      if (pos + lo < kSelM) dst[(run >> 1) * kSelM + pos + lo] = c;
    }
    __syncthreads();
    Cand* x = src;
    src = dst;
    dst = x;
  }
}

// Shared memory of one block of the selection. Blocks and leader only
// ever store into each other's: a block pushes its list into the
// leader's `gathered` before the first cluster barrier of a round, and
// the leader pushes the round's outcome into every block before the
// second, so no block reads another's shared memory.
struct SelectShared {
  Cand warp_list[kSelWarps][kSelM];
  Cand tmp[kSelThreads];
  Cand list[kSelM];               // the block's list
  int list_len;
  int list_trunc;
  Cand gathered[kMaxCluster][kSelM];  // the leader's: every block's list
  int g_len[kMaxCluster];
  int g_trunc[kMaxCluster];
  int pos[kMaxCluster];
  int last_i;                     // the leader's: its last merged entry
  int last_take;
  long long cov_cut;
  // pushed by the leader after each round
  int again;                      // a truncated list stopped the merge
  int consumed;                   // entries of this block's list merged
  int picks;                      // merged so far in this group
  int take_i;                     // the round's last entry and its take
  int take_n;
  long long covered;              // units merged so far in this group
};

// The block's list from its warps' lists (every thread calls it): the
// merged warp lists' first min(kSelM, kleft) entries, as far as they are
// known to be in order (up to a truncated warp list's last entry) and
// their units cover `need`.
static __device__ void block_select(SelectShared& sh, const float* sc,
                                    const int* un, int n_loc, int idx0,
                                    long long need, int kleft) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  warp_select(sc, un, n_loc, idx0, need, kleft, sh.warp_list[warp]);
  __syncthreads();
  Cand* merged = &sh.warp_list[0][0];
  merge_top(merged, sh.tmp);
  if (warp == 0) {
    const Cand c = merged[lane];
    const unsigned real = __ballot_sync(0xffffffffu, c.i != kNoNode);
    const unsigned marks = __ballot_sync(0xffffffffu, (c.o & kMark) != 0);
    const int nreal = __popc(real);
    const int valid = marks ? __ffs(marks) : 32;
    long long x = c.u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    const long long prior = x - c.u;
    const int lim = min(min(valid, nreal), min(kSelM, kleft));
    const bool take = lane < lim && prior < need;
    const int n = __popc(__ballot_sync(0xffffffffu, take));
    const long long cov =
        n > 0 ? __shfl_sync(0xffffffffu, x, (n - 1) & 31) : 0;
    if (take) sh.list[lane] = Cand{c.s, c.u, c.i, 0};
    if (lane == 0) {
      sh.list_len = n;
      // all known (32 or fewer real entries, none cut) and all listed
      const bool exhausted = n == nreal && nreal < 32 && !marks;
      sh.list_trunc = (cov >= need || n >= kleft || exhausted) ? 0 : 1;
    }
  }
  __syncthreads();
}

// Warp 0's cut of a merged run: merged[0, kSelM) holds the best kSelM of
// m candidates, sorted, a kMark on any entry after which candidates left
// out of the run may rank. The prefix taken ends at the first entry whose
// prior units reach `need`, at kmax entries, or after the first marked
// entry or the kSelM-th (kMergeBlocked: what was left out may rank
// next). For each entry taken, pos[its list] += 1 and emit(n, c, prior)
// runs, in parallel. Returns the number taken and sets *status, *cov (the
// units taken), *last_i and *last_take (the last entry and what it takes:
// min(units, need - prior)) on every lane.
template <class Emit>
__device__ int take_prefix(const Cand* merged, int m, long long need,
                           int kmax, int* pos, Emit emit, int* status,
                           long long* cov, int* last_i, int* last_take) {
  const int e = threadIdx.x & 31;
  const Cand c = merged[e];
  const unsigned marks = __ballot_sync(0xffffffffu, (c.o & kMark) != 0);
  int valid = marks ? __ffs(marks) : 1 << 30;
  if (m > kSelM) valid = min(valid, kSelM);  // the rest are not merged
  long long x = c.u;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, off);
    if (e >= off) x += y;
  }
  const long long prior = x - c.u;
  const int limit = min(min(valid, m), kmax);
  const bool take = e < limit && prior < need;
  const int cut = __popc(__ballot_sync(0xffffffffu, take));
  const int q = max(cut - 1, 0);
  *cov = cut > 0 ? __shfl_sync(0xffffffffu, x, q) : 0;
  *last_i = cut > 0 ? __shfl_sync(0xffffffffu, c.i, q) : -1;
  *last_take = (int)min(__shfl_sync(0xffffffffu, (long long)c.u, q),
                        need - __shfl_sync(0xffffffffu, prior, q));
  if (take) {
    atomicAdd(&pos[c.o & (kMark - 1)], 1);
    emit(e, Cand{c.s, c.u, c.i, 0}, prior);
  }
  if (*cov >= need || cut >= kmax) *status = kMergeDone;
  else if (cut == valid) *status = kMergeBlocked;
  else *status = kMergeExhausted;
  __syncwarp();
  return cut;
}

// The leader's merge of the blocks' lists (every thread of the leader
// calls it): the lists pushed into sh.gathered (g_len, g_trunc; L lists)
// are padded, their truncated ones' last entries marked, the best kSelM
// of them merged, and warp 0 takes its prefix (take_prefix), leaving
// sh.pos[j] (entries of list j taken), sh.last_i / last_take and
// sh.cov_cut. Returns the number taken and sets *status (in warp 0).
template <class Emit>
__device__ int merge_lists(SelectShared& sh, int L, long long need,
                           int kmax, Emit emit, int* status) {
  const int tid = threadIdx.x;
  const int j = tid >> 5, e = tid & 31;
  if (tid < kMaxCluster) sh.pos[tid] = 0;
  Cand* merged = &sh.gathered[0][0];
  const int len = j < L ? sh.g_len[j] : 0;
  if (e >= len) merged[tid] = no_cand();
  else if (e == len - 1 && sh.g_trunc[j]) merged[tid].o |= kMark;
  __syncthreads();
  merge_top(merged, sh.tmp);
  if (j != 0) return 0;
  const int m = (int)__reduce_add_sync(0xffffffffu, e < L ? sh.g_len[e] : 0);
  long long cov;
  int last_i, last_take;
  const int cut = take_prefix(merged, m, need, kmax, sh.pos, emit, status,
                              &cov, &last_i, &last_take);
  if (e == 0) {
    sh.cov_cut = cov;
    sh.last_i = last_i;
    sh.last_take = last_take;
  }
  __syncwarp();
  return cut;
}

// Writes one group's instance row in node-index order from its picks
// (pi[t], pt[t]: node, take; p of them, in any order): a pick's first slot
// is the sum of the takes of the picks with lower node indices; slots past
// the placed total are -1. Every thread of the block calls it, with
// stage[2 * blockDim.x] shared scratch; pi/pt are read through L2.
static __device__ void emit_instances(const int* pi, const int* pt, int p,
                                      int total, int* row, int max_count,
                                      int* stage) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int* stage_i = stage;
  int* stage_t = stage + nt;
  for (int t0 = 0; t0 < p; t0 += nt) {
    const int t = t0 + tid;
    const int mine = t < p ? __ldcg(pi + t) : 0;
    int start = 0;
    for (int c0 = 0; c0 < p; c0 += nt) {
      __syncthreads();
      if (c0 + tid < p) {
        stage_i[tid] = __ldcg(pi + c0 + tid);
        stage_t[tid] = __ldcg(pt + c0 + tid);
      }
      __syncthreads();
      const int n = min(nt, p - c0);
      for (int q = 0; q < n; ++q)
        if (stage_i[q] < mine) start += stage_t[q];
    }
    if (t < p) {
      const int take = __ldcg(pt + t);
      for (int j = 0; j < take && start + j < max_count; ++j)
        row[start + j] = mine;
    }
  }
  for (int q = total + tid; q < max_count; q += nt) row[q] = -1;
}

// The cluster's (score desc, index asc) prefix of unit-bearing nodes until
// their units cover `need` or `kmax` are merged. Every thread of every
// block of the cluster calls it with the same need and kmax; each block
// passes its own nodes (sc/un over n_loc local nodes, global index idx0 +
// local). emit(n, c, prior) runs on a thread of the leader (rank 0) for
// the n-th entry (in parallel over the entries of a round); prior is the
// units merged before it. After
// each round every block calls own(c, take) for each of its merged
// entries, take = min(units, need - prior) being what the waterfill
// places there, from as many threads as it has entries. Entries merged
// in an earlier round are taken out by zeroing their units in un.
// Returns the number merged and sets *covered to their units (in every
// thread). No shared memory of another block is touched after the last
// round's second barrier, so a block may exit right after.
template <class Emit, class Own>
__device__ int cluster_select(SelectShared& sh, const float* sc, int* un,
                              int n_loc, int idx0, long long need, int kmax,
                              Emit emit, Own own, long long* covered_out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nblk = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  long long covered = 0;  // merged before this round (same in every block)
  int picks = 0;
  while (true) {
    block_select(sh, sc, un, n_loc, idx0, need - covered, kmax - picks);
    SelectShared* lead = cluster.map_shared_rank(&sh, 0);
    if (tid < sh.list_len) {
      const Cand c = sh.list[tid];
      lead->gathered[rank][tid] = Cand{c.s, c.u, c.i, rank};
    }
    if (tid == 0) {
      lead->g_len[rank] = sh.list_len;
      lead->g_trunc[rank] = sh.list_trunc;
    }
    cluster.sync();  // every block's list is in the leader
    if (rank == 0) {
      int st = kMergeDone;
      const long long base_cov = covered;
      const int base_picks = picks;
      const int n = merge_lists(
          sh, nblk, need - covered, kmax - picks,
          [&](int n_, const Cand& c, long long prior) {
            emit(base_picks + n_, c, base_cov + prior);
          },
          &st);
      if (tid < nblk) {  // warp 0, which holds the merge's outcome
        SelectShared* r = cluster.map_shared_rank(&sh, tid);
        r->again = st == kMergeBlocked ? 1 : 0;
        r->consumed = sh.pos[tid];
        r->picks = base_picks + n;
        r->covered = base_cov + sh.cov_cut;
        r->take_i = sh.last_i;
        r->take_n = sh.last_take;
      }
    }
    cluster.sync();  // the round's outcome is in every block
    const int again = sh.again;
    const int used_up = sh.consumed;
    covered = sh.covered;
    picks = sh.picks;
    // only the round's last entry can take less than its units
    for (int t = tid; t < used_up; t += kSelThreads) {
      const Cand c = sh.list[t];
      own(c, c.i == sh.take_i ? sh.take_n : c.u);
      if (again) un[c.i - idx0] = 0;
    }
    __syncthreads();
    if (!again) break;
  }
  *covered_out = covered;
  return picks;
}


// ---------------------------------------------------------------------------
// The waterfill as a unit-weighted radix select (K4, K5 and K7's phases)
// ---------------------------------------------------------------------------
//
// The full waterfill (kernels.py _waterfill) sorts the nodes by (score
// desc, index asc), takes the int32 cumsum `prior` of their units in that
// order and gives each take = clamp(count - prior, 0, units). Only one
// node takes part of its units: the boundary b, the first whose prior +
// units reaches count. Nodes before it take all, nodes after it none. So
// the waterfill is a search for b, weighted by units, and needs no sort and
// no pick per node: a radix select from the score's top digit.
//   * Each unit-bearing node has the key score_bits(score) and the weight
//     units; a node without units drops out.
//   * Round 0 gathers each block's units and its lowest and highest key.
//     If all units fit the count, every node takes all its units (the
//     shortcut). If every key is the same, the nodes share the count in
//     node-index order and the select ends here. Otherwise the radix
//     passes start at the first 8-bit digit where the lowest and highest
//     keys differ; the digits above it are the same in every key.
//   * Pass p builds the cluster's histogram of digit p over the nodes whose
//     higher digits equal the prefix fixed so far: each block adds its
//     nodes into its own 256 bins (shared atomics), then
//     its nonzero bins into the leader's (distributed shared memory). The
//     leader scans them from the top digit down with the need still open,
//     fixes the digit where the units above reach the need, and writes the
//     outcome (the prefix, the need left) into every block's shared memory.
//     If the fixed digit's bin holds exactly the need, every node from that
//     bin up takes all.
//   * After the last digit the boundary key is known and the need is what
//     the nodes tied at it share: they take it in node-index order, from an
//     index-ordered prefix sum of their units across the cluster's slices
//     (blocks hold contiguous slices in rank order; the leader sends each
//     block the tied units of the blocks before it).
// Rounds 0 and the tie round are one cluster barrier each: every block
// stores its part into every block's shared memory (double-buffered by
// round parity, so a round's stores never meet the previous round's
// reads) and each block decides alone. A radix pass is two: the blocks'
// bins go to the leader only, which scans them and stores the outcome
// into every block. When every block read the leader's bins through
// distributed shared memory instead, the leader's SM served 15 x 2 KB a
// pass and a pass cost ~9,000 cycles (PERF.md, PR 5).
// Weights are summed in 64 bits, so the takes are the reference's wherever
// its int32 cumsum does not wrap (every unit total below 2^31, the domain
// where the pick loop this replaces agreed with it too).

constexpr int kBins = 256;

struct WaterShared {
  unsigned long long hist[kBins];   // the leader's: the cluster's bins
  unsigned long long local[kBins];  // this block's bins of the pass
  unsigned long long warp_sum[32];  // block scans
  unsigned warp_lo[32];
  unsigned warp_hi[32];
  // every block's units (round 0) or tied units, and its lowest and
  // highest key (round 0), stored by that block; [round parity][rank]
  unsigned long long part[2][kMaxCluster];
  unsigned part_lo[2][kMaxCluster];
  unsigned part_hi[2][kMaxCluster];
  // a radix pass's outcome, stored by the leader
  unsigned long long need;  // the need left at the fixed prefix
  unsigned prefix;          // the fixed prefix, or the cut (kSelCut)
  int mode;
};

enum SelectMode { kSelRun = 0, kSelCut = 1, kSelTie = 2 };

// Zeroes the select's bins; then the cluster's barrier. Every thread of
// every block of the cluster calls it once, before the first
// cluster_waterfill.
static __device__ void waterfill_init(WaterShared& ws) {
  for (int t = threadIdx.x; t < 2 * kBins; t += blockDim.x)
    (&ws.hist[0])[t] = 0;
  cooperative_groups::this_cluster().sync();
}

// The local nodes [l0, l1) this thread owns: contiguous runs in thread
// order, so an index-ordered scan follows the threads.
__device__ __forceinline__ void own_range(int n_loc, int& l0, int& l1) {
  const int per = (n_loc + (int)blockDim.x - 1) / (int)blockDim.x;
  l0 = min((int)threadIdx.x * per, n_loc);
  l1 = min(l0 + per, n_loc);
}

// Adds each lane's w into bins[d] (d == kBins: none, with w 0). Every lane
// calls it. A warp whose lanes share one digit (a run of tied scores) adds
// once, so ties do not serialise 32 atomics on one bin; other warps add
// lane by lane.
__device__ __forceinline__ void warp_bin_add(unsigned long long* bins,
                                             unsigned d, unsigned w) {
  const unsigned active = __ballot_sync(0xffffffffu, d < kBins);
  if (active == 0) return;
  const int first = __ffs(active) - 1;
  const unsigned d0 = __shfl_sync(0xffffffffu, d, first);
  if (__all_sync(0xffffffffu, d == d0 || d == kBins)) {
    // two 16-bit halves: 32 lanes of up to 2^31 - 1 do not fit 32 bits
    const unsigned lo = __reduce_add_sync(0xffffffffu, w & 0xffffu);
    const unsigned hi = __reduce_add_sync(0xffffffffu, w >> 16);
    if ((int)(threadIdx.x & 31) == first)
      atomicAdd(&bins[d0], ((unsigned long long)hi << 16) + lo);
  } else if (d < kBins) {
    atomicAdd(&bins[d], (unsigned long long)w);
  }
}

// Inclusive warp scan of x.
__device__ __forceinline__ unsigned long long warp_incl(unsigned long long x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The block's exclusive scan of each thread's x, in thread order (every
// thread calls it); *total gets the block's sum.
__device__ __forceinline__ unsigned long long block_excl(
    WaterShared& ws, unsigned long long x, unsigned long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned long long incl = warp_incl(x);
  if (lane == 31) ws.warp_sum[warp] = incl;
  __syncthreads();
  unsigned long long before = 0, sum = 0;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) {
    if (w < warp) before += ws.warp_sum[w];
    sum += ws.warp_sum[w];
  }
  *total = sum;
  return before + incl - x;
}

// Thread r < blocks stores this block's part into block r's parts of this
// parity (every thread calls it); then the cluster's barrier.
__device__ __forceinline__ void share_part(WaterShared& ws, int parity,
                                           unsigned long long units,
                                           unsigned lo, unsigned hi) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  if ((int)threadIdx.x < (int)cluster.num_blocks()) {
    WaterShared* dst = cluster.map_shared_rank(&ws, threadIdx.x);
    dst->part[parity][rank] = units;
    dst->part_lo[parity][rank] = lo;
    dst->part_hi[parity][rank] = hi;
  }
  cluster.sync();
}

template <class Apply>
__device__ long long cluster_waterfill(WaterShared& ws, int& rounds,
                                       const float* sc, const int* un,
                                       int n_loc, long long need,
                                       Apply apply) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nblk = (int)cluster.num_blocks();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int per = (n_loc + nt - 1) / nt;
  int l0, l1;
  own_range(n_loc, l0, l1);
  WaterShared* lead = cluster.map_shared_rank(&ws, 0);
  __syncthreads();  // the block's sc/un are written
  if (need <= 0) {
    for (int l = l0; l < l1; ++l) apply(l, 0);
    return 0;
  }
  const unsigned long long count = (unsigned long long)need;

  // round 0: each block's units and its lowest and highest key
  unsigned long long mine = 0;
  unsigned lo_b = 0xffffffffu, hi_b = 0;
  for (int l = l0; l < l1; ++l) {
    if (un[l] > 0) {
      const unsigned b = score_bits(sc[l]);
      mine += (unsigned)un[l];
      lo_b = min(lo_b, b);
      hi_b = max(hi_b, b);
    }
  }
  lo_b = __reduce_min_sync(0xffffffffu, lo_b);
  hi_b = __reduce_max_sync(0xffffffffu, hi_b);
  if (lane == 0) {
    ws.warp_lo[warp] = lo_b;
    ws.warp_hi[warp] = hi_b;
  }
  unsigned long long block_total;
  unsigned long long off = block_excl(ws, mine, &block_total);
  for (int w = 0; w < nt / 32; ++w) {
    lo_b = min(lo_b, ws.warp_lo[w]);
    hi_b = max(hi_b, ws.warp_hi[w]);
  }
  int parity = rounds & 1;
  share_part(ws, parity, block_total, lo_b, hi_b);
  ++rounds;
  // every warp reads the parts: the cluster's total, keys, and the units of
  // the blocks before this one
  const unsigned long long t = lane < nblk ? ws.part[parity][lane] : 0;
  const unsigned long long t_incl = warp_incl(t);
  const unsigned long long total = __shfl_sync(0xffffffffu, t_incl, 31);
  const unsigned long long base =
      rank == 0 ? 0 : __shfl_sync(0xffffffffu, t_incl, rank - 1);
  const unsigned lo = __reduce_min_sync(
      0xffffffffu, lane < nblk ? ws.part_lo[parity][lane] : 0xffffffffu);
  const unsigned hi = __reduce_max_sync(
      0xffffffffu, lane < nblk ? ws.part_hi[parity][lane] : 0u);
  int mode, start = 0;
  unsigned prefix = 0;
  unsigned long long nd = count;
  unsigned long long placed = count;
  if (total <= count) {  // every node takes all its units
    mode = kSelCut;
    placed = total;
  } else if (lo == hi) {  // one key: the count shared in index order
    mode = kSelTie;
    prefix = lo;
    off += base;
  } else {  // the digits above the first that differs are shared
    mode = kSelRun;
    start = __clz(lo ^ hi) / 8;
    prefix = start == 0 ? 0 : hi >> (32 - 8 * start);
  }

  for (int p = start; p < 4 && mode == kSelRun; ++p) {
    const int shift = 24 - 8 * p;
    for (int j = 0; j < per; ++j) {
      const int l = tid * per + j;
      unsigned d = kBins, w = 0;
      if (l < n_loc && un[l] > 0) {
        const unsigned b = score_bits(sc[l]);
        if (p == 0 || (b >> (shift + 8)) == prefix) {
          d = (b >> shift) & (kBins - 1);
          w = (unsigned)un[l];
        }
      }
      warp_bin_add(ws.local, d, w);
    }
    __syncthreads();
    for (int b = tid; b < kBins; b += nt) {
      const unsigned long long v = ws.local[b];
      if (v != 0) {
        atomicAdd(&lead->hist[b], v);
        ws.local[b] = 0;
      }
    }
    cluster.sync();  // every block's bins are in the leader's
    if (rank == 0 && warp == 0) {
      // lane L holds bins 255 - 8L down to 248 - 8L, and zeroes them
      unsigned long long v[8], lane_sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = ws.hist[kBins - 1 - 8 * lane - j];
        ws.hist[kBins - 1 - 8 * lane - j] = 0;
        lane_sum += v[j];
      }
      const unsigned long long incl = warp_incl(lane_sum);
      const int f = __ffs(__ballot_sync(0xffffffffu, incl >= nd)) - 1;
      unsigned long long above = incl - lane_sum, vj = 0;
      int j = 0;
      if (lane == f) {
        while (above + v[j] < nd) above += v[j++];
        vj = v[j];
      }
      above = __shfl_sync(0xffffffffu, above, f);
      vj = __shfl_sync(0xffffffffu, vj, f);
      j = __shfl_sync(0xffffffffu, j, f);
      const unsigned fixed = (prefix << 8) | (kBins - 1 - 8 * f - j);
      const unsigned long long left = nd - above;
      // the bin holds exactly the need: every node from its lowest score
      // bits up takes all
      const int m = left == vj ? kSelCut : kSelRun;
      if (lane < nblk) {
        WaterShared* dst = cluster.map_shared_rank(&ws, lane);
        dst->need = left;
        dst->prefix = m == kSelCut ? fixed << shift : fixed;
        dst->mode = m;
      }
    }
    cluster.sync();  // the outcome is in every block
    ++rounds;
    mode = ws.mode;
    prefix = ws.prefix;
    nd = ws.need;
  }
  if (mode == kSelRun) {
    // the nodes tied at the boundary key share nd in index order
    mode = kSelTie;
    unsigned long long tied = 0;
    for (int l = l0; l < l1; ++l)
      if (un[l] > 0 && score_bits(sc[l]) == prefix) tied += (unsigned)un[l];
    unsigned long long tied_total;
    off = block_excl(ws, tied, &tied_total);
    parity = rounds & 1;
    share_part(ws, parity, tied_total, 0, 0);
    ++rounds;
    const unsigned long long x = warp_incl(
        lane < nblk ? ws.part[parity][lane] : 0);
    off += rank == 0 ? 0 : __shfl_sync(0xffffffffu, x, rank - 1);
  }
  for (int l = l0; l < l1; ++l) {
    const int u = un[l];
    int take = 0;
    if (u > 0) {
      const unsigned b = score_bits(sc[l]);
      if (mode == kSelCut) {
        take = b >= prefix ? u : 0;
      } else if (b > prefix) {
        take = u;
      } else if (b == prefix) {
        take = off >= nd ? 0 : (int)min((unsigned long long)u, nd - off);
        off += (unsigned)u;
      }
    }
    apply(l, take);
  }
  return (long long)placed;
}

}  // namespace nomad
