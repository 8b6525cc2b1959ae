// Node-sharded placement solves: the mesh route.
//
// Replaces two kernels of nomad_tpu/scheduler/tpu/kernels.py:
//   * make_sharded_solver (:583) with _sharded_waterfill (:385),
//     _topk_fill (:404) and _candidates_to_inst (:457): the node axis
//     split into D equal shards; per scan step (one group) every shard
//     scores its own rows, the shards' vectors are gathered, and the
//     waterfill decision runs replicated. Full mode gathers the [Np]
//     score and units; top-k mode gathers each shard's k best
//     (score, units, global index) triples; compact mode also emits the
//     [G, maxC] instance list in node order, plus over [Np] and used';
//   * make_sharded_solver_preempt (:475): solve_placement_preempt's two
//     phases per group, each a full-gather waterfill, with phase 1's
//     placed total (the reference's psum) feeding phase 2's remainder.
// Same inputs, same outputs, bit for bit, and equal to the single-card
// kernels (solve_compact.cu, solve_dense.cu) on the same inputs.
//
// How the shards map onto the card: one process drives every shard. The
// shards of one card are contiguous rows of one [rows, 3] tensor, and
// one launch serves all of them. The exchange between cards happens
// outside these kernels (scheduler/gpu/kernels.py): each kernel reads a
// gathered buffer in which every shard has written its part, so between
// shards of one card the gather costs nothing.
//
// Five kernels, launched per card in order on the card's stream:
//   shard_score         one thread-block cluster per shard, up to 16
//                       blocks wide (D x size <= the card's SMs: 8 shards
//                       x 16 = 128 of 132), each block a contiguous part
//                       of the shard's rows: units and score
//                       (solve_common.cuh); full and preemption modes
//                       write them into the gathered [Np] vectors, top-k
//                       mode runs the cluster-wide selection
//                       (solve_common.cuh cluster_select) into the
//                       shard's [k] slot of the [D*k] candidate buffer;
//   candidate_fill      one block: the D sorted candidate lists merged in
//                       (score desc, global index asc) order, which is
//                       argsort by index then stable argsort by -score,
//                       min(units, left) placed on each until the group
//                       is placed, the card's own takes applied; in
//                       compact mode the picks are kept for the rows;
//   gathered_waterfill  full mode, one block: a pick loop over the
//                       gathered [Np] vectors (picking the best
//                       unit-bearing node until `count` is placed is the
//                       stable-argsort waterfill), applying the card's
//                       own takes;
//   gathered_select     the preemption solve's two phases, one thread-
//                       block cluster of up to 16 blocks over the gathered
//                       [Np] vectors, each block a contiguous slice of
//                       them in shared memory: the unit-weighted radix
//                       select (solve_common.cuh cluster_waterfill), at
//                       most 10 cluster barriers a phase however many
//                       nodes receive instances (one when its units all
//                       fit or its scores all tie), then each block
//                       applies the card's own rows of its slice;
//                       phase 1 leaves its remainder on the card for phase
//                       2, which applies the victim accounting (`freed`,
//                       `used_new`);
//   shard_finish        after the scan: over [rows] (compact mode) or the
//                       preemption solve's used' = used - freed + used_new.
// On one card the preemption solve's whole chain (4 launches a group and
// the finish) is captured once per shape into a CUDA graph and replayed
// (scheduler/gpu/kernels.py): every entry point launches on the stream it
// is given and allocates nothing.
//
// What bounds it on the card: not bytes (c2m_sharded moves ~10 MB per
// batch) but the step-by-step dependency between groups (two launches
// per step, each waiting on the last) and, inside a step, the barriers
// of the selection. A shard's selection stops early: its later
// candidates can only rank after its earlier ones, so once the units it
// has selected cover the group's count, nothing it would add could
// receive an instance. Its unfilled slots carry no units.
//
// Numerics: solve_common.cuh (floor-div units, int32 wrap, XLA's score
// rounding; build with --fmad=false). Ties go to the lower global node
// index, as lax.top_k and a stable argsort order them.

#include "solve_common.cuh"

namespace {

using namespace nomad;

enum ScoreMode { kFull = 0, kTopk = 1, kPhase1 = 2, kPhase2 = 3 };

// the candidate fill's list heads (kernels.py MAX_SHARDS)
constexpr int kMaxShards = 1024;

struct ScoreArgs {
  int mode;
  int g;
  int init;               // first step: set up the card's working rows
  const int* cap;         // [rows, 3]
  const int* used_in;     // [rows, 3]: K6's used, K7's used_exist
  int* used;              // [rows, 3]: K6's working used'
  int* used_new;          // [rows, 3] (K7): this solve's placements
  int* freed;             // [rows, 3] (K7): victim usage claimed
  int* take1;             // [rows] (K7): phase 1's takes this step
  const int* prefix;      // [tp, rows, 3] (K7) cumulative tier usage
  int tp;
  const int* tier_limit;  // [gp] (K7)
  const int* rem;         // [1] (K7): phase 1's remainder
  const int* asks;        // [gp, 3]
  const int* counts;      // [gp]
  const uint8_t* feas;    // [gp, rows] bool
  const float* bias;      // [gp, rows]
  const int* ucap;        // [gp, rows]
  int* assign;            // [gp, rows] or null
  int* evict;             // [gp, rows] (K7)
  float* score_s;         // scratch [rows] (top-k)
  int* units_s;           // scratch [rows] (top-k)
  float* g_score;         // gathered: [Np], or [D * k] candidates
  int* g_units;
  int* g_idx;             // [D * k] candidates' global indices
  int rows;
  int w;                  // rows per shard
  int s0;                 // global index of the card's first shard
  int k;
  int smem_rows;          // top-k: score/units of a block's rows in shared
                          // memory (else in score_s/units_s)
};

__global__ void __launch_bounds__(kSelThreads, 1)
shard_score_kernel(ScoreArgs a) {
  __shared__ SelectShared sh;
  extern __shared__ __align__(16) uint8_t dsm[];

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int csize = (int)cluster.num_blocks();
  const int shard = blockIdx.x / csize;  // one cluster per shard
  const int sub = (a.w + csize - 1) / csize;
  const int shard_lo = shard * a.w;      // the shard's first card row
  const int lo = min(shard_lo + (int)cluster.block_rank() * sub,
                     shard_lo + a.w);    // this block's rows [lo, hi)
  const int hi = min(lo + sub, shard_lo + a.w);
  float* sc = a.smem_rows ? (float*)dsm : a.score_s + lo;
  int* un = a.smem_rows ? (int*)(dsm + (size_t)sub * 4) : a.units_s + lo;
  const int base = a.s0 * a.w;           // global index of card row 0
  const bool pre = a.mode >= kPhase1;
  if (a.init) {
    for (int t = lo * 3 + tid; t < hi * 3; t += kSelThreads) {
      if (pre) {
        a.used_new[t] = 0;
        a.freed[t] = 0;
      } else {
        a.used[t] = a.used_in[t];
      }
    }
    __syncthreads();
  }
  const int g = a.g;
  int count = a.counts[g];
  const int* prow = nullptr;
  if (a.mode == kPhase2) {
    count = *a.rem;
    if (count <= 0) return;  // the same in every thread: nothing to place
    int klim = a.tier_limit[g];
    klim = min(max(klim < 0 ? klim + a.tp : klim, 0), a.tp - 1);
    prow = a.prefix + (size_t)klim * a.rows * 3;
  }
  const int ask[3] = {a.asks[g * 3 + 0], a.asks[g * 3 + 1], a.asks[g * 3 + 2]};
  const float af0 = (float)ask[0];
  const float af1 = (float)ask[1];
  const size_t row = (size_t)g * a.rows;

  for (int n = lo + tid; n < hi; n += kSelThreads) {
    const int* c = a.cap + n * 3;
    int ut[3];
    if (pre) {
#pragma unroll
      for (int r = 0; r < 3; ++r)
        ut[r] = wrap_add(wrap_sub(a.used_in[n * 3 + r], a.freed[n * 3 + r]),
                         a.used_new[n * 3 + r]);
    } else {
#pragma unroll
      for (int r = 0; r < 3; ++r) ut[r] = a.used[n * 3 + r];
    }
    int free[3], su[3];
    int ucap = a.ucap[row + n];
    if (a.mode == kPhase2) {
      // the remainder on free capacity plus the preemptible tiers' usage
      // not yet claimed by an earlier group
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int p = max(wrap_sub(prow[n * 3 + r], a.freed[n * 3 + r]), 0);
        free[r] = wrap_add(wrap_sub(c[r], ut[r]), p);
        su[r] = max(wrap_sub(ut[r], p), 0);
      }
      ucap = wrap_sub(ucap, a.take1[n]);
    } else {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        free[r] = wrap_sub(c[r], ut[r]);
        su[r] = ut[r];
      }
    }
    const int units = units_for(free, ask, ucap, a.feas[row + n] != 0, count);
    float s = -INFINITY;
    if (units > 0)
      s = score_fit(c[0], c[1], (float)su[0], (float)su[1], af0, af1,
                    a.bias[row + n]);
    if (a.mode == kTopk) {
      sc[n - lo] = s;
      un[n - lo] = units;
    } else {
      a.g_score[base + n] = s;
      a.g_units[base + n] = units;
    }
    if (a.mode == kPhase1) {
      a.take1[n] = 0;
      a.evict[row + n] = 0;
    }
    if (a.mode != kPhase2 && a.assign != nullptr) a.assign[row + n] = 0;
  }
  if (a.mode != kTopk) return;

  // top-k: the shard's best unit-bearing rows, best first, into its slot
  // of the candidate buffer, until they cover the group's count
  __syncthreads();
  const int slot = (a.s0 + shard) * a.k;
  int j = 0;
  long long covered = 0;
  if (count > 0)
    j = cluster_select(
        sh, sc, un, hi - lo, base + lo, count, a.k,
        [&](int n, const Cand& c, long long) {
          a.g_score[slot + n] = c.s;
          a.g_units[slot + n] = c.u;
          a.g_idx[slot + n] = c.i;
        },
        [](const Cand&, int) {}, &covered);
  if (cluster.block_rank() == 0) {
    for (int t = j + tid; t < a.k; t += kSelThreads) {
      a.g_score[slot + t] = -INFINITY;
      a.g_units[slot + t] = 0;
      a.g_idx[slot + t] = kNoNode;
    }
  }
}

struct FillArgs {
  int g;
  const int* asks;        // [gp, 3]
  const int* counts;      // [gp]
  const float* g_score;   // [D * k] candidates, each shard's slot sorted
  const int* g_units;
  const int* g_idx;
  int d;                  // shards in the mesh
  int k;
  int w;
  int s0;
  int rows;
  int* used;              // [rows, 3] the card's working used'
  int* assign;            // [gp, rows] or null (top-k mode)
  int* inst;              // [gp, max_count] or null (compact mode)
  int max_count;
  int* picks;             // compact mode: [gp, 2, D * k] each group's picks
                          // and takes, then [gp] picks, [gp] instances
  int gp;
};

__global__ void __launch_bounds__(kThreads, 1)
candidate_fill_kernel(FillArgs a) {
  __shared__ Cand pool[2 * kSelThreads];
  Cand* stage = pool;
  Cand* tmp = pool + kSelThreads;
  __shared__ int head_pos[kMaxShards];
  __shared__ int done[kMaxShards];   // entries of each list merged so far
  __shared__ int stage_len[kMaxShards];
  __shared__ int npicks;
  __shared__ long long placed;
  __shared__ int again;

  const int tid = threadIdx.x;
  const int g = a.g;
  const int count = a.counts[g];
  const int ask[3] = {a.asks[g * 3 + 0], a.asks[g * 3 + 1], a.asks[g * 3 + 2]};
  const int base = a.s0 * a.w;
  const size_t dk = (size_t)a.d * a.k;
  int* pick_g = a.picks + (size_t)g * 2 * dk;
  int* pick_t = pick_g + dk;
  // the q-th candidate of the fill places min(units, left) (prior: the
  // units filled before it); the card applies its own rows' takes
  auto fill = [&](int q, const Cand& c, long long prior) {
    const int tk = (int)min((long long)c.u, (long long)count - prior);
    if (a.inst != nullptr) {
      pick_g[q] = c.i;
      pick_t[q] = tk;
    }
    const int l = c.i - base;
    if (l >= 0 && l < a.rows) {
#pragma unroll
      for (int r = 0; r < 3; ++r)
        a.used[l * 3 + r] = wrap_add(a.used[l * 3 + r], wrap_mul(tk, ask[r]));
      if (a.assign != nullptr) a.assign[(size_t)g * a.rows + l] = tk;
    }
  };

  for (int j = tid; j < a.d; j += kThreads) done[j] = 0;
  if (tid == 0) {
    npicks = 0;
    placed = 0;
  }
  __syncthreads();
  if (a.d <= kMaxCluster) {
    // up to 16 lists: a window of 32 entries of each, merged best-32 by
    // merge_top and cut by take_prefix; a window used up before its
    // list's end stops the cut, and the next windows are merged
    do {
      const int j = tid / kSelM, e = tid % kSelM;
      if (tid < kMaxCluster) head_pos[tid] = 0;
      bool real = false;
      if (tid < kSelThreads) {
        Cand c = no_cand();
        const int p = j < a.d ? done[j] + e : a.k;
        const int at = j * a.k + p;
        if (p < a.k && a.g_units[at] > 0) {
          c = Cand{a.g_score[at], a.g_units[at], a.g_idx[at], j};
          real = true;
          if (e == kSelM - 1 && p + 1 < a.k && a.g_units[at + 1] > 0)
            c.o |= kMark;
        }
        stage[tid] = c;
      }
      const int m = __syncthreads_count(real);
      merge_top(stage, tmp);
      if (tid < 32) {
        int st, li, lt;
        long long cov;
        const long long before = placed;
        const int n0 = npicks;
        const int n = take_prefix(
            stage, m, (long long)count - before, 0x7fffffff, head_pos,
            [&](int q, const Cand& c, long long prior) {
              fill(n0 + q, c, before + prior);
            },
            &st, &cov, &li, &lt);
        if (tid < a.d) done[tid] += head_pos[tid];
        if (tid == 0) {
          npicks = n0 + n;
          placed = before + cov;
          again = st == kMergeBlocked ? 1 : 0;
        }
      }
      __syncthreads();
    } while (again);
  } else {
    // more lists: one warp merges windows of them (lane l holds lists l,
    // l + 32, ...) in order; a window used up before its list's end stops
    // the merge, and the next windows are staged
    Cand* window = pool;
    const int per = max(1, 2 * kSelThreads / a.d);  // entries per list
    do {
      for (int j = tid; j < a.d; j += kThreads) stage_len[j] = 0;
      __syncthreads();
      for (int t = tid; t < a.d * per; t += kThreads) {
        const int j = t / per, e = t % per;
        const int p = done[j] + e;
        const int at = j * a.k + p;
        if (p < a.k && a.g_units[at] > 0) {
          window[t] = Cand{a.g_score[at], a.g_units[at], a.g_idx[at], j};
          // a list's unit-bearing entries come first: its last one sets
          // the window's length
          if (e == per - 1 || p + 1 >= a.k || a.g_units[at + 1] <= 0)
            stage_len[j] = e + 1;
        }
      }
      __syncthreads();
      if (tid < 32) {
        int st;
        long long cov;
        const long long before = placed;
        const int n0 = npicks;
        const int n = warp_merge(
            a.d, head_pos,
            [&](int j, int p, Cand& c) {
              if (p >= stage_len[j]) return false;
              c = window[j * per + p];
              return true;
            },
            [&](int j) { return stage_len[j] == per && done[j] + per < a.k; },
            (long long)count - before, 0x7fffffff,
            [&](int q, const Cand& c, long long prior) {
              fill(n0 + q, c, before + prior);
            },
            &st, &cov);
        for (int j = tid; j < a.d; j += 32) done[j] += head_pos[j];
        if (tid == 0) {
          npicks = n0 + n;
          placed = before + cov;
          again = st == kMergeBlocked ? 1 : 0;
        }
      }
      __syncthreads();
    } while (again);
  }
  if (a.inst != nullptr && tid == 0) {
    int* counts_out = a.picks + (size_t)a.gp * 2 * dk;
    counts_out[g] = npicks;
    counts_out[a.gp + g] = (int)min(placed, (long long)count);
  }
}

// compact mode, after the scan: each group's instance row from its picks
__global__ void shard_inst_kernel(const int* picks, int gp, int dk,
                                  int* inst, int max_count) {
  __shared__ int stage[2 * 256];
  const int g = blockIdx.x;
  const int* pg = picks + (size_t)g * 2 * dk;
  const int* counts = picks + (size_t)gp * 2 * dk;
  emit_instances(pg, pg + dk, __ldcg(counts + g), __ldcg(counts + gp + g),
                 inst + (size_t)g * max_count, max_count, stage);
}

enum GatherMode { kWaterFull = 0, kWaterPhase1 = 1, kWaterPhase2 = 2 };

struct WaterArgs {
  int g;
  const int* asks;        // [gp, 3]
  const int* counts;      // [gp]
  const float* g_score;   // [np] gathered
  int* g_units;           // [np] gathered (picked nodes are zeroed)
  int np;
  int base;               // global index of card row 0
  int rows;
  int* used;              // [rows, 3] the card's working used'
  int* assign;            // [gp, rows]
};

// Block-wide argmax of (s, i); every thread returns the winner.
static __device__ void block_argmax(float s, int i, float* sh_s,
                                    int* sh_i, float* out_s, int* out_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float os = __shfl_down_sync(0xffffffffu, s, off);
    int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
  if (lane == 0) {
    sh_s[warp] = s;
    sh_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    s = sh_s[lane];
    i = sh_i[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      float os = __shfl_down_sync(0xffffffffu, s, off);
      int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (better(os, oi, s, i)) {
        s = os;
        i = oi;
      }
    }
    if (lane == 0) {
      *out_s = s;
      *out_i = i;
    }
  }
  __syncthreads();
}

// Full mode: the best node that still has units takes min(units, left)
// until the group is placed.
__global__ void __launch_bounds__(kThreads, 1)
gathered_waterfill_kernel(WaterArgs a) {
  __shared__ float sh_s[kWarps];
  __shared__ int sh_i[kWarps];
  __shared__ float best_s;
  __shared__ int best_i;
  __shared__ int remaining;

  const int tid = threadIdx.x;
  const int g = a.g;
  const int count = a.counts[g];
  const int ask[3] = {a.asks[g * 3 + 0], a.asks[g * 3 + 1], a.asks[g * 3 + 2]};
  const size_t row = (size_t)g * a.rows;
  float my_s = -INFINITY;
  int my_i = kNoNode;
  if (count > 0) {
    for (int n = tid; n < a.np; n += kThreads) {
      if (a.g_units[n] > 0 && better(a.g_score[n], n, my_s, my_i)) {
        my_s = a.g_score[n];
        my_i = n;
      }
    }
  }
  if (tid == 0) remaining = count;
  __syncthreads();
  int rem = count;
  while (rem > 0) {
    block_argmax(my_s, my_i, sh_s, sh_i, &best_s, &best_i);
    const int bi = best_i;
    if (bi == kNoNode) break;
    if ((bi % kThreads) == tid) {
      const int tk = min(a.g_units[bi], remaining);
      remaining -= tk;
      a.g_units[bi] = 0;
      const int l = bi - a.base;
      if (l >= 0 && l < a.rows) {
#pragma unroll
        for (int r = 0; r < 3; ++r)
          a.used[l * 3 + r] = wrap_add(a.used[l * 3 + r], wrap_mul(tk, ask[r]));
        a.assign[row + l] = tk;
      }
      my_s = -INFINITY;
      my_i = kNoNode;
      for (int n = tid; n < a.np; n += kThreads) {
        if (a.g_units[n] > 0 && better(a.g_score[n], n, my_s, my_i)) {
          my_s = a.g_score[n];
          my_i = n;
        }
      }
    }
    __syncthreads();
    rem = remaining;
  }
}

struct SelectArgs {
  int mode;               // kWaterPhase1 or kWaterPhase2
  int g;
  const int* asks;        // [gp, 3]
  const int* counts;      // [gp]
  int* rem;               // [1]: written by phase 1, read by phase 2
  const float* g_score;   // [np] gathered
  const int* g_units;     // [np] gathered
  int np;
  int slice;              // S: gathered entries per block
  int smem;               // the slice's score and units in shared memory
  int base;               // global index of card row 0
  int rows;
  const int* cap;         // [rows, 3]
  const int* used_in;     // [rows, 3] (used_exist)
  int* used_new;          // [rows, 3]
  int* freed;             // [rows, 3]
  int* take1;             // [rows]
  const int* prefix;      // [tp, rows, 3]
  int tp;
  const int* tier_limit;  // [gp]
  int* assign;            // [gp, rows]
  int* evict;             // [gp, rows]
};

// One phase of one group of the preemption solve over the gathered
// vectors; each block applies the takes of the card's own rows in its
// slice (shard_score zeroed the group's rows in phase 1).
__global__ void __launch_bounds__(kSelThreads, 1)
gathered_select_kernel(SelectArgs a) {
  __shared__ WaterShared ws;
  extern __shared__ __align__(16) uint8_t dsm[];

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int S = a.slice;
  const int lo = rank * S;
  const int n_loc = max(0, min(S, a.np - lo));
  waterfill_init(ws);
  const int g = a.g;
  const int count = a.mode == kWaterPhase2 ? *a.rem : a.counts[g];
  const float* sc = a.g_score + lo;
  const int* un = a.g_units + lo;
  if (a.smem) {
    float* ssc = (float*)dsm;
    int* sun = (int*)(dsm + (size_t)S * 4);
    int l0, l1;
    own_range(n_loc, l0, l1);
    for (int l = l0; l < l1; ++l) {
      ssc[l] = sc[l];
      sun[l] = un[l];
    }
    sc = ssc;
    un = sun;
  }
  const int ask[3] = {a.asks[g * 3 + 0], a.asks[g * 3 + 1], a.asks[g * 3 + 2]};
  const size_t row = (size_t)g * a.rows;
  const int* prow = nullptr;
  if (a.mode == kWaterPhase2) {
    int klim = a.tier_limit[g];
    klim = min(max(klim < 0 ? klim + a.tp : klim, 0), a.tp - 1);
    prow = a.prefix + (size_t)klim * a.rows * 3;
  }
  int rounds = 0;
  const long long placed = cluster_waterfill(
      ws, rounds, sc, un, n_loc, count, [&](int l, int tk) {
        const int c = lo + l - a.base;  // the card's row, if it owns it
        if (tk == 0 || c < 0 || c >= a.rows) return;
        if (a.mode == kWaterPhase1) {
#pragma unroll
          for (int r = 0; r < 3; ++r)
            a.used_new[c * 3 + r] =
                wrap_add(a.used_new[c * 3 + r], wrap_mul(tk, ask[r]));
          a.take1[c] = tk;
          a.assign[row + c] = tk;
          return;
        }
        // what phase 2 ate into victims rather than leftover free
        // capacity, against the usage standing after phase 1
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const int t = c * 3 + r;
          const int ut =
              wrap_add(wrap_sub(a.used_in[t], a.freed[t]), a.used_new[t]);
          const int p = max(wrap_sub(prow[t], a.freed[t]), 0);
          const int normal_free = max(wrap_sub(a.cap[t], ut), 0);
          const int placed_r = wrap_mul(tk, ask[r]);
          const int overflow = max(wrap_sub(placed_r, normal_free), 0);
          a.freed[t] = wrap_add(a.freed[t], min(overflow, p));
          a.used_new[t] = wrap_add(a.used_new[t], placed_r);
        }
        a.evict[row + c] = tk;
        a.assign[row + c] = wrap_add(a.assign[row + c], tk);
      });
  // phase 1's remainder: count minus the whole mesh's takes (the
  // reference's psum), the same on every card
  if (a.mode == kWaterPhase1 && rank == 0 && threadIdx.x == 0)
    *a.rem = count - (int)placed;
  // no block exits while another may still read the leader's bins
  cluster.sync();
}

__global__ void shard_finish_kernel(int preempt, const int* cap,
                                    const int* used_in, const int* used,
                                    const int* freed, const int* used_new,
                                    int* used_out, uint8_t* over, int rows) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= rows) return;
  if (preempt) {
    for (int r = 0; r < 3; ++r) {
      const int t = n * 3 + r;
      used_out[t] = wrap_add(wrap_sub(used_in[t], freed[t]), used_new[t]);
    }
    return;
  }
  // overflow flags: placed usage beyond the free capacity at entry
  bool o = false;
  for (int r = 0; r < 3; ++r) {
    const int t = n * 3 + r;
    const int placed = wrap_sub(used[t], used_in[t]);
    o |= placed > max(wrap_sub(cap[t], used_in[t]), 0);
  }
  over[n] = o ? 1 : 0;
}

cudaLaunchConfig_t shard_config(int n_shards, int csize, size_t dyn,
                                cudaLaunchAttribute* attr, void* stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_shards * csize, 1, 1);
  cfg.blockDim = dim3(kSelThreads, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

struct ShardLaunch {
  int w;       // rows per shard it was chosen for
  int csize;   // blocks per cluster
  int dyn;     // dynamic shared memory: a block's score/units, or 0
};

// One cluster per shard: the widest of 16, 8, ..., 1 blocks with
// n_shards * size <= the card's SMs that the card can co-schedule, each
// block keeping its rows' score and units in shared memory where they
// fit. Chosen at the first launch for each shard count and width.
cudaError_t shard_launch(int n_shards, int w, ShardLaunch* out) {
  static ShardLaunch chosen[kMaxShards + 1] = {};
  // per device, so set before every launch
  cudaError_t e = cudaFuncSetAttribute(
      shard_score_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  ShardLaunch& c = chosen[n_shards];
  if (c.csize == 0 || c.w != w) {
    int dev = 0, sms = 0, optin = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, shard_score_kernel);
    if (e != cudaSuccess) return e;
    c.csize = 0;
    for (int csize = kMaxCluster; csize >= 1 && c.csize == 0; csize /= 2) {
      if (csize > 1 && n_shards * csize > sms) continue;
      const size_t sub = (size_t)(w + csize - 1) / csize;
      const size_t dyn =
          fa.sharedSizeBytes + sub * 8 <= (size_t)optin ? sub * 8 : 0;
      e = cudaFuncSetAttribute(shard_score_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dyn);
      if (e != cudaSuccess) return e;
      cudaLaunchAttribute attr[1];
      cudaLaunchConfig_t cfg = shard_config(n_shards, csize, dyn, attr,
                                            nullptr);
      int clusters = 0;
      e = cudaOccupancyMaxActiveClusters(
          &clusters, (const void*)shard_score_kernel, &cfg);
      if (e != cudaSuccess) return e;
      if (clusters >= 1) c = ShardLaunch{w, csize, (int)dyn};
    }
    if (c.csize == 0) return cudaErrorLaunchOutOfResources;
  }
  *out = c;
  return cudaFuncSetAttribute(shard_score_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              c.dyn);
}

struct SelectLaunch {
  int np;     // gathered entries it was chosen for
  int csize;  // blocks per cluster
  int slice;  // entries per block
  int dyn;    // dynamic shared memory: a block's score/units, or 0
};

// One cluster over the gathered vectors: the widest of 16, 8, ..., 1
// blocks the card can co-schedule, each block's slice of score and units
// in shared memory where it fits. Chosen at the first launch for each np.
cudaError_t select_launch(int np, SelectLaunch* out) {
  static SelectLaunch chosen = {};
  // per device, so set before every launch
  cudaError_t e = cudaFuncSetAttribute(
      gathered_select_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
  if (e != cudaSuccess) return e;
  if (chosen.csize == 0 || chosen.np != np) {
    int dev = 0, optin = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, gathered_select_kernel);
    if (e != cudaSuccess) return e;
    chosen.csize = 0;
    for (int csize = kMaxCluster; csize >= 1 && chosen.csize == 0;
         csize /= 2) {
      const int slice = (np + csize - 1) / csize;
      const size_t dyn = fa.sharedSizeBytes + (size_t)slice * 8 <=
                                 (size_t)optin
                             ? (size_t)slice * 8
                             : 0;
      e = cudaFuncSetAttribute(gathered_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dyn);
      if (e != cudaSuccess) return e;
      cudaLaunchAttribute attr[1];
      cudaLaunchConfig_t cfg = shard_config(1, csize, dyn, attr, nullptr);
      int clusters = 0;
      e = cudaOccupancyMaxActiveClusters(
          &clusters, (const void*)gathered_select_kernel, &cfg);
      if (e != cudaSuccess) return e;
      if (clusters >= 1) chosen = SelectLaunch{np, csize, slice, (int)dyn};
    }
    if (chosen.csize == 0) return cudaErrorLaunchOutOfResources;
  }
  *out = chosen;
  return cudaFuncSetAttribute(gathered_select_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              chosen.dyn);
}

}  // namespace

extern "C" int nomad_shard_score(
    int mode, int g, int init, const int* cap, const int* used_in, int* used,
    int* used_new, int* freed, int* take1, const int* prefix, int tp,
    const int* tier_limit, const int* rem, const int* asks, const int* counts,
    const uint8_t* feas, const float* bias, const int* ucap, int* assign,
    int* evict, float* score_s, int* units_s, float* g_score, int* g_units,
    int* g_idx, int n_shards, int w, int s0, int k, void* stream) {
  ScoreArgs a{mode,    g,      init,    cap,     used_in, used,    used_new,
              freed,   take1,  prefix,  tp,      tier_limit, rem,  asks,
              counts,  feas,   bias,    ucap,    assign,  evict,   score_s,
              units_s, g_score, g_units, g_idx,  n_shards * w, w,  s0,
              k};
  if (n_shards < 1 || n_shards > kMaxShards)
    return (int)cudaErrorInvalidValue;
  ShardLaunch l;
  cudaError_t e = shard_launch(n_shards, w, &l);
  if (e != cudaSuccess) return (int)e;
  a.smem_rows = l.dyn > 0 ? 1 : 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = shard_config(n_shards, l.csize, l.dyn, attr,
                                        stream);
  e = cudaLaunchKernelEx(&cfg, shard_score_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The cluster size shard_score uses for n_shards shards of w rows on this
// card, negative where a block's rows do not fit in shared memory.
extern "C" int nomad_shard_cluster(int n_shards, int w) {
  ShardLaunch l;
  if (n_shards < 1 || n_shards > kMaxShards) return 0;
  if (shard_launch(n_shards, w, &l) != cudaSuccess) return 0;
  return l.dyn > 0 ? l.csize : -l.csize;
}

extern "C" int nomad_candidate_fill(
    int g, const int* asks, const int* counts, const float* g_score,
    const int* g_units, const int* g_idx, int d, int k, int w, int s0,
    int rows, int* used, int* assign, int* inst, int max_count, int* picks,
    int gp, void* stream) {
  FillArgs a{g,  asks,  counts,    g_score, g_units, g_idx,
             d,  k,     w,         s0,      rows,    used,
             assign, inst, max_count, picks, gp};
  candidate_fill_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int nomad_gathered_waterfill(
    int mode, int g, const int* asks, const int* counts, int* rem,
    const float* g_score, int* g_units, int np, int base, int rows,
    const int* cap, const int* used_in, int* used, int* used_new, int* freed,
    int* take1, const int* prefix, int tp, const int* tier_limit, int* assign,
    int* evict, void* stream) {
  if (mode == kWaterFull) {
    WaterArgs a{g, asks, counts, g_score, g_units, np, base, rows, used,
                assign};
    gathered_waterfill_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (mode != kWaterPhase1 && mode != kWaterPhase2)
    return (int)cudaErrorInvalidValue;
  SelectLaunch l;
  cudaError_t e = select_launch(np, &l);
  if (e != cudaSuccess) return (int)e;
  SelectArgs a{mode,    g,       asks,    counts,     rem,      g_score,
               g_units, np,      l.slice, l.dyn > 0,  base,     rows,
               cap,     used_in, used_new, freed,     take1,    prefix,
               tp,      tier_limit, assign, evict};
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = shard_config(1, l.csize, l.dyn, attr, stream);
  e = cudaLaunchKernelEx(&cfg, gathered_select_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The cluster size of the preemption phases' select over np gathered
// entries on this card, negative where a block's slice does not fit in
// shared memory, 0 if none can be placed. Chooses (and caches) the launch
// shape, so a caller capturing a CUDA graph calls it first.
extern "C" int nomad_water_cluster(int np) {
  SelectLaunch l;
  if (np < 1 || select_launch(np, &l) != cudaSuccess) return 0;
  return l.dyn > 0 ? l.csize : -l.csize;
}

extern "C" int nomad_shard_finish(int preempt, const int* cap,
                                  const int* used_in, const int* used,
                                  const int* freed, const int* used_new,
                                  int* used_out, uint8_t* over, int rows,
                                  const int* picks, int gp, int dk,
                                  int* inst, int max_count, void* stream) {
  const int threads = 256;
  const int blocks = (rows + threads - 1) / threads;
  shard_finish_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      preempt, cap, used_in, used, freed, used_new, used_out, over, rows);
  if (inst != nullptr && gp > 0)
    shard_inst_kernel<<<gp, threads, 0, (cudaStream_t)stream>>>(
        picks, gp, dk, inst, max_count);
  return (int)cudaGetLastError();
}
