// Dense and preemption placement solves.
//
// Replaces two kernels of nomad_tpu/scheduler/tpu/kernels.py:
//   * solve_placement (:191), scan step _place_group (:176) with the
//     full stable-argsort waterfill _waterfill (:143): every group in
//     order, units, score, fill the best nodes until `count` is placed,
//     used += take * ask; the [G, N] assignment comes back dense (K4);
//   * solve_placement_preempt (:359), scan step _place_group_preempt
//     (:295): the same phase 1 against real free capacity, then the
//     group's remainder retried on capacity expanded by the preemptible
//     tiers' usage (prefix_used[klim] - freed), with `freed` carried
//     across groups so no two groups spend the same victim capacity (K5).
// Same inputs, same outputs, bit for bit.
//
// What bounds them on the card: not bytes (the dense [G, N] rows are
// ~17 B per (group, node), ~14 MB at Gp 80 x Np 10240) but the
// sequential dependency between groups and, inside a group, the
// waterfill.
//
// K4 is ONE launch of ONE block of 1024 threads. Each thread owns the
// nodes n = tid (mod 1024) for the whole scan and caches its best (score
// desc, index asc) over its nodes that still have units; a pick is one
// shuffle reduction over the 1024 cached bests, and only the picked
// node's owner rescans its nodes. Picking the best unit-bearing node
// until `count` is placed is the full sort's waterfill, so a group costs
// as many picks as nodes it fills.
//
// K5 is ONE launch of ONE thread-block cluster of up to 16 blocks of 512
// threads. Block b owns the contiguous node slice [b*S, b*S+S) (S a
// multiple of 128) from the first group to the last and keeps the
// slice's per-node state in its shared memory: used_new and freed ([S,
// 3] each), phase 1's takes, and the phase's score and units (36 B a
// node, 23 KB a block at Np 10240); cap and used_exist stay in L2, and
// cp.async brings group g+1's feas/bias/ucap rows and its tier-prefix
// row while group g runs. Each phase's waterfill is the unit-weighted
// radix select (solve_common.cuh cluster_waterfill): one round of the
// cluster's unit total and key range (one cluster barrier) settles a
// phase whose units all fit or whose scores all tie; otherwise 8-bit radix
// passes from the first digit where the keys differ (two barriers each)
// and one index-ordered round for the run tied at the boundary. Each
// block then applies its own nodes' takes. The pick loop it replaces made
// one dependent block-wide pick (~2,500 cycles) per node that received
// instances: 1,750 on the preempt wave, where the select needs 120
// rounds. The bound is that chain of rounds and the scoring between
// them, group after group, which no count of bytes or operations sees.
// Where the slice's state and rows do not fit in shared memory (or Np is
// not a multiple of 128) the same kernel keeps them in global memory and
// reads the rows in place.
//
// Numerics: solve_common.cuh (floor-div units, int32 wrap, the f32 score
// term for term; build with --fmad=false). The tier index is read as
// lax.dynamic_index_in_dim reads it: a negative index counts from the end,
// then it is clamped to [0, tp - 1].

#include <cuda_pipeline.h>

#include "solve_common.cuh"

namespace {

using namespace nomad;

struct Args {
  const int* cap;         // [np, 3]
  const int* used_in;     // [np, 3]
  const int* asks;        // [gp, 3]
  const int* counts;      // [gp]
  const uint8_t* feas;    // [gp, np] bool
  const float* bias;      // [gp, np]
  const int* ucap;        // [gp, np]
  int np;
  int gp;
  float* score;           // scratch [np]
  int* units;             // scratch [np]
  int* used_new;          // scratch [np, 3]: this solve's placements
  int* assign;            // out [gp, np]
  int* used_out;          // out [np, 3]
};

struct Shared {
  float sh_s[kWarps];
  int sh_i[kWarps];
  float best_s;
  int best_i;
  int remaining;
};

// The waterfill over units/score already written for this thread's nodes:
// the best node that still has units takes min(units, left) until `count`
// is placed or no node has units. Writes take[n] for each picked node
// (the caller zeroed the row) and adds take * ask to used_new.
__device__ void waterfill(const Args& a, Shared& sh, float my_s, int my_i,
                          int count, int* take, const int ask[3]) {
  const int tid = threadIdx.x;
  if (tid == 0) sh.remaining = count;
  __syncthreads();
  int rem = count;
  while (rem > 0) {
    block_argmax(my_s, my_i, sh.sh_s, sh.sh_i, &sh.best_s, &sh.best_i);
    const int bi = sh.best_i;
    if (bi == kNoNode) break;
    if ((bi % kThreads) == tid) {
      const int tk = min(a.units[bi], sh.remaining);
      take[bi] = tk;
#pragma unroll
      for (int r = 0; r < 3; ++r)
        a.used_new[bi * 3 + r] =
            wrap_add(a.used_new[bi * 3 + r], wrap_mul(tk, ask[r]));
      a.units[bi] = 0;
      sh.remaining -= tk;
      my_s = -INFINITY;
      my_i = kNoNode;
      for (int n = tid; n < a.np; n += kThreads) {
        if (a.units[n] > 0 && better(a.score[n], n, my_s, my_i)) {
          my_s = a.score[n];
          my_i = n;
        }
      }
    }
    __syncthreads();
    rem = sh.remaining;
  }
  // every thread has read `remaining` before the next group resets it
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) solve_dense_kernel(Args a) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int np = a.np;

  for (int t = tid; t < np * 3; t += kThreads) a.used_new[t] = 0;
  __syncthreads();

  for (int g = 0; g < a.gp; ++g) {
    const int count = a.counts[g];
    const int ask[3] = {a.asks[g * 3 + 0], a.asks[g * 3 + 1],
                        a.asks[g * 3 + 2]};
    const size_t row = (size_t)g * np;
    const uint8_t* frow = a.feas + row;
    const float* brow = a.bias + row;
    const int* urow = a.ucap + row;
    int* arow = a.assign + row;
    // _units_for and _score_nodes against the usage at the start of the
    // group
    float my_s = -INFINITY;
    int my_i = kNoNode;
    for (int n = tid; n < np; n += kThreads) {
      const int* c = a.cap + n * 3;
      int ut[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        ut[r] = wrap_add(a.used_in[n * 3 + r], a.used_new[n * 3 + r]);
      const int free[3] = {wrap_sub(c[0], ut[0]), wrap_sub(c[1], ut[1]),
                           wrap_sub(c[2], ut[2])};
      const int units = units_for(free, ask, urow[n], frow[n] != 0, count);
      a.units[n] = units;
      arow[n] = 0;
      if (units > 0) {
        const float s = score_fit(c[0], c[1], (float)ut[0], (float)ut[1],
                                  (float)ask[0], (float)ask[1], brow[n]);
        a.score[n] = s;
        if (better(s, n, my_s, my_i)) {
          my_s = s;
          my_i = n;
        }
      }
    }
    waterfill(a, sh, my_s, my_i, count, arow, ask);
  }
  __syncthreads();
  for (int t = tid; t < np * 3; t += kThreads)
    a.used_out[t] = wrap_add(a.used_in[t], a.used_new[t]);
}

// ---------------------------------------------------------------------------
// K5: the preemption solve as one thread-block cluster
// ---------------------------------------------------------------------------

struct PreemptArgs {
  const int* cap;         // [np, 3]
  const int* used_exist;  // [np, 3]
  const int* prefix;      // [tp, np, 3] cumulative tier usage
  int tp;
  const int* asks;        // [gp, 3]
  const int* counts;      // [gp]
  const uint8_t* feas;    // [gp, np] bool
  const float* bias;      // [gp, np]
  const int* ucap;        // [gp, np]
  const int* tier_limit;  // [gp]
  int np;
  int gp;
  int slice;              // S: nodes per block, a multiple of 128
  int* work;              // global state (kSmem false): [9 * np]
  int* assign;            // out [gp, np]
  int* evict;             // out [gp, np]
  int* used_out;          // out [np, 3]
};

// Bytes of one group's rows of a slice of s nodes: bias, ucap, the tier
// prefix row, feas.
__host__ __device__ inline size_t preempt_row_bytes(int s) {
  return (size_t)s * 21;
}

// Shared bytes of a slice of s nodes: its state (score, units, take1,
// used_new, freed: 36 B a node) and two buffers of rows.
__host__ __device__ inline size_t preempt_smem_bytes(int s) {
  return (size_t)s * 36 + 2 * preempt_row_bytes(s);
}

// 16-byte asynchronous copies of [src, src + bytes) (bytes a multiple of 16)
__device__ __forceinline__ void copy_rows_async(uint8_t* dst,
                                                const uint8_t* src,
                                                size_t bytes) {
  for (size_t off = (size_t)threadIdx.x * 16; off < bytes;
       off += (size_t)blockDim.x * 16)
    __pipeline_memcpy_async(dst + off, src + off, 16);
}

__device__ __forceinline__ int tier_row(const PreemptArgs& a, int g) {
  const int klim = a.tier_limit[g];
  return min(max(klim < 0 ? klim + a.tp : klim, 0), a.tp - 1);
}

template <bool kSmem>
__global__ void __launch_bounds__(kSelThreads, 1)
solve_preempt_kernel(PreemptArgs a) {
  __shared__ WaterShared ws;
  extern __shared__ __align__(16) uint8_t dsm[];

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int S = a.slice;
  const int lo = rank * S;
  const int n_loc = max(0, min(S, a.np - lo));
  int l0, l1;
  own_range(n_loc, l0, l1);

  // the slice's state: shared memory, or its rows of the global workspace
  float* sc;
  int *un, *take1, *used_new, *freed;
  uint8_t* rowbuf = nullptr;
  if (kSmem) {
    sc = (float*)dsm;
    un = (int*)(dsm + (size_t)S * 4);
    take1 = (int*)(dsm + (size_t)S * 8);
    used_new = (int*)(dsm + (size_t)S * 12);
    freed = (int*)(dsm + (size_t)S * 24);
    rowbuf = dsm + (size_t)S * 36;
  } else {
    sc = (float*)a.work + lo;
    un = a.work + (size_t)a.np + lo;
    take1 = a.work + 2 * (size_t)a.np + lo;
    used_new = a.work + 3 * (size_t)a.np + (size_t)lo * 3;
    freed = a.work + 6 * (size_t)a.np + (size_t)lo * 3;
  }
  for (int l = l0; l < l1; ++l) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      used_new[l * 3 + r] = 0;
      freed[l * 3 + r] = 0;
    }
  }
  waterfill_init(ws);
  int rounds = 0;

  const size_t rb = preempt_row_bytes(S);
  auto prefetch = [&](int g, int b) {
    uint8_t* dst = rowbuf + b * rb;
    const size_t row = (size_t)g * a.np + lo;
    copy_rows_async(dst, (const uint8_t*)(a.bias + row), (size_t)n_loc * 4);
    copy_rows_async(dst + (size_t)S * 4, (const uint8_t*)(a.ucap + row),
                    (size_t)n_loc * 4);
    copy_rows_async(dst + (size_t)S * 8,
                    (const uint8_t*)(a.prefix + ((size_t)tier_row(a, g) *
                                                 a.np + lo) * 3),
                    (size_t)n_loc * 12);
    copy_rows_async(dst + (size_t)S * 20, a.feas + row, (size_t)n_loc);
    __pipeline_commit();
  };
  if (kSmem) prefetch(0, 0);

  for (int g = 0; g < a.gp; ++g) {
    const int count = a.counts[g];
    const int ask[3] = {a.asks[g * 3 + 0], a.asks[g * 3 + 1],
                        a.asks[g * 3 + 2]};
    const float af0 = (float)ask[0];
    const float af1 = (float)ask[1];
    const float* brow;
    const int* urow;
    const int* prow;
    const uint8_t* frow;
    if (kSmem) {
      __pipeline_wait_prior(0);
      __syncthreads();  // group g's rows are in; group g-1's buffer is free
      if (g + 1 < a.gp) prefetch(g + 1, (g + 1) & 1);
      const uint8_t* buf = rowbuf + (g & 1) * rb;
      brow = (const float*)buf;
      urow = (const int*)(buf + (size_t)S * 4);
      prow = (const int*)(buf + (size_t)S * 8);
      frow = buf + (size_t)S * 20;
    } else {
      const size_t row = (size_t)g * a.np + lo;
      brow = a.bias + row;
      urow = a.ucap + row;
      prow = a.prefix + ((size_t)tier_row(a, g) * a.np + lo) * 3;
      frow = a.feas + row;
    }
    int* arow = a.assign + (size_t)g * a.np + lo;
    int* erow = a.evict + (size_t)g * a.np + lo;

    // phase 1: _units_for and _score_nodes against the usage at the start
    // of the group
    for (int l = l0; l < l1; ++l) {
      const int* c = a.cap + (size_t)(lo + l) * 3;
      const int* ue = a.used_exist + (size_t)(lo + l) * 3;
      int ut[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        ut[r] = wrap_add(wrap_sub(ue[r], freed[l * 3 + r]),
                         used_new[l * 3 + r]);
      const int free[3] = {wrap_sub(c[0], ut[0]), wrap_sub(c[1], ut[1]),
                           wrap_sub(c[2], ut[2])};
      const int units = units_for(free, ask, urow[l], frow[l] != 0, count);
      un[l] = units;
      sc[l] = units > 0 ? score_fit(c[0], c[1], (float)ut[0], (float)ut[1],
                                    af0, af1, brow[l])
                        : -INFINITY;
    }
    const long long placed1 = cluster_waterfill(
        ws, rounds, sc, un, n_loc, count, [&](int l, int tk) {
          take1[l] = tk;
#pragma unroll
          for (int r = 0; r < 3; ++r)
            used_new[l * 3 + r] =
                wrap_add(used_new[l * 3 + r], wrap_mul(tk, ask[r]));
        });
    const int rem = count - (int)placed1;

    if (rem > 0) {
      // phase 2: the remainder on free capacity plus the preemptible
      // tiers' usage not yet claimed by an earlier group
      for (int l = l0; l < l1; ++l) {
        const int* c = a.cap + (size_t)(lo + l) * 3;
        const int* ue = a.used_exist + (size_t)(lo + l) * 3;
        int free2[3], used2[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const int ut = wrap_add(wrap_sub(ue[r], freed[l * 3 + r]),
                                  used_new[l * 3 + r]);
          const int pre = max(wrap_sub(prow[l * 3 + r], freed[l * 3 + r]), 0);
          free2[r] = wrap_add(wrap_sub(c[r], ut), pre);
          used2[r] = max(wrap_sub(ut, pre), 0);
        }
        const int units = units_for(free2, ask, wrap_sub(urow[l], take1[l]),
                                    frow[l] != 0, rem);
        un[l] = units;
        sc[l] = units > 0 ? score_fit(c[0], c[1], (float)used2[0],
                                      (float)used2[1], af0, af1, brow[l])
                          : -INFINITY;
      }
      cluster_waterfill(ws, rounds, sc, un, n_loc, rem, [&](int l, int t2) {
        if (t2 != 0) {
          // what phase 2 ate into victims rather than leftover free
          // capacity, against the usage standing after phase 1
          const int* c = a.cap + (size_t)(lo + l) * 3;
          const int* ue = a.used_exist + (size_t)(lo + l) * 3;
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const int ut = wrap_add(wrap_sub(ue[r], freed[l * 3 + r]),
                                    used_new[l * 3 + r]);
            const int pre =
                max(wrap_sub(prow[l * 3 + r], freed[l * 3 + r]), 0);
            const int normal_free = max(wrap_sub(c[r], ut), 0);
            const int placed = wrap_mul(t2, ask[r]);
            const int overflow = max(wrap_sub(placed, normal_free), 0);
            freed[l * 3 + r] = wrap_add(freed[l * 3 + r], min(overflow, pre));
            used_new[l * 3 + r] = wrap_add(used_new[l * 3 + r], placed);
          }
        }
        erow[l] = t2;
        arow[l] = wrap_add(take1[l], t2);
      });
    } else {
      for (int l = l0; l < l1; ++l) {
        erow[l] = 0;
        arow[l] = take1[l];
      }
    }
  }
  for (int l = l0; l < l1; ++l) {
    const size_t n = (size_t)(lo + l);
#pragma unroll
    for (int r = 0; r < 3; ++r)
      a.used_out[n * 3 + r] =
          wrap_add(wrap_sub(a.used_exist[n * 3 + r], freed[l * 3 + r]),
                   used_new[l * 3 + r]);
  }
  // no block exits while another may still read the leader's bins
  cluster.sync();
}

template <bool kSmem>
cudaError_t launch_preempt(const PreemptArgs& a, int csize, size_t dyn,
                           cudaStream_t st, int* placed_ok) {
  auto* fn = solve_preempt_kernel<kSmem>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dyn);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, 1, 1);
  cfg.blockDim = dim3(kSelThreads, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)fn, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) {
    *placed_ok = 0;  // this cluster size cannot be co-scheduled
    return cudaSuccess;
  }
  *placed_ok = 1;
  e = cudaLaunchKernelEx(&cfg, fn, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// The workspace is one int32 buffer of 5 * np: score, units, used_new
// [np, 3].
extern "C" int nomad_solve_dense(const int* cap, const int* used,
                                 const int* asks, const int* counts,
                                 const uint8_t* feas, const float* bias,
                                 const int* ucap, int np, int gp,
                                 int* workspace, int* assign, int* used_out,
                                 void* stream) {
  Args a{cap,  used, asks, counts, feas, bias, ucap, np, gp,
         reinterpret_cast<float*>(workspace), workspace + np,
         workspace + 2 * (size_t)np, assign, used_out};
  solve_dense_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The workspace is one int32 buffer of 9 * np (the slices' state where
// it does not fit in shared memory). info (host, 4 ints) receives the
// cluster size, whether the slices are in shared memory, the slice width
// and the dynamic shared-memory bytes.
extern "C" int nomad_solve_preempt(const int* cap, const int* used_exist,
                                   const int* prefix, int tp, const int* asks,
                                   const int* counts, const uint8_t* feas,
                                   const float* bias, const int* ucap,
                                   const int* tier_limit, int np, int gp,
                                   int* workspace, int* assign, int* evict,
                                   int* used_out, int* info, void* stream) {
  PreemptArgs a{cap,  used_exist, prefix, tp,        asks,  counts,
                feas, bias,       ucap,   tier_limit, np,   gp,
                0,    workspace,  assign, evict,      used_out};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, solve_preempt_kernel<true>);
  if (e != cudaSuccess) return (int)e;
  // 16-byte copies of the rows need 16-byte aligned row starts
  const bool aligned = np % 128 == 0 && ((uintptr_t)feas % 16) == 0 &&
                       ((uintptr_t)bias % 16) == 0 &&
                       ((uintptr_t)ucap % 16) == 0 &&
                       ((uintptr_t)prefix % 16) == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  for (int csize = kMaxCluster; csize >= 2; csize /= 2) {
    const int per = (np + csize - 1) / csize;
    a.slice = (per + 127) / 128 * 128;
    const size_t dyn = preempt_smem_bytes(a.slice);
    const bool fits = aligned && fa.sharedSizeBytes + dyn <= (size_t)optin;
    int ok = 0;
    e = fits ? launch_preempt<true>(a, csize, dyn, st, &ok)
             : launch_preempt<false>(a, csize, 0, st, &ok);
    if (e != cudaSuccess) return (int)e;
    if (ok) {
      info[0] = csize;
      info[1] = fits ? 1 : 0;
      info[2] = a.slice;
      info[3] = fits ? (int)dyn : 0;
      return 0;
    }
  }
  return (int)cudaErrorLaunchOutOfResources;  // no cluster can be placed
}
