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
// K4 is K5's phase 1 and nothing else, so both are one kernel template,
// solve_placement_kernel<kSmem, kPreempt>; K4 is its instance without
// phase 2, `freed`, the phase-1 takes, the tier row and the evictions.
// Each solve is ONE launch of ONE thread-block cluster of up to 16 blocks
// of 512 threads. Block b owns the contiguous node slice [b*S, b*S+S) (S
// a multiple of 128) from the first group to the last and keeps the
// slice's per-node state in its shared memory: used_new ([S, 3]), the
// phase's score and units, and for K5 freed ([S, 3]) and phase 1's takes
// (20 B a node for K4, 36 B for K5: 12 KB and 23 KB a block at Np 10240);
// cap and the input usage stay in L2, and cp.async brings group g+1's
// feas/bias/ucap rows (and K5's tier-prefix row) while group g runs. Each
// phase's waterfill is the unit-weighted radix select (solve_common.cuh
// cluster_waterfill): one round of the cluster's unit total and key range
// (one cluster barrier) settles a phase whose units all fit or whose
// scores all tie; otherwise 8-bit radix passes from the first digit where
// the keys differ (two barriers each) and one index-ordered round for the
// run tied at the boundary. Each block then applies its own nodes' takes
// and writes their entries of the group's rows; a padded group (count 0)
// only writes its zero rows. The pick loop this replaced made one
// dependent block-wide pick (~2,500 cycles) per node that received
// instances, on one SM. The bound is the chain of rounds and the scoring
// between them, group after group, which no count of bytes or
// operations sees. Where the slice's state and rows do not fit
// in shared memory (or Np is not a multiple of 128, or a row is not
// 16-byte aligned) the same kernel keeps them in global memory and reads
// the rows in place.
//
// Numerics: solve_common.cuh (floor-div units, int32 wrap, the f32 score
// term for term; build with --fmad=false). The tier index is read as
// lax.dynamic_index_in_dim reads it: a negative index counts from the end,
// then it is clamped to [0, tp - 1].

#include <cuda_pipeline.h>

#include "solve_common.cuh"

namespace {

using namespace nomad;

struct SolveArgs {
  const int* cap;         // [np, 3]
  const int* used_in;     // [np, 3]: K4's used, K5's used_exist
  const int* prefix;      // K5: [tp, np, 3] cumulative tier usage
  int tp;
  const int* asks;        // [gp, 3]
  const int* counts;      // [gp]
  const uint8_t* feas;    // [gp, np] bool
  const float* bias;      // [gp, np]
  const int* ucap;        // [gp, np]
  const int* tier_limit;  // K5: [gp]
  int np;
  int gp;
  int slice;              // S: nodes per block, a multiple of 128
  int* work;              // global state (kSmem false): [state_words * np]
  int* assign;            // out [gp, np]
  int* evict;             // K5: out [gp, np]
  int* used_out;          // out [np, 3]
};

// int32 words of state a node: score, units, used_new [3]; K5 adds phase
// 1's take and freed [3]. The global workspace holds state_words * np.
__host__ __device__ constexpr int state_words(bool preempt) {
  return preempt ? 9 : 5;
}

// Bytes of one group's rows of a slice of s nodes: bias, ucap, K5's tier
// prefix row, feas.
__host__ __device__ constexpr size_t row_bytes(bool preempt, int s) {
  return (size_t)s * (preempt ? 21 : 9);
}

// Shared bytes of a slice of s nodes: its state and two buffers of rows.
__host__ __device__ constexpr size_t smem_bytes(bool preempt, int s) {
  return (size_t)s * 4 * state_words(preempt) + 2 * row_bytes(preempt, s);
}

// 16-byte asynchronous copies of [src, src + bytes) (bytes a multiple of 16)
__device__ __forceinline__ void copy_rows_async(uint8_t* dst,
                                                const uint8_t* src,
                                                size_t bytes) {
  for (size_t off = (size_t)threadIdx.x * 16; off < bytes;
       off += (size_t)blockDim.x * 16)
    __pipeline_memcpy_async(dst + off, src + off, 16);
}

__device__ __forceinline__ int tier_row(const SolveArgs& a, int g) {
  const int klim = a.tier_limit[g];
  return min(max(klim < 0 ? klim + a.tp : klim, 0), a.tp - 1);
}

template <bool kSmem, bool kPreempt>
__global__ void __launch_bounds__(kSelThreads, 1)
solve_placement_kernel(SolveArgs a) {
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
  // (score, units, used_new, then K5's take1 and freed, each np long)
  float* sc;
  int *un, *used_new, *take1 = nullptr, *freed = nullptr;
  uint8_t* rowbuf = nullptr;
  if (kSmem) {
    sc = (float*)dsm;
    un = (int*)(dsm + (size_t)S * 4);
    used_new = (int*)(dsm + (size_t)S * 8);
    if (kPreempt) {
      take1 = (int*)(dsm + (size_t)S * 20);
      freed = (int*)(dsm + (size_t)S * 24);
    }
    rowbuf = dsm + (size_t)S * 4 * state_words(kPreempt);
  } else {
    sc = (float*)a.work + lo;
    un = a.work + (size_t)a.np + lo;
    used_new = a.work + 2 * (size_t)a.np + (size_t)lo * 3;
    if (kPreempt) {
      take1 = a.work + 5 * (size_t)a.np + lo;
      freed = a.work + 6 * (size_t)a.np + (size_t)lo * 3;
    }
  }
  for (int l = l0; l < l1; ++l) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      used_new[l * 3 + r] = 0;
      if (kPreempt) freed[l * 3 + r] = 0;
    }
  }
  waterfill_init(ws);
  int rounds = 0;

  // the usage standing before this solve's placements, and K5's freed
  // victim capacity taken off it
  auto base_used = [&](int l, int r) {
    const int ue = a.used_in[(size_t)(lo + l) * 3 + r];
    return kPreempt ? wrap_sub(ue, freed[l * 3 + r]) : ue;
  };

  const size_t rb = row_bytes(kPreempt, S);
  auto prefetch = [&](int g, int b) {
    uint8_t* dst = rowbuf + b * rb;
    const size_t row = (size_t)g * a.np + lo;
    copy_rows_async(dst, (const uint8_t*)(a.bias + row), (size_t)n_loc * 4);
    copy_rows_async(dst + (size_t)S * 4, (const uint8_t*)(a.ucap + row),
                    (size_t)n_loc * 4);
    if (kPreempt)
      copy_rows_async(dst + (size_t)S * 8,
                      (const uint8_t*)(a.prefix + ((size_t)tier_row(a, g) *
                                                   a.np + lo) * 3),
                      (size_t)n_loc * 12);
    copy_rows_async(dst + (size_t)S * (kPreempt ? 20 : 8), a.feas + row,
                    (size_t)n_loc);
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
    const int* prow = nullptr;
    const uint8_t* frow;
    if (kSmem) {
      __pipeline_wait_prior(0);
      __syncthreads();  // group g's rows are in; group g-1's buffer is free
      if (g + 1 < a.gp) prefetch(g + 1, (g + 1) & 1);
      const uint8_t* buf = rowbuf + (g & 1) * rb;
      brow = (const float*)buf;
      urow = (const int*)(buf + (size_t)S * 4);
      if (kPreempt) prow = (const int*)(buf + (size_t)S * 8);
      frow = buf + (size_t)S * (kPreempt ? 20 : 8);
    } else {
      const size_t row = (size_t)g * a.np + lo;
      brow = a.bias + row;
      urow = a.ucap + row;
      if (kPreempt)
        prow = a.prefix + ((size_t)tier_row(a, g) * a.np + lo) * 3;
      frow = a.feas + row;
    }
    int* arow = a.assign + (size_t)g * a.np + lo;
    int* erow = kPreempt ? a.evict + (size_t)g * a.np + lo : nullptr;
    if (count <= 0) {  // a padded group places nothing: zero rows, no score
      for (int l = l0; l < l1; ++l) {
        arow[l] = 0;
        if (kPreempt) erow[l] = 0;
      }
      continue;
    }

    // phase 1: _units_for and _score_nodes against the usage at the start
    // of the group
    for (int l = l0; l < l1; ++l) {
      const int* c = a.cap + (size_t)(lo + l) * 3;
      int ut[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        ut[r] = wrap_add(base_used(l, r), used_new[l * 3 + r]);
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
          if (kPreempt) take1[l] = tk;
          else arow[l] = tk;
#pragma unroll
          for (int r = 0; r < 3; ++r)
            used_new[l * 3 + r] =
                wrap_add(used_new[l * 3 + r], wrap_mul(tk, ask[r]));
        });
    const int rem = count - (int)placed1;
    if constexpr (!kPreempt) continue;  // K4: phase 1 is the whole group

    if (rem > 0) {
      // phase 2: the remainder on free capacity plus the preemptible
      // tiers' usage not yet claimed by an earlier group
      for (int l = l0; l < l1; ++l) {
        const int* c = a.cap + (size_t)(lo + l) * 3;
        int free2[3], used2[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const int ut = wrap_add(base_used(l, r), used_new[l * 3 + r]);
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
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const int ut = wrap_add(base_used(l, r), used_new[l * 3 + r]);
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
      a.used_out[n * 3 + r] = wrap_add(base_used(l, r), used_new[l * 3 + r]);
  }
  // no block exits while another may still read the leader's bins
  cluster.sync();
}

template <bool kSmem, bool kPreempt>
cudaError_t launch_cluster(const SolveArgs& a, int csize, size_t dyn,
                           cudaStream_t st, int* placed_ok) {
  auto* fn = solve_placement_kernel<kSmem, kPreempt>;
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

// Launches the solve on the largest cluster that can be co-scheduled,
// with the slices in shared memory where the rows are 16-byte aligned
// (`aligned`, and Np a multiple of 128) and a slice fits. info (host, 4
// ints) receives the cluster size, whether the slices are in shared
// memory, the slice width and the dynamic shared-memory bytes.
template <bool kPreempt>
int launch_solve(SolveArgs a, bool aligned, cudaStream_t st, int* info) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, solve_placement_kernel<true, kPreempt>);
  if (e != cudaSuccess) return (int)e;
  aligned = aligned && a.np % 128 == 0 && ((uintptr_t)a.feas % 16) == 0 &&
            ((uintptr_t)a.bias % 16) == 0 && ((uintptr_t)a.ucap % 16) == 0;
  for (int csize = kMaxCluster; csize >= 2; csize /= 2) {
    const int per = (a.np + csize - 1) / csize;
    a.slice = (per + 127) / 128 * 128;
    const size_t dyn = smem_bytes(kPreempt, a.slice);
    const bool fits = aligned && fa.sharedSizeBytes + dyn <= (size_t)optin;
    int ok = 0;
    e = fits ? launch_cluster<true, kPreempt>(a, csize, dyn, st, &ok)
             : launch_cluster<false, kPreempt>(a, csize, 0, st, &ok);
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

}  // namespace

// K4. The workspace is one int32 buffer of 5 * np (the slices' state where
// it does not fit in shared memory); info as launch_solve's.
extern "C" int nomad_solve_dense(const int* cap, const int* used,
                                 const int* asks, const int* counts,
                                 const uint8_t* feas, const float* bias,
                                 const int* ucap, int np, int gp,
                                 int* workspace, int* assign, int* used_out,
                                 int* info, void* stream) {
  SolveArgs a{cap,  used, nullptr, 0,         asks,    counts,
              feas, bias, ucap,    nullptr,   np,      gp,
              0,    workspace, assign, nullptr, used_out};
  return launch_solve<false>(a, true, (cudaStream_t)stream, info);
}

// K5. The workspace is one int32 buffer of 9 * np; info as launch_solve's.
extern "C" int nomad_solve_preempt(const int* cap, const int* used_exist,
                                   const int* prefix, int tp, const int* asks,
                                   const int* counts, const uint8_t* feas,
                                   const float* bias, const int* ucap,
                                   const int* tier_limit, int np, int gp,
                                   int* workspace, int* assign, int* evict,
                                   int* used_out, int* info, void* stream) {
  SolveArgs a{cap,  used_exist, prefix, tp,        asks,   counts,
              feas, bias,       ucap,   tier_limit, np,    gp,
              0,    workspace,  assign, evict,      used_out};
  return launch_solve<true>(a, ((uintptr_t)prefix % 16) == 0,
                            (cudaStream_t)stream, info);
}
