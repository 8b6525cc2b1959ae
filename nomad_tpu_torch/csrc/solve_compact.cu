// Compact placement solve: the batch solver's main kernel.
//
// Replaces nomad_tpu/scheduler/tpu/kernels.py solve_placement_compact
// (:212) with its scan step _place_group (:176), _units_for (:128),
// _score_nodes (:114) and _waterfill_topk (:152). Same inputs, same
// outputs, bit for bit: the bit-packed feasibility rows are read in place
// (MSB-first, as np.packbits writes them), groups are placed in order, and
// each group's instances come out in node-index order with -1 past the
// group's placed total.
//
// What bounds it on the card: neither bytes (a c2m solve moves ~3 MB) nor
// operations (19 f32 operations per node and group), but the dependency
// from group to group (group g+1 scores against the usage group g left)
// and the barriers inside a group. Design: the whole scan is ONE launch of
// ONE thread-block cluster of up to 16 blocks (cudaLaunchKernelEx with a
// cluster dimension). Block b owns the contiguous node slice [b*S, b*S+S)
// (S a multiple of 128) and keeps the slice's used (3 x i32), score and
// units in its shared memory from the first group to the last; cap stays
// in L2. Per group:
//   1. each block scores its slice (solve_common.cuh score_fit) against
//      its own used, reading the group's feas/bias/ucap rows from shared
//      memory, where cp.async brought them while the previous group ran;
//   2. one cluster-wide selection (solve_common.cuh cluster_select): the
//      waterfill's picks are the unit-bearing nodes in (score desc, index
//      asc) order until their units cover the count or k are taken, so
//      each warp and then each block lists its best 32, the leader block
//      merges the blocks' lists through distributed shared memory, and a
//      further round runs only if a list cut at 32 stopped the merge;
//   3. each block adds the takes of its own picks to its used; the
//      leader keeps the group's pick list in global memory.
// After the scan the blocks write every inst[g, :maxC] from the pick
// lists, in parallel over groups: a pick's first slot is the sum of the
// takes of the group's picks with lower node indices.
// Blocks and leader only store into each other's shared memory (a list
// in, the round's outcome out), never load from it: two cluster barriers
// per selection round. The bound is the chain of a group's barriers and
// its selection's sorts and merges, which no count of bytes or
// operations sees. Where a slice does not fit in
// shared memory (or Np is not a multiple of 128), the same kernel, with
// kSmem false, keeps used/score/units in global memory and reads the rows
// in place.
//
// Numerics: solve_common.cuh (floor-div units, int32 wrap, XLA's score
// rounding; build with --fmad=false and never --use_fast_math). Ties go to
// the lower node index, across block slices too: the order lax.top_k
// gives.

#include <cuda_pipeline.h>

#include "solve_common.cuh"

namespace {

using namespace nomad;
namespace cg = cooperative_groups;

struct Args {
  const int* cap;          // [np, 3]
  const int* used_in;      // [np, 3]
  const int* asks;         // [gp, 3]
  const int* counts;       // [gp]
  const uint8_t* feas;     // [uf, np / 8] MSB-first
  const int* feas_idx;     // [gp]
  const float* bias;       // [ub, np]
  const int* bias_idx;     // [gp]
  const uint8_t* ucap;     // [uu, np] int16 or int32
  const int* ucap_idx;     // [gp]
  int ucap_bytes;          // 2 or 4
  int np;
  int gp;
  int max_count;
  int k;
  int slice;               // S: nodes per block, a multiple of 128
  float* score;            // scratch [np] (kSmem false)
  int* units;              // scratch [np] (kSmem false)
  int* pick_i;             // scratch [gp, k]: each group's picks in merge
  int* pick_t;             //   order, and their takes
  int* placed;             // scratch [gp]: picks per group
  int* total;              // scratch [gp]: instances per group
  int* inst;               // out [gp, max_count]
  uint8_t* over;           // out [np]
  int* used;               // out [np, 3] (used'; kSmem false: working)
};

// Bytes of one group's rows for a slice of s nodes in shared memory.
__host__ __device__ inline size_t row_bytes(int s, int ucap_bytes) {
  return (size_t)s * 4 + (size_t)s * ucap_bytes + (size_t)s / 8;
}

__host__ __device__ inline size_t smem_bytes(int s, int ucap_bytes) {
  return (size_t)s * 20 + 2 * row_bytes(s, ucap_bytes);
}

// 16-byte asynchronous copies of [src, src + bytes) (bytes a multiple of 16)
__device__ __forceinline__ void copy_async(uint8_t* dst, const uint8_t* src,
                                           size_t bytes) {
  for (size_t off = (size_t)threadIdx.x * 16; off < bytes;
       off += (size_t)kSelThreads * 16)
    __pipeline_memcpy_async(dst + off, src + off, 16);
}

template <bool kSmem>
__global__ void __launch_bounds__(kSelThreads, 1)
solve_compact_kernel(Args a) {
  __shared__ SelectShared sh;
  extern __shared__ __align__(16) uint8_t dsm[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int S = a.slice;
  const int lo = rank * S;
  const int n_loc = max(0, min(S, a.np - lo));
  const int ub = a.ucap_bytes;
  const size_t rb = row_bytes(S, ub);

  int* used_s;
  float* sc;
  int* un;
  uint8_t* rowbuf = nullptr;
  if (kSmem) {
    used_s = (int*)dsm;
    sc = (float*)(dsm + (size_t)S * 12);
    un = (int*)(dsm + (size_t)S * 16);
    rowbuf = dsm + (size_t)S * 20;
  } else {
    used_s = a.used + (size_t)lo * 3;
    sc = a.score + lo;
    un = a.units + lo;
  }
  for (int t = tid; t < n_loc * 3; t += kSelThreads)
    used_s[t] = a.used_in[(size_t)lo * 3 + t];

  // the group's rows of this slice: shared-memory copies or global rows
  auto bias_src = [&](int g) {
    return (const uint8_t*)(a.bias + (size_t)a.bias_idx[g] * a.np + lo);
  };
  auto ucap_src = [&](int g) {
    return a.ucap + ((size_t)a.ucap_idx[g] * a.np + lo) * ub;
  };
  auto feas_src = [&](int g) {
    return a.feas + (size_t)a.feas_idx[g] * (a.np >> 3) + (lo >> 3);
  };
  auto prefetch = [&](int g, int b) {
    uint8_t* dst = rowbuf + b * rb;
    copy_async(dst, bias_src(g), (size_t)n_loc * 4);
    copy_async(dst + (size_t)S * 4, ucap_src(g), (size_t)n_loc * ub);
    copy_async(dst + (size_t)S * (4 + ub), feas_src(g), (size_t)n_loc / 8);
    __pipeline_commit();
  };
  if (kSmem) prefetch(0, 0);
  __syncthreads();

  for (int g = 0; g < a.gp; ++g) {
    const int count = a.counts[g];
    const int ask0 = a.asks[g * 3 + 0];
    const int ask1 = a.asks[g * 3 + 1];
    const int ask2 = a.asks[g * 3 + 2];
    const float* brow;
    const uint8_t* urow;
    const uint8_t* frow;
    if (kSmem) {
      __pipeline_wait_prior(0);
      __syncthreads();  // group g's rows are in; group g-1's buffer is free
      if (g + 1 < a.gp) prefetch(g + 1, (g + 1) & 1);
      const uint8_t* buf = rowbuf + (g & 1) * rb;
      brow = (const float*)buf;
      urow = buf + (size_t)S * 4;
      frow = buf + (size_t)S * (4 + ub);
    } else {
      brow = (const float*)bias_src(g);
      urow = ucap_src(g);
      frow = feas_src(g);
    }
    int placed = 0;            // picks of this group
    long long covered = 0;     // their units
    if (count > 0) {
      // 1. units and score of this block's nodes (_units_for,
      //    _score_nodes) against the usage at the start of the group
      const int ask[3] = {ask0, ask1, ask2};
      const float af0 = (float)ask0;
      const float af1 = (float)ask1;
      for (int l = tid; l < n_loc; l += kSelThreads) {
        const int* c = a.cap + (size_t)(lo + l) * 3;
        const int* u = used_s + l * 3;
        const int free[3] = {wrap_sub(c[0], u[0]), wrap_sub(c[1], u[1]),
                             wrap_sub(c[2], u[2])};
        const bool feasible = (frow[l >> 3] >> (7 - (l & 7))) & 1;
        const int ucap = ub == 2 ? (int)((const int16_t*)urow)[l]
                                 : ((const int*)urow)[l];
        const int units = units_for(free, ask, ucap, feasible, count);
        // a node without units is never picked (the JAX kernel scores it
        // NEG_INF, below every node that has units)
        float s = -INFINITY;
        if (units > 0)
          s = score_fit(c[0], c[1], (float)u[0], (float)u[1], af0, af1,
                        brow[l]);
        sc[l] = s;
        un[l] = units;
      }
      __syncthreads();
      // 2-3. the waterfill's picks, cluster-wide: the leader lists them
      //      in merge order, each owner adds its takes to its used
      placed = cluster_select(
          sh, sc, un, n_loc, lo, count, a.k,
          [&](int j, const Cand& c, long long prior) {
            const size_t at = (size_t)g * a.k + j;
            a.pick_i[at] = c.i;
            a.pick_t[at] = (int)min((long long)c.u, (long long)count - prior);
          },
          [&](const Cand& c, int tk) {
            int* u = used_s + (c.i - lo) * 3;
            u[0] = wrap_add(u[0], wrap_mul(tk, ask0));
            u[1] = wrap_add(u[1], wrap_mul(tk, ask1));
            u[2] = wrap_add(u[2], wrap_mul(tk, ask2));
          },
          &covered);
    }
    if (rank == 0 && tid == 0) {
      a.placed[g] = placed;
      a.total[g] = (int)min(covered, (long long)count);
    }
  }

  // 4. instances in node-index order, off the scan's critical path: block
  //    b writes the rows of groups g = b mod the cluster. A pick's first
  //    slot is the sum of the takes of the group's picks with lower node
  //    indices; slots past the group's placed total are -1.
  cluster.sync();  // the leader's pick lists are visible to every block
  const int nblk = (int)cluster.num_blocks();
  for (int g = rank; g < a.gp; g += nblk)
    emit_instances(a.pick_i + (size_t)g * a.k, a.pick_t + (size_t)g * a.k,
                   __ldcg(a.placed + g), __ldcg(a.total + g),
                   a.inst + (size_t)g * a.max_count, a.max_count,
                   (int*)sh.tmp);  // the selection's scratch, free now

  // used' and the overflow flags of this block's slice (no other block
  // touches its shared memory after the last selection)
  for (int l = tid; l < n_loc; l += kSelThreads) {
    const int n = lo + l;
    bool o = false;
    for (int r = 0; r < 3; ++r) {
      const int in = a.used_in[n * 3 + r];
      const int now = used_s[l * 3 + r];
      if (kSmem) a.used[n * 3 + r] = now;
      // overflow flags: placed usage beyond the free capacity at entry
      o |= wrap_sub(now, in) > max(wrap_sub(a.cap[n * 3 + r], in), 0);
    }
    a.over[n] = o ? 1 : 0;
  }
}

template <bool kSmem>
cudaError_t launch(const Args& a, int csize, size_t dyn, cudaStream_t st,
                   int* placed_ok) {
  auto* fn = solve_compact_kernel<kSmem>;
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

// info (host, 4 ints) receives the cluster size, whether the slices are in
// shared memory, the slice width and the dynamic shared-memory bytes.
extern "C" int nomad_solve_compact(
    const int* cap, const int* used_in, const int* asks, const int* counts,
    const uint8_t* feas_packed, const int* feas_idx, const float* bias_rows,
    const int* bias_idx, const void* ucap_rows, int ucap_i16,
    const int* ucap_idx, int np, int gp, int max_count, int k,
    float* score_scratch, int* units_scratch, int* pick_scratch, int* inst,
    uint8_t* over, int* used_out, int* info, void* stream) {
  const int ub = ucap_i16 ? 2 : 4;
  const size_t gk = (size_t)gp * k;
  Args a{cap,      used_in,  asks,     counts,    feas_packed,
         feas_idx, bias_rows, bias_idx, (const uint8_t*)ucap_rows,
         ucap_idx, ub,        np,       gp,        max_count,
         k,        0,         score_scratch, units_scratch,
         pick_scratch,        pick_scratch + gk, pick_scratch + 2 * gk,
         pick_scratch + 2 * gk + gp, inst, over, used_out};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, solve_compact_kernel<true>);
  if (e != cudaSuccess) return (int)e;
  // 16-byte copies of the rows need 16-byte aligned row starts
  const bool aligned = np % 128 == 0 && ((uintptr_t)feas_packed % 16) == 0 &&
                       ((uintptr_t)bias_rows % 16) == 0 &&
                       ((uintptr_t)ucap_rows % 16) == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  for (int csize = kMaxCluster; csize >= 2; csize /= 2) {
    const int per = (np + csize - 1) / csize;
    a.slice = (per + 127) / 128 * 128;
    const size_t dyn = smem_bytes(a.slice, ub);
    const bool fits = aligned && fa.sharedSizeBytes + dyn <= (size_t)optin;
    int ok = 0;
    e = fits ? launch<true>(a, csize, dyn, st, &ok)
             : launch<false>(a, csize, 0, st, &ok);
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
