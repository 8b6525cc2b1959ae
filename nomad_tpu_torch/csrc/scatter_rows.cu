// Row scatters onto the [np, 3] int32 usage tensor.
//
// Replaces the two row-scatter jits of nomad_tpu/scheduler/tpu/solver.py:
//   * _scatter_rows (:427)      used.at[idx].set(rows, mode="drop"),
//     donated (in place: the resident tensor's delta sync, :386) or not
//     (a fresh copy: the per-batch adjusted view, :1038);
//   * _scatter_add_rows (:459)  max(used.at[idx].add(rows, mode="drop"), 0)
//     onto a fresh copy of a chained used' tensor (:1023, :1048).
// Indices are padded to a power of two >= 1024 with 1 << 30; mode="drop"
// drops every index outside the array, so the kernels skip them (a
// negative index counts from the end, as jnp indexing normalizes it).
//
// What bounds them on the card: bytes, and below a few hundred KB the
// launch itself. A delta is a few KB; the non-donated set and the add
// also write the whole [np, 3] tensor (120 KB at the c2m bucket), and
// the add clamps all of it. The set is one thread per element a pass
// (a copy pass when not donated, then the scatter). The add is ONE
// launch: block b owns the rows [b*R, b*R+R) of dst, reads every (idx,
// rows) pair (16 B a pair, from L2), adds the pairs that fall in its
// rows into a shared-memory delta tile (shared atomics: a repeated index
// sums, and int32 adds wrap the same in any order), then writes
// dst = max(src + delta, 0) over its rows, so no pass waits on another.
// Nothing here allocates: the wrapper hands in the output.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void copy_kernel(const int* __restrict__ src, int* __restrict__ dst,
                            int count) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < count) dst[t] = src[t];
}

__device__ __forceinline__ int row_index(const int* idx, int i, int np) {
  int j = idx[i];
  if (j < 0 && j >= -np) j += np;
  return (j >= 0 && j < np) ? j : -1;
}

__global__ void scatter_set_kernel(int* __restrict__ dst,
                                   const int* __restrict__ idx,
                                   const int* __restrict__ rows, int b,
                                   int np) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= b * 3) return;
  const int j = row_index(idx, t / 3, np);
  if (j >= 0) dst[j * 3 + t % 3] = rows[t];
}

// Rows of dst a block of the add owns, its threads, and the pairs a
// thread loads at once.
constexpr int kAddRows = 256;
constexpr int kAddThreads = 256;
constexpr int kAddPer = kAddRows * 3 / kAddThreads;
constexpr int kAddBatch = 4;

__global__ void __launch_bounds__(kAddThreads)
scatter_add_clamp_kernel(const int* __restrict__ src, int* __restrict__ dst,
                         const int* __restrict__ idx,
                         const int* __restrict__ rows, int b, int np) {
  __shared__ int delta[kAddRows * 3];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kAddRows;
  const int ne = min(kAddRows, np - r0) * 3;
  const size_t base = (size_t)r0 * 3;
  // every load is issued before any of them is waited on: the block's src
  // elements, then each batch of pairs with their rows, so the kernel
  // waits on memory about once
  int s[kAddPer];
#pragma unroll
  for (int k = 0; k < kAddPer; ++k) {
    const int e = tid + k * kAddThreads;
    s[k] = e < ne ? src[base + e] : 0;
    delta[e] = 0;
  }
  __syncthreads();
  for (int i0 = 0; i0 < b; i0 += kAddThreads * kAddBatch) {
    int j[kAddBatch], v[kAddBatch][3];
#pragma unroll
    for (int q = 0; q < kAddBatch; ++q) {
      const int i = i0 + q * kAddThreads + tid;
      j[q] = i < b ? row_index(idx, i, np) - r0 : -1;
#pragma unroll
      for (int r = 0; r < 3; ++r) v[q][r] = i < b ? rows[i * 3 + r] : 0;
    }
#pragma unroll
    for (int q = 0; q < kAddBatch; ++q) {
      if (j[q] >= 0 && j[q] * 3 < ne) {
#pragma unroll
        for (int r = 0; r < 3; ++r) atomicAdd(delta + j[q] * 3 + r, v[q][r]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kAddPer; ++k) {
    const int e = tid + k * kAddThreads;
    if (e < ne) {
      const int x = (int)((unsigned)s[k] + (unsigned)delta[e]);
      dst[base + e] = x < 0 ? 0 : x;
    }
  }
}

inline int blocks(int count) { return (count + kThreads - 1) / kThreads; }

}  // namespace

// dst == src: in place (donated). Otherwise src is copied into dst first.
extern "C" int nomad_scatter_rows(const int* src, int* dst, const int* idx,
                                  const int* rows, int b, int np,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (src != dst) {
    copy_kernel<<<blocks(np * 3), kThreads, 0, s>>>(src, dst, np * 3);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (b > 0)
    scatter_set_kernel<<<blocks(b * 3), kThreads, 0, s>>>(dst, idx, rows, b,
                                                          np);
  return (int)cudaGetLastError();
}

// dst must not alias src: dst = max(src with rows added at idx, 0).
extern "C" int nomad_scatter_add_rows(const int* src, int* dst, const int* idx,
                                      const int* rows, int b, int np,
                                      void* stream) {
  if (np <= 0) return 0;
  scatter_add_clamp_kernel<<<(np + kAddRows - 1) / kAddRows, kAddThreads, 0,
                             (cudaStream_t)stream>>>(src, dst, idx, rows, b,
                                                     np);
  return (int)cudaGetLastError();
}
