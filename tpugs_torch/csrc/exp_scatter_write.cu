// S1 — do scattered row writes cost more than contiguous ones under
// compute? Replaces scripts/exp_scatter_write.py::run (kernel make_kernel)
// and ::smem_dma_legal, the experiment behind the scatter reduce engine
// (B6 writes every contribution row to a slot-ordered position).
//
// scatter_write_kernel: one 256-thread block per 128-row block i.
//   * Synthetic compute, as much as the reference's per grid step: a
//     512 x 128 f32 array, each element carried through compute_iters
//     dependent multiply-adds x = x * 1.000001 + 0.5 (fmaf), in registers,
//     eight independent chains a thread at a time. Each thread folds its
//     256 results into 4 sums, so the block ends with 1024 values s[e];
//     every chain feeds the rows written, and none can be dropped.
//   * Writes: 128 rows of 1024 bf16 (2 KB, the reference's row), row r
//     holding s rotated by r (element e = s[(e + r) % 1024]), so the rows of
//     a block differ. contig writes row r at i * 128 + r, scatter at
//     pos[i * 128 + r]. Each row is written whole, 16 bytes a thread, by
//     128 consecutive threads.
//   Bound on an H100: the larger of the rows' bytes (plus pos for scatter)
//   at 3.35 TB/s and the multiply-adds (2 operations each) at 67 TF/s.
//
// async_copy_probe_kernel: the counterpart of smem_dma_legal, which asked
// whether Mosaic allows an HBM -> SMEM copy at a dynamic offset. It copies
// 8 int32 from src + 8 * offset into shared memory with cp.async
// (__pipeline_memcpy_async, two 16-byte copies), waits, and returns
// element 3: 19 for src = arange(64), offset = 2.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpugs {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kRows = 128;                         // rows per block
constexpr int kRowElems = 1024;                    // bf16 per row
constexpr int kElems = 512 * 128;                  // compute array per block
constexpr int kPerThread = kElems / kThreads;      // 256
constexpr int kChains = 8;                         // chains a thread carries at once
constexpr int kSums = kRowElems / kThreads;        // 4
constexpr int kVecs = kRowElems / 8;               // 16-byte vectors per row

// Start value of element m of block blk: the top 10 bits of a
// multiplicative hash of blk * 65536 + m, over 64 — a multiple of 1/64
// below 16, so the plain version's f64 arithmetic reproduces fmaf exactly,
// and the blocks' values differ.
__device__ __forceinline__ float start_value(long long blk, int m) {
  const unsigned h = (static_cast<unsigned>(blk) * 65536u + static_cast<unsigned>(m)) *
                     2654435761u;
  return static_cast<float>(h >> 22) * (1.0f / 64.0f);
}

__global__ void __launch_bounds__(kThreads)
scatter_write_kernel(const int* __restrict__ pos, bf16* __restrict__ out, int compute_iters) {
  __shared__ float srow[kRowElems];
  const int tid = threadIdx.x;
  const long long blk = blockIdx.x;
  float s[kSums] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < kPerThread; k0 += kChains) {
    float x[kChains];
#pragma unroll
    for (int q = 0; q < kChains; ++q) x[q] = start_value(blk, tid + (k0 + q) * kThreads);
    for (int it = 0; it < compute_iters; ++it) {
#pragma unroll
      for (int q = 0; q < kChains; ++q) x[q] = fmaf(x[q], 1.000001f, 0.5f);
    }
#pragma unroll
    for (int q = 0; q < kChains; ++q) s[q % kSums] += x[q];
  }
#pragma unroll
  for (int q = 0; q < kSums; ++q) srow[tid + q * kThreads] = s[q];
  __syncthreads();

  const int v = tid % kVecs;
  for (int r = tid / kVecs; r < kRows; r += kThreads / kVecs) {
    const long long row = blk * kRows + r;
    const long long dst = pos != nullptr ? pos[row] : row;
    __align__(16) bf16 vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      vals[e] = __float2bfloat16_rn(srow[(v * 8 + e + r) & (kRowElems - 1)]);
    *reinterpret_cast<uint4*>(out + dst * kRowElems + v * 8) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

__global__ void async_copy_probe_kernel(const int* __restrict__ src, int offset,
                                        int* __restrict__ out) {
  __shared__ __align__(16) int buf[8];
  const int t = threadIdx.x;
  if (t < 2) __pipeline_memcpy_async(buf + 4 * t, src + 8 * offset + 4 * t, 16);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (t == 0) out[0] = buf[3];
}

}  // namespace
}  // namespace tpugs

// pos: (nb * 128,) int32 destination rows, or null for contig; out:
// (nb * 128, 1024) bf16.
extern "C" int tpugs_exp_scatter_write(const int* pos, __nv_bfloat16* out, int nb,
                                       int compute_iters, cudaStream_t stream) {
  if (nb <= 0 || compute_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  tpugs::scatter_write_kernel<<<nb, tpugs::kThreads, 0, stream>>>(pos, out, compute_iters);
  return static_cast<int>(cudaGetLastError());
}

// src: 16-byte aligned int32 array with at least 8 * (offset + 1) entries.
extern "C" int tpugs_exp_async_copy_probe(const int* src, int offset, int* out,
                                          cudaStream_t stream) {
  if (offset < 0 || reinterpret_cast<uintptr_t>(src) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  tpugs::async_copy_probe_kernel<<<1, 32, 0, stream>>>(src, offset, out);
  return static_cast<int>(cudaGetLastError());
}
