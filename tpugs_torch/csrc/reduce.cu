// B3 — per-Gaussian reduce of the contribution rows. Replaces
// tpugs/raster/pallas_tiled.py::reduce_contribs_pallas (kernel
// _make_stripe_sum_kernel, with the XLA slot-table gather before it and
// the unpermute by slot_order after it).
//
// out[i, c] = sum over Gaussian i's intersections, in increasing tile
// order, of rows[pos, c], accumulated in f32 from 0. That is the order in
// which the reference's stripe-sum adds a column's stripes, so given the
// same rows the result is bit-equal to it.
//
// Bound on an H100: bytes. Each intersection's row (D+1 columns, 2 bytes
// each in bf16) is read once and each Gaussian's (D+1) f32 sums are
// written once; the adds are negligible. Design: gather and sum in one
// pass — a warp per Gaussian reads its CSR position list and, for each 64
// channels, loads two channels per lane from every row (128 coalesced
// bytes per row in bf16), keeping the running sums in registers, and
// writes the row straight to the Gaussian's original index. No gathered
// copy of the rows (~2.3 GB at garden scale) is materialised and no
// unpermute pass is needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tpugs {
namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__global__ void reduce_kernel(const T* __restrict__ rows, const int* __restrict__ offsets,
                              const int* __restrict__ pos, float* __restrict__ out, int n,
                              int n_cols, int row_stride) {
  const int lane = threadIdx.x % 32;
  const int gid = blockIdx.x * kWarps + threadIdx.x / 32;
  if (gid >= n) return;
  const int k0 = offsets[gid];
  const int k1 = offsets[gid + 1];
  float* o = out + static_cast<long long>(gid) * n_cols;
  for (int c = lane * 2; c < n_cols; c += 64) {
    float a0 = 0.0f, a1 = 0.0f;
    for (int k = k0; k < k1; ++k) {
      const float2 v = load_pair(rows + static_cast<long long>(pos[k]) * row_stride + c);
      a0 += v.x;
      a1 += v.y;
    }
    o[c] = a0;
    if (c + 1 < n_cols) o[c + 1] = a1;
  }
}

template <typename T>
int launch(const T* rows, const int* offsets, const int* pos, float* out, int n,
           int n_cols, int row_stride, cudaStream_t stream) {
  if (row_stride % 2 != 0 || n_cols > row_stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kWarps - 1) / kWarps;
  reduce_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(rows, offsets, pos, out, n, n_cols,
                                                       row_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tpugs

extern "C" int tpugs_reduce_f32(const float* rows, const int* offsets, const int* pos,
                                float* out, int n, int n_cols, int row_stride,
                                cudaStream_t stream) {
  return tpugs::launch<float>(rows, offsets, pos, out, n, n_cols, row_stride, stream);
}

extern "C" int tpugs_reduce_bf16(const __nv_bfloat16* rows, const int* offsets,
                                 const int* pos, float* out, int n, int n_cols,
                                 int row_stride, cudaStream_t stream) {
  return tpugs::launch<__nv_bfloat16>(rows, offsets, pos, out, n, n_cols, row_stride,
                                      stream);
}
