// B7 — masked stripe sum of the scatter reduce engine. Replaces
// tpugs/raster/pallas_tiled.py::reduce_striped_pallas (kernel
// _make_masked_stripe_kernel, with the unpermute acc[inv] after it).
//
// B6 (adjoint.cu with a destination table) writes cover row j of column c
// to striped row base[j] + c. For each column c:
//   out[index[c], :] = sum over j = 0 .. culled[c]-1 of striped[base[j] + c, :n_cols],
// accumulated in f32 from 0 in j order, which is the increasing tile order
// in which B3 adds the same rows: given B2's rows, the sums are bit-equal
// to B3's. With a null index the sums are written in column order (row c).
//
// Looping to culled[c] replaces the reference's masked select: rows past a
// column's count were never written (their contents may be NaN) and are
// never read. Bound on an H100: bytes. Every live striped row (D+1
// columns, 2 bytes each in bf16) is read once and each Gaussian's (D+1)
// f32 sums written once. Design: B3's (reduce.cu), with only the address
// changed — a warp per column, two channels a lane, the sums in registers.
// The eight warps of a block take neighbouring columns, so in each stripe
// they read neighbouring rows: the reads are sequential, which is the
// point of the striped layout.

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
__global__ void stripe_sum_kernel(const T* __restrict__ striped, const int* __restrict__ base,
                                  const int* __restrict__ culled,
                                  const long long* __restrict__ index, float* __restrict__ out,
                                  int n, int n_cols, int row_stride) {
  const int lane = threadIdx.x % 32;
  const int col = blockIdx.x * kWarps + threadIdx.x / 32;
  if (col >= n) return;
  const int count = culled[col];
  const long long dst = index != nullptr ? index[col] : col;
  float* o = out + dst * n_cols;
  for (int c = lane * 2; c < n_cols; c += 64) {
    float a0 = 0.0f, a1 = 0.0f;
    for (int j = 0; j < count; ++j) {
      const float2 v =
          load_pair(striped + (static_cast<long long>(base[j]) + col) * row_stride + c);
      a0 += v.x;
      a1 += v.y;
    }
    o[c] = a0;
    if (c + 1 < n_cols) o[c + 1] = a1;
  }
}

template <typename T>
int launch(const T* striped, const int* base, const int* culled, const long long* index,
           float* out, int n, int n_cols, int row_stride, cudaStream_t stream) {
  if (row_stride % 2 != 0 || n_cols > row_stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kWarps - 1) / kWarps;
  stripe_sum_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(striped, base, culled, index, out,
                                                           n, n_cols, row_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tpugs

extern "C" int tpugs_stripe_sum_f32(const float* striped, const int* base, const int* culled,
                                    const long long* index, float* out, int n, int n_cols,
                                    int row_stride, cudaStream_t stream) {
  return tpugs::launch<float>(striped, base, culled, index, out, n, n_cols, row_stride,
                              stream);
}

extern "C" int tpugs_stripe_sum_bf16(const __nv_bfloat16* striped, const int* base,
                                     const int* culled, const long long* index, float* out,
                                     int n, int n_cols, int row_stride, cudaStream_t stream) {
  return tpugs::launch<__nv_bfloat16>(striped, base, culled, index, out, n, n_cols,
                                      row_stride, stream);
}
