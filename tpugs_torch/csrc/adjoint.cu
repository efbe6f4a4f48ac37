// B2 — adjoint contribution rows. Replaces
// tpugs/raster/pallas_tiled.py::adjoint_pallas_raw (kernel
// _make_adjoint_kernel, exact weights of _block_weights_full).
//
// For every intersection in padded slot r of tile t's span, row r holds
// sum_p w(p) * [F_t(p) | 1 | 0...] over the tile's pixels: blend-weighted
// features plus the ones-channel at column D, whose sum is the weight
// denominator. Same walk, weights and tile-wide early exit as B1; weights
// of pixels outside W x H are zeroed; blocks skipped by the exit get zero
// rows (they are real intersections that B3 reads).
//
// Bound on an H100: tensor-core operations. Per processed block the
// product is 128 x (ts*ts) x (D+1) multiply-adds: 2 * pairs * (D+1) FLOP,
// at 989 TFLOP/s in bf16, against ~1 KB per row written. The weights are
// ~30 f32 operations per pair on the CUDA cores.
//
// Design. The TPU kernel keeps a tile's 1024 x 640 bf16 feature slab and a
// 1024 x 128 weight block in VMEM (1.3 MB); a Hopper block has 227 KB. So
// the grid is (channel slice of 128, tile), 256 threads, and each block
// recomputes the tile's weights for its slice (cheap next to the product):
//   per 128-Gaussian block, per pixel sub-chunk of P pixels:
//     - one thread per pixel walks the 128 Gaussians in order carrying its
//       transmittance (exact sequential product) and writes w^T to shared
//       memory, cast to bf16 in bf16 mode as the reference does;
//     - the feature sub-chunk (P x 128 channels, ones-channel synthesised)
//       is staged in shared memory;
//     - C[128 x 128] += w^T F: WMMA bf16 tensor-core tiles with f32
//       accumulate in bf16 mode (P = 256), f32 FMA in f32 mode (P = 128);
//   then the 128 rows are written and the tile-wide exit is tested with
//   __syncthreads_or. Per-pixel T persists in shared memory across blocks.
// Shared memory: about 134 KB dynamic (both modes) + 7 KB static.
//
// B6 — the scatter-write adjoint of the opt-in scatter reduce engine.
// Replaces tpugs/raster/pallas_tiled.py::adjoint_scatter_pallas_raw
// (kernel _make_adjoint_scatter_kernel). It is this kernel instantiated
// with a destination table: row r goes to out + dest[r] * DC instead of
// out + r * DC, at all three write sites (the products of both modes and
// the zero rows of blocks past the early exit, which are real
// intersections and are summed). Weights and products are B2's own
// instructions, so each row is bit-equal to B2's. dest is the plan's
// slot_pos: rows land in the striped layout that B7 (stripe_sum.cu) reads
// in sequence; every padding slot maps to one trash row, whose racing
// writes are harmless because nothing reads it. Rows keep B2's width; the
// reference's 1024-lane rows are a Mosaic unit and are not copied. Bound:
// B2's, plus 4 bytes of dest per written row; the scattered rows (1.3 KB
// at D = 512) are each written whole by consecutive threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace tpugs {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kSlice = 128;       // channels per block; CHANNEL_SLICE in kernels.py
constexpr int kLdc = kSlice + 4;  // f32 row stride of the output stage
constexpr int kMaxPixels = 1024;

template <typename T> struct Cfg;
template <> struct Cfg<float> { static constexpr int P = 128, kPad = 4; };
template <> struct Cfg<bf16> { static constexpr int P = 256, kPad = 8; };

template <typename T>
struct Layout {
  static constexpr int P = Cfg<T>::P;
  static constexpr int LDA = P + Cfg<T>::kPad;       // w^T stage: [kBlock][LDA]
  static constexpr int LDF = kSlice + Cfg<T>::kPad;  // feature stage: [P][LDF]
  static constexpr size_t kW = size_t(kBlock) * LDA * sizeof(T);
  static constexpr size_t kF = size_t(P) * LDF * sizeof(T);
  static constexpr size_t kC = size_t(kBlock) * kLdc * sizeof(float);
  static constexpr size_t kBytes = (kW + kF > kC) ? kW + kF : kC;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// Row r of the plan is written to output row r (B2) or dest[r] (B6).
template <bool kScatter>
__device__ __forceinline__ long long out_row(const int* __restrict__ dest, long long r) {
  if constexpr (kScatter) {
    return dest[r];
  } else {
    return r;
  }
}

// F[pl][c] = feats[tile][pix0 + pl][c0 + c] for c0 + c < D, 1 at column D,
// 0 after; 16-byte loads where the row allows.
template <typename T>
__device__ __forceinline__ void stage_features(T* Fs, const T* __restrict__ feats,
                                               long long pix_base, int c0, int D,
                                               bool vec_ok, int tid) {
  using L = Layout<T>;
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = kSlice / V;
  for (int idx = tid; idx < L::P * VPR; idx += kThreads) {
    const int pl = idx / VPR;
    const int col = c0 + (idx % VPR) * V;
    const T* src = feats + (pix_base + pl) * D + col;
    T* dst = Fs + pl * L::LDF + (idx % VPR) * V;
    if (vec_ok && col + V <= D) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int c = col + e;
        dst[e] = c < D ? src[e] : from_f<T>(c == D ? 1.0f : 0.0f);
      }
    }
  }
}

// bf16: C[128 x 128] on the tensor cores. Warp w owns rows 16w..16w+15.
struct MmaProduct {
  using T = bf16;
  using L = Layout<bf16>;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[kSlice / 16];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < kSlice / 16; ++j) nvcuda::wmma::fill_fragment(acc[j], 0.0f);
  }

  __device__ void accumulate(const bf16* Wt, const bf16* Fs, int tid) {
    using namespace nvcuda;
    const int warp = tid / 32;
    for (int k = 0; k < L::P / 16; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Wt + warp * 16 * L::LDA + k * 16, L::LDA);
#pragma unroll
      for (int j = 0; j < kSlice / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> f;
        wmma::load_matrix_sync(f, Fs + k * 16 * L::LDF + j * 16, L::LDF);
        wmma::mma_sync(acc[j], a, f, acc[j]);
      }
    }
  }

  // Called by all threads after a barrier that ends every read of Wt/Fs
  // (the f32 stage Cs aliases them).
  template <bool kScatter>
  __device__ void store(bf16* __restrict__ out, const int* __restrict__ dest, long long row0,
                        int DC, int c0, float* Cs, int tid) {
    const int warp = tid / 32;
#pragma unroll
    for (int j = 0; j < kSlice / 16; ++j)
      nvcuda::wmma::store_matrix_sync(Cs + warp * 16 * kLdc + j * 16, acc[j], kLdc,
                                      nvcuda::wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < kBlock * kSlice / 2; idx += kThreads) {
      const int g = idx / (kSlice / 2);
      const int c = (idx % (kSlice / 2)) * 2;
      *reinterpret_cast<__nv_bfloat162*>(out + out_row<kScatter>(dest, row0 + g) * DC + c0 + c) =
          __floats2bfloat162_rn(Cs[g * kLdc + c], Cs[g * kLdc + c + 1]);
    }
  }
};

// f32: C[128 x 128] by FMA, an 8 x 8 register tile per thread.
struct FmaProduct {
  using T = float;
  using L = Layout<float>;
  float acc[8][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  __device__ void accumulate(const float* Wt, const float* Fs, int tid) {
    const int tg = tid / 16, tc = tid % 16;
    for (int p = 0; p < L::P; ++p) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Wt[(tg * 8 + i) * L::LDA + p];
      const float4 b0 = *reinterpret_cast<const float4*>(Fs + p * L::LDF + tc * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(Fs + p * L::LDF + tc * 8 + 4);
      const float f[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], f[j], acc[i][j]);
    }
  }

  template <bool kScatter>
  __device__ void store(float* __restrict__ out, const int* __restrict__ dest, long long row0,
                        int DC, int c0, float*, int tid) {
    const int tg = tid / 16, tc = tid % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* o = out + out_row<kScatter>(dest, row0 + tg * 8 + i) * DC + c0 + tc * 8;
      *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
};

template <typename T>
using ProductOf = typename std::conditional<std::is_same<T, bf16>::value, MmaProduct,
                                            FmaProduct>::type;

template <typename T, bool kScatter>
__global__ void __launch_bounds__(kThreads)
adjoint_kernel(const float* __restrict__ pack, const int* __restrict__ tile_starts,
               const int* __restrict__ tile_ends, const int* __restrict__ padded_starts,
               const T* __restrict__ feats, const int* __restrict__ dest, T* __restrict__ out,
               int ntx, int ts, int width, int height, int D, int DC, float trans_eps,
               int vec_ok) {
  using L = Layout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Wt = reinterpret_cast<T*>(smem);
  T* Fs = reinterpret_cast<T*>(smem + L::kW);
  float* Cs = reinterpret_cast<float*>(smem);
  __shared__ BlockGeom g;
  __shared__ float Tpix[kMaxPixels];

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kSlice;
  const int tile = blockIdx.y;
  const int tspx = ts * ts;
  const int count = tile_ends[tile] - tile_starts[tile];
  const int nb = (count + kBlock - 1) / kBlock;
  const long long pstart = padded_starts[tile];
  const int x0 = (tile % ntx) * ts;
  const int y0 = (tile / ntx) * ts;

  for (int p = tid; p < tspx; p += kThreads) Tpix[p] = 1.0f;
  __syncthreads();
  int keep = 1.0f > trans_eps;
  ProductOf<T> prod;

  for (int b = 0; b < nb; ++b) {
    const long long row0 = pstart + static_cast<long long>(b) * kBlock;
    if (!keep) {  // early exit: the remaining blocks' rows are zeros
      for (int idx = tid; idx < kBlock * kSlice; idx += kThreads)
        out[out_row<kScatter>(dest, row0 + idx / kSlice) * DC + c0 + idx % kSlice] =
            from_f<T>(0.0f);
      continue;
    }
    load_geom(g, pack, row0, tid);
    __syncthreads();
    const int remaining = count - b * kBlock;
    prod.zero();
    for (int sub = 0; sub < tspx / L::P; ++sub) {
      if (tid < L::P) {
        const int p = sub * L::P + tid;
        const float px = static_cast<float>(x0 + p % ts) + 0.5f;
        const float py = static_cast<float>(y0 + p / ts) + 0.5f;
        const bool in_img = px < static_cast<float>(width) && py < static_cast<float>(height);
        const float trans = Tpix[p];
        float texc = 1.0f;
        for (int i = 0; i < kBlock; ++i) {
          const float alpha = pair_alpha(g, i, px, py, i < remaining);
          const float w = alpha * texc * trans;
          texc *= 1.0f - alpha;
          Wt[i * L::LDA + tid] = from_f<T>(in_img ? w : 0.0f);
        }
        Tpix[p] = trans * texc;
      }
      stage_features<T>(Fs, feats, static_cast<long long>(tile) * tspx + sub * L::P, c0, D,
                        vec_ok, tid);
      __syncthreads();
      prod.accumulate(Wt, Fs, tid);
      __syncthreads();
    }
    prod.template store<kScatter>(out, dest, row0, DC, c0, Cs, tid);
    int any = 0;
    for (int p = tid; p < tspx; p += kThreads) any |= Tpix[p] > trans_eps;
    keep = __syncthreads_or(any);
  }
}

template <typename T, bool kScatter>
int launch(const float* pack, const int* tile_starts, const int* tile_ends,
           const int* padded_starts, const T* feats, const int* dest, T* out, int n_tiles,
           int ntx, int ts, int width, int height, int D, int DC, float trans_eps,
           cudaStream_t stream) {
  using L = Layout<T>;
  if (DC % kSlice != 0 || DC < D + 1 || ts * ts > kMaxPixels || (ts * ts) % L::P != 0 ||
      kScatter != (dest != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(adjoint_kernel<T, kScatter>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::kBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int V = 16 / sizeof(T);
  const int vec_ok = (D % V == 0) && (reinterpret_cast<uintptr_t>(feats) % 16 == 0);
  const dim3 grid(DC / kSlice, n_tiles);
  adjoint_kernel<T, kScatter><<<grid, kThreads, L::kBytes, stream>>>(
      pack, tile_starts, tile_ends, padded_starts, feats, dest, out, ntx, ts, width, height,
      D, DC, trans_eps, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tpugs

extern "C" int tpugs_adjoint_f32(const float* pack, const int* tile_starts,
                                 const int* tile_ends, const int* padded_starts,
                                 const float* feats, float* out, int n_tiles, int ntx,
                                 int ts, int width, int height, int D, int DC,
                                 float trans_eps, cudaStream_t stream) {
  return tpugs::launch<float, false>(pack, tile_starts, tile_ends, padded_starts, feats,
                                     nullptr, out, n_tiles, ntx, ts, width, height, D, DC,
                                     trans_eps, stream);
}

extern "C" int tpugs_adjoint_bf16(const float* pack, const int* tile_starts,
                                  const int* tile_ends, const int* padded_starts,
                                  const __nv_bfloat16* feats, __nv_bfloat16* out,
                                  int n_tiles, int ntx, int ts, int width, int height,
                                  int D, int DC, float trans_eps, cudaStream_t stream) {
  return tpugs::launch<__nv_bfloat16, false>(pack, tile_starts, tile_ends, padded_starts,
                                             feats, nullptr, out, n_tiles, ntx, ts, width,
                                             height, D, DC, trans_eps, stream);
}

extern "C" int tpugs_adjoint_scatter_f32(const float* pack, const int* tile_starts,
                                         const int* tile_ends, const int* padded_starts,
                                         const float* feats, const int* dest, float* out,
                                         int n_tiles, int ntx, int ts, int width,
                                         int height, int D, int DC, float trans_eps,
                                         cudaStream_t stream) {
  return tpugs::launch<float, true>(pack, tile_starts, tile_ends, padded_starts, feats, dest,
                                    out, n_tiles, ntx, ts, width, height, D, DC, trans_eps,
                                    stream);
}

extern "C" int tpugs_adjoint_scatter_bf16(const float* pack, const int* tile_starts,
                                          const int* tile_ends, const int* padded_starts,
                                          const __nv_bfloat16* feats, const int* dest,
                                          __nv_bfloat16* out, int n_tiles, int ntx, int ts,
                                          int width, int height, int D, int DC,
                                          float trans_eps, cudaStream_t stream) {
  return tpugs::launch<__nv_bfloat16, true>(pack, tile_starts, tile_ends, padded_starts,
                                            feats, dest, out, n_tiles, ntx, ts, width,
                                            height, D, DC, trans_eps, stream);
}
