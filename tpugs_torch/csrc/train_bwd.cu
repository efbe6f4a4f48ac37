// B5 — train backward rows. Replaces
// tpugs/raster/pallas_train.py::_backward_impl (kernel _make_bwd_kernel,
// blend state of _block_weights_full, prefix of _lane_prefix_sum).
//
// Per tile, the blocks B4 walked (blocks_done) are walked again and the
// blend state is rebuilt; per pixel p and Gaussian i of a block, with the
// image cotangent g (H, W, D), hterm = h * T_final and the carry grem
// (starting at grem0 = g . image-without-background):
//   u      = g(p) . col(i)                               (D multiply-adds)
//   v      = grem - sum_{j <= i} w_j u_j                 (sequential prefix)
//   dalpha = texc * T * u - (v + hterm) / max(1 - alpha, 1e-6)
// masked by grad_mask (kept, alpha_raw < 0.999); d sigma is gated by
// sigma > 0. Summed over the tile's pixels per Gaussian, one row per
// intersection: [d col = sum_p w g (D) | dmx dmy dca dcb dcc dop |dmx|
// |dmy| | 0 pad], in f32 or cast to bf16 at the store. Rows of blocks
// past blocks_done are zero (B3 reads every position). Each row belongs to
// one tile, so one CUDA block writes it: no atomics, the same rows on
// every run.
//
// Bound on an H100: operations. Per walked (pixel, Gaussian) pair, 2D f32
// multiply-adds (u and d col) plus ~60 operations for the blend state and
// the adjoint; the bytes are the packs and g once, and one row per
// intersection out. Not TF32 (gradients are held at 3e-4 of their max).
//
// Design. g for a 32x32 tile at D = 131 is 557 KB, and the per-pair
// state (u, w, d sigma, d op) of a 128-Gaussian block over 1024 pixels
// another 2 MB: neither fits in 227 KB. So one CUDA block of 256 threads
// per tile walks each block in sub-blocks of 32 Gaussians and the tile's
// pixels in chunks of 256 (one thread per pixel):
//   (1) u for the thread's pixel and the 32 Gaussians, in registers, from
//       g staged in 32-channel slices (Gs) and the colours (Ct);
//   (2) the sequential walk over the 32 Gaussians, carrying T, texc, the
//       prefix and grem per pixel in shared memory between sub-blocks and
//       chunks; it stores w, d sigma and d op per pair;
//   (3) the 8 geometry sums: 8 threads per Gaussian over the chunk's
//       pixels (dx, dy recomputed exactly), then a shuffle over the 8;
//   (4) d col += w^T g over the chunk, g restaged in 32-channel slices.
// After the chunks, the 32 rows are written. Shared memory is about
// 160 KB + 128 B per channel (D <= 512).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace tpugs {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kGeomCols = 8;
constexpr int kGeomGrads = 8;
constexpr int kThreads = 256;     // = pixels per chunk
constexpr int kSub = 32;          // Gaussians per sub-block
constexpr int kDK = 32;           // channels per staged slice of g
constexpr int kMaxPixels = 1024;
constexpr int kLdG = kDK + 1;     // Gs[pixel][channel]
constexpr int kLdC = kSub + 4;    // Ct[channel][gaussian], 16-byte rows
constexpr int kLdW = kSub + 4;    // Ws[pixel][gaussian], 16-byte rows
constexpr int kLdD = kThreads + 8;  // Dsig/Dop[gaussian][pixel]

constexpr size_t kFixedFloats = size_t(kThreads) * kLdG + size_t(kDK) * kLdC +
                                size_t(kThreads) * kLdW + 2 * size_t(kSub) * kLdD +
                                size_t(kSub) * kGeomGrads + 4 * size_t(kMaxPixels);

__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(bf16* o, float v) { *o = __float2bfloat16_rn(v); }

// Gs[q][k] = g(pixel q of chunk c, channel d0 + k), 0 outside the image
// or past D; ts = 1 << ts_shift. Each warp reads 32 consecutive channels of
// one pixel.
__device__ __forceinline__ void stage_g(float* Gs, const float* __restrict__ gimg, int chunk,
                                        int d0, int x0, int y0, int ts_shift, int width,
                                        int height, int D, int tid) {
  const int k = tid % kDK;
  const int ts_mask = (1 << ts_shift) - 1;
  for (int q = tid / kDK; q < kThreads; q += kThreads / kDK) {
    const int p = chunk * kThreads + q;
    const int x = x0 + (p & ts_mask);
    const int y = y0 + (p >> ts_shift);
    float v = 0.0f;
    if (x < width && y < height && d0 + k < D)
      v = gimg[(static_cast<long long>(y) * width + x) * D + d0 + k];
    Gs[q * kLdG + k] = v;
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
train_bwd_kernel(const float* __restrict__ geom, const float* __restrict__ cols,
                 const float* __restrict__ gimg, const float* __restrict__ hterm,
                 const float* __restrict__ grem0, const int* __restrict__ tile_starts,
                 const int* __restrict__ tile_ends, const int* __restrict__ padded_starts,
                 const int* __restrict__ blocks_done, OutT* __restrict__ out, int ntx, int ts,
                 int width, int height, int D, int Dpad, int RW) {
  extern __shared__ __align__(16) float smem[];
  float* Gs = smem;                       // [kThreads][kLdG]
  float* Ct = Gs + kThreads * kLdG;       // [kDK][kLdC]
  float* Ws = Ct + kDK * kLdC;            // [kThreads][kLdW]
  float* Dsig = Ws + kThreads * kLdW;     // [kSub][kLdD]
  float* Dop = Dsig + kSub * kLdD;        // [kSub][kLdD]
  float* Geo = Dop + kSub * kLdD;         // [kSub][kGeomGrads]
  float* Tr = Geo + kSub * kGeomGrads;    // per pixel: T carried into the block
  float* Tx = Tr + kMaxPixels;            //   texc within the block
  float* Cs = Tx + kMaxPixels;            //   prefix of w*u within the block
  float* Gr = Cs + kMaxPixels;            //   grem carried into the block
  float* Dcol = Gr + kMaxPixels;          // [kSub][Dpad]
  __shared__ BlockGeom g;

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int tspx = ts * ts;
  const int ts_shift = __ffs(ts) - 1;  // ts is 16 or 32
  const int n_chunks = tspx / kThreads;
  const int count = tile_ends[tile] - tile_starts[tile];
  const int nb = (count + kBlock - 1) / kBlock;
  const int nb_done = min(blocks_done[tile], nb);
  const long long pstart = padded_starts[tile];
  const int x0 = (tile % ntx) * ts;
  const int y0 = (tile / ntx) * ts;

  for (int p = tid; p < tspx; p += kThreads) {
    const int x = x0 + p % ts;
    const int y = y0 + p / ts;
    Tr[p] = 1.0f;
    Tx[p] = 1.0f;
    Cs[p] = 0.0f;
    Gr[p] = (x < width && y < height) ? grem0[static_cast<long long>(y) * width + x] : 0.0f;
  }

  for (int b = 0; b < nb_done; ++b) {
    const long long row0 = pstart + static_cast<long long>(b) * kBlock;
    load_geom(g, geom, row0, tid, kGeomCols);
    const int remaining = count - b * kBlock;
    for (int s = 0; s < kBlock / kSub; ++s) {
      const int gbase = s * kSub;
      __syncthreads();  // the previous sub-block's rows are written
      for (int idx = tid; idx < kSub * Dpad; idx += kThreads) Dcol[idx] = 0.0f;
      for (int idx = tid; idx < kSub * kGeomGrads; idx += kThreads) Geo[idx] = 0.0f;
      for (int c = 0; c < n_chunks; ++c) {
        const int p = c * kThreads + tid;
        const int x = x0 + (p & (ts - 1));
        const int y = y0 + (p >> ts_shift);
        const bool in_img = x < width && y < height;

        // (1) u[i] = g(p) . col(gbase + i)
        float u[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) u[i] = 0.0f;
        for (int d0 = 0; d0 < D; d0 += kDK) {
          __syncthreads();  // previous readers of Gs, Ct (and g, Geo, Dcol init) done
          stage_g(Gs, gimg, c, d0, x0, y0, ts_shift, width, height, D, tid);
          for (int idx = tid; idx < kSub * kDK; idx += kThreads) {
            const int i = idx / kDK;
            const int k = idx % kDK;
            Ct[k * kLdC + i] = d0 + k < D ? cols[(row0 + gbase + i) * D + d0 + k] : 0.0f;
          }
          __syncthreads();
          for (int k = 0; k < kDK; ++k) {
            const float gv = Gs[tid * kLdG + k];
            const float4* cv = reinterpret_cast<const float4*>(Ct + k * kLdC);
#pragma unroll
            for (int i4 = 0; i4 < kSub / 4; ++i4) {
              const float4 v = cv[i4];
              u[4 * i4 + 0] = fmaf(gv, v.x, u[4 * i4 + 0]);
              u[4 * i4 + 1] = fmaf(gv, v.y, u[4 * i4 + 1]);
              u[4 * i4 + 2] = fmaf(gv, v.z, u[4 * i4 + 2]);
              u[4 * i4 + 3] = fmaf(gv, v.w, u[4 * i4 + 3]);
            }
          }
        }

        // (2) the walk over the sub-block for this pixel
        {
          const float px = static_cast<float>(x) + 0.5f;
          const float py = static_cast<float>(y) + 0.5f;
          const float trans = Tr[p];
          const float grem = Gr[p];
          const float h = in_img ? hterm[static_cast<long long>(y) * width + x] : 0.0f;
          float texc = Tx[p];
          float cs = Cs[p];
#pragma unroll
          for (int i = 0; i < kSub; ++i) {
            const int gi = gbase + i;
            const PairTerms t = pair_terms(g, gi, px, py);
            const float alpha = clipped_alpha(t, gi < remaining);
            const bool kept = alpha != 0.0f;
            const float w = alpha * texc * trans;
            cs = fmaf(w, u[i], cs);
            const float v = grem - cs;
            const float d_alpha = texc * trans * u[i] - (v + h) / fmaxf(1.0f - alpha, 1e-6f);
            const float d_araw = (kept && t.alpha_raw < kAlphaMax) ? d_alpha : 0.0f;
            Dop[i * kLdD + tid] = d_araw * t.e;
            Dsig[i * kLdD + tid] = t.sigma > 0.0f ? -d_araw * g.op[gi] * t.e : 0.0f;
            Ws[tid * kLdW + i] = w;
            texc *= 1.0f - alpha;
          }
          Tx[p] = texc;
          Cs[p] = cs;
        }
        __syncthreads();

        // (3) geometry sums: 8 threads per Gaussian, then a shuffle over them
        {
          const int i = tid >> 3;
          const int l = tid & 7;
          const int gi = gbase + i;
          const float mx = g.mx[gi], my = g.my[gi];
          const float ca = g.ca[gi], cb = g.cb[gi], cc = g.cc[gi];
          float a[kGeomGrads];
#pragma unroll
          for (int k = 0; k < kGeomGrads; ++k) a[k] = 0.0f;
          for (int q = l; q < kThreads; q += 8) {
            const int pq = c * kThreads + q;
            const float qx = static_cast<float>(x0 + (pq & (ts - 1))) + 0.5f;
            const float qy = static_cast<float>(y0 + (pq >> ts_shift)) + 0.5f;
            const float dx = __fsub_rn(qx, mx);
            const float dy = __fsub_rn(qy, my);
            const float ds = Dsig[i * kLdD + q];
            const float dmx = ds * -(ca * dx + cb * dy);
            const float dmy = ds * -(cc * dy + cb * dx);
            a[0] += dmx;
            a[1] += dmy;
            a[2] += ds * (0.5f * dx * dx);
            a[3] += ds * (dx * dy);
            a[4] += ds * (0.5f * dy * dy);
            a[5] += Dop[i * kLdD + q];
            a[6] += fabsf(dmx);
            a[7] += fabsf(dmy);
          }
#pragma unroll
          for (int k = 0; k < kGeomGrads; ++k) {
#pragma unroll
            for (int off = 4; off >= 1; off >>= 1)
              a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
          }
          if (l == 0) {
#pragma unroll
            for (int k = 0; k < kGeomGrads; ++k) Geo[i * kGeomGrads + k] += a[k];
          }
        }

        // (4) d col(gbase + 4 ig + j, d0 + k) += sum_q w(q, .) g(q, d0 + k)
        {
          const int ig = tid / 32;
          const int k = tid % 32;
          for (int d0 = 0; d0 < D; d0 += kDK) {
            __syncthreads();  // previous readers of Gs done
            stage_g(Gs, gimg, c, d0, x0, y0, ts_shift, width, height, D, tid);
            __syncthreads();
            float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
            for (int q = 0; q < kThreads; ++q) {
              const float4 w4 = *reinterpret_cast<const float4*>(Ws + q * kLdW + 4 * ig);
              const float gv = Gs[q * kLdG + k];
              a0 = fmaf(w4.x, gv, a0);
              a1 = fmaf(w4.y, gv, a1);
              a2 = fmaf(w4.z, gv, a2);
              a3 = fmaf(w4.w, gv, a3);
            }
            float* dc = Dcol + (4 * ig) * Dpad + d0 + k;
            dc[0] += a0;
            dc[Dpad] += a1;
            dc[2 * Dpad] += a2;
            dc[3 * Dpad] += a3;
          }
        }
      }
      __syncthreads();
      for (int idx = tid; idx < kSub * RW; idx += kThreads) {
        const int i = idx / RW;
        const int col = idx % RW;
        float v = 0.0f;
        if (col < D)
          v = Dcol[i * Dpad + col];
        else if (col < D + kGeomGrads)
          v = Geo[i * kGeomGrads + col - D];
        store(out + (row0 + gbase + i) * RW + col, v);
      }
    }
    __syncthreads();
    for (int p = tid; p < tspx; p += kThreads) {
      Tr[p] *= Tx[p];
      Gr[p] -= Cs[p];
      Tx[p] = 1.0f;
      Cs[p] = 0.0f;
    }
    __syncthreads();
  }
  // blocks the forward's early exit skipped: zero rows
  const long long zero0 = (pstart + static_cast<long long>(nb_done) * kBlock) * RW;
  const long long n_zero = static_cast<long long>(nb - nb_done) * kBlock * RW;
  for (long long idx = tid; idx < n_zero; idx += kThreads) store(out + zero0 + idx, 0.0f);
}

template <typename OutT>
int launch(const float* geom, const float* cols, const float* gimg, const float* hterm,
           const float* grem0, const int* tile_starts, const int* tile_ends,
           const int* padded_starts, const int* blocks_done, OutT* out, int n_tiles, int ntx,
           int ts, int width, int height, int D, int RW, cudaStream_t stream) {
  const int Dpad = (D + kDK - 1) / kDK * kDK;
  if (D < 1 || RW < D + kGeomGrads || (ts != 16 && ts != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = (kFixedFloats + size_t(kSub) * Dpad) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(train_bwd_kernel<OutT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  train_bwd_kernel<OutT><<<n_tiles, kThreads, bytes, stream>>>(
      geom, cols, gimg, hterm, grem0, tile_starts, tile_ends, padded_starts, blocks_done, out,
      ntx, ts, width, height, D, Dpad, RW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tpugs

extern "C" int tpugs_train_bwd_f32(const float* geom, const float* cols, const float* gimg,
                                   const float* hterm, const float* grem0,
                                   const int* tile_starts, const int* tile_ends,
                                   const int* padded_starts, const int* blocks_done,
                                   float* out, int n_tiles, int ntx, int ts, int width,
                                   int height, int D, int RW, cudaStream_t stream) {
  return tpugs::launch<float>(geom, cols, gimg, hterm, grem0, tile_starts, tile_ends,
                              padded_starts, blocks_done, out, n_tiles, ntx, ts, width, height,
                              D, RW, stream);
}

extern "C" int tpugs_train_bwd_bf16(const float* geom, const float* cols, const float* gimg,
                                    const float* hterm, const float* grem0,
                                    const int* tile_starts, const int* tile_ends,
                                    const int* padded_starts, const int* blocks_done,
                                    __nv_bfloat16* out, int n_tiles, int ntx, int ts,
                                    int width, int height, int D, int RW,
                                    cudaStream_t stream) {
  return tpugs::launch<__nv_bfloat16>(geom, cols, gimg, hterm, grem0, tile_starts, tile_ends,
                                      padded_starts, blocks_done, out, n_tiles, ntx, ts, width,
                                      height, D, RW, stream);
}
