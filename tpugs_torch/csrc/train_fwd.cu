// B4 — D-channel train render. Replaces
// tpugs/raster/pallas_train.py::_forward_tiles (kernel _make_fwd_kernel,
// weights of _block_weights_full) and the tiles_to_image crop after it.
//
// Per tile: front-to-back compositing of the tile's depth-sorted span in
// 128-Gaussian blocks, img(p, :) = sum_b w(p, b) col(b, :) over D channels,
// alpha(p) = 1 - T(p), with B1's weights and its block-granular, tile-wide
// early exit; blocks_done[tile] is the number of blocks walked, which B5
// replays. The image is written in (H, W, D) layout, cropped to W x H.
//
// Bound on an H100: operations. Per walked (pixel, Gaussian) pair, D f32
// multiply-adds plus ~30 operations for the weight; the bytes are one pack
// row (32 + 4D bytes) per walked intersection and 4(D+1) per pixel out.
// Not TF32: the trainer's gradients are held at 3e-4 of their maximum.
//
// Design. The TPU kernel keeps a tile's (1024, d_pad) f32 image in VMEM;
// at D = 131 that is 536 KB, over a Hopper block's 227 KB. So the grid is
// (tile, slice of 32 channels) and each CUDA block owns one slice: one
// thread per pixel (ts*ts threads) walks the 128 Gaussians of a block in
// order, carrying its exclusive transmittance in a register (the exact
// sequential product, as B1), and keeps its 32 channel sums in registers.
// The block's geometry and its 128 x 32 colour slice are staged in shared
// memory and read as broadcasts (float4). Every slice recomputes the same
// weights, so every slice takes the same exit.

#include <cuda_runtime.h>

#include "common.cuh"

namespace tpugs {
namespace {

constexpr int kGeomCols = 8;
constexpr int kSliceC = 32;  // channels per CUDA block

__global__ void __launch_bounds__(1024)
train_fwd_kernel(const float* __restrict__ geom, const float* __restrict__ cols,
                 const int* __restrict__ tile_starts, const int* __restrict__ tile_ends,
                 const int* __restrict__ padded_starts, float* __restrict__ img,
                 float* __restrict__ alpha_out, int* __restrict__ blocks_done, int ntx, int ts,
                 int width, int height, int D, float trans_eps) {
  __shared__ BlockGeom g;
  __shared__ __align__(16) float col[kBlock][kSliceC];

  const int tile = blockIdx.x;
  const int c0 = blockIdx.y * kSliceC;
  const int nc = min(kSliceC, D - c0);
  const int p = threadIdx.x;
  const int count = tile_ends[tile] - tile_starts[tile];
  const int nb = (count + kBlock - 1) / kBlock;
  const long long pstart = padded_starts[tile];
  const int x = (tile % ntx) * ts + p % ts;
  const int y = (tile / ntx) * ts + p / ts;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;

  float acc[kSliceC];
#pragma unroll
  for (int c = 0; c < kSliceC; ++c) acc[c] = 0.0f;
  float trans = 1.0f;
  int keep = 1.0f > trans_eps;
  int b = 0;
  for (; b < nb && keep; ++b) {
    const long long row0 = pstart + static_cast<long long>(b) * kBlock;
    load_geom(g, geom, row0, p, kGeomCols);
    for (int idx = p; idx < kBlock * kSliceC; idx += blockDim.x) {
      const int i = idx / kSliceC;
      const int c = idx % kSliceC;
      col[i][c] = c < nc ? cols[(row0 + i) * D + c0 + c] : 0.0f;
    }
    __syncthreads();
    const int remaining = count - b * kBlock;
    float texc = 1.0f;
    for (int i = 0; i < kBlock; ++i) {
      const float alpha = pair_alpha(g, i, px, py, i < remaining);
      const float w = alpha * texc * trans;
      if (w != 0.0f) {
        const float4* cv = reinterpret_cast<const float4*>(col[i]);
#pragma unroll
        for (int c4 = 0; c4 < kSliceC / 4; ++c4) {
          const float4 v = cv[c4];
          acc[4 * c4 + 0] = fmaf(w, v.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = fmaf(w, v.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(w, v.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(w, v.w, acc[4 * c4 + 3]);
        }
      }
      texc *= 1.0f - alpha;
    }
    trans *= texc;
    keep = __syncthreads_or(trans > trans_eps);
  }
  if (x < width && y < height) {
    const long long pix = static_cast<long long>(y) * width + x;
    float* o = img + pix * D + c0;
#pragma unroll
    for (int c = 0; c < kSliceC; ++c)
      if (c < nc) o[c] = acc[c];
    if (blockIdx.y == 0) alpha_out[pix] = 1.0f - trans;
  }
  if (blockIdx.y == 0 && p == 0) blocks_done[tile] = b;
}

}  // namespace
}  // namespace tpugs

extern "C" int tpugs_train_fwd(const float* geom, const float* cols, const int* tile_starts,
                               const int* tile_ends, const int* padded_starts, float* img,
                               float* alpha, int* blocks_done, int n_tiles, int ntx, int ts,
                               int width, int height, int D, float trans_eps,
                               cudaStream_t stream) {
  if (ts * ts > 1024 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_tiles, (D + tpugs::kSliceC - 1) / tpugs::kSliceC);
  tpugs::train_fwd_kernel<<<grid, ts * ts, 0, stream>>>(
      geom, cols, tile_starts, tile_ends, padded_starts, img, alpha, blocks_done, ntx, ts,
      width, height, D, trans_eps);
  return static_cast<int>(cudaGetLastError());
}
