// B1 — tile render. Replaces tpugs/raster/pallas_tiled.py::render_pallas_raw
// (kernel _make_render_kernel, exact weights of _block_weights_full).
//
// Per tile: front-to-back alpha compositing over the tile's depth-sorted
// span in 128-Gaussian blocks, writing [r, g, b, depth, 1 - T] per pixel,
// with the reference's block-granular, tile-wide early exit (stop before a
// block once max over the tile's ts*ts pixels of T <= trans_eps).
//
// Bound on an H100: operations. Each evaluated (pixel, Gaussian) pair costs
// about 30 f32 operations including one exp; the bytes are one 64-byte pack
// row per intersection (shared by the tile's pixels) and 20 bytes out per
// pixel. Design: one CUDA block per tile, one thread per pixel (ts*ts
// threads), the block's geometry and colours staged once in shared memory
// and read as broadcasts; each thread walks the 128 Gaussians in order
// carrying its exclusive transmittance in a register, which is the exact
// sequential product. The tile-wide exit is __syncthreads_or(T > eps),
// which is also the barrier before the next block overwrites the stage.

#include <cuda_runtime.h>

#include "common.cuh"

namespace tpugs {
namespace {

__global__ void render_kernel(const float* __restrict__ pack,
                              const int* __restrict__ tile_starts,
                              const int* __restrict__ tile_ends,
                              const int* __restrict__ padded_starts,
                              float* __restrict__ out, int* __restrict__ blocks_done,
                              int ntx, int ts, float trans_eps) {
  __shared__ BlockGeom g;
  __shared__ float col[4][kBlock];  // c0, c1, c2, depth

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int tspx = ts * ts;
  const int count = tile_ends[tile] - tile_starts[tile];
  const int nb = (count + kBlock - 1) / kBlock;
  const long long pstart = padded_starts[tile];
  const float px = static_cast<float>((tile % ntx) * ts + p % ts) + 0.5f;
  const float py = static_cast<float>((tile / ntx) * ts + p / ts) + 0.5f;

  float trans = 1.0f;
  float img[4] = {0.f, 0.f, 0.f, 0.f};
  int keep = 1.0f > trans_eps;
  int b = 0;
  for (; b < nb && keep; ++b) {
    const long long row0 = pstart + static_cast<long long>(b) * kBlock;
    load_geom(g, pack, row0, p);
    if (p < kBlock) {
      const float4 c = *reinterpret_cast<const float4*>(pack + (row0 + p) * kPackCols + 8);
      col[0][p] = c.x; col[1][p] = c.y; col[2][p] = c.z; col[3][p] = c.w;
    }
    __syncthreads();
    const int remaining = count - b * kBlock;
    float texc = 1.0f;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < kBlock; ++i) {
      const float alpha = pair_alpha(g, i, px, py, i < remaining);
      const float w = alpha * texc * trans;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += w * col[c][i];
      texc *= 1.0f - alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) img[c] += acc[c];
    trans *= texc;
    keep = __syncthreads_or(trans > trans_eps);
  }
  float* o = out + (static_cast<long long>(tile) * tspx + p) * 5;
  o[0] = img[0]; o[1] = img[1]; o[2] = img[2]; o[3] = img[3];
  o[4] = 1.0f - trans;
  if (p == 0) blocks_done[tile] = b;
}

}  // namespace
}  // namespace tpugs

extern "C" int tpugs_render(const float* pack, const int* tile_starts,
                            const int* tile_ends, const int* padded_starts,
                            float* out, int* blocks_done, int n_tiles, int ntx,
                            int ts, float trans_eps, cudaStream_t stream) {
  tpugs::render_kernel<<<n_tiles, ts * ts, 0, stream>>>(
      pack, tile_starts, tile_ends, padded_starts, out, blocks_done, ntx, ts,
      trans_eps);
  return static_cast<int>(cudaGetLastError());
}
