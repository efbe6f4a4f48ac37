// Shared device code of the render (B1) and adjoint (B2) kernels: the
// exact per-pair alpha of tpugs/raster/pallas_tiled.py::_block_weights_full.
#pragma once

#include <cuda_runtime.h>

namespace tpugs {

constexpr int kBlock = 128;     // Gaussians per block of a tile's span
constexpr int kPackCols = 16;   // floats per packed intersection row
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.999f;

// Geometry of one block in shared memory, one array per parameter so the
// per-Gaussian reads of a warp are broadcasts.
struct BlockGeom {
  float mx[kBlock], my[kBlock], ca[kBlock], cb[kBlock], cc[kBlock], op[kBlock];
};

// Loads rows [row0, row0 + kBlock) of the (T, 16) pack; threads
// 0..kBlock-1 take one row each.
__device__ __forceinline__ void load_geom(BlockGeom& g, const float* pack,
                                          long long row0, int tid) {
  if (tid < kBlock) {
    const float4 a = *reinterpret_cast<const float4*>(pack + (row0 + tid) * kPackCols);
    const float2 b = *reinterpret_cast<const float2*>(pack + (row0 + tid) * kPackCols + 4);
    g.mx[tid] = a.x; g.my[tid] = a.y; g.ca[tid] = a.z; g.cb[tid] = a.w;
    g.cc[tid] = b.x; g.op[tid] = b.y;
  }
}

// alpha of Gaussian i of the block at pixel centre (px, py); 0 past the
// span (``valid`` false), below 1/255, or for sigma < 0 (and NaN).
// The 1/255 clip is a step: a one-ulp change of sigma near it moves a
// pixel by (1/255)*T. So sigma and alpha use the _rn intrinsics, which
// nvcc never contracts into FMAs, in the plain version's operation order;
// the clip then decides exactly as the plain PyTorch version does.
__device__ __forceinline__ float pair_alpha(const BlockGeom& g, int i, float px,
                                            float py, bool valid) {
  const float dx = __fsub_rn(px, g.mx[i]);
  const float dy = __fsub_rn(py, g.my[i]);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(g.ca[i], dx), dx),
                               __fmul_rn(__fmul_rn(g.cc[i], dy), dy));
  const float sigma = __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(g.cb[i], dx), dy));
  const float alpha = fminf(__fmul_rn(g.op[i], expf(-fmaxf(sigma, 0.0f))), kAlphaMax);
  return (valid && sigma >= 0.0f && alpha >= kAlphaMin) ? alpha : 0.0f;
}

}  // namespace tpugs
