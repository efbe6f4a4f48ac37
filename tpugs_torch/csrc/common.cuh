// Shared device code of the render (B1), adjoint (B2) and train (B4, B5)
// kernels: the exact per-pair alpha of
// tpugs/raster/pallas_tiled.py::_block_weights_full.
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

// Loads rows [row0, row0 + kBlock) of a (T, cols) pack whose first six
// columns are the geometry (cols 16 for B2, 8 for B4/B5); threads
// 0..kBlock-1 take one row each.
__device__ __forceinline__ void load_geom(BlockGeom& g, const float* pack,
                                          long long row0, int tid, int cols = kPackCols) {
  if (tid < kBlock) {
    const float4 a = *reinterpret_cast<const float4*>(pack + (row0 + tid) * cols);
    const float2 b = *reinterpret_cast<const float2*>(pack + (row0 + tid) * cols + 4);
    g.mx[tid] = a.x; g.my[tid] = a.y; g.ca[tid] = a.z; g.cb[tid] = a.w;
    g.cc[tid] = b.x; g.op[tid] = b.y;
  }
}

// The terms of Gaussian i of the block at pixel centre (px, py):
// offsets, sigma, e = exp(-max(sigma, 0)) and alpha_raw = op * e.
// The 1/255 clip is a step: a one-ulp change of sigma near it moves a
// pixel by (1/255)*T. So sigma and alpha use the _rn intrinsics, which
// nvcc never contracts into FMAs, in the plain version's operation order;
// the clip then decides exactly as the plain PyTorch version does.
struct PairTerms {
  float dx, dy, sigma, e, alpha_raw;
};

__device__ __forceinline__ PairTerms pair_terms(float mx, float my, float ca, float cb,
                                                float cc, float op, float px, float py) {
  PairTerms t;
  t.dx = __fsub_rn(px, mx);
  t.dy = __fsub_rn(py, my);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, t.dx), t.dx),
                               __fmul_rn(__fmul_rn(cc, t.dy), t.dy));
  t.sigma = __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(cb, t.dx), t.dy));
  t.e = expf(-fmaxf(t.sigma, 0.0f));
  t.alpha_raw = __fmul_rn(op, t.e);
  return t;
}

__device__ __forceinline__ PairTerms pair_terms(const BlockGeom& g, int i, float px,
                                                float py) {
  return pair_terms(g.mx[i], g.my[i], g.ca[i], g.cb[i], g.cc[i], g.op[i], px, py);
}

// alpha of those terms; 0 past the span (``valid`` false), below 1/255, or
// for sigma < 0 (and NaN).
__device__ __forceinline__ float clipped_alpha(const PairTerms& t, bool valid) {
  const float alpha = fminf(t.alpha_raw, kAlphaMax);
  return (valid && t.sigma >= 0.0f && alpha >= kAlphaMin) ? alpha : 0.0f;
}

__device__ __forceinline__ float pair_alpha(const BlockGeom& g, int i, float px,
                                            float py, bool valid) {
  return clipped_alpha(pair_terms(g, i, px, py), valid);
}

// A tile's ``units`` ranks (CTAs) as one cluster of at most
// ``max_cluster``, or past it as G = ceil(units / max_cluster) pixel groups
// of C = ceil(units / G) ranks each: (C, G). The layouts of B1, B4 and B5
// (render.cu, train_fwd.cu, train_bwd.cu) all take it, as their Python
// twins in raster/kernels.py and raster/train.py do.
inline int2 group_layout(int units, int max_cluster) {
  const int G = (units + max_cluster - 1) / max_cluster;
  return make_int2((units + G - 1) / G, G);
}

}  // namespace tpugs
