// B1 — tile render. Replaces tpugs/raster/pallas_tiled.py::render_pallas_raw
// (kernel _make_render_kernel, exact weights of _block_weights_full).
//
// Per tile: front-to-back alpha compositing over the tile's depth-sorted
// span in 128-Gaussian blocks, writing [r, g, b, depth, 1 - T] per pixel,
// with the reference's block-granular, tile-wide early exit (stop before a
// block once max over the tile's ts*ts pixels of T <= trans_eps).
//
// Bound on an H100: operations. Each (pixel, Gaussian) pair with a nonzero
// alpha costs about 30 f32 operations including one exp; the bytes are one
// 64-byte pack row per walked intersection and 20 bytes out per pixel.
//
// Design. The one-CTA-per-tile kernel of commit 55f8844 (1024 threads, one
// per pixel, every thread evaluating all 128 pairs of every walked block)
// lost its time in two ways: the few tiles on the scene's silhouette that
// walk 8-14 blocks ran their walk serially on one SM while the rest of the
// card idled, and two thirds of the pairs it evaluated cannot reach the
// 1/255 clip anywhere near the pixel. Here:
//   * a tile is a thread-block cluster of C CTAs of 256 threads (4 at tile
//     32, 1 at tile 16; render_cluster in raster/kernels.py, checked here),
//     warp w of rank r taking the tile's warp rectangle 8r + w (row-major,
//     so rank r owns pixel rows [r * 256 / ts, (r + 1) * 256 / ts) at tiles
//     16 and 32), one thread per pixel, so a heavy tile's walk runs on C
//     SMs; each rank stages the block's 128 pack rows
//     (geometry and colour, 48 bytes each, three 16-byte cp.async) itself,
//     one block ahead, double-buffered;
//   * a warp covers an 8 x 4 pixel rectangle (the output stays row-major in
//     the tile). After the block has landed, lane l tests Gaussians l,
//     l + 32, l + 64, l + 96 against the warp's rectangle (rect_dead below:
//     the plan's sub-cutoff test on the rectangle of pixel centres, with a
//     margin for f32 rounding) and four __ballot_sync build a 128-bit live
//     mask; the warp then walks only the set bits, in increasing order,
//     with no divergence. A culled pair has alpha 0 at every pixel of the
//     warp, and skipping it is exact for finite colours (texc * (1 - 0) and
//     acc + 0 * col leave every bit as it was), so the image, T and the
//     tile-wide exit are bit-equal to the unculled walk;
//   * each pixel keeps the 55f8844 kernel's arithmetic in its order:
//     pair_alpha's _rn intrinsics, w = alpha * texc * T, the sequential
//     texc and T products, so the image and blocks_done are bit-equal to it;
//   * the tile-wide exit: each rank ORs T > eps over its pixels (those
//     outside the image too) and stores a mark for the block into every
//     rank's slot through DSMEM before it arrives at a cluster barrier (B4's
//     exchange); it waits for that barrier only after the next block has
//     landed and its masks are built, so the exchange runs under them;
//   * at most 40 registers, six CTAs per SM.
// The instantiation without the cull walks all 128 Gaussians of a block,
// as the old kernel did; it exists for the checks that hold the two
// bit-equal.
//
// Other tiles (kGhost): ceil(ts / 8) x ceil(ts / 4) warp rectangles cover
// the tile, row-major, 8 to a CTA. A pixel slot outside the tile's ts x ts
// (in a rectangle that reaches past the tile, or in a warp past the last
// rectangle) is a ghost: its T starts at 0, so it weighs nothing and votes
// for the exit, and it writes nothing; a warp without a rectangle walks no
// pair. The cull tests a rectangle that reaches past the tile on all its 32
// centres, which only culls less. At tiles 16 and 32 the rectangles fill the
// CTAs, and kGhost is false. Up to 8 CTAs (tiles up to 40) a tile is one
// cluster, as above. Past that its CTAs form G pixel groups of C CTAs
// (render_cluster in raster/kernels.py: G = ceil(CTAs / 8), C = ceil(CTAs /
// G)), one cluster each (group blockIdx.y), and the tile-wide exit becomes
// an exact vote over the groups in two launches:
//   * the vote (kVote): every group walks its pixels' T alone, with this
//     kernel's instructions and cull and without the colours, to its own
//     exit, and atomicMax-es the blocks it walked into blocks_done[tile]
//     (zeroed first). A pixel's T never grows from block to block, so
//     neither does a group's largest T: the tile's largest T first falls to
//     trans_eps at the block where the last group's does, the largest of
//     the groups' exit blocks, which is the one-cluster walk's blocks_done;
//   * the walk (replay): every group walks exactly blocks_done[tile] blocks
//     with no exit test and no exchange (its pixels need nothing of the
//     other groups'), writing the image.
// The vote replays its group's walk a second time; resuming from it is a
// later speed item.

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "common.cuh"

namespace tpugs {

constexpr int kThreads = 256;           // threads of a CTA, one per pixel
constexpr int kRectW = 8, kRectH = 4;   // a warp's pixel rectangle
constexpr int kRowVecs = 3;             // float4s of a staged pack row
constexpr int kIlp = 4;                 // live pairs whose alphas are evaluated together
constexpr int kMaxCluster = 8;          // CTAs of a cluster (the portable limit)
constexpr float kCullSlack = 1e-3f;     // the plan's slack on sig_cut
// Relative margin of the cull against f32 rounding: the kernel's sigma and
// the test's minimum each err by a few units in the last place (2^-24) of
// the sum of the quadratic's term magnitudes; 1e-4 of it is ~1700 units.
constexpr float kCullMargin = 1e-4f;

namespace {

// A staged pack row: [mx, my, ca, cb], [cc, op, depth, 0], [c0, c1, c2, depth].
struct StagedRow {
  float4 v[kRowVecs];
};

// Rows [row0, row0 + kBlock) of the pack into ``dst`` by 16-byte cp.async.
__device__ __forceinline__ void stage_rows(StagedRow* dst, const float* pack, long long row0,
                                           int tid) {
  for (int k = tid; k < kBlock * kRowVecs; k += kThreads) {
    const int r = k / kRowVecs, v = k % kRowVecs;
    cp_async16(&dst[r].v[v], pack + (row0 + r) * kPackCols + 4 * v);
  }
}

// A row's constants of the cull, computed once per CTA and block: 1 / a,
// 1 / c and sig_cut = ln(max(255 op, 1)) + the plan's 1e-3 slack
// (raster/plan.py, step 3), or +inf, which culls nothing, for a conic that
// is not positive definite or a NaN or negative opacity (fmaxf would read a
// NaN opacity as 1/255).
__device__ __forceinline__ float4 cull_consts(const StagedRow& row) {
  const float ca = row.v[0].z, cb = row.v[0].w, cc = row.v[1].x, op = row.v[1].y;
  const bool ok =
      ca > 0.0f && cc > 0.0f && __fmul_rn(ca, cc) > __fmul_rn(cb, cb) && op >= 0.0f;
  const float cut =
      ok ? __fadd_rn(logf(fmaxf(__fmul_rn(255.0f, op), 1.0f)), kCullSlack) : INFINITY;
  return make_float4(__frcp_rn(fmaxf(ca, 1e-12f)), __frcp_rn(fmaxf(cc, 1e-12f)), cut, 0.0f);
}

// The conic quadratic's minimum along an edge at fixed offset ``e`` (its
// coefficient ``ce``): the other offset at its stationary point (its
// coefficient ``co``, ``inv_co`` = 1 / co) clamped to [lo, hi]; as
// raster/plan.py's edge_x / edge_y.
__device__ __forceinline__ float edge_min(float e, float lo, float hi, float ce, float co,
                                          float inv_co, float cb) {
  const float cbe = __fmul_rn(cb, e);
  const float t = fminf(fmaxf(__fmul_rn(-cbe, inv_co), lo), hi);
  return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(0.5f, ce), e), e),
                             __fmul_rn(__fmul_rn(__fmul_rn(0.5f, co), t), t)),
                   __fmul_rn(cbe, t));
}

// True when no pixel centre of the warp's rectangle, [x0, x0 + kRectW - 1]
// x [y0, y0 + kRectH - 1], can give the Gaussian an alpha of 1/255: the
// minimum of sigma over the rectangle (the edge minima, and 0 if the centre
// lies inside), less kCullMargin times the sum of the quadratic's term
// magnitudes there, exceeds the row's sig_cut. A value that is not finite
// culls nothing (fminf and fmaxf skip NaN, and the margin is then infinite
// or NaN). The same f32 operations as raster/kernels.py::rect_live but
// logf.
__device__ __forceinline__ bool rect_dead(const StagedRow& row, const float4& cst, float x0,
                                          float y0) {
  const float x1 = x0 + (kRectW - 1), y1 = y0 + (kRectH - 1);
  const float mx = row.v[0].x, my = row.v[0].y, ca = row.v[0].z, cb = row.v[0].w;
  const float cc = row.v[1].x;
  const float lx = __fsub_rn(x0, mx), ux = __fsub_rn(x1, mx);
  const float ly = __fsub_rn(y0, my), uy = __fsub_rn(y1, my);
  float qmin = fminf(fminf(edge_min(lx, ly, uy, ca, cc, cst.y, cb),
                           edge_min(ux, ly, uy, ca, cc, cst.y, cb)),
                     fminf(edge_min(ly, lx, ux, cc, ca, cst.x, cb),
                           edge_min(uy, lx, ux, cc, ca, cst.x, cb)));
  if (lx <= 0.0f && ux >= 0.0f && ly <= 0.0f && uy >= 0.0f) qmin = fminf(qmin, 0.0f);
  const float ex = fmaxf(fabsf(lx), fabsf(ux)), ey = fmaxf(fabsf(ly), fabsf(uy));
  const float terms = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(0.5f, ca), ex), ex),
                                          __fmul_rn(__fmul_rn(__fmul_rn(0.5f, cc), ey), ey)),
                                __fmul_rn(__fmul_rn(fabsf(cb), ex), ey));
  return __fsub_rn(qmin, __fmul_rn(kCullMargin, terms)) > cst.z;
}

// Grid (C * n_tiles, G) in clusters of (C, 1, 1): blockIdx.y is the pixel
// group (G > 1 only with kGhost). With kGhost, ``replay`` walks exactly
// blocks_done[tile] blocks with no exit test and writes no blocks_done.
template <bool kCull, bool kGhost = false, bool kVote = false>
__global__ void __launch_bounds__(kThreads, 6)
render_kernel(const float* __restrict__ pack, const int* __restrict__ tile_starts,
              const int* __restrict__ tile_ends, const int* __restrict__ padded_starts,
              float* __restrict__ out, int* __restrict__ blocks_done, int ntx, int ts,
              float trans_eps, int C, int replay) {
  __shared__ __align__(16) StagedRow rows[2][kBlock];
  __shared__ float4 cst[kBlock];  // the block's cull_consts
  __shared__ int exit_mark[2];  // block b's mark, b + 1, in slot b % 2

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rank = C > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int tile = blockIdx.x / C;
  const int count = tile_ends[tile] - tile_starts[tile];
  const int nb = (count + kBlock - 1) / kBlock;
  const long long pstart = padded_starts[tile];
  const bool fixed = kGhost && replay;  // walk blocks_done[tile] blocks, no exit test
  const bool exchange = C > 1 && !fixed;  // the cluster-wide exit exchange
  const int nb_walk = fixed ? min(nb, blocks_done[tile]) : nb;
  // The warp's rectangle and the thread's pixel (lx, ly) in the tile.
  int rx, ry;
  bool rect = true;  // the warp has a rectangle
  if constexpr (kGhost) {
    const int rects_x = (ts + kRectW - 1) / kRectW;
    const int r = (static_cast<int>(blockIdx.y) * C + rank) * (kThreads / 32) + warp;
    rx = (r % rects_x) * kRectW;
    ry = (r / rects_x) * kRectH;
    rect = r < rects_x * ((ts + kRectH - 1) / kRectH);
  } else {
    const int rects_x = ts / kRectW;
    rx = (warp % rects_x) * kRectW;
    ry = rank * (kThreads / ts) + (warp / rects_x) * kRectH;
  }
  const int lx = rx + lane % kRectW, ly = ry + lane / kRectW;
  const bool real = !kGhost || (rect && lx < ts && ly < ts);  // not a ghost
  const float x0 = static_cast<float>((tile % ntx) * ts + rx) + 0.5f;
  const float y0 = static_cast<float>((tile / ntx) * ts + ry) + 0.5f;
  const float px = x0 + static_cast<float>(lane % kRectW);
  const float py = y0 + static_cast<float>(lane / kRectW);

  if (tid < 2) exit_mark[tid] = 0;
  if (nb_walk > 0) stage_rows(rows[0], pack, pstart, tid);
  cp_async_commit();
  if (exchange) cluster_arrive();  // every CTA has started and set its marks

  float trans = real ? 1.0f : 0.0f;
  float img[4] = {0.f, 0.f, 0.f, 0.f};
  bool keep = 1.0f > trans_eps;
  bool pending = exchange;  // a cluster barrier phase arrived at and not yet waited for
  int b = 0;
  while (keep && b < nb_walk) {
    cp_async_wait_all();
    __syncthreads();  // block b has landed; block b - 1's reads have ended
    if (b + 1 < nb_walk) stage_rows(rows[(b + 1) & 1], pack, pstart + (b + 1) * kBlock, tid);
    cp_async_commit();
    const StagedRow* r = rows[b & 1];
    const int remaining = count - b * kBlock;
    unsigned live[4] = {~0u, ~0u, ~0u, ~0u};
    if (kCull) {
      if (tid < kBlock) cst[tid] = cull_consts(r[tid]);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 32 * k + lane;
        live[k] = __ballot_sync(~0u, j < remaining && !rect_dead(r[j], cst[j], x0, y0));
      }
    }
    if (kGhost && !rect) live[0] = live[1] = live[2] = live[3] = 0u;  // the whole warp
    // Block b - 1's exit marks were in flight while block b landed and its
    // masks were built: wait for them only now (b == 0: for the start).
    if (exchange) {
      cluster_wait();
      pending = false;
      if (b > 0 && exit_mark[(b - 1) & 1] != b) break;
    }
    // The live pairs in increasing order, kIlp at a time: their alphas are
    // independent, and only the compositing after them is sequential.
    float texc = 1.0f;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      for (unsigned m = live[k]; m != 0;) {
        int idx[kIlp];
        float alpha[kIlp];
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          idx[u] = m != 0 ? 32 * k + __ffs(m) - 1 : -1;
          m &= m - 1;
        }
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          const int i = idx[u] < 0 ? idx[0] : idx[u];
          const float4 g0 = r[i].v[0], g1 = r[i].v[1];
          alpha[u] = clipped_alpha(pair_terms(g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, px, py),
                                   kCull || i < remaining);  // a live bit is inside the span
        }
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          if (idx[u] < 0) break;  // the same for the whole warp
          if constexpr (!kVote) {
            const float4 c = r[idx[u]].v[2];
            const float w = alpha[u] * texc * trans;
            acc[0] += w * c.x;
            acc[1] += w * c.y;
            acc[2] += w * c.z;
            acc[3] += w * c.w;
          }
          texc *= 1.0f - alpha[u];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) img[c] += acc[c];
    trans *= texc;
    const int any = __syncthreads_or(trans > trans_eps);
    ++b;
    if (exchange) {
      if (any && tid < C) st_cluster(map_rank(smem_addr(&exit_mark[(b - 1) & 1]), tid), b);
      cluster_arrive();
      pending = true;
    } else if (!fixed) {
      keep = any;
    }
  }
  if (pending) cluster_wait();  // no rank writes to this CTA's marks after this
  cp_async_wait_all();  // a block staged past the exit lands before the CTA ends

  if (!kVote && real) {
    float* o = out + (static_cast<long long>(tile) * ts * ts + ly * ts + lx) * 5;
    o[0] = img[0]; o[1] = img[1]; o[2] = img[2]; o[3] = img[3];
    o[4] = 1.0f - trans;
  }
  if (rank == 0 && tid == 0) {
    if constexpr (kVote)
      atomicMax(&blocks_done[tile], b);  // this group's exit block
    else if (!fixed)
      blocks_done[tile] = b;
  }
}

cudaLaunchConfig_t render_config(int n_tiles, int C, int G, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * n_tiles, G, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// (C, G) at tile ts, as raster/kernels.py::render_cluster gives them: the
// tile's warp rectangles at 8 a CTA, one cluster of at most 8 CTAs, or G
// pixel groups of C.
int2 render_layout(int ts) {
  const int rects = ((ts + kRectW - 1) / kRectW) * ((ts + kRectH - 1) / kRectH);
  return group_layout((rects + kThreads / 32 - 1) / (kThreads / 32), kMaxCluster);
}

template <bool kCull, bool kGhost, bool kVote>
cudaError_t run_as(const float* pack, const int* tile_starts, const int* tile_ends,
                   const int* padded_starts, float* out, int* blocks_done, int n_tiles, int ntx,
                   int ts, float trans_eps, int C, int G, int replay, cudaStream_t stream,
                   int* resident) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      render_config(n_tiles > 0 ? n_tiles : 1, C, n_tiles > 0 ? G : 1, stream, attr);
  if (n_tiles == 0)
    return cudaOccupancyMaxActiveClusters(resident, render_kernel<kCull, kGhost, kVote>, &cfg);
  cudaError_t e = cudaLaunchKernelEx(&cfg, render_kernel<kCull, kGhost, kVote>, pack,
                                     tile_starts, tile_ends, padded_starts, out, blocks_done,
                                     ntx, ts, trans_eps, C, replay);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Launches (n_tiles > 0) or, with n_tiles == 0, returns the resident
// clusters in *resident. (C, G) must be render_layout(ts); ``pass`` 0 is
// the one-cluster walk (G = 1), 1 the vote and 2 the walk after it (G > 1).
template <bool kCull>
cudaError_t run(const float* pack, const int* tile_starts, const int* tile_ends,
                const int* padded_starts, float* out, int* blocks_done,
                int n_tiles, int ntx, int ts, float trans_eps, int C, int G, int pass,
                cudaStream_t stream, int* resident) {
  if (ts < 1) return cudaErrorInvalidValue;
  const int2 want = render_layout(ts);
  if (C != want.x || G != want.y || (G == 1) != (pass == 0) || pass < 0 || pass > 2)
    return cudaErrorInvalidValue;
  if (pass == 1)
    return run_as<kCull, true, true>(pack, tile_starts, tile_ends, padded_starts, out,
                                     blocks_done, n_tiles, ntx, ts, trans_eps, C, G, 0, stream,
                                     resident);
  return C * kThreads == ts * ts && G == 1
             ? run_as<kCull, false, false>(pack, tile_starts, tile_ends, padded_starts, out,
                                           blocks_done, n_tiles, ntx, ts, trans_eps, C, 1, 0,
                                           stream, resident)
             : run_as<kCull, true, false>(pack, tile_starts, tile_ends, padded_starts, out,
                                          blocks_done, n_tiles, ntx, ts, trans_eps, C, G,
                                          pass == 2, stream, resident);
}

}  // namespace
}  // namespace tpugs

// ``cull`` 0 walks every Gaussian of a block; ``pass`` as in run.
extern "C" int tpugs_render(const float* pack, const int* tile_starts, const int* tile_ends,
                            const int* padded_starts, float* out, int* blocks_done, int n_tiles,
                            int ntx, int ts, float trans_eps, int cull, int C, int G, int pass,
                            cudaStream_t stream) {
  if (n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      cull ? tpugs::run<true>(pack, tile_starts, tile_ends, padded_starts, out, blocks_done,
                              n_tiles, ntx, ts, trans_eps, C, G, pass, stream, nullptr)
           : tpugs::run<false>(pack, tile_starts, tile_ends, padded_starts, out, blocks_done,
                               n_tiles, ntx, ts, trans_eps, C, G, pass, stream, nullptr);
  return static_cast<int>(e);
}

// Resident clusters of the render kernel's walk at tile ts, or minus a CUDA
// error.
extern "C" int tpugs_render_max_clusters(int ts, int cull) {
  if (ts < 1) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const int2 l = tpugs::render_layout(ts);
  const int pass = l.y == 1 ? 0 : 2;
  const cudaError_t e =
      cull ? tpugs::run<true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 1, ts,
                              0.0f, l.x, l.y, pass, nullptr, &n)
           : tpugs::run<false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 1, ts,
                               0.0f, l.x, l.y, pass, nullptr, &n);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
