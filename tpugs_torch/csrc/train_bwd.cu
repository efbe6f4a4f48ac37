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
// past blocks_done are zero (B3 reads every position). No atomics: the
// same rows on every run.
//
// Bound on an H100: operations. Per walked (pixel, Gaussian) pair ~30
// operations for the blend state, and per pair with a nonzero alpha 2D
// f32 multiply-adds (u and d col) and ~30 for the adjoint; the bytes are
// the packs and g once, and one row per intersection out: 2.538 ms at the
// garden train step (67 TFLOP/s f32; chip_smoke.py). Not TF32 (gradients
// are held at 3e-4 of their max).
//
// Design (D <= 256: the cluster kernel). The TPU kernel keeps a tile's
// whole g in VMEM (536 KB at D = 131); a Hopper CTA has 227 KB, and the
// one-CTA kernel below restaged g in 32-channel slices eight times per
// walked block (about 38 GB from L2 per step), which cost 47% of its time
// (experiments/train_bwd_phases.py). So a tile is a thread-block cluster
// of C = ts^2 / 128 CTAs (8 at tile 32, 2 at tile 16; train_cluster in
// raster/train.py, which the C side checks) of 256 threads. Rank r owns
// 128 pixels, 4 or 8 whole pixel rows of the tile, in 8 x 4 patches of 32,
// for every block; it loads their g once per tile (68 KB at D = 131) and
// keeps it. Threads 0-127 (warps 0-3) carry one pixel's T, texc, prefix
// and grem in registers: no state crosses ranks, and B4's blocks_done
// fixes the walk. Per 32-Gaussian sub-block:
//   (1) u (128 x 32) = G Ct^T from shared memory, a 4 x 4 register tile
//       per thread (8 float4 loads per 64 FMAs); the colours Ct (32 x D)
//       come in by cp.async, issued a sub-block ahead;
//   (2) warps 0-3 walk: the one-CTA kernel's instructions in its order (u
//       is summed over the channels in order too, so each pair's values
//       are that kernel's); the 8 geometry terms of each 4 Gaussians are
//       summed over the warp by one 31-shuffle reduce-scatter, skipped
//       where no lane has a nonzero d alpha;
//   (3) the partial d col (32 x D) = W^T G: warp w takes 8 Gaussians over
//       half the pixels, lane l the columns l + 32j (8 x ceil(D/32)
//       accumulators, the count a template argument); the halves are
//       added and written with the geometry partials (the 4 walking warps
//       in order) into Dpart, laid out as the 32 rows themselves;
//   (4) after a cluster barrier, rank q sums its 1/C of the rows' 16-byte
//       vectors over the C ranks' Dpart, in rank order 0..C-1, by DSMEM
//       loads, and stores them; an arrive here and a wait before the next
//       Dpart write let the next sub-block start before the others finish.
// Shared memory per CTA: g, max(Ct, u/w), Dpart and the walking warps'
// geometry sums, 111,104 bytes with the block's geometry at D = 131, so
// two CTAs fit on an SM (the phases tool: one CTA per SM costs 12 ms
// more); 207,360 at D = 256. Zero rows and the row epilogue store 16
// bytes per thread.
//
// Measured at the garden train step (f32 rows, NVIDIA H100 80GB HBM3,
// 700.00 W): 26.5 ms in chip_smoke.py, against 68.9 for the one-CTA kernel
// (PERF.md); experiments/train_bwd_phases.py in one call: 27.0 ms against
// 70.2. Of it: the u product 7.1 ms, the d col product 6.9, the geometry
// sums 4.3, the walk 2.3, the colour staging 1.0, the DSMEM sums 0.5. The
// products run at about half the f32 FMA rate, the walk on half the warps.
//
// Widths D > 256 (CLUSTER_MAX_CHANNELS) take the one-CTA kernel below
// (tpugs_train_bwd_wide_*), chosen by width alone: there g and the
// partials of a cluster of 8 no longer fit one CTA's shared memory.
//
// The geometry-only instantiation of the one-CTA kernel
// (tpugs_train_bwd_geom_f32) writes rows of the 8 geometry columns alone
// and drops the colour gradients (Dcol, its zeroing and step (4)). Its
// shared memory no longer grows with D, so it takes any D >= 1: the u
// product still reads every colour column and every channel of g, in
// kDK-channel slices. A render wider than the colour kernels' 512
// channels runs in channel chunks, whose geometry sums add; the absgrad
// columns |dmx| |dmy| are absolute values of per-pixel sums over all
// channels and do not, so they come from one such launch over all D.
// Bound: walked pairs * 30 + nonzero-alpha pairs * (2D + 30) f32
// operations, against the colour rows and g read once per walked block and
// the 8-column rows written (chip_smoke.py, phase 5).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "common.cuh"

namespace tpugs {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kGeomCols = 8;
constexpr int kGeomGrads = 8;
constexpr int kSub = 32;  // Gaussians per sub-block

__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(bf16* o, float v) { *o = __float2bfloat16_rn(v); }

// ------------------------------------------------------- the cluster kernel

constexpr int kPix = 128;             // pixels per rank; PIXELS_PER_RANK in raster/train.py
constexpr int kCThreads = 2 * kPix;   // the walk takes warps 0-3, one thread per pixel
constexpr int kWalkWarps = kPix / 32;
constexpr int kMaxClusterD = 256;     // CLUSTER_MAX_CHANNELS in raster/train.py
constexpr int kMaxCluster = 8;        // portable cluster size: ts = 32 gives C = 8
constexpr int kLdU = kSub + 4;        // Us/Ws[pixel][gaussian]
static_assert(kWalkWarps * 8 == kSub, "d col: warp w takes Gaussians 8 (w % 4) + 0..7");

// Shared memory of one rank, in floats. g is [kPix][ldg] with ldg / 4 odd,
// so 8 pixels' float4s at one channel fall in 8 distinct bank groups; the
// colour rows Ct[kSub][ldg] share region X with u and then w
// (Us/Ws[kPix][kLdU]); Dpart[kSub][RW] is this rank's partial of the
// sub-block's 32 rows, laid out as the rows themselves; GeoW[warp][kSub][8]
// the geometry sums of each walking warp's 32 pixels.
struct ClusterLayout {
  int D4, ldg, RW;
  __host__ __device__ ClusterLayout(int D, int row_width) : RW(row_width) {
    D4 = (D + 3) / 4 * 4;
    ldg = (D4 / 4) % 2 ? D4 : D4 + 4;
  }
  __host__ __device__ int x() const { return kPix * ldg; }
  __host__ __device__ int x_size() const {
    return kSub * ldg > kPix * kLdU ? kSub * ldg : kPix * kLdU;
  }
  __host__ __device__ int dpart() const { return x() + x_size(); }
  __host__ __device__ int geow() const { return dpart() + kSub * RW; }
  __host__ __device__ size_t bytes() const {
    return size_t(geow() + kWalkWarps * kSub * kGeomGrads) * sizeof(float);
  }
};

// Local pixel l (0..127) of a rank, in its ts x (128 / ts) pixel rows:
// each 32 form an 8 x 4 patch, so a walking warp sees nearby pixels and
// more often finds no nonzero d alpha for a Gaussian.
__device__ __forceinline__ int2 local_xy(int l, int ts) {
  const int w = l >> 5, lane = l & 31, per_row = ts >> 3;
  return make_int2(8 * (w % per_row) + (lane & 7), 4 * (w / per_row) + (lane >> 3));
}

// The sub-block's colour rows cols[row .. row + 32) into Ct (4-byte
// cp.async, one committed group), zeros in columns [D, D4).
__device__ __forceinline__ void stage_colours(float* Ct, const float* __restrict__ cols,
                                              long long row, int D, const ClusterLayout& L,
                                              int tid) {
  const float* src = cols + row * D;
  for (int e = tid; e < kSub * D; e += kCThreads) {
    const int i = e / D;
    cp_async4(Ct + i * L.ldg + e - i * D, src + e);
  }
  const int pad = L.D4 - D;
  for (int e = tid; e < kSub * pad; e += kCThreads) Ct[(e / pad) * L.ldg + D + e % pad] = 0.0f;
  cp_async_commit();
}

// v[0..31] summed over the warp's 32 lanes by a reduce-scatter, 31
// shuffles in 5 levels (16 independent ones in the first): lane l returns
// the sum of v[l]. A fixed tree: the same sums on every run.
template <int H>
__device__ __forceinline__ void reduce_scatter_level(float (&v)[32], int lane) {
  const bool hi = lane & H;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float keep = hi ? v[j + H] : v[j];
    const float give = hi ? v[j] : v[j + H];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, give, H);
  }
}
__device__ __forceinline__ float warp_sum32(float (&v)[32], int lane) {
  reduce_scatter_level<16>(v, lane);
  reduce_scatter_level<8>(v, lane);
  reduce_scatter_level<4>(v, lane);
  reduce_scatter_level<2>(v, lane);
  reduce_scatter_level<1>(v, lane);
  return v[0];
}

__device__ __forceinline__ void add4(float4& s, const float4 v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// This rank's share of the sub-block's 32 rows (out points at the first):
// each 16-byte vector of output is the sum of the C ranks' partials, in
// rank order 0..C-1, read through DSMEM.
__device__ __forceinline__ void sum_partials(float* __restrict__ out,
                                             const uint32_t (&part)[kMaxCluster], int C,
                                             int rank, int RW, int tid) {
  const int n = kSub * RW / 4;
  const int per = (n + C - 1) / C;
  const int end = min(n, (rank + 1) * per);
  for (int v = rank * per + tid; v < end; v += kCThreads) {
    float4 s = ld_cluster_f4(part[0] + 16u * v);
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < C) add4(s, ld_cluster_f4(part[r] + 16u * v));
    *reinterpret_cast<float4*>(out + 4 * v) = s;
  }
}
__device__ __forceinline__ void sum_partials(bf16* __restrict__ out,
                                             const uint32_t (&part)[kMaxCluster], int C,
                                             int rank, int RW, int tid) {
  const int n = kSub * RW / 8;
  const int per = (n + C - 1) / C;
  const int end = min(n, (rank + 1) * per);
  for (int v = rank * per + tid; v < end; v += kCThreads) {
    float4 s = ld_cluster_f4(part[0] + 32u * v);
    float4 t = ld_cluster_f4(part[0] + 32u * v + 16u);
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r) {
      if (r < C) {
        add4(s, ld_cluster_f4(part[r] + 32u * v));
        add4(t, ld_cluster_f4(part[r] + 32u * v + 16u));
      }
    }
    const __nv_bfloat162 h[4] = {__floats2bfloat162_rn(s.x, s.y), __floats2bfloat162_rn(s.z, s.w),
                                 __floats2bfloat162_rn(t.x, t.y), __floats2bfloat162_rn(t.z, t.w)};
    *reinterpret_cast<uint4*>(out + 8 * v) = *reinterpret_cast<const uint4*>(h);
  }
}

// (3) The partial d col = W^T G over this rank's pixels, NC = ceil(D / 32):
// warp w takes Gaussians 8 (w % 4) + 0..7 over pixel half w / 4, lane l
// the columns l + 32j; the halves are added, then written with the
// geometry partials (the walking warps in order) into Dpart once every
// rank has read the previous ones.
template <int NC>
__device__ __forceinline__ void partial_rows(const float* X, const float* Gs, float* Dpart,
                                             const float* GeoW, int ldg, int D, int RW,
                                             int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int g0 = 8 * (warp % kWalkWarps);
  const int q0 = (warp / kWalkWarps) * (kPix / 2);
  float acc[8][NC];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[m][j] = 0.0f;
#pragma unroll 2
  for (int q = q0; q < q0 + kPix / 2; ++q) {
    const float4 w0 = *reinterpret_cast<const float4*>(X + q * kLdU + g0);
    const float4 w1 = *reinterpret_cast<const float4*>(X + q * kLdU + g0 + 4);
    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float* gq = Gs + q * ldg + lane;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float gv = gq[32 * j];
#pragma unroll
      for (int m = 0; m < 8; ++m) acc[m][j] = fmaf(wv[m], gv, acc[m][j]);
    }
  }
  cluster_wait();  // every rank has read this rank's previous partials
  const bool second = warp >= kWalkWarps;
  if (second) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < D) {
#pragma unroll
        for (int m = 0; m < 8; ++m) Dpart[(g0 + m) * RW + c] = acc[m][j];
      }
    }
  } else {
    constexpr int kW = kSub * kGeomGrads;  // one walking warp's GeoW
    const int e = tid;                      // 128 threads, 256 sums: two each
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = e + h * kPix;
      Dpart[(f / kGeomGrads) * RW + D + f % kGeomGrads] =
          ((GeoW[f] + GeoW[kW + f]) + GeoW[2 * kW + f]) + GeoW[3 * kW + f];
    }
  }
  __syncthreads();
  if (!second) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < D) {
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          float* o = Dpart + (g0 + m) * RW + c;
          *o = acc[m][j] + *o;
        }
      }
    }
  }
}

// Grid C * n_tiles in clusters of (C, 1, 1): the C CTAs of a cluster take
// one tile, rank r its pixels [r * kPix, (r + 1) * kPix).
template <typename OutT>
__global__ void __launch_bounds__(kCThreads, 2)
train_bwd_cluster_kernel(const float* __restrict__ geom, const float* __restrict__ cols,
                         const float* __restrict__ gimg, const float* __restrict__ hterm,
                         const float* __restrict__ grem0, const int* __restrict__ tile_starts,
                         const int* __restrict__ tile_ends, const int* __restrict__ padded_starts,
                         const int* __restrict__ blocks_done, OutT* __restrict__ out, int ntx,
                         int ts, int width, int height, int D, int RW, int C) {
  extern __shared__ __align__(16) float smem[];
  const ClusterLayout L(D, RW);
  float* Gs = smem;                 // [kPix][ldg]: this rank's g, for the whole tile
  float* X = smem + L.x();          // Ct[kSub][ldg], then Us/Ws[kPix][kLdU]
  float* Dpart = smem + L.dpart();  // [kSub][RW]
  float* GeoW = smem + L.geow();    // [kWalkWarps][kSub][kGeomGrads]
  __shared__ BlockGeom g;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rank = static_cast<int>(cluster_rank());
  const int tile = blockIdx.x / C;
  const int ldg = L.ldg, D4 = L.D4;
  const int count = tile_ends[tile] - tile_starts[tile];
  const int nb = (count + kBlock - 1) / kBlock;
  const int nb_done = min(blocks_done[tile], nb);
  const long long pstart = padded_starts[tile];
  const int x0 = (tile % ntx) * ts;
  const int y0 = (tile / ntx) * ts;
  uint32_t part[kMaxCluster];  // every rank's Dpart, as DSMEM addresses
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) part[r] = map_rank(smem_addr(Dpart), r < C ? r : 0);

  const int rank_y = y0 + rank * (kPix / ts);  // the rank's first pixel row

  // this thread's pixel (threads of the walk) and its carried state
  const int2 lp = local_xy(tid, ts);
  const int xi = x0 + lp.x;
  const int yi = rank_y + lp.y;
  const bool in_img = tid < kPix && xi < width && yi < height;
  const float px = static_cast<float>(xi) + 0.5f;
  const float py = static_cast<float>(yi) + 0.5f;
  const long long pix = static_cast<long long>(yi) * width + xi;
  const float h = in_img ? hterm[pix] : 0.0f;
  float grem = in_img ? grem0[pix] : 0.0f;
  float trans = 1.0f;

  // this rank's g, once per tile: 0 outside the image and in columns [D, D4)
  for (int idx = tid; idx < kPix * D4; idx += kCThreads) {
    const int pl = idx / D4;
    const int c = idx - pl * D4;
    const int2 l = local_xy(pl, ts);
    const int x = x0 + l.x;
    const int y = rank_y + l.y;
    float v = 0.0f;
    if (c < D && x < width && y < height) v = gimg[(static_cast<long long>(y) * width + x) * D + c];
    Gs[pl * ldg + c] = v;
  }
  // row columns past the geometry sums: 0 in every partial
  const int n_pad = RW - D - kGeomGrads;
  for (int e = tid; e < kSub * n_pad; e += kCThreads)
    Dpart[(e / n_pad) * RW + D + kGeomGrads + e % n_pad] = 0.0f;
  if (nb_done > 0) stage_colours(X, cols, pstart, D, L, tid);
  cluster_arrive();  // every CTA of the cluster has started
  cluster_wait();
  cluster_arrive();  // Dpart is free (paired with the first sub-block's wait)

  for (int b = 0; b < nb_done; ++b) {
    const long long row0 = pstart + static_cast<long long>(b) * kBlock;
    load_geom(g, geom, row0, tid, kGeomCols);  // the last walk's reads ended at a barrier
    const int remaining = count - b * kBlock;
    float texc = 1.0f, cs = 0.0f;
    for (int s = 0; s < kBlock / kSub; ++s) {
      const int gbase = s * kSub;
      cp_async_wait_all();
      __syncthreads();  // the colours and the block's geometry are in

      // (1) u = G Ct^T: thread (pg, gg) takes pixels pg + 32j, Gaussians gg + 8m;
      // each u is summed over the channels in order, as before
      {
        const int gg = tid & 7, pg = tid >> 3;
        float u[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int m = 0; m < 4; ++m) u[j][m] = 0.0f;
#pragma unroll 1  // unrolled by 2 it ran 2.4% slower, by 4 0.9% (phases tool)
        for (int k = 0; k < D4; k += 4) {
          float4 gv[4], cv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            gv[j] = *reinterpret_cast<const float4*>(Gs + (pg + 32 * j) * ldg + k);
#pragma unroll
          for (int m = 0; m < 4; ++m)
            cv[m] = *reinterpret_cast<const float4*>(X + (gg + 8 * m) * ldg + k);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              float a = fmaf(gv[j].x, cv[m].x, u[j][m]);
              a = fmaf(gv[j].y, cv[m].y, a);
              a = fmaf(gv[j].z, cv[m].z, a);
              u[j][m] = fmaf(gv[j].w, cv[m].w, a);
            }
        }
        __syncthreads();  // every read of the colours is done
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int m = 0; m < 4; ++m) X[(pg + 32 * j) * kLdU + gg + 8 * m] = u[j][m];
      }
      __syncthreads();

      // (2) the walk over the sub-block for this thread's pixel; w replaces u
      // in place; the 8 geometry terms of every 4 Gaussians are summed over
      // the warp at once (skipped where no lane has a nonzero d alpha)
      if (tid < kPix) {
        float* row = X + tid * kLdU;
        for (int i4 = 0; i4 < kSub; i4 += 4) {
          const float4 u4 = *reinterpret_cast<const float4*>(row + i4);
          const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
          float ww[4], dsv[4], dopv[4], dxv[4], dyv[4];
          bool any = false;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i4 + e;
            const int gi = gbase + i;
            const PairTerms t = pair_terms(g, gi, px, py);
            const float alpha = clipped_alpha(t, gi < remaining);
            const bool kept = alpha != 0.0f;
            const float w = alpha * texc * trans;
            cs = fmaf(w, uu[e], cs);
            const float v = grem - cs;
            const float d_alpha = texc * trans * uu[e] - (v + h) / fmaxf(1.0f - alpha, 1e-6f);
            const float d_araw = (kept && t.alpha_raw < kAlphaMax) ? d_alpha : 0.0f;
            ww[e] = w;
            texc *= 1.0f - alpha;
            dsv[e] = t.sigma > 0.0f ? -d_araw * g.op[gi] * t.e : 0.0f;
            dopv[e] = d_araw * t.e;
            dxv[e] = t.dx;
            dyv[e] = t.dy;
            any |= d_araw != 0.0f;
          }
          *reinterpret_cast<float4*>(row + i4) = make_float4(ww[0], ww[1], ww[2], ww[3]);
          float sum = 0.0f;  // every term is 0 when no lane has a nonzero d alpha
          if (__any_sync(0xffffffffu, any)) {
            float a[4 * kGeomGrads];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int gi = gbase + i4 + e;
              const float ds = dsv[e], dx = dxv[e], dy = dyv[e];
              const float ca = g.ca[gi], cb = g.cb[gi], cc = g.cc[gi];
              const float dmx = ds * -(ca * dx + cb * dy);
              const float dmy = ds * -(cc * dy + cb * dx);
              a[kGeomGrads * e + 0] = dmx;
              a[kGeomGrads * e + 1] = dmy;
              a[kGeomGrads * e + 2] = ds * (0.5f * dx * dx);
              a[kGeomGrads * e + 3] = ds * (dx * dy);
              a[kGeomGrads * e + 4] = ds * (0.5f * dy * dy);
              a[kGeomGrads * e + 5] = dopv[e];
              a[kGeomGrads * e + 6] = fabsf(dmx);
              a[kGeomGrads * e + 7] = fabsf(dmy);
            }
            sum = warp_sum32(a, lane);
          }
          // lane l holds term l % 8 of Gaussian i4 + l / 8
          GeoW[(warp * kSub + i4) * kGeomGrads + lane] = sum;
        }
      }
      __syncthreads();

      switch ((D + 31) / 32) {  // (3), with ceil(D / 32) columns per lane
        case 1: partial_rows<1>(X, Gs, Dpart, GeoW, ldg, D, RW, tid); break;
        case 2: partial_rows<2>(X, Gs, Dpart, GeoW, ldg, D, RW, tid); break;
        case 3: partial_rows<3>(X, Gs, Dpart, GeoW, ldg, D, RW, tid); break;
        case 4: partial_rows<4>(X, Gs, Dpart, GeoW, ldg, D, RW, tid); break;
        case 5: partial_rows<5>(X, Gs, Dpart, GeoW, ldg, D, RW, tid); break;
        case 6: partial_rows<6>(X, Gs, Dpart, GeoW, ldg, D, RW, tid); break;
        case 7: partial_rows<7>(X, Gs, Dpart, GeoW, ldg, D, RW, tid); break;
        default: partial_rows<8>(X, Gs, Dpart, GeoW, ldg, D, RW, tid); break;
      }
      __syncthreads();  // every read of Ws is done
      if (s + 1 < kBlock / kSub)
        stage_colours(X, cols, row0 + gbase + kSub, D, L, tid);
      else if (b + 1 < nb_done)
        stage_colours(X, cols, row0 + kBlock, D, L, tid);
      cluster_arrive();  // every rank's partials are complete
      cluster_wait();
      // (4) this rank's share of the 32 rows: the C partials summed in rank order
      sum_partials(out + (row0 + gbase) * RW, part, C, rank, RW, tid);
      cluster_arrive();  // this rank has read the others' partials
    }
    trans *= texc;
    grem -= cs;
  }
  // blocks the forward's early exit skipped: zero rows, 16 bytes a store,
  // split over the cluster's ranks (the span is 16-byte aligned)
  constexpr int V = 16 / sizeof(OutT);
  const long long zero0 = (pstart + static_cast<long long>(nb_done) * kBlock) * RW;
  const long long n_vec = static_cast<long long>(nb - nb_done) * kBlock * RW / V;
  for (long long v = rank * kCThreads + tid; v < n_vec; v += C * kCThreads)
    *reinterpret_cast<uint4*>(out + zero0 + v * V) = make_uint4(0, 0, 0, 0);
  cluster_wait();  // no rank leaves while another may still read its partials
}

cudaLaunchConfig_t cluster_config(int n_tiles, int C, size_t bytes, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * n_tiles, 1, 1);
  cfg.blockDim = dim3(kCThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// (C, P) as raster/train.py::train_cluster gives them, or an error.
template <typename OutT>
cudaError_t prepare_cluster(int ts, int D, int RW, int C, int P, size_t* bytes) {
  if (D < 1 || D > kMaxClusterD || RW < D + kGeomGrads || RW % 4 != 0 ||
      (ts != 16 && ts != 32) || P != kPix || C * P != ts * ts || C > kMaxCluster)
    return cudaErrorInvalidValue;
  *bytes = ClusterLayout(D, RW).bytes();
  cudaError_t e = cudaFuncSetAttribute(train_bwd_cluster_kernel<OutT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(*bytes));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(train_bwd_cluster_kernel<OutT>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename OutT>
int launch_cluster(const float* geom, const float* cols, const float* gimg, const float* hterm,
                   const float* grem0, const int* tile_starts, const int* tile_ends,
                   const int* padded_starts, const int* blocks_done, OutT* out, int n_tiles,
                   int ntx, int ts, int width, int height, int D, int RW, int C, int P,
                   cudaStream_t stream) {
  size_t bytes = 0;
  cudaError_t e = prepare_cluster<OutT>(ts, D, RW, C, P, &bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(n_tiles, C, bytes, stream, attr);
  e = cudaLaunchKernelEx(&cfg, train_bwd_cluster_kernel<OutT>, geom, cols, gimg, hterm, grem0,
                         tile_starts, tile_ends, padded_starts, blocks_done, out, ntx, ts,
                         width, height, D, RW, C);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of the cluster kernel at (ts, D) that can be resident at once,
// or minus a CUDA error.
template <typename OutT>
int max_clusters(int ts, int D) {
  const int RW = (D + kGeomGrads + 3) / 4 * 4;
  const int C = ts * ts / kPix;
  size_t bytes = 0;
  cudaError_t e = prepare_cluster<OutT>(ts, D, RW, C, kPix, &bytes);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(1, C, bytes, nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, train_bwd_cluster_kernel<OutT>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// ------------------------------------- the one-CTA kernel (D > kMaxClusterD)

constexpr int kThreads = 256;     // = pixels per chunk
constexpr int kDK = 32;           // channels per staged slice of g
constexpr int kMaxPixels = 1024;
constexpr int kLdG = kDK + 1;     // Gs[pixel][channel]
constexpr int kLdC = kSub + 4;    // Ct[channel][gaussian], 16-byte rows
constexpr int kLdW = kSub + 4;    // Ws[pixel][gaussian], 16-byte rows
constexpr int kLdD = kThreads + 8;  // Dsig/Dop[gaussian][pixel]

constexpr size_t kFixedFloats = size_t(kThreads) * kLdG + size_t(kDK) * kLdC +
                                size_t(kThreads) * kLdW + 2 * size_t(kSub) * kLdD +
                                size_t(kSub) * kGeomGrads + 4 * size_t(kMaxPixels);


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

// kGeomOnly: rows of the kGeomGrads geometry columns alone (RW = kGeomGrads),
// no colour gradients; any D.
template <typename OutT, bool kGeomOnly>
__global__ void __launch_bounds__(kThreads)
train_bwd_wide_kernel(const float* __restrict__ geom, const float* __restrict__ cols,
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
  float* Dcol = Gr + kMaxPixels;          // [kSub][Dpad]; absent with kGeomOnly
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
      if constexpr (!kGeomOnly)
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
        if constexpr (!kGeomOnly) {
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
        const int lead = kGeomOnly ? 0 : D;  // colour columns before the geometry
        float v = 0.0f;
        if (col < lead)
          v = Dcol[i * Dpad + col];
        else if (col < lead + kGeomGrads)
          v = Geo[i * kGeomGrads + col - lead];
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
  constexpr int V = 16 / sizeof(OutT);  // 16-byte stores; the span is 16-byte aligned
  for (long long v = tid; v < n_zero / V; v += kThreads)
    *reinterpret_cast<uint4*>(out + zero0 + v * V) = make_uint4(0, 0, 0, 0);
}

template <typename OutT, bool kGeomOnly = false>
int launch_wide(const float* geom, const float* cols, const float* gimg, const float* hterm,
           const float* grem0, const int* tile_starts, const int* tile_ends,
           const int* padded_starts, const int* blocks_done, OutT* out, int n_tiles, int ntx,
           int ts, int width, int height, int D, int RW, cudaStream_t stream) {
  const int Dpad = (D + kDK - 1) / kDK * kDK;
  const bool rw_ok = kGeomOnly ? RW == kGeomGrads : RW >= D + kGeomGrads;
  if (D < 1 || !rw_ok || (ts != 16 && ts != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = (kFixedFloats + (kGeomOnly ? 0 : size_t(kSub) * Dpad)) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(train_bwd_wide_kernel<OutT, kGeomOnly>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  train_bwd_wide_kernel<OutT, kGeomOnly><<<n_tiles, kThreads, bytes, stream>>>(
      geom, cols, gimg, hterm, grem0, tile_starts, tile_ends, padded_starts, blocks_done, out,
      ntx, ts, width, height, D, Dpad, RW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tpugs

#define TPUGS_TRAIN_BWD_ARGS                                                                  \
  const float *geom, const float *cols, const float *gimg, const float *hterm,              \
      const float *grem0, const int *tile_starts, const int *tile_ends,                     \
      const int *padded_starts, const int *blocks_done
#define TPUGS_TRAIN_BWD_PASS                                                                  \
  geom, cols, gimg, hterm, grem0, tile_starts, tile_ends, padded_starts, blocks_done

// The cluster kernel, for D <= 256, at (C, P) from raster/train.py::train_cluster.
extern "C" int tpugs_train_bwd_f32(TPUGS_TRAIN_BWD_ARGS, float* out, int n_tiles, int ntx,
                                   int ts, int width, int height, int D, int RW, int C, int P,
                                   cudaStream_t stream) {
  return tpugs::launch_cluster<float>(TPUGS_TRAIN_BWD_PASS, out, n_tiles, ntx, ts, width,
                                      height, D, RW, C, P, stream);
}

extern "C" int tpugs_train_bwd_bf16(TPUGS_TRAIN_BWD_ARGS, __nv_bfloat16* out, int n_tiles,
                                    int ntx, int ts, int width, int height, int D, int RW,
                                    int C, int P, cudaStream_t stream) {
  return tpugs::launch_cluster<__nv_bfloat16>(TPUGS_TRAIN_BWD_PASS, out, n_tiles, ntx, ts,
                                              width, height, D, RW, C, P, stream);
}

// The one-CTA kernel, for D > 256 (any D <= 512).
extern "C" int tpugs_train_bwd_wide_f32(TPUGS_TRAIN_BWD_ARGS, float* out, int n_tiles, int ntx,
                                        int ts, int width, int height, int D, int RW,
                                        cudaStream_t stream) {
  return tpugs::launch_wide<float>(TPUGS_TRAIN_BWD_PASS, out, n_tiles, ntx, ts, width, height,
                                   D, RW, stream);
}

extern "C" int tpugs_train_bwd_wide_bf16(TPUGS_TRAIN_BWD_ARGS, __nv_bfloat16* out,
                                         int n_tiles, int ntx, int ts, int width, int height,
                                         int D, int RW, cudaStream_t stream) {
  return tpugs::launch_wide<__nv_bfloat16>(TPUGS_TRAIN_BWD_PASS, out, n_tiles, ntx, ts, width,
                                           height, D, RW, stream);
}

// The one-CTA kernel's geometry-only instantiation: f32 rows of the 8
// geometry columns (RW = 8), for any D >= 1.
extern "C" int tpugs_train_bwd_geom_f32(TPUGS_TRAIN_BWD_ARGS, float* out, int n_tiles, int ntx,
                                        int ts, int width, int height, int D, int RW,
                                        cudaStream_t stream) {
  return tpugs::launch_wide<float, true>(TPUGS_TRAIN_BWD_PASS, out, n_tiles, ntx, ts, width,
                                         height, D, RW, stream);
}

// Resident clusters of the cluster kernel at tile ts and D channels (bf16
// or f32 rows), or minus a CUDA error.
extern "C" int tpugs_train_bwd_max_clusters(int bf16, int ts, int D) {
  return bf16 ? tpugs::max_clusters<__nv_bfloat16>(ts, D) : tpugs::max_clusters<float>(ts, D);
}
