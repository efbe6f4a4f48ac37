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
// one-CTA kernel that it replaced restaged g in
// 32-channel slices eight times per walked block (about 38 GB from L2 per
// step), which cost 47% of its time (experiments/train_bwd_phases.py). So
// a tile is a thread-block cluster of C = ts^2 / 128 CTAs (8 at tile 32,
// 2 at tile 16; train_cluster in raster/train.py, which the C side checks)
// of 256 threads. Rank r owns
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
// Widths D > 256 (CLUSTER_MAX_CHANNELS), up to kMaxGeomD: g of a rank's
// 128 pixels over D channels and Dpart no longer fit a CTA. The work splits
// in two, chosen by width alone (raster/train.py::train_layout, which the
// C side checks):
//  - colour slices (train_bwd_colour_kernel): the cluster kernel's layout
//    over S = ceil(D / 128) channel slices of Ns columns (fwd_slices'
//    split at COLOUR_SLICE_CHANNELS), one launch with the slices in the grid (cluster c takes tile
//    c / S, slice c % S), so a tile's slices run side by side. A slice
//    keeps g of its Ns columns resident, walks for w alone (w = alpha texc
//    T does not depend on u; the cluster kernel's instructions in its
//    order, so every w is the cluster kernel's), runs step (3) without
//    the geometry and step (4) over its columns, stored row by row (rows
//    are RW apart; a bf16 row of RW = 4 mod 8 columns is 8-byte aligned,
//    so its stores are 8 bytes). No colour staging, no u product.
//  - one geometry launch (train_bwd_geom_kernel, below), which needs
//    u = g . colour summed over all D channels at every pair: the absgrad
//    columns |dmx| |dmy| are absolute values of per-pixel sums over all
//    channels and are not linear in the slices. It writes columns D..RW.
// Together they compute the u product once and the d col product once;
// the walk runs S + 1 times. Rows of blocks past blocks_done are zeroed
// by the geometry launch, whole.
//
// The geometry cluster kernel also serves train_geom_rows (rows of the 8
// geometry columns alone, RW = 8). Its rank keeps g of P pixels over all D
// channels resident, P the largest of 64, 32, 16 and 8 whose layout fits a
// CTA (kGeomWidths: 64 up to D = 700, 32 up to 1276, 16 up to 2108, 8 up
// to the cap kMaxGeomD = 4096). At tile 32 a tile's g outgrows the 227 KB
// of 16 CTAs, the largest cluster (a non-portable size), above about 880
// channels, so no one cluster can hold it: a tile's ts^2 / P ranks form G
// pixel groups, each a cluster of C = min(ts^2 / P, 16) CTAs of 256 threads
// (raster/train.py::geom_cluster, which the C side checks). Each group
// walks the tile's blocks (B4's blocks_done) for its own pixels; a pixel's
// state depends on no other pixel, so the groups exchange nothing. The
// sub-block's colour rows stream in by cp.async in chunks of KC channels
// (64 at P = 64, 128 at 32, 256 at 16 and 8), double-buffered and issued a
// chunk ahead (4-byte copies where D % 4 != 0: the rows are not 16-byte
// aligned). The u product takes all 8 warps in 128 / P channel splits of
// 32 channels a chunk (16 at P = 8), so does the walk (256 / P threads a
// pixel, a scan over their shares of the sub-block) and the geometry sums
// over pixels (from d sigma and d op the walk stores); a block's 128 x 8
// partial sums are added over the group's ranks in rank order through
// DSMEM. With G = 1 those are the rows. With G > 1 each group stores them
// in a scratch [T_padded / 128][G][128][8] and train_bwd_groups_kernel adds
// the groups in group order: no atomics, the same rows on every run. |dmx| and
// |dmy| are sums over pixels of per-pixel absolute values, so the groups'
// sums add as the ranks' do. No d col product and no Dpart of width D.
// Shared memory GeomLayout<P>: 256 ldg + 48,384 bytes at P = 64 (ldg = D
// rounded up to 4, plus 4 where that is an even count of 16-byte groups),
// at most kGeomSmem beside the 3,072 static bytes.
//
// Measured at P = 64 (NVIDIA H100 80GB HBM3, 700.00 W;
// experiments/train_bwd_phases.py on chip_smoke.py's phase 5 render, tile
// 16, trans_eps 0; PERF.md): the rows of a 512-channel render 103.3 ms
// (colour slices 42.0, geometry kernel 61.3) against 251.6 for the first
// one-CTA kernel in the same call; its geometry rows at D = 515 76.4 ms
// against 129.5 for a one-CTA geometry kernel that restaged g in 32-channel
// slices for every sub-block. Slices of 128 columns (two CTAs per SM) ran
// 14% faster than 256 (one). Of the geometry kernel: the u product 26 ms,
// the colour staging (4-byte copies at D = 515) 13, g 3, the sums 2; the
// walk on 2 warps with the geometry reduce-scatter cost 37 ms before it
// took 4 threads a pixel, and a per-sub-block DSMEM exchange cost more than
// a per-block one; three chunk buffers instead of two gained 2.6% at D =
// 512 and lost 1% at 515, and skipping the u of Gaussians whose alpha is 0
// on all 64 pixels of a rank cost 12% (most are not), so neither was kept.
//
// Tiles past 32 (ghost layout, ts^2 > 8 ranks of 128): the cluster kernel
// and the colour slices run as G pixel groups of C ranks (G = ceil(ranks /
// 8), C = ceil(ranks / G); raster/train.py::rank_groups), one cluster each
// (group blockIdx.y); a group walks the tile's blocks_done for its own
// pixels, which need nothing of the other groups', and stores its partial
// rows in an f32 scratch [T_padded / 128][G][128][RW]; train_bwd_groups_kernel
// then adds the groups in group order, no atomics (the geometry kernel's
// scheme and kernel). The geometry kernel takes every tile
// with its ghost layout past 32.
//
// Geometry bound (chip_smoke.py, phase 5): walked pairs * 30 +
// nonzero-alpha pairs * (2D + 30) f32 operations, against the colour rows
// read once per walked block, g once per image, and the rows written.

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

// Local pixel l (0..127) of rank ``rank`` at (x, y) from the tile's
// corner: at tiles 16 and 32 (kGhost false) in the rank's pixel rows
// (local_xy); at other tiles the rank's slots 128 rank + l, row-major over
// the tile, where y >= ts (a slot past ts^2) marks a ghost.
template <bool kGhost>
__device__ __forceinline__ int2 rank_xy(int l, int rank, int ts) {
  if constexpr (kGhost) {
    const int p = rank * kPix + l;
    return make_int2(p % ts, p / ts);
  } else {
    const int2 lp = local_xy(l, ts);
    return make_int2(lp.x, rank * (kPix / ts) + lp.y);
  }
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
// geometry partials (the walking warps in order; not with kGeo false, the
// colour slices) into Dpart, rows RW apart, once every rank has read the
// previous ones.
template <int NC, bool kGeo = true>
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
  } else if constexpr (kGeo) {
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

// Grid (C * n_tiles, G) in clusters of (C, 1, 1): the C CTAs of a cluster
// take one tile and its pixel group blockIdx.y, rank r its pixels [R *
// kPix, (R + 1) * kPix) (rank_xy), R = C blockIdx.y + r. A ghost (kGhost)
// has T and g 0, so it adds no weight and no gradient. With G > 1 (kGhost)
// the group's partial rows go to gsum, [T_padded / 128][G][128][RW].
template <typename OutT, bool kGhost>
__global__ void __launch_bounds__(kCThreads, 2)
train_bwd_cluster_kernel(const float* __restrict__ geom, const float* __restrict__ cols,
                         const float* __restrict__ gimg, const float* __restrict__ hterm,
                         const float* __restrict__ grem0, const int* __restrict__ tile_starts,
                         const int* __restrict__ tile_ends, const int* __restrict__ padded_starts,
                         const int* __restrict__ blocks_done, OutT* __restrict__ out,
                         float* __restrict__ gsum, int ntx, int ts, int width, int height, int D,
                         int RW, int C, int G) {
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
  const int group = kGhost ? static_cast<int>(blockIdx.y) : 0;
  const int R = group * C + rank;  // the rank among the tile's
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

  // this thread's pixel (threads of the walk) and its carried state
  const int2 lp = rank_xy<kGhost>(tid, R, ts);
  const bool real = !kGhost || lp.y < ts;
  const int xi = x0 + lp.x;
  const int yi = y0 + lp.y;
  const bool in_img = tid < kPix && real && xi < width && yi < height;
  const float px = static_cast<float>(xi) + 0.5f;
  const float py = static_cast<float>(yi) + 0.5f;
  const long long pix = static_cast<long long>(yi) * width + xi;
  const float h = in_img ? hterm[pix] : 0.0f;
  float grem = in_img ? grem0[pix] : 0.0f;
  float trans = real ? 1.0f : 0.0f;

  // this rank's g, once per tile: 0 outside the image, on ghosts and in
  // columns [D, D4)
  for (int idx = tid; idx < kPix * D4; idx += kCThreads) {
    const int pl = idx / D4;
    const int c = idx - pl * D4;
    const int2 l = rank_xy<kGhost>(pl, R, ts);
    const int x = x0 + l.x;
    const int y = y0 + l.y;
    const bool ok = c < D && (!kGhost || l.y < ts) && x < width && y < height;
    float v = 0.0f;
    if (ok) v = gimg[(static_cast<long long>(y) * width + x) * D + c];
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
      // (4) this rank's share of the 32 rows: the C partials summed in rank
      // order; with pixel groups, the group's rows in the scratch
      if (kGhost && G > 1)
        sum_partials(gsum + ((row0 / kBlock * G + group) * kBlock + gbase) * RW, part, C, rank,
                     RW, tid);
      else
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
  for (long long v = R * kCThreads + tid; v < n_vec; v += (kGhost ? G : 1) * C * kCThreads)
    *reinterpret_cast<uint4*>(out + zero0 + v * V) = make_uint4(0, 0, 0, 0);
  cluster_wait();  // no rank leaves while another may still read its partials
}

// The G pixel groups' partial rows (gsum [T_padded / 128][G][128][W]) of
// every walked row, added in group order 0..G-1, into the row's columns
// [col0, col0 + ncols) (rows RW apart), the pad columns after them to
// col0 + ncols + pad written 0. Grid T_padded / 128: CTA b takes block b of
// the plan's padded rows (spans are whole blocks; its tile is the last whose
// span starts at or before it), if the forward walked it. Serves the
// cluster kernel (W = RW), the colour slices (W = RW, their D columns) and
// the geometry kernel (W = 8).
template <typename OutT>
__global__ void __launch_bounds__(kCThreads)
train_bwd_groups_kernel(const float* __restrict__ gsum, const int* __restrict__ tile_starts,
                        const int* __restrict__ tile_ends, const int* __restrict__ padded_starts,
                        const int* __restrict__ blocks_done, OutT* __restrict__ out, int n_tiles,
                        int W, int G, int RW, int col0, int ncols, int pad) {
  const long long row0 = static_cast<long long>(blockIdx.x) * kBlock;
  int lo = 0, hi = n_tiles - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (padded_starts[mid] <= row0) lo = mid; else hi = mid - 1;
  }
  const int count = tile_ends[lo] - tile_starts[lo];
  const int nb_done = min(blocks_done[lo], (count + kBlock - 1) / kBlock);
  if ((row0 - padded_starts[lo]) / kBlock >= nb_done) return;
  const float* blk = gsum + static_cast<long long>(blockIdx.x) * G * kBlock * W;
  const int cols = ncols + pad;
  for (int e = threadIdx.x; e < kBlock * cols; e += kCThreads) {
    const int r = e / cols, c = e - r * cols;
    OutT* o = out + (row0 + r) * RW + col0 + c;
    if (c >= ncols) {
      store(o, 0.0f);
      continue;
    }
    const float* p = blk + r * W + c;
    float sum = p[0];
    for (int k = 1; k < G; ++k) sum += p[static_cast<long long>(k) * kBlock * W];
    store(o, sum);
  }
}

// The group-order add after a launch in G > 1 pixel groups (n_rows =
// T_padded).
template <typename OutT>
cudaError_t add_groups(const float* gsum, const int* tile_starts, const int* tile_ends,
                       const int* padded_starts, const int* blocks_done, OutT* out, int n_tiles,
                       long long n_rows, int W, int G, int RW, int col0, int ncols, int pad,
                       cudaStream_t stream) {
  if (n_rows % kBlock != 0) return cudaErrorInvalidValue;
  if (n_rows > 0)
    train_bwd_groups_kernel<OutT><<<static_cast<unsigned>(n_rows / kBlock), kCThreads, 0,
                                    stream>>>(gsum, tile_starts, tile_ends, padded_starts,
                                              blocks_done, out, n_tiles, W, G, RW, col0, ncols,
                                              pad);
  return cudaGetLastError();
}

cudaLaunchConfig_t cluster_config(int n_tiles, int C, size_t bytes, cudaStream_t stream,
                                  cudaLaunchAttribute* attr, int G = 1) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * n_tiles, G, 1);
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

// (C, G) of a tile of the cluster kernel and its colour slices, as
// raster/train.py::rank_groups gives them: ts^2 pixels at kPix a rank, one
// cluster of at most kMaxCluster ranks or G pixel groups of C ((0, 0) for
// ts < 1).
int2 rank_groups(int ts) {
  if (ts < 1) return make_int2(0, 0);
  return group_layout((ts * ts + kPix - 1) / kPix, kMaxCluster);
}

// rank_xy's pixel blocks tile only tiles 16 and 32; every other tile takes
// the ghost layout (row-major slots).
bool ghost_tile(int ts) { return ts != 16 && ts != 32; }

// (C, P, G) as raster/train.py::train_cluster gives them, or an error.
template <typename OutT, bool kGhost>
cudaError_t prepare_cluster(int ts, int D, int RW, int C, int P, int G, size_t* bytes) {
  const int2 want = rank_groups(ts);
  if (D < 1 || D > kMaxClusterD || RW < D + kGeomGrads || RW % 4 != 0 || P != kPix ||
      C != want.x || G != want.y || kGhost != ghost_tile(ts))
    return cudaErrorInvalidValue;
  *bytes = ClusterLayout(D, RW).bytes();
  cudaError_t e = cudaFuncSetAttribute(train_bwd_cluster_kernel<OutT, kGhost>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(*bytes));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(train_bwd_cluster_kernel<OutT, kGhost>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename OutT, bool kGhost>
int launch_cluster_as(const float* geom, const float* cols, const float* gimg,
                      const float* hterm, const float* grem0, const int* tile_starts,
                      const int* tile_ends, const int* padded_starts, const int* blocks_done,
                      OutT* out, float* gsum, int n_tiles, int ntx, int ts, int width, int height,
                      int D, int RW, int C, int P, int G, long long n_rows, cudaStream_t stream) {
  size_t bytes = 0;
  cudaError_t e = prepare_cluster<OutT, kGhost>(ts, D, RW, C, P, G, &bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((G > 1) != (gsum != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(n_tiles, C, bytes, stream, attr, G);
  e = cudaLaunchKernelEx(&cfg, train_bwd_cluster_kernel<OutT, kGhost>, geom, cols, gimg, hterm,
                         grem0, tile_starts, tile_ends, padded_starts, blocks_done, out, gsum,
                         ntx, ts, width, height, D, RW, C, G);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (G > 1)
    return static_cast<int>(add_groups(gsum, tile_starts, tile_ends, padded_starts, blocks_done,
                                       out, n_tiles, n_rows, RW, G, RW, 0, RW, 0, stream));
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_cluster(const float* geom, const float* cols, const float* gimg, const float* hterm,
                   const float* grem0, const int* tile_starts, const int* tile_ends,
                   const int* padded_starts, const int* blocks_done, OutT* out, float* gsum,
                   int n_tiles, int ntx, int ts, int width, int height, int D, int RW, int C,
                   int P, int G, long long n_rows, cudaStream_t stream) {
  return !ghost_tile(ts)
             ? launch_cluster_as<OutT, false>(geom, cols, gimg, hterm, grem0, tile_starts,
                                              tile_ends, padded_starts, blocks_done, out, gsum,
                                              n_tiles, ntx, ts, width, height, D, RW, C, P, G,
                                              n_rows, stream)
             : launch_cluster_as<OutT, true>(geom, cols, gimg, hterm, grem0, tile_starts,
                                             tile_ends, padded_starts, blocks_done, out, gsum,
                                             n_tiles, ntx, ts, width, height, D, RW, C, P, G,
                                             n_rows, stream);
}

template <typename OutT, bool kGhost>
int max_clusters_as(int ts, int D, int C) {
  const int RW = (D + kGeomGrads + 3) / 4 * 4;
  size_t bytes = 0;
  cudaError_t e = prepare_cluster<OutT, kGhost>(ts, D, RW, C, kPix, rank_groups(ts).y, &bytes);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(1, C, bytes, nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, train_bwd_cluster_kernel<OutT, kGhost>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// Clusters of the cluster kernel at (ts, D) that can be resident at once,
// or minus a CUDA error.
template <typename OutT>
int max_clusters(int ts, int D) {
  const int C = rank_groups(ts).x;
  return !ghost_tile(ts) ? max_clusters_as<OutT, false>(ts, D, C)
                         : max_clusters_as<OutT, true>(ts, D, C);
}

// ------------------------------------------ the colour slices (D > 256)

constexpr int kMaxSliceD = 256;  // the widest slice taken: CLUSTER_MAX_CHANNELS in raster/train.py

// Shared memory of one rank of a colour slice Ns columns wide, in floats:
// g of the slice's columns Gs[kPix][ldg] (ldg / 4 odd), Ws[kPix][kLdU] and
// Dpart[kSub][Ns], this rank's partial of the slice's columns of the 32
// rows.
struct ColourLayout {
  int Ns, ldg;
  __host__ __device__ explicit ColourLayout(int ns) : Ns(ns) { ldg = (Ns / 4) % 2 ? Ns : Ns + 4; }
  __host__ __device__ int ws() const { return kPix * ldg; }
  __host__ __device__ int dpart() const { return ws() + kPix * kLdU; }
  __host__ __device__ size_t bytes() const {
    return size_t(dpart() + kSub * Ns) * sizeof(float);
  }
};

__device__ __forceinline__ void store4(float* o, const float4 s) {
  *reinterpret_cast<float4*>(o) = s;
}
__device__ __forceinline__ void store4(bf16* o, const float4 s) {
  const __nv_bfloat162 h[2] = {__floats2bfloat162_rn(s.x, s.y), __floats2bfloat162_rn(s.z, s.w)};
  *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(h);
}

// This rank's share of a slice's ns columns of the sub-block's 32 rows (out
// points at row 0, the slice's first column): each 4 columns of a row are
// the sum of the C ranks' partials, in rank order 0..C-1, read through
// DSMEM; stored row by row, 4 columns a store (16 bytes in f32, 8 in bf16:
// RW and the slice's first column are multiples of 4), the row's last
// ns % 4 columns one by one.
template <typename OutT>
__device__ __forceinline__ void sum_columns(OutT* __restrict__ out,
                                            const uint32_t (&part)[kMaxCluster], int C,
                                            int rank, int Ns, int ns, int RW, int tid) {
  const int per_row = Ns / 4;
  const int n = kSub * per_row;
  const int per = (n + C - 1) / C;
  const int end = min(n, (rank + 1) * per);
  for (int v = rank * per + tid; v < end; v += kCThreads) {
    const int i = v / per_row;
    const int c = 4 * (v - i * per_row);
    if (c >= ns) continue;
    float4 s = ld_cluster_f4(part[0] + 16u * v);
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < C) add4(s, ld_cluster_f4(part[r] + 16u * v));
    OutT* o = out + static_cast<long long>(i) * RW + c;
    if (c + 4 <= ns) {
      store4(o, s);
    } else {
      const float e[4] = {s.x, s.y, s.z, s.w};
      for (int k = 0; k < ns - c; ++k) store(o + k, e[k]);
    }
  }
}

// Grid (C * S * n_tiles, G) in clusters of (C, 1, 1): cluster c takes tile
// c / S and channel slice c % S, columns [c0, c0 + ns), of pixel group
// blockIdx.y; rank r its pixels [R * kPix, (R + 1) * kPix) as in the
// cluster kernel, ghosts and groups too. Writes only the slice's columns of
// the walked blocks' rows (with G > 1, of the group's rows in gsum).
template <typename OutT, bool kGhost>
__global__ void __launch_bounds__(kCThreads, 2)
train_bwd_colour_kernel(const float* __restrict__ geom, const float* __restrict__ gimg,
                        const int* __restrict__ tile_starts, const int* __restrict__ tile_ends,
                        const int* __restrict__ padded_starts,
                        const int* __restrict__ blocks_done, OutT* __restrict__ out,
                        float* __restrict__ gsum, int ntx, int ts, int width, int height, int D,
                        int RW, int C, int S, int Ns, int G) {
  extern __shared__ __align__(16) float smem[];
  const ColourLayout L(Ns);
  float* Gs = smem;                 // [kPix][ldg]: this rank's g of the slice, for the whole tile
  float* Ws = smem + L.ws();        // [kPix][kLdU]
  float* Dpart = smem + L.dpart();  // [kSub][Ns]
  __shared__ BlockGeom g;

  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster_rank());
  const int cl = blockIdx.x / C;
  const int tile = cl / S;
  const int group = kGhost ? static_cast<int>(blockIdx.y) : 0;
  const int R = group * C + rank;  // the rank among the tile's
  const int c0 = (cl % S) * Ns;
  const int ns = min(Ns, D - c0);
  const int ldg = L.ldg;
  const int count = tile_ends[tile] - tile_starts[tile];
  const int nb = (count + kBlock - 1) / kBlock;
  const int nb_done = min(blocks_done[tile], nb);
  const long long pstart = padded_starts[tile];
  const int x0 = (tile % ntx) * ts;
  const int y0 = (tile / ntx) * ts;
  uint32_t part[kMaxCluster];  // every rank's Dpart, as DSMEM addresses
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) part[r] = map_rank(smem_addr(Dpart), r < C ? r : 0);

  const int2 lp = rank_xy<kGhost>(tid, R, ts);
  const float px = static_cast<float>(x0 + lp.x) + 0.5f;
  const float py = static_cast<float>(y0 + lp.y) + 0.5f;
  float trans = !kGhost || lp.y < ts ? 1.0f : 0.0f;

  // this rank's g of the slice, once per tile: 0 outside the image, on
  // ghosts and past ns
  for (int idx = tid; idx < kPix * Ns; idx += kCThreads) {
    const int pl = idx / Ns;
    const int c = idx - pl * Ns;
    const int2 l = rank_xy<kGhost>(pl, R, ts);
    const int x = x0 + l.x;
    const int y = y0 + l.y;
    float v = 0.0f;
    if (c < ns && (!kGhost || l.y < ts) && x < width && y < height)
      v = gimg[(static_cast<long long>(y) * width + x) * D + c0 + c];
    Gs[pl * ldg + c] = v;
  }
  cluster_arrive();  // every CTA of the cluster has started
  cluster_wait();
  cluster_arrive();  // Dpart is free (paired with the first sub-block's wait)

  for (int b = 0; b < nb_done; ++b) {
    const long long row0 = pstart + static_cast<long long>(b) * kBlock;
    load_geom(g, geom, row0, tid, kGeomCols);  // the last walk's reads ended at a barrier
    const int remaining = count - b * kBlock;
    float texc = 1.0f;
    for (int s = 0; s < kBlock / kSub; ++s) {
      const int gbase = s * kSub;
      __syncthreads();  // the block's geometry is in, every read of Ws is done

      // the walk for w alone: the cluster kernel's instructions in its order
      if (tid < kPix) {
        float* row = Ws + tid * kLdU;
        for (int i4 = 0; i4 < kSub; i4 += 4) {
          float ww[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gi = gbase + i4 + e;
            const PairTerms t = pair_terms(g, gi, px, py);
            const float alpha = clipped_alpha(t, gi < remaining);
            ww[e] = alpha * texc * trans;
            texc *= 1.0f - alpha;
          }
          *reinterpret_cast<float4*>(row + i4) = make_float4(ww[0], ww[1], ww[2], ww[3]);
        }
      }
      __syncthreads();

      switch ((ns + 31) / 32) {  // (3) without the geometry, rows Ns apart
        case 1: partial_rows<1, false>(Ws, Gs, Dpart, nullptr, ldg, ns, Ns, tid); break;
        case 2: partial_rows<2, false>(Ws, Gs, Dpart, nullptr, ldg, ns, Ns, tid); break;
        case 3: partial_rows<3, false>(Ws, Gs, Dpart, nullptr, ldg, ns, Ns, tid); break;
        case 4: partial_rows<4, false>(Ws, Gs, Dpart, nullptr, ldg, ns, Ns, tid); break;
        case 5: partial_rows<5, false>(Ws, Gs, Dpart, nullptr, ldg, ns, Ns, tid); break;
        case 6: partial_rows<6, false>(Ws, Gs, Dpart, nullptr, ldg, ns, Ns, tid); break;
        case 7: partial_rows<7, false>(Ws, Gs, Dpart, nullptr, ldg, ns, Ns, tid); break;
        default: partial_rows<8, false>(Ws, Gs, Dpart, nullptr, ldg, ns, Ns, tid); break;
      }
      cluster_arrive();  // every rank's partials are complete
      cluster_wait();
      // (4) this rank's share of the slice's columns of the 32 rows (with
      // pixel groups, of the group's rows in the scratch)
      if (kGhost && G > 1)
        sum_columns(gsum + ((row0 / kBlock * G + group) * kBlock + gbase) * RW + c0, part, C,
                    rank, Ns, ns, RW, tid);
      else
        sum_columns(out + (row0 + gbase) * RW + c0, part, C, rank, Ns, ns, RW, tid);
      cluster_arrive();  // this rank has read the others' partials
    }
    trans *= texc;
  }
  cluster_wait();  // no rank leaves while another may still read its partials
}

// (C, P, G, S, Ns) as raster/train.py::train_layout gives them, or an error.
template <typename OutT, bool kGhost>
cudaError_t prepare_colour(int ts, int D, int RW, int C, int P, int G, int S, int Ns,
                          size_t* bytes) {
  const int2 want = rank_groups(ts);
  if (D < 1 || RW < D + kGeomGrads || RW % 4 != 0 || S < 1 || Ns < 16 || Ns > kMaxSliceD ||
      Ns % 16 != 0 || static_cast<long long>(S - 1) * Ns >= D ||
      static_cast<long long>(S) * Ns < D || P != kPix || C != want.x || G != want.y ||
      kGhost != ghost_tile(ts))
    return cudaErrorInvalidValue;
  *bytes = ColourLayout(Ns).bytes();
  cudaError_t e = cudaFuncSetAttribute(train_bwd_colour_kernel<OutT, kGhost>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(*bytes));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(train_bwd_colour_kernel<OutT, kGhost>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename OutT, bool kGhost>
int launch_colour_as(const float* geom, const float* gimg, const int* tile_starts,
                     const int* tile_ends, const int* padded_starts, const int* blocks_done,
                     OutT* out, float* gsum, int n_tiles, int ntx, int ts, int width, int height,
                     int D, int RW, int C, int P, int G, int S, int Ns, long long n_rows,
                     cudaStream_t stream) {
  size_t bytes = 0;
  cudaError_t e = prepare_colour<OutT, kGhost>(ts, D, RW, C, P, G, S, Ns, &bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((G > 1) != (gsum != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(S * n_tiles, C, bytes, stream, attr, G);
  e = cudaLaunchKernelEx(&cfg, train_bwd_colour_kernel<OutT, kGhost>, geom, gimg, tile_starts,
                         tile_ends, padded_starts, blocks_done, out, gsum, ntx, ts, width,
                         height, D, RW, C, S, Ns, G);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (G > 1)
    return static_cast<int>(add_groups(gsum, tile_starts, tile_ends, padded_starts, blocks_done,
                                       out, n_tiles, n_rows, RW, G, RW, 0, D, 0, stream));
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_colour(const float* geom, const float* gimg, const int* tile_starts,
                  const int* tile_ends, const int* padded_starts, const int* blocks_done,
                  OutT* out, float* gsum, int n_tiles, int ntx, int ts, int width, int height,
                  int D, int RW, int C, int P, int G, int S, int Ns, long long n_rows,
                  cudaStream_t stream) {
  return !ghost_tile(ts)
             ? launch_colour_as<OutT, false>(geom, gimg, tile_starts, tile_ends, padded_starts,
                                             blocks_done, out, gsum, n_tiles, ntx, ts, width,
                                             height, D, RW, C, P, G, S, Ns, n_rows, stream)
             : launch_colour_as<OutT, true>(geom, gimg, tile_starts, tile_ends, padded_starts,
                                            blocks_done, out, gsum, n_tiles, ntx, ts, width,
                                            height, D, RW, C, P, G, S, Ns, n_rows, stream);
}

template <typename OutT, bool kGhost>
int max_colour_clusters_as(int ts, int Ns, int C) {
  size_t bytes = 0;
  cudaError_t e = prepare_colour<OutT, kGhost>(ts, Ns, Ns + kGeomGrads, C, kPix,
                                               rank_groups(ts).y, 1, Ns, &bytes);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(1, C, bytes, nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, train_bwd_colour_kernel<OutT, kGhost>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// Clusters of one colour slice Ns columns wide at tile ts that can be
// resident at once, or minus a CUDA error.
template <typename OutT>
int max_colour_clusters(int ts, int Ns) {
  const int C = rank_groups(ts).x;
  return !ghost_tile(ts) ? max_colour_clusters_as<OutT, false>(ts, Ns, C)
                         : max_colour_clusters_as<OutT, true>(ts, Ns, C);
}

// -------------------------------------------- the geometry cluster kernel

constexpr int kGThreads = 256;        // the u product's channel splits, the walk's pixels
constexpr int kMaxGeomCluster = 16;   // GEOM_MAX_CLUSTER in raster/train.py; non-portable
constexpr int kGeomSmem = 229376;     // dynamic bytes a CTA may take: 227 KB less BlockGeom
constexpr int kMaxGeomD = 38140;      // GEOM_MAX_CHANNELS in raster/train.py
// (widest D, pixels per rank P) of the geometry kernel, the largest P whose
// layout fits kGeomSmem first: GEOM_WIDTHS in raster/train.py
constexpr int kGeomWidths[7][2] = {{700, 64},  {1276, 32}, {2108, 16}, {4276, 8},
                                   {8620, 4},  {18460, 2}, {38140, 1}};

// The kernel's shape at NP pixels per rank: the u product in K channel
// splits of 8 NP / JP threads (a JP x 4 register tile each: JP pixels, 4
// Gaussians), KS channels of every staged chunk of KC = K KS to a split;
// the walk Q threads per pixel, NG Gaussians of the sub-block each (below
// 8 pixels a rank, one warp a pixel and the other warps idle). NU u
// buffers: at K = 2 the halves add in registers, else every split stores
// its partial and all threads add them.
template <int NP>
struct GeomShape {
  static constexpr int JP = NP < 4 ? NP : 4;
  static constexpr int K = kGThreads / (8 * (NP / JP));
  static constexpr int KS = NP >= 16 ? 32 : NP == 8 ? 16 : 8;
  static constexpr int KC = K * KS;
  static constexpr int Q = kGThreads / NP < kSub ? kGThreads / NP : kSub;
  static constexpr int NG = kSub / Q;
  static constexpr int NU = K == 2 ? 1 : K;
  static constexpr int LDC = KC + 4;  // Cc[gaussian][channel]: an odd count of 16-byte groups
  static constexpr int LDS = NP + 5;  // Dsig/Dop[gaussian][pixel]: the walk's stores in 32 banks
};

// Shared memory of one rank, in floats: g Gs[NP][ldg] (ldg / 4 odd), two
// colour chunk buffers Cc[kSub][LDC], Us[NU][NP][kLdU], the walk's d sigma
// and d op Dsig/Dop[kSub][LDS], and this rank's partial sums of the block
// Gpart[kBlock][8].
template <int NP>
struct GeomLayout {
  using Sh = GeomShape<NP>;
  int D4, ldg;
  __host__ __device__ explicit GeomLayout(int D) {
    D4 = (D + 3) / 4 * 4;
    ldg = (D4 / 4) % 2 ? D4 : D4 + 4;
  }
  __host__ __device__ int chunks() const { return NP * ldg; }
  __host__ __device__ int us() const { return chunks() + 2 * kSub * Sh::LDC; }
  __host__ __device__ int dsig() const { return us() + Sh::NU * NP * kLdU; }
  __host__ __device__ int dop() const { return dsig() + kSub * Sh::LDS; }
  __host__ __device__ int gpart() const { return dop() + kSub * Sh::LDS; }
  __host__ __device__ size_t bytes() const {
    return size_t(gpart() + kBlock * kGeomGrads) * sizeof(float);
  }
};

// Local pixel l (0..NP-1) of the tile's rank R: the rank's (NP / 4) x 4
// pixel block (ts / (NP / 4) blocks across the tile, rank order
// row-major), in patches of up to 8 x 4 side by side (at NP = 64 each
// walking warp's pixels lie in one).
template <int NP>
__device__ __forceinline__ int2 geom_xy(int l, int R, int ts) {
  constexpr int bw = NP / 4, pw = bw < 8 ? bw : 8;
  const int per_row = ts / bw, li = l % (4 * pw);
  return make_int2(bw * (R % per_row) + pw * (l / (4 * pw)) + li % pw,
                   4 * (R / per_row) + li / pw);
}

// Local pixel l of rank R at (x, y) from the tile's corner: geom_xy at
// tiles 16 and 32 and P >= 8 (kGhost false; its blocks tile no other
// tile), else the rank's slots NP R + l, row-major over the tile, where
// y >= ts (a slot past ts^2) marks a ghost.
template <int NP, bool kGhost>
__device__ __forceinline__ int2 geom_pixel(int l, int R, int ts) {
  if constexpr (kGhost) {
    const int p = R * NP + l;
    return make_int2(p % ts, p / ts);
  } else {
    return geom_xy<NP>(l, R, ts);
  }
}

// Channels [k0, k0 + KC) of the colour rows cols[row .. row + 32) into
// Cc (one committed group): 16-byte cp.async where D % 4 == 0 (the rows
// are then 16-byte aligned), else 4-byte; zeros in the chunk's columns
// past D up to a multiple of 4. (Aligned 16-byte loads into registers,
// shifted into place after the chunk before, ran 3% slower at D = 515 and
// 2% faster at 1027: the loads' latency is no longer hidden.)
template <int NP>
__device__ __forceinline__ void stage_chunk(float* Cc, const float* __restrict__ cols,
                                            long long row, int k0, int D, int tid) {
  constexpr int kKC = GeomShape<NP>::KC, kLdC = GeomShape<NP>::LDC;
  const int kw = min(kKC, D - k0);
  const float* src = cols + row * D + k0;
  if ((D & 3) == 0) {
    for (int e = tid; e < kSub * (kKC / 4); e += kGThreads) {
      const int i = e / (kKC / 4);
      const int k = 4 * (e % (kKC / 4));
      if (k < kw) cp_async16(Cc + i * kLdC + k, src + static_cast<long long>(i) * D + k);
    }
  } else {
    const int kw4 = (kw + 3) & ~3;
    for (int e = tid; e < kSub * kKC; e += kGThreads) {
      const int i = e / kKC;
      const int k = e % kKC;
      if (k < kw)
        cp_async4(Cc + i * kLdC + k, src + static_cast<long long>(i) * D + k);
      else if (k < kw4)
        Cc[i * kLdC + k] = 0.0f;
    }
  }
  cp_async_commit();
}

// This rank's share of the block's 128 x 8 geometry sums (out points at
// row 0, the first geometry column; rows RW apart): each 4 sums are the C
// ranks' partials added in rank order 0..C-1 through DSMEM; the n_pad
// columns after the geometry are written 0.
template <typename OutT>
__device__ __forceinline__ void sum_geometry(OutT* __restrict__ out,
                                             const uint32_t (&part)[kMaxGeomCluster], int C,
                                             int rank, int RW, int n_pad, int tid) {
  constexpr int n = kBlock * kGeomGrads / 4;
  const int per = (n + C - 1) / C;
  const int v = rank * per + tid;
  if (tid >= per || v >= n) return;
  float4 s = ld_cluster_f4(part[0] + 16u * v);
#pragma unroll
  for (int r = 1; r < kMaxGeomCluster; ++r)
    if (r < C) add4(s, ld_cluster_f4(part[r] + 16u * v));
  const int t = 4 * (v & 1);
  OutT* o = out + static_cast<long long>(v >> 1) * RW + t;
  store(o, s.x);
  store(o + 1, s.y);
  store(o + 2, s.z);
  store(o + 3, s.w);
  if (t) for (int k = 0; k < n_pad; ++k) store(o + 4 + k, 0.0f);
}

// Grid C * G * n_tiles in clusters of (C, 1, 1): cluster c takes tile c / G
// and its pixel group c % G, the tile's ranks R = (c % G) C .. + C - 1 of
// NP pixels each (geom_pixel); a ghost has T and g 0, so it adds no
// gradient. Writes columns [col0, RW) of every row of the
// tile's span: col0 = 0 for RW = 8 (the geometry rows of train_geom_rows),
// else col0 = D (train_rows' geometry and pad columns, and the whole rows
// of the blocks past blocks_done). With G = 1 the cluster's sums are the
// rows; with G > 1 each group stores its sums of every walked row in gsum
// [T_padded / 128][G][128][8], and train_bwd_groups_kernel adds them.
// Per 32-Gaussian sub-block:
//   (1) u (NP x 32) = G Ct^T chunk by chunk, each chunk's K slices of KS
//       channels to the K splits of the CTA (a 4 x 4 register tile per
//       thread, each u summed over its split's channels in order); the
//       splits' sums are added in split order through Us;
//   (2) the walk, Q threads per pixel, each NG of the sub-block's
//       Gaussians: each computes its share's transmittance factor P and
//       sum S of alpha * T * u from 1, an exclusive scan over the Q (under
//       (P1, S1)(P2, S2) = (P1 P2, S1 + P1 S2), log2 Q shuffle steps) gives
//       each its T and prefix of w * u on entry, and each then replays its
//       share and stores d sigma and d op per pair;
//   (3) all 8 warps sum the 8 geometry terms of each Gaussian over the
//       rank's pixels, 8 threads per Gaussian of NP / 8 pixels each and a
//       butterfly over the 8 (pairs whose d sigma and d op are 0 skipped);
// and per 128-Gaussian block (4) the ranks' partials are added in rank
// order through DSMEM, one cluster exchange a block.
template <typename OutT, int NP, bool kGhost>
__global__ void __launch_bounds__(kGThreads, 1)
train_bwd_geom_kernel(const float* __restrict__ geom, const float* __restrict__ cols,
                      const float* __restrict__ gimg, const float* __restrict__ hterm,
                      const float* __restrict__ grem0, const int* __restrict__ tile_starts,
                      const int* __restrict__ tile_ends, const int* __restrict__ padded_starts,
                      const int* __restrict__ blocks_done, OutT* __restrict__ out,
                      float* __restrict__ gsum, int ntx, int ts, int width, int height, int D,
                      int RW, int C, int G) {
  using Sh = GeomShape<NP>;
  constexpr int kLdC = Sh::LDC, kLdS = Sh::LDS, kStride = NP / Sh::JP, kJP = Sh::JP;
  extern __shared__ __align__(16) float smem[];
  const GeomLayout<NP> L(D);
  float* Gs = smem;                  // [NP][ldg]: this rank's g, for the whole tile
  float* Cbuf = smem + L.chunks();   // 2 x Cc[kSub][kLdC]
  float* Us = smem + L.us();         // [NU][NP][kLdU]
  float* Dsig = smem + L.dsig();     // [kSub][kLdS]
  float* Dop = smem + L.dop();       // [kSub][kLdS]
  float* Gpart = smem + L.gpart();   // [kBlock][kGeomGrads]
  __shared__ BlockGeom g;

  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster_rank());
  const int cl = blockIdx.x / C;
  const int tile = cl / G, group = cl % G;
  const int R = group * C + rank;  // the rank among the tile's ts^2 / NP
  const int ldg = L.ldg, D4 = L.D4;
  const int col0 = RW == kGeomGrads ? 0 : D;
  const int n_pad = RW - col0 - kGeomGrads;
  const int count = tile_ends[tile] - tile_starts[tile];
  const int nb = (count + kBlock - 1) / kBlock;
  const int nb_done = min(blocks_done[tile], nb);
  const long long pstart = padded_starts[tile];
  const int x0 = (tile % ntx) * ts;
  const int y0 = (tile / ntx) * ts;
  uint32_t part[kMaxGeomCluster];  // every rank's Gpart, as DSMEM addresses
#pragma unroll
  for (int r = 0; r < kMaxGeomCluster; ++r)
    part[r] = map_rank(smem_addr(Gpart), r < C ? r : 0);

  // this thread's pixel in the walk, its share of the Gaussians and the
  // pixel's carried state (the same in its Q threads); below 8 pixels a
  // rank the threads past NP Q walk no pixel
  constexpr bool kAllWalk = Sh::Q * NP == kGThreads;
  const int wp = tid / Sh::Q, quarter = tid % Sh::Q;
  const int2 lp = geom_pixel<NP, kGhost>(wp, R, ts);
  const bool real = (kAllWalk || wp < NP) && (!kGhost || lp.y < ts);
  const int xi = x0 + lp.x;
  const int yi = y0 + lp.y;
  const bool in_img = real && xi < width && yi < height;
  const float px = static_cast<float>(xi) + 0.5f;
  const float py = static_cast<float>(yi) + 0.5f;
  const long long pix = static_cast<long long>(yi) * width + xi;
  const float h = in_img ? hterm[pix] : 0.0f;
  float grem = in_img ? grem0[pix] : 0.0f;
  float trans = real ? 1.0f : 0.0f;

  // this rank's g over all D channels, once per tile: 0 outside the image,
  // on ghosts and in columns [D, D4)
  for (int idx = tid; idx < NP * D4; idx += kGThreads) {
    const int pl = idx / D4;
    const int c = idx - pl * D4;
    const int2 l = geom_pixel<NP, kGhost>(pl, R, ts);
    const int x = x0 + l.x;
    const int y = y0 + l.y;
    const bool inside = (!kGhost || l.y < ts) && x < width && y < height;
    float v = 0.0f;
    if (c < D && inside) v = gimg[(static_cast<long long>(y) * width + x) * D + c];
    Gs[pl * ldg + c] = v;
  }
  // the colour chunks of the walk in order: sub-block q / n_ch of the span,
  // channels KC (q % n_ch) onward
  const int n_ch = (D + Sh::KC - 1) / Sh::KC;
  const int n_q = nb_done * (kBlock / kSub) * n_ch;
  if (n_q > 0) stage_chunk<NP>(Cbuf, cols, pstart, 0, D, tid);
  cluster_arrive();  // every CTA of the cluster has started
  cluster_wait();
  cluster_arrive();  // Gpart is free (paired with the first block's wait)

  // (1)'s thread (pg, gg) of channel split `half`: pixels pg + (NP / JP) j,
  // Gaussians gg + 8m
  const int half = tid / (kGThreads / Sh::K);
  const int gg = tid & 7, pg = (tid % (kGThreads / Sh::K)) >> 3;
  int q = 0;
  for (int b = 0; b < nb_done; ++b) {
    const long long row0 = pstart + static_cast<long long>(b) * kBlock;
    load_geom(g, geom, row0, tid, kGeomCols);  // the last walk's reads ended at a barrier
    const int remaining = count - b * kBlock;
    float texc = 1.0f, cs = 0.0f;
    for (int s = 0; s < kBlock / kSub; ++s) {
      const int gbase = s * kSub;

      // (1) u = G Ct^T, chunk by chunk, each chunk staged one ahead
      float u[kJP][4];
#pragma unroll
      for (int j = 0; j < kJP; ++j)
#pragma unroll
        for (int m = 0; m < 4; ++m) u[j][m] = 0.0f;
      for (int kc = 0; kc < n_ch; ++kc, ++q) {
        cp_async_wait_all();  // chunk q is in (the only group in flight)
        __syncthreads();      // for every thread, and every read of chunk q - 1 is done
        if (q + 1 < n_q)
          stage_chunk<NP>(Cbuf + ((q + 1) & 1) * kSub * kLdC, cols,
                          pstart + static_cast<long long>((q + 1) / n_ch) * kSub,
                          ((q + 1) % n_ch) * Sh::KC, D, tid);
        const int k0 = kc * Sh::KC + half * Sh::KS;
        const float* Cc = Cbuf + (q & 1) * kSub * kLdC + half * Sh::KS;
        const float* Gk = Gs + k0;
        const int kw4 = min(Sh::KS, D4 - k0);
#pragma unroll 1
        for (int k = 0; k < kw4; k += 4) {
          float4 gv[kJP], cv[4];
#pragma unroll
          for (int j = 0; j < kJP; ++j)
            gv[j] = *reinterpret_cast<const float4*>(Gk + (pg + kStride * j) * ldg + k);
#pragma unroll
          for (int m = 0; m < 4; ++m)
            cv[m] = *reinterpret_cast<const float4*>(Cc + (gg + 8 * m) * kLdC + k);
#pragma unroll
          for (int j = 0; j < kJP; ++j)
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              float a = fmaf(gv[j].x, cv[m].x, u[j][m]);
              a = fmaf(gv[j].y, cv[m].y, a);
              a = fmaf(gv[j].z, cv[m].z, a);
              u[j][m] = fmaf(gv[j].w, cv[m].w, a);
            }
        }
      }
      // the splits' sums, in split order: u = u(split 0) + u(split 1) + ...
      if constexpr (Sh::K == 2) {
        if (half) {
#pragma unroll
          for (int j = 0; j < kJP; ++j)
#pragma unroll
            for (int m = 0; m < 4; ++m) Us[(pg + kStride * j) * kLdU + gg + 8 * m] = u[j][m];
        }
        __syncthreads();
        if (!half) {
#pragma unroll
          for (int j = 0; j < kJP; ++j)
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              float* o = Us + (pg + kStride * j) * kLdU + gg + 8 * m;
              *o = u[j][m] + *o;
            }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kJP; ++j)
#pragma unroll
          for (int m = 0; m < 4; ++m)
            Us[(half * NP + pg + kStride * j) * kLdU + gg + 8 * m] = u[j][m];
        __syncthreads();
        for (int e = tid; e < NP * kSub; e += kGThreads) {
          float* o = Us + (e / kSub) * kLdU + e % kSub;
          float a = o[0];
#pragma unroll
          for (int k = 1; k < Sh::K; ++k) a += o[k * NP * kLdU];
          o[0] = a;
        }
      }
      __syncthreads();

      // (2) the walk: thread `quarter` of pixel wp takes Gaussians
      // NG quarter + 0..NG-1 of the sub-block
      if (kAllWalk || wp < NP) {
        const float* row = Us + wp * kLdU + Sh::NG * quarter;
        float uu[Sh::NG];
        if constexpr (Sh::NG % 4 == 0) {
#pragma unroll
          for (int e = 0; e < Sh::NG; e += 4) {
            const float4 u4 = *reinterpret_cast<const float4*>(row + e);
            uu[e] = u4.x;
            uu[e + 1] = u4.y;
            uu[e + 2] = u4.z;
            uu[e + 3] = u4.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < Sh::NG; ++e) uu[e] = row[e];
        }
        float al[Sh::NG], ex[Sh::NG];
        unsigned grad = 0, pos = 0;  // bit e: d alpha passes the clip; sigma > 0
        float P = 1.0f, S = 0.0f;    // the share's T factor and sum of alpha * T * u, from 1
#pragma unroll
        for (int e = 0; e < Sh::NG; ++e) {
          const int gi = gbase + Sh::NG * quarter + e;
          const PairTerms pt = pair_terms(g, gi, px, py);
          const float alpha = clipped_alpha(pt, gi < remaining);
          al[e] = alpha;
          ex[e] = pt.e;
          if (alpha != 0.0f && pt.alpha_raw < kAlphaMax) grad |= 1u << e;
          if (pt.sigma > 0.0f) pos |= 1u << e;
          S = fmaf(alpha * P, uu[e], S);
          P *= 1.0f - alpha;
        }
#pragma unroll
        for (int d = 1; d < Sh::Q; d <<= 1) {  // inclusive scan over the pixel's shares
          const float Pu = __shfl_up_sync(0xffffffffu, P, d, Sh::Q);
          const float Su = __shfl_up_sync(0xffffffffu, S, d, Sh::Q);
          if (quarter >= d) {
            S = fmaf(Pu, S, Su);
            P = Pu * P;
          }
        }
        float Pe = __shfl_up_sync(0xffffffffu, P, 1, Sh::Q);  // exclusive: the shares before
        float Se = __shfl_up_sync(0xffffffffu, S, 1, Sh::Q);
        if (quarter == 0) {
          Pe = 1.0f;
          Se = 0.0f;
        }
        float tx = texc * Pe;                  // T within the block on entry
        float c = fmaf(texc * trans, Se, cs);  // prefix of w * u on entry
#pragma unroll
        for (int e = 0; e < Sh::NG; ++e) {
          const int gi = gbase + Sh::NG * quarter + e;
          const float alpha = al[e];
          const float w = alpha * tx * trans;
          c = fmaf(w, uu[e], c);
          const float v = grem - c;
          const float d_alpha = tx * trans * uu[e] - (v + h) / fmaxf(1.0f - alpha, 1e-6f);
          const float d_araw = (grad >> e) & 1u ? d_alpha : 0.0f;
          tx *= 1.0f - alpha;
          Dsig[(Sh::NG * quarter + e) * kLdS + wp] =
              (pos >> e) & 1u ? -d_araw * g.op[gi] * ex[e] : 0.0f;
          Dop[(Sh::NG * quarter + e) * kLdS + wp] = d_araw * ex[e];
        }
        texc = __shfl_sync(0xffffffffu, tx, Sh::Q - 1, Sh::Q);  // the pixel's state after the sub-block
        cs = __shfl_sync(0xffffffffu, c, Sh::Q - 1, Sh::Q);
      }
      __syncthreads();

      // (3) this rank's partial sums, once every rank has read the previous
      // block's
      if (s == 0) cluster_wait();
      {
        const int i = tid >> 3, l = tid & 7;
        const int gi = gbase + i;
        const float mx = g.mx[gi], my = g.my[gi];
        const float ca = g.ca[gi], cb = g.cb[gi], cc = g.cc[gi];
        float a[kGeomGrads];
#pragma unroll
        for (int k = 0; k < kGeomGrads; ++k) a[k] = 0.0f;
        for (int p = l; p < NP; p += 8) {
          const float ds = Dsig[i * kLdS + p];
          const float dop = Dop[i * kLdS + p];
          if (ds == 0.0f && dop == 0.0f) continue;  // every term 0
          const int2 xy = geom_pixel<NP, kGhost>(p, R, ts);
          const float dx = __fsub_rn(static_cast<float>(x0 + xy.x) + 0.5f, mx);
          const float dy = __fsub_rn(static_cast<float>(y0 + xy.y) + 0.5f, my);
          const float dmx = ds * -(ca * dx + cb * dy);
          const float dmy = ds * -(cc * dy + cb * dx);
          a[0] += dmx;
          a[1] += dmy;
          a[2] += ds * (0.5f * dx * dx);
          a[3] += ds * (dx * dy);
          a[4] += ds * (0.5f * dy * dy);
          a[5] += dop;
          a[6] += fabsf(dmx);
          a[7] += fabsf(dmy);
        }
#pragma unroll
        for (int k = 0; k < kGeomGrads; ++k) {
#pragma unroll
          for (int off = 4; off >= 1; off >>= 1) a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
        }
        if (l == 0) {
#pragma unroll
          for (int k = 0; k < kGeomGrads; ++k) Gpart[(gbase + i) * kGeomGrads + k] = a[k];
        }
      }
    }
    cluster_arrive();  // every rank's partial of the block is complete
    cluster_wait();
    // (4) this rank's share of the 128 x 8 sums, the C partials in rank order:
    // the rows themselves, or the group's sums
    if (G == 1)
      sum_geometry(out + row0 * RW + col0, part, C, rank, RW, n_pad, tid);
    else
      sum_geometry(gsum + (row0 / kBlock * G + group) * kBlock * kGeomGrads, part, C, rank,
                   kGeomGrads, 0, tid);
    cluster_arrive();  // this rank has read the others' partials
    trans *= texc;
    grem -= cs;
  }
  // blocks the forward's early exit skipped: whole zero rows, 16 bytes a
  // store, split over the tile's ranks (the span is 16-byte aligned)
  constexpr int V = 16 / sizeof(OutT);
  const long long zero0 = (pstart + static_cast<long long>(nb_done) * kBlock) * RW;
  const long long n_vec = static_cast<long long>(nb - nb_done) * kBlock * RW / V;
  for (long long v = R * kGThreads + tid; v < n_vec; v += G * C * kGThreads)
    *reinterpret_cast<uint4*>(out + zero0 + v * V) = make_uint4(0, 0, 0, 0);
  cluster_wait();  // no rank leaves while another may still read its partial
}

// P of the geometry kernel at D channels (kGeomWidths), 0 past its cap.
int geom_pixels(int D) {
  for (const auto& w : kGeomWidths)
    if (D <= w[0]) return w[1];
  return 0;
}

// (C, P, G) as raster/train.py::geom_cluster gives them, or an error: the
// tile's ceil(ts^2 / P) ranks in G = ceil(ranks / 16) groups of C =
// ceil(ranks / G). RW is 8 (geometry rows) or train_rows' (D + 8 rounded up
// to 4).
cudaError_t check_geom(int ts, int D, int RW, int C, int P, int G) {
  if (D < 1 || D > kMaxGeomD || (RW != kGeomGrads && RW != (D + kGeomGrads + 3) / 4 * 4) ||
      ts < 1 || P != geom_pixels(D))
    return cudaErrorInvalidValue;
  const int ranks = (ts * ts + P - 1) / P;
  const int groups = (ranks + kMaxGeomCluster - 1) / kMaxGeomCluster;
  if (G != groups || C != (ranks + groups - 1) / groups) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename OutT, int NP, bool kGhost>
cudaError_t prepare_geom(int D, size_t* bytes) {
  *bytes = GeomLayout<NP>(D).bytes();
  if (*bytes > static_cast<size_t>(kGeomSmem)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(train_bwd_geom_kernel<OutT, NP, kGhost>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(*bytes));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(train_bwd_geom_kernel<OutT, NP, kGhost>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(train_bwd_geom_kernel<OutT, NP, kGhost>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

cudaLaunchConfig_t geom_config(int n_clusters, int C, size_t bytes, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = cluster_config(n_clusters, C, bytes, stream, attr);
  cfg.blockDim = dim3(kGThreads, 1, 1);
  return cfg;
}

template <typename OutT, int NP, bool kGhost>
int launch_geom_p(const float* geom, const float* cols, const float* gimg, const float* hterm,
                  const float* grem0, const int* tile_starts, const int* tile_ends,
                  const int* padded_starts, const int* blocks_done, OutT* out, float* gsum,
                  int n_tiles, int ntx, int ts, int width, int height, int D, int RW, int C,
                  int G, long long n_rows, cudaStream_t stream) {
  size_t bytes = 0;
  cudaError_t e = prepare_geom<OutT, NP, kGhost>(D, &bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = geom_config(G * n_tiles, C, bytes, stream, attr);
  e = cudaLaunchKernelEx(&cfg, train_bwd_geom_kernel<OutT, NP, kGhost>, geom, cols, gimg, hterm,
                         grem0, tile_starts, tile_ends, padded_starts, blocks_done, out, gsum,
                         ntx, ts, width, height, D, RW, C, G);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (G > 1) {
    const int col0 = RW == kGeomGrads ? 0 : D;
    return static_cast<int>(add_groups(gsum, tile_starts, tile_ends, padded_starts, blocks_done,
                                       out, n_tiles, n_rows, kGeomGrads, G, RW, col0, kGeomGrads,
                                       RW - col0 - kGeomGrads, stream));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_geom(const float* geom, const float* cols, const float* gimg, const float* hterm,
                const float* grem0, const int* tile_starts, const int* tile_ends,
                const int* padded_starts, const int* blocks_done, OutT* out, float* gsum,
                int n_tiles, int ntx, int ts, int width, int height, int D, int RW, int C, int P,
                int G, long long n_rows, cudaStream_t stream) {
  cudaError_t e = check_geom(ts, D, RW, C, P, G);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (G > 1 && gsum == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // geom_xy's blocks tile only tiles 16 and 32 (at P >= 8, where C P G = ts^2)
  const bool ghost = ghost_tile(ts);
#define TPUGS_GEOM_LAUNCH(NP, GHOST)                                                           \
  launch_geom_p<OutT, NP, GHOST>(geom, cols, gimg, hterm, grem0, tile_starts, tile_ends,      \
                                 padded_starts, blocks_done, out, gsum, n_tiles, ntx, ts,     \
                                 width, height, D, RW, C, G, n_rows, stream)
  switch (P) {
    case 64: return ghost ? TPUGS_GEOM_LAUNCH(64, true) : TPUGS_GEOM_LAUNCH(64, false);
    case 32: return ghost ? TPUGS_GEOM_LAUNCH(32, true) : TPUGS_GEOM_LAUNCH(32, false);
    case 16: return ghost ? TPUGS_GEOM_LAUNCH(16, true) : TPUGS_GEOM_LAUNCH(16, false);
    case 8: return ghost ? TPUGS_GEOM_LAUNCH(8, true) : TPUGS_GEOM_LAUNCH(8, false);
    case 4: return TPUGS_GEOM_LAUNCH(4, true);
    case 2: return TPUGS_GEOM_LAUNCH(2, true);
    default: return TPUGS_GEOM_LAUNCH(1, true);
  }
#undef TPUGS_GEOM_LAUNCH
}

template <int NP, bool kGhost>
int max_geom_clusters_p(int C, int D) {
  size_t bytes = 0;
  cudaError_t e = prepare_geom<float, NP, kGhost>(D, &bytes);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = geom_config(1, C, bytes, nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, train_bwd_geom_kernel<float, NP, kGhost>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// Clusters of the geometry kernel at (ts, D) that can be resident at once
// (geometry rows, RW = 8), or minus a CUDA error.
int max_geom_clusters(int ts, int D) {
  const int P = geom_pixels(D);
  if (D < 1 || P == 0 || ts < 1) return -static_cast<int>(cudaErrorInvalidValue);
  const int ranks = (ts * ts + P - 1) / P;
  const int G = (ranks + kMaxGeomCluster - 1) / kMaxGeomCluster;
  const int C = (ranks + G - 1) / G;
  const bool ghost = ghost_tile(ts);
#define TPUGS_GEOM_RESIDENT(NP, GHOST) max_geom_clusters_p<NP, GHOST>(C, D)
  switch (P) {
    case 64: return ghost ? TPUGS_GEOM_RESIDENT(64, true) : TPUGS_GEOM_RESIDENT(64, false);
    case 32: return ghost ? TPUGS_GEOM_RESIDENT(32, true) : TPUGS_GEOM_RESIDENT(32, false);
    case 16: return ghost ? TPUGS_GEOM_RESIDENT(16, true) : TPUGS_GEOM_RESIDENT(16, false);
    case 8: return ghost ? TPUGS_GEOM_RESIDENT(8, true) : TPUGS_GEOM_RESIDENT(8, false);
    case 4: return TPUGS_GEOM_RESIDENT(4, true);
    case 2: return TPUGS_GEOM_RESIDENT(2, true);
    default: return TPUGS_GEOM_RESIDENT(1, true);
  }
#undef TPUGS_GEOM_RESIDENT
}

}  // namespace
}  // namespace tpugs

#define TPUGS_TRAIN_BWD_ARGS                                                                  \
  const float *geom, const float *cols, const float *gimg, const float *hterm,              \
      const float *grem0, const int *tile_starts, const int *tile_ends,                     \
      const int *padded_starts, const int *blocks_done
#define TPUGS_TRAIN_BWD_PASS                                                                  \
  geom, cols, gimg, hterm, grem0, tile_starts, tile_ends, padded_starts, blocks_done

// The cluster kernel, for D <= 256, at (C, P, G) from
// raster/train.py::train_layout; gsum (f32, T_padded * G * RW, with
// n_rows = T_padded) holds the pixel groups' partial rows where G > 1 (else
// null), and a second kernel adds them into out.
extern "C" int tpugs_train_bwd_f32(TPUGS_TRAIN_BWD_ARGS, float* out, float* gsum, int n_tiles,
                                   int ntx, int ts, int width, int height, int D, int RW, int C,
                                   int P, int G, long long n_rows, cudaStream_t stream) {
  return tpugs::launch_cluster<float>(TPUGS_TRAIN_BWD_PASS, out, gsum, n_tiles, ntx, ts, width,
                                      height, D, RW, C, P, G, n_rows, stream);
}

extern "C" int tpugs_train_bwd_bf16(TPUGS_TRAIN_BWD_ARGS, __nv_bfloat16* out, float* gsum,
                                    int n_tiles, int ntx, int ts, int width, int height, int D,
                                    int RW, int C, int P, int G, long long n_rows,
                                    cudaStream_t stream) {
  return tpugs::launch_cluster<__nv_bfloat16>(TPUGS_TRAIN_BWD_PASS, out, gsum, n_tiles, ntx, ts,
                                              width, height, D, RW, C, P, G, n_rows, stream);
}

// The colour slices (the row's columns [0, D)), at (C, P, G, S, Ns) from
// train_layout, gsum as for the cluster kernel; cols, hterm and grem0 are
// not read.
extern "C" int tpugs_train_bwd_colour_f32(TPUGS_TRAIN_BWD_ARGS, float* out, float* gsum,
                                          int n_tiles, int ntx, int ts, int width, int height,
                                          int D, int RW, int C, int P, int G, int S, int Ns,
                                          long long n_rows, cudaStream_t stream) {
  return tpugs::launch_colour<float>(geom, gimg, tile_starts, tile_ends, padded_starts,
                                     blocks_done, out, gsum, n_tiles, ntx, ts, width, height, D,
                                     RW, C, P, G, S, Ns, n_rows, stream);
}

extern "C" int tpugs_train_bwd_colour_bf16(TPUGS_TRAIN_BWD_ARGS, __nv_bfloat16* out,
                                           float* gsum, int n_tiles, int ntx, int ts, int width,
                                           int height, int D, int RW, int C, int P, int G, int S,
                                           int Ns, long long n_rows, cudaStream_t stream) {
  return tpugs::launch_colour<__nv_bfloat16>(geom, gimg, tile_starts, tile_ends, padded_starts,
                                             blocks_done, out, gsum, n_tiles, ntx, ts, width,
                                             height, D, RW, C, P, G, S, Ns, n_rows, stream);
}

// The geometry cluster kernel at (C, P, G) from raster/train.py::geom_cluster:
// rows of the 8 geometry columns (RW = 8), or train_rows' columns D..RW
// and the skipped blocks' whole rows (RW = D + 8 rounded up to 4); gsum,
// f32 T_padded * G * 8 (n_rows = T_padded), holds the pixel groups' sums
// where G > 1 (else it may be null), and a second kernel adds them into
// out.
extern "C" int tpugs_train_bwd_geom_f32(TPUGS_TRAIN_BWD_ARGS, float* out, float* gsum,
                                        int n_tiles, int ntx, int ts, int width, int height,
                                        int D, int RW, int C, int P, int G, long long n_rows,
                                        cudaStream_t stream) {
  return tpugs::launch_geom<float>(TPUGS_TRAIN_BWD_PASS, out, gsum, n_tiles, ntx, ts, width,
                                   height, D, RW, C, P, G, n_rows, stream);
}

extern "C" int tpugs_train_bwd_geom_bf16(TPUGS_TRAIN_BWD_ARGS, __nv_bfloat16* out, float* gsum,
                                         int n_tiles, int ntx, int ts, int width, int height,
                                         int D, int RW, int C, int P, int G, long long n_rows,
                                         cudaStream_t stream) {
  return tpugs::launch_geom<__nv_bfloat16>(TPUGS_TRAIN_BWD_PASS, out, gsum, n_tiles, ntx, ts,
                                           width, height, D, RW, C, P, G, n_rows, stream);
}

// Resident clusters of the cluster kernel at tile ts and D channels (bf16
// or f32 rows), or minus a CUDA error.
extern "C" int tpugs_train_bwd_max_clusters(int bf16, int ts, int D) {
  return bf16 ? tpugs::max_clusters<__nv_bfloat16>(ts, D) : tpugs::max_clusters<float>(ts, D);
}

// Resident clusters of one colour slice Ns columns wide at tile ts.
extern "C" int tpugs_train_bwd_colour_max_clusters(int bf16, int ts, int Ns) {
  return bf16 ? tpugs::max_colour_clusters<__nv_bfloat16>(ts, Ns)
              : tpugs::max_colour_clusters<float>(ts, Ns);
}

// Resident clusters of the geometry kernel at tile ts and D (its (C, P)
// from geom_cluster's rule; RW = 8).
extern "C" int tpugs_train_bwd_geom_max_clusters(int ts, int D) {
  return tpugs::max_geom_clusters(ts, D);
}
