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
// Bound on an H100: operations. Per walked (pixel, Gaussian) pair ~30 f32
// operations for the weight, and per pair with a nonzero weight D
// multiply-adds; the bytes are one pack row (32 + 4D bytes) per walked
// intersection and 4(D+1) per pixel out (chip_smoke.py computes it).
// Plain TF32 is ruled out: the trainer's gradients are held at 3e-4 of
// their maximum and the image at 1e-4 of its twin's.
//
// Design (the cluster kernel). The TPU kernel keeps a tile's
// (1024, d_pad) f32 image in VMEM, 536 KB at D = 131, over a Hopper CTA's
// 227 KB. The one-CTA-per-32-channel-slice kernel below (the wide kernel)
// therefore computed every pair's weight once per slice, five times at
// D = 131, and ran the colour product as scalar FMA in a divergent branch.
// Here a tile is a thread-block cluster of C = ts^2 / 128 CTAs (8 at tile
// 32, 2 at tile 16; train_fwd_cluster in raster/train.py, which the C side
// checks) of 256 threads. Rank r owns 128 of the tile's pixels (whole
// pixel rows, row-major) and all D channels; its image stays in wgmma's
// f32 accumulators for the whole walk: warpgroup g owns pixels 64g..64g+63,
// N = D rounded up to 16 columns (72 registers a thread at D = 131). Per
// chunk of 16 Gaussians of a block:
//   (1) the chunk's colour rows, one contiguous run of 16 D floats, came in
//       by 16-byte cp.async a chunk ahead; they are split into TF32 hi and
//       lo parts (hi = x with its low 13 mantissa bits cleared, lo = x - hi,
//       exact) and stored transposed, channel rows over the Gaussians, in
//       wgmma's K-major no-swizzle core matrices (TF32 operands are K-major
//       only);
//   (2) the walk: two lanes per pixel, each computing the alphas of 8 of
//       the chunk's Gaussians (common.cuh's pair_alpha, the _rn intrinsics);
//       the alphas are exchanged by one shuffle each and both lanes carry
//       the exact sequential product (w = alpha * texc * T, texc *= 1 -
//       alpha, in the wide kernel's order), so every weight, T, alpha and
//       blocks_done are bit-identical to the wide kernel's; each lane
//       stores its 8 weights' hi and lo as the A operand (pixel rows);
//   (3) one CTA barrier, then each warpgroup issues the 3xTF32 product
//       img += Whi Chi + Whi Clo + Wlo Chi (m64nNk8, N split into 128, 64,
//       32 and 16; the dropped Wlo Clo is below 2^-20 of each term) and goes
//       on to the next chunk's walk while the tensor cores run; operands are
//       double-buffered, and each warpgroup waits for its previous product
//       just before the next barrier.
// The exit: after each block, each rank ORs T > eps over its pixels (those
// outside the image too, as the wide kernel's __syncthreads_or), stores a
// mark for the block into every rank's slot through DSMEM and passes one
// cluster barrier; every rank then takes the decision the wide kernel,
// the TPU kernel and the twin take. The next block's geometry comes in by
// cp.async during the walk. The image leaves through shared memory, each
// pixel's D channels one contiguous run. Shared memory per CTA: 32768 +
// 384 N bytes of operands and staging (at least 512 (N + 8) for the
// image) and 6,272 static (geometry, marks); 88,064 + 6,272 at D = 131, so
// two CTAs fit on an SM (125-128 registers a thread; 30 resident clusters
// of 8 at tile 32).
//
// Measured at the garden train step (D = 131, tile 32; NVIDIA H100 80GB
// HBM3, 700.00 W; experiments/train_fwd_phases.py, PERF.md): 5.0-5.1 ms
// against 12.6 for the wide kernel in the same call (2.5x). Of it: the
// 3xTF32 product 1.9 ms (at about 88% of the TF32 peak over the walked
// pairs, and it does not overlap the walk), the colour staging 1.0 (0.7
// of it the hi/lo split), the alpha evaluations 0.8, the weight stores
// 0.4, the image stores 0.3, the exit exchange nothing measurable; one CTA
// per SM instead of two costs 1.9 ms more. Tried and taken out: skipping
// the product of chunks whose weights are all 0 for a warpgroup (+0.6 ms),
// geometry in 16- and 8-byte slots instead of six 4-byte arrays (+0.1).
//
// Channel slices (every D). A thread's accumulators hold at most 256
// columns, so the channels are cut into S slices of Ns = 16 ceil(D / 16 S)
// columns (S = ceil(D / SLICE_CHANNELS); raster/train.py::train_fwd_cluster,
// which the C side checks), and each (tile, slice) is a cluster of its own:
// grid C * S * n_tiles, cluster c = S tile + s. Slice s owns channels
// [s Ns, s Ns + ns), ns = min(Ns, D - s Ns); its colour staging brings in ns
// floats of each of the chunk's 16 rows, 16 runs D floats apart (16-byte
// cp.async where D % 4 == 0, else 4-byte; with S = 1 the chunk's rows are
// one run of 16 D floats, as before). Every slice walks the tile's pairs
// with the same instructions in the same order, so every slice computes
// the same weights and takes the same exit; slice 0 alone writes alpha and
// blocks_done. At the D = 512 feature image (tile 16, trans_eps 0; NVIDIA
// H100 80GB HBM3, 700.00 W; PERF.md): 17.5 ms against 43.7 for the wide
// kernel; slices 256 columns wide (one CTA per SM) 1-3% faster than 128
// (two CTAs per SM, twice the walks); of the 17.5 ms the walks take 5.6,
// the product 5.9, the colour staging and split 6.0; skipping the product
// of all-zero chunks costs 0.4 ms more here too.
//
// Tiles other than 16 and 32, whose pixels do not split into ranks of 128,
// take the wide kernel at the end of this file (tpugs_train_fwd_wide).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "common.cuh"

namespace tpugs {
namespace {

constexpr int kGeomCols = 8;

// ------------------------------------------------------- the cluster kernel

constexpr int kPix = 128;          // pixels per rank; PIXELS_PER_RANK in raster/train.py
constexpr int kThreads = 256;      // two warpgroups; two lanes per pixel in the walk
constexpr int kKC = 16;            // Gaussians per chunk
constexpr int kChunks = kBlock / kKC;
constexpr int kMaxSliceD = 256;    // a slice's widest: CLUSTER_MAX_CHANNELS in raster/train.py
constexpr int kMaxCluster = 8;     // portable cluster size: ts = 32 gives C = 8
static_assert(kChunks % 2 == 0, "operand buffers alternate by chunk across blocks");

// Operands in wgmma's K-major no-swizzle layout: core matrices of 8 rows
// (pixels of W, channels of C) x 16 bytes (4 Gaussians); the chunk's 4 core
// matrices along K are adjacent (LBO 128 B), 8-row groups follow (SBO).
constexpr uint32_t kLbo = 128;
constexpr uint32_t kSbo = kLbo * (kKC / 4);
__device__ __forceinline__ int op_off(int row, int k) {
  return (row >> 3) * (kSbo / 4) + (k >> 2) * (kLbo / 4) + (row & 7) * 4 + (k & 3);
}

// Shared memory of one rank, in floats: W[2 buffers][hi, lo][kPix x kKC],
// C[2][hi, lo][N x kKC], the raw colour rows Raw[2][kKC x N]; after the
// walk the same bytes stage the image, [kPix][N + 8] (rows 8 floats apart
// mod 32 banks, so the accumulators' float2 stores do not conflict).
__host__ __device__ constexpr int w_floats() { return 4 * kPix * kKC; }
__host__ __device__ constexpr int c_floats(int N) { return 4 * N * kKC; }
__host__ __device__ constexpr int image_ld(int N) { return N + 8; }
__host__ __device__ constexpr size_t cluster_bytes(int N) {
  return size_t(w_floats() + c_floats(N) + 2 * kKC * N > kPix * image_ld(N)
                    ? w_floats() + c_floats(N) + 2 * kKC * N
                    : kPix * image_ld(N)) * sizeof(float);
}

// x's TF32 part: its low 13 mantissa bits cleared, so x - hi is exact and
// |x - hi| < 2^-10 |x|.
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// Orders this thread's shared-memory writes before the tensor cores'
// (asynchronous proxy) reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(kLbo >> 4) << 16 | static_cast<uint64_t>(kSbo >> 4) << 32;
}

// d (N/2 floats of this thread) += A B^T over K = 8, TF32 in, f32 out.
template <int N>
__device__ __forceinline__ void mma_tf32(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void mma_tf32<16>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_tf32<32>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_tf32<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_tf32<128>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d += A (64 x 8) B (8 x 16 NB): the N columns in instructions of 128, 64,
// 32 and 16; OFF counts 16-column groups already issued.
template <int NB, int OFF = 0>
__device__ __forceinline__ void mma_cols(float* d, uint64_t da, uint32_t b_addr) {
  constexpr int REM = NB - OFF;
  constexpr int STEP = REM >= 8 ? 8 : REM >= 4 ? 4 : REM >= 2 ? 2 : 1;
  if constexpr (REM > 0) {
    mma_tf32<16 * STEP>(d + 8 * OFF, da, desc(b_addr + OFF * 2 * kSbo));
    mma_cols<NB, OFF + STEP>(d, da, b_addr);
  }
}

// One chunk's product for this warpgroup: img += Whi Chi + Whi Clo + Wlo Chi
// over the chunk's 16 Gaussians (two k-steps of 8).
template <int NB>
__device__ __forceinline__ void mma_chunk(float* d, const float* Wh, const float* Wl,
                                          const float* Ch, const float* Cl, int wg) {
  const uint32_t ah = smem_addr(Wh) + wg * 8 * kSbo, al = smem_addr(Wl) + wg * 8 * kSbo;
  const uint32_t bh = smem_addr(Ch), bl = smem_addr(Cl);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t k = s * 2 * kLbo;
    mma_cols<NB>(d, desc(ah + k), bh + k);
    mma_cols<NB>(d, desc(ah + k), bl + k);
    mma_cols<NB>(d, desc(al + k), bh + k);
  }
  wgmma_commit();
}

// The block's geometry (rows row0..row0+127 of the (T, 8) pack) into g by
// 4-byte cp.async, threads 0..127 one row each; not committed on its own.
__device__ __forceinline__ void stage_geom(BlockGeom& g, const float* __restrict__ geom,
                                           long long row0, int tid) {
  if (tid < kBlock) {
    const float* r = geom + (row0 + tid) * kGeomCols;
    cp_async4(&g.mx[tid], r);
    cp_async4(&g.my[tid], r + 1);
    cp_async4(&g.ca[tid], r + 2);
    cp_async4(&g.cb[tid], r + 3);
    cp_async4(&g.cc[tid], r + 4);
    cp_async4(&g.op[tid], r + 5);
  }
}

// A chunk's colour rows (row .. row + 15), channels c0 .. c0 + ns - 1 of
// each, into Raw as [kKC][ns]. With ns == D the rows are one contiguous run
// of 16 D floats (16-byte aligned since rows are multiples of 16); else 16
// runs of ns floats, D apart: by 16 bytes where D % 4 == 0 (then c0 and ns
// are multiples of 4 too), else by 4.
__device__ __forceinline__ void stage_colours(float* Raw, const float* __restrict__ cols,
                                              long long row, int D, int c0, int ns, int tid) {
  const float* src = cols + row * D + c0;
  if (ns == D) {
    for (int v = tid; v < kKC * D / 4; v += kThreads) cp_async16(Raw + 4 * v, src + 4 * v);
  } else if ((D & 3) == 0) {
    const int nv = ns >> 2;
    for (int v = tid; v < kKC * nv; v += kThreads) {
      const int i = v / nv, k = v - i * nv;
      cp_async16(Raw + i * ns + 4 * k, src + static_cast<long long>(i) * D + 4 * k);
    }
  } else {
    for (int v = tid; v < kKC * ns; v += kThreads) {
      const int i = v / ns, k = v - i * ns;
      cp_async4(Raw + i * ns + k, src + static_cast<long long>(i) * D + k);
    }
  }
}

// Raw (16 Gaussians x D, D the slice's ns) into Ch/Cl: channel n's 4
// Gaussians 4a..4a+3 as one 16-byte row of a core matrix, hi and lo.
// Channels [D, N) hold the zeros that zero_pad_colours wrote.
template <int N>
__device__ __forceinline__ void split_colours(float* Ch, float* Cl, const float* Raw, int D,
                                              int tid) {
#pragma unroll
  for (int e = tid; e < 4 * N; e += kThreads) {
    const int a = e / N, n = e - a * N;
    if (n >= D) continue;
    const float* r = Raw + 4 * a * D + n;
    const float x0 = r[0], x1 = r[D], x2 = r[2 * D], x3 = r[3 * D];
    const float4 hi = make_float4(tf32_hi(x0), tf32_hi(x1), tf32_hi(x2), tf32_hi(x3));
    *reinterpret_cast<float4*>(Ch + op_off(n, 4 * a)) = hi;
    *reinterpret_cast<float4*>(Cl + op_off(n, 4 * a)) =
        make_float4(x0 - hi.x, x1 - hi.y, x2 - hi.z, x3 - hi.w);
  }
}

// Channels [D, N) of both colour buffers, hi and lo: zeros, once.
template <int N>
__device__ __forceinline__ void zero_pad_colours(float* Cbuf, int D, int tid) {
  const int pad = N - D;
  for (int e = tid; e < 4 * 4 * pad; e += kThreads) {
    const int part = e / (4 * pad), a = e / pad % 4, n = D + e % pad;
    *reinterpret_cast<float4*>(Cbuf + part * N * kKC + op_off(n, 4 * a)) =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// The walk of one chunk (Gaussians i0..i0+15) for pixel ``pw`` (its row of
// W): lane half q computes the alphas of Gaussians i0 + 8q +
// 0..7, the halves swap them by shuffles, and both carry the sequential
// product in order; each stores its own 8 weights, hi and lo.
__device__ __forceinline__ void walk_chunk(const BlockGeom& g, int i0, int q, float px,
                                           float py, int remaining, float trans, float& texc,
                                           float* Wh, float* Wl, int pw) {
  float mine[8], w[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int i = i0 + 8 * q + e;
    mine[e] = pair_alpha(g, i, px, py, i < remaining);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float other = __shfl_xor_sync(0xffffffffu, mine[e], 16);
      const float alpha = (h == q) ? mine[e] : other;
      const float wv = alpha * texc * trans;
      texc *= 1.0f - alpha;
      if (h == q) w[e] = wv;
    }
  }
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int o = op_off(pw, 8 * q + 4 * v);
    const float4 hi = make_float4(tf32_hi(w[4 * v]), tf32_hi(w[4 * v + 1]),
                                  tf32_hi(w[4 * v + 2]), tf32_hi(w[4 * v + 3]));
    *reinterpret_cast<float4*>(Wh + o) = hi;
    *reinterpret_cast<float4*>(Wl + o) = make_float4(w[4 * v] - hi.x, w[4 * v + 1] - hi.y,
                                                     w[4 * v + 2] - hi.z, w[4 * v + 3] - hi.w);
  }
}

// Grid C * S * n_tiles in clusters of (C, 1, 1): the C CTAs of cluster c
// take tile c / S and channel slice c % S (Ns = 16 NB columns), rank r the
// tile's pixel rows [r * kPix / ts, (r + 1) * kPix / ts).
template <int NB>
__global__ void __launch_bounds__(kThreads, NB <= 9 ? 2 : 1)
train_fwd_cluster_kernel(const float* __restrict__ geom, const float* __restrict__ cols,
                         const int* __restrict__ tile_starts, const int* __restrict__ tile_ends,
                         const int* __restrict__ padded_starts, float* __restrict__ img,
                         float* __restrict__ alpha_out, int* __restrict__ blocks_done, int ntx,
                         int ts, int width, int height, int D, float trans_eps, int C, int S) {
  constexpr int N = 16 * NB;
  extern __shared__ __align__(128) float smem[];
  float* Wbuf = smem;                      // [2][hi, lo][kPix * kKC]
  float* Cbuf = smem + w_floats();         // [2][hi, lo][N * kKC]
  float* Raw = Cbuf + c_floats(N);         // [2][kKC * N]
  __shared__ BlockGeom gs[2];
  __shared__ int exit_mark[2];  // block b's mark, b + 1, in slot b % 2

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;                       // warpgroup: pixels 64 wg .. 64 wg + 63
  const int q = lane >> 4;                        // lane half of the pixel in the walk
  const int pl = 16 * warp + (lane & 15);         // this thread's pixel of the rank
  const int rank = static_cast<int>(cluster_rank());
  const int tile = blockIdx.x / C / S;
  const int slice = blockIdx.x / C % S;
  const int c0 = slice * N, ns = min(N, D - c0);  // the slice's channels
  const int count = tile_ends[tile] - tile_starts[tile];
  const int nb = (count + kBlock - 1) / kBlock;
  const long long pstart = padded_starts[tile];
  const int x0 = (tile % ntx) * ts;
  const int y0 = (tile / ntx) * ts + rank * (kPix / ts);  // the rank's first pixel row
  const float px = static_cast<float>(x0 + pl % ts) + 0.5f;
  const float py = static_cast<float>(y0 + pl / ts) + 0.5f;

  if (tid < 2) exit_mark[tid] = 0;
  zero_pad_colours<N>(Cbuf, ns, tid);
  if (nb > 0) {
    stage_geom(gs[0], geom, pstart, tid);
    stage_colours(Raw, cols, pstart, D, c0, ns, tid);
    cp_async_commit();
  }
  cluster_arrive();  // every CTA has started and set its marks (waited before the first mark)

  float acc[8 * NB];
#pragma unroll
  for (int i = 0; i < 8 * NB; ++i) acc[i] = 0.0f;
  float trans = 1.0f;
  bool keep = 1.0f > trans_eps;
  int b = 0;
  cp_async_wait_all();
  __syncthreads();
  for (; b < nb && keep; ++b) {
    const long long row0 = pstart + static_cast<long long>(b) * kBlock;
    const BlockGeom& g = gs[b & 1];
    if (b + 1 < nb) stage_geom(gs[(b + 1) & 1], geom, row0 + kBlock, tid);
    const int remaining = count - b * kBlock;
    float texc = 1.0f;
    for (int j = 0; j < kChunks; ++j) {
      const int buf = j & 1;
      float* Wh = Wbuf + buf * 2 * kPix * kKC;
      float* Wl = Wh + kPix * kKC;
      float* Ch = Cbuf + buf * 2 * N * kKC;
      float* Cl = Ch + N * kKC;
      split_colours<N>(Ch, Cl, Raw + buf * kKC * N, ns, tid);
      if (j + 1 < kChunks || b + 1 < nb)  // the next chunk's colours, by cp.async
        stage_colours(Raw + (buf ^ 1) * kKC * N, cols, row0 + (j + 1) * kKC, D, c0, ns, tid);
      cp_async_commit();
      walk_chunk(g, j * kKC, q, px, py, remaining, trans, texc, Wh, Wl, pl);
      fence_proxy_async();
      cp_async_wait_all();
      wgmma_wait_all();  // this warpgroup's previous product has read its operands
      __syncthreads();
      mma_chunk<NB>(acc, Wh, Wl, Ch, Cl, wg);
    }
    trans *= texc;
    const int any = __syncthreads_or(trans > trans_eps);
    if (b == 0) cluster_wait();
    if (any && tid < C) st_cluster(map_rank(smem_addr(&exit_mark[b & 1]), tid), b + 1);
    cluster_arrive();
    cluster_wait();
    keep = exit_mark[b & 1] == b + 1;
  }
  if (b == 0) cluster_wait();
  wgmma_wait_all();

  if (slice == 0 && rank == 0 && tid == 0) blocks_done[tile] = b;
  const int xi = x0 + pl % ts, yi = y0 + pl / ts;
  if (slice == 0 && q == 0 && xi < width && yi < height)
    alpha_out[static_cast<long long>(yi) * width + xi] = 1.0f - trans;
  // The image through shared memory, free once every product has read its
  // operands: thread (warp w of the warpgroup, lane l) holds rows 16w + l/4
  // (+8) and columns 8i + 2(l%4) (+1) of the warpgroup's 64 pixels in
  // acc[4i..4i+3]; then warp w writes pixels 16w..16w+15, each one run of
  // the slice's ns floats in device memory.
  constexpr int LD = image_ld(N);
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = 64 * wg + 16 * (warp & 3) + (lane >> 2) + 8 * h;
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
      *reinterpret_cast<float2*>(smem + p * LD + 8 * i + 2 * (lane & 3)) =
          make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  }
  __syncthreads();
  for (int p = 16 * warp; p < 16 * warp + 16; ++p) {
    const int x = x0 + p % ts, y = y0 + p / ts;
    if (x < width && y < height) {
      float* o = img + (static_cast<long long>(y) * width + x) * D + c0;
      for (int c = lane; c < ns; c += 32) o[c] = smem[p * LD + c];
    }
  }
}

cudaLaunchConfig_t cluster_config(int n_clusters, int C, size_t bytes, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * n_clusters, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
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

template <int NB>
cudaError_t prepare(size_t* bytes) {
  *bytes = cluster_bytes(16 * NB);
  cudaError_t e = cudaFuncSetAttribute(train_fwd_cluster_kernel<NB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(*bytes));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(train_fwd_cluster_kernel<NB>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Launches (n_tiles > 0) or, with n_tiles == 0, returns the resident
// clusters in *resident.
template <int NB>
cudaError_t run(const float* geom, const float* cols, const int* tile_starts,
                const int* tile_ends, const int* padded_starts, float* img, float* alpha,
                int* blocks_done, int n_tiles, int ntx, int ts, int width, int height, int D,
                float trans_eps, int C, int S, cudaStream_t stream, int* resident) {
  size_t bytes = 0;
  cudaError_t e = prepare<NB>(&bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(n_tiles > 0 ? S * n_tiles : 1, C, bytes, stream, attr);
  if (n_tiles == 0) return cudaOccupancyMaxActiveClusters(resident, train_fwd_cluster_kernel<NB>, &cfg);
  e = cudaLaunchKernelEx(&cfg, train_fwd_cluster_kernel<NB>, geom, cols, tile_starts, tile_ends,
                         padded_starts, img, alpha, blocks_done, ntx, ts, width, height, D,
                         trans_eps, C, S);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// (C, P, S, Ns) as raster/train.py::train_fwd_cluster gives them: every
// slice Ns columns wide (a multiple of 16, at most kMaxSliceD) and holding
// at least one channel; or an error.
cudaError_t dispatch(const float* geom, const float* cols, const int* tile_starts,
                     const int* tile_ends, const int* padded_starts, float* img, float* alpha,
                     int* blocks_done, int n_tiles, int ntx, int ts, int width, int height,
                     int D, float trans_eps, int C, int P, int S, int Ns, cudaStream_t stream,
                     int* resident) {
  if (D < 1 || S < 1 || Ns < 16 || Ns > kMaxSliceD || Ns % 16 != 0 ||
      static_cast<long long>(S - 1) * Ns >= D || static_cast<long long>(S) * Ns < D ||
      (ts != 16 && ts != 32) || P != kPix || C * P != ts * ts || C > kMaxCluster)
    return cudaErrorInvalidValue;
#define TPUGS_FWD_CASE(nb)                                                                    \
  case nb:                                                                                   \
    return run<nb>(geom, cols, tile_starts, tile_ends, padded_starts, img, alpha, blocks_done, \
                   n_tiles, ntx, ts, width, height, D, trans_eps, C, S, stream, resident);
  switch (Ns / 16) {
    TPUGS_FWD_CASE(1) TPUGS_FWD_CASE(2) TPUGS_FWD_CASE(3) TPUGS_FWD_CASE(4)
    TPUGS_FWD_CASE(5) TPUGS_FWD_CASE(6) TPUGS_FWD_CASE(7) TPUGS_FWD_CASE(8)
    TPUGS_FWD_CASE(9) TPUGS_FWD_CASE(10) TPUGS_FWD_CASE(11) TPUGS_FWD_CASE(12)
    TPUGS_FWD_CASE(13) TPUGS_FWD_CASE(14) TPUGS_FWD_CASE(15) TPUGS_FWD_CASE(16)
    default: return cudaErrorInvalidValue;
  }
#undef TPUGS_FWD_CASE
}

// ------------------------------------ the wide kernel (tiles other than 16, 32)

constexpr int kSliceC = 32;  // channels per CUDA block

// Grid (tile, slice of 32 channels); one thread per pixel (ts*ts threads)
// walks the 128 Gaussians of a block in order, carrying its exclusive
// transmittance in a register (the exact sequential product, as B1), and
// keeps its 32 channel sums in registers. The block's geometry and its 128
// x 32 colour slice are staged in shared memory and read as broadcasts
// (float4). Every slice recomputes the same weights, so every slice takes
// the same exit.
__global__ void __launch_bounds__(1024)
train_fwd_wide_kernel(const float* __restrict__ geom, const float* __restrict__ cols,
                      const int* __restrict__ tile_starts, const int* __restrict__ tile_ends,
                      const int* __restrict__ padded_starts, float* __restrict__ img,
                      float* __restrict__ alpha_out, int* __restrict__ blocks_done, int ntx,
                      int ts, int width, int height, int D, float trans_eps) {
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

#define TPUGS_TRAIN_FWD_ARGS                                                                 \
  const float *geom, const float *cols, const int *tile_starts, const int *tile_ends,      \
      const int *padded_starts, float *img, float *alpha, int *blocks_done, int n_tiles,   \
      int ntx, int ts, int width, int height, int D, float trans_eps

// The cluster kernel in channel slices, for any D at tiles 16 and 32, at
// (C, P, S, Ns) from raster/train.py::train_fwd_cluster.
extern "C" int tpugs_train_fwd(TPUGS_TRAIN_FWD_ARGS, int C, int P, int S, int Ns,
                               cudaStream_t stream) {
  if (n_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tpugs::dispatch(geom, cols, tile_starts, tile_ends, padded_starts,
                                          img, alpha, blocks_done, n_tiles, ntx, ts, width,
                                          height, D, trans_eps, C, P, S, Ns, stream, nullptr));
}

// The wide kernel, for any D >= 1 and ts * ts <= 1024.
extern "C" int tpugs_train_fwd_wide(TPUGS_TRAIN_FWD_ARGS, cudaStream_t stream) {
  if (ts * ts > 1024 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_tiles, (D + tpugs::kSliceC - 1) / tpugs::kSliceC);
  tpugs::train_fwd_wide_kernel<<<grid, ts * ts, 0, stream>>>(
      geom, cols, tile_starts, tile_ends, padded_starts, img, alpha, blocks_done, ntx, ts,
      width, height, D, trans_eps);
  return static_cast<int>(cudaGetLastError());
}

// Resident clusters of the cluster kernel at tile ts and a slice of D <=
// 256 channels, or minus a CUDA error.
extern "C" int tpugs_train_fwd_max_clusters(int ts, int D) {
  int n = 0;
  const cudaError_t e = tpugs::dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                        nullptr, nullptr, 0, 1, ts, 1, 1, D, 0.0f, ts * ts / 128,
                                        128, 1, (D + 15) / 16 * 16, nullptr, &n);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
