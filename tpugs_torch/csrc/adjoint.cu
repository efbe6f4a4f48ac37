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
// Bound on an H100: bytes. A view reads the walked blocks' pack rows and
// the tile features once and writes every row (D + 1 columns): 0.922 ms
// at 3.35 TB/s on the canonical view, of which the rows are 1.9 GB. The
// product, 2 * pairs * (D + 1) FLOP at 989 TFLOP/s in bf16, is 0.40 ms;
// the weights, about 30 f32 operations x 388 M walked pairs at 67 TFLOP/s,
// 0.17 ms.
//
// Design. The TPU kernel runs one grid step per tile with all channels in
// VMEM (1.3 MB), so it computes each block's weights once; a Hopper CTA
// has 227 KB. So a tile is taken by a thread-block cluster of C CTAs, one
// per channel slice of 128 columns (S = DC / 128 slices; C = ceil(S /
// ceil(S / 8)), at most 8, in ceil(S / 8) clusters per tile; a CTA whose
// slice lies past DC walks and shares weights but writes no columns;
// ``adjoint_cluster`` in raster/kernels.py computes C and the grid). The
// CTAs compute each walked block's weights once, between them, and share
// them through distributed shared memory (DSMEM):
//   - the tile's pixels form groups of P (32 in bf16, 16 in f32); group g
//     belongs to cluster rank g mod C for every block, so each pixel's
//     transmittance T is read and written by its owner alone;
//   - per 128-Gaussian block, in rounds of C groups: each rank issues the
//     round's feature rows for its slice with cp.async (16 B, .cg); walks
//     its group, kThreads / P lanes per pixel: each lane computes one
//     Gaussian's alpha of every chunk, the chunk's alphas go round the
//     lanes by shuffles, and every lane carries the pixel's exact
//     sequential product (the _rn pair_alpha of common.cuh, the same
//     instructions and order as B1, so each weight is bit-identical to
//     the one-CTA kernel's); lane q stores the chunk's weights with one
//     16-byte DSMEM store into rank q's W buffer; cluster barrier; then
//     each rank runs the product for its 128 columns over the round's C*P
//     pixels from its own shared memory: C[128 x 128] += w^T F; in bf16
//     one wgmma m64n128k16 per warpgroup and 16 pixels, with W and F laid
//     out in wgmma's no-swizzle core matrices (f32 accumulate); in f32 FMA
//     on an 8 x 8 register tile per thread;
//   - the tile-wide early exit is a cluster-wide OR: each rank ORs its own
//     pixels' T > eps and stores a mark into every rank's flag slot for
//     the block; it is read after the next cluster barrier, so every rank
//     decides what the one-CTA kernel decided.
// Tiles whose ts*ts pixels are not whole groups (kGhost): the last group's
// slots past ts*ts are ghosts, whose T starts at 0 (so all their weights
// are 0 and they vote for the exit) and whose feature rows are staged as
// zeros; the product still runs over whole groups. At tiles 16 and 32 the
// groups are whole and kGhost is false. Each cluster keeps its tile's T in
// a scratch of device memory (n_groups P floats a cluster, the wrapper's),
// so a tile of any size fits; each rank reads and writes only its own
// groups' T there, and reads it back after its own __syncthreads, so the
// rows are those of one cluster walking the whole tile. (T in each CTA's
// shared memory held at most 1024 pixels, tile 32, and was 1.4-2.2% faster
// at tiles 16 and 32 on the canonical view: PERF.md.) The grid puts the
// tile on x (C ceil(S / 8) CTAs a tile), so it takes any number of tiles.
// Every global store is 16 bytes: the product rows (bf16 through a 1-KB
// per-warp stage), and the zero rows of exited blocks. Shared memory per
// CTA: two buffers of C*P pixels x 128 columns (W and F) + 8 KB stage + 3
// KB static; 91 KB at C = 5 in bf16, so two CTAs fit on an SM.
//
// Measured on the canonical view (N = 2^19, 1296 x 840, D = 512, tile
// 32, bf16) on an NVIDIA H100 80GB HBM3 at 700 W, with
// experiments/adjoint_phases.py: 5.5-5.6 ms, against 12.2-12.4 ms for the
// one-CTA-per-slice design it replaced on the same card (B6: 5.7 against
// 13.4); with a WMMA product instead of wgmma this design took 10% more.
// Cutting phases out: the walk 1.8 ms (1.3 of it the DSMEM stores), the
// feature staging 0.9, the product 0.8, the zero rows 0.4; with one CTA
// per SM instead of two it takes 8.3 ms, so it is bound by latency, not
// by any one unit.
//
// B6 — the scatter-write adjoint of the opt-in scatter reduce engine.
// Replaces tpugs/raster/pallas_tiled.py::adjoint_scatter_pallas_raw
// (kernel _make_adjoint_scatter_kernel). It is this kernel instantiated
// with a destination table: row r goes to out + dest[r] * DC instead of
// out + r * DC, at both write sites (the product rows and the zero rows of
// blocks past the early exit, which are real intersections and are
// summed); each thread loads dest once for each row it writes. Weights
// and products are B2's own instructions, so each row is bit-equal to
// B2's. dest is the plan's slot_pos: rows land in the striped layout that
// B7 (stripe_sum.cu) reads in sequence; every padding slot maps to one
// trash row, whose racing writes are harmless because nothing reads it.
// Bound: B2's, plus 4 bytes of dest per written row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cluster.cuh"
#include "common.cuh"

namespace tpugs {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 128;  // channels per CTA; CHANNEL_SLICE in kernels.py
constexpr int kMaxCluster = 8;  // MAX_CLUSTER in kernels.py (portable size)

template <typename T> struct Cfg;
template <> struct Cfg<float> { static constexpr int P = 16, kPad = 4; };
template <> struct Cfg<bf16> { static constexpr int P = 32, kPad = 0; };

template <typename T>
struct Layout {
  static constexpr int P = Cfg<T>::P;          // pixels per group
  static constexpr int K = kThreads / P;       // lanes per pixel in the walk
  static constexpr int V = 16 / sizeof(T);     // elements per 16-byte vector
  static constexpr int LD = kBlock + Cfg<T>::kPad;  // elements per pixel of W and F
  static constexpr size_t kStage = std::is_same<T, bf16>::value ? kWarps * 256 * sizeof(float) : 0;
  __host__ __device__ static size_t buffer(int C) { return size_t(C) * P * LD * sizeof(T); }
  __host__ __device__ static size_t bytes(int C) { return 2 * buffer(C) + kStage; }
  static_assert(kSlice == kBlock, "W and F share one layout");

  // Element offset of (pixel p, column c) in W (columns are Gaussians) or
  // F (channels). bf16: wgmma's no-swizzle core matrices, 8 pixels x 8
  // columns in 128 contiguous bytes, the 16 core matrices of 8 pixels side
  // by side along the columns (2 KB). f32: rows of LD.
  __device__ static int off(int p, int c) {
    if constexpr (std::is_same<T, bf16>::value)
      return (p / 8) * (8 * kBlock) + (c / 8) * 64 + (p % 8) * 8 + c % 8;
    else
      return p * LD + c;
  }
  static_assert(K % V == 0 && K >= kMaxCluster, "a chunk of K weights fills whole vectors, "
                                                "and lane q stores to rank q");
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// Orders this thread's earlier shared-memory writes (plain, cp.async or
// DSMEM) before later reads by the tensor cores' asynchronous proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cluster;" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <typename T> __device__ __forceinline__ uint4 to_vec(const float* w);
template <> __device__ __forceinline__ uint4 to_vec<float>(const float* w) {
  return make_uint4(__float_as_uint(w[0]), __float_as_uint(w[1]), __float_as_uint(w[2]),
                    __float_as_uint(w[3]));
}
template <> __device__ __forceinline__ uint4 to_vec<bf16>(const float* w) {
  return make_uint4(pack_bf2(w[0], w[1]), pack_bf2(w[2], w[3]), pack_bf2(w[4], w[5]),
                    pack_bf2(w[6], w[7]));
}

// Row r of the plan is written to output row r (B2) or dest[r] (B6).
template <bool kScatter>
__device__ __forceinline__ long long out_row(const int* __restrict__ dest, long long r) {
  if constexpr (kScatter) {
    return dest[r];
  } else {
    return r;
  }
}

// ------------------------------------------------------------- phases

// The round's feature rows F[pl][c] = feats[pix_base + pl][c0 + c] for
// c0 + c < D, 1 at column D, 0 after; whole 16-byte vectors of features
// by cp.async (committed as one group), the others built in registers and
// stored as 16 bytes. Vectors that start at or past column D hold no
// feature and are the same in every round: fill_constant_columns wrote
// them once. With kGhost, rows pl >= nreal (ghosts) get zero features.
template <typename T, bool kGhost>
__device__ __forceinline__ void stage_features(T* Fs, const T* __restrict__ feats,
                                               long long pix_base, int npix, int nreal, int c0,
                                               int D, bool vec_ok, int tid) {
  using L = Layout<T>;
  constexpr int VPR = kSlice / L::V;
  for (int idx = tid; idx < npix * VPR; idx += kThreads) {
    const int pl = idx / VPR;
    const int col = c0 + (idx % VPR) * L::V;
    if (col >= D) continue;
    const T* src = feats + (pix_base + pl) * D + col;
    T* dst = Fs + L::off(pl, (idx % VPR) * L::V);
    if (kGhost && pl >= nreal) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    } else if (vec_ok && col + L::V <= D) {
      cp_async16(dst, src);
    } else {  // built in registers, stored as one vector
      alignas(16) T v[L::V];
#pragma unroll
      for (int e = 0; e < L::V; ++e) {
        const int c = col + e;
        v[e] = c < D ? src[e] : from_f<T>(c == D ? 1.0f : 0.0f);
      }
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
  cp_async_commit();
}

// F's vectors at columns >= D (1 at column D, 0 after), for all ``rows``.
template <typename T>
__device__ __forceinline__ void fill_constant_columns(T* Fs, int rows, int c0, int D, int tid) {
  using L = Layout<T>;
  constexpr int VPR = kSlice / L::V;
  for (int idx = tid; idx < rows * VPR; idx += kThreads) {
    const int col = c0 + (idx % VPR) * L::V;
    if (col < D) continue;
    alignas(16) T v[L::V];
#pragma unroll
    for (int e = 0; e < L::V; ++e) v[e] = from_f<T>(col + e == D ? 1.0f : 0.0f);
    *reinterpret_cast<uint4*>(Fs + L::off(idx / VPR, (idx % VPR) * L::V)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// Pixel ``p`` of group slot ``slot`` walks the block's Gaussians, K lanes
// per pixel (lane q of the pixel computes Gaussian i0 + q of each chunk of
// K); every lane carries the exact product. Lane q < n_dst stores each
// chunk's weights into rank q's W row ``slot * P + pl`` (w_dst, already
// mapped to that rank). Updates the pixel's T.
template <typename T>
__device__ __forceinline__ void walk_pixel(const BlockGeom& g, float* Tpix, int p, int pl,
                                           int slot, int q, uint32_t w_dst, bool store,
                                           int remaining, int x0, int y0, int ts, int width,
                                           int height) {
  using L = Layout<T>;
  const float px = static_cast<float>(x0 + p % ts) + 0.5f;
  const float py = static_cast<float>(y0 + p / ts) + 0.5f;
  const bool in_img = px < static_cast<float>(width) && py < static_cast<float>(height);
  const float trans = Tpix[p];
  float texc = 1.0f;
  const int wp = slot * L::P + pl;  // the pixel's row of W
  for (int i0 = 0; i0 < kBlock; i0 += L::K) {
    const float mine = pair_alpha(g, i0 + q, px, py, i0 + q < remaining);
    float w[L::K];
#pragma unroll
    for (int m = 0; m < L::K; ++m) {
      const float alpha = __shfl_sync(0xffffffffu, mine, m, L::K);
      const float wm = alpha * texc * trans;
      texc *= 1.0f - alpha;
      w[m] = in_img ? wm : 0.0f;
    }
    if (store) {
#pragma unroll
      for (int v = 0; v < L::K / L::V; ++v)
        st_cluster(w_dst + static_cast<uint32_t>(L::off(wp, i0 + v * L::V) * sizeof(T)),
                   to_vec<T>(w + v * L::V));
    }
  }
  if (q == 0) Tpix[p] = trans * texc;
}

// The zero rows of a block past the tile's exit: 16-byte stores.
template <typename T, bool kScatter>
__device__ __forceinline__ void zero_rows(T* __restrict__ out, const int* __restrict__ dest,
                                          long long row0, int DC, int c0, int tid) {
  constexpr int VPR = kSlice * sizeof(T) / 16;
  for (int idx = tid; idx < kBlock * VPR; idx += kThreads)
    *reinterpret_cast<uint4*>(out + out_row<kScatter>(dest, row0 + idx / VPR) * DC + c0 +
                              (idx % VPR) * (16 / sizeof(T))) = make_uint4(0, 0, 0, 0);
}

// bf16: C[128 x 128] on the tensor cores with wgmma: warpgroup g (threads
// 128g..128g+127) owns rows 64g..64g+63, and per 16 pixels issues one
// m64n128k16 product with A = w^T (W, Gaussian-major) and B = F
// (channel-major), both read from shared memory through descriptors.
struct WgmmaProduct {
  using L = Layout<bf16>;
  static constexpr uint32_t kLbo = 8 * kBlock * sizeof(bf16);  // next 8 pixels (K): 2 KB
  static constexpr uint32_t kSbo = 128;                        // next 8 rows or columns
  float d[64];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  }

  // No-swizzle matrix descriptor of the operand at shared address addr.
  __device__ static uint64_t desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           static_cast<uint64_t>(kLbo >> 4) << 16 | static_cast<uint64_t>(kSbo >> 4) << 32;
  }

  __device__ void mma(uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));  // p: accumulate into d
  }

  // Over pixels [0, npix); every thread of both warpgroups calls it.
  __device__ void accumulate(const bf16* Ws, const bf16* Fs, int npix, int tid) {
    const uint32_t a0 = smem_addr(Ws) + (tid / 128) * 8 * kSbo;
    const uint32_t b0 = smem_addr(Fs);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    for (int k = 0; k < npix / 16; ++k) mma(desc(a0 + 2 * k * kLbo), desc(b0 + 2 * k * kLbo));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  }

  // Thread l of warp w of warpgroup g holds rows 64g + 16w + l/4 (+8),
  // columns 8i + 2(l%4) (+1) in d[4i..4i+3]. Each 16 x 16 tile goes
  // through the warp's own 1-KB stage: lane l writes 8 columns of row l/2
  // as one 16-byte store.
  template <bool kScatter>
  __device__ void store(bf16* __restrict__ out, const int* __restrict__ dest, long long row0,
                        int DC, int c0, float* stage, int tid) {
    const int warp = tid / 32, lane = tid % 32;
    float* st = stage + warp * 256;
    const long long orow = out_row<kScatter>(dest, row0 + warp * 16 + lane / 2);
    bf16* o = out + orow * DC + c0 + (lane % 2) * 8;
    const int r = lane / 4, c = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < kSlice / 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the tile's two groups of 8 columns
        const float* q = d + 8 * j + 4 * h;
        *reinterpret_cast<float2*>(st + r * 16 + 8 * h + c) = make_float2(q[0], q[1]);
        *reinterpret_cast<float2*>(st + (r + 8) * 16 + 8 * h + c) = make_float2(q[2], q[3]);
      }
      __syncwarp();
      const float4 a = *reinterpret_cast<const float4*>(st + lane * 8);
      const float4 b = *reinterpret_cast<const float4*>(st + lane * 8 + 4);
      const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      *reinterpret_cast<uint4*>(o + j * 16) = to_vec<bf16>(w);
      __syncwarp();
    }
  }
};

// f32: C[128 x 128] by FMA, an 8 x 8 register tile per thread.
struct FmaProduct {
  using L = Layout<float>;
  float acc[8][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  __device__ void accumulate(const float* Ws, const float* Fs, int npix, int tid) {
    const int tg = tid / 16, tc = tid % 16;
    for (int p = 0; p < npix; ++p) {
      const float4 a0 = *reinterpret_cast<const float4*>(Ws + p * L::LD + tg * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(Ws + p * L::LD + tg * 8 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Fs + p * L::LD + tc * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(Fs + p * L::LD + tc * 8 + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
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
using ProductOf = typename std::conditional<std::is_same<T, bf16>::value, WgmmaProduct,
                                            FmaProduct>::type;

// Grid grid_x * n_tiles in clusters of (C, 1, 1), grid_x = C * ceil(S / 8):
// blockIdx.x % grid_x is the channel slice, the cluster's CTAs share one
// tile, blockIdx.x / grid_x. ``tscratch`` holds grid_x / C clusters' T of
// n_groups P floats for each tile.
template <typename T, bool kScatter, bool kGhost>
__global__ void __launch_bounds__(kThreads, 2)
adjoint_kernel(const float* __restrict__ pack, const int* __restrict__ tile_starts,
               const int* __restrict__ tile_ends, const int* __restrict__ padded_starts,
               const T* __restrict__ feats, const int* __restrict__ dest, T* __restrict__ out,
               float* __restrict__ tscratch, int ntx, int ts, int width, int height, int D,
               int DC, float trans_eps, int vec_ok, int C, int grid_x) {
  using L = Layout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ws = reinterpret_cast<T*>(smem);
  T* Fs = reinterpret_cast<T*>(smem + L::buffer(C));
  float* stage = reinterpret_cast<float*>(smem + 2 * L::buffer(C));
  __shared__ BlockGeom g;
  __shared__ int exit_mark[2];  // block b's mark, b + 1, in slot b % 2

  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster_rank());
  const int slot = static_cast<int>(blockIdx.x % grid_x);  // the CTA's slice of the tile
  const int c0 = slot * kSlice;
  const bool has_cols = c0 < DC;
  // ranks [0, n_dst) of this cluster have columns and read W
  const int n_dst = min(C, DC / kSlice - (slot - rank));
  const int tile = blockIdx.x / grid_x;
  const int tspx = ts * ts;
  const int n_groups = kGhost ? (tspx + L::P - 1) / L::P : tspx / L::P;
  // the tile's T, in the cluster's scratch
  float* const Tpix =
      tscratch + (static_cast<long long>(tile) * (grid_x / C) + slot / C) * n_groups * L::P;
  const int n_rounds = (n_groups + C - 1) / C;
  const int count = tile_ends[tile] - tile_starts[tile];
  const int nb = (count + kBlock - 1) / kBlock;
  const long long pstart = padded_starts[tile];
  const int x0 = (tile % ntx) * ts;
  const int y0 = (tile / ntx) * ts;
  const int pl = tid / L::K, q = tid % L::K;  // pixel of the group, lane of the pixel
  const uint32_t w_dst = map_rank(smem_addr(Ws), q < n_dst ? q : 0);

  for (int p = tid; p < n_groups * L::P; p += kThreads)  // its own groups'
    if ((p / L::P) % C == rank) Tpix[p] = !kGhost || p < tspx ? 1.0f : 0.0f;
  if (tid < 2) exit_mark[tid] = 0;
  if (has_cols) fill_constant_columns<T>(Fs, C * L::P, c0, D, tid);
  cluster_arrive();  // every CTA of the cluster has started and initialised
  cluster_wait();
  int keep = 1.0f > trans_eps;
  ProductOf<T> prod;

  cluster_arrive();  // W is free (paired with the first round's wait)
  for (int b = 0; b < nb; ++b) {
    const long long row0 = pstart + static_cast<long long>(b) * kBlock;
    if (!keep) {  // early exit: the remaining blocks' rows are zeros
      if (has_cols) zero_rows<T, kScatter>(out, dest, row0, DC, c0, tid);
      continue;
    }
    load_geom(g, pack, row0, tid);
    const int remaining = count - b * kBlock;
    prod.zero();
    for (int r = 0; r < n_rounds; ++r) {
      const int g0 = r * C;
      const int npix = min(C, n_groups - g0) * L::P;
      __syncthreads();  // the geometry is in; every read of F (and W) is done
      if (has_cols)
        stage_features<T, kGhost>(Fs, feats, static_cast<long long>(tile) * tspx + g0 * L::P,
                                  npix, tspx - g0 * L::P, c0, D, vec_ok, tid);
      cluster_wait();  // every rank has finished reading its W
      if (g0 + rank < n_groups)
        walk_pixel<T>(g, Tpix, (g0 + rank) * L::P + pl, pl, rank, q, w_dst, q < n_dst,
                      remaining, x0, y0, ts, width, height);
      fence_proxy_async();
      if (r == n_rounds - 1) {  // the exit mark of this block, from this rank's pixels
        __syncthreads();  // this round's T updates are in
        int any = 0;
        for (int idx = tid; idx < ((n_groups - rank + C - 1) / C) * L::P; idx += kThreads)
          any |= Tpix[(rank + (idx / L::P) * C) * L::P + idx % L::P] > trans_eps;
        if (__syncthreads_or(any) && tid < C)
          st_cluster(map_rank(smem_addr(&exit_mark[b % 2]), tid), b + 1);
      }
      cluster_arrive();  // W and the exit marks are complete in every rank
      cluster_wait();
      if (has_cols) {
        cp_async_wait_all();
        fence_proxy_async();
        __syncthreads();
        prod.accumulate(Ws, Fs, npix, tid);
      }
      cluster_arrive();  // this rank has finished reading its W
    }
    if (has_cols) prod.template store<kScatter>(out, dest, row0, DC, c0, stage, tid);
    keep = exit_mark[b % 2] == b + 1;
  }
  cluster_wait();  // no rank leaves while another may still reach its memory
}

template <typename T, bool kScatter, bool kGhost>
int launch_as(const float* pack, const int* tile_starts, const int* tile_ends,
              const int* padded_starts, const T* feats, const int* dest, T* out, float* tscratch,
              int n_tiles, int ntx, int ts, int width, int height, int D, int DC, float trans_eps,
              int C, int grid_x, cudaStream_t stream) {
  using L = Layout<T>;
  const size_t bytes = L::bytes(C);
  cudaError_t e = cudaFuncSetAttribute(adjoint_kernel<T, kScatter, kGhost>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec_ok = (D % L::V == 0) && (reinterpret_cast<uintptr_t>(feats) % 16 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid_x) * n_tiles, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, adjoint_kernel<T, kScatter, kGhost>, pack, tile_starts,
                         tile_ends, padded_starts, feats, dest, out, tscratch, ntx, ts, width,
                         height, D, DC, trans_eps, vec_ok, C, grid_x);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Any tile; C and grid_x from raster/kernels.py::adjoint_cluster(DC);
// tscratch (grid_x / C) * n_tiles * n_groups * P floats.
template <typename T, bool kScatter>
int launch(const float* pack, const int* tile_starts, const int* tile_ends,
           const int* padded_starts, const T* feats, const int* dest, T* out, float* tscratch,
           int n_tiles, int ntx, int ts, int width, int height, int D, int DC, float trans_eps,
           int C, int grid_x, cudaStream_t stream) {
  using L = Layout<T>;
  const int S = DC / kSlice;
  const int per = (S + kMaxCluster - 1) / kMaxCluster;  // clusters per tile
  if (DC % kSlice != 0 || DC < D + 1 || ts < 1 || kScatter != (dest != nullptr) ||
      C != (S + per - 1) / per || grid_x != C * per || tscratch == nullptr ||
      static_cast<long long>(grid_x) * n_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((ts * ts) % L::P == 0)
    return launch_as<T, kScatter, false>(pack, tile_starts, tile_ends, padded_starts, feats,
                                         dest, out, tscratch, n_tiles, ntx, ts, width, height,
                                         D, DC, trans_eps, C, grid_x, stream);
  return launch_as<T, kScatter, true>(pack, tile_starts, tile_ends, padded_starts, feats, dest,
                                      out, tscratch, n_tiles, ntx, ts, width, height, D, DC,
                                      trans_eps, C, grid_x, stream);
}

// Clusters of C CTAs that can be resident on the card at once (0 if none).
template <typename T>
int max_clusters(int C) {
  using L = Layout<T>;
  const size_t bytes = L::bytes(C);
  cudaError_t e = cudaFuncSetAttribute(adjoint_kernel<T, false, false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, adjoint_kernel<T, false, false>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace
}  // namespace tpugs

extern "C" int tpugs_adjoint_f32(const float* pack, const int* tile_starts,
                                 const int* tile_ends, const int* padded_starts,
                                 const float* feats, float* out, float* tscratch, int n_tiles,
                                 int ntx, int ts, int width, int height, int D, int DC,
                                 float trans_eps, int C, int grid_x, cudaStream_t stream) {
  return tpugs::launch<float, false>(pack, tile_starts, tile_ends, padded_starts, feats,
                                     nullptr, out, tscratch, n_tiles, ntx, ts, width, height, D,
                                     DC, trans_eps, C, grid_x, stream);
}

extern "C" int tpugs_adjoint_bf16(const float* pack, const int* tile_starts,
                                  const int* tile_ends, const int* padded_starts,
                                  const __nv_bfloat16* feats, __nv_bfloat16* out,
                                  float* tscratch, int n_tiles, int ntx, int ts, int width,
                                  int height, int D, int DC, float trans_eps, int C, int grid_x,
                                  cudaStream_t stream) {
  return tpugs::launch<__nv_bfloat16, false>(pack, tile_starts, tile_ends, padded_starts,
                                             feats, nullptr, out, tscratch, n_tiles, ntx, ts,
                                             width, height, D, DC, trans_eps, C, grid_x, stream);
}

extern "C" int tpugs_adjoint_scatter_f32(const float* pack, const int* tile_starts,
                                         const int* tile_ends, const int* padded_starts,
                                         const float* feats, const int* dest, float* out,
                                         float* tscratch, int n_tiles, int ntx, int ts,
                                         int width, int height, int D, int DC, float trans_eps,
                                         int C, int grid_x, cudaStream_t stream) {
  return tpugs::launch<float, true>(pack, tile_starts, tile_ends, padded_starts, feats, dest,
                                    out, tscratch, n_tiles, ntx, ts, width, height, D, DC,
                                    trans_eps, C, grid_x, stream);
}

extern "C" int tpugs_adjoint_scatter_bf16(const float* pack, const int* tile_starts,
                                          const int* tile_ends, const int* padded_starts,
                                          const __nv_bfloat16* feats, const int* dest,
                                          __nv_bfloat16* out, float* tscratch, int n_tiles,
                                          int ntx, int ts, int width, int height, int D, int DC,
                                          float trans_eps, int C, int grid_x,
                                          cudaStream_t stream) {
  return tpugs::launch<__nv_bfloat16, true>(pack, tile_starts, tile_ends, padded_starts,
                                            feats, dest, out, tscratch, n_tiles, ntx, ts, width,
                                            height, D, DC, trans_eps, C, grid_x, stream);
}

// Resident clusters of the B2 kernel at cluster size C (bf16 or f32), or
// minus a CUDA error.
extern "C" int tpugs_adjoint_max_clusters(int bf16, int C) {
  return bf16 ? tpugs::max_clusters<__nv_bfloat16>(C) : tpugs::max_clusters<float>(C);
}
