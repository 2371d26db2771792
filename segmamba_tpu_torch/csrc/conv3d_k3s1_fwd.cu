// 3x3x3 stride-1 SAME convolution, channels-last, no bias, for Hopper
// (sm_90a): the forward and, with flipped and transposed weights, dx.
//
// Replaces the Pallas TPU kernels of the JAX package
//   K9  segmamba_tpu/ops/conv3d_pallas.py:59   _kernel    (conv3d_k3s1 :82,
//       pallas_call :122; dx through the same kernel, _conv3d_bwd :139-146)
//       segmamba_tpu/ops/conv3d_pallas.py:212  _kernel_v2 (conv3d_k3s1_v2
//       :296, pallas_call :280; the same function with TPU lane padding)
//
//   y[b, d, h, w, co] = sum_{kd, kh, kw, ci} x[b, d+kd-1, h+kh-1, w+kw-1, ci]
//                                             * w[kd, kh, kw, ci, co]
// with x zero outside the volume. x and y are (B, D, H, W, C) contiguous in
// one type (float32 or bfloat16); sums are float32, y is rounded once.
//
// The TPU kernel folds the 9 in-plane taps into the matmul's N ("P-form")
// to fill 128-lane MXU tiles and materialises overlapping H blocks in HBM.
// None of that is carried over. Here the conv is an implicit GEMM: M =
// output positions, N = Cout, K = 27 Cin.
//
// bfloat16 (conv_wg_kernel<N>): wgmma on the tensor cores fed by a ring of
// shared-memory stages.
//   - Tiles. A block tile is 16 (h) x 8 MT (w) output positions at one
//     (b, d) and N output channels: two consumer warpgroups, each MT
//     8 x 8 position patches, one m64 wgmma tile per patch. N is the whole
//     Cout where it fits (N in 16 ... 192, MT = 4 for N <= 48, 2 for <= 128,
//     1 above: at most 96 accumulators a thread), so x is staged once per
//     tile, not once per Cout tile; Cout above 192 takes several N tiles.
//   - Operands. Both come from shared memory through wgmma descriptors in
//     the no-swizzle layout (core matrices of 8 rows x 16 bytes). A stage
//     holds the 18 x (8 MT + 2) input halo of the tile for one depth tap
//     and 16 input channels as [channel group 0..1][halo position][8], so
//     the 8 positions of one patch row are 8 consecutive 16-byte rows for
//     every tap (kh, kw): A's descriptor for (patch, tap) is the halo's
//     address moved by ((8 r + kh) (8 MT + 2) + 8 m + kw) rows, SBO one
//     halo row, LBO one channel group. The shift costs no copy, no
//     registers and no ldmatrix; the alternatives (A from registers
//     through ldmatrix, or a materialised tile per tap) spend registers or
//     shared-memory traffic on what an address offset does. B is the
//     stage's 9 x N x 16 weights, packed once per call by pack_kernel in
//     exactly the stage's layout ([tap][channel group][n][8], K-major) and
//     moved by one bulk copy.
//   - Ring. One producer warp fills S >= 3 stages (as many as 227 KB
//     hold: 3 at N = 192, 6 at N = 48); per stage its elected lane arms
//     the stage's full barrier with the byte count and issues two 4-D TMA
//     loads of the halo (one per 8-channel group; the tensor map's zero
//     fill outside the volume, at negative coordinates too, is the SAME
//     padding and the ragged H, W and Cin) and the weights' bulk copy.
//     Cin % 8 != 0 (encoder1's Cin = 4: rows of 8 bytes, no 16-byte
//     stride for a tensor map) stages the halo with cp.async of 4 or 8
//     bytes, zero filled, drained and fenced to the async proxy before the
//     barrier's second arrival. Consumers wait on the full barrier, issue
//     9 MT wgmmas, commit, and release the stage before (wgmma.wait_group
//     1 keeps one stage's products in flight) through its empty barrier.
//   - Grid. Persistent: min(tiles, SMs) blocks walk the tiles (b, d, h, w
//     fastest), so a tile's epilogue overlaps the producer's next loads and
//     blocks running together share x planes in L2. Depth taps outside the
//     volume are skipped (D = 1 runs one third of the stages).
// float32 (conv_f32_kernel<NF>, as before): exact FMAs on the CUDA cores
// (no TF32, which would break the f32 tier), one thread per output
// position and NT = 8 NF accumulators over a 16 x 16 tile; the wrapper
// packs (27, cout_pad, cin_pad) weights for it.
//
// What bounds it on this card: the products, 2 * 27 * Cin * Cout flops per
// position (261 GFLOP at 128^3, 48 -> 48: 0.26 ms at 989 TFLOP/s bf16),
// against bytes of x read once, y written once and the weights (0.12 ms at
// 3.35 TB/s). Per call the bf16 path moves from device memory x (plus the
// re-reads of halo rows and neighbouring planes that L2 does not catch), y
// once, and the packed weights: 27 Cin Cout 2 bytes written by pack_kernel
// and read from L2 by every tile (27 Cin Cout 2 bytes per tile). At 128^3
// 48 -> 48: x 201 MB and y 201 MB to and from device memory, w 249 KB
// (float32) read and 124 KB packed written; into shared memory 4096 tiles
// x 9 stages of 19.6 KB of halo and 13.8 KB of weights (0.72 + 0.51 GB,
// from L2 for the most part, since the 132 blocks walk neighbouring
// tiles and planes together). The
// wgmma products read A and B from shared memory (2 KB + 32 N bytes per
// m64nNk16): at N = 48 that is ~146 bytes per clock at the tensor cores'
// peak, above the 128 an SM has, so N = 48 tiles cannot pass ~88% of peak;
// at N >= 96 the weights' L2 traffic (288 N bytes per 9 MT wgmmas) is the
// tighter limit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>

#include "wgmma_ring.cuh"

namespace {

// ---------------------------------------------------------------------------
// bfloat16: wgmma, TMA / cp.async, mbarrier ring
// ---------------------------------------------------------------------------

constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int WG_THREADS = CONSUMERS * 128 + 32;  // + one producer warp
constexpr int WG_CK = 16;                       // input channels per stage
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;              // bytes a block may use

template <int N>
struct Geo {
  static constexpr int MT = N <= 48 ? 4 : (N <= 128 ? 2 : 1);  // patches/WG
  static constexpr int TH = 16, TW = 8 * MT;                 // block tile
  static constexpr int HWW = TW + 2, HHH = TH + 2;           // halo
  static constexpr int P = HHH * HWW;                        // halo positions
  static constexpr int GROUP = (P * 16 + 127) / 128 * 128;   // 8-ch group
  static constexpr int HALO = 2 * GROUP;
  static constexpr int WBYTES = 9 * 2 * N * 16;              // 288 N
  static constexpr int STAGE = HALO + WBYTES;
  static constexpr int BOX = 2 * P * 16;                     // TMA bytes
};

struct WgParams {
  const __nv_bfloat16* x;    // (B, D, H, W, Cin)
  const __nv_bfloat16* wp;   // packed: [n tile][kd][chunk][tap][2][N][8]
  __nv_bfloat16* y;          // (B, D, H, W, Cout)
  int B, D, H, W, Cin, Cout, nchunks, tiles_h, tiles_w, stages, use_tma;
  long long ntiles;
};

struct TileAt {
  int nt, b, d, h0, w0;
};

template <int N>
__device__ __forceinline__ TileAt tile_at(const WgParams& p, long long t) {
  using G = Geo<N>;
  TileAt a;
  a.w0 = (int)(t % p.tiles_w) * G::TW;
  t /= p.tiles_w;
  a.h0 = (int)(t % p.tiles_h) * G::TH;
  t /= p.tiles_h;
  a.d = (int)(t % p.D);
  t /= p.D;
  a.b = (int)(t % p.B);
  a.nt = (int)(t / p.B);
  return a;
}

template <int N>
__device__ void produce(const WgParams& p, const CUtensorMap* xmap,
                        unsigned char* smem, uint64_t* full, uint64_t* empty,
                        int lane) {
  using G = Geo<N>;
  int slot = 0, pend = -1;   // pend: the stage whose cp.async are in flight
  uint32_t phase = 0;
  long long used = 0;        // stages issued
  const uint32_t bytes = (p.use_tma ? G::BOX : 0) + G::WBYTES;
  // one chunk: the channels beyond Cin stay as zeroed at the start
  const bool skip = p.nchunks == 1;
  for (long long t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
    const TileAt a = tile_at<N>(p, t);
    for (int kd = 0; kd < 3; ++kd) {
      const int plane = a.d + kd - 1;
      if (plane < 0 || plane >= p.D) continue;
      for (int c = 0; c < p.nchunks; ++c) {
        if (used >= p.stages) ring::mbar_wait(&empty[slot], phase ^ 1);
        unsigned char* halo = smem + (size_t)slot * G::STAGE;
        if (lane == 0) {
          ring::mbar_arrive_tx(&full[slot], bytes);
          if (p.use_tma)
            for (int gi = 0; gi < 2; ++gi)
              ring::tma_load_4d(halo + gi * G::GROUP, xmap, &full[slot],
                                c * WG_CK + gi * 8, a.w0 - 1, a.h0 - 1,
                                a.b * p.D + plane);
          ring::bulk_load(halo + G::HALO,
                          p.wp + (((long long)a.nt * 3 + kd) * p.nchunks + c) *
                                     (G::WBYTES / 2),
                          G::WBYTES, &full[slot]);
        }
        if (p.use_tma) {
          if (lane == 0) ring::mbar_arrive(&full[slot]);
        } else {
          // Cin % 8 != 0: the halo by cp.async; the previous stage's
          // copies complete (one stage stays in flight) and arrive
          ring::rows_cp_async(p.x, halo, G::GROUP, 2, p.Cin, c * WG_CK,
                              (long long)a.b * p.D + plane, p.H, p.W,
                              a.h0 - 1, a.w0 - 1, G::HHH, G::HWW, skip,
                              lane);
          ring::cp_async_commit();
          if (pend >= 0) {
            ring::cp_async_wait<1>();
            ring::fence_proxy_async();
            __syncwarp();
            if (lane == 0) ring::mbar_arrive(&full[pend]);
          }
          pend = slot;
        }
        ++used;
        if (++slot == p.stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
  }
  if (pend >= 0) {
    ring::cp_async_wait<0>();
    ring::fence_proxy_async();
    __syncwarp();
    if (lane == 0) ring::mbar_arrive(&full[pend]);
  }
}

template <int N>
__device__ void consume(const WgParams& p, unsigned char* smem,
                        uint64_t* full, uint64_t* empty, int wg, int wtid) {
  using G = Geo<N>;
  constexpr int MT = G::MT, NA = N / 2;
  const int wi = wtid >> 5, lane = wtid & 31;
  const int g = lane >> 2, tq = lane & 3;
  float acc[MT][NA];
  int slot = 0, prev = 0;
  uint32_t phase = 0;
  bool pending = false;
  for (long long t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
    const TileAt a = tile_at<N>(p, t);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NA; ++j) acc[m][j] = 0.f;
    for (int kd = 0; kd < 3; ++kd) {
      const int plane = a.d + kd - 1;
      if (plane < 0 || plane >= p.D) continue;
      for (int c = 0; c < p.nchunks; ++c) {
        ring::mbar_wait(&full[slot], phase);
        const uint32_t hbase = ring::smem_u32(smem + (size_t)slot * G::STAGE);
        const uint32_t wbase = hbase + G::HALO;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < NA; ++j) ring::reg_fence(acc[m][j]);
        ring::wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int kh = tap / 3, kw = tap % 3;
          const uint64_t db =
              ring::make_desc(wbase + tap * (2 * N * 16), N * 16, 128);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const uint32_t row = (wg * 8 + kh) * G::HWW + m * 8 + kw;
            const uint64_t da =
                ring::make_desc(hbase + row * 16, G::GROUP, G::HWW * 16);
            ring::Wgmma<N>::ss(acc[m], da, db);
          }
        }
        ring::wgmma_commit();
        ring::wgmma_wait<1>();
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < NA; ++j) ring::reg_fence(acc[m][j]);
        if (pending && wtid == 0) ring::mbar_arrive(&empty[prev]);
        pending = true;
        prev = slot;
        if (++slot == p.stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    ring::wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NA; ++j) ring::reg_fence(acc[m][j]);
    if (pending && wtid == 0) ring::mbar_arrive(&empty[prev]);
    pending = false;

    // thread: patch rows 2 wi (g) and 2 wi + 1 (g + 8), column g; channels
    // 8 j + 2 tq, + 1 of the N tile
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int w = a.w0 + m * 8 + g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int h = a.h0 + wg * 8 + 2 * wi + half;
        if (h >= p.H || w >= p.W) continue;
        __nv_bfloat16* yr =
            p.y + ((((long long)a.b * p.D + a.d) * p.H + h) * p.W + w) * p.Cout;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int co = a.nt * N + j * 8 + 2 * tq;
          const float v0 = acc[m][4 * j + 2 * half];
          const float v1 = acc[m][4 * j + 2 * half + 1];
          if (co + 1 < p.Cout && (p.Cout & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(yr + co) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (co < p.Cout) yr[co] = __float2bfloat16(v0);
            if (co + 1 < p.Cout) yr[co + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(WG_THREADS, 1)
    conv_wg_kernel(const __grid_constant__ CUtensorMap xmap,
                   const WgParams p) {
  using G = Geo<N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + (size_t)p.stages * G::STAGE);
  uint64_t* empty = full + p.stages;
  if (!p.use_tma && p.nchunks == 1) {   // channels the copies skip: zero
    for (int i = threadIdx.x; i < p.stages * G::STAGE / 16; i += WG_THREADS)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    ring::fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      ring::mbar_init(&full[s], 2);   // the producer's two arrivals
      ring::mbar_init(&empty[s], CONSUMERS);
    }
    ring::mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp == CONSUMERS * 4) {
    produce<N>(p, &xmap, smem, full, empty, threadIdx.x & 31);
  } else {
    consume<N>(p, smem, full, empty, warp >> 2, threadIdx.x & 127);
  }
}

// Stages that fit beside the barriers (at least 3; the host checks).
template <int N>
constexpr int stages_for() {
  constexpr int s = (SMEM_LIMIT - 128 - 16 * MAX_STAGES) / Geo<N>::STAGE;
  return s > MAX_STAGES ? MAX_STAGES : s;
}

template <int N>
int launch_wg(const WgParams& base, const void* x, cudaStream_t stream) {
  using G = Geo<N>;
  static_assert(stages_for<N>() >= 3, "fewer than three stages fit");
  WgParams p = base;
  p.stages = stages_for<N>();
  p.tiles_h = (p.H + G::TH - 1) / G::TH;
  p.tiles_w = (p.W + G::TW - 1) / G::TW;
  const int ntn = (p.Cout + N - 1) / N;
  p.ntiles = (long long)ntn * p.B * p.D * p.tiles_h * p.tiles_w;
  p.use_tma = (p.Cin % 8) == 0;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (p.use_tma) {
    const int e = ring_host::encode_map(&map, x, p.Cin, p.W, p.H,
                                        (long long)p.B * p.D, G::HWW,
                                        G::HHH);
    if (e != 0) return e;
  }
  const size_t smem = 128 + (size_t)p.stages * G::STAGE + 16 * p.stages;
  static int attr_set = 0;   // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_wg_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    attr_set = 1;
  }
  const long long blocks =
      p.ntiles < ring_host::sm_count() ? p.ntiles : ring_host::sm_count();
  conv_wg_kernel<N><<<(unsigned)blocks, WG_THREADS, smem, stream>>>(map, p);
  return (int)cudaGetLastError();
}

// One thread per packed element: wp[nt][kd][c][tap][gi][n][e] = weight of
// input channel c 16 + gi 8 + e, output channel nt N + n, in bf16 (zero
// beyond Cin, Cout). flip: the dx weights, w[2-kd][2-kh][2-kw][co][ci] of a
// forward w (3, 3, 3, Cout, Cin).
__global__ void pack_kernel(const void* w, int w_bf16, __nv_bfloat16* wp,
                            int cin, int cout, int nchunks, int N, int flip,
                            long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long r = i;
  const int e = (int)(r % 8);
  r /= 8;
  const int n = (int)(r % N);
  r /= N;
  const int gi = (int)(r % 2);
  r /= 2;
  const int tap = (int)(r % 9);
  r /= 9;
  const int c = (int)(r % nchunks);
  r /= nchunks;
  const int kd = (int)(r % 3);
  const int nt = (int)(r / 3);
  const int ci = c * WG_CK + gi * 8 + e, co = nt * N + n;
  float v = 0.f;
  if (ci < cin && co < cout) {
    long long src;
    if (flip)
      src = ((long long)(26 - (kd * 9 + tap)) * cout + co) * cin + ci;
    else
      src = ((long long)(kd * 9 + tap) * cin + ci) * cout + co;
    v = w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[src])
               : static_cast<const float*>(w)[src];
  }
  wp[i] = __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs, one thread per output position
// ---------------------------------------------------------------------------

constexpr int TH = 16, TW = 16;           // output tile (h, w) per block
constexpr int HH = TH + 2, HW = TW + 2;   // input halo of the tile
constexpr int CK = 16;                    // input channels per stage
constexpr int THREADS = 256;
constexpr int RS = 17;                    // halo row stride (odd)

struct Params {
  const void* x;    // (B, D, H, W, Cin)
  const void* wt;   // (27, cout_pad, cin_pad), zero padded
  void* y;          // (B, D, H, W, Cout)
  int B, D, H, W, Cin, Cout, cin_pad, cout_pad, tiles_w;
};

// The stage's input halo: plane d + kd - 1, rows h0 - 1 .. h0 + TH, columns
// w0 - 1 .. w0 + TW, channels c0 .. c0 + 15, zero outside; smem[pos][c].
__device__ void stage_halo(const Params& p, float* halo, int b, int d, int kd,
                           int h0, int w0, int c0) {
  const float* x = static_cast<const float*>(p.x);
  const int di = d + kd - 1;
  const bool plane = di >= 0 && di < p.D;
  const bool vec = (p.Cin % 8) == 0;  // whole 8-channel groups, aligned
  if (vec) {
    for (int i = threadIdx.x; i < HH * HW * 2; i += THREADS) {
      const int pos = i >> 1, half = i & 1;
      const int gh = h0 + pos / HW - 1, gw = w0 + pos % HW - 1;
      const int c = c0 + half * 8;
      float* dst = halo + pos * RS + half * 8;
      if (plane && gh >= 0 && gh < p.H && gw >= 0 && gw < p.W &&
          c < p.Cin) {
        const float* src =
            x + ((((long long)b * p.D + di) * p.H + gh) * p.W + gw) * p.Cin +
            c;
        const float4 v0 = reinterpret_cast<const float4*>(src)[0];
        const float4 v1 = reinterpret_cast<const float4*>(src)[1];
        dst[0] = v0.x; dst[1] = v0.y; dst[2] = v0.z; dst[3] = v0.w;
        dst[4] = v1.x; dst[5] = v1.y; dst[6] = v1.z; dst[7] = v1.w;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[j] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < HH * HW * CK; i += THREADS) {
      const int pos = i / CK, cc = i % CK;
      const int gh = h0 + pos / HW - 1, gw = w0 + pos % HW - 1;
      const int c = c0 + cc;
      float v = 0.f;
      if (plane && gh >= 0 && gh < p.H && gw >= 0 && gw < p.W && c < p.Cin)
        v = x[((((long long)b * p.D + di) * p.H + gh) * p.W + gw) * p.Cin +
              c];
      halo[pos * RS + cc] = v;
    }
  }
}

template <int NF>
__global__ void __launch_bounds__(THREADS)
    conv_f32_kernel(Params p) {
  constexpr int NT = 8 * NF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* halo = reinterpret_cast<float*>(smem_raw);
  float* ws = halo + HH * HW * RS;   // [9][CK][NT]
  const int tile = blockIdx.x;
  const int h0 = (tile / p.tiles_w) * TH, w0 = (tile % p.tiles_w) * TW;
  const int b = blockIdx.y / p.D, d = blockIdx.y % p.D;
  const int co0 = blockIdx.z * NT;
  const int hl = threadIdx.x / TW, wl = threadIdx.x % TW;
  const float* wt = static_cast<const float*>(p.wt);

  float acc[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n] = 0.f;

  for (int kd = 0; kd < 3; ++kd) {
    for (int c0 = 0; c0 < p.cin_pad; c0 += CK) {
      stage_halo(p, halo, b, d, kd, h0, w0, c0);
      for (int i = threadIdx.x; i < 9 * NT * CK; i += THREADS) {
        const int ci = i % CK, row = i / CK;   // global reads along ci
        const int tap = row / NT, co = row % NT;
        ws[(tap * CK + ci) * NT + co] =
            wt[((long long)(kd * 9 + tap) * p.cout_pad + co0 + co) *
                   p.cin_pad + c0 + ci];
      }
      __syncthreads();
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const float* xr =
            halo + ((hl + tap / 3) * HW + wl + tap % 3) * RS;
        const float* wr = ws + tap * CK * NT;
#pragma unroll 4
        for (int ci = 0; ci < CK; ++ci) {
          const float xv = xr[ci];
#pragma unroll
          for (int n = 0; n < NT; ++n) acc[n] = fmaf(xv, wr[ci * NT + n],
                                                      acc[n]);
        }
      }
      __syncthreads();
    }
  }
  const int h = h0 + hl, w = w0 + wl;
  if (h >= p.H || w >= p.W) return;
  float* yr = static_cast<float*>(p.y) +
              ((((long long)b * p.D + d) * p.H + h) * p.W + w) * p.Cout;
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (co0 + n < p.Cout) yr[co0 + n] = acc[n];
}

constexpr size_t f32_smem_bytes(int nf) {
  return (size_t)(HH * HW * RS) * sizeof(float) +
         (size_t)9 * 8 * nf * CK * sizeof(float);
}

template <int NF>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid((unsigned)(p.tiles_w * ((p.H + TH - 1) / TH)),
                  (unsigned)(p.B * p.D), (unsigned)(p.cout_pad / (8 * NF)));
  const size_t smem = f32_smem_bytes(NF);
  static int attr_set = 0;   // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_f32_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = 1;
  }
  conv_f32_kernel<NF><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, D, H, W, Cin) and y (B, D, H, W, Cout) contiguous, float32 or
// bfloat16 (is_bf16), x 16-byte aligned. Returns a cudaError_t value (0 =
// launched), or 100000 + a CUresult when the tensor map cannot be encoded.
//   float32: wt (27, cout_pad, cin_pad) float32, zero beyond (Cout, Cin):
//     tap kd * 9 + kh * 3 + kw, row co, column ci; cin_pad a multiple of
//     16, cout_pad of 8 nf, nf one of 1, 2, 4, 6, 8.
//   bfloat16: wt packed by conv3d_k3s1_pack with N = 8 nf (nf one of 2, 4,
//     6, 8, 12, 16, 24), cin_pad = 16 nchunks, cout_pad = N ntn.
int conv3d_k3s1_fwd(const void* x, const void* wt, void* y, int is_bf16,
                    int B, int D, int H, int W, int Cin, int Cout,
                    int cin_pad, int cout_pad, int nf, void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 ||
      cin_pad < Cin || cin_pad % CK || cout_pad < Cout ||
      cout_pad % (8 * nf) || (long long)B * D > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (Cin % 2 != 0) return (int)cudaErrorInvalidValue;   // pad to even
    WgParams p;
    p.x = static_cast<const __nv_bfloat16*>(x);
    p.wp = static_cast<const __nv_bfloat16*>(wt);
    p.y = static_cast<__nv_bfloat16*>(y);
    p.B = B; p.D = D; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout;
    p.nchunks = cin_pad / WG_CK;
    switch (nf * 8) {
      case 16: return launch_wg<16>(p, x, st);
      case 32: return launch_wg<32>(p, x, st);
      case 48: return launch_wg<48>(p, x, st);
      case 64: return launch_wg<64>(p, x, st);
      case 96: return launch_wg<96>(p, x, st);
      case 128: return launch_wg<128>(p, x, st);
      case 192: return launch_wg<192>(p, x, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (cout_pad / (8 * nf) > 65535) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.wt = wt; p.y = y;
  p.B = B; p.D = D; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout;
  p.cin_pad = cin_pad; p.cout_pad = cout_pad;
  p.tiles_w = (W + TW - 1) / TW;
  switch (nf) {
    case 1: return (int)launch_f32<1>(p, st);
    case 2: return (int)launch_f32<2>(p, st);
    case 4: return (int)launch_f32<4>(p, st);
    case 6: return (int)launch_f32<6>(p, st);
    case 8: return (int)launch_f32<8>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 kernel's weights: w (3, 3, 3, cin, cout) contiguous, float32
// or bfloat16 (w_bf16) (flip: the forward's w (3, 3, 3, cout, cin), taken
// flipped and transposed, for dx) into wp, ntn * 3 * nchunks * 9 * 2 * N *
// 8 bf16 elements.
int conv3d_k3s1_pack(const void* w, int w_bf16, void* wp, int cin, int cout,
                     int nchunks, int N, int ntn, int flip, void* stream) {
  if (cin < 1 || cout < 1 || nchunks * WG_CK < cin || N < 8 || N % 8 ||
      ntn * N < cout)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)ntn * 3 * nchunks * 9 * 2 * N * 8;
  const int threads = 256;
  pack_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      w, w_bf16, static_cast<__nv_bfloat16*>(wp), cin, cout, nchunks, N,
      flip, total);
  return (int)cudaGetLastError();
}

const char* conv3d_k3s1_error_string(int err) {
  return ring_host::error_string(err);
}

}  // extern "C"
