// Weight gradient of the 3x3x3 stride-1 SAME convolution, channels-last,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
//   K9  segmamba_tpu/ops/conv3d_pallas.py:152  _dw_kernel  (_conv3d_dw :174,
//       pallas_call :187; the dw of conv3d_k3s1's and conv3d_k3s1_v2's VJP)
//
//   dw[kd, kh, kw, ci, co] = sum_{b, d, h, w} x[b, d+kd-1, h+kh-1, w+kw-1, ci]
//                                              * dy[b, d, h, w, co]
// with x zero outside the volume; x and dy (B, D, H, W, C) contiguous in one
// type (float32 or bfloat16), every product and sum in float32.
//
// The TPU kernel carries one (3, Cin, 9 Cout) float32 accumulator through
// its whole serial grid. Hopper blocks run in no order, so the position
// reduction is split: each block sums its share of the positions into
// registers and writes one float32 partial (nparts, 27, Cin, Cout);
// dw_reduce_kernel adds the partials in part order, a second pass with no
// atomics, so the same inputs give the same bits.
//
// bfloat16 (dw_wg_kernel<NCI>): a GEMM per tap with M = output channels,
// N = input channels, K = positions, on the tensor cores with wgmma.
//   - Block. 64 output channels (M) x NCI input channels (N = 24 where
//     Cin % 24 == 0, 16, or 8 for Cin <= 8) x all 27 taps: three
//     warpgroups, warpgroup kd holding the 9 in-plane taps of depth tap kd
//     (9 x NCI / 2 accumulators a thread: 108 at NCI = 24). 384 threads
//     leave 168 registers a thread; a separate producer warp would make
//     416, which ptxas caps at 128, so warpgroup 2's first warp feeds the
//     ring between its own steps (Feeder). Wider N with fewer taps per
//     warpgroup (3 taps x N = 48 or 64, the kernel row a grid index) ran
//     slower on an H100 at bench_conv.py's shapes: each dy fragment then
//     serves 3 wgmmas instead of 9, and x and dy are staged 3 times.
//   - Work. A unit is one 8 x 16 (h, w) column of positions at one b over
//     a range of planes d0 .. d1; a block walks the units part, part +
//     nparts, ... The ring's stage s of a unit holds plane d0 - 1 + s:
//     x's 10 x 18 halo (NCI channels) and dy's 8 x 16 positions (64
//     channels), each as [8-channel group][position][8]. Warpgroup kd at
//     output plane d pairs dy(d) with x(d + kd - 1), so each plane of x
//     and dy is staged once per block and read by all three depth taps.
//   - Operands. A = dy (M = co, K = positions) from registers: per k step
//     (one row of 16 positions) an ldmatrix.x4.trans of the warp's 16
//     channels, reused by the 9 taps' wgmmas. B = x (K = positions, N =
//     ci) from shared memory, MN-major: a k step's 16 positions of a tap
//     (kh, kw) are 16 consecutive 16-byte rows of the halo, so the
//     descriptor is the halo moved by ((k + kh) 18 + kw) rows (LBO 8 rows,
//     SBO one channel group). Shifting B and not A keeps Cin = 4 at N = 8
//     instead of padding it to M = 64.
//   - Ring. S >= 3 stages (8 fit at NCI <= 24), full and empty mbarriers.
//     The feeding warp's elected lane arms a stage with its byte count and
//     issues 4-D TMA loads, one per 8-channel group (zero fill outside the
//     volume); a tensor with C % 8 != 0 (Cin = 4) is staged with cp.async
//     instead. A warpgroup releases a stage after its last use (and, for
//     the stages at a unit's ends that its depth tap does not read, after
//     the stage has landed, so no release counts towards a slot's earlier
//     use).
//   - Parts. The wrapper sizes nparts x (ci tiles) x (co tiles) to about
//     one wave of blocks on the card, and splits the planes into ranges so
//     that there are >= 4 units a part.
// float32 (dw_f32_kernel, as before): exact FMAs on the CUDA cores, one
// thread per (tap, ci), 32 accumulators, CO = 32, 8 x 16 position steps.
//
// What bounds it on this card: the products, as the forward (2 * 27 * Cin
// * Cout flops per position; 0.26 ms at 128^3, 48 -> 48). Per call the
// bf16 path moves: x once per output-channel tile of 64 and dy once per
// input-channel tile (from L2 where blocks running together share them;
// the unit's two edge planes of x again), the partials written (nparts 27
// Cin Cout 4 bytes) and read back by the reduce, and dw written once. At
// 128^3 48 -> 48 (NCI 24, 66 parts, 3 plane ranges): x 201 MB once, dy
// 201 MB for each of 2 input-channel tiles, 16.4 MB of partials written
// and read, dw 249 KB. M pads Cout to 64 (48 -> 64 costs a third more
// products); A from registers keeps the wgmmas' shared-memory reads at
// B's 32 N bytes each.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>

#include "wgmma_ring.cuh"

namespace {

// ---------------------------------------------------------------------------
// bfloat16: wgmma, TMA / cp.async, mbarrier ring, all 27 taps per block
// ---------------------------------------------------------------------------

constexpr int DW_CONSUMERS = 3;                       // one per depth tap
constexpr int DW_THREADS = DW_CONSUMERS * 128;
constexpr int DTH = 8, DTW = 16;                      // positions per stage
constexpr int DHH = DTH + 2, DHW = DTW + 2;           // x's halo
constexpr int DP = DHH * DHW;                         // 180
constexpr int DPOS = DTH * DTW;                       // 128
constexpr int MCO = 64;                               // output channels (M)
constexpr int XGROUP = (DP * 16 + 127) / 128 * 128;   // bytes, 8-ch group
constexpr int YGROUP = DPOS * 16;
constexpr int YBYTES = (MCO / 8) * YGROUP;
constexpr int DW_MAX_STAGES = 8;
constexpr int DW_SMEM_LIMIT = 232448;

template <int NCI>
struct DwGeo {
  static constexpr int XG = NCI / 8;
  static constexpr int XBYTES = XG * XGROUP;
  static constexpr int STAGE = XBYTES + YBYTES;
};

struct DwParams {
  const __nv_bfloat16* x;    // (B, D, H, W, Cin)
  const __nv_bfloat16* dy;   // (B, D, H, W, Cout)
  float* part;               // (nparts, 27, Cin, Cout)
  int B, D, H, W, Cin, Cout, tiles_h, tiles_w, dsplit, dr, stages;
  int x_tma, dy_tma;
  long long nunits;
};

struct Unit {
  int b, h0, w0, d0, d1;
};

// Unit u: (w tile fastest, h tile, plane range, b).
__device__ __forceinline__ Unit unit_at(const DwParams& p, long long u) {
  Unit a;
  a.w0 = (int)(u % p.tiles_w) * DTW;
  u /= p.tiles_w;
  a.h0 = (int)(u % p.tiles_h) * DTH;
  u /= p.tiles_h;
  a.d0 = (int)(u % p.dsplit) * p.dr;
  a.b = (int)(u / p.dsplit);
  a.d1 = min(p.D, a.d0 + p.dr);
  return a;
}

// The ring's producer, run by the first warp of warpgroup 2 (the depth tap
// that reads furthest ahead) between its own steps: a separate producer
// warp would make the block 416 threads, which caps every thread at 128
// registers, below the consumers' 108 accumulators and A fragments.
template <int NCI>
struct Feeder {
  const DwParams* p;
  const CUtensorMap* xmap;
  const CUtensorMap* ymap;
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
  int ci0, co0, nxg, nyg, lane;
  long long u;        // unit of the next stage to issue
  Unit a;
  int pl;             // its plane
  long long issued;   // stages issued
  long long pend;     // the stage whose cp.async copies are in flight (-1)

  __device__ void start(const DwParams* p_, const CUtensorMap* xm,
                        const CUtensorMap* ym, unsigned char* sm,
                        uint64_t* fu, uint64_t* em, int ci, int co,
                        int ln) {
    p = p_; xmap = xm; ymap = ym; smem = sm; full = fu; empty = em;
    ci0 = ci; co0 = co; lane = ln;
    nxg = min(DwGeo<NCI>::XG, (p->Cin - ci0 + 7) / 8);   // groups with data
    nyg = min(MCO / 8, (p->Cout - co0 + 7) / 8);
    u = blockIdx.x;
    if (u < p->nunits) {
      a = unit_at(*p, u);
      pl = a.d0 - 1;
    }
    issued = 0;
    pend = -1;
  }

  // The in-flight cp.async copies of stage ``pend`` have landed: arrive.
  __device__ void complete(bool keep_latest) {
    if (keep_latest)
      ring::cp_async_wait<1>();
    else
      ring::cp_async_wait<0>();
    ring::fence_proxy_async();
    __syncwarp();
    if (lane == 0) ring::mbar_arrive(&full[pend % p->stages]);
  }

  // Issue stages up to global index ``target``; then, if the stage the
  // caller needs next (``need``) still has copies in flight, finish them.
  __device__ void issue_until(long long target, long long need) {
    using G = DwGeo<NCI>;
    const int S = p->stages;
    while (issued <= target && u < p->nunits) {
      const int slot = (int)(issued % S);
      if (issued >= S)
        ring::mbar_wait(&empty[slot], (uint32_t)(((issued / S) - 1) & 1));
      const bool xv = pl >= 0 && pl < p->D, yv = pl >= a.d0 && pl < a.d1;
      unsigned char* xs = smem + (size_t)slot * G::STAGE;
      unsigned char* ys = xs + G::XBYTES;
      const int plane = a.b * p->D + pl;
      if (lane == 0) {
        const uint32_t bytes = (xv && p->x_tma ? nxg * DP * 16 : 0) +
                               (yv && p->dy_tma ? nyg * YGROUP : 0);
        ring::mbar_arrive_tx(&full[slot], bytes);
        if (xv && p->x_tma)
          for (int gi = 0; gi < nxg; ++gi)
            ring::tma_load_4d(xs + gi * XGROUP, xmap, &full[slot],
                              ci0 + 8 * gi, a.w0 - 1, a.h0 - 1, plane);
        if (yv && p->dy_tma)
          for (int j = 0; j < nyg; ++j)
            ring::tma_load_4d(ys + j * YGROUP, ymap, &full[slot],
                              co0 + 8 * j, a.w0, a.h0, plane);
      }
      // a tensor with C % 8 != 0 by cp.async (channels beyond C are not
      // read: they fall in rows or columns of dw that are not stored); the
      // previous such stage's copies complete and arrive
      const bool xc = xv && !p->x_tma, yc = yv && !p->dy_tma;
      if (xc)
        ring::rows_cp_async(p->x, xs, XGROUP, nxg, p->Cin, ci0, plane, p->H,
                            p->W, a.h0 - 1, a.w0 - 1, DHH, DHW, true, lane);
      if (yc)
        ring::rows_cp_async(p->dy, ys, YGROUP, nyg, p->Cout, co0, plane,
                            p->H, p->W, a.h0, a.w0, DTH, DTW, true, lane);
      if (xc || yc) {
        ring::cp_async_commit();
        if (pend >= 0) complete(true);
        pend = issued;
      } else {
        if (pend >= 0) {   // no copies behind this stage: finish them now
          complete(false);
          pend = -1;
        }
        if (lane == 0) ring::mbar_arrive(&full[slot]);
      }
      ++issued;
      if (++pl > a.d1) {
        u += gridDim.x;
        if (u < p->nunits) {
          a = unit_at(*p, u);
          pl = a.d0 - 1;
        }
      }
    }
    if (pend >= 0 && pend <= need) {
      complete(false);
      pend = -1;
    }
  }
};

template <int NCI>
__device__ void dw_consume(const DwParams& p, const CUtensorMap* xmap,
                           const CUtensorMap* ymap, unsigned char* smem,
                           uint64_t* full, uint64_t* empty, int kd, int wtid,
                           int ci0, int co0) {
  using G = DwGeo<NCI>;
  constexpr int NA = NCI / 2;
  const int S = p.stages;
  // warpgroup 2's first warp also feeds the ring: at its step i it needs
  // stage gbase + i + 2 and has released every stage before gbase + i, so
  // it may issue up to gbase + i + S - 1 without waiting on itself
  const bool feeds = kd == 2 && (wtid >> 5) == 0;
  Feeder<NCI> feed;
  if (feeds) feed.start(&p, xmap, ymap, smem, full, empty, ci0, co0, wtid);
  const int wi = wtid >> 5, lane = wtid & 31;
  const int g = lane >> 2, tq = lane & 3;
  // this lane's ldmatrix row: channel group 2 wi + (matrix & 1), position
  // row + 8 (matrix >> 1) of a k step's 16
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t a_off =
      (uint32_t)((2 * wi + (mi & 1)) * YGROUP + (mr + 8 * (mi >> 1)) * 16);
  auto wait_full = [&](long long gs) {
    ring::mbar_wait(&full[gs % S], (uint32_t)((gs / S) & 1));
  };
  // release stage gs: once it has landed (so that this arrival cannot
  // count towards the slot's previous use), arrive on its empty barrier
  auto release = [&](long long gs) {
    wait_full(gs);
    ring::mbar_arrive(&empty[gs % S]);
  };
  float acc[9][NA];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < NA; ++j) acc[t][j] = 0.f;
  long long gbase = 0;   // global index of the unit's stage 0
  for (long long u = blockIdx.x; u < p.nunits; u += gridDim.x) {
    const Unit a = unit_at(p, u);
    const int n = a.d1 - a.d0;
    for (int i = 0; i < n; ++i) {
      if (feeds) feed.issue_until(gbase + i + S - 1, gbase + i + 2);
      const int xp = a.d0 + i + kd - 1;
      const bool xok = xp >= 0 && xp < p.D;
      const long long sy = gbase + i + 1, sx = gbase + i + kd;
      wait_full(sy);
      if (xok) {
        wait_full(sx);
        const uint32_t yb =
            ring::smem_u32(smem + (size_t)(sy % S) * G::STAGE + G::XBYTES) +
            a_off;
        const uint32_t xb = ring::smem_u32(smem + (size_t)(sx % S) * G::STAGE);
        uint32_t af[2][4];
#pragma unroll
        for (int t = 0; t < 9; ++t)
#pragma unroll
          for (int j = 0; j < NA; ++j) ring::reg_fence(acc[t][j]);
#pragma unroll
        for (int ks = 0; ks < DTH; ++ks) {
          uint32_t* fr = af[ks & 1];
          ring::ldsm_x4_trans(fr, yb + ks * 256);
#pragma unroll
          for (int q = 0; q < 4; ++q) ring::reg_fence(fr[q]);
          ring::wgmma_fence();
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int kh = tap / 3, kw = tap % 3;
            const uint64_t db = ring::make_desc(
                xb + ((ks + kh) * DHW + kw) * 16, 128, XGROUP);
            ring::WgmmaRS<NCI>::rs(acc[tap], fr, db);
          }
          ring::wgmma_commit();
          ring::wgmma_wait<1>();
        }
        ring::wgmma_wait<0>();
#pragma unroll
        for (int t = 0; t < 9; ++t)
#pragma unroll
          for (int j = 0; j < NA; ++j) ring::reg_fence(acc[t][j]);
      }
      if (wtid == 0) {   // every stage of the unit once per warpgroup
        if (kd == 0) {
          release(gbase + i);
          if (i == n - 1) {
            release(gbase + n);
            release(gbase + n + 1);
          }
        } else {
          if (i == 0) release(gbase);
          release(gbase + i + 1);
          if (i == n - 1) release(gbase + n + 1);
        }
      }
    }
    gbase += n + 2;
  }

  // thread: co rows 16 wi + g (+ 8), ci columns 8 j + 2 tq (+ 1)
  float* out = p.part + (long long)blockIdx.x * 27 * p.Cin * p.Cout;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int j = 0; j < NCI / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int co = co0 + 16 * wi + g + 8 * (q >> 1);
        const int ci = ci0 + 8 * j + 2 * tq + (q & 1);
        if (ci < p.Cin && co < p.Cout)
          out[((long long)(kd * 9 + tap) * p.Cin + ci) * p.Cout + co] =
              acc[tap][4 * j + q];
      }
}

template <int NCI>
__global__ void __launch_bounds__(DW_THREADS, 1)
    dw_wg_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap ymap,
                 const DwParams p) {
  using G = DwGeo<NCI>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + (size_t)p.stages * G::STAGE);
  uint64_t* empty = full + p.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      ring::mbar_init(&full[s], 2);   // the producer's two arrivals
      ring::mbar_init(&empty[s], DW_CONSUMERS);
    }
    ring::mbar_init_fence();
  }
  __syncthreads();
  dw_consume<NCI>(p, &xmap, &ymap, smem, full, empty, threadIdx.x >> 7,
                  threadIdx.x & 127, blockIdx.y * NCI, blockIdx.z * MCO);
}

template <int NCI>
constexpr int dw_stages_for() {
  constexpr int s =
      (DW_SMEM_LIMIT - 128 - 16 * DW_MAX_STAGES) / DwGeo<NCI>::STAGE;
  return s > DW_MAX_STAGES ? DW_MAX_STAGES : s;
}

template <int NCI>
int launch_wg(DwParams p, int nparts, cudaStream_t stream) {
  using G = DwGeo<NCI>;
  static_assert(dw_stages_for<NCI>() >= 3, "fewer than three stages fit");
  p.stages = dw_stages_for<NCI>();
  CUtensorMap xmap, ymap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&ymap, 0, sizeof(ymap));
  const long long planes = (long long)p.B * p.D;
  if (p.x_tma) {
    const int e = ring_host::encode_map(&xmap, p.x, p.Cin, p.W, p.H, planes,
                                        DHW, DHH);
    if (e != 0) return e;
  }
  if (p.dy_tma) {
    const int e = ring_host::encode_map(&ymap, p.dy, p.Cout, p.W, p.H,
                                        planes, DTW, DTH);
    if (e != 0) return e;
  }
  const size_t smem = 128 + (size_t)p.stages * G::STAGE + 16 * p.stages;
  static int attr_set = 0;   // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dw_wg_kernel<NCI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DW_SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    attr_set = 1;
  }
  const dim3 grid((unsigned)nparts, (unsigned)((p.Cin + NCI - 1) / NCI),
                  (unsigned)((p.Cout + MCO - 1) / MCO));
  dw_wg_kernel<NCI><<<grid, DW_THREADS, smem, stream>>>(xmap, ymap, p);
  return (int)cudaGetLastError();
}

// dw[i] = sum over parts, in part order, of part[k][i].
__global__ void dw_reduce_kernel(const float* part, float* dw, int nparts,
                                 long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nparts; ++k) s += part[(long long)k * n + i];
  dw[i] = s;
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs, one thread per (tap, ci)
// ---------------------------------------------------------------------------

constexpr int TH = 8, TW = 16;           // positions per step (K = 128)
constexpr int HH = TH + 2, HW = TW + 2;  // x's halo of the step
constexpr int CI = 32;                   // dw tile's input channels
constexpr int CO_F32 = 32;               // dw tile's output channels
constexpr int THREADS = 288;             // 9 warps: one in-plane tap each
constexpr int XS = HH * HW + 1;          // x row stride (odd: 181)

struct Params {
  const void* x;
  const void* dy;
  float* part;   // (nparts, 27, Cin, Cout)
  int B, D, H, W, Cin, Cout, tiles_h, tiles_w, nparts;
  long long ntiles;
};

// (b, d, h0, w0) of position tile ``tile``.
struct Tile {
  int b, d, h0, w0;
};
__device__ __forceinline__ Tile tile_of(const Params& p, long long tile) {
  Tile t;
  const int tw = (int)(tile % p.tiles_w);
  long long r = tile / p.tiles_w;
  const int th = (int)(r % p.tiles_h);
  r /= p.tiles_h;
  t.d = (int)(r % p.D);
  t.b = (int)(r / p.D);
  t.h0 = th * TH;
  t.w0 = tw * TW;
  return t;
}

// Stage position tile ``tile``: xs[c][halo pos] on plane d + kd - 1 and
// dys[pos][c], zero outside.
__device__ void stage_f32(const Params& p, float* xs, float* dys,
                          long long tile, int kd, int ci0, int co0) {
  const Tile t = tile_of(p, tile);
  const int di = t.d + kd - 1;
  const bool plane = di >= 0 && di < p.D;
  const float* x = static_cast<const float*>(p.x);
  const float* dy = static_cast<const float*>(p.dy);
  for (int i = threadIdx.x; i < HH * HW * CI; i += THREADS) {
    const int pos = i / CI, c = i % CI;
    const int gh = t.h0 + pos / HW - 1, gw = t.w0 + pos % HW - 1;
    const int ci = ci0 + c;
    float v = 0.f;
    if (plane && gh >= 0 && gh < p.H && gw >= 0 && gw < p.W && ci < p.Cin)
      v = x[((((long long)t.b * p.D + di) * p.H + gh) * p.W + gw) * p.Cin +
            ci];
    xs[c * XS + pos] = v;
  }
  for (int i = threadIdx.x; i < TH * TW * CO_F32; i += THREADS) {
    const int pos = i / CO_F32, c = i % CO_F32;
    const int gh = t.h0 + pos / TW, gw = t.w0 + pos % TW, co = co0 + c;
    float v = 0.f;
    if (gh < p.H && gw < p.W && co < p.Cout)
      v = dy[((((long long)t.b * p.D + t.d) * p.H + gh) * p.W + gw) *
                 p.Cout + co];
    dys[pos * CO_F32 + c] = v;
  }
}

__global__ void __launch_bounds__(THREADS) dw_f32_kernel(Params p) {
  __shared__ __align__(16) float xs[CI * XS];
  __shared__ __align__(16) float dys[TH * TW * CO_F32];
  const int tiles_co = (p.Cout + CO_F32 - 1) / CO_F32;
  const int ci0 = (blockIdx.y / tiles_co) * CI;
  const int co0 = (blockIdx.y % tiles_co) * CO_F32;
  const int kd = blockIdx.z;
  const int tap = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kh = tap / 3, kw = tap % 3;

  float acc[CO_F32];
#pragma unroll
  for (int c = 0; c < CO_F32; ++c) acc[c] = 0.f;

  for (long long tile = blockIdx.x; tile < p.ntiles; tile += p.nparts) {
    stage_f32(p, xs, dys, tile, kd, ci0, co0);
    __syncthreads();
    for (int hl = 0; hl < TH; ++hl) {
      const float* xr = xs + lane * XS + (hl + kh) * HW + kw;
      for (int wl = 0; wl < TW; ++wl) {
        const float xv = xr[wl];
        const float4* dr =
            reinterpret_cast<const float4*>(dys + (hl * TW + wl) * CO_F32);
#pragma unroll
        for (int c = 0; c < CO_F32 / 4; ++c) {
          const float4 v = dr[c];
          acc[4 * c] = fmaf(xv, v.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(xv, v.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(xv, v.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(xv, v.w, acc[4 * c + 3]);
        }
      }
    }
    __syncthreads();
  }
  const int ci = ci0 + lane;
  if (ci >= p.Cin) return;
  float* out = p.part +
               (((long long)blockIdx.x * 27 + kd * 9 + tap) * p.Cin + ci) *
                   p.Cout;
#pragma unroll
  for (int c = 0; c < CO_F32; ++c)
    if (co0 + c < p.Cout) out[co0 + c] = acc[c];
}

}  // namespace

extern "C" {

// x (B, D, H, W, Cin) and dy (B, D, H, W, Cout) contiguous, float32 or
// bfloat16 (is_bf16), 16-byte aligned; part (nparts, 27, Cin, Cout)
// float32, every element written; dw = the sum over parts
// (conv3d_k3s1_dw_reduce). Returns a cudaError_t value (0 = launched), or
// 100000 + a CUresult when a tensor map cannot be encoded.
//   float32: part p sums position tiles p, p + nparts, ... (8 x 16 (h, w)
//     at one (b, d)); nf and dsplit unused.
//   bfloat16: 8 nf input channels per block (nf one of 1, 2, 3), the
//     planes split into dsplit ranges; part p sums units p, p + nparts, ...
//     (8 x 16 (h, w) columns at one b over one plane range); Cin and Cout
//     even.
int conv3d_k3s1_dw(const void* x, const void* dy, float* part, int is_bf16,
                   int B, int D, int H, int W, int Cin, int Cout, int nf,
                   int nparts, int dsplit, void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 ||
      nparts < 1 || nparts > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (Cin % 2 || Cout % 2 || dsplit < 1 || dsplit > D)
      return (int)cudaErrorInvalidValue;
    DwParams p;
    p.x = static_cast<const __nv_bfloat16*>(x);
    p.dy = static_cast<const __nv_bfloat16*>(dy);
    p.part = part;
    p.B = B; p.D = D; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout;
    p.tiles_h = (H + DTH - 1) / DTH;
    p.tiles_w = (W + DTW - 1) / DTW;
    p.dr = (D + dsplit - 1) / dsplit;
    p.dsplit = (D + p.dr - 1) / p.dr;
    p.nunits = (long long)B * p.dsplit * p.tiles_h * p.tiles_w;
    p.x_tma = Cin % 8 == 0;
    p.dy_tma = Cout % 8 == 0;
    switch (nf) {
      case 1: return launch_wg<8>(p, nparts, st);
      case 2: return launch_wg<16>(p, nparts, st);
      case 3: return launch_wg<24>(p, nparts, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  Params p;
  p.x = x; p.dy = dy; p.part = part;
  p.B = B; p.D = D; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout;
  p.tiles_h = (H + TH - 1) / TH;
  p.tiles_w = (W + TW - 1) / TW;
  p.nparts = nparts;
  p.ntiles = (long long)B * D * p.tiles_h * p.tiles_w;
  const long long nct =
      (long long)((Cin + CI - 1) / CI) * ((Cout + CO_F32 - 1) / CO_F32);
  if (nct > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nparts, (unsigned)nct, 3u);
  dw_f32_kernel<<<grid, THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// dw (n floats) = the sum over nparts partials of n floats each, in part
// order (deterministic).
int conv3d_k3s1_dw_reduce(const float* part, float* dw, int nparts,
                          long long n, void* stream) {
  if (nparts < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  dw_reduce_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(part, dw, nparts,
                                                          n);
  return (int)cudaGetLastError();
}

const char* conv3d_k3s1_dw_error_string(int err) {
  return ring_host::error_string(err);
}

}  // extern "C"
