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
// its whole serial grid (zeroed at program (0, 0, 0), a constant output
// index map). Hopper blocks run in no order, so the position reduction is
// split instead: block (part, ci tile, co tile, kd) sums its share of the
// position tiles (tiles part, part + nparts, ...) into registers and writes
// one float32 partial (nparts, 27, Cin, Cout); the wrapper adds the
// partials with torch.sum. No atomics: every run gives the same bits.
//
// Per block: 9 warps, warp = the in-plane tap (kh, kw); a 32 (ci) x CO (co)
// tile of dw for the block's depth tap kd, a GEMM with K = positions. Each
// step stages a tile of 8 x 16 output positions at one (b, d): dy's 128
// positions x CO channels, and x's 10 x 18 halo on plane d + kd - 1 x 32
// channels, zero outside the volume (edges and ragged H, W masked here):
//   - bfloat16: position-major rows in shared memory, filled by cp.async
//     copies of 8 (or 4) channels (zero-filled outside the volume; element
//     copies when a channel count is not a multiple of 4) two steps deep,
//     so the next step's copies overlap this step's products; fragments
//     come from ldmatrix.trans (a fragment's pairs run along positions,
//     the rows' channels along M and N; the (kh, kw) shift is a row
//     address, so no alignment is lost), products on the tensor cores with
//     warp-level mma.sync.m16n8k16 (bf16 in, f32 accumulate); CO = 8 NF
//     as the forward's output tile, rows padded by 16 bytes (no bank
//     conflicts);
//   - float32: exact FMAs on the CUDA cores, one thread per (tap, ci), 32
//     accumulators, CO = 32, dy read as broadcasts.
//
// What bounds it on this card: the products, as the forward (2 * 27 * Cin
// * Cout flops per position). dy is staged once per (ci tile, kd) and x
// once per co tile: 3 to 18 reads of each from device memory or L2 against
// the bound's one; all three depth taps per block, wgmma and TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 8, TW = 16;           // positions per step (K = 128)
constexpr int HH = TH + 2, HW = TW + 2;  // x's halo of the step
constexpr int CI = 32;                   // dw tile's input channels
constexpr int CO_F32 = 32;               // float32: dw tile's output channels
constexpr int THREADS = 288;             // 9 warps: one in-plane tap each
constexpr int XS = HH * HW + 1;          // float32 x row stride (odd: 181)
constexpr int XR = CI + 8;               // bf16 x row: 40 elements, 80 bytes

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

// ---------------------------------------------------------------------------
// bfloat16: cp.async staging two steps deep, ldmatrix.trans, mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x2_trans(unsigned* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int PIECE>
__device__ __forceinline__ void cp_async_piece(void* dst, const void* src,
                                               bool valid) {
  if constexpr (PIECE == 8)
    cp_async16(dst, src, valid);
  else
    cp_async8(dst, src, valid);
}

// x's halo rows of one step: cp.async of PIECE channels each.
template <int PIECE>
__device__ __forceinline__ void copy_x(const Params& p, __nv_bfloat16* xs,
                                       const Tile& t, int di, bool plane,
                                       int ci0) {
  constexpr int PER = CI / PIECE;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  for (int i = threadIdx.x; i < HH * HW * PER; i += THREADS) {
    const int pos = i / PER, q = i % PER;
    const int gh = t.h0 + pos / HW - 1, gw = t.w0 + pos % HW - 1;
    const int ci = ci0 + q * PIECE;
    const bool ok = plane && gh >= 0 && gh < p.H && gw >= 0 && gw < p.W &&
                    ci < p.Cin;
    const __nv_bfloat16* src =
        ok ? x + ((((long long)t.b * p.D + di) * p.H + gh) * p.W + gw) *
                     p.Cin + ci
           : x;
    cp_async_piece<PIECE>(xs + pos * XR + q * PIECE, src, ok);
  }
}

// dy's rows of one step: cp.async of PIECE channels each.
template <int PIECE, int CO, int DR>
__device__ __forceinline__ void copy_dy(const Params& p, __nv_bfloat16* dys,
                                        const Tile& t, int co0) {
  constexpr int PER = CO / PIECE;
  const __nv_bfloat16* dy = static_cast<const __nv_bfloat16*>(p.dy);
  for (int i = threadIdx.x; i < TH * TW * PER; i += THREADS) {
    const int pos = i / PER, q = i % PER;
    const int gh = t.h0 + pos / TW, gw = t.w0 + pos % TW;
    const int co = co0 + q * PIECE;
    const bool ok = gh < p.H && gw < p.W && co < p.Cout;
    const __nv_bfloat16* src =
        ok ? dy + ((((long long)t.b * p.D + t.d) * p.H + gh) * p.W + gw) *
                      p.Cout + co
           : dy;
    cp_async_piece<PIECE>(dys + pos * DR + q * PIECE, src, ok);
  }
}

// Issue the copies of step ``tile`` into one stage: xs[halo pos][ci] (rows
// of XR) on plane d + kd - 1 and dys[pos][co] (rows of DR), zero outside
// the volume and beyond the channel counts. cp.async of 8 channels where a
// channel count is a multiple of 8, of 4 where it is a multiple of 4
// only, element stores otherwise.
template <int CO, int DR>
__device__ void stage_bf16(const Params& p, __nv_bfloat16* xs,
                           __nv_bfloat16* dys, long long tile, int kd,
                           int ci0, int co0) {
  const Tile t = tile_of(p, tile);
  const int di = t.d + kd - 1;
  const bool plane = di >= 0 && di < p.D;
  if (p.Cin % 8 == 0) {
    copy_x<8>(p, xs, t, di, plane, ci0);
  } else if (p.Cin % 4 == 0) {
    copy_x<4>(p, xs, t, di, plane, ci0);
  } else {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
    for (int i = threadIdx.x; i < HH * HW * CI; i += THREADS) {
      const int pos = i / CI, c = i % CI;
      const int gh = t.h0 + pos / HW - 1, gw = t.w0 + pos % HW - 1;
      const int ci = ci0 + c;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (plane && gh >= 0 && gh < p.H && gw >= 0 && gw < p.W && ci < p.Cin)
        v = x[((((long long)t.b * p.D + di) * p.H + gh) * p.W + gw) * p.Cin +
              ci];
      xs[pos * XR + c] = v;
    }
  }
  if (p.Cout % 8 == 0) {
    copy_dy<8, CO, DR>(p, dys, t, co0);
  } else if (p.Cout % 4 == 0) {
    copy_dy<4, CO, DR>(p, dys, t, co0);
  } else {
    const __nv_bfloat16* dy = static_cast<const __nv_bfloat16*>(p.dy);
    for (int i = threadIdx.x; i < TH * TW * CO; i += THREADS) {
      const int pos = i / CO, c = i % CO;
      const int gh = t.h0 + pos / TW, gw = t.w0 + pos % TW, co = co0 + c;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (gh < p.H && gw < p.W && co < p.Cout)
        v = dy[((((long long)t.b * p.D + t.d) * p.H + gh) * p.W + gw) *
                   p.Cout + co];
      dys[pos * DR + c] = v;
    }
  }
}

template <int NF>
__host__ __device__ constexpr int dy_row() {   // CO + 8 elements
  return 8 * NF + 8;
}

template <int NF>
__host__ __device__ constexpr int stage_elems() {
  return HH * HW * XR + TH * TW * dy_row<NF>();
}

template <int NF>
__global__ void __launch_bounds__(THREADS) dw_bf16_kernel(Params p) {
  constexpr int CO = 8 * NF, DR = dy_row<NF>(), STAGE = stage_elems<NF>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tiles_co = (p.Cout + CO - 1) / CO;
  const int ci0 = (blockIdx.y / tiles_co) * CI;
  const int co0 = (blockIdx.y % tiles_co) * CO;
  const int kd = blockIdx.z;
  const int tap = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kh = tap / 3, kw = tap % 3;
  const int g = lane >> 2, t = lane & 3;
  const int j = lane >> 3, r = lane & 7;   // ldmatrix: matrix j, row r

  float acc[2][NF][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

  long long tile = blockIdx.x;
  int st = 0;
  if (tile < p.ntiles)
    stage_bf16<CO, DR>(p, buf, buf + HH * HW * XR, tile, kd, ci0, co0);
  cp_async_commit();
  for (; tile < p.ntiles; tile += p.nparts) {
    const long long next = tile + p.nparts;
    __nv_bfloat16* nb = buf + (st ^ 1) * STAGE;
    if (next < p.ntiles)
      stage_bf16<CO, DR>(p, nb, nb + HH * HW * XR, next, kd, ci0, co0);
    cp_async_commit();
    cp_async_wait_prev();   // this step's copies have landed
    __syncthreads();
    const __nv_bfloat16* xs = buf + st * STAGE;
    const __nv_bfloat16* dys = xs + HH * HW * XR;
#pragma unroll 2
    for (int ks = 0; ks < TH; ++ks) {
      // B (k = 16 positions of row ks, n = 8 co): matrices (k 0-7, n),
      // (k 8-15, n), (k 0-7, n + 1), (k 8-15, n + 1)
      unsigned bf[NF][2];
#pragma unroll
      for (int n = 0; n + 1 < NF; n += 2) {
        unsigned q[4];
        ldsm_x4_trans(q, dys + (ks * TW + r + (j & 1) * 8) * DR +
                             (n + (j >> 1)) * 8);
        bf[n][0] = q[0]; bf[n][1] = q[1];
        bf[n + 1][0] = q[2]; bf[n + 1][1] = q[3];
      }
      if constexpr ((NF & 1) != 0) {
        ldsm_x2_trans(bf[NF - 1],
                      dys + (ks * TW + r + (j & 1) * 8) * DR + (NF - 1) * 8);
      }
      // A (m = 16 ci, k = 16 positions shifted by (kh, kw)): matrices
      // (k 0-7, ci 0-7), (k 0-7, ci 8-15), (k 8-15, ci 0-7), (k 8-15, ...)
      const int hrow = (ks + kh) * HW + kw + r + (j >> 1) * 8;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        unsigned a[4];
        ldsm_x4_trans(a, xs + hrow * XR + m * 16 + (j & 1) * 8);
#pragma unroll
        for (int n = 0; n < NF; ++n)
          mma_bf16(acc[m][n], a, bf[n][0], bf[n][1]);
      }
    }
    __syncthreads();   // the stage is refilled two steps on
    st ^= 1;
  }

  // c0, c1: ci row g, co columns 2t, 2t + 1; c2, c3: ci row g + 8
  float* out = p.part + ((long long)blockIdx.x * 27 + kd * 9 + tap) *
                            p.Cin * p.Cout;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = ci0 + m * 16 + g + half * 8;
      if (ci >= p.Cin) continue;
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        const int co = co0 + n * 8 + 2 * t;
        if (co < p.Cout) out[(long long)ci * p.Cout + co] =
            acc[m][n][half * 2];
        if (co + 1 < p.Cout) out[(long long)ci * p.Cout + co + 1] =
            acc[m][n][half * 2 + 1];
      }
    }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs, one thread per (tap, ci)
// ---------------------------------------------------------------------------

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

template <int NF>
cudaError_t launch_bf16(const Params& p, dim3 grid, cudaStream_t stream) {
  const size_t smem = 2 * stage_elems<NF>() * sizeof(__nv_bfloat16);
  const cudaError_t err = cudaFuncSetAttribute(
      dw_bf16_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dw_bf16_kernel<NF><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, D, H, W, Cin) and dy (B, D, H, W, Cout) contiguous, float32 or
// bfloat16 (is_bf16); part (nparts, 27, Cin, Cout) float32, every element
// written: part p sums position tiles p, p + nparts, ... (tiles of 8 x 16
// (h, w) at one (b, d)). dw = part.sum(0). bfloat16 tiles Cout by 8 nf
// (nf one of 1, 2, 4, 6, 8), float32 by 32. Returns a cudaError_t value
// (0 = launched).
int conv3d_k3s1_dw(const void* x, const void* dy, float* part, int is_bf16,
                   int B, int D, int H, int W, int Cin, int Cout, int nf,
                   int nparts, void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 ||
      nparts < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.dy = dy; p.part = part;
  p.B = B; p.D = D; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout;
  p.tiles_h = (H + TH - 1) / TH;
  p.tiles_w = (W + TW - 1) / TW;
  p.nparts = nparts;
  p.ntiles = (long long)B * D * p.tiles_h * p.tiles_w;
  const int co_tile = is_bf16 ? 8 * nf : CO_F32;
  const long long nct =
      (long long)((Cin + CI - 1) / CI) * ((Cout + co_tile - 1) / co_tile);
  if (nct > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nparts, (unsigned)nct, 3u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    dw_f32_kernel<<<grid, THREADS, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  switch (nf) {
    case 1: return (int)launch_bf16<1>(p, grid, st);
    case 2: return (int)launch_bf16<2>(p, grid, st);
    case 4: return (int)launch_bf16<4>(p, grid, st);
    case 6: return (int)launch_bf16<6>(p, grid, st);
    case 8: return (int)launch_bf16<8>(p, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* conv3d_k3s1_dw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
