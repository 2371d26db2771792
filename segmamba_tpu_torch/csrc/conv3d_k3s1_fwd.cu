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
// to fill 128-lane MXU tiles, materialises overlapping H blocks in HBM and
// adds 9 shifted slices of P in VMEM. None of that is carried over. Here
// the conv is an implicit GEMM: M = output positions, N = Cout, K = 27 Cin,
// the K loop running over (kd, a chunk of 16 input channels) stages and,
// inside each stage, over the 9 in-plane taps:
//   - a block owns a 16 x 16 tile of output positions (h, w) at one (b, d)
//     and NT = 8 NF output channels; it stages in shared memory the
//     18 x 18 input halo of its tile for one depth tap and 16 channels,
//     zero outside the volume (edges and ragged H, W masked here, no
//     padded copy of x exists), and the stage's 9 x NT x 16 weights;
//   - bfloat16: 8 warps, each two rows of 16 positions (two m16 tiles);
//     per tap the A fragment is 16 consecutive positions of one halo row
//     shifted by (kh, kw) and 16 channels, the B fragment the tap's
//     16 x 8 weights, on the tensor cores with warp-level
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate), fragments loaded from
//     shared memory with rows padded to 12 words (no bank conflicts);
//   - float32: exact FMAs on the CUDA cores (no TF32, which would break the
//     f32 tier), one thread per output position and NT accumulators, the
//     stage's weights read as broadcasts.
// The wrapper pads Cin to a multiple of 16 and Cout to a multiple of NT in
// the weights only (zero rows), so Cin = 4 (encoder1's first conv, K = 108)
// runs as one ragged stage and the output is masked at Cout.
//
// What bounds it on this card: the products, 2 * 27 * Cin * Cout flops per
// position (261 GFLOP at 128^3, 48 -> 48: 0.26 ms at 989 TFLOP/s bf16),
// against 0.12 ms of bytes. mma.sync reaches a fraction of the tensor
// cores' wgmma rate, and the stage loop synchronises twice per 16 channels
// without overlapping loads and products; TMA, wgmma and a multi-stage ring
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 16, TW = 16;           // output tile (h, w) per block
constexpr int HH = TH + 2, HW = TW + 2;   // input halo of the tile
constexpr int CK = 16;                    // input channels per stage
constexpr int THREADS = 256;              // 8 warps

// Halo / weight row stride in elements: bf16 rows of 12 words keep the
// fragment loads free of bank conflicts; float32 rows of 17 the
// thread-per-position loads.
template <typename T> struct Row;
template <> struct Row<__nv_bfloat16> { static constexpr int S = 24; };
template <> struct Row<float> { static constexpr int S = 17; };

struct Params {
  const void* x;    // (B, D, H, W, Cin)
  const void* wt;   // (27, cout_pad, cin_pad), zero padded
  void* y;          // (B, D, H, W, Cout)
  int B, D, H, W, Cin, Cout, cin_pad, cout_pad, tiles_w;
};

// The stage's input halo: plane d + kd - 1, rows h0 - 1 .. h0 + TH, columns
// w0 - 1 .. w0 + TW, channels c0 .. c0 + 15, zero outside; smem[pos][c].
template <typename T>
__device__ void stage_halo(const Params& p, T* halo, int b, int d, int kd,
                           int h0, int w0, int c0) {
  constexpr int RS = Row<T>::S;
  const T* x = static_cast<const T*>(p.x);
  const int di = d + kd - 1;
  const bool plane = di >= 0 && di < p.D;
  const bool vec = (p.Cin % 8) == 0;  // whole 8-channel groups, aligned
  if (vec) {
    // 8 channels per 16 (bf16) or 32 (f32) bytes
    for (int i = threadIdx.x; i < HH * HW * 2; i += THREADS) {
      const int pos = i >> 1, half = i & 1;
      const int gh = h0 + pos / HW - 1, gw = w0 + pos % HW - 1;
      const int c = c0 + half * 8;
      T* dst = halo + pos * RS + half * 8;
      if (plane && gh >= 0 && gh < p.H && gw >= 0 && gw < p.W &&
          c < p.Cin) {
        const T* src =
            x + ((((long long)b * p.D + di) * p.H + gh) * p.W + gw) * p.Cin +
            c;
        if constexpr (sizeof(T) == 2) {
          const uint4 v = *reinterpret_cast<const uint4*>(src);
          const unsigned* vv = reinterpret_cast<const unsigned*>(&v);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            reinterpret_cast<unsigned*>(dst)[j] = vv[j];
        } else {
          const float4 v0 = reinterpret_cast<const float4*>(src)[0];
          const float4 v1 = reinterpret_cast<const float4*>(src)[1];
          float* f = reinterpret_cast<float*>(dst);
          f[0] = v0.x; f[1] = v0.y; f[2] = v0.z; f[3] = v0.w;
          f[4] = v1.x; f[5] = v1.y; f[6] = v1.z; f[7] = v1.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[j] = T(0.f);
      }
    }
  } else {
    for (int i = threadIdx.x; i < HH * HW * CK; i += THREADS) {
      const int pos = i / CK, cc = i % CK;
      const int gh = h0 + pos / HW - 1, gw = w0 + pos % HW - 1;
      const int c = c0 + cc;
      T v = T(0.f);
      if (plane && gh >= 0 && gh < p.H && gw >= 0 && gw < p.W && c < p.Cin)
        v = x[((((long long)b * p.D + di) * p.H + gh) * p.W + gw) * p.Cin +
              c];
      halo[pos * RS + cc] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores, mma.sync m16n8k16
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float* c, unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <int NF>
__global__ void __launch_bounds__(THREADS)
    conv_bf16_kernel(Params p) {
  constexpr int NT = 8 * NF, RS = Row<__nv_bfloat16>::S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ws = halo + HH * HW * RS;   // [9][NT][RS]
  const int tile = blockIdx.x;
  const int h0 = (tile / p.tiles_w) * TH, w0 = (tile % p.tiles_w) * TW;
  const int b = blockIdx.y / p.D, d = blockIdx.y % p.D;
  const int co0 = blockIdx.z * NT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* wt = static_cast<const __nv_bfloat16*>(p.wt);

  float acc[2][NF][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.f;

  for (int kd = 0; kd < 3; ++kd) {
    for (int c0 = 0; c0 < p.cin_pad; c0 += CK) {
      stage_halo(p, halo, b, d, kd, h0, w0, c0);
      // weights of the 9 in-plane taps: ws[tap][co][ci], two uint4 a row
      for (int i = threadIdx.x; i < 9 * NT * 2; i += THREADS) {
        const int row = i >> 1, half = i & 1;
        const int tap = row / NT, co = row % NT;
        const uint4 v = *reinterpret_cast<const uint4*>(
            wt + ((long long)(kd * 9 + tap) * p.cout_pad + co0 + co) *
                     p.cin_pad + c0 + half * 8);
        unsigned* dst = reinterpret_cast<unsigned*>(ws + row * RS + half * 8);
        dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
      }
      __syncthreads();
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int kh = tap / 3, kw = tap % 3;
        unsigned bf[NF][2];
#pragma unroll
        for (int n = 0; n < NF; ++n) {
          const __nv_bfloat16* wr = ws + (tap * NT + n * 8 + g) * RS + 2 * t;
          bf[n][0] = ld32(wr);
          bf[n][1] = ld32(wr + 8);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int base = (warp * 2 + m + kh) * HW + kw;
          const __nv_bfloat16* r0 = halo + (base + g) * RS + 2 * t;
          const __nv_bfloat16* r1 = halo + (base + g + 8) * RS + 2 * t;
          const unsigned a0 = ld32(r0), a1 = ld32(r1);
          const unsigned a2 = ld32(r0 + 8), a3 = ld32(r1 + 8);
#pragma unroll
          for (int n = 0; n < NF; ++n)
            mma_bf16(acc[m][n], a0, a1, a2, a3, bf[n][0], bf[n][1]);
        }
      }
      __syncthreads();
    }
  }

  // c0, c1: position g, channels 2t, 2t + 1; c2, c3: position g + 8
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int h = h0 + warp * 2 + m;
    if (h >= p.H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int w = w0 + g + half * 8;
      if (w >= p.W) continue;
      __nv_bfloat16* yr =
          y + ((((long long)b * p.D + d) * p.H + h) * p.W + w) * p.Cout;
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        const int co = co0 + n * 8 + 2 * t;
        const float v0 = acc[m][n][half * 2], v1 = acc[m][n][half * 2 + 1];
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

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs, one thread per output position
// ---------------------------------------------------------------------------

template <int NF>
__global__ void __launch_bounds__(THREADS)
    conv_f32_kernel(Params p) {
  constexpr int NT = 8 * NF, RS = Row<float>::S;
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

template <typename T>
constexpr size_t smem_bytes(int nf) {
  return (size_t)(HH * HW * Row<T>::S) * sizeof(T) +
         (size_t)9 * 8 * nf * (sizeof(T) == 2 ? Row<T>::S : CK) * sizeof(T);
}

template <int NF>
cudaError_t launch(const Params& p, bool bf16, cudaStream_t stream) {
  const dim3 grid((unsigned)(p.tiles_w * ((p.H + TH - 1) / TH)),
                  (unsigned)(p.B * p.D), (unsigned)(p.cout_pad / (8 * NF)));
  cudaError_t err;
  if (bf16) {
    const size_t smem = smem_bytes<__nv_bfloat16>(NF);
    err = cudaFuncSetAttribute(conv_bf16_kernel<NF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    conv_bf16_kernel<NF><<<grid, THREADS, smem, stream>>>(p);
  } else {
    const size_t smem = smem_bytes<float>(NF);
    err = cudaFuncSetAttribute(conv_f32_kernel<NF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    conv_f32_kernel<NF><<<grid, THREADS, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, D, H, W, Cin) and y (B, D, H, W, Cout) contiguous, float32 or
// bfloat16 (is_bf16); wt (27, cout_pad, cin_pad) in the same type, zero
// beyond (Cout, Cin): tap kd * 9 + kh * 3 + kw, row co, column ci.
// cin_pad is a multiple of 16, cout_pad of 8 * nf, nf one of 1, 2, 4, 6, 8.
// Returns a cudaError_t value (0 = launched).
int conv3d_k3s1_fwd(const void* x, const void* wt, void* y, int is_bf16,
                    int B, int D, int H, int W, int Cin, int Cout,
                    int cin_pad, int cout_pad, int nf, void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 ||
      cin_pad < Cin || cin_pad % CK || cout_pad < Cout ||
      cout_pad % (8 * nf) || (long long)B * D > 65535 ||
      cout_pad / (8 * nf) > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.wt = wt; p.y = y;
  p.B = B; p.D = D; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout;
  p.cin_pad = cin_pad; p.cout_pad = cout_pad;
  p.tiles_w = (W + TW - 1) / TW;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  switch (nf) {
    case 1: return (int)launch<1>(p, bf, st);
    case 2: return (int)launch<2>(p, bf, st);
    case 4: return (int)launch<4>(p, bf, st);
    case 6: return (int)launch<6>(p, bf, st);
    case 8: return (int)launch<8>(p, bf, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* conv3d_k3s1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
