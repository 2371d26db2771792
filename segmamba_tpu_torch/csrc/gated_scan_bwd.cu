// Gated selective scan, backward, for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of the JAX package with one template:
//   K3  segmamba_tpu/ops/scan_pallas_dir.py:119   _dir_bwd_kernel
//       (flags REVERSE, GATE, HAS_ACC; driven by _dir_bwd_call :270 and the
//       custom VJP of _make_dir_core :350)
//   K4  segmamba_tpu/ops/scan_pallas_fused.py:73  _bwd_kernel
//       (= REVERSE=0, GATE=1, HAS_ACC=0; _bwd_call :168, _make_core :225)
//   K5  segmamba_tpu/ops/scan_pallas_dir.py:514   _slice_bwd_kernel
//       (= SLICE: REVERSE=0, GATE=1, HAS_ACC=0, scan-order step t at original
//       row (t mod S) P + floor(t / S); driven by _slice_bwd_call :555 and the
//       custom VJP of _make_slice_core :680; GATE=0 and HAS_ACC=1 are the
//       wrapper's chain over groups of 16 states when N > 16)
//   K6  segmamba_tpu/ops/scan_pallas.py:194       _bwd_kernel
//       (= SOFTPLUS=0, REVERSE=0, GATE=0, HAS_ACC=0, float32, D and bias
//       zero; _bwd_call :281, _make_core :333): the ungated core's adjoint,
//       seeded by dlast, the gradient of the returned last state. du and
//       ddt are then du and ddelta; the wrapper keeps du, ddelta, dA, dB, dC.
// It is the adjoint of csrc/gated_scan_fwd.cu and reads that kernel's chunk
// exit states (R, nc, N, D), float32, in scan order.
//
// Per row r, channel d, state n (N = 16) and scan-order step s, in float32:
//   delta = softplus(dt + bias) (SOFTPLUS=0: dt + bias),  a = exp(delta A),
//   x_s   = a_s x_{s-1} + delta_s B_s u_s
//   dy    = dout * silu(z)                (GATE; else dy = dout)
//   dz    = dout * ytot * (sig + silu (1 - sig)),  ytot = C.x + D u (+ acc)
//   dacc  = dy                            (GATE and HAS_ACC; the ungated link's
//                                          dacc = dout is set by the wrapper)
//   g_s   = C_s dy_s + a_{s+1} g_{s+1}    (adjoint, reverse scan order;
//                                          the last step's a g is dlast, or 0)
//   dp    = g_s x_{s-1} a_s;  S = sum_n g B
//   du    = S delta + dy D;   ddelta = sum_n dp A + S u;
//   ddt   = ddelta sigmoid(dt + bias)     (SOFTPLUS=0: ddelta)
//   dA    = sum_s dp delta;   dD = sum_s dy u;  dbias = sum_s ddt
//   dB_s  = sum_d g delta u;  dC_s = sum_d x dy
// du, ddt, dz and dacc are written in the storage dtype (float32 or
// bfloat16); the reductions are float32 per-block partials that the wrapper
// sums with torch.sum (no atomics, so every run gives the same bits).
//
// What bounds it on this card: like the forward, an elementwise recurrence
// with 16 states per (step, channel): exps (the SFU) and the bytes of the
// sequence operands, not the tensor cores. Two things make it harder than
// the forward:
// - The adjoint runs backwards while x runs forwards, and x cannot be walked
//   backwards by dividing by a (a = exp(delta A) underflows to 0 for A near
//   -16). Pass 3 recomputes x from checkpoints: a thread runs its chunk
//   forward from the chunk's entry state and stores x at every SUB-th step
//   (global scratch, its own addresses); then, sub-chunk by sub-chunk from
//   the last to the first, it replays SUB steps into shared memory and walks
//   g backwards through them.
// - L is long (262,144 steps at stage 0) and the adjoint carry is serial in
//   reverse scan order. The forward's three-pass answer carries over:
//   1. bwd_chunk:  one thread per (row, chunk, channel) runs the adjoint
//                  over its chunk from a zero entry (needs a, C and dy only,
//                  not x) and writes the chunk's zero-entry adjoint exit and
//                  its sum of delta (its decay is exp(A * sum delta)).
//   2. bwd_carry:  one thread per (row, state, channel) combines the chunk
//                  summaries in reverse scan order, starting from dlast (or
//                  0), and leaves each chunk's adjoint entry in place.
//   3. bwd_grad:   one block per (channel block, chunk, row) re-runs its
//                  chunk as above and forms every gradient. The sums over
//                  channels (dB, dC) are taken in shared memory per
//                  sub-chunk, one partial per channel block.
// With one chunk there is no carry pass, and pass 3 starts from dlast itself.
// Chunks are the forward's (multiples of T on the original layout). With
// REVERSE the chunks and the steps in a chunk are walked in the mirrored
// order on the same layout, so the ragged tail chunk is the first in scan
// order and masked steps never enter any state or gradient.
//
// The kernel allocates nothing: the caller passes every output, partial and
// scratch buffer. At K6's prefill shape (R = 2, L = 2048, D = 5120) the
// dB/dC partials (nbd, R, L, N) are 40 x 2 x 2048 x 16 floats, 10.5 MB each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NS = 16;   // state size N the kernel is built for
constexpr int SUB = 8;   // steps per replayed sub-chunk in pass 3
constexpr int CARRY_THREADS = 256;

struct Params {
  const void* u;
  const void* dt;
  const void* z;
  const void* acc;
  const void* B;
  const void* C;
  const void* dout;      // (R, L, D) contiguous
  const float* A;        // (R|1, D, NS)
  const float* Dv;       // (R|1, D)
  const float* bias;     // (R|1, D)
  const float* states;   // (R, nc, NS, D), scan order (forward exit states)
  const float* dlast;    // (R, NS, D) adjoint seed of the last state, or null
  void* du;              // (R, L, D) contiguous, storage dtype
  void* ddt;
  void* dz;
  void* dacc;
  float* dA_p;           // (R, nc, NS, D)
  float* dD_p;           // (R, nc, D)
  float* dbias_p;        // (R, nc, D)
  float* dB_p;           // (nbd, R, L, NS)
  float* dC_p;           // (nbd, R, L, NS)
  float* gbuf;           // (R, nc, NS, D) scratch (nc > 1)
  float* sdelta;         // (R, nc, D) scratch (nc > 1)
  float* ckpt;           // (R, nc, nsub, NS, D) scratch
  long long R, L, D;
  int T, nc, nsub;
  unsigned S, P;         // SLICE: slices and positions (L = S P)
  long long su_r, su_l, sdt_r, sdt_l, sz_r, sz_l, sacc_r, sacc_l;
  long long sB_r, sB_l, sC_r, sC_l;
  long long sA_r, sDv_r, sbias_r;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename S> __device__ __forceinline__ S from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(__expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + __expf(-x));
}

// delta from dt + bias: softplus of it, or (K6) as it is.
template <bool SOFTPLUS>
__device__ __forceinline__ float delta_of(float x) {
  return SOFTPLUS ? softplus_f(x) : x;
}

// Original row of scan-order step tt: itself, or with SLICE the step's place
// in the slice-major layout (as in gated_scan_fwd.cu).
template <bool SLICE>
__device__ __forceinline__ long long row_of(const Params& p, long long tt) {
  if (!SLICE) return tt;
  const unsigned t = (unsigned)tt;
  return (long long)(t % p.S) * p.P + t / p.S;
}

// Stage scan-order steps [t0, t0 + len) of B and/or C of row r into shared
// memory.
template <typename S, bool WITH_B, bool WITH_C, bool SLICE>
__device__ __forceinline__ void stage_bc(const Params& p, long long r,
                                         long long t0, int len, float* sB,
                                         float* sC) {
  const S* B = static_cast<const S*>(p.B) + r * p.sB_r;
  const S* C = static_cast<const S*>(p.C) + r * p.sC_r;
  for (int i = threadIdx.x; i < len * NS; i += blockDim.x) {
    const long long t = row_of<SLICE>(p, t0 + i / NS);
    const int n = i % NS;
    if (WITH_B) sB[i] = to_f(B[t * p.sB_l + n]);
    if (WITH_C) sC[i] = to_f(C[t * p.sC_l + n]);
  }
  __syncthreads();
}

// dy = dout * silu(z) with the gate, dout without it.
template <typename S, bool GATE>
__device__ __forceinline__ float dy_at(const S* dout, const S* z,
                                       long long tt, long long sz_l,
                                       long long D) {
  const float g = to_f(dout[tt * D]);
  if (!GATE) return g;
  const float zz = to_f(z[tt * sz_l]);
  return g * zz * sigmoid_f(zz);
}

// Pass 1: zero-entry adjoint over each chunk, in reverse scan order.
template <typename S, bool REVERSE, bool GATE, bool SOFTPLUS, bool SLICE>
__global__ void bwd_chunk_kernel(Params p) {
  extern __shared__ float smem[];
  float* sC = smem;
  const long long r = blockIdx.z;
  const int c = blockIdx.y;
  const long long d = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long t0 = (long long)c * p.T;
  const int len = (int)min((long long)p.T, p.L - t0);
  stage_bc<S, false, true, SLICE>(p, r, t0, len, nullptr, sC);
  if (d >= p.D) return;

  float A[NS], g[NS];
  const float* Ar = p.A + r * p.sA_r + d * NS;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    A[n] = Ar[n];
    g[n] = 0.f;
  }
  const float bias = p.bias[r * p.sbias_r + d];
  const S* dt = static_cast<const S*>(p.dt) + r * p.sdt_r + d;
  const S* z = GATE ? static_cast<const S*>(p.z) + r * p.sz_r + d : nullptr;
  const S* dout = static_cast<const S*>(p.dout) + r * p.L * p.D + d;
  float sd = 0.f;
  for (int i = len - 1; i >= 0; --i) {  // scan order, last step first
    const int t = REVERSE ? len - 1 - i : i;
    const long long tt = row_of<SLICE>(p, t0 + t);
    const float delta = delta_of<SOFTPLUS>(to_f(dt[tt * p.sdt_l]) + bias);
    const float dy = dy_at<S, GATE>(dout, z, tt, p.sz_l, p.D);
    sd += delta;
    const float* cc = sC + t * NS;
#pragma unroll
    for (int n = 0; n < NS; ++n)
      g[n] = __expf(delta * A[n]) * (cc[n] * dy + g[n]);
  }
  float* gb = p.gbuf + ((r * p.nc + c) * NS) * p.D + d;
#pragma unroll
  for (int n = 0; n < NS; ++n) gb[n * p.D] = g[n];
  p.sdelta[(r * p.nc + c) * p.D + d] = sd;
}

// Pass 2: adjoint carry over the chunk summaries, last scan chunk first,
// from the seed dlast (or 0); leaves each chunk's adjoint entry
// (a_{s+1} g_{s+1} at its last step).
template <bool REVERSE>
__global__ void bwd_carry_kernel(Params p) {
  const long long r = blockIdx.y;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= NS * p.D) return;
  const int n = (int)(idx / p.D);
  const long long d = idx % p.D;
  const float a = p.A[r * p.sA_r + d * NS + n];
  float carry = p.dlast != nullptr ? p.dlast[(r * NS + n) * p.D + d] : 0.f;
  for (int i = 0; i < p.nc; ++i) {
    const long long c = REVERSE ? i : p.nc - 1 - i;
    const long long hi = ((r * p.nc + c) * NS + n) * p.D + d;
    const float h = p.gbuf[hi];
    const float sd = p.sdelta[(r * p.nc + c) * p.D + d];
    p.gbuf[hi] = carry;
    carry = __expf(a * sd) * carry + h;
  }
}

// Pass 3: recompute x from checkpoints, walk g backwards, form gradients.
// Shared memory: B and C of the chunk (2 T NS), then per sub-chunk
// xs (SUB NS ld: x after the replay, g after the walk), dys, dtrs and us
// (SUB ld each: dy, dt + bias, u; u becomes delta u in the walk), with the
// channel fastest and ld = blockDim.x + 1 so that the per-step sums over
// channels do not hit one bank.
template <typename S, bool REVERSE, bool GATE, bool HAS_ACC, bool SOFTPLUS,
          bool SLICE>
__global__ void bwd_grad_kernel(Params p) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int ld = nt + 1;
  float* sB = smem;
  float* sC = sB + p.T * NS;
  float* xs = sC + p.T * NS;
  float* dys = xs + SUB * NS * ld;
  float* dtrs = dys + SUB * ld;
  float* us = dtrs + SUB * ld;

  const long long r = blockIdx.z;
  const int c = blockIdx.y;
  const long long d = (long long)blockIdx.x * nt + tid;
  const long long t0 = (long long)c * p.T;
  const int len = (int)min((long long)p.T, p.L - t0);
  const int vc = REVERSE ? p.nc - 1 - c : c;  // scan-order chunk index
  stage_bc<S, true, true, SLICE>(p, r, t0, len, sB, sC);
  const bool on = d < p.D;

  float A[NS];
  float bias = 0.f, Dv = 0.f;
  if (on) {
    const float* Ar = p.A + r * p.sA_r + d * NS;
#pragma unroll
    for (int n = 0; n < NS; ++n) A[n] = Ar[n];
    bias = p.bias[r * p.sbias_r + d];
    Dv = p.Dv[r * p.sDv_r + d];
  } else {
#pragma unroll
    for (int n = 0; n < NS; ++n) A[n] = 0.f;
  }
  const long long dd = on ? d : 0;
  const S* u = static_cast<const S*>(p.u) + r * p.su_r + dd;
  const S* dt = static_cast<const S*>(p.dt) + r * p.sdt_r + dd;
  const S* z = GATE ? static_cast<const S*>(p.z) + r * p.sz_r + dd : nullptr;
  const S* acc =
      HAS_ACC ? static_cast<const S*>(p.acc) + r * p.sacc_r + dd : nullptr;
  const S* dout = static_cast<const S*>(p.dout) + r * p.L * p.D + dd;
  S* du = static_cast<S*>(p.du) + r * p.L * p.D + dd;
  S* ddt = static_cast<S*>(p.ddt) + r * p.L * p.D + dd;
  S* dz = GATE ? static_cast<S*>(p.dz) + r * p.L * p.D + dd : nullptr;
  S* dacc = (GATE && HAS_ACC) ? static_cast<S*>(p.dacc) + r * p.L * p.D + dd
                              : nullptr;
  float* ck = p.ckpt + ((r * p.nc + c) * p.nsub) * NS * p.D + dd;

  // forward over the chunk from its entry state, checkpointing x before
  // every SUB-th step (scan order)
  if (on) {
    float x[NS];
    if (vc > 0) {
      const float* st = p.states + ((r * p.nc + vc - 1) * NS) * p.D + d;
#pragma unroll
      for (int n = 0; n < NS; ++n) x[n] = st[n * p.D];
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n) x[n] = 0.f;
    }
    for (int i = 0; i < len; ++i) {
      if (i % SUB == 0) {
        float* ckj = ck + (long long)(i / SUB) * NS * p.D;
#pragma unroll
        for (int n = 0; n < NS; ++n) ckj[n * p.D] = x[n];
      }
      const int t = REVERSE ? len - 1 - i : i;
      const long long tt = row_of<SLICE>(p, t0 + t);
      const float delta = delta_of<SOFTPLUS>(to_f(dt[tt * p.sdt_l]) + bias);
      const float dlu = delta * to_f(u[tt * p.su_l]);
      const float* b = sB + t * NS;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        x[n] = __expf(delta * A[n]) * x[n] + dlu * b[n];
    }
  }

  float g[NS], dA[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    g[n] = 0.f;
    dA[n] = 0.f;
  }
  // adjoint entry: left by bwd_carry, or with one chunk the seed itself
  const float* gb = p.nc > 1 ? p.gbuf + ((r * p.nc + c) * NS) * p.D + d
                    : p.dlast != nullptr ? p.dlast + r * NS * p.D + d
                                         : nullptr;
  if (on && gb != nullptr) {
#pragma unroll
    for (int n = 0; n < NS; ++n) g[n] = gb[n * p.D];
  }
  float dDs = 0.f, dbs = 0.f;
  const long long bd = blockIdx.x;
  float* dBp = p.dB_p + (bd * p.R + r) * p.L * NS;
  float* dCp = p.dC_p + (bd * p.R + r) * p.L * NS;

  for (int j = (len + SUB - 1) / SUB - 1; j >= 0; --j) {
    const int i0 = j * SUB;
    const int klen = min(SUB, len - i0);
    const float* ckj = ck + (long long)j * NS * p.D;
    // replay the sub-chunk: x, dy, dz and dacc per step
    if (on) {
      float x[NS];
#pragma unroll
      for (int n = 0; n < NS; ++n) x[n] = ckj[n * p.D];
      for (int k = 0; k < klen; ++k) {
        const int t = REVERSE ? len - 1 - (i0 + k) : i0 + k;
        const long long tt = row_of<SLICE>(p, t0 + t);
        const float dtraw = to_f(dt[tt * p.sdt_l]) + bias;
        const float delta = delta_of<SOFTPLUS>(dtraw);
        const float uu = to_f(u[tt * p.su_l]);
        const float dlu = delta * uu;
        const float* b = sB + t * NS;
        const float* cc = sC + t * NS;
        float y = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          x[n] = __expf(delta * A[n]) * x[n] + dlu * b[n];
          y += cc[n] * x[n];
          xs[(k * NS + n) * ld + tid] = x[n];
        }
        const float g_out = to_f(dout[tt * p.D]);
        float dy = g_out;
        if (GATE) {
          float ytot = y + Dv * uu;
          if (HAS_ACC) ytot += to_f(acc[tt * p.sacc_l]);
          const float zz = to_f(z[tt * p.sz_l]);
          const float sig = sigmoid_f(zz);
          const float silu = zz * sig;
          dz[tt * p.D] = from_f<S>(g_out * ytot * (sig + silu * (1.f - sig)));
          dy = g_out * silu;
          if (HAS_ACC) dacc[tt * p.D] = from_f<S>(dy);
        }
        dys[k * ld + tid] = dy;
        dtrs[k * ld + tid] = dtraw;
        us[k * ld + tid] = uu;
      }
    } else {
      for (int k = 0; k < klen; ++k) {
#pragma unroll
        for (int n = 0; n < NS; ++n) xs[(k * NS + n) * ld + tid] = 0.f;
        dys[k * ld + tid] = 0.f;
        dtrs[k * ld + tid] = 0.f;
        us[k * ld + tid] = 0.f;
      }
    }
    __syncthreads();
    // dC[t, n] = sum over the block's channels of x dy
    for (int idx = tid; idx < klen * NS; idx += nt) {
      const int k = idx / NS, n = idx % NS;
      const float* xr = xs + (k * NS + n) * ld;
      const float* dr = dys + k * ld;
      float s = 0.f;
      for (int q = 0; q < nt; ++q) s += xr[q] * dr[q];
      const int t = REVERSE ? len - 1 - (i0 + k) : i0 + k;
      dCp[row_of<SLICE>(p, t0 + t) * NS + n] = s;
    }
    __syncthreads();
    // adjoint walk, last step of the sub-chunk first
    if (on) {
      for (int k = klen - 1; k >= 0; --k) {
        const int t = REVERSE ? len - 1 - (i0 + k) : i0 + k;
        const long long tt = row_of<SLICE>(p, t0 + t);
        const float dtraw = dtrs[k * ld + tid];
        const float delta = delta_of<SOFTPLUS>(dtraw);
        const float uu = us[k * ld + tid];
        const float dy = dys[k * ld + tid];
        const float* b = sB + t * NS;
        const float* cc = sC + t * NS;
        float Ssum = 0.f, ddl = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float gn = cc[n] * dy + g[n];
          const float xprev =
              k > 0 ? xs[((k - 1) * NS + n) * ld + tid] : ckj[n * p.D];
          const float a = __expf(delta * A[n]);
          const float dp = gn * xprev * a;
          dA[n] += dp * delta;
          ddl += dp * A[n];
          Ssum += gn * b[n];
          g[n] = a * gn;
          xs[(k * NS + n) * ld + tid] = gn;
        }
        const float ddelta = ddl + Ssum * uu;
        const float ddt_v = SOFTPLUS ? ddelta * sigmoid_f(dtraw) : ddelta;
        du[tt * p.D] = from_f<S>(Ssum * delta + dy * Dv);
        ddt[tt * p.D] = from_f<S>(ddt_v);
        dDs += dy * uu;
        dbs += ddt_v;
        us[k * ld + tid] = delta * uu;
      }
    }
    __syncthreads();
    // dB[t, n] = sum over the block's channels of g delta u
    for (int idx = tid; idx < klen * NS; idx += nt) {
      const int k = idx / NS, n = idx % NS;
      const float* gr = xs + (k * NS + n) * ld;
      const float* ur = us + k * ld;
      float s = 0.f;
      for (int q = 0; q < nt; ++q) s += gr[q] * ur[q];
      const int t = REVERSE ? len - 1 - (i0 + k) : i0 + k;
      dBp[row_of<SLICE>(p, t0 + t) * NS + n] = s;
    }
    __syncthreads();
  }

  if (on) {
    float* dAp = p.dA_p + ((r * p.nc + c) * NS) * p.D + d;
#pragma unroll
    for (int n = 0; n < NS; ++n) dAp[n * p.D] = dA[n];
    p.dD_p[(r * p.nc + c) * p.D + d] = dDs;
    p.dbias_p[(r * p.nc + c) * p.D + d] = dbs;
  }
}

size_t grad_smem(int T, int threads) {
  const size_t ld = (size_t)threads + 1;
  return (2 * (size_t)T * NS + SUB * NS * ld + 3 * SUB * ld) * sizeof(float);
}

template <typename S, bool REVERSE, bool GATE, bool HAS_ACC, bool SOFTPLUS,
          bool SLICE = false>
cudaError_t launch_grad(const Params& p, dim3 grid, int threads,
                        cudaStream_t stream) {
  const size_t smem = grad_smem(p.T, threads);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_grad_kernel<S, REVERSE, GATE, HAS_ACC, SOFTPLUS, SLICE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bwd_grad_kernel<S, REVERSE, GATE, HAS_ACC, SOFTPLUS, SLICE>
      <<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename S, bool REVERSE, bool SOFTPLUS, bool SLICE = false>
cudaError_t launch(const Params& p, bool gate, bool has_acc, int threads,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((p.D + threads - 1) / threads), (unsigned)p.nc,
                  (unsigned)p.R);
  cudaError_t err;
  if (p.nc > 1) {
    const size_t smem = (size_t)p.T * NS * sizeof(float);
    if constexpr (!SOFTPLUS)  // K6: ungated
      bwd_chunk_kernel<S, REVERSE, false, false, false>
          <<<grid, threads, smem, stream>>>(p);
    else if (gate)
      bwd_chunk_kernel<S, REVERSE, true, true, SLICE>
          <<<grid, threads, smem, stream>>>(p);
    else
      bwd_chunk_kernel<S, REVERSE, false, true, SLICE>
          <<<grid, threads, smem, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const dim3 g2((unsigned)((NS * p.D + CARRY_THREADS - 1) / CARRY_THREADS),
                  (unsigned)p.R);
    bwd_carry_kernel<REVERSE><<<g2, CARRY_THREADS, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if constexpr (!SOFTPLUS) {  // K6: ungated, no acc
    return launch_grad<S, REVERSE, false, false, false>(p, grid, threads,
                                                        stream);
  } else {
    if (gate && has_acc)
      return launch_grad<S, REVERSE, true, true, true, SLICE>(p, grid,
                                                              threads,
                                                              stream);
    if (gate)  // K5's own flags with SLICE
      return launch_grad<S, REVERSE, true, false, true, SLICE>(p, grid,
                                                               threads,
                                                               stream);
    return launch_grad<S, REVERSE, false, false, true, SLICE>(p, grid,
                                                              threads,
                                                              stream);
  }
}

}  // namespace

extern "C" {

// strides: u_r, u_l, dt_r, dt_l, z_r, z_l, acc_r, acc_l, B_r, B_l, C_r, C_l,
//          A_r, Dv_r, bias_r (elements; host array of 15), as gated_scan_fwd.
// ckpt holds ceil(T / gated_scan_bwd_sub_len()) sub-chunk checkpoints per
// chunk: (R, nc, nsub, N, D) float32. dlast (R, N, D) float32 or null seeds
// the adjoint of the last state in scan order. softplus = 0 is K6's mode:
// float32, no reverse, no gate, no acc. nslices > 0 is K5's mode (SLICE,
// nslices | L): forward, gate and acc as for K1; dB / dC partials at
// original rows.
// Returns a cudaError_t value (0 = launched).
int gated_scan_bwd(const void* u, const void* dt, const void* z,
                   const void* acc, const void* B, const void* C,
                   const void* dout, const float* A, const float* Dv,
                   const float* bias, const float* states,
                   const float* dlast, void* du, void* ddt, void* dz,
                   void* dacc, float* dA_p, float* dD_p, float* dbias_p,
                   float* dB_p, float* dC_p, float* gbuf, float* sdelta,
                   float* ckpt, int is_bf16, int reverse, int gate,
                   int has_acc, int softplus, long long nslices, long long R,
                   long long L, long long D, int N, int T, int threads,
                   const long long* strides, void* stream) {
  if (N != NS || T < 1 || T > 256 || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || R < 1 || L < 1 || D < 1 || R > 65535 ||
      L > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!softplus && (is_bf16 || reverse || gate || has_acc || nslices))
    return (int)cudaErrorInvalidValue;
  if (nslices && (nslices < 1 || L % nslices || reverse))
    return (int)cudaErrorInvalidValue;
  const long long nc = (L + T - 1) / T;
  if (nc > 65535) return (int)cudaErrorInvalidValue;
  if (grad_smem(T, threads) > 232448) return (int)cudaErrorInvalidValue;
  if ((nc > 1 && (states == nullptr || gbuf == nullptr ||
                  sdelta == nullptr)) ||
      ckpt == nullptr || (gate && (z == nullptr || dz == nullptr)) ||
      (gate && has_acc && (acc == nullptr || dacc == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.u = u; p.dt = dt; p.z = z; p.acc = acc; p.B = B; p.C = C; p.dout = dout;
  p.A = A; p.Dv = Dv; p.bias = bias; p.states = states; p.dlast = dlast;
  p.du = du; p.ddt = ddt; p.dz = dz; p.dacc = dacc;
  p.dA_p = dA_p; p.dD_p = dD_p; p.dbias_p = dbias_p; p.dB_p = dB_p;
  p.dC_p = dC_p; p.gbuf = gbuf; p.sdelta = sdelta; p.ckpt = ckpt;
  p.R = R; p.L = L; p.D = D; p.T = T; p.nc = (int)nc;
  p.nsub = (T + SUB - 1) / SUB;
  p.S = nslices ? (unsigned)nslices : 1u;
  p.P = (unsigned)(L / p.S);
  p.su_r = strides[0]; p.su_l = strides[1];
  p.sdt_r = strides[2]; p.sdt_l = strides[3];
  p.sz_r = strides[4]; p.sz_l = strides[5];
  p.sacc_r = strides[6]; p.sacc_l = strides[7];
  p.sB_r = strides[8]; p.sB_l = strides[9];
  p.sC_r = strides[10]; p.sC_l = strides[11];
  p.sA_r = strides[12]; p.sDv_r = strides[13]; p.sbias_r = strides[14];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool g = gate != 0, a = has_acc != 0;
  cudaError_t err;
  if (!softplus)
    err = launch<float, false, false>(p, false, false, threads, st);
  else if (nslices)
    err = is_bf16 ? launch<__nv_bfloat16, false, true, true>(p, g, a,
                                                             threads, st)
                  : launch<float, false, true, true>(p, g, a, threads, st);
  else if (is_bf16)
    err = reverse ? launch<__nv_bfloat16, true, true>(p, g, a, threads, st)
                  : launch<__nv_bfloat16, false, true>(p, g, a, threads, st);
  else
    err = reverse ? launch<float, true, true>(p, g, a, threads, st)
                  : launch<float, false, true>(p, g, a, threads, st);
  return (int)err;
}

// Steps per sub-chunk checkpoint; the caller sizes ckpt from it.
int gated_scan_bwd_sub_len(void) { return SUB; }

const char* gated_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
