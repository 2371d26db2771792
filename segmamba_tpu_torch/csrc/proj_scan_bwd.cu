// Projection-fused gated selective scan, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
//   K8  segmamba_tpu/ops/scan_pallas_proj.py:134  _proj_bwd_kernel
//       (flags REVERSE, GATE, HAS_ACC; driven by _proj_bwd_call :200 and the
//       custom VJP of _make_proj_core :369)
// It is the adjoint of csrc/proj_scan_fwd.cu and reads that kernel's chunk
// exit states (R, nc, N, E), float32, in scan order.
//
// Per row, channel e, state n (N = 16) and scan-order step s, in float32,
// with x_dbl = xc W (W = [W_dt | W_B | W_C]), xdt = x_dbl[:, :Rk],
// B = x_dbl[:, Rk:Rk+N], C = x_dbl[:, Rk+N:], dt_raw = xdt dt_proj + bias,
// delta = softplus(dt_raw), a = exp(delta A):
//   dy    = dout * silu(z)               (GATE; else dy = dout)
//   dz    = dout * ytot * (sig + silu (1 - sig)),  ytot = C.x + D xc (+ acc)
//   dacc  = dy                           (GATE and HAS_ACC; the ungated
//                                         link's dacc = dout is the wrapper's)
//   g_s   = C_s dy_s + a_{s+1} g_{s+1}   (adjoint, reverse scan order)
//   dp    = g_s x_{s-1} a_s;  Ssum = sum_n g B
//   ddt_raw = (sum_n dp A + Ssum xc) sigmoid(dt_raw)
//   dB_s  = sum_e g delta xc;  dC_s = sum_e x dy;  dxdt_s = ddt_raw dt_proj^T
//   dxc   = Ssum delta + dy D + dxdt W_dt^T + dB W_B^T + dC W_C^T
//   dW    = xc^T [dxdt | dB | dC];  d dt_proj = xdt^T ddt_raw
//   dbias = sum_s ddt_raw;  dA = sum_s dp delta;  dD = sum_s dy xc
// dxc, dz and dacc are written in the storage dtype; the weight gradients
// are float32 partials, one per block (row, chunk) of E (2 Rk + 3N + 2)
// floats, that the wrapper sums with torch.sum (no atomics, the same bits
// every run).
//
// What bounds it on this card: as the forward, the exps and the in-kernel
// products (here the projections once more, and the four products of the
// projections' adjoint), not the bytes. K8's point carries over: a block
// owns all E <= 128 channels of its chunk, so the sums over channels (dB,
// dC, dxdt) are complete in the block and no (blocks, R, L, N) dB/dC
// partial buffers exist, unlike K3/K4.
// The passes are K3's (csrc/gated_scan_bwd.cu) with the projections
// recomputed in each from the xc tile:
//   1. proj_bwd_chunk: zero-entry adjoint over each chunk (needs a, C, dy).
//   2. proj_bwd_carry: the adjoint carry over the chunk summaries.
//   3. proj_bwd_grad:  recompute x from the saved entry state with
//                      checkpoints every SUB steps (global scratch), then
//                      sub-chunk by sub-chunk from the last: replay x into
//                      shared memory, sum x dy over channels (dC), walk g
//                      back, sum g delta xc and ddt_raw dt_proj over channels
//                      (dB, dxdt), and form dxc and the weight sums.
//
// The kernel allocates nothing: the caller passes every output, partial and
// scratch buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NS = 16;            // state size N the kernel is built for
constexpr int SUB = 8;            // steps per replayed sub-chunk in pass 3
constexpr int CARRY_THREADS = 256;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

struct Params {
  const void* xc;       // (R, L, E), rows and steps strided
  const void* z;
  const void* acc;
  const void* dout;     // (R, L, E) contiguous
  const float* W;       // (E, ncol), ncol = Rk + 2 NS
  const float* dtp;     // (Rk, E)
  const float* bias;    // (E)
  const float* A;       // (E, NS)
  const float* Dv;      // (E)
  const float* states;  // (R, nc, NS, E), scan order (forward exit states)
  void* dxc;            // (R, L, E) contiguous, storage dtype
  void* dz;
  void* dacc;
  float* part;          // (R, nc, pw) per-block weight-gradient partials
  float* gbuf;          // (R, nc, NS, E) scratch (nc > 1)
  float* sdelta;        // (R, nc, E) scratch (nc > 1)
  float* ckpt;          // (R, nc, nsub, NS, E) scratch
  long long R, L;
  int E, Rk, ncol, ldw, T, nc, nsub, pw;
  long long sx_r, sx_l, sz_r, sz_l, sacc_r, sacc_l;
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

// Pass 1 / 2 shared memory: W (E x ldw), dt_proj (Rk x E), x_dbl (T x ncol),
// the xc tile (T x E, storage type).
size_t base_floats(const Params& p) {
  return (size_t)p.E * p.ldw + (size_t)p.Rk * p.E + (size_t)p.T * p.ncol;
}

// Pass 3 adds, before the tile: xs (SUB NS ld), dys, dtrs, us, parts
// (SUB ld each), reds (SUB ncol: dxdt | dB | dC per step), and the weight
// accumulators aW (ncol E, column-major) and adtp (Rk E).
size_t grad_floats(const Params& p, int threads) {
  const size_t ld = (size_t)threads + 1;
  return base_floats(p) + SUB * NS * ld + 4 * SUB * ld +
         (size_t)SUB * p.ncol + (size_t)p.ncol * p.E + (size_t)p.Rk * p.E;
}

template <typename S>
__device__ void stage_project(const Params& p, long long r, long long t0,
                              int len, float* sW, float* sdtp, float* sx,
                              S* tile) {
  const int E = p.E, ncol = p.ncol, ldw = p.ldw;
  const S* xc = static_cast<const S*>(p.xc) + r * p.sx_r;
  for (int i = threadIdx.x; i < E * ncol; i += blockDim.x)
    sW[(i / ncol) * ldw + i % ncol] = p.W[i];
  for (int i = threadIdx.x; i < p.Rk * E; i += blockDim.x) sdtp[i] = p.dtp[i];
  for (int i = threadIdx.x; i < len * E; i += blockDim.x)
    tile[i] = xc[(t0 + i / E) * p.sx_l + i % E];
  __syncthreads();
  const int nq = (len + 3) / 4;
  for (int j = threadIdx.x; j < nq * ncol; j += blockDim.x) {
    const int c = j % ncol, t = 4 * (j / ncol);
    const S* x0 = tile + t * E;
    const S* x1 = tile + min(t + 1, len - 1) * E;
    const S* x2 = tile + min(t + 2, len - 1) * E;
    const S* x3 = tile + min(t + 3, len - 1) * E;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int e = 0; e < E; ++e) {
      const float w = sW[e * ldw + c];
      a0 += to_f(x0[e]) * w;
      a1 += to_f(x1[e]) * w;
      a2 += to_f(x2[e]) * w;
      a3 += to_f(x3[e]) * w;
    }
    sx[t * ncol + c] = a0;
    if (t + 1 < len) sx[(t + 1) * ncol + c] = a1;
    if (t + 2 < len) sx[(t + 2) * ncol + c] = a2;
    if (t + 3 < len) sx[(t + 3) * ncol + c] = a3;
  }
  __syncthreads();
}

__device__ __forceinline__ float dtraw_at(const Params& p, const float* sx,
                                          const float* sdtp, int t, int e,
                                          float bias) {
  const float* xd = sx + t * p.ncol;
  float v = bias;
  for (int k = 0; k < p.Rk; ++k) v += xd[k] * sdtp[k * p.E + e];
  return v;
}

// dy = dout * silu(z) with the gate, dout without it.
template <typename S, bool GATE>
__device__ __forceinline__ float dy_at(const Params& p, long long r,
                                       long long tt, int e) {
  const float g =
      to_f(static_cast<const S*>(p.dout)[(r * p.L + tt) * p.E + e]);
  if (!GATE) return g;
  const float zz =
      to_f(static_cast<const S*>(p.z)[r * p.sz_r + tt * p.sz_l + e]);
  return g * zz * sigmoid_f(zz);
}

// Pass 1: zero-entry adjoint over each chunk, in reverse scan order.
template <typename S, bool REVERSE, bool GATE>
__global__ void proj_bwd_chunk_kernel(Params p) {
  extern __shared__ float smem[];
  float* sW = smem;
  float* sdtp = sW + p.E * p.ldw;
  float* sx = sdtp + p.Rk * p.E;
  S* tile = reinterpret_cast<S*>(sx + p.T * p.ncol);
  const long long r = blockIdx.y;
  const int c = blockIdx.x;
  const int e = threadIdx.x;
  const long long t0 = (long long)c * p.T;
  const int len = (int)min((long long)p.T, p.L - t0);
  stage_project<S>(p, r, t0, len, sW, sdtp, sx, tile);
  if (e >= p.E) return;

  float A[NS], g[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    A[n] = p.A[e * NS + n];
    g[n] = 0.f;
  }
  const float bias = p.bias[e];
  float sd = 0.f;
  for (int i = len - 1; i >= 0; --i) {  // scan order, last step first
    const int t = REVERSE ? len - 1 - i : i;
    const float delta = softplus_f(dtraw_at(p, sx, sdtp, t, e, bias));
    const float dy = dy_at<S, GATE>(p, r, t0 + t, e);
    sd += delta;
    const float* cc = sx + t * p.ncol + p.Rk + NS;
#pragma unroll
    for (int n = 0; n < NS; ++n)
      g[n] = __expf(delta * A[n]) * (cc[n] * dy + g[n]);
  }
  float* gb = p.gbuf + ((r * p.nc + c) * NS) * p.E + e;
#pragma unroll
  for (int n = 0; n < NS; ++n) gb[n * p.E] = g[n];
  p.sdelta[(r * p.nc + c) * p.E + e] = sd;
}

// Pass 2: adjoint carry over the chunk summaries, last scan chunk first;
// leaves each chunk's adjoint entry (a_{s+1} g_{s+1} at its last step).
template <bool REVERSE>
__global__ void proj_bwd_carry_kernel(Params p) {
  const long long r = blockIdx.y;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= NS * p.E) return;
  const int n = idx / p.E, e = idx % p.E;
  const float a = p.A[e * NS + n];
  float carry = 0.f;
  for (int i = 0; i < p.nc; ++i) {
    const long long c = REVERSE ? i : p.nc - 1 - i;
    const long long hi = ((r * p.nc + c) * NS + n) * p.E + e;
    const float h = p.gbuf[hi];
    const float sd = p.sdelta[(r * p.nc + c) * p.E + e];
    p.gbuf[hi] = carry;
    carry = __expf(a * sd) * carry + h;
  }
}

// Pass 3: recompute x from checkpoints, walk g backwards, form gradients.
template <typename S, bool REVERSE, bool GATE, bool HAS_ACC>
__global__ void proj_bwd_grad_kernel(Params p) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int ld = nt + 1;
  const int E = p.E, Rk = p.Rk, ncol = p.ncol;
  float* sW = smem;
  float* sdtp = sW + E * p.ldw;
  float* sx = sdtp + Rk * E;
  float* xs = sx + p.T * ncol;
  float* dys = xs + SUB * NS * ld;
  float* dtrs = dys + SUB * ld;    // dt_raw, then ddt_raw after the walk
  float* us = dtrs + SUB * ld;     // delta xc after the walk
  float* parts = us + SUB * ld;    // Ssum delta + dy D
  float* reds = parts + SUB * ld;  // per step: dxdt (Rk) | dB (N) | dC (N)
  float* aW = reds + SUB * ncol;   // (ncol, E): dW^T accumulators
  float* adtp = aW + ncol * E;     // (Rk, E): d dt_proj accumulators
  S* tile = reinterpret_cast<S*>(adtp + Rk * E);

  const long long r = blockIdx.y;
  const int c = blockIdx.x;
  const int e = tid;
  const long long t0 = (long long)c * p.T;
  const int len = (int)min((long long)p.T, p.L - t0);
  const int vc = REVERSE ? p.nc - 1 - c : c;  // scan-order chunk index
  for (int i = tid; i < (ncol + Rk) * E; i += nt) aW[i] = 0.f;
  stage_project<S>(p, r, t0, len, sW, sdtp, sx, tile);
  const bool on = e < E;

  float A[NS];
  float bias = 0.f, Dv = 0.f;
  if (on) {
#pragma unroll
    for (int n = 0; n < NS; ++n) A[n] = p.A[e * NS + n];
    bias = p.bias[e];
    Dv = p.Dv[e];
  } else {
#pragma unroll
    for (int n = 0; n < NS; ++n) A[n] = 0.f;
  }
  const long long ee = on ? e : 0;
  const S* z = GATE ? static_cast<const S*>(p.z) + r * p.sz_r + ee : nullptr;
  const S* acc =
      HAS_ACC ? static_cast<const S*>(p.acc) + r * p.sacc_r + ee : nullptr;
  const S* dout = static_cast<const S*>(p.dout) + r * p.L * E + ee;
  S* dxc = static_cast<S*>(p.dxc) + r * p.L * E + ee;
  S* dz = GATE ? static_cast<S*>(p.dz) + r * p.L * E + ee : nullptr;
  S* dacc = (GATE && HAS_ACC) ? static_cast<S*>(p.dacc) + r * p.L * E + ee
                              : nullptr;
  float* ck = p.ckpt + ((r * p.nc + c) * (long long)p.nsub) * NS * E + ee;

  // forward over the chunk from its entry state, checkpointing x before
  // every SUB-th step (scan order)
  if (on) {
    float x[NS];
    if (vc > 0) {
      const float* st = p.states + ((r * p.nc + vc - 1) * NS) * E + e;
#pragma unroll
      for (int n = 0; n < NS; ++n) x[n] = st[n * E];
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n) x[n] = 0.f;
    }
    for (int i = 0; i < len; ++i) {
      if (i % SUB == 0) {
        float* ckj = ck + (long long)(i / SUB) * NS * E;
#pragma unroll
        for (int n = 0; n < NS; ++n) ckj[n * E] = x[n];
      }
      const int t = REVERSE ? len - 1 - i : i;
      const float delta = softplus_f(dtraw_at(p, sx, sdtp, t, e, bias));
      const float dlu = delta * to_f(tile[t * E + e]);
      const float* b = sx + t * ncol + Rk;
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
  if (on && p.nc > 1) {  // adjoint entry left by proj_bwd_carry
    const float* gb = p.gbuf + ((r * p.nc + c) * NS) * E + e;
#pragma unroll
    for (int n = 0; n < NS; ++n) g[n] = gb[n * E];
  }
  float dDs = 0.f, dbs = 0.f;

  for (int j = (len + SUB - 1) / SUB - 1; j >= 0; --j) {
    const int i0 = j * SUB;
    const int klen = min(SUB, len - i0);
    const float* ckj = ck + (long long)j * NS * E;
    // replay the sub-chunk: x, dy, dz and dacc per step
    if (on) {
      float x[NS];
#pragma unroll
      for (int n = 0; n < NS; ++n) x[n] = ckj[n * E];
      for (int k = 0; k < klen; ++k) {
        const int t = REVERSE ? len - 1 - (i0 + k) : i0 + k;
        const long long tt = t0 + t;
        const float dtraw = dtraw_at(p, sx, sdtp, t, e, bias);
        const float delta = softplus_f(dtraw);
        const float uu = to_f(tile[t * E + e]);
        const float dlu = delta * uu;
        const float* b = sx + t * ncol + Rk;
        const float* cc = b + NS;
        float y = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          x[n] = __expf(delta * A[n]) * x[n] + dlu * b[n];
          y += cc[n] * x[n];
          xs[(k * NS + n) * ld + tid] = x[n];
        }
        const float g_out = to_f(dout[tt * E]);
        float dy = g_out;
        if (GATE) {
          float ytot = y + Dv * uu;
          if (HAS_ACC) ytot += to_f(acc[tt * p.sacc_l]);
          const float zz = to_f(z[tt * p.sz_l]);
          const float sig = sigmoid_f(zz);
          const float silu = zz * sig;
          dz[tt * E] = from_f<S>(g_out * ytot * (sig + silu * (1.f - sig)));
          dy = g_out * silu;
          if (HAS_ACC) dacc[tt * E] = from_f<S>(dy);
        }
        dys[k * ld + tid] = dy;
        dtrs[k * ld + tid] = dtraw;
        us[k * ld + tid] = uu;
      }
    }
    __syncthreads();
    // dC[s, n] = sum over channels of x dy
    for (int idx = tid; idx < klen * NS; idx += nt) {
      const int k = idx / NS, n = idx % NS;
      const float* xr = xs + (k * NS + n) * ld;
      const float* dr = dys + k * ld;
      float s = 0.f;
      for (int q = 0; q < E; ++q) s += xr[q] * dr[q];
      reds[k * ncol + Rk + NS + n] = s;
    }
    __syncthreads();
    // adjoint walk, last step of the sub-chunk first
    if (on) {
      for (int k = klen - 1; k >= 0; --k) {
        const int t = REVERSE ? len - 1 - (i0 + k) : i0 + k;
        const float dtraw = dtrs[k * ld + tid];
        const float delta = softplus_f(dtraw);
        const float uu = us[k * ld + tid];
        const float dy = dys[k * ld + tid];
        const float* b = sx + t * ncol + Rk;
        const float* cc = b + NS;
        float Ssum = 0.f, ddl = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float gn = cc[n] * dy + g[n];
          const float xprev =
              k > 0 ? xs[((k - 1) * NS + n) * ld + tid] : ckj[n * E];
          const float a = __expf(delta * A[n]);
          const float dp = gn * xprev * a;
          dA[n] += dp * delta;
          ddl += dp * A[n];
          Ssum += gn * b[n];
          g[n] = a * gn;
          xs[(k * NS + n) * ld + tid] = gn;
        }
        const float ddt_raw = (ddl + Ssum * uu) * sigmoid_f(dtraw);
        parts[k * ld + tid] = Ssum * delta + dy * Dv;
        dtrs[k * ld + tid] = ddt_raw;
        us[k * ld + tid] = delta * uu;
        dDs += dy * uu;
        dbs += ddt_raw;
      }
    }
    __syncthreads();
    // dB[s, n] = sum over channels of g delta xc; dxdt[s, k] = sum over
    // channels of ddt_raw dt_proj[k]
    for (int idx = tid; idx < klen * (NS + Rk); idx += nt) {
      const int k = idx / (NS + Rk), m = idx % (NS + Rk);
      float s = 0.f;
      if (m < NS) {
        const float* gr = xs + (k * NS + m) * ld;
        const float* ur = us + k * ld;
        for (int q = 0; q < E; ++q) s += gr[q] * ur[q];
        reds[k * ncol + Rk + m] = s;
      } else {
        const float* dr = dtrs + k * ld;
        const float* pr = sdtp + (m - NS) * E;
        for (int q = 0; q < E; ++q) s += dr[q] * pr[q];
        reds[k * ncol + (m - NS)] = s;
      }
    }
    __syncthreads();
    // dxc, and the weight sums over the sub-chunk's steps
    if (on) {
      float uk[SUB], dx[SUB];
#pragma unroll
      for (int k = 0; k < SUB; ++k) {
        const int t = REVERSE ? len - 1 - (i0 + k) : i0 + k;
        uk[k] = k < klen ? to_f(tile[t * E + e]) : 0.f;
        dx[k] = k < klen ? parts[k * ld + tid] : 0.f;
      }
      const float* wr = sW + e * p.ldw;
      for (int cc = 0; cc < ncol; ++cc) {
        const float w = wr[cc];
        float a = aW[cc * E + e];
#pragma unroll
        for (int k = 0; k < SUB; ++k) {
          if (k < klen) {
            const float rv = reds[k * ncol + cc];
            dx[k] += rv * w;
            a += uk[k] * rv;
          }
        }
        aW[cc * E + e] = a;
      }
      for (int kk = 0; kk < Rk; ++kk) {
        float a = adtp[kk * E + e];
        for (int k = 0; k < klen; ++k) {
          const int t = REVERSE ? len - 1 - (i0 + k) : i0 + k;
          a += sx[t * ncol + kk] * dtrs[k * ld + tid];
        }
        adtp[kk * E + e] = a;
      }
#pragma unroll
      for (int k = 0; k < SUB; ++k) {
        if (k < klen) {
          const int t = REVERSE ? len - 1 - (i0 + k) : i0 + k;
          dxc[(t0 + t) * E] = from_f<S>(dx[k]);
        }
      }
    }
    __syncthreads();
  }

  // this block's partials: aW (ncol E) | adtp (Rk E) | dA (N E) | dbias (E)
  // | dD (E); each thread writes its own channel's entries
  if (on) {
    float* pb = p.part + (r * p.nc + c) * (long long)p.pw;
    for (int cc = 0; cc < ncol + Rk; ++cc) pb[cc * E + e] = aW[cc * E + e];
    float* pA = pb + (ncol + Rk) * E;
#pragma unroll
    for (int n = 0; n < NS; ++n) pA[n * E + e] = dA[n];
    pA[NS * E + e] = dbs;
    pA[(NS + 1) * E + e] = dDs;
  }
}

template <typename S, bool REVERSE, bool GATE, bool HAS_ACC>
cudaError_t launch_grad(const Params& p, dim3 grid, int threads,
                        size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      proj_bwd_grad_kernel<S, REVERSE, GATE, HAS_ACC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  proj_bwd_grad_kernel<S, REVERSE, GATE, HAS_ACC>
      <<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename S, bool REVERSE, bool GATE>
cudaError_t launch_chunk(const Params& p, dim3 grid, int threads,
                         size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      proj_bwd_chunk_kernel<S, REVERSE, GATE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  proj_bwd_chunk_kernel<S, REVERSE, GATE><<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename S, bool REVERSE>
cudaError_t launch(const Params& p, bool gate, bool has_acc, int threads,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)p.nc, (unsigned)p.R);
  const size_t tile = (size_t)p.T * p.E * sizeof(S);
  const size_t smem1 = base_floats(p) * sizeof(float) + tile;
  const size_t smem3 = grad_floats(p, threads) * sizeof(float) + tile;
  if (smem3 > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err;
  if (p.nc > 1) {
    err = gate ? launch_chunk<S, REVERSE, true>(p, grid, threads, smem1,
                                                stream)
               : launch_chunk<S, REVERSE, false>(p, grid, threads, smem1,
                                                 stream);
    if (err != cudaSuccess) return err;
    const dim3 g2((unsigned)((NS * p.E + CARRY_THREADS - 1) / CARRY_THREADS),
                  (unsigned)p.R);
    proj_bwd_carry_kernel<REVERSE><<<g2, CARRY_THREADS, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (gate && has_acc)
    return launch_grad<S, REVERSE, true, true>(p, grid, threads, smem3,
                                               stream);
  if (gate)
    return launch_grad<S, REVERSE, true, false>(p, grid, threads, smem3,
                                                stream);
  return launch_grad<S, REVERSE, false, false>(p, grid, threads, smem3,
                                               stream);
}

}  // namespace

extern "C" {

// strides: xc_r, xc_l, z_r, z_l, acc_r, acc_l (elements; host array of 6),
// as proj_scan_fwd. part holds (R, nc, proj_scan_bwd_part_len(E, Rk))
// float32 partials: dW^T (Rk + 2N, E) | d dt_proj (Rk, E) | dA^T (N, E) |
// dbias (E) | dD (E). ckpt holds ceil(T / proj_scan_bwd_sub_len())
// sub-chunk checkpoints per chunk: (R, nc, nsub, N, E) float32. acc is read
// only with the gate (ytot); dacc is written only with the gate and acc.
// Returns a cudaError_t value (0 = launched).
int proj_scan_bwd(const void* xc, const void* z, const void* acc,
                  const void* dout, const float* W, const float* dtp,
                  const float* bias, const float* A, const float* Dv,
                  const float* states, void* dxc, void* dz, void* dacc,
                  float* part, float* gbuf, float* sdelta, float* ckpt,
                  int is_bf16, int reverse, int gate, int has_acc,
                  long long R, long long L, int E, int Rk, int N, int T,
                  int threads, const long long* strides, void* stream) {
  if (N != NS || T < 1 || T > 256 || E < 1 || E > 128 || Rk < 1 ||
      threads < E || threads > 1024 || threads % 32 != 0 || R < 1 ||
      R > 65535 || L < 1)
    return (int)cudaErrorInvalidValue;
  const long long nc = (L + T - 1) / T;
  if (nc > 0x7fffffffLL ||
      (nc > 1 && (states == nullptr || gbuf == nullptr ||
                  sdelta == nullptr)) ||
      ckpt == nullptr || part == nullptr || dxc == nullptr ||
      (gate && (z == nullptr || dz == nullptr)) ||
      (gate && has_acc && (acc == nullptr || dacc == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xc = xc; p.z = z; p.acc = acc; p.dout = dout; p.W = W; p.dtp = dtp;
  p.bias = bias; p.A = A; p.Dv = Dv; p.states = states; p.dxc = dxc;
  p.dz = dz; p.dacc = dacc; p.part = part; p.gbuf = gbuf;
  p.sdelta = sdelta; p.ckpt = ckpt;
  p.R = R; p.L = L; p.E = E; p.Rk = Rk; p.ncol = Rk + 2 * NS;
  p.ldw = p.ncol | 1; p.T = T; p.nc = (int)nc;
  p.nsub = (T + SUB - 1) / SUB;
  p.pw = (2 * Rk + 3 * NS + 2) * E;
  p.sx_r = strides[0]; p.sx_l = strides[1];
  p.sz_r = strides[2]; p.sz_l = strides[3];
  p.sacc_r = strides[4]; p.sacc_l = strides[5];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool g = gate != 0, a = has_acc != 0;
  cudaError_t err;
  if (is_bf16)
    err = reverse ? launch<__nv_bfloat16, true>(p, g, a, threads, st)
                  : launch<__nv_bfloat16, false>(p, g, a, threads, st);
  else
    err = reverse ? launch<float, true>(p, g, a, threads, st)
                  : launch<float, false>(p, g, a, threads, st);
  return (int)err;
}

// Steps per sub-chunk checkpoint; the caller sizes ckpt from it.
int proj_scan_bwd_sub_len(void) { return SUB; }

// Floats of one block's weight-gradient partials.
int proj_scan_bwd_part_len(int E, int Rk) { return (2 * Rk + 3 * NS + 2) * E; }

const char* proj_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
