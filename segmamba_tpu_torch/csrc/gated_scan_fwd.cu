// Gated selective scan, forward, for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of the JAX package with one template:
//   K1  segmamba_tpu/ops/scan_pallas_dir.py:60   _dir_fwd_kernel
//       (flags REVERSE, GATE, HAS_ACC; entry mamba_scan_fused_dir :382)
//   K2  segmamba_tpu/ops/scan_pallas_fused.py:42 _fwd_kernel
//       (= REVERSE=0, GATE=1, HAS_ACC=0; entry mamba_scan_fused :250)
//   K5  segmamba_tpu/ops/scan_pallas_dir.py:477  _slice_fwd_kernel
//       (= SLICE: REVERSE=0, GATE=1, HAS_ACC=0 over a slice-major layout;
//       entry mamba_scan_fused_slice :728; GATE=0 and HAS_ACC=1 are the
//       wrapper's chain over groups of 16 states when N > 16)
//   K6  segmamba_tpu/ops/scan_pallas.py:162      _fwd_kernel
//       (= SOFTPLUS=0, REVERSE=0, GATE=0, HAS_ACC=0, float32 I/O, D and bias
//       zero; entry selective_scan_pallas :361): the ungated core
//       (u, delta, A, B, C) -> (y, chunk exit states). Its wrapper applies
//       bias and softplus before the kernel and D-skip and the silu(z) gate
//       after it, in float32, as the JAX entry does; the last state is the
//       last chunk's exit state.
//
// Per row r, channel d, state n (N = 16) and step t, in float32:
//   delta = softplus(dt + bias)                  (logaddexp(x, 0) form;
//                                                  SOFTPLUS=0: dt + bias)
//   x_t   = exp(delta A) x_{t-1} + delta B_t u_t  (REVERSE: x_{t+1}, suffix
//                                                  order, same layout)
//   y_t   = C_t . x_t + D u_t (+ acc_t) (* silu(z_t))
// SLICE (K5) runs the scan in slice-interleaved order over the original
// slice-major layout of S slices x P = L / S positions: scan-order step t
// reads and writes original row (t mod S) P + floor(t / S) of u, dt, z, B, C
// and out. No interleaved copy exists; chunks are T steps of the scan order,
// and every step's channel vector is still contiguous, so a warp's loads
// coalesce whatever the row order. (The TPU kernel gathers (S, Tp) blocks by
// strided DMA and transposes them in VMEM; that scheme exists for VMEM and
// is not carried over.)
// I/O is float32 or bfloat16 (u, dt, z, acc, B, C and out share one type);
// A (D x N), D and bias are float32, shared (row stride 0) or per row.
//
// What bounds it on this card: an elementwise recurrence with 16 states per
// (token, channel): one exp and two FMAs per state per token, so the SFU's
// exp rate and the bytes of u/dt/z/acc/out bound it, not the tensor cores
// (no wgmma/TMA needed). The sequence dimension is long (262,144 tokens at
// stage 0 of a 128^3 window) while R = 1 and D = 96, so a walk of L in one
// thread per (row, channel) would use 96 threads of one SM. (K6 on the LM's
// prefill is the other way round: R = 2, L = 2048, D = 5120, 40 channel
// blocks of 128 per row and chunk; the same passes fill the card.) The
// design cuts L into chunks of T steps, as the TPU kernel's saved chunk
// states do:
//   1. chunk_exit:   one thread per (row, chunk, channel) runs its chunk
//                    from a zero state, keeping the 16 states in registers;
//                    writes the exit state and the chunk's sum of delta
//                    (its decay is exp(A * sum delta)).
//   2. chunk_carry:  one thread per (row, state, channel) combines the
//                    chunk carries in scan order and leaves each chunk's
//                    entry state in place of its zero-entry exit state.
//   3. chunk_output: one thread per (row, chunk, channel) re-runs its chunk
//                    from the entry state and writes the gated output (and
//                    the exact exit state when asked for).
// B and C of a chunk are staged in shared memory as float32 (every channel
// of the block reads them); u/dt/z/acc/out are read with the channel index
// fastest, so a warp touches consecutive addresses. Rows may be strided
// (z is the second half of xz; B and C are column slices of x_dbl), so every
// sequence operand comes with its own row and step strides, unit stride
// along the last axis, and no vector alignment is assumed. Ragged L and D
// are masked: a thread whose channel is out of range only helps stage B/C,
// and a chunk's steps stop at L, so the reverse scan starts at the last
// real step and no masked step enters any state. (The JAX K6 pads L with
// delta = 0, identity steps, so its last state is exact too.)
//
// The kernel allocates nothing: the caller passes the output, the optional
// exit-state output (R, nc, N, D) and the scratch (R, nc, N, D) + (R, nc, D).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NS = 16;            // state size N the kernel is built for
constexpr int CARRY_THREADS = 256;

struct Params {
  const void* u;
  const void* dt;
  const void* z;
  const void* acc;
  const void* B;
  const void* C;
  const float* A;       // (R|1, D, NS)
  const float* Dv;      // (R|1, D)
  const float* bias;    // (R|1, D)
  void* out;            // (R, L, D) contiguous
  float* states;        // (R, nc, NS, D) or nullptr
  float* hbuf;          // (R, nc, NS, D) scratch (nc > 1)
  float* sdelta;        // (R, nc, D) scratch (nc > 1)
  long long R, L, D;
  int T, nc;
  unsigned S, P;        // SLICE: slices and positions (L = S P)
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

// delta from dt + bias: softplus of it, or (K6) as it is.
template <bool SOFTPLUS>
__device__ __forceinline__ float delta_of(float x) {
  return SOFTPLUS ? softplus_f(x) : x;
}

// Original row of scan-order step tt: itself, or with SLICE the step's place
// in the slice-major layout.
template <bool SLICE>
__device__ __forceinline__ long long row_of(const Params& p, long long tt) {
  if (!SLICE) return tt;
  const unsigned t = (unsigned)tt;
  return (long long)(t % p.S) * p.P + t / p.S;
}

// Stage scan-order steps [t0, t0 + len) of B (and C) of row r into shared
// memory.
template <typename S, bool WITH_C, bool SLICE>
__device__ __forceinline__ void stage_bc(const Params& p, long long r,
                                         long long t0, int len, float* sB,
                                         float* sC) {
  const S* B = static_cast<const S*>(p.B) + r * p.sB_r;
  const S* C = static_cast<const S*>(p.C) + r * p.sC_r;
  for (int i = threadIdx.x; i < len * NS; i += blockDim.x) {
    const long long t = row_of<SLICE>(p, t0 + i / NS);
    const int n = i % NS;
    sB[i] = to_f(B[t * p.sB_l + n]);
    if (WITH_C) sC[i] = to_f(C[t * p.sC_l + n]);
  }
  __syncthreads();
}

template <typename S, bool REVERSE, bool SOFTPLUS, bool SLICE>
__global__ void chunk_exit_kernel(Params p) {
  extern __shared__ float smem[];
  float* sB = smem;
  const long long r = blockIdx.z;
  const int c = blockIdx.y;
  const long long d = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long t0 = (long long)c * p.T;
  const int len = (int)min((long long)p.T, p.L - t0);
  stage_bc<S, false, SLICE>(p, r, t0, len, sB, nullptr);
  if (d >= p.D) return;

  float A[NS], h[NS];
  const float* Ar = p.A + r * p.sA_r + d * NS;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    A[n] = Ar[n];
    h[n] = 0.f;
  }
  const float bias = p.bias[r * p.sbias_r + d];
  const S* u = static_cast<const S*>(p.u) + r * p.su_r + d;
  const S* dt = static_cast<const S*>(p.dt) + r * p.sdt_r + d;
  float sd = 0.f;
  for (int i = 0; i < len; ++i) {
    const int t = REVERSE ? len - 1 - i : i;
    const long long tt = row_of<SLICE>(p, t0 + t);
    const float delta = delta_of<SOFTPLUS>(to_f(dt[tt * p.sdt_l]) + bias);
    const float du = delta * to_f(u[tt * p.su_l]);
    sd += delta;
    const float* b = sB + t * NS;
#pragma unroll
    for (int n = 0; n < NS; ++n) h[n] = __expf(delta * A[n]) * h[n] + du * b[n];
  }
  float* hb = p.hbuf + ((r * p.nc + c) * NS) * p.D + d;
#pragma unroll
  for (int n = 0; n < NS; ++n) hb[n * p.D] = h[n];
  p.sdelta[(r * p.nc + c) * p.D + d] = sd;
}

template <bool REVERSE>
__global__ void chunk_carry_kernel(Params p) {
  const long long r = blockIdx.y;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= NS * p.D) return;
  const int n = (int)(idx / p.D);
  const long long d = idx % p.D;
  const float a = p.A[r * p.sA_r + d * NS + n];
  float carry = 0.f;
  for (int i = 0; i < p.nc; ++i) {
    const long long c = REVERSE ? p.nc - 1 - i : i;
    const long long hi = ((r * p.nc + c) * NS + n) * p.D + d;
    const float h = p.hbuf[hi];
    const float sd = p.sdelta[(r * p.nc + c) * p.D + d];
    p.hbuf[hi] = carry;  // entry state of chunk c
    carry = __expf(a * sd) * carry + h;
  }
}

template <typename S, bool REVERSE, bool GATE, bool HAS_ACC, bool SOFTPLUS,
          bool SLICE>
__global__ void chunk_output_kernel(Params p) {
  extern __shared__ float smem[];
  float* sB = smem;
  float* sC = smem + p.T * NS;
  const long long r = blockIdx.z;
  const int c = blockIdx.y;
  const long long d = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long t0 = (long long)c * p.T;
  const int len = (int)min((long long)p.T, p.L - t0);
  stage_bc<S, true, SLICE>(p, r, t0, len, sB, sC);
  if (d >= p.D) return;

  float A[NS], x[NS];
  const float* Ar = p.A + r * p.sA_r + d * NS;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    A[n] = Ar[n];
    x[n] = 0.f;
  }
  if (p.nc > 1) {  // entry state left by chunk_carry
    const float* hb = p.hbuf + ((r * p.nc + c) * NS) * p.D + d;
#pragma unroll
    for (int n = 0; n < NS; ++n) x[n] = hb[n * p.D];
  }
  const float bias = p.bias[r * p.sbias_r + d];
  const float Dv = p.Dv[r * p.sDv_r + d];
  const S* u = static_cast<const S*>(p.u) + r * p.su_r + d;
  const S* dt = static_cast<const S*>(p.dt) + r * p.sdt_r + d;
  const S* z = GATE ? static_cast<const S*>(p.z) + r * p.sz_r + d : nullptr;
  const S* acc =
      HAS_ACC ? static_cast<const S*>(p.acc) + r * p.sacc_r + d : nullptr;
  S* out = static_cast<S*>(p.out) + r * p.L * p.D + d;
  for (int i = 0; i < len; ++i) {
    const int t = REVERSE ? len - 1 - i : i;
    const long long tt = row_of<SLICE>(p, t0 + t);
    const float delta = delta_of<SOFTPLUS>(to_f(dt[tt * p.sdt_l]) + bias);
    const float uu = to_f(u[tt * p.su_l]);
    const float du = delta * uu;
    const float* b = sB + t * NS;
    const float* cc = sC + t * NS;
    float y = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      x[n] = __expf(delta * A[n]) * x[n] + du * b[n];
      y += cc[n] * x[n];
    }
    y += Dv * uu;
    if (HAS_ACC) y += to_f(acc[tt * p.sacc_l]);
    if (GATE) {
      const float zz = to_f(z[tt * p.sz_l]);
      y *= zz / (1.f + __expf(-zz));
    }
    out[tt * p.D] = from_f<S>(y);
  }
  if (p.states != nullptr) {
    const long long vc = REVERSE ? p.nc - 1 - c : c;  // scan-order index
    float* st = p.states + ((r * p.nc + vc) * NS) * p.D + d;
#pragma unroll
    for (int n = 0; n < NS; ++n) st[n * p.D] = x[n];
  }
}

template <typename S, bool REVERSE, bool SOFTPLUS, bool SLICE = false>
cudaError_t launch(const Params& p, bool gate, bool has_acc, int threads,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((p.D + threads - 1) / threads), (unsigned)p.nc,
                  (unsigned)p.R);
  const size_t smem = (size_t)p.T * NS * sizeof(float);
  cudaError_t err;
  if (p.nc > 1) {
    chunk_exit_kernel<S, REVERSE, SOFTPLUS, SLICE>
        <<<grid, threads, smem, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const dim3 g2((unsigned)((NS * p.D + CARRY_THREADS - 1) / CARRY_THREADS),
                  (unsigned)p.R);
    chunk_carry_kernel<REVERSE><<<g2, CARRY_THREADS, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if constexpr (!SOFTPLUS) {  // K6: ungated, no acc
    chunk_output_kernel<S, REVERSE, false, false, false, false>
        <<<grid, threads, 2 * smem, stream>>>(p);
  } else if (gate && has_acc) {
    chunk_output_kernel<S, REVERSE, true, true, true, SLICE>
        <<<grid, threads, 2 * smem, stream>>>(p);
  } else if (gate) {  // K5's own flags with SLICE
    chunk_output_kernel<S, REVERSE, true, false, true, SLICE>
        <<<grid, threads, 2 * smem, stream>>>(p);
  } else if (has_acc) {
    chunk_output_kernel<S, REVERSE, false, true, true, SLICE>
        <<<grid, threads, 2 * smem, stream>>>(p);
  } else {
    chunk_output_kernel<S, REVERSE, false, false, true, SLICE>
        <<<grid, threads, 2 * smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: u_r, u_l, dt_r, dt_l, z_r, z_l, acc_r, acc_l, B_r, B_l, C_r, C_l,
//          A_r, Dv_r, bias_r (elements; host array of 15).
// softplus = 0 is K6's mode: float32, no reverse, no gate, no acc.
// nslices > 0 is K5's mode (SLICE, nslices | L): forward; gate and acc
// (in original row order) as for K1. Returns a cudaError_t value (0 = launched).
int gated_scan_fwd(const void* u, const void* dt, const void* z,
                   const void* acc, const void* B, const void* C,
                   const float* A, const float* Dv, const float* bias,
                   void* out, float* states, float* hbuf, float* sdelta,
                   int is_bf16, int reverse, int gate, int has_acc,
                   int softplus, long long nslices, long long R, long long L,
                   long long D, int N, int T, int threads,
                   const long long* strides, void* stream) {
  if (N != NS || T < 1 || T > 256 || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || R < 1 || L < 1 || D < 1 || R > 65535 ||
      L > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!softplus && (is_bf16 || reverse || gate || has_acc || nslices))
    return (int)cudaErrorInvalidValue;
  if (nslices && (nslices < 1 || L % nslices || reverse))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.u = u; p.dt = dt; p.z = z; p.acc = acc; p.B = B; p.C = C;
  p.A = A; p.Dv = Dv; p.bias = bias;
  p.out = out; p.states = states; p.hbuf = hbuf; p.sdelta = sdelta;
  p.R = R; p.L = L; p.D = D; p.T = T;
  p.S = nslices ? (unsigned)nslices : 1u;
  p.P = (unsigned)(L / p.S);
  const long long nc = (L + T - 1) / T;
  if (nc > 65535) return (int)cudaErrorInvalidValue;
  p.nc = (int)nc;
  if (nc > 1 && (hbuf == nullptr || sdelta == nullptr))
    return (int)cudaErrorInvalidValue;
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

const char* gated_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
