// Projection-fused gated selective scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
//   K8  segmamba_tpu/ops/scan_pallas_proj.py:71  _proj_fwd_kernel
//       (flags REVERSE, GATE, HAS_ACC; entry mamba_scan_proj :406)
// Per row r, channel e (E <= 128 channels), state n (N = 16) and step t, in
// float32, with the projections computed INSIDE the kernel from weights
// staged in shared memory (no library GEMM):
//   x_dbl = xc_t @ [W_dt | W_B | W_C]          (E x (Rk + 2N))
//   delta = softplus(x_dbl_dt @ dt_proj + bias)  (Rk x E)
//   x_t   = exp(delta A) x_{t-1} + delta B_t xc_t   (REVERSE: x_{t+1}, suffix
//                                                    order, same layout)
//   out_t = C_t . x_t + D xc_t (+ acc_t) (* silu(z_t))
// I/O (xc, z, acc, out) is float32 or bfloat16; the products widen bf16 to
// float32 and accumulate in float32 (the TPU kernel's bf16 x bf16 -> f32
// matrix-unit mode, and its interpret mode's float32, give the same
// numbers up to the order of the sums).
//
// What bounds it on this card: the scan's exps (16 per step and channel)
// and the in-kernel products, 2 E (Rk + 2N) + 2 Rk E operations per step,
// about as many as the scan's own at stage 0 (E = 96, Rk = 3); the bytes
// are xc read once (plus z / acc) and out written once. No tensor cores
// yet: a first version that is right (wgmma for the products is later
// work). The TPU kernel's grid is serial in L ((b, nc) with the carry in
// VMEM scratch), which would give one or two blocks at L = 262,144 here.
// The design keeps K1's chunk-parallel three passes instead:
//   1. proj_exit:   one block per (row, chunk) of T steps: stages the xc
//                   tile (T x E, storage type) and the weights in shared
//                   memory, computes the chunk's x_dbl (T x (Rk + 2N)), then
//                   one thread per channel runs the chunk from a zero state
//                   and writes its exit state and sum of delta.
//   2. proj_carry:  one thread per (row, state, channel) combines the chunk
//                   carries in scan order into each chunk's entry state.
//   3. proj_output: the block recomputes the tile's projections (K8's point:
//                   delta, B and C never go to device memory) and re-runs
//                   its chunk from the entry state, writing the output and
//                   the exact exit state for the backward.
// A block owns all E channels of its T steps because every step's B, C and
// delta mix all channels. Ragged L is masked (a chunk's steps stop at L, so
// the reverse scan starts at the last real step); channels beyond E only
// help stage and project.
//
// The kernel allocates nothing: the caller passes the output, the optional
// exit-state output (R, nc, N, E) and the scratch (R, nc, N, E) + (R, nc, E).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NS = 16;            // state size N the kernel is built for
constexpr int CARRY_THREADS = 256;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

struct Params {
  const void* xc;       // (R, L, E), rows and steps strided
  const void* z;
  const void* acc;
  const float* W;       // (E, ncol), ncol = Rk + 2 NS: [W_dt | W_B | W_C]
  const float* dtp;     // (Rk, E)
  const float* bias;    // (E)
  const float* A;       // (E, NS)
  const float* Dv;      // (E)
  void* out;            // (R, L, E) contiguous
  float* states;        // (R, nc, NS, E) or nullptr
  float* hbuf;          // (R, nc, NS, E) scratch (nc > 1)
  float* sdelta;        // (R, nc, E) scratch (nc > 1)
  long long R, L;
  int E, Rk, ncol, ldw, T, nc;
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

// Shared memory of a block: the weights W (E rows of ldw, ldw odd so that a
// column read by consecutive channels hits distinct banks), dt_proj
// (Rk x E), the chunk's x_dbl (T x ncol), then the xc tile (T x E) in the
// storage type.
size_t smem_bytes(const Params& p, size_t elem) {
  return ((size_t)p.E * p.ldw + (size_t)p.Rk * p.E + (size_t)p.T * p.ncol) *
             sizeof(float) +
         (size_t)p.T * p.E * elem;
}

// Stage W, dt_proj and the xc tile of steps [t0, t0 + len) of row r, then
// x_dbl[t, c] = sum_e xc[t, e] W[e, c]; each thread forms four steps of one
// column at a time. Ends with a barrier.
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

// delta of channel e at step t from the chunk's x_dbl.
__device__ __forceinline__ float delta_at(const Params& p, const float* sx,
                                          const float* sdtp, int t, int e,
                                          float bias) {
  const float* xd = sx + t * p.ncol;
  float v = bias;
  for (int k = 0; k < p.Rk; ++k) v += xd[k] * sdtp[k * p.E + e];
  return softplus_f(v);
}

template <typename S>
__device__ __forceinline__ void carve(const Params& p, float* smem,
                                      float*& sW, float*& sdtp, float*& sx,
                                      S*& tile) {
  sW = smem;
  sdtp = sW + p.E * p.ldw;
  sx = sdtp + p.Rk * p.E;
  tile = reinterpret_cast<S*>(sx + p.T * p.ncol);
}

template <typename S, bool REVERSE>
__global__ void proj_exit_kernel(Params p) {
  extern __shared__ float smem[];
  float *sW, *sdtp, *sx;
  S* tile;
  carve(p, smem, sW, sdtp, sx, tile);
  const long long r = blockIdx.y;
  const int c = blockIdx.x;
  const int e = threadIdx.x;
  const long long t0 = (long long)c * p.T;
  const int len = (int)min((long long)p.T, p.L - t0);
  stage_project<S>(p, r, t0, len, sW, sdtp, sx, tile);
  if (e >= p.E) return;

  float A[NS], h[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    A[n] = p.A[e * NS + n];
    h[n] = 0.f;
  }
  const float bias = p.bias[e];
  float sd = 0.f;
  for (int i = 0; i < len; ++i) {
    const int t = REVERSE ? len - 1 - i : i;
    const float delta = delta_at(p, sx, sdtp, t, e, bias);
    const float du = delta * to_f(tile[t * p.E + e]);
    sd += delta;
    const float* b = sx + t * p.ncol + p.Rk;
#pragma unroll
    for (int n = 0; n < NS; ++n) h[n] = __expf(delta * A[n]) * h[n] + du * b[n];
  }
  float* hb = p.hbuf + ((r * p.nc + c) * NS) * p.E + e;
#pragma unroll
  for (int n = 0; n < NS; ++n) hb[n * p.E] = h[n];
  p.sdelta[(r * p.nc + c) * p.E + e] = sd;
}

template <bool REVERSE>
__global__ void proj_carry_kernel(Params p) {
  const long long r = blockIdx.y;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= NS * p.E) return;
  const int n = idx / p.E, e = idx % p.E;
  const float a = p.A[e * NS + n];
  float carry = 0.f;
  for (int i = 0; i < p.nc; ++i) {
    const long long c = REVERSE ? p.nc - 1 - i : i;
    const long long hi = ((r * p.nc + c) * NS + n) * p.E + e;
    const float h = p.hbuf[hi];
    const float sd = p.sdelta[(r * p.nc + c) * p.E + e];
    p.hbuf[hi] = carry;  // entry state of chunk c
    carry = __expf(a * sd) * carry + h;
  }
}

template <typename S, bool REVERSE, bool GATE, bool HAS_ACC>
__global__ void proj_output_kernel(Params p) {
  extern __shared__ float smem[];
  float *sW, *sdtp, *sx;
  S* tile;
  carve(p, smem, sW, sdtp, sx, tile);
  const long long r = blockIdx.y;
  const int c = blockIdx.x;
  const int e = threadIdx.x;
  const long long t0 = (long long)c * p.T;
  const int len = (int)min((long long)p.T, p.L - t0);
  stage_project<S>(p, r, t0, len, sW, sdtp, sx, tile);
  if (e >= p.E) return;

  float A[NS], x[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    A[n] = p.A[e * NS + n];
    x[n] = 0.f;
  }
  if (p.nc > 1) {  // entry state left by proj_carry
    const float* hb = p.hbuf + ((r * p.nc + c) * NS) * p.E + e;
#pragma unroll
    for (int n = 0; n < NS; ++n) x[n] = hb[n * p.E];
  }
  const float bias = p.bias[e];
  const float Dv = p.Dv[e];
  const S* z = GATE ? static_cast<const S*>(p.z) + r * p.sz_r + e : nullptr;
  const S* acc =
      HAS_ACC ? static_cast<const S*>(p.acc) + r * p.sacc_r + e : nullptr;
  S* out = static_cast<S*>(p.out) + r * p.L * p.E + e;
  for (int i = 0; i < len; ++i) {
    const int t = REVERSE ? len - 1 - i : i;
    const long long tt = t0 + t;
    const float delta = delta_at(p, sx, sdtp, t, e, bias);
    const float uu = to_f(tile[t * p.E + e]);
    const float du = delta * uu;
    const float* b = sx + t * p.ncol + p.Rk;
    const float* cc = b + NS;
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
    out[tt * p.E] = from_f<S>(y);
  }
  if (p.states != nullptr) {
    const long long vc = REVERSE ? p.nc - 1 - c : c;  // scan-order index
    float* st = p.states + ((r * p.nc + vc) * NS) * p.E + e;
#pragma unroll
    for (int n = 0; n < NS; ++n) st[n * p.E] = x[n];
  }
}

template <typename S, bool REVERSE, bool GATE, bool HAS_ACC>
cudaError_t launch_output(const Params& p, dim3 grid, int threads,
                          size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      proj_output_kernel<S, REVERSE, GATE, HAS_ACC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  proj_output_kernel<S, REVERSE, GATE, HAS_ACC>
      <<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename S, bool REVERSE>
cudaError_t launch(const Params& p, bool gate, bool has_acc, int threads,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)p.nc, (unsigned)p.R);
  const size_t smem = smem_bytes(p, sizeof(S));
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err;
  if (p.nc > 1) {
    err = cudaFuncSetAttribute(proj_exit_kernel<S, REVERSE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    proj_exit_kernel<S, REVERSE><<<grid, threads, smem, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const dim3 g2((unsigned)((NS * p.E + CARRY_THREADS - 1) / CARRY_THREADS),
                  (unsigned)p.R);
    proj_carry_kernel<REVERSE><<<g2, CARRY_THREADS, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (gate && has_acc)
    return launch_output<S, REVERSE, true, true>(p, grid, threads, smem,
                                                 stream);
  if (gate)
    return launch_output<S, REVERSE, true, false>(p, grid, threads, smem,
                                                  stream);
  if (has_acc)
    return launch_output<S, REVERSE, false, true>(p, grid, threads, smem,
                                                  stream);
  return launch_output<S, REVERSE, false, false>(p, grid, threads, smem,
                                                 stream);
}

}  // namespace

extern "C" {

// strides: xc_r, xc_l, z_r, z_l, acc_r, acc_l (elements; host array of 6),
// unit stride along the channel axis. W (E, Rk + 2N), dt_proj (Rk, E), bias
// (E), A (E, N) and D (E) are float32 and contiguous, shared by the rows.
// Returns a cudaError_t value (0 = launched).
int proj_scan_fwd(const void* xc, const void* z, const void* acc,
                  const float* W, const float* dtp, const float* bias,
                  const float* A, const float* Dv, void* out, float* states,
                  float* hbuf, float* sdelta, int is_bf16, int reverse,
                  int gate, int has_acc, long long R, long long L, int E,
                  int Rk, int N, int T, int threads, const long long* strides,
                  void* stream) {
  if (N != NS || T < 1 || T > 256 || E < 1 || E > 128 || Rk < 1 ||
      threads < E || threads > 1024 || threads % 32 != 0 || R < 1 ||
      R > 65535 || L < 1 || (gate && z == nullptr) ||
      (has_acc && acc == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long nc = (L + T - 1) / T;
  if (nc > 0x7fffffffLL || (nc > 1 && (hbuf == nullptr || sdelta == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xc = xc; p.z = z; p.acc = acc; p.W = W; p.dtp = dtp; p.bias = bias;
  p.A = A; p.Dv = Dv; p.out = out; p.states = states; p.hbuf = hbuf;
  p.sdelta = sdelta;
  p.R = R; p.L = L; p.E = E; p.Rk = Rk; p.ncol = Rk + 2 * NS;
  p.ldw = p.ncol | 1; p.T = T; p.nc = (int)nc;
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

const char* proj_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
