// Lower-bound probe of the fused forward scan (K10), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   K10  benchmarks/bench_scan_lb.py:26  _kernel  (entry variant_call :66)
// a probe of K2 (segmamba_tpu/ops/scan_pallas_fused.py:42) that keeps K2's
// loads, exps, C-reduction, D-skip and gate and replaces the Hillis-Steele
// combine. Per row r, channel d, state n (N = 16) and step t of a chunk of
// T = 128 steps, in float32:
//   delta = softplus(dt + bias)
//   a = exp(delta A),  b = delta u B_t,  b += a carry at step 0 only
//   "noshift": 7 rounds of b = a b 0.5 + b, with a = a a after each of the
//              first 6 (the combine's multiply-adds, no shift);
//   "nohs":    b = a b (generation and reduction only)
//   out_t = (C_t . b_t + D u_t) silu(z_t),   carry <- b at step T - 1.
// Its outputs are wrong on purpose: it measures where the floor sits.
//
// The TPU grid runs the chunks in order with the carry in scratch memory.
// Here no chunk waits on another: the carry enters only at step 0 of a
// chunk, and the carry that leaves chunk c - 1 is its step T - 1, which
// never saw a carry (T > 1). So the block of chunk c recomputes it from
// chunk c - 1's last step (one extra step of loads, the same instructions
// that block runs there, so the same bits) and needs no serial pass and no
// look-back. With T = 1 step 0 would be step T - 1 and the carry would
// chain through every chunk; T is fixed at 128.
//
// What bounds it on this card: one exp per state and step, so the SFU (16
// ex2 results per clock per SM) first for "nohs"; "noshift" adds ~20 float
// instructions per state and step, so the FP32 issue slots bound it. Then
// the bytes of u/dt/z/out.
//
// The design is K2's (csrc/gated_scan_fwd.cu) on purpose, so that K2's time
// minus this kernel's reads as the price of K2's second sweep and its
// look-back: the same tile (row, DB channels, one chunk), TPC = 2 threads
// per channel with 8 states each, ex2.approx on A pre-scaled by log2(e),
// the chunk staged in shared memory in 32-step sub-chunks whose loads are
// in flight (unconditional, unconverted) while the sub-chunk ahead of them
// is swept, z asked into L2 while staging, and the outputs written by the
// channel's thread pair, one shuffle per two steps. The one sweep here is
// K2's second sweep (with the outputs) run over the staged sub-chunks as
// they arrive. Blocks take tiles from blockIdx, chunk slowest.
//
// Operands are contiguous: u, dt, z, out (R, L, D) and B, C (R, L, 16) in
// one type (float32 or bfloat16); A (D, 16), D and bias (D) float32 and
// shared by the rows. L is a multiple of 128; D is masked by the block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NS = 16;            // state size N the kernel is built for
constexpr int TPC = 2;            // threads per channel
constexpr int SPT = NS / TPC;     // states per thread
constexpr int MAX_THREADS = 192;  // threads per block (DB x TPC)
constexpr int T = 128;            // steps per chunk
constexpr int TS = 32;            // steps of a sub-chunk (staging unit)
constexpr int NSUB = T / TS;
constexpr int G = 8;              // steps whose outputs go together
constexpr int BC_PER = TS * NS / 64;   // B / C entries a thread stages
constexpr int ROUNDS = 7;         // combine rounds of a 128-step chunk
constexpr float LOG2E = 1.4426950408889634f;

enum Variant { NOSHIFT = 0, NOHS = 1 };

struct Params {
  const void* u;
  const void* dt;
  const void* z;
  const void* B;
  const void* C;
  const float* A;       // (D, NS)
  const float* Dv;      // (D)
  const float* bias;    // (D)
  void* out;            // (R, L, D)
  long long R, L, D;
  int nc, DB, ncb;      // chunks, channels per block, channel blocks
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

// K2's softplus: max(x, 0) + log1p(e), e = exp(-|x|), the series below
// e = 2^-6.
__device__ __forceinline__ float softplus_f(float x) {
  const float e = __expf(-fabsf(x));
  const float series = e * (1.f - e * (0.5f - e * (0.33333334f - 0.25f * e)));
  return fmaxf(x, 0.f) + (e < 0.015625f ? series : __logf(1.f + e));
}

__device__ __forceinline__ void unpack(const float4& lo, const float4& hi,
                                       float (&v)[SPT]) {
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// One step of one state: a = exp(delta A), b = delta u B (+ a carry), then
// the variant's combine. The carry's recomputation calls this too.
template <int V>
__device__ __forceinline__ float step_x(float delta, float du, float a2,
                                        float Bn, bool first, float carry) {
  float a = ex2(delta * a2);
  float b = du * Bn;
  if (first) b = __fmaf_rn(a, carry, b);
  if (V == NOSHIFT) {
#pragma unroll
    for (int k = 0; k < ROUNDS; ++k) {
      b = __fmaf_rn(a * b, 0.5f, b);   // a b 0.5 + b: the 0.5 is exact
      if (k + 1 < ROUNDS) a = a * a;
    }
    return b;
  }
  return a * b;
}

// One sub-chunk's operands in flight in registers, as loaded (K2's Staged).
template <typename S>
struct Staged {
  S b[BC_PER], c[BC_PER], dt[TS / TPC], u[TS / TPC];
};

// Issue the loads of sub-chunk s of the chunk at t0 and ask L2 for its z
// rows. Every sub-chunk is full (T = 4 TS, L a multiple of T).
template <typename S>
__device__ __forceinline__ void load_sub(const Params& p, long long r,
                                         long long d0, long long t0, int s,
                                         Staged<S>& q) {
  const int tid = threadIdx.x, nthr = blockDim.x, DB = p.DB;
  const S* B = static_cast<const S*>(p.B) + r * p.L * NS;
  const S* C = static_cast<const S*>(p.C) + r * p.L * NS;
  const int k = tid % DB;
  const long long d = min(d0 + k, p.D - 1);
  const S* u = static_cast<const S*>(p.u) + r * p.L * p.D + d;
  const S* dt = static_cast<const S*>(p.dt) + r * p.L * p.D + d;
  const S* z = static_cast<const S*>(p.z) + r * p.L * p.D + d;
  const bool pf = d0 + k < p.D &&
                  (k % (32 / (int)sizeof(S)) == 0 || d == p.D - 1);
  const long long rb = t0 + s * TS + tid / NS;
  const S* pb = B + rb * NS + tid % NS;
  const S* pc = C + rb * NS + tid % NS;
  const long long stb = (nthr / NS) * NS;
#pragma unroll
  for (int e = 0; e < BC_PER; ++e) {
    if (tid + e * nthr < TS * NS) {
      q.b[e] = *pb;
      q.c[e] = *pc;
    }
    pb += stb;
    pc += stb;
  }
  const long long t1 = t0 + s * TS + tid / DB;
  const S* pd = dt + t1 * p.D;
  const S* pu = u + t1 * p.D;
  const S* pz = z + t1 * p.D;
#pragma unroll
  for (int e = 0; e < TS / TPC; ++e) {
    q.dt[e] = pd[e * TPC * p.D];
    q.u[e] = pu[e * TPC * p.D];
    if (pf) prefetch_l2(pz + e * TPC * p.D);
  }
}

// Write a loaded sub-chunk into the chunk's shared buffers: B, C, delta =
// softplus(dt + bias) and u. Out-of-range channels stage zeros.
template <typename S>
__device__ __forceinline__ void store_sub(const Params& p, float bias,
                                          long long d0, int s,
                                          const Staged<S>& q, float* sB,
                                          float* sC, float* sDel, S* sU) {
  const int tid = threadIdx.x, nthr = blockDim.x, DB = p.DB;
  const int lo = s * TS;
#pragma unroll
  for (int e = 0; e < BC_PER; ++e) {
    const int i = tid + e * nthr;
    if (i < TS * NS) {
      sB[lo * NS + i] = to_f(q.b[e]);
      sC[lo * NS + i] = to_f(q.c[e]);
    }
  }
  const int k = tid % DB;
  const bool live = d0 + k < p.D;
  const int t1 = lo + tid / DB;
#pragma unroll
  for (int e = 0; e < TS / TPC; ++e) {
    const float dv = softplus_f(to_f(q.dt[e]) + bias);
    sDel[(t1 + e * TPC) * DB + k] = live ? dv : 0.f;
    sU[(t1 + e * TPC) * DB + k] = live ? q.u[e] : from_f<S>(0.f);
  }
}

// The sweep over sub-chunk s with its outputs: thread (dl, g) advances its
// 8 states; the pair sums its halves of C . x by shuffles and thread g
// writes the steps of parity g, out = (C . x + D u) silu(z).
template <typename S, int V>
__device__ __forceinline__ void sweep_sub(const Params& p, int s,
                                          long long t0, int dl, int g,
                                          unsigned pair, const float* sB,
                                          const float* sC, const float* sDel,
                                          const S* sU, const float (&a2)[SPT],
                                          const float (&carry)[SPT], float Dv,
                                          const S* z, S* out) {
  const int DB = p.DB;
  S zq[TS / TPC];
#pragma unroll
  for (int j2 = 0; j2 < TS / TPC; ++j2)
    zq[j2] = z[(t0 + s * TS + g + 2 * j2) * p.D];
#pragma unroll
  for (int q0 = 0; q0 < TS; q0 += G) {
    float y[G], uv[G];
#pragma unroll
    for (int e = 0; e < G; ++e) {
      const int t = s * TS + q0 + e;
      const float delta = sDel[t * DB + dl];
      uv[e] = to_f(sU[t * DB + dl]);
      const float du = delta * uv[e];
      float b[SPT], c[SPT];
      const float4* b4 = reinterpret_cast<const float4*>(sB + t * NS + g * SPT);
      const float4* c4 = reinterpret_cast<const float4*>(sC + t * NS + g * SPT);
      unpack(b4[0], b4[1], b);
      unpack(c4[0], c4[1], c);
      const bool first = s == 0 && q0 == 0 && e == 0;   // step 0: the carry
      float ya = 0.f, yb = 0.f;   // two chains of C . x
#pragma unroll
      for (int n = 0; n < SPT; n += 2) {
        const float x0 = step_x<V>(delta, du, a2[n], b[n], first, carry[n]);
        const float x1 =
            step_x<V>(delta, du, a2[n + 1], b[n + 1], first, carry[n + 1]);
        ya = __fmaf_rn(c[n], x0, ya);
        yb = __fmaf_rn(c[n + 1], x1, yb);
      }
      y[e] = ya + yb;
    }
#pragma unroll
    for (int j2 = 0; j2 < G / 2; ++j2) {
      // send the partner the half of its step, receive ours
      const float mine = g ? y[2 * j2 + 1] : y[2 * j2];
      const float theirs = g ? y[2 * j2] : y[2 * j2 + 1];
      const float yy = mine + __shfl_xor_sync(pair, theirs, 1);
      const float uu = g ? uv[2 * j2 + 1] : uv[2 * j2];
      const int o = q0 / 2 + j2;
      float v = __fmaf_rn(Dv, uu, yy);
      const float zf = to_f(zq[o]);
      v *= zf / (1.f + __expf(-zf));
      out[(t0 + s * TS + g + 2 * o) * p.D] = from_f<S>(v);
    }
  }
}

template <typename S, int V>
__global__ void __launch_bounds__(MAX_THREADS, 2) scan_lb_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sB = reinterpret_cast<float*>(smem4);   // (T, NS)
  float* sC = sB + T * NS;                       // (T, NS)
  float* sDel = sC + T * NS;                     // (T, DB) delta
  const int DB = p.DB;
  S* sU = reinterpret_cast<S*>(sDel + T * DB);   // (T, DB) u
  const int tid = threadIdx.x;

  const unsigned tile = blockIdx.x;
  const unsigned per_chunk = (unsigned)(p.R * p.ncb);
  const int w = (int)(tile / per_chunk);           // chunk
  const long long r = (tile % per_chunk) / p.ncb;
  const long long d0 = (long long)((tile % per_chunk) % p.ncb) * DB;
  const long long t0 = (long long)w * T;
  const int dl = tid / TPC;         // channel of this thread in the block
  const int g = tid % TPC;          // its half of the states
  const long long d = d0 + dl;
  const bool active = d < p.D;      // others only stage
  const long long dc = active ? d : 0;

  Staged<S> q;
  load_sub<S>(p, r, d0, t0, 0, q);
  float a2[SPT];
#pragma unroll
  for (int n = 0; n < SPT; ++n) a2[n] = p.A[dc * NS + g * SPT + n] * LOG2E;
  const float bias = p.bias[min(d0 + tid % DB, p.D - 1)];
  // The carry: chunk w - 1's step T - 1, which saw no carry.
  float carry[SPT];
#pragma unroll
  for (int n = 0; n < SPT; ++n) carry[n] = 0.f;
  if (w > 0) {
    const long long tp = t0 - 1;
    const S* Bp = static_cast<const S*>(p.B) + (r * p.L + tp) * NS + g * SPT;
    const long long at = (r * p.L + tp) * p.D + dc;
    const float delta = softplus_f(to_f(static_cast<const S*>(p.dt)[at]) +
                                   p.bias[dc]);
    const float du = delta * to_f(static_cast<const S*>(p.u)[at]);
#pragma unroll
    for (int n = 0; n < SPT; ++n)
      carry[n] = step_x<V>(delta, du, a2[n], to_f(Bp[n]), false, 0.f);
  }
  store_sub<S>(p, bias, d0, 0, q, sB, sC, sDel, sU);
  __syncthreads();

  const unsigned pair = 3u << (tid & 30);
  const float Dv = p.Dv[dc];
  const S* z = static_cast<const S*>(p.z) + r * p.L * p.D + dc;
  S* out = static_cast<S*>(p.out) + r * p.L * p.D + dc;
  for (int s = 0; s < NSUB; ++s) {
    const bool more = s + 1 < NSUB;
    if (more) load_sub<S>(p, r, d0, t0, s + 1, q);
    if (active)
      sweep_sub<S, V>(p, s, t0, dl, g, pair, sB, sC, sDel, sU, a2, carry, Dv,
                      z, out);
    if (more) {   // rows of sub-chunk s + 1: nobody reads them yet
      store_sub<S>(p, bias, d0, s + 1, q, sB, sC, sDel, sU);
      __syncthreads();
    }
  }
}

template <typename S>
size_t smem_bytes(int DB) {
  return (size_t)T * (2 * NS + DB) * sizeof(float) + (size_t)T * DB * sizeof(S);
}

template <typename S, int V>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = scan_lb_kernel<S, V>;
  const size_t smem = smem_bytes<S>(p.DB);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(p.R * p.ncb * p.nc);
  kernel<<<blocks, p.DB * TPC, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// variant: 0 = "noshift", 1 = "nohs". channels: channels per block (DB, a
// multiple of 32, at most 96). All operands contiguous; L a multiple of
// 128 (the chunk). Returns a cudaError_t value (0 = launched).
int scan_lb_fwd(const void* u, const void* dt, const void* z, const void* B,
                const void* C, const float* A, const float* Dv,
                const float* bias, void* out, int is_bf16, int variant,
                long long R, long long L, long long D, int N, int chunk,
                int channels, void* stream) {
  if (N != NS || chunk != T || L < T || L % T || L > 0x7fffffffLL || R < 1
      || D < 1 || channels < 32 || channels % 32
      || channels * TPC > MAX_THREADS || (variant != NOSHIFT && variant != NOHS))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.u = u; p.dt = dt; p.z = z; p.B = B; p.C = C;
  p.A = A; p.Dv = Dv; p.bias = bias; p.out = out;
  p.R = R; p.L = L; p.D = D; p.DB = channels;
  const long long nc = L / T;
  const long long ncb = (D + channels - 1) / channels;
  if (R * ncb * nc > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.nc = (int)nc;
  p.ncb = (int)ncb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (is_bf16)
    err = variant == NOSHIFT ? launch<bf, NOSHIFT>(p, st)
                             : launch<bf, NOHS>(p, st);
  else
    err = variant == NOSHIFT ? launch<float, NOSHIFT>(p, st)
                             : launch<float, NOHS>(p, st);
  return (int)err;
}

const char* scan_lb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
