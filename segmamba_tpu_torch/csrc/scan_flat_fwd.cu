// Fused gated selective scan, forward, with the states spread over threads
// (K11), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   K11  benchmarks/bench_scan_flat.py:42  _fwd_kernel_flat
//        (entry flat_call :88; combine _hs_fwd_flat :32)
// which computes K2's function (segmamba_tpu/ops/scan_pallas_fused.py:42)
// in another work layout. Per row r, channel d, state n (N = 16) and step
// t, in float32, from a zero state:
//   delta = softplus(dt + bias)
//   x_t   = exp(delta A) x_{t-1} + delta B_t u_t
//   out_t = (C_t . x_t + D u_t) silu(z_t)
// The TPU kernel works on one flat (T, N D) array, one lane per (state,
// channel), so that 16 x 96 fills whole 128-lane groups where K2's (N, T,
// 96) arrays fill 96 of 128; B is expanded by a one-hot product and C . x
// reduced by another, split into bf16 halves.
//
// Lane occupancy does not carry over to this card; the idea does: one
// working element per (state, channel). A channel's 16 states sit on 16
// lanes of a warp (TPC = 16, one state per thread), where K2 keeps 8
// states per thread (TPC = 2). C . x is reduced across the 16 lanes by
// shuffles: 16 steps' products at once as a reduce-scatter (8 + 4 + 2 + 1
// shuffles for 16 sums), after which lane j holds step j's sum. So the
// kernel answers one question about K2's layout: does spreading the states
// over threads beat it, or lose to it? Per state and step it spends what
// K2 spends (one ex2, the recurrence's multiply-add) plus the shared-memory
// reads of delta, u, B and C that K2 shares among a thread's 8 states.
//
// Everything else follows K2 (csrc/gated_scan_fwd.cu): a block owns a tile
// (row, DB = 32 channels, one 128-step chunk) taken from an atomic ticket,
// chunk slowest; the chunk is staged in shared memory in 32-step
// sub-chunks with loads in flight while the one ahead is swept; sweep 1
// from a zero state gives the chunk's aggregate; a decoupled look-back
// gives the entry state (records of one float per thread, so per (row,
// chunk, channel, state), and the channel's sum of delta; flags per (row,
// channel block, chunk), polled 32 chunks a load by one warp; the fold in
// chunk order, so the bits do not depend on where a walk stops); sweep 2
// from the entry state writes each step's C . x to shared memory, and an
// epilogue writes out = (y + D u) silu(z) row by row, coalesced (a lane
// holds one step of one channel after the reduce-scatter, so direct
// stores would touch 32 rows per warp).
//
// What bounds it: one exp per state and step (the SFU, 16 ex2 per clock
// per SM), then the issue slots, which this layout spends more of than
// K2's; then the bytes of u/dt/z/out.
//
// Operands are contiguous: u, dt, z, out (R, L, D), B, C (R, L, 16) in one
// type (float32 or bfloat16); A (D, 16), D and bias (D) float32, shared by
// the rows. L is a multiple of 128; D is masked by the block. The caller
// passes the records agg and incl (R, nc, D, 16 floats each), sdel (R, nc,
// D floats) and the flags (TICKET_PAD + R ncb nc unsigned ints, zeroed on
// the launch's stream; the first is the ticket): scan_flat_fwd_scratch
// sizes them. A flag never raised would hang the card: every block raises
// AGG (w > 0) and INCL (w < nc - 1) before it can return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NS = 16;            // state size N = threads per channel
constexpr int DB = 32;            // channels per block
constexpr int NTHR = DB * NS;     // 512 threads
constexpr int T = 128;            // steps per chunk
constexpr int TS = 32;            // steps of a sub-chunk (staging unit)
constexpr int NSUB = T / TS;
constexpr int BC_PER = TS * NS / NTHR;   // B / C entries a thread stages
constexpr int DU_PER = TS * DB / NTHR;   // dt / u entries a thread stages
constexpr int OUT_PER = T * DB / NTHR;   // outputs a thread writes
constexpr int FOLD = 12;          // look-back: records loaded at once
constexpr int TICKET_PAD = 32;    // flags[0] is the ticket; flags from [32]
constexpr unsigned FLAG_AGG = 1, FLAG_INCL = 2;
constexpr float LOG2E = 1.4426950408889634f;

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
  float* agg;           // (R, nc, D, NS) scratch: exit states from zero
  float* incl;          // (R, nc, D, NS) scratch: inclusive states
  float* sdel;          // (R, nc, D) scratch: sums of delta
  unsigned* flags;      // TICKET_PAD + (R, ncb, nc), zeroed
  long long R, L, D;
  int nc, ncb;          // chunks, channel blocks
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

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// fence.acq_rel.gpu after relaxed flag loads: an acquire.
__device__ __forceinline__ void fence_acquire() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// A block's flag: every thread fences its record stores, the block meets,
// and thread 0 stores the flag (the fences make it a release).
__device__ __forceinline__ void publish(unsigned* flag, unsigned v) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_relaxed(flag, v);
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

// The carry across a chunk (K2's fold): its decay exp(A sum delta) applied
// to the entry state, plus its aggregate.
__device__ __forceinline__ float fold(float x, float a2, float sd, float h) {
  return __fmaf_rn(ex2(a2 * sd), x, h);
}

// One sub-chunk's operands in flight in registers, as loaded.
template <typename S>
struct Staged {
  S b[BC_PER], c[BC_PER], dt[DU_PER], u[DU_PER];
};

// Issue the loads of sub-chunk s of the chunk at t0 and ask L2 for the z
// rows the epilogue reads. Every sub-chunk is full (L a multiple of T).
template <typename S>
__device__ __forceinline__ void load_sub(const Params& p, long long r,
                                         long long d0, long long t0, int s,
                                         Staged<S>& q) {
  const int tid = threadIdx.x;
  const S* B = static_cast<const S*>(p.B) + (r * p.L + t0 + s * TS) * NS;
  const S* C = static_cast<const S*>(p.C) + (r * p.L + t0 + s * TS) * NS;
#pragma unroll
  for (int e = 0; e < BC_PER; ++e) {
    q.b[e] = B[tid + e * NTHR];
    q.c[e] = C[tid + e * NTHR];
  }
  const int k = tid % DB;
  const long long d = min(d0 + k, p.D - 1);
  const long long base = (r * p.L + t0 + s * TS) * p.D + d;
  const S* u = static_cast<const S*>(p.u) + base;
  const S* dt = static_cast<const S*>(p.dt) + base;
  const S* z = static_cast<const S*>(p.z) + base;
  // one prefetch per 32 bytes of a z row, and at the row's end
  const bool pf = d0 + k < p.D &&
                  (k % (32 / (int)sizeof(S)) == 0 || d == p.D - 1);
#pragma unroll
  for (int e = 0; e < DU_PER; ++e) {
    const long long row = tid / DB + e * (NTHR / DB);
    q.dt[e] = dt[row * p.D];
    q.u[e] = u[row * p.D];
    if (pf) prefetch_l2(z + row * p.D);
  }
}

// Write a loaded sub-chunk into the chunk's shared buffers: B, C, delta =
// softplus(dt + bias) and u. Out-of-range channels stage zeros.
template <typename S>
__device__ __forceinline__ void store_sub(const Params& p, float bias,
                                          long long d0, int s,
                                          const Staged<S>& q, float* sB,
                                          float* sC, float* sDel, S* sU) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = 0; e < BC_PER; ++e) {
    sB[s * TS * NS + tid + e * NTHR] = to_f(q.b[e]);
    sC[s * TS * NS + tid + e * NTHR] = to_f(q.c[e]);
  }
  const int k = tid % DB;
  const bool live = d0 + k < p.D;
#pragma unroll
  for (int e = 0; e < DU_PER; ++e) {
    const int t = s * TS + tid / DB + e * (NTHR / DB);
    sDel[t * DB + k] = live ? softplus_f(to_f(q.dt[e]) + bias) : 0.f;
    sU[t * DB + k] = live ? q.u[e] : from_f<S>(0.f);
  }
}

// Reduce-scatter over the 16 lanes of a channel: v[j] of every lane in,
// the sum over the lanes of v[lane] out (8 + 4 + 2 + 1 shuffles).
__device__ __forceinline__ float reduce_scatter16(float (&v)[16], int n,
                                                  unsigned mask) {
#pragma unroll
  for (int w = 8; w >= 1; w >>= 1) {
    const bool hi = (n & w) != 0;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const float keep = hi ? v[i + w] : v[i];
      const float send = hi ? v[i] : v[i + w];
      v[i] = keep + __shfl_xor_sync(mask, send, w);
    }
  }
  return v[0];
}

template <typename S>
__global__ void __launch_bounds__(NTHR, 2) scan_flat_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  unsigned* sMisc = reinterpret_cast<unsigned*>(smem);   // ticket, walk
  float* sB = smem + 4;             // (T, NS)
  float* sC = sB + T * NS;          // (T, NS)
  float* sDel = sC + T * NS;        // (T, DB) delta
  float* sY = sDel + T * DB;        // (T, DB) C . x
  S* sU = reinterpret_cast<S*>(sY + T * DB);   // (T, DB) u
  const int tid = threadIdx.x;

  if (tid == 0) sMisc[0] = atomicAdd(p.flags, 1u);
  __syncthreads();
  const unsigned ticket = sMisc[0];
  const unsigned per_chunk = (unsigned)(p.R * p.ncb);
  const int w = (int)(ticket / per_chunk);           // chunk
  const long long r = (ticket % per_chunk) / p.ncb;
  const int cb = (int)((ticket % per_chunk) % p.ncb);
  const long long d0 = (long long)cb * DB;
  const long long t0 = (long long)w * T;
  const int dl = tid / NS;          // channel of this thread in the block
  const int n = tid % NS;           // its state
  const long long d = d0 + dl;
  const bool active = d < p.D;      // others only stage
  const long long dc = active ? d : 0;
  const unsigned half = 0xffffu << (tid & 16);   // the channel's 16 lanes

  Staged<S> q;
  load_sub<S>(p, r, d0, t0, 0, q);
  const float a2 = p.A[dc * NS + n] * LOG2E;
  const float bias = p.bias[min(d0 + tid % DB, p.D - 1)];  // staging channel
  store_sub<S>(p, bias, d0, 0, q, sB, sC, sDel, sU);
  __syncthreads();

  // Sweep 1: the chunk from a zero state, each sub-chunk's loads in flight
  // while the one before it is swept.
  float h = 0.f, sd = 0.f;
  for (int s = 0; s < NSUB; ++s) {
    const bool more = s + 1 < NSUB;
    if (more) load_sub<S>(p, r, d0, t0, s + 1, q);
    if (active) {
#pragma unroll 8
      for (int t = s * TS; t < (s + 1) * TS; ++t) {
        const float delta = sDel[t * DB + dl];
        const float du = delta * to_f(sU[t * DB + dl]);
        sd += delta;
        h = __fmaf_rn(ex2(delta * a2), h, du * sB[t * NS + n]);
      }
    }
    if (more) {   // rows of sub-chunk s + 1: nobody reads them yet
      store_sub<S>(p, bias, d0, s + 1, q, sB, sC, sDel, sU);
      __syncthreads();
    }
  }

  // Look-back (K2's): the entry state x of chunk w.
  float x = 0.f;
  const long long rec = (r * p.nc * p.D + dc) * NS + n;   // chunk 0's
  const long long rec_m = p.D * NS;                       // per chunk
  float* sdel = p.sdel + r * p.nc * p.D + dc;             // chunk 0's
  unsigned* flags =   // (row, channel block)'s flag of chunk 0
      p.flags + TICKET_PAD + (r * p.ncb + cb) * p.nc;
  if (w > 0) {
    if (active) {
      p.agg[rec + w * rec_m] = h;
      if (n == 0) sdel[w * p.D] = sd;
    }
    publish(flags + w, FLAG_AGG);
    // warp 0 walks back to the nearest inclusive state; every chunk between
    // it and w has its aggregate out
    if (tid < 32) {
      const int lane = tid;
      int top = w - 1;
      for (;;) {
        const int m = top - lane;
        const unsigned f = m >= 0 ? ld_relaxed(flags + m) : 0u;
        const unsigned not_agg = __ballot_sync(0xffffffffu, f != FLAG_AGG);
        if (not_agg == 0) {   // 32 aggregates: further back
          top -= 32;
          continue;
        }
        const int k = __ffs(not_agg) - 1;   // the nearest one that is not
        if (__shfl_sync(0xffffffffu, f, k) == FLAG_INCL) {
          top -= k;
          break;
        }
        top -= k;             // wait at the one not out yet
        __nanosleep(32);
      }
      fence_acquire();
      if (lane == 0) sMisc[1] = (unsigned)top;
    }
    __syncthreads();
    const int j = (int)sMisc[1];
    if (active) {
      x = __ldcg(p.incl + rec + j * rec_m);
      for (int m = j + 1; m < w; m += FOLD) {   // FOLD records at once
        float am[FOLD], sdm[FOLD];
#pragma unroll
        for (int e = 0; e < FOLD; ++e) {   // past w - 1: loaded, not folded
          const int me = min(m + e, w - 1);
          am[e] = __ldcg(p.agg + rec + me * rec_m);
          sdm[e] = __ldcg(sdel + me * p.D);
        }
#pragma unroll
        for (int e = 0; e < FOLD; ++e)
          if (m + e < w) x = fold(x, a2, sdm[e], am[e]);
      }
    }
  }
  if (w < p.nc - 1) {   // publish the inclusive state of w
    if (active) p.incl[rec + w * rec_m] = w > 0 ? fold(x, a2, sd, h) : h;
    publish(flags + w, FLAG_INCL);
  }

  // Sweep 2 from the entry state: per 16 steps, each lane's C x, reduced
  // and scattered over the channel's lanes (lane j: step j's y).
  if (active) {
    for (int s0 = 0; s0 < T; s0 += 16) {
      float v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int t = s0 + e;
        const float delta = sDel[t * DB + dl];
        const float du = delta * to_f(sU[t * DB + dl]);
        x = __fmaf_rn(ex2(delta * a2), x, du * sB[t * NS + n]);
        v[e] = sC[t * NS + n] * x;
      }
      sY[(s0 + n) * DB + dl] = reduce_scatter16(v, n, half);
    }
  }
  __syncthreads();

  // Epilogue, row by row: out = (y + D u) silu(z).
  const S* z = static_cast<const S*>(p.z) + (r * p.L + t0) * p.D;
  S* out = static_cast<S*>(p.out) + (r * p.L + t0) * p.D;
  const int k = tid % DB;
  const long long de = min(d0 + k, p.D - 1);
  const bool live = d0 + k < p.D;
  const float Dv = p.Dv[de];
  S zq[OUT_PER];
#pragma unroll
  for (int e = 0; e < OUT_PER; ++e)
    zq[e] = z[(long long)(tid / DB + e * (NTHR / DB)) * p.D + de];
#pragma unroll
  for (int e = 0; e < OUT_PER; ++e) {
    const int t = tid / DB + e * (NTHR / DB);
    float o = __fmaf_rn(Dv, to_f(sU[t * DB + k]), sY[t * DB + k]);
    const float zf = to_f(zq[e]);
    o *= zf / (1.f + __expf(-zf));
    if (live) out[(long long)t * p.D + de] = from_f<S>(o);
  }
}

template <typename S>
size_t smem_bytes() {
  return 16 + (size_t)T * (2 * NS + 2 * DB) * sizeof(float) +
         (size_t)T * DB * sizeof(S);
}

template <typename S>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = scan_flat_kernel<S>;
  const size_t smem = smem_bytes<S>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(p.R * p.ncb * p.nc);
  kernel<<<blocks, NTHR, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All operands contiguous; L a multiple of 128 (the chunk). agg, incl,
// sdel and flags as scan_flat_fwd_scratch sizes them, flags zeroed.
// Returns a cudaError_t value (0 = launched).
int scan_flat_fwd(const void* u, const void* dt, const void* z, const void* B,
                  const void* C, const float* A, const float* Dv,
                  const float* bias, void* out, float* agg, float* incl,
                  float* sdel, unsigned* flags, int is_bf16, long long R,
                  long long L, long long D, int N, int chunk, void* stream) {
  if (N != NS || chunk != T || L < T || L % T || L > 0x7fffffffLL || R < 1
      || D < 1)
    return (int)cudaErrorInvalidValue;
  if (agg == nullptr || incl == nullptr || sdel == nullptr ||
      flags == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.u = u; p.dt = dt; p.z = z; p.B = B; p.C = C;
  p.A = A; p.Dv = Dv; p.bias = bias; p.out = out;
  p.agg = agg; p.incl = incl; p.sdel = sdel; p.flags = flags;
  p.R = R; p.L = L; p.D = D;
  const long long nc = L / T;
  const long long ncb = (D + DB - 1) / DB;
  if (R * ncb * nc > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.nc = (int)nc;
  p.ncb = (int)ncb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(p, st) : launch<float>(p, st));
}

// Scratch sizes in elements: agg and incl (floats each), sdel (floats),
// flags (unsigned ints, to be zeroed).
void scan_flat_fwd_scratch(long long R, long long L, long long D,
                           long long* sizes) {
  const long long nc = L / T;
  sizes[0] = R * nc * D * NS;
  sizes[1] = R * nc * D;
  sizes[2] = TICKET_PAD + R * ((D + DB - 1) / DB) * nc;
}

const char* scan_flat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
