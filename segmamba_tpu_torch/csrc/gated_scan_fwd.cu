// Gated selective scan, forward, for Hopper (sm_90a).
//
// Replaces five Pallas TPU kernels of the JAX package with one template:
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
//   K7  segmamba_tpu/ops/scan_pallas_mxu.py:131  _fwd_kernel (pallas_call
//       :251, helpers _block_scan :107, _masks :82; entry selective_scan_mxu
//       :379): K6's function in K7's ratio form (RATIO, below), as its own
//       kernel mxu_fwd_kernel so that profiles keep it apart.
//   K8  segmamba_tpu/ops/scan_pallas_proj.py:71  _proj_fwd_kernel
//       (pallas_call :284; flags REVERSE, GATE, HAS_ACC; entry
//       mamba_scan_proj :406): K1 with B, C and delta projected from u = xc
//       inside the tile (PROJ, below), as its own kernel proj_fwd_kernel.
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
// Rows may be strided (z is the second half of xz; B and C are column
// slices of x_dbl): every sequence operand has its own row and step strides
// and unit stride along its last axis; no vector alignment is assumed.
//
// What bounds it on this card: one exp per state and step, 16 per (token,
// channel), so the SFU (16 ex2 results per clock per SM) bounds it first,
// then the issue slots (four float ops beside each exp), then the bytes of
// u/dt/z/acc/out. The tensor cores have no part. The sequence is long
// (262,144 tokens at stage 0 of a 128^3 window) while R = 1 and D = 96, so
// L is cut into chunks of T steps (the chunk_size cuts the backward's saved
// states sit on) and the carries must cross blocks.
//
// The design: ONE kernel, a single-pass chunk scan with decoupled
// look-back. A block owns a tile: row r, DB channels (TPC = 2 threads per
// channel, 8 of the 16 states each) and one scan-order chunk.
//   - The tile comes from an atomic ticket, chunk slowest, not from
//     blockIdx (CUDA starts blocks in no order): every tile a block waits on
//     holds a smaller ticket, so its block is already running and the wait
//     ends. In REVERSE the scan order starts at the last physical chunk.
//   - Staging: the chunk's B and C, delta = softplus(dt + bias) (once per
//     token and channel) and u go to shared memory, T x (2 N + DB) floats
//     and T x DB of u's type, in sub-chunks of TS steps. A sub-chunk's loads
//     are issued, unconditional and unconverted, before the sub-chunk ahead
//     of it is swept, and stored after: no load waits on another (a guarded
//     load converted inside its branch serialised them, one round trip
//     each), and a full sub-chunk steps its pointers by constant strides.
//     The z / acc rows the outputs read are asked into L2 meanwhile.
//   - Sweep 1: each thread runs its states over the chunk from a zero state
//     in registers: the chunk's aggregate (its exit state from zero) and
//     sum delta, whose decay is exp(A sum delta).
//   - Look-back: every thread writes its aggregate record (its 8 states;
//     the channel's sum delta beside), and the block raises its flag AGG.
//     One warp polls the flags of 32 predecessors per load, back to the
//     nearest one with inclusive states (flag INCL); then each thread
//     folds forward from that chunk's inclusive record, FOLD records'
//     loads at once: x = exp2(A log2(e) sum delta_m) x + agg_m, in chunk
//     order. Every inclusive state is this one fold, in this order, from
//     chunk 0's aggregate, so wherever a walk stops the entry state has the
//     same bits: the result is deterministic. The block then writes its
//     inclusive records and raises INCL. Records are per (row, chunk,
//     channel, state half); flags per (row, channel block, chunk), so a
//     poll is one 128-byte line for 32 chunks.
//   - Sweep 2: from the entry state over the staged chunk, with the
//     outputs: the two threads of a channel sum their halves of C . x with
//     one shuffle per two steps, and thread g writes the steps of parity g,
//     out = (C . x + D u (+ acc)) (* silu(z)), so each output's gate costs
//     one exp and sweep 2 needs no block barrier; a sub-chunk's z / acc
//     loads are in flight before it is swept. With `states` the exact exit
//     state is written, (R, nc, N, D) in scan order.
// Memory order of the look-back: each thread's record stores, then its
// fence (__threadfence), then the block barrier, then thread 0's relaxed
// store of the flag (the fences before it make it a release); the polling
// warp loads flags with ld.relaxed.gpu, then fence.acq_rel.gpu (an
// acquire), then the block barrier hands the walk's end to every thread,
// which reads records with ld.global.cg (L2, not the SM's L1, which is not
// coherent across SMs). A poll that waits more than 4 s traps (the launch
// fails) instead of hanging the card, as the backward's do.
// exp is ex2.approx.ftz on A pre-scaled by log2(e): one MUFU and no extra
// FMUL per state and step. Sweep 2 repeats sweep 1's exps (a chunk's decays
// would take 16 x its staged delta in shared memory), so the SFU floor is
// two sweeps' worth; the three kernels this design replaced also ran two,
// re-read u and dt from device memory and carried the chunks on 6 of 132
// SMs, one dependent round trip per chunk. What it costs beyond the two
// sweeps: the look-back, whose records are 16 x DB floats a chunk, not one
// value, so a walk of d chunks reads d of them; walks grow when the
// inclusive states lag, and a block idles while it walks.
// Ragged L and D are masked: a thread whose channel is out of range only
// stages, and a chunk's steps stop at L, so the reverse scan starts at the
// last real step and no masked step enters any state. (The JAX K6 pads L
// with delta = 0, identity steps, so its last state is exact too.)
//
// RATIO (K7; K6's flags and operands): the same tiles, staging, records and
// look-back, with the states advanced in K7's arithmetic. In sub-blocks of
// `sub` steps (sub | T), per unit (row, channel, state, sub-block):
//   cum = in-sub-block running sum of delta,  l = A cum,
//   P = exp(l),  Pinv = exp(-max(l, -MAX_BLOCK_DROP - 10))
//   v_t = c + sum_{s <= t} delta_s u_s B_s Pinv_s,  x_t = P_t v_t,
//   c <- P_end v_end                       (the carry into the next one)
// under the guard: drop = |A| sum |delta| over the sub-block, one serial
// sum in step order, below MAX_BLOCK_DROP the ratio form, otherwise the
// step recurrence (K6's). The backward kernel (gated_scan_bwd.cu, RATIO)
// takes the same serial sum of the same values, so both reach the same
// decision bit for bit; guarded = 0 is JAX's unguarded kernel (the ratio
// form everywhere, the Pinv clamp only a NaN guard). The staging sub-chunk
// (TS = 32) holds whole sub-blocks when sub | TS (JAX's S = 16), so a
// sub-block's |delta| sum is taken once a sweep, from shared memory; any
// other sub stages the whole chunk before sweep 1. Sweep 1 runs the chunk
// from zero in that form (one exp a (step, state): Pinv, or the step's
// decay), its exit the aggregate; the carry across chunks is K6's fold,
// exp(A sum delta) x + agg, since a chunk's decay is the product of its
// sub-blocks' P_end. Sweep 2 runs the ratio form again from the entry
// state, y_t = C_t . x_t: two exps a (step, state) (Pinv and P). (JAX's
// split x = x_blk + P carry at chunk level, scan_pallas_mxu.py:113-123 -
// sweep 1 writing the zero-entry output, sweep 2 adding sum_n C_t[n]
// exp(A[n] cum_t) x_entry[n] with one exp - has the same exps in all and
// ran 1.36x slower on the H100: its second sweep re-reads y.) A thread's
// sub-block whose units all take one form runs a path without the
// per-unit selects (Form). tally (two uint64: units through the ratio
// form, through the step form, real states only) is added to once per warp
// after sweep 1, or null. What bounds RATIO: three exps a (step, state)
// against K6's two, and about twice K6's float32 operations (the clamp, l,
// x = P v); the tensor cores cannot carry it (JAX's triangular products
// would take 3xTF32 for float32 parity, ~6.5 float32-add equivalents an
// output against 1 for the running sum).
//
// PROJ (K8; K1's flags, softplus, u = xc): one block owns all E <= 128
// channels of its chunk (DB = E rounded up to 32, two threads a channel),
// since each step's B, C and delta mix every channel; x_proj (its columns
// reordered to [B | C | dt]) and dt_proj are staged once a block
// (csrc/proj_tile.cuh). The whole chunk is staged before sweep 1: its xc
// rows are loaded (four sub-chunks' loads in flight at once) and stored as
// u is (rows of ldu = DB + 4 elements, so a warp's row-per-lane vector
// loads meet no bank conflict); then, between barriers, the projections
// form every row's B, C and xdt = xc W_dt in shared memory (on the tensor
// cores where xc and x_proj are bfloat16), and delta = softplus(xdt .
// dt_proj + bias), once per (token, channel). Sweep 2 reads what sweep 1
// staged, so a call projects each token once. Bounded as K1 (the SFU),
// plus the projections' 2 E (32 + Rk) operations a row (the x_proj product
// of a call, 3.5 GFLOP at stage 0 R = 2, is 0.05 ms of float32 peak); what
// it costs beyond K1 is the staging phase, which sweep 1 cannot overlap:
// per-sub-chunk phases of load, projection and delta, three barriers each,
// took a third of a block on the H100 (PERF.md §6). Nothing of B, C or
// delta goes to device memory.
//
// The kernel allocates nothing: the caller passes the output, the optional
// exit-state output (R, nc, N, D), the scratch records agg and incl (R,
// nc, D, TPC, SPT floats each) and sdel (R, nc, D floats), and the flags
// (TICKET_PAD + R nc D TPC unsigned ints, zeroed on the launch's stream;
// the first is the ticket); gated_scan_fwd_scratch sizes them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NS = 16;            // state size N the kernel is built for
constexpr int TPC = 2;            // threads per channel
constexpr int SPT = NS / TPC;     // states per thread
constexpr int MAX_THREADS = 192;  // threads per block (DB x TPC)
constexpr int FOLD = 12;          // look-back: records loaded at once
constexpr int TS = 32;            // steps of a sub-chunk (staging unit)
constexpr int G = 8;              // sweep 2: steps whose outputs go together
constexpr int BC_PER = TS * NS / 64;   // B / C entries a thread stages
constexpr int TICKET_PAD = 32;    // flags[0] is the ticket; flags from [32]
constexpr unsigned FLAG_AGG = 1, FLAG_INCL = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned long long WAIT_LIMIT_NS = 4000000000ull;

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
  float* states;        // (R, nc, NS, D) scan order, or nullptr
  float* agg;           // (R, nc, D, TPC, SPT) scratch: exit states from zero
  float* incl;          // (R, nc, D, TPC, SPT) scratch: inclusive states
  float* sdel;          // (R, nc, D) scratch: sums of delta
  unsigned* flags;      // TICKET_PAD + (R, ncb, nc), zeroed
  long long R, L, D;
  int T, nc, DB, ncb;   // steps per chunk, chunks, channels per block, blocks
  unsigned S, P;        // SLICE: slices and positions (L = S P)
  long long su_r, su_l, sdt_r, sdt_l, sz_r, sz_l, sacc_r, sacc_l;
  long long sB_r, sB_l, sC_r, sC_l;
  long long sA_r, sDv_r, sbias_r;
  int sub, guarded, n_valid;    // RATIO: sub-block, guard, real states
  unsigned long long* tally;    // RATIO: (ratio units, step units) or null
  int ldu;                      // elements of a staged row of u
  const float* W;               // PROJ: x_proj (D, Rk + 2 NS), float32
  const float* dtp;             // PROJ: dt_proj (Rk, D), float32
  int Rk;                       // PROJ: dt_rank
  int wmma;                     // PROJ: bf16 xc and x_proj, tensor cores
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

#include "ratio_guard.cuh"   // RATIO's guard and step, shared with the bwd
#include "proj_tile.cuh"     // PROJ's projections, shared with the bwd

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

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
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

// softplus(x) = max(x, 0) + log1p(e), e = exp(-|x|) in (0, 1]: the series
// to e^4 below 2^-6 (truncation < 2e-8 relative), else log(1 + e) (error
// < 2e-7, relative < 1e-5 there).
__device__ __forceinline__ float softplus_f(float x) {
  const float e = __expf(-fabsf(x));
  const float series = e * (1.f - e * (0.5f - e * (0.33333334f - 0.25f * e)));
  return fmaxf(x, 0.f) + (e < 0.015625f ? series : __logf(1.f + e));
}

// delta from dt + bias: softplus of it, or (K6) as it is.
template <bool SOFTPLUS>
__device__ __forceinline__ float delta_of(float x) {
  return SOFTPLUS ? softplus_f(x) : x;
}

// The carry across a chunk: its decay exp(A sum delta) applied to the entry
// state, plus its aggregate. The look-back and a chunk's own inclusive
// state use this one function, so every fold rounds alike.
__device__ __forceinline__ float fold(float x, float a2, float sd, float h) {
  return __fmaf_rn(ex2(a2 * sd), x, h);
}

__device__ __forceinline__ void unpack(const float4& lo, const float4& hi,
                                       float (&v)[SPT]) {
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// Original row of scan-order step tt: itself, or with SLICE the step's place
// in the slice-major layout.
template <bool SLICE>
__device__ __forceinline__ long long row_of(const Params& p, long long tt) {
  if (!SLICE) return tt;
  const unsigned t = (unsigned)tt;
  return (long long)(t % p.S) * p.P + t / p.S;
}

// First physical step of scan-order chunk v.
template <bool REVERSE>
__device__ __forceinline__ long long chunk_start(const Params& p, int v) {
  return (long long)(REVERSE ? p.nc - 1 - v : v) * p.T;
}

// Physical rows [lo, hi) of the chunk's sub-chunk s (scan steps s TS ..
// s TS + TS - 1 of a chunk of len steps).
template <bool REVERSE>
__device__ __forceinline__ void sub_rows(int s, int len, int& lo, int& hi) {
  const int a = s * TS, b = min(len, a + TS);
  lo = REVERSE ? len - b : a;
  hi = REVERSE ? len - a : b;
}

// One sub-chunk's operands in flight in registers, as loaded: B and C
// entries tid, tid + nthr, ... of its TS x NS, and dt and u of channel
// tid % DB at rows tid / DB, + TPC, ... No load is guarded by a branch and
// none is converted before the last is issued, so the loads overlap.
template <typename S>
struct Staged {
  S b[BC_PER], c[BC_PER], dt[TS / TPC], u[TS / TPC];
};

// Issue the loads of rows [lo, hi) of the chunk at t0; with `for_output`
// also ask L2 for the z / acc rows the outputs read. A full sub-chunk
// (not SLICE) steps its pointers by constant strides; otherwise every index
// is clamped into range.
template <typename S, bool GATE, bool HAS_ACC, bool SLICE>
__device__ __forceinline__ void load_sub(const Params& p, long long r,
                                         long long d0, long long t0, int lo,
                                         int hi, bool for_output,
                                         Staged<S>& q) {
  const int tid = threadIdx.x, nthr = blockDim.x, DB = p.DB;
  const S* B = static_cast<const S*>(p.B) + r * p.sB_r;
  const S* C = static_cast<const S*>(p.C) + r * p.sC_r;
  const int nbc = (hi - lo) * NS;
  const int k = tid % DB;
  const long long d = min(d0 + k, p.D - 1);
  const S* u = static_cast<const S*>(p.u) + r * p.su_r + d;
  const S* dt = static_cast<const S*>(p.dt) + r * p.sdt_r + d;
  const S* z = static_cast<const S*>(p.z) + r * p.sz_r + d;
  const S* acc = static_cast<const S*>(p.acc) + r * p.sacc_r + d;
  // one prefetch per 32 bytes of a z / acc row, and at the row's end
  const bool pf = for_output && (GATE || HAS_ACC) && d0 + k < p.D &&
                  (k % (32 / (int)sizeof(S)) == 0 || d == p.D - 1);
  if (!SLICE && hi - lo == TS) {
    const long long rb = t0 + lo + tid / NS;
    const S* pb = B + rb * p.sB_l + tid % NS;
    const S* pc = C + rb * p.sC_l + tid % NS;
    const long long stb = (nthr / NS) * p.sB_l, stc = (nthr / NS) * p.sC_l;
#pragma unroll
    for (int e = 0; e < BC_PER; ++e) {
      if (tid + e * nthr < nbc) {
        q.b[e] = *pb;
        q.c[e] = *pc;
      }
      pb += stb;
      pc += stc;
    }
    const long long t1 = t0 + lo + tid / DB;
    const S* pd = dt + t1 * p.sdt_l;
    const S* pu = u + t1 * p.su_l;
    const S* pz = z + t1 * p.sz_l;
    const S* pa = acc + t1 * p.sacc_l;
#pragma unroll
    for (int e = 0; e < TS / TPC; ++e) {
      q.dt[e] = pd[e * TPC * p.sdt_l];
      q.u[e] = pu[e * TPC * p.su_l];
      if (pf) {
        if (GATE) prefetch_l2(pz + e * TPC * p.sz_l);
        if (HAS_ACC) prefetch_l2(pa + e * TPC * p.sacc_l);
      }
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < BC_PER; ++e) {
    const int i = min(tid + e * nthr, nbc - 1);
    const long long tt = row_of<SLICE>(p, t0 + lo + i / NS);
    q.b[e] = B[tt * p.sB_l + i % NS];
    q.c[e] = C[tt * p.sC_l + i % NS];
  }
#pragma unroll
  for (int e = 0; e < TS / TPC; ++e) {
    const int t = lo + tid / DB + e * TPC;
    const long long tt = row_of<SLICE>(p, t0 + min(t, hi - 1));
    q.dt[e] = dt[tt * p.sdt_l];
    q.u[e] = u[tt * p.su_l];
    if (pf && t < hi) {
      if (GATE) prefetch_l2(z + tt * p.sz_l);
      if (HAS_ACC) prefetch_l2(acc + tt * p.sacc_l);
    }
  }
}

// Write a loaded sub-chunk into the chunk's shared buffers: B, C, delta =
// softplus(dt + bias) and u (rows of p.ldu). Out-of-range channels stage
// zeros. A full sub-chunk needs no row test: its stores are predicated, not
// branched.
template <typename S, bool SOFTPLUS>
__device__ __forceinline__ void store_sub(const Params& p, float bias,
                                          long long d0, int lo, int hi,
                                          const Staged<S>& q, float* sB,
                                          float* sC, float* sDel, S* sU) {
  const int tid = threadIdx.x, nthr = blockDim.x, DB = p.DB;
  const int nbc = (hi - lo) * NS;
#pragma unroll
  for (int e = 0; e < BC_PER; ++e) {
    const int i = tid + e * nthr;
    if (i < nbc) {
      sB[lo * NS + i] = to_f(q.b[e]);
      sC[lo * NS + i] = to_f(q.c[e]);
    }
  }
  const int k = tid % DB;
  const bool live = d0 + k < p.D;
  const int t1 = lo + tid / DB;
  float* del = sDel + t1 * DB + k;
  S* us = sU + t1 * p.ldu + k;
  auto put = [&](int e) {
    const float dv = delta_of<SOFTPLUS>(to_f(q.dt[e]) + bias);
    del[e * TPC * DB] = live ? dv : 0.f;
    us[e * TPC * p.ldu] = live ? q.u[e] : from_f<S>(0.f);
  };
  if (hi - lo == TS) {
#pragma unroll
    for (int e = 0; e < TS / TPC; ++e) put(e);
  } else {
#pragma unroll
    for (int e = 0; e < TS / TPC; ++e)
      if (t1 + e * TPC < hi) put(e);
  }
}

// PROJ: issue the loads of the xc rows [lo, hi) of the chunk at t0 (channel
// tid % DB at rows tid / DB, + TPC, ...) and ask L2 for the z / acc rows
// the outputs read, as load_sub does for u; B, C and delta are projected
// from xc. A full sub-chunk steps its pointers by a constant stride;
// otherwise every index is clamped into range.
template <typename S, bool GATE, bool HAS_ACC>
__device__ __forceinline__ void proj_load_rows(const Params& p, long long r,
                                               long long d0, long long t0,
                                               int lo, int hi,
                                               S (&u)[TS / TPC]) {
  const int DB = p.DB, k = threadIdx.x % DB;
  const long long d = min(d0 + k, p.D - 1);
  const S* xc = static_cast<const S*>(p.u) + r * p.su_r + d;
  const S* z = static_cast<const S*>(p.z) + r * p.sz_r + d;
  const S* acc = static_cast<const S*>(p.acc) + r * p.sacc_r + d;
  const bool pf = (GATE || HAS_ACC) && d0 + k < p.D &&
                  (k % (32 / (int)sizeof(S)) == 0 || d == p.D - 1);
  const int t1 = lo + (int)threadIdx.x / DB;
  if (hi - lo == TS) {
    const long long tt = t0 + t1;
    const S* pu = xc + tt * p.su_l;
    const S* pz = z + tt * p.sz_l;
    const S* pa = acc + tt * p.sacc_l;
#pragma unroll
    for (int e = 0; e < TS / TPC; ++e) {
      u[e] = pu[e * TPC * p.su_l];
      if (pf) {
        if (GATE) prefetch_l2(pz + e * TPC * p.sz_l);
        if (HAS_ACC) prefetch_l2(pa + e * TPC * p.sacc_l);
      }
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < TS / TPC; ++e) {
    const int t = t1 + e * TPC;
    const long long tt = t0 + min(t, hi - 1);
    u[e] = xc[tt * p.su_l];
    if (pf && t < hi) {
      if (GATE) prefetch_l2(z + tt * p.sz_l);
      if (HAS_ACC) prefetch_l2(acc + tt * p.sacc_l);
    }
  }
}

// PROJ: write loaded xc rows [lo, hi) into sU (rows of p.ldu). Channels
// past D stage zeros.
template <typename S>
__device__ __forceinline__ void proj_store_rows(const Params& p, long long d0,
                                                int lo, int hi,
                                                const S (&u)[TS / TPC],
                                                S* sU) {
  const int k = threadIdx.x % p.DB, t1 = lo + (int)threadIdx.x / p.DB;
  const bool live = d0 + k < p.D;
  S* us = sU + t1 * p.ldu + k;
#pragma unroll
  for (int e = 0; e < TS / TPC; ++e)
    if (hi - lo == TS || t1 + e * TPC < hi)
      us[e * TPC * p.ldu] = live ? u[e] : from_f<S>(0.f);
}

// Sweep 2 over NSTEP scan steps from i0: the states advance; returns each
// step's C . x over this thread's half of the states, and u.
template <typename S, bool REVERSE, int NSTEP>
__device__ __forceinline__ void sweep_out(int i0, int len, int DB, int ldu,
                                          int dl, int g, const float* sB,
                                          const float* sC, const float* sDel,
                                          const S* sU, const float (&a2)[SPT],
                                          float (&x)[SPT], float (&y)[NSTEP],
                                          float (&uv)[NSTEP]) {
#pragma unroll
  for (int e = 0; e < NSTEP; ++e) {
    const int t = REVERSE ? len - 1 - (i0 + e) : i0 + e;
    const float delta = sDel[t * DB + dl];
    uv[e] = to_f(sU[t * ldu + dl]);
    const float du = delta * uv[e];
    float b[SPT], c[SPT];
    const float4* b4 = reinterpret_cast<const float4*>(sB + t * NS + g * SPT);
    const float4* c4 = reinterpret_cast<const float4*>(sC + t * NS + g * SPT);
    unpack(b4[0], b4[1], b);
    unpack(c4[0], c4[1], c);
    float ya = 0.f, yb = 0.f;   // two chains of C . x
#pragma unroll
    for (int n = 0; n < SPT; n += 2) {
      x[n] = __fmaf_rn(ex2(delta * a2[n]), x[n], du * b[n]);
      x[n + 1] = __fmaf_rn(ex2(delta * a2[n + 1]), x[n + 1], du * b[n + 1]);
      ya = __fmaf_rn(c[n], x[n], ya);
      yb = __fmaf_rn(c[n + 1], x[n + 1], yb);
    }
    y[e] = ya + yb;
  }
}

// The output of one step: (C . x + D u (+ acc)) (* silu(z)).
template <typename S, bool GATE, bool HAS_ACC>
__device__ __forceinline__ S out_of(float y, float uu, float Dv, S zz, S aa) {
  float o = __fmaf_rn(Dv, uu, y);
  if (HAS_ACC) o += to_f(aa);
  if (GATE) {
    const float zf = to_f(zz);
    o *= zf / (1.f + __expf(-zf));
  }
  return from_f<S>(o);
}

// Sweep 1 over a staged sub-chunk (scan steps i0 .. i1 - 1): the states
// and the sum of delta advance.
template <typename S, bool REVERSE>
__device__ __forceinline__ void sweep_agg(int i0, int i1, int len, int DB,
                                          int ldu, int dl, int g,
                                          const float* sB,
                                          const float* sDel, const S* sU,
                                          const float (&a2)[SPT],
                                          float (&h)[SPT], float& sd) {
  auto step = [&](int i) {
    const int t = REVERSE ? len - 1 - i : i;
    const float delta = sDel[t * DB + dl];
    const float du = delta * to_f(sU[t * ldu + dl]);
    sd += delta;
    float b[SPT];
    const float4* b4 = reinterpret_cast<const float4*>(sB + t * NS + g * SPT);
    unpack(b4[0], b4[1], b);
#pragma unroll
    for (int n = 0; n < SPT; ++n)
      h[n] = __fmaf_rn(ex2(delta * a2[n]), h[n], du * b[n]);
  };
  if (i1 - i0 == TS) {   // a full sub-chunk, unrolled
#pragma unroll
    for (int e = 0; e < TS; ++e) step(i0 + e);
  } else {
    for (int i = i0; i < i1; ++i) step(i);
  }
}

// Sweep 2 over a staged sub-chunk (scan steps s TS .. i1 - 1 of the chunk
// at t0) with its outputs: the two threads of a channel sum their halves of
// C . x by shuffles, and thread g writes the steps of parity g, so each
// step's gate costs one exp and no block barrier is needed. A full
// sub-chunk's z / acc loads are all in flight before it is swept.
template <typename S, bool REVERSE, bool GATE, bool HAS_ACC, bool SLICE>
__device__ __forceinline__ void sweep_sub_out(
    const Params& p, int s, int i1, int len, long long t0, int DB, int dl,
    int g, unsigned pair, const float* sB, const float* sC, const float* sDel,
    const S* sU, const float (&a2)[SPT], float (&x)[SPT], float Dv,
    const S* z, const S* acc, S* out) {
  if (i1 - s * TS == TS) {
    // rows of steps s TS + 2 j + g: stepped, or SLICE's map
    const int i0 = s * TS + g;
    const long long tb = t0 + (REVERSE ? len - 1 - i0 : i0);
    const long long dir = REVERSE ? -2 : 2;
    S zq[TS / TPC], aq[TS / TPC];
#pragma unroll
    for (int j2 = 0; j2 < TS / TPC; ++j2) {
      const long long tt =
          SLICE ? row_of<SLICE>(p, tb + dir * j2) : tb + dir * j2;
      if (GATE) zq[j2] = z[tt * p.sz_l];
      if (HAS_ACC) aq[j2] = acc[tt * p.sacc_l];
    }
#pragma unroll
    for (int q0 = 0; q0 < TS; q0 += G) {
      float y[G], uv[G];
      sweep_out<S, REVERSE, G>(s * TS + q0, len, DB, p.ldu, dl, g, sB, sC,
                               sDel, sU, a2, x, y, uv);
#pragma unroll
      for (int j2 = 0; j2 < G / 2; ++j2) {
        // send the partner the half of its step, receive ours
        const float mine = g ? y[2 * j2 + 1] : y[2 * j2];
        const float theirs = g ? y[2 * j2] : y[2 * j2 + 1];
        const float yy = mine + __shfl_xor_sync(pair, theirs, 1);
        const float uu = g ? uv[2 * j2 + 1] : uv[2 * j2];
        const int o = q0 / 2 + j2;
        const long long tt =
            SLICE ? row_of<SLICE>(p, tb + dir * o) : tb + dir * o;
        out[tt * p.D] = out_of<S, GATE, HAS_ACC>(yy, uu, Dv, zq[o], aq[o]);
      }
    }
    return;
  }
  for (int i = s * TS; i < i1; ++i) {   // a ragged chunk's last steps
    float y[1], uv[1];
    sweep_out<S, REVERSE, 1>(i, len, DB, p.ldu, dl, g, sB, sC, sDel, sU, a2,
                             x, y, uv);
    const float yy = y[0] + __shfl_xor_sync(pair, y[0], 1);
    if ((i & 1) == g) {
      const long long tt = row_of<SLICE>(p, t0 + (REVERSE ? len - 1 - i : i));
      S zz = from_f<S>(0.f), aa = from_f<S>(0.f);
      if (GATE) zz = z[tt * p.sz_l];
      if (HAS_ACC) aa = acc[tt * p.sacc_l];
      out[tt * p.D] = out_of<S, GATE, HAS_ACC>(yy, uv[0], Dv, zz, aa);
    }
  }
}

// RATIO: the guard bits of sub-block [tb, te) of the staged chunk for this
// thread's states: the serial sum of |delta| in step order (the backward's
// pre-pass takes the same sum of the same values).
__device__ __forceinline__ unsigned sub_block_bits(const float* sDel, int DB,
                                                   int dl, int tb, int te,
                                                   const float (&aa)[SPT],
                                                   int guarded) {
  float dabs = 0.f;
  for (int t = tb; t < te; ++t) dabs += fabsf(sDel[t * DB + dl]);
  return ratio_bits(dabs, aa, guarded);
}

// RATIO, one step of unit n in form FORM (guard bits m): v advances;
// returns its state x_t when WITH_X (P v, or v), else 0.
template <bool WITH_X, int FORM>
__device__ __forceinline__ float ratio_step(unsigned m, int n, float a2,
                                            float cum, float delta,
                                            float bu, float& v) {
  const bool r = is_ratio<FORM>(m, n);
  const float l2 = a2 * cum;
  ratio_advance(r, l2, a2, delta, bu, v);
  if (!WITH_X) return 0.f;
  return r ? ex2(l2) * v : v;
}

// RATIO sweep over the sub-blocks of scan steps [i0, i1) (sub-block
// aligned, i1 <= len): v (the carry, x at sub-block ends) and sum delta sd
// advance; the units are counted by form (real states: `valid`). With
// WITH_OUT (sweep 2), y_t = C_t . x_t over the channel's two threads, one
// shuffle a step, written by the thread of the step's parity to out (the
// chunk's first row).
template <bool WITH_OUT>
__device__ __forceinline__ void sweep_ratio(
    const Params& p, int i0, int i1, int len, int DB, int dl, int g,
    unsigned pair, const float* sB, const float* sC, const float* sDel,
    const float* sU, const float (&a2)[SPT], const float (&aa)[SPT],
    unsigned valid, float (&v)[SPT], float& sd, unsigned (&units)[2],
    float* out) {
  for (int tb = i0; tb < i1; tb += p.sub) {
    const int te = min(tb + p.sub, len);
    const unsigned m = sub_block_bits(sDel, DB, dl, tb, te, aa, p.guarded);
    units[0] += __popc(m & valid);
    units[1] += __popc(~m & valid);
    float cum = 0.f;
    auto steps = [&](auto form) __attribute__((always_inline)) {
      constexpr int F = decltype(form)::value;
      for (int t = tb; t < te; ++t) {
        const float delta = sDel[t * DB + dl];
        const float du = delta * sU[t * p.ldu + dl];
        cum += delta;
        sd += delta;
        float b[SPT], c[SPT];
        const float4* b4 =
            reinterpret_cast<const float4*>(sB + t * NS + g * SPT);
        unpack(b4[0], b4[1], b);
        float ya = 0.f, yb = 0.f;   // two chains of C . x
        if (WITH_OUT) {
          const float4* c4 =
              reinterpret_cast<const float4*>(sC + t * NS + g * SPT);
          unpack(c4[0], c4[1], c);
        }
#pragma unroll
        for (int n = 0; n < SPT; n += 2) {
          const float x0 = ratio_step<WITH_OUT, F>(m, n, a2[n], cum, delta,
                                                   du * b[n], v[n]);
          const float x1 = ratio_step<WITH_OUT, F>(
              m, n + 1, a2[n + 1], cum, delta, du * b[n + 1], v[n + 1]);
          if (WITH_OUT) {
            ya = __fmaf_rn(c[n], x0, ya);
            yb = __fmaf_rn(c[n + 1], x1, yb);
          }
        }
        if (WITH_OUT) {
          const float yt = ya + yb;
          const float y = yt + __shfl_xor_sync(pair, yt, 1);
          if ((t & 1) == g) out[(long long)t * p.D] = y;
        }
      }
    };
    if (m == (1u << SPT) - 1u)
      steps(Form<ALL_RATIO>{});
    else if (m == 0u)
      steps(Form<ALL_STEP>{});
    else
      steps(Form<MIXED>{});
#pragma unroll
    for (int n = 0; n < SPT; ++n)   // the carry out of the sub-block: P_end v
      if (m >> n & 1u) v[n] *= ex2(a2[n] * cum);
  }
}

// PROJ: delta = softplus(xdt . dt_proj + bias) of the chunk's rows for the
// staging channel (tid % DB), 8 rows at a time: their loads and softplus
// before their stores. No barrier.
template <int RK>
__device__ __forceinline__ void proj_delta_rows(const Params& p, float bias,
                                                long long d0, int len,
                                                const float* sXdt,
                                                const float* sDtp,
                                                float* sDel) {
  const int DB = p.DB, k = threadIdx.x % DB;
  const bool live = d0 + k < p.D;
  for (int t0 = (int)threadIdx.x / DB; t0 < len; t0 += 8 * TPC) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = min(t0 + j * TPC, len - 1);
      v[j] = softplus_f(proj_dt_raw<RK>(sXdt + t * p.Rk, sDtp, DB, p.Rk, k,
                                        bias));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (t0 + j * TPC < len)
        sDel[(t0 + j * TPC) * DB + k] = live ? v[j] : 0.f;
  }
}

// PROJ: the whole chunk staged at once. Its xc rows go to sU (the loads of
// up to four sub-chunks in flight together, issued before any is stored);
// then, between barriers, the projections of every row form B, C and xdt,
// and delta = softplus(xdt . dt_proj + bias) is formed for the staging
// channel (tid % DB), as store_sub stages delta. One staging phase a chunk,
// three barriers: four sub-chunks' phases, with three barriers each, left
// the projections latency-bound (a third of a block on the H100). Every
// thread enters; ends with a barrier.
template <typename S, bool REVERSE, bool GATE, bool HAS_ACC>
__device__ __forceinline__ void proj_stage_chunk(
    const Params& p, long long r, long long d0, long long t0, int len,
    float bias, S* sU, const float* sWt, const float* sDtp, float* sB,
    float* sC, float* sXdt, float* sDel) {
  constexpr int AHEAD = 4;   // sub-chunks whose loads are in flight at once
  const int nsub = (len + TS - 1) / TS;
  for (int s0 = 0; s0 < nsub; s0 += AHEAD) {
    S q[AHEAD][TS / TPC];
    int lo[AHEAD], hi[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (s0 + k < nsub) {
        sub_rows<REVERSE>(s0 + k, len, lo[k], hi[k]);
        proj_load_rows<S, GATE, HAS_ACC>(p, r, d0, t0, lo[k], hi[k], q[k]);
      }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (s0 + k < nsub) proj_store_rows<S>(p, d0, lo[k], hi[k], q[k], sU);
  }
  __syncthreads();
  if constexpr (is_bf16<S>) {
    if (p.wmma)   // sWt holds the weights in bfloat16 (proj_stage_wb)
      project_rows_mma(sU, p.ldu, 0, len, p.DB,
                       reinterpret_cast<const __nv_bfloat16*>(sWt), p.Rk, sB,
                       sC, sXdt);
    else
      project_rows<S>(sU, p.ldu, 0, len, p.DB, sWt, p.Rk, sB, sC, sXdt);
  } else {
    project_rows<S>(sU, p.ldu, 0, len, p.DB, sWt, p.Rk, sB, sC, sXdt);
  }
  __syncthreads();
  switch (p.Rk) {   // delta; the models' dt_ranks unrolled
    case 1: proj_delta_rows<1>(p, bias, d0, len, sXdt, sDtp, sDel); break;
    case 2: proj_delta_rows<2>(p, bias, d0, len, sXdt, sDtp, sDel); break;
    case 3: proj_delta_rows<3>(p, bias, d0, len, sXdt, sDtp, sDel); break;
    case 4: proj_delta_rows<4>(p, bias, d0, len, sXdt, sDtp, sDel); break;
    default: proj_delta_rows<0>(p, bias, d0, len, sXdt, sDtp, sDel);
  }
  __syncthreads();
}

// Floats of the staged u rows (T rows of ldu elements), 16-byte aligned.
template <typename S>
__host__ __device__ __forceinline__ int u_floats(int T, int ldu) {
  return (T * ldu * (int)sizeof(S) + 15) / 16 * 4;
}

template <typename S, bool REVERSE, bool GATE, bool HAS_ACC, bool SOFTPLUS,
          bool SLICE, bool RATIO, bool PROJ>
__device__ __forceinline__ void scan_fwd_body(const Params& p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = p.T, DB = p.DB;
  unsigned* sMisc = reinterpret_cast<unsigned*>(smem);   // ticket, walk
  float* sB = smem + 4;             // (T, NS)
  float* sC = sB + T * NS;          // (T, NS)
  float* sDel = sC + T * NS;        // (T, DB) delta
  S* sU = reinterpret_cast<S*>(sDel + T * DB);   // (T, ldu) u
  // PROJ: xdt (T, Rk), x_proj transposed (Rk + 2 NS, DB), dt_proj (Rk, DB)
  float* sXdt = sDel + T * DB + u_floats<S>(T, p.ldu);
  float* sWt = sXdt + (T * p.Rk + 3) / 4 * 4;
  float* sDtp = sWt + (p.Rk + 2 * NS) * DB;
  const int tid = threadIdx.x;

  if (tid == 0) sMisc[0] = atomicAdd(p.flags, 1u);
  __syncthreads();
  const unsigned ticket = sMisc[0];
  const unsigned per_chunk = (unsigned)(p.R * p.ncb);
  const int w = (int)(ticket / per_chunk);           // chunk, scan order
  const long long r = (ticket % per_chunk) / p.ncb;
  const long long d0 = (long long)((ticket % per_chunk) % p.ncb) * DB;
  const long long t0 = chunk_start<REVERSE>(p, w);
  const int len = (int)min((long long)T, p.L - t0);
  const int nsub = (len + TS - 1) / TS;
  const int dl = tid / TPC;         // channel of this thread in the block
  const int g = tid % TPC;          // its half of the states
  const long long d = d0 + dl;
  const bool active = d < p.D;      // others only stage
  const long long dc = active ? d : 0;

  Staged<S> q;
  int lo, hi;
  sub_rows<REVERSE>(0, len, lo, hi);
  if constexpr (PROJ) {   // the weights: bfloat16 for the tensor cores
    proj_stage_weights(p.W, p.dtp, (int)p.D, DB, p.Rk, sWt, !p.wmma);
    if (p.wmma)
      proj_stage_wb(p.W, (int)p.D, DB, p.Rk,
                    reinterpret_cast<__nv_bfloat16*>(sWt));
  } else {
    load_sub<S, GATE, HAS_ACC, SLICE>(p, r, d0, t0, lo, hi, true, q);
  }
  float a2[SPT], aa[SPT];   // A log2(e); |A| (RATIO's guard)
  const float* Ar = p.A + r * p.sA_r + dc * NS + g * SPT;
#pragma unroll
  for (int n = 0; n < SPT; ++n) {
    a2[n] = Ar[n] * LOG2E;
    aa[n] = fabsf(Ar[n]);
  }
  // the staging channel's bias
  const float bias =
      RATIO ? 0.f : p.bias[r * p.sbias_r + min(d0 + tid % DB, p.D - 1)];
  // RATIO with sub-blocks that straddle sub-chunks: the whole chunk first
  const bool whole = RATIO && TS % p.sub != 0;
  if constexpr (PROJ) {   // PROJ: the whole chunk, projected once
    proj_stage_chunk<S, REVERSE, GATE, HAS_ACC>(p, r, d0, t0, len, bias, sU,
                                                sWt, sDtp, sB, sC, sXdt,
                                                sDel);
  } else {
    store_sub<S, SOFTPLUS>(p, bias, d0, lo, hi, q, sB, sC, sDel, sU);
    for (int s = 1; whole && s < nsub; ++s) {
      sub_rows<REVERSE>(s, len, lo, hi);
      load_sub<S, GATE, HAS_ACC, SLICE>(p, r, d0, t0, lo, hi, false, q);
      store_sub<S, SOFTPLUS>(p, bias, d0, lo, hi, q, sB, sC, sDel, sU);
    }
    __syncthreads();
  }
  const unsigned pair = 3u << (tid & 30);   // the channel's two threads
  float* yr = RATIO ? static_cast<float*>(p.out) + (r * p.L + t0) * p.D + dc
                    : nullptr;              // RATIO: the chunk's outputs
  unsigned valid = 0, units[2] = {0u, 0u};  // RATIO: real states, tally
#pragma unroll
  for (int n = 0; n < SPT; ++n)
    if (g * SPT + n < p.n_valid) valid |= 1u << n;

  // Sweep 1: the chunk from a zero state, each sub-chunk's loads in flight
  // while the one before it is swept (PROJ: all staged before).
  float h[SPT], sd = 0.f;
#pragma unroll
  for (int n = 0; n < SPT; ++n) h[n] = 0.f;
  const int nsw = whole ? 1 : nsub;
  for (int s = 0; s < nsw; ++s) {
    const bool more = !PROJ && s + 1 < nsw;   // PROJ: the chunk is staged
    if (more) {
      sub_rows<REVERSE>(s + 1, len, lo, hi);
      load_sub<S, GATE, HAS_ACC, SLICE>(p, r, d0, t0, lo, hi, true, q);
    }
    if (active) {
      const int i1 = whole ? len : min(len, (s + 1) * TS);
      if constexpr (RATIO)
        sweep_ratio<false>(p, s * TS, i1, len, DB, dl, g, pair, sB, sC,
                           sDel, sU, a2, aa, valid, h, sd, units, yr);
      else
        sweep_agg<S, REVERSE>(s * TS, i1, len, DB, p.ldu, dl, g, sB, sDel, sU,
                              a2, h, sd);
    }
    if (more) {   // rows of sub-chunk s + 1: nobody reads them yet
      store_sub<S, SOFTPLUS>(p, bias, d0, lo, hi, q, sB, sC, sDel, sU);
      __syncthreads();
    }
  }
  if (RATIO && p.tally != nullptr) tally_add(p.tally, units);
  // Look-back: the entry state x of chunk w. Records are per thread; the
  // flag is the block's, set by thread 0 after every thread's records are
  // out (each thread fences its stores, then the block barrier), and one
  // warp polls the flags of 32 predecessors with one load.
  float x[SPT];
#pragma unroll
  for (int n = 0; n < SPT; ++n) x[n] = 0.f;
  const long long rec = (r * p.nc * p.D + dc) * TPC + g;  // chunk 0's
  const long long rec_m = p.D * TPC;                      // per chunk
  float* sdel = p.sdel + r * p.nc * p.D + dc;             // chunk 0's
  unsigned* flags =   // (row, channel block)'s flag of chunk 0
      p.flags + TICKET_PAD + (r * p.ncb + d0 / DB) * p.nc;
  if (w > 0) {
    if (active) {
      float4* ag =
          reinterpret_cast<float4*>(p.agg + (rec + w * rec_m) * SPT);
      ag[0] = make_float4(h[0], h[1], h[2], h[3]);
      ag[1] = make_float4(h[4], h[5], h[6], h[7]);
      sdel[w * p.D] = sd;   // both threads of the channel: the same bits
    }
    publish(flags + w, FLAG_AGG);
    // warp 0 walks back to the nearest inclusive state; every chunk between
    // it and w has its aggregate out
    if (tid < 32) {
      const int lane = tid;
      int top = w - 1;
      unsigned long long t_wait = 0;
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
        const unsigned long long now = global_ns();
        if (t_wait == 0) t_wait = now;
        else if (now - t_wait > WAIT_LIMIT_NS) __trap();
        __nanosleep(32);
      }
      fence_acquire();
      if (lane == 0) sMisc[1] = (unsigned)top;
    }
    __syncthreads();
    const int j = (int)sMisc[1];
    if (active) {
      const float4* in = reinterpret_cast<const float4*>(
          p.incl + (rec + j * rec_m) * SPT);
      unpack(__ldcg(in), __ldcg(in + 1), x);
      for (int m = j + 1; m < w; m += FOLD) {   // FOLD records at once
        float4 a[FOLD][2];
        float sdm[FOLD];
#pragma unroll
        for (int e = 0; e < FOLD; ++e) {   // past w - 1: loaded, not folded
          const int me = min(m + e, w - 1);
          const float4* am = reinterpret_cast<const float4*>(
              p.agg + (rec + me * rec_m) * SPT);
          a[e][0] = __ldcg(am);
          a[e][1] = __ldcg(am + 1);
          sdm[e] = __ldcg(sdel + me * p.D);
        }
#pragma unroll
        for (int e = 0; e < FOLD; ++e)
          if (m + e < w) {
            float hm[SPT];
            unpack(a[e][0], a[e][1], hm);
#pragma unroll
            for (int n = 0; n < SPT; ++n)
              x[n] = fold(x[n], a2[n], sdm[e], hm[n]);
          }
      }
    }
  }
  if (w < p.nc - 1) {   // publish the inclusive state of w
    if (active) {
      float xi[SPT];
#pragma unroll
      for (int n = 0; n < SPT; ++n)
        xi[n] = w > 0 ? fold(x[n], a2[n], sd, h[n]) : h[n];
      float4* in =
          reinterpret_cast<float4*>(p.incl + (rec + w * rec_m) * SPT);
      in[0] = make_float4(xi[0], xi[1], xi[2], xi[3]);
      in[1] = make_float4(xi[4], xi[5], xi[6], xi[7]);
    }
    publish(flags + w, FLAG_INCL);
  }
  if (!active) return;   // no barrier follows

  // Sweep 2 from the entry state, with the outputs, and the exit state.
  if constexpr (RATIO) {
    float sd2 = 0.f;
    unsigned counted[2] = {0u, 0u};   // counted in sweep 1
    sweep_ratio<true>(p, 0, len, len, DB, dl, g, pair, sB, sC, sDel, sU, a2,
                      aa, valid, x, sd2, counted, yr);
  } else {
    const float Dv = p.Dv[r * p.sDv_r + dc];
    const S* z = static_cast<const S*>(p.z) + r * p.sz_r + dc;
    const S* acc = static_cast<const S*>(p.acc) + r * p.sacc_r + dc;
    S* out = static_cast<S*>(p.out) + r * p.L * p.D + dc;
    for (int s = 0; s < nsub; ++s)
      sweep_sub_out<S, REVERSE, GATE, HAS_ACC, SLICE>(
          p, s, min(len, (s + 1) * TS), len, t0, DB, dl, g, pair, sB, sC,
          sDel, sU, a2, x, Dv, z, acc, out);
  }
  if (p.states != nullptr) {
    float* st = p.states + ((r * p.nc + w) * NS + g * SPT) * p.D + d;
#pragma unroll
    for (int n = 0; n < SPT; ++n) st[n * p.D] = x[n];
  }
}

template <typename S, bool REVERSE, bool GATE, bool HAS_ACC, bool SOFTPLUS,
          bool SLICE>
__global__ void __launch_bounds__(MAX_THREADS, 2) scan_fwd_kernel(Params p) {
  scan_fwd_body<S, REVERSE, GATE, HAS_ACC, SOFTPLUS, SLICE, false, false>(p);
}

// K7: K6's instance (float32, forward, ungated, no acc, delta as given) in
// the ratio form.
__global__ void __launch_bounds__(MAX_THREADS, 2) mxu_fwd_kernel(Params p) {
  scan_fwd_body<float, false, false, false, false, false, true, false>(p);
}

// K8: K1's instances with the projections in the tile. Up to 256 threads
// (128 channels) a block, with K1's register budget (168 a thread, as two
// blocks of 192 threads an SM give K1).
template <typename S, bool REVERSE, bool GATE, bool HAS_ACC>
__global__ void __maxnreg__(168) proj_fwd_kernel(Params p) {
  scan_fwd_body<S, REVERSE, GATE, HAS_ACC, true, false, false, true>(p);
}

template <typename S>
size_t smem_bytes(const Params& p) {
  size_t floats = 4 + (size_t)p.T * (2 * NS + p.DB) + u_floats<S>(p.T, p.ldu);
  if (p.Rk > 0)   // PROJ: xdt, x_proj and dt_proj
    floats += (size_t)(p.T * p.Rk + 3) / 4 * 4 +
              (size_t)(2 * p.Rk + 2 * NS) * p.DB;
  return floats * sizeof(float);
}

template <typename S>
cudaError_t launch_kernel(void (*kernel)(Params), const Params& p,
                          cudaStream_t stream) {
  const size_t smem = smem_bytes<S>(p);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(p.R * p.ncb * p.nc);
  kernel<<<blocks, p.DB * TPC, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename S, bool REVERSE, bool GATE, bool HAS_ACC, bool SOFTPLUS,
          bool SLICE>
cudaError_t launch_one(const Params& p, cudaStream_t stream) {
  return launch_kernel<S>(
      scan_fwd_kernel<S, REVERSE, GATE, HAS_ACC, SOFTPLUS, SLICE>, p, stream);
}

template <typename S, bool REVERSE, bool SOFTPLUS, bool SLICE>
cudaError_t launch_flags(const Params& p, bool gate, bool has_acc,
                         cudaStream_t stream) {
  if constexpr (!SOFTPLUS)   // K6: ungated, no acc
    return launch_one<S, REVERSE, false, false, false, false>(p, stream);
  if (gate && has_acc)
    return launch_one<S, REVERSE, true, true, true, SLICE>(p, stream);
  if (gate)   // K5's own flags with SLICE
    return launch_one<S, REVERSE, true, false, true, SLICE>(p, stream);
  if (has_acc)
    return launch_one<S, REVERSE, false, true, true, SLICE>(p, stream);
  return launch_one<S, REVERSE, false, false, true, SLICE>(p, stream);
}

template <typename S, bool REVERSE>
cudaError_t launch_proj(const Params& p, bool gate, bool has_acc,
                        cudaStream_t stream) {
  if (gate && has_acc)
    return launch_kernel<S>(proj_fwd_kernel<S, REVERSE, true, true>, p,
                            stream);
  if (gate)
    return launch_kernel<S>(proj_fwd_kernel<S, REVERSE, true, false>, p,
                            stream);
  if (has_acc)
    return launch_kernel<S>(proj_fwd_kernel<S, REVERSE, false, true>, p,
                            stream);
  return launch_kernel<S>(proj_fwd_kernel<S, REVERSE, false, false>, p,
                          stream);
}

// K8's block for E channels, dt_rank Rk and chunk T: E rounded up to 32
// channels, staged rows of ldu = DB + 4 elements (= 4 mod 8: conflict-free
// row-per-lane loads).
void proj_block(Params& p, long long E, int Rk, int T) {
  p.T = T;
  p.Rk = Rk;
  p.DB = (int)(E + 31) / 32 * 32;
  p.ldu = p.DB + 4;
}

}  // namespace

extern "C" {

// strides: u_r, u_l, dt_r, dt_l, z_r, z_l, acc_r, acc_l, B_r, B_l, C_r, C_l,
//          A_r, Dv_r, bias_r (elements; host array of 15).
// softplus = 0 is K6's mode: float32, no reverse, no gate, no acc.
// nslices > 0 is K5's mode (SLICE, nslices | L): forward; gate and acc
// (in original row order) as for K1. channels: channels per block (DB, a
// multiple of 32). agg, incl and flags as
// gated_scan_fwd_scratch sizes them, flags zeroed; all required. Returns a
// cudaError_t value (0 = launched).
int gated_scan_fwd(const void* u, const void* dt, const void* z,
                   const void* acc, const void* B, const void* C,
                   const float* A, const float* Dv, const float* bias,
                   void* out, float* states, float* agg, float* incl,
                   float* sdel, unsigned* flags, int is_bf16, int reverse,
                   int gate, int has_acc, int softplus, long long nslices,
                   long long R,
                   long long L, long long D, int N, int T, int channels,
                   const long long* strides, void* stream) {
  if (N != NS || T < 1 || T > 256 || channels < 32 || channels % 32
      || channels * TPC > MAX_THREADS || R < 1 || L < 1
      || D < 1 || L > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!softplus && (is_bf16 || reverse || gate || has_acc || nslices))
    return (int)cudaErrorInvalidValue;
  if (nslices && (nslices < 1 || L % nslices || reverse))
    return (int)cudaErrorInvalidValue;
  if (agg == nullptr || incl == nullptr || sdel == nullptr ||
      flags == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.u = u; p.dt = dt; p.z = z; p.acc = acc; p.B = B; p.C = C;
  p.A = A; p.Dv = Dv; p.bias = bias;
  p.out = out; p.states = states; p.agg = agg; p.incl = incl;
  p.sdel = sdel; p.flags = flags;
  p.R = R; p.L = L; p.D = D; p.T = T; p.DB = channels;
  p.ldu = channels;
  p.S = nslices ? (unsigned)nslices : 1u;
  p.P = (unsigned)(L / p.S);
  const long long nc = (L + T - 1) / T;
  const long long ncb = (D + channels - 1) / channels;
  if (R * ncb * nc > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.nc = (int)nc;
  p.ncb = (int)ncb;
  const size_t smem = is_bf16 ? smem_bytes<__nv_bfloat16>(p)
                              : smem_bytes<float>(p);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  p.su_r = strides[0]; p.su_l = strides[1];
  p.sdt_r = strides[2]; p.sdt_l = strides[3];
  p.sz_r = strides[4]; p.sz_l = strides[5];
  p.sacc_r = strides[6]; p.sacc_l = strides[7];
  p.sB_r = strides[8]; p.sB_l = strides[9];
  p.sC_r = strides[10]; p.sC_l = strides[11];
  p.sA_r = strides[12]; p.sDv_r = strides[13]; p.sbias_r = strides[14];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool g = gate != 0, a = has_acc != 0;
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (!softplus)
    err = launch_flags<float, false, false, false>(p, false, false, st);
  else if (nslices)
    err = is_bf16 ? launch_flags<bf, false, true, true>(p, g, a, st)
                  : launch_flags<float, false, true, true>(p, g, a, st);
  else if (is_bf16)
    err = reverse ? launch_flags<bf, true, true, false>(p, g, a, st)
                  : launch_flags<bf, false, true, false>(p, g, a, st);
  else
    err = reverse ? launch_flags<float, true, true, false>(p, g, a, st)
                  : launch_flags<float, false, true, false>(p, g, a, st);
  return (int)err;
}

// K7 (RATIO): float32 u, delta (final), B, C with strides u_r, u_l,
// delta_r, delta_l, B_r, B_l, C_r, C_l, A_r (elements; host array of 9); A
// (R|1, D, 16); y (R, L, D) contiguous and the chunk exit states (R, nc,
// 16, D) written; agg, incl, sdel and flags (zeroed) as
// gated_scan_fwd_scratch sizes them. sub | T is the sub-block, guarded the
// per-unit guard (0: the ratio form everywhere); tally (two uint64, added
// to) or null counts the units of the first n_valid states by form.
// Returns a cudaError_t value.
int mxu_scan_fwd(const float* u, const float* dt, const float* A,
                 const float* B, const float* C, float* y, float* states,
                 float* agg, float* incl, float* sdel, unsigned* flags,
                 unsigned long long* tally, long long R, long long L,
                 long long D, int T, int sub, int guarded, int n_valid,
                 int channels, const long long* strides, void* stream) {
  if (T < 1 || T > 256 || sub < 1 || T % sub != 0 || channels < 32 ||
      channels % 32 || channels * TPC > MAX_THREADS || R < 1 || L < 1 ||
      D < 1 || L > 0x7fffffffLL || n_valid < 1 || n_valid > NS)
    return (int)cudaErrorInvalidValue;
  if (y == nullptr || states == nullptr || agg == nullptr ||
      incl == nullptr || sdel == nullptr || flags == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.u = u; p.dt = dt; p.B = B; p.C = C; p.A = A;
  p.out = y; p.states = states; p.agg = agg; p.incl = incl;
  p.sdel = sdel; p.flags = flags; p.tally = tally;
  p.R = R; p.L = L; p.D = D; p.T = T; p.DB = channels;
  p.ldu = channels;
  p.S = 1u;
  p.P = (unsigned)L;
  p.sub = sub; p.guarded = guarded != 0; p.n_valid = n_valid;
  const long long nc = (L + T - 1) / T;
  const long long ncb = (D + channels - 1) / channels;
  if (R * ncb * nc > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.nc = (int)nc;
  p.ncb = (int)ncb;
  if (smem_bytes<float>(p) > 232448) return (int)cudaErrorInvalidValue;
  p.su_r = strides[0]; p.su_l = strides[1];
  p.sdt_r = strides[2]; p.sdt_l = strides[3];
  p.sB_r = strides[4]; p.sB_l = strides[5];
  p.sC_r = strides[6]; p.sC_l = strides[7];
  p.sA_r = strides[8];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)launch_kernel<float>(mxu_fwd_kernel, p, st);
}

// K8's shared memory a block in bytes (proj_scan_fwd takes at most
// 232448, an H100 block's limit); scan_proj.py mirrors it.
long long proj_scan_fwd_smem(long long E, int Rk, int T, int is_bf16) {
  Params p{};
  proj_block(p, E, Rk, T);
  return (long long)(is_bf16 ? smem_bytes<__nv_bfloat16>(p)
                             : smem_bytes<float>(p));
}

// K8 (PROJ): xc (R, L, E) with strides xc_r, xc_l, z_r, z_l, acc_r, acc_l
// (elements; host array of 6), unit stride along the channels; W = x_proj
// (E, Rk + 2 N) and dtp = dt_proj (Rk, E), bias and D (E) and A (E, N),
// float32, contiguous, shared by the rows. out (R, L, E) contiguous;
// states (R, nc, N, E) in scan order, or null; agg, incl, sdel and flags
// (zeroed) as gated_scan_fwd_scratch sizes them. E <= 128 (one block owns
// every channel), 1 <= Rk <= 16, proj_scan_fwd_smem <= 232448. wmma (with
// is_bf16): W holds bfloat16 values (x_proj was bfloat16), and the
// projections run on the tensor cores. Returns a cudaError_t value.
int proj_scan_fwd(const void* xc, const void* z, const void* acc,
                  const float* W, const float* dtp, const float* bias,
                  const float* A, const float* Dv, void* out, float* states,
                  float* agg, float* incl, float* sdel, unsigned* flags,
                  int is_bf16, int wmma, int reverse, int gate, int has_acc,
                  long long R, long long L, long long E, int Rk, int T,
                  const long long* strides, void* stream) {
  if (T < 1 || T > 256 || E < 1 || E > PROJ_MAX_CHANNELS || Rk < 1 ||
      Rk > PROJ_MAX_RANK || R < 1 || L < 1 || L > 0x7fffffffLL ||
      (gate && z == nullptr) || (has_acc && acc == nullptr) ||
      xc == nullptr || W == nullptr || dtp == nullptr || out == nullptr ||
      agg == nullptr || incl == nullptr || sdel == nullptr ||
      flags == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long nc = (L + T - 1) / T;
  if (R * nc > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Params p{};
  p.u = xc; p.z = z; p.acc = acc; p.A = A; p.Dv = Dv; p.bias = bias;
  p.out = out; p.states = states; p.agg = agg; p.incl = incl;
  p.sdel = sdel; p.flags = flags; p.W = W; p.dtp = dtp;
  p.wmma = is_bf16 && wmma;
  p.R = R; p.L = L; p.D = E;
  proj_block(p, E, Rk, T);
  p.S = 1u;
  p.P = (unsigned)L;
  p.nc = (int)nc;
  p.ncb = 1;
  p.n_valid = NS;
  p.su_r = strides[0]; p.su_l = strides[1];
  p.sz_r = strides[2]; p.sz_l = strides[3];
  p.sacc_r = strides[4]; p.sacc_l = strides[5];
  if (proj_scan_fwd_smem(E, Rk, T, is_bf16) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool g = gate != 0, a = has_acc != 0;
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (is_bf16)
    err = reverse ? launch_proj<bf, true>(p, g, a, st)
                  : launch_proj<bf, false>(p, g, a, st);
  else
    err = reverse ? launch_proj<float, true>(p, g, a, st)
                  : launch_proj<float, false>(p, g, a, st);
  return (int)err;
}

// Scratch sizes in elements: agg and incl (floats each), sdel (floats),
// flags (unsigned ints, to be zeroed).
void gated_scan_fwd_scratch(long long R, long long L, long long D, int T,
                            long long* sizes) {
  const long long nc = (L + T - 1) / T;
  sizes[0] = R * nc * D * TPC * SPT;
  sizes[1] = R * nc * D;
  sizes[2] = TICKET_PAD + R * ((D + 31) / 32) * nc;
}

const char* gated_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
