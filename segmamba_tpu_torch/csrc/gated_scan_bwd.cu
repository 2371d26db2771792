// Gated selective scan, backward, for Hopper (sm_90a).
//
// Replaces five Pallas TPU kernels of the JAX package with one template:
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
//   K7  segmamba_tpu/ops/scan_pallas_mxu.py:165   _bwd_kernel (pallas_call
//       :284; _bwd_call_mxu :275, _make_core :335): K6's adjoint in K7's
//       ratio form (RATIO, below), as its own kernel mxu_bwd_kernel.
//   K8  segmamba_tpu/ops/scan_pallas_proj.py:134  _proj_bwd_kernel
//       (pallas_call :351; _proj_bwd_call :200, _make_proj_core :369): K3
//       through the projections formed in the tile (PROJ, below), as its own
//       kernel proj_bwd_kernel.
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
// bfloat16); dA, dD, dbias are float32 partials per chunk and dB, dC per
// channel block, which the wrapper sums with torch.sum (no atomics, and
// every sum inside the kernel in a fixed order, so every run gives the
// same bits).
//
// What bounds it on this card: an elementwise recurrence with 16 states
// per (step, channel): exps (the SFU, 16 results per clock per SM), the
// float32 issue slots of ~20 operations per (step, channel, state), and the
// channel sums of dB and dC (warp shuffles); the bytes (u, dt, z, acc,
// dout in, du, ddt, dz, dacc out) come after, the tensor cores have no
// part. Two things make it harder than the forward: x runs forwards while
// the adjoint runs backwards, and x cannot be walked backwards by dividing
// by a (a = exp(delta A) underflows to 0 for A near -16).
//
// The design: ONE kernel per call, a single-pass chunk scan with decoupled
// look-back in reverse scan order. A block owns a tile: row r, DB channels
// and one chunk of T steps (the forward's chunks, whose entry states it
// reads).
//   - The tile comes from an atomic ticket handed out in REVERSE scan order
//     (the last scan chunk first): every tile a block waits on holds a
//     smaller ticket, so its block is already running and the wait ends.
//     With REVERSE, scan order is the mirrored physical order on the same
//     layout, as in the forward.
//   - TPC = 4 threads per channel, 4 states each (the forward takes 2 and
//     8): the walk holds x for a group of K = 8 steps in registers (K x the
//     states of a thread) and the checkpoints sit in shared memory for the
//     whole tile (T / K - 1 x 16 floats a channel, 45 KB for 48 channels
//     at T = 128; group 0's is the entry state, re-read); with 4 states a
//     thread, three blocks of 48 channels (192 threads, 74 KB of shared
//     memory) share an SM. On the H100 three blocks of 192 threads (96
//     registers) run faster than two with more registers and no spills
//     (`two_blocks` in tools/scan_bwd_probe.py), which is why the launch
//     bound asks for three.
//   - Staging: a group of K steps at a time into a two-slot ring in shared
//     memory (one barrier a group): B and C, delta (softplus once per token
//     and channel), u and
//     dy = dout silu(z) (the gate once), loads of the next group in flight
//     in registers while the current one is swept, as in gated_scan_fwd.cu.
//     Sweep F stages also dzf = dout silu'(z) and yw = D u (+ acc), from
//     which it writes dz (and dacc = dy, at staging); sweep B stages
//     sigmoid(dt + bias) for ddt in their place. Each sweep stages anew
//     (from L2, mostly): the whole tile's operands would take the shared
//     memory of several blocks.
//   - Sweep F, forward in scan order from the saved entry state (the
//     forward's exit state of the chunk before, or zero): x rebuilt, its
//     value at every K-th step kept as a checkpoint in shared memory, and
//     at once the chunk's adjoint aggregate h = sum_s P_s C_s dy_s with the
//     inclusive prefix decay P_s = a_0 ... a_s, and sum delta (the chunk's
//     decay is exp(A sum delta)). h is what the chunk hands the chunk
//     before it for a zero entry: a_0 g_0 unrolls to h + P_last g_in. The
//     gate's output y = C.x is at hand too: sweep F writes dz.
//   - Look-back toward later scan chunks: every thread writes its
//     aggregate record (its 4 states; the channel's sum delta beside), the
//     block raises its flag AGG; one warp polls the flags of 32 successors
//     per load, up to the nearest one with an inclusive record (INCL);
//     each thread folds down from it: g = exp2(A log2(e) sum delta_m) g +
//     h_m, FOLD records' loads at once. The last scan chunk's entry is the
//     seed (dlast for K6, else 0), which also serves a call with one chunk;
//     every inclusive record is this one fold, in this order, from the
//     seed, so wherever a walk stops the adjoint entry has the same bits.
//     The block then writes its inclusive record and raises INCL. Records,
//     flags and the memory order are gated_scan_fwd.cu's: record stores,
//     __threadfence, block barrier, thread 0's relaxed flag store; the
//     polling warp's ld.relaxed.gpu then fence.acq_rel.gpu, a barrier, and
//     records read with ld.global.cg. A poll that waits more than 4 s traps
//     (the launch fails) instead of hanging the card.
//   - Sweep B, group by group from the last, from the adjoint entry: x
//     replayed from the group's checkpoint into registers (K x 4 values a
//     thread), then the walk over the group's steps from the last: g, dp,
//     dA (per thread), du and ddt (the four threads of a channel sum S and
//     ddelta's partials by a reduce-scatter: two shuffles a step), dD and
//     dbias. dB_t and dC_t, sums over the block's channels: a warp
//     reduce-scatter over its 8 channels (the 8 values dB, dC of a thread's
//     4 states: 4 + 2 + 1 shuffles, after which each of the 32 lanes holds
//     one of the warp's 32 sums, the scheme of csrc/scan_flat_fwd.cu's
//     lanes), then across the block's warps in shared memory, in warp
//     order, after the group's barrier (the exchange double-buffered by
//     group); one partial per channel block, which the wrapper adds
//     (adding them in the kernel, by the last block of each chunk to
//     finish, took longer in PR 10's trials).
//   - Exps: three sweeps (sweep F, the replay, the walk). Keeping the
//     replay's decays for the walk takes another K x 4 registers a thread,
//     so two blocks an SM, not three, which cost more than the third exp
//     sweep in PR 10's trials.
// Ragged L and D are masked: a step past L and a channel past D are staged
// as zeros (an identity step: delta 0, dy 0), enter no state or sum, and
// write nothing.
//
// The kernel allocates nothing: the caller passes every output and partial,
// the records agg and incl (R, nc, D, TPC, SPT floats each), sdel (R, nc,
// D floats) and the flags (TICKET_PAD + R ncb nc unsigned ints, zeroed on
// the launch's stream; the first is the ticket); gated_scan_bwd_scratch
// sizes them. At K6's prefill shape (R = 2, L = 2048, D = 5120) the dB/dC
// partials (ncb, R, L, N) are 160 x 2 x 2048 x 16 floats, 42 MB each.
// Where the time goes: tools/scan_bwd_probe.py prints a block's split
// (sweep F, the look-back's wait and fold, sweep B) and the cost of the
// dB/dC reduce-scatter and of the third block an SM (PERF.md §6).
//
// RATIO (K7; K6's flags and operands, the adjoint of gated_scan_fwd.cu's
// RATIO): the same tiles, staging, look-back, reductions and outputs, with
// x and the adjoint in K7's arithmetic, per unit (row, channel, state,
// sub-block of `sub` steps) under the forward's guard. The guard: before
// sweep F the block takes, per (sub-block, channel), the serial sum of
// |delta| in step order from device memory into shared memory (the
// forward's sub_block_bits sums the same values in the same order, so the
// kernels reach the same decision bit for bit); a unit takes the ratio
// form when |A| times it is below MAX_BLOCK_DROP (all units with guarded =
// 0), otherwise the step form. With cum the sub-block's running sum of
// delta, l = A cum, P = exp(l), Pinv = exp(-max(l, -MAX_BLOCK_DROP - 10)):
//   - Sweep F runs the forward's ratio form from the entry state: the
//     running value v = c + sum b Pinv (c = P_end v at a sub-block's end;
//     the step form's v is x), checkpointed with cum every K steps in
//     shared memory; and the adjoint aggregate h = sum_s P_s C_s dy_s with
//     the chunk's prefix decay P_s = (the earlier sub-blocks' P_end) x the
//     step's P, which the ratio form has at hand (the step form's running
//     product of decays as in K6): two exps a (step, state).
//   - Sweep B replays K steps from the checkpoint (v, and x at a
//     sub-block's end: one exp a (step, state)) and walks the adjoint
//     backwards, a ratio unit as JAX's upper-triangular sums (:204-225):
//     gr = P_end g_in at the sub-block's end, gr += P_t dx_t,
//     g_t = Pinv_t gr, and at its start the carry a g with a = P (cum is
//     delta there); a step unit as K6's g = dx + a g. Both forms have
//     dp = g_t (x_{t-1} a_t) = g_t (P_t v_{t-1}) (or a_t x_{t-1}), so the
//     walk takes two exps a (step, state) (P or a, and Pinv).
// Five exps a (step, state) in all against K6's three. Sweep F runs a
// group of K steps whose units (of this thread) all take one form without
// the per-unit selects (Form); sweep B does not: its three copies spilled
// to local memory and ran 1.13x slower on the H100 (PERF.md §6).
// dD and dbias are not formed (the wrapper applies D and bias outside).
//
// PROJ (K8; K3's flags, softplus, u = xc, the adjoint of gated_scan_fwd.cu's
// PROJ): with x_dbl = xc [W_dt | W_B | W_C], xdt its dt columns, dt_raw =
// xdt dt_proj + bias, the gradients of xc and of the weights:
//   dB_s = sum_e g delta xc,  dC_s = sum_e x dy,  dxdt_s = dt_proj ddt_raw_s
//   dxc  = S delta + dy D + dxdt W_dt^T + dB W_B^T + dC W_C^T
//   dW   = xc^T [dxdt | dB | dC],  d dt_proj = xdt^T ddt_raw,
//   dbias = sum ddt_raw, dA, dD as K3's.
// dB, dC and dxdt are sums over every channel and each channel's dxc needs
// them, so one block owns all E <= 128 channels of its chunk (DB = E
// rounded up to 8, four threads a channel: up to 512 threads, one block an
// SM). Before sweep F the block stages x_proj (columns reordered to [B | C |
// dt]) and dt_proj, loads the chunk's xc rows (scan order) into the
// checkpoints' region and projects them once (csrc/proj_tile.cuh; on the
// tensor cores for bf16 xc and x_proj, from a bf16 copy of x_proj in the
// slots, free until sweep F): B, C and xdt of the whole tile stay in shared
// memory for both sweeps (18 KB at T = 128, E = 96, against projecting each
// 8-step group twice). Each sweep
// stages its groups as K3's do, delta = softplus(xdt . dt_proj + bias) from
// the tile's xdt. Sweep B's walk leaves S delta + dy D and ddt_raw per
// (step, channel) in shared memory; after the group's barrier the block
// adds the warps' dB / dC partials in warp order and forms dxdt (a dot over
// the channels), and after another the four threads of a channel form its
// dxc (two steps each) and add the group's terms of dW (a fourth of the
// columns each) and d dt_proj in registers. No (blocks, R, L, N) dB / dC
// buffer and no checkpoint in device memory: a block's weight gradients go
// out once, as one float32 partial per (row, chunk) that the wrapper sums
// with torch.sum (the same bits every run). A thread-block cluster of two
// CTAs of 48 channels (K3's block) adding their channel sums through
// distributed shared memory ran about 1.2x slower on the H100 (PERF.md
// §6). Shared memory (proj_scan_bwd_smem): 171 KiB at E = 96, T = 128,
// dt_rank 3 (bf16 or float32: the xc tile shares the checkpoints'
// region); 223 KiB at E = 128, dt_rank 4; dt_rank <= 6 fits at E = 128, T
// = 128, and E <= 64 at T = 256 (scan_proj.proj_scan_supported sends the
// rest to the directional scan).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NS = 16;            // state size N the kernel is built for
constexpr int TPC = 4;            // threads per channel
constexpr int SPT = NS / TPC;     // states per thread
constexpr int MAX_THREADS = 192;  // threads per block (DB x TPC)
constexpr int MIN_THREADS = 128;
constexpr int K = 8;              // steps of a group: staging, checkpoint,
                                  // replay
constexpr int NA = 5;             // per-channel arrays a slot holds (at most)
constexpr int BC_PER = K * NS / MIN_THREADS;   // B / C entries a thread stages
constexpr int RPT = K / TPC;      // rows of a channel a thread stages
constexpr int FOLD = 8;           // look-back: records loaded at once
constexpr int TICKET_PAD = 32;    // flags[0] is the ticket; flags from [32]
constexpr unsigned FLAG_AGG = 1, FLAG_INCL = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned long long WAIT_LIMIT_NS = 4000000000ull;
constexpr int MIN_BLOCKS = 3;     // the launch bound: blocks an SM
constexpr int NA_RATIO = 3;       // RATIO's slot arrays: delta, u, dy

// Slot arrays (each K x DB floats, after B and C): sweep F's and sweep B's.
constexpr int A_DEL = 0, A_U = 1, A_DY = 2;
constexpr int A_DZF = 3, A_YW = 4;   // sweep F
constexpr int A_SIG = 3;             // sweep B

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
  float* dA_p;           // (R, nc, D, NS)
  float* dD_p;           // (R, nc, D)
  float* dbias_p;        // (R, nc, D)
  float* dB_p;           // (ncb, R, L, NS): the channel blocks' dB
  float* dC_p;           // (ncb, R, L, NS)
  float* agg;            // (R, nc, D, TPC, SPT) scratch: aggregates
  float* incl;           // (R, nc, D, TPC, SPT) scratch: inclusive carries
  float* sdel;           // (R, nc, D) scratch: sums of delta
  unsigned* flags;       // TICKET_PAD + (R, ncb, nc), zeroed
  long long R, L, D;
  int T, nc, DB, ncb;    // steps per chunk, chunks, channels per block, blocks
  unsigned S, P;         // SLICE: slices and positions (L = S P)
  long long su_r, su_l, sdt_r, sdt_l, sz_r, sz_l, sacc_r, sacc_l;
  long long sB_r, sB_l, sC_r, sC_l;
  long long sA_r, sDv_r, sbias_r;
  int sub, guarded, n_valid;    // RATIO: sub-block, guard, real states
  unsigned long long* tally;    // RATIO: (ratio units, step units) or null
  const float* W;        // PROJ: x_proj (D, Rk + 2 NS), float32
  const float* dtp;      // PROJ: dt_proj (Rk, D), float32
  float* part;           // PROJ: (R, nc, (2 Rk + 3 NS + 2) D) partials
  int Rk, ldu;           // PROJ: dt_rank; elements of a staged xc row
  int wmma;              // PROJ: bf16 xc and x_proj, tensor cores
  int nch;               // PROJ: channels of the tile and the weights (16 k)
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

#include "ratio_guard.cuh"   // RATIO's guard and step, shared with the fwd
#include "proj_tile.cuh"     // PROJ's projections, shared with the fwd

constexpr int PROJ_THREADS = PROJ_MAX_CHANNELS * TPC;
constexpr int PROJ_ACC_W = (2 * NS + PROJ_MAX_RANK) / TPC;  // dW columns
constexpr int PROJ_ACC_D = PROJ_MAX_RANK / TPC;   // d dt_proj rows a thread

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

// softplus(x) as gated_scan_fwd.cu computes it (so x is rebuilt from the
// same delta), and sigmoid(x) = softplus'(x), from one exp.
__device__ __forceinline__ float softplus_sig(float x, float& sig) {
  const float e = __expf(-fabsf(x));
  const float r = 1.f / (1.f + e);
  sig = x >= 0.f ? r : e * r;
  const float series = e * (1.f - e * (0.5f - e * (0.33333334f - 0.25f * e)));
  return fmaxf(x, 0.f) + (e < 0.015625f ? series : __logf(1.f + e));
}

// The carry across a chunk: its decay exp(A sum delta) applied to the
// adjoint entry, plus its aggregate. The look-back and a chunk's own
// inclusive record use this one function, so every fold rounds alike.
__device__ __forceinline__ float fold(float g, float a2, float sd, float h) {
  return __fmaf_rn(ex2(a2 * sd), g, h);
}

__device__ __forceinline__ void unpack(const float4& v, float (&a)[SPT]) {
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}

// RATIO: the form of this thread's units over scan steps [i0, i0 + K) of
// a chunk of len steps (past len: identity steps, the step form), from
// the guard sums of the sub-blocks they touch.
__device__ __forceinline__ int group_form(const float* sDabs, int DB, int ch,
                                          int i0, int len, int sub,
                                          const float (&aa)[SPT],
                                          int guarded) {
  const int i1 = min(i0 + K, len);
  unsigned all = i1 < i0 + K ? 0u : (1u << SPT) - 1u, any = 0u;
  for (int sb = i0 / sub; sb * sub < i1; ++sb) {
    const unsigned m = ratio_bits(sDabs[sb * DB + ch], aa, guarded);
    all &= m;
    any |= m;
  }
  return all == (1u << SPT) - 1u ? ALL_RATIO : any == 0u ? ALL_STEP : MIXED;
}

// Original row of scan-order step tt: itself, or with SLICE the step's place
// in the slice-major layout (as in gated_scan_fwd.cu).
template <bool SLICE>
__device__ __forceinline__ long long row_of(const Params& p, long long tt) {
  if (!SLICE) return tt;
  const unsigned t = (unsigned)tt;
  return (long long)(t % p.S) * p.P + t / p.S;
}

// Physical row of scan step i (clamped into the chunk) of the chunk that
// starts at t0 and has len steps.
template <bool REVERSE, bool SLICE>
__device__ __forceinline__ long long phys(const Params& p, long long t0,
                                          int len, int i) {
  const int ic = min(i, len - 1);
  return row_of<SLICE>(p, t0 + (REVERSE ? len - 1 - ic : ic));
}

// One group's operands in flight in registers, as loaded: B and C entries
// tid, tid + nthr of its K x NS, and dt, u, dout, z, acc of channel
// tid % DB at the group's steps tid / DB, + TPC, ... No load is guarded by
// a branch (indices are clamped) and none is converted before the last is
// issued, so the loads overlap.
template <typename S>
struct Staged {
  S b[BC_PER], c[BC_PER], dt[RPT], u[RPT], go[RPT], z[RPT], ac[RPT];
};

// Issue the loads of group j (scan steps j K .. j K + K - 1) of the chunk
// at t0; sweep F (FWD) also loads acc. PROJ loads neither B, C nor dt (the
// tile's projections hold them).
template <typename S, bool FWD, bool REVERSE, bool GATE, bool HAS_ACC,
          bool SLICE, bool PROJ = false>
__device__ __forceinline__ void load_group(const Params& p, long long r,
                                           long long d0, long long t0,
                                           int len, int j, Staged<S>& q) {
  const int tid = threadIdx.x, nthr = blockDim.x, DB = p.DB;
  const S* B = static_cast<const S*>(p.B) + r * p.sB_r;
  const S* C = static_cast<const S*>(p.C) + r * p.sC_r;
#pragma unroll
  for (int e = 0; e < BC_PER; ++e) {
    if (PROJ) break;
    const int i = min(tid + e * nthr, K * NS - 1);
    const long long tt = phys<REVERSE, SLICE>(p, t0, len, j * K + i / NS);
    q.b[e] = B[tt * p.sB_l + i % NS];
    q.c[e] = C[tt * p.sC_l + i % NS];
  }
  const long long d = min(d0 + tid % DB, p.D - 1);
  const S* u = static_cast<const S*>(p.u) + r * p.su_r + d;
  const S* dt = static_cast<const S*>(p.dt) + r * p.sdt_r + d;
  const S* z = static_cast<const S*>(p.z) + r * p.sz_r + d;
  const S* acc = static_cast<const S*>(p.acc) + r * p.sacc_r + d;
  const S* go = static_cast<const S*>(p.dout) + r * p.L * p.D + d;
#pragma unroll
  for (int e = 0; e < RPT; ++e) {
    const long long tt =
        phys<REVERSE, SLICE>(p, t0, len, j * K + tid / DB + e * TPC);
    if (!PROJ) q.dt[e] = dt[tt * p.sdt_l];
    q.u[e] = u[tt * p.su_l];
    q.go[e] = go[tt * p.D];
    if (GATE) q.z[e] = z[tt * p.sz_l];
    if (FWD && GATE && HAS_ACC) q.ac[e] = acc[tt * p.sacc_l];
  }
}

// Write a loaded group into a slot: B, C and the per-channel arrays (sweep
// F: delta, u, dy, dzf, yw; sweep B: delta, u, dy, sigmoid). Steps past the
// chunk and channels past D stage zeros. Sweep F's staging also writes
// dacc = dy. PROJ's slot has no B and C, and its dt_raw comes from the
// tile's xdt rows (sXdt) and dt_proj (sDtp).
template <typename S, bool FWD, bool REVERSE, bool GATE, bool HAS_ACC,
          bool SOFTPLUS, bool SLICE, bool PROJ = false>
__device__ __forceinline__ void store_group(const Params& p, long long r,
                                            long long d0, long long t0,
                                            int len, int j, float bias,
                                            float Dv, const Staged<S>& q,
                                            float* slot,
                                            const float* sXdt = nullptr,
                                            const float* sDtp = nullptr) {
  const int tid = threadIdx.x, nthr = blockDim.x, DB = p.DB;
  float* sB = slot;
  float* sC = sB + K * NS;
  float* arr = PROJ ? slot : sC + K * NS;
#pragma unroll
  for (int e = 0; e < BC_PER; ++e) {
    const int i = tid + e * nthr;
    if (!PROJ && i < K * NS) {
      const bool ok = j * K + i / NS < len;
      sB[i] = ok ? to_f(q.b[e]) : 0.f;
      sC[i] = ok ? to_f(q.c[e]) : 0.f;
    }
  }
  const int k = tid % DB;
  const bool live = d0 + k < p.D;
  S* dacc = static_cast<S*>(p.dacc) + r * p.L * p.D + d0 + k;
  float xr[RPT];   // dt_raw of the thread's rows, before any store
#pragma unroll
  for (int e = 0; e < RPT; ++e)
    xr[e] = PROJ ? proj_dt_raw(sXdt + (j * K + tid / DB + e * TPC) * p.Rk,
                               sDtp, p.nch, p.Rk, (int)d0 + k, bias)
                 : to_f(q.dt[e]) + bias;
#pragma unroll
  for (int e = 0; e < RPT; ++e) {
    const int row = tid / DB + e * TPC;   // step of the group
    const bool ok = live && j * K + row < len;
    const float x = xr[e];
    float sig = 1.f;
    const float delta = SOFTPLUS ? softplus_sig(x, sig) : x;
    const float uu = to_f(q.u[e]);
    const float g = to_f(q.go[e]);
    float dy = g, dzf = 0.f;
    if (GATE) {
      const float zf = to_f(q.z[e]);
      const float sz = 1.f / (1.f + __expf(-zf));
      dy = g * zf * sz;
      dzf = g * sz * (1.f + zf * (1.f - sz));
    }
    float* a = arr + row * DB + k;
    a[A_DEL * K * DB] = ok ? delta : 0.f;
    a[A_U * K * DB] = ok ? uu : 0.f;
    a[A_DY * K * DB] = ok ? dy : 0.f;
    if (FWD && GATE) {
      float yw = Dv * uu;
      if (HAS_ACC) yw += to_f(q.ac[e]);
      a[A_DZF * K * DB] = ok ? dzf : 0.f;
      a[A_YW * K * DB] = ok ? yw : 0.f;
      if (HAS_ACC && ok)
        dacc[phys<REVERSE, SLICE>(p, t0, len, j * K + row) * p.D] =
            from_f<S>(dy);
    }
    if (!FWD && SOFTPLUS) a[A_SIG * K * DB] = ok ? sig : 0.f;
  }
}

// PROJ: a group's sums over the block's channels into sRed (Rk + 2 NS, K:
// a column's K steps 16-byte aligned together), one warp item a step,
// dealt to the warps in turn: its lanes add the warps' reduce-scattered dB |
// dC partials in sX (nw, K, 32) in warp order (a lane an output), and form
// its dxdt = sum_e ddt_raw dt_proj (dt_proj's rows of ldt floats, nvalid
// real channels; the lanes take the channels in turn, PROJ_MAX_RANK / 4
// ranks at once, then shuffle trees add them: the same order every run).
// No barrier.
__device__ __forceinline__ void proj_group_sums(int Rk, int DB, int nvalid,
                                                int nw, const float* sX,
                                                const float* sDdt,
                                                const float* sDtp, int ldt,
                                                float* sRed) {
  constexpr int RB = PROJ_MAX_RANK / 4;   // ranks a pass
  const int ncol = Rk + 2 * NS;
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < K; k += nw) {
    const int o = k * 32 + lane;
    float s = 0.f;
    for (int v = 0; v < nw; ++v) s += sX[v * K * 32 + o];
    // lane l of a warp kept dB (bit 4 clear) or dC of state
    // (l mod 4) SPT + 2 (bit 3) + (bit 2)
    const int n = (lane & 3) * SPT + ((lane >> 3) & 1) * 2 +
                  ((lane >> 2) & 1);
    sRed[(((lane & 16) ? NS : 0) + n) * K + k] = s;
    for (int k0 = 0; k0 < Rk; k0 += RB) {
      float d[RB];
#pragma unroll
      for (int m = 0; m < RB; ++m) d[m] = 0.f;
      for (int e = lane; e < nvalid; e += 32) {
        const float g = sDdt[k * DB + e];
#pragma unroll
        for (int m = 0; m < RB; ++m)
          if (k0 + m < Rk) d[m] = __fmaf_rn(g, sDtp[(k0 + m) * ldt + e], d[m]);
      }
#pragma unroll
      for (int m = 0; m < RB; ++m)
#pragma unroll
        for (int w = 16; w > 0; w >>= 1)
          d[m] += __shfl_xor_sync(0xffffffffu, d[m], w);
#pragma unroll
      for (int m = 0; m < RB; ++m)
        if (lane == 0 && k0 + m < Rk) sRed[(2 * NS + k0 + m) * K + k] = d[m];
    }
  }
}

// Floats of the region that holds the checkpoints, (ngmax - 1, DB, NS);
// PROJ first stages the chunk's xc rows there (ngmax K rows of ldu).
template <typename S>
__host__ __device__ __forceinline__ int ck_floats(int T, int DB, int ldu,
                                                  bool proj) {
  const int ngmax = (T + K - 1) / K;
  const int ck = (ngmax - 1) * DB * NS;
  const int tile = (ngmax * K * ldu * (int)sizeof(S) + 15) / 16 * 4;
  return proj && tile > ck ? tile : ck;
}

template <typename S, bool REVERSE, bool GATE, bool HAS_ACC, bool SOFTPLUS,
          bool SLICE, bool RATIO, bool PROJ>
__device__ __forceinline__ void scan_bwd_body(const Params& p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = p.T, DB = p.DB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int ngmax = (T + K - 1) / K;
  const int slot_len =
      K * ((PROJ ? 0 : 2 * NS) + (RATIO ? NA_RATIO : NA) * DB);
  unsigned* sMisc = reinterpret_cast<unsigned*>(smem);   // ticket, walk
  float* sCk = smem + 4;                     // (ngmax - 1, DB, NS)
  float* sSlot = sCk + ck_floats<S>(T, DB, p.ldu, PROJ);   // two slots
  float* sX = sSlot + 2 * slot_len;   // two (nw, K, 32) exchanges (PROJ: one)
  float* sCum = sX + (PROJ ? 1 : 2) * nw * K * 32;   // RATIO: (ngmax - 1, DB)
  float* sDabs = sCum + (ngmax - 1) * DB;    // RATIO: (T / sub, DB)
  // PROJ, in RATIO's place: the tile's B, C (ngmax K, NS) and xdt (ngmax K,
  // Rk); x_proj transposed (Rk + 2 NS, nch) and dt_proj (Rk, nch); a
  // group's sums dB | dC | dxdt (Rk + 2 NS, K), S delta + dy D and ddt_raw
  // (K, DB)
  const int ncol = p.Rk + 2 * NS;
  float* sBt = sCum;
  float* sCt = sBt + ngmax * K * NS;
  float* sXdt = sCt + ngmax * K * NS;
  float* sWt = sXdt + (ngmax * K * p.Rk + 3) / 4 * 4;
  float* sDtp = sWt + ncol * p.nch;
  float* sRed = sDtp + p.Rk * p.nch;
  float* sPart = sRed + (K * ncol + 3) / 4 * 4;
  float* sDdt = sPart + K * DB;

  if (tid == 0) sMisc[0] = atomicAdd(p.flags, 1u);
  __syncthreads();
  const unsigned ticket = sMisc[0];
  const unsigned per_chunk = (unsigned)(p.R * p.ncb);
  const int w = p.nc - 1 - (int)(ticket / per_chunk);   // scan-order chunk
  const long long r = (ticket % per_chunk) / p.ncb;
  const int cb = (int)((ticket % per_chunk) % p.ncb);
  const long long d0 = (long long)cb * DB;
  const long long t0 = (long long)(REVERSE ? p.nc - 1 - w : w) * T;
  const int len = (int)min((long long)T, p.L - t0);
  const int ng = (len + K - 1) / K;
  const int ch = tid / TPC;        // channel of this thread in the block
  const int qs = tid % TPC;        // its quarter of the states
  const long long d = d0 + ch;
  const bool active = d < p.D;
  const long long dc = active ? d : p.D - 1;

  float a2[SPT], aa[SPT];   // A log2(e); |A| (RATIO's guard)
#pragma unroll
  for (int n = 0; n < SPT; ++n) {
    const float an = p.A[r * p.sA_r + dc * NS + qs * SPT + n];
    a2[n] = an * LOG2E;
    aa[n] = fabsf(an);
  }
  const float Dv = RATIO ? 0.f : p.Dv[r * p.sDv_r + dc];
  // the staging channel's bias and D
  const long long ds = min(d0 + tid % DB, p.D - 1);
  const float bias_s = RATIO ? 0.f : p.bias[r * p.sbias_r + ds];
  const float Dv_s = RATIO ? 0.f : p.Dv[r * p.sDv_r + ds];
  // RATIO: the units' guard sums, per (sub-block, channel), and the states
  // the tally counts
  unsigned valid = 0, units[2] = {0u, 0u};
  if constexpr (RATIO) {
    const float* dtr = static_cast<const float*>(p.dt) + r * p.sdt_r;
    const int nsb = (len + p.sub - 1) / p.sub;
    for (int e = tid; e < nsb * DB; e += blockDim.x) {
      const int sb = e / DB, k = e % DB;
      const float* dtk = dtr + min(d0 + k, p.D - 1) + t0 * p.sdt_l;
      float dabs = 0.f;   // serial, in step order
      for (int t = sb * p.sub; t < min(sb * p.sub + p.sub, len); ++t)
        dabs += fabsf(dtk[t * p.sdt_l]);
      sDabs[e] = dabs;
    }
#pragma unroll
    for (int n = 0; n < SPT; ++n)
      if (active && qs * SPT + n < p.n_valid) valid |= 1u << n;
  }
  // PROJ: the weights, and the chunk's xc rows in scan order (zero past L
  // and past E) in the checkpoints' region, projected once: the tile's B,
  // C and xdt for both sweeps
  if constexpr (PROJ) {
    S* tile = reinterpret_cast<S*>(sCk);
    const S* xc = static_cast<const S*>(p.u) + r * p.su_r;
    const int nt = blockDim.x, nch = p.nch, n = ng * K * nch;
    for (int e0 = tid; e0 < n; e0 += 8 * nt) {   // 8 loads, then 8 stores
      S v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = e0 + j * nt, i = e / nch, k = e % nch;
        v[j] = from_f<S>(0.f);
        if (e < n && i < len && k < p.D)
          v[j] = xc[phys<REVERSE, SLICE>(p, t0, len, i) * p.su_l + k];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = e0 + j * nt;
        if (e < n) tile[e / nch * p.ldu + e % nch] = v[j];
      }
    }
    // the epilogue's float32 weights; the tensor cores' bfloat16 copy in
    // the slots, free until sweep F stages its first group
    proj_stage_weights(p.W, p.dtp, (int)p.D, nch, p.Rk, sWt, true);
    __nv_bfloat16* sWb = reinterpret_cast<__nv_bfloat16*>(sSlot);
    if (p.wmma) proj_stage_wb(p.W, (int)p.D, nch, p.Rk, sWb);
    __syncthreads();
    if constexpr (is_bf16<S>) {
      if (p.wmma)
        project_rows_mma(tile, p.ldu, 0, ng * K, nch, sWb, p.Rk, sBt, sCt,
                         sXdt);
      else
        project_rows<S>(tile, p.ldu, 0, ng * K, nch, sWt, p.Rk, sBt, sCt,
                        sXdt);
    } else {
      project_rows<S>(tile, p.ldu, 0, ng * K, nch, sWt, p.Rk, sBt, sCt,
                      sXdt);
    }
    __syncthreads();   // the tile's projections are out
  }

  // Sweep F: x from the entry state, its checkpoints, the aggregate h and
  // sum delta; dz.
  float x[SPT], P[SPT], h[SPT], sd = 0.f;
  // RATIO: x is the running value v; Pk the chunk's decay before the
  // sub-block; cum, the mask m, and the step's place in its sub-block
  float Pk[SPT], cum = 0.f;
  unsigned m = 0;
  int pos = 0, sb = 0;
#pragma unroll
  for (int n = 0; n < SPT; ++n) {
    x[n] = 0.f;
    P[n] = 1.f;
    h[n] = 0.f;
    Pk[n] = 1.f;
  }
  if (w > 0 && active) {
    const float* st =
        p.states + ((r * p.nc + w - 1) * NS + qs * SPT) * p.D + d;
#pragma unroll
    for (int n = 0; n < SPT; ++n) x[n] = st[n * p.D];
  }

  S* dz = static_cast<S*>(p.dz) + r * p.L * p.D + dc;
  Staged<S> q;
  load_group<S, true, REVERSE, GATE, HAS_ACC, SLICE, PROJ>(p, r, d0, t0, len,
                                                           0, q);
  store_group<S, true, REVERSE, GATE, HAS_ACC, SOFTPLUS, SLICE, PROJ>(
      p, r, d0, t0, len, 0, bias_s, Dv_s, q, sSlot, sXdt, sDtp);
  __syncthreads();
  for (int j = 0; j < ng; ++j) {
    const bool more = j + 1 < ng;
    if (more)
      load_group<S, true, REVERSE, GATE, HAS_ACC, SLICE, PROJ>(
          p, r, d0, t0, len, j + 1, q);
    if (j > 0) {
      *reinterpret_cast<float4*>(sCk + ((j - 1) * DB + ch) * NS +
                                 qs * SPT) = make_float4(x[0], x[1], x[2],
                                                         x[3]);
      if (RATIO && qs == 0) sCum[(j - 1) * DB + ch] = cum;
    }
    const float* slot = sSlot + (j & 1) * slot_len;
    const float* sB = PROJ ? sBt + j * K * NS : slot;
    const float* sC = PROJ ? sCt + j * K * NS : sB + K * NS;
    const float* arr = PROJ ? slot : sC + K * NS;
    float yp[K];   // this thread's part of C.x, per step
    if constexpr (RATIO) {
      auto steps = [&](auto form) __attribute__((always_inline)) {
        constexpr int F = decltype(form)::value;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float* a = arr + k * DB + ch;
          const float delta = a[A_DEL * K * DB];
          const float dy = a[A_DY * K * DB];
          const float du = delta * a[A_U * K * DB];
          float b[SPT], c[SPT];
          unpack(*reinterpret_cast<const float4*>(sB + k * NS + qs * SPT),
                 b);
          unpack(*reinterpret_cast<const float4*>(sC + k * NS + qs * SPT),
                 c);
          sd += delta;
          const int i = j * K + k;
          if (i < len && pos == 0) {   // a sub-block starts
            m = ratio_bits(sDabs[sb * DB + ch], aa, p.guarded);
            units[0] += __popc(m & valid);
            units[1] += __popc(~m & valid);
            cum = 0.f;
          }
          cum += delta;
          const bool end = i < len && (pos == p.sub - 1 || i == len - 1);
          const unsigned mi = i < len ? m : 0u;   // past L: identity steps
#pragma unroll
          for (int n = 0; n < SPT; ++n) {
            const bool rn = is_ratio<F>(mi, n);
            const float l2 = a2[n] * cum;
            const float e = ratio_advance(rn, l2, a2[n], delta, du * b[n],
                                          x[n]);
            const float ep = rn ? ex2(l2) : e;   // P, or the step's decay
            P[n] = rn ? Pk[n] * ep : P[n] * ep;
            h[n] = __fmaf_rn(P[n], c[n] * dy, h[n]);
            if (end) {
              if (rn) x[n] *= ep;   // the carry, P_end v
              Pk[n] = P[n];
            }
          }
          if (i < len && ++pos == p.sub) {
            pos = 0;
            ++sb;
          }
        }
      };
      const int gf = group_form(sDabs, DB, ch, j * K, len, p.sub, aa,
                                p.guarded);
      if (gf == ALL_RATIO)
        steps(Form<ALL_RATIO>{});
      else if (gf == ALL_STEP)
        steps(Form<ALL_STEP>{});
      else
        steps(Form<MIXED>{});
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float* a = arr + k * DB + ch;
        const float delta = a[A_DEL * K * DB];
        const float dy = a[A_DY * K * DB];
        const float du = delta * a[A_U * K * DB];
        float b[SPT], c[SPT];
        unpack(*reinterpret_cast<const float4*>(sB + k * NS + qs * SPT), b);
        unpack(*reinterpret_cast<const float4*>(sC + k * NS + qs * SPT), c);
        sd += delta;
        yp[k] = 0.f;
#pragma unroll
        for (int n = 0; n < SPT; ++n) {
          const float an = ex2(delta * a2[n]);
          x[n] = __fmaf_rn(an, x[n], du * b[n]);
          P[n] *= an;
          h[n] = __fmaf_rn(P[n], c[n] * dy, h[n]);
          yp[k] = __fmaf_rn(c[n], x[n], yp[k]);
        }
      }
    }
    if (GATE) {
      // C.x over the channel's 4 threads, the group's steps at once: a
      // reduce-scatter on lane bits 0 and 1 leaves each thread the sums
      // of steps 4 (bit 0) + 2 (bit 1) + e, e = 0, 1; dz = dzf (C.x + yw)
      const bool b0 = qs & 1, b1 = qs & 2;
      float y4[K / 2], y2[K / 4];
#pragma unroll
      for (int e = 0; e < K / 2; ++e)
        y4[e] = (b0 ? yp[e + K / 2] : yp[e]) +
                __shfl_xor_sync(0xffffffffu, b0 ? yp[e] : yp[e + K / 2], 1);
#pragma unroll
      for (int e = 0; e < K / 4; ++e)
        y2[e] = (b1 ? y4[e + K / 4] : y4[e]) +
                __shfl_xor_sync(0xffffffffu, b1 ? y4[e] : y4[e + K / 4], 2);
#pragma unroll
      for (int e = 0; e < K / 4; ++e) {
        const int k = (b0 ? K / 2 : 0) + (b1 ? K / 4 : 0) + e;
        const int i = j * K + k;
        const float* a = arr + k * DB + ch;
        if (active && i < len)
          dz[phys<REVERSE, SLICE>(p, t0, len, i) * p.D] =
              from_f<S>(a[A_DZF * K * DB] * (y2[e] + a[A_YW * K * DB]));
      }
    }
    if (more)   // group j + 1's slot: nobody reads it yet
      store_group<S, true, REVERSE, GATE, HAS_ACC, SOFTPLUS, SLICE, PROJ>(
          p, r, d0, t0, len, j + 1, bias_s, Dv_s, q,
          sSlot + ((j + 1) & 1) * slot_len, sXdt, sDtp);
    __syncthreads();
  }

  // Look-back: the adjoint entry g of chunk w (the carry a g into its last
  // step). Records are per thread; the flag is the block's.
  float g[SPT];
  const long long rec = (r * p.nc * p.D + dc) * TPC + qs;   // chunk 0's
  const long long rec_m = p.D * TPC;                         // per chunk
  float* sdel = p.sdel + r * p.nc * p.D + dc;                // chunk 0's
  unsigned* flags =   // (row, channel block)'s flag of chunk 0
      p.flags + TICKET_PAD + (r * p.ncb + cb) * p.nc;
  if (w == p.nc - 1) {   // the seed
#pragma unroll
    for (int n = 0; n < SPT; ++n)
      g[n] = p.dlast != nullptr && active
                 ? p.dlast[(r * NS + qs * SPT + n) * p.D + d]
                 : 0.f;
  } else {
    if (active) {
      *reinterpret_cast<float4*>(p.agg + (rec + w * rec_m) * SPT) =
          make_float4(h[0], h[1], h[2], h[3]);
      if (qs == 0) sdel[w * p.D] = sd;
    }
    publish(flags + w, FLAG_AGG);
    // warp 0 walks up to the nearest inclusive record; every chunk between
    // it and w has its aggregate out
    if (warp == 0) {
      int bot = w + 1;
      unsigned long long t_wait = 0;
      for (;;) {
        const int m = bot + lane;
        const unsigned f = m < p.nc ? ld_relaxed(flags + m) : 0u;
        const unsigned not_agg = __ballot_sync(0xffffffffu, f != FLAG_AGG);
        if (not_agg == 0) {   // 32 aggregates: further on
          bot += 32;
          continue;
        }
        const int kk = __ffs(not_agg) - 1;   // the nearest one that is not
        if (__shfl_sync(0xffffffffu, f, kk) == FLAG_INCL) {
          bot += kk;
          break;
        }
        bot += kk;            // wait at the one not out yet
        const unsigned long long now = global_ns();
        if (t_wait == 0) t_wait = now;
        else if (now - t_wait > WAIT_LIMIT_NS) __trap();
        __nanosleep(32);
      }
      fence_acquire();
      if (lane == 0) sMisc[1] = (unsigned)bot;
    }
    __syncthreads();
    const int jj = (int)sMisc[1];
#pragma unroll
    for (int n = 0; n < SPT; ++n) g[n] = 0.f;
    if (active) {
      unpack(__ldcg(reinterpret_cast<const float4*>(
                 p.incl + (rec + jj * rec_m) * SPT)), g);
      for (int m = jj - 1; m > w; m -= FOLD) {   // FOLD records at once
        float4 am[FOLD];
        float sdm[FOLD];
#pragma unroll
        for (int e = 0; e < FOLD; ++e) {   // past w + 1: loaded, not folded
          const int me = max(m - e, w + 1);
          am[e] = __ldcg(reinterpret_cast<const float4*>(
              p.agg + (rec + me * rec_m) * SPT));
          sdm[e] = __ldcg(sdel + me * p.D);
        }
#pragma unroll
        for (int e = 0; e < FOLD; ++e)
          if (m - e > w) {
            float hm[SPT];
            unpack(am[e], hm);
#pragma unroll
            for (int n = 0; n < SPT; ++n)
              g[n] = fold(g[n], a2[n], sdm[e], hm[n]);
          }
      }
    }
  }
  if (w > 0) {   // publish the inclusive carry of w
    if (active) {
      float gi[SPT];
#pragma unroll
      for (int n = 0; n < SPT; ++n) gi[n] = fold(g[n], a2[n], sd, h[n]);
      *reinterpret_cast<float4*>(p.incl + (rec + w * rec_m) * SPT) =
          make_float4(gi[0], gi[1], gi[2], gi[3]);
    }
    publish(flags + w, FLAG_INCL);
  }

  // Sweep B: group by group from the last, replay x, walk g, the gradients.
  float dA[SPT];
#pragma unroll
  for (int n = 0; n < SPT; ++n) dA[n] = 0.f;
  float dDs = 0.f, dbs = 0.f;
  // PROJ: this thread's terms of dW (columns qs + TPC m of the reordered
  // x_dbl) and of d dt_proj (rows qs + TPC m), for channel ch
  float accW[PROJ ? PROJ_ACC_W : 1], accD[PROJ ? PROJ_ACC_D : 1];
#pragma unroll
  for (int m = 0; m < (PROJ ? PROJ_ACC_W : 1); ++m) accW[m] = 0.f;
#pragma unroll
  for (int m = 0; m < (PROJ ? PROJ_ACC_D : 1); ++m) accD[m] = 0.f;
  S* du_o = static_cast<S*>(p.du) + r * p.L * p.D + dc;   // PROJ: dxc
  S* ddt_o = static_cast<S*>(p.ddt) + r * p.L * p.D + dc;
  float* dBp = p.dB_p + ((long long)cb * p.R + r) * p.L * NS;
  float* dCp = p.dC_p + ((long long)cb * p.R + r) * p.L * NS;
  load_group<S, false, REVERSE, GATE, HAS_ACC, SLICE, PROJ>(
      p, r, d0, t0, len, ng - 1, q);
  store_group<S, false, REVERSE, GATE, HAS_ACC, SOFTPLUS, SLICE, PROJ>(
      p, r, d0, t0, len, ng - 1, bias_s, Dv_s, q,
      sSlot + ((ng - 1) & 1) * slot_len, sXdt, sDtp);
  __syncthreads();
  for (int j = ng - 1; j >= 0; --j) {
    if (j > 0)
      load_group<S, false, REVERSE, GATE, HAS_ACC, SLICE, PROJ>(
          p, r, d0, t0, len, j - 1, q);
    const float* slot = sSlot + (j & 1) * slot_len;
    const float* sB = PROJ ? sBt + j * K * NS : slot;
    const float* sC = PROJ ? sCt + j * K * NS : sB + K * NS;
    const float* arr = PROJ ? slot : sC + K * NS;
    float xc[SPT], rc = 0.f;   // the checkpoint (RATIO: and its cum)
    if (j > 0) {
      unpack(*reinterpret_cast<const float4*>(sCk + ((j - 1) * DB + ch) *
                                              NS + qs * SPT), xc);
      if (RATIO) rc = sCum[(j - 1) * DB + ch];
    } else {   // group 0's checkpoint is the entry state
#pragma unroll
      for (int n = 0; n < SPT; ++n)
        xc[n] = w > 0 && active ? p.states[((r * p.nc + w - 1) * NS +
                                            qs * SPT + n) * p.D + d]
                                : 0.f;
    }
    float xs[K][SPT];
    // RATIO: each step's cum, and its guard bits | start 16 | end 32
    float cums[K];
    unsigned fl[K];
    // replay the group from its checkpoint (RATIO: xs holds v, and x at a
    // sub-block's end)
    int rpos = 0, rsb = 0;
    unsigned rm = 0;
    if (RATIO) {
      rpos = j * K % p.sub;
      rsb = j * K / p.sub;
      rm = ratio_bits(sDabs[rsb * DB + ch], aa, p.guarded);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float* a = arr + k * DB + ch;
      const float delta = a[A_DEL * K * DB];
      const float du = delta * a[A_U * K * DB];
      float b[SPT];
      unpack(*reinterpret_cast<const float4*>(sB + k * NS + qs * SPT), b);
      if constexpr (RATIO) {
        const int i = j * K + k;
        const bool start = i < len && rpos == 0;
        if (start) {
          rm = ratio_bits(sDabs[rsb * DB + ch], aa, p.guarded);
          rc = 0.f;
        }
        rc += delta;
        cums[k] = rc;
        const bool end = i < len && (rpos == p.sub - 1 || i == len - 1);
        const unsigned mi = i < len ? rm : 0u;   // past L: identity steps
        fl[k] = mi | (start ? 16u : 0u) | (end ? 32u : 0u);
#pragma unroll
        for (int n = 0; n < SPT; ++n) {
          const bool rn = mi >> n & 1u;
          const float l2 = a2[n] * rc;
          float v = k > 0 ? xs[k - 1][n] : xc[n];
          ratio_advance(rn, l2, a2[n], delta, du * b[n], v);
          if (end && rn) v *= ex2(l2);   // x = P_end v
          xs[k][n] = v;
        }
        if (i < len && ++rpos == p.sub) {
          rpos = 0;
          ++rsb;
        }
        continue;
      }
#pragma unroll
      for (int n = 0; n < SPT; ++n) {
        const float an = ex2(delta * a2[n]);
        xs[k][n] = __fmaf_rn(an, k > 0 ? xs[k - 1][n] : xc[n], du * b[n]);
      }
    }
    float* xch = sX + ((PROJ ? 0 : j & 1) * nw + warp) * K * 32;
    // the walk, last step first
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      const float* a = arr + k * DB + ch;
      const float delta = a[A_DEL * K * DB];
      const float uu = a[A_U * K * DB];
      const float dy = a[A_DY * K * DB];
      const float du = delta * uu;
      float b[SPT], c[SPT], vB[SPT], vC[SPT];
      unpack(*reinterpret_cast<const float4*>(sB + k * NS + qs * SPT), b);
      unpack(*reinterpret_cast<const float4*>(sC + k * NS + qs * SPT), c);
      float Sp = 0.f, ddp = 0.f;
#pragma unroll
      for (int n = 0; n < SPT; ++n) {
        const float prev = k > 0 ? xs[k - 1][n] : xc[n];
        float gn, dp, xt;
        if constexpr (RATIO) {
          const bool rn = fl[k] >> n & 1u;
          const bool at_start = fl[k] & 16u, at_end = fl[k] & 32u;
          const float l2 = a2[n] * cums[k];
          const float e1 = ex2(rn ? l2 : delta * a2[n]);   // P, or a
          const float e2 = ex2(-fmaxf(l2, PINV_FLOOR2));    // Pinv
          // ratio: gr = P_end g_in at the end, + P dx; g = Pinv gr
          const float grs = rn && at_end ? e1 * g[n] : g[n];
          const float gsum = __fmaf_rn(rn ? e1 : 1.f, c[n] * dy, grs);
          gn = rn ? e2 * gsum : gsum;
          dp = gn * (e1 * prev);   // x_{t-1} a_t = P_t v_{t-1}
          xt = rn && !at_end ? e1 * xs[k][n] : xs[k][n];
          g[n] = rn && !at_start ? gsum : e1 * gn;
        } else {
          const float an = ex2(delta * a2[n]);
          gn = __fmaf_rn(c[n], dy, g[n]);
          dp = gn * (an * prev);
          xt = xs[k][n];
          g[n] = an * gn;
        }
        dA[n] = __fmaf_rn(dp, delta, dA[n]);
        ddp = __fmaf_rn(dp, a2[n], ddp);
        Sp = __fmaf_rn(gn, b[n], Sp);
        vB[n] = gn * du;
        vC[n] = xt * dy;
      }
      ddp = __fmaf_rn(Sp, uu, ddp * LN2);
      // S (quarters 0, 2) and ddelta (1, 3) over the channel's 4 threads
      const bool odd = qs & 1;
      float sum = (odd ? ddp : Sp) +
                  __shfl_xor_sync(0xffffffffu, odd ? Sp : ddp, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int i = j * K + k;
      if (PROJ && qs < 2) {   // the epilogue's per (step, channel) terms
        const bool ok = active && i < len;
        if (qs == 0) {
          sPart[k * DB + ch] = ok ? __fmaf_rn(sum, delta, dy * Dv) : 0.f;
          if (ok) dDs = __fmaf_rn(dy, uu, dDs);
        } else {
          const float ddt_v = ok ? sum * a[A_SIG * K * DB] : 0.f;
          sDdt[k * DB + ch] = ddt_v;
          dbs += ddt_v;
        }
      } else if (active && i < len && qs < 2) {
        const long long tt = phys<REVERSE, SLICE>(p, t0, len, i) * p.D;
        if (qs == 0) {
          du_o[tt] = from_f<S>(__fmaf_rn(sum, delta, dy * Dv));
          dDs = __fmaf_rn(dy, uu, dDs);
        } else {
          const float ddt_v = SOFTPLUS ? sum * a[A_SIG * K * DB] : sum;
          ddt_o[tt] = from_f<S>(ddt_v);
          dbs += ddt_v;
        }
      }
      // dB, dC over the warp's 8 channels: reduce-scatter on lane bits
      // 4, 3, 2; lane keeps dB (bit 4 clear) or dC, then half the states
      const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
      float s4[SPT];
#pragma unroll
      for (int n = 0; n < SPT; ++n)
        s4[n] = (h16 ? vC[n] : vB[n]) +
                __shfl_xor_sync(0xffffffffu, h16 ? vB[n] : vC[n], 16);
      float s2[2];
#pragma unroll
      for (int n = 0; n < 2; ++n)
        s2[n] = (h8 ? s4[n + 2] : s4[n]) +
                __shfl_xor_sync(0xffffffffu, h8 ? s4[n] : s4[n + 2], 8);
      xch[k * 32 + lane] = (h4 ? s2[1] : s2[0]) +
                           __shfl_xor_sync(0xffffffffu, h4 ? s2[0] : s2[1], 4);
    }
    if (j > 0)   // group j - 1's slot: nobody reads it yet
      store_group<S, false, REVERSE, GATE, HAS_ACC, SOFTPLUS, SLICE, PROJ>(
          p, r, d0, t0, len, j - 1, bias_s, Dv_s, q,
          sSlot + ((j - 1) & 1) * slot_len, sXdt, sDtp);
    __syncthreads();
    if constexpr (PROJ) {
      proj_group_sums(p.Rk, DB, (int)p.D, nw, sX, sDdt, sDtp, p.nch, sRed);
      __syncthreads();
      // dxc of steps qs and qs + TPC; the group's terms of dW and d dt_proj
      const float* xg = slot + A_U * K * DB;   // the group's xc, (K, DB)
      static_assert(K == 2 * TPC && K == 8,
                    "a thread: the dxc of two steps, dW terms of 8");
      float v0 = sPart[qs * DB + ch], v1 = sPart[(qs + TPC) * DB + ch];
      const float* wt = sWt + ch;   // the channel's x_proj row
#pragma unroll 4
      for (int c = 0; c < ncol; ++c) {
        const float wc = wt[c * p.nch];
        v0 = __fmaf_rn(sRed[c * K + qs], wc, v0);
        v1 = __fmaf_rn(sRed[c * K + qs + TPC], wc, v1);
      }
      if (active && j * K + qs < len)
        du_o[phys<REVERSE, SLICE>(p, t0, len, j * K + qs) * p.D] =
            from_f<S>(v0);
      if (active && j * K + qs + TPC < len)
        du_o[phys<REVERSE, SLICE>(p, t0, len, j * K + qs + TPC) * p.D] =
            from_f<S>(v1);
      float xk[K];   // the channel's xc at the group's steps
#pragma unroll
      for (int k = 0; k < K; ++k) xk[k] = xg[k * DB + ch];
#pragma unroll
      for (int m = 0; m < PROJ_ACC_W; ++m)
        if (qs + TPC * m < ncol) {
          const float4* rc =
              reinterpret_cast<const float4*>(sRed + (qs + TPC * m) * K);
          const float4 r0 = rc[0], r1 = rc[1];
          accW[m] = __fmaf_rn(xk[0], r0.x, accW[m]);
          accW[m] = __fmaf_rn(xk[1], r0.y, accW[m]);
          accW[m] = __fmaf_rn(xk[2], r0.z, accW[m]);
          accW[m] = __fmaf_rn(xk[3], r0.w, accW[m]);
          accW[m] = __fmaf_rn(xk[4], r1.x, accW[m]);
          accW[m] = __fmaf_rn(xk[5], r1.y, accW[m]);
          accW[m] = __fmaf_rn(xk[6], r1.z, accW[m]);
          accW[m] = __fmaf_rn(xk[7], r1.w, accW[m]);
        }
#pragma unroll
      for (int m = 0; m < PROJ_ACC_D; ++m)
        if (qs + TPC * m < p.Rk) {
          const int kk = qs + TPC * m;
#pragma unroll
          for (int k = 0; k < K; ++k)
            accD[m] = __fmaf_rn(sXdt[(j * K + k) * p.Rk + kk],
                                sDdt[k * DB + ch], accD[m]);
        }
      __syncthreads();   // the exchange and the group's sums are free
      continue;
    }
    // the block's dB, dC of the group's steps: the warps' sums in order
    const float* xj = sX + (j & 1) * nw * K * 32;
    for (int e = tid; e < K * 32; e += blockDim.x) {
      const int k = e >> 5, l = e & 31;
      const int i = j * K + k;
      if (i < len) {
        float s = 0.f;
        for (int v = 0; v < nw; ++v) s += xj[v * K * 32 + e];
        // lane l of a warp kept dB (bit 4 clear) or dC of state
        // (l mod 4) SPT + 2 (bit 3) + (bit 2)
        const int n = (l & 3) * SPT + ((l >> 3) & 1) * 2 + ((l >> 2) & 1);
        ((l & 16) ? dCp : dBp)[phys<REVERSE, SLICE>(p, t0, len, i) * NS +
                               n] = s;
      }
    }
  }

  if constexpr (PROJ) {   // the block's partials, (2 Rk + 3 NS + 2, D)
    if (active) {
      float* pb = p.part + (r * p.nc + w) * (2 * p.Rk + 3 * NS + 2) * p.D + d;
#pragma unroll
      for (int m = 0; m < PROJ_ACC_W; ++m)   // dW^T in x_proj's column order
        if (qs + TPC * m < ncol)
          pb[proj_col_in(qs + TPC * m, p.Rk) * p.D] = accW[m];
#pragma unroll
      for (int m = 0; m < PROJ_ACC_D; ++m)   // d dt_proj
        if (qs + TPC * m < p.Rk) pb[(ncol + qs + TPC * m) * p.D] = accD[m];
#pragma unroll
      for (int n = 0; n < SPT; ++n)   // dA^T
        pb[(ncol + p.Rk + qs * SPT + n) * p.D] = dA[n];
      if (qs == 1) pb[(ncol + p.Rk + NS) * p.D] = dbs;
      if (qs == 0) pb[(ncol + p.Rk + NS + 1) * p.D] = dDs;
    }
    return;
  }
  if (active) {
    *reinterpret_cast<float4*>(p.dA_p + ((r * p.nc + w) * p.D + d) * NS +
                               qs * SPT) =
        make_float4(dA[0], dA[1], dA[2], dA[3]);
    if (!RATIO && qs == 0) p.dD_p[(r * p.nc + w) * p.D + d] = dDs;
    if (!RATIO && qs == 1) p.dbias_p[(r * p.nc + w) * p.D + d] = dbs;
  }
  if (RATIO && p.tally != nullptr) tally_add(p.tally, units);
}

template <typename S, bool REVERSE, bool GATE, bool HAS_ACC, bool SOFTPLUS,
          bool SLICE>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
    scan_bwd_kernel(Params p) {
  scan_bwd_body<S, REVERSE, GATE, HAS_ACC, SOFTPLUS, SLICE, false, false>(p);
}

// K7: K6's instance (float32, forward, ungated, no acc, delta as given) in
// the ratio form.
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
    mxu_bwd_kernel(Params p) {
  scan_bwd_body<float, false, false, false, false, false, true, false>(p);
}

// K8: K3's instances through the projections, one block a chunk and an SM:
// MAXT 384 threads (E <= 96, up to 168 registers; 5% faster at stage 0 on
// the H100 than the 512-thread bound's 128, `tools/proj_ab.py --ablate`)
// or PROJ_THREADS (E <= 128).
template <typename S, bool REVERSE, bool GATE, bool HAS_ACC, int MAXT>
__global__ void __launch_bounds__(MAXT, 1) proj_bwd_kernel(Params p) {
  scan_bwd_body<S, REVERSE, GATE, HAS_ACC, true, false, false, true>(p);
}

// Shared memory of a block; RATIO (sub-block `sub`) has three slot arrays,
// the checkpoints' cum and the guard sums.
size_t smem_bytes(int T, int DB, bool ratio, int sub) {
  const size_t ngmax = (T + K - 1) / K, nw = DB * TPC / 32;
  size_t floats = (ngmax - 1) * DB * NS +
                  2 * (size_t)K * (2 * NS + (ratio ? NA_RATIO : NA) * DB) +
                  2 * nw * K * 32;
  if (ratio) floats += (ngmax - 1) * DB + (size_t)(T / sub) * DB;
  return 16 + floats * sizeof(float);
}

// Shared memory of a PROJ block of DB channels (the carve of
// scan_bwd_body), nch channels of the tile and the weights.
template <typename S>
size_t proj_smem_bytes(int T, int DB, int nch, int Rk) {
  const size_t ngmax = (T + K - 1) / K, nw = DB * TPC / 32;
  const size_t ncol = Rk + 2 * NS;
  const size_t floats =
      ck_floats<S>(T, DB, nch + 4, true) + 2 * (size_t)K * NA * DB +
      nw * K * 32 + 2 * ngmax * K * NS + (ngmax * K * Rk + 3) / 4 * 4 +
      (ncol + Rk) * nch + (K * ncol + 3) / 4 * 4 + 2 * (size_t)K * DB;
  return 16 + floats * sizeof(float);
}

cudaError_t launch_kernel(void (*kernel)(Params), const Params& p,
                          size_t smem, cudaStream_t stream) {
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
  return launch_kernel(
      scan_bwd_kernel<S, REVERSE, GATE, HAS_ACC, SOFTPLUS, SLICE>, p,
      smem_bytes(p.T, p.DB, false, 1), stream);
}

template <typename S, bool REVERSE, int MAXT>
cudaError_t launch_proj(const Params& p, bool gate, bool has_acc,
                        cudaStream_t stream) {
  const size_t smem = proj_smem_bytes<S>(p.T, p.DB, p.nch, p.Rk);
  if (gate && has_acc)
    return launch_kernel(proj_bwd_kernel<S, REVERSE, true, true, MAXT>, p,
                         smem, stream);
  if (gate)
    return launch_kernel(proj_bwd_kernel<S, REVERSE, true, false, MAXT>, p,
                         smem, stream);
  return launch_kernel(proj_bwd_kernel<S, REVERSE, false, false, MAXT>, p,
                       smem, stream);
}

template <typename S, bool REVERSE>
cudaError_t launch_proj(const Params& p, bool gate, bool has_acc,
                        cudaStream_t stream) {
  if (p.DB * TPC <= 384)
    return launch_proj<S, REVERSE, 384>(p, gate, has_acc, stream);
  return launch_proj<S, REVERSE, PROJ_THREADS>(p, gate, has_acc, stream);
}

// acc enters the backward only through the gate (dz's ytot): an ungated
// link with acc runs the ungated instance, the wrapper sets its dacc.
template <typename S, bool REVERSE, bool SOFTPLUS, bool SLICE>
cudaError_t launch_flags(const Params& p, bool gate, bool has_acc,
                         cudaStream_t stream) {
  if constexpr (!SOFTPLUS)   // K6: ungated, no acc
    return launch_one<S, REVERSE, false, false, false, false>(p, stream);
  if (gate && has_acc)
    return launch_one<S, REVERSE, true, true, true, SLICE>(p, stream);
  if (gate)   // K5's own flags with SLICE
    return launch_one<S, REVERSE, true, false, true, SLICE>(p, stream);
  return launch_one<S, REVERSE, false, false, true, SLICE>(p, stream);
}

// K8's channels of the staged tile (E rounded up to 16, whole m16 tiles).
int proj_tile_channels(long long E) { return (int)(E + 15) / 16 * 16; }

}  // namespace

extern "C" {

// strides: u_r, u_l, dt_r, dt_l, z_r, z_l, acc_r, acc_l, B_r, B_l, C_r, C_l,
//          A_r, Dv_r, bias_r (elements; host array of 15), as gated_scan_fwd.
// dlast (R, N, D) float32 or null seeds the adjoint of the last state in
// scan order. softplus = 0 is K6's mode: float32, no reverse, no gate, no
// acc. nslices > 0 is K5's mode (SLICE, nslices | L): forward, gate and
// acc as for K1. channels: channels per block (DB: 32, 40 or 48). du,
// ddt, dz, dacc (R, L, D) contiguous in the storage dtype; float32
// partials dA_p (R, nc, D, N), dD_p and dbias_p (R, nc, D) per chunk, dB_p
// and dC_p (ceil(D / channels), R, L, N) per channel block; agg, incl,
// sdel and flags (zeroed) as gated_scan_bwd_scratch sizes them; states
// required when L > T. Returns a cudaError_t value (0 = launched).
int gated_scan_bwd(const void* u, const void* dt, const void* z,
                   const void* acc, const void* B, const void* C,
                   const void* dout, const float* A, const float* Dv,
                   const float* bias, const float* states,
                   const float* dlast, void* du, void* ddt, void* dz,
                   void* dacc, float* dA_p, float* dD_p, float* dbias_p,
                   float* dB_p, float* dC_p, float* agg, float* incl,
                   float* sdel, unsigned* flags, int is_bf16, int reverse,
                   int gate, int has_acc, int softplus, long long nslices,
                   long long R, long long L, long long D, int N, int T,
                   int channels, const long long* strides, void* stream) {
  if (N != NS || T < 1 || T > 256 || channels % 8 != 0 ||
      channels * TPC < MIN_THREADS || channels * TPC > MAX_THREADS ||
      R < 1 || L < 1 || D < 1 || L > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!softplus && (is_bf16 || reverse || gate || has_acc || nslices))
    return (int)cudaErrorInvalidValue;
  if (nslices && (nslices < 1 || L % nslices || reverse))
    return (int)cudaErrorInvalidValue;
  const long long nc = (L + T - 1) / T;
  const long long ncb = (D + channels - 1) / channels;
  if (R * ncb * nc > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if ((nc > 1 && states == nullptr) || agg == nullptr || incl == nullptr ||
      sdel == nullptr || flags == nullptr || dA_p == nullptr ||
      dD_p == nullptr || dbias_p == nullptr || dB_p == nullptr ||
      dC_p == nullptr || (gate && (z == nullptr || dz == nullptr)) ||
      (gate && has_acc && (acc == nullptr || dacc == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T, channels, false, 1);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  Params p{};
  p.u = u; p.dt = dt; p.z = z; p.acc = acc; p.B = B; p.C = C; p.dout = dout;
  p.A = A; p.Dv = Dv; p.bias = bias; p.states = states; p.dlast = dlast;
  p.du = du; p.ddt = ddt; p.dz = dz; p.dacc = dacc;
  p.dA_p = dA_p; p.dD_p = dD_p; p.dbias_p = dbias_p; p.dB_p = dB_p;
  p.dC_p = dC_p; p.agg = agg; p.incl = incl; p.sdel = sdel; p.flags = flags;
  p.R = R; p.L = L; p.D = D; p.T = T; p.nc = (int)nc;
  p.DB = channels; p.ncb = (int)ncb;
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

// K7 (RATIO): the adjoint of mxu_scan_fwd. float32 u, delta, B, C with
// strides u_r, u_l, delta_r, delta_l, B_r, B_l, C_r, C_l, A_r (elements;
// host array of 9); A (R|1, D, 16); dy (R, L, D) contiguous; states (R,
// nc, 16, D) the forward's chunk exit states (required when L > T); dlast
// (R, 16, D) or null seeds the adjoint of the last state. du, ddelta (R, L,
// D) contiguous; float32 partials dA_p (R, nc, D, 16) per chunk, dB_p and
// dC_p (ceil(D / channels), R, L, 16) per channel block; agg, incl, sdel
// and flags (zeroed) as gated_scan_bwd_scratch sizes them. sub, guarded,
// tally and n_valid as mxu_scan_fwd. Returns a cudaError_t value.
int mxu_scan_bwd(const float* u, const float* dt, const float* A,
                 const float* B, const float* C, const float* dy,
                 const float* states, const float* dlast, float* du,
                 float* ddt, float* dA_p, float* dB_p, float* dC_p,
                 float* agg, float* incl, float* sdel, unsigned* flags,
                 unsigned long long* tally, long long R, long long L,
                 long long D, int T, int sub, int guarded, int n_valid,
                 int channels, const long long* strides, void* stream) {
  if (T < 1 || T > 256 || sub < 1 || T % sub != 0 || channels % 8 != 0 ||
      channels * TPC < MIN_THREADS || channels * TPC > MAX_THREADS ||
      R < 1 || L < 1 || D < 1 || L > 0x7fffffffLL || n_valid < 1 ||
      n_valid > NS)
    return (int)cudaErrorInvalidValue;
  const long long nc = (L + T - 1) / T;
  const long long ncb = (D + channels - 1) / channels;
  if (R * ncb * nc > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if ((nc > 1 && states == nullptr) || agg == nullptr || incl == nullptr ||
      sdel == nullptr || flags == nullptr || dA_p == nullptr ||
      dB_p == nullptr || dC_p == nullptr || du == nullptr || ddt == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T, channels, true, sub);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  Params p{};
  p.u = u; p.dt = dt; p.B = B; p.C = C; p.dout = dy;
  p.A = A; p.states = states; p.dlast = dlast;
  p.du = du; p.ddt = ddt; p.dA_p = dA_p; p.dB_p = dB_p; p.dC_p = dC_p;
  p.agg = agg; p.incl = incl; p.sdel = sdel; p.flags = flags;
  p.tally = tally;
  p.R = R; p.L = L; p.D = D; p.T = T; p.nc = (int)nc;
  p.DB = channels; p.ncb = (int)ncb;
  p.S = 1u;
  p.P = (unsigned)L;
  p.sub = sub; p.guarded = guarded != 0; p.n_valid = n_valid;
  p.su_r = strides[0]; p.su_l = strides[1];
  p.sdt_r = strides[2]; p.sdt_l = strides[3];
  p.sB_r = strides[4]; p.sB_l = strides[5];
  p.sC_r = strides[6]; p.sC_l = strides[7];
  p.sA_r = strides[8];
  return (int)launch_kernel(mxu_bwd_kernel, p, smem,
                            static_cast<cudaStream_t>(stream));
}

// K8's channels a block: E rounded up to 8 (whole warps of 8 channels), at
// least 32 (the template's 128 threads).
int proj_scan_bwd_channels(int E) {
  const int c = (E + 7) / 8 * 8;
  return c < 32 ? 32 : c;
}

// K8's shared memory a block in bytes (proj_scan_bwd takes at most
// 232448, an H100 block's limit); scan_proj.py mirrors it.
long long proj_scan_bwd_smem(long long E, int Rk, int T, int is_bf16) {
  const int DB = proj_scan_bwd_channels((int)E), nch = proj_tile_channels(E);
  return (long long)(is_bf16 ? proj_smem_bytes<__nv_bfloat16>(T, DB, nch, Rk)
                             : proj_smem_bytes<float>(T, DB, nch, Rk));
}

// K8 (PROJ): the adjoint of proj_scan_fwd. xc (R, L, E) with strides xc_r,
// xc_l, z_r, z_l, acc_r, acc_l (elements; host array of 6); dout (R, L, E)
// contiguous; W, dtp, bias, A, D as proj_scan_fwd; states (R, nc, N, E) the
// forward's chunk exit states (required when L > T). dxc, dz, dacc (R, L,
// E) contiguous in the storage dtype (dz with the gate, dacc with the gate
// and acc); part (R, nc, (2 Rk + 3 N + 2) E) float32 partials per (row,
// chunk): dW^T (Rk + 2 N, E) in x_proj's column order | d dt_proj (Rk, E) |
// dA^T (N, E) | dbias (E) | dD (E); agg, incl, sdel and flags (zeroed) as
// gated_scan_bwd_scratch sizes them for proj_scan_bwd_channels(E) channels.
// E <= 128, 1 <= Rk <= 16, proj_scan_bwd_smem <= 232448 (at T = 128: Rk
// <= 6 at E = 128; at T = 256: E <= 64). wmma (with is_bf16): W holds
// bfloat16 values, and the projections run on the tensor cores where E
// rounded up to 8 is a multiple of 16. Returns a cudaError_t value.
int proj_scan_bwd(const void* xc, const void* z, const void* acc,
                  const void* dout, const float* W, const float* dtp,
                  const float* bias, const float* A, const float* Dv,
                  const float* states, void* dxc, void* dz, void* dacc,
                  float* part, float* agg, float* incl, float* sdel,
                  unsigned* flags, int is_bf16, int wmma, int reverse,
                  int gate, int has_acc, long long R, long long L,
                  long long E, int Rk, int T, const long long* strides,
                  void* stream) {
  if (T < 1 || T > 256 || E < 1 || E > PROJ_MAX_CHANNELS || Rk < 1 ||
      Rk > PROJ_MAX_RANK || R < 1 || L < 1 || L > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long nc = (L + T - 1) / T;
  if (R * nc > 0x7fffffffLL || (nc > 1 && states == nullptr) ||
      xc == nullptr || dout == nullptr || W == nullptr || dtp == nullptr ||
      dxc == nullptr || part == nullptr || agg == nullptr ||
      incl == nullptr || sdel == nullptr || flags == nullptr ||
      (gate && (z == nullptr || dz == nullptr)) ||
      (gate && has_acc && (acc == nullptr || dacc == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.u = xc; p.z = z; p.acc = acc; p.dout = dout; p.A = A; p.Dv = Dv;
  p.bias = bias; p.states = states; p.du = dxc; p.dz = dz; p.dacc = dacc;
  p.part = part; p.agg = agg; p.incl = incl; p.sdel = sdel; p.flags = flags;
  p.W = W; p.dtp = dtp; p.Rk = Rk;
  p.R = R; p.L = L; p.D = E; p.T = T; p.nc = (int)nc;
  p.DB = proj_scan_bwd_channels((int)E);
  p.ncb = 1;
  p.nch = proj_tile_channels(E);
  p.ldu = p.nch + 4;   // = 4 mod 8: conflict-free row-per-lane loads
  p.wmma = is_bf16 && wmma;
  p.S = 1u;
  p.P = (unsigned)L;
  p.su_r = strides[0]; p.su_l = strides[1];
  p.sz_r = strides[2]; p.sz_l = strides[3];
  p.sacc_r = strides[4]; p.sacc_l = strides[5];
  if (proj_scan_bwd_smem(E, Rk, T, is_bf16) > 232448)
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

// Scratch sizes in elements for channels per block DB: agg and incl
// (floats each), sdel (floats), flags (unsigned ints, to be zeroed).
void gated_scan_bwd_scratch(long long R, long long L, long long D, int T,
                            int channels, long long* sizes) {
  const long long nc = (L + T - 1) / T;
  sizes[0] = R * nc * D * NS;
  sizes[1] = R * nc * D;
  sizes[2] = TICKET_PAD + R * ((D + channels - 1) / channels) * nc;
}

const char* gated_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
