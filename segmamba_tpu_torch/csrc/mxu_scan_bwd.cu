// Matrix-unit selective scan (K7), backward, for Hopper (sm_90a): the
// ratio-form sub-block adjoint with the forward's per-unit guard.
//
// Replaces the Pallas TPU kernel
//   K7  segmamba_tpu/ops/scan_pallas_mxu.py:165  _bwd_kernel (pallas_call
//       :284), driven by _bwd_call_mxu :275 and the custom VJP of
//       _make_core :335.
// It is the adjoint of csrc/mxu_scan_fwd.cu and reads that kernel's chunk
// exit states (R, nc, N, D). The same function as K6's backward: per row r,
// channel d, state n (N = 16 per launch) and step t, float32,
//   a_t  = exp(delta_t A),  x_t = a_t x_{t-1} + delta_t B_t u_t
//   g_t  = C_t dy_t + a_{t+1} g_{t+1}      (the adjoint; beyond the last
//                                           step it is dlast, or 0)
//   dp   = g_t x_{t-1} a_t;  Ssum = sum_n g B
//   du   = Ssum delta;  ddelta = sum_n dp A + Ssum u
//   dA   = sum_t dp delta;  dB_t = sum_d g delta u;  dC_t = sum_d x dy
// computed in K7's arithmetic, per sub-block of S steps, unit by unit under
// the forward's guard (drop = |A| sum |delta| over the sub-block, the same
// serial sum, so the same decision bit for bit):
// - x is recomputed in the forward's ratio form (P, Pinv, the running
//   c + sum b Pinv) or step form;
// - the adjoint of a ratio unit takes the ratio form with upper-triangular
//   in-sub-block sums, g_t = Pinv_t (sum_{s >= t} P_s dx_s + P_end g_in),
//   and the product-form chain backwards across sub-blocks,
//   g_in <- a_start g_start, with a recomputed as exp(delta A) at the
//   sub-block start (JAX :197-202, :209-225); a step unit walks
//   g_t = dx_t + a_{t+1} g_{t+1}.
//
// What bounds it on this card: as the forward, the SFU's exps (three per
// (step, state) in the ratio form's gradient pass, two more to recompute
// x) and then the bytes of the sequence operands; the triangular products
// of the TPU kernel are running sums in float32 on the CUDA cores. The TPU
// kernel walks the chunks serially; here they run in parallel, as in K3/K6
// (csrc/gated_scan_bwd.cu), as kernels named mxu_<pass>_kernel:
//   1. bwd_chunk:  one thread per (row, chunk, channel) runs the adjoint
//                  over its chunk from a zero entry (needs delta, C and dy,
//                  not x) and writes the adjoint leaving the chunk and the
//                  chunk's sum of delta (its decay is exp(A sum delta)).
//   2. bwd_carry:  one thread per (row, state, channel) combines the chunk
//                  summaries from the last chunk, seeded by dlast (or 0),
//                  and leaves each chunk's entering adjoint in place.
//   3. bwd_grad:   one block per (channel block, chunk, row) recomputes x
//                  from the chunk's entry state (the previous chunk's exit;
//                  chunk 0 enters at zero), checkpointing the running state
//                  every SUB steps (global scratch, its own addresses);
//                  then, unit of SUB steps by unit from the last, replays
//                  SUB steps into shared memory and walks g backwards
//                  through them, forming every gradient. dB and dC (sums
//                  over channels) are taken in shared memory, one partial
//                  per channel block; dA is one partial per chunk.
// The partials are summed by the wrapper with torch.sum: no atomics, so
// every run gives the same bits. A ragged L stops at the last real step.
// The optional tally (as the forward's) counts the units of pass 3.
// The kernel allocates nothing: the caller passes every buffer.

#include <cuda_runtime.h>

namespace {

constexpr int NS = 16;   // states per launch
constexpr int SUB = 8;   // steps per replayed unit in pass 3
constexpr int CARRY_THREADS = 256;
constexpr float MAX_BLOCK_DROP = 75.f;
constexpr float PINV_FLOOR = -(MAX_BLOCK_DROP + 10.f);

struct Params {
  const float* u;
  const float* dt;       // delta (final)
  const float* A;        // (R|1, D, NS)
  const float* B;
  const float* C;
  const float* dy;       // (R, L, D) contiguous
  const float* states;   // (R, nc, NS, D), the forward's chunk exit states
  const float* dlast;    // (R, NS, D) adjoint seed of the last state, or null
  float* du;             // (R, L, D) contiguous
  float* ddt;            // (R, L, D) contiguous
  float* dA_p;           // (R, nc, NS, D)
  float* dB_p;           // (nbd, R, L, NS)
  float* dC_p;           // (nbd, R, L, NS)
  float* gbuf;           // (R, nc, NS, D) scratch (nc > 1)
  float* sdelta;         // (R, nc, D) scratch (nc > 1)
  float* ckpt;           // (R, nc, nsub, NS, D) scratch
  unsigned long long* tally;
  long long R, L, D;
  int T, S, nc, nsub, guarded, n_valid;
  long long su_r, su_l, sdt_r, sdt_l, sB_r, sB_l, sC_r, sC_l, sA_r;
};

template <bool WITH_B>
__device__ __forceinline__ void stage_bc(const Params& p, long long r,
                                         long long t0, int len, float* sB,
                                         float* sC) {
  const float* B = p.B + r * p.sB_r;
  const float* C = p.C + r * p.sC_r;
  for (int i = threadIdx.x; i < len * NS; i += blockDim.x) {
    const long long t = t0 + i / NS;
    const int n = i % NS;
    if (WITH_B) sB[i] = B[t * p.sB_l + n];
    sC[i] = C[t * p.sC_l + n];
  }
  __syncthreads();
}

// As in mxu_scan_fwd.cu: bit n set when unit n takes the ratio form.
__device__ __forceinline__ unsigned ratio_mask(const float* A, float dabs,
                                               int guarded) {
  unsigned m = 0;
#pragma unroll
  for (int n = 0; n < NS; ++n)
    if (!guarded || fabsf(A[n]) * dabs < MAX_BLOCK_DROP) m |= 1u << n;
  return m;
}

// Serial sums over steps [tb, te) of one channel, in the forward's order:
// of |delta| (the guard's drop per unit of |A|) and of delta (the
// in-sub-block cumulative sum at te - 1).
__device__ __forceinline__ float abs_sum(const float* dt, long long sdt_l,
                                         long long tb, long long te) {
  float s = 0.f;
  for (long long t = tb; t < te; ++t) s += fabsf(dt[t * sdt_l]);
  return s;
}

__device__ __forceinline__ float plain_sum(const float* dt, long long sdt_l,
                                           long long tb, long long te) {
  float s = 0.f;
  for (long long t = tb; t < te; ++t) s += dt[t * sdt_l];
  return s;
}

__device__ void tally_block(unsigned long long* tally, unsigned n_ratio,
                            unsigned n_step) {
  __shared__ unsigned long long acc[2];
  if (threadIdx.x == 0) acc[0] = acc[1] = 0ull;
  __syncthreads();
  if (n_ratio) atomicAdd(&acc[0], (unsigned long long)n_ratio);
  if (n_step) atomicAdd(&acc[1], (unsigned long long)n_step);
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(&tally[0], acc[0]);
    atomicAdd(&tally[1], acc[1]);
  }
}

// One step of the adjoint walk for state n at step t of a sub-block [tb, te)
// with in-sub-block cumulative delta dl: gr holds the adjoint entering from
// the right (a_{t+1} g_{t+1}), or for a ratio unit inside the sub-block the
// running sum_{s > t} P_s dx_s + P_end g_in. Returns g_t and updates gr.
__device__ __forceinline__ float adjoint_step(bool ratio, float A, float dl,
                                              float a, float dx, bool at_end,
                                              bool at_start, float& gr) {
  if (ratio) {
    const float l = A * dl;
    const float P = __expf(l);
    if (at_end) gr *= P;           // P_end g_in
    gr = fmaf(P, dx, gr);          // upper-triangular in-sub-block sum
    const float g = __expf(-fmaxf(l, PINV_FLOOR)) * gr;
    if (at_start) gr = a * g;      // product-form chain to the left
    return g;
  }
  const float g = dx + gr;
  gr = a * g;
  return g;
}

// Pass 1: the adjoint over each chunk from a zero entry, last step first.
__global__ void mxu_bwd_chunk_kernel(Params p) {
  extern __shared__ float smem[];
  float* sC = smem;
  const long long r = blockIdx.z;
  const int c = blockIdx.y;
  const long long d = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long t0 = (long long)c * p.T;
  const int len = (int)min((long long)p.T, p.L - t0);
  stage_bc<false>(p, r, t0, len, nullptr, sC);
  if (d >= p.D) return;

  float A[NS], gr[NS];
  const float* Ar = p.A + r * p.sA_r + d * NS;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    A[n] = Ar[n];
    gr[n] = 0.f;
  }
  const float* dt = p.dt + r * p.sdt_r + t0 * p.sdt_l + d;
  const float* dy = p.dy + (r * p.L + t0) * p.D + d;
  float sd = 0.f;
  for (int tb = (len - 1) / p.S * p.S; tb >= 0; tb -= p.S) {
    const int te = min(tb + p.S, len);
    const unsigned m = ratio_mask(A, abs_sum(dt, p.sdt_l, tb, te),
                                  p.guarded);
    float dl = plain_sum(dt, p.sdt_l, tb, te);
    sd += dl;
    for (int t = te - 1; t >= tb; --t) {
      const float delta = dt[t * p.sdt_l];
      const float dyv = dy[t * p.D];
      const float* cc = sC + t * NS;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        adjoint_step(m >> n & 1u, A[n], dl, __expf(delta * A[n]),
                     cc[n] * dyv, t == te - 1, t == tb, gr[n]);
      dl -= delta;
    }
  }
  float* gb = p.gbuf + ((r * p.nc + c) * NS) * p.D + d;
#pragma unroll
  for (int n = 0; n < NS; ++n) gb[n * p.D] = gr[n];
  p.sdelta[(r * p.nc + c) * p.D + d] = sd;
}

// Pass 2: the adjoint carry over the chunk summaries, last chunk first,
// from the seed dlast (or 0); leaves each chunk's entering adjoint.
__global__ void mxu_bwd_carry_kernel(Params p) {
  const long long r = blockIdx.y;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= NS * p.D) return;
  const int n = (int)(idx / p.D);
  const long long d = idx % p.D;
  const float a = p.A[r * p.sA_r + d * NS + n];
  float carry = p.dlast != nullptr ? p.dlast[(r * NS + n) * p.D + d] : 0.f;
  for (int c = p.nc - 1; c >= 0; --c) {
    const long long hi = ((r * p.nc + c) * NS + n) * p.D + d;
    const float h = p.gbuf[hi];
    const float sd = p.sdelta[(r * p.nc + c) * p.D + d];
    p.gbuf[hi] = carry;
    carry = __expf(a * sd) * carry + h;
  }
}

// Pass 3: recompute x from checkpoints, walk g backwards, form gradients.
// Shared memory: B and C of the chunk (2 T NS), then per replayed unit
// xs ((SUB + 1) NS ld: row 0 the state before the unit, row k + 1 x after
// step k, overwritten by g in the walk), dys, dts, us, dls (dy, delta, u,
// in-sub-block cumulative delta; u becomes delta u in the walk) and mks
// (the step's ratio mask), SUB ld each, channel fastest, ld = threads + 1.
__global__ void mxu_bwd_grad_kernel(Params p) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int ld = nt + 1;
  float* sB = smem;
  float* sC = sB + p.T * NS;
  float* xs = sC + p.T * NS;
  float* dys = xs + (SUB + 1) * NS * ld;
  float* dts = dys + SUB * ld;
  float* us = dts + SUB * ld;
  float* dls = us + SUB * ld;
  unsigned* mks = reinterpret_cast<unsigned*>(dls + SUB * ld);

  const long long r = blockIdx.z;
  const int c = blockIdx.y;
  const long long d = (long long)blockIdx.x * nt + tid;
  const long long t0 = (long long)c * p.T;
  const int len = (int)min((long long)p.T, p.L - t0);
  stage_bc<true>(p, r, t0, len, sB, sC);
  const bool on = d < p.D;
  const long long dd = on ? d : 0;

  float A[NS];
  const float* Ar = p.A + r * p.sA_r + dd * NS;
#pragma unroll
  for (int n = 0; n < NS; ++n) A[n] = on ? Ar[n] : 0.f;
  const float* u = p.u + r * p.su_r + t0 * p.su_l + dd;
  const float* dt = p.dt + r * p.sdt_r + t0 * p.sdt_l + dd;
  const float* dy = p.dy + (r * p.L + t0) * p.D + dd;
  float* du = p.du + (r * p.L + t0) * p.D + dd;
  float* ddt = p.ddt + (r * p.L + t0) * p.D + dd;
  float* ck = p.ckpt + ((r * p.nc + c) * p.nsub) * NS * p.D + dd;
  const unsigned valid = p.n_valid >= 32 ? ~0u : (1u << p.n_valid) - 1u;
  unsigned n_ratio = 0, n_step = 0;

  // forward over the chunk from its entry state, as the forward kernel,
  // checkpointing the running state v before every SUB-th step
  if (on) {
    float v[NS];
    if (c > 0) {
      const float* st = p.states + ((r * p.nc + c - 1) * NS) * p.D + d;
#pragma unroll
      for (int n = 0; n < NS; ++n) v[n] = st[n * p.D];
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n) v[n] = 0.f;
    }
    for (int tb = 0; tb < len; tb += p.S) {
      const int te = min(tb + p.S, len);
      const unsigned m =
          ratio_mask(A, abs_sum(dt, p.sdt_l, tb, te), p.guarded);
      n_ratio += __popc(m & valid);
      n_step += __popc(~m & valid);
      float dl = 0.f;
      for (int t = tb; t < te; ++t) {
        if (t % SUB == 0) {
          float* ckj = ck + (long long)(t / SUB) * NS * p.D;
#pragma unroll
          for (int n = 0; n < NS; ++n) ckj[n * p.D] = v[n];
        }
        const float delta = dt[t * p.sdt_l];
        const float dlu = delta * u[t * p.su_l];
        dl += delta;
        const float* b = sB + t * NS;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          if (m >> n & 1u)
            v[n] = fmaf(dlu * b[n], __expf(-fmaxf(A[n] * dl, PINV_FLOOR)),
                        v[n]);
          else
            v[n] = __expf(delta * A[n]) * v[n] + dlu * b[n];
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
        if (m >> n & 1u) v[n] *= __expf(A[n] * dl);
    }
  }

  float gr[NS], dA[NS];
  // adjoint entering the chunk's last step: left by bwd_carry, or with one
  // chunk the seed itself
  const float* gb = p.nc > 1 ? p.gbuf + ((r * p.nc + c) * NS) * p.D + dd
                    : p.dlast != nullptr ? p.dlast + r * NS * p.D + dd
                                         : nullptr;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    gr[n] = on && gb != nullptr ? gb[n * p.D] : 0.f;
    dA[n] = 0.f;
  }
  const long long bd = blockIdx.x;
  float* dBp = p.dB_p + ((bd * p.R + r) * p.L + t0) * NS;
  float* dCp = p.dC_p + ((bd * p.R + r) * p.L + t0) * NS;

  for (int j = (len + SUB - 1) / SUB - 1; j >= 0; --j) {
    const int i0 = j * SUB;
    const int klen = min(SUB, len - i0);
    // replay the unit from its checkpoint: x, dy, delta, u, cumulative
    // delta and the ratio mask per step
    if (on) {
      float v[NS];
      const float* ckj = ck + (long long)j * NS * p.D;
#pragma unroll
      for (int n = 0; n < NS; ++n) v[n] = ckj[n * p.D];
      const int tb = i0 / p.S * p.S;   // the sub-block holding step i0
      unsigned m = ratio_mask(A, abs_sum(dt, p.sdt_l, tb, min(tb + p.S, len)),
                              p.guarded);
      float dl = plain_sum(dt, p.sdt_l, tb, i0);  // cumulative delta so far
#pragma unroll
      for (int n = 0; n < NS; ++n)  // the state before the unit
        xs[n * ld + tid] =
            (m >> n & 1u) && i0 > tb ? __expf(A[n] * dl) * v[n] : v[n];
      for (int k = 0; k < klen; ++k) {
        const int t = i0 + k;
        if (k > 0 && t % p.S == 0) {  // a sub-block starts inside the unit
#pragma unroll
          for (int n = 0; n < NS; ++n)
            if (m >> n & 1u) v[n] *= __expf(A[n] * dl);
          m = ratio_mask(A, abs_sum(dt, p.sdt_l, t, min(t + p.S, len)),
                         p.guarded);
          dl = 0.f;
        }
        const float delta = dt[t * p.sdt_l];
        const float uu = u[t * p.su_l];
        const float dlu = delta * uu;
        dl += delta;
        const float* b = sB + t * NS;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          float x;
          if (m >> n & 1u) {
            const float l = A[n] * dl;
            v[n] = fmaf(dlu * b[n], __expf(-fmaxf(l, PINV_FLOOR)), v[n]);
            x = __expf(l) * v[n];
          } else {
            v[n] = __expf(delta * A[n]) * v[n] + dlu * b[n];
            x = v[n];
          }
          xs[((k + 1) * NS + n) * ld + tid] = x;
        }
        dys[k * ld + tid] = dy[t * p.D];
        dts[k * ld + tid] = delta;
        us[k * ld + tid] = uu;
        dls[k * ld + tid] = dl;
        mks[k * ld + tid] = m;
      }
    } else {
      for (int k = 0; k < klen; ++k) {
#pragma unroll
        for (int n = 0; n < NS; ++n) xs[((k + 1) * NS + n) * ld + tid] = 0.f;
        dys[k * ld + tid] = 0.f;
        us[k * ld + tid] = 0.f;
      }
    }
    __syncthreads();
    // dC[t, n] = sum over the block's channels of x dy
    for (int idx = tid; idx < klen * NS; idx += nt) {
      const int k = idx / NS, n = idx % NS;
      const float* xr = xs + ((k + 1) * NS + n) * ld;
      const float* dr = dys + k * ld;
      float s = 0.f;
      for (int q = 0; q < nt; ++q) s += xr[q] * dr[q];
      dCp[(i0 + k) * NS + n] = s;
    }
    __syncthreads();
    // adjoint walk, last step of the unit first
    if (on) {
      for (int k = klen - 1; k >= 0; --k) {
        const int t = i0 + k;
        const int tb = t / p.S * p.S;
        const int te = min(tb + p.S, len);
        const float delta = dts[k * ld + tid];
        const float uu = us[k * ld + tid];
        const float dyv = dys[k * ld + tid];
        const float dl = dls[k * ld + tid];
        const unsigned m = mks[k * ld + tid];
        const float* b = sB + t * NS;
        const float* cc = sC + t * NS;
        float Ssum = 0.f, ddl = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float a = __expf(delta * A[n]);
          const float g = adjoint_step(m >> n & 1u, A[n], dl, a, cc[n] * dyv,
                                       t == te - 1, t == tb, gr[n]);
          const float dp = g * xs[(k * NS + n) * ld + tid] * a;
          dA[n] = fmaf(dp, delta, dA[n]);
          ddl = fmaf(dp, A[n], ddl);
          Ssum = fmaf(g, b[n], Ssum);
          xs[((k + 1) * NS + n) * ld + tid] = g;
        }
        du[t * p.D] = Ssum * delta;
        ddt[t * p.D] = ddl + Ssum * uu;
        us[k * ld + tid] = delta * uu;
      }
    }
    __syncthreads();
    // dB[t, n] = sum over the block's channels of g delta u
    for (int idx = tid; idx < klen * NS; idx += nt) {
      const int k = idx / NS, n = idx % NS;
      const float* gr_ = xs + ((k + 1) * NS + n) * ld;
      const float* ur = us + k * ld;
      float s = 0.f;
      for (int q = 0; q < nt; ++q) s += gr_[q] * ur[q];
      dBp[(i0 + k) * NS + n] = s;
    }
    __syncthreads();
  }

  if (on) {
    float* dAp = p.dA_p + ((r * p.nc + c) * NS) * p.D + d;
#pragma unroll
    for (int n = 0; n < NS; ++n) dAp[n * p.D] = dA[n];
  }
  if (p.tally != nullptr) tally_block(p.tally, n_ratio, n_step);
}

size_t grad_smem(int T, int threads) {
  const size_t ld = (size_t)threads + 1;
  return (2 * (size_t)T * NS + (SUB + 1) * NS * ld + 5 * SUB * ld) *
         sizeof(float);
}

}  // namespace

extern "C" {

// strides: u_r, u_l, delta_r, delta_l, B_r, B_l, C_r, C_l, A_r (elements;
// host array of 9), as mxu_scan_fwd. ckpt holds ceil(T /
// mxu_scan_bwd_sub_len()) checkpoints per chunk: (R, nc, nsub, 16, D).
// dlast (R, 16, D) or null seeds the adjoint of the last state. tally and
// n_valid as mxu_scan_fwd. Returns a cudaError_t value (0 = launched).
int mxu_scan_bwd(const float* u, const float* dt, const float* A,
                 const float* B, const float* C, const float* dy,
                 const float* states, const float* dlast, float* du,
                 float* ddt, float* dA_p, float* dB_p, float* dC_p,
                 float* gbuf, float* sdelta, float* ckpt,
                 unsigned long long* tally, long long R, long long L,
                 long long D, int T, int S, int guarded, int n_valid,
                 int threads, const long long* strides, void* stream) {
  if (T < 1 || T > 256 || S < 1 || S > T || T % S != 0 || threads < 32 ||
      threads > 1024 || threads % 32 != 0 || R < 1 || L < 1 || D < 1 ||
      R > 65535 || L > 0x7fffffffLL || n_valid < 1 || n_valid > NS)
    return (int)cudaErrorInvalidValue;
  const long long nc = (L + T - 1) / T;
  if (nc > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem3 = grad_smem(T, threads);
  if (smem3 > 232448) return (int)cudaErrorInvalidValue;
  if ((nc > 1 && (states == nullptr || gbuf == nullptr ||
                  sdelta == nullptr)) || ckpt == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.u = u; p.dt = dt; p.A = A; p.B = B; p.C = C; p.dy = dy;
  p.states = states; p.dlast = dlast; p.du = du; p.ddt = ddt;
  p.dA_p = dA_p; p.dB_p = dB_p; p.dC_p = dC_p; p.gbuf = gbuf;
  p.sdelta = sdelta; p.ckpt = ckpt; p.tally = tally;
  p.R = R; p.L = L; p.D = D; p.T = T; p.S = S; p.nc = (int)nc;
  p.nsub = (T + SUB - 1) / SUB; p.guarded = guarded != 0;
  p.n_valid = n_valid;
  p.su_r = strides[0]; p.su_l = strides[1];
  p.sdt_r = strides[2]; p.sdt_l = strides[3];
  p.sB_r = strides[4]; p.sB_l = strides[5];
  p.sC_r = strides[6]; p.sC_l = strides[7];
  p.sA_r = strides[8];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((D + threads - 1) / threads), (unsigned)nc,
                  (unsigned)R);
  cudaError_t err;
  if (nc > 1) {
    const size_t smem1 = (size_t)T * NS * sizeof(float);
    mxu_bwd_chunk_kernel<<<grid, threads, smem1, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const dim3 g2((unsigned)((NS * D + CARRY_THREADS - 1) / CARRY_THREADS),
                  (unsigned)R);
    mxu_bwd_carry_kernel<<<g2, CARRY_THREADS, 0, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(mxu_bwd_grad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem3);
  if (err != cudaSuccess) return (int)err;
  mxu_bwd_grad_kernel<<<grid, threads, smem3, st>>>(p);
  return (int)cudaGetLastError();
}

// Steps per replayed unit; the caller sizes ckpt from it.
int mxu_scan_bwd_sub_len(void) { return SUB; }

const char* mxu_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
