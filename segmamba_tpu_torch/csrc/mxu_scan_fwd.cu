// Matrix-unit selective scan (K7), forward, for Hopper (sm_90a): the
// ratio-form sub-block scan with its overflow guard decided per unit.
//
// Replaces the Pallas TPU kernel
//   K7  segmamba_tpu/ops/scan_pallas_mxu.py:131  _fwd_kernel (pallas_call
//       :251), with its helpers _block_scan :107 and _masks :82; entry
//       selective_scan_mxu :379, guarded custom VJP _make_core :335.
// The function is K6's core (u, delta, A, B, C) -> (y, chunk exit states),
// float32, delta final (bias and softplus run before the kernel, D-skip and
// the silu(z) gate after it, in the wrapper ops/scan_mxu.py).
//
// Per row r, channel d, state n (N = 16 per launch), in sub-blocks of S
// steps (S divides the chunk length T), with b = delta u B:
//   Delta = in-sub-block cumulative sum of delta,  l = A Delta,
//   P = exp(l),  Pinv = exp(-max(l, -MAX_BLOCK_DROP - 10))
//   x_t = P_t (c + sum_{s <= t} b_s Pinv_s)        (= x_blk + P c)
//   c  <- P_end (c + sum_blk b Pinv)               (= P_end c + x_blk_end)
//   y_t = sum_n C_t x_t
// The guard, decided per unit (r, d, n, sub-block) in the kernel:
//   drop = |A[d, n]| sum_{t in blk} |delta_t|; drop < MAX_BLOCK_DROP takes
//   the ratio form, otherwise the step recurrence
//   x_t = exp(delta_t A) x_{t-1} + b_t in the same thread, from the same
//   carry. (JAX decides once per call from the global bound and sends the
//   whole call to the Hillis-Steele kernel K6 with lax.cond.) guarded = 0
//   is JAX's unguarded kernel: the ratio form everywhere.
// Every pass computes the decision with the same serial sum over the
// sub-block's deltas, so the passes and the backward kernel agree bit for
// bit on it.
//
// What bounds it on this card: the TPU kernel moves the in-sub-block
// cumulative sums onto the matrix unit as block-diagonal triangular
// products (HIGHEST precision). Here one thread walks its channel's steps
// in order, so those sums are running sums on the CUDA cores in true
// float32 (no TF32); the ratio form costs two exps per (step, state) where
// the step form costs one. So the SFU's exp rate bounds it, then the bytes
// of u and delta (a tensor-core form, e.g. 3xTF32 mma on the S x S masks,
// is later work). The TPU kernel carries its state across a serial grid
// axis of chunks; at stage 0 (L = 262,144, D = 96) that would leave one or
// two blocks busy, so this kernel takes K1's chunk-parallel three passes
// (csrc/gated_scan_fwd.cu), as kernels named mxu_<pass>_kernel:
//   1. chunk_exit:   one thread per (row, chunk, channel) runs its chunk
//                    from a zero state, 16 states in registers; writes the
//                    exit state and the chunk's sum of delta (its decay is
//                    exp(A sum delta), the product of its P_end).
//   2. chunk_carry:  one thread per (row, state, channel) combines the
//                    chunk summaries in order, leaving each chunk's entry.
//   3. chunk_output: re-runs each chunk from its entry, writes y and the
//                    chunk exit states (R, nc, N, D), K6's layout.
// B and C of a chunk are staged in shared memory; u and delta are read with
// the channel fastest (coalesced), with row and step strides (B and C may
// be column slices of x_dbl). A ragged L stops at the last real step (JAX
// pads with delta = 0, identity steps, so the outputs agree).
//
// The optional tally (two uint64: units through the ratio form, through
// the step form) is added to once per block of pass 3, after a reduction
// in shared memory; it is null on the main path. The kernel allocates
// nothing: the caller passes y, the states and the scratch.

#include <cuda_runtime.h>

namespace {

constexpr int NS = 16;             // states per launch
constexpr int CARRY_THREADS = 256;
constexpr float MAX_BLOCK_DROP = 75.f;
constexpr float PINV_FLOOR = -(MAX_BLOCK_DROP + 10.f);  // NaN-guard clamp

struct Params {
  const float* u;
  const float* dt;      // delta (final)
  const float* A;       // (R|1, D, NS)
  const float* B;
  const float* C;
  float* y;             // (R, L, D) contiguous
  float* states;        // (R, nc, NS, D)
  float* hbuf;          // (R, nc, NS, D) scratch (nc > 1)
  float* sdelta;        // (R, nc, D) scratch (nc > 1)
  unsigned long long* tally;  // (ratio units, step units) or null
  long long R, L, D;
  int T, S, nc, guarded, n_valid;
  long long su_r, su_l, sdt_r, sdt_l, sB_r, sB_l, sC_r, sC_l, sA_r;
};

// Stage chunk steps [t0, t0 + len) of B (and C) of row r in shared memory.
template <bool WITH_C>
__device__ __forceinline__ void stage_bc(const Params& p, long long r,
                                         long long t0, int len, float* sB,
                                         float* sC) {
  const float* B = p.B + r * p.sB_r;
  const float* C = p.C + r * p.sC_r;
  for (int i = threadIdx.x; i < len * NS; i += blockDim.x) {
    const long long t = t0 + i / NS;
    const int n = i % NS;
    sB[i] = B[t * p.sB_l + n];
    if (WITH_C) sC[i] = C[t * p.sC_l + n];
  }
  __syncthreads();
}

// The guard: bit n set when unit n takes the ratio form. dabs is the
// sub-block's serial sum of |delta| (the same order in every pass).
__device__ __forceinline__ unsigned ratio_mask(const float* A, float dabs,
                                               int guarded) {
  unsigned m = 0;
#pragma unroll
  for (int n = 0; n < NS; ++n)
    if (!guarded || fabsf(A[n]) * dabs < MAX_BLOCK_DROP) m |= 1u << n;
  return m;
}

__device__ __forceinline__ float abs_sum(const float* dt, long long sdt_l,
                                         long long tb, long long te) {
  float s = 0.f;
  for (long long t = tb; t < te; ++t) s += fabsf(dt[t * sdt_l]);
  return s;
}

// Add each thread's unit counts to the tally: a shared-memory sum, then one
// global add per count and block. Every thread of the block calls it.
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

// Pass 1: each chunk from a zero state; exit state and sum of delta.
__global__ void mxu_chunk_exit_kernel(Params p) {
  extern __shared__ float smem[];
  float* sB = smem;
  const long long r = blockIdx.z;
  const int c = blockIdx.y;
  const long long d = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long t0 = (long long)c * p.T;
  const int len = (int)min((long long)p.T, p.L - t0);
  stage_bc<false>(p, r, t0, len, sB, nullptr);
  if (d >= p.D) return;

  float A[NS], v[NS];
  const float* Ar = p.A + r * p.sA_r + d * NS;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    A[n] = Ar[n];
    v[n] = 0.f;
  }
  const float* u = p.u + r * p.su_r + t0 * p.su_l + d;
  const float* dt = p.dt + r * p.sdt_r + t0 * p.sdt_l + d;
  float sd = 0.f;
  for (int tb = 0; tb < len; tb += p.S) {
    const int te = min(tb + p.S, len);
    const unsigned m = ratio_mask(A, abs_sum(dt, p.sdt_l, tb, te), p.guarded);
    float dl = 0.f;
    for (int t = tb; t < te; ++t) {
      const float delta = dt[t * p.sdt_l];
      const float du = delta * u[t * p.su_l];
      dl += delta;
      const float* b = sB + t * NS;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        if (m >> n & 1u)  // v = c + sum b Pinv
          v[n] = fmaf(du * b[n], __expf(-fmaxf(A[n] * dl, PINV_FLOOR)), v[n]);
        else              // v = x
          v[n] = __expf(delta * A[n]) * v[n] + du * b[n];
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)  // carry out of the sub-block: P_end v
      if (m >> n & 1u) v[n] *= __expf(A[n] * dl);
    sd += dl;
  }
  float* hb = p.hbuf + ((r * p.nc + c) * NS) * p.D + d;
#pragma unroll
  for (int n = 0; n < NS; ++n) hb[n * p.D] = v[n];
  p.sdelta[(r * p.nc + c) * p.D + d] = sd;
}

// Pass 2: the carry over the chunk summaries; leaves each chunk's entry.
__global__ void mxu_chunk_carry_kernel(Params p) {
  const long long r = blockIdx.y;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= NS * p.D) return;
  const int n = (int)(idx / p.D);
  const long long d = idx % p.D;
  const float a = p.A[r * p.sA_r + d * NS + n];
  float carry = 0.f;
  for (int c = 0; c < p.nc; ++c) {
    const long long hi = ((r * p.nc + c) * NS + n) * p.D + d;
    const float h = p.hbuf[hi];
    const float sd = p.sdelta[(r * p.nc + c) * p.D + d];
    p.hbuf[hi] = carry;  // entry state of chunk c
    carry = __expf(a * sd) * carry + h;
  }
}

// Pass 3: each chunk from its entry state; y, the exit states, the tally.
__global__ void mxu_chunk_output_kernel(Params p) {
  extern __shared__ float smem[];
  float* sB = smem;
  float* sC = smem + p.T * NS;
  const long long r = blockIdx.z;
  const int c = blockIdx.y;
  const long long d = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long t0 = (long long)c * p.T;
  const int len = (int)min((long long)p.T, p.L - t0);
  stage_bc<true>(p, r, t0, len, sB, sC);
  unsigned n_ratio = 0, n_step = 0;

  if (d < p.D) {
    float A[NS], v[NS];
    const float* Ar = p.A + r * p.sA_r + d * NS;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      A[n] = Ar[n];
      v[n] = 0.f;
    }
    if (p.nc > 1) {  // entry state left by chunk_carry
      const float* hb = p.hbuf + ((r * p.nc + c) * NS) * p.D + d;
#pragma unroll
      for (int n = 0; n < NS; ++n) v[n] = hb[n * p.D];
    }
    const unsigned valid = p.n_valid >= 32 ? ~0u : (1u << p.n_valid) - 1u;
    const float* u = p.u + r * p.su_r + t0 * p.su_l + d;
    const float* dt = p.dt + r * p.sdt_r + t0 * p.sdt_l + d;
    float* y = p.y + (r * p.L + t0) * p.D + d;
    for (int tb = 0; tb < len; tb += p.S) {
      const int te = min(tb + p.S, len);
      const unsigned m =
          ratio_mask(A, abs_sum(dt, p.sdt_l, tb, te), p.guarded);
      n_ratio += __popc(m & valid);
      n_step += __popc(~m & valid);
      float dl = 0.f;
      for (int t = tb; t < te; ++t) {
        const float delta = dt[t * p.sdt_l];
        const float du = delta * u[t * p.su_l];
        dl += delta;
        const float* b = sB + t * NS;
        const float* cc = sC + t * NS;
        float yt = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          float x;
          if (m >> n & 1u) {
            const float l = A[n] * dl;
            v[n] = fmaf(du * b[n], __expf(-fmaxf(l, PINV_FLOOR)), v[n]);
            x = __expf(l) * v[n];
          } else {
            v[n] = __expf(delta * A[n]) * v[n] + du * b[n];
            x = v[n];
          }
          yt = fmaf(cc[n], x, yt);
        }
        y[t * p.D] = yt;
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
        if (m >> n & 1u) v[n] *= __expf(A[n] * dl);
    }
    if (p.states != nullptr) {
      float* st = p.states + ((r * p.nc + c) * NS) * p.D + d;
#pragma unroll
      for (int n = 0; n < NS; ++n) st[n * p.D] = v[n];
    }
  }
  if (p.tally != nullptr) tally_block(p.tally, n_ratio, n_step);
}

}  // namespace

extern "C" {

// strides: u_r, u_l, delta_r, delta_l, B_r, B_l, C_r, C_l, A_r (elements;
// host array of 9). A is (R|1, D, 16) contiguous per row; y is written
// contiguous (R, L, D); states (R, nc, 16, D) may be null. tally (two
// uint64) may be null; n_valid is the number of real states (<= 16) that
// it counts. Returns a cudaError_t value (0 = launched).
int mxu_scan_fwd(const float* u, const float* dt, const float* A,
                 const float* B, const float* C, float* y, float* states,
                 float* hbuf, float* sdelta, unsigned long long* tally,
                 long long R, long long L, long long D, int T, int S,
                 int guarded, int n_valid, int threads,
                 const long long* strides, void* stream) {
  if (T < 1 || T > 256 || S < 1 || S > T || T % S != 0 || threads < 32 ||
      threads > 1024 || threads % 32 != 0 || R < 1 || L < 1 || D < 1 ||
      R > 65535 || L > 0x7fffffffLL || n_valid < 1 || n_valid > NS)
    return (int)cudaErrorInvalidValue;
  const long long nc = (L + T - 1) / T;
  if (nc > 65535 || (nc > 1 && (hbuf == nullptr || sdelta == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.u = u; p.dt = dt; p.A = A; p.B = B; p.C = C;
  p.y = y; p.states = states; p.hbuf = hbuf; p.sdelta = sdelta;
  p.tally = tally;
  p.R = R; p.L = L; p.D = D; p.T = T; p.S = S; p.nc = (int)nc;
  p.guarded = guarded != 0; p.n_valid = n_valid;
  p.su_r = strides[0]; p.su_l = strides[1];
  p.sdt_r = strides[2]; p.sdt_l = strides[3];
  p.sB_r = strides[4]; p.sB_l = strides[5];
  p.sC_r = strides[6]; p.sC_l = strides[7];
  p.sA_r = strides[8];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((D + threads - 1) / threads), (unsigned)nc,
                  (unsigned)R);
  const size_t smem = (size_t)T * NS * sizeof(float);
  cudaError_t err;
  if (nc > 1) {
    mxu_chunk_exit_kernel<<<grid, threads, smem, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const dim3 g2((unsigned)((NS * D + CARRY_THREADS - 1) / CARRY_THREADS),
                  (unsigned)R);
    mxu_chunk_carry_kernel<<<g2, CARRY_THREADS, 0, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  mxu_chunk_output_kernel<<<grid, threads, 2 * smem, st>>>(p);
  return (int)cudaGetLastError();
}

const char* mxu_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
