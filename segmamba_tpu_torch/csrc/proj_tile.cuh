// K8's projections inside a tile: what the forward and the backward PROJ
// instances (gated_scan_fwd.cu, gated_scan_bwd.cu) share. A PROJ block owns
// all E <= 128 channels of its chunk (the projections and the backward's
// sums over channels mix them), stages the chunk's xc rows in shared memory
// in the storage type, and forms
//   x_dbl = xc [W_B | W_C | W_dt]   (x_proj's columns reordered: B and C
//                                    first, so every row's B and C start on
//                                    a 16-byte boundary for float4 reads)
// in float32: on the tensor cores (mma.sync m16n8k16, bf16 x bf16 -> f32)
// where xc and x_proj are both bfloat16, so every product is exact and only
// the order of the sums differs from a float32 matmul; on the CUDA cores
// otherwise (a float32 operand stays a float32 FMA).
//
// Layouts: a tile row holds ldu elements (ldu = channels + 4, so ldu = 4
// mod 8: the 32 rows a warp reads at once, one per lane, 8 or 16 bytes
// each, fall on distinct banks); the weights transposed, sWt[c][e] (ncol
// rows of nch floats, zero past E, nch a multiple of 4); the outputs sB,
// sC (rows of NS floats) and sXdt (rows of Rk floats).
//
// What bounds it: 2 E (32 + Rk) operations per row, against the scan's ~20
// E NS per row and sweep. On the CUDA cores a warp forms 32 rows x PROJ_CB
// columns at once (a lane a row), so each 4-channel step is one vector load
// of the lane's row, PROJ_CB broadcast loads of the weights and 4 PROJ_CB
// FMAs: a third of a forward block's time at stage 0 (E = 96), measured on
// the H100, hence the tensor cores for bfloat16: a warp's (16 rows, 8
// columns) tile is E / 16 mma.sync from two 32-bit loads of each operand per
// lane. Included inside each source's anonymous namespace, after to_f and
// NS.

constexpr int PROJ_CB = 8;          // columns a warp forms at once
constexpr int PROJ_MAX_RANK = 16;   // dt_rank the instances take
constexpr int PROJ_MAX_CHANNELS = 128;
static_assert(NS % PROJ_CB == 0, "a column block lies in B or in C");

// Four consecutive channels of a staged row, widened to float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// Column c of the reordered x_dbl ([B | C | dt]) is column proj_col_in(c)
// of x_proj ([dt | B | C]).
__device__ __forceinline__ int proj_col_in(int c, int Rk) {
  return c < 2 * NS ? Rk + c : c - 2 * NS;
}

// Stage the weights once a block: sWt[c][e] = x_proj[e][col_in(c)] (with
// `with_w`) and, right after it, sDtp[k][e] = dt_proj[k][e] (zero for e >=
// E), from the float32 W (E, Rk + 2 NS) and dtp (Rk, E); a thread's loads
// go out in batches of 8 before its stores. No barrier.
__device__ __forceinline__ void proj_stage_weights(const float* W,
                                                   const float* dtp, int E,
                                                   int nch, int Rk,
                                                   float* sWt, bool with_w) {
  const int ncol = Rk + 2 * NS;
  const int n1 = ncol * nch, n = (ncol + Rk) * nch, nt = blockDim.x;
  for (int i0 = threadIdx.x + (with_w ? 0 : n1); i0 < n; i0 += 8 * nt) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * nt, e = i % nch;
      v[j] = 0.f;
      if (i < n1 && e < E) v[j] = W[e * ncol + proj_col_in(i / nch, Rk)];
      else if (i < n && e < E) v[j] = dtp[(i - n1) / nch * E + e];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i0 + j * nt < n) sWt[i0 + j * nt] = v[j];
  }
}

// The tensor cores' operand B: the weights in bfloat16 (exact: x_proj is
// bfloat16 on this path), sWb[c][e] with rows of nch + 8 elements (8 rows
// of a warp's loads on distinct banks), zero past E and
// past the last column (proj_ncp rows). No barrier.
__device__ __forceinline__ int proj_ncp(int Rk) {
  return (Rk + 2 * NS + 7) / 8 * 8;
}
__device__ __forceinline__ void proj_stage_wb(const float* W, int E, int nch,
                                              int Rk, __nv_bfloat16* sWb) {
  const int ncol = Rk + 2 * NS, ld = nch + 8;
  const int n = proj_ncp(Rk) * ld, nt = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n; i0 += 8 * nt) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * nt, c = i / ld, e = i % ld;
      v[j] = 0.f;
      if (i < n && c < ncol && e < E) v[j] = W[e * ncol + proj_col_in(c, Rk)];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i0 + j * nt < n) sWb[i0 + j * nt] = __float2bfloat16(v[j]);
  }
}

template <typename S>
constexpr bool is_bf16 = false;
template <>
constexpr bool is_bf16<__nv_bfloat16> = true;

__device__ __forceinline__ unsigned ld_b32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// d += A B over one k16 step: A (16 x 16, row-major) and B (16 x 8,
// column-major) in bfloat16 fragments, d in float32 (mma.sync
// m16n8k16.row.col, the layouts of the PTX ISA).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], unsigned a0,
                                               unsigned a1, unsigned a2,
                                               unsigned a3, unsigned b0,
                                               unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One output of the projections: column c of x_dbl ([B | C | dt]) at row
// t into sB, sC or sXdt.
__device__ __forceinline__ void proj_put(int t, int c, int ncol, int Rk,
                                         float v, float* sB, float* sC,
                                         float* sXdt) {
  if (c < NS) sB[t * NS + c] = v;
  else if (c < 2 * NS) sC[t * NS + c - NS] = v;
  else if (c < ncol) sXdt[t * Rk + c - 2 * NS] = v;
}

// x_dbl of bfloat16 tile rows [r0, r0 + nrows) on the tensor cores (nch a
// multiple of 16): work items are (16 rows, 8 columns) output tiles, dealt
// to the warps in turn, each nch / 16 mma.sync with its operands loaded
// straight from shared memory (the tile's rows of ldu elements and sWb).
// No barrier.
__device__ __forceinline__ void project_rows_mma(
    const __nv_bfloat16* tile, int ldu, int r0, int nrows, int nch,
    const __nv_bfloat16* sWb, int Rk, float* sB, float* sC, float* sXdt) {
  const int ncol = Rk + 2 * NS, ld = nch + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, g = lane >> 2, tq = lane & 3;
  const int nt = proj_ncp(Rk) / 8, items = (nrows + 15) / 16 * nt;
  for (int it = warp; it < items; it += nw) {
    const int m0 = (it / nt) * 16, n0 = (it % nt) * 8;
    const __nv_bfloat16* pa =
        tile + (long long)(r0 + min(m0 + g, nrows - 1)) * ldu + 2 * tq;
    const __nv_bfloat16* pb =
        tile + (long long)(r0 + min(m0 + g + 8, nrows - 1)) * ldu + 2 * tq;
    const __nv_bfloat16* pw = sWb + (n0 + g) * ld + 2 * tq;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < nch; k0 += 16)
      mma_bf16_16816(d, ld_b32(pa + k0), ld_b32(pb + k0), ld_b32(pa + k0 + 8),
                     ld_b32(pb + k0 + 8), ld_b32(pw + k0),
                     ld_b32(pw + k0 + 8));
    const int c = n0 + 2 * tq;
    if (m0 + g < nrows) {
      proj_put(r0 + m0 + g, c, ncol, Rk, d[0], sB, sC, sXdt);
      proj_put(r0 + m0 + g, c + 1, ncol, Rk, d[1], sB, sC, sXdt);
    }
    if (m0 + g + 8 < nrows) {
      proj_put(r0 + m0 + g + 8, c, ncol, Rk, d[2], sB, sC, sXdt);
      proj_put(r0 + m0 + g + 8, c + 1, ncol, Rk, d[3], sB, sC, sXdt);
    }
  }
}

// x_dbl of tile rows [r0, r0 + nrows): B into sB, C into sC, the dt
// columns into sXdt (each output row r0 + i at row r0 + i). Work items are
// (32 rows, PROJ_CB columns), dealt to the warps in turn; each column's sum
// runs over the channels in order. No barrier.
template <typename S>
__device__ __forceinline__ void project_rows(const S* tile, int ldu, int r0,
                                             int nrows, int nch,
                                             const float* sWt, int Rk,
                                             float* sB, float* sC,
                                             float* sXdt) {
  const int ncol = Rk + 2 * NS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int nblk = (ncol + PROJ_CB - 1) / PROJ_CB;
  const int items = (nrows + 31) / 32 * nblk;
  for (int it = warp; it < items; it += nw) {
    const int row = (it / nblk) * 32 + lane;
    const int c0 = (it % nblk) * PROJ_CB;
    const S* xr = tile + (long long)(r0 + min(row, nrows - 1)) * ldu;
    int wo[PROJ_CB];
#pragma unroll
    for (int m = 0; m < PROJ_CB; ++m) wo[m] = min(c0 + m, ncol - 1) * nch;
    float acc[PROJ_CB];
#pragma unroll
    for (int m = 0; m < PROJ_CB; ++m) acc[m] = 0.f;
    for (int e = 0; e < nch; e += 4) {
      const float4 x = load4(xr + e);
#pragma unroll
      for (int m = 0; m < PROJ_CB; ++m) {
        const float4 w = *reinterpret_cast<const float4*>(sWt + wo[m] + e);
        acc[m] = __fmaf_rn(x.x, w.x, acc[m]);
        acc[m] = __fmaf_rn(x.y, w.y, acc[m]);
        acc[m] = __fmaf_rn(x.z, w.z, acc[m]);
        acc[m] = __fmaf_rn(x.w, w.w, acc[m]);
      }
    }
    if (row < nrows) {
      const int t = r0 + row;
      if (c0 < 2 * NS) {   // 8 columns of B or of C: two 16-byte stores
        float4* o = reinterpret_cast<float4*>(
            (c0 < NS ? sB + c0 : sC + c0 - NS) + t * NS);
        o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      } else {
#pragma unroll
        for (int m = 0; m < PROJ_CB; ++m)
          if (c0 + m < ncol) sXdt[t * Rk + c0 + m - 2 * NS] = acc[m];
      }
    }
  }
}

// dt_raw of channel e at a staged row: bias + sum_k xdt[k] dt_proj[k][e],
// the sum in k order. RK > 0 unrolls it for that dt_rank (a loop of
// unknown length kept the forward's rows from overlapping: delta took half
// of its staging phase on the H100).
template <int RK = 0>
__device__ __forceinline__ float proj_dt_raw(const float* xdt,
                                             const float* sDtp, int nch,
                                             int Rk, int e, float bias) {
  float v = 0.f;
  if constexpr (RK > 0) {
#pragma unroll
    for (int k = 0; k < RK; ++k) v = __fmaf_rn(xdt[k], sDtp[k * nch + e], v);
  } else {
    for (int k = 0; k < Rk; ++k) v = __fmaf_rn(xdt[k], sDtp[k * nch + e], v);
  }
  return v + bias;
}

