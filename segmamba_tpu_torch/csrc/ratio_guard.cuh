// K7's ratio form: what the forward and the backward RATIO instances
// (gated_scan_fwd.cu, gated_scan_bwd.cu) share, so that they reach the same
// decision bit for bit: the guard's threshold and test, the NaN-guard clamp
// of Pinv, one forward step of a unit, and the form of a stretch of a
// thread's units; and the tally's warp sums. Included inside each source's
// anonymous namespace, after its ex2 (ex2.approx.ftz of an argument in log2
// units).

// Largest in-sub-block log-decay drop before 1 / P leaves the float32 range
// (exp(88) overflows; headroom for b): segmamba_tpu/ops/scan_pallas_mxu.py
// :75-78. The Pinv clamp at -(MAX_BLOCK_DROP + 10), in log2 units.
constexpr float MAX_BLOCK_DROP = 75.f;
constexpr float PINV_FLOOR2 = -(MAX_BLOCK_DROP + 10.f) * 1.4426950408889634f;

// The guard bits of one sub-block for a thread's states (bit n: the ratio
// form): dabs, the serial sum of |delta| over the sub-block in step order,
// times |A| (aa), below MAX_BLOCK_DROP; every unit when not guarded.
template <int SPT>
__device__ __forceinline__ unsigned ratio_bits(float dabs,
                                               const float (&aa)[SPT],
                                               int guarded) {
  unsigned m = 0;
#pragma unroll
  for (int n = 0; n < SPT; ++n)
    if (!guarded || aa[n] * dabs < MAX_BLOCK_DROP) m |= 1u << n;
  return m;
}

// The form of a thread's units over a stretch of steps, a template argument
// so that a stretch whose units all take one form runs without the per-unit
// selects: MIXED (bit n of the guard picks), ALL_RATIO, ALL_STEP.
constexpr int MIXED = 0, ALL_RATIO = 1, ALL_STEP = 2;
template <int F>
struct Form {
  static constexpr int value = F;
};

// Whether unit n takes the ratio form, from the guard bits and the form.
template <int FORM>
__device__ __forceinline__ bool is_ratio(unsigned bits, int n) {
  return FORM == ALL_RATIO || (FORM == MIXED && (bits >> n & 1u));
}

// One forward step of a unit: v, the ratio form's running value c + sum b
// Pinv or the step form's state, advances; l2 = A log2(e) cum, with cum the
// sub-block's running sum of delta; bu = delta u B. Returns the exp it took
// (Pinv, or the step's decay exp(delta A)).
__device__ __forceinline__ float ratio_advance(bool r, float l2, float a2,
                                               float delta, float bu,
                                               float& v) {
  const float e = ex2(r ? -fmaxf(l2, PINV_FLOOR2) : delta * a2);
  v = r ? __fmaf_rn(bu, e, v) : __fmaf_rn(e, v, bu);
  return e;
}

// The tally: each warp adds its units by form (every lane calls it).
__device__ __forceinline__ void tally_add(unsigned long long* tally,
                                          const unsigned (&units)[2]) {
  const unsigned nr = __reduce_add_sync(0xffffffffu, units[0]);
  const unsigned ns = __reduce_add_sync(0xffffffffu, units[1]);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(tally, (unsigned long long)nr);
    atomicAdd(tally + 1, (unsigned long long)ns);
  }
}
