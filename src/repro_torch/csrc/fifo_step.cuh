// Device code shared by the two kernels: the NEG sentinel and the
// segmented max-plus scan primitives.  Both kernels run Jacobi steps of the
// event-time fixpoint of one config row,
//
//   b = is_read ? t[data_idx] + rd_lat : t[bp_idx] + bp_base   (NEG if masked)
//   m = seg_start ? max(b, delta) : b
//   (A, M) = inclusive segmented max-plus scan of (seg_start ? NEG : delta, m)
//   t <- max(A, M)
//
// each lane scanning its own chunk of events in sequence, then combining
// the chunks' aggregates with warp_inclusive_scan (K1, condensed.cu: one or
// a few warps a row) or block_exclusive_scan and a cluster scan (K2,
// fifo_eval.cu: a thread-block cluster a row).

// NEG sums: the scan accumulates NEG = -1e9 across segment starts.  That
// is harmless in float32: at every event the true value max(A, M) comes
// from the M term of its own segment start (delta >= 0 there, and all sums
// of real terms are integers below 2**24, exact in any association
// order), while every term that crossed a NEG stays below -9e8.  So the
// association order of the scan is free and the result is bit-identical
// to the reference's Hillis-Steele doubling.  The pad identity (0, NEG) is
// the one the reference uses (jnp.pad in fifo_eval.py).  Do not replace
// NEG by -inf: -inf + -inf and inf - inf behave differently.

#pragma once

#include <cuda_runtime.h>

namespace fifo {

constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_E_PAD = 32768;          // K2: 8 CTAs x 4096 events

// Scratch for the block-wide scan (static shared memory).
struct Scratch {
  float a[32];
  float m[32];
};

// (a1, m1) . (a2, m2) = (a1 + a2, max(m1 + a2, m2))
__device__ __forceinline__ void combine(float pa, float pm, float& a,
                                        float& m) {
  m = fmaxf(pm + a, m);
  a = pa + a;
}

// Inclusive scan of (a, m) over the lanes of a warp.
__device__ __forceinline__ void warp_inclusive_scan(float& a, float& m,
                                                    int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    float pa = __shfl_up_sync(FULL, a, off);
    float pm = __shfl_up_sync(FULL, m, off);
    if (lane >= off) combine(pa, pm, a, m);
  }
}

// Block-wide EXCLUSIVE scan of one (a, m) pair per thread, identity
// (0, NEG).  blockDim.x is a multiple of 32.  Contains __syncthreads().
__device__ __forceinline__ void block_exclusive_scan(float& a, float& m,
                                                     Scratch& s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  warp_inclusive_scan(a, m, lane);
  if (lane == 31) {
    s.a[warp] = a;
    s.m[warp] = m;
  }
  float ea = __shfl_up_sync(FULL, a, 1);
  float em = __shfl_up_sync(FULL, m, 1);
  if (lane == 0) {
    ea = 0.f;
    em = NEG;
  }
  __syncthreads();
  if (warp == 0) {
    float wa = lane < n_warps ? s.a[lane] : 0.f;
    float wm = lane < n_warps ? s.m[lane] : NEG;
    warp_inclusive_scan(wa, wm, lane);
    float xa = __shfl_up_sync(FULL, wa, 1);
    float xm = __shfl_up_sync(FULL, wm, 1);
    if (lane == 0) {
      xa = 0.f;
      xm = NEG;
    }
    if (lane < n_warps) {
      s.a[lane] = xa;
      s.m[lane] = xm;
    }
  }
  __syncthreads();
  const float pa = s.a[warp];
  const float pm = s.m[warp];
  // prefix of the warp, then the lanes before this one inside the warp
  combine(pa, pm, ea, em);
  a = ea;
  m = em;
}

}  // namespace fifo
