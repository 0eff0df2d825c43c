// Shared device code of the two fifo_eval kernels (fifo_eval.cu,
// condensed.cu): one Jacobi step of the max-plus event-time fixpoint for
// one config row, done by one thread block.
//
//   b = is_read ? t[data_idx] + rd_lat : t[bp_idx] + bp_base   (NEG if masked)
//   m = seg_start ? max(b, delta) : b
//   (A, M) = inclusive segmented max-plus scan of (seg_start ? NEG : delta, m)
//   t <- max(A, M)
//
// Layout: the row's event times t live in dynamic shared memory (one
// e_pad float buffer, updated in place).  Thread i owns the contiguous
// chunk [i*K, i*K + K) of events.  A step is
//
//   1. gather: each thread computes m for its chunk into registers,
//      reading only the OLD t (Jacobi, not Gauss-Seidel: updating t
//      before every thread has gathered would change the iteration
//      count, and with it which rows are UNRESOLVED at the cap);
//   2. __syncthreads();
//   3. a sequential scan of the chunk gives its aggregate, a block-wide
//      exclusive scan of the aggregates (warp shuffles, then one warp
//      over the warp totals) gives each chunk's prefix, and a second
//      sequential pass writes the new t in place.
//
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
#include <math_constants.h>

#include <type_traits>

namespace fifo {

constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_K = 32;                 // events per thread
constexpr int MAX_E_PAD = MAX_THREADS * MAX_K;

// Operands of one row.  Shared operands are (e_pad,), per-row operands
// point at the row's (e_pad,) slice.
struct RowOperands {
  const float* __restrict__ delta;
  const float* __restrict__ segst;
  const float* __restrict__ is_read;
  const float* __restrict__ has_data;
  const int* __restrict__ data_idx;
  const float* __restrict__ end_bonus;
  const float* __restrict__ rd_lat;
  const int* __restrict__ bp_idx;
  const float* __restrict__ bp_valid;
  const float* __restrict__ bp_base;
};

// Scratch for the block-wide scan and reductions (static shared memory).
struct Scratch {
  float a[32];
  float m[32];
  float r[32];
};

// (a1, m1) . (a2, m2) = (a1 + a2, max(m1 + a2, m2))
__device__ __forceinline__ void combine(float pa, float pm, float& a,
                                        float& m) {
  m = fmaxf(pm + a, m);
  a = pa + a;
}

__device__ __forceinline__ float a_of(const RowOperands& op, int e) {
  return op.segst[e] > 0.f ? NEG : op.delta[e];
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

// Block-wide max.  Contains __syncthreads(); every thread gets the result.
__device__ __forceinline__ float block_max(float v, Scratch& s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  if (lane == 0) s.r[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? s.r[lane] : -CUDART_INF_F;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
    if (lane == 0) s.r[0] = v;
  }
  __syncthreads();
  const float r = s.r[0];
  __syncthreads();
  return r;
}

// One Jacobi step of the row held in shared memory t.  Returns (through
// the block) whether t is unchanged, and the new max(t) in *max_t.
// Every thread of the block must call it.
template <int K>
__device__ __forceinline__ bool step(float* t, const RowOperands& op,
                                     int e_pad, Scratch& s, float* max_t) {
  const int base = threadIdx.x * K;
  float m[K];
  // 1. gather from the old t
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = base + k;
    float mk = NEG;
    if (e < e_pad) {
      float b;
      if (op.is_read[e] > 0.f) {
        b = op.has_data[e] > 0.f ? t[op.data_idx[e]] + op.rd_lat[e] : NEG;
      } else {
        b = op.bp_valid[e] > 0.f ? t[op.bp_idx[e]] + op.bp_base[e] : NEG;
      }
      mk = op.segst[e] > 0.f ? fmaxf(b, op.delta[e]) : b;
    }
    m[k] = mk;
  }
  __syncthreads();
  // 2. the chunk's aggregate
  float A = 0.f, M = NEG;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = base + k;
    if (e < e_pad) {
      float a = a_of(op, e);
      float mk = m[k];
      combine(A, M, a, mk);
      A = a;
      M = mk;
    }
  }
  // 3. the chunk's prefix, then the new times in place
  block_exclusive_scan(A, M, s);
  bool same = true;
  float local_max = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = base + k;
    if (e < e_pad) {
      float a = a_of(op, e);
      float mk = m[k];
      combine(A, M, a, mk);
      A = a;
      M = mk;
      const float tn = fmaxf(A, M);
      same &= (tn == t[e]);
      t[e] = tn;
      local_max = fmaxf(local_max, tn);
    }
  }
  const bool all_same = __syncthreads_and(same);
  *max_t = block_max(local_max, s);
  return all_same;
}

// max over the row of t + end_bonus.  Contains __syncthreads().
__device__ __forceinline__ float latency(const float* t,
                                         const RowOperands& op, int e_pad,
                                         Scratch& s) {
  float v = -CUDART_INF_F;
  for (int e = threadIdx.x; e < e_pad; e += blockDim.x)
    v = fmaxf(v, t[e] + op.end_bonus[e]);
  return block_max(v, s);
}

// Threads per block and events per thread for a row of e_pad events:
// the smallest K in {1, 2, 4, 8, 16, 32} with e_pad <= 1024 * K, and as
// many threads (a multiple of 32) as the row then needs.
inline void pick_shape(int e_pad, int* k, int* threads) {
  int kk = 1;
  while (kk < MAX_K && (e_pad + kk - 1) / kk > MAX_THREADS) kk <<= 1;
  int n = (e_pad + kk - 1) / kk;
  *k = kk;
  *threads = ((n + 31) / 32) * 32;
}

// Launches kern on c blocks of `threads` threads, with smem bytes of
// dynamic shared memory (above 48 KB this has to be allowed first), and
// returns the launch's error.
template <typename Kernel, typename... Args>
cudaError_t launch_rows(Kernel kern, int c, int threads, size_t smem,
                        cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<c, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The launch of both C entry points: checks e_pad, picks the block shape
// and calls launch(std::integral_constant<int, K>, threads, smem), with
// smem the bytes of one e_pad float buffer, for the K that pick_shape
// chose.  The entry points pass a generic lambda that launches their
// kernel's K instance through launch_rows.
template <typename Launch>
cudaError_t dispatch(int c, int e_pad, Launch&& launch) {
  if (c <= 0) return cudaSuccess;
  if (e_pad <= 0 || e_pad > MAX_E_PAD) return cudaErrorInvalidValue;
  int k, threads;
  pick_shape(e_pad, &k, &threads);
  const size_t smem = (size_t)e_pad * sizeof(float);
  switch (k) {
    case 1: return launch(std::integral_constant<int, 1>(), threads, smem);
    case 2: return launch(std::integral_constant<int, 2>(), threads, smem);
    case 4: return launch(std::integral_constant<int, 4>(), threads, smem);
    case 8: return launch(std::integral_constant<int, 8>(), threads, smem);
    case 16: return launch(std::integral_constant<int, 16>(), threads, smem);
    case 32: return launch(std::integral_constant<int, 32>(), threads, smem);
  }
  return cudaErrorInvalidValue;
}

}  // namespace fifo
