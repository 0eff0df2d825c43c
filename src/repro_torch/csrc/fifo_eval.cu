// K2: batched FIFO-configuration latency evaluation over the full event
// stream, one thread block per config row.
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/fifo_eval/fifo_eval.py::_fifo_eval_kernel.
//
// Per row: t = step(0) with iters = 1, then step while the row has not
// converged, iters < max_iters and max(t) <= bound (checked BEFORE each
// step, as the reference's while-loop condition does).  Output row
// [max(t + end_bonus), converged, over_bound, iters] (float32), plus the
// final times when `times` is not null.
//
// What bounds it on the H100: not the bytes of the per-row operands
// (rd_lat, bp_idx, bp_valid, bp_base: 16 bytes an event, read once from
// device memory and then from L1/L2), but the serial depth of the
// data-dependent iteration count: every iteration is a gather of two
// shared-memory times per event, a block-wide scan and two block-wide
// reductions, each ending in a barrier, and a row takes as many
// iterations as its longest chain of back-pressure waves.
//
// What this simple design does about it: the row's times stay in shared
// memory for the whole loop (one e_pad buffer, at most 128 KB at the
// largest e_pad of 32768; no double buffer, which would not fit), so the
// gathers never touch device memory; the scan is a register-resident
// chunk scan plus one warp-shuffle scan per block.  Rows run on separate
// blocks, so a batch of C rows fills the card once C is a few hundred.

#include <cuda_runtime.h>

#include "fifo_step.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(fifo::MAX_THREADS)
fifo_eval_kernel(const float* __restrict__ delta,
                 const float* __restrict__ segst,
                 const float* __restrict__ is_read,
                 const float* __restrict__ has_data,
                 const int* __restrict__ data_idx,
                 const float* __restrict__ end_bonus,
                 const float* __restrict__ rd_lat,
                 const int* __restrict__ bp_idx,
                 const float* __restrict__ bp_valid,
                 const float* __restrict__ bp_base,
                 float* __restrict__ out, float* __restrict__ times,
                 int e_pad, int max_iters, float bound) {
  extern __shared__ float t[];
  __shared__ fifo::Scratch s;
  const size_t row = blockIdx.x;
  const size_t off = row * (size_t)e_pad;
  fifo::RowOperands op{delta,       segst,        is_read,
                       has_data,    data_idx,     end_bonus,
                       rd_lat + off, bp_idx + off, bp_valid + off,
                       bp_base + off};
  for (int e = threadIdx.x; e < e_pad; e += blockDim.x) t[e] = 0.f;
  __syncthreads();

  float max_t;
  fifo::step<K>(t, op, e_pad, s, &max_t);
  int iters = 1;
  bool conv = false;
  while (!conv && iters < max_iters && max_t <= bound) {
    conv = fifo::step<K>(t, op, e_pad, s, &max_t);
    ++iters;
  }
  const float lat = fifo::latency(t, op, e_pad, s);
  if (threadIdx.x == 0) {
    float* o = out + row * 4;
    o[0] = lat;
    o[1] = conv ? 1.f : 0.f;
    o[2] = max_t > bound ? 1.f : 0.f;
    o[3] = (float)iters;
  }
  if (times != nullptr)
    for (int e = threadIdx.x; e < e_pad; e += blockDim.x)
      times[off + e] = t[e];
}

}  // namespace

// C interface, loaded with ctypes.  Shared operands are (e_pad,), per-row
// operands (c, e_pad), out (c, 4), times (c, e_pad) or null.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fifo_eval_launch(const float* delta, const float* segst,
                                const float* is_read, const float* has_data,
                                const int* data_idx, const float* end_bonus,
                                const float* rd_lat, const int* bp_idx,
                                const float* bp_valid, const float* bp_base,
                                float* out, float* times, int c, int e_pad,
                                int max_iters, float bound, void* stream) {
  return (int)fifo::dispatch(
      c, e_pad, [&](auto k, int threads, size_t smem) {
        return fifo::launch_rows(
            fifo_eval_kernel<decltype(k)::value>, c, threads, smem,
            (cudaStream_t)stream, delta, segst, is_read, has_data, data_idx,
            end_bonus, rd_lat, bp_idx, bp_valid, bp_base, out, times, e_pad,
            max_iters, bound);
      });
}
