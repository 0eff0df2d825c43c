// K1: fused evaluation + exactness certificate over a condensed event
// stream, one thread block per config row.
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/fifo_eval/condensed.py::_condensed_kernel.
//
// Per row: one step from zeros, then step while the row is active (not
// converged, not over the bound) and iters < max_iters; converged and
// over_bound are updated AFTER each step (the reference's per-row
// freezing).  Then the certificate: slot v is violated when
// valid[v] > 0 and t[src[v]] - t[dst[v]] > thr[v];
// certified = converged & !over_bound & no violated slot.  Output row
// [max(t + end_bonus), converged, over_bound, iters, certified] (float32),
// plus the final times when `times` is not null.  iters is this block's
// loop count, i.e. the row's own (the reference counts per row block).
//
// What bounds it on the H100: the condensed rows are short (e_pad 128 to
// 3200 on the Stream-HLS designs), so the per-row operand bytes (16 bytes
// an event plus 16 bytes a certificate slot, v_pad up to ~23k) are small;
// the serial depth of the data-dependent iteration count, each iteration
// a few block barriers, bounds it, and at small batches (the optimizers
// send 8 rows) the card is mostly idle because only C blocks exist.
//
// What this simple design does about it: times stay in shared memory for
// the whole loop and the certificate; the certificate gathers read shared
// memory, so the event times never leave the block and a fully
// certifying batch is one launch with no event-time transfer to the host.

#include <cuda_runtime.h>

#include "fifo_step.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(fifo::MAX_THREADS)
condensed_kernel(const float* __restrict__ delta,
                 const float* __restrict__ segst,
                 const float* __restrict__ is_read,
                 const float* __restrict__ has_data,
                 const int* __restrict__ data_idx,
                 const float* __restrict__ end_bonus,
                 const float* __restrict__ rd_lat,
                 const int* __restrict__ bp_idx,
                 const float* __restrict__ bp_valid,
                 const float* __restrict__ bp_base,
                 const int* __restrict__ cert_src,
                 const int* __restrict__ cert_dst,
                 const float* __restrict__ cert_thr,
                 const float* __restrict__ cert_valid,
                 float* __restrict__ out, float* __restrict__ times,
                 int e_pad, int v_pad, int max_iters, float bound) {
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
  bool conv = fifo::step<K>(t, op, e_pad, s, &max_t);
  bool over = max_t > bound;
  int iters = 1;
  while (!conv && !over && iters < max_iters) {
    conv = fifo::step<K>(t, op, e_pad, s, &max_t);
    over = max_t > bound;
    ++iters;
  }

  // fused certificate over this row's slots
  const size_t voff = row * (size_t)v_pad;
  bool viol = false;
  for (int v = threadIdx.x; v < v_pad; v += blockDim.x) {
    const size_t i = voff + v;
    if (cert_valid[i] > 0.f && t[cert_src[i]] - t[cert_dst[i]] > cert_thr[i])
      viol = true;
  }
  const bool any_viol = __syncthreads_or(viol);
  const float lat = fifo::latency(t, op, e_pad, s);
  if (threadIdx.x == 0) {
    float* o = out + row * 5;
    o[0] = lat;
    o[1] = conv ? 1.f : 0.f;
    o[2] = over ? 1.f : 0.f;
    o[3] = (float)iters;
    o[4] = (conv && !over && !any_viol) ? 1.f : 0.f;
  }
  if (times != nullptr)
    for (int e = threadIdx.x; e < e_pad; e += blockDim.x)
      times[off + e] = t[e];
}

}  // namespace

// C interface, loaded with ctypes.  Shared operands are (e_pad,), per-row
// operands (c, e_pad), certificate slots (c, v_pad), out (c, 5), times
// (c, e_pad) or null.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int fifo_eval_condensed_launch(
    const float* delta, const float* segst, const float* is_read,
    const float* has_data, const int* data_idx, const float* end_bonus,
    const float* rd_lat, const int* bp_idx, const float* bp_valid,
    const float* bp_base, const int* cert_src, const int* cert_dst,
    const float* cert_thr, const float* cert_valid, float* out,
    float* times, int c, int e_pad, int v_pad, int max_iters, float bound,
    void* stream) {
  if (v_pad < 0) return (int)cudaErrorInvalidValue;
  return (int)fifo::dispatch(
      c, e_pad, [&](auto k, int threads, size_t smem) {
        return fifo::launch_rows(
            condensed_kernel<decltype(k)::value>, c, threads, smem,
            (cudaStream_t)stream, delta, segst, is_read, has_data, data_idx,
            end_bonus, rd_lat, bp_idx, bp_valid, bp_base, cert_src, cert_dst,
            cert_thr, cert_valid, out, times, e_pad, v_pad, max_iters, bound);
      });
}
