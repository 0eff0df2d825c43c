// The two small kernels around each K2 and K1 launch of the evaluation
// closures (kernels/fifo_eval/ops.py): the depth operands before the
// fixpoint, and the epilogue after it.
//
// They replace no TPU kernel.  In the reference package the same work is
// plain jnp code that XLA fuses around the Pallas call
// (src/repro/core/backends/operands.py::depth_operands and the closures of
// src/repro/kernels/fifo_eval/ops.py).  Eagerly in PyTorch it was about 60
// operator launches and 3-4 pageable copies a call, which held the host
// longer than K2 held the card (PERF.md); here it is two launches.
//
// depth_operands_kernel: from the (c, n_fifos) depths and the per-event
// tables of GraphOperands, writes the (c, e_pad) read latency, the
// back-pressure gather index, its mask and its add, and the (c,)
// structural-deadlock flag, each equal bit for bit to
// core/backends/operands.py::depth_operands_plain.  Grid (c, blocks a
// row): a block walks a stretch of the row's events; each event gathers
// its FIFO's depth and width (a row's are a few hundred bytes, which stay
// in L1) and one entry of the read table.  The structural flag is an OR
// over the row's events: every block
// ORs its own (__syncthreads_or) and stores 1 where it found a write
// without a partner read, after the flags are cleared on the stream.
//
// eval_epilogue_kernel: from K2's (c, 4) or K1's (c, 5) output, the
// structural flag, the depths and the widths, writes one packed (c, lanes)
// int32 row: [0] latency (float bits, clamped below at taskless_lat),
// [1] BRAM18K count (Algorithm 1 summed over the row's FIFOs), [2] status,
// [3] iterations (float bits), and for K1 [4] certified.  One block a row;
// its threads split the FIFOs and sum their counts.
//
// What bounds them on the H100: the launch.  For 8 rows of 26,496 events
// the operand kernel writes 3.4 MB (about 1 us at 3.35 TB/s) and the
// epilogue reads a few kilobytes; both are a few microseconds beside K2's
// milliseconds.  The design keeps them to one pass over the events each,
// with coalesced loads of the per-event tables and coalesced stores.
//
// Integer arithmetic follows torch's int32 tensors: products, sums and
// differences wrap (computed unsigned), division and remainder are the
// floor forms of torch.div(rounding_mode="floor") and torch.remainder.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// core/bram.py
constexpr int SRL_DEPTH = 2;
constexpr int SRL_BITS = 1024;
constexpr int N_BRAM_CONFIGS = 5;
__constant__ int BRAM_DEPTH[N_BRAM_CONFIGS] = {1024, 2048, 4096, 8192,
                                               16384};
__constant__ int BRAM_WIDTH[N_BRAM_CONFIGS] = {18, 9, 4, 2, 1};
// core/backends/base.py
constexpr int CONVERGED = 0;
constexpr int DEADLOCK = 1;
constexpr int UNRESOLVED = 2;

constexpr int OPERAND_THREADS = 256;
constexpr int OPERAND_EVENTS = 4 * OPERAND_THREADS;  // events a block
constexpr int EPILOGUE_THREADS = 128;

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// A FIFO of depth d and width w is a shift register (no BRAM, one-cycle
// reads) at depth <= SRL_DEPTH or d * w <= SRL_BITS.
__device__ __forceinline__ bool is_srl(int d, int w) {
  return d <= SRL_DEPTH || wrap_mul(d, w) <= SRL_BITS;
}

// Algorithm 1 for one FIFO, step for step as operands.py::bram_count_torch.
__device__ __forceinline__ int bram_count(int d, int w0) {
  int n = 0;
  int w = w0;
#pragma unroll
  for (int i = 0; i < N_BRAM_CONFIGS; ++i) {
    const int d_i = BRAM_DEPTH[i], w_i = BRAM_WIDTH[i];
    n = wrap_add(n, wrap_mul(floor_div(w, w_i),
                             wrap_sub(0, floor_div(wrap_sub(0, d), d_i))));
    w = floor_mod(w, w_i);
    const bool fits = w > 0 && d <= d_i;
    n = wrap_add(n, fits ? 1 : 0);
    if (fits) w = 0;
  }
  return is_srl(d, w0) ? 0 : n;
}

__global__ void __launch_bounds__(OPERAND_THREADS)
depth_operands_kernel(const int* __restrict__ depths, int n_fifos,
                      const int* __restrict__ widths,
                      const int* __restrict__ fifo,
                      const int* __restrict__ rank,
                      const bool* __restrict__ is_write,
                      const int* __restrict__ evt_n_reads,
                      const int* __restrict__ evt_read_base,
                      const int* __restrict__ read_evt_flat,
                      const float* __restrict__ read_off_flat,
                      int n_flat_reads, const float* __restrict__ data_off,
                      int e_pad, float* __restrict__ rd_lat,
                      int* __restrict__ bp_idx, float* __restrict__ bp_valid,
                      float* __restrict__ bp_base, bool* structural) {
  const int row = blockIdx.x;
  const int* d_row = depths + (size_t)row * n_fifos;
  const size_t base = (size_t)row * e_pad;
  const int stop = min(e_pad, (int)(blockIdx.y + 1) * OPERAND_EVENTS);
  bool overrun_any = false;
  for (int e = blockIdx.y * OPERAND_EVENTS + threadIdx.x; e < stop;
       e += blockDim.x) {
    const int f = fifo[e];
    const int d = d_row[f];
    rd_lat[base + e] = (is_srl(d, widths[f]) ? 1.0f : 2.0f) + data_off[e];
    const int pos = wrap_sub(rank[e], d);
    const bool write = is_write[e];
    const bool overrun = write && pos >= evt_n_reads[e];
    overrun_any |= overrun;
    bp_valid[base + e] = (write && pos >= 0 && !overrun) ? 1.0f : 0.0f;
    const int flat =
        min(max(wrap_add(evt_read_base[e], pos), 0), n_flat_reads - 1);
    bp_idx[base + e] = read_evt_flat[flat];
    bp_base[base + e] = read_off_flat[flat] + 1.0f;
  }
  if (__syncthreads_or(overrun_any) && threadIdx.x == 0) structural[row] = true;
}

__global__ void __launch_bounds__(EPILOGUE_THREADS)
eval_epilogue_kernel(const float* __restrict__ out, int out_lanes,
                     const bool* __restrict__ structural,
                     const int* __restrict__ depths, int n_fifos,
                     const int* __restrict__ widths, float taskless_lat,
                     int* __restrict__ packed) {
  __shared__ unsigned warp_sum[EPILOGUE_THREADS / 32];
  const int row = blockIdx.x;
  const int* d_row = depths + (size_t)row * n_fifos;
  unsigned sum = 0;  // int32 sum with wraparound, as torch's
  for (int f = threadIdx.x; f < n_fifos; f += blockDim.x)
    sum += (unsigned)bram_count(d_row[f], widths[f]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x != 0) return;
  sum = 0;
#pragma unroll
  for (int w = 0; w < EPILOGUE_THREADS / 32; ++w) sum += warp_sum[w];
  const float* o = out + (size_t)row * out_lanes;
  // torch.clamp(lat, min=taskless_lat): NaN stays NaN
  const float lat = o[0] < taskless_lat ? taskless_lat : o[0];
  const int status = (structural[row] || o[2] > 0.0f) ? DEADLOCK
                     : o[1] > 0.0f                    ? CONVERGED
                                                      : UNRESOLVED;
  int* p = packed + (size_t)row * out_lanes;
  p[0] = __float_as_int(lat);
  p[1] = (int)sum;
  p[2] = status;
  p[3] = __float_as_int(o[3]);
  if (out_lanes > 4) p[4] = (o[4] > 0.0f && status == CONVERGED) ? 1 : 0;
}

}  // namespace

// C interface, loaded with ctypes.  depths (c, n_fifos) int32, widths
// (n_fifos,) int32, the per-event tables (e_pad,) (is_write one byte an
// event), read_evt_flat / read_off_flat (n_flat_reads,); outputs (c,
// e_pad) and structural (c,) one byte a row.  Returns the cudaError_t of
// the clear or the launch (0 on success), cudaErrorInvalidValue for sizes
// the kernel cannot run.
extern "C" int depth_operands_launch(
    const int* depths, const int* widths, const int* fifo, const int* rank,
    const bool* is_write, const int* evt_n_reads, const int* evt_read_base,
    const int* read_evt_flat, const float* read_off_flat,
    const float* data_off, float* rd_lat, int* bp_idx, float* bp_valid,
    float* bp_base, bool* structural, int c, int n_fifos, int e_pad,
    int n_flat_reads, void* stream) {
  if (c <= 0) return cudaSuccess;
  if (n_fifos <= 0 || e_pad <= 0 || n_flat_reads <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(structural, 0, (size_t)c, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(c, (e_pad + OPERAND_EVENTS - 1) / OPERAND_EVENTS);
  depth_operands_kernel<<<grid, OPERAND_THREADS, 0, s>>>(
      depths, n_fifos, widths, fifo, rank, is_write, evt_n_reads,
      evt_read_base, read_evt_flat, read_off_flat, n_flat_reads, data_off,
      e_pad, rd_lat, bp_idx, bp_valid, bp_base, structural);
  return (int)cudaGetLastError();
}

// out (c, lanes) float32 from K2 (lanes 4) or K1 (lanes 5), structural
// (c,), depths (c, n_fifos) int32, widths (n_fifos,) int32; packed (c,
// lanes) int32.  Returns the cudaError_t of the launch.
extern "C" int eval_epilogue_launch(const float* out, const bool* structural,
                                    const int* depths, const int* widths,
                                    int* packed, int c, int lanes,
                                    int n_fifos, float taskless_lat,
                                    void* stream) {
  if (c <= 0) return cudaSuccess;
  if ((lanes != 4 && lanes != 5) || n_fifos < 0)
    return (int)cudaErrorInvalidValue;
  eval_epilogue_kernel<<<c, EPILOGUE_THREADS, 0, (cudaStream_t)stream>>>(
      out, lanes, structural, depths, n_fifos, widths, taskless_lat, packed);
  return (int)cudaGetLastError();
}
