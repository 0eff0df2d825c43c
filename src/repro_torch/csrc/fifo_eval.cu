// K2: batched FIFO-configuration latency evaluation over the full event
// stream, one thread-block cluster per config row.
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
// Per-design-table mode (cross-design batches; replaces the reference's
// jnp vmap kernels/fifo_eval/ref.py::fifo_eval_ref_hetero on the card):
// when `table_of_row` is not null, the six event tables hold D rows of
// e_pad and row r reads table row table_of_row[r]; when `bounds` is not
// null, row r stops on its own bound bounds[r]; when `bp_base` is null,
// every back-pressure edge adds the raw stream's 1.  Null pointers take
// the shared-table path, unchanged.  Each CTA of a cluster reads its row's
// table index and bound itself, so every CTA takes the same stop
// decision on the cluster-reduced max(t).
//
// What bounds it on the H100: the latency of one row-iteration.  The main
// path sends batches of at most 8 rows and a row runs up to max_iters
// Jacobi steps in sequence, each a gather, a segmented scan and a
// reduction (max and convergence) separated by barriers; the bytes and
// the float operations are far below the card's rates.
//
// What the design does about it:
//  - Each thread owns K consecutive events of its CTA's slice.  It loads
//    their ten operands ONCE per launch (K * 4 contiguous bytes a thread
//    and array, neighbouring threads on neighbouring addresses) and folds
//    them into one gather address and one add per event (the edge that
//    is_read selects: data_idx/rd_lat or bp_idx/bp_base), the delta, and
//    one bit mask of segment starts: 12 bytes an event instead of ~40.
//    The gather address is a 32-bit shared-memory address in the owner
//    CTA (mapa); a masked edge points at a cell that always holds 0 and
//    adds NEG, so b = NEG exactly as in the reference.  The folded
//    operands and the thread's own times stay in registers for the whole
//    loop.  Only t moves between iterations, in shared memory.
//  - One row spreads over a cluster of CL CTAs (Hopper thread-block
//    clusters): CTA r owns events [r * span, (r + 1) * span) with span =
//    threads * K, its slice of t in its shared memory.  A gather outside
//    the slice reads the peer's shared memory (ld.shared::cluster).  The
//    scan is a chunk scan, a block scan of the chunk aggregates and a
//    cluster scan of the CTA aggregates; max(t) and the convergence flag
//    are reduced across the cluster, so every CTA takes the same stop
//    decision.  Jacobi order holds across CTAs: a cluster barrier
//    separates every gather from the first write, and another comes
//    before any CTA exits.
//
// The cluster size, threads and K are chosen in Python
// (fifo_eval.py::k2_launch_shape) and checked here.  See fifo_step.cuh
// for why the scan's association order does not change any result bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "fifo_step.cuh"

namespace cg = cooperative_groups;

namespace {

using fifo::MAX_E_PAD;
using fifo::MAX_THREADS;
using fifo::NEG;

constexpr int MAX_CLUSTER = 16;

// Per-CTA shared scratch besides the times.
struct Shared {
  fifo::Scratch s;   // block scan
  float wm[32];      // per-warp max
  int wc[32];        // per-warp all-same
  float agg_a, agg_m;  // this CTA's inclusive scan aggregate (peers read it)
  float pre_a, pre_m;  // scan prefix of the CTAs before this one
  float red_v;         // this CTA's max (peers read it)
  int red_c;           // this CTA's all-same flag (peers read it)
  float fin_v;         // the cluster's max
  int fin_c;           // the cluster's all-same flag
};

// 32-bit address of `p` in the shared memory of cluster rank `rank`.
__device__ __forceinline__ uint32_t map_rank(const float* p, uint32_t rank) {
  uint32_t local = (uint32_t)__cvta_generic_to_shared(p);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}

template <bool CL>
__device__ __forceinline__ float load_t(uint32_t addr) {
  float v;
  if constexpr (CL)
    asm volatile("ld.shared::cluster.f32 %0, [%1];"
                 : "=f"(v)
                 : "r"(addr)
                 : "memory");
  else
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

template <bool CL>
__device__ __forceinline__ void cluster_barrier() {
  if constexpr (CL)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// Shared-memory object `x` of cluster rank `r` (this CTA's own when CL is
// false).
template <bool CL, typename T>
__device__ __forceinline__ T* peer(T* x, unsigned r) {
  if constexpr (CL)
    return cg::this_cluster().map_shared_rank(x, r);
  else
    return x;
}

// Cluster-wide (max v, all same).  Every thread of every CTA of the
// cluster calls it and gets the same result.  Contains barriers.
template <bool CL>
__device__ __forceinline__ void cluster_reduce(float v, bool same,
                                               Shared& sh, unsigned n_ranks,
                                               float* max_v, bool* all) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(fifo::FULL, v, off));
  same = __all_sync(fifo::FULL, same);
  if (lane == 0) {
    sh.wm[warp] = v;
    sh.wc[warp] = same;
  }
  __syncthreads();
  if (warp == 0) {
    float x = lane < n_warps ? sh.wm[lane] : -CUDART_INF_F;
    bool c = lane < n_warps ? sh.wc[lane] != 0 : true;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x = fmaxf(x, __shfl_xor_sync(fifo::FULL, x, off));
    c = __all_sync(fifo::FULL, c);
    if (lane == 0) {
      sh.red_v = x;
      sh.red_c = c;
    }
  }
  cluster_barrier<CL>();
  if (warp == 0) {
    float x = -CUDART_INF_F;
    bool c = true;
    if (lane < (int)n_ranks) {
      x = *peer<CL>(&sh.red_v, lane);
      c = *peer<CL>(&sh.red_c, lane) != 0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x = fmaxf(x, __shfl_xor_sync(fifo::FULL, x, off));
    c = __all_sync(fifo::FULL, c);
    if (lane == 0) {
      sh.fin_v = x;
      sh.fin_c = c;
    }
  }
  __syncthreads();
  *max_v = sh.fin_v;
  *all = sh.fin_c != 0;
}

// Vector of K 32-bit values, loaded as one access where K * 4 is 8 or 16.
template <typename T, int K>
struct alignas(sizeof(T) * K) Vec {
  T v[K];
};

// x[i, i + K) as one access (zeros when `load` is false).
template <int K, typename T>
__device__ __forceinline__ Vec<T, K> load_vec(const T* x, bool load) {
  Vec<T, K> v{};
  if (load) v = *reinterpret_cast<const Vec<T, K>*>(x);
  return v;
}

template <int K, bool CL>
__global__ void __launch_bounds__(MAX_THREADS)
fifo_eval_kernel(const float* __restrict__ delta,
                 const float* __restrict__ segst,
                 const float* __restrict__ is_read,
                 const float* __restrict__ has_data,
                 const int* __restrict__ data_idx,
                 const float* __restrict__ end_bonus,
                 const float* __restrict__ rd_lat,
                 const int* __restrict__ bp_idx,
                 const float* __restrict__ bp_valid,
                 const float* __restrict__ bp_base, float* __restrict__ out,
                 float* __restrict__ times,
                 const int* __restrict__ table_of_row,
                 const float* __restrict__ bounds, int e_pad, int max_iters,
                 float bound_all, int n_ranks) {
  extern __shared__ __align__(16) float t[];  // span + 1 floats
  __shared__ Shared sh;
  const int span = blockDim.x * K;
  const unsigned rank = CL ? cg::this_cluster().block_rank() : 0;
  const size_t row = blockIdx.x / n_ranks;
  // this row's event tables and bound
  const size_t tab =
      table_of_row != nullptr ? (size_t)table_of_row[row] * e_pad : 0;
  const float bound = bounds != nullptr ? bounds[row] : bound_all;
  const bool unit_bp = bp_base == nullptr;  // back-pressure adds 1
  const int base = (int)rank * span + threadIdx.x * K;  // first event
  // the thread's events are all below e_pad or all above (e_pad % K == 0).
  // Keep this a comparison: ptxas 12.9 mis-compiled the equivalent
  // max(0, min(K, e_pad - base)) == K (it inverted the test).
  const bool own = base + K <= e_pad;

  // t = 0, and the zero cell t[span] that masked edges read
  for (int e = threadIdx.x; e <= span; e += blockDim.x) t[e] = 0.f;

  // operands, once, folded: gather addresses, adds, deltas, segment flags
  uint32_t addr[K];
  float ad[K], dl[K], tk[K];
  unsigned seg = 0;
  {
    const size_t off = row * (size_t)e_pad + base;
    const auto dv = load_vec<K>(delta + tab + base, own);
    const auto sg = load_vec<K>(segst + tab + base, own);
    const auto rd = load_vec<K>(is_read + tab + base, own);
    const auto hd = load_vec<K>(has_data + tab + base, own);
    const auto di = load_vec<K>(data_idx + tab + base, own);
    const auto rl = load_vec<K>(rd_lat + off, own);
    const auto bi = load_vec<K>(bp_idx + off, own);
    const auto bv = load_vec<K>(bp_valid + off, own);
    const auto bb = load_vec<K>(unit_bp ? nullptr : bp_base + off,
                                own && !unit_bp);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool read = rd.v[k] > 0.f;
      const bool edge =
          own && (read ? hd.v[k] > 0.f : bv.v[k] > 0.f);
      const int idx = read ? di.v[k] : bi.v[k];
      const unsigned owner = edge ? (unsigned)(idx / span) : rank;
      const float* cell = edge ? &t[idx - (int)owner * span] : &t[span];
      addr[k] = CL ? map_rank(cell, owner)
                   : (uint32_t)__cvta_generic_to_shared(cell);
      ad[k] = edge ? (read ? rl.v[k] : unit_bp ? 1.f : bb.v[k]) : NEG;
      dl[k] = dv.v[k];
      // events past e_pad open segments of their own, and stay at t = 0
      if (!own || sg.v[k] > 0.f) seg |= 1u << k;
      tk[k] = 0.f;
    }
  }
  // every CTA of the cluster has started and zeroed its t
  cluster_barrier<CL>();

  float max_t = 0.f;
  bool conv = false;
  int iters = 0;
  while (true) {
    // 1. gather from the old t (own and peer slices)
    float m[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float b = load_t<CL>(addr[k]) + ad[k];
      m[k] = (seg >> k) & 1 ? fmaxf(b, dl[k]) : b;
    }
    // 2. no CTA writes t before every CTA has gathered
    cluster_barrier<CL>();
    // 3. chunk aggregate, block scan, cluster scan of the CTA aggregates
    float A = 0.f, M = NEG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float a = (seg >> k) & 1 ? NEG : dl[k];
      float mk = m[k];
      fifo::combine(A, M, a, mk);
      A = a;
      M = mk;
    }
    const float own_a = A, own_m = M;
    fifo::block_exclusive_scan(A, M, sh.s);
    if (threadIdx.x == blockDim.x - 1) {
      float ia = own_a, im = own_m;
      fifo::combine(A, M, ia, im);
      sh.agg_a = ia;
      sh.agg_m = im;
    }
    if constexpr (CL) {
      cluster_barrier<CL>();
      if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        float pa = 0.f, pm = NEG;
        if (lane < (int)rank) {
          pa = *peer<CL>(&sh.agg_a, lane);
          pm = *peer<CL>(&sh.agg_m, lane);
        }
        fifo::warp_inclusive_scan(pa, pm, lane);
        if (lane == 31) {
          sh.pre_a = pa;
          sh.pre_m = pm;
        }
      }
      __syncthreads();
      float pa = sh.pre_a, pm = sh.pre_m;
      fifo::combine(pa, pm, A, M);
    }
    // 4. the new times, into registers and this CTA's slice of t
    bool same = true;
    float local_max = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float a = (seg >> k) & 1 ? NEG : dl[k];
      float mk = m[k];
      fifo::combine(A, M, a, mk);
      A = a;
      M = mk;
      const float tn = fmaxf(A, M);
      same &= tn == tk[k];
      tk[k] = tn;
      if (own) local_max = fmaxf(local_max, tn);
    }
    Vec<float, K> nv;
#pragma unroll
    for (int k = 0; k < K; ++k) nv.v[k] = tk[k];
    *reinterpret_cast<Vec<float, K>*>(&t[threadIdx.x * K]) = nv;
    // 5. max(t) and convergence over the cluster (its barrier also
    //    publishes the new t to the next gather)
    bool all_same;
    cluster_reduce<CL>(local_max, same, sh, n_ranks, &max_t, &all_same);
    // the first step is never marked converged
    conv = iters > 0 && all_same;
    ++iters;
    if (conv || iters >= max_iters || max_t > bound) break;
  }

  // The last reduction's peers may still be reading this CTA's red_v and
  // red_c, which the latency reduction below writes again.  Inside the
  // loop the next step's barrier 2 holds that write back; here, this one.
  cluster_barrier<CL>();

  // latency = max(t + end_bonus) over the row
  float v = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (own) v = fmaxf(v, tk[k] + end_bonus[tab + base + k]);
  float lat;
  bool unused;
  cluster_reduce<CL>(v, true, sh, n_ranks, &lat, &unused);
  if (rank == 0 && threadIdx.x == 0) {
    float* o = out + row * 4;
    o[0] = lat;
    o[1] = conv ? 1.f : 0.f;
    o[2] = max_t > bound ? 1.f : 0.f;
    o[3] = (float)iters;
  }
  if (times != nullptr) {
    float* tr = times + row * (size_t)e_pad;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (own) tr[base + k] = tk[k];
  }
  // no CTA leaves while a peer may still read its shared memory
  cluster_barrier<CL>();
}

// The launch of fifo_eval_kernel<K, CL> on clusters of `cluster` CTAs
// (CL: cluster > 1) of `threads` threads: its attributes set and `cfg`
// filled for a grid of one cluster (launch() widens it to the rows).
template <int K, bool CL>
cudaError_t configure(int cluster, int threads, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  auto kern = fifo_eval_kernel<K, CL>;
  const size_t smem = ((size_t)threads * K + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  *cfg = {};
  cfg->gridDim = dim3((unsigned)cluster);
  cfg->blockDim = dim3((unsigned)threads);
  cfg->dynamicSmemBytes = smem;
  if (CL) {
    if (cluster > 8) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = (unsigned)cluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
  }
  return cudaSuccess;
}

template <int K, bool CL, typename... Args>
cudaError_t launch(int c, int cluster, int threads, cudaStream_t stream,
                   Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<K, CL>(cluster, threads, &cfg, &attr);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3((unsigned)(c * cluster));
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, fifo_eval_kernel<K, CL>, args..., cluster);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of the launch shape resident on the current device at once;
// for a cluster of one CTA, the CTAs per SM times the SMs.
template <int K>
cudaError_t active_clusters(int cluster, int threads, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (cluster > 1) {
    cudaError_t err = configure<K, true>(cluster, threads, &cfg, &attr);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(n, fifo_eval_kernel<K, true>,
                                          &cfg);
  }
  cudaError_t err = configure<K, false>(1, threads, &cfg, &attr);
  int dev = 0, n_sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fifo_eval_kernel<K, false>, threads, cfg.dynamicSmemBytes);
  *n = per_sm * n_sms;
  return err;
}

bool valid_shape(int cluster, int threads, int k) {
  const bool pow2 = cluster > 0 && (cluster & (cluster - 1)) == 0;
  return pow2 && cluster <= MAX_CLUSTER && threads >= 32 &&
         threads <= MAX_THREADS && threads % 32 == 0 &&
         (k == 1 || k == 2 || k == 4);
}

}  // namespace

// C interface, loaded with ctypes.  Shared operands are (e_pad,), per-row
// operands (c, e_pad), out (c, 4), times (c, e_pad) or null; e_pad a
// multiple of 4 (so a thread's events are all below e_pad or all above).
// table_of_row (c,) or null: the shared operands are then (D, e_pad) and
// row r reads row table_of_row[r] of them (each in [0, D), which the
// caller checks); bounds (c,) or null: row r's own bound, else `bound`;
// bp_base null: every back-pressure edge adds 1.
// cluster, threads and k from fifo_eval.py::k2_launch_shape.
// Returns the cudaError_t of the launch (0 on success), and
// cudaErrorInvalidValue for a shape the kernel cannot run, checked before
// anything launches.
extern "C" int fifo_eval_launch(const float* delta, const float* segst,
                                const float* is_read, const float* has_data,
                                const int* data_idx, const float* end_bonus,
                                const float* rd_lat, const int* bp_idx,
                                const float* bp_valid, const float* bp_base,
                                float* out, float* times,
                                const int* table_of_row,
                                const float* bounds, int c, int e_pad,
                                int max_iters, float bound, int cluster,
                                int threads, int k, void* stream) {
  if (c <= 0) return cudaSuccess;
  if (e_pad <= 0 || e_pad > MAX_E_PAD || e_pad % 4 != 0 ||
      !valid_shape(cluster, threads, k) ||
      (long long)threads * k * cluster < e_pad)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // a cluster of one CTA takes the instance without cluster barriers and
  // DSMEM loads, which is faster (PERF.md)
#define FIFO_EVAL_LAUNCH(KK)                                                 \
  return (int)(cluster == 1 ? launch<KK, false>(c, 1, threads, s, ARGS)      \
                            : launch<KK, true>(c, cluster, threads, s, ARGS))
#define ARGS                                                                 \
  delta, segst, is_read, has_data, data_idx, end_bonus, rd_lat, bp_idx,      \
      bp_valid, bp_base, out, times, table_of_row, bounds, e_pad, max_iters, \
      bound
  switch (k) {
    case 1: FIFO_EVAL_LAUNCH(1);
    case 2: FIFO_EVAL_LAUNCH(2);
    default: FIFO_EVAL_LAUNCH(4);
  }
#undef ARGS
#undef FIFO_EVAL_LAUNCH
}

// How many clusters of `cluster` CTAs of `threads` threads and `k` events
// each can be resident on the current device at once
// (cudaOccupancyMaxActiveClusters): the rows K2 runs in one wave.  0 when
// the device cannot launch that cluster size; minus the cudaError_t when a
// query fails, and minus cudaErrorInvalidValue for a shape the kernel
// cannot run.
extern "C" int fifo_eval_active_clusters(int cluster, int threads, int k) {
  if (!valid_shape(cluster, threads, k))
    return -(int)cudaErrorInvalidValue;
  int n = 0;
  cudaError_t err = k == 1   ? active_clusters<1>(cluster, threads, &n)
                    : k == 2 ? active_clusters<2>(cluster, threads, &n)
                             : active_clusters<4>(cluster, threads, &n);
  if (err != cudaSuccess) {
    cudaGetLastError();
    // a size above the portable 8 that this device does not allow
    if (cluster > 8) return 0;
    return -(int)err;
  }
  return n;
}
