// K1: fused evaluation + exactness certificate over a condensed event
// stream.  One row runs on the warps of one CTA, or, for few rows, on a
// thread-block cluster that splits the row's certificate slots.
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
// plus the final times when `times` is not null.  iters is the row's own
// loop count (the reference counts per row block; nothing reads it).
//
// What bounds it on the H100.  The condensed rows are short (e_pad 128 to
// 3200 on the Stream-HLS designs), so each Jacobi step is a chain of
// latencies: a gather, a segmented scan and two reductions, with barriers
// between.  The bytes are the certificate's: 16 per slot, and a row has 7
// to 60 times more slots than events (v_pad up to ~23k).  At the 512-row
// bucket they are ~90 % of what the launch must read, so there it is bound
// by memory bandwidth; at the main path's 1 or 8 rows the card is nearly
// empty, and one SM alone would read a row's slots after its fixpoint.
//
// What the design does about it:
//  - Rows on warps.  A row of e_pad events runs on a CTA of `warps` warps
//    (one for e_pad <= 1024), each lane owning k consecutive events (k a
//    multiple of 4, at most 32).  With one warp the scan, the convergence
//    test and the max are shuffles and __syncwarp only; several warps
//    (k15mmtree's 3200 events) meet at __syncthreads.  Each CTA freezes
//    on its own.
//  - Operands folded once, kept on chip.  At launch each lane loads its
//    events' ten operands in 16-byte vectors and folds them into one
//    shared-memory gather address and one add per event (the edge that
//    is_read selects; a masked edge reads a cell that always holds 0 and
//    adds NEG, so b = NEG exactly as in the reference), the delta and a bit
//    mask of segment starts, in registers for the whole loop.  Only the
//    row's times move between iterations, in shared memory.
//  - Certificate bytes read wide.  After the fixpoint the lanes stream the
//    CTA's slots from global memory in 16-byte vectors, two groups of four
//    slots in flight at a time.
//  - Few rows spread over the card.  With split > 1, a row runs on a
//    cluster of `split` CTAs.  Each CTA repeats the row's fixpoint (it is
//    cheap, and the CTAs need no times from each other) and checks its own
//    slice of the slots; the verdicts meet in the leader's shared memory,
//    and a cluster barrier keeps the leader resident until every peer has
//    written it.
//
// The shape (warps, k, split) is chosen in Python
// (condensed.py::k1_launch_shape) and checked here.  PERF.md has the
// alternatives that were measured and dropped (rows sharing a CTA, slots
// staged in shared memory or prefetched into L2).  See fifo_step.cuh for
// why the scan's association order does not change any result bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "fifo_step.cuh"

namespace cg = cooperative_groups;

namespace {

using fifo::FULL;
using fifo::NEG;

constexpr int MAX_CTA_THREADS = 256;
constexpr int MAX_WARPS = MAX_CTA_THREADS / 32;   // per CTA, so per row
constexpr int MAX_SPLIT = 16;                     // CTAs per row
constexpr int MAX_K = 32;                         // events per lane
constexpr int MAX_E_PAD = MAX_WARPS * 32 * MAX_K;

struct Shape {
  int warps;  // warps of the row's CTA
  int k;      // events per lane
  int split;  // CTAs per row, each checking one slice of its slots
};

// Slots of each CTA's slice: v_pad / split rounded up to whole 16-byte
// groups (CTA r checks [r * slice, (r + 1) * slice) cut at v_pad).
__host__ __device__ inline int slice_of(int v_pad, int split) {
  const int s = (v_pad + split - 1) / split;
  return (s + 3) & ~3;
}

// Per-row scratch of the cross-warp scan and reductions.
struct RowScratch {
  float a[MAX_WARPS];
  float m[MAX_WARPS];
  float v[MAX_WARPS];
  int c[MAX_WARPS];
};

struct Shared {
  RowScratch row;
  int viol[MAX_SPLIT];           // the leader's: each rank's verdict
};

// The row's times and the zero cell that masked edges read.
size_t dynamic_smem(int e_pad) { return (size_t)(e_pad + 4) * sizeof(float); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// The warps of the row meet: __syncwarp for one warp, else the CTA's
// barrier (warps is the same across the CTA).
__device__ __forceinline__ void row_sync(int warps) {
  if (warps == 1)
    __syncwarp();
  else
    __syncthreads();
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" : : : "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" : : : "memory");
}

// Four slots: whether any is violated.
__device__ __forceinline__ bool violated(const float* t, int4 s, int4 d,
                                         float4 h, float4 v) {
  return (v.x > 0.f && t[s.x] - t[d.x] > h.x) |
         (v.y > 0.f && t[s.y] - t[d.y] > h.y) |
         (v.z > 0.f && t[s.z] - t[d.z] > h.z) |
         (v.w > 0.f && t[s.w] - t[d.w] > h.w);
}

template <int K>
__global__ void __launch_bounds__(MAX_CTA_THREADS)
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
                 int e_pad, int v_pad, int max_iters, float bound,
                 Shape sh) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Shared s;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;          // the warp's index in the row
  const int n_lanes = sh.warps * 32;
  const int l = threadIdx.x;               // the lane's index in the row
  const bool cl = sh.split > 1;
  int rank = 0;
  size_t row = blockIdx.x;
  if (cl) {
    rank = (int)cg::this_cluster().block_rank();
    row = blockIdx.x / sh.split;
    // peers write their verdicts into the leader's shared memory: none may
    // do so before every CTA of the cluster runs (waited for below)
    cluster_arrive();
  }
  RowScratch& rs = s.row;
  float* t = smem;                         // times, then the zero cell

  // 1. t = 0 and the zero cell t[e_pad] that masked edges read
  for (int e = l; e < e_pad + 4; e += n_lanes) t[e] = 0.f;

  // 2. operands, once, folded: gather addresses, adds, deltas, segment
  //    flags.  Lane l owns events [l * K, l * K + K), in groups of four
  //    that lie all below e_pad or all above (e_pad % 4 == 0); an event
  //    above is the scan's identity (a = 0, m = NEG) and is never written.
  const int base = l * K;
  const size_t off = row * (size_t)e_pad;
  const uint32_t zero = smem_u32(&t[e_pad]);
  uint32_t addr[K];
  float ad[K], dl[K];
  unsigned seg = 0;
#pragma unroll
  for (int g = 0; g < K / 4; ++g) {
    const int e0 = base + 4 * g;
    // Keep this a comparison: ptxas 12.9 mis-compiled the equivalent
    // max(0, min(4, e_pad - e0)) == 4 in K2 (it inverted the test).
    const bool own = e0 + 4 <= e_pad;
    float4 dv{}, sg{}, rd{}, hd{}, rl{}, bv{}, bb{};
    int4 di{}, bi{};
    if (own) {
      dv = *reinterpret_cast<const float4*>(delta + e0);
      sg = *reinterpret_cast<const float4*>(segst + e0);
      rd = *reinterpret_cast<const float4*>(is_read + e0);
      hd = *reinterpret_cast<const float4*>(has_data + e0);
      di = *reinterpret_cast<const int4*>(data_idx + e0);
      rl = *reinterpret_cast<const float4*>(rd_lat + off + e0);
      bi = *reinterpret_cast<const int4*>(bp_idx + off + e0);
      bv = *reinterpret_cast<const float4*>(bp_valid + off + e0);
      bb = *reinterpret_cast<const float4*>(bp_base + off + e0);
    }
    const float dvs[4] = {dv.x, dv.y, dv.z, dv.w};
    const float sgs[4] = {sg.x, sg.y, sg.z, sg.w};
    const float rds[4] = {rd.x, rd.y, rd.z, rd.w};
    const float hds[4] = {hd.x, hd.y, hd.z, hd.w};
    const float rls[4] = {rl.x, rl.y, rl.z, rl.w};
    const float bvs[4] = {bv.x, bv.y, bv.z, bv.w};
    const float bbs[4] = {bb.x, bb.y, bb.z, bb.w};
    const int dis[4] = {di.x, di.y, di.z, di.w};
    const int bis[4] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * g + j;
      const bool read = rds[j] > 0.f;
      const bool edge = own && (read ? hds[j] > 0.f : bvs[j] > 0.f);
      const int idx = read ? dis[j] : bis[j];
      addr[k] = edge ? smem_u32(t) + 4u * (uint32_t)idx : zero;
      ad[k] = edge ? (read ? rls[j] : bbs[j]) : NEG;
      dl[k] = own ? dvs[j] : 0.f;
      if (own && sgs[j] > 0.f) seg |= 1u << k;
    }
  }
  row_sync(sh.warps);

  float max_t;
  bool conv, over;
  int iters = 0;
  do {
    // gather from the old t
    float m[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float b = ld_shared(addr[k]) + ad[k];
      m[k] = (seg >> k) & 1 ? fmaxf(b, dl[k]) : b;
    }
    // no lane of the row writes t before every lane has gathered
    row_sync(sh.warps);
    // the chunk's aggregate, then the exclusive prefix over the row
    float A = 0.f, M = NEG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float a = (seg >> k) & 1 ? NEG : dl[k];
      float mk = m[k];
      fifo::combine(A, M, a, mk);
      A = a;
      M = mk;
    }
    fifo::warp_inclusive_scan(A, M, lane);
    float ea = __shfl_up_sync(FULL, A, 1);
    float em = __shfl_up_sync(FULL, M, 1);
    if (lane == 0) {
      ea = 0.f;
      em = NEG;
    }
    if (sh.warps > 1) {
      if (lane == 31) {
        rs.a[w] = A;
        rs.m[w] = M;
      }
      row_sync(sh.warps);
      float pa = 0.f, pm = NEG;
      for (int j = 0; j < w; ++j) {
        float xa = rs.a[j], xm = rs.m[j];
        fifo::combine(pa, pm, xa, xm);
        pa = xa;
        pm = xm;
      }
      fifo::combine(pa, pm, ea, em);
    }
    // the new times, in place; same and max over the lane's events
    A = ea;
    M = em;
    bool same = true;
    float local_max = -CUDART_INF_F;
#pragma unroll
    for (int g = 0; g < K / 4; ++g) {
      float tn[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * g + j;
        float a = (seg >> k) & 1 ? NEG : dl[k];
        float mk = m[k];
        fifo::combine(A, M, a, mk);
        A = a;
        M = mk;
        tn[j] = fmaxf(A, M);
      }
      const int e0 = base + 4 * g;
      if (e0 + 4 <= e_pad) {
        float4* p = reinterpret_cast<float4*>(&t[e0]);
        const float4 old = *p;
        same &= old.x == tn[0] && old.y == tn[1] && old.z == tn[2] &&
                old.w == tn[3];
        *p = make_float4(tn[0], tn[1], tn[2], tn[3]);
        local_max = fmaxf(local_max, fmaxf(fmaxf(tn[0], tn[1]),
                                           fmaxf(tn[2], tn[3])));
      }
    }
    // max(t) and convergence over the row (the barrier also publishes the
    // new t to the next gather)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      local_max = fmaxf(local_max, __shfl_xor_sync(FULL, local_max, o));
    same = __all_sync(FULL, same);
    if (sh.warps > 1) {
      if (lane == 0) {
        rs.v[w] = local_max;
        rs.c[w] = same;
      }
      row_sync(sh.warps);
      for (int j = 0; j < sh.warps; ++j) {
        local_max = fmaxf(local_max, rs.v[j]);
        same &= rs.c[j] != 0;
      }
    } else {
      __syncwarp();
    }
    max_t = local_max;
    conv = same;
    over = max_t > bound;
    ++iters;
  } while (!conv && !over && iters < max_iters);

  // latency = max(t + end_bonus) over the row.  rs.a was last read before
  // the loop's last barrier, so it is free.
  float lat = -CUDART_INF_F;
#pragma unroll
  for (int g = 0; g < K / 4; ++g) {
    const int e0 = base + 4 * g;
    if (e0 + 4 <= e_pad) {
      const float4 tv = *reinterpret_cast<const float4*>(&t[e0]);
      const float4 eb = *reinterpret_cast<const float4*>(end_bonus + e0);
      lat = fmaxf(lat, fmaxf(fmaxf(tv.x + eb.x, tv.y + eb.y),
                             fmaxf(tv.z + eb.z, tv.w + eb.w)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    lat = fmaxf(lat, __shfl_xor_sync(FULL, lat, o));
  if (sh.warps > 1) {
    if (lane == 0) rs.a[w] = lat;
    row_sync(sh.warps);
    for (int j = 0; j < sh.warps; ++j) lat = fmaxf(lat, rs.a[j]);
  }

  // the certificate over this CTA's slice of the row's slots
  const int slice = slice_of(v_pad, sh.split);
  const int lo = min(rank * slice, v_pad);
  const int n_slots = min(lo + slice, v_pad) - lo;
  const size_t voff = row * (size_t)v_pad + lo;
  bool viol = false;
  if (n_slots > 0) {
    const int4* ps = reinterpret_cast<const int4*>(cert_src + voff);
    const int4* pd = reinterpret_cast<const int4*>(cert_dst + voff);
    const float4* ph = reinterpret_cast<const float4*>(cert_thr + voff);
    const float4* pv = reinterpret_cast<const float4*>(cert_valid + voff);
    const int n4 = n_slots / 4;
    for (int g = l; g < n4; g += 2 * n_lanes) {
      const int g2 = g + n_lanes;
      const bool two = g2 < n4;
      const int4 s0 = ps[g], d0 = pd[g];
      const float4 h0 = ph[g], v0 = pv[g];
      int4 s1{}, d1{};
      float4 h1{}, v1{};
      if (two) {
        s1 = ps[g2];
        d1 = pd[g2];
        h1 = ph[g2];
        v1 = pv[g2];
      }
      viol |= violated(t, s0, d0, h0, v0) | violated(t, s1, d1, h1, v1);
    }
  }
  viol = __any_sync(FULL, viol);
  if (sh.warps > 1) {
    // rs.c was last read before the latency's barrier
    if (lane == 0) rs.c[w] = viol;
    row_sync(sh.warps);
    for (int j = 0; j < sh.warps; ++j) viol |= rs.c[j] != 0;
  }
  if (cl) {
    cluster_wait();   // every CTA of the cluster runs
    if (threadIdx.x == 0)
      *cg::this_cluster().map_shared_rank(&s.viol[rank], 0) = viol;
    // release/acquire: the leader sees every verdict, and stays resident
    // until every peer has written it
    cluster_arrive();
    cluster_wait();
    if (rank != 0) return;
    for (int j = 0; j < sh.split; ++j) viol |= s.viol[j] != 0;
  }

  if (l == 0) {
    float* o = out + row * 5;
    o[0] = lat;
    o[1] = conv ? 1.f : 0.f;
    o[2] = over ? 1.f : 0.f;
    o[3] = (float)iters;
    o[4] = (conv && !over && !viol) ? 1.f : 0.f;
  }
  if (times != nullptr) {
#pragma unroll
    for (int g = 0; g < K / 4; ++g) {
      const int e0 = base + 4 * g;
      if (e0 + 4 <= e_pad)
        *reinterpret_cast<float4*>(times + off + e0) =
            *reinterpret_cast<const float4*>(&t[e0]);
    }
  }
}

bool valid_shape(const Shape& sh, int e_pad, int v_pad) {
  const auto pow2 = [](int x) { return x > 0 && (x & (x - 1)) == 0; };
  return sh.k >= 4 && sh.k <= MAX_K && sh.k % 4 == 0 && sh.warps >= 1 &&
         sh.warps <= MAX_WARPS && pow2(sh.split) && sh.split <= MAX_SPLIT &&
         e_pad > 0 && e_pad <= MAX_E_PAD && e_pad % 4 == 0 &&
         e_pad <= sh.warps * 32 * sh.k && v_pad >= 0 && v_pad % 4 == 0;
}

// The launch of condensed_kernel<K> in `sh`'s shape, its attributes set
// and `cfg` filled for a grid of one CTA or cluster (callers widen it).
template <int K>
cudaError_t configure(const Shape& sh, int e_pad, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  auto kern = condensed_kernel<K>;
  const size_t smem = dynamic_smem(e_pad);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  *cfg = {};
  cfg->gridDim = dim3((unsigned)sh.split);
  cfg->blockDim = dim3((unsigned)(sh.warps * 32));
  cfg->dynamicSmemBytes = smem;
  if (sh.split > 1) {
    if (sh.split > 8) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = (unsigned)sh.split;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
  }
  return cudaSuccess;
}

template <int K, typename... Args>
cudaError_t launch(const Shape& sh, int c, int e_pad, int v_pad,
                   cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<K>(sh, e_pad, &cfg, &attr);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3((unsigned)(c * sh.split));
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, condensed_kernel<K>, args..., sh);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of the shape (split > 1) resident at once.
template <int K>
cudaError_t active(const Shape& sh, int e_pad, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<K>(sh, e_pad, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(n, condensed_kernel<K>, &cfg);
}

}  // namespace

// Runs CALL(K) for the shape's K (valid_shape has checked it).
#define K1_BY_K(CALL)   \
  switch (k) {          \
    case 4: CALL(4);    \
    case 8: CALL(8);    \
    case 12: CALL(12);  \
    case 16: CALL(16);  \
    case 20: CALL(20);  \
    case 24: CALL(24);  \
    case 28: CALL(28);  \
    default: CALL(32);  \
  }


// C interface, loaded with ctypes.  Shared operands are (e_pad,), per-row
// operands (c, e_pad), certificate slots (c, v_pad), out (c, 5), times
// (c, e_pad) or null; every pointer 16-byte aligned.  The shape (warps, k,
// split) comes from condensed.py::k1_launch_shape.
// Returns the cudaError_t of the launch (0 on success), and
// cudaErrorInvalidValue for a shape the kernel cannot run, checked before
// anything launches.
extern "C" int fifo_eval_condensed_launch(
    const float* delta, const float* segst, const float* is_read,
    const float* has_data, const int* data_idx, const float* end_bonus,
    const float* rd_lat, const int* bp_idx, const float* bp_valid,
    const float* bp_base, const int* cert_src, const int* cert_dst,
    const float* cert_thr, const float* cert_valid, float* out,
    float* times, int c, int e_pad, int v_pad, int max_iters, float bound,
    int warps, int k, int split, void* stream) {
  const Shape sh{warps, k, split};
  if (!valid_shape(sh, e_pad, v_pad)) return (int)cudaErrorInvalidValue;
  if (c <= 0) return cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
#define K1_LAUNCH(KK)                                                        \
  return (int)launch<KK>(sh, c, e_pad, v_pad, st, delta, segst, is_read,     \
                         has_data, data_idx, end_bonus, rd_lat, bp_idx,      \
                         bp_valid, bp_base, cert_src, cert_dst, cert_thr,    \
                         cert_valid, out, times, e_pad, v_pad, max_iters,    \
                         bound)
  K1_BY_K(K1_LAUNCH);
#undef K1_LAUNCH
}

// How many clusters of the shape (split > 1) can be resident on the
// current device at once: the rows K1 runs in one wave
// (cudaOccupancyMaxActiveClusters).  0 when the device cannot launch that
// cluster size; minus the cudaError_t when a query fails, and minus
// cudaErrorInvalidValue for a shape the kernel cannot run or a split of 1.
extern "C" int fifo_eval_condensed_active(int e_pad, int v_pad, int warps,
                                          int k, int split) {
  const Shape sh{warps, k, split};
  if (split < 2 || !valid_shape(sh, e_pad, v_pad))
    return -(int)cudaErrorInvalidValue;
  int n = 0;
  cudaError_t err;
#define K1_ACTIVE(KK) err = active<KK>(sh, e_pad, &n); break
  K1_BY_K(K1_ACTIVE);
#undef K1_ACTIVE
  if (err != cudaSuccess) {
    cudaGetLastError();
    // a size above the portable 8 that this device does not allow
    if (split > 8) return 0;
    return -(int)err;
  }
  return n;
}
