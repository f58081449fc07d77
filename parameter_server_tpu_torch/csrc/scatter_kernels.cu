// Row kernels of the parameter-server tables, hand-written for Hopper (sm_90a).
//
// They replace the four Pallas kernels of parameter_server_tpu/ops/scatter.py:
//   ps_gather      <- _gather_kernel       / _pallas_gather       out_p[k] = table_p[ids[k]]
//   ps_scatter_set <- _scatter_set_kernel  / _pallas_scatter_set  table_p[ids[k]] = rows_p[k]
//   ps_scatter_add <- _scatter_add_kernel  / _pallas_scatter_add  table[ids[k]] += rows[k]
//   ps_apply       <- _apply_kernel        / _pallas_apply        fused gather -> rule -> scatter
// and ps_segment_sum, which replaces none (see its section): the dense LR
// step's per-row gradient sums over its sorted positions.
//
// Contract shared with the Pallas kernels: float32 tables of shape
// [rows + 1, dim] (the last row is the trash row), int32 ids that are unique
// except for bucket pads, which all point at the trash row.  Unlike the Pallas
// kernels these accept any dim (the LR table has dim = 1) and compute row
// offsets in int64 (ids[k] * dim overflows int32 once rows * dim >= 2^31).
// Ids that fall outside [0, table_rows) are skipped (gather writes NaN there)
// rather than faulting.
//
// Bound: every kernel moves each touched row once and does at most a few
// flops per element, so it is bound by device-memory bytes (3.35 TB/s on an
// H100 SXM): gather and scatter-set read ids and one row and write one row
// per id and plane; scatter-add also reads the table row; apply reads and
// writes the value and each state plane and reads the gradient.  At the LR
// table's dim 1 a request moves well under a megabyte, which the card could
// move in ~0.1-0.3 us, far below one launch (~1 us): there the design aims at
// fewer dependent round trips per thread, and fewer launches.
//
// Gather, scatter-set and scatter-add are one row-move kernel in three modes
// (Move); gather and scatter-set take up to 4 planes that share the ids (a
// value table and its state planes) in one launch and read each id once.
// Every kernel has three forms:
//   - dim 1: each thread takes 4 consecutive ids with one int4 load and
//     moves the 4 rows' list side (gathered rows, rows to write, gradients)
//     as float4.  All table loads of the 4 rows are issued before any is
//     used.  The tail of the id list is masked.  Small blocks (64 threads)
//     spread a short id list over every SM.
//   - dim % 4 == 0: a group of lanes (a power of two, at most a warp) shares a
//     row and moves it as float4, loading the row's id once.  Each group keeps
//     R rows in flight: all loads of the R rows (for scatter-add: the table
//     rows and the update rows; for apply: the value, every state plane and
//     the gradient) are issued before any store, the register form of the
//     Pallas kernel's "start block i+1's DMAs before waiting on block i".
//     Consecutive groups take consecutive rows, so ids and the list side move
//     coalesced.
//   - any other width, or a pointer that is not 16-byte aligned: the same row
//     kernel with float lanes.
// Row offsets are computed in int64 once per row; nothing divides per element.
//
// Trash row: ps_apply neither loads nor stores a row whose id is the trash row
// (table_rows - 1), so bucket pads cost nothing and the trash row keeps its
// fill.  scatter_set writes identical rows there and scatter_add adds exact
// zeros, so their races on it are benign.  No kernel uses atomics: results
// are bitwise deterministic, and scatter-add needs unique ids (the wrapper
// merges duplicates before the launch).
//
// Every entry point is a plain C function: pointers and the stream arrive as
// void*, it launches on the caller's stream without synchronising, and it
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIds = 4;            // dim-1 kernels: ids per thread
constexpr int kThreads1 = 64;      // dim-1 kernels: a short id list spreads over every SM
constexpr int kMoveRows = 4;       // rows in flight per lane group, row moves
constexpr int kMaxPlanes = 4;      // the value and at most 3 state planes

// Read once; a function-local static is initialised thread-safely, and the
// kernels launch from several host threads (the Van's receive threads).
int sm_count() {
  static const int count = [] {
    int dev = 0;
    int c = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        c <= 0) {
      return 132;
    }
    return c;
  }();
  return count;
}

// Blocks for `items` work items at `per_block` items a block: every item
// covered, at most `per_sm` blocks on each SM (the rest by a grid-stride loop).
int blocks_for(int64_t items, int64_t per_block, int per_sm) {
  int64_t blocks = (items + per_block - 1) / per_block;
  const int64_t cap = static_cast<int64_t>(sm_count()) * per_sm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks);
}

// log2 of the lanes that share a row: the largest power of two that is at
// most the row's vector count and at most a warp.
int lane_shift_for(int64_t row_vecs) {
  int s = 0;
  while (s < 5 && (int64_t{2} << s) <= row_vecs) ++s;
  return s;
}

__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

template <typename V>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kWidth = 1;
  __device__ static float nan() { return NAN; }
  __device__ static float add(float a, float b) { return a + b; }
};
template <>
struct Vec<float4> {
  static constexpr int kWidth = 4;
  __device__ static float4 nan() { return make_float4(NAN, NAN, NAN, NAN); }
  __device__ static float4 add(const float4& a, const float4& b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};

// K consecutive elements moved by one vector load or store (K = 4: int4 or
// float4).
template <typename T, int K>
struct alignas(sizeof(T) * K) Pack {
  T v[K];
};

// Plane p of a row move.  Gather: tab[p] is read at the ids and list[p] is
// written at the list positions.  Scatter-set / -add: list[p] is read and
// tab[p] written (for add also read).
struct Planes {
  float* tab[kMaxPlanes];
  float* list[kMaxPlanes];
};

struct ApplyPlanes {
  float* plane[1 + 3];  // value, then the state planes
  const float* grads;
};

struct Hyper {
  float lr, l1, l2, eps;
  float beta1, one_minus_beta1, beta2, one_minus_beta2;
  float ftrl_alpha, ftrl_beta;
};

enum Kind { kSgd = 0, kAdagrad = 1, kAdam = 2, kFtrl = 3 };

// state planes each optimizer keeps, in sorted-name order (s0, s1, s2)
template <int KIND>
__host__ __device__ constexpr int state_planes() {
  return KIND == kSgd ? 0 : (KIND == kAdam ? 3 : 1);
}

// rows in flight per lane group, apply: Adam keeps 5 vectors a row
template <int KIND>
__host__ __device__ constexpr int apply_rows() {
  return KIND == kAdam ? 2 : 4;
}

// -- row moves: gather, scatter-set, scatter-add ----------------------------

enum Move { kGather = 0, kSet = 1, kAdd = 2 };

// dim 1: K consecutive ids a thread; ids and the list planes 16-byte aligned.
template <int MOVE, int NP, int K>
__global__ void __launch_bounds__(kThreads1)
    move_dim1_kernel(Planes p, const int32_t* __restrict__ ids, int64_t n,
                     int64_t table_rows) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x * K;
  for (int64_t k0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * K;
       k0 < n; k0 += stride) {
    if (k0 + K <= n) {
      const Pack<int32_t, K> id = *reinterpret_cast<const Pack<int32_t, K>*>(ids + k0);
      bool ok[K];
#pragma unroll
      for (int j = 0; j < K; ++j) ok[j] = id.v[j] >= 0 && id.v[j] < table_rows;
      Pack<float, K> x[NP];
      if constexpr (MOVE == kGather) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
#pragma unroll
          for (int pl = 0; pl < NP; ++pl) x[pl].v[j] = ok[j] ? p.tab[pl][id.v[j]] : NAN;
        }
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) {
          *reinterpret_cast<Pack<float, K>*>(p.list[pl] + k0) = x[pl];
        }
      } else {
        float y[NP][K];  // scatter-add: the table rows, all loaded before any store
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) {
          x[pl] = *reinterpret_cast<const Pack<float, K>*>(p.list[pl] + k0);
          if constexpr (MOVE == kAdd) {
#pragma unroll
            for (int j = 0; j < K; ++j) y[pl][j] = ok[j] ? p.tab[pl][id.v[j]] : 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if (!ok[j]) continue;
#pragma unroll
          for (int pl = 0; pl < NP; ++pl) {
            if constexpr (MOVE == kAdd) {
              p.tab[pl][id.v[j]] = y[pl][j] + x[pl].v[j];
            } else {
              p.tab[pl][id.v[j]] = x[pl].v[j];
            }
          }
        }
      }
    } else {
      for (int64_t k = k0; k < n; ++k) {
        const int64_t id = ids[k];
        const bool ok = id >= 0 && id < table_rows;
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) {
          if constexpr (MOVE == kGather) {
            p.list[pl][k] = ok ? p.tab[pl][id] : NAN;
          } else if (ok) {
            p.tab[pl][id] = MOVE == kAdd ? p.tab[pl][id] + p.list[pl][k] : p.list[pl][k];
          }
        }
      }
    }
  }
}

// Any dim: 2^lane_shift lanes a row, R rows in flight per lane group; a row
// is row_vecs vectors of V.
template <int MOVE, typename V, int NP, int R>
__global__ void __launch_bounds__(kThreads)
    move_rows_kernel(Planes p, const int32_t* __restrict__ ids, int64_t n,
                     int64_t row_vecs, int64_t table_rows, int lane_shift) {
  const int lanes = 1 << lane_shift;
  const int lane = threadIdx.x & (lanes - 1);
  const int64_t groups = blockDim.x >> lane_shift;
  const int64_t group = threadIdx.x >> lane_shift;
  const int64_t tile_rows = groups * R;
  for (int64_t tile = blockIdx.x * tile_rows; tile < n; tile += gridDim.x * tile_rows) {
    int64_t toff[R], loff[R];  // vector offsets of the table row and the list row
    bool ok[R], live[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t k = tile + j * groups + group;
      live[j] = k < n;
      const int64_t id = live[j] ? ids[k] : -1;
      ok[j] = id >= 0 && id < table_rows;
      toff[j] = id * row_vecs;
      loff[j] = k * row_vecs;
    }
    for (int64_t c = lane; c < row_vecs; c += lanes) {
      V x[NP][R];
      V y[NP][R];  // scatter-add: the table rows
#pragma unroll
      for (int j = 0; j < R; ++j) {
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) {
          if constexpr (MOVE == kGather) {
            x[pl][j] = ok[j] ? reinterpret_cast<const V*>(p.tab[pl])[toff[j] + c]
                             : Vec<V>::nan();
          } else if (ok[j]) {
            x[pl][j] = reinterpret_cast<const V*>(p.list[pl])[loff[j] + c];
            if constexpr (MOVE == kAdd) {
              y[pl][j] = reinterpret_cast<const V*>(p.tab[pl])[toff[j] + c];
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (MOVE == kGather ? !live[j] : !ok[j]) continue;
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) {
          if constexpr (MOVE == kGather) {
            reinterpret_cast<V*>(p.list[pl])[loff[j] + c] = x[pl][j];
          } else if constexpr (MOVE == kAdd) {
            reinterpret_cast<V*>(p.tab[pl])[toff[j] + c] = Vec<V>::add(y[pl][j], x[pl][j]);
          } else {
            reinterpret_cast<V*>(p.tab[pl])[toff[j] + c] = x[pl][j];
          }
        }
      }
    }
  }
}

// -- apply -----------------------------------------------------------------

// One optimizer step on one element, in registers; mirrors kv/optim.py
// operation by operation (the build passes -fmad=false so no multiply-add is
// contracted and each operation rounds as the plain version's does).  s0..s2
// are the state planes in sorted-name order.
template <int KIND>
__device__ __forceinline__ void rule(float& v, float& s0, float& s1, float& s2, float grad,
                                     const Hyper& h) {
  if (KIND == kSgd) {
    const float g = grad + h.l2 * v;
    v = v - h.lr * g;
  } else if (KIND == kAdagrad) {  // s0 = sum_sq
    const float g = grad + h.l2 * v;
    const float sum_sq = s0 + g * g;
    const float lr = h.lr / (sqrtf(sum_sq) + h.eps);
    float nv = v - lr * g;
    if (h.l1 > 0.f) nv = sign_of(nv) * fmaxf(fabsf(nv) - lr * h.l1, 0.f);
    v = nv;
    s0 = sum_sq;
  } else if (KIND == kAdam) {  // s0 = m, s1 = t, s2 = v
    const float g = grad + h.l2 * v;
    const float t = s1 + 1.f;
    const float m = h.beta1 * s0 + h.one_minus_beta1 * g;
    const float vv = h.beta2 * s2 + h.one_minus_beta2 * g * g;
    const float m_hat = m / (1.f - powf(h.beta1, t));
    const float v_hat = vv / (1.f - powf(h.beta2, t));
    v = v - h.lr * m_hat / (sqrtf(v_hat) + h.eps);
    s0 = m;
    s1 = t;
    s2 = vv;
  } else {  // kFtrl: v = z, s0 = n; the lazy weight is computed inline
    const float z = v;
    const float n = s0;
    const float w_raw =
        -(z - sign_of(z) * h.l1) / ((h.ftrl_beta + sqrtf(n)) / h.ftrl_alpha + h.l2);
    const float w = (fabsf(z) <= h.l1) ? 0.f : w_raw;
    const float sigma = (sqrtf(n + grad * grad) - sqrtf(n)) / h.ftrl_alpha;
    v = z + grad - sigma * w;
    s0 = n + grad * grad;
  }
}

// The same step on four neighbouring elements of a row.
template <int KIND>
__device__ __forceinline__ void rule(float4& v, float4& s0, float4& s1, float4& s2,
                                     const float4& g, const Hyper& h) {
  rule<KIND>(v.x, s0.x, s1.x, s2.x, g.x, h);
  rule<KIND>(v.y, s0.y, s1.y, s2.y, g.y, h);
  rule<KIND>(v.z, s0.z, s1.z, s2.z, g.z, h);
  rule<KIND>(v.w, s0.w, s1.w, s2.w, g.w, h);
}

// dim 1: K consecutive ids a thread; ids and grads 16-byte aligned.  Only
// ids in [0, live_rows) are touched: the trash row (live_rows) and anything
// out of range are neither loaded nor stored.
template <int KIND, int K>
__global__ void __launch_bounds__(kThreads1)
    apply_dim1_kernel(ApplyPlanes p, const int32_t* __restrict__ ids, int64_t n,
                      int64_t live_rows, Hyper h) {
  constexpr int S = state_planes<KIND>();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x * K;
  for (int64_t k0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * K;
       k0 < n; k0 += stride) {
    Pack<int32_t, K> id;
    Pack<float, K> g;
    if (k0 + K <= n) {
      id = *reinterpret_cast<const Pack<int32_t, K>*>(ids + k0);
      g = *reinterpret_cast<const Pack<float, K>*>(p.grads + k0);
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const bool in = k0 + j < n;
        id.v[j] = in ? ids[k0 + j] : -1;
        g.v[j] = in ? p.grads[k0 + j] : 0.f;
      }
    }
    bool ok[K];
    float x[1 + 3][K] = {};
#pragma unroll
    for (int j = 0; j < K; ++j) {
      ok[j] = id.v[j] >= 0 && id.v[j] < live_rows;
#pragma unroll
      for (int pl = 0; pl <= S; ++pl) {
        if (ok[j]) x[pl][j] = p.plane[pl][id.v[j]];
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (!ok[j]) continue;
      rule<KIND>(x[0][j], x[1][j], x[2][j], x[3][j], g.v[j], h);
#pragma unroll
      for (int pl = 0; pl <= S; ++pl) p.plane[pl][id.v[j]] = x[pl][j];
    }
  }
}

// Any dim: 2^lane_shift lanes a row, R rows in flight per lane group.
template <int KIND, typename V>
__global__ void __launch_bounds__(kThreads)
    apply_rows_kernel(ApplyPlanes p, const int32_t* __restrict__ ids, int64_t n,
                      int64_t row_vecs, int64_t live_rows, int lane_shift, Hyper h) {
  constexpr int S = state_planes<KIND>();
  constexpr int R = apply_rows<KIND>();
  const int lanes = 1 << lane_shift;
  const int lane = threadIdx.x & (lanes - 1);
  const int64_t groups = blockDim.x >> lane_shift;
  const int64_t group = threadIdx.x >> lane_shift;
  const int64_t tile_rows = groups * R;
  for (int64_t tile = blockIdx.x * tile_rows; tile < n; tile += gridDim.x * tile_rows) {
    int64_t src[R], gsrc[R];
    bool ok[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t k = tile + j * groups + group;
      const int64_t id = k < n ? ids[k] : -1;
      ok[j] = id >= 0 && id < live_rows;
      src[j] = id * row_vecs;
      gsrc[j] = k * row_vecs;
    }
    for (int64_t c = lane; c < row_vecs; c += lanes) {
      V x[1 + 3][R] = {};
      V g[R] = {};
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (!ok[j]) continue;
        g[j] = reinterpret_cast<const V*>(p.grads)[gsrc[j] + c];
#pragma unroll
        for (int pl = 0; pl <= S; ++pl) x[pl][j] = reinterpret_cast<V*>(p.plane[pl])[src[j] + c];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (!ok[j]) continue;
        rule<KIND>(x[0][j], x[1][j], x[2][j], x[3][j], g[j], h);
#pragma unroll
        for (int pl = 0; pl <= S; ++pl) reinterpret_cast<V*>(p.plane[pl])[src[j] + c] = x[pl][j];
      }
    }
  }
}

// -- segment sum of the dense LR step ----------------------------------------
//
// ps_segment_sum replaces no Pallas kernel: the JAX dense step sums its
// gradient with XLA's scatter-add.  It was added because torch's
// segment_reduce sums a segment in one thread that waits on each load, and
// under Zipf keys one row holds about a quarter of a batch's positions
// (~1.6e5): 7.6 ms a step.
//
// Input: the step's positions sorted by row slot (order[i] = the position,
// stable, so a segment's positions ascend) and the unique index of each
// sorted entry (uid, nondecreasing from 0); out[u] is the sum over segment
// u of residual[order[i] / nnz], and 0 for u past the last segment.
//
// Each sum is the float32 running sum from 0 in position order, the plain
// version's (segment_combine) bit for bit: a float32 sum in any other order
// (a tree, or float64 rounded once) moved the LR table's first-block
// gradient norm by ~3e-4 of itself against the sequential float32 sums,
// because the hot row adds the same few residual values in one binade and
// so rounds the same way again and again.  So the adds of one segment form
// one dependent chain, and the kernels' work is to keep that chain fed.
// The first launch writes each sorted entry's value, vals[i] =
// residual[order[i] / nnz].  In the second a warp takes a window of 32
// sorted entries: each lane puts its entry's value in shared memory, and the
// warp sums each segment whose head is in the window, every lane adding the
// same values, read as float4s ahead of the adds.  A segment that runs past
// the window is read on for one round of 32, and past that in batches of
// kSeqRounds rounds, each loaded a batch ahead of its adds and read from
// shared memory a round ahead.  Bound: the hot row's chain of dependent
// float adds (4.5 cycles each on an H100, 2.27 ns at 1.98 GHz: 0.37 ms at
// 1.6e5 adds); the bytes, 8 + 8 of order and uid read, 4 of the values
// written and read, and 4 written an entry (the [B] residual stays in L2),
// would take ~5 us.
constexpr int kSeqThreads = 256;
constexpr int kSeqRounds = 16;

// The 32 values of a round, from shared memory.
__device__ __forceinline__ void read_round(float4 (&q)[8], const float* v) {
#pragma unroll
  for (int k = 0; k < 8; ++k) q[k] = reinterpret_cast<const float4*>(v)[k];
}

__device__ __forceinline__ float add_round(float acc, const float4 (&q)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    acc = acc + q[k].x;
    acc = acc + q[k].y;
    acc = acc + q[k].z;
    acc = acc + q[k].w;
  }
  return acc;
}

// acc + v[from], ..., v[to - 1] in order; a whole round is read before its
// adds, so only the adds wait on each other.
__device__ __forceinline__ float chain(float acc, const float* v, int from, int to) {
  if (from == 0 && to == 32) {
    float4 q[8];
    read_round(q, v);
    return add_round(acc, q);
  }
  for (int j = from; j < to; ++j) acc = acc + v[j];
  return acc;
}

__global__ void __launch_bounds__(kSeqThreads)
    segsum_vals_kernel(const int64_t* __restrict__ order, const float* __restrict__ residual,
                       int32_t per, int64_t n, float* __restrict__ vals) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) vals[i] = residual[static_cast<int32_t>(order[i]) / per];
}

// acc + segment seg's entries from p on, in order, in batches of kSeqRounds
// rounds of 32.  While a batch is added, the next batch's values and uids
// are in flight, and each round's values are read from shared memory a
// round ahead of its adds; entries past the segment add 0, which leaves a
// running sum from +0 as it was (it is never -0).  Indices are 32-bit
// (n < 2^31), and a uid is compared by its low word (uids are below n).
__device__ __forceinline__ float chain_long(float acc, float* v, const float* __restrict__ vals,
                                            const int64_t* __restrict__ uid, int64_t seg,
                                            int64_t p, int64_t n, int lane) {
  const unsigned full = 0xffffffffu;
  const int32_t* uid_lo = reinterpret_cast<const int32_t*>(uid);  // little-endian low words
  const int32_t m = static_cast<int32_t>(n);
  const int32_t s = static_cast<int32_t>(seg);
  int32_t at = static_cast<int32_t>(p) + lane;
  float x[kSeqRounds];
  int32_t u[kSeqRounds];
#pragma unroll
  for (int r = 0; r < kSeqRounds; ++r) {
    const int32_t q = at + r * 32;
    const int32_t c = q < m ? q : m - 1;
    x[r] = vals[c];
    u[r] = q < m ? uid_lo[2 * c] : -1;
  }
  for (;;) {
    const bool more = __ballot_sync(full, u[kSeqRounds - 1] == s) == full;
    __syncwarp();  // every lane is done reading the last batch
#pragma unroll
    for (int r = 0; r < kSeqRounds; ++r) v[r * 32 + lane] = u[r] == s ? x[r] : 0.f;
    __syncwarp();
    at += kSeqRounds * 32;
#pragma unroll
    for (int r = 0; r < kSeqRounds; ++r) {
      const int32_t q = at + r * 32;
      const int32_t c = q < m ? q : m - 1;
      x[r] = vals[c];
      u[r] = q < m ? uid_lo[2 * c] : -1;
    }
    float4 cur[8];
    read_round(cur, v);
#pragma unroll
    for (int r = 0; r < kSeqRounds; ++r) {
      float4 ahead[8];
      if (r + 1 < kSeqRounds) read_round(ahead, v + (r + 1) * 32);
      acc = add_round(acc, cur);
      if (r + 1 < kSeqRounds) {
#pragma unroll
        for (int k = 0; k < 8; ++k) cur[k] = ahead[k];
      }
    }
    if (!more) return acc;
  }
}

__global__ void __launch_bounds__(kSeqThreads)
    segsum_seq_kernel(const float* __restrict__ vals, const int64_t* __restrict__ uid,
                      int64_t n, float* __restrict__ out) {
  // a warp's values: its window, then a batch of kSeqRounds rounds of 32
  __shared__ __align__(16) float buf[kSeqThreads / 32][kSeqRounds * 32];
  const unsigned full = 0xffffffffu;
  const int64_t base = ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) * 32;
  const int lane = threadIdx.x & 31;
  float* v = buf[threadIdx.x >> 5];
  if (base >= n) return;  // whole warps leave together
  const int64_t i = base + lane;
  const int64_t segments = uid[n - 1] + 1;
  if (i < n && i >= segments) out[i] = 0.f;  // past the last segment
  const int64_t u = i < n ? uid[i] : -1;
  const bool head = i < n && (i == 0 || uid[i - 1] != u);
  unsigned heads = __ballot_sync(full, head);
  if (!heads) return;  // the window lies inside a segment an earlier warp sums
  v[lane] = i < n ? vals[i] : 0.f;
  __syncwarp();
  const int live = n - base < 32 ? static_cast<int>(n - base) : 32;
  const int64_t next = base + 32;
  const int64_t seg_after = next < n ? uid[next] : -1;
  while (heads) {
    const int b = __ffs(heads) - 1;
    heads &= heads - 1;
    const int e = heads ? __ffs(heads) - 1 : 32;
    const int64_t seg = __shfl_sync(full, u, b);
    float acc = chain(0.f, v, b, e < live ? e : live);
    if (e == 32 && seg_after == seg) {
      // the segment runs on past the window: most end within one more round
      const int64_t q = next + lane;
      const bool in = q < n && uid[q] == seg;
      const int cnt = __popc(__ballot_sync(full, in));
      __syncwarp();
      v[lane] = in ? vals[q] : 0.f;
      __syncwarp();
      acc = chain(acc, v, 0, cnt);
      if (cnt == 32) acc = chain_long(acc, v, vals, uid, seg, next + 32, n, lane);
    }
    if (lane == 0) out[seg] = acc;
  }
}

__global__ void noop_kernel() {}

// A plane pointer as the kernels take it; which side of a move is written is
// fixed by the entry point.
float* floats(const void* x) { return static_cast<float*>(const_cast<void*>(x)); }

// -- launchers ---------------------------------------------------------------

template <int MOVE, typename V, int NP>
void launch_move_rows(const Planes& p, const int32_t* ids, int64_t n, int64_t dim,
                      int64_t table_rows, cudaStream_t st) {
  const int64_t row_vecs = dim / Vec<V>::kWidth;
  const int shift = lane_shift_for(row_vecs);
  const int64_t rows_per_block = (kThreads >> shift) * kMoveRows;
  move_rows_kernel<MOVE, V, NP, kMoveRows>
      <<<blocks_for(n, rows_per_block, 2048 / kThreads), kThreads, 0, st>>>(
          p, ids, n, row_vecs, table_rows, shift);
}

template <int MOVE, int NP>
void launch_move(const Planes& p, const int32_t* ids, int64_t n, int64_t dim,
                 int64_t table_rows, bool vec, cudaStream_t st) {
  if (vec && dim == 1) {
    move_dim1_kernel<MOVE, NP, kIds>
        <<<blocks_for(n, kThreads1 * kIds, 2048 / kThreads1), kThreads1, 0, st>>>(
            p, ids, n, table_rows);
  } else if (vec && dim % 4 == 0) {
    launch_move_rows<MOVE, float4, NP>(p, ids, n, dim, table_rows, st);
  } else {
    launch_move_rows<MOVE, float, NP>(p, ids, n, dim, table_rows, st);
  }
}

// One launch over nplanes (1..4) planes that share the ids.
template <int MOVE>
int launch_planes(int nplanes, const Planes& p, const void* ids, int64_t n, int64_t dim,
                  int64_t table_rows, int vec, void* stream) {
  if (nplanes < 1 || nplanes > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && dim > 0) {
    const int32_t* i = static_cast<const int32_t*>(ids);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (nplanes) {
      case 1: launch_move<MOVE, 1>(p, i, n, dim, table_rows, vec, st); break;
      case 2: launch_move<MOVE, 2>(p, i, n, dim, table_rows, vec, st); break;
      case 3: launch_move<MOVE, 3>(p, i, n, dim, table_rows, vec, st); break;
      default: launch_move<MOVE, 4>(p, i, n, dim, table_rows, vec, st); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, typename V>
void launch_apply_rows(const ApplyPlanes& p, const int32_t* ids, int64_t n, int64_t dim,
                       int64_t live_rows, const Hyper& h, cudaStream_t st) {
  const int64_t row_vecs = dim / Vec<V>::kWidth;
  const int shift = lane_shift_for(row_vecs);
  const int64_t rows_per_block = (kThreads >> shift) * apply_rows<KIND>();
  apply_rows_kernel<KIND, V>
      <<<blocks_for(n, rows_per_block, 2048 / kThreads), kThreads, 0, st>>>(
          p, ids, n, row_vecs, live_rows, shift, h);
}

template <int KIND>
void launch_apply(const ApplyPlanes& p, const int32_t* ids, int64_t n, int64_t dim,
                  int64_t live_rows, const Hyper& h, bool vec, cudaStream_t st) {
  if (vec && dim == 1) {
    apply_dim1_kernel<KIND, kIds>
        <<<blocks_for(n, kThreads1 * kIds, 2048 / kThreads1), kThreads1, 0, st>>>(
            p, ids, n, live_rows, h);
  } else if (vec && dim % 4 == 0) {
    launch_apply_rows<KIND, float4>(p, ids, n, dim, live_rows, h, st);
  } else {
    launch_apply_rows<KIND, float>(p, ids, n, dim, live_rows, h, st);
  }
}

}  // namespace

extern "C" {

// An empty launch: the floor under every kernel's time on this card.
int ps_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// out_p[k] = table_p[ids[k]] for planes p < nplanes (1..4), one launch; every
// plane is [table_rows, dim].  vec: every pointer is 16-byte aligned.
int ps_gather(int nplanes, const void* t0, const void* t1, const void* t2, const void* t3,
              void* o0, void* o1, void* o2, void* o3, const void* ids, int64_t n,
              int64_t dim, int64_t table_rows, int vec, void* stream) {
  const Planes p{{floats(t0), floats(t1), floats(t2), floats(t3)},
                 {floats(o0), floats(o1), floats(o2), floats(o3)}};
  return launch_planes<kGather>(nplanes, p, ids, n, dim, table_rows, vec, stream);
}

// table_p[ids[k]] = rows_p[k] for planes p < nplanes (1..4), one launch; the
// tables are [table_rows, dim] and must not overlap, the rows [n, dim].
// Repeated ids must carry identical rows (trash pads).  vec: every pointer is
// 16-byte aligned.
int ps_scatter_set(int nplanes, void* t0, void* t1, void* t2, void* t3, const void* r0,
                   const void* r1, const void* r2, const void* r3, const void* ids,
                   int64_t n, int64_t dim, int64_t table_rows, int vec, void* stream) {
  const Planes p{{floats(t0), floats(t1), floats(t2), floats(t3)},
                 {floats(r0), floats(r1), floats(r2), floats(r3)}};
  return launch_planes<kSet>(nplanes, p, ids, n, dim, table_rows, vec, stream);
}

// table[ids[k]] += rows[k]; ids unique except trash pads whose rows are zero.
// vec: every pointer is 16-byte aligned.
int ps_scatter_add(void* table, const void* ids, const void* rows, int64_t n, int64_t dim,
                   int64_t table_rows, int vec, void* stream) {
  const Planes p{{floats(table)}, {floats(rows)}};
  if (n > 0 && dim > 0) {
    launch_move<kAdd, 1>(p, static_cast<const int32_t*>(ids), n, dim, table_rows, vec,
                         static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

// kind: 0 sgd, 1 adagrad, 2 adam, 3 ftrl.  State planes s0..s2 follow the
// optimizer's sorted state names; unused ones may be null.  Rows whose id is
// the trash row (table_rows - 1) or out of range are not touched.  vec: every
// pointer is 16-byte aligned.
int ps_apply(int kind, void* value, void* s0, void* s1, void* s2,
             const void* ids, const void* grads, int64_t n, int64_t dim,
             int64_t table_rows, float lr, float l1, float l2, float eps,
             float beta1, float one_minus_beta1, float beta2,
             float one_minus_beta2, float ftrl_alpha, float ftrl_beta,
             int vec, void* stream) {
  const Hyper h{lr,    l1,
                l2,    eps,
                beta1, one_minus_beta1,
                beta2, one_minus_beta2,
                ftrl_alpha, ftrl_beta};
  if (n <= 0 || dim <= 0) return static_cast<int>(cudaGetLastError());
  const ApplyPlanes p{{static_cast<float*>(value), static_cast<float*>(s0),
                       static_cast<float*>(s1), static_cast<float*>(s2)},
                      static_cast<const float*>(grads)};
  const int32_t* i = static_cast<const int32_t*>(ids);
  const int64_t live_rows = table_rows - 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kSgd: launch_apply<kSgd>(p, i, n, dim, live_rows, h, vec, st); break;
    case kAdagrad: launch_apply<kAdagrad>(p, i, n, dim, live_rows, h, vec, st); break;
    case kAdam: launch_apply<kAdam>(p, i, n, dim, live_rows, h, vec, st); break;
    case kFtrl: launch_apply<kFtrl>(p, i, n, dim, live_rows, h, vec, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[u] = the float32 running sum, from 0 in position order, of
// residual[order[i] / nnz] over the sorted entries i with uid[i] == u, for
// u < uid[n - 1] + 1, and 0 for the rest of out[0, n).  order: int64
// positions sorted by row slot (stably), n < 2^31; uid: int64, 0 at the
// first entry and one more at each new slot; residual: float [n / nnz];
// vals: n floats of scratch (each sorted entry's value).  Two launches.
int ps_segment_sum(const void* order, const void* uid, const void* residual, int64_t nnz,
                   int64_t n, void* out, void* vals, void* stream) {
  if (nnz <= 0 || n >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + kSeqThreads - 1) / kSeqThreads);
  segsum_vals_kernel<<<blocks, kSeqThreads, 0, st>>>(
      static_cast<const int64_t*>(order), static_cast<const float*>(residual),
      static_cast<int32_t>(nnz), n, static_cast<float*>(vals));
  segsum_seq_kernel<<<blocks, kSeqThreads, 0, st>>>(
      static_cast<const float*>(vals), static_cast<const int64_t*>(uid), n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
