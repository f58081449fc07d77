// Row kernels of the parameter-server tables, hand-written for Hopper (sm_90a).
//
// They replace the four Pallas kernels of parameter_server_tpu/ops/scatter.py:
//   ps_gather      <- _gather_kernel       / _pallas_gather       out[k] = table[ids[k]]
//   ps_scatter_set <- _scatter_set_kernel  / _pallas_scatter_set  table[ids[k]] = rows[k]
//   ps_scatter_add <- _scatter_add_kernel  / _pallas_scatter_add  table[ids[k]] += rows[k]
//   ps_apply       <- _apply_kernel        / _pallas_apply        fused gather -> rule -> scatter
//
// Contract shared with the Pallas kernels: float32 tables of shape
// [rows + 1, dim] (the last row is the trash row), int32 ids that are unique
// except for bucket pads, which all point at the trash row.  Unlike the Pallas
// kernels these accept any dim (the LR table has dim = 1) and compute element
// offsets in int64 (ids[k] * dim overflows int32 once rows * dim >= 2^31).
//
// Bound: every kernel moves each touched row once and does a few flops per
// element, so it is bound by device-memory bytes (3.35 TB/s on an H100 SXM).
// Design: one thread per (id, column) element in a grid-stride loop, so
// neighbouring threads touch neighbouring columns of a row (coalesced for
// wide rows) and dim = 1 packs 32 ids into one warp.  Ids that fall outside
// [0, table_rows) are skipped (gather writes NaN there) rather than faulting.
//
// Races: pads hit the trash row many times in one launch.  scatter_set writes
// identical bytes there and scatter_add adds exact zeros, so those races are
// benign; apply may rewrite trash bytes (Adam's t), which is allowed only
// because KVTable re-zeros the trash row right after every apply.
//
// Every entry point is a plain C function: pointers and the stream arrive as
// void*, it launches on the caller's stream without synchronising, and it
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// 16 resident blocks of 256 threads on each of 132 SMs; the grid-stride loop
// covers the rest.
constexpr int64_t kMaxBlocks = 132 * 16;

int grid_for(int64_t total) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks);
}

__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

struct Hyper {
  float lr, l1, l2, eps;
  float beta1, one_minus_beta1, beta2, one_minus_beta2;
  float ftrl_alpha, ftrl_beta;
};

enum Kind { kSgd = 0, kAdagrad = 1, kAdam = 2, kFtrl = 3 };

__global__ void gather_kernel(const float* __restrict__ table,
                              const int32_t* __restrict__ ids,
                              float* __restrict__ out, int64_t n, int64_t dim,
                              int64_t table_rows) {
  const int64_t total = n * dim;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int64_t k = e / dim;
    const int64_t c = e - k * dim;
    const int64_t id = ids[k];
    out[e] = (id >= 0 && id < table_rows) ? table[id * dim + c] : NAN;
  }
}

__global__ void scatter_set_kernel(float* __restrict__ table,
                                   const int32_t* __restrict__ ids,
                                   const float* __restrict__ rows, int64_t n,
                                   int64_t dim, int64_t table_rows) {
  const int64_t total = n * dim;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int64_t k = e / dim;
    const int64_t id = ids[k];
    if (id < 0 || id >= table_rows) continue;
    table[id * dim + (e - k * dim)] = rows[e];
  }
}

__global__ void scatter_add_kernel(float* __restrict__ table,
                                   const int32_t* __restrict__ ids,
                                   const float* __restrict__ rows, int64_t n,
                                   int64_t dim, int64_t table_rows) {
  const int64_t total = n * dim;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int64_t k = e / dim;
    const int64_t id = ids[k];
    if (id < 0 || id >= table_rows) continue;
    const int64_t off = id * dim + (e - k * dim);
    table[off] = table[off] + rows[e];
  }
}

// One optimizer step on one element; mirrors kv/optim.py operation by
// operation (the build passes -fmad=false so no multiply-add is contracted
// and each operation rounds as the plain version's does).
template <int KIND>
__device__ __forceinline__ void apply_rule(float* __restrict__ value,
                                           float* __restrict__ s0,
                                           float* __restrict__ s1,
                                           float* __restrict__ s2,
                                           int64_t off, float grad,
                                           const Hyper& h) {
  const float v = value[off];
  if (KIND == kSgd) {
    const float g = grad + h.l2 * v;
    value[off] = v - h.lr * g;
  } else if (KIND == kAdagrad) {
    // s0 = sum_sq
    const float g = grad + h.l2 * v;
    const float sum_sq = s0[off] + g * g;
    const float lr = h.lr / (sqrtf(sum_sq) + h.eps);
    float nv = v - lr * g;
    if (h.l1 > 0.f) nv = sign_of(nv) * fmaxf(fabsf(nv) - lr * h.l1, 0.f);
    value[off] = nv;
    s0[off] = sum_sq;
  } else if (KIND == kAdam) {
    // state planes in sorted-name order: s0 = m, s1 = t, s2 = v
    const float g = grad + h.l2 * v;
    const float t = s1[off] + 1.f;
    const float m = h.beta1 * s0[off] + h.one_minus_beta1 * g;
    const float vv = h.beta2 * s2[off] + h.one_minus_beta2 * g * g;
    const float m_hat = m / (1.f - powf(h.beta1, t));
    const float v_hat = vv / (1.f - powf(h.beta2, t));
    value[off] = v - h.lr * m_hat / (sqrtf(v_hat) + h.eps);
    s0[off] = m;
    s1[off] = t;
    s2[off] = vv;
  } else {  // kFtrl: value = z, s0 = n; the lazy weight is computed inline
    const float z = v;
    const float n = s0[off];
    const float w_raw =
        -(z - sign_of(z) * h.l1) / ((h.ftrl_beta + sqrtf(n)) / h.ftrl_alpha + h.l2);
    const float w = (fabsf(z) <= h.l1) ? 0.f : w_raw;
    const float sigma = (sqrtf(n + grad * grad) - sqrtf(n)) / h.ftrl_alpha;
    value[off] = z + grad - sigma * w;
    s0[off] = n + grad * grad;
  }
}

template <int KIND>
__global__ void apply_kernel(float* __restrict__ value, float* __restrict__ s0,
                             float* __restrict__ s1, float* __restrict__ s2,
                             const int32_t* __restrict__ ids,
                             const float* __restrict__ grads, int64_t n,
                             int64_t dim, int64_t table_rows, Hyper h) {
  const int64_t total = n * dim;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int64_t k = e / dim;
    const int64_t id = ids[k];
    if (id < 0 || id >= table_rows) continue;
    apply_rule<KIND>(value, s0, s1, s2, id * dim + (e - k * dim), grads[e], h);
  }
}

}  // namespace

extern "C" {

int ps_gather(const void* table, const void* ids, void* out, int64_t n,
              int64_t dim, int64_t table_rows, void* stream) {
  const int64_t total = n * dim;
  if (total > 0) {
    gather_kernel<<<grid_for(total), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int32_t*>(ids),
        static_cast<float*>(out), n, dim, table_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

int ps_scatter_set(void* table, const void* ids, const void* rows, int64_t n,
                   int64_t dim, int64_t table_rows, void* stream) {
  const int64_t total = n * dim;
  if (total > 0) {
    scatter_set_kernel<<<grid_for(total), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(table), static_cast<const int32_t*>(ids),
        static_cast<const float*>(rows), n, dim, table_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

int ps_scatter_add(void* table, const void* ids, const void* rows, int64_t n,
                   int64_t dim, int64_t table_rows, void* stream) {
  const int64_t total = n * dim;
  if (total > 0) {
    scatter_add_kernel<<<grid_for(total), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(table), static_cast<const int32_t*>(ids),
        static_cast<const float*>(rows), n, dim, table_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// kind: 0 sgd, 1 adagrad, 2 adam, 3 ftrl.  State planes s0..s2 follow the
// optimizer's sorted state names; unused ones may be null.
int ps_apply(int kind, void* value, void* s0, void* s1, void* s2,
             const void* ids, const void* grads, int64_t n, int64_t dim,
             int64_t table_rows, float lr, float l1, float l2, float eps,
             float beta1, float one_minus_beta1, float beta2,
             float one_minus_beta2, float ftrl_alpha, float ftrl_beta,
             void* stream) {
  const Hyper h{lr,    l1,
                l2,    eps,
                beta1, one_minus_beta1,
                beta2, one_minus_beta2,
                ftrl_alpha, ftrl_beta};
  const int64_t total = n * dim;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  const int grid = grid_for(total);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* v = static_cast<float*>(value);
  float* a = static_cast<float*>(s0);
  float* b = static_cast<float*>(s1);
  float* c = static_cast<float*>(s2);
  const int32_t* i = static_cast<const int32_t*>(ids);
  const float* g = static_cast<const float*>(grads);
  switch (kind) {
    case kSgd:
      apply_kernel<kSgd><<<grid, kThreads, 0, st>>>(v, a, b, c, i, g, n, dim,
                                                    table_rows, h);
      break;
    case kAdagrad:
      apply_kernel<kAdagrad><<<grid, kThreads, 0, st>>>(v, a, b, c, i, g, n,
                                                        dim, table_rows, h);
      break;
    case kAdam:
      apply_kernel<kAdam><<<grid, kThreads, 0, st>>>(v, a, b, c, i, g, n, dim,
                                                     table_rows, h);
      break;
    case kFtrl:
      apply_kernel<kFtrl><<<grid, kThreads, 0, st>>>(v, a, b, c, i, g, n, dim,
                                                     table_rows, h);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
