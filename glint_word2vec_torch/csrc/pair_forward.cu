// Forward half of the fused SGNS pair step for Hopper (sm_90a).
//
// Replaces glint_word2vec_tpu/ops/pallas_sgns.py::pair_forward (:201; kernel
// body _pair_forward_kernel, :113-197), the first phase of fused_pair_step.
// For each pair p of a dense pair batch it gathers h = syn0[centers[p]],
// u = syn1[contexts[p]] and the n rows syn1[negs[p, k]] in storage dtype,
// upcasts them to fp32 and writes
//   c_pos[p]    = alpha * (1 - sigmoid(h.u)) * mask[p]
//   c_neg[p, k] = -alpha * sigmoid(h.neg_k) * nmask[p, k]
//   h_out[p]    = h (fp32, an exact upcast)
//   d_center[p] = c_pos[p] * u + sum_k c_neg[p, k] * neg_k
//   loss[p]     = (-log sigmoid(h.u) - sum_k log sigmoid(-h.neg_k) * nmask[p, k])
//                 * mask[p]
// The TPU kernel carries the loss sum across its sequential grid steps
// (:193-197). Hopper blocks run in no order, so this kernel writes one loss
// per pair and the wrapper reduces them in a fixed order: no float atomics,
// and two calls on the same inputs give the same bits.
//
// Bound: memory bandwidth, and before it latency. A call must read the
// (2 + n) rows of d storage-dtype values of each pair and write two fp32
// rows (h and d_center) a pair, about ((2 + n) * s + 8) * P * d bytes
// (s = 4 or 2); the arithmetic, 4 * (1 + n) * d flops a pair, is far below
// the card's rate for those bytes. At a training step's size (P = 3,277,
// n = 5, d = 300: 35 MB, about 0.010 ms at 3.35 TB/s) the time is the
// launch plus the dependent trips to device memory that each pair makes.
//
// Design: one warp a pair, two dependent trips. The TPU kernel starts all
// block_rows x (2 + n) row copies before it waits on any (:113-197); here
// - trip 1: lane t < 2 + n loads id t of the pair (center, context, the n
//   negatives) and, for a negative, its mask, and puts them in the warp's
//   slice of shared memory;
// - trip 2: the warp asks for all 2 + n rows with cp.async before it waits
//   on any, staging them in storage dtype in its slice (16-byte copies
//   when the row stride and the tables' bases allow it: fp32 rows with
//   stride % 4 == 0; 8-byte copies of 4 bf16 values when stride % 4 == 0
//   but not % 8, as at d = 300; 4-byte copies otherwise; bf16 rows of an
//   odd stride, which are only 2-byte aligned, by plain 2-byte loads);
// - then everything else comes from shared memory: each lane takes
//   groups of 4 columns, the 1 + n dot products are formed in one pass
//   over the columns (negatives in chunks of kChunkNegs, one register sum
//   each) and their warp reductions are interleaved; every lane then
//   holds every sum, and d_center is formed from the staged rows with no
//   second read of u or the negative rows, each column in one fixed order:
//   c_pos * u first, then the negatives k = 0 .. n - 1. h and d_center
//   are written with 16-byte stores when d % 4 == 0.
// The registers are sized for n <= kChunkNegs = 8 in one pass; a larger n
// (users run 5 to 25) takes ceil(n / 8) passes over the staged h. The host
// picks the warps a block so that the most pairs are resident on an SM at
// once (at d = 300, n = 5, fp32: 27 of 8.5 KB each, one wave for
// P = 3,277; times in PERF.md §6).
//
// The tiled form takes every (d, n) whose 2 + n rows do not fit in one
// block's shared memory ((2 + n) * round_up(d * s, 16) bytes plus the ids
// and masks past 227 KB: at n = 5, d > 8,300 in fp32; at n = 25,
// d > 2,150). It stages nothing: one warp a pair reads the rows from the
// tables in the same groups of 4 columns, each lane the same groups in the
// same order, so it forms the same sums as the one-pass form, bit for bit:
// - pass 1: the 1 + n dot products, kChunkNegs negatives a pass over the
//   columns, each a register sum per lane, then the same warp reductions
//   (the first pass also writes h);
// - the coefficients c_pos and c_neg, lane 0 writing c_neg to its output
//   row, which pass 2 reads back after a __syncwarp;
// - pass 2: d_center group by group, each column c_pos * u first, then the
//   negatives k = 0 .. n - 1.
// It reads u and the negative rows twice and h once a chunk of negatives,
// and needs no shared memory, so no (d, n) is too large: the only limit
// is the tables' own size. The host takes it only where the one-pass
// form's slice does not fit; glint_pair_forward_tiled launches it at any
// shape, for tests that hold the two forms against each other.
//
// Row offsets are 64-bit: id * stride passes 2^31 at V = 10,000,000.
//
// Preconditions: the tables share one row stride and n >= 1 (the wrapper
// checks both); every id lies in [0, V) (the caller keeps this, as the
// training path does by drawing ids from the corpus and the alias table:
// no id is range-checked here).
//
// Plain C interface, built by glint_word2vec_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes by glint_word2vec_torch/ops/fused_sgns.py.

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarpsPerBlock = 16;
constexpr int kMaxThreads = kMaxWarpsPerBlock * 32;
// Negatives whose dot products one pass over the columns forms.
constexpr int kChunkNegs = 8;
constexpr unsigned kFull = 0xffffffffu;

constexpr int32_t kDtypeF32 = 0;
constexpr int32_t kDtypeBF16 = 1;

__host__ __device__ __forceinline__ int64_t round_up16(int64_t x) {
  return (x + 15) & ~int64_t{15};
}

// Bytes of a warp's slice of shared memory: the 2 + n staged rows, each
// padded to 16 bytes, then the 2 + n ids, the n negative masks and the n
// coefficients c_neg.
__host__ __device__ __forceinline__ int64_t slice_bytes(int n, int64_t d,
                                                        int s) {
  return (2 + n) * round_up16(d * s) + round_up16(4 * (2 + 3 * int64_t{n}));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// log(sigmoid(x)) = -softplus(-x) = -(max(-x, 0) + log1p(exp(-|x|))).
__device__ __forceinline__ float log_sigmoid(float x) {
  return -(fmaxf(-x, 0.0f) + log1pf(expf(-fabsf(x))));
}

// Columns 4g .. 4g + 3 of a staged row as fp32; the columns at or past d
// read as 0 (the staged row's padding holds anything).
__device__ __forceinline__ float4 group4(const float* row, int64_t g,
                                         int64_t d) {
  float4 v = reinterpret_cast<const float4*>(row)[g];
  const int64_t j = 4 * g;
  if (j + 4 > d) {
    if (j + 1 >= d) v.y = 0.0f;
    if (j + 2 >= d) v.z = 0.0f;
    v.w = 0.0f;
  }
  return v;
}

// bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32 bits.
__device__ __forceinline__ float4 group4(const uint16_t* row, int64_t g,
                                         int64_t d) {
  const uint2 w = reinterpret_cast<const uint2*>(row)[g];
  float4 v = make_float4(__uint_as_float(w.x << 16),
                         __uint_as_float(w.x & 0xffff0000u),
                         __uint_as_float(w.y << 16),
                         __uint_as_float(w.y & 0xffff0000u));
  const int64_t j = 4 * g;
  if (j + 4 > d) {
    if (j + 1 >= d) v.y = 0.0f;
    if (j + 2 >= d) v.z = 0.0f;
    v.w = 0.0f;
  }
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Columns 4g .. of an fp32 output row: one 16-byte store when d % 4 == 0
// (the wrapper's outputs are 16-byte aligned), else the columns below d.
__device__ __forceinline__ void store4(float* row, int64_t g, int64_t d,
                                       float4 v) {
  const int64_t j = 4 * g;
  if ((d & 3) == 0) {
    reinterpret_cast<float4*>(row)[g] = v;
    return;
  }
  row[j] = v.x;
  if (j + 1 < d) row[j + 1] = v.y;
  if (j + 2 < d) row[j + 2] = v.z;
  if (j + 3 < d) row[j + 3] = v.w;
}

// A copy of kBytes into shared memory that also keeps the line in L1
// (.ca): a row many pairs of a block's SM read (row 0 of the padded
// slots, a frequent negative) is then read from L2 once, not once a pair
// (PERF.md §6).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(kBytes)
               : "memory");
}

// Columns 4g .. 4g + 3 of a table row as fp32, the columns at or past d
// read as 0 and never loaded (the row may be the table's last). kVec is the
// widest load every row allows (as vec_bytes finds it): a 16-byte load of
// 4 fp32 values, an 8-byte load of 4 bf16 values, else one value a load.
template <int kVec>
__device__ __forceinline__ float4 load4(const float* row, int64_t g,
                                        int64_t d) {
  const int64_t j = 4 * g;
  if (kVec == 16 && j + 4 <= d) {
    return __ldg(reinterpret_cast<const float4*>(row) + g);
  }
  float4 v;
  v.x = __ldg(row + j);
  v.y = j + 1 < d ? __ldg(row + j + 1) : 0.0f;
  v.z = j + 2 < d ? __ldg(row + j + 2) : 0.0f;
  v.w = j + 3 < d ? __ldg(row + j + 3) : 0.0f;
  return v;
}

__device__ __forceinline__ float bf16_at(const uint16_t* row, int64_t j) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(row + j)) << 16);
}

template <int kVec>
__device__ __forceinline__ float4 load4(const uint16_t* row, int64_t g,
                                        int64_t d) {
  const int64_t j = 4 * g;
  if (kVec >= 8 && j + 4 <= d) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(row) + g);
    return make_float4(__uint_as_float(w.x << 16),
                       __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16),
                       __uint_as_float(w.y & 0xffff0000u));
  }
  float4 v;
  v.x = bf16_at(row, j);
  v.y = j + 1 < d ? bf16_at(row, j + 1) : 0.0f;
  v.z = j + 2 < d ? bf16_at(row, j + 2) : 0.0f;
  v.w = j + 3 < d ? bf16_at(row, j + 3) : 0.0f;
  return v;
}

// Row r of a pair (0 the center, 1 the context, 2 + k negative k) staged
// in the warp's slice of shared memory: the one-pass form.
template <typename T>
struct StagedRows {
  const unsigned char* slice;
  int64_t rb;  // bytes a staged row takes, padded to 16
  __device__ __forceinline__ float4 group(int r, int64_t g, int64_t d) const {
    return group4(reinterpret_cast<const T*>(slice + r * rb), g, d);
  }
};

// Row r of pair p read from the tables: the tiled form.
template <typename T, int kVec>
struct TableRows {
  const T* syn0;
  const T* syn1;
  int64_t stride;
  int32_t center, context;
  const int32_t* negs;  // the pair's n negative ids
  __device__ __forceinline__ float4 group(int r, int64_t g, int64_t d) const {
    const int32_t id = r == 0 ? center : r == 1 ? context : __ldg(negs + (r - 2));
    return load4<kVec>((r == 0 ? syn0 : syn1) + static_cast<int64_t>(id) * stride,
                       g, d);
  }
};

// Everything after the rows are reachable, for one pair p on one warp: the
// dot products (kChunkNegs negatives a pass over the columns, the first
// pass also h.u and the h row's store), their warp sums, the coefficients
// and the loss, then d_center, each column c_pos * u first and then the
// negatives k = 0 .. n - 1. nms holds the pair's n negative masks; cn
// takes its n coefficients c_neg (lane 0 writes them and the warp reads
// them back after a __syncwarp), as does c_neg_out, which may be cn.
template <typename Rows>
__device__ __forceinline__ void pair_body(
    const Rows& rows, const float* nms, float* cn, float m, float alpha,
    int64_t p, int n, int64_t d, int lane, float* __restrict__ c_pos_out,
    float* c_neg_out, float* __restrict__ h_out, float* __restrict__ dcen_out,
    float* __restrict__ loss_out) {
  const int64_t groups = (d + 3) / 4;
  float* hdst = h_out + p * d;
  float f_pos = 0.0f;
  float loss = 0.0f;
  for (int k0 = 0; k0 < n; k0 += kChunkNegs) {
    const int cnt = min(kChunkNegs, n - k0);
    float acc[kChunkNegs + 1];
#pragma unroll
    for (int k = 0; k <= kChunkNegs; ++k) acc[k] = 0.0f;
    for (int64_t g = lane; g < groups; g += 32) {
      const float4 hv = rows.group(0, g, d);
      if (k0 == 0) {
        acc[kChunkNegs] = dot4(hv, rows.group(1, g, d), acc[kChunkNegs]);
        store4(hdst, g, d, hv);
      }
#pragma unroll
      for (int k = 0; k < kChunkNegs; ++k) {
        if (k < cnt) acc[k] = dot4(hv, rows.group(2 + k0 + k, g, d), acc[k]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int k = 0; k <= kChunkNegs; ++k) {
        if (k < cnt || (k == kChunkNegs && k0 == 0)) {
          acc[k] += __shfl_xor_sync(kFull, acc[k], o);
        }
      }
    }
    if (k0 == 0) {
      f_pos = acc[kChunkNegs];
      loss = -log_sigmoid(f_pos);
    }
#pragma unroll
    for (int k = 0; k < kChunkNegs; ++k) {
      if (k < cnt) {
        const float nm = nms[k0 + k];
        const float c = -alpha * sigmoid(acc[k]) * nm;
        if (lane == 0) {
          cn[k0 + k] = c;
          c_neg_out[p * n + k0 + k] = c;
        }
        loss -= log_sigmoid(-acc[k]) * nm;
      }
    }
  }
  const float c_pos = alpha * (1.0f - sigmoid(f_pos)) * m;
  __syncwarp();  // lane 0's coefficients are visible to the warp

  // d_center: c_pos * u, then each negative in order.
  float* ddst = dcen_out + p * d;
  for (int64_t g = lane; g < groups; g += 32) {
    const float4 uv = rows.group(1, g, d);
    float4 v = make_float4(c_pos * uv.x, c_pos * uv.y, c_pos * uv.z,
                           c_pos * uv.w);
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float c = cn[k];
      const float4 nv = rows.group(2 + k, g, d);
      v.x = fmaf(c, nv.x, v.x);
      v.y = fmaf(c, nv.y, v.y);
      v.z = fmaf(c, nv.z, v.z);
      v.w = fmaf(c, nv.w, v.w);
    }
    store4(ddst, g, d, v);
  }
  if (lane == 0) {
    c_pos_out[p] = c_pos;
    loss_out[p] = loss * m;
  }
}

// The one-pass form, one pair per warp; kVec is the bytes a copy of trip 2
// moves (16, 8 or 4 with cp.async, 2 with plain loads).
template <typename T, int kVec>
__global__ void __launch_bounds__(kMaxThreads, 2)
pair_forward_kernel(const T* __restrict__ syn0, const T* __restrict__ syn1,
                    int64_t stride, const int32_t* __restrict__ centers,
                    const int32_t* __restrict__ contexts,
                    const float* __restrict__ mask,
                    const int32_t* __restrict__ negs,
                    const float* __restrict__ nmask,
                    const float* __restrict__ alpha_p, int64_t P, int n,
                    int64_t d, float* __restrict__ c_pos_out,
                    float* __restrict__ c_neg_out, float* __restrict__ h_out,
                    float* __restrict__ dcen_out,
                    float* __restrict__ loss_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (p >= P) return;  // uniform across the warp
  const int nrows = 2 + n;
  const int64_t rb = round_up16(d * static_cast<int64_t>(sizeof(T)));
  unsigned char* slice = smem + warp * slice_bytes(n, d, sizeof(T));
  int32_t* ids = reinterpret_cast<int32_t*>(slice + nrows * rb);
  float* nms = reinterpret_cast<float*>(ids + nrows);
  float* cn = nms + n;

  // Trip 1: the pair's ids and negative masks, one lane each.
  const int32_t* pneg = negs + p * n;
  const float* pnm = nmask + p * n;
  for (int t = lane; t < nrows; t += 32) {
    ids[t] = t == 0 ? __ldg(centers + p)
                    : t == 1 ? __ldg(contexts + p) : __ldg(pneg + (t - 2));
    if (t >= 2) nms[t - 2] = __ldg(pnm + (t - 2));
  }
  const float m = __ldg(mask + p);
  const float alpha = __ldg(alpha_p);
  __syncwarp();

  // Trip 2: every row of the pair requested before any is waited on.
  const int64_t nvec = (d * static_cast<int64_t>(sizeof(T)) + kVec - 1) / kVec;
  for (int r = 0; r < nrows; ++r) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        (r == 0 ? syn0 : syn1) + static_cast<int64_t>(ids[r]) * stride);
    unsigned char* dst = slice + r * rb;
    if constexpr (kVec >= 4) {
      for (int64_t v = lane; v < nvec; v += 32) {
        cp_async<kVec>(dst + v * kVec, src + v * kVec);
      }
    } else {
      // bf16 rows of an odd stride: plain loads, four in flight a lane.
      const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
      uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
      for (int64_t v0 = lane; v0 < nvec; v0 += 128) {
        uint16_t x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          x[u] = v0 + 32 * u < nvec ? __ldg(s16 + v0 + 32 * u) : 0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (v0 + 32 * u < nvec) d16[v0 + 32 * u] = x[u];
        }
      }
    }
  }
  if constexpr (kVec >= 4) {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncwarp();  // every lane's copies are visible to the warp

  pair_body(StagedRows<T>{slice, rb}, nms, cn, m, alpha, p, n, d, lane,
            c_pos_out, c_neg_out, h_out, dcen_out, loss_out);
}

// The tiled form, one pair per warp, no shared memory; kVec is the widest
// load every row allows.
template <typename T, int kVec>
__global__ void __launch_bounds__(kMaxThreads, 2)
pair_forward_tiled_kernel(const T* __restrict__ syn0,
                          const T* __restrict__ syn1, int64_t stride,
                          const int32_t* __restrict__ centers,
                          const int32_t* __restrict__ contexts,
                          const float* __restrict__ mask,
                          const int32_t* __restrict__ negs,
                          const float* __restrict__ nmask,
                          const float* __restrict__ alpha_p, int64_t P, int n,
                          int64_t d, float* __restrict__ c_pos_out,
                          float* c_neg_out, float* __restrict__ h_out,
                          float* __restrict__ dcen_out,
                          float* __restrict__ loss_out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (p >= P) return;  // uniform across the warp
  const TableRows<T, kVec> rows{syn0, syn1, stride, __ldg(centers + p),
                                __ldg(contexts + p), negs + p * n};
  // The coefficients go to the pair's row of c_neg_out, and pass 2 reads
  // them back from there (a plain load: the row is written in this launch).
  float* cn = c_neg_out + p * n;
  pair_body(rows, nmask + p * n, cn, __ldg(mask + p), __ldg(alpha_p), p, n, d,
            lane, c_pos_out, c_neg_out, h_out, dcen_out, loss_out);
}

// A launch's shape: warps (pairs) a block, the blocks an SM holds at once;
// warps == 0 when not one warp's slice fits in a block.
struct Plan {
  int warps = 0;
  int per_sm = 0;
  int sms = 0;
};

// The shape that keeps the most pairs resident on an SM for a kernel and a
// slice size, found once with the occupancy calculator and kept.
int plan_for(const void* fn, int64_t slice, Plan* out) {
  struct Entry {
    const void* fn;
    int64_t slice;
    Plan plan;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int cached = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < cached; ++i) {
    if (cache[i].fn == fn && cache[i].slice == slice) {
      *out = cache[i].plan;
      return cudaSuccess;
    }
  }
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  Plan best;
  best.sms = sms;
  for (int w = 1; w <= kMaxWarpsPerBlock; ++w) {
    if (w * slice > optin) break;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, 32 * w, static_cast<size_t>(w * slice));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (blocks * w > best.per_sm * best.warps ||
        (blocks * w == best.per_sm * best.warps && blocks > 0 &&
         w <= 8)) {
      best.warps = w;
      best.per_sm = blocks;
    }
  }
  if (cached < 64) cache[cached++] = {fn, slice, best};
  *out = best;
  return cudaSuccess;
}

// The largest copy (16, 8, 4 bytes; 2 for bf16 only) that every row of
// both tables allows: the row stride in bytes and both bases divisible.
int vec_bytes(const void* syn0, const void* syn1, int64_t stride, int s) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(syn0) |
                          reinterpret_cast<uintptr_t>(syn1) |
                          static_cast<uintptr_t>(stride * s);
  for (int v = 16; v > 2; v >>= 1) {
    if ((bases & (v - 1)) == 0) return v;
  }
  return 2;
}

template <typename T, int kVec>
const void* kernel_of(bool tiled) {
  return tiled ? reinterpret_cast<const void*>(pair_forward_tiled_kernel<T, kVec>)
               : reinterpret_cast<const void*>(pair_forward_kernel<T, kVec>);
}

template <typename T>
const void* pick(int vec, bool tiled) {
  switch (vec) {
    case 16:
      return kernel_of<T, 16>(tiled);
    case 8:
      return kernel_of<T, 8>(tiled);
    case 4:
      return kernel_of<T, 4>(tiled);
    default:
      if constexpr (sizeof(T) == 2) return kernel_of<T, 2>(tiled);
      return nullptr;  // an fp32 row is always 4-byte aligned
  }
}

// A launch of one form: its kernel, a warp's slice and the plan.
struct Launch {
  const void* fn = nullptr;
  int64_t slice = 0;
  Plan plan;
  int32_t form = 0;  // 0 the one-pass form, 1 the tiled form
};

// The one-pass form where a warp's slice fits in a block (unless `tiled`
// asks for the tiled form), else the tiled form.
int choose(int32_t dtype, const void* syn0, const void* syn1, int64_t stride,
           int n, int64_t d, bool tiled, Launch* out) {
  if (dtype != kDtypeF32 && dtype != kDtypeBF16) return cudaErrorInvalidValue;
  const int s = dtype == kDtypeF32 ? 4 : 2;
  const int vec = vec_bytes(syn0, syn1, stride, s);
  for (int form = tiled ? 1 : 0; form < 2; ++form) {
    Launch l;
    l.form = form;
    l.fn = s == 4 ? pick<float>(vec, form == 1) : pick<uint16_t>(vec, form == 1);
    if (l.fn == nullptr) return cudaErrorInvalidValue;
    l.slice = form == 0 ? slice_bytes(n, d, s) : 0;
    const int e = plan_for(l.fn, l.slice, &l.plan);
    if (e != cudaSuccess) return e;
    if (l.plan.warps > 0) {
      *out = l;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;  // the tiled form always has a plan
}

int launch(const Launch& l, const void* syn0, const void* syn1,
           int64_t stride, const void* centers, const void* contexts,
           const void* mask, const void* negs, const void* nmask,
           const void* alpha, int64_t P, int32_t n, int64_t d, void* c_pos,
           void* c_neg, void* h, void* d_center, void* loss, void* stream) {
  const int64_t blocks = (P + l.plan.warps - 1) / l.plan.warps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int32_t* ci = static_cast<const int32_t*>(centers);
  const int32_t* xi = static_cast<const int32_t*>(contexts);
  const float* mk = static_cast<const float*>(mask);
  const int32_t* ng = static_cast<const int32_t*>(negs);
  const float* nm = static_cast<const float*>(nmask);
  const float* al = static_cast<const float*>(alpha);
  float* o[5] = {static_cast<float*>(c_pos), static_cast<float*>(c_neg),
                 static_cast<float*>(h), static_cast<float*>(d_center),
                 static_cast<float*>(loss)};
  void* args[] = {&syn0, &syn1, &stride, &ci, &xi, &mk, &ng, &nm, &al,
                  &P,    &n,    &d,      &o[0], &o[1], &o[2], &o[3], &o[4]};
  return static_cast<int>(cudaLaunchKernel(
      l.fn, dim3(static_cast<unsigned>(blocks)), dim3(32 * l.plan.warps),
      args, static_cast<size_t>(l.plan.warps * l.slice),
      static_cast<cudaStream_t>(stream)));
}

int forward(bool tiled, const void* syn0, const void* syn1, int64_t stride,
            int32_t dtype, const void* centers, const void* contexts,
            const void* mask, const void* negs, const void* nmask,
            const void* alpha, int64_t P, int32_t n, int64_t d, void* c_pos,
            void* c_neg, void* h, void* d_center, void* loss, void* stream,
            int32_t* form) {
  if (P < 0 || n < 1 || d <= 0 || stride < d) return cudaErrorInvalidValue;
  Launch l;
  const int e = choose(dtype, syn0, syn1, stride, n, d, tiled, &l);
  if (e != cudaSuccess) return e;
  if (form != nullptr) *form = l.form;
  if (P == 0) return cudaSuccess;
  return launch(l, syn0, syn1, stride, centers, contexts, mask, negs, nmask,
                alpha, P, n, d, c_pos, c_neg, h, d_center, loss, stream);
}

}  // namespace

extern "C" {

// Launches the forward pass on `stream` and returns cudaGetLastError() as
// an int (0 = launched). syn0/syn1 are [V, stride] of `dtype` (0 = f32,
// 1 = bf16); centers, contexts [P] int32; mask [P] f32; negs [P, n] int32;
// nmask [P, n] f32; alpha a device f32 scalar. Outputs, contiguous fp32,
// 16-byte aligned: c_pos [P], c_neg [P, n], h [P, d], d_center [P, d],
// loss [P]. Takes the one-pass form where a pair's rows fit in a block's
// shared memory, else the tiled form, and writes which into *form (0 the
// one-pass form, 1 the tiled form). Does not synchronise and allocates
// nothing.
int glint_pair_forward(const void* syn0, const void* syn1, int64_t stride,
                       int32_t dtype, const void* centers, const void* contexts,
                       const void* mask, const void* negs, const void* nmask,
                       const void* alpha, int64_t P, int32_t n, int64_t d,
                       void* c_pos, void* c_neg, void* h, void* d_center,
                       void* loss, void* stream, int32_t* form) {
  return forward(false, syn0, syn1, stride, dtype, centers, contexts, mask,
                 negs, nmask, alpha, P, n, d, c_pos, c_neg, h, d_center, loss,
                 stream, form);
}

// glint_pair_forward in the tiled form whatever the shape (the same
// arguments, less `form`).
int glint_pair_forward_tiled(const void* syn0, const void* syn1,
                             int64_t stride, int32_t dtype,
                             const void* centers, const void* contexts,
                             const void* mask, const void* negs,
                             const void* nmask, const void* alpha, int64_t P,
                             int32_t n, int64_t d, void* c_pos, void* c_neg,
                             void* h, void* d_center, void* loss,
                             void* stream) {
  return forward(true, syn0, syn1, stride, dtype, centers, contexts, mask,
                 negs, nmask, alpha, P, n, d, c_pos, c_neg, h, d_center, loss,
                 stream, nullptr);
}

// The launch glint_pair_forward (tiled = 0) or glint_pair_forward_tiled
// (tiled = 1) makes for these arguments, into out[0..4]: blocks, pairs a
// block, blocks an SM holds at once, SMs, and the form (0 one-pass, 1
// tiled).
int glint_pair_forward_grid(const void* syn0, const void* syn1, int64_t stride,
                            int32_t dtype, int64_t P, int32_t n, int64_t d,
                            int32_t tiled, int64_t* out) {
  if (P < 0 || n < 1 || d <= 0 || stride < d) return cudaErrorInvalidValue;
  Launch l;
  const int e = choose(dtype, syn0, syn1, stride, n, d, tiled != 0, &l);
  if (e != cudaSuccess) return e;
  out[0] = (P + l.plan.warps - 1) / l.plan.warps;
  out[1] = l.plan.warps;
  out[2] = l.plan.per_sm;
  out[3] = l.plan.sms;
  out[4] = l.form;
  return cudaSuccess;
}

const char* glint_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
