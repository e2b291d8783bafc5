// Run-summing table scatters for Hopper (sm_90a), the update half of the
// fused SGNS pair step:
//   scatter_add_rows_f32   table[ids[k]] += upd[k]              (syn0 update)
//   scatter_add_rank1_hbm  table[ids[k]] += coef[k] * h[hidx[k]] (syn1 update)
//
// Replaces glint_word2vec_tpu/ops/pallas_sgns.py::scatter_add_rows_f32
// (kernels _scatter_rows_f32_kernel and _scatter_runs_f32, :504-639) and
// ::scatter_add_rank1_hbm (kernel _scatter_rank1_hbm_kernel, :642-723).
// The wrapper sorts the ids stably and hands in the sorted ids and the
// permutation (`order`); equal ids then form contiguous runs, and each run
// belongs to exactly one warp: the warp whose position is the run's first.
// That warp reads the table row once, adds the run's updates to it in fp32
// in sorted (= input) order, rounds to the storage dtype once and writes
// the row once. The TPU kernel lets a run span two sequential grid steps
// (:555-556); on Hopper two blocks holding one run would race, so the work
// is segmented at run starts instead, and no float atomics are used: the
// result is deterministic. The sums use __fadd_rn / __fmul_rn so that nvcc
// contracts nothing into an FMA; the kernels are then bitwise equal to
// their plain versions run on the CPU (index_add_ over the sorted ids adds
// in input order there). Under bf16 storage a run rounds once here, where
// the TPU kernel rounds once per grid block the run spans.
//
// Bound: memory bandwidth. A call must read the P x d fp32 payload rows
// (upd, or h), read and write each of the R distinct table rows once in
// storage dtype, and read per update its sorted id and permutation entry
// (8 bytes), plus its coefficient and h row index for the rank-1 scatter
// (16 bytes): about (P * d * 4 + 2 * R * d * s + N * 8 or N * 16) bytes.
//
// Design: one warp per sorted position; warps not at a run start exit at
// once. A run's warp keeps up to 8 columns per lane (256 per pass) in
// registers and walks the run for each pass. A long run (a frequent word
// drawn as a negative hundreds of times in one step) is summed serially by
// its one warp; splitting long runs with a fixed-order second pass is
// later work. Row offsets are 64-bit: id * d passes 2^31 at V = 10,000,000.
//
// Preconditions: sorted_ids is sorted and order is a permutation of
// [0, N) that sorts the ids stably (the wrapper's sort keeps both); every
// id lies in [0, V) (the caller keeps this: no id is range-checked here).
//
// Plain C interface, built by glint_word2vec_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes by glint_word2vec_torch/ops/fused_sgns.py.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kCols = 8;  // columns per lane per pass

constexpr int32_t kDtypeF32 = 0;
constexpr int32_t kDtypeBF16 = 1;

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}

// bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32 bits.
__device__ __forceinline__ float load_f(const uint16_t* p, int64_t i) {
  return __uint_as_float(static_cast<uint32_t>(p[i]) << 16);
}

__device__ __forceinline__ void store_f(float* p, int64_t i, float v) {
  p[i] = v;
}

// fp32 -> bf16, round to nearest even (what torch's .to(bfloat16) does).
__device__ __forceinline__ void store_f(uint16_t* p, int64_t i, float v) {
  p[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Payload of update k, column j.
struct RowsPayload {
  const float* upd;  // [N, d] fp32, in input order
  int64_t d;
  __device__ __forceinline__ const float* row(int32_t src) const {
    return upd + static_cast<int64_t>(src) * d;
  }
  __device__ __forceinline__ float scale(int32_t) const { return 1.0f; }
  static constexpr bool kScaled = false;
};

struct Rank1Payload {
  const float* coef;    // [N]
  const float* h;       // [B, h_stride] fp32
  const int32_t* hidx;  // [N]
  int64_t h_stride;
  __device__ __forceinline__ const float* row(int32_t src) const {
    return h + static_cast<int64_t>(__ldg(hidx + src)) * h_stride;
  }
  __device__ __forceinline__ float scale(int32_t src) const {
    return __ldg(coef + src);
  }
  static constexpr bool kScaled = true;
};

template <typename T, typename Payload>
__global__ void __launch_bounds__(kThreads)
scatter_runs_kernel(T* __restrict__ table, int64_t stride, int64_t d,
                    const int32_t* __restrict__ sorted_ids,
                    const int32_t* __restrict__ order, int64_t n,
                    Payload pay) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    (threadIdx.x >> 5);
  if (w >= n) return;
  const int lane = threadIdx.x & 31;
  const int32_t id = __ldg(sorted_ids + w);
  if (w > 0 && __ldg(sorted_ids + w - 1) == id) return;  // not a run start
  int64_t end = w + 1;
  while (end < n && __ldg(sorted_ids + end) == id) ++end;
  T* trow = table + static_cast<int64_t>(id) * stride;

  for (int64_t c0 = 0; c0 < d; c0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int64_t j = c0 + lane + 32 * i;
      acc[i] = j < d ? load_f(trow, j) : 0.0f;
    }
    for (int64_t k = w; k < end; ++k) {
      const int32_t src = __ldg(order + k);
      const float* prow = pay.row(src);
      const float c = pay.scale(src);
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int64_t j = c0 + lane + 32 * i;
        if (j < d) {
          const float v = Payload::kScaled ? __fmul_rn(c, __ldg(prow + j))
                                           : __ldg(prow + j);
          acc[i] = __fadd_rn(acc[i], v);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int64_t j = c0 + lane + 32 * i;
      if (j < d) store_f(trow, j, acc[i]);
    }
  }
}

template <typename Payload>
int launch(void* table, int64_t stride, int64_t d, int32_t dtype,
           const void* sorted_ids, const void* order, int64_t n,
           const Payload& pay, cudaStream_t s) {
  if (n < 0 || d <= 0 || stride < d) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const unsigned g = static_cast<unsigned>(blocks);
  const int32_t* ids = static_cast<const int32_t*>(sorted_ids);
  const int32_t* ord = static_cast<const int32_t*>(order);
  switch (dtype) {
    case kDtypeF32:
      scatter_runs_kernel<float, Payload><<<g, kThreads, 0, s>>>(
          static_cast<float*>(table), stride, d, ids, ord, n, pay);
      break;
    case kDtypeBF16:
      scatter_runs_kernel<uint16_t, Payload><<<g, kThreads, 0, s>>>(
          static_cast<uint16_t*>(table), stride, d, ids, ord, n, pay);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both launch on `stream` and return cudaGetLastError() as an int
// (0 = launched). `table` is [V, stride] of `dtype` (0 = f32, 1 = bf16),
// updated in place; sorted_ids and order are [n] int32. Neither
// synchronises or allocates.

// upd is [n, d] fp32, contiguous, in input (unsorted) order.
int glint_scatter_add_rows_f32(void* table, int64_t stride, int64_t d,
                               int32_t dtype, const void* sorted_ids,
                               const void* order, int64_t n, const void* upd,
                               void* stream) {
  RowsPayload pay{static_cast<const float*>(upd), d};
  return launch(table, stride, d, dtype, sorted_ids, order, n, pay,
                static_cast<cudaStream_t>(stream));
}

// coef [n] fp32 and hidx [n] int32 in input order; h is [B, h_stride]
// fp32 with rows of at least d values.
int glint_scatter_add_rank1(void* table, int64_t stride, int64_t d,
                            int32_t dtype, const void* sorted_ids,
                            const void* order, int64_t n, const void* coef,
                            const void* h, const void* hidx, int64_t h_stride,
                            void* stream) {
  if (h_stride < d) return cudaErrorInvalidValue;
  Rank1Payload pay{static_cast<const float*>(coef),
                   static_cast<const float*>(h),
                   static_cast<const int32_t*>(hidx), h_stride};
  return launch(table, stride, d, dtype, sorted_ids, order, n, pay,
                static_cast<cudaStream_t>(stream));
}

const char* glint_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
