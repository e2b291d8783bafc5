// Row gather for Hopper (sm_90a): out[i, :] = float32(table[ids[i], :]).
//
// Replaces glint_word2vec_tpu/ops/pallas_rows.py::gather_rows (kernel body
// _gather_kernel), which the JAX engine reaches through _pull_rows
// (glint_word2vec_tpu/parallel/engine.py:95-115) and then upcasts to fp32.
// Here the upcast is fused into the copy: a bf16 table is read once and
// never materialised as a bf16 intermediate.
//
// Bound: memory bandwidth. One call moves N*d*(itemsize + 4) + 4*N bytes
// (the rows read, the fp32 rows written, the ids read) and does no
// arithmetic, so its least time on an H100 SXM is those bytes at 3.35 TB/s.
//
// Design: one warp per output row, kWarpsPerBlock rows per block, no shared
// memory. A lane moves 16 bytes per load where the source row and the
// destination row both start on a 16-byte boundary (an fp32 row at d=300 is
// 1,200 bytes, so every row does), 8-byte bf16 loads where the source is
// only 8-byte aligned (a bf16 row at d=300 is 600 bytes, so odd ids start 8
// bytes off), and scalars for the tail and for anything else. Row offsets
// are 64-bit: at V=10,000,000 and d=300, id*d reaches 3.0e9, past 2^31.
// TMA or cp.async staging is later work.
//
// Precondition, kept by the wrapper's caller: every id lies in [0, V). The
// engine clips ids and masks rows it does not own around the kernel, as
// _pull_rows does around the TPU kernel.
//
// Plain C interface, built by glint_word2vec_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes by glint_word2vec_torch/ops/rows.py.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

constexpr int32_t kDtypeF32 = 0;
constexpr int32_t kDtypeBF16 = 1;

__device__ __forceinline__ bool aligned_to(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32 bits.
// A 32-bit word holds two bf16 values, the lower-addressed one in its low
// half (little endian).
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__global__ void __launch_bounds__(kThreads)
gather_rows_f32_kernel(const float* __restrict__ table,
                       const int32_t* __restrict__ ids,
                       float* __restrict__ out,
                       int64_t n, int64_t d, int64_t stride) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const int lane = threadIdx.x & 31;
  const float* src = table + static_cast<int64_t>(__ldg(ids + row)) * stride;
  float* dst = out + row * d;
  int64_t done = 0;
  if (aligned_to(src, 16) && aligned_to(dst, 16)) {
    const int64_t nv = d >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int64_t j = lane; j < nv; j += 32) d4[j] = __ldg(s4 + j);
    done = nv << 2;
  }
  for (int64_t j = done + lane; j < d; j += 32) dst[j] = __ldg(src + j);
}

__global__ void __launch_bounds__(kThreads)
gather_rows_bf16_kernel(const uint16_t* __restrict__ table,
                        const int32_t* __restrict__ ids,
                        float* __restrict__ out,
                        int64_t n, int64_t d, int64_t stride) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const int lane = threadIdx.x & 31;
  const uint16_t* src =
      table + static_cast<int64_t>(__ldg(ids + row)) * stride;
  float* dst = out + row * d;
  float4* d4 = reinterpret_cast<float4*>(dst);
  int64_t done = 0;
  if (aligned_to(dst, 16) && aligned_to(src, 16)) {
    // 8 bf16 (16 bytes) in, 8 fp32 (32 bytes) out per lane step.
    const int64_t nv = d >> 3;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    for (int64_t j = lane; j < nv; j += 32) {
      const uint4 v = __ldg(s + j);
      d4[2 * j] = make_float4(bf16_lo(v.x), bf16_hi(v.x),
                              bf16_lo(v.y), bf16_hi(v.y));
      d4[2 * j + 1] = make_float4(bf16_lo(v.z), bf16_hi(v.z),
                                  bf16_lo(v.w), bf16_hi(v.w));
    }
    done = nv << 3;
  } else if (aligned_to(dst, 16) && aligned_to(src, 8)) {
    // 4 bf16 (8 bytes) in, 4 fp32 (16 bytes) out per lane step.
    const int64_t nv = d >> 2;
    const uint2* s = reinterpret_cast<const uint2*>(src);
    for (int64_t j = lane; j < nv; j += 32) {
      const uint2 v = __ldg(s + j);
      d4[j] = make_float4(bf16_lo(v.x), bf16_hi(v.x),
                          bf16_lo(v.y), bf16_hi(v.y));
    }
    done = nv << 2;
  }
  for (int64_t j = done + lane; j < d; j += 32) {
    dst[j] = __uint_as_float(static_cast<uint32_t>(__ldg(src + j)) << 16);
  }
}

}  // namespace

extern "C" {

// Launches the gather on `stream` and returns cudaGetLastError() as an int
// (0 = launched). `table` is [V, stride] of `dtype` (0 = f32, 1 = bf16) with
// rows of d <= stride elements; `ids` is [n] int32; `out` is [n, d] fp32,
// contiguous. Does not synchronise and allocates nothing.
int glint_gather_rows(const void* table, const void* ids, void* out,
                      int64_t n, int64_t d, int64_t stride, int32_t dtype,
                      void* stream) {
  if (n < 0 || d <= 0 || stride < d) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* id = static_cast<const int32_t*>(ids);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case kDtypeF32:
      gather_rows_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<const float*>(table), id, o, n, d, stride);
      break;
    case kDtypeBF16:
      gather_rows_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<const uint16_t*>(table), id, o, n, d, stride);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* glint_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
