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
// Design: one wave. The grid holds min(N, the warps the card keeps
// resident at once) warps (the occupancy API, read once), and each warp
// takes an equal share of the rows, to within one, so no partial second
// wave trails the first, every SM gets the same work, and a small call
// (N = 64 on the served path) still spreads one row a warp over 8
// blocks. A warp takes its rows kRows = 2 at a time: it loads their ids
// together, one lane a row, then issues every load of the group's rows
// (up to 384 columns a row a pass) before its first store. Two rows a
// group keep the kernel at 48 registers, five blocks an SM; four rows
// (64 registers, four blocks) and one row (more warps, each waiting on
// its loads alone) were slower at N = 10,000 (PERF.md §6). A lane moves
// 16 bytes a load where the source and destination rows start on 16-byte
// boundaries (an fp32 row at d = 300 is 1,200 bytes, so every row does),
// 8-byte bf16 loads where the source is only 8-byte aligned (a bf16 row
// at d = 300 is 600 bytes, so odd ids start 8 bytes off), and scalars
// for anything else and for the tail.
// Row offsets are 64-bit: at V = 10,000,000 and d = 300, id * d reaches
// 3.0e9, past 2^31.
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
constexpr int kRows = 2;   // rows a warp moves together (see Design)
constexpr int kUnits = 3;  // 16-byte output units a lane holds a row a pass

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
__device__ __forceinline__ float4 bf16x4(uint2 v) {
  return make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y));
}

__device__ __forceinline__ float load_f(const float* p, int64_t j) {
  return __ldg(p + j);
}
__device__ __forceinline__ float load_f(const uint16_t* p, int64_t j) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p + j)) << 16);
}

// Output unit u (4 columns, 16 bytes of fp32) of a row: fp32 rows load it
// as one float4; bf16 rows as one 8-byte load (4 values).
__device__ __forceinline__ float4 load_unit(const float* src, int64_t u) {
  return __ldg(reinterpret_cast<const float4*>(src) + u);
}
__device__ __forceinline__ float4 load_unit(const uint16_t* src, int64_t u) {
  return bf16x4(__ldg(reinterpret_cast<const uint2*>(src) + u));
}

// Whether a source row can be read in 16-byte units (fp32) or 8-byte ones
// (bf16), four values each.
template <typename T>
__device__ __forceinline__ bool unit_aligned(const T* src) {
  return aligned_to(src, 4 * sizeof(T));
}

// The rows r0 .. r0 + kRows - 1 that lie below `last`, with every load of
// the group issued before the first store.
template <typename T>
__device__ __forceinline__ void gather_group(
    const T* __restrict__ table, const int32_t* __restrict__ ids,
    float* __restrict__ out, int64_t last, int64_t d, int64_t stride,
    int64_t r0, int lane) {
  const int32_t mine =
      lane < kRows && r0 + lane < last ? __ldg(ids + r0 + lane) : 0;
  const T* src[kRows];
  bool vec[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    src[r] = table + static_cast<int64_t>(__shfl_sync(0xffffffffu, mine, r)) *
                         stride;
    // d % 4 == 0 keeps every fp32 output row 16-byte aligned.
    vec[r] = d % 4 == 0 && unit_aligned(src[r]);
  }
  const int64_t units = d / 4;
  for (int64_t c0 = 0; c0 < units; c0 += 32 * kUnits) {
    float4 v[kRows][kUnits];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        const int64_t u = c0 + lane + 32 * i;
        v[r][i] = r0 + r < last && vec[r] && u < units
                      ? load_unit(src[r], u)
                      : make_float4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float4* dst = reinterpret_cast<float4*>(out + (r0 + r) * d);
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        const int64_t u = c0 + lane + 32 * i;
        if (r0 + r < last && vec[r] && u < units) dst[u] = v[r][i];
      }
    }
  }
  // Rows that are not unit-aligned, and the tail of every row.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r0 + r >= last) break;
    float* dst = out + (r0 + r) * d;
    for (int64_t j = (vec[r] ? units * 4 : 0) + lane; j < d; j += 32) {
      dst[j] = load_f(src[r], j);
    }
  }
}

// Warp w of `warps` takes rows [w * n / warps, (w + 1) * n / warps), in
// groups of kRows: every warp gets the same number of rows to within one.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                   float* __restrict__ out, int64_t n, int64_t d,
                   int64_t stride, int64_t warps) {
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= warps) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int64_t last = (w + 1) * n / warps;
  for (int64_t r0 = w * n / warps; r0 < last; r0 += kRows) {
    gather_group(table, ids, out, last, d, stride, r0, lane);
  }
}

// The launch for n rows: min(n, the warps the card holds at once) warps
// (*per_sm blocks an SM, *sms SMs; read once a device and kept), so no
// partial second wave trails the first and a small call still spreads
// one row a warp over many SMs.
template <typename T>
cudaError_t grid_for(int64_t n, int64_t* warps, int* per_sm, int* sms) {
  constexpr int kDevices = 64;
  static int known_sms[kDevices], known_per_sm[kDevices];  // 0: not read
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && known_per_sm[dev] > 0) {
    *sms = known_sms[dev];
    *per_sm = known_per_sm[dev];
  } else {
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, gather_rows_kernel<T>, kThreads, 0);
    }
    if (e != cudaSuccess) return e;
    if (dev < kDevices) {
      known_sms[dev] = *sms;
      known_per_sm[dev] = *per_sm;
    }
  }
  const int64_t cap = static_cast<int64_t>(*per_sm) * *sms * kWarpsPerBlock;
  *warps = n < cap ? n : cap;
  return e;
}

template <typename T>
int launch(const void* table, const void* ids, void* out, int64_t n,
           int64_t d, int64_t stride, cudaStream_t s) {
  int64_t warps = 0;
  int per_sm = 0, sms = 0;
  const cudaError_t e = grid_for<T>(n, &warps, &per_sm, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gather_rows_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(ids),
      static_cast<float*>(out), n, d, stride, warps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the gather on `stream` and returns cudaGetLastError() as an int
// (0 = launched). `table` is [V, stride] of `dtype` (0 = f32, 1 = bf16) with
// rows of d <= stride elements; `ids` is [n] int32; `out` is [n, d] fp32,
// contiguous and 16-byte aligned. Does not synchronise and allocates
// nothing.
int glint_gather_rows(const void* table, const void* ids, void* out,
                      int64_t n, int64_t d, int64_t stride, int32_t dtype,
                      void* stream) {
  if (n < 0 || d <= 0 || stride < d) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kDtypeF32:
      return launch<float>(table, ids, out, n, d, stride, s);
    case kDtypeBF16:
      return launch<uint16_t>(table, ids, out, n, d, stride, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The launch glint_gather_rows makes for n rows of `dtype`: out[0] its
// blocks, out[1] the blocks an SM holds at once, out[2] the card's SMs
// (so out[0] / (out[1] * out[2]) is its number of waves). Returns a
// cudaError_t as an int.
int glint_gather_rows_grid(int64_t n, int32_t dtype, int64_t* out) {
  int64_t warps = 0;
  int per_sm = 0, sms = 0;
  const cudaError_t e = dtype == kDtypeF32
                            ? grid_for<float>(n, &warps, &per_sm, &sms)
                            : grid_for<uint16_t>(n, &warps, &per_sm, &sms);
  out[0] = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  out[1] = per_sm;
  out[2] = sms;
  return static_cast<int>(e);
}

const char* glint_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
