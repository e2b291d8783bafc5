// Forward half of the fused SGNS pair step for Hopper (sm_90a).
//
// Replaces glint_word2vec_tpu/ops/pallas_sgns.py::pair_forward (kernel body
// _pair_forward_kernel, :113-197), the first phase of fused_pair_step. For
// each pair p of a dense pair batch it gathers h = syn0[centers[p]],
// u = syn1[contexts[p]] and the n rows syn1[negs[p, k]] in storage dtype,
// upcasts them to fp32 and writes
//   c_pos[p]    = alpha * (1 - sigmoid(h.u)) * mask[p]
//   c_neg[p, k] = -alpha * sigmoid(h.neg_k) * nmask[p, k]
//   h_out[p]    = h (fp32)
//   d_center[p] = c_pos[p] * u + sum_k c_neg[p, k] * neg_k
//   loss[p]     = (-log sigmoid(h.u) - sum_k log sigmoid(-h.neg_k) * nmask[p, k])
//                 * mask[p]
// The TPU kernel carries the loss sum across its sequential grid steps
// (:193-197). Hopper blocks run in no order, so this kernel writes one loss
// per pair and the wrapper reduces them in a fixed order: no float atomics.
//
// Bound: memory bandwidth. A call must read (2 + n) rows of d storage-dtype
// values per pair and write two fp32 rows (h and d_center) per pair, about
// ((2 + n) * P * d * s + 2 * P * d * 4) bytes; the arithmetic, 2 * (1 + 2n)
// * d flops per pair, is far below the card's rate for those bytes.
//
// Design: one warp per pair, eight pairs per block. The warp stages h in
// fp32 in shared memory, takes every dot product as per-lane fused
// multiply-adds over columns lane, lane + 32, ... and a butterfly of
// shuffles, and keeps the pair's c_neg in shared memory for the d_center
// pass. The u and negative rows are read a second time for d_center; that
// second read mostly hits L1/L2. Staging the rows with TMA or cp.async, and
// vector loads, are later work. Row offsets are 64-bit: id * d passes 2^31
// at V = 10,000,000.
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

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr size_t kDefaultSmem = 48 * 1024;

constexpr int32_t kDtypeF32 = 0;
constexpr int32_t kDtypeBF16 = 1;

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return __ldg(p + i);
}

// bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32 bits.
__device__ __forceinline__ float load_f(const uint16_t* p, int64_t i) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p + i)) << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// log(sigmoid(x)) = -softplus(-x) = -(max(-x, 0) + log1p(exp(-|x|))).
__device__ __forceinline__ float log_sigmoid(float x) {
  return -(fmaxf(-x, 0.0f) + log1pf(expf(-fabsf(x))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
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
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (p >= P) return;
  // This warp's slice: d floats of h, then n floats of c_neg.
  float* hs = smem + static_cast<int64_t>(warp) * (d + n);
  float* cn = hs + d;
  const float alpha = __ldg(alpha_p);
  const T* hrow = syn0 + static_cast<int64_t>(__ldg(centers + p)) * stride;
  const T* urow = syn1 + static_cast<int64_t>(__ldg(contexts + p)) * stride;
  const int32_t* pneg = negs + p * n;
  float* hdst = h_out + p * d;

  float acc = 0.0f;
  for (int64_t j = lane; j < d; j += 32) {
    const float hv = load_f(hrow, j);
    hs[j] = hv;
    hdst[j] = hv;
    acc = fmaf(hv, load_f(urow, j), acc);
  }
  const float f_pos = warp_sum(acc);
  const float m = __ldg(mask + p);
  const float c_pos = alpha * (1.0f - sigmoid(f_pos)) * m;
  float loss = -log_sigmoid(f_pos);

  for (int k = 0; k < n; ++k) {
    const T* nrow = syn1 + static_cast<int64_t>(__ldg(pneg + k)) * stride;
    float a = 0.0f;
    for (int64_t j = lane; j < d; j += 32) a = fmaf(hs[j], load_f(nrow, j), a);
    const float f_neg = warp_sum(a);
    const float nm = __ldg(nmask + p * n + k);
    const float c = -alpha * sigmoid(f_neg) * nm;
    if (lane == 0) {
      cn[k] = c;
      c_neg_out[p * n + k] = c;
    }
    loss -= log_sigmoid(-f_neg) * nm;
  }
  __syncwarp();

  float* ddst = dcen_out + p * d;
  for (int64_t j = lane; j < d; j += 32) {
    float v = c_pos * load_f(urow, j);
    for (int k = 0; k < n; ++k) {
      const T* nrow = syn1 + static_cast<int64_t>(__ldg(pneg + k)) * stride;
      v = fmaf(cn[k], load_f(nrow, j), v);
    }
    ddst[j] = v;
  }
  if (lane == 0) {
    c_pos_out[p] = c_pos;
    loss_out[p] = loss * m;
  }
}

template <typename T>
int launch(const void* syn0, const void* syn1, int64_t stride,
           const void* centers, const void* contexts, const void* mask,
           const void* negs, const void* nmask, const void* alpha, int64_t P,
           int n, int64_t d, void* c_pos, void* c_neg, void* h, void* dcen,
           void* loss, cudaStream_t s) {
  const size_t smem = sizeof(float) * kWarpsPerBlock * static_cast<size_t>(d + n);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_forward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  pair_forward_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const T*>(syn0), static_cast<const T*>(syn1), stride,
      static_cast<const int32_t*>(centers), static_cast<const int32_t*>(contexts),
      static_cast<const float*>(mask), static_cast<const int32_t*>(negs),
      static_cast<const float*>(nmask), static_cast<const float*>(alpha), P, n,
      d, static_cast<float*>(c_pos), static_cast<float*>(c_neg),
      static_cast<float*>(h), static_cast<float*>(dcen),
      static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the forward pass on `stream` and returns cudaGetLastError() as
// an int (0 = launched). syn0/syn1 are [V, stride] of `dtype` (0 = f32,
// 1 = bf16); centers, contexts [P] int32; mask [P] f32; negs [P, n] int32;
// nmask [P, n] f32; alpha a device f32 scalar. Outputs, contiguous fp32:
// c_pos [P], c_neg [P, n], h [P, d], d_center [P, d], loss [P]. Does not
// synchronise and allocates nothing.
int glint_pair_forward(const void* syn0, const void* syn1, int64_t stride,
                       int32_t dtype, const void* centers, const void* contexts,
                       const void* mask, const void* negs, const void* nmask,
                       const void* alpha, int64_t P, int32_t n, int64_t d,
                       void* c_pos, void* c_neg, void* h, void* d_center,
                       void* loss, void* stream) {
  if (P < 0 || n < 1 || d <= 0 || stride < d) return cudaErrorInvalidValue;
  if (P == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kDtypeF32:
      return launch<float>(syn0, syn1, stride, centers, contexts, mask, negs,
                           nmask, alpha, P, n, d, c_pos, c_neg, h, d_center,
                           loss, s);
    case kDtypeBF16:
      return launch<uint16_t>(syn0, syn1, stride, centers, contexts, mask,
                              negs, nmask, alpha, P, n, d, c_pos, c_neg, h,
                              d_center, loss, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* glint_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
