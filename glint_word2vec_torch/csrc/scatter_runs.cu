// Run-summing table scatters for Hopper (sm_90a). Four entry points over
// one kernel template:
//   scatter_add_rows_f32   table[ids[k]] += upd[k]               (fp32 upd)
//   scatter_add_rank1_hbm  table[ids[k]] += coef[k] * h[hidx[k]]
//       fp32 run sums, one rounding to the storage dtype per run: the
//       update half of the fused SGNS pair step;
//   scatter_add_rows       table[ids[k]] += upd[k] cast to the table's
//                          dtype                                 (fp32 upd)
//   scatter_add_rank1      table[ids[k]] += (coef[k] * h[hidx[k]]) cast to
//                          the table's dtype
//       runs summed in the table's dtype, one rounding per add: the
//       updates of the composed step (fastText, the host batcher).
//
// Replaces glint_word2vec_tpu/ops/pallas_sgns.py::scatter_add_rows_f32
// (kernels _scatter_rows_f32_kernel and _scatter_runs_f32, :504-639),
// ::scatter_add_rank1_hbm (kernel _scatter_rank1_hbm_kernel, :642-723),
// glint_word2vec_tpu/ops/pallas_rows.py::scatter_add_rows (kernels
// _scatter_kernel and _scatter_runs, :109-196, :275-326) and
// ::scatter_add_rank1 (kernel _scatter_rank1_kernel, :198-272).
//
// The wrapper sorts the ids stably and hands in the sorted ids and the
// permutation (`order`); equal ids then form contiguous runs, and each
// column of a run's table row belongs to exactly one lane (see Design),
// which reads it once, adds the run's updates to it in sorted (= input)
// order and writes it once. The TPU kernels let a run
// span sequential grid steps; on Hopper two blocks holding one run would
// race, so the work is segmented at run starts instead, and no float
// atomics are used: the result is deterministic. The sums use __fadd_rn /
// __fmul_rn so that nvcc contracts nothing into an FMA, and the kernels are
// bitwise equal to their plain versions run on the CPU (index_add_ over the
// sorted ids adds in input order there).
//
// The two contracts differ only under bf16 storage. The fp32-sum policy
// (kRoundEach = false) keeps the run's sum in fp32 and rounds once per run
// (the TPU kernel rounds once per grid block the run spans). The table-dtype
// policy (kRoundEach = true) rounds the update row to the table's dtype and
// every partial sum to it, as the TPU kernel's table-dtype accumulator does:
// under bf16 that is an fp32 add and a round to nearest even per update.
// For fp32 tables both policies are ((row + u0) + u1) + ... in fp32. Every
// payload is fp32: the table-dtype policy rounds each update to the table's
// dtype in the kernel, which is the cast the TPU wrapper makes before its
// kernel (pallas_rows.py:291), with the same result: round to nearest
// even. (bf16 payload rows, read as 2-byte words, made the long-run path
// several times slower on an H100.)
//
// Bound: memory bandwidth. A call must read the payload rows (N x d fp32,
// or the B x d fp32 h of the rank-1 forms), read and write
// each of the R distinct table rows once in storage dtype, and read per
// update its sorted id and permutation entry (8 bytes), plus its
// coefficient and h row index for the rank-1 forms (16 bytes).
//
// Design: one warp per sorted position. Each lane loads one update's
// permutation entry (and coefficient and h row index) and the warp
// broadcasts them with shuffles, so the row loads of consecutive updates do
// not wait on a chain of scalar index loads; the run's end comes from a
// ballot over the next 32 ids, then a galloping search for longer runs.
// - A short run (under 32 updates, almost every run) belongs to the warp at
//   its first position, which keeps up to 10 columns per lane (320 per
//   pass, so d = 300 is one pass) in registers; the other warps exit.
// - A long run (row 0, which every padded slot of a grid batch targets, or
//   a frequent word drawn as a negative many times in one step) is shared
//   by the warps at its first min(ceil(d / 32), 32) positions, each taking
//   32-column slices of the row. A lane loads its column of 32 updates
//   before adding them in order, so 32 row loads are in flight where one
//   warp adding update after update had one. Every column is still one
//   lane's serial sum in sorted order, so the result is unchanged; the
//   run's length still sets its time (splitting a run's sum is not allowed
//   by the table-dtype contract, which rounds after every add).
// Row offsets are 64-bit: id * d passes 2^31 at V = 10,000,000. bf16 table
// rows are read as 2-byte words, so any row alignment is fine.
//
// Preconditions: sorted_ids is sorted and order is a permutation of
// [0, N) that sorts the ids stably (the wrapper's sort keeps both); every
// id lies in [0, V) (the caller keeps this: no id is range-checked here).
//
// Plain C interface, built by glint_word2vec_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes by glint_word2vec_torch/ops/fused_sgns.py (the
// fp32-sum forms) and glint_word2vec_torch/ops/rows.py (the table-dtype
// forms).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kCols = 10;  // columns per lane per pass of a short run
constexpr int kLongRun = 32;  // runs this long or longer take helper warps
constexpr int kHelpers = 32;  // at most this many warps share one run
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

constexpr int32_t kDtypeF32 = 0;
constexpr int32_t kDtypeBF16 = 1;

// Table rows are read with plain loads (the warp writes them back later);
// payload rows, which no launch writes, through the read-only cache
// (__ldg).
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

// The value of `v` rounded to the storage dtype T, as an fp32.
template <typename T>
__device__ __forceinline__ float round_to(float v);

template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float round_to<uint16_t>(float v) {
  return __uint_as_float(
      static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)))
      << 16);
}

// Per-update data a lane prefetches for the warp: the source row index and
// a coefficient.
struct Meta {
  int32_t row;
  float coef;
};

// Update k is row order[k] of upd ([N, d] fp32, in input order).
struct RowsPayload {
  const float* upd;
  int64_t d;
  struct Row {
    const float* p;
    __device__ __forceinline__ float at(int64_t j) const { return __ldg(p + j); }
  };
  __device__ __forceinline__ Meta meta(int32_t src) const { return {src, 1.0f}; }
  __device__ __forceinline__ Row row(Meta m) const {
    return {upd + static_cast<int64_t>(m.row) * d};
  }
};

// Update k is coef[order[k]] * h[hidx[order[k]]].
struct Rank1Payload {
  const float* coef;    // [N]
  const float* h;       // [B, h_stride] fp32
  const int32_t* hidx;  // [N]
  int64_t h_stride;
  struct Row {
    const float* p;
    float c;
    __device__ __forceinline__ float at(int64_t j) const {
      return __fmul_rn(c, __ldg(p + j));
    }
  };
  __device__ __forceinline__ Meta meta(int32_t src) const {
    return {__ldg(hidx + src), __ldg(coef + src)};
  }
  __device__ __forceinline__ Row row(Meta m) const {
    return {h + static_cast<int64_t>(m.row) * h_stride, m.coef};
  }
};

// acc + x under the policy: fp32 sums, or every add rounded to T.
template <typename T, bool kRoundEach>
__device__ __forceinline__ float add(float acc, float x) {
  if (kRoundEach) return round_to<T>(__fadd_rn(acc, round_to<T>(x)));
  return __fadd_rn(acc, x);
}

// The end of the run of `id` that holds position `a`: the least e > a with
// e == n or sorted_ids[e] != id. The ids equal to `id` after `a` are a
// prefix, so every probe below is a ballot over a prefix of lanes: first
// the 32 ids after `a` (most runs end there), then, for a longer run,
// lanes probe a + 2^lane and the bracket found is cut 32 ways a round
// (a run of 9,262 takes 5 probes instead of 290).
__device__ __forceinline__ int64_t run_end(const int32_t* __restrict__ ids,
                                           int64_t n, int64_t a, int32_t id,
                                           int lane) {
  const int64_t p = a + 1 + lane;
  unsigned m = __ballot_sync(kFull, p < n && __ldg(ids + p) == id);
  if (m != kFull) return a + __ffs(~m);
  a += 32;  // in the run
  const int64_t q = a + (int64_t{1} << lane);
  m = __ballot_sync(kFull, q < n && __ldg(ids + q) == id);
  const int c = __popc(m);
  int64_t lo = c == 0 ? a : a + (int64_t{1} << (c - 1));  // in the run
  int64_t hi = c == 32 ? n : min64(n, a + (int64_t{1} << c));  // past it
  while (hi - lo > 1) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t r = lo + step * (lane + 1);
    m = __ballot_sync(kFull, r < hi && __ldg(ids + r) == id);
    const int64_t in = lo + step * __popc(m);
    hi = min64(hi, in + step);
    lo = in;
  }
  return hi;
}

template <typename T, typename Payload, bool kRoundEach>
__global__ void __launch_bounds__(kThreads)
scatter_runs_kernel(T* __restrict__ table, int64_t stride, int64_t d,
                    const int32_t* __restrict__ sorted_ids,
                    const int32_t* __restrict__ order, int64_t n,
                    Payload pay) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    (threadIdx.x >> 5);
  if (w >= n) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int32_t id = __ldg(sorted_ids + w);

  // w's offset k in its run, if k < helpers: the ids before w equal to
  // `id` are a prefix of the lanes' probes.
  const int64_t slices = (d + 31) / 32;
  const int helpers = static_cast<int>(slices < kHelpers ? slices : kHelpers);
  const int64_t back = w - 1 - lane;
  const unsigned before = __ballot_sync(
      kFull, lane < helpers && back >= 0 && __ldg(sorted_ids + back) == id);
  if (before == kFull) return;
  const int k = __ffs(~before) - 1;
  if (k >= helpers) return;
  const int64_t s0 = w - k;  // the run's first position
  // A short run belongs to its first warp alone.
  if (k > 0) {
    const int64_t q = s0 + kLongRun - 1;
    if (!(q < n && __ldg(sorted_ids + q) == id)) return;
  }
  const int64_t end = run_end(sorted_ids, n, s0, id, lane);
  const int64_t len = end - s0;
  T* trow = table + static_cast<int64_t>(id) * stride;

  if (len < kLongRun) {
    // Short run, one warp: kCols columns a lane per pass, the updates in
    // order, each update's row loads issued together.
    Meta mine{0, 0.0f};
    if (lane < len) mine = pay.meta(__ldg(order + s0 + lane));
    const int cnt = static_cast<int>(len);
    for (int64_t c0 = 0; c0 < d; c0 += 32 * kCols) {
      float acc[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int64_t j = c0 + lane + 32 * i;
        acc[i] = j < d ? load_f(trow, j) : 0.0f;
      }
#pragma unroll 4
      for (int t = 0; t < cnt; ++t) {
        const Meta m{__shfl_sync(kFull, mine.row, t),
                     __shfl_sync(kFull, mine.coef, t)};
        const typename Payload::Row row = pay.row(m);
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int64_t j = c0 + lane + 32 * i;
          if (j < d) acc[i] = add<T, kRoundEach>(acc[i], row.at(j));
        }
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int64_t j = c0 + lane + 32 * i;
        if (j < d) store_f(trow, j, acc[i]);
      }
    }
    return;
  }

  // Long run: `helpers` warps split the row into 32-column slices (warp k
  // takes slices k, k + helpers, ...), and each walks the whole run for
  // its slice, one column a lane. A lane loads its column of 32 updates
  // before it adds any of them, and the next 32 updates' indices are
  // fetched before the adds: the loads overlap, the adds stay in order.
  for (int64_t s = k; s < slices; s += helpers) {
    const int64_t j = 32 * s + lane;
    const bool col = j < d;
    float acc = col ? load_f(trow, j) : 0.0f;
    Meta mine = pay.meta(__ldg(order + s0 + lane));  // len >= 32
    for (int64_t b = s0; b < end; b += 32) {
      const int cnt = static_cast<int>(end - b < 32 ? end - b : 32);
      float v[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const Meta m{__shfl_sync(kFull, mine.row, t),
                     __shfl_sync(kFull, mine.coef, t)};
        v[t] = (t < cnt && col) ? pay.row(m).at(j) : 0.0f;
      }
      if (b + 32 + lane < end) mine = pay.meta(__ldg(order + b + 32 + lane));
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        if (t < cnt) acc = add<T, kRoundEach>(acc, v[t]);
      }
    }
    if (col) store_f(trow, j, acc);
  }
}

template <typename T, typename Payload, bool kRoundEach>
int launch(void* table, int64_t stride, int64_t d, const void* sorted_ids,
           const void* order, int64_t n, const Payload& pay, cudaStream_t s) {
  if (n < 0 || d <= 0 || stride < d) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  scatter_runs_kernel<T, Payload, kRoundEach>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<T*>(table), stride, d,
          static_cast<const int32_t*>(sorted_ids),
          static_cast<const int32_t*>(order), n, pay);
  return static_cast<int>(cudaGetLastError());
}

// The table's storage type for `dtype`, with the launch of `Payload` under
// policy kRoundEach.
template <typename Payload, bool kRoundEach>
int launch_dtype(void* table, int64_t stride, int64_t d, int32_t dtype,
                 const void* sorted_ids, const void* order, int64_t n,
                 const Payload& pay, cudaStream_t s) {
  switch (dtype) {
    case kDtypeF32:
      return launch<float, Payload, kRoundEach>(table, stride, d, sorted_ids,
                                                order, n, pay, s);
    case kDtypeBF16:
      return launch<uint16_t, Payload, kRoundEach>(table, stride, d,
                                                   sorted_ids, order, n, pay,
                                                   s);
    default:
      return cudaErrorInvalidValue;
  }
}

Rank1Payload rank1_payload(const void* coef, const void* h, const void* hidx,
                           int64_t h_stride) {
  return Rank1Payload{static_cast<const float*>(coef),
                      static_cast<const float*>(h),
                      static_cast<const int32_t*>(hidx), h_stride};
}

}  // namespace

extern "C" {

// Every entry launches on `stream` and returns cudaGetLastError() as an int
// (0 = launched). `table` is [V, stride] of `dtype` (0 = f32, 1 = bf16),
// updated in place; sorted_ids and order are [n] int32. None synchronises
// or allocates.

// fp32-sum policy. upd is [n, d] fp32, contiguous, in input order.
int glint_scatter_add_rows_f32(void* table, int64_t stride, int64_t d,
                               int32_t dtype, const void* sorted_ids,
                               const void* order, int64_t n, const void* upd,
                               void* stream) {
  const RowsPayload pay{static_cast<const float*>(upd), d};
  return launch_dtype<RowsPayload, false>(
      table, stride, d, dtype, sorted_ids, order, n, pay,
      static_cast<cudaStream_t>(stream));
}

// fp32-sum policy. coef [n] fp32 and hidx [n] int32 in input order; h is
// [B, h_stride] fp32 with rows of at least d values.
int glint_scatter_add_rank1(void* table, int64_t stride, int64_t d,
                            int32_t dtype, const void* sorted_ids,
                            const void* order, int64_t n, const void* coef,
                            const void* h, const void* hidx, int64_t h_stride,
                            void* stream) {
  if (h_stride < d) return cudaErrorInvalidValue;
  return launch_dtype<Rank1Payload, false>(
      table, stride, d, dtype, sorted_ids, order, n,
      rank1_payload(coef, h, hidx, h_stride),
      static_cast<cudaStream_t>(stream));
}

// Table-dtype policy. upd is [n, d] fp32, contiguous, in input order; each
// update row is rounded to the table's dtype before it is added.
int glint_scatter_add_rows(void* table, int64_t stride, int64_t d,
                           int32_t dtype, const void* sorted_ids,
                           const void* order, int64_t n, const void* upd,
                           void* stream) {
  const RowsPayload pay{static_cast<const float*>(upd), d};
  return launch_dtype<RowsPayload, true>(
      table, stride, d, dtype, sorted_ids, order, n, pay,
      static_cast<cudaStream_t>(stream));
}

// Table-dtype policy, rank-1 payload; arguments as glint_scatter_add_rank1.
int glint_scatter_add_rank1_table(void* table, int64_t stride, int64_t d,
                                  int32_t dtype, const void* sorted_ids,
                                  const void* order, int64_t n,
                                  const void* coef, const void* h,
                                  const void* hidx, int64_t h_stride,
                                  void* stream) {
  if (h_stride < d) return cudaErrorInvalidValue;
  return launch_dtype<Rank1Payload, true>(
      table, stride, d, dtype, sorted_ids, order, n,
      rank1_payload(coef, h, hidx, h_stride),
      static_cast<cudaStream_t>(stream));
}

const char* glint_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
