#!/usr/bin/env python3
"""The rate of ``mma.sync.m16n8k8`` on TF32 operands on one CUDA card.

    python3 scripts/torch_mma_rate.py

Builds a one-kernel library with ``nvcc`` (into the gitignored
``glint_word2vec_torch/_build/``) and times ``mma.sync.m16n8k8`` TF32 in
independent chains a warp, with no memory traffic, at several warps an
SM: the most the tensor-core core of the port's shared-pool forward
kernel (``glint_word2vec_torch/csrc/pair_forward_shared.cu``) could
reach. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MMA_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int CHAINS>
__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1.0f + (threadIdx.x + i) * 1e-3f) & 0xffffe000u;
  const uint32_t b0 = __float_as_uint(0.5f), b1 = __float_as_uint(0.25f);
  float c[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) mma(c[j], a, b0, b1);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(void* out, int chains, int blocks, int threads, int iters,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chains == 4) mma_loop<4><<<blocks, threads, 0, s>>>((float*)out, iters);
  else if (chains == 8) mma_loop<8><<<blocks, threads, 0, s>>>((float*)out, iters);
  else mma_loop<16><<<blocks, threads, 0, s>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
"""


def mma_rate() -> None:
    import torch

    from glint_word2vec_torch.kernels import build

    out_dir = os.path.join(ROOT, "glint_word2vec_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    src, so = os.path.join(out_dir, "mma_rate.cu"), os.path.join(out_dir, "mma_rate.so")
    tmp = f"{src}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(MMA_SOURCE)
    os.replace(tmp, src)
    subprocess.run([build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    lib.run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for chains in (4, 8, 16):
        for threads, per_sm in ((128, 1), (128, 4), (512, 2)):
            blocks, iters = sms * per_sm, 2048
            out = torch.empty(blocks * threads, device="cuda")
            assert lib.run(out.data_ptr(), chains, blocks, threads, iters, stream) == 0
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            lib.run(out.data_ptr(), chains, blocks, threads, iters, stream)
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
            n = blocks * threads // 32 * iters * chains
            print(f"mma.sync m16n8k8 tf32, {chains} chains a warp, "
                  f"{threads // 32 * per_sm} warps an SM: {n} in {ms:.4f} ms, "
                  f"{n * 2048 / ms / 1e9:.1f} TFLOP/s", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mma_rate: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    mma_rate()
    return 0


if __name__ == "__main__":
    sys.exit(main())
