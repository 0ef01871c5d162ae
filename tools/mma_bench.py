"""Latency and throughput of ``mma.sync`` on one card: m16n8k16 with bf16
operands and m16n8k8 with TF32 operands, both with f32 accumulation, the
two products the port's scans can build on.

    python3 tools/mma_bench.py

Builds a small CUDA program with ``nvcc`` into the git-ignored
``build/tools/`` and runs it: 132 CTAs of 1, 4 or 16 warps, each warp
issuing 1, 2, 4 or 8 independent accumulation chains of 4096 products.
Prints one ``[mma]`` line a configuration: cycles per product per warp
(``clock64`` in CTA 0; with one chain, the latency) and TFLOP/s over the
whole grid (CUDA events), then a JSON line of the best rate of each type.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "tools"

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

template <int CH, bool TF32>
__global__ void chains(float* out, int iters, long long* cyc) {
  float d[CH][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = threadIdx.x * 3u, b0 = threadIdx.x ^ 5u;
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (TF32) {
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                     : "r"(a0), "r"(a1), "r"(7u), "r"(9u), "r"(b0), "r"(11u));
      } else {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                     : "r"(a0), "r"(a1), "r"(7u), "r"(9u), "r"(b0), "r"(11u));
      }
    }
  }
  long long t1 = clock64();
  float s = 0.0f;
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cyc = t1 - t0;
}

template <int CH, bool TF32>
void run(int warps) {
  const int blocks = 132, iters = 4096;
  float* out;
  long long* cyc;
  cudaMalloc(&out, sizeof(float) * blocks * 32 * warps);
  cudaMalloc(&cyc, sizeof(long long));
  chains<CH, TF32><<<blocks, 32 * warps>>>(out, iters, cyc);
  cudaDeviceSynchronize();
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  chains<CH, TF32><<<blocks, 32 * warps>>>(out, iters, cyc);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  long long c;
  cudaMemcpy(&c, cyc, sizeof(c), cudaMemcpyDeviceToHost);
  const double flop = (TF32 ? 2048.0 : 4096.0) * iters * CH * warps * blocks;
  printf("[mma] %s chains=%d warps=%d: %.2f cycles a product a warp, "
         "%.1f TFLOP/s\n", TF32 ? "tf32 m16n8k8" : "bf16 m16n8k16", CH,
         warps, (double)c / ((double)iters * CH), flop / (ms * 1e-3) / 1e12);
  cudaFree(out);
  cudaFree(cyc);
}

template <bool TF32>
void sweep() {
  run<1, TF32>(1); run<2, TF32>(1); run<4, TF32>(1); run<8, TF32>(1);
  run<1, TF32>(4); run<2, TF32>(4); run<4, TF32>(4); run<8, TF32>(4);
  run<1, TF32>(16); run<2, TF32>(16); run<4, TF32>(16);
}

int main() {
  sweep<false>();
  sweep<true>();
  return 0;
}
"""


def main() -> int:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        print("mma_bench.py needs nvcc and a CUDA card", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    src, exe = OUT / "mma_bench.cu", OUT / "mma_bench"
    src.write_text(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(exe), str(src)], check=True)
    text = subprocess.run([str(exe)], check=True, capture_output=True,
                          text=True).stdout
    print(text, end="")
    best = {}
    for kind, rate in re.findall(r"\[mma\] (\w+) .*?([\d.]+) TFLOP/s", text):
        best[kind] = max(best.get(kind, 0.0), float(rate))
    print(json.dumps({"best_tflop_s": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
