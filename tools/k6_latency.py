#!/usr/bin/env python3
"""Latencies of the operations on K6's serial chains, and K6's SASS, on the card.

A probe kernel (PROBE, built with nvcc for sm_90a into build/k6_latency/)
runs 1000 dependent steps of each operation on one warp and prints the
cycles a step (clock64): a shuffle (+ an add), __fdiv_rn, __fsqrt_rn (+ an
add), a product and a difference, a shared load chased by its value, a
column step of K6's panel (shuffle, square root, quotient, product,
difference), __frcp_rn (+ an add), and a quotient from a known reciprocal
by Markstein's correction. --sass also prints, from `cuobjdump -sass` of
the package's K6 library, each kernel instance's instruction count and its
loops (a backward branch: its length and most frequent opcodes). Needs one
card and the CUDA toolkit; seconds.

    python3 tools/k6_latency.py [--sass]
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
STEPS = 1000

PROBE = r"""
#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>
__global__ void probe(float* out, long long* cyc, float seed, int steps) {
  __shared__ float sm[1024];
  const int l = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) sm[i] = 1.0f + i * 1e-7f;
  __syncwarp();
  float x = seed + l * 1e-6f;
  int idx = l;
  long long t0;
#define STEP(slot, body) t0 = clock64(); for (int i = 0; i < steps; ++i) { body; } \
  if (l == 0) cyc[slot] = clock64() - t0;
  STEP(0, x = __shfl_sync(0xffffffffu, x, (i + 1) & 31) + 1e-7f)
  STEP(1, x = __fdiv_rn(x, 1.0000001f))
  STEP(2, x = __fsqrt_rn(x) + 0.5f)
  STEP(3, x = __fsub_rn(x, __fmul_rn(x, 1e-7f)))
  STEP(4, const float v = sm[idx]; idx = (idx + (int)v) & 1023)
  STEP(5, const float p = __shfl_sync(0xffffffffu, x, i & 31);
       const float q = __fdiv_rn(x, __fsqrt_rn(p + 1.f));
       x = __fsub_rn(x, __fmul_rn(q, 1e-3f)) + 0.1f)
  STEP(6, x = __frcp_rn(x) + 1.f)
  const float b = 1.0000001f, rb = __frcp_rn(b);
  STEP(7, const float q0 = __fmul_rn(x, rb); x = __fmaf_rn(__fmaf_rn(-q0, b, x), rb, q0))
  out[threadIdx.x] = x + (float)idx;
}
int main(int argc, char** argv) {
  const int steps = atoi(argv[1]);
  float* out; long long* cyc;
  cudaMalloc(&out, 4096); cudaMalloc(&cyc, 8 * sizeof(long long));
  for (int rep = 0; rep < 2; ++rep) { probe<<<1, 32>>>(out, cyc, 1.5f, steps); cudaDeviceSynchronize(); }
  long long h[8];
  cudaMemcpy(h, cyc, sizeof(h), cudaMemcpyDeviceToHost);
  for (int i = 0; i < 8; ++i) printf("%lld\n", h[i]);
  return cudaGetLastError() != cudaSuccess;
}
"""
NAMES = ("shuffle + add", "__fdiv_rn", "__fsqrt_rn + add", "product and difference",
         "shared load chase", "column step", "__frcp_rn + add", "Markstein quotient")


def sass_report(cuobjdump: pathlib.Path, lib: pathlib.Path) -> None:
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split()[0]
        ins = [(int(a, 16), op) for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", fn)]
        print(f"{name}: {len(ins)} instructions")
        for addr, op in ins:
            tgt = re.search(r"BRA.*0x([0-9a-f]+)", op)
            if tgt and int(tgt.group(1), 16) < addr:
                body = [o for a, o in ins if int(tgt.group(1), 16) <= a <= addr]
                ops = collections.Counter(
                    re.sub(r"^@!?U?P[T0-9]+\s+", "", o).split()[0].split(".")[0] for o in body)
                print(f"  loop {int(tgt.group(1), 16):#x}..{addr:#x}: {len(body)} instructions, "
                      + ", ".join(f"{k} {v}" for k, v in ops.most_common(6)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", action="store_true", help="also print K6's SASS counts")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from lbmpc_tpu_torch.ops import _cuda, chol_kernel

    d = ROOT / "build" / "k6_latency"
    d.mkdir(parents=True, exist_ok=True)
    (d / "probe.cu").write_text(PROBE)
    nvcc = _cuda.nvcc_path()
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
                    str(d / "probe"), str(d / "probe.cu")], check=True)
    out = subprocess.run([str(d / "probe"), str(STEPS)], check=True, capture_output=True,
                         text=True).stdout.split()
    for name, cycles in zip(NAMES, out):
        print(f"{name:24s} {int(cycles) / STEPS:7.1f} cycles a step")
    if args.sass:
        k = chol_kernel.FACTOR_SOLVE_BLOCKED
        _cuda.build_all([k])
        sass_report(pathlib.Path(nvcc).parent / "cuobjdump", k.library_path())
    return 0


if __name__ == "__main__":
    sys.exit(main())
