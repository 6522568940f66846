"""The rate mma.sync reaches on this card: m16n8k8 TF32 and m16n8k16 bf16
products into fp32, each warp issuing independent products back to back
(no loads), over a grid that fills every SM.  The number bounds what a
kernel built on mma.sync (kernels #1, #2 and #4 of the port) can reach,
below the published dense peaks that only wgmma attains.  Needs one CUDA
card and nvcc:

    python3 tools/mma_rate.py

Prints one JSON line: the card's name and power limit, and for each type
the best TFLOP/s over a few chains-a-warp and warps-an-SM settings.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "abft_mma.cuh"

// ILP independent accumulators a warp; iters rounds of ILP products each
template <typename T, int ILP>
__global__ void rate(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int r = 0; r < 4; ++r) a[r] = 0x3f800000u ^ (threadIdx.x * 977u + r);
  for (int r = 0; r < 2; ++r) b[r] = 0x3f800000u ^ (threadIdx.x * 131u + r);
  float acc[ILP][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < ILP; ++j) abft_mma::Mma<T>::run(acc[j], a, b);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < ILP; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  if (s == 1.2345f) out[threadIdx.x] = s;   // keeps the products live
}

extern "C" int mma_rate(int kind, int ilp, int blocks, int threads,
                        int iters, float* out, float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  auto go = [&]() {
    if (kind == 0) {
      if (ilp == 4) rate<float, 4><<<blocks, threads>>>(out, iters);
      else rate<float, 8><<<blocks, threads>>>(out, iters);
    } else {
      if (ilp == 4) rate<__nv_bfloat16, 4><<<blocks, threads>>>(out, iters);
      else rate<__nv_bfloat16, 8><<<blocks, threads>>>(out, iters);
    }
  };
  go();                                       // warm up
  cudaEventRecord(e0);
  go();
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    import torch
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 2
    out_dir = build.build_dir().parent / "mma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "mma_rate.cu"
    src.write_text(SOURCE)
    lib_path = out_dir / "libmma_rate.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                    str(build.CSRC), "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.mma_rate
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.zeros(1024, device="cuda")
    iters = 4096
    res = {}
    for kind, name, flops in ((0, "tf32 m16n8k8", 2 * 16 * 8 * 8),
                              (1, "bf16 m16n8k16", 2 * 16 * 8 * 16)):
        best = 0.0
        for ilp in (4, 8):
            for warps_per_sm in (4, 8, 16, 32):
                blocks, threads = sms * warps_per_sm // 4, 128
                ms = ctypes.c_float()
                rc = fn(kind, ilp, blocks, threads, iters, buf.data_ptr(),
                        ctypes.addressof(ms))
                if rc != 0:
                    raise RuntimeError(f"mma_rate launch failed: {rc}")
                n = blocks * threads // 32 * iters * ilp
                best = max(best, n * flops / (ms.value * 1e-3) / 1e12)
        res[name] = round(best, 1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "tflops": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
