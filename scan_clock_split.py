#!/usr/bin/env python3
"""Where a step of the sLSTM scan kernel (K5) goes, from clock64() counters
on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 scan_clock_split.py``

Builds a copy of ``src/repro_torch/kernels/csrc/slstm_scan.cuh`` (and the
serving entries of ``slstm_scan.cu``) with counters
inserted at the kernel's phase boundaries (the source is not changed), runs
it at the scan shapes of the xlstm-350m serving path with the launch plan the
wrapper would use, and prints one JSON line per case: the device time by
CUDA-graph replay and, averaged over the warps of every CTA (lane 0 of each),
the cycles of the set-up before the first step and per step of

  dot       the h . R products of the warp's slots and their butterfly
  sync      the barrier after the gate sums
  gates     the gate and state update (the warps that own cells)
  exchange  h_t to every CTA of the cluster and the cluster barrier,
            including the wait for the gate step of the slowest warp

Needs one CUDA device and nvcc; exits non-zero without them.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import slstm_scan as kscan  # noqa: E402

HEADER = os.path.join(_build.CSRC, "slstm_scan.cuh")  # the kernels
SOURCE = os.path.join(_build.CSRC, "slstm_scan.cu")  # the serving entries
# (B, S, dtype) at H = 4, dh = 512: a decode tick of the slot pool, the
# longest prompt served, a 256-token prefill
CASES = [(4, 1, torch.bfloat16), (1, 48, torch.bfloat16), (1, 256, torch.bfloat16),
         (4, 1, torch.float32), (1, 256, torch.float32)]
PHASES = ("setup", "dot", "sync", "gates", "exchange", "total")

# (marker in the kernel source, text put before it)
PROBES = [
    ("#define IGATE_CLIP 5.0f\n", "__device__ long long g_clk[8192 * 8];\n"),
    ("  const int tid = threadIdx.x, lane", "  const long long k_start = clock64();\n"),
    ("  for (int t = 0; t < S; ++t) {\n", "  long long k_dot = 0, k_sync = 0, k_gates = 0, k_x = 0, k0 = clock64(), k1;\n"),
    ("    float pc[SCAN_MAX_ITEMS][4];\n", "    long long ks = clock64();\n"),
    ("    __syncthreads();  // every partial gate sum of step t is in gpart\n",
     "    k1 = clock64(); k_dot += k1 - ks; ks = k1;\n"),
    ("#pragma unroll\n    for (int j = 0; j < SCAN_MAX_ITEMS; ++j) {\n      if (ib[j] >= 0) {",
     "    k1 = clock64(); k_sync += k1 - ks; ks = k1;\n"),
    ("    if (t + 1 < S) {  // h_t to every CTA", "    k1 = clock64(); k_gates += k1 - ks; ks = k1;\n"),
    ("  }\n\n#pragma unroll\n  for (int j = 0; j < SCAN_MAX_ITEMS; ++j) {\n    if (mine[j]) {",
     "    k1 = clock64(); k_x += k1 - ks;\n"),
    ("  if (clustered) cluster_barrier();  // no CTA leaves",
     "  if (lane == 0) {\n"
     "    const int cta = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x, at = cta * 16 + warp;\n"
     "    if (at < 8192) {\n"
     "      long long* o = g_clk + at * 8;\n"
     "      o[0] = k0 - k_start; o[1] = k_dot; o[2] = k_sync; o[3] = k_gates; o[4] = k_x; o[5] = clock64() - k_start; o[6] = 1;\n"
     "    }\n  }\n"),
]


def instrumented_source() -> str:
    src = open(HEADER).read().replace("#pragma once\n", "")
    src += open(SOURCE).read().replace('#include "slstm_scan.cuh"\n', "")
    for marker, text in PROBES:
        if src.count(marker) != 1:
            raise RuntimeError(f"marker not found once in {HEADER}: {marker!r}; update PROBES")
        src = src.replace(marker, text + marker)
    return src + (
        '\nextern "C" int scan_clocks(long long* out, int n) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, g_clk, n * sizeof(long long));\n}\n"
        '\nextern "C" int scan_clocks_clear() {\n'
        "  static long long zero[8192 * 8];\n"
        "  return (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(zero));\n}\n"
    )


def build() -> ctypes.CDLL:
    out_dir = os.path.join(_build.build_dir(), "scan_clocks")
    os.makedirs(out_dir, exist_ok=True)
    cu, lib = os.path.join(out_dir, "slstm_scan_clocks.cu"), os.path.join(out_dir, "libscanclocks.so")
    with open(cu, "w") as f:
        f.write(instrumented_source())
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", lib, cu], check=True)
    dll = ctypes.CDLL(lib)
    dll.slstm_scan.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    dll.slstm_scan.restype = ctypes.c_int
    dll.scan_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dll.scan_clocks.restype = ctypes.c_int
    dll.scan_clocks_clear.restype = ctypes.c_int
    return dll


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_clock_split: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    import chip_smoke  # the timing helpers

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"gpu_name_power_limit": smi}), flush=True)
    dll = build()
    H, dh = 4, 512
    for B, S, dtype in CASES:
        rng = np.random.default_rng(B * 1000 + S)
        pre = torch.from_numpy(rng.normal(size=(B, S, 4, H, dh)).astype(np.float32)).to(dev).to(dtype)
        rs = [(torch.from_numpy(rng.normal(size=(H, dh, dh)).astype(np.float32)).to(dev) * dh**-0.5).to(dtype)
              for _ in range(4)]
        st = [torch.zeros(B, H, dh, device=dev), torch.ones(B, H, dh, device=dev), torch.zeros(B, H, dh, device=dev)]
        plan = kscan.plan_scan(B, S, H, dh, pre.element_size(), kscan.card_max_cluster(dtype))
        h_all = torch.empty((B, S, H, dh), dtype=dtype, device=dev)
        outs = [torch.empty((B, H, dh), device=dev) for _ in range(3)]

        def launch():
            err = dll.slstm_scan(
                *(t.data_ptr() for t in (pre, *rs, *st, h_all, *outs)), B, S, H, dh, int(dtype == torch.bfloat16),
                plan.cluster, plan.cols, plan.rows, plan.row_slots, plan.resident, plan.threads, plan.smem,
                torch.cuda.current_stream().cuda_stream,
            )
            if err:
                raise RuntimeError(f"launch refused: cudaError {err} (plan {plan})")

        graph_ms = chip_smoke.graph_ms(launch)
        if dll.scan_clocks_clear():
            raise RuntimeError("clearing the counters failed")
        launch()
        torch.cuda.synchronize()
        ref = kscan.slstm_scan_plain(pre, *rs, *st)
        max_err = max(float((g.float() - r.float()).abs().max()) for g, r in zip((h_all, *outs), ref))
        buf = np.zeros(8192 * 8, dtype=np.int64)
        if dll.scan_clocks(buf.ctypes.data, buf.size):
            raise RuntimeError("reading the counters failed")
        rows = buf.reshape(-1, 8)
        rows = rows[rows[:, 6] == 1][:, :6].astype(np.float64)
        mean = rows.mean(axis=0)
        per_step = {k: mean[i] / S for i, k in enumerate(PHASES) if k in ("dot", "sync", "gates", "exchange")}
        print(json.dumps(dict(
            dtype=str(dtype).replace("torch.", ""), B=B, S=S, H=H, dh=dh, plan=plan._asdict(),
            graph_ms=graph_ms, max_abs_err_vs_plain=max_err, warps=int(len(rows)),
            setup_cycles=mean[0], cycles_per_step=per_step, total_cycles=mean[5],
            dot_cycles_per_step_max=float(rows[:, 1].max() / S),
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
