#!/usr/bin/env python3
"""Which device records ``torch.profiler`` loses from a session, as the
process ages, on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 profiler_loss_probe.py``

Each round opens five sessions (CPU + CUDA activities), each holding 512
spin kernels (``torch.cuda._sleep``), a synchronise, 200 small elementwise
kernels and one 4096^3 matmul, and counts the spins and the elementwise
kernels the profiler kept:

  A   short spins (1000 cycles)
  B   short spins after a 0.25 s host wait inside the session
  C   long spins (200000 cycles, about 0.1 ms each)
  D   short spins after a 1 s host wait before the session opens
  A2  A again

Between rounds the process launches small and large kernels for 12 s, as
a serve loop does.  One JSON line per round: the process's age, the kernels
launched so far, and for each arm the spins lost, the elementwise kernels
lost, the matmuls seen and the host ms the spins took to launch.  Needs
CUDA; exits 1 without it."""
import json
import sys
import time

import torch

SPINS, SMALL, ROUNDS, AGE_S = 512, 200, 10, 12.0
ARMS = {
    "A": dict(cycles=1000), "B": dict(cycles=1000, lead=0.25), "C": dict(cycles=200000),
    "D": dict(cycles=1000, pad=1.0), "A2": dict(cycles=1000),
}


def window(a, small, cycles, lead=0.0, pad=0.0):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    if pad:
        time.sleep(pad)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if lead:
            time.sleep(lead)
        t = time.perf_counter()
        for _ in range(SPINS):
            torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        for _ in range(SMALL):
            small.add_(1.0)
        a @ a
        torch.cuda.synchronize()
    spins = adds = mms = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            if "spin_kernel" in e.key:
                spins += e.count
            elif any(w in e.key.lower() for w in ("gemm", "sm90", "cutlass")):
                mms += e.count
            else:
                adds += e.count
    return dict(lost=SPINS - spins, small_lost=SMALL - adds, matmuls_seen=mms, spin_launch_ms=1e3 * t)


def age(a, small, seconds):
    t, n = time.time(), 0
    while time.time() - t < seconds:
        for _ in range(2000):
            small.mul_(1.0000001)
        for _ in range(4):
            a @ a
        torch.cuda.synchronize()
        n += 2004
    return n


def main():
    if not torch.cuda.is_available():
        print("profiler_loss_probe: no CUDA device", file=sys.stderr)
        return 1
    a = torch.randn(4096, 4096, device="cuda")
    small = torch.randn(1024, device="cuda")
    t0, launched = time.time(), 0
    for rnd in range(ROUNDS):
        row = dict(round=rnd, age_s=time.time() - t0, launched=launched)
        row.update({name: window(a, small, **arm) for name, arm in ARMS.items()})
        print(json.dumps(row), flush=True)
        launched += age(a, small, AGE_S)
    return 0


if __name__ == "__main__":
    sys.exit(main())
