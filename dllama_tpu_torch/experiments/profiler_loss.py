"""How many device records torch.profiler keeps of a short block, by the age
of the process, with and without a lead-in of spin kernels. On the card.

Usage: python -m dllama_tpu_torch.experiments.profiler_loss [--ages 0,60,120] [--lead-s 0.2]

At each age (seconds after the first capture) it profiles one elementwise
kernel alone and five in a row, each after a few idle seconds: bare, and
after --lead-s of torch.cuda._sleep spin kernels inside the same session
(as chip_smoke.profiled does). A row prints the kernels wanted and seen:
``age 120 s: bare 0/1 0/5, lead-in 1/1 5/5``.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def seen(y: torch.Tensor, n: int, lead_s: float) -> int:
    """The number of the block's n y.mul_ kernels the profiler returned."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < lead_s:
            torch.cuda._sleep(20_000)
            torch.cuda.synchronize()
        for _ in range(n):
            y.mul_(1.0)
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA and "Mul" in e.name for e in prof.events())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ages", default="0,60,120", help="seconds after the first capture")
    ap.add_argument("--lead-s", type=float, default=0.2, help="spin lead-in, seconds")
    ap.add_argument("--idle-s", type=float, default=3.0, help="idle time before each capture")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_loss: no CUDA device")
        return 1
    y = torch.ones(1 << 22, device="cuda")
    y.mul_(1.0)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for age in (float(a) for a in args.ages.split(",")):
        while time.perf_counter() - t0 < age:
            time.sleep(0.5)
        row = {}
        for label, lead in (("bare", 0.0), ("lead-in", args.lead_s)):
            got = []
            for n in (1, 5):
                time.sleep(args.idle_s)
                got.append(f"{seen(y, n, lead)}/{n}")
            row[label] = " ".join(got)
        print(f"age {time.perf_counter() - t0:.0f} s: bare {row['bare']}, "
              f"lead-in {row['lead-in']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
