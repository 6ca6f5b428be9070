"""Time per call for the probes: device time on the card, host time on the CPU.

The reference's probes run each function inside one jitted scan with a data
dependency, because XLA would otherwise hoist or drop the call. PyTorch runs
eagerly, so the counterpart is the device's own time over calls run back to
back: the calls are queued behind a spin kernel, so that the host has
launched them all before the first one starts and its work stays off the
clock, and two CUDA events around them give the time. When the host cannot
queue faster than the device runs even behind a long spin, the device's own
events under ``torch.profiler`` are summed instead.
"""

from __future__ import annotations

import sys
import time

import torch


def profiled_us(fn, iters: int) -> float:
    """Microseconds of device time per call of ``fn`` from the device's own
    events (kernels and copies) under torch.profiler. CPU operators also
    carry the time of the kernels they launch, so they are left out. The
    profiler drops device events at a window's edges on the H100, more as a
    process goes on (every event of a 3-call window once), so the window
    opens on a long spin of the device and 256 short ones and closes on 64
    short ones, all left out by name, and a window that recorded no device
    time is taken again, at most twice."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=activities) as prof:
            torch.cuda._sleep(int(1e7))
            for _ in range(256):
                torch.cuda._sleep(100)
            for _ in range(iters):
                fn()
            for _ in range(64):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA and "spin" not in e.key)
        if total > 0:
            return total / iters
    raise RuntimeError("the profiler recorded no device time")


def time_us(fn, device: torch.device, iters: int, warmup: int = 3) -> float:
    """Microseconds per call of ``fn``: device time on ``cuda``, host time
    (best of 3 loops) on ``cpu``."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            best = min(best, time.perf_counter() - t0)
        return best / iters * 1e6
    cycles = 10**8
    for _ in range(3):
        torch.cuda.synchronize()
        queued, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        queued.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        spin_ms = queued.elapsed_time(start)
        if host_ms < spin_ms:
            return start.elapsed_time(end) / iters * 1e3
        cycles = int(cycles * 2 * host_ms / spin_ms)
    print(f"    (the host outran a {spin_ms:.1f} ms spin: {iters} calls took {host_ms:.1f} ms to "
          "queue; the time is the sum of the device's own events under the profiler)",
          file=sys.stderr)
    return profiled_us(fn, iters)
