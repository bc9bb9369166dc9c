"""Trace one CLI run of the port on the card with ``torch.profiler``.

    python -m sharkmer_tpu_torch.tools.trace_spcr -- <CLI args>

Runs ``python -m sharkmer_tpu_torch <CLI args>`` in this process twice
untraced (kernels built, caches warm), then once under
``torch.profiler`` (CPU and CUDA activities), and prints:

* the traced wall and the untraced walls;
* the device's busy time (the union of its kernel, copy and set
  intervals) and its idle share, 1 - busy / traced wall;
* the closure attempts (``ops/reach._reach_call``, each one
  ``reach_closure`` launch) and the device work they enqueue: kernel
  launches, copies and sets issued inside them, per attempt; the device
  time of ``reach_closure_kernel`` and its launches;
* the ten largest device items by name (total ms and count).

It needs a CUDA device and raises without one; the last line is the
same summary as one JSON object.
"""

from __future__ import annotations

import bisect
import json
import sys
import time

WARM_RUNS = 2
TOP_ITEMS = 10
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cudaMemcpyAsync", "cudaMemsetAsync")


def _merged_ms(intervals) -> float:
    """Total length of the union of (start, end) intervals in µs, as ms."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def main(argv=None) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..main import main as cli_main
    from ..ops import reach

    cli = list(sys.argv[1:] if argv is None else argv)
    if cli[:1] == ["--"]:
        cli = cli[1:]
    if not torch.cuda.is_available():
        raise RuntimeError("trace_spcr: torch sees no CUDA device")

    walls = []
    for _ in range(WARM_RUNS):
        start = time.perf_counter()
        if cli_main(cli) != 0:
            raise RuntimeError("trace_spcr: the CLI failed")
        walls.append(time.perf_counter() - start)

    reach_call = reach._reach_call

    def traced_call(*a, **kw):
        with record_function("reach_call"):
            return reach_call(*a, **kw)

    reach._reach_call = traced_call
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            rc = cli_main(cli)
            torch.cuda.synchronize()
            traced = time.perf_counter() - start
    finally:
        reach._reach_call = reach_call
    if rc != 0:
        raise RuntimeError("trace_spcr: the traced CLI run failed")

    events = prof.events()
    device = [(e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CUDA]
    busy_ms = _merged_ms(device)
    calls = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "reach_call")
    runtime = sorted(e.time_range.start for e in events
                     if e.name in RUNTIME_CALLS)
    in_calls = sum(bisect.bisect_right(runtime, e) - bisect.bisect_left(
        runtime, s) for s, e in calls)

    def device_ms(avg):
        return getattr(avg, "self_device_time_total",
                       getattr(avg, "self_cuda_time_total", 0.0)) / 1e3

    averages = list(prof.key_averages())
    top = sorted((a for a in averages if device_ms(a) > 0),
                 key=device_ms, reverse=True)[:TOP_ITEMS]
    kernel = [a for a in averages
              if "reach_closure_kernel" in a.key and device_ms(a) > 0]
    summary = {
        "device": torch.cuda.get_device_name(0),
        "untraced_s": walls, "traced_s": traced, "device_busy_s": busy_ms / 1e3,
        "idle_share": 1 - busy_ms / 1e3 / traced,
        "device_intervals": len(device), "closure_attempts": len(calls),
        "device_work_in_closures": in_calls,
        "per_attempt": in_calls / max(len(calls), 1),
        "closure_s": sum(e - s for s, e in calls) / 1e6,
        "closure_kernel_ms": sum(device_ms(a) for a in kernel),
        "closure_kernel_launches": sum(a.count for a in kernel),
        "largest": [{"name": a.key, "ms": device_ms(a), "count": a.count}
                    for a in top],
    }
    print(f"traced wall {traced:.3f} s (untraced {walls}); device busy "
          f"{busy_ms / 1e3:.3f} s over {len(device)} intervals; idle share "
          f"{summary['idle_share']:.3f}")
    print(f"closure attempts {len(calls)} ({summary['closure_s']:.3f} s); "
          f"{in_calls} launches, copies and sets inside them, "
          f"{summary['per_attempt']:.1f} per attempt; reach_closure_kernel "
          f"{summary['closure_kernel_ms']:.3f} ms over "
          f"{summary['closure_kernel_launches']} launches")
    for item in summary["largest"]:
        print(f"  {item['ms']:10.3f} ms  {item['count']:7d}  {item['name']}")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
