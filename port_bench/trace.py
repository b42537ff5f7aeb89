"""Device traces: a sub-window of requests under ``torch.profiler``, read back.

The profiler (CPU and CUDA activity; CUPTI sees the port's ctypes launches)
writes one Chrome trace into a fresh directory under ``TMPDIR``; it is read
and deleted at once. Requests are marked by ``REQUEST_SPAN`` record_function
spans, so the traced window runs from the first request's start to the last
one's end, each ended by its synchronize.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")
REQUEST_SPAN = "port_bench.request"
TOP = 10


@dataclasses.dataclass
class Trace:
    device: list  # (short name, start us, duration us, category)
    host: list  # (name, start us, duration us)
    requests: list  # (start us, end us) of each REQUEST_SPAN

    @property
    def window_us(self) -> tuple:
        return self.requests[0][0], self.requests[-1][1]

    def kernels(self, prefix: str = "") -> list:
        return [e for e in self.device if e[3] == "kernel" and e[0].startswith(prefix)]


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace, template
    arguments and parameters: ``void ns::k<(E)1>(float*)`` -> ``k``."""
    name = name.replace("(anonymous namespace)::", "")
    while "<" in name:
        stripped = re.sub(r"<[^<>]*>", "", name)
        if stripped == name:
            break
        name = stripped
    name = name.split("(")[0].strip()
    return name.split(" ")[-1].split("::")[-1]


def parse(events: list) -> Trace:
    device, host, requests = [], [], []
    for e in events:
        cat, ph = e.get("cat"), e.get("ph")
        if ph != "X":
            continue
        start, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((short_name(e["name"]), start, dur, cat))
        elif cat in HOST_CATS:
            host.append((e["name"], start, dur))
            if cat == "user_annotation" and e["name"] == REQUEST_SPAN:
                requests.append((start, start + dur))
    device.sort(key=lambda e: e[1])
    requests.sort()
    return Trace(device, host, requests)


def capture(fn) -> Trace:
    """Run ``fn()`` under the profiler and read its trace back."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = tempfile.mkdtemp(prefix="port_bench_trace.")
    try:
        with profile(activities=activities) as prof:
            fn()
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return parse(json.load(f).get("traceEvents", []))
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


def intervals(trace: Trace) -> list:
    """The union of the device's busy intervals inside the window, sorted."""
    lo, hi = trace.window_us
    merged = []
    for _, start, dur, _ in trace.device:
        a, b = max(start, lo), min(start + dur, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_us(trace: Trace) -> float:
    return sum(b - a for a, b in intervals(trace))


def _host_at(trace: Trace, t: float) -> str:
    """The innermost host span running at ``t``: the latest to start."""
    best = None
    for name, start, dur in trace.host:
        if start <= t <= start + dur and (best is None or start >= best[1]):
            best = (name, start)
    return best[0] if best else "host idle"


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the window by what the host was doing in their middle."""
    totals = {}
    for name, _, dur, _ in trace.device:
        totals[name] = totals.get(name, 0.0) + dur * 1e-6
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    lo, hi = trace.window_us
    edges = [lo] + [x for ab in intervals(trace) for x in ab] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {
        "device_ops": [[name, seconds] for name, seconds in ops],
        "idle_gaps": [[_host_at(trace, (a + b) / 2), (b - a) * 1e-6] for a, b in gaps],
    }
