"""The port's own spans in a trace: where the host spent its time and where
it waited on the card, by the layer that held it.

The port opens a ``port.*`` span (``utils.profiling.span``) at each layer
boundary while a profiler records; spans nest in the order of the calls, on
the one host thread that drives the card. A host wait is a runtime call that
blocks on the card (``WAITS``) and starts inside a port span; the harness's
own synchronize, outside every port span, is not one. A program without the
spans shows none: every reader here then finds nothing to read.

``launches`` and ``device_us_by_span`` put each device operation down to the
innermost port span around its launch (the runtime or driver call of the
same correlation id). ``trace.Trace`` keeps no launch, so they read a Chrome
trace's events themselves; the readers of a run do not call them yet.
"""

from __future__ import annotations

PREFIX = "port."
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy", "cudaMemcpyAsync")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def port_spans(host: list) -> list:
    """(name, start us, duration us) of every port span among ``host``, by
    start; of two that start together, the longer (the outer) first."""
    return sorted((s for s in host if s[0].startswith(PREFIX)), key=lambda s: (s[1], -s[2]))


def innermost(spans: list, times: list) -> list:
    """For each time, the name of the innermost of ``spans`` (nested, sorted
    by start) that holds it, or None. One sweep, a stack of open spans."""
    out = [None] * len(times)
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(spans) and spans[j][1] <= t:
            while stack and stack[-1][1] + stack[-1][2] < spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] + stack[-1][2] < t:
            stack.pop()
        out[i] = stack[-1][0] if stack else None
    return out


def span_us(trace, name: str) -> float | None:
    """Host microseconds inside the spans named ``name``; None where none."""
    durations = [s[2] for s in trace.host if s[0] == name]
    return sum(durations) if durations else None


def host_wait_us(trace) -> float | None:
    """Host microseconds in blocking runtime calls that start inside a port
    span; None where the trace has no port span or no device operation."""
    spans = port_spans(trace.host)
    if not spans or not trace.device:
        return None
    waits = [h for h in trace.host if h[0] in WAITS]
    owners = innermost(spans, [h[1] for h in waits])
    return sum(h[2] for h, owner in zip(waits, owners) if owner is not None)


def launches(events: list) -> list:
    """(duration us, launch start us) of each device operation of a Chrome
    trace's events, its launch the runtime or driver call of the same
    correlation id; the start is None where the trace has no such call."""
    device, calls = [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        correlation = e.get("args", {}).get("correlation")
        if e.get("cat") in DEVICE_CATS:
            device.append((float(e.get("dur", 0.0)), correlation))
        elif e.get("cat") in LAUNCH_CATS and correlation is not None:
            calls[correlation] = float(e["ts"])
    return [(dur, calls.get(c)) for dur, c in device]


def device_us_by_span(spans: list, launched: list) -> dict:
    """Device microseconds by the innermost of ``spans`` (``port_spans``)
    around each operation's launch (``launches``); None holds what was
    launched outside every port span, or whose launch was not found."""
    found = [(dur, start) for dur, start in launched if start is not None]
    owners = innermost(spans, [start for _, start in found])
    totals = {}
    for (dur, _), owner in zip(found, owners):
        totals[owner] = totals.get(owner, 0.0) + dur
    lost = sum(dur for dur, start in launched if start is None)
    if lost:
        totals[None] = totals.get(None, 0.0) + lost
    return totals
