"""Profiling and timing: the counterpart of ``pde_superresolution_tpu.utils.profiling``.

  * ``trace(logdir)``: a context manager around ``torch.profiler`` that
    records host (CPU) activity, and the card's (CUDA, through CUPTI) where
    one is present, and writes a Chrome/Perfetto JSON trace into ``logdir``
    (``<host>_<pid>.<ns>.pt.trace.json``, the name TensorBoard's PyTorch
    profiler plugin reads; or open it in ui.perfetto.dev). CUPTI sees every
    kernel on the card, the port's own too, although those are launched
    through ctypes and no PyTorch operator wraps them.
  * ``Timer`` and ``benchmark_fn``: wall-clock timing; ``benchmark_fn``
    synchronizes the card after every call, as ``block_until_ready`` does
    in the JAX package, so its times are the device's work and not its
    dispatch.
  * ``span(name)``: a named span around one layer of the port, for a trace
    taken by ``trace`` or any other ``torch.profiler`` session. While a
    profiler records, it is ``torch.profiler.record_function(name)``: a
    host interval on the trace's clock, beside the kernels CUPTI records,
    so a kernel's launch falls inside the spans of the layers that launched
    it. Otherwise it returns one shared no-op context at once. Measured on
    a CPU (torch 2.13): a span costs 0.96 µs with no profiler running (the
    check ``torch.autograd._profiler_enabled()`` alone 0.17-0.42 µs), where
    an unconditional ``record_function`` costs 14.4 µs; 15.6 µs while a
    profiler records.

The spans, each a module constant, nest in the order of the calls:

  * ``port.integrate`` (``INTEGRATE``): ``integrate.integrate``, the whole
    call; its own time is the RK4 stage sums and the stack of saves.
  * ``port.integrate_fused`` (``INTEGRATE_FUSED``):
    ``integrate.integrate_fused``, the whole call; its own time is the save
    loop's time updates and the stack of saves.
  * ``port.fused_learned_rk4`` (``FUSED_LEARNED_RK4``):
    ``ops.fused_kernels.fused_learned_rk4``, the wrapper's checks, the
    forcing pack and the launch.
  * ``port.pack_forcing`` (``PACK_FORCING``): ``fused_kernels.pack_forcing``,
    the forcing pack, its upload of the grid's points included.
  * ``port.fused_rhs`` (``FUSED_RHS``): ``fused_kernels.fused_rhs``, the
    wrapper's checks and the launch (or the plain version).
  * ``port.fused_rk4`` (``FUSED_RK4``): ``fused_kernels.fused_rk4``, the
    same for the baseline scheme's kernel.
  * ``port.tower`` (``TOWER``): ``StencilModel.coefficients``' conv tower
    (convolutions, periodic pads, ReLUs, heads).
  * ``port.projection`` (``PROJECTION``): ``StencilModel.coefficients``'
    constraint layers (``PolynomialAccuracy``).
  * ``port.forcing`` (``FORCING``): the forcing field of one RHS on
    ``StencilModel.rhs_fn``'s kernel route.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
import warnings
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile

INTEGRATE = "port.integrate"
INTEGRATE_FUSED = "port.integrate_fused"
FUSED_LEARNED_RK4 = "port.fused_learned_rk4"
PACK_FORCING = "port.pack_forcing"
FUSED_RHS = "port.fused_rhs"
FUSED_RK4 = "port.fused_rk4"
TOWER = "port.tower"
PROJECTION = "port.projection"
FORCING = "port.forcing"
SPANS = (INTEGRATE, INTEGRATE_FUSED, FUSED_LEARNED_RK4, PACK_FORCING, FUSED_RHS, FUSED_RK4,
         TOWER, PROJECTION, FORCING)

_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span(TOWER): ...``: a ``record_function`` span while a profiler
    records, else a shared no-op context (no allocation, no call into the
    profiler)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: ``with profiling.trace("/tmp/trace"): fn()``.

    Yields the running ``torch.profiler.profile``; on exit the trace is
    written to a new JSON file in ``logdir`` (made if missing), even when the
    block raised.
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with warnings.catch_warnings():  # one cycle, so no events are cleared
        warnings.filterwarnings("ignore", message=".*clears events at the end of each cycle")
        prof = profile(activities=activities)
        prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
        prof.export_chrome_trace(os.path.join(logdir, name))


class Timer:
    """Plain wall-clock timer (context manager).

    NOTE: does NOT synchronize the device. PyTorch returns from a call on a
    CUDA tensor before the card has done the work, so to time device work
    the caller must ``torch.cuda.synchronize()`` inside the block
    (``benchmark_fn`` below does this for you).
    """

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False


def _synchronize(out) -> None:
    """Wait for every CUDA device that holds a tensor of ``out`` (tensors
    nested in dicts, lists and tuples)."""
    devices, stack = set(), [out]
    while stack:
        item = stack.pop()
        if isinstance(item, torch.Tensor):
            if item.is_cuda:
                devices.add(item.device)
        elif isinstance(item, dict):
            stack.extend(item.values())
        elif isinstance(item, (list, tuple)):
            stack.extend(item)
    for device in devices:
        torch.cuda.synchronize(device)


def benchmark_fn(
    fn: Callable,
    *args,
    repeats: int = 10,
    warmup: int = 1,
) -> dict:
    """Time ``fn(*args)`` correctly (device-synchronized, warm-up excluded).

    Returns {"mean_s", "best_s", "runs"}; after each call the devices of
    the CUDA tensors among its outputs are synchronized, so the timings
    measure device execution, not dispatch.
    """
    for _ in range(warmup):
        _synchronize(fn(*args))
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _synchronize(fn(*args))
        runs.append(time.perf_counter() - t0)
    return {
        "mean_s": sum(runs) / len(runs),
        "best_s": min(runs),
        "runs": runs,
    }
