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
