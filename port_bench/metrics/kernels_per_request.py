"""Ops wrappers (``ops/fused_kernels``, torch ops): device kernels a request
launches, counted in the trace."""


def read(r):
    kernels = r.trace.kernels()
    return len(kernels) / r.traced if kernels else None
