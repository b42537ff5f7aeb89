"""Ops wrappers: host milliseconds a traced request spends in
``fused_kernels.pack_forcing`` (its ``port.pack_forcing`` spans), the forcing
pack of each ``fused_learned_rk4`` launch, its upload of the grid included."""

from port_bench import spans

SPAN = "port.pack_forcing"


def read(r):
    us = spans.span_us(r.trace, SPAN)
    return None if us is None else 1e-3 * us / r.traced
