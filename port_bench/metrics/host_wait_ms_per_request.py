"""Integrator layer, at the host's boundary with the card: host milliseconds
a traced request spends in runtime calls that block on the card
(synchronizes, copies: ``spans.WAITS``) inside the port's spans, where the
host waits for the kernels before it instead of queueing the next."""

from port_bench import spans


def read(r):
    us = spans.host_wait_us(r.trace)
    return None if us is None else 1e-3 * us / r.traced
