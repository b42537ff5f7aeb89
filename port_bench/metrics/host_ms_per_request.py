"""Integrator layer (``integrate.integrate_fused`` / ``integrate.integrate``):
host milliseconds from a request's start until the port's call returns,
before its synchronize, averaged over the untraced window's requests. Where
it nears the request's latency, the host paces the card."""

import statistics


def read(r):
    return 1e3 * statistics.fmean(r.window.host_s) if r.window.host_s else None
