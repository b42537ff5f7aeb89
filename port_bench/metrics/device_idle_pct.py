"""Device: the share of the traced requests' window in which no kernel,
copy or fill ran on the card (the union of their intervals)."""

from port_bench import trace


def read(r):
    window = r.traced_window_s
    if window <= 0 or not r.trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_us(r.trace) * 1e-6 / window)
