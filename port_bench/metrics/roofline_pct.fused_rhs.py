"""``fused_rhs``'s share of its roofline: each launch's bytes bound (one RHS
of the whole batch from given coefficients, ``flops.rhs_bound_ms``) over
the device time of the kernels whose names start with ``PREFIX``."""

from port_bench import flops

PREFIX = "fused_rhs"


def read(r):
    launches = r.trace.kernels(PREFIX)
    if not launches:
        return None
    bound = flops.rhs_bound_ms(r.config, r.traffic["batch"], r.traffic["domain_factor"])
    return 100.0 * bound * len(launches) / (1e-3 * sum(e[2] for e in launches))
