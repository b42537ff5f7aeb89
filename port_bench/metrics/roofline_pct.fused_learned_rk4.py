"""``fused_learned_rk4``'s share of its roofline: the least time of each
launch (``save_every`` RK4 steps of the whole batch), from the
configuration's shapes and the published peaks (``flops.learned_rk4_bound_ms``),
over the device time of the kernels whose names start with ``PREFIX``."""

from port_bench import flops

PREFIX = "fused_learned_rk4"


def read(r):
    launches = r.trace.kernels(PREFIX)
    if not launches:
        return None
    bound = flops.learned_rk4_bound_ms(r.config, r.traffic["batch"], r.traffic["save_every"],
                                       r.traffic["domain_factor"])
    return 100.0 * bound * len(launches) / (1e-3 * sum(e[2] for e in launches))
