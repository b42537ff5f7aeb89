"""The fused route: ``integrate.integrate_fused`` over
``StencilModel.fused_rk4_fn``, one ``fused_learned_rk4`` launch a save
interval (the forcing packed at each launch's start time), as
``scripts/run_ensemble`` builds it under ``--fused auto``."""

from pde_superresolution_torch import integrate

FLAG = "auto"  # run_ensemble's --fused on the card; the cell must take the kernel
FUSED = True


def build(model, params, dt, traffic, forcing, t0):
    """(request, pack): ``request(u0) -> (times, saves)`` for one batch of
    members with its forcing, from time ``t0``; ``pack`` is what
    ``choose_route`` reads."""
    advance = model.fused_rk4_fn(params, dt, traffic["save_every"], forcing=forcing, t0=t0)

    def request(u0):
        return integrate.integrate_fused(advance, u0, dt, traffic["steps"],
                                         traffic["save_every"], t0=t0)

    return request, advance.pack
