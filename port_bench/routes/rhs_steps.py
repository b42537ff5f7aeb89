"""The per-step route: ``integrate.integrate`` over ``StencilModel.rhs_fn``
(the cuDNN tower, the constraint projection, then one ``fused_rhs`` launch
a RHS), as ``scripts/run_ensemble --fused false`` and ``--output_path``
integrate."""

from pde_superresolution_torch import integrate

FLAG = "false"
FUSED = False


def build(model, params, dt, traffic, forcing, t0):
    rhs = model.rhs_fn(params, forcing)

    def request(u0):
        return integrate.integrate(rhs, u0, dt, traffic["steps"], traffic["save_every"],
                                   t0=t0)

    return request, None
