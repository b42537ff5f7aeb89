"""Whole step: the model FLOPs of the trajectory-steps the untraced window
completed (``flops.flops_per_traj_step``, from the configuration's shapes),
over the window's seconds times the bf16 tensor-core peak. It reads the same
whatever implements the step."""

from port_bench import flops


def read(r):
    w = r.window
    if not w.completed:
        return None
    work = w.completed * r.traffic["batch"] * r.traffic["steps"]
    per_step = flops.flops_per_traj_step(r.config, r.traffic["domain_factor"])
    return 100.0 * per_step * work / (w.seconds * flops.MFU_PEAK)
