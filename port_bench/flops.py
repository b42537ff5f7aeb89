"""Operations, bytes and least times, from a configuration's shapes alone.

The yardstick of the roofline and ``mfu`` metrics. Nothing here reads the
program's packed weights or launch geometry, so a change of the program's
layout cannot move it.

Per grid point and RHS evaluation the model does
  * bf16 tensor-core MACs: every tower layer's ``K * Cin * C`` and the
    heads' ``C * F`` (F the free dims of all orders);
  * float32 MACs: the projection, one order at a time (``S_d * F_d`` for
    order d's taps and free dims; the block-diagonal zeros between orders
    are no work), and the stencil ``S`` (the taps of all orders).
An RK4 step is four RHS evaluations.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAKS = {
    "bf16_tensor_flops": 989e12,
    "fp32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}
MFU_PEAK = PEAKS["bf16_tensor_flops"]


def nx(cfg: dict, domain_factor: int = 1) -> int:
    return domain_factor * cfg["fine_size"] // cfg["resample_factor"]


def stencil_size(cfg: dict) -> int:
    """Taps a derivative order: even on the staggered (conservative) grid."""
    size = cfg["model"]["stencil_size"]
    if cfg["conservative"]:
        return size + size % 2
    return size + (1 - size % 2)


def taps_total(cfg: dict) -> int:
    return stencil_size(cfg) * len(cfg["derivative_orders"])


def free_dims(cfg: dict) -> int:
    """Head outputs of all orders: each order's taps less its constraints."""
    acc = cfg["model"]["polynomial_accuracy_order"]
    return sum(stencil_size(cfg) - (d + acc) for d in cfg["derivative_orders"])


def tower_macs(cfg: dict) -> int:
    m = cfg["model"]
    c, k = m["filters"], m["kernel_size"]
    return k * c + (m["num_layers"] - 1) * k * c * c


def bf16_macs(cfg: dict) -> int:
    return tower_macs(cfg) + cfg["model"]["filters"] * free_dims(cfg)


def projection_macs(cfg: dict) -> int:
    """The sum over orders of ``S_d * F_d``: every order has the same taps."""
    return stencil_size(cfg) * free_dims(cfg)


def fp32_macs(cfg: dict) -> int:
    return projection_macs(cfg) + taps_total(cfg)


def weight_floats(cfg: dict) -> int:
    m = cfg["model"]
    c = m["filters"]
    f, s = free_dims(cfg), taps_total(cfg)
    return tower_macs(cfg) + m["num_layers"] * c + c * f + f + s + projection_macs(cfg)


def flops_per_traj_step(cfg: dict, domain_factor: int = 1) -> float:
    """Model FLOPs of one trajectory's RK4 step: 2 per MAC, 4 RHS a step."""
    return 2.0 * (bf16_macs(cfg) + fp32_macs(cfg)) * 4 * nx(cfg, domain_factor)


def learned_rk4_bound_ms(cfg: dict, batch: int, steps: int, domain_factor: int = 1) -> float:
    """Least time of ``steps`` fused RK4 steps of ``batch`` trajectories.
    The tower and heads at the bf16 tensor-core rate, the projection and
    stencil at the float32 rate; forcing with ``terms`` sinusoids adds, per
    point and step, three sums of ``terms`` multiply-adds and two rotations
    of 6 operations a term, float32. The bytes (state in and out, weights,
    the forcing's pack of 3 + 2 nx floats a term and trajectory) are far
    below."""
    n = nx(cfg, domain_factor)
    terms = cfg["forcing"]["terms"] if cfg.get("forcing") else 0
    points = n * batch * steps
    ops_s = points * (4 * 2.0 * (bf16_macs(cfg) / PEAKS["bf16_tensor_flops"]
                                 + fp32_macs(cfg) / PEAKS["fp32_flops"])
                      + (3 * 2 + 2 * 6) * terms / PEAKS["fp32_flops"])
    floats = 2 * batch * n + weight_floats(cfg) + batch * terms * (3 + 2 * n)
    return 1e3 * max(ops_s, 4 * floats / PEAKS["hbm_bytes_per_s"])


def rhs_bound_ms(cfg: dict, batch: int, domain_factor: int = 1) -> float:
    """Least time of one stencil-and-flux RHS from given coefficients: ``u``,
    the forcing field and every coefficient read once and ``u_t`` written
    once at the HBM rate (2 flops a tap and about 10 a point are far below
    the float32 rate)."""
    n = nx(cfg, domain_factor)
    forced = 1 if cfg.get("forcing") else 0
    s = taps_total(cfg)
    floats = batch * n * (2 + forced + s)
    flops = batch * n * (2 * s + 10)
    return 1e3 * max(4 * floats / PEAKS["hbm_bytes_per_s"], flops / PEAKS["fp32_flops"])
