"""Configuration: dataclass hparams with reference-style string overrides.

The PyTorch counterpart of the JAX package's ``training/config.py``, field
for field: ``to_json`` gives the JAX package's dict, and ``from_json`` reads
its checkpoint configs (the committed ``assets/ckpt_*.json``). Overrides are
``--hparams=key=value,...`` comma lists.
"""

from __future__ import annotations

import dataclasses
import json
import typing

from pde_superresolution_torch.models.stencil_net import ModelConfig
from pde_superresolution_torch.training.losses import LossWeights


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    # problem
    equation: str = "burgers"
    # non-default physics parameters (eta, period, ...) forwarded to the
    # equation constructor; populated automatically when training from an
    # HDF5 file so custom physics round-trips (not settable via --hparams)
    equation_params: dict = dataclasses.field(default_factory=dict)
    conservative: bool = True
    resample_factor: int = 8
    fine_size: int = 1024
    # data generation
    num_trajectories: int = 32
    num_times: int = 128
    time_delta: float = 0.1
    warmup_time: float = 0.0
    ic_scale: float = 1.0
    data_seed: int = 0
    # model
    model: ModelConfig = ModelConfig()
    # loss
    loss_weights: LossWeights = LossWeights()
    num_time_steps: int = 4  # unrolled-loss steps (0 disables)
    # Unroll CURRICULUM: train phase p with unroll_curriculum[p] rollout
    # steps until global step curriculum_stops[p] (same convention as
    # learning_stops: the step at which the phase ENDS). Empty = train at
    # num_time_steps throughout. The last entry must equal num_time_steps
    # and the last stop must equal num_steps; loss norms are recomputed per
    # phase. Motivation: at hard coarsenings long unrolls diverge from a
    # fresh init (KdV 16x, RESULTS.md round-3) — growing the horizon as
    # the scheme stabilizes is the standard fix.
    unroll_curriculum: tuple = ()
    curriculum_stops: tuple = ()
    # Rollout-noise injection (train-time only): Gaussian noise of std
    # ``rollout_noise * rms(u)`` (per sample) added to the INITIAL state of
    # the unrolled-loss rollout, while targets stay the clean snapshots —
    # the scheme is trained to pull a perturbed trajectory back to the true
    # one (the standard drift-correction trick for learned solvers). Eval
    # losses are always computed clean. 0 = off (bit-identical to before).
    rollout_noise: float = 0.0
    # coarse RK4 substeps per snapshot interval in the unrolled loss;
    # 0 = auto from the equation's stable_time_step on the coarse grid
    coarse_time_subsample: int = 0
    # optimization (piecewise-constant LR ≈ learning_rates/learning_stops)
    learning_rates: tuple = (1e-3, 1e-4)
    learning_stops: tuple = (2000, 4000)  # steps at which each rate ENDS
    batch_size: int = 128
    frac_training: float = 0.8
    eval_interval: int = 250
    checkpoint_interval: int = 1000
    grad_clip_norm: float = 1.0
    seed: int = 0

    @property
    def num_steps(self) -> int:
        return self.learning_stops[-1]

    def curriculum_phases(self) -> tuple:
        """((unroll_steps, end_step), ...) — one phase if no curriculum.

        Validates the curriculum fields (called from the training loops
        rather than __post_init__ so partially-formed configs can still be
        constructed and serialized)."""
        if not self.unroll_curriculum:
            if self.curriculum_stops:
                raise ValueError(
                    f"curriculum_stops={self.curriculum_stops} set without "
                    "unroll_curriculum — a half-specified curriculum would "
                    "silently train at the full unroll from step 0"
                )
            return ((self.num_time_steps, self.num_steps),)
        ks = tuple(int(k) for k in self.unroll_curriculum)
        stops = tuple(int(s) for s in self.curriculum_stops)
        if len(ks) != len(stops):
            raise ValueError(
                f"unroll_curriculum {ks} and curriculum_stops {stops} must "
                "align"
            )
        if list(ks) != sorted(set(ks)):
            raise ValueError(f"unroll_curriculum must increase: {ks}")
        if list(stops) != sorted(set(stops)):
            raise ValueError(f"curriculum_stops must increase: {stops}")
        if ks[-1] != self.num_time_steps:
            raise ValueError(
                f"last curriculum unroll ({ks[-1]}) must equal "
                f"num_time_steps ({self.num_time_steps})"
            )
        if stops[-1] != self.num_steps:
            raise ValueError(
                f"last curriculum stop ({stops[-1]}) must equal num_steps "
                f"({self.num_steps})"
            )
        return tuple(zip(ks, stops))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=list)

    @classmethod
    def from_json(cls, s: str) -> "TrainingConfig":
        raw = json.loads(s)
        raw["equation_params"] = dict(raw.get("equation_params", {}))
        raw["model"] = ModelConfig(**raw["model"])
        raw["loss_weights"] = LossWeights(**raw["loss_weights"])
        for k in ("learning_rates", "learning_stops"):
            raw[k] = tuple(raw[k])
        for k in ("unroll_curriculum", "curriculum_stops"):
            raw[k] = tuple(raw.get(k, ()))
        return cls(**raw)


def _coerce_literal(value: str) -> typing.Any:
    """Best-effort scalar coercion for equation-parameter overrides
    (``eq.<field>=<value>``), whose target types live on the equation
    dataclasses rather than TrainingConfig: int, then float, then bool
    literals, else the raw string."""
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    return value


def _coerce(value: str, annotation) -> typing.Any:
    # `from __future__ import annotations` makes field types plain strings.
    ann = annotation if isinstance(annotation, str) else getattr(
        annotation, "__name__", str(annotation)
    )
    if ann == "bool":
        return value.lower() in ("1", "true", "yes")
    if ann == "int":
        return int(value)
    if ann == "float":
        return float(value)
    if ann.startswith("tuple"):
        return tuple(
            float(v) if "." in v or "e" in v.lower() else int(v)
            for v in value.split(";")
        )
    return value


def parse_hparams(overrides: str, base: TrainingConfig | None = None) -> TrainingConfig:
    """Apply reference-style comma overrides: ``key=value,key2=value2``.

    Nested model/loss fields are addressed directly by name (all leaf names
    are unique): e.g. ``filters=64,num_time_steps=8,conservative=false``.
    Tuple values use ``;`` separators: ``learning_rates=1e-3;1e-4``.
    Equation-constructor fields use an ``eq.`` prefix and merge into
    ``equation_params``: e.g. ``eq.eta=0.02`` (Burgers viscosity) or
    ``eq.period=62.8,eq.forcing_k_min=30,eq.forcing_k_max=60`` (domain
    scaling with matched physical forcing band — RESULTS.md "domain
    generalization").
    """
    config = base or TrainingConfig()
    if not overrides:
        return config
    top = {f.name: f for f in dataclasses.fields(TrainingConfig)}
    model_fields = {f.name: f for f in dataclasses.fields(ModelConfig)}
    loss_fields = {f.name: f for f in dataclasses.fields(LossWeights)}
    updates: dict = {}
    model_updates: dict = {}
    loss_updates: dict = {}
    eq_updates: dict = {}
    for item in overrides.split(","):
        if not item.strip():
            continue
        key, _, value = item.partition("=")
        key = key.strip()
        value = value.strip()
        if key in ("model", "loss_weights", "equation_params"):
            raise ValueError(f"set nested fields directly, not {key!r}")
        if key.startswith("eq."):
            eq_updates[key[len("eq."):]] = _coerce_literal(value)
        elif key in top:
            updates[key] = _coerce(value, top[key].type)
        elif key in model_fields:
            model_updates[key] = _coerce(value, model_fields[key].type)
        elif key in loss_fields:
            loss_updates[key] = _coerce(value, loss_fields[key].type)
        else:
            raise ValueError(f"unknown hparam {key!r}")
    if model_updates:
        updates["model"] = dataclasses.replace(config.model, **model_updates)
    if loss_updates:
        updates["loss_weights"] = dataclasses.replace(
            config.loss_weights, **loss_updates
        )
    if eq_updates:
        updates["equation_params"] = {**config.equation_params, **eq_updates}
    return dataclasses.replace(config, **updates)
