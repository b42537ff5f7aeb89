"""Numerical debugging aids: the counterpart of ``pde_superresolution_tpu.utils.debugging``.

The failure modes that matter here are numerical: NaN/Inf from CFL
violations, under-resolved shocks, or exploding unrolled gradients. Tools:

  * ``checked(fn, errors=float_checks)``: run ``fn`` with every operator
    checked, as JAX's ``checkify`` does with the same error set: with
    ``nan_checks`` a NaN in an operator's floating output raises
    ``FloatingPointError("nan generated by primitive: <op>.")`` at the
    first operator that made one, with ``div_checks`` a division by zero
    raises ``FloatingPointError("division by zero")`` before it runs, and
    ``float_checks`` is both;
  * ``debug_nans()``: the NaN check for everything run inside the context,
    backward included, as ``jax_debug_nans``: ``FloatingPointError("invalid
    value (nan) encountered in <op>")``;
  * ``assert_all_finite(tree, name)``: a host-side check over a tree of
    tensors or arrays (tests, loop guards), with JAX's ``keystr`` paths.

The checks run in a ``TorchDispatchMode``, which sees every ATen operator,
forward and backward. The port's kernels are launched through ctypes on raw
pointers, below any dispatch mode, so their wrappers hand each output to
``check_output`` (a no-op unless a check is in force), as checkify has a
rule for the ``pallas_call`` primitive. Operators that only move, view or
allocate data are not checked, as checkify checks no ``reshape``, ``slice``,
``concatenate`` or ``select_n``. The checks observe and change nothing: a
checked call returns what the unchecked call returns, bit for bit. Each
check reads its result on the host, so a checked call synchronizes the card
once per operator: use it while bisecting, not in production runs.
"""

from __future__ import annotations

import contextlib
import numbers
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

aten = torch.ops.aten

# operators whose outputs are not checked: copies, layouts, selections and
# fresh buffers (``empty`` may hold any bits); views are skipped as well
_UNCHECKED = frozenset({
    aten._to_copy, aten.alias, aten.cat, aten.clone, aten.constant_pad_nd, aten.copy,
    aten.copy_, aten.detach, aten.empty, aten.empty_like, aten.empty_strided,
    aten.fill_, aten.flip, aten.full, aten.full_like, aten.gather, aten.index,
    aten.index_put, aten.index_put_, aten.index_select, aten.lift_fresh,
    aten.lift_fresh_copy, aten.masked_fill, aten.masked_fill_, aten.new_empty,
    aten.new_empty_strided, aten.new_zeros, aten.ones_like, aten.repeat, aten.roll,
    aten.scatter, aten.scatter_, aten.select_scatter, aten.set_, aten.slice_scatter,
    aten.stack, aten.where, aten.zero_, aten.zeros, aten.zeros_like,
})
# divisions and the argument that is the divisor
_DIVISIONS = {
    aten.div: 1, aten.div_: 1, aten.floor_divide: 1, aten.floor_divide_: 1,
    aten.true_divide: 1, aten.true_divide_: 1, aten.reciprocal: 0, aten.reciprocal_: 0,
}


# checkify's error sets that this module implements: frozensets of names,
# combined with ``|`` as checkify's are
nan_checks = frozenset({"nan"})
div_checks = frozenset({"division"})
float_checks = nan_checks | div_checks


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for item in out:
            yield from _tensors(item)


class _FloatCheck(TorchDispatchMode):
    """Checks, with ``nans``, every operator's floating outputs for NaN
    and, with ``divisions``, every divisor for zero."""

    def __init__(self, divisions: bool, message: str, nans: bool = True):
        super().__init__()
        self.nans = nans
        self.divisions = divisions
        self.message = message  # formatted with the operator's name
        self.enabled = True

    def check(self, name: str, tensor: torch.Tensor) -> None:
        """Raise if ``tensor`` (the output of ``name``) holds a NaN."""
        if (self.enabled and self.nans and (tensor.is_floating_point() or tensor.is_complex())
                and tensor.device.type != "meta" and tensor.numel()
                and bool(torch.isnan(tensor).any())):
            raise FloatingPointError(self.message.format(name))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if self.enabled and self.divisions and packet in _DIVISIONS:
            divisor = args[_DIVISIONS[packet]] if len(args) > _DIVISIONS[packet] else None
            if isinstance(divisor, torch.Tensor):
                zero = divisor.numel() and bool((divisor == 0).any())
            else:
                zero = isinstance(divisor, numbers.Number) and divisor == 0
            if zero:
                raise FloatingPointError("division by zero")
        out = func(*args, **kwargs)
        if packet not in _UNCHECKED and not func.is_view:
            name = packet.__name__.rstrip("_")
            for tensor in _tensors(out):
                self.check(name, tensor)
        return out


def _active_checks() -> list:
    """The ``_FloatCheck`` modes in force on this thread, innermost last."""
    if not torch._C._len_torch_dispatch_stack():
        return []
    return [m for m in _get_current_dispatch_mode_stack() if isinstance(m, _FloatCheck)]


def check_output(name: str, tensor: torch.Tensor) -> None:
    """Hand a kernel's output to the checks in force (none: a no-op).

    The port's kernel wrappers call this after each launch: a dispatch mode
    cannot see a kernel launched through ctypes. Without a check in force it
    costs one test of the dispatch-mode stack's length.
    """
    if torch._C._len_torch_dispatch_stack():
        for mode in _active_checks():
            mode.check(name, tensor)


_NAN_MESSAGE = "invalid value (nan) encountered in {}"


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Check every operator run inside the context for NaN outputs,
    backward included (slow; use while bisecting), as ``jax_debug_nans``.

    ``debug_nans(False)`` turns an enclosing ``debug_nans()`` off for its
    block; on exit the previous state is restored, nesting included.
    """
    outer = [m for m in _active_checks() if m.message == _NAN_MESSAGE]
    if enable and not any(m.enabled for m in outer):
        with _FloatCheck(divisions=False, message=_NAN_MESSAGE):
            yield
        return
    previous = [m.enabled for m in outer]
    for mode in outer:
        mode.enabled = enable
    try:
        yield
    finally:
        for mode, state in zip(outer, previous):
            mode.enabled = state


def checked(fn: Callable, errors=float_checks) -> Callable:
    """Wrap ``fn`` with per-operator checks; raises ``FloatingPointError``
    at the first operator (or kernel) that fails one.

    ``errors`` is ``nan_checks`` (NaN outputs), ``div_checks`` (zero
    divisors) or ``float_checks`` (both), as checkify's sets of those
    names; any other set (checkify's ``index_checks``, ``user_checks``)
    raises ``ValueError``.

    Example::

        step = debugging.checked(train_step)
        state, parts = step(state, batch)   # raises if any op made a NaN
    """
    errors = frozenset(errors)
    if errors not in (nan_checks, div_checks, float_checks):
        raise ValueError(f"errors={sorted(map(str, errors))}: supported are nan_checks "
                         f"{sorted(nan_checks)}, div_checks {sorted(div_checks)} and "
                         f"float_checks {sorted(float_checks)}")
    nans, divisions = bool(errors & nan_checks), bool(errors & div_checks)

    def wrapper(*args, **kwargs):
        with _FloatCheck(divisions=divisions, nans=nans,
                         message="nan generated by primitive: {}."):
            return fn(*args, **kwargs)

    return wrapper


def _leaves(tree, path: str = ""):
    """(JAX ``keystr`` path, leaf) in JAX's flattening order: dict keys
    sorted, sequences by index, NamedTuple fields by name; None is empty."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for field in tree._fields:
            yield from _leaves(getattr(tree, field), f"{path}.{field}")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves(item, f"{path}[{i}]")
    else:
        yield path, tree


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def assert_all_finite(tree, name: str = "tree") -> None:
    """Host-side finiteness check over a tree (dicts, lists, tuples and
    NamedTuples of tensors or arrays); the message names the first
    non-finite leaf by JAX's ``keystr`` path."""
    for path, leaf in _leaves(tree):
        arr = _numpy(leaf)
        finite = np.isfinite(arr)
        if not finite.all():
            raise FloatingPointError(
                f"{name}{path}: {int((~finite).sum())}/{arr.size} non-finite values"
            )
