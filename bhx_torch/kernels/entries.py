"""The one seam of the kernel entries: their device dispatch, their
backward under autograd, and the counts of their launches and backward
passes.

A differentiable entry (the march, the composite, the ingredients, the
sky on record rows and on an interleaved record) is an :class:`Entry`:
its plain torch version, which CPU tensors run; its CUDA launcher, which
any other tensor runs (it checks its arguments, launches and counts the
launch, or raises); and its vector-Jacobian product, the backward of the
one ``torch.autograd.Function`` here, whose forward saves only the tensor
inputs.  Non-tensor flags go by keyword to all three.  :func:`replay` is
the backward of every entry but the march's: autograd through the plain
math.

The counts are by kind and kernel name: LAUNCH, a kernel launch (the mesh
kernel's too, which has no backward); REPLAY, a backward pass (a replay
of the plain version, or a call of the Euler march's adjoint); ADJOINT,
a call of the adjoint that launched its kernels, under the forward's
name.  Each kernel module declares its names as it is imported,
so every declared name reads 0 until it counts.  They are always on;
``profiling``'s counters, which the benchmark reads, count only while a
profiler records.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable

import torch
from torch.autograd.function import once_differentiable

LAUNCH, REPLAY, ADJOINT = "launch", "replay", "adjoint"

# kind -> kernel name -> count since the last reset.
_counts: Dict[str, Dict[str, int]] = {LAUNCH: {}, REPLAY: {}, ADJOINT: {}}


def declare(names: Iterable[str], *kinds: str) -> None:
    """Count each of ``kinds`` of each kernel of ``names``, from 0."""
    for kind in kinds:
        for name in names:
            _counts[kind].setdefault(name, 0)


def count(kind: str, name: str) -> None:
    """One more ``kind`` of the declared kernel ``name``."""
    _counts[kind][name] += 1


def launch_counts() -> Dict[str, int]:
    """Kernel launches by kernel name since the last reset."""
    return dict(_counts[LAUNCH])


def replay_counts() -> Dict[str, int]:
    """Backward passes by kernel name since the last reset."""
    return dict(_counts[REPLAY])


def adjoint_counts() -> Dict[str, int]:
    """Calls of the Euler march's adjoint kernel since the last reset, under
    the forward's name."""
    return dict(_counts[ADJOINT])


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches) to the launch counts: the
    launches of a CUDA graph's replay, which no launcher counts.  A name
    that is no kernel's is ignored."""
    launches = _counts[LAUNCH]
    for name in launches.keys() & counts.keys():
        launches[name] += counts[name]


def reset_launch_counts() -> None:
    """Zero the launch, replay and adjoint counts."""
    for counts in _counts.values():
        for name in counts:
            counts[name] = 0


@dataclasses.dataclass(frozen=True)
class Entry:
    """A differentiable kernel entry: ``plain(*tensors, **flags)`` for CPU
    tensors, ``launch(*tensors, **flags)`` for the others, and
    ``backward(*tensors, grad_out, **flags)``, which gives the cotangents
    of the tensors (of one tensor: that cotangent alone, or a tuple)."""

    plain: Callable
    launch: Callable
    backward: Callable

    def __call__(self, *tensors, **flags) -> torch.Tensor:
        """The plain version for CPU tensors, the launcher for the others;
        differentiable in every tensor: the backward is ``backward``, on the
        tensors' own device."""
        return _Function.apply(self, flags, *tensors)


class _Function(torch.autograd.Function):
    """An entry's call under autograd: the forward dispatches by device and
    saves only its tensor inputs, the backward calls the entry's
    ``backward`` on them."""

    @staticmethod
    def forward(ctx, entry: Entry, flags: dict, *tensors):
        ctx.entry, ctx.flags = entry, flags
        ctx.save_for_backward(*tensors)
        version = entry.plain if tensors[0].device.type == "cpu" else entry.launch
        return version(*tensors, **flags)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        grads = ctx.entry.backward(*ctx.saved_tensors, grad_out, **ctx.flags)
        return (None, None, *((grads,) if torch.is_tensor(grads) else grads))


def replay(name: str, plain: Callable, inputs, grad_out: torch.Tensor, **flags) -> tuple:
    """The cotangents of ``inputs`` for the cotangent ``grad_out`` of
    ``plain(*inputs, **flags)``, by autograd through that plain math (the
    reference's recompute-adjoint backward rules, shade_pallas.py:300-305,
    551-563, 677-680, 765-768), zeros for an input it does not reach;
    counted as a backward pass of ``name``."""
    count(REPLAY, name)
    inputs = [t.detach().requires_grad_() for t in inputs]
    with torch.enable_grad():
        grads = torch.autograd.grad(plain(*inputs, **flags), inputs, grad_out,
                                    allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for t, g in zip(inputs, grads))
