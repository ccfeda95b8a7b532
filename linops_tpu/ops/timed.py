"""Timed decorator operator — the tracing/profiling hook.

Reference: src/TimedOperators.jl wraps prod/tprod/ctprod in TimerOutputs
sections. Here the eager apply boundary is timed host-side (with
``block_until_ready`` for honest device timings) and a ``jax.profiler``
trace annotation is emitted per apply; inside a larger traced graph the
decorator is transparent (it forwards ``apply``), since per-node timing is
meaningless after XLA fusion.
"""

from __future__ import annotations

import time

import jax

from ..core.base import LinearOperator, register_operator
from ..core.dense import aslinearoperator

__all__ = ["TimedOperator"]

_SLOT = {"N": "prod", "T": "tprod", "H": "ctprod", "C": "prod"}


class TimedOperator(LinearOperator):
    _fields_children = ("op",)
    _fields_aux = ()

    def __init__(self, op):
        super().__init__()
        self.op = aslinearoperator(op)

    @property
    def timings(self):
        # lazily (re)created so pytree unflatten — which bypasses __init__ —
        # still yields a working operator (same pattern as base counters)
        t = getattr(self, "_timings", None)
        if t is None:
            t = {"prod": [0, 0.0], "tprod": [0, 0.0], "ctprod": [0, 0.0]}
            object.__setattr__(self, "_timings", t)
        return t

    @property
    def nrow(self):
        return self.op.nrow

    @property
    def ncol(self):
        return self.op.ncol

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def symmetric(self):
        return self.op.symmetric

    @property
    def hermitian(self):
        return self.op.hermitian

    # traced path: transparent forwarding (all 15 trait functions forwarded in
    # the reference, src/TimedOperators.jl:39-59)
    def apply(self, v, mode: str = "N"):
        return self.op.apply(v, mode)

    def apply_matrix(self, M, mode: str = "N"):
        return self.op.apply_matrix(M, mode)

    def _has_tprod(self):
        return self.op._has_tprod()

    def _has_ctprod(self):
        return self.op._has_ctprod()

    def _bump_children(self, mode: str, n: int = 1):
        self.op.bump(mode, n)

    # counters delegate to the wrapped operator (reference contract:
    # nprod(top) == nprod(top.op), test/test_linop.jl:694-698) — so counts
    # survive wrapper commutation (op.T builds a fresh TimedOperator, but
    # the underlying operator's counters are shared).
    @property
    def nprod(self) -> int:
        return self.op.nprod

    @property
    def ntprod(self) -> int:
        return self.op.ntprod

    @property
    def nctprod(self) -> int:
        return self.op.nctprod

    def reset_counters(self):
        super().reset_counters()
        self.op.reset_counters()
        return self

    # eager path: timed
    def matvec(self, v, mode: str = "N"):
        from ..core.apply import matvec

        slot = _SLOT[mode]
        t0 = time.perf_counter()
        with jax.profiler.TraceAnnotation(f"linops.{slot}"):
            out = jax.block_until_ready(matvec(self, v, mode=mode))
        dt = time.perf_counter() - t0
        rec = self.timings.setdefault(slot, [0, 0.0])
        rec[0] += 1
        rec[1] += dt
        return out

    # decorator commutes with adjoint/transpose/conj (reference:
    # src/TimedOperators.jl:35-37)
    @property
    def T(self):
        return TimedOperator(self.op.T)

    @property
    def H(self):
        return TimedOperator(self.op.H)

    def conj(self):
        return TimedOperator(self.op.conj())

    def _name(self):
        return "Timed operator"

    def __repr__(self):
        lines = [f"TimedOperator wrapping:", repr(self.op), "timings:"]
        for slot, (n, t) in self.timings.items():
            lines.append(f"  {slot:8s} ncalls={n:6d}  total={t * 1e3:10.3f} ms")
        return "\n".join(lines)


register_operator(TimedOperator)
