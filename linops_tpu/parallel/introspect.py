"""Compiled-program introspection: audit the collectives GSPMD and
shard_map insert into jitted SPMD programs.

The reference has no analogue (its parallelism is BLAS threads); on a
device mesh the collective schedule IS the scaling story, so the framework exposes it:
``collective_counts`` compiles a function and counts the arrays its
collectives move in the optimized HLO — the contract the scaling bench and the
multichip dryrun assert against (e.g. a halo-partitioned matvec must insert
exactly 2 ``collective-permute`` ops and ZERO ``all-gather``s per apply).
"""

from __future__ import annotations

import re

import jax

__all__ = ["collective_counts", "hlo_collective_counts", "COLLECTIVE_OPS"]

COLLECTIVE_OPS = (
    "collective-permute",
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
)


def _operand_count(hlo_text: str, open_paren: int) -> int:
    """Operands of the instruction whose argument list opens at
    ``open_paren`` (operands print as ``%name``)."""
    depth, i = 0, open_paren
    while i < len(hlo_text):
        depth += {"(": 1, ")": -1}.get(hlo_text[i], 0)
        if depth == 0:
            break
        i += 1
    return max(1, hlo_text.count("%", open_paren, i))


def hlo_collective_counts(hlo_text: str) -> dict:
    """Count the arrays the collectives of optimized-HLO text move. Async
    pairs (``-start``/``-done``) count once, and a combined (variadic)
    instruction counts once per operand: XLA:GPU merges collectives with
    the same peers into one instruction, XLA:CPU does not."""
    counts = {}
    for name in COLLECTIVE_OPS:
        # instruction forms: `name(`, `name-start(`, `name.N(` — count the
        # op applications, not the `-done` halves of async pairs
        pat = rf"\b{re.escape(name)}(?:-start)?(?:\.\d+)?\("
        counts[name] = sum(_operand_count(hlo_text, m.end() - 1)
                           for m in re.finditer(pat, hlo_text))
    return counts


def collective_counts(fn, *args, static_argnames=None, **kwargs) -> dict:
    """Compile ``fn(*args, **kwargs)`` (jit) and return the per-program
    collective counts of the optimized HLO (``hlo_collective_counts``).

    Note this counts *the program text*: a collective inside
    a compiled loop body counts once regardless of trip count, so the result
    is the per-iteration schedule for chain/loop programs.
    """
    jitted = (
        jax.jit(fn, static_argnames=static_argnames)
        if static_argnames
        else jax.jit(fn)
    )
    compiled = jitted.lower(*args, **kwargs).compile()
    return hlo_collective_counts(compiled.as_text())
