"""Shared jit cache for public map methods.

Eagerly-dispatched jnp ops are one dispatch (and one first-call compile)
EACH, so a public method that issues ~30 ops pays ~30 of them. Wrapping the
whole method in one `jax.jit` makes a public API call a single compiled
program dispatch — the same consolidation `maps/paged.py` applies to its
host-stateful pipeline, expressed as a decorator for the pure pytree
methods.

Methods stay pure pytree -> pytree functions, so the wrapper is semantically
transparent; calling a wrapped method inside an outer `jax.jit` simply
inlines the nested jit. The jit cache is keyed on the unbound function, so
all instances of a map class share one cache; recompiles happen per argument
shape/static-value combination exactly as with a hand-written jit.
"""
from __future__ import annotations

import functools
import inspect

import jax
import numpy as np


def compiled(*static_argnames, arrays=()):
    """Decorate a pytree method: run it as one jitted program.

    `static_argnames` are the Python-value parameters (meanings, thresholds,
    margins, offsets, flags) baked into the compiled program. Unhashable
    values passed for a static parameter (lists, numpy or jax arrays) are
    canonicalized to python scalars/tuples so callers may pass
    `offset=[1, 0, 0]` or `offset=jnp.array([1, 0, 0])` without tripping
    jit hashing.

    `arrays` names traced parameters coerced through `jnp.asarray` before
    the jit boundary: a Python list-of-lists point cloud would otherwise be
    treated as a pytree of thousands of scalar leaves (one tracer each, one
    compile per list shape).
    """

    def deco(fn):
        # inline=True: when a wrapped method is traced inside an OUTER jit
        # (users fusing whole cycles, lax loops), the jaxpr inlines with no
        # pjit boundary — nested pjit inside fori_loop bodies blew XLA
        # compile times from minutes to >20 min on the 512^3 cycle bench.
        # Called eagerly, it still compiles and caches as one program.
        jfn = jax.jit(fn, static_argnames=static_argnames, inline=True)
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            import jax.numpy as jnp

            b = sig.bind(*args, **kwargs)
            b.apply_defaults()
            for name in static_argnames:
                v = b.arguments.get(name)
                try:
                    hash(v)
                except TypeError:
                    a = np.asarray(v)
                    b.arguments[name] = (
                        a.item() if a.ndim == 0 else tuple(a.ravel().tolist())
                    )
            for name in arrays:
                v = b.arguments.get(name)
                if v is not None and not hasattr(v, "dtype"):
                    b.arguments[name] = jnp.asarray(v)
            out = jfn(*b.args, **b.kwargs)
            # jit outputs are rebuilt by pytree unflattening, which drops
            # non-pytree host state (e.g. the stored Sensor of the reference's
            # init-once/insert-repeatedly flow, TemplateVoxelMap.hpp:836-905);
            # let the receiver re-attach it to the maps it derives
            if b.args:
                carry = getattr(b.args[0], "_carry_host_state", None)
                if carry is not None:
                    out = carry(out)
            return out

        wrapper.__wrapped__ = fn
        return wrapper

    return deco
