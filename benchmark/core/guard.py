"""The import guard: the port runs without JAX and without the JAX package.

Module names are compared by their top-level part (before the first dot),
whole: `lfdtpu_torch` is the program, `lfdtpu` is not allowed.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "lfdtpu")


def forbidden(modules=None):
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
