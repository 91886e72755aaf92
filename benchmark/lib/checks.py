"""What a run must not have loaded: the JAX stack or the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "diffbir_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN``, compared whole: ``diffbir_tpu_torch`` is not
    ``diffbir_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
