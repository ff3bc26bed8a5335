"""The import guard: the port is measured alone, so a run fails when the
JAX stack or the JAX package was loaded into its process.  Modules are
compared by their whole top-level name (the part before the first dot),
so ``repro_torch`` is not taken for ``repro``."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)
