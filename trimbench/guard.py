"""The import guard: nothing the benchmark runs may load JAX or the JAX
package.  Modules are compared by their whole top-level name (the part
before the first dot), since the port's name, ``repro_torch``, begins
with the JAX package's, ``repro``."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in modules if top(name) in FORBIDDEN)
