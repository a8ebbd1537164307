"""What the measured process may not hold: JAX, Flax or the JAX package, compared
by whole top-level module names (the port's name begins with the JAX package's)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "condmdi_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(names=None) -> list[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted({top_level(n) for n in names} & set(FORBIDDEN))
