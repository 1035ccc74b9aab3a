"""The modules a run may not load: JAX, Flax and the JAX package, compared
by their whole top-level name (the port's own name begins with the JAX
package's)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "lammps_ucg_dev_tpu")


class ForbiddenLoaded(RuntimeError):
    """A process of the run had loaded a forbidden module after the
    window; ``found`` maps each such rank to the names."""

    def __init__(self, found: dict):
        self.found = found
        super().__init__("loaded after the window: " + "; ".join(
            f"rank {r}: {', '.join(n)}" for r, n in sorted(found.items())))


def forbidden_loaded() -> list[str]:
    """Top-level names in ``sys.modules``, compared whole, that the run may
    not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
