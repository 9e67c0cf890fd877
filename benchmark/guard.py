"""The import guard: top-level module names that no run may have loaded
(JAX, its libraries and the JAX package), compared whole, so that
``metdetpy_tpu_torch`` passes."""

import sys

BANNED = ("jax", "jaxlib", "flax", "metdetpy_tpu")


def loaded() -> list:
    tops = {name.split(".")[0] for name, mod in list(sys.modules.items())
            if mod is not None}
    return sorted(tops & set(BANNED))
