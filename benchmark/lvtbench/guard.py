"""The import guard: a run of the port's benchmark may not load JAX or the
JAX package. Module names are compared by their top-level name (the part
before the first dot) as a whole, so ``lvt_tpu_torch`` passes and
``lvt_tpu`` does not."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "lvt_tpu")


def forbidden_loaded(modules=None):
    """The sorted top-level names of the loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
