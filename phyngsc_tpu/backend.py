"""Backend policy: which decode walk runs where, and the compile cache.

Every backend-dependent choice in the package goes through this module:

- ``"gpu"`` runs the compiled Pallas walk kernel (ops/walk.py);
- ``"cpu"`` runs the XLA walk, or the kernel in Pallas interpret mode when
  ``PHYNGSC_WALK=kernel`` forces it (the CPU tests do this);
- any other backend is an error.

A GPU never runs interpret mode: ``PHYNGSC_WALK=xla`` there selects the XLA
walk, and nothing else does.
"""

from __future__ import annotations

import os

#: walk implementations (see walk_impl)
KERNEL = "kernel"
INTERPRET = "interpret"
XLA = "xla"

_WALK_ENV = ("auto", KERNEL, XLA)


def walk_impl(backend: str | None = None) -> str:
    """The decode walk for `backend` (default: JAX's default backend) under
    ``PHYNGSC_WALK`` = auto | kernel | xla."""
    if backend is None:
        import jax

        backend = jax.default_backend()
    mode = os.environ.get("PHYNGSC_WALK", "auto")
    if mode not in _WALK_ENV:
        raise ValueError(f"PHYNGSC_WALK={mode!r}: expected one of {_WALK_ENV}")
    if backend == "gpu":
        return XLA if mode == XLA else KERNEL
    if backend == "cpu":
        return INTERPRET if mode == KERNEL else XLA
    raise RuntimeError(
        f"unsupported JAX backend {backend!r}: phyngsc_tpu runs on an NVIDIA "
        "GPU, or on the CPU for tests")


def device_summary() -> str:
    """'<platform> <device_kind> x<count>' of JAX's default devices."""
    import jax

    devs = jax.devices()
    return f"{devs[0].platform} {devs[0].device_kind} x{len(devs)}"


def checkout_dir() -> str:
    """Root of the source checkout this package was imported from."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at $JAX_COMPILATION_CACHE_DIR
    if set, else at <checkout>/.jax_cache; returns the directory. Call before
    the first compilation."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        checkout_dir(), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
