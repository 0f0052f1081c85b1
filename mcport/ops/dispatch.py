"""The one platform decision: fused kernels on the GPU, the lax forms elsewhere.

Every engine asks :func:`use_kernels` which path generator to run, and every
kernel wrapper asks :func:`kernel_interpret` how to run its ``pallas_call``.
The platform is JAX's own (``JAX_PLATFORMS`` selects it); nothing here falls
back silently: a kernel asked for on a platform it cannot compile for raises
:class:`KernelPlatformError`.

Interpret mode (the Pallas interpreter on the CPU) exists for the test suite
only: a kernel wrapper's ``interpret=True`` argument, or the suite's
``interpret_kernels`` fixture, which flips :data:`_interpret` so that engines
can be driven through their kernel path on the CPU.
"""

from __future__ import annotations

import jax

__all__ = ["KERNEL_PLATFORM", "KernelPlatformError", "use_kernels",
           "kernel_interpret"]

# The platform the fused kernels are compiled for (Pallas, Triton route).
KERNEL_PLATFORM = "gpu"

# Set only by the test suite (tests/conftest.py ``interpret_kernels``).
_interpret = False


class KernelPlatformError(RuntimeError):
    """A fused kernel was requested where it cannot be compiled."""


def _platform() -> str:
    return jax.default_backend()


def use_kernels(requested: bool | None = None) -> bool:
    """Whether an engine runs the fused kernel (True) or its lax form (False).

    ``requested=None`` decides from the platform: the kernel on the GPU, lax
    on the CPU. ``False`` forces the lax form anywhere. ``True`` demands the
    kernel and raises :class:`KernelPlatformError` off the GPU.
    """
    on_gpu = _platform() == KERNEL_PLATFORM
    if requested is None:
        return on_gpu or _interpret
    if requested and not (on_gpu or _interpret):
        raise KernelPlatformError(
            f"fused kernels compile for the {KERNEL_PLATFORM!r} platform only; "
            f"this process runs on {_platform()!r} (use the lax form: "
            "use_pallas=False / --no-pallas)")
    return bool(requested)


def kernel_interpret(interpret: bool = False) -> bool:
    """The ``interpret`` flag a kernel wrapper passes to ``pallas_call``.

    Compiled on the GPU; interpreted where the test suite asks for it; an
    error anywhere else, and for an interpreted kernel on the GPU.
    """
    interpret = interpret or _interpret
    on_gpu = _platform() == KERNEL_PLATFORM
    if interpret and on_gpu:
        raise KernelPlatformError(
            "interpret mode is for CPU tests; on the GPU the kernel compiles")
    if not interpret and not on_gpu:
        raise KernelPlatformError(
            f"fused kernels compile for the {KERNEL_PLATFORM!r} platform only; "
            f"this process runs on {_platform()!r}")
    return interpret
