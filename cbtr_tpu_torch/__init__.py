"""cbtr_tpu_torch — the PyTorch/CUDA port of cbtr_tpu.

Same capabilities and module layout as the JAX package `cbtr_tpu`, which
stays in the repository as the reference the port is tested against: mesh
preprocessing (NumPy), C1 cubic Bezier-triangle surfaces (Clough-Tocher),
Newton-style ray/surface intersection and Snell refraction through a lens,
as differentiable PyTorch tensor code.  The O(rays x patches) winner search
runs in a hand-written CUDA kernel for Hopper (csrc/sweep_select.cu) when
the tensors lie on the GPU, and in its plain PyTorch twin when they lie on
the CPU.

This package imports torch and numpy and never jax.
"""

from . import config, geom  # noqa: F401

__version__ = "0.1.0"
