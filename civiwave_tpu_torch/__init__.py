"""civiwave_tpu_torch — the PyTorch/CUDA port of civiwave_tpu.

The JAX package ``civiwave_tpu`` stays the reference; this package mirrors
its layout (``config/``, ``mesh/``, ``ops/``, ``physics/``, ``solver/``,
``utils/``, ``runner.py``) so each counterpart sits at the same relative
path.  It imports torch and numpy, never jax.

Ported so far: the structured hex8 route — ``runner.build_simulation`` ->
``mesh.structured_config.try_build_structured`` -> ``NewmarkStepper.step``
-> ``newmark_step`` -> ``solve_pcg`` -> ``ops.structured`` — with the three
Pallas kernels of that route rewritten as CUDA C++ for Hopper (sm_90a)
under ``csrc/``.  On CPU tensors every kernel wrapper runs its plain
PyTorch version; on CUDA tensors it launches the kernel or raises.

Precision contract (same as the reference): FP32 solver vectors, FP64
reductions.  Torch has no global x64 switch to flip; every f64 value is
created with an explicit dtype.
"""

__version__ = "0.1.0"
