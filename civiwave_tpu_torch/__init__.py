"""civiwave_tpu_torch — the PyTorch/CUDA port of civiwave_tpu.

The JAX package ``civiwave_tpu`` stays the reference; this package mirrors
its layout (``config/``, ``mesh/``, ``ops/``, ``physics/``, ``solver/``,
``utils/``, ``runner.py``) so each counterpart sits at the same relative
path.  It imports torch and numpy, never jax.

Ported so far, both routes of ``runner.build_simulation``:

* the structured hex8 route — ``mesh.structured_config.try_build_structured``
  -> ``NewmarkStepper.step`` -> ``newmark_step`` -> ``solve_pcg`` ->
  ``ops.structured`` (kernels K1-K3);
* the general gather path — ``mesh.gmsh`` / ``utils.synthetic.box_mesh``
  -> ``mesh.preprocess.run`` -> ``mesh.pack.build_packed_model`` -> the
  same stepper and PCG -> ``ops.apply_keff`` (kernels K7 element_forces
  and G1 assemble_csr) and ``ops.block_jacobi``.

The kernels are CUDA C++ for Hopper (sm_90a) under ``csrc/``.  On CPU
tensors every kernel wrapper runs its plain PyTorch version; on CUDA
tensors it launches the kernel or raises.

Precision contract (same as the reference): FP32 solver vectors, FP64
reductions.  Torch has no global x64 switch to flip; every f64 value is
created with an explicit dtype.
"""

__version__ = "0.1.0"
