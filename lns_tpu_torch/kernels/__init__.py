"""Hand-written Hopper kernels for the rollout's hot spots.

Each module holds a kernel's wrapper and its plain PyTorch version; a
wrapper counts each launch, its scratch bytes and its host time in the
counter registry of ``utils.profiling``. A wrapper takes the plain version only for a CPU tensor;
for a CUDA tensor it launches the kernel or raises. The kernels have no
backward kernel: under grad, with an input that requires grad,
``fab_fused_core``, ``fused_group_norm_swish`` and ``fab_axial_in_fused``
in the d-space core's mode go through autograd Functions that launch the
kernel and carry the plain version's gradient; the other wrappers raise on
a CUDA tensor before launching.

  * ``prop_rollout``  CUDA C++ (``csrc/prop_rollout.cu``): all propagator steps
  * ``fab_core``      CUDA C++ (``csrc/fab_core.cu``): the FAB c-space core
  * ``group_norm``    CUDA C++ (``csrc/group_norm.cu``): GroupNorm + affine
                      (+ swish), a thread-block cluster per sample
  * ``axial``         CUDA C++ (``csrc/axial.cu``): head-major axial apply
                      (+ InstanceNorm), the FAB d-space core
  * ``axial_pipeline`` CUDA C++ (``csrc/axial_pipeline.cu``): batched
                      square-by-wide matmul and the h <-> w swap
"""
