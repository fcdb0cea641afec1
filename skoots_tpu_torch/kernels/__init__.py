"""The port's hand-written CUDA kernels (``csrc/``) behind their PyTorch
wrappers; on CPU tensors each wrapper runs its plain version. The JAX
package exports its Pallas bake as ``bake_skeleton_pallas``; the port's
counterpart is :func:`~skoots_tpu_torch.kernels.bake.bake_skeleton_kernel`."""

from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel

__all__ = ["bake_skeleton_kernel"]
