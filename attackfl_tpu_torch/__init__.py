"""attackfl_tpu_torch: the PyTorch/CUDA port of attackfl_tpu.

It runs the same federated poisoning simulation on one NVIDIA GPU: the
same config schema, the same round semantics, and the JAX package's one
Pallas training kernel rewritten by hand in CUDA (``csrc/fused_step.cu``).
It imports nothing from ``attackfl_tpu``; the tests hold it against that
package on identical inputs.
"""
