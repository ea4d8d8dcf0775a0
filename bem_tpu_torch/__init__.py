"""bem_tpu_torch — the Bayesian Enhancement Model's serving and training
paths in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``bem_tpu`` (JAX on TPU, kept as the reference): the module
paths mirror ``bem_tpu``'s, so each counterpart is found by name. The
package imports torch and never jax.
"""

__version__ = "0.1.0"
