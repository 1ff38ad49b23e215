"""PyTorch/CUDA port of the serving system.

A second package beside the JAX reference (``aws_k8s_ansible_provisioner_tpu``):
it imports ``torch`` and never ``jax``, and nothing from the JAX package. Its
entry points (``serving.engine.Engine``, ``models.layers.DecoderLM``,
``serving.paged_kv.init_pool``, the server CLI) run on CUDA unless the caller
passes ``device="cpu"``. The paged-attention and paged-KV-write kernels are
CUDA C++ for Hopper under ``csrc/``, built with nvcc on first use
(``ops/cuda_build.py``).
"""
