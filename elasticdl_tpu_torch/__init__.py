"""elasticdl_tpu_torch — the PyTorch/CUDA port of elasticdl_tpu.

A package of its own beside the JAX package, which stays the reference.
It imports ``torch`` and never ``jax`` nor anything of ``elasticdl_tpu``;
where it needs one of the reference's jax-free modules it keeps its own
copy under the same relative path.  Every TPU kernel on a ported path is a
kernel written by hand for Hopper under ``csrc/``.
"""
