"""PyTorch/CUDA port of eavit_tpu, the Explorative-Attention ViT RND/PPO
framework, for NVIDIA Hopper GPUs.

The JAX package ``eavit_tpu`` is the reference; this package imports
nothing of it (nor JAX). Its modules carry the same names as their JAX
counterparts. The TPU kernels on the acting and training paths (forward
and backward of the fused-qkv attention and of the fused FFN) are CUDA C++
under ``csrc/``, built on first use by ``ops/_build.py``; every kernel
wrapper runs its plain torch version for CPU tensors and the kernel for
CUDA tensors. Entry points (``python -m eavit_tpu_torch``, ``train.train``,
``eval.evaluate``, ``RNDAgent``) run on CUDA unless the caller passes
``device="cpu"``.
"""
