"""PyTorch / CUDA port of ``unet_design_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module tree
(``ops/wavelet.py`` <-> ``ops/wavelet.py``, ...) and keeps its I/O layout at
public functions: NHWC ``(B, H, W, C)`` images and ``(B, T, H, W, C)``
trajectories.  It imports torch, numpy and the standard library only, never
JAX or the JAX package.  The one hand-written kernel, the Haar pyramid of
the multi-resolution loss, is CUDA C++ in ``csrc/`` built by ``nvcc`` at
first use (:mod:`unet_design_tpu_torch.ops.haar`).
"""
