"""rwkvtts_torch: the PyTorch + CUDA (NVIDIA Hopper) port of rwkvtts_tpu.

The subpackages mirror ``rwkvtts_tpu``'s (``ops``, ``models``, ``codecs``,
``infer``, ``parallel``, ``train``, ``data``, ``eval``, ``utils``) so each module's counterpart
is found by name. Plain tensor code is
PyTorch; each kernel the JAX package wrote in Pallas for the TPU is a
hand-written CUDA kernel under ``csrc/``, built at first use
(``_build.py``). Every kernel wrapper takes its plain PyTorch version for
tensors on the CPU and launches the kernel for tensors on a CUDA device.

This package never imports JAX.
"""
