"""targetDP in PyTorch: the port of the JAX package ``repro`` to one NVIDIA
H100, with the TPU kernels of its main path written by hand in CUDA
(``csrc/``).  Imports torch and numpy only; nothing of JAX or ``repro``."""
