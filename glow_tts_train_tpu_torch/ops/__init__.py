"""Ops of the port, channels-last ``[batch, time, channels]`` like the JAX
package's ops.  ``*_cuda.py`` modules hold a hand-written CUDA kernel's
wrapper and its plain PyTorch version; the wrapper takes the plain version
only for CPU tensors."""
