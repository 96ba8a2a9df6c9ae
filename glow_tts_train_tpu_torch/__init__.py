"""glow_tts_train_tpu_torch — the PyTorch/CUDA port of glow_tts_train_tpu.

Serving path (phoneme ids -> mel) on an NVIDIA H100: the four TPU kernels
of that path are hand-written CUDA for Hopper (``csrc/``), each with a
plain PyTorch version beside it that CPU tensors run.  Importing this
package or any submodule pulls in ``torch`` and numpy, never ``jax``; the
jax-free modules of the JAX package (``config``, ``utils.stdio``) are
imported, not copied.
"""

__version__ = "0.1.0"
