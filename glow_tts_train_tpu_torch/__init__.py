"""glow_tts_train_tpu_torch — the PyTorch/CUDA port of glow_tts_train_tpu.

Serving (phoneme ids -> mel, ``python -m glow_tts_train_tpu_torch.infer``)
and training (``python -m glow_tts_train_tpu_torch``, with ``encoder_fuse:
false`` and ``fp16_run: false``) on an NVIDIA H100: the TPU kernels of
those paths are hand-written CUDA for Hopper (``csrc/``), each with a
plain PyTorch version beside it that CPU tensors run.  Importing this
package or any submodule pulls in ``torch`` and numpy, never ``jax``; the
jax-free modules of the JAX package (``config``, ``utils.stdio``,
``data``) are imported, not copied.
"""

__version__ = "0.1.0"
