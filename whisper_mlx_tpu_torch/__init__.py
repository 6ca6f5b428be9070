"""whisper_mlx_tpu_torch — whisper greedy transcription in PyTorch on CUDA.

A port of ``whisper_mlx_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU. The JAX package stays the reference; this package imports
``torch`` and never ``jax``.

- ``audio``      WAV decode and the log-mel frontend
- ``ops``        hand-written Hopper kernels (``csrc/``) and their plain
                 PyTorch versions
- ``models``     Whisper encoder/decoder as functions over a state dict
- ``checkpoint`` conversion of the JAX package's parameter tree
- ``decoding``   tokenizer, logit filters, the greedy loop, ``decode``
- ``inference``  ``transcribe()`` and output writers
- ``runtime``    device setup and the serving configuration

On CUDA tensors the kernels are the only path; on CPU tensors each kernel's
plain version runs. Kernels build at first use into ``build/kernels/``.
"""

__version__ = "0.1.0"

from whisper_mlx_tpu_torch.inference.transcribe import transcribe  # noqa: F401,E402

__all__ = ["transcribe", "__version__"]
