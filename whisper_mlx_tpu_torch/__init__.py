"""whisper_mlx_tpu_torch — whisper greedy transcription in PyTorch on CUDA.

A port of ``whisper_mlx_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU. The JAX package stays the reference; this package imports
``torch`` and never ``jax``.

- ``audio``      audio decode (WAV, ffmpeg), the serving loaders and the
                 log-mel frontend
- ``native``     host C++ (WAV reader, DTW), built with g++ at first use
- ``ops``        hand-written Hopper kernels (``csrc/``) and their plain
                 PyTorch versions
- ``models``     Whisper encoder/decoder as functions over a state dict
- ``checkpoint`` conversion of the JAX package's parameter tree
- ``decoding``   tokenizer, logit filters, the greedy loop, ``decode``
- ``inference``  ``transcribe()`` (sequential and batched), word
                 timestamps, output writers, the WER harness
- ``runtime``    device setup, the serving configuration and the
                 cross-request ``TranscriptionBatcher``
- ``serving``    the HTTP daemon (``serving.server``), the chat service,
                 profiles, sessions, tools and sync
- ``agents``     the legacy tool-calling agent and its REPL

On CUDA tensors the kernels are the only path; on CPU tensors each kernel's
plain version runs. Kernels build at first use into ``build/kernels/``.
"""

__version__ = "0.1.0"

from whisper_mlx_tpu_torch.inference.transcribe import transcribe  # noqa: F401,E402

__all__ = ["transcribe", "__version__"]
