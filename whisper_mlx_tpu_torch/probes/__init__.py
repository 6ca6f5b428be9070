"""Probe entry points: microbenchmarks of the 4-bit whisper decode step's
matmuls and of its attention, run as
``python -m whisper_mlx_tpu_torch.probes.<name>`` on the card."""
