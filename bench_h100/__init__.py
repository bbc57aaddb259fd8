"""The benchmark of ``midi_model_tpu_torch`` on NVIDIA GPUs (see README.md)."""
