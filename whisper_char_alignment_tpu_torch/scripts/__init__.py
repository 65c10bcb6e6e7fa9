"""The port's benchmark programs besides ``bench.py`` and its profiling
programs (``profile_*``): run each with
``python -m whisper_char_alignment_tpu_torch.scripts.<name>``."""
