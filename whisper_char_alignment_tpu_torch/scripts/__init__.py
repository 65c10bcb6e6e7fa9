"""The port's benchmark programs besides ``bench.py``: run each with
``python -m whisper_char_alignment_tpu_torch.scripts.<name>``."""
