"""The port's benchmark programs besides ``bench.py``, its profiling
programs (``profile_*``) and its asset-day programs (``calibrate_kv_guard``,
``asset_gates``, ``rehearse_asset_day``, ``verify_kernels_on_device``,
``parity_vs_reference``, ``measure_cpu_baseline``): run each with
``python -m whisper_char_alignment_tpu_torch.scripts.<name>``."""
