"""Plain references of the benchmark's configurations, one module a family.

A configuration file names its module (``"reference": "whisper"``). A
reference is plain PyTorch and NumPy in float32 (TF32 off), with no kernel,
cache or batching of the port's, and imports nothing of the port or of JAX.
"""
