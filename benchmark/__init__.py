"""The benchmark of the PyTorch and CUDA port (``whisper_char_alignment_tpu_torch``).

Run one cell from the root of a checkout::

    python3 -m benchmark.run --workload medium.timit_b32 --seed 7 --seconds 30 --trace 0

``BENCHMARK.json`` at the root names the cells. Each configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``), cell's
comparison limits (``limits/<workload>.json``) and per-layer metric
(``metrics/<metric>.py``) is a file of its own that the harness finds by its
name. ``reference/`` holds the plain float32 reference, which imports nothing
of the port. Nothing here imports JAX or the JAX package.
"""
