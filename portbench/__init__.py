"""The benchmark of the PyTorch/CUDA port (``miniprot_tpu_torch``):
``run.py`` runs one cell of ``BENCHMARK.json`` once."""
