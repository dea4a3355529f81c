"""PyTorch / CUDA port of mla_tpu for one NVIDIA H100 (see README.md, "PyTorch / CUDA port").

Imports torch and numpy only, never jax or anything of mla_tpu, which is
the reference it is tested against.
"""
