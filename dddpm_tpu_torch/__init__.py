"""PyTorch/CUDA port of dddpm_tpu for NVIDIA Hopper (H100).

Importing the package imports nothing heavy: the CUDA kernels under
csrc/ are compiled by ops/_build.py the first time a wrapper launches
one on a CUDA tensor.
"""
