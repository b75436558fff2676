"""Attention math and the hand-written CUDA kernels (see flash_attention.py)."""
