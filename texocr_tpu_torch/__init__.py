"""PyTorch and CUDA port of texocr_tpu for NVIDIA Hopper GPUs (see README)."""
