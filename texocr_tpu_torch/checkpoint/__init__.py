"""Checkpoints: reference state dicts and JAX parameter trees."""

from texocr_tpu_torch.checkpoint.convert import load_state, state_dict_from_jax  # noqa: F401
