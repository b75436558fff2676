"""Checkpoints: reference state dicts and JAX parameter trees."""

from texocr_tpu_torch.checkpoint.convert import (  # noqa: F401
    load_jax_params,
    load_state,
    state_dict_from_jax,
)
from texocr_tpu_torch.checkpoint.io import load_weights  # noqa: F401
