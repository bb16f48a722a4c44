"""Carrying weights between the JAX package's parameter trees and the port's
``state_dict``s, on numpy arrays (no JAX import)."""

from pai_tpu_torch.interop.jax_params import (
    jax_from_state_dict,
    state_dict_from_jax,
)
