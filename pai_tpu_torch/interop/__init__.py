"""Carrying weights into and out of the port: the JAX package's parameter
trees (``jax_params``, numpy trees, no JAX import) and the reference's
Lightning ``.ckpt`` files (``lightning``, also ``python -m
pai_tpu_torch.interop.lightning import|export``)."""

from pai_tpu_torch.interop.jax_params import (
    jax_from_state_dict,
    state_dict_from_jax,
)

_LIGHTNING = ("import_lightning_state_dict", "import_lightning_checkpoint",
              "export_lightning_state_dict", "export_lightning_checkpoint",
              "find_ema_state")


def __getattr__(name):
    # imported at first use, so that ``python -m
    # pai_tpu_torch.interop.lightning`` does not find the module loaded
    # before it runs
    if name in _LIGHTNING:
        from pai_tpu_torch.interop import lightning

        return getattr(lightning, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
