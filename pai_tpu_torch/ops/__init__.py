"""Core neural-net ops of the port: ``nn.Module`` layers with the reference's
torch semantics and parameter names."""

from pai_tpu_torch.ops.layers import (
    BatchNorm,
    Conv,
    ConvTranspose,
    Dropout2d,
    leaky_relu,
)
