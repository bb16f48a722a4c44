"""Core neural-net ops of the port: ``nn.Module`` layers with the reference's
torch semantics and parameter names."""

from pai_tpu_torch.ops.layers import (
    BatchNorm,
    Conv,
    ConvTranspose,
    Dense,
    Dropout2d,
    avg_pool_2x,
    gamma_embedding,
    leaky_relu,
    silu,
    upsample_nearest_2x,
)
