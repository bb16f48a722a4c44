"""Core neural-net ops of the port: ``nn.Module`` layers with the reference's
torch semantics and parameter names."""

from pai_tpu_torch.ops.layers import (
    BatchNorm,
    Conv,
    ConvTranspose,
    Dense,
    Dropout,
    Dropout2d,
    InstanceNorm,
    LayerNorm,
    LeakyReLU,
    SiLU,
    avg_pool_2x,
    gamma_embedding,
    gelu,
    leaky_relu,
    max_pool_2x,
    round_to_compute,
    sigmoid,
    silu,
    upsample_nearest_2x,
)
