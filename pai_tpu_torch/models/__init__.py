"""Model zoo of the port. All generators are ``nn.Module``s over NHWC tensors
(``module(x)``), as is the PatchGAN discriminator (``module(x, y)``), with the
reference's torch parameter names."""

from pai_tpu_torch.models.discriminator import Discriminator
from pai_tpu_torch.models.registry import GENERATOR_NAMES, build_generator
