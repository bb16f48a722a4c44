"""Palette diffusion of the port: noise schedules, the Gaussian reverse
distributions and the DDPM sampler (the sampling side; the training-side
functions arrive with the Palette training slice)."""

from pai_tpu_torch.diffusion.gaussian import (p_mean_variance,
                                              q_mean_variance)
from pai_tpu_torch.diffusion.sampler import ddpm_sample
from pai_tpu_torch.diffusion.schedule import (DiffusionSchedule,
                                              cosine_beta_schedule,
                                              linear_beta_schedule,
                                              make_schedule)
