"""Palette diffusion of the port: noise schedules, the Gaussian forward and
reverse distributions with the training objective's VLB term, and the DDPM
sampler."""

from pai_tpu_torch.diffusion.gaussian import (p_mean_variance,
                                              q_mean_variance, q_sample,
                                              vlb_term)
from pai_tpu_torch.diffusion.sampler import ddpm_sample
from pai_tpu_torch.diffusion.schedule import (DiffusionSchedule,
                                              cosine_beta_schedule,
                                              linear_beta_schedule,
                                              make_schedule)
