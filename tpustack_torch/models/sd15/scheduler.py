"""DDIM noise schedule for SD1.5, as plain tensor functions.

Counterpart of ``tpustack/models/sd15/scheduler.py``: SD's ``scaled_linear``
betas (0.00085 -> 0.012, 1000 train steps), leading-spaced timesteps and the
deterministic DDIM (eta=0) update.  The tables are float32 on the CPU; the
pipeline indexes them per step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NUM_TRAIN_TIMESTEPS = 1000
BETA_START = 0.00085
BETA_END = 0.012


def alphas_cumprod(num_train_timesteps: int = NUM_TRAIN_TIMESTEPS) -> torch.Tensor:
    betas = torch.linspace(BETA_START ** 0.5, BETA_END ** 0.5, num_train_timesteps,
                           dtype=torch.float32) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


class Schedule(NamedTuple):
    """Per-inference-step constants (all ``[num_steps]``)."""

    timesteps: torch.Tensor   # int64 train-timestep fed to the UNet
    alpha_t: torch.Tensor     # float32 alphas_cumprod at t
    alpha_prev: torch.Tensor  # float32 alphas_cumprod at the next, less noisy step
    init_noise_sigma: float   # scale of the initial latents


def make_schedule(num_steps: int, num_train_timesteps: int = NUM_TRAIN_TIMESTEPS) -> Schedule:
    """Leading-spaced timesteps (diffusers' default for SD1.5); the last
    step's ``alpha_prev`` is 1."""
    ac = alphas_cumprod(num_train_timesteps)
    step = num_train_timesteps // num_steps
    ts = torch.arange(num_steps).flip(0) * step
    prev = ts - step
    alpha_prev = torch.where(prev >= 0, ac[prev.clamp_min(0)], torch.ones((), dtype=torch.float32))
    return Schedule(timesteps=ts, alpha_t=ac[ts], alpha_prev=alpha_prev, init_noise_sigma=1.0)


def ddim_step(i: int, x: torch.Tensor, eps: torch.Tensor, sched: Schedule) -> torch.Tensor:
    """Deterministic DDIM (eta=0) update, epsilon-prediction, in float32."""
    a_t = sched.alpha_t[i].to(x.device)
    a_prev = sched.alpha_prev[i].to(x.device)
    x = x.float()
    eps = eps.float()
    x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
