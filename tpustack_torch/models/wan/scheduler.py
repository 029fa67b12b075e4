"""Flow-matching sampling schedule for the Wan T2V family.

Counterpart of ``tpustack/models/wan/scheduler.py``: the ComfyUI ``simple``
schedule (uniform sigmas in (1, 0] warped by the video timestep shift
``s*sig / (1 + (s-1)*sig)``), Euler and Heun steps, and the ComfyUI sampler
names mapped onto them (``uni_pc``/``dpmpp_2m`` -> ``heun``, everything else
-> ``euler``).  Rectified flow: ``x_sig = (1-sig)*x0 + sig*eps``, the model
predicts ``v = eps - x0``, a step is ``x <- x + (sig_next - sig)*v``; the DiT
is conditioned on ``sig*1000``.

The sigmas are float32 and equal the JAX package's bit for bit: the uniform
grid is ``1 - i*(1/n)`` in float32, which is the value ``jnp.linspace(1, 0,
n+1)`` gives (``start*(1-step) + stop*step`` with the ``i/n`` division
compiled as a product by the reciprocal).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FlowSchedule(NamedTuple):
    sigmas: torch.Tensor     # [steps + 1] float32, descending, sigmas[-1] == 0
    timesteps: torch.Tensor  # [steps] float32, sigma * 1000 (DiT conditioning)


def make_flow_schedule(num_steps: int, shift: float = 5.0) -> FlowSchedule:
    n = int(num_steps)
    step = torch.arange(n, dtype=torch.float32) * torch.tensor(1.0 / n, dtype=torch.float32)
    sig = torch.cat([1.0 - step, torch.zeros(1)])
    sig = shift * sig / (1.0 + (shift - 1.0) * sig)
    return FlowSchedule(sigmas=sig, timesteps=sig[:-1] * 1000.0)


def euler_step(i: int, x: torch.Tensor, v: torch.Tensor, sched: FlowSchedule) -> torch.Tensor:
    dt = float(sched.sigmas[i + 1] - sched.sigmas[i])
    return x + dt * v


def heun_step(i: int, x: torch.Tensor, v: torch.Tensor, v_next: torch.Tensor,
              sched: FlowSchedule) -> torch.Tensor:
    """Trapezoidal correction with the velocity at the predicted endpoint."""
    dt = float(sched.sigmas[i + 1] - sched.sigmas[i])
    return x + dt * 0.5 * (v + v_next)


# ComfyUI sampler-name compatibility (the reference client sends "uni_pc")
_SECOND_ORDER = {"uni_pc", "uni_pc_bh2", "heun", "dpmpp_2m", "dpmpp_2m_sde"}


def canonical_sampler(name: str) -> str:
    return "heun" if name in _SECOND_ORDER else "euler"
