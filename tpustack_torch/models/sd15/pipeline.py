"""SD1.5 text->image pipeline in PyTorch.

Counterpart of ``tpustack/models/sd15/pipeline.py``: tokenise prompt and
negative prompt, encode both with CLIP, run classifier-free guidance as one
UNet call at batch 2B ordered ``[uncond, cond]``, step DDIM, decode
``x / 0.18215`` through the VAE and quantise ``round(clip((img+1)*127.5))``
to uint8 ``[B, H, W, 3]``.

Differences from the JAX pipeline, all deliberate:

- PyTorch runs eagerly: there is no compiled program per signature, and the
  denoise loop is a Python loop of UNet calls.
- Noise comes from one ``torch.Generator(device).manual_seed(seed)`` per
  image, so a seed gives a different image than the JAX pipeline's threefry
  noise.  :meth:`SD15Pipeline._denoise_decode` takes the noise itself, so
  the tests feed both packages the same numbers.
- Parameters are held on the device in the compute dtype (bf16 for
  ``sd15()``, float32 for ``tiny()``); computing in bf16 from bf16-stored
  weights is what flax's ``Dense(dtype=bf16)`` does with its float32 params.
  ``conv_out`` of the UNet and VAE stays float32, as in flax.
"""

from __future__ import annotations

import random
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpustack_torch.models.sd15.clip import CLIPTextEncoder
from tpustack_torch.models.sd15.config import SD15Config
from tpustack_torch.models.sd15.scheduler import ddim_step, make_schedule
from tpustack_torch.models.sd15.tokenizer import load_tokenizer
from tpustack_torch.models.sd15.unet import UNet2DCondition
from tpustack_torch.models.sd15.vae import VAEDecoder
from tpustack_torch.models.sd15.weights import load_into
from tpustack_torch.utils import get_logger, resolve_device

log = get_logger("models.sd15.pipeline")


def _random_init(module: nn.Module, gen: torch.Generator) -> None:
    """Shape-exact random weights from ``gen``, flax's defaults: lecun-normal
    kernels and token embeddings (std 1/sqrt(fan_in)), zero biases, unit norm
    scales, and CLIP's position embedding at std 0.01."""
    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                std = 0.01 if name.endswith("position_embedding") else m.embedding_dim ** -0.5
                m.weight.normal_(0.0, std, generator=gen)


class SD15Pipeline:
    """Holds the three towers on one device and runs txt2img on them.

    ``device``: ``None`` means the first GPU and raises without one; pass
    ``"cpu"`` to run on the CPU.  ``params``: ``{tower: state_dict}`` (for
    example from :func:`tpustack_torch.models.sd15.weights.params_from_jax`);
    without it the weights are drawn from ``seed``."""

    def __init__(self, config: Optional[SD15Config] = None, *, device=None,
                 params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                 seed: int = 0):
        self.config = c = config or SD15Config.sd15()
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # float32 work (attention logits, conv_out) stays float32: TF32
            # off for both matmuls and cuDNN convolutions
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.dtype = c.compute_dtype
        with torch.device(self.device):
            self.text_encoder = CLIPTextEncoder(c.text)
            self.unet = UNet2DCondition(c.unet)
            self.vae_decoder = VAEDecoder(c.vae)
        towers = {"text_encoder": self.text_encoder, "unet": self.unet,
                  "vae_decoder": self.vae_decoder}
        if params is None:
            log.warning("Initialising SD1.5 with RANDOM weights (seed %d, no checkpoint given)", seed)
            gen = torch.Generator(self.device).manual_seed(seed)
            for m in towers.values():
                _random_init(m, gen)
        for m in towers.values():
            m.to(self.dtype).eval().requires_grad_(False)
        # the output convs compute in float32, as flax's conv_out(dtype=f32)
        self.unet.conv_out.float()
        self.vae_decoder.decoder.conv_out.float()
        if params is not None:
            for name, m in towers.items():
                load_into(m, params[name])  # each tensor in its module's dtype
        self.tokenizer = load_tokenizer(c.text.vocab_size, c.text.max_length)

    # ------------------------------------------------------------- the loop
    @torch.inference_mode()
    def _denoise_decode(self, cond_ids, uncond_ids, noise, steps: int,
                        guidance: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encode -> CFG DDIM loop -> VAE decode -> uint8, from given noise.

        ``cond_ids``/``uncond_ids``: ``[B, L]`` token ids; ``noise``: ``[B,
        h, w, 4]`` float32 initial latents (NHWC).  Returns ``(images [B, H,
        W, 3] uint8, final latents [B, h, w, 4] float32)`` on the device."""
        c = self.config
        dev = self.device
        sched = make_schedule(int(steps))
        ids = torch.cat([torch.as_tensor(np.asarray(uncond_ids)),
                         torch.as_tensor(np.asarray(cond_ids))]).to(dev)
        context = self.text_encoder(ids)
        x = torch.as_tensor(noise, dtype=torch.float32).to(dev) * sched.init_noise_sigma
        for i in range(int(steps)):
            t = torch.full((x.shape[0] * 2,), int(sched.timesteps[i]), device=dev)
            eps = self.unet(torch.cat([x, x]).to(self.dtype), t, context)
            eps_uncond, eps_cond = eps.float().chunk(2)
            eps = eps_uncond + guidance * (eps_cond - eps_uncond)
            x = ddim_step(i, x, eps, sched)
        img = self.vae_decoder(x / c.vae.scaling_factor)
        img = torch.clamp((img.float() + 1.0) * 127.5, 0.0, 255.0)
        return torch.round(img).to(torch.uint8), x

    # --------------------------------------------------------------- public
    def check_request(self, steps: int, width: int, height: int) -> None:
        """Raise ``ValueError`` for a request :meth:`generate` cannot serve."""
        c = self.config
        # latents must survive the UNet's own down/up path cleanly
        factor = c.vae_scale * 2 ** (len(c.unet.block_out_channels) - 1)
        if width % factor or height % factor or width <= 0 or height <= 0:
            raise ValueError(f"width/height must be positive multiples of {factor}")
        if steps < 1:
            raise ValueError("steps must be >= 1")

    def generate(self, prompt, *, steps: int = 30, guidance_scale: float = 7.5,
                 seed=None, width: int = 512, height: int = 512,
                 negative_prompt="", batch_size: int = 1) -> Tuple[np.ndarray, float]:
        """Returns (``[B, H, W, 3]`` uint8 images, wall seconds).

        ``prompt``/``negative_prompt``/``seed`` may each be a sequence, one
        per image, so distinct requests share one batch (the server's
        micro-batcher relies on this).  A scalar prompt is repeated
        ``batch_size`` times; a scalar seed expands to ``seed, seed+1, ...``
        so each image's noise depends only on its own seed; ``None`` draws a
        seed."""
        t0 = time.perf_counter()
        c = self.config
        self.check_request(steps, width, height)
        prompts = [prompt] * batch_size if isinstance(prompt, str) else list(prompt)
        negs = ([negative_prompt] * len(prompts) if isinstance(negative_prompt, str)
                else list(negative_prompt))
        if isinstance(seed, (list, tuple)):
            seeds = list(seed)
        elif seed is None:
            seeds = [None] * len(prompts)
        else:
            seeds = [seed + i for i in range(len(prompts))]
        if not len(prompts) == len(negs) == len(seeds):
            raise ValueError(f"prompt/negative_prompt/seed lengths differ: "
                             f"{len(prompts)}/{len(negs)}/{len(seeds)}")
        lat = (height // c.vae_scale, width // c.vae_scale, c.unet.in_channels)
        noise = torch.stack([
            torch.randn(lat, generator=torch.Generator(self.device).manual_seed(
                random.randrange(2 ** 31) if s is None else int(s)),
                device=self.device, dtype=torch.float32)
            for s in seeds])
        img, _ = self._denoise_decode(self.tokenizer(prompts), self.tokenizer(negs),
                                      noise, steps, guidance_scale)
        out = img.cpu().numpy()
        return out, time.perf_counter() - t0
