"""Wan T2V text->video pipeline in PyTorch.

Counterpart of ``tpustack/models/wan/pipeline.py``: the graph the reference
client builds for ComfyUI (CLIPTextEncode x2 -> EmptyHunyuanLatentVideo ->
KSampler -> VAEDecode) as one call: UMT5 encode of the uncond rows then the
cond rows, the CFG flow-matching loop (the DiT over ``[x, x]``, Euler or
Heun), the causal 3D VAE decode, uint8 conversion.  Frame counts follow
ComfyUI's floor convention: 16 requested frames give 13 (1 + 4*floor(15/4)).

Differences from the JAX pipeline, all deliberate:

- PyTorch runs eagerly: the denoise loop is a Python loop of DiT calls, and
  there is no compiled program per signature (``is_warm`` reports the
  signatures already run, which the server logs).
- Noise comes from one ``torch.Generator(device).manual_seed(seed)`` per
  item, so a batched row's noise equals its solo run's, and a seed gives a
  different video than the JAX pipeline's threefry noise.
  :meth:`WanPipeline._run` takes the noise itself, so the tests feed both
  packages the same numbers.
- Parameters are held on the device in the compute dtype, except what flax
  computes in float32 (see ``WanDiT.FLOAT32``, the T5 norms and bias, the
  VAE's ``gamma``).  Random weights are drawn on the device from a seed.
- :meth:`generate_async` returns the device tensor; :attr:`last_run`
  describes the last call: its batch, whether it took the streaming
  decoder, and its text, denoise and decode-enqueue seconds (the first two
  end in a device synchronise on CUDA).
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tpustack_torch.models.wan.config import WanConfig
from tpustack_torch.models.wan.dit import WanDiT
from tpustack_torch.models.wan.scheduler import (canonical_sampler, euler_step, heun_step,
                                                 make_flow_schedule)
from tpustack_torch.models.wan.tokenizer import load_tokenizer
from tpustack_torch.models.wan.umt5 import EMBED_KEYS, UMT5Encoder
from tpustack_torch.models.wan.wanvae import (WanVAEDecoder, WanVAEDecoderStream,
                                              init_decode_caches)
from tpustack_torch.models.wan.weights import build, init_random, load_into
from tpustack_torch.ops.quant import UMT5_QUANTIZABLE, quantize_module_
from tpustack_torch.utils import get_logger, resolve_device

log = get_logger("models.wan.pipeline")

# float32 parts of each tower (parameter name components)
_TEXT_F32 = ("layer_norm", "final_layer_norm", "relative_attention_bias")
_VAE_F32 = ("gamma",)


class WanPipeline:
    """Holds the three towers on one device and runs text->video on them.

    ``device``: ``None`` means the first GPU and raises without one; pass
    ``"cpu"`` to run on the CPU.  ``params``: ``{"text_encoder", "dit",
    "vae_decoder": state_dict}`` (e.g. from
    :func:`tpustack_torch.models.wan.weights.params_from_jax`); without it
    the weights are drawn on the device from ``seed``."""

    #: stream the VAE decode (bounded memory) when the batch's decoded
    #: pixel-frame volume B*F*H*W exceeds this.  Provisional on the H100:
    #: the JAX package's default, set for a 16 GB chip and not yet
    #: re-derived for an 80 GB card
    STREAM_DECODE_PIXELS = int(os.environ.get("WAN_VAE_STREAM_PIXELS", str(3_000_000)))
    #: latent frames per streamed decode chunk; provisional on the H100 (the
    #: JAX package's default)
    STREAM_DECODE_CHUNK = int(os.environ.get("WAN_VAE_STREAM_CHUNK", "2"))

    def __init__(self, config: Optional[WanConfig] = None, *, device=None,
                 params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None, seed: int = 0):
        self.config = c = config or WanConfig.wan_1_3b()
        self.device = dev = resolve_device(device)
        if dev.type == "cuda":
            # float32 work (logits, norms, the DiT head) stays float32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.dtype = dt = c.compute_dtype
        # an int8 text tower is drawn as its float twin and then quantised
        # (int8 layers start at zero); a loaded one is built int8
        text_cfg = (dataclasses.replace(c.text, quant=None) if params is None else c.text)
        self.text_encoder = build(lambda: UMT5Encoder(text_cfg, dt), dt, _TEXT_F32, dev)
        self.dit = build(lambda: WanDiT(c.dit), dt, WanDiT.FLOAT32, dev)
        self.vae_decoder = build(lambda: WanVAEDecoder(c.vae), dt, _VAE_F32, dev)
        self.vae_decoder_stream = WanVAEDecoderStream(self.vae_decoder)
        towers = {"text_encoder": self.text_encoder, "dit": self.dit,
                  "vae_decoder": self.vae_decoder}
        if params is None:
            log.warning("Initialising Wan with RANDOM weights (seed %d, no checkpoint given)",
                        seed)
            gen = torch.Generator(dev).manual_seed(seed)
            for m in towers.values():
                init_random(m, gen)
            if c.text.quant:
                t0 = time.perf_counter()
                quantize_module_(self.text_encoder, names=UMT5_QUANTIZABLE, embed_keys=EMBED_KEYS,
                                 dtype=dt)
                log.info("Quantised the umt5 text tower to int8 in %.1fs",
                         time.perf_counter() - t0)
        else:
            for name, m in towers.items():
                load_into(m, params[name])
        self.tokenizer = load_tokenizer(c.text.vocab_size, c.text.max_length)
        self._warm_keys = set()
        self.last_run: Dict[str, object] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- the loop
    @torch.inference_mode()
    def _denoise_body(self, ids, mask, noise, num_steps: int, sampler: str,
                      guidance_scale: float) -> torch.Tensor:
        """Text encode + CFG flow-matching loop -> float32 latents.

        ``ids``/``mask``: ``[2B, L]``, the uncond rows then the cond rows;
        ``noise``: ``[B, F', H', W', z]`` float32."""
        c, dev = self.config, self.device
        sched = make_flow_schedule(int(num_steps), c.flow_shift)
        t0 = time.perf_counter()
        context = self.text_encoder(torch.as_tensor(np.asarray(ids)).to(dev),
                                    torch.as_tensor(np.asarray(mask)).to(dev))
        self._sync()
        t1 = time.perf_counter()
        guidance = float(np.float32(guidance_scale))

        def velocity(x, t):
            tt = torch.full((x.shape[0] * 2,), float(t), dtype=torch.float32, device=dev)
            v = self.dit(torch.cat([x, x]).to(self.dtype), tt, context)
            v_uncond, v_cond = v.float().chunk(2)
            return v_uncond + guidance * (v_cond - v_uncond)

        x = torch.as_tensor(noise, dtype=torch.float32).to(dev)
        for i in range(int(num_steps)):
            v = velocity(x, sched.timesteps[i])
            if sampler == "heun":
                # endpoint velocity; at the final step sigma_next = 0, so t_next = 0
                v_next = velocity(euler_step(i, x, v, sched), sched.sigmas[i + 1] * 1000.0)
                x = heun_step(i, x, v, v_next, sched)
            else:
                x = euler_step(i, x, v, sched)
        self._sync()
        self.last_run = {"text_s": t1 - t0, "denoise_s": time.perf_counter() - t1}
        return x

    @staticmethod
    def _to_uint8(frames: torch.Tensor) -> torch.Tensor:
        frames = torch.clamp((frames.float() + 1.0) * 127.5, 0.0, 255.0)
        return torch.round(frames).to(torch.uint8)

    @torch.inference_mode()
    def _decode_fused(self, x: torch.Tensor) -> torch.Tensor:
        return self._to_uint8(self.vae_decoder(x))

    @torch.inference_mode()
    def _decode_streaming(self, x: torch.Tensor) -> torch.Tensor:
        """Loop over latent-frame chunks of the streaming decoder: the same
        values as :meth:`_decode_fused` (2-frame causal history per conv),
        memory bounded by the chunk."""
        b, t = x.shape[0], x.shape[1]
        chunk = max(2, self.STREAM_DECODE_CHUNK)
        caches = init_decode_caches(self.config.vae, b, x.shape[2], x.shape[3],
                                    dtype=self.dtype, device=self.device)
        outs, lo = [], 0
        while lo < t:
            n = min(chunk, t - lo)
            if lo == 0 and n < 2:
                raise ValueError("streaming decode needs >= 2 latent frames")
            frames, caches = self.vae_decoder_stream(x[:, lo:lo + n], caches, lo == 0)
            outs.append(self._to_uint8(frames))
            lo += n
        return torch.cat(outs, dim=1)

    def _use_stream_decode(self, noise_shape, height: int, width: int) -> bool:
        b, f_lat = noise_shape[0], noise_shape[1]
        if f_lat < 2:
            return False
        # the fused decoder's activations scale with B*F*H*W: compare the
        # whole batch's decoded volume
        px = b * (1 + self.config.vae.temporal_scale * (f_lat - 1)) * height * width
        return px > self.STREAM_DECODE_PIXELS

    def _run(self, ids, mask, noise, steps: int, sampler: str, guidance_scale: float,
             height: int, width: int) -> torch.Tensor:
        """Denoise + decode (fused or streaming by the decoded pixel-frame
        volume) -> ``[B, F, H, W, 3]`` uint8 on the device."""
        x = self._denoise_body(ids, mask, noise, steps, sampler, guidance_scale)
        stream = self._use_stream_decode(tuple(x.shape), height, width)
        t0 = time.perf_counter()
        out = self._decode_streaming(x) if stream else self._decode_fused(x)
        self.last_run.update(decode_enqueue_s=time.perf_counter() - t0,
                             stream_decode=stream, batch=int(x.shape[0]))
        return out

    def _noise(self, seeds: Sequence[Optional[int]], lat_shape) -> torch.Tensor:
        """One ``torch.Generator(device)`` per item: a row's noise depends
        only on its own seed (``None`` draws one)."""
        return torch.stack([
            torch.randn(lat_shape, generator=torch.Generator(self.device).manual_seed(
                random.randrange(2 ** 31) if s is None else int(s) % (2 ** 31)),
                device=self.device, dtype=torch.float32)
            for s in seeds])

    # --------------------------------------------------------------- public
    def generate(self, prompt: str, *, negative_prompt: str = "", frames: int = 16,
                 steps: int = 25, guidance_scale: float = 6.0, seed: Optional[int] = None,
                 width: int = 512, height: int = 320, sampler: str = "uni_pc",
                 batch_size: int = 1) -> Tuple[np.ndarray, float]:
        """Returns (``[B, F, H, W, 3]`` uint8 frames, wall seconds).  Defaults
        are the reference client's: 512x320, 16 frames, 25 steps, cfg 6.0,
        uni_pc."""
        t0 = time.perf_counter()
        vid = self.generate_async(prompt, negative_prompt=negative_prompt, frames=frames,
                                  steps=steps, guidance_scale=guidance_scale, seed=seed,
                                  width=width, height=height, sampler=sampler,
                                  batch_size=batch_size)
        return vid.cpu().numpy(), time.perf_counter() - t0

    def generate_async(self, prompt: str, *, negative_prompt: str = "", frames: int = 16,
                       steps: int = 25, guidance_scale: float = 6.0,
                       seed: Optional[int] = None, width: int = 512, height: int = 320,
                       sampler: str = "uni_pc", batch_size: int = 1) -> torch.Tensor:
        """One generation of ``batch_size`` rows with seeds ``seed, seed+1,
        ...``; returns the device tensor ``[B, F, H, W, 3]`` uint8 (the
        decode may still be running: ``.cpu()`` waits for it)."""
        base = random.randrange(2 ** 31) if seed is None else int(seed)
        return self.generate_many_async(
            [{"prompt": prompt, "negative_prompt": negative_prompt, "seed": base + i}
             for i in range(batch_size)], frames=frames, steps=steps,
            guidance_scale=guidance_scale, width=width, height=height, sampler=sampler)

    def generate_many_async(self, items, *, frames: int = 16, steps: int = 25,
                            guidance_scale: float = 6.0, width: int = 512, height: int = 320,
                            sampler: str = "uni_pc") -> torch.Tensor:
        """B independent requests (``{"prompt", "negative_prompt", "seed"}``
        each) in one batch: the text encode, the denoise loop and the decode
        run once for all rows.  A row equals the solo run of its (prompt,
        negative, seed)."""
        lat_shape = self._lat_shape(frames, height, width)
        ids, mask = self.tokenizer([it.get("negative_prompt", "") for it in items]
                                   + [it["prompt"] for it in items])
        noise = self._noise([it.get("seed") for it in items], lat_shape)
        out = self._run(ids, mask, noise, int(steps), canonical_sampler(sampler),
                        guidance_scale, height, width)
        self._warm_keys.add((len(items), lat_shape, int(steps), canonical_sampler(sampler)))
        return out

    def pixel_frame_count(self, frames: int) -> int:
        """Decoded frame count for a requested frame count (the ComfyUI
        floor convention); servers must not re-derive it."""
        ts = self.config.vae.temporal_scale
        lat_f = max(0, int(frames) - 1) // ts + 1
        return 1 + ts * (lat_f - 1)

    def signature_key(self, *, batch_size: int, frames: int, steps: int, width: int,
                      height: int, sampler: str):
        return (batch_size, self._lat_shape(frames, height, width), int(steps),
                canonical_sampler(sampler))

    def is_warm(self, **kw) -> bool:
        """True once a call with this signature has run in this process."""
        return self.signature_key(**kw) in self._warm_keys

    def _lat_shape(self, frames: int, height: int, width: int):
        c = self.config
        ts = c.vae.temporal_scale
        lat_f = max(0, int(frames) - 1) // ts + 1
        return c.latent_shape(1 + (lat_f - 1) * ts, height, width)
