"""The PyTorch port's SD1.5 slice against the JAX package, on the CPU.

Both sides get the same weights (the JAX tree from a numpy seed, carried to
the port by ``params_from_jax``) and the same numpy inputs, at the tiny
preset in float32.  The JAX tree is built from ``jax.eval_shape`` plus numpy
values, so no flax init runs; the JAX modules run eagerly.

Tolerances: both sides compute in float32 on the CPU, so they differ only in
summation order and in the order of fused operations (XLA vs ATen kernels).
Through CLIP's two layers that stays below 1e-4 absolute; through the UNet's
~20 normalised layers below 1e-3 absolute on outputs of order 1; the
uint8 images agree within +-2 levels (one rounding step either side of a
value whose float difference is a few 1e-3 of a level's 255 scale).
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustack.models.sd15 import SD15Config as JaxConfig
from tpustack.models.sd15.clip import CLIPTextEncoder as JaxCLIP
from tpustack.models.sd15.scheduler import ddim_step as jax_ddim_step
from tpustack.models.sd15.scheduler import make_schedule as jax_make_schedule
from tpustack.models.sd15.tokenizer import load_tokenizer as jax_load_tokenizer
from tpustack.models.sd15.unet import UNet2DCondition as JaxUNet
from tpustack.models.sd15.vae import VAEDecoder as JaxVAE
from tpustack.models.sd15.weights import export_state_dict
from tpustack_torch.models.sd15 import SD15Config, SD15Pipeline
from tpustack_torch.models.sd15.clip import CLIPTextEncoder
from tpustack_torch.models.sd15.scheduler import make_schedule
from tpustack_torch.models.sd15.tokenizer import HashTokenizer, load_tokenizer
from tpustack_torch.models.sd15.unet import UNet2DCondition, set_attn_impl
from tpustack_torch.models.sd15.vae import VAEDecoder
from tpustack_torch.models.sd15.weights import load_into, params_from_jax

LAT = 8  # 64x64 images


def _fill(path, s, rng):
    """Values of order 1 through every layer: lecun-normal kernels, norm
    scales near 1, small non-zero biases."""
    name = path[-1].key
    if name == "kernel":
        return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
    if name == "scale":
        return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
    if name == "bias":
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)
    return (0.5 * rng.randn(*s.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def jcfg():
    return JaxConfig.tiny()


@pytest.fixture(scope="module")
def jax_tree(jcfg):
    c = jcfg
    key = jax.random.PRNGKey(0)
    ids = jnp.zeros((1, c.text.max_length), jnp.int32)
    ctx = jnp.zeros((1, c.text.max_length, c.unet.cross_attention_dim))
    shapes = {
        "text_encoder": jax.eval_shape(JaxCLIP(c.text).init, key, ids)["params"],
        "unet": jax.eval_shape(JaxUNet(c.unet).init, key, jnp.zeros((1, LAT, LAT, 4)),
                               jnp.zeros((1,), jnp.int32), ctx)["params"],
        "vae_decoder": jax.eval_shape(JaxVAE(c.vae).init, key,
                                      jnp.zeros((1, LAT, LAT, 4)))["params"],
    }
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map_with_path(lambda p, s: _fill(p, s, rng), shapes)


@pytest.fixture(scope="module")
def port_params(jax_tree):
    return params_from_jax(jax_tree)


@pytest.fixture(scope="module")
def pipe(port_params):
    return SD15Pipeline(SD15Config.tiny(), device="cpu", params=port_params)


def _np(x):
    return np.asarray(x, dtype=np.float32)


# ----------------------------------------------------------------- weights
@pytest.mark.parametrize("tower", ["text_encoder", "unet", "vae_decoder"])
def test_params_from_jax_matches_export_state_dict(jax_tree, port_params, tower):
    """Key for key and value for value, the JAX package's own exporter."""
    ref = export_state_dict(jax_tree[tower], tower)
    got = port_params[tower]
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_load_is_strict(port_params):
    unet = UNet2DCondition(SD15Config.tiny().unet)
    sd = dict(port_params["unet"])
    sd.pop("conv_in.bias")
    with pytest.raises(RuntimeError):
        load_into(unet, sd)
    sd = dict(port_params["unet"])
    sd["conv_in.weight"] = sd["conv_in.weight"][:1]
    with pytest.raises(ValueError, match="shape"):
        load_into(unet, sd)
    with pytest.raises(ValueError, match="lacks"):
        params_from_jax({"unet": {}})


# ------------------------------------------------------------------ towers
def test_clip_matches_jax(jcfg, jax_tree, port_params):
    rng = np.random.RandomState(1)
    ids = rng.randint(0, jcfg.text.vocab_size, size=(2, jcfg.text.max_length)).astype(np.int32)
    ref = JaxCLIP(jcfg.text).apply({"params": jax_tree["text_encoder"]}, jnp.asarray(ids))
    m = CLIPTextEncoder(SD15Config.tiny().text)
    load_into(m, port_params["text_encoder"])
    with torch.no_grad():
        got = m(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_unet_matches_jax(jcfg, jax_tree, port_params, impl):
    """``flash``: JAX runs the interpret-mode Pallas kernel, the port the
    kernel's plain twin (the wrapper's CPU path)."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, LAT, LAT, 4).astype(np.float32)
    t = np.array([981, 1], np.int32)
    ctx = rng.randn(2, jcfg.text.max_length, jcfg.unet.cross_attention_dim).astype(np.float32)
    jm = JaxUNet(dataclasses.replace(jcfg.unet, attn_impl=impl))
    ref = jm.apply({"params": jax_tree["unet"]}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    m = UNet2DCondition(SD15Config.tiny().unet)
    load_into(m, port_params["unet"])
    set_attn_impl(m, impl)
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert float(np.abs(_np(ref)).mean()) > 0.05  # not a trivially small output
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-3, rtol=1e-3)


def test_vae_decoder_matches_jax(jcfg, jax_tree, port_params):
    rng = np.random.RandomState(3)
    z = rng.randn(1, LAT, LAT, 4).astype(np.float32)
    ref = JaxVAE(jcfg.vae).apply({"params": jax_tree["vae_decoder"]}, jnp.asarray(z))
    m = VAEDecoder(SD15Config.tiny().vae)
    load_into(m, port_params["vae_decoder"])
    with torch.no_grad():
        got = m(torch.from_numpy(z))
    assert got.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-3, rtol=1e-3)


def test_scheduler_matches_jax():
    # float32 cumprod of 1000 factors: XLA's parallel scan and ATen's
    # sequential loop round differently, ~1e-6 relative
    for steps in (2, 30):
        ref, got = jax_make_schedule(steps), make_schedule(steps)
        np.testing.assert_array_equal(got.timesteps.numpy(), np.asarray(ref.timesteps))
        np.testing.assert_allclose(got.alpha_t.numpy(), np.asarray(ref.alpha_t), rtol=1e-5)
        np.testing.assert_allclose(got.alpha_prev.numpy(), np.asarray(ref.alpha_prev), rtol=1e-5)
        assert float(got.alpha_prev[-1]) == 1.0


# ------------------------------------------------------------ whole slice
def test_denoise_decode_matches_jax(jcfg, jax_tree, pipe):
    """The port's ``_denoise_decode`` against the JAX modules composed the
    same way (CLIP -> CFG loop of UNet + DDIM -> VAE -> uint8) on the same
    numpy noise: 64x64, 2 steps, guidance 7.5."""
    steps, guidance = 2, 7.5
    tok = load_tokenizer(jcfg.text.vocab_size, jcfg.text.max_length)
    cond = tok(["a red fox in the snow", "a lighthouse at dusk"])
    uncond = tok(["", "blurry"])
    noise = np.random.RandomState(4).randn(2, LAT, LAT, 4).astype(np.float32)

    p = jax_tree
    ctx = JaxCLIP(jcfg.text).apply({"params": p["text_encoder"]},
                                   jnp.asarray(np.concatenate([uncond, cond])))
    unet = JaxUNet(jcfg.unet)
    sched = jax_make_schedule(steps)
    x = jnp.asarray(noise) * sched.init_noise_sigma
    for i in range(steps):
        t = jnp.broadcast_to(sched.timesteps[i], (4,))
        eps = unet.apply({"params": p["unet"]}, jnp.concatenate([x, x]), t, ctx)
        eu, ec = jnp.split(eps.astype(jnp.float32), 2)
        x = jax_ddim_step(i, x, eu + guidance * (ec - eu), sched)
    img = JaxVAE(jcfg.vae).apply({"params": p["vae_decoder"]}, x / jcfg.vae.scaling_factor)
    ref_img = np.asarray(jnp.round(jnp.clip((img + 1.0) * 127.5, 0, 255)).astype(jnp.uint8))

    got_img, got_lat = pipe._denoise_decode(cond, uncond, noise, steps, guidance)
    np.testing.assert_allclose(got_lat.numpy(), _np(x), atol=2e-3, rtol=1e-3)
    diff = np.abs(got_img.numpy().astype(int) - ref_img.astype(int))
    assert got_img.shape == (2, 64, 64, 3) and got_img.dtype == torch.uint8
    assert diff.max() <= 2, diff.max()
    assert len(np.unique(ref_img)) > 10  # a real image, not a constant


def test_generate_seeds_and_validation(pipe):
    a, _ = pipe.generate("a cat", steps=1, width=64, height=64, seed=5, batch_size=2)
    b, _ = pipe.generate(["a cat"], steps=1, width=64, height=64, seed=[6])
    assert a.shape == (2, 64, 64, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a[1], b[0])  # scalar seed -> seed, seed+1
    assert not np.array_equal(a[0], a[1])
    with pytest.raises(ValueError, match="multiples"):
        pipe.generate("x", steps=1, width=72, height=64)
    with pytest.raises(ValueError, match="lengths"):
        pipe.generate(["x", "y"], steps=1, width=64, height=64, seed=[1])


def test_pipeline_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SD15Pipeline(SD15Config.tiny())


# --------------------------------------------------------------- tokenizer
PROMPTS = ["a photo of an astronaut riding a horse on mars",
           "A Cat,<|endoftext|> sitting; on a MAT!!",
           "", "   spaced   out\ttabs\nnewline", "numbers 1234 and co-op's",
           "word " * 40]


def test_tokenizer_ids_equal_jax():
    for vocab, length in ((49408, 77), (6656, 16)):
        ref = jax_load_tokenizer(vocab, length)(PROMPTS)
        got = load_tokenizer(vocab, length)(PROMPTS)
        np.testing.assert_array_equal(got, ref)


def test_hash_tokenizer_equals_jax():
    from tpustack.models.sd15.tokenizer import HashTokenizer as JaxHash

    np.testing.assert_array_equal(HashTokenizer(6656, 16)(PROMPTS), JaxHash(6656, 16)(PROMPTS))


def test_tokenizer_dir_errors(monkeypatch, tmp_path):
    monkeypatch.setenv("SD15_TOKENIZER_DIR", str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError):
        load_tokenizer(49408, 77)
    monkeypatch.setenv("SD15_TOKENIZER_DIR", str(tmp_path))  # exists, no files
    with pytest.raises(RuntimeError, match="failed to load"):
        load_tokenizer(49408, 77)


# ------------------------------------------------------------------ imports
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "tpustack_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax_or_tpustack():
    banned = ("jax", "flax", "tpustack")
    files = _port_sources()
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in banned, f"{path} imports {mod}"
