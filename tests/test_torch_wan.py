"""The PyTorch port's Wan T2V slice against the JAX package, on the CPU.

Both sides get the same weights (a JAX tree of numpy values from a seed,
carried to the port by ``params_from_jax``) and the same numpy inputs, at
``WanConfig.tiny()`` in float32.  The JAX tree comes from ``jax.eval_shape``
plus numpy values, so no flax init runs.

Tolerances, stated before the comparison: both sides compute in float32 on
the CPU and differ only in summation order and fused operations (XLA vs
ATen), so the modules agree within 1e-4 relative L2 (the norm of the
difference over the norm of the JAX output), the schedule and the tokenizer
exactly, and uint8 frames within +-2 levels (one rounding step either side
of a value whose float difference is far below a level).
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustack.models.wan import WanConfig as JaxConfig
from tpustack.models.wan import WanPipeline as JaxPipeline
from tpustack.models.wan.dit import WanDiT as JaxDiT
from tpustack.models.wan.scheduler import make_flow_schedule as jax_schedule
from tpustack.models.wan.tokenizer import T5HashTokenizer as JaxTokenizer
from tpustack.models.wan.umt5 import UMT5Encoder as JaxUMT5
from tpustack.models.wan.wanvae import WanVAEDecoder as JaxVAEDecoder
from tpustack.models.wan.weights import export_wan_state_dict
from tpustack_torch.models.wan import WanConfig, WanPipeline
from tpustack_torch.models.wan.dit import WanDiT
from tpustack_torch.models.wan.scheduler import canonical_sampler, make_flow_schedule
from tpustack_torch.models.wan.tokenizer import T5HashTokenizer, load_tokenizer
from tpustack_torch.models.wan.umt5 import UMT5Encoder
from tpustack_torch.models.wan.wanvae import (WanVAEDecoder, WanVAEDecoderStream,
                                              init_decode_caches)
from tpustack_torch.models.wan.weights import load_into, params_from_jax

REL = 1e-4  # relative L2, float32 on both sides
LEVELS = 2  # uint8 frames


def _fill(path, s, rng):
    """Values of order 1 through every layer: lecun-normal kernels, norm
    scales near 1, small non-zero biases, and modulation / bias tables and
    embeddings of order 0.2-0.5."""
    name = path[-1].key
    if name == "kernel":
        return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
    if name in ("scale", "gamma"):
        return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
    if name == "bias":
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)
    if name == "embedding":
        return (0.5 * rng.randn(*s.shape)).astype(np.float32)
    return (0.2 * rng.randn(*s.shape)).astype(np.float32)  # modulation, rel_embedding


def _japply(module, params, *args):
    """A flax module's ``apply``, jitted: one compile is faster on the CPU
    than eager op-by-op dispatch."""
    return np.asarray(jax.jit(module.apply)({"params": params}, *map(jnp.asarray, args)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def jcfg():
    return JaxConfig.tiny()


@pytest.fixture(scope="module")
def jax_tree(jcfg):
    c, key = jcfg, jax.random.PRNGKey(0)
    ids = jnp.zeros((1, c.text.max_length), jnp.int32)
    lat = jnp.zeros((1, 1, 4, 4, c.dit.in_channels))
    ctx = jnp.zeros((1, c.text.max_length, c.dit.text_dim))
    shapes = {
        "text_encoder": jax.eval_shape(JaxUMT5(c.text).init, key, ids)["params"],
        "dit": jax.eval_shape(JaxDiT(c.dit).init, key, lat, jnp.zeros((1,)), ctx)["params"],
        "vae_decoder": jax.eval_shape(JaxVAEDecoder(c.vae).init, key,
                                      jnp.zeros((1, 1, 4, 4, c.vae.z_channels)))["params"],
    }
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map_with_path(lambda p, s: _fill(p, s, rng), shapes)


@pytest.fixture(scope="module")
def port_params(jax_tree):
    return params_from_jax(jax_tree)


@pytest.fixture(scope="module")
def pipe(port_params):
    return WanPipeline(WanConfig.tiny(), device="cpu", params=port_params)


def _module(cls, cfg, params):
    m = cls(cfg)
    load_into(m, params)
    return m.eval()


# ----------------------------------------------------------------- weights
@pytest.mark.parametrize("tower,model", [("text_encoder", "umt5"), ("dit", "dit"),
                                         ("vae_decoder", "vae_decoder")])
def test_params_from_jax_matches_export_state_dict(jax_tree, port_params, pipe, tower, model):
    """Key for key and value for value the JAX package's exporter (the
    released checkpoints' names and layouts), and the port's modules load
    them strictly."""
    ref = export_wan_state_dict(jax_tree[tower], model)
    got = port_params[tower]
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    own = getattr(pipe, tower).state_dict()
    assert set(own) == set(ref)
    assert all(tuple(own[k].shape) == v.shape for k, v in ref.items())


def test_load_is_strict(port_params):
    dit = WanDiT(WanConfig.tiny().dit)
    sd = dict(port_params["dit"])
    sd.pop("blocks.0.self_attn.norm_q.weight")
    with pytest.raises(RuntimeError):
        load_into(dit, sd)
    sd = dict(port_params["dit"])
    sd["patch_embedding.weight"] = sd["patch_embedding.weight"][:1]
    with pytest.raises(ValueError, match="shape"):
        load_into(dit, sd)
    with pytest.raises(ValueError, match="lacks"):
        params_from_jax({"dit": {}})


# ------------------------------------------------------- scheduler, tokenizer
@pytest.mark.parametrize("steps", [1, 2, 3, 25, 50])
def test_schedule_equals_jax(steps):
    ref, got = jax_schedule(steps, 5.0), make_flow_schedule(steps, 5.0)
    assert got.sigmas.dtype == torch.float32
    np.testing.assert_array_equal(got.sigmas.numpy(), np.asarray(ref.sigmas))
    np.testing.assert_array_equal(got.timesteps.numpy(), np.asarray(ref.timesteps))
    assert canonical_sampler("uni_pc") == "heun" and canonical_sampler("euler") == "euler"


PROMPTS = ["a red panda eating bamboo, cinematic", "", "A Cat,sitting; on a MAT!!",
           "numbers 1234 and co-op's", "word " * 40]


@pytest.mark.parametrize("vocab,length", [(256384, 512), (512, 16)])
def test_tokenizer_ids_and_mask_equal_jax(vocab, length):
    ref_ids, ref_mask = JaxTokenizer(vocab, length)(PROMPTS)
    ids, mask = T5HashTokenizer(vocab, length)(PROMPTS)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(mask, ref_mask)


def test_tokenizer_dir_raises(monkeypatch):
    monkeypatch.setenv("WAN_TOKENIZER_DIR", "/nonexistent")
    with pytest.raises(RuntimeError, match="failed to load"):
        load_tokenizer(512, 16)


def test_unported_options_raise():
    cfg = WanConfig.tiny()
    # the int8 text tower is ported: only an unknown mode raises now
    assert dataclasses.replace(cfg.text, quant="int8").quant == "int8"
    with pytest.raises(ValueError, match="int4"):
        dataclasses.replace(cfg.text, quant="int4")
    with pytest.raises(NotImplementedError, match="vae3d"):
        dataclasses.replace(cfg.vae, arch="tpu")


def test_latent_normalization_equals_jax():
    from tpustack.models.wan.wanvae import normalize_latents as jax_normalize

    from tpustack_torch.models.wan.wanvae import latent_stats, normalize_latents

    vae = WanConfig.wan_1_3b().vae
    mu = np.random.RandomState(5).randn(1, 2, 3, 4, vae.z_channels).astype(np.float32)
    ref = np.asarray(jax_normalize(JaxConfig.wan_1_3b().vae, jnp.asarray(mu)))
    np.testing.assert_array_equal(normalize_latents(vae, torch.from_numpy(mu)).numpy(), ref)
    assert latent_stats(WanConfig.tiny().vae) is None


# ------------------------------------------------------------------ towers
def test_umt5_matches_jax_with_ragged_mask(jcfg, jax_tree, port_params):
    tok = T5HashTokenizer(jcfg.text.vocab_size, jcfg.text.max_length)
    ids, mask = tok(["a panda", "", "a red panda eating bamboo in the rain at dusk"])
    ref = _japply(JaxUMT5(jcfg.text), jax_tree["text_encoder"], ids, mask)
    m = _module(UMT5Encoder, WanConfig.tiny().text, port_params["text_encoder"])
    with torch.no_grad():
        got = m(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == (3, jcfg.text.max_length, jcfg.text.dim)
    assert (got[~mask] == 0).all() and (np.abs(got[mask]) > 0).any()
    assert _rel(got, ref) < REL


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_dit_matches_jax(jcfg, jax_tree, port_params, impl):
    """A non-square latent grid (3 frames x 8 x 12, so 3 x 4 x 6 tokens),
    where a wrong RoPE split or unpatchify order would show.  ``flash``: JAX
    runs the interpret-mode Pallas kernel, the port the kernel's plain twin
    (the wrapper's CPU path)."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 8, 12, jcfg.dit.in_channels).astype(np.float32)
    t = np.array([999.0, 1.5], np.float32)
    ctx = rng.randn(2, jcfg.text.max_length, jcfg.dit.text_dim).astype(np.float32)
    jm = JaxDiT(dataclasses.replace(jcfg.dit, attn_impl=impl))
    ref = _japply(jm, jax_tree["dit"], x, t, ctx)
    cfg = dataclasses.replace(WanConfig.tiny().dit, attn_impl=impl)
    m = _module(WanDiT, cfg, port_params["dit"])
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert float(np.abs(np.asarray(ref)).mean()) > 0.05  # not a trivially small output
    assert _rel(got.numpy(), ref) < REL


def test_vae_decoder_matches_jax_and_stream_matches_both(jcfg, jax_tree, port_params):
    """The whole-sequence decoder against the JAX one, and the port's
    streaming decode (chunks 2, 2, 1: the frame-0 bypass and the up3d tail
    across chunk edges) against the port's whole decode and the JAX
    decoder."""
    rng = np.random.RandomState(3)
    z = rng.randn(1, 5, 4, 6, jcfg.vae.z_channels).astype(np.float32)
    ref = _japply(JaxVAEDecoder(jcfg.vae), jax_tree["vae_decoder"], z)
    m = _module(WanVAEDecoder, WanConfig.tiny().vae, port_params["vae_decoder"])
    stream = WanVAEDecoderStream(m)
    with torch.no_grad():
        full = m(torch.from_numpy(z)).numpy()
        caches, outs, lo = init_decode_caches(WanConfig.tiny().vae, 1, 4, 6), [], 0
        for n in (2, 2, 1):
            frames, caches = stream(torch.from_numpy(z[:, lo:lo + n]), caches, lo == 0)
            outs.append(frames)
            lo += n
        streamed = torch.cat(outs, dim=1).numpy()
        with pytest.raises(ValueError, match=">= 2 latent frames"):
            stream(torch.from_numpy(z[:, :1]), init_decode_caches(WanConfig.tiny().vae, 1, 4, 6),
                   True)
    assert full.shape == ref.shape == (1, 17, 32, 48, 3)
    assert _rel(full, ref) < REL
    np.testing.assert_allclose(streamed, full, atol=1e-5, rtol=0)
    assert _rel(streamed, ref) < REL


# ------------------------------------------------------------ whole slice
def _jax_video(jcfg, jax_tree, ids, mask, noise, steps, sampler, guidance):
    jp = JaxPipeline(jcfg, params=jax_tree)
    x = jp._denoise_body(jax_tree, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(noise),
                         steps, sampler, jnp.float32(guidance))
    frames = _japply(JaxVAEDecoder(jcfg.vae), jax_tree["vae_decoder"], x)
    return np.asarray(x), np.asarray(JaxPipeline._to_uint8(jnp.asarray(frames)))


@pytest.mark.parametrize("sampler,frames", [("euler", 5), ("heun", 5), ("heun", 1)])
def test_pipeline_matches_jax(jcfg, jax_tree, pipe, monkeypatch, sampler, frames):
    """The port's denoise + decode against the JAX ``_denoise_body`` + VAE
    decode on the same numpy noise: 32x32, 2 steps, cfg 6.0, the uncond
    rows then the cond rows of two prompts; 5 frames through both the fused
    and the streaming decoder, and the 1-frame image mode."""
    steps, guidance, hw = 2, 6.0, 32
    lat = pipe._lat_shape(frames, hw, hw)
    ids, mask = pipe.tokenizer(["", "blurry", "a red panda", "a blue robot dancing"])
    noise = np.random.RandomState(4).randn(2, *lat).astype(np.float32)
    ref_x, ref_img = _jax_video(jcfg, jax_tree, ids, mask, noise, steps, sampler, guidance)
    got_x = pipe._denoise_body(ids, mask, noise, steps, sampler, guidance)
    assert _rel(got_x.numpy(), ref_x) < REL
    assert len(np.unique(ref_img)) > 10  # a real video, not a constant
    decodes = [False, True] if frames > 1 else [False]
    for stream in decodes:
        monkeypatch.setattr(WanPipeline, "STREAM_DECODE_PIXELS", 0 if stream else 10 ** 9)
        img = pipe._run(ids, mask, noise, steps, sampler, guidance, hw, hw)
        assert pipe.last_run["stream_decode"] is stream
        assert img.shape == (2, pipe.pixel_frame_count(frames), hw, hw, 3)
        assert img.dtype == torch.uint8
        diff = np.abs(img.numpy().astype(int) - ref_img.astype(int))
        assert diff.max() <= LEVELS, (stream, diff.max())


def test_generate_rows_equal_solo_and_frame_floor(pipe):
    """A batched row's noise (and so its video) is its solo run's; 16
    requested frames decode to 13 under the ComfyUI floor convention."""
    kw = dict(frames=5, steps=1, width=32, height=32, sampler="euler", guidance_scale=6.0)
    many = pipe.generate_many_async([{"prompt": "a panda", "negative_prompt": "blurry",
                                      "seed": 7},
                                     {"prompt": "a robot", "seed": 8}], **kw)
    solo, _ = pipe.generate("a panda", negative_prompt="blurry", seed=7, **kw)
    d = np.abs(many[0].numpy().astype(int) - solo[0].astype(int))
    assert d.max() <= LEVELS
    assert not np.array_equal(many[0].numpy(), many[1].numpy())
    assert pipe.pixel_frame_count(16) == 13 and pipe.pixel_frame_count(1) == 1
    assert pipe._lat_shape(16, 320, 512) == (4, 40, 64, 4)
    assert pipe.is_warm(batch_size=2, frames=5, steps=1, width=32, height=32, sampler="euler")
    with pytest.raises(ValueError, match="multiples"):
        pipe.generate("x", frames=5, steps=1, width=40, height=32)


def test_pipeline_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WanPipeline(WanConfig.tiny())


def test_random_init_is_seeded_and_full_width_shapes():
    """Random weights come from the seed alone; the full-width towers have
    the released checkpoints' parameter counts (built on the meta device,
    no storage)."""
    a = WanPipeline(WanConfig.tiny(), device="cpu", seed=3)
    b = WanPipeline(WanConfig.tiny(), device="cpu", seed=3)
    for name in ("text_encoder", "dit", "vae_decoder"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    full = WanConfig.wan_1_3b()
    with torch.device("meta"):
        n_dit = sum(p.numel() for p in WanDiT(full.dit).parameters())
        n_text = sum(p.numel() for p in UMT5Encoder(full.text).parameters())
    assert 1.3e9 < n_dit < 1.5e9, n_dit
    assert 5.6e9 < n_text < 5.8e9, n_text


# ------------------------------------------------------------------ imports
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAN_MODULES = [os.path.join(REPO, "tpustack_torch", "models", "wan", f"{m}.py")
               for m in ("__init__", "config", "scheduler", "tokenizer", "umt5", "dit", "wanvae",
                         "weights", "pipeline")]
WAN_MODULES.append(os.path.join(REPO, "tpustack_torch", "serving", "graph_server.py"))


@pytest.mark.parametrize("path", WAN_MODULES, ids=os.path.basename)
def test_wan_modules_import_no_jax_or_tpustack(path):
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
            assert mod.split(".")[0] not in ("jax", "flax", "tpustack"), f"{path} imports {mod}"
