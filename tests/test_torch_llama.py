"""The port's Llama model against the JAX package, on the CPU.

The same flax parameters (``Generator(LlamaConfig.tiny(max_seq=64))`` from a
seed, carried to the port by ``params_from_jax``) and the same numpy inputs
go through the JAX ``LlamaModel.apply`` and the port's ``LlamaModel``, in
float32, in every attention branch the paged engine runs: the from-zero
prefill, the masked suffix prefill, the streaming (flash ``q_offset``)
prefill, and the chunk-buffer decode step through both pool views (the
gathered dense view with the plain partial, and the in-place view the paged
kernel reads), each with the float cache and with the int8 KV cache.

Tolerance 1e-4 (relative and absolute) on logits of order 1: float32 on both
sides, differing in summation order through two layers (XLA against ATen
kernels, Pallas interpret against the plain twins).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustack.models.llama import LlamaConfig as JaxConfig
from tpustack.models.llama import init_kv_caches as jax_init_caches
from tpustack.models.llm_generate import Generator as JaxGenerator
from tpustack_torch.models.llama import LlamaConfig, LlamaModel, init_kv_caches, rope
from tpustack_torch.models.llama_weights import (init_random_, jax_path_to_key, load_params,
                                                 params_from_jax)

TOL = dict(rtol=1e-4, atol=1e-4)
B, P, SUFFIX, BLK = 2, 16, 8, 8


@pytest.fixture(scope="module", params=[None, "int8"], ids=["float-kv", "int8-kv"])
def models(request):
    jcfg = dataclasses.replace(JaxConfig.tiny(max_seq=64), kv_quant=request.param)
    jgen = JaxGenerator(jcfg, dtype=jnp.float32, seed=3)
    cfg = dataclasses.replace(LlamaConfig.tiny(max_seq=64), kv_quant=request.param)
    model = LlamaModel(cfg, torch.float32)
    load_params(model, params_from_jax(jgen.params))
    return jgen, model.eval(), cfg


def _jax_apply(jgen, *args):
    return jgen.model.apply({"params": jgen.params}, *args)


def _prefill(models, seed=0):
    """From-zero prefill of ``B`` rows of ``P`` tokens (ragged lengths) on
    both sides; returns both caches, the tokens and the lengths."""
    jgen, model, cfg = models
    rng = np.random.RandomState(seed)
    tokens = rng.randint(3, cfg.vocab_size, (B, P)).astype(np.int32)
    lengths = np.array([P, P - 5], np.int32)
    pos = np.broadcast_to(np.arange(P), (B, P)).astype(np.int32)
    jl, jc = _jax_apply(jgen, jnp.asarray(tokens), jnp.asarray(pos),
                        jax_init_caches(jgen.cfg, B, jnp.float32), 0, None,
                        jnp.asarray(lengths - 1))
    pc = init_kv_caches(cfg, B, torch.float32, "cpu")
    with torch.no_grad():
        pl = model(torch.from_numpy(tokens).long(), torch.from_numpy(pos).long(), pc, 0, None,
                   torch.from_numpy(lengths - 1))
    return (np.asarray(jl), jc), (pl.numpy(), pc), tokens, lengths


def test_from_zero_prefill(models):
    (jl, jc), (pl, pc), _, _ = _prefill(models)
    np.testing.assert_allclose(pl, jl, **TOL)
    for jlayer, player in zip(jc, pc):
        for k in jlayer:  # the cache rows prefill wrote
            np.testing.assert_allclose(player[k][:, :P].float().numpy(),
                                       np.asarray(jlayer[k][:, :P]).astype(np.float32),
                                       **TOL)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "streaming"])
def test_suffix_prefill(models, masked):
    """A suffix at ``base = P`` over the prefilled prefix: the explicit-mask
    plain path, or the streaming flash path (``q_offset``/``kv_len``)."""
    jgen, model, cfg = models
    (_, jc), (_, pc), _, _ = _prefill(models)
    rng = np.random.RandomState(1)
    tokens = rng.randint(3, cfg.vocab_size, (B, SUFFIX)).astype(np.int32)
    pos = (P + np.broadcast_to(np.arange(SUFFIX), (B, SUFFIX))).astype(np.int32)
    last = np.array([SUFFIX - 1, SUFFIX - 3], np.int32)
    mask = (np.arange(cfg.max_seq)[None, None, None, :] <= pos[:, None, :, None]
            if masked else None)
    jl, _ = _jax_apply(jgen, jnp.asarray(tokens), jnp.asarray(pos), jc, P,
                       None if mask is None else jnp.asarray(mask), jnp.asarray(last))
    with torch.no_grad():
        pl = model(torch.from_numpy(tokens).long(), torch.from_numpy(pos).long(), pc, P,
                   None if mask is None else torch.from_numpy(mask),
                   torch.from_numpy(last))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)


def _pool_from(caches, lengths, max_seq, rng, torch_side):
    """Scatter dense prefill rows into a scrambled pool ``[N, BLK, ...]``
    (block 0 poisoned) and return ``(pool layers, block table)``."""
    nb = max_seq // BLK
    n_pool = B * nb + 1
    bt = np.zeros((B, nb), np.int32)
    perm = rng.permutation(np.arange(1, n_pool))
    for i in range(B):
        bt[i] = perm[i * nb:(i + 1) * nb]
    pool = []
    for layer in caches:
        out = {}
        for k, v in layer.items():
            v = v.numpy() if torch_side else np.asarray(v)
            arr = np.zeros((n_pool, BLK) + v.shape[2:], v.dtype)
            arr[0] = 100 if v.dtype == np.int8 else 1e4
            for i in range(B):
                for j in range(nb):
                    arr[bt[i, j]] = v[i, j * BLK:(j + 1) * BLK]
            out[k] = arr
        pool.append(out)
    return pool, bt


@pytest.mark.parametrize("view", ["paged", "gather"])
def test_chunk_buffer_decode_steps(models, view):
    """Two chunk-buffer decode steps (t = 0, 1) over a frozen pool, through
    the in-place view (``pk``/``pv``/``bt``, the paged kernel's operands)
    or the gathered dense view (``k``/``v``, the plain partial)."""
    jgen, model, cfg = models
    (_, jc), (_, pc), _, lengths = _prefill(models)
    pool, bt = _pool_from(pc, lengths, cfg.max_seq, np.random.RandomState(2), True)
    rng = np.random.RandomState(3)
    steps = rng.randint(3, cfg.vocab_size, (2, B, 1)).astype(np.int32)
    cur0 = lengths.astype(np.int32)
    nb = bt.shape[1]

    def jax_view(layer):
        if view == "paged":
            v = {"pk": jnp.asarray(layer["k"]), "pv": jnp.asarray(layer["v"]),
                 "bt": jnp.asarray(bt)}
            if "k_scale" in layer:
                v.update(pk_scale=jnp.asarray(layer["k_scale"]),
                         pv_scale=jnp.asarray(layer["v_scale"]))
            return v
        return {k: jnp.asarray(a[bt.reshape(-1)].reshape((B, nb * BLK) + a.shape[2:]))
                for k, a in layer.items()}

    def port_view(layer):
        t = {k: torch.from_numpy(a) for k, a in layer.items()}
        if view == "paged":
            v = {"pk": t["k"], "pv": t["v"], "bt": torch.from_numpy(bt),
                 "lens": torch.from_numpy(cur0)}
            if "k_scale" in t:
                v.update(pk_scale=t["k_scale"], pv_scale=t["v_scale"])
            return v
        return {k: a[torch.from_numpy(bt).reshape(-1).long()].reshape(
            (B, nb * BLK) + tuple(a.shape[2:])) for k, a in t.items()}

    def bufs(zeros, quant):
        shape = (B, 2, cfg.n_kv_heads, cfg.head_dim)
        if quant:
            return {"ck": zeros(shape, "int8"), "cv": zeros(shape, "int8"),
                    "ck_scale": zeros(shape[:3], "float32"),
                    "cv_scale": zeros(shape[:3], "float32")}
        return {"ck": zeros(shape, "float32"), "cv": zeros(shape, "float32")}

    quant = cfg.kv_quant == "int8"
    jcaches = [dict(jax_view(layer), **bufs(lambda s, d: jnp.zeros(s, d), quant))
               for layer in pool]
    pcaches = [dict(port_view(layer), **bufs(
        lambda s, d: torch.zeros(s, dtype=getattr(torch, d)), quant)) for layer in pool]
    for t in range(2):
        pos = (cur0 + t)[:, None]
        jl, jcaches = _jax_apply(jgen, jnp.asarray(steps[t]), jnp.asarray(pos), jcaches,
                                 (jnp.asarray(cur0), t), None)
        with torch.no_grad():
            pl = model(torch.from_numpy(steps[t]).long(), torch.from_numpy(pos).long(),
                       pcaches, (torch.from_numpy(cur0).long(), t), None)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)


def test_rope_and_weight_names_match_jax():
    from tpustack.models.llama import rope as jax_rope

    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    pos = rng.randint(0, 4000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)), rtol=1e-5, atol=1e-5)
    assert jax_path_to_key(("layers_3", "self_attn", "q_proj", "kernel")) == \
        "layers.3.self_attn.q_proj.weight"
    assert jax_path_to_key(("norm", "scale")) == "norm.scale"
    assert jax_path_to_key(("embed_tokens", "embedding")) == "embed_tokens.weight"


def test_random_init_draws_the_flax_distributions():
    """Seeded init: the same seed gives the same weights; kernels are
    truncated normals at the lecun std, biases zero, norms one."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), qkv_bias=True)
    with torch.device("meta"):
        a, b = LlamaModel(cfg, torch.float32), LlamaModel(cfg, torch.float32)
    a, b = (init_random_(m.to_empty(device="cpu"), seed=5) for m in (a, b))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    w = a.layers[0].mlp.gate_proj.weight
    std = (1 / cfg.dim) ** 0.5
    assert w.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(w.std().item() - std) < 0.1 * std
    assert torch.all(a.layers[0].self_attn.q_proj.bias == 0)
    assert torch.all(a.norm.scale == 1)
    assert abs(a.embed_tokens.weight.std().item() - (1 / cfg.vocab_size) ** 0.5) < 2e-3
