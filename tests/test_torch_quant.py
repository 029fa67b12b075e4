"""Weight-only int8 in the port (``tpustack_torch.ops.quant``) against the
JAX package's (``tpustack.ops.quant``), on the CPU.

- ``quantize_kernel``, ``quantize_rows`` and ``quantize_params`` give the
  JAX functions' int8 values and scales element for element, on float32 and
  bf16 inputs: both divide in float32 and round half to even.
- The tiny int8 ``LlamaModel`` (plain, tied embeddings, Qwen's q/k/v bias)
  loads a JAX int8 tree with ``load_state_dict(strict=True)`` and its
  float32 logits are within 1e-4 relative L2 of the JAX int8 model's (the
  same int8 values and float32 scales on both sides; only the float32
  summation order differs).
- The int8 umt5 encoder loads the JAX int8 tower and matches its output
  within 1e-4 relative L2, and stays within the JAX test's cosine bound of
  its float twin.
- ``Generator(quant="int8")``: from a JAX int8 tree its greedy ids equal the
  JAX generator's; drawn from a seed it is its float twin quantised layer by
  layer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustack.models.llama import LlamaConfig as JaxConfig
from tpustack.models.llm_generate import Generator as JaxGenerator
from tpustack.models.llm_generate import SampleConfig as JaxSample
from tpustack.models.wan.config import UMT5Config as JaxUMT5Config
from tpustack.models.wan.umt5 import UMT5Encoder as JaxUMT5
from tpustack.ops import quant as jq
from tpustack_torch.models.llama import LlamaConfig, LlamaModel, init_kv_pool
from tpustack_torch.models.llama_weights import load_params, params_from_jax
from tpustack_torch.models.llm_continuous import ContinuousEngine, SlotRequest
from tpustack_torch.models.llm_generate import Generator, SampleConfig
from tpustack_torch.models.wan.config import UMT5Config
from tpustack_torch.models.wan.umt5 import EMBED_KEYS, UMT5Encoder
from tpustack_torch.models.wan.weights import load_into, tower_from_jax
from tpustack_torch.ops import quant as pq
from tpustack_torch.serving import kv_pool

REL_L2 = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16(x: np.ndarray):
    """(the JAX bf16 array, the same values as a torch bf16 tensor)"""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kernel_and_rows_equal_jax(dtype):
    rng = np.random.RandomState(0)
    w = rng.randn(48, 40).astype(np.float32) * 0.3  # [in, out], the JAX layout
    w[:, 3] = 0.0  # a zero channel must not divide by zero
    if dtype == "bfloat16":
        jw, tw = _bf16(w)
    else:
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
    ref = jq.quantize_kernel(jw)
    q, s = pq.quantize_kernel(tw.t())  # torch Linear layout [out, in]
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.t().numpy(), np.asarray(ref["kernel"]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref["scale"]))
    assert (q[3] == 0).all() and s[3] == 1.0
    ref = jq.quantize_rows(jw)
    q, s = pq.quantize_rows(tw)
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref["embedding"]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref["scale"]))


def test_quantize_rounds_half_to_even_as_jax():
    """A channel whose absmax is 127 has scale 1.0 exactly, so its values
    land on .5 ties: both packages round them to the even neighbour."""
    col = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5], np.float32)
    ref = np.asarray(jq.quantize_kernel(jnp.asarray(col[:, None]))["kernel"])[:, 0]
    q, s = pq.quantize_kernel(torch.from_numpy(col[None, :]))
    assert float(s[0]) == 1.0
    np.testing.assert_array_equal(q[0].numpy(), ref)
    np.testing.assert_array_equal(q[0].numpy(), [127, 0, 2, 2, 0, -2, -2, 126])


def _jax_params(tie=False, bias=False, seed=0):
    cfg = dataclasses.replace(JaxConfig.tiny(max_seq=64), tie_embeddings=tie, qkv_bias=bias)
    return JaxGenerator(cfg, dtype=jnp.float32, seed=seed).params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_equals_jax_and_consumes(dtype):
    tree = jax.tree_util.tree_map(np.asarray, _jax_params(bias=True))
    if dtype == "bfloat16":
        tree = jax.tree_util.tree_map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), tree)
    # the JAX function consumes its (nested) input: hand it a copy
    ref = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jq.quantize_params(jax.tree_util.tree_map(lambda x: x, tree))))
    sd = {k: (v.to(torch.bfloat16) if dtype == "bfloat16" else v)
          for k, v in params_from_jax(tree).items()}
    got = pq.quantize_params(sd)
    assert not sd  # consumed key by key
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype or ref[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].float().numpy(), ref[k].float().numpy(), err_msg=k)
    assert got["layers.0.self_attn.q_proj.weight"].dtype == torch.int8
    assert got["embed_tokens.weight"].dtype == torch.int8
    assert "layers.0.self_attn.q_proj.bias" in got  # carried through


@pytest.mark.parametrize("tie,bias", [(False, False), (True, False), (False, True)],
                         ids=["plain", "tied", "qkv-bias"])
def test_int8_llama_logits_match_jax(tie, bias):
    jcfg = dataclasses.replace(JaxConfig.tiny(max_seq=64), quant="int8", tie_embeddings=tie,
                               qkv_bias=bias)
    jgen = JaxGenerator(jcfg, dtype=jnp.float32, seed=3)
    cfg = dataclasses.replace(LlamaConfig.tiny(max_seq=64), quant="int8", tie_embeddings=tie,
                              qkv_bias=bias)
    model = LlamaModel(cfg, torch.float32)
    sd = params_from_jax(jgen.params)
    assert sd["layers.1.mlp.down_proj.weight"].dtype == torch.int8
    load_params(model, sd)  # strict: every key of the int8 tree, nothing else
    assert isinstance(model.layers[0].mlp.up_proj, pq.Int8Dense)
    assert isinstance(model.embed_tokens, torch.nn.Embedding if tie else pq.Int8Embed)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    ref, _ = jgen.model.apply({"params": jgen.params}, jnp.asarray(tokens))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < REL_L2


def test_int8_dense_rounds_once_in_the_compute_dtype():
    """bf16 compute: the int8 weight widened exactly, the product and the
    float32 scale and bias applied before ONE rounding to the output dtype;
    the lm_head form keeps float32 logits."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(32, 16, bias=True)
    q, s = pq.quantize_kernel(lin.weight)
    d = pq.Int8Dense(32, 16, bias=True, dtype=torch.bfloat16)
    d.weight.copy_(q)
    d.scale.copy_(s)
    d.bias.copy_(lin.bias)
    x = torch.randn(3, 5, 32).to(torch.bfloat16)
    want = ((x.float() @ q.float().t()) * s + lin.bias.detach()).to(torch.bfloat16)
    got = d(x)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max() <= 2 ** -7 * want.float().abs().max()
    d.out_dtype = torch.float32
    assert d(x).dtype == torch.float32


def _umt5_pair():
    jcfg = JaxUMT5Config(vocab_size=512, dim=32, ffn_dim=64, num_heads=2, head_dim=16,
                         num_layers=2, max_length=16)
    cfg = UMT5Config(vocab_size=512, dim=32, ffn_dim=64, num_heads=2, head_dim=16,
                     num_layers=2, max_length=16)
    ids = np.random.RandomState(0).randint(0, 512, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), bool)
    mask[1, 11:] = False
    params = JaxUMT5(jcfg).init(jax.random.PRNGKey(1), jnp.asarray(ids))["params"]
    return jcfg, cfg, ids, mask, params


def test_int8_umt5_matches_jax():
    jcfg, cfg, ids, mask, params = _umt5_pair()
    float_ref = np.asarray(jax.jit(JaxUMT5(jcfg).apply)({"params": params}, ids, mask))
    qparams = jq.quantize_params(jax.tree_util.tree_map(np.asarray, params),
                                 names=jq.UMT5_QUANTIZABLE, embed_keys=frozenset({"embed"}))
    qjcfg = dataclasses.replace(jcfg, quant="int8")
    ref = np.asarray(jax.jit(JaxUMT5(qjcfg).apply)({"params": qparams}, ids, mask))
    enc = UMT5Encoder(dataclasses.replace(cfg, quant="int8"), torch.float32)
    sd = tower_from_jax(jax.tree_util.tree_map(np.asarray, qparams), "text_encoder")
    assert sd["shared.weight"].dtype == torch.int8 and "shared.scale" in sd
    load_into(enc, sd)
    with torch.no_grad():
        got = enc(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    assert _rel(got, ref) < REL_L2
    # the JAX test's bound against the float tower
    a, b = got.ravel(), float_ref.ravel()
    assert float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))) > 0.99


def test_quantize_module_matches_quantize_params_on_umt5():
    """The in-place swap (the random-weights path) and the state-dict
    function (the loading path) give the same int8 tower."""
    _, cfg, ids, mask, params = _umt5_pair()
    sd = tower_from_jax(jax.tree_util.tree_map(np.asarray, params), "text_encoder")
    enc = UMT5Encoder(cfg, torch.float32)
    load_into(enc, sd)
    pq.quantize_module_(enc, names=pq.UMT5_QUANTIZABLE, embed_keys=EMBED_KEYS)
    want = pq.quantize_params(dict(sd), names=pq.UMT5_QUANTIZABLE, embed_keys=EMBED_KEYS)
    got = enc.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


def _port_greedy(pgen, prompt, n):
    pool = kv_pool.KVBlockPool(17, 8)
    rt = kv_pool.PagedKVRuntime(init_kv_pool(pgen.cfg, 17, 8, torch.float32, "cpu"), pool,
                                pgen.cfg.max_seq)
    out = {}
    reqs = [SlotRequest(ids=list(prompt), max_new=n, sample=SampleConfig(greedy=True),
                        on_done=lambda t, s: out.__setitem__("t", t))]
    ContinuousEngine(pgen, rt, slots=2, chunk=4).run(lambda: reqs.pop(0) if reqs else None)
    assert pool.n_free == pool.capacity_blocks
    return out["t"]


def test_int8_generator_greedy_ids_equal_jax():
    jcfg = dataclasses.replace(JaxConfig.tiny(max_seq=64), quant="int8")
    jgen = JaxGenerator(jcfg, dtype=jnp.float32, seed=3)
    cfg = dataclasses.replace(LlamaConfig.tiny(max_seq=64), quant="int8")
    pgen = Generator(cfg, params=params_from_jax(jgen.params), dtype=torch.float32,
                     device="cpu")
    prompt = [5, 6, 7, 8, 9]
    ref = jgen.generate_fused(prompt, max_new_tokens=12, sample=JaxSample(greedy=True),
                              stop_tokens=(), chunk=4)[0]
    assert _port_greedy(pgen, prompt, 12) == list(ref)


def test_int8_generator_from_seed_is_the_quantised_float_twin():
    cfg = LlamaConfig.tiny(max_seq=64)
    twin = Generator(cfg, dtype=torch.float32, seed=0, device="cpu")
    want = pq.quantize_params(dict(twin.model.state_dict()))
    gen = Generator(dataclasses.replace(cfg, quant="int8"), dtype=torch.float32, seed=0,
                    device="cpu")
    got = gen.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    assert gen.model.cfg.quant == "int8"
    assert gen.weight_bytes < 0.5 * twin.weight_bytes


def test_wan_pipeline_int8_text_tower_is_its_float_twin_quantised():
    """Random weights: the int8 umt5 tower is drawn as its float twin from
    the seed and quantised, and the other towers draw the same numbers."""
    from tpustack_torch.models.wan import WanConfig, WanPipeline

    cfg = WanConfig.tiny()
    twin = WanPipeline(cfg, device="cpu", seed=0)
    pipe = WanPipeline(dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, quant="int8")),
                       device="cpu", seed=0)
    want = pq.quantize_params(dict(twin.text_encoder.state_dict()), names=pq.UMT5_QUANTIZABLE,
                              embed_keys=EMBED_KEYS)
    got = pipe.text_encoder.state_dict()
    assert set(got) == set(want) and got["shared.weight"].dtype == torch.int8
    for k in want:
        np.testing.assert_array_equal(got[k].float().numpy(), want[k].float().numpy(),
                                      err_msg=k)
    for k, v in twin.dit.state_dict().items():
        assert torch.equal(pipe.dit.state_dict()[k], v), k
