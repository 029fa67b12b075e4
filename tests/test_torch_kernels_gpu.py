"""The port's CUDA kernels against their plain twins, on the card.

Marked ``gpu``: each test skips without a CUDA device (a CUDA kernel has no
CPU mode).  This file imports only ``torch`` and the port, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerance, as in ``chip_smoke.py``: 4e-3 absolute and 1e-2 relative per
element, and 1e-2 relative L2 per case.  Both sides round the output to bf16
(one ulp is at most 2^-7 relative) and the kernel also rounds the softmax
probabilities to bf16 before P.V; a typical output of N(0,1) inputs over 4096
keys is ~0.03, and the L2 limit catches faults spread thin over every row (a
dropped K tile, a wrong rescale) that an element-wise limit would not.

The paged kernel is held to its twin at the limits of ``chip_smoke.py``
phase 3 (``PAGED_TOL`` there, restated here): the row max ``m`` within 1e-3
absolute (logits of order 1-5; only float32 summation order differs), the
denominator ``l`` within 1e-3 relative (float32 sums of exponentials in
another order), the unnormalised ``acc`` within 1e-2 relative L2, and the
normalised output ``acc / l`` within 4e-3 absolute + 1e-2 relative per
element and 1e-2 relative L2.  Both sides round p to bf16 before P.V, but
the kernel rounds it against the running max of its tile (then rescales),
the twin against the row's final max, so single elements differ by about a
bf16 ulp; the L2 limits catch a dropped key tile or a wrong rescale.
"""

import pytest
import torch

from tpustack_torch.ops.flash_attention import flash_attention, flash_attention_ref
from tpustack_torch.ops.paged_attention import (paged_attention_partial,
                                                paged_attention_partial_ref)

CASES = [
    ((2, 4096, 8, 40), (2, 4096, 8, 40), {}),
    ((2, 1024, 8, 80), (2, 1024, 8, 80), {}),
    ((1, 512, 8, 64), (1, 2048, 2, 64), dict(causal=True, q_offset=1024, kv_len=1536)),
    ((1, 77, 2, 40), (1, 300, 2, 40), {}),
    ((2, 130, 4, 128), (2, 130, 4, 128), dict(causal=True)),
    ((1, 64, 2, 16), (1, 64, 2, 16), dict(kv_len=0)),
    ((1, 100, 3, 8), (1, 100, 1, 8), dict(causal=True)),   # D below the MMA width, MQA
    ((1, 70, 2, 104), (1, 33, 2, 104), {}),                # odd lengths, D padded to 112
    # the edges of the Hopper tiling: 128 q rows per CTA (two warpgroups of
    # 64), 128-key K/V tiles, 64-wide TMA boxes along D
    ((1, 33, 4, 64), (1, 33, 4, 64), {}),                  # Sq below one warpgroup's 64
    ((2, 130, 4, 40), (2, 200, 4, 40), {}),                # Sq, Sk not tile multiples
    ((1, 200, 4, 80), (1, 200, 4, 80), dict(causal=True)),
    ((1, 256, 4, 64), (1, 512, 4, 64), dict(kv_len=300)),  # kv_len inside a K/V tile
    ((1, 256, 4, 64), (1, 512, 2, 64),                     # diagonal crosses q tiles
     dict(causal=True, q_offset=37, kv_len=293)),
    ((1, 300, 28, 128), (1, 300, 4, 128), dict(causal=True)),  # GQA 28/4 (Qwen2.5-7B)
    # the LLM path's two flash shapes at Qwen2.5-7B width: from-zero prefill of
    # the 2048 bucket, and a 1024-row suffix after a 256-token prefix hit
    ((1, 2048, 28, 128), (1, 2048, 4, 128), dict(causal=True)),
    ((1, 1024, 28, 128), (1, 4096, 4, 128), dict(causal=True, q_offset=256, kv_len=1280)),
    # the Wan DiT's two flash shapes at the default request (512x320, 13
    # frames: 2560 tokens, 12 heads of 128, MHA, non-causal): self-attention
    # and the text cross-attention over 512 keys, at CFG batch 2 and at the
    # batched pair's 4
    ((2, 2560, 12, 128), (2, 2560, 12, 128), {}),
    ((2, 2560, 12, 128), (2, 512, 12, 128), {}),
    ((4, 2560, 12, 128), (4, 2560, 12, 128), {}),
    ((4, 2560, 12, 128), (4, 512, 12, 128), {}),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("qs,ks,kw", CASES)
def test_flash_kernel_matches_twin(cuda, qs, ks, kw):
    g = torch.Generator(cuda).manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device=cuda).bfloat16() for s in (qs, ks, ks))
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    ref = flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=4e-3, rtol=1e-2)
    rel = (out.float() - ref.float()).norm() / ref.float().norm().clamp_min(1e-30)
    assert rel < 1e-2, rel


@pytest.mark.gpu
@pytest.mark.parametrize("d", range(8, 129, 8))
def test_flash_kernel_every_head_dim(cuda, d):
    """Every D the contract allows: one or two 64-wide boxes, P.V at N = D."""
    g = torch.Generator(cuda).manual_seed(d)
    q, k, v = (torch.randn(s, generator=g, device=cuda).bfloat16()
               for s in ((1, 150, 2, d), (1, 140, 1, d), (1, 140, 1, d)))
    out = flash_attention(q, k, v, causal=True, q_offset=10)
    ref = flash_attention_ref(q, k, v, causal=True, q_offset=10)
    torch.testing.assert_close(out.float(), ref.float(), atol=4e-3, rtol=1e-2)
    rel = (out.float() - ref.float()).norm() / ref.float().norm()
    assert rel < 1e-2, rel


@pytest.mark.gpu
def test_flash_kernel_rows_without_keys_are_exact_zeros(cuda):
    g = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn(s, generator=g, device=cuda).bfloat16()
               for s in ((1, 160, 4, 40), (1, 160, 2, 40), (1, 160, 2, 40)))
    assert torch.equal(flash_attention(q, k, v, kv_len=0), torch.zeros_like(q))
    # causal rows at negative positions see no key; the others match the twin
    out = flash_attention(q, k, v, causal=True, q_offset=-70)
    assert torch.equal(out[:, :70], torch.zeros_like(out[:, :70]))
    ref = flash_attention_ref(q, k, v, causal=True, q_offset=-70)
    torch.testing.assert_close(out.float(), ref.float(), atol=4e-3, rtol=1e-2)


@pytest.mark.gpu
def test_unet_attention_above_the_kernels_head_dim_takes_the_plain_path(cuda):
    """SD1.5 at 1024x1024: the level-2 self-attention ``[2, 1024, 8, 160]``
    (CFG batch 2) through the UNet's attention block with ``impl="auto"``
    launches no kernel, raises nothing and equals the plain path."""
    from tpustack_torch.models.sd15.unet import CrossAttention

    torch.manual_seed(0)
    attn = CrossAttention(1280, 8).to(cuda, torch.bfloat16)
    x = torch.randn(2, 1024, 1280, device=cuda, dtype=torch.bfloat16)
    before = flash_attention.launches
    with torch.inference_mode():
        attn.impl = "auto"
        out = attn(x)
        attn.impl = "xla"
        ref = attn(x)
    torch.cuda.synchronize()
    assert flash_attention.launches == before
    assert out.shape == (2, 1024, 1280) and torch.equal(out, ref)


@pytest.mark.gpu
def test_flash_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(1, 64, 2, 40, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 64, 2, 36, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 2, 64, 40, device=cuda, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, q)


# ----------------------------------------------------------------- paged
PAGED_CASES = [  # (label, B, S, H, Hkv, D, N pool blocks, blk, ctx, int8)
    ("decode", 8, 1, 28, 4, 128, 513, 64, 4096, False),
    ("verify", 8, 5, 28, 4, 128, 513, 64, 4096, False),
    ("int8", 8, 5, 28, 4, 128, 513, 64, 4096, True),
    ("mqa", 4, 1, 8, 1, 128, 129, 64, 2048, False),
    ("mha", 4, 2, 8, 8, 128, 129, 64, 2048, False),
    ("blk16", 8, 5, 28, 4, 128, 2049, 16, 4096, False),
    ("d64", 3, 3, 8, 2, 64, 97, 32, 1024, True),
]
# the edges of the kernel's work split (units of one (row, kv head, 64-key
# tile) spread evenly over one CTA per SM): (label, case, lengths)
PAGED_EDGE_CASES = [
    ("all empty", (8, 1, 28, 4, 128, 513, 64, 4096, False), [0] * 8),
    ("one full, seven empty", (8, 1, 28, 4, 128, 513, 64, 4096, False), [4096] + [0] * 7),
    ("tile multiples", (8, 5, 28, 4, 128, 513, 64, 4096, False),
     [64, 128, 640, 1024, 4096, 192, 256, 0]),
    ("block multiples blk 32", (6, 5, 28, 4, 128, 513, 32, 2048, False),
     [32, 96, 160, 2048, 1056, 0]),
    ("b1 hkv1", (1, 1, 8, 1, 128, 65, 64, 4096, False), [4095]),
    ("blk 32 verify", (8, 5, 28, 4, 128, 1025, 32, 4096, False), None),
    ("int8 one full", (8, 5, 28, 4, 128, 513, 64, 4096, True), [4096] + [0] * 7),
]


def paged_inputs(dev, b, s, h, hkv, d, n_pool, blk, ctx, int8, seed=0, lens=None):
    """A scrambled pool with block 0 poisoned (1e4, or 127 in int8),
    ragged lengths up to ``ctx`` (row 0 full, row 1 empty, one mid-block;
    or ``lens``), and idle table entries at block 0."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    shape = (n_pool, blk, hkv, d)
    if int8:
        pk = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        pv = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        pk[0] = 127
        pv[0] = 127
        ks = torch.rand(shape[:3], generator=g) * 0.02 + 1e-3
        vs = torch.rand(shape[:3], generator=g) * 0.02 + 1e-3
    else:
        pk = torch.randn(shape, generator=g).bfloat16()
        pv = torch.randn(shape, generator=g).bfloat16()
        pk[0] = 1e4
        pv[0] = 1e4
        ks = vs = None
    nb = ctx // blk
    lens_given = lens
    lens = torch.randint(1, ctx + 1, (b,), generator=g, dtype=torch.int32)
    lens[0] = ctx
    if b > 1:
        lens[1] = 0
    if b > 2:
        lens[2] = blk + 3
    if lens_given is not None:
        lens = torch.tensor(lens_given, dtype=torch.int32)
    assert sum(-(-int(n) // blk) for n in lens) <= n_pool - 1
    perm = torch.randperm(n_pool - 1, generator=g) + 1
    bt = torch.zeros((b, nb), dtype=torch.int32)
    pos = 0
    for i in range(b):
        n = -(-int(lens[i]) // blk)
        bt[i, :n] = perm[pos:pos + n].int()
        pos += n
    q = torch.randn((b, s, h, d), generator=g).bfloat16()
    to = lambda t: None if t is None else t.to(dev)  # noqa: E731
    return to(q), to(pk), to(pv), to(bt), to(lens), to(ks), to(vs)


def paged_compare(got, ref):
    """Max |err| of the normalised output; asserts every stated limit."""
    (a, m, l), (ra, rm, rl) = got, ref
    ok = rl > 0
    assert torch.equal(l == 0, rl == 0)
    assert (m[~ok] <= -1e29).all() and (a[~ok] == 0).all()
    if ok.any():  # every row without keys was checked exactly above
        assert (m[ok] - rm[ok]).abs().max() <= 1e-3
    torch.testing.assert_close(l, rl, rtol=1e-3, atol=1e-6)
    assert (a - ra).norm() <= 1e-2 * ra.norm()
    out = a / l.clamp_min(1e-30)[..., None]
    rout = ra / rl.clamp_min(1e-30)[..., None]
    torch.testing.assert_close(out, rout, atol=4e-3, rtol=1e-2)
    assert (out - rout).norm() <= 1e-2 * rout.norm()
    return (out - rout).abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("case", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_paged_kernel_matches_twin(cuda, case):
    q, pk, pv, bt, lens, ks, vs = paged_inputs(cuda, *case[1:])
    before = paged_attention_partial.launches
    got = paged_attention_partial(q, pk, pv, bt, lens, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert paged_attention_partial.launches == before + 1
    ref = paged_attention_partial_ref(q, pk, pv, bt, lens, k_scale=ks, v_scale=vs)
    paged_compare(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("label,case,lens", PAGED_EDGE_CASES,
                         ids=[c[0] for c in PAGED_EDGE_CASES])
def test_paged_kernel_split_edges(cuda, label, case, lens):
    q, pk, pv, bt, ln, ks, vs = paged_inputs(cuda, *case, lens=lens)
    got = paged_attention_partial(q, pk, pv, bt, ln, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    paged_compare(got, paged_attention_partial_ref(q, pk, pv, bt, ln, k_scale=ks, v_scale=vs))


@pytest.mark.gpu
@pytest.mark.parametrize("lens", [None, [4096] + [0] * 7], ids=["ragged", "one full"])
def test_paged_kernel_is_bitwise_repeatable(cuda, lens):
    """Split pairs merge in key order and every launch leaves the pair
    counters at zero, so a second call gives the same bits."""
    q, pk, pv, bt, ln, _, _ = paged_inputs(cuda, 8, 5, 28, 4, 128, 513, 64, 4096, False,
                                           lens=lens)
    first = paged_attention_partial(q, pk, pv, bt, ln)
    # NaN in the allocator's free blocks, so an output the second call
    # failed to write cannot pass on the bytes an earlier one left
    poison = [torch.full_like(t, float("nan")) for t in first for _ in range(4)]
    del poison
    second = paged_attention_partial(q, pk, pv, bt, ln)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    paged_compare(second, paged_attention_partial_ref(q, pk, pv, bt, ln))


@pytest.mark.gpu
def test_paged_kernel_in_a_cuda_graph_follows_lengths_and_tables(cuda):
    """Nothing about the lengths is decided on the host: a captured call,
    replayed after ``lengths`` and ``block_tables`` changed in place,
    matches the twin on the new ones."""
    case = (8, 5, 28, 4, 128, 513, 64, 4096, False)
    q, pk, pv, bt, ln, _, _ = paged_inputs(cuda, *case)
    paged_attention_partial(q, pk, pv, bt, ln)  # build, counters, tensor maps
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attention_partial(q, pk, pv, bt, ln)
    _, _, _, bt2, ln2, _, _ = paged_inputs(cuda, *case, seed=1,
                                           lens=[0, 4096, 1000, 3, 64, 65, 2000, 130])
    bt.copy_(bt2)
    ln.copy_(ln2)
    graph.replay()
    torch.cuda.synchronize()
    paged_compare(out, paged_attention_partial_ref(q, pk, pv, bt, ln))
    graph.replay()
    torch.cuda.synchronize()
    paged_compare(out, paged_attention_partial_ref(q, pk, pv, bt, ln))


@pytest.mark.gpu
def test_paged_kernel_rejects_what_it_cannot_take(cuda):
    q, pk, pv, bt, lens, _, _ = paged_inputs(cuda, 2, 1, 4, 2, 128, 9, 64, 256, False)
    with pytest.raises(ValueError, match="bf16"):
        paged_attention_partial(q.float(), pk, pv, bt, lens)
    with pytest.raises(ValueError, match="int32"):
        paged_attention_partial(q, pk, pv, bt.long(), lens)
    with pytest.raises(ValueError, match="multiple of 16"):
        paged_attention_partial(q[..., :40].contiguous(), pk[..., :40].contiguous(),
                                pv[..., :40].contiguous(), bt, lens)
    with pytest.raises(ValueError, match="query"):
        paged_attention_partial(torch.zeros(2, 40, 4, 128, device=cuda, dtype=torch.bfloat16),
                                pk, pv, bt, lens)
