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
"""

import pytest
import torch

from tpustack_torch.ops.flash_attention import flash_attention, flash_attention_ref

CASES = [
    ((2, 4096, 8, 40), (2, 4096, 8, 40), {}),
    ((2, 1024, 8, 80), (2, 1024, 8, 80), {}),
    ((1, 512, 8, 64), (1, 2048, 2, 64), dict(causal=True, q_offset=1024, kv_len=1536)),
    ((1, 77, 2, 40), (1, 300, 2, 40), {}),
    ((2, 130, 4, 128), (2, 130, 4, 128), dict(causal=True)),
    ((1, 64, 2, 16), (1, 64, 2, 16), dict(kv_len=0)),
    ((1, 100, 3, 8), (1, 100, 1, 8), dict(causal=True)),   # D below the MMA width, MQA
    ((1, 70, 2, 104), (1, 33, 2, 104), {}),                # odd lengths, D padded to 112
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
