"""Paged decode attention: the hand-written Hopper kernel and its plain twin.

Counterpart of ``paged_attention_partial``, ``paged_flash_attention`` and
``paged_bytes_accounting`` in ``tpustack/ops/pallas/flash_attention.py``.  The
KV pool (``[N, blk, Hkv, D]`` per layer) is read in place through per-row
block tables; the result is the unnormalised online-softmax partial of
:func:`~tpustack_torch.ops.attention.dot_product_attention_partial`, so the
continuous decode step merges it with its chunk-buffer partial unchanged.

:func:`paged_attention_partial` launches ``csrc/paged_attention.cu`` for
CUDA tensors and raises when it cannot; it never falls back.  For CPU tensors
it runs :func:`paged_attention_partial_ref`, the plain PyTorch version (a
gather of the table-mapped blocks into a dense view, then the plain partial),
which the tests hold against the JAX package and ``chip_smoke.py`` holds the
kernel against on the card.  :func:`work_partition` is the kernel's split of
the work over its persistent grid, in plain Python, for the CPU tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tpustack_torch.ops.attention import dot_product_attention_partial

KERNEL = "paged_attention"
TILE = 64             # key positions per kernel tile: one unit of work
MAX_ROWS = 64         # S * H / Hkv query rows: one wgmma tile per (b, kv head)
MAX_BATCH = 1024      # batch rows one launch takes (the kernel's shared prefix sums)
MAX_PAIRS = 1 << 16   # (b, kv head) pairs the counter buffer holds


def contract_violation(*, blk: int, rows: int, head_dim: int, q_dtype: torch.dtype,
                       batch: int = 1, kv_heads: int = 1) -> Optional[str]:
    """What the CUDA kernel needs that this geometry lacks, or None when it
    takes it: bf16 ``q``, ``head_dim`` a multiple of 16 up to 128, ``blk`` a
    multiple of 16, ``rows = S * H / Hkv <= MAX_ROWS`` query rows per kv
    head, at most ``MAX_BATCH`` rows and ``MAX_PAIRS`` (row, kv head)
    pairs.  The wrapper raises with it; the LLM server checks its engine's
    geometry with it at startup (``llm_generate.resolve_paged_flash``)."""
    if q_dtype != torch.bfloat16:
        return f"bf16 q and pools (got {q_dtype})"
    if head_dim % 16 or head_dim > 128:
        return f"D <= 128, a multiple of 16 (got {head_dim})"
    if blk % 16:
        return f"blk a multiple of 16 (got {blk})"
    if rows > MAX_ROWS:
        return f"S*H/Hkv <= {MAX_ROWS} query rows per kv head (got {rows})"
    if batch > MAX_BATCH or batch * kv_heads > MAX_PAIRS:
        return (f"at most {MAX_BATCH} rows and {MAX_PAIRS} (row, kv head) pairs "
                f"(got {batch} x {kv_heads})")
    return None


def _check(q, pool_k, pool_v, block_tables, lengths, k_scale, v_scale):
    if q.dim() != 4 or pool_k.dim() != 4:
        raise ValueError("q must be [B, S, H, D] and the pools [N, blk, Hkv, D]")
    b, _, h, d = q.shape
    if pool_k.shape != pool_v.shape:
        raise ValueError(f"pool shapes differ: {tuple(pool_k.shape)} vs {tuple(pool_v.shape)}")
    if pool_k.shape[3] != d:
        raise ValueError(f"q head_dim {d} != pool head_dim {pool_k.shape[3]}")
    if h % pool_k.shape[2]:
        raise ValueError(f"q heads {h} not a multiple of kv heads {pool_k.shape[2]}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {b}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if k_scale is not None and (tuple(k_scale.shape) != tuple(pool_k.shape[:3])
                                or tuple(v_scale.shape) != tuple(pool_k.shape[:3])):
        raise ValueError(f"scales must be {tuple(pool_k.shape[:3])}")


def gather_pool(x: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Pool tensor ``[N, blk, *tail]`` -> dense per-row view ``[B, nb*blk,
    *tail]`` through ``block_tables [B, nb]`` (a copy)."""
    b, nb = block_tables.shape
    g = x.index_select(0, block_tables.reshape(-1).long())
    return g.reshape((b, nb * x.shape[1]) + tuple(x.shape[2:]))


def paged_attention_partial_ref(q, pool_k, pool_v, block_tables, lengths, *,
                                scale: Optional[float] = None,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None):
    """Plain PyTorch version of :func:`paged_attention_partial`: gather the
    table-mapped blocks into a dense view and take the plain partial with
    the mask ``position < lengths[b]``.  Idle entries (block 0 included) are
    gathered but masked, so they contribute exactly zero."""
    _check(q, pool_k, pool_v, block_tables, lengths, k_scale, v_scale)
    s = q.shape[1]
    k = gather_pool(pool_k, block_tables)
    v = gather_pool(pool_v, block_tables)
    ks = gather_pool(k_scale, block_tables) if k_scale is not None else None
    vs = gather_pool(v_scale, block_tables) if v_scale is not None else None
    cols = torch.arange(k.shape[1], device=q.device)
    mask = (cols[None, :] < lengths.to(q.device)[:, None].long())[:, None, :]
    mask = mask.expand(q.shape[0], s, k.shape[1])
    return dot_product_attention_partial(q, k, v, mask=mask, scale=scale, k_scale=ks,
                                         v_scale=vs)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built kernel's C entry, with its ctypes signature (built once)."""
    from tpustack_torch.ops import _build

    fn = _build.load(KERNEL).tpst_paged_attention
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                                  ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _grid(index: int) -> int:
    """The kernel's persistent grid on device ``index``: one CTA per SM."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _pair_counters(index: int) -> torch.Tensor:
    """One zeroed int32 buffer per device, allocated at the first call (make
    that call before any CUDA-graph capture): the kernel counts the pieces
    of each split (b, kv head) pair in it and leaves it zeroed, so launches
    that share it must run one after another (one stream)."""
    return torch.zeros(MAX_PAIRS, device=torch.device("cuda", index), dtype=torch.int32)


def work_partition(lengths, hkv: int, nb: int, blk: int, grid: int) -> dict:
    """The kernel's split of the work, in plain Python (the CPU tests hold
    its properties; the kernel computes the same on the device).

    A unit is one (row b, kv head, 64-key tile) with tile <
    ``ceil(min(lengths[b], nb*blk) / 64)``, ordered (b, kv head, tile); pair
    ``b * hkv + kvh`` holds a contiguous run of them.  CTA ``c`` of ``grid``
    takes units ``[c*q + min(c, r), (c+1)*q + min(c+1, r))``, ``q, r =
    divmod(U, grid)``.  Returns ``units`` (U), ``ranges`` (per CTA),
    ``segments`` (per CTA: ``(pair, t0, t1, slot)`` tiles of one pair, slot
    None when the CTA holds the whole pair, else its workspace slot ``2c``
    or ``2c + 1``), ``pieces`` (per split pair: ``[(cta, slot, t0, t1)]`` in
    key order) and ``empty`` (per pair with no keys: the CTA that writes its
    empty partial)."""
    tiles = [-(-min(max(int(n), 0), nb * blk) // TILE) for n in lengths]
    pre = [0]
    for n in tiles:
        pre.append(pre[-1] + hkv * n)
    units = pre[-1]
    q, r = divmod(units, grid)
    start = [c * q + min(c, r) for c in range(grid + 1)]
    segments, pieces = [[] for _ in range(grid)], {}
    for c in range(grid):
        u = start[c]
        while u < start[c + 1]:
            b = max(i for i in range(len(tiles)) if pre[i] <= u and tiles[i])
            kvh = (u - pre[b]) // tiles[b]
            s_p = pre[b] + kvh * tiles[b]
            e_p = s_p + tiles[b]
            end = min(start[c + 1], e_p)
            whole = u == s_p and e_p <= start[c + 1]
            slot = None if whole else 2 * c + (1 if s_p > start[c] else 0)
            pair = b * hkv + kvh
            segments[c].append((pair, u - s_p, end - s_p, slot))
            if not whole:
                pieces.setdefault(pair, []).append((c, slot, u - s_p, end - s_p))
            u = end
    empty = {b * hkv + k: (b * hkv + k) % grid for b, n in enumerate(tiles) if n == 0
             for k in range(hkv)}
    return dict(units=units, ranges=list(zip(start[:-1], start[1:])), segments=segments,
                pieces=pieces, empty=empty)


def paged_attention_partial(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                            block_tables: torch.Tensor, lengths: torch.Tensor, *,
                            scale: Optional[float] = None,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None):
    """In-place paged attention over keys ``[0, lengths[b])``, as the partial
    ``(acc [B,S,H,D] f32, m [B,S,H] f32, l [B,S,H] f32)``.

    ``q [B, S, H, D]``: S = 1 for a decode step, K+1 for a speculative
    verify (every row attends the same pool prefix).  ``pool_k/pool_v [N,
    blk, Hkv, D]`` are the pool tensors, read through ``block_tables [B, nb]``
    (int32); idle entries may point anywhere, block 0 included.
    ``k_scale``/``v_scale [N, blk, Hkv]`` f32 dequantise an int8 pool.

    CUDA: q contiguous bf16, pools contiguous bf16 (or int8 with scales),
    ``D`` a multiple of 16 up to 128, ``blk`` a multiple of 16, ``S * H /
    Hkv <= 64`` and ``B <= 1024``; anything else raises.  One launch per
    call, on the current stream, counted by
    ``paged_attention_partial.launches``; the host reads nothing back from
    the device, so the call can be captured in a CUDA graph and replayed
    with ``lengths`` and ``block_tables`` changed in place.  Calls on one
    device share the pair counters (:func:`_pair_counters`) and must not run
    concurrently on two streams.  CPU tensors take
    :func:`paged_attention_partial_ref`."""
    _check(q, pool_k, pool_v, block_tables, lengths, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_partial_ref(q, pool_k, pool_v, block_tables, lengths,
                                           scale=scale, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_partial: unsupported device {q.device}")
    b, s, h, d = q.shape
    n_pool, blk, hkv, _ = pool_k.shape
    nb = block_tables.shape[1]
    quant = k_scale is not None
    tensors = {"q": q, "pool_k": pool_k, "pool_v": pool_v, "block_tables": block_tables,
               "lengths": lengths}
    if quant:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"paged_attention_partial: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention_partial kernel needs contiguous tensors; "
                             f"{name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention_partial kernel needs 16-byte aligned {name}")
    rows = s * (h // hkv)
    why = contract_violation(blk=blk, rows=rows, head_dim=d, q_dtype=q.dtype, batch=b,
                             kv_heads=hkv)
    if why is not None:
        raise ValueError(f"paged_attention_partial kernel takes {why}")
    want = torch.int8 if quant else torch.bfloat16
    if pool_k.dtype != want or pool_v.dtype != want:
        raise ValueError(f"paged_attention_partial kernel takes bf16 q and {want} pools "
                         f"(int8 with scales); got {q.dtype}, {pool_k.dtype}, {pool_v.dtype}")
    if quant and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("paged_attention_partial kernel takes float32 scales")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_tables and lengths must be int32")
    if n_pool * blk + TILE >= 2 ** 31:
        raise ValueError("paged_attention_partial kernel takes pools of < 2^31 positions")
    acc = torch.empty((b, s, h, d), device=q.device, dtype=torch.float32)
    m = torch.empty((b, s, h), device=q.device, dtype=torch.float32)
    l = torch.empty((b, s, h), device=q.device, dtype=torch.float32)
    if b == 0:
        return acc, m, l
    grid = _grid(q.device.index)
    slot = -(-rows * (d + 2) // 4) * 4  # a piece: acc [rows][D], m, l; 16-byte aligned
    ws = torch.empty((2 * grid * slot,), device=q.device, dtype=torch.float32)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), ptr(k_scale),
                    ptr(v_scale), block_tables.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
                    m.data_ptr(), l.data_ptr(), ws.data_ptr(),
                    _pair_counters(q.device.index).data_ptr(), b, s, h, hkv, d, blk, nb, n_pool,
                    int(quant), grid, float(d ** -0.5 if scale is None else scale), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {err}")
    paged_attention_partial.launches += 1
    return acc, m, l


paged_attention_partial.launches = 0


def paged_flash_attention(q, pool_k, pool_v, block_tables, lengths, *,
                          scale: Optional[float] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalised in-place paged attention ``[B, S, H, D]`` in ``q``'s dtype;
    a row with ``lengths[b] == 0`` gives zeros."""
    acc, _, l = paged_attention_partial(q, pool_k, pool_v, block_tables, lengths,
                                        scale=scale, k_scale=k_scale, v_scale=v_scale)
    return (acc / l[..., None].clamp_min(1e-30)).to(q.dtype)


def paged_bytes_accounting(*, n_valid_blocks: int, blocks_per_seq: int, block: int,
                           kvh: int, hd: int, esize: int, scale_bytes: int,
                           n_steps: int) -> dict:
    """Per-decode-step device-memory bytes of ONE slot's pool reads, gather vs
    in place (the JAX package's arithmetic, copied).  Gather pays, per chunk
    of ``n_steps``: read every table-mapped block and write the dense copy
    once, then read the whole dense copy per step.  In place pays the valid
    blocks per step plus one block for the idle tail.  Bytes per position are
    K + V (``esize`` each) plus the int8 layout's scales (``scale_bytes``)."""
    pos_bytes = kvh * (2 * hd * esize + scale_bytes)
    full = blocks_per_seq * block * pos_bytes
    valid = n_valid_blocks * block * pos_bytes
    tail = (block * pos_bytes) if n_valid_blocks < blocks_per_seq else 0
    gather_chunk = 2 * full + n_steps * full
    inplace_chunk = n_steps * (valid + tail)
    return {
        "gather_step_bytes": gather_chunk / max(1, n_steps),
        "paged_flash_step_bytes": inplace_chunk / max(1, n_steps),
        "gather_chunk_bytes": gather_chunk,
        "paged_flash_chunk_bytes": inplace_chunk,
    }
