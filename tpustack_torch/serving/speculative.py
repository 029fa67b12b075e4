"""Speculative decoding, host side: the config and the drafters.

The port of ``tpustack/serving/speculative.py``: ``SpecConfig``, the
``PromptLookupDrafter`` (pure numpy) and the ``DraftModelDrafter`` (greedy
proposals from a second generator).  The continuous engine scores the last
accepted token plus up to ``SpecConfig.tokens`` drafted tokens in one
forward pass (``Generator._spec_verify_paged`` / ``_spec_verify_cont``) and
keeps the longest prefix the model agrees with, so greedy output is the same
with speculation on or off, whatever the drafter.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class SpecConfig:
    """``tokens``: max draft tokens per verify step (K).  ``ngram_max`` /
    ``ngram_min``: prompt-lookup match lengths, longest first.
    ``ema_alpha``: weight of the newest acceptance ratio in each slot's
    rolling EMA.  ``probe_every``: waves between 1-token probes once a
    slot's EMA throttled its drafting to zero.  ``drafter``: any object
    with ``draft(history, k) -> List[int]``; None builds the prompt-lookup
    default."""

    tokens: int = 4
    ngram_max: int = 3
    ngram_min: int = 1
    ema_alpha: float = 0.25
    probe_every: int = 8
    drafter: Optional[object] = None


class PromptLookupDrafter:
    """n-gram prompt lookup: propose the continuation of the most recent
    earlier occurrence of the history's final n-gram (longest n first; among
    matches of one length the most recent with ``k`` continuation tokens,
    else the one with the longest stub; the self-match is excluded)."""

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1):
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError(f"need 1 <= ngram_min <= ngram_max, got [{ngram_min}, {ngram_max}]")
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min

    def draft(self, history: Sequence[int], k: int) -> List[int]:
        n_hist = len(history)
        if k <= 0 or n_hist < self.ngram_min + 1:
            return []
        arr = np.asarray(history, dtype=np.int64)
        for n in range(min(self.ngram_max, n_hist - 1), self.ngram_min - 1, -1):
            pat = arr[-n:]
            m = n_hist - n  # candidate starts [0, m): start m IS the suffix
            eq = np.ones(m, dtype=bool)
            for j in range(n):
                eq &= arr[j:j + m] == pat[j]
            idx = np.flatnonzero(eq)
            if idx.size:
                full = idx[idx <= n_hist - n - k]  # k tokens available
                start = int(full[-1]) if full.size else int(idx[0])
                cont = arr[start + n:start + n + k]
                if cont.size:
                    return [int(x) for x in cont]
        return []


class DraftModelDrafter:
    """Greedy k-token proposals from a separate draft generator.

    Rehearsal-grade by design, as in the JAX package: each call runs the
    draft model's own solo prefill over the (ctx-clipped) history plus k
    greedy decode steps (``Generator.generate``); no draft KV is kept, so a
    proposal costs O(len(history)) draft-model work.  The draft generator
    has its own caches and counters; the target's are never touched.  The
    verify step owns correctness."""

    def __init__(self, gen, stop_tokens: Sequence[int] = ()):
        self.gen = gen
        self.stop_tokens = tuple(stop_tokens)

    def draft(self, history: Sequence[int], k: int) -> List[int]:
        from tpustack_torch.models.llm_generate import SampleConfig

        if k <= 0 or not history:
            return []
        # clip to the draft model's context (it may be shorter than the
        # target's); proposals from shifted positions are still proposals
        ctx = self.gen.cfg.max_seq
        hist = list(history)[-(max(1, ctx - k - 1)):]
        try:
            out, _ = self.gen.generate(hist, max_new_tokens=k, sample=SampleConfig(greedy=True),
                                       stop_tokens=self.stop_tokens)
        except ValueError:
            return []
        return [int(t) for t in out[:k]]
