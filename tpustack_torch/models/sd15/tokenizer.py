"""Prompt tokenization for the SD1.5 text tower.

Counterpart of ``tpustack/models/sd15/tokenizer.py`` with the same
precedence and errors: ``SD15_TOKENIZER_DIR`` (a real checkpoint's vocab;
an unusable one raises) -> the vendored CLIP-format vocab under ``vocab/``
(a copy of the JAX package's stand-in vocab) -> a deterministic hash
tokenizer with CLIP's ``[BOS] ids [EOS]`` framing as the last resort.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Sequence

import numpy as np

from tpustack_torch.utils import get_logger

log = get_logger("models.sd15.tokenizer")

BOS_ID = 49406
EOS_ID = 49407
_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")

VENDORED_VOCAB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vocab")


class HashTokenizer:
    """Deterministic word->id hashing with CLIP-style [BOS] ids [EOS] pad framing."""

    def __init__(self, vocab_size: int, max_length: int):
        self.vocab_size = vocab_size
        self.max_length = max_length
        # keep ids clear of the BOS/EOS slots when the vocab is full-size
        self.bos = min(BOS_ID, vocab_size - 2)
        self.eos = min(EOS_ID, vocab_size - 1)

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")
        return h % max(self.bos - 1, 1) + 1  # avoid 0 / BOS / EOS

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        out = np.full((len(prompts), self.max_length), self.eos, dtype=np.int32)
        for row, prompt in enumerate(prompts):
            words = _WORD_RE.findall(prompt.lower())[: self.max_length - 2]
            ids = [self.bos] + [self._word_id(w) for w in words] + [self.eos]
            out[row, : len(ids)] = ids
        return out


class ClipBPEWrapper:
    """:class:`tpustack_torch.models.clip_bpe.ClipBPE` with the pipeline's
    call contract (``prompts -> [B, max_length] int32``)."""

    def __init__(self, bpe, max_length: int):
        self._bpe = bpe
        self.max_length = max_length
        self.vocab_size = bpe.vocab_size

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        return self._bpe(list(prompts), max_length=self.max_length)


def load_tokenizer(vocab_size: int, max_length: int):
    """``SD15_TOKENIZER_DIR`` -> vendored vocab -> hash, as in the JAX package."""
    from tpustack_torch.models.clip_bpe import ClipBPE

    explicit_dir = os.environ.get("SD15_TOKENIZER_DIR", "")
    for which, tok_dir in (("SD15_TOKENIZER_DIR", explicit_dir),
                           ("vendored", VENDORED_VOCAB_DIR)):
        if not (tok_dir and os.path.isdir(tok_dir)):
            if which == "SD15_TOKENIZER_DIR" and explicit_dir:
                raise FileNotFoundError(
                    f"SD15_TOKENIZER_DIR={explicit_dir!r} is not a directory; "
                    "refusing to fall back to the vendored vocab — its ids "
                    "would be meaningless for the configured checkpoint's "
                    "text tower")
            continue
        try:
            bpe = ClipBPE.load(tok_dir)
            if bpe.vocab_size > vocab_size:
                raise ValueError(f"vocab {bpe.vocab_size} exceeds text-tower "
                                 f"embedding table {vocab_size}")
            log.info("Loaded CLIP BPE tokenizer (%s: %s, vocab %d)",
                     which, tok_dir, bpe.vocab_size)
            return ClipBPEWrapper(bpe, max_length)
        except Exception as e:  # corrupt/partial files
            if which == "SD15_TOKENIZER_DIR":
                # an explicitly configured real vocab failing to load is an
                # error: the stand-in vocab would give wrong conditioning
                raise RuntimeError(f"SD15_TOKENIZER_DIR={tok_dir!r} was set but its "
                                   f"vocab failed to load: {e}") from e
            log.warning("CLIP BPE load from %s failed (%s)", tok_dir, e)
    log.warning("No usable CLIP vocab files; using deterministic hash tokenizer — "
                "fine for perf/demo, not for real prompts")
    return HashTokenizer(vocab_size, max_length)
