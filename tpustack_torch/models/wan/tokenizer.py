"""UMT5 prompt tokenization for the Wan family.

Counterpart of ``tpustack/models/wan/tokenizer.py``: a deterministic hash
tokenizer with T5 framing (``ids... EOS pad...``, pad 0) and its attention
mask, the same ids as the JAX package's.  A real umt5 SentencePiece vocab
(``WAN_TOKENIZER_DIR``) needs ``transformers``, which the port does not use:
setting it raises, as the JAX loader does when its load fails, rather than
serving hash ids that mean nothing to a real checkpoint's text tower.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import List, Sequence, Tuple

import numpy as np

from tpustack_torch.utils import get_logger

log = get_logger("models.wan.tokenizer")

PAD_ID = 0
EOS_ID = 1
_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


class T5HashTokenizer:
    """Word->id hashing with T5 ``ids... EOS pad...`` framing + attention mask."""

    def __init__(self, vocab_size: int, max_length: int):
        self.vocab_size = vocab_size
        self.max_length = max_length

    def _ids(self, text: str) -> List[int]:
        out = []
        for w in _WORD_RE.findall(text.lower()):
            h = int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little")
            out.append(2 + h % (self.vocab_size - 2))  # keep 0/1 special
        return out

    def __call__(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.full((len(texts), self.max_length), PAD_ID, np.int32)
        mask = np.zeros((len(texts), self.max_length), bool)
        for i, t in enumerate(texts):
            toks = (self._ids(t) + [EOS_ID])[: self.max_length]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = True
        return ids, mask


def load_tokenizer(vocab_size: int, max_length: int) -> T5HashTokenizer:
    tok_dir = os.environ.get("WAN_TOKENIZER_DIR", "")
    if tok_dir:
        raise RuntimeError(
            f"WAN_TOKENIZER_DIR={tok_dir!r} was set but its tokenizer failed to "
            "load: the PyTorch port has no umt5 SentencePiece reader yet (queued)")
    log.warning("Using deterministic HASH tokenizer (not the umt5 vocab)")
    return T5HashTokenizer(vocab_size, max_length)
