"""LLM text tokenization for the port: the counterpart of
``tpustack/models/text_tokenizer.py`` without the Hugging Face branch.

The precedence is the JAX package's: the vendored CLIP-format BPE vocab
(``models/sd15/vocab``) when it fits the model's vocab, else a byte-level
tokenizer (UTF-8 byte + 3, llama-style pad=0 / bos=1 / eos=2).  A tokenizer
directory (``LLM_TOKENIZER_DIR``) needs ``transformers``, which the card's
machine does not have: setting it raises instead of falling back quietly.
"""

from __future__ import annotations

import os
from typing import List, Sequence

from tpustack_torch.utils import get_logger

log = get_logger("models.text_tokenizer")

BOS_ID = 1
EOS_ID = 2
_BYTE_OFFSET = 3


class ByteTokenizer:
    """UTF-8 bytes with llama-style special ids; needs vocab_size >= 259."""

    def __init__(self, vocab_size: int):
        if vocab_size < 256 + _BYTE_OFFSET:
            raise ValueError(f"byte tokenizer needs vocab >= 259, got {vocab_size}")
        self.vocab_size = vocab_size
        self.bos_id = BOS_ID
        self.eos_id = EOS_ID

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [b + _BYTE_OFFSET for b in text.encode("utf-8")]
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - _BYTE_OFFSET for i in ids if _BYTE_OFFSET <= i < 256 + _BYTE_OFFSET)
        return data.decode("utf-8", errors="replace")


class BpeTextTokenizer:
    """Subword BPE on the vendored CLIP-format vocab, with this module's
    llama-style encode/decode contract."""

    def __init__(self, bpe):
        self._bpe = bpe
        self.vocab_size = bpe.vocab_size
        self.bos_id = bpe.bos_id
        self.eos_id = bpe.eos_id

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self._bpe.encode(text)
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._bpe.decode(list(ids))


def load_text_tokenizer(vocab_size: int):
    if os.environ.get("LLM_TOKENIZER_DIR"):
        raise NotImplementedError(
            "LLM_TOKENIZER_DIR is not supported by the PyTorch port yet: loading a "
            "checkpoint's tokenizer needs transformers, which it does not use; unset it "
            "to use the vendored BPE / byte tokenizer")
    from tpustack_torch.models.clip_bpe import ClipBPE
    from tpustack_torch.models.sd15.tokenizer import VENDORED_VOCAB_DIR

    bpe = ClipBPE.load(VENDORED_VOCAB_DIR)
    if bpe.vocab_size <= vocab_size:
        log.info("Using vendored BPE tokenizer (vocab %d)", bpe.vocab_size)
        return BpeTextTokenizer(bpe)
    log.info("Vendored BPE vocab %d exceeds model vocab %d: byte-level tokenizer",
             bpe.vocab_size, vocab_size)
    return ByteTokenizer(vocab_size)
