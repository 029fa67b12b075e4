"""CLIP-format byte-pair-encoding tokenizer, self-contained.

The port's own copy of ``tpustack/models/clip_bpe.py`` (the port imports
nothing of ``tpustack``).  Same contract: ``vocab.json`` (token->id, word-final
tokens suffixed ``</w>``) + ``merges.txt`` (one merge per line, header line
first), the ids HF ``CLIPTokenizer`` gives on the same files;
``tests/test_torch_sd15.py`` holds the ids equal to the JAX package's.

Normalisation mirrors HF's no-ftfy path: control-char removal, CJK spacing,
NFC, whitespace split, lowercase (accents kept), then the CLIP split regex.
The ``regex`` module gives Unicode letter classes where it is installed; the
standard library ``re`` fallback is identical on ASCII text.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

try:  # transformers' own dependency; always present where transformers is
    import regex as _re

    _CLIP_PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE)
except ImportError:  # stdlib fallback: ASCII classes (identical on ASCII text)
    import re as _re

    _CLIP_PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
        _re.IGNORECASE)

BOS_TOKEN = "<|startoftext|>"
EOS_TOKEN = "<|endoftext|>"

# HF splits added tokens out of the RAW text (token trie, exact match) before
# any normalisation — so a literal special token adjacent to punctuation
# ("a cat,<|endoftext|>") must be recognised even though the CLIP split regex
# would greedily consume the "<|" into the punctuation class.
_SPECIAL_SPLIT = _re.compile(r"(<\|startoftext\|>|<\|endoftext\|>)")


@functools.lru_cache()
def byte_alphabet() -> Tuple[Dict[int, str], Dict[str, int]]:
    """GPT-2/CLIP reversible byte↔unicode table: printable bytes map to
    themselves, the rest to U+0100.. so no token ever contains whitespace or
    control characters."""
    keep = (list(range(ord("!"), ord("~") + 1)) +
            list(range(ord("¡"), ord("¬") + 1)) +
            list(range(ord("®"), ord("ÿ") + 1)))
    enc: Dict[int, str] = {}
    bump = 0
    for b in range(256):
        if b in keep:
            enc[b] = chr(b)
        else:
            enc[b] = chr(256 + bump)
            bump += 1
    return enc, {c: b for b, c in enc.items()}


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF) or
            (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F) or
            (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF) or
            (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def normalize(text: str) -> str:
    """HF CLIPTokenizer's no-ftfy preprocessing, reduced to its effect:
    drop control chars, space out CJK, NFC-normalise, collapse whitespace,
    lowercase (keeping accents)."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD:
            continue
        cat = unicodedata.category(ch)
        if ch in ("\t", "\n", "\r") or cat == "Zs":
            out.append(" ")
        elif cat in ("Cc", "Cf"):
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(tok.lower() for tok in text.split())


class ClipBPE:
    """Encoder over a CLIP-format ``vocab.json`` + ``merges.txt`` pair."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        self.encoder = dict(vocab)
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.rank = {pair: r for r, pair in enumerate(merges)}
        self.bos_id = self.encoder[BOS_TOKEN]
        self.eos_id = self.encoder[EOS_TOKEN]
        self.unk_id = self.eos_id  # CLIP convention: unk == eos
        self._byte_enc, _ = byte_alphabet()
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def load(cls, dirpath: str) -> "ClipBPE":
        with open(os.path.join(dirpath, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(dirpath, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:]  # first line is a header
        merges = [tuple(ln.split()) for ln in lines if ln]
        return cls(vocab, merges)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    # ------------------------------------------------------------------ core
    def _bpe(self, token: str) -> List[str]:
        """Merge the byte-symbols of one regex token (word-final symbol
        carries ``</w>``) greedily by merge rank until no ranked pair
        remains."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            pairs = [(parts[i], parts[i + 1]) for i in range(len(parts) - 1)]
            best = min(pairs, key=lambda p: self.rank.get(p, float("inf")))
            if best not in self.rank:
                break
            merged, i = [], 0
            while i < len(parts):
                if (i < len(parts) - 1 and
                        (parts[i], parts[i + 1]) == best):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[token] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        """Text → ids, no special-token framing."""
        ids: List[int] = []
        for seg in _SPECIAL_SPLIT.split(text):
            if seg == BOS_TOKEN:
                ids.append(self.bos_id)
                continue
            if seg == EOS_TOKEN:
                ids.append(self.eos_id)
                continue
            for tok in _CLIP_PAT.findall(normalize(seg)):
                # a special-token string surviving into the normalised text
                # (e.g. case-folded "<|ENDOFTEXT|>") still maps to its id:
                # HF's bpe cache pins these strings to themselves, so the
                # vocab lookup yields bos/eos there too
                if tok == BOS_TOKEN:
                    ids.append(self.bos_id)
                    continue
                if tok == EOS_TOKEN:
                    ids.append(self.eos_id)
                    continue
                sym = "".join(self._byte_enc[b] for b in tok.encode("utf-8"))
                ids.extend(self.encoder.get(p, self.unk_id)
                           for p in self._bpe(sym))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        _, byte_dec = byte_alphabet()
        text = "".join(self.decoder.get(int(i), "") for i in ids
                       if int(i) not in (self.bos_id, self.eos_id))
        # '<','/','w','>' are printable bytes, so decode the byte symbols
        # first and replace the word-final marker in the RESULT (doing it
        # before would inject raw spaces the byte table doesn't contain)
        raw = bytes(byte_dec[c] for c in text if c in byte_dec)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    # -------------------------------------------------------------- batching
    def __call__(self, prompts: Sequence[str],
                 max_length: int = 77) -> np.ndarray:
        """CLIP framing: ``[BOS] ids… [EOS]`` truncated to ``max_length``,
        padded with EOS (HF's pad_token) — the SD15/Wan text-tower contract."""
        out = np.full((len(prompts), max_length), self.eos_id, dtype=np.int32)
        for row, prompt in enumerate(prompts):
            ids = self.encode(prompt)[: max_length - 2]
            framed = [self.bos_id] + ids + [self.eos_id]
            out[row, : len(framed)] = framed
        return out
