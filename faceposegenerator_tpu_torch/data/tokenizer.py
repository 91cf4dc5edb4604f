"""CLIP BPE tokenizer (port of `faceposegenerator_tpu/data/tokenizer.py:29-171`;
pure Python, no network, nothing imported from the JAX package).

The reference tokenizes prompts with the SD2.1 `AutoTokenizer` padded to 77
(`tokenize_prompt`, `train_ID-Booth.py:457-471`). This is the same algorithm
(lowercase + whitespace cleanup, byte→unicode table, BPE merges with `</w>`
end-of-word markers, bos/eos wrapping, padding to `model_max_length`),
loading `vocab.json` + `merges.txt` from a local tokenizer directory. It
returns the JAX tokenizer's (B, model_max_length) int32 numpy arrays; the
pipeline casts them to long.

Padding token: the SD2.x tokenizer sets `pad_token: "!"` (id 0) in
`tokenizer_config.json`, while SD1.x CLIP pads with EOS. The reference runs
the text encoder without an attention mask, so the pad id changes every
hidden state after EOS — `from_pretrained` reads the configured pad token so
conditioning matches the reference for the stated SD2.1 operating point.
"""

from __future__ import annotations

import functools
import html
import json
import os
import re
from typing import Dict, List, Tuple

import numpy as np


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2-style reversible byte→unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


# CLIP's token pattern; python `re` lacks \p{L}/\p{N}, so spell out the
# practical equivalent for prompts (letters incl. unicode word chars, digits,
# punctuation runs, and contractions).
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+",
    re.IGNORECASE,
)


class CLIPTokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        merges: List[Tuple[str, str]],
        model_max_length: int = 77,
        pad_token: str | None = None,
    ):
        self.vocab = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.model_max_length = model_max_length
        self.bos_token_id = vocab["<|startoftext|>"]
        self.eos_token_id = vocab["<|endoftext|>"]
        # SD1.x CLIP pads with EOS; SD2.x sets pad_token "!" (id 0)
        self.pad_token_id = vocab[pad_token] if pad_token else self.eos_token_id
        self.cache: Dict[str, str] = {}

    @classmethod
    def from_pretrained(cls, tokenizer_dir: str, model_max_length: int = 77):
        with open(os.path.join(tokenizer_dir, "vocab.json")) as f:
            vocab = json.load(f)
        with open(os.path.join(tokenizer_dir, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = []
        for line in lines:
            if line.startswith("#") or not line.strip():
                continue
            a, b = line.split()
            merges.append((a, b))
        pad_token = None
        cfg_path = os.path.join(tokenizer_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            pt = cfg.get("pad_token")
            if isinstance(pt, dict):  # serialized AddedToken form
                pt = pt.get("content")
            pad_token = pt
        return cls(vocab, merges, model_max_length, pad_token=pad_token)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids = []
        for token in _PAT.findall(_clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.vocab[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts, padding: str = "max_length", truncation: bool = True) -> np.ndarray:
        """Tokenize to (B, model_max_length) int32 with bos/eos wrapping and
        pad-token padding (diffusers `tokenize_prompt` contract; pad id per
        the loaded tokenizer_config — EOS for SD1.x, "!" for SD2.x)."""
        if isinstance(texts, str):
            texts = [texts]
        L = self.model_max_length
        out = np.full((len(texts), L), self.pad_token_id, np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos_token_id] + self.encode(t)[: L - 2] + [self.eos_token_id]
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids) -> str:
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        text = "".join(
            self.decoder[int(i)]
            for i in ids
            if int(i) not in (self.bos_token_id, self.eos_token_id)
        )
        raw = bytearray(byte_decoder[c] for c in text if c in byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()
