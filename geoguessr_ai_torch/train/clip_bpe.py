"""CLIP byte-pair-encoding tokenizer (the port's copy of
geoguessr_ai_tpu/train/clip_bpe.py), with no dependency beyond the
standard library and numpy.

The algorithm is CLIP's: GPT-2's byte -> unicode mapping, the ``</w>``
word-end marker, merges applied by rank, ``<|startoftext|>`` /
``<|endoftext|>`` around the ids, padding with the eos id, truncation that
keeps the eos.  It reads standard ``vocab.json`` + ``merges.txt`` assets;
the repo ships a small learned vocabulary in ``data/clip_bpe/``
(``learn_bpe`` / ``write_assets`` build one).

The JAX module splits words with the ``regex`` package's pattern

    <\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d
    |[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+      (IGNORECASE)

which the standard ``re`` cannot express (its ``\\d`` is Nd only, and
``[^\\W\\d_]`` is not ``\\p{L}``).  ``find_tokens`` scans for the same
alternatives in the same order over ``unicodedata`` categories: L* for
``\\p{L}``, N* for ``\\p{N}``, Unicode White_Space for ``\\s``, the
literals matched case-insensitively.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

from geoguessr_ai_torch.config import REPO_ROOT

BOS_TOKEN = "<|startoftext|>"
EOS_TOKEN = "<|endoftext|>"
#: The assets in the repo, used unless ``CLIP_BPE_DIR`` names others.
DEFAULT_ASSET_DIR = os.path.join(REPO_ROOT, "data", "clip_bpe")


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """HF CLIPTokenizer's no-ftfy cleanup: control-char strip, CJK
    spacing, NFC, whitespace tokenize, lowercase (accents kept), join."""
    chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            chars.append(f" {ch} ")
        elif unicodedata.category(ch) == "Zs" or ch in ("\t", "\n", "\r"):
            chars.append(" ")
        else:
            chars.append(ch)
    text = unicodedata.normalize("NFC", "".join(chars))
    return " ".join(tok.lower() for tok in text.split())


# ---------------------------------------------------------------------------
# The word pattern, without ``regex``
# ---------------------------------------------------------------------------

#: The pattern's literal alternatives, in its order.
_LITERALS = (BOS_TOKEN, EOS_TOKEN, "'s", "'t", "'re", "'ve", "'m", "'ll",
             "'d")


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def _is_space(ch: str) -> bool:
    """``regex``'s ``\\s``: Unicode White_Space, which is ``str.isspace()``
    less the information separators U+001C-U+001F."""
    return ch.isspace() and not "\x1c" <= ch <= "\x1f"


def _is_other(ch: str) -> bool:
    """``[^\\s\\p{L}\\p{N}]`` under IGNORECASE, which also leaves out U+0345
    (a combining mark whose case variants are iota, a letter): that
    character matches no alternative and is skipped."""
    return not (_is_space(ch) or _is_letter(ch) or _is_number(ch)
                or ch == "\u0345")


def _literal_at(text: str, i: int, lit: str) -> bool:
    """``lit`` at ``text[i]``, case-insensitively (``'S`` and ``'ſ`` match
    ``'s``, as under IGNORECASE)."""
    seg = text[i:i + len(lit)]
    return len(seg) == len(lit) and all(
        c == t or c.casefold() == t for c, t in zip(seg, lit))


#: The alternatives after the literals: (class, whether it takes a run).
_CLASSES = ((_is_letter, True), (_is_number, False), (_is_other, True))


def find_tokens(text: str) -> List[str]:
    """``pattern.findall(text)`` of the JAX tokenizer's word pattern: at
    each position the first alternative that matches, in the pattern's
    order (the two specials, the contractions, a run of letters, one
    number, a run of anything but space, letters and numbers); a
    character that matches none (a space) is skipped."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch in "<'":  # the first character of every literal
            lit = next((t for t in _LITERALS if _literal_at(text, i, t)),
                       None)
            if lit is not None:
                out.append(text[i:i + len(lit)])
                i += len(lit)
                continue
        for member, run in _CLASSES:
            if member(ch):
                j = i + 1
                while run and j < n and member(text[j]):
                    j += 1
                out.append(text[i:j])
                i = j
                break
        else:
            i += 1
    return out


class CLIPBPETokenizer:
    """Callable: List[str] -> (B, max_length) int32 ids, bos/eos framed,
    padded with the eos id (HF's pad_token == eos), truncated so eos
    always terminates the sequence."""

    def __init__(self, vocab_file: str, merges_file: str,
                 max_length: int = 77):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            # the first line is the header; HF caps at 48894 merges
            merges = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.max_length = max_length
        self.bos_id = self.encoder[BOS_TOKEN]
        self.eos_id = self.encoder[EOS_TOKEN]
        self.unk_id = self.eos_id  # HF's unk_token == "<|endoftext|>"
        self._cache: Dict[str, str] = {BOS_TOKEN: BOS_TOKEN,
                                       EOS_TOKEN: EOS_TOKEN}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
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
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for token in find_tokens(basic_clean(text)):
            mapped = "".join(self.byte_encoder[b]
                             for b in token.encode("utf-8"))
            out.extend(self.bpe(mapped).split(" "))
        return out

    def encode(self, text: str) -> List[int]:
        """bos + content (truncated to max_length - 2) + eos, unpadded."""
        ids = [self.encoder.get(t, self.unk_id) for t in self.tokenize(text)]
        return [self.bos_id] + ids[:self.max_length - 2] + [self.eos_id]

    def decode(self, ids) -> str:
        """ids -> text as HF's convert_tokens_to_string: specials dropped,
        the byte map reversed, '</w>' -> space (punctuation decodes with a
        space before it, as in HF)."""
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        text = "".join(
            t for t in (self.decoder.get(int(i), "")
                        for i in np.asarray(ids).reshape(-1))
            if t not in (BOS_TOKEN, EOS_TOKEN))
        raw = bytearray(byte_decoder.get(c, 0)  # 0x00 marks '</w>'
                        for c in text.replace("</w>", "\x00"))
        return (raw.decode("utf-8", errors="replace").replace("\x00", " ")
                .strip())

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.max_length), self.eos_id, np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            out[i, :len(ids)] = ids
        return out


# ---------------------------------------------------------------------------
# Assets
# ---------------------------------------------------------------------------


def asset_dir() -> str:
    """``CLIP_BPE_DIR`` when set, else the repo's ``data/clip_bpe/``."""
    return os.path.abspath(os.environ.get("CLIP_BPE_DIR", DEFAULT_ASSET_DIR))


def load_default_tokenizer(max_length: int = 77) -> CLIPBPETokenizer:
    d = asset_dir()
    return CLIPBPETokenizer(os.path.join(d, "vocab.json"),
                            os.path.join(d, "merges.txt"), max_length)


def default_tokenize_fn(max_length: int = 77):
    """The BPE tokenizer of ``asset_dir()``; the hash tokenizer, with a
    warning, only when the assets are absent."""
    d = asset_dir()
    if os.path.exists(os.path.join(d, "vocab.json")):
        return load_default_tokenizer(max_length)
    from geoguessr_ai_torch.utils.logging import logger

    logger.warning(
        f"no CLIP BPE assets under {d}; falling back to hash tokenizer "
        "(fine for tests, NOT interoperable with real CLIP checkpoints)")
    from geoguessr_ai_torch.train.pretrain_clip import hash_tokenizer

    return hash_tokenizer(max_length=max_length)


# ---------------------------------------------------------------------------
# BPE learning (building the assets offline)
# ---------------------------------------------------------------------------


def learn_bpe(corpus: Sequence[str], num_merges: int = 4096
              ) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """Merges learned from a text corpus; returns (vocab, merges) in
    OpenAI CLIP's order: 256 byte tokens, 256 ``</w>`` byte tokens, one
    token per merge, then the two specials."""
    byte_enc = bytes_to_unicode()
    word_freq: Dict[Tuple[str, ...], int] = {}
    for text in corpus:
        for token in find_tokens(basic_clean(text)):
            mapped = "".join(byte_enc[b] for b in token.encode("utf-8"))
            word = tuple(mapped[:-1]) + (mapped[-1] + "</w>",)
            word_freq[word] = word_freq.get(word, 0) + 1

    merges: List[Tuple[str, str]] = []
    for _ in range(num_merges):
        pair_freq: Dict[Tuple[str, str], int] = {}
        for word, freq in word_freq.items():
            for pair in zip(word[:-1], word[1:]):
                pair_freq[pair] = pair_freq.get(pair, 0) + freq
        if not pair_freq:
            break
        # deterministic: the most frequent pair, ties broken by the pair
        best = max(pair_freq.items(), key=lambda kv: (kv[1], kv[0]))
        if best[1] < 2:
            break
        first, second = best[0]
        merges.append((first, second))
        merged = first + second
        new_freq: Dict[Tuple[str, ...], int] = {}
        for word, freq in word_freq.items():
            out: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    out.append(merged)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            key = tuple(out)
            new_freq[key] = new_freq.get(key, 0) + freq
        word_freq = new_freq

    vocab_tokens = (list(byte_enc.values())
                    + [f"{v}</w>" for v in byte_enc.values()]
                    + [a + b for a, b in merges] + [BOS_TOKEN, EOS_TOKEN])
    vocab = {tok: i for i, tok in enumerate(vocab_tokens)}
    if len(vocab) != len(vocab_tokens):
        raise ValueError("duplicate token in the learned vocabulary")
    return vocab, merges


def write_assets(vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "vocab.json"), "w",
              encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "merges.txt"), "w",
              encoding="utf-8") as f:
        f.write("#version: 0.2 - geoguessr-ai-tpu learned merges\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
