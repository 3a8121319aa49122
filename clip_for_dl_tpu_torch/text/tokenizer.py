"""WordPiece tokenizer — self-contained, HF-BERT-vocab compatible.

A copy of ``clip_for_dl_tpu.text.tokenizer`` (the port cannot import the JAX
package, whose ``__init__`` imports jax). Basic tokenizer (clean, CJK
spacing, optional lowercase/strip-accents, punctuation split) then greedy
longest-match-first WordPiece over a ``vocab.txt``-format vocabulary.
``tests/test_torch_zeroshot.py`` holds its ids and masks equal to the JAX
tokenizer's on the prompt families.

Output arrays are fixed-length (max_length padding), int32 numpy.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


def load_vocab(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = False):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._space_cjk(text)
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            tokens.extend(self._split_punct(tok))
        return [t for t in tokens if t]

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _space_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch
            for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punct(tok: str) -> List[str]:
        out: List[List[str]] = []
        new_word = True
        for ch in tok:
            if _is_punctuation(ch):
                out.append([ch])
                new_word = True
            else:
                if new_word:
                    out.append([])
                new_word = False
                out[-1].append(ch)
        return ["".join(w) for w in out]


class WordPieceTokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        unk_token: str = "[UNK]",
        max_chars_per_word: int = 100,
    ):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece: Optional[str] = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces


class BertTokenizer:
    """Full pipeline with HF-compatible encode semantics."""

    def __init__(
        self,
        vocab: Dict[str, int] | str,
        do_lower_case: bool = False,
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        unk_token: str = "[UNK]",
    ):
        if isinstance(vocab, str):
            vocab = load_vocab(vocab)
        self.vocab = vocab
        self.ids_to_tokens = {v: k for k, v in vocab.items()}
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordPieceTokenizer(vocab, unk_token)
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        # word → pieces memo: radiology reports reuse a small vocabulary,
        # so the greedy WordPiece scan runs once per distinct word
        self._word_cache: Dict[str, List[str]] = {}
        self._word_cache_cap = 1 << 16

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        cache = self._word_cache
        for word in self.basic.tokenize(text):
            pieces = cache.get(word)
            if pieces is None:
                pieces = self.wordpiece.tokenize(word)
                if len(cache) < self._word_cache_cap:
                    cache[word] = pieces
            out.extend(pieces)
        return out

    def encode(
        self,
        texts: Sequence[str] | str,
        max_length: int = 512,
        padding: str = "max_length",
        truncation: bool = True,
    ) -> Dict[str, np.ndarray]:
        """Returns {input_ids, attention_mask, token_type_ids} int32 arrays
        of shape [B, L]. padding: 'max_length' (fixed shapes) or 'longest'."""
        if isinstance(texts, str):
            texts = [texts]
        seqs: List[List[int]] = []
        for t in texts:
            ids = [self.vocab.get(tok, self.wordpiece.vocab.get(self.wordpiece.unk_token))
                   for tok in self.tokenize(t)]
            if truncation and len(ids) > max_length - 2:
                ids = ids[: max_length - 2]
            seqs.append([self.cls_id, *ids, self.sep_id])
        if padding == "max_length":
            pad_to = max_length
        else:
            pad_to = max(len(s) for s in seqs)
        n = len(seqs)
        input_ids = np.full((n, pad_to), self.pad_id, np.int32)
        mask = np.zeros((n, pad_to), np.int32)
        for i, s in enumerate(seqs):
            s = s[:pad_to]
            input_ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return {
            "input_ids": input_ids,
            "attention_mask": mask,
            "token_type_ids": np.zeros_like(input_ids),
        }

    def encode_bucketed(
        self,
        texts: Sequence[str] | str,
        max_length: int = 512,
        buckets: Sequence[int] = (32, 64, 128),
    ) -> Dict[str, np.ndarray]:
        """Length-bucketed encode: pad to the smallest bucket ≥ the batch's
        longest sequence (capped at max_length).

        The same features as padding='max_length' (masked attention makes
        padded positions inert), but a batch of short reports runs the text
        tower on a fraction of the 200/512-token pad, at one of a few
        shapes."""
        enc = self.encode(texts, max_length=max_length, padding="longest")
        cur = enc["input_ids"].shape[1]
        target = max_length
        for b in sorted(buckets):
            if cur <= b <= max_length:
                target = b
                break
        if target > cur:
            pad = target - cur
            n = enc["input_ids"].shape[0]
            enc["input_ids"] = np.concatenate(
                [enc["input_ids"], np.full((n, pad), self.pad_id, np.int32)], 1
            )
            enc["attention_mask"] = np.concatenate(
                [enc["attention_mask"], np.zeros((n, pad), np.int32)], 1
            )
            enc["token_type_ids"] = np.zeros_like(enc["input_ids"])
        elif target < cur:
            enc = {k: v[:, :target] for k, v in enc.items()}
        return enc


def build_tiny_vocab(words: Iterable[str], do_lower_case: bool = False) -> Dict[str, int]:
    """Test/dev helper: specials + whole words + all char pieces."""
    basic = BasicTokenizer(do_lower_case)
    vocab: List[str] = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    seen = set(vocab)
    for w in words:
        for tok in basic.tokenize(w):
            for cand in (tok, *[c for c in tok], *["##" + c for c in tok]):
                if cand not in seen:
                    seen.add(cand)
                    vocab.append(cand)
    return {t: i for i, t in enumerate(vocab)}


# The synthetic development vocabulary the JAX CLI builds when no vocab file
# is given (clip_for_dl_tpu/cli/main.py:43-66): prompt-template words plus
# the disease names, cased and lowercased.
_DEV_WORDS = (
    "this chest x-ray shows a of normal without any significant findings "
    "the radiological indicate image reveals characteristics diagnostic "
    "features are present demonstrates is typical case clear signs "
    "visible exhibits consistent with patterns suggest possible some may "
    "primary finding primarily one main evidence among other multiple "
    "conditions in no lobe lower right stable appearance compared prior "
    "exam mild associated effusion acute cardiopulmonary abnormality "
    "again noted cardiac silhouette and mediastinum size within limits"
)


def dev_words(disease_labels: Sequence[str]) -> List[str]:
    """The words of the JAX CLI's synthetic vocabulary: the prompt
    templates' words and the disease names, cased and lowercased."""
    return (
        _DEV_WORDS.split()
        + [w for d in disease_labels for w in d.split()]
        + [w for d in disease_labels for w in d.lower().split()]
    )


def build_dev_vocab(disease_labels: Sequence[str]) -> Dict[str, int]:
    """The JAX CLI's synthetic vocabulary for ``disease_labels``."""
    return build_tiny_vocab(dev_words(disease_labels))
