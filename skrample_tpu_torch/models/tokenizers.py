"""Checkpoint-vocabulary tokenizers: the published CLIP BPE and T5's
SentencePiece Unigram (the JAX package's ``models/tokenizers.py``).

Imported checkpoints were trained on their own vocabularies, so prompt ids
must come from the checkpoint's ``vocab.json`` + ``merges.txt`` (CLIP) or
``tokenizer.json`` (T5).  :class:`CLIPBPETokenizer` is the published CLIP
byte-pair encoding (openai/CLIP ``simple_tokenizer``): byte-to-unicode
remapping, the contraction/letter/number/punctuation split, lowest-rank
merges, the ``</w>`` end-of-word marker; text cleaning is whitespace
collapse and lowercase.  :class:`UnigramTokenizer` is max-sum Viterbi over
the scored pieces with metaspace word marking and fused unknowns.

Only the standard library and numpy: the published split pattern's
``\\p{L}``/``\\p{N}`` classes (the third-party ``regex`` package in the
JAX module) are read from ``unicodedata`` categories here, with the
pattern's case-insensitive matching reproduced where it differs from plain
category tests (U+0345 and U+017F, see :func:`_split`).  Python's own
``[^\\W\\d_]`` would not do: it takes ``²`` and ``½`` (category No) as
letters.  Ids equal the JAX package's (``tests/test_torch_text_encoders.py``)
for every character of the Unicode version both sides know.
"""

from __future__ import annotations

import json
import re
import unicodedata
from pathlib import Path

import numpy as np

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")  # in the published pattern's order
_NOT_SPACE = frozenset("\x1c\x1d\x1e\x1f")  # str.isspace() takes them; Unicode's White_Space (the pattern's \s) not
_FOLDED_AWAY = "ͅ"
"""Combining ypogegrammeni (Mn) case-folds to a letter (iota), so the
pattern's case-insensitive ``[^\\s\\p{L}\\p{N}]`` refuses it, while
``\\p{L}`` takes it only by its own category: no alternative matches and
the character is skipped like whitespace."""


def _kind(ch: str) -> str:
    "The published pattern's class of one character: ``L``etter, ``N``umber, ``s``kipped, or ``o``ther."
    if ch == _FOLDED_AWAY or (ch.isspace() and ch not in _NOT_SPACE):
        return "s"
    major = unicodedata.category(ch)[0]
    return major if major in "LN" else "o"


def _fold(ch: str) -> str:
    "Simple case folding as far as the literals' ASCII letters need it: the long s (U+017F) is an ``s``."
    return "s" if ch == "ſ" else ch.lower()


def _split(text: str) -> list[str]:
    """``findall`` of the published CLIP pattern (case-insensitive)
    ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
    over lowercased text, as a left-to-right scan trying the alternatives
    in the pattern's order."""
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        literal = next((s for s in (*_SPECIALS, *_CONTRACTIONS) if "".join(map(_fold, text[i : i + len(s)])) == s), None)
        if literal is not None:
            out.append(text[i : i + len(literal)])
            i += len(literal)
            continue
        kind = _kind(text[i])
        if kind == "s":
            i += 1
            continue
        j = i + 1
        if kind == "L":
            while j < n and _kind(text[j]) == "L":
                j += 1
        elif kind == "o":
            while j < n and _kind(text[j]) == "o":
                j += 1
        out.append(text[i:j])
        i = j
    return out


def _bytes_to_unicode() -> dict[int, str]:
    "The published reversible byte <-> printable-unicode table."
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


class CLIPBPETokenizer:
    """CLIP byte-pair encoder over a checkpoint's ``vocab.json`` +
    ``merges.txt``.  ``__call__`` produces the diffusers-pipeline id layout:
    ``bos + tokens + eos``, truncated to ``length``, padded with ``pad_id``
    (CLIP-L convention: the eos id; SDXL's second tokenizer pads with 0:
    pass ``pad_id=0``)."""

    BOS = "<|startoftext|>"
    EOS = "<|endoftext|>"

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]], max_tokens: int = 77) -> None:
        self.vocab = dict(vocab)
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.max_tokens = max_tokens
        self.byte_encoder = _bytes_to_unicode()
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self._cache: dict[str, tuple[str, ...]] = {}
        for special in (self.BOS, self.EOS):
            if special not in self.vocab:
                raise ValueError(f"vocabulary is missing {special!r}")
        self.bos_id = self.vocab[self.BOS]
        self.eos_id = self.vocab[self.EOS]

    @classmethod
    def from_files(cls, vocab_json: str | Path, merges_txt: str | Path, **kw) -> CLIPBPETokenizer:
        vocab = json.loads(Path(vocab_json).read_text(encoding="utf-8"))
        merges = []
        for line in Path(merges_txt).read_text(encoding="utf-8").splitlines():
            if line.startswith("#version") or not line.strip():
                continue
            a, b = line.split()
            merges.append((a, b))
        return cls(vocab, merges, **kw)

    def _bpe(self, token: str) -> tuple[str, ...]:
        "Lowest-rank merge loop over the word, with the </w> terminal marker."
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = (*token[:-1], token[-1] + "</w>")
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            bigram = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if bigram not in self.ranks:
                break
            first, second = bigram
            out: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        self._cache[token] = word
        return word

    def encode(self, text: str) -> list[int]:
        "Text -> BPE ids, no implicit specials.  Cleaning: whitespace collapse + lowercase."
        text = " ".join(text.split()).lower()
        ids: list[int] = []
        for token in _split(text):
            if token in (self.BOS, self.EOS):  # literal special-token text stays one atomic id, never BPE'd
                ids.append(self.vocab[token])
                continue
            mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.vocab[piece] for piece in self._bpe(mapped))
        return ids

    def decode(self, ids) -> str:
        byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        text = "".join(self.id_to_token[int(i)] for i in np.asarray(ids).reshape(-1))
        raw = bytes(byte_decoder[c] for c in text if c in byte_decoder)
        # the </w> markers are plain ascii and survive the byte decode; word boundaries become spaces after it
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __call__(self, texts: str | list[str], length: int | None = None, pad_id: int | None = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        length = length or self.max_tokens
        pad = self.eos_id if pad_id is None else pad_id
        rows = []
        for text in texts:
            ids = [self.bos_id, *self.encode(text)[: length - 2], self.eos_id]
            rows.append(ids + [pad] * (length - len(ids)))
        return np.asarray(rows, np.int32)


_METASPACE = "▁"  # the SentencePiece word-boundary marker
_UNK_PENALTY = 10.0  # unknown chars score min(vocab) - this (sentencepiece kUnkPenalty)


class UnigramTokenizer:
    """SentencePiece-Unigram tokenizer over a checkpoint's vocabulary: the
    T5 family (SD3's tokenizer_3, Flux's tokenizer_2).

    ``vocab`` is the scored piece list ``[(piece, log_prob), ...]`` in id
    order, as ``tokenizer.json``'s ``model.vocab`` carries it.  Segmentation
    is max-sum Viterbi over the pieces, with single-character unknown nodes
    scored ``min(scores) - 10`` and adjacent unknowns fused into one
    ``unk_id`` afterwards.  Every space becomes ``▁`` and the text gets a
    leading ``▁``; pieces never span word boundaries.  Normalization is NFKC
    + unicode-space/control mapping + space collapsing.

    ``__call__`` produces the diffusers T5 id layout: ``tokens + eos``,
    truncated to ``length``, padded with ``pad_id`` (T5 has no bos)."""

    def __init__(
        self,
        vocab: list[tuple[str, float]],
        unk_id: int = 2,
        eos_id: int = 1,
        pad_id: int = 0,
        specials: dict[str, int] | None = None,
        max_tokens: int = 512,
    ) -> None:
        self.pieces = [(str(p), float(s)) for p, s in vocab]
        self.scores = {p: s for p, s in self.pieces}
        self.ids = {p: i for i, (p, _) in enumerate(self.pieces)}
        self.unk_id, self.eos_id, self.pad_id = unk_id, eos_id, pad_id
        self.max_tokens = max_tokens
        self._unk_score = min(s for _, s in self.pieces) - _UNK_PENALTY
        self._max_piece = max(len(p) for p, _ in self.pieces)
        # atomic special tokens (T5's <extra_id_N> sentinels): matched verbatim before normalization, longest first
        self.specials = dict(specials or {})
        self._special_re = (
            re.compile("|".join(re.escape(t) for t in sorted(self.specials, key=len, reverse=True)))
            if self.specials
            else None
        )

    @classmethod
    def from_tokenizer_json(cls, path: str | Path, **kw) -> UnigramTokenizer:
        """Load from an HF-format ``tokenizer.json`` (Unigram model only):
        ``model.vocab``/``model.unk_id`` and the added-token table (T5's
        ``</s>``/``<pad>`` ids and the ``<extra_id_*>`` sentinels)."""
        blob = json.loads(Path(path).read_text(encoding="utf-8"))
        model = blob["model"]
        if model.get("type") != "Unigram":
            raise ValueError(f"not a Unigram tokenizer.json (model.type={model.get('type')!r})")
        vocab = [(p, float(s)) for p, s in model["vocab"]]
        lookup = {p: i for i, (p, _) in enumerate(vocab)}
        specials = {t["content"]: t["id"] for t in blob.get("added_tokens", []) if t["content"] not in lookup}
        eos = lookup.get("</s>", 1)
        pad = lookup.get("<pad>", 0)
        return cls(vocab, unk_id=int(model.get("unk_id", 2)), eos_id=eos, pad_id=pad, specials=specials, **kw)

    @staticmethod
    def _normalize(text: str) -> str:
        "NFKC + unicode spaces/controls -> ascii space + run collapsing."
        text = unicodedata.normalize("NFKC", text)
        out = []
        for ch in text:
            cat = unicodedata.category(ch)
            if cat == "Zs" or ch in "\t\n\r\x0b\x0c":
                out.append(" ")
            elif cat not in ("Cc", "Cf"):
                out.append(ch)
        return re.sub(" {2,}", " ", "".join(out))

    def _viterbi(self, chunk: str) -> list[int]:
        "Best segmentation of one metaspace-marked word; unknowns fused."
        n = len(chunk)
        best = [float("-inf")] * (n + 1)
        back: list[tuple[int, int]] = [(-1, -1)] * (n + 1)  # (start, id or -1 = unknown)
        best[0] = 0.0
        for end in range(1, n + 1):
            for start in range(max(0, end - self._max_piece), end):
                if best[start] == float("-inf"):
                    continue
                piece = chunk[start:end]
                score = self.scores.get(piece)
                if score is not None and best[start] + score > best[end]:
                    best[end] = best[start] + score
                    back[end] = (start, self.ids[piece])
            if best[end - 1] != float("-inf") and best[end - 1] + self._unk_score > best[end]:
                best[end] = best[end - 1] + self._unk_score  # the single-character unknown node
                back[end] = (end - 1, -1)
        ids: list[int] = []
        pos = n
        while pos > 0:
            start, tid = back[pos]
            ids.append(tid)
            pos = start
        out: list[int] = []
        prev_unk = False
        for tid in reversed(ids):  # fuse adjacent unknowns into one unk id
            if tid == -1:
                if not prev_unk:
                    out.append(self.unk_id)
            else:
                out.append(tid)
            prev_unk = tid == -1
        return out

    def encode(self, text: str) -> list[int]:
        "Text -> Unigram ids, no implicit specials."
        segments: list[str | int] = []
        pos = 0
        if self._special_re is not None:
            for m in self._special_re.finditer(text):
                if m.start() > pos:
                    segments.append(text[pos : m.start()])
                segments.append(self.specials[m.group()])
                pos = m.end()
        if pos < len(text) or not segments:
            segments.append(text[pos:])
        ids: list[int] = []
        for seg in segments:
            if isinstance(seg, int):
                ids.append(seg)
                continue
            norm = self._normalize(seg)
            if not norm:
                continue
            marked = norm.replace(" ", _METASPACE)
            if not marked.startswith(_METASPACE):
                marked = _METASPACE + marked
            # every chunk begins at a word marker; pieces never span chunks
            for word in re.findall(f"{_METASPACE}[^{_METASPACE}]*", marked):
                ids.extend(self._viterbi(word))
        return ids

    def decode(self, ids) -> str:
        toks = []
        rev_special = {i: t for t, i in self.specials.items()}
        for i in np.asarray(ids).reshape(-1):
            i = int(i)
            if i in rev_special:
                toks.append(rev_special[i])
            elif i == self.unk_id:
                toks.append(" ⁇ ")
            elif 0 <= i < len(self.pieces):
                toks.append(self.pieces[i][0])
        return "".join(toks).replace(_METASPACE, " ").strip()

    def __call__(self, texts: str | list[str], length: int | None = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        length = length or self.max_tokens
        rows = []
        for text in texts:
            ids = [*self.encode(text)[: length - 1], self.eos_id]
            rows.append(ids + [self.pad_id] * (length - len(ids)))
        return np.asarray(rows, np.int32)
