"""Text pipeline: vocabulary, tokenization, padded batching — the port
of ``bigdl_tpu.data.text`` (the same vocabulary files and the same
batches for the same seed).

Batches are padded to FIXED bucket lengths, so a model sees one shape
per bucket instead of one per sentence length, and a mask — not ragged
shapes — carries the sequence lengths.
"""

import collections
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.data.dataset import MiniBatch

PAD, UNK, BOS, EOS = "<pad>", "<unk>", "<bos>", "<eos>"
_VOCAB_V2 = "#bigdl-tpu-vocab-v2"


class Vocabulary:
    """Token → id dictionary — reference ``text/Dictionary.scala``.
    Ids: 0=pad, 1=unk, 2=bos, 3=eos, then tokens by frequency."""

    def __init__(self, tokens_by_freq: Sequence[str]):
        self.itos: List[str] = [PAD, UNK, BOS, EOS] + list(tokens_by_freq)
        self.stoi: Dict[str, int] = {t: i for i, t in enumerate(self.itos)}

    @staticmethod
    def build(corpus: Iterable[Sequence[str]], max_size: Optional[int] = None,
              min_freq: int = 1) -> "Vocabulary":
        counts = collections.Counter()
        for toks in corpus:
            counts.update(toks)
        items = [t for t, c in counts.most_common(max_size) if c >= min_freq]
        return Vocabulary(items)

    def __len__(self):
        return len(self.itos)

    def encode(self, tokens: Sequence[str], add_bos=False, add_eos=False
               ) -> List[int]:
        ids = [self.stoi.get(t, 1) for t in tokens]
        if add_bos:
            ids = [2] + ids
        if add_eos:
            ids = ids + [3]
        return ids

    def decode(self, ids: Sequence[int], strip_special: bool = True) -> List[str]:
        toks = [self.itos[i] for i in ids]
        if strip_special:
            toks = [t for t in toks if t not in (PAD, UNK, BOS, EOS)]
        return toks


    def save(self, path: str) -> None:
        """Persist the vocabulary (one token per line, frequency order) —
        re-loadable with :meth:`load` for serving-side tokenization.
        Newlines/backslashes inside a token are escaped so a pathological
        token cannot shift every subsequent id on reload; a version sentinel
        on the first line keeps raw (pre-escaping) files loading
        unchanged."""
        with open(path, "w", encoding="utf-8", newline="\n") as f:
            f.write(_VOCAB_V2 + "\n")
            for tok in self.itos:
                f.write(tok.replace("\\", "\\\\").replace("\n", "\\n")
                        .replace("\r", "\\r") + "\n")

    @staticmethod
    def _unescape(s: str) -> str:
        out, i = [], 0
        while i < len(s):
            c = s[i]
            if c == "\\" and i + 1 < len(s):
                nxt = s[i + 1]
                out.append({"n": "\n", "r": "\r", "\\": "\\"}.get(nxt,
                                                                  "\\" + nxt))
                i += 2
            else:
                out.append(c)
                i += 1
        return "".join(out)

    @staticmethod
    def load(path: str) -> "Vocabulary":
        with open(path, encoding="utf-8") as f:
            lines = [ln.rstrip("\n") for ln in f]
        if lines and lines[0].rstrip("\r") == _VOCAB_V2:
            if lines[0].endswith("\r"):  # CRLF-translated v2 file
                lines = [ln[:-1] if ln.endswith("\r") else ln
                         for ln in lines]
            tokens = [Vocabulary._unescape(ln) for ln in lines[1:]]
        else:  # legacy raw format: tokens verbatim, no unescaping
            tokens = lines
        v = Vocabulary.__new__(Vocabulary)
        v.itos = tokens
        v.stoi = {t: i for i, t in enumerate(tokens)}
        return v


def char_tokenize(text: str) -> List[str]:
    return list(text)


def word_tokenize(text: str) -> List[str]:
    return text.split()


def pad_to(ids: Sequence[int], length: int) -> np.ndarray:
    out = np.zeros((length,), np.int32)
    n = min(len(ids), length)
    out[:n] = np.asarray(ids[:n], np.int32)
    return out


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (last bucket truncates) — keeps the number of
    batch shapes bounded by len(buckets)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class TextBatcher:
    """sentences (token-id lists) → padded (ids, mask) minibatches, bucketed
    by length — the ``SampleToMiniBatch`` of the text path."""

    def __init__(self, buckets: Sequence[int] = (32, 64, 128),
                 batch_size: int = 32, shuffle: bool = True, seed: int = 0):
        self.buckets = sorted(buckets)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __call__(self, encoded: Sequence[Sequence[int]],
                 labels: Optional[Sequence] = None) -> Iterator[MiniBatch]:
        by_bucket: Dict[int, List[int]] = collections.defaultdict(list)
        for i, ids in enumerate(encoded):
            by_bucket[bucket_length(len(ids), self.buckets)].append(i)
        order = sorted(by_bucket)
        if self.shuffle:
            self.rng.shuffle(order)
        for b in order:
            idxs = by_bucket[b]
            if self.shuffle:
                self.rng.shuffle(idxs)
            for s in range(0, len(idxs), self.batch_size):
                chunk = idxs[s:s + self.batch_size]
                ids = np.stack([pad_to(encoded[i], b) for i in chunk])
                mask = (ids != 0)
                batch = MiniBatch(input=ids, mask=mask)
                if labels is not None:
                    batch["target"] = np.asarray([labels[i] for i in chunk])
                yield batch


def language_model_arrays(text: str, vocab: Optional[Vocabulary],
                          seq_len: int, tokenizer=char_tokenize
                          ) -> Tuple[np.ndarray, np.ndarray, Vocabulary]:
    """Rolling next-token-prediction windows — the char-RNN training prep
    (reference ``models/rnn`` data path): x[t] predicts x[t+1]."""
    toks = tokenizer(text)
    if vocab is None:
        vocab = Vocabulary.build([toks])
    ids = np.asarray(vocab.encode(toks), np.int32)
    n = (len(ids) - 1) // seq_len
    if n <= 0:
        raise ValueError(f"text too short for seq_len={seq_len}")
    x = ids[: n * seq_len].reshape(n, seq_len)
    y = ids[1: n * seq_len + 1].reshape(n, seq_len)
    return x, y, vocab
