"""CLIP byte-pair-encoding tokenizer (GPT-2-style byte BPE).

Counterpart of ``xai_tpu/data/tokenizer.py``, after openai-CLIP's
``SimpleTokenizer`` (MIT-licensed; the reference vendors it, e.g.
CLIP_Surgery/clip/simple_tokenizer.py): the byte -> unicode map, merge
ranks from the standard ``bpe_simple_vocab_16e6.txt.gz``, lowercasing and
whitespace cleanup, the ``<|startoftext|>`` / ``<|endoftext|>`` specials
and a fixed context of 77 with truncation.

The vocabulary and the 1000 ImageNet class names are this package's own
copies (``xai_tpu_torch/data/``), so the port reads no file of the JAX
package.
"""
from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache

import numpy as np

DEFAULT_BPE_PATH = os.path.join(os.path.dirname(__file__),
                                "bpe_simple_vocab_16e6.txt.gz")
CLASS_NAMES_PATH = os.path.join(os.path.dirname(__file__),
                                "imagenet_classes.txt")


@lru_cache()
def imagenet_class_names() -> tuple:
    """The 1000 human-readable ImageNet class names (the reference's
    util/class_maps/ImageNet/imagenet_classes.txt, read at
    evaluatePerturbation.py:65)."""
    with open(CLASS_NAMES_PATH) as f:
        return tuple(line.strip() for line in f if line.strip())


def class_prompts() -> list:
    """The reference's CLIP prompt table: "a photo of a {label}" a class
    (evaluatePerturbation.py:699)."""
    return [f"a photo of a {label}" for label in imagenet_class_names()]


@lru_cache()
def default_tokenizer():
    return SimpleTokenizer(DEFAULT_BPE_PATH)


@lru_cache()
def bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("\xa1"), ord("\xac") + 1)) +
          list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    return set(zip(word[:-1], word[1:]))


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: str = None, context_length: int = 77):
        bpe_path = bpe_path or DEFAULT_BPE_PATH
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        # openai CLIP uses the regex module's \p{L} / \p{N}; these ASCII
        # classes are the same on the English class prompts
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE)

    def bpe(self, token: str) -> str:
        """The merged symbols of one pre-token, space-separated: merge the
        lowest-ranked adjacent pair until no pair has a rank."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
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
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list:
        tokens = []
        text = whitespace_clean(html.unescape(html.unescape(text))).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return tokens

    def tokenize(self, texts, truncate: bool = True) -> np.ndarray:
        """list[str] -> ``[N, context_length]`` int32 ids (clip.tokenize),
        zero-padded."""
        if isinstance(texts, str):
            texts = [texts]
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            toks = [sot] + self.encode(text) + [eot]
            if len(toks) > self.context_length:
                if not truncate:
                    raise RuntimeError(f"too long: {text}")
                toks = toks[:self.context_length]
                toks[-1] = eot
            out[i, :len(toks)] = toks
        return out
