"""Text classifiers of the open-vocabulary models (host code, numpy):
prompt templates, the prompt-engineered vocabulary files, the per-dataset
classifier cache, the seen/unseen mask and CLIP's BPE tokenizer.

Counterpart: ``dvis_plus_tpu/models/ov/text.py`` (``VILD_TEMPLATES`` :29,
``load_vocabulary_file`` :47, ``expand_prompts`` :64, ``build_text_classifier``
:78, ``TextClassifierCache`` :110, ``category_overlapping_mask`` :129,
``SimpleTokenizer`` :163), copied so that the port imports nothing of the
JAX package and builds the same float32 arrays:

- each dataset class is a synonym list (``name1:name2:...``); every prompt
  template is applied to every synonym; per (class, template) the
  normalized synonym embeddings are averaged, so a class owns
  ``len(templates)`` rows, class-major; the learned void rows are appended
  by the model (``OVSegmenter.full_classifier``), and ``num_templates``
  ends with their count;
- the tokenizer needs the public merges file (``bpe_simple_vocab_16e6.txt.gz``)
  and the ``regex`` package, imported when a tokenizer is made, so the
  package imports without it.
"""
from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# FC-CLIP / ViLD prompt templates (public prompt set, as used by the
# reference's VILD_PROMPT list)
VILD_TEMPLATES = [
    "a photo of a {}.",
    "This is a photo of a {}",
    "There is a {} in the scene",
    "There is the {} in the scene",
    "a photo of a {} in the scene",
    "a photo of a small {}.",
    "a photo of a medium {}.",
    "a photo of a large {}.",
    "This is a photo of a small {}.",
    "This is a photo of a medium {}.",
    "This is a photo of a large {}.",
    "There is a small {} in the scene.",
    "There is a medium {} in the scene.",
    "There is a large {} in the scene.",
]


def load_vocabulary_file(path: str) -> List[List[str]]:
    """Prompt-engineered category file: one class per line, synonyms split
    by ':' (reference ov_datasets/*_with_prompt_eng.txt format)."""
    classes = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            # lines may be "id:name1,name2" style; keep the name part
            if ":" in line and line.split(":")[0].isdigit():
                line = line.split(":", 1)[1]
            synonyms = [s.strip() for s in line.replace(",", ":").split(":") if s.strip()]
            classes.append(synonyms)
    return classes


def expand_prompts(
    classes: Sequence[Sequence[str]], templates: Sequence[str] = VILD_TEMPLATES
) -> Tuple[List[List[str]], List[int]]:
    """Returns (per-(class,template) synonym prompt lists, num_templates per
    class). Row order: class-major, template-minor."""
    rows = []
    num_templates = []
    for synonyms in classes:
        for tmpl in templates:
            rows.append([tmpl.format(s) for s in synonyms])
        num_templates.append(len(templates))
    return rows, num_templates


def build_text_classifier(
    encode_fn: Callable[[List[str]], np.ndarray],
    classes: Sequence[Sequence[str]],
    void_embeds: "np.ndarray | None" = None,  # explicit void rows (tests);
    templates: Sequence[str] = VILD_TEMPLATES,
    num_void: int = 1,
) -> Tuple[np.ndarray, List[int]]:
    """Builds the (R, C) classifier matrix: for each (class, template) the
    mean of normalized synonym embeddings. The void block is LEARNED model
    state (reference void_embedding, meta_architecture_ov.py:152-157): by
    default no rows are appended here — the model's ``full_classifier``
    concatenates its normalized void params — but ``num_templates`` still
    ends with the void-row count ``num_void`` (the number of rows
    ``full_classifier`` WILL append: 1 for a private/merged void row, the
    full row count only under 'max' merge mode — reference
    ``num_templates + [void_embed.shape[0]]`` :228). Passing ``void_embeds``
    appends explicit rows instead (test fixtures)."""
    rows, num_templates = expand_prompts(classes, templates)
    embeds = []
    for prompts in rows:
        e = encode_fn(prompts)  # (S, C)
        e = e / (np.linalg.norm(e, axis=-1, keepdims=True) + 1e-12)
        embeds.append(e.mean(axis=0))
    mat = np.stack(embeds, axis=0)
    if void_embeds is not None:
        mat = np.concatenate([mat, np.asarray(void_embeds)], axis=0)
        num_templates = num_templates + [len(void_embeds)]
    else:
        num_templates = num_templates + [num_void]
    return mat, num_templates


class TextClassifierCache:
    """Per-dataset classifier cache (reference builds+caches per dataset name)."""

    def __init__(self, encode_fn, templates: Sequence[str] = VILD_TEMPLATES,
                 num_void: int = 1):
        self.encode_fn = encode_fn
        self.templates = list(templates)
        self.num_void = num_void
        self._cache: Dict[str, Tuple[np.ndarray, List[int]]] = {}

    def get(self, dataset_name: str, classes, void_embeds=None) -> Tuple[np.ndarray, List[int]]:
        if dataset_name not in self._cache:
            self._cache[dataset_name] = build_text_classifier(
                self.encode_fn, classes, void_embeds, self.templates,
                num_void=self.num_void,
            )
        return self._cache[dataset_name]


def category_overlapping_mask(
    train_classes: Sequence[Sequence[str]], test_classes: Sequence[Sequence[str]]
) -> np.ndarray:
    """(K_test,) 1 where a test class shares any synonym with training
    vocabulary (reference _set_class_information overlap computation)."""
    train_names = {n.lower() for syns in train_classes for n in syns}
    return np.asarray(
        [int(any(n.lower() in train_names for n in syns)) for syns in test_classes],
        np.float32,
    )


# ---------------------------------------------------------------------------
# CLIP BPE tokenizer (standard public algorithm; needs the bpe vocab file)
# ---------------------------------------------------------------------------


@functools.lru_cache()
def _bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class SimpleTokenizer:
    """CLIP BPE tokenizer; requires the public merges file
    (bpe_simple_vocab_16e6.txt.gz)."""

    def __init__(self, bpe_path: str, context_length: int = 77):
        import regex as re_mod

        self.context_length = context_length
        self.byte_encoder = _bytes_to_unicode()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.pat = re_mod.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            re_mod.IGNORECASE,
        )

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i + 1 < len(word) and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, texts: List[str]) -> np.ndarray:
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        result = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            text = html.unescape(html.unescape(text)).strip().lower()
            ids = [sot]
            for tok in self.pat.findall(text):
                tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
                ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
            ids.append(eot)
            ids = ids[: self.context_length]
            result[i, : len(ids)] = ids
        return result
