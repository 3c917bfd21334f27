"""The port's open-vocabulary host code against the JAX package's: the
vocabulary files (the port's copies byte-identical), their parsing, the
prompt expansion, ``build_text_classifier`` and its cache, the seen/unseen
mask (equal arrays), CLIP's BPE tokenizer on a small merges file written
here (equal token ids), and the CLI helpers that pick a set's vocabulary,
its void row and its classifier (``cli_ov`` against
``train_net_video_ov.py``)."""
import gzip
import os
import zlib

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_VOCAB = os.path.join(REPO, "dvis_plus_tpu", "data", "ov_vocab")
PORT_VOCAB = os.path.join(REPO, "dvis_plus_tpu_torch", "data", "ov_vocab")


def test_vocabulary_copies_are_byte_identical():
    names = sorted(os.listdir(JAX_VOCAB))
    assert names == sorted(os.listdir(PORT_VOCAB)) and len(names) == 6
    for name in names:
        with open(os.path.join(JAX_VOCAB, name), "rb") as a, open(os.path.join(PORT_VOCAB, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("name", sorted(os.listdir(JAX_VOCAB)))
def test_load_vocabulary_file(name):
    from dvis_plus_tpu.models.ov import text as jax_text
    from dvis_plus_tpu_torch.models.ov import text

    got = text.load_vocabulary_file(os.path.join(PORT_VOCAB, name))
    assert got == jax_text.load_vocabulary_file(os.path.join(JAX_VOCAB, name)) and len(got) > 20


def _encode(prompts):
    """A deterministic stand-in for a text tower: one seeded vector a
    prompt (crc32 of its text, stable across processes)."""
    return np.stack([np.random.RandomState(zlib.crc32(p.encode())).randn(16) for p in prompts]
                    ).astype(np.float32)


@pytest.mark.parametrize("num_void,void_embeds", [(1, None), (3, None), (1, "rows")])
def test_build_text_classifier_and_cache(num_void, void_embeds):
    from dvis_plus_tpu.models.ov import text as jax_text
    from dvis_plus_tpu_torch.models.ov import text

    classes = text.load_vocabulary_file(os.path.join(PORT_VOCAB, "ytvis19_instance_with_prompt_eng.txt"))[1:8]
    assert text.VILD_TEMPLATES == jax_text.VILD_TEMPLATES
    assert text.expand_prompts(classes) == jax_text.expand_prompts(classes)
    rows = None if void_embeds is None else np.random.RandomState(0).randn(2, 16).astype(np.float32)
    got = text.build_text_classifier(_encode, classes, rows, num_void=num_void)
    want = jax_text.build_text_classifier(_encode, classes, rows, num_void=num_void)
    assert got[1] == want[1] and got[0].dtype == np.float32
    assert np.array_equal(got[0], want[0])
    assert got[0].shape[0] == 7 * 14 + (0 if rows is None else 2)
    cache = text.TextClassifierCache(_encode, num_void=num_void)
    first = cache.get("set", classes, rows)
    assert cache.get("set", classes[:2], rows) is first  # built once per name
    assert np.array_equal(first[0], got[0])


def test_category_overlapping_mask():
    from dvis_plus_tpu.models.ov import text as jax_text
    from dvis_plus_tpu_torch.models.ov import text

    train = text.load_vocabulary_file(os.path.join(PORT_VOCAB, "coco_panoptic_with_prompt_eng.txt"))
    test = text.load_vocabulary_file(os.path.join(PORT_VOCAB, "ytvis19_instance_with_prompt_eng.txt"))[1:]
    got = text.category_overlapping_mask(train, test)
    want = jax_text.category_overlapping_mask(train, test)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert 0 < got.sum() < len(test)


def write_merges(path: str) -> str:
    """A small gzip merges file in the layout of CLIP's
    ``bpe_simple_vocab_16e6.txt.gz`` (a header line, then one merge a
    line), enough to merge the words of the tests' prompts."""
    merges = ["t h", "th e</w>", "a </w>", "o f</w>", "p h", "ph o", "pho t", "phot o</w>",
              "i n</w>", "s c", "sc e", "sce n", "scen e</w>", "c a", "ca t</w>", "d o", "do g</w>",
              "t o", "r e", "e r", "i s</w>", "th is</w>", "h e", "l a", "r g", "la rg", "larg e</w>"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return path


TEXTS = ["a photo of a cat.", "There is the dog in the scene", "This is a photo of a large giant_panda.",
         "A &amp; B, 3 cats!", "  zebra's  tail ", "", "x" * 200]


def test_tokenizer_equals_jax(tmp_path):
    """Byte-level BPE with the merges file, ``<|startoftext|>`` / ``<|endoftext|>``,
    HTML unescaping, lower-casing, truncation to the context length."""
    from dvis_plus_tpu.models.ov.text import SimpleTokenizer as JaxTokenizer
    from dvis_plus_tpu_torch.models.ov.text import SimpleTokenizer

    bpe = write_merges(str(tmp_path / "merges.txt.gz"))
    got = SimpleTokenizer(bpe).tokenize(TEXTS)
    want = JaxTokenizer(bpe).tokenize(TEXTS)
    assert got.dtype == np.int32 and got.shape == (len(TEXTS), 77)
    assert np.array_equal(got, want)
    eot = SimpleTokenizer(bpe).encoder["<|endoftext|>"]
    # the end-of-text id is each row's highest; a row cut at the context
    # length loses it, in both packages
    assert (got[:-1].max(axis=1) == eot).all() and eot not in got[-1]


def test_cli_helpers_equal_jax(tmp_path, monkeypatch):
    """``vocabulary_for`` (the file, the ``invalid_class_id`` row dropped,
    the ``DVIS_OV_VOCAB`` override), ``void_index_for`` (by name, by
    ``ov.test2train``, else None) and ``build_classifier`` (1 void row, or
    every row under merge mode ``max``) give what the JAX CLI's do."""
    import train_net_video_ov as jax_cli
    from dvis_plus_tpu.core.config import load_config
    from dvis_plus_tpu_torch import cli_ov

    for name in ("ytvis_2019_val", "ytvis_2021_val", "ovis_val", "coco_panoptic_video_ov", "lvvis_val",
                 "VSPW_vss_video_val"):
        assert cli_ov.vocabulary_for(name) == jax_cli.vocabulary_for(name), name
    cfg = load_config("configs/ov/ov_online_convnextl_supervised.yaml")
    for name, t2t in (("ovis_train", ""), ("ytvis_2019_val", "ytvis_2019_train"), ("ytvis_2019_val", "")):
        cfg.model.ov.test2train = t2t
        assert cli_ov.void_index_for(cfg, name) == jax_cli.void_index_for(cfg, name)
    for mode in ("coco", "max"):
        cfg.model.ov.void_merge_mode = mode
        got = cli_ov.build_classifier(cfg, "ytvis_2019_val", _encode)
        want = jax_cli.build_classifier(cfg, "ytvis_2019_val", _encode)
        assert got[1] == want[1] and got[2] == want[2] and np.array_equal(got[0], want[0])
        assert got[1][-1] == (5 if mode == "max" else 1)
    vocab = tmp_path / "vocab"
    vocab.mkdir()
    (vocab / "ytvis19_instance_with_prompt_eng.txt").write_text("0:invalid_class_id\n1:cat,kitty\n2:dog\n")
    monkeypatch.setenv("DVIS_OV_VOCAB", str(vocab))
    assert cli_ov.vocabulary_for("ytvis_2019_val") == [["cat", "kitty"], ["dog"]]


def test_cli_ov_refuses_without_text_weights(monkeypatch):
    """Without ``--clip-weights`` and ``--bpe`` the OV CLI stops, as the JAX
    CLI does, unless ``--random-text`` asks for random classifiers."""
    from dvis_plus_tpu_torch import cli_ov

    monkeypatch.delenv("DVIS_CLIP_WEIGHTS", raising=False)
    monkeypatch.delenv("DVIS_CLIP_BPE", raising=False)
    with pytest.raises(SystemExit, match="--random-text"):
        cli_ov.main(["--config-file", "configs/ov/ov_online_convnextl_zeroshot_ytvis19.yaml",
                     "--eval-only", "--device", "cpu"])
