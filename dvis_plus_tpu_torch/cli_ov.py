"""Evaluation CLI of the port's open-vocabulary models (the counterpart of
``train_net_video_ov.py --eval-only``):

    DVIS_DATASETS=<root> python -m dvis_plus_tpu_torch.cli_ov \\
        --config-file configs/ov/ov_online_convnextl_zeroshot_ytvis19.yaml --eval-only \\
        (--clip-weights <open_clip checkpoint> --bpe <bpe_simple_vocab_16e6.txt.gz> | --random-text) \\
        [--device cuda|cpu] [weights=<state_dict .pth/.npz>] [key.path=value ...]

``model.ov.enabled`` is set, and ``model.meta_architecture`` (``minvis``,
``dvis_online``, ``dvis_offline``, or their ``*_ov`` names; ``ctvis``)
picks ``OVSegmenter``, ``DVISOnlineOV`` or ``DVISOfflineOV``
(``models/meta/ov.py``) with the CLIP trunk of the ``clip_*`` backbone
fields. Each test set's text classifier is built on the host from its
prompt-engineered vocabulary (``data/ov_vocab/``, a copy of the JAX
package's files; ``DVIS_OV_VOCAB`` names another directory) through the CLIP
text tower of ``--clip-weights`` (an open_clip state dict, ``.npz`` or a
torch checkpoint) and the tokenizer of ``--bpe``, or, with
``--random-text``, from seeded random vectors (meaningless, for debugging:
seeded by ``hash`` of the prompts, which Python randomizes per process
unless ``PYTHONHASHSEED`` is set, as in the JAX CLI). Without either the
CLI refuses to run. A class seen in any training set (``datasets.train``)
is fused with ``geometric_ensemble_alpha``, the others with ``beta``; a
test set named in ``datasets.train`` or by ``ov.test2train`` takes that
set's private void row. ``test.task=vps`` / ``vss`` route to the panoptic /
semantic loops, anything else to VIS (``results.json``), as in the JAX CLI.
``--device cuda`` (the default) raises when no card is present. The CLI
prints each set's result dict and returns them.

Counterpart: ``train_net_video_ov.py`` (``_VOCAB_BY_DATASET`` :27,
``_ov_arch`` :44, ``_maybe_things_first`` :65, ``vocabulary_for`` :91,
``make_text_encoder`` :118, ``void_index_for`` :173, ``build_classifier``
:187, ``do_eval`` :272). Training is not ported.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from dvis_plus_tpu_torch.models.ov.text import (
    SimpleTokenizer,
    TextClassifierCache,
    category_overlapping_mask,
    load_vocabulary_file,
)

logger = logging.getLogger("dvis_plus_tpu_torch.cli_ov")

_VOCAB_BY_DATASET = {
    # dataset-name prefix -> prompt-engineered vocabulary file
    "ytvis_2019": "ytvis19_instance_with_prompt_eng.txt",
    "ytvis_2021": "ytvis21_instance_with_prompt_eng.txt",
    "ytvis_2022": "ytvis21_instance_with_prompt_eng.txt",
    "ovis": "ovis_instance_with_prompt_eng.txt",
    "coco": "coco_panoptic_with_prompt_eng.txt",
    "panoVSPW": "vipseg_panoptic_with_prompt_eng.txt",
    # VSPW semantic shares VIPSeg's 124-class taxonomy: file row i = shifted
    # dataset id i, the VSS class space (no things-first reorder)
    "VSPW": "vipseg_panoptic_with_prompt_eng.txt",
    "lvvis": "lsvis_instance_with_prompt_eng.txt",
}
VOCAB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "ov_vocab")


def _maybe_things_first(dataset_name: str, classes):
    """Panoptic (vps) sets take a things-first class space, as the panoptic
    top-K decides thing or stuff by ``class < num_things``: the vocabulary
    file's rows (keyed by dataset id) are reordered by the registered
    categories, or, where those disagree with the file (a reduced synthetic
    ground truth), the categories' names are the vocabulary."""
    from dvis_plus_tpu_torch.data.catalog import get_metadata
    from dvis_plus_tpu_torch.data.datasets.vps_vss import panoptic_contiguous_maps

    try:
        md = get_metadata(dataset_name)
    except KeyError:
        return classes
    cats = getattr(md, "categories", None)
    if getattr(md, "evaluator_type", "") != "vps" or not cats:
        return classes
    _, contig_to_dataset, _ = panoptic_contiguous_maps(cats)
    if len(cats) == len(classes) and {c["id"] for c in cats} == set(range(len(classes))):
        return [classes[contig_to_dataset[i]] for i in range(len(classes))]
    by_id = {c["id"]: c for c in cats}
    return [[by_id[contig_to_dataset[i]]["name"]] for i in range(len(cats))]


def vocabulary_for(dataset_name: str):
    """A set's synonym lists: its vocabulary file (the ``invalid_class_id``
    row dropped), else the registered class names."""
    from dvis_plus_tpu_torch.data.catalog import get_metadata

    vocab_dir = os.environ.get("DVIS_OV_VOCAB", VOCAB_DIR)
    for prefix, fname in _VOCAB_BY_DATASET.items():
        if dataset_name.startswith(prefix):
            path = os.path.join(vocab_dir, fname)
            if os.path.exists(path):
                classes = load_vocabulary_file(path)
                if classes and classes[0] and classes[0][0] == "invalid_class_id":
                    classes = classes[1:]
                return _maybe_things_first(dataset_name, classes)
    md = get_metadata(dataset_name)
    names = list(getattr(md, "thing_classes", []) or []) + list(getattr(md, "stuff_classes", []) or [])
    if not names:
        raise ValueError(f"no vocabulary available for {dataset_name}")
    return [[n] for n in names]


def _load_state_dict(path: str):
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict", "module"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    return {k: v.float().numpy() if v.is_floating_point() else v.numpy() for k, v in sd.items()}


def make_text_encoder(cfg, args, device):
    """``encode_fn(prompts) -> (N, Cc)`` float32 numpy embeddings."""
    if args.random_text:
        logger.warning("--random-text: classifiers are random hashes; quality is meaningless")

        def encode_fn(prompts):
            rng = np.random.RandomState(abs(hash(tuple(prompts))) % 2**31)
            return rng.randn(len(prompts), cfg.model.ov.clip_embed_dim).astype(np.float32)

        return encode_fn

    if not args.clip_weights or not args.bpe:
        raise SystemExit(
            "OV requires --clip-weights <open_clip checkpoint> and --bpe "
            "<bpe_simple_vocab_16e6.txt.gz> (or pass --random-text for a "
            "debug run with meaningless classifiers)"
        )
    from dvis_plus_tpu_torch.models.ov.clip_backbone import text_encoder_for, text_state_dict

    enc = text_encoder_for(text_state_dict(_load_state_dict(args.clip_weights))).to(device).eval()
    tokenizer = SimpleTokenizer(args.bpe)

    def encode_fn(prompts):
        with torch.inference_mode():
            tokens = torch.from_numpy(tokenizer.tokenize(prompts)).to(device)
            return enc(tokens).cpu().numpy()

    return encode_fn


def void_index_for(cfg, dataset_name):
    """The private void row a set uses: training set i's row i (by name, or
    by ``ov.test2train``); None: the merged rows (``ov.void_merge_mode``)."""
    train = list(cfg.datasets.train)
    if dataset_name in train:
        return train.index(dataset_name)
    t2t = cfg.model.ov.test2train
    if t2t and t2t in train:
        return train.index(t2t)
    return None


def build_classifier(cfg, dataset_name, encode_fn, void_embeds=None, void_index=None):
    """(text classifier (R, Cc) float32 without the void rows, num_templates
    ending with the count of void rows the model appends, the set's
    synonym lists)."""
    classes = vocabulary_for(dataset_name)
    if void_index is not None or cfg.model.ov.void_merge_mode != "max":
        void_rows = 1
    else:
        void_rows = cfg.model.ov.num_void_embeddings
    cache = TextClassifierCache(encode_fn, num_void=void_rows)
    tc, nt = cache.get(dataset_name, classes, void_embeds)
    return tc, nt, classes


def build_ov_model(cfg) -> torch.nn.Module:
    """The port's open-vocabulary module for ``cfg`` (randomly initialized)."""
    from dvis_plus_tpu_torch.config import ov_arch
    from dvis_plus_tpu_torch.models.meta.ov import DVISOfflineOV, DVISOnlineOV, OVSegmenter

    arch = ov_arch(cfg)
    models = {"minvis_ov": OVSegmenter, "ctvis": OVSegmenter, "dvis_online_ov": DVISOnlineOV,
              "dvis_offline_ov": DVISOfflineOV}
    if arch not in models:
        raise ValueError(f"no open-vocabulary model for {arch!r}")
    return models[arch](cfg.model)


def do_eval(cfg, encode_fn, device) -> dict:
    from dvis_plus_tpu_torch.cli import _eval_vis, _eval_vps, _eval_vss, load_weights
    from dvis_plus_tpu_torch.config import ov_arch
    from dvis_plus_tpu_torch.data.catalog import get_dataset, get_metadata
    from dvis_plus_tpu_torch.data.mapper import mapper_for_type
    from dvis_plus_tpu_torch.engine.ov_inference import ov_video_logits_masks_fn

    cfg.model.meta_architecture = ov_arch(cfg)
    torch.manual_seed(cfg.seed)
    model = build_ov_model(cfg)
    if cfg.weights:
        load_weights(model, cfg.weights)
    model = model.to(device).eval()
    # seen / unseen against the union of every training set's vocabulary
    train_classes = []
    for name in cfg.datasets.train:
        train_classes += vocabulary_for(name)

    results = {}
    types = list(cfg.datasets.dataset_type_test)
    for idx, name in enumerate(cfg.datasets.test):
        vi = void_index_for(cfg, name)
        tc, nt, test_classes = build_classifier(cfg, name, encode_fn, void_index=vi)
        overlap = category_overlapping_mask(train_classes, test_classes)
        fn = ov_video_logits_masks_fn(cfg, model, tc, nt, overlap, void_index=vi)
        mapper = mapper_for_type(cfg, types[idx] if idx < len(types) else "video_instance")
        loader = (mapper(rec, seed=0) for rec in get_dataset(name))
        out_dir = os.path.join(cfg.output_dir, "inference", name)
        run = {"vps": _eval_vps, "vss": _eval_vss}.get(cfg.test.task, _eval_vis)
        res = run(cfg, model, get_metadata(name), loader, out_dir, logits_masks_fn=fn)
        results[name] = {**res, "device": str(device)}
        logger.info("%s: %s", name, results[name])
    print(json.dumps(results, indent=2))
    return results


def main(argv=None) -> dict:
    from dvis_plus_tpu_torch.config import check_supported, load_config
    from dvis_plus_tpu_torch.data.datasets.vps_vss import register_all_vipseg, register_all_vspw
    from dvis_plus_tpu_torch.data.datasets.ytvis import register_all_ytvis

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--eval-only", action="store_true", required=True,
                        help="training is not ported; evaluation only")
    parser.add_argument("--resume", action="store_true", help="read by training only")
    parser.add_argument("--clip-weights", default=os.environ.get("DVIS_CLIP_WEIGHTS", ""))
    parser.add_argument("--bpe", default=os.environ.get("DVIS_CLIP_BPE", ""))
    parser.add_argument("--random-text", action="store_true",
                        help="debug: random text classifiers (meaningless quality)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default) raises without a card; cpu must be asked for")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = load_config(args.config_file, args.opts)
    cfg.model.ov.enabled = True
    check_supported(cfg)  # a setting the port cannot honour raises here
    root = os.environ.get("DVIS_DATASETS", "datasets")
    for register in (register_all_ytvis, register_all_vipseg, register_all_vspw):
        register(root)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    device = torch.device(args.device)
    return do_eval(cfg, make_text_encoder(cfg, args, device), device)


if __name__ == "__main__":
    main()
