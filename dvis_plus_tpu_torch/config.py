"""Configuration of the ported slices: dataclasses, YAML loading and
YAML-free presets.

Counterpart: ``dvis_plus_tpu/core/config.py`` (the dataclasses :31-370 and
``load_config`` :453). The dataclasses below hold only the fields the port
reads, under the JAX package's names and defaults. :func:`load_config`
follows a YAML's ``_BASE_`` chain and applies dotted ``key.path=value``
overrides as the JAX package's does; a key the port has no field for
(``solver``, training input, the criterion) is kept as a plain attribute or
namespace, so any of the repository's YAMLs loads. PyYAML is imported inside
the function: a GPU machine may have none, and there the presets serve.
:func:`check_supported` then holds a loaded configuration to what the port
does: a setting it cannot honour raises ``NotImplementedError`` (the CLI and
``run_vis_inference`` call it), so no entry point gives way silently;
:func:`check_trainable` does the same for training (the CLI without
``--eval-only``).

The presets hold the values ``load_config`` resolves for their YAML:
``configs/dvis/minvis_r50_ytvis19.yaml`` (base_video),
``configs/dvis/ctvis_r50_ytvis19.yaml`` (minvis -> base_video),
``configs/dvis/video_maskformer_r50_ytvis19.yaml`` (base_video),
``configs/dvis/{maskformer_r50_coco,video_maskformer_r50_coco_joint}.yaml``
(base_video), ``configs/dvis/{minvis,ctvis}_vitl_ytvis19.yaml`` (their R50
YAMLs),
``configs/dvis/dvis_online_r50_ytvis19.yaml`` (ctvis -> minvis ->
base_video), ``configs/dvis/dvis_online_r50_{vipseg,vspw}.yaml`` (vspw ->
vipseg -> dvis_online_r50_ytvis19), ``configs/dvis/dvis_offline_swinl_ytvis19.yaml``
(dvis_online_swinl -> dvis_online_r50 -> ...),
``configs/dvis/dvis_offline_vitl_ytvis19.yaml`` (dvis_online_vitl ->
dvis_online_r50 -> ...) and ``configs/daq/daq_online_r50_ytvis19.yaml`` /
``daq_offline_r50_ovis.yaml`` (daq_online_r50_ovis -> dvis_online_r50_ovis
-> dvis_online_r50_ytvis19 -> ...), but for the ReID branch the DAQ YAMLs
inherit and no DAQ model can use (see :func:`daq_online_r50_ytvis19`), and
``configs/ov/ov_{online,minvis,offline}_convnextl_zeroshot_ytvis19.yaml``
(ov_online_convnextl_coco -> base_video; fcclip_convnextl_coco;
ov_offline_convnextl_coco).
``tests/test_torch_config.py`` holds each preset equal to its YAML field by
field, and this ``load_config`` equal to the JAX package's.
"""
from __future__ import annotations

import os
import typing
from dataclasses import dataclass, field, fields, is_dataclass
from types import SimpleNamespace
from typing import Any, Dict, Iterable, List, Optional, Tuple


@dataclass
class BackboneConfig:
    # resnet50 | resnet101 | swin_{t,s,b,l} | another swin_* name | vit_adapter_dinov2
    name: str = "resnet50"
    out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    # Swin widths: read only for a swin_* name outside swin_{t,s,b,l}
    swin_embed_dim: int = 96
    swin_depths: Tuple[int, ...] = (2, 2, 6, 2)
    swin_num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    swin_window_size: int = 7
    swin_mlp_ratio: float = 4.0
    swin_drop_path_rate: float = 0.3  # training: stochastic depth, 0 to this over the blocks
    swin_patch_size: int = 4
    swin_qkv_bias: bool = True
    swin_fast_softmax: bool = False  # bf16 attention scores: not ported (raises)
    swin_fused_attn: bool = False  # eval: both values run kernel B2 on CUDA; training the plain op
    # ViT-Adapter (DINOv2); the trunk runs on a stride-16 grid whatever
    # vit_patch_size says, as in the JAX package
    vit_embed_dim: int = 1024
    vit_depth: int = 24
    vit_num_heads: int = 16
    vit_patch_size: int = 14
    vit_interaction_indexes: Tuple[Tuple[int, int], ...] = ((0, 5), (6, 11), (12, 17), (18, 23))
    vit_conv_inplane: int = 64
    vit_deform_num_heads: int = 16
    vit_n_points: int = 4
    vit_with_cffn: bool = True
    vit_deform_ratio: float = 0.5
    vit_frozen: bool = True  # training: the DINOv2 trunk is fixed (the reference's frozen trunk)
    vit_flash_attention: bool = False  # serving: trunk attention through kernel B3
    vit_extractor_coarse: bool = False  # serving: coarse stride-8 extractor queries
    # CLIP trunks of the open-vocabulary models (clip_* names): read when
    # model.ov.enabled, whatever the name says, as in the JAX package
    clip_model_type: str = "convnext"  # convnext | resnet (ModifiedResNet)
    clip_depths: Tuple[int, ...] = (3, 3, 27, 3)  # ConvNeXt-L; RN50: (3, 4, 6, 3)
    clip_dims: Tuple[int, ...] = (192, 384, 768, 1536)
    clip_resnet_width: int = 64  # RN50 stem width (res5 = 32x)
    clip_attnpool_spacial: int = 7  # the attention pool's table: input_resolution // 32


@dataclass
class PixelDecoderConfig:
    conv_dim: int = 256
    mask_dim: int = 256
    transformer_nheads: int = 8
    transformer_dim_feedforward: int = 1024
    transformer_enc_layers: int = 6
    transformer_in_features: Tuple[str, ...] = ("res3", "res4", "res5")
    num_points: int = 4
    msdeform_value_dtype: str = "float32"
    island_dtype: str = "float32"
    msdeform_impl: str = "exact"  # exact | pallas_local (radius-7 clamp)


@dataclass
class TransformerDecoderConfig:
    hidden_dim: int = 256
    num_queries: int = 100
    nheads: int = 8
    dim_feedforward: int = 2048
    dec_layers: int = 9
    mask_dim: int = 256
    reid_branch: bool = False
    reid_hidden_dim: int = 512


@dataclass
class TrackerConfig:
    num_layers: int = 6
    feedforward_dim: int = 2048
    num_heads: int = 8
    matcher_solver: str = "auction"  # auction | jv
    noise_mode: str = "hard"  # training: none | rs | wa | cc ('hard' reads as 'wa')
    noise_ratio: float = 0.5  # training: share of non-first frames noised


@dataclass
class RefinerConfig:
    num_layers: int = 6
    feedforward_dim: int = 2048
    num_heads: int = 8
    window_size: int = 5


@dataclass
class DAQConfig:
    """DVIS-DAQ's Video Instance Cutter (the JAX package's ``DAQConfig``,
    every field a YAML under ``configs/daq/`` sets). The curriculum and
    training thresholds are read only by training."""

    num_new_ins: int = 10
    num_slots: int = 5
    offline_topk_num: int = 20
    mask_nms_thr: float = 0.6
    match_score_thr: float = 0.3
    inference_select_thr: float = 0.1
    aux_inference_select_thr: float = 0.01  # the first frame's segmenter scores
    training_select_thr: float = 0.1
    keep_threshold: float = 0.01  # slot-branch survival gate (ovis_infer)
    noise_frame_num: int = 1  # sequences shorter than this that end early are dropped
    kick_out_frame_num: int = 8  # a track missed this many frames in a row leaves the table
    ovis_infer: bool = False
    max_num_instances: int = 50  # capacity of the slot table
    using_frame_num: Tuple[int, ...] = ()
    steps: Tuple[int, ...] = ()
    increasing_step: Tuple[int, ...] = (8000,)


@dataclass
class OVConfig:
    """The open-vocabulary head (the JAX package's ``OVConfig`` but for
    ``ensemble_on_valid_mask``, which nothing there reads)."""

    enabled: bool = False
    geometric_ensemble_alpha: float = 0.4  # classes seen in training
    geometric_ensemble_beta: float = 0.8  # the others
    clip_embed_dim: int = 768
    test2train: str = ""  # the training set whose private void row a test set takes
    num_void_embeddings: int = 1  # one learned void row a training dataset
    void_merge_mode: str = "coco"  # coco | mean | max: the rows of a set with none of its own


@dataclass
class CriterionConfig:
    """The set criterion and its matchers (training only)."""

    deep_supervision: bool = True
    no_object_weight: float = 0.1
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    reid_weight: float = 2.0
    aux_reid_weight: float = 3.0
    train_num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    max_num_instances: int = 50  # padded ground-truth capacity of a clip
    matcher_solver: str = "jv"  # jv (exact, scipy) | auction


@dataclass
class ModelConfig:
    meta_architecture: str = "minvis"
    num_classes: int = 40
    compute_dtype: str = "bfloat16"
    size_divisibility: int = 32
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    pixel_decoder: PixelDecoderConfig = field(default_factory=PixelDecoderConfig)
    transformer_decoder: TransformerDecoderConfig = field(
        default_factory=TransformerDecoderConfig
    )
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    refiner: RefinerConfig = field(default_factory=RefinerConfig)
    daq: DAQConfig = field(default_factory=DAQConfig)
    ov: OVConfig = field(default_factory=OVConfig)
    criterion: CriterionConfig = field(default_factory=CriterionConfig)
    param_dtype: str = "float32"  # parameters and optimizer state
    freeze: Tuple[str, ...] = ()  # training: components kept fixed, e.g. ("segmenter",)


@dataclass
class SolverConfig:
    """AdamW with the reference's groups, warmup multi-step schedule and the
    full-model gradient clip (training only)."""

    ims_per_batch: int = 8  # clips a step
    base_lr: float = 1e-4
    max_iter: int = 40000
    warmup_iters: int = 10
    warmup_factor: float = 1.0
    steps: Tuple[int, ...] = (26000,)
    gamma: float = 0.1
    weight_decay: float = 0.05
    backbone_multiplier: float = 0.1
    clip_gradients_value: float = 0.01
    amp: bool = True  # the compute dtype is model.compute_dtype either way
    checkpoint_period: int = 5000


@dataclass
class InputConfig:
    sampling_frame_num: int = 5
    sampling_frame_range: int = 2
    sampling_frame_shuffle: bool = False
    sampling_interval: int = 1
    min_size_train: Tuple[int, ...] = (360, 480)  # one chosen a clip
    max_size_train: int = 768
    min_size_test: int = 480
    max_size_test: int = 768
    crop_enabled: bool = False
    random_flip: str = "flip_by_clip"  # any value but "none" flips a whole clip
    augmentations: Tuple[str, ...] = ()
    image_format: str = "RGB"
    pseudo: bool = False  # COCO pseudo-videos: read by nothing, the image_instance sets make them
    lsj_aug: bool = False  # pseudo-videos: large-scale jitter instead of the shortest-edge resize


@dataclass
class DatasetsConfig:
    train: Tuple[str, ...] = ("ytvis_2019_train",)  # OV eval: the seen vocabulary, void rows
    test: Tuple[str, ...] = ("ytvis_2019_val",)
    dataset_ratio: Tuple[float, ...] = (1.0,)
    dataset_need_map: Tuple[bool, ...] = (False,)
    dataset_type: Tuple[str, ...] = ("video_instance",)
    dataset_type_test: Tuple[str, ...] = ("video_instance",)


@dataclass
class TestConfig:
    task: str = "vis"  # vis | vps | vss | vos | mots (the CLI routes by it and by the dataset type)
    object_mask_threshold: float = 0.0  # VPS: a query is kept above this score
    overlap_threshold: float = 0.8  # VPS: least share of a query's mask it keeps
    window_size: int = 5
    max_num: int = 20
    offline_mf_budget_gb: float = 4.0
    eval_pipeline: bool = True  # post-processing on a worker thread, loader prefetched
    mask_download: str = "runs"  # runs | packed (engine/inference.py::paged_inference_video)
    rle_col_k: int = 8  # per-column change capacity of the runs download


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    input: InputConfig = field(default_factory=InputConfig)
    datasets: DatasetsConfig = field(default_factory=DatasetsConfig)
    test: TestConfig = field(default_factory=TestConfig)
    output_dir: str = "./output"
    seed: int = 42
    weights: str = ""  # state dict to load (.npz or a torch checkpoint)


# ---------------------------------------------------------------------------
# YAML loading with _BASE_ inheritance and dotted overrides
# ---------------------------------------------------------------------------


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_yaml_chain(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    base_rel = data.pop("_BASE_", None)
    if base_rel is not None:
        data = _deep_merge(_load_yaml_chain(os.path.join(os.path.dirname(path), base_rel)), data)
    return data


def _coerce(value: Any, typ: Any) -> Any:
    """Coerce a YAML or command-line value into a field's declared type."""
    origin = typing.get_origin(typ)
    if origin is tuple:
        args = typing.get_args(typ)
        elem = args[0] if args else Any
        if isinstance(value, str):
            value = [v for v in value.strip("()[]").split(",") if v != ""]
        if elem is Any or elem is Ellipsis:
            return tuple(value)
        return tuple(_coerce(v, elem) for v in value)
    if typ is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if typ in (int, float, str):
        return typ(value)
    return value


def _field_type(node: Any, name: str) -> Any:
    return typing.get_type_hints(type(node))[name]


def _set(node: Any, key: str, value: Any) -> None:
    """Set one key on a config node: a declared field is coerced to its type;
    anything else (a section or key the port never reads) is kept as it is,
    dictionaries as namespaces."""
    if is_dataclass(node) and key in {f.name for f in fields(node)}:
        cur = getattr(node, key)
        if is_dataclass(cur) and isinstance(value, dict):
            for k, v in value.items():
                _set(cur, k.lower(), v)
        else:
            setattr(node, key, _coerce(value, _field_type(node, key)))
    elif isinstance(value, dict):
        cur = getattr(node, key, None)
        if not isinstance(cur, SimpleNamespace):
            cur = SimpleNamespace()
            setattr(node, key, cur)
        for k, v in value.items():
            _set(cur, k.lower(), v)
    else:
        setattr(node, key, value)


def load_config(path: Optional[str] = None, overrides: Optional[List[str]] = None) -> Config:
    """Build a Config from an optional YAML (with ``_BASE_`` chaining) plus
    ``key.path=value`` overrides."""
    import yaml

    cfg = Config()
    if path:
        for k, v in _load_yaml_chain(path).items():
            _set(cfg, k.lower(), v)
    return apply_overrides(cfg, overrides or [])


def apply_overrides(cfg: Config, overrides: Iterable[str]) -> Config:
    """Set ``key.path=value`` overrides (values parsed as YAML) on ``cfg``."""
    import yaml

    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must be key.path=value, got: {ov}")
        key, _, value = ov.partition("=")
        try:
            parsed = yaml.safe_load(value)
        except yaml.YAMLError:
            parsed = value
        *sections, leaf = key.strip().lower().split(".")
        node = cfg
        for p in sections:
            if not hasattr(node, p):
                setattr(node, p, SimpleNamespace())
            node = getattr(node, p)
        _set(node, leaf, parsed)
    return cfg


# ---------------------------------------------------------------------------
# What the port honours
# ---------------------------------------------------------------------------


_ABSENT = object()


def _lookup(cfg: Any, path: str) -> Any:
    for part in path.split("."):
        cfg = getattr(cfg, part, _ABSENT)
        if cfg is _ABSENT:
            return _ABSENT
    return cfg


OV_ARCHS = ("minvis_ov", "dvis_online_ov", "dvis_offline_ov")


def is_ov(cfg) -> bool:
    """An open-vocabulary configuration: ``model.ov.enabled`` or a ``*_ov``
    architecture (``train_net_video_ov.py::_ov_arch``)."""
    return (_lookup(cfg, "model.ov.enabled") is True
            or str(_lookup(cfg, "model.meta_architecture")).endswith("_ov"))


def ov_arch(cfg) -> str:
    """The open-vocabulary model of ``model.meta_architecture``
    (``train_net_video_ov.py::_ov_arch``): ``minvis``, ``dvis_online`` and
    ``dvis_offline`` become their ``*_ov`` forms when ``model.ov.enabled``;
    ``ctvis`` and the ``*_ov`` names stay."""
    arch = cfg.model.meta_architecture
    if cfg.model.ov.enabled and not arch.endswith("_ov"):
        arch = {"minvis": "minvis_ov", "dvis_online": "dvis_online_ov",
                "dvis_offline": "dvis_offline_ov"}.get(arch, arch)
    return arch


def _ported_backbone(name, cfg) -> bool:
    """The CLIP trunks (``clip_*``) serve the open-vocabulary models only."""
    if str(name).startswith("clip"):
        return is_ov(cfg)
    return name in ("resnet50", "resnet101", "vit_adapter_dinov2") or str(name).startswith("swin")


def _ported_ov(enabled, cfg) -> bool:
    """Open vocabulary runs the CLIP trunks (the JAX package builds one from
    the ``clip_*`` fields whatever ``backbone.name`` says, so the port asks
    for a ``clip_*`` name) and no DVIS-DAQ model (the JAX package has no DAQ
    OV model)."""
    if not enabled:
        return True
    arch = str(_lookup(cfg, "model.meta_architecture"))
    return str(_lookup(cfg, "model.backbone.name")).startswith("clip") and not arch.startswith("daq_")


def _eval_dataset_types(types, cfg) -> bool:
    from dvis_plus_tpu_torch.data.mapper import EVAL_DATASET_TYPES

    return all(t in EVAL_DATASET_TYPES for t in types)


def _ported_task(task, cfg) -> bool:
    """VOS and MOTS run through the DAQ eval loop, which needs the cutter's
    ``segment_only`` (``train_net_video.py::run_task_eval`` sends both tasks
    there whatever the architecture), so they run only with a ``daq_*``
    architecture, in the JAX package as here."""
    if task in ("vis", "vps", "vss"):
        return True
    arch = str(_lookup(cfg, "model.meta_architecture"))
    return task in ("vos", "mots") and arch.startswith("daq_")


# (key path, the values the port honours (a tuple, or a predicate of the
# value and the whole configuration), the ROADMAP item that lifts the
# limit). One place to shrink as later slices land. A key that is absent is at the
# JAX package's default, which every row honours. Keys that cannot change an
# eval result (``solver.*``, the training input and datasets, the criterion,
# ``parallel.*``, profiling and compile-cache directories) are not listed:
# training reads them, and :data:`TRAINABLE` holds them there.
SUPPORTED = (
    ("model.meta_architecture",
     ("dvis_online", "dvis_offline", "minvis", "ctvis", "video_maskformer", "maskformer",
      "daq_online", "daq_offline") + OV_ARCHS,
     "A13 (open vocabulary: minvis, dvis_online and dvis_offline; A12: no daq_* OV model)"),
    ("model.backbone.name", _ported_backbone,
     "A13 (the clip_* trunks serve the open-vocabulary models only)"),
    ("model.backbone.clip_model_type", ("convnext", "resnet"), "A13 (the CLIP trunk families)"),
    ("model.backbone.swin_fast_softmax", (False,), "queue A, small pieces left open (bf16 scores)"),
    ("model.sem_seg_head", ("mask_former",),
     "A13 (read by nothing: the FC-CLIP head comes with model.ov.enabled)"),
    ("model.pixel_decoder.name", ("msdeform",), "A6 (FPNPixelDecoder)"),
    ("model.ov.enabled", _ported_ov,
     "A13 (open vocabulary runs a clip_* backbone; A12: the JAX package has no DAQ OV model)"),
    ("test.task", _ported_task,
     "A12: vos and mots run through the DAQ eval loop, so only with a daq_* architecture"),
    ("datasets.dataset_type_test", _eval_dataset_types,
     "A14c.5 (image_panoptic: the COCO panoptic pseudo-video mapper)"),
    ("test.refiner_shard_devices", (0, 1), "A15 (the object-sharded refiner pass)"),
    ("test.eval_devices", (1,), "A15 (video-parallel eval)"),
)

def _trunk_attention_trains(flash, cfg) -> bool:
    """An unfrozen ViT trunk trains through its dense attention: B3 is
    forward only, and its wrapper raises under gradients. A frozen trunk runs
    without gradients, so B3 serves it."""
    b = cfg.model.backbone
    segmenter_frozen = (cfg.model.meta_architecture in ("dvis_online", "dvis_offline", "daq_online",
                                                        "daq_offline")
                        and "segmenter" in cfg.model.freeze)
    return not (flash and b.name == "vit_adapter_dinov2" and not b.vit_frozen
                and not segmenter_frozen)


def _trains_images(cfg) -> bool:
    return "image_instance" in tuple(cfg.datasets.dataset_type)


PSEUDO_AUGMENTATIONS = ("brightness", "contrast", "saturation")


def _ctvis_weight(default: float):
    """Only CTVIS reads ``reid_weight`` / ``aux_reid_weight``; DVIS++ online
    and offline weigh their ReID losses 2 and 3 in the code, so another value
    there would be dropped silently (in the JAX package too)."""
    return lambda w, cfg: cfg.model.meta_architecture == "ctvis" or w == default


TRAIN_DATASET_TYPES = ("video_instance", "image_instance", "video_panoptic", "video_semantic",
                       "video_sot")

# What training honours, in the form of :data:`SUPPORTED` (the eval rows hold
# too): DVIS++ online and offline, MinVIS and CTVIS on every ported backbone,
# Mask2Former and Video Mask2Former, DVIS-DAQ online and offline, on video
# instance, panoptic, semantic and class-agnostic object sets and COCO
# pseudo-videos.
TRAINABLE = (
    ("model.meta_architecture",
     ("dvis_online", "dvis_offline", "minvis", "ctvis", "maskformer", "video_maskformer",
      "daq_online", "daq_offline"),
     "A14c.5 (open-vocabulary training)"),
    ("model.ov.enabled", (False,), "A14c.5 (open-vocabulary training)"),
    ("model.backbone.vit_flash_attention", _trunk_attention_trains,
     "queue B (B3 is forward only: an unfrozen ViT trunk trains with vit_flash_attention=false)"),
    ("model.param_dtype", ("float32",), "A14b (fp32 parameters and optimizer state)"),
    ("model.tracker.noise_mode", ("none", "rs", "wa", "cc", "hard"), "A14b (the noiser's modes)"),
    ("model.criterion.matcher_solver", ("jv", "auction"), "A14b (the matchers' solvers)"),
    ("datasets.dataset_type", lambda types, cfg: all(t in TRAIN_DATASET_TYPES for t in types),
     "A14c.5 (image_panoptic: the COCO panoptic pseudo-video mapper)"),
    # the pseudo-video recipe's inputs: the image_instance mapper alone reads
    # them (in the JAX package too), so without such a set they would be
    # dropped silently
    ("input.pseudo", lambda v, cfg: not v or _trains_images(cfg),
     "A14c.2 (read by nothing: the image_instance sets make the pseudo-videos)"),
    ("input.lsj_aug", lambda v, cfg: not v or _trains_images(cfg),
     "A14c.2 (read by the image_instance mapper alone)"),
    ("input.augmentations",
     lambda v, cfg: not v or (_trains_images(cfg) and set(v) <= set(PSEUDO_AUGMENTATIONS)),
     "A14c.2 (brightness, contrast and saturation, read by the image_instance mapper alone)"),
    ("parallel.model_parallel_size", (1,), "A15 (training on more than one device)"),
    # read by nothing, in the JAX package either: a value but the default
    # would be dropped silently
    ("model.criterion.deep_supervision", (True,), "A14b (every layer is supervised)"),
    ("model.criterion.reid_weight", _ctvis_weight(2.0), "A14c (read by CTVIS alone; DVIS++'s is 2)"),
    ("model.criterion.aux_reid_weight", _ctvis_weight(3.0), "A14c (read by CTVIS alone; DVIS++'s is 3)"),
    ("input.sampling_interval", (1,), "A14b (clips are sampled by sampling_frame_range)"),
    ("input.image_format", ("RGB",), "A14b (frames are read as RGB)"),
    ("solver.amp", (True,), "A14b (the compute dtype is model.compute_dtype)"),
)


def check_trainable(cfg: Any) -> None:
    """:func:`check_supported`, then the same for :data:`TRAINABLE`: raise
    ``NotImplementedError`` naming every key whose value training cannot
    honour, a DVIS-DAQ model with the ReID branch, and more than one
    process (``WORLD_SIZE``)."""
    check_supported(cfg)
    faults = _faults(cfg, TRAINABLE)
    if str(_lookup(cfg, "model.meta_architecture")).startswith("daq_") and \
            _lookup(cfg, "model.transformer_decoder.reid_branch") is True:
        # no DAQ model builds with it, in the JAX package either
        faults.append("model.transformer_decoder.reid_branch=True builds no DVIS-DAQ model (the "
                      "cutter takes the segmenter's C-wide queries, the ReID branch makes them 2C "
                      "wide); set model.transformer_decoder.reid_branch=false")
    if int(os.environ.get("WORLD_SIZE", "1")) != 1:
        faults.append(f"WORLD_SIZE={os.environ['WORLD_SIZE']} is not ported "
                      "(ROADMAP A15 (training on more than one device))")
    if faults:
        raise NotImplementedError("training cannot honour: " + "; ".join(faults))


def check_supported(cfg: Any) -> None:
    """Raise ``NotImplementedError`` naming every key of ``cfg`` whose value
    asks for something the port does not do (:data:`SUPPORTED`), with the
    value and the ROADMAP item that will lift the limit. ``cfg`` is a
    :class:`Config` or any object with the same attribute paths."""
    faults = _faults(cfg, SUPPORTED)
    if faults:
        raise NotImplementedError("the port cannot honour: " + "; ".join(faults))


def _faults(cfg: Any, table) -> list:
    faults = []
    for key, honours, item in table:
        value = _lookup(cfg, key)
        if value is _ABSENT:
            continue
        if honours(value, cfg) if callable(honours) else value in honours:
            continue
        faults.append(f"{key}={value!r} is not ported (ROADMAP {item})")
    return faults


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------


def minvis_r50_ytvis19() -> Config:
    """MinVIS, ResNet-50, YouTube-VIS 2019 (40 classes): the bare segmenter,
    its queries aligned frame to frame after the forward."""
    return Config()


def ctvis_r50_ytvis19() -> Config:
    """CTVIS, ResNet-50, YouTube-VIS 2019: MinVIS with the ReID branch (the
    embeddings it aligns are concat(decoder-normed, ReID MLP))."""
    cfg = minvis_r50_ytvis19()
    cfg.model.meta_architecture = "ctvis"
    cfg.model.transformer_decoder.reid_branch = True
    cfg.solver.max_iter, cfg.solver.base_lr = 32000, 5e-5
    return cfg


def video_maskformer_r50_ytvis19() -> Config:
    """Video Mask2Former, ResNet-50, YouTube-VIS 2019: one clip-joint
    forward over the whole video."""
    cfg = Config()
    cfg.model.meta_architecture = "video_maskformer"
    cfg.input.sampling_frame_num = 2
    return cfg


def maskformer_r50_coco() -> Config:
    """Mask2Former, ResNet-50, on COCO pseudo-videos of one frame
    (``coco2ytvis2019_train``, 80 classes): the segmenter's image
    pretraining."""
    cfg = Config()
    cfg.model.meta_architecture = "maskformer"
    cfg.model.num_classes = 80
    cfg.datasets.train = ("coco2ytvis2019_train",)
    cfg.datasets.dataset_type = ("image_instance",)
    cfg.input.sampling_frame_num = 1
    return cfg


def video_maskformer_r50_coco_joint() -> Config:
    """Video Mask2Former, ResNet-50, on COCO pseudo-videos of two rotated
    frames (``coco2ytvis2019_train``, 80 classes)."""
    cfg = maskformer_r50_coco()
    cfg.model.meta_architecture = "video_maskformer"
    cfg.input.sampling_frame_num = 2
    return cfg


def minvis_vitl_ytvis19() -> Config:
    """MinVIS, DINOv2 ViT-L with the ViT-Adapter (the trunk frozen in
    training), Q = 200, YouTube-VIS 2019."""
    cfg = minvis_r50_ytvis19()
    cfg.model.backbone = BackboneConfig(name="vit_adapter_dinov2")
    cfg.model.transformer_decoder.num_queries = 200
    return cfg


def ctvis_vitl_ytvis19() -> Config:
    """CTVIS, DINOv2 ViT-L with the ViT-Adapter, Q = 200, the 512-wide ReID
    branch, YouTube-VIS 2019."""
    cfg = ctvis_r50_ytvis19()
    cfg.model.backbone = BackboneConfig(name="vit_adapter_dinov2")
    cfg.model.transformer_decoder.num_queries = 200
    return cfg


def dvis_online_r50_ytvis19() -> Config:
    """DVIS++ online, ResNet-50, YouTube-VIS 2019 (40 classes). Training
    freezes the segmenter and trains the tracker for 20,000 steps (the base
    learning rate 5e-5 comes from the CTVIS YAML it inherits)."""
    cfg = ctvis_r50_ytvis19()
    cfg.model.meta_architecture = "dvis_online"
    cfg.model.freeze = ("segmenter",)
    cfg.solver.max_iter = 20000
    return cfg


# The trainable architectures at small widths, fp32: the port's training
# tests and ``chip_smoke.py``'s small training phases train at these, as
# overrides of a YAML or of :func:`tiny`'s preset.
TINY_TRAIN = (
    "model.compute_dtype=float32",
    "model.pixel_decoder.conv_dim=32", "model.pixel_decoder.mask_dim=32",
    "model.pixel_decoder.transformer_enc_layers=1", "model.pixel_decoder.transformer_dim_feedforward=64",
    "model.pixel_decoder.transformer_nheads=4",
    "model.transformer_decoder.hidden_dim=32", "model.transformer_decoder.mask_dim=32",
    "model.transformer_decoder.num_queries=8", "model.transformer_decoder.nheads=4",
    "model.transformer_decoder.dim_feedforward=64", "model.transformer_decoder.dec_layers=2",
    "model.transformer_decoder.reid_hidden_dim=32",
    "model.tracker.num_layers=2", "model.tracker.feedforward_dim=64", "model.tracker.num_heads=4",
    "model.refiner.num_layers=2", "model.refiner.feedforward_dim=64", "model.refiner.num_heads=4",
    "model.criterion.train_num_points=256", "model.criterion.max_num_instances=4",
)


def dvis_online_r50_vipseg() -> Config:
    """DVIS++ online, ResNet-50, VIPSeg video panoptic segmentation: 124
    classes, 720p test input (shorter edge 720, longer at most 1280)."""
    cfg = dvis_online_r50_ytvis19()
    cfg.model.num_classes = 124
    cfg.datasets.train = ("panoVSPW_vps_video_train",)
    cfg.datasets.test = ("panoVSPW_vps_video_val",)
    cfg.datasets.dataset_type = cfg.datasets.dataset_type_test = ("video_panoptic",)
    cfg.test.task = "vps"
    cfg.input.min_size_test, cfg.input.max_size_test = 720, 1280
    cfg.input.min_size_train, cfg.input.max_size_train = (480, 720), 1280
    return cfg


def dvis_online_r50_vspw() -> Config:
    """DVIS++ online, ResNet-50, VSPW video semantic segmentation: the VIPSeg
    model's widths and input size on VSPW's 124 classes."""
    cfg = dvis_online_r50_vipseg()
    cfg.datasets.train = ("VSPW_vss_video_train",)
    cfg.datasets.test = ("VSPW_vss_video_val",)
    cfg.datasets.dataset_type = cfg.datasets.dataset_type_test = ("video_semantic",)
    cfg.test.task = "vss"
    return cfg


def dvis_offline_r50_ytvis19() -> Config:
    """DVIS++ offline, ResNet-50, YouTube-VIS 2019 (stage 3 of the recipe):
    the online R50 stack, frozen, plus the 6-layer temporal refiner, trained
    on clips of 15 frames."""
    cfg = dvis_online_r50_ytvis19()
    cfg.model.meta_architecture = "dvis_offline"
    _offline_training(cfg)
    return cfg


def tiny(arch: str, *overrides: str) -> Config:
    """``arch``'s preset of :data:`TRAIN_PRESETS` at the widths of
    :data:`TINY_TRAIN`, then ``overrides``."""
    return apply_overrides(TRAIN_PRESETS[arch](), (*TINY_TRAIN, *overrides))


def dvis_offline_swinl_ytvis19() -> Config:
    """DVIS++ offline, Swin-L (window 12), YouTube-VIS 2019: the online
    Swin-L stack with Q = 200 plus the 6-layer temporal refiner."""
    cfg = dvis_online_r50_ytvis19()
    m = cfg.model
    m.meta_architecture = "dvis_offline"
    m.backbone = BackboneConfig(
        name="swin_l", swin_embed_dim=192, swin_depths=(2, 2, 18, 2),
        swin_num_heads=(6, 12, 24, 48), swin_window_size=12,
    )
    m.transformer_decoder.num_queries = 200
    _offline_training(cfg)
    return cfg


def _offline_training(cfg: Config) -> None:
    """The offline YAMLs' training: segmenter and tracker frozen, clips of 15
    frames drawn within 7 of a reference frame."""
    cfg.model.freeze = cfg.model.freeze + ("tracker",)
    cfg.input.sampling_frame_num, cfg.input.sampling_frame_range = 15, 7


def dvis_offline_vitl_ytvis19() -> Config:
    """DVIS++ offline, DINOv2 ViT-L with the ViT-Adapter (every ``vit_*``
    default is the ViT-L width), YouTube-VIS 2019: Q = 200, ReID branch,
    6-layer temporal refiner."""
    cfg = dvis_online_r50_ytvis19()
    m = cfg.model
    m.meta_architecture = "dvis_offline"
    m.backbone = BackboneConfig(name="vit_adapter_dinov2")
    m.transformer_decoder.num_queries = 200
    _offline_training(cfg)
    return cfg


def daq_online_r50_ytvis19() -> Config:
    """DVIS-DAQ online, ResNet-50, YouTube-VIS 2019 (40 classes): the R50
    segmenter (Q = 100) and the 6-layer Video Instance Cutter with a slot
    table of 50 tracks, 100 new-instance queries and 5 background slots,
    the slot branch gating survival (``ovis_infer``), kick-out after 8
    missed frames.

    One field differs from what ``load_config`` resolves for
    ``configs/daq/daq_online_r50_ytvis19.yaml``: the YAML inherits
    ``transformer_decoder.reid_branch: true`` from the DVIS++ chain, which
    makes the segmenter's queries 2C wide where the cutter takes C (the JAX
    package fails on it when it builds the model, and so does the port);
    the reference DVIS-DAQ segmenter has no ReID branch, and the Swin-L and
    ViT-L DAQ YAMLs turn it off. Here it is off."""
    cfg = dvis_online_r50_ytvis19()
    m = cfg.model
    m.meta_architecture = "daq_online"
    m.transformer_decoder.reid_branch = False
    m.daq = DAQConfig(num_new_ins=100, num_slots=5, max_num_instances=50, kick_out_frame_num=8,
                      ovis_infer=True, mask_nms_thr=0.6, using_frame_num=(3, 5), steps=(10000,))
    cfg.solver.max_iter = 40000
    return cfg


def daq_offline_r50_ovis() -> Config:
    """DVIS-DAQ offline, ResNet-50, OVIS (25 classes): the online cutter of
    :func:`daq_online_r50_ytvis19`, then the 6-layer temporal refiner over
    the 20 best sequences (``configs/daq/daq_offline_r50_ovis.yaml``, with
    ``reid_branch`` off for the reason given there)."""
    cfg = daq_online_r50_ytvis19()
    m = cfg.model
    m.meta_architecture = "daq_offline"
    m.num_classes = 25
    m.daq.offline_topk_num = 20
    m.freeze = ("segmenter", "cutter")
    cfg.input.sampling_frame_num, cfg.input.sampling_frame_range = 15, 7
    cfg.datasets.train = ("ovis_train",)
    cfg.datasets.test = ("ovis_val",)
    return cfg


# each trainable architecture's R50 preset: the three stages of the DVIS++
# recipe on YouTube-VIS 2019 (stage 1 MinVIS or CTVIS, 2 online, 3 offline),
# the COCO pseudo-video pretraining (Mask2Former, Video Mask2Former) and
# DVIS-DAQ online and offline
TRAIN_PRESETS = {"minvis": minvis_r50_ytvis19, "ctvis": ctvis_r50_ytvis19,
                 "dvis_online": dvis_online_r50_ytvis19, "dvis_offline": dvis_offline_r50_ytvis19,
                 "maskformer": maskformer_r50_coco, "video_maskformer": video_maskformer_r50_coco_joint,
                 "daq_online": daq_online_r50_ytvis19, "daq_offline": daq_offline_r50_ovis}


def ov_online_convnextl_zeroshot_ytvis19() -> Config:
    """OV-DVIS++ online, CLIP ConvNeXt-L (depths (3, 3, 27, 3), widths 192 to
    1536, CLIP embedding 768), zero-shot on YouTube-VIS 2019: trained on COCO
    panoptic pseudo-videos (133 classes, the seen vocabulary), evaluated
    against the YTVIS-19 vocabulary with the geometric ensemble (alpha 0.4,
    beta 0.8); Q = 100, 9 decoder layers, a 6-layer tracker."""
    cfg = Config()
    m = cfg.model
    m.meta_architecture = "dvis_online"
    m.num_classes = 133
    m.backbone.name = "clip_convnext_l"
    m.ov = OVConfig(enabled=True, geometric_ensemble_alpha=0.4, geometric_ensemble_beta=0.8,
                    clip_embed_dim=768)
    m.freeze = ("backbone",)
    cfg.datasets.train = ("coco_panoptic_video_ov",)
    cfg.datasets.dataset_type = ("image_panoptic",)
    return cfg


def ov_minvis_convnextl_zeroshot_ytvis19() -> Config:
    """The bare FC-CLIP segmenter of :func:`ov_online_convnextl_zeroshot_ytvis19`
    (MinVIS OV: queries aligned frame to frame after the forward), Q = 250."""
    cfg = ov_online_convnextl_zeroshot_ytvis19()
    cfg.model.meta_architecture = "minvis"
    cfg.model.transformer_decoder.num_queries = 250
    cfg.solver.ims_per_batch, cfg.solver.steps = 16, (28000,)
    cfg.input.sampling_frame_num = 1
    return cfg


def ov_offline_convnextl_zeroshot_ytvis19() -> Config:
    """:func:`ov_online_convnextl_zeroshot_ytvis19` plus the 6-layer OV
    temporal refiner (OV-DVIS++ offline)."""
    cfg = ov_online_convnextl_zeroshot_ytvis19()
    cfg.model.meta_architecture = "dvis_offline"
    cfg.model.freeze = ("backbone", "segmenter", "tracker")
    cfg.input.sampling_frame_num, cfg.input.sampling_frame_range = 15, 7
    return cfg
