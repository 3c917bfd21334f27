"""YAML-free configuration presets for the ported slices.

The port's model code reads its configuration by attribute only, so it takes
either the JAX package's ``dvis_plus_tpu.core.config.Config`` (tests and the
CPU CLI, where PyYAML is installed) or a preset below (on a GPU machine,
which may have no PyYAML). The presets hold only the fields the port reads,
with the values ``load_config`` resolves for their YAML through its
``_BASE_`` chain: ``configs/dvis/dvis_online_r50_ytvis19.yaml`` (ctvis ->
minvis -> base_video) and ``configs/dvis/dvis_offline_swinl_ytvis19.yaml``
(dvis_online_swinl -> dvis_online_r50 -> ...). ``tests/test_torch_config.py``
holds each preset equal to its YAML field by field.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class BackboneConfig:
    name: str = "resnet50"  # resnet50 | resnet101 | swin_{t,s,b,l} | another swin_* name
    out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    # Swin widths: read only for a swin_* name outside swin_{t,s,b,l}
    swin_embed_dim: int = 96
    swin_depths: Tuple[int, ...] = (2, 2, 6, 2)
    swin_num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    swin_window_size: int = 7
    swin_mlp_ratio: float = 4.0
    swin_patch_size: int = 4
    swin_qkv_bias: bool = True
    swin_fast_softmax: bool = False  # bf16 attention scores: not ported (raises)
    swin_fused_attn: bool = False  # both values run kernel B2 on CUDA


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
    reid_branch: bool = True
    reid_hidden_dim: int = 512


@dataclass
class TrackerConfig:
    num_layers: int = 6
    feedforward_dim: int = 2048
    num_heads: int = 8
    matcher_solver: str = "auction"  # auction | jv


@dataclass
class RefinerConfig:
    num_layers: int = 6
    feedforward_dim: int = 2048
    num_heads: int = 8
    window_size: int = 5


@dataclass
class ModelConfig:
    meta_architecture: str = "dvis_online"
    num_classes: int = 40
    compute_dtype: str = "bfloat16"
    size_divisibility: int = 32
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    pixel_decoder: PixelDecoderConfig = field(default_factory=PixelDecoderConfig)
    transformer_decoder: TransformerDecoderConfig = field(
        default_factory=TransformerDecoderConfig
    )
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    refiner: RefinerConfig = field(default_factory=RefinerConfig)


@dataclass
class InputConfig:
    min_size_test: int = 480
    max_size_test: int = 768


@dataclass
class TestConfig:
    window_size: int = 5
    max_num: int = 20
    offline_mf_budget_gb: float = 4.0


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    input: InputConfig = field(default_factory=InputConfig)
    test: TestConfig = field(default_factory=TestConfig)


def dvis_online_r50_ytvis19() -> Config:
    """DVIS++ online, ResNet-50, YouTube-VIS 2019 (40 classes)."""
    return Config()


def dvis_offline_swinl_ytvis19() -> Config:
    """DVIS++ offline, Swin-L (window 12), YouTube-VIS 2019: the online
    Swin-L stack with Q = 200 plus the 6-layer temporal refiner."""
    cfg = Config()
    m = cfg.model
    m.meta_architecture = "dvis_offline"
    m.backbone = BackboneConfig(
        name="swin_l", swin_embed_dim=192, swin_depths=(2, 2, 18, 2),
        swin_num_heads=(6, 12, 24, 48), swin_window_size=12,
    )
    m.transformer_decoder.num_queries = 200
    return cfg
