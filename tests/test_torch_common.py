"""Shared helpers for the PyTorch port's parity tests (no tests of its own).

Builds tiny DVIS++ online (ResNet-50) and offline (Swin, ViT-Adapter)
configurations and
seeded numpy weights shaped like the JAX model's parameter tree (random
everywhere, so that the reference's zero-initialized projections such as
the sampling offsets give generic sampling locations). The same weights
load into the port through ``dvis_plus_tpu_torch.convert.state_dict_from_jax``.
"""
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from dvis_plus_tpu.core.config import Config

H_IN, W_IN = 64, 96  # input size of the tiny parity runs


def tiny_cfg(impl: str = "exact", enc_layers: int = 2, tracker_layers: int = 2) -> Config:
    """fp32 parity settings (PARITY.md): exact deformable op or its clamped
    form, exact JV matcher, float32 compute."""
    cfg = Config()
    m = cfg.model
    m.meta_architecture = "dvis_online"
    m.num_classes = 5
    m.compute_dtype = "float32"
    pd = m.pixel_decoder
    pd.conv_dim, pd.mask_dim = 32, 32
    pd.transformer_enc_layers = enc_layers
    pd.transformer_dim_feedforward = 64
    pd.transformer_nheads = 4
    pd.msdeform_impl = impl
    td = m.transformer_decoder
    td.hidden_dim, td.mask_dim = 32, 32
    td.num_queries = 8
    td.nheads = 4
    td.dim_feedforward = 64
    td.dec_layers = 2
    td.reid_branch = True
    td.reid_hidden_dim = 48
    m.tracker.num_layers = tracker_layers
    m.tracker.feedforward_dim = 64
    m.tracker.num_heads = 4
    m.tracker.matcher_solver = "jv"
    cfg.test.window_size = 3
    cfg.test.max_num = 10
    cfg.test.mask_download = "packed"
    cfg.test.eval_pipeline = False
    return cfg


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def random_params(shapes, seed: int = 0, scale: float = 0.05):
    """Seeded numpy weights shaped like a JAX param tree (from
    ``jax.eval_shape(model.init, ...)``): normal(0, scale) leaves, norm
    scales around 1, FrozenBN variances positive, and wider sampling-offset
    projections so deformable samples spread over several pixels."""
    rng = np.random.RandomState(seed)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        x = (scale * rng.randn(*tree.shape)).astype(np.float32)
        if path[-1] == "var":
            return np.abs(x) + 0.5
        if path[-1] == "scale":
            return x + 1.0
        if "sampling_offsets" in path and path[-1] == "kernel":
            return x * 10.0
        if path[-1] == "relative_position_bias_table":
            return x * 20.0  # a bias of order 1, so the scores depend on it
        if "vit" in path and path[-1] == "kernel" and path[-2] in ("q_proj", "k_proj"):
            return x * 20.0  # scores of order 1, so the softmax is not flat
        if path[-1] == "gamma":
            return x + 0.5  # LayerScale / injector gates of order 1, not 1e-5
        return x

    return walk(shapes, ())


@functools.cache
def jax_model_and_params(impl: str = "exact", enc_layers: int = 2, tracker_layers: int = 2):
    """(cfg, flax module, seeded numpy params) for the tiny DVISOnline."""
    from dvis_plus_tpu.models.meta.dvis_online import DVISOnline

    cfg = tiny_cfg(impl, enc_layers, tracker_layers)
    model = DVISOnline(cfg.model)
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros((1, 2, H_IN, W_IN, 3), jnp.float32)
    )
    return cfg, model, random_params(shapes)


def tiny_offline_cfg(window: int = 12, backbone: str = "swin_tiny") -> Config:
    """DVIS++ offline with a tiny Swin: embed 32, depths (2, 2, 2, 2), heads
    (1, 2, 4, 8), so Dh = 32 in every stage. The backbone name lies outside
    the named variants, so the ``swin_*`` width fields apply on both sides.
    At 64x96 input the stages see 16x24, 8x12, 4x6 and 2x3 tokens: every
    stage pads, and with window 12 the last three are one padded window."""
    cfg = tiny_cfg()
    m = cfg.model
    m.meta_architecture = "dvis_offline"
    b = m.backbone
    b.name = backbone
    b.swin_embed_dim = 32
    b.swin_depths = (2, 2, 2, 2)
    b.swin_num_heads = (1, 2, 4, 8)
    b.swin_window_size = window
    m.refiner.num_layers = 2
    m.refiner.feedforward_dim = 64
    m.refiner.num_heads = 4
    return cfg


@functools.cache
def jax_offline_model_and_params(window: int = 12):
    """(cfg, flax module, seeded numpy params) for the tiny Swin DVISOffline."""
    from dvis_plus_tpu.models.meta.dvis_offline import DVISOffline

    cfg = tiny_offline_cfg(window)
    model = DVISOffline(cfg.model)
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros((1, 2, H_IN, W_IN, 3), jnp.float32)
    )
    return cfg, model, random_params(shapes)


def tiny_vit_backbone(b, coarse: bool = False, flash: bool = False):
    """Set a backbone config to a tiny ViT-Adapter: embed 32, depth 4, 2
    heads (Dh = 16), one trunk block per interaction, ``conv_inplane`` 8, 2
    deformable heads. At 64x96 input the trunk sees 4x6 tokens, not the 37x37
    pretraining grid, so the position embedding is resampled."""
    b.name = "vit_adapter_dinov2"
    b.vit_embed_dim = 32
    b.vit_depth = 4
    b.vit_num_heads = 2
    b.vit_interaction_indexes = ((0, 0), (1, 1), (2, 2), (3, 3))
    b.vit_conv_inplane = 8
    b.vit_deform_num_heads = 2
    b.vit_extractor_coarse = coarse
    b.vit_flash_attention = flash
    return b


def tiny_vit_offline_cfg(coarse: bool = False, flash: bool = False) -> Config:
    """DVIS++ offline with the tiny ViT-Adapter backbone."""
    cfg = tiny_offline_cfg()
    tiny_vit_backbone(cfg.model.backbone, coarse, flash)
    return cfg


@functools.cache
def jax_vit_offline_model_and_params(coarse: bool = False, flash: bool = False):
    """(cfg, flax module, seeded numpy params) for the tiny ViT DVISOffline."""
    from dvis_plus_tpu.models.meta.dvis_offline import DVISOffline

    cfg = tiny_vit_offline_cfg(coarse, flash)
    model = DVISOffline(cfg.model)
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros((1, 2, H_IN, W_IN, 3), jnp.float32)
    )
    return cfg, model, random_params(shapes, seed=3)


def port_model(cfg, params):
    """The port's DVISOnline / DVISOffline (by ``meta_architecture``) with
    the JAX params loaded (strict)."""
    from dvis_plus_tpu_torch.convert import state_dict_from_jax
    from dvis_plus_tpu_torch.models.meta.dvis_offline import DVISOffline
    from dvis_plus_tpu_torch.models.meta.dvis_online import DVISOnline

    arch = DVISOffline if cfg.model.meta_architecture == "dvis_offline" else DVISOnline
    model = arch(cfg.model)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval()


def images(T: int, seed: int = 1) -> np.ndarray:
    """(T, H, W, 3) normalized synthetic frames."""
    return np.random.RandomState(seed).randn(T, H_IN, W_IN, 3).astype(np.float32)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))
