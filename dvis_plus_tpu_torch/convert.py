"""JAX parameter trees of the VIS models -> the port's ``state_dict``.

Counterpart: the Flax trees of ``dvis_plus_tpu/models/segmenter/segmenter.py::
Segmenter`` (:41, the MinVIS and CTVIS model: ``{"backbone",
"pixel_decoder", "transformer_decoder"}``, with ``reid_embed`` for CTVIS),
``dvis_plus_tpu/models/meta/video_maskformer.py::VideoMaskFormer`` (:29, the
same three with the clip decoder's ``level_embed`` / ``query_feat`` /
``query_embed`` / ``input_proj_i`` / ``cross_i`` / ``self_i`` / ``ffn_i`` /
heads under ``transformer_decoder``),
``dvis_plus_tpu/models/meta/dvis_online.py::DVISOnline`` (:40,
``{"segmenter", "tracker"}``) and
``dvis_plus_tpu/models/meta/dvis_offline.py::DVISOffline`` (:46,
``{"online": {"segmenter", "tracker"}, "refiner"}``) and
``dvis_plus_tpu/models/meta/daq.py::{DAQOnline,DAQOffline}`` (:37, :196:
``{"segmenter", "cutter"}`` and ``{"online": {...}, "refiner"}``, the cutter
becoming ``tracker.*`` as in the reference DAQ checkpoints), with a ResNet,
Swin or ViT-Adapter backbone; and the open-vocabulary trees of
``dvis_plus_tpu/models/meta/ov.py::{OVSegmenter,DVISOnlineOV,DVISOfflineOV}``
(:38, :163, :230: the CLIP trunk under ``backbone``, the FC-CLIP head under
``transformer_decoder/ov_head``, ``void_embedding``; the tracker's and
refiner's ``class_embed_ov`` heads). The port's parameters carry the
reference checkpoints' names, so this is the inverse of
``dvis_plus_tpu/core/zoo_convert.py::convert_reference_checkpoint`` (with
``convert_torch_swin``, ``convert_torch_vit_adapter``,
``convert_daq_cutter``, ``convert_refiner`` and the ``convert_ov_*``
functions), and the port's
``state_dict()`` converts back with that function. Numpy in, torch out; no jax needed.

Layout changes: Flax ``Dense`` kernel (in, out) -> ``Linear.weight``
(out, in); conv HWIO -> OIHW, conv1d (k, in, out) -> (out, in, k);
``DenseGeneral`` q/k/v (C, H, Dh) and ``out_proj`` (H, Dh, C) -> the fused
``in_proj_weight`` (3C, C) and ``out_proj.weight``; ``FrozenBN``
scale/bias/mean/var -> buffers; ``GroupNorm`` / ``LayerNorm`` scale ->
weight. The Swin ``relative_position_index`` buffers, which the JAX tree
does not hold, are rebuilt from each bias table's size.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _dense(p, key: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{key}.weight"] = _a(p["kernel"]).T
    if "bias" in p:
        out[f"{key}.bias"] = _a(p["bias"])


def _conv(p, key: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{key}.weight"] = np.transpose(_a(p["kernel"]), (3, 2, 0, 1))
    if "bias" in p:
        out[f"{key}.bias"] = _a(p["bias"])


def _norm(p, key: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{key}.weight"] = _a(p["scale"])
    out[f"{key}.bias"] = _a(p["bias"])


def _frozen_bn(p, key: str, out: Dict[str, np.ndarray]) -> None:
    _norm(p, key, out)
    out[f"{key}.running_mean"] = _a(p["mean"])
    out[f"{key}.running_var"] = _a(p["var"])


def _mlp(p, key: str, out: Dict[str, np.ndarray]) -> None:
    for name in sorted(p, key=lambda n: int(n.split("_")[1])):
        _dense(p[name], f"{key}.layers.{name.split('_')[1]}", out)


def _mha(p, key: str, out: Dict[str, np.ndarray], in_proj: str = "in_proj_",
         out_proj: str = "out_proj") -> None:
    """q/k/v ``DenseGeneral``s -> one fused (3C, C) projection, named
    ``in_proj_weight`` / ``out_proj`` (``nn.MultiheadAttention``) or, for the
    ViT trunk, ``qkv.weight`` / ``proj``."""
    ws, bs = [], []
    for name in ("q_proj", "k_proj", "v_proj"):
        k = _a(p[name]["kernel"])  # (C, H, Dh)
        ws.append(k.reshape(k.shape[0], -1).T)
        bs.append(_a(p[name]["bias"]).reshape(-1))
    out[f"{key}.{in_proj}weight"] = np.concatenate(ws, axis=0)
    out[f"{key}.{in_proj}bias"] = np.concatenate(bs, axis=0)
    k = _a(p["out_proj"]["kernel"])  # (H, Dh, C)
    out[f"{key}.{out_proj}.weight"] = k.reshape(-1, k.shape[-1]).T
    out[f"{key}.{out_proj}.bias"] = _a(p["out_proj"]["bias"])


def _layers(p, pre: str, out: Dict[str, np.ndarray]) -> None:
    """self_{i} / cross_{i} / ffn_{i} -> the reference's three layer lists."""
    for name, sub in p.items():
        kind, _, idx = name.rpartition("_")
        if kind == "self":
            _mha(sub["attn"], f"{pre}transformer_self_attention_layers.{idx}.self_attn", out)
            _norm(sub["norm"], f"{pre}transformer_self_attention_layers.{idx}.norm", out)
        elif kind == "cross":
            _mha(sub["attn"], f"{pre}transformer_cross_attention_layers.{idx}.multihead_attn", out)
            _norm(sub["norm"], f"{pre}transformer_cross_attention_layers.{idx}.norm", out)
        elif kind == "ffn":
            for lin in ("linear1", "linear2"):
                _dense(sub[lin], f"{pre}transformer_ffn_layers.{idx}.{lin}", out)
            _norm(sub["norm"], f"{pre}transformer_ffn_layers.{idx}.norm", out)


def _backbone(p, out: Dict[str, np.ndarray]) -> None:
    _conv(p["stem_conv1"], "backbone.stem.conv1", out)
    _frozen_bn(p["stem_norm1"], "backbone.stem.conv1.norm", out)
    for name, blk in p.items():
        if not name.startswith("res"):
            continue
        stage, _, b = name.partition("_block")
        pre = f"backbone.{stage}.{b}"
        for i in (1, 2, 3):
            _conv(blk[f"conv{i}"], f"{pre}.conv{i}", out)
            _frozen_bn(blk[f"norm{i}"], f"{pre}.conv{i}.norm", out)
        if "shortcut" in blk:
            _conv(blk["shortcut"], f"{pre}.shortcut", out)
            _frozen_bn(blk["shortcut_norm"], f"{pre}.shortcut.norm", out)


def _swin_backbone(p, out: Dict[str, np.ndarray]) -> None:
    from dvis_plus_tpu_torch.models.backbones.swin import rel_pos_index

    _conv(p["patch_embed"], "backbone.patch_embed.proj", out)
    _norm(p["patch_norm"], "backbone.patch_embed.norm", out)
    for name, sub in p.items():
        if name.startswith("stage"):
            stage, _, b = name[len("stage"):].partition("_block")
            pre = f"backbone.layers.{stage}.blocks.{b}"
            _norm(sub["norm1"], f"{pre}.norm1", out)
            _norm(sub["norm2"], f"{pre}.norm2", out)
            attn = sub["attn"]
            _dense(attn["qkv"], f"{pre}.attn.qkv", out)
            _dense(attn["proj"], f"{pre}.attn.proj", out)
            table = _a(attn["relative_position_bias_table"])
            out[f"{pre}.attn.relative_position_bias_table"] = table
            ws = (int(round(table.shape[0] ** 0.5)) + 1) // 2
            out[f"{pre}.attn.relative_position_index"] = rel_pos_index(ws).astype(np.int64)
            _dense(sub["mlp_fc1"], f"{pre}.mlp.fc1", out)
            _dense(sub["mlp_fc2"], f"{pre}.mlp.fc2", out)
        elif name.startswith("downsample"):
            pre = f"backbone.layers.{name[len('downsample'):]}.downsample"
            _norm(sub["norm"], f"{pre}.norm", out)
            _dense(sub["reduction"], f"{pre}.reduction", out)
        elif name.startswith("out_norm"):
            _norm(sub, f"backbone.norm{name[len('out_norm'):]}", out)


def _vit_backbone(p, out: Dict[str, np.ndarray]) -> None:
    """Flax ``ViTAdapter`` tree -> ``backbone.*`` in the reference key space
    (the inverse of ``dvis_plus_tpu/core/checkpoint.py::
    convert_torch_vit_adapter``)."""
    pre = "backbone."
    vit = p["vit"]
    out[f"{pre}vit_module.cls_token"] = _a(vit["cls_token"])
    out[f"{pre}vit_module.pos_embed"] = _a(vit["pos_embed"])
    _conv(vit["patch_embed"], f"{pre}vit_module.patch_embed.proj", out)
    for name, blk in vit.items():
        if not name.startswith("block"):
            continue
        b = f"{pre}vit_module.blocks.{name[len('block'):]}"
        _norm(blk["norm1"], f"{b}.norm1", out)
        _norm(blk["norm2"], f"{b}.norm2", out)
        _mha(blk["attn"], f"{b}.attn", out, in_proj="qkv.", out_proj="proj")
        _dense(blk["mlp_fc1"], f"{b}.mlp.fc1", out)
        _dense(blk["mlp_fc2"], f"{b}.mlp.fc2", out)
        out[f"{b}.ls1.gamma"] = _a(blk["ls1"]["gamma"])
        out[f"{b}.ls2.gamma"] = _a(blk["ls2"]["gamma"])

    spm = p["spm"]
    for name, idx in (("stem1", "stem.0"), ("stem2", "stem.3"), ("stem3", "stem.6"),
                      ("conv2", "conv2.0"), ("conv3", "conv3.0"), ("conv4", "conv4.0")):
        head, _, i = idx.rpartition(".")
        _conv(spm[f"{name}_conv"], f"{pre}spm.{idx}", out)
        _frozen_bn(spm[f"{name}_bn"], f"{pre}spm.{head}.{int(i) + 1}", out)
    for name in ("fc1", "fc2", "fc3", "fc4"):
        _conv(spm[name], f"{pre}spm.{name}", out)

    def deform(sub, key):
        for lin in ("value_proj", "sampling_offsets", "attention_weights", "output_proj"):
            _dense(sub[lin], f"{key}.{lin}", out)

    def extractor(sub, key):
        _norm(sub["query_norm"], f"{key}.query_norm", out)
        _norm(sub["feat_norm"], f"{key}.feat_norm", out)
        deform(sub["attn"], f"{key}.attn")
        if "ffn" in sub:
            _norm(sub["ffn_norm"], f"{key}.ffn_norm", out)
            _dense(sub["ffn"]["fc1"], f"{key}.ffn.fc1", out)
            _dense(sub["ffn"]["fc2"], f"{key}.ffn.fc2", out)
            _conv(sub["ffn"]["dwconv"], f"{key}.ffn.dwconv.dwconv", out)  # (3, 3, 1, C) -> (C, 1, 3, 3)

    last = max(int(n.rsplit("_", 1)[1]) for n in p if n.startswith("extractor_"))
    for name, sub in p.items():
        kind, _, i = name.rpartition("_")
        if kind == "extractor":
            extractor(sub, f"{pre}interactions.{i}.extractor")
        elif kind == "extra_extractor":  # they sit on the last interaction
            extractor(sub, f"{pre}interactions.{last}.extra_extractors.{i}")
        elif kind == "injector":
            key = f"{pre}interactions.{i}.injector"
            _norm(sub["query_norm"], f"{key}.query_norm", out)
            _norm(sub["feat_norm"], f"{key}.feat_norm", out)
            deform(sub["attn"], f"{key}.attn")
            out[f"{key}.gamma"] = _a(sub["gamma"])

    # Flax's ConvTranspose places the spatially mirrored tap where torch's
    # ConvTranspose2d places tap (kh, kw): (kH, kW, Cin, Cout) -> (Cin, Cout,
    # kH, kW), flipped on both spatial axes
    up = np.transpose(_a(p["up"]["kernel"]), (2, 3, 0, 1))[:, :, ::-1, ::-1]
    out[f"{pre}up.weight"] = np.ascontiguousarray(up)
    out[f"{pre}up.bias"] = _a(p["up"]["bias"])
    for n in (1, 2, 3, 4):
        _frozen_bn(p[f"norm{n}"], f"{pre}norm{n}", out)
    out[f"{pre}level_embed"] = _a(p["level_embed"])


def _pixel_decoder(p, out: Dict[str, np.ndarray]) -> None:
    pre = "sem_seg_head.pixel_decoder."
    for name, sub in p.items():
        if name.startswith("input_proj_") and name.endswith("_conv"):
            _conv(sub, f"{pre}input_proj.{name.split('_')[2]}.0", out)
        elif name.startswith("input_proj_") and name.endswith("_norm"):
            _norm(sub, f"{pre}input_proj.{name.split('_')[2]}.1", out)
        elif name.startswith("encoder_layer_"):
            e = f"{pre}transformer.encoder.layers.{name.rsplit('_', 1)[1]}"
            for lin in ("value_proj", "sampling_offsets", "attention_weights", "output_proj"):
                _dense(sub[lin], f"{e}.self_attn.{lin}", out)
            for lin in ("linear1", "linear2"):
                _dense(sub[lin], f"{e}.{lin}", out)
            _norm(sub["norm1"], f"{e}.norm1", out)
            _norm(sub["norm2"], f"{e}.norm2", out)
    out[f"{pre}transformer.level_embed"] = _a(p["level_embed"])
    _conv(p["mask_features"], f"{pre}mask_features", out)
    for name in ("adapter_1", "layer_1"):
        _conv(p[name]["conv"], f"{pre}{name}", out)
        _norm(p[name]["norm"], f"{pre}{name}.norm", out)


def _predictor(p, out: Dict[str, np.ndarray]) -> None:
    pre = "sem_seg_head.predictor."
    for name in ("query_feat", "query_embed", "level_embed"):
        out[f"{pre}{name}.weight"] = _a(p[name])
    _norm(p["decoder_norm"], f"{pre}decoder_norm", out)
    _dense(p["class_embed"], f"{pre}class_embed", out)
    _mlp(p["mask_embed"], f"{pre}mask_embed", out)
    if "reid_embed" in p:
        _mlp(p["reid_embed"], f"{pre}reid_embed", out)
    for name, sub in p.items():
        if name.startswith("input_proj_"):
            _conv(sub, f"{pre}input_proj.{name.split('_')[2]}", out)
    _layers(p, pre, out)


def _tracker(p, out: Dict[str, np.ndarray]) -> None:
    pre = "tracker."
    step = p["frame_step"]
    _layers(step, pre, out)
    _mlp(step["ref_proj"], f"{pre}ref_proj", out)
    _norm(p["decoder_norm"], f"{pre}decoder_norm", out)
    _dense(p["class_embed"], f"{pre}class_embed", out)
    _mlp(p["mask_embed"], f"{pre}mask_embed", out)
    k = _a(p["mask_feature_proj"]["kernel"])  # Dense (C_in, C_out) = 1x1 conv
    out[f"{pre}mask_feature_proj.weight"] = k.T[:, :, None, None]
    out[f"{pre}mask_feature_proj.bias"] = _a(p["mask_feature_proj"]["bias"])


def _cutter(p, out: Dict[str, np.ndarray]) -> None:
    """The DAQ ``VideoInstanceCutter`` tree -> ``tracker.*`` (the inverse of
    ``zoo_convert.py::convert_daq_cutter``)."""
    pre = "tracker."
    _layers(p, pre, out)
    for name, sub in p.items():
        kind, _, i = name.rpartition("_")
        if kind == "slot_cross":
            layer = f"{pre}slot_cross_attention_layers.{i}"
            _mha(sub["attn"], f"{layer}.multihead_attn", out)
            _norm(sub["norm"], f"{layer}.norm", out)
            sa = sub["slot_attn"]
            _norm(sa["norm_inputs"], f"{layer}.slot_attn.norm_inputs", out)
            _norm(sa["project_q_norm"], f"{layer}.slot_attn.project_q.0", out)
            _dense(sa["project_q_dense"], f"{layer}.slot_attn.project_q.1", out)
            _dense(sa["project_k"], f"{layer}.slot_attn.project_k", out)
        elif kind == "slot_ffn":
            for lin in ("linear1", "linear2"):
                _dense(sub[lin], f"{pre}slot_ffn_layers.{i}.{lin}", out)
            _norm(sub["norm"], f"{pre}slot_ffn_layers.{i}.norm", out)
    _norm(p["decoder_norm"], f"{pre}decoder_norm", out)
    _dense(p["class_embed"], f"{pre}class_embed", out)
    _mlp(p["mask_embed"], f"{pre}mask_embed", out)
    _mlp(p["pos_embed"], f"{pre}pos_embed", out)
    k = _a(p["mask_feature_proj"]["kernel"])  # Dense (C_in, C_out) = 1x1 conv
    out[f"{pre}mask_feature_proj.weight"] = k.T[:, :, None, None]
    out[f"{pre}mask_feature_proj.bias"] = _a(p["mask_feature_proj"]["bias"])
    out[f"{pre}new_ins_embeds.weight"] = _a(p["new_ins_embeds"])
    out[f"{pre}bg_slots.weight"] = _a(p["bg_slots"])


def _refiner(p, out: Dict[str, np.ndarray]) -> None:
    pre = "refiner."
    for name, sub in p.items():
        kind, _, i = name.rpartition("_")
        if kind in ("time_self", "obj_self"):
            layer = f"{pre}transformer_{kind}_attention_layers.{i}"
            _mha(sub["attn"], f"{layer}.self_attn", out)
            _norm(sub["norm"], f"{layer}.norm", out)
        elif kind == "cross":
            layer = f"{pre}transformer_cross_attention_layers.{i}"
            _mha(sub["attn"], f"{layer}.multihead_attn", out)
            _norm(sub["norm"], f"{layer}.norm", out)
        elif kind == "ffn":
            for lin in ("linear1", "linear2"):
                _dense(sub[lin], f"{pre}transformer_ffn_layers.{i}.{lin}", out)
            _norm(sub["norm"], f"{pre}transformer_ffn_layers.{i}.norm", out)
        elif kind == "conv":
            for j, conv in ((0, "conv1"), (2, "conv2")):
                key = f"{pre}conv_short_aggregate_layers.{i}.{j}"
                out[f"{key}.weight"] = np.transpose(_a(sub[conv]["kernel"]), (2, 1, 0))
                out[f"{key}.bias"] = _a(sub[conv]["bias"])
            _norm(sub["norm"], f"{pre}conv_norms.{i}", out)
    _norm(p["decoder_norm"], f"{pre}decoder_norm", out)
    _mlp(p["mask_embed"], f"{pre}mask_embed", out)
    _dense(p["activation_proj"], f"{pre}activation_proj", out)
    if "class_embed_ov" in p:  # the OV refiner (zoo_convert.py::convert_ov_refiner)
        _ov_head(p["maskpool_norm"], p["maskpool_proj"], p["class_embed_ov"], p["logit_scale"],
                 pre, out)
    else:
        _dense(p["class_embed"], f"{pre}class_embed", out)


def _clip_backbone(p, out: Dict[str, np.ndarray]) -> None:
    """Flax ``CLIPBackbone`` (ConvNeXt trunk + visual head, or ModifiedResNet
    + attention pool) -> ``backbone.clip_model.*`` in open_clip's names (the
    inverse of ``convert_open_clip_convnext`` / ``convert_clip_visual_head``,
    ``convert_open_clip_resnet`` / ``convert_clip_attnpool``)."""
    pre = "backbone.clip_model."
    out[f"{pre}logit_scale"] = _a(p["logit_scale"])
    trunk = p["trunk"]
    if "attnpool" in p:  # ModifiedResNet (RN50)
        v = f"{pre}visual."
        for name, sub in trunk.items():
            if name.startswith("layer"):
                layer, _, b = name.partition("_")
                blk = f"{v}{layer}.{b}"
                for i in (1, 2, 3):
                    _conv(sub[f"conv{i}"], f"{blk}.conv{i}", out)
                    _frozen_bn(sub[f"bn{i}"], f"{blk}.bn{i}", out)
                if "downsample_conv" in sub:
                    _conv(sub["downsample_conv"], f"{blk}.downsample.0", out)
                    _frozen_bn(sub["downsample_bn"], f"{blk}.downsample.1", out)
            elif name.startswith("conv"):
                _conv(sub, f"{v}{name}", out)
            elif name.startswith("bn"):
                _frozen_bn(sub, f"{v}{name}", out)
        ap, a = p["attnpool"], f"{v}attnpool."
        out[f"{a}positional_embedding"] = _a(ap["positional_embedding"])
        for name in ("q_proj", "k_proj", "v_proj"):
            k = _a(ap[name]["kernel"])  # (C, H, Dh)
            out[f"{a}{name}.weight"] = k.reshape(k.shape[0], -1).T
            out[f"{a}{name}.bias"] = _a(ap[name]["bias"]).reshape(-1)
        k = _a(ap["c_proj"]["kernel"])  # (H, Dh, out)
        out[f"{a}c_proj.weight"] = k.reshape(-1, k.shape[-1]).T
        out[f"{a}c_proj.bias"] = _a(ap["c_proj"]["bias"])
        return
    t = f"{pre}visual.trunk."
    _conv(trunk["stem_conv"], f"{t}stem.0", out)
    _norm(trunk["stem_norm"], f"{t}stem.1", out)
    for name, sub in trunk.items():
        if name.startswith("downsample_norm"):
            _norm(sub, f"{t}stages.{name[len('downsample_norm'):]}.downsample.0", out)
        elif name.startswith("downsample_conv"):
            _conv(sub, f"{t}stages.{name[len('downsample_conv'):]}.downsample.1", out)
        elif name.startswith("stage"):
            stage, _, b = name[len("stage"):].partition("_block")
            blk = f"{t}stages.{stage}.blocks.{b}"
            _conv(sub["dwconv"], f"{blk}.conv_dw", out)  # (7, 7, 1, C) -> (C, 1, 7, 7)
            _norm(sub["norm"], f"{blk}.norm", out)
            _dense(sub["pwconv1"], f"{blk}.mlp.fc1", out)
            _dense(sub["pwconv2"], f"{blk}.mlp.fc2", out)
            out[f"{blk}.gamma"] = _a(sub["gamma"])
    head = p["visual_head"]
    _norm(head["head_norm"], f"{t}head.norm", out)
    _dense(head["proj_fc1"], f"{pre}visual.head.mlp.fc1", out)
    _dense(head["proj_fc2"], f"{pre}visual.head.mlp.fc2", out)


def _ov_head(norm, proj, mlp, scale, pre: str, out: Dict[str, np.ndarray]) -> None:
    """The FC-CLIP class head group under ``pre`` (``_mask_pooling_proj.{0,1}``,
    ``class_embed``, ``logit_scale``; ``zoo_convert.py::_ov_head``)."""
    _norm(norm, f"{pre}_mask_pooling_proj.0", out)
    _dense(proj, f"{pre}_mask_pooling_proj.1", out)
    _mlp(mlp, f"{pre}class_embed", out)
    out[f"{pre}logit_scale"] = _a(scale)


def _ov_predictor(p, out: Dict[str, np.ndarray]) -> None:
    pre = "sem_seg_head.predictor."
    for name in ("query_feat", "query_embed", "level_embed"):
        out[f"{pre}{name}.weight"] = _a(p[name])
    _norm(p["decoder_norm"], f"{pre}decoder_norm", out)
    _mlp(p["mask_embed"], f"{pre}mask_embed", out)
    h = p["ov_head"]
    _ov_head(h["maskpool_norm"], h["maskpool_proj"], h["class_embed"], h["logit_scale"], pre, out)
    for name, sub in p.items():
        if name.startswith("input_proj_"):
            _conv(sub, f"{pre}input_proj.{name.split('_')[2]}", out)
    _layers(p, pre, out)


def _ov_segmenter(seg, out: Dict[str, np.ndarray]) -> None:
    """Flax ``OVSegmenter`` -> the reference key space (the inverse of
    ``zoo_convert.py::convert_ov_segmenter``): the void rows split into
    ``void_embedding`` (row 0) and ``additional_void_embedding``."""
    _clip_backbone(seg["backbone"], out)
    _pixel_decoder(seg["pixel_decoder"], out)
    _ov_predictor(seg["transformer_decoder"], out)
    void = _a(seg["void_embedding"])
    out["void_embedding.weight"] = void[:1]
    if void.shape[0] > 1:
        out["additional_void_embedding.weight"] = void[1:]


def _ov_tracker(p, out: Dict[str, np.ndarray]) -> None:
    """The OV tracker (no ``mask_feature_proj``; ``merge`` + the FC-CLIP
    head) -> ``tracker.*`` (``zoo_convert.py::convert_ov_tracker``)."""
    pre = "tracker."
    step = p["frame_step"]
    _layers(step, pre, out)
    _mlp(step["ref_proj"], f"{pre}ref_proj", out)
    _norm(p["decoder_norm"], f"{pre}decoder_norm", out)
    _mlp(p["mask_embed"], f"{pre}mask_embed", out)
    _dense(p["merge"], f"{pre}merge", out)
    _ov_head(p["maskpool_norm"], p["maskpool_proj"], p["class_embed_ov"], p["logit_scale"], pre, out)


def state_dict_from_jax(params: Mapping, cfg=None) -> Dict[str, torch.Tensor]:
    """JAX ``Segmenter``, ``VideoMaskFormer``, ``DVISOnline``,
    ``DVISOffline``, ``DAQOnline``, ``DAQOffline``, ``OVSegmenter``,
    ``DVISOnlineOV`` or ``DVISOfflineOV`` params (``{"params": ...}`` or the
    bare tree, numpy leaves) -> a ``state_dict`` for the port's model of the
    same name.
    ``cfg`` is accepted for symmetry with the zoo converter; the tree itself
    carries every shape."""
    p = params.get("params", params)
    out: Dict[str, np.ndarray] = {}
    online = p.get("online", p)
    seg = online.get("segmenter", online)  # a bare segmenter or clip model tree
    if "trunk" in seg["backbone"]:  # the open-vocabulary models' CLIP trunk
        _ov_segmenter(seg, out)
        if "tracker" in online:
            _ov_tracker(online["tracker"], out)
    else:
        if "patch_embed" in seg["backbone"]:
            _swin_backbone(seg["backbone"], out)
        elif "vit" in seg["backbone"]:
            _vit_backbone(seg["backbone"], out)
        else:
            _backbone(seg["backbone"], out)
        _pixel_decoder(seg["pixel_decoder"], out)
        _predictor(seg["transformer_decoder"], out)
        if "tracker" in online:
            _tracker(online["tracker"], out)
        if "cutter" in online:
            _cutter(online["cutter"], out)
    if "refiner" in p:
        _refiner(p["refiner"], out)
    return {
        k: torch.from_numpy(v if v.dtype == np.int64 else np.array(v, np.float32))
        for k, v in out.items()
    }
