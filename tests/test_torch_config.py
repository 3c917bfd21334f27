"""The port's YAML-free presets equal the JAX package's loaded configs, field
by field, for every field the port reads; and the port's own ``load_config``
(``_BASE_`` chain, dotted overrides) resolves the slices' YAMLs to the same
values as the JAX package's. ``check_supported`` holds every YAML under
``configs/`` to what the port does: the ported slices pass, anything else
raises ``NotImplementedError`` with the key in the message."""
import dataclasses
import glob
import os

import pytest

from dvis_plus_tpu.core.config import load_config
from dvis_plus_tpu_torch import config as port_config
from dvis_plus_tpu_torch.config import (
    ctvis_r50_ytvis19,
    ctvis_vitl_ytvis19,
    daq_offline_r50_ovis,
    daq_online_r50_ytvis19,
    dvis_offline_swinl_ytvis19,
    dvis_offline_r50_ytvis19,
    dvis_offline_vitl_ytvis19,
    dvis_online_r50_vipseg,
    dvis_online_r50_vspw,
    dvis_online_r50_ytvis19,
    maskformer_r50_coco,
    minvis_r50_ytvis19,
    minvis_vitl_ytvis19,
    ov_minvis_convnextl_zeroshot_ytvis19,
    ov_offline_convnextl_zeroshot_ytvis19,
    ov_online_convnextl_zeroshot_ytvis19,
    video_maskformer_r50_coco_joint,
    video_maskformer_r50_ytvis19,
)

YAML = "configs/dvis/dvis_online_r50_ytvis19.yaml"
GROUPS = [
    "model",
    "model.backbone",
    "model.pixel_decoder",
    "model.transformer_decoder",
    "model.tracker",
    "model.criterion",
    "solver",
    "input",
    "datasets",
    "test",
]


def _get(cfg, path):
    for p in path.split("."):
        cfg = getattr(cfg, p)
    return cfg


def _assert_fields_equal(got, want, group):
    for f in dataclasses.fields(got):
        value = getattr(got, f.name)
        if dataclasses.is_dataclass(value):
            continue
        ref = getattr(want, f.name)
        if isinstance(value, tuple):
            value, ref = list(value), list(ref)
        assert value == ref, f"{group}.{f.name}: preset {value!r} != yaml {ref!r}"


@pytest.mark.parametrize("group", GROUPS)
def test_preset_matches_yaml(group):
    _assert_fields_equal(_get(dvis_online_r50_ytvis19(), group), _get(load_config(YAML), group), group)


@pytest.mark.parametrize("group", GROUPS + ["model.refiner"])
def test_r50_offline_preset_matches_yaml(group):
    want = _get(load_config("configs/dvis/dvis_offline_r50_ytvis19.yaml"), group)
    _assert_fields_equal(_get(dvis_offline_r50_ytvis19(), group), want, group)


@pytest.mark.parametrize("group", GROUPS + ["model.refiner"])
def test_swinl_offline_preset_matches_yaml(group):
    want = _get(load_config("configs/dvis/dvis_offline_swinl_ytvis19.yaml"), group)
    _assert_fields_equal(_get(dvis_offline_swinl_ytvis19(), group), want, group)


@pytest.mark.parametrize("group", GROUPS + ["model.refiner"])
def test_vitl_offline_preset_matches_yaml(group):
    want = _get(load_config("configs/dvis/dvis_offline_vitl_ytvis19.yaml"), group)
    _assert_fields_equal(_get(dvis_offline_vitl_ytvis19(), group), want, group)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("preset", [minvis_r50_ytvis19, ctvis_r50_ytvis19, video_maskformer_r50_ytvis19])
def test_minvis_ctvis_clip_presets_match_yaml(preset, group):
    want = _get(load_config(f"configs/dvis/{preset.__name__}.yaml"), group)
    _assert_fields_equal(_get(preset(), group), want, group)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("preset", [maskformer_r50_coco, video_maskformer_r50_coco_joint,
                                    minvis_vitl_ytvis19, ctvis_vitl_ytvis19])
def test_coco_and_vitl_training_presets_match_yaml(preset, group):
    want = _get(load_config(f"configs/dvis/{preset.__name__}.yaml"), group)
    _assert_fields_equal(_get(preset(), group), want, group)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("preset", [dvis_online_r50_vipseg, dvis_online_r50_vspw])
def test_vps_vss_presets_match_yaml(preset, group):
    want = _get(load_config(f"configs/dvis/{preset.__name__}.yaml"), group)
    _assert_fields_equal(_get(preset(), group), want, group)


@pytest.mark.parametrize("group", GROUPS + ["model.refiner", "model.daq"])
@pytest.mark.parametrize("preset", [daq_online_r50_ytvis19, daq_offline_r50_ovis])
def test_daq_presets_match_yaml(preset, group):
    """The DAQ presets equal their YAMLs but for the one field their
    docstring names: the YAMLs inherit the DVIS++ ReID branch, with which
    no DAQ model builds (in the JAX package either)."""
    want = _get(load_config(f"configs/daq/{preset.__name__}.yaml"), group)
    if group == "model.transformer_decoder":
        assert want.reid_branch and not preset().model.transformer_decoder.reid_branch
        want.reid_branch = False
    _assert_fields_equal(_get(preset(), group), want, group)


OV_PRESETS = [ov_online_convnextl_zeroshot_ytvis19, ov_minvis_convnextl_zeroshot_ytvis19,
              ov_offline_convnextl_zeroshot_ytvis19]


@pytest.mark.parametrize("group", GROUPS + ["model.refiner", "model.ov"])
@pytest.mark.parametrize("preset", OV_PRESETS)
def test_ov_presets_match_yaml(preset, group):
    """The open-vocabulary presets equal their YAMLs (the ConvNeXt-L
    ``clip_*`` fields under ``model.backbone``, ``datasets.train`` = the COCO
    pseudo-videos whose vocabulary is the seen one)."""
    want = _get(load_config(f"configs/ov/{preset.__name__}.yaml"), group)
    _assert_fields_equal(_get(preset(), group), want, group)


OVERRIDES = [
    "model.compute_dtype=float32",
    "model.backbone.vit_flash_attention=true",
    "model.backbone.vit_interaction_indexes=[[0,0],[1,1]]",
    "model.backbone.swin_depths=[1,1,2,1]",
    "model.pixel_decoder.conv_dim=32",
    "model.tracker.matcher_solver=jv",
    "input.min_size_test=64",
    "test.window_size=3",
    "test.offline_mf_budget_gb=0.5",
    "datasets.test=[ytvis_2019_val,ovis_val]",
    "solver.max_iter=3",
    "parallel.model_parallel_size=2",  # a section the port keeps as a namespace
    "output_dir=/tmp/out",
    "seed=7",
]


@pytest.mark.parametrize("overrides", [[], OVERRIDES], ids=["plain", "overrides"])
@pytest.mark.parametrize("yaml_name", [
    "dvis_online_r50_ytvis19", "dvis_offline_swinl_ytvis19", "dvis_offline_vitl_ytvis19",
    "../daq/daq_offline_r50_ovis", "../daq/daq_online_r50_vipseg",
    "../ov/ov_online_r50_zeroshot_ytvis19", "../ov/ov_online_convnextl_supervised",
])
def test_load_config_matches_jax(yaml_name, overrides):
    path = f"configs/dvis/{yaml_name}.yaml"
    got, want = port_config.load_config(path, overrides), load_config(path, overrides)
    for group in GROUPS + ["model.refiner", "model.daq", "model.ov"]:
        _assert_fields_equal(_get(got, group), _get(want, group), group)
    assert (got.output_dir, got.seed, got.weights) == (want.output_dir, want.seed, want.weights)
    if overrides:
        assert got.solver.max_iter == 3 and got.model.backbone.vit_interaction_indexes == ((0, 0), (1, 1))


def test_load_config_rejects_a_malformed_override():
    with pytest.raises(ValueError):
        port_config.load_config(None, ["model.compute_dtype"])


# ---------------------------------------------------------------------------
# check_supported: a setting the port cannot honour raises, naming the key
# ---------------------------------------------------------------------------

ALL_YAMLS = sorted(
    os.path.relpath(p, "configs")
    for p in glob.glob(os.path.join("configs", "**", "*.yaml"), recursive=True)
)


def _expected_fault(cfg):
    """The first key that puts a YAML outside the ported slices, from the
    JAX package's own reading of it; None where the port runs it."""
    m = cfg.model
    if m.meta_architecture not in ("dvis_online", "dvis_offline", "minvis", "ctvis",
                                   "video_maskformer", "maskformer", "daq_online", "daq_offline",
                                   "minvis_ov", "dvis_online_ov", "dvis_offline_ov"):
        return "model.meta_architecture"
    # the CLIP trunks serve open vocabulary only, and open vocabulary runs
    # them, on no DAQ model (the JAX package has none)
    ov = m.ov.enabled or m.meta_architecture.endswith("_ov")
    if m.backbone.name.startswith("clip") and not ov:
        return "model.backbone.name"
    if m.ov.enabled and (not m.backbone.name.startswith("clip") or m.meta_architecture.startswith("daq_")):
        return "model.ov.enabled"
    # vos and mots go to the DAQ eval loop, in the JAX CLI as here
    if cfg.test.task not in ("vis", "vps", "vss") and not (
            cfg.test.task in ("vos", "mots") and m.meta_architecture.startswith("daq_")):
        return "test.task"
    if any(t not in ("video_instance", "video_panoptic", "video_semantic", "video_sot", "image_panoptic")
           for t in cfg.datasets.dataset_type_test):
        return "datasets.dataset_type_test"
    return None


@pytest.mark.parametrize("yaml_name", ALL_YAMLS)
def test_every_yaml_loads_and_is_run_or_refused(yaml_name):
    """Every YAML of the repository loads; the port runs it exactly when the
    JAX package's reading of it stays inside the ported slices (VIS, VPS and
    VSS with DVIS++ online and offline, MinVIS, CTVIS, Video Mask2Former,
    the image Mask2Former and DVIS-DAQ online and offline, the last also for
    VOS and MOTS, on ResNet, Swin and ViT-Adapter backbones; open vocabulary
    with MinVIS, DVIS++ online and offline on the CLIP ConvNeXt and RN50
    trunks), and otherwise raises with the offending key in the message."""
    path = os.path.join("configs", yaml_name)
    cfg = port_config.load_config(path)
    fault = _expected_fault(load_config(path))
    if fault is None:
        port_config.check_supported(cfg)
    else:
        with pytest.raises(NotImplementedError, match=fault.replace(".", r"\.")):
            port_config.check_supported(cfg)


def test_some_yamls_of_every_kind_exist():
    kinds = {_expected_fault(load_config(os.path.join("configs", y))) for y in ALL_YAMLS}
    # every YAML of the repository is in a ported slice, the 48
    # open-vocabulary ones (ConvNeXt-L and RN50, VIS, VPS and VSS) too
    assert kinds == {None}
    assert len(ALL_YAMLS) > 100
    assert sum(y.startswith("daq/") for y in ALL_YAMLS) == 18
    assert sum(y.startswith("ov/") for y in ALL_YAMLS) == 48


# the tiny variants the CLI tests run
SLICE_CASES = [
    # COCO images as pseudo-videos (the pseudo-video mapper at eval)
    ("dvis/maskformer_r50_coco.yaml", ["datasets.dataset_type_test=[image_instance]"]),
    ("dvis/dvis_online_r50_ytvis19.yaml", []),
    ("dvis/dvis_offline_swinl_ytvis19.yaml", []),
    ("dvis/dvis_offline_vitl_ytvis19.yaml", []),
    ("dvis/dvis_offline_swinl_ytvis19.yaml", ["model.backbone.name=swin_t"]),
    ("dvis/dvis_offline_r50_ytvis19.yaml", ["model.compute_dtype=float32"]),
    ("dvis/dvis_offline_vitl_ytvis19.yaml", ["model.backbone.vit_flash_attention=true"]),
    ("dvis/dvis_online_r50_ytvis19.yaml", ["model.pixel_decoder.msdeform_impl=pallas_local"]),
    # the values the port does serve, asked for by name
    ("dvis/dvis_online_r50_ytvis19.yaml", ["test.mask_download=packed", "test.eval_pipeline=false",
                                          "test.eval_devices=1", "test.refiner_shard_devices=0",
                                          "model.pixel_decoder.name=msdeform", "test.task=vis"]),
    # keys that cannot change an eval result stay ignored
    ("dvis/dvis_online_r50_ytvis19.yaml", ["solver.max_iter=3", "parallel.model_parallel_size=2",
                                          "input.sampling_frame_num=3", "datasets.train=[ovis_train]"]),
    ("dvis/minvis_r50_ytvis19.yaml", []),
    ("dvis/ctvis_r50_ytvis19.yaml", []),
    ("dvis/video_maskformer_r50_ytvis19.yaml", []),
    ("dvis/minvis_vitl_ytvis19.yaml", ["model.tracker.matcher_solver=jv"]),
    ("dvis/ctvis_r50_ovis.yaml", []),
    # the JAX defaults asked for by name: the runs download and the pipeline
    ("dvis/dvis_online_r50_ytvis19.yaml", ["test.mask_download=runs", "test.eval_pipeline=true",
                                          "test.rle_col_k=1"]),
    ("dvis/video_maskformer_r50_ytvis19.yaml", ["test.mask_download=packed",
                                               "test.eval_pipeline=false"]),
    # VPS and VSS (VIPSeg, VSPW) of every ported architecture and backbone,
    # and the image Mask2Former
    *[(f"dvis/{arch}_{bb}_{ds}.yaml", []) for arch in ("dvis_online", "dvis_offline", "minvis", "ctvis")
      for bb in ("r50", "vitl") for ds in ("vipseg", "vspw")],
    ("dvis/maskformer_r50_coco.yaml", []),
    ("dvis/dvis_online_r50_ytvis19.yaml", ["test.task=vps", "datasets.dataset_type_test=[video_panoptic]"]),
    # DVIS-DAQ (VIS, VPS, VOS, MOTS), and the class-agnostic SOT sets
    ("daq/daq_online_r50_ytvis19.yaml", []),
    ("daq/daq_vos_r50_ytvos.yaml", []),
    ("dvis/minvis_r50_vipseg.yaml", ["datasets.dataset_type_test=[video_sot]"]),
    ("dvis/ctvis_r50_vspw.yaml", ["model.meta_architecture=daq_offline"]),
    ("dvis/dvis_online_r50_vipseg.yaml", ["model.meta_architecture=daq_online"]),
    ("daq/daq_online_r50_ytvis19.yaml", ["test.task=mots"]),
    ("daq/daq_offline_r50_ovis.yaml", ["test.task=vos"]),
    # open vocabulary: the three architectures on ConvNeXt-L and RN50, VIS,
    # VPS and VSS, the *_ov names and the void-row settings
    ("ov/ov_online_convnextl_zeroshot_ytvis19.yaml", []),
    ("ov/ov_minvis_convnextl_zeroshot_ytvis19.yaml", []),
    ("ov/ov_offline_convnextl_zeroshot_ytvis19.yaml", []),
    ("ov/ov_online_r50_zeroshot_ytvis19.yaml", []),
    ("ov/ov_offline_r50_zeroshot_vipseg.yaml", []),
    ("ov/ov_online_convnextl_zeroshot_vspw.yaml", []),
    ("ov/ov_online_convnextl_supervised.yaml", ["model.ov.void_merge_mode=max"]),
    ("ov/ov_online_convnextl_coco.yaml", ["model.meta_architecture=dvis_offline_ov"]),
    ("ov/fcclip_r50_coco.yaml", ["model.meta_architecture=ctvis"]),
    # COCO panoptic pseudo-videos as a test set: the JAX test loader maps
    # them (tests/test_torch_ov_data.py)
    ("daq/daq_vos_r50_ytvos.yaml", ["datasets.dataset_type_test=[image_panoptic]"]),
]


@pytest.mark.parametrize("yaml_name,overrides", SLICE_CASES)
def test_ported_slices_pass_the_check(yaml_name, overrides):
    port_config.check_supported(port_config.load_config(os.path.join("configs", yaml_name), overrides))


REFUSED_CASES = [
    # VOS and MOTS go to the DAQ eval loop: only with a daq_* architecture
    ("dvis/dvis_online_r50_vipseg.yaml", ["test.task=vos"], "test.task"),  # VOS
    ("dvis/dvis_offline_r50_vspw.yaml", ["test.task=mots"], "test.task"),  # MOTS
    ("daq/daq_vos_r50_ytvos.yaml", ["model.meta_architecture=dvis_online"], "test.task"),
    ("daq/daq_online_r50_ytvis19.yaml", ["test.task=vos", "model.meta_architecture=minvis"], "test.task"),
    # open vocabulary on a DAQ model (the JAX package has none); a CLIP trunk without it
    ("ov/ov_online_r50_zeroshot_ytvis19.yaml", ["model.meta_architecture=daq_online"], "model.ov.enabled"),
    ("ov/ov_online_r50_zeroshot_ytvis19.yaml", ["model.ov.enabled=false"], "model.backbone.name"),
    ("daq/daq_online_r50_ytvis19.yaml", ["model.meta_architecture=daq_online_ov"],
     "model.meta_architecture"),  # an OV architecture
    ("daq/daq_offline_r50_ovis.yaml", ["model.ov.enabled=true"], "model.ov.enabled"),
    ("daq/daq_vos_r50_ytvos.yaml", ["datasets.dataset_type_test=[image_semantic]"],
     "datasets.dataset_type_test"),
    # the open-vocabulary segmenter builds MSDeformAttn whatever the name
    ("dvis/dvis_online_r50_ytvis19.yaml",
     ["model.pixel_decoder.name=fpn", "model.ov.enabled=true", "model.backbone.name=clip_rn50"],
     "model.pixel_decoder.name"),
    ("dvis/dvis_online_r50_ytvis19.yaml", ["test.task=mots"], "test.task"),
    ("dvis/dvis_online_r50_ytvis19.yaml", ["model.ov.enabled=true"], "model.ov.enabled"),
    ("dvis/dvis_online_r50_ytvis19.yaml", ["model.sem_seg_head=fcclip"], "model.sem_seg_head"),
    ("dvis/dvis_online_r50_ytvis19.yaml", ["model.backbone.name=clip_rn50"], "model.backbone.name"),
    # swin_fast_softmax is served; another unported value beside it is not
    ("dvis/dvis_offline_swinl_ytvis19.yaml",
     ["model.backbone.swin_fast_softmax=true", "model.backbone.clip_model_type=vit"],
     "model.backbone.clip_model_type"),
    # the limits hold for the MinVIS, CTVIS and Video Mask2Former slices too
    ("dvis/minvis_r50_ytvis19.yaml", ["model.pixel_decoder.name=transformer_encoder"],
     "model.pixel_decoder.name"),  # a decoder no package builds
    ("dvis/ctvis_r50_ytvis19.yaml", ["model.ov.enabled=true"], "model.ov.enabled"),
    # and for DVIS-DAQ
    ("daq/daq_online_r50_vipseg.yaml", ["model.pixel_decoder.name=fpn", "model.ov.enabled=true"],
     "model.pixel_decoder.name"),
    # and for open vocabulary
    ("ov/ov_online_convnextl_coco.yaml", ["model.backbone.clip_model_type=vit"],
     "model.backbone.clip_model_type"),
]


# A6 and the Swin serving knob: the FPN pixel decoder on every YAML whose
# model the JAX package builds on its Segmenter (every closed-vocabulary
# architecture but the two clip Mask2Formers, which build MSDeformAttn
# whatever the name, as the open-vocabulary models do), in eval and in
# training; bf16 scores on every Swin YAML
CLOSED_YAMLS = sorted(
    os.path.relpath(p, "configs") for p in glob.glob("configs/*/*.yaml")
    if not p.startswith("configs/ov/") and "maskformer" not in os.path.basename(p))
SWIN_YAMLS = sorted(os.path.relpath(p, "configs") for p in glob.glob("configs/*/*swinl*.yaml"))


@pytest.mark.parametrize("yaml_name", CLOSED_YAMLS)
def test_fpn_pixel_decoder_passes_on_closed_vocabulary_yamls(yaml_name):
    cfg = port_config.load_config(os.path.join("configs", yaml_name), ["model.pixel_decoder.name=fpn"])
    port_config.check_supported(cfg)
    assert cfg.model.pixel_decoder.name == "fpn"


@pytest.mark.parametrize("yaml_name", SWIN_YAMLS)
def test_swin_fast_softmax_passes_on_swin_yamls(yaml_name):
    cfg = port_config.load_config(os.path.join("configs", yaml_name),
                                  ["model.backbone.swin_fast_softmax=true"])
    port_config.check_supported(cfg)
    assert cfg.model.backbone.swin_fast_softmax is True


@pytest.mark.parametrize("yaml_name", ["dvis/maskformer_r50_coco.yaml",
                                       "dvis/video_maskformer_r50_coco_joint.yaml",
                                       "dvis/video_maskformer_r50_ytvis19.yaml",
                                       "ov/ov_online_r50_zeroshot_ytvis19.yaml",
                                       "ov/fcclip_r50_coco.yaml"])
def test_fpn_is_refused_where_nothing_reads_it(yaml_name):
    cfg = port_config.load_config(os.path.join("configs", yaml_name), ["model.pixel_decoder.name=fpn"])
    with pytest.raises(NotImplementedError, match=r"model\.pixel_decoder\.name='fpn'"):
        port_config.check_supported(cfg)


def test_fpn_trains_on_the_staged_recipe():
    for yaml_name in ("dvis/minvis_r50_ytvis19.yaml", "dvis/dvis_online_r50_ytvis19.yaml",
                      "dvis/dvis_offline_r50_ytvis19.yaml"):
        port_config.check_trainable(port_config.load_config(
            os.path.join("configs", yaml_name), ["model.pixel_decoder.name=fpn"]))
    assert "model.backbone.swin_fast_softmax" not in {key for key, _, _ in port_config.SUPPORTED}


# multi-device eval (A15): the values the port once refused, now served
A15_EVAL_CASES = [
    ("dvis/dvis_online_r50_ytvis19.yaml", ["test.refiner_shard_devices=2"]),
    ("dvis/dvis_online_r50_ytvis19.yaml", ["test.eval_devices=4"]),
    ("dvis/dvis_online_r50_ytvis19.yaml", ["test.eval_devices=0"]),
    ("dvis/video_maskformer_r50_ytvis19.yaml", ["test.eval_devices=2"]),
    ("daq/daq_offline_r50_ovis.yaml", ["test.eval_devices=2"]),
    ("ov/ov_offline_convnextl_zeroshot_ytvis19.yaml", ["test.eval_devices=2"]),
]


@pytest.mark.parametrize("yaml_name,overrides", A15_EVAL_CASES)
def test_multi_device_eval_settings_pass_the_check(yaml_name, overrides):
    port_config.check_supported(port_config.load_config(os.path.join("configs", yaml_name), overrides))
    assert not any("A15" in item for _, _, item in port_config.SUPPORTED + port_config.TRAINABLE)


@pytest.mark.parametrize("yaml_name,overrides,key", REFUSED_CASES)
def test_unported_settings_raise_with_the_key(yaml_name, overrides, key):
    cfg = port_config.load_config(os.path.join("configs", yaml_name), overrides)
    with pytest.raises(NotImplementedError) as exc:
        port_config.check_supported(cfg)
    msg = str(exc.value)
    assert key + "=" in msg and ("ROADMAP A" in msg or "ROADMAP queue A" in msg), msg


def test_check_names_every_fault_at_once():
    cfg = port_config.load_config(
        "configs/dvis/dvis_online_r50_ytvis19.yaml",
        ["test.task=vos", "model.pixel_decoder.name=fpn", "model.meta_architecture=video_maskformer"])
    with pytest.raises(NotImplementedError) as exc:
        port_config.check_supported(cfg)
    assert "test.task='vos'" in str(exc.value) and "model.pixel_decoder.name='fpn'" in str(exc.value)


def test_inherited_jax_defaults_pass_and_presets_pass():
    """The JAX package's own Config (``test.mask_download='runs'``,
    ``test.eval_pipeline=True`` by default, the port's defaults too) passes:
    the parity tests hand such a config to ``run_vis_inference``. The
    YAML-free presets pass too."""
    jax_cfg = load_config(YAML)
    assert jax_cfg.test.mask_download == "runs" and jax_cfg.test.eval_pipeline is True
    port_config.check_supported(jax_cfg)
    jax_cfg.test.task = "vos"
    with pytest.raises(NotImplementedError, match=r"test\.task"):
        port_config.check_supported(jax_cfg)
    for preset in (dvis_online_r50_ytvis19, dvis_offline_swinl_ytvis19, dvis_offline_vitl_ytvis19,
                   minvis_r50_ytvis19, ctvis_r50_ytvis19, video_maskformer_r50_ytvis19,
                   dvis_online_r50_vipseg, dvis_online_r50_vspw, daq_online_r50_ytvis19,
                   daq_offline_r50_ovis, *OV_PRESETS):
        port_config.check_supported(preset())


@pytest.mark.parametrize("key,value", [("test.task", "vos"), ("model.pixel_decoder.name", "pixel_shuffle"),
                                       ("model.ov.enabled", "true")])
def test_run_vis_inference_refuses_before_it_reads_a_video(key, value):
    from dvis_plus_tpu_torch.engine.inference import run_vis_inference

    cfg = port_config.load_config(YAML, [f"{key}={value}"])

    def loader():
        raise AssertionError("the loader was read")
        yield

    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        run_vis_inference(cfg, None, loader(), None)


def test_cli_refuses_an_unported_setting(tmp_path):
    from dvis_plus_tpu_torch import cli

    with pytest.raises(NotImplementedError, match=r"test\.task='vos'"):
        cli.main(["--config-file", "configs/dvis/dvis_online_r50_vipseg.yaml", "--eval-only",
                  "--device", "cpu", "test.task=vos", f"output_dir={tmp_path}"])
    with pytest.raises(NotImplementedError, match=r"model\.ov\.enabled=True"):
        cli.main(["--config-file", "configs/daq/daq_online_r50_ytvis19.yaml", "--eval-only",
                  "--device", "cpu", "model.ov.enabled=true", f"output_dir={tmp_path}"])


# ---------------------------------------------------------------------------
# check_trainable: what training honours (DVIS++ online on video instance sets)
# ---------------------------------------------------------------------------


def test_check_trainable_accepts_the_online_yaml_and_preset():
    port_config.check_trainable(port_config.load_config(YAML))
    port_config.check_trainable(dvis_online_r50_ytvis19())
    port_config.check_trainable(port_config.load_config(YAML, [
        "model.tracker.noise_mode=cc", "model.criterion.matcher_solver=auction",
        "input.crop_enabled=true", "input.random_flip=none", "parallel.model_parallel_size=1"]))


@pytest.mark.parametrize("yaml_name,overrides", [
    ("configs/dvis/minvis_r50_ytvis19.yaml", []),
    ("configs/dvis/ctvis_r50_ytvis19.yaml", ["model.criterion.reid_weight=1.0"]),
    ("configs/dvis/ctvis_r50_ovis.yaml", ["model.backbone.name=resnet101"]),
    ("configs/dvis/dvis_offline_r50_ytvis19.yaml", []),
    ("configs/dvis/dvis_offline_swinl_ytvis19.yaml", []),  # the segmenter frozen: no gradient
    (YAML, ["model.freeze=[]"]),  # the segmenter decays without gradients, as in the JAX package
    # a Swin or ViT segmenter trained: Swin's window attention and an
    # unfrozen ViT trunk through their plain ops in training mode
    ("configs/dvis/dvis_offline_swinl_ytvis19.yaml", ["model.freeze=[tracker]"]),
    ("configs/dvis/minvis_r50_ytvis19.yaml", ["model.backbone.name=swin_l"]),
    ("configs/dvis/minvis_vitl_ytvis19.yaml", ["model.backbone.vit_frozen=false"]),
    ("configs/dvis/minvis_vitl_ytvis19.yaml", ["model.backbone.vit_flash_attention=true"]),
    # the COCO pseudo-video recipe; need_map changes no batch (in the JAX package either)
    ("configs/dvis/video_maskformer_r50_coco_joint.yaml",
     ["input.pseudo=true", "input.lsj_aug=true", "input.augmentations=[brightness,contrast,saturation]"]),
    ("configs/dvis/maskformer_r50_coco.yaml", ["datasets.dataset_need_map=[true]"]),
    ("configs/dvis/video_maskformer_r50_ytvis19.yaml",
     ["datasets.train=[ytvis_2019_train,coco2ytvis2019_train]",
      "datasets.dataset_type=[video_instance,image_instance]", "datasets.dataset_ratio=[1.0,0.5]"]),
    # open vocabulary (A14c.5): the *_ov names, and COCO panoptic
    # pseudo-videos for a closed model too (its mapper reads the recipe's inputs)
    (YAML, ["model.meta_architecture=dvis_online_ov", "model.backbone.name=clip_convnext_l"]),
    ("configs/ov/ov_offline_convnextl_zeroshot_ytvis19.yaml", ["model.tracker.noise_mode=hard"]),
    ("configs/dvis/maskformer_r50_coco.yaml", ["datasets.dataset_type=[image_panoptic]", "input.lsj_aug=true"]),
    ("configs/dvis/dvis_online_r50_vipseg.yaml", ["datasets.dataset_type=[video_panoptic,image_panoptic]"]),
])
def test_check_trainable_accepts_stages_1_and_3(yaml_name, overrides):
    port_config.check_trainable(port_config.load_config(yaml_name, overrides))


TRAIN_REFUSED = [
    # CTVIS trains no OV model (the JAX CLI keeps it ctvis: no OV loss); the
    # OV tracker noises with 'wa' whatever noise_mode says, in the JAX package
    ("configs/ov/fcclip_r50_coco.yaml", ["model.meta_architecture=ctvis"], "model.meta_architecture",
     '"Tree state"'),
    ("configs/ov/ov_offline_convnextl_zeroshot_ytvis19.yaml", ["model.tracker.noise_mode=rs"],
     "model.tracker.noise_mode", "A14b"),
    # an unfrozen ViT trunk trained through B3, which is forward only
    ("configs/dvis/minvis_vitl_ytvis19.yaml",
     ["model.backbone.vit_frozen=false", "model.backbone.vit_flash_attention=true"],
     "model.backbone.vit_flash_attention", "queue B"),
    ("configs/dvis/maskformer_r50_coco.yaml", ["datasets.dataset_type=[image_semantic]"],
     "datasets.dataset_type", "A14c"),
    ("configs/dvis/maskformer_r50_coco.yaml", ["input.augmentations=[hue]"], "input.augmentations",
     "A14c.2"),
    (YAML, ["model.param_dtype=bfloat16"], "model.param_dtype", "A14b"),
    (YAML, ["model.tracker.noise_mode=mixup"], "model.tracker.noise_mode", "A14b"),
    (YAML, ["model.criterion.matcher_solver=greedy"], "model.criterion.matcher_solver", "A14b"),
    ("configs/dvis/dvis_online_r50_vipseg.yaml", ["datasets.dataset_type=[video_panoptic,image_semantic]"],
     "datasets.dataset_type", "A14c"),
    (YAML, ["input.pseudo=true"], "input.pseudo", "A14c"),
    (YAML, ["input.lsj_aug=true"], "input.lsj_aug", "A14c"),
    (YAML, ["input.augmentations=[brightness]"], "input.augmentations", "A14c"),
    # keys no code reads, in either package: only their defaults pass
    (YAML, ["model.criterion.deep_supervision=false"], "model.criterion.deep_supervision", "A14b"),
    (YAML, ["model.criterion.reid_weight=1.0"], "model.criterion.reid_weight", "A14c"),
    (YAML, ["model.criterion.aux_reid_weight=1.0"], "model.criterion.aux_reid_weight", "A14c"),
    (YAML, ["input.sampling_interval=2"], "input.sampling_interval", "A14b"),
    (YAML, ["input.image_format=BGR"], "input.image_format", "A14b"),
    (YAML, ["solver.amp=false"], "solver.amp", "A14b"),
]


@pytest.mark.parametrize("overrides", [["parallel.model_parallel_size=2"], ["test.eval_devices=2"]])
def test_check_trainable_accepts_multi_device_settings(overrides, monkeypatch):
    """A model group of two ranks and video-parallel eval (A15): training
    takes them, at two processes too."""
    port_config.check_trainable(port_config.load_config(YAML, overrides))
    monkeypatch.setenv("WORLD_SIZE", "2")
    port_config.check_trainable(port_config.load_config(YAML, overrides))


@pytest.mark.parametrize("yaml_name,overrides,key,item", TRAIN_REFUSED)
def test_check_trainable_refuses_with_the_key_and_item(yaml_name, overrides, key, item):
    cfg = port_config.load_config(yaml_name, overrides)
    with pytest.raises(NotImplementedError) as exc:
        port_config.check_trainable(cfg)
    assert key + "=" in str(exc.value) and f"ROADMAP {item}" in str(exc.value), str(exc.value)


TRAINABLE_YAMLS = sorted(
    [f"configs/dvis/{a}_vitl_{d}.yaml" for a in ("minvis", "ctvis") for d in ("ytvis19", "ytvis21", "ovis")]
    + [f"configs/dvis/{n}.yaml" for n in ("maskformer_r50_coco", "video_maskformer_r50_coco_joint",
                                           "video_maskformer_r50_ytvis19")])


@pytest.mark.parametrize("yaml_name", TRAINABLE_YAMLS)
def test_check_trainable_accepts_the_vitl_and_coco_yamls(yaml_name):
    """Every ViT-L MinVIS / CTVIS YAML on a video instance set, and the
    three Mask2Former / Video Mask2Former YAMLs."""
    cfg = port_config.load_config(yaml_name)
    assert set(cfg.datasets.dataset_type) <= {"video_instance", "image_instance"}
    port_config.check_trainable(cfg)


def _daq_yamls(reid_branch: bool):
    return [p for p in sorted(glob.glob("configs/daq/*.yaml"))
            if port_config.load_config(p).model.transformer_decoder.reid_branch == reid_branch]


def _refused_training_yamls():
    """The DVIS-DAQ YAMLs that inherit the DVIS++ ReID branch (the R50 ones
    and ``daq_online_swinl_ovis.yaml``), with which no DAQ model builds (in
    the JAX package either)."""
    return [(p, "model.transformer_decoder.reid_branch=True") for p in _daq_yamls(True)]


@pytest.mark.parametrize("yaml_name,item", _refused_training_yamls())
def test_check_trainable_refuses_the_vps_vss_daq_and_ov_yamls(yaml_name, item):
    """What training still refuses among the VPS, VSS, DVIS-DAQ and
    open-vocabulary YAMLs, naming the key: the R50 DAQ YAMLs and the Swin-L
    OVIS one (their ReID branch); no open-vocabulary YAML
    (:func:`test_check_trainable_accepts_the_ov_yamls`)."""
    with pytest.raises(NotImplementedError) as exc:
        port_config.check_trainable(port_config.load_config(yaml_name))
    assert item in str(exc.value), str(exc.value)


OV_YAMLS = sorted(glob.glob("configs/ov/*.yaml"))


@pytest.mark.parametrize("yaml_name", OV_YAMLS)
def test_check_trainable_accepts_the_ov_yamls(yaml_name):
    """Every open-vocabulary YAML (A14c.5): the FC-CLIP segmenter, OV-DVIS++
    online and offline, on COCO panoptic pseudo-videos, the video sets and
    the supervised mixtures; no row of the tables names A14c.5 any more."""
    assert len(OV_YAMLS) == 48
    port_config.check_trainable(port_config.load_config(yaml_name))
    rows = port_config.SUPPORTED + port_config.TRAINABLE
    assert not any("A14c.5" in item for _, _, item in rows)


def _trainable_vps_vss_daq_yamls():
    return sorted(glob.glob("configs/dvis/*_vipseg.yaml") + glob.glob("configs/dvis/*_vspw.yaml")
                  + _daq_yamls(False))


@pytest.mark.parametrize("yaml_name", _trainable_vps_vss_daq_yamls())
def test_check_trainable_accepts_the_vps_vss_and_daq_yamls(yaml_name):
    """Every VIPSeg and VSPW YAML of ``configs/dvis/`` (A14c.3) and every
    DVIS-DAQ YAML whose model builds (A14c.4: ViT-L and Swin-L, online,
    offline and VOS)."""
    assert len(_daq_yamls(False)) == 11
    port_config.check_trainable(port_config.load_config(yaml_name))


def test_a_daq_yaml_trains_with_the_reid_branch_off():
    cfg = port_config.load_config("configs/daq/daq_online_r50_vipseg.yaml",
                                  ["model.transformer_decoder.reid_branch=false"])
    port_config.check_trainable(cfg)
    assert cfg.datasets.dataset_type == ("video_panoptic",)


def test_check_trainable_accepts_more_than_one_process(monkeypatch):
    """Data-parallel training (A15): ``WORLD_SIZE`` is no fault."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    port_config.check_trainable(port_config.load_config(YAML))


@pytest.mark.parametrize("yaml_name", ALL_YAMLS)
def test_every_yaml_checks_the_same_at_two_processes(yaml_name, monkeypatch):
    """Each YAML passes or fails ``check_supported`` and ``check_trainable``
    with ``WORLD_SIZE=2`` as it does in one process."""
    cfg = port_config.load_config(os.path.join("configs", yaml_name))

    def outcome(check):
        try:
            check(cfg)
            return None
        except NotImplementedError as e:
            return str(e)

    alone = [outcome(port_config.check_supported), outcome(port_config.check_trainable)]
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert [outcome(port_config.check_supported), outcome(port_config.check_trainable)] == alone
