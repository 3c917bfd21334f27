"""The port's tool twins against the JAX package's tools on the same inputs:
the synthetic-data writer's trees byte for byte (every dataset and layout),
the COCO -> pseudo-video and VOS -> COCO-video converters' json byte for
byte, and the offline VPS / VSS scorer on the three cases of
``tests/test_eval_video_metrics_tool.py`` (equal result dicts; the same
``KeyError``)."""
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import tests.test_eval_video_metrics_tool as jax_case  # noqa: E402

DATASETS = ["ytvis_2019", "ytvis_2021", "ovis", "lvvis", "bdd", "vipseg", "vspw", "coco"]


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fp:
                out[os.path.relpath(p, root)] = fp.read()
    return out


def _run_jax_main(module, argv):
    old = sys.argv
    sys.argv = [module.__file__] + argv
    try:
        module.main()
    finally:
        sys.argv = old


def test_synth_data_trees_are_byte_equal(tmp_path):
    import synth_data as jax_synth

    from dvis_plus_tpu_torch.tools import synth_data

    _run_jax_main(jax_synth, ["--root", str(tmp_path / "jax"), "--datasets", *DATASETS])
    synth_data.main(["--root", str(tmp_path / "port"), "--datasets", *DATASETS])
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert len(want) > 100 and sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []


def test_synth_data_default_datasets_and_errors(tmp_path, capsys):
    from dvis_plus_tpu_torch.tools import synth_data

    synth_data.main(["--root", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == ["VIPSeg", "VSPW_480p", "coco", "ovis", "ytvis_2019",
                                            "ytvis_2021"]
    with pytest.raises(SystemExit, match="unknown dataset"):
        synth_data.main(["--root", str(tmp_path), "--datasets", "kitti"])


@pytest.mark.parametrize("mapping", ["none", "ytvis19", "ytvis21", "ovis"])
def test_coco2ytvis_json_is_byte_equal(tmp_path, mapping):
    import coco2ytvis as jax_tool

    from dvis_plus_tpu_torch.tools import coco2ytvis, synth_data

    synth_data.make_coco(str(tmp_path), n_images=5)
    coco = json.load(open(tmp_path / "coco/annotations/instances_train2017.json"))
    for i, ann in enumerate(coco["annotations"]):  # ids the maps keep and drop
        ann["category_id"] = [1, 3, 7, 18, 90][i % 5]
    src = tmp_path / "instances.json"
    json.dump(coco, open(src, "w"))
    _run_jax_main(jax_tool, ["--input", str(src), "--output", str(tmp_path / "jax.json"),
                             "--map", mapping])
    coco2ytvis.main(["--input", str(src), "--output", str(tmp_path / "port.json"), "--map", mapping])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_convert_vos_to_cocovid_json_is_byte_equal(tmp_path):
    import cv2

    import convert_vos_to_cocovid as jax_tool

    from dvis_plus_tpu_torch.tools import convert_vos_to_cocovid

    rng = np.random.RandomState(0)
    for v, n in (("vidA", 4), ("vidB", 3)):
        os.makedirs(tmp_path / "JPEGImages" / v)
        os.makedirs(tmp_path / "Annotations" / v)
        for t in range(n):
            cv2.imwrite(str(tmp_path / "JPEGImages" / v / f"{t:05d}.jpg"),
                        rng.randint(0, 255, (24, 32, 3), np.uint8))
            if v == "vidB" and t == 1:
                continue  # a frame without a mask
            m = np.zeros((24, 32), np.uint8)
            m[2 + t:10 + t, 3:12] = 1
            m[12:20, 10 + 2 * t:20 + 2 * t] = 2 if t < 2 else 3
            cv2.imwrite(str(tmp_path / "Annotations" / v / f"{t:05d}.png"), m)
    args = ["--images", str(tmp_path / "JPEGImages"), "--masks", str(tmp_path / "Annotations")]
    _run_jax_main(jax_tool, args + ["--output", str(tmp_path / "jax.json")])
    convert_vos_to_cocovid.main(args + ["--output", str(tmp_path / "port.json")])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert len(json.load(open(tmp_path / "port.json"))["annotations"]) == 6


def _vps_case(tmp_path, unknown: bool):
    gt_dir, pred_dir = tmp_path / "panomasksRGB", tmp_path / "pred"
    gt_anno = jax_case._vps_tree(str(gt_dir), "gt", (4, 9, 11), crowd_gt=not unknown)
    pred_anno = jax_case._vps_tree(str(pred_dir / "pan_pred"), "pr",
                                   (4, 9, 11) if unknown else (70, 3, 12))
    if unknown:
        pred_anno["annotations"][0]["segments_info"][0]["category_id"] = 99
    gt_json = tmp_path / "gt.json"
    json.dump({"categories": [{"id": 2, "name": "cat", "isthing": 1},
                              {"id": 5, "name": "sky", "isthing": 0},
                              {"id": 7, "name": "dog", "isthing": 1}],
               "annotations": [gt_anno]}, open(gt_json, "w"))
    json.dump({"annotations": [pred_anno]}, open(pred_dir / "pred.json", "w"))
    return ["vps", "--pred-dir", str(pred_dir), "--gt-json", str(gt_json), "--gt-dir", str(gt_dir)]


def test_eval_video_metrics_vps_perfect_prediction(tmp_path):
    from dvis_plus_tpu_torch.tools.eval_video_metrics import main

    argv = _vps_case(tmp_path, unknown=False) + ["--windows", "1", "2", "4"]
    got = main(argv)
    assert got == jax_case.tool_main(argv)
    for k in ("VPQ", "VPQ@1", "VPQ@2", "VPQ@4", "SQ", "AQ", "STQ"):
        assert got[k] == 100.0, (k, got)


def test_eval_video_metrics_vps_rejects_unknown_category(tmp_path):
    from dvis_plus_tpu_torch.tools.eval_video_metrics import main

    argv = _vps_case(tmp_path, unknown=True)
    with pytest.raises(KeyError, match="unknown category_id 99"):
        jax_case.tool_main(argv)
    with pytest.raises(KeyError, match="unknown category_id 99"):
        main(argv)


def test_eval_video_metrics_vss_perfect_prediction(tmp_path):
    import cv2

    from dvis_plus_tpu_torch.tools.eval_video_metrics import main

    H, W, T = jax_case.H, jax_case.W, jax_case.T
    gt_root, pred_dir = tmp_path / "VSPW", tmp_path / "pred"
    names = ["v1", "v2"]
    for vid in names:
        for t in range(T):
            m = np.full((H, W), 3 + (t % 2), np.uint8)
            m[:8] = 1
            m[0, 0] = 0
            p = gt_root / "data" / vid / "mask" / f"{t:05d}.png"
            os.makedirs(p.parent, exist_ok=True)
            cv2.imwrite(str(p), m)
            shifted = np.where(m == 0, 255, m.astype(np.int64) - 1)
            if vid == "v2" and t == 3:
                shifted[10:, :5] = 6  # one wrong patch: below 100 on both
            q = pred_dir / vid / f"{t:05d}.png"
            os.makedirs(q.parent, exist_ok=True)
            cv2.imwrite(str(q), shifted.astype(np.uint8))
    (gt_root / "val.txt").write_text("\n".join(names) + "\n")
    argv = ["vss", "--pred-dir", str(pred_dir), "--gt-root", str(gt_root), "--num-classes", "8",
            "--vc-clips", "2", "4"]
    got = main(argv)
    assert got == jax_case.tool_main(argv)
    assert got["videos"] == 2 and 0 < got["mIoU"] < 100.0


def test_zoo_runbook_dry_run(tmp_path, monkeypatch, capsys):
    """``tests/test_zoo_runbook.py``'s case on the port: the seeded random
    ``.pth`` -> coverage -> the eval CLI -> results.json -> the differ."""
    from dvis_plus_tpu_torch.tools import zoo_runbook

    monkeypatch.setenv("DVIS_DATASETS", str(tmp_path / "unused"))
    res = zoo_runbook.main(["--dry-run", "--output-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[runbook] convert: filled" in out and "0 mismatched, 0 left at init" in out
    assert "[runbook] eval: ytvis_2019_val" in out
    assert '"ok": true' in out and "[runbook] OK" in out
    assert res["convert"]["filled"] == res["convert"]["total"] > 100
    assert res["diff"]["rows"] > 0 and res["diff"]["min_pixel_agree"] == 1.0


def test_zoo_runbook_refuses_a_mismatched_checkpoint(tmp_path, capsys):
    import torch

    from dvis_plus_tpu_torch.cli import build_model
    from dvis_plus_tpu_torch.config import load_config
    from dvis_plus_tpu_torch.tools import zoo_runbook

    cfg = load_config("configs/dvis/dvis_online_r50_ytvis19.yaml", zoo_runbook.DRY_RUN_OPTS)
    sd = build_model(cfg.model).state_dict()
    sd["sem_seg_head.predictor.class_embed.weight"] = torch.zeros(3, 3)
    torch.save(sd, tmp_path / "bad.pth")
    with pytest.raises(SystemExit, match="FAIL convert: shape mismatches"):
        zoo_runbook.stage_convert(cfg, str(tmp_path / "bad.pth"))
    del sd["sem_seg_head.predictor.class_embed.weight"]
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(SystemExit, match="FAIL convert: keys left at init"):
        zoo_runbook.stage_convert(cfg, str(tmp_path / "short.pth"))


def test_serving_deviation_ap_reduced_run(tmp_path):
    """``tools/serving_deviation_ap.py`` on the port at 3 steps a stage: the
    staged recipe, the Swin and the ViT-Adapter MinVIS train through the
    port's trainer, and every knob scores the same weights through the CLI's
    eval loop (an AP in [0, 1] for each)."""
    import torch

    from dvis_plus_tpu_torch.tools import serving_deviation_ap as sda

    torch.set_num_threads(2)
    dev = torch.device("cpu")
    sda.write_synth(str(tmp_path / "data"))
    res = sda.measure(str(tmp_path), dev, steps_scale=0.0, min_steps=3)
    res.update(sda.measure_swin(str(tmp_path), dev, steps_scale=0.0, min_steps=3))
    res.update(sda.measure_vit(str(tmp_path), dev, steps_scale=0.0, min_steps=3))
    want = {"online": sda.VARIANTS, "offline": sda.VARIANTS, "swin": sda.SWIN_VARIANTS,
            "vit": sda.VIT_VARIANTS}
    for key, variants in want.items():
        assert list(res[key]) == [name for name, _ in variants], key
        assert all(0.0 <= ap <= 1.0 for ap in res[key].values()), res[key]
    assert os.path.exists(tmp_path / "stage3" / "checkpoints" / "step_0000003.pth")
