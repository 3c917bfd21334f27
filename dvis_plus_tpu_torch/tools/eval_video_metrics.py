"""Offline VPS / VSS scoring CLI over the port's
:mod:`dvis_plus_tpu_torch.evaluation.offline_scoring` (the reference's
standalone scorers ``DVIS_Plus/utils/eval_{vpq,stq,miou,vc}_vspw.py``).

Counterpart: ``tools/eval_video_metrics.py`` of the JAX package, with the
same subcommands and flags.

Usage:
  python -m dvis_plus_tpu_torch.tools.eval_video_metrics vps --pred-dir OUT/inference/<ds> \\
      --gt-json .../panoptic_gt_VIPSeg_val.json --gt-dir .../panomasksRGB
  python -m dvis_plus_tpu_torch.tools.eval_video_metrics vss --pred-dir OUT/inference/<ds> \\
      --gt-root .../VSPW_480p [--split val] [--num-classes 124]
"""
from __future__ import annotations

import argparse
import json

from dvis_plus_tpu_torch.evaluation.offline_scoring import score_vps, score_vss


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="task", required=True)

    vps = sub.add_parser("vps", help="VPQ + STQ on VPSEvaluator output")
    vps.add_argument("--pred-dir", required=True)
    vps.add_argument("--gt-json", required=True)
    vps.add_argument("--gt-dir", required=True)
    vps.add_argument("--windows", type=int, nargs="+", default=[1, 2, 4, 6])
    vps.add_argument("--num-workers", type=int, default=0)

    vss = sub.add_parser("vss", help="mIoU + VC on VSSEvaluator output")
    vss.add_argument("--pred-dir", required=True)
    vss.add_argument("--gt-root", required=True)
    vss.add_argument("--split", default="val")
    vss.add_argument("--num-classes", type=int, default=124)
    vss.add_argument("--vc-clips", type=int, nargs="+", default=[8, 16])

    args = ap.parse_args(argv)
    if args.task == "vps":
        res = score_vps(
            args.pred_dir, args.gt_json, args.gt_dir,
            windows=tuple(args.windows), num_workers=args.num_workers,
        )
    else:
        res = score_vss(
            args.pred_dir, args.gt_root, split=args.split,
            num_classes=args.num_classes, vc_clips=tuple(args.vc_clips),
        )
    print(json.dumps({k: res[k] for k in sorted(res)}, indent=2))
    return res


if __name__ == "__main__":
    main()
