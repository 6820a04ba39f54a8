"""BONAI F1 / offset-error evaluation CLI (counterpart of
``tools/bonai/bonai_evaluation.py``): pkl -> roof and footprint polygons
-> polygon F1 at IoU ``--iou`` for roofs and footprints, offset EPE.

    python -m bonai_tpu_torch.tools.bonai_evaluation results.pkl \\
        --gt-json ann.json [--merge] [--score-thr 0.4] [--min-area 500] \\
        [--iou 0.5] [--csv-prefix PREFIX] [--out-csv summary.csv]

The ground truth comes from a BONAI json (roof ``segmentation``,
``footprint_mask`` and ``offset``) or from a roof CSV.  ``--merge`` scores
1024² crops named ``base__x_y`` merged back into their original images.
The printed lines and the summary CSV are the JAX CLI's.
"""

from __future__ import annotations

import argparse
import csv
import pickle

import numpy as np

from ..datasets.coco_api import COCOIndex
from ..evaluation.bonai_eval import (dump_csv, load_csv, merge_crop_records,
                                     offset_error_vector, poly_area,
                                     polygon_f1, results_to_csv_records)


def gt_records_from_json(ann_file, min_area=500):
    """Per-image GT records of a BONAI json: the first roof part, the
    footprint (or the roof moved by -offset), the offset; footprints under
    ``min_area`` dropped."""
    coco = COCOIndex(ann_file)
    records = {}
    for img_id, info in coco.imgs.items():
        recs = []
        for ann in coco.load_anns_for_img(img_id):
            roof = np.asarray(ann["segmentation"][0],
                              np.float32).reshape(-1, 2)
            fp = (np.asarray(ann["footprint_mask"], np.float32)
                  .reshape(-1, 2) if "footprint_mask" in ann
                  else roof - np.asarray(ann.get("offset", (0, 0)),
                                         np.float32))
            if poly_area(fp) < min_area:
                continue
            recs.append(dict(polygon=roof, footprint_polygon=fp,
                             score=1.0,
                             offset=np.asarray(ann.get("offset", (0, 0)),
                                               np.float32)))
        records[info.get("file_name", str(img_id))] = recs
    return records


def main(argv=None):
    parser = argparse.ArgumentParser(description="BONAI evaluation")
    parser.add_argument("pkl", help="results pkl from bonai_test")
    parser.add_argument("--gt-json", default=None)
    parser.add_argument("--gt-roof-csv", default=None)
    parser.add_argument("--gt-footprint-csv", default=None)
    parser.add_argument("--score-thr", type=float, default=0.4)
    parser.add_argument("--min-area", type=float, default=500)
    parser.add_argument("--iou", type=float, default=0.5)
    parser.add_argument("--merge", action="store_true",
                        help="merge crop1024 tiles to original images")
    parser.add_argument("--csv-prefix", default=None,
                        help="dump roof/footprint csv artifacts")
    parser.add_argument("--out-csv", default=None,
                        help="summary csv path")
    args = parser.parse_args(argv)

    with open(args.pkl, "rb") as f:
        payload = pickle.load(f)
    results = payload["results"]
    filenames = payload["filenames"]

    pred = results_to_csv_records(results, filenames,
                                  score_thr=args.score_thr,
                                  min_area=args.min_area)
    if args.merge:
        pred = merge_crop_records(pred)
    if args.csv_prefix:
        dump_csv(pred, args.csv_prefix + "_roof.csv", key="polygon")
        dump_csv(pred, args.csv_prefix + "_footprint.csv",
                 key="footprint_polygon")

    if args.gt_json:
        gt = gt_records_from_json(args.gt_json, min_area=args.min_area)
    elif args.gt_roof_csv:
        gt = load_csv(args.gt_roof_csv)
    else:
        parser.error("need --gt-json or --gt-roof-csv")
    if args.merge:
        # merged records are keyed by the extension-less scene stem
        gt = {k.rsplit(".", 1)[0] if "." in k else k: v
              for k, v in gt.items()}

    summary = {}
    for key, name in (("polygon", "roof"),
                      ("footprint_polygon", "footprint")):
        metrics, matches = polygon_f1(pred, gt, iou_thr=args.iou, key=key)
        summary.update({f"{name}_{k}": v for k, v in metrics.items()})
        print(f"[{name}] P={metrics['precision']:.4f} "
              f"R={metrics['recall']:.4f} F1={metrics['f1']:.4f} "
              f"(TP={metrics['tp']} FP={metrics['fp']} FN={metrics['fn']})")
        if name == "footprint":
            off = offset_error_vector(pred, gt, matches)
            summary.update(off)
            print(f"[offset] aEPE={off['aEPE']:.3f} aAE={off['aAE']:.4f} "
                  f"cos={off['cos_distance']:.4f} "
                  f"({off['matched']} matched)")
    if args.out_csv:
        with open(args.out_csv, "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(list(summary))
            wr.writerow([f"{v:.4f}" if isinstance(v, float) else v
                         for v in summary.values()])
        print(f"wrote {args.out_csv}")
    return summary


if __name__ == "__main__":
    main()
