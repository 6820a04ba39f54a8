"""Proposal files for Fast R-CNN: an RPN's results pkl made into a
``proposal_file``, and a config that trains and tests from such files.

An RPN's pkl (``bonai_tpu_torch.tools.test --out``, as the JAX test CLI
writes it) holds, per image, the per-class list of one ``(N, 5)`` array
(boxes and scores in the original image's pixels).  ``LoadProposals`` reads
one ``(N, 4|5)`` array an image, so the file is that list's first entry,
image by image, in the order of the annotation file (test mode: no image
filtered out).  ROADMAP.md queue C records the two layouts.

    python -m bonai_tpu_torch.datasets.proposals RPN_PKL OUT_PKL
"""

from __future__ import annotations

import argparse
import copy
import pickle

import numpy as np


def rpn_results_to_proposals(results):
    """An RPN's per-image results -> the ``(N, 5)`` float32 array of each
    image: its one class's entry."""
    out = []
    for r in results:
        dets = r[0] if isinstance(r, tuple) else r
        if len(dets) != 1:
            raise ValueError(f"an RPN result holds one class, got "
                             f"{len(dets)}")
        out.append(np.asarray(dets[0], np.float32).reshape(-1, 5))
    return out


def write_proposal_file(rpn_pkl, out):
    """Convert the RPN results pkl ``rpn_pkl`` into the proposal file
    ``out``; returns the proposals."""
    with open(rpn_pkl, "rb") as f:
        props = rpn_results_to_proposals(pickle.load(f))
    with open(out, "wb") as f:
        pickle.dump(props, f)
    return props


def _with_proposals(pipeline, after, num_max_proposals):
    """``pipeline`` with ``LoadProposals`` after its step ``after`` and
    ``proposals`` collected (in a ``MultiScaleFlipAug`` too)."""
    out = []
    for step in pipeline:
        step = copy.deepcopy(step)
        if step.get("type") == "Collect" and "proposals" not in step["keys"]:
            step["keys"] = list(step["keys"]) + ["proposals"]
        if "transforms" in step:
            step["transforms"] = _with_proposals(step["transforms"], None,
                                                 num_max_proposals)
        out.append(step)
        if step.get("type") == after:
            out.append(dict(type="LoadProposals",
                            num_max_proposals=num_max_proposals))
    return out


def fast_rcnn_config(cfg, train_proposals=None, test_proposals=None,
                     num_max_proposals=2000):
    """``cfg`` (a Fast R-CNN config; changed in place and returned) reading
    proposal files: ``LoadProposals(num_max_proposals)`` in its train
    pipeline (after ``LoadAnnotations``) and its test pipeline (after
    ``LoadImageFromFile``), ``proposals`` collected, and the train and test
    splits' ``proposal_file`` (where given).  The test CLI can point the
    test split at another file with ``--options
    data.test.proposal_file=PATH``."""
    data = cfg.data
    data.train.pipeline = _with_proposals(data.train.pipeline,
                                          "LoadAnnotations",
                                          num_max_proposals)
    for split in ("val", "test"):
        if split in data:
            data[split].pipeline = _with_proposals(
                data[split].pipeline, "LoadImageFromFile", num_max_proposals)
    if train_proposals is not None:
        data.train.proposal_file = train_proposals
    if test_proposals is not None:
        data.test.proposal_file = test_proposals
    return cfg


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="RPN results pkl -> Fast R-CNN proposal file")
    parser.add_argument("rpn_pkl")
    parser.add_argument("out")
    args = parser.parse_args(argv)
    props = write_proposal_file(args.rpn_pkl, args.out)
    print(f"wrote {args.out}: {len(props)} images, "
          f"{sum(len(p) for p in props)} proposals")


if __name__ == "__main__":
    main()
