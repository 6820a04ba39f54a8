"""Dataset building, packing to fixed shapes and the host-side loader
(counterpart of ``bonai_tpu/datasets/builder.py``).

The loader yields fixed-shape numpy batches, the batch contract of
``train_detector``.  Every batch draws its augmentation from its own
``numpy.random.RandomState((seed + epoch) * 9973 + shard_id + bi)``, as the
JAX package's ``mode='process'`` loader does, whether it is built in a
thread (``mode='thread'``) or in a forked worker process
(``mode='process'``): both modes give the JAX process-mode batches.  The
workers run numpy only, never torch, so forking a process that holds a CUDA
context is safe.

Data-parallel training: the loader of rank ``r`` of ``W`` (``rank``,
``world_size``) yields that rank's rows ``r*spg:(r+1)*spg`` of the JAX
global batch of ``spg * W`` (the rows that ``shard_map`` gives device
``r``), step for step.  Rank 0 draws its rows' augmentation first from
the global batch's ``RandomState``, as the JAX loader does, so its batches
equal the JAX rows to the bit; rank ``r > 0`` draws from
``RandomState((seed_of_the_batch, r))`` (the JAX draws of rows past the
first rank are not kept: they would need the earlier rows' work).  The
``shard_id``/``num_shards`` split is the JAX multi-host split (other images
per step) and serves the sharded evaluation.
"""

from __future__ import annotations

import collections
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from ..registry import Registry, build_from_cfg
from ..utils.raster import fill_poly

DATASETS = Registry("dataset")
_NOT_PORTED = ("ClassBalancedDataset", "VOCDataset", "XMLDataset",
               "LVISDataset", "CityscapesDataset", "WIDERFaceDataset",
               "DeepFashionDataset")


def _register_defaults():
    from .bonai import BONAI
    from .coco import CocoDataset
    for cls in (CocoDataset, BONAI):
        if cls.__name__ not in DATASETS:
            DATASETS.register_module()(cls)


class ConcatDataset:
    """Datasets one after another (the per-city annotation files)."""

    def __init__(self, datasets):
        self.datasets = datasets
        self.cumlens = np.cumsum([len(d) for d in datasets])
        self.CLASSES = datasets[0].CLASSES

    def __len__(self):
        return int(self.cumlens[-1])

    def _locate(self, idx):
        ds = int(np.searchsorted(self.cumlens, idx, side="right"))
        prev = 0 if ds == 0 else int(self.cumlens[ds - 1])
        return self.datasets[ds], idx - prev

    def prepare(self, idx, rng=None):
        d, i = self._locate(idx)
        return d.prepare(i, rng)

    @property
    def test_mode(self):
        return self.datasets[0].test_mode

    def get_ann_info(self, idx):
        d, i = self._locate(idx)
        return d.get_ann_info(i)


class RepeatDataset:
    """A dataset repeated ``times`` over."""

    def __init__(self, dataset, times):
        self.dataset = dataset
        self.times = times
        self.CLASSES = dataset.CLASSES
        self._ori_len = len(dataset)

    def __len__(self):
        return self.times * self._ori_len

    def prepare(self, idx, rng=None):
        return self.dataset.prepare(idx % self._ori_len, rng)

    def get_ann_info(self, idx):
        return self.dataset.get_ann_info(idx % self._ori_len)

    def get_cat_ids(self, idx):
        return self.dataset.get_cat_ids(idx % self._ori_len)

    @property
    def test_mode(self):
        return self.dataset.test_mode


def build_dataset(cfg, default_args=None):
    """The dataset of a config's ``data.train`` (or ``val``/``test``):
    ``RepeatDataset`` wrappers, and an ``ann_file`` list built as one
    dataset per file (each prefix a matching list or a shared value) and
    concatenated."""
    _register_defaults()
    cfg = dict(cfg)
    if cfg.get("type") == "RepeatDataset":
        return RepeatDataset(build_dataset(cfg["dataset"], default_args),
                             cfg["times"])
    if cfg.get("type") in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg['type']} is not ported to bonai_tpu_torch yet (ROADMAP.md "
            f"items A7-A8)")
    ann_file = cfg.get("ann_file")
    if isinstance(ann_file, (list, tuple)):
        n = len(ann_file)
        kinds = ("img_prefix", "seg_prefix", "edge_prefix",
                 "side_face_prefix", "offset_field_prefix")
        parts = []
        for i, af in enumerate(ann_file):
            sub = dict(cfg)
            sub["ann_file"] = af
            for kind in kinds:
                val = cfg.get(kind)
                if isinstance(val, (list, tuple)):
                    assert len(val) == n, \
                        f"{kind} list must match ann_file list length"
                    sub[kind] = val[i]
            parts.append(build_from_cfg(sub, DATASETS, default_args))
        return ConcatDataset(parts) if len(parts) > 1 else parts[0]
    return build_from_cfg(cfg, DATASETS, default_args)


# ---------------------------------------------------------------------------
# packing to fixed shapes
# ---------------------------------------------------------------------------

def rasterize_instance_mask(polys, bbox, size):
    """Rasterise a multi-part polygon into a bbox-local (size, size) grid
    (``cv2.fillPoly``'s pixels, through ``utils/raster.py::fill_poly``)."""
    x1, y1, x2, y2 = bbox
    w = max(x2 - x1, 1e-3)
    h = max(y2 - y1, 1e-3)
    mask = np.zeros((size, size), np.uint8)
    pts = []
    for p in polys:
        q = np.empty_like(p)
        q[:, 0] = (p[:, 0] - x1) / w * size
        q[:, 1] = (p[:, 1] - y1) / h * size
        if q.shape[0] >= 3:
            pts.append(np.round(q).astype(np.int32))
    if pts:
        fill_poly(mask, pts, 1)
    return mask


def _pack_proposals(result):
    """A Fast R-CNN sample's proposals padded to ``_num_max_proposals``
    (2000 by default) and their validity."""
    cap = int(result.get("_num_max_proposals", 2000))
    props = np.asarray(result["proposals"], np.float32).reshape(-1, 4)
    pp = np.zeros((cap, 4), np.float32)
    pv = np.zeros((cap,), bool)
    k = min(len(props), cap)
    pp[:k] = props[:k]
    pv[:k] = True
    return {"proposals": pp, "proposals_valid": pv}


def pack_sample(result, max_gt, inst_mask_size, train=True):
    """Pipeline output -> fixed-shape numpy sample (the batch contract).
    The image stays ``uint8`` when the pipeline normalises on the card.
    Returns ``(sample, metas)``; ``metas['gt_truncated']`` counts the GTs
    past ``max_gt`` that were dropped."""
    img = result["img"]
    dt = np.uint8 if img.dtype == np.uint8 else np.float32
    img = np.ascontiguousarray(img, dt)
    h, w = result["img_shape"][:2]
    sf = result.get("scale_factor", 1.0)
    sf = float(np.asarray(sf).reshape(-1)[0])
    out = {
        "image": img,
        "img_shape": np.asarray([h, w], np.float32),
        "scale_factor": np.float32(sf),
    }
    if "proposals" in result:
        out.update(_pack_proposals(result))
    if not train:
        # proposals in test mode too: a Fast R-CNN tests on them (the JAX
        # package packs them for training only, ROADMAP.md queue C)
        return out, result.get("img_metas", {})
    boxes = result.get("gt_bboxes", np.zeros((0, 4), np.float32))
    labels = result.get("gt_labels", np.zeros((0,), np.int64))
    offsets = result.get("gt_offsets", np.zeros((len(boxes), 2), np.float32))
    polys = result.get("gt_masks", [[] for _ in range(len(boxes))])
    n = min(len(boxes), max_gt)
    n_truncated = len(boxes) - n
    gt_bboxes = np.zeros((max_gt, 4), np.float32)
    gt_labels = np.zeros((max_gt,), np.int32)
    gt_valid = np.zeros((max_gt,), bool)
    gt_offsets = np.zeros((max_gt, 2), np.float32)
    gt_masks = np.zeros((max_gt, inst_mask_size, inst_mask_size), np.uint8)
    gt_bboxes[:n] = boxes[:n]
    gt_labels[:n] = labels[:n]
    gt_valid[:n] = True
    gt_offsets[:n] = offsets[:n]
    for i in range(n):
        if polys[i]:
            gt_masks[i] = rasterize_instance_mask(
                polys[i], boxes[i], inst_mask_size)
    out.update(gt_bboxes=gt_bboxes, gt_labels=gt_labels, gt_valid=gt_valid,
               gt_offsets=gt_offsets, gt_masks=gt_masks)
    if "gt_footprint_bboxes" in result:
        fp = np.zeros((max_gt, 4), np.float32)
        fb = result["gt_footprint_bboxes"]
        k = min(len(fb), max_gt)
        fp[:k] = fb[:k]
        out["gt_footprint_bboxes"] = fp
    if "gt_only_footprint_flag" in result:
        out["gt_only_footprint_flag"] = np.float32(
            result["gt_only_footprint_flag"])
    if "gt_building_heights" in result:
        gh = np.zeros((max_gt,), np.float32)
        hv = np.asarray(result["gt_building_heights"],
                        np.float32).reshape(-1)
        gh[:min(len(hv), max_gt)] = hv[:max_gt]
        out["gt_building_heights"] = gh
    if "gt_angle" in result:
        out["gt_angle"] = np.float32(result["gt_angle"])
    metas = dict(result.get("img_metas", {}))
    if n_truncated:
        # dropped GTs become false background for the losses: never silent
        metas["gt_truncated"] = n_truncated
    return out, metas


def make_batch(dataset, idx_list, seed, max_gt, inst_mask_size, train):
    """One packed batch of the dataset indices ``idx_list``, its
    augmentation drawn from ``RandomState(seed)``; an image without GT is
    replaced by a random other one (up to 32 tries).  Returns ``(batch,
    metas)``."""
    rng = np.random.RandomState(seed)
    samples, metas = [], []
    for idx in idx_list:
        for _ in range(32):
            res = dataset.prepare(int(idx), rng)
            if res is not None:
                s, m = pack_sample(res, max_gt, inst_mask_size, train)
                break
            idx = rng.randint(len(dataset))
        else:
            raise RuntimeError("too many empty samples")
        samples.append(s)
        metas.append(m)
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}, metas


_WORKER = {}


def _worker_init(dataset, max_gt, inst_mask_size, train):
    """Worker-process state (forked: the dataset arrives copy-on-write)."""
    _WORKER.update(dataset=dataset, max_gt=max_gt,
                   inst_mask_size=inst_mask_size, train=train)


def _worker_batch(idx_list, seed):
    w = _WORKER
    return make_batch(w["dataset"], idx_list, seed, w["max_gt"],
                      w["inst_mask_size"], w["train"])


class DataLoader:
    """Prefetched fixed-shape batch iterator: ``prefetch`` batches are
    built ahead, by as many threads (``mode='thread'``) or forked worker
    processes (``mode='process'``).  Call :meth:`close` to stop the
    worker processes."""

    def __init__(self, dataset, batch_size, max_gt=256, inst_mask_size=112,
                 shuffle=True, seed=0, train=True, drop_last=None,
                 shard_id=0, num_shards=1, prefetch=2, mode="thread",
                 rank=0, world_size=1):
        if mode not in ("thread", "process"):
            raise ValueError(f"loader mode {mode!r}")
        self.mode = mode
        self._pool = None
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.inst_mask_size = inst_mask_size
        self.shuffle = shuffle
        self.seed = seed
        self.train = train
        self.drop_last = train if drop_last is None else drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.rank = rank
        self.world_size = world_size
        self.prefetch = prefetch
        self.epoch = 0
        self.truncated_instances = 0
        self.truncated_samples = 0

    def __len__(self):
        batch = self.batch_size * self.world_size      # the global batch
        if self.drop_last:
            return (len(self.dataset) // self.num_shards) // batch
        per = -(-len(self.dataset) // self.num_shards)
        return -(-per // batch)

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _epoch_indices(self):
        n = len(self.dataset)
        rng = np.random.RandomState(self.seed + self.epoch)
        idx = rng.permutation(n) if self.shuffle else np.arange(n)
        if self.num_shards == 1:
            return idx
        if self.drop_last:
            # training: contiguous equal shards, tail dropped
            per = n // self.num_shards
            return idx[self.shard_id * per:(self.shard_id + 1) * per]
        # evaluation: wrap-padded, interleaved shards
        per = -(-n // self.num_shards)
        padded = np.resize(idx, per * self.num_shards)
        return padded[self.shard_id::self.num_shards]

    def _submit(self, ex, indices, base_seed, bi):
        first = (bi * self.world_size + self.rank) * self.batch_size
        ks = [int(indices[(first + j) % max(len(indices), 1)])
              for j in range(self.batch_size)]
        seed = base_seed + bi if self.rank == 0 else (base_seed + bi,
                                                       self.rank)
        if self.mode == "process":
            return ex.submit(_worker_batch, ks, seed)
        return ex.submit(make_batch, self.dataset, ks, seed,
                         self.max_gt, self.inst_mask_size, self.train)

    def _executor(self):
        if self.mode == "thread":
            return ThreadPoolExecutor(max_workers=self.prefetch)
        if self._pool is None:
            self._pool = ProcessPoolExecutor(
                max_workers=self.prefetch,
                mp_context=multiprocessing.get_context("fork"),
                initializer=_worker_init,
                initargs=(self.dataset, self.max_gt, self.inst_mask_size,
                          self.train))
        return self._pool

    def __iter__(self):
        indices = self._epoch_indices()
        nb = len(self)
        base_seed = (self.seed + self.epoch) * 9973 + self.shard_id
        ex = self._executor()
        try:
            pending = collections.deque(
                self._submit(ex, indices, base_seed, bi)
                for bi in range(min(self.prefetch, nb)))
            for bi in range(nb):
                batch, metas = pending.popleft().result()
                if bi + len(pending) + 1 < nb:
                    pending.append(self._submit(ex, indices, base_seed,
                                                bi + len(pending) + 1))
                for m in metas:
                    if m.get("gt_truncated"):
                        self.truncated_instances += m["gt_truncated"]
                        self.truncated_samples += 1
                yield batch, metas
        finally:
            if self.mode == "thread":
                ex.shutdown(wait=True, cancel_futures=True)

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None


def build_dataloader(dataset, samples_per_gpu, workers_per_gpu=2,
                     num_devices=1, shuffle=True, seed=0, max_gt=256,
                     inst_mask_size=112, train=True, shard_id=0,
                     num_shards=1, loader_mode="thread", rank=0,
                     world_size=1, **kwargs):
    """The loader of a config's ``data``: a global batch of
    ``samples_per_gpu * num_devices``, ``max(2, workers_per_gpu)`` batches
    built ahead, ``loader_mode`` 'thread' or 'process'.  With
    ``world_size > 1`` it is the loader of data-parallel rank ``rank``:
    its ``samples_per_gpu`` rows of a global batch of ``samples_per_gpu *
    world_size``."""
    return DataLoader(dataset, batch_size=samples_per_gpu * num_devices,
                      max_gt=max_gt, inst_mask_size=inst_mask_size,
                      shuffle=shuffle, seed=seed, train=train,
                      shard_id=shard_id, num_shards=num_shards,
                      prefetch=max(2, workers_per_gpu), mode=loader_mode,
                      rank=rank, world_size=world_size)
