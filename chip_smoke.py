#!/usr/bin/env python3
"""Drives the bonai_tpu_torch serving, training (one card and
data-parallel) and test-and-score paths on the NVIDIA GPUs of one machine
(one is enough) and checks them.

Run from the repository root, on a machine with a CUDA device and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which must pass:

1. build: every CUDA kernel of the paths, from ``bonai_tpu_torch/csrc``,
   one ``nvcc`` per source, started together.
2. kernels: each kernel's wrapper at the shapes the paths give it, against
   its plain PyTorch version, in float32 and bfloat16, with pushed, border
   and invalid RoIs: max abs error, the wrapper's time (CUDA events over
   20 warm calls), the kernel's own device time over 20 such calls (CUDA
   events around each bare C launch), plain time and the least time the card could
   take (the bound).  Serving shapes: bbox R=6000 at 7x7, mask R=4000 at
   14x14, offset R=4000 at 7x7; training shapes: bbox R=2048 at 7x7, mask
   R=512 at 14x14, offset R=512 at 7x7; C=256.  Each forward and its
   backward run on the same RoIs.  And B1 and B2 at the C4 layout's shape
   (the coco_rcnn phase's C4 Mask R-CNN): one stride-16 level of
   (2, 64, 64, 1024), 14x14 bins, every RoI on that level; serving bbox
   R=2000 (1000 an image) and mask R=200, training bbox R=1024 (512 an
   image) and the mask branch's positives R=256.
   - B1, the RoIAlign forward kernel, under the block rule and under the
     strip rule (B3's function, ``roi_align_impl='pallas'``), at the
     serving and training shapes; the levels the kernel computes must
     equal the torch rule's on every RoI, and on RoIs at the rules' edges;
   - B2, the backward kernel, under both rules (B4's function under the
     strip rule) at the training shapes, against autograd through the
     plain versions; it must allocate nothing but the level gradients, in
     the output gradient's dtype;
   - B5, the forward-only window-64 strip RoIAlign: B1's kernel in its
     window-64 mode (the gather rule, the window cut and the y rule), at
     the training shapes; its levels must equal ``map_roi_levels``' on
     every RoI and on the gather rule's edges.
3. serve: ``init_detector`` on ``configs/loft_foa/loft_foa_r50_fpn_2x_bonai.py``
   at full width with seeded random weights in bfloat16, once with its
   ``roi_align_impl='block'`` and once with ``'pallas'``; two batched
   ``simple_test`` calls at 1024^2 with B=2 and one ``inference_detector``
   call on a random BGR image each.  Outputs must be finite and of the
   right shapes, and a small float32 input must agree with the same model
   run through the kernels' plain versions.
4. train: ``train_detector`` on the same config at full width, seeded
   random float32 weights, bfloat16 autocast, the config's train settings
   and optimizer, on a synthetic padded batch (B=2, 1024^2, 100 GTs, 112^2
   masks, offsets within +-30 px): 1 warm-up and 5 timed steps with
   ``'block'``, 1 and 3 with ``'pallas'``.  Every loss and gradient norm
   must be finite and the trainable weights must move.  On a small float32
   input, the FPN-level gradients of the RoI branches' losses through the
   kernels must agree with the plain path.
5. data: training from files.  The port's generator writes 8 train tiles
   of 1024^2 (seed 0: the first 8 of the acceptance set) into
   ``build/chip_smoke_data``; the loader of
   ``configs/loft_foa/loft_foa_r50_fpn_2x_synth_bonai.py`` (data paths
   pointed there) reads them once cold (PNG decode) and once warm (the
   decoded-image cache) in its thread mode, then twice in its process
   mode (the first pass starts the workers);
   ``train_detector(cfg, None, ...)`` then trains that config (its
   ``frozen_stages=-1``, bfloat16 autocast) 6 steps from the files.  Every
   loss must be finite, every trainable tensor (the stem and ``layer1``
   included) must move and no BatchNorm statistic may.  Its final
   checkpoint goes on to the eval phase.
6. eval: test and score that checkpoint.  The generator writes the first
   val scene of the acceptance set (seed 77, 2048^2) and its four 1024^2
   crops; the test CLI (``bonai_tpu_torch.tools.bonai_test``, ``--city
   config``, on the card) runs the config on the first crop to a pkl
   (``--max-images 1``: the 6-step weights leave about 1750 detections a
   crop to trace and overlay), and the evaluation CLI scores it per crop
   and ``--merge``d into the scene (the best ``EVAL_TOP`` detections:
   each scored record costs 0.1-0.3 s of host time); ``run_inference``
   is timed warm over
   the four crops.  The
   results must be well formed, P/R/F1 finite within [0, 1] and aEPE
   finite (the weights have had 6 steps); the inference ms per tile and
   the seconds of pkl -> records and of F1 are printed.  The planted
   check: the crop json's own roofs as results (full-size masks, score 1,
   the GT offsets) must score ``PLANTED``.
7. resume: chunked training through the host-RSS watchdog (phases 7, 8,
   24 and 25 run in a child process of their own beside phases 9 to 23:
   processes of their own or host-bound work, their times not a lone
   run's).  On the data
   phase's 8 tiles (4 steps an epoch) in process loader mode, ``python -m
   bonai_tpu_torch.tools.train_chunked`` with ``BONAI_MAX_RSS_GB`` below
   any process's RSS trains the 2x synthetic recipe 6 steps: the train CLI
   checkpoints and exits 75 at step 4 (its first log row, the first
   epoch's end), the wrapper resumes it once, and it ends at step 6.  An
   unbroken run of the same 6 steps, at the same time on the same card,
   logs every step; both run under ``--deterministic``, and the chunked
   run's logged losses and final weights must equal the unbroken run's to
   the bit.  ``host_rss_gb`` is
   printed at the start and the end.
8. ddp: data parallelism, every run started through
   ``bonai_tpu_torch.parallel.launch``.  (a) The rehearsal: two gloo
   ranks on one card (NCCL refuses two ranks on one device), each one
   step of the train phase's config on its image of the synthetic batch,
   float32, no autocast, deterministic, at a constant LR; the updated
   weights of both ranks must equal a one-process step (a process of its
   own) whose gradient is the mean of the two half-batch gradients, with
   the same draws, within 1e-4 of each tensor's largest update.  Both
   ranks share the card, so its step time is not a scaling figure.  (b)
   The CLI: ``bonai_tpu_torch.tools.train.main`` with ``--n-devices
   device_count()`` as every rank of a process group of that many ranks
   (NCCL, one rank per card, under DDP even for one card) trains 4 steps
   of the 2x synthetic recipe from the data phase's tiles, while (a)
   runs; its step ms are printed against the data phase's (one process,
   no DDP); then ``run_inference`` of the eval phase's four crops is sharded
   over as many ranks and merged in dataset order.
9. loft: LOFT with the plain ``OffsetHead``
   (``configs/loft/loft_r50_fpn_2x_bonai.py``) at full width, seeded
   random weights, ``'block'`` route: one serve batch (B=2, 1024^2, bf16)
   and one ``inference_detector`` call, a small float32 input held to the
   plain route, and 3 steps on the repeated synthetic batch (finite
   losses, every trainable weight moves, the RoI branches' gradients
   held to the plain route).
10. rcnn: the R-CNN baselines on BONAI, each at full width with seeded
   random weights and ``roi_align_impl='block'`` (the config's key):
   ``configs/mask_rcnn/mask_rcnn_r50_fpn_2x_bonai.py``,
   ``configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_bonai.py`` and
   ``configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_bonai.py``, as the loft
   phase runs its config: one serve batch and one ``inference_detector``
   call (the results carry the model's heads: boxes and masks, or boxes
   alone), the small float32 input held to the plain route, and training
   on the repeated synthetic batch (6 steps of Mask R-CNN, 3 of the
   others).  The Mask R-CNN's 6-step checkpoint goes through the test CLI
   on the card (one of the eval phase's val crops; a pkl of ``(bbox,
   segm)`` 2-tuples) and the evaluation CLI on its best ``EVAL_TOP``
   detections, which prints roof and footprint F1.  COCO-style scoring: the Mask R-CNN's and the Dynamic
   R-CNN's checkpoints through the generic test CLI
   (``bonai_tpu_torch.tools.test``, ``--eval bbox segm`` and ``--eval
   bbox``) on that crop, with the AP keys and the seconds taken; the
   planted check: the four crops' own GTs as results (score 1, full-size
   RLE masks) must score ``bbox_mAP == segm_mAP == 1.0`` and VOC ``mAP ==
   1.0`` through ``CocoDataset.evaluate``.
11. hrnet: LOFT-FOA on HRNet-W32 + HRFPN
   (``configs/hrnet/loft_foa_hrnetv2p_w32_2x_bonai.py``) at full width,
   seeded random weights whose backbone BatchNorm statistics are those of
   a random batch (identity statistics let the fuse sums grow to head
   outputs of about 5e8), ``'block'``, as the loft phase runs its config:
   one serve batch and one ``inference_detector`` call, the small float32
   input held to the plain route, 3 steps on the repeated synthetic batch
   at the config's base LR, without its warmup (exactly ``conv2``/``bn2``,
   behind the gradient stop after ``layer1``, get no gradient, in this
   phase alone; they move by weight decay alone, which the warmup's LRs
   would leave under a float32 ulp, and bn2's zero bias stays 0), the RoI
   branches' gradients held to the plain route; then the backbone + neck
   time of a serve batch beside R50 + FPN's.
12. rcnn2: the rest of the R-CNN family on BONAI, as the rcnn phase runs
   its configs (3 steps each; Libra's at the base LR, without the
   warmup, so that its non-local block's ``theta``/``phi``/``g``, whose
   first gradient comes in step 2 behind the zero ``conv_out``, move):
   ``configs/libra_rcnn/libra_faster_rcnn_r50_fpn_1x_bonai.py``,
   ``configs/double_heads/dh_faster_rcnn_r50_fpn_1x_bonai.py`` (with the
   count of its 1.3x-scaled reg RoIs past the tile and their widest level
   footprint against the JAX block kernel's 40-cell window),
   ``configs/ms_rcnn/ms_rcnn_r50_fpn_1x_bonai.py`` (``mask_scores`` in
   the outputs, the pair in the results; its checkpoint through the test
   CLI with ``--eval bbox segm``), ``configs/rpn/rpn_r50_fpn_1x_bonai.py``
   (no kernel may launch) and ``configs/fast_rcnn/
   fast_rcnn_r50_fpn_1x_bonai.py`` (serve and train batches with 2000
   proposals an image around the synthetic GTs).  Then the file chain:
   the RPN's checkpoint through the test CLI on the data phase's 8 tiles
   and the eval phase's 4 crops, ``AR@100/300/1000`` of the first crop,
   both pkls made proposal files, the Fast R-CNN trained 3 steps from
   them by ``train_detector`` and scored by the test CLI with ``--eval
   bbox`` on the first crop from its file.
13. rcnn3: Grid R-CNN (``configs/grid_rcnn/
   grid_rcnn_r50_fpn_gn-head_2x_bonai.py``: a box head without ``fc_reg``,
   the grid head at 14^2 on the detections and on the jittered positives)
   and PointRend (``configs/point_rend/point_rend_r50_fpn_2x_bonai.py``:
   the coarse head behind the single-level ``GenericRoIExtractor``, the
   point head, 224^2 masks after five subdivision steps), as the rcnn
   phase runs its configs, 3 steps each; each checkpoint through the test
   CLI, ``--eval bbox`` and ``--eval bbox segm``.
14. trunks: the R-CNN trunk variants (``TRUNK_CONFIGS``): the DCNv2
   (c3-c5), GCNet (context blocks after conv3 of c3-c5), Res2Net-50 and
   RegNetX-3.2GF Mask R-CNNs and the generalized-attention (after conv2
   of c4-c5) and PAFPN Faster R-CNNs, each at full width with seeded
   random weights under ``'block'`` (the attention and PAFPN configs
   default to the plain gather route; Res2Net's and PAFPN's backbone
   BatchNorm statistics calibrated as the hrnet phase's), as the rcnn
   phase runs its configs: one serve batch and one ``inference_detector``
   call; the FPN
   levels of a small float32 input on the card against a float64 run on
   the CPU (the deformable sampling and attention blocks inside), within
   1e-4 of each level's largest value, or twice the CPU's own float32
   rounding where that is larger, with TF32 off, and its RoI branches
   held to the plain route; 3 steps on the repeated synthetic batch (at
   the base LR but PAFPN's, so that the zero-initialised plugin convs'
   inputs and Res2Net's stem visibly move; the stem, behind the gradient
   stop after the max-pool, gets no gradient and moves by weight decay
   alone, its zero BN biases not at all); each checkpoint through the
   test CLI with ``--eval bbox`` (and ``segm`` for the Mask R-CNNs).
15. coco_trunks: the COCO recipes' trunk, neck and R-CNN head options
   (``COCO_TRUNK_CONFIGS``): the ResNeXt-101 32x4d Mask R-CNN (grouped
   3x3 convs), the R50 caffe-style Faster R-CNN (stride on the 1x1 conv,
   BN affine behind a gradient stop) and the GN+WS R50 Mask R-CNN
   (GroupNorm and weight-standardised convs in the trunk, the FPN, the
   4-conv box head and the mask head), each at full width with seeded
   random weights under ``'block'`` (the two BN trunks' statistics
   calibrated) and the test scale at 1024^2, as the trunks phase runs
   its configs: one serve batch and one ``inference_detector`` call; the
   FPN levels of a small float32 input held to float64 on the CPU and
   its RoI branches to the plain route; 3 steps at the base LR, clipped
   at 35 as the BONAI recipes are, on the repeated synthetic batch (the
   caffe trunk's BN affines get no
   gradient and move by weight decay alone, their zero biases not at
   all); each checkpoint through the test CLI.
16. coco_rcnn: item 6's A7 part (``COCO_RCNN_CONFIGS``): the C4 Mask
   R-CNN (a three-stage caffe trunk, no neck, the shared res5 head on
   14x14 RoIs of the one stride-16 map, whose mask branch reads the box
   branch's RoIAlign: B1 twice a batch and a step), GRoIE's Mask R-CNN
   and the modulated deformable RoI pooling Faster R-CNN (plain PyTorch
   RoI extraction: no launch), and, trained, OHEM's Faster R-CNN (a
   ranking pass of the box head without gradient: B1 twice a step, B2
   once), PISA's Mask R-CNN (ISR-P, CARL), Libra's COCO Faster R-CNN (the
   combined instance- and IoU-balanced sampler) and the GIoU Faster
   R-CNN (decoded boxes); each at full width with seeded random weights,
   its BN statistics calibrated, under ``'block'``, the test scale at
   1024^2 and ``score_thr`` 0 (random 81-way heads stay under the
   configs' 0.05), as the coco_trunks phase runs its configs: the first
   three served (one batch and one ``inference_detector`` call, the
   trunk's levels of a small float32 input held to float64 on the CPU
   and the RoI branches to the plain route), every one trained 3 steps
   at the base LR (every trainable tensor moves, the caffe affines by
   weight decay alone) with the small-input gradient check; the C4
   checkpoint through the test CLI.
17. coco_dense: item 6's A6 dense-head and anchor half
   (``COCO_DENSE_CONFIGS``): Guided Anchoring's RetinaNet (the retina
   towers, the location and shape branches, two deformable feature
   adaptions a level) and RPN-only detector, the legacy v1.x Mask R-CNN
   (``LegacyAnchorGenerator`` and the v1.x coder in the RPN and the box
   head: B1 twice a batch and a step) and Cascade Mask R-CNN (B1 and B2 4
   times a step), the legacy RetinaNet, the SepBN RetinaNet on the
   crop640 NAS-FPN (per-level norms, calibrated too; its test side 640^2),
   Libra's balanced-L1 and PISA's RetinaNets; each at full width with
   seeded random weights, its BN statistics calibrated, ``score_thr`` 0:
   GA RetinaNet, the GA RPN, the legacy Mask R-CNN and the SepBN RetinaNet
   served (the RetinaNets as the dense phase serves, their head outputs,
   GA's deformable adaptions among them, held to the CPU; the R-CNN and
   the RPN as the trunks phase serves), every one trained 3 steps at the
   base LR clipped at 35 (every trainable tensor moves).
18. cascades: the last two mask-producing cascades (``CASCADE_CONFIGS``):
   HTC (``configs/htc/htc_r50_fpn_1x_bonai.py``: a mask head at every
   stage with the info-flow chain, interleaved mask sampling, the semantic
   head fused into every RoI feature) and DetectoRS
   (``configs/detectors/detectors_cascade_rcnn_r50_1x_bonai.py``: SAC in
   c3-c5, the RFP's second step through a backbone copy), each at full
   width with seeded random weights whose BatchNorm statistics are
   calibrated (DetectoRS's copy's too) under ``'block'``, as the trunks
   phase runs its configs: one serve batch and one ``inference_detector``
   call; the FPN levels (after the RFP step) and HTC's semantic embedding
   of a small float32 input on the card against float64 on the CPU, and
   the RoI branches against the plain route; 3 steps on the repeated
   synthetic batch (HTC's with a ``gt_semantic_seg`` planted from the GT
   masks; DetectoRS at the base LR, so that the RFP copy's stem and
   ``layer1``, behind its gradient stops, visibly move by weight decay
   alone); each checkpoint through the test CLI with ``--eval bbox
   segm``.
19. dense: the dense single-stage detectors (``DENSE_CONFIGS``: RetinaNet
   R50-FPN on its COCO config and on the GHM and PISA configs, which keep
   COCO's 80 classes, and FreeAnchor, ATSS, GFL and FCOS on BONAI), each
   at full width with seeded random weights: one serve batch (B=2,
   1024^2, bf16; the COCO configs' test scale set to 1024^2) timed twice
   and one ``inference_detector`` call; the batch once more with
   ``score_thr=0``, which must fill every image's ``max_per_img``
   detections (the focal-loss prior, 0.01, keeps random weights under
   the configs' 0.05); the head outputs of a small float32 input on the
   card and on the CPU, which must agree within 1e-4 of each output's
   largest value with TF32 off; 3 training steps at the base LR on the
   repeated synthetic batch, its first 8 GTs an image widened to reach
   every pyramid level (finite losses, every trainable tensor moves; the
   COCO configs, whose schedule has no gradient clip, with their
   warmup);
   the BONAI configs' checkpoints through the test CLI with ``--eval
   bbox`` on the first val crop (``score_thr=0``).  No kernel may launch.
20. dense2: RepPoints, FSAF and FoveaBox on BONAI as the dense phase runs
   its configs (one timed serve batch; RepPoints' small-input check runs
   through its deformable convs, both point sets and ``moment_transfer``),
   no kernel launch; Guided-Anchoring Faster R-CNN as the trunks phase
   runs PAFPN (calibrated BatchNorm statistics, ``'block'``, its COCO
   schedule's warmup; the small input's FPN levels and GA-RPN outputs
   held to the CPU); each checkpoint through the test CLI with ``--eval
   bbox``.  Each config's line carries the card's name and power limit.
21. dense3: NAS-FPN RetinaNet (``configs/nas_fpn/
   retinanet_r50_nasfpn_bonai.py``, COCO's 80 classes), NAS-FCOS, SSD300
   and CornerNet (Hourglass-104) on BONAI as the dense2 phase runs its
   dense detectors, from weights whose R50 and hourglass BatchNorm
   statistics are calibrated: one timed serve batch; the small input
   (SSD's 320x320, CornerNet's 128x256) on the card against the CPU, both
   in float64 (float32 rounding through NAS-FCOS's per-channel GroupNorms
   and Hourglass-104 reaches 1e-4 of an output's largest value), within
   1e-4 of each output's largest value, through NAS-FCOS's deformable
   towers and CornerNet's corner pools; 3
   steps on the widened synthetic batch at the config's training side
   (1024^2; SSD's 300^2, CornerNet's 511^2) at the base LR (NAS-FPN's
   unclipped COCO schedule with its warmup; CornerNet's Adam); each
   checkpoint through the test CLI with ``--eval bbox``.  No kernel
   launch.  Each config's line carries the card's name and power limit.
22. attr: LOFT-FOA with every attribute head (height, joint
   offset-height, angle, side-face, offset-field, offset reweighting) and
   ``SemiRPNHead`` (``attr``), and LOFT with polar offsets (``polar``),
   both derived at full width from the LOFT configs (``_attr_config``,
   ``_polar_config``), from weights whose R50 BatchNorm statistics are
   calibrated: one serve batch and one ``inference_detector`` call; the
   small float32 input's every RoI branch (the attribute heads' outputs
   too) against the plain route; 3 steps on the synthetic batch (``attr``:
   with 1024^2 side-face maps and offset fields, heights, angles,
   footprint boxes, one footprint-only image; ``polar``: polar offsets),
   every trainable tensor moving; then the train CLI 2 steps on the data
   phase's 8 tiles with their side-face PNGs and offset-field ``.npy``
   files (written by the port's generator) and the BONAI test CLI on its
   checkpoint.  Each config's line carries the card's name and power
   limit.
23. tta: test-time augmentation of LOFT-FOA R50-FPN at full width
   (``'block'``, bf16, 1024^2, B=2, seeded random weights with
   calibrated R50 BatchNorm statistics): one warm and one timed batch of
   the detection level at the default views (none, horizontal,
   vertical), of the proposal level (``aug_test``) at the same views, and
   of the detection level at scales (1.0, 0.5) with the horizontal flip,
   each against a timed plain ``simple_test``, with its soft-NMS and
   merges timed inside; a small float32 input through both levels, the
   kernel against its plain version, matched detection by detection
   within 1e-4 of each output's largest value (TF32 off).  Then from
   files: the BONAI test CLI with ``--aug-test`` on the data phase's
   checkpoint over two of the eval phase's val crops and the evaluation
   CLI on its pkl's best ``EVAL_TOP`` detections; the train CLI 2 steps of the ``attr`` configuration
   with ``RandomRotate(rotate_ratio=1.0, angles='any')`` after
   ``RandomFlip`` (the numpy warps), every loss finite, the loader's
   angles printed, at least one off the multiples of 90.
24. datasets: the non-BONAI datasets and the robustness benchmark at full
   width (``datasets_phase``).  Robustness: ``tools/test_robustness.py``
   on LOFT-FOA R50-FPN (the 2x synthetic recipe, the flagship's model)
   with the data phase's checkpoint over two of the eval phase's 1024^2
   val crops, the clean run and the 15 benchmark corruptions at severity
   3 (``Corrupt`` on the host, before the test pipeline's resize): every
   corruption in the pkl with the JAX layout, the P, mPC and rPC tables
   printed, B1 3 times a batch (96 in the 32 batches), and each
   corruption's served detections different from the clean run's (a
   corruption that never reached the served images would repeat them);
   each corruption's host ms on a 1024^2 tile.  Pascal VOC: 4 VOC2007-layout 500x375 images
   written as JPEGs by ``encode_jpeg``, with XML boxes, converted by the
   port's converter (its boxes equal to ``VOCDataset``'s); JPEG decoding
   timed at 500x375 and 1024^2, and ``read_jpeg(encode_jpeg(x, q))`` equal
   to ``jpeg_round_trip(x, q)``; ``configs/pascal_voc/
   faster_rcnn_r50_fpn_1x_voc0712.py`` trained 2 steps from the files at
   1000x600 (its two-year list pointed at the one tree), one test batch
   scored by ``VOCDataset.evaluate`` (``mAP``), and the VOC branch of
   ``test_robustness`` on ``jpeg_compression`` at severity 5, its
   detections different from the clean run's.
   Cityscapes: a 2048x1024 ``leftImg8bit``/``gtFine`` tree with 16-bit
   ``instanceIds`` (``write_png``) converted by the port's converter;
   ``configs/cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py`` trained 2
   steps and one test batch served.  LVIS: an LVIS-v1-style json
   (``coco_url`` only, 2000 image entries over 4 JPEGs, a long tail of 6
   categories in one image each) under ``ClassBalancedDataset(
   oversample_thr=1e-3)``, whose length must equal the closed form of its
   repeat factors; ``configs/lvis/
   mask_rcnn_r50_fpn_sample1e-3_mstrain_1x_lvis_v1.py`` trained 2 steps and
   its 1203-class serve of one image timed.  The three configs run
   with their own ``'gather'`` route (no kernel: their launch counts must
   be 0) from calibrated random weights (``_calibrated_weights``); every
   loss finite.
25. tools: the host tools on LOFT-FOA R50-FPN at full width (``'block'``,
   1024^2) and the data phase's checkpoint: ``fuse_conv_bn`` and
   ``publish_model`` on it, the checkpoint and each tool's file served
   through ``inference_detector`` (B=2, bf16, two of the eval phase's val
   crops); the fold held to the unfused model on a small float32 input
   (TF32 off), on the checkpoint and on calibrated random weights, matched
   detection by detection within 1e-4 of each output's largest value;
   ``export_model``'s ``export_detector`` at B=1, the ``.pt2`` loaded by
   ``load_exported`` in a fresh process, whose call must hold the
   RoIAlign op, launch B1 3 times and give eager ``simple_test``'s outputs
   within 1e-4 of each output's largest value (both calls timed);
   ``get_flops`` at 1024^2; the mask library against its numpy versions
   on the eval phase's masks (decode, encode, ``mask_iou``: equal, both
   timed); ``show_result`` and ``browse_dataset`` on a crop and a train
   tile, PNGs written; ``profile_time`` and ``device_trace`` around a
   serve call, whose trace must hold B1's 3 kernels; ``collect_env``.
26. bench: ``bonai_tpu_torch.tools.bench_roi_align.main(["--iters", "3"])``,
   the entry point of B5.

Every launch count is zeroed just before each serve, train, data, eval and
bench run and read just after: the route's forward kernel must launch 3
times per batch or step, its backward kernel 3 times per training step, no
other kernel at all; the bench must launch B5.  The resume phase's runs are
processes of their own, which start from zero and log their counts; their
sum must be 3 launches of each kernel a step.  The ddp phase reads every
rank's counts: each rank launches B1 and B2 3 times a step, B1 3 times a
test batch.  The loft, hrnet and rcnn phases' counts are zeroed and read
like the serve and train phases', at one launch of each kernel per RoI
call a batch or step makes: 3 for LOFT (on either backbone), 2 for Mask
R-CNN (box and mask), 4 for Cascade Mask R-CNN (three box stages and the
mask), 1 for Dynamic R-CNN, 1 for Libra R-CNN, 2 for Double-Head (the
cls RoIs and the scaled reg RoIs), 2 for Mask Scoring R-CNN (box and
mask; the IoU head reuses the mask features), 1 for Fast R-CNN, 0 for the
RPN, 2 for Grid R-CNN (box and grid), 1 for PointRend (box; its mask
extractor is the plain RoIAlign), 2 for the trunk variants' Mask R-CNNs
and 1 for their Faster R-CNNs, 6 for HTC (three box and three mask
stages; its semantic fusion's RoIAlign is the plain one), 2 for the
COCO trunks' Mask R-CNNs and 1 for their Faster R-CNN, 2 for the
legacy v1.x Mask R-CNN and 4 for its Cascade Mask R-CNN, and 4 for
DetectoRS (three box stages and the mask); the file chain's RPN test runs
launch nothing, its Fast R-CNN launches B1 and B2 once a training step and
B1 once a test batch; the dense phase's runs launch nothing, nor do the
dense2 phase's RepPoints, FSAF and FoveaBox; its GA Faster R-CNN launches
B1 once a serve batch, B1 and B2 once a step, B1 once a test batch; the
dense3 phase's four detectors launch nothing, nor do the coco_dense
phase's GA RPN and RetinaNets; the attr phase's ``attr``
model launches B1 8 times a serve or test batch (box, mask, offset, the
reweighting's mask and side-face calls, the side-face head, the
offset-field head and its aggregation's mask call) and B1 and B2 7 times
a step (the offset field's aggregation runs at test only), its ``polar``
model 3 times each; the tta phase's LOFT-FOA launches B1 3 times a view
(box, mask, offset): 9 a batch at the default views at either level, 12
at the four scaled views, 9 in the BONAI test CLI's batch with
``--aug-test``, and its rotated ``attr`` training B1 and B2 7 times a
step; the datasets phase's robustness runs B1 3 times a batch, its VOC,
Cityscapes and LVIS runs no kernel; the tools phase's serve batches (the
checkpoint, fused, published, traced), its eager call and its reloaded
exported program (counted in its own process) B1 3 times each.

Prints the card's name and power limit, the kernels' JSON line, and as its
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without a CUDA device or outside the repository.
"""

import contextlib
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs/loft_foa/loft_foa_r50_fpn_2x_bonai.py")
SYNTH_CONFIG = os.path.join(
    REPO, "configs/loft_foa/loft_foa_r50_fpn_2x_synth_bonai.py")
LOFT_CONFIG = os.path.join(REPO, "configs/loft/loft_r50_fpn_2x_bonai.py")
HRNET_CONFIG = os.path.join(REPO,
                            "configs/hrnet/loft_foa_hrnetv2p_w32_2x_bonai.py")
# the R-CNN baselines on BONAI (the rcnn phase): label, config, train steps
RCNN_CONFIGS = (
    ("mask_rcnn", "configs/mask_rcnn/mask_rcnn_r50_fpn_2x_bonai.py", 6),
    ("cascade", "configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_bonai.py",
     3),
    ("dynamic", "configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_bonai.py", 3))
# the dense single-stage detectors (the dense phase): label, config, and
# whether its checkpoint is scored on the eval phase's val crop (the BONAI
# configs; the GHM and PISA configs keep their COCO base's 80 classes)
DENSE_CONFIGS = (
    ("retinanet", "configs/retinanet/retinanet_r50_fpn_1x_coco.py", False),
    ("ghm", "configs/ghm/retinanet_ghm_r50_fpn_1x_bonai.py", False),
    ("pisa", "configs/pisa/pisa_retinanet_r50_fpn_1x_bonai.py", False),
    ("free_anchor",
     "configs/free_anchor/retinanet_free_anchor_r50_fpn_1x_bonai.py", True),
    ("atss", "configs/atss/atss_r50_fpn_1x_bonai.py", True),
    ("gfl", "configs/gfl/gfl_r50_fpn_1x_bonai.py", True),
    ("fcos", "configs/fcos/fcos_r50_fpn_1x_bonai.py", True))
DENSE_STEPS = 3
# the R-CNN trunk variants (the trunks phase): label, config, the RoIAlign
# kernel calls of a batch or step, whether it trains with its warmup (the
# BONAI schedules train at the base LR, clip 35: at the warmup's first
# LRs the zero-initialised plugin convs and their inputs, and Res2Net's
# decay-only stem, move by less than a float32 ulp in 3 steps; PAFPN's
# COCO schedule, unclipped, keeps its warmup), and whether its weights
# get calibrated BatchNorm statistics (``_calibrated_weights``: with
# identity statistics Res2Net's c5 reaches 3e3 on a 256^2 input, against
# R50's 231, and its boxes leave no detection; PAFPN's 80-class head
# saturates, and its RoI losses' stride-16 gradients of the small input
# fall to 1e-27, into float32's subnormal range, where the gradient
# check's relative bound cannot hold)
TRUNK_CONFIGS = (
    ("dcn", "configs/dcn/mask_rcnn_r50_fpn_dconv_c3-c5_1x_bonai.py", 2,
     False, False),
    ("gcnet", "configs/gcnet/mask_rcnn_r50_fpn_r4_gcb_c3-c5_1x_bonai.py", 2,
     False, False),
    ("attention", "configs/empirical_attention/"
     "faster_rcnn_r50_fpn_attention_1111_1x_bonai.py", 1, False, False),
    ("res2net", "configs/res2net/mask_rcnn_r2_50_fpn_2x_bonai.py", 2, False,
     True),
    ("regnet", "configs/regnet/mask_rcnn_regnetx-3.2GF_fpn_1x_bonai.py", 2,
     False, False),
    ("pafpn", "configs/pafpn/faster_rcnn_r50_pafpn_1x_bonai.py", 1, True,
     True))
TRUNK_STEPS = 3
# the COCO recipes' trunk, neck and head options (the coco_trunks phase):
# label, config, the RoIAlign kernel calls of a batch or step, whether its
# BatchNorm statistics are calibrated (the two BN trunks; GN has no
# statistics), and its test ``score_thr`` (the GN+WS head's random 81-way
# softmax stays near 1/81 everywhere, below the config's 0.05, so it
# serves at 0 and fills its 100 detections an image).  Each trains at its
# base LR, clipped as the BONAI recipes are (max_norm 35): at the warmup's
# first LRs weight decay moves the caffe trunk's BN affines, behind their
# gradient stop, by less than a float32 ulp in 3 steps, and unclipped, as
# the COCO schedules are, random weights diverge (X101: grad norm 277,
# then 8.8e6, then NaN)
COCO_TRUNK_CONFIGS = (
    ("x101", "configs/mask_rcnn/mask_rcnn_x101_32x4d_fpn_1x_coco.py", 2,
     True, 0.05),
    ("r50_caffe", "configs/faster_rcnn/faster_rcnn_r50_caffe_fpn_1x_coco.py",
     1, True, 0.05),
    ("gn_ws", "configs/gn+ws/mask_rcnn_r50_fpn_gn_ws-all_2x_coco.py", 2,
     False, 0.0))
COCO_TRUNK_DIR = os.path.join(REPO, "build", "chip_smoke_coco_trunks")
# item 6's A7 part (the coco_rcnn phase): label, config, the RoIAlign
# kernel calls of a serve batch (None: trained only; its serve path is
# the plain Faster or Mask R-CNN's, or Libra's BFP, which the rcnn, rcnn2
# and coco_trunks phases serve), and the forward and backward calls of a
# step (OHEM's ranking pass runs the box branch once more, without
# gradient; GRoIE's and the deformable pooling's RoI extraction is plain
# PyTorch, as it is plain XLA in the JAX package)
COCO_RCNN_CONFIGS = (
    ("c4", "configs/mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py", 2, (2, 2)),
    ("groie", "configs/groie/mask_rcnn_r50_fpn_groie_1x_coco.py", 0, (0, 0)),
    ("mdpool", "configs/dcn/faster_rcnn_r50_fpn_mdpool_1x_coco.py", 0,
     (0, 0)),
    ("ohem", "configs/faster_rcnn/faster_rcnn_r50_fpn_ohem_1x_coco.py", None,
     (2, 1)),
    ("pisa", "configs/pisa/pisa_mask_rcnn_r50_fpn_1x_coco.py", None,
     (2, 2)),
    ("libra", "configs/libra_rcnn/libra_faster_rcnn_r50_fpn_1x_coco.py",
     None, (1, 1)),
    ("giou", "configs/faster_rcnn/faster_rcnn_r50_fpn_giou_1x_coco.py", None,
     (1, 1)))
COCO_RCNN_DIR = os.path.join(REPO, "build", "chip_smoke_coco_rcnn")
COCO_RCNN_STEPS = 3
# item 6's A6 dense-head and anchor half (the coco_dense phase): label,
# config, the RoIAlign kernel calls of a serve batch (None: trained only;
# the legacy Cascade's serve path is the Cascade Mask R-CNN's of the rcnn
# phase, the trained-only RetinaNets' the dense phase's RetinaNet's), the
# forward and backward calls of a step (the legacy Cascade's three box
# stages and its mask branch, as the cascades phase counts DetectoRS's),
# and the test side (None: SIZE; the crop640 config's 640)
COCO_DENSE_CONFIGS = (
    ("ga_retina", "configs/guided_anchoring/ga_retinanet_r50_fpn_1x_coco.py",
     0, (0, 0), None),
    ("ga_rpn", "configs/guided_anchoring/ga_rpn_r50_fpn_1x_coco.py", 0,
     (0, 0), None),
    ("legacy_mask", "configs/legacy_1.x/mask_rcnn_r50_fpn_1x_coco_v1.py", 2,
     (2, 2), None),
    ("legacy_cascade",
     "configs/legacy_1.x/cascade_mask_rcnn_r50_fpn_1x_coco_v1.py", None,
     (4, 4), None),
    ("legacy_retina", "configs/legacy_1.x/retinanet_r50_fpn_1x_coco_v1.py",
     None, (0, 0), None),
    ("sepbn_nasfpn",
     "configs/nas_fpn/retinanet_r50_nasfpn_crop640_50e_coco.py", 0, (0, 0),
     640),
    ("libra_retina", "configs/libra_rcnn/libra_retinanet_r50_fpn_1x_coco.py",
     None, (0, 0), None),
    ("pisa_retina", "configs/pisa/pisa_retinanet_r50_fpn_1x_coco.py", None,
     (0, 0), None))
COCO_DENSE_DIR = os.path.join(REPO, "build", "chip_smoke_coco_dense")
COCO_DENSE_STEPS = 3
# the last two mask-producing cascades (the cascades phase): label, config,
# the RoIAlign kernel calls of a batch or step (HTC: 3 box stages and 3
# mask stages; DetectoRS: 3 box stages and the mask), whether it trains
# with its warmup (DetectoRS at the base LR: at the warmup's first LRs
# weight decay moves the RFP copy's stem and layer1, behind its gradient
# stops, by less than a float32 ulp in 3 steps; from random weights its
# losses grow by orders of magnitude a step there, finite: each SAC conv's
# weight_beta, a constant added to every weight element, moves the output
# by the sum of its input window).  Both from weights with calibrated
# BatchNorm statistics, DetectoRS's backbone copy's too.
CASCADE_CONFIGS = (
    ("htc", "configs/htc/htc_r50_fpn_1x_bonai.py", 6, True),
    ("detectors", "configs/detectors/detectors_cascade_rcnn_r50_1x_bonai.py",
     4, False))
CASCADE_STEPS = 3
# RepPoints, FSAF, FoveaBox and Guided-Anchoring Faster R-CNN (the dense2
# phase): label, config, the RoIAlign kernel calls of a batch or step (the
# three dense detectors run the dense phase's pattern, GA the trunks
# phase's for PAFPN: calibrated BatchNorm statistics, the warmup of its
# COCO schedule)
DENSE2_CONFIGS = (
    ("reppoints", "configs/reppoints/reppoints_moment_r50_fpn_1x_bonai.py",
     0),
    ("fsaf", "configs/fsaf/fsaf_r50_fpn_1x_bonai.py", 0),
    ("fovea", "configs/foveabox/fovea_r50_fpn_4x4_1x_bonai.py", 0),
    ("ga_faster", "configs/guided_anchoring/ga_faster_r50_fpn_1x_bonai.py",
     1))
DENSE2_STEPS = 3
# NAS-FPN RetinaNet, NAS-FCOS, SSD300 and CornerNet (the dense3 phase):
# label, config, whether its BatchNorm statistics are calibrated (the R50
# trunks and the hourglass; SSD's VGG has none), its small float32
# input's size (SSD's extra convs need 300-odd pixels a side, the
# hourglass multiples of 128), its ``inference_detector`` image's size
# (the hourglass takes the 1024^2-scaled image only at a multiple of 128,
# as in the JAX package: 512x640 pads to 832x1024) and its training
# batch's side (SSD's config trains at 300^2, CornerNet's at 511^2 crops)
DENSE3_CONFIGS = (
    ("nasfpn", "configs/nas_fpn/retinanet_r50_nasfpn_bonai.py", True,
     (256, 320), (512, 640), 1024),
    ("nasfcos", "configs/nas_fcos/nas_fcos_r50_fpn_bonai.py", True,
     (256, 320), (512, 640), 1024),
    ("ssd", "configs/ssd/ssd300_bonai.py", False, (320, 320), (512, 640),
     300),
    ("cornernet", "configs/cornernet/cornernet_hourglass104_bonai.py", True,
     (128, 256), (512, 512), 511))
DENSE3_STEPS = 3
# LOFT's attribute heads with the semi-RPN, and polar offsets (the attr
# phase): the RoIAlign kernel calls of a serve batch and of a training
# step, and the steps
ATTR_CALLS = {"attr": (8, 7), "polar": (3, 3)}
ATTR_STEPS = 3
ATTR_FILES_STEPS = 2
ATTR_DIR = os.path.join(REPO, "build", "chip_smoke_attr")
# test-time augmentation on LOFT-FOA (the tta phase): label, merge level,
# views, the RoIAlign kernel calls of a batch (3 a view: box, mask, offset)
TTA_DEFAULT = dict(scales=[1.0], flip=True,
                   flip_directions=["horizontal", "vertical"])
TTA_RUNS = (("det", "det", TTA_DEFAULT, 9),
            ("proposal", "proposal", TTA_DEFAULT, 9),
            ("det scales", "det", dict(scales=[1.0, 0.5], flip=True,
                                       flip_directions=["horizontal"]), 12))
TTA_DIR = os.path.join(REPO, "build", "chip_smoke_tta")
TTA_CHECKPOINT = os.path.join(REPO, "build", "chip_smoke_tta_ckpt",
                              "data_phase.pth")
# the datasets phase: its files, the robustness run (tiles, severity) and
# the configs it trains from files
DATASETS_DIR = os.path.join(REPO, "build", "chip_smoke_datasets")
ROBUST_TILES = 2
ROBUST_SEVERITY = 3
DATASETS_STEPS = 2
VOC_CONFIG = os.path.join(REPO,
                          "configs/pascal_voc/faster_rcnn_r50_fpn_1x_voc0712.py")
CITYSCAPES_CONFIG = os.path.join(
    REPO, "configs/cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py")
LVIS_CONFIG = os.path.join(
    REPO, "configs/lvis/mask_rcnn_r50_fpn_sample1e-3_mstrain_1x_lvis_v1.py")
# the tools phase: its files, and the eval phase's masks that the mask
# library and its numpy versions encode, decode and intersect
TOOLS_DIR = os.path.join(REPO, "build", "chip_smoke_tools")
TOOLS_MASKS = 300
TOOLS_TIMED = 3         # timed calls of the eager and the reloaded program
# the rcnn phase's checkpoints scored COCO-style by the test CLI: --eval,
# and the RoI calls of a batch
COCO_SCORED = {"mask_rcnn": (("bbox", "segm"), 2), "dynamic": (("bbox",), 1),
               "mask_scoring": (("bbox", "segm"), 2), "grid": (("bbox",), 2),
               "point_rend": (("bbox", "segm"), 1),
               **{label: (("bbox",), 0) for label, _, scored in DENSE_CONFIGS
                  if scored},
               **{label: (("bbox", "segm") if calls == 2 else ("bbox",),
                          calls) for label, _, calls, *_ in TRUNK_CONFIGS},
               **{label: (("bbox", "segm"), calls)
                  for label, _, calls, _ in CASCADE_CONFIGS},
               **{label: (("bbox", "segm") if calls == 2 else ("bbox",),
                          calls)
                  for label, _, calls, *_ in COCO_TRUNK_CONFIGS},
               **{label: (("bbox",), calls)
                  for label, _, calls in DENSE2_CONFIGS},
               "c4": (("bbox", "segm"), 2),
               **{label: (("bbox",), 0) for label, *_ in DENSE3_CONFIGS}}
# the rest of the R-CNN family on BONAI (the rcnn2 phase): label, config,
# the RoIAlign calls of a batch or step
RCNN2_CONFIGS = (
    ("libra", "configs/libra_rcnn/libra_faster_rcnn_r50_fpn_1x_bonai.py", 1),
    ("double_head",
     "configs/double_heads/dh_faster_rcnn_r50_fpn_1x_bonai.py", 2),
    ("mask_scoring", "configs/ms_rcnn/ms_rcnn_r50_fpn_1x_bonai.py", 2),
    ("rpn", "configs/rpn/rpn_r50_fpn_1x_bonai.py", 0),
    ("fast_rcnn", "configs/fast_rcnn/fast_rcnn_r50_fpn_1x_bonai.py", 1))
RCNN2_STEPS = 3
# Grid R-CNN and PointRend (the rcnn3 phase): label, config, the RoIAlign
# kernel calls of a batch or step
RCNN3_CONFIGS = (
    ("grid", "configs/grid_rcnn/grid_rcnn_r50_fpn_gn-head_2x_bonai.py", 2),
    ("point_rend", "configs/point_rend/point_rend_r50_fpn_2x_bonai.py", 1))
RCNN3_STEPS = 3
JAX_BLOCK_CELLS = 40        # the JAX block kernel's padded window
DATA_DIR = os.path.join(REPO, "build", "chip_smoke_data")
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA H100 SXM data sheet
H100_FP32_FLOPS = 67e12             # fp32 outside the tensor cores
BATCH, SIZE, C = 2, 1024, 256
SERVE_BRANCHES = (("bbox", 6000, 7), ("mask", 4000, 14), ("offset", 4000, 7))
TRAIN_BRANCHES = (("bbox", 2048, 7), ("mask", 512, 14), ("offset", 512, 7))
STRIDES = [4, 8, 16, 32]
# the C4 layout's RoIAlign (the coco_rcnn phase's C4 Mask R-CNN): one
# stride-16 level of 1024 channels, 14x14 bins; serving 1000 proposals and
# 100 detections an image, training 512 samples and their 128 positives
C4_STRIDES, C4_C = [16], 1024
C4_SERVE_BRANCHES = (("bbox", 2000, 14), ("mask", 200, 14))
C4_TRAIN_BRANCHES = (("bbox", 1024, 14), ("mask", 256, 14))
# TP/FP/FN of the planted check: the first val scene's crop json scored as
# its own results (tests/test_torch_port_eval.py asserts the same counts)
PLANTED = {"roof": (24, 1, 1), "footprint": (25, 0, 0)}
SCORED_CROPS = 1            # of the eval phase's 4 (see eval_phase)
# the evaluation CLI traces and overlays each scored mask on the host, at
# 0.1-0.3 s a record for the noisy masks of barely trained weights; where
# a phase only checks that the CLI scores its test CLI's pkl, it scores
# the best EVAL_TOP detections
EVAL_TOP = 100


def _gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(nbytes, flops):
    """The least time for ``nbytes`` of device memory traffic and
    ``flops`` float32 operations, and which of the two sets it."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _rois(n, gen):
    """Proposal-like RoIs on a 1024^2 tile: log-uniform sizes 4..700 px,
    one in twenty wide and flat (the block and strip rules push those
    coarser), boxes over the border, one in ten invalid."""
    import torch
    c = torch.rand(n, 2, generator=gen) * SIZE
    wh = torch.exp(torch.empty(n, 2).uniform_(1.4, 6.55, generator=gen))
    flat = torch.rand(n, generator=gen) < 0.05
    wh[flat] = torch.stack([wh[flat, 0].clamp(min=200),
                            wh[flat, 0].clamp(min=200) / 8], 1)
    boxes = torch.cat([c - wh / 2, c + wh / 2], 1).clamp(-50, SIZE + 50)
    b = torch.randint(0, BATCH, (n, 1), generator=gen).float()
    valid = torch.rand(n, generator=gen) > 0.1
    return torch.cat([b, boxes], 1).cuda(), valid.cuda()


def _block_module():
    """The module ``bonai_tpu_torch.ops.roi_align_block`` (the package's
    attribute of that name is its function)."""
    import importlib
    return importlib.import_module("bonai_tpu_torch.ops.roi_align_block")


def _device_ms(fn, reps, name):
    """The device time per call of kernel ``name`` over ``reps`` calls of
    ``fn`` (the calls ``_time_ms`` times): CUDA events recorded on the
    stream just before and just after each bare C launch (the ``ctypes``
    call), summed.  No profiler: a tracer left attached would slow every
    later launch of the serve and train phases."""
    import torch
    module = _block_module()
    events = []

    def timed(call):
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = call(*args)
            end.record()
            events.append((start, end))
            return rc
        return run
    fn()
    torch.cuda.synchronize()
    saved = module._call
    module._call = timed(saved)
    try:
        for _ in range(reps):
            fn()
    finally:
        module._call = saved
    torch.cuda.synchronize()
    if len(events) != reps:
        raise AssertionError(f"{name}: {len(events)} launches in {reps} "
                             f"calls")
    return sum(a.elapsed_time(b) for a, b in events) / reps


class _Sums:
    """Per-batch sums of one kernel's numbers over the three branches."""

    def __init__(self):
        self.ms = self.device_ms = self.plain_ms = self.bound_ms = 0.0
        self.err = 0.0
        self.bound_by = None
        self.levels_checked = 0

    def add(self, ms, device_ms, plain_ms, bound, bound_by, err):
        self.ms += ms
        self.device_ms += device_ms
        self.plain_ms += plain_ms
        self.bound_ms += bound
        self.err = max(self.err, err)
        self.bound_by = bound_by


# per entry of ``_kernels``: the CUDA source that builds its kernel
# (``bonai_tpu_torch/csrc/<source>.cu``), the TPU kernel it replaces, and
# for the forwards, the level rule's arguments of ``launch_forward`` (the
# name of its ``level_rule`` in ``ops/roi_align_block.py``, window)
KERNELS = {
    "roi_align_block_fwd": ("roi_align_block_fwd",
                            "bonai_tpu/ops/pallas_roi_align_block.py:152",
                            ("BLOCK_RULE", 32)),
    "roi_align_fused_fwd": ("roi_align_block_fwd",
                            "bonai_tpu/ops/pallas_roi_align_fused.py:127",
                            ("STRIP_RULE", 40)),
    "roi_align_strip_fwd": ("roi_align_block_fwd",
                            "bonai_tpu/ops/pallas_roi_align.py:113",
                            ("WINDOW64_RULE", 64)),
    "roi_align_block_bwd": ("roi_align_block_bwd",
                            "bonai_tpu/ops/pallas_roi_align_block.py:216",
                            None),
    "roi_align_fused_bwd": ("roi_align_block_bwd",
                            "bonai_tpu/ops/pallas_roi_align_fused.py:181",
                            None),
}


def _window64(name):
    return KERNELS[name][2][0] == "WINDOW64_RULE"


def _kernels():
    """The port's RoIAlign wrappers: name -> (wrapper, which counts its
    kernel's launches; plain version of the function; level rule).  The
    block and the strip ('fused') route launch the same two kernels under
    their own rule and counters, the window-64 route ('strip') the forward
    kernel in its window-64 mode."""
    from bonai_tpu_torch.ops import (block_levels, roi_align_block,
                                     roi_align_block_backward,
                                     roi_align_block_ref, roi_align_fused,
                                     roi_align_fused_backward,
                                     roi_align_fused_ref, roi_align_strip,
                                     roi_align_strip_ref, strip_levels)
    from bonai_tpu_torch.ops.roi_align_strip import gather_levels
    return {
        "roi_align_block_fwd": (roi_align_block, roi_align_block_ref,
                                block_levels),
        "roi_align_fused_fwd": (roi_align_fused, roi_align_fused_ref,
                                strip_levels),
        "roi_align_strip_fwd": (roi_align_strip, roi_align_strip_ref,
                                gather_levels),
        "roi_align_block_bwd": (roi_align_block_backward,
                                roi_align_block_ref, block_levels),
        "roi_align_fused_bwd": (roi_align_fused_backward,
                                roi_align_fused_ref, strip_levels),
    }


def _edge_rois():
    """RoIs on the edges of the level rules, one float32 ulp below, at and
    above: max(w, h) = 112 * 2^k (the block push), w = 144 * 2^k (the strip
    push), sqrt(w * h) = 56 * 2^k and 56 * (2^k - 1e-6) (the gather rule),
    from the origin and from a fractional corner."""
    import numpy as np
    import torch
    rows = []
    for k in range(-2, 6):
        edges = [(112, "wide"), (112, "tall"), (144, "wide"), (56, "square"),
                 (56 * (1 - 1e-6 / 2.0 ** k), "square")]
        for edge, shape in edges:
            e = np.float32(edge * 2.0 ** k)
            for v in (np.nextafter(e, np.float32(0)), e,
                      np.nextafter(e, np.float32(np.inf))):
                w, h = {"wide": (v, v / 8), "tall": (v / 8, v),
                        "square": (v, v)}[shape]
                for x0, y0 in ((0.0, 0.0), (100.25, 37.5)):
                    rows.append([len(rows) % BATCH, x0, y0,
                                 np.float32(x0) + w, np.float32(y0) + h])
    return torch.tensor(np.array(rows, np.float32), device="cuda")


def _check_levels(name, levels, rois, size, strides=STRIDES):
    """The levels that forward kernel ``name`` computes for ``rois`` must
    equal its torch rule's on the card; returns the RoIs checked."""
    import torch
    block = _block_module()
    rule, window = KERNELS[name][2]
    _, lvl = block.launch_forward(levels, rois, None, (size, size), strides,
                                  2, getattr(block, rule), 56, window)
    want = _kernels()[name][2](rois[:, 1:5], strides)
    if not torch.equal(lvl.long(), want):
        bad = (lvl.long() != want).nonzero()[:, 0]
        raise AssertionError(f"{name}: the kernel's levels differ from the "
                             f"torch rule's on {bad.numel()} RoIs, e.g. "
                             f"{rois[bad[:4]].tolist()}")
    return rois.shape[0]


def _zero_counts():
    for fn, _, _ in _kernels().values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, (fn, _, _) in _kernels().items()}


def _check_counts(counts, expected, what):
    """``counts`` must equal ``expected`` for the named kernels and be 0
    for every other."""
    want = {name: expected.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{what}: kernel launches {counts}, expected "
                             f"{want}")


def _cells_read(name, shapes, rois, size, valid, strides=STRIDES):
    """The distinct level cells that forward kernel ``name`` must read for
    these RoIs: the corners of nonzero weight of the valid RoIs' samples
    (B5's window-cut corners have weight zero)."""
    import torch
    from bonai_tpu_torch.ops.roi_align import corner_plan
    from bonai_tpu_torch.ops.roi_align_strip import strip_corner_plan
    if _window64(name):
        corners, weights = strip_corner_plan(shapes, rois, size, strides)
        weights = [w * valid[:, None, None] for w in weights]
    else:
        corners, weights = corner_plan(
            shapes, rois, _kernels()[name][2](rois[:, 1:5], strides), size,
            strides, roi_valid=valid)
    return int(torch.unique(torch.cat(
        [c[w != 0] for c, w in zip(corners, weights)])).numel())


def _forward_kernel(name, levels32, branches, seed, label,
                    strides=STRIDES):
    """One forward kernel against its plain version; returns the bfloat16
    per-batch sums.  ``seed`` draws the RoIs (the same seed, the same RoIs
    for every kernel).  The bound's bytes are the level cells this run's
    RoIs read (``_cells_read``), the RoIs and the output."""
    import torch
    fn, ref_fn, level_rule = _kernels()[name]
    gen = torch.Generator().manual_seed(seed)
    sums = _Sums()
    c = levels32[0].shape[-1]
    for dtype in (torch.float32, torch.bfloat16):
        levels = [f.to(dtype) for f in levels32]
        shapes = [tuple(f.shape) for f in levels]
        cell_bytes = c * levels[0].element_size()
        for branch, n, size in branches:
            rois, valid = _rois(n, gen)
            args = (levels, rois, size, strides)
            with torch.no_grad():
                got = fn(*args, roi_valid=valid)
                torch.cuda.synchronize()
                ref = ref_fn(*args, roi_valid=valid)
            diff = (got.float() - ref.float()).abs()
            if dtype == torch.float32:
                ok = bool((diff <= 1e-4 + 1e-4 * ref.abs()).all())
            else:       # one bf16 ulp relative
                ok = bool((diff <= ref.float().abs() * 2 ** -7 + 1e-6).all())
            pushed = "" if _window64(name) else " pushed=%d" % int((
                level_rule(rois[:, 1:5], strides)
                > level_rule(rois[:, 1:5], strides, window=10 ** 9)).sum())
            sums.levels_checked += _check_levels(name, levels, rois, size,
                                                 strides)

            def kernel():
                with torch.no_grad():
                    return fn(*args, roi_valid=valid)

            def plain():
                with torch.no_grad():
                    return ref_fn(*args, roi_valid=valid)
            ms = _time_ms(kernel, 20)
            device_ms = _device_ms(kernel, 20, name)
            plain_ms = _time_ms(plain, 3)
            cells = _cells_read(name, shapes, rois, size, valid, strides)
            nbytes = (cells * cell_bytes + rois.numel() * 4 + valid.numel()
                      + got.numel() * got.element_size())
            # 4 corners x (multiply + add) per sample and channel, valid rows
            flops = int(valid.sum()) * size * size * 4 * 4 * 2 * c
            bound, bound_by = _bound_ms(nbytes, flops)
            print(f"kernel {name} {label} {str(dtype)[6:]} "
                  f"{branch} R={n} {size}x{size}: "
                  f"max_abs_err={float(diff.max()):.3g} within_tol={ok}"
                  f"{pushed} invalid={int((~valid).sum())} "
                  f"ms={ms:.4f} device_ms={device_ms:.4f} "
                  f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f} "
                  f"({bound_by}; {cells} cells read)", flush=True)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version ({label}, {dtype}, {branch})")
            if dtype == torch.bfloat16:
                sums.add(ms, device_ms, plain_ms, bound, bound_by,
                         float(diff.max()))
    return sums


def _backward_kernel(name, levels32, seed, branches=TRAIN_BRANCHES,
                     strides=STRIDES, label="train"):
    """One backward kernel at the training shapes against autograd through
    the plain version; returns the bfloat16 per-step sums."""
    import torch
    fn, ref_fn, level_rule = _kernels()[name]
    gen = torch.Generator().manual_seed(seed)
    sums = _Sums()
    c = levels32[0].shape[-1]
    for dtype in (torch.float32, torch.bfloat16):
        levels = [f.to(dtype, copy=True).requires_grad_()
                  for f in levels32]
        shapes = [tuple(f.shape) for f in levels]
        grad_bytes = sum(f.numel() * f.element_size() for f in levels)
        for branch, n, size in branches:
            rois, valid = _rois(n, gen)
            lvl = level_rule(rois[:, 1:5], strides).to(torch.int32)
            cot = torch.randn(n, size, size, c, generator=gen).to(
                device="cuda", dtype=dtype)

            def kernel():
                return fn(cot, shapes, strides, rois, lvl, valid)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            got = kernel()
            torch.cuda.synchronize()
            # the level gradients are all the backward allocates: no float32
            # copy of the pyramid, no cast
            extra = torch.cuda.max_memory_allocated() - before
            if extra > grad_bytes + 2 ** 20 or any(
                    g.dtype != cot.dtype for g in got):
                raise AssertionError(f"{name} allocated {extra} bytes for "
                                     f"{grad_bytes} bytes of {dtype} "
                                     f"gradients")
            out = ref_fn(levels, rois, size, strides, roi_valid=valid)

            def plain():
                return torch.autograd.grad(out, levels, cot,
                                           retain_graph=True)
            ref = plain()
            ok, err = True, 0.0
            for g, e in zip(got, ref):
                top = float(e.float().abs().max())
                diff = (g.float() - e.float()).abs()
                err = max(err, float(diff.max()))
                if dtype == torch.float32:      # 1e-4 of the level's largest
                    ok &= float(diff.max()) <= 1e-4 * top
                else:       # one bf16 ulp, plus float32 summation order
                    ok &= bool((diff <= e.float().abs() * 2 ** -7
                                + 1e-5 * top).all())
            ms = _time_ms(kernel, 20)
            device_ms = _device_ms(kernel, 20, name)
            plain_ms = _time_ms(plain, 3)
            # the output gradient read once, the level gradients written once
            nbytes = (cot.numel() * cot.element_size() + grad_bytes
                      + rois.numel() * 4 + lvl.numel() * 4 + valid.numel())
            # 4 corners x (multiply + add) per sample and channel, valid rows
            flops = int(valid.sum()) * size * size * 4 * 4 * 2 * c
            bound, bound_by = _bound_ms(nbytes, flops)
            print(f"kernel {name} {label} {str(dtype)[6:]} {branch} "
                  f"R={n} {size}x{size}: max_abs_err={err:.3g} "
                  f"within_tol={ok} invalid={int((~valid).sum())} "
                  f"ms={ms:.4f} device_ms={device_ms:.4f} "
                  f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f} "
                  f"({bound_by}; allocated {extra} bytes for {grad_bytes} "
                  f"bytes of level gradients)", flush=True)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version ({dtype}, {branch})")
            if dtype == torch.bfloat16:
                sums.add(ms, device_ms, plain_ms, bound, bound_by, err)
            del out
    return sums


def kernel_phase():
    """Every kernel against its plain version.  Returns the bfloat16
    per-batch (per-step) sums by kernel: ``(name, "serve")`` and ``(name,
    "train")`` for the forwards, ``(name, "train")`` for the backwards.
    The forwards of one set of shapes, and the backwards, share their
    RoIs."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    levels32 = [torch.randn(BATCH, SIZE // s, SIZE // s, C, generator=gen)
                .cuda() for s in STRIDES]
    sums = {}
    for name in ("roi_align_block_fwd", "roi_align_fused_fwd"):
        sums[name, "serve"] = _forward_kernel(name, levels32, SERVE_BRANCHES,
                                              1, "serve")
    for name in ("roi_align_block_fwd", "roi_align_fused_fwd",
                 "roi_align_strip_fwd"):
        sums[name, "train"] = _forward_kernel(name, levels32, TRAIN_BRANCHES,
                                              2, "train")
    for name in ("roi_align_block_bwd", "roi_align_fused_bwd"):
        sums[name, "train"] = _backward_kernel(name, levels32, 3)
    # the C4 layout: one stride-16 level of 1024 channels, 14x14 bins
    c4 = [torch.randn(BATCH, SIZE // 16, SIZE // 16, C4_C, generator=gen)
          .cuda()]
    sums["roi_align_block_fwd", "c4 serve"] = _forward_kernel(
        "roi_align_block_fwd", c4, C4_SERVE_BRANCHES, 4, "c4 serve",
        C4_STRIDES)
    sums["roi_align_block_fwd", "c4 train"] = _forward_kernel(
        "roi_align_block_fwd", c4, C4_TRAIN_BRANCHES, 5, "c4 train",
        C4_STRIDES)
    sums["roi_align_block_bwd", "c4 train"] = _backward_kernel(
        "roi_align_block_bwd", c4, 5, C4_TRAIN_BRANCHES, C4_STRIDES,
        "c4 train")
    for key in (("roi_align_block_fwd", "c4 serve"),
                ("roi_align_block_fwd", "c4 train"),
                ("roi_align_block_bwd", "c4 train")):
        v = sums[key]
        print(f"kernel {key[0]} at the C4 shape, {key[1][3:]}: bf16 "
              f"{v.ms:.4f} ms a batch or step (device {v.device_ms:.4f}), "
              f"bound {v.bound_ms:.4f} ms ({v.bound_by}), "
              f"{v.device_ms / v.bound_ms:.1f}x the bound; plain "
              f"{v.plain_ms:.3f} ms", flush=True)
    edges = _edge_rois()
    for name in ("roi_align_block_fwd", "roi_align_fused_fwd",
                 "roi_align_strip_fwd"):
        checked = _check_levels(name, levels32, edges, 7) + sum(
            v.levels_checked for (n, _), v in sums.items() if n == name)
        print(f"kernel {name}: the kernel's levels equal the torch rule's "
              f"on {checked} RoIs ({edges.shape[0]} on the rules' edges)",
              flush=True)
    return sums


def _branches(model, train=False):
    """Each RoI branch of a batch (with ``train``, of a training step):
    ``(name, run, calls)``, where ``run(feats, rois, valid)`` gives the
    branch's head outputs (a tuple) from its ``calls`` RoIAlign kernel
    calls: the box head (a cascade's every stage; Double-Head's two calls,
    its reg RoIs scaled), then the mask head (with Mask Scoring's IoU head
    on the same RoI features; no kernel call behind PointRend's
    single-level ``GenericRoIExtractor``, the plain RoIAlign), Grid
    R-CNN's grid head and the offset head the model has.  LOFT's offset
    branch adds the height heads on its features, and the mask and
    side-face calls of its reweighting; then its side-face head, its
    offset-field head (serving: with the mask call of its aggregation)
    and its angle head (no RoIAlign).  HTC's every box stage and mask
    stage (its info-flow chain inside) each take the semantic embedding.
    The RPN-only detector has none.  An extractor that pools by GRoIE, a
    ``GenericRoIExtractor``, RoIPool or a deformable pooling pack runs
    plain PyTorch, no kernel (``_kernel_calls``); the C4 layout's mask
    branch reads the box branch's RoIAlign and shared head."""
    import torch
    if "bbox_head" not in getattr(model, "roi_head", {}):
        return []                       # the RPN, a dense detector
    if hasattr(model, "mask_stage"):    # HTC
        def sem(f):
            return model.semantic(f)[1]
        return [(f"HTC box stage {i}",
                 lambda f, r, v, h=h: model._bbox_head_forward(
                     h, f, r, v, sem_feat=sem(f)), 1)
                for i, h in enumerate(model.roi_head["bbox_head"])] + [
            (f"HTC mask stage {i}",
             lambda f, r, v, i=i: (model.mask_stage(i, f, r, v, sem(f)),), 1)
            for i in range(model.num_stages)]
    bbox = model.roi_head["bbox_head"]
    double = getattr(model, "reg_roi_scale_factor", None) is not None
    out = [(type(h).__name__,
            lambda f, r, v, h=h: model._bbox_head_forward(h, f, r, v),
            (2 if double else 1) * _kernel_calls(model.bbox_extractor_cfg))
           for h in (bbox if isinstance(bbox, torch.nn.ModuleList)
                     else [bbox])]
    if "mask_head" in model.roi_head:
        def mask(f, r, v):
            x = model._mask_roi_feats(f, r, v)
            logits = model.roi_head["mask_head"](x)
            if "mask_iou_head" not in model.roi_head:
                return (logits,)
            return logits, model.roi_head["mask_iou_head"](x, logits)
        out.append(("mask head" + (" + IoU head" if "mask_iou_head" in
                                   model.roi_head else ""), mask,
                    _kernel_calls(model.mask_extractor_cfg
                                  or model.bbox_extractor_cfg)))
    if "grid_head" in model.roi_head:
        out.append(("GridHead", lambda f, r, v: (model.roi_head["grid_head"](
            model._roi_align_cfg(model.grid_extractor_cfg, f, r, v))[
                "fused"],), 1))
    if "offset_head" in model.roi_head:
        reweights = getattr(model, "reweights", False)

        def offset(f, r, v):
            x = model._offset_feats(f, r, v)
            outs = [model.roi_head["offset_head"](x)]
            for h in ("height_head", "offset_height_head"):
                if h in model.roi_head:
                    o = model.roi_head[h](x)
                    outs += list(o) if isinstance(o, tuple) else [o]
            return tuple(outs)
        out.append(("OffsetHead" + (", reweighted" if reweights else ""),
                    offset, 3 if reweights else 1))
    if "side_face_head" in model.roi_head:
        out.append(("SideFaceHead", lambda f, r, v: (
            model._side_face_logits(f, r, v),), 1))
    if "offset_field_head" in model.roi_head:
        from bonai_tpu_torch.models.roi_heads.attribute_heads import (
            offset_field_to_offsets)
        aggregate = model.with_mask and not train

        def field(f, r, v):
            x = model._roi_align_cfg(model.offset_field_extractor_cfg, f, r,
                                     v)
            y = model.roi_head["offset_field_head"](x)
            if not aggregate:
                return (y,)
            return y, offset_field_to_offsets(y, model._mask_logits(f, r, v))
        out.append(("OffsetFieldHead", field, 2 if aggregate else 1))
    if "angle_head" in model.roi_head:
        out.append(("AngleHead", lambda f, r, v: (
            model.roi_head["angle_head"](f),), 0))
    return out


def _kernel_calls(extractor_cfg):
    """The kernel calls of one RoI extraction by ``extractor_cfg``: 1 for
    a ``SingleRoIExtractor``'s RoIAlign, 0 for a ``GenericRoIExtractor``
    (GRoIE, PointRend's), RoIPool or a deformable pooling pack."""
    layer = dict(extractor_cfg.get("roi_layer", {})).get("type", "RoIAlign")
    return int(extractor_cfg.get("type") != "GenericRoIExtractor"
               and layer == "RoIAlign")


def _roi_calls(model, train=False):
    """The RoIAlign calls a batch (with ``train``, a step) of ``model``
    makes."""
    return sum(calls for _, _, calls in _branches(model, train))


def _train_calls(model):
    """The forward and the backward kernel calls of a training step: a
    hard-mining sampler (OHEM, ScoreHLR) runs the box branch once more,
    without gradient, over every candidate."""
    from bonai_tpu_torch.models.detectors.two_stage import HARD_MINING
    n = _roi_calls(model, train=True)
    rcnn = (getattr(model, "train_cfg", None) or {}).get("rcnn")
    ranked = isinstance(rcnn, dict) and dict(rcnn.get("sampler", {})).get(
        "type") in HARD_MINING
    return n + (_branches(model, True)[0][2] if ranked else 0), n


def _max_dets(model):
    """Detections a serve call pads to: the R-CNN's ``max_per_img``, the
    RPN-only detector's proposals."""
    if "bbox_head" in model.roi_head:
        return model.test_cfg["rcnn"]["max_per_img"]
    return model.test_cfg["rpn"]["max_num"]


def _serve_proposals(model, img):
    """A Fast R-CNN's proposals for a serve batch ``img``: 2000 an image
    around the synthetic batch's GTs, on the card; none for a detector
    with an RPN."""
    import torch
    if not model.takes_proposals:
        return ()
    from bonai_tpu_torch.tools.profile_train import (synthetic_batch,
                                                     synthetic_proposals)
    b = synthetic_batch(batch=img.shape[0], size=int(img.shape[1]), m=1)
    return tuple(torch.as_tensor(x).to(img.device) for x in
                 synthetic_proposals(b["gt_bboxes"], b["gt_valid"], 2000,
                                     int(img.shape[1])))


def _mask_side(model):
    """The side of a serve call's masks: twice its RoI features' (28 for
    the FCN head on 14x14 RoIs, 14 for the C4 layout's 7x7 shared-head
    map), or PointRend's coarse side doubled at each subdivision step
    (224)."""
    if "point_head" not in model.roi_head:
        ext = model.mask_extractor_cfg or model.bbox_extractor_cfg
        side = dict(ext.get("roi_layer", {})).get("output_size", 14)
        if model.mask_extractor_cfg is None:        # through the shared head
            side //= model.roi_head["shared_head"].stride
        return 2 * side
    tc = model.test_cfg["rcnn"]
    return model.roi_head["mask_head"].output_size * tc.get(
        "scale_factor", 2) ** tc.get("subdivision_steps", 5)


def _check_outputs(out, b, p, model, need_detections=True):
    """``simple_test``'s outputs: the keys of ``model``'s heads, their
    shapes, finite values and, with ``need_detections``, a valid
    detection."""
    import torch
    shapes = {"det_bboxes": (b, p, 4), "det_scores": (b, p),
              "det_labels": (b, p), "det_valid": (b, p)}
    roi_head = getattr(model, "roi_head", {})   # none in a dense detector
    if "mask_head" in roi_head:
        shapes["mask_probs"] = (b, p, _mask_side(model), _mask_side(model))
    if "mask_iou_head" in roi_head:
        shapes["mask_scores"] = (b, p)
    if "offset_head" in roi_head:
        shapes["offsets"] = (b, p, 2)
    side = 2 * dict(getattr(model, "side_face_extractor_cfg", {}).get(
        "roi_layer", {})).get("output_size", 0)
    for head, keys in (
            ("height_head", {"heights": (b, p)}),
            ("offset_height_head", {"offset_height_offsets": (b, p, 2),
                                    "offset_height_heights": (b, p)}),
            ("angle_head", {"angle": (b,)}),
            ("side_face_head", {"side_face_probs": (b, p, side, side)}),
            ("offset_field_head", {"offset_field_offsets": (b, p, 2)})):
        if head in roi_head:
            shapes.update(keys)
    if set(out) != set(shapes):
        raise AssertionError(f"outputs {sorted(out)}, expected "
                             f"{sorted(shapes)}")
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{key}: shape {tuple(out[key].shape)}, "
                                 f"expected {shape}")
        if out[key].is_floating_point() and not bool(
                torch.isfinite(out[key]).all()):
            raise AssertionError(f"{key} has non-finite values")
    if need_detections and not int(out["det_valid"].sum()):
        raise AssertionError("no valid detections")


# per route: the detector module's name of the wrapper, its forward and
# backward kernels
ROUTES = {"block": ("roi_align_block", "roi_align_block_fwd",
                    "roi_align_block_bwd"),
          "pallas": ("roi_align_fused", "roi_align_fused_fwd",
                     "roi_align_fused_bwd")}


def _config(impl, config=CONFIG):
    from bonai_tpu_torch.config import Config
    cfg = Config.fromfile(config)
    cfg.model.roi_align_impl = impl
    return cfg


def _plain_route(impl):
    """The plain version of route ``impl``'s wrapper, taking the wrapper's
    arguments."""
    ref_fn = _kernels()[ROUTES[impl][1]][1]

    def plain(levels, rois, output_size, featmap_strides, backward=None,
              **kw):
        return ref_fn(levels, rois, output_size, featmap_strides, **kw)
    return plain


def serve_phase(impl, config=CONFIG, calls=2, label=None, checkpoint=None,
                inspect=None):
    """Full-width serving of ``config`` (LOFT-FOA R50-FPN by default)
    through the port's entry points with ``roi_align_impl=impl``, seeded
    random weights or those of ``checkpoint``: ``calls`` timed batches,
    then one ``inference_detector`` call (``inspect(model, img, img_shape,
    scale)`` after them).  Returns the forward kernel's launch count of the
    run, its ms per call and the peak device memory of the batches and the
    ``inference_detector`` call in GiB."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import (inference_detector, init_detector,
                                      prepare_batch)
    from bonai_tpu_torch.evaluation.coco_eval import split_segm
    _, fwd_name, _ = ROUTES[impl]
    what = label or f"serve ({impl})"

    t0 = time.time()
    model = init_detector(_config(impl, config), checkpoint,  # cuda, bf16
                          seed=0)
    print(f"{what}: init_detector {time.time() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"dtype {next(model.parameters()).dtype}", flush=True)
    max_per_img = _max_dets(model)
    n_roi = _roi_calls(model)
    r = np.random.RandomState(0)
    imgs = [r.randint(0, 256, (SIZE, SIZE, 3), np.uint8)
            for _ in range(BATCH)]
    img, img_shape, scale, _ = prepare_batch(model, imgs)
    props = _serve_proposals(model, img)
    model.simple_test(img, img_shape, scale, *props)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _zero_counts()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.simple_test(img, img_shape, scale, *props)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_outputs(out, BATCH, max_per_img, model)
    _check_counts(_counts(), {fwd_name: n_roi * calls},
                  f"{what}, {calls} batches")
    proposals = None
    if model.takes_proposals:   # 2000 random boxes in the image's pixels
        from bonai_tpu_torch.tools.profile_train import synthetic_proposals
        proposals = synthetic_proposals(np.zeros((1, 0, 4)),
                                        np.zeros((1, 0), bool), 2000,
                                        512)[0][0]
    t0 = time.perf_counter()
    res = inference_detector(model, r.randint(0, 256, (512, 640, 3),
                                              np.uint8), proposals=proposals)
    single_ms = (time.perf_counter() - t0) * 1e3
    bbox = res[0] if isinstance(res, tuple) else res
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"{what}: simple_test 1024^2 B={BATCH} ms per call "
          f"{[round(x, 1) for x in times]}, ms per image "
          f"{[round(x / BATCH, 1) for x in times]}; valid detections "
          f"{out['det_valid'].sum(1).tolist()}", flush=True)
    print(f"{what}: inference_detector 512x640 -> 819x1024 incl. "
          f"host paste+RLE {single_ms:.1f} ms, {len(bbox[0])} detections; "
          f"peak memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated); "
          f"launches {counts}", flush=True)
    _check_counts(counts, {fwd_name: n_roi * (calls + 1)},
                  f"{what}, {calls + 1} batches")
    if inspect is not None:
        inspect(model, img, img_shape, scale)
    # (bbox, segm, offsets), (bbox, segm) or bbox alone; Mask Scoring's
    # segm the pair of masks and mask scores
    parts = len(res) if isinstance(res, tuple) else 1
    if parts != 1 + ("mask_head" in model.roi_head) + (
            "offset_head" in model.roi_head):
        raise AssertionError(f"inference_detector gave {parts} parts")
    segm, mask_scores = split_segm(res[1]) if parts > 1 else (None, None)
    if (mask_scores is None) == ("mask_iou_head" in model.roi_head):
        raise AssertionError("inference_detector: mask scores where the "
                             "model has no IoU head, or none where it has")
    if not (np.isfinite(bbox[0]).all()
            and (parts < 2 or len(segm[0]) == len(bbox[0]))
            and (mask_scores is None or (
                len(mask_scores[0]) == len(bbox[0])
                and np.isfinite(mask_scores[0]).all()))
            and (parts < 3 or (len(res[2]) == len(bbox[0])
                               and np.isfinite(res[2]).all()))):
        raise AssertionError("inference_detector results are inconsistent")

    # a small float32 input: the three RoI branches' head outputs on the
    # model's own proposals, through the kernel and through its plain
    # version (same level rule and arithmetic; no NMS in between, so
    # float noise cannot reorder anything), in float32 throughout: cuDNN's
    # TF32 convolutions would round the two runs' RoI features, which
    # differ in their last bits, to 10-bit mantissas apart
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        _small_input_check(model, impl, what, r)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return counts[fwd_name], statistics.median(times), peak / 2 ** 30


def _small_input_check(model, impl, what, r):
    """The RoI heads' outputs of a small float32 input on the model's own
    proposals, through route ``impl``'s kernel and through its plain
    version."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import prepare_batch
    from bonai_tpu_torch.models.detectors import two_stage
    attr, fwd_name, _ = ROUTES[impl]
    model.float()
    small = [r.randint(0, 256, (256, 320, 3), np.uint8) for _ in range(2)]
    model.cfg.data.test.pipeline[1].img_scale = (320, 320)
    img, img_shape, _, _ = prepare_batch(model, small)
    kernel_fn = getattr(two_stage, attr)
    if not _branches(model):
        print(f"{what}: no RoI branch, no small-input check", flush=True)
        return
    with torch.inference_mode():
        feats = model.extract_feat(img)
        if not model.takes_proposals:
            props, _, pvalid = model._rpn_and_proposals(
                feats, img_shape, dict(model.test_cfg["rpn"]))
        else:
            from bonai_tpu_torch.tools.profile_train import (
                synthetic_proposals)
            props, pvalid = (torch.as_tensor(x).cuda() for x in
                             synthetic_proposals(np.zeros((2, 0, 4)),
                                                 np.zeros((2, 0), bool),
                                                 500, 320))
        rois, rvalid = two_stage.boxes_to_rois(props, pvalid)
        for i, (name, branch, calls) in enumerate(_branches(model)):
            head = f"RoI branch {i} ({name})"

            def run():
                return branch(feats, rois, rvalid)
            launched = kernel_fn.launches
            got = run()
            if kernel_fn.launches != launched + calls:
                raise AssertionError(f"small input: {head} did not run "
                                     f"{fwd_name} {calls} time(s)")
            try:
                setattr(two_stage, attr, _plain_route(impl))
                ref = run()
            finally:
                setattr(two_stage, attr, kernel_fn)
            err = max(float((g - e).abs().max()) for g, e in zip(got, ref))
            scale = max(float(e.abs().max()) for e in ref)
            print(f"{what}: small float32 input, {head} through the "
                  f"kernel vs its plain version: max abs diff {err:.3g} "
                  f"(outputs up to {scale:.3g})", flush=True)
            if not err <= 1e-4 * max(scale, 1.0):
                raise AssertionError(f"small input: {head} differs from "
                                     f"the plain path by {err}")


def _roi_grad_check(model, impl, what):
    """On a small float32 input, one step's RoI branches: the FPN-level
    gradients of their losses through the kernels against the plain
    version's backward fed the same output gradients (the heads between
    them are the same run, so a ReLU flipped by float noise cannot differ
    between the two).  The two sum each level cell's contributions in
    another order, so each element is held to 1e-4 of the sum of its
    contributions' magnitudes (the plain backward of the output
    gradients' magnitudes: the bilinear weights are not negative).  The
    branches' contributions cancel to a net gradient far smaller than
    that sum, which a bound on the net gradient alone ignores."""
    import torch
    from bonai_tpu_torch.core.samplers import generator_draws
    from bonai_tpu_torch.models.detectors import two_stage
    from bonai_tpu_torch.tools.profile_train import synthetic_batch
    from bonai_tpu_torch.tools.profile_train import has_attributes
    attr, fwd_name, bwd_name = ROUTES[impl]
    kernel_fn = getattr(two_stage, attr)
    plain = _plain_route(impl)
    n_fwd, n_roi = _train_calls(model)
    if not n_roi:
        print(f"{what}: no RoI branch, no gradient check", flush=True)
        return
    batch = {k: torch.as_tensor(v).cuda() for k, v in synthetic_batch(
        size=320, g=12, seed=1, proposals=500 if model.takes_proposals
        else 0, attributes=has_attributes(model))
        .items()}
    with torch.no_grad():
        feats = [f.detach().requires_grad_()
                 for f in model.extract_feat(batch["image"])]
        if not model.takes_proposals:
            props, _, pvalid = model._rpn_and_proposals(
                feats, batch["img_shape"],
                dict(model.train_cfg["rpn_proposal"]))
        else:
            props, pvalid = batch["proposals"], batch["proposals_valid"]
    # the levels that collect the gradient go to the kernel calls alone;
    # the heads' other uses of the levels (PointRend's single-level
    # extractor and point features) see them as constants
    const = [f.detach() for f in feats]
    calls = []

    def recorded(levels, rois, output_size, featmap_strides, **kw):
        out = kernel_fn([f.contiguous() for f in feats[:len(levels)]], rois,
                        output_size, featmap_strides, **kw)
        if torch.is_grad_enabled():     # not a hard-mining ranking pass
            out.retain_grad()
            calls.append((rois, output_size, list(featmap_strides), kw,
                          out))
        return out

    _zero_counts()
    try:
        setattr(two_stage, attr, recorded)
        losses = model._roi_forward_train(
            const, props, pvalid, batch,
            generator_draws(torch.Generator(device="cuda").manual_seed(0)))
    finally:
        setattr(two_stage, attr, kernel_fn)
    sum(v for k, v in losses.items() if not k.startswith("stat_")).backward()
    torch.cuda.synchronize()
    _check_counts(_counts(), {fwd_name: n_fwd, bwd_name: n_roi},
                  f"{what}, small input")
    strides = max((c[2] for c in calls), key=len)
    levels = [f.detach().requires_grad_() for f in feats[:len(strides)]]
    mags = [f.detach().requires_grad_() for f in feats[:len(strides)]]
    for rois, output_size, call_strides, kw, out in calls:
        ref = plain(levels[:len(call_strides)], rois, output_size,
                    call_strides, **kw)
        err = float((out - ref).abs().max())
        if not err <= 1e-4 * max(float(ref.abs().max()), 1.0):
            raise AssertionError(f"small input: RoI features differ from "
                                 f"the plain version by {err}")
        ref.backward(out.grad)
        plain(mags[:len(call_strides)], rois, output_size, call_strides,
              **kw).backward(out.grad.abs())
    for s, f, e, m in zip(strides, feats, levels, mags):
        diff = (f.grad - e.grad).abs()
        top = float(e.grad.abs().max())
        ratio = float((diff / m.grad.clamp(min=1e-30)).max())
        print(f"{what}: small float32 input, FPN stride {s} "
              f"gradient of the RoI losses through the kernels vs the plain "
              f"version: max abs diff {float(diff.max()):.3g} (gradients up "
              f"to {top:.3g}, sums of contribution magnitudes up to "
              f"{float(m.grad.max()):.3g}; largest diff over its element's "
              f"sum {ratio:.3g})", flush=True)
        if not bool((diff <= 1e-4 * m.grad).all()):
            raise AssertionError(f"small input: the stride-{s} gradient "
                                 f"differs from the plain path by "
                                 f"{ratio:.3g} of an element's sum")
    if not float(levels[0].grad.abs().max()) > 0:
        raise AssertionError("small input: no gradient reached the FPN")


def train_phase(impl, steps, config=CONFIG, label=None, keep=False,
                warmup=True, load_from=None, batch=None):
    """Full-width training of ``config`` (LOFT-FOA R50-FPN by default)
    through ``train_detector`` with ``roi_align_impl=impl`` for ``steps``
    steps (1 warm-up) on one card, from seeded random weights or those of
    ``load_from``, with the config's LR warmup or, without ``warmup``, at
    its base LR, on ``batch`` (by default the synthetic batch of
    ``profile_train``).  Every trainable tensor must get a gradient in
    some step,
    but for those behind a backbone's gradient stop (``behind_stop``:
    HRNet's ``conv2``/``bn2`` after ``layer1``, Res2Net's deep stem after
    the max-pool, the stem and ``layer1`` of DetectoRS's RFP backbone
    copy), which must get none, and every one must move.
    Returns the forward and backward kernels' launch counts of the run,
    the median warm step time, the peak memory, and with ``keep`` the
    final checkpoint, whose work directory the caller removes."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import train_detector
    from bonai_tpu_torch.engine import train_step as train_step_module
    from bonai_tpu_torch.models.builder import build_detector
    from bonai_tpu_torch.tools.profile_train import synthetic_batch
    from bonai_tpu_torch.utils.weights import load_mmdet_checkpoint
    _, fwd_name, bwd_name = ROUTES[impl]
    what = label or f"train ({impl})"

    cfg = _config(impl, config)
    if not warmup:
        cfg.lr_config.warmup = None
    if batch is None:
        batch = synthetic_batch(proposals=2000 if cfg.model.type
                                == "FastRCNN" else 0)
    work_dir = os.path.join(REPO, "build", "chip_smoke_train" + (
        f"_{label.split()[0]}" if keep else ""))
    shutil.rmtree(work_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # which parameters had a nonzero gradient in some step (on the card,
    # no host read in the step)
    params, grad_seen = [], [None]
    update = train_step_module.apply_gradients

    def recording(optimizer, lr, max_norm=None):
        norm = update(optimizer, lr, max_norm)
        params[:] = [p for g in optimizer.param_groups for p in g["params"]]
        norms = torch.stack(torch._foreach_norm([p.grad for p in params]))
        grad_seen[0] = norms if grad_seen[0] is None else torch.maximum(
            grad_seen[0], norms)
        return norm
    _zero_counts()
    t0 = time.time()
    # one epoch of `steps` copies of the batch: no epoch checkpoint falls
    # between the timed steps
    train_step_module.apply_gradients = recording
    try:
        model, hist = train_detector(cfg, [batch] * steps, work_dir, seed=0,
                                     max_steps=steps, log_interval=1,
                                     n_devices=1, load_from=load_from)
    finally:
        train_step_module.apply_gradients = update
    torch.cuda.synchronize()
    grad_seen[0] = (grad_seen[0] > 0).tolist()
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    wall = time.time() - t0
    step_ms = [h["time"] * 1e3 for h in hist]
    print(f"{what}: train_detector {batch['image'].shape[1]}^2 B={BATCH} "
          f"bf16 autocast, "
          f"{steps} steps in {wall:.1f} s incl. set-up and the final "
          f"checkpoint; ms per step {[round(x, 1) for x in step_ms]}; "
          f"median of the {len(step_ms) - 1} warm steps "
          f"{statistics.median(step_ms[1:]):.1f} ms; peak memory "
          f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated); launches "
          f"{counts}", flush=True)
    # the losses (FreeAnchor's are positive_ and negative_bag_loss)
    keys = [k for k in hist[0] if k.split(".")[-1].startswith("loss")
            or k.endswith("_loss")]
    for h in hist:
        print(f"{what}: step {h['iter']} lr {h['lr']:.3g} grad_norm "
              f"{h['grad_norm']:.4g} " + " ".join(
                  f"{k} {h[k]:.5g}" for k in keys), flush=True)
    if not all(np.isfinite(h[k]) for h in hist
               for k in keys + ["grad_norm"]):
        raise AssertionError("a loss or the gradient norm is not finite")
    n_fwd, n_bwd = _train_calls(model)
    _check_counts(counts, {fwd_name: n_fwd * steps, bwd_name: n_bwd * steps},
                  f"{what}, {steps} steps")
    init = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    init.init_weights(torch.Generator().manual_seed(0))
    if load_from:
        init.load_state_dict(load_mmdet_checkpoint(load_from))
    start = dict(init.named_parameters())
    # the trainable tensors without a gradient in any step: exactly those
    # upstream of a backbone's gradient stop (HRNet's conv2/bn2 after
    # layer1, Res2Net's deep stem after the max-pool, the RFP copy's stem
    # and layer1), which weight decay and momentum alone move, as in the
    # JAX step; none in other models
    names = {id(p): n for n, p in model.named_parameters()}
    no_grad = {names[id(p)] for p, seen in zip(params, grad_seen[0])
               if not seen}
    behind_stop = {f"{prefix}.{n}" for prefix, m in model.named_modules()
                   for n, p in m.named_parameters()
                   if getattr(m, "behind_stop", ()) and p.requires_grad
                   and n.split(".")[0] in m.behind_stop}
    # the bias of the non-local block's phi, and of a context block's
    # pooling conv, shifts every logit of a softmax row alike: its
    # gradient is 0 but for float noise
    noise_only = {n for n in names.values()
                  if n.endswith(("refine.phi.conv.bias", "conv_mask.bias"))}
    # an attention block without the query-key term (GRoIE's type 0100)
    # has the query conv the JAX block has, and reads it nowhere: weight
    # decay and momentum alone move it, as in the JAX step
    from bonai_tpu_torch.ops.layers import GeneralizedAttention
    unused = {f"{n}.query_conv.weight" for n, m in model.named_modules()
              if isinstance(m, GeneralizedAttention)
              and hasattr(m, "query_conv") and not m.terms[0]}
    print(f"{what}: trainable tensors without a gradient in any step: "
          f"{sorted(no_grad) or 'none'}", flush=True)
    if not behind_stop | unused <= no_grad <= behind_stop | noise_only \
            | unused:
        raise AssertionError(f"trainable tensors without a gradient in any "
                             f"step: {sorted(no_grad)}, expected "
                             f"{sorted(behind_stop | unused)} (and maybe "
                             f"{sorted(noise_only)})")
    moved = frozen_moved = trainable = 0
    held = []
    for name, p in model.named_parameters():
        changed = not torch.equal(p.detach().cpu(), start[name].detach())
        if not p.requires_grad:
            frozen_moved += changed
            continue
        trainable += 1
        # weight decay alone scales a bias without a gradient (bn2's, or
        # phi's), 0 at the start, by 0
        if name in no_grad and name.endswith("bias") \
                and not start[name].any():
            moved += not changed
            held.append(name)
        else:
            moved += changed
    print(f"{what}: {moved} of {trainable} trainable parameter tensors "
          f"moved, or held at 0 without a gradient: {held or 'none'}; "
          f"{frozen_moved} frozen ones moved", flush=True)
    if moved != trainable or frozen_moved:
        stuck = [n for n, p in model.named_parameters() if p.requires_grad
                 and n not in held and torch.equal(p.detach().cpu(),
                                                   start[n].detach())]
        raise AssertionError(f"the trainable weights did not all move "
                             f"({stuck[:8]}, or {held} moved), or a frozen "
                             f"one did")
    out = {"fwd": counts[fwd_name], "bwd": counts[bwd_name],
           "step_ms": statistics.median(step_ms[1:]),
           "peak_gib": peak / 2 ** 30}
    if keep:
        from bonai_tpu_torch.engine import latest_checkpoint
        out.update(checkpoint=latest_checkpoint(work_dir), work_dir=work_dir)
    else:
        shutil.rmtree(work_dir, ignore_errors=True)

    _roi_grad_check(model, impl, what)
    return out


def _synth_config(test=False):
    """The 2x synthetic recipe with its train data in ``DATA_DIR`` (and
    with ``test``, its test data the eval phase's val crops)."""
    from bonai_tpu_torch.config import Config
    cfg = Config.fromfile(SYNTH_CONFIG)
    train = cfg.data.train
    train.ann_file = os.path.join(DATA_DIR, "train", "train.json")
    train.img_prefix = os.path.join(DATA_DIR, "train", "images") + "/"
    train.pipeline[0].cache_dir = os.path.join(DATA_DIR, "imgcache_train")
    if test:
        cfg.data.test.ann_file = os.path.join(DATA_DIR, "val", "val.json")
        cfg.data.test.img_prefix = os.path.join(DATA_DIR, "val",
                                                "images") + "/"
    return cfg


def _loader_rates(cfg, mode):
    """Images per second of two passes of the config's loader in ``mode``
    (one loader: the process mode's workers start in the first pass)."""
    from bonai_tpu_torch.apis.train import build_train_loader
    cfg.data.loader_mode = mode
    loader = build_train_loader(cfg)
    rates = []
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            n = sum(len(metas) for _, metas in loader)
            rates.append(n / (time.perf_counter() - t0))
        return rates, n
    finally:
        loader.close()
        del cfg.data["loader_mode"]


def data_phase(steps=6, tiles=8):
    """Training from files: generate, load, train ``steps`` steps of the
    synthetic recipe through ``train_detector(cfg, None, ...)``.  Returns
    the forward and backward kernels' launch counts, the median warm step
    time and the loader's rates."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import train_detector
    from bonai_tpu_torch.models.builder import build_detector
    from bonai_tpu_torch.tools.make_synthetic_bonai import write_split
    _, fwd_name, bwd_name = ROUTES["block"]

    shutil.rmtree(DATA_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    write_split(DATA_DIR, "train", tiles, 0, SIZE)
    gen_s = (time.perf_counter() - t0) / tiles
    cfg = _synth_config()
    (cold, warm), n = _loader_rates(cfg, "thread")
    (start, warm_process), _ = _loader_rates(cfg, "process")
    print(f"data: generator {gen_s:.3f} s per 1024^2 tile ({tiles} tiles, "
          f"seed 0); loader ({cfg.data.workers_per_gpu} workers, batch "
          f"{cfg.data.samples_per_gpu}, {n} images a pass) thread mode "
          f"{cold:.1f} images/s cold (PNG decode), {warm:.1f} warm (cache); "
          f"process mode {start:.1f} while its workers start, "
          f"{warm_process:.1f} warm", flush=True)

    work_dir = os.path.join(REPO, "build", "chip_smoke_files")
    shutil.rmtree(work_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.time()
    model, hist = train_detector(cfg, None, work_dir, seed=0,
                                 max_steps=steps, log_interval=1,
                                 n_devices=1)
    torch.cuda.synchronize()
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    wall = time.time() - t0
    step_ms = [h["time"] * 1e3 for h in hist]
    wait_ms = [h["data_time"] * 1e3 for h in hist]
    median = statistics.median(step_ms[1:])
    print(f"data: train_detector from files, {SYNTH_CONFIG[len(REPO) + 1:]} "
          f"1024^2 B={cfg.data.samples_per_gpu} bf16 autocast, "
          f"frozen_stages={cfg.model.backbone.frozen_stages}, {steps} steps "
          f"in {wall:.1f} s incl. set-up and the final checkpoint; ms per "
          f"step {[round(x, 1) for x in step_ms]}; median of the "
          f"{len(step_ms) - 1} warm steps {median:.1f} ms; host wait for the "
          f"next batch, ms per step {[round(x, 1) for x in wait_ms]} (median "
          f"of the warm steps {statistics.median(wait_ms[1:]):.1f}); peak "
          f"memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated); "
          f"launches {counts}", flush=True)
    keys = [k for k in hist[0] if k.split(".")[-1].startswith("loss")]
    for h in hist:
        print(f"data: step {h['iter']} lr {h['lr']:.3g} grad_norm "
              f"{h['grad_norm']:.4g} " + " ".join(
                  f"{k} {h[k]:.5g}" for k in keys), flush=True)
    if not all(np.isfinite(h[k]) for h in hist
               for k in keys + ["grad_norm"]):
        raise AssertionError("a loss or the gradient norm is not finite")
    _check_counts(counts, {fwd_name: 3 * steps, bwd_name: 3 * steps},
                  f"train from files, {steps} steps")
    init = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    init.init_weights(torch.Generator().manual_seed(0))
    start = init.state_dict()
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    moved, still, stats_moved = [], [], []
    for name, v in model.state_dict().items():
        changed = not torch.equal(v.cpu(), start[name])
        if name.endswith(("running_mean", "running_var")):
            if changed:
                stats_moved.append(name)
        elif name in trainable:
            (moved if changed else still).append(name)
    print(f"data: {len(moved)} of {len(trainable)} trainable tensors moved "
          f"(stem and layer1 included: "
          f"{'backbone.conv1.weight' in moved and 'backbone.layer1.0.conv1.weight' in moved}"
          f"), {len(stats_moved)} BatchNorm statistics moved", flush=True)
    if still or stats_moved or len(trainable) != len(
            list(model.parameters())):
        raise AssertionError(f"not moved: {still[:4]}; BatchNorm statistics "
                             f"moved: {stats_moved[:4]}")
    from bonai_tpu_torch.engine import latest_checkpoint
    return {"fwd": counts[fwd_name], "bwd": counts[bwd_name],
            "step_ms": median, "cold": cold, "warm": warm,
            "checkpoint": latest_checkpoint(work_dir), "work_dir": work_dir}


def _planted_pkl(ann_file, path):
    """A results pkl built from a crop json itself: per image its roofs
    filled into full-size masks (RLE), its roof boxes with score 1 and its
    GT offsets."""
    import pickle
    import numpy as np
    from bonai_tpu_torch.datasets import mask_utils
    with open(ann_file) as f:
        ds = json.load(f)
    results, names = [], []
    for im in ds["images"]:
        anns = [a for a in ds["annotations"] if a["image_id"] == im["id"]]
        dets = np.array([[a["bbox"][0], a["bbox"][1],
                          a["bbox"][0] + a["bbox"][2],
                          a["bbox"][1] + a["bbox"][3], 1.0] for a in anns],
                        np.float32).reshape(-1, 5)
        rles = [mask_utils.encode_mask(mask_utils.poly_to_mask(
            a["segmentation"], im["height"], im["width"])) for a in anns]
        offsets = np.array([a["offset"] for a in anns],
                           np.float32).reshape(-1, 2)
        results.append(([dets], [rles], offsets))
        names.append(im["file_name"])
    with open(path, "wb") as f:
        pickle.dump(dict(results=results, filenames=names), f)


def _top_thr(results, n=EVAL_TOP):
    """The score of the ``n``-th best detection of ``results`` (class 0,
    over all images): ``--score-thr`` for the evaluation CLI to score the
    best ``n`` (and any tied with the last)."""
    import numpy as np
    scores = np.sort(np.concatenate([r[0][0][:, 4] for r in results]))[::-1]
    return float(scores[min(n, len(scores)) - 1])


def _scores(summary):
    """The evaluation CLI's summary must hold finite P/R/F1 within [0, 1]
    and a finite aEPE (-1 when nothing matched)."""
    import math
    for name in ("roof", "footprint"):
        for k in ("precision", "recall", "f1"):
            v = summary[f"{name}_{k}"]
            if not (math.isfinite(v) and 0.0 <= v <= 1.0):
                raise AssertionError(f"{name}_{k} = {v}")
    if not math.isfinite(summary["aEPE"]):
        raise AssertionError(f"aEPE = {summary['aEPE']}")
    return (f"roof P/R/F1 {summary['roof_precision']:.4f}/"
            f"{summary['roof_recall']:.4f}/{summary['roof_f1']:.4f} (TP/FP/FN "
            f"{summary['roof_tp']}/{summary['roof_fp']}/"
            f"{summary['roof_fn']}), "
            f"footprint {summary['footprint_precision']:.4f}/"
            f"{summary['footprint_recall']:.4f}/{summary['footprint_f1']:.4f} "
            f"({summary['footprint_tp']}/{summary['footprint_fp']}/"
            f"{summary['footprint_fn']}), aEPE {summary['aEPE']:.4f} px "
            f"({summary['matched']} matched)")


def eval_phase(checkpoint, work_dir):
    """Test and score the data phase's checkpoint: the first val scene of
    the acceptance set (seed 77, 2048^2, four 1024^2 crops) through the
    test CLI on the card, then the evaluation CLI per crop and merged, and
    the planted check.  Removes ``work_dir`` (the checkpoint's) at the end.
    Returns B1's launches in the test CLI's run and the CLI's results."""
    import pickle
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import init_detector, run_inference
    from bonai_tpu_torch.datasets import build_dataloader, build_dataset
    from bonai_tpu_torch.evaluation import results_to_csv_records
    from bonai_tpu_torch.tools import bonai_evaluation, bonai_test
    from bonai_tpu_torch.tools.make_synthetic_bonai import write_scene_split
    _, fwd_name, _ = ROUTES["block"]

    t0 = time.perf_counter()
    write_scene_split(DATA_DIR, "val", 1, 77, scene_size=2048, crop=SIZE)
    gen_s = time.perf_counter() - t0
    crops = os.path.join(DATA_DIR, "val", "val.json")
    scenes = os.path.join(DATA_DIR, "val_originals", "val_originals.json")
    cfg = _synth_config(test=True)
    out_dir = os.path.join(REPO, "build", "chip_smoke_eval")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    cfg_path = os.path.join(out_dir, os.path.basename(SYNTH_CONFIG))
    cfg.dump(cfg_path)
    pkl = os.path.join(out_dir, "results.pkl")

    # the 6-step weights leave about 1750 detections a crop at or above
    # 0.4 (chip_smoke, PR 7): tracing and overlaying them takes about 30 s
    # a crop on the host, so the test CLI runs and scores one crop
    _zero_counts()
    t0 = time.perf_counter()
    payload = bonai_test.main([cfg_path, checkpoint, "--out", pkl,
                               "--city", "config", "--max-images",
                               str(SCORED_CROPS)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = _counts()
    results, names = payload["results"], payload["filenames"]
    batch = cfg.data.samples_per_gpu
    batches = -(-SCORED_CROPS // batch)
    if len(results) != SCORED_CROPS or len(names) != 4:
        raise AssertionError(f"test CLI: {len(results)} results, "
                             f"{len(names)} file names")
    _check_counts(counts, {fwd_name: 3 * batches},
                  f"test CLI, {SCORED_CROPS} of {len(names)} tiles in "
                  f"{batches} batch(es)")
    for res in results:
        boxes, masks, offsets = res[0][0], res[1][0], res[2]
        if not (boxes.shape[1:] == (5,) and len(masks) == len(boxes)
                == len(offsets) and np.isfinite(boxes).all()
                and np.isfinite(offsets).all()
                and all(m["size"] == [SIZE, SIZE] for m in masks)):
            raise AssertionError("the test CLI's results are malformed")
    score_thr = 0.4
    n_dets = [len(r[0][0]) for r in results]
    n_above = sum(int((r[0][0][:, 4] >= score_thr).sum()) for r in results)

    # warm: the model and the loader again, run_inference timed alone
    model = init_detector(cfg, checkpoint, dtype=torch.bfloat16)
    loader = build_dataloader(build_dataset(dict(cfg.data.test,
                                                 test_mode=True)),
                              samples_per_gpu=batch, shuffle=False,
                              train=False)
    t0 = time.perf_counter()
    run_inference(model, loader, progress=False)
    torch.cuda.synchronize()
    infer_ms = (time.perf_counter() - t0) * 1e3 / len(names)
    loader.close()
    del model
    t0 = time.perf_counter()
    records = results_to_csv_records(results, names, score_thr=score_thr)
    records_s = time.perf_counter() - t0
    print(f"eval: generator {gen_s:.1f} s for 1 val scene (seed 77, 2048^2, "
          f"{len(names)} crops); test CLI {cli_s:.1f} s (model build, "
          f"--max-images {SCORED_CROPS}: {batches} batch of {batch}, bf16); "
          f"launches {counts}", flush=True)
    print(f"eval: detections at or above score_thr {score_thr}: {n_above} "
          f"(of {sum(n_dets)} on the {SCORED_CROPS} scored crop(s))",
          flush=True)
    print(f"eval: inference {infer_ms:.1f} ms per 1024^2 tile "
          f"(run_inference warm over the {len(names)} crops: loader, "
          f"simple_test, paste + RLE)", flush=True)
    print(f"eval: pkl -> records {records_s:.2f} s "
          f"({sum(map(len, records.values()))} records)", flush=True)

    t0 = time.perf_counter()
    summary = bonai_evaluation.main([pkl, "--gt-json", crops])
    eval_s = time.perf_counter() - t0
    print(f"eval: per crop: {_scores(summary)}; evaluation CLI "
          f"{eval_s:.2f} s (F1 about {eval_s - records_s:.2f} s of it)",
          flush=True)
    thr = _top_thr(results)
    t0 = time.perf_counter()
    summary = bonai_evaluation.main([pkl, "--merge", "--gt-json", scenes,
                                     "--score-thr", str(thr)])
    print(f"eval: merged, the best {EVAL_TOP} detections (score_thr "
          f"{thr:.4f}): {_scores(summary)}; evaluation CLI "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    planted = os.path.join(out_dir, "planted.pkl")
    _planted_pkl(crops, planted)
    summary = bonai_evaluation.main([planted, "--gt-json", crops])
    got = {name: tuple(summary[f"{name}_{k}"] for k in ("tp", "fp", "fn"))
           for name in ("roof", "footprint")}
    print(f"eval: planted (the crop json's own roofs): {_scores(summary)}",
          flush=True)
    if got != PLANTED or summary["aEPE"] != 0.0:
        raise AssertionError(f"planted check: {got}, aEPE {summary['aEPE']}"
                             f", expected {PLANTED}, aEPE 0")
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(work_dir, ignore_errors=True)
    return counts[fwd_name], results


RESUME_STEPS = 6        # 4 steps an epoch over the data phase's 8 tiles
RESUME_LOG = 4          # the watchdog checks at the first epoch's end


def _start(argv, log, env=None):
    """``argv`` started from the repo's root in a session of its own, its
    standard output and error going to ``log`` + ``.out`` / ``.err`` (two
    commands at once cannot block each other on a full pipe)."""
    with open(log + ".out", "w") as out, open(log + ".err", "w") as err:
        proc = subprocess.Popen(argv, cwd=REPO, stdout=out, stderr=err,
                                env=dict(os.environ, **(env or {})),
                                start_new_session=True)
    proc.log, proc.t0 = log, time.perf_counter()
    return proc


def _finish(procs, what):
    """Wait for every process of ``procs`` (of :func:`_start`); if waiting
    fails or one exits non-zero, kill the others with all they started.
    Returns each one's ``CompletedProcess`` and its seconds from start to
    exit."""
    ends = {}
    try:
        while len(ends) < len(procs):
            for i, p in enumerate(procs):
                if i not in ends and p.poll() is not None:
                    ends[i] = time.perf_counter() - p.t0
                    if p.returncode:
                        raise AssertionError(f"{what}: {p.args[:4]} exited "
                                             f"{p.returncode}:\n"
                                             + _tail(p.log, 3000))
            time.sleep(0.1)
    finally:
        _kill(procs)
    done = []
    for i, p in enumerate(procs):
        with open(p.log + ".out") as out, open(p.log + ".err") as err:
            done.append((subprocess.CompletedProcess(
                p.args, p.returncode, out.read(), err.read()), ends[i]))
    return done


def _tail(log, n):
    with open(log + ".out") as out, open(log + ".err") as err:
        return f"{out.read()[-n:]}\n{err.read()[-n:]}"


def _kill(procs):
    """SIGKILL each process of :func:`_start` still running, and every
    process of its session (the ranks and loader workers it spawned)."""
    import signal
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()


def _train_cli(module, work_dir, cfg_path, *args, env=None):
    """``python -m bonai_tpu_torch.tools.<module>`` to ``RESUME_STEPS`` steps
    in one process, on one card of any host (``train_chunked`` takes the
    work dir as its second argument), started by :func:`_start` with its
    log beside ``work_dir``."""
    where = [work_dir] if module == "train_chunked" else ["--work-dir",
                                                          work_dir]
    return _start(
        [sys.executable, "-m", f"bonai_tpu_torch.tools.{module}", cfg_path,
         *where, "--max-steps", str(RESUME_STEPS), "--n-devices", "1",
         *args], work_dir, env)


def _run_end(proc, work_dir):
    """The run's log rows, final checkpoint and summed kernel launches (one
    ``kernel launches`` log line per process)."""
    import torch
    from bonai_tpu_torch.engine import latest_checkpoint
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    ckpt = torch.load(latest_checkpoint(work_dir), map_location="cpu",
                      weights_only=True)
    launches = {}
    for line in proc.stderr.splitlines():
        if "kernel launches " in line:
            for k, v in json.loads(line.split("kernel launches ")[1]).items():
                launches[k] = launches.get(k, 0) + v
    return rows, ckpt, launches


def _max_diff(a, b):
    return max(float((x.float() - b["state_dict"][k].float()).abs().max())
               for k, x in a["state_dict"].items())


def resume_phase():
    """Chunked training through the watchdog: ``train_chunked`` with
    ``BONAI_MAX_RSS_GB`` below any process's RSS trains the 2x synthetic
    recipe on the data phase's 8 tiles in process loader mode; the run
    checkpoints and exits 75 at step 4 (the first epoch's end, its first
    log row), the wrapper resumes it once and it ends at step 6.  Its
    logged losses and final weights must equal an unbroken run's of the
    same steps: both run under ``--deterministic``, so to the bit.  The
    two runs share the card at the same time (their times are not a
    single run's).  Returns the summed kernel launches of the chunked
    run."""
    cfg = _synth_config()
    cfg.data.loader_mode = "process"
    cfg.log_config.interval = RESUME_LOG
    out = os.path.join(REPO, "build", "chip_smoke_resume")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    cfg_path = os.path.join(out, os.path.basename(SYNTH_CONFIG))
    cfg.dump(cfg_path)
    whole_dir, chunked_dir = (os.path.join(out, d)
                              for d in ("unbroken", "chunked"))
    (whole, whole_s), (chunked, chunked_s) = _finish([
        _train_cli("train", whole_dir, cfg_path, "--deterministic",
                   "--options", "log_config.interval=1"),
        _train_cli("train_chunked", chunked_dir, cfg_path, "--deterministic",
                   env={"BONAI_MAX_RSS_GB": "0.001"})], "resume")
    lines = chunked.stdout.splitlines()
    restarts = sum("RSS-limit restart (rc=75)" in x for x in lines)
    if restarts != 1 or lines[-1] != "[train_chunked] complete":
        raise AssertionError(f"train_chunked: {restarts} restarts, last line "
                             f"{lines[-1]!r}")
    rows_w, ckpt_w, _ = _run_end(whole, whole_dir)
    rows_c, ckpt_c, launches = _run_end(chunked, chunked_dir)
    import torch
    preempt = torch.load(os.path.join(chunked_dir, "checkpoints",
                                      f"step_{RESUME_LOG}.pth"),
                         map_location="cpu", weights_only=True)["meta"]
    print(f"resume: train_chunked, {RESUME_STEPS} steps of "
          f"{SYNTH_CONFIG[len(REPO) + 1:]} (process loader, "
          f"--deterministic), BONAI_MAX_RSS_GB=0.001: exit 75 at step "
          f"{preempt['step']} (the end of epoch {preempt['epoch']}), "
          f"{restarts} restart, complete at step {ckpt_c['step']} in "
          f"{chunked_s:.1f} s; unbroken run {whole_s:.1f} s, at the same "
          f"time on the same card; launches {launches}", flush=True)
    print(f"resume: host_rss_gb of the unbroken run at step "
          f"{rows_w[0]['iter']} (start) {rows_w[0]['host_rss_gb']}, at step "
          f"{rows_w[-1]['iter']} (end) {rows_w[-1]['host_rss_gb']}; the "
          f"chunked run's first process at step {rows_c[0]['iter']} "
          f"{rows_c[0]['host_rss_gb']} (preempt_rss "
          f"{preempt['preempt_rss']:.3f})", flush=True)
    keys = [k for k in rows_c[0] if k.startswith("loss")]
    same = {r["iter"]: r for r in rows_w}
    for rc in rows_c:
        rw = same[rc["iter"]]
        print(f"resume: step {rc['iter']} unbroken / chunked " + " ".join(
            f"{k} {rw[k]:.4f}/{rc[k]:.4f}" for k in keys), flush=True)
    diff = _max_diff(ckpt_c, ckpt_w)
    print(f"resume: final weights, chunked vs unbroken: max abs diff {diff!r}"
          f" over {len(ckpt_w['state_dict'])} tensors", flush=True)
    if ([r["iter"] for r in rows_c] != [RESUME_LOG]
            or any(rc[k] != same[rc["iter"]][k] for rc in rows_c
                   for k in keys) or diff != 0.0
            or not ckpt_c["step"] == ckpt_w["step"] == RESUME_STEPS):
        raise AssertionError("the chunked run differs from the unbroken one")
    shutil.rmtree(out, ignore_errors=True)
    return launches


DDP_STEPS = 4           # the CLI run of the ddp phase


def _rehearsal_config():
    """The full-width LOFT-FOA config of the serve and train phases in
    float32 (no autocast) at a constant LR, so that each tensor's update
    stands far above its float32 rounding."""
    cfg = _config("block")
    cfg.compute_dtype = "float32"
    cfg.lr_config = dict(policy="step", warmup=None, step=[])
    return cfg


def _by_kernel(launches):
    """Wrapper launch counts (``ops.launch_counts()``) by the kernel names
    of ``_kernels``."""
    return {name: launches.get(fn.__name__, 0)
            for name, (fn, _, _) in _kernels().items()}


def _sharded_test_rank(cfg, checkpoint, out):
    """A rank of the ddp phase's sharded test: the checkpoint in bfloat16
    on this rank's card and its eval shard through ``run_inference``; rank
    0 writes the merged results, and every rank's time and kernel
    launches, to ``out``."""
    import pickle
    import torch
    from bonai_tpu_torch import parallel
    from bonai_tpu_torch.apis import init_detector, run_inference
    from bonai_tpu_torch.datasets import build_dataloader, build_dataset
    from bonai_tpu_torch.ops import launch_counts
    rank, world_size = parallel.world()
    model = init_detector(cfg, checkpoint, dtype=torch.bfloat16)
    loader = build_dataloader(
        build_dataset(dict(cfg.data.test, test_mode=True)),
        samples_per_gpu=cfg.data.samples_per_gpu, shuffle=False,
        train=False, shard_id=rank, num_shards=world_size)
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_inference(model, loader, progress=False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    ranks = parallel.gather_objects((ms, launched))
    loader.close()
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(dict(results=results, ranks=ranks), f)


# the train CLI as every rank of a process group of N cards (NCCL), so that
# it runs under DDP even on one card
CLI_RANKS = ("import sys; from bonai_tpu_torch import parallel; "
             "from bonai_tpu_torch.tools.train import main; "
             "sys.exit(parallel.launch(main, int(sys.argv[1]), 'cuda', "
             "sys.argv[3:], work_dir=sys.argv[2]))")


def ddp_phase(card, files_step_ms):
    """Data parallelism through ``bonai_tpu_torch.parallel.launch``:

    (a) the rehearsal: two gloo ranks on one card (NCCL refuses two ranks
    on one device), each one step of the full-width LOFT-FOA config on
    its image of the synthetic batch, float32, deterministic; the updated
    weights must equal a one-process step whose gradient is the mean of
    the two half-batch gradients, with the same draws, within 1e-4 of each
    tensor's largest update;
    (b) the CLI: ``tools/train.py``'s ``main`` with ``--n-devices
    device_count()`` in each rank of a NCCL group of one rank per card
    (under DDP even for one card) trains ``DDP_STEPS`` steps of the 2x synthetic recipe
    from the data phase's tiles, and ``run_inference`` over the eval
    phase's four crops is sharded over the same number of ranks.

    The CLI runs while the rehearsal does, on the same card (their times
    are not a single run's).  Every rank must launch B1 and B2 3 times a
    step (B1 3 times a test batch).  Returns the launch counts per rank of
    each run."""
    import pickle
    import numpy as np
    import torch
    from bonai_tpu_torch import parallel
    from bonai_tpu_torch.apis.train import rank_launches
    from bonai_tpu_torch.engine import latest_checkpoint
    from bonai_tpu_torch.parallel.rehearsal import rehearse
    from bonai_tpu_torch.tools.profile_train import synthetic_batch
    _, fwd_name, bwd_name = ROUTES["block"]
    out = os.path.join(REPO, "build", "chip_smoke_ddp")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)

    # (b) the CLI over every card, started first to run beside (a)
    n = torch.cuda.device_count()
    cfg = _synth_config(test=True)
    cfg_path = os.path.join(out, os.path.basename(SYNTH_CONFIG))
    cfg.dump(cfg_path)
    work_dir = os.path.join(out, "wd")
    cli = _start([sys.executable, "-c", CLI_RANKS, str(n), out, cfg_path,
                  "--work-dir", work_dir, "--n-devices", str(n),
                  "--max-steps", str(DDP_STEPS), "--options",
                  "log_config.interval=1"], os.path.join(out, "cli"))

    # (a) two gloo ranks on one card against the mean of the halves
    try:
        report = rehearse(_rehearsal_config(), synthetic_batch(),
                          os.path.join(out, "rehearsal"), timeout=600)
    except BaseException:
        _kill([cli])
        raise
    ranks = report["ranks"]
    counts = [_by_kernel(r["counts"]) for r in ranks]
    for r, c in enumerate(counts):
        _check_counts(c, {fwd_name: 3, bwd_name: 3},
                      f"ddp rehearsal rank {r}, 1 step")
    m = ranks[0]["metrics"]
    print(f"ddp: rehearsal, 2 gloo ranks on one card ({card}), "
          f"{os.path.basename(CONFIG)} full width float32, one image each: "
          f"launch to exit {report['launch_s']:.1f} s, step ms per rank "
          f"{[round(r['ms'], 1) for r in ranks]} (first step, cold; not a "
          f"scaling figure: both ranks share the card with the CLI run); "
          f"loss {m['loss']:.5g} grad_norm {m['grad_norm']:.5g}; weights "
          f"vs the mean-of-halves "
          f"step: largest diff {report['worst']:.3g} of a tensor's largest "
          f"update ({report['moved']} of {report['tensors']} tensors "
          f"moved); launches per rank {counts}", flush=True)

    # (b) the CLI's end, then sharded testing
    (proc, cli_s), = _finish([cli], f"train --n-devices {n}")
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    cli_counts = [_by_kernel(c) for c in rank_launches(proc.stderr)]
    if len(cli_counts) != n or [r["iter"] for r in rows] != list(
            range(1, DDP_STEPS + 1)):
        raise AssertionError(f"train --n-devices {n}: launches of "
                             f"{len(cli_counts)} ranks, rows "
                             f"{[r['iter'] for r in rows]}")
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in rows):
        raise AssertionError("train --n-devices: a loss is not finite")
    for r, c in enumerate(cli_counts):
        _check_counts(c, {fwd_name: 3 * DDP_STEPS, bwd_name: 3 * DDP_STEPS},
                      f"train --n-devices {n}, rank {r}, {DDP_STEPS} steps")
    strides = proc.stderr.count("Grad strides do not match bucket view")
    step_ms = [r["time"] * 1e3 for r in rows]
    print(f"ddp: train --n-devices {n} (NCCL, one rank per card, "
          f"{card}), {DDP_STEPS} steps of the 2x synthetic recipe from "
          f"files, global batch {cfg.data.samples_per_gpu * n}: "
          f"{cli_s:.1f} s incl. start-up, beside the rehearsal; ms per step "
          f"{[round(x, 1) for x in step_ms]}, median of the warm steps "
          f"{statistics.median(step_ms[1:]):.1f} against "
          f"{files_step_ms:.1f} in the data phase (one process, no DDP); "
          f"losses {[r['loss'] for r in rows]}; 'grad strides do not match "
          f"bucket view' warnings: {strides}; launches per rank "
          f"{cli_counts}", flush=True)

    pkl = os.path.join(out, "sharded.pkl")
    t0 = time.perf_counter()
    rc = parallel.launch(_sharded_test_rank, n, "cuda", cfg,
                         latest_checkpoint(work_dir), pkl, work_dir=out,
                         timeout=600)
    if rc:
        raise AssertionError(f"the sharded test's ranks exited {rc}")
    infer_s = time.perf_counter() - t0
    with open(pkl, "rb") as f:
        got = pickle.load(f)
    results, infer = got["results"], got["ranks"]
    if len(results) != 4 or not all(
            np.isfinite(res[0][0]).all() and len(res[0][0]) == len(res[1][0])
            == len(res[2]) for res in results):
        raise AssertionError("sharded run_inference: malformed results")
    infer_counts = [_by_kernel(c) for _, c in infer]
    per_rank = -(-4 // n)
    batches = -(-per_rank // cfg.data.samples_per_gpu)
    for r, c in enumerate(infer_counts):
        _check_counts(c, {fwd_name: 3 * batches},
                      f"sharded run_inference, rank {r}")
    print(f"ddp: run_inference of the 4 val crops sharded over {n} rank(s) "
          f"({card}): {infer_s:.1f} s incl. start-up and model load; "
          f"run_inference ms per rank {[round(t, 1) for t, _ in infer]}; "
          f"detections per crop {[len(res[0][0]) for res in results]}; "
          f"launches per rank {infer_counts}", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return dict(rehearsal=counts, cli=cli_counts, test=infer_counts)


def loft_phase():
    """LOFT with the plain ``OffsetHead`` (``configs/loft/
    loft_r50_fpn_2x_bonai.py``) at full width with seeded random weights
    and the ``'block'`` route: serving (one batch, B=2, 1024^2, bf16, then
    ``inference_detector``; a small float32 input against the plain
    route), and 3 training steps on the repeated synthetic batch.  Returns
    the launch counts."""
    serve, _, _ = serve_phase("block", LOFT_CONFIG, calls=1,
                              label="loft serve")
    train = train_phase("block", 3, LOFT_CONFIG, label="loft train")
    return dict(serve=serve, train=train)


def _trunk_ms(models, reps=5):
    """Backbone + neck ms of a 1024^2 B=2 bfloat16 batch for each of
    ``models`` (label -> model), timed in turns (a, b, b, a), the median of
    ``reps`` synchronised calls each."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import prepare_batch
    r = np.random.RandomState(0)
    imgs = [r.randint(0, 256, (SIZE, SIZE, 3), np.uint8)
            for _ in range(BATCH)]
    times = {k: [] for k in models}
    order = list(models) + list(models)[::-1]
    with torch.inference_mode():
        for label in order:
            model = models[label]
            img = prepare_batch(model, imgs)[0].to(
                next(model.parameters()).dtype)
            model.extract_feat(img)
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.extract_feat(img)
                torch.cuda.synchronize()
                times[label].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


@contextlib.contextmanager
def _reproducible_convs():
    """cuDNN in float32 without TF32, its deterministic algorithms only:
    the same numbers in every run, whatever the process ran before."""
    import torch
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark
    cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = \
        False, True, False
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = saved


def _calibrated_weights(config, path, head=False):
    """Seeded random weights of ``config`` (``init_weights``, seed 0) with
    the stored statistics of every BatchNorm of the backbone and the neck
    (DetectoRS's backbone copy; SSD and CornerNet have no neck), and with
    ``head`` of the dense head (the SepBN head's per-level norms), set to
    those of its input on a random
    1024^2 B=2 batch (``_reproducible_convs``: the same statistics in
    every run), so that each one's output has unit variance, as a
    trained network's has.  With identity statistics
    HRNet's fuse sums grow from module to module, to head outputs of about
    5e8.  Saves them to ``path`` as an mmdet ``.pth``."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import init_detector, prepare_batch
    from bonai_tpu_torch.models.backbones.resnet import FrozenBatchNorm2d
    model = init_detector(_config("block", config), seed=0,
                          dtype=torch.float32)
    r = np.random.RandomState(0)
    img = prepare_batch(model, [r.randint(0, 256, (SIZE, SIZE, 3), np.uint8)
                                for _ in range(BATCH)])[0]

    def calibrate(bn, args):
        bn.running_mean.copy_(args[0].mean((0, 2, 3)))
        bn.running_var.copy_(args[0].var((0, 2, 3)))
    parts = (model.backbone, model.neck) + ((model.bbox_head,) if head
                                            else ())
    hooks = [m.register_forward_pre_hook(calibrate)
             for part in parts if part is not None
             for m in part.modules() if isinstance(m, FrozenBatchNorm2d)]
    with torch.no_grad(), _reproducible_convs():
        feats = model.extract_feat(img)
        if head:
            model.bbox_head(feats)
    for h in hooks:
        h.remove()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"state_dict": {k: v.cpu() for k, v in
                               model.state_dict().items()}}, path)
    print(f"calibrated the {len(hooks)} backbone, neck"
          f"{' and head' if head else ''} BatchNorms of "
          f"{os.path.basename(config)} on a random batch", flush=True)
    del model
    torch.cuda.empty_cache()


def hrnet_phase(r50_serve_ms, r50_step_ms):
    """LOFT-FOA on HRNet-W32 + HRFPN (``configs/hrnet/
    loft_foa_hrnetv2p_w32_2x_bonai.py``) at full width with seeded random
    weights (``_calibrated_weights``) and the ``'block'`` route: serving
    (one batch, B=2, 1024^2, bf16, then ``inference_detector``; a small
    float32 input against the plain route), 3 training steps on the
    repeated synthetic batch, and the backbone + neck time of a serve
    batch beside LOFT-FOA R50-FPN's (``r50_*``: the serve and train
    phases' numbers of this run).  Returns the launch counts."""
    import torch
    from bonai_tpu_torch.apis import init_detector
    weights = os.path.join(REPO, "build", "chip_smoke_hrnet", "init.pth")
    _calibrated_weights(HRNET_CONFIG, weights)
    serve, serve_ms, _ = serve_phase("block", HRNET_CONFIG, calls=1,
                                  label="hrnet serve", checkpoint=weights)
    # at the base LR: the warmup's first LRs (5e-6 to 2e-5) times the
    # weight decay (1e-4) move conv2/bn2 by less than a float32 ulp
    train = train_phase("block", 3, HRNET_CONFIG, label="hrnet train",
                        warmup=False, load_from=weights)
    shutil.rmtree(os.path.dirname(weights), ignore_errors=True)
    models = {"HRNet-W32 + HRFPN": init_detector(_config("block",
                                                         HRNET_CONFIG)),
              "R50 + FPN": init_detector(_config("block"))}
    trunk = _trunk_ms(models)
    del models
    torch.cuda.empty_cache()
    print(f"hrnet: serve {serve_ms:.1f} ms a B=2 call (LOFT-FOA R50-FPN "
          f"{r50_serve_ms:.1f} in this run); train median step "
          f"{train['step_ms']:.1f} ms (R50 {r50_step_ms:.1f}), peak "
          f"{train['peak_gib']:.2f} GiB; backbone + neck of a 1024^2 B=2 "
          f"bf16 batch " + ", ".join(f"{k} {v:.2f} ms"
                                      for k, v in trunk.items())
          + f"; B1 {serve} launches serving, B1 {train['fwd']} / B2 "
          f"{train['bwd']} training", flush=True)
    return dict(serve=serve, train=train)


def rcnn_phase():
    """The R-CNN baselines on BONAI (``RCNN_CONFIGS``: Mask R-CNN, Cascade
    Mask R-CNN, Dynamic R-CNN) at full width with seeded random weights and
    the ``'block'`` route: one serve batch (B=2, 1024^2, bf16) and one
    ``inference_detector`` call, a small float32 input held to the plain
    route, and training on the repeated synthetic batch (6 steps of Mask
    R-CNN, 3 of the others; the RoI branches' gradients held to the plain
    route).  Then the test and evaluation CLIs on the Mask R-CNN's 6-step
    checkpoint, on the first of the eval phase's val crops.  Returns each
    config's launch counts and times."""
    out = {}
    for label, config, steps in RCNN_CONFIGS:
        config = os.path.join(REPO, config)
        serve, serve_ms, _ = serve_phase("block", config, calls=1,
                                      label=f"{label} serve")
        train = train_phase("block", steps, config, label=f"{label} train",
                            keep=label in COCO_SCORED)
        out[label] = dict(serve=serve, serve_ms=serve_ms, train=train)
    for label, config, _ in RCNN_CONFIGS:
        if label in COCO_SCORED:
            out[label]["coco_cli"] = rcnn_coco(
                label, os.path.join(REPO, config),
                out[label]["train"]["checkpoint"])
    coco_planted(os.path.join(REPO, RCNN_CONFIGS[0][1]))
    shutil.rmtree(out["dynamic"]["train"]["work_dir"], ignore_errors=True)
    train = out["mask_rcnn"]["train"]
    out["mask_rcnn"]["test_cli"] = rcnn_eval(
        os.path.join(REPO, RCNN_CONFIGS[0][1]), train["checkpoint"],
        train["work_dir"])
    for label, r in out.items():
        print(f"rcnn {label}: serve {r['serve_ms']:.1f} ms a B=2 call, B1 "
              f"{r['serve']} launches; train median step "
              f"{r['train']['step_ms']:.1f} ms, peak "
              f"{r['train']['peak_gib']:.2f} GiB, B1 {r['train']['fwd']} / "
              f"B2 {r['train']['bwd']} launches", flush=True)
    return out


def _crop_test_cfg(config):
    """``config`` with the ``'block'`` route and the eval phase's four val
    crops as its test set."""
    cfg = _config("block", config)
    cfg.data.test.update(
        ann_file=os.path.join(DATA_DIR, "val", "val.json"),
        img_prefix=os.path.join(DATA_DIR, "val", "images") + "/")
    return cfg


def rcnn_coco(label, config, checkpoint, options=()):
    """COCO-style scoring of a checkpoint: the generic test CLI
    (``bonai_tpu_torch.tools.test``) on the card with ``--eval`` of
    ``COCO_SCORED[label]`` on the first of the eval phase's val crops (and
    the config overrides ``options``, ``key=value``).  Returns the forward
    kernel's launches in the run."""
    import math
    import torch
    from bonai_tpu_torch.config import Config
    from bonai_tpu_torch.datasets import build_dataset
    from bonai_tpu_torch.evaluation import evaluate_coco
    from bonai_tpu_torch.tools import test as test_cli
    _, fwd_name, _ = ROUTES["block"]
    kinds, calls = COCO_SCORED[label]
    out_dir = os.path.join(REPO, "build", "chip_smoke_coco")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    cfg_path = os.path.join(out_dir, os.path.basename(config))
    _crop_test_cfg(config).dump(cfg_path)
    _zero_counts()
    t0 = time.perf_counter()
    results, metrics = test_cli.main([
        cfg_path, checkpoint, "--out", os.path.join(out_dir, "r.pkl"),
        "--eval", *kinds, "--max-images", "1"]
        + (["--options", *options] if options else []))
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = _counts()
    _check_counts(counts, {fwd_name: calls}, f"{label} COCO test CLI, "
                  "1 batch")
    ds = build_dataset(dict(Config.fromfile(cfg_path).data.test,
                            test_mode=True))
    t0 = time.perf_counter()
    if evaluate_coco(ds, results, metric_types=kinds) != metrics:
        raise AssertionError(f"{label} COCO scoring is not repeatable")
    score_s = time.perf_counter() - t0
    keys = [f"{k}_mAP{s}" for k in kinds for s in ("", "_50", "_75")]
    if len(results) != 1 or list(metrics) != keys or not all(
            math.isfinite(v) and (0.0 <= v <= 1.0 or v == -1.0)
            for v in metrics.values()):
        raise AssertionError(f"{label} COCO scoring: {len(results)} results, "
                             f"metrics {metrics}")
    boxes = results[0][0] if isinstance(results[0], tuple) else results[0]
    print(f"{label} coco: tools.test --eval {' '.join(kinds)} on 1 of "
          f"4 val crops, {len(boxes[0])} detections, {cli_s:.1f} s (model "
          f"build, test, scoring; the scoring alone {score_s:.2f} s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
          + f"; launches {counts}", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    return counts[fwd_name]


def coco_planted(config):
    """The COCO planted check: the four val crops' own GTs as results
    (score 1, full-size RLE masks) must score ``bbox_mAP == segm_mAP ==
    1.0`` and VOC ``mAP == 1.0`` through ``CocoDataset.evaluate``."""
    import numpy as np
    from bonai_tpu_torch.datasets import build_dataset, mask_utils
    cfg = _crop_test_cfg(config)
    ds = build_dataset(dict(cfg.data.test, test_mode=True))
    results = []
    for i, info in enumerate(ds.data_infos):
        ann = ds.get_ann_info(i)
        dets = np.concatenate([ann["bboxes"], np.ones(
            (len(ann["bboxes"]), 1), np.float32)], 1)
        results.append(([dets], [[mask_utils.encode_mask(
            mask_utils.poly_to_mask(m, info["height"], info["width"]))
            for m in ann["masks"]]]))
    t0 = time.perf_counter()
    got = ds.evaluate(results, metric=["bbox", "segm", "mAP", "recall"])
    eval_s = time.perf_counter() - t0
    print(f"coco planted ({len(results)} crops, "
          f"{sum(len(r[0][0]) for r in results)} GTs): "
          + ", ".join(f"{k} {v:.4f}" for k, v in got.items())
          + f"; {eval_s:.2f} s", flush=True)
    if not got["bbox_mAP"] == got["segm_mAP"] == got["mAP"] == 1.0:
        raise AssertionError(f"COCO planted check: {got}")


def rcnn_eval(config, checkpoint, work_dir):
    """The test CLI on the card with ``config`` and ``checkpoint`` on the
    first of the eval phase's val crops (a 2-tuple pkl: boxes and roof
    masks, no offsets), then the evaluation CLI on it.  Removes
    ``work_dir`` (the checkpoint's) at the end.  Returns B1's launches in
    the test CLI's run."""
    import numpy as np
    import torch
    from bonai_tpu_torch.tools import bonai_evaluation, bonai_test
    _, fwd_name, _ = ROUTES["block"]
    cfg = _crop_test_cfg(config)
    crops = cfg.data.test.ann_file
    out_dir = os.path.join(REPO, "build", "chip_smoke_rcnn_eval")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    cfg_path = os.path.join(out_dir, os.path.basename(config))
    cfg.dump(cfg_path)
    pkl = os.path.join(out_dir, "results.pkl")
    _zero_counts()
    t0 = time.perf_counter()
    payload = bonai_test.main([cfg_path, checkpoint, "--out", pkl, "--city",
                               "config", "--max-images", "1"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = _counts()
    _check_counts(counts, {fwd_name: 2}, "rcnn test CLI, 1 batch")
    results = payload["results"]
    if len(results) != 1:
        raise AssertionError(f"rcnn test CLI: {len(results)} results")
    for res in results:
        if not (isinstance(res, tuple) and len(res) == 2
                and res[0][0].shape[1:] == (5,)
                and len(res[1][0]) == len(res[0][0])
                and np.isfinite(res[0][0]).all()
                and all(m["size"] == [SIZE, SIZE] for m in res[1][0])):
            raise AssertionError("the rcnn test CLI's results are not "
                                 "(bbox, segm) 2-tuples")
    thr = _top_thr(results)
    t0 = time.perf_counter()
    summary = bonai_evaluation.main([pkl, "--gt-json", crops,
                                     "--score-thr", str(thr)])
    eval_s = time.perf_counter() - t0
    print(f"rcnn mask_rcnn eval: test CLI {cli_s:.1f} s (model build, 1 of "
          f"{len(payload['filenames'])} crops, bf16), "
          f"{len(results[0][0][0])} detections; evaluation CLI of the best "
          f"{EVAL_TOP} (score_thr {thr:.4f}) {eval_s:.1f} s: "
          f"{_scores(summary)}; launches {counts}", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    return counts[fwd_name]


def _dh_reg_rois(model, img, img_shape, scale):
    """Double-Head's reg RoIs of a serve batch (its proposals scaled by
    ``reg_roi_scale_factor``, not clipped): how many reach past the tile,
    and the widest level footprint of any of them (``block_footprint``,
    the backward kernel's tile test: the samples clip to the level first)
    against the JAX block kernel's 40-cell window, past which it zeroes
    samples.  Returns the counts."""
    import torch
    from bonai_tpu_torch.models.detectors import two_stage
    from bonai_tpu_torch.models.roi_heads.bbox_head import scale_rois
    from bonai_tpu_torch.ops.roi_align_block import (block_footprint,
                                                     block_levels)
    with torch.inference_mode():
        feats = model.extract_feat(img.to(next(model.parameters()).dtype))
        props, _, valid = model._rpn_and_proposals(
            feats, img_shape, dict(model.test_cfg["rpn"]))
        rois, rvalid = two_stage.boxes_to_rois(props.float(), valid)
        rois = scale_rois(rois, model.reg_roi_scale_factor)[rvalid]
        ext = torch.maximum(rois[:, 3] - rois[:, 1], rois[:, 4] - rois[:, 2])
        lvl = block_levels(rois[:, 1:5], STRIDES)
        foot = block_footprint([f.shape for f in feats[:len(STRIDES)]],
                               rois, lvl, 7, STRIDES)
        span = torch.maximum(foot[:, 1] - foot[:, 0], foot[:, 3] - foot[:, 2])
    out = {"reg_rois": int(rois.shape[0]),
           "past_tile": int((ext > SIZE).sum()),
           "past_push": int((ext > STRIDES[-1] * 28).sum()),
           "max_extent_px": float(ext.max()),
           "max_footprint_cells": int(span.max()) + 1}
    print(f"double_head serve: {out['reg_rois']} reg RoIs (scaled 1.3), "
          f"{out['past_push']} wider than the block rule's push (28 cells "
          f"at stride 32), {out['past_tile']} wider than the {SIZE} px "
          f"tile, the widest {out['max_extent_px']:.1f} px; widest level "
          f"footprint {out['max_footprint_cells']} cells against the JAX "
          f"kernel's {JAX_BLOCK_CELLS}-cell window", flush=True)
    if out["max_footprint_cells"] > JAX_BLOCK_CELLS:
        print("double_head serve: a reg RoI's samples reach past the JAX "
              "block kernel's window", flush=True)
    return out


def rcnn2_phase():
    """The rest of the R-CNN family on BONAI (``RCNN2_CONFIGS``: Libra,
    Double-Head and Mask Scoring R-CNN, the RPN-only detector, Fast R-CNN)
    at full width with seeded random weights and the ``'block'`` route, as
    the rcnn phase runs its configs: one serve batch and one
    ``inference_detector`` call (Fast R-CNN's on 2000 synthetic proposals
    an image), the small float32 input held to the plain route, and
    ``RCNN2_STEPS`` training steps on the repeated synthetic batch (the RoI
    branches' gradients held to the plain route).  Libra trains at the
    base LR: its non-local block's ``conv_out`` starts at zero, so its
    ``theta``/``phi``/``g`` get their first gradient in step 2, which the
    warmup's LRs would leave under a float32 ulp.  Then the file chain
    (:func:`rcnn2_files`) and the Mask Scoring checkpoint through the
    test CLI with ``--eval bbox segm``.  Returns each config's launch
    counts and times."""
    out = {}
    for label, config, calls in RCNN2_CONFIGS:
        config = os.path.join(REPO, config)
        window = {}
        serve, serve_ms, _ = serve_phase(
            "block", config, calls=1, label=f"{label} serve",
            inspect=(lambda *a: window.update(_dh_reg_rois(*a)))
            if label == "double_head" else None)
        train = train_phase("block", RCNN2_STEPS, config,
                            label=f"{label} train",
                            keep=label in ("rpn", "mask_scoring"),
                            warmup=label != "libra")
        if serve != 2 * calls or not (
                train["fwd"] == train["bwd"] == RCNN2_STEPS * calls):
            raise AssertionError(f"{label}: B1 {serve} launches serving, "
                                 f"{train['fwd']} / B2 {train['bwd']} "
                                 f"training; expected {calls} a batch or "
                                 f"step")
        out[label] = dict(serve=serve, serve_ms=serve_ms, train=train,
                          window=window)
    out["mask_scoring"]["coco_cli"] = rcnn_coco(
        "mask_scoring", os.path.join(REPO, RCNN2_CONFIGS[2][1]),
        out["mask_scoring"]["train"]["checkpoint"])
    shutil.rmtree(out["mask_scoring"]["train"]["work_dir"],
                  ignore_errors=True)
    out["files"] = rcnn2_files(out["rpn"]["train"]["checkpoint"])
    shutil.rmtree(out["rpn"]["train"]["work_dir"], ignore_errors=True)
    for label, r in out.items():
        if label == "files":
            continue
        print(f"rcnn2 {label}: serve {r['serve_ms']:.1f} ms a B=2 call, B1 "
              f"{r['serve']} launches; train median step "
              f"{r['train']['step_ms']:.1f} ms, peak "
              f"{r['train']['peak_gib']:.2f} GiB, B1 {r['train']['fwd']} / "
              f"B2 {r['train']['bwd']} launches", flush=True)
    return out


def rcnn3_phase():
    """Grid R-CNN and PointRend (``RCNN3_CONFIGS``) at full width with
    seeded random weights and the ``'block'`` route, as the rcnn phase runs
    its configs: one serve batch and one ``inference_detector`` call
    (PointRend's 224^2 masks pasted on the host), the small float32 input
    held to the plain route (Grid R-CNN's grid call at 14^2 among the
    branches), ``RCNN3_STEPS`` training steps on the repeated synthetic
    batch (the RoI branches' gradients held to the plain route, the grid
    call's on the jittered positives), then each checkpoint through the
    test CLI on the first val crop, scored COCO-style (Grid R-CNN ``--eval
    bbox``, PointRend ``--eval bbox segm``).  Grid R-CNN trains at the base
    LR: at the warmup's first LRs its GroupNorm weights, 1 at the start,
    and other grid-head tensors move by less than a float32 ulp in 3
    steps.  Returns each config's launch counts, times and peak
    memory."""
    out = {}
    for label, config, calls in RCNN3_CONFIGS:
        config = os.path.join(REPO, config)
        serve, serve_ms, serve_peak = serve_phase(
            "block", config, calls=1, label=f"{label} serve")
        train = train_phase("block", RCNN3_STEPS, config,
                            label=f"{label} train", keep=True,
                            warmup=label != "grid")
        if serve != 2 * calls or not (
                train["fwd"] == train["bwd"] == RCNN3_STEPS * calls):
            raise AssertionError(f"{label}: B1 {serve} launches serving, "
                                 f"{train['fwd']} / B2 {train['bwd']} "
                                 f"training; expected {calls} a batch or "
                                 f"step")
        coco = rcnn_coco(label, config, train["checkpoint"])
        shutil.rmtree(train["work_dir"], ignore_errors=True)
        out[label] = dict(serve=serve, serve_ms=serve_ms,
                          serve_peak_gib=serve_peak, train=train,
                          coco_cli=coco)
    for label, r in out.items():
        print(f"rcnn3 {label}: serve {r['serve_ms']:.1f} ms a B=2 call, peak "
              f"{r['serve_peak_gib']:.2f} GiB, B1 {r['serve']} launches; "
              f"train median step {r['train']['step_ms']:.1f} ms, peak "
              f"{r['train']['peak_gib']:.2f} GiB, B1 {r['train']['fwd']} / "
              f"B2 {r['train']['bwd']} launches; test CLI B1 "
              f"{r['coco_cli']} launches", flush=True)
    return out


def _trunk_cpu_check(model, what, r):
    """The FPN levels of a small float32 input (two 256x320 images) on the
    card, from the same weights as a float64 run on the CPU (float32
    where the port computes in float32: the sampling weights, the
    softmaxes and HTC's antialiased resize), with TF32 off: the
    backbone's deformable sampling, attention blocks and SAC convs and
    the RFP (plain PyTorch on both devices) inside, HTC's semantic
    embedding after them, and a Guided-Anchoring RPN's four outputs (its
    deformable feature adaption inside).  Each level must agree within 1e-4
    of its largest value, or within twice the float32 rounding that a
    float32 run on the CPU shows against the float64 one where that is
    larger (Res2Net with calibrated statistics: 9e-5 of the largest)."""
    import copy
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import prepare_batch
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model.float()
        cpu = copy.deepcopy(model).cpu().to(
            memory_format=torch.contiguous_format)
        small = [r.randint(0, 256, (256, 320, 3), np.uint8) for _ in range(2)]
        model.cfg.data.test.pipeline[1].img_scale = (320, 320)
        img = prepare_batch(model, small)[0]
        def outputs(m, x):
            feats = m.extract_feat(x)
            named = [(f"FPN level {i}", f) for i, f in enumerate(feats)]
            if hasattr(m, "semantic"):          # HTC's semantic embedding
                named.append(("semantic embedding", m.semantic(feats)[1]))
            if getattr(m, "ga_rpn", False):
                outs = m.rpn_head([f.permute(0, 3, 1, 2) for f in feats])
                named += [(f"GA-RPN {kind} level {i}", o) for kind, level in
                          zip(("logits", "deltas", "shapes", "location"),
                              outs) for i, o in enumerate(level)]
            return named
        with torch.inference_mode():
            got = outputs(model, img)
            cpu32 = outputs(cpu, img.cpu())
            want = outputs(cpu.double(), img.cpu().double())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    for (level, g), (_, c), (_, w) in zip(got, cpu32, want):
        err = float((g.cpu().double() - w).abs().max())
        noise = float((c.double() - w).abs().max())
        top = float(w.abs().max())
        print(f"{what}: small float32 input ({tuple(img.shape[1:3])}), "
              f"{level} on the card vs float64 on the CPU: max abs diff "
              f"{err:.3g} (float32 on the CPU {noise:.3g}; values up to "
              f"{top:.3g})", flush=True)
        if not err <= max(1e-4 * top, 2 * noise):
            raise AssertionError(f"{what}: {level} differs between the card "
                                 f"and the CPU by {err}")


def trunks_phase():
    """The R-CNN trunk variants (``TRUNK_CONFIGS``: the DCNv2, GCNet,
    Res2Net and RegNetX-3.2GF Mask R-CNNs, the generalized-attention and
    PAFPN Faster R-CNNs) at full width with seeded random weights and the
    ``'block'`` route, as the rcnn phase runs its configs: one serve batch
    and one ``inference_detector`` call, the FPN levels of a small float32
    input on the card held to the CPU (``_trunk_cpu_check``) and its RoI
    branches to the plain route, ``TRUNK_STEPS`` training steps on the
    repeated synthetic batch (every trainable tensor moves; Res2Net's
    stem, behind the gradient stop, by weight decay alone; Res2Net and
    PAFPN from weights with calibrated BatchNorm statistics), then each
    checkpoint through the test CLI on the first val crop (``--eval bbox``,
    and ``segm`` for the Mask R-CNNs).  Returns each config's launch
    counts, times and peak memory."""
    import numpy as np
    out = {}
    for label, config, calls, warmup, calibrate in TRUNK_CONFIGS:
        config = os.path.join(REPO, config)
        weights = None
        if calibrate:
            weights = os.path.join(REPO, "build", "chip_smoke_trunks",
                                   "init.pth")
            _calibrated_weights(config, weights)
        serve, serve_ms, serve_peak = serve_phase(
            "block", config, calls=1, label=f"{label} serve",
            checkpoint=weights,
            inspect=lambda model, *_: _trunk_cpu_check(
                model, f"{label} serve", np.random.RandomState(1)))
        train = train_phase("block", TRUNK_STEPS, config,
                            label=f"{label} train", keep=True,
                            warmup=warmup, load_from=weights)
        if weights:
            shutil.rmtree(os.path.dirname(weights), ignore_errors=True)
        if serve != 2 * calls or not (
                train["fwd"] == train["bwd"] == TRUNK_STEPS * calls):
            raise AssertionError(f"{label}: B1 {serve} launches serving, "
                                 f"{train['fwd']} / B2 {train['bwd']} "
                                 f"training; expected {calls} a batch or "
                                 f"step")
        coco = rcnn_coco(label, config, train["checkpoint"])
        shutil.rmtree(train["work_dir"], ignore_errors=True)
        out[label] = dict(serve=serve, serve_ms=serve_ms,
                          serve_peak_gib=serve_peak, train=train,
                          coco_cli=coco)
    for label, r in out.items():
        print(f"trunks {label}: serve {r['serve_ms']:.1f} ms a B=2 call, "
              f"peak {r['serve_peak_gib']:.2f} GiB, B1 {r['serve']} "
              f"launches; train median step {r['train']['step_ms']:.1f} ms, "
              f"peak {r['train']['peak_gib']:.2f} GiB, B1 "
              f"{r['train']['fwd']} / B2 {r['train']['bwd']} launches; test "
              f"CLI B1 {r['coco_cli']} launches", flush=True)
    return out


def coco_trunks_phase():
    """The COCO recipes' trunk, neck and R-CNN head options
    (``COCO_TRUNK_CONFIGS``: ResNeXt-101 32x4d, caffe style with the BN
    affine behind a gradient stop, GN and ConvWS through the trunk, the
    FPN, ``Shared4Conv1FCBBoxHead`` and the mask head) at full width with
    seeded random weights (the BN trunks' statistics calibrated,
    ``_calibrated_weights``) and the ``'block'`` route, as the trunks phase
    runs its configs, each config's test scale set to 1024^2 and its
    ``score_thr`` to the table's (written under ``COCO_TRUNK_DIR``): one
    serve batch and one
    ``inference_detector`` call, the FPN levels of a small float32 input
    held to the CPU and its RoI branches to the plain route,
    ``TRUNK_STEPS`` steps at the base LR, clipped at 35, on the repeated
    synthetic batch (every trainable tensor moves; the caffe trunk's BN
    affines, behind their gradient stop, by weight decay alone), then
    each checkpoint through the test CLI on the first val crop.  Returns
    each config's launch counts, times and peak memory."""
    import numpy as np
    out = {}
    os.makedirs(COCO_TRUNK_DIR, exist_ok=True)
    for label, config, calls, calibrate, score_thr in COCO_TRUNK_CONFIGS:
        cfg = _dense_config(os.path.join(REPO, config))
        cfg.optimizer_config.grad_clip = dict(max_norm=35, norm_type=2)
        cfg.test_cfg.rcnn.score_thr = score_thr
        config = os.path.join(COCO_TRUNK_DIR, f"{label}.py")
        cfg.dump(config)
        weights = None
        if calibrate:
            weights = os.path.join(COCO_TRUNK_DIR, "init.pth")
            _calibrated_weights(config, weights)
        serve, serve_ms, serve_peak = serve_phase(
            "block", config, calls=1, label=f"{label} serve",
            checkpoint=weights,
            inspect=lambda model, *_: _trunk_cpu_check(
                model, f"{label} serve", np.random.RandomState(1)))
        train = train_phase("block", TRUNK_STEPS, config,
                            label=f"{label} train", keep=True, warmup=False,
                            load_from=weights)
        if serve != 2 * calls or not (
                train["fwd"] == train["bwd"] == TRUNK_STEPS * calls):
            raise AssertionError(f"{label}: B1 {serve} launches serving, "
                                 f"{train['fwd']} / B2 {train['bwd']} "
                                 f"training; expected {calls} a batch or "
                                 f"step")
        coco = rcnn_coco(label, config, train["checkpoint"])
        shutil.rmtree(train["work_dir"], ignore_errors=True)
        out[label] = dict(serve=serve, serve_ms=serve_ms,
                          serve_peak_gib=serve_peak, train=train,
                          coco_cli=coco)
    shutil.rmtree(COCO_TRUNK_DIR, ignore_errors=True)
    for label, r in out.items():
        print(f"coco_trunks {label}: serve {r['serve_ms']:.1f} ms a B=2 "
              f"call, peak {r['serve_peak_gib']:.2f} GiB, B1 {r['serve']} "
              f"launches; train median step {r['train']['step_ms']:.1f} ms, "
              f"peak {r['train']['peak_gib']:.2f} GiB, B1 "
              f"{r['train']['fwd']} / B2 {r['train']['bwd']} launches; test "
              f"CLI B1 {r['coco_cli']} launches", flush=True)
    return out


def coco_rcnn_phase():
    """Item 6's A7 part (``COCO_RCNN_CONFIGS``: the C4 Mask R-CNN, GRoIE,
    modulated deformable RoI pooling, OHEM, PISA, Libra's COCO samplers and
    GIoU) at full width with seeded random weights, the BN statistics
    calibrated (``_calibrated_weights``), under ``'block'``, the test scale
    at 1024^2 and ``score_thr`` 0 (configs written under
    ``COCO_RCNN_DIR``), as ``coco_trunks_phase`` runs its configs: those
    with a serve count one serve batch and one ``inference_detector``
    call, the trunk's levels of a small float32 input held to the CPU and
    the RoI branches to the plain route; every one ``COCO_RCNN_STEPS``
    steps at the base LR, clipped at 35, on the repeated synthetic batch
    (every trainable tensor moves; the caffe trunk's and shared head's BN
    affines by weight decay alone), the launch counts of the table, and
    the C4 checkpoint through the test CLI.  Returns each config's launch
    counts, times and peak memory (``None`` where not served)."""
    import numpy as np
    out = {}
    os.makedirs(COCO_RCNN_DIR, exist_ok=True)
    for label, config, calls, (fwd, bwd) in COCO_RCNN_CONFIGS:
        cfg = _dense_config(os.path.join(REPO, config))
        cfg.optimizer_config.grad_clip = dict(max_norm=35, norm_type=2)
        cfg.test_cfg.rcnn.score_thr = 0.0
        config = os.path.join(COCO_RCNN_DIR, f"{label}.py")
        cfg.dump(config)
        weights = os.path.join(COCO_RCNN_DIR, "init.pth")
        _calibrated_weights(config, weights)
        serve = serve_ms = serve_peak = None
        if calls is not None:
            serve, serve_ms, serve_peak = serve_phase(
                "block", config, calls=1, label=f"{label} serve",
                checkpoint=weights,
                inspect=lambda model, *_: _trunk_cpu_check(
                    model, f"{label} serve", np.random.RandomState(1)))
        train = train_phase("block", COCO_RCNN_STEPS, config,
                            label=f"{label} train", keep=label == "c4",
                            warmup=False, load_from=weights)
        if (calls is not None and serve != 2 * calls) \
                or train["fwd"] != fwd * COCO_RCNN_STEPS \
                or train["bwd"] != bwd * COCO_RCNN_STEPS:
            raise AssertionError(
                f"{label}: B1 {serve} launches serving, {train['fwd']} / B2 "
                f"{train['bwd']} training; expected {calls} a batch, "
                f"{fwd} / {bwd} a step")
        coco = None
        if label == "c4":
            coco = rcnn_coco(label, config, train["checkpoint"])
            shutil.rmtree(train["work_dir"], ignore_errors=True)
        out[label] = dict(serve=serve, serve_ms=serve_ms,
                          serve_peak_gib=serve_peak, train=train,
                          coco_cli=coco)
    shutil.rmtree(COCO_RCNN_DIR, ignore_errors=True)
    for label, r in out.items():
        print(f"coco_rcnn {label}: " + (
            "trained only" if r["serve"] is None else
            f"serve {r['serve_ms']:.1f} ms a B=2 call, peak "
            f"{r['serve_peak_gib']:.2f} GiB, B1 {r['serve']} launches")
              + f"; train median step {r['train']['step_ms']:.1f} ms, "
              f"peak {r['train']['peak_gib']:.2f} GiB, B1 "
              f"{r['train']['fwd']} / B2 {r['train']['bwd']} launches"
              + ("" if r["coco_cli"] is None else
                 f"; test CLI B1 {r['coco_cli']} launches"), flush=True)
    return out


def coco_dense_phase():
    """Item 6's A6 dense-head and anchor half (``COCO_DENSE_CONFIGS``:
    Guided Anchoring's RetinaNet and RPN-only detector, the legacy v1.x
    Mask and Cascade Mask R-CNNs and RetinaNet, the SepBN RetinaNet on the
    crop640 NAS-FPN, Libra's and PISA's RetinaNets) at full width with
    seeded random weights, the BN statistics calibrated
    (``_calibrated_weights``, the SepBN head's per-level norms too), the
    test side at 1024^2 (640^2 for the crop640 config) and ``score_thr`` 0
    (configs written under ``COCO_DENSE_DIR``).  Those with a serve count
    one serve batch: the RetinaNets through :func:`dense_serve` (every
    image's detections filled at ``score_thr`` 0; their head outputs on a
    small float32 input on the card against the CPU, GA's through its
    deformable adaptions), the R-CNN and the RPN through
    :func:`serve_phase` under ``'block'`` (the RPN's proposals; the FPN
    levels and the GA-RPN's outputs of a small float32 input held to the
    CPU, the legacy Mask R-CNN's RoI branches to the plain route).  Every
    one ``COCO_DENSE_STEPS`` steps at the base LR, clipped at 35, on the
    repeated synthetic batch (the RetinaNets' of :func:`_dense_batch` at
    the test side): every trainable tensor moves, and the launch counts of
    the table.  Returns each config's launch counts, times and peak
    memory (``None`` where not served)."""
    import numpy as np
    out = {}
    os.makedirs(COCO_DENSE_DIR, exist_ok=True)
    for label, config, calls, (fwd, bwd), side in COCO_DENSE_CONFIGS:
        t0 = time.time()
        side = side or SIZE
        cfg = _dense_config(os.path.join(REPO, config), side)
        cfg.optimizer_config.grad_clip = dict(max_norm=35, norm_type=2)
        dense = cfg.model.type == "RetinaNet"
        if dense:
            cfg.test_cfg.score_thr = 0.0
        elif cfg.test_cfg.get("rcnn"):
            cfg.test_cfg.rcnn.score_thr = 0.0
        config = os.path.join(COCO_DENSE_DIR, f"{label}.py")
        cfg.dump(config)
        weights = os.path.join(COCO_DENSE_DIR, "init.pth")
        _calibrated_weights(config, weights, head=label == "sepbn_nasfpn")
        serve = serve_ms = serve_peak = None
        if calls is not None and dense:
            serve, serve_ms, serve_peak = dense_serve(
                label, config, calls=1, checkpoint=weights, side=side)
        elif calls is not None:
            serve, serve_ms, serve_peak = serve_phase(
                "block", config, calls=1, label=f"{label} serve",
                checkpoint=weights,
                inspect=lambda model, *_: _trunk_cpu_check(
                    model, f"{label} serve", np.random.RandomState(1)))
        train = train_phase("block", COCO_DENSE_STEPS, config,
                            label=f"{label} train", warmup=False,
                            load_from=weights,
                            batch=_dense_batch(side) if dense else None)
        if (calls is not None and serve != 2 * calls) \
                or train["fwd"] != fwd * COCO_DENSE_STEPS \
                or train["bwd"] != bwd * COCO_DENSE_STEPS:
            raise AssertionError(
                f"{label}: B1 {serve} launches serving, {train['fwd']} / B2 "
                f"{train['bwd']} training; expected {calls} a batch, "
                f"{fwd} / {bwd} a step")
        out[label] = dict(serve=serve, serve_ms=serve_ms,
                          serve_peak_gib=serve_peak, train=train,
                          coco_cli=None, seconds=time.time() - t0)
    shutil.rmtree(COCO_DENSE_DIR, ignore_errors=True)
    card = _gpu_name_and_power()
    for label, r in out.items():
        print(f"coco_dense {label}: " + (
            "trained only" if r["serve"] is None else
            f"serve {r['serve_ms']:.1f} ms a B=2 call, peak "
            f"{r['serve_peak_gib']:.2f} GiB, B1 {r['serve']} launches")
              + f"; train median step {r['train']['step_ms']:.1f} ms, "
              f"peak {r['train']['peak_gib']:.2f} GiB, B1 "
              f"{r['train']['fwd']} / B2 {r['train']['bwd']} launches; "
              f"{r['seconds']:.1f} s; card {card}", flush=True)
    return out


def cascades_phase():
    """HTC and DetectoRS (``CASCADE_CONFIGS``) at full width with seeded
    random weights whose BatchNorm statistics are calibrated
    (``_calibrated_weights``, DetectoRS's RFP backbone copy too) and the
    ``'block'`` route, as the trunks phase runs its configs: one serve
    batch and one ``inference_detector`` call, the FPN levels (after the
    RFP step) and HTC's semantic embedding of a small float32 input on the
    card held to the CPU (``_trunk_cpu_check``) and the RoI branches to
    the plain route, ``CASCADE_STEPS`` training steps on the repeated
    synthetic batch (HTC's with a ``gt_semantic_seg`` planted from the GT
    masks, so that its semantic loss trains; every trainable tensor moves,
    the RFP copy's stem and ``layer1`` by weight decay alone), then each
    checkpoint through the test CLI with ``--eval bbox segm`` on the first
    val crop.  Returns each config's launch counts, times and peak
    memory."""
    import numpy as np
    from bonai_tpu_torch.tools.profile_train import synthetic_batch
    out = {}
    for label, config, calls, warmup in CASCADE_CONFIGS:
        config = os.path.join(REPO, config)
        weights = os.path.join(REPO, "build", "chip_smoke_cascades",
                               "init.pth")
        _calibrated_weights(config, weights)
        serve, serve_ms, serve_peak = serve_phase(
            "block", config, calls=1, label=f"{label} serve",
            checkpoint=weights,
            inspect=lambda model, *_: _trunk_cpu_check(
                model, f"{label} serve", np.random.RandomState(1)))
        train = train_phase("block", CASCADE_STEPS, config,
                            label=f"{label} train", keep=True,
                            warmup=warmup, load_from=weights,
                            batch=synthetic_batch(semantic=label == "htc"))
        shutil.rmtree(os.path.dirname(weights), ignore_errors=True)
        if serve != 2 * calls or not (
                train["fwd"] == train["bwd"] == CASCADE_STEPS * calls):
            raise AssertionError(f"{label}: B1 {serve} launches serving, "
                                 f"{train['fwd']} / B2 {train['bwd']} "
                                 f"training; expected {calls} a batch or "
                                 f"step")
        coco = rcnn_coco(label, config, train["checkpoint"])
        shutil.rmtree(train["work_dir"], ignore_errors=True)
        out[label] = dict(serve=serve, serve_ms=serve_ms,
                          serve_peak_gib=serve_peak, train=train,
                          coco_cli=coco)
    for label, r in out.items():
        print(f"cascades {label}: serve {r['serve_ms']:.1f} ms a B=2 call, "
              f"peak {r['serve_peak_gib']:.2f} GiB, B1 {r['serve']} "
              f"launches; train median step {r['train']['step_ms']:.1f} ms, "
              f"peak {r['train']['peak_gib']:.2f} GiB, B1 "
              f"{r['train']['fwd']} / B2 {r['train']['bwd']} launches; test "
              f"CLI B1 {r['coco_cli']} launches", flush=True)
    return out


def _test_cli(cfg_path, checkpoint, *args):
    """The generic test CLI on the card; returns its results and metrics,
    the seconds taken and the launch counts of the run."""
    import torch
    from bonai_tpu_torch.tools import test as test_cli
    _zero_counts()
    t0 = time.perf_counter()
    results, metrics = test_cli.main([cfg_path, checkpoint, *args])
    torch.cuda.synchronize()
    return results, metrics, time.perf_counter() - t0, _counts()


def rcnn2_files(rpn_checkpoint):
    """The RPN -> proposal file -> Fast R-CNN chain on the data and eval
    phases' tiles.  The RPN's checkpoint through the test CLI on the 8
    train tiles (test mode) and on the 4 val crops (no kernel may launch);
    ``AR@100/300/1000`` of the first crop through
    ``CocoDataset.evaluate``; both pkls made proposal files
    (``datasets.proposals``); ``train_detector`` trains the Fast R-CNN
    config ``RCNN2_STEPS`` steps from the files (``LoadProposals(2000)``,
    the train tiles' file; B1 and B2 once a step); the test CLI scores it
    with ``--eval bbox`` on the first crop from the crops' file (given with
    ``--options``; B1 once).  Returns the launch counts."""
    import math
    import torch
    from bonai_tpu_torch.apis import train_detector
    from bonai_tpu_torch.datasets import build_dataset
    from bonai_tpu_torch.datasets.proposals import (fast_rcnn_config,
                                                    write_proposal_file)
    from bonai_tpu_torch.engine import latest_checkpoint
    _, fwd_name, bwd_name = ROUTES["block"]
    out_dir = os.path.join(REPO, "build", "chip_smoke_files")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    rpn_config = os.path.join(REPO, RCNN2_CONFIGS[3][1])
    fast_config = os.path.join(REPO, RCNN2_CONFIGS[4][1])
    train_json = os.path.join(DATA_DIR, "train", "train.json")
    train_images = os.path.join(DATA_DIR, "train", "images") + "/"
    counts = {}
    props = {}
    for split in ("train", "crops"):
        cfg = _crop_test_cfg(rpn_config)
        if split == "train":
            cfg.data.test.update(ann_file=train_json, img_prefix=train_images)
        cfg_path = os.path.join(out_dir, f"rpn_{split}.py")
        cfg.dump(cfg_path)
        pkl = os.path.join(out_dir, f"rpn_{split}.pkl")
        results, _, secs, counts[f"rpn_{split}"] = _test_cli(
            cfg_path, rpn_checkpoint, "--out", pkl)
        _check_counts(counts[f"rpn_{split}"], {}, f"rpn test CLI, {split}")
        props[split] = os.path.join(out_dir, f"proposals_{split}.pkl")
        n = [len(p) for p in write_proposal_file(pkl, props[split])]
        print(f"rcnn2 files: rpn test CLI on the {len(results)} {split} "
              f"tiles, {secs:.1f} s; proposals an image {n}", flush=True)
        if split == "crops":
            ds = build_dataset(dict(cfg.data.test, test_mode=True))
            recall = ds.evaluate(results[:1], metric="recall",
                                 proposal_nums=(100, 300, 1000))
            print("rcnn2 files: rpn on the first val crop: " + ", ".join(
                f"{k} {v:.4f}" for k, v in recall.items()), flush=True)
            if not all(0.0 <= v <= 1.0 for v in recall.values()):
                raise AssertionError(f"rpn recall {recall}")

    cfg = _config("block", fast_config)
    cfg.data.train.update(ann_file=train_json, img_prefix=train_images)
    cfg.data.test.update(
        ann_file=os.path.join(DATA_DIR, "val", "val.json"),
        img_prefix=os.path.join(DATA_DIR, "val", "images") + "/")
    fast_rcnn_config(cfg, props["train"], num_max_proposals=2000)
    cfg_path = os.path.join(out_dir, "fast_rcnn_files.py")
    cfg.dump(cfg_path)
    work_dir = os.path.join(out_dir, "wd_fast")
    _zero_counts()
    t0 = time.time()
    _, hist = train_detector(cfg, None, work_dir, seed=0,
                             max_steps=RCNN2_STEPS, log_interval=1,
                             n_devices=1)
    torch.cuda.synchronize()
    counts["fast_train"] = _counts()
    _check_counts(counts["fast_train"], {fwd_name: RCNN2_STEPS,
                                         bwd_name: RCNN2_STEPS},
                  f"fast_rcnn from files, {RCNN2_STEPS} steps")
    losses = [{k: v for k, v in h.items() if k.startswith("loss")}
              for h in hist]
    print(f"rcnn2 files: fast_rcnn train_detector from the files, "
          f"{RCNN2_STEPS} steps in {time.time() - t0:.1f} s incl. set-up; "
          f"ms per step {[round(h['time'] * 1e3, 1) for h in hist]}; "
          f"losses {losses}; launches {counts['fast_train']}", flush=True)
    if not all(math.isfinite(v) for h in losses for v in h.values()):
        raise AssertionError(f"fast_rcnn from files: losses {losses}")
    results, metrics, secs, counts["fast_test"] = _test_cli(
        cfg_path, latest_checkpoint(work_dir), "--eval", "bbox",
        "--max-images", "1", "--options",
        f"data.test.proposal_file={props['crops']}")
    _check_counts(counts["fast_test"], {fwd_name: 1},
                  "fast_rcnn test CLI, 1 batch")
    if len(results) != 1 or not all(0.0 <= v <= 1.0 or v == -1.0
                                    for v in metrics.values()):
        raise AssertionError(f"fast_rcnn test CLI: {len(results)} results, "
                             f"{metrics}")
    print(f"rcnn2 files: fast_rcnn test CLI --eval bbox on the first val "
          f"crop from its proposal file, {len(results[0][0])} detections, "
          f"{secs:.1f} s: " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in metrics.items())
          + f"; launches {counts['fast_test']}", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    return {k: (c[fwd_name], c[bwd_name]) for k, c in counts.items()}


def _dense_config(config, side=SIZE):
    """A dense detector's config with its test scale at ``side``^2 (the
    COCO configs' is 1333x800)."""
    from bonai_tpu_torch.config import Config
    cfg = Config.fromfile(config)
    cfg.data.test.pipeline[1].img_scale = (side, side)
    return cfg


def _dense_cpu_check(model, what, r, size=(256, 320), float64=False):
    """The head outputs of a small float32 input (two images of ``size``)
    on the card and on the CPU, from the same weights, with TF32 off: each
    output (logits, deltas or distances, centerness; RepPoints' two point
    sets, through its deformable convs, and ``moment_transfer``; NAS-FCOS's
    through its deformable towers; CornerNet's heat, offset and embedding
    maps of both levels, through its corner pools) must agree within 1e-4
    of its largest value over the levels.  With ``float64`` (the dense3
    phase's detectors) both runs are in float64 (the heads cast their
    outputs to float32): in float32, NAS-FCOS's per-channel GroupNorms
    over a few cells and Hourglass-104's hundred layers leave the card
    and the CPU each up to 1e-4 of the largest value from the float64
    result (CornerNet's embeddings on the card 1.03e-4, on the CPU 3.9e-5,
    PR 18); the CPU's float32 distance is printed beside."""
    import copy
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import prepare_batch
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model.float()
        cpu = copy.deepcopy(model).cpu().to(
            memory_format=torch.contiguous_format)
        small = [r.randint(0, 256, size + (3,), np.uint8) for _ in range(2)]
        model.cfg.data.test.pipeline[1].img_scale = (max(size),) * 2
        img, _, _, _ = prepare_batch(model, small)
        with torch.inference_mode():
            if float64:
                cpu32 = cpu.bbox_head(cpu.extract_feat(img.cpu()))
                model.double()
                cpu.double()
                img = img.double()
            t0 = time.perf_counter()
            got = model.bbox_head(model.extract_feat(img))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want = cpu.bbox_head(cpu.extract_feat(img.cpu()))
            t2 = time.perf_counter()
            if not float64:
                cpu32 = want
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    if isinstance(got[0], dict):                # CornerNet's levels
        got, cpu32, want = ([[lvl[k] for lvl in outs] for k in sorted(
            outs[0])] for outs in (got, cpu32, want))
    against = "the CPU, both in float64" if float64 else "the CPU"
    for i, (g, c, w) in enumerate(zip(got, cpu32, want)):
        if torch.is_tensor(g):                  # RepPoints' moment_transfer
            g, c, w = [g], [c], [w]
        err = max(float((a.cpu().double() - b.double()).abs().max())
                  for a, b in zip(g, w))
        noise = max(float((a.double() - b.double()).abs().max())
                    for a, b in zip(c, w))
        top = max(float(b.abs().max()) for b in w)
        print(f"{what}: small input ({tuple(img.shape[1:3])}), "
              f"head output {i} on the card vs {against}: max abs diff "
              f"{err:.3g} (" + (f"float32 on the CPU {noise:.3g}; "
                                if float64 else "") +
              f"outputs up to {top:.3g}); card {(t1 - t0) * 1e3:.1f} ms, "
              f"CPU {(t2 - t1) * 1e3:.1f} ms", flush=True)
        if not err <= 1e-4 * top:
            raise AssertionError(f"{what}: head output {i} differs between "
                                 f"the card and the CPU by {err}")


def dense_serve(label, config, calls=2, checkpoint=None,
                small=(256, 320), float64=False, single=(512, 640),
                side=SIZE):
    """Full-width serving of a dense detector through the port's entry
    points (seeded random weights, or ``checkpoint``'s; bfloat16) at the
    test side ``side``:
    ``calls`` timed batches and one ``inference_detector`` call (an image
    of ``single``) at the config's thresholds, one batch with
    ``score_thr=0``, which must fill every image's ``max_per_img``
    detections (CornerNet's, without a threshold, keep at least one),
    then :func:`_dense_cpu_check` at ``small`` (both runs in float64 with
    ``float64``).  No kernel may launch.  Returns the forward kernel's
    launches (0), the median ms a batch and the peak GiB."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import (inference_detector, init_detector,
                                      prepare_batch)
    what = f"{label} serve"
    t0 = time.time()
    model = init_detector(_dense_config(config, side), checkpoint,
                          seed=0)                           # cuda, bf16
    print(f"{what}: init_detector {time.time() - t0:.1f} s, "
          f"{type(model).__name__}, {model.num_classes} classes, "
          f"{sum(p.numel() for p in model.parameters())} parameters",
          flush=True)
    max_per_img = model.test_cfg.get("max_per_img", 100)
    r = np.random.RandomState(0)
    imgs = [r.randint(0, 256, (side, side, 3), np.uint8)
            for _ in range(BATCH)]
    img, img_shape, scale, _ = prepare_batch(model, imgs)
    if tuple(img.shape[1:3]) != (side, side):
        raise AssertionError(f"{what}: input {tuple(img.shape)}")
    model.simple_test(img, img_shape, scale)            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.simple_test(img, img_shape, scale)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_outputs(out, BATCH, max_per_img, model,
                       need_detections=False)
    t0 = time.perf_counter()
    res = inference_detector(model, r.randint(0, 256, single + (3,),
                                              np.uint8))
    single_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (isinstance(res, list) and len(res) == 1
            and res[0].shape[1:] == (5,) and np.isfinite(res[0]).all()):
        raise AssertionError(f"{what}: inference_detector gave {res}")
    thr = model.test_cfg.get("score_thr", 0.05)
    model.test_cfg["score_thr"] = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    every = model.simple_test(img, img_shape, scale)
    torch.cuda.synchronize()
    every_ms = (time.perf_counter() - t0) * 1e3
    model.test_cfg["score_thr"] = thr
    _check_outputs(every, BATCH, max_per_img, model)
    counts = _counts()
    _check_counts(counts, {}, f"{what}, {calls + 2} batches")
    n_every = every["det_valid"].sum(1).tolist()
    print(f"{what}: simple_test {side}^2 B={BATCH} bf16 ms per call "
          f"{[round(x, 1) for x in times]}; valid detections at score_thr "
          f"{thr} {out['det_valid'].sum(1).tolist()}; at 0 {n_every} "
          f"({every_ms:.1f} ms); inference_detector {single[0]}x{single[1]} "
          f"{single_ms:.1f} ms, {len(res[0])} class-0 detections; peak "
          f"memory {peak:.2f} GiB (max_memory_allocated); launches {counts}",
          flush=True)
    # CornerNet has no score threshold: its detections are the corner
    # pairs that survive the decode's masks, each image must keep some
    fill = [max_per_img] * BATCH if "score_thr" in model.cfg.test_cfg \
        else None
    if (n_every != fill) if fill else min(n_every) < 1:
        raise AssertionError(f"{what}: {n_every} detections at score_thr 0")
    _dense_cpu_check(model, what, r, small, float64)
    return counts[ROUTES["block"][1]], statistics.median(times), peak


def _dense_batch(size=SIZE):
    """The synthetic training batch at ``size``^2 with its first 8 GTs an
    image made a quarter to 0.98 of the side wide and high (log-uniform,
    seed 1; 256..1000 px at 1024^2): its objects then reach every pyramid
    level's targets (the batch's own boxes of 10 px to a fifth of the
    side stop at stride 32), so every level's learnable scale gets a
    gradient."""
    import numpy as np
    from bonai_tpu_torch.tools.profile_train import synthetic_batch
    batch = synthetic_batch(size=size)
    r = np.random.RandomState(1)
    lo, hi = 256.0 * size / SIZE, 1000.0 * size / SIZE
    wh = np.exp(r.uniform(np.log(lo), np.log(hi), (BATCH, 8, 2)))
    xy = r.uniform(0, 1, (BATCH, 8, 2)) * (size - 1 - wh)
    batch["gt_bboxes"][:, :8] = np.concatenate([xy, xy + wh], -1)
    return batch


def dense_phase():
    """The dense single-stage detectors (``DENSE_CONFIGS``) at full width
    with seeded random weights: :func:`dense_serve`, then ``DENSE_STEPS``
    training steps on the repeated synthetic batch of :func:`_dense_batch`
    (at the base LR where the config's schedule clips the gradient, the
    BONAI schedule: at the warmup's first LRs the GN weights, 1 at the
    start, move by less than a float32 ulp; with the warmup where it does
    not, RetinaNet's COCO schedule, which the GHM and PISA configs keep:
    at its base LR without a clip they diverge from random weights), and
    the BONAI configs' checkpoints through
    the test CLI (``--eval bbox``, ``score_thr=0``).  Returns each
    config's launch counts, times and peak memory."""
    from bonai_tpu_torch.config import Config
    out = {}
    for label, config, scored in DENSE_CONFIGS:
        config = os.path.join(REPO, config)
        serve, serve_ms, serve_peak = dense_serve(label, config)
        clip = dict(Config.fromfile(config).get("optimizer_config") or {}
                    ).get("grad_clip")
        train = train_phase("block", DENSE_STEPS, config,
                            label=f"{label} train", keep=scored,
                            warmup=not clip, batch=_dense_batch())
        coco = None
        if scored:
            coco = rcnn_coco(label, config, train["checkpoint"],
                             options=["test_cfg.score_thr=0.0"])
            shutil.rmtree(train["work_dir"], ignore_errors=True)
        out[label] = dict(serve=serve, serve_ms=serve_ms,
                          serve_peak_gib=serve_peak, train=train,
                          coco_cli=coco)
    for label, r in out.items():
        print(f"dense {label}: serve {r['serve_ms']:.1f} ms a B=2 call, peak "
              f"{r['serve_peak_gib']:.2f} GiB; train median step "
              f"{r['train']['step_ms']:.1f} ms, peak "
              f"{r['train']['peak_gib']:.2f} GiB; launches B1 serving "
              f"{r['serve']}, B1 / B2 training {r['train']['fwd']} / "
              f"{r['train']['bwd']}" + (f", B1 test CLI {r['coco_cli']}"
                                        if r["coco_cli"] is not None
                                        else ""),
              flush=True)
    return out


def dense2_phase():
    """RepPoints, FSAF, FoveaBox and Guided-Anchoring Faster R-CNN
    (``DENSE2_CONFIGS``) at full width with seeded random weights.  The
    three dense detectors as the dense phase runs its configs
    (:func:`dense_serve`, RepPoints' small-input check through its
    deformable convs; ``DENSE2_STEPS`` steps at the base LR on
    :func:`_dense_batch`; the test CLI with ``--eval bbox`` at
    ``score_thr=0``), no kernel launch; GA as the trunks phase runs PAFPN
    (calibrated BatchNorm statistics, the ``'block'`` route, its COCO
    schedule's warmup): B1 once a serve batch, its RoI branch held to the
    plain route and its FPN levels and GA-RPN outputs of a small float32
    input to the CPU, B1 and B2 once a step, B1 once in the test CLI.
    Returns each config's launch counts, times and peak memory."""
    import numpy as np
    from bonai_tpu_torch.config import Config
    out = {}
    for label, config, calls in DENSE2_CONFIGS:
        config = os.path.join(REPO, config)
        t0 = time.time()
        if not calls:
            serve, serve_ms, serve_peak = dense_serve(label, config, calls=1)
            clip = dict(Config.fromfile(config).get("optimizer_config")
                        or {}).get("grad_clip")
            train = train_phase("block", DENSE2_STEPS, config,
                                label=f"{label} train", keep=True,
                                warmup=not clip, batch=_dense_batch())
            options = ["test_cfg.score_thr=0.0"]
        else:
            weights = os.path.join(REPO, "build", "chip_smoke_dense2",
                                   "init.pth")
            _calibrated_weights(config, weights)
            serve, serve_ms, serve_peak = serve_phase(
                "block", config, calls=1, label=f"{label} serve",
                checkpoint=weights,
                inspect=lambda model, *_: _trunk_cpu_check(
                    model, f"{label} serve", np.random.RandomState(1)))
            train = train_phase("block", DENSE2_STEPS, config,
                                label=f"{label} train", keep=True,
                                load_from=weights)
            shutil.rmtree(os.path.dirname(weights), ignore_errors=True)
            options = []
        if serve != 2 * calls or not (
                train["fwd"] == train["bwd"] == DENSE2_STEPS * calls):
            raise AssertionError(f"{label}: B1 {serve} launches serving, "
                                 f"{train['fwd']} / B2 {train['bwd']} "
                                 f"training; expected {calls} a batch or "
                                 f"step")
        coco = rcnn_coco(label, config, train["checkpoint"], options=options)
        shutil.rmtree(train["work_dir"], ignore_errors=True)
        out[label] = dict(serve=serve, serve_ms=serve_ms,
                          serve_peak_gib=serve_peak, train=train,
                          coco_cli=coco, seconds=time.time() - t0)
    card = _gpu_name_and_power()
    for label, r in out.items():
        print(f"dense2 {label}: serve {r['serve_ms']:.1f} ms a B=2 call, "
              f"peak {r['serve_peak_gib']:.2f} GiB, B1 {r['serve']} "
              f"launches; train median step {r['train']['step_ms']:.1f} ms, "
              f"peak {r['train']['peak_gib']:.2f} GiB, B1 "
              f"{r['train']['fwd']} / B2 {r['train']['bwd']} launches; test "
              f"CLI B1 {r['coco_cli']} launches; {r['seconds']:.1f} s; "
              f"card {card}", flush=True)
    return out


def dense3_phase():
    """NAS-FPN RetinaNet, NAS-FCOS, SSD300 and CornerNet
    (``DENSE3_CONFIGS``) at full width with seeded random weights (the R50
    trunks' and the hourglass's BatchNorm statistics calibrated,
    ``_calibrated_weights``), as the dense phase runs its configs:
    :func:`dense_serve` (one timed batch; the small input through
    NAS-FCOS's deformable towers and CornerNet's corner pools on the card
    against the CPU, both in float64), ``DENSE3_STEPS`` steps on :func:`_dense_batch` at the
    config's training side (at the base LR where the schedule clips the
    gradient; NAS-FPN's COCO schedule, unclipped, with its warmup), each
    checkpoint through the test CLI with ``--eval bbox`` at
    ``score_thr=0``.  No kernel may launch.  Returns each config's launch
    counts, times and peak memory."""
    from bonai_tpu_torch.config import Config
    out = {}
    for label, config, calibrate, small, single, side in DENSE3_CONFIGS:
        config = os.path.join(REPO, config)
        t0 = time.time()
        weights = None
        if calibrate:
            weights = os.path.join(REPO, "build", "chip_smoke_dense3",
                                   "init.pth")
            _calibrated_weights(config, weights)
        serve, serve_ms, serve_peak = dense_serve(
            label, config, calls=1, checkpoint=weights, small=small,
            float64=True, single=single)
        clip = dict(Config.fromfile(config).get("optimizer_config")
                    or {}).get("grad_clip")
        train = train_phase("block", DENSE3_STEPS, config,
                            label=f"{label} train", keep=True,
                            warmup=not clip, load_from=weights,
                            batch=_dense_batch(side))
        if weights:
            shutil.rmtree(os.path.dirname(weights), ignore_errors=True)
        if serve or train["fwd"] or train["bwd"]:
            raise AssertionError(f"{label}: B1 {serve} launches serving, "
                                 f"{train['fwd']} / B2 {train['bwd']} "
                                 f"training; expected none")
        coco = rcnn_coco(label, config, train["checkpoint"],
                         options=["test_cfg.score_thr=0.0"])
        shutil.rmtree(train["work_dir"], ignore_errors=True)
        out[label] = dict(serve=serve, serve_ms=serve_ms,
                          serve_peak_gib=serve_peak, train=train,
                          coco_cli=coco, seconds=time.time() - t0)
    card = _gpu_name_and_power()
    for label, r in out.items():
        print(f"dense3 {label}: serve {r['serve_ms']:.1f} ms a B=2 call, "
              f"peak {r['serve_peak_gib']:.2f} GiB, B1 {r['serve']} "
              f"launches; train median step {r['train']['step_ms']:.1f} ms, "
              f"peak {r['train']['peak_gib']:.2f} GiB, B1 "
              f"{r['train']['fwd']} / B2 {r['train']['bwd']} launches; test "
              f"CLI B1 {r['coco_cli']} launches; {r['seconds']:.1f} s; "
              f"card {card}", flush=True)
    return out


def _attr_config():
    """The ``attr`` configuration, derived at full width from
    ``configs/loft_foa/loft_foa_r50_fpn_2x_bonai.py`` (its ``'block'``
    route; the same derivation as ``tests/torch_port_common.py::attr_cfg``
    at tiny widths): ``SemiRPNHead``; height and joint offset-height heads
    of 4 convs of 256 and 2 FCs of 1024; an angle head of 256 in, 2 convs
    of 256; side-face and offset-field heads of 4 convs of 256; offset
    reweighting; a train pipeline that loads heights, the angle, footprint
    boxes and flag, side-face maps and offset fields.  Written to
    ``ATTR_DIR``; returns its path."""
    from bonai_tpu_torch.config import Config
    cfg = Config.fromfile(CONFIG)
    cfg.model.rpn_head.type = "SemiRPNHead"
    trunk = dict(num_convs=4, num_fcs=2, conv_out_channels=256,
                 fc_out_channels=1024)
    cfg.model.roi_head.update(
        height_head=dict(trunk), offset_height_head=dict(trunk),
        angle_head=dict(in_channels=256, conv_out_channels=256,
                        num_convs=2),
        side_face_head=dict(num_convs=4, conv_out_channels=256),
        offset_field_head=dict(num_convs=4, conv_out_channels=256),
        offset_reweight=True)
    load = cfg.data.train.pipeline[1]
    assert load.type == "LoadAnnotations"
    load.update(with_building_height=True, with_angle=True,
                with_footprint_bbox=True, with_only_footprint_flag=True,
                with_side_face=True, with_offset_field=True)
    os.makedirs(ATTR_DIR, exist_ok=True)
    path = os.path.join(ATTR_DIR, "loft_foa_r50_fpn_attr_bonai.py")
    cfg.dump(path)
    return path


def _polar_config():
    """The ``polar`` configuration, derived at full width from
    ``configs/loft/loft_r50_fpn_2x_bonai.py`` (the same derivation as
    ``tests/torch_port_common.py::polar_cfg`` at tiny widths): its
    ``OffsetHead`` with ``reg_num=3`` and ``offset_coordinate='polar'``,
    ``DeltaPolarOffsetCoder``, and ``OffsetTransform('xy2la')`` after
    ``RandomFlip`` in the train pipeline.  Written to ``ATTR_DIR``;
    returns its path."""
    from bonai_tpu_torch.config import Config
    cfg = Config.fromfile(LOFT_CONFIG)
    oh = cfg.model.roi_head.offset_head
    oh.update(reg_num=3, offset_coordinate="polar",
              offset_coder=dict(type="DeltaPolarOffsetCoder",
                                target_means=[0.0, 0.0],
                                target_stds=[0.5, 0.5]))
    pipeline = cfg.data.train.pipeline
    flip = [i for i, t in enumerate(pipeline) if t.type == "RandomFlip"][0]
    pipeline.insert(flip + 1, dict(type="OffsetTransform",
                                   transform_flag="xy2la"))
    os.makedirs(ATTR_DIR, exist_ok=True)
    path = os.path.join(ATTR_DIR, "loft_r50_fpn_polar_bonai.py")
    cfg.dump(path)
    return path


def _polar_batch():
    """The synthetic batch with its offsets in polar form, as
    ``OffsetTransform('xy2la')`` leaves them."""
    import numpy as np
    from bonai_tpu_torch.tools.profile_train import synthetic_batch
    batch = synthetic_batch()
    o = batch["gt_offsets"]
    batch["gt_offsets"] = np.stack([np.hypot(o[..., 0], o[..., 1]),
                                    np.arctan2(o[..., 1], o[..., 0])],
                                   -1).astype(np.float32)
    return batch


def attr_files(config, weights):
    """The ``attr`` configuration from files: the side-face PNG and
    offset-field ``.npy`` of each of the data phase's 8 tiles (written by
    the port's generator, ``write_attribute_maps``, under ``DATA_DIR``;
    the tiles too where no data phase ran), ``ATTR_FILES_STEPS`` steps of
    the train CLI from ``weights`` (every attribute loss finite), then the
    BONAI test CLI on its checkpoint (one batch of two tiles: ``(bbox,
    segm, offsets)`` each).  Returns B1's and B2's launches of the train
    CLI and B1's of the test CLI."""
    import numpy as np
    import torch
    from bonai_tpu_torch.config import Config
    from bonai_tpu_torch.engine import latest_checkpoint
    from bonai_tpu_torch.tools import bonai_test
    from bonai_tpu_torch.tools import train as train_cli
    from bonai_tpu_torch.tools.make_synthetic_bonai import (
        write_attribute_maps, write_split)
    _, fwd_name, bwd_name = ROUTES["block"]
    serve_calls, step_calls = ATTR_CALLS["attr"]
    train_dir = os.path.join(DATA_DIR, "train")
    if not os.path.exists(os.path.join(train_dir, "train.json")):
        write_split(DATA_DIR, "train", 8, 0, SIZE)
    t0 = time.perf_counter()
    side, field = write_attribute_maps(DATA_DIR, "train")
    maps_s = time.perf_counter() - t0
    cfg = Config.fromfile(config)
    for split in (cfg.data.train, cfg.data.test):
        split.update(ann_file=os.path.join(train_dir, "train.json"),
                     img_prefix=os.path.join(train_dir, "images") + "/",
                     side_face_prefix=side + "/",
                     offset_field_prefix=field + "/")
    cfg.data.workers_per_gpu = 2
    cfg.load_from = weights
    cfg.log_config = dict(interval=1)
    work_dir = os.path.join(ATTR_DIR, "wd")
    shutil.rmtree(work_dir, ignore_errors=True)
    cfg_path = os.path.join(ATTR_DIR, "attr_files.py")
    cfg.dump(cfg_path)
    _zero_counts()
    t0 = time.perf_counter()
    # the CLI prints its whole config: into the work directory
    os.makedirs(work_dir)
    with open(os.path.join(work_dir, "stdout.txt"), "w") as f, \
            contextlib.redirect_stdout(f):
        train_cli.main([cfg_path, "--work-dir", work_dir, "--max-steps",
                        str(ATTR_FILES_STEPS), "--n-devices", "1"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = _counts()
    _check_counts(counts, {fwd_name: step_calls * ATTR_FILES_STEPS,
                           bwd_name: step_calls * ATTR_FILES_STEPS},
                  f"attr from files, {ATTR_FILES_STEPS} steps")
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    keys = ("loss", "loss_angle", "loss_height", "loss_offset_height",
            "loss_side_face", "loss_offset_field", "loss_offset",
            "loss_rpn_bbox")
    if len(rows) != ATTR_FILES_STEPS or not all(
            np.isfinite(r[k]) for r in rows for k in keys):
        raise AssertionError(f"attr from files: log rows {rows}")
    print(f"attr files: maps of {len(os.listdir(side))} tiles written in "
          f"{maps_s:.1f} s; train CLI {ATTR_FILES_STEPS} steps in "
          f"{train_s:.1f} s incl. set-up; " + " ".join(
              f"{k} {rows[-1][k]:.4g}" for k in keys)
          + f"; launches {counts}", flush=True)
    pkl = os.path.join(ATTR_DIR, "attr.pkl")
    _zero_counts()
    t0 = time.perf_counter()
    payload = bonai_test.main([cfg_path, latest_checkpoint(work_dir),
                               "--out", pkl, "--city", "config",
                               "--max-images", "2"])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_counts = _counts()
    _check_counts(test_counts, {fwd_name: serve_calls},
                  "attr test CLI, 1 batch")
    results = payload["results"]
    if len(results) != 2 or not all(
            isinstance(r, tuple) and len(r) == 3
            and len(r[2]) == len(r[0][0]) and np.isfinite(r[2]).all()
            for r in results):
        raise AssertionError("the attr test CLI's results are not (bbox, "
                             "segm, offsets) 3-tuples")
    print(f"attr files: BONAI test CLI {test_s:.1f} s (model build, 2 "
          f"tiles, bf16), detections {[len(r[0][0]) for r in results]}; "
          f"launches {test_counts}", flush=True)
    shutil.rmtree(work_dir, ignore_errors=True)
    return counts[fwd_name], counts[bwd_name], test_counts[fwd_name]


def attr_phase():
    """LOFT-FOA with every attribute head and the semi-RPN (``attr``,
    :func:`_attr_config`) and LOFT with polar offsets (``polar``,
    :func:`_polar_config`) at full width, from seeded random weights whose
    R50 BatchNorm statistics are calibrated (``_calibrated_weights``), with
    the ``'block'`` route: one serve batch (B=2, 1024^2, bf16) and one
    ``inference_detector`` call; the small float32 input's every RoI
    branch output (the attribute heads' too) against the plain route;
    ``ATTR_STEPS`` steps on the repeated synthetic batch (``attr``: with
    random 1024^2 side-face maps and offset fields, heights, angles,
    footprint boxes, the first image footprint-only; ``polar``: its
    offsets polar), every trainable tensor moving; B1 and B2 launched
    ``ATTR_CALLS`` times a batch or step.  Then :func:`attr_files`.
    Returns the launch counts, times and peak memory."""
    from bonai_tpu_torch.tools.profile_train import synthetic_batch
    t0 = time.time()
    out = {}
    for label, config, batch in (
            ("attr", _attr_config(), synthetic_batch(attributes=True)),
            ("polar", _polar_config(), _polar_batch())):
        weights = os.path.join(ATTR_DIR, f"{label}_init.pth")
        _calibrated_weights(config, weights)
        serve, serve_ms, serve_peak = serve_phase(
            "block", config, calls=1, label=f"{label} serve",
            checkpoint=weights)
        train = train_phase("block", ATTR_STEPS, config,
                            label=f"{label} train", load_from=weights,
                            batch=batch)
        serve_calls, step_calls = ATTR_CALLS[label]
        if serve != 2 * serve_calls or not (
                train["fwd"] == train["bwd"] == ATTR_STEPS * step_calls):
            raise AssertionError(f"{label}: B1 {serve} launches serving, "
                                 f"{train['fwd']} / B2 {train['bwd']} "
                                 f"training; expected {serve_calls} a "
                                 f"batch and {step_calls} a step")
        out[label] = dict(serve=serve, serve_ms=serve_ms,
                          serve_peak_gib=serve_peak, train=train)
    files = attr_files(_attr_config(), os.path.join(ATTR_DIR,
                                                     "attr_init.pth"))
    out["files"] = dict(zip(("fwd", "bwd", "test_cli"), files))
    card = _gpu_name_and_power()
    for label in ATTR_CALLS:
        r = out[label]
        print(f"attr phase {label}: serve {r['serve_ms']:.1f} ms a B=2 "
              f"call, peak {r['serve_peak_gib']:.2f} GiB, B1 {r['serve']} "
              f"launches; train median step {r['train']['step_ms']:.1f} ms, "
              f"peak {r['train']['peak_gib']:.2f} GiB, B1 "
              f"{r['train']['fwd']} / B2 {r['train']['bwd']} launches; card "
              f"{card}", flush=True)
    print(f"attr phase: {time.time() - t0:.1f} s", flush=True)
    shutil.rmtree(ATTR_DIR, ignore_errors=True)
    return out


def _match_detections(got, ref, what):
    """Hold two TTA outputs of the same input to each other: per image the
    same number of valid detections, each of ``got``'s matched to the
    nearest of ``ref``'s by box and score (a near-tie may order them
    otherwise), every float output of a matched pair within 1e-4 of that
    output's largest value (at least 1).  Returns the largest difference
    and the number of pairs matched out of place."""
    import torch
    valid_g, valid_r = got["det_valid"], ref["det_valid"]
    if not torch.equal(valid_g.sum(1), valid_r.sum(1)):
        raise AssertionError(f"{what}: valid detections "
                             f"{valid_g.sum(1).tolist()} against "
                             f"{valid_r.sum(1).tolist()}")
    keys = [k for k, v in ref.items() if v.is_floating_point()
            and v.dim() >= 2]
    worst, moved = 0.0, 0
    for i in range(valid_r.shape[0]):
        g = {k: got[k][i][valid_g[i]].float() for k in keys}
        r = {k: ref[k][i][valid_r[i]].float() for k in keys}
        key_g = torch.cat([g["det_bboxes"], g["det_scores"][:, None]], 1)
        key_r = torch.cat([r["det_bboxes"], r["det_scores"][:, None]], 1)
        order = torch.cdist(key_g, key_r).argmin(1)
        if len(set(order.tolist())) != len(order):
            raise AssertionError(f"{what}: image {i}'s detections do not "
                                 f"pair off")
        moved += int((order != torch.arange(len(order),
                                            device=order.device)).sum())
        for k in keys:
            err = float((g[k] - r[k][order]).abs().max()) if len(order) \
                else 0.0
            scale = max(float(ref[k].float().abs().max()), 1.0)
            worst = max(worst, err / scale)
            if not err <= 1e-4 * scale:
                raise AssertionError(f"{what}: {k} differs by {err} "
                                     f"(outputs up to {scale})")
    return worst, moved


def _timed(module, name, sums):
    """Replace ``module.name`` by a wrapper that adds its synchronised
    milliseconds to ``sums[name]``; returns the undo."""
    import torch
    fn = getattr(module, name)

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        sums[name] = sums.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out
    setattr(module, name, timed)
    return lambda: setattr(module, name, fn)


def tta_serve():
    """Test-time augmentation of LOFT-FOA R50-FPN at full width (``'block'``,
    bf16, 1024^2, B=2, seeded random weights with calibrated R50 BatchNorm
    statistics): one warm and one timed batch of each of ``TTA_RUNS``
    (after a timed plain ``simple_test``), each held to its launches a
    batch and to ``simple_test``'s outputs; the soft-NMS and the
    detection-level merges timed inside each call.  Then a small float32
    input through both merge levels at the default views, through the
    kernel and through its plain version, matched detection by detection
    within 1e-4 of each output's largest value (TF32 off).  Returns, per
    run, its launches, ms and peak memory."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import init_detector, prepare_batch
    from bonai_tpu_torch.apis import test as port_test
    from bonai_tpu_torch.models.detectors import two_stage
    attr, fwd_name, _ = ROUTES["block"]
    weights = os.path.join(TTA_DIR, "loft_foa_init.pth")
    _calibrated_weights(CONFIG, weights)
    model = init_detector(_config("block"), weights, seed=0)
    r = np.random.RandomState(0)
    img, img_shape, scale, _ = prepare_batch(model, [
        r.randint(0, 256, (SIZE, SIZE, 3), np.uint8) for _ in range(BATCH)])
    max_per_img = _max_dets(model)
    model.simple_test(img, img_shape, scale)              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.simple_test(img, img_shape, scale)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    out = {}
    for label, mode, views, calls in TTA_RUNS:
        run = port_test.tta_runner(model, dict(views, mode=mode))
        run(img, img_shape, scale)                        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stages = {}
        undo = [_timed(two_stage, "multiclass_nms", stages),
                _timed(port_test, "merge_flip_tta", stages)]
        _zero_counts()
        try:
            t0 = time.perf_counter()
            res = run(img, img_shape, scale)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            for u in undo:
                u()
        counts = _counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        _check_counts(counts, {fwd_name: calls}, f"tta {label}, 1 batch")
        _check_outputs(res, BATCH, max_per_img, model)
        out[label] = dict(launches=counts[fwd_name], ms=ms, peak_gib=peak)
        print(f"tta {label} ({mode} level, views {views}): 1024^2 B={BATCH} "
              f"{ms:.1f} ms a batch against simple_test's {plain_ms:.1f} "
              f"(ratio {ms / plain_ms:.2f}); soft-NMS "
              f"{stages.get('multiclass_nms', 0.0):.1f} ms, merges "
              f"{stages.get('merge_flip_tta', 0.0):.1f} ms of it; peak "
              f"{peak:.2f} GiB; valid detections "
              f"{res['det_valid'].sum(1).tolist()}; launches {counts}",
              flush=True)

    # the small float32 input through both levels, kernel against plain
    kernel_fn = getattr(two_stage, attr)
    with _reproducible_convs():
        model.float()
        model.cfg.data.test.pipeline[1].img_scale = (320, 320)
        small = [r.randint(0, 256, (256, 320, 3), np.uint8) for _ in range(2)]
        img_s, shp_s, sf_s, _ = prepare_batch(model, small)
        for mode in ("det", "proposal"):
            run = port_test.tta_runner(model, dict(TTA_DEFAULT, mode=mode))
            launched = kernel_fn.launches
            got = run(img_s, shp_s, sf_s)
            if kernel_fn.launches != launched + 9:
                raise AssertionError(f"tta small input ({mode}): "
                                     f"{kernel_fn.launches - launched} "
                                     f"launches, expected 9")
            setattr(two_stage, attr, _plain_route("block"))
            try:
                ref = run(img_s, shp_s, sf_s)
            finally:
                setattr(two_stage, attr, kernel_fn)
            worst, moved = _match_detections(got, ref, f"tta small input "
                                                       f"({mode})")
            print(f"tta small float32 input, {mode} level, kernel vs plain "
                  f"route: largest difference {worst:.3g} of each output's "
                  f"largest; {int(ref['det_valid'].sum())} valid "
                  f"detections, {moved} paired out of place", flush=True)
    del model
    torch.cuda.empty_cache()
    return out


def tta_files(checkpoint):
    """Test-time augmentation and rotation from files: the BONAI test CLI
    with ``--aug-test`` (detection level, the default horizontal and
    vertical flips) on the data phase's checkpoint over two of the eval
    phase's val crops, and the evaluation CLI on its pkl; then the train
    CLI ``ATTR_FILES_STEPS`` steps of the ``attr`` configuration with
    ``RandomRotate(rotate_ratio=1.0, angles='any')`` after ``RandomFlip``
    on the data phase's tiles with their maps (thread loader), every loss
    finite, at least one angle off the multiples of 90.  Returns the
    launches of both."""
    import numpy as np
    import torch
    from bonai_tpu_torch.config import Config
    from bonai_tpu_torch.datasets.pipelines.transforms import RandomRotate
    from bonai_tpu_torch.tools import bonai_evaluation, bonai_test
    from bonai_tpu_torch.tools import train as train_cli
    from bonai_tpu_torch.tools.make_synthetic_bonai import (
        write_attribute_maps, write_split, write_scene_split)
    _, fwd_name, bwd_name = ROUTES["block"]
    crops = os.path.join(DATA_DIR, "val", "val.json")
    if not os.path.exists(crops):
        write_scene_split(DATA_DIR, "val", 1, 77, scene_size=2048, crop=SIZE)
    cfg_path = os.path.join(TTA_DIR, os.path.basename(SYNTH_CONFIG))
    _synth_config(test=True).dump(cfg_path)
    pkl = os.path.join(TTA_DIR, "tta.pkl")
    _zero_counts()
    t0 = time.perf_counter()
    payload = bonai_test.main([cfg_path, checkpoint, "--out", pkl, "--city",
                               "config", "--max-images", "2", "--aug-test"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_counts = _counts()
    _check_counts(cli_counts, {fwd_name: 9}, "tta BONAI test CLI, 1 batch")
    results = payload["results"]
    if len(results) != 2 or not all(
            isinstance(res, tuple) and len(res) == 3
            and len(res[2]) == len(res[0][0]) == len(res[1][0])
            and np.isfinite(res[0][0]).all() and np.isfinite(res[2]).all()
            for res in results):
        raise AssertionError("the tta test CLI's results are not (bbox, "
                             "segm, offsets) 3-tuples")
    thr = _top_thr(results)
    t0 = time.perf_counter()
    summary = bonai_evaluation.main([pkl, "--gt-json", crops,
                                     "--score-thr", str(thr)])
    eval_s = time.perf_counter() - t0
    print(f"tta files: BONAI test CLI --aug-test {cli_s:.1f} s (model "
          f"build, 2 val crops, 3 views, bf16), detections "
          f"{[len(res[0][0]) for res in results]}; launches {cli_counts}; "
          f"evaluation CLI of the best {EVAL_TOP} (score_thr {thr:.4f}) "
          f"{eval_s:.1f} s: {_scores(summary)}", flush=True)

    train_dir = os.path.join(DATA_DIR, "train")
    if not os.path.exists(os.path.join(train_dir, "train.json")):
        write_split(DATA_DIR, "train", 8, 0, SIZE)
    side, field = write_attribute_maps(DATA_DIR, "train")
    cfg = Config.fromfile(_attr_config())
    for split in (cfg.data.train,):
        split.update(ann_file=os.path.join(train_dir, "train.json"),
                     img_prefix=os.path.join(train_dir, "images") + "/",
                     side_face_prefix=side + "/",
                     offset_field_prefix=field + "/")
    pipeline = cfg.data.train.pipeline
    flip = [i for i, t in enumerate(pipeline) if t.type == "RandomFlip"][0]
    pipeline.insert(flip + 1, dict(type="RandomRotate", rotate_ratio=1.0,
                                   angles="any"))
    cfg.data.update(workers_per_gpu=2, loader_mode="thread")
    weights = os.path.join(TTA_DIR, "attr_init.pth")
    _calibrated_weights(_attr_config(), weights)
    cfg.load_from = weights
    cfg.log_config = dict(interval=1)
    rot_dir = os.path.join(TTA_DIR, "wd")
    cfg_path = os.path.join(TTA_DIR, "attr_rotate.py")
    cfg.dump(cfg_path)
    angles = []
    draw = RandomRotate.draw_angle

    def recorded(self, rng):
        angle = draw(self, rng)
        angles.append(angle)
        return angle
    RandomRotate.draw_angle = recorded
    _zero_counts()
    try:
        os.makedirs(rot_dir)
        t0 = time.perf_counter()
        with open(os.path.join(rot_dir, "stdout.txt"), "w") as f, \
                contextlib.redirect_stdout(f):
            train_cli.main([cfg_path, "--work-dir", rot_dir, "--max-steps",
                            str(ATTR_FILES_STEPS), "--n-devices", "1"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        RandomRotate.draw_angle = draw
    counts = _counts()
    step_calls = ATTR_CALLS["attr"][1]
    _check_counts(counts, {fwd_name: step_calls * ATTR_FILES_STEPS,
                           bwd_name: step_calls * ATTR_FILES_STEPS},
                  f"rotated attr training, {ATTR_FILES_STEPS} steps")
    with open(os.path.join(rot_dir, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    keys = [k for k in rows[0] if k.startswith("loss")]
    if len(rows) != ATTR_FILES_STEPS or not all(
            np.isfinite(row[k]) for row in rows for k in keys):
        raise AssertionError(f"rotated attr training: log rows {rows}")
    print(f"tta files: RandomRotate drew {angles} (the loader's draws, "
          f"prefetch included)", flush=True)
    if not any(a is not None and a % 90 for a in angles):
        raise AssertionError("RandomRotate drew no angle off the multiples "
                             "of 90: its general path did not run")
    print(f"tta files: rotated attr train CLI {ATTR_FILES_STEPS} steps in "
          f"{train_s:.1f} s incl. set-up; ms per step "
          f"{[round(row['time'] * 1e3, 1) for row in rows]}, data_time ms "
          f"{[round(row['data_time'] * 1e3, 1) for row in rows]}; "
          + " ".join(f"{k} {rows[-1][k]:.4g}" for k in keys)
          + f"; launches {counts}", flush=True)
    return dict(test_cli=cli_counts[fwd_name], fwd=counts[fwd_name],
                bwd=counts[bwd_name])


def tta_phase(checkpoint):
    """Test-time augmentation and rotated training: :func:`tta_serve`, then
    :func:`tta_files` on the data phase's ``checkpoint`` (``main`` sets a
    copy aside, ``TTA_CHECKPOINT``, which the tools phase uses and
    removes).  Returns the launch counts, times and peaks."""
    t0 = time.time()
    shutil.rmtree(TTA_DIR, ignore_errors=True)
    os.makedirs(TTA_DIR)
    out = dict(serve=tta_serve(), files=tta_files(checkpoint))
    print(f"tta phase: {time.time() - t0:.1f} s; card "
          f"{_gpu_name_and_power()}", flush=True)
    shutil.rmtree(TTA_DIR, ignore_errors=True)
    return out


_RELOAD = """
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from bonai_tpu_torch import ops
from bonai_tpu_torch.tools.export_model import load_exported
t0 = time.perf_counter()
run = load_exported(sys.argv[2])
load_s = time.perf_counter() - t0
img = torch.load(sys.argv[3]).cuda()
with torch.no_grad():
    run(img)
    torch.cuda.synchronize()
    for fn in (ops.roi_align_block, ops.roi_align_block_backward,
               ops.roi_align_fused, ops.roi_align_fused_backward,
               ops.roi_align_strip):
        fn.launches = 0
    ms = []
    for _ in range(int(sys.argv[5])):
        t0 = time.perf_counter()
        out = run(img)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
torch.save({k: v.cpu() for k, v in out.items()}, sys.argv[4])
print(json.dumps({"launches": ops.launch_counts(), "ms": ms,
                  "load_s": load_s}))
"""


def _serve_files(model, crops, label):
    """``inference_detector`` on the B=2 batch ``crops``, its launches
    zeroed just before and read just after (3 of B1).  Returns the host
    results and the launches."""
    import torch
    from bonai_tpu_torch.apis import inference_detector
    _, fwd_name, _ = ROUTES["block"]
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    results = inference_detector(model, crops)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = _counts()
    _check_counts(counts, {fwd_name: 3}, f"tools: {label}, 1 batch")
    print(f"tools: {label}: inference_detector 1024^2 B={len(crops)} "
          f"{ms:.1f} ms (the model's first call: test pipeline, "
          f"simple_test, paste + RLE); "
          f"detections {[len(r[0][0]) for r in results]}; launches {counts}",
          flush=True)
    return results, counts[fwd_name]


def _same_results(got, want, what):
    """Host results of two serve runs of the same weights: the same
    detections, boxes and offsets within 1e-4 of their largest value."""
    import numpy as np
    for g, w in zip(got, want):
        for k in (0, 2):
            a = np.asarray(g[k][0] if k == 0 else g[k], np.float32)
            b = np.asarray(w[k][0] if k == 0 else w[k], np.float32)
            if a.shape != b.shape or not np.abs(a - b).max(initial=0.0) \
                    <= 1e-4 * max(np.abs(b).max(initial=0.0), 1.0):
                raise AssertionError(f"{what}: output {k} differs")


def _fused_small_check(pairs, r):
    """Each ``(label, unfused, fused, bound)`` checkpoint pair of the
    synthetic recipe on a small float32 input (TF32 off, deterministic
    cuDNN): the FPN levels, and every RoI branch's outputs on the unfused
    model's proposals (through B1), within ``bound`` of each output's
    largest value."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import init_detector, prepare_batch
    from bonai_tpu_torch.models.detectors import two_stage
    cfg = _synth_config(test=True)
    cfg.data.test.pipeline[1].img_scale = (320, 320)
    small = [r.randint(0, 256, (256, 320, 3), np.uint8) for _ in range(2)]
    with _reproducible_convs(), torch.inference_mode():
        for label, unfused, fused, bound in pairs:
            models = [init_detector(cfg, c, dtype=torch.float32)
                      for c in (unfused, fused)]
            img, img_shape, _, _ = prepare_batch(models[0], small)
            feats = [m.extract_feat(img) for m in models]
            props, _, pvalid = models[0]._rpn_and_proposals(
                feats[0], img_shape, dict(models[0].test_cfg["rpn"]))
            rois, rvalid = two_stage.boxes_to_rois(props, pvalid)
            ref, got = ([*f, *(o for _, branch, _ in _branches(m)
                               for o in branch(f, rois, rvalid))]
                        for m, f in zip(models, feats))
            worst = 0.0
            for g, e in zip(got, ref):
                err = float((g.float() - e.float()).abs().max())
                scale = max(float(e.float().abs().max()), 1.0)
                worst = max(worst, err / scale)
                if not err <= bound * scale:
                    raise AssertionError(f"tools: fused {label} differs by "
                                         f"{err} (outputs up to {scale})")
            print(f"tools: fused vs unfused {label}, small float32 input: "
                  f"{len(ref)} outputs (FPN levels, RoI branches on "
                  f"{int(rvalid.sum())} proposals), largest difference "
                  f"{worst:.3g} of each output's largest (bound {bound:g})",
                  flush=True)
            del models


def tools_export(cfg, checkpoint, crop):
    """``export_detector`` of LOFT-FOA R50-FPN at B=1, 1024^2, bf16, saved;
    the program loaded in a fresh process, its call's launches counted
    there (3 of B1 a call, ``TOOLS_TIMED`` timed calls) and its outputs
    held to eager ``simple_test``'s within 1e-4 of each output's largest
    value.  Returns B1's launches a call there."""
    import torch
    from bonai_tpu_torch.apis import init_detector, prepare_batch
    from bonai_tpu_torch.tools.export_model import export_detector
    _, fwd_name, _ = ROUTES["block"]
    model = init_detector(cfg, checkpoint)
    t0 = time.perf_counter()
    program = export_detector(model, SIZE, 1)
    export_s = time.perf_counter() - t0
    path = os.path.join(TOOLS_DIR, "loft_foa.pt2")
    torch.export.save(program, path)
    save_s = time.perf_counter() - t0 - export_s
    graph_ops = sorted({str(n.target) for n in program.graph.nodes
                        if n.op == "call_function"
                        and str(n.target).startswith("bonai_tpu_torch")})
    if "bonai_tpu_torch.roi_align_levels.default" not in graph_ops:
        raise AssertionError(f"the exported graph holds {graph_ops}")
    img = prepare_batch(model, [crop])[0]
    shp = torch.full((1, 2), float(SIZE), device="cuda")
    one = torch.ones(1, device="cuda")
    model.simple_test(img, shp, one)                      # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    eager_ms = []
    for _ in range(TOOLS_TIMED):
        t0 = time.perf_counter()
        eager = model.simple_test(img, shp, one)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    _check_counts(_counts(), {fwd_name: 3 * TOOLS_TIMED},
                  f"tools: eager simple_test, {TOOLS_TIMED} calls")
    img_path = os.path.join(TOOLS_DIR, "img.pt")
    out_path = os.path.join(TOOLS_DIR, "reloaded.pt")
    torch.save(img.cpu(), img_path)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _RELOAD, REPO, path,
                           img_path, out_path, str(TOOLS_TIMED)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"the reload process failed:\n{proc.stderr}")
    proc_s = time.perf_counter() - t0
    run = json.loads(proc.stdout.strip().splitlines()[-1])
    counts = _by_kernel(run["launches"])
    _check_counts(counts, {fwd_name: 3 * TOOLS_TIMED},
                  f"tools: the reloaded program, {TOOLS_TIMED} calls")
    got = torch.load(out_path)
    if set(got) != set(eager):
        raise AssertionError(f"reloaded outputs {sorted(got)}")
    worst = 0.0
    for k, v in eager.items():
        g, e = got[k].cuda(), v
        if not e.is_floating_point():
            if not torch.equal(g, e):
                raise AssertionError(f"reloaded {k} differs")
            continue
        err = float((g.float() - e.float()).abs().max())
        scale = max(float(e.float().abs().max()), 1.0)
        worst = max(worst, err / scale)
        if not err <= 1e-4 * scale:
            raise AssertionError(f"reloaded {k} differs by {err}")
    print(f"tools: export_detector 1024^2 B=1 bf16 {export_s:.1f} s, "
          f"torch.export.save {save_s:.1f} s "
          f"({os.path.getsize(path) / 2 ** 20:.1f} MiB; graph ops "
          f"{graph_ops}); reloaded in a fresh process ({proc_s:.1f} s, "
          f"torch.export.load {run['load_s']:.1f} s): ms a call "
          f"{[round(x, 1) for x in run['ms']]} (median "
          f"{statistics.median(run['ms']):.1f}) against eager "
          f"simple_test's {[round(x, 1) for x in eager_ms]} (median "
          f"{statistics.median(eager_ms):.1f}; warm, synchronised); largest "
          f"difference {worst:.3g} of each output's largest; valid "
          f"detections {int(eager['det_valid'].sum())}; launches {counts}",
          flush=True)
    del model
    return counts[fwd_name] // TOOLS_TIMED


def tools_masks(results):
    """The mask library against its numpy versions on the eval phase's
    RLEs: decode, encode and ``mask_iou``, equal to the element, both
    timed."""
    import numpy as np
    from bonai_tpu_torch.datasets import mask_utils
    rles = [m for res in results for m in res[1][0]][:TOOLS_MASKS]
    times = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        times[label] = time.perf_counter() - t0
        return out
    dec = {native: timed(f"decode {native}", lambda: [
        mask_utils.decode_mask(r, native=native) for r in rles])
        for native in (True, False)}
    enc = {native: timed(f"encode {native}", lambda: [
        mask_utils.encode_mask(m, native=native) for m in dec[True]])
        for native in (True, False)}
    iou = {native: timed(f"iou {native}", lambda: mask_utils.mask_iou(
        rles, rles, native=native)) for native in (True, False)}
    if not (all(np.array_equal(a, b) for a, b in zip(dec[True], dec[False]))
            and enc[True] == enc[False] == rles
            and np.array_equal(iou[True], iou[False])):
        raise AssertionError("the mask library differs from numpy")
    print(f"tools: mask library vs numpy on {len(rles)} of the eval phase's "
          f"1024^2 masks, equal: decode {times['decode True']:.3f} / "
          f"{times['decode False']:.3f} s, encode "
          f"{times['encode True']:.3f} / {times['encode False']:.3f} s, "
          f"mask_iou {len(rles)}x{len(rles)} {times['iou True']:.3f} / "
          f"{times['iou False']:.3f} s ({int((iou[True] > 0).sum())} "
          f"overlapping pairs)", flush=True)


def _echoed(fn, *args):
    """``fn(*args)`` with its standard output captured, echoed, and
    returned beside its result."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    text = buf.getvalue()
    print(text, end="", flush=True)
    return out, text


def _no_launches(what):
    counts = _counts()
    _check_counts(counts, {}, what)
    return counts


@contextlib.contextmanager
def _served_runs():
    """The results of every ``run_inference`` that ``tools/
    test_robustness.py`` makes while open, in order."""
    from bonai_tpu_torch.tools import test_robustness
    real, runs = test_robustness.run_inference, []

    def recorded(*args, **kwargs):
        runs.append(real(*args, **kwargs))
        return runs[-1]

    test_robustness.run_inference = recorded
    try:
        yield runs
    finally:
        test_robustness.run_inference = real


def _corruptions_served(runs, names, what):
    """The clean run's detections (``runs[0]``) against each corruption's
    (``runs[1:]``, in ``names``' order): a corruption that did not reach
    the served images would give the clean run's boxes and scores."""
    import numpy as np

    def boxes(results):
        return [np.asarray((r[0] if isinstance(r, tuple) else r)[0])
                for r in results]

    if len(runs) != 1 + len(names):
        raise AssertionError(f"{what}: {len(runs)} served runs for "
                             f"{len(names)} corruptions and the clean one")
    clean = boxes(runs[0])
    same = [name for name, run in zip(names, runs[1:])
            if all(a.shape == b.shape and np.array_equal(a, b)
                   for a, b in zip(boxes(run), clean))]
    if same:
        raise AssertionError(f"{what}: {same} served the clean images' "
                             f"detections")


def datasets_robustness(checkpoint):
    """``tools/test_robustness.py`` on LOFT-FOA with ``checkpoint`` over
    ``ROBUST_TILES`` of the eval phase's val crops: the clean run and the
    15 benchmark corruptions at ``ROBUST_SEVERITY``; each corruption's
    detections must differ from the clean run's.  Returns B1's
    launches."""
    import pickle
    import numpy as np
    from bonai_tpu_torch.datasets.pipelines.corrupt import corrupt_image
    from bonai_tpu_torch.tools import test_robustness
    from bonai_tpu_torch.utils.png import read_png
    val = os.path.join(DATA_DIR, "val")
    with open(os.path.join(val, "val.json")) as f:
        crops = json.load(f)
    crops["images"] = crops["images"][:ROBUST_TILES]
    keep = {im["id"] for im in crops["images"]}
    crops["annotations"] = [a for a in crops["annotations"]
                            if a["image_id"] in keep]
    ann_file = os.path.join(DATASETS_DIR, "robust_val.json")
    with open(ann_file, "w") as f:
        json.dump(crops, f)
    tile = read_png(os.path.join(val, "images",
                                 crops["images"][0]["file_name"]))
    host_ms = {}
    for name in test_robustness.BENCHMARK_CORRUPTIONS:
        t0 = time.perf_counter()
        out = corrupt_image(tile, name, ROBUST_SEVERITY,
                            np.random.RandomState(0))
        host_ms[name] = round((time.perf_counter() - t0) * 1e3, 1)
        if out.shape != tile.shape or out.dtype != np.uint8:
            raise AssertionError(f"{name}: {out.shape} {out.dtype}")
    print(f"datasets: corruption host ms per {SIZE}^2 tile at severity "
          f"{ROBUST_SEVERITY}: {host_ms}; card {_gpu_name_and_power()}",
          flush=True)
    cfg = _synth_config(test=True)
    cfg.data.test.ann_file = ann_file
    cfg_path = os.path.join(DATASETS_DIR, "robust.py")
    cfg.dump(cfg_path)
    out = os.path.join(DATASETS_DIR, "robust.pkl")
    runs = 1 + len(test_robustness.BENCHMARK_CORRUPTIONS)
    _zero_counts()
    t0 = time.perf_counter()
    with _served_runs() as served:
        agg, text = _echoed(test_robustness.main, [
            cfg_path, checkpoint, "--out", out, "--corruptions",
            "benchmark", "--severities", "0", str(ROBUST_SEVERITY),
            "--max-images", str(ROBUST_TILES)])
    torch_s = time.perf_counter() - t0
    fwd = ROUTES["block"][1]
    counts = _counts()
    _check_counts(counts, {fwd: 3 * ROBUST_TILES * runs},
                  f"test_robustness, {runs} runs of {ROBUST_TILES} batches")
    _corruptions_served(served, test_robustness.BENCHMARK_CORRUPTIONS,
                        "test_robustness")
    with open(out, "rb") as f:
        saved = pickle.load(f)
    if saved != agg or list(saved) != test_robustness.BENCHMARK_CORRUPTIONS:
        raise AssertionError(f"the pkl holds {list(saved)}")
    for name, by_sev in saved.items():
        if list(by_sev) != [0, ROBUST_SEVERITY] or any(
                set(e) != {"bbox"} or not {"AP", "AP50", "AP75"} <= set(
                    e["bbox"]) or not all(np.isfinite(v) for v in
                                          e["bbox"].values())
                for e in by_sev.values()):
            raise AssertionError(f"{name}: {by_sev}")
    for table in ("Performance on Clean Data [P] (bbox)",
                  "Mean Performance under Corruption [mPC] (bbox)",
                  "Relative Performance under Corruption [rPC] (bbox)"):
        if table not in text:
            raise AssertionError(f"test_robustness printed no {table!r}")
    print(f"datasets: test_robustness {runs} runs x {ROBUST_TILES} tiles in "
          f"{torch_s:.1f} s ({torch_s / runs:.2f} s a run incl. corruption, "
          f"serve and COCO scoring); clean bbox AP "
          f"{saved['fog'][0]['bbox']['AP']:.4f}; each corruption's "
          f"detections differ from the clean run's; B1 {counts[fwd]} "
          f"launches", flush=True)
    return counts[fwd]


def _files_run(label, config, cfg, weights):
    """``DATASETS_STEPS`` steps of ``train_detector`` on ``cfg`` (its
    files) from ``weights``, every loss finite and no kernel launched.
    Returns the checkpoint, the step ms and the losses."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import train_detector
    from bonai_tpu_torch.engine import latest_checkpoint
    work_dir = os.path.join(DATASETS_DIR, label, "wd")
    shutil.rmtree(work_dir, ignore_errors=True)
    cfg.data.workers_per_gpu = 2
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    _, hist = train_detector(cfg, None, work_dir, seed=0,
                             max_steps=DATASETS_STEPS, log_interval=1,
                             n_devices=1, load_from=weights)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _no_launches(f"{label} train from files")
    keys = [k for k in hist[0] if k.split(".")[-1].startswith("loss")]
    if len(hist) != DATASETS_STEPS or not all(
            np.isfinite(h[k]) for h in hist for k in keys + ["grad_norm"]):
        raise AssertionError(f"{label}: log rows {hist}")
    print(f"datasets {label}: train_detector from files "
          f"({config[len(REPO) + 1:]}, B={cfg.data.samples_per_gpu}), "
          f"{DATASETS_STEPS} steps in {wall:.1f} s incl. set-up; ms per step "
          f"{[round(h['time'] * 1e3, 1) for h in hist]}; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          + " ".join(f"{k} {hist[-1][k]:.4g}" for k in keys), flush=True)
    return latest_checkpoint(work_dir)


def datasets_voc():
    """Pascal VOC from JPEG files: the converter, the JPEG codec's times
    and round trip, 2 training steps, one scored test batch and the VOC
    branch of ``test_robustness``."""
    import pickle
    import numpy as np
    from bonai_tpu_torch.config import Config
    from bonai_tpu_torch.apis.test import test_split
    from bonai_tpu_torch.datasets import build_dataset
    from bonai_tpu_torch.tools import test_robustness
    from bonai_tpu_torch.tools.convert_datasets import pascal_voc
    from bonai_tpu_torch.tools.make_synthetic_datasets import make_voc
    from bonai_tpu_torch.utils.jpeg import (encode_jpeg, jpeg_round_trip,
                                            read_jpeg)
    from bonai_tpu_torch.utils.png import read_png
    root = os.path.join(DATASETS_DIR, "voc", "VOCdevkit")
    t0 = time.perf_counter()
    voc_dir, split = make_voc(root, n=4, size=(375, 500), seed=0)
    gen_s = time.perf_counter() - t0
    with open(split) as f:
        ids = f.read().split()
    with open(os.path.join(os.path.dirname(split), "test.txt"), "w") as f:
        f.write("\n".join(ids[:2]) + "\n")
    jpgs = [os.path.join(voc_dir, "JPEGImages", i + ".jpg") for i in ids]
    dec_ms = []
    for path in jpgs:
        t0 = time.perf_counter()
        read_jpeg(path)
        dec_ms.append((time.perf_counter() - t0) * 1e3)
    crop = read_png(os.path.join(DATA_DIR, "val", "images", sorted(
        os.listdir(os.path.join(DATA_DIR, "val", "images")))[0]))
    big = {}
    for q in (15, 60, 95):
        t0 = time.perf_counter()
        data = encode_jpeg(crop, q)
        enc_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        decoded = read_jpeg(data)
        dec = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rt = jpeg_round_trip(crop, q)
        rt_ms = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(decoded, rt):
            raise AssertionError(f"read_jpeg(encode_jpeg(x, {q})) differs "
                                 f"from jpeg_round_trip(x, {q})")
        big[q] = (round(enc_ms, 1), round(dec, 1), round(rt_ms, 1),
                  len(data))
    voc_img = read_jpeg(jpgs[0])
    if not np.array_equal(read_jpeg(encode_jpeg(voc_img, 40)),
                          jpeg_round_trip(voc_img, 40)):
        raise AssertionError("VOC image: round trip differs")
    print(f"datasets voc: 4 VOC2007 images of 500x375 written in "
          f"{gen_s:.2f} s; read_jpeg ms each {[round(x, 1) for x in dec_ms]}"
          f"; a {SIZE}^2 val crop at quality 15 / 60 / 95: (encode ms, "
          f"read_jpeg ms, jpeg_round_trip ms, bytes) {big}, the decodes equal"
          f" to the round trips; card {_gpu_name_and_power()}", flush=True)
    ann_json = os.path.join(DATASETS_DIR, "voc", "voc07_trainval.json")
    n_img, n_ann = pascal_voc.convert(voc_dir, "trainval", ann_json)
    load = [dict(type="LoadImageFromFile"),
            dict(type="LoadAnnotations", with_bbox=True)]
    xml = build_dataset(dict(type="VOCDataset", ann_file=split,
                             img_prefix=voc_dir + "/", pipeline=load))
    coco = build_dataset(dict(type="CocoDataset", ann_file=ann_json,
                              img_prefix=voc_dir + "/", pipeline=load,
                              min_size=0))
    if n_img != 4 or len(xml) != len(coco) != 4 or any(
            not np.array_equal(xml.get_ann_info(i)["bboxes"],
                               coco.get_ann_info(i)["bboxes"])
            for i in range(4)):
        raise AssertionError("the converted json's boxes differ from "
                             "VOCDataset's")
    print(f"datasets voc: pascal_voc converter {n_img} images, {n_ann} "
          f"annotations; boxes equal to VOCDataset's", flush=True)
    weights = os.path.join(DATASETS_DIR, "voc", "calibrated.pth")
    _calibrated_weights(VOC_CONFIG, weights)
    cfg = Config.fromfile(VOC_CONFIG)
    train = cfg.data.train
    train.ann_file = [split] * len(train.ann_file)
    train.img_prefix = [voc_dir + "/"] * len(train.img_prefix)
    cfg.data.test.update(ann_file=os.path.join(os.path.dirname(split),
                                               "test.txt"),
                         img_prefix=voc_dir + "/")
    checkpoint = _files_run("voc", VOC_CONFIG, cfg, weights)
    # the 2-step weights score below the config's 0.05: serve at 0, so
    # that every image keeps detections (of its max_per_img) to score
    cfg.test_cfg.rcnn.score_thr = 0.0
    _zero_counts()
    t0 = time.perf_counter()
    dataset, results = test_split(cfg, checkpoint)
    serve_s = time.perf_counter() - t0
    _no_launches("voc test batch")
    # the results keep class 0's detections only, as the JAX test loop's
    # (ROADMAP.md queue C)
    if len(results) != 2 or any(
            len(r) != 1 or not 0 < len(r[0]) <= cfg.test_cfg.rcnn.max_per_img
            or not np.isfinite(r[0]).all() for r in results):
        raise AssertionError("voc: results of the test batch")
    m_ap = dataset.evaluate(results)["mAP"]
    if not 0 <= m_ap <= 1:
        raise AssertionError(f"voc mAP {m_ap}")
    print(f"datasets voc: one test batch (2 images at 1000x600, score_thr "
          f"0) through test_split in {serve_s:.1f} s incl. the model's load; "
          f"{sum(len(d) for d in results[0])} class-0 detections in the "
          f"first; "
          f"VOCDataset.evaluate mAP {m_ap:.4f}", flush=True)
    cfg_path = os.path.join(DATASETS_DIR, "voc", "voc.py")
    cfg.dump(cfg_path)
    out = os.path.join(DATASETS_DIR, "voc", "robust.pkl")
    _zero_counts()
    with _served_runs() as served:
        agg, text = _echoed(test_robustness.main, [
            cfg_path, checkpoint, "--out", out, "--corruptions",
            "jpeg_compression", "--severities", "0", "5"])
    _no_launches("voc test_robustness")
    _corruptions_served(served, ["jpeg_compression"], "voc test_robustness")
    with open(out, "rb") as f:
        saved = pickle.load(f)
    entries = saved.get("jpeg_compression", {})
    if saved != agg or list(entries) != [0, 5] or any(
            not isinstance(e, list) or len(e) != 1 or set(e[0]) != {"ap"}
            for e in entries.values()) or \
            "Mean Performance under Corruption [mPC] in AP50" not in text:
        raise AssertionError(f"voc test_robustness: {saved}")
    return m_ap


def datasets_cityscapes():
    """Cityscapes: the 16-bit tree, the converter, 2 training steps and
    one served test batch."""
    import numpy as np
    from bonai_tpu_torch.apis.test import test_split
    from bonai_tpu_torch.config import Config
    from bonai_tpu_torch.tools.convert_datasets import cityscapes
    from bonai_tpu_torch.tools.make_synthetic_datasets import \
        make_cityscapes_tree
    from bonai_tpu_torch.utils.png import read_png
    root = os.path.join(DATASETS_DIR, "cityscapes")
    t0 = time.perf_counter()
    make_cityscapes_tree(root, n=2, size=(1024, 2048), seed=0)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _echoed(cityscapes.main, [root, os.path.join(root, "annotations")])
    conv_s = time.perf_counter() - t0
    ann_file = os.path.join(root, "annotations",
                            "instancesonly_filtered_gtFine_train.json")
    with open(ann_file) as f:
        js = json.load(f)
    inst = read_png(os.path.join(root, "gtFine", "train", "aachen",
                                 "aachen_000000_000019_gtFine_instanceIds"
                                 ".png"), unchanged=True)
    cats = {a["category_id"] for a in js["annotations"]}
    if inst.dtype != np.uint16 or inst.max() < 26000 or len(
            js["images"]) != 2 or not cats <= {24, 25, 26} or 26 not in cats:
        raise AssertionError(f"cityscapes json: {len(js['images'])} images, "
                             f"categories {cats}, map {inst.dtype}")
    print(f"datasets cityscapes: 2 2048x1024 frames with 16-bit instanceIds "
          f"written in {gen_s:.1f} s; converted in {conv_s:.1f} s: "
          f"{len(js['annotations'])} instances, categories {sorted(cats)}",
          flush=True)
    weights = os.path.join(root, "calibrated.pth")
    _calibrated_weights(CITYSCAPES_CONFIG, weights)
    cfg = Config.fromfile(CITYSCAPES_CONFIG)
    prefix = os.path.join(root, "leftImg8bit", "train") + "/"
    cfg.data.train.dataset.update(ann_file=ann_file, img_prefix=prefix)
    cfg.data.test.update(ann_file=ann_file, img_prefix=prefix)
    checkpoint = _files_run("cityscapes", CITYSCAPES_CONFIG, cfg, weights)
    cfg.test_cfg.rcnn.score_thr = 0.0       # as the voc run serves
    _zero_counts()
    t0 = time.perf_counter()
    _, results = test_split(cfg, checkpoint, max_images=1)
    serve_s = time.perf_counter() - t0
    _no_launches("cityscapes test batch")
    boxes, masks = results[0][:2]
    if len(results) != 1 or len(boxes) != 1 or len(masks) != 1 or not len(
            boxes[0]) or len(masks[0]) != len(boxes[0]) or not np.isfinite(
                boxes[0]).all():
        raise AssertionError("cityscapes: results of the test batch")
    print(f"datasets cityscapes: one 2048x1024 test batch (score_thr 0) "
          f"through test_split in {serve_s:.1f} s incl. the model's load; "
          f"{len(boxes[0])} class-0 detections with their masks", flush=True)


def datasets_lvis():
    """LVIS v1 under ``ClassBalancedDataset``: its length against the
    closed form, 2 training steps, the 1203-class serve of one image."""
    import math
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import inference_detector, init_detector
    from bonai_tpu_torch.config import Config
    from bonai_tpu_torch.datasets import ClassBalancedDataset, build_dataset
    from bonai_tpu_torch.tools.make_synthetic_datasets import make_lvis
    from bonai_tpu_torch.utils.jpeg import read_jpeg
    root = os.path.join(DATASETS_DIR, "lvis")
    t0 = time.perf_counter()
    ann_file = make_lvis(root, n_images=2000, n_files=4, n_rare=6,
                         size=(480, 640), seed=0)
    gen_s = time.perf_counter() - t0
    cfg = Config.fromfile(LVIS_CONFIG)
    # the loader stacks a batch's images unpadded, as the JAX loader does,
    # so the multi-scale Resize trains one image a batch (ROADMAP.md C)
    cfg.data.samples_per_gpu = 1
    cfg.data.train.dataset.update(ann_file=ann_file, img_prefix=root + "/")
    cfg.data.test.update(ann_file=ann_file, img_prefix=root + "/")
    t0 = time.perf_counter()
    ds = build_dataset(cfg.data.train)
    build_s = time.perf_counter() - t0
    with open(ann_file) as f:
        js = json.load(f)
    cats = {}
    for a in js["annotations"]:
        cats.setdefault(a["image_id"], set()).add(a["category_id"])
    n = len(js["images"])
    freq = {}
    for s in cats.values():
        for c in s:
            freq[c] = freq.get(c, 0) + 1
    thr = cfg.data.train.oversample_thr
    repeats = [math.ceil(max(max(1.0, math.sqrt(thr / (freq[c] / n)))
                             for c in cats.get(im["id"], ())) if
                         cats.get(im["id"]) else 1.0) for im in js["images"]]
    if not isinstance(ds, ClassBalancedDataset) or len(ds) != sum(
            repeats) or max(repeats) < 2:
        raise AssertionError(f"ClassBalancedDataset of {len(ds)} against "
                             f"the closed form's {sum(repeats)}")
    print(f"datasets lvis: json of {n} images over 4 JPEGs written in "
          f"{gen_s:.1f} s; ClassBalancedDataset(oversample_thr={thr}) built "
          f"in {build_s:.1f} s: {len(ds)} entries, the closed form's "
          f"{sum(repeats)} (repeat factors up to {max(repeats)})",
          flush=True)
    weights = os.path.join(root, "calibrated.pth")
    _calibrated_weights(LVIS_CONFIG, weights)
    checkpoint = _files_run("lvis", LVIS_CONFIG, cfg, weights)
    model = init_detector(cfg, checkpoint)
    img = read_jpeg(os.path.join(root, "train2017", "000000000000.jpg"))
    _zero_counts()
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inference_detector(model, [img])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    _no_launches("lvis serve")
    boxes = out[0][0] if isinstance(out[0], tuple) else out[0]
    if len(boxes) != 1 or not all(np.isfinite(b).all() for b in boxes):
        raise AssertionError(f"lvis serve: {len(boxes)} classes")
    print(f"datasets lvis: 1203-class serve of one 640x480 image "
          f"(inference_detector, bf16, score_thr "
          f"{cfg.test_cfg.rcnn.score_thr}, max_per_img "
          f"{cfg.test_cfg.rcnn.max_per_img}), ms per call "
          f"{[round(x, 1) for x in ms]} (the first warm-up); "
          f"{sum(len(b) for b in boxes)} detections of class 0 kept (the "
          f"results keep class 0 only); card "
          f"{_gpu_name_and_power()}", flush=True)
    del model
    torch.cuda.empty_cache()
    return statistics.median(ms[1:])


def datasets_phase(checkpoint):
    """The non-BONAI datasets and the robustness benchmark at full width
    (the module's phase 24).  Returns B1's launches of the robustness
    run."""
    t_phase = time.time()
    shutil.rmtree(DATASETS_DIR, ignore_errors=True)
    os.makedirs(DATASETS_DIR)
    launches = datasets_robustness(checkpoint)
    datasets_voc()
    datasets_cityscapes()
    datasets_lvis()
    shutil.rmtree(DATASETS_DIR, ignore_errors=True)
    print(f"datasets phase: {time.time() - t_phase:.1f} s; card "
          f"{_gpu_name_and_power()}", flush=True)
    return launches


def tools_phase(checkpoint, eval_results):
    """The host tools on LOFT-FOA R50-FPN at full width (``'block'``,
    1024^2, the data phase's ``checkpoint``): ``fuse_conv_bn`` and
    ``publish_model`` on it, each file served through
    ``inference_detector`` (B=2, bf16, the eval phase's val crops, 3 B1
    launches a batch); the fold held to the unfused model on a small
    float32 input, on the checkpoint and on calibrated random weights (the
    checkpoint's BatchNorm statistics are the identity's);
    ``export_model``'s program reloaded in a fresh process
    (:func:`tools_export`); ``get_flops`` at 1024^2; the mask library on
    the eval phase's masks; ``show_result`` and ``browse_dataset`` on a
    crop; ``profile_time`` and ``device_trace`` around a serve call.
    Returns the launch counts of its runs."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import init_detector, prepare_batch
    from bonai_tpu_torch.tools import fuse_conv_bn, get_flops
    from bonai_tpu_torch.tools.browse_dataset import browse
    from bonai_tpu_torch.tools.publish_model import publish_model
    from bonai_tpu_torch.utils.collect_env import env_info_str
    from bonai_tpu_torch.utils.png import read_png
    from bonai_tpu_torch.utils.profiling import device_trace, profile_time
    from bonai_tpu_torch.utils.visualize import show_result
    t_phase = time.time()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    print("tools: collect_env: " + "; ".join(env_info_str().splitlines()),
          flush=True)
    cfg = _synth_config(test=True)
    val = os.path.join(DATA_DIR, "val", "images")
    crops = [read_png(os.path.join(val, f))
             for f in sorted(os.listdir(val))[:BATCH]]
    launches = {}

    fused = os.path.join(TOOLS_DIR, "fused.pth")
    fuse_conv_bn.main([checkpoint, fused])
    model = init_detector(cfg, checkpoint)
    served, launches["unfused_serve"] = _serve_files(
        model, crops, "the data phase's checkpoint")
    img, img_shape, scale, _ = prepare_batch(model, crops)
    with profile_time("tools", "simple_test 1024^2 B=2") as timed:
        model.simple_test(img, img_shape, scale)
    trace_dir = os.path.join(TOOLS_DIR, "trace")
    _zero_counts()
    with device_trace(trace_dir):
        model.simple_test(img, img_shape, scale)
    launches["traced_serve"] = _counts()[ROUTES["block"][1]]
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    b1 = [e for e in events if e.get("cat") == "kernel"
          and "roi_align_block_fwd" in e.get("name", "")]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    print(f"tools: profile_time {timed['ms']:.1f} ms; device_trace: "
          f"{len(events)} events, {kernels} kernels, B1 {len(b1)} "
          f"({sum(e.get('dur', 0) for e in b1) / 1e3:.4f} ms); trace.json "
          f"{os.path.getsize(os.path.join(trace_dir, 'trace.json')) / 2 ** 20:.1f}"
          f" MiB", flush=True)
    if len(b1) != 3 or launches["traced_serve"] != 3:
        raise AssertionError(f"the trace holds {len(b1)} B1 kernels, "
                             f"{launches['traced_serve']} launched")
    t0 = time.perf_counter()
    out = os.path.join(TOOLS_DIR, "show_result.png")
    drawn = show_result(crops[0], served[0], out_file=out)
    show_s = time.perf_counter() - t0
    if not (np.array_equal(read_png(out), drawn)
            and (drawn != crops[0]).any(-1).mean() > 0.001):
        raise AssertionError("show_result drew nothing")
    del model
    model = init_detector(cfg, fused)
    _, launches["fused_serve"] = _serve_files(model, crops,
                                              "the fused checkpoint")
    del model
    published = publish_model(checkpoint, os.path.join(TOOLS_DIR,
                                                       "loft_foa"))
    model = init_detector(cfg, published)
    got, launches["published_serve"] = _serve_files(
        model, crops, f"the published {os.path.basename(published)}")
    _same_results(got, served, "the published checkpoint")
    del model
    torch.cuda.empty_cache()

    calibrated = os.path.join(TOOLS_DIR, "calibrated.pth")
    _calibrated_weights(SYNTH_CONFIG, calibrated)
    calibrated_fused = os.path.join(TOOLS_DIR, "calibrated_fused.pth")
    fuse_conv_bn.main([calibrated, calibrated_fused])
    # the data phase's statistics are the identity's (trained with
    # norm_eval=False, frozen at their init): the fold changes nothing
    # there, and the plain-route bound holds.  The calibrated statistics
    # fold for real; the fold rounds each BatchNorm's affine once more in
    # float32, which the 53 BatchNorms and the heads carry to about 1e-4
    # of the largest output, as far as float32 rounding alone carries the
    # unfused model from its float64 self; a wrong fold differs by O(1)
    _fused_small_check((("data phase checkpoint", checkpoint, fused, 1e-4),
                        ("calibrated weights", calibrated, calibrated_fused,
                         1e-3)), np.random.RandomState(0))
    launches["reloaded_export"] = tools_export(cfg, checkpoint, crops[0])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, flops, lines = get_flops.get_flops(cfg, (SIZE, SIZE), "cuda")
    print(f"tools: get_flops ({time.perf_counter() - t0:.1f} s): "
          + "; ".join(lines), flush=True)
    tools_masks(eval_results)
    t0 = time.perf_counter()
    written = browse(_synth_config(), os.path.join(TOOLS_DIR, "browse"), 1)
    browse_s = time.perf_counter() - t0
    if len(written) != 1 or read_png(written[0]).shape != (SIZE, SIZE, 3):
        raise AssertionError(f"browse_dataset wrote {written}")
    print(f"tools: show_result on a 1024^2 crop ({len(served[0][0][0])} "
          f"detections) {show_s:.2f} s; browse_dataset, one train tile, "
          f"{browse_s:.2f} s; PNGs written", flush=True)
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    print(f"tools phase: {time.time() - t_phase:.1f} s; card "
          f"{_gpu_name_and_power()}", flush=True)
    return launches


def bench_phase():
    """The RoIAlign micro-benchmark, B5's entry point.  Returns B5's launch
    count of the run."""
    from bonai_tpu_torch.tools.bench_roi_align import main as bench
    _zero_counts()
    results = bench(["--iters", "3"])
    counts = _counts()
    print(f"bench: launches {counts}", flush=True)
    if not counts["roi_align_strip_fwd"]:
        raise AssertionError("bench_roi_align did not launch "
                             "roi_align_strip_fwd")
    for (route, branch), (fwd_ms, fwd_bwd_ms) in results.items():
        if (fwd_bwd_ms is None) != (route == "pallas") or not fwd_ms > 0:
            raise AssertionError(f"bench_roi_align {route} {branch}: fwd "
                                 f"{fwd_ms} ms, fwd+bwd {fwd_bwd_ms} ms")
    if len(results) != 4 * 3:
        raise AssertionError(f"bench_roi_align timed {sorted(results)}")
    return counts["roi_align_strip_fwd"]


def _entry(name, path, launches, sums, label=None, **extra):
    """The kernels line's entry of ``KERNELS[name]`` (``label``: the name
    it is shown under, else ``name``)."""
    source, replaces, _ = KERNELS[name]
    return {"name": label or name, "route": "cuda",
            "source": f"bonai_tpu_torch/csrc/{source}.cu",
            "replaces": replaces, "path": path, "launches": launches,
            "max_abs_err": sums.err, "ms": sums.ms,
            "device_ms": sums.device_ms, "plain_ms": sums.plain_ms,
            "bound_ms": sums.bound_ms, "bound_by": sums.bound_by,
            "library_ms": None, **extra}


# the phases that run beside the families' (processes of their own, or
# host-bound work): a child process of their own, started after the eval
# phase; argv: the repository, the card, the data phase's step ms, the
# eval phase's pickled results and the JSON file of their returns
BESIDE = """
import json, pickle, signal, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
# a SIGTERM unwinds the phases, whose cleanup stops what they started
signal.signal(signal.SIGTERM, lambda *_: sys.exit(1))
with open(sys.argv[4], "rb") as f:
    eval_results = pickle.load(f)
out, seconds = {}, {}
for name, fn, args in (
        ("resume", cs.resume_phase, ()),
        ("ddp", cs.ddp_phase, (sys.argv[2], float(sys.argv[3]))),
        ("datasets", cs.datasets_phase, (cs.TTA_CHECKPOINT,)),
        ("tools", cs.tools_phase, (cs.TTA_CHECKPOINT, eval_results))):
    t = time.time()
    out[name] = fn(*args)
    seconds[name] = round(time.time() - t, 1)
with open(sys.argv[5], "w") as f:
    json.dump(dict(out, seconds=seconds), f)
"""


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "bonai_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from bonai_tpu_torch.ops import _build

    card = _gpu_name_and_power()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.time()
    sources = sorted({source for source, *_ in KERNELS.values()})
    _build.build(sources)
    build_s = time.time() - t0
    print(f"build: {len(sources)} source(s) in {build_s:.1f} s", flush=True)
    for name in sources:
        log = (_build.BUILD_DIR / f"{name}.ptxas.txt")
        if log.exists():
            print(log.read_text().strip(), flush=True)

    phase_s = {}

    def timed(name, fn, *args):
        t = time.time()
        out = fn(*args)
        phase_s[name] = round(time.time() - t, 1)
        return out

    sums = timed("kernels", kernel_phase)
    serve_runs = timed("serve", lambda: {impl: serve_phase(impl)
                                         for impl in ("block", "pallas")})
    serve = {impl: run[0] for impl, run in serve_runs.items()}
    train = timed("train", lambda: {impl: train_phase(impl, steps)
                                    for impl, steps in (("block", 6),
                                                        ("pallas", 4))})
    files = timed("data", data_phase)
    # the tta, datasets and tools phases use the same checkpoint after
    # eval_phase removes it
    os.makedirs(os.path.dirname(TTA_CHECKPOINT), exist_ok=True)
    shutil.copyfile(files["checkpoint"], TTA_CHECKPOINT)
    test_cli_launches, eval_results = timed(
        "eval", eval_phase, files["checkpoint"], files["work_dir"])
    print(f"compare train: from files {files['step_ms']:.1f} ms a step vs "
          f"the repeated synthetic batch {train['block']['step_ms']:.1f} ms "
          f"(same route, this run); the loader gives "
          f"{files['cold']:.1f} images/s cold, {files['warm']:.1f} warm, "
          f"against {2e3 / files['step_ms']:.1f} images/s the step takes",
          flush=True)
    beside_files = [os.path.join(REPO, "build", f"chip_smoke_beside.{ext}")
                    for ext in ("pkl", "json")]
    with open(beside_files[0], "wb") as f:
        pickle.dump(eval_results, f)
    beside = _start([sys.executable, "-c", BESIDE, REPO, card,
                     str(files["step_ms"]), *beside_files],
                    os.path.join(REPO, "build", "chip_smoke_beside"))
    try:
        return _families(phase_s, timed, card, build_s, sums, serve_runs,
                         serve, train, files, test_cli_launches, beside,
                         beside_files[1])
    finally:
        _stop(beside)
        shutil.rmtree(os.path.dirname(TTA_CHECKPOINT), ignore_errors=True)


def _stop(proc, grace=30):
    """End a process of :func:`_start` that still runs: SIGTERM, so that
    it stops the processes it started in process groups of their own, then,
    after ``grace`` seconds, :func:`_kill`."""
    import signal
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(grace)
        except subprocess.TimeoutExpired:
            pass
    _kill([proc])


def _families(phase_s, timed, card, build_s, sums, serve_runs, serve, train,
              files, test_cli_launches, beside, beside_json):
    """:func:`main` from the loft phase on: the family phases, then the
    phases beside them (:data:`BESIDE`: their output printed, their
    returns read), the launch counts' checks and the result lines."""
    import torch
    loft = timed("loft", loft_phase)
    hrnet = timed("hrnet", hrnet_phase, serve_runs["block"][1],
                  train["block"]["step_ms"])
    rcnn = timed("rcnn", rcnn_phase)
    rcnn2 = timed("rcnn2", rcnn2_phase)
    rcnn3 = timed("rcnn3", rcnn3_phase)
    trunks = timed("trunks", trunks_phase)
    coco_trunks = timed("coco_trunks", coco_trunks_phase)
    coco_rcnn = timed("coco_rcnn", coco_rcnn_phase)
    coco_dense = timed("coco_dense", coco_dense_phase)
    cascades = timed("cascades", cascades_phase)
    dense = timed("dense", dense_phase)
    dense2 = timed("dense2", dense2_phase)
    dense3 = timed("dense3", dense3_phase)
    attr = timed("attr", attr_phase)
    tta = timed("tta", tta_phase, TTA_CHECKPOINT)
    bench_launches = timed("bench", bench_phase)
    t = time.time()
    (proc, beside_s), = _finish([beside], "the phases beside the families")
    print(proc.stdout, end="", flush=True)
    print(proc.stderr, end="", file=sys.stderr, flush=True)
    with open(beside_json) as f:
        beside = json.load(f)
    phase_s.update({f"{name} (beside)": v
                    for name, v in beside.pop("seconds").items()},
                   beside_wait=round(time.time() - t, 1),
                   beside_total=round(beside_s, 1))
    resume_launches, ddp, datasets, tools = (
        beside[k] for k in ("resume", "ddp", "datasets", "tools"))
    _check_counts({name: resume_launches.get(
        fn.__name__, 0) for name, (fn, _, _) in _kernels().items()},
        {"roi_align_block_fwd": 3 * RESUME_STEPS,
         "roi_align_block_bwd": 3 * RESUME_STEPS},
        f"chunked training, {RESUME_STEPS} steps in two processes")
    print(f"phase seconds: {phase_s}; build {build_s:.1f}; card {card}",
          flush=True)
    for fwd, bwd, impl in (("B1", "B2", "block"), ("B3", "B4", "pallas")):
        f_name, b_name = ROUTES[impl][1:]
        print(f"train ({impl}): {bwd} {sums[b_name, 'train'].ms:.4f} ms per "
              f"step in 3 launches, "
              f"{100 * sums[b_name, 'train'].ms / train[impl]['step_ms']:.2f}"
              f" % of the {train[impl]['step_ms']:.1f} ms step; {fwd} at the "
              f"training shapes {sums[f_name, 'train'].ms:.4f} ms per step",
              flush=True)
    for what, a, b in (("serve", "roi_align_fused_fwd", "roi_align_block_fwd"),
                       ("train", "roi_align_fused_fwd", "roi_align_block_fwd"),
                       ("train", "roi_align_strip_fwd", "roi_align_fused_fwd"),
                       ("train", "roi_align_fused_bwd", "roi_align_block_bwd")):
        print(f"compare {what}: {a} {sums[a, what].ms:.4f} ms vs {b} "
              f"{sums[b, what].ms:.4f} ms (ratio "
              f"{sums[a, what].ms / sums[b, what].ms:.3f}; same RoIs, "
              f"bounds {sums[a, what].bound_ms:.4f} / "
              f"{sums[b, what].bound_ms:.4f} ms)", flush=True)

    def c4_numbers(name, whats):
        """The kernel's numbers at the C4 layout's shape (the kernel
        phase's bf16 sums a batch or step)."""
        return {f"c4_{what}_{key}": getattr(sums[name, f"c4 {what}"], attr)
                for what in whats for key, attr in (
                    ("ms", "ms"), ("device_ms", "device_ms"),
                    ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms"),
                    ("bound_by", "bound_by"), ("max_abs_err", "err"))}

    def forward(name, impl, label=None, **extra):
        return _entry(name, f"serve and train ({impl})", serve[impl],
                      sums[name, "serve"], label,
                      train_launches=train[impl]["fwd"], **extra,
                      train_ms=sums[name, "train"].ms,
                      train_device_ms=sums[name, "train"].device_ms,
                      train_plain_ms=sums[name, "train"].plain_ms,
                      train_bound_ms=sums[name, "train"].bound_ms)
    # B3 and B4 (the strip route) run on B1's and B2's kernels, B5 on B1's
    entries = [
        forward("roi_align_block_fwd", "block",
                train_from_files_launches=files["fwd"],
                test_cli_launches=test_cli_launches,
                train_chunked_launches=resume_launches["roi_align_block"],
                ddp_rehearsal_launches=[c["roi_align_block_fwd"]
                                        for c in ddp["rehearsal"]],
                ddp_cli_launches=[c["roi_align_block_fwd"]
                                  for c in ddp["cli"]],
                ddp_test_launches=[c["roi_align_block_fwd"]
                                   for c in ddp["test"]],
                loft_serve_launches=loft["serve"],
                loft_train_launches=loft["train"]["fwd"],
                hrnet_serve_launches=hrnet["serve"],
                hrnet_train_launches=hrnet["train"]["fwd"],
                **{f"rcnn_{k}_serve_launches": r["serve"]
                   for k, r in rcnn.items()},
                **{f"rcnn_{k}_train_launches": r["train"]["fwd"]
                   for k, r in rcnn.items()},
                rcnn_mask_rcnn_test_cli_launches=rcnn["mask_rcnn"][
                    "test_cli"],
                **{f"rcnn_{k}_coco_cli_launches": rcnn[k]["coco_cli"]
                   for k in COCO_SCORED if k in rcnn},
                **{f"rcnn2_{k}_serve_launches": rcnn2[k]["serve"]
                   for k, _, _ in RCNN2_CONFIGS},
                **{f"rcnn2_{k}_train_launches": rcnn2[k]["train"]["fwd"]
                   for k, _, _ in RCNN2_CONFIGS},
                rcnn2_mask_scoring_coco_cli_launches=rcnn2["mask_scoring"][
                    "coco_cli"],
                **{f"rcnn2_files_{k}_launches": fwd
                   for k, (fwd, _) in rcnn2["files"].items()},
                rcnn2_double_head_reg_rois=rcnn2["double_head"]["window"],
                **{f"{phase}_{k}_{what}_launches": n
                   for phase, runs in (("rcnn3", rcnn3), ("trunks", trunks),
                                       ("coco_trunks", coco_trunks),
                                       ("coco_rcnn", coco_rcnn),
                                       ("coco_dense", coco_dense),
                                       ("cascades", cascades),
                                       ("dense2", dense2),
                                       ("dense3", dense3))
                   for k, r in runs.items()
                   for what, n in (("serve", r["serve"]),
                                   ("train", r["train"]["fwd"]),
                                   ("coco_cli", r["coco_cli"]))
                   if n is not None},
                **c4_numbers("roi_align_block_fwd", ("serve", "train")),
                **{f"dense_{k}_{what}_launches": n for k, r in dense.items()
                   for what, n in (("serve", r["serve"]),
                                   ("train", r["train"]["fwd"]),
                                   ("coco_cli", r["coco_cli"]))
                   if n is not None},
                **{f"{k}_{what}_launches": n for k in ATTR_CALLS
                   for what, n in (("serve", attr[k]["serve"]),
                                   ("train", attr[k]["train"]["fwd"]))},
                attr_files_train_launches=attr["files"]["fwd"],
                attr_test_cli_launches=attr["files"]["test_cli"],
                **{f"tta_{k.replace(' ', '_')}_serve_launches": r["launches"]
                   for k, r in tta["serve"].items()},
                tta_test_cli_launches=tta["files"]["test_cli"],
                tta_rotate_train_launches=tta["files"]["fwd"],
                datasets_robustness_launches=datasets,
                **{f"tools_{k}_launches": n for k, n in tools.items()}),
        _entry("roi_align_block_bwd", "train (block)", train["block"]["bwd"],
               sums["roi_align_block_bwd", "train"],
               train_from_files_launches=files["bwd"],
               train_chunked_launches=resume_launches[
                   "roi_align_block_backward"],
               ddp_rehearsal_launches=[c["roi_align_block_bwd"]
                                       for c in ddp["rehearsal"]],
               ddp_cli_launches=[c["roi_align_block_bwd"]
                                 for c in ddp["cli"]],
               loft_train_launches=loft["train"]["bwd"],
               hrnet_train_launches=hrnet["train"]["bwd"],
               **{f"rcnn_{k}_train_launches": r["train"]["bwd"]
                  for k, r in rcnn.items()},
               **{f"rcnn2_{k}_train_launches": rcnn2[k]["train"]["bwd"]
                  for k, _, _ in RCNN2_CONFIGS},
               rcnn2_files_fast_train_launches=rcnn2["files"][
                   "fast_train"][1],
               **{f"{phase}_{k}_train_launches": r["train"]["bwd"]
                  for phase, runs in (("rcnn3", rcnn3), ("trunks", trunks),
                                      ("coco_trunks", coco_trunks),
                                      ("coco_rcnn", coco_rcnn),
                                      ("coco_dense", coco_dense),
                                      ("cascades", cascades),
                                      ("dense2", dense2),
                                      ("dense3", dense3))
                  for k, r in runs.items()},
               **{f"dense_{k}_train_launches": r["train"]["bwd"]
                  for k, r in dense.items()},
               **{f"{k}_train_launches": attr[k]["train"]["bwd"]
                  for k in ATTR_CALLS},
               attr_files_train_launches=attr["files"]["bwd"],
               tta_rotate_train_launches=tta["files"]["bwd"],
               **c4_numbers("roi_align_block_bwd", ("train",))),
        forward("roi_align_fused_fwd", "pallas",
                "roi_align_block_fwd (strip rule)"),
        _entry("roi_align_fused_bwd", "train (pallas)",
               train["pallas"]["bwd"], sums["roi_align_fused_bwd", "train"],
               "roi_align_block_bwd (strip rule)"),
        _entry("roi_align_strip_fwd", "bonai_tpu_torch.tools.bench_roi_align",
               bench_launches, sums["roi_align_strip_fwd", "train"],
               "roi_align_block_fwd (window-64 rule)")]
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:               # any failed phase: no result line
        traceback.print_exc()
        sys.exit(1)
