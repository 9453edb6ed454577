#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU, the CUDA
toolkit (``nvcc``) and PyTorch. Phases, in order; any failure exits non-zero
before the last line is printed:

1. build the hand-written kernels K1 (``deform_im2col_windowed``), K2
   (``roi_align_fwd``), K3 (``deform_col2im_windowed``, K1's backward), K4
   (``roi_align_bwd``, K2's backward) and K5 (``deform_conv_fused``, the
   whole windowed-DCN forward behind the entry points
   ``deform_conv2d_windowed_fused`` and ``deform_conv2d_frame``) from
   ``dynamask_torch/ops/csrc`` (one ``nvcc`` per source, started together;
   each of K1-K4 with an fp32 and a bf16 instance), and count the
   tensor-core instructions (``HMMA``, ``HGMMA``) of K5's three instances
   in ``cuobjdump -sass`` of its library: the frame rule on bf16 must have
   some, the two fp32-rule instances none;
2. hold each kernel against its plain PyTorch version at the shapes the
   flagship's inference and training paths give it, and time both with CUDA
   events; the bf16 instances of K1-K4 (``<name>_bf16``) at the flagship's
   inference (n = 100) and training (n = 512) shapes on bf16 inputs, K1
   and K2 within one bf16 ulp of max|ref|, K3 within the fp32 rule plus
   that ulp, K4 (an fp32 sum) within the fp32 rule; K5 at the SFM shapes
   in fp32 and bf16 (n = 100 and 512), through each entry point with its
   rounding rule, timed beside
   the port's own form of the same function (K1 + ``torch.matmul``); K2
   and K4 also at the training crops with RoIs clustered as the training
   step makes them, and K2 at the inference crops on the 1344x800 portrait
   canvas that phase 6's portrait images use, and at the shapes of phase
   8's configurations (K1 at n = 300 for LVIS inference and at the 128
   mask slots of a Cityscapes step, K3 there too; K2 at LVIS's 300-det
   crops and on the 1024x2048 Cityscapes canvas, at inference and in
   training, K4 there in training, and K2 at the VOC config's box extract
   on its 1024x1024 canvas, phase 11's), and K2 and K4 at RefineMask's P2
   crops (phase 10's, ratio 2: the semantic features at C = 256/128/64
   and 14/28/56 and the one-channel semantic mask at each size; K2 and K4
   at a step's 512 RoIs, K2 also at an image's 100 dets on 800x1344 and
   on 1024x2048 and at LVIS's 300, where at C = 1 it cuts each RoI into
   bands), and K2 and K4 at HTC's semantic crops of a step (phase 12's:
   the 100x168x256 stride-8 plane of 4 images, ratio 1, 2048 RoIs at 7x7
   and 512 at 14x14), and K2 and K4 at GRoIE's all-level crops and
   Double-Head's two box crops (phase 13's: GRoIE's box extract of an
   image, 1000 RoIs x 4 levels, and of a step, 2048 x 4, its mask extract
   of a step, 512 x 4 at 14x14, Double-Head's 2048 RoIs of a step and the
   same enlarged 1.3x, in one launch), and K2 and K4 at HRFPN's crops
   (phase 15's: the 200x336 1x1-reduced map of an image and of a step's
   4 images average-pooled to P2-P5, an image's 1000 box and 100 mask
   RoIs, a step's 2048 and 512), and K1 and K3 on the whole maps of
   phase 17 (``map ...`` lines, every map of ``WHOLE_MAPS``: GA-RPN's
   P2-P6 and GA-RetinaNet's P3-P7 in 4 deform groups at C = 256, the
   stride-1 SAC branches of layer2-4 in one group at C = 128/256/512 and
   dilations 1 and 3, K1 at an image's and a step's, K3 at a step's, the
   step's SAC maps from zero offsets too, where K3's offset gradient
   must be exactly 0), on lines of their own kept out of the
   ``kernels`` line's sums; K1 and K3 also at edge shapes
   (ragged bands, one deform group, channels per group not a multiple of
   4, padding and dilation 2, windows 1 and 2, one RoI, a misaligned base)
   with random, zero and exact-edge offsets, K2 and K4 at theirs (C not a
   multiple of 4, one bin, three samples a bin, one RoI, a 1x1 plane, a
   misaligned base) with zero-area, off-plane and exact-edge RoIs, each of
   K1-K4 in fp32 and in bf16 (the bf16 scalar instances among them), and
   K5 at its own edge shapes, untimed; and CUDA tensors of a type no
   instance takes (fp16, or bf16 beside fp32) must be refused unlaunched;
3. check the port end to end on a small input: a toy DynaMask model, a
   toy Mask R-CNN (ResNet-18, 32-channel FPN, the FCN mask head), a
   toy RefineMask (32-channel semantic tower and stages), a box-only toy
   Faster R-CNN, two toy Mask R-CNNs at depth 50 on the ResNeXt-32x4d
   and the caffe-style backbones, a toy Cascade Mask R-CNN and a toy HTC
   (its semantic head at 32 channels, ``gt_semantic_seg`` in the step's
   batch, every stage's sampler draws given), a toy GN+WS Mask R-CNN (GN
   of 32 groups throughout, ``Shared4Conv1FCBBoxHead``), a toy GRoIE Mask
   R-CNN and a toy Double-Head Faster R-CNN on the GPU (kernels) against
   the same models on the CPU (plain versions), at inference and for one
   training step (losses and per-parameter gradients);
4. drive the inference path: DynaMask R50-FPN (``configs/dynamask/coco/
   r50_dynamask_1x.py``) at full width, random weights N(0, 0.05) from a
   seeded generator, one 800x1344 image in fp32, ``simple_test`` + mask paste
   in the faithful and the MSM-routed mode; then the three SFM
   ``fuse_conv_1`` inputs of a faithful drive go through both K5 entry
   points, each result held against the main path's DCN output;
5. drive the training path: the same config at full width with its own
   seeded initialisation (zero DCN offsets, as the JAX package), a seeded
   synthetic batch of 4 images at 800x1344 with 20 GTs each, fp32, on the
   host; one warm-up and three timed SGD steps, each a call of
   ``train_steps`` on the trainer from ``init_trainer``;
6. drive the COCO evaluation path: a seeded COCO-format set written to
   ``build/chip_smoke_coco/`` (8 noise JPEGs at COCO sizes, 3-10 polygon
   GTs each over 2-5 categories; the file lists all 80 ``COCO_CLASSES``)
   goes through
   ``build_dataset`` with the config's test pipeline, ``single_device_test``
   (the config's loader workers; ``simple_test`` + the paste on the
   dataset's mask canvas in original-image coordinates, on the card; one
   copy of each image's masks to the host) and ``CocoDataset.evaluate``
   (RLE by the C codec of ``dynamask_torch/native``, built with ``cc``
   into ``build/dynamask_torch_native/``), after one untimed pass: the
   flagship at random weights N(0, 0.05). It prints img/s end to end and
   its split (loader start-up, host pipeline + collate, device, copy, RLE,
   evaluate), checks one finite result per image, each valid det's mask
   through ``encode_mask`` -> ``decode_rle`` bit for bit, the C codec
   against the numpy codec byte for byte on every mask, and that the GTs
   given as predictions score bbox and segm mAP of exactly 1.0; then one
   ``train_steps`` step from a ``build_dataloader`` batch of 4 images of
   the set through the config's train pipeline, whose losses must be
   finite; the drive and the step held to their exact launches;
7. drive the training loop: (a) ``python -m dynamask_torch.tools.train``
   (its ``main``, in-process) on the flagship at full width from its own
   seeded initialisation, over a seeded 16-image COCO-format set in
   ``build/chip_smoke_coco_train/`` (four at each of phase 6's sizes: three
   landscape batches of 4 and one portrait an epoch), validating on phase
   6's set after each epoch, with ``total_epochs=2``, ``lr_config.step=
   [1]`` and logs, checkpoints and validation every epoch. Run A trains two
   epochs into ``build/chip_smoke_train/A``; run B resumes from A's
   ``epoch_1.pth``. Checks: finite train rows; ``epoch_1.pth``,
   ``epoch_2.pth`` and ``latest`` in A; a ``val`` row with finite bbox and
   segm mAP for each epoch of each run; B just after its load holds A's
   epoch-1 model and optimizer state bit for bit; B's epoch-2 rows carry
   A's step and lr; B's first step's losses within LOSS_RTOL of A's (the
   same forward on the same state, data and draws); B's final parameters
   within RESUME_RTOL of A's (the backwards of K3, K4 and cuDNN sum in a
   nondeterministic order). It prints each epoch's wall time with its
   first batch (the loader's start-up in a run's first epoch), the
   checkpoint's size with its save and load times, the validation's img/s,
   the in-loop ms/step beside phase 5's, and the peak memory. (b) Does the
   step train? Phase 3's toy at 2 classes with the JAX overfit proxy's
   recipe (``tests/test_overfit.py``) on that proxy's 4-image set in
   ``build/chip_smoke_overfit/``, 80 epochs through ``train_detector``
   from the weights seed 0 gives on the CPU (``load_from``): the last
   epoch's mean loss must be below half the first's; ``run_eval``
   then reads the loop's checkpoint from its work dir, and its bbox and
   segm mAP are printed beside the JAX package's (``ACCURACY.json``), a
   reading and not a gate;
8. drive the other four configurations of ``BASELINE.json``, each built
   from its config file, unchanged, at full width: Mask R-CNN R50-FPN 1x
   (FCN mask head), DynaMask R101-FPN 3x, DynaMask on LVIS v1 (1203
   classes, 300 det slots) and on Cityscapes (1024x2048 canvas). Each
   runs inference on one seeded image at its test canvas (random weights
   N(0, 0.05) from seed 0; both modes for DynaMask; median of 5 after a
   counted warm-up) and training at its batch and train canvas (4x800x1344;
   1x1024x2048 for Cityscapes; its seeded initialisation, a synthetic
   batch with 20 GTs an image; median of 3 after a warm-up), printing
   ms/img, ms/step, peak memory, the valid det slots and the launches of
   each path, each held to its exact counts (an image: K1 3, K2 5
   faithful / 6 dynamic on DynaMask, K2 2 on Mask R-CNN; a step: K1 6, K2
   6, K3 3, K4 6 on DynaMask, K2 2, K4 2 on Mask R-CNN). Then the LVIS and Cityscapes evaluation paths: a seeded set
   in each format (``build/chip_smoke_lvis/``: 8 images named by
   ``coco_url``, 1203 categories with frequency bands, negative and
   not-exhaustive categories; ``build/chip_smoke_cityscapes/``: 2 PNGs of
   2048x1024) through ``run_test`` and ``dataset.evaluate``; the GTs given
   as predictions must score exactly 1.0 (LVIS: in every band), and the
   Cityscapes results go through ``results2txt``. It prints the phase's
   seconds;
9. drive the flagship under the mixed-precision policy
   (``dynamask_torch/core/fp16.py``): inference through
   ``apis.make_test_fn`` in fp32 and with ``bf16=True`` (a bf16 copy of
   the model on a bf16 image, box and score decode in fp32), both modes,
   at 800x1344, in turns (median of 5 after a warm-up, peak memory); then
   phase 5's trainer, batch and draws through ``train_steps`` with
   ``compute_dtype=torch.bfloat16``: step 0's loss finite and within 5% of
   phase 5's fp32 step 0, parameters and gradients fp32 after it, and 3
   timed steps beside phase 5's ms/step and peak memory. Each drive must
   launch its precision's instance of every kernel of its path exactly as
   often as ``INFER_COUNTS`` / ``STEP_COUNTS`` say (an image: K1 3, K2 5
   faithful and 6 dynamic; a step: K1 6, K2 6, K3 3, K4 6) and no instance
   of the other precision. It prints the phase's seconds;
10. drive the RefineMask family (no DCN: K2 and K4 only), each from its
   config file, unchanged, at full width: ``configs/refinemask/coco/
   r50_refinemask_1x.py`` at phases 4-5's protocol (random weights
   N(0, 0.05) from seed 0, one seeded 800x1344 image through
   ``inference_detector``, a counted warm-up and the median of 5; its
   seeded initialisation and a synthetic batch of 4 at 800x1344 with 20
   GTs an image and ``gt_semantic`` from the data pipeline's rasteriser,
   one warm-up and 3 timed ``train_steps``), then the LVIS config (1203
   classes on stages 0-2, 300 slots) and the Cityscapes one (1024x2048,
   batch 1), one timed image and one timed step each; then one step from
   phase 6's eval drive (``single_device_test`` -> RLE -> COCO metrics,
   img/s) and loader-batch step on the R50 config, whose ``with_semantic``
   train set gives the batch ``gt_semantic``.
   Every drive must launch exactly K2 8 an image, K2 8 and K4 8 a step,
   and nothing else. It prints ms/img, ms/step, peak memory, step 0's
   ``loss_instance`` and ``loss_semantic`` and the phase's seconds;
11. drive the box-only detectors and the ResNet variants, each from its
   config file, unchanged, at full width at phases 4-5's protocol (one
   800x1344 image, a step of 4x800x1344; a counted warm-up held to its
   exact launches, then the median of 2): Faster R-CNN
   (``configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py``; K2 1 an
   image, K2 1 and K4 1 a step), the same through
   ``configs/fp16/faster_rcnn_r50_fpn_fp16_1x_coco.py`` in bf16
   (``make_test_fn(bf16=True)``, ``compute_dtype=torch.bfloat16``; the
   ``_bf16`` instances only), Mask R-CNN on ResNeXt-101-32x4d and on the
   caffe-style R50 (K2 2 an image, K2 2 and K4 2 a step); then mmdet's
   RPN -> Fast R-CNN workflow over phase 6's set: the RPN config's eval
   drive (no kernel; ``proposal_fast`` AR, the GTs as proposals exactly
   1.0), its proposals written to ``build/chip_smoke_proposals/
   rpn_val.pkl``, which the Fast R-CNN config's test set reads as its
   ``proposal_file`` (K2 an image); and the VOC config's eval drive on a
   seeded VOC2007 layout in ``build/chip_smoke_voc/`` (8 noise JPEGs with
   XML annotations, K2 an image, VOC2007 mAP, the GTs as predictions
   1.0). It prints ms/img, ms/step and peak memory of each config and
   the phase's seconds;
12. drive Cascade R-CNN and Hybrid Task Cascade, each from its config
   file, unchanged, at full width at phases 4-5's protocol (one image at
   the config's test canvas, a step at its train batch; a counted warm-up
   held to its exact launches, then timed repeats):
   ``configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py`` (median
   of 3 images, 2 steps; K2 4 an image, K2 4 and K4 4 a step: three box
   stages and one mask extract), ``cascade_rcnn_r50_fpn_1x_coco.py`` (one
   of each; K2 3, K2 3 and K4 3), ``configs/htc/htc_r50_fpn_1x_coco.py``
   (median of 3 images, 2 steps with ``gt_semantic_seg`` in the batch,
   so ``loss_semantic_seg`` and its gradient run; K2 8 an image: three
   box stages and the mask extract, each with its semantic crop; K2 12
   and K4 12 a step: box, semantic, mask and semantic crops in each of
   three stages), ``htc_without_semantic_r50_fpn_1x_coco.py`` (one image,
   K2 4) and ``htc_x101_64x4d_fpn_16x1_20e_coco.py`` (ResNeXt-101 64x4d,
   its config's batch of 1; one image and one step, HTC's counts); then
   phase 6's eval drive and loader-batch step on HTC (K2 8 an image, K2 12
   and K4 12 the step; the loaders give no ``gt_semantic_seg``, as the
   JAX package's give none). It prints ms/img, ms/step and peak memory of
   each config and the phase's seconds;
13. drive the two-stage family's options, each from its config file,
   unchanged, at full width at phases 4-5's protocol:
   ``configs/gn+ws/mask_rcnn_r50_fpn_gn_ws-all_2x_coco.py`` (GN and ConvWS
   in the backbone, GN on the FPN, ``Shared4Conv1FCBBoxHead`` and the mask
   head with GN; median of 3 images, 2 steps) and its X101-32x4d file
   (one of each), ``configs/groie/mask_rcnn_r50_fpn_groie_1x_coco.py``
   (every RoI pooled from all four levels, one K2 launch an extract;
   median of 3 images, 2 steps; then phase 6's eval drive and loader-batch
   step), ``configs/double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py`` (a
   second box crop of each RoI enlarged 1.3x, in the same K2 launch; one
   of each),
   ``configs/carafe/mask_rcnn_r50_fpn_carafe_1x_coco.py`` (one of each),
   ``configs/faster_rcnn/faster_rcnn_r50_fpn_giou_1x_coco.py`` and
   ``..._ohem_1x_coco.py`` (a step each) and ``..._soft_nms_1x_coco.py``
   (an image); K2 2 an image and K2 2 + K4 2 a step on the Mask R-CNNs,
   K2 1 and K2 1 + K4 1 on the Faster R-CNNs and Double-Head; then the
   Soft-NMS config's ``multiclass_nms`` call on one image's scores, held
   against the same call on the CPU and timed beside greedy NMS on the
   same inputs. It prints ms/img, ms/step and
   peak memory of each config and the phase's seconds;
14. drive the single-stage detectors, each from its config file,
   unchanged, at full width at phases 4-5's protocol (no hand kernel runs
   on these paths: every counter is held at exactly 0 on each drive):
   ``configs/retinanet/retinanet_r50_fpn_1x_coco.py`` (median of 3 images,
   2 steps, then its eval drive on phase 6's set: bbox AP with the 4
   loader workers, phase 11's ms/img split, the GTs as predictions
   exactly 1.0), ``configs/fp16/retinanet_r50_fpn_fp16_1x_coco.py`` in
   bf16 (an image, a step), ``configs/legacy_1.x/
   retinanet_r50_fpn_1x_coco_v1.py`` (an image), the GHM and FreeAnchor
   R50s (a step each), ``configs/nas_fpn/retinanet_r50_fpn_crop640_50e_
   coco.py`` (``RetinaSepBNHead`` over the BN FPN; an image and a step at
   640x640), ``configs/atss/atss_r50_fpn_1x_coco.py``, ``configs/fcos/
   fcos_r50_caffe_fpn_gn-head_4x4_1x_coco.py`` and its
   ``center-normbbox-centeronreg-giou`` twin (an image and a step each).
   Phase 3 adds the toy RetinaNet, ATSS and FCOS on the card against the
   same weights on the CPU. It prints ms/img, ms/step and peak memory of
   each config and the phase's seconds;
15. drive the detectors on item 8's backbones and necks, each from its
   config file, unchanged, at full width at phases 4-5's protocol:
   ``configs/hrnet/mask_rcnn_hrnetv2p_w32_1x_coco.py`` (HRNet-W32 +
   HRFPN, whose P2-P6 are one 1x1-reduced map average-pooled; an image
   and a step), ``htc_hrnetv2p_w18_20e_coco.py`` (an image and a step with
   ``gt_semantic_seg``), ``cascade_mask_rcnn_hrnetv2p_w40_20e_coco.py``
   (an image), ``fcos_hrnetv2p_w32_gn-head_4x4_1x_coco.py`` (HRFPN at
   stride 2; an image and a step, no kernel),
   ``configs/regnet/mask_rcnn_regnetx-3.2GF_fpn_1x_coco.py`` (an image
   and a step), ``retinanet_regnetx-800MF_fpn_1x_coco.py`` (an image, no
   kernel), ``configs/res2net/mask_rcnn_r2_101_fpn_2x_coco.py`` and
   ``configs/pafpn/faster_rcnn_r50_pafpn_1x_coco.py`` (an image and a step
   each), each held to its exact K2/K4 launches (the Mask R-CNNs' 2 / 2 +
   2, HTC's and the cascade's as phase 12's, the PAFPN Faster R-CNN's 1 /
   1 + 1) with K1, K3 and K5 at 0; then phase 6's eval drive and
   loader-batch step on the HRNet-W18 Mask R-CNN. Phase 2 times K2 and K4
   at HRFPN's crops (``hrfpn ...`` lines), and phase 3 adds toy Mask
   R-CNNs on HRNet + HRFPN, RegNet and Res2Net, a toy Faster R-CNN on
   PAFPN and a toy FCOS on HRFPN at stride 2, each on the card against the
   same weights on the CPU (labels and validity equal, dets within 1e-4,
   the step's losses within 1e-4 relative). It prints ms/img, ms/step and
   peak memory of each config and the phase's seconds;
16. run the detectors on the backbones' deformable convs and block
   plugins from their config files, unchanged, at full width
   (``ITEM7_CELLS``): ``configs/dcn/``'s DCNv1 Mask R-CNN (an image and a
   step), DCNv2 Mask R-CNN (an image at 800x1344 through the exact gather
   with its mask, an image at 800x800 where JAX's windowed form runs on
   the square stride-1 maps, each held to its count of the two forms, and
   a step), group-4 DCNv2 Faster R-CNN (an image) and DCNv1 Cascade Mask
   R-CNN (an image and a step); GCNet's r16 Mask R-CNN (an image and a
   step) and GRoIE's r4 GCB file (an image); GA '1111' + DCN Faster R-CNN
   (an image and a step); FCOS with ``dcn_on_last_conv`` (an image and a
   step, no kernel); RegNetX-3.2GF mdconv (an image and a step); HTC
   X101-64x4d DCN (an image); each held to its exact K2/K4 launches with
   K1, K3 and K5 at 0, the steps from the JAX initialisation. Then the
   plain exact-gather DCNv1 timed by stage with CUDA events (layer2-4's
   strided and stride-1 blocks at a step's 4 and an image's 1 800x1344
   images, forward and forward + backward, ``plain dcn ...`` lines) and
   GA '1111' at c4 and c5 (``plain GA ...`` lines): plain PyTorch by
   design, the JAX package computes them in XLA. Last, toy DCNv1 + GCB
   and DCNv2 (4 groups) + GA '1111' Mask R-CNNs at depth 50 through
   phase 3's inference and training-step checks, and a toy FCOS with
   ``dcn_on_last_conv`` (its losses and every gradient, the offset
   convs' among them), on the card against the CPU. It prints the
   phase's seconds;
17. run guided anchoring and DetectoRS from their config files, unchanged,
   at full width (``ITEM9_CELLS``): ``configs/guided_anchoring/``'s
   GA-RPN, GA-Faster R-CNN and GA-RetinaNet R50 (an image and a step
   each: K1 on every FPN level in 4 deform groups, K3 in the steps) and
   ``configs/detectors/``'s deformable-SAC Cascade R-CNN (an image and a
   step: K1/K3 on the stride-1 SAC branches at dilations 1 and 3), the
   DetectoRS HTC (SAC + a two-step RFP, an image) and HTC with RFP alone
   (an image), each held to its exact K1-K5 launches and to its count of
   exact-gather calls (the strided SAC blocks), the steps from the JAX
   initialisation; then a toy GA-Faster R-CNN and a toy DetectoRS Cascade
   Mask R-CNN (SAC + RFP) through phase 3's inference and training-step
   checks, and a toy GA-RetinaNet (dets, losses and every gradient, the
   ``FeatureAdaption`` offset convs' among them), on the card against the
   CPU. It prints the phase's seconds;
18-19. run item 9's two-stage heads and item 6's FPN dense detectors
   (``run_item9_heads``, ``run_item6``);
20. run SSD, PISA, Libra R-CNN and NAS-FPN from their config files,
   unchanged, at full width (``ITEM20_CELLS``, ``run_item20``): SSD300 and
   PISA-SSD300 at 300x300, PISA Faster / Mask R-CNN R50 and PISA RetinaNet
   at 800x1344 (the X101 PISA Mask R-CNN an image), Libra Faster R-CNN at
   768x1344, Libra RetinaNet at 768x1280 (the canvases nearest 800x1344
   where JAX's BFP is defined, ROADMAP.md queue 3, 3bj) and NAS-FPN
   RetinaNet at 640x640, an image and a step of 4 each, with Libra Fast
   R-CNN on proposals given in the batch; each held to its exact K1-K5
   launches (PISA Faster R-CNN: K2 1 an image, K2 2 and K4 1 a step, its
   Score-HLR pass over every candidate one K2 launch without K4; PISA
   Mask R-CNN 2, 3 and 2; Libra's two-stage files 1, 1 and 1; 0 on the
   others) (their device-busy shares stand in PERF.md). Then PISA
   Faster R-CNN's step split into its sampler's host and device ms, Libra
   Faster R-CNN at 800x1344 required to raise the 3bj ``ValueError``, and toy SSD300 and
   NAS-FPN RetinaNet (float64 steps), PISA Mask R-CNN and Libra Faster
   R-CNN on the card against the CPU; phase 2's ``pisa ...`` lines time K2
   at the Score-HLR pass's 8080 RoIs and the 2000-proposal test crop. It
   prints the phase's seconds;
21. run the rest of item 9 from its config files, unchanged, at full
   width (``ITEM21_CELLS``, ``run_item21``): the C4 Faster R-CNN, Mask
   R-CNN and RPN (``configs/{faster_rcnn,mask_rcnn,rpn}/
   *_r50_caffe_c4_1x_coco.py``: the caffe ResNet-50 to its stride-16
   layer3, no neck, the RPN on that one level, RoIAlign to 14x14 at 1024
   channels, the res5 shared head before the avg-pooled box head and the
   deconv-only mask head), the DeformRoIPool and modulated DeformRoIPool
   Faster R-CNNs (``configs/dcn/faster_rcnn_r50_fpn_{dpool,mdpool}_1x_
   coco.py``: the box crop plain PyTorch, two deform pool passes with the
   offset fcs between) at 800x1344, and CornerNet on Hourglass-104
   (``configs/cornernet/cornernet_hourglass104_mstest_8x6_210e_coco.py``:
   an image at 383x511, the canvas its test pipeline gives a 640x480
   image, and a step at its 511x511 train canvas), an image and a step of
   4 each, with phase 4's and phase 5's weights; each held to its exact
   K1-K5 launches (K2 1 an image and K2 1 + K4 1 a step on C4 Faster
   R-CNN, 2 and 2 + 2 on C4 Mask R-CNN, 0 on the RPN, the two deform pool
   files and CornerNet) (their device-busy shares stand in PERF.md);
   then the plain deform pool timed at an image's and a step's box
   crops (``plain dpool ...`` lines), CornerNet
   at 800x1344 required to raise the 3bq ``ValueError`` (its Hourglass
   cannot halve that canvas evenly), and toy C4 Mask R-CNN, mdpool
   Faster R-CNN and CornerNet on the card against the CPU; phase
   2's ``c4 ...`` lines time K2 at the C4 crops of an image (1000
   proposals, 100 dets, 14x14 at 1024 channels on the 50x84 stride-16
   map) and K2 and K4 at a step's (2048 box RoIs and 512 mask slots of 4
   images). It prints the phase's seconds;
22. run item 2's bf16 on the families that run the hand kernels, each
   file from its config, unchanged, at full width, as its fp32 cell of
   phases 8-21 drives it (``ITEM22_CELLS``, ``run_item22``): DynaMask
   R101 3x, LVIS (an image) and Cityscapes (1024x2048, batch 1) in both
   MSM modes, RefineMask R50, the C4 Mask R-CNN, Cascade Mask R-CNN, HTC
   (its step with ``gt_semantic_seg``), the X101-32x4d Mask R-CNN (an
   image), GRoIE, HRNet-W32 (its step from N(0, 0.05) weights),
   GA-Faster R-CNN, GA-RetinaNet, the SAC Cascade R-CNN and PointRefine:
   an image through ``make_test_fn(..., bf16=True)`` and a step through
   ``train_steps(..., compute_dtype=torch.bfloat16)``, each a counted
   warm-up and a timed repeat (their profiled passes cut in PR 24 for
   phase 23's time); each drive launches the
   bf16 instance of each kernel exactly as often as the same file's fp32
   drive launched the fp32 one earlier in this run, no fp32 instance and
   no K5, and step 0's loss is finite and within 5% of the fp32 cell's
   step 0 (on the DynaMask files, where both steps route every RoI alike,
   with the mask loss taken on the bf16 step's logits cast to fp32: in
   bf16 JAX's detail loss saturates, 3by; where the routing differs,
   without the MSM-routed terms). Each file's ``<name>
   <mode>:`` and ``<name> step:`` lines put bf16 beside the fp32 drive:
   ms, peak memory, the ratios. Phase 2's
   bf16 lines hold K1 and K3 ``_bf16`` on every map of ``WHOLE_MAPS``
   (K3's offset gradient exactly 0 from zero offsets) and K2 and K4
   ``_bf16`` at RefineMask's P2 crops (C = 1 among them), HTC's semantic
   crops, GRoIE's and Double-Head's crops and the C4 crops, each timed
   beside its bound at 2 B an element, out of the ``kernels`` line's
   sums. It prints the phase's seconds;
23. run test-time augmentation and conv+BN folding (``run_tta``): the
   flagship at full width from random N(0, 0.05) weights with its
   BatchNorms' statistics drawn (means N(0, 0.1), variances U(0.5, 1.5)),
   saved and read back by the eval CLI (``tools.test.main``) with
   ``--tta --tta-scales 800 1333 1000 1333 --eval bbox segm`` over a
   seeded COCO set of one image at each COCO size in
   ``build/chip_smoke_tta/``, in the faithful and the dynamic mode, each
   without and with ``--fuse-conv-bn`` (4 augmentations an image, the
   second scale on the 1344x1344 canvas; K1 3 x 4 and K2 5 x 4 an image
   faithful, 6 x 4 dynamic, exact, and 55 folded pairs, JAX's count), then
   ``aug_device_test`` in bf16 unfolded and folded (the same counts on
   the ``_bf16`` instances), the device ms an image of TTA and of the
   single scale (``make_test_fn``), unfolded and folded, fp32 and bf16,
   each beside its busy share, the folded fp32 drive's dets against the
   unfolded one's, and toy DynaMask (both modes) and Mask R-CNN
   ``aug_test`` on the card against the CPU; phase 2's ``tta ...`` lines
   hold K2 and its bf16 instance at each augmentation's crops on the
   1344x1344 canvas and in a flipped frame. It prints the phase's seconds
   and the whole run's.

For each drive (faithful, dynamic, the K5 check on the captured DCN
inputs, train, eval, loader_train, in phase 7 the loop's steps, its
validations and the overfit loop, and in phase 8 each configuration's
inference modes, its training and the two evaluation paths, in phase 9
the fp32 and bf16 drives, in phase 10 each RefineMask config's image
and steps, the loader-batch step and the eval drive, in phase 11 each
config's image and steps and the RPN, Fast R-CNN and VOC eval drives, in
phase 12 each config's image and steps and HTC's eval drive and
loader-batch step, in phase 13 each config's image and steps and
GRoIE's eval drive and loader-batch step, in phase 14 each config's
image and steps and RetinaNet's eval drive, in phase 15 each config's
image and steps and the HRNet-W18 Mask R-CNN's eval drive and
loader-batch step, in phases 16-22 each config's image and
steps, and in phase 23 each eval CLI drive and each bf16 TTA drive)
the kernels' launch
counters are zeroed just before it
and read just after (the loop's
steps and its validations in turns), and every kernel of that path must
have launched in it: K1 and K2 at inference, in the eval loops and in the
loop's validations, K5 through both entry points in its check, K1-K4 in
training; behind Mask R-CNN's FCN head, which runs no DCN, K2 at
inference and K2 and K4 in training; phase 6 and phases 8-22 hold each
drive to its exact counts, every other kernel at 0 (the RPN's eval drive,
every phase-14 drive, phase 15's FCOS and RetinaNet drives, phase 16's
FCOS drives and phase 21's RPN, deform pool and CornerNet drives launch
none).

Standard output ends with the ``kernels`` JSON line, the card's name and
power limit as ``nvidia-smi`` reports them, and the ``{"ok": true, ...}``
line. Details go to ``chiprun_out/chip_smoke.json``.
"""

import collections
import contextlib
import functools
import itertools
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

DEVICE = 'cuda'
ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, 'configs/dynamask/coco/r50_dynamask_1x.py')
MASK_RCNN = os.path.join(ROOT,
                         'configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py')
REFINEMASK = os.path.join(ROOT,
                          'configs/refinemask/coco/r50_refinemask_1x.py')
IMAGE_HW = (800, 1344)           # the flagship's test canvas
PORTRAIT_HW = (1344, 800)        # its canvas for portrait images (phase 6)
TRAIN_IMAGES = 4                 # the config's samples_per_gpu
TRAIN_GTS = 20
TIMED_STEPS = 3                  # after one warm-up step
# the lr schedule's epoch: COCO train2017's 117266 images with annotations
# at the config's 4 per step on one card
COCO_STEPS_PER_EPOCH = 117266 // TRAIN_IMAGES
N_DETS = 100                     # inference: max_per_img dets reach the mask
N_BOX_TRAIN = TRAIN_IMAGES * 512  # training: sampled RoIs of the box branch
N_POS_TRAIN = TRAIN_IMAGES * 128  # training: max_pos slots of the mask branch
LVIS_DETS = 300                  # the LVIS config's max_per_img
CITY_HW = (1024, 2048)           # the Cityscapes config's canvas
CITY_POS = 128                   # its training step's mask slots (batch 1)
VOC_HW = (1024, 1024)            # the VOC config's canvas (phase 11)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
# H100 SXM peak operation rates (data sheet, dense), by the type the
# operations run in: fp32 outside the tensor cores, and bf16 x bf16 products
# summed in fp32 on the tensor cores
# (and the Hopper white paper's 133.8 TFLOP/s of packed bf16 pairs outside
# them, ``bf16x2``: K5's frame-rule sampler). An FMA counts two operations
# there and a product or a sum one, so a count of products and sums at
# these rates is a least time, never more than the card needs
PEAK_OPS_PER_S = {'fp32': 67e12, 'bf16': 989e12, 'bf16x2': 133.8e12}
# Tolerances, each against the kernel's plain version on the same inputs:
K1_TOL = 1e-4   # absolute; same arithmetic as the plain form, fma only
K2_TOL = 1e-4   # absolute; same samples; summation order and fma only
# K3 and K4 sum with fp32 atomics (and K3 its channel sums by warp shuffle)
# in another order than the plain versions: relative to the largest value
K3_RTOL = 1e-5
K4_RTOL = 1e-5
# K5 sums 9*C products per output in another order than cuBLAS's GEMM in the
# plain version and the main path (~1e-6 of the largest output on the CPU
# emulation): in fp32, relative to the largest value; in bf16 both sides
# round an fp32 result that may straddle a rounding boundary, so one bf16
# ulp of the largest value
K5_RTOL = 1e-5
INFER_KERNELS = ('deform_im2col_windowed', 'roi_align_fwd')
K5_KERNELS = ('deform_conv2d_windowed_fused', 'deform_conv2d_frame')
TRAIN_KERNELS = ('deform_im2col_windowed', 'roi_align_fwd',
                 'deform_col2im_windowed', 'roi_align_bwd')
# the flagship's launches of one image in each mode (the MSM's RoIAlign is
# the dynamic mode's sixth K2) and of one training step
INFER_COUNTS = {'faithful': {'deform_im2col_windowed': 3, 'roi_align_fwd': 5},
                'dynamic': {'deform_im2col_windowed': 3, 'roi_align_fwd': 6}}
STEP_COUNTS = {'deform_im2col_windowed': 6, 'roi_align_fwd': 6,
               'deform_col2im_windowed': 3, 'roi_align_bwd': 6}
BF16_LOSS_RTOL = 0.05   # the JAX package's own bf16 rule
                        # (tests/test_bf16_train.py)


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(DEVICE)
    return start.elapsed_time(end) / iters


# -- kernel cases -------------------------------------------------------------

SFM_STAGES = ((14, 256), (28, 128), (56, 64))   # (S, C) of the 3 DCNs


def k1_cases(gen, dev):
    """K1 at the three SFM stages: n = 100 dets at inference, 512 positive
    slots in training; 2 deform groups. Offsets reach ±5 px, past the ±3
    window and off the plane. Then, on lines of their own, the shapes the
    other configurations give it: n = 300 at LVIS inference, 128 positive
    slots in a Cityscapes training step, and phase 17's whole maps."""
    import torch
    for path, n in (('infer', N_DETS), ('train', N_POS_TRAIN),
                    (f'{CONFIG} lvis infer', LVIS_DETS),
                    (f'{CONFIG} cityscapes train', CITY_POS)):
        for s, c in SFM_STAGES:
            x = torch.randn(n, s, s, c, generator=gen, device=dev)
            off = (torch.rand(n, s, s, 36, generator=gen, device=dev) - 0.5) \
                * 10
            yield f'{path} {n}x{s}x{s}x{c}', (x, off), dict(
                kernel_size=3, padding=1, dilation=1, deform_groups=2,
                window=3)
    yield from whole_map_cases(gen, dev, train=False)


def k3_cases(gen, dev):
    """K3 at the training shapes of K1, with a random column gradient, and
    at a step's whole maps of phase 17."""
    import torch
    for case, (x, off), kw in k1_cases(gen, dev):
        if case.startswith(('train', f'{CONFIG} cityscapes train')):
            n, s, _, c = x.shape
            d_col = torch.randn(n, s, s, 2, 9, c // 2, generator=gen,
                                device=dev)
            yield case, (x, off, d_col), kw
            del x, off, d_col
    yield from whole_map_cases(gen, dev, train=True)


def synthetic_rois(gen, dev, n, images, canvas):
    """(RoIs, image indices) of ``n`` random RoIs over ``images`` images of
    the (h, w) ``canvas``: the first four partly off the image, of zero
    area, very wide and past the far corner."""
    import torch
    h, w = canvas
    xy = torch.rand(n, 2, generator=gen, device=dev) * torch.tensor(
        [w, h], device=dev)
    wh = torch.rand(n, 2, generator=gen, device=dev) ** 2 * torch.tensor(
        [w, h], device=dev)
    r = torch.cat([xy - wh / 4, xy + wh], 1)
    r[:4] = torch.tensor([[-40., -30., 100., 90.],     # partly off
                          [h / 2, h / 2, h / 2, h / 2],  # zero area
                          [0., h / 3, w, h / 3 + 60],   # very wide
                          [w - 100, h - 80, w + 60, h + 40]], device=dev)
    return r.contiguous(), torch.randint(0, images, (n,), generator=gen,
                                         device=dev)


def _crops(gen, dev, images, n_box, n_mask, place=None, canvas=IMAGE_HW):
    """The crops of the main path, as (name, K2 arguments, options): the 7x7
    box extract (ratio 2) and the 14x14 mask extract (ratio 2) over P2-P5,
    the SFM crops ({14, 28, 56}^2 of P4/P3/P2 at scale 1/4 with 256/128/64
    channels, ratio 1) and the MSM 56x56x128 crop of P2 (ratio 1), over
    ``images`` images of the (h, w) ``canvas``. RoIs include boxes partly
    off the image, zero-area and very wide ones; ``place(n, synthetic)``,
    given, returns the (RoIs, image indices) of a crop of n RoIs in their
    place (``synthetic(k)`` draws k of the default ones)."""
    import torch
    from dynamask_torch.ops import roi_align as ra
    h, w = canvas
    shapes = [(h // s, w // s) for s in (4, 8, 16, 32)]

    def synthetic(n):
        return synthetic_rois(gen, dev, n, images, canvas)

    def placed(n):
        return place(n, synthetic) if place else synthetic(n)

    def multilevel(n, p, c, ratio):
        feats = [torch.randn(images, a, b, c, generator=gen, device=dev)
                 for a, b in shapes]
        r, b = placed(n)
        return (ra.multilevel_crop_args(feats, r, b, (4, 8, 16, 32)),
                dict(out_size=p, sampling_ratio=ratio))

    def single(n, p, c, plane, ratio):
        a, b = plane
        feat = torch.randn(images, a, b, c, generator=gen, device=dev)
        flat, _ = ra._flat_planes([feat])
        r, bi = placed(n)
        return (flat, r, bi * (a * b),
                torch.full((n,), a, dtype=torch.int32, device=dev),
                torch.full((n,), b, dtype=torch.int32, device=dev),
                torch.full((n,), 0.25, device=dev)), dict(
                    out_size=p, sampling_ratio=ratio)

    yield f'box {n_box}x7x7x256 r2', *multilevel(n_box, 7, 256, 2)
    yield f'mask {n_mask}x14x14x256 r2', *multilevel(n_mask, 14, 256, 2)
    for (s, c), plane, lvl in zip(SFM_STAGES, shapes[2::-1],
                                  ('P4', 'P3', 'P2')):
        yield f'sfm {lvl} {n_mask}x{s}x{s}x{c} r1', *single(n_mask, s, c,
                                                            plane, 1)
    yield f'msm P2 {n_mask}x56x56x128 r1', *single(n_mask, 56, 128, shapes[0],
                                                   1)


def clustered_place(gen, dev, images, n_pos):
    """RoIs as the flagship's training step makes them, for
    :func:`_crops`: ``n_pos`` positives jittered (each corner by up to ±10%
    of the box's side, IoU ~0.7-1 with it) around ``TRAIN_GTS`` GT boxes per
    image of 96-160 px (~128), all clipped to the image, about 6 positives
    per GT; a crop of more RoIs (the box extract) fills the rest with the
    default RoIs."""
    import torch
    h, w = IMAGE_HW
    n_gt = images * TRAIN_GTS
    side = 96 + 64 * torch.rand(n_gt, 2, generator=gen, device=dev)
    ctr = torch.rand(n_gt, 2, generator=gen, device=dev) * torch.tensor(
        [w, h], device=dev)
    lim = torch.tensor([w, h, w, h], dtype=torch.float32, device=dev)
    gt = torch.minimum(torch.cat([ctr - side / 2, ctr + side / 2], 1).clamp(
        min=0), lim)
    pick = torch.arange(n_pos, device=dev) % n_gt
    jitter = (torch.rand(n_pos, 4, generator=gen, device=dev) - 0.5) * 0.2
    pos = torch.minimum((gt[pick] + jitter * side[pick].repeat(1, 2)).clamp(
        min=0), lim).contiguous()
    pos_img = pick // TRAIN_GTS

    def place(n, synthetic):
        if n <= n_pos:
            return pos[:n].contiguous(), pos_img[:n]
        r, b = synthetic(n - n_pos)
        return torch.cat([pos, r]).contiguous(), torch.cat([pos_img, b])
    return place


def k1_bf16_cases(gen, dev):
    """K1's bf16 instance at the flagship's inference (n = 100) and
    training (n = 512) shapes and on every whole map of ``WHOLE_MAPS``
    (phase 22's guided-anchoring and SAC drives): K1's cases with x and the
    offsets in bf16."""
    for case, (x, off), kw in k1_cases(gen, dev):
        if case.startswith(('infer', 'train', WHOLE_MAP)):
            yield case, (x.bfloat16(), off.bfloat16()), kw
        del x, off


def k3_bf16_cases(gen, dev):
    """K3's bf16 instance at the flagship's training shapes and on a
    step's whole maps (the SAC maps from zero offsets too): K3's cases
    with x, the offsets and the column gradient in bf16."""
    for case, args, kw in k3_cases(gen, dev):
        if case.startswith(('train', WHOLE_MAP)):
            yield case, tuple(a.bfloat16() for a in args), kw
        del args


# the crops phase 22's bf16 drives give K2 and K4 beside the flagship's:
# RefineMask's P2 crops (C = 256/128/64 and the one-channel semantic mask)
# of a step and of an R50 image, HTC's stride-8 semantic crops of a step,
# GRoIE's all-level and Double-Head's crops, the C4 level at 1024 channels
def bf16_family_crops(dev, infer=True):
    yield from refine_crops(dev, *REFINE_DRIVES[0])
    if infer:
        yield from refine_crops(dev, *REFINE_DRIVES[1])
    yield from htc_crops(dev)
    yield from two_stage_crops(dev, infer)
    yield from c4_crops(dev, infer)


def k2_bf16_cases(gen, dev):
    """K2's bf16 instance at the flagship's inference and training crops
    and at the families' crops of phase 22 (:func:`bf16_family_crops`):
    K2's with the flat features in bf16 (RoIs, scales and plane indices as
    they are)."""
    for path, images, n_box, n_mask in (('infer', 1, 1000, N_DETS),
                                        ('train', TRAIN_IMAGES, N_BOX_TRAIN,
                                         N_POS_TRAIN)):
        for case, args, kw in _crops(gen, dev, images, n_box, n_mask):
            yield f'{path} {case}', (args[0].bfloat16(), *args[1:]), kw
            del args
    for case, args, kw in bf16_family_crops(dev):
        yield case, (args[0].bfloat16(), *args[1:]), kw
        del args
    for case, args, kw in tta_crops(dev):      # phase 23's bf16 drives
        yield case, (args[0].bfloat16(), *args[1:]), kw
        del args


def k4_bf16_cases(gen, dev):
    """K4's bf16 instance at the flagship's training crops and at the
    families' crops of a step (:func:`bf16_family_crops`): K4's with the
    crop gradient in bf16; the result is its fp32 sum."""
    import torch
    for case, args, kw in k4_cases(gen, dev):
        if case.startswith('train '):
            yield case, (args[0].bfloat16(), *args[1:]), kw
        del args
    cgen = torch.Generator(device=dev).manual_seed(27)
    for case, args, kw in bf16_family_crops(dev, infer=False):
        d_out, *rest = k4_args(cgen, args, kw)
        yield case, (d_out.bfloat16(), *rest), kw
        del args, d_out, rest


def k5_cases(gen, dev):
    """K5 at the three SFM stages (C_out = C, HWIO weights N(0, 1/(9C))),
    offsets as K1's: fp32 and bf16 at n = 100 and 512."""
    import torch
    for path, n, dtype in (('infer', N_DETS, torch.float32),
                           ('train', N_POS_TRAIN, torch.float32),
                           ('infer bf16', N_DETS, torch.bfloat16),
                           ('train bf16', N_POS_TRAIN, torch.bfloat16)):
        for s, c in SFM_STAGES:
            x = torch.randn(n, s, s, c, generator=gen, device=dev).to(dtype)
            off = (torch.rand(n, s, s, 36, generator=gen, device=dev) - 0.5) \
                * 10
            w = torch.randn(3, 3, c, c, generator=gen, device=dev) / \
                math.sqrt(9 * c)
            yield f'{path} {n}x{s}x{s}x{c}', (x, off, w), dict(
                kernel_size=3, padding=1, dilation=1, deform_groups=2,
                window=3)
            del x, off, w


def abs_limit(tol):
    """A tolerance in absolute terms: (scale, got) -> (limit, how set)."""
    return lambda scale, got: (tol, f'{tol}')


def rel_limit(tol):
    """A tolerance relative to the largest reference value."""
    return lambda scale, got: (tol * scale, f'{tol} x max|ref| {scale:.3e}')


def bf16_ulp(scale):
    """One bf16 ulp (8 significant bits) of a magnitude ``scale``."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7) if scale > 0 else 0.0


def bf16_limit(scale, got):
    """K1 and K2 in bf16: both sides round the same fp32 value (but for
    fma contraction), which may straddle a rounding boundary: one bf16 ulp
    of max|ref|."""
    return bf16_ulp(scale), 'one bf16 ulp of max|ref|'


def rounded_rel_limit(tol):
    """K3 in bf16: the fp32 rule on the two fp32 sums, plus the one bf16
    ulp of max|ref| that rounding them can put between two sums that
    straddle a rounding boundary."""
    return lambda scale, got: (tol * scale + bf16_ulp(scale),
                               f'{tol} x max|ref| {scale:.3e} + one bf16 '
                               f'ulp of it')


def k5_limit(scale, got):
    """K5's tolerance: (limit, how it was set)."""
    import torch
    if got.dtype == torch.bfloat16:
        return (2.0 ** (math.floor(math.log2(scale)) - 7),
                'one bf16 ulp of max|ref|')
    return K5_RTOL * scale, f'{K5_RTOL} x max|ref| {scale:.3e}'


CLUSTERED = 'clustered'
PORTRAIT = 'portrait'
CONFIG = 'config'                 # the shapes of phase 8's configurations
REFINE = 'refine'                 # RefineMask's crops of P2 (phase 10)
HTC = 'htc'                       # HTC's semantic crops of a step (phase 12)
# GRoIE's all-level and Double-Head's two box crops (phase 13)
TWO_STAGE = 'two_stage'
# HRFPN's pyramid: one 1x1-reduced map average-pooled (phase 15)
HRFPN_CROPS = 'hrfpn'
# K1 and K3 on whole maps: guided anchoring's FPN levels and DetectoRS'
# SAC branches (phase 17)
WHOLE_MAP = 'map'
# item 9's RoI heads: PointRend's P2-only crops, Grid R-CNN's jittered
# positives, FPN-routed and all-level (phase 18)
HEAD_CROPS = 'heads'
# PISA Faster R-CNN's Score-HLR pass over a step's candidates and its test
# crop of 2000 proposals (phase 20)
PISA_CROPS = 'pisa'
# the C4 detectors' crops: one stride-16 level at 1024 channels into 14x14
# bins (phase 21)
C4_CROPS = 'c4'
C4_CHANNELS = 1024
# test-time augmentation's crops: each augmentation's on the 1344x1344
# canvas of the second scale and in a flipped frame (phase 23)
TTA_CROPS = 'tta'
OFF_ROW = (CLUSTERED, PORTRAIT, CONFIG, REFINE, HTC,
           TWO_STAGE, HRFPN_CROPS, WHOLE_MAP, HEAD_CROPS,
           PISA_CROPS, C4_CROPS, TTA_CROPS)  # out of the sums
PISA_PROPOSALS = 2000       # PISA Faster R-CNN's proposals an image
PISA_SCORE_ROIS = TRAIN_IMAGES * (PISA_PROPOSALS + TRAIN_GTS)   # 8080
# the whole maps phase 17 gives K1 (an image and a step's 4 images) and K3 (a
# step's) at 800x1344: GA-RPN's P2-P6 and GA-RetinaNet's P3-P7 (C 256, 4
# deform groups, padding and dilation 1), and the two branches of the
# stride-1 SAC blocks of layer2-4 (C 128/256/512, one group, padding and
# dilation 1 and 3); (n, H, W, C, deform groups, padding, dilation).
# tests/test_torch_port_dcn_bands.py checks the launch configuration of each
GA_LEVELS = ((200, 336), (100, 168), (50, 84), (25, 42), (13, 21), (7, 11))
SAC_MAPS = ((100, 168, 128), (50, 84, 256), (25, 42, 512))
WHOLE_MAPS = ([(n, h, w, 256, 4, 1, 1) for n in (1, TRAIN_IMAGES)
               for h, w in GA_LEVELS]
              + [(n, h, w, c, 1, d, d) for n in (1, TRAIN_IMAGES)
                 for h, w, c in SAC_MAPS for d in (1, 3)])


def whole_map_cases(gen, dev, train):
    """K1's (``train``: K3's, a step's shapes only, with a random column
    gradient) arguments on every one of phase 17's whole maps, with offsets
    up to ±5 px; a step's SAC maps once more from zero offsets, the SAC
    init a step from the JAX initialisation runs."""
    import torch
    for n, h, w, c, g, pad, d in WHOLE_MAPS:
        if train and n != TRAIN_IMAGES:
            continue
        kinds = ('random', 'zero') if g == 1 and n == TRAIN_IMAGES \
            else ('random',)
        for kind in kinds:
            x = torch.randn(n, h, w, c, generator=gen, device=dev)
            off = torch.zeros(n, h, w, g * 18, device=dev) if kind == 'zero' \
                else (torch.rand(n, h, w, g * 18, generator=gen,
                                 device=dev) - 0.5) * 10
            args = (x, off)
            if train:
                args += (torch.randn(n, h, w, g, 9, c // g, generator=gen,
                                     device=dev),)
            label = 'ga' if g == 4 else 'sac'
            yield (f'{WHOLE_MAP} {label} {n}x{h}x{w}x{c} g{g} d{d} {kind}',
                   args, dict(kernel_size=3, padding=pad, dilation=d,
                              deform_groups=g, window=3))
            del x, off, args
# RefineMask's P2 crops (stride 4, sampling ratio 2) per stage: the
# transformed semantic features (C = 256, 128, 64 at 14, 28, 56) and the
# one-channel semantic mask at the same sizes; (P, C)
REFINE_CROPS = ((14, 256), (28, 128), (56, 64), (14, 1), (28, 1), (56, 1))
# the drives that take them, (label, generator seed, images, RoIs, canvas,
# placed as the training step places them): the training step's 512
# positive slots over 4 images, and one image's dets at inference, 100 on
# R50 1x and Cityscapes, 300 on LVIS (at C = 1 and n < MIN_BLOCKS, K2 cuts
# each RoI into bands)
REFINE_DRIVES = (('train', 10, TRAIN_IMAGES, N_POS_TRAIN, IMAGE_HW, True),
                 ('r50 infer', 12, 1, N_DETS, IMAGE_HW, False),
                 ('lvis infer', 13, 1, LVIS_DETS, IMAGE_HW, False),
                 ('cityscapes infer', 14, 1, N_DETS, CITY_HW, False))


def refine_crops(dev, label, seed, images, n, canvas, clustered):
    """K2's arguments at RefineMask's P2 crops in one drive of
    ``REFINE_DRIVES``: ``n`` RoIs over ``images`` images of the (h, w)
    ``canvas`` (P2 at stride 4), placed as the training step places them
    (:func:`clustered_place`) or drawn as the inference crops'
    (:func:`synthetic_rois`), each crop of ``REFINE_CROPS`` from the
    drive's own generator."""
    import torch
    from dynamask_torch.ops import roi_align as ra
    gen = torch.Generator(device=dev).manual_seed(seed)
    if clustered:
        rois, img = clustered_place(gen, dev, images, n)(n, None)
    else:
        rois, img = synthetic_rois(gen, dev, n, images, canvas)
    h, w = canvas[0] // 4, canvas[1] // 4
    for p, c in REFINE_CROPS:
        feat = torch.randn(images, h, w, c, generator=gen, device=dev)
        flat, _ = ra._flat_planes([feat])
        yield (f'{REFINE} {label} P2 {n}x{p}x{p}x{c} r2', (
            flat, rois, img * (h * w),
            torch.full((n,), h, dtype=torch.int32, device=dev),
            torch.full((n,), w, dtype=torch.int32, device=dev),
            torch.full((n,), 0.25, device=dev)),
            dict(out_size=p, sampling_ratio=2))
        del feat, flat


def htc_crops(dev):
    """K2's arguments at HTC's single-level crops of its semantic
    embedding in a training step (phase 12): the box branch's (512
    sampled RoIs an image) at 7x7 and the mask branch's (128 positive
    slots an image) at 14x14, over 4 images of the 100x168x256 plane at
    stride 8, sampling ratio 1, the RoIs placed as the training step
    places them (:func:`clustered_place`)."""
    import torch
    from dynamask_torch.ops import roi_align as ra
    gen = torch.Generator(device=dev).manual_seed(16)
    place = clustered_place(gen, dev, TRAIN_IMAGES, N_POS_TRAIN)
    h, w = IMAGE_HW[0] // 8, IMAGE_HW[1] // 8
    feat = torch.randn(TRAIN_IMAGES, h, w, 256, generator=gen, device=dev)
    flat, _ = ra._flat_planes([feat])

    def synthetic(k):
        return synthetic_rois(gen, dev, k, TRAIN_IMAGES, IMAGE_HW)

    for n, p in ((N_BOX_TRAIN, 7), (N_POS_TRAIN, 14)):
        rois, img = place(n, synthetic)
        yield (f'{HTC} train P3 semantic {n}x{p}x{p}x256 r1', (
            flat, rois, img * (h * w),
            torch.full((n,), h, dtype=torch.int32, device=dev),
            torch.full((n,), w, dtype=torch.int32, device=dev),
            torch.full((n,), 0.125, device=dev)),
            dict(out_size=p, sampling_ratio=1))


def two_stage_crops(dev, infer=True):
    """K2's arguments at the crops phase 13 puts on K2/K4: GRoIE's
    all-level box extract of an image (1000 proposals x 4 levels at 7x7,
    one flat crop of 4000 rows, with ``infer``), its box extract of a step
    (2048 sampled RoIs x 4 levels) and its mask extract of a step (512
    positive slots x 4 levels at 14x14), and Double-Head's box crops of a
    step in one launch (the 2048 RoIs, then the same enlarged 1.3x, each
    routed by its own size), over P2-P5 of the 800x1344 canvas at 256 channels, the step's
    RoIs placed as the training step places them
    (:func:`clustered_place`); from a generator of their own."""
    import torch
    from dynamask_torch.models.double_head import scale_rois
    from dynamask_torch.ops import roi_align as ra
    gen = torch.Generator(device=dev).manual_seed(18)
    h, w = IMAGE_HW
    strides = (4, 8, 16, 32)

    def levels(images):
        return [torch.randn(images, h // s, w // s, 256, generator=gen,
                            device=dev) for s in strides]

    if infer:
        feats = levels(1)
        rois, img = synthetic_rois(gen, dev, 1000, 1, IMAGE_HW)
        yield (f'{TWO_STAGE} groie infer box 4x1000x7x7x256 r2',
               ra.generic_crop_args(feats, rois, img, strides),
               dict(out_size=7, sampling_ratio=2))
        del feats
    feats = levels(TRAIN_IMAGES)
    place = clustered_place(gen, dev, TRAIN_IMAGES, N_POS_TRAIN)

    def synthetic(k):
        return synthetic_rois(gen, dev, k, TRAIN_IMAGES, IMAGE_HW)

    for n, p, what in ((N_BOX_TRAIN, 7, 'box'), (N_POS_TRAIN, 14, 'mask')):
        rois, img = place(n, synthetic)
        yield (f'{TWO_STAGE} groie train {what} 4x{n}x{p}x{p}x256 r2',
               ra.generic_crop_args(feats, rois, img, strides),
               dict(out_size=p, sampling_ratio=2))
    rois, img = place(N_BOX_TRAIN, synthetic)
    yield (f'{TWO_STAGE} double_head train box + enlarged box '
           f'2x{N_BOX_TRAIN}x7x7x256 r2',
           ra.multilevel_crop_args(
               feats, torch.cat([rois, scale_rois(rois, 1.3)]).contiguous(),
               img.repeat(2), strides),
           dict(out_size=7, sampling_ratio=2))


def hrfpn_crops(dev, infer=True):
    """K2's arguments at the crops phase 15 puts on K2/K4 over HRFPN's
    pyramid: P2-P5 of the 800x1344 canvas as HRFPN makes them (a
    200x336x256 map average-pooled by 2, 4 and 8, floor mode), with
    ``infer`` an image's box extract (1000 proposals, 7x7) and mask
    extract (100 dets, 14x14), then a step's over 4 images (2048 sampled
    RoIs at 7x7, 512 positive slots at 14x14, placed as the training step
    places them, :func:`clustered_place`); ratio 2, from a generator of
    their own."""
    import torch
    import torch.nn.functional as F
    from dynamask_torch.ops import roi_align as ra
    gen = torch.Generator(device=dev).manual_seed(20)
    h, w = IMAGE_HW
    strides = (4, 8, 16, 32)

    def pyramid(images):
        x = torch.randn(images, 256, h // 4, w // 4, generator=gen,
                        device=dev)
        levels = [x] + [F.avg_pool2d(x, 2 ** i, 2 ** i) for i in (1, 2, 3)]
        return [lvl.permute(0, 2, 3, 1).contiguous() for lvl in levels]

    if infer:
        feats = pyramid(1)
        for n, p, what in ((1000, 7, 'box'), (N_DETS, 14, 'mask')):
            rois, img = synthetic_rois(gen, dev, n, 1, IMAGE_HW)
            yield (f'{HRFPN_CROPS} infer {what} {n}x{p}x{p}x256 r2',
                   ra.multilevel_crop_args(feats, rois, img, strides),
                   dict(out_size=p, sampling_ratio=2))
        del feats
    feats = pyramid(TRAIN_IMAGES)
    place = clustered_place(gen, dev, TRAIN_IMAGES, N_POS_TRAIN)

    def synthetic(k):
        return synthetic_rois(gen, dev, k, TRAIN_IMAGES, IMAGE_HW)

    for n, p, what in ((N_BOX_TRAIN, 7, 'box'), (N_POS_TRAIN, 14, 'mask')):
        rois, img = place(n, synthetic)
        yield (f'{HRFPN_CROPS} train {what} {n}x{p}x{p}x256 r2',
               ra.multilevel_crop_args(feats, rois, img, strides),
               dict(out_size=p, sampling_ratio=2))


def jittered(gen, boxes, amplitude=0.15, canvas=IMAGE_HW):
    """Grid R-CNN's jitter of the positives (``models/grid_rcnn.py``):
    centres moved and sides scaled by up to ``amplitude`` of the side,
    clipped to the image."""
    import torch
    h, w = canvas
    jit = (torch.rand(boxes.shape, generator=gen, device=boxes.device) * 2
           - 1) * amplitude
    cxcy = (boxes[:, 2:] + boxes[:, :2]) / 2
    wh = boxes[:, 2:] - boxes[:, :2]
    cxcy, wh = cxcy + wh * jit[:, :2], wh * (1 + jit[:, 2:])
    lim = torch.tensor([w - 1, h - 1, w - 1, h - 1], device=boxes.device)
    return torch.minimum(torch.cat([cxcy - wh / 2, cxcy + wh / 2], 1).clamp(
        min=0), lim).contiguous()


def head_crops(dev, infer=True):
    """K2's arguments at the crops phase 18 puts on K2/K4 (item 9's RoI
    heads): PointRend's coarse crop, P2 alone at 14x14 and ratio 1 (stride
    4), of an image's 100 dets (with ``infer``) and of a step's 512
    positive slots; Grid R-CNN's 14x14 crop (ratio 2) of a step's 512
    positives, jittered as its head jitters them, FPN-routed over P2-P5 and
    under GRoIE's box extractor from all four levels (4 x 512 rows, one
    launch); over the 800x1344 canvas at 256 channels, the step's RoIs
    placed as the training step places them (:func:`clustered_place`),
    from a generator of their own."""
    import torch
    from dynamask_torch.ops import roi_align as ra
    gen = torch.Generator(device=dev).manual_seed(22)
    h, w = IMAGE_HW
    strides = (4, 8, 16, 32)

    def p2_crop(feats, rois, img):
        a, b = feats[0].shape[1:3]
        n = rois.shape[0]
        flat, _ = ra._flat_planes([feats[0]])
        return (flat, rois, img * (a * b),
                torch.full((n,), a, dtype=torch.int32, device=dev),
                torch.full((n,), b, dtype=torch.int32, device=dev),
                torch.full((n,), 0.25, device=dev))

    if infer:
        feats = [torch.randn(1, h // 4, w // 4, 256, generator=gen,
                             device=dev)]
        rois, img = synthetic_rois(gen, dev, N_DETS, 1, IMAGE_HW)
        yield (f'{HEAD_CROPS} point_rend infer P2 {N_DETS}x14x14x256 r1',
               p2_crop(feats, rois, img), dict(out_size=14, sampling_ratio=1))
        del feats
    feats = [torch.randn(TRAIN_IMAGES, h // s, w // s, 256, generator=gen,
                         device=dev) for s in strides]
    place = clustered_place(gen, dev, TRAIN_IMAGES, N_POS_TRAIN)

    def synthetic(k):
        return synthetic_rois(gen, dev, k, TRAIN_IMAGES, IMAGE_HW)

    rois, img = place(N_POS_TRAIN, synthetic)
    yield (f'{HEAD_CROPS} point_rend train P2 {N_POS_TRAIN}x14x14x256 r1',
           p2_crop(feats, rois, img), dict(out_size=14, sampling_ratio=1))
    jb = jittered(gen, rois)
    yield (f'{HEAD_CROPS} grid train jittered {N_POS_TRAIN}x14x14x256 r2',
           ra.multilevel_crop_args(feats, jb, img, strides),
           dict(out_size=14, sampling_ratio=2))
    yield (f'{HEAD_CROPS} grid groie train jittered '
           f'4x{N_POS_TRAIN}x14x14x256 r2',
           ra.generic_crop_args(feats, jb, img, strides),
           dict(out_size=14, sampling_ratio=2))


def pisa_crops(dev):
    """K2's arguments at the crops phase 20 adds: PISA Faster R-CNN's
    Score-HLR pass, one box forward without a gradient over every candidate
    of a step (4 x (2000 proposals + 20 GTs) = 8080 RoIs in image order,
    7x7 at ratio 2, FPN-routed over P2-P5 of four 800x1344 images at 256
    channels; no K4 follows it), and its test crop of an image's 2000
    proposals, from a generator of their own."""
    import torch
    from dynamask_torch.ops import roi_align as ra
    gen = torch.Generator(device=dev).manual_seed(24)
    h, w = IMAGE_HW
    strides = (4, 8, 16, 32)
    for images, n, what in ((TRAIN_IMAGES, PISA_SCORE_ROIS, 'score_hlr'),
                            (1, PISA_PROPOSALS, 'infer')):
        feats = [torch.randn(images, h // s, w // s, 256, generator=gen,
                             device=dev) for s in strides]
        rois, img = synthetic_rois(gen, dev, n, images, IMAGE_HW)
        img, order = img.sort(stable=True)
        yield (f'{PISA_CROPS} {what} {n}x7x7x256 r2',
               ra.multilevel_crop_args(feats, rois[order].contiguous(), img,
                                       strides),
               dict(out_size=7, sampling_ratio=2))
        del feats


def c4_crops(dev, infer=True):
    """K2's arguments at the C4 detectors' crops (phase 21): RoIAlign of
    the 50x84 stride-16 layer3 of 800x1344 images at 1024 channels into
    14x14 bins at ratio 2, an image's 1000 proposals and 100 dets (with
    ``infer``) and a step's 2048 sampled RoIs and 512 positive slots over 4
    images, placed as the training step places them
    (:func:`clustered_place`), from a generator of their own."""
    import torch
    from dynamask_torch.ops import roi_align as ra
    gen = torch.Generator(device=dev).manual_seed(25)
    h, w = IMAGE_HW
    drives = (((1, 1000, 'infer box'), (1, N_DETS, 'infer mask'))
              if infer else ()) + ((TRAIN_IMAGES, N_BOX_TRAIN, 'train box'),
                                   (TRAIN_IMAGES, N_POS_TRAIN, 'train mask'))
    for images, n, what in drives:
        feat = torch.randn(images, h // 16, w // 16, C4_CHANNELS,
                           generator=gen, device=dev)
        if images == 1:
            rois, img = synthetic_rois(gen, dev, n, 1, IMAGE_HW)
        else:
            rois, img = clustered_place(gen, dev, images, N_POS_TRAIN)(
                n, lambda k: synthetic_rois(gen, dev, k, images, IMAGE_HW))
        yield (f'{C4_CROPS} {what} {n}x14x14x{C4_CHANNELS} r2',
               ra.multilevel_crop_args([feat], rois, img, (16,)),
               dict(out_size=14, sampling_ratio=2))
        del feat


# phase 23's frames of a 640x427 COCO image: at the second scale (1000,
# 1333) its 889x1333 region on the 1344x1344 canvas; at the first (800,
# 1333) its 800x1199 region on the 800x1344 canvas, flipped
TTA_CANVAS = (1344, 1344)
TTA_REGION = (889, 1333)
FLIP_REGION = (800, 1199)


def tta_crops(dev):
    """K2's arguments at test-time augmentation's new crops (phase 23),
    each augmentation's (:func:`_crops`: the box extract of the shared
    1000 proposals, the mask, SFM and MSM crops of 100 dets): on the
    1344x1344 canvas of the second scale, P2 336x336, the RoIs over the
    889x1333 image region; and on the 800x1344 canvas in the flipped
    800x1199 region of the first scale, the RoIs mirrored about its width
    (those partly off its left edge now past its right one, those at its
    left edge at its right), from generators of their own."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(29)

    def in_region(n, _):
        return synthetic_rois(gen, dev, n, 1, TTA_REGION)

    for case, args, kw in _crops(gen, dev, 1, 1000, N_DETS, in_region,
                                 TTA_CANVAS):
        yield f'{TTA_CROPS} 1344x1344 {case}', args, kw
    fgen = torch.Generator(device=dev).manual_seed(30)

    def flipped(n, _):
        r, b = synthetic_rois(fgen, dev, n, 1, FLIP_REGION)
        w = FLIP_REGION[1]
        return torch.stack([w - r[:, 2], r[:, 1], w - r[:, 0], r[:, 3]],
                           1).contiguous(), b

    for case, args, kw in _crops(fgen, dev, 1, 1000, N_DETS, flipped):
        yield f'{TTA_CROPS} flipped {case}', args, kw


def config_crops(dev, train=False):
    """The crops of the other configurations where they differ from the
    flagship's: LVIS inference (300 dets), Cityscapes inference on the
    1024x2048 canvas and VOC's box extract on its 1024x1024 canvas, or
    (``train``) a Cityscapes training step (1 image, 512 sampled RoIs, 128
    positive slots), each from a generator of its own."""
    import torch
    if not train:
        gen = torch.Generator(device=dev).manual_seed(6)
        for case, args, kw in _crops(gen, dev, 1, 1000, LVIS_DETS):
            yield f'{CONFIG} lvis infer {case}', args, kw
        gen = torch.Generator(device=dev).manual_seed(7)
        for case, args, kw in _crops(gen, dev, 1, 1000, N_DETS,
                                     canvas=CITY_HW):
            yield f'{CONFIG} cityscapes infer {case}', args, kw
        # the VOC config's box extract (phase 11): 1000 proposals on its
        # 1024x1024 canvas
        gen = torch.Generator(device=dev).manual_seed(15)
        case, args, kw = next(_crops(gen, dev, 1, 1000, N_DETS,
                                     canvas=VOC_HW))
        yield f'{CONFIG} voc infer {case}', args, kw
        return
    gen = torch.Generator(device=dev).manual_seed(8)
    for case, args, kw in _crops(gen, dev, 1, 512, CITY_POS,
                                 canvas=CITY_HW):
        yield f'{CONFIG} cityscapes train {case}', args, kw


def clustered_crops(dev):
    """The training crops with the training path's RoIs
    (:func:`clustered_place`), from a generator of their own so the other
    cases keep their inputs."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(3)
    place = clustered_place(gen, dev, TRAIN_IMAGES, N_POS_TRAIN)
    for case, args, kw in _crops(gen, dev, TRAIN_IMAGES, N_BOX_TRAIN,
                                 N_POS_TRAIN, place):
        yield f'{CLUSTERED} {case}', args, kw


def k2_cases(gen, dev):
    """K2 at the inference crops (one image, 1000 proposals, 100 dets) and
    at the training crops (4 images, 2048 sampled RoIs, 512 positive
    slots), then at the training crops with clustered RoIs, at the
    inference crops on the portrait canvas, at phase 8's and at
    RefineMask's P2 crops (phase 10) of its training step and of each
    config's inference, at HTC's semantic crops of a step (phase 12), at
    GRoIE's and Double-Head's crops (phase 13), at HRFPN's (phase 15), at
    item 9's heads' (phase 18), at PISA's (phase 20), at C4's (phase 21)
    and at test-time augmentation's (phase 23), each from a generator of
    its own so the other cases keep their inputs."""
    import torch
    for case, args, kw in _crops(gen, dev, 1, 1000, N_DETS):
        yield 'infer ' + case, args, kw
    for case, args, kw in _crops(gen, dev, TRAIN_IMAGES, N_BOX_TRAIN,
                                 N_POS_TRAIN):
        yield 'train ' + case, args, kw
    yield from clustered_crops(dev)
    pgen = torch.Generator(device=dev).manual_seed(5)
    for case, args, kw in _crops(pgen, dev, 1, 1000, N_DETS,
                                 canvas=PORTRAIT_HW):
        yield f'{PORTRAIT} infer {case}', args, kw
    yield from config_crops(dev)
    yield from config_crops(dev, train=True)
    for drive in REFINE_DRIVES:
        yield from refine_crops(dev, *drive)
    yield from htc_crops(dev)
    yield from two_stage_crops(dev)
    yield from hrfpn_crops(dev)
    yield from head_crops(dev)
    yield from pisa_crops(dev)
    yield from c4_crops(dev)
    yield from tta_crops(dev)


def k4_args(gen, args, kw):
    """K4's arguments on the crop of K2's ``args``: a random crop
    gradient, the flat buffer's row count and the RoI arguments."""
    import torch
    flat, rois = args[:2]
    p = kw['out_size']
    d_out = torch.randn(rois.shape[0], p, p, flat.shape[1], generator=gen,
                        device=flat.device)
    return (d_out, flat.shape[0], *args[1:])


def k4_cases(gen, dev):
    """K4 at the training crops (4 images, 2048 sampled RoIs, 512 positive
    slots), with a random crop gradient, then with clustered RoIs, at the
    Cityscapes step's crops, at RefineMask's P2 crops of a step, at HTC's
    semantic crops of a step, at GRoIE's and Double-Head's crops of a
    step, at HRFPN's crops of a step, at item 9's heads' crops of a
    step (PointRend's P2 crop, Grid R-CNN's jittered positives) and at
    the C4 detectors' crops of a step."""
    import torch
    for case, args, kw in _crops(gen, dev, TRAIN_IMAGES, N_BOX_TRAIN,
                                 N_POS_TRAIN):
        yield 'train ' + case, k4_args(gen, args, kw), kw
        del args
    cgen = torch.Generator(device=dev).manual_seed(4)
    for case, args, kw in clustered_crops(dev):
        yield case, k4_args(cgen, args, kw), kw
        del args
    cgen = torch.Generator(device=dev).manual_seed(9)
    for case, args, kw in config_crops(dev, train=True):
        yield case, k4_args(cgen, args, kw), kw
        del args
    cgen = torch.Generator(device=dev).manual_seed(11)
    for case, args, kw in refine_crops(dev, *REFINE_DRIVES[0]):
        yield case, k4_args(cgen, args, kw), kw
        del args
    cgen = torch.Generator(device=dev).manual_seed(17)
    for case, args, kw in htc_crops(dev):
        yield case, k4_args(cgen, args, kw), kw
        del args
    cgen = torch.Generator(device=dev).manual_seed(19)
    for case, args, kw in two_stage_crops(dev, infer=False):
        yield case, k4_args(cgen, args, kw), kw
        del args
    cgen = torch.Generator(device=dev).manual_seed(21)
    for case, args, kw in hrfpn_crops(dev, infer=False):
        yield case, k4_args(cgen, args, kw), kw
        del args
    cgen = torch.Generator(device=dev).manual_seed(23)
    for case, args, kw in head_crops(dev, infer=False):
        yield case, k4_args(cgen, args, kw), kw
        del args
    cgen = torch.Generator(device=dev).manual_seed(26)
    for case, args, kw in c4_crops(dev, infer=False):
        yield case, k4_args(cgen, args, kw), kw
        del args


# -- bounds: bytes each function must move, operations it must do ------------
# Each bound function gives (bytes, {type: operations}), the types keys of
# PEAK_OPS_PER_S.

def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_of(nbytes, ops):
    """(least ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over their type's peak rate. Types run on
    different units, which can overlap, so the operations take the longest
    of their types' times."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(n / PEAK_OPS_PER_S[t] for t, n in ops.items())
    return 1e3 * max(t_bytes, t_ops), (
        'bytes' if t_bytes >= t_ops else 'operations')


def k1_bound(args, kw, out):
    x, off = args
    # 4 tents + 9 for the 2x2 blend
    return _nbytes(x, off, out), {'fp32': 13 * out.numel()}


def k5_bound(args, kw, out, round_to_input):
    import torch
    x, off, w = args
    # the contraction, plus the sampling: a blend of 6 products and 3 sums
    # a column element, and the 4 tent weights once a sample (pixel, group,
    # tap), shared by the group's channels, in fp32. The frame rule on a
    # bf16 x rounds the sample and the weight to bf16 before the product
    # and sums in fp32: a bf16 tensor-core product, and its blend, each
    # step rounded to bf16, runs as packed bf16 pairs (``bf16x2``).
    # Otherwise the operands, the blend and the product are fp32.
    n, s, _, c = x.shape
    taps = off.shape[-1] // 2
    cols = n * s * s * 9 * c
    mma = 2 * cols * w.shape[-1]
    tents = 4 * n * s * s * taps
    if round_to_input and x.dtype == torch.bfloat16:
        ops = {'fp32': tents, 'bf16x2': 9 * cols, 'bf16': mma}
    else:
        ops = {'fp32': 9 * cols + tents + mma}
    return _nbytes(x, off, w, out), ops


def k3_bound(args, kw, out):
    x, off, d_col = args
    d_x, d_off = out
    # per column element: two 7-op channel terms, four corner weights times
    # the gradient and four adds into d_x
    return _nbytes(x, off, d_col, d_x, d_off), {'fp32': 22 * d_col.numel()}


def _sample_axes(rois, base, hs, ws, sc, kw):
    """Per RoI and axis, each sample's two clamped corners and its inside
    flag: ((y0, y1, in_y), (x0, x1, in_x)), each (N, P*s). The samples are
    the plain version's (``roi_align_fwd_plain``), written out here so that
    the bounds need nothing of the checkout under test."""
    import torch
    p, s = kw['out_size'], kw['sampling_ratio']
    k = torch.arange(p * s, device=rois.device)
    grid = (k // s).float() + ((k % s).float() + 0.5) / s

    def axis(lo, hi, extent):
        lo, hi = lo * sc - 0.5, hi * sc - 0.5
        v = lo[:, None] + ((hi - lo) / torch.full_like(lo, float(p)))[
            :, None] * grid[None, :]
        ef = extent.float()[:, None]
        v0 = torch.floor(torch.minimum(v.clamp(min=0.0), ef - 1)).long()
        v1 = torch.minimum(v0 + 1, extent.long()[:, None] - 1)
        return v0, v1, (v >= -1.0) & (v <= ef)

    return (axis(rois[:, 1], rois[:, 3], hs), axis(rois[:, 0], rois[:, 2], ws))


def rows_read(args, kw):
    """How many rows of the flat features a K2 crop must read: those that
    hold a corner of an inside sample, each once."""
    import torch
    flat, rois, base, hs, ws, sc = args
    (y0, y1, in_y), (x0, x1, in_x) = _sample_axes(rois, base, hs, ws, sc, kw)
    inside = in_y[:, :, None] & in_x[:, None, :]
    read = torch.zeros(flat.shape[0], dtype=torch.bool, device=flat.device)
    w = ws.long()[:, None, None]
    for yy in (y0, y1):
        for xx in (x0, x1):
            at = base[:, None, None] + yy[:, :, None] * w + xx[:, None, :]
            read[at[inside]] = True
    return int(read.sum())


def bins_read(args, kw):
    """How many bins of d_out a K4 crop must read: those with an inside
    sample (the others pass nothing)."""
    _, _, rois, base, hs, ws, sc = args
    p, s = kw['out_size'], kw['sampling_ratio']
    (_, _, in_y), (_, _, in_x) = _sample_axes(rois, base, hs, ws, sc, kw)
    return int((in_y.reshape(-1, p, s).any(2).sum(1) *
                in_x.reshape(-1, p, s).any(2).sum(1)).sum())


# the operations of one sample's four bilinear weights from its fractional
# position (ly, lx): hy = 1 - ly, hx = 1 - lx, then the four products
BILINEAR_WEIGHT_OPS = 6


def k2_bound(args, kw, out):
    # the features each crop reads (not the whole pyramid), once
    flat, rois, base, hs, ws, sc = args
    feat_bytes = rows_read(args, kw) * flat.shape[1] * flat.element_size()
    # per sample and channel: four products with the corner weights, added
    # (4 FMAs); per bin and channel: the mean's one scale; the four weights
    # are the sample's, shared by its channels (BILINEAR_WEIGHT_OPS each)
    s2 = kw['sampling_ratio'] ** 2
    return (feat_bytes + _nbytes(rois, base, hs, ws, sc, out),
            {'fp32': out.numel() * (s2 * 8 + 1) +
             out[..., 0].numel() * s2 * BILINEAR_WEIGHT_OPS})


def k4_bound(args, kw, out):
    # the d_out bins with an inside sample, read once; all of d_flat, the
    # wrapper's output, written once
    d_out, _, rois, base, hs, ws, sc = args
    d_out_bytes = bins_read(args, kw) * d_out.shape[-1] * d_out.element_size()
    # per bin and channel: the mean's one scale; per sample and channel:
    # four products of the corner weights with it, four adds into d_flat;
    # the four weights per sample, shared by its channels
    s2 = kw['sampling_ratio'] ** 2
    return (d_out_bytes + _nbytes(rois, base, hs, ws, sc, out),
            {'fp32': d_out.numel() * (s2 * 8 + 1) +
             d_out[..., 0].numel() * s2 * BILINEAR_WEIGHT_OPS})


def k3_zeros(got, ref, args, kw):
    """K3's offset gradient against the VJP's zeros: (held, incidental,
    largest). ``held``: it is exactly 0 wherever the rules make it so (the
    sample outside, an integer clipped displacement, the clip;
    ``deform_conv.offset_grad_live``), as the plain version's is.
    Elsewhere it is held to the tolerance only: a channel sum that cancels
    to exactly 0 in one order of summation may leave a last-bit residue in
    another. ``incidental``: the plain version's zeros where the rules
    leave the gradient live; ``largest``: K3's largest magnitude there."""
    from dynamask_torch.ops.deform_conv import offset_grad_live
    x, off = args[:2]
    live = offset_grad_live(off, x.shape[1], x.shape[2], **kw)
    there = got[1][live & (ref[1] == 0)].float()
    largest = float(there.abs().max()) if there.numel() else 0.0
    return not (got[1][~live] != 0).any(), there.numel(), largest


def _compare(got, ref):
    """(max abs error, max abs reference, all finite) over one output or a
    tuple of outputs."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, ref))
    scale = max(b.float().abs().max().item() for b in ref)
    return err, scale, all(torch.isfinite(a).all().item() for a in got)


def kernel_specs():
    import dynamask_torch.ops as ops
    from dynamask_torch.ops import (deform_conv as dc, deform_conv_fused as
                                    dcf, roi_align as ra)
    no_lib = ('no PyTorch call computes this function (no DCN or RoIAlign '
              'op in PyTorch without torchvision)')
    k5 = dict(cases=k5_cases, limit=k5_limit, yardstick=dc.deform_conv2d,
              source='dynamask_torch/ops/csrc/deform_conv_fused.cu',
              library_null='no PyTorch call computes a DCN')
    return (
        dict(name='deform_im2col_windowed', kernel=dc.deform_im2col_windowed,
             plain=dc.deform_im2col_windowed_plain, cases=k1_cases,
             bound=k1_bound, limit=abs_limit(K1_TOL),
             source='dynamask_torch/ops/csrc/deform_im2col.cu',
             replaces='dynamask_tpu/ops/deform_conv_pallas.py:318',
             library_null=no_lib),
        dict(name='roi_align_fwd', kernel=ra.roi_align_fwd,
             plain=ra.roi_align_fwd_plain, cases=k2_cases, bound=k2_bound,
             limit=abs_limit(K2_TOL),
             source='dynamask_torch/ops/csrc/roi_align.cu',
             replaces='dynamask_tpu/ops/roi_align_pallas.py:45',
             library_null=no_lib),
        dict(name='deform_col2im_windowed',
             kernel=dc.deform_col2im_windowed,
             plain=dc.deform_col2im_windowed_plain, cases=k3_cases,
             bound=k3_bound, limit=rel_limit(K3_RTOL),
             source='dynamask_torch/ops/csrc/deform_col2im.cu',
             replaces='dynamask_tpu/ops/deform_conv_pallas.py:535',
             library_null='no PyTorch call computes the DCN backward'),
        dict(name='roi_align_bwd', kernel=ra.roi_align_bwd,
             plain=ra.roi_align_bwd_plain, cases=k4_cases, bound=k4_bound,
             limit=rel_limit(K4_RTOL),
             source='dynamask_torch/ops/csrc/roi_align_bwd.cu',
             # no Pallas backward: XLA autodiff of the gather form
             replaces='dynamask_tpu/ops/roi_align.py:46',
             library_null='no PyTorch call computes the RoIAlign backward'),
        dict(name='deform_conv2d_windowed_fused',
             kernel=dcf.deform_conv2d_windowed_fused,
             plain=functools.partial(dcf.deform_conv2d_fused_plain,
                                     round_to_input=False),
             bound=functools.partial(k5_bound, round_to_input=False),
             replaces='dynamask_tpu/ops/deform_conv_pallas.py:40', **k5),
        dict(name='deform_conv2d_frame', kernel=dcf.deform_conv2d_frame,
             plain=functools.partial(dcf.deform_conv2d_fused_plain,
                                     round_to_input=True),
             bound=functools.partial(k5_bound, round_to_input=True),
             replaces='dynamask_tpu/ops/deform_conv_pallas.py:177', **k5),
        # the bf16 instances of K1-K4 (the mixed-precision paths, phase 9)
        dict(name='deform_im2col_windowed' + ops.BF16,
             kernel=dc.deform_im2col_windowed,
             plain=dc.deform_im2col_windowed_plain, cases=k1_bf16_cases,
             bound=k1_bound, limit=bf16_limit,
             source='dynamask_torch/ops/csrc/deform_im2col.cu',
             replaces='dynamask_tpu/ops/deform_conv_pallas.py:318',
             library_null=no_lib),
        dict(name='roi_align_fwd' + ops.BF16, kernel=ra.roi_align_fwd,
             plain=ra.roi_align_fwd_plain, cases=k2_bf16_cases,
             bound=k2_bound, limit=bf16_limit,
             source='dynamask_torch/ops/csrc/roi_align.cu',
             replaces='dynamask_tpu/ops/roi_align_pallas.py:45',
             library_null=no_lib),
        dict(name='deform_col2im_windowed' + ops.BF16,
             kernel=dc.deform_col2im_windowed,
             plain=dc.deform_col2im_windowed_plain, cases=k3_bf16_cases,
             bound=k3_bound, limit=rounded_rel_limit(K3_RTOL),
             source='dynamask_torch/ops/csrc/deform_col2im.cu',
             replaces='dynamask_tpu/ops/deform_conv_pallas.py:535',
             library_null='no PyTorch call computes the DCN backward'),
        dict(name='roi_align_bwd' + ops.BF16, kernel=ra.roi_align_bwd,
             plain=ra.roi_align_bwd_plain, cases=k4_bf16_cases,
             bound=k4_bound, limit=rel_limit(K4_RTOL),
             source='dynamask_torch/ops/csrc/roi_align_bwd.cu',
             replaces='dynamask_tpu/ops/roi_align.py:46',
             library_null='no PyTorch call computes the RoIAlign backward'))


# K5's instances by the C symbol the wrapper calls, each with the name its
# kernel functions' mangled names begin with in the library's SASS
K5_INSTANCES = {'deform_conv_fused_f32': 'k5_fma_kernelIf',
                'deform_conv_fused_bf16': 'k5_fma_kernelI13__nv_bfloat16',
                'deform_conv_fused_bf16_round': 'k5_mma_kernel'}
TENSOR_CORE_OPCODES = ('HMMA', 'HGMMA')


def cuobjdump_path():
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin',
                              'cuobjdump'),
                 shutil.which('cuobjdump'), '/usr/local/cuda/bin/cuobjdump'):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('cuobjdump not found: the CUDA toolkit has it')


def check_k5_sass(lib):
    """Phase 1: the tensor-core instructions of K5's three instances in
    ``cuobjdump -sass`` of its library ``lib``, summed over each
    instance's kernel functions (its tiles and vector widths). The frame
    rule on bf16 must run its product on the tensor cores, the fp32-rule
    instances must not."""
    import re
    sass = subprocess.run([cuobjdump_path(), '-sass', lib], check=True,
                          capture_output=True, text=True).stdout
    counts = {sym: dict.fromkeys(TENSOR_CORE_OPCODES, 0)
              for sym in K5_INSTANCES}
    functions = dict.fromkeys(K5_INSTANCES, 0)
    into = None
    for line in sass.splitlines():
        head = re.match(r'\s*Function : (\S+)', line)
        if head:
            into = next((sym for sym, stem in K5_INSTANCES.items()
                         if stem in head.group(1)), None)
            if into:
                functions[into] += 1
            continue
        op = re.match(r'\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)',
                      line)
        if into and op and op.group(1) in TENSOR_CORE_OPCODES:
            counts[into][op.group(1)] += 1
    print(f'  K5 SASS, tensor-core instructions per instance (kernel '
          f'functions): ' + '; '.join(
              f'{sym} {functions[sym]} fn, ' + ', '.join(
                  f'{op} {n}' for op, n in counts[sym].items())
              for sym in K5_INSTANCES))
    if min(functions.values()) == 0:
        raise RuntimeError(f'K5 SASS: an instance with no kernel function '
                           f'{functions}')
    if sum(counts['deform_conv_fused_bf16_round'].values()) == 0:
        raise RuntimeError('K5 SASS: the bf16 frame-rule instance has no '
                           'tensor-core instruction')
    for sym in ('deform_conv_fused_f32', 'deform_conv_fused_bf16'):
        if sum(counts[sym].values()):
            raise RuntimeError(f'K5 SASS: the fp32-rule instance {sym} has '
                               f'tensor-core instructions {counts[sym]}')
    return dict(counts=counts, functions=functions)


# K5 off the SFM shapes, as the entry points' contract allows: ragged pixel,
# channel-chunk and output-channel tiles, one deform group, a wider padding
# and dilation, a narrower window; (n, S, C, C_out, g, padding, dilation,
# window)
K5_EDGE_SHAPES = ((3, 13, 96, 70, 2, 1, 1, 3), (2, 9, 64, 130, 1, 2, 2, 2),
                  (1, 5, 8, 3, 2, 1, 1, 3), (4, 17, 40, 24, 2, 1, 1, 1))


def check_k5_edges(report):
    """Phase 2, K5 at the edge shapes, both entry points, fp32 and bf16,
    against the plain version (untimed)."""
    import torch
    from dynamask_torch.ops import deform_conv_fused as dcf
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    worst = {}
    for n, s, c, c_out, g, pad, dil, win in K5_EDGE_SHAPES:
        x = torch.randn(n, s, s, c, generator=gen, device=DEVICE)
        off = (torch.rand(n, s, s, 18 * g, generator=gen, device=DEVICE) -
               0.5) * 10
        w = torch.randn(3, 3, c, c_out, generator=gen, device=DEVICE) / \
            math.sqrt(9 * c)
        for dtype in (torch.float32, torch.bfloat16):
            for fn, rule in ((dcf.deform_conv2d_windowed_fused, False),
                             (dcf.deform_conv2d_frame, True)):
                args = (x.to(dtype), off, w, 3, pad, dil, g, win)
                got = fn(*args)
                torch.cuda.synchronize(DEVICE)
                err, scale, finite = _compare(
                    got, dcf.deform_conv2d_fused_plain(
                        *args, round_to_input=rule))
                limit, tol = k5_limit(scale, got)
                key = f'{fn.__name__} {dtype}'.replace('torch.', '')
                worst[key] = max(worst.get(key, 0.0), err / limit)
                if not (err <= limit and finite):
                    raise RuntimeError(
                        f'{fn.__name__} disagrees with its plain version at '
                        f'n {n}, S {s}, C {c}, C_out {c_out}, g {g}, pad '
                        f'{pad}, dil {dil}, window {win}, {dtype}: max abs '
                        f'err {err} (limit {limit}, {tol})')
    print(f'  K5 at {len(K5_EDGE_SHAPES)} edge shapes: largest error over '
          f'its tolerance per entry point and type {worst}')
    report['k5_edges'] = worst


# K1 and K3 off the SFM shapes: ragged bands (S = 13, 17), one deform group,
# channels per group not a multiple of 4 (the scalar instance), padding 2
# with dilation 2, windows 1 and 2, one RoI, a base off 16-byte alignment
# (the scalar instance at cg = 32), and SAC's large branch (one group,
# padding and dilation 3); (n, S, C, g, padding, dilation, window,
# misaligned)
DCN_EDGE_SHAPES = ((2, 13, 64, 2, 1, 1, 3, False),
                   (2, 17, 64, 2, 1, 1, 3, False),
                   (2, 14, 64, 1, 1, 1, 3, False),
                   (2, 9, 6, 2, 1, 1, 3, False),
                   (2, 12, 20, 2, 1, 1, 3, False),
                   (2, 14, 64, 2, 2, 2, 3, False),
                   (2, 14, 64, 2, 1, 1, 1, False),
                   (2, 14, 64, 2, 1, 1, 2, False),
                   (1, 28, 128, 2, 1, 1, 3, False),
                   (2, 14, 64, 2, 1, 1, 3, True),
                   (2, 14, 64, 1, 3, 3, 3, False))


def dcn_edge_offsets(gen, kind, n, s, g, window):
    """Offsets of one edge case: ``random`` up to ±10 px, ``zero`` (every
    DCN's init: K3 must give exactly 0 offset gradient), ``exact``
    displacements of exactly ±window and integers, and a quarter inside and
    outside the window's edge."""
    import torch
    shape = (n, s, s, g, 3, 3, 2)
    if kind == 'random':
        off = (torch.rand(shape, generator=gen, device=DEVICE) - 0.5) * 20
    elif kind == 'zero':
        off = torch.zeros(shape, device=DEVICE)
    else:
        vals = torch.tensor([-window, window, 0., 1., -1., 2., -2.,
                             window - 0.25, -window - 0.25], device=DEVICE)
        rel = vals[torch.randint(0, len(vals), shape, generator=gen,
                                 device=DEVICE)]
        base = torch.arange(3, device=DEVICE, dtype=torch.float32) - 1.0
        # offsets that put the displacement itself on those values at
        # padding 1, dilation 1 (rel = tap base + offset)
        off = rel - torch.stack(torch.meshgrid(base, base, indexing='ij'),
                                -1)
    return off.reshape(n, s, s, -1).contiguous()


def check_dcn_edges(report):
    """Phase 2, K1 and K3 at the edge shapes with three kinds of offsets,
    in fp32 and in bf16, against their plain versions (untimed). K3's
    offset gradient must be exactly 0 wherever the tent and clip rules make
    the plain version's so (``k3_zeros``)."""
    import torch
    import dynamask_torch.ops as ops
    from dynamask_torch.ops import deform_conv as dc
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    worst = {}
    for (n, s, c, g, pad, dil, win, misaligned), dtype, kind in \
            itertools.product(DCN_EDGE_SHAPES,
                              (torch.float32, torch.bfloat16),
                              ('random', 'zero', 'exact')):
        bf16 = dtype == torch.bfloat16
        x = torch.randn(n * s * s * c + misaligned, generator=gen,
                        device=DEVICE).to(dtype)[int(misaligned):].view(
                            n, s, s, c)
        off = dcn_edge_offsets(gen, kind, n, s, g, win).to(dtype)
        kw = dict(kernel_size=3, padding=pad, dilation=dil,
                  deform_groups=g, window=win)
        d_col = torch.randn(n, s, s, g, 9, c // g, generator=gen,
                            device=DEVICE).to(dtype)
        where = (f'n {n}, S {s}, C {c}, g {g}, pad {pad}, dil {dil}, '
                 f'window {win}, {kind} offsets, {dtype}'
                 f'{", misaligned x" if misaligned else ""}')
        for name, args, limit in (
                ('deform_im2col_windowed', (x, off),
                 bf16_limit if bf16 else abs_limit(K1_TOL)),
                ('deform_col2im_windowed', (x, off, d_col),
                 (rounded_rel_limit if bf16 else rel_limit)(K3_RTOL))):
            kernel = getattr(dc, name)
            key = name + (ops.BF16 if bf16 else '')
            launches = ops.kernel_launches()[key]
            got = kernel(*args, **kw)
            torch.cuda.synchronize(DEVICE)
            if ops.kernel_launches()[key] != launches + 1:
                raise RuntimeError(f'{key} did not launch its kernel')
            ref = getattr(dc, name + '_plain')(*args, **kw)
            err, scale, finite = _compare(got, ref)
            lim, tol = limit(scale, got)
            worst[key] = max(worst.get(key, 0.0), err / lim)
            if not (err <= lim and finite):
                raise RuntimeError(
                    f'{key} disagrees with its plain version at '
                    f'{where}: max abs err {err} (limit {lim}, {tol})')
            if name == 'deform_col2im_windowed' and not k3_zeros(
                    got, ref, args, kw)[0]:
                raise RuntimeError(
                    f'{key} gives an offset gradient where the tent and '
                    f'clip rules give exactly 0, at {where}')
    print(f'  K1 and K3 at {len(DCN_EDGE_SHAPES)} edge shapes x 3 offset '
          f'kinds, fp32 and bf16: largest error over its tolerance {worst}')
    report['dcn_edges'] = worst


# K2 and K4 off the main path's crops: channels not a multiple of 4 (the
# scalar instance), one bin, three samples a bin, one RoI, a 1x1 plane, bins
# far narrower than a pixel, and a base off 16-byte alignment (the scalar
# instance at C = 32); (n, P, s, C, plane height, plane width, misaligned)
ROI_EDGE_SHAPES = ((9, 7, 2, 3, 20, 24, False), (9, 14, 1, 10, 20, 24, False),
                   (9, 1, 2, 16, 20, 24, False), (9, 7, 3, 16, 20, 24, False),
                   (1, 7, 2, 16, 20, 24, False), (9, 7, 2, 16, 1, 1, False),
                   (9, 56, 1, 8, 12, 10, False), (9, 14, 2, 32, 20, 24, True))


def roi_edge_rois(gen, n, p, s, h, w):
    """``n`` RoIs on an h x w plane at scale 1 for a P x P crop with s x s
    samples a bin, cycling through kinds: random boxes up to twice the
    plane, zero-area, wholly off the plane, partly off it, the whole plane,
    and exact-edge boxes of bin 1 whose first sample falls exactly on -1,
    or whose last falls exactly on the extent (in binary, for s = 1 and 2),
    each also moved 2^-8 past that edge: the inclusion test's two sides."""
    import torch

    def box(x1, y1, x2, y2):
        return torch.tensor([x1, y1, x2, y2], dtype=torch.float32,
                            device=DEVICE)

    low = -0.5 - 0.5 / s                   # first sample at -1
    high_x, high_y = w - p + 0.5 / s + 0.5, h - p + 0.5 / s + 0.5
    eps = 2.0 ** -8
    kinds = [
        lambda: torch.sort(torch.rand(2, 2, generator=gen, device=DEVICE) *
                           torch.tensor([2 * w, 2 * h], device=DEVICE) -
                           torch.tensor([w / 2, h / 2], device=DEVICE),
                           dim=0)[0].reshape(-1),
        lambda: box(w / 3, h / 2, w / 3, h / 2),
        lambda: box(w + 3, h + 2, w + 9, h + 7),
        lambda: box(-5, -4, w / 2, h / 2),
        lambda: box(0, 0, w, h),
        lambda: box(low, low, low + p, low + p),
        lambda: box(low - eps, low - eps, low - eps + p, low - eps + p),
        lambda: box(high_x, high_y, high_x + p, high_y + p),
        lambda: box(high_x + eps, high_y + eps, high_x + eps + p,
                    high_y + eps + p)]
    return torch.stack([kinds[i % len(kinds)]() for i in range(n)])


def check_roi_edges(report):
    """Phase 2, K2 and K4 at the edge shapes, in fp32 and in bf16, against
    their plain versions (untimed). Where the plain crop is exactly 0
    (every sample outside) K2's must be too: the kernels make the same
    inside and outside decisions."""
    import torch
    import dynamask_torch.ops as ops
    from dynamask_torch.ops import roi_align as ra
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    worst = {}
    for (n, p, s, c, h, w, misaligned), dtype in itertools.product(
            ROI_EDGE_SHAPES, (torch.float32, torch.bfloat16)):
        bf16 = dtype == torch.bfloat16
        images = 2
        rows = images * h * w
        flat = torch.randn(rows * c + misaligned, generator=gen,
                           device=DEVICE).to(dtype)[int(misaligned):].view(
                               rows, c)
        rois = roi_edge_rois(gen, n, p, s, h, w)
        crop = (rois, (torch.arange(n, device=DEVICE) % images) * (h * w),
                torch.full((n,), h, dtype=torch.int32, device=DEVICE),
                torch.full((n,), w, dtype=torch.int32, device=DEVICE),
                torch.ones(n, device=DEVICE))
        d_out = torch.randn(n * p * p * c + misaligned, generator=gen,
                            device=DEVICE).to(dtype)[int(misaligned):].view(
                                n, p, p, c)
        where = (f'n {n}, P {p}, s {s}, C {c}, plane {h}x{w}, {dtype}'
                 f'{", misaligned" if misaligned else ""}')
        for name, args, limit in (
                ('roi_align_fwd', (flat, *crop),
                 bf16_limit if bf16 else abs_limit(K2_TOL)),
                ('roi_align_bwd', (d_out, rows, *crop), rel_limit(K4_RTOL))):
            kernel = getattr(ra, name)
            key = name + (ops.BF16 if bf16 else '')
            launches = ops.kernel_launches()[key]
            got = kernel(*args, p, s)
            torch.cuda.synchronize(DEVICE)
            if ops.kernel_launches()[key] != launches + 1:
                raise RuntimeError(f'{key} did not launch its kernel')
            ref = getattr(ra, name + '_plain')(*args, p, s)
            err, scale, finite = _compare(got, ref)
            lim, tol = limit(scale, got)
            worst[key] = max(worst.get(key, 0.0), err / lim)
            if not (err <= lim and finite):
                raise RuntimeError(f'{key} disagrees with its plain version '
                                   f'at {where}: max abs err {err} (limit '
                                   f'{lim}, {tol})')
            if name == 'roi_align_fwd' and (got[ref == 0] != 0).any():
                raise RuntimeError(f'{key} samples where its plain version '
                                   f'has no inside sample, at {where}')
    print(f'  K2 and K4 at {len(ROI_EDGE_SHAPES)} edge shapes, fp32 and '
          f'bf16: largest error over its tolerance {worst}')
    report['roi_edges'] = worst


def check_refusals(report):
    """Phase 2: a CUDA tensor of a type no instance takes (fp16), or a bf16
    tensor beside an fp32 one, is refused with an error and launches
    nothing: no wrapper casts it or falls back to its plain version."""
    import torch
    from dynamask_torch.ops import deform_conv as dc, kernel_launches
    from dynamask_torch.ops import roi_align as ra
    x = torch.zeros(2, 8, 8, 16, device=DEVICE)
    off = torch.zeros(2, 8, 8, 36, device=DEVICE)
    d_col = torch.zeros(2, 8, 8, 2, 9, 8, device=DEVICE)
    n, dcn = 2, (3, 1, 1, 2, 3)
    crop = (torch.zeros(n, 4, device=DEVICE),
            torch.zeros(n, dtype=torch.int64, device=DEVICE),
            torch.full((n,), 8, dtype=torch.int32, device=DEVICE),
            torch.full((n,), 8, dtype=torch.int32, device=DEVICE),
            torch.ones(n, device=DEVICE))
    flat, d_out = (torch.zeros(64, 16, device=DEVICE),
                   torch.zeros(n, 7, 7, 16, device=DEVICE))
    cases = (
        ('K1 fp16', lambda: dc.deform_im2col_windowed(x.half(), off.half(),
                                                      *dcn)),
        ('K1 bf16 x, fp32 offsets', lambda: dc.deform_im2col_windowed(
            x.bfloat16(), off, *dcn)),
        ('K3 bf16 x, fp32 d_col', lambda: dc.deform_col2im_windowed(
            x.bfloat16(), off.bfloat16(), d_col, *dcn)),
        ('K2 fp16', lambda: ra.roi_align_fwd(flat.half(), *crop, 7, 2)),
        ('K4 fp16', lambda: ra.roi_align_bwd(d_out.half(), 64, *crop, 7, 2)))
    before = kernel_launches()
    for name, call in cases:
        try:
            call()
        except (TypeError, ValueError):
            continue
        raise RuntimeError(f'{name}: accepted, not refused')
    torch.cuda.synchronize(DEVICE)
    if kernel_launches() != before:
        raise RuntimeError('a refused call launched a kernel')
    print(f'  {len(cases)} calls of unsupported types refused, none '
          f'launched: {", ".join(c for c, _ in cases)}')
    report['refused'] = [c for c, _ in cases]


def check_kernels(report):
    """Phase 2: each kernel against its plain version, timed."""
    import torch
    from dynamask_torch.ops import kernel_launches
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    for spec in kernel_specs():
        name, kernel, plain = spec['name'], spec['kernel'], spec['plain']
        agg = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, yardstick_ms=0.0,
                   bound_ms={'bytes': 0.0, 'operations': 0.0})
        for case, args, kw in spec['cases'](gen, DEVICE):
            launches = kernel_launches()[name]
            got = kernel(*args, **kw)
            torch.cuda.synchronize(DEVICE)
            if kernel_launches()[name] != launches + 1:
                raise RuntimeError(f'{name} did not launch its kernel')
            ref = plain(*args, **kw)
            err, scale, finite = _compare(got, ref)
            limit, tol = spec['limit'](scale, got)
            if not (err <= limit and finite):
                raise RuntimeError(f'{name} [{case}] disagrees with its '
                                   f'plain version: max abs err {err} '
                                   f'(limit {limit}, max |ref| {scale})')
            zeros = k3_zeros(got, ref, args, kw) if name.startswith(
                'deform_col2im') else None
            if zeros and not zeros[0]:
                raise RuntimeError(f'{name} [{case}] gives an offset '
                                   'gradient where the tent and clip rules '
                                   'give exactly 0')
            if zeros is not None and case.endswith(' zero') and \
                    got[1].any():
                raise RuntimeError(f'{name} [{case}]: an offset gradient '
                                   'from zero offsets, where it must be '
                                   'exactly 0 (3f)')
            del ref
            ms = cuda_ms(lambda: kernel(*args, **kw))
            plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=5)
            nbytes, ops = spec['bound'](args, kw, got)
            b_ms, by = bound_of(nbytes, ops)
            gflop = ', '.join(f'{n / 1e9:.2f} GFLOP {t}'
                              for t, n in ops.items())
            line = (f'  {name} [{case}]: max_abs_err {err:.3e} (tol {limit:.3e}'
                    f', {tol}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
                    f'bound {b_ms:.4f} ms by {by} ({nbytes / 1e9:.4f} GB, '
                    f'{gflop})')
            case_rec = dict(
                name=name, case=case, max_abs_err=err, max_abs_ref=scale,
                tol=limit, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, bytes=nbytes, ops=ops)
            if zeros and zeros[1]:
                line += (f'; {zeros[1]} live offset gradients the plain '
                         f'version sums to exactly 0, K3 at most '
                         f'{zeros[2]:.3e} there')
                case_rec['incidental_zeros'] = list(zeros[1:])
            if 'yardstick' in spec:   # the main path's form: K1 + matmul
                y_ms = cuda_ms(lambda: spec['yardstick'](*args, **kw))
                line += f', K1 + GEMM {y_ms:.4f} ms'
                case_rec['k1_gemm_ms'] = y_ms
                agg['yardstick_ms'] += y_ms
            print(line)
            report['kernel_cases'].append(case_rec)
            if case.startswith(OFF_ROW):   # on lines of their own only
                del got, args
                continue
            agg['max_abs_err'] = max(agg['max_abs_err'], err)
            agg['ms'] += ms
            agg['plain_ms'] += plain_ms
            agg['bound_ms'][by] += b_ms
            del got, args
            torch.cuda.empty_cache()
        # the cases run one after another: their bounds add up, and the row
        # is bound by what bounds the larger part of the sum
        bound = agg['bound_ms']
        rows.append(dict(
            name=name, route='cuda', source=spec['source'],
            replaces=spec['replaces'], launches=None,
            max_abs_err=agg['max_abs_err'], ms=agg['ms'],
            plain_ms=agg['plain_ms'], bound_ms=sum(bound.values()),
            bound_by=max(bound, key=bound.get),
            library_ms=None, library_ms_null=spec['library_null']))
        if 'yardstick' in spec:
            rows[-1]['k1_gemm_ms'] = agg['yardstick_ms']
    return rows


# -- phase 3: a toy model, GPU against CPU ------------------------------------

TOY_CONFIGS = {'dynamask': FLAGSHIP, 'mask_rcnn': MASK_RCNN,
               'refinemask': REFINEMASK,
               'faster_rcnn': os.path.join(
                   ROOT, 'configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py'),
               'x101': os.path.join(ROOT, 'configs/mask_rcnn/'
                                    'mask_rcnn_x101_32x4d_fpn_1x_coco.py'),
               'caffe': os.path.join(ROOT, 'configs/mask_rcnn/'
                                     'mask_rcnn_r50_caffe_fpn_1x_coco.py'),
               'cascade': os.path.join(ROOT, 'configs/cascade_rcnn/'
                                       'cascade_mask_rcnn_r50_fpn_1x_coco.py'),
               'htc': os.path.join(ROOT, 'configs/htc/htc_r50_fpn_1x_coco.py'),
               'gn_ws': os.path.join(ROOT, 'configs/gn+ws/'
                                     'mask_rcnn_r50_fpn_gn_ws-all_2x_coco.py'),
               'groie': os.path.join(ROOT, 'configs/groie/'
                                     'mask_rcnn_r50_fpn_groie_1x_coco.py'),
               'double_head': os.path.join(
                   ROOT, 'configs/double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py'),
               # phase 17's two-stage toys
               'ga_faster': os.path.join(
                   ROOT, 'configs/guided_anchoring/'
                   'ga_faster_r50_fpn_1x_coco.py'),
               'detectors': os.path.join(
                   ROOT, 'configs/detectors/'
                   'detectors_cascade_rcnn_r50_1x_coco.py'),
               # phase 18's: item 9's RoI heads
               'point_refine': os.path.join(
                   ROOT, 'configs/point_refine/r50_point_refine_1x.py'),
               'point_rend': os.path.join(
                   ROOT, 'configs/point_rend/'
                   'point_rend_r50_caffe_fpn_mstrain_1x_coco.py'),
               'ms_rcnn': os.path.join(
                   ROOT, 'configs/ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py'),
               'grid_rcnn': os.path.join(
                   ROOT, 'configs/grid_rcnn/'
                   'grid_rcnn_r50_fpn_gn-head_1x_coco.py'),
               'dynamic_rcnn': os.path.join(
                   ROOT, 'configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x.py'),
               # phase 20's: PISA's and Libra's RoI heads
               'pisa_mask_rcnn': os.path.join(
                   ROOT, 'configs/pisa/pisa_mask_rcnn_r50_fpn_1x_coco.py'),
               'libra_faster_rcnn': os.path.join(
                   ROOT, 'configs/libra_rcnn/'
                   'libra_faster_rcnn_r50_fpn_1x_coco.py'),
               # phase 21's: C4 and the modulated DeformRoIPool
               'c4': os.path.join(ROOT, 'configs/mask_rcnn/'
                                  'mask_rcnn_r50_caffe_c4_1x_coco.py'),
               'mdpool': os.path.join(ROOT, 'configs/dcn/'
                                      'faster_rcnn_r50_fpn_mdpool_1x_coco.py')}
# the toys whose RoI head is a cascade of stages (phase 12)
CASCADE_TOYS = ('cascade', 'htc')
# phase 17's: the GA-Faster R-CNN's guided anchors (a square a location)
# and the DetectoRS Cascade Mask R-CNN's SAC + RFP at depth 50
GA_TOYS = ('ga_faster',)
ITEM9_TWO_STAGE_TOYS = GA_TOYS + ('detectors',)
# phase 18's: item 9's RoI heads
HEAD_TOYS = ('point_refine', 'point_rend', 'ms_rcnn', 'grid_rcnn',
             'dynamic_rcnn')
# the toys at depth 50, the ResNeXt and caffe backbones' own blocks
DEEP_TOYS = ('x101', 'caffe')
# the toys of the two-stage family's options (phase 13)
TWO_STAGE_TOYS = ('gn_ws', 'groie', 'double_head')


def toy_cfg(kind='dynamask'):
    """A small DynaMask Mask R-CNN (ResNet-18, 32-channel FPN, 8 classes);
    ``kind='mask_rcnn'``: the same from the Mask R-CNN config, its FCN mask
    head at 2 convs of 32 channels; ``'refinemask'``: from the RefineMask
    R50 1x config, one instance and two semantic convs of 32 channels;
    ``'faster_rcnn'``: from the Faster R-CNN config, box-only; ``'x101'``
    and ``'caffe'``: from the ResNeXt-32x4d and the caffe-style Mask R-CNN
    configs at depth 50, their FCN heads as the Mask R-CNN toy's;
    ``'cascade'`` and ``'htc'``: from the Cascade Mask R-CNN and HTC
    configs, each stage's box and mask head as the Mask R-CNN toy's, HTC's
    semantic head at 32 channels; ``'gn_ws'``, ``'groie'`` and
    ``'double_head'``: from the GN+WS and GRoIE Mask R-CNN and the
    Double-Head Faster R-CNN configs (GN of 32 groups throughout, the
    shared convs at 32 channels; Double-Head's tower at 64); an item-7
    toy (``ITEM7_TOYS``, phase 16): its config's Mask R-CNN at depth 50
    with the toy's backbone keys, the heads as the Mask R-CNN toy's;
    ``'ga_faster'``: from the GA-Faster R-CNN config (its GA-RPN head at
    32 channels, test proposals as the training ones, which the GA
    builder requires); ``'detectors'``: from the DetectoRS Cascade Mask
    R-CNN config at depth 50 (both backbones), its RFP's ASPP at 8
    channels a branch, the heads as the cascade toy's; phase 18's
    (``HEAD_TOYS``): PointRefine (as the DynaMask toy's mask head),
    PointRend (coarse and point heads at 32 channels, 64-wide fcs), Mask
    Scoring R-CNN (the Mask R-CNN toy's mask head, the MaskIoU head on its
    32 channels), Grid R-CNN (2 convs, 8 channels a point) and Dynamic
    R-CNN (box-only), each from its config file; phase 20's PISA Mask
    R-CNN (the Mask R-CNN toy's heads under its Score-HLR sampler) and
    Libra Faster R-CNN (its FPN and BFP at 32 channels)."""
    from dynamask_torch.utils import Config
    cfg = Config.fromfile(TOY_CONFIGS[kind] if kind in TOY_CONFIGS
                          else ITEM7_TOYS[kind][0])
    m = cfg.model
    if kind == 'c4':
        return c4_toy_cfg(cfg)
    if kind in ITEM7_TOYS:
        m.backbone.update(ITEM7_TOYS[kind][1])
    # Libra's FPN, then its BFP (a list of necks)
    fpn, *rest = m.neck if isinstance(m.neck, list) else [m.neck]
    if kind in DEEP_TOYS or kind in ITEM7_TOYS or kind == 'detectors':
        m.backbone.depth = 50
    else:
        m.backbone.depth = 18
        fpn['in_channels'] = [64, 128, 256, 512]
    fpn['out_channels'] = 32
    for neck in rest:
        neck['in_channels'] = 32
    if kind == 'detectors':
        m.neck.aspp_out_channels = 8
        m.neck.rfp_backbone.rfp_inplanes = 32
    m.rpn_head.in_channels = m.rpn_head.feat_channels = 32
    rh = m.roi_head
    for ext in (rh.bbox_roi_extractor, rh.get('mask_roi_extractor')):
        if ext:
            ext.out_channels = 32
            if 'output_channels' in ext.roi_layer:    # DeformRoIPool's
                ext.roi_layer.output_channels = 32
    cascade = kind in CASCADE_TOYS or kind == 'detectors'
    for head in (rh.bbox_head if cascade else [rh.bbox_head]):
        head.in_channels = 32
        head.fc_out_channels = 64
        head.num_classes = 8
        if 'conv_out_channels' in head:
            head.conv_out_channels = 64 if kind == 'double_head' else 32
    mh = rh.get('mask_head')
    if kind in ('faster_rcnn', 'double_head', 'dynamic_rcnn',
                'libra_faster_rcnn', 'mdpool', *GA_TOYS):
        pass
    elif kind == 'grid_rcnn':
        rh.grid_roi_extractor.out_channels = 32
        rh.grid_head.update(in_channels=32, point_feat_channels=8,
                            num_convs=2)
    elif kind == 'point_rend':
        mh.update(in_channels=32, conv_out_channels=32, fc_out_channels=64,
                  num_classes=8)
        rh.point_head.update(in_channels=32, fc_channels=32, num_classes=8)
    elif kind in ('mask_rcnn', 'cascade', 'htc', 'gn_ws', 'groie',
                  'detectors', 'ms_rcnn', 'pisa_mask_rcnn', *DEEP_TOYS,
                  *ITEM7_TOYS):
        for head in (mh if kind == 'htc' else [mh]):
            head.num_convs = 2
            head.in_channels = head.conv_out_channels = 32
            head.num_classes = 8
        if kind == 'htc':
            rh.semantic_roi_extractor.out_channels = 32
            rh.semantic_head.update(in_channels=32, conv_out_channels=32,
                                    num_convs=2)
        if kind == 'ms_rcnn':
            rh.mask_iou_head.update(in_channels=32, num_classes=8)
    elif kind == 'refinemask':
        mh.num_convs_instance, mh.num_convs_semantic = 1, 2
        mh.conv_out_channels_instance = mh.conv_out_channels_semantic = 32
        mh.stage_num_classes = [8, 8, 8, 8]
    else:
        mh.num_convs_instance = 1
        mh.conv_out_channels_instance = mh.conv_out_channels_semantic = 32
        mh.stage_num_classes = [8, 8, 8, 1]
    cfg.test_cfg.rpn.nms_pre = 64
    cfg.train_cfg.rpn_proposal.max_num = 32
    if kind in GA_TOYS:
        cfg.test_cfg.rpn.max_num = 32
    for stage in (cfg.train_cfg.rcnn if cascade else [cfg.train_cfg.rcnn]):
        stage.sampler.num = 64
    cfg.test_cfg.rcnn.max_per_img = 8
    return cfg


def c4_toy_cfg(cfg):
    """The C4 Mask R-CNN toy: the file's model at its widths (the caffe
    ResNet-50 to layer3, the res5 shared head), 8 classes, the mask head's
    deconv at 32 channels; phase 3's toy test settings, 32 RoIs an image
    (res5 on every RoI is the CPU's cost)."""
    rh = cfg.model.roi_head
    rh.bbox_head.num_classes = rh.mask_head.num_classes = 8
    rh.mask_head.conv_out_channels = 32
    cfg.test_cfg.rpn.nms_pre = 64
    cfg.train_cfg.rpn_proposal.max_num = 32
    cfg.train_cfg.rcnn.sampler.num = 32
    cfg.test_cfg.rcnn.max_per_img = 8
    return cfg


def check_toy_against_cpu(report):
    """Phase 3a: inference, the port on the GPU against itself on the CPU:
    the toy DynaMask in both modes, then the toy Mask R-CNN, RefineMask,
    Faster R-CNN, ResNeXt and caffe Mask R-CNNs, Cascade Mask R-CNN, HTC,
    and the GN+WS, GRoIE and Double-Head toys."""
    import torch
    from dynamask_torch.models import build_detector
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(1, 128, 128, 3, generator=gen)
    batch = {'image': img, 'img_shape': torch.tensor([[128., 128.]]),
             'scale_factor': torch.ones(1, 4)}
    for name, dynamic in (('faithful', False), ('dynamic', True),
                          ('mask_rcnn', False), ('refinemask', False),
                          ('faster_rcnn', False), ('x101', False),
                          ('caffe', False), ('cascade', False),
                          ('htc', False), ('gn_ws', False), ('groie', False),
                          ('double_head', False)):
        cfg = toy_cfg(name if name in TOY_CONFIGS else 'dynamask')
        if name in ('faithful', 'dynamic'):
            cfg.model.roi_head.dynamic_inference = dynamic
        ref = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                             device='cpu', seed=0)
        model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                               device=DEVICE)
        model.load_state_dict(ref.state_dict())
        a = ref.simple_test(batch)
        b = {k: v.cpu() for k, v in model.simple_test(
            {k: v.to(DEVICE) for k, v in batch.items()}).items()
            if torch.is_tensor(v)}
        errs = {k: (a[k].double() - b[k].double()).abs().max().item()
                for k in ('dets', 'mask_probs') if k in a}
        same = all(torch.equal(a[k], b[k]) for k in ('labels', 'det_valid'))
        print(f'  toy {name}: {int(a["det_valid"].sum())} dets, ' + (
            f'mask_probs {tuple(a["mask_probs"].shape)}' if 'mask_probs' in a
            else 'boxes only') + ', GPU vs CPU max abs err ' + ', '.join(
                f'{k} {v:.3e}' for k, v in errs.items()) +
            f', labels/valid equal {same}')
        report['toy'].append(dict(model=name, dynamic=dynamic,
                                  same_labels_valid=same, **errs))
        # fp32 on both devices (TF32 off), other summation orders: ~1e-5
        # on 128-px box coordinates and on mask probabilities
        if not (same and max(errs.values()) < 1e-3):
            raise RuntimeError('toy model: GPU result disagrees with the CPU '
                               'reference')


TOY_LOSS_RTOL = 1e-4   # fp32 sums in other orders: ~1e-6 relative
# Per parameter, relative L2 of the gradient, GPU against CPU: at most
# TOY_GRAD_RL2, or TOY_GRAD_FLOOR times that parameter's own response on the
# CPU to a 1e-7 relative perturbation of the input image (fp32 rounding
# noise). The MSM's gradients are ill-conditioned in the reference math
# (its conv biases are cancelled by batch-statistics BatchNorms) and move
# by ~2e-4 under that perturbation. Each conv's backward alone, cuDNN's
# included, agrees with float64 as closely as the CPU's fp32 does
# (tools/diagnose_toy_train_grads.py); what parts the devices further is an
# input within rounding of a kink: a ReLU input near zero (one such element
# put 9.5e-3 into the toy's stage-2 gradients) or a DCN offset near an
# integer, on one side on the GPU and on the other on the CPU. So the other
# runs take the first GPU run's side wherever the two inputs differ by at
# most KINK_RTOL of the input's largest magnitude (fp32 rounding of sums of
# a few hundred terms is ~1e-6 of it), and a side that differs by more
# fails (:class:`KinkSides`).
TOY_GRAD_RL2 = 1e-3
TOY_GRAD_FLOOR = 10.0
TOY_GRAD_ZERO = 1e-9    # of the largest gradient norm: a zero's rounding
# a toy step in float64 on both devices (phase 19): sums in other orders
TOY_LOSS_RTOL64 = 1e-9
TOY_GRAD_RL2_64 = 1e-6
KINK_RTOL = 1e-5
INPUT_NOISE = 1e-7


class KinkSides:
    """The side of each kink of a toy step's math: of zero for each ReLU
    input, and of the integers for each DCN offset (the bilinear tent's
    derivative is 0 at an integer and the difference of the two corners
    between two). ``patched(follow=False)`` keeps every such input of one
    run; ``patched(follow=True)`` runs the step again with each input put
    on the kept run's side where the two differ by at most KINK_RTOL of the
    input's largest magnitude (both sides are then right within rounding,
    and the derivative differs); a side that differs by more raises.
    ``moved`` counts the inputs moved. The point heads' top-k (phase 18)
    is such a kink too: a run that follows takes the kept run's points
    where they are its own top-k within KINK_RTOL of the map's largest
    magnitude (a value at the k-th place ties the next within rounding,
    as saturated sigmoids do), and raises where they are not."""

    def __init__(self):
        self.kept, self.moved = [], 0

    def _pin(self, x, follow, kept, side):
        import torch
        if not follow:
            self.kept.append(x.detach().cpu().clone())
            return x
        ref = next(kept, None)
        if ref is None or ref.shape != x.shape:
            raise RuntimeError('toy train: the runs meet other kinks')
        ref = ref.to(x.device)
        flip = side(x.detach()) != side(ref)
        if flip.any():
            gap = (x.detach() - ref).abs()[flip].max()
            if gap > KINK_RTOL * x.detach().abs().max():
                raise RuntimeError(f'toy train: an input lies on the other '
                                   f'side of a kink by {gap}')
            self.moved += int(flip.sum())
            # the kept value where the sides differ; the gradient still
            # flows to x
            x = x + torch.where(flip, ref - x.detach(), 0.0)
        return x

    def _pin_top_k(self, top_k, x, k, follow, kept):
        import torch
        values, idx = top_k(x, k)
        if not follow:
            self.kept.append(idx.detach().cpu().clone())
            return values, idx
        ref = next(kept, None)
        if ref is None or ref.shape != idx.shape:
            raise RuntimeError('toy train: the runs meet other top-ks')
        ref = ref.to(x.device)
        rows = (torch.sort(ref, -1).values != torch.sort(idx, -1).values
                ).any(-1)
        if rows.any():
            chosen = torch.zeros_like(x, dtype=torch.bool).scatter(-1, ref,
                                                                   True)
            low = torch.where(chosen, x, float('inf')).amin(-1)
            high = torch.where(chosen, float('-inf'), x).amax(-1)
            gap = (high - low)[rows].max()
            if gap > KINK_RTOL * x.abs().max():
                raise RuntimeError(f'toy train: a top-k takes other points '
                                   f'by {gap}')
            self.moved += int(rows.sum())
        return x.gather(-1, ref), ref

    @contextlib.contextmanager
    def patched(self, follow: bool):
        import torch
        import torch.nn.functional as F
        import dynamask_torch.models.dynamask_head as head
        import dynamask_torch.models.guided_anchor as ga
        import dynamask_torch.models.point_refine_head as prh
        import dynamask_torch.models.point_rend as prend
        import dynamask_torch.ops.deform_conv as dc
        relu, dcn, kept = F.relu, head.deform_conv2d_nhwc, iter(self.kept)
        top_k = prh.top_k
        # the backbones' DCNs (phase 16) and SAC's windowed one (phase 17),
        # looked up at each call; the GA heads' windowed DCN (phase 17)
        exact, windowed = dc.deform_conv2d_exact, dc.modulated_deform_conv2d
        nhwc, ga_dcn = dc.deform_conv2d_nhwc, ga.deform_conv2d_nhwc

        def offset_side(o):
            f = torch.floor(o)
            return 2 * f + (o != f)

        def pinned_relu(x, inplace=False):
            return relu(self._pin(x, follow, kept, lambda t: t > 0),
                        inplace=inplace)

        def pinned_dcn(x, offsets, *args):
            return dcn(x, self._pin(offsets, follow, kept, offset_side),
                       *args)

        def pinned(op):
            def run(x, offsets, *args):
                return op(x, self._pin(offsets, follow, kept, offset_side),
                          *args)
            return run

        def pinned_top_k(x, k):
            return self._pin_top_k(top_k, x, k, follow, kept)

        F.relu, head.deform_conv2d_nhwc = pinned_relu, pinned_dcn
        prh.top_k = prend.top_k = pinned_top_k
        dc.deform_conv2d_exact = pinned(exact)
        dc.modulated_deform_conv2d = pinned(windowed)
        dc.deform_conv2d_nhwc, ga.deform_conv2d_nhwc = pinned(nhwc), \
            pinned(ga_dcn)
        try:
            yield
        finally:
            F.relu, head.deform_conv2d_nhwc = relu, dcn
            prh.top_k = prend.top_k = top_k
            dc.deform_conv2d_exact, dc.modulated_deform_conv2d = exact, \
                windowed
            dc.deform_conv2d_nhwc, ga.deform_conv2d_nhwc = nhwc, ga_dcn


def toy_train_case(kind='dynamask'):
    """The toy training step's inputs: the model (the toy of ``kind``) on
    the CPU in training mode (the DynaMask toy's DCN offset convs off zero,
    so K3's offset gradient is exercised too), the same weights on the GPU,
    a synthetic batch of 2 images at 128x128 (with RefineMask's
    ``gt_semantic``, HTC's ``gt_semantic_seg``), the same batch with its
    image perturbed by INPUT_NOISE (relative), and the random draws
    (sampler priorities, each cascade stage's among them, GA's shape
    sampler's, Gumbel uniforms, PointRend's points, Grid R-CNN's second
    sampling and jitter). SAC's offset convs start off zero too, and the C4
    toy's zero BatchNorm scales at 0.5."""
    import numpy as np
    import torch
    from dynamask_torch.apis import semantic_seg_shape, synthetic_batch
    from dynamask_torch.models import build_detector
    cfg = toy_cfg(kind)
    b, hw, max_gts = 2, 128, 4
    ref = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                         device='cpu', seed=0).train()
    with torch.no_grad():
        for name, p in ref.named_parameters():
            if any(k in name for k in ('conv_offset', 'offset_s',
                                       'offset_l')):
                p.copy_(torch.randn(p.shape, generator=torch.Generator(
                ).manual_seed(2)) * 0.05)
            # the C4 toy's residual branches, whose last BatchNorm scale
            # starts at 0, get a gradient through a scale of 0.5
            if kind == 'c4' and name.endswith('.weight') and p.dim() == 1 \
                    and not p.any():
                p.fill_(0.5)
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                           device=DEVICE).train()
    model.load_state_dict(ref.state_dict())
    batch = synthetic_batch(3, b=b, h=hw, w=hw, num_gts=3, max_gts=max_gts,
                            crop_size=32, num_classes=8, device='cpu',
                            with_semantic=getattr(getattr(
                                ref, 'roi_head', None), 'with_semantic',
                                False),
                            semantic_seg=semantic_seg_shape(ref))
    noisy = dict(batch, image=batch['image'] * (1 + INPUT_NOISE * torch.randn(
        batch['image'].shape, generator=torch.Generator().manual_seed(5))))
    rng = np.random.RandomState(4)
    # a GA-RPN samples the squares, one a location; C4's RPN 15 anchors a
    # cell of its stride-16 map
    n_anchors = (1 if kind in GA_TOYS else 3) * sum(
        (hw // s) ** 2 for s in (4, 8, 16, 32, 64))
    if kind == 'c4':
        n_anchors = 15 * (hw // 16) ** 2
    cascade = kind in CASCADE_TOYS or kind == 'detectors'
    rcnn = cfg.train_cfg.rcnn
    sampler = (rcnn[0] if cascade else rcnn).sampler
    max_pos = int(sampler.num * sampler.pos_fraction)
    noise = {'rpn': rng.uniform(size=(b, n_anchors)),
             'rcnn': rng.uniform(size=(
                 b, max_gts + cfg.train_cfg.rpn_proposal.max_num)),
             'gumbel': rng.uniform(1e-4, 1 - 1e-4, (b * max_pos, 4))}
    if kind in GA_TOYS:     # the shape sampler's draws
        noise['ga_pos'] = rng.uniform(size=(b, n_anchors))
        noise['ga_neg'] = rng.uniform(size=(b, n_anchors))
    if kind == 'point_rend':   # the oversampled and the uniform points
        rh = ref.roi_head
        n_imp = int(rh.importance_sample_ratio * rh.num_points)
        noise['point_over'] = rng.uniform(size=(
            b * max_pos, int(rh.num_points * rh.oversample_ratio), 2))
        noise['point_rand'] = rng.uniform(size=(
            b * max_pos, rh.num_points - n_imp, 2))
    if sampler.get('type') == 'CombinedSampler':   # Libra's two samplers
        for name in ('rcnn_pos', 'rcnn_pos_n', 'rcnn_neg'):
            noise[name] = rng.uniform(size=noise['rcnn'].shape)
    if kind == 'grid_rcnn':    # the grid branch's sampling and jitter
        noise['rcnn_grid'] = rng.uniform(size=noise['rcnn'].shape)
        noise['grid_jitter'] = rng.uniform(-0.15, 0.15, (b * max_pos, 4))
    if cascade:
        # every stage's draws (models/cascade_roi_head.py): a later stage
        # samples from the previous one's slots, at most sampler.num; HTC's
        # stage-0 mask resample has the GTs in front of them
        n = min(sampler.num, noise['rcnn'].shape[1])
        for s in range(len(rcnn)):
            if s:
                noise[f'rcnn_{s}'] = rng.uniform(size=(b, n))
            noise[f'rcnn_mask_{s}'] = rng.uniform(size=(
                b, n + (max_gts if s == 0 else 0)))
    noise = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in noise.items()}
    return ref, model, batch, noisy, noise


def toy_train_step(net, data, noise, proposals=None):
    """``forward_train`` and the backward pass of ``net`` on ``data``:
    (losses, per trainable parameter its gradient as float64 on the CPU,
    the RPN proposals). Given ``proposals``, the step takes them in place of
    its own: near-tied RPN scores, ordered differently by two devices'
    summation orders, would otherwise change which RoIs are sampled. The
    caller may pin the sides of its kinks (:class:`KinkSides`)."""
    import torch
    import dynamask_torch.models.detectors as detectors
    import dynamask_torch.models.guided_anchor as ga
    from dynamask_torch.models.detectors import parse_losses
    dev = net.device
    orig = detectors.rpn_get_proposals
    taken = []

    def hook(*a, **k):
        if proposals is None:
            taken.append(orig(*a, **k))
            return taken[-1]
        return type(proposals)(*[t.to(dev) for t in proposals])

    net.zero_grad(set_to_none=True)
    detectors.rpn_get_proposals = ga.rpn_get_proposals = hook
    try:
        total, log = parse_losses(net.forward_train(
            {k: v.to(dev) for k, v in data.items()},
            {k: v.to(dev) for k, v in noise.items()}))
        total.backward()
    finally:
        detectors.rpn_get_proposals = ga.rpn_get_proposals = orig
    logs = {k: float(v.detach()) for k, v in log.items()}
    grads = {k: (p.grad.detach().cpu().double() if p.grad is not None
                 else torch.zeros(p.shape, dtype=torch.float64))
             for k, p in net.named_parameters() if p.requires_grad}
    return logs, grads, proposals if proposals is not None else taken[-1]


def check_toy_train_against_cpu(report, kind='dynamask'):
    """Phase 3b: one training step of the toy model (the DynaMask toy, the
    Mask R-CNN toy or the RefineMask toy), GPU (with and without cuDNN's
    convs) against CPU: the same weights, batch, random draws and proposals
    (the first GPU run's)."""
    import torch
    name = 'toy_train' + ('' if kind == 'dynamask' else f'_{kind}')
    ref, model, batch, noisy, noise = toy_train_case(kind)
    logs, grads, moved = {}, {}, {}
    sides = KinkSides()
    with sides.patched(follow=False):
        logs['gpu'], grads['gpu'], props = toy_train_step(model, batch, noise)
    for run, net, data in (('gpu_no_cudnn', model, batch),
                           ('cpu', ref, batch), ('cpu_noisy', ref, noisy)):
        sides.moved = 0
        torch.backends.cudnn.enabled = run != 'gpu_no_cudnn'
        try:
            with sides.patched(follow=True):
                logs[run], grads[run], _ = toy_train_step(net, data, noise,
                                                          props)
        finally:
            torch.backends.cudnn.enabled = True
        moved[run] = sides.moved

    def rel_l2(a, g):
        return ((a - g).norm() / g.norm()).item()

    tol = TOY_GRAD_RL2
    print(f'  {name} step, CPU losses: {logs["cpu"]}; ReLU inputs and '
          f'DCN offsets put on the GPU run\'s side of a kink: {moved}')
    report[name] = {'losses_cpu': logs['cpu'], 'kink_inputs_moved': moved}
    for run in ('gpu', 'gpu_no_cudnn'):
        worst_loss = max(abs(logs[run][k] - v) / max(abs(v), 1e-6)
                         for k, v in logs['cpu'].items())
        rows = []
        for k, g in grads['cpu'].items():
            a = grads[run][k]
            if not g.any():     # frozen stem and stage 1, unused parameters
                if a.any():
                    raise RuntimeError(f'{name} ({run}): {k} has a '
                                       'gradient on the GPU, none on the CPU')
                continue
            d = rel_l2(a, g)
            floor = rel_l2(grads['cpu_noisy'][k], g)
            rows.append((d / max(tol, TOY_GRAD_FLOOR * floor), d, floor, k))
        rows.sort(reverse=True)
        worst = [dict(param=k, rel_l2=d, cpu_noise_rel_l2=f)
                 for _, d, f, k in rows[:3]]
        print(f'  {run} vs CPU: worst loss rel err {worst_loss:.3e} (tol '
              f'{TOY_LOSS_RTOL}); gradient rel-L2 over {len(rows)} '
              f'parameters, the three nearest their tolerance (max({tol}, '
              f'{TOY_GRAD_FLOOR} x CPU noise)): ' + ', '.join(
                  f'{w["param"]} {w["rel_l2"]:.2e} (noise '
                  f'{w["cpu_noise_rel_l2"]:.1e})' for w in worst))
        report[name][run] = dict(
            losses=logs[run], worst_loss_rel=worst_loss, worst_grads=worst,
            params_compared=len(rows))
        if not (worst_loss <= TOY_LOSS_RTOL and rows[0][0] <= 1.0 and
                len(rows) > 50):
            raise RuntimeError(f'{name} step ({run}): GPU disagrees with '
                               'the CPU')


# -- phases 4 and 5: the flagship ---------------------------------------------

def check_launches(path, launches, names):
    print(f'  {path}: kernel launches: {launches}')
    for name in names:
        if launches[name] <= 0:
            raise RuntimeError(f'{name} was not launched on the {path} path')


def check_exact_launches(path, launches, counts, times=1):
    """Every kernel instance launched exactly ``times`` x its count in
    ``counts``, and every other one (the other precision's instances,
    the kernels off the path) not at all."""
    print(f'  {path}: kernel launches: {launches}')
    wrong = {k: n for k, n in launches.items()
             if n != counts.get(k, 0) * times}
    if wrong:
        raise RuntimeError(f'{path}: launches {wrong}, expected '
                           f'{ {k: n * times for k, n in counts.items()} }')


def run_inference_path(report, card):
    """Phase 4: flagship inference, both modes, counters around each."""
    import torch
    import dynamask_torch.ops as ops
    from dynamask_torch.apis import inference_detector, init_detector
    t0 = time.perf_counter()
    model = init_detector(FLAGSHIP, device=DEVICE, seed=0, init_std=0.05)
    print(f'  flagship built on {model.device} in '
          f'{time.perf_counter() - t0:.1f} s '
          f'({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)')
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    h, w = IMAGE_HW
    batch = {'image': torch.randn(1, h, w, 3, generator=gen, device=DEVICE),
             'img_shape': torch.tensor([[h, w]], dtype=torch.float32,
                                       device=DEVICE),
             'scale_factor': torch.ones(1, 4, device=DEVICE)}
    rh = model.roi_head
    modes = (('faithful', False), ('dynamic', True))

    def drive(dynamic):
        rh.dynamic_inference = dynamic
        out = inference_detector(model, batch)
        torch.cuda.synchronize(DEVICE)
        return out

    outs, launches = {}, {}
    for mode, dyn in modes:
        ops.reset_kernel_launches()
        outs[mode] = drive(dyn)
        launches[mode] = ops.kernel_launches()
        check_launches(mode, launches[mode], INFER_KERNELS)

    for name, dyn in modes:
        out = outs[name]
        d = rh.max_per_img
        expect = {'dets': (1, d, 5), 'labels': (1, d), 'valid': (1, d),
                  'masks': (1, d, h, w)}
        for k, shape in expect.items():
            if tuple(out[k].shape) != shape:
                raise RuntimeError(f'{name}: {k} shape {tuple(out[k].shape)}'
                                   f' != {shape}')
        if not torch.isfinite(out['dets']).all():
            raise RuntimeError(f'{name}: non-finite dets')
        times = []
        for _ in range(5):
            t = time.perf_counter()
            drive(dyn)
            times.append(1e3 * (time.perf_counter() - t))
        ms = statistics.median(times)
        n_valid = int(out['valid'].sum())
        line = (f'  {name}: {ms:.1f} ms/img (median of 5, after 1 warm-up) '
                f'[{card}], {n_valid} valid dets, '
                f'{int(out["masks"][out["valid"]].sum())} mask pixels')
        rec = dict(mode=name, ms_per_img=ms, times_ms=times,
                   valid_dets=n_valid)
        if 'msm_routing' in out:
            r = {k: v.tolist() for k, v in out['msm_routing'].items()
                 if k != 'need'}
            line += f', routing {r}'
            rec['routing'] = r
        print(line)
        report['main_path'].append(rec)
    launches['k5_check'] = check_k5_on_flagship(report, drive)
    del model, outs
    return launches


def check_k5_on_flagship(report, drive):
    """Phase 4, K5: capture the three SFM ``fuse_conv_1`` inputs of a
    faithful drive (NHWC features, offsets, weight, n = 100) and the main
    path's DCN output on them (K1 + GEMM); run both K5 entry points on them
    in fp32, counters zeroed just before and read just after, and hold each
    result against that output."""
    import torch
    import dynamask_torch.models.dynamask_head as head
    import dynamask_torch.ops as ops
    dcn, taken = head.deform_conv2d_nhwc, []

    def capture(x, offsets, weight, *conf):
        out = dcn(x, offsets, weight, *conf)
        taken.append((x.detach().clone(), offsets.detach().clone(),
                      weight.detach().clone(), conf, out.detach().clone()))
        return out

    head.deform_conv2d_nhwc = capture
    try:
        drive(False)
    finally:
        head.deform_conv2d_nhwc = dcn
    if len(taken) != len(SFM_STAGES):
        raise RuntimeError(f'faithful drive ran {len(taken)} DCNs, expected '
                           f'{len(SFM_STAGES)}')
    ops.reset_kernel_launches()
    outs = [[ops.KERNELS[name](x, off, w.permute(2, 3, 1, 0), *conf)
             for name in K5_KERNELS] for x, off, w, conf, _ in taken]
    torch.cuda.synchronize(DEVICE)
    launches = ops.kernel_launches()
    check_launches('k5_check', launches, K5_KERNELS)
    for (x, _, _, _, ref), got in zip(taken, outs):
        for name, out in zip(K5_KERNELS, got):
            err, scale, finite = _compare(out, ref)
            limit = K5_RTOL * scale
            shape = 'x'.join(str(d) for d in x.shape)
            print(f'  {name} on the captured fuse_conv_1 input {shape}: max '
                  f'abs err {err:.3e} against the main path\'s DCN output '
                  f'(tol {limit:.3e}, {K5_RTOL} x max|ref| {scale:.3e})')
            report['k5_flagship'].append(dict(
                name=name, shape=list(x.shape), max_abs_err=err,
                max_abs_ref=scale, tol=limit))
            if not (err <= limit and finite and out.shape == ref.shape):
                raise RuntimeError(f'{name} disagrees with the main path\'s '
                                   f'DCN on the {shape} input')
    return launches


def run_train_path(report, card):
    """Phase 5: flagship training through ``train_steps``, one call per
    step on the host batch, counters around the whole drive."""
    import torch
    import dynamask_torch.ops as ops
    from dynamask_torch.apis import (init_trainer, synthetic_batch,
                                     train_steps)
    t0 = time.perf_counter()
    model, opt = init_trainer(FLAGSHIP, steps_per_epoch=COCO_STEPS_PER_EPOCH,
                              device=DEVICE, seed=0)
    h, w = IMAGE_HW
    # on the host, as a loader hands it over: train_steps moves it
    batch = synthetic_batch(0, b=TRAIN_IMAGES, h=h, w=w, num_gts=TRAIN_GTS,
                            crop_size=128,
                            num_classes=model.roi_head.num_classes,
                            device='cpu')
    print(f'  trainer built in {time.perf_counter() - t0:.1f} s: '
          f'{sum(p.numel() for p in opt.params) / 1e6:.1f} M trainable of '
          f'{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params; '
          f'batch {TRAIN_IMAGES}x{h}x{w}, {TRAIN_GTS} GTs per image')
    offsets = {k: p for k, p in model.named_parameters()
               if 'conv_offset' in k}
    if not offsets or any(p.abs().max() != 0 for p in offsets.values()):
        raise RuntimeError('the DCN offset convs must start at zero')
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.synchronize(DEVICE)
    torch.cuda.reset_peak_memory_stats(DEVICE)
    ops.reset_kernel_launches()
    logs, times = [], []
    for i in range(1 + TIMED_STEPS):
        t = time.perf_counter()
        log, = train_steps(model, opt, [batch], generator=gen)
        torch.cuda.synchronize(DEVICE)
        times.append(1e3 * (time.perf_counter() - t))
        log = {k: float(v) for k, v in log.items()}
        logs.append(log)
        bad = [k for k, v in log.items() if v != v or abs(v) == float('inf')]
        bad += [k for k, p in model.named_parameters() if p.grad is not None
                and not torch.isfinite(p.grad).all()]
        if bad:
            raise RuntimeError(f'train step {i}: non-finite {bad}')
        if i == 0:
            # the JAX tent derivative: zero offsets get exactly zero gradient
            moved = [k for k, p in offsets.items()
                     if p.grad is None or p.grad.abs().max() != 0]
            if moved:
                raise RuntimeError(f'step 0: conv_offset gradients not '
                                   f'exactly 0: {moved}')
        print(f'  step {i}{" (warm-up)" if i == 0 else ""}: '
              f'{times[-1]:.1f} ms [{card}], ' + ', '.join(
                  f'{k} {v:.5g}' for k, v in log.items()))
    launches = ops.kernel_launches()
    check_launches('train', launches, TRAIN_KERNELS)
    peak = torch.cuda.max_memory_allocated(DEVICE)
    ms = statistics.median(times[1:])
    still_zero = all(p.abs().max() == 0 for p in offsets.values())
    print(f'  train: {ms:.1f} ms/step (median of {TIMED_STEPS}, after 1 '
          f'warm-up), {1e3 * TRAIN_IMAGES / ms:.2f} img/s, peak memory '
          f'{peak / 2 ** 30:.2f} GiB [{card}]; conv_offset gradients exactly '
          f'0 at step 0, offsets still all zero after {1 + TIMED_STEPS} '
          f'steps: {still_zero}')
    report['train'] = dict(ms_per_step=ms, times_ms=times,
                           img_per_s=1e3 * TRAIN_IMAGES / ms,
                           peak_memory_bytes=peak, losses=logs,
                           launches=launches, steps=1 + TIMED_STEPS,
                           offsets_still_zero=still_zero)
    del model, opt, batch
    return launches


# -- phase 6: the COCO evaluation path ------------------------------------------

COCO_SET = os.path.join(ROOT, 'build', 'chip_smoke_coco')
COCO_SIZES = ((640, 480), (480, 640), (640, 427), (500, 375))   # w x h


def write_coco_set(root, seed=0, per_size=2):
    """A seeded COCO-format set in ``root``: ``per_size`` noise JPEGs at
    each COCO size, each with 3-10 rectangle-polygon GTs (inset 2 px in
    their boxes, as ``tests/test_data.py:make_synthetic_coco`` draws them,
    1/16-1/3 of the image side) over 2-5 of five categories. The file
    lists all 80 ``COCO_CLASSES`` as categories, as COCO's does: the
    model's 80 labels map onto them. Returns (annotation file, image
    directory, GT count)."""
    import cv2
    import numpy as np
    from dynamask_torch.data import COCO_CLASSES
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, 'images')
    os.makedirs(img_dir, exist_ok=True)
    cats = [{'id': k + 1, 'name': n} for k, n in enumerate(COCO_CLASSES)]
    used = np.sort(rng.choice(len(cats), 5, False)) + 1
    images, anns = [], []
    for i in range(per_size * len(COCO_SIZES)):
        w, h = COCO_SIZES[i // per_size]
        name = f'{i:012d}.jpg'
        cv2.imwrite(os.path.join(img_dir, name),
                    rng.uniform(0, 255, (h, w, 3)).astype(np.uint8))
        images.append({'id': i + 1, 'file_name': name, 'width': w,
                       'height': h})
        here = rng.choice(used, rng.randint(2, 6), False)
        for _ in range(rng.randint(3, 11)):
            bw = int(rng.randint(w // 16, w // 3))
            bh = int(rng.randint(h // 16, h // 3))
            x, y = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
            poly = [x + 2, y + 2, x + bw - 2, y + 2, x + bw - 2, y + bh - 2,
                    x + 2, y + bh - 2]
            anns.append({'id': len(anns) + 1, 'image_id': i + 1,
                         'category_id': int(rng.choice(here)),
                         'bbox': [float(x), float(y), float(bw), float(bh)],
                         'area': float(bw * bh), 'iscrowd': 0,
                         'segmentation': [[float(v) for v in poly]]})
    ann_file = os.path.join(root, 'instances.json')
    with open(ann_file, 'w') as f:
        json.dump({'images': images, 'annotations': anns,
                   'categories': cats}, f)
    return ann_file, img_dir, len(anns)


def check_eval_outputs(dataset, results, det_json, segm_json):
    """One finite result per image; every valid det's mask survives
    encode_mask -> decode_rle bit for bit; the C codec and the numpy codec
    give the same RLE bytes on every mask of the drive (valid or not)."""
    import numpy as np
    from dynamask_torch.data import decode_rle, encode_mask, encode_mask_plain
    ids = sorted(r['img_id'] for r in results)
    if ids != sorted(dataset.sample_id(i) for i in range(len(dataset))):
        raise RuntimeError(f'eval: results for images {ids}')
    n_masks = n_valid = 0
    segm = iter(segm_json)
    for res in results:
        valid = np.asarray(res['valid'], bool)
        if not np.isfinite(res['dets'][valid]).all():
            raise RuntimeError(f'eval: non-finite dets, image {res["img_id"]}')
        for d, mask in enumerate(res['masks']):
            rle = encode_mask(mask)
            if rle != encode_mask_plain(mask):
                raise RuntimeError(f'eval: C and numpy RLE differ, image '
                                   f'{res["img_id"]} det {d}')
            n_masks += 1
            if valid[d]:
                entry = next(segm)
                if entry['segmentation'] != rle or not np.array_equal(
                        decode_rle(entry['segmentation']), mask):
                    raise RuntimeError(f'eval: RLE round trip differs, image '
                                       f'{res["img_id"]} det {d}')
                n_valid += 1
    return n_masks, n_valid


def gt_as_predictions(dataset):
    """The set's GTs as results: boxes at score 0.9, masks rasterized from
    the polygons at original resolution."""
    import numpy as np
    from dynamask_torch.data import polygons_to_mask
    results = []
    for i, info in enumerate(dataset.img_infos):
        ann = dataset.get_ann_info(i)
        n = len(ann['bboxes'])
        results.append({
            'img_id': info['id'],
            'dets': np.concatenate([ann['bboxes'],
                                    np.full((n, 1), 0.9, np.float32)], 1),
            'labels': ann['labels'], 'valid': np.ones(n, bool),
            'masks': [polygons_to_mask(m, info['height'], info['width'])
                      for m in ann['masks']]})
    return results


def run_eval_path(report, card, config=FLAGSHIP,
                  infer_counts=INFER_COUNTS['faithful'],
                  step_counts=STEP_COUNTS, prefix='', init_std=None):
    """Phase 6 (and phase 10 on RefineMask's R50 1x ``config``, its paths
    named with ``prefix``): the seeded COCO set through ``build_dataset``,
    the config's test pipeline and loader, ``single_device_test``
    (``simple_test`` + the paste on the dataset's mask canvas, on the
    card) and ``CocoDataset.evaluate``; counters around the timed drive,
    held to ``infer_counts`` an image. Then one ``train_steps`` step on a
    loader batch of the train pipeline (with ``gt_semantic`` where the
    head reads it; from N(0, ``init_std``) weights, given), held to
    ``step_counts``."""
    import torch
    import dynamask_torch.ops as ops
    from dynamask_torch.apis import (init_detector, init_trainer,
                                     single_device_test, train_steps)
    from dynamask_torch.data import build_dataloader, build_dataset
    label = prefix.replace('_', ' ')
    ann_file, img_dir, n_gts = write_coco_set(COCO_SET)
    model = init_detector(config, device=DEVICE, seed=0, init_std=0.05)
    data = model.cfg.data
    paths = dict(ann_file=ann_file, img_prefix=img_dir, data_root=None)
    dataset = build_dataset(dict(data['test'], **paths),
                            default_args=dict(test_mode=True))
    n = len(dataset)
    print(f'  {label}set: {n} images at COCO sizes {COCO_SIZES} (w x h), '
          f'{n_gts} polygon GTs; the config\'s test pipeline, '
          f'{data["workers_per_gpu"]} loader workers')
    single_device_test(model, dataset, workers_per_gpu=0, progress=False)
    torch.cuda.synchronize(DEVICE)
    timings = {}
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    results = single_device_test(model, dataset, progress=False,
                                 workers_per_gpu=data['workers_per_gpu'],
                                 timings=timings)
    t_test = time.perf_counter() - t0
    key = f'{prefix}eval'
    launches = {key: ops.kernel_launches()}
    check_exact_launches(key, launches[key], infer_counts, times=n)
    t = time.perf_counter()
    det_json, segm_json = dataset.results2json(results)
    timings['rle'] = time.perf_counter() - t
    t = time.perf_counter()
    metrics = dataset.evaluate_json(det_json, segm_json, ['bbox', 'segm'])
    timings['evaluate'] = time.perf_counter() - t
    total = t_test + timings['rle'] + timings['evaluate']
    warm = total - timings['startup']
    ms = {k: 1e3 * v / n for k, v in timings.items()}
    print(f'  {label}eval: {n / total:.2f} img/s end to end '
          f'({1e3 * total / n:.1f} ms/img), {n / warm:.2f} img/s without the '
          f'loader start-up [{card}]; ms/img: loader start-up '
          f'{ms["startup"]:.1f}, host pipeline + collate '
          f'{ms["pipeline"]:.1f}, device (simple_test + paste, '
          f'synchronised) {ms["device"]:.1f}, device-to-host copy '
          f'{ms["fetch"]:.1f} + RLE {ms["rle"]:.1f}, evaluate '
          f'{ms["evaluate"]:.1f}')
    n_masks, n_valid = check_eval_outputs(dataset, results, det_json,
                                          segm_json)
    print(f'  {label}eval: {len(results)} results; {n_valid} valid dets, '
          f'each mask\'s RLE round trip exact; C and numpy RLE '
          f'byte-identical on all {n_masks} masks; bbox_mAP '
          f'{metrics["bbox_mAP"]:.4f}, segm_mAP {metrics["segm_mAP"]:.4f} '
          f'(random weights)')
    gt = dataset.evaluate(gt_as_predictions(dataset), metric=['bbox', 'segm'])
    print(f'  {label}eval: GT as predictions: bbox_mAP {gt["bbox_mAP"]}, '
          f'segm_mAP {gt["segm_mAP"]}')
    if gt['bbox_mAP'] != 1.0 or gt['segm_mAP'] != 1.0:
        raise RuntimeError(f'{key}: GT as predictions must score exactly '
                           f'1.0')
    report[key] = dict(images=n, seconds=total, img_per_s=n / total,
                       img_per_s_without_startup=n / warm, ms_per_img=ms,
                       metrics=metrics, gt_as_predictions=gt,
                       valid_dets=n_valid, masks_checked=n_masks,
                       launches=launches[key])
    del model, results
    torch.cuda.empty_cache()

    model, opt = init_trainer(config, steps_per_epoch=COCO_STEPS_PER_EPOCH,
                              device=DEVICE, seed=0, init_std=init_std)
    semantic = model.roi_head.with_semantic
    train_set = build_dataset(dict(data['train'], **paths), default_args=dict(
        max_gts=data['max_gts'], mask_crop_size=data['mask_crop_size']))
    if semantic != train_set.with_semantic:
        raise RuntimeError(f'{prefix}loader_train: the head reads '
                           f'gt_semantic: {semantic}, the train set has it: '
                           f'{train_set.with_semantic}')
    loader = build_dataloader(train_set, data['samples_per_gpu'],
                              workers_per_gpu=data['workers_per_gpu'])
    t = time.perf_counter()
    batch = next(iter(loader))
    t_load = time.perf_counter() - t
    img = batch['image']
    shape = tuple(img.shape)
    if shape[0] != data['samples_per_gpu']:
        raise RuntimeError(f'loader batch {shape}')
    sem_note = ''
    if semantic:
        sem = batch['gt_semantic']
        if (sem.dtype != torch.uint8 or tuple(sem.shape) != (
                shape[0], shape[1] // 4, shape[2] // 4) or not sem.any()):
            raise RuntimeError(f'loader gt_semantic {tuple(sem.shape)} '
                               f'{sem.dtype}, {int(sem.sum())} pixels set')
        sem_note = (f', gt_semantic {tuple(sem.shape)} uint8 with '
                    f'{int(sem.sum())} pixels set')
    ops.reset_kernel_launches()
    t = time.perf_counter()
    log, = train_steps(model, opt, [batch],
                       generator=torch.Generator(device=DEVICE)
                       .manual_seed(0))
    torch.cuda.synchronize(DEVICE)
    t_step = time.perf_counter() - t
    key = f'{prefix}loader_train'
    launches[key] = ops.kernel_launches()
    check_exact_launches(key, launches[key], step_counts)
    log = {k: float(v) for k, v in log.items()}
    bad = [k for k, v in log.items() if not math.isfinite(v)]
    if bad or (semantic and 'loss_semantic' not in log):
        raise RuntimeError(f'{key}: non-finite {bad} or no loss_semantic: '
                           f'{sorted(log)}')
    print(f'  {label}train step from a loader batch {shape} '
          f'({int(batch["gt_valid"].sum())} GTs{sem_note}, {t_load:.1f} s '
          f'to the first batch): {1e3 * t_step:.1f} ms (first step) '
          f'[{card}], ' + ', '.join(f'{k} {v:.5g}' for k, v in log.items()))
    report[key] = dict(batch=list(shape), load_s=t_load,
                       step_ms=1e3 * t_step, losses=log,
                       launches=launches[key])
    del model, opt, batch
    torch.cuda.empty_cache()
    return launches


# -- phase 7: the training loop ---------------------------------------------

TRAIN_SET = os.path.join(ROOT, 'build', 'chip_smoke_coco_train')
TRAIN_RUNS = os.path.join(ROOT, 'build', 'chip_smoke_train')
OVERFIT_SET = os.path.join(ROOT, 'build', 'chip_smoke_overfit')
VAL_IMAGES = 2 * len(COCO_SIZES)     # phase 6's set
OVERFIT_EPOCHS = 80
LOSS_RTOL = 1e-5      # B's first step against A's: the same forward
# B's final weights against A's, relative L2 over all of them: the
# backwards of K3, K4 and cuDNN sum in a nondeterministic order, so the
# four steps of epoch 2 part the runs (3.3e-8 on the H100 when this was
# set)
RESUME_RTOL = 1e-5
# The JAX package's overfit proxy (ACCURACY.json, all_stage variant, on the
# CPU): seed 0, and the spread over seeds 0-1 (seed 2 collapses to 0.05)
JAX_OVERFIT = dict(bbox_mAP=(0.4847, '0.46-0.49'),
                   segm_mAP=(0.6199, '0.62-0.72'))


class LoopRecords(logging.Handler):
    """The loop's structured log records: each epoch's ``epoch_timing``
    and the resume's ``load_s``."""

    def __init__(self):
        super().__init__()
        self.epochs, self.load_s = [], []

    def emit(self, record):
        if hasattr(record, 'epoch_timing'):
            self.epochs.append(record.epoch_timing)
        if hasattr(record, 'load_s'):
            self.load_s.append(record.load_s)


def loop_rows(work_dir):
    rows = []
    for name in sorted(os.listdir(work_dir)):
        if name.endswith('.log.json'):
            with open(os.path.join(work_dir, name)) as f:
                rows += [json.loads(line) for line in f]
    return rows


def _equal_states(a, b, where=''):
    """Bit-for-bit equality of two nested states of tensors (``b`` may be
    on the card)."""
    import torch
    if torch.is_tensor(a):
        if not (torch.is_tensor(b) and a.dtype == b.dtype and
                torch.equal(a, b.detach().cpu())):
            raise RuntimeError(f'train loop: {where} differs')
    elif isinstance(a, dict):
        if set(a) != set(b):
            raise RuntimeError(f'train loop: {where} keys differ')
        for k in a:
            _equal_states(a[k], b[k], f'{where}.{k}')
    elif a != b:
        raise RuntimeError(f'train loop: {where} differs: {a} != {b}')


@contextlib.contextmanager
def counted_loop(counts):
    """Split the loop's kernel launches into ``counts['train_loop']`` and
    ``counts['val_loop']``: the counters are zeroed just before each part
    (the steps between validations, each validation) and read just after.
    A resume's load is checked on the spot: the model and the optimizer
    just after it must hold the checkpoint's state bit for bit."""
    import dynamask_torch.apis.train as loop
    import dynamask_torch.ops as ops
    validate, load, loaded = loop._run_validation, loop.load_checkpoint, []

    def read(path):
        for k, n in ops.kernel_launches().items():
            counts[path][k] = counts[path].get(k, 0) + n
        ops.reset_kernel_launches()

    def counted_validation(*args, **kwargs):
        read('train_loop')
        try:
            return validate(*args, **kwargs)
        finally:
            read('val_loop')

    def checked_load(path, model, optimizer):
        import torch
        meta = load(path, model, optimizer)
        ckpt = torch.load(path, map_location='cpu', weights_only=True)
        _equal_states(ckpt['state_dict'], model.state_dict(), 'model')
        _equal_states(ckpt['optimizer'], optimizer.state_dict(), 'optimizer')
        loaded.append(path)
        return meta

    loop._run_validation, loop.load_checkpoint = (counted_validation,
                                                  checked_load)
    ops.reset_kernel_launches()
    try:
        yield loaded
        read('train_loop')
    finally:
        loop._run_validation, loop.load_checkpoint = validate, load


def check_loop_rows(name, rows, epochs):
    """Finite train rows; a val row with finite mAPs for each epoch."""
    for r in rows:
        if r['mode'] == 'train' and not all(
                math.isfinite(v) for v in r.values()
                if isinstance(v, float)):
            raise RuntimeError(f'train loop {name}: non-finite row {r}')
    vals = {r['epoch']: r for r in rows if r['mode'] == 'val'}
    for e in epochs:
        v = vals.get(e)
        if v is None or not (math.isfinite(v['bbox_mAP']) and
                             math.isfinite(v['segm_mAP'])):
            raise RuntimeError(f'train loop {name}: epoch {e} has no val '
                               f'row with finite mAPs')


def run_train_loop(report, card, phase5_ms):
    """Phase 7(a): ``python -m dynamask_torch.tools.train`` in-process on
    the flagship at full width. Run A: two epochs of 4 steps on a 16-image
    set, validating on phase 6's set after each; run B: resumed from A's
    ``epoch_1.pth``. Returns the launches of the loop's steps and of its
    validations."""
    import torch
    import dynamask_torch.ops as ops
    from dynamask_torch.tools.train import main as train_main
    train_ann, train_img, n_gts = write_coco_set(TRAIN_SET, seed=1,
                                                 per_size=4)
    val_ann, val_img, _ = write_coco_set(COCO_SET)
    options = [f'data.train.ann_file={train_ann}',
               f'data.train.img_prefix={train_img}',
               'data.train.data_root=None', f'data.val.ann_file={val_ann}',
               f'data.val.img_prefix={val_img}', 'data.val.data_root=None',
               'total_epochs=2', 'lr_config.step=[1]',
               'evaluation.interval=1', 'evaluation.classwise=False',
               'log_config.interval=1', 'checkpoint_config.interval=1']
    print(f'  train set: {4 * len(COCO_SIZES)} images at COCO sizes, '
          f'{n_gts} GTs; val set: phase 6\'s; options {options[6:]}')
    shutil.rmtree(TRAIN_RUNS, ignore_errors=True)
    dirs = {r: os.path.join(TRAIN_RUNS, r) for r in 'AB'}
    records = LoopRecords()
    logger = logging.getLogger('dynamask_torch')
    logger.addHandler(records)
    counts = {p: dict.fromkeys(ops.kernel_launches(), 0)
              for p in ('train_loop', 'val_loop')}
    torch.cuda.synchronize(DEVICE)
    torch.cuda.reset_peak_memory_stats(DEVICE)
    try:
        walls = {}
        for run, extra in (('A', []), ('B', ['--resume-from', os.path.join(
                dirs['A'], 'epoch_1.pth')])):
            with counted_loop(counts) as resumed:
                t = time.perf_counter()
                rc = train_main([FLAGSHIP, '--device', DEVICE, '--work-dir',
                                 dirs[run], *extra, '--options', *options])
                walls[run] = time.perf_counter() - t
            if rc != 0:
                raise RuntimeError(f'train loop {run}: exit code {rc}')
    finally:
        logger.removeHandler(records)
    peak = torch.cuda.max_memory_allocated(DEVICE)
    rows = {r: loop_rows(d) for r, d in dirs.items()}
    for f in ('epoch_1.pth', 'epoch_2.pth', 'latest'):
        if not os.path.isfile(os.path.join(dirs['A'], f)):
            raise RuntimeError(f'train loop A: no {f}')
    check_loop_rows('A', rows['A'], (1, 2))
    check_loop_rows('B', rows['B'], (2,))
    for path, names in (('train_loop', TRAIN_KERNELS),
                        ('val_loop', INFER_KERNELS)):
        check_launches(path, counts[path], names)

    if resumed != [os.path.join(dirs['A'], 'epoch_1.pth')]:
        raise RuntimeError(f'train loop B: resumed from {resumed}')
    train = {r: [x for x in rows[r] if x['mode'] == 'train'
                 and x['epoch'] == 2] for r in 'AB'}
    if [(x['step'], x['lr']) for x in train['A']] != \
            [(x['step'], x['lr']) for x in train['B']]:
        raise RuntimeError('train loop: B\'s epoch-2 steps or lr differ '
                           'from A\'s')
    first = {k: abs(v - train['A'][0][k]) / max(abs(train['A'][0][k]),
                                                1e-12)
             for k, v in train['B'][0].items()
             if k.startswith('loss') or k == 'acc'}
    first_diff = max(first.values())
    print(f'  resume: B\'s loaded state equals A\'s epoch_1.pth bit for '
          f'bit; epoch-2 steps and lr equal; first step losses max rel '
          f'diff {first_diff:.3e} (tol {LOSS_RTOL})')
    if first_diff > LOSS_RTOL:
        raise RuntimeError(f'train loop: B\'s first step losses differ '
                           f'from A\'s: {first}')
    a2, b2 = (torch.load(os.path.join(dirs[r], 'epoch_2.pth'),
                         map_location='cpu', weights_only=True)['state_dict']
              for r in 'AB')
    stats = [k for k in a2 if k.endswith(('running_mean', 'running_var'))]
    weights = [k for k in a2 if a2[k].is_floating_point()
               and k not in stats]

    def rel_l2(keys):
        num = sum(float(((a2[k] - b2[k]).double() ** 2).sum()) for k in keys)
        return (num / sum(float((a2[k].double() ** 2).sum())
                          for k in keys)) ** 0.5

    final = rel_l2(weights)
    worst = max((rel_l2([k]), k) for k in weights if a2[k].any())
    print(f'  resume: B\'s final weights against A\'s: relative L2 '
          f'{final:.3e} over all (tol {RESUME_RTOL}); worst tensor '
          f'{worst[1]} {worst[0]:.3e}; BN statistics {rel_l2(stats):.3e}')
    if not final <= RESUME_RTOL:
        raise RuntimeError(f'train loop: B\'s final weights differ from '
                           f'A\'s: relative L2 {final}')

    epochs = records.epochs
    for run, e in zip('AAB', epochs):
        print(f'  epoch {e["epoch"]} of {run}: {e["train_s"]:.2f} s for its '
              f'4 steps, first batch {e["first_batch_s"]:.2f} s (the '
              f'loader\'s start-up in a run\'s first epoch), data wait after '
              f'it {e["data_s"]:.3f} s; checkpoint '
              f'{e["checkpoint_bytes"] / 1e9:.3f} GB saved in '
              f'{e["save_s"]:.2f} s; validation {e["val_s"]:.2f} s '
              f'({VAL_IMAGES / e["val_s"]:.2f} img/s, loader start-up '
              f'included) [{card}]')
    ms = {r: 1e3 * train[r][-1]['time'] for r in 'AB'}
    print(f'  in-loop ms/step (the log\'s time over epoch 2): A {ms["A"]:.1f}'
          f', B {ms["B"]:.1f}, against phase 5\'s {phase5_ms:.1f}; '
          f'checkpoint load {records.load_s[0]:.2f} s; peak memory '
          f'{peak / 2 ** 30:.2f} GiB; runs A {walls["A"]:.1f} s, B '
          f'{walls["B"]:.1f} s [{card}]')
    report['train_loop'] = dict(
        epochs=epochs, load_s=records.load_s, rows=rows, walls_s=walls,
        ms_per_step_epoch2=ms, phase5_ms_per_step=phase5_ms,
        peak_memory_bytes=peak, first_step_max_rel_diff=first_diff,
        final_rel_l2=final, final_worst_tensor=worst,
        resume_rtol=RESUME_RTOL, launches=counts)
    return counts


def write_overfit_set(root):
    """``tests/test_data.py:make_synthetic_coco(num_imgs=4)``'s set, the
    one the JAX package's overfit proxy trains on: four noise images of
    160x120 and 120x160 with three rectangle-polygon GTs each, person or
    car, from seed 0."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(0)
    img_dir = os.path.join(root, 'imgs')
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for i in range(4):
        h, w = (120, 160) if i % 2 == 0 else (160, 120)
        name = f'{i:04d}.jpg'
        cv2.imwrite(os.path.join(img_dir, name),
                    rng.uniform(0, 255, (h, w, 3)).astype(np.uint8))
        images.append({'id': i + 1, 'file_name': name, 'width': w,
                       'height': h})
        for _ in range(3):
            x, y = rng.randint(0, w - 40), rng.randint(0, h - 40)
            bw, bh = rng.randint(15, 40, 2)
            poly = [x + 2, y + 2, x + bw - 2, y + 2, x + bw - 2, y + bh - 2,
                    x + 2, y + bh - 2]
            anns.append({'id': len(anns) + 1, 'image_id': i + 1,
                         'category_id': int(rng.choice([1, 3])),
                         'bbox': [float(x), float(y), float(bw), float(bh)],
                         'area': float(bw * bh), 'iscrowd': 0,
                         'segmentation': [[float(v) for v in poly]]})
    ann_file = os.path.join(root, 'ann.json')
    with open(ann_file, 'w') as f:
        json.dump({'images': images, 'annotations': anns, 'categories': [
            {'id': 1, 'name': 'person'}, {'id': 3, 'name': 'car'}]}, f)
    return ann_file, img_dir


def overfit_cfg(ann_file, img_dir):
    """Phase 3's toy at 2 classes with the recipe of
    ``tests/test_overfit.py:36-57``: 160x128 canvases, no flip, batch 2,
    backbone unfrozen with batch statistics, every stage's instance loss,
    lr 0.01 with a 10-step warmup and no decay, ``OVERFIT_EPOCHS`` (80)
    epochs, no validation; the JAX toy's box loss weights and proposal and
    sample counts, so that the model is the JAX proxy's in all the port
    reads."""
    cfg = toy_cfg()
    m = cfg.model
    m.backbone.frozen_stages = -1
    m.backbone.norm_eval = False
    m.roi_head.bbox_head.num_classes = 2
    m.roi_head.mask_head.stage_num_classes = [2, 2, 2, 1]
    m.roi_head.mask_head.loss_cfg.all_stage_instance_loss = True
    m.roi_head.bbox_head.loss_cls.loss_weight = 1.0
    m.roi_head.bbox_head.loss_bbox.loss_weight = 1.0
    cfg.train_cfg.rpn.sampler.num = 64
    cfg.train_cfg.rpn_proposal.nms_pre = 64
    cfg.train_cfg.rcnn.sampler.num = 32
    cfg.test_cfg.rpn.nms_pre = 32
    norm = dict(type='Normalize', mean=[123.675, 116.28, 103.53],
                std=[58.395, 57.12, 57.375], to_rgb=True)
    load = [dict(type='LoadImageFromFile')]
    rest = [dict(type='Resize', img_scale=(160, 128), keep_ratio=True),
            norm, dict(type='Pad', size_divisor=32)]
    ds = dict(type='CocoDataset', ann_file=ann_file, img_prefix=img_dir,
              canvases=[(128, 160), (160, 128)], classes=['person', 'car'])
    cfg.data = dict(
        samples_per_gpu=2, workers_per_gpu=0, max_gts=8, mask_crop_size=32,
        train=dict(ds, pipeline=load + [dict(
            type='LoadAnnotations', with_bbox=True, with_mask=True)] + rest),
        test=dict(ds, pipeline=load + rest, test_mode=True))
    cfg.optimizer = dict(type='SGD', lr=0.01, momentum=0.9,
                         weight_decay=0.0001)
    cfg.lr_config = dict(policy='step', warmup='linear', warmup_iters=10,
                         warmup_ratio=0.001, step=[1000])
    cfg.total_epochs = OVERFIT_EPOCHS
    cfg.checkpoint_config = dict(interval=OVERFIT_EPOCHS)
    cfg.log_config = dict(interval=1)
    return cfg


def run_overfit(report, card):
    """Phase 7(b): does the step train? The toy through ``train_detector``
    on 4 images for 80 epochs, from the weights that seed 0 gives on the
    CPU (``load_from``: the proxy is sensitive to its init, and the CPU's
    generator draws what the CPU tests draw); the last epoch's mean loss
    must be below half the first's. Then ``run_eval`` reads the loop's
    checkpoint from its work dir: bbox and segm mAP, a reading beside the
    JAX package's."""
    import torch
    import dynamask_torch.ops as ops
    from dynamask_torch.apis import init_detector, run_eval, train_detector
    cfg = overfit_cfg(*write_overfit_set(OVERFIT_SET))
    work = os.path.join(OVERFIT_SET, 'work')
    shutil.rmtree(work, ignore_errors=True)
    init = os.path.join(OVERFIT_SET, 'init_seed0_cpu.pth')
    torch.save(init_detector(cfg, device='cpu', seed=0).state_dict(), init)
    ops.reset_kernel_launches()
    t = time.perf_counter()
    train_detector(cfg, work_dir=work, load_from=init, seed=0, device=DEVICE,
                   validate=False)
    wall = time.perf_counter() - t
    launches = ops.kernel_launches()
    check_launches('overfit_loop', launches, TRAIN_KERNELS)
    rows = [r for r in loop_rows(work) if r['mode'] == 'train']
    by_epoch = {}
    for r in rows:
        if not math.isfinite(r['loss']):
            raise RuntimeError(f'overfit: non-finite loss {r}')
        by_epoch.setdefault(r['epoch'], []).append(r['loss'])
    first, last = (statistics.mean(by_epoch[e])
                   for e in (1, OVERFIT_EPOCHS))
    metrics = run_eval(cfg, work, ('bbox', 'segm'), device=DEVICE)
    print(f'  overfit: {OVERFIT_EPOCHS} epochs x {len(by_epoch[1])} steps '
          f'in {wall:.1f} s [{card}]; mean loss epoch 1 {first:.4f} -> epoch '
          f'{OVERFIT_EPOCHS} {last:.4f} (gate: below half); ' + ', '.join(
              f'{k} {metrics[k]:.4f} (JAX {v[0]}, seeds {v[1]})'
              for k, v in JAX_OVERFIT.items()))
    report['overfit'] = dict(loss_by_epoch={e: statistics.mean(v) for e, v
                                            in by_epoch.items()},
                             metrics=metrics, seconds=wall,
                             launches=launches)
    if not last < first / 2:
        raise RuntimeError(f'overfit: the mean loss went {first} -> {last}')
    return launches


# -- phase 8: the other configurations of BASELINE.json ----------------------

# (name, config, test canvas, train batch, train canvas); the DynaMask ones
# run both inference modes, Mask R-CNN its one
# the shapes of each come from the config (apis.config_shapes)
CONFIG_CELLS = (
    ('mask_rcnn', MASK_RCNN),
    ('r101', os.path.join(ROOT, 'configs/dynamask/coco/r101_dynamask_3x.py')),
    ('lvis', os.path.join(ROOT, 'configs/dynamask/lvis/'
                          'r50_dynamask_lvis_1x.py')),
    ('cityscapes', os.path.join(ROOT, 'configs/dynamask/cityscapes/'
                                'r50_dynamask_cityscapes_1x.py')),
)
LVIS_SET = os.path.join(ROOT, 'build', 'chip_smoke_lvis')
CITYSCAPES_SET = os.path.join(ROOT, 'build', 'chip_smoke_cityscapes')
LVIS_NUM_CLASSES = 1203


def _rect_anns(rng, img_id, w, h, cats, n, first_id, lo=16, hi=3):
    """``n`` rectangle-polygon GTs of 1/``lo``-1/``hi`` of the image side,
    inset 2 px in their boxes, over ``cats``."""
    anns = []
    for k in range(n):
        bw = int(rng.randint(w // lo, w // hi))
        bh = int(rng.randint(h // lo, h // hi))
        x, y = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
        poly = [x + 2, y + 2, x + bw - 2, y + 2, x + bw - 2, y + bh - 2,
                x + 2, y + bh - 2]
        anns.append({'id': first_id + k, 'image_id': img_id,
                     'category_id': int(rng.choice(cats)),
                     'bbox': [float(x), float(y), float(bw), float(bh)],
                     'area': float(bw * bh), 'iscrowd': 0,
                     'segmentation': [[float(v) for v in poly]]})
    return anns


def write_lvis_set(root, seed=0, per_size=2):
    """A seeded LVIS v1-format set in ``root``: ``per_size`` noise JPEGs at
    each of phase 6's COCO sizes, named by ``coco_url`` only, as LVIS names
    them; 1203 categories with ``frequency`` r/c/f in turn; 3-10 GTs each
    over 6 categories, two of each band; per image the first absent of the
    6 as ``neg_category_ids`` and its first GT category as
    ``not_exhaustive_category_ids``. Returns (annotation file, image
    directory, GT count)."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, 'val2017')
    os.makedirs(img_dir, exist_ok=True)
    bands = 'rcf'
    cats = [{'id': i + 1, 'name': f'lvis_category_{i + 1:04d}',
             'frequency': bands[i % 3], 'image_count': 1}
            for i in range(LVIS_NUM_CLASSES)]
    used = [1, 4, 2, 5, 3, 6]          # r, r, c, c, f, f
    images, anns = [], []
    for i in range(per_size * len(COCO_SIZES)):
        w, h = COCO_SIZES[i // per_size]
        name = f'{397133 + i:012d}.jpg'
        cv2.imwrite(os.path.join(img_dir, name),
                    rng.uniform(0, 255, (h, w, 3)).astype(np.uint8))
        new = _rect_anns(rng, i + 1, w, h, used, int(rng.randint(3, 11)),
                         len(anns) + 1)
        held = {a['category_id'] for a in new}
        anns += new
        images.append({
            'id': i + 1, 'width': w, 'height': h,
            'coco_url': f'http://images.cocodataset.org/val2017/{name}',
            'neg_category_ids': [c for c in used if c not in held][:1],
            'not_exhaustive_category_ids': [new[0]['category_id']]})
    ann_file = os.path.join(root, 'lvis_v1_val.json')
    with open(ann_file, 'w') as f:
        json.dump({'images': images, 'annotations': anns,
                   'categories': cats}, f)
    return ann_file, img_dir, len(anns)


def write_cityscapes_set(root, seed=0, num_images=2):
    """A seeded Cityscapes set in ``root``: ``num_images`` noise PNGs of
    2048x1024 with 3-10 rectangle GTs each over the 8 classes, their
    official label ids as category ids (as
    ``tools/convert_datasets/cityscapes.py`` writes them). Returns
    (annotation file, image directory, GT count)."""
    import cv2
    import numpy as np
    from dynamask_torch.data import CITYSCAPES_CLASSES, CITYSCAPES_LABEL_IDS
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, 'leftImg8bit', 'val')
    os.makedirs(img_dir, exist_ok=True)
    ids = [CITYSCAPES_LABEL_IDS[n] for n in CITYSCAPES_CLASSES]
    images, anns = [], []
    for i in range(num_images):
        name = f'frankfurt_{i:06d}_000019_leftImg8bit.png'
        cv2.imwrite(os.path.join(img_dir, name),
                    rng.uniform(0, 255, (1024, 2048, 3)).astype(np.uint8))
        images.append({'id': i + 1, 'file_name': name, 'width': 2048,
                       'height': 1024})
        anns += _rect_anns(rng, i + 1, 2048, 1024, ids,
                           int(rng.randint(3, 11)), len(anns) + 1, lo=32,
                           hi=6)
    ann_file = os.path.join(root, 'instancesonly_filtered_gtFine_val.json')
    with open(ann_file, 'w') as f:
        json.dump({'images': images, 'annotations': anns, 'categories': [
            {'id': CITYSCAPES_LABEL_IDS[n], 'name': n}
            for n in CITYSCAPES_CLASSES]}, f)
    return ann_file, img_dir, len(anns)


# Mask R-CNN's launches (no DCN): its box and mask extracts, K4 their
# gradients in a step
MASK_RCNN_INFER_COUNTS = {'roi_align_fwd': 2}
MASK_RCNN_STEP_COUNTS = {'roi_align_fwd': 2, 'roi_align_bwd': 2}


def config_modes(name):
    """(mode, the MSM flag or None, exact launches of one image) of each
    inference mode of phase 8's config ``name``."""
    if name == 'mask_rcnn':
        return (('fcn', None, MASK_RCNN_INFER_COUNTS),)
    return tuple((m, m == 'dynamic', INFER_COUNTS[m])
                 for m in ('faithful', 'dynamic'))


def det_slots(model) -> int:
    """The det slots of an image: the RoI head's ``max_per_img``, a
    single-stage detector's, or a proposal detector's proposals."""
    rh = getattr(model, 'roi_head', None)
    if rh is not None:
        return rh.max_per_img
    if hasattr(model, 'test_cfg'):
        return model.test_cfg['max_per_img']
    return model.rpn_max_num


def num_classes(model) -> int:
    """The classes of the dets (one for a proposal detector's)."""
    rh = getattr(model, 'roi_head', None)
    if rh is not None:
        return rh.num_classes
    return getattr(model, 'num_classes', 1)


def mask_side(rh):
    """The side of a RoI head's mask probabilities, None without a mask
    head: 28 from the FCN heads (Mask R-CNN's, Mask Scoring R-CNN's, the
    cascades' stage heads), 14 behind the C4 shared head, PointRend's
    coarse side doubled at each subdivision step (224), 112 from the
    DynaMask, RefineMask and PointRefine heads."""
    import torch
    from dynamask_torch.models.fcn_mask_head import FCNMaskHead
    if rh is None or rh.mask_head is None:
        return None
    shared = getattr(rh, 'shared_head', None)
    if shared is not None:     # C4: the shared head halves the 14x14 crop
        return 2 * rh.mask_roi_out // shared.stride
    if isinstance(rh.mask_head, (FCNMaskHead, torch.nn.ModuleList)):
        return 28
    if hasattr(rh, 'subdivision_steps'):
        return rh.mask_head.out_size * rh.scale_factor ** rh.subdivision_steps
    return 112


def device_busy(fn):
    """One more call of ``fn`` under ``torch.profiler`` (CPU and CUDA):
    {'wall_ms', 'busy_ms', 'share'}, the union of the device's kernel and
    copy intervals over the call's wall time, the profiler's own cost
    inside it; ``share`` None when the trace holds no device time. The
    device-side spans of the ``record_function`` ranges are not work:
    they are left out by their flag and by their names."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(DEVICE)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(DEVICE)
        wall = time.perf_counter() - t
    return busy_of(prof.events(), wall)


def busy_of(events, wall):
    """The busy share of a profiled call of ``wall`` seconds from its
    ``events`` (:func:`device_busy`)."""
    from torch.autograd import DeviceType
    ranges = {e.name for e in events if e.device_type == DeviceType.CPU}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA and e.name not in
                   ranges and not getattr(e, 'is_user_annotation', False))
    busy, end = 0.0, float('-inf')
    for start, stop in spans:       # microseconds
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return dict(wall_ms=1e3 * wall, busy_ms=busy / 1e3,
                share=busy / 1e6 / wall if spans else None)


def busy_text(b) -> str:
    if b['share'] is None:
        return (f'device busy share not measured (no device time in the '
                f'trace of a {b["wall_ms"]:.1f} ms pass)')
    return (f'device busy {100 * b["share"]:.1f}% of a {b["wall_ms"]:.1f} ms '
            'profiled pass')


def run_config_inference(report, card, name, path, hw, modes, repeats=5,
                         bf16=False, busy=False):
    """Phases 8 and 10-14, inference: the config's detector built on the
    card with random weights N(0, 0.05) from seed 0, one seeded image at
    the config's test canvas through ``inference_detector`` (with
    ``bf16``, ``make_test_fn(..., bf16=True)``: a bf16 copy of the model on
    a bf16 image); per mode of ``modes`` (:func:`config_modes`) a counted
    warm-up drive held to its exact launches, then the median of
    ``repeats``, and with ``busy`` one more drive under the profiler
    (:func:`device_busy`). A box-only detector's drive gives no masks."""
    import torch
    import dynamask_torch.ops as ops
    from dynamask_torch.apis import (inference_detector, init_detector,
                                     make_test_fn)
    t0 = time.perf_counter()
    model = init_detector(path, device=DEVICE, seed=0, init_std=0.05)
    build_s = time.perf_counter() - t0
    h, w = hw
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    batch = {'image': torch.randn(1, h, w, 3, generator=gen, device=DEVICE),
             'img_shape': torch.tensor([[h, w]], dtype=torch.float32,
                                       device=DEVICE),
             'scale_factor': torch.ones(1, 4, device=DEVICE)}
    rh = getattr(model, 'roi_head', None)
    d = det_slots(model)
    classes = num_classes(model)
    print(f'  {name}: built in {build_s:.1f} s, '
          f'{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, '
          f'{classes} classes, {d} det slots, canvas {h}x{w}')
    launches, recs = {}, []
    fn = None if bf16 else functools.partial(inference_detector, model)
    side = mask_side(rh)

    def drive(dynamic):
        if dynamic is not None:
            rh.dynamic_inference = dynamic
        out = fn(batch)
        torch.cuda.synchronize(DEVICE)
        return out

    for mode, dyn, counts in modes:
        if bf16:
            # the bf16 copy drives the mode its fp32 model has when it is
            # made: one copy per mode, the last one dropped first
            if dyn is not None:
                rh.dynamic_inference = dyn
            fn = None
            fn = make_test_fn(model, hw, bf16=True)
        torch.cuda.synchronize(DEVICE)
        torch.cuda.reset_peak_memory_stats(DEVICE)
        ops.reset_kernel_launches()
        out = drive(dyn)
        key = f'{name}_{mode}'
        launches[key] = ops.kernel_launches()
        check_exact_launches(key, launches[key], counts)
        expect = {'dets': (1, d, 5), 'labels': (1, d), 'valid': (1, d)}
        if side:
            expect['masks'] = (1, d, h, w)
        if ('masks' in out) != bool(side):
            raise RuntimeError(f'{key}: outputs {sorted(out)}')
        for k, shape in expect.items():
            if tuple(out[k].shape) != shape:
                raise RuntimeError(f'{key}: {k} shape '
                                   f'{tuple(out[k].shape)} != {shape}')
        if not torch.isfinite(out['dets']).all():
            raise RuntimeError(f'{key}: non-finite dets')
        if int(out['labels'].max()) >= classes:
            raise RuntimeError(f'{key}: a label past {classes}')
        if side:
            with torch.no_grad():
                full = model.simple_test(batch)
            probs = full['mask_probs']
            if tuple(probs.shape) != (1, d, side, side) or not \
                    torch.isfinite(probs).all():
                raise RuntimeError(f'{key}: mask probabilities '
                                   f'{tuple(probs.shape)}, finite '
                                   f'{bool(torch.isfinite(probs).all())}')
            # Mask Scoring R-CNN's box scores times its predicted IoUs
            segm = full.get('segm_scores')
            if segm is not None and not (
                    tuple(segm.shape) == (1, d) and
                    torch.isfinite(segm).all() and
                    (segm <= full['dets'][..., 4] + 1e-6).all()):
                raise RuntimeError(f'{key}: segm_scores {segm}')
            del probs, full
        times = []
        for _ in range(repeats):
            t = time.perf_counter()
            drive(dyn)
            times.append(1e3 * (time.perf_counter() - t))
        ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated(DEVICE)
        n_valid = int(out['valid'].sum())
        line = (f'  {key}: {ms:.1f} ms/img (median of {repeats}, after 1 '
                f'warm-up){" bf16" if bf16 else ""} [{card}]; peak memory '
                f'{peak / 2 ** 30:.2f} GiB; {n_valid} of {d} det slots '
                'valid; ' + (f'mask probabilities {side}x{side}, finite'
                             if side else 'boxes only') +
                f'; launches {launches[key]}')
        rec = dict(config=name, mode=mode, ms_per_img=ms, times_ms=times,
                   peak_memory_bytes=peak, valid_dets=n_valid, slots=d,
                   launches=launches[key], bf16=bf16)
        if busy:
            rec['busy'] = device_busy(lambda: drive(dyn))
            line += '; ' + busy_text(rec['busy'])
        if 'msm_routing' in out:
            r = {k: v.tolist() for k, v in out['msm_routing'].items()
                 if k != 'need'}
            line += f'; routing {r}'
            rec['routing'] = r
        print(line)
        recs.append(rec)
    del model, out, fn
    torch.cuda.empty_cache()
    return launches, recs


@contextlib.contextmanager
def msm_step_of(model, store):
    """While active, a DynaMask model's training step appends to ``store``
    (given) what its mask loss saw, as tensors on the card read after the
    step (no synchronisation inside it): 'routing', the stage each
    positive RoI's straight-through Gumbel argmax picks (-1 on a padding
    RoI); 'saturated', the share of the detail logits whose sigmoid is
    exactly 0 or 1 in their own type; 'loss_masks_f32', the same
    ``dyna_mask_loss`` on the same logits cast to fp32 first."""
    import torch
    import dynamask_torch.models.dynamask_roi_head as drh
    if store is None or not hasattr(getattr(model, 'roi_head', None),
                                    '_msm_labels'):
        yield
        return
    saved = drh.dyna_mask_loss

    def record(preds, details, targets, mask_labels, valid, *args, **kw):
        with torch.no_grad():
            stage = mask_labels.argmax(1).masked_fill(~valid.bool(), -1)
            sig = [torch.sigmoid(d) for d in details]
            n_sat = sum(((g == 0) | (g == 1)).sum() for g in sig)
            f32 = saved([p.float() for p in preds],
                        [d.float() for d in details], targets,
                        mask_labels.float(), valid, *args, **kw)
            store.append(dict(
                routing=stage, loss_masks_f32=f32['loss_masks'],
                saturated=n_sat / sum(g.numel() for g in sig)))
        return saved(preds, details, targets, mask_labels, valid, *args,
                     **kw)
    drh.dyna_mask_loss = record
    try:
        yield
    finally:
        drh.dyna_mask_loss = saved


def run_config_train(report, card, name, path, images, hw, counts,
                     repeats=TIMED_STEPS, compute_dtype=None, init_std=None,
                     busy=False):
    """Phases 8 and 10-14, training: ``init_trainer`` on the config (its
    seeded JAX initialisation), a seeded synthetic batch of ``images`` at
    the train canvas with 20 GTs each over the config's classes (and, for
    a head that reads it, ``gt_semantic`` through the data pipeline's
    rasteriser, or HTC's ``gt_semantic_seg``), one warm-up and
    ``repeats`` timed ``train_steps`` (in ``compute_dtype`` on fp32
    masters, given; from N(0, ``init_std``) weights, given); counters
    around all of them, held to ``counts`` a step; with ``busy`` one more
    step under the profiler (:func:`device_busy`)."""
    import torch
    import dynamask_torch.ops as ops
    from dynamask_torch.apis import (init_trainer, semantic_seg_shape,
                                     synthetic_batch, train_steps)
    model, opt = init_trainer(path, steps_per_epoch=COCO_STEPS_PER_EPOCH,
                              device=DEVICE, seed=0, init_std=init_std)
    h, w = hw
    semantic = getattr(getattr(model, 'roi_head', None), 'with_semantic',
                       False)
    seg = semantic_seg_shape(model)
    batch = synthetic_batch(0, b=images, h=h, w=w, num_gts=TRAIN_GTS,
                            crop_size=128, num_classes=num_classes(model),
                            device='cpu', with_semantic=semantic,
                            semantic_seg=seg)
    if seg and tuple(batch['gt_semantic_seg'].shape) != (
            images, h // seg[0], w // seg[0]):
        raise RuntimeError(f'{name}: gt_semantic_seg '
                           f'{tuple(batch["gt_semantic_seg"].shape)}')
    if semantic:
        sem = batch['gt_semantic']
        if sem.dtype != torch.uint8 or tuple(sem.shape) != (
                images, h // 4, w // 4) or not sem.any():
            raise RuntimeError(f'{name}: gt_semantic {tuple(sem.shape)} '
                               f'{sem.dtype}, {int(sem.sum())} pixels set')
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.synchronize(DEVICE)
    torch.cuda.reset_peak_memory_stats(DEVICE)
    ops.reset_kernel_launches()
    times, logs, msm = [], [], []
    for i in range(1 + repeats):
        t = time.perf_counter()
        with msm_step_of(model, msm if i == 0 else None):
            log, = train_steps(model, opt, [batch], generator=gen,
                               compute_dtype=compute_dtype)
        torch.cuda.synchronize(DEVICE)
        times.append(1e3 * (time.perf_counter() - t))
        log = {k: float(v) for k, v in log.items()}
        bad = [k for k, v in log.items() if not math.isfinite(v)]
        if bad or (semantic and 'loss_semantic' not in log) or (
                seg and 'loss_semantic_seg' not in log):
            raise RuntimeError(f'{name} train step {i}: non-finite {bad} '
                               f'or no loss_semantic(_seg): {sorted(log)}')
        logs.append(log)
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise RuntimeError(f'{name}: a master weight left fp32')
    key = f'{name}_train'
    launches = {key: ops.kernel_launches()}
    check_exact_launches(key, launches[key], counts, times=1 + repeats)
    peak = torch.cuda.max_memory_allocated(DEVICE)
    ms = statistics.median(times[1:])
    prec = ' bf16' if compute_dtype is torch.bfloat16 else ''
    shares = device_busy(lambda: train_steps(
        model, opt, [batch], generator=gen,
        compute_dtype=compute_dtype)) if busy else None
    print(f'  {key}: {ms:.1f} ms/step{prec} (median of {repeats}, after 1 '
          f'warm-up), batch {images}x{h}x{w}, {1e3 * images / ms:.2f} img/s, '
          f'peak memory {peak / 2 ** 30:.2f} GiB [{card}]; first losses ' +
          ', '.join(f'{k} {v:.4g}' for k, v in logs[0].items()) +
          (f'; {busy_text(shares)}' if busy else ''))
    rec = dict(config=name, ms_per_step=ms, times_ms=times, batch=images,
               canvas=list(hw), peak_memory_bytes=peak, losses=logs,
               launches=launches[key], bf16=bool(prec))
    if busy:
        rec['busy'] = shares
    if msm:
        rec['msm'] = {k: v.tolist() for k, v in msm[0].items()}
    del model, opt, batch
    torch.cuda.empty_cache()
    return launches, rec


def run_config_eval(report, card, name, path, writer, root):
    """Phase 8, the evaluation path of the LVIS or Cityscapes config: its
    seeded set through ``run_test`` (the config's test pipeline and loader
    workers, its detector at its seeded initialisation on the card) and
    ``dataset.evaluate``, counters around ``run_test`` held to the exact
    launches of an image; the GTs given as
    predictions must score exactly 1.0 (LVIS: in every band too)."""
    import dynamask_torch.ops as ops
    from dynamask_torch.apis import run_test
    from dynamask_torch.utils import Config
    ann_file, img_dir, n_gts = writer(root)
    cfg = Config.fromfile(path)
    cfg.data.test.update(ann_file=ann_file, img_prefix=img_dir,
                         data_root=None)
    ops.reset_kernel_launches()
    t = time.perf_counter()
    dataset, results = run_test(cfg, device=DEVICE)
    t_test = time.perf_counter() - t
    key = f'{name}_eval'
    n = len(dataset)
    launches = {key: ops.kernel_launches()}
    # the configs test in the faithful mode (their test_cfg sets no
    # dynamic_inference)
    check_exact_launches(key, launches[key], INFER_COUNTS['faithful'],
                         times=n)
    t = time.perf_counter()
    metrics = dataset.evaluate(results, metric=['bbox', 'segm'])
    t_eval = time.perf_counter() - t
    det_json, segm_json = dataset.results2json(results)
    n_masks, n_valid = check_eval_outputs(dataset, results, det_json,
                                          segm_json)
    gt = dataset.evaluate(gt_as_predictions(dataset),
                          metric=['bbox', 'segm'])
    keys = [k for k in gt if k.endswith(('_mAP', '_mAP_r', '_mAP_c',
                                         '_mAP_f'))]
    print(f'  {key}: {n} images, {n_gts} GTs, {len(dataset.CLASSES)} '
          f'classes; run_test {t_test:.1f} s ({n / t_test:.2f} img/s, '
          f'{cfg.data.workers_per_gpu} loader workers started), evaluate '
          f'{t_eval:.1f} s [{card}]; {n_valid} valid dets, RLE exact on '
          f'{n_masks} masks; ' + ', '.join(
              f'{k} {metrics[k]:.4f}' for k in keys) +
          ' (random weights); GT as predictions: ' + ', '.join(
              f'{k} {gt[k]}' for k in keys) + f'; launches {launches[key]}')
    if not keys or any(gt[k] != 1.0 for k in keys):
        raise RuntimeError(f'{key}: GT as predictions must score exactly '
                           f'1.0: {gt}')
    extra = {}
    if hasattr(dataset, 'results2txt'):
        files = dataset.results2txt(results, os.path.join(root, 'txt'))
        pngs = [f for f in os.listdir(os.path.join(root, 'txt'))
                if f.endswith('.png')]
        if len(files) != n or len(pngs) != n_valid:
            raise RuntimeError(f'{key}: results2txt wrote {len(files)} txt, '
                               f'{len(pngs)} png for {n_valid} dets')
        extra['results2txt'] = dict(txt=len(files), png=len(pngs))
        print(f'  {key}: results2txt: {len(files)} txt, {len(pngs)} PNGs')
    rec = dict(config=name, images=n, gts=n_gts, run_test_s=t_test,
               evaluate_s=t_eval, valid_dets=n_valid, metrics=metrics,
               gt_as_predictions=gt, launches=launches[key], **extra)
    return launches, rec


def run_configs(report, card):
    """Phase 8: each configuration's inference and training at its own
    shapes, and the LVIS and Cityscapes evaluation paths."""
    import torch
    from dynamask_torch.apis import config_shapes
    launches = {}
    report['configs'] = {'inference': [], 'train': [], 'eval': []}
    for name, path in CONFIG_CELLS:
        test_hw, images, train_hw = config_shapes(path)
        got, recs = run_config_inference(report, card, name, path, test_hw,
                                         config_modes(name))
        launches.update(got)
        report['configs']['inference'] += recs
        got, rec = run_config_train(
            report, card, name, path, images, train_hw,
            MASK_RCNN_STEP_COUNTS if name == 'mask_rcnn' else STEP_COUNTS)
        launches.update(got)
        report['configs']['train'].append(rec)
    for name, writer, root in (('lvis', write_lvis_set, LVIS_SET),
                               ('cityscapes', write_cityscapes_set,
                                CITYSCAPES_SET)):
        path = dict(CONFIG_CELLS)[name]
        got, rec = run_config_eval(report, card, name, path, writer, root)
        launches.update(got)
        report['configs']['eval'].append(rec)
        torch.cuda.empty_cache()
    return launches


# -- phase 9: the flagship in bf16 ---------------------------------------------

def in_precision(counts, prec):
    """``counts`` keyed by the names of ``prec``'s instances."""
    return {k + ('_bf16' if prec == 'bf16' else ''): n
            for k, n in counts.items()}


def run_bf16_paths(report, card):
    """Phase 9: the flagship at full width under the mixed-precision
    policy. Inference through ``apis.make_test_fn`` (``simple_test`` + the
    paste, 800x1344, batch 1) in fp32 and in bf16 (a bf16 copy of the
    model, a bf16 image), both modes, in turns: warm-up, then 5 drives of
    each, median ms/img and peak memory; then ``train_steps`` with
    ``compute_dtype=torch.bfloat16`` on phase 5's trainer, batch and draws
    (seed 0): step 0's loss must be finite and within BF16_LOSS_RTOL of
    phase 5's fp32 step 0, the masters fp32 after it; then 3 timed steps.
    Counters are zeroed just before each precision's first drive of a mode
    and before the steps, and read just after: each kernel's instance of
    that precision must launch as often as INFER_COUNTS / STEP_COUNTS say,
    the other precision's instance never."""
    import torch
    import dynamask_torch.ops as ops
    from dynamask_torch.apis import (init_detector, init_trainer,
                                     make_test_fn, synthetic_batch,
                                     train_steps)
    t0 = time.perf_counter()
    model = init_detector(FLAGSHIP, device=DEVICE, seed=0, init_std=0.05)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    h, w = IMAGE_HW
    batch = {'image': torch.randn(1, h, w, 3, generator=gen, device=DEVICE),
             'img_shape': torch.tensor([[h, w]], dtype=torch.float32,
                                       device=DEVICE),
             'scale_factor': torch.ones(1, 4, device=DEVICE)}
    launches, recs = {}, []
    for mode, dyn in (('faithful', False), ('dynamic', True)):
        # the fp32 fn runs ``model`` itself and the bf16 fn a copy made
        # here: both drive ``mode`` for as long as the flag stays set
        model.roi_head.dynamic_inference = dyn
        t = time.perf_counter()
        by_prec = {p: make_test_fn(model, IMAGE_HW, bf16=p == 'bf16')
                   for p in ('fp32', 'bf16')}
        print(f'  {mode}: the fns (and the bf16 copy) built in '
              f'{time.perf_counter() - t:.1f} s')
        outs, times, peaks = {}, {p: [] for p in by_prec}, {}
        for prec, fn in by_prec.items():
            torch.cuda.synchronize(DEVICE)
            torch.cuda.reset_peak_memory_stats(DEVICE)
            ops.reset_kernel_launches()
            outs[prec] = fn(batch)
            torch.cuda.synchronize(DEVICE)
            peaks[prec] = torch.cuda.max_memory_allocated(DEVICE)
            key = f'{prec}_{mode}'
            launches[key] = ops.kernel_launches()
            check_exact_launches(key, launches[key],
                                 in_precision(INFER_COUNTS[mode], prec))
            if ('msm_routing' in outs[prec]) != dyn:
                raise RuntimeError(f'{key}: the routing statistics '
                                   f'{"missing" if dyn else "present"}')
        for _ in range(5):
            for prec, fn in by_prec.items():
                t = time.perf_counter()
                fn(batch)
                torch.cuda.synchronize(DEVICE)
                times[prec].append(1e3 * (time.perf_counter() - t))
        rec = dict(mode=mode)
        for prec, out in outs.items():
            d = model.roi_head.max_per_img
            for k, shape in (('dets', (1, d, 5)), ('masks', (1, d, h, w))):
                if tuple(out[k].shape) != shape:
                    raise RuntimeError(f'{prec} {mode}: {k} shape '
                                       f'{tuple(out[k].shape)} != {shape}')
            if out['dets'].dtype != torch.float32 or not torch.isfinite(
                    out['dets']).all():
                raise RuntimeError(f'{prec} {mode}: dets not finite fp32')
            ms = statistics.median(times[prec])
            n_valid = int(out['valid'].sum())
            rec[prec] = dict(ms_per_img=ms, times_ms=times[prec],
                             peak_memory_bytes=peaks[prec],
                             valid_dets=n_valid)
        print(f'  {mode}: bf16 {rec["bf16"]["ms_per_img"]:.1f} ms/img, fp32 '
              f'{rec["fp32"]["ms_per_img"]:.1f} (medians of 5, in turns, '
              f'after 1 warm-up each) [{card}]; peak memory bf16 '
              f'{peaks["bf16"] / 2 ** 30:.2f} GiB, fp32 '
              f'{peaks["fp32"] / 2 ** 30:.2f}; valid dets '
              f'{rec["bf16"]["valid_dets"]} / {rec["fp32"]["valid_dets"]}; '
              f'launches K1, K2 bf16 '
              f'{launches[f"bf16_{mode}"]["deform_im2col_windowed_bf16"]}, '
              f'{launches[f"bf16_{mode}"]["roi_align_fwd_bf16"]}, fp32 '
              f'{launches[f"fp32_{mode}"]["deform_im2col_windowed"]}, '
              f'{launches[f"fp32_{mode}"]["roi_align_fwd"]}')
        recs.append(rec)
    del model, by_prec, outs

    model, opt = init_trainer(FLAGSHIP, steps_per_epoch=COCO_STEPS_PER_EPOCH,
                              device=DEVICE, seed=0)
    tbatch = synthetic_batch(0, b=TRAIN_IMAGES, h=h, w=w, num_gts=TRAIN_GTS,
                             crop_size=128,
                             num_classes=model.roi_head.num_classes,
                             device='cpu')
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.synchronize(DEVICE)
    torch.cuda.reset_peak_memory_stats(DEVICE)
    ops.reset_kernel_launches()
    logs, times = [], []
    for i in range(1 + TIMED_STEPS):
        t = time.perf_counter()
        log, = train_steps(model, opt, [tbatch], generator=gen,
                           compute_dtype=torch.bfloat16)
        torch.cuda.synchronize(DEVICE)
        times.append(1e3 * (time.perf_counter() - t))
        logs.append({k: float(v) for k, v in log.items()})
        if not all(math.isfinite(v) for v in logs[-1].values()):
            raise RuntimeError(f'bf16 step {i}: non-finite log {logs[-1]}')
        if i == 0:
            masters = [k for k, p in model.named_parameters()
                       if p.dtype != torch.float32 or (
                           p.grad is not None and
                           p.grad.dtype != torch.float32)]
            if masters:
                raise RuntimeError(f'bf16 step: parameters or gradients not '
                                   f'fp32: {masters[:5]}')
        print(f'  bf16 step {i}{" (warm-up)" if i == 0 else ""}: '
              f'{times[-1]:.1f} ms [{card}], ' + ', '.join(
                  f'{k} {v:.5g}' for k, v in logs[-1].items()))
    launches['bf16_train'] = ops.kernel_launches()
    check_exact_launches('bf16_train', launches['bf16_train'],
                         in_precision(STEP_COUNTS, 'bf16'),
                         times=1 + TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated(DEVICE)
    l16, l32 = logs[0]['loss'], report['train']['losses'][0]['loss']
    rel = abs(l16 - l32) / max(abs(l32), 1e-6)
    ms = statistics.median(times[1:])
    fp32 = report['train']
    print(f'  bf16 train: {ms:.1f} ms/step (median of {TIMED_STEPS}, after 1 '
          f'warm-up), peak memory {peak / 2 ** 30:.2f} GiB; fp32 (phase 5) '
          f'{fp32["ms_per_step"]:.1f} ms/step, '
          f'{fp32["peak_memory_bytes"] / 2 ** 30:.2f} GiB [{card}]; step-0 '
          f'loss bf16 {l16:.5g}, fp32 {l32:.5g} (rel {rel:.3e}, tol '
          f'{BF16_LOSS_RTOL})')
    if not rel <= BF16_LOSS_RTOL:
        raise RuntimeError(f'bf16 step-0 loss {l16} not within '
                           f'{BF16_LOSS_RTOL} of fp32\'s {l32}')
    report['bf16'] = dict(inference=recs, train=dict(
        ms_per_step=ms, times_ms=times, peak_memory_bytes=peak, losses=logs,
        loss_rel_to_fp32=rel, fp32_ms_per_step=fp32['ms_per_step'],
        fp32_peak_memory_bytes=fp32['peak_memory_bytes']),
        launches=launches)
    del model, opt
    return launches


# -- phase 10: the RefineMask family -------------------------------------------

# (name, config, timed repeats of inference and of training): the R50 1x
# COCO config at phase 4/5's protocol, then LVIS (1203-class stages, 300
# slots) and Cityscapes (1024x2048, batch 1), one timed repeat each
REFINE_CELLS = (
    ('refine_r50', REFINEMASK, 5, TIMED_STEPS),
    ('refine_lvis', os.path.join(ROOT, 'configs/refinemask/lvis/'
                                 'r50_refinemask_lvis_1x.py'), 1, 1),
    ('refine_cityscapes', os.path.join(ROOT, 'configs/refinemask/'
                                       'cityscapes/r50_refinemask_1x.py'),
     1, 1),
)
# RefineMask's launches: K2 for the box and the mask extracts and, in each
# of the 3 stages, a P2 crop of the transformed semantic features and one
# of the semantic mask (C = 1); K4 for the same 8 crops' gradients in a
# step; no DCN. Per image at inference, per step in training (the crops
# take every image of a batch in one launch).
REFINE_INFER_COUNTS = {'roi_align_fwd': 8}
REFINE_STEP_COUNTS = {'roi_align_fwd': 8, 'roi_align_bwd': 8}


def run_refinemask(report, card):
    """Phase 10: the three RefineMask cells' inference and training at
    their own shapes, each from its config file, unchanged; then phase
    6's eval drive and loader-batch step on the R50 1x config."""
    from dynamask_torch.apis import config_shapes
    launches = {}
    report['refinemask'] = {'inference': [], 'train': []}
    for name, path, n_inf, n_steps in REFINE_CELLS:
        test_hw, images, train_hw = config_shapes(path)
        got, recs = run_config_inference(
            report, card, name, path, test_hw,
            (('infer', None, REFINE_INFER_COUNTS),), repeats=n_inf)
        launches.update(got)
        report['refinemask']['inference'] += recs
        got, rec = run_config_train(report, card, name, path, images,
                                    train_hw, REFINE_STEP_COUNTS,
                                    repeats=n_steps)
        launches.update(got)
        report['refinemask']['train'].append(rec)
    launches.update(run_eval_path(report, card, REFINEMASK,
                                  REFINE_INFER_COUNTS, REFINE_STEP_COUNTS,
                                  'refine_'))
    flagship = [r['ms_per_img'] for r in report['main_path']
                if r['mode'] == 'faithful']
    r50 = report['refinemask']['inference'][0]['ms_per_img']
    print(f'  refine_r50: {r50:.1f} ms/img against the flagship\'s faithful '
          f'{flagship[0]:.1f} (phase 4) in this call')
    return launches


# -- phase 11: the box-only detectors and the ResNet variants -----------------

FASTER = os.path.join(ROOT, 'configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py')
FASTER_FP16 = os.path.join(ROOT,
                           'configs/fp16/faster_rcnn_r50_fpn_fp16_1x_coco.py')
X101 = os.path.join(ROOT, 'configs/mask_rcnn/mask_rcnn_x101_32x4d_fpn_1x_coco.py')
CAFFE = os.path.join(ROOT, 'configs/mask_rcnn/mask_rcnn_r50_caffe_fpn_1x_coco.py')
RPN_CONFIG = os.path.join(ROOT, 'configs/rpn/rpn_r50_fpn_1x_coco.py')
FAST_RCNN = os.path.join(ROOT, 'configs/fast_rcnn/fast_rcnn_r50_fpn_1x_coco.py')
VOC_CONFIG = os.path.join(ROOT, 'configs/pascal_voc/'
                          'faster_rcnn_r50_fpn_1x_voc0712.py')
PROPOSAL_FILE = os.path.join(ROOT, 'build', 'chip_smoke_proposals',
                             'rpn_val.pkl')
VOC_SET = os.path.join(ROOT, 'build', 'chip_smoke_voc')
VOC_SIZES = ((500, 375), (375, 500), (500, 333), (353, 500))   # w x h
# Faster R-CNN's launches: its box extract alone (K2 an image; K2 and K4
# a step: the step's crops take every image of the batch in one launch)
BOX_INFER_COUNTS = {'roi_align_fwd': 1}
BOX_STEP_COUNTS = {'roi_align_fwd': 1, 'roi_align_bwd': 1}
# (name, config, bf16, an image's launches, a step's)
BOX_CELLS = (
    ('faster_rcnn', FASTER, False, BOX_INFER_COUNTS, BOX_STEP_COUNTS),
    ('faster_rcnn_fp16', FASTER_FP16, True, BOX_INFER_COUNTS,
     BOX_STEP_COUNTS),
    ('x101', X101, False, MASK_RCNN_INFER_COUNTS, MASK_RCNN_STEP_COUNTS),
    ('caffe', CAFFE, False, MASK_RCNN_INFER_COUNTS, MASK_RCNN_STEP_COUNTS),
)


def write_voc_set(root, seed=0, per_size=2):
    """A seeded VOC2007 layout in ``root``: ``per_size`` noise JPEGs at
    each of four VOC sizes with an XML file each, 2-6 objects of the 20
    classes, one in three difficult, and ``ImageSets/Main/test.txt``.
    Returns the object count."""
    import cv2
    import numpy as np
    from dynamask_torch.data import VOC_CLASSES
    rng = np.random.RandomState(seed)
    base = os.path.join(root, 'VOC2007')
    for d in ('JPEGImages', 'Annotations', 'ImageSets/Main'):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    ids, n_obj = [], 0
    for i in range(per_size * len(VOC_SIZES)):
        w, h = VOC_SIZES[i // per_size]
        img_id = f'{i:06d}'
        ids.append(img_id)
        cv2.imwrite(os.path.join(base, 'JPEGImages', f'{img_id}.jpg'),
                    rng.uniform(0, 255, (h, w, 3)).astype(np.uint8))
        objs = []
        for _ in range(rng.randint(2, 7)):
            bw, bh = rng.randint(w // 10, w // 2), rng.randint(h // 10, h // 2)
            x, y = rng.randint(1, w - bw), rng.randint(1, h - bh)
            objs.append(
                f'<object><name>{VOC_CLASSES[rng.randint(20)]}</name>'
                f'<difficult>{int(rng.rand() < 1 / 3)}</difficult><bndbox>'
                f'<xmin>{x}</xmin><ymin>{y}</ymin><xmax>{x + bw}</xmax>'
                f'<ymax>{y + bh}</ymax></bndbox></object>')
        n_obj += len(objs)
        with open(os.path.join(base, 'Annotations', f'{img_id}.xml'),
                  'w') as f:
            f.write(f'<annotation><size><width>{w}</width><height>{h}'
                    f'</height><depth>3</depth></size>{"".join(objs)}'
                    '</annotation>')
    with open(os.path.join(base, 'ImageSets/Main/test.txt'), 'w') as f:
        f.write('\n'.join(ids) + '\n')
    return n_obj


def gt_boxes_as_results(dataset):
    """The set's GT boxes as results (score 0.9), with the boxes as an
    RPN's proposals too."""
    import numpy as np
    results = []
    for i in range(len(dataset)):
        ann = dataset.get_ann_info(i)
        n = len(ann['bboxes'])
        dets = np.concatenate([ann['bboxes'], np.full((n, 1), 0.9,
                                                      np.float32)], 1)
        results.append({'img_id': dataset.sample_id(i), 'dets': dets,
                        'proposals': dets, 'labels': ann['labels'],
                        'valid': np.ones(n, bool)})
    return results


def run_box_eval(report, card, name, cfg, counts, init_std=None):
    """Phase 11, an evaluation drive: ``run_test``'s steps on ``cfg`` (its
    detector at its seeded initialisation on the card, or N(0,
    ``init_std``) weights from seed 0, its test set,
    ``single_device_test`` with its loader workers, timed by part),
    counters around them held to ``counts`` an image; every image's
    result finite and box-only. Returns (dataset, results, launches,
    seconds)."""
    import numpy as np
    import dynamask_torch.ops as ops
    from dynamask_torch.apis import init_detector, single_device_test
    from dynamask_torch.data import build_dataset
    ops.reset_kernel_launches()
    t = time.perf_counter()
    model = init_detector(cfg, device=DEVICE, seed=0, init_std=init_std)
    dataset = build_dataset(dict(cfg.data.test),
                            default_args=dict(test_mode=True))
    timings = {}
    results = single_device_test(model, dataset, progress=False,
                                 workers_per_gpu=cfg.data.workers_per_gpu,
                                 timings=timings)
    t_test = time.perf_counter() - t
    key = f'{name}_eval'
    launches = {key: ops.kernel_launches()}
    print(f'  {key}: ms/img: loader start-up '
          f'{1e3 * timings["startup"] / len(dataset):.1f}, host pipeline + '
          f'collate {1e3 * timings["pipeline"] / len(dataset):.1f}, device '
          f'(simple_test, synchronised) '
          f'{1e3 * timings["device"] / len(dataset):.1f}, device-to-host '
          f'copy {1e3 * timings["fetch"] / len(dataset):.1f} [{card}]')
    report.setdefault('box_eval_ms_per_img', {})[key] = {
        k: 1e3 * v / len(dataset) for k, v in timings.items()}
    check_exact_launches(key, launches[key], counts, times=len(dataset))
    if sorted(r['img_id'] for r in results) != sorted(
            dataset.sample_id(i) for i in range(len(dataset))):
        raise RuntimeError(f'{key}: results for {len(results)} images')
    for r in results:
        if 'masks' in r or not np.isfinite(r['dets'][r['valid']]).all():
            raise RuntimeError(f'{key}: image {r["img_id"]}: masks or '
                               'non-finite dets')
    return dataset, results, launches, t_test


def run_proposal_paths(report, card):
    """Phase 11, mmdet's RPN -> Fast R-CNN workflow over phase 6's set: the
    RPN config's eval drive (no kernel), ``proposal_fast`` AR and the
    ``proposal`` table, its proposals written as a ``proposal_file``; the
    Fast R-CNN config's eval drive reading that file (K2 an image), its
    bbox mAP; the GTs given as proposals must give AR 1.0 exactly."""
    import pickle
    from dynamask_torch.apis.test import proposal_lists
    from dynamask_torch.utils import Config
    ann_file, img_dir, n_gts = write_coco_set(COCO_SET)
    paths = dict(ann_file=ann_file, img_prefix=img_dir, data_root=None)
    cfg = Config.fromfile(RPN_CONFIG)
    cfg.data.test.update(paths)
    dataset, results, launches, t_test = run_box_eval(report, card, 'rpn',
                                                      cfg, {})
    n = len(dataset)
    plist = proposal_lists(results)
    metrics = dataset.evaluate(results, metric=['proposal_fast',
                                                'proposal'])
    gt = dataset.evaluate(gt_boxes_as_results(dataset),
                          metric=['proposal_fast'])
    if any(v != 1.0 for v in gt.values()):
        raise RuntimeError(f'rpn_eval: the GTs as proposals give {gt}')
    os.makedirs(os.path.dirname(PROPOSAL_FILE), exist_ok=True)
    with open(PROPOSAL_FILE, 'wb') as f:
        pickle.dump(plist, f)
    counts = [len(p) for p in plist]
    print(f'  rpn_eval: {n} images, {n_gts} GTs; run_test {t_test:.1f} s '
          f'({n / t_test:.2f} img/s, {cfg.data.workers_per_gpu} loader '
          f'workers) [{card}]; {min(counts)}-{max(counts)} proposals an '
          'image; ' + ', '.join(f'{k} {metrics[k]:.4f}' for k in
                                ('AR@100', 'AR@300', 'AR@1000')) +
          f' (random weights; proposal_fast), the GTs as proposals {gt}; '
          f'written to {os.path.relpath(PROPOSAL_FILE, ROOT)}; launches '
          f'{launches["rpn_eval"]}')
    report['proposals'] = {'rpn': dict(images=n, run_test_s=t_test,
                                       proposals=counts, metrics=metrics,
                                       gt_as_proposals=gt,
                                       launches=launches['rpn_eval'])}
    cfg = Config.fromfile(FAST_RCNN)
    cfg.data.test.update(paths, proposal_file=PROPOSAL_FILE)
    dataset, results, got, t_test = run_box_eval(report, card, 'fast_rcnn',
                                                 cfg, BOX_INFER_COUNTS)
    launches.update(got)
    read = [int(dataset[i]['proposal_valid'].sum()) for i in range(n)]
    if read != counts:
        raise RuntimeError(f'fast_rcnn_eval: read {read} proposals, the '
                           f'RPN wrote {counts}')
    metrics = dataset.evaluate(results, metric=['bbox'])
    n_valid = sum(int(r['valid'].sum()) for r in results)
    print(f'  fast_rcnn_eval: {n} images on the RPN\'s proposals; run_test '
          f'{t_test:.1f} s ({n / t_test:.2f} img/s) [{card}]; {n_valid} '
          f'valid dets; bbox_mAP {metrics["bbox_mAP"]:.4f} (random '
          f'weights); launches {got["fast_rcnn_eval"]}')
    report['proposals']['fast_rcnn'] = dict(
        images=n, run_test_s=t_test, valid_dets=n_valid, metrics=metrics,
        launches=got['fast_rcnn_eval'])
    return launches


def run_voc_path(report, card):
    """Phase 11, the VOC config's eval drive on a seeded VOC2007 layout in
    ``build/chip_smoke_voc/``: K2 an image, the VOC2007 ('11points') mAP;
    the GTs given as predictions must give mAP 1.0 (to 1e-12: eleven
    elevenths)."""
    from dynamask_torch.utils import Config
    n_obj = write_voc_set(VOC_SET)
    cfg = Config.fromfile(VOC_CONFIG)
    cfg.data.test.update(data_root=VOC_SET)
    dataset, results, launches, t_test = run_box_eval(
        report, card, 'voc', cfg, BOX_INFER_COUNTS)
    metrics = dataset.evaluate(results, metric=['mAP'])
    gt = dataset.evaluate(gt_boxes_as_results(dataset), metric=['mAP'])
    if abs(gt['mAP'] - 1.0) > 1e-12 or dataset.year != 2007:
        raise RuntimeError(f'voc_eval: the GTs as predictions give {gt}')
    n = len(dataset)
    print(f'  voc_eval: {n} images, {n_obj} objects, {len(dataset.CLASSES)} '
          f'classes; run_test {t_test:.1f} s ({n / t_test:.2f} img/s, '
          f'{cfg.data.workers_per_gpu} loader workers) [{card}]; mAP '
          f'{metrics["mAP"]:.4f} (random weights, VOC2007 11 points), the '
          f'GTs as predictions {gt["mAP"]}; launches {launches["voc_eval"]}')
    report['voc'] = dict(images=n, objects=n_obj, run_test_s=t_test,
                         metrics=metrics, gt_as_predictions=gt,
                         launches=launches['voc_eval'])
    return launches


def run_box_only(report, card):
    """Phase 11: Faster R-CNN (fp32, and bf16 from the fp16 config), Mask
    R-CNN X101-32x4d and R50-caffe, each from its config file, unchanged,
    at full width: one image at 800x1344 and one step at 4x800x1344
    (phases 4-5's weights protocol), each a counted warm-up held to its
    exact launches and 2 timed repeats; then the RPN -> Fast R-CNN eval
    drives and the VOC one."""
    import torch
    from dynamask_torch.apis import config_shapes
    launches = {}
    report['box_only'] = {'inference': [], 'train': []}
    for name, path, bf16, infer, step in BOX_CELLS:
        test_hw, images, train_hw = config_shapes(path)
        prec = 'bf16' if bf16 else 'fp32'
        got, recs = run_config_inference(
            report, card, name, path, test_hw,
            (('infer', None, in_precision(infer, prec)),), repeats=2,
            bf16=bf16)
        launches.update(got)
        report['box_only']['inference'] += recs
        got, rec = run_config_train(
            report, card, name, path, images, train_hw,
            in_precision(step, prec), repeats=2,
            compute_dtype=torch.bfloat16 if bf16 else None)
        launches.update(got)
        report['box_only']['train'].append(rec)
    launches.update(run_proposal_paths(report, card))
    launches.update(run_voc_path(report, card))
    return launches


# -- phase 12: Cascade R-CNN and Hybrid Task Cascade -------------------------

CASCADE_CONFIG = os.path.join(ROOT, 'configs/cascade_rcnn/'
                              'cascade_mask_rcnn_r50_fpn_1x_coco.py')
HTC_CONFIG = os.path.join(ROOT, 'configs/htc/htc_r50_fpn_1x_coco.py')
# their launches: K2 for each stage's box extract, one launch an extract
# (the step's take every image of the batch in one); Cascade Mask R-CNN
# adds its one mask extract; HTC adds the semantic crop (single level,
# stride 8, ratio 1) to each box and mask extract, and in training runs
# one mask extract a stage; K4 for each crop's gradient in a step
CASCADE_BOX_INFER = {'roi_align_fwd': 3}
CASCADE_BOX_STEP = {'roi_align_fwd': 3, 'roi_align_bwd': 3}
CASCADE_INFER = {'roi_align_fwd': 4}
CASCADE_STEP = {'roi_align_fwd': 4, 'roi_align_bwd': 4}
HTC_INFER = {'roi_align_fwd': 8}
HTC_STEP = {'roi_align_fwd': 12, 'roi_align_bwd': 12}
HTC_NOSEM_INFER = {'roi_align_fwd': 4}
# (name, config, timed repeats of an image, timed steps (None: no step),
# an image's launches, a step's)
CASCADE_CELLS = (
    ('cascade_mask_rcnn', CASCADE_CONFIG, 3, 2, CASCADE_INFER, CASCADE_STEP),
    ('cascade_rcnn', os.path.join(ROOT, 'configs/cascade_rcnn/'
                                  'cascade_rcnn_r50_fpn_1x_coco.py'),
     1, 1, CASCADE_BOX_INFER, CASCADE_BOX_STEP),
    ('htc', HTC_CONFIG, 3, 2, HTC_INFER, HTC_STEP),
    ('htc_without_semantic', os.path.join(
        ROOT, 'configs/htc/htc_without_semantic_r50_fpn_1x_coco.py'),
     1, None, HTC_NOSEM_INFER, None),
    ('htc_x101', os.path.join(ROOT, 'configs/htc/'
                              'htc_x101_64x4d_fpn_16x1_20e_coco.py'),
     1, 1, HTC_INFER, HTC_STEP),
)


def run_cascades(report, card):
    """Phase 12: Cascade Mask R-CNN, Cascade R-CNN, HTC, HTC without its
    semantic branch and HTC on ResNeXt-101 64x4d, each from its config
    file, unchanged, at full width: one image at the config's test canvas
    (phase 4's weights protocol) and steps at its train batch (HTC's with
    ``gt_semantic_seg``), each a counted warm-up held to its exact
    launches, then timed repeats; then phase 6's eval drive on HTC."""
    from dynamask_torch.apis import config_shapes
    launches = {}
    report['cascades'] = {'inference': [], 'train': []}
    for name, path, n_inf, n_steps, infer, step in CASCADE_CELLS:
        test_hw, images, train_hw = config_shapes(path)
        got, recs = run_config_inference(
            report, card, name, path, test_hw, (('infer', None, infer),),
            repeats=n_inf)
        launches.update(got)
        report['cascades']['inference'] += recs
        if n_steps:
            got, rec = run_config_train(report, card, name, path, images,
                                        train_hw, step, repeats=n_steps)
            launches.update(got)
            report['cascades']['train'].append(rec)
    launches.update(run_eval_path(report, card, HTC_CONFIG, HTC_INFER,
                                  HTC_STEP, 'htc_'))
    return launches


# -- phase 13: the two-stage family's options --------------------------------

GN_WS_CONFIG = os.path.join(ROOT, 'configs/gn+ws/'
                            'mask_rcnn_r50_fpn_gn_ws-all_2x_coco.py')
GROIE_CONFIG = os.path.join(ROOT, 'configs/groie/'
                            'mask_rcnn_r50_fpn_groie_1x_coco.py')
SOFT_NMS_CONFIG = os.path.join(ROOT, 'configs/faster_rcnn/'
                               'faster_rcnn_r50_fpn_soft_nms_1x_coco.py')
# the drives take phase 11's launches (one box extract; Double-Head's
# takes its cls crop and its enlarged reg crop in one) or Mask R-CNN's (box
# + mask extract), GRoIE's all-level extracts one launch each
# (name, config, timed repeats of an image (None: no image), timed steps
# (None: no step), an image's launches, a step's)
TWO_STAGE_CELLS = (
    ('gn_ws', GN_WS_CONFIG, 3, 2, MASK_RCNN_INFER_COUNTS,
     MASK_RCNN_STEP_COUNTS),
    ('gn_ws_x101', os.path.join(
        ROOT, 'configs/gn+ws/mask_rcnn_x101_32x4d_fpn_gn_ws-all_2x_coco.py'),
     1, 1, MASK_RCNN_INFER_COUNTS, MASK_RCNN_STEP_COUNTS),
    ('groie', GROIE_CONFIG, 3, 2, MASK_RCNN_INFER_COUNTS,
     MASK_RCNN_STEP_COUNTS),
    ('double_head', os.path.join(
        ROOT, 'configs/double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py'),
     1, 1, BOX_INFER_COUNTS, BOX_STEP_COUNTS),
    ('carafe', os.path.join(
        ROOT, 'configs/carafe/mask_rcnn_r50_fpn_carafe_1x_coco.py'),
     1, 1, MASK_RCNN_INFER_COUNTS, MASK_RCNN_STEP_COUNTS),
    ('giou', os.path.join(
        ROOT, 'configs/faster_rcnn/faster_rcnn_r50_fpn_giou_1x_coco.py'),
     None, 1, BOX_INFER_COUNTS, BOX_STEP_COUNTS),
    ('ohem', os.path.join(
        ROOT, 'configs/faster_rcnn/faster_rcnn_r50_fpn_ohem_1x_coco.py'),
     None, 1, BOX_INFER_COUNTS, BOX_STEP_COUNTS),
    ('soft_nms', SOFT_NMS_CONFIG, 1, None, BOX_INFER_COUNTS, None),
)


# the card's Soft-NMS dets against the CPU's: |a - b| <= atol + rtol |b|
# (the boxes, up to 1344 px, are gathered, not computed; the scores decay
# by IoUs of fp32 boxes offset by up to 80 x 1345 px)
SOFT_NMS_ATOL, SOFT_NMS_RTOL = 1e-5, 1e-6


def time_soft_nms(report, card):
    """The Soft-NMS config's test NMS on the card: its box head's decoded
    boxes and scores of one image (1000 proposals x 80 classes, random
    weights N(0, 0.05), seed 0) through ``multiclass_nms`` with Soft-NMS
    (100 selection steps on the device) and with greedy NMS, each timed
    with CUDA events on the same inputs; both must give finite dets, and
    the card's Soft-NMS must give the CPU's on the same arguments: labels
    and validity exactly, scores and boxes within ``SOFT_NMS_ATOL`` and
    ``SOFT_NMS_RTOL``."""
    import torch
    import dynamask_torch.models.bbox_head as bh
    from dynamask_torch.apis import inference_detector, init_detector
    model = init_detector(SOFT_NMS_CONFIG, device=DEVICE, seed=0,
                          init_std=0.05)
    h, w = IMAGE_HW
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    batch = {'image': torch.randn(1, h, w, 3, generator=gen, device=DEVICE),
             'img_shape': torch.tensor([[h, w]], dtype=torch.float32,
                                       device=DEVICE),
             'scale_factor': torch.ones(1, 4, device=DEVICE)}
    seen, nms = [], bh.multiclass_nms
    bh.multiclass_nms = lambda *a, **k: seen.append((a, k)) or nms(*a, **k)
    try:
        inference_detector(model, batch)
    finally:
        bh.multiclass_nms = nms
    (args, kw), = seen
    if kw.get('nms_type') != 'soft_nms':
        raise RuntimeError(f'soft_nms: the test NMS was called with {kw}')
    greedy_kw = {k: v for k, v in kw.items()
                 if k not in ('nms_type', 'sigma', 'min_score')}
    soft = nms(*args, **kw)
    greedy = nms(*args, **greedy_kw)
    for what, out in (('soft', soft), ('greedy', greedy)):
        if not torch.isfinite(out[0]).all():
            raise RuntimeError(f'soft_nms: non-finite {what} dets')
    cpu = nms(*[a.cpu() if torch.is_tensor(a) else a for a in args],
              **{k: v.cpu() if torch.is_tensor(v) else v
                 for k, v in kw.items()})
    for what, a, b in zip(('labels', 'validity'), soft[1:], cpu[1:]):
        if not torch.equal(a.cpu(), b):
            raise RuntimeError(f'soft_nms: the card\'s {what} differ from '
                               'the CPU\'s')
    diff = (soft[0].cpu() - cpu[0]).abs()
    soft_err = diff.max().item()
    if not (diff <= SOFT_NMS_ATOL + SOFT_NMS_RTOL * cpu[0].abs()).all():
        raise RuntimeError(f'soft_nms: dets differ from the CPU\'s by up to '
                           f'{soft_err} (atol {SOFT_NMS_ATOL}, rtol '
                           f'{SOFT_NMS_RTOL})')
    soft_ms = cuda_ms(lambda: nms(*args, **kw), iters=10)
    greedy_ms = cuda_ms(lambda: nms(*args, **greedy_kw), iters=10)
    boxes, scores = args[:2]
    cands = int((scores > args[2]).sum())
    print(f'  soft_nms: multiclass_nms on one image\'s {tuple(scores.shape)} '
          f'scores ({cands} over score_thr {args[2]}): Soft-NMS '
          f'{soft_ms:.3f} ms ({int(soft[2].sum())} dets), greedy NMS '
          f'{greedy_ms:.3f} ms ({int(greedy[2].sum())} dets), device time '
          f'by CUDA events; against the CPU: labels and validity equal, '
          f'dets max abs err {soft_err:.3g} [{card}]')
    report['soft_nms_timing'] = dict(soft_ms=soft_ms, greedy_ms=greedy_ms,
                                     candidates=cands,
                                     max_abs_err_vs_cpu=soft_err,
                                     soft_dets=int(soft[2].sum()),
                                     greedy_dets=int(greedy[2].sum()))
    del model
    torch.cuda.empty_cache()


def run_two_stage(report, card):
    """Phase 13: GN+WS Mask R-CNN (R50 and X101-32x4d), GRoIE Mask R-CNN,
    Double-Head Faster R-CNN, CARAFE Mask R-CNN, and the GIoU, OHEM and
    Soft-NMS Faster R-CNNs, each from its config file, unchanged, at full
    width: one image at the config's test canvas (phase 4's weights
    protocol) and steps at its train batch (4x800x1344, 20 GTs an image),
    each a counted warm-up held to its exact launches, then timed repeats;
    then phase 6's eval drive on GRoIE, and the Soft-NMS call against
    greedy NMS on the same dets."""
    from dynamask_torch.apis import config_shapes
    launches = {}
    report['two_stage'] = {'inference': [], 'train': []}
    for name, path, n_inf, n_steps, infer, step in TWO_STAGE_CELLS:
        test_hw, images, train_hw = config_shapes(path)
        if n_inf:
            got, recs = run_config_inference(
                report, card, name, path, test_hw, (('infer', None, infer),),
                repeats=n_inf)
            launches.update(got)
            report['two_stage']['inference'] += recs
        if n_steps:
            got, rec = run_config_train(report, card, name, path, images,
                                        train_hw, step, repeats=n_steps)
            launches.update(got)
            report['two_stage']['train'].append(rec)
    launches.update(run_eval_path(report, card, GROIE_CONFIG,
                                  MASK_RCNN_INFER_COUNTS,
                                  MASK_RCNN_STEP_COUNTS, 'groie_'))
    time_soft_nms(report, card)
    return launches


# -- phase 14: the single-stage detectors -------------------------------------

RETINANET = os.path.join(ROOT, 'configs/retinanet/retinanet_r50_fpn_1x_coco.py')
ATSS_CONFIG = os.path.join(ROOT, 'configs/atss/atss_r50_fpn_1x_coco.py')
FCOS_CENTER = os.path.join(ROOT, 'configs/fcos/fcos_center-normbbox-'
                           'centeronreg-giou_r50_caffe_fpn_gn-head_4x4_1x_'
                           'coco.py')
CROP640_HW = (640, 640)   # the crop640 recipe's training crops
# (name, config, timed repeats of an image (None: no image), timed steps
# (None: no step), bf16, the canvas of both (None: the config's own));
# no hand kernel runs on these paths: each drive holds every counter at 0
SINGLE_STAGE_CELLS = (
    ('retinanet', RETINANET, 3, 2, False, None),
    ('retinanet_fp16', os.path.join(
        ROOT, 'configs/fp16/retinanet_r50_fpn_fp16_1x_coco.py'),
     1, 1, True, None),
    ('retinanet_v1', os.path.join(
        ROOT, 'configs/legacy_1.x/retinanet_r50_fpn_1x_coco_v1.py'),
     1, None, False, None),
    ('ghm', os.path.join(ROOT, 'configs/ghm/retinanet_ghm_r50_fpn_1x_coco.py'),
     None, 1, False, None),
    ('free_anchor', os.path.join(
        ROOT, 'configs/free_anchor/retinanet_free_anchor_r50_fpn_1x_coco.py'),
     None, 1, False, None),
    ('crop640', os.path.join(
        ROOT, 'configs/nas_fpn/retinanet_r50_fpn_crop640_50e_coco.py'),
     1, 1, False, CROP640_HW),
    ('atss', ATSS_CONFIG, 1, 1, False, None),
    ('fcos', os.path.join(
        ROOT, 'configs/fcos/fcos_r50_caffe_fpn_gn-head_4x4_1x_coco.py'),
     1, 1, False, None),
    ('fcos_center', FCOS_CENTER, 1, 1, False, None),
)
# the card's toy outputs against the CPU's from the same weights: dets
# within TOY_DET_TOL (absolute, on scores and on boxes of a 96x128 canvas),
# labels and validity equal; each loss within TOY_LOSS_RTOL relative
TOY_DET_TOL = 1e-4
TOY_LOSS_RTOL = 1e-4
SINGLE_STAGE_TOYS = {'retinanet': RETINANET, 'atss': ATSS_CONFIG,
                     'fcos': FCOS_CENTER}


def single_stage_toy(kind, path=None):
    """The config of a single-stage toy (``kind``'s, or the file at
    ``path``): ResNet-18, a 32-channel FPN with its extra levels, two-conv
    heads of 32 channels, 8 classes, 50 candidates a level and 20 dets an
    image."""
    from dynamask_torch.utils import Config
    cfg = Config.fromfile(path or SINGLE_STAGE_TOYS[kind])
    m = cfg.model
    m.backbone.depth = 18
    m.neck.in_channels = [64, 128, 256, 512]
    m.neck.out_channels = 32
    m.bbox_head.update(in_channels=32, feat_channels=32, stacked_convs=2,
                       num_classes=8)
    cfg.test_cfg.update(nms_pre=50, max_per_img=20)
    return cfg


def check_single_stage_toys(report):
    """Phase 3, the single-stage toys (RetinaNet, ATSS, FCOS with center
    sampling, ``norm_on_bbox`` and GN): built on the CPU with N(0, 0.05)
    weights from seed 0 and copied to the card; two seeded 96x128 images
    through ``simple_test`` and a training step's losses on the same batch
    on both."""
    import copy
    import torch
    from dynamask_torch.apis import synthetic_batch
    from dynamask_torch.models import build_detector
    for kind in SINGLE_STAGE_TOYS:
        cfg = single_stage_toy(kind)
        cpu = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                             device='cpu', seed=0, init_std=0.05)
        gpu = copy.deepcopy(cpu).to(DEVICE)
        batch = synthetic_batch(3, b=2, h=96, w=128, num_gts=4,
                                num_classes=8)
        batch['scale_factor'] = torch.tensor([[1.0] * 4, [0.8] * 4])
        ref = cpu.simple_test(batch)
        got = gpu.simple_test({k: v.to(DEVICE) for k, v in batch.items()})
        for k in ('labels', 'det_valid'):
            if not torch.equal(got[k].cpu(), ref[k]):
                raise RuntimeError(f'toy {kind}: the card\'s {k} differ '
                                   'from the CPU\'s')
        err = (got['dets'].cpu() - ref['dets']).abs().max().item()
        if err > TOY_DET_TOL or int(ref['det_valid'].sum()) < 4:
            raise RuntimeError(f'toy {kind}: dets max abs err {err} '
                               f'({int(ref["det_valid"].sum())} valid)')
        cpu.train()
        gpu.train()
        lref = {k: float(v.detach()) for k, v in
                cpu.forward_train(batch).items()}
        lgot = {k: float(v.detach()) for k, v in gpu.forward_train(
            {k: v.to(DEVICE) for k, v in batch.items()}).items()}
        rel = {k: abs(lgot[k] - v) / max(abs(v), 1e-12)
               for k, v in lref.items()}
        if max(rel.values()) > TOY_LOSS_RTOL or not all(
                math.isfinite(v) and v > 0 for v in lref.values()):
            raise RuntimeError(f'toy {kind}: losses {lgot} vs the CPU\'s '
                               f'{lref}')
        print(f'  toy {kind}: {int(ref["det_valid"].sum())} valid dets, '
              f'labels and validity equal, dets max abs err {err:.3g} '
              f'(tol {TOY_DET_TOL}); losses max rel err '
              f'{max(rel.values()):.3g} (tol {TOY_LOSS_RTOL})')
        report['toy'].append(dict(toy=f'single_stage_{kind}',
                                  dets_max_abs_err=err, loss_rel_err=rel))
        del cpu, gpu


def run_single_stage_eval(report, card):
    """Phase 14, RetinaNet's evaluation drive: phase 6's seeded COCO set
    through the config's test pipeline, its 4 loader workers and
    ``single_device_test`` (N(0, 0.05) weights from seed 0, boxes only),
    the ms/img split of phase 11, counters held at 0; bbox AP, and the GTs
    as predictions must score exactly 1.0."""
    from dynamask_torch.utils import Config
    ann_file, img_dir, n_gts = write_coco_set(COCO_SET)
    cfg = Config.fromfile(RETINANET)
    cfg.data.test.update(ann_file=ann_file, img_prefix=img_dir,
                         data_root=None)
    dataset, results, launches, t_test = run_box_eval(
        report, card, 'retinanet', cfg, {}, init_std=0.05)
    t = time.perf_counter()
    metrics = dataset.evaluate(results, metric=['bbox'])
    t_eval = time.perf_counter() - t
    gt = dataset.evaluate(gt_boxes_as_results(dataset), metric=['bbox'])
    if gt['bbox_mAP'] != 1.0:
        raise RuntimeError(f'retinanet_eval: the GTs as predictions give '
                           f'{gt}')
    n = len(dataset)
    n_valid = sum(int(r['valid'].sum()) for r in results)
    print(f'  retinanet_eval: {n} images, {n_gts} GTs; run_test {t_test:.1f} '
          f's ({n / t_test:.2f} img/s with {cfg.data.workers_per_gpu} loader '
          f'workers started), evaluate {t_eval:.2f} s [{card}]; {n_valid} '
          f'valid dets; bbox_mAP {metrics["bbox_mAP"]:.4f} (random '
          f'weights), the GTs as predictions {gt["bbox_mAP"]}; launches '
          f'{launches["retinanet_eval"]}')
    report['single_stage']['eval'] = dict(
        images=n, run_test_s=t_test, evaluate_s=t_eval, valid_dets=n_valid,
        metrics=metrics, gt_as_predictions=gt,
        launches=launches['retinanet_eval'])
    return launches


def run_single_stage(report, card):
    """Phase 14: RetinaNet (fp32, and bf16 from the fp16 config), the
    legacy v1, GHM and FreeAnchor RetinaNets, the crop640 RetinaNet
    (``RetinaSepBNHead`` over the BN FPN, at 640x640), ATSS, and FCOS with
    its center-sampling twin, each from its config file, unchanged, at full
    width: one image at the test canvas (phase 4's weights protocol) and
    steps at the train batch (4 images, 20 GTs each), each a counted
    warm-up with every kernel held at 0 launches, then timed repeats;
    then RetinaNet's eval drive."""
    import torch
    from dynamask_torch.apis import config_shapes
    launches = {}
    report['single_stage'] = {'inference': [], 'train': []}
    for name, path, n_inf, n_steps, bf16, canvas in SINGLE_STAGE_CELLS:
        test_hw, images, train_hw = config_shapes(path)
        if n_inf:
            got, recs = run_config_inference(
                report, card, name, path, canvas or test_hw,
                (('infer', None, {}),), repeats=n_inf, bf16=bf16)
            launches.update(got)
            report['single_stage']['inference'] += recs
        if n_steps:
            got, rec = run_config_train(
                report, card, name, path, images, canvas or train_hw, {},
                repeats=n_steps,
                compute_dtype=torch.bfloat16 if bf16 else None)
            launches.update(got)
            report['single_stage']['train'].append(rec)
    launches.update(run_single_stage_eval(report, card))
    return launches


# -- phase 15: the detectors on item 8's backbones and necks ------------------

HRNET_DIR = os.path.join(ROOT, 'configs/hrnet')
HRNET_MASK_W18 = os.path.join(HRNET_DIR, 'mask_rcnn_hrnetv2p_w18_1x_coco.py')
FCOS_HRNET = os.path.join(HRNET_DIR,
                          'fcos_hrnetv2p_w32_gn-head_4x4_1x_coco.py')
REGNET_MASK = os.path.join(ROOT, 'configs/regnet/'
                           'mask_rcnn_regnetx-3.2GF_fpn_1x_coco.py')
RES2NET_MASK = os.path.join(ROOT,
                            'configs/res2net/mask_rcnn_r2_101_fpn_2x_coco.py')
PAFPN_FASTER = os.path.join(ROOT,
                            'configs/pafpn/faster_rcnn_r50_pafpn_1x_coco.py')
# (name, config, timed repeats of an image, timed steps (None: no step),
# an image's launches, a step's); K1, K3 and K5 run on none of them. The
# HRNet steps start from N(0, 0.05) weights (phase 4's protocol), as the
# HRNet eval drive's step does: at the JAX initialisation, under JAX's
# ``norm_eval=True`` (ROADMAP.md queue 3, 3aj), HRNet's activations reach
# ~5e7 and the first update makes the second step's losses non-finite
HRNET_STEP_STD = 0.05
ITEM8_CELLS = (
    ('hrnet_w32', os.path.join(HRNET_DIR, 'mask_rcnn_hrnetv2p_w32_1x_coco.py'),
     1, 1, MASK_RCNN_INFER_COUNTS, MASK_RCNN_STEP_COUNTS),
    ('htc_hrnet_w18', os.path.join(HRNET_DIR, 'htc_hrnetv2p_w18_20e_coco.py'),
     1, 1, HTC_INFER, HTC_STEP),
    ('cascade_hrnet_w40', os.path.join(
        HRNET_DIR, 'cascade_mask_rcnn_hrnetv2p_w40_20e_coco.py'),
     1, None, CASCADE_INFER, None),
    ('fcos_hrnet_w32', FCOS_HRNET, 1, 1, {}, {}),
    ('regnetx_3.2gf', REGNET_MASK, 1, 1, MASK_RCNN_INFER_COUNTS,
     MASK_RCNN_STEP_COUNTS),
    ('retinanet_regnetx_800mf', os.path.join(
        ROOT, 'configs/regnet/retinanet_regnetx-800MF_fpn_1x_coco.py'),
     1, None, {}, None),
    ('res2net_101', RES2NET_MASK, 1, 1, MASK_RCNN_INFER_COUNTS,
     MASK_RCNN_STEP_COUNTS),
    ('pafpn', PAFPN_FASTER, 1, 1, BOX_INFER_COUNTS, BOX_STEP_COUNTS),
)
# the toys: (config, its backbone and neck at toy width); the heads as
# :func:`toy_cfg` makes them
TOY_HRNET = dict(
    stage1=dict(num_modules=1, num_branches=1, block='BOTTLENECK',
                num_blocks=(2,), num_channels=(16,)),
    stage2=dict(num_modules=1, num_branches=2, block='BASIC',
                num_blocks=(1, 2), num_channels=(8, 16)),
    stage3=dict(num_modules=1, num_branches=3, block='BASIC',
                num_blocks=(1, 1, 1), num_channels=(8, 16, 32)),
    stage4=dict(num_modules=1, num_branches=4, block='BASIC',
                num_blocks=(1, 1, 1, 1), num_channels=(8, 16, 32, 64)))
ITEM8_TOYS = {
    'hrnet': (HRNET_MASK_W18, dict(extra=TOY_HRNET, frozen_stages=1),
              [8, 16, 32, 64]),
    'regnet': (REGNET_MASK, dict(arch=dict(
        w0=16, wa=16.0, wm=2.0, group_w=8, depth=7, bot_mul=1.0)),
        [16, 32, 64, 128]),
    'res2net': (RES2NET_MASK, dict(depth=50), None),
    'pafpn': (PAFPN_FASTER, dict(depth=18), [64, 128, 256, 512]),
    'fcos_hrnet': (FCOS_HRNET, dict(extra=TOY_HRNET), [8, 16, 32, 64]),
}


def item8_toy(kind):
    """The config of an item-8 toy: the config file's detector on the toy
    backbone and a 32-channel neck (HRFPN keeps its stride), its heads at
    toy width (:func:`toy_cfg`'s for the two-stage ones; FCOS's two-conv
    heads of 32 channels, 8 classes, 50 candidates a level, 20 dets)."""
    from dynamask_torch.utils import Config
    path, backbone, in_channels = ITEM8_TOYS[kind]
    cfg = Config.fromfile(path)
    m = cfg.model
    m.backbone.update(backbone)
    if in_channels:
        m.neck.in_channels = in_channels
    m.neck.out_channels = 32
    if kind == 'fcos_hrnet':
        m.bbox_head.update(in_channels=32, feat_channels=32, stacked_convs=2,
                           num_classes=8)
        cfg.test_cfg.update(nms_pre=50, max_per_img=20)
        return cfg
    m.rpn_head.in_channels = m.rpn_head.feat_channels = 32
    rh = m.roi_head
    for ext in (rh.bbox_roi_extractor, rh.get('mask_roi_extractor')):
        if ext:
            ext.out_channels = 32
    rh.bbox_head.update(in_channels=32, fc_out_channels=64, num_classes=8)
    if rh.mask_head:
        rh.mask_head.update(num_convs=2, in_channels=32, conv_out_channels=32,
                            num_classes=8)
    cfg.test_cfg.rpn.nms_pre = 64
    cfg.train_cfg.rpn_proposal.max_num = 32
    cfg.train_cfg.rcnn.sampler.num = 64
    cfg.test_cfg.rcnn.max_per_img = 8
    return cfg


def check_item8_toys(report):
    """Phase 3, the item-8 toys: Mask R-CNN on HRNet + HRFPN, on RegNet
    and on Res2Net-50, Faster R-CNN on PAFPN and FCOS on HRFPN at stride
    2, each built on the CPU at its seeded initialisation (FCOS at N(0,
    0.05)) and loaded into the same model on the card; two seeded 128x128
    images (the second at
    scale factor 0.8) through ``simple_test``, and one training step on a
    seeded batch with the same sampler draws and the card's RPN proposals
    on both (:func:`toy_train_step`): labels and validity equal, dets
    within TOY_DET_TOL, each loss within TOY_LOSS_RTOL relative."""
    import numpy as np
    import torch
    from dynamask_torch.apis import synthetic_batch
    from dynamask_torch.models import build_detector
    for kind in ITEM8_TOYS:
        cfg = item8_toy(kind)
        # FCOS at N(0, 0.05) as phase 3's single-stage toys: at its own
        # init the prior bias keeps every score below the threshold
        cpu = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                             device='cpu', seed=0, init_std=0.05 if
                             kind == 'fcos_hrnet' else None)
        gpu = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                             device=DEVICE)
        gpu.load_state_dict(cpu.state_dict())
        b, hw, max_gts = 2, 128, 4
        batch = synthetic_batch(3, b=b, h=hw, w=hw, num_gts=3,
                                max_gts=max_gts, crop_size=32, num_classes=8,
                                device='cpu')
        test = {k: batch[k] for k in ('image', 'img_shape')}
        test['scale_factor'] = torch.tensor([[1.0] * 4, [0.8] * 4])
        with torch.no_grad():
            ref = cpu.simple_test(test)
            got = gpu.simple_test({k: v.to(DEVICE) for k, v in test.items()})
        for k in ('labels', 'det_valid'):
            if not torch.equal(got[k].cpu(), ref[k]):
                raise RuntimeError(f'toy {kind}: the card\'s {k} differ '
                                   'from the CPU\'s')
        err = (got['dets'].cpu() - ref['dets']).abs().max().item()
        if err > TOY_DET_TOL or int(ref['det_valid'].sum()) < 4:
            raise RuntimeError(f'toy {kind}: dets max abs err {err} '
                               f'({int(ref["det_valid"].sum())} valid)')
        cpu.train()
        gpu.train()
        if kind == 'fcos_hrnet':     # no draws, no proposals
            lref = {k: float(v.detach()) for k, v in
                    cpu.forward_train(batch).items()}
            lgot = {k: float(v.detach()) for k, v in gpu.forward_train(
                {k: v.to(DEVICE) for k, v in batch.items()}).items()}
        else:
            rng = np.random.RandomState(4)
            n_anchors = 3 * sum((hw // s) ** 2 for s in (4, 8, 16, 32, 64))
            noise = {k: torch.from_numpy(v.astype(np.float32)) for k, v in {
                'rpn': rng.uniform(size=(b, n_anchors)),
                'rcnn': rng.uniform(size=(
                    b, max_gts + cfg.train_cfg.rpn_proposal.max_num))}.items()}
            lgot, _, props = toy_train_step(gpu, batch, noise)
            lref, _, _ = toy_train_step(cpu, batch, noise, props)
        keys = [k for k in lref if 'loss' in k]
        rel = {k: abs(lgot[k] - lref[k]) / max(abs(lref[k]), 1e-12)
               for k in keys}
        if max(rel.values()) > TOY_LOSS_RTOL or not all(
                math.isfinite(lref[k]) and lref[k] > 0 for k in keys):
            raise RuntimeError(f'toy {kind}: losses {lgot} vs the CPU\'s '
                               f'{lref}')
        print(f'  toy {kind}: {int(ref["det_valid"].sum())} valid dets, '
              f'labels and validity equal, dets max abs err {err:.3g} '
              f'(tol {TOY_DET_TOL}); {len(keys)} losses, max rel err '
              f'{max(rel.values()):.3g} (tol {TOY_LOSS_RTOL})')
        report['toy'].append(dict(toy=f'item8_{kind}', dets_max_abs_err=err,
                                  loss_rel_err=rel))
        del cpu, gpu


def run_item8(report, card):
    """Phase 15: the detectors on HRNet + HRFPN, RegNet, Res2Net and PAFPN,
    each from its config file, unchanged, at full width: an image at the
    config's test canvas (phase 4's weights protocol) and steps at its
    train batch (the HRNet steps from N(0, HRNET_STEP_STD) weights), each
    a counted warm-up held to its exact launches, then timed repeats; then
    phase 6's eval drive and loader-batch step on the HRNet-W18 Mask
    R-CNN."""
    from dynamask_torch.apis import config_shapes
    launches = {}
    report['item8'] = {'inference': [], 'train': []}
    for name, path, n_inf, n_steps, infer, step in ITEM8_CELLS:
        test_hw, images, train_hw = config_shapes(path)
        got, recs = run_config_inference(
            report, card, name, path, test_hw, (('infer', None, infer),),
            repeats=n_inf)
        launches.update(got)
        report['item8']['inference'] += recs
        if n_steps:
            got, rec = run_config_train(
                report, card, name, path, images, train_hw, step,
                repeats=n_steps, init_std=HRNET_STEP_STD if 'hrnet' in name
                else None)
            launches.update(got)
            report['item8']['train'].append(rec)
    launches.update(run_eval_path(report, card, HRNET_MASK_W18,
                                  MASK_RCNN_INFER_COUNTS,
                                  MASK_RCNN_STEP_COUNTS, 'hrnet_',
                                  init_std=HRNET_STEP_STD))
    return launches


# -- phase 16: the backbones' deformable convs and block plugins (item 7) ----

DCN_DIR = os.path.join(ROOT, 'configs/dcn')
MDCONV_MASK = os.path.join(DCN_DIR, 'mask_rcnn_r50_fpn_mdconv_c3-c5_1x_coco.py')
FCOS_DCN = os.path.join(ROOT, 'configs/fcos/fcos_center-normbbox-centeronreg-'
                        'giou_r50_caffe_fpn_gn-head_dcn_4x4_1x_coco.py')
SQUARE_HW = (800, 800)      # a COCO image of equal sides, resized
# (name, config, timed repeats of an image (None: no image), its canvas
# (None: the config's), timed steps (None: no step), an image's launches, a
# step's); K1, K3 and K5 run on none of them
ITEM7_CELLS = (
    ('dcn_mask_rcnn', os.path.join(DCN_DIR,
                                   'mask_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py'),
     1, None, 1, MASK_RCNN_INFER_COUNTS, MASK_RCNN_STEP_COUNTS),
    ('mdconv_mask_rcnn', MDCONV_MASK, 1, None, 1, MASK_RCNN_INFER_COUNTS,
     MASK_RCNN_STEP_COUNTS),
    ('mdconv_mask_rcnn_square', MDCONV_MASK, 1, SQUARE_HW, None,
     MASK_RCNN_INFER_COUNTS, None),
    ('mdconv_g4_faster', os.path.join(
        DCN_DIR, 'faster_rcnn_r50_fpn_mdconv_c3-c5_group4_1x_coco.py'),
     1, None, None, BOX_INFER_COUNTS, None),
    ('dcn_cascade_mask_rcnn', os.path.join(
        DCN_DIR, 'cascade_mask_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py'),
     1, None, 1, CASCADE_INFER, CASCADE_STEP),
    ('gcb_mask_rcnn', os.path.join(
        ROOT, 'configs/gcnet/mask_rcnn_r50_fpn_r16_gcb_c3-c5_1x_coco.py'),
     1, None, 1, MASK_RCNN_INFER_COUNTS, MASK_RCNN_STEP_COUNTS),
    ('groie_gcb', os.path.join(
        ROOT, 'configs/groie/mask_rcnn_r50_fpn_syncbn-backbone_r4_gcb_c3-c5_'
        'groie_1x_coco.py'), 1, None, None, MASK_RCNN_INFER_COUNTS, None),
    ('ga_1111_dcn_faster', os.path.join(
        ROOT, 'configs/empirical_attention/'
        'faster_rcnn_r50_fpn_attention_1111_dcn_1x_coco.py'),
     1, None, 1, BOX_INFER_COUNTS, BOX_STEP_COUNTS),
    ('fcos_dcn', FCOS_DCN, 1, None, 1, {}, {}),
    ('regnetx_3.2gf_mdconv', os.path.join(
        ROOT, 'configs/regnet/mask_rcnn_regnetx-3.2GF_fpn_mdconv_c3-c5_1x_'
        'coco.py'), 1, None, 1, MASK_RCNN_INFER_COUNTS,
     MASK_RCNN_STEP_COUNTS),
    ('htc_x101_dcn', os.path.join(
        ROOT, 'configs/htc/htc_x101_64x4d_fpn_dconv_c3-c5_mstrain_400_1400_'
        '16x1_20e_coco.py'), 1, None, None, HTC_INFER, None),
)
# the DCNv2 drives' forms on R50's c3-c5 (13 blocks) per forward: every
# block through the exact gather on 800x1344; on 800x800 the three strided
# first blocks so, the ten others in JAX's windowed form (3am)
DCN_FORMS = {'mdconv_mask_rcnn': (13, 0), 'mdconv_mask_rcnn_square': (3, 10)}
# the toys, two-stage (:func:`toy_cfg`, depth 50) and FCOS: the config and
# what the toy's backbone or head adds to it
ITEM7_TOYS = {
    'dcn_gcb': (os.path.join(
        ROOT, 'configs/gcnet/mask_rcnn_r50_fpn_r16_gcb_c3-c5_1x_coco.py'),
        dict(dcn=dict(type='DCN', deform_groups=1),
             stage_with_dcn=(False, True, True, True))),
    'mdcn4_ga': (MDCONV_MASK, dict(
        dcn=dict(type='DCNv2', deform_groups=4),
        plugins=[dict(cfg=dict(type='GeneralizedAttention', spatial_range=-1,
                               num_heads=8, attention_type='1111',
                               kv_stride=2),
                      stages=(False, False, True, True),
                      position='after_conv2')])),
}
# the plain DCN's timed stages: (stage, input channels, input H x W of a
# step's and an image's first block at 800x1344)
DCN_STAGES = (('layer2', 128, (200, 336)), ('layer3', 256, (100, 168)),
              ('layer4', 512, (50, 84)))


@contextlib.contextmanager
def counted_dcn_forms():
    """Counts the calls of the exact gather and of the windowed DCNv2 (the
    backbone's ``DeformConv2dPack`` looks them up at each call)."""
    import dynamask_torch.ops.deform_conv as dc
    counts = {'exact': 0, 'windowed': 0}
    exact, windowed = dc.deform_conv2d_exact, dc.modulated_deform_conv2d

    def cexact(*a, **k):
        counts['exact'] += 1
        return exact(*a, **k)

    def cwindowed(*a, **k):
        counts['windowed'] += 1
        return windowed(*a, **k)

    dc.deform_conv2d_exact, dc.modulated_deform_conv2d = cexact, cwindowed
    try:
        yield counts
    finally:
        dc.deform_conv2d_exact, dc.modulated_deform_conv2d = exact, windowed


def check_dcn_forms(report, name, counts, forms=None, section='item7'):
    """A drive's calls are whole forwards of ``forms`` (``DCN_FORMS[name]``
    by default): (exact-gather, windowed DCNv2) calls a forward; (0, 0)
    asks for none."""
    exact, windowed = forms or DCN_FORMS[name]
    per = exact + windowed
    n = (counts['exact'] + counts['windowed']) // per if per else 0
    if (per and n < 1) or (counts['exact'], counts['windowed']) != (
            exact * n, windowed * n):
        raise RuntimeError(f'{name}: DCN forms {counts}, expected '
                           f'{exact} exact and {windowed} windowed a forward')
    print(f'  {name}: {n} forwards, each {exact} exact-gather and '
          f'{windowed} windowed DCNs')
    report[section].setdefault('dcn_forms', {})[name] = dict(counts,
                                                             forwards=n)


def time_plain_dcn(report, card):
    """The plain exact-gather DCNv1 of R50's c3-c5 on the card, stage by
    stage, forward and forward + backward with CUDA events: a stage's
    strided first block and a stride-1 block, at a step's 4 images and an
    image's 1, 800x1344; then GA '1111' (8 heads, kv stride 2) at c4 and
    c5's widths and maps. These are plain PyTorch by design (the JAX
    package computes them in XLA): the lines are the case for a hand
    kernel, not kernel rows."""
    import torch
    from dynamask_torch.models.plugins import GeneralizedAttention
    from dynamask_torch.ops.deform_conv import deform_conv2d_exact
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    recs = []
    for images in (TRAIN_IMAGES, 1):
        for stage, c, (h, w) in DCN_STAGES:
            for stride in (2, 1):
                hi, wi = (h, w) if stride == 2 else (h // 2, w // 2)
                ho, wo = (hi - 1) // stride + 1, (wi - 1) // stride + 1
                x = torch.randn(images, hi, wi, c, generator=gen,
                                device=DEVICE, requires_grad=True)
                off = torch.randn(images, ho, wo, 18, generator=gen,
                                  device=DEVICE, requires_grad=True)
                wt = (torch.randn(3, 3, c, c, generator=gen, device=DEVICE)
                      / (9 * c) ** 0.5).requires_grad_()
                cot = torch.randn(images, ho, wo, c, generator=gen,
                                  device=DEVICE)

                def fwd():
                    with torch.no_grad():
                        deform_conv2d_exact(x, off, wt, None, 3, stride)

                def fwd_bwd():
                    out = deform_conv2d_exact(x, off, wt, None, 3, stride)
                    torch.autograd.grad((out * cot).sum(), (x, off, wt))

                torch.cuda.reset_peak_memory_stats(DEVICE)
                f_ms = cuda_ms(fwd, iters=3, warmup=1)
                fb_ms = cuda_ms(fwd_bwd, iters=3, warmup=1)
                peak = torch.cuda.max_memory_allocated(DEVICE)
                # the least time: the inputs read and the output written
                # once (the backward also reads the output's gradient and
                # writes each input's), the 9 taps' products (the
                # backward's two more) at the fp32 peak
                nbytes = _nbytes(x, off, wt, cot)
                ops = 2 * cot.numel() * 9 * c
                f_bound = bound_of(nbytes, {'fp32': ops})
                fb_bound = bound_of(2 * nbytes, {'fp32': 3 * ops})
                rec = dict(op='dcn_exact', stage=stage, images=images,
                           stride=stride, c=c, hw_in=[hi, wi],
                           fwd_ms=f_ms, fwd_bwd_ms=fb_ms, peak_bytes=peak,
                           fwd_bound=f_bound, fwd_bwd_bound=fb_bound)
                recs.append(rec)
                print(f'  plain dcn {stage} {images}x{hi}x{wi}x{c} stride '
                      f'{stride}: fwd {f_ms:.3f} ms (bound {f_bound[0]:.3f},'
                      f' {f_bound[1]}), fwd+bwd {fb_ms:.3f} ms (bound '
                      f'{fb_bound[0]:.3f}), peak {peak / 2 ** 30:.2f} GiB '
                      f'[{card}]')
                del x, off, wt, cot
        for stage, c, (h, w) in (('c4', 256, (50, 84)),
                                 ('c5', 512, (25, 42))):
            ga = GeneralizedAttention(c, num_heads=8, attention_type='1111',
                                      kv_stride=2).to(DEVICE)
            with torch.no_grad():
                for p in ga.parameters():
                    p.normal_(0, 0.05, generator=gen)
            x = torch.randn(images, c, h, w, generator=gen, device=DEVICE
                            ).contiguous(memory_format=torch.channels_last)
            x.requires_grad_()

            def ga_fwd():
                with torch.no_grad():
                    ga(x)

            def ga_fwd_bwd():
                ga(x).sum().backward()

            torch.cuda.reset_peak_memory_stats(DEVICE)
            f_ms = cuda_ms(ga_fwd, iters=3, warmup=1)
            fb_ms = cuda_ms(ga_fwd_bwd, iters=3, warmup=1)
            peak = torch.cuda.max_memory_allocated(DEVICE)
            recs.append(dict(op='generalized_attention_1111', stage=stage,
                             images=images, c=c, hw=[h, w], fwd_ms=f_ms,
                             fwd_bwd_ms=fb_ms, peak_bytes=peak))
            print(f'  plain GA 1111 {stage} {images}x{h}x{w}x{c}: fwd '
                  f'{f_ms:.3f} ms, fwd+bwd {fb_ms:.3f} ms, peak '
                  f'{peak / 2 ** 30:.2f} GiB [{card}]')
            del ga, x
    report['item7']['plain_ops'] = recs
    torch.cuda.empty_cache()


def item7_toy(kind):
    """The config of an item-7 toy: the Mask R-CNN toy of its config file
    at depth 50 (:func:`toy_cfg`) with the toy's backbone keys, or FCOS's
    DCN config at :func:`single_stage_toy`'s width."""
    if kind == 'fcos_dcn':
        cfg = single_stage_toy(kind, FCOS_DCN)
        assert cfg.model.bbox_head.dcn_on_last_conv
        return cfg
    return toy_cfg(kind)


def check_item7_toys(report):
    """Phase 16's toys on the card against the same weights on the CPU:
    the DCNv1 + GCB and the DCNv2 (4 groups) + GA '1111' Mask R-CNNs
    through phase 3's inference check (labels and validity equal, dets and
    mask probabilities within 1e-3) and phase 3's training step (each loss
    within TOY_LOSS_RTOL, every parameter's gradient within TOY_GRAD_RL2
    relative L2 or the CPU's own noise, the offset convs' among them);
    FCOS with ``dcn_on_last_conv`` at N(0, 0.05) through ``simple_test``
    and a training step's losses and gradients, as its single-stage
    siblings plus the gradients."""
    import copy
    import torch
    from dynamask_torch.models import build_detector
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(1, 128, 128, 3, generator=gen)
    batch = {'image': img, 'img_shape': torch.tensor([[128., 128.]]),
             'scale_factor': torch.ones(1, 4)}
    for kind in ITEM7_TOYS:
        cfg = item7_toy(kind)
        ref = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                             device='cpu', seed=0)
        model = copy.deepcopy(ref).to(DEVICE)
        a = ref.simple_test(batch)
        b = {k: v.cpu() for k, v in model.simple_test(
            {k: v.to(DEVICE) for k, v in batch.items()}).items()
            if torch.is_tensor(v)}
        errs = {k: (a[k].double() - b[k].double()).abs().max().item()
                for k in ('dets', 'mask_probs')}
        same = all(torch.equal(a[k], b[k]) for k in ('labels', 'det_valid'))
        print(f'  toy {kind}: {int(a["det_valid"].sum())} dets, GPU vs CPU '
              'max abs err ' + ', '.join(f'{k} {v:.3e}' for k, v in
                                          errs.items()) +
              f', labels/valid equal {same}')
        report['toy'].append(dict(model=f'item7_{kind}',
                                  same_labels_valid=same, **errs))
        if not (same and max(errs.values()) < 1e-3):
            raise RuntimeError(f'toy {kind}: GPU result disagrees with the '
                               'CPU reference')
        del ref, model
        check_toy_train_against_cpu(report, kind)
    check_dense_toy(report, 'fcos_dcn', item7_toy('fcos_dcn'), 4)


def check_dense_toy(report, name, cfg, n_offsets, noise=None,
                    step_dtype=None, hw=(96, 128), init_std=0.05,
                    prepare=None):
    """A dense-head toy (``cfg``) on the card against the CPU: built on the
    CPU with N(0, ``init_std``) weights from seed 0 (None: the JAX
    initialisers; ``prepare(model)``, given, then changes them) and copied
    to the card; two seeded images of ``hw`` (96x128) through
    ``simple_test`` (labels and validity
    equal, dets within TOY_DET_TOL) and a training step with ``noise``'s
    draws (each loss within TOY_LOSS_RTOL, every gradient within
    TOY_GRAD_RL2 relative L2 or the CPU's own noise; ``n_offsets`` offset
    conv tensors among them). With ``step_dtype=torch.float64`` the step
    runs in float64 on both (the model and the batch cast), held to
    TOY_LOSS_RTOL64 and TOY_GRAD_RL2_64: phase 19's toys, whose fp32
    gradients of the backbone's early BatchNorms part from their own
    float64 by up to 8.7e-3 relative L2 on the CPU (RepPoints)."""
    import copy
    import torch
    from dynamask_torch.apis import synthetic_batch
    from dynamask_torch.models import build_detector
    cpu = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                         device='cpu', seed=0, init_std=init_std)
    if prepare is not None:
        with torch.no_grad():
            prepare(cpu)
    gpu = copy.deepcopy(cpu).to(DEVICE)
    data = synthetic_batch(3, b=2, h=hw[0], w=hw[1], num_gts=4,
                           num_classes=8)
    data['scale_factor'] = torch.tensor([[1.0] * 4, [0.8] * 4])
    ref = cpu.simple_test(data)
    got = gpu.simple_test({k: v.to(DEVICE) for k, v in data.items()})
    err = (got['dets'].cpu() - ref['dets']).abs().max().item()
    if not all(torch.equal(got[k].cpu(), ref[k]) for k in (
            'labels', 'det_valid')) or err > TOY_DET_TOL or int(
            ref['det_valid'].sum()) < 4:
        raise RuntimeError(f'toy {name}: the card\'s dets differ from the '
                           f'CPU\'s (max abs err {err})')
    # the step's losses and gradients as phase 3's two-stage toys hold
    # them: the CPU on the card's side of each kink, each gradient within
    # TOY_GRAD_RL2 or TOY_GRAD_FLOOR times the CPU's own noise; the GN of
    # the 1x1 top level normalises single values, so the gradients that
    # reach the neck through it alone are zero in the math and rounding on
    # both devices: under TOY_GRAD_ZERO of the largest norm on both, they
    # are not compared
    noisy = dict(data, image=data['image'] * (1 + INPUT_NOISE * torch.randn(
        data['image'].shape, generator=torch.Generator().manual_seed(5))))
    loss_tol, grad_tol = TOY_LOSS_RTOL, TOY_GRAD_RL2
    if step_dtype is not None:
        loss_tol, grad_tol = TOY_LOSS_RTOL64, TOY_GRAD_RL2_64
        cpu, gpu = cpu.to(step_dtype), gpu.to(step_dtype)

    def cast(v, dev):
        return v.to(dev, step_dtype) if (
            step_dtype is not None and v.is_floating_point()) else v.to(dev)

    def step(net, batch):
        net.train().zero_grad(set_to_none=True)
        losses = net.forward_train(
            {k: cast(v, net.device) for k, v in batch.items()},
            {k: cast(v, net.device) for k, v in (noise or {}).items()})
        sum(v for k, v in losses.items() if 'loss' in k).backward()
        return ({k: float(v.detach()) for k, v in losses.items()},
                {k: p.grad.detach().cpu().double()
                 for k, p in net.named_parameters() if p.grad is not None})

    logs, grads, sides = {}, {}, KinkSides()
    with sides.patched(follow=False):
        logs['gpu'], grads['gpu'] = step(gpu, data)
    for run, batch in (('cpu', data), ('cpu_noisy', noisy)):
        with sides.patched(follow=True):
            logs[run], grads[run] = step(cpu, batch)
    rel = {k: abs(logs['gpu'][k] - v) / max(abs(v), 1e-12)
           for k, v in logs['cpu'].items()}

    def rel_l2(a, g):
        return ((a - g).norm() / g.norm()).item()

    zero = TOY_GRAD_ZERO * max(g.norm().item() for g in
                               grads['cpu'].values())
    rows = sorted((rel_l2(grads['gpu'][k], g) / max(
        grad_tol, TOY_GRAD_FLOOR * rel_l2(grads['cpu_noisy'][k], g)),
        rel_l2(grads['gpu'][k], g), k) for k, g in grads['cpu'].items()
        if max(g.norm().item(), grads['gpu'][k].norm().item()) > zero)
    offsets = {k: d for _, d, k in rows if 'conv_offset' in k}
    if (max(rel.values()) > loss_tol or rows[-1][0] > 1.0 or
            len(offsets) != n_offsets):
        raise RuntimeError(f'toy {name}: losses {rel}, worst gradient '
                           f'{rows[-1]}, offset convs {offsets}')
    prec = '' if step_dtype is None else ' (step in float64)'
    print(f'  toy {name}: {int(ref["det_valid"].sum())} valid dets, labels '
          f'and validity equal, dets max abs err {err:.3g} (tol '
          f'{TOY_DET_TOL}); losses{prec} max rel err '
          f'{max(rel.values()):.3g} (tol {loss_tol}); {len(rows)} gradients, '
          f'the nearest its tolerance {rows[-1][2]} {rows[-1][1]:.3g} '
          f'(max({grad_tol}, {TOY_GRAD_FLOOR} x CPU noise)), the offset '
          f'convs\' max {max(offsets.values(), default=0.0):.3g}; kink inputs '
          f'moved {sides.moved}')
    report['toy'].append(dict(toy=f'dense_{name}', dets_max_abs_err=err,
                              loss_rel_err=rel,
                              grad_rel_l2={k: d for _, d, k in rows}))




def run_item7(report, card):
    """Phase 16: the detectors on the backbones' deformable convs and
    block plugins, each from its config file, unchanged, at full width:
    an image at the config's test canvas (the DCNv2 Mask R-CNN also at
    800x800, where JAX's windowed form runs) with phase 4's weights
    protocol, and steps at its train batch from the JAX initialisation,
    each a counted warm-up held to its exact launches, then timed repeats;
    the plain DCN and GA timed by stage; the toys on the card against the
    CPU."""
    import torch
    from dynamask_torch.apis import config_shapes
    launches = {}
    report['item7'] = {'inference': [], 'train': []}
    for name, path, n_inf, hw, n_steps, infer, step in ITEM7_CELLS:
        test_hw, images, train_hw = config_shapes(path)
        if n_inf:
            with counted_dcn_forms() as forms:
                got, recs = run_config_inference(
                    report, card, name, path, hw or test_hw,
                    (('infer', None, infer),), repeats=n_inf)
            if name in DCN_FORMS:
                check_dcn_forms(report, name, forms)
            launches.update(got)
            report['item7']['inference'] += recs
        if n_steps:
            got, rec = run_config_train(report, card, name, path, images,
                                        train_hw, step, repeats=n_steps)
            launches.update(got)
            report['item7']['train'].append(rec)
        torch.cuda.empty_cache()
    time_plain_dcn(report, card)
    check_item7_toys(report)
    return launches


# -- phase 17: guided anchoring and DetectoRS (item 9's first entry, item 8)

K1, K3 = 'deform_im2col_windowed', 'deform_col2im_windowed'
GA_DIR = os.path.join(ROOT, 'configs/guided_anchoring')
DETECTORS_DIR = os.path.join(ROOT, 'configs/detectors')
# (name, config, timed repeats of an image, timed steps (None: no step), an
# image's launches, a step's, exact-gather calls a forward). K1 per
# windowed DCN forward: GA-RPN's one FeatureAdaption on each of P2-P6,
# GA-RetinaNet's two on each of P3-P7, the two branches of each of R50's 10
# stride-1 SAC blocks in layer2-4 (each backbone pass); a step recomputes
# K1 for the kernel's gradient and runs K3 once a DCN. The 3 strided SAC
# blocks' two branches take the exact gather (plain PyTorch); HTC with RFP
# alone builds SAC with plain branches (3aw)
ITEM9_CELLS = (
    ('ga_rpn', os.path.join(GA_DIR, 'ga_rpn_r50_fpn_1x_coco.py'), 2, 2,
     {K1: 5}, {K1: 10, K3: 5}, 0),
    ('ga_faster', os.path.join(GA_DIR, 'ga_faster_r50_fpn_1x_coco.py'), 2,
     2, {K1: 5, 'roi_align_fwd': 1},
     {K1: 10, K3: 5, 'roi_align_fwd': 1, 'roi_align_bwd': 1}, 0),
    ('ga_retinanet', os.path.join(GA_DIR, 'ga_retinanet_r50_fpn_1x_coco.py'),
     2, 2, {K1: 10}, {K1: 20, K3: 10}, 0),
    ('sac_cascade_rcnn', os.path.join(DETECTORS_DIR,
                                      'cascade_rcnn_r50_sac_1x_coco.py'),
     1, 1, {K1: 20, 'roi_align_fwd': 3},
     {K1: 40, K3: 20, 'roi_align_fwd': 3, 'roi_align_bwd': 3}, 6),
    ('detectors_htc', os.path.join(DETECTORS_DIR,
                                   'detectors_htc_r50_1x_coco.py'),
     1, None, {K1: 40, 'roi_align_fwd': 8}, None, 12),
    ('htc_rfp', os.path.join(DETECTORS_DIR, 'htc_r50_rfp_1x_coco.py'), 1,
     None, {'roi_align_fwd': 8}, None, 0),
)


def check_item9_toys(report):
    """Phase 17's toys on the card against the same weights on the CPU:
    the GA-Faster R-CNN and the DetectoRS Cascade Mask R-CNN (SAC + RFP)
    toys through phase 3's inference check and training step (their
    ``FeatureAdaption`` and SAC offset convs off zero, so K3's offset
    gradient is exercised, and among the gradients compared), and a
    GA-RetinaNet toy at :func:`single_stage_toy`'s width (dets, losses and
    every gradient, its two offset convs' among them) with the shape
    sampler's draws given."""
    import copy
    import numpy as np
    import torch
    from dynamask_torch.models import build_detector
    gen = torch.Generator().manual_seed(1)
    batch = {'image': torch.randn(1, 128, 128, 3, generator=gen),
             'img_shape': torch.tensor([[128., 128.]]),
             'scale_factor': torch.ones(1, 4)}
    for kind in ITEM9_TWO_STAGE_TOYS:
        cfg = toy_cfg(kind)
        ref = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                             device='cpu', seed=0)
        model = copy.deepcopy(ref).to(DEVICE)
        a = ref.simple_test(batch)
        b = {k: v.cpu() for k, v in model.simple_test(
            {k: v.to(DEVICE) for k, v in batch.items()}).items()
            if torch.is_tensor(v)}
        errs = {k: (a[k].double() - b[k].double()).abs().max().item()
                for k in ('dets', 'mask_probs') if k in a}
        same = all(torch.equal(a[k], b[k]) for k in ('labels', 'det_valid'))
        print(f'  toy {kind}: {int(a["det_valid"].sum())} dets, GPU vs CPU '
              'max abs err ' + ', '.join(f'{k} {v:.3e}' for k, v in
                                          errs.items()) +
              f', labels/valid equal {same}')
        report['toy'].append(dict(model=f'item9_{kind}',
                                  same_labels_valid=same, **errs))
        if not (same and max(errs.values()) < 1e-3):
            raise RuntimeError(f'toy {kind}: GPU result disagrees with the '
                               'CPU reference')
        del ref, model
        check_toy_train_against_cpu(report, kind)
    cfg = single_stage_toy('ga_retinanet', os.path.join(
        GA_DIR, 'ga_retinanet_r50_fpn_1x_coco.py'))
    squares = sum(-(-96 // s) * -(-128 // s) for s in (8, 16, 32, 64, 128))
    rng = np.random.RandomState(6)
    noise = {k: torch.from_numpy(rng.uniform(size=(2, squares)).astype(
        np.float32)) for k in ('ga_pos', 'ga_neg')}
    check_dense_toy(report, 'ga_retinanet', cfg, 2, noise)


def run_item9(report, card):
    """Phase 17: guided anchoring's and DetectoRS' detectors from their
    config files, unchanged, at full width: an image at the config's test
    canvas with phase 4's weights protocol and steps at its train batch
    from the JAX initialisation, each a counted warm-up held to its exact
    launches of every kernel and to its exact-gather calls, then timed
    repeats; then the toys on the card against the CPU."""
    import torch
    from dynamask_torch.apis import config_shapes
    launches = {}
    report['item9'] = {'inference': [], 'train': []}
    for name, path, n_inf, n_steps, infer, step, exact in ITEM9_CELLS:
        test_hw, images, train_hw = config_shapes(path)
        with counted_dcn_forms() as forms:
            got, recs = run_config_inference(
                report, card, name, path, test_hw, (('infer', None, infer),),
                repeats=n_inf)
        check_dcn_forms(report, f'{name}_infer', forms, (exact, 0), 'item9')
        launches.update(got)
        report['item9']['inference'] += recs
        if n_steps:
            with counted_dcn_forms() as forms:
                got, rec = run_config_train(report, card, name, path, images,
                                            train_hw, step, repeats=n_steps)
            check_dcn_forms(report, f'{name}_train', forms, (exact, 0),
                            'item9')
            launches.update(got)
            report['item9']['train'].append(rec)
        torch.cuda.empty_cache()
    check_item9_toys(report)
    return launches


# -- phase 18: item 9's two-stage heads ---------------------------------------

ROI_FWD, ROI_BWD = 'roi_align_fwd', 'roi_align_bwd'
# (name, config, timed repeats of an image, timed steps, an image's
# launches, a step's). K2 an image: the box extract and the head's crop of
# the dets (PointRefine's 14x14 mask extract, PointRend's coarse crop of P2
# alone, Grid R-CNN's 14x14 grid extract, all-level under GRoIE's box
# extractor), and Mask Scoring R-CNN's mask extract twice (its MaskIoU
# head crops the mask features again); a step: the box extract and the
# head's crop of the positives (Grid R-CNN's second sample, jittered),
# each with K4 for its gradient; Dynamic R-CNN the box extract alone. No
# DCN on these paths.
HEAD_CELLS = (
    ('point_refine', TOY_CONFIGS['point_refine'], 2, 2, {ROI_FWD: 2},
     {ROI_FWD: 2, ROI_BWD: 2}),
    ('point_rend', TOY_CONFIGS['point_rend'], 2, 2, {ROI_FWD: 2},
     {ROI_FWD: 2, ROI_BWD: 2}),
    ('ms_rcnn', TOY_CONFIGS['ms_rcnn'], 2, 2, {ROI_FWD: 3},
     {ROI_FWD: 2, ROI_BWD: 2}),
    ('grid_rcnn', TOY_CONFIGS['grid_rcnn'], 2, 2, {ROI_FWD: 2},
     {ROI_FWD: 2, ROI_BWD: 2}),
    ('grid_rcnn_groie', os.path.join(
        ROOT, 'configs/groie/grid_rcnn_r50_fpn_gn-head_groie_1x_coco.py'), 1,
     1, {ROI_FWD: 2}, {ROI_FWD: 2, ROI_BWD: 2}),
    ('dynamic_rcnn', TOY_CONFIGS['dynamic_rcnn'], 2, 2, {ROI_FWD: 1},
     {ROI_FWD: 1, ROI_BWD: 1}),
)
# the toys' mask probabilities, card against CPU, on every valid det's
# pixel: the CPU run takes the card's side of each top-k tie and ReLU kink
# within rounding (:class:`KinkSides`); they agreed within 9.4e-6 on an
# H100 (PERF.md, phase 18), and dets are held at 1e-3
HEAD_TOY_MASK_TOL = 1e-4


def check_head_toys(report):
    """Phase 18's toys on the card against the same weights on the CPU:
    ``simple_test`` (dets, labels and validity; the valid dets' mask
    probabilities; Mask Scoring R-CNN's ``segm_scores``), the CPU run on
    the card run's side of each kink (the point heads' top-k ties, the
    ReLUs; :class:`KinkSides`), then phase 3's
    training step of each (losses and every gradient, with and without
    cuDNN), the draws of PointRend's points and of Grid R-CNN's second
    sampling and jitter given."""
    import copy
    import torch
    from dynamask_torch.models import build_detector
    gen = torch.Generator().manual_seed(1)
    batch = {'image': torch.randn(1, 128, 128, 3, generator=gen),
             'img_shape': torch.tensor([[128., 128.]]),
             'scale_factor': torch.ones(1, 4)}
    for kind in HEAD_TOYS:
        cfg = toy_cfg(kind)
        ref = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                             device='cpu', seed=0)
        model = copy.deepcopy(ref).to(DEVICE)
        sides = KinkSides()
        with torch.no_grad():
            with sides.patched(follow=False):
                b = {k: v.cpu() for k, v in model.simple_test(
                    {k: v.to(DEVICE) for k, v in batch.items()}).items()}
            with sides.patched(follow=True):
                a = ref.simple_test(batch)
        same = all(torch.equal(a[k], b[k]) for k in ('labels', 'det_valid'))
        valid = a['det_valid'].bool()
        errs = {k: (a[k].double() - b[k].double())[valid].abs().max().item()
                for k in ('dets', 'segm_scores', 'mask_probs') if k in a}
        masks_agree = errs.get('mask_probs', 0.0) < HEAD_TOY_MASK_TOL
        print(f'  toy {kind}: {int(valid.sum())} dets, GPU vs CPU max abs '
              'err ' + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()) +
              f' (masks under {HEAD_TOY_MASK_TOL}), labels/valid equal '
              f'{same}; top-k rows and ReLU inputs put on the GPU run\'s '
              f'side of a tie: {sides.moved}')
        report['toy'].append(dict(model=f'heads_{kind}',
                                  same_labels_valid=same,
                                  kink_inputs_moved=sides.moved, **errs))
        box_errs = [v for k, v in errs.items() if k != 'mask_probs']
        if not (same and int(valid.sum()) > 0 and masks_agree and
                max(box_errs) < 1e-3):
            raise RuntimeError(f'toy {kind}: GPU result disagrees with the '
                               'CPU reference')
        del ref, model
        check_toy_train_against_cpu(report, kind)


def run_item9_heads(report, card):
    """Phase 18: item 9's two-stage heads from their config files,
    unchanged, at full width: an image at the config's test canvas with
    phase 4's weights protocol and steps at its train batch from the JAX
    initialisation (PointRefine's with ``gt_semantic``), each a counted
    warm-up held to its exact launches of every kernel, then timed
    repeats; then the toys on the card against the CPU."""
    import torch
    from dynamask_torch.apis import config_shapes
    launches = {}
    report['heads'] = {'inference': [], 'train': []}
    for name, path, n_inf, n_steps, infer, step in HEAD_CELLS:
        test_hw, images, train_hw = config_shapes(path)
        got, recs = run_config_inference(
            report, card, name, path, test_hw, (('infer', None, infer),),
            repeats=n_inf)
        launches.update(got)
        report['heads']['inference'] += recs
        got, rec = run_config_train(report, card, name, path, images,
                                    train_hw, step, repeats=n_steps)
        launches.update(got)
        report['heads']['train'].append(rec)
        torch.cuda.empty_cache()
    check_head_toys(report)
    return launches


# -- phase 19: item 6's FPN dense detectors -----------------------------------

GFL_CONFIG = os.path.join(ROOT, 'configs/gfl/gfl_r50_fpn_1x_coco.py')
ITEM6_CONFIGS = {
    'gfl': GFL_CONFIG,
    'fsaf': os.path.join(ROOT, 'configs/fsaf/fsaf_r50_fpn_1x_coco.py'),
    'fovea': os.path.join(ROOT,
                          'configs/foveabox/fovea_r50_fpn_4x4_1x_coco.py'),
    'fovea_align': os.path.join(
        ROOT, 'configs/foveabox/fovea_align_r50_fpn_gn-head_4x4_2x_coco.py'),
    'reppoints': os.path.join(
        ROOT, 'configs/reppoints/reppoints_moment_r50_fpn_gn-neck+head_1x_'
        'coco.py'),
    'reppoints_grid': os.path.join(
        ROOT, 'configs/reppoints/bbox_r50_grid_fpn_gn-neck+head_1x_coco.py'),
    'nas_fcos': os.path.join(
        ROOT, 'configs/nas_fcos/nas_fcos_nashead_r50_caffe_fpn_gn-head_4x4_'
        '1x_coco.py'),
}
# (name, timed repeats of an image, timed steps (None: no step), the
# exact-gather and the windowed DCNs a forward): FoveaBox's FeatureAlign a
# level (5), RepPoints' two DCNs a level (10), NAS-FCOS' two DCNv2s in each
# tower a level (20). No hand kernel runs on these paths: each drive holds
# K1-K5 and their bf16 instances at 0 launches.
ITEM6_CELLS = (
    ('gfl', 1, 1, 0, 0),
    ('fsaf', 1, 1, 0, 0),
    ('fovea', 1, 1, 0, 0),
    ('fovea_align', 1, 1, 5, 0),
    ('reppoints', 1, 1, 10, 0),
    ('reppoints_grid', 1, None, 10, 0),
    ('nas_fcos', 1, 1, 0, 20),
)
# the toys on the card against the CPU, and the offset convs among each
# one's gradients (the align head's FeatureAlign; NAS-FCOS' four DCNv2s,
# weight and bias)
ITEM6_TOYS = {'gfl': 0, 'fsaf': 0, 'fovea_align': 1, 'reppoints': 0,
              'nas_fcos': 8}


def counted_item6_forms(name):
    """The (exact-gather, windowed) DCNs a forward of ``name``'s detector,
    counted from the built model: FoveaBox's FeatureAlign and RepPoints'
    ``DeformConv2d`` s each run once a level, NAS-FCOS' DCNv2s once a level
    each, over the 5 levels; held against ``ITEM6_CELLS``."""
    from dynamask_torch.models import build_detector
    from dynamask_torch.models.layers import DeformConv2d
    from dynamask_torch.models.nasfcos import ModulatedDeformConv2dPack
    from dynamask_torch.utils import Config
    cfg = Config.fromfile(ITEM6_CONFIGS[name])
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                           device='meta')
    mods = list(model.bbox_head.modules())
    n = len(ITEM6_LEVELS)
    return (n * sum(isinstance(m, DeformConv2d) for m in mods),
            n * sum(isinstance(m, ModulatedDeformConv2dPack) for m in mods))


def item6_toy(kind):
    """The config of an item-6 toy at :func:`single_stage_toy`'s width
    (NAS-FCOS' searched head keeps its four ops, RepPoints' point features
    32 channels)."""
    cfg = single_stage_toy(kind, ITEM6_CONFIGS[kind])
    if kind == 'nas_fcos':
        cfg.model.bbox_head.pop('stacked_convs')
    if kind.startswith('reppoints'):
        cfg.model.bbox_head.point_feat_channels = 32
    return cfg


# the FPN levels P3-P7 at 800x1344
ITEM6_LEVELS = ((100, 168), (50, 84), (25, 42), (13, 21), (7, 11))
# (form, deform groups, offsets' half-range in pixels, modulated): the
# align FoveaBox's FeatureAlign, RepPoints' point DCNs (offsets of a few
# strides), NAS-FCOS' windowed DCNv2 (its +-3 window)
ITEM6_DCNS = (('fovea_align', 4, 4.0, False), ('reppoints', 1, 12.0, False),
              ('nas_fcos', 2, 3.0, True))


def time_item6_dcns(report, card):
    """The plain DCNs of phase 19's heads on the card, level by level (P3-P7
    at 800x1344, 256 channels in and out), forward and forward + backward
    with CUDA events, at a step's 4 images and an image's 1: the
    exact gather of FoveaBox's FeatureAlign (4 groups) and of RepPoints
    (offsets past any window, most samples off the plane), NAS-FCOS' windowed
    DCNv2 (2 groups). Plain PyTorch by design (XLA in the JAX package):
    the lines are ROADMAP.md S13's case for a hand kernel, not kernel
    rows."""
    import torch
    from dynamask_torch.ops.deform_conv import (deform_conv2d_exact,
                                                modulated_deform_conv2d)
    gen = torch.Generator(device=DEVICE).manual_seed(19)
    recs, c = [], 256
    for form, g, amp, modulated in ITEM6_DCNS:
        for images in (TRAIN_IMAGES, 1):
            totals = [0.0, 0.0]
            for h, w in ITEM6_LEVELS:
                x = torch.randn(images, h, w, c, generator=gen, device=DEVICE,
                                requires_grad=True)
                off = ((torch.rand(images, h, w, 18 * g, generator=gen,
                                   device=DEVICE) * 2 - 1) *
                       amp).requires_grad_()
                mask = torch.rand(images, h, w, 9 * g, generator=gen,
                                  device=DEVICE, requires_grad=True)
                wt = (torch.randn(3, 3, c, c, generator=gen, device=DEVICE)
                      / (9 * c) ** 0.5).requires_grad_()
                cot = torch.randn(images, h, w, c, generator=gen,
                                  device=DEVICE)
                if modulated:
                    def call():
                        return modulated_deform_conv2d(x, off, mask, wt, 3,
                                                       1, 1, g)
                    inputs = (x, off, mask, wt)
                else:
                    def call():
                        return deform_conv2d_exact(x, off, wt, None, 3, 1, 1,
                                                   1, g)
                    inputs = (x, off, wt)

                def fwd():
                    with torch.no_grad():
                        call()

                def fwd_bwd():
                    torch.autograd.grad((call() * cot).sum(), inputs)

                torch.cuda.reset_peak_memory_stats(DEVICE)
                f_ms = cuda_ms(fwd, iters=3, warmup=1)
                fb_ms = cuda_ms(fwd_bwd, iters=3, warmup=1)
                peak = torch.cuda.max_memory_allocated(DEVICE)
                nbytes = _nbytes(*inputs, cot)
                ops = 2 * cot.numel() * 9 * c
                f_bound = bound_of(nbytes, {'fp32': ops})
                fb_bound = bound_of(2 * nbytes, {'fp32': 3 * ops})
                totals[0] += f_ms
                totals[1] += fb_ms
                recs.append(dict(op=form, images=images, hw=[h, w], c=c,
                                 groups=g, fwd_ms=f_ms, fwd_bwd_ms=fb_ms,
                                 peak_bytes=peak, fwd_bound=f_bound,
                                 fwd_bwd_bound=fb_bound))
                print(f'  plain dcn {form} {images}x{h}x{w}x{c} g {g}: fwd '
                      f'{f_ms:.3f} ms (bound {f_bound[0]:.3f}, '
                      f'{f_bound[1]}), fwd+bwd {fb_ms:.3f} ms (bound '
                      f'{fb_bound[0]:.3f}), peak {peak / 2 ** 30:.2f} GiB '
                      f'[{card}]')
                del x, off, mask, wt, cot, inputs
            print(f'  plain dcn {form} x{images}, P3-P7: fwd {totals[0]:.3f} '
                  f'ms, fwd+bwd {totals[1]:.3f} ms [{card}]')
            torch.cuda.empty_cache()
    report['item6']['plain_dcn'] = recs


def run_item6(report, card):
    """Phase 19: item 6's FPN dense detectors (GFL, FSAF, FoveaBox and its
    align form, RepPoints and its grid form, NAS-FCOS with its searched
    head), each from its config file, unchanged, at full width: an image at
    the config's test canvas with phase 4's weights protocol and steps at
    its train batch (20 GTs an image) from the JAX initialisation, each a
    counted warm-up held to 0 launches of every kernel and to its exact
    DCN forms, then a timed repeat (their device-busy shares stand in
    PERF.md); then GFL through phase 6's eval drive, the plain DCNs
    timed by level, and the toys on the card against the CPU."""
    import torch
    from dynamask_torch.apis import config_shapes
    launches = {}
    report['item6'] = {'inference': [], 'train': []}
    for name, n_inf, n_steps, exact, windowed in ITEM6_CELLS:
        forms = (exact, windowed)
        if counted_item6_forms(name) != forms:
            raise RuntimeError(f'{name}: the model runs '
                               f'{counted_item6_forms(name)} DCNs a forward, '
                               f'the table says {forms}')
        path = ITEM6_CONFIGS[name]
        test_hw, images, train_hw = config_shapes(path)
        with counted_dcn_forms() as counts:
            got, recs = run_config_inference(
                report, card, name, path, test_hw, (('infer', None, {}),),
                repeats=n_inf)
        check_dcn_forms(report, f'{name}_infer', counts, forms, 'item6')
        launches.update(got)
        report['item6']['inference'] += recs
        if n_steps:
            with counted_dcn_forms() as counts:
                got, rec = run_config_train(report, card, name, path, images,
                                            train_hw, {}, repeats=n_steps)
            check_dcn_forms(report, f'{name}_train', counts, forms, 'item6')
            launches.update(got)
            report['item6']['train'].append(rec)
        torch.cuda.empty_cache()
    launches.update(run_gfl_eval(report, card))
    time_item6_dcns(report, card)
    for kind, n_offsets in ITEM6_TOYS.items():
        check_dense_toy(report, kind, item6_toy(kind), n_offsets,
                        step_dtype=torch.float64)
    return launches


def run_gfl_eval(report, card):
    """Phase 19, GFL's evaluation drive: phase 6's seeded COCO set through
    the config's test pipeline, its loader workers and
    ``single_device_test`` (N(0, 0.05) weights from seed 0), the ms/img
    split of phase 11, every kernel at 0; bbox AP, and the GTs as
    predictions must score exactly 1.0."""
    from dynamask_torch.utils import Config
    ann_file, img_dir, n_gts = write_coco_set(COCO_SET)
    cfg = Config.fromfile(GFL_CONFIG)
    cfg.data.test.update(ann_file=ann_file, img_prefix=img_dir,
                         data_root=None)
    dataset, results, launches, t_test = run_box_eval(
        report, card, 'gfl', cfg, {}, init_std=0.05)
    metrics = dataset.evaluate(results, metric=['bbox'])
    gt = dataset.evaluate(gt_boxes_as_results(dataset), metric=['bbox'])
    if gt['bbox_mAP'] != 1.0:
        raise RuntimeError(f'gfl_eval: the GTs as predictions give {gt}')
    n = len(dataset)
    n_valid = sum(int(r['valid'].sum()) for r in results)
    print(f'  gfl_eval: {n} images, {n_gts} GTs; run_test {t_test:.1f} s '
          f'({n / t_test:.2f} img/s with {cfg.data.workers_per_gpu} loader '
          f'workers started) [{card}]; {n_valid} valid dets; bbox_mAP '
          f'{metrics["bbox_mAP"]:.4f} (random weights), the GTs as '
          f'predictions {gt["bbox_mAP"]}; launches {launches["gfl_eval"]}')
    report['item6']['eval'] = dict(images=n, run_test_s=t_test,
                                   valid_dets=n_valid, metrics=metrics,
                                   gt_as_predictions=gt,
                                   launches=launches['gfl_eval'])
    return launches


# -- phase 20: SSD, PISA, Libra R-CNN and NAS-FPN -----------------------------

ITEM20_CONFIGS = {name: os.path.join(ROOT, path) for name, path in {
    'ssd300': 'configs/ssd/ssd300_coco.py',
    'pisa_ssd300': 'configs/pisa/pisa_ssd300_coco.py',
    'pisa_faster_rcnn': 'configs/pisa/pisa_faster_rcnn_r50_fpn_1x_coco.py',
    'pisa_mask_rcnn': 'configs/pisa/pisa_mask_rcnn_r50_fpn_1x_coco.py',
    'pisa_mask_rcnn_x101':
        'configs/pisa/pisa_mask_rcnn_x101_32x4d_fpn_1x_coco.py',
    'pisa_retinanet': 'configs/pisa/pisa_retinanet_r50_fpn_1x_coco.py',
    'libra_faster_rcnn':
        'configs/libra_rcnn/libra_faster_rcnn_r50_fpn_1x_coco.py',
    'libra_fast_rcnn': 'configs/libra_rcnn/libra_fast_rcnn_r50_fpn_1x_coco.py',
    'libra_retinanet': 'configs/libra_rcnn/libra_retinanet_r50_fpn_1x_coco.py',
    'nas_fpn': 'configs/nas_fpn/retinanet_r50_nasfpn_crop640_50e_coco.py',
}.items()}
SSD_HW = (300, 300)          # SSD300's canvas, an image's and a step's
# the COCO-scale canvases nearest 800x1344 on which JAX's BFP is defined
# (ROADMAP.md queue 3, 3bj): P2-P6 at 768x1344, P3-P7 at 768x1280
LIBRA_HW = (768, 1344)
LIBRA_RETINA_HW = (768, 1280)
# (name, an image's canvas, a step's canvas or None, an image's launches, a
# step's). PISA's RoI head: K2 an image (the box crop of its proposals, and
# Mask R-CNN's mask crop); a step: the Score-HLR pass over every candidate
# (K2, no K4), then the sampled box crop and the mask crop (K2 + K4 each).
# Libra's box crop reads the BFP pyramid. SSD, the RetinaNets and NAS-FPN
# run no hand kernel: every count 0.
ITEM20_CELLS = (
    ('ssd300', SSD_HW, SSD_HW, {}, {}),
    ('pisa_ssd300', SSD_HW, SSD_HW, {}, {}),
    ('pisa_faster_rcnn', IMAGE_HW, IMAGE_HW, {ROI_FWD: 1},
     {ROI_FWD: 2, ROI_BWD: 1}),
    ('pisa_mask_rcnn', IMAGE_HW, IMAGE_HW, {ROI_FWD: 2},
     {ROI_FWD: 3, ROI_BWD: 2}),
    ('pisa_mask_rcnn_x101', IMAGE_HW, None, {ROI_FWD: 2}, None),
    ('pisa_retinanet', IMAGE_HW, IMAGE_HW, {}, {}),
    ('libra_faster_rcnn', LIBRA_HW, LIBRA_HW, {ROI_FWD: 1},
     {ROI_FWD: 1, ROI_BWD: 1}),
    ('libra_retinanet', LIBRA_RETINA_HW, LIBRA_RETINA_HW, {}, {}),
    ('nas_fpn', CROP640_HW, CROP640_HW, {}, {}),
)
LIBRA_FAST_COUNTS = ({ROI_FWD: 1}, {ROI_FWD: 1, ROI_BWD: 1})
FAST_PROPOSALS = (1000, 2000)   # an image's test proposals, a step's
# the toys on the card against the CPU: (kind, canvas) of the dense ones,
# their steps in float64; the two-stage ones (phase 3's fp32 step: K2/K4
# take fp32 and bf16, not float64). The dense ones take the JAX
# initialisers and then ``TOY_HEADS[kind]``: N(0, 0.05) weights leave
# their logits to the biases, every location's scores within rounding of
# each other (fp32 and float64 on the CPU part by 8.0 on a NAS-FPN det),
# and from the JAX init SSD's softmax saturates (scores of 0.99998-0.99999,
# 132.7 apart) and NAS-FPN's prior bias leaves no det over the threshold;
# after these the two part by 4.4e-5 and 1.1e-5
ITEM20_DENSE_TOYS = (('ssd300', SSD_HW), ('nas_fpn', (128, 128)))
ITEM20_TWO_STAGE_TOYS = ('pisa_mask_rcnn', 'libra_faster_rcnn')


def range_split(fn, names):
    """One call of ``fn`` under ``torch.profiler``: per ``record_function``
    range of ``names``, the host ms it spans (its CPU events' durations
    summed) and the device ms busy inside those spans (the union of kernel
    and copy intervals clipped to them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(DEVICE)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(DEVICE)
    events = prof.events()
    cpu_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA and e.name not in
                   cpu_names and not getattr(e, 'is_user_annotation', False))
    out = {}
    for name in names:
        windows = [(e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CPU and e.name == name]
        busy = 0.0
        for lo, hi in windows:
            end = lo
            for s, t in spans:
                s, t = max(s, end), min(t, hi)
                if t > s:
                    busy += t - s
                    end = t
        out[name] = dict(host_ms=sum(hi - lo for lo, hi in windows) / 1e3,
                         device_ms=busy / 1e3, calls=len(windows))
    return out


def check_bfp_3bj(report, card):
    """Libra Faster R-CNN on the 800x1344 canvas: JAX's BFP cannot resize
    its P6 (13x21) to the gather size (50x84) by whole-number ratios and
    fails; the port raises the ValueError naming 3bj (ROADMAP.md queue
    3), which this check requires."""
    import torch
    from dynamask_torch.apis import inference_detector, init_detector
    model = init_detector(ITEM20_CONFIGS['libra_faster_rcnn'],
                          device=DEVICE, seed=0, init_std=0.05)
    h, w = IMAGE_HW
    batch = {'image': torch.zeros(1, h, w, 3, device=DEVICE),
             'img_shape': torch.tensor([[h, w]], dtype=torch.float32,
                                       device=DEVICE),
             'scale_factor': torch.ones(1, 4, device=DEVICE)}
    try:
        inference_detector(model, batch)
    except ValueError as e:
        if '3bj' not in str(e):
            raise
        print(f'  libra_faster_rcnn at {h}x{w}: raises the 3bj error, as '
              f'required: {e} [{card}]')
        report['item20']['bfp_3bj'] = str(e)
        return
    finally:
        del model
        torch.cuda.empty_cache()
    raise RuntimeError(f'libra_faster_rcnn at {h}x{w}: no 3bj error')


def run_pisa_sampler_split(report, card):
    """PISA Faster R-CNN's step, profiled once more: the host ms and the
    device ms inside its ``score_hlr`` range (the no-grad box forward over
    every candidate) and its ``sampler`` range (the assignment and the
    Score-HLR sampling of each image, ``nms_match`` among them, whose
    greedy keep reads a flag back once per fixpoint iteration)."""
    import torch
    from dynamask_torch.apis import init_trainer, synthetic_batch, train_steps
    model, opt = init_trainer(ITEM20_CONFIGS['pisa_faster_rcnn'],
                              steps_per_epoch=COCO_STEPS_PER_EPOCH,
                              device=DEVICE, seed=0)
    h, w = IMAGE_HW
    batch = synthetic_batch(0, b=TRAIN_IMAGES, h=h, w=w, num_gts=TRAIN_GTS,
                            crop_size=128, num_classes=80, device='cpu')
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    train_steps(model, opt, [batch], generator=gen)
    split = range_split(lambda: train_steps(model, opt, [batch],
                                            generator=gen),
                        ('score_hlr', 'sampler', 'forward_train'))
    s, hlr, step = split['sampler'], split['score_hlr'], split[
        'forward_train']
    print(f'  pisa_faster_rcnn step, profiled: sampler (assign + Score-HLR '
          f'of {s["calls"]} images) host {s["host_ms"]:.1f} ms, device '
          f'{s["device_ms"]:.1f} ms; score_hlr pass host {hlr["host_ms"]:.1f}'
          f' ms, device {hlr["device_ms"]:.1f} ms; forward_train host '
          f'{step["host_ms"]:.1f} ms, device {step["device_ms"]:.1f} ms '
          f'[{card}]')
    report['item20']['pisa_sampler'] = split
    del model, opt
    torch.cuda.empty_cache()


def fast_proposals(gen, n, images, hw):
    """(B, n, 4) proposals and their validity: per image random boxes of
    5-40% of the side (the last tenth invalid padding)."""
    import torch
    h, w = hw
    xy = torch.rand(images, n, 2, generator=gen, device=DEVICE) * \
        torch.tensor([w, h], device=DEVICE)
    wh = (0.05 + 0.35 * torch.rand(images, n, 2, generator=gen,
                                   device=DEVICE)) * min(h, w)
    lim = torch.tensor([w, h, w, h], device=DEVICE)
    boxes = torch.minimum(torch.cat([xy, xy + wh], -1), lim)
    valid = torch.arange(n, device=DEVICE) < n - n // 10
    return boxes, valid.expand(images, n).contiguous()


def run_libra_fast(report, card):
    """Libra Fast R-CNN from its file at full width on proposals from the
    batch (phase 11's workflow, without the RPN): an image of 1000
    proposals at 768x1344 (N(0, 0.05) weights) and a step of 4 images
    with 2000 each (the JAX initialisation), each a counted warm-up held
    to its exact launches and a timed repeat, with the device-busy
    share."""
    import torch
    import dynamask_torch.ops as ops
    from dynamask_torch.apis import (init_detector, init_trainer,
                                     synthetic_batch, train_steps)
    infer_counts, step_counts = LIBRA_FAST_COUNTS
    path = ITEM20_CONFIGS['libra_fast_rcnn']
    model = init_detector(path, device=DEVICE, seed=0, init_std=0.05)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    h, w = LIBRA_HW
    props, valid = fast_proposals(gen, FAST_PROPOSALS[0], 1, LIBRA_HW)
    batch = {'image': torch.randn(1, h, w, 3, generator=gen, device=DEVICE),
             'img_shape': torch.tensor([[h, w]], dtype=torch.float32,
                                       device=DEVICE),
             'scale_factor': torch.ones(1, 4, device=DEVICE),
             'proposals': props, 'proposal_valid': valid}

    def image():
        with torch.no_grad():
            out = model.simple_test(batch)
        torch.cuda.synchronize(DEVICE)
        return out

    launches = {}
    ops.reset_kernel_launches()
    out = image()
    launches['libra_fast_rcnn_infer'] = ops.kernel_launches()
    check_exact_launches('libra_fast_rcnn_infer',
                         launches['libra_fast_rcnn_infer'], infer_counts)
    if not torch.isfinite(out['dets']).all():
        raise RuntimeError('libra_fast_rcnn_infer: non-finite dets')
    t = time.perf_counter()
    image()
    ms = 1e3 * (time.perf_counter() - t)
    busy = device_busy(image)
    print(f'  libra_fast_rcnn_infer: {ms:.1f} ms/img, {FAST_PROPOSALS[0]} '
          f'proposals at {h}x{w} [{card}]; {int(out["det_valid"].sum())} '
          f'valid dets; {busy_text(busy)}')
    rec = dict(config='libra_fast_rcnn', ms_per_img=ms, busy=busy)
    del model
    model, opt = init_trainer(path, steps_per_epoch=COCO_STEPS_PER_EPOCH,
                              device=DEVICE, seed=0)
    step_batch = synthetic_batch(0, b=TRAIN_IMAGES, h=h, w=w,
                                 num_gts=TRAIN_GTS, crop_size=128,
                                 num_classes=80, device='cpu')
    props, valid = fast_proposals(gen, FAST_PROPOSALS[1], TRAIN_IMAGES,
                                  LIBRA_HW)
    step_batch.update(proposals=props.cpu(), proposal_valid=valid.cpu())
    ops.reset_kernel_launches()
    times = []
    for _ in range(2):
        t = time.perf_counter()
        log, = train_steps(model, opt, [step_batch], generator=gen)
        torch.cuda.synchronize(DEVICE)
        times.append(1e3 * (time.perf_counter() - t))
        if not all(math.isfinite(float(v)) for v in log.values()):
            raise RuntimeError(f'libra_fast_rcnn_train: {log}')
    launches['libra_fast_rcnn_train'] = ops.kernel_launches()
    check_exact_launches('libra_fast_rcnn_train',
                         launches['libra_fast_rcnn_train'], step_counts, 2)
    busy = device_busy(lambda: train_steps(model, opt, [step_batch],
                                           generator=gen))
    print(f'  libra_fast_rcnn_train: {times[1]:.1f} ms/step (after 1 '
          f'warm-up), batch {TRAIN_IMAGES}x{h}x{w}, {FAST_PROPOSALS[1]} '
          f'proposals an image [{card}]; losses ' + ', '.join(
              f'{k} {float(v):.4g}' for k, v in log.items()) +
          f'; {busy_text(busy)}')
    report['item20']['libra_fast'] = dict(infer=rec, ms_per_step=times[1],
                                          times_ms=times, busy=busy)
    del model, opt
    torch.cuda.empty_cache()
    return launches


def scale_ssd_head(model):
    """SSD's head convs at a tenth of their He weights."""
    for conv in [*model.bbox_head.cls_convs, *model.bbox_head.reg_convs]:
        conv.weight.mul_(0.1)


def unbias_retina_cls(model):
    """RetinaNet's class conv without its prior bias, its weights x10."""
    model.bbox_head.retina_cls.bias.zero_()
    model.bbox_head.retina_cls.weight.mul_(10.0)


TOY_HEADS = {'ssd300': scale_ssd_head, 'nas_fpn': unbias_retina_cls}


def check_item20_toys(report):
    """Phase 20's toys on the card against the CPU: SSD300 (the full VGG at
    300x300, 8 classes) and NAS-FPN RetinaNet (at 128x128) as phase 19's
    dense toys (their steps in float64 on both devices), PISA Mask R-CNN
    and Libra Faster R-CNN as phase 18's (``simple_test``, then phase 3's
    training step with every draw given, the Score-HLR and combined
    samplers' among them)."""
    import copy
    import torch
    from dynamask_torch.models import build_detector
    for kind, hw in ITEM20_DENSE_TOYS:
        if kind == 'ssd300':
            from dynamask_torch.utils import Config
            cfg = Config.fromfile(ITEM20_CONFIGS[kind])
            cfg.model.bbox_head.num_classes = 8
            cfg.test_cfg.update(nms_pre=50, max_per_img=20)
        else:
            cfg = single_stage_toy(kind, ITEM20_CONFIGS[kind])
            cfg.model.neck.in_channels = [128, 256, 512]
        check_dense_toy(report, kind, cfg, 0, step_dtype=torch.float64,
                        hw=hw, init_std=None, prepare=TOY_HEADS[kind])
    gen = torch.Generator().manual_seed(1)
    batch = {'image': torch.randn(1, 128, 128, 3, generator=gen),
             'img_shape': torch.tensor([[128., 128.]]),
             'scale_factor': torch.ones(1, 4)}
    for kind in ITEM20_TWO_STAGE_TOYS:
        cfg = toy_cfg(kind)
        ref = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                             device='cpu', seed=0)
        model = copy.deepcopy(ref).to(DEVICE)
        sides = KinkSides()
        with torch.no_grad():
            with sides.patched(follow=False):
                b = {k: v.cpu() for k, v in model.simple_test(
                    {k: v.to(DEVICE) for k, v in batch.items()}).items()}
            with sides.patched(follow=True):
                a = ref.simple_test(batch)
        same = all(torch.equal(a[k], b[k]) for k in ('labels', 'det_valid'))
        valid = a['det_valid'].bool()
        errs = {k: (a[k].double() - b[k].double())[valid].abs().max().item()
                for k in ('dets', 'mask_probs') if k in a}
        print(f'  toy {kind}: {int(valid.sum())} dets, GPU vs CPU max abs '
              'err ' + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()) +
              f', labels/valid equal {same}; ReLU inputs put on the GPU '
              f'run\'s side of a kink: {sides.moved}')
        report['toy'].append(dict(model=f'item20_{kind}',
                                  same_labels_valid=same, **errs))
        if not (same and int(valid.sum()) > 0 and errs['dets'] < 1e-3 and
                errs.get('mask_probs', 0.0) < HEAD_TOY_MASK_TOL):
            raise RuntimeError(f'toy {kind}: GPU result disagrees with the '
                               'CPU reference')
        del ref, model
        check_toy_train_against_cpu(report, kind)


def run_item20(report, card):
    """Phase 20: SSD300 and PISA-SSD300, PISA Faster / Mask R-CNN (and the
    X101 Mask R-CNN's image) and PISA RetinaNet, Libra Faster R-CNN, Libra
    Fast R-CNN and Libra RetinaNet, NAS-FPN RetinaNet, each from its config
    file, unchanged, at full width: an image with phase 4's weights
    protocol and a step of 4 images (20 GTs each) from the JAX
    initialisation, on SSD's 300x300, 800x1344, the canvases where JAX's
    BFP is defined (768x1344, 768x1280) and NAS-FPN's 640x640; each a
    counted warm-up held to its exact launches of every kernel and a timed
    repeat (the device-busy shares stand in PERF.md). Then PISA
    Faster R-CNN's sampler split, Libra's 3bj raise at 800x1344 and the
    toys on the card against the CPU."""
    import torch
    from dynamask_torch.apis import config_shapes
    launches = {}
    report['item20'] = {'inference': [], 'train': []}
    for name, infer_hw, train_hw, infer, step in ITEM20_CELLS:
        path = ITEM20_CONFIGS[name]
        images = config_shapes(path)[1]
        got, recs = run_config_inference(
            report, card, name, path, infer_hw, (('infer', None, infer),),
            repeats=1)
        launches.update(got)
        report['item20']['inference'] += recs
        if train_hw is not None:
            got, rec = run_config_train(report, card, name, path, images,
                                        train_hw, step, repeats=1)
            launches.update(got)
            report['item20']['train'].append(rec)
        torch.cuda.empty_cache()
    launches.update(run_libra_fast(report, card))
    run_pisa_sampler_split(report, card)
    check_bfp_3bj(report, card)
    check_item20_toys(report)
    return launches


ITEM21_CONFIGS = {name: os.path.join(ROOT, rel) for name, rel in {
    'faster_rcnn_c4':
        'configs/faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py',
    'mask_rcnn_c4': 'configs/mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py',
    'rpn_c4': 'configs/rpn/rpn_r50_caffe_c4_1x_coco.py',
    'dpool_faster_rcnn': 'configs/dcn/faster_rcnn_r50_fpn_dpool_1x_coco.py',
    'mdpool_faster_rcnn':
        'configs/dcn/faster_rcnn_r50_fpn_mdpool_1x_coco.py',
    'cornernet':
        'configs/cornernet/cornernet_hourglass104_mstest_8x6_210e_coco.py',
}.items()}
# CornerNet's canvases: its test pipeline resizes a 640x480 image to
# 383x511 with no pad, and its train pipeline's crop is 511x511; at both
# the stride-4 map halves evenly five times, as JAX's Hourglass needs (3bq)
CORNER_IMAGE_HW = (383, 511)
CORNER_TRAIN_HW = (511, 511)
# (name, an image's canvas, a step's, an image's launches, a step's): the
# C4 box crop one K2 launch (K4 in the step), Mask R-CNN's mask crop a
# second; the deform pool's box crop, the RPN and CornerNet run no hand
# kernel
ITEM21_CELLS = (
    ('faster_rcnn_c4', IMAGE_HW, IMAGE_HW, {ROI_FWD: 1},
     {ROI_FWD: 1, ROI_BWD: 1}),
    ('mask_rcnn_c4', IMAGE_HW, IMAGE_HW, {ROI_FWD: 2},
     {ROI_FWD: 2, ROI_BWD: 2}),
    ('rpn_c4', IMAGE_HW, IMAGE_HW, {}, {}),
    ('dpool_faster_rcnn', IMAGE_HW, IMAGE_HW, {}, {}),
    ('mdpool_faster_rcnn', IMAGE_HW, IMAGE_HW, {}, {}),
    ('cornernet', CORNER_IMAGE_HW, CORNER_TRAIN_HW, {}, {}),
)
ITEM21_TWO_STAGE_TOYS = ('c4', 'mdpool')


def time_plain_dpool(report, card):
    """The plain deform pool (``ops.roi_pool``, the dpool and mdpool
    extractors' two passes and offset fcs) at the FPN's P2-P5 of 800x1344
    images at 256 channels, with CUDA events: an image's 1000 proposals
    forward, a step's 2048 RoIs over 4 images forward and forward +
    backward (``plain dpool ...`` lines). Plain PyTorch by design: the JAX
    package computes it in XLA."""
    import torch
    from dynamask_torch.models.deform_roi_pool import DeformRoIPoolPack
    gen = torch.Generator(device=DEVICE).manual_seed(27)
    h, w = IMAGE_HW
    report['item21']['plain_dpool'] = []
    for modulated in (False, True):
        ext = DeformRoIPoolPack(modulated=modulated).to(DEVICE)
        with torch.no_grad():
            for p in ext.parameters():
                p.normal_(0.0, 0.01, generator=gen)
        for images, n, grad in ((1, 1000, False), (TRAIN_IMAGES, N_BOX_TRAIN,
                                                   False),
                                (TRAIN_IMAGES, N_BOX_TRAIN, True)):
            feats = [torch.randn(images, h // s, w // s, 256, generator=gen,
                                 device=DEVICE).requires_grad_(grad)
                     for s in (4, 8, 16, 32)]
            rois, img = synthetic_rois(gen, DEVICE, n, images, IMAGE_HW)

            def run():
                with torch.set_grad_enabled(grad):
                    out = ext(feats, rois, img)
                    if grad:
                        out.sum().backward()

            torch.cuda.reset_peak_memory_stats(DEVICE)
            ms = cuda_ms(run, iters=3, warmup=1)
            peak = torch.cuda.max_memory_allocated(DEVICE)
            what = 'fwd+bwd' if grad else 'fwd'
            name = 'mdpool' if modulated else 'dpool'
            print(f'  plain {name} {n} RoIs over {images}x{h}x{w} P2-P5 x256 '
                  f'{what}: {ms:.2f} ms, peak memory {peak / 2 ** 30:.2f} GiB '
                  f'[{card}]')
            report['item21']['plain_dpool'].append(dict(
                extractor=name, rois=n, images=images, pass_=what, ms=ms,
                peak_memory_bytes=peak))
            del feats
        del ext
    torch.cuda.empty_cache()


def check_hourglass_3bq(report, card):
    """CornerNet on the 800x1344 canvas: its Hourglass halves the 200x336
    stride-4 map to 13x21 and cannot add that level's upsampled 7x11 branch
    (14x22), where JAX's sum fails; the port raises the ValueError naming
    3bq (ROADMAP.md queue 3), which this check requires."""
    import torch
    from dynamask_torch.apis import inference_detector, init_detector
    model = init_detector(ITEM21_CONFIGS['cornernet'], device=DEVICE, seed=0,
                          init_std=0.05)
    h, w = IMAGE_HW
    batch = {'image': torch.zeros(1, h, w, 3, device=DEVICE),
             'img_shape': torch.tensor([[h, w]], dtype=torch.float32,
                                       device=DEVICE),
             'scale_factor': torch.ones(1, 4, device=DEVICE)}
    try:
        inference_detector(model, batch)
    except ValueError as e:
        if '3bq' not in str(e):
            raise
        print(f'  cornernet at {h}x{w}: raises the 3bq error, as required: '
              f'{e} [{card}]')
        report['item21']['hourglass_3bq'] = str(e)
        return
    finally:
        del model
        torch.cuda.empty_cache()
    raise RuntimeError(f'cornernet at {h}x{w}: no 3bq error')


def corner_toy_cfg():
    """The CornerNet toy of the JAX package's tests (an Hourglass of
    ``downsample_times=2``, ``stage_channels=[16, 16, 32]``,
    ``stage_blocks=[1, 1, 1]``, 16-channel maps) from the config file, 8
    classes, 20 corners and 50 pairs, 10 dets."""
    from dynamask_torch.utils import Config
    cfg = Config.fromfile(ITEM21_CONFIGS['cornernet'])
    cfg.model.backbone.update(downsample_times=2, stage_channels=[16, 16, 32],
                              stage_blocks=[1, 1, 1], feat_channel=16)
    cfg.model.bbox_head.update(num_classes=8, in_channels=16)
    cfg.test_cfg.update(corner_topk=20, num_dets=50, max_per_img=10)
    return cfg


def pair_corners(model):
    """The toy's heatmap biases at their init but class 0's at 1, its
    embeddings scaled to a twentieth: the top corners pair up within the
    distance threshold, so the decode keeps dets."""
    head = model.bbox_head
    for heat in (*head.tl_heat, *head.br_heat):
        heat[1].conv.bias[0] = 1.0
    for emb in (*head.tl_emb, *head.br_emb):
        emb[1].conv.weight.mul_(0.05)
        emb[1].conv.bias.zero_()


def check_item21_toys(report):
    """Phase 21's toys on the card against the CPU: C4 Mask R-CNN and the
    mdpool Faster R-CNN as phase 18's (``simple_test``, then phase 3's
    training step with every draw given), and the CornerNet toy as phase
    19's dense toys (its step in fp32)."""
    import copy
    import torch
    from dynamask_torch.models import build_detector
    gen = torch.Generator().manual_seed(1)
    batch = {'image': torch.randn(1, 128, 128, 3, generator=gen),
             'img_shape': torch.tensor([[128., 128.]]),
             'scale_factor': torch.ones(1, 4)}
    for kind in ITEM21_TWO_STAGE_TOYS:
        cfg = toy_cfg(kind)
        ref = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                             device='cpu', seed=0)
        model = copy.deepcopy(ref).to(DEVICE)
        sides = KinkSides()
        with torch.no_grad():
            with sides.patched(follow=False):
                b = {k: v.cpu() for k, v in model.simple_test(
                    {k: v.to(DEVICE) for k, v in batch.items()}).items()}
            with sides.patched(follow=True):
                a = ref.simple_test(batch)
        same = all(torch.equal(a[k], b[k]) for k in ('labels', 'det_valid'))
        valid = a['det_valid'].bool()
        errs = {k: (a[k].double() - b[k].double())[valid].abs().max().item()
                for k in ('dets', 'mask_probs') if k in a}
        print(f'  toy {kind}: {int(valid.sum())} dets, GPU vs CPU max abs '
              'err ' + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()) +
              f', labels/valid equal {same}; ReLU inputs put on the GPU '
              f'run\'s side of a kink: {sides.moved}')
        report['toy'].append(dict(model=f'item21_{kind}',
                                  same_labels_valid=same, **errs))
        if not (same and int(valid.sum()) > 0 and errs['dets'] < 1e-3 and
                errs.get('mask_probs', 0.0) < HEAD_TOY_MASK_TOL):
            raise RuntimeError(f'toy {kind}: GPU result disagrees with the '
                               'CPU reference')
        del ref, model
        check_toy_train_against_cpu(report, kind)
    # its step in fp32: the losses take the head's outputs in fp32 on
    # both devices, as JAX's do (a float64 model computes them in fp32)
    check_dense_toy(report, 'cornernet', corner_toy_cfg(), 0, hw=(96, 128),
                    init_std=None, prepare=pair_corners)


def run_item21(report, card):
    """Phase 21: the C4 Faster R-CNN, Mask R-CNN and RPN, the dpool and
    mdpool Faster R-CNNs and CornerNet, each from its config file,
    unchanged, at full width: an image with phase 4's weights protocol and
    a step of 4 images (20 GTs each) from the JAX initialisation, at
    800x1344 (CornerNet at 383x511 and 511x511); each a counted warm-up
    held to its exact launches of every kernel and a timed repeat (the
    device-busy shares stand in PERF.md). Then the plain deform
    pool timed, CornerNet's 3bq raise at 800x1344 and the toys on the card
    against the CPU."""
    import torch
    launches = {}
    report['item21'] = {'inference': [], 'train': []}
    t = time.perf_counter()
    for name, infer_hw, train_hw, infer, step in ITEM21_CELLS:
        path = ITEM21_CONFIGS[name]
        got, recs = run_config_inference(
            report, card, name, path, infer_hw, (('infer', None, infer),),
            repeats=1)
        launches.update(got)
        report['item21']['inference'] += recs
        got, rec = run_config_train(report, card, name, path, TRAIN_IMAGES,
                                    train_hw, step, repeats=1)
        launches.update(got)
        report['item21']['train'].append(rec)
        torch.cuda.empty_cache()
    parts = {'drives': time.perf_counter() - t}
    for part, fn in (('plain dpool', lambda: time_plain_dpool(report, card)),
                     ('3bq', lambda: check_hourglass_3bq(report, card)),
                     ('toys', lambda: check_item21_toys(report))):
        t = time.perf_counter()
        fn()
        parts[part] = time.perf_counter() - t
    report['item21']['parts_s'] = parts
    print('  phase 21 parts: ' + ', '.join(f'{k} {v:.1f} s'
                                           for k, v in parts.items()))
    return launches


# -- phase 22: item 2, bf16 on the families that run the hand kernels -------

# (name of the file's fp32 cell in phases 8-21, config, a step too); each
# file is driven as its fp32 cell drives it: phase 8's DynaMask files in
# both MSM modes, the HRNet step from N(0, HRNET_STEP_STD) weights (3aj)
ITEM22_CELLS = (
    ('r101', dict(CONFIG_CELLS)['r101'], True),
    ('lvis', dict(CONFIG_CELLS)['lvis'], False),
    ('cityscapes', dict(CONFIG_CELLS)['cityscapes'], True),
    ('refine_r50', REFINEMASK, True),
    ('mask_rcnn_c4', ITEM21_CONFIGS['mask_rcnn_c4'], True),
    ('cascade_mask_rcnn', CASCADE_CONFIG, True),
    ('htc', HTC_CONFIG, True),
    ('x101', X101, False),
    ('groie', GROIE_CONFIG, True),
    ('hrnet_w32', os.path.join(HRNET_DIR, 'mask_rcnn_hrnetv2p_w32_1x_coco.py'),
     True),
    ('ga_faster', os.path.join(GA_DIR, 'ga_faster_r50_fpn_1x_coco.py'), True),
    ('ga_retinanet', os.path.join(GA_DIR, 'ga_retinanet_r50_fpn_1x_coco.py'),
     True),
    ('sac_cascade_rcnn', os.path.join(DETECTORS_DIR,
                                      'cascade_rcnn_r50_sac_1x_coco.py'), True),
    ('point_refine', TOY_CONFIGS['point_refine'], True),
)


# DynaMask's mask loss weighs each stage's detail loss by the MSM's
# straight-through Gumbel argmax and divides it by the stage's routed count;
# the flops loss is the routed stages' mean cost. Step 0's routing is
# recorded on both sides (:func:`msm_step_of`). Where it agrees RoI for
# RoI, the whole loss is held to BF16_LOSS_RTOL, its mask loss taken on the
# bf16 step's own logits cast to fp32: in bf16, JAX's detail loss takes the
# log of 1 - sigmoid in the logits' type, which is exactly 0 past |x| ~ 6.9
# and then clamps to log(1e-10) (3by; the port keeps JAX's function), so
# random full-width weights move it by tens of percent. Where the routing
# differs, the loss without these terms is held, and the routing of both is
# printed beside them.
ROUTED_LOSSES = ('loss_masks', 'loss_flops')


def held_loss(log, msm, routing_agrees):
    """Step 0's loss as the step-0 rule holds it (``msm``: the step's
    :func:`msm_step_of` record, None off DynaMask)."""
    if msm is None:
        return log['loss']
    if routing_agrees:
        return log['loss'] - log['loss_masks'] + msm['loss_masks_f32']
    return log['loss'] - sum(log.get(k, 0.0) for k in ROUTED_LOSSES)


def routing_text(r16, r32):
    """Both steps' routed counts per stage (valid RoIs) and how many RoIs
    the two route differently."""
    def hist(r):
        return dict(sorted(collections.Counter(v for v in r if v >= 0
                                               ).items()))
    moved = (sum(a != b for a, b in zip(r16, r32)) if len(r16) == len(r32)
             else 'all (RoI counts differ)')
    return (f'routed per stage bf16 {hist(r16)}, fp32 {hist(r32)}, '
            f'{moved} of {len(r16)} RoIs routed differently')


def fp32_records(report, name):
    """The fp32 drives of config cell ``name`` in this run's earlier
    phases: ({mode: an image's record}, the steps' record)."""
    infer, train = {}, None
    for section in report.values():
        if not isinstance(section, dict):
            continue
        for rec in section.get('inference') or ():
            if isinstance(rec, dict) and rec.get('config') == name and \
                    not rec.get('bf16'):
                infer[rec['mode']] = rec
        for rec in section.get('train') or ():
            if isinstance(rec, dict) and rec.get('config') == name and \
                    not rec.get('bf16'):
                train = rec
    if not infer:
        raise RuntimeError(f'{name}: no fp32 drive in this run to hold '
                           'its bf16 drive to')
    return infer, train


def per_drive(rec):
    """One drive's launches of an fp32 record (a step's: its total over
    the warm-up and the timed steps, divided by their number)."""
    n = len(rec['times_ms']) if 'ms_per_step' in rec else 1
    counts = {k: v // n for k, v in rec['launches'].items() if v}
    if any(v % n for v in rec['launches'].values()):
        raise RuntimeError(f'{rec["config"]}: {rec["launches"]} over {n} '
                           'steps')
    return counts


def run_item22(report, card):
    """Phase 22: item 2's bf16 on the files of the families that run the
    hand kernels (``ITEM22_CELLS``), each from its config file, unchanged,
    at full width, as its fp32 cell in phases 8-21 drives it: an image
    through ``make_test_fn(..., bf16=True)`` at the config's test canvas
    (both MSM modes on the DynaMask files) and a step of the config's
    batch (4 at 800x1344; Cityscapes 1 at 1024x2048; HTC's with
    ``gt_semantic_seg``) through ``train_steps(..., compute_dtype=
    torch.bfloat16)``, each a counted warm-up and a timed repeat (no
    profiled pass since PR 24). Each drive must launch the bf16 instance of
    each kernel exactly as often as the same file's fp32 drive in this run
    launched the fp32 one, and no fp32 instance and no K5; step 0's loss
    finite and within BF16_LOSS_RTOL of the fp32 cell's step 0
    (DynaMask's as :func:`held_loss` holds it). Each file's line beside
    its fp32 drive: ms, peak memory, the ratios."""
    import torch
    from dynamask_torch.apis import config_shapes
    launches = {}
    report['item22'] = {'inference': [], 'train': [], 'pairs': []}
    for name, path, step in ITEM22_CELLS:
        test_hw, images, train_hw = config_shapes(path)
        infer32, train32 = fp32_records(report, name)
        key = f'{name}_bf16'
        modes = tuple((mode, None if mode == 'infer' else mode == 'dynamic',
                       in_precision(per_drive(rec), 'bf16'))
                      for mode, rec in infer32.items())
        # the drives' profiled passes are cut (PR 24, for phase 23's time;
        # PERF.md keeps PR 22's busy shares)
        got, recs = run_config_inference(report, card, key, path, test_hw,
                                         modes, repeats=1, bf16=True)
        launches.update(got)
        report['item22']['inference'] += recs
        pair = dict(config=name, infer={})
        for rec in recs:
            r32 = infer32[rec['mode']]
            pair['infer'][rec['mode']] = dict(
                bf16_ms=rec['ms_per_img'], fp32_ms=r32['ms_per_img'],
                bf16_peak=rec['peak_memory_bytes'],
                fp32_peak=r32['peak_memory_bytes'])
            print(f'  {name} {rec["mode"]}: bf16 {rec["ms_per_img"]:.1f} '
                  f'ms/img, fp32 {r32["ms_per_img"]:.1f} (phase 8-21 cell, '
                  f'this run), ratio '
                  f'{rec["ms_per_img"] / r32["ms_per_img"]:.2f}; peak '
                  f'memory bf16 {rec["peak_memory_bytes"] / 2 ** 30:.2f} '
                  f'GiB, fp32 {r32["peak_memory_bytes"] / 2 ** 30:.2f} '
                  f'[{card}]')
        if step:
            got, rec = run_config_train(
                report, card, key, path, images, train_hw,
                in_precision(per_drive(train32), 'bf16'), repeats=1,
                compute_dtype=torch.bfloat16,
                init_std=HRNET_STEP_STD if 'hrnet' in name else None)
            launches.update(got)
            report['item22']['train'].append(rec)
            m16, m32 = rec.get('msm'), train32.get('msm')
            if (m16 is None) != (m32 is None):
                raise RuntimeError(f'{name}: the MSM recorded on one step '
                                   'of the two')
            agrees = m16 is None or m16['routing'] == m32['routing']
            l16 = held_loss(rec['losses'][0], m16, agrees)
            l32 = held_loss(train32['losses'][0], m32, agrees)
            rel = abs(l16 - l32) / max(abs(l32), 1e-6)
            routed = '' if agrees else (', '.join(
                f'{k} bf16 {rec["losses"][0][k]:.4g}, fp32 '
                f'{train32["losses"][0][k]:.4g}' for k in ROUTED_LOSSES) +
                '; ' + routing_text(m16['routing'], m32['routing']))
            pair['train'] = dict(
                bf16_ms=rec['ms_per_step'], fp32_ms=train32['ms_per_step'],
                bf16_peak=rec['peak_memory_bytes'],
                fp32_peak=train32['peak_memory_bytes'], loss_bf16=l16,
                loss_fp32=l32, loss_rel=rel, routing_agrees=agrees)
            routed_note = ''
            if m16 is not None and agrees:
                routed_note = (
                    f'; the MSM routing the same on all '
                    f'{len(m16["routing"])} RoIs; loss_masks bf16 '
                    f'{rec["losses"][0]["loss_masks"]:.4g} on its own '
                    f'logits, {m16["loss_masks_f32"]:.4g} on them cast to '
                    f'fp32, fp32 {train32["losses"][0]["loss_masks"]:.4g} '
                    f'({m32["loss_masks_f32"]:.4g}); detail sigmoids '
                    f'saturated bf16 {m16["saturated"]:.3%}, fp32 '
                    f'{m32["saturated"]:.3%} (3by)')
                pair['train'].update(msm_bf16=m16, msm_fp32=m32)
            print(f'  {name} step: bf16 {rec["ms_per_step"]:.1f} ms/step, '
                  f'fp32 {train32["ms_per_step"]:.1f} (this run), ratio '
                  f'{rec["ms_per_step"] / train32["ms_per_step"]:.2f}; peak '
                  f'memory bf16 {rec["peak_memory_bytes"] / 2 ** 30:.2f} '
                  f'GiB, fp32 {train32["peak_memory_bytes"] / 2 ** 30:.2f}; '
                  f'step-0 loss bf16 {l16:.5g}, fp32 {l32:.5g} (rel '
                  f'{rel:.3e}, tol {BF16_LOSS_RTOL}' + routed_note +
                  (f'; without the routed {routed}' if routed else '') +
                  f') [{card}]')
            if not rel <= BF16_LOSS_RTOL:
                raise RuntimeError(f'{name}: bf16 step-0 loss {l16} not '
                                   f'within {BF16_LOSS_RTOL} of fp32\'s '
                                   f'{l32}')
        report['item22']['pairs'].append(pair)
        torch.cuda.empty_cache()
    return launches


# -- phase 23: test-time augmentation and conv+BN folding ---------------------

TTA_SET = os.path.join(ROOT, 'build', 'chip_smoke_tta')
# the eval CLI's --tta-scales (h w pairs): Resize(keep_ratio) fits each
# image into 1333x800, then 1333x1000 (the 1344x1344 canvas), flipped and
# not: 4 augmentations an image
TTA_SCALES = ('800', '1333', '1000', '1333')
TTA_AUGS = 4
TTA_INFER = {mode: {k: n * TTA_AUGS for k, n in counts.items()}
             for mode, counts in INFER_COUNTS.items()}
# the folded fp32 TTA drive against the unfolded one. At random weights
# the RPN's objectness ties by the hundred: one rounding apart, the two
# models keep other proposals (7-20% of the 1000 in their slots, a
# builder's chip run), so a det is either the same det (FOLD_BOX_ATOL)
# or another one. Held: each image's FPN levels within FOLD_FEAT_RL2
# (relative L2; the fold itself), the same number of valid dets, and at
# least FOLD_MATCH_SHARE of the folded dets the unfolded ones
FOLD_FEAT_RL2 = 1e-5
FOLD_BOX_ATOL = 0.01    # px, on boxes in original-image coordinates
FOLD_MATCH_SHARE = 0.5
FLAGSHIP_PAIRS = 55     # JAX's count (tests/test_torch_port_fuse.py)


def draw_bn_stats(model, gen):
    """Every BatchNorm's running statistics drawn from ``gen``: means
    N(0, 0.1), variances U(0.5, 1.5), so that folding is not an
    identity."""
    import torch
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d) and \
                    m.running_mean is not None:
                n = m.running_mean.numel()
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))


def tta_toy_batches(device):
    """Two augmentations of a seeded 100x120 image for the toys: as it is
    on a 128x128 canvas, and resized to 125x150 and flipped in that region
    on a 160x160 canvas."""
    import torch
    import torch.nn.functional as F
    img = torch.randn(1, 3, 100, 120,
                      generator=torch.Generator().manual_seed(2))
    out = []
    for (h, w), canvas, flip in (((100, 120), 128, False),
                                 ((125, 150), 160, True)):
        region = F.interpolate(img, size=(h, w), mode='bilinear',
                               align_corners=False)
        if flip:
            region = region.flip(-1)
        image = torch.zeros(1, canvas, canvas, 3)
        image[0, :h, :w] = region[0].permute(1, 2, 0)
        sf = torch.tensor([[w / 120, h / 100] * 2])
        out.append({k: v.to(device) for k, v in dict(
            image=image, img_shape=torch.tensor([[float(h), float(w)]]),
            ori_shape=torch.tensor([[100., 120.]]), scale_factor=sf).items()})
    return out


def check_tta_toys(report):
    """Phase 23: a toy DynaMask in both modes and a toy Mask R-CNN
    (phase 3's) through ``aug_test`` on the card (the kernels) against the
    same models on the CPU (the plain versions), on two augmentations, the
    second rescaled and flipped."""
    import torch
    from dynamask_torch.models import build_detector
    flips = [False, True]
    for name, dynamic in (('faithful', False), ('dynamic', True),
                          ('mask_rcnn', False)):
        cfg = toy_cfg('mask_rcnn' if name == 'mask_rcnn' else 'dynamask')
        if name != 'mask_rcnn':
            cfg.model.roi_head.dynamic_inference = dynamic
        ref = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                             device='cpu', seed=0)
        model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                               device=DEVICE)
        model.load_state_dict(ref.state_dict())
        a = ref.aug_test(tta_toy_batches('cpu'), flips)
        b = {k: v.cpu() for k, v in model.aug_test(
            tta_toy_batches(DEVICE), flips).items()}
        errs = {k: (a[k].double() - b[k].double()).abs().max().item()
                for k in ('dets', 'mask_probs')}
        same = all(torch.equal(a[k], b[k]) for k in ('labels', 'det_valid'))
        print(f'  toy tta {name}: {int(a["det_valid"].sum())} dets, '
              f'mask_probs {tuple(a["mask_probs"].shape)}, GPU vs CPU max '
              'abs err ' + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
              + f', labels/valid equal {same}')
        report['toy'].append(dict(model=f'tta_{name}', dynamic=dynamic,
                                  same_labels_valid=same, **errs))
        # phase 3's rule for simple_test
        if not (same and max(errs.values()) < 1e-3):
            raise RuntimeError(f'toy tta {name}: GPU result disagrees with '
                               'the CPU reference')


def _ms(values) -> str:
    return ' / '.join(f'{v:.1f}' for v in values)


def fold_agreement(folded, unfolded):
    """The folded drive's results against the unfolded drive's, image by
    image: the same number of valid dets, and the share of the folded
    ones within FOLD_BOX_ATOL (every coordinate) of an unfolded det of
    their label -> the least share over the images."""
    import numpy as np
    least = 1.0
    for f, u in zip(folded, unfolded):
        fv, uv = f['valid'], u['valid']
        if f['img_id'] != u['img_id'] or fv.sum() != uv.sum():
            raise RuntimeError(f'fold: image {f["img_id"]}: {int(fv.sum())} '
                               f'valid dets folded, {int(uv.sum())} '
                               'unfolded')
        ub, ul = u['dets'][uv, :4], u['labels'][uv]
        near = [len(ub[ul == label]) and np.abs(
            ub[ul == label] - box).max(1).min() <= FOLD_BOX_ATOL
            for box, label in zip(f['dets'][fv, :4], f['labels'][fv])]
        least = min(least, float(np.mean(near)) if near else 1.0)
    if least < FOLD_MATCH_SHARE:
        raise RuntimeError(f'fold: {least:.3f} of an image\'s folded dets '
                           f'are unfolded ones (least {FOLD_MATCH_SHARE})')
    return least


def fold_features(model, folded, dataset):
    """The largest relative L2 distance of the folded model's FPN levels
    from the unfolded model's, over each image of ``dataset`` at its own
    pipeline's scale, and the share of the RPN's proposals the two keep in
    the same slot (within FOLD_BOX_ATOL)."""
    import torch
    worst, same = 0.0, []
    with torch.no_grad():
        for i in range(len(dataset)):
            s = dataset[i]
            b = {k: torch.from_numpy(s[k])[None].to(DEVICE)
                 for k in ('image', 'img_shape', 'scale_factor')}
            fa = model.extract_feat(model.images(b))
            fb = folded.extract_feat(folded.images(b))
            worst = max([worst] + [((a - c).norm() / a.norm()).item()
                                   for a, c in zip(fa, fb)])
            pa, pb = model.rpn_proposals(fa, b), folded.rpn_proposals(fb, b)
            same.append(((pa.boxes - pb.boxes).abs().amax(-1) <=
                         FOLD_BOX_ATOL).float().mean().item())
    if worst > FOLD_FEAT_RL2:
        raise RuntimeError(f'fold: FPN levels {worst:.3e} apart (relative '
                           f'L2; limit {FOLD_FEAT_RL2})')
    return worst, same


def run_tta(report, card):
    """Phase 23: test-time augmentation and conv+BN folding on the
    flagship at full width, random N(0, 0.05) weights from seed 0 and its
    BatchNorms' statistics drawn (:func:`draw_bn_stats`), saved as a
    ``state_dict`` and read back by the eval CLI, over a seeded COCO set
    of one image at each of ``COCO_SIZES``. (a) The eval CLI
    (``tools.test.main`` in-process) with ``--tta --tta-scales 800 1333
    1000 1333 --eval bbox segm``, in the faithful and the dynamic mode,
    each without and with ``--fuse-conv-bn``: 4 augmentations an image,
    the second scale on the 1344x1344 canvas; each drive held to its
    exact launches (K1 3 x 4 and K2 5 x 4 an image faithful, 6 x 4
    dynamic, the fp32 instances). (b) ``aug_device_test`` in bf16 (a bf16
    copy of the model, folded in fp32 first for the folded drive), faithful,
    each held to the same counts on the ``_bf16`` instances. (c) The
    device ms an image of ``aug_device_test`` against ``make_test_fn`` at
    the single scale (``simple_test`` + the paste) over the same images,
    unfolded and folded, fp32 and bf16, each beside the device's busy
    share of a profiled pass over the first image, timed in turns (after
    a counted warm-up drive each in bf16), each held to its launches; the folded model's FPN levels and its
    fp32 TTA drive's dets against the unfolded ones
    (:func:`fold_features`, :func:`fold_agreement`). (d) The toys'
    ``aug_test`` on the card against the CPU (:func:`check_tta_toys`)."""
    import io
    import re
    import torch
    import dynamask_torch.ops as ops
    from dynamask_torch.apis import (aug_device_test, dataset_mask_canvas,
                                     init_detector, make_test_fn)
    from dynamask_torch.data import build_dataset
    from dynamask_torch.engine import fuse_conv_bn
    from dynamask_torch.tools.test import main as test_main
    rec = report.setdefault('tta', {'cli': [], 'timed': [], 'seconds': {}})
    t_part = time.perf_counter()

    def part(name):         # the phase's seconds by part, in the report
        nonlocal t_part
        now = time.perf_counter()
        rec['seconds'][name] = now - t_part
        t_part = now
    ann_file, img_dir, n_gts = write_coco_set(TTA_SET, per_size=1)
    model = init_detector(FLAGSHIP, device=DEVICE, seed=0, init_std=0.05)
    draw_bn_stats(model, torch.Generator().manual_seed(0))
    ckpt = os.path.join(TTA_SET, 'flagship_random_bn.pth')
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
    scales = [tuple(int(v) for v in TTA_SCALES[i:i + 2])
              for i in range(0, len(TTA_SCALES), 2)]
    paths = [f'data.test.ann_file={ann_file}',
             f'data.test.img_prefix={img_dir}', 'data.test.data_root=None']
    n = len(COCO_SIZES)
    print(f'  set: {n} images at COCO sizes {COCO_SIZES} (w x h), {n_gts} '
          f'polygon GTs; --tta-scales {" ".join(TTA_SCALES)}: '
          f'{TTA_AUGS} augmentations an image')
    launches = {}
    n_fused = None
    for mode, dyn in (('faithful', False), ('dynamic', True)):
        for fused in (False, True):
            argv = [FLAGSHIP, ckpt, '--tta', '--tta-scales', *TTA_SCALES,
                    '--eval', 'bbox', 'segm', '--device', DEVICE,
                    '--options', *paths,
                    f'model.roi_head.dynamic_inference={dyn}']
            if fused:
                argv.insert(3, '--fuse-conv-bn')
            key = f'tta_{mode}' + ('_fused' if fused else '')
            out = io.StringIO()
            ops.reset_kernel_launches()
            t = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = test_main(argv)
            torch.cuda.synchronize(DEVICE)
            wall = time.perf_counter() - t
            launches[key] = ops.kernel_launches()
            text = out.getvalue()
            if rc != 0:
                raise RuntimeError(f'{key}: the eval CLI exited {rc}: '
                                   f'{text[-2000:]}')
            check_exact_launches(key, launches[key], TTA_INFER[mode],
                                 times=n)
            metrics = dict(re.findall(r'^(\w+_mAP): ([0-9.]+)$', text,
                                      re.M))
            if set(metrics) != {'bbox_mAP', 'segm_mAP'}:
                raise RuntimeError(f'{key}: metrics {metrics}: {text}')
            m = re.search(r'^fused (\d+) conv\+bn pairs$', text, re.M)
            if fused != bool(m):
                raise RuntimeError(f'{key}: fold line {m}: {text}')
            if m:
                if n_fused not in (None, int(m[1])):
                    raise RuntimeError(f'{key}: {m[1]} pairs, {n_fused} '
                                       'before')
                n_fused = int(m[1])
            print(f'  {key}: the eval CLI in {wall:.1f} s (build, {n} '
                  f'images x {TTA_AUGS} augmentations, evaluate) [{card}]; '
                  f'bbox_mAP {metrics["bbox_mAP"]}, segm_mAP '
                  f'{metrics["segm_mAP"]} (random weights)'
                  + (f'; fused {n_fused} conv+bn pairs' if m else ''))
            rec['cli'].append(dict(mode=mode, fused=fused, seconds=wall,
                                   metrics=metrics, launches=launches[key]))
    part('cli')
    if n_fused != FLAGSHIP_PAIRS:
        raise RuntimeError(f'fold: {n_fused} pairs, JAX folds '
                           f'{FLAGSHIP_PAIRS}')
    rec['fused_pairs'] = n_fused

    dataset = build_dataset(dict(model.cfg.data['test'],
                                 ann_file=ann_file, img_prefix=img_dir,
                                 data_root=None),
                            default_args=dict(test_mode=True))
    folded, _ = fuse_conv_bn(model)
    results = {}
    for prec in ('fp32', 'bf16'):
        bf16 = prec == 'bf16'
        nets = (('unfolded', model), ('folded', folded))
        counts = in_precision(TTA_INFER['faithful'], prec)
        # bf16: a counted warm-up drive each, the bf16 paths (the CLI's
        # drives above warmed the fp32 ones up)
        for label, net in nets if bf16 else ():
            key = f'tta_{prec}_{label}'
            ops.reset_kernel_launches()
            results[key] = aug_device_test(net, dataset, scales=scales,
                                           bf16=bf16, progress=False)
            launches[key] = ops.kernel_launches()
            check_exact_launches(key, launches[key], counts, times=n)
        fns = {label: make_test_fn(net, dataset_mask_canvas(dataset),
                                   bf16=bf16) for label, net in nets}
        batches = [{k: torch.from_numpy(dataset[i][k])[None].to(DEVICE)
                    for k in ('image', 'img_shape', 'ori_shape',
                              'scale_factor')} for i in range(n)]

        def single_scale(label):
            for b in batches:
                fns[label](b)
            torch.cuda.synchronize(DEVICE)

        # timed in turns, unfolded then folded
        tta_ms = collections.defaultdict(list)
        single_ms = collections.defaultdict(list)
        for label in ('unfolded', 'folded'):
            net = dict(nets)[label]
            timings = {}
            ops.reset_kernel_launches()
            got = aug_device_test(net, dataset, scales=scales, bf16=bf16,
                                  progress=False, timings=timings)
            check_exact_launches(f'tta_{prec}_{label} (timed)',
                                 ops.kernel_launches(), counts, times=n)
            results.setdefault(f'tta_{prec}_{label}', got)
            tta_ms[label].append(1e3 * timings['device'] / n)
            single_scale(label)
            t = time.perf_counter()
            single_scale(label)
            single_ms[label].append(1e3 * (time.perf_counter() - t) / n)
        for label, net in nets:
            # the busy shares over the first image: a profiled pass over
            # all four costs the host seconds of trace processing
            row = dict(precision=prec, folded=label == 'folded',
                       tta_ms=statistics.mean(tta_ms[label]),
                       tta_ms_turns=tta_ms[label],
                       single_ms=statistics.mean(single_ms[label]),
                       single_ms_turns=single_ms[label],
                       tta_busy=device_busy(lambda: aug_device_test(
                           net, dataset, scales=scales, bf16=bf16,
                           progress=False, max_images=1)),
                       single_busy=device_busy(
                           lambda: fns[label](batches[0])))
            print(f'  tta_{prec}_{label}: TTA x{TTA_AUGS} '
                  f'{row["tta_ms"]:.1f} device ms/img (aug_test + paste, '
                  f'synchronised; turns {_ms(row["tta_ms_turns"])}), '
                  f'{busy_text(row["tta_busy"])}; single scale '
                  f'{row["single_ms"]:.1f} device ms/img (simple_test + '
                  f'paste; turns {_ms(row["single_ms_turns"])}), '
                  f'{busy_text(row["single_busy"])}; TTA / single '
                  f'{row["tta_ms"] / row["single_ms"]:.2f} [{card}]')
            rec['timed'].append(row)
        del fns, batches
        part(f'timed_{prec}')
    for prec in ('fp32', 'bf16'):
        a, b = (next(r for r in rec['timed'] if r['precision'] == prec and
                     r['folded'] == f) for f in (True, False))
        print(f'  tta {prec}: folded / unfolded device ms/img, TTA '
              f'{a["tta_ms"] / b["tta_ms"]:.3f}, single scale '
              f'{a["single_ms"] / b["single_ms"]:.3f} [{card}]')
    feat, same = fold_features(model, folded, dataset)
    least = fold_agreement(results['tta_fp32_folded'],
                           results['tta_fp32_unfolded'])
    print(f'  tta fold: FPN levels within {feat:.3e} of the unfolded '
          f'model\'s (relative L2, limit {FOLD_FEAT_RL2}); the RPN keeps '
          f'{_ms([100 * v for v in same])} % of its proposals in their '
          f'slots; the folded fp32 TTA drive has the unfolded one\'s '
          f'valid count on every image, and at least {100 * least:.1f}% '
          f'of its dets within {FOLD_BOX_ATOL} px of an unfolded det of '
          f'their label (limit {100 * FOLD_MATCH_SHARE:.0f}%; the others '
          'follow other proposals)')
    rec['fold'] = dict(feature_rl2=feat, proposals_same_slot=same,
                       least_matched_share=least)
    part('fold')
    del model, folded, results
    torch.cuda.empty_cache()
    check_tta_toys(report)
    part('toys')
    print('  phase 23 by part: ' + ', '.join(
        f'{k} {v:.1f} s' for k, v in rec['seconds'].items()))
    return launches


def main() -> int:
    t_run = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on a GPU',
              file=sys.stderr)
        return 2
    import dynamask_torch.ops as ops
    from dynamask_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 GEMMs
    torch.backends.cudnn.allow_tf32 = False         # fp32 convs
    card = card_line()
    print(f'device: {torch.cuda.get_device_name(0)} | torch '
          f'{torch.__version__} cuda {torch.version.cuda} | {card} | host '
          f'{len(os.sched_getaffinity(0))} CPUs')
    report = {'card': card, 'kernel_cases': [], 'toy': [], 'main_path': [],
              'k5_flagship': []}

    print('phase 1: build kernels')
    t0 = time.perf_counter()
    built = _build.build()
    print(f'  built {sorted(built)} in {time.perf_counter() - t0:.1f} s')
    report['build'] = {}
    for name, info in built.items():
        ptxas = [ln.strip() for ln in info['log'].splitlines()
                 if 'registers' in ln or 'spill' in ln]
        for ln in ptxas:
            print(f'  {name}: {ln}')
        report['build'][name] = dict(seconds=info['seconds'], ptxas=ptxas)
    report['k5_sass'] = check_k5_sass(_build.library_path(
        'deform_conv_fused'))

    print(f'phase 2: kernels against their plain versions [{card}]')
    rows = check_kernels(report)
    check_dcn_edges(report)
    check_roi_edges(report)
    check_refusals(report)
    check_k5_edges(report)
    print('phase 3: toy model, GPU against CPU')
    check_toy_against_cpu(report)
    check_toy_train_against_cpu(report)
    check_toy_train_against_cpu(report, 'mask_rcnn')
    check_toy_train_against_cpu(report, 'refinemask')
    for kind in ('faster_rcnn', *DEEP_TOYS, *CASCADE_TOYS, *TWO_STAGE_TOYS):
        check_toy_train_against_cpu(report, kind)
    check_single_stage_toys(report)
    check_item8_toys(report)
    print(f'phase 4: flagship inference [{card}]')
    launches = run_inference_path(report, card)
    torch.cuda.empty_cache()
    print(f'phase 5: flagship training [{card}]')
    launches['train'] = run_train_path(report, card)
    torch.cuda.empty_cache()
    print(f'phase 6: COCO evaluation path [{card}]')
    launches.update(run_eval_path(report, card))
    torch.cuda.empty_cache()
    print(f'phase 7: the training loop [{card}]')
    t7 = time.perf_counter()
    launches.update(run_train_loop(report, card,
                                   report['train']['ms_per_step']))
    torch.cuda.empty_cache()
    launches['overfit_loop'] = run_overfit(report, card)
    report['phase7_s'] = time.perf_counter() - t7
    print(f'  phase 7: {report["phase7_s"]:.1f} s')
    torch.cuda.empty_cache()
    print(f'phase 8: the other configurations of BASELINE.json [{card}]')
    t8 = time.perf_counter()
    launches.update(run_configs(report, card))
    report['phase8_s'] = time.perf_counter() - t8
    print(f'  phase 8: {report["phase8_s"]:.1f} s')
    torch.cuda.empty_cache()
    print(f'phase 9: the flagship in bf16 [{card}]')
    t9 = time.perf_counter()
    launches.update(run_bf16_paths(report, card))
    report['phase9_s'] = time.perf_counter() - t9
    print(f'  phase 9: {report["phase9_s"]:.1f} s')
    torch.cuda.empty_cache()
    print(f'phase 10: the RefineMask family [{card}]')
    t10 = time.perf_counter()
    launches.update(run_refinemask(report, card))
    report['phase10_s'] = time.perf_counter() - t10
    print(f'  phase 10: {report["phase10_s"]:.1f} s')
    torch.cuda.empty_cache()
    print(f'phase 11: the box-only detectors and the ResNet variants '
          f'[{card}]')
    t11 = time.perf_counter()
    launches.update(run_box_only(report, card))
    report['phase11_s'] = time.perf_counter() - t11
    print(f'  phase 11: {report["phase11_s"]:.1f} s')
    torch.cuda.empty_cache()
    print(f'phase 12: Cascade R-CNN and Hybrid Task Cascade [{card}]')
    t12 = time.perf_counter()
    launches.update(run_cascades(report, card))
    report['phase12_s'] = time.perf_counter() - t12
    print(f'  phase 12: {report["phase12_s"]:.1f} s')
    torch.cuda.empty_cache()
    print(f'phase 13: the two-stage family\'s options [{card}]')
    t13 = time.perf_counter()
    launches.update(run_two_stage(report, card))
    report['phase13_s'] = time.perf_counter() - t13
    print(f'  phase 13: {report["phase13_s"]:.1f} s')
    torch.cuda.empty_cache()
    print(f'phase 14: the single-stage detectors [{card}]')
    t14 = time.perf_counter()
    launches.update(run_single_stage(report, card))
    report['phase14_s'] = time.perf_counter() - t14
    print(f'  phase 14: {report["phase14_s"]:.1f} s')
    torch.cuda.empty_cache()
    print(f'phase 15: the detectors on HRNet, RegNet, Res2Net and PAFPN '
          f'[{card}]')
    t15 = time.perf_counter()
    launches.update(run_item8(report, card))
    report['phase15_s'] = time.perf_counter() - t15
    print(f'  phase 15: {report["phase15_s"]:.1f} s')
    torch.cuda.empty_cache()
    print(f'phase 16: the backbones\' deformable convs and block plugins '
          f'[{card}]')
    t16 = time.perf_counter()
    launches.update(run_item7(report, card))
    report['phase16_s'] = time.perf_counter() - t16
    print(f'  phase 16: {report["phase16_s"]:.1f} s')
    torch.cuda.empty_cache()
    print(f'phase 17: guided anchoring and DetectoRS [{card}]')
    t17 = time.perf_counter()
    launches.update(run_item9(report, card))
    report['phase17_s'] = time.perf_counter() - t17
    print(f'  phase 17: {report["phase17_s"]:.1f} s')
    torch.cuda.empty_cache()
    print(f'phase 18: item 9\'s two-stage heads [{card}]')
    t18 = time.perf_counter()
    launches.update(run_item9_heads(report, card))
    report['phase18_s'] = time.perf_counter() - t18
    print(f'  phase 18: {report["phase18_s"]:.1f} s')
    torch.cuda.empty_cache()
    print(f'phase 19: item 6\'s FPN dense detectors [{card}]')
    t19 = time.perf_counter()
    launches.update(run_item6(report, card))
    report['phase19_s'] = time.perf_counter() - t19
    print(f'  phase 19: {report["phase19_s"]:.1f} s')
    torch.cuda.empty_cache()
    print(f'phase 20: SSD, PISA, Libra R-CNN and NAS-FPN [{card}]')
    t20 = time.perf_counter()
    launches.update(run_item20(report, card))
    report['phase20_s'] = time.perf_counter() - t20
    print(f'  phase 20: {report["phase20_s"]:.1f} s')
    torch.cuda.empty_cache()
    print(f'phase 21: C4, DeformRoIPool and CornerNet [{card}]')
    t21 = time.perf_counter()
    launches.update(run_item21(report, card))
    report['phase21_s'] = time.perf_counter() - t21
    print(f'  phase 21: {report["phase21_s"]:.1f} s')
    torch.cuda.empty_cache()
    print(f'phase 22: bf16 on the families that run the hand kernels '
          f'[{card}]')
    t22 = time.perf_counter()
    launches.update(run_item22(report, card))
    report['phase22_s'] = time.perf_counter() - t22
    print(f'  phase 22: {report["phase22_s"]:.1f} s')
    torch.cuda.empty_cache()
    print(f'phase 23: test-time augmentation and conv+BN folding [{card}]')
    t23 = time.perf_counter()
    launches.update(run_tta(report, card))
    report['phase23_s'] = time.perf_counter() - t23
    report['run_s'] = time.perf_counter() - t_run
    print(f'  phase 23: {report["phase23_s"]:.1f} s; the whole run '
          f'{report["run_s"]:.1f} s [{card}]')
    for row in rows:   # each path's count from its own zeroed drive
        by_path = {path: n[row['name']] for path, n in launches.items()}
        row['launches'] = sum(by_path.values())
        row['launches_by_path'] = by_path
    assert set(r['name'] for r in rows) == set(ops.kernel_launches())
    report['kernels'] = rows
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'chip_smoke.json'), 'w') as f:
        json.dump(report, f, indent=1)
    print(json.dumps({'kernels': rows}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    try:
        rc = main()
    except Exception as e:  # report and fail: no phase may swallow an error
        import traceback
        traceback.print_exc()
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
        rc = 1
    sys.exit(rc)
