#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``tps_pp_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at its path's shapes, then drives
the paths of the full-width NRTR + TPS++ flagship (random weights from a
seed):

* serving (bf16), through ``TextRecognizer.simple_test`` on a batch of 512
  crops and a small batch with mixed valid ratios, on each of the JAX
  package's serving decodes: ``fused40_bf16`` (B=512 and 5), ``fused40``
  (int8 encoder K/V; B=512 and 5) and ``steps`` with a ``use_fused_step``
  decoder (B=512 and 8, the small-batch regime it is kept for); and
  ``fused40_bf16`` with ``stem_mode='fused'`` (kernel 12, seven launches a
  ``predict``) and with the two-stage sampler (``sample_mode='pallas'``,
  ``TPS_SAMPLER_VARIANT=twostage``: kernel 2, and kernel 1 not at all),
  B=512 and 5 each. Each path runs with the launch counts set to 0 just
  before it, and its kernels must carry it; its argmax must agree with its
  plain path (the recognizer's ``plain`` switch); the paths are timed in
  turns. A float32 model then serves B=8 through ``steps``, with and
  without ``use_fused_step`` and with the fused stem (the kernels' float32
  variants), against its plain path;
* training (f32 parameters and Adam state, bf16 autocast, B=256, Adam at
  1e-4 with grad clip 5.0, random DICT90 labels): one step from the same
  weights and batch on the kernel path and on the plain path must agree
  (the loss in f32 and bf16 compute; in f32 compute also the grad norm
  and the gradient that reaches the loss only through the warp's d_grid);
  five steps with dropout 0.1 must give finite losses through the
  grid_sample kernels; both paths are timed. The d_img-only backward
  kernel is driven through ``GridSampleFunction`` with a detached grid;
* beam search (``beam_width`` 5) on a float32 model whose decoder has
  ``use_fused_step``, B=64 (the step kernels at 320 rows): each kernel step
  against the plain step on the same caches, and the path against its
  plain path, the best beam's tokens equal on every row but one whose
  plain ranking has a near-tie (``BEAM_TIE``).

* the inference API, after the serving paths: the seed-0 bf16 flagship's
  weights written as a ``.pth`` (mmcv's wrapper, ``module.`` prefixes)
  and loaded by ``init_recognizer`` from
  ``configs/textrecog/nrtr/nrtr_tps++.py`` with ``model.dtype=bfloat16``
  (``fused40_bf16``); ``model_inference`` on 512 seed-0 uint8 BGR crops
  (heights 16-64, widths 24-400) through the config's test pipeline,
  which must launch kernels 1, 3 and 4, its batch held against the plain
  path, and ``batch_mode=False`` on 16 of them against ``batch_mode=True``
  under the near-tie rule; ``eval_recognizer`` over the crops with random
  DICT90 labels at batch 64, whose metrics must be those of
  ``model_inference``'s texts; ``model_inference``, the host pipeline and
  ``predict`` timed apart; and ``bench_torch.py`` run with
  ``BENCH_ITERS=3``, which must report ``fused40_bf16``.

* the training API, last: the flagship of
  ``configs/textrecog/nrtr/nrtr_tps++.py`` (``model.dtype=bfloat16``, f32
  parameters and Adam state, the config's schedule) through
  ``train_recognizer`` in a world-1 NCCL process group (so that the
  data-parallel gradient all-reduce and the global-batch BatchNorm run),
  on 1,024 seed-0 uint8 crops (heights 16-64, widths 24-400, random
  DICT90 labels of 1-25 characters) through the config's
  ``train_pipeline`` with ``LoadImageFromNdarray`` for
  ``LoadImageFromFile``, ``samples_per_gpu`` 256, ``workers_per_gpu``
  ``min(10, os.cpu_count() - 1)`` spawned workers: two epochs of 4 steps,
  each with its ``.pth`` checkpoint and its evaluation on 256 crops
  (kernels 1, 3 and 4), kernels 8 and 9 launched on every step; then a
  resume from epoch 1's ``.pth`` that runs epoch 2 again, whose step
  count and lr must equal the uninterrupted run's and whose losses must
  be within ``LOSS_RTOL`` (cuDNN's and kernel 9's atomics are not
  bit-reproducible); and a resume of the finished job, which must run no
  step. It prints the CPU count, the loader's images/s alone, the bare
  step's images/s at B=256, ``train_recognizer``'s images/s and the share
  of its wall time the step loop waited on the loader, and the
  checkpoint's size and save time.

* the ABINet + TPS++ family, last: the model of
  ``configs/textrecog/abinet/abinet_tps++.py`` through the port's config
  loader with ``model.dtype=bfloat16``, seed-0 weights, on the card.
  Serving at B=512 (random 32x128x3 crops) and B=5 (mixed valid ratios)
  must launch kernel 1 and no other kernel; its logits' argmax must equal
  the plain path's at every position but where the plain path's top-2
  logit gap is below the near-tie width: ``TIE_MULT`` times the widest gap
  at which the plain path parts from itself when only the sampler's
  rounding changes (the two-stage sampler's plain version), never below
  ``NEAR_TIE``. ``predict`` is timed against the plain path, and its
  stages by CUDA events (``extract_feat``, the vision model, the LM +
  fuser rounds). A float32 model at B=8: logits within
  ``ABINET_F32_ATOL`` of its plain path. The inference API:
  ``init_recognizer`` from the config and a ``.pth`` of the weights, then
  ``model_inference`` on 64 uint8 crops through the config's test
  pipeline (kernel 1; texts those of the plain path but for near-ties).
  Training with the config's Adam at its ``samples_per_gpu`` (192), f32
  parameters, random DICT36 labels of 1-25 characters: one step without
  dropout, kernel path against plain path, in f32 compute (loss, grad
  norm and the ``localization_fc2`` gradient, as the flagship's) and in
  bf16 compute (the loss); five steps with the config's dropout under
  bf16 autocast, finite, launching kernels 8 and 9 once each a step; the
  step timed against the plain path.

* the CTC family's CRNN-TPS, last: the model of
  ``configs/textrecog/tps/crnn_tps_academic_dataset.py`` through the
  port's config loader with ``model.dtype=bfloat16``, seed-0 weights and
  the TPS-STN's fc2 weights drawn at random (``CRNN_FC2_SCALE``), so that
  the warp samples between pixels and past the border. Kernels 8, 9 and
  10 at one channel against their plain versions on the model's own
  grids, bf16 and f32, at the serving shape (B=512) and the training
  shape (B=64), and at three channels on a uniform grid; the one-channel
  rows are recorded (``*_c1``) at the serving (8) and training (9, 10)
  shapes, 9 and 10 also as device time by CUDA graph (``*_c1_graph``)
  on the config's own initial grid (fc2 at zero weights and the fiducial
  bias, as training starts), held there against their plain versions
  too, ATen's backward timed the same way; the label names the grid and
  the plan's cluster of CTAs an image. Kernel 8's rows by CUDA graph are
  the serving shape's (``grid_sample_forward_c1_graph``, bf16 B=512) and
  the training forward's (``grid_sample_forward_c1_f32_graph``, f32
  B=64), each also read cold (the calls rotated over copies of their
  inputs that exceed the L2 cache), ``F.grid_sample`` beside them the
  same ways; the label names kernel 8's plan. Serving at B=512 and B=5 (random
  32x100x1 crops) must launch kernel 8 and no other kernel; its logits'
  argmax must equal the plain path's at every position but where the
  plain top-2 logit gap is below ``TIE_MULT`` times the widest gap at
  which the plain path parts from itself when only the warp's rounding
  changes (the gather + lerp of the plain backward, in f32, rounded to
  bf16 once, against ATen's warp), never below ``NEAR_TIE``;
  ``predict`` timed against the plain path, and its stages by CUDA
  events. A float32 model at B=8: logits within
  ``CRNN_F32_ATOL``. ``init_recognizer`` from the config and a ``.pth``,
  ``model_inference`` on 64 uint8 crops of mixed widths through the
  grayscale test pipeline (kernel 8; valid ratios below 1 clip the CTC
  decode). Training with the config's Adadelta at its
  ``samples_per_gpu`` (64), f32 parameters, random DICT36 labels of 1-12
  characters: one step, kernel path against plain path, in f32 compute
  (loss, grad norm and the ``localization_fc2`` gradient, as the
  flagship's) and in bf16 compute (the loss); five bf16 steps, finite,
  launching kernels 8 and 9 once each a step; then the warp of a
  training batch with a detached grid, whose backward is kernel 10.

* the ResNet31 attention family, last, which runs no hand-written kernel
  (in JAX it is plain XLA): the models of ``SAR_CONFIGS`` (SAR's parallel
  and sequential decoders, RobustScanner, and the parallel config with
  ``ParallelSARDecoderWithBS``) at full width in bf16, seed-0 weights.
  Serving at B=512 (random 48x160x3 crops, valid ratios of widths 48-160
  in steps of 4 over 160, the columns past the width zeroed), the beam
  decoder at B=64 and width 5: ``predict`` timed, its stages by CUDA
  events (``extract_feat``, the encoder, the decode), the resolved decode
  mode ``'steps'``. Each path's float32 model on the card against the
  same weights on the CPU at B=8 (TF32 off): the greedy argmax equal but
  where the CPU path's top-2 gap is below ``NEAR_TIE`` at a row's first
  parting, the beam's best-beam tokens equal but where the CPU ranking
  has a near-tie (``BEAM_TIE``), the probabilities within
  ``SAR_F32_ATOL``; bf16 against float32 on the card at B=512, recorded.
  Training SAR-parallel and RobustScanner at the configs' B=64 (f32
  parameters, bf16 autocast, Adam 1e-3, random DICT90 labels of 1-25
  characters), timed; one float32 step without dropout at B=8, the card
  against the CPU: the loss within ``SAR_LOSS_RTOL`` and the grad norm
  within ``SAR_GRAD_NORM_RTOL``. ``init_recognizer`` from the SAR config
  and a ``.pth``, ``model_inference`` on 64 uint8 crops (heights 16-64,
  widths 24-400): the texts of ``simple_test`` on the pipeline's batch.
  No kernel launches in the phase.

* the transformer family on its other trunks, last: the models of
  ``TRANSFORMER_CONFIGS`` (SATRN academic and small, NRTR on the modality
  transform and on ResNet31 1by16 and 1by8) at full width in bf16, seed-0
  weights. For each, ``'auto'`` must resolve to ``fused40_bf16`` before
  the trunk and again over its token count (200, 40 or 320); serving at
  B=512 (random crops at 32 x 100 or 32 x 160, valid ratios of widths in
  steps of 4, the columns past the width zeroed) must launch kernel 4, and
  kernel 3 where the encoder fuses (NRTR's; SATRN's encoder runs as a
  module); its argmax must equal the plain path's at every row but where
  the plain top-2 gap is below the near-tie width: ``TIE_MULT`` times the
  widest gap at which the plain decode parts from itself when only the
  encoder's rounding changes (the path's encoding against the encoder run
  in float32 and rounded to bf16), never below ``NEAR_TIE``; kernel 4
  against its plain version on one encoding under ``TIE_MULT`` times the
  widest gap at which the plain decode parts from itself when every value
  of that encoding moves by one bf16 ulp (``bf16_ulp_step``), never below
  ``NEAR_TIE``. ``predict`` timed against the plain path, its stages by
  CUDA events;
  SATRN-small also on ``fused40`` (kernel 5 at d_k 32). Kernel 3 at 40 and
  320 tokens (beside ``nn.TransformerEncoder``) and kernels 4-5 at d_k 32
  and kernel 4 at 320 source tokens are recorded (``encoder_t40``,
  ``encoder_t320``, ``full_decode_dk32``, ``full_decode_int8_dk32``,
  ``full_decode_te320``). Each float32 model on the card against the CPU
  at B=8 (TF32 off): argmax equal but at a CPU near-tie, probabilities and
  teacher-forced logits within ``TF_F32_ATOL``. The fallback: NRTR-R31
  1by16 in bf16 with ``'auto'`` on crops of 32 x ``TF_FALLBACK_WIDTH``
  (520 tokens, more than kernels 3 and 4 take) resolves to
  ``fused40_bf16`` before the trunk and to ``'steps'`` over its token
  count; ``predict`` serves them without a ``ValueError``, finite, and
  launches no kernel. B=64 training steps of SATRN academic and NRTR-R31
  1by16, timed, with finite losses.

* the segmentation recognizer and the image-space preprocessors, last.
  SegOCR (``SEG_CONFIG``, ResNet31 with four outputs, FPNOCR, SegHead;
  47.7 M parameters) in bf16, seed-0 weights, runs no kernel (in JAX it is
  plain XLA): ``predict`` on 512 random 64 x 256 crops timed, its stages
  by CUDA events (``extract_feat``, the neck, the head) and the host's
  ``tensor2str`` (connected components) of the 512 logit maps; its
  float32 model on the card against the same weights on the CPU at B=8
  (TF32 off): logits within ``SEG_F32_RTOL`` of their largest, the
  per-pixel argmax equal but where the CPU's top-2 gap is below
  ``NEAR_TIE``, the texts equal on the images without such a pixel; B=64
  training steps (Adam, random char maps with 2% ignored pixels), timed,
  and a float32 step at B=8, the card against the CPU, under
  ``SEG_LOSS_RTOL`` and ``SEG_GRAD_NORM_RTOL``. Then MORAN in front of
  CRNN (``CRNN_CONFIG`` with ``MORAN_PRE``: kernel 8 three times a
  ``predict``, its offset map of 3 x 11 sampled up to 32 x 100) and SPIN
  in front of ABINet + TPS++ (``ABINET_CONFIG``, its fc2 drawn at
  ``SPIN_FC2_SCALE``: kernel 1 and kernel 8, SPIN's 2 x 8 offsets at
  three channels up to 32 x 128): serving at B=512 and 5, the argmax
  against the plain path but where the plain top-2 logit gap is below
  ``TIE_MULT`` times the widest gap at which the plain path parts from
  itself when only its warps' rounding changes (the gather + lerp for
  ATen's warps, the two-stage sampler's plain version for the dense
  one's), never below ``NEAR_TIE``; ``predict`` and its preprocessor
  timed; at B=64 an f32-compute step, kernel path against plain path
  (loss within ``LOSS_RTOL``, grad norm within ``GRAD_NORM_RTOL``), which
  must launch kernels 8, 9 (the final warp, TPS++'s) and 10 (the offset
  sample, whose grid is constant), then bf16 steps timed against the
  plain path. The offset samples' kernels on the paths' own inputs are
  recorded (``grid_sample_moran_offsets``, ``grid_sample_spin_offsets``
  and their ``grid_sample_grad_img_*`` rows), device time by CUDA graph,
  kernel 8's also cold.

* text detection, last, which runs no hand-written kernel (in JAX it is
  plain XLA, DCNv2 included): both DBNet configs (``DET_CONFIGS``: R18-FPNC
  and R50-DCNv2-FPNC) through ``init_detector`` from their files, seed-0
  weights, float32 (TF32 off), 640 x 640. Their forward must launch no
  kernel. ``detect_batch`` on seeded uint8 640 x 640 x 3 images (B=16 and
  8) timed whole and by stage: the host's prep, the batch's copy to the
  card, the forward on a tensor already there (whole, and by stage with
  CUDA events: trunk, neck, head, and the DCNv2 layers' share of the
  trunk, each the mean of 3 runs), the map's copy to the host and
  ``DBPostprocessor`` an image. Random weights put the whole seed-0 map
  above the mask threshold (one box an image), so the postprocessor is
  also timed on trained-like maps (``trained_like_maps``: word quads drawn
  by ``cv_ops.fill_poly``) and, as a stress test, on the model's map with
  the probability branch's last bias shifted until a share of
  ``DET_STRESS_ABOVE`` of the pixels lie above the threshold, the first
  share at which the float32 batch keeps ``DET_MIN_BOXES`` boxes. The
  card against the CPU at B=2 on the same weights, stressed and seed-0:
  each map channel within ``DET_F32_ATOL``; the number of mask pixels that
  part is logged, and with the CPU map taking the card's value there (the
  masks equal), the boundaries must be equal (points within 1e-3 px), at
  least ``DET_MIN_BOXES`` of them on the stressed map and one an image on
  the seed-0 map. Then ``MMOCR(det=<R18 config>,
  recog='NRTR_TPS').readtext`` on ``N_PAGES`` seeded 640 x 480 pages, on
  the seed-0 map and on the stress test's (the recognizer float32 from
  its config): every page a result list, ms a page whole and split into
  detection, crops and recognition, and the recognizer's launches (kernel
  1).

* detection training and PANet / PSENet, last, which run no hand-written
  kernel (plain XLA and host numpy in JAX): PANet-R18
  (``panet_r18_fpem_ffm_600e_icdar2015.py``) at B=16 and PSENet-R50
  (``psenet_r50_fpnf_600e_icdar2015.py``) at B=8 through
  ``init_detector``, seed-0 weights, float32 (TF32 off), 640 x 640: their
  forward launches no kernel; ``detect_batch`` timed whole and by stage
  (prep, the batch's copy, the forward on the card's tensor, the logits'
  copy, the postprocessor an image on the seed-0 logits and on
  ``N_TRAINED_LIKE`` trained-like logit maps made by ``pan_pse_maps``
  from the ``word_quads`` of a page through the config's own targets);
  the card against the CPU at B=2 on the seed-0 logits and on a stress
  test (``PAN_PSE_STRESS``: the head's text and kernel channels scaled
  and shifted until random weights give tens of regions): logits within
  ``DET_F32_ATOL`` of each channel's scale, and where the two maps' pixel
  decisions are equal the boundaries equal, at least ``DET_MIN_BOXES`` on
  the stressed maps. One float32 step (train-mode BatchNorm, the config's
  loss and optimizer) of DBNet-R18, PANet-R18 and PSENet-R50 on B=2 pages
  of ``word_quads``, the card against the CPU on the same weights: loss
  within ``DET_LOSS_RTOL`` and grad norm within ``DET_GRAD_NORM_RTOL``,
  relative, finite, no kernel launched. ``train_detector`` on the
  DBNet-R18 config at its ``samples_per_gpu`` (16), ``N_DET_TRAIN_PAGES``
  seeded pages (``DetPages``), ``DET_TRAIN_EPOCHS`` epochs with their
  ``.pth``: ms a warm step, the host's target ms a page and the share of
  the epoch spent making batches; a resume from epoch 1's ``.pth`` repeats
  epoch 2's step count and lr, its loss within ``LOSS_RTOL``.

* FCENet and TextSnake, which run no hand-written kernel (plain XLA
  and host numpy in JAX; DCNv2 on the port's plain ``ops/deform_conv.py``):
  FCENet-R50 (``fcenet_r50_fpn_1500e_icdar2015.py``), FCENet-R50-DCNv2
  (``fcenet_r50dcnv2_fpn_1500e_ctw1500.py``) and TextSnake-R50
  (``textsnake_r50_fpn_unet_1200e_ctw1500.py``) through ``init_detector``,
  seed-0 weights, float32 (TF32 off): the card against the CPU at B=2 on
  640 x 640 (``fce_ts_card_checks``: every output within
  ``FCE_TS_F32_RTOL`` of its largest magnitude on the seed-0 weights and
  on a stressed map, whose first-decision logits are moved until half
  its pixels pass the postprocessor's first threshold; there the
  decisions that part are counted and, on equal decisions, FCENet's
  polygons before NMS and TextSnake's boundaries compared; a trained-like
  map moved by the card's difference from the CPU gives the unmoved
  map's polygons or boundaries where the decisions are equal); FCENet's
  text classes then lowered by ``FCE_QUIET`` (seed-0
  weights put thousands of pixels above ``score_thr``, and ``poly_nms``
  would take minutes a page); ``detect_batch`` at B=8 (TextSnake B=4, its
  host postprocessor a second an image) by stage, the
  postprocessor on the seed-0 maps and on trained-like maps
  (``fce_maps``, ``textsnake_maps``: each config's own targets of the
  ``word_quads`` of a page, with FCENet's polygon IoUs counted and timed),
  one B=1 forward at the config's test scale (``FCE_TS_CONFIGS``); one
  float32 step of FCENet-R50 and TextSnake-R50, the card against the CPU
  (``DET_LOSS_RTOL``, ``DET_GRAD_NORM_RTOL``); ``train_detector`` on
  FCENet-R50 at B=8 over ``N_FCE_TRAIN_PAGES`` pages for
  ``FCE_TRAIN_EPOCHS`` epochs and a resume from epoch 1; and
  ``MMOCR.readtext`` with the FCENet-R50 config path and the flagship
  recognizer on ``N_PAGES`` pages, FCENet's text classes lowered until at
  most ``FCE_READ_PIXELS`` pixels pass.

* DRRG, last, which runs no hand-written kernel (flax and host numpy in
  JAX): the shipped DRRG-R50 config (``DRRG_CONFIG``) through
  ``init_detector``, seed-0 weights, float32 (TF32 off). The card against
  the CPU at B=2 on 640 x 640 (``drrg_card_checks``: features and maps
  within ``DRRG_F32_RTOL`` of their largest magnitude, seed-0 and with the
  text and centre logits moved until half the pixels pass the
  centre-mask decision; the GCN's logits on identical node features; on
  trained-like maps (``drrg_maps``: ``DRRGTargets`` of 2-4 ``word_quads``
  a page as +-8 logits) moved by the card's difference, the GCN's link
  bias raised by ``DRRG_LINK_BIAS``, the boundaries equal where the
  decisions and links are, at least ``DRRG_MIN_COMPARED``); the text
  logits then lowered by ``DRRG_QUIET`` (seed-0 weights pass most
  pixels); ``detect_batch`` at B=8 by stage (prep, copy in, the forward
  and its trunk / neck / head, the features and maps' copy out in ms and
  MB), the test graphs and postprocessor on the quieted maps and, beside
  the card's features, on trained-like maps by stage (``DRRGStages``:
  ``propose_comps`` with ``poly_nms``'s polygon IoUs, the graphs and RoI
  pooling, the GCN on the card, the postprocessor); one B=1 forward at
  the test pipeline's 1024 x 640; one float32 step on one page, the card
  against the CPU (``DET_LOSS_RTOL``, ``DET_GRAD_NORM_RTOL``, the targets'
  ``RandomState`` seeded alike); ``train_detector`` over
  ``N_DRRG_TRAIN_PAGES`` pages, one a step, for ``DRRG_TRAIN_EPOCHS``
  epochs and a resume from epoch 1; ``MMOCR.readtext`` with the DRRG
  config path and the flagship recognizer on two pages, its text and
  centre logits lowered until at most ``DRRG_READ_PIXELS`` pixels pass.

* Mask R-CNN, last, which runs no hand-written kernel (flax and host
  numpy in JAX): the shipped ICDAR 2015 config (``MASKRCNN_CONFIG``: R50,
  FPN 256, RPN of 5 anchors, box FCs of 1024, mask convs of 256) through
  ``init_detector``, seed-0 weights, float32 (TF32 off). The card against
  the CPU at B=2 on 640 x 640 (``maskrcnn_card_checks``): the five levels
  and the RPN maps within ``MASKRCNN_F32_RTOL`` of their largest
  magnitude; on the CPU's proposals, the card's 7x7 and 14x14 pooling
  against ``roi_align_np`` of the card's levels copied out, and both
  heads on the same pooled RoIs, within it too; ``detect_batch``'s
  boundaries with the box head's text bias raised by
  ``MASKRCNN_CLS_BIAS`` and the mask logits scaled by
  ``MASKRCNN_MASK_SCALE`` on both, box by box, each side's decisions read
  from its own stages (``maskrcnn_decisions``, ``compare_maskrcnn``):
  equal but where a
  decision lies within ``MASKRCNN_TIE`` of its threshold (top-k, ``wh >
  2``, both NMSs, ``score_thr``, the RoI level, ``mask_thr``) or a box
  corner within ``MASKRCNN_TIE_PX`` of an integer, at least
  ``MASKRCNN_MIN_COMPARED`` equal. ``detect_batch`` at B=8 by stage: the
  host's prep, the copy in, the forward and its trunk / FPN / RPN by CUDA
  events, the RPN maps' copy out (ms, MB: the levels stay on the card),
  the proposals and their NMS, pooling + box head and mask pooling + mask
  head by CUDA events, the detections and their NMS, the paste with
  ``points2boundary``, and proposals, boxes and boundaries a page; one
  B=1 page at the CTW1500 config's 1600 x 1600; one float32 step on one
  page, the card against the CPU on the CPU's RoI sample
  (``DET_LOSS_RTOL``, ``DET_GRAD_NORM_RTOL``), timed on cuDNN's default
  and deterministic algorithms; ``train_detector`` over
  ``N_MASKRCNN_TRAIN_PAGES`` pages, one a step, for
  ``MASKRCNN_TRAIN_EPOCHS`` epochs and a resume from epoch 1, as a user
  calls it (it runs Mask R-CNN's epochs on cuDNN's deterministic
  algorithms itself);
  ``MMOCR.readtext`` with the config path and the flagship recognizer on
  two pages, in the trained-like setting. The detector's path launches no
  kernel.

* KIE and NER, last, which run no hand-written kernel (flax and numpy in
  JAX): the shipped SDMGR configs (UNet16, no visual modality, openset)
  and the BERT-softmax NER config at full width, on data the phase writes
  in a temporary directory from a seed (``kie_ner_data``: receipts of
  ``KIE_NODES`` boxes with texts of up to ``KIE_CHARS`` characters,
  sentences of ``NER_LEN`` characters). Float32, TF32 off, seed weights
  (``init_kie_weights``). The card against the CPU on the same weights:
  SDMGR's node and edge logits at B=``B_KIE`` for each config, the UNet's
  map and the pooled visual features (``KIE_F32_RTOL`` of their largest
  magnitude), the openset pairs decoded
  from the card's softmaxes equal to the CPU's but where a link lies
  within ``OPENSET_TIE`` of ``edge_thr``; BERT-base's logits at
  B=``B_NER_F32`` (``NER_F32_RTOL``), their argmax equal but at a CPU
  top-2 gap below ``NER_TIE``; one f32 step of SDMGR-UNet16 at B=``B_KIE``
  and of NER at B=``B_NER_F32`` without dropout (``DET_LOSS_RTOL``,
  ``DET_GRAD_NORM_RTOL``). SDMGR's whole f32 gradient is ill-conditioned:
  the fusion's signed square root has a derivative of 1 / (2 sqrt|z|) at
  near-zero products, so the CPU's own f32 gradient norm lies ~1e-3 from
  its float64 one. Its f32 step holds instead the gradient norm of each
  group of leaves downstream of the fusion (``KIE_DOWNSTREAM``,
  ``DET_GRAD_NORM_RTOL``; their difference over that norm is logged: a
  ReLU flip in the GNN moves it), and the card's f32 gradient norm
  no farther from the CPU's float64 one than ``KIE_F32_GRAD_MULT`` times
  the CPU's own f32 one; a float64 step at B=``B_KIE`` holds the whole
  gradient norm, card against CPU. ``train_kie``
  on the UNet16 config (images as arrays), and ``tools/train.py`` on the
  closed-set and NER configs, ``KIE_NER_EPOCHS`` epochs each;
  ``tools/test.py`` on their checkpoints,
  on the card and on the CPU, with equal metrics (the UNet16 checkpoint on
  black pages: the image files are absent). ``MMOCR(det='DBNet',
  recog=<the flagship config>, kie='SDMGR').readtext`` on two 640 x 480
  pages, the DB map stressed so that it keeps boxes, every box with its
  ``label`` and ``label_score``. No KIE or NER call moves a launch count.
  It logs SDMGR's forward at B=``B_KIE`` by CUDA events (the LSTM, the GNN,
  the UNet + pooling), BERT-base's at B=``B_NER``, T=``NER_LEN`` against
  its bound, each step, the ms an item of each evaluation and a page of
  ``readtext`` by stage (det / recog / kie).

* deployment, last (``deploy_phase``): the flagship at full width in bf16
  (``fused40_bf16``, seed-0 weights) through ``utils/export.py``:
  ``export_serialized`` at B=``B``, ``load_serialized`` and a run
  of the loaded program on seed-0 crops with mixed valid ratios, which
  must launch kernels 1, 3 and 4 (counted from 0 just before) and equal
  the eager kernel path's argmax on every row (the largest probability
  difference logged); ``aot_compile`` at B=``B``, whose CUDA graph must
  hold kernels 1, 3 and 4 and whose replay must equal the eager argmax,
  its replay ms against the eager ``predict``'s; ``ExportedRecognizer``
  at batch 8 against ``simple_test`` on 5 crops; ``tools/serve_model.py``
  on ``configs/textrecog/nrtr/nrtr_tps++.py`` (``model.dtype=bfloat16``)
  in a thread on a free port: ``DEPLOY_CROPS`` uint8 crops as PNG bodies
  (``cv_ops.png_encode``; the card's machine has no cv2), raw and base64,
  each text equal to ``model_inference`` on the decoded array and its
  score within ``DEPLOY_SCORE_ATOL``, the p50 and largest ms a request;
  ``/ping``, a body that does not decode (400) and a wrong path (404); and
  ``--det`` with DBNet-R18's config on a 640 x 480 PNG page, the
  boundaries equal to ``detect``'s. It logs the export and capture
  seconds, the artifacts' bytes and the graph pool's. Then a TPSPACK1
  annotation file (``tools.data.pack_converter``) through
  ``eval_recognizer`` on ``PACKED_CROPS`` PNG crops, its texts and metrics
  those of the same lines as text (``packed_roundtrip``); and greedy
  ``steps`` + ``use_fused_step`` with its early exit
  (``steps_exit_deploy``): ``export_serialized`` / ``load_serialized``
  and ``aot_compile`` at B=8 and B=``B``, bf16, the exit forced at step
  0, mid-sequence and never through the valid ratios
  (``exit_by_ratio``): argmax and zeros equal to the eager decode's on
  every row, the program launching kernels 6-7 240 times each, the graph
  holding them and a replay launching none from Python; the replay,
  eager ``predict`` (the host exit) and the eager device exit timed in
  turns. Kernels 6-7 are also held with the ``skip`` flag set and unset
  against their plain versions, and read by CUDA graph.
- the mesh phase (``mesh_phase``): ``predict(mesh=)`` on the flagship in
  bf16 at B=``B``, full width, over two meshes of local devices: every
  visible card (one host thread a card), and card 0 listed twice (the
  split and the padding on a one-card machine: its two shards run in turn
  on the card's one thread), and B=``MESH_SMALL`` on the second
  (padded to 8 rows, two shards of 4). Kernels 1, 3 and 4 must launch on
  every shard (each shard's own counts, ``last_shard_launches``), and each
  shard's rows must equal ``predict`` of the same rows alone on its card,
  bit for bit (the same kernels at the same shapes; where they are not,
  the argmax is held under the decode's near-tie rule and the rows that
  part are logged). ``eval_recognizer(mesh=)`` on the card-twice mesh at
  batches of 32 gives the metrics and results of the call without a mesh
  at batches of 16 (the shards' shapes; at 32 the whole decode's plan
  differs, and rows part at near-ties, which are counted). The meshes
  and the one-card ``predict`` are timed in turns.
  The whole script's time is logged before the ``kernels`` line.

The warp's backward kernels (9 and 10) are timed on the uniform grid of
the checks and on TPS++'s own [0, 1]^2 grid, which puts every sample in
the lower half of the map's rows; their band plan is logged.

The 3x3 convolution of the fused stem (kernel 11) has no caller in either
package; it is driven as an op, at the stem's width over the batch of 512.
The band walk's plan at each stem shape (kernels 11 and 12 in bf16) is
logged, and the module stem is timed against the fused stem.

For every kernel it reports the time, the plain version's time, the time of
one PyTorch call that computes the same function where there is one (and,
for kernel 8's graph rows, both on cold inputs: ``cold_ms``,
``library_cold_ms``, None elsewhere), and the bound: the larger of the bytes it must move (each input read once,
each output written once) over the card's memory rate and its operations
over the peak rate of their type (bf16 tensor cores for the matmuls, f32
for the rest), at this run's shapes and steps.

It imports nothing of JAX and nothing of the JAX package.

Output: progress lines, then one JSON line with the kernels, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises; without a CUDA
device it exits non-zero and prints no result.
"""
import json
import math
import os
import subprocess
import sys
import time

B = 512          # serving batch (bench.py's)
N_DECODE = 64    # batch of the decode kernel check
B_SMALL = 8      # the small batch the fused step is kept for
SEED = 0
MESH_SMALL = 6   # the mesh phase's batch that pads (to 8 rows, 2 shards)
# the H100 SXM's published peaks (NVIDIA data sheet, dense): HBM bytes/s,
# bf16 tensor-core and f32 FLOP/s; its L2 cache's bytes
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
L2_BYTES = 50e6

# tolerances of the kernel-vs-plain checks (both sides in bf16 on the card)
SAMPLER_ATOL = 2e-2
# the encoder's two versions round the same values to bf16 at the same
# points; they part where an f32 sum taken in another order crosses a bf16
# rounding boundary (one ulp, 2^-8 relative), and that drifts through six
# layers: allow eight ulps, absolute at magnitude 1 and relative above
ENCODER_ATOL, ENCODER_RTOL = 6.25e-2, 3.125e-2
# decode: argmax equal, or the first differing step is a near-tie of the
# plain version; probabilities before it within the JAX bf16 contract
NEAR_TIE, DECODE_ATOL, DECODE_RTOL = 1e-3, 2e-2, 5e-2
# the bf16 `steps` decodes round the residual stream to bf16 after every
# call (the JAX kernels with use_fused_step as the module path), where the
# whole decode keeps it f32: there one bf16 ulp anywhere upstream moves
# the step-0 probabilities by ~2e-3, and even the module `steps` decode,
# with no decode kernel, parts from itself at top-2 gaps of ~2e-3 when
# only the sampler's version changes. So the fused-step path's near-tie is
# measured in each run (steps_tie_widths): that module decode's widest
# gap, its own sensitivity to one ulp upstream, times TIE_MULT, and
# never below NEAR_TIE. The fused-step kernels against their plain
# versions on one encoding, and the path against its plain path, must part
# only within it. Likewise the fused stem (stem_tie_widths): it perturbs
# every activation of the trunk by bf16 roundings on top of the
# sampler's, encoder's and decode's kernels, so its path's near-tie is
# TIE_MULT times the widest gap at which the decode parts when only the
# stem's rounding changes (module stem against the fused stem, all plain).
# Readings over several seeds: tools/steps_tie_calibration.py, PERF.md
TIE_MULT = 2.0
# the per-step kernels (bf16 outputs of O(1) values): one bf16 rounding
# apart where f32 sums in another order cross a rounding boundary, two
# ulps relative and 2e-2 absolute near 0
STEP_ATOL, STEP_RTOL = 2e-2, 2 ** -7
# the training warp, (atol, rtol): bf16 as the sampler and as the JAX
# package's bf16 VJP test (tests/test_grid_sample_vjp.py:180-193); f32 as
# its f32 tests, at a cotangent scale of 1e-3 (d_grid scales 64-term
# channel sums by (W-1)/2 = 63.5, so unit cotangents put the f32 rounding
# of two summation orders near 2e-5, above the f32 atol)
WARP_BOUNDS = {
    'bfloat16': dict(fwd=(2e-2, 0.0), d_img=(5e-2, 5e-2),
                     d_grid=(0.1, 5e-2), cot_scale=1.0),
    'float32': dict(fwd=(1e-5, 0.0), d_img=(1e-5, 0.0),
                    d_grid=(1e-5, 1e-4), cot_scale=1e-3),
}
# kernels 11-12 (bf16 outputs of O(1) values): both versions round y and
# the output at the same points; an f32 sum in another order moves a
# rounding by one ulp now and then: two bf16 ulps, relative, and 2e-2
# absolute near 0. float32: sums of up to 9 * 64 terms in another order
STEM_BOUNDS = {'bfloat16': (2e-2, 2 ** -7), 'float32': (1e-4, 1e-4)}
# the three BasicBlock shapes of the flagship's stem, (C_in, C_mid, C_out,
# H, W, residual): layer1's blocks, layer2's block0 at full resolution (its
# stride-2 main path), layer2's blocks 1-3
STEM_SHAPES = {'layer1': (32, 32, 32, 32, 128, True),
               'layer2_block0': (32, 64, 64, 32, 128, False),
               'layer2_blocks': (64, 64, 64, 16, 64, True)}
B_TRAIN = 256    # training batch (the JAX package's bench_train.py)
# beam search: batch, beam width, and the near-tie of the plain path's
# ranking (its two best final totals, or a step's last kept and best
# dropped candidate) under which a row's kernel path may pick another beam
B_BEAM, BEAM_W, BEAM_TIE = 64, 5, 1e-3
# the training step, kernel path against plain path (dropout 0)
LOSS_RTOL, GRAD_COS_MIN, GRAD_NORM_RTOL = 1e-2, 0.99, 5e-2
TRAIN_OPT = dict(type='Adam', lr=1e-4, grad_clip=dict(max_norm=5.0))
# the training API phase: crops in the training and validation sets,
# steps an epoch at B=256
N_TRAIN_CROPS, N_VAL_CROPS, TRAIN_EPOCHS = 1024, 256, 2
# the ABINet phase: its config, the crops of its inference API check, and
# the tolerance of the f32 model's logits, kernel path against plain path
# (the f32 warps part by ~1e-6, WARP_BOUNDS; seven transformer layers and
# three rounds amplify that, and the logits reach ~10)
ABINET_CONFIG = 'configs/textrecog/abinet/abinet_tps++.py'
N_ABINET_CROPS, ABINET_F32_ATOL = 64, 1e-3
# the CRNN-TPS phase: its config, the crops of its inference API check, the
# tolerance of the f32 model's logits (kernel path against plain path: the
# f32 warps part by ~1e-6 where ATen and the kernel round the unnormalized
# coordinate in other orders), the scale of the random fc2 weights (so
# that the warp samples between pixels and past the border), and the
# longest label of its training batch (26 frames align any label of 12
# characters, repeats and all: 2 * 12 - 1 <= 26)
CRNN_TPS_CONFIG = 'configs/textrecog/tps/crnn_tps_academic_dataset.py'
N_CRNN_CROPS, CRNN_F32_ATOL = 64, 1e-3
CRNN_FC2_SCALE, CRNN_MAX_LABEL = 0.05, 12
# the ResNet31 attention phase: its configs (the beam-search decoder is the
# parallel config with decoder.type='ParallelSARDecoderWithBS'), the
# beam batch, the float32 batch held against the CPU,
# the crops of its inference API check, and the bounds of the card against
# the CPU in float32 with TF32 off, where cuDNN and the CPU's convolutions
# sum up to 4,608 terms in other orders: the probabilities (absolute), the
# check step's loss and grad norm (relative)
SAR_CONFIGS = {
    'sar_parallel':
        'configs/textrecog/sar/sar_r31_parallel_decoder_academic.py',
    'sar_sequential':
        'configs/textrecog/sar/sar_r31_sequential_decoder_academic.py',
    'robust_scanner':
        'configs/textrecog/robust_scanner/robustscanner_r31_academic.py',
    'sar_beam': 'configs/textrecog/sar/sar_r31_parallel_decoder_academic.py'}
B_SAR_BEAM, B_SAR_F32, N_SAR_CROPS = 64, 8, 64
SAR_F32_ATOL, SAR_LOSS_RTOL, SAR_GRAD_NORM_RTOL = 1e-4, 1e-4, 1e-3
# the transformer family on its other trunks: each config with its crop
# width (SATRN's fixed 32 x 100; NRTR's keep-aspect pipeline up to 32 x
# 160, which gives 40 tokens on the modality transform and the 1by16
# trunk, 320 on the 1by8 trunk); the training batch (the configs'
# samples_per_gpu), the float32 batch held against the CPU, the bound of
# the card against the CPU in float32 with TF32 off (as SAR's), and the
# batch and crop width of the fallback (32 x 2080 gives the 1by16 trunk
# 2 x 260 = 520 tokens, past the kernels' 512)
TRANSFORMER_CONFIGS = {
    'satrn_academic': ('configs/textrecog/satrn/satrn_academic.py', 100),
    'satrn_small': ('configs/textrecog/satrn/satrn_small.py', 100),
    'nrtr_modality': (
        'configs/textrecog/nrtr/nrtr_modality_transform_academic.py', 160),
    'nrtr_r31_1by16': (
        'configs/textrecog/nrtr/nrtr_r31_1by16_1by8_academic.py', 160),
    'nrtr_r31_1by8': (
        'configs/textrecog/nrtr/nrtr_r31_1by8_1by4_academic.py', 160)}
B_TF_TRAIN, B_TF_F32, TF_F32_ATOL = 64, 8, 1e-4
B_TF_FALLBACK, TF_FALLBACK_WIDTH = 16, 2080
# the segmentation recognizer and the image-space preprocessors: SegOCR's
# config, the float32 batch held against the CPU (TF32 off) and its bounds
# (logits relative to their largest; the check step's loss and grad norm,
# as SAR's), its optimizer (the toy config's); MORAN in front of CRNN,
# SPIN in front of ABINet + TPS++ (its fc2 drawn at this scale, off the
# near-identity start), and the preprocessors' training batch
SEG_CONFIG = 'configs/textrecog/seg/seg_r31_1by16_fpnocr_academic.py'
B_SEG_F32, SEG_F32_RTOL = 8, 1e-4
SEG_LOSS_RTOL, SEG_GRAD_NORM_RTOL = 1e-4, 1e-3
SEG_OPT = dict(type='Adam', lr=1e-4)
CRNN_CONFIG = 'configs/textrecog/crnn/crnn_academic_dataset.py'
MORAN_PRE = dict(type='MORAN', num_img_channel=1, img_size=(32, 100))
SPIN_FC2_SCALE, B_PRE_TRAIN = 0.05, 64
# text detection: the two DBNet configs with their timing batches; the
# float32 batch held against the CPU and its bound (TF32 off): on the CPU
# the seed-0 maps of both configs at 640 x 640 lie within 4.3e-6 of their
# float64 values (the binary channel, which scales P - T by k / 4 = 12.5;
# 3.6e-7 on P and T), so two float32 roundings of them stay within 1e-4;
# the stress test's shares of pixels above the mask threshold, tried in
# turn until the float32 batch's map keeps DET_MIN_BOXES boxes (the seed-0
# map lies above it everywhere: one box an image); the trained-like maps:
# words a page, their height (px at 640 x 640), width over height and tilt
# (degrees), DB's shrink ratio; readtext's pages (h, w)
DET_CONFIGS = {
    'dbnet_r18': ('configs/textdet/dbnet/dbnet_r18_fpnc_1200e_icdar2015.py',
                  16),
    'dbnet_r50dcnv2': (
        'configs/textdet/dbnet/dbnet_r50dcnv2_fpnc_1200e_icdar2015.py', 8)}
B_DET_F32, DET_F32_ATOL = 2, 1e-4
DET_STRESS_ABOVE, DET_MIN_BOXES = (0.3, 0.4, 0.5, 0.6, 0.7), 10
DET_WORDS, DET_WORD_H, DET_WORD_ASPECT, DET_WORD_TILT, DB_SHRINK = (
    (10, 40), (8, 24), (1.5, 6.0), 20.0, 0.4)
N_PAGES, PAGE_HW = 4, (480, 640)
# PANet and PSENet serving (config, batch); the postprocessors' trained-like
# maps a config; the stress test: the head's text and kernel logits scaled
# to PAN_PSE_STRESS_STD times their std and shifted so that a share of
# their pixels lies above 0 (text, then the kernels down to the last share:
# random weights give one region an image); the one-step check's configs
# (card against the CPU at B_DET_F32, bounds relative, as SAR's);
# train_detector's config, pages and epochs
PAN_PSE_CONFIGS = {
    'panet_r18': ('configs/textdet/panet/panet_r18_fpem_ffm_600e_icdar2015.py',
                  16),
    'psenet_r50': ('configs/textdet/psenet/psenet_r50_fpnf_600e_icdar2015.py',
                   8)}
N_TRAINED_LIKE, PAN_PSE_STRESS_STD = 8, 4.0
PAN_PSE_STRESS = {'PANet': (0.05, 0.005), 'PSENet': (0.3, 0.05)}
DET_STEP_CONFIGS = {'dbnet_r18': DET_CONFIGS['dbnet_r18'][0],
                    'panet_r18': PAN_PSE_CONFIGS['panet_r18'][0],
                    'psenet_r50': PAN_PSE_CONFIGS['psenet_r50'][0]}
DET_LOSS_RTOL, DET_GRAD_NORM_RTOL = 1e-4, 1e-3
N_DET_TRAIN_PAGES, DET_TRAIN_EPOCHS = 32, 2
# FCENet and TextSnake (config, batch, the test pipeline's img_scale (h,
# w): TextSnake's 1333 padded to a multiple of 32, as its pipeline's Pad
# does); their card-vs-CPU bound, relative to each output's largest
# magnitude; the logit margin that quiets FCENet's random text classes
# (seed-0 weights put thousands of p3 pixels above score_thr, and
# poly_nms, exact polygon IoUs in Python, then takes minutes a page), also
# the bisection's range; the stressed map of the card-vs-CPU check: the
# share of pixels its bisection aims to pass the first threshold, the
# shares it must reach, the least FCENet polygons compared (and trained-
# like outputs of both), the share of TextSnake's boundaries that may
# part, the px its radii are raised by (fce_ts_card_checks); the
# words of FCENet's trained-like pages (each word costs about ten
# polygon IoUs of ~0.5 s) and their count; TextSnake's trained-like maps;
# the pixels readtext's FCENet leaves above score_thr on its pages;
# train_detector's pages and epochs on FCENet-R50
FCE_TS_CONFIGS = {
    'fcenet_r50_ic15': (
        'configs/textdet/fcenet/fcenet_r50_fpn_1500e_icdar2015.py', 8,
        (2260, 2260)),
    'fcenet_r50dcnv2_ctw': (
        'configs/textdet/fcenet/fcenet_r50dcnv2_fpn_1500e_ctw1500.py', 8,
        (736, 1080)),
    'textsnake_r50_ctw': (
        'configs/textdet/textsnake/textsnake_r50_fpn_unet_1200e_ctw1500.py',
        4, (736, 1344))}
FCE_TS_F32_RTOL, FCE_QUIET, FCE_READ_PIXELS = 1e-5, 30.0, 8
FCE_TS_STRESS, FCE_TS_STRESS_SHARES, FCE_TS_MIN_COMPARED = 0.5, (0.3, 0.7), 10
TS_STRESS_PART, TS_STRESS_RADIUS = 0.1, 8.0
FCE_WORDS, N_FCE_TRAINED_LIKE, N_TS_TRAINED_LIKE = (1, 1), 1, 4
N_FCE_TRAIN_PAGES, FCE_TRAIN_EPOCHS = 16, 2
# DRRG (config, serving batch, the test pipeline's img_scale (h, w)); the
# card-vs-CPU bounds of the features and maps and of the GCN's logits,
# relative to their largest magnitude; the margin that quiets the seed-0
# text logits (random weights pass most pixels, and the skeleton of a
# page-sized region would take poly_nms hours); the bias added to the
# GCN's class-1 logit where links must form (random weights rarely reach
# link_thr 0.8; exp stays finite), the distance from link_thr within which
# a link decision counts as a tie; the words of a trained-like page and
# the pages; the least boundaries compared card against CPU; training's
# pages and epochs; the pixels readtext's DRRG leaves past the first
# decision
DRRG_CONFIG = 'configs/textdet/drrg/drrg_r50_fpn_unet_1200e_ctw1500.py'
B_DRRG, DRRG_TEST_SCALE = 8, (640, 1024)
DRRG_F32_RTOL, DRRG_QUIET = 1e-5, 30.0
DRRG_LINK_BIAS, DRRG_LINK_MARGIN = 8.0, 1e-4
DRRG_WORDS, N_DRRG_TRAINED_LIKE, DRRG_MIN_COMPARED = (2, 4), 4, 2
N_DRRG_TRAIN_PAGES, DRRG_TRAIN_EPOCHS, DRRG_READ_PIXELS = 4, 2, 400
# Mask R-CNN (config, serving batch, page size, the CTW1500 config's test
# scale (h, w)); the card-vs-CPU bound of the levels, RPN maps, pooled
# RoIs and the heads' outputs, relative to their largest magnitude; the distance from
# a threshold within which a decision counts as a tie (scores, IoUs, mask
# probabilities, the RoI level's log2), and in px for the paste's integer
# box corners (results may part only where one lies so near); the least
# boundaries compared equal; the text bias added to the
# box head's fc_cls (random weights score most RoIs near 0.5) and the
# scale of conv_logits' weights (random masks sit near 0.5 everywhere)
# where boundaries are compared; training's pages and epochs; readtext's
# pages
MASKRCNN_CONFIG = ('configs/textdet/maskrcnn/'
                   'mask_rcnn_r50_fpn_160e_icdar2015.py')
B_MASKRCNN, MASKRCNN_HW, MASKRCNN_TEST_SCALE = 8, (640, 640), (1600, 1600)
MASKRCNN_F32_RTOL, MASKRCNN_TIE, MASKRCNN_TIE_PX = 1e-5, 1e-4, 1e-3
MASKRCNN_MIN_COMPARED, MASKRCNN_CLS_BIAS, MASKRCNN_MASK_SCALE = 10, 4.0, 8.0
N_MASKRCNN_TRAIN_PAGES, MASKRCNN_TRAIN_EPOCHS = 4, 2
# KIE and NER: the shipped configs; the receipts' boxes and characters, a
# sentence's characters; the batches (the configs' samples_per_gpu, and
# BERT's card-vs-CPU batch); the card-vs-CPU bounds (of each output's
# largest magnitude), the distance from edge_thr within which an openset
# link counts as a tie, BERT's argmax near-tie; training's receipts and
# sentences (NER's test set half as many more), epochs; the shares of DB's
# map put above its threshold for readtext, and the boxes a page it keeps
KIE_NER_CONFIGS = {
    'unet16': 'configs/kie/sdmgr/sdmgr_unet16_60e_wildreceipt.py',
    'novisual': 'configs/kie/sdmgr/sdmgr_novisual_60e_wildreceipt.py',
    'openset': 'configs/kie/sdmgr/sdmgr_novisual_60e_wildreceipt_openset.py',
    'ner': 'configs/ner/bert_softmax/bert_softmax_cluener_18e.py'}
KIE_NODES, KIE_CHARS, NER_LEN = 64, 32, 128
B_KIE, B_NER, B_NER_F32 = 4, 8, 2
KIE_F32_RTOL, NER_F32_RTOL, OPENSET_TIE, NER_TIE = 1e-5, 1e-4, 1e-4, 1e-4
N_RECEIPTS, N_SENTENCES, KIE_NER_EPOCHS = 8, 16, 2
KIE_DB_ABOVE, KIE_MIN_BOXES = (0.05, 0.1, 0.2, 0.3, 0.5), 4
# SDMGR's f32 step: the leaves downstream of BlockFusion (their gradients
# do not pass through its signed square root), their grad norms held card
# against CPU; the card's f32 gradient norm may lie this many times as far
# from the CPU's float64 one as the CPU's own f32 one does (on an H100 at
# B=4: 1.02e-3 on its host, 2.75e-3 on the card; one ReLU flip in the GNN
# makes most of the gap: tools/torch_kie_precision.py --step)
KIE_DOWNSTREAM = ('head.edge_embed', 'head.gnn_layers', 'head.node_cls',
                  'head.edge_cls')
KIE_F32_GRAD_MULT = 3
# deployment: the crops the server answers (each raw and as base64), the
# bound on a served score against model_inference's on the same array, on
# a served boundary's values against detect's (the same forward twice)
DEPLOY_CROPS, DEPLOY_SCORE_ATOL, DEPLOY_BOX_ATOL = 16, 1e-6, 1e-3
# the crops of the TPSPACK1 round trip through eval_recognizer
PACKED_CROPS = 12


def log(*a):
    print(*a, flush=True)


def card():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls=20, reps=5):
    """Device milliseconds of one ``fn()`` call: ``calls`` calls captured
    in one CUDA graph and replayed ``reps`` times between CUDA events, so
    that the host's cost of a call (Python, the wrapper's checks, the
    launch) is not in it, as it is in ``cuda_ms`` where a call is short.
    ``fn`` may be a list of calls, captured in turn (``calls`` at least as
    many): the same call on copies of its inputs and outputs that together
    exceed the L2 cache (``cold_copies``) finds them cold."""
    import torch
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    calls = max(calls, len(fns))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            for f in fns:
                f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode='relaxed'):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * calls)
    del graph
    return ms


def rotated(fn, sets):
    """Calls of ``fn`` on each argument tuple of ``sets``, for a cold
    reading by ``graph_ms``: each call's result is held in a slot of its
    own until the same set's next call, so the calls of one capture write
    outputs of their own too."""
    held = [None] * len(sets)

    def call(i):
        held[i] = fn(*sets[i])
    return [lambda i=i: call(i) for i in range(len(sets))]


def cold_copies(call_bytes):
    """How many copies of a call's inputs and outputs (``call_bytes``
    together) exceed twice the L2 cache, so that ``graph_ms`` over them
    reads each copy cold."""
    return int(math.ceil(2 * L2_BYTES / call_bytes)) + 1


def bound(nbytes, bf16_flops=0, f32_flops=0):
    """(least ms, what binds it) of work that moves ``nbytes`` and does
    ``bf16_flops`` on the tensor cores and ``f32_flops`` elsewhere."""
    mem = nbytes / PEAK_BYTES * 1e3
    ops = (bf16_flops / PEAK_BF16 + f32_flops / PEAK_F32) * 1e3
    return (mem, 'bytes') if mem >= ops else (ops, 'operations')


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def transformer_encoder_yardstick(enc, dtype):
    """One ``nn.TransformerEncoder`` with the weights of the port's
    ``NRTREncoder`` ``enc``: pre-norm layers, erf-GELU, the attention's
    biases zero (NRTR's projections have none), the final LayerNorm; in
    eval mode and ``dtype`` on enc's device. It computes kernel 3's
    function (the mask as ``src_key_padding_mask``, True where a key is
    masked) and is its library yardstick: timed beside it, never called by
    the port. Needs n_head * d_k == d_model, as nn.MultiheadAttention."""
    import torch
    from torch import nn
    first = enc.layer_stack[0]
    D = first.norm1.normalized_shape[0]
    te = nn.TransformerEncoder(
        nn.TransformerEncoderLayer(
            D, enc.n_head, first.mlp.w_1.out_features, dropout=0.0,
            activation='gelu', layer_norm_eps=1e-5, batch_first=True,
            norm_first=True),
        len(enc.layer_stack), norm=nn.LayerNorm(D, eps=1e-5),
        enable_nested_tensor=False)
    with torch.no_grad():
        for src, dst in zip(enc.layer_stack, te.layers):
            a = src.attn
            dst.self_attn.in_proj_weight.copy_(torch.cat(
                [a.linear_q.weight, a.linear_k.weight, a.linear_v.weight]))
            dst.self_attn.in_proj_bias.zero_()
            dst.self_attn.out_proj.weight.copy_(a.fc.weight)
            dst.self_attn.out_proj.bias.zero_()
            for d, m in ((dst.linear1, src.mlp.w_1), (dst.linear2,
                                                      src.mlp.w_2),
                         (dst.norm1, src.norm1), (dst.norm2, src.norm2)):
                d.weight.copy_(m.weight)
                d.bias.copy_(m.bias)
        te.norm.weight.copy_(enc.layer_norm.weight)
        te.norm.bias.copy_(enc.layer_norm.bias)
    return te.to(enc.layer_norm.weight.device, dtype).eval()


def first_divergence(kernel_probs, plain_probs):
    """Per row: (first step whose argmax differs or None, plain top-2 gap
    there)."""
    import torch
    ka, pa = kernel_probs.argmax(-1), plain_probs.argmax(-1)
    out = []
    for r in range(ka.shape[0]):
        diff = torch.nonzero(ka[r] != pa[r])
        if diff.numel() == 0:
            out.append((None, None))
            continue
        t = int(diff[0, 0])
        top2 = torch.topk(plain_probs[r, t].float(), 2).values
        out.append((t, float(top2[0] - top2[1])))
    return out


def check_decode(kernel_probs, plain_probs, what, near_tie=NEAR_TIE,
                 bound=None):
    """The decode rule; returns (max abs error on the agreeing prefix,
    number of rows that part at a near-tie, their largest top-2 gap).
    ``bound``: (atol, rtol) of the probabilities on the agreeing prefix,
    (DECODE_ATOL, DECODE_RTOL) when None."""
    atol, rtol = bound or (DECODE_ATOL, DECODE_RTOL)
    div = first_divergence(kernel_probs, plain_probs)
    err, ties, widest = 0.0, 0, 0.0
    for r, (t, gap) in enumerate(div):
        if t is not None:
            if not gap < near_tie:
                raise AssertionError(
                    f'{what}: row {r} parts from the plain path at step {t} '
                    f'with a top-2 gap of {gap:.3g} (>= {near_tie})')
            ties += 1
            widest = max(widest, gap)
        stop = kernel_probs.shape[1] if t is None else t
        k, p = kernel_probs[r, :stop].float(), plain_probs[r, :stop].float()
        if stop:
            err = max(err, float((k - p).abs().max()))
            bad = (k - p).abs() > atol + rtol * p.abs()
            if bool(bad.any()):
                raise AssertionError(f'{what}: row {r} probabilities beyond '
                                     f'atol {atol} rtol {rtol}')
    return err, ties, widest


def bf16_ulp_step(t, seed):
    """``t`` (bf16) with every value moved by one ulp, up or down at random
    (from ``seed``); a zero moves off 0 by the least subnormal."""
    import torch
    gen = torch.Generator(device=t.device).manual_seed(seed)
    step = torch.randint(0, 2, t.shape, generator=gen, device=t.device,
                         dtype=torch.int16) * 2 - 1
    step = torch.where(t == 0, torch.ones_like(step), step)
    return (t.contiguous().view(torch.int16) + step).view(torch.bfloat16)


def steps_tie_widths(r, img):
    """How far the bf16 ``steps`` decodes of ``r`` (a recognizer whose
    decoder has ``use_fused_step``) part from themselves on ``img``, each
    as (rows that part, widest top-2 gap of the plain side where they
    part), with the probabilities before that held to the decode rule:

    * ``module``: the module decode (no decode kernel) on the encodings of
      the sampler's kernel and of its plain version: the decode's own
      sensitivity to one bf16 ulp upstream;
    * ``kernels``: the fused step's kernels against their plain versions
      on one encoding (the sampler kernel's), so that the sampler drops
      out;
    * ``path``: the kernel path against the plain path, as ``predict``
      gives them with ``r.plain`` False and True.
    """
    import torch
    from tps_pp_tpu_torch.models.decoders import greedy_decode
    dec, lc, n = r.model.decoder, r.label_convertor, img.shape[0]
    with torch.inference_mode():
        ones = torch.ones(n, device=img.device)

        def decode(enc, plain):
            return greedy_decode(dec, enc, ones, max_seq_len=r.max_seq_len,
                                 start_idx=lc.start_idx,
                                 end_idx=lc.end_idx, plain=plain)
        enc_k, enc_p = (r.model.encode_full(img, ones, plain=p)[1]
                        for p in (False, True))
        out = dict(kernels=(decode(enc_k, False), decode(enc_k, True)))
        out['path'] = (out['kernels'][0], decode(enc_p, True))
        dec.use_fused_step = False
        try:
            out['module'] = (decode(enc_k, False), decode(enc_p, False))
        finally:
            dec.use_fused_step = True
    return {k: check_decode(a, b, f'steps_tie_widths {k}', near_tie=1.0)[1:]
            for k, (a, b) in out.items()}


def stem_tie_widths(r, img):
    """How far the ``fused40_bf16`` decode of ``r`` (bf16, the flagship's
    trunk) parts from itself on ``img`` around the fused stem, each as (rows
    that part, widest top-2 gap of the second side where they part), with
    the probabilities before that held to the decode rule:

    * ``module``: the module stem against the fused stem's plain version,
      the rest plain: the decode's sensitivity to the stem's bf16 rounding,
      which no kernel enters;
    * ``kernel``: the fused stem's kernels against their plain versions,
      the rest of the path on its kernels, so that only the stem differs;
    * ``path``: the kernel path against the plain path, both with the fused
      stem, as ``predict`` gives them with ``r.plain`` False and True.
    """
    import torch
    from tps_pp_tpu_torch.ops.stem import fused_stem_forward
    m, n = r.model, img.shape[0]
    end = r.label_convertor.end_idx if r.early_exit else None

    def decode(stem, plain, stem_plain=None):
        stem = None if stem == 'module' else fused_stem_forward(
            m.backbone, img, r.dtype, plain=stem_plain)
        return m.decode_full_fused(img, torch.ones(n, device=img.device),
                                   end_idx=end, plain=plain, stem=stem)

    with torch.inference_mode():
        fused_k, fused_p = (decode('fused', p, p) for p in (False, True))
        out = dict(module=(decode('module', True), fused_p),
                   kernel=(fused_k, decode('fused', False, True)),
                   path=(fused_k, fused_p))
    return {k: check_decode(a, b, f'stem_tie_widths {k}', near_tie=1.0)[1:]
            for k, (a, b) in out.items()}


def transformer_tie_widths(rec, x, v, what):
    """How far the whole decode of ``rec`` (bf16, a transformer-family
    model whose decoder has one) parts from itself on crops ``x`` (bf16)
    with valid ratios ``v``, each as (rows that part, widest top-2 gap of
    the second side where they part), with the probabilities before that
    held to the decode rule:

    * ``ulp``: the plain decode on the path's encoding against it on that
      encoding with every value one bf16 ulp away (``bf16_ulp_step``):
      the decode's own sensitivity to one rounding of its input;
    * ``kernel``: kernel 4 against its plain version on one encoding;
    * ``encoder``: the plain decode on the path's encoding against it on
      the encoder's run in float32, rounded to bf16: its sensitivity to
      the encoder's rounding, which the path's encoder changes.

    Returns (the widths, the path's encoding)."""
    import copy

    import torch
    m, end = rec.model, rec.label_convertor.end_idx
    fuses = getattr(type(m.encoder), 'SUPPORTS_FUSED_FORWARD', False)

    def decode(enc, plain):
        return m.decoder.fused_full_decode(enc, v, end_idx=end, plain=plain)
    with torch.inference_mode():
        feat = m.extract_feat(x)
        out_enc = (m.encoder(feat, v, fused=True) if fuses
                   else m.encode(feat, v))
        enc32 = copy.deepcopy(m.encoder).float()
        enc_f = enc32(feat.float(), v).to(torch.bfloat16)
        del enc32
        on_k = decode(out_enc, True)
        pairs = dict(ulp=(decode(bf16_ulp_step(out_enc, SEED), True), on_k),
                     kernel=(decode(out_enc, False), on_k),
                     encoder=(on_k, decode(enc_f, True)))
        return {k: check_decode(a, b, f'{what} {k}', near_tie=1.0)[1:]
                for k, (a, b) in pairs.items()}, out_enc


def check_close(what, got, want, bound):
    """Max abs error of ``got`` against ``want``; raises beyond
    ``bound`` = (atol, rtol)."""
    atol, rtol = bound
    got, want = got.float(), want.float()
    d = (got - want).abs()
    if got.shape != want.shape or bool(
            (d > atol + rtol * want.abs()).any()):
        raise AssertionError(f'{what}: max abs error {float(d.max())} beyond '
                             f'atol {atol} rtol {rtol}')
    return float(d.max())


def warp_inputs(dev, dtype, cot_scale, g):
    """The training warp at the flagship's training shapes: a
    (B_TRAIN, 32, 128, 64) map, a (B_TRAIN, 16, 64) grid over [-1.3, 1.3]^2
    (inside the map, on its clamped border and beyond it, exact pixel
    centres in the first row) and a cotangent of ``cot_scale``."""
    import numpy as np
    import torch
    img = g.uniform(-1, 1, (B_TRAIN, 32, 128, 64))
    grid = g.uniform(-1.3, 1.3, (B_TRAIN, 16, 64, 2))
    grid[:, 0, :, 0] = 2 * g.integers(1, 127, (B_TRAIN, 64)) / 127 - 1
    grid[:, 0, :, 1] = 2 * g.integers(1, 31, (B_TRAIN, 64)) / 31 - 1
    cot = cot_scale * g.uniform(-1, 1, (B_TRAIN, 16, 64, 64))
    return (torch.tensor(img, dtype=dtype, device=dev),
            torch.tensor(grid, dtype=torch.float32, device=dev),
            torch.tensor(cot, dtype=dtype, device=dev))


def warp_checks(dev, g, record, name):
    """Kernels 8, 9 and 10 against their plain versions in bf16 and f32;
    records them with their bf16 errors and times (the training path's
    dtype); times 9 and 10 on the [0, 1]^2 grid too, with their plan."""
    import numpy as np
    import torch
    from tps_pp_tpu_torch.ops.grid_sample import (
        grid_sample_forward, grid_sample_grad, grid_sample_grad_img,
        grid_sample_grad_img_plain, grid_sample_grad_plain,
        grid_sample_plain, grid_sample_plan)
    errs, timed = {}, None
    for dname in ('float32', 'bfloat16'):
        b = WARP_BOUNDS[dname]
        img, grid, cot = warp_inputs(dev, getattr(torch, dname),
                                     b['cot_scale'], g)
        out = grid_sample_forward(img, grid)
        d_img, d_grid = grid_sample_grad(grid, cot, img)
        d_img10 = grid_sample_grad_img(grid, cot, 32, 128)
        want_img, want_grid = grid_sample_grad_plain(grid, cot, img)
        want_img10 = grid_sample_grad_img_plain(grid, cot, 32, 128)
        torch.cuda.synchronize()
        if out.dtype != img.dtype or d_img.dtype != torch.float32 or \
                d_grid.dtype != torch.float32:
            raise AssertionError(f'grid_sample {dname}: output dtypes')
        errs[dname] = dict(
            fwd=check_close(f'grid_sample_forward {dname}', out,
                            grid_sample_plain(img, grid), b['fwd']),
            d_img=check_close(f'grid_sample_grad d_img {dname}', d_img,
                              want_img, b['d_img']),
            d_grid=check_close(f'grid_sample_grad d_grid {dname}', d_grid,
                               want_grid, b['d_grid']),
            d_img10=check_close(f'grid_sample_grad_img {dname}', d_img10,
                                want_img10, b['d_img']))
        log(f'grid_sample {dname}: max abs errors {errs[dname]} [{name}]')
        timed = (img, grid, cot)
    img, grid, cot = timed
    e = errs['bfloat16']
    src = 'tps_pp_tpu_torch/csrc/grid_sample.cu'
    # the library's sampler (ATen, NCHW views, a grid of the image's type):
    # the same bilinear, border, align_corners function
    img_l, cot_l = img.permute(0, 3, 1, 2), cot.permute(0, 3, 1, 2)
    grid_l = grid.to(img.dtype)
    taps = cot.numel() * 8                   # 4 taps, a multiply-add each
    d_img = nbytes(img) * 2                  # f32
    record('grid_sample_forward', src,
           'tps_pp_tpu/ops/pallas_grid_sample.py:126',
           lambda: grid_sample_forward(img, grid),
           lambda: grid_sample_plain(img, grid), e['fwd'], 20,
           nbytes(img, grid, cot), f32_flops=taps,
           fn_lib=lambda: torch.nn.functional.grid_sample(
               img_l, grid_l, mode='bilinear', padding_mode='border',
               align_corners=True))
    record('grid_sample_grad', src,
           'tps_pp_tpu/ops/pallas_grid_sample.py:283',
           lambda: grid_sample_grad(grid, cot, img),
           lambda: grid_sample_grad_plain(grid, cot, img),
           max(e['d_img'], e['d_grid']), 10,
           # d_grid is the grid's size
           nbytes(grid, cot, img, grid) + d_img, f32_flops=2 * taps,
           fn_lib=lambda: torch.ops.aten.grid_sampler_2d_backward(
               cot_l, img_l, grid_l, 0, 1, True, [True, True]))
    record('grid_sample_grad_img', src,
           'tps_pp_tpu/ops/pallas_grid_sample.py:178',
           lambda: grid_sample_grad_img(grid, cot, 32, 128),
           lambda: grid_sample_grad_img_plain(grid, cot, 32, 128),
           e['d_img10'], 10, nbytes(grid, cot) + d_img, f32_flops=taps,
           fn_lib=lambda: torch.ops.aten.grid_sampler_2d_backward(
               cot_l, img_l, grid_l, 0, 1, True, [True, False]))
    # TPS++ feeds a [0, 1]^2 grid to this [-1, 1] sampler: every sample in
    # the lower half of the rows, the upper half's bands empty
    plan = grid_sample_plan(B_TRAIN, 32, 128, 64)
    if grid_sample_grad.last_plan != plan or \
            grid_sample_grad_img.last_plan != plan:
        raise AssertionError(f'grid_sample plan {plan}, the kernels ran '
                             f'{grid_sample_grad.last_plan}, '
                             f'{grid_sample_grad_img.last_plan}')
    # (its own generator: the later phases draw the data they always drew)
    quad = torch.tensor(np.random.default_rng(SEED + 2).uniform(
        0, 1, tuple(grid.shape)), dtype=torch.float32, device=dev)
    b = WARP_BOUNDS['bfloat16']
    (d_img, d_grid), (want_img, want_grid) = (
        fn(quad, cot, img) for fn in (grid_sample_grad,
                                      grid_sample_grad_plain))
    errs = [check_close('grid_sample_grad d_img [0, 1]^2', d_img, want_img,
                        b['d_img']),
            check_close('grid_sample_grad d_grid [0, 1]^2', d_grid,
                        want_grid, b['d_grid']),
            check_close('grid_sample_grad_img [0, 1]^2',
                        grid_sample_grad_img(quad, cot, 32, 128),
                        grid_sample_grad_img_plain(quad, cot, 32, 128),
                        b['d_img'])]
    del d_img, want_img
    ms = [cuda_ms(fn, 10) for fn in (
        lambda: grid_sample_grad(quad, cot, img),
        lambda: grid_sample_grad_img(quad, cot, 32, 128))]
    log(f'grid_sample_grad / grid_sample_grad_img on the [0, 1]^2 grid: '
        f'{ms[0]:.4f} / {ms[1]:.4f} ms, max abs errors '
        f'{", ".join(f"{e:.4g}" for e in errs)}; band plan at B={B_TRAIN} '
        f'(rows a band, channels a slab, CTAs an SM, CTAs, shared memory '
        f'bytes a CTA): {plan} [{name}]')
    return img, grid, cot


def beam_phase(rec, img, name):
    """Beam search through ``TextRecognizer.predict`` on a float32 copy of
    ``rec`` whose decoder has ``use_fused_step`` (kernels 6 and 7 at
    B_BEAM * BEAM_W rows, the sampler's f32 variant), timed, then checked
    two ways on the same B_BEAM images:

    * step by step: the same ``beam_decode`` on the kernels, each step's
      probabilities against the plain step's on a copy of the same
      (reindexed) caches and tokens, within the decode rule's bounds;
    * end to end against the plain path: the best beam's tokens equal on
      every row, or the plain path's ranking had a near-tie (within
      BEAM_TIE) where a step's rounding can swap a beam: between its two
      best final totals, or at a step's cut between the last kept and the
      best dropped candidate. Such a row is printed."""
    import torch
    from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg
    from tps_pp_tpu_torch.models.decoders import beam_decode
    from tps_pp_tpu_torch.ops.decode_step import cross_ffn_step, self_attn_step
    from tps_pp_tpu_torch.ops.tps_sampler import tps_sampler
    cfg = nrtr_tps_pp_cfg(decode_mode='steps')
    cfg = dict(cfg, beam_width=BEAM_W, decoder=dict(cfg['decoder'],
                                                    use_fused_step=True))
    r = build_recognizer(cfg)
    r.model.load_state_dict(rec.model.state_dict())
    if r.beam_width != BEAM_W or r.resolved_decode_mode() != 'steps' or \
            r.dtype != torch.float32:
        raise AssertionError(f'beam: width {r.beam_width}, mode '
                             f'{r.resolved_decode_mode()}, {r.dtype}')
    im = img[:B_BEAM].to(torch.float32).contiguous()
    ones = torch.ones(B_BEAM, device=im.device)
    dec = r.model.decoder
    fns = (tps_sampler, self_attn_step, cross_ffn_step)
    step_err = [0.0]

    class Twin:
        """The decoder's kernel steps, each held against the plain step on
        a copy of its caches."""

        def decode_init(self, *a):
            return dec.decode_init(*a)

        def decode_step(self, token, t, carry, static, plain=False):
            copy = [tuple(c.clone() for c in layer) for layer in carry]
            want, _ = dec.decode_step(token, t, copy, static, plain=True)
            got, carry = dec.decode_step(token, t, carry, static)
            step_err[0] = max(step_err[0], check_close(
                f'beam step {t}', got, want, (DECODE_ATOL, DECODE_RTOL)))
            return got, carry

    def run(decoder, plain):
        with torch.inference_mode():
            _, enc = r.model.encode_full(im, ones, plain=plain)
            return beam_decode(
                decoder, enc, ones, max_seq_len=r.max_seq_len,
                start_idx=r.label_convertor.start_idx, beam_width=BEAM_W,
                length_norm=r.beam_length_norm, plain=plain,
                return_ranking=True)

    r.predict(im)                                 # warm
    for fn in fns:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pk = r.predict(im)
    torch.cuda.synchronize()
    ms_k = (time.perf_counter() - t0) * 1e3
    launches = {fn.__name__: fn.launches for fn in fns}
    if min(launches.values()) < 1:
        raise AssertionError(f'beam: a kernel did not launch: {launches}')
    t0 = time.perf_counter()
    pp, totals, cut = run(dec, True)
    torch.cuda.synchronize()
    ms_p = (time.perf_counter() - t0) * 1e3
    twin = run(Twin(), False)[0]
    if pk.shape != pp.shape or not bool(torch.isfinite(pk).all()):
        raise AssertionError(f'beam: bad output {tuple(pk.shape)}')
    same = (pk.argmax(-1) == pp.argmax(-1)).all(-1)
    near = torch.minimum(totals[:, 0] - totals[:, 1], cut.min(1).values)
    for row in torch.nonzero(~same).flatten().tolist():
        gap = float(near[row])
        if not gap < BEAM_TIE:
            raise AssertionError(f'beam: row {row} picks another best beam '
                                 f'than the plain path, whose ranking has no '
                                 f'near-tie ({gap:.4g} >= {BEAM_TIE})')
        log(f'beam: row {row} parts from the plain path; the plain '
            f'ranking\'s closest call {gap:.4g} (final totals '
            f'{float(totals[row, 0] - totals[row, 1]):.4g}, cut '
            f'{float(cut[row].min()):.4g} at step '
            f'{int(cut[row].argmin())}) < {BEAM_TIE}')
    k, p = pk[same], pp[same]
    if bool(((k - p).abs() > DECODE_ATOL + DECODE_RTOL * p.abs()).any()):
        raise AssertionError(f'beam: scores beyond atol {DECODE_ATOL} rtol '
                             f'{DECODE_RTOL}')
    log(f'beam B={B_BEAM} beam_width={BEAM_W}, float32, use_fused_step: '
        f'launches {launches}; each kernel step against the plain step on '
        f'its caches: max abs err {step_err[0]:.4g} (that run\'s tokens '
        f'equal to predict\'s on '
        f'{int((twin.argmax(-1) == pk.argmax(-1)).all(-1).sum())} rows); '
        f'best-beam tokens equal to the plain path on {int(same.sum())} of '
        f'{B_BEAM} rows, the rest at a near-tie; rows whose plain ranking '
        f'has one {int((near < BEAM_TIE).sum())}; max abs err on agreeing '
        f'rows {float((k - p).abs().max()):.4g}; {ms_k:.2f} ms kernel path '
        f'(predict), {ms_p:.2f} ms plain [{name}]')


def stem_checks(dev, g, record):
    """Kernels 11 and 12 against their plain versions: float32 on 8 images,
    then bf16 over the batch of B at the stem's shapes, timed; kernel 12
    at its three shapes (layer1's is listed), kernel 11 with the library's
    convolution beside it. Returns the launch count of kernel 11's run as
    an op."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from tps_pp_tpu_torch.ops.stem import (basic_block_cp,
                                           basic_block_cp_plain, conv3x3_cp,
                                           conv3x3_cp_plain, stem_plan)
    f32, bf = torch.float32, torch.bfloat16

    def inputs(cin, cmid, cout, n, H, W, dtype):
        """t (cin, n*H*W) in [-1, 1]; w1, wt with variance 1/fan_in;
        biases in [-0.5, 0.5], float32."""
        def r(*shape, scale=1.0, dt=dtype):
            return torch.from_numpy(g.uniform(-scale, scale, shape).astype(
                np.float32)).to(dev, dt)
        return (r(cin, n * H * W), r(cmid, cin, scale=(3 / cin) ** 0.5),
                r(cmid, 1, scale=0.5, dt=f32),
                r(cout, 9 * cmid, scale=(3 / (9 * cmid)) ** 0.5),
                r(cout, 1, scale=0.5, dt=f32))

    errs = {}
    for sname, (cin, cmid, cout, H, W, res) in STEM_SHAPES.items():
        a = inputs(cin, cmid, cout, 8, H, W, f32)
        errs[sname] = check_close(
            f'basic_block_cp float32 {sname}',
            basic_block_cp(*a, H=H, W=W, residual=res),
            basic_block_cp_plain(*a, H=H, W=W, residual=res),
            STEM_BOUNDS['float32'])
    x, _, _, w, b = inputs(32, 32, 32, 8, 32, 128, f32)
    errs['conv3x3_cp'] = check_close(
        'conv3x3_cp float32', conv3x3_cp(x, w, b, H=32, W=128, relu=True),
        conv3x3_cp_plain(x, w, b, H=32, W=128, relu=True),
        STEM_BOUNDS['float32'])
    log(f'stem kernels, float32 on 8 images: max abs errors {errs}')

    src, rep = 'tps_pp_tpu_torch/csrc/stem.cu', 'tps_pp_tpu/ops/pallas_stem.py'
    # kernel 11 as an op at the stem's width, (32, B*32*128) -> 32
    x, _, _, w, b = inputs(32, 32, 32, B, 32, 128, bf)
    conv3x3_cp.launches = 0
    out = conv3x3_cp(x, w, b, H=32, W=128)
    torch.cuda.synchronize()
    launches = conv3x3_cp.launches
    err = check_close('conv3x3_cp', out, conv3x3_cp_plain(x, w, b, H=32,
                                                          W=128),
                      STEM_BOUNDS['bfloat16'])
    # the library's convolution of the same function: NCHW channels-last
    # views of x, OIHW weights, a bf16 bias; never used by the port
    x_l = x.reshape(32, B, 32, 128).permute(1, 0, 2, 3).contiguous(
        memory_format=torch.channels_last)
    w_l = w.reshape(32, 3, 3, 32).permute(0, 3, 1, 2).contiguous()
    b_l = b[:, 0].to(bf)
    lib = F.conv2d(x_l, w_l, b_l, padding=1)
    lib_err = float((lib.permute(1, 0, 2, 3).reshape(32, -1).float() -
                     out.float()).abs().max())
    log(f'conv3x3_cp: launches {launches} as an op; the library '
        f'convolution parts from the kernel by {lib_err:.4g}')
    if launches != 1 or not lib_err <= 0.1:
        raise AssertionError(f'conv3x3_cp: launches {launches}, library '
                             f'error {lib_err}')
    P = x.shape[1]
    record('conv3x3_cp', src, rep + ':93',
           lambda: conv3x3_cp(x, w, b, H=32, W=128),
           lambda: conv3x3_cp_plain(x, w, b, H=32, W=128), err, 10,
           nbytes(x, w, b, out), bf16_flops=2 * P * 32 * 9 * 32,
           fn_lib=lambda: F.conv2d(x_l, w_l, b_l, padding=1))
    del x, w, b, out, x_l, lib

    # kernel 12 at the stem's three shapes over the batch of B, each with
    # the plan of its band walk on this card
    log(f'conv3x3_cp plan at B={B}: '
        f'{stem_plan(32, 32, 32, B, 32, 128, block=False)}')
    for sname, (cin, cmid, cout, H, W, res) in STEM_SHAPES.items():
        log(f'basic_block_cp {sname} plan at B={B} (R output rows a group, '
            f'NR ring slots, blocks, shared memory bytes a block): '
            f'{stem_plan(cin, cmid, cout, B, H, W)}')
        a = inputs(cin, cmid, cout, B, H, W, bf)
        got = basic_block_cp(*a, H=H, W=W, residual=res)
        err = check_close(f'basic_block_cp {sname}', got,
                          basic_block_cp_plain(*a, H=H, W=W, residual=res),
                          STEM_BOUNDS['bfloat16'])
        P = a[0].shape[1]
        record('basic_block_cp', src, rep + ':174',
               lambda a=a, H=H, W=W, res=res: basic_block_cp(
                   *a, H=H, W=W, residual=res),
               lambda a=a, H=H, W=W, res=res: basic_block_cp_plain(
                   *a, H=H, W=W, residual=res), err, 5, nbytes(*a, got),
               bf16_flops=2 * P * (cmid * cin + cout * 9 * cmid),
               listed=sname == 'layer1', label=f'basic_block_cp {sname}')
        del a, got
    return launches


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp(min=1e-30))


def train_slice(dev, g, name, warp_args):
    """The training path of the full-width flagship; returns the launch
    counts of the warp kernels in its runs."""
    import copy

    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import (FLAGSHIP_INPUT, build_recognizer,
                                       nrtr_tps_pp_cfg)
    from tps_pp_tpu_torch.ops.grid_sample import (
        GridSampleFunction, grid_sample_forward, grid_sample_grad,
        grid_sample_grad_img, grid_sample_grad_img_plain)
    from tps_pp_tpu_torch.parallel import build_optimizer, make_train_step
    warps = (grid_sample_forward, grid_sample_grad, grid_sample_grad_img)

    def recognizer(dropout, dtype='bfloat16'):
        cfg = nrtr_tps_pp_cfg(dtype=dtype)
        cfg = dict(cfg, encoder=dict(cfg['encoder'], dropout=dropout),
                   decoder=dict(cfg['decoder'], dropout=dropout))
        return build_recognizer(cfg, device=dev, param_dtype='float32')

    rec = recognizer(0.0).init_weights(SEED)
    state0 = copy.deepcopy(rec.model.state_dict())
    lc = rec.label_convertor
    chars = [c for c in lc.idx2char if len(c) == 1]
    texts = [''.join(g.choice(chars, int(g.integers(1, 26))))
             for _ in range(B_TRAIN)]
    h, w, c = FLAGSHIP_INPUT
    batch = dict(
        img=torch.from_numpy(g.standard_normal((B_TRAIN, h, w, c)).astype(
            np.float32)).to(dev),
        valid_ratio=g.uniform(0.5, 1.0, B_TRAIN).astype(np.float32),
        padded_targets=lc.str2tensor(texts)['padded_targets'])

    def step_fn(r):
        opt, _ = build_optimizer(TRAIN_OPT, r.model.named_parameters())
        return make_train_step(r, opt)

    # ---- check step: the same weights and batch on both paths, dropout 0.
    # In f32 compute the paths differ only by the kernels' rounding, and
    # all three checks hold. In bf16 compute the gradients of a randomly
    # initialised model are dominated by bf16 rounding amplified through
    # the trunk: one bf16 ulp of the warp's output moves them (kernel
    # against plain: cosine 0.92 over all parameters, 0.88-0.92 for
    # localization_fc2; kernel against kernel 1.0), so there the loss is
    # checked and the gradients are reported.
    loc_grads = {}
    for dtype in ('float32', 'bfloat16'):
        rec = recognizer(0.0, dtype)
        got = {}
        for plain in (False, True):
            rec.model.load_state_dict(state0)
            step = step_fn(rec)
            for fn in warps:
                fn.launches = 0
            m = step(batch, plain=plain)
            torch.cuda.synchronize()
            got[plain] = (float(m['loss']), float(m['grad_norm']),
                          rec.model.tpsnet.TPE.localization_fc2.weight.grad
                          .clone(), [fn.launches for fn in warps],
                          torch.cat([p.grad.flatten().float()
                                     for p in rec.model.parameters()]))
        (lk, nk, gk, ck, ak), (lp, np_, gp, cp, ap) = got[False], got[True]
        cos = cosine(gk, gp)
        loc_grads[dtype] = gk
        log(f'train check step, {dtype} compute: loss {lk:.6f} kernel / '
            f'{lp:.6f} plain; grad_norm {nk:.6f} / {np_:.6f}; '
            f'cos(d localization_fc2) {cos:.6f}, cos(all gradients) '
            f'{cosine(ak, ap):.6f}; warp launches kernel path {ck}, plain '
            f'path {cp} [{name}]')
        del ak, ap, got
        if not (np.isfinite(lk) and abs(lk - lp) <= LOSS_RTOL * abs(lp)):
            raise AssertionError(f'train {dtype}: loss {lk} vs plain {lp}')
        if ck[0] < 1 or ck[1] < 1 or any(cp):
            raise AssertionError(f'train {dtype}: warp launches {ck} kernel '
                                 f'path, {cp} plain path')
        if dtype == 'bfloat16':
            continue
        if not abs(nk - np_) <= GRAD_NORM_RTOL * abs(np_):
            raise AssertionError(f'train: grad_norm {nk} vs plain {np_}')
        if not cos >= GRAD_COS_MIN:
            raise AssertionError(f'train: cosine of the localization_fc2 '
                                 f'gradient {cos} < {GRAD_COS_MIN}')
    log(f'train check step, kernel path: cos(d localization_fc2) of bf16 '
        f'against f32 compute '
        f'{cosine(loc_grads["bfloat16"], loc_grads["float32"]):.6f} '
        f'[{name}]')
    del rec

    # ---- the training path: five steps with dropout 0.1 ---------------
    rec = recognizer(0.1)
    rec.model.load_state_dict(state0)
    step = step_fn(rec)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for fn in warps:
        fn.launches = 0
    losses = [float(step(batch, gen)['loss']) for _ in range(5)]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in warps}
    log(f'train: 5 steps, dropout 0.1, losses {losses}; warp launches '
        f'{launches} [{name}]')
    if not all(np.isfinite(losses)):
        raise AssertionError(f'train: non-finite loss {losses}')
    if launches['grid_sample_forward'] < 5 or \
            launches['grid_sample_grad'] < 5:
        raise AssertionError(f'train: warp kernels not launched {launches}')

    # ---- kernel 10 through the autograd function, grid detached --------
    img, grid, cot = warp_args
    img = img.detach().requires_grad_(True)
    for fn in warps:
        fn.launches = 0
    GridSampleFunction.apply(img, grid, False).backward(cot)
    torch.cuda.synchronize()
    counts = [fn.launches for fn in warps]
    if counts != [1, 0, 1]:
        raise AssertionError(f'detached grid: launches {counts}')
    check_close('GridSampleFunction d_img', img.grad,
                grid_sample_grad_img_plain(grid, cot, 32, 128).to(img.dtype),
                WARP_BOUNDS['bfloat16']['d_img'])
    launches['grid_sample_grad_img'] = counts[2]

    # ---- warm step time, the two paths in turns --------------------------
    times = {False: [], True: []}
    for plain in (False, True, False, True):
        step(batch, gen, plain=plain)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            loss = step(batch, gen, plain=plain)['loss']
        torch.cuda.synchronize()
        times[plain].append((time.perf_counter() - t0) / 3)
        if not bool(torch.isfinite(loss)):
            raise AssertionError('train: non-finite loss while timing')
    for plain, ts in times.items():
        log(f'train B={B_TRAIN} {"plain" if plain else "kernel"} path: '
            f'{min(ts) * 1e3:.2f} ms/step, {B_TRAIN / min(ts):.1f} images/s '
            f'(best of 2 rounds of 3 steps, dropout 0.1) [{name}]')
    return launches


def decode_flops(d, N, steps, TE):
    """(bf16, f32) operations of the whole greedy decode of ``N`` rows over
    ``steps`` steps: the encoder K/V projection, every step's matmuls and
    classifier, and the attention over t + 1 cached and TE encoder keys."""
    L, D, HD, DI, NC, H, DK = (d[k] for k in ('L', 'D', 'HD', 'DI', 'NC',
                                              'H', 'DK'))
    mm = 2 * N * TE * D * L * 2 * HD + steps * (
        2 * N * L * (D * 3 * HD + 3 * HD * D + 2 * D * DI) + 2 * N * D * NC)
    att = sum(4 * N * H * DK * L * (t + 1 + TE) for t in range(steps))
    return mm, att


def decode_graph_checks(w, out_enc, src_mask, lc):
    """The captured decode's exit and weight cache, bf16 and int8 encoder
    K/V: a classifier bias that makes EOS win ends the decode on the device
    after as many steps as the plain version runs (fewer than 40); a weight
    changed in place is served by the next replay (the graph reads it
    through its pointer: no new capture), and another tensor in a weight's
    place by a new capture, each against the plain version on the new
    weights."""
    import torch
    from tps_pp_tpu_torch.ops.full_decode import (full_decode,
                                                  full_decode_plain)
    w = {k: v.clone() for k, v in w.items()}
    bcls = w['bcls'].clone()
    w['bcls'][lc.end_idx] += 100.0
    for enc_dtype in ('bfloat16', 'int8'):
        args = (out_enc, src_mask, w, 8, lc.start_idx, lc.end_idx, enc_dtype)
        got = full_decode(*args)
        steps = full_decode.last_steps
        want = full_decode_plain(*args)
        ran = int((want.abs().sum((0, 2)) > 0).sum())
        check_decode(got, want, f'full_decode {enc_dtype} forced EOS')
        if not steps == ran < want.shape[1] or bool(
                (got[:, steps:] != 0).any()):
            raise AssertionError(f'full_decode {enc_dtype} forced EOS: '
                                 f'{steps} steps run, plain {ran}')
        log(f'full_decode {enc_dtype} forced EOS: {steps} steps run, plain '
            f'{ran}')
    w['bcls'].copy_(bcls)
    args = (out_enc, src_mask, w, 8, lc.start_idx, None)
    before = full_decode(*args)
    captures = full_decode.captures
    g = torch.Generator(device=out_enc.device).manual_seed(SEED)
    # noise at 0.3 of the weights' spread: the outputs move, the weights'
    # scale (at which the near-tie rule was set) stays within 5%
    with torch.no_grad():
        w['wcls'].add_((0.3 * w['wcls'].float().std() * torch.randn(
            w['wcls'].shape, generator=g, device=out_enc.device)).to(
            w['wcls'].dtype))
    got = full_decode(*args)
    err, ties, _ = check_decode(got, full_decode_plain(*args),
                                'full_decode after a weight change')
    if full_decode.captures != captures or torch.equal(got, before):
        raise AssertionError('full_decode: a weight changed in place was '
                             'not served by the replay')
    log(f'full_decode after an in-place weight change: replayed, {ties} '
        f'rows part from the plain version at a near-tie, max abs err '
        f'{err:.4g}')
    w['wfc2'] = w['wfc2'] + (0.3 * w['wfc2'].float().std() * torch.randn(
        w['wfc2'].shape, generator=g, device=out_enc.device)).to(
        w['wfc2'].dtype)
    again = full_decode(*args)
    err, ties, _ = check_decode(again, full_decode_plain(*args),
                                'full_decode after a weight replaced')
    if full_decode.captures != captures + 1 or torch.equal(again, got):
        raise AssertionError('full_decode: a weight replaced by another '
                             'tensor was not captured again')
    log(f'full_decode after a weight replaced by another tensor: '
        f'recaptured, {ties} rows part from the plain version at a '
        f'near-tie, max abs err {err:.4g}')


def same_upto_eos(probs, ref, end_idx):
    """``probs`` with every step after ``ref``'s first EOS of its row set to
    ``ref``'s: the convertor reads no step past EOS, and a decode of
    another batch size may stop earlier (the all-rows-EOS exit)."""
    import torch
    eos = ref.argmax(-1) == end_idx
    after = (torch.cumsum(eos.int(), 1) - eos.int()) > 0
    return torch.where(after[..., None], ref, probs)


def inference_api_phase(rec, name):
    """The user's entry points on the card: ``init_recognizer`` from the
    flagship's config file and a ``.pth``, ``model_inference`` on 512 uint8
    crops, ``eval_recognizer`` over them, and ``bench_torch.py``."""
    import logging
    import tempfile

    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import (eval_recognizer, init_recognizer,
                                       model_inference)
    from tps_pp_tpu_torch.config import load_config, merge_cli_options
    from tps_pp_tpu_torch.convertors import BaseConvertor
    from tps_pp_tpu_torch.datasets.pipelines.transforms import Compose
    from tps_pp_tpu_torch.evaluation import eval_ocr_metric
    from tps_pp_tpu_torch.ops.encoder import encoder_forward
    from tps_pp_tpu_torch.ops.full_decode import full_decode
    from tps_pp_tpu_torch.ops.tps_sampler import tps_sampler

    repo = os.path.dirname(os.path.abspath(__file__))
    counted = {'tps_sampler': tps_sampler, 'encoder': encoder_forward,
               'full_decode': full_decode}

    def zero():
        for fn in counted.values():
            fn.launches = 0

    def launches(what):
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in counted.items()}
        log(f'inference API, {what}: launches {got}')
        if min(got.values()) < 1:
            raise AssertionError(f'inference API, {what}: a kernel of the '
                                 f'path did not launch: {got}')
        return got

    # ---- a .pth of the seed-0 flagship (mmcv's wrapper, DDP prefixes),
    # loaded over seed-1 weights from the config file with model.dtype set
    sd = {k: v.detach().cpu() for k, v in rec.model.state_dict().items()}
    cfg = load_config(os.path.join(repo, 'configs/textrecog/nrtr/'
                                   'nrtr_tps++.py'))
    merge_cli_options(cfg, {'model.dtype': 'bfloat16'})
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, 'flagship.pth')
        torch.save({'meta': {}, 'state_dict': {
            f'module.{k}': v for k, v in sd.items()}}, pth)
        r = init_recognizer(cfg, pth, seed=1)
    if r.device.type != 'cuda' or r.resolved_decode_mode() != 'fused40_bf16':
        raise AssertionError(f'init_recognizer: {r.device}, '
                             f'{r.resolved_decode_mode()}')
    loaded = r.model.state_dict()
    if loaded.keys() != sd.keys() or not all(
            torch.equal(loaded[k].cpu(), v) for k, v in sd.items()):
        raise AssertionError('init_recognizer: the loaded weights are not '
                             'the written ones')
    log(f'inference API: init_recognizer(configs/textrecog/nrtr/'
        f'nrtr_tps++.py, .pth) with model.dtype=bfloat16 resolves to '
        f'{r.resolved_decode_mode()}, stem {r.resolved_stem_mode()}; '
        f'{len(sd)} tensors loaded as written')

    # ---- 512 uint8 BGR crops of assorted sizes through model_inference --
    g = np.random.default_rng(SEED)
    crops = [g.integers(0, 256, (int(g.integers(16, 65)),
                                 int(g.integers(24, 401)), 3), np.uint8)
             for _ in range(B)]
    lc = r.label_convertor
    zero()
    batched = model_inference(r, crops, batch_mode=True)
    launches(f'model_inference B={B}')
    pipeline = Compose([dict(type='LoadImageFromNdarray')] +
                       [dict(t) for t in r.test_pipeline_cfg[1:]])

    def host_batch(imgs):
        datas = [pipeline(dict(img=im, img_info=dict(filename=None)))
                 for im in imgs]
        return (np.stack([d['img'] for d in datas]).astype(np.float32),
                np.asarray([d['img_metas'].get('valid_ratio', 1.0) or 1.0
                            for d in datas], np.float32))

    img, vr = host_batch(crops)

    def texts(probs):
        idx, _ = lc.tensor2idx(probs.float().cpu().numpy())
        return lc.idx2str(idx)

    pk = r.predict(img, vr)
    r.plain = True
    pp = r.predict(img, vr)
    r.plain = False
    if tuple(pk.shape) != (B, r.max_seq_len, lc.num_classes() - 1) or \
            not bool(torch.isfinite(pk).all()):
        raise AssertionError(f'inference API: bad output {tuple(pk.shape)}')
    err, ties, widest = check_decode(pk, pp, 'inference API B=512')
    if texts(pk) != [x['text'] for x in batched]:
        raise AssertionError('model_inference: texts other than the '
                             'decode of predict on the pipeline batch')
    log(f'inference API B={B}: kernel path against the plain path on the '
        f'pipeline batch: {ties} rows part at a near-tie (top-2 gap at most '
        f'{widest:.3g} < {NEAR_TIE}); max abs err {err:.4g}; texts of '
        f'model_inference = decode of predict; first texts '
        f'{[x["text"] for x in batched[:3]]}')

    # ---- batch_mode=False (batches of 1) on the first 16 crops ----------
    n1 = 16
    alone = model_inference(r, crops[:n1], batch_mode=False)
    p1 = torch.cat([r.predict(img[i:i + 1], vr[i:i + 1])
                    for i in range(n1)])
    if texts(p1) != [x['text'] for x in alone]:
        raise AssertionError('model_inference batch_mode=False: texts other '
                             'than the decode of predict')
    err, ties, widest = check_decode(
        same_upto_eos(p1, pk[:n1], lc.end_idx), pk[:n1],
        'model_inference batch 1 vs B=512')
    same = sum(a['text'] == b['text'] for a, b in zip(alone, batched))
    log(f'inference API batch_mode=False, first {n1} crops: {same} of {n1} '
        f'texts equal to batch_mode=True\'s, {ties} part at a near-tie '
        f'(top-2 gap at most {widest:.3g}); max abs err {err:.4g}')

    # ---- eval_recognizer over the crops with random DICT90 labels -------
    class ArrayDataset:
        """The crops and their labels through the test pipeline."""

        def __init__(self, imgs, labels):
            self.imgs, self.labels = imgs, labels

        def __len__(self):
            return len(self.imgs)

        def __getitem__(self, i):
            return pipeline(dict(img=self.imgs[i], img_info=dict(
                filename=None, text=self.labels[i]), text=self.labels[i]))

        def evaluate(self, results, metric='acc'):
            return eval_ocr_metric([x['text'] for x in results],
                                   self.labels)

    chars = BaseConvertor.DICT90
    labels = [''.join(chars[int(i)] for i in g.integers(
        0, len(chars), int(g.integers(1, 26)))) for _ in range(B)]
    bs = 64
    kept = []   # eval_recognizer's own 'ms per image' line

    class Keep(logging.Handler):
        def emit(self, record):
            kept.append(record.getMessage())

    logger = logging.getLogger('tps_pp_tpu_torch')
    keep, level = Keep(), logger.level
    logger.addHandler(keep)
    logger.setLevel(logging.INFO)
    zero()
    try:
        t0 = time.perf_counter()
        metrics, results = eval_recognizer(r, ArrayDataset(crops, labels),
                                           batch_size=bs,
                                           return_results=True)
        t_eval = time.perf_counter() - t0
    finally:
        logger.removeHandler(keep)
        logger.setLevel(level)
    launches(f'eval_recognizer batch {bs}')
    want = eval_ocr_metric([x['text'] for x in batched], labels)
    if metrics != want:
        raise AssertionError(f'eval_recognizer: {metrics} != {want}')
    p64 = torch.cat([r.predict(img[i:i + bs], vr[i:i + bs],
                               bucket_batch=False) for i in range(0, B, bs)])
    if texts(p64) != [x['text'] for x in results]:
        raise AssertionError('eval_recognizer: texts other than the decode '
                             'of predict on its batches')
    err, ties, widest = check_decode(same_upto_eos(p64, pk, lc.end_idx), pk,
                                     f'eval batches of {bs} vs B=512')
    same = sum(a['text'] == b['text'] for a, b in zip(results, batched))
    log(f'inference API eval_recognizer ({B} crops, random DICT90 labels, '
        f'batch {bs}): {metrics} = eval_ocr_metric of model_inference\'s '
        f'texts; {same} of {B} texts equal, {ties} part at a near-tie (top-2 '
        f'gap at most {widest:.3g}); {t_eval * 1e3 / B:.3f} ms per image '
        f'wall (pipeline included), eval_recognizer\'s own log (predict and '
        f'its copy to the host): {kept} [{name}]')

    # ---- times: model_inference, the host pipeline alone, predict alone --
    def timed_call(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    calls = {'model_inference': lambda: model_inference(r, crops,
                                                        batch_mode=True),
             'host pipeline': lambda: host_batch(crops),
             'predict': lambda: r.predict(img, vr)}
    best = {k: [] for k in calls}
    for _ in range(2):
        for k, fn in calls.items():
            best[k].append(sum(timed_call(fn) for _ in range(3)) / 3)
    for k, ts in best.items():
        log(f'inference API B={B}, {k}: {min(ts) * 1e3:.2f} ms/batch, '
            f'{B / min(ts):.1f} images/s (best of 2 rounds of 3; the '
            f'rounds {", ".join(f"{t * 1e3:.2f}" for t in ts)} ms) [{name}]')
    del r, pk, pp, p1, p64
    torch.cuda.empty_cache()

    # ---- the bench twin ---------------------------------------------------
    out = subprocess.run([sys.executable, 'bench_torch.py'], cwd=repo,
                         env=dict(os.environ, BENCH_ITERS='3'),
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f'bench_torch.py exited {out.returncode}: '
                             f'{out.stderr[-2000:]}')
    line = out.stdout.strip().splitlines()[-1]
    bench = json.loads(line)
    if bench['decode_mode'] != 'fused40_bf16' or not (
            np.isfinite(bench['value']) and bench['value'] > 0):
        raise AssertionError(f'bench_torch.py: {line}')
    log(f'bench_torch.py (BENCH_ITERS=3): {line}')


class ArrayCrops:
    """Decoded uint8 crops and their labels through a pipeline: the
    training API phase's in-memory datasets, pickled into the loader's
    spawned workers."""

    def __init__(self, imgs, texts, pipeline):
        from tps_pp_tpu_torch.datasets.pipelines.transforms import Compose
        self.imgs, self.texts = imgs, texts
        self.pipeline = Compose(pipeline)

    def __len__(self):
        return len(self.imgs)

    def sample(self, i, key=None):
        from tps_pp_tpu_torch.datasets import seeded_rngs
        rngs = seeded_rngs(key) if key is not None else {}
        return self.pipeline(dict(img=self.imgs[i], text=self.texts[i],
                                  img_info=dict(filename=None), **rngs))

    def __getitem__(self, i):
        return self.sample(i)

    def evaluate(self, results, metric='acc'):
        from tps_pp_tpu_torch.evaluation import eval_ocr_metric
        return eval_ocr_metric([r['text'] for r in results], self.texts)


def train_api_phase(name):
    """``train_recognizer`` on the card: the flagship config's model and
    train pipeline, spawned workers, a world-1 NCCL group, checkpoints,
    the eval hook and resume (see the module docstring)."""
    import socket
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as tdist
    from tps_pp_tpu_torch.apis import build_recognizer, train_recognizer
    from tps_pp_tpu_torch.config import load_config, merge_cli_options
    from tps_pp_tpu_torch.convertors import BaseConvertor
    from tps_pp_tpu_torch.datasets import DataLoader
    from tps_pp_tpu_torch.ops.encoder import encoder_forward
    from tps_pp_tpu_torch.ops.full_decode import full_decode
    from tps_pp_tpu_torch.ops.grid_sample import (grid_sample_forward,
                                                  grid_sample_grad)
    from tps_pp_tpu_torch.ops.tps_sampler import tps_sampler
    from tps_pp_tpu_torch.parallel import (build_optimizer_from_run_cfg,
                                           dist, make_train_step,
                                           maybe_init_distributed,
                                           step_generator)
    from tps_pp_tpu_torch.tools.train import train_cfg_of
    from tps_pp_tpu_torch.utils.checkpoint import CheckpointManager

    repo = os.path.dirname(os.path.abspath(__file__))
    counted = {'grid_sample_forward': grid_sample_forward,
               'grid_sample_grad': grid_sample_grad,
               'tps_sampler': tps_sampler, 'encoder': encoder_forward,
               'full_decode': full_decode}
    cpus = os.cpu_count()
    workers = min(10, cpus - 1)
    log(f'training API: os.cpu_count() {cpus}, workers_per_gpu {workers}')

    # ---- a world-1 NCCL group -------------------------------------------
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    os.environ.update(RANK='0', LOCAL_RANK='0', WORLD_SIZE='1',
                      MASTER_ADDR='localhost', MASTER_PORT=str(port))
    dev = maybe_init_distributed()
    if not (dist.is_active() and dist.world_size() == 1
            and tdist.get_backend() == 'nccl'):
        raise AssertionError('training API: no world-1 NCCL group')

    # ---- the config's model and train pipeline, in-memory crops ----------
    cfg = load_config(os.path.join(repo, 'configs/textrecog/nrtr/'
                                   'nrtr_tps++.py'))
    merge_cli_options(cfg, {'model.dtype': 'bfloat16'})

    def ndarray_input(pipeline):
        steps = [dict(t) for t in pipeline]
        if steps[0]['type'] != 'LoadImageFromFile':
            raise AssertionError(f'pipeline starts with {steps[0]}')
        steps[0]['type'] = 'LoadImageFromNdarray'
        return steps

    g = np.random.default_rng(SEED)
    chars = BaseConvertor.DICT90

    def crops(n):
        imgs = [g.integers(0, 256, (int(g.integers(16, 65)),
                                    int(g.integers(24, 401)), 3), np.uint8)
                for _ in range(n)]
        texts = [''.join(chars[int(i)] for i in g.integers(
            0, len(chars), int(g.integers(1, 26)))) for _ in range(n)]
        return imgs, texts

    train_ds = ArrayCrops(*crops(N_TRAIN_CROPS),
                          ndarray_input(cfg['train_pipeline']))
    val_ds = ArrayCrops(*crops(N_VAL_CROPS),
                        ndarray_input(cfg['test_pipeline']))
    tcfg = train_cfg_of(cfg)
    tcfg.update(samples_per_gpu=B_TRAIN, workers_per_gpu=workers,
                total_epochs=TRAIN_EPOCHS, log_interval=1)
    steps_per_epoch = N_TRAIN_CROPS // B_TRAIN

    def recognizer():
        return build_recognizer(cfg['model'], dev, param_dtype='float32')

    def run(**kw):
        rec = recognizer()
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        opt, hist = train_recognizer(rec, train_ds, tcfg,
                                     val_dataset=val_ds, seed=SEED, **kw)
        torch.cuda.synchronize()
        return (rec, opt, hist, time.perf_counter() - t0,
                {k: fn.launches for k, fn in counted.items()})

    with tempfile.TemporaryDirectory() as wd:
        # ---- the uninterrupted run: 2 epochs, checkpoints, eval hook ---
        rec, opt, hist, wall, got = run(work_dir=wd)
        steps = [h for h in hist if 'loss' in h]
        epochs = [h for h in hist if 'seconds' in h]
        evals = [h['eval'] for h in hist if 'eval' in h]
        n_steps = TRAIN_EPOCHS * steps_per_epoch
        log(f'training API, train_recognizer: {len(steps)} steps, losses '
            f'{[round(h["loss"], 5) for h in steps]}, lr '
            f'{[h["lr"] for h in steps]}; evals {evals}; launches {got}; '
            f'{wall:.2f} s wall')
        if opt.count != n_steps or len(steps) != n_steps or not all(
                np.isfinite(h['loss']) for h in steps):
            raise AssertionError(f'training API: {opt.count} steps, losses '
                                 f'{[h["loss"] for h in steps]}')
        if got['grid_sample_forward'] != n_steps or \
                got['grid_sample_grad'] != n_steps:
            raise AssertionError(f'training API: kernels 8 and 9 not '
                                 f'launched on every step: {got}')
        if min(got[k] for k in ('tps_sampler', 'encoder',
                                'full_decode')) < TRAIN_EPOCHS or \
                len(evals) != TRAIN_EPOCHS:
            raise AssertionError(f'training API: the eval hook did not run '
                                 f'on kernels 1, 3 and 4: {got}, {evals}')
        files = sorted(os.listdir(wd))
        if files != [f'epoch_{e + 1}.pth' for e in range(TRAIN_EPOCHS)]:
            raise AssertionError(f'training API: checkpoints {files}')
        for e in epochs:
            log(f'training API epoch {e["epoch"]}: {e["images"]} images in '
                f'{e["seconds"]:.3f} s, {e["images"] / e["seconds"]:.1f} '
                f'images/s end to end; waited on the loader '
                f'{e["loader_wait"]:.3f} s, idle share '
                f'{e["loader_wait"] / e["seconds"]:.3f} [{name}]')

        # ---- resume from epoch 1's .pth: epoch 2 again ------------------
        _, opt2, hist2, _, got2 = run(
            work_dir=os.path.join(wd, 'resumed'),
            resume_from=os.path.join(wd, 'epoch_1.pth'))
        again = [h for h in hist2 if 'loss' in h]
        last = steps[steps_per_epoch:]
        gap = max(abs(a['loss'] - b['loss']) / abs(b['loss'])
                  for a, b in zip(again, last))
        log(f'training API, resumed from epoch_1.pth: {len(again)} steps, '
            f'count {opt2.count}, lr {[h["lr"] for h in again]}, losses '
            f'{[round(h["loss"], 5) for h in again]}; largest relative gap '
            f'to the uninterrupted epoch 2: {gap:.3g} (LOSS_RTOL '
            f'{LOSS_RTOL}); launches {got2}')
        if opt2.count != opt.count or len(again) != len(last) or \
                [h['lr'] for h in again] != [h['lr'] for h in last] or \
                [h['iter'] for h in again] != [h['iter'] for h in last]:
            raise AssertionError('training API: the resumed run is not '
                                 'epoch 2 of the uninterrupted one')
        if not gap <= LOSS_RTOL:
            raise AssertionError(f'training API: resumed losses part by '
                                 f'{gap} > {LOSS_RTOL}')

        # ---- resume of the finished job: nothing left --------------------
        _, opt3, hist3, _, _ = run(resume_from=wd)
        if opt3.count != opt.count or any('loss' in h for h in hist3):
            raise AssertionError(f'training API: a finished job replayed '
                                 f'{opt3.count - opt.count} steps')
        log(f'training API: resume of the finished job ran no step '
            f'(count {opt3.count})')

        # ---- the checkpoint: size and save time --------------------------
        mgr = CheckpointManager(os.path.join(wd, 'timed'))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = mgr.save(TRAIN_EPOCHS, rec.model, opt)
        t_save = time.perf_counter() - t0
        log(f'training API checkpoint: {os.path.getsize(path) / 2**20:.1f} '
            f'MiB, saved in {t_save:.3f} s [{name}]')

    # ---- the loader alone, with its workers ------------------------------
    loader = DataLoader(train_ds, B_TRAIN, shuffle=True, seed=SEED,
                        num_workers=workers, pin_memory=True)
    try:
        n_img = 0
        for epoch in range(3):
            loader.set_epoch(epoch)
            if epoch == 1:      # epoch 0 starts the workers
                t0 = time.perf_counter()
            for b in loader:
                n_img += (epoch > 0) * len(b['texts'])
        t_loader = time.perf_counter() - t0
    finally:
        loader.close()
    log(f'training API loader alone: {n_img} images in {t_loader:.3f} s, '
        f'{n_img / t_loader:.1f} images/s ({workers} workers, pinned) '
        f'[{name}]')

    # ---- the bare step at B=256 on a batch already on the card ----------
    rec = recognizer().init_weights(SEED)
    opt, _ = build_optimizer_from_run_cfg(
        tcfg, rec.model.named_parameters(), steps_per_epoch,
        TRAIN_EPOCHS)
    step = make_train_step(rec, opt)
    host = next(iter(DataLoader(train_ds, B_TRAIN, shuffle=True,
                                seed=SEED)))
    batch = dict(img=torch.as_tensor(host['img']).to(dev),
                 valid_ratio=torch.as_tensor(host['valid_ratio']).to(dev),
                 padded_targets=rec.label_convertor.str2tensor(
                     host['texts'])['padded_targets'])
    ts = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(batch, step_generator(SEED + 1, i, dev))['loss'])
        ts.append(time.perf_counter() - t0)
    t_step = min(ts[2:])
    log(f'training API bare step B={B_TRAIN}: {t_step * 1e3:.2f} ms, '
        f'{B_TRAIN / t_step:.1f} images/s (best of 3 after 2, the metrics '
        f'read each step as train_recognizer does) [{name}]')
    del rec, opt, step, batch
    tdist.destroy_process_group()
    for k in ('RANK', 'LOCAL_RANK', 'WORLD_SIZE', 'MASTER_ADDR',
              'MASTER_PORT'):
        os.environ.pop(k)
    torch.cuda.empty_cache()


def check_logits(kernel, plain, what, near_tie):
    """The single-pass rule: the argmax of ``kernel`` (N, T, C) logits
    equals ``plain``'s at every position but where the plain top-2 logit
    gap is below ``near_tie``. Returns (max abs logit error, positions
    that part, their widest plain gap)."""
    import torch
    kernel, plain = kernel.float(), plain.float()
    top2 = torch.topk(plain, 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    part = kernel.argmax(-1) != plain.argmax(-1)
    widest = float(gap[part].max()) if bool(part.any()) else 0.0
    if not widest < near_tie and bool(part.any()):
        raise AssertionError(f'{what}: {int(part.sum())} positions part from '
                             f'the plain path, one at a top-2 logit gap of '
                             f'{widest:.4g} (>= {near_tie:.4g})')
    return float((kernel - plain).abs().max()), int(part.sum()), widest


def launch_counters():
    """Each kernel wrapper's launch count, by the name of its kernel."""
    from tps_pp_tpu_torch.ops.decode_step import (cross_ffn_step,
                                                  self_attn_step)
    from tps_pp_tpu_torch.ops.encoder import encoder_forward
    from tps_pp_tpu_torch.ops.full_decode import full_decode
    from tps_pp_tpu_torch.ops.grid_sample import (grid_sample_forward,
                                                  grid_sample_grad,
                                                  grid_sample_grad_img)
    from tps_pp_tpu_torch.ops.stem import basic_block_cp, conv3x3_cp
    from tps_pp_tpu_torch.ops.tps_sampler import tps_sampler
    return {'tps_sampler': lambda: tps_sampler.launches,
            'tps_sampler_twostage': lambda: tps_sampler.launches_twostage,
            'encoder': lambda: encoder_forward.launches,
            'full_decode': lambda: full_decode.launches,
            'full_decode_int8': lambda: full_decode.launches_int8,
            'self_attn_step': lambda: self_attn_step.launches,
            'cross_ffn_step': lambda: cross_ffn_step.launches,
            'grid_sample_forward': lambda: grid_sample_forward.launches,
            'grid_sample_grad': lambda: grid_sample_grad.launches,
            'grid_sample_grad_img': lambda: grid_sample_grad_img.launches,
            'conv3x3_cp': lambda: conv3x3_cp.launches,
            'basic_block_cp': lambda: basic_block_cp.launches}


def zero_launches():
    """Every wrapper's launch count set to 0."""
    from tps_pp_tpu_torch.ops.decode_step import (cross_ffn_step,
                                                  self_attn_step)
    from tps_pp_tpu_torch.ops.encoder import encoder_forward
    from tps_pp_tpu_torch.ops.full_decode import full_decode
    from tps_pp_tpu_torch.ops.grid_sample import (grid_sample_forward,
                                                  grid_sample_grad,
                                                  grid_sample_grad_img)
    from tps_pp_tpu_torch.ops.stem import basic_block_cp, conv3x3_cp
    from tps_pp_tpu_torch.ops.tps_sampler import tps_sampler
    for fn in (tps_sampler, encoder_forward, full_decode, self_attn_step,
               cross_ffn_step, grid_sample_forward, grid_sample_grad,
               grid_sample_grad_img, conv3x3_cp, basic_block_cp):
        fn.launches = 0
    tps_sampler.launches_twostage = full_decode.launches_int8 = 0


def read_launches(family, what, want):
    """The counts now; each kernel in ``want`` (name -> count, None for
    at least one) must match, every other must be 0. Returns the counts
    that are not 0."""
    import torch
    torch.cuda.synchronize()
    got = {k: f() for k, f in launch_counters().items()}
    bad = {k: n for k, n in got.items()
           if (k not in want and n) or (k in want and (
               n < 1 if want[k] is None else n != want[k]))}
    log(f'{family} {what}: launches {got}')
    if bad:
        raise AssertionError(f'{family} {what}: launches {bad} against '
                             f'{want}')
    return {k: n for k, n in got.items() if n}


def abinet_phase(dev, name):
    """The ABINet + TPS++ family on ``dev``, the card (see the module
    docstring): serving through kernel 1, the f32 model, the inference API
    and training through kernels 8 and 9. Returns the launch counts of its
    serving, inference API and training runs."""
    import copy
    import tempfile

    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import (ABINetRecognizer, build_recognizer,
                                       init_recognizer, model_inference)
    from tps_pp_tpu_torch.config import load_config, merge_cli_options
    from tps_pp_tpu_torch.datasets.pipelines.transforms import Compose
    from tps_pp_tpu_torch.parallel import (build_optimizer_from_run_cfg,
                                           make_train_step)
    from tps_pp_tpu_torch.tools.train import train_cfg_of

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    cfg_path = os.path.join(repo, ABINET_CONFIG)
    zero = zero_launches

    def read(what, want):
        return read_launches('abinet', what, want)

    def model_cfg(dtype, dropout=None):
        cfg = load_config(cfg_path)
        merge_cli_options(cfg, {'model.dtype': dtype})
        model = copy.deepcopy(dict(cfg['model']))
        if dropout is not None:
            model['encoder']['encoder']['dropout'] = dropout
            model['decoder']['dropout'] = dropout
        return cfg, model

    # ---- build: the config's model in bf16, seed-0 weights, on the card
    cfg, model = model_cfg('bfloat16')
    rec = build_recognizer(model, device=dev)
    if not isinstance(rec, ABINetRecognizer) or rec.device != dev \
            or rec.resolved_decode_mode() != 'single_pass':
        raise AssertionError(f'abinet: built {type(rec).__name__} on '
                             f'{rec.device}, {rec.resolved_decode_mode()}')
    rec.init_weights(SEED)
    lc = rec.label_convertor
    S, C = rec.max_seq_len, model['decoder']['num_chars']
    g = np.random.default_rng(SEED + 14)
    img = torch.from_numpy(g.standard_normal((B, 32, 128, 3)).astype(
        np.float32)).to(dev)

    # ---- serving, B=512 and B=5: kernel 1 only ---------------------------
    zero()
    pk = rec.predict(img)
    vr5 = np.array([1.0, 0.6, 0.85, 0.35, 1.0], np.float32)
    pk5 = rec.predict(img[:5], vr5)
    launches = {'serving': read('serving B=512 and B=5',
                                {'tps_sampler': 2})}
    zero()
    rec.plain = True
    pp, pp5 = rec.predict(img), rec.predict(img[:5], vr5)
    # the path's own spread from one upstream rounding, no kernel in it:
    # the plain path with the two-stage sampler's plain version (another
    # rounding of the same warp) against the dense one's
    tpsnet, sample_mode = rec.model.tpsnet, rec.model.tpsnet.sample_mode
    tpsnet.sample_mode = 'pallas'
    os.environ['TPS_SAMPLER_VARIANT'] = 'twostage'
    try:
        p2 = rec.predict(img)
    finally:
        tpsnet.sample_mode = sample_mode
        os.environ.pop('TPS_SAMPLER_VARIANT')
    rec.plain = False
    read('plain paths', {})
    if tuple(pk.shape) != (B, S, C) or not bool(torch.isfinite(pk).all()):
        raise AssertionError(f'abinet: bad output {tuple(pk.shape)}')
    _, n_spread, spread = check_logits(p2, pp, 'abinet spread', 1e9)
    near_tie = max(TIE_MULT * spread, NEAR_TIE)
    err, parts, widest = check_logits(pk, pp, 'abinet B=512', near_tie)
    err5, parts5, widest5 = check_logits(pk5, pp5, 'abinet B=5', near_tie)
    log(f'abinet serving: plain logits up to {float(pp.abs().max()):.4g} '
        f'in magnitude; the plain path with the two-stage sampler parts '
        f'from the dense one at {n_spread} of {B * S} positions, widest '
        f'top-2 logit gap {spread:.4g}: near-tie width {near_tie:.4g} '
        f'(TIE_MULT x that, >= {NEAR_TIE}); kernel path against plain path '
        f'B={B}: {parts} positions part (widest gap {widest:.4g}), max abs '
        f'logit error {err:.4g}; B=5 with mixed valid ratios: {parts5} part '
        f'(widest {widest5:.4g}), max abs error {err5:.4g}; first texts '
        f'{[x["text"] for x in rec.simple_test(img[:3])]} [{name}]')

    # ---- times: predict at B=512, kernel and plain paths in turns; the
    # stages by CUDA events -------------------------------------------------
    times = {False: [], True: []}
    for plain in (False, True, True, False):
        rec.plain = plain
        rec.predict(img)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            rec.predict(img)
        torch.cuda.synchronize()
        times[plain].append((time.perf_counter() - t0) / 3)
    rec.plain = False
    for plain, ts in times.items():
        log(f'abinet serving B={B} {"plain" if plain else "kernel"} path: '
            f'{B / min(ts):.1f} images/s ({min(ts) * 1e3:.2f} ms/batch, '
            f'best of 2 rounds of 3; the rounds '
            f'{", ".join(f"{t * 1e3:.2f}" for t in ts)} ms) [{name}]')
    m = rec.model
    with torch.inference_mode():
        x = img.to(torch.bfloat16)
        feat = m.extract_feat(x)
        out_enc = m.encoder(feat)

        def rounds():
            logits = out_enc['logits']
            for _ in range(m.iter_size):
                d = m.decoder(logits)
                logits = m.fuser(out_enc['feature'], d['feature'])['logits']
            return logits

        stages = {'extract_feat': lambda: m.extract_feat(x),
                  'vision model': lambda: m.encoder(feat),
                  f'{m.iter_size} LM + fuser rounds': rounds,
                  'forward_test_nar': lambda: m.forward_test_nar(x)}
        ms = {k: cuda_ms(fn, 5) for k, fn in stages.items()}
    log(f'abinet serving B={B} by stage (CUDA events, mean of 5): '
        + ', '.join(f'{k} {v:.3f} ms' for k, v in ms.items()) + f' [{name}]')
    del feat, out_enc, x

    # ---- a float32 model at B=8: the sampler kernel's f32 variant --------
    _, model32 = model_cfg('float32')
    r32 = build_recognizer(model32, device=dev)
    r32.model.load_state_dict(rec.model.state_dict())
    zero()
    lk = r32.predict(img[:B_SMALL])
    read(f'float32 B={B_SMALL}', {'tps_sampler': 1})
    r32.plain = True
    lp = r32.predict(img[:B_SMALL])
    err32, parts32, _ = check_logits(lk, lp, 'abinet float32', NEAR_TIE)
    if not err32 <= ABINET_F32_ATOL:
        raise AssertionError(f'abinet float32: logits part by {err32} > '
                             f'{ABINET_F32_ATOL}')
    log(f'abinet float32 B={B_SMALL}: kernel path against plain path, max '
        f'abs logit error {err32:.4g} (<= {ABINET_F32_ATOL}), {parts32} '
        f'positions part')
    del r32

    # ---- the inference API: .pth, init_recognizer, model_inference -------
    sd = {k: v.detach().cpu() for k, v in rec.model.state_dict().items()}
    crops = [g.integers(0, 256, (int(g.integers(16, 65)),
                                 int(g.integers(24, 401)), 3), np.uint8)
             for _ in range(N_ABINET_CROPS)]
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, 'abinet.pth')
        torch.save({'meta': {}, 'state_dict': sd}, pth)
        r = init_recognizer(cfg, pth, device=dev, seed=1)
    if not isinstance(r, ABINetRecognizer) or r.device != dev or \
            not all(torch.equal(v.cpu(), sd[k])
                    for k, v in r.model.state_dict().items()):
        raise AssertionError('abinet init_recognizer: not the written '
                             'weights on the card')
    zero()
    got = model_inference(r, crops, batch_mode=True)
    launches['inference API'] = read(
        f'model_inference on {N_ABINET_CROPS} crops', {'tps_sampler': 1})
    pipeline = Compose([dict(type='LoadImageFromNdarray')] +
                       [dict(t) for t in r.test_pipeline_cfg[1:]])
    batch = np.stack([pipeline(dict(img=c, img_info=dict(filename=None)))[
        'img'] for c in crops]).astype(np.float32)
    r.plain = True
    plain_res = model_inference(r, crops, batch_mode=True)
    lp = r.predict(batch)
    r.plain = False
    lk = r.predict(batch)

    def texts(logits):
        return lc.idx2str(lc.tensor2idx(logits.cpu().numpy())[0])

    if texts(lk) != [x['text'] for x in got] or \
            texts(lp) != [x['text'] for x in plain_res]:
        raise AssertionError('abinet model_inference: texts other than the '
                             'decode of predict on the pipeline batch')
    err, parts, widest = check_logits(lk, lp, 'abinet model_inference',
                                      near_tie)
    same = sum(a['text'] == b['text'] for a, b in zip(got, plain_res))
    log(f'abinet inference API: init_recognizer({ABINET_CONFIG}, .pth), '
        f'model_inference on {N_ABINET_CROPS} uint8 crops: {same} of '
        f'{N_ABINET_CROPS} texts equal to the plain path\'s, {parts} '
        f'positions part (widest gap {widest:.4g} < {near_tie:.4g}); first '
        f'texts {[x["text"] for x in got[:3]]}')
    del r, rec, m, pk, pp, p2, lk, lp
    torch.cuda.empty_cache()

    # ---- training: the config's Adam, f32 parameters, B=192 ------------
    tc = train_cfg_of(cfg)
    bt = int(tc['samples_per_gpu'])
    chars = lc.idx2char[:36]
    labels = [''.join(g.choice(chars, int(g.integers(1, 26))))
              for _ in range(bt)]
    td = lc.str2tensor(labels)
    tbatch = dict(
        img=torch.from_numpy(g.standard_normal((bt, 32, 128, 3)).astype(
            np.float32)).to(dev),
        valid_ratio=np.ones(bt, np.float32),
        padded_targets=td['padded_targets'],
        target_lengths=td['target_lengths'])

    def trainer(dtype, dropout=None):
        rt = build_recognizer(model_cfg(dtype, dropout)[1], device=dev,
                              param_dtype='float32')
        if dropout == 0.0:
            rt.model.decoder.token_encoder.dropout = 0.0
        return rt

    def step_fn(rt):
        opt, _ = build_optimizer_from_run_cfg(
            tc, rt.model.named_parameters(), steps_per_epoch=1,
            total_epochs=tc['total_epochs'])
        return make_train_step(rt, opt)

    rt = trainer('float32', 0.0).init_weights(SEED)
    state0 = copy.deepcopy(rt.model.state_dict())
    for dtype in ('float32', 'bfloat16'):
        if dtype == 'bfloat16':
            rt = trainer(dtype, 0.0)
        res = {}
        for plain in (False, True):
            rt.model.load_state_dict(state0)
            step = step_fn(rt)
            zero()
            mets = step(tbatch, plain=plain)
            n = read(f'train check step, {dtype} compute, '
                     f'{"plain" if plain else "kernel"} path',
                     {} if plain else {'grid_sample_forward': 1,
                                       'grid_sample_grad': 1})
            res[plain] = (float(mets['loss']), float(mets['grad_norm']),
                          rt.model.tpsnet.TPE.localization_fc2.weight.grad
                          .clone(), n)
        (lk_, nk, gk, _), (lp_, np_, gp, _) = res[False], res[True]
        cos = cosine(gk, gp)
        log(f'abinet train check step B={bt}, {dtype} compute: loss '
            f'{lk_:.6f} kernel / {lp_:.6f} plain; grad_norm {nk:.6f} / '
            f'{np_:.6f}; cos(d localization_fc2) {cos:.6f} [{name}]')
        if not (np.isfinite(lk_) and abs(lk_ - lp_) <= LOSS_RTOL * abs(lp_)):
            raise AssertionError(f'abinet train {dtype}: loss {lk_} vs '
                                 f'plain {lp_}')
        if dtype == 'float32' and not (
                abs(nk - np_) <= GRAD_NORM_RTOL * abs(np_)
                and cos >= GRAD_COS_MIN):
            raise AssertionError(f'abinet train: grad_norm {nk} vs {np_}, '
                                 f'cosine {cos}')
    del rt

    # ---- five steps with the config's dropout, then the step's time ----
    rt = trainer('bfloat16')
    rt.model.load_state_dict(state0)
    step = step_fn(rt)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    zero()
    losses = [float(step(tbatch, gen)['loss']) for _ in range(5)]
    launches['training'] = read('5 training steps', {
        'grid_sample_forward': 5, 'grid_sample_grad': 5})
    log(f'abinet train: 5 steps B={bt}, bf16 compute, dropout 0.1, losses '
        f'{losses}')
    if not all(np.isfinite(losses)):
        raise AssertionError(f'abinet train: non-finite loss {losses}')
    times = {False: [], True: []}
    for plain in (False, True, True, False):
        step(tbatch, gen, plain=plain)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            loss = step(tbatch, gen, plain=plain)['loss']
        torch.cuda.synchronize()
        times[plain].append((time.perf_counter() - t0) / 3)
        if not bool(torch.isfinite(loss)):
            raise AssertionError('abinet train: non-finite loss while '
                                 'timing')
    for plain, ts in times.items():
        log(f'abinet train B={bt} {"plain" if plain else "kernel"} path: '
            f'{min(ts) * 1e3:.2f} ms/step, {bt / min(ts):.1f} images/s (best '
            f'of 2 rounds of 3 steps; the rounds '
            f'{", ".join(f"{t * 1e3:.2f}" for t in ts)} ms) [{name}]')
    del rt, step
    torch.cuda.empty_cache()
    log(f'abinet phase: {time.perf_counter() - t_phase:.1f} s; launches '
        f'{json.dumps(launches)}')
    return launches


def crnn_tps_phase(dev, name, record):
    """The CTC family's CRNN-TPS on ``dev``, the card (see the module
    docstring): kernels 8, 9 and 10 at C = 1 (and C = 3) against their
    plain versions, recorded at the serving and training shapes; serving
    through kernel 8, the f32 model, the inference API, training through
    kernels 8 and 9, and the detached-grid backward through kernel 10.
    Returns the launch counts of the C = 1 entries."""
    import copy
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F
    from tps_pp_tpu_torch.apis import (TextRecognizer, build_recognizer,
                                       init_recognizer, model_inference)
    from tps_pp_tpu_torch.config import load_config, merge_cli_options
    from tps_pp_tpu_torch.datasets.pipelines.transforms import Compose
    from tps_pp_tpu_torch.ops.grid_sample import (
        GridSampleFunction, _gather_lerp, grid_sample_forward,
        grid_sample_fwd_plan, grid_sample_grad, grid_sample_grad_img,
        grid_sample_grad_img_plain, grid_sample_grad_plain,
        grid_sample_plain, grid_sample_plan)
    from tps_pp_tpu_torch.parallel import (build_optimizer_from_run_cfg,
                                           make_train_step)
    from tps_pp_tpu_torch.tools.train import train_cfg_of

    t_phase = time.perf_counter()
    cfg_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            CRNN_TPS_CONFIG)
    bf, f32 = torch.bfloat16, torch.float32

    def read(what, want):
        return read_launches('crnn_tps', what, want)

    def model_cfg(dtype):
        cfg = load_config(cfg_path)
        merge_cli_options(cfg, {'model.dtype': dtype})
        return cfg, copy.deepcopy(dict(cfg['model']))

    def random_fc2(r):
        """fc2's weights drawn at random (seeded, on the CPU)."""
        fc2 = r.model.preprocessor.LocalizationNetwork.localization_fc2
        gen = torch.Generator().manual_seed(SEED + 15)
        with torch.no_grad():
            fc2.weight.copy_(CRNN_FC2_SCALE * torch.randn(
                tuple(fc2.weight.shape), generator=gen))
        return r

    # ---- build: the config's model in bf16, seed-0 weights, fc2 random ---
    cfg, model = model_cfg('bfloat16')
    rec = build_recognizer(model, device=dev)
    if type(rec) is not TextRecognizer or rec.device != dev or \
            rec.resolved_decode_mode() != 'single_pass' or \
            rec.model.preprocessor is None or rec.model.encoder is not None:
        raise AssertionError(f'crnn_tps: built {type(rec).__name__} on '
                             f'{rec.device}, {rec.resolved_decode_mode()}')
    random_fc2(rec.init_weights(SEED))
    lc, m = rec.label_convertor, rec.model
    S, C = 26, lc.num_classes()
    g = np.random.default_rng(SEED + 15)
    img = torch.from_numpy(g.standard_normal((B, 32, 100, 1)).astype(
        np.float32)).to(dev)
    with torch.no_grad():
        grid = m.preprocessor.grid(img.to(bf))
    gx = (grid[..., 0] + 1) * 0.5 * 99
    gy = (grid[..., 1] + 1) * 0.5 * 31
    outside = float((grid.abs() > 1).any(-1).float().mean())
    centres = float((((gx - gx.round()).abs() < 1e-3) &
                     ((gy - gy.round()).abs() < 1e-3)).float().mean())
    log(f'crnn_tps: the serving grid (B={B}, 32 x 100, fc2 ~ '
        f'{CRNN_FC2_SCALE} N(0, 1)): {outside:.4f} of the samples beyond '
        f'[-1, 1] (clipped to the border), {centres:.4f} within 1e-3 px of '
        f'a pixel centre')
    if not outside > 0 or not centres < 0.5:
        raise AssertionError('crnn_tps: the grid tests too little of the '
                             'warp')

    # ---- kernels 8, 9 and 10 at C = 1 (the model's grids) and C = 3 ------
    src = 'tps_pp_tpu_torch/csrc/grid_sample.cu'

    def warp_check(x, gr, what):
        dname = 'bfloat16' if x.dtype == bf else 'float32'
        b = WARP_BOUNDS[dname]
        H, W = x.shape[1:3]
        cot = torch.from_numpy((b['cot_scale'] * g.uniform(
            -1, 1, tuple(x.shape))).astype(np.float32)).to(dev, x.dtype)
        out = grid_sample_forward(x, gr)
        d_img, d_grid = grid_sample_grad(gr, cot, x)
        d_img10 = grid_sample_grad_img(gr, cot, H, W)
        want_img, want_grid = grid_sample_grad_plain(gr, cot, x)
        tag = f'crnn_tps {what} {dname}'
        e = dict(
            fwd=check_close(f'{tag} forward', out, grid_sample_plain(x, gr),
                            b['fwd']),
            d_img=check_close(f'{tag} d_img', d_img, want_img, b['d_img']),
            d_grid=check_close(f'{tag} d_grid', d_grid, want_grid,
                               b['d_grid']),
            d_img10=check_close(f'{tag} d_img only', d_img10,
                                grid_sample_grad_img_plain(gr, cot, H, W),
                                b['d_img']))
        log(f'{tag}: max abs errors {e}; band plan '
            f'{grid_sample_plan(*x.shape)} [{name}]')
        return cot, e

    def crops(n, c):
        return torch.from_numpy(g.uniform(-1, 1, (n, 32, 100, c)).astype(
            np.float32)).to(dev)

    bt = int(train_cfg_of(cfg)['samples_per_gpu'])
    x_s, grid_t = crops(B, 1).to(bf), grid[:bt].contiguous()
    x_t = crops(bt, 1)
    errs = {}
    cots = {}
    for what, x, gr in (('serving B=512', x_s, grid),
                        (f'training B={bt}', x_t, grid_t)):
        for dt in (bf, f32):
            cots[what, dt], errs[what, dt] = warp_check(x.to(dt), gr, what)
    cot_t = cots[f'training B={bt}', f32]
    grid3 = g.uniform(-1.3, 1.3, (bt, 32, 100, 2))
    grid3[:, 0, :, 0] = 2 * g.integers(0, 100, (bt, 100)) / 99 - 1
    grid3[:, 0, :, 1] = 2 * g.integers(0, 32, (bt, 100)) / 31 - 1
    grid3 = torch.tensor(grid3, dtype=f32, device=dev)
    for dt in (bf, f32):
        warp_check(crops(bt, 3).to(dt), grid3, f'C = 3, B={bt}')
    e_s, e_t = errs['serving B=512', bf], errs[f'training B={bt}', f32]
    # the config's own initial warp, the traffic of the rows by CUDA graph:
    # fc2 at zero weights and the fiducial bias, as training starts (the
    # same grid for every crop; trained warps stay near it)
    pre0 = copy.deepcopy(m.preprocessor).float()
    pre0.reset_localization()
    with torch.no_grad():
        grid0 = pre0.grid(img[:bt]).contiguous()
    del pre0
    cot0, e0 = warp_check(x_t, grid0, f'initial grid, training B={bt}')
    taps_s, taps_t = grid.shape[0] * 3200 * 8, bt * 3200 * 8

    def aten_bwd(masks, gr, cot):
        x_l, c_l = x_t.permute(0, 3, 1, 2), cot.permute(0, 3, 1, 2)
        return lambda: torch.ops.aten.grid_sampler_2d_backward(
            c_l, x_l, gr, 0, 1, True, masks)

    record('grid_sample_forward_c1', src,
           'tps_pp_tpu/ops/pallas_grid_sample.py:126',
           lambda: grid_sample_forward(x_s, grid),
           lambda: grid_sample_plain(x_s, grid), e_s['fwd'], 50,
           # the image in, the grid, the warped image out
           nbytes(x_s, grid, x_s), f32_flops=taps_s,
           fn_lib=lambda: F.grid_sample(
               x_s.permute(0, 3, 1, 2), grid.to(bf), mode='bilinear',
               padding_mode='border', align_corners=True),
           label=f'grid_sample_forward C=1 bf16 B={B} (CRNN-TPS serving)')
    plan_t = grid_sample_plan(bt, 32, 100, 1)
    # kernels 9 and 10 by CUDA events on the random fc2's grid (the host
    # paces calls this short), then as device time by CUDA graph on the
    # config's initial grid, each beside ATen's timed the same way
    for sfx, graph, gr, cot, e, grid_name in (
            ('', False, grid_t, cot_t, e_t, 'random fc2 grid'),
            ('_graph', True, grid0, cot0, e0, 'initial grid')):
        how = 'CUDA graph' if graph else 'CUDA events'
        record(f'grid_sample_grad_c1{sfx}', src,
               'tps_pp_tpu/ops/pallas_grid_sample.py:283',
               lambda gr=gr, cot=cot: grid_sample_grad(gr, cot, x_t),
               lambda gr=gr, cot=cot: grid_sample_grad_plain(gr, cot, x_t),
               max(e['d_img'], e['d_grid']), 50,
               # grid, cotangent and image in; f32 d_img and d_grid out
               nbytes(gr, cot, x_t, x_t, gr), f32_flops=2 * taps_t,
               fn_lib=aten_bwd([True, True], gr, cot), graph=graph,
               label=f'grid_sample_grad C=1 f32 B={bt} (CRNN-TPS training; '
                     f'{grid_name}; {how}; cluster {plan_t["cluster"]}, '
                     f'plan {plan_t})')
        record(f'grid_sample_grad_img_c1{sfx}', src,
               'tps_pp_tpu/ops/pallas_grid_sample.py:178',
               lambda gr=gr, cot=cot: grid_sample_grad_img(gr, cot, 32, 100),
               lambda gr=gr, cot=cot: grid_sample_grad_img_plain(
                   gr, cot, 32, 100),
               e['d_img10'], 50, nbytes(gr, cot, x_t),
               f32_flops=taps_t, fn_lib=aten_bwd([True, False], gr, cot),
               graph=graph,
               label=f'grid_sample_grad_img C=1 f32 B={bt} (detached grid; '
                     f'{grid_name}; {how}; cluster {plan_t["cluster"]})')
    # kernel 8's calls are short enough for the host to pace them too: its
    # device time by CUDA graph at the serving batch (bf16) and in the
    # training forward (f32), warm and on inputs rotated past the L2 cache

    def aten_fwd(x, gr):
        return F.grid_sample(x.permute(0, 3, 1, 2), gr.to(x.dtype),
                             mode='bilinear', padding_mode='border',
                             align_corners=True)

    for sfx, x, gr, e, what in (
            ('', x_s, grid, e_s, f'bf16 B={B} (CRNN-TPS serving)'),
            ('_f32', x_t, grid_t, e_t, f'f32 B={bt} (CRNN-TPS training)')):
        moved = nbytes(x, gr, x)
        sets = [(x, gr)] + [(x.clone(), gr.clone())
                            for _ in range(cold_copies(moved) - 1)]
        record(f'grid_sample_forward_c1{sfx}_graph', src,
               'tps_pp_tpu/ops/pallas_grid_sample.py:126',
               lambda x=x, gr=gr: grid_sample_forward(x, gr),
               lambda x=x, gr=gr: grid_sample_plain(x, gr), e['fwd'], 20,
               moved, f32_flops=gr.shape[0] * 3200 * 8,
               fn_lib=lambda x=x, gr=gr: aten_fwd(x, gr), graph=True,
               cold=(rotated(grid_sample_forward, sets),
                     rotated(aten_fwd, sets)),
               label=f'grid_sample_forward C=1 {what}; CUDA graph, warm '
                     f'and over {len(sets)} copies cold; plan '
                     f'{grid_sample_fwd_plan(*x.shape, 3200, x.dtype)}')
        del sets
    del x_s, x_t, grid3, grid0

    # ---- serving, B=512 and B=5: kernel 8 only ---------------------------
    zero_launches()
    pk = rec.predict(img)
    vr5 = np.array([1.0, 0.6, 0.85, 0.35, 1.0], np.float32)
    pk5 = rec.predict(img[:5], vr5)
    launches = {'serving': read('serving B=512 and B=5',
                                {'grid_sample_forward': 2})}
    zero_launches()
    rec.plain = True
    pp, pp5 = rec.predict(img), rec.predict(img[:5], vr5)
    rec.plain = False
    # the path's own spread from one rounding of the warp, no kernel in it:
    # the plain path with the warp computed by the gather + lerp of the
    # plain backward (JAX's order of the f32 unnormalize and lerp) and
    # rounded to bf16 once, against ATen's f32 warp rounded once
    with torch.inference_mode():
        x = img.to(bf)
        warped = _gather_lerp(x.float(), grid).to(bf)
        p2 = m.decoder(m.backbone(warped), None).float()
    read('plain paths', {})
    if tuple(pk.shape) != (B, S, C) or not bool(torch.isfinite(pk).all()):
        raise AssertionError(f'crnn_tps: bad output {tuple(pk.shape)}')
    _, n_spread, spread = check_logits(p2, pp, 'crnn_tps spread', 1e9)
    near_tie = max(TIE_MULT * spread, NEAR_TIE)
    err, parts, widest = check_logits(pk, pp, 'crnn_tps B=512', near_tie)
    err5, parts5, widest5 = check_logits(pk5, pp5, 'crnn_tps B=5', near_tie)
    log(f'crnn_tps serving: plain logits up to {float(pp.abs().max()):.4g} '
        f'in magnitude; the plain path with the gather + lerp warp parts '
        f'from the ATen one at {n_spread} of {B * S} positions, widest '
        f'top-2 logit gap {spread:.4g}: near-tie width {near_tie:.4g} '
        f'(TIE_MULT x that, >= {NEAR_TIE}); kernel path against plain path '
        f'B={B}: {parts} positions part (widest gap {widest:.4g}), max abs '
        f'logit error {err:.4g}; B=5 with mixed valid ratios: {parts5} part '
        f'(widest {widest5:.4g}), max abs error {err5:.4g}; first texts '
        f'{[x["text"] for x in rec.simple_test(img[:3])]} [{name}]')

    # ---- times: predict at B=512 in turns; the stages by CUDA events -----
    times = {False: [], True: []}
    for plain in (False, True, True, False):
        rec.plain = plain
        rec.predict(img)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            rec.predict(img)
        torch.cuda.synchronize()
        times[plain].append((time.perf_counter() - t0) / 5)
    rec.plain = False
    for plain, ts in times.items():
        log(f'crnn_tps serving B={B} {"plain" if plain else "kernel"} path: '
            f'{B / min(ts):.1f} images/s ({min(ts) * 1e3:.3f} ms/batch, '
            f'best of 2 rounds of 5; the rounds '
            f'{", ".join(f"{t * 1e3:.3f}" for t in ts)} ms) [{name}]')
    with torch.inference_mode():
        x = img.to(bf)
        rect = m.preprocessor(x)
        feat = m.backbone(rect)
        stages = {'localization + grid': lambda: m.preprocessor.grid(x),
                  'preprocessor (grid + kernel 8)': lambda: m.preprocessor(x),
                  'VGG': lambda: m.backbone(rect),
                  'BiLSTM decoder': lambda: m.decoder(feat, None),
                  'forward_test_nar': lambda: m.forward_test_nar(x)}
        ms = {k: cuda_ms(fn, 10) for k, fn in stages.items()}
    log(f'crnn_tps serving B={B} by stage (CUDA events, mean of 10): '
        + ', '.join(f'{k} {v:.3f} ms' for k, v in ms.items()) + f' [{name}]')
    del rect, feat, x, warped

    # ---- a float32 model at B=8: kernel 8's f32 variant ------------------
    _, model32 = model_cfg('float32')
    r32 = build_recognizer(model32, device=dev)
    r32.model.load_state_dict(rec.model.state_dict())
    zero_launches()
    lk = r32.predict(img[:B_SMALL])
    read(f'float32 B={B_SMALL}', {'grid_sample_forward': 1})
    r32.plain = True
    lp = r32.predict(img[:B_SMALL])
    err32, parts32, _ = check_logits(lk, lp, 'crnn_tps float32', NEAR_TIE)
    if not err32 <= CRNN_F32_ATOL:
        raise AssertionError(f'crnn_tps float32: logits part by {err32} > '
                             f'{CRNN_F32_ATOL}')
    log(f'crnn_tps float32 B={B_SMALL}: kernel path against plain path, '
        f'max abs logit error {err32:.4g} (<= {CRNN_F32_ATOL}), {parts32} '
        f'positions part')
    del r32

    # ---- the inference API: .pth, init_recognizer, model_inference -------
    sd = {k: v.detach().cpu() for k, v in rec.model.state_dict().items()}
    crops_u8 = [g.integers(0, 256, (int(g.integers(16, 65)),
                                    int(g.integers(8, 241)), 3), np.uint8)
                for _ in range(N_CRNN_CROPS)]
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, 'crnn_tps.pth')
        torch.save({'meta': {}, 'state_dict': sd}, pth)
        r = init_recognizer(cfg, pth, device=dev, seed=1)
    if type(r) is not TextRecognizer or r.device != dev or \
            not all(torch.equal(v.cpu(), sd[k])
                    for k, v in r.model.state_dict().items()):
        raise AssertionError('crnn_tps init_recognizer: not the written '
                             'weights on the card')
    zero_launches()
    got = model_inference(r, crops_u8, batch_mode=True)
    launches['inference API'] = read(
        f'model_inference on {N_CRNN_CROPS} crops', {'grid_sample_forward': 1})
    pipeline = Compose([dict(type='LoadImageFromNdarray',
                             color_type='grayscale')] +
                       [dict(t) for t in r.test_pipeline_cfg[1:]])
    datas = [pipeline(dict(img=c, img_info=dict(filename=None)))
             for c in crops_u8]
    batch = np.stack([d['img'] for d in datas]).astype(np.float32)
    metas = [d['img_metas'] for d in datas]
    vr = np.asarray([mt['valid_ratio'] for mt in metas], np.float32)
    r.plain = True
    plain_res = model_inference(r, crops_u8, batch_mode=True)
    lp = r.predict(batch, vr)
    r.plain = False
    lk = r.predict(batch, vr)

    def texts(logits):
        return lc.idx2str(lc.tensor2idx(logits.cpu().numpy(), metas)[0])

    if batch.shape[1:] != (32, 100, 1) or not float(vr.min()) < 1.0 or \
            texts(lk) != [x['text'] for x in got] or \
            texts(lp) != [x['text'] for x in plain_res]:
        raise AssertionError('crnn_tps model_inference: texts other than the '
                             'decode of predict on the pipeline batch')
    err, parts, widest = check_logits(lk, lp, 'crnn_tps model_inference',
                                      near_tie)
    same = sum(a['text'] == b['text'] for a, b in zip(got, plain_res))
    log(f'crnn_tps inference API: init_recognizer({CRNN_TPS_CONFIG}, .pth), '
        f'model_inference on {N_CRNN_CROPS} grayscale uint8 crops (valid '
        f'ratios {float(vr.min()):.2f}-{float(vr.max()):.2f}): {same} of '
        f'{N_CRNN_CROPS} texts equal to the plain path\'s, {parts} '
        f'positions part (widest gap {widest:.4g} < {near_tie:.4g}); first '
        f'texts {[x["text"] for x in got[:3]]}')
    del r, rec, m, pk, pp, p2, lk, lp
    torch.cuda.empty_cache()

    # ---- training: the config's Adadelta, f32 parameters, B=64 -----------
    tc = train_cfg_of(cfg)
    chars = lc.idx2char[1:37]
    labels = [''.join(g.choice(chars, int(g.integers(1, CRNN_MAX_LABEL + 1))))
              for _ in range(bt)]
    td = lc.str2tensor(labels)
    x_train = torch.from_numpy(g.standard_normal((bt, 32, 100, 1)).astype(
        np.float32)).to(dev)
    tbatch = dict(img=x_train, valid_ratio=np.ones(bt, np.float32),
                  padded_targets=td['padded_targets'],
                  target_lengths=td['target_lengths'])

    def trainer(dtype):
        return build_recognizer(model_cfg(dtype)[1], device=dev,
                                param_dtype='float32')

    def step_fn(rt):
        opt, _ = build_optimizer_from_run_cfg(
            tc, rt.model.named_parameters(), steps_per_epoch=1,
            total_epochs=tc['total_epochs'])
        return make_train_step(rt, opt)

    rt = random_fc2(trainer('float32').init_weights(SEED))
    state0 = copy.deepcopy(rt.model.state_dict())
    for dtype in ('float32', 'bfloat16'):
        if dtype == 'bfloat16':
            rt = trainer(dtype)
        res = {}
        for plain in (False, True):
            rt.model.load_state_dict(state0)
            step = step_fn(rt)
            zero_launches()
            mets = step(tbatch, plain=plain)
            read(f'train check step, {dtype} compute, '
                 f'{"plain" if plain else "kernel"} path',
                 {} if plain else {'grid_sample_forward': 1,
                                   'grid_sample_grad': 1})
            fc2 = rt.model.preprocessor.LocalizationNetwork.localization_fc2
            res[plain] = (float(mets['loss']), float(mets['grad_norm']),
                          fc2.weight.grad.clone())
        (lk_, nk, gk), (lp_, np_, gp) = res[False], res[True]
        cos = cosine(gk, gp)
        log(f'crnn_tps train check step B={bt}, {dtype} compute: loss '
            f'{lk_:.6f} kernel / {lp_:.6f} plain; grad_norm {nk:.6f} / '
            f'{np_:.6f}; cos(d localization_fc2) {cos:.6f} [{name}]')
        if not (np.isfinite(lk_) and abs(lk_ - lp_) <= LOSS_RTOL * abs(lp_)):
            raise AssertionError(f'crnn_tps train {dtype}: loss {lk_} vs '
                                 f'plain {lp_}')
        if dtype == 'float32' and not (
                abs(nk - np_) <= GRAD_NORM_RTOL * abs(np_)
                and cos >= GRAD_COS_MIN):
            raise AssertionError(f'crnn_tps train: grad_norm {nk} vs {np_}, '
                                 f'cosine {cos}')

    # ---- five bf16 steps, then the step's time ----------------------------
    rt.model.load_state_dict(state0)
    step = step_fn(rt)
    zero_launches()
    losses = [float(step(tbatch)['loss']) for _ in range(5)]
    launches['training'] = read('5 training steps', {
        'grid_sample_forward': 5, 'grid_sample_grad': 5})
    log(f'crnn_tps train: 5 steps B={bt}, bf16 compute, Adadelta lr '
        f'{tc["optimizer"]["lr"]}, losses {losses}')
    if not all(np.isfinite(losses)):
        raise AssertionError(f'crnn_tps train: non-finite loss {losses}')
    times = {False: [], True: []}
    for plain in (False, True, True, False):
        step(tbatch, plain=plain)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            loss = step(tbatch, plain=plain)['loss']
        torch.cuda.synchronize()
        times[plain].append((time.perf_counter() - t0) / 5)
        if not bool(torch.isfinite(loss)):
            raise AssertionError('crnn_tps train: non-finite loss while '
                                 'timing')
    for plain, ts in times.items():
        log(f'crnn_tps train B={bt} {"plain" if plain else "kernel"} path: '
            f'{min(ts) * 1e3:.2f} ms/step, {bt / min(ts):.1f} images/s (best '
            f'of 2 rounds of 5 steps; the rounds '
            f'{", ".join(f"{t * 1e3:.2f}" for t in ts)} ms) [{name}]')

    # ---- the warp with a detached grid: kernel 10 ------------------------
    with torch.no_grad():
        gr = rt.model.preprocessor.grid(x_train)
    x = x_train.clone().requires_grad_(True)
    cot = torch.from_numpy((1e-3 * g.uniform(-1, 1, (bt, 32, 100, 1))).astype(
        np.float32)).to(dev)
    zero_launches()
    GridSampleFunction.apply(x, gr, False).backward(cot)
    launches['detached grid'] = read('detached-grid backward', {
        'grid_sample_forward': 1, 'grid_sample_grad_img': 1})
    err = check_close('crnn_tps detached-grid d_img', x.grad,
                      grid_sample_grad_img_plain(gr, cot, 32, 100),
                      WARP_BOUNDS['float32']['d_img'])
    log(f'crnn_tps detached-grid backward B={bt}: d_img max abs error '
        f'{err:.4g} against the plain version')
    del rt, step, x
    torch.cuda.empty_cache()
    log(f'crnn_tps phase: {time.perf_counter() - t_phase:.1f} s; launches '
        f'{json.dumps(launches)}')
    out = {'grid_sample_forward_c1': sum(
               n.get('grid_sample_forward', 0) for n in launches.values()),
           'grid_sample_grad_c1': launches['training']['grid_sample_grad'],
           'grid_sample_grad_img_c1':
               launches['detached grid']['grid_sample_grad_img']}
    # the rows by CUDA graph time the same launches of the same paths:
    # kernel 8's the serving path's (bf16) and the training steps' (f32)
    out['grid_sample_grad_c1_graph'] = out['grid_sample_grad_c1']
    out['grid_sample_grad_img_c1_graph'] = out['grid_sample_grad_img_c1']
    out['grid_sample_forward_c1_graph'] = \
        launches['serving']['grid_sample_forward']
    out['grid_sample_forward_c1_f32_graph'] = \
        launches['training']['grid_sample_forward']
    return out


def sar_phase(dev, name):
    """The ResNet31 attention family on ``dev``, the card (see the module
    docstring): serving, beam search, the float32 models against the CPU,
    bf16 against float32, training and the inference API, with no
    hand-written kernel launched. Returns the phase's launch counts (all
    0)."""
    import copy
    import tempfile

    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import (TextRecognizer, build_recognizer,
                                       init_recognizer, model_inference)
    from tps_pp_tpu_torch.config import load_config, merge_cli_options
    from tps_pp_tpu_torch.datasets.pipelines.transforms import Compose
    from tps_pp_tpu_torch.models.decoders import beam_decode, greedy_decode
    from tps_pp_tpu_torch.parallel import (build_optimizer_from_run_cfg,
                                           make_train_step)
    from tps_pp_tpu_torch.tools.train import train_cfg_of

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    cpu = torch.device('cpu')

    def model_cfg(key, dtype, no_dropout=False):
        cfg = load_config(os.path.join(repo, SAR_CONFIGS[key]))
        merge_cli_options(cfg, {'model.dtype': dtype})
        model = copy.deepcopy(dict(cfg['model']))
        if key == 'sar_beam':
            model['decoder'] = dict(model['decoder'],
                                    type='ParallelSARDecoderWithBS')
        if no_dropout and model['type'] == 'SARNet':
            model['encoder'] = dict(model['encoder'], enc_do_rnn=0.0)
            model['decoder'] = dict(model['decoder'], pred_dropout=0.0)
        return cfg, model

    def build(key, dtype, device, state=None, no_dropout=False, **kw):
        r = build_recognizer(model_cfg(key, dtype, no_dropout)[1],
                             device=device, **kw)
        if state is None:
            r.init_weights(SEED)
        else:
            r.model.load_state_dict(state)
        if type(r) is not TextRecognizer or r.device.type != device.type \
                or r.resolved_decode_mode() != 'steps':
            raise AssertionError(f'sar {key}: built {type(r).__name__} on '
                                 f'{r.device}, {r.resolved_decode_mode()}')
        return r

    def crops(n, h=48, w=160):
        """Random crops, their valid ratios (widths 48-160 in steps of 4,
        over 160) and the columns past each width zeroed, as the
        keep-aspect pipeline pads them."""
        x = g.standard_normal((n, h, w, 3)).astype(np.float32)
        widths = g.choice(np.arange(48, 161, 4), n)
        for i, wd in enumerate(widths):
            x[i, :, wd:] = 0.0
        return (torch.from_numpy(x).to(dev),
                torch.from_numpy((widths / 160).astype(np.float32)).to(dev))

    def timed(fn, rounds=2, reps=3):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) / reps)
        return min(ts), ts

    zero_launches()
    g = np.random.default_rng(SEED + 16)
    img, vr = crops(B)
    bf16_out, sections = {}, {}
    t_sec = [time.perf_counter()]

    def section(what):
        now = time.perf_counter()
        sections[what] = round(now - t_sec[0], 1)
        t_sec[0] = now

    def random_labels(lc, n):
        """n DICT90 labels of 1-25 characters as ``lc``'s padded
        targets."""
        chars = lc.idx2char[:90]
        return lc.str2tensor([''.join(g.choice(chars, int(g.integers(1, 26))))
                              for _ in range(n)])['padded_targets']

    # ---- serving, bf16, B=512 (the beam decoder at B_SAR_BEAM) ------------
    states = {}
    for key in SAR_CONFIGS:
        rec = build(key, 'bfloat16', dev)
        states[key] = {k: v.detach().cpu()
                       for k, v in rec.model.state_dict().items()}
        m, lc = rec.model, rec.label_convertor
        n = B_SAR_BEAM if key == 'sar_beam' else B
        x, v = img[:n].to(torch.bfloat16), vr[:n]
        out = rec.predict(x, v)
        if tuple(out.shape) != (n, rec.max_seq_len, lc.num_classes() - 1) \
                or not bool(torch.isfinite(out).all()):
            raise AssertionError(f'sar {key}: bad output {tuple(out.shape)}')
        ms, ts = timed(lambda: rec.predict(x, v))
        with torch.inference_mode():
            feat = m.extract_feat(x)
            enc = m.encode(feat, v)
            kw = dict(max_seq_len=rec.max_seq_len, start_idx=lc.start_idx,
                      feat=feat)

            def decode():
                if rec.beam_width > 1:
                    return beam_decode(m.decoder, enc, v,
                                       beam_width=rec.beam_width, **kw)
                return greedy_decode(m.decoder, enc, v, end_idx=lc.end_idx,
                                     **kw)
            stages = {'extract_feat': lambda: m.extract_feat(x),
                      'encoder': lambda: m.encode(feat, v),
                      'decode': decode}
            st = {k: cuda_ms(fn, 3) for k, fn in stages.items()}
        if key != 'sar_beam':
            bf16_out[key] = out         # held against float32 below
        texts = [r['text'] for r in rec.simple_test(x[:3], v[:3])]
        log(f'sar {key} serving B={n} bf16 ({rec.resolved_decode_mode()}, '
            f'beam_width {rec.beam_width}): {n / ms:.1f} images/s '
            f'({ms * 1e3:.3f} ms/batch, best of 2 rounds of 3; '
            f'{", ".join(f"{t * 1e3:.3f}" for t in ts)}); stages (CUDA '
            f'events, mean of 3): '
            + ', '.join(f'{k} {t:.3f} ms' for k, t in st.items())
            + f'; first texts {texts} [{name}]')
        del rec, m, feat, enc, out
        torch.cuda.empty_cache()
    section('serving')

    # ---- float32: the card against the CPU (B_SAR_F32); bf16 against f32 --
    # (dropout-free builds, kept for the training check step)
    f32_models = {}
    tf_targets = random_labels(lc, B_SAR_F32)
    for key in SAR_CONFIGS:
        rg = build(key, 'float32', dev, states[key], no_dropout=True)
        rc = build(key, 'float32', cpu, states[key], no_dropout=True)
        x, v = img[:B_SAR_F32], vr[:B_SAR_F32]
        t0 = time.perf_counter()
        if key == 'sar_beam':
            with torch.inference_mode():
                def run(r, xx, vv):
                    feat, enc = r.model.encode_full(xx, vv)
                    return beam_decode(
                        r.model.decoder, enc, vv,
                        max_seq_len=r.max_seq_len,
                        start_idx=r.label_convertor.start_idx,
                        beam_width=r.beam_width, feat=feat,
                        return_ranking=True)
                pk, _, _ = run(rg, x, v)
                pc, totals, cut = run(rc, x.cpu(), v.cpu())
            pk = pk.cpu()
            same = (pk.argmax(-1) == pc.argmax(-1)).all(-1)
            near = torch.minimum(totals[:, 0] - totals[:, 1],
                                 cut.min(1).values)
            for row in torch.nonzero(~same).flatten().tolist():
                if not float(near[row]) < BEAM_TIE:
                    raise AssertionError(
                        f'sar beam float32: row {row} picks another best '
                        f'beam than the CPU path, whose ranking has no '
                        f'near-tie ({float(near[row]):.4g} >= {BEAM_TIE})')
            err = float((pk[same] - pc[same]).abs().max()) if bool(
                same.any()) else 0.0
            if not err <= SAR_F32_ATOL:
                raise AssertionError(f'sar beam float32: scores part by '
                                     f'{err:.4g} > {SAR_F32_ATOL}')
            ties = int((~same).sum())
            widest = float(near[~same].max()) if ties else 0.0
        else:
            pk = rg.predict(x, v).cpu()
            pc = rc.predict(x.cpu(), v.cpu())
            # the decode rule, the CPU path as the plain side
            err, ties, widest = check_decode(pk, pc, f'sar {key} float32',
                                             bound=(SAR_F32_ATOL, 0.0))
            # the teacher-forced pass over varied labels: seed-0 weights
            # decode one token at every step, this feeds the others
            tgt = torch.from_numpy(tf_targets)
            with torch.inference_mode():
                lk = rg.model(x, tgt.to(dev), v).float().cpu()
                lp = rc.model(x.cpu(), tgt, v.cpu()).float()
            tf_err = float((lk - lp).abs().max())
            tf_bound = SAR_F32_ATOL * max(1.0, float(lp.abs().max()))
            if not tf_err <= tf_bound:
                raise AssertionError(f'sar {key} float32 teacher-forced: '
                                     f'logits part by {tf_err:.4g} > '
                                     f'{tf_bound:.4g}')
        cpu_s = time.perf_counter() - t0
        line = (f'sar {key} float32 B={B_SAR_F32}, card against CPU: max '
                f'abs probability error {err:.4g} (<= {SAR_F32_ATOL}), '
                f'{ties} rows part at a near-tie of the CPU path (widest '
                f'{widest:.4g})')
        if key != 'sar_beam':
            line += (f'; teacher-forced logits over random labels within '
                     f'{tf_err:.4g} (<= {tf_bound:.4g}, SAR_F32_ATOL x their '
                     f'largest magnitude)')
        line += f'; {cpu_s:.1f} s'
        if key != 'sar_beam':
            # bf16 against float32 on the card, the serving batch
            with torch.inference_mode():
                p32 = rg.predict(img, vr)
            pb = bf16_out.pop(key).float()
            div = first_divergence(pb, p32)
            parts = [(t, gap) for t, gap in div if t is not None]
            line += (f'; bf16 against float32 on the card, B={B}: '
                     f'{len(parts)} rows part, first at steps '
                     f'{sorted({t for t, _ in parts})[:6]}, widest top-2 '
                     f'gap of the float32 path there '
                     f'{max((gap for _, gap in parts), default=0.0):.4g}')
            del p32
        log(line + f' [{name}]')
        if key in ('sar_parallel', 'robust_scanner'):
            f32_models[key] = (rg, rc)
        del rg, rc
        torch.cuda.empty_cache()
    section('float32 checks')

    # ---- training: B=64 steps, then a float32 step against the CPU -------
    for key in ('sar_parallel', 'robust_scanner'):
        cfg, _ = model_cfg(key, 'bfloat16')
        tc = train_cfg_of(cfg)
        bt = int(tc['samples_per_gpu'])
        rt = build(key, 'bfloat16', dev, states[key], param_dtype='float32')
        xt, vt = crops(bt)
        batch = dict(img=xt, valid_ratio=vt,
                     padded_targets=random_labels(lc, bt))

        def step_fn(r):
            opt, _ = build_optimizer_from_run_cfg(
                tc, r.model.named_parameters(), steps_per_epoch=1,
                total_epochs=tc['total_epochs'])
            return make_train_step(r, opt)

        step = step_fn(rt)
        losses = [float(step(batch)['loss']) for _ in range(2)]
        ms, ts = timed(lambda: step(batch), rounds=2, reps=3)
        if not all(np.isfinite(losses)):
            raise AssertionError(f'sar {key} train: losses {losses}')
        # one float32 step without dropout on both devices, B_SAR_F32, on
        # the models of the float32 checks (their weights still the
        # serving model's)
        small = {k: t[:B_SAR_F32] for k, t in batch.items()}
        mets = []
        for r in f32_models.pop(key):
            d = r.device
            b = dict(small, img=small['img'].to(d),
                     valid_ratio=small['valid_ratio'].to(d))
            mt = step_fn(r)(b)
            mets.append((float(mt['loss']), float(mt['grad_norm'])))
        (lk, nk), (lp, np_) = mets
        if not (abs(lk - lp) <= SAR_LOSS_RTOL * abs(lp)
                and abs(nk - np_) <= SAR_GRAD_NORM_RTOL * abs(np_)):
            raise AssertionError(f'sar {key} train check: loss {lk} / {lp}, '
                                 f'grad norm {nk} / {np_}')
        log(f'sar {key} train B={bt}, f32 parameters, bf16 autocast, '
            f'{tc["optimizer"]["type"]} lr {tc["optimizer"]["lr"]}: '
            f'{ms * 1e3:.2f} ms/step, {bt / ms:.1f} images/s (best of 2 '
            f'rounds of 3; {", ".join(f"{t * 1e3:.2f}" for t in ts)}); '
            f'losses {losses}; float32 step without dropout B={B_SAR_F32}, '
            f'card / CPU: loss {lk:.7f} / {lp:.7f} (rel '
            f'{abs(lk - lp) / abs(lp):.3g} <= {SAR_LOSS_RTOL}), grad norm '
            f'{nk:.6f} / {np_:.6f} (rel {abs(nk - np_) / abs(np_):.3g} <= '
            f'{SAR_GRAD_NORM_RTOL}) [{name}]')
        del rt, step
        torch.cuda.empty_cache()
    section('training')

    # ---- the inference API: .pth, init_recognizer, model_inference -------
    cfg_path = os.path.join(repo, SAR_CONFIGS['sar_parallel'])
    cfg = load_config(cfg_path)
    merge_cli_options(cfg, {'model.dtype': 'bfloat16'})
    u8 = [g.integers(0, 256, (int(g.integers(16, 65)),
                              int(g.integers(24, 401)), 3), np.uint8)
          for _ in range(N_SAR_CROPS)]
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, 'sar.pth')
        torch.save({'meta': {}, 'state_dict': states['sar_parallel']}, pth)
        r = init_recognizer(cfg, pth, device=dev, seed=1)
    if not all(torch.equal(t.cpu(), states['sar_parallel'][k].to(t.dtype))
               for k, t in r.model.state_dict().items()):
        raise AssertionError('sar init_recognizer: not the written weights')
    got = model_inference(r, u8, batch_mode=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = model_inference(r, u8, batch_mode=True)
    ms_api = (time.perf_counter() - t0) * 1e3
    pipeline = Compose([dict(type='LoadImageFromNdarray')] +
                       [dict(t) for t in r.test_pipeline_cfg[1:]])
    datas = [pipeline(dict(img=c, img_info=dict(filename=None)))
             for c in u8]
    order = sorted(range(len(datas)),
                   key=lambda i: float(datas[i]['img_metas']['valid_ratio']))
    batch = np.stack([datas[i]['img'] for i in order]).astype(np.float32)
    vrs = np.asarray([datas[i]['img_metas']['valid_ratio'] for i in order],
                     np.float32)
    want = r.simple_test(batch, vrs,
                         img_metas=[datas[i]['img_metas'] for i in order])
    if batch.shape[1:] != (48, 160, 3) or [got[i]['text'] for i in order] \
            != [w['text'] for w in want]:
        raise AssertionError('sar model_inference: texts other than '
                             'simple_test\'s on the pipeline batch')
    log(f'sar inference API: init_recognizer({SAR_CONFIGS["sar_parallel"]}, '
        f'.pth, model.dtype=bfloat16), model_inference on {N_SAR_CROPS} '
        f'uint8 crops (valid ratios {float(vrs.min()):.2f}-'
        f'{float(vrs.max()):.2f}) in {ms_api:.1f} ms, texts equal to '
        f'simple_test\'s on the pipeline batch; first texts '
        f'{[x["text"] for x in got[:3]]} [{name}]')
    del r
    section('inference API')

    launches = read_launches('sar', 'the whole phase', {})
    log(f'sar phase: {time.perf_counter() - t_phase:.1f} s (by section: '
        f'{sections}); no hand-written kernel launched')
    return launches


def transformer_phase(dev, name, record):
    """The transformer family on its other trunks on ``dev``, the card (see
    the module docstring): ``'auto'`` resolving to ``fused40_bf16`` for
    each of ``TRANSFORMER_CONFIGS``, B=512 serving through kernels 3 (the
    NRTR configs) and 4 against the plain path, SATRN-small on ``fused40``
    (kernel 5), kernel 3 at 40 and 320 tokens and kernels 4-5 at d_k 32
    and 320 source tokens recorded, the float32 models against the CPU,
    and B=64 training steps. Returns the launch counts of its rows of the
    kernels line, from the serving runs."""
    import copy

    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import TextRecognizer, build_recognizer
    from tps_pp_tpu_torch.config import load_config, merge_cli_options
    from tps_pp_tpu_torch.models.encoders.nrtr import sequence_mask
    from tps_pp_tpu_torch.ops.encoder import (encoder_forward,
                                              encoder_forward_plain)
    from tps_pp_tpu_torch.ops.full_decode import (_dims, full_decode,
                                                  full_decode_plain)
    from tps_pp_tpu_torch.parallel import (build_optimizer_from_run_cfg,
                                           make_train_step)
    from tps_pp_tpu_torch.tools.train import train_cfg_of

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    cpu, bf = torch.device('cpu'), torch.bfloat16
    g = np.random.default_rng(SEED + 17)

    def model_cfg(key, dtype):
        cfg = load_config(os.path.join(repo, TRANSFORMER_CONFIGS[key][0]))
        merge_cli_options(cfg, {'model.dtype': dtype})
        return cfg, copy.deepcopy(dict(cfg['model']))

    def build(key, dtype, device, state=None, **kw):
        r = build_recognizer(model_cfg(key, dtype)[1], device=device, **kw)
        if state is None:
            r.init_weights(SEED)
        else:
            r.model.load_state_dict(state)
        if type(r) is not TextRecognizer or r.device.type != device.type:
            raise AssertionError(f'transformer {key}: built '
                                 f'{type(r).__name__} on {r.device}')
        return r

    def crops(n, w):
        """Random 32 x w crops, their valid ratios (widths 32-w in steps
        of 4, over w) and the columns past each width zeroed."""
        x = g.standard_normal((n, 32, w, 3)).astype(np.float32)
        widths = g.choice(np.arange(32, w + 1, 4), n)
        for i, wd in enumerate(widths):
            x[i, :, wd:] = 0.0
        return (torch.from_numpy(x).to(dev),
                torch.from_numpy((widths / w).astype(np.float32)).to(dev))

    def timed(fn, rounds=2, reps=3):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) / reps)
        return min(ts), ts

    def random_labels(lc, n):
        chars = lc.idx2char[:len(lc.idx2char) - 3]
        return lc.str2tensor([''.join(g.choice(chars, int(g.integers(1, 26))))
                              for _ in range(n)])['padded_targets']

    def record_encoder(label, m, feat, v):
        """Kernel 3 at this model's token count, on its trunk's feature,
        with nn.TransformerEncoder as the library call."""
        n, h, w, c = feat.shape
        x = feat.reshape(n, h * w, c).contiguous()
        mask = sequence_mask(v, h * w)
        wts = m.encoder.folded_weights(bf)
        H = m.encoder.n_head
        got = encoder_forward(x, mask, wts, H)
        want = encoder_forward_plain(x, mask, wts, H)
        torch.cuda.synchronize()
        err = check_close(label, got, want, (ENCODER_ATOL, ENCODER_RTOL))
        te = transformer_encoder_yardstick(m.encoder, bf)
        pad = mask <= 0

        def te_call():
            with torch.no_grad():
                return te(x, src_key_padding_mask=pad)
        L, D = wts['wqkv'].shape[:2]
        HD, DI, T = wts['wfc'].shape[1], wts['w1'].shape[2], h * w
        record(label, 'tps_pp_tpu_torch/csrc/encoder.cu',
               'tps_pp_tpu/ops/pallas_encoder.py:178',
               lambda: encoder_forward(x, mask, wts, H),
               lambda: encoder_forward_plain(x, mask, wts, H), err, 5,
               nbytes(x, mask, got, *wts.values()),
               bf16_flops=2 * n * T * L * (D * 3 * HD + HD * D + 2 * D * DI)
               + 4 * n * T * T * HD * L, fn_lib=te_call,
               label=f'{label} (T={T}, B={n}, {L} layers)')
        del te

    def record_decode(label, m, out_enc, v, lc, enc_dtype, near_tie):
        """Kernel 4 (or 5) at this model's widths and source tokens, its
        argmax against the plain version's under ``near_tie``."""
        dec = m.decoder
        wd = dec.packed_weights(bf)
        dd = _dims(wd, dec.n_head)
        n, TE = out_enc.shape[:2]
        src_mask = sequence_mask(v, TE).contiguous()
        args = (out_enc, src_mask, wd, dec.n_head, lc.start_idx, lc.end_idx,
                enc_dtype)
        pk = full_decode(*args)
        steps = full_decode.last_steps
        pp = full_decode_plain(*args)
        torch.cuda.synchronize()
        err, ties, widest = check_decode(pk, pp, label, near_tie)
        mm_ops, att_ops = decode_flops(dd, n, steps, TE)
        record(label, 'tps_pp_tpu_torch/csrc/full_decode.cu',
               'tps_pp_tpu/ops/pallas_full_decode.py:378',
               lambda: full_decode(*args), lambda: full_decode_plain(*args),
               err, 3, nbytes(out_enc, src_mask, pk, *wd.values()),
               bf16_flops=mm_ops, f32_flops=att_ops,
               label=f'{label} (N={n}, TE={TE}, d_k={dd["DK"]}, {steps} '
                     f'steps; {ties} rows part at a near-tie, widest '
                     f'{widest:.3g})')

    # ---- serving, bf16, B=512: 'auto', kernels 3 and 4 ---------------------
    states, launches = {}, {}
    for key, (path, width) in TRANSFORMER_CONFIGS.items():
        rec = build(key, 'bfloat16', dev)
        states[key] = {k: t.detach().cpu()
                       for k, t in rec.model.state_dict().items()}
        m, lc = rec.model, rec.label_convertor
        fuses = getattr(type(m.encoder), 'SUPPORTS_FUSED_FORWARD', False)
        x, v = crops(B, width)
        x = x.to(bf)
        with torch.inference_mode():
            feat = m.extract_feat(x)
        tokens = int(feat.shape[1] * feat.shape[2])
        modes = (rec.resolved_decode_mode(), rec.resolved_decode_mode(tokens))
        if modes != ('fused40_bf16', 'fused40_bf16'):
            raise AssertionError(f'transformer {key}: auto resolved to '
                                 f'{modes} over {tokens} tokens')
        zero_launches()
        out = rec.predict(x, v)
        want = {'full_decode': 1, **({'encoder': 1} if fuses else {})}
        got = read_launches('transformer', f'{key} predict B={B}', want)
        S, NC = rec.max_seq_len, lc.num_classes() - 1
        if tuple(out.shape) != (B, S, NC) or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f'transformer {key}: bad output '
                                 f'{tuple(out.shape)}')
        rec.plain = True
        pp = rec.predict(x, v)
        ms_p, _ = timed(lambda: rec.predict(x, v), rounds=1, reps=1)
        rec.plain = False
        tw, out_enc = transformer_tie_widths(rec, x, v, f'transformer {key}')
        # the near-tie of the path: TIE_MULT times the widest gap at which
        # the plain decode parts from itself when only the encoder's
        # rounding changes; of kernel 4 on one encoding: when every value
        # of that encoding moves by one bf16 ulp; never below NEAR_TIE
        sens, ulp, k4 = tw['encoder'], tw['ulp'], tw['kernel']
        tie = max(NEAR_TIE, TIE_MULT * sens[1])
        tie_k4 = max(NEAR_TIE, TIE_MULT * ulp[1])
        if k4[0] and not k4[1] < tie_k4:
            raise AssertionError(f'transformer {key} kernel 4, one encoding: '
                                 f'a row parts from the plain version at a '
                                 f'top-2 gap of {k4[1]:.3g} (>= '
                                 f'{tie_k4:.3g})')
        err, ties, widest = check_decode(out, pp, f'transformer {key}',
                                         near_tie=tie)
        ms, ts = timed(lambda: rec.predict(x, v))
        with torch.inference_mode():
            st = {'extract_feat': lambda: m.extract_feat(x),
                  'encoder': (lambda: m.encoder(feat, v, fused=True))
                  if fuses else (lambda: m.encode(feat, v)),
                  'decode': lambda: m.decoder.fused_full_decode(
                      out_enc, v, end_idx=lc.end_idx)}
            st = {k: cuda_ms(fn, 3) for k, fn in st.items()}
        log(f'transformer {key} serving B={B} bf16 (auto -> '
            f'{modes[1]}, {tokens} encoder tokens, encoder '
            f'{"kernel 3" if fuses else "module"}): {B / ms:.1f} images/s '
            f'({ms * 1e3:.3f} ms/batch, best of 2 rounds of 3; '
            f'{", ".join(f"{t * 1e3:.3f}" for t in ts)}; plain path '
            f'{ms_p * 1e3:.1f} ms); stages (CUDA events, mean of 3): '
            + ', '.join(f'{k} {t:.3f} ms' for k, t in st.items())
            + f'; the plain decode on the encoding one bf16 ulp away: '
            f'{ulp[0]} rows part (widest {ulp[1]:.3g}), near-tie '
            f'{tie_k4:.3g}; kernel 4 against its plain version on one '
            f'encoding: {k4[0]} part (widest {k4[1]:.3g}); the plain decode '
            f'on the path\'s encoding against the float32 encoder\'s: '
            f'{sens[0]} rows part (widest {sens[1]:.3g}), near-tie '
            f'{tie:.3g}; the path against the plain path: {ties} of {B} rows '
            f'part at a near-tie (widest {widest:.3g} < {tie:.3g}), max abs '
            f'err {err:.4g}; launches {got} [{name}]')
        with torch.inference_mode():
            if key == 'nrtr_r31_1by16':
                record_encoder('encoder_t40', m, feat, v)
                launches['encoder_t40'] = got['encoder']
            if key == 'nrtr_r31_1by8':
                record_encoder('encoder_t320', m, feat, v)
                launches['encoder_t320'] = got['encoder']
                record_decode('full_decode_te320', m, out_enc, v, lc,
                              'bfloat16', tie_k4)
                launches['full_decode_te320'] = got['full_decode']
            if key == 'satrn_small':
                record_decode('full_decode_dk32', m, out_enc, v, lc,
                              'bfloat16', tie_k4)
                launches['full_decode_dk32'] = got['full_decode']
                record_decode('full_decode_int8_dk32', m, out_enc, v, lc,
                              'int8', tie_k4)
        if key == 'satrn_small':
            # fused40: int8 encoder K/V, one scale per (layer, K or V, head)
            rec.decode_mode = 'fused40'
            zero_launches()
            out8 = rec.predict(x, v)
            got8 = read_launches('transformer', f'{key} fused40 B={B}',
                                 {'full_decode_int8': 1})
            launches['full_decode_int8_dk32'] = got8['full_decode_int8']
            rec.plain = True
            pp8 = rec.predict(x, v)
            rec.plain = False
            err8, ties8, widest8 = check_decode(
                out8, pp8, f'transformer {key} fused40', tie)
            ms8, _ = timed(lambda: rec.predict(x, v))
            log(f'transformer {key} serving B={B} fused40 (int8 K/V): '
                f'{B / ms8:.1f} images/s ({ms8 * 1e3:.3f} ms/batch); '
                f'{ties8} rows part at a near-tie (widest {widest8:.3g}), '
                f'max abs err {err8:.4g} [{name}]')
        del rec, m, feat, out_enc, out, pp, x
        torch.cuda.empty_cache()

    # ---- float32: the card against the CPU, B_TF_F32 ------------------------
    for key, (path, width) in TRANSFORMER_CONFIGS.items():
        rg = build(key, 'float32', dev, states[key])
        rc = build(key, 'float32', cpu, states[key])
        x, v = crops(B_TF_F32, width)
        t0 = time.perf_counter()
        pk = rg.predict(x, v).cpu()
        pc = rc.predict(x.cpu(), v.cpu())
        err, ties, widest = check_decode(pk, pc, f'transformer {key} float32',
                                         bound=(TF_F32_ATOL, 0.0))
        tgt = torch.from_numpy(random_labels(rg.label_convertor, B_TF_F32))
        with torch.inference_mode():
            lk = rg.model(x, tgt.to(dev), v).float().cpu()
            lp = rc.model(x.cpu(), tgt, v.cpu()).float()
        tf_err = float((lk - lp).abs().max())
        tf_bound = TF_F32_ATOL * max(1.0, float(lp.abs().max()))
        if not tf_err <= tf_bound:
            raise AssertionError(f'transformer {key} float32 teacher-forced: '
                                 f'logits part by {tf_err:.4g} > '
                                 f'{tf_bound:.4g}')
        log(f'transformer {key} float32 B={B_TF_F32} '
            f'({rg.resolved_decode_mode()}), card against CPU: max abs '
            f'probability error {err:.4g} (<= {TF_F32_ATOL}), {ties} rows '
            f'part at a near-tie of the CPU path (widest {widest:.4g}); '
            f'teacher-forced logits within '
            f'{tf_err:.4g} (<= {tf_bound:.4g}); '
            f'{time.perf_counter() - t0:.1f} s [{name}]')
        del rg, rc
        torch.cuda.empty_cache()

    # ---- the fallback: 'auto' over more tokens than the kernels take ------
    key = 'nrtr_r31_1by16'
    rf = build(key, 'bfloat16', dev, states[key])
    x, v = crops(B_TF_FALLBACK, TF_FALLBACK_WIDTH)
    with torch.inference_mode():
        feat = rf.model.extract_feat(x.to(bf))
    tokens = int(feat.shape[1] * feat.shape[2])
    modes = (rf.resolved_decode_mode(), rf.resolved_decode_mode(tokens))
    if tokens <= 512 or modes != ('fused40_bf16', 'steps'):
        raise AssertionError(f'transformer {key} fallback: auto resolved to '
                             f'{modes} over {tokens} tokens')
    zero_launches()
    out = rf.predict(x, v)
    read_launches('transformer', f'{key} fallback', {})
    if tuple(out.shape) != (B_TF_FALLBACK, rf.max_seq_len,
                            rf.label_convertor.num_classes() - 1) or not bool(
                                torch.isfinite(out).all()):
        raise AssertionError(f'transformer {key} fallback: bad output '
                             f'{tuple(out.shape)}')
    ms, _ = timed(lambda: rf.predict(x, v), rounds=1, reps=2)
    log(f'transformer {key} fallback, bf16, decode_mode auto, '
        f'B={B_TF_FALLBACK} at 32 x {TF_FALLBACK_WIDTH}: {tokens} encoder '
        f'tokens an image; resolved {modes[0]} before the trunk, {modes[1]} '
        f'after it (kernels 3 and 4 take at most 512); predict '
        f'{ms * 1e3:.2f} ms, no ValueError, no kernel launched [{name}]')
    del rf, feat, out
    torch.cuda.empty_cache()

    # ---- training: B=64 steps (f32 parameters, bf16 autocast) -------------
    for key in ('satrn_academic', 'nrtr_r31_1by16'):
        cfg, _ = model_cfg(key, 'bfloat16')
        tc = train_cfg_of(cfg)
        rt = build(key, 'bfloat16', dev, states[key], param_dtype='float32')
        xt, vt = crops(B_TF_TRAIN, TRANSFORMER_CONFIGS[key][1])
        batch = dict(img=xt, valid_ratio=vt, padded_targets=random_labels(
            rt.label_convertor, B_TF_TRAIN))
        opt, _ = build_optimizer_from_run_cfg(
            tc, rt.model.named_parameters(), steps_per_epoch=1,
            total_epochs=tc['total_epochs'])
        step = make_train_step(rt, opt)
        zero_launches()
        losses = [float(step(batch)['loss']) for _ in range(2)]
        read_launches('transformer', f'{key} train', {})
        ms, ts = timed(lambda: step(batch), rounds=2, reps=3)
        if not all(np.isfinite(losses)):
            raise AssertionError(f'transformer {key} train: losses {losses}')
        log(f'transformer {key} train B={B_TF_TRAIN}, f32 parameters, bf16 '
            f'autocast, {tc["optimizer"]["type"]} lr '
            f'{tc["optimizer"]["lr"]}: {ms * 1e3:.2f} ms/step, '
            f'{B_TF_TRAIN / ms:.1f} images/s (best of 2 rounds of 3; '
            f'{", ".join(f"{t * 1e3:.2f}" for t in ts)}); losses {losses} '
            f'[{name}]')
        del rt, step, opt
        torch.cuda.empty_cache()
    log(f'transformer phase: {time.perf_counter() - t_phase:.1f} s')
    return launches


def seg_preproc_phase(dev, name, record):
    """The segmentation recognizer and the image-space preprocessors on
    ``dev``, the card (see the module docstring): SegOCR academic (no
    kernel), CRNN + MORAN (kernels 8-10 at one channel), ABINet + TPS++ +
    SPIN (kernels 1 and 8-10, SPIN's offsets at three channels); the
    offset samples' kernel rows. Returns the rows' launches on the paths."""
    import copy

    import numpy as np
    import torch
    import torch.nn.functional as F
    from tps_pp_tpu_torch.apis import SegRecognizer, build_recognizer
    from tps_pp_tpu_torch.config import load_config, merge_cli_options
    from tps_pp_tpu_torch.models.rectifiers import MORAN, SPIN
    from tps_pp_tpu_torch.ops import grid_sample as gs
    from tps_pp_tpu_torch.parallel import (build_optimizer,
                                           build_optimizer_from_run_cfg,
                                           make_train_step)
    from tps_pp_tpu_torch.tools.train import train_cfg_of

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    cpu = torch.device('cpu')
    bf, f32 = torch.bfloat16, torch.float32
    g = np.random.default_rng(SEED + 18)
    sections, t_sec = {}, [time.perf_counter()]

    def section(what):
        now = time.perf_counter()
        sections[what] = round(now - t_sec[0], 1)
        t_sec[0] = now

    def model_cfg(path, dtype, pre=None, dropout=None):
        cfg = load_config(os.path.join(repo, path))
        merge_cli_options(cfg, {'model.dtype': dtype})
        model = copy.deepcopy(dict(cfg['model']))
        if pre:
            model['preprocessor'] = dict(pre)
        if dropout is not None:                # ABINet's two dropouts
            model['encoder']['encoder']['dropout'] = dropout
            model['decoder']['dropout'] = dropout
        return cfg, model

    def timed(fn, rounds=2, reps=3):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) / reps)
        return min(ts), ts

    def fmt(ts):
        return ', '.join(f'{t * 1e3:.3f}' for t in ts)

    class Tap:
        """``fn`` with ``hook`` called on its arguments first; attributes
        (the wrapper's launch count, its last plan) read and written
        through to ``fn``, which counts its launches under its module name,
        the name this stands in for."""

        def __init__(self, fn, hook):
            object.__setattr__(self, '_fn', fn)
            object.__setattr__(self, '_hook', hook)

        def __call__(self, *args):
            self._hook(*args)
            return self._fn(*args)

        def __getattr__(self, key):
            return getattr(self._fn, key)

        def __setattr__(self, key, value):
            setattr(self._fn, key, value)

    class OffsetSamples:
        """Counts the kernel 8 and kernel 10 launches whose source is an
        offset map of ``hw`` (the rows' launches on the path) and keeps
        the first B=512 (padded) forward's and the first backward's inputs
        (the rows' inputs). Every grid must be f32."""

        def __init__(self, hw):
            self.hw, self.fwd, self.bwd = hw, 0, 0
            self.fwd_args = self.bwd_args = None
            self._f, self._b = gs.grid_sample_forward, gs.grid_sample_grad_img

        def _on_fwd(self, img, grid):
            if grid.dtype != f32:
                raise AssertionError(f'a {grid.dtype} grid')
            if tuple(img.shape[1:3]) == self.hw:
                self.fwd += 1
                if self.fwd_args is None and img.shape[0] >= B:
                    self.fwd_args = (img.clone(), grid.clone())

        def _on_bwd(self, grid, cot, H, W):
            if (H, W) == self.hw:
                self.bwd += 1
                if self.bwd_args is None:
                    self.bwd_args = (grid.clone(), cot.clone())

        def __enter__(self):
            gs.grid_sample_forward = Tap(self._f, self._on_fwd)
            gs.grid_sample_grad_img = Tap(self._b, self._on_bwd)
            return self

        def __exit__(self, *exc):
            gs.grid_sample_forward = self._f
            gs.grid_sample_grad_img = self._b

    def gather_plain(img, grid):
        """The same warp in another rounding, no kernel: the gather + lerp
        of the plain backward in f32, rounded to the image's dtype once."""
        return gs._gather_lerp(img.float(), grid).to(img.dtype)

    # ==== SegOCR academic: no kernel ====================================
    _, model = model_cfg(SEG_CONFIG, 'bfloat16')
    rec = build_recognizer(model, device=dev)
    if type(rec) is not SegRecognizer or rec.device != dev or \
            rec.resolved_decode_mode() != 'single_pass':
        raise AssertionError(f'seg: built {type(rec).__name__} on '
                             f'{rec.device}, {rec.resolved_decode_mode()}')
    rec.init_weights(SEED)
    img = torch.from_numpy(g.standard_normal((B, 64, 256, 3)).astype(
        np.float32)).to(dev)
    zero_launches()
    out = rec.predict(img)
    read_launches('seg', f'predict B={B}', {})
    C = len(rec.label_convertor.idx2char)
    if tuple(out.shape) != (B, 64, 256, C) or out.dtype != f32 or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f'seg: bad output {tuple(out.shape)}')
    ms, ts = timed(lambda: rec.predict(img))
    t0 = time.perf_counter()
    host = out.cpu().numpy()
    copy_s = time.perf_counter() - t0
    rec.label_convertor.tensor2str(host[:1])      # scipy's import
    t0 = time.perf_counter()
    texts, _ = rec.label_convertor.tensor2str(host)
    decode_s = time.perf_counter() - t0
    m = rec.model
    with torch.inference_mode():
        x = img.to(bf)
        feats = m.backbone(x)
        neck = m.neck(feats)
        st = {'extract_feat (ResNet31)': lambda: m.backbone(x),
              'neck (FPNOCR)': lambda: m.neck(feats),
              'head (SegHead)': lambda: m.head(neck),
              'forward_test_nar': lambda: m.forward_test_nar(x)}
        st = {k: cuda_ms(fn, 3) for k, fn in st.items()}
    log(f'seg serving B={B} bf16 64 x 256 ({SEG_CONFIG}): {B / ms:.1f} '
        f'images/s ({ms * 1e3:.3f} ms/batch, best of 2 rounds of 3; '
        f'{fmt(ts)}); stages (CUDA events, mean of 3): '
        + ', '.join(f'{k} {v:.3f} ms' for k, v in st.items())
        + f'; the f32 logits to the host ({host.nbytes / 2 ** 20:.0f} MiB) '
        f'{copy_s * 1e3:.1f} ms; host tensor2str of the {B} maps '
        f'{decode_s * 1e3:.1f} ms ({B / decode_s:.1f} images/s); first '
        f'texts {texts[:3]} [{name}]')
    state = {k: v.detach().float().cpu() for k, v in m.state_dict().items()}
    del rec, m, out, host, feats, neck, x
    torch.cuda.empty_cache()

    # float32, the card against the CPU (TF32 off)
    _, model32 = model_cfg(SEG_CONFIG, 'float32')
    rg = build_recognizer(model32, device=dev)
    rc = build_recognizer(model32, device=cpu)
    for r in (rg, rc):
        r.model.load_state_dict(state)
    x8 = img[:B_SEG_F32]
    zero_launches()
    lk = rg.predict(x8).cpu()
    read_launches('seg', f'float32 predict B={B_SEG_F32}', {})
    lp = rc.predict(x8.cpu())
    err = float((lk - lp).abs().max())
    bound = SEG_F32_RTOL * float(lp.abs().max())
    top2 = torch.topk(lp, 2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) < NEAR_TIE
    part = lk.argmax(-1) != lp.argmax(-1)
    if not err <= bound or bool((part & ~tie).any()):
        raise AssertionError(f'seg float32: logits part by {err:.4g} '
                             f'(bound {bound:.4g}), {int((part & ~tie).sum())}'
                             f' pixels part off a CPU near-tie')
    metas = [{'valid_ratio': float(v)}
             for v in np.linspace(0.5, 1.0, B_SEG_F32)]
    tk = rg.label_convertor.tensor2str(lk.numpy(), metas)[0]
    tp = rc.label_convertor.tensor2str(lp.numpy(), metas)[0]
    # texts equal where no pixel is a CPU near-tie, and wherever the two
    # argmax maps are equal (the decode of equal maps)
    clean = [i for i in range(B_SEG_F32) if not bool(tie[i].any())]
    same = [i for i in range(B_SEG_F32) if not bool(part[i].any())]
    if any(tk[i] != tp[i] for i in set(clean) | set(same)):
        raise AssertionError(f'seg float32: texts {tk} against {tp}')
    log(f'seg float32 B={B_SEG_F32}, card against CPU: max abs logit error '
        f'{err:.4g} (<= {bound:.4g}, SEG_F32_RTOL x the largest), '
        f'{int(part.sum())} pixels part, none off a CPU top-2 gap below '
        f'{NEAR_TIE} ({int(tie.sum())} such pixels); texts equal on the '
        f'{len(clean)} images without one and on the {len(same)} whose '
        f'argmax maps are equal; texts {tk} [{name}]')
    section('seg serving')

    # training: B_PRE_TRAIN bf16 steps, then a float32 step against the CPU
    rt = build_recognizer(model_cfg(SEG_CONFIG, 'bfloat16')[1], device=dev,
                          param_dtype='float32')
    rt.model.load_state_dict(state)
    xt = torch.from_numpy(g.standard_normal((B_PRE_TRAIN, 64, 256, 3))
                          .astype(np.float32)).to(dev)
    gt = np.kron(g.integers(0, C, (B_PRE_TRAIN, 8, 32)),
                 np.ones((1, 8, 8), np.int64))
    gt[g.random(gt.shape) < 0.02] = 255
    batch = dict(img=xt, gt_seg=gt.astype(np.int32))

    def seg_step(r):
        opt, _ = build_optimizer(dict(SEG_OPT), r.model.named_parameters())
        return make_train_step(r, opt)

    step = seg_step(rt)
    zero_launches()
    losses = [float(step(batch)['loss']) for _ in range(2)]
    read_launches('seg', f'2 training steps B={B_PRE_TRAIN}', {})
    ms_t, ts_t = timed(lambda: step(batch))
    if not all(np.isfinite(losses)):
        raise AssertionError(f'seg train: losses {losses}')
    small = dict(img=xt[:B_SEG_F32], gt_seg=batch['gt_seg'][:B_SEG_F32])
    mets = []
    for r in (rg, rc):
        mt = seg_step(r)(dict(small, img=small['img'].to(r.device)))
        mets.append((float(mt['loss']), float(mt['grad_norm'])))
    (lk_, nk), (lp_, np_) = mets
    if not (abs(lk_ - lp_) <= SEG_LOSS_RTOL * abs(lp_)
            and abs(nk - np_) <= SEG_GRAD_NORM_RTOL * abs(np_)):
        raise AssertionError(f'seg train check: loss {lk_} / {lp_}, grad '
                             f'norm {nk} / {np_}')
    log(f'seg train B={B_PRE_TRAIN}, f32 parameters, bf16 autocast, '
        f'{SEG_OPT["type"]} lr {SEG_OPT["lr"]}: {ms_t * 1e3:.2f} ms/step, '
        f'{B_PRE_TRAIN / ms_t:.1f} images/s (best of 2 rounds of 3; '
        f'{fmt(ts_t)}); losses {losses}; float32 step B={B_SEG_F32}, card / '
        f'CPU: loss {lk_:.7f} / {lp_:.7f} (rel {abs(lk_ - lp_) / abs(lp_):.3g}'
        f' <= {SEG_LOSS_RTOL}), grad norm {nk:.6f} / {np_:.6f} (rel '
        f'{abs(nk - np_) / abs(np_):.3g} <= {SEG_GRAD_NORM_RTOL}); no kernel '
        f'launched [{name}]')
    del rt, rg, rc, step, xt, batch, small, img, state
    torch.cuda.empty_cache()
    section('seg training')

    # ==== the preprocessors ============================================
    rows, launches = {}, {}

    def preproc(family, path, pre, kind, shape, offs_hw, serve_want,
                train_want, fc2_scale=None):
        """Serving (B=512 and 5) and training (B_PRE_TRAIN) of the config
        at ``path`` with the preprocessor ``pre``, kernel path against
        plain path; its offset samples' row inputs into ``rows``."""
        dropout = 0.0 if kind is SPIN else None
        cfg, model = model_cfg(path, 'bfloat16', pre)
        rec = build_recognizer(model, device=dev)
        p = rec.model.preprocessor
        if not isinstance(p, kind) or \
                rec.resolved_decode_mode() != 'single_pass':
            raise AssertionError(f'{family}: built {type(p).__name__}, '
                                 f'{rec.resolved_decode_mode()}')
        rec.init_weights(SEED)
        if fc2_scale:         # SPIN off its near-identity start
            gen = torch.Generator().manual_seed(SEED + 18)
            with torch.no_grad():
                p.fc2.weight.copy_(fc2_scale * torch.randn(
                    tuple(p.fc2.weight.shape), generator=gen))
        x = torch.from_numpy(g.standard_normal((B,) + shape).astype(
            np.float32)).to(dev)
        vr5 = np.array([1.0, 0.6, 0.85, 0.35, 1.0], np.float32)
        zero_launches()
        with OffsetSamples(offs_hw) as serve_samples:
            pk = rec.predict(x)
            pk5 = rec.predict(x[:5], vr5)
        read_launches(family, 'serving B=512 and B=5', serve_want)
        zero_launches()
        rec.plain = True
        pp, pp5 = rec.predict(x), rec.predict(x[:5], vr5)
        # the plain path's own spread when only its warps' rounding
        # changes: the gather + lerp for ATen's warps, and the two-stage
        # sampler's plain version for the dense one's where TPS++ is
        tps = rec.model.tpsnet
        plain_fn, gs.grid_sample_plain = gs.grid_sample_plain, gather_plain
        if tps is not None:
            sample_mode, tps.sample_mode = tps.sample_mode, 'pallas'
            os.environ['TPS_SAMPLER_VARIANT'] = 'twostage'
        try:
            p2 = rec.predict(x)
        finally:
            gs.grid_sample_plain = plain_fn
            if tps is not None:
                tps.sample_mode = sample_mode
                os.environ.pop('TPS_SAMPLER_VARIANT')
        read_launches(family, 'plain paths', {})
        if not bool(torch.isfinite(pk).all()):
            raise AssertionError(f'{family}: non-finite logits')
        _, n_spread, spread = check_logits(p2, pp, f'{family} spread', 1e9)
        near_tie = max(TIE_MULT * spread, NEAR_TIE)
        err, parts, widest = check_logits(pk, pp, f'{family} B={B}',
                                          near_tie)
        err5, parts5, widest5 = check_logits(pk5, pp5, f'{family} B=5',
                                             near_tie)
        ms_p, _ = timed(lambda: rec.predict(x))
        rec.plain = False
        ms, ts = timed(lambda: rec.predict(x))
        with torch.inference_mode():
            xb = x.to(bf)
            st = {'preprocessor': lambda: p(xb),
                  'forward_test_nar': lambda: rec.model.forward_test_nar(xb)}
            st = {k: cuda_ms(fn, 5) for k, fn in st.items()}
        log(f'{family} serving B={B} bf16 {shape}: {B / ms:.1f} images/s '
            f'({ms * 1e3:.3f} ms/batch, best of 2 rounds of 3; {fmt(ts)}; '
            f'the plain path {ms_p * 1e3:.3f} ms); stages (CUDA events, mean '
            f'of 5): ' + ', '.join(f'{k} {v:.3f} ms' for k, v in st.items())
            + f'; the plain path with the gather + lerp warps parts from '
            f'itself at {n_spread} of {pk.numel() // pk.shape[-1]} positions '
            f'(widest gap {spread:.4g}): near-tie {near_tie:.4g}; kernel path '
            f'against plain path B={B}: {parts} positions part (widest '
            f'{widest:.4g}), max abs logit error {err:.4g}; B=5: {parts5} '
            f'part (widest {widest5:.4g}), {err5:.4g}; offset-map samples '
            f'through kernel 8: {serve_samples.fwd}; first texts '
            f'{[r["text"] for r in rec.simple_test(x[:3])]} [{name}]')
        state0 = {k: v.detach().float() for k, v in
                  rec.model.state_dict().items()}
        lc = rec.label_convertor
        del rec, pk, pp, p2, pk5, pp5, xb
        torch.cuda.empty_cache()

        # training: an f32-compute step, kernel path against plain path,
        # then bf16 steps, timed against the plain path
        tc = train_cfg_of(cfg)
        bt = B_PRE_TRAIN
        chars = lc.idx2char[1:37] if kind is MORAN else lc.idx2char[:36]
        td = lc.str2tensor([''.join(g.choice(chars, int(g.integers(1, 13))))
                            for _ in range(bt)])
        tbatch = dict(img=x[:bt].contiguous(),
                      valid_ratio=np.ones(bt, np.float32),
                      padded_targets=td['padded_targets'],
                      target_lengths=td['target_lengths'])

        def trainer(dtype):
            rt = build_recognizer(model_cfg(path, dtype, pre, dropout)[1],
                                  device=dev, param_dtype='float32')
            if dropout == 0.0:
                rt.model.decoder.token_encoder.dropout = 0.0
            rt.model.load_state_dict(state0)
            return rt

        def step_fn(rt):
            opt, _ = build_optimizer_from_run_cfg(
                tc, rt.model.named_parameters(), steps_per_epoch=1,
                total_epochs=tc['total_epochs'])
            return make_train_step(rt, opt)

        rt = trainer('float32')
        res = {}
        for plain in (False, True):
            rt.model.load_state_dict(state0)
            zero_launches()
            with OffsetSamples(offs_hw) as train_samples:
                mets = step_fn(rt)(tbatch, plain=plain)
            read_launches(family, f'train check step, f32 compute, '
                          f'{"plain" if plain else "kernel"} path',
                          {} if plain else train_want)
            if not plain:
                kernel_samples = train_samples
            res[plain] = (float(mets['loss']), float(mets['grad_norm']))
        (lk_, nk), (lp_, np_) = res[False], res[True]
        if not (np.isfinite(lk_) and abs(lk_ - lp_) <= LOSS_RTOL * abs(lp_)
                and abs(nk - np_) <= GRAD_NORM_RTOL * abs(np_)):
            raise AssertionError(f'{family} train: loss {lk_} / {lp_}, '
                                 f'grad norm {nk} / {np_}')
        rt = trainer('bfloat16')
        step = step_fn(rt)
        zero_launches()
        losses = [float(step(tbatch)['loss']) for _ in range(2)]
        read_launches(family, f'2 bf16 training steps B={bt}',
                      {k: 2 * n for k, n in train_want.items()})
        ms_t, ts_t = timed(lambda: step(tbatch))
        ms_tp, _ = timed(lambda: step(tbatch, plain=True))
        if not all(np.isfinite(losses)):
            raise AssertionError(f'{family} train: losses {losses}')
        log(f'{family} train B={bt}, f32 parameters, bf16 autocast, '
            f'{tc["optimizer"]["type"]} lr {tc["optimizer"]["lr"]}: f32 '
            f'check step loss {lk_:.6f} kernel / {lp_:.6f} plain, grad_norm '
            f'{nk:.6f} / {np_:.6f}; {ms_t * 1e3:.2f} ms/step, '
            f'{bt / ms_t:.1f} images/s (best of 2 rounds of 3; {fmt(ts_t)}; '
            f'the plain path {ms_tp * 1e3:.2f} ms); bf16 losses {losses}; '
            f'offset-map d_img through kernel 10: {kernel_samples.bwd} '
            f'[{name}]')
        rows[kind.__name__] = (serve_samples, kernel_samples)
        launches[kind.__name__] = (serve_samples.fwd, kernel_samples.bwd)
        del rt, step, tbatch, x
        torch.cuda.empty_cache()

    preproc('crnn_moran', CRNN_CONFIG, MORAN_PRE, MORAN, (32, 100, 1),
            (3, 11), {'grid_sample_forward': 6},
            {'grid_sample_forward': 3, 'grid_sample_grad': 1,
             'grid_sample_grad_img': 1})
    section('crnn_moran')
    preproc('abinet_spin', ABINET_CONFIG, dict(type='SPIN'), SPIN,
            (32, 128, 3), (2, 8), {'tps_sampler': 2, 'grid_sample_forward': 2},
            {'grid_sample_forward': 2, 'grid_sample_grad': 1,
             'grid_sample_grad_img': 1}, fc2_scale=SPIN_FC2_SCALE)
    section('abinet_spin')

    # ==== the offset samples' rows: the paths' own inputs ================
    src = 'tps_pp_tpu_torch/csrc/grid_sample.cu'
    out = {}

    def aten_fwd(x, gr):
        return F.grid_sample(x.permute(0, 3, 1, 2), gr.to(x.dtype),
                             mode='bilinear', padding_mode='border',
                             align_corners=True)

    for kind, key in (('MORAN', 'moran'), ('SPIN', 'spin')):
        serve, train = rows[kind]
        o, og = serve.fwd_args
        ogt, cot = train.bwd_args
        (n, h, w, c), (bt, hs, ws) = o.shape, ogt.shape[:3]
        e_f = check_close(f'{key} offsets forward',
                          gs.grid_sample_forward(o, og),
                          gs.grid_sample_plain(o, og),
                          WARP_BOUNDS['bfloat16']['fwd'])
        e_b = check_close(f'{key} offsets d_img',
                          gs.grid_sample_grad_img(ogt, cot, h, w),
                          gs.grid_sample_grad_img_plain(ogt, cot, h, w),
                          WARP_BOUNDS['float32']['d_img'])
        zeros = torch.zeros((bt, c, h, w), dtype=cot.dtype, device=dev)
        # the offset map in, the grid, the upsampled map out
        npix = og.shape[1] * og.shape[2]
        moved = nbytes(o, og) + n * npix * c * o.element_size()
        plan = gs.grid_sample_fwd_plan(n, h, w, c, npix, o.dtype)
        sets = [(o, og)] + [(o.clone(), og.clone())
                            for _ in range(cold_copies(moved) - 1)]
        record(f'grid_sample_{key}_offsets', src,
               'tps_pp_tpu/ops/pallas_grid_sample.py:126',
               lambda: gs.grid_sample_forward(o, og),
               lambda: gs.grid_sample_plain(o, og), e_f, 20, moved,
               f32_flops=n * npix * c * 8, fn_lib=lambda: aten_fwd(o, og),
               cold=(rotated(gs.grid_sample_forward, sets),
                     rotated(aten_fwd, sets)),
               label=f'grid_sample_{key}_offsets: kernel 8, C={c} '
                     f'{o.dtype} B={n}, {h} x {w} -> {og.shape[1]} x '
                     f'{og.shape[2]}, plan {plan}', graph=True)
        del sets
        record(f'grid_sample_grad_img_{key}_offsets', src,
               'tps_pp_tpu/ops/pallas_grid_sample.py:178',
               lambda: gs.grid_sample_grad_img(ogt, cot, h, w),
               lambda: gs.grid_sample_grad_img_plain(ogt, cot, h, w), e_b,
               20,
               # grid and cotangent in, the f32 d_img of the map out
               nbytes(ogt, cot) + bt * h * w * c * 4,
               f32_flops=bt * hs * ws * c * 8,
               fn_lib=lambda: torch.ops.aten.grid_sampler_2d_backward(
                   cot.permute(0, 3, 1, 2), zeros, ogt, 0, 1, True,
                   [True, False]),
               label=f'grid_sample_grad_img_{key}_offsets: kernel 10, '
                     f'C={c} {cot.dtype} B={bt}, {hs} x {ws} samples into '
                     f'{h} x {w}, band plan '
                     f'{gs.grid_sample_plan(bt, h, w, c)}', graph=True)
        out[f'grid_sample_{key}_offsets'] = launches[kind][0]
        out[f'grid_sample_grad_img_{key}_offsets'] = launches[kind][1]
    section('kernel rows')
    log(f'seg_preproc phase: {time.perf_counter() - t_phase:.1f} s (by '
        f'section: {sections}); the offset rows\' launches on the paths '
        f'{json.dumps(out)}')
    return out


def word_quads(g, hw=(640, 640), shrink=0.0):
    """``DET_WORDS`` word quads of a page (``DET_WORD_H`` px tall,
    ``DET_WORD_ASPECT`` times as wide, tilted up to ``DET_WORD_TILT``
    degrees), each shrunk by DB's offset D = A (1 - r^2) / L of
    ``shrink`` (0: whole): (4, 2) float32 corners."""
    import numpy as np
    H, W = hw
    out = []
    for _ in range(int(g.integers(*DET_WORDS, endpoint=True))):
        h = g.uniform(*DET_WORD_H)
        w = h * g.uniform(*DET_WORD_ASPECT)
        d = w * h * (1 - shrink ** 2) / (2 * (w + h)) if shrink else 0.0
        kw, kh = w - 2 * d, h - 2 * d
        a = np.deg2rad(g.uniform(-DET_WORD_TILT, DET_WORD_TILT))
        cx, cy = g.uniform(w / 2, W - w / 2), g.uniform(h / 2, H - h / 2)
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        out.append(((np.array([[-kw, -kh], [kw, -kh], [kw, kh], [-kw, kh]])
                     / 2) @ rot.T + [cx, cy]).astype(np.float32))
    return out


def trained_like_maps(g, n, hw=(640, 640)):
    """``n`` probability maps shaped like a trained DBNet's: the
    ``word_quads`` of a page, each drawn by ``cv_ops.fill_poly`` as DB's
    shrunk text kernel (``DB_SHRINK``), at 0.95 under a 5 x 5 box blur,
    over a background of U(0, 0.1). The postprocessor's cost on such a
    map, not on a map of random weights."""
    import numpy as np
    from tps_pp_tpu_torch.datasets.pipelines import cv_ops
    H, W = hw
    out = []
    for _ in range(n):
        kern = np.zeros((H, W), np.float32)
        for quad in word_quads(g, hw, DB_SHRINK):
            cv_ops.fill_poly(kern, [np.rint(quad).astype(np.int32)], 1.0)
        for axis in (0, 1):
            pad = np.pad(kern, [(2, 2) if i == axis else (0, 0)
                                for i in (0, 1)], mode='edge')
            kern = sum(np.take(pad, range(i, i + kern.shape[axis]),
                               axis=axis) for i in range(5)) / 5
        out.append(np.clip(0.95 * kern + g.uniform(0, 0.1, (H, W)), 0, 1)
                   .astype(np.float32))
    return np.stack(out)


def det_phase(dev, name):
    """Text detection on ``dev``, the card (see the module docstring):
    both DBNet configs through ``init_detector``, ``detect_batch`` timed by
    stage, the float32 maps and boundaries against the CPU, and
    ``MMOCR.readtext``; the detector's forward launches no hand-written
    kernel."""
    import math

    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import MMOCR, TextDetector, init_detector
    from tps_pp_tpu_torch.ops.deform_conv import ModulatedDeformConv

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    g = np.random.default_rng(SEED + 19)
    sections, t_sec = {}, [time.perf_counter()]

    def section(what):
        now = time.perf_counter()
        sections[what] = round(now - t_sec[0], 1)
        t_sec[0] = now

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def stage_ms(det, x, reps=3):
        """Device ms of the trunk, the neck and the head on ``x``, and of
        the DCNv2 layers inside the trunk (CUDA events, the mean of
        ``reps`` runs after one)."""
        m = det.model
        pairs = []
        hooks = []
        for mod in m.modules():
            if isinstance(mod, ModulatedDeformConv):
                hooks.append(mod.register_forward_pre_hook(
                    lambda *_: pairs.append([event(), None])))
                hooks.append(mod.register_forward_hook(
                    lambda *_: pairs[-1].__setitem__(1, event())))
        ms, dcn = np.zeros(3), 0.0
        with torch.inference_mode():
            for r in range(reps + 1):
                pairs.clear()
                e0 = event()
                feats = m.backbone(x)
                e1 = event()
                fused = m.neck(feats)
                e2 = event()
                m.head(fused)
                e3 = event()
                torch.cuda.synchronize()
                if r:
                    ms += [e0.elapsed_time(e1), e1.elapsed_time(e2),
                           e2.elapsed_time(e3)]
                    dcn += sum(a.elapsed_time(b) for a, b in pairs)
        for h in hooks:
            h.remove()
        return ms / reps, dcn / reps

    def n_boxes(det, x):
        prob = det.forward(x)[..., 0].cpu().numpy()
        return sum(len(b) for b in det.postprocess(prob,
                                                   [(1.0, 1.0)] * len(x)))

    def move_bias(det, shift):
        with torch.no_grad():
            det.model.head.binarize[6].bias.add_(shift)

    def stress(det, x, key):
        """The stress test: shift the probability branch's last bias so
        that a share of the map's pixels on ``x`` lie above the mask
        threshold, the first share of ``DET_STRESS_ABOVE`` at which ``x``
        keeps ``DET_MIN_BOXES`` boxes; returns (share, shift, boxes)."""
        logit = torch.logit(det.forward(x)[..., 0]).flatten()[::7].cpu()
        thr = det.postprocessor.mask_thr
        for above in DET_STRESS_ABOVE:
            shift = (math.log(thr / (1 - thr))
                     - float(torch.quantile(logit, 1 - above)))
            move_bias(det, shift)
            boxes = n_boxes(det, x)
            if boxes >= DET_MIN_BOXES:
                return above, shift, boxes
            move_bias(det, -shift)
        raise AssertionError(f'{key}: no share in {DET_STRESS_ABOVE} keeps '
                             f'{DET_MIN_BOXES} boxes on {len(x)} images')

    def post_ms(det, prob):
        t0 = time.perf_counter()
        boxes = det.postprocess(prob, [(1.0, 1.0)] * len(prob))
        return ((time.perf_counter() - t0) / len(prob) * 1e3,
                sum(len(b) for b in boxes) / len(prob))

    stats, levels = {}, {}
    for key, (path, n) in DET_CONFIGS.items():
        det = init_detector(os.path.join(repo, path), device=dev, seed=SEED)
        if det.device.type != 'cuda' or det.model.training:
            raise AssertionError(f'{key}: built on {det.device}')
        imgs = [g.integers(0, 256, (640, 640, 3), np.uint8)
                for _ in range(n)]
        # ---- the forward launches no hand-written kernel
        zero_launches()
        det.forward(np.stack([det.prep(i)[0] for i in imgs]))
        read_launches('det', f'{key} forward', {})
        # ---- detect_batch, whole and by stage, warm: the host's prep, the
        # batch's copy to the card, the forward on the card's tensor (and
        # by stage), the map's copy to the host, the postprocessor
        det.detect_batch(imgs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = det.detect_batch(imgs)
        whole = (time.perf_counter() - t0) / n
        if len(out) != n:
            raise AssertionError(f'{key}: {len(out)} results for {n}')
        t0 = time.perf_counter()
        preps = [det.prep(i) for i in imgs]
        prep = (time.perf_counter() - t0) / n
        batch = np.stack([p[0] for p in preps])
        h2d = cuda_ms(lambda: torch.as_tensor(batch).to(dev), 3) / n
        x = torch.as_tensor(batch, device=dev)
        fwd = cuda_ms(lambda: det.forward(x), 3) / n
        maps = det.forward(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prob = maps[..., 0].cpu().numpy()
        copy = (time.perf_counter() - t0) / n
        post, per_img = post_ms(det, prob)
        (trunk, neck, head), dcn = stage_ms(det, x)
        trunk, neck, head, dcn = trunk / n, neck / n, head / n, dcn / n
        log(f'det {key} B={n} 640x640 (f32, TF32 off): detect_batch '
            f'{whole * 1e3:.2f} ms/image; host prep {prep * 1e3:.2f}, '
            f'batch copy to the card {h2d:.3f}, forward on the card\'s '
            f'tensor {fwd:.3f} (by stage: trunk {trunk:.3f}, of which DCNv2 '
            f'{dcn:.3f}; neck {neck:.3f}; head {head:.3f}; sum '
            f'{trunk + neck + head:.3f}), map copy {copy * 1e3:.3f}, '
            f'DBPostprocessor {post:.2f} ms/image ({per_img:.1f} boxes an '
            f'image, seed-0 map) [{name}]')
        # ---- the postprocessor on trained-like maps (the same for both
        # configs: it sees only the map)
        post_t, per_img_t = post_ms(det, trained_like_maps(
            np.random.default_rng(SEED + 1900), 8))
        log(f'det {key} trained-like maps ({DET_WORDS} word quads a page, '
            f'{DET_WORD_H} px tall): DBPostprocessor {post_t:.2f} ms/image, '
            f'{per_img_t:.1f} boxes an image [{name}]')
        section(f'{key} timing')
        # ---- the stress test: the postprocessor on the stressed map
        xb = x[:B_DET_F32]
        above, shift, _ = stress(det, xb, key)
        levels[key] = above
        prob = det.forward(x[:4])[..., 0].cpu().numpy()
        post_s, per_img_s = post_ms(det, prob)
        log(f'det {key} stress test (bias {shift:+.4f}, '
            f'{float((prob > det.postprocessor.mask_thr).mean()):.3f} of '
            f'the pixels above the threshold, the share {above} of '
            f'{DET_STRESS_ABOVE}): DBPostprocessor {post_s:.1f} ms/image, '
            f'{per_img_s:.1f} boxes an image [{name}]')
        stats[f'{key} timing'] = dict(
            prep=prep * 1e3, h2d=h2d, forward=fwd, trunk=trunk, dcn=dcn,
            neck=neck, head=head, copy=copy * 1e3, post_seed0=post,
            post_trained_like=post_t, post_stress=post_s, stress=above)
        # ---- the card against the CPU, float32, TF32 off
        cpu_det = TextDetector(det.model_cfg, det.img_size, device='cpu')
        cpu_det.model.load_state_dict({k: v.cpu() for k, v in
                                       det.model.state_dict().items()})
        for label, stressed in (('stressed', True), ('seed-0', False)):
            if not stressed:
                move_bias(det, -shift)
                move_bias(cpu_det, -shift)
            got = det.forward(xb).cpu()
            want = cpu_det.forward(xb.cpu())
            err = [float(v) for v in
                   (got - want).abs().amax(dim=(0, 1, 2))]
            if max(err) > DET_F32_ATOL:
                raise AssertionError(f'{key} {label}: maps {err} apart '
                                     f'(bound {DET_F32_ATOL})')
            pc, pw = got[..., 0].numpy(), want[..., 0].numpy()
            thr = det.postprocessor.mask_thr
            flips = int(((pc > thr) != (pw > thr)).sum())
            # where the masks part, the CPU map takes the card's value, so
            # that the two masks are equal
            pw = np.where((pc > thr) == (pw > thr), pw, pc)
            n_box = 0
            for a, b in zip(det.postprocess(pc, [(1.0, 1.0)] * len(pc)),
                            det.postprocess(pw, [(1.0, 1.0)] * len(pw))):
                if len(a) != len(b) or any(
                        np.abs(u[:-1] - v[:-1]).max() > 1e-3
                        or abs(u[-1] - v[-1]) > DET_F32_ATOL
                        for u, v in zip(a, b)):
                    raise AssertionError(f'{key} {label}: boundaries part')
                n_box += len(a)
            # the stressed map keeps DET_MIN_BOXES; the seed-0 map one box
            # an image
            least = DET_MIN_BOXES if stressed else len(pc)
            if n_box < least:
                raise AssertionError(f'{key} {label}: {n_box} boundaries '
                                     f'compared, fewer than {least}')
            log(f'det {key} {label} B={B_DET_F32}: the card against the '
                f'CPU, maps [prob, thr, binary] within {err} (bound '
                f'{DET_F32_ATOL}); {flips} mask pixels part; {n_box} '
                f'boundaries equal on equal masks')
            stats[f'{key} {label}'] = dict(err=err, flips=flips,
                                           boxes=n_box)
        section(f'{key} checks')
        del det, cpu_det, x, xb, maps
        torch.cuda.empty_cache()

    # ---- MMOCR.readtext: DBNet-R18 and NRTR + TPS++ from their configs, on
    # the seed-0 map (one box a page) and on the stress test's
    reader = MMOCR(det=os.path.join(repo, DET_CONFIGS['dbnet_r18'][0]),
                   recog='NRTR_TPS', device=dev)
    pages = [g.integers(0, 256, (*PAGE_HW, 3), np.uint8)
             for _ in range(N_PAGES)]
    reader.readtext(pages[:1])
    for label in ('seed-0', 'stressed'):
        if label == 'stressed':
            x = torch.as_tensor(np.stack(
                [reader.detector.prep(p)[0] for p in pages[:2]]), device=dev)
            thr = reader.detector.postprocessor.mask_thr
            logit = torch.logit(reader.detector.forward(x)[..., 0])
            q = float(torch.quantile(logit.flatten()[::7].cpu(),
                                     1 - levels['dbnet_r18']))
            move_bias(reader.detector, math.log(thr / (1 - thr)) - q)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        res = reader.readtext(pages, merge=True)
        torch.cuda.synchronize()
        whole = (time.perf_counter() - t0) / N_PAGES
        rec_launches = read_launches('det', f'readtext {label}',
                                     {'tps_sampler': None})
        if len(res) != N_PAGES or any(not isinstance(r['result'], list)
                                      for r in res):
            raise AssertionError(f'readtext: {res!r:.300}')
        t_det = t_crop = t_rec = 0.0
        n_crops = 0
        for page in pages:
            t0 = time.perf_counter()
            bounds = reader.detector.detect(page)
            t1 = time.perf_counter()
            crops, _ = reader.crops(page, bounds)
            t2 = time.perf_counter()
            if crops:
                reader.recognize(crops)
            torch.cuda.synchronize()
            t_det += t1 - t0
            t_crop += t2 - t1
            t_rec += time.perf_counter() - t2
            n_crops += len(crops)
        log(f'det readtext {N_PAGES} pages {PAGE_HW[1]}x{PAGE_HW[0]} '
            f'(DBNet-R18 f32 at 640x640, {label} map; NRTR + TPS++ f32 from '
            f'its config): {whole * 1e3:.1f} ms/page; detection '
            f'{t_det / N_PAGES * 1e3:.1f}, crops '
            f'{t_crop / N_PAGES * 1e3:.2f}, recognition '
            f'{t_rec / N_PAGES * 1e3:.1f} ms/page; {n_crops / N_PAGES:.1f} '
            f'boxes a page; launches {rec_launches} [{name}]')
        section(f'readtext {label}')
    log(f'det phase: {time.perf_counter() - t_phase:.1f} s (by section: '
        f'{sections}); the detector forward launched no hand-written '
        f'kernel; {json.dumps(stats)}')


class DetPages:
    """``n`` seeded 640 x 640 pages for ``train_detector``: uint8 noise as
    float32 in [0, 1] and the ``word_quads`` of each page as its
    polygons; a fresh dict an item (the loop adds targets to it)."""

    def __init__(self, g, n, hw=(640, 640), words=None):
        """``words``: (least, most) of each page's quads kept, where
        given."""
        import numpy as np
        self.items = []
        for _ in range(n):
            img = (g.integers(0, 256, (*hw, 3), np.uint8).astype(np.float32)
                   / 255.0)
            quads = word_quads(g, hw)
            if words is not None:
                quads = quads[:int(g.integers(*words, endpoint=True))]
            self.items.append(dict(img=img, gt_polygons=quads,
                                   gt_polygons_ignore=[]))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return dict(self.items[i])


def pan_pse_maps(det, g, n):
    """``n`` raw logit maps shaped like a trained PANet's or PSENet's, at
    the head's 1/4 of 640 x 640: the ``word_quads`` of a page through the
    config's targets (``PANetTargets``: instance texts and kernels;
    ``PSENetTargets``: text and six nested kernels), at the head's scale,
    +/-8 inside and out, PAN's embedding one constant 4-vector an instance
    (zero outside), plus N(0, 0.5) noise."""
    import numpy as np
    from tps_pp_tpu_torch.apis.train_det import DetBatches
    batches = DetBatches(det.model_cfg, DetPages(g, n), None)
    _, tgt = batches(range(n))
    if det.det_type == 'PANet':
        texts, kernels = tgt['gt_texts'], tgt['gt_kernels']
        emb = g.normal(0, 3, (int(texts.max()) + 1, 4)).astype(np.float32)
        emb[0] = 0
        logits = np.concatenate([
            (np.stack([texts, kernels], -1) > 0) * 16.0 - 8.0,
            emb[texts.astype(int)]], -1)
    else:
        logits = np.moveaxis(tgt['gt_kernels'], 1, -1) * 16.0 - 8.0
    return (logits + g.normal(0, 0.5, logits.shape)).astype(np.float32)


def det_train_phase(dev, name):
    """Detection training and PANet / PSENet on ``dev``, the card (see the
    module docstring); nothing here launches a hand-written kernel."""
    import tempfile

    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import TextDetector, init_detector
    from tps_pp_tpu_torch.apis.train_det import (DetBatches, _make_optimizer,
                                                 make_det_train_step,
                                                 train_detector)
    from tps_pp_tpu_torch.config import load_config
    from tps_pp_tpu_torch.registry import LOSSES

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    g = np.random.default_rng(SEED + 20)
    stats = {}

    def masks(det, maps):
        """The pixels' decisions the postprocessor takes from its maps."""
        score = 1.0 / (1.0 + np.exp(-maps))
        if det.det_type == 'PANet':
            return score[..., :2] > 0.5
        return score > det.postprocessor.min_kernel_confidence

    def post(det, maps):
        t0 = time.perf_counter()
        out = det.postprocess(maps, [(1.0, 1.0)] * len(maps))
        return ((time.perf_counter() - t0) / len(maps) * 1e3,
                sum(len(b) for b in out) / len(maps), out)

    # ---- PANet-R18 and PSENet-R50 serving at 640 x 640, f32 -------------
    for key, (path, n) in PAN_PSE_CONFIGS.items():
        det = init_detector(os.path.join(repo, path), device=dev, seed=SEED)
        if det.device.type != 'cuda' or det.model.training:
            raise AssertionError(f'{key}: built on {det.device}')
        imgs = [g.integers(0, 256, (640, 640, 3), np.uint8)
                for _ in range(n)]
        zero_launches()
        det.forward(np.stack([det.prep(i)[0] for i in imgs]))
        read_launches('det-train', f'{key} forward', {})
        det.detect_batch(imgs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = det.detect_batch(imgs)
        whole = (time.perf_counter() - t0) / n
        if len(out) != n:
            raise AssertionError(f'{key}: {len(out)} results for {n}')
        t0 = time.perf_counter()
        batch = np.stack([det.prep(i)[0] for i in imgs])
        prep = (time.perf_counter() - t0) / n
        h2d = cuda_ms(lambda: torch.as_tensor(batch).to(dev), 3) / n
        x = torch.as_tensor(batch, device=dev)
        fwd = cuda_ms(lambda: det.forward(x), 3) / n
        maps = det.forward(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = det.host_maps(maps)
        copy = (time.perf_counter() - t0) / n
        post_ms, per_img, _ = post(det, host)
        tl = pan_pse_maps(det, np.random.default_rng(SEED + 2000),
                          N_TRAINED_LIKE)
        post_t, per_img_t, _ = post(det, tl)
        log(f'det-train {key} B={n} 640x640 (f32, TF32 off): detect_batch '
            f'{whole * 1e3:.2f} ms/image; host prep {prep * 1e3:.2f}, '
            f'batch copy to the card {h2d:.3f}, forward on the card\'s '
            f'tensor {fwd:.3f}, logits copy {copy * 1e3:.3f}, '
            f'{type(det.postprocessor).__name__} {post_ms:.2f} ms/image '
            f'({per_img:.1f} boxes an image, seed-0 maps); trained-like '
            f'maps {post_t:.2f} ms/image ({per_img_t:.1f} boxes an image) '
            f'[{name}]')
        stats[f'{key} serving'] = dict(
            detect_batch=whole * 1e3, prep=prep * 1e3, h2d=h2d, forward=fwd,
            copy=copy * 1e3, post_seed0=post_ms, boxes_seed0=per_img,
            post_trained_like=post_t, boxes_trained_like=per_img_t)
        # ---- the card against the CPU at B_DET_F32, float32, TF32 off: the
        # seed-0 maps, then the stressed ones (each channel's bound scaled
        # with it)
        cpu_det = TextDetector(det.model_cfg, det.img_size, device='cpu')
        cpu_det.model.load_state_dict({k: v.cpu() for k, v in
                                       det.model.state_dict().items()})
        xb = x[:B_DET_F32]
        scale = np.ones(det.model.head.out_conv.out_channels)
        for label in ('seed-0', 'stressed'):
            if label == 'stressed':
                logit = det.forward(xb)
                k = logit.shape[-1] if det.det_type == 'PSENet' else 2
                above = np.linspace(*PAN_PSE_STRESS[det.det_type], k)
                for c in range(k):
                    lc = logit[..., c].flatten()
                    q = float(torch.quantile(lc[::3].cpu(), 1 - above[c]))
                    scale[c] = PAN_PSE_STRESS_STD / float(lc.std())
                    for d in (det, cpu_det):
                        conv = d.model.head.out_conv
                        with torch.no_grad():
                            conv.weight[c] *= scale[c]
                            conv.bias[c] = (conv.bias[c] - q) * scale[c]
            got = det.host_maps(det.forward(xb))
            want = cpu_det.host_maps(cpu_det.forward(xb.cpu()))
            err = np.abs(got - want).max(axis=(0, 1, 2)) / scale
            if err.max() > DET_F32_ATOL:
                raise AssertionError(f'{key} {label}: maps {err} apart, '
                                     f'over their scales {scale} (bound '
                                     f'{DET_F32_ATOL})')
            err = [float(v) for v in err]
            mc, mw = masks(det, got), masks(det, want)
            part = (mc != mw).any(-1)
            flips = int(part.sum())
            # where the decisions part, the CPU map takes the card's pixel
            want = np.where(part[..., None], got, want)
            _, _, bc = post(det, got)
            _, _, bw = post(det, want)
            n_box = 0
            for a, b in zip(bc, bw):
                if len(a) != len(b) or any(
                        a_.shape != b_.shape
                        or np.abs(a_[:-1] - b_[:-1]).max() > 1e-3
                        or abs(a_[-1] - b_[-1]) > DET_F32_ATOL
                        for a_, b_ in zip(a, b)):
                    raise AssertionError(f'{key} {label}: boundaries part')
                n_box += len(a)
            log(f'det-train {key} {label} B={B_DET_F32}: the card against '
                f'the CPU, logits within {max(err):.3g} of their scale '
                f'(bound {DET_F32_ATOL}); {flips} pixels\' decisions part; '
                f'{n_box} boundaries equal on equal decisions')
            stats[f'{key} {label}'] = dict(err=max(err), flips=flips,
                                           boxes=n_box)
        if n_box < DET_MIN_BOXES:
            raise AssertionError(f'{key}: {n_box} boundaries compared on '
                                 f'the stressed maps, fewer than '
                                 f'{DET_MIN_BOXES}')
        del det, cpu_det, x, xb, maps
        torch.cuda.empty_cache()

    # ---- one f32 step, the card against the CPU, B_DET_F32 pages ---------
    for key, path in DET_STEP_CONFIGS.items():
        cfg = load_config(os.path.join(repo, path))
        model_cfg = cfg['model']
        pages = DetPages(g, B_DET_F32)
        results = {}
        for where in ('card', 'cpu'):
            device = dev if where == 'card' else torch.device('cpu')
            det = TextDetector(model_cfg, device=device, seed=SEED)
            model = det.model.train()
            loss_fn = LOSSES.build(model_cfg['loss'])
            img, tgt = DetBatches(model_cfg, pages, loss_fn)(
                range(B_DET_F32))
            opt, _ = _make_optimizer(cfg, model.named_parameters())
            step = make_det_train_step(model, loss_fn, opt)
            img = torch.from_numpy(img).to(device)
            tgt = {k: torch.from_numpy(v).to(device) for k, v in tgt.items()}
            if where == 'card':
                zero_launches()
            m = step(img, tgt)
            results[where] = {k: float(v) for k, v in m.items()}
            if where == 'card':
                read_launches('det-train', f'{key} step', {})
                step_ms = cuda_ms(lambda: step(img, tgt), 3)
            del det, model
        a, b = results['card'], results['cpu']
        dl = abs(a['loss'] - b['loss']) / abs(b['loss'])
        dg = abs(a['grad_norm'] - b['grad_norm']) / abs(b['grad_norm'])
        if not (all(np.isfinite(list(a.values())))
                and dl <= DET_LOSS_RTOL and dg <= DET_GRAD_NORM_RTOL):
            raise AssertionError(f'{key} step: card {a} against the CPU '
                                 f'{b}')
        log(f'det-train {key} f32 step B={B_DET_F32} 640x640, train-mode '
            f'BatchNorm: loss {a["loss"]:.6f} (CPU {b["loss"]:.6f}, '
            f'{dl:.3g} apart, bound {DET_LOSS_RTOL}), grad norm '
            f'{a["grad_norm"]:.6f} ({dg:.3g} apart, bound '
            f'{DET_GRAD_NORM_RTOL}); {step_ms:.2f} ms a step on the card '
            f'[{name}]')
        stats[f'{key} step'] = dict(loss_rel=dl, grad_norm_rel=dg,
                                    step_ms=step_ms, **a)
        torch.cuda.empty_cache()

    # ---- train_detector: DBNet-R18 at its samples_per_gpu, a resume -----
    cfg = load_config(os.path.join(repo, DET_CONFIGS['dbnet_r18'][0]))
    bs = int(cfg['data']['samples_per_gpu'])
    pages = DetPages(g, N_DET_TRAIN_PAGES)
    with tempfile.TemporaryDirectory() as wd:
        zero_launches()
        _, opt, hist = train_detector(cfg, pages, work_dir=wd,
                                      total_epochs=DET_TRAIN_EPOCHS,
                                      batch_size=bs, seed=SEED, device=dev)
        read_launches('det-train', 'train_detector', {})
        _, opt2, again = train_detector(
            cfg, pages, total_epochs=DET_TRAIN_EPOCHS, batch_size=bs,
            seed=SEED, device=dev,
            resume_from=os.path.join(wd, 'epoch_1.pth'))
    last = hist[-1]
    if not all(np.isfinite(h['loss']) for h in hist + again):
        raise AssertionError(f'train_detector: {hist} {again}')
    gap = abs(again[-1]['loss'] - last['loss']) / abs(last['loss'])
    if ([h['epoch'] for h in again] != [DET_TRAIN_EPOCHS - 1]
            or opt2.count != opt.count or again[-1]['lr'] != last['lr']
            or gap > LOSS_RTOL):
        raise AssertionError(f'train_detector resume: {again} against '
                             f'{last}')
    steps = -(-N_DET_TRAIN_PAGES // bs)
    step_ms = (last['seconds'] - last['batch_seconds']) / steps * 1e3
    log(f'det-train train_detector DBNet-R18 ({DET_TRAIN_EPOCHS} epochs of '
        f'{N_DET_TRAIN_PAGES} 640x640 pages, B={bs}): epoch 2 '
        f'{last["seconds"]:.2f} s, {step_ms:.1f} ms a warm step, host '
        f'targets {last["batch_seconds"] / N_DET_TRAIN_PAGES * 1e3:.1f} ms '
        f'a page, {last["batch_seconds"] / last["seconds"]:.3f} of the epoch '
        f'making batches; losses {[round(h["loss"], 4) for h in hist]}; '
        f'the resume from epoch 1 ran epoch 2 again: {opt2.count} steps, lr '
        f'{again[-1]["lr"]:.6g}, loss {gap:.3g} apart (LOSS_RTOL '
        f'{LOSS_RTOL}) [{name}]')
    stats['train_detector'] = dict(
        epoch_s=last['seconds'], step_ms=step_ms,
        target_ms_page=last['batch_seconds'] / N_DET_TRAIN_PAGES * 1e3,
        batch_share=last['batch_seconds'] / last['seconds'],
        resume_gap=gap, losses=[h['loss'] for h in hist])
    log(f'det-train phase: {time.perf_counter() - t_phase:.1f} s; no '
        f'hand-written kernel launched; {json.dumps(stats)}')


def fce_like(g, hw, polys):
    """An FCENet output shaped like a trained one's, a (cls, reg) pair a
    level: ``FCENetTargets`` of ``polys``, the text and centre regions as
    +-4 logits plus N(0, 0.5) noise, the Fourier maps plus N(0, 0.05)."""
    import numpy as np
    from tps_pp_tpu_torch.models.textdet.targets import FCENetTargets
    levels = []
    for m in FCENetTargets().generate_level_targets(hw, polys, []):
        tr, tcl = 2 * m[..., 0] - 1, 2 * m[..., 1] - 1
        cls = np.stack([-tr, tr, -tcl, tcl], -1) * 4
        levels.append(((cls + g.normal(0, 0.5, cls.shape)).astype(np.float32),
                       (m[..., 3:] + g.normal(0, 0.05, m[..., 3:].shape)
                        ).astype(np.float32)))
    return levels


def textsnake_like(g, hw, polys):
    """A TextSnake output shaped like a trained one's: the
    ``TextSnakeTargets`` of ``polys``, the text and centre masks as +-4
    logits, the sin, cos and radius maps, plus noise."""
    import numpy as np
    from tps_pp_tpu_torch.models.textdet.targets import TextSnakeTargets
    t = TextSnakeTargets().generate(polys, [], *hw)
    x = np.stack([(2 * t['gt_text_mask'] - 1) * 4,
                  (2 * t['gt_center_region_mask'] - 1) * 4, t['gt_sin_map'],
                  t['gt_cos_map'], t['gt_radius_map']], -1)
    noise = g.normal(0, 1, x.shape) * [0.5, 0.5, 0.05, 0.05, 0.2]
    return (x + noise).astype(np.float32)


def drrg_like(g, hw, polys, seed=0):
    """A DRRG output shaped like a trained one's: the ``DRRGTargets``
    maps of ``polys`` (its generator seeded with ``seed``), the text and
    centre masks as +-8 logits, the sin, cos, top and bottom height maps,
    plus noise; (H, W, 6) float32."""
    import numpy as np
    from tps_pp_tpu_torch.models.textdet.targets import DRRGTargets
    t = DRRGTargets(seed=seed).generate(polys, [], *hw)
    x = np.stack([(2 * t['gt_text_mask'] - 1) * 8,
                  (2 * t['gt_center_region_mask'] - 1) * 8, t['gt_sin_map'],
                  t['gt_cos_map'], t['gt_top_height_map'],
                  t['gt_bot_height_map']], -1)
    noise = g.normal(0, 1, x.shape) * [0.5, 0.5, 0.05, 0.05, 0.2, 0.2]
    return (x + noise).astype(np.float32)


def fce_maps(g, n, hw=(640, 640), words=None):
    """``n`` ``fce_like`` outputs, each of a page's ``word_quads``
    (``words`` of them where given)."""
    out = []
    for _ in range(n):
        quads = word_quads(g, hw)
        if words is not None:
            quads = quads[:int(g.integers(*words, endpoint=True))]
        out.append(fce_like(g, hw, quads))
    return out


def textsnake_maps(g, n, hw=(640, 640)):
    """``n`` ``textsnake_like`` outputs of a page's ``word_quads``,
    stacked."""
    import numpy as np
    return np.stack([textsnake_like(g, hw, word_quads(g, hw))
                     for _ in range(n)])


def lower_first_decision(det, d, radius=0.0):
    """Lower by ``d`` (raise where negative) the logits of the first
    decision ``det``'s postprocessor takes: FCENet's text and centre class
    1, TextSnake's text and centre maps; raise TextSnake's radius map by
    ``radius``."""
    import torch
    fce = det.det_type == 'FCENet'
    conv = det.model.head.out_conv_cls if fce else det.model.head.out_conv
    with torch.no_grad():
        for i in ((1, 3) if fce else (0, 1)):
            conv.bias[i] -= d
        if not fce:
            conv.bias[4] += radius


def first_decisions(det, maps, d=0.0):
    """The pixels' first decisions of ``det``'s postprocessor on batched
    ``maps``, with the logits ``lower_first_decision`` moves lowered by
    ``d``: FCENet's score above score_thr, level after level, TextSnake's
    centre score above its threshold; flattened."""
    import torch
    pp = det.postprocessor
    if det.det_type == 'FCENet':
        out = []
        for c, _ in maps:
            c = c.float()
            tr = torch.softmax(torch.stack([c[..., 0], c[..., 1] - d], -1),
                               -1)[..., 1]
            tcl = torch.softmax(torch.stack([c[..., 2], c[..., 3] - d], -1),
                                -1)[..., 1]
            out.append((tr ** pp.alpha * tcl ** pp.beta
                        > pp.score_thr).flatten())
        return torch.cat(out)
    s = torch.sigmoid(maps[..., :2].float() - d)
    return (s[..., 1] * s[..., 0] > pp.min_center_region_confidence
            ).flatten()


def first_decision_margin(det, maps, at_most):
    """The least ``d`` in [-FCE_QUIET, FCE_QUIET] (bisection) at which at
    most ``at_most`` of the first decisions on ``maps`` pass."""
    lo, hi = -FCE_QUIET, FCE_QUIET
    for _ in range(40):
        mid = (lo + hi) / 2
        if int(first_decisions(det, maps, mid).sum()) <= at_most:
            hi = mid
        else:
            lo = mid
    return hi


def equal_first_decisions(det, maps, other, part):
    """``maps`` with ``other``'s first-decision logits where ``part`` (laid
    out as ``first_decisions``) says their decisions part: the two then
    decide alike and differ elsewhere as they did."""
    import torch
    if det.det_type != 'FCENet':
        sel = part.reshape(maps.shape[:-1])[..., None]
        return torch.cat([torch.where(sel, other[..., :2], maps[..., :2]),
                          maps[..., 2:]], -1)
    out, i0 = [], 0
    for (c, r), (oc, _) in zip(maps, other):
        k = c[..., 0].numel()
        sel = part[i0:i0 + k].reshape(c.shape[:-1])[..., None]
        out.append((torch.where(sel, oc, c), r))
        i0 += k
    return tuple(out)


def compare_postprocessed(det, a, b):
    """(compared, parted) between what ``det``'s postprocessor makes of
    the batched CPU maps ``a`` and ``b``: FCENet's polygons before NMS (one
    a pixel of each contour; no ``poly_nms`` time), vertices within 1 px
    (int32 truncations of the regression) and scores within 1e-4;
    TextSnake's boundaries, vertices equal and scores within 1e-4 (all the
    boundaries of an image whose counts differ part). Raises where FCENet's
    contours differ."""
    import numpy as np
    pp = det.postprocessor
    n = part = 0
    if det.det_type == 'FCENet':
        for i in range(len(a[0][0])):
            for (ac, ar), (bc, br), s in zip(a, b, pp.scales):
                pa = pp.candidates(ac[i].numpy(), ar[i].numpy(), s)
                pb = pp.candidates(bc[i].numpy(), br[i].numpy(), s)
                if [u.shape for u in pa] != [v.shape for v in pb]:
                    raise AssertionError(f'FCENet contours part: '
                                         f'{[u.shape for u in pa]} against '
                                         f'{[v.shape for v in pb]}')
                for u, v in zip(pa, pb):
                    n += len(u)
                    part += int(((np.abs(u[:, :-1] - v[:, :-1]).max(1) > 1)
                                 | (np.abs(u[:, -1] - v[:, -1]) > 1e-4)
                                 ).sum())
        return n, part
    scales = [(1.0, 1.0)] * len(a)
    for us, vs in zip(det.postprocess(a.numpy(), scales),
                      det.postprocess(b.numpy(), scales)):
        n += max(len(us), len(vs))
        if len(us) != len(vs):
            part += max(len(us), len(vs))
            continue
        part += sum(u.shape != v.shape or bool((u[:-1] != v[:-1]).any())
                    or bool(abs(u[-1] - v[-1]) > 1e-4)
                    for u, v in zip(us, vs))
    return n, part


def fce_ts_card_checks(det, cpu_det, xb, one):
    """The card's ``det`` against ``cpu_det`` (the same weights on the CPU)
    on the batch ``xb`` and the trained-like map ``one`` (batched, on the
    CPU); raises where a check fails, else returns the counts.

    * The outputs within ``FCE_TS_F32_RTOL`` of their largest magnitude,
      on the seed-0 weights and on a stressed map: the first decision's
      logits moved on both (by bisection on the CPU's maps) until
      ``FCE_TS_STRESS`` of the pixels pass it, the share reached within
      ``FCE_TS_STRESS_SHARES``; TextSnake's radii raised by
      ``TS_STRESS_RADIUS`` px (the random weights' are below the 1 px
      that a disk needs).
    * On the stressed map, the decisions that part counted; the CPU's map
      given the card's logits where they part, the postprocessed outputs
      (``compare_postprocessed``): for FCENet at least
      ``FCE_TS_MIN_COMPARED`` polygons and none parting; for TextSnake at
      least one boundary an image (the random weights' centre mask is a
      few large regions) and at most ``TS_STRESS_PART`` of them parting
      (``centralize`` truncates float64 walks of hundreds of steps to
      int32).
    * ``one`` moved by the stressed maps' difference, against ``one`` given
      the moved map's logits where the decisions part: at least
      ``FCE_TS_MIN_COMPARED`` compared and none parting."""
    def outputs(m):
        return [t for pair in m for t in pair] if isinstance(m, tuple) \
            else [m]

    def to_cpu(m):
        return tuple((c.cpu(), r.cpu()) for c, r in m) \
            if isinstance(m, tuple) else m.cpu()

    def err(got, want):
        e = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(outputs(got), outputs(want)))
        if not e <= FCE_TS_F32_RTOL:
            raise AssertionError(f'{det.det_type}: maps {e} apart over '
                                 f'their scale (bound {FCE_TS_F32_RTOL})')
        return e

    fce = det.det_type == 'FCENet'
    want = cpu_det.forward(xb.cpu())
    seed0 = first_decisions(det, want)
    checks = dict(err=err(to_cpu(det.forward(xb)), want),
                  passed_seed0=float(seed0.float().mean()))
    d = first_decision_margin(det, want, int(FCE_TS_STRESS * seed0.numel()))
    lower_first_decision(det, d, TS_STRESS_RADIUS)
    lower_first_decision(cpu_det, d, TS_STRESS_RADIUS)
    got, want = to_cpu(det.forward(xb)), cpu_det.forward(xb.cpu())
    lower_first_decision(det, -d, -TS_STRESS_RADIUS)
    checks['err_stressed'] = err(got, want)
    dc, dw = first_decisions(det, got), first_decisions(det, want)
    share = float(dw.float().mean())
    if not FCE_TS_STRESS_SHARES[0] <= share <= FCE_TS_STRESS_SHARES[1]:
        raise AssertionError(f'{det.det_type}: the stressed map passes '
                             f'{share} of its pixels')
    n, part = compare_postprocessed(
        det, got, equal_first_decisions(det, want, got, dc != dw))
    if (n < (FCE_TS_MIN_COMPARED if fce else len(xb))
            or part > (0 if fce else TS_STRESS_PART * n)):
        raise AssertionError(f'{det.det_type} stressed: {part} of {n} '
                             f'postprocessed outputs part')
    checks.update(shift=d, passed=share, flips=int((dc != dw).sum()),
                  compared=n, parted=part)
    if fce:
        moved = tuple((c + (gc - wc)[:1], r + (gr - wr)[:1])
                      for (c, r), (gc, gr), (wc, wr) in zip(one, got, want))
    else:
        moved = one + (got - want)[:1]
    du, dm = first_decisions(det, one), first_decisions(det, moved)
    n, part = compare_postprocessed(
        det, moved, equal_first_decisions(det, one, moved, du != dm))
    if n < FCE_TS_MIN_COMPARED or part:
        raise AssertionError(f'{det.det_type} trained-like: {part} of {n} '
                             f'postprocessed outputs part')
    checks.update(moved_flips=int((du != dm).sum()), moved_compared=n)
    return checks


def fce_textsnake_phase(dev, name):
    """FCENet and TextSnake on ``dev``, the card (see the module
    docstring); nothing here launches a hand-written kernel."""
    import tempfile

    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import MMOCR, TextDetector, init_detector
    from tps_pp_tpu_torch.apis.train_det import (DetBatches, _make_optimizer,
                                                 make_det_train_step,
                                                 train_detector)
    from tps_pp_tpu_torch.config import load_config
    from tps_pp_tpu_torch.models.textdet import postprocess
    from tps_pp_tpu_torch.registry import LOSSES

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    g = np.random.default_rng(SEED + 21)
    stats, sections, t_sec = {}, {}, [time.perf_counter()]

    def section(what):
        now = time.perf_counter()
        sections[what] = round(now - t_sec[0], 1)
        t_sec[0] = now

    def leaves(maps):
        return [t for pair in maps for t in pair] if isinstance(
            maps, tuple) else [maps]

    def few(det, x, k):
        """Lower FCENet's first decision by the least margin that leaves
        at most ``k`` pixels of the pages ``x`` above score_thr; returns
        their count."""
        lower_first_decision(det, first_decision_margin(det, det.forward(x),
                                                        k))
        return int(first_decisions(det, det.forward(x)).sum())

    def post(det, maps):
        t0 = time.perf_counter()
        out = det.postprocess(maps, [(1.0, 1.0)] * len(maps))
        return ((time.perf_counter() - t0) / len(maps) * 1e3,
                sum(len(b) for b in out) / len(maps), out)

    readers = {}
    for key, (path, n, scale) in FCE_TS_CONFIGS.items():
        det = init_detector(os.path.join(repo, path), device=dev, seed=SEED)
        if det.device.type != 'cuda' or det.model.training:
            raise AssertionError(f'{key}: built on {det.device}')
        fce = det.det_type == 'FCENet'
        imgs = [g.integers(0, 256, (640, 640, 3), np.uint8)
                for _ in range(n)]
        batch = np.stack([det.prep(i)[0] for i in imgs])
        x = torch.as_tensor(batch, device=dev)
        # ---- the card against the CPU at B_DET_F32: seed-0 and stressed
        # maps, and a trained-like map moved by the card's difference
        cpu_det = TextDetector(det.model_cfg, det.img_size, device='cpu')
        cpu_det.model.load_state_dict({k: v.cpu() for k, v in
                                       det.model.state_dict().items()})
        rng = np.random.default_rng(SEED + 2200)
        if fce:
            one = tuple((torch.from_numpy(c)[None], torch.from_numpy(r)[None])
                        for c, r in fce_maps(rng, 1)[0])
        else:
            one = torch.from_numpy(textsnake_maps(rng, 1))
        checks = fce_ts_card_checks(det, cpu_det, x[:B_DET_F32], one)
        what = 'polygons before NMS' if fce else 'boundaries'
        log(f'fce-ts {key} B={B_DET_F32} 640x640: the card against the CPU '
            f'(f32, TF32 off); seed-0 weights: outputs within '
            f'{checks["err"]:.3g} of their largest magnitude (bound '
            f'{FCE_TS_F32_RTOL}), {checks["passed_seed0"]:.4f} of the pixels '
            f'past the postprocessor\'s first threshold; stressed (its '
            f'logits lowered by {checks["shift"]:+.4f} on both): within '
            f'{checks["err_stressed"]:.3g}, {checks["passed"]:.4f} of the '
            f'pixels past it, {checks["flips"]} decisions part, '
            f'{checks["compared"]} {what} compared on equal decisions, '
            f'{checks["parted"]} part; a trained-like map moved by the '
            f'difference: {checks["moved_flips"]} decisions part, '
            f'{checks["moved_compared"]} {what} compared, none part')
        stats[f'{key} card-cpu'] = checks
        del cpu_det
        if fce:
            lower_first_decision(det, FCE_QUIET)
        # ---- serving: detect_batch by stage at B=n, 640 x 640
        zero_launches()
        det.forward(x)
        read_launches('fce-ts', f'{key} forward', {})
        det.detect_batch(imgs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = det.detect_batch(imgs)
        whole = (time.perf_counter() - t0) / n
        if len(out) != n:
            raise AssertionError(f'{key}: {len(out)} results for {n}')
        t0 = time.perf_counter()
        np.stack([det.prep(i)[0] for i in imgs])
        prep = (time.perf_counter() - t0) / n
        h2d = cuda_ms(lambda: torch.as_tensor(batch).to(dev), 3) / n
        fwd = cuda_ms(lambda: det.forward(x), 3) / n
        maps = det.forward(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = det.host_maps(maps)
        copy = (time.perf_counter() - t0) / n
        post_ms, per_img, _ = post(det, host)
        # ---- one image at the test pipeline's scale
        big = TextDetector(det.model_cfg, scale, device=dev)
        big.model.load_state_dict(det.model.state_dict())
        xs = torch.rand((1, *scale, 3), device=dev)
        big_ms = cuda_ms(lambda: big.forward(xs), 3)
        big_out = leaves(big.forward(xs))
        if not all(bool(torch.isfinite(t).all()) for t in big_out):
            raise AssertionError(f'{key}: {scale} output not finite')
        del big, big_out
        # ---- the postprocessor on trained-like maps
        if fce:
            tl = fce_maps(np.random.default_rng(SEED + 2100),
                          N_FCE_TRAINED_LIKE, words=FCE_WORDS)
        else:
            tl = textsnake_maps(np.random.default_rng(SEED + 2100),
                                N_TS_TRAINED_LIKE)
        calls = [0, 0.0]

        def counted(a, b, _iou=postprocess.poly_iou):
            t0 = time.perf_counter()
            out = _iou(a, b)
            calls[0] += 1
            calls[1] += time.perf_counter() - t0
            return out
        postprocess.poly_iou = counted
        try:
            post_t, per_img_t, _ = post(det, tl)
        finally:
            postprocess.poly_iou = counted.__defaults__[0]
        if per_img_t < 1:
            raise AssertionError(f'{key}: no boundary on trained-like maps')
        log(f'fce-ts {key} B={n} 640x640 (f32, TF32 off): detect_batch '
            f'{whole * 1e3:.2f} ms/image; host prep {prep * 1e3:.2f}, batch '
            f'copy to the card {h2d:.3f}, forward on the card\'s tensor '
            f'{fwd:.3f}, maps copy {copy * 1e3:.3f}, '
            f'{type(det.postprocessor).__name__} {post_ms:.2f} ms/image '
            f'({per_img:.1f} boundaries an image, seed-0 maps'
            f'{", text classes quieted" if fce else ""}); trained-like maps '
            f'{post_t:.1f} ms/image ({per_img_t:.1f} boundaries an image, '
            f'{len(tl)} maps{f" of {FCE_WORDS} words" if fce else ""}; '
            f'{calls[0]} polygon IoUs, {calls[1] * 1e3:.1f} ms in all); B=1 '
            f'at {scale[1]}x{scale[0]}: forward {big_ms:.2f} ms [{name}]')
        stats[f'{key} serving'] = dict(
            detect_batch=whole * 1e3, prep=prep * 1e3, h2d=h2d, forward=fwd,
            copy=copy * 1e3, post_seed0=post_ms, boxes_seed0=per_img,
            post_trained_like=post_t, boxes_trained_like=per_img_t,
            poly_iou_calls=calls[0], poly_iou_ms=calls[1] * 1e3,
            forward_test_scale=big_ms, test_scale=scale)
        section(key)
        del det, x, maps, host
        torch.cuda.empty_cache()

    # ---- one f32 step of each family, the card against the CPU ---------
    for key in ('fcenet_r50_ic15', 'textsnake_r50_ctw'):
        cfg = load_config(os.path.join(repo, FCE_TS_CONFIGS[key][0]))
        model_cfg = cfg['model']
        pages = DetPages(g, B_DET_F32)
        results = {}
        for where in ('card', 'cpu'):
            device = dev if where == 'card' else torch.device('cpu')
            det = TextDetector(model_cfg, device=device, seed=SEED)
            model = det.model.train()
            loss_fn = LOSSES.build(model_cfg['loss'])
            img, tgt = DetBatches(model_cfg, pages, loss_fn)(
                range(B_DET_F32))
            opt, _ = _make_optimizer(cfg, model.named_parameters())
            step = make_det_train_step(model, loss_fn, opt)
            img = torch.from_numpy(img).to(device)
            tgt = {k: torch.from_numpy(v).to(device) for k, v in tgt.items()}
            if where == 'card':
                zero_launches()
            m = step(img, tgt)
            results[where] = {k: float(v) for k, v in m.items()}
            if where == 'card':
                read_launches('fce-ts', f'{key} step', {})
                step_ms = cuda_ms(lambda: step(img, tgt), 3)
            del det, model
        a, b = results['card'], results['cpu']
        dl = abs(a['loss'] - b['loss']) / abs(b['loss'])
        dg = abs(a['grad_norm'] - b['grad_norm']) / abs(b['grad_norm'])
        if not (all(np.isfinite(list(a.values())))
                and dl <= DET_LOSS_RTOL and dg <= DET_GRAD_NORM_RTOL):
            raise AssertionError(f'{key} step: card {a} against the CPU '
                                 f'{b}')
        log(f'fce-ts {key} f32 step B={B_DET_F32} 640x640, train-mode '
            f'BatchNorm: loss {a["loss"]:.6f} (CPU {b["loss"]:.6f}, '
            f'{dl:.3g} apart, bound {DET_LOSS_RTOL}), grad norm '
            f'{a["grad_norm"]:.6f} ({dg:.3g} apart, bound '
            f'{DET_GRAD_NORM_RTOL}); {step_ms:.2f} ms a step on the card '
            f'[{name}]')
        stats[f'{key} step'] = dict(loss_rel=dl, grad_norm_rel=dg,
                                    step_ms=step_ms, **a)
        torch.cuda.empty_cache()
    section('steps')

    # ---- train_detector: FCENet-R50 at B=8, a resume ------------------
    cfg = load_config(os.path.join(repo, FCE_TS_CONFIGS['fcenet_r50_ic15'][0]))
    bs = int(cfg['data']['samples_per_gpu'])
    pages = DetPages(g, N_FCE_TRAIN_PAGES)
    with tempfile.TemporaryDirectory() as wd:
        zero_launches()
        _, opt, hist = train_detector(cfg, pages, work_dir=wd,
                                      total_epochs=FCE_TRAIN_EPOCHS,
                                      batch_size=bs, seed=SEED, device=dev)
        read_launches('fce-ts', 'train_detector', {})
        _, opt2, again = train_detector(
            cfg, pages, total_epochs=FCE_TRAIN_EPOCHS, batch_size=bs,
            seed=SEED, device=dev,
            resume_from=os.path.join(wd, 'epoch_1.pth'))
    last = hist[-1]
    if not all(np.isfinite(h['loss']) for h in hist + again):
        raise AssertionError(f'train_detector: {hist} {again}')
    gap = abs(again[-1]['loss'] - last['loss']) / abs(last['loss'])
    if ([h['epoch'] for h in again] != [FCE_TRAIN_EPOCHS - 1]
            or opt2.count != opt.count or again[-1]['lr'] != last['lr']
            or gap > LOSS_RTOL):
        raise AssertionError(f'train_detector resume: {again} against '
                             f'{last}')
    steps = -(-N_FCE_TRAIN_PAGES // bs)
    step_ms = (last['seconds'] - last['batch_seconds']) / steps * 1e3
    log(f'fce-ts train_detector FCENet-R50 ({FCE_TRAIN_EPOCHS} epochs of '
        f'{N_FCE_TRAIN_PAGES} 640x640 pages, B={bs}): epoch 2 '
        f'{last["seconds"]:.2f} s, {step_ms:.1f} ms a warm step, host '
        f'targets {last["batch_seconds"] / N_FCE_TRAIN_PAGES * 1e3:.1f} ms '
        f'a page, {last["batch_seconds"] / last["seconds"]:.3f} of the epoch '
        f'making batches; losses {[round(h["loss"], 4) for h in hist]}; the '
        f'resume from epoch 1 ran epoch 2 again: {opt2.count} steps, lr '
        f'{again[-1]["lr"]:.6g}, loss {gap:.3g} apart (LOSS_RTOL '
        f'{LOSS_RTOL}) [{name}]')
    stats['train_detector'] = dict(
        epoch_s=last['seconds'], step_ms=step_ms,
        target_ms_page=last['batch_seconds'] / N_FCE_TRAIN_PAGES * 1e3,
        batch_share=last['batch_seconds'] / last['seconds'],
        resume_gap=gap, losses=[h['loss'] for h in hist])
    section('train_detector')

    # ---- MMOCR.readtext: the FCENet-IC15 config path and the flagship ----
    reader = MMOCR(det=os.path.join(repo,
                                    FCE_TS_CONFIGS['fcenet_r50_ic15'][0]),
                   recog='NRTR_TPS', device=dev)
    pages = [g.integers(0, 256, (*PAGE_HW, 3), np.uint8)
             for _ in range(N_PAGES)]
    det = reader.detector
    kept = few(det, torch.as_tensor(np.stack([det.prep(p)[0] for p in pages]),
                                    device=dev), FCE_READ_PIXELS)
    reader.readtext(pages[:1])
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    res = reader.readtext(pages, merge=True)
    torch.cuda.synchronize()
    whole = (time.perf_counter() - t0) / N_PAGES
    n_boxes = sum(len(r['result']) for r in res)
    rec_launches = read_launches('fce-ts', 'readtext',
                                 {'tps_sampler': None} if n_boxes else {})
    if len(res) != N_PAGES or any(not isinstance(r['result'], list)
                                  for r in res) or not n_boxes:
        raise AssertionError(f'readtext: {res!r:.300}')
    log(f'fce-ts readtext {N_PAGES} pages {PAGE_HW[1]}x{PAGE_HW[0]} '
        f'(FCENet-R50 f32 at 640x640 from its config, its text classes '
        f'lowered until {kept} pixels of the pages pass score_thr; NRTR + '
        f'TPS++ from its config): {whole * 1e3:.1f} ms/page; '
        f'{n_boxes / N_PAGES:.1f} boxes a page; launches {rec_launches} '
        f'[{name}]')
    stats['readtext'] = dict(ms_page=whole * 1e3)
    section('readtext')
    log(f'fce-ts phase: {time.perf_counter() - t_phase:.1f} s (by section: '
        f'{sections}); no hand-written kernel launched; '
        f'{json.dumps(stats)}')


def drrg_maps(g, n, hw=(640, 640)):
    """``n`` ``drrg_like`` maps, each of ``DRRG_WORDS`` of a page's
    ``word_quads``, stacked (n, H, W, 6)."""
    import numpy as np
    out = []
    for i in range(n):
        quads = word_quads(g, hw)[:int(g.integers(*DRRG_WORDS,
                                                  endpoint=True))]
        out.append(drrg_like(g, hw, quads, seed=SEED + i))
    return np.stack(out)


def drrg_decisions(det, maps, d=0.0):
    """The centre-mask decisions of ``det``'s component proposal on
    batched maps (N, H, W, 6), the text and centre logits lowered by
    ``d``: the centre score (times the text score) and the text score
    both above their thresholds; flattened."""
    import torch
    gt = det.postprocessor.graph_test
    maps = torch.as_tensor(maps)
    text = torch.sigmoid(maps[..., 0].float() - d)
    center = torch.sigmoid(maps[..., 1].float() - d) * text
    return ((center > gt.center_region_thr)
            & (text > gt.text_region_thr)).flatten()


def drrg_margin(det, maps, at_most):
    """The least ``d`` in [-DRRG_QUIET, DRRG_QUIET] (bisection) at which at
    most ``at_most`` of ``drrg_decisions`` pass."""
    lo, hi = -DRRG_QUIET, DRRG_QUIET
    for _ in range(40):
        mid = (lo + hi) / 2
        if int(drrg_decisions(det, maps, mid).sum()) <= at_most:
            hi = mid
        else:
            lo = mid
    return hi


def drrg_shift(det, d=0.0, link=0.0):
    """Lower ``det``'s text and centre logits by ``d``; raise its GCN's
    class-1 bias by ``link``."""
    import torch
    with torch.no_grad():
        det.model.head.out_conv.bias[:2] -= d
        det.model.head.gcn.classifier[2].bias[1] += link


class DRRGStages:
    """Times each host and card stage of a ``DRRGDetector`` (wrapping its
    instance's methods): ``propose_comps`` (with ``poly_nms``'s polygon
    IoUs, counted and timed), the rest of ``build_test`` (the local graphs
    and the rotated RoI pooling), ``link_probs`` (the GCN on its device,
    synchronised) and the postprocessor; keeps each call's link
    probabilities."""

    def __init__(self, detector):
        from tps_pp_tpu_torch.models.textdet import postprocess
        self.ms = dict(propose=0.0, graphs=0.0, gcn=0.0, post=0.0,
                       iou=0.0)
        self.ious, self.probs, self.comps = 0, [], 0
        self.detector, self.postprocess = detector, postprocess
        gt = detector.graph_test
        self.saved = (gt.propose_comps, gt.build_test, detector.link_probs,
                      detector.postprocessor, postprocess.poly_iou)
        propose, build, links, post, iou = self.saved

        def timed(key, fn):
            def call(*a):
                t0 = time.perf_counter()
                out = fn(*a)
                self.ms[key] += (time.perf_counter() - t0) * 1e3
                return out
            return call

        def counted(a, b):
            self.ious += 1
            return iou(a, b)

        def proposed(maps):
            comps, geo = propose(maps)
            self.comps += 0 if comps is None else len(comps)
            return comps, geo

        def built(*a):
            before = self.ms['propose']
            t0 = time.perf_counter()
            out = build(*a)
            self.ms['graphs'] += ((time.perf_counter() - t0) * 1e3
                                  - (self.ms['propose'] - before))
            return out

        def probed(*a):
            p = links(*a)       # on the host: the GCN's device has synced
            self.probs.append(p)
            return p
        gt.propose_comps = timed('propose', proposed)
        gt.build_test = built
        detector.link_probs = timed('gcn', probed)
        detector.postprocessor = timed('post', post)
        postprocess.poly_iou = timed('iou', counted)

    def restore(self):
        gt = self.detector.graph_test
        (gt.propose_comps, gt.build_test, self.detector.link_probs,
         self.detector.postprocessor, self.postprocess.poly_iou) = self.saved

    def near_ties(self):
        """Link probabilities within ``DRRG_LINK_MARGIN`` of link_thr."""
        import numpy as np
        thr = self.detector.postprocessor.link_thr
        return sum(int((np.abs(p - thr) < DRRG_LINK_MARGIN).sum())
                   for p in self.probs)


def drrg_card_checks(det, cpu_det, xb, g):
    """The card's DRRG ``det`` against ``cpu_det`` (the same weights on the
    CPU) on the batch ``xb``; raises where a check fails, else returns the
    counts.

    * The features and maps within ``DRRG_F32_RTOL`` of their largest
      magnitude, on the seed-0 weights and on a stressed map: the text and
      centre logits moved on both (bisection on the CPU's maps) until
      half the pixels pass the centre-mask decision (the shares reached
      within ``FCE_TS_STRESS_SHARES``); the decisions that part counted.
    * The GCN's link logits on identical node features (the CPU's
      stressed features and trained-like maps, ``drrg_maps``, through the
      CPU's test graphs) within ``DRRG_F32_RTOL`` of their largest.
    * Boundaries on trained-like maps, the GCN's link bias raised by
      ``DRRG_LINK_BIAS`` on both: the card's detector on its stressed
      features and the trained-like maps moved by the stressed maps'
      difference, the CPU's on its own features and the unmoved maps
      given the moved maps' text and centre logits where their decisions
      part; a page with a link probability within ``DRRG_LINK_MARGIN`` of
      link_thr on either side is left out; at least ``DRRG_MIN_COMPARED``
      boundaries compared, all equal (vertices, scores within 1e-4)."""
    import numpy as np
    import torch

    def err(got, want):
        e = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, want))
        if not e <= DRRG_F32_RTOL:
            raise AssertionError(f'DRRG: outputs {e} apart over their '
                                 f'scale (bound {DRRG_F32_RTOL})')
        return e

    def cpu(out):
        return tuple(t.cpu() for t in out)

    want = cpu_det.forward(xb.cpu())
    seed0 = drrg_decisions(det, want[1])
    checks = dict(err=err(cpu(det.forward(xb)), want),
                  passed_seed0=float(seed0.float().mean()))
    d = drrg_margin(det, want[1], int(FCE_TS_STRESS * seed0.numel()))
    drrg_shift(det, d)
    drrg_shift(cpu_det, d)
    got, want = cpu(det.forward(xb)), cpu_det.forward(xb.cpu())
    drrg_shift(det, -d)
    drrg_shift(cpu_det, -d)
    checks['err_stressed'] = err(got, want)
    dc, dw = drrg_decisions(det, got[1]), drrg_decisions(det, want[1])
    share = float(dw.float().mean())
    if not FCE_TS_STRESS_SHARES[0] <= share <= FCE_TS_STRESS_SHARES[1]:
        raise AssertionError(f'DRRG: the stressed map passes {share} of '
                             f'its pixels')
    checks.update(shift=d, passed=share, flips=int((dc != dw).sum()))
    # ---- the GCN on identical node features
    one = drrg_maps(g, len(xb))
    feats = [np.concatenate([want[0][i].numpy(), one[i]], -1)
             for i in range(len(xb))]
    node, adj, knn = cpu_det.postprocessor.graph_test.build_test(
        one[0], feats[0])[:3]
    with torch.no_grad():
        a = det.model.head.gcn(*(torch.from_numpy(t).to(det.device)
                                 for t in (node, adj, knn))).cpu()
        b = cpu_det.model.head.gcn(*map(torch.from_numpy, (node, adj, knn)))
    checks['gcn_err'] = e = float((a - b).abs().max() / b.abs().max())
    if not e <= DRRG_F32_RTOL:
        raise AssertionError(f'DRRG: GCN logits {e} apart over their '
                             f'scale (bound {DRRG_F32_RTOL})')
    # ---- boundaries on moved trained-like maps, link bias raised
    moved = one + (got[1] - want[1]).numpy()
    part = (drrg_decisions(det, one) != drrg_decisions(det, moved)).reshape(
        one.shape[:-1])
    same = one.copy()
    same[..., :2] = np.where(part[..., None].numpy(), moved[..., :2],
                             one[..., :2])
    drrg_shift(det, link=DRRG_LINK_BIAS)
    drrg_shift(cpu_det, link=DRRG_LINK_BIAS)
    compared = skipped = 0
    try:
        for i in range(len(xb)):
            sa, sb = (DRRGStages(det.postprocessor),
                      DRRGStages(cpu_det.postprocessor))
            try:
                ba = det.postprocessor(np.concatenate(
                    [got[0][i].numpy(), moved[i]], -1))
                bb = cpu_det.postprocessor(np.concatenate(
                    [want[0][i].numpy(), same[i]], -1))
            finally:
                sa.restore()
                sb.restore()
            if sa.near_ties() or sb.near_ties():
                skipped += 1
                continue
            if len(ba) != len(bb) or any(
                    u.shape != v.shape or bool((u[:-1] != v[:-1]).any())
                    or abs(float(u[-1] - v[-1])) > 1e-4
                    for u, v in zip(ba, bb)):
                raise AssertionError(
                    f'DRRG page {i}: the card\'s {len(ba)} boundaries part '
                    f'from the CPU\'s {len(bb)}')
            compared += len(bb)
    finally:
        drrg_shift(det, link=-DRRG_LINK_BIAS)
        drrg_shift(cpu_det, link=-DRRG_LINK_BIAS)
    if compared < DRRG_MIN_COMPARED:
        raise AssertionError(f'DRRG: {compared} boundaries compared '
                             f'({skipped} pages with near-tie links)')
    checks.update(moved_flips=int(part.sum()), compared=compared,
                  skipped=skipped)
    return checks


def drrg_phase(dev, name):
    """DRRG on ``dev``, the card (see the module docstring); nothing here
    launches a hand-written kernel."""
    import tempfile

    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import MMOCR, TextDetector, init_detector
    from tps_pp_tpu_torch.apis.train_det import (DetBatches, _make_optimizer,
                                                 make_drrg_train_step,
                                                 train_detector)
    from tps_pp_tpu_torch.config import load_config
    from tps_pp_tpu_torch.datasets.pipelines import cv_ops
    from tps_pp_tpu_torch.models.textdet import postprocess
    from tps_pp_tpu_torch.registry import LOSSES

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(repo, DRRG_CONFIG)
    g = np.random.default_rng(SEED + 22)
    stats, sections, t_sec = {}, {}, [time.perf_counter()]

    def section(what):
        now = time.perf_counter()
        sections[what] = round(now - t_sec[0], 1)
        t_sec[0] = now

    det = init_detector(path, device=dev, seed=SEED)
    if det.device.type != torch.device(dev).type or det.model.training:
        raise AssertionError(f'DRRG: built on {det.device}')
    imgs = [g.integers(0, 256, (640, 640, 3), np.uint8)
            for _ in range(B_DRRG)]
    batch = np.stack([det.prep(i)[0] for i in imgs])
    x = torch.as_tensor(batch, device=dev)
    # ---- the card against the CPU at B_DET_F32
    cpu_det = TextDetector(det.model_cfg, det.img_size, device='cpu')
    cpu_det.model.load_state_dict({k: v.cpu() for k, v in
                                   det.model.state_dict().items()})
    checks = drrg_card_checks(det, cpu_det, x[:B_DET_F32],
                              np.random.default_rng(SEED + 2200))
    log(f'drrg B={B_DET_F32} 640x640: the card against the CPU (f32, TF32 '
        f'off); seed-0 weights: features and maps within '
        f'{checks["err"]:.3g} of their largest magnitude (bound '
        f'{DRRG_F32_RTOL}), {checks["passed_seed0"]:.4f} of the pixels past '
        f'the centre-mask decision; stressed (text and centre logits '
        f'lowered by {checks["shift"]:+.4f} on both): within '
        f'{checks["err_stressed"]:.3g}, {checks["passed"]:.4f} of the '
        f'pixels past it, {checks["flips"]} decisions part; the GCN on '
        f'identical node features: logits within {checks["gcn_err"]:.3g}; '
        f'trained-like maps moved by the difference ({checks["moved_flips"]} '
        f'decisions part), link bias +{DRRG_LINK_BIAS}: '
        f'{checks["compared"]} boundaries compared, none part, '
        f'{checks["skipped"]} pages left out for near-tie links')
    stats['card-cpu'] = checks
    del cpu_det
    section('card-cpu')

    # ---- serving: detect_batch by stage at B_DRRG, 640 x 640
    drrg_shift(det, DRRG_QUIET)
    zero_launches()
    det.forward(x)
    read_launches('drrg', 'forward', {})
    det.detect_batch(imgs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = det.detect_batch(imgs)
    whole = (time.perf_counter() - t0) / B_DRRG
    if len(out) != B_DRRG or any(out):
        raise AssertionError(f'DRRG quieted: {[len(b) for b in out]}')
    t0 = time.perf_counter()
    np.stack([det.prep(i)[0] for i in imgs])
    prep = (time.perf_counter() - t0) / B_DRRG
    h2d = cuda_ms(lambda: torch.as_tensor(batch).to(dev), 3) / B_DRRG
    fwd = cuda_ms(lambda: det.forward(x), 3) / B_DRRG
    m = det.model
    with torch.inference_mode():
        trunk = cuda_ms(lambda: m.backbone(x), 3) / B_DRRG
        c = m.backbone(x)
        neck = cuda_ms(lambda: m.neck(c), 3) / B_DRRG
        f = m.neck(c)
        head = cuda_ms(lambda: m.head(f), 3) / B_DRRG
        del c, f
    maps = det.forward(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = det.host_maps(maps)
    copy = (time.perf_counter() - t0) / B_DRRG
    mb = host.nbytes / B_DRRG / 1e6
    del maps
    scales = [(1.0, 1.0)] * B_DRRG
    t0 = time.perf_counter()
    det.postprocess(host, scales)
    post_quiet = (time.perf_counter() - t0) / B_DRRG * 1e3
    # trained-like maps beside the card's features, the link bias raised
    tl = drrg_maps(np.random.default_rng(SEED + 2100), N_DRRG_TRAINED_LIKE)
    cat = np.concatenate([host[:N_DRRG_TRAINED_LIKE, ..., :-6], tl], -1)
    drrg_shift(det, link=DRRG_LINK_BIAS)
    st = DRRGStages(det.postprocessor)
    try:
        t0 = time.perf_counter()
        bounds = det.postprocess(cat, scales[:N_DRRG_TRAINED_LIKE])
        post_tl = (time.perf_counter() - t0) / N_DRRG_TRAINED_LIKE * 1e3
    finally:
        st.restore()
        drrg_shift(det, link=-DRRG_LINK_BIAS)
    per_img = sum(len(b) for b in bounds) / N_DRRG_TRAINED_LIKE
    if per_img < 1:
        raise AssertionError('DRRG: no boundary on trained-like maps')
    stage = {k: v / N_DRRG_TRAINED_LIKE for k, v in st.ms.items()}
    del host, cat
    # ---- one image at the test pipeline's scale
    big = TextDetector(det.model_cfg, DRRG_TEST_SCALE, device=dev)
    big.model.load_state_dict(det.model.state_dict())
    xs = torch.rand((1, *DRRG_TEST_SCALE, 3), device=dev)
    big_ms = cuda_ms(lambda: big.forward(xs), 3)
    if not all(bool(torch.isfinite(t).all()) for t in big.forward(xs)):
        raise AssertionError(f'DRRG: {DRRG_TEST_SCALE} output not finite')
    del big
    log(f'drrg B={B_DRRG} 640x640 (DRRG-R50 f32, TF32 off): detect_batch '
        f'{whole * 1e3:.2f} ms/image on quieted seed-0 maps; host prep '
        f'{prep * 1e3:.2f}, batch copy to the card {h2d:.3f}, forward on '
        f'the card\'s tensor {fwd:.3f} (trunk {trunk:.3f}, neck {neck:.3f}, '
        f'head {head:.3f}), features and maps copy {copy * 1e3:.3f} ms '
        f'({mb:.1f} MB an image), the test graphs and postprocessor '
        f'{post_quiet:.2f} ms/image (no component); trained-like maps '
        f'({N_DRRG_TRAINED_LIKE} pages of {DRRG_WORDS} words, link bias '
        f'+{DRRG_LINK_BIAS}): {post_tl:.1f} ms/image, {per_img:.1f} '
        f'boundaries an image, {st.comps / N_DRRG_TRAINED_LIKE:.1f} '
        f'components; by stage a page: propose_comps '
        f'{stage["propose"]:.1f} ms ({st.ious / N_DRRG_TRAINED_LIKE:.0f} '
        f'polygon IoUs, {stage["iou"]:.1f} ms), graphs and RoI pooling '
        f'{stage["graphs"]:.1f}, GCN on the card {stage["gcn"]:.2f}, '
        f'postprocessor {stage["post"]:.1f}; B=1 at '
        f'{DRRG_TEST_SCALE[1]}x{DRRG_TEST_SCALE[0]}: forward {big_ms:.2f} '
        f'ms [{name}]')
    stats['serving'] = dict(
        detect_batch=whole * 1e3, prep=prep * 1e3, h2d=h2d, forward=fwd,
        trunk=trunk, neck=neck, head=head, copy=copy * 1e3, copy_mb=mb,
        post_quiet=post_quiet, post_trained_like=post_tl,
        boxes_trained_like=per_img,
        comps=st.comps / N_DRRG_TRAINED_LIKE,
        poly_iou_calls=st.ious / N_DRRG_TRAINED_LIKE,
        stages_ms=stage, forward_test_scale=big_ms)
    drrg_shift(det, -DRRG_QUIET)
    del det, x
    torch.cuda.empty_cache()
    section('serving')

    # ---- one f32 step on one page, the card against the CPU
    cfg = load_config(path)
    model_cfg = cfg['model']
    pages = DetPages(g, 1, words=DRRG_WORDS)
    results = {}
    for where in ('card', 'cpu'):
        device = dev if where == 'card' else torch.device('cpu')
        model = TextDetector(model_cfg, device=device, seed=SEED).model
        loss_fn = LOSSES.build(dict(type='DRRGLoss'))
        batches = DetBatches(model_cfg, pages, loss_fn)
        batches.targets.rng = np.random.RandomState(SEED)
        img, tgt = batches([0])
        opt, _ = _make_optimizer(cfg, model.named_parameters())
        step = make_drrg_train_step(model, loss_fn, opt)
        img = torch.from_numpy(img).to(device)
        tgt = {k: v if k == 'gt_comp_attribs' else
               torch.from_numpy(v).to(device) for k, v in tgt.items()}
        if where == 'card':
            zero_launches()
        results[where] = {k: float(v) for k, v in step(img, tgt).items()}
        if where == 'card':
            read_launches('drrg', 'step', {})
            step_ms = cuda_ms(lambda: step(img, tgt), 3)
        del model
    a, b = results['card'], results['cpu']
    dl = abs(a['loss'] - b['loss']) / abs(b['loss'])
    dg = abs(a['grad_norm'] - b['grad_norm']) / abs(b['grad_norm'])
    if not (all(np.isfinite(list(a.values())))
            and dl <= DET_LOSS_RTOL and dg <= DET_GRAD_NORM_RTOL):
        raise AssertionError(f'DRRG step: card {a} against the CPU {b}')
    log(f'drrg f32 step, one 640x640 page of {len(pages[0]["gt_polygons"])} '
        f'words ({len(tgt["gt_comp_attribs"][0])} components), '
        f'train-mode BatchNorm: loss {a["loss"]:.6f} (CPU '
        f'{b["loss"]:.6f}, {dl:.3g} apart, bound {DET_LOSS_RTOL}; '
        f'loss_gcn {a["loss_gcn"]:.6f}), grad norm {a["grad_norm"]:.6f} '
        f'({dg:.3g} apart, bound {DET_GRAD_NORM_RTOL}); {step_ms:.2f} ms '
        f'a step on the card, the eval forward and the host graphs '
        f'included [{name}]')
    stats['step'] = dict(loss_rel=dl, grad_norm_rel=dg, step_ms=step_ms,
                         **a)
    torch.cuda.empty_cache()
    section('step')

    # ---- train_detector: 2 epochs of one page a step, a resume
    pages = DetPages(g, N_DRRG_TRAIN_PAGES, words=DRRG_WORDS)
    calls = [0]

    def counted(p, q, _iou=postprocess.poly_iou):
        calls[0] += 1
        return _iou(p, q)
    postprocess.poly_iou = counted
    try:
        with tempfile.TemporaryDirectory() as wd:
            zero_launches()
            _, opt, hist = train_detector(
                cfg, pages, work_dir=wd, total_epochs=DRRG_TRAIN_EPOCHS,
                seed=SEED, device=dev)
            read_launches('drrg', 'train_detector', {})
            ious = calls[0]
            _, opt2, again = train_detector(
                cfg, pages, total_epochs=DRRG_TRAIN_EPOCHS, seed=SEED,
                device=dev, resume_from=os.path.join(wd, 'epoch_1.pth'))
    finally:
        postprocess.poly_iou = counted.__defaults__[0]
    last = hist[-1]
    if not all(np.isfinite(h['loss']) for h in hist + again):
        raise AssertionError(f'DRRG train_detector: {hist} {again}')
    gap = abs(again[-1]['loss'] - last['loss']) / abs(last['loss'])
    if ([h['epoch'] for h in again] != [DRRG_TRAIN_EPOCHS - 1]
            or opt2.count != opt.count or again[-1]['lr'] != last['lr']
            or gap > LOSS_RTOL):
        raise AssertionError(f'DRRG train_detector resume: {again} '
                             f'against {last}')
    step_ms = ((last['seconds'] - last['batch_seconds'])
               / N_DRRG_TRAIN_PAGES * 1e3)
    log(f'drrg train_detector DRRG-R50 ({DRRG_TRAIN_EPOCHS} epochs of '
        f'{N_DRRG_TRAIN_PAGES} 640x640 pages of {DRRG_WORDS} words, one a '
        f'step; its samples_per_gpu not read): epoch 2 '
        f'{last["seconds"]:.2f} s, {step_ms:.1f} ms a warm step (the eval '
        f'forward and the host graphs included), host targets '
        f'{last["batch_seconds"] / N_DRRG_TRAIN_PAGES * 1e3:.1f} ms a page '
        f'({ious / (DRRG_TRAIN_EPOCHS * N_DRRG_TRAIN_PAGES):.0f} polygon '
        f'IoUs a page), {last["batch_seconds"] / last["seconds"]:.3f} of '
        f'the epoch making batches; losses '
        f'{[round(h["loss"], 4) for h in hist]}; the resume from epoch 1 '
        f'ran epoch 2 again: {opt2.count} steps, lr {again[-1]["lr"]:.6g}, '
        f'loss {gap:.3g} apart (LOSS_RTOL {LOSS_RTOL}) [{name}]')
    stats['train_detector'] = dict(
        epoch_s=last['seconds'], step_ms=step_ms,
        target_ms_page=last['batch_seconds'] / N_DRRG_TRAIN_PAGES * 1e3,
        batch_share=last['batch_seconds'] / last['seconds'],
        ious_page=ious / (DRRG_TRAIN_EPOCHS * N_DRRG_TRAIN_PAGES),
        resume_gap=gap, losses=[h['loss'] for h in hist])
    section('train_detector')

    # ---- MMOCR.readtext: the DRRG config path and the flagship ----------
    reader = MMOCR(det=path, recog='NRTR_TPS', device=dev)
    pages = [g.integers(0, 256, (*PAGE_HW, 3), np.uint8) for _ in range(2)]
    det = reader.detector
    xr = torch.as_tensor(np.stack([det.prep(p)[0] for p in pages]),
                         device=dev)
    drrg_shift(det, drrg_margin(det, det.forward(xr)[1], DRRG_READ_PIXELS),
               DRRG_LINK_BIAS)
    passed = drrg_decisions(det, det.forward(xr)[1]).reshape(
        len(pages), *det.img_size).cpu().numpy()
    kept = int(passed.sum())
    # the passing pixels' 8-connected regions, and those large enough to
    # propose components (center_region_area_thr)
    regions = big_regions = 0
    for m in passed:
        n, lab = cv_ops.connected_components(m.astype(np.uint8), 8)
        regions += n - 1
        big_regions += int((np.bincount(lab.ravel())[1:] >= det.postprocessor
                            .graph_test.center_region_area_thr).sum())
    reader.readtext(pages[:1])
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    res = reader.readtext(pages, merge=True)
    torch.cuda.synchronize()
    whole = (time.perf_counter() - t0) / len(pages)
    n_boxes = sum(len(r['result']) for r in res)
    rec_launches = read_launches('drrg', 'readtext',
                                 {'tps_sampler': None} if n_boxes else {})
    if len(res) != len(pages) or any(not isinstance(r['result'], list)
                                     for r in res):
        raise AssertionError(f'DRRG readtext: {res!r:.300}')
    log(f'drrg readtext {len(pages)} pages {PAGE_HW[1]}x{PAGE_HW[0]} '
        f'(DRRG-R50 f32 at 640x640 from its config, its text and centre '
        f'logits lowered until {kept} pixels of the pages pass the '
        f'centre-mask decision, in {regions} regions, {big_regions} of them '
        f'large enough to propose components; link bias '
        f'+{DRRG_LINK_BIAS}; NRTR + TPS++ from its config): '
        f'{whole * 1e3:.1f} ms/page; '
        f'{n_boxes / len(pages):.1f} boxes a page; launches {rec_launches} '
        f'[{name}]')
    stats['readtext'] = dict(ms_page=whole * 1e3, boxes=n_boxes,
                             pixels=kept, regions=regions,
                             big_regions=big_regions)
    section('readtext')
    log(f'drrg phase: {time.perf_counter() - t_phase:.1f} s (by section: '
        f'{sections}); no hand-written kernel launched; '
        f'{json.dumps(stats)}')


def nms_margin(boxes, scores, thr, max_out):
    """``nms_xyxy(boxes, scores, thr, max_out)``'s keep list and the least
    distance of its decisions from their thresholds: each IoU it computes
    from ``thr``, each suppressed box's score from the keeper's, and, where
    it stops at ``max_out``, the last kept score from the next one's."""
    import numpy as np
    from tps_pp_tpu_torch.models.textdet.maskrcnn import bbox_iou_matrix
    order = scores.argsort()[::-1]
    keep, margin = [], np.inf
    while order.size > 0 and len(keep) < max_out:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        ious = bbox_iou_matrix(boxes[i:i + 1], boxes[rest])[0]
        margin = min(margin, float(np.abs(ious - thr).min()))
        gone = ious > thr
        if gone.any():
            margin = min(margin, float((scores[i] - scores[rest[gone]]).min()))
        order = rest[~gone]
    if order.size and len(keep) == max_out:
        margin = min(margin, float(scores[keep[-1]] - scores[order[0]]))
    return np.asarray(keep, np.int64), margin


def level_margin(boxes, n_levels):
    """The least distance of ``roi_levels``' log2 from an integer, over the
    boxes whose level is not clipped."""
    import numpy as np
    areas = np.prod(np.maximum(boxes[:, 2:] - boxes[:, :2], 1), -1)
    v = np.log2(np.sqrt(areas) / 56 + 1e-6) + 2
    inside = (v > 0) & (v < n_levels - 1)
    return float(np.abs(v - np.round(v))[inside].min()) if inside.any() \
        else np.inf


def maskrcnn_decisions(det, run):
    """``run()`` drives the port's serving (``det(levels, rpn_np, hw)`` or
    a ``TextDetector``'s ``detect_batch``, whose postprocessor is the
    ``MaskRCNNDetector`` ``det``) while hooks on ``det``'s stages and on
    ``maskrcnn.delta2bbox`` / ``nms_xyxy`` record what they take and give;
    from those intermediates, the distance of every decision from its
    threshold. Returns (``run()``'s result, per image a dict):
    ``boundaries`` (the paste of each final box alone: [] or its boundary;
    together they are the paste's output and as many as the result's),
    ``boxes``, ``scores``, ``box_margin`` (the least over the top-k cuts,
    ``wh > 2``, both NMSs, ``score_thr`` and the RoI levels),
    ``px_margins`` (each box's corners from the integers the paste
    truncates them to), ``mask_margins`` (each box's least distance of a
    resized mask probability from ``mask_thr``)."""
    import numpy as np
    from tps_pp_tpu_torch.models.textdet import maskrcnn
    saved = maskrcnn.delta2bbox, maskrcnn.nms_xyxy
    images, cur, at = [], [None], dict(det=0, paste=0)

    def delta2bbox(*a, **k):
        out = saved[0](*a, **k)
        if cur[0] is not None:
            cur[0]['decoded'].append(out)   # clipped in place after
        return out

    def nms_xyxy(boxes, scores, thr, max_out):
        keep = saved[1](boxes, scores, thr, max_out)
        if cur[0] is not None:
            cur[0]['nms'].append((boxes.copy(), scores.copy(), thr,
                                  max_out, keep))
        return keep

    def traced(fn, *a):
        """``fn(*a)`` and the least margin of the decodes and NMSs it
        ran."""
        cur[0] = dict(decoded=[], nms=[])
        try:
            out = fn(*a)
        finally:
            rec, cur[0] = cur[0], None
        margin = np.inf
        for boxes, scores, thr, max_out, keep in rec['nms']:
            again, m = nms_margin(boxes, scores, thr, max_out)
            if not np.array_equal(again, keep):
                raise AssertionError('nms_margin does not repeat nms_xyxy')
            margin = min(margin, m)
        return out, rec['decoded'], margin

    def proposals(rpn_np, img_hw):
        out, decoded, margin = traced(type(det).proposals, det, rpn_np,
                                      img_hw)
        for c, _ in rpn_np:
            sc = np.sort(1 / (1 + np.exp(-c.reshape(-1))))[::-1]
            k = min(det.pre_nms_top_n, len(sc))
            if k < len(sc):
                margin = min(margin, float(sc[k - 1] - sc[k]))
        wh = np.concatenate([b[:, 2:] - b[:, :2] for b in decoded])
        margin = min(margin, float(np.abs(wh - 2).min()),
                     level_margin(out[0], len(rpn_np)))
        images.append(dict(box_margin=margin, proposals=out[0],
                           n_levels=len(rpn_np),
                           boxes=np.zeros((0, 4), np.float32),
                           scores=np.zeros((0,), np.float32), boundaries=[],
                           px_margins=[], mask_margins=[]))
        return out

    def detections(props, probs, deltas, img_hw):
        o = images[at['det']]
        at['det'] += 1
        if props is not o['proposals']:
            raise AssertionError('detections of other proposals')
        out, _, margin = traced(type(det).detections, det, props, probs,
                                deltas, img_hw)
        if len(probs):
            margin = min(margin, float(np.abs(probs[:, 1]
                                              - det.score_thr).min()))
        o.update(boxes=out[0], scores=out[1], box_margin=min(
            o['box_margin'], margin, level_margin(out[0], o['n_levels'])),
            px_margins=[float(np.abs(bx - np.round(bx)).min())
                        for bx in out[0]])
        return out

    def paste(boxes, scores, mask_logits, img_hw):
        o = images[at['paste']]
        at['paste'] += 1
        out = type(det).paste(det, boxes, scores, mask_logits, img_hw)
        if not np.array_equal(boxes, o['boxes']):
            raise AssertionError('a paste of other boxes')
        alone = [type(det).paste(det, boxes[j:j + 1], scores[j:j + 1],
                                 mask_logits[j:j + 1], img_hw)
                 for j in range(len(boxes))]
        flat = sum(alone, [])
        if len(flat) != len(out) or not all(
                np.array_equal(u, v) for u, v in zip(flat, out)):
            raise AssertionError('the paste box by box is not the paste')
        o['boundaries'] = alone
        for box, m in zip(boxes, mask_logits):
            x0, y0, x1, y1 = box.astype(int)
            prob = maskrcnn.cv_ops.resize_f32(1 / (1 + np.exp(-m)),
                                              max(x1 - x0, 1),
                                              max(y1 - y0, 1))
            o['mask_margins'].append(float(np.abs(prob
                                                  - det.mask_thr).min()))
        return out

    maskrcnn.delta2bbox, maskrcnn.nms_xyxy = delta2bbox, nms_xyxy
    det.proposals, det.detections, det.paste = proposals, detections, paste
    try:
        result = run()
    finally:
        maskrcnn.delta2bbox, maskrcnn.nms_xyxy = saved
        del det.proposals, det.detections, det.paste
    if len(result) != len(images) or any(
            len(r) != len(sum(o['boundaries'], []))
            for r, o in zip(result, images)):
        raise AssertionError('Mask R-CNN: the traced boundaries are not '
                             'the result')
    for o in images:
        del o['proposals'], o['n_levels']
    return result, images


def compare_maskrcnn(got, want, atol=0.0):
    """Boundaries of two ``maskrcnn_decisions`` traces on the same pages, each
    final box's list against the other's, the points within ``atol`` px and
    the scores within 1e-4: they must agree wherever no decision lies near
    its threshold. An image whose final boxes part in number (or by more
    than 1e-2 px) must have a box decision within ``MASKRCNN_TIE`` of its
    threshold on one side, a box whose boundaries part a mask probability
    within ``MASKRCNN_TIE`` of ``mask_thr`` or a corner within
    ``MASKRCNN_TIE_PX`` of an integer; anything else raises. Returns
    (boundaries compared equal, images parting at a box tie, boxes parting
    at a mask or corner tie)."""
    import numpy as np

    def same(p, q):
        return len(p) == len(q) and all(
            u.shape == v.shape and bool(
                (np.abs(u[:-1] - v[:-1]) <= atol).all())
            and abs(float(u[-1] - v[-1])) <= 1e-4 for u, v in zip(p, q))
    compared = box_ties = mask_ties = 0
    for i, (a, b) in enumerate(zip(got, want)):
        tied = min(a['box_margin'], b['box_margin']) <= MASKRCNN_TIE
        if len(a['boxes']) != len(b['boxes']) or (
                len(a['boxes']) and
                float(np.abs(a['boxes'] - b['boxes']).max()) > 1e-2):
            if not tied:
                raise AssertionError(f'Mask R-CNN image {i}: the final '
                                     f'boxes part with no decision tie')
            box_ties += 1
            continue
        for j in range(len(b['boxes'])):
            p, q = a['boundaries'][j], b['boundaries'][j]
            if same(p, q):
                compared += len(q)
                continue
            if not (tied or min(a['mask_margins'][j], b['mask_margins'][j])
                    <= MASKRCNN_TIE or min(a['px_margins'][j],
                                           b['px_margins'][j])
                    <= MASKRCNN_TIE_PX):
                raise AssertionError(f'Mask R-CNN image {i} box {j}: the '
                                     f'boundaries part with no decision '
                                     f'tie: {p} {q}')
            mask_ties += 1
    return compared, box_ties, mask_ties


def maskrcnn_shift(det, cls_bias=0.0, mask_scale=1.0):
    """Raise ``det``'s box head's text logit by ``cls_bias``; scale its
    mask head's ``conv_logits`` by ``mask_scale`` (the trained-like
    setting of the boundary comparison)."""
    import torch
    heads = det.model.roi_head
    with torch.no_grad():
        heads.bbox_head.fc_cls.bias[1] += cls_bias
        heads.mask_head.conv_logits.weight.mul_(mask_scale)
        heads.mask_head.conv_logits.bias.mul_(mask_scale)


def maskrcnn_card_checks(det, cpu_det, imgs):
    """The card's Mask R-CNN ``det`` against ``cpu_det`` (the same weights
    on the CPU) on the pages ``imgs`` (uint8, at the input size); raises
    where a check fails, else returns the numbers.

    * The five levels and the RPN maps within ``MASKRCNN_F32_RTOL`` of
      their largest magnitude.
    * On identical host RoIs (the CPU's proposals), the card's pooling
      within ``MASKRCNN_F32_RTOL`` of ``roi_align_np`` on the card's
      levels copied to the host, and the box and mask heads' outputs on
      the same pooled RoIs within ``MASKRCNN_F32_RTOL``.
    * Boundaries in the trained-like setting (``maskrcnn_shift`` by
      ``MASKRCNN_CLS_BIAS`` and ``MASKRCNN_MASK_SCALE`` on both): each
      final box's boundary in ``detect_batch``'s result on either side
      equal unless a decision of that side's stages
      (``maskrcnn_decisions``) lies near its threshold
      (``compare_maskrcnn``), at least ``MASKRCNN_MIN_COMPARED``
      compared."""
    import numpy as np
    import torch
    from tps_pp_tpu_torch.models.textdet import maskrcnn

    def err(got, want):
        got, want = got.detach().cpu().float(), want.detach().cpu().float()
        e = float((got - want).abs().max() / want.abs().max())
        if not e <= MASKRCNN_F32_RTOL:
            raise AssertionError(f'Mask R-CNN: {e} apart over the scale '
                                 f'(bound {MASKRCNN_F32_RTOL})')
        return e

    p, q = det.postprocessor, cpu_det.postprocessor
    xb = np.stack([det.prep(i)[0] for i in imgs])
    (gl, gr), (wl, wr) = det.forward(xb), cpu_det.forward(xb)
    checks = dict(levels=max(err(a, b) for a, b in zip(gl, wl)),
                  rpn=max(max(err(a, c), err(b, d))
                          for (a, b), (c, d) in zip(gr, wr)))
    hw = det.img_size
    props = [q.proposals(r, hw)[0] for r in q.host_rpn(wr)]
    with torch.inference_mode():
        for size, key in (((7, 7), 'pool7'), ((14, 14), 'pool14')):
            pooled = p.pool(gl, props, size).cpu()
            host = []
            for i, b in enumerate(props):
                lvl = maskrcnn.roi_levels(b, len(gl))
                out = np.zeros((len(b), size[1], size[0], gl[0].shape[1]),
                               np.float32)
                for li in np.unique(lvl):
                    out[lvl == li] = maskrcnn.roi_align_np(
                        gl[li][i].permute(1, 2, 0).cpu().numpy(),
                        b[lvl == li] / p.strides[li], size)
                host.append(out)
            checks[key] = err(pooled, torch.from_numpy(
                np.concatenate(host)).permute(0, 3, 1, 2))
            head = 'bbox_head' if key == 'pool7' else 'mask_head'
            a = getattr(det.model.roi_head, head)(pooled.to(det.device))
            b = getattr(cpu_det.model.roi_head, head)(pooled)
            a, b = (a, b) if key == 'pool14' else (torch.cat(a, -1),
                                                   torch.cat(b, -1))
            checks[head] = err(a, b)
    checks['rois'] = sum(len(b) for b in props)
    maskrcnn_shift(det, MASKRCNN_CLS_BIAS, MASKRCNN_MASK_SCALE)
    maskrcnn_shift(cpu_det, MASKRCNN_CLS_BIAS, MASKRCNN_MASK_SCALE)
    try:
        _, got = maskrcnn_decisions(p, lambda: det.detect_batch(imgs))
        _, want = maskrcnn_decisions(q, lambda: cpu_det.detect_batch(imgs))
    finally:
        maskrcnn_shift(det, -MASKRCNN_CLS_BIAS, 1 / MASKRCNN_MASK_SCALE)
        maskrcnn_shift(cpu_det, -MASKRCNN_CLS_BIAS, 1 / MASKRCNN_MASK_SCALE)
    compared, box_ties, mask_ties = compare_maskrcnn(got, want)
    if compared < MASKRCNN_MIN_COMPARED:
        raise AssertionError(f'Mask R-CNN: {compared} boundaries compared '
                             f'({box_ties} images, {mask_ties} boxes at a '
                             f'tie)')
    checks.update(compared=compared, box_ties=box_ties, mask_ties=mask_ties,
                  boxes=sum(len(o['boxes']) for o in want))
    return checks


def maskrcnn_phase(dev, name):
    """OCRMaskRCNN on ``dev``, the card (see the module docstring); nothing
    of its path launches a hand-written kernel."""
    import tempfile

    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import MMOCR, TextDetector, init_detector
    from tps_pp_tpu_torch.apis.train_det import (_deterministic_cudnn,
                                                 _make_optimizer,
                                                 make_maskrcnn_train_step,
                                                 train_detector)
    from tps_pp_tpu_torch.config import load_config
    from tps_pp_tpu_torch.models.textdet import maskrcnn

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(repo, MASKRCNN_CONFIG)
    g = np.random.default_rng(SEED + 23)
    hw = f'{MASKRCNN_HW[1]}x{MASKRCNN_HW[0]}'
    stats, sections, t_sec = {}, {}, [time.perf_counter()]

    def section(what):
        now = time.perf_counter()
        sections[what] = round(now - t_sec[0], 1)
        t_sec[0] = now

    det = init_detector(path, img_size=MASKRCNN_HW, device=dev, seed=SEED)
    if det.device.type != torch.device(dev).type or det.model.training:
        raise AssertionError(f'Mask R-CNN: built on {det.device}')
    p = det.postprocessor
    imgs = [g.integers(0, 256, (*MASKRCNN_HW, 3), np.uint8)
            for _ in range(B_MASKRCNN)]
    batch = np.stack([det.prep(i)[0] for i in imgs])
    x = torch.as_tensor(batch, device=dev)
    # ---- the card against the CPU at B_DET_F32
    cpu_det = TextDetector(det.model_cfg, det.img_size, device='cpu')
    cpu_det.model.load_state_dict({k: v.cpu() for k, v in
                                   det.model.state_dict().items()})
    checks = maskrcnn_card_checks(det, cpu_det, imgs[:B_DET_F32])
    log(f'maskrcnn B={B_DET_F32} {hw}: the card against the CPU (f32, '
        f'TF32 off), seed-0 weights, each of their largest magnitude '
        f'(bound {MASKRCNN_F32_RTOL}): levels within {checks["levels"]:.3g}, '
        f'RPN maps {checks["rpn"]:.3g}; on the CPU\'s {checks["rois"]} '
        f'proposals, the card\'s pooling against roi_align_np of its '
        f'levels: 7x7 {checks["pool7"]:.3g}, 14x14 {checks["pool14"]:.3g}; '
        f'box head {checks["bbox_head"]:.3g}, mask head '
        f'{checks["mask_head"]:.3g}; boundaries (fc_cls text bias '
        f'+{MASKRCNN_CLS_BIAS}, conv_logits x{MASKRCNN_MASK_SCALE}): '
        f'{checks["boxes"]} final boxes on the CPU, {checks["compared"]} '
        f'boundaries equal, {checks["box_ties"]} images and '
        f'{checks["mask_ties"]} boxes parting at a decision within '
        f'{MASKRCNN_TIE} ({MASKRCNN_TIE_PX} px) [{name}]')
    stats['card-cpu'] = checks
    del cpu_det
    section('card-cpu')

    # ---- serving: detect_batch by stage at B_MASKRCNN, on the seed-0
    # weights (few RoIs pass score_thr) and in the trained-like setting
    zero_launches()
    det.detect_batch(imgs)
    read_launches('maskrcnn', 'detect_batch', {})
    t0 = time.perf_counter()
    np.stack([det.prep(i)[0] for i in imgs])
    prep = (time.perf_counter() - t0) / B_MASKRCNN
    h2d = cuda_ms(lambda: torch.as_tensor(batch).to(dev), 3) / B_MASKRCNN
    fwd = cuda_ms(lambda: det.forward(x), 3) / B_MASKRCNN
    m = det.model
    with torch.inference_mode():
        trunk = cuda_ms(lambda: m.backbone(x), 3) / B_MASKRCNN
        c = m.backbone(x)
        fpn = cuda_ms(lambda: m.neck(c), 3) / B_MASKRCNN
        levels = m.features(x)
        rpn_ms = cuda_ms(lambda: m.rpn_head(levels), 3) / B_MASKRCNN
        del c, levels
    saved_nms = maskrcnn.nms_xyxy

    def stages():
        """detect_batch's ms an image whole, then by stage (host clock,
        CUDA events for the pooling and heads), and its counts a page."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = det.detect_batch(imgs)
        st = dict(detect_batch=(time.perf_counter() - t0) * 1e3
                  / B_MASKRCNN)
        if len(out) != B_MASKRCNN:
            raise AssertionError(f'Mask R-CNN: {len(out)} pages')
        levels, rpn = det.forward(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rpn_np = p.host_rpn(rpn)
        st['copy'] = (time.perf_counter() - t0) * 1e3 / B_MASKRCNN
        st['copy_mb'] = sum(c_.nbytes + r.nbytes
                            for c_, r in rpn_np[0]) / 1e6
        nms = [0.0]

        def timed_nms(*a):
            t = time.perf_counter()
            kept = saved_nms(*a)
            nms[0] += (time.perf_counter() - t) * 1e3
            return kept
        maskrcnn.nms_xyxy = timed_nms
        try:
            t0 = time.perf_counter()
            props = [p.proposals(r, det.img_size)[0] for r in rpn_np]
            st['proposals'] = (time.perf_counter() - t0) * 1e3 / B_MASKRCNN
            st['rpn_nms'], nms[0] = nms[0] / B_MASKRCNN, 0.0
            probs, deltas = p.box_outputs(levels, props)
            t0 = time.perf_counter()
            dets = [p.detections(a, b, c_, det.img_size)
                    for a, b, c_ in zip(props, probs, deltas)]
            st['detections'] = (time.perf_counter() - t0) * 1e3 / B_MASKRCNN
            st['det_nms'] = nms[0] / B_MASKRCNN
        finally:
            maskrcnn.nms_xyxy = saved_nms
        boxes = [b for b, _ in dets]
        heads = p.model.roi_head
        with torch.inference_mode():
            st['box'] = cuda_ms(lambda: heads.bbox_head(
                p.pool(levels, props, (7, 7))), 3) / B_MASKRCNN
            if any(len(b) for b in boxes):
                st['mask'] = cuda_ms(lambda: heads.mask_head(
                    p.pool(levels, boxes, (14, 14))), 3) / B_MASKRCNN
                masks = p.mask_outputs(levels, boxes)
            else:
                st['mask'], masks = 0.0, [None] * len(boxes)
        t0 = time.perf_counter()
        bounds = [p.paste(b, s_, m_, det.img_size) if len(b) else []
                  for (b, s_), m_ in zip(dets, masks)]
        st['paste'] = (time.perf_counter() - t0) * 1e3 / B_MASKRCNN
        st.update(proposals_page=sum(map(len, props)) / B_MASKRCNN,
                  boxes_page=sum(map(len, boxes)) / B_MASKRCNN,
                  boundaries_page=sum(map(len, bounds)) / B_MASKRCNN)
        return st

    def fmt(st):
        return (f'detect_batch {st["detect_batch"]:.2f} ms/image: RPN '
                f'maps\' copy out {st["copy"]:.3f} ms ({st["copy_mb"]:.2f} '
                f'MB an image), proposals {st["proposals"]:.2f} (their NMS '
                f'{st["rpn_nms"]:.2f}), pooling + box head {st["box"]:.3f}, '
                f'detections {st["detections"]:.2f} (NMS '
                f'{st["det_nms"]:.2f}), mask pooling + mask head '
                f'{st["mask"]:.3f}, paste with points2boundary '
                f'{st["paste"]:.2f}; a page {st["proposals_page"]:.1f} '
                f'proposals, {st["boxes_page"]:.1f} boxes, '
                f'{st["boundaries_page"]:.1f} boundaries')
    seed0 = stages()
    maskrcnn_shift(det, MASKRCNN_CLS_BIAS, MASKRCNN_MASK_SCALE)
    try:
        shifted = stages()
    finally:
        maskrcnn_shift(det, -MASKRCNN_CLS_BIAS, 1 / MASKRCNN_MASK_SCALE)
    if shifted['boxes_page'] < 1 or shifted['boundaries_page'] < 1:
        raise AssertionError(f'Mask R-CNN trained-like: {shifted}')
    # ---- one page at the CTW1500 config's test scale
    big = TextDetector(det.model_cfg, MASKRCNN_TEST_SCALE, device=dev)
    big.model.load_state_dict(det.model.state_dict())
    page = g.integers(0, 256, (*MASKRCNN_TEST_SCALE, 3), np.uint8)
    xs = torch.as_tensor(big.prep(page)[0][None], device=dev)
    big_fwd = cuda_ms(lambda: big.forward(xs), 3)
    big.detect(page)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    found = big.detect(page)
    big_ms = (time.perf_counter() - t0) * 1e3
    if not all(np.isfinite(b).all() for b in found):
        raise AssertionError('Mask R-CNN: test-scale boundaries not finite')
    del big, xs
    log(f'maskrcnn B={B_MASKRCNN} {hw} (Mask R-CNN R50-FPN f32, TF32 '
        f'off): host prep {prep * 1e3:.2f} ms/image, batch copy to the '
        f'card {h2d:.3f}, forward on the card\'s tensor {fwd:.3f} (trunk '
        f'{trunk:.3f}, FPN {fpn:.3f}, RPN {rpn_ms:.3f}); seed-0 weights: '
        f'{fmt(seed0)}; trained-like (fc_cls text bias '
        f'+{MASKRCNN_CLS_BIAS}, conv_logits x{MASKRCNN_MASK_SCALE}): '
        f'{fmt(shifted)}; B=1 at '
        f'{MASKRCNN_TEST_SCALE[1]}x{MASKRCNN_TEST_SCALE[0]}, seed-0: '
        f'forward {big_fwd:.2f} ms, detect {big_ms:.1f} ms, {len(found)} '
        f'boundaries [{name}]')
    stats['serving'] = dict(
        prep=prep * 1e3, h2d=h2d, forward=fwd, trunk=trunk, fpn=fpn,
        rpn=rpn_ms, seed0=seed0, trained_like=shifted,
        forward_test_scale=big_fwd, detect_test_scale=big_ms,
        boundaries_test_scale=len(found))
    del det, x
    torch.cuda.empty_cache()
    section('serving')

    # ---- one f32 step on one page, the card against the CPU
    cfg = load_config(path)
    model_cfg = cfg['model']
    pages = DetPages(g, 1, hw=MASKRCNN_HW)
    item = pages[0]
    img_np = item['img'][None]
    gt_boxes, gt_masks = maskrcnn.poly_boxes_masks(item['gt_polygons'],
                                                   *MASKRCNN_HW)
    results, batch = {}, None
    for where in ('cpu', 'card'):
        device = dev if where == 'card' else torch.device('cpu')
        model = TextDetector(model_cfg, MASKRCNN_HW, device=device,
                             seed=SEED).model
        d = maskrcnn.MaskRCNNDetector(model)
        img = torch.from_numpy(img_np).to(device)
        if batch is None:       # the CPU's sample, on both sides
            batch = d.sample_train_batch(img, gt_boxes, gt_masks,
                                         np.random.default_rng(SEED))
        opt, _ = _make_optimizer(cfg, model.named_parameters())
        step = make_maskrcnn_train_step(d, opt)
        model.train()
        if where == 'card':
            zero_launches()
        results[where] = {k: float(v) for k, v in step(img, batch).items()}
        if where == 'card':
            read_launches('maskrcnn', 'step', {})
            # cuDNN's default algorithms, then the deterministic ones that
            # train_detector runs Mask R-CNN with
            step_ms = cuda_ms(lambda: step(img, batch), 3)
            with _deterministic_cudnn(True):
                det_step_ms = cuda_ms(lambda: step(img, batch), 3)
        del model
    a, b = results['card'], results['cpu']
    dl = abs(a['loss'] - b['loss']) / abs(b['loss'])
    dg = abs(a['grad_norm'] - b['grad_norm']) / abs(b['grad_norm'])
    if not (all(np.isfinite(list(a.values())))
            and dl <= DET_LOSS_RTOL and dg <= DET_GRAD_NORM_RTOL):
        raise AssertionError(f'Mask R-CNN step: card {a} against the CPU '
                             f'{b}')
    log(f'maskrcnn f32 step, one {hw} page of '
        f'{len(item["gt_polygons"])} words ({int(batch["labels"].sum())} '
        f'positive RoIs of {len(batch["labels"])}), train-mode BatchNorm, '
        f'the CPU\'s RoI sample on both: loss {a["loss"]:.6f} (CPU '
        f'{b["loss"]:.6f}, {dl:.3g} apart, bound {DET_LOSS_RTOL}; '
        f'loss_mask {a["loss_mask"]:.6f}), grad norm {a["grad_norm"]:.6f} '
        f'({dg:.3g} apart, bound {DET_GRAD_NORM_RTOL}); a step on the '
        f'card {step_ms:.2f} ms with cuDNN\'s default algorithms, '
        f'{det_step_ms:.2f} ms with its deterministic ones [{name}]')
    stats['step'] = dict(loss_rel=dl, grad_norm_rel=dg, step_ms=step_ms,
                         deterministic_step_ms=det_step_ms, **a)
    torch.cuda.empty_cache()
    section('step')

    # ---- train_detector: 2 epochs of one page a step, a resume (as a
    # user calls it: train_detector itself runs Mask R-CNN's epochs with
    # cuDNN's deterministic algorithms)
    pages = DetPages(g, N_MASKRCNN_TRAIN_PAGES, hw=MASKRCNN_HW)
    if torch.backends.cudnn.deterministic:
        raise AssertionError('cuDNN deterministic before train_detector')
    with tempfile.TemporaryDirectory() as wd:
        zero_launches()
        _, opt, hist = train_detector(
            cfg, pages, work_dir=wd, total_epochs=MASKRCNN_TRAIN_EPOCHS,
            seed=SEED, device=dev)
        read_launches('maskrcnn', 'train_detector', {})
        _, opt2, again = train_detector(
            cfg, pages, total_epochs=MASKRCNN_TRAIN_EPOCHS, seed=SEED,
            device=dev, resume_from=os.path.join(wd, 'epoch_1.pth'))
    if torch.backends.cudnn.deterministic:
        raise AssertionError('train_detector left cuDNN deterministic')
    last = hist[-1]
    if not all(np.isfinite(h['loss']) for h in hist + again):
        raise AssertionError(f'Mask R-CNN train_detector: {hist} {again}')
    gap = abs(again[-1]['loss'] - last['loss']) / abs(last['loss'])
    if ([h['epoch'] for h in again] != [MASKRCNN_TRAIN_EPOCHS - 1]
            or opt2.count != opt.count or again[-1]['lr'] != last['lr']
            or gap > LOSS_RTOL):
        raise AssertionError(f'Mask R-CNN train_detector resume: {again} '
                             f'against {last}')
    step_ms = ((last['seconds'] - last['batch_seconds'])
               / N_MASKRCNN_TRAIN_PAGES * 1e3)
    log(f'maskrcnn train_detector Mask R-CNN R50-FPN '
        f'({MASKRCNN_TRAIN_EPOCHS} epochs of {N_MASKRCNN_TRAIN_PAGES} '
        f'{hw} pages, one a step; schedule_sgd_160e; cuDNN '
        f'deterministic, as train_detector runs it): epoch 2 '
        f'{last["seconds"]:.2f} s, {step_ms:.1f} ms a warm step (the eval '
        f'forward and the RPN maps\' copy included), host targets '
        f'{last["batch_seconds"] / N_MASKRCNN_TRAIN_PAGES * 1e3:.1f} ms a '
        f'page, {last["batch_seconds"] / last["seconds"]:.3f} of the epoch; '
        f'losses {[round(h["loss"], 4) for h in hist]}; the resume from '
        f'epoch 1 ran epoch 2 again: {opt2.count} steps, lr '
        f'{again[-1]["lr"]:.6g}, loss {gap:.3g} apart (LOSS_RTOL '
        f'{LOSS_RTOL}) [{name}]')
    stats['train_detector'] = dict(
        epoch_s=last['seconds'], step_ms=step_ms,
        target_ms_page=last['batch_seconds'] / N_MASKRCNN_TRAIN_PAGES * 1e3,
        batch_share=last['batch_seconds'] / last['seconds'],
        resume_gap=gap, losses=[h['loss'] for h in hist])
    section('train_detector')

    # ---- MMOCR.readtext: the Mask R-CNN config path and the flagship ----
    reader = MMOCR(det=path, recog='NRTR_TPS', det_img_size=MASKRCNN_HW,
                   device=dev)
    pages = [g.integers(0, 256, (*PAGE_HW, 3), np.uint8) for _ in range(2)]
    # the trained-like setting: the seed-0 weights pass few RoIs
    maskrcnn_shift(reader.detector, MASKRCNN_CLS_BIAS, MASKRCNN_MASK_SCALE)
    reader.readtext(pages[:1])
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    res = reader.readtext(pages, merge=True)
    torch.cuda.synchronize()
    whole = (time.perf_counter() - t0) / len(pages)
    n_boxes = sum(len(r['result']) for r in res)
    rec_launches = read_launches('maskrcnn', 'readtext',
                                 {'tps_sampler': None} if n_boxes else {})
    if len(res) != len(pages) or any(not isinstance(r['result'], list)
                                     for r in res):
        raise AssertionError(f'Mask R-CNN readtext: {res!r:.300}')
    log(f'maskrcnn readtext {len(pages)} pages {PAGE_HW[1]}x{PAGE_HW[0]} '
        f'(Mask R-CNN R50-FPN f32 at {hw} from its config, seed-0 '
        f'weights, fc_cls text bias +{MASKRCNN_CLS_BIAS}, conv_logits '
        f'x{MASKRCNN_MASK_SCALE}; NRTR + TPS++ from its config): '
        f'{whole * 1e3:.1f} '
        f'ms/page; {n_boxes / len(pages):.1f} boxes a page; launches '
        f'{rec_launches} (the recognizer\'s) [{name}]')
    stats['readtext'] = dict(ms_page=whole * 1e3, boxes=n_boxes)
    section('readtext')
    log(f'maskrcnn phase: {time.perf_counter() - t_phase:.1f} s (by '
        f'section: {sections}); no hand-written kernel launched by the '
        f'detector; {json.dumps(stats)}')


def kie_ner_data(d, g):
    """Receipts and sentences in the directory ``d`` from the generator
    ``g``: a 90-character ``dict.txt``; ``closed.jsonl`` and
    ``openset.jsonl``, ``N_RECEIPTS`` receipts of ``KIE_NODES`` boxes
    (texts of 1 to ``KIE_CHARS`` characters, a few outside the
    dictionary; 26 classes, or the openset's 4 with edge ids) on pages of
    400-1000 px; a 21,128-token ``vocab.txt``; ``ner_train.jsonl`` and
    ``ner_test.jsonl``, sentences of ``NER_LEN`` characters with entities.
    Returns {name: path} and the receipts' uint8 BGR pages by file name."""
    import string

    import numpy as np
    chars = (string.digits + string.ascii_letters + string.punctuation)[:90]
    files = {k: os.path.join(d, f) for k, f in (
        ('dict', 'dict.txt'), ('closed', 'closed.jsonl'),
        ('openset', 'openset.jsonl'), ('vocab', 'vocab.txt'),
        ('ner_train', 'ner_train.jsonl'), ('ner_test', 'ner_test.jsonl'))}
    with open(files['dict'], 'w') as f:
        f.write('\n'.join(chars) + '\n')
    pool = list(chars) + ['é', '€']          # two unknown ones
    images, closed, openset = {}, [], []
    for i in range(N_RECEIPTS):
        h, w = (int(v) for v in g.integers(400, 1000, 2))
        name = f'receipt_{i}.png'
        images[name] = g.integers(0, 256, (h, w, 3), np.uint8)
        anns = []
        for _ in range(KIE_NODES):
            x, y = g.uniform(0, w - 60), g.uniform(0, h - 20)
            bw, bh = g.uniform(10, min(200, w - x)), g.uniform(8, 20)
            text = ''.join(g.choice(pool, int(g.integers(1, KIE_CHARS + 1))))
            anns.append({'box': [x, y, x + bw, y, x + bw, y + bh, x, y + bh],
                         'text': text})
        closed.append({'file_name': name, 'height': h, 'width': w,
                       'annotations': [dict(a, label=int(g.integers(0, 26)))
                                       for a in anns]})
        openset.append({'file_name': name, 'height': h, 'width': w,
                        'annotations': [
                            dict(a, label=int(g.integers(0, 4)),
                                 edge=int(g.integers(-1, 12)))
                            for a in anns]})
    for key, lines in (('closed', closed), ('openset', openset)):
        with open(files[key], 'w') as f:
            f.write('\n'.join(json.dumps(ln) for ln in lines) + '\n')
    vocab = ['[PAD]', '[UNK]'] + [chr(0x4e00 + k) for k in range(21126)]
    with open(files['vocab'], 'w', encoding='utf-8') as f:
        f.write('\n'.join(vocab) + '\n')
    cats = ['address', 'book', 'company', 'game', 'government', 'movie',
            'name', 'organization', 'position', 'scene']
    sentences = []
    for _ in range(N_SENTENCES + N_SENTENCES // 2):
        text = ''.join(chr(0x4e00 + int(k))
                       for k in g.integers(0, 21200, NER_LEN))
        label = {}
        for s0 in sorted(g.choice(NER_LEN - 8, 4, replace=False)):
            e0 = int(s0 + g.integers(1, 6))
            cat = cats[int(g.integers(0, 10))]
            label.setdefault(cat, {})[text[s0:e0 + 1]] = [[int(s0), e0]]
        sentences.append({'text': text, 'label': label})
    for key, part in (('ner_train', sentences[:N_SENTENCES]),
                      ('ner_test', sentences[N_SENTENCES:])):
        with open(files[key], 'w', encoding='utf-8') as f:
            f.write('\n'.join(json.dumps(ln, ensure_ascii=False)
                              for ln in part) + '\n')
    return files, images


def kie_ner_options(key, files, d):
    """``--cfg-options`` of a shipped KIE or NER config for the phase's
    data: its train and test annotation files, dictionary or vocabulary,
    and image directory (which holds no image: SDMGR's visual pages are
    black there, as the JAX dataset makes them for an absent file)."""
    opts = []
    for split in ('train', 'test'):
        if key == 'ner':
            opts += [f'data.{split}.ann_file={files["ner_" + split]}',
                     f'data.{split}.vocab_file={files["vocab"]}',
                     f'data.{split}.max_len={NER_LEN}']
        else:
            ann = files['openset' if key == 'openset' else 'closed']
            opts += [f'data.{split}.ann_file={ann}',
                     f'data.{split}.dict_file={files["dict"]}',
                     f'data.{split}.img_prefix={d}',
                     f'data.{split}.max_nodes={KIE_NODES}',
                     f'data.{split}.max_chars={KIE_CHARS}']
    return opts + [f'total_epochs={KIE_NER_EPOCHS}']


def logged_ms_item(fn):
    """``fn()``'s result and the ms an item that the KIE / NER
    evaluation logs (``tools/test.py`` ``eval_kie_ner``), read from its
    log record (the root logger at INFO while ``fn`` runs)."""
    import logging
    seen = []

    class Handler(logging.Handler):
        def emit(self, record):
            if record.getMessage().endswith('ms/item'):
                seen.append(record.args[-1])
    root, handler = logging.getLogger(), Handler()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        out = fn()
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    return out, seen[-1]


def kie_ner_phase(dev, name):
    """SDMGR and BERT-softmax NER on ``dev``, the card (see the module
    docstring); nothing of their paths launches a hand-written kernel."""
    import copy
    import math
    import tempfile

    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import MMOCR
    from tps_pp_tpu_torch.apis.train_det import _make_optimizer
    from tps_pp_tpu_torch.apis.train_kie import (
        KIE_KEYS, NER_KEYS, build_task_dataset, init_kie_weights,
        make_kie_step, make_ner_step, train_kie)
    from tps_pp_tpu_torch.config import load_config, merge_cli_options
    from tps_pp_tpu_torch.models.kie import build_sdmgr
    from tps_pp_tpu_torch.models.kie.sdmgr import _guarded_l2
    from tps_pp_tpu_torch.models.ner import NerClassifier
    from tps_pp_tpu_torch.registry import LOSSES
    from tps_pp_tpu_torch.tools import test as test_tool
    from tps_pp_tpu_torch.tools import train as train_tool

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    g = np.random.default_rng(SEED + 24)
    stats, sections, t_sec = {}, {}, [time.perf_counter()]

    def section(what):
        now = time.perf_counter()
        sections[what] = round(now - t_sec[0], 1)
        t_sec[0] = now

    def rel_err(got, want):
        """The largest difference over the CPU's largest magnitude."""
        want = want.detach().cpu().double()
        return float((got.detach().cpu().double() - want).abs().max()
                     / want.abs().max())

    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    files, images = kie_ner_data(d, g)
    paths = {k: os.path.join(repo, p) for k, p in KIE_NER_CONFIGS.items()}
    opts = {k: kie_ner_options(k, files, d) for k in KIE_NER_CONFIGS}
    cfgs = {k: merge_cli_options(load_config(paths[k]),
                                 test_tool.parse_cfg_options(opts[k]))
            for k in KIE_NER_CONFIGS}
    section('data')

    def batch_of(ds, keys, n):
        return [torch.from_numpy(np.stack([ds[i][k] for i in range(n)]))
                for k in keys]

    # ---- SDMGR: the card against the CPU at B_KIE, each config ----------
    checks, fwd = {}, {}
    for key in ('novisual', 'openset', 'unet16'):
        cfg = cfgs[key]
        visual = key == 'unet16'
        ds = build_task_dataset(cfg, 'test', **(
            {'images': images} if visual else {}))
        keys = ['relations', 'texts'] + (['img', 'boxes'] if visual else [])
        batch = batch_of(ds, keys, B_KIE)
        cpu = init_kie_weights(build_sdmgr(cfg['model'], visual), SEED).eval()
        card = copy.deepcopy(cpu).to(dev)
        xb = [b.to(dev) for b in batch]
        zero_launches()
        with torch.inference_mode():
            node, edge = card(*xb)
            read_launches('kie', f'{key} forward', {})
            node_h, edge_h = cpu(*batch)
            c = dict(node=rel_err(node, node_h), edge=rel_err(edge, edge_h))
            if visual:
                fm, fm_h = card.backbone(xb[2]), cpu.backbone(batch[2])
                c['map'] = rel_err(fm, fm_h)
                c['pooled'] = rel_err(
                    card.visual_features(xb[2], xb[3]),
                    cpu.visual_features(batch[2], batch[3]))
        if max(c.values()) > KIE_F32_RTOL:
            raise AssertionError(f'SDMGR {key}: card against CPU {c}')
        if key == 'openset':
            same = ties = pairs = 0
            N = KIE_NODES
            for b in range(B_KIE):
                item = ds[b]
                n = int((item['labels'] != -100).sum())
                got = []
                for nd, ed in ((node, edge), (node_h, edge_h)):
                    nodes = torch.softmax(nd[b].float(), -1)[:n]
                    links = torch.softmax(ed[b].float(), -1).reshape(
                        N, N, 2)[:n, :n, 1]
                    got.append(ds.decode_pred(dict(
                        filename=item['filename'],
                        nodes=nodes.cpu().numpy(),
                        edges=links.cpu().numpy())))
                pairs += len(got[1]['pairs'])
                if got[0]['pairs'] == got[1]['pairs'] and \
                        got[0]['labels'] == got[1]['labels']:
                    same += 1
                    continue
                e = torch.softmax(edge_h[b], -1).reshape(N, N, 2)[:n, :n, 1]
                e = torch.maximum(e, e.T)
                if not bool(((e - ds.edge_thr).abs() < OPENSET_TIE).any()):
                    raise AssertionError(f'SDMGR openset: receipt {b} pairs '
                                         f'{got[0]["pairs"]} on the card, '
                                         f'{got[1]["pairs"]} on the CPU')
                ties += 1
            c.update(decoded_equal=same, decoded_ties=ties, cpu_pairs=pairs)
        checks[key] = c
        if visual:             # SDMGR's forward by part, CUDA events
            h = card.head
            with torch.inference_mode():
                fwd['whole'] = cuda_ms(lambda: card(*xb), 10)
                fwd['unet_pool'] = cuda_ms(
                    lambda: card.visual_features(xb[2], xb[3]), 10)
                texts = xb[1]
                B_, N_, L_ = texts.shape
                emb = h.node_embed(texts.clamp(min=0).long()).reshape(
                    B_ * N_, L_, -1)
                fwd['lstm'] = cuda_ms(lambda: h.rnn(emb), 10)
                nodes = torch.randn(B_, N_, h.node_cls.in_features,
                                    device=dev)
                edges = _guarded_l2(h.edge_embed(xb[0]))
                mask = (texts > 0).any(-1).float()

                def gnn():
                    x = nodes
                    for layer in h.gnn_layers:
                        x, _ = layer(x, edges, mask)
                    return x
                fwd['gnn'] = cuda_ms(gnn, 10)
        del card, cpu
    log(f'kie SDMGR B={B_KIE}, {KIE_NODES} nodes of {KIE_CHARS} characters, '
        f'f32 (TF32 off), the card against the CPU on seed-{SEED} weights '
        f'(bound {KIE_F32_RTOL} of each largest magnitude): '
        f'{json.dumps(checks)}; UNet16 512x512 '
        f'forward {fwd["whole"]:.3f} ms (UNet + 7x7 RoI max pool '
        f'{fwd["unet_pool"]:.3f}, LSTM {fwd["lstm"]:.3f}, 2 GNN layers '
        f'{fwd["gnn"]:.3f}) [{name}]')
    stats['sdmgr'] = dict(checks=checks, forward_ms=fwd)
    section('sdmgr')

    # ---- BERT-base: the card against the CPU at B_NER_F32, timed at B_NER
    cfg = cfgs['ner']
    ds = build_task_dataset(cfg, 'train')
    cpu = init_kie_weights(NerClassifier(cfg['model']), SEED).eval()
    card = copy.deepcopy(cpu).to(dev)
    ids, mask, _ = batch_of(ds, NER_KEYS, B_NER)
    zero_launches()
    with torch.inference_mode():
        got = card(ids[:B_NER_F32].to(dev), mask[:B_NER_F32].to(dev))
        read_launches('ner', 'forward', {})
        want = cpu(ids[:B_NER_F32], mask[:B_NER_F32])
        err = rel_err(got, want)
        top2 = want.topk(2, -1).values
        gap = (top2[..., 0] - top2[..., 1])
        parted = got.cpu().argmax(-1) != want.argmax(-1)
        if err > NER_F32_RTOL or bool((parted & (gap >= NER_TIE)).any()):
            raise AssertionError(f'BERT-base: card against CPU {err}, '
                                 f'argmax parted at gaps {gap[parted]}')
        idb, mb = ids.to(dev), mask.to(dev)
        bert_ms = cuda_ms(lambda: card(idb, mb), 10)
    enc = cfg['model']['encoder']
    H, L_, F_ = (enc.get('hidden_size', 768), enc.get('num_hidden_layers', 12),
                 enc.get('intermediate_size', 3072))
    flops = B_NER * L_ * NER_LEN * (8 * H * H + 4 * H * F_ + 4 * NER_LEN * H)
    flops += 2 * B_NER * NER_LEN * H * 21
    bert_bound = flops / PEAK_F32 * 1e3
    log(f'ner BERT-base f32 (TF32 off): B={B_NER_F32} T={NER_LEN} logits '
        f'within {err:.3g} of their largest magnitude of the CPU\'s (bound '
        f'{NER_F32_RTOL}), argmax parted at {int(parted.sum())} positions, '
        f'each at a CPU top-2 gap below {NER_TIE}; forward B={B_NER} '
        f'T={NER_LEN} {bert_ms:.3f} ms ({flops / 1e9:.1f} GFLOP, bound '
        f'{bert_bound:.3f} ms at the f32 peak, '
        f'{flops / bert_ms / 1e9:.1f} TFLOP/s) [{name}]')
    stats['bert'] = dict(err=err, parted=int(parted.sum()), ms=bert_ms,
                         gflop=flops / 1e9, bound_ms=bert_bound)
    del card, cpu
    section('bert')

    # ---- one f32 step of each, the card against the CPU; SDMGR-UNet16's
    # also in float64 (its whole f32 gradient is ill-conditioned: the
    # fusion's signed square root has a derivative of 1 / (2 sqrt|z|) at
    # near-zero z; tools/torch_kie_precision.py --step shows it by module)
    steps = {}
    ner_cfg = copy.deepcopy(cfgs['ner'])
    merge_cli_options(ner_cfg, {
        'model.encoder.hidden_dropout_prob': 0.0,
        'model.encoder.attention_probs_dropout_prob': 0.0,
        'model.decoder.hidden_dropout_prob': 0.0})
    for key, cfg in (('unet16', cfgs['unet16']), ('ner', ner_cfg)):
        model_cfg = cfg['model']
        loss_fn = LOSSES.build(dict(model_cfg['loss']))
        if key == 'unet16':
            ds = build_task_dataset(cfg, 'train', images=images)
            batch = batch_of(ds, KIE_KEYS + ('img', 'boxes'), B_KIE)
            base = init_kie_weights(build_sdmgr(model_cfg, True), SEED)
        else:
            ds = build_task_dataset(cfg, 'train')
            batch = batch_of(ds, NER_KEYS, B_NER_F32)
            base = init_kie_weights(NerClassifier(model_cfg), SEED)
        res, grads = {}, {}
        dtypes = (torch.float32, torch.float64) if key == 'unet16' else (
            torch.float32,)
        for dtype in dtypes:
            for where in ('cpu', 'card'):
                device = dev if where == 'card' else torch.device('cpu')
                model = copy.deepcopy(base).to(device, dtype).train()
                opt, _ = _make_optimizer(cfg, model.named_parameters())
                step = (make_kie_step(model, loss_fn, opt) if key == 'unet16'
                        else make_ner_step(model, loss_fn, opt, SEED))
                xb = [(b.to(dtype) if b.is_floating_point() else
                       b).to(device) for b in batch]
                if where == 'card':
                    zero_launches()
                res[where, dtype] = r = {k: float(v)
                                         for k, v in step(xb).items()}
                if key == 'unet16' and dtype == torch.float32:
                    # the step's gradients, which the optimizer left in
                    # .grad (no clipping in the config; Adam copies them)
                    grad = {n: q.grad.detach().double().cpu()
                            for n, q in model.named_parameters()}
                    norm = float(torch.sqrt(sum((v * v).sum()
                                                for v in grad.values())))
                    if abs(norm - r['grad_norm']) > 1e-5 * r['grad_norm']:
                        raise AssertionError(
                            f'{key} {where}: .grad norm {norm} != '
                            f'{r["grad_norm"]}')
                    grads[where] = grad
                if where == 'card':
                    read_launches(key, 'step', {})
                    if dtype == torch.float32:
                        res['ms'] = cuda_ms(lambda: step(xb), 5)
                del model, opt

        def gap(a, b, k):
            return abs(a[k] - b[k]) / abs(b[k])
        f32 = torch.float32
        a, b = res['card', f32], res['cpu', f32]
        st = dict(loss_rel=gap(a, b, 'loss'),
                  grad_norm_rel=gap(a, b, 'grad_norm'), ms=res['ms'],
                  loss=a['loss'], grad_norm=a['grad_norm'])
        ok = st['grad_norm_rel'] <= DET_GRAD_NORM_RTOL
        if key == 'unet16':
            c, d = res['card', torch.float64], res['cpu', torch.float64]
            gc, gp = grads['card'], grads['cpu']
            down, moved = {}, {}
            for grp in KIE_DOWNSTREAM:
                names = [n for n in gp if n.startswith(grp + '.')]
                nc, npu, diff = (np.sqrt(sum(float((v ** 2).sum())
                                             for v in vs)) for vs in (
                    [gc[n] for n in names], [gp[n] for n in names],
                    [gc[n] - gp[n] for n in names]))
                down[grp] = float(abs(nc - npu) / npu)
                moved[grp] = float(diff / npu)
            st.update(f64_loss_rel=gap(c, d, 'loss'),
                      f64_grad_norm_rel=gap(c, d, 'grad_norm'),
                      downstream_rel=down, downstream_moved=moved,
                      card_f32_from_f64=gap(a, d, 'grad_norm'),
                      cpu_f32_from_f64=gap(b, d, 'grad_norm'))
            ok = (st['f64_loss_rel'] <= DET_LOSS_RTOL
                  and st['f64_grad_norm_rel'] <= DET_GRAD_NORM_RTOL
                  and max(down.values()) <= DET_GRAD_NORM_RTOL
                  and st['card_f32_from_f64'] <=
                  KIE_F32_GRAD_MULT * st['cpu_f32_from_f64'])
        if not (np.isfinite(a['loss']) and st['loss_rel'] <= DET_LOSS_RTOL
                and ok):
            raise AssertionError(f'{key} step: {res} {st}')
        steps[key] = st
    u = steps['unet16']
    log(f'kie / ner steps, the card against the CPU (loss bound '
        f'{DET_LOSS_RTOL}, grad norm {DET_GRAD_NORM_RTOL}, relative): '
        f'SDMGR-UNet16 B={B_KIE} (train-mode BatchNorm) f32 loss '
        f'{u["loss"]:.6f} ({u["loss_rel"]:.3g} apart), grad norm '
        f'{u["grad_norm"]:.6f} ({u["grad_norm_rel"]:.3g} apart, logged), '
        f'downstream of the fusion, grad norm (the difference over the '
        f'norm, logged) '
        + ', '.join(f'{k[5:]} {v:.3g} ({u["downstream_moved"][k]:.3g})'
                    for k, v in u['downstream_rel'].items())
        + f' apart; f32 grad norm from the CPU\'s float64: card '
        f'{u["card_f32_from_f64"]:.3g}, CPU {u["cpu_f32_from_f64"]:.3g} '
        f'(bound {KIE_F32_GRAD_MULT}x the CPU\'s); float64: loss '
        f'{u["f64_loss_rel"]:.3g} and grad norm {u["f64_grad_norm_rel"]:.3g} '
        f'apart; {u["ms"]:.2f} ms an f32 step; '
        f'BERT-base B={B_NER_F32} T={NER_LEN} f32 without dropout loss '
        f'{steps["ner"]["loss"]:.6f} ({steps["ner"]["loss_rel"]:.3g} '
        f'apart), grad norm {steps["ner"]["grad_norm_rel"]:.3g} apart, '
        f'{steps["ner"]["ms"]:.2f} ms a step [{name}]')
    stats['steps'] = steps
    torch.cuda.empty_cache()
    section('steps')

    # ---- training, then tools/test.py on the card and on the CPU --------
    runs = {}
    with tempfile.TemporaryDirectory() as wd:
        zero_launches()
        t0 = time.perf_counter()
        _, opt, hist = train_kie(
            cfgs['unet16'], build_task_dataset(cfgs['unet16'], 'train',
                                               images=images),
            work_dir=os.path.join(wd, 'unet16'),
            batch_size=int(cfgs['unet16']['data']['samples_per_gpu']),
            seed=SEED, device=dev)
        torch.cuda.synchronize()
        runs['unet16'] = dict(seconds=time.perf_counter() - t0,
                              steps=opt.count,
                              losses=[h['loss'] for h in hist])
        for key in ('novisual', 'ner'):
            t0 = time.perf_counter()
            _, opt, hist = train_tool.main(
                [paths[key], '--work-dir', os.path.join(wd, key),
                 '--seed', str(SEED), '--cfg-options'] + opts[key],
                device=dev)
            torch.cuda.synchronize()
            runs[key] = dict(seconds=time.perf_counter() - t0,
                             steps=opt.count,
                             losses=[h['loss'] for h in hist])
        read_launches('kie / ner', 'training', {})
        for key in ('unet16', 'novisual', 'ner'):
            ckpt = os.path.join(wd, key, f'epoch_{KIE_NER_EPOCHS}.pth')
            argv = [paths[key], ckpt, '--cfg-options'] + opts[key]
            if key != 'ner':
                argv.append('evaluation.metric_options.macro_f1.ignores=[]')
            zero_launches()
            on_card, item_ms = logged_ms_item(
                lambda: test_tool.main(argv, device=dev))
            read_launches(key, 'tools/test.py', {})
            on_cpu = test_tool.main(argv, device='cpu')
            if on_card != on_cpu:
                raise AssertionError(f'{key} tools/test.py: card {on_card}, '
                                     f'CPU {on_cpu}')
            runs[key].update(metrics=on_card, eval_ms_item=item_ms)
    bad = [k for k, r in runs.items() if not np.isfinite(r['losses']).all()]
    if bad:
        raise AssertionError(f'kie / ner training: {runs}')
    log(f'kie / ner training, {KIE_NER_EPOCHS} epochs each, then '
        f'tools/test.py on the card and the CPU (equal metrics): '
        f'train_kie SDMGR-UNet16 ({N_RECEIPTS} receipts, B=4) '
        f'{runs["unet16"]["seconds"]:.2f} s, eval on black pages '
        f'{runs["unet16"]["metrics"]} at '
        f'{runs["unet16"]["eval_ms_item"]:.2f} ms an item; tools/train.py '
        f'SDMGR closed set {runs["novisual"]["seconds"]:.2f} s, '
        f'{runs["novisual"]["metrics"]} at '
        f'{runs["novisual"]["eval_ms_item"]:.2f} ms an item; tools/train.py '
        f'BERT-softmax ({N_SENTENCES} sentences, B=8) '
        f'{runs["ner"]["seconds"]:.2f} s, {runs["ner"]["metrics"]} at '
        f'{runs["ner"]["eval_ms_item"]:.2f} ms an item; losses '
        f'{ {k: [round(x, 4) for x in r["losses"]] for k, r in runs.items()} }'
        f' [{name}]')
    stats['training'] = runs
    section('training')

    # ---- MMOCR.readtext with KIE: DBNet-R18, the flagship, SDMGR --------
    reader = MMOCR(det=os.path.join(repo, DET_CONFIGS['dbnet_r18'][0]),
                   recog='NRTR_TPS', kie='SDMGR', device=dev)
    det = reader.detector
    pages = [g.integers(0, 256, (*PAGE_HW, 3), np.uint8) for _ in range(2)]
    x = torch.as_tensor(np.stack([det.prep(p)[0] for p in pages]),
                        device=dev)
    thr = det.postprocessor.mask_thr
    logit = torch.logit(det.forward(x)[..., 0]).flatten()[::7].cpu()
    for above in KIE_DB_ABOVE:       # DB's map stressed until it keeps boxes
        shift = (math.log(thr / (1 - thr))
                 - float(torch.quantile(logit, 1 - above)))
        with torch.no_grad():
            det.model.head.binarize[6].bias.add_(shift)
        if min(len(b) for b in det.detect_batch(pages)) >= KIE_MIN_BOXES:
            break
        with torch.no_grad():
            det.model.head.binarize[6].bias.sub_(shift)
    else:
        raise AssertionError(f'readtext: no share in {KIE_DB_ABOVE} keeps '
                             f'{KIE_MIN_BOXES} boxes a page')
    reader.readtext(pages[:1])
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    res = reader.readtext(pages)
    torch.cuda.synchronize()
    whole = (time.perf_counter() - t0) / len(pages)
    rec_launches = read_launches('kie', 'readtext', {'tps_sampler': None})
    boxes = [b for r in res for b in r['result']]
    if len(res) != 2 or len(boxes) < 2 * KIE_MIN_BOXES or not all(
            isinstance(b.get('label'), int) and
            0.0 <= b.get('label_score', -1.0) <= 1.0 for b in boxes):
        raise AssertionError(f'readtext with KIE: {res!r:.400}')
    t_det = t_rec = t_kie = 0.0
    for page in pages:
        t0 = time.perf_counter()
        crops, quads = reader.crops(page, det.detect(page))
        t1 = time.perf_counter()
        recs = reader.recognize(crops)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        results = [{'box': q, 'text': r['text']}
                   for (q, _), r in zip(quads, recs)]
        zero_launches()
        reader.kie_infer(results)
        torch.cuda.synchronize()
        t_kie += time.perf_counter() - t2
        read_launches('kie', 'kie_infer', {})
        t_det += t1 - t0
        t_rec += t2 - t1
    n = len(pages)
    log(f'kie readtext {n} pages {PAGE_HW[1]}x{PAGE_HW[0]} (DBNet-R18 f32, '
        f'its map stressed: {above} of it above the threshold; NRTR + TPS++ '
        f'f32 from its config; SDMGR at MMOCR\'s widths, seed-{SEED} '
        f'weights): {whole * 1e3:.1f} ms/page; detection and crops '
        f'{t_det / n * 1e3:.1f}, recognition {t_rec / n * 1e3:.1f}, KIE '
        f'{t_kie / n * 1e3:.2f} ms/page; {len(boxes) / n:.1f} boxes a page, '
        f'each labelled ({len({b["label"] for b in boxes})} classes); '
        f'launches {rec_launches} (the recognizer\'s; KIE none) [{name}]')
    stats['readtext'] = dict(ms_page=whole * 1e3, det=t_det / n * 1e3,
                             recog=t_rec / n * 1e3, kie=t_kie / n * 1e3,
                             boxes=len(boxes))
    del reader, det, x
    tmp.cleanup()
    torch.cuda.empty_cache()
    section('readtext')
    log(f'kie_ner phase: {time.perf_counter() - t_phase:.1f} s (by '
        f'section: {sections}); no hand-written kernel launched by KIE or '
        f'NER; {json.dumps(stats)}')


def exit_by_ratio(dec, end_idx):
    """Wrap ``dec``'s ``decode_init`` and ``decode_step`` on the instance so
    that row n emits EOS (a one-hot of ``end_idx`` in place of its
    probabilities) at step ``exit_code(valid_ratio[n])``: the exit's
    schedule is an input of an exported or captured program, and one
    program serves every schedule."""
    import torch
    init, step = dec.decode_init, dec.decode_step

    def decode_init(out_enc, valid_ratio=None, **kw):
        carry, static = init(out_enc, valid_ratio, **kw)
        finish = torch.round(valid_ratio * 1000).long() % 64 - 1
        return carry, (static, finish)

    def decode_step(token, t, carry, static, plain=False, **kw):
        static, finish = static
        probs, carry = step(token, t, carry, static, plain=plain, **kw)
        eos = (torch.arange(probs.shape[-1], device=probs.device) ==
               end_idx).to(probs.dtype)
        return torch.where((finish == t)[:, None], eos, probs), carry
    dec.decode_init, dec.decode_step = decode_init, decode_step


def ratio_for_exit(steps, g):
    """Valid ratios in [0.32, 0.94] whose ``exit_by_ratio`` code is
    ``steps`` (-1: the row never emits EOS)."""
    import numpy as np
    k = g.integers(5, 15, len(steps))
    return ((k * 64 + np.asarray(steps) + 1) / 1000).astype(np.float32)


def steps_exit_deploy(dev, name, img):
    """Greedy ``steps`` + ``use_fused_step`` with its early exit through
    ``export_serialized`` / ``load_serialized`` and ``aot_compile``, at
    B=8 and B=512, bf16, with the exit forced at step 0, mid-sequence and
    never (``exit_by_ratio``): argmax and zeros equal to the eager
    decode's, kernels 6-7 in the program and in the graph, none launched
    from Python at a replay; the replay, eager ``predict`` (the host
    exit) and the eager device exit timed in turns."""
    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import (FLAGSHIP_INPUT, build_recognizer,
                                       nrtr_tps_pp_cfg)
    from tps_pp_tpu_torch.utils import export

    cfg = nrtr_tps_pp_cfg(dtype='bfloat16', decode_mode='steps')
    cfg['decoder'] = dict(cfg['decoder'], use_fused_step=True)
    rec = build_recognizer(cfg).init_weights(SEED)
    model = rec.serving_model()
    S, end = rec.max_seq_len, rec.label_convertor.end_idx
    exit_by_ratio(model.decoder, end)
    g = np.random.default_rng(SEED + 7)
    want = {'tps_sampler': 1, 'self_attn_step': 6 * S,
            'cross_ffn_step': 6 * S}
    for n in (B_SMALL, B):
        rows = np.arange(n)
        mid = (7 * rows) % 20 + 1          # the last row to end: step 20
        schedules = {'step 0': np.zeros(n, int), 'mid-sequence': mid,
                     'never': np.where(rows == 0, -1, mid)}
        im = img[:n].contiguous()
        t0 = time.perf_counter()
        blob = export.export_serialized(rec, n, FLAGSHIP_INPUT)
        t_export = time.perf_counter() - t0
        program = export.load_serialized(blob).module()
        t0 = time.perf_counter()
        call = export.aot_compile(rec, n, FLAGSHIP_INPUT)
        t_aot = time.perf_counter() - t0
        log(f'deploy steps exit B={n}: export {t_export:.2f} s, '
            f'{len(blob)} bytes; aot_compile {t_aot:.2f} s (capture '
            f'{call.capture_ms:.1f} ms), graph pool {call.pool_bytes} '
            f'bytes; launches captured {call.captured_launches} [{name}]')
        if call.captured_launches != want:
            raise AssertionError(f'deploy steps exit B={n}: captured '
                                 f'{call.captured_launches}, not {want}')
        for what, steps in schedules.items():
            vr = torch.from_numpy(ratio_for_exit(steps, g)).to(dev)
            eager = rec.predict(im, vr, bucket_batch=False)
            stop = int(steps.max()) if steps.min() >= 0 else None
            ended = eager.argmax(-1) == end
            if stop is not None and not (
                    bool((eager[:, stop + 1:] == 0).all()) and
                    bool(ended[:, stop].any())):
                raise AssertionError(f'deploy steps exit B={n} {what}: the '
                                     f'eager decode did not stop at {stop}')
            zero_launches()
            with torch.no_grad():
                got_p = program(im, vr)
            read_launches('deploy', f'steps exit program B={n} {what}',
                          want)
            zero_launches()
            got_r = call(im, vr).clone()
            read_launches('deploy', f'steps exit replay B={n} {what} (no '
                          f'Python launch)', {})
            for kind, got in (('program', got_p), ('replay', got_r)):
                same = int((got.argmax(-1) == eager.argmax(-1)).all(-1)
                           .sum())
                zeros = bool(torch.equal(got == 0, eager == 0))
                log(f'deploy steps exit B={n} {what}: {kind} argmax equal '
                    f'to eager on {same} of {n} rows, its zeros the eager '
                    f'decode\'s: {zeros}, bit-equal: '
                    f'{bool(torch.equal(got, eager))} (exit step '
                    f'{stop})')
                if same != n or not zeros:
                    raise AssertionError(f'deploy steps exit B={n} {what}: '
                                         f'the {kind} parts from eager')
            # eager: predict, whose decode reads the exit on the host;
            # eager device exit: the same batch through the traced form
            with torch.inference_mode():
                fns = {'replay': lambda: call(im, vr),
                       'eager': lambda: rec.predict(im, vr,
                                                    bucket_batch=False),
                       'eager device exit': lambda: rec._predict_impl(
                           model, im, vr, device_exit=True)}
                ms = {k: [] for k in fns}
                for k in ('replay', 'eager', 'eager device exit',
                          'eager device exit', 'eager', 'replay'):
                    ms[k].append(cuda_ms(fns[k], 2))
            log(f'deploy steps exit B={n} {what}: ms a batch (CUDA events, '
                f'in turns) ' + ', '.join(
                    f'{k} {" / ".join(f"{v:.3f}" for v in vs)}'
                    for k, vs in ms.items()) + f' [{name}]')
        del blob, program, call
    del rec, model


def packed_roundtrip(rec, g):
    """``eval_recognizer`` over PNG crops whose annotation file is a
    TPSPACK1 file written by ``tools.data.pack_converter`` and over the same
    lines as text: the same texts and metrics."""
    import tempfile

    import numpy as np
    from tps_pp_tpu_torch.apis import eval_recognizer
    from tps_pp_tpu_torch.apis.inference import DEFAULT_TEST_PIPELINE
    from tps_pp_tpu_torch.convertors.base import BaseConvertor
    from tps_pp_tpu_torch.datasets import OCRDataset
    from tps_pp_tpu_torch.datasets.pipelines.cv_ops import (png_decode,
                                                             png_encode)
    from tps_pp_tpu_torch.tools.data import pack_converter
    from tps_pp_tpu_torch.utils.packed import PackedReader

    def load_png(results):
        path = os.path.join(results['img_prefix'],
                            results['img_info']['filename'])
        with open(path, 'rb') as f:
            img = png_decode(f.read())
        results.update(filename=path, img=img, img_shape=img.shape,
                       ori_shape=img.shape)
        return results

    chars = BaseConvertor.DICT90
    with tempfile.TemporaryDirectory() as d:
        lines = []
        for i in range(PACKED_CROPS):
            crop = g.integers(0, 256, (int(g.integers(16, 65)),
                                       int(g.integers(24, 401)), 3),
                              np.uint8)
            with open(os.path.join(d, f'crop_{i}.png'), 'wb') as f:
                f.write(png_encode(crop))
            text = ''.join(chars[int(c)] for c in g.integers(
                0, len(chars), int(g.integers(1, 26))))
            lines.append(f'crop_{i}.png {text}')
        txt = os.path.join(d, 'label.txt')
        pack = os.path.join(d, 'label.pack')
        with open(txt, 'w', encoding='utf-8') as f:
            f.write('\n'.join(lines) + '\n')
        pack_converter.main([txt, pack])
        if [PackedReader(pack)[i].decode() for i in range(len(lines))] != \
                lines:
            raise AssertionError('packed: the records are not the lines')
        out = {}
        for kind, ann, loader in (('text', txt, 'HardDiskLoader'),
                                  ('TPSPACK1', pack, 'PackedLoader')):
            ds = OCRDataset(ann_file=ann, img_prefix=d, test_mode=True,
                            loader=dict(type=loader,
                                        parser=dict(type='LineStrParser')),
                            pipeline=[load_png] + DEFAULT_TEST_PIPELINE)
            out[kind] = eval_recognizer(rec, ds, batch_size=8,
                                        return_results=True)
    (m_t, r_t), (m_p, r_p) = out['text'], out['TPSPACK1']
    same = [a['text'] for a in r_t] == [b['text'] for b in r_p]
    log(f'packed round trip: eval_recognizer over {PACKED_CROPS} PNG crops, '
        f'annotations as TPSPACK1 {m_p} and as text {m_t}; texts equal: '
        f'{same}')
    if not same or m_t != m_p:
        raise AssertionError('packed: TPSPACK1 and text annotations read '
                             'differently')


def deploy_phase(dev, name):
    """The deployment entry points on the card (see the module docstring,
    "deployment")."""
    import base64
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import (FLAGSHIP_INPUT, build_recognizer,
                                       model_inference, nrtr_tps_pp_cfg)
    from tps_pp_tpu_torch.datasets.pipelines.cv_ops import (png_decode,
                                                             png_encode)
    from tps_pp_tpu_torch.tools import serve_model
    from tps_pp_tpu_torch.utils import export

    t_phase = time.perf_counter()
    want = {'tps_sampler': 1, 'encoder': 1, 'full_decode': 1}
    rec = build_recognizer(nrtr_tps_pp_cfg(
        dtype='bfloat16', decode_mode='fused40_bf16')).init_weights(SEED)
    g = np.random.default_rng(SEED)
    h, w, c = FLAGSHIP_INPUT
    img = torch.from_numpy(g.standard_normal((B, h, w, c)).astype(
        np.float32)).to(dev, torch.bfloat16)
    vr = torch.from_numpy(g.uniform(0.3, 1.0, B).astype(np.float32)).to(dev)
    vr[::4] = 1.0

    def same_argmax(what, got, ref):
        if tuple(got.shape) != tuple(ref.shape) or not bool(
                torch.isfinite(got).all()):
            raise AssertionError(f'deploy {what}: output {tuple(got.shape)}'
                                 f', finite {bool(torch.isfinite(got).all())}')
        rows = int((got.argmax(-1) == ref.argmax(-1)).all(-1).sum())
        diff = float((got.float() - ref.float()).abs().max())
        log(f'deploy {what}: argmax equal to the eager kernel path on '
            f'{rows} of {got.shape[0]} rows; largest probability '
            f'difference {diff:.4g}')
        if rows != got.shape[0]:
            raise AssertionError(f'deploy {what}: {got.shape[0] - rows} '
                                 f'rows part from the eager kernel path')

    # ---- torch.export at B=512: the loaded program's launches (B=8 is
    # exported on the steps path, steps_exit_deploy)
    for n in (B,):
        eager = rec.predict(img[:n], vr[:n], bucket_batch=False)
        t0 = time.perf_counter()
        blob = export.export_serialized(rec, n, FLAGSHIP_INPUT)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = export.load_serialized(blob).module()
        t_load = time.perf_counter() - t0
        zero_launches()
        with torch.no_grad():
            got = program(img[:n].contiguous(), vr[:n].contiguous())
        read_launches('deploy', f'exported program B={n}', want)
        log(f'deploy export B={n}: {len(blob)} bytes, export '
            f'{t_export:.2f} s, load {t_load:.2f} s [{name}]')
        same_argmax(f'exported program B={n}', got, eager)
        del blob, program

    # ---- aot_compile at B=512: the captured graph and its replay
    t0 = time.perf_counter()
    call = export.aot_compile(rec, B, FLAGSHIP_INPUT)
    t_aot = time.perf_counter() - t0
    log(f'deploy aot_compile B={B}: {t_aot:.2f} s (two eager calls, then '
        f'the capture {call.capture_ms:.1f} ms); graph pool '
        f'{call.pool_bytes} bytes; launches captured '
        f'{call.captured_launches} [{name}]')
    if call.captured_launches != want:
        raise AssertionError(f'deploy aot_compile: captured '
                             f'{call.captured_launches}, not {want}')
    zero_launches()
    got = call(img, vr).clone()
    read_launches('deploy', 'graph replay (no Python launch)', {})
    same_argmax(f'graph replay B={B}', got,
                rec.predict(img, vr, bucket_batch=False))
    with torch.inference_mode():
        for what, fn in (('replay', lambda: call(img, vr)),
                         ('eager predict', lambda: rec.predict(
                             img, vr, bucket_batch=False)),
                         ('eager predict', lambda: rec.predict(
                             img, vr, bucket_batch=False)),
                         ('replay', lambda: call(img, vr))):
            log(f'deploy B={B} {what}: {cuda_ms(fn, 5):.3f} ms [{name}]')
    del call

    # ---- ExportedRecognizer: simple_test at a compiled batch of 8
    five = img[:5].float().cpu().numpy()
    er = export.ExportedRecognizer(rec, 8, FLAGSHIP_INPUT)
    got = [r['text'] for r in er.simple_test(five)]
    ref = [r['text'] for r in rec.simple_test(five)]
    log(f'deploy ExportedRecognizer: texts {got[:2]}...; equal to '
        f'simple_test: {got == ref}')
    if got != ref:
        raise AssertionError('deploy ExportedRecognizer: texts differ from '
                             'simple_test')
    packed_roundtrip(rec, g)
    del er, rec

    # ---- greedy steps + use_fused_step with its early exit, exported and
    # captured
    steps_exit_deploy(dev, name, img)

    # ---- serve_model in a thread: the flagship config, PNG bodies
    repo = os.path.dirname(os.path.abspath(__file__))

    def serve(argv):
        server = serve_model.make_server(argv + ['--port', '0'])
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server, thread, f'http://127.0.0.1:{server.server_address[1]}'

    def stop(server, thread):
        server.shutdown()
        server.server_close()
        server.model.close()
        thread.join(timeout=60)
        if thread.is_alive():
            raise AssertionError('deploy: the server thread did not stop')

    def request(url, body=None):
        req = urllib.request.Request(url, data=body,
                                     method='GET' if body is None
                                     else 'POST')
        try:
            r = urllib.request.urlopen(req, timeout=300)
            return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    server, thread, base = serve([
        os.path.join(repo, 'configs/textrecog/nrtr/nrtr_tps++.py'),
        '--cfg-options', 'model.dtype=bfloat16'])
    try:
        srec = server.model.rec
        crops = [g.integers(0, 256, (int(g.integers(16, 65)),
                                     int(g.integers(24, 401)), 3), np.uint8)
                 for _ in range(DEPLOY_CROPS)]
        request(base + '/predictions/ocr', png_encode(crops[0]))   # warm
        # the server's own time a request: the body's decode (in the
        # request's thread) and the model's predict (model_inference on the
        # model's worker thread, the wait for it included)
        inside = {'decode': [], 'predict': []}

        def timed(key, fn):
            def call(*a):
                t0 = time.perf_counter()
                out = fn(*a)
                torch.cuda.synchronize()
                inside[key].append((time.perf_counter() - t0) * 1e3)
                return out
            return call
        decode_image = serve_model.decode_image
        serve_model.decode_image = timed('decode', decode_image)
        server.model.predict = timed('predict', server.model.predict)
        zero_launches()
        # the references first, in this thread, so that no work of this
        # thread runs beside a request
        refs, decode_ms, infer_ms = [], [], []
        for crop in crops:
            raw = png_encode(crop)
            t0 = time.perf_counter()
            arr = png_decode(raw)
            t1 = time.perf_counter()
            refs.append((raw, arr, model_inference(srec, arr)))
            torch.cuda.synchronize()
            decode_ms.append((t1 - t0) * 1e3)
            infer_ms.append((time.perf_counter() - t1) * 1e3)
        # model_inference in a new thread a call, as the server runs it
        fresh_ms = []
        for _, arr, _ in refs:
            def run(a=arr):
                t0 = time.perf_counter()
                model_inference(srec, a)
                torch.cuda.synchronize()
                fresh_ms.append((time.perf_counter() - t0) * 1e3)
            th = threading.Thread(target=run)
            th.start()
            th.join()
        fresh_ms.sort()
        log(f'deploy model_inference of one crop in a new thread a call: '
            f'p50 {fresh_ms[len(fresh_ms) // 2]:.2f} ms, max '
            f'{fresh_ms[-1]:.2f} [{name}]')
        times, worst = [], 0.0
        for raw, arr, ref in refs:
            for body in (raw, base64.b64encode(raw)):
                t0 = time.perf_counter()
                code, out = request(base + '/predictions/ocr', body)
                times.append((time.perf_counter() - t0) * 1e3)
                score = float(np.mean(ref['score']))
                worst = max(worst, abs(out.get('score', np.inf) - score))
                if code != 200 or out['text'] != ref['text'] or \
                        abs(out['score'] - score) > DEPLOY_SCORE_ATOL:
                    raise AssertionError(f'deploy serve: {code} {out} '
                                         f'against {ref}')
        read_launches('deploy', f'serve_model, {2 * DEPLOY_CROPS} requests '
                      f'and their model_inference', {k: None for k in want})
        serve_model.decode_image = decode_image
        for ts in (times, decode_ms, infer_ms, *inside.values()):
            ts.sort()
        log(f'deploy serve_model ({srec.resolved_decode_mode()}): '
            f'{len(times)} PNG requests (raw and base64) equal to '
            f'model_inference (largest score difference {worst:.3g}); ms a '
            f'request p50 {times[len(times) // 2]:.2f}, max {times[-1]:.2f}; '
            f'of a crop, png_decode p50 {decode_ms[len(crops) // 2]:.2f} '
            f'(max {decode_ms[-1]:.2f}), model_inference p50 '
            f'{infer_ms[len(crops) // 2]:.2f} (max {infer_ms[-1]:.2f}); in '
            f'the server, a request\'s decode p50 '
            f'{inside["decode"][len(times) // 2]:.2f} and predict p50 '
            f'{inside["predict"][len(times) // 2]:.2f} [{name}]')
        checks = {'ping': request(base + '/ping'),
                  'bad body': request(base + '/predictions/ocr',
                                      b'garbage\x00'),
                  'bad path': request(base + '/predictions/nope',
                                      png_encode(crops[0]))}
        codes = {k: v[0] for k, v in checks.items()}
        log(f'deploy serve_model: {codes}, ping {checks["ping"][1]}')
        if codes != {'ping': 200, 'bad body': 400, 'bad path': 404} or \
                checks['ping'][1] != {'status': 'Healthy'}:
            raise AssertionError(f'deploy serve_model: {checks}')
    finally:
        stop(server, thread)
    del srec

    # ---- --det: DBNet-R18 on a 640 x 480 page
    server, thread, base = serve([os.path.join(repo, DET_CONFIGS[
        'dbnet_r18'][0]), '--det'])
    try:
        page = g.integers(0, 256, PAGE_HW + (3,), np.uint8)
        t0 = time.perf_counter()
        code, out = request(base + '/predictions/ocr', png_encode(page))
        t_det = (time.perf_counter() - t0) * 1e3
        got = out.get('boundary_result', [])
        ref = [list(map(float, b))
               for b in server.model.detector.detect(page)]
        same = len(got) == len(ref) > 0 and all(
            len(a) == len(b) for a, b in zip(got, ref))
        diff = max((float(np.abs(np.subtract(a, b)).max())
                    for a, b in zip(got, ref)), default=0.0)
        log(f'deploy serve_model --det: {code}, {len(got)} boundaries, '
            f'detect {len(ref)}, largest difference {diff:.3g}; '
            f'{t_det:.1f} ms the request (the first) [{name}]')
        if code != 200 or not same or diff > DEPLOY_BOX_ATOL:
            raise AssertionError(f'deploy --det: {code}, {len(got)} '
                                 f'boundaries against detect\'s {len(ref)}, '
                                 f'{diff}')
    finally:
        stop(server, thread)
    log(f'deploy phase: {time.perf_counter() - t_phase:.1f} s [{name}]')


def mesh_phase(dev, name, hw=(32, 128)):
    """``predict(mesh=)`` and ``eval_recognizer(mesh=)`` on the card (see
    the module docstring, "the mesh phase"), on crops of ``hw``."""
    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import (build_recognizer, eval_recognizer,
                                       nrtr_tps_pp_cfg)
    from tps_pp_tpu_torch.apis.inference import DEFAULT_TEST_PIPELINE
    from tps_pp_tpu_torch.convertors.base import BaseConvertor
    from tps_pp_tpu_torch.datasets.pipelines import Compose
    from tps_pp_tpu_torch.evaluation import eval_ocr_metric
    from tps_pp_tpu_torch.parallel import create_mesh
    from tps_pp_tpu_torch.utils.batching import next_pow2, pad_rows

    rec = build_recognizer(nrtr_tps_pp_cfg(dtype='bfloat16',
                                           decode_mode='auto'))
    rec.init_weights(SEED)
    g = np.random.default_rng(SEED + 27)
    img = torch.from_numpy(g.standard_normal((B,) + tuple(hw) + (3,)).astype(
        np.float32)).to(dev, rec.dtype)
    vr = torch.from_numpy(g.uniform(0.3, 1.0, B).astype(np.float32)).to(dev)
    cards = [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
    meshes = {f'{len(cards)} card(s)': create_mesh(devices=cards),
              'card 0 twice': create_mesh(devices=[cards[0]] * 2)}
    counted = ('tps_sampler.launches', 'encoder_forward.launches',
               'full_decode.launches')
    rec.predict(img, vr)
    for label, mesh in meshes.items():
        for n in ((B, MESH_SMALL) if 'twice' in label else (B,)):
            zero_launches()
            got = rec.predict(img[:n], vr[:n], mesh=mesh)
            torch.cuda.synchronize()
            shards = rec.last_shard_launches
            nd = mesh.shape['data']
            if len(shards) != nd or any(
                    c.get(k, 0) < 1 for c in shards for k in counted):
                raise AssertionError(f'mesh {label} B={n}: kernels 1, 3, 4 '
                                     f'not launched on every shard: {shards}')
            m = -(-next_pow2(n) // nd) * nd
            xp, vp = pad_rows((img[:n], vr[:n]), n, m)
            s = m // nd
            replicas = rec._shard_replicas(mesh.data_devices())
            bitwise, parted = 0, 0
            for i, d in enumerate(mesh.data_devices()):
                with torch.cuda.device(d), torch.inference_mode(), \
                        rec._mode(replicas[i], False):
                    alone = rec._predict_impl(
                        replicas[i], xp[i * s:(i + 1) * s].to(d).contiguous(),
                        vp[i * s:(i + 1) * s].to(d).contiguous())
                rows = got[i * s:min((i + 1) * s, n)]
                alone = alone[:rows.shape[0]].to(rows.device)
                if torch.equal(rows, alone):
                    bitwise += 1
                elif rows.shape[0]:
                    _, ties, _ = check_decode(rows, alone,
                                              f'mesh {label} shard {i}')
                    parted += ties
            log(f'mesh {label} B={n}: {nd} shard(s) of {s} rows, launches '
                f'by shard {shards}; {bitwise} of {nd} shards bit-equal to '
                f'predict of their rows alone on their card, {parted} rows '
                f'part at a near-tie')
    # eval_recognizer over crops: with the card-twice mesh as without
    pipeline = Compose([dict(type='LoadImageFromNdarray')]
                       + DEFAULT_TEST_PIPELINE)
    chars = BaseConvertor.DICT90
    crops = [g.integers(0, 256, (int(g.integers(16, 65)),
                                 int(g.integers(24, 401)), 3), np.uint8)
             for _ in range(100)]
    labels = [''.join(chars[int(i)] for i in g.integers(
        0, len(chars), int(g.integers(1, 26)))) for _ in crops]

    class ArrayDataset:
        def __len__(self):
            return len(crops)

        def __getitem__(self, i):
            return pipeline(dict(img=crops[i], img_info=dict(filename=None)))

        def evaluate(self, results, metric='acc'):
            return eval_ocr_metric([x['text'] for x in results], labels)

    # batches of 32 split in two shards of 16 rows: the call without a mesh
    # at batches of 16 runs the same rows at the same shapes
    got = eval_recognizer(rec, ArrayDataset(), batch_size=32,
                          return_results=True, mesh=meshes['card 0 twice'])
    want = eval_recognizer(rec, ArrayDataset(), batch_size=16,
                           return_results=True)
    whole = eval_recognizer(rec, ArrayDataset(), batch_size=32,
                            return_results=True)
    same = got[1] == want[1]
    log(f'mesh eval_recognizer, batches of 32 on card 0 twice: {got[0]}; '
        f'results equal to the call without a mesh at batches of 16 (the '
        f'shards\' shapes): {same}; texts equal to it at batches of 32: '
        f'{sum(a["text"] == b["text"] for a, b in zip(got[1], whole[1]))} '
        f'of {len(crops)}')
    if got[0] != want[0] or not same:
        raise AssertionError(f'mesh eval_recognizer: {got[0]} != {want[0]} '
                             f'or other results')
    # the meshes against one card, in turns
    runs = {'one card': None, **meshes}
    times = {k: [] for k in runs}
    for k in list(runs) + list(reversed(list(runs))):
        rec.predict(img, vr, mesh=runs[k])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            rec.predict(img, vr, mesh=runs[k])
        torch.cuda.synchronize()
        times[k].append((time.perf_counter() - t0) / 3)
    for k, ts in times.items():
        log(f'mesh predict B={B} {k}: {B / min(ts):.1f} images/s '
            f'({min(ts) * 1e3:.2f} ms/batch, best of 2 rounds of 3) [{name}]')
    del rec
    torch.cuda.empty_cache()


def main():
    import torch
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device '
                 '(torch.cuda.is_available() is False)')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from tps_pp_tpu_torch.apis import (FLAGSHIP_INPUT, build_recognizer,
                                       nrtr_tps_pp_cfg)
    from tps_pp_tpu_torch.models.encoders.nrtr import sequence_mask
    from tps_pp_tpu_torch.ops import _lib, tps as tps_ops
    from tps_pp_tpu_torch.ops.decode_step import (cross_ffn_step,
                                                  cross_ffn_step_plain,
                                                  self_attn_step,
                                                  self_attn_step_plain)
    from tps_pp_tpu_torch.ops.encoder import (encoder_attention,
                                              encoder_attention_plain,
                                              encoder_forward,
                                              encoder_forward_plain)
    from tps_pp_tpu_torch.ops.gemm import gemm, gemm_plain
    from tps_pp_tpu_torch.ops.full_decode import (_dims, full_decode,
                                                  full_decode_plain,
                                                  graph_bytes)
    from tps_pp_tpu_torch.ops.stem import basic_block_cp, fused_stem_forward
    from tps_pp_tpu_torch.ops.tps_sampler import (
        PLAIN, tps_grid_sample_fused, tps_sampler, tps_sampler_plain,
        tps_sampler_plain_twostage, warp_twostage)

    # plain f32 products on the card stay f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    name = card()
    log(f'card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}')

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _lib.build()
    _lib.load()
    log(f'build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}')

    # ---- the flagship, bf16, seeded random weights -----------------------
    cfg = nrtr_tps_pp_cfg(dtype='bfloat16', decode_mode='auto')
    rec = build_recognizer(cfg)
    if rec.device.type != 'cuda':
        raise AssertionError(f'built on {rec.device}, not on the card')
    rec.init_weights(SEED)
    if rec.resolved_decode_mode() != 'fused40_bf16':
        raise AssertionError(f'auto resolved to {rec.resolved_decode_mode()}')
    model = rec.model
    bf, f32 = torch.bfloat16, torch.float32
    g = np.random.default_rng(SEED)
    kernels = []

    def record(name_, src, replaces, fn_k, fn_p, err, reps, moved,
               bf16_flops=0, f32_flops=0, fn_lib=None, calls=1,
               listed=True, label=None, graph=False, cold=None):
        """Time the kernel, its plain version and the library call (each
        ``fn`` makes ``calls`` calls) and note the bound of one call; the
        entry goes into the ``kernels`` line when ``listed``, the log line
        in any case (under ``label``, default the name). With ``graph``
        the kernel and the library call are timed as device time
        (``graph_ms``: calls too short for the host to keep up with), and
        ``cold``, a pair of lists of calls (the kernel's and the library
        call's, ``rotated`` over copies of the inputs that exceed the L2
        cache), adds their device time on cold inputs (``cold_ms``,
        ``library_cold_ms``; None where not read)."""
        bound_ms, bound_by = bound(moved, bf16_flops, f32_flops)
        timer = graph_ms if graph else (lambda fn: cuda_ms(fn, reps))
        k = dict(
            name=name_, route='cuda', source=src, replaces=replaces,
            launches=None, max_abs_err=err,
            ms=timer(fn_k) / calls,
            plain_ms=cuda_ms(fn_p, reps) / calls, bound_ms=bound_ms,
            bound_by=bound_by,
            library_ms=None if fn_lib is None else timer(fn_lib),
            cold_ms=None if cold is None else graph_ms(cold[0]),
            library_cold_ms=None if cold is None else graph_ms(cold[1]))
        if listed:
            kernels.append(k)
        lib = ('none' if k['library_ms'] is None
               else f'{k["library_ms"]:.4f} ms')
        cold_log = ('' if cold is None else
                    f'; cold: {k["cold_ms"]:.4f} ms kernel, '
                    f'{k["library_cold_ms"]:.4f} ms library')
        log(f'{label or name_}: max_abs_err {err:.4g}; {k["ms"]:.4f} ms '
            f'kernel, {k["plain_ms"]:.4f} ms plain, bound {bound_ms:.4f} ms '
            f'({bound_by}), library {lib}{cold_log} [{name}]')

    # ---- kernel 1: TPS++ grid + warp at (B, 32, 128, 64) -> (B, 16, 64, 64)
    tps = model.tpsnet
    inv, P_hat, P = tps.tps_matrices(dev)
    fid = tps_ops.build_C_cell_centers((2, 16))
    feat = torch.from_numpy(g.uniform(-1, 1, (B, 32, 128, 64)).astype(
        np.float32)).to(dev, bf)
    cp = torch.from_numpy((fid[None] + 0.03 * g.standard_normal(
        (B, 32, 2))).astype(np.float32)).to(dev)
    score = torch.from_numpy(np.tanh(g.standard_normal(
        (B, 1024, 32))).astype(np.float32)).to(dev)
    args = (feat, cp, score, inv, P_hat, P, (16, 64))
    out_k = tps_sampler(*args)
    out_p = tps_sampler_plain(*args)
    torch.cuda.synchronize()
    err = float((out_k.float() - out_p.float()).abs().max())
    if not err <= SAMPLER_ATOL:
        raise AssertionError(f'tps_sampler: max abs error {err} > '
                             f'{SAMPLER_ATOL}')
    n_ctrl = inv.shape[0]
    record('tps_sampler', 'tps_pp_tpu_torch/csrc/tps_sampler.cu',
           'tps_pp_tpu/ops/pallas_tps.py:248',
           lambda: tps_sampler(*args), lambda: tps_sampler_plain(*args),
           err, 20, nbytes(feat, cp, score, inv, P_hat, P, out_k),
           # T = inv @ [C'; 0], the modulated P' rows, 4 taps per channel
           f32_flops=B * (2 * n_ctrl * n_ctrl * 2 + 1024 * (
               2 * 32 + 2 * n_ctrl * 2) + 1024 * 64 * 8))

    # ---- kernel 2: the two-stage variant at the same shapes; the second
    # map (with_mp) of both variants ------------------------------------------
    out_k = tps_sampler(*args, variant='twostage')
    out_p = tps_sampler_plain_twostage(*args)
    torch.cuda.synchronize()
    err = float((out_k.float() - out_p.float()).abs().max())
    if not err <= SAMPLER_ATOL:
        raise AssertionError(f'tps_sampler twostage: max abs error {err} > '
                             f'{SAMPLER_ATOL}')
    # float32: the f32 grid's rounding parts the two versions, so each is
    # held against the same function with the grid in float64, the kernel
    # within twice the plain version's error (as kernel 1's float32 test)
    args32 = (feat.float(),) + args[1:]
    got32 = tps_sampler(*args32, variant='twostage')
    want32 = tps_sampler_plain_twostage(*args32)
    f64 = [a.double() for a in args32[:6]]
    exact = warp_twostage(f64[0], tps_ops.build_P_prime(*f64[1:])).reshape(
        got32.shape).float()
    torch.cuda.synchronize()
    err_k = float((got32 - exact).abs().max())
    err_p = float((want32 - exact).abs().max())
    if not err_k <= 2 * err_p:
        raise AssertionError(f'tps_sampler twostage float32: error {err_k} '
                             f'against the float64 grid, plain {err_p}')
    log(f'tps_sampler twostage float32: max abs error against the float64 '
        f'grid {err_k:.4g} kernel, {err_p:.4g} plain')
    del args32, got32, want32, f64, exact
    mp_img = torch.from_numpy(g.uniform(-1, 1, (B, 16, 64, 64)).astype(
        np.float32)).to(dev, bf)
    for variant in ('dense', 'twostage'):
        rect, mp = tps_grid_sample_fused(feat, mp_img, *args[1:],
                                         variant=variant)
        torch.cuda.synchronize()
        errs = [check_close(f'tps_grid_sample_fused {variant} {what}', got,
                            PLAIN[variant](m, *args[1:]), (SAMPLER_ATOL, 0))
                for what, got, m in (('rect', rect, feat), ('mp', mp, mp_img))]
        ms = cuda_ms(lambda v=variant: tps_grid_sample_fused(
            feat, mp_img, *args[1:], variant=v), 20)
        log(f'tps_grid_sample_fused with_mp, {variant}: max abs errors '
            f'{errs[0]:.4g} (rect), {errs[1]:.4g} (mp); {ms:.4f} ms, both '
            f'maps in one launch [{name}]')
    del rect, mp, mp_img
    record('tps_sampler_twostage', 'tps_pp_tpu_torch/csrc/tps_sampler.cu',
           'tps_pp_tpu/ops/pallas_tps.py:86',
           lambda: tps_sampler(*args, variant='twostage'),
           lambda: tps_sampler_plain_twostage(*args), err, 20,
           nbytes(feat, cp, score, inv, P_hat, P, out_k),
           f32_flops=B * (2 * n_ctrl * n_ctrl * 2 + 1024 * (
               2 * 32 + 2 * n_ctrl * 2) + 1024 * 64 * 8))

    # ---- kernels 11 and 12: the fused stem's convolutions ----------------
    conv_launches = stem_checks(dev, g, record)

    # ---- kernel 3: whole encoder at (B, 64, 512) --------------------------
    vr = torch.from_numpy(g.uniform(0.3, 1.0, B).astype(np.float32)).to(dev)
    mask = sequence_mask(vr, 64)
    x = torch.from_numpy(g.standard_normal((B, 64, 512)).astype(
        np.float32)).to(dev, bf)
    w_enc = model.encoder.folded_weights(bf)
    enc_k = encoder_forward(x, mask, w_enc, 8)
    enc_p = encoder_forward_plain(x, mask, w_enc, 8)
    torch.cuda.synchronize()
    d = (enc_k.float() - enc_p.float()).abs()
    err = float(d.max())
    if bool((d > ENCODER_ATOL + ENCODER_RTOL * enc_p.float().abs()).any()):
        raise AssertionError(f'encoder: max abs error {err} beyond atol '
                             f'{ENCODER_ATOL} rtol {ENCODER_RTOL}')
    Le, De, HDe = w_enc['wqkv'].shape[0], 512, w_enc['wfc'].shape[1]
    DIe = w_enc['w1'].shape[2]
    # the library yardstick: nn.TransformerEncoder with the same weights
    te = transformer_encoder_yardstick(model.encoder, bf)
    pad = mask <= 0

    def te_call():
        with torch.no_grad():
            return te(x, src_key_padding_mask=pad)

    err_te = float((te_call().float() - enc_p.float()).abs().max())
    # the encoder's four products and its attention on the products' matmul
    # (bf16) rate; the attention's score and weighted sum are bf16 products
    # too (tps_pp_tpu/ops/pallas_encoder.py:56-70 rounds their operands)
    record('encoder', 'tps_pp_tpu_torch/csrc/encoder.cu',
           'tps_pp_tpu/ops/pallas_encoder.py:178',
           lambda: encoder_forward(x, mask, w_enc, 8),
           lambda: encoder_forward_plain(x, mask, w_enc, 8), err, 5,
           nbytes(x, mask, enc_k, *w_enc.values()),
           bf16_flops=2 * B * 64 * Le * (De * 3 * HDe + HDe * De +
                                         2 * De * DIe) +
           4 * B * 8 * 64 * 64 * 64 * Le, fn_lib=te_call)
    feat_enc = x.reshape(B, 4, 16, De)

    def module_call():
        with torch.no_grad():
            return model.encoder(feat_enc, vr)

    ms_mod = cuda_ms(module_call, 5)
    log(f'encoder, module path (cuBLAS products, f32 attention): '
        f'{ms_mod:.4f} ms; nn.TransformerEncoder max abs difference from '
        f'the plain version {err_te:.4g} [{name}]')
    del te

    # ---- kernel 3's parts alone at its shapes: the GEMM with each
    # product's epilogue (and the whole decode's K/V projection), the
    # attention with a fully masked image ------------------------------------
    Me = B * 64
    y_e = torch.from_numpy(g.standard_normal((Me, De)).astype(
        np.float32)).to(dev, bf)
    x32_e = torch.from_numpy(g.standard_normal((Me, De)).astype(
        np.float32)).to(dev)
    wkv = model.decoder.packed_weights(bf)['wkv_enc']
    parts = (('QKV', y_e, w_enc['wqkv'][0], dict(bias=w_enc['bqkv'][0])),
             ('fc', y_e, w_enc['wfc'][0],
              dict(residual=x32_e, out_dtype=f32, ln=True)),
             ('W1', y_e, w_enc['w1'][0], dict(bias=w_enc['b1'][0],
                                                gelu=True)),
             ('W2', y_e[:, :DIe].contiguous(), w_enc['w2'][Le - 1],
              dict(bias=w_enc['b2'][Le - 1], residual=x32_e, out_dtype=f32,
                   ln=True, ln_s=w_enc['lnf_s'], ln_b=w_enc['lnf_b'])),
             ('decode K/V projection', y_e, wkv, {}))
    for what, a_, b_, kw in parts:
        got = gemm(a_, b_, **kw)
        want = gemm_plain(a_, b_, **kw)
        torch.cuda.synchronize()
        errs = [check_close(f'gemm {what}', gt, wt,
                            (1e-3, 1e-4) if gt.dtype == f32
                            else (2e-2, 2 ** -7))
                for gt, wt in zip(*((got, want) if kw.get('ln')
                                    else ((got,), (want,))))]
        ms_k = cuda_ms(lambda: gemm(a_, b_, **kw), 10)
        ms_t = cuda_ms(lambda: a_ @ b_, 10)
        Nn, Kk = b_.shape[1], b_.shape[0]
        bmin, by = bound(nbytes(a_, b_, got if not kw.get('ln') else got[0],
                                *(t for t in kw.values()
                                  if isinstance(t, torch.Tensor))),
                         2 * Me * Nn * Kk)
        log(f'gemm {what} ({Me} x {Nn} x {Kk}): max abs errors '
            f'{", ".join(f"{e:.4g}" for e in errs)}; {ms_k:.4f} ms kernel, '
            f'{ms_t:.4f} ms torch.matmul (product only), bound {bmin:.4f} '
            f'ms ({by}) [{name}]')
    qkv_e = torch.from_numpy(g.standard_normal((Me, 3 * HDe)).astype(
        np.float32)).to(dev, bf)
    mask_e = mask.clone()
    mask_e[1] = 0.0
    att_k = encoder_attention(qkv_e, mask_e, 8)
    err_a = check_close('encoder attention', att_k,
                        encoder_attention_plain(qkv_e, mask_e, 8),
                        (2e-2, 2 ** -7))
    ms_a = cuda_ms(lambda: encoder_attention(qkv_e, mask_e, 8), 10)
    bmin, by = bound(nbytes(qkv_e, mask_e, att_k), 4 * B * 8 * 64 ** 3)
    log(f'encoder attention (B={B}, one layer; image 1 fully masked): max '
        f'abs error {err_a:.4g}; {ms_a:.4f} ms kernel, bound {bmin:.4f} ms '
        f'({by}) [{name}]')
    del y_e, x32_e, qkv_e, att_k, got, want

    # ---- kernels 4 and 5: whole greedy decode, one captured CUDA graph, at
    # N=64 (listed) and at the serving batch, bf16 and int8 encoder K/V ----
    dec = model.decoder
    lc = rec.label_convertor
    w_dec = dec.packed_weights(bf)
    dd = _dims(w_dec, 8)
    for n_rows in (N_DECODE, B):
        out_enc = enc_p[:n_rows].contiguous()
        src_mask = mask[:n_rows].contiguous()
        for enc_dtype, kname in (('bfloat16', 'full_decode'),
                                 ('int8', 'full_decode_int8')):
            dargs = (out_enc, src_mask, w_dec, 8, lc.start_idx, lc.end_idx,
                     enc_dtype)
            captures = full_decode.captures
            pk = full_decode(*dargs)
            again = full_decode(*dargs)
            pp = full_decode_plain(*dargs)
            torch.cuda.synchronize()
            if full_decode.captures != captures + 1 or \
                    not torch.equal(pk, again):
                raise AssertionError(
                    f'{kname} N={n_rows}: {full_decode.captures - captures} '
                    f'captures in two calls, replay equal to the first call: '
                    f'{torch.equal(pk, again)}')
            err, ties, widest = check_decode(pk, pp, f'{kname} N={n_rows}')
            steps = full_decode.last_steps
            mm_ops, att_ops = decode_flops(dd, n_rows, steps, 64)
            # the encoder K/V that every step reads again, at the memory rate
            kv_ms = nbytes(out_enc) * 2 * dd['L'] * dd['HD'] // dd['D'] // (
                1 + (enc_dtype == 'int8')) / PEAK_BYTES * 1e3
            held = max(v for k, v in graph_bytes(w_dec).items()
                       if k[1] == n_rows and k[3] == (enc_dtype == 'int8'))
            log(f'{kname} N={n_rows}: {ties} of {n_rows} rows part at a '
                f'near-tie (top-2 gap at most {widest:.3g}); {steps} steps '
                f'run; replay equal to the first call; encoder K/V floor '
                f'{kv_ms:.4f} ms a step, {steps * kv_ms:.4f} ms a decode; '
                f'the captured decode holds {held / 2 ** 20:.1f} MiB')
            record(kname, 'tps_pp_tpu_torch/csrc/full_decode.cu',
                   'tps_pp_tpu/ops/pallas_full_decode.py:378',
                   lambda a=dargs: full_decode(*a),
                   lambda a=dargs: full_decode_plain(*a), err, 3,
                   nbytes(out_enc, src_mask, pk, *w_dec.values()),
                   bf16_flops=mm_ops, f32_flops=att_ops,
                   listed=n_rows == N_DECODE, label=f'{kname} N={n_rows}')
    decode_graph_checks(w_dec, enc_p[:N_DECODE].contiguous(),
                        mask[:N_DECODE].contiguous(), lc)

    # ---- kernels 6 and 7: one decode step of one layer at N=B ------------
    ws = {k: v[0] for k, v in dec.step_weights().items()}
    sa_w = (ws['wqkv'], ws['wfc1'], ws['ln1_s'], ws['ln1_b'])
    cf_w = tuple(ws[k] for k in ('wq2', 'wfc2', 'ln2_s', 'ln2_b', 'w1', 'b1',
                                 'w2', 'b2', 'ln3_s', 'ln3_b'))
    T = dec.max_seq_len + 1
    xs = torch.from_numpy(g.standard_normal((B, 512)).astype(
        np.float32)).to(dev, bf)
    ck0 = torch.from_numpy(g.standard_normal((B, 8, T, 64)).astype(
        np.float32)).to(dev, bf)
    cv0 = torch.from_numpy(g.standard_normal((B, 8, T, 64)).astype(
        np.float32)).to(dev, bf)
    with torch.inference_mode():
        ek, ev = (a.contiguous() for a in
                  dec.layer_stack[0].enc_attn.project_kv(enc_p))
    err6 = err7 = 0.0
    # bf16 at B, and the f32 variants at the small batch the f32 model
    # serves
    for dt, n in ((bf, B), (f32, B_SMALL)):
        xd, ckd, cvd, ekd, evd = (a[:n].to(dt).contiguous() for a in
                                  (xs, ck0, cv0, ek, ev))
        for t in (0, 1, 20, T - 2):
            ck, cv, ckp, cvp = (ckd.clone(), cvd.clone(), ckd.clone(),
                                cvd.clone())
            got, _, _ = self_attn_step(xd, ck, cv, t, *sa_w)
            want, _, _ = self_attn_step_plain(xd, ckp, cvp, t, *sa_w)
            torch.cuda.synchronize()
            err6 = max(err6, check_close(f'self_attn_step {dt} N={n} t={t}',
                                         got, want, (STEP_ATOL, STEP_RTOL)))
            for c, cp_, c0 in ((ck, ckp, ckd), (cv, cvp, cvd)):
                err6 = max(err6, check_close(
                    f'self_attn_step {dt} N={n} t={t} cache', c[:, :, t],
                    cp_[:, :, t], (STEP_ATOL, STEP_RTOL)))
                keep = torch.arange(T, device=dev) != t
                if not (torch.equal(c[:, :, keep], c0[:, :, keep]) and
                        torch.equal(cp_[:, :, keep], c0[:, :, keep])):
                    raise AssertionError(f'self_attn_step {dt} N={n} t={t}: '
                                         f'a cache slot other than t changed')
        got = cross_ffn_step(xd, ekd, evd, mask[:n].contiguous(), *cf_w)
        want = cross_ffn_step_plain(xd, ekd, evd, mask[:n].contiguous(),
                                    *cf_w)
        torch.cuda.synchronize()
        err7 = max(err7, check_close(f'cross_ffn_step {dt} N={n}', got, want,
                                     (STEP_ATOL, STEP_RTOL)))
    log(f'self_attn_step at t = 0, 1, 20, {T - 2} and cross_ffn_step '
        f'(bf16 B={B}, f32 B={B_SMALL}): max abs errors {err6:.4g}, '
        f'{err7:.4g}; caches equal outside slot t')
    # the device exit's skip flag: set, both give x and leave the caches
    # as they were, bit for bit with their plain versions; unset, within
    # the bounds
    for dt, n in ((bf, B), (f32, B_SMALL)):
        xd, ckd, cvd, ekd, evd = (a[:n].to(dt).contiguous() for a in
                                  (xs, ck0, cv0, ek, ev))
        md = mask[:n].contiguous()
        for flag in (True, False):
            sk = torch.tensor(flag, device=dev)
            ck, cv, ckp, cvp = (ckd.clone(), cvd.clone(), ckd.clone(),
                                cvd.clone())
            outs = (self_attn_step(xd, ck, cv, 20, *sa_w, sk)[0],
                    self_attn_step_plain(xd, ckp, cvp, 20, *sa_w, sk)[0],
                    cross_ffn_step(xd, ekd, evd, md, *cf_w, sk),
                    cross_ffn_step_plain(xd, ekd, evd, md, *cf_w, sk))
            torch.cuda.synchronize()
            what = f'skip {flag} {dt} N={n}'
            if flag:
                if not (all(torch.equal(o, xd) for o in outs) and
                        torch.equal(ck, ckd) and torch.equal(cv, cvd) and
                        torch.equal(ckp, ckd) and torch.equal(cvp, cvd)):
                    raise AssertionError(f'{what}: a skipped step is not x '
                                         f'with the caches untouched')
                continue
            check_close(f'self_attn_step {what}', outs[0], outs[1],
                        (STEP_ATOL, STEP_RTOL))
            check_close(f'self_attn_step {what} cache', ck[:, :, 20],
                        ckp[:, :, 20], (STEP_ATOL, STEP_RTOL))
            check_close(f'cross_ffn_step {what}', outs[2], outs[3],
                        (STEP_ATOL, STEP_RTOL))
    log(f'self_attn_step and cross_ffn_step with the skip flag (bf16 B={B}, '
        f'f32 B={B_SMALL}): set, x and the caches bit-equal to the plain '
        f'versions; unset, within the bounds')
    ck, cv = ck0.clone(), cv0.clone()
    S = dec.max_seq_len
    slot = nbytes(ck[:, :, 0])                  # one slot of K (or V)
    # device time (CUDA graph), as the step decode's launches are short
    record('self_attn_step', 'tps_pp_tpu_torch/csrc/decode_step.cu',
           'tps_pp_tpu/ops/pallas_decode.py:122',
           lambda: [self_attn_step(xs, ck, cv, t, *sa_w) for t in range(S)],
           lambda: [self_attn_step_plain(xs, ck, cv, t, *sa_w)
                    for t in range(S)], err6, 3,
           # the mean step of the 40: reads t slots, writes slot t
           nbytes(xs, xs, *sa_w) + 2 * slot * ((S - 1) / 2 + 1),
           bf16_flops=2 * B * (512 * 3 * 512 + 512 * 512),
           f32_flops=4 * B * 512 * (S + 1) / 2, calls=S, graph=True)
    record('cross_ffn_step', 'tps_pp_tpu_torch/csrc/decode_step.cu',
           'tps_pp_tpu/ops/pallas_decode.py:219',
           lambda: cross_ffn_step(xs, ek, ev, mask, *cf_w),
           lambda: cross_ffn_step_plain(xs, ek, ev, mask, *cf_w), err7, 20,
           nbytes(xs, ek, ev, mask, xs, *cf_w),
           bf16_flops=2 * B * (2 * 512 * 512 + 2 * 512 * 256),
           f32_flops=4 * B * 512 * 64, graph=True)
    # a skipped step: the flag set, device time
    sk = torch.tensor(True, device=dev)
    ms6 = graph_ms(lambda: self_attn_step(xs, ck, cv, 20, *sa_w, sk))
    ms7 = graph_ms(lambda: cross_ffn_step(xs, ek, ev, mask, *cf_w, sk))
    log(f'skipped step (flag set) B={B}, device time: self_attn_step '
        f'{ms6:.4f} ms, cross_ffn_step {ms7:.4f} ms [{name}]')
    del ck, cv, ck0, cv0, ek, ev

    # ---- kernels 8-10: the training warp at B_TRAIN, bf16 and f32 --------
    warp_args = warp_checks(dev, g, record, name)

    # ---- the serving paths through the user's entry point ----------------
    h, w, c = FLAGSHIP_INPUT
    img = torch.from_numpy(g.standard_normal((B, h, w, c)).astype(
        np.float32)).to(dev, bf)
    small = {5: [1.0, 0.55, 0.8, 0.3, 0.95],
             B_SMALL: [1.0, 0.55, 0.8, 0.3, 0.95, 0.6, 0.45, 1.0]}
    rec_fs = build_recognizer(dict(cfg, decoder=dict(
        cfg['decoder'], use_fused_step=True)))
    rec_fs.model.load_state_dict(rec.model.state_dict())
    rec_fs.decode_mode = 'steps'
    widths = steps_tie_widths(rec_fs, img)
    tie_steps = max(NEAR_TIE, TIE_MULT * widths['module'][1])
    log(f'steps near-ties at B={B} (rows that part, widest top-2 gap): '
        f'module decode, kernel vs plain sampler {widths["module"]}; fused '
        f'step, kernels vs plain on one encoding {widths["kernels"]}; fused '
        f'step path vs plain path {widths["path"]}; near-tie of the '
        f'fused-step path {tie_steps:.4g}')
    for k in ('kernels', 'path'):
        if not widths[k][1] < tie_steps:
            raise AssertionError(f'steps {k}: parts at a top-2 gap of '
                                 f'{widths[k][1]:.4g} >= {tie_steps:.4g}')
    sw = stem_tie_widths(rec, img)
    tie_stem = max(NEAR_TIE, TIE_MULT * sw['module'][1])
    log(f'fused stem near-ties at B={B} (rows that part, widest top-2 gap): '
        f'module stem vs the fused stem, both plain {sw["module"]}; fused '
        f'stem kernels vs plain, the rest on kernels {sw["kernel"]}; '
        f'fused-stem path vs plain path {sw["path"]}; near-tie of the '
        f'fused-stem path {tie_stem:.4g}')
    for k in ('kernel', 'path'):
        if not sw[k][1] < tie_stem:
            raise AssertionError(f'fused stem {k}: parts at a top-2 gap of '
                                 f'{sw[k][1]:.4g} >= {tie_stem:.4g}')
    # path: (recognizer, decode mode, stem mode, sampler variant, small
    # batch, near-tie of the argmax rule, {kernel: its count})
    paths = {
        'fused40_bf16': (rec, 'fused40_bf16', 'xla', 'dense', 5, NEAR_TIE, {
            'tps_sampler': lambda: tps_sampler.launches,
            'encoder': lambda: encoder_forward.launches,
            'full_decode': lambda: full_decode.launches}),
        'fused40': (rec, 'fused40', 'xla', 'dense', 5, NEAR_TIE, {
            'tps_sampler': lambda: tps_sampler.launches,
            'encoder': lambda: encoder_forward.launches,
            'full_decode_int8': lambda: full_decode.launches_int8}),
        'steps, use_fused_step': (
            rec_fs, 'steps', 'xla', 'dense', B_SMALL, tie_steps, {
                'tps_sampler': lambda: tps_sampler.launches,
                'self_attn_step': lambda: self_attn_step.launches,
                'cross_ffn_step': lambda: cross_ffn_step.launches}),
        'fused40_bf16, fused stem': (
            rec, 'fused40_bf16', 'fused', 'dense', 5, tie_stem, {
                'basic_block_cp': lambda: basic_block_cp.launches,
                'tps_sampler': lambda: tps_sampler.launches,
                'encoder': lambda: encoder_forward.launches,
                'full_decode': lambda: full_decode.launches}),
        'fused40_bf16, two-stage sampler': (
            rec, 'fused40_bf16', 'xla', 'twostage', 5, NEAR_TIE, {
                'tps_sampler_twostage':
                    lambda: tps_sampler.launches_twostage,
                'encoder': lambda: encoder_forward.launches,
                'full_decode': lambda: full_decode.launches}),
    }
    wrappers = (tps_sampler, encoder_forward, full_decode, self_attn_step,
                cross_ffn_step, basic_block_cp)
    S, NC = rec.max_seq_len, lc.num_classes() - 1

    def serve(r, mode, stem_mode='xla', variant='dense', plain=False):
        """``r`` on decode ``mode``, ``stem_mode`` and the sampler
        ``variant`` (``TPS_SAMPLER_VARIANT``, which the flagship's
        ``sample_mode='pallas'`` reads), the kernels or, with ``plain``,
        their plain versions."""
        r.decode_mode, r.stem_mode, r.plain = mode, stem_mode, plain
        os.environ['TPS_SAMPLER_VARIANT'] = variant
        return r

    path_launches = {}
    for pname, (r, mode, stem_mode, variant, n_small, near_tie,
                counts) in paths.items():
        serve(r, mode, stem_mode, variant)
        im_s, vr_s = img[:n_small].contiguous(), small[n_small]
        for fn in wrappers:
            fn.launches = 0
        full_decode.launches_int8 = tps_sampler.launches_twostage = 0
        res = r.simple_test(img)
        res_s = r.simple_test(im_s, vr_s)
        torch.cuda.synchronize()
        got = {k: f() for k, f in counts.items()}
        log(f'{pname}: launches {got}')
        if min(got.values()) < 1:
            raise AssertionError(f'{pname}: a kernel of the path did not '
                                 f'launch: {got}')
        # the fused stem: 7 blocks a predict (layer1's 3, layer2's 4), two
        # predicts; the two-stage sampler replaces the dense one
        if stem_mode == 'fused' and got['basic_block_cp'] != 7 * 2:
            raise AssertionError(f'{pname}: {got["basic_block_cp"]} block '
                                 f'launches in two predicts, not 14')
        if variant == 'twostage' and tps_sampler.launches:
            raise AssertionError(f'{pname}: the dense sampler launched '
                                 f'{tps_sampler.launches} times')
        if mode.startswith('fused40'):
            # the whole decode of a batch is a replay of its bucket's graph
            captures = full_decode.captures
            r.predict(img)
            torch.cuda.synchronize()
            if full_decode.captures != captures:
                raise AssertionError(f'{pname}: a second batch of {B} '
                                     f'captured its decode again')
        for k, n in got.items():
            path_launches.setdefault(k, n)
        for rr in res + res_s:
            if not isinstance(rr['text'], str) or not np.all(
                    np.isfinite(rr['score'])):
                raise AssertionError(f'{pname}: bad result {rr}')
        if len(res) != B or len(res_s) != n_small:
            raise AssertionError(f'{pname}: wrong number of results')
        log(f'{pname}: {len(res)} + {len(res_s)} results; first texts '
            f'{[rr["text"] for rr in res[:3]]}')
        # argmax of the kernel path against the plain path on both batches
        for what, (im, v) in ((f'B={B}', (img, None)),
                              (f'B={n_small}', (im_s, vr_s))):
            pk = r.predict(im, v)
            r.plain = True
            pp = r.predict(im, v)
            r.plain = False
            if tuple(pk.shape) != (im.shape[0], S, NC) or not bool(
                    torch.isfinite(pk).all()):
                raise AssertionError(f'{pname} {what}: bad output '
                                     f'{tuple(pk.shape)}')
            err, ties, widest = check_decode(pk, pp, f'{pname} {what}',
                                             near_tie)
            same = int((pk.argmax(-1) == pp.argmax(-1)).all(-1).sum())
            log(f'{pname} {what}: argmax equal to the plain path on {same} '
                f'of {im.shape[0]} rows, {ties} part at a near-tie (top-2 '
                f'gap at most {widest:.3g} < {near_tie}); max abs err '
                f'{err:.4g}; step 0 max abs err '
                f'{float((pk[:, 0] - pp[:, 0]).abs().max()):.4g}')
    serve(rec, 'fused40_bf16')

    # ---- a float32 model serves through `steps`, at the small batch: the
    # f32 variants of the sampler, of the step kernels and of the stem's
    # blocks -------------------------------------------------------------
    im_s, vr_s = img[:B_SMALL].contiguous(), small[B_SMALL]
    for fused, stem_mode in ((False, 'xla'), (True, 'xla'),
                             (False, 'fused')):
        cfg32 = nrtr_tps_pp_cfg(decode_mode='steps')
        cfg32['decoder'] = dict(cfg32['decoder'], use_fused_step=fused)
        r32 = build_recognizer(dict(cfg32, stem_mode=stem_mode))
        r32.model.load_state_dict(rec.model.state_dict())
        what = (f'float32 steps{", use_fused_step" if fused else ""}'
                f'{", fused stem" if stem_mode == "fused" else ""}')
        for fn in wrappers:
            fn.launches = 0
        pk = r32.predict(im_s, vr_s)
        torch.cuda.synchronize()
        got = {fn.__name__: fn.launches for fn in wrappers}
        if r32.dtype != f32 or got['tps_sampler'] < 1 or fused != (
                min(got['self_attn_step'], got['cross_ffn_step']) > 0) or \
                got['basic_block_cp'] != 7 * (stem_mode == 'fused'):
            raise AssertionError(f'{what}: launches {got}')
        r32.plain = True
        pp = r32.predict(im_s, vr_s)
        if tuple(pk.shape) != (B_SMALL, S, NC) or not bool(
                torch.isfinite(pk).all()):
            raise AssertionError(f'{what}: bad output {tuple(pk.shape)}')
        err, ties, widest = check_decode(pk, pp, what)
        log(f'{what} B={B_SMALL}: launches {got}; {ties} rows part from the '
            f'plain path at a near-tie (top-2 gap at most {widest:.3g} < '
            f'{NEAR_TIE}); max abs err {err:.4g}')
        del r32

    # ---- beam search on the card --------------------------------------------
    beam_phase(rec, img, name)

    # ---- warm throughput at B=512, the paths in turns ---------------------
    # (recognizer, decode mode, stem mode, sampler variant, plain)
    timed = {'fused40_bf16': (rec, 'fused40_bf16', 'xla', 'dense', False),
             'fused40': (rec, 'fused40', 'xla', 'dense', False),
             'steps, use_fused_step': (rec_fs, 'steps', 'xla', 'dense',
                                       False),
             'fused40_bf16, fused stem': (rec, 'fused40_bf16', 'fused',
                                          'dense', False),
             'fused40_bf16, two-stage sampler': (rec, 'fused40_bf16', 'xla',
                                                 'twostage', False),
             'fused40_bf16, plain': (rec, 'fused40_bf16', 'xla', 'dense',
                                     True)}
    times = {k: [] for k in timed}
    for _ in range(2):
        for k, (r, *setting) in timed.items():
            serve(r, *setting)
            r.predict(img)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                r.predict(img)
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) / 3)
    for k, ts in times.items():
        log(f'slice B={B} {k}: {B / min(ts):.1f} images/s '
            f'({min(ts) * 1e3:.2f} ms/batch, best of 2 rounds of 3) '
            f'[{name}]')
    serve(rec, 'fused40_bf16')
    serve(rec_fs, 'steps')
    rec_fs.predict(img[:B_SMALL])
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        rec_fs.predict(img[:B_SMALL])
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    log(f'slice B={B_SMALL} steps, use_fused_step: {min(ts) * 1e3:.2f} '
        f'ms/batch (best of 5) [{name}]')
    # the module stem against the fused stem (stem + layer1 + layer2), in
    # turns, CUDA events
    stems = {'module': lambda: model.backbone.stem_and_head(img),
             'fused': lambda: fused_stem_forward(model.backbone, img, bf)}
    with torch.inference_mode():
        for k in ('module', 'fused', 'fused', 'module'):
            log(f'stem B={B}, {k}: {cuda_ms(stems[k], 5):.3f} ms (stem + '
                f'layer1 + layer2) [{name}]')
    serve(rec, 'auto')
    os.environ.pop('TPS_SAMPLER_VARIANT')

    # ---- the inference API: init_recognizer, model_inference,
    # eval_recognizer and the bench twin -------------------------------------
    del rec_fs
    inference_api_phase(rec, name)
    del rec, model

    # ---- the training slice ------------------------------------------------
    launches = train_slice(dev, g, name, warp_args)
    path_launches.update(launches)

    # ---- the training API: train_recognizer, checkpoints, resume ---------
    train_api_phase(name)

    # ---- the ABINet + TPS++ family: kernel 1 serving, kernels 8-9 training
    abinet_phase(dev, name)

    # ---- the CTC family's CRNN-TPS: kernels 8-10 at one channel
    path_launches.update(crnn_tps_phase(dev, name, record))

    # ---- the ResNet31 attention family: SAR and RobustScanner, no kernel
    sar_phase(dev, name)

    # ---- the transformer family on its other trunks: kernels 3 and 4-5
    path_launches.update(transformer_phase(dev, name, record))

    # ---- SegOCR (no kernel); MORAN and SPIN in front of CRNN and ABINet
    path_launches.update(seg_preproc_phase(dev, name, record))

    # ---- text detection: DBNet R18 and R50-DCNv2, MMOCR.readtext; no kernel
    det_phase(dev, name)

    # ---- detection training; PANet-R18 and PSENet-R50; no kernel
    det_train_phase(dev, name)

    # ---- FCENet and TextSnake: serving, training, readtext; no kernel
    fce_textsnake_phase(dev, name)

    # ---- DRRG: serving, the GCN, training, readtext; no kernel
    drrg_phase(dev, name)

    # ---- Mask R-CNN: serving, the card against the CPU, training, readtext
    maskrcnn_phase(dev, name)

    # ---- KIE and NER: SDMGR, the UNet16, BERT-base, their CLIs, readtext
    kie_ner_phase(dev, name)

    # ---- deployment: export, CUDA-graph capture, the server
    deploy_phase(dev, name)

    # ---- the mesh: predict and eval_recognizer split over cards
    t_mesh = time.perf_counter()
    mesh_phase(dev, name)
    log(f'mesh phase: {time.perf_counter() - t_mesh:.1f} s')
    path_launches['conv3x3_cp'] = conv_launches
    for k in kernels:
        k['launches'] = path_launches.get(k['name'])
    if any(not k['launches'] for k in kernels):
        raise AssertionError(f'a kernel was not launched: {kernels}')

    for k in kernels:
        k['max_abs_err'] = float(k['max_abs_err'])
    log(f'chip_smoke: {time.perf_counter() - t_script:.1f} s in all, the '
        f'kernels\' build included')
    print(json.dumps({'kernels': kernels}), flush=True)
    print(name, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
