#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (fsvlm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; each passes or raises, and any failure exits non-zero:

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them.
2. build: compile every hand-written kernel from the repo's sources
   (one nvcc per source, all started together) and print the build time.
3. kernels: hold each kernel against its plain PyTorch version on the card,
   in fp32 and bf16, at the shapes the main paths give it and at edges of L:
   the forward (O and LSE, max-abs tolerances below) and the two backward
   kernels (dQ, dK, dV: max abs error over the largest abs value of the plain
   version's three); the d = 64 kernels #6-#8, then the blockwise kernels
   #3-#5 at head dims 32, 64, 128 and 80 (zero-padded to 128).  Then time
   kernels, plain versions and the one PyTorch library call that computes the
   same function (a yardstick only), with each kernel's bound.  Then the
   whole-sequence kernels #1-#2 at head dims 32, 64, 80 and 128, L from 1 to
   1024, B*H not a multiple of 4, and CoOp's and CoCoOp's own shapes.  The
   forwards #6, #3 and #1 and the backwards #7/#8 and #4/#5 are checked at
   the edges of the bf16 kernels' tiles and short-L packing (L 15-17, 31-33,
   63-65; #7/#8 also 127-129), and timed by CUDA events as above and, beside
   them, by the device time alone (torch.profiler), which at small shapes
   leaves out the host's launch time (#2 too; #7/#8 also at the text shapes
   (100, 8, 16) and (100, 8, 24) causal; #3-#5 at head dims 32, 64 and 128).
   Phase 2 prints the registers and spills of every bf16 tensor-core kernel
   (#1-#2, the flash forward behind #3 and #6, #7/#8 and #4/#5).
4. serving: PromptSRC ViT-B/16 at full width (random weights from seed 0,
   bf16 frozen towers, bf16 compute, 100 classes): text features once, then
   3 batches of 100 uint8 224x224 images, through the kernel and again with
   the plain attention; text features, image features, logits (absolutely
   and against their spread between classes) and top-1 must agree.  Kernel
   launch counts are zeroed just before the kernel run and read just after
   it: every kernel of the path must have launched.
5. profile: device time by kernel (torch.profiler) over one serving batch
   and one text pass, and the wall time of repeated text passes.
6. train: the PromptSRC ViT-B/16 train step at full width (the recipe's
   prompt and optimizer settings, bf16, batch 48, 100 classes, a uint8
   cache of 288 224x224 images, DEVICE_AUG, the per-step frozen teacher):
   6 steps over 2 epochs of 3 (warmup LR, then the cosine's first LR; GPA
   at both epoch ends and the final swap-in), through the kernels and again
   with the plain attention on the same weights, batches, boxes and flips.
   The first step's prompt gradients (in fp32, and in bf16 against their
   rounding noise), the per-step losses and the prompts' total change must
   agree (limits below), and each kernel must launch its expected count per
   step.  Then step time, images/s, peak memory, one step checked to make
   no synchronizing call; then TRAIN.EPOCH_FUSE: 2 epochs fused (a warm-up
   step, the captured step, its replays) against 2 step by step from one
   state, bit-equal (prompts, momentum, step count, generator, every step's
   metrics), the fused run under torch.profiler: the wrappers' counts those
   of the warm-up and the captured step alone (a replay calls no wrapper),
   the trace's #6-#8 kernel events at the derived counts per step times the
   steps, one cudaGraphLaunch per replay; a replay loop under sync
   debug mode 'error'; epochs timed fused, step by step as train() runs
   them unfused and synced after every step, in turns, with images/s, the
   capture's ms, peak memory each way and model TFLOP/s from
   ``utils/flops.py`` (its own JSON line ``{"fused_epoch": ...}``); and one
   profiled step.  The harness that times single steps sets EPOCH_FUSE
   "off" (a fused epoch never calls ``train_step_resident``); the CLI
   phases on a resident cache (9-12) run with "auto", so fused, and count
   the wrappers' calls over the steps that are not replays
   (``engine/fused.py``'s STEPS).
7. IVLP train: the IVLP ViT-B/16 KD train step (the _kd recipe: CE plus KD
   from the zero-shot CLIP teacher, whose image pass runs on every batch)
   under FSVLM_FORCE_PALLAS=1, so that every attention takes the blockwise
   kernels #3-#5 and none the d = 64 ones.  The recipe's KD_ALPHA 1.0 gives
   the KD term weight 0, so the teacher's logits on one batch, and the loss
   at KD_ALPHA 0.5, are first held to the plain path's.  Then phase 6's run
   and agreement rules on the same cache (6 steps over 2 epochs of 3,
   kernels against plain attention), then 2 steps with mixup on, the same
   perm and lam handed to
   both; step time, images/s, peak memory, one step checked to make no
   synchronizing call (and one with the trainer's own mixup draws), an
   epoch of mixup steps on the trainer's own draws fused against step by
   step (phase 6's rule, bit-equal, #3-#5 counted from its trace), and one profiled
   step.  The variable is set for the phase and restored after it;
   phases 4-6 run with it unset, on the d = 64 kernels.
8. CoOp and CoCoOp: under FSVLM_FORCE_PALLAS=legacy, so that every
   attention takes the whole-sequence kernels #1-#2 (phase 3 holds them to
   their plain versions at d 32/64/80/128, ten lengths and the steps' own
   shapes).  CoOp from configs/trainers/CoOp/vit_b16_ep50.yaml (16 ctx,
   batch 32; the image tower without gradient): phase 6's run and agreement
   rules, one step checked to make no synchronizing call, one profiled
   step, then test() on 200 cache images through both paths (text features
   once; |dlogit| at most 0.1, and the kernel path's distance to an fp32
   plain evaluation at most 4x the plain bf16 path's; top-1 agreement past
   twice the largest |dlogit|); then an epoch fused against step by step
   (phase 6's rule, #1-#2 counted from its trace), and one of CoOp under
   LOSS_TYPE focal.  CoCoOp from configs/trainers/CoCoOp/vit_b16_c4_ep10_batch1.yaml
   (4 ctx, batch 1: 100 text sequences per step): the same run and rules;
   then 2 steps at batch 48 with TRAIN.REMAT, past BATCHED_TEXT_LIMIT, so
   class blocks of 85 (2 blocks, one padded) with every block and text
   layer rematerialized, against the plain path, with its peak memory;
   there the trainer vetoes EPOCH_FUSE "auto" (as the JAX package's), and
   "on" overrides it: an epoch fused against step by step, bit-equal.

9. cli: ``fsvlm_tpu_torch.train.main``, the port's CLI, on the card with
   FSVLM_FORCE_PALLAS unset (the d = 64 kernels #6-#8): PromptSRC from
   configs/trainers/PromptSRC/vit_b16_c2_ep20_batch4_4+4ctx.yaml on
   configs/datasets/synthetic.yaml at ViT-B/16 (phase 4's bf16 towers,
   random from seed 0), bf16, ``--seed 1``, the imbalanced protocol
   (PER_CLASS_SHOTS [16, 16, 16, 8, 8, 4, 2, 1], WeightedClassSampler),
   DEVICE_AUG, CACHED_TEACHER, best-val selection, a checkpoint every
   epoch, 2 epochs.  The log contract (log.txt, which parse_test_res.py
   parses; the checkpoint pointer, model.pkl-1/-2, model-best.pkl), the
   launches of #6-#8 (the teacher cache pass, steps without a teacher pass,
   the val and test passes: counts derived from the code; the epochs
   fused, so the wrappers' calls over the steps that are not replays), the
   teacher
   cache against a plain-attention cache (cosine), a rerun that resumes
   from a copy whose pointer names model.pkl-1 (start epoch, prompts,
   momentum, step count, generator and GPA accumulator restored exactly;
   epoch 2 trained, fused, under FSVLM_PROFILE_DIR: its Chrome trace holds
   #6-#8 at the derived counts for every step of epoch 2 and its val pass,
   and one cudaGraphLaunch per replay) and ``--eval-only --load-epoch 2`` (the epoch-2
   model's test predictions exactly) must hold.  The CLI's own output goes
   to its log files, not to this script's.  Then the teacher cache build
   time, the epoch time and images/s, and phase 6's PromptSRC step at batch
   48 with and without CACHED_TEACHER, in turns: step ms synced, launches,
   device busy, peak memory.

10. CLIP-path trainers, with FSVLM_FORCE_PALLAS unset (the d = 64
   kernels #6-#8): the CLIP-LoRA ViT-B/16 train step from
   configs/trainers/LoRA/vit_b16_ep10_batch32.yaml (batch 32, q/k/v factors
   at r 2, alpha 1 on all 12 + 12 layers, DROPOUT_RATE 0.25, both towers
   rematerialized, bf16) on phase 6's cache: the first-step gradients on a
   random nonzero B (at the init B = 0 and A's gradient is 0), 6 steps
   against the plain attention on the same weights, boxes, flips and
   dropout masks (phase 6's rules), #6 48 and #7/#8 24 launches per step, no
   synchronizing call, step time, images/s, peak memory, an epoch with
   the trainer's own dropout draws fused against step by step (bit-equal,
   counted from its trace) and a profiled step.  Then MaPLe from configs/trainers/MaPLe/vit_b16_c2_ep5_batch4_2ctx.yaml
   at batch 48 (vision L = 199, no remat: 24 launches each), the same way;
   LinearProbeCLIP (batch 32, #6 only), the same way; ZeroshotCLIP and ZeroshotCLIP2
   test() on 200 cache images against the plain path (phase 8's eval
   rules); and ``--trainer LoRA`` through the CLI on Synthetic for 2
   epochs (lora/best.pkl and last.pkl, derived launches, ``--eval-only``
   reproducing the predictions).

11. PLIP and the ModifiedResNet towers, with FSVLM_FORCE_PALLAS unset.
   PLIP ViT-B/16 from configs/trainers/PLIP/vit_b16_c4_ep10_batch4.yaml on
   phase 4's towers (4 ctx "a photo of a", REG_TYPE grad, REG_COEFF 0.01,
   K 1, bf16, batch 48, the recipe's 4): the gradient penalty
   differentiates the text tower twice, so the text tower takes the
   reference attention (no kernel) and the image tower #6 only (12 per
   step, #7/#8 none).  Phase 6's first-step gradient rules, the penalty's
   own gradient in fp32 against a central difference, 6 steps against the
   plain attention (losses and penalties), no synchronizing call, step
   time and a profiled step, then test() on 200 images under phase 8's
   eval rules, and an epoch fused against step by step.  Then one step
   each of REG_TYPE svd and spectral_norm (the text tower on #6-#8:
   24/12/12 per step), each with an epoch fused against step by step.  Then CoOp from
   configs/trainers/CoOp/rn50.yaml (16 ctx, batch 32, bf16) on an RN50
   tower (random weights from seed 0, every BN perturbed so that the
   residual branches speak): phase 6's run and rules with #6-#8 12 each per
   step from the text tower and none from the RN tower (cuDNN convs and a
   plain attention pool), test() under phase 8's rules, and ZeroshotCLIP's
   test() on the same tower; the RN50 tower in fp32 (TF32 off) against the
   frozen reference activations of tests/golden_pack/rn50_full_shape.npz
   at its replay's tolerances; and ``--trainer PLIP`` through the CLI on
   Synthetic with phase 9's data settings for 2 epochs, then
   ``--eval-only`` reproducing its predictions.

12. recognition, with FSVLM_FORCE_PALLAS unset (the d = 64 kernels #6-#8):
   the port's JPEG decoder (fsvlm_tpu_torch/csrc/jpeg_decoder.cpp, built by
   g++; this machine's libjpeg header and library, which it does not use,
   are reported) on the committed fixtures of tests/torch_fixtures/jpeg:
   the full decode, ``decode_file`` at 256, the loader's cache view and the
   eval view, each byte-equal to the digests of expected.json (made from
   Pillow and the JAX package's libjpeg build).  Then PromptSRC ViT-B/16
   through the CLI (``--root``, configs/datasets/caltech101.yaml, phase 9's
   recipe and bf16 towers) on a temporary Caltech101-layout tree of 100
   class folders (hard links to the fixtures, split_zhou_Caltech101.json of
   Caltech101's sizes: 4100 / 1650 / 2465) under Setting A's shape at half
   of tail 4's shots (PER_CLASS_SHOTS 50 x 8 then 50 x 2: 500 train images,
   300 val; 50 x 16 then 50 x 4 until phase 20 came in),
   WeightedClassSampler, DEVICE_AUG, CACHED_TEACHER, best-val, 1 epoch (the
   recipe's 20, cut): the log contract with the base/new report, finite
   losses, #6-#8 launched exactly the counts derived from the code, and
   ``--eval-only`` from model-best.pkl giving the run's final test
   predictions.  Then the decode rates at DATALOADER.NUM_WORKERS threads,
   the train cache's materialize, the run's own epoch as train() ran it (its
   device cache build included; no separate timed epoch runs, to make room
   for phase 18), a cached test(), the cold
   ``--eval-only`` time, the eval cache's bytes and the peak RSS, printed as
   one ``{"recognition": ...}`` line.

13. host_aug, with FSVLM_FORCE_PALLAS unset (the d = 64 kernels #6-#8): the
   host train transforms (fsvlm_tpu_torch/data/transforms.py,
   autoaugment.py, imageops.py over csrc/imaging.cpp, built by g++) on the
   committed JPEG fixtures for every pipeline of
   tests/torch_fixtures/transforms/expected.json (the recipes' list at
   bicubic and bilinear, SimCLR's six, colorjitter, the three AutoAugment
   policies, the three RandAugment variants with cutout, random_translation,
   random_crop, center_crop, NO_TRANSFORM, gaussian_noise, instance_norm) at
   its seeds, against the digests of the JAX package's Pillow outputs:
   byte-equal, gaussian_noise and instance_norm within 1e-6.  Then phase
   12's PromptSRC command on a fresh tree without DATALOADER.DEVICE_AUG
   True (the scripts' default: the host pipeline, uint8 views normalized
   in the step): the log contract, finite losses, #6-#8 exactly as derived
   (phase 12's counts: only the augmentation moved), ``--eval-only``
   exact.  Then CoOp with LOSS_TYPE simclr through the CLI
   (scripts/coop/train.sh's options with SUB=all, configs/trainers/CoOp/
   vit_b16_ep50.yaml, batch 32, 1 epoch): the override line, "img2" in
   every step's batch and unlike "img", finite NT-Xent losses, #6-#8 as
   derived (two text passes and two frozen vision passes per step), the
   ValueError under DEVICE_AUG, and its step time.  Then PromptSRC with
   SIMCLR_ALPHA 0.1 on the two-view loader at batch 48: 3 steps, the first
   under sync debug mode 'error', launches as derived.  Then views/s of
   the recipes' and SimCLR's lists at NUM_WORKERS threads over the 500
   train files, the run's host-aug epoch (files decoded on first use; no
   separate warm epoch runs) beside phase 12's DEVICE_AUG epoch, the
   ms per step of LOADER_STEPS (10) steps fed from batches built beforehand
   against as many fed by the loader as it runs (in turns: the loader's own
   share), and the
   device's idle share over 5 profiled host-aug steps in the loader's
   steady state, printed as one ``{"host_aug": ...}`` line.

14. int8_tools: W8A8 int8 (fsvlm_tpu_torch/ops/quant.py; the product is
   ``torch._int_mm``, cuBLASLt, no TPU kernel) and the tools.  The product
   at the ViT-B/16 tower's four GEMM shapes (M = 100 x 197; (K, N) =
   (768, 2304), (768, 768), (768, 3072), (3072, 768)), bf16, dynamic and
   static: q8, scale, the int8 activations and the int32 accumulators
   byte-equal to the same function on the CPU, the output within one bf16
   ulp of the CPU's; timed by CUDA events beside the bf16 ``x @ w``, the bare
   ``torch._int_mm`` on the stored column-major q8 and on a row-major copy,
   and the activation quantization alone, with its bound (bytes, or int8
   operations at 1,979 TOP/s).  Then, with FSVLM_FORCE_PALLAS unset,
   ZeroshotCLIP ViT-B/16 test() on phase 8's 200 images under MODEL.QUANT_INT8
   (attn + mlp dynamic, mlp only, and QUANT_INT8_STATIC calibrated over the
   cache in 4 batches) against the bf16 tower on the same weights: image
   features' cosine >= 0.99 (dynamic) / 0.985 (static), top-1 agreement
   (random weights: reported), #6 24 per 200 images (and 12 per calibration
   batch), the int8 products (``ops.quant.LAUNCHES``) 48 per batch of 100
   (24 for mlp only), and in one profiled batch the int8 GEMM kernels by
   name (those a lone torch._int_mm launches, and those holding "gemm_s8";
   their count is reported: late in a long run the profiler can drop a
   kernel record), ms per batch of 100 in turns and the GEMM weight bytes.  PromptSRC INT8_TEACHER at phase 6's settings, dynamic
   and static (scales from 4 augmented batches: the trainer refuses static
   scales under DEVICE_AUG, which is checked), in turns with the bf16
   teacher on the same cache and draws: the teacher's features on one batch
   (cosine as above), finite losses and their gap to the bf16 teacher's,
   train() fused, so #6-#8 as phase 6 derived and 48 int8 products per
   step over the steps that are not replays (the int8 GEMM kernels shown by
   name in one profiled step), no host sync, an epoch of the dynamic
   teacher fused against step by step (phase 6's rule), step ms, busy,
   idle and peak memory.  IVLP KD INT8_TEACHER under
   FSVLM_FORCE_PALLAS=1 at KD_ALPHA 0.5: 3 steps with #3-#5 as phase 7
   derived, an epoch fused against step by step, the teacher's features (cosine >= 0.99) and its logits' gap to
   the bf16 teacher's beside phase 7's rule (reported: that rule holds a
   kernel to its plain version, not int8 to bf16).  Then on phase 12's tree
   and model: ``python -m fsvlm_tpu_torch.tools.predict`` over 100 test
   files (one row each, top-1 equal to phase 12's ``--eval-only``
   predictions on the same files), again under MODEL.QUANT_INT8, and the
   images/s of predict() in this process for both; export_torch_checkpoint,
   ``python -m fsvlm_tpu_torch.tools.import_torch_prompts``, ``--eval-only``
   (predictions exact); ``python -m fsvlm_tpu_torch.tools.interpret_prompt``
   (top-4 words for every context vector).  One ``{"int8": ...}`` line, and
   the whole script's wall time.

15. lpclip_export, with FSVLM_FORCE_PALLAS unset (#6 alone): ``python -m
   fsvlm_tpu_torch.tools.lpclip``'s main in this process on phase 12's tree
   (configs/datasets/caltech101.yaml, ViT-B/16 in fp32, random from seed 1,
   8 shots, the tool's default 16 cut for the call's time: 800 train, 400
   val, 2465 test images): the three npz files,
   #6 launched 12 times per extracted batch and nothing else, extraction
   images/s per split, the L-BFGS fit's ms per C and the search's seconds
   (tools/logreg.py, scipy over torch on the card), the val features
   against the plain attention's (min cosine >= 0.999), and every fit of
   the search that converged on the card (n_iter < max_iter) again on this
   machine's CPU over the npz files, in three one-thread processes beside the
   rest of the phase, and once more on the samples permuted: the card's
   solution within twice the CPU's own spread (or 1e-5) of the CPU's in
   the float64 objective; the printed lines and val predictions
   reported (the tree's 17 images under 100 labels tie the optimum's
   class scores).  #6 in fp32 at the extraction's shape (32, 12, 197, 64) timed
   beside its plain version and SDPA, with its bound.  Then
   ``fsvlm_tpu_torch.tools.export_serving`` at ViT-B/16, 100 classes,
   batch 96 (the tool's defaults; its command line for fp32, then bf16 and
   int8 dynamic and static): the exported graph holds 12
   ``fsvlm.flash_attn_fwd_d64`` nodes and no other attention (no SDPA,
   softmax or other fsvlm operator), an int8 weight keeps its column-major
   layout and a row-major one is refused; the loaded program equals the
   live function in this process; beside those checks (every artifact is
   written first), a fresh process that imports torch, numpy and the port
   alone loads each artifact with ``load_serving`` and runs it on the same
   seeded images: top-1 equal to the live function's, logits within 1e-5
   (fp32) or 1e-3 (bf16, int8) relative, byte equality reported, and #6
   launched exactly 12 times per call (``LAUNCHES`` counts in the
   operator's body).  Once that process has ended, the ms per batch of the
   live function and the loaded program (median of EXPORT_TURNS (3) in
   turns).  One ``{"lpclip_export": ...}`` line.

16. drivers, with FSVLM_FORCE_PALLAS unset (the d = 64 kernels #6-#8), on
   phase 12's tree: ``python -m fsvlm_tpu_torch.run_script
   scripts/imbalance/run_setting_a.sh PromptSRC caltech101 1
   vit_b16_c2_ep20_batch4_4+4ctx 50 50 ce <tree>`` (the unchanged driver,
   its ``python train.py`` routed to the port's CLI on the card) with
   TAIL_SWEEP=1 (850 train images), OUT_ROOT and FSVLM_PROFILE_DIR in a
   temporary directory, cut only through FSVLM_EXTRA_OPTS (1 epoch, batch
   96: 8 steps; random weights; bf16 towers; the recipe's host
   augmentation, so no resident cache and no fused epoch), the per-step
   teacher: the
   runner's exit 0 and exactly one
   routed call, the driver's directory contract
   (setting_a/caltech101/PromptSRC/<cfg>/ce/tail1/seed1/ with log.txt and
   VLPromptLearner/model.pkl-1), the end signal and ``* accuracy:`` in
   log.txt, one Chrome trace in FSVLM_PROFILE_DIR whose kernel events count
   #6-#8 at exactly the derived numbers for its window (before_train to the
   start of after_train: the 8 steps, 36 / 24 / 24 each; no
   cudaGraphLaunch), and
   parse_test_res.py through the shim's pass-through naming the run's
   accuracy.  Then adam, amsgrad, adamw, rmsprop and radam on phase 6's
   PromptSRC step (batch 48): one step of the trainer under sync debug mode
   'error', 3 steps whose parameters and moment buffers match the same
   optimizer on the card's host CPU fed the same gradients (max |card - cpu|
   at most 1e-6 of each tensor's largest magnitude), and a non-finite
   gradient that leaves parameters, buffers and counts unchanged.  Then
   lpclip's ``search_logreg`` on the card on seeded class-separated
   features (100 classes, 16 train and 4 val rows each, 512 wide) against
   the same search in a one-thread CPU process started at the phase's
   start: the same printed lines and best C.  One ``{"drivers": ...}``
   line.

17. zoo_data, with FSVLM_FORCE_PALLAS unset (the d = 64 kernels #6-#8): the
   Dassl datasets and the port's PNG decoder.  (a) Whether the machine has
   zlib's header and library (the decoder uses neither); the committed PNG
   fixtures (tests/torch_fixtures/png) decoded in full, as the cache view
   at 256 and as the eval view at 224, each against expected.json's
   sha256 (Pillow's decode and the JAX package's views), the truncated one
   raising.  (b) A PACS-layout tree at PACS's published sizes (7 classes;
   art_painting 2048, cartoon 2344, photo 1670 as hard links to the JPEG
   fixtures, sketch 3929 to the PNG sketch fixtures, its
   dog/n02103406_4068-1.png a truncated PNG listed in the train split;
   kfold splits at 9:1, 1-based labels), then PromptSRC leave-one-domain-out
   through ``fsvlm_tpu_torch.train.main``: configs/datasets/zoo/pacs.yaml,
   the PromptSRC recipe, art_painting + cartoon + photo -> sketch, seed 1,
   phase 4's ViT-B/16 towers, bf16, the host transforms (DEVICE_AUG off),
   the per-step teacher, cut to 1 epoch at batch 48: the decode rates over
   the sketch files at 8 threads, the split sizes and the summary's counts
   (the truncated file skipped), #6-#8 at the counts derived from the code,
   ``--eval-only`` reproducing the predictions (its wall time a cold eval
   of the sketch PNGs), the run's epoch ms and images/s (no separate
   epoch runs), peak memory.  (c) A
   DEVICE_AUG DataManager with sketch among the sources: the materialized
   train cache's sketch rows each equal to their fixture's cache256 digest.
   (d) An SSL CIFAR-10 tree at CIFAR-10's sizes (50,000 + 10,000 hard
   links to a 32x32 PNG fixture) through configs/datasets/zoo/ssl_cifar10.yaml
   at SEED 1: the split counts, each split's digest equal to the JAX
   package's (SSL_JAX_DIGESTS), and SSL_U_BATCHES (10) batches of the train_u loader at the
   FixMatch recipe's loader settings (views/s, labels equal to the
   dataset's at each batch's indices).  One ``{"zoo_data": ...}`` line.

18. zoo_dg: the Dassl DG zoo (fsvlm_tpu_torch/trainers/zoo/, no attention:
   every launch count stays 0) on phase 17's PACS tree, which main keeps
   for it.  (a) Vanilla from configs/trainers/zoo/vanilla_mixstyle_pacs.yaml
   (resnet18_ms_l12, 224x224, batch 64, SGD 0.001, cosine, the host's
   random_resized_crop + flip + colorjitter + normalize) through
   ``fsvlm_tpu_torch.train.main``, art_painting + cartoon + photo ->
   sketch, seed 1, default PRETRAINED (the "no weights found" warning is
   checked), cut to 1 epoch (85 steps) with TEST.NO_TEST (the CLI's own
   test after training is the one test): the log contract, finite
   losses, the epoch ms and images/s as train() ran it, ``--eval-only``
   from the checkpoint giving the same 3928 predictions (its wall time a
   cold eval), a resume that restores weights, BN statistics, optimizer
   state and generator bit for bit, one step's MixStyle draws taken twice
   from one generator state (bit-equal, on the card, advancing the
   generator as the step left to itself does), one step under sync debug
   mode 'error', the idle share of 3 loader-fed steps and peak memory.
   (b) CrossGrad, DDAIG (fcn_3x32_gctx and fcn_3x64_gctx_stn), DomainMix
   (crossdomain and random) and DAELDG (RandomDomainSampler over the 3
   domains) on resnet18 at 224x224, ZOO_B_BATCH images, ZOO_B_STEPS steps
   on the card and on the card's CPU from the same weights, batches and
   recorded draws, TF32 off, each step from the card's state: per step
   the losses, weights (apart: those that start at zero) and BN
   statistics within ZOO_B_BOUND (the STN generator's case:
   ZOO_B_BOUND_STN).  One ``{"zoo_dg": ...}`` line.

19. zoo_da: the Dassl DA zoo (trainers/zoo/da.py, no attention: every
   launch count stays 0) on its own Office-31-layout tree (office31/
   {amazon,webcam,dslr}/<the 31 classes>/ at the published domain sizes
   2817 / 795 / 498, hard links to the JPEG fixtures).  (a) DANN from
   configs/trainers/zoo/dann_resnet18.yaml with
   configs/datasets/zoo/office31.yaml (resnet18, 224x224, batch 32, SGD
   0.002, cosine, the host's random_flip + random_translation + normalize,
   COUNT_ITER smaller_one: 795 // 32 = 24 steps) through
   ``fsvlm_tpu_torch.train.main``, amazon -> webcam, seed 1, default
   PRETRAINED (the warning is checked), cut to 1 epoch: the log contract,
   finite losses, ``--eval-only`` giving the same 795 predictions, a resume
   that restores both groups' weights and optimizer states, the net's and
   the critic's BN statistics and the generator bit for bit, one step under
   sync debug mode 'error', the epoch ms and images/s as train() ran it,
   the idle share of 3 loader-fed steps, peak memory.  (b) SourceOnly
   through the CLI (1 epoch), then ADDA and AdaBN from its checkpoint
   through MODEL.INIT_WEIGHTS (1 epoch each): ADDA's classifier unchanged
   and its backbone moved, AdaBN's weights unchanged and its statistics
   re-estimated; the three webcam accuracies.  (c) Each of the ten DA
   trainers on SyntheticDA (3 source domains) on cnn_digit5_m3sda at 32x32
   (ZOO_C_CASES), ZOO_C_STEPS steps card vs CPU as phase 18's (b), at
   ZOO_C_BOUND (its reason beside it), and one more card step under sync
   debug mode 'error'.  (d)
   Each new backbone (alexnet, vgg16, preact_resnet18, efficientnet_b0-b7)
   train forward and backward card vs CPU (ZOO_D_CASES), within ZOO_D_BOUND.
   One ``{"zoo_da": ...}`` line.

20. zoo_ssl: the Dassl SSL zoo (trainers/zoo/ssl.py, no attention: every
   launch count stays 0) on phase 17's SSL CIFAR-10 tree, which main keeps
   for it, and data-parallel training at world size 1 (parallel/mesh.py).
   (a) FixMatch from configs/trainers/zoo/fixmatch_cifar10.yaml with
   configs/datasets/zoo/ssl_cifar10.yaml (wide_resnet_28_2, 32x32, 64
   labeled + 448 unlabeled a step, each with a weak and a strong view from
   the host's transforms, SGD 0.03, COUNT_ITER train_u) through
   ``fsvlm_tpu_torch.train.main``, seed 1, default PRETRAINED (the warning
   is checked), cut to 1 epoch of ZOO_SSL_STEPS steps (its reason beside
   it): the log contract (the pseudo-label metrics among the losses), finite
   losses, ``--eval-only`` giving the same 10,000 predictions (its wall
   time a cold eval), a resume that restores weights, BN statistics,
   optimizer and generator bit for bit, one step under sync debug mode
   'error', the epoch ms and images/s as train() ran it, step busy ms and
   the idle share of 3 loader-fed steps, peak memory.  (b) SupBaseline,
   EntMin, MeanTeacher, MixMatch (K = 2) and FixMatch on SyntheticDA on
   wide_resnet_28_2 at 32x32 (ZOO_E_CASES), ZOO_E_STEPS steps card vs CPU
   as phase 18's (b), MeanTeacher's teacher and its statistics among the
   compared tensors, within ZOO_E_BOUND (its reason beside it), one more
   card step of each under sync debug mode 'error'; MeanTeacher's
   checkpoint resumed into a new trainer bit-equal (weights, statistics,
   teacher, optimizer, generator); wide_resnet_28_2's (in float64) and
   wide_resnet_16_4's train forward and backward card vs CPU within
   ZOO_D_BOUND.  (c) FixMatch's two steps and its eval (logits gathered
   over the ranks) under a NCCL process group of world size 1, bit-equal
   to the same run without one (and that run to itself), cuDNN
   deterministic.  One ``{"zoo_ssl": ...}`` line.

21. ranks: the CLIP trainers across ranks (parallel/mesh.py).  (a)
   PromptSRC ViT-B/16 (phase 6's settings: batch 48, bf16, 100 classes,
   DEVICE_AUG on phase 6's cache, per-step teacher) 2 epochs of 3 steps, and
   IVLP with mixup and KD (KD_ALPHA 0.5) under FSVLM_FORCE_PALLAS=1 (#3-#5)
   1 epoch, each step by step and fused, each run from a new trainer,
   without a process group and under a NCCL one of world size 1 (the
   captured step then holds the gradients' and the metrics' all-reduces):
   the four runs bit-equal (metrics, prompts, optimizer, generator, mixup
   rng, GPA), the wrappers' calls, the fused runs' kernel events per
   group in their profiler traces (36 / 24 / 24 a step) and one
   ``cudaGraphLaunch`` per replay, the replay loop under NCCL without a
   sync.  (b) Beside (a), three processes of this script (``--ranks-worker``):
   PromptSRC ViT-B/16 in fp32 with TF32 off at the global batch 48 as two
   gloo ranks on cuda:0 (24 + 24; NCCL refuses two ranks on one card)
   against one process at 48, RANKS_B_STEPS steps on the same batches
   with host-given boxes and flips, step by step (EPOCH_FUSE off: a gloo
   collective cannot be captured), then test() on RANKS_B_TEST images:
   within RANKS_DLOSS and RANKS_DPARAM, the same predictions, #6-#8 at
   their per-step counts on each rank.  Then the cost of LoRA's
   image-tower dropout masks drawn at the global shape (LORA_MASK_RANKS
   ranks, batch LORA_MASK_BATCH) against the local one.  One
   ``{"ranks": ...}`` line.

Phases 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 17 and 21 zero the launch counts
just before each main path and read them just after, and phase 16 counts
the driver's from its profiler trace (the run is another process): each
kernel of the path must have launched its expected count (derived from the
code: a rematerialized layer runs its forward kernel again), and the other
families none; phases 18, 19 and 20 launch none of them.  A count is a
wrapper's calls (``LAUNCHES``); a fused epoch's CUDA graph replays the
captured step's kernels without calling a wrapper, so its replays are
counted apart (``engine/fused.py``'s STEPS) and its kernels from a
profiler trace: each ``_fused_vs_eager`` run, and phase 9's resumed CLI
run (FSVLM_PROFILE_DIR).  The line
``chip_smoke: seconds by phase {...}`` gives each phase function's time.

The line before the last is ``{"kernels": [...]}`` (one row per TPU kernel;
#2's row lists its three CUDA kernels as ``parts``; ``launches`` the
wrappers' calls on the fused main path (phase 6's PromptSRC epochs for
#6-#8, phase 7's IVLP mixup epoch for #3-#5, phase 8's CoOp epoch for #1
and #2), ``launches_traced`` that run's kernel events in its trace (#2's:
its three kernels') and ``graph_replays`` its replays; #6-#8's and #3-#5's
rows their launches on each path that runs them, ``launches_by_path``); the
last line is ``{"ok": true, "device": {...}}``, and the script exits 0.
"""

import contextlib
import io
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Hopper H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

TOL = {"float32": {"o": 1e-4, "lse": 1e-4}, "bfloat16": {"o": 2e-2, "lse": 1e-2}}
# backward: max abs error of dQ, dK, dV over the largest abs value of the plain
# version's three (bf16: an output ulp is 2^-8 relative)
TOL_BWD = {"float32": 1e-5, "bfloat16": 1e-2}
BWD_SHAPES = [  # (B, H, L, causal): the train step's vision and text shapes, edges of L
    (48, 12, 201, False), (100, 8, 16, True), (100, 8, 24, True),
    (32, 12, 197, False), (48, 12, 199, False),  # the LoRA and MaPLe steps' vision
    (3, 2, 1, False), (4, 8, 8, True), (4, 8, 24, True), (2, 8, 77, True),
    (2, 4, 513, True), (2, 4, 1024, True),
    # the bf16 kernels' edges (a whole (b*h) per warp at L <= 16 and <= 32, then
    # CTAs of 64 or 128 own rows over 64-row tiles), B*H = 6, causal and unmasked
    *((2, 3, L, causal) for L in (15, 17, 31, 33, 63, 65, 127, 129) for causal in (True, False)),
]
BWD_TIMED = {"vision": (48, 12, 201, False), "text": (100, 8, 16, True),
             "text24": (100, 8, 24, True)}
KERNEL_SHAPES = [  # (B, H, L, causal): vision, text at its truncated lengths, edges of L
    (100, 12, 201, False),
    (32, 12, 197, False), (48, 12, 199, False), (100, 12, 197, False),  # LoRA, MaPLe, zero-shot
    (100, 8, 8, True), (100, 8, 16, True), (100, 8, 24, True), (100, 8, 77, True),
    (2, 4, 513, True), (3, 2, 1, False), (2, 4, 1024, True),
    # the bf16 forward's edges (a whole (b*h) per warp at L <= 16 and <= 32, 64-row
    # CTAs and 64-key tiles past 32), B*H = 6; then B*H not a multiple of 4
    (2, 3, 15, True), (2, 3, 16, False), (2, 3, 17, True), (2, 3, 31, False), (2, 3, 32, True),
    (2, 3, 33, False), (2, 3, 63, True), (2, 3, 64, False), (2, 3, 65, True),
    (3, 1, 16, True), (5, 1, 24, True), (3, 3, 33, False),
]
N_CLASSES, N_BATCHES, BATCH = 100, 3, 100
# main-path agreement, kernel against plain attention: cosine of the image and
# of the text features; the largest logit difference, absolutely and as a
# share of the image's logit spread between classes (std over the classes)
MIN_COSINE, MAX_DLOGIT, MAX_DLOGIT_OVER_SPREAD = 0.999, 0.1, 0.25
# train path, kernels against plain attention: per-step |dloss| <= DLOSS * (1 + |loss|);
# cosine of each prompt tensor's first-step gradient in fp32, and of its total
# change; in bf16, each first-step gradient's distance (1 - cosine) to the fp32
# plain gradient at most BF16_NOISE_RATIO times the plain bf16 path's
TRAIN_BATCH, TRAIN_CACHE, TRAIN_EPOCHS, TRAIN_STEPS_PER_EPOCH = 48, 288, 2, 3
DLOSS, MIN_GRAD_COSINE, MIN_DELTA_COSINE, BF16_NOISE_RATIO = 1e-2, 0.999, 0.99, 4.0
N_EPOCH_PAIRS = 3  # epochs timed fused, unfused and synced after every step, in turns
# blockwise kernels #3-#5: head dims (80 is zero-padded to the 128 instantiation),
# lengths (the IVLP step's text 16 and vision 201, edges of L), and the timed
# shapes: the train vision shape and two of the same D * H at other head dims
BW_DIMS = (32, 64, 128, 80)
BW_LENGTHS = (1, 8, 15, 16, 17, 31, 32, 33, 63, 64, 65, 77, 201, 300, 513)
BW_PATH_SHAPES = [  # (B, H, L, causal) at d = 64: the IVLP step's student vision,
    # KD-teacher vision (no prompts), student text and the build's teacher text
    (48, 12, 201, False), (48, 12, 197, False), (100, 8, 16, True), (100, 8, 77, True),
]
BW_TIMED = {"vision": (48, 12, 201, 64, False), "vision_d32": (48, 24, 201, 32, False),
            "vision_d128": (48, 6, 201, 128, False), "text": (100, 8, 16, 64, True)}
N_MIX_STEPS = 2  # IVLP steps with mixup on, after the 6 without
# whole-sequence kernels #1-#2: head dims (80 runs the 128 instantiation),
# lengths (the text 16 and 24, vision 197 and 201, edges of L: the bf16
# kernels pack a whole (b*h) per warp at L <= 16 and <= 32, and walk 64-row
# tiles past 32), the CoOp and CoCoOp steps' own shapes at d = 64 (their
# vision pass without prompts; text at CoOp's 16 ctx, at CoCoOp's batch 1
# and one class block of its chunked batch-48 step: 48 x 85 prompts), B*H
# not a multiple of the 4 heads of a packed CTA, and the timed shapes
FUSED_DIMS = (32, 64, 80, 128)
FUSED_LENGTHS = (1, 8, 15, 16, 17, 24, 31, 32, 33, 63, 64, 65, 77, 197, 201, 300, 513, 1024)
FUSED_PATH_SHAPES = [  # (B, H, L, causal) at d = 64
    (32, 12, 197, False), (100, 8, 24, True), (100, 8, 16, True), (48, 12, 197, False),
    (4080, 8, 16, True),
]
FUSED_RAGGED = [(3, 1, 16, True), (5, 1, 24, True), (3, 3, 33, False)]  # (B, H, L, causal), each d
FUSED_TIMED = {"vision": (32, 12, 197, False), "text": (100, 8, 24, True),
               "cocoop_block": (4080, 8, 16, True)}


def log(msg):
    print(msg, flush=True)


PHASE_S = {}  # seconds of each phase function, printed at the end
CARD = []  # nvidia-smi's name and power limit, for the lines that print a time


def _timed(fn):
    def run(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            PHASE_S[fn.__name__] = round(time.perf_counter() - t0, 1)

    run.__name__, run.__doc__ = fn.__name__, fn.__doc__
    return run


class force_pallas:
    """FSVLM_FORCE_PALLAS set to ``value`` (None: unset) inside the block, and
    restored after it."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self.saved = os.environ.get("FSVLM_FORCE_PALLAS")
        self._set(self.value)

    def __exit__(self, *exc):
        self._set(self.saved)

    @staticmethod
    def _set(value):
        if value is None:
            os.environ.pop("FSVLM_FORCE_PALLAS", None)
        else:
            os.environ["FSVLM_FORCE_PALLAS"] = value


def _others_silent(launches, family_prefix, where):
    """Fail if a kernel outside ``family_prefix`` launched on this path."""
    stray = {k: n for k, n in launches.items() if n and not k.startswith(family_prefix)}
    if stray:
        raise SystemExit(f"FAIL: {where} launched kernels of the other family: {stray}")


@_timed
def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is False; this smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    log(smi[0])
    CARD[:] = [smi[0]]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi[0]


@_timed
def phase_build():
    from fsvlm_tpu_torch.ops.kernels.build import build_all

    t0 = time.perf_counter()
    tc = {}  # the bf16 tensor-core kernels: "library:name<D[,R]>" -> [registers, spill bytes]
    for name, info in build_all().items():
        log(f"build {name}: nvcc {info['seconds']:.1f} s")
        # ptxas prints, per kernel instantiation, "Compiling entry function
        # '<mangled name>'", then its spills, then its registers
        entry, short = "", None
        for ln in info["log"].splitlines():
            if "Compiling entry function" in ln:
                mangled = ln.split("'")[1]
                entry = mangled.split("_cu_")[-1][:60] if "_cu_" in mangled else mangled[:60]
                # template arguments: Li<int>E, Lb<0|1>E (bool)
                m = re.search(r"((?:flash|fwd|stats|dkv|dq)_(?:tiled|packed))_kernelI"
                              r"((?:L[ib]\d+E)+)E", mangled)
                short = m and f"{name}:{m[1]}<" + ",".join(
                    v if t == "i" else ("false", "true")[int(v)]
                    for t, v in re.findall(r"L([ib])(\d+)E", m[2])) + ">"
            elif "registers" in ln or "spill" in ln:
                log(f"build   {entry}: {ln.split(':', 1)[-1].strip()}")
                if short:
                    got = tc.setdefault(short, [0, 0])
                    if "registers" in ln:
                        got[0] = int(re.search(r"Used (\d+) registers", ln)[1])
                    else:
                        got[1] = int(re.search(r"(\d+) bytes spill stores", ln)[1])
    log("build: bf16 tensor-core kernels (#1-#2; #3 and #6: flash_*; #7/#8: flash_attn_bwd; "
        "#4/#5: blockwise_attn_bwd), registers/spill bytes: "
        + ", ".join(f"{k} {r}/{sp}" for k, (r, sp) in sorted(tc.items())))
    log(f"build: {time.perf_counter() - t0:.1f} s in all")


def _qkv(B, H, L, dtype, gen, d=64):
    """q, k, v as the strided (B, H, L, d) views that the port's mha makes."""
    import torch

    qkv = torch.randn((B, L, 3 * H * d), generator=gen, device="cuda").to(dtype)
    return [t.view(B, L, H, d).transpose(1, 2) for t in qkv.split(H * d, dim=-1)]


def _time_ms(fn, iters=20):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters=20):
    """Device time of one call of ``fn``: the kernels' own device time
    (torch.profiler) over ``iters`` calls, over ``iters``; None when the
    profiler recorded no device time.  Unlike ``_time_ms`` it leaves out the
    host time between launches, which at small shapes exceeds the kernels'
    own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return us / 1e3 / iters if us > 0 else None


def _ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


def _bound(B, H, L, causal, dtype_name, elsize, d=64, lse=True):
    """Least time of one forward: q, k, v read, O (and LSE) written, the mask
    read when there is one; 4 operations per (query, key) pair and head dim
    this data needs."""
    pairs = L * (L + 1) // 2 if causal else L * L  # score entries this data needs
    nbytes = (4 * B * H * L * d * elsize + (B * H * L * 4 if lse else 0)
              + (L * L * 4 if causal else 0))
    flops = 4 * B * H * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bound_bwd(B, H, L, causal, elsize, n_out, flops_per_pair, d=64, stats=True):
    """Least time of one backward kernel at bf16 peak: q, k, v, dO read, LSE
    and delta read (``stats``), ``n_out`` gradients written, the mask read
    when there is one; ``flops_per_pair`` operations per (query, key) pair
    and head dim this data needs."""
    pairs = L * (L + 1) // 2 if causal else L * L
    nbytes = ((4 + n_out) * B * H * L * d * elsize + (2 * B * H * L * 4 if stats else 0)
              + (L * L * 4 if causal else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops_per_pair * B * H * pairs * d / PEAK_FLOPS["bfloat16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _blhd_grad(B, H, L, dtype, gen, d=64):
    """dO as it reaches the attention from mha's merge of the heads: a
    (B, H, L, d) view of (B, L, H, d) memory."""
    import torch

    return torch.randn((B, L, H, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)


def _library_bwd_ms(q, k, v, do, causal, timer=_time_ms):
    """Time (by ``timer``) of the one PyTorch call that computes dQ, dK and
    dV for these inputs, aten's flash-attention backward (after its own
    forward, untimed); None where it does not take them."""
    import torch

    aten = torch.ops.aten
    try:
        o, lse, cq, ck, mq, mk, seed, off = aten._scaled_dot_product_flash_attention(
            q, k, v, 0.0, causal, False)[:8]
        return timer(lambda: aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, o, lse, cq, ck, mq, mk, 0.0, causal, seed, off))
    except (RuntimeError, TypeError) as e:
        log(f"library: the flash backward does not take these inputs ({str(e).splitlines()[0]})")
        return None


@_timed
def phase_kernels_bwd():
    """The dK/dV and dQ kernels against the plain backward; then times."""
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.ops.attention import causal_mask

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {fa.KERNEL_DKV: [0.0, 0.0], fa.KERNEL_DQ: [0.0, 0.0]}  # [abs, relative]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for B, H, L, causal in BWD_SHAPES:
            q, k, v = _qkv(B, H, L, dtype, gen)
            do = _blhd_grad(B, H, L, dtype, gen)
            mask = causal_mask(L, device="cuda") if causal else None
            o, lse = fa._kernel_fwd(q, k, v, mask)
            dq, dk, dv = fa._kernel_bwd(q, k, v, o, lse, do, mask)
            ref = fa.reference_attention_bwd(q, k, v, o, lse, do, mask)
            torch.cuda.synchronize()
            scale = max(r.float().abs().max().item() for r in ref)
            errs = [(g.float() - r.float()).abs().max().item() for g, r in zip((dq, dk, dv), ref)]
            rel = [e / scale for e in errs]
            ok = all(np.isfinite(e) and r <= TOL_BWD[name] for e, r in zip(errs, rel))
            log(f"kernel flash_attn_bwd {name} B={B} H={H} L={L} "
                f"{'causal' if causal else 'nomask'}: max|err|/max|ref| dQ {rel[0]:.3e} "
                f"dK {rel[1]:.3e} dV {rel[2]:.3e} (max|ref| {scale:.3e}, tol {TOL_BWD[name]:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"FAIL: the backward kernels disagree with their plain version "
                                 f"({name}, B={B} H={H} L={L})")
            for kern, idx in ((fa.KERNEL_DKV, (1, 2)), (fa.KERNEL_DQ, (0,))):
                worst[kern][0] = max(worst[kern][0], *(errs[i] for i in idx))
                worst[kern][1] = max(worst[kern][1], *(rel[i] for i in idx))
            del q, k, v, do, o, lse, dq, dk, dv, ref

    timings = {}
    for label, (B, H, L, causal) in BWD_TIMED.items():
        q, k, v = _qkv(B, H, L, torch.bfloat16, gen)
        do = _blhd_grad(B, H, L, torch.bfloat16, gen)
        mask = causal_mask(L, device="cuda") if causal else None
        o, lse = fa._kernel_fwd(q, k, v, mask)
        delta = fa.attention_delta(o, do)
        args = (q, k, v, do, lse, delta, mask)
        dkv = lambda: fa._launch_dkv(*args)  # noqa: E731
        dq = lambda: fa._launch_dq(*args)  # noqa: E731
        bwd = lambda: fa._kernel_bwd(q, k, v, o, lse, do, mask)  # noqa: E731
        dkv_ms, dq_ms, bwd_ms = _time_ms(dkv), _time_ms(dq), _time_ms(bwd)
        plain_ms = _time_ms(lambda: fa.reference_attention_bwd(q, k, v, o, lse, do, mask))
        lib_ms = _library_bwd_ms(q, k, v, do, causal)
        # device time alone (profiler): each kernel, the whole backward (the
        # delta pre-pass and both kernels) and aten's
        dev = {"dkv": _device_ms(dkv), "dq": _device_ms(dq), "bwd": _device_ms(bwd),
               "aten": _library_bwd_ms(q, k, v, do, causal, timer=_device_ms)}
        b_dkv = _bound_bwd(B, H, L, causal, 2, 2, 8)
        b_dq = _bound_bwd(B, H, L, causal, 2, 1, 6)
        timings[label] = {
            fa.KERNEL_DKV: dict(ms=dkv_ms, plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=b_dkv[0], bound_by=b_dkv[1], device_ms=dev["dkv"],
                                library_device_ms=dev["aten"]),
            fa.KERNEL_DQ: dict(ms=dq_ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=b_dq[0], bound_by=b_dq[1], device_ms=dev["dq"],
                               library_device_ms=dev["aten"]),
        }
        log(f"time flash_attn_bwd bf16 {label} ({B},{H},{L},64) "
            f"{'causal' if causal else 'nomask'}: dK/dV kernel {dkv_ms:.4f} ms (bound "
            f"{b_dkv[0]:.4f} ms, {b_dkv[1]}), dQ kernel {dq_ms:.4f} ms (bound {b_dq[0]:.4f} ms, "
            f"{b_dq[1]}), whole backward with the delta pre-pass {bwd_ms:.4f} ms; "
            f"plain backward {plain_ms:.4f} ms; aten._scaled_dot_product_flash_attention_backward "
            f"{_ms(lib_ms)}")
        log(f"time flash_attn_bwd bf16 {label}: device time (profiler): dK/dV kernel "
            f"{_ms(dev['dkv'])}, dQ kernel {_ms(dev['dq'])}, whole backward with the delta "
            f"pre-pass {_ms(dev['bwd'])}, aten backward {_ms(dev['aten'])}")
        del q, k, v, do, o, lse, delta, args
    for kern, (a, r) in worst.items():
        log(f"kernel {kern}: worst max|err| {a:.3e}, worst max|err|/max|ref| {r:.3e}")
    return {k: v[0] for k, v in worst.items()}, timings


@_timed
def phase_kernels_blockwise():
    """The blockwise kernels #3-#5 against their plain versions at every
    head dim and edge of L, causal and unmasked, and at the IVLP step's own
    shapes (BW_PATH_SHAPES), fp32 and bf16; then times at BW_TIMED in bf16,
    with bounds, plain and library times."""
    import torch
    import torch.nn.functional as F

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.ops.attention import causal_mask

    gen = torch.Generator(device="cuda").manual_seed(2)
    kernels = (fa.BW_KERNEL, fa.BW_KERNEL_DKV, fa.BW_KERNEL_DQ)
    worst = {(k, n): [0.0, 0.0] for k in kernels for n in ("float32", "bfloat16")}
    edges = [((4, 4) if L <= 201 else (2, 2)) + (L, d, causal)
             for d in BW_DIMS for L in BW_LENGTHS for causal in (True, False)]
    path = [(B, H, L, 64, causal) for B, H, L, causal in BW_PATH_SHAPES]
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for B, H, L, d, causal in edges + path:
            q, k, v = _qkv(B, H, L, dtype, gen, d)
            do = _blhd_grad(B, H, L, dtype, gen, d)
            mask = causal_mask(L, device="cuda") if causal else None
            o, lse = fa._blockwise_attn_fwd_op(q, k, v, mask)
            grads = fa._bw_kernel_bwd(q, k, v, o, lse, do, mask)
            o_ref, lse_ref = fa.reference_blockwise_fwd(q, k, v, mask)
            ref = fa.reference_blockwise_bwd(q, k, v, o, lse, do, mask)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_l = (lse - lse_ref).abs().max().item()
            scale = max(r.float().abs().max().item() for r in ref)
            errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(grads, ref)]
            rel = [e / scale for e in errs]
            ok = (all(np.isfinite(e) for e in (err_o, err_l, *errs))
                  and err_o <= TOL[name]["o"] and err_l <= TOL[name]["lse"]
                  and max(rel) <= TOL_BWD[name])
            n_cases += 1
            if not ok or L in (16, 201) or (B, H, L, d, causal) in path:
                log(f"kernel blockwise {name} d={d} B={B} H={H} L={L} "
                    f"{'causal' if causal else 'nomask'}: max|dO|={err_o:.3e} "
                    f"max|dLSE|={err_l:.3e}; max|err|/max|ref| dQ {rel[0]:.3e} dK "
                    f"{rel[1]:.3e} dV {rel[2]:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"FAIL: the blockwise kernels disagree with their plain "
                                 f"versions ({name}, B={B} H={H} L={L} d={d}, causal={causal})")
            for kern, a, r in ((fa.BW_KERNEL, max(err_o, err_l), 0.0),
                               (fa.BW_KERNEL_DKV, max(errs[1:]), max(rel[1:])),
                               (fa.BW_KERNEL_DQ, errs[0], rel[0])):
                worst[kern, name][0] = max(worst[kern, name][0], a)
                worst[kern, name][1] = max(worst[kern, name][1], r)
            del q, k, v, do, o, lse, grads, o_ref, lse_ref, ref
    log(f"kernel blockwise: {n_cases} cases ok (d {BW_DIMS}, L {BW_LENGTHS}, causal and "
        f"unmasked; the IVLP step's shapes {BW_PATH_SHAPES} at d 64; fp32 and bf16)")

    timings = {}
    for label, (B, H, L, d, causal) in BW_TIMED.items():
        q, k, v = _qkv(B, H, L, torch.bfloat16, gen, d)
        do = _blhd_grad(B, H, L, torch.bfloat16, gen, d)
        mask = causal_mask(L, device="cuda") if causal else None
        o, lse = fa._blockwise_attn_fwd_op(q, k, v, mask)
        delta = fa.attention_delta(o, do)
        args = (q, k, v, do, lse, delta, mask)
        fwd_ms = _time_ms(lambda: fa._blockwise_attn_fwd_op(q, k, v, mask))
        # the same launch without the checks and the torch.library dispatch
        direct_ms = _time_ms(lambda: fa._bw_launch(q, k, v, mask))
        dkv = lambda: fa._bw_launch_dkv(*args)  # noqa: E731
        dq = lambda: fa._bw_launch_dq(*args)  # noqa: E731
        bwd = lambda: fa._bw_kernel_bwd(q, k, v, o, lse, do, mask)  # noqa: E731
        dkv_ms, dq_ms, bwd_ms = _time_ms(dkv), _time_ms(dq), _time_ms(bwd)
        plain_fwd_ms = _time_ms(lambda: fa.reference_blockwise_fwd(q, k, v, mask))
        plain_bwd_ms = _time_ms(lambda: fa.reference_blockwise_bwd(q, k, v, o, lse, do, mask))
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
        lib_fwd_ms = _time_ms(sdpa)
        lib_bwd_ms = _library_bwd_ms(q, k, v, do, causal)
        dev_ms = _device_ms(lambda: fa._blockwise_attn_fwd_op(q, k, v, mask))
        lib_dev_ms = _device_ms(sdpa)
        # device time alone (profiler) of each backward kernel, the whole
        # backward (the delta pre-pass and both kernels) and aten's
        dev = {"dkv": _device_ms(dkv), "dq": _device_ms(dq), "bwd": _device_ms(bwd),
               "aten": _library_bwd_ms(q, k, v, do, causal, timer=_device_ms)}
        b_fwd = _bound(B, H, L, causal, "bfloat16", 2, d)
        b_dkv = _bound_bwd(B, H, L, causal, 2, 2, 8, d)
        b_dq = _bound_bwd(B, H, L, causal, 2, 1, 6, d)
        timings[label] = {
            fa.BW_KERNEL: dict(ms=fwd_ms, plain_ms=plain_fwd_ms, library_ms=lib_fwd_ms,
                               bound_ms=b_fwd[0], bound_by=b_fwd[1], device_ms=dev_ms,
                               library_device_ms=lib_dev_ms),
            fa.BW_KERNEL_DKV: dict(ms=dkv_ms, plain_ms=plain_bwd_ms, library_ms=lib_bwd_ms,
                                   bound_ms=b_dkv[0], bound_by=b_dkv[1], device_ms=dev["dkv"],
                                   library_device_ms=dev["aten"]),
            fa.BW_KERNEL_DQ: dict(ms=dq_ms, plain_ms=plain_bwd_ms, library_ms=lib_bwd_ms,
                                  bound_ms=b_dq[0], bound_by=b_dq[1], device_ms=dev["dq"],
                                  library_device_ms=dev["aten"]),
        }
        log(f"time blockwise bf16 {label} ({B},{H},{L},{d}) {'causal' if causal else 'nomask'}: "
            f"fwd kernel {fwd_ms:.4f} ms (launched directly {direct_ms:.4f} ms; bound "
            f"{b_fwd[0]:.4f}, {b_fwd[1]}; plain "
            f"{plain_fwd_ms:.4f}; sdpa {lib_fwd_ms:.4f}); dK/dV kernel {dkv_ms:.4f} ms (bound "
            f"{b_dkv[0]:.4f}, {b_dkv[1]}); dQ kernel {dq_ms:.4f} ms (bound {b_dq[0]:.4f}, "
            f"{b_dq[1]}); whole backward with the delta pre-pass {bwd_ms:.4f} ms; plain backward "
            f"{plain_bwd_ms:.4f} ms; aten._scaled_dot_product_flash_attention_backward "
            f"{_ms(lib_bwd_ms)}")
        log(f"time blockwise bf16 {label}: device time (profiler): fwd kernel {_ms(dev_ms)}, "
            f"sdpa {_ms(lib_dev_ms)}; dK/dV kernel {_ms(dev['dkv'])}, dQ kernel {_ms(dev['dq'])}, "
            f"whole backward with the delta pre-pass {_ms(dev['bwd'])}, aten backward "
            f"{_ms(dev['aten'])}")
        del q, k, v, do, o, lse, delta, args
    for (kern, name), (a, r) in worst.items():
        log(f"kernel {kern} {name}: worst max|err| {a:.3e}"
            + (f", worst max|err|/max|ref| {r:.3e}" if kern != fa.BW_KERNEL else ""))
    return {k: max(worst[k, n][0] for n in ("float32", "bfloat16")) for k in kernels}, timings


@_timed
def phase_kernels_fused():
    """The whole-sequence kernels #1-#2 against their plain versions at every
    head dim and edge of L, causal and unmasked, and at the CoOp and CoCoOp
    steps' own shapes (FUSED_PATH_SHAPES), fp32 and bf16; then times at
    FUSED_TIMED in bf16, with bounds, plain and library times."""
    import torch
    import torch.nn.functional as F

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.ops.attention import causal_mask

    gen = torch.Generator(device="cuda").manual_seed(3)
    bwd_kernels = (fa.FUSED_KERNEL_STATS, fa.FUSED_KERNEL_DKV, fa.FUSED_KERNEL_DQ)
    worst = {(k, n): [0.0, 0.0] for k in (fa.FUSED_KERNEL, "bwd") for n in ("float32", "bfloat16")}
    edges = [((4, 4) if L <= 201 else (2, 2)) + (L, d, causal)
             for d in FUSED_DIMS for L in FUSED_LENGTHS for causal in (True, False)]
    edges += [(B, H, L, d, causal) for d in FUSED_DIMS for B, H, L, causal in FUSED_RAGGED]
    path = [(B, H, L, 64, causal) for B, H, L, causal in FUSED_PATH_SHAPES]
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for B, H, L, d, causal in edges + path:
            q, k, v = _qkv(B, H, L, dtype, gen, d)
            do = _blhd_grad(B, H, L, dtype, gen, d)
            mask = causal_mask(L, device="cuda") if causal else None
            before = dict(fa.LAUNCHES)
            o = fa._fused_attn_fwd_op(q, k, v, mask)
            grads = fa._fused_attn_bwd_op(q, k, v, do, mask)
            launched = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES if fa.LAUNCHES[n] != before[n]}
            o_ref = fa.reference_fused_fwd(q, k, v, mask)
            ref = fa.reference_fused_bwd(q, k, v, do, mask)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            scale = max(r.float().abs().max().item() for r in ref)
            errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(grads, ref)]
            rel = [e / scale for e in errs]
            ok = (all(np.isfinite(e) for e in (err_o, *errs)) and err_o <= TOL[name]["o"]
                  and max(rel) <= TOL_BWD[name]
                  and launched == dict.fromkeys((fa.FUSED_KERNEL,) + bwd_kernels, 1))
            n_cases += 1
            if not ok or L in (16, 197) or (B, H, L, d, causal) in path:
                log(f"kernel fused {name} d={d} B={B} H={H} L={L} "
                    f"{'causal' if causal else 'nomask'}: max|dO|={err_o:.3e}; max|err|/max|ref| "
                    f"dQ {rel[0]:.3e} dK {rel[1]:.3e} dV {rel[2]:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"FAIL: the whole-sequence kernels disagree with their plain "
                                 f"versions or launched {launched} ({name}, B={B} H={H} L={L} "
                                 f"d={d}, causal={causal})")
            for kern, a, r in ((fa.FUSED_KERNEL, err_o, 0.0), ("bwd", max(errs), max(rel))):
                worst[kern, name][0] = max(worst[kern, name][0], a)
                worst[kern, name][1] = max(worst[kern, name][1], r)
            del q, k, v, do, o, grads, o_ref, ref
    log(f"kernel fused: {n_cases} cases ok (d {FUSED_DIMS}, L {FUSED_LENGTHS}, causal and "
        f"unmasked; ragged B*H {FUSED_RAGGED}; the CoOp/CoCoOp steps' shapes "
        f"{FUSED_PATH_SHAPES} at d 64; fp32 and bf16)")

    timings = {}
    for label, (B, H, L, causal) in FUSED_TIMED.items():
        q, k, v = _qkv(B, H, L, torch.bfloat16, gen)
        do = _blhd_grad(B, H, L, torch.bfloat16, gen)
        mask = causal_mask(L, device="cuda") if causal else None
        stats = fa._fused_launch_stats(q, k, v, do, mask)
        fwd_ms = _time_ms(lambda: fa._fused_launch(q, k, v, mask))
        part_ms = {
            fa.FUSED_KERNEL_STATS: _time_ms(lambda: fa._fused_launch_stats(q, k, v, do, mask)),
            fa.FUSED_KERNEL_DKV: _time_ms(lambda: fa._fused_launch_dkv(q, k, v, do, stats, mask)),
            fa.FUSED_KERNEL_DQ: _time_ms(lambda: fa._fused_launch_dq(q, k, v, do, stats, mask)),
        }

        def launches_bwd():
            st = fa._fused_launch_stats(q, k, v, do, mask)
            fa._fused_launch_dkv(q, k, v, do, st, mask)
            fa._fused_launch_dq(q, k, v, do, st, mask)

        bwd_ms = _time_ms(launches_bwd)
        plain_fwd_ms = _time_ms(lambda: fa.reference_fused_fwd(q, k, v, mask))
        plain_bwd_ms = _time_ms(lambda: fa.reference_fused_bwd(q, k, v, do, mask))
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
        lib_fwd_ms = _time_ms(sdpa)
        lib_bwd_ms = _library_bwd_ms(q, k, v, do, causal)
        # device time alone (profiler): the kernels', the three of #2 and the library calls'
        dev = {"fwd": _device_ms(lambda: fa._fused_launch(q, k, v, mask)),
               "bwd": _device_ms(launches_bwd), "sdpa": _device_ms(sdpa),
               "aten_bwd": _library_bwd_ms(q, k, v, do, causal, timer=_device_ms)}
        b_fwd = _bound(B, H, L, causal, "bfloat16", 2, lse=False)
        b_bwd = _bound_bwd(B, H, L, causal, 2, 3, 10, stats=False)
        timings[label] = {
            fa.FUSED_KERNEL: dict(ms=fwd_ms, plain_ms=plain_fwd_ms, library_ms=lib_fwd_ms,
                                  bound_ms=b_fwd[0], bound_by=b_fwd[1], device_ms=dev["fwd"],
                                  library_device_ms=dev["sdpa"]),
            "bwd": dict(ms=bwd_ms, plain_ms=plain_bwd_ms, library_ms=lib_bwd_ms,
                        bound_ms=b_bwd[0], bound_by=b_bwd[1], parts=part_ms,
                        device_ms=dev["bwd"], library_device_ms=dev["aten_bwd"]),
        }
        log(f"time fused bf16 {label} ({B},{H},{L},64) {'causal' if causal else 'nomask'}: "
            f"fwd kernel {fwd_ms:.4f} ms (bound {b_fwd[0]:.4f}, {b_fwd[1]}; plain "
            f"{plain_fwd_ms:.4f}; sdpa {lib_fwd_ms:.4f}); backward {bwd_ms:.4f} ms = stats "
            f"{part_ms[fa.FUSED_KERNEL_STATS]:.4f} + dK/dV {part_ms[fa.FUSED_KERNEL_DKV]:.4f} + dQ "
            f"{part_ms[fa.FUSED_KERNEL_DQ]:.4f} timed apart (bound {b_bwd[0]:.4f}, {b_bwd[1]}); "
            f"plain backward {plain_bwd_ms:.4f} ms; "
            f"aten._scaled_dot_product_flash_attention_backward {lib_bwd_ms} ms")
        log(f"time fused bf16 {label}: device time (profiler): fwd kernel {_ms(dev['fwd'])}, "
            f"sdpa {_ms(dev['sdpa'])}; backward's three kernels {_ms(dev['bwd'])}, aten "
            f"backward {_ms(dev['aten_bwd'])}")
        del q, k, v, do, stats
    for (kern, name), (a, r) in worst.items():
        log(f"kernel fused {kern} {name}: worst max|err| {a:.3e}"
            + (f", worst max|err|/max|ref| {r:.3e}" if kern != fa.FUSED_KERNEL else ""))
    return {k: max(worst[k, n][0] for n in ("float32", "bfloat16")) for k in (fa.FUSED_KERNEL, "bwd")}, timings


@_timed
def phase_kernels():
    import torch
    import torch.nn.functional as F

    from fsvlm_tpu_torch.ops.attention import causal_mask
    from fsvlm_tpu_torch.ops.flash_attention import (
        _kernel_fwd, _launch, reference_attention_fwd)

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0  # max abs error of O or LSE over every checked case
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for B, H, L, causal in KERNEL_SHAPES:
            q, k, v = _qkv(B, H, L, dtype, gen)
            mask = causal_mask(L, device="cuda") if causal else None
            o, lse = _kernel_fwd(q, k, v, mask)
            o_ref, lse_ref = reference_attention_fwd(q, k, v, mask)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_l = (lse - lse_ref).abs().max().item()
            ok = (np.isfinite(err_o) and np.isfinite(err_l)
                  and err_o <= TOL[name]["o"] and err_l <= TOL[name]["lse"])
            log(f"kernel flash_attn_fwd_d64 {name} B={B} H={H} L={L} "
                f"{'causal' if causal else 'nomask'}: max|dO|={err_o:.3e} "
                f"max|dLSE|={err_l:.3e} (tol {TOL[name]['o']:g}/{TOL[name]['lse']:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"FAIL: flash_attn_fwd_d64 disagrees with its plain version "
                                 f"({name}, B={B} H={H} L={L})")
            worst = max(worst, err_o, err_l)
            del q, k, v, o, lse, o_ref, lse_ref

    timings = {}
    for label, (B, H, L, causal) in (("vision", (100, 12, 201, False)),
                                     ("text", (100, 8, 16, True))):
        q, k, v = _qkv(B, H, L, torch.bfloat16, gen)
        mask = causal_mask(L, device="cuda") if causal else None
        ms = _time_ms(lambda: _kernel_fwd(q, k, v, mask))
        # the same launch without the checks and the torch.library dispatch
        direct_ms = _time_ms(lambda: _launch(q, k, v, mask))
        plain_ms = _time_ms(lambda: reference_attention_fwd(q, k, v, mask))
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
        lib_ms = _time_ms(sdpa)
        dev_ms, lib_dev_ms = _device_ms(lambda: _launch(q, k, v, mask)), _device_ms(sdpa)
        bound_ms, bound_by = _bound(B, H, L, causal, "bfloat16", 2)
        timings[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bound_ms, bound_by=bound_by, device_ms=dev_ms,
                              library_device_ms=lib_dev_ms)
        log(f"time flash_attn_fwd_d64 bf16 {label} ({B},{H},{L},64) "
            f"{'causal' if causal else 'nomask'}: kernel {ms:.4f} ms (launched directly "
            f"{direct_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); device time "
            f"(profiler): kernel {_ms(dev_ms)}, sdpa {_ms(lib_dev_ms)}")
    return worst, timings


@_timed
def phase_main():
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.serve import PromptSRCPredictor, PromptSRCServeConfig

    node = PromptSRCServeConfig(PREC="bf16", FROZEN_DTYPE="bf16")
    classnames = [f"class {i}" for i in range(N_CLASSES)]
    t0 = time.perf_counter()
    pred = PromptSRCPredictor(classnames, node=node, backbone="ViT-B/16", seed=0, device="cuda")
    plain = PromptSRCPredictor(classnames, node=node, clip=pred.clip,
                               prompt_params=pred.prompt_params, device="cuda",
                               attn_impl="plain")
    log(f"main: predictors built in {time.perf_counter() - t0:.1f} s "
        f"(text L={pred.frozen['base_embed'].shape[1]})")
    rng = np.random.RandomState(1234)
    batches = [torch.from_numpy(rng.randint(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)).cuda()
               for _ in range(N_BATCHES)]

    def run(p):
        torch.cuda.synchronize()
        t = time.perf_counter()
        txf = p.text_features().float()
        torch.cuda.synchronize()
        text_ms = (time.perf_counter() - t) * 1e3
        feats, logits, top, ms = [], [], [], []
        for x in batches:
            t = time.perf_counter()
            f = p.image_features(x)
            lg = p.logits(f)
            top.append(p.topk(lg, 5))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            feats.append(f.float())
            logits.append(lg.float())
        return text_ms, txf, torch.cat(feats), torch.cat(logits), top, ms

    # warm-up (CUDA and cuBLAS set-up, the first launch of each CUDA kernel,
    # the first GEMM of each shape): untimed, uncounted; the timed run
    # computes the text features anew
    for p in (pred, plain):
        p.image_logits(batches[0])
        p._text_features = None
    torch.cuda.synchronize()

    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
    k_text_ms, k_txf, k_feats, k_logits, k_top, k_ms = run(pred)
    launches = dict(fa.LAUNCHES)
    p_text_ms, p_txf, p_feats, p_logits, _, p_ms = run(plain)

    n = N_BATCHES * BATCH
    E = pred.clip.cfg.embed_dim
    for name, t, shape in (("kernel text features", k_txf, (N_CLASSES, E)),
                           ("plain text features", p_txf, (N_CLASSES, E)),
                           ("kernel features", k_feats, (n, E)), ("plain features", p_feats, (n, E)),
                           ("kernel logits", k_logits, (n, N_CLASSES)),
                           ("plain logits", p_logits, (n, N_CLASSES))):
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            raise SystemExit(f"FAIL: {name} shape {tuple(t.shape)} (want {shape}) or not finite")
    if any(len(row) != 5 for tops in k_top for row in tops) or len(k_top[0]) != BATCH:
        raise SystemExit("FAIL: predict top-k has the wrong shape")
    cos = torch.nn.functional.cosine_similarity(k_feats, p_feats, dim=-1)
    cos_txt = torch.nn.functional.cosine_similarity(k_txf, p_txf, dim=-1)
    dlog = (k_logits - p_logits).abs().amax(dim=-1)
    # each image's logit error against the spread of its logits between
    # classes, which is what decides its ranking
    spread = p_logits.std(dim=-1)
    rel = dlog / spread
    top2 = p_logits.topk(2, dim=-1).values
    confident = (top2[:, 0] - top2[:, 1]) > 0.2
    same_top1 = k_logits.argmax(-1) == p_logits.argmax(-1)
    flips = int((confident & ~same_top1).sum())
    log(f"main: text features {k_text_ms:.1f} ms (kernel) / {p_text_ms:.1f} ms (plain); "
        f"ms per batch of {BATCH}: kernel {[round(x, 2) for x in k_ms]}, "
        f"plain {[round(x, 2) for x in p_ms]}")
    log(f"main: min cosine image features {cos.min().item():.6f}, text features "
        f"{cos_txt.min().item():.6f}; max |dlogit| {dlog.max().item():.4f}; logit spread "
        f"between classes (std per image) {spread.min().item():.4f}-{spread.max().item():.4f}, "
        f"max |dlogit|/spread {rel.max().item():.4f}; "
        f"top-1 agreement {same_top1.float().mean().item():.4f}, "
        f"confident images {int(confident.sum())}, confident flips {flips}; launches {launches}")
    if (cos.min().item() < MIN_COSINE or cos_txt.min().item() < MIN_COSINE
            or dlog.max().item() > MAX_DLOGIT or rel.max().item() > MAX_DLOGIT_OVER_SPREAD
            or flips):
        raise SystemExit("FAIL: kernel and plain serving paths disagree")
    expected = pred.clip.cfg.transformer_layers + N_BATCHES * pred.clip.cfg.vision_layers
    _others_silent(launches, "flash_attn", "the serving path")
    if launches[fa.KERNEL] != expected:
        raise SystemExit(f"FAIL: {fa.KERNEL} launched {launches[fa.KERNEL]} times on the "
                         f"serving path, expected {expected}")
    return pred, batches[0]


# kernel-name fragments (bf16, as the profiler demangles them) of #6-#8 on
# the PromptSRC step, of #3-#5 on the IVLP step, and of the whole-sequence
# kernels #1 and #2 (bf16 and fp32), summed by _profile where a step runs
# them.  #3 and #6 launch one forward; at d = 64 #4/#5 and #7/#8 launch the
# same mma_attn.cuh kernels from the LSE (one instantiation each at #7/#8's
# warp counts, from two libraries), matched by their template arguments.
# Each cell runs one family, so each cell's groups are unambiguous.
FLASH_FWD = ("flash_tiled_kernel<64>", "flash_packed_kernel<64, ")
LSE_DKV = ("dkv_tiled_kernel<64, true", "dkv_packed_kernel<64, 16, true",
           "dkv_packed_kernel<64, 32, true")
LSE_DQ = ("dq_tiled_kernel<64, true", "dq_packed_kernel<64, 16, true",
          "dq_packed_kernel<64, 32, true")
FLASH_GROUPS = {"#6": FLASH_FWD, "#7": LSE_DKV, "#8": LSE_DQ}
BW_GROUPS = {"#3": FLASH_FWD, "#4": LSE_DKV, "#5": LSE_DQ}
# the LAUNCHES names (``ops/flash_attention.py``) of each group's kernels
GROUP_KERNELS = {"#6": ("flash_attn_fwd_d64",), "#7": ("flash_attn_bwd_dkv_d64",),
                 "#8": ("flash_attn_bwd_dq_d64",), "#3": ("blockwise_attn_fwd",),
                 "#4": ("blockwise_attn_bwd_dkv",), "#5": ("blockwise_attn_bwd_dq",),
                 "#1": ("fused_attn_fwd",),
                 "#2": ("fused_attn_bwd_stats", "fused_attn_bwd_dkv", "fused_attn_bwd_dq")}
FUSED_GROUPS = {"#1": ("fwd_tiled_kernel", "fwd_packed_kernel", "fused_attn_fwd_kernel"),
                "#2": ("stats_tiled_kernel", "stats_packed_kernel", "fused_attn_bwd_stats_kernel",
                       *(f"{kind}_tiled_kernel<{D}, false" for kind in ("dkv", "dq")
                         for D in (32, 64, 128)),
                       *(f"{kind}_packed_kernel<{D}, {R}, false" for kind in ("dkv", "dq")
                         for D in (32, 64, 128) for R in (16, 32)),
                       "kernel<float, 32, true>", "kernel<float, 64, true>",
                       "kernel<float, 128, true>")}


def _profile(label, fn, top=12, groups=None, counts=None):
    """Run ``fn`` once under torch.profiler; print its wall time, the device's
    busy time (kernels' self device time) and idle share, the top kernels by
    device time and, per group of ``groups`` ({label: name fragments}), the
    device time and launches of the kernels whose names hold a fragment
    (and, into the dict ``counts`` where given, {label: launches})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # the device's own events (kernels, copies, fills; not the ranges that
    # annotations project onto the device's timeline), summed by name from
    # the profiler's raw events: key_averages() would build the CPU op tree
    # first, tens of seconds for a loader-fed window
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
                and not getattr(e, "is_user_annotation", lambda: False)()):
            row = by_name.setdefault(e.name(), [0, 0.0])
            row[0] += 1
            row[1] += e.duration_ns() / 1e3
    rows = sorted(((name, n, us) for name, (n, us) in by_name.items()), key=lambda r: -r[2])
    busy = sum(us for _, _, us in rows)
    log(f"profile: {label}: wall {wall_us / 1e3:.3f} ms under the profiler, device busy "
        f"{busy / 1e3:.3f} ms, idle share {max(0.0, 1 - busy / wall_us):.3f}")
    for name, n, us in rows[:top]:
        log(f"profile:   {us / 1e3:9.3f} ms  {100 * us / busy:5.1f}%  x{n:<4d} {name[:100]}")
    for group, frags in (groups or {}).items():
        hit = [(n, us) for name, n, us in rows if any(f in name for f in frags)]
        us = sum(u for _, u in hit)
        log(f"profile:   {group}: {us / 1e3:.3f} ms, {100 * us / busy:.1f}% of busy, "
            f"{sum(n for n, _ in hit)} launches")
        if counts is not None:
            counts[group] = sum(n for n, _ in hit)
    return wall_us / 1e3, busy / 1e3


def _traced(fn, groups):
    """Run ``fn`` under torch.profiler.  Returns its result, the launches
    of each group of ``groups`` ({label: name fragments}) among the
    device's kernel events (a CUDA graph's replayed kernels among them),
    and the number of CUDA graph launches (cudaGraphLaunch runtime calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    counts, graphs = dict.fromkeys(groups, 0), 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("cudaGraphLaunch"):
            graphs += 1
        elif (e.device_type() == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", lambda: False)()):
            for label, frags in groups.items():
                counts[label] += any(f in name for f in frags)
    return out, counts, graphs


def _group_launches(groups, per_step, steps):
    """{group label: launches} that ``steps`` steps of ``per_step``
    ({kernel: launches}) make, by GROUP_KERNELS."""
    return {g: steps * sum(per_step.get(k, 0) for k in GROUP_KERNELS[g]) for g in groups}


def _zero_fused_steps():
    from fsvlm_tpu_torch.engine import fused

    fused.STEPS.update(dict.fromkeys(fused.STEPS, 0))


def _wrapped_steps(label, total):
    """Of the ``total`` train steps run since ``_zero_fused_steps``, the
    ones whose kernel wrappers ran, so that LAUNCHES counts them: every step
    but a CUDA graph replay, and each captured step once (its launches are
    recorded into the graph, which the first replay runs).  Checks that the
    fused epochs' steps (``engine/fused.py``'s STEPS) fit in ``total``.
    Returns (that number, STEPS)."""
    from fsvlm_tpu_torch.engine import fused

    s = dict(fused.STEPS)
    if (s["eager"] + s["replays"] > total or s["captured"] > s["eager"]
            or (s["replays"] > 0) != (s["captured"] > 0)):
        raise SystemExit(f"FAIL: {label}: the fused epochs' steps {s} do not fit {total} steps")
    return total - s["replays"] + s["captured"], s


@_timed
def phase_profile(pred, batch):
    """Device time by kernel over one serving batch and one text pass
    (torch.profiler), and host wall time of repeated text passes, with the
    kernel reached through its torch.library operator (the main path) and
    launched directly, in alternation."""
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa

    def text_pass():
        pred._text_features = None
        pred.text_features()

    for label, fn in (("image batch of %d" % len(batch), lambda: pred.logits(pred.image_features(batch))),
                      ("text pass", text_pass)):
        _profile(label, fn)
    op = fa._flash_attn_fwd_op
    walls = {"operator": [], "direct": []}
    try:
        for _ in range(5):
            for route, call in (("operator", op), ("direct", fa._launch)):
                fa._flash_attn_fwd_op = call
                torch.cuda.synchronize()
                t = time.perf_counter()
                text_pass()
                torch.cuda.synchronize()
                walls[route].append(round((time.perf_counter() - t) * 1e3, 3))
    finally:
        fa._flash_attn_fwd_op = op
    log(f"profile: text pass wall ms, 5 repeats each, alternating: through the operator "
        f"{walls['operator']}, launched directly {walls['direct']}")


def _cosine(a, b):
    import torch

    return torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(),
                                                 dim=0).item()


def _train_cfg(trainer_key):
    """The recipe (get_cfg_default) at the smoke run's size: SEED 0, bf16
    frozen towers and compute, DEVICE_AUG, batch TRAIN_BATCH, TRAIN_EPOCHS
    epochs (a depth cut of the recipe's 20)."""
    from fsvlm_tpu_torch.config import get_cfg_default

    cfg = get_cfg_default()
    cfg.SEED = 0
    cfg.MODEL.FROZEN_DTYPE = "bf16"
    getattr(cfg.TRAINER, trainer_key).PREC = "bf16"
    cfg.DATALOADER.DEVICE_AUG = True
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = TRAIN_BATCH
    cfg.OPTIM.MAX_EPOCH = TRAIN_EPOCHS
    return cfg


def _train_cache():
    import torch

    rng = np.random.RandomState(1234)
    cache = torch.from_numpy(rng.randint(0, 256, (TRAIN_CACHE, 224, 224, 3), dtype=np.uint8)).cuda()
    labels = torch.from_numpy(np.arange(TRAIN_CACHE) % N_CLASSES).cuda()
    return cache, labels


def _augmented_batch(cache, labels, seed, batch=TRAIN_BATCH):
    """One augmented batch of ``batch`` cache images from a generator of its
    own (the trainers' are not drawn from)."""
    import torch

    from fsvlm_tpu_torch.ops.preprocess import (
        crop_resize_flip_normalize, sample_crop_boxes, sample_flips)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    images = crop_resize_flip_normalize(
        cache[:batch], sample_crop_boxes(batch, 224, 224, (0.08, 1.0), gen),
        sample_flips(batch, gen), 224)
    return {"img": images, "label": labels[:batch]}


def _grad_agreement(label, kt, pt, node, batch):
    """The first step's prompt gradients on one batch, through the kernels
    and the plain attention, in the step's bf16 and again in fp32 (PREC is
    read by both trainers' compute_dtype()).  fp32: kernel against plain at
    MIN_GRAD_COSINE; bf16: each path's distance (1 - cosine) to the fp32
    plain gradient is its rounding noise, and the kernel path's may be at
    most BF16_NOISE_RATIO times the plain path's."""
    import torch

    grads = {}
    for prec in ("bf16", "fp32"):
        node.PREC = prec
        for name, t in (("kernel", kt), ("plain", pt)):
            loss, _ = t.loss_fn(t.params, t.frozen, batch)
            grads[name, prec] = dict(zip(t.params, torch.autograd.grad(loss, list(t.params.values()))))
    node.PREC = "bf16"
    cos = {pair: {k: _cosine(grads[pair[0]][k], grads[pair[1]][k]) for k in kt.params}
           for pair in ((("kernel", "fp32"), ("plain", "fp32")), (("kernel", "bf16"), ("plain", "bf16")),
                        (("kernel", "bf16"), ("plain", "fp32")), (("plain", "bf16"), ("plain", "fp32")))}
    for (a, b), c in cos.items():
        log(f"{label}: first-step gradient cosine, {' '.join(a)} against {' '.join(b)}: "
            + ", ".join(f"{k} {v:.7f}" for k, v in c.items()))
    k_vs_p32 = cos[("kernel", "fp32"), ("plain", "fp32")]
    noise_k = cos[("kernel", "bf16"), ("plain", "fp32")]
    noise_p = cos[("plain", "bf16"), ("plain", "fp32")]
    if (min(k_vs_p32.values()) < MIN_GRAD_COSINE
            or any(1 - noise_k[k] > BF16_NOISE_RATIO * (1 - noise_p[k]) + 1e-9 for k in kt.params)):
        raise SystemExit(f"FAIL: {label}: kernel and plain first-step prompt gradients disagree")


def _train_both(label, kt, pt, per_step, family, batch=TRAIN_BATCH, aux=()):
    """kt.train() through the kernels, every step timed on the host clock,
    with the launch counts zeroed just before and read just after; then
    pt.train() through the plain attention.  Checks the per-step losses
    (and the step metrics named in ``aux``, by the same rule), each prompt
    tensor's total change and the launch counts.  Returns (launches,
    step_ms, peak bytes)."""
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa

    init = {k: v.detach().clone() for k, v in kt.params.items()}
    step_ms = []
    run_step = kt.train_step_resident
    # step by step: the timer wraps each train_step_resident, which a fused
    # epoch (TRAIN.EPOCH_FUSE) would not call
    fuse = kt.cfg.TRAIN.EPOCH_FUSE, pt.cfg.TRAIN.EPOCH_FUSE
    kt.cfg.TRAIN.EPOCH_FUSE = pt.cfg.TRAIN.EPOCH_FUSE = "off"

    def timed_step(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_step(*args, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    kt.train_step_resident = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
    k_hist = kt.train()
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    kt.train_step_resident = run_step
    p_hist = pt.train()
    kt.cfg.TRAIN.EPOCH_FUSE, pt.cfg.TRAIN.EPOCH_FUSE = fuse
    if not torch.equal(kt.generator.get_state(), pt.generator.get_state()):
        raise SystemExit(f"FAIL: {label}: the two runs drew differently from their generators")

    k_loss = [m["loss"] for h in k_hist for m in h]
    p_loss = [m["loss"] for h in p_hist for m in h]
    n_steps = TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH
    dloss = [abs(a - b) / (1 + abs(b)) for a, b in zip(k_loss, p_loss)]
    aux_ok = True
    for key in aux:
        k_aux = [m[key] for h in k_hist for m in h]
        p_aux = [m[key] for h in p_hist for m in h]
        d_aux = [abs(a - b) / (1 + abs(b)) for a, b in zip(k_aux, p_aux)]
        log(f"{label}: {key} kernel {[round(x, 6) for x in k_aux]}, plain "
            f"{[round(x, 6) for x in p_aux]}; max |d{key}|/(1+|{key}|) {max(d_aux):.3e} "
            f"(limit {DLOSS:g})")
        aux_ok &= all(np.isfinite(k_aux + p_aux)) and max(d_aux) <= DLOSS
    delta_cos = {k: _cosine(kt.params[k].detach() - init[k], pt.params[k].detach() - init[k])
                 for k in kt.params}
    lrs = [kt.lr_schedule.lr_at_epoch(e) for e in range(TRAIN_EPOCHS)]
    log(f"{label}: losses kernel {[round(x, 5) for x in k_loss]}, plain "
        f"{[round(x, 5) for x in p_loss]}; max |dloss|/(1+|loss|) {max(dloss):.3e} "
        f"(limit {DLOSS:g}); LR per epoch {lrs}; optimizer count {int(kt.optim.count)}")
    log(f"{label}: cosine of each prompt tensor's total change {delta_cos}")
    log(f"{label}: launches over {n_steps} steps {launches}, expected per step {per_step}")
    if (len(k_loss) != n_steps or not all(np.isfinite(k_loss + p_loss))
            or max(dloss) > DLOSS or min(delta_cos.values()) < MIN_DELTA_COSINE or not aux_ok):
        raise SystemExit(f"FAIL: {label}: kernel and plain train paths disagree")
    _others_silent(launches, family, f"the {label} path")
    for kern, n in per_step.items():
        if launches[kern] != n * n_steps:
            raise SystemExit(f"FAIL: {kern} launched {launches[kern]} times on the {label} path, "
                             f"expected {n * n_steps}")
    med = float(np.median(step_ms[1:]))
    log(f"{label}: step ms {[round(x, 2) for x in step_ms]}; median over steps 2-{n_steps} "
        f"{med:.2f} ms, {batch / med * 1e3:.1f} images/s; peak memory "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    return launches, step_ms, peak


def _no_sync_step(label, step, *args, **kw):
    """One step with torch.cuda's sync debug mode set to raise on a
    synchronizing call (the JAX step issues none either)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"{label}: one step under sync debug mode 'error' made no synchronizing call")


def _trainer_state(t):
    """A copy of what a step changes: the trained tensors, the optimizer's
    tensors (counts and moments), the generator and the mixup rng."""
    import copy

    return {"params": {k: v.detach().clone() for k, v in t.params.items()},
            "optim": [x.clone() for x in t.optim.tensors()] if t.optim else [],
            "generator": t.generator.get_state(),
            "mix_rng": copy.deepcopy(t.mix_rng.bit_generator.state)}


def _set_trainer_state(t, state):
    import torch

    with torch.no_grad():
        for k, v in state["params"].items():
            t.params[k].copy_(v)
        for x, v in zip(t.optim.tensors() if t.optim else [], state["optim"]):
            x.copy_(v)
    t.generator.set_state(state["generator"])
    t.mix_rng.bit_generator.state = state["mix_rng"]


def _states_equal(a, b):
    import torch

    return (a["params"].keys() == b["params"].keys()
            and all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
            and len(a["optim"]) == len(b["optim"])
            and all(torch.equal(x, y) for x, y in zip(a["optim"], b["optim"]))
            and torch.equal(a["generator"], b["generator"]) and a["mix_rng"] == b["mix_rng"])


def _fused_vs_eager(label, t, epochs, per_step, groups):
    """From one state, ``epochs`` epochs of trainer ``t`` step by step
    (TRAIN.EPOCH_FUSE off) and fused ("on": a warm-up step, the capture,
    replays), the fused run under torch.profiler: the trained tensors, the
    optimizer's counts and moments, the generator, the mixup rng and every
    step's metrics must be bit-equal.  Launches: step by step each kernel
    at ``per_step`` x steps; fused, the wrappers' counts those of the
    warm-up and the captured step alone (a replay calls no wrapper), the
    captured step's calls ``per_step``, one cudaGraphLaunch per replay in
    the trace, and the trace's kernel events of each group of ``groups``
    at ``per_step`` x steps: the replays ran the kernels.
    Leaves t in the fused run's state with its graph, EPOCH_FUSE "auto".
    Returns ({mode: {"ms", "peak", "launches"}, with "traced" and "replays"
    for "on"}, the capture's timings)."""
    import torch

    from fsvlm_tpu_torch.engine import fused
    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.ops import quant

    start, runs = _trainer_state(t), {}
    t._fused = None  # the fused run captures its own graph
    for mode in ("off", "on"):
        _set_trainer_state(t, start)
        t.cfg.TRAIN.EPOCH_FUSE = mode
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        quant.LAUNCHES.update(dict.fromkeys(quant.LAUNCHES, 0))
        _zero_fused_steps()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def run():
            hist = []
            for t.epoch in range(epochs):
                with contextlib.redirect_stdout(io.StringIO()):
                    hist.append(t.run_epoch())
            return hist

        t0 = time.perf_counter()
        if mode == "on":
            hist, traced, graphs = _traced(run, groups)
        else:
            hist, traced, graphs = run(), None, None
        torch.cuda.synchronize()
        runs[mode] = {"ms": (time.perf_counter() - t0) * 1e3,
                      "peak": torch.cuda.max_memory_allocated(),
                      "launches": {**fa.LAUNCHES, **quant.LAUNCHES}, "hist": hist,
                      "state": _trainer_state(t), "traced": traced, "graphs": graphs,
                      "steps": dict(fused.STEPS)}
    t.cfg.TRAIN.EPOCH_FUSE = "auto"
    on, off = runs["on"], runs["off"]
    steps = sum(len(h) for h in on["hist"])
    f = t._fused
    same = on["hist"] == off["hist"] and _states_equal(on["state"], off["state"])
    want_traced = _group_launches(groups, per_step, steps)
    tally = {k: n for c in (f.tally if f and f.tally else ()) for k, n in c.items() if n}
    log(f"{label}: {epochs} epoch(s), {steps} steps, fused (warm-up step, capture, replays) "
        f"against step by step from one state: metrics, trained tensors, optimizer counts and "
        f"moments, generator and mixup rng bit-equal: {same}; optimizer count "
        f"{int(t.optim.count) if t.optim else None}; fused steps {on['steps']}; wrapper calls "
        f"fused {on['launches']} (the captured step's {tally}), step by step "
        f"{off['launches']}; fused under the profiler: kernel events {on['traced']} (expected "
        f"{want_traced}), {on['graphs']} cudaGraphLaunch; capture (under the profiler) "
        f"{f.timings if f else None} ms; wall ms fused (profiled) {on['ms']:.1f}, step by step "
        f"{off['ms']:.1f}; peak memory fused {on['peak'] / 2**30:.2f} GiB, step by step "
        f"{off['peak'] / 2**30:.2f} GiB")
    if f is None or f.graph is None:
        raise SystemExit(f"FAIL: {label}: the fused epochs captured no graph")
    if not same:
        raise SystemExit(f"FAIL: {label}: fused and step-by-step epochs differ")
    replays = steps - 1  # a warm-up step, the capture, then one replay a step
    if (on["steps"] != {"eager": 1, "captured": 1, "replays": replays}
            or any(off["launches"][k] != n * steps for k, n in per_step.items())
            or any(on["launches"][k] * steps != n * 2 for k, n in off["launches"].items())
            or any(tally.get(k, 0) != n for k, n in per_step.items())):
        raise SystemExit(f"FAIL: {label}: the wrapper calls are not the warm-up's and the "
                         f"captured step's, or not the derived counts (per step {per_step})")
    if on["traced"] != want_traced or on["graphs"] != replays:
        raise SystemExit(f"FAIL: {label}: the fused run's trace holds {on['traced']} kernel "
                         f"events and {on['graphs']} graph launches, expected {want_traced} "
                         f"and {replays}")
    keep = ("ms", "peak", "launches", "traced", "graphs")
    return {m: {k: r[k] for k in keep} for m, r in runs.items()}, f.timings


def _no_sync_replays(label, t):
    """One fused epoch of ``t`` (its graph captured) with torch.cuda's sync
    debug mode raising on a synchronizing call around the replay loop."""
    import torch

    f = t._fused
    run = f.run

    def no_sync_run(*args):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    f.run = no_sync_run
    t.cfg.TRAIN.EPOCH_FUSE = "on"
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            n = len(t.run_epoch())
    finally:
        del f.run
        t.cfg.TRAIN.EPOCH_FUSE = "auto"
    log(f"{label}: the replay loop of a fused epoch ({n} replays) under sync debug mode "
        f"'error' made no synchronizing call")


@_timed
def phase_train(clip):
    """The PromptSRC ViT-B/16 train step at full width, through the kernels
    and through the plain attention (same weights, batches, boxes, flips)."""
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.trainers.promptsrc import PromptSRC

    cfg = _train_cfg("PROMPTSRC")  # the vit_b16_c2_ep20_batch4_4+4ctx recipe
    classnames = [f"class {i}" for i in range(N_CLASSES)]
    cache, labels = _train_cache()

    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
    t0 = time.perf_counter()
    kt = PromptSRC(cfg, classnames, cache, labels, clip=clip, device="cuda",
                   steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    build_launches = dict(fa.LAUNCHES)
    pt = PromptSRC(cfg, classnames, cache, labels, clip=clip, device="cuda",
                   steps_per_epoch=TRAIN_STEPS_PER_EPOCH, attn_impl="plain")
    log(f"train: trainers built in {time.perf_counter() - t0:.1f} s (text L="
        f"{kt.frozen['base_embed'].shape[1]}, teacher text L=77); launches while building the "
        f"kernel trainer {build_launches}")
    if build_launches[fa.KERNEL] != clip.cfg.transformer_layers:
        raise SystemExit(f"FAIL: the teacher text features launched {fa.KERNEL} "
                         f"{build_launches[fa.KERNEL]} times, expected {clip.cfg.transformer_layers}")
    cos_txt = torch.nn.functional.cosine_similarity(kt.frozen["zs_text"], pt.frozen["zs_text"], dim=-1)
    if cos_txt.min().item() < MIN_COSINE:
        raise SystemExit(f"FAIL: teacher text features disagree (min cosine {cos_txt.min().item()})")

    _grad_agreement("train", kt, pt, cfg.TRAINER.PROMPTSRC, _augmented_batch(cache, labels, 7))
    per_step = {fa.KERNEL: 3 * clip.cfg.vision_layers, fa.KERNEL_DKV: 2 * clip.cfg.vision_layers,
                fa.KERNEL_DQ: 2 * clip.cfg.vision_layers}  # text + student + teacher; text + student
    launches, _, _ = _train_both("train", kt, pt, per_step, "flash_attn")
    index = kt.epoch_schedule()[0][0]
    _no_sync_step("train", kt.train_step_resident, index)

    # TRAIN.EPOCH_FUSE (the default path, "auto"): TRAIN_EPOCHS epochs fused
    # against step by step from one state, bit-equal, #6-#8 counted from the
    # fused run's trace; a replay loop without a sync
    fused, _ = _fused_vs_eager("train", kt, TRAIN_EPOCHS, per_step, FLASH_GROUPS)
    _no_sync_replays("train", kt)
    # the capture's ms outside the profiler: a fused epoch that captures anew
    kt._fused = None
    kt.cfg.TRAIN.EPOCH_FUSE = "on"
    with contextlib.redirect_stdout(io.StringIO()):
        kt.run_epoch()
    kt.cfg.TRAIN.EPOCH_FUSE = "auto"
    capture = kt._fused.timings

    # epochs fused (replays of the captured step), step by step as train()
    # runs them without fusion (no sync between steps, one read-back at the
    # end) and synced after every step, in turns
    run_step = kt.train_step_resident

    def synced_step(*args, **kw):
        torch.cuda.synchronize()
        out = run_step(*args, **kw)
        torch.cuda.synchronize()
        return out

    def epoch_ms_per_step(mode):
        kt.cfg.TRAIN.EPOCH_FUSE = "on" if mode == "fused" else "off"
        kt.train_step_resident = synced_step if mode == "synced" else run_step
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            kt.run_epoch()
        ms = (time.perf_counter() - t) * 1e3 / TRAIN_STEPS_PER_EPOCH
        kt.train_step_resident = run_step
        kt.cfg.TRAIN.EPOCH_FUSE = "auto"
        return ms

    modes = ("fused", "pipelined", "synced")
    epochs = {m: [] for m in modes}
    for i in range(N_EPOCH_PAIRS):
        for mode in modes[i % 3:] + modes[:i % 3]:
            epochs[mode].append(epoch_ms_per_step(mode))
    epoch_med = {m: float(np.median(v)) for m, v in epochs.items()}
    from fsvlm_tpu_torch.utils.flops import promptsrc_step_flops

    node = cfg.TRAINER.PROMPTSRC
    step_flops = promptsrc_step_flops(clip.cfg, TRAIN_BATCH, N_CLASSES,
                                      kt.frozen["base_embed"].shape[1], n_vpt=node.N_CTX_VISION)
    tflops = {m: step_flops / (ms * 1e-3) / 1e12 for m, ms in epoch_med.items()}
    log(f"train: ms per step over {N_EPOCH_PAIRS} epochs of {TRAIN_STEPS_PER_EPOCH} steps each way, "
        f"in turns, on {CARD[0]}: fused (TRAIN.EPOCH_FUSE, replays) "
        f"{[round(x, 2) for x in epochs['fused']]} (median {epoch_med['fused']:.2f}, "
        f"{TRAIN_BATCH / epoch_med['fused'] * 1e3:.1f} images/s), step by step as train() runs "
        f"them unfused {[round(x, 2) for x in epochs['pipelined']]} (median "
        f"{epoch_med['pipelined']:.2f}, {TRAIN_BATCH / epoch_med['pipelined'] * 1e3:.1f} "
        f"images/s), synced after every step {[round(x, 2) for x in epochs['synced']]} (median "
        f"{epoch_med['synced']:.2f}); the step's model FLOPs (utils/flops.py, dgrad only) "
        f"{step_flops / 1e12:.4f} TFLOP: {tflops['fused']:.1f} TFLOP/s fused, "
        f"{tflops['pipelined']:.1f} unfused, {tflops['synced']:.1f} synced; capture "
        f"{capture['capture']:.1f} ms, instantiate {capture['instantiate']:.1f} ms; peak memory "
        f"over {TRAIN_EPOCHS} epochs fused (with the capture) {fused['on']['peak'] / 2**30:.2f} "
        f"GiB, step by step {fused['off']['peak'] / 2**30:.2f} GiB")
    print(json.dumps({"fused_epoch": {
        "ms_per_step": epoch_med, "images_per_s": {m: TRAIN_BATCH / v * 1e3
                                                    for m, v in epoch_med.items()},
        "model_tflops": tflops, "capture_ms": capture,
        "peak_gib": {m: fused[m]["peak"] / 2**30 for m in ("on", "off")}, "card": CARD[0]}}),
          flush=True)
    _profile(f"one train step, batch {TRAIN_BATCH}", lambda: kt.train_step_resident(index), top=30,
             groups=FLASH_GROUPS)
    return fused["on"], launches


@_timed
def phase_train_ivlp(clip):
    """The IVLP ViT-B/16 KD train step at full width under
    FSVLM_FORCE_PALLAS=1 (the caller sets it), through the blockwise kernels
    and through their plain versions; then mixup steps on shared draws."""
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.ops.preprocess import sample_crop_boxes, sample_flips
    from fsvlm_tpu_torch.trainers.ivlp import IVLP

    cfg = _train_cfg("IVLP")  # the vit_b16_c2_ep20_batch4_4+4ctx_kd recipe
    node = cfg.TRAINER.IVLP
    classnames = [f"class {i}" for i in range(N_CLASSES)]
    cache, labels = _train_cache()

    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
    t0 = time.perf_counter()
    kt = IVLP(cfg, classnames, cache, labels, clip=clip, device="cuda",
              steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    build_launches = dict(fa.LAUNCHES)
    pt = IVLP(cfg, classnames, cache, labels, clip=clip, device="cuda",
              steps_per_epoch=TRAIN_STEPS_PER_EPOCH, attn_impl="plain")
    log(f"ivlp: trainers built in {time.perf_counter() - t0:.1f} s (text L="
        f"{kt.frozen['base_embed'].shape[1]}, KD teacher text L=77, fp32); launches while "
        f"building the kernel trainer {build_launches}")
    _others_silent(build_launches, "blockwise", "the IVLP build")
    if build_launches[fa.BW_KERNEL] != clip.cfg.transformer_layers:
        raise SystemExit(f"FAIL: the KD teacher text features launched {fa.BW_KERNEL} "
                         f"{build_launches[fa.BW_KERNEL]} times, expected "
                         f"{clip.cfg.transformer_layers}")
    cos_txt = torch.nn.functional.cosine_similarity(kt.frozen["teacher_text"],
                                                    pt.frozen["teacher_text"], dim=-1)
    if cos_txt.min().item() < MIN_COSINE:
        raise SystemExit(f"FAIL: KD teacher text features disagree (min cosine "
                         f"{cos_txt.min().item()})")

    # The recipe's KD_ALPHA 1.0 gives the KD term weight 0, so no loss or
    # gradient below sees the teacher's image pass: hold its logits to the
    # plain path's (phase 4's rules), and the loss at KD_ALPHA 0.5 too.
    n = clip.cfg.vision_layers  # = transformer_layers = 12 for ViT-B/16
    batch = _augmented_batch(cache, labels, 8)
    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
    t_kernel = kt.teacher_logits(kt.frozen, batch["img"])
    teacher_launches = dict(fa.LAUNCHES)
    t_plain = pt.teacher_logits(pt.frozen, batch["img"])
    dlog = (t_kernel - t_plain).abs().max(dim=-1).values
    rel = (dlog / t_plain.std(dim=-1)).max().item()
    kt.kd_alpha = pt.kd_alpha = 0.5
    with torch.no_grad():
        kd_losses = [t.loss_fn(t.params, t.frozen, batch)[0].item() for t in (kt, pt)]
    kt.kd_alpha = pt.kd_alpha = float(node.KD_ALPHA)
    d_kd = abs(kd_losses[0] - kd_losses[1]) / (1 + abs(kd_losses[1]))
    log(f"ivlp: KD teacher logits, kernel against plain: max |dlogit| {dlog.max().item():.4f}, "
        f"max |dlogit|/spread {rel:.4f} (limits {MAX_DLOGIT:g}, {MAX_DLOGIT_OVER_SPREAD:g}); "
        f"loss at KD_ALPHA 0.5 (kernel, plain) {[round(x, 5) for x in kd_losses]}, "
        f"|dloss|/(1+|loss|) {d_kd:.3e}; launches of the teacher pass {teacher_launches}")
    _others_silent(teacher_launches, "blockwise", "the KD teacher pass")
    if teacher_launches[fa.BW_KERNEL] != n:
        raise SystemExit(f"FAIL: the KD teacher image pass launched {fa.BW_KERNEL} "
                         f"{teacher_launches[fa.BW_KERNEL]} times, expected {n}")
    if (not torch.isfinite(t_kernel).all() or dlog.max().item() > MAX_DLOGIT
            or rel > MAX_DLOGIT_OVER_SPREAD or not np.isfinite(kd_losses).all() or d_kd > DLOSS):
        raise SystemExit("FAIL: ivlp: kernel and plain KD teacher passes disagree")

    _grad_agreement("ivlp", kt, pt, node, batch)
    per_step = {fa.BW_KERNEL: 3 * n, fa.BW_KERNEL_DKV: 2 * n, fa.BW_KERNEL_DQ: 2 * n}
    launches, step_ms, peak = _train_both("ivlp", kt, pt, per_step, "blockwise")
    index = kt.epoch_schedule()[0][0]
    _no_sync_step("ivlp", kt.train_step_resident, index)

    # epochs as train() runs them: the images/s a user sees
    epoch_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        kt.run_epoch()
        epoch_ms.append((time.perf_counter() - t) * 1e3 / TRAIN_STEPS_PER_EPOCH)
    log(f"ivlp: ms per step over 2 epochs as train() runs them {[round(x, 2) for x in epoch_ms]} "
        f"({TRAIN_BATCH / float(np.median(epoch_ms)) * 1e3:.1f} images/s)")

    # mixup on (USE_MIXUP's defaults.py value): each step's perm, lam, boxes
    # and flips drawn once and handed to both trainers
    node.USE_MIXUP = kt.use_mixup = pt.use_mixup = True
    gen = torch.Generator(device="cuda").manual_seed(9)
    lams = np.random.default_rng(9).beta(node.MIXUP_ALPHA, node.MIXUP_ALPHA, N_MIX_STEPS)
    mix_loss = []
    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
    for step in range(N_MIX_STEPS):
        idx = torch.arange(step * TRAIN_BATCH, (step + 1) * TRAIN_BATCH, device="cuda")
        aug = (sample_crop_boxes(TRAIN_BATCH, 224, 224, (0.08, 1.0), gen), sample_flips(TRAIN_BATCH, gen))
        mix = (torch.randperm(TRAIN_BATCH, generator=gen, device="cuda"),
               torch.tensor(lams[step], dtype=torch.float32, device="cuda"))
        mix_loss.append([t.train_step_resident(idx, aug=aug, mix=mix)["loss"].item()
                         for t in (kt, pt)])
    mix_launches = dict(fa.LAUNCHES)
    dloss = [abs(a - b) / (1 + abs(b)) for a, b in mix_loss]
    log(f"ivlp: {N_MIX_STEPS} mixup steps, lam {[round(float(x), 4) for x in lams]}: losses (kernel, plain) "
        f"{[[round(x, 5) for x in p] for p in mix_loss]}; max |dloss|/(1+|loss|) {max(dloss):.3e}; "
        f"launches {mix_launches}")
    if not all(np.isfinite(mix_loss).flatten()) or max(dloss) > DLOSS:
        raise SystemExit("FAIL: ivlp: kernel and plain mixup steps disagree")
    _others_silent(mix_launches, "blockwise", "the IVLP mixup steps")
    for kern, k in per_step.items():  # the plain trainer launches none
        if mix_launches[kern] != k * N_MIX_STEPS:
            raise SystemExit(f"FAIL: {kern} launched {mix_launches[kern]} times over the mixup "
                             f"steps, expected {k * N_MIX_STEPS}")
    kt.draw_epoch_lams()  # as run_epoch does at an epoch's start: one copy to the device
    _no_sync_step("ivlp (mixup on the trainer's own draws)", kt.train_step_resident, index)
    # an epoch of mixup steps on the trainer's own draws, fused against step by step
    fused, _ = _fused_vs_eager("ivlp mixup", kt, 1, per_step, BW_GROUPS)
    _profile(f"one IVLP KD train step, batch {TRAIN_BATCH}", lambda: kt.train_step_resident(index),
             top=30, groups=BW_GROUPS)
    return fused["on"], launches


COOP_RECIPE = "configs/trainers/CoOp/vit_b16_ep50.yaml"
COCOOP_RECIPE = "configs/trainers/CoCoOp/vit_b16_c4_ep10_batch1.yaml"
N_TEST = 200  # test() images (the first of the train cache; labels from seed 1234)
REMAT_BATCH, N_REMAT_STEPS = 48, 2  # CoCoOp's class-chunked steps under TRAIN.REMAT


def _recipe_cfg(recipe):
    """A recipe's override list on get_cfg_default() at the smoke run's
    size: SEED 0, bf16 frozen towers (PREC bf16 is the recipe's), DEVICE_AUG,
    TRAIN_EPOCHS epochs (a depth cut of the recipes' 50 and 10)."""
    from fsvlm_tpu_torch.config import RECIPES, get_cfg_default

    cfg = get_cfg_default()
    cfg.merge_from_list(RECIPES[recipe])
    cfg.merge_from_list(["SEED", 0, "MODEL.FROZEN_DTYPE", "bf16", "DATALOADER.DEVICE_AUG", True,
                         "OPTIM.MAX_EPOCH", TRAIN_EPOCHS])
    return cfg


def _fused_per_step(clip_cfg, text_passes, text_recomputes=0):
    """Launches per train step of the whole-sequence kernels, derived from
    the code: the image tower's forward (no gradient: the ViT's layers once)
    and ``text_passes`` text-tower passes, forward and backward, each text
    layer's forward run 1 + ``text_recomputes`` times (checkpointing
    recomputes through the same kernel)."""
    from fsvlm_tpu_torch.ops import flash_attention as fa

    n_text = clip_cfg.transformer_layers * text_passes
    return {fa.FUSED_KERNEL: clip_cfg.vision_layers + n_text * (1 + text_recomputes),
            fa.FUSED_KERNEL_STATS: n_text, fa.FUSED_KERNEL_DKV: n_text, fa.FUSED_KERNEL_DQ: n_text}


def _coop_test(kt, pt, cache):
    """test() on N_TEST uint8 images at TEST batch 100 through both paths on
    the kernel path's trained ctx (copied into the plain trainer), and once
    more on the plain path in fp32: the text features once; max |dlogit| at
    most MAX_DLOGIT, and the kernel path's distance to the fp32 logits at
    most BF16_NOISE_RATIO times the plain bf16 path's (phase 6's noise rule:
    CoOp's 100 prompts share their 16 context tokens, so the logit spread
    between classes, phase 4's yardstick, is about a tenth of serving's);
    top-1 agreement on every image whose top-1/top-2 margin exceeds twice
    the largest |dlogit|."""
    from fsvlm_tpu_torch.ops import flash_attention as fa

    n_batches = -(-N_TEST // kt.cfg.DATALOADER.TEST.BATCH_SIZE)
    want = {fa.FUSED_KERNEL: kt.clip.cfg.transformer_layers + n_batches * kt.clip.cfg.vision_layers}
    return _split_eval_test("coop test()", kt, pt, cache, kt.cfg.TRAINER.COOP, want, "fused_attn")


def _split_eval_test(label, kt, pt, cache, node, want, family):
    """_coop_test's run and rules for any trainer with a split eval whose
    PREC lies in ``node``: the nonzero launches of the kernel run must be
    ``want``, and kernels outside ``family`` must not launch."""
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa

    with torch.no_grad():
        for k in pt.params:
            pt.params[k].copy_(kt.params[k])
    labels = np.random.RandomState(1234).randint(0, N_CLASSES, N_TEST)
    runs = {}  # node.PREC is read by both trainers' compute_dtype()
    for name, t, prec in (("kernel", kt, "bf16"), ("plain", pt, "bf16"), ("plain fp32", pt, "fp32")):
        seen = {"text": [], "logits": []}
        text_fn, image_fn = t.text_features_fn, t.image_logits_fn
        t.text_features_fn = lambda *a, f=text_fn, c=seen: c["text"].append(f(*a)) or c["text"][-1]
        t.image_logits_fn = lambda *a, f=image_fn, c=seen: c["logits"].append(f(*a)) or c["logits"][-1]
        node.PREC = prec
        torch.cuda.synchronize()
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        t0 = time.perf_counter()
        acc = t.test(cache[:N_TEST], labels)
        torch.cuda.synchronize()
        runs[name] = (acc, seen, dict(fa.LAUNCHES), (time.perf_counter() - t0) * 1e3)
        del t.text_features_fn, t.image_logits_fn  # the trainer's own methods again
    node.PREC = "bf16"
    (k_acc, k_seen, launches, k_ms), (p_acc, p_seen, _, p_ms) = runs["kernel"], runs["plain"]
    n_batches = -(-N_TEST // kt.cfg.DATALOADER.TEST.BATCH_SIZE)
    k_log, p_log, f_log = (torch.cat(runs[n][1]["logits"]).float()
                           for n in ("kernel", "plain", "plain fp32"))
    cos_txt = torch.nn.functional.cosine_similarity(k_seen["text"][0].float(),
                                                    p_seen["text"][0].float(), dim=-1)
    dlog = (k_log - p_log).abs().amax(dim=-1)
    noise_k, noise_p = ((x - f_log).abs().max().item() for x in (k_log, p_log))
    spread = p_log.std(dim=-1)
    top2 = p_log.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * dlog.max()
    flips = int((decided & (k_log.argmax(-1) != p_log.argmax(-1))).sum())
    log(f"{label}: {N_TEST} images in {n_batches} batches; accuracy kernel {k_acc:.1f}%, plain "
        f"{p_acc:.1f}%, plain fp32 {runs['plain fp32'][0]:.1f}%; {k_ms:.1f} / {p_ms:.1f} ms; text "
        f"feature passes {len(k_seen['text'])}; min text cosine {cos_txt.min().item():.6f}; max "
        f"|dlogit| {dlog.max().item():.4f}; max |dlogit| to the fp32 logits: kernel {noise_k:.4f}, "
        f"plain bf16 {noise_p:.4f}; logit spread between classes {spread.min().item():.4f}-"
        f"{spread.max().item():.4f} (max |dlogit|/spread {(dlog / spread).max().item():.4f}); images "
        f"past the 2 x max|dlogit| margin {int(decided.sum())}, near ties {int((~decided).sum())}, "
        f"top-1 flips past the margin {flips}; launches {launches}")
    _others_silent(launches, family, label)
    if ({k: n for k, n in launches.items() if n} != want or len(k_seen["text"]) != 1
            or len(k_seen["logits"]) != n_batches or k_log.shape != (N_TEST, N_CLASSES)
            or not torch.isfinite(k_log).all() or cos_txt.min().item() < MIN_COSINE
            or dlog.max().item() > MAX_DLOGIT or noise_k > BF16_NOISE_RATIO * noise_p or flips):
        raise SystemExit(f"FAIL: {label}: kernel and plain paths disagree, or the launches "
                         f"are not {want}")
    return k_ms


def _cocoop_remat(clip, cache, labels):
    """CoCoOp at batch REMAT_BATCH under TRAIN.REMAT: B * n_cls past
    BATCHED_TEXT_LIMIT, so the class-chunked path with every block and text
    layer rematerialized; the first-step gradients and N_REMAT_STEPS steps
    against the plain attention on shared boxes and flips.  Each tensor's
    total change must reach MIN_DELTA_COSINE against the plain path's, or,
    where bf16 rounding alone takes it below that, stay within phase 6's
    noise rule: its distance (1 - cosine) to a third run's, the plain path
    in fp32, at most BF16_NOISE_RATIO times the plain bf16 path's."""
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.ops.preprocess import sample_crop_boxes, sample_flips
    from fsvlm_tpu_torch.trainers import cocoop

    cfg = _recipe_cfg(COCOOP_RECIPE)
    cfg.merge_from_list(["DATALOADER.TRAIN_X.BATCH_SIZE", REMAT_BATCH, "TRAIN.REMAT", True])
    classnames = [f"class {i}" for i in range(N_CLASSES)]
    kt = cocoop.CoCoOp(cfg, classnames, cache, labels, clip=clip, device="cuda",
                       steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    pt = cocoop.CoCoOp(cfg, classnames, cache, labels, clip=clip, device="cuda",
                       steps_per_epoch=TRAIN_STEPS_PER_EPOCH, attn_impl="plain")
    cfg32 = _recipe_cfg(COCOOP_RECIPE)
    cfg32.merge_from_list(["DATALOADER.TRAIN_X.BATCH_SIZE", REMAT_BATCH, "TRAIN.REMAT", True,
                           "TRAINER.COCOOP.PREC", "fp32"])
    ft = cocoop.CoCoOp(cfg32, classnames, cache, labels, clip=clip, device="cuda",
                       steps_per_epoch=TRAIN_STEPS_PER_EPOCH, attn_impl="plain")
    chunk = kt.class_chunk_for(REMAT_BATCH)
    n_blocks = -(-N_CLASSES // chunk)
    log(f"cocoop remat: batch {REMAT_BATCH} x {N_CLASSES} classes = {REMAT_BATCH * N_CLASSES} text "
        f"sequences > BATCHED_TEXT_LIMIT {cocoop.BATCHED_TEXT_LIMIT}: {n_blocks} blocks of {chunk} "
        f"classes ({n_blocks * chunk - N_CLASSES} padded), each a ({REMAT_BATCH * chunk}, 8, "
        f"{kt.frozen['base_embed'].shape[1]}) text pass")
    if not (REMAT_BATCH * N_CLASSES > cocoop.BATCHED_TEXT_LIMIT and 1 < n_blocks and kt.remat):
        raise SystemExit("FAIL: cocoop remat: the step is not on the class-chunked remat path")
    _grad_agreement("cocoop remat", kt, pt, cfg.TRAINER.COCOOP,
                    _augmented_batch(cache, labels, 12, REMAT_BATCH))
    per_step = _fused_per_step(clip.cfg, n_blocks, text_recomputes=2)
    init = {k: v.detach().clone() for k, v in kt.params.items()}
    gen = torch.Generator(device="cuda").manual_seed(13)
    losses, step_ms, peak = [], [], 0
    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
    for step in range(N_REMAT_STEPS):
        idx = torch.arange(step * REMAT_BATCH, (step + 1) * REMAT_BATCH, device="cuda")
        aug = (sample_crop_boxes(REMAT_BATCH, 224, 224, (0.08, 1.0), gen), sample_flips(REMAT_BATCH, gen))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        k_loss = kt.train_step_resident(idx, aug=aug)["loss"].item()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        peak = max(peak, torch.cuda.max_memory_allocated())
        losses.append((k_loss, pt.train_step_resident(idx, aug=aug)["loss"].item()))
        ft.train_step_resident(idx, aug=aug)
    launches = dict(fa.LAUNCHES)
    dloss = [abs(a - b) / (1 + abs(b)) for a, b in losses]
    change = {name: {k: t.params[k].detach() - init[k] for k in init}
              for name, t in (("kernel", kt), ("plain", pt), ("fp32", ft))}
    cos = {pair: {k: _cosine(change[pair[0]][k], change[pair[1]][k]) for k in init}
           for pair in (("kernel", "plain"), ("kernel", "fp32"), ("plain", "fp32"))}
    delta_ok = all(cos["kernel", "plain"][k] >= MIN_DELTA_COSINE
                   or 1 - cos["kernel", "fp32"][k] <= BF16_NOISE_RATIO * (1 - cos["plain", "fp32"][k])
                   for k in init)
    log(f"cocoop remat: losses (kernel, plain) {[[round(x, 5) for x in p] for p in losses]}; max "
        f"|dloss|/(1+|loss|) {max(dloss):.3e}; step ms (kernel) {[round(x, 1) for x in step_ms]}; "
        f"peak memory of a kernel step {peak / 2**30:.2f} GiB; launches over {N_REMAT_STEPS} steps "
        f"{launches}, expected per step {per_step}")
    for (a, b), c in cos.items():
        log(f"cocoop remat: cosine of each tensor's total change, {a} against {b}: "
            + ", ".join(f"{k} {v:.7f}" for k, v in c.items()))
    _others_silent(launches, "fused_attn", "the cocoop remat path")
    if (not np.isfinite(losses).all() or max(dloss) > DLOSS or not delta_ok
            or any(launches[k] != n * N_REMAT_STEPS for k, n in per_step.items())):
        raise SystemExit("FAIL: cocoop remat: kernel and plain paths disagree, or the launches "
                         "are not the derived counts")
    _profile(f"one CoCoOp step under TRAIN.REMAT, batch {REMAT_BATCH}",
             lambda: kt.train_step_resident(torch.arange(REMAT_BATCH, device="cuda")), top=12,
             groups=FUSED_GROUPS)
    # past BATCHED_TEXT_LIMIT the trainer vetoes EPOCH_FUSE "auto" (as JAX's);
    # "on" overrides it: an epoch fused against step by step
    if not (kt._epoch_fuse_auto_off and not kt.fuses_epoch()):
        raise SystemExit("FAIL: cocoop remat: EPOCH_FUSE auto is not vetoed past the limit")
    log("cocoop remat: EPOCH_FUSE auto vetoed past BATCHED_TEXT_LIMIT; \"on\" below overrides it")
    kt.cfg.TRAIN.EPOCH_FUSE = "on"
    if not kt.fuses_epoch():
        raise SystemExit("FAIL: cocoop remat: EPOCH_FUSE on does not override the veto")
    _fused_vs_eager("cocoop remat (EPOCH_FUSE on)", kt, 1, per_step, FUSED_GROUPS)


@_timed
def phase_coop_cocoop(clip):
    """Phase 8, under FSVLM_FORCE_PALLAS=legacy (the caller sets it): CoOp
    and CoCoOp ViT-B/16 from their recipes through the whole-sequence
    kernels #1-#2 and through their plain versions; CoOp's test()."""
    import torch

    from fsvlm_tpu_torch.trainers.cocoop import CoCoOp
    from fsvlm_tpu_torch.trainers.coop import CoOp

    classnames = [f"class {i}" for i in range(N_CLASSES)]
    cache, labels = _train_cache()

    cfg = _recipe_cfg(COOP_RECIPE)
    batch = cfg.DATALOADER.TRAIN_X.BATCH_SIZE
    kt = CoOp(cfg, classnames, cache, labels, clip=clip, device="cuda",
              steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    pt = CoOp(cfg, classnames, cache, labels, clip=clip, device="cuda",
              steps_per_epoch=TRAIN_STEPS_PER_EPOCH, attn_impl="plain")
    log(f"coop: {COOP_RECIPE}: N_CTX {cfg.TRAINER.COOP.N_CTX}, batch {batch}, LR {cfg.OPTIM.LR}, "
        f"text L={kt.frozen['base_embed'].shape[1]}")
    _grad_agreement("coop", kt, pt, cfg.TRAINER.COOP, _augmented_batch(cache, labels, 10, batch))
    per_step = _fused_per_step(clip.cfg, 1)
    launches, _, _ = _train_both("coop", kt, pt, per_step, "fused_attn", batch)
    index = kt.epoch_schedule()[0][0]
    _no_sync_step("coop", kt.train_step_resident, index)
    _profile(f"one CoOp train step, batch {batch}", lambda: kt.train_step_resident(index), top=20,
             groups=FUSED_GROUPS)
    _coop_test(kt, pt, cache)
    fused, _ = _fused_vs_eager("coop", kt, 1, per_step, FUSED_GROUPS)
    kt.cfg.TRAINER.COOP.LOSS_TYPE = "focal"  # the trainer reads it at build
    with contextlib.redirect_stdout(io.StringIO()):
        ft = CoOp(kt.cfg, classnames, cache, labels, clip=clip, device="cuda",
                  steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    if ft.loss_type != "focal":
        raise SystemExit("FAIL: coop: LOSS_TYPE focal did not build the focal loss")
    _fused_vs_eager("coop focal", ft, 1, per_step, FUSED_GROUPS)
    del kt, pt, ft

    cfg = _recipe_cfg(COCOOP_RECIPE)
    batch = cfg.DATALOADER.TRAIN_X.BATCH_SIZE
    kt = CoCoOp(cfg, classnames, cache, labels, clip=clip, device="cuda",
                steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    pt = CoCoOp(cfg, classnames, cache, labels, clip=clip, device="cuda",
                steps_per_epoch=TRAIN_STEPS_PER_EPOCH, attn_impl="plain")
    log(f"cocoop: {COCOOP_RECIPE}: N_CTX {cfg.TRAINER.COCOOP.N_CTX}, batch {batch} "
        f"(the batched path: {batch * N_CLASSES} text sequences), text "
        f"L={kt.frozen['base_embed'].shape[1]}")
    _grad_agreement("cocoop", kt, pt, cfg.TRAINER.COCOOP, _augmented_batch(cache, labels, 11, batch))
    _train_both("cocoop", kt, pt, _fused_per_step(clip.cfg, 1), "fused_attn", batch)
    index = kt.epoch_schedule()[0][0]
    _profile(f"one CoCoOp train step, batch {batch}", lambda: kt.train_step_resident(index), top=12,
             groups=FUSED_GROUPS)
    del kt, pt
    torch.cuda.empty_cache()
    _cocoop_remat(clip, cache, labels)
    return fused["on"], launches


CLI_RECIPE = "configs/trainers/PromptSRC/vit_b16_c2_ep20_batch4_4+4ctx.yaml"
CLI_PER_CLASS_SHOTS = [16, 16, 16, 8, 8, 4, 2, 1]
CLI_EPOCHS = 2
CACHED_STEPS = 10  # timed batch-48 steps per side, in turns


def _run_cli(clip, argv):
    """``fsvlm_tpu_torch.train.main`` on ``argv`` with ``clip``; its output
    goes to its log.txt only (the end of it is printed if it raises).
    Returns the trainer."""
    from fsvlm_tpu_torch.train import build_argparser, main

    console = io.StringIO()
    try:
        with contextlib.redirect_stdout(console):
            return main(build_argparser().parse_args(argv), clip=clip)
    except BaseException:
        print(console.getvalue()[-4000:], flush=True)
        raise


@contextlib.contextmanager
def _epochs_timed(cls, out):
    """Append to ``out`` the ms of each ``cls.run_epoch`` that runs inside the
    block (a CLI run's own epochs, as train() ran them; run_epoch reads its
    metrics back at its end)."""
    run_epoch = cls.run_epoch

    def timed(self):
        t0 = time.perf_counter()
        try:
            return run_epoch(self)
        finally:
            out.append((time.perf_counter() - t0) * 1e3)

    cls.run_epoch = timed
    try:
        yield out
    finally:
        cls.run_epoch = run_epoch


def _cli(clip, out_dir, *flags):
    """Run the port's CLI (phase 9's configuration) on ``clip`` into
    ``out_dir``.  Returns the trainer."""
    return _run_cli(clip, [
        "--trainer", "PromptSRC", "--seed", "1", "--device", "cuda",
        "--dataset-config-file", "configs/datasets/synthetic.yaml", "--config-file", CLI_RECIPE,
        "--output-dir", out_dir, *flags,
        "MODEL.FROZEN_DTYPE", "bf16", "TRAINER.PROMPTSRC.PREC", "bf16",
        "DATASET.NUM_SHOTS", "-1", "DATASET.PER_CLASS_SHOTS", str(CLI_PER_CLASS_SHOTS),
        "DATALOADER.TRAIN_X.SAMPLER", "WeightedClassSampler", "DATALOADER.DEVICE_AUG", "True",
        "TRAINER.PROMPTSRC.CACHED_TEACHER", "True", "TEST.FINAL_MODEL", "best_val",
        "TRAIN.CHECKPOINT_FREQ", "1", "OPTIM.MAX_EPOCH", str(CLI_EPOCHS)])


def _read(path):
    with open(path) as f:
        return f.read()


def _max_abs(a, b):
    import torch

    a, b = (torch.as_tensor(np.asarray(x, np.float64)) for x in (a, b))
    return float((a - b).abs().max()) if a.numel() else 0.0


def _cli_expected_launches(t, clip_cfg, epochs=CLI_EPOCHS, steps=None):
    """#6-#8 over the CLI run, from the code: the teacher text features
    (PromptSRC.build_model) and the teacher cache pass (one vision pass per
    batch of min(64, N)); per step the student text and vision towers
    forward and backward (no teacher pass under CACHED_TEACHER); per test()
    one text pass and one vision pass per batch: the val set after each
    epoch (best_val), then the test set twice (after_train, and the CLI's
    report).  ``steps``: the train steps counted (default all; the wrappers'
    counts leave out a fused epoch's replays, ``_wrapped_steps``)."""
    from fsvlm_tpu_torch.ops import flash_attention as fa

    Lt, Lv = clip_cfg.transformer_layers, clip_cfg.vision_layers
    ds = t.dm.dataset
    n_train, B_test = len(ds.train_x), t.cfg.DATALOADER.TEST.BATCH_SIZE
    cache_batches = -(-n_train // min(64, n_train))
    if steps is None:
        steps = t.steps_per_epoch * epochs

    def test_pass(n):
        return Lt + -(-n // B_test) * Lv

    fwd = (Lt + cache_batches * Lv + steps * (Lt + Lv) + epochs * test_pass(len(ds.val))
           + 2 * test_pass(len(ds.test)))
    return {fa.KERNEL: fwd, fa.KERNEL_DKV: steps * (Lt + Lv), fa.KERNEL_DQ: steps * (Lt + Lv)}


def _resumed_trace(t, clip_cfg, prof):
    """Phase 9's resumed run: #6-#8 among the kernel events of its
    FSVLM_PROFILE_DIR trace (epoch 2 fused: a warm-up step, the capture and
    a replay a step, then the val pass) at the derived counts, and one
    cudaGraphLaunch per replay (``engine/fused.py``'s STEPS)."""
    from fsvlm_tpu_torch.engine import fused

    traces = os.listdir(prof)
    if len(traces) != 1:
        raise SystemExit(f"FAIL: cli: FSVLM_PROFILE_DIR holds {traces}, not one trace")
    counts, n_kernels, graphs = _trace_kernel_counts(os.path.join(prof, traces[0]),
                                                     FLASH_GROUPS)
    Lt, Lv = clip_cfg.transformer_layers, clip_cfg.vision_layers
    steps, n_val = t.steps_per_epoch, len(t.dm.dataset.val)
    val = Lt + -(-n_val // t.cfg.DATALOADER.TEST.BATCH_SIZE) * Lv  # text once, vision per batch
    want = {"#6": steps * (Lt + Lv) + val, "#7": steps * (Lt + Lv), "#8": steps * (Lt + Lv)}
    fsteps = dict(fused.STEPS)
    log(f"cli: the resumed run's FSVLM_PROFILE_DIR trace ({n_kernels} kernel events): #6-#8 "
        f"{counts}, expected {want} ({steps} steps of epoch 2 and its val pass); {graphs} "
        f"cudaGraphLaunch; fused steps {fsteps}")
    if (counts != want or fsteps != {"eager": 1, "captured": 1, "replays": steps - 1}
            or graphs != steps - 1):
        raise SystemExit("FAIL: cli: the resumed run's trace does not hold every step's kernels "
                         "or one graph launch per replay")


def _cached_teacher_steps(clip):
    """Phase 6's PromptSRC step (batch 48, 100 classes, DEVICE_AUG) with and
    without CACHED_TEACHER, stepped in turns: launches of one step, step ms
    synced (median), device busy of one profiled step, peak memory of one
    step (both trainers resident)."""
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.trainers.promptsrc import PromptSRC

    cache, labels = _train_cache()
    classnames = [f"class {i}" for i in range(N_CLASSES)]
    trainers, out = {}, {}
    for cached in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = PromptSRC(_train_cfg("PROMPTSRC"), classnames, cache, labels, clip=clip,
                      device="cuda", steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
        if cached:
            # the tensor-fed trainer has no DataManager: its teacher cache is
            # built here, from the eval view of the 224-pixel cache at INPUT.SIZE
            # 224 (the image itself), in eval_view_batches' batches of 64
            n, views = len(cache), cache.cpu().numpy()
            t.frozen["zs_img_cache"] = t.build_teacher_cache(n, (
                {"img": views[i:i + 64], "index": np.arange(i, min(i + 64, n)),
                 "valid": np.ones(min(64, n - i), bool)} for i in range(0, n, 64)))
            t.cached_teacher = True
        torch.cuda.synchronize()
        trainers[cached] = (t, t.epoch_schedule()[0][0])
        out[cached] = {"build_s": time.perf_counter() - t0, "ms": []}
        t.train_step_resident(trainers[cached][1])  # warm-up
    Lt, Lv = clip.cfg.transformer_layers, clip.cfg.vision_layers
    for cached, (t, index) in trainers.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        t.train_step_resident(index)
        torch.cuda.synchronize()
        out[cached]["peak"] = torch.cuda.max_memory_allocated()
        got = {k: n for k, n in fa.LAUNCHES.items() if n}
        want = {fa.KERNEL: Lt + Lv + (0 if cached else Lv), fa.KERNEL_DKV: Lt + Lv,
                fa.KERNEL_DQ: Lt + Lv}
        if got != want:
            raise SystemExit(f"FAIL: cli: one PromptSRC step (CACHED_TEACHER {cached}) launched "
                             f"{got}, expected {want}")
        out[cached]["launches"] = got
    for i in range(CACHED_STEPS):
        for cached in ((False, True) if i % 2 == 0 else (True, False)):
            t, index = trainers[cached]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.train_step_resident(index)
            torch.cuda.synchronize()
            out[cached]["ms"].append((time.perf_counter() - t0) * 1e3)
    for cached, (t, index) in trainers.items():
        out[cached]["wall"], out[cached]["busy"] = _profile(
            f"one PromptSRC train step, batch {TRAIN_BATCH}, CACHED_TEACHER {cached}",
            lambda: t.train_step_resident(index), top=8, groups=FLASH_GROUPS)
    for cached in (False, True):
        o = out[cached]
        med = float(np.median(o["ms"]))
        log(f"cli: PromptSRC step batch {TRAIN_BATCH}, CACHED_TEACHER {cached}: step ms synced "
            f"{[round(x, 2) for x in o['ms']]} (median {med:.2f}, {TRAIN_BATCH / med * 1e3:.1f} "
            f"images/s); device busy {o['busy']:.3f} ms of {o['wall']:.3f} ms profiled (idle "
            f"{max(0.0, 1 - o['busy'] / o['wall']):.3f}); peak memory {o['peak'] / 2**30:.2f} GiB; "
            f"launches per step {o['launches']}; trainer built in {o['build_s']:.2f} s")


@_timed
def phase_cli(clip):
    """The port's CLI end to end on the card (module docstring, phase 9)."""
    import torch

    from fsvlm_tpu_torch.engine.checkpoint import flatten
    from fsvlm_tpu_torch.engine.trainer import SimpleTrainer
    from fsvlm_tpu_torch.ops import flash_attention as fa

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        out = os.path.join(work, "run")
        torch.cuda.synchronize()
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        _zero_fused_steps()
        t0 = time.perf_counter()
        t = _cli(clip, out)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        ds = t.dm.dataset
        total = t.steps_per_epoch * CLI_EPOCHS
        wrapped, fsteps = _wrapped_steps("cli", total)
        log(f"cli: {CLI_RECIPE} on Synthetic: train_x {len(ds.train_x)} (per class "
            f"{CLI_PER_CLASS_SHOTS}), val {len(ds.val)}, test {len(ds.test)}; "
            f"{t.steps_per_epoch} steps of {t.batch_size} per epoch, {CLI_EPOCHS} epochs; "
            f"run {run_s:.1f} s; fused steps {fsteps}; wrapper calls {launches}")

        # the log contract
        text = _read(os.path.join(out, "log.txt"))
        for needle in ("=> result", "* accuracy:", "Classification Report", "Finish training",
                       "Deploy the model with the best val performance",
                       "[PromptSRC] cached teacher image features",
                       "* device-resident train set", "Using GPA model for final inference"):
            if needle not in text:
                raise SystemExit(f"FAIL: cli: log.txt lacks {needle!r}")
        mdir = os.path.join(out, "VLPromptLearner")
        files = set(os.listdir(mdir))
        want = {"checkpoint", "model-best.pkl", "model.pkl-1", "model.pkl-2"}
        if not want <= files or _read(os.path.join(mdir, "checkpoint")).strip() != "model.pkl-2":
            raise SystemExit(f"FAIL: cli: checkpoint files {sorted(files)}")
        seed_dir = os.path.join(work, "agg", "seed1")
        os.makedirs(seed_dir)
        shutil.copy(os.path.join(out, "log.txt"), seed_dir)
        agg = subprocess.run([sys.executable, "parse_test_res.py", os.path.dirname(seed_dir)],
                             capture_output=True, text=True, timeout=120)
        if agg.returncode != 0 or "* accuracy:" not in agg.stdout:
            raise SystemExit(f"FAIL: cli: parse_test_res.py: {agg.stdout}{agg.stderr}")
        accs = [float(x) for x in re.findall(r"\* accuracy: ([\d.]+)%", text)]
        log(f"cli: log contract holds; accuracies in log.txt (val, val, test, test) {accs}; "
            f"parse_test_res.py: {agg.stdout.strip().splitlines()[-1]}")

        # launches of #6-#8, from the code: the wrappers' calls, the epochs
        # fused (TRAIN.EPOCH_FUSE auto: one capture, then a replay a step,
        # which calls no wrapper; the resumed run below counts the replays'
        # kernels in its trace)
        expected = _cli_expected_launches(t, clip.cfg, steps=wrapped)
        _others_silent(launches, "flash_attn", "the CLI run")
        if (any(launches[k] != n for k, n in expected.items())
                or fsteps != {"eager": 1, "captured": 1, "replays": total - 1}):
            raise SystemExit(f"FAIL: cli: launches {launches}, expected {expected}; fused steps "
                             f"{fsteps}, expected one capture")
        log(f"cli: #6-#8 wrapper calls the expected {expected}")

        # the teacher cache against the plain attention; its build time
        kernel_cache = t.frozen["zs_img_cache"]
        t.attn_impl = "plain"
        plain_cache = t.build_teacher_cache(*t.eval_view_batches())
        t.attn_impl = None
        cos = torch.nn.functional.cosine_similarity(kernel_cache, plain_cache, dim=-1).min().item()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.build_teacher_cache(*t.eval_view_batches())
        torch.cuda.synchronize()
        cache_ms = (time.perf_counter() - t0) * 1e3
        epoch_ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                t.run_epoch()
            torch.cuda.synchronize()
            epoch_ms.append((time.perf_counter() - t0) * 1e3)
        n_img = t.steps_per_epoch * t.batch_size
        log(f"cli: teacher cache ({tuple(kernel_cache.shape)}) min cosine to the plain-attention "
            f"cache {cos:.6f} (limit {MIN_COSINE}); build {cache_ms:.1f} ms; epoch ms "
            f"{[round(x, 1) for x in epoch_ms]} ({n_img} images, "
            f"{n_img / min(epoch_ms) * 1e3:.1f} images/s)")
        if cos < MIN_COSINE:
            raise SystemExit("FAIL: cli: the teacher cache disagrees with the plain attention")

        # resume from a copy whose pointer names model.pkl-1
        resumed = os.path.join(work, "resumed")
        shutil.copytree(out, resumed)
        with open(os.path.join(resumed, "VLPromptLearner", "checkpoint"), "w") as f:
            f.write("model.pkl-1")
        with open(os.path.join(resumed, "VLPromptLearner", "model.pkl-1"), "rb") as f:
            saved = pickle.load(f)
        restored = {}
        resume = SimpleTrainer.resume_model_if_exist

        def spy(self, directory):
            start = resume(self, directory)
            restored.update(
                start=start, params={k: v.detach().cpu().clone() for k, v in self.params.items()},
                trace={k: x.cpu().clone() for k, x in zip(self.params, self.optim.trace)},
                count=int(self.optim.count), generator=self.generator.get_state().numpy(),
                gpa={k: v.cpu().clone() for k, v in (self.gpa_params or {}).items()})
            return start

        SimpleTrainer.resume_model_if_exist = spy
        # under FSVLM_PROFILE_DIR: its window (before_train to the start of
        # after_train) holds epoch 2, fused, and its val pass
        prof, env_prof = os.path.join(work, "profile"), os.environ.get("FSVLM_PROFILE_DIR")
        os.environ["FSVLM_PROFILE_DIR"] = prof
        _zero_fused_steps()
        try:
            t2 = _cli(clip, resumed)
        finally:
            SimpleTrainer.resume_model_if_exist = resume
            if env_prof is None:
                del os.environ["FSVLM_PROFILE_DIR"]
            else:
                os.environ["FSVLM_PROFILE_DIR"] = env_prof
        _resumed_trace(t2, clip.cfg, prof)
        sd, opt, extra = flatten(saved["state_dict"]), saved["optimizer"], saved["extra"]
        diffs = {
            "prompts": max(_max_abs(restored["params"][k], sd[k]) for k in sd),
            "momentum": max(_max_abs(restored["trace"][k], opt["trace"][k]) for k in opt["trace"]),
            "step count": abs(restored["count"] - int(opt["count"])),
            "generator": _max_abs(restored["generator"], extra["rng_state"]),
            "GPA": max(_max_abs(restored["gpa"][k], v) for k, v in extra["gpa_params"].items()),
        }
        rtext = "".join(_read(os.path.join(resumed, f)) for f in os.listdir(resumed)
                        if f.startswith("log.txt-"))
        log(f"cli: resumed from model.pkl-1 at epoch {restored['start']}; max abs difference to "
            f"the checkpoint: {diffs}; the rerun trained {t2.epoch + 1 - restored['start']} "
            f"epoch(s)")
        if (restored["start"] != 1 or any(diffs.values()) or t2.epoch != CLI_EPOCHS - 1
                or f"epoch [{CLI_EPOCHS}/{CLI_EPOCHS}]" not in rtext or "epoch [1/" in rtext
                or "Finish training" not in rtext):
            raise SystemExit("FAIL: cli: the resumed run did not restore the checkpoint exactly "
                             "or did not finish")

        # --eval-only --load-epoch 2 against the epoch-2 model's test()
        t.load_model(out, epoch=CLI_EPOCHS)
        with contextlib.redirect_stdout(io.StringIO()):
            want_true, want_pred = t.test(return_pred=True)
        t3 = _cli(clip, os.path.join(work, "eval"), "--eval-only", "--model-dir", out,
                  "--load-epoch", str(CLI_EPOCHS))
        acc = [float(x) for x in re.findall(r"\* accuracy: ([\d.]+)%",
                                            _read(os.path.join(work, "eval", "log.txt")))]
        want_acc = 100.0 * float(np.mean(np.asarray(want_true) == np.asarray(want_pred)))
        log(f"cli: --eval-only --load-epoch {CLI_EPOCHS}: accuracy {acc} against the epoch-"
            f"{CLI_EPOCHS} model's {want_acc:.4f}%; predictions equal "
            f"{t3.evaluator.y_pred == want_pred}")
        if t3.evaluator.y_pred != want_pred or t3.evaluator.y_true != want_true:
            raise SystemExit("FAIL: cli: --eval-only did not reproduce the epoch-2 predictions")
        del t, t2, t3
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _cached_teacher_steps(clip)
    return launches


LORA_RECIPE = "configs/trainers/LoRA/vit_b16_ep10_batch32.yaml"
MAPLE_RECIPE = "configs/trainers/MaPLe/vit_b16_c2_ep5_batch4_2ctx.yaml"
LP_RECIPE = "configs/trainers/LinearProbeCLIP/vit_b16_ep50.yaml"
MAPLE_BATCH = 48  # bench.py's batch (the recipe's 4)
LORA_CLI_SHOTS = 16  # Synthetic: 8 classes x 16 = 128 train images, 4 steps of 32 per epoch


def _yaml_cfg(recipe, *opts):
    """A recipe's yaml file on defaults.py (get_cfg_base, as the CLI reads
    it) at the smoke run's size: SEED 0, bf16 frozen towers (the recipes'
    PREC is bf16), DEVICE_AUG, TRAIN_EPOCHS epochs; then ``opts``."""
    from fsvlm_tpu_torch.config import get_cfg_base

    cfg = get_cfg_base()
    cfg.merge_from_file(recipe)
    cfg.merge_from_list(["SEED", 0, "MODEL.FROZEN_DTYPE", "bf16", "DATALOADER.DEVICE_AUG", True,
                         "OPTIM.MAX_EPOCH", TRAIN_EPOCHS, *opts])
    return cfg


def _step_summary(label, kt, batch, step_ms, peak):
    """Median synced step ms (steps 2-6 of _train_both), images/s, peak
    memory, and one profiled step's device busy and idle share."""
    index = kt.epoch_schedule()[0][0]
    _no_sync_step(label, kt.train_step_resident, index)
    wall, busy = _profile(f"one {label} train step, batch {batch}",
                          lambda: kt.train_step_resident(index), top=20, groups=FLASH_GROUPS)
    med = float(np.median(step_ms[1:]))
    log(f"{label}: step {med:.2f} ms median synced, {batch / med * 1e3:.1f} images/s, peak memory "
        f"{peak / 2**30:.2f} GiB, device busy {busy:.3f} ms of {wall:.3f} ms profiled (idle "
        f"{max(0.0, 1 - busy / wall):.3f})")


def _lora_step(clip, cache, labels):
    """The CLIP-LoRA ViT-B/16 train step from LORA_RECIPE (module docstring,
    phase 10) through the kernels and through the plain attention."""
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.trainers.lora import DropoutDraws, LoRA

    cfg = _yaml_cfg(LORA_RECIPE)
    node, batch = cfg.TRAINER.LORA, cfg.DATALOADER.TRAIN_X.BATCH_SIZE
    classnames = [f"class {i}" for i in range(N_CLASSES)]
    kt = LoRA(cfg, classnames, cache, labels, clip=clip, device="cuda",
              steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    pt = LoRA(cfg, classnames, cache, labels, clip=clip, device="cuda",
              steps_per_epoch=TRAIN_STEPS_PER_EPOCH, attn_impl="plain")
    log(f"lora: {LORA_RECIPE}: ENCODER {node.ENCODER}, POSITION {node.POSITION}, PARAMS "
        f"{node.PARAMS}, r {node.R}, alpha {node.ALPHA} (scale {kt.scale:.6f}), DROPOUT_RATE "
        f"{node.DROPOUT_RATE}, SCL weights {node.TEXT_LOSS_WEIGHT}/{node.IMAGE_LOSS_WEIGHT}/"
        f"{node.LOGITS_LOSS_WEIGHT}, batch {batch}, LR {cfg.OPTIM.LR}; text L="
        f"{kt.frozen['fixed_prompts'].shape[1]}, vision L={clip.cfg.vision_seq_len}; remat on "
        f"both towers")
    if not (kt.use_dropout and set(kt.towers) == {"text", "vision"} and len(kt.params) == 12):
        raise SystemExit("FAIL: lora: the recipe's factors or dropout are not on the path")
    # at LoRA's own init B = 0, so A's first-step gradient is exactly 0: the
    # first-step check runs on a random nonzero B (the same in both), then B = 0
    gen = torch.Generator(device="cuda").manual_seed(21)
    with torch.no_grad():
        for k in kt.params:
            if k.endswith(".1"):
                b = 0.02 * torch.randn(kt.params[k].shape, generator=gen, device="cuda")
                kt.params[k].copy_(b)
                pt.params[k].copy_(b)
    first = _augmented_batch(cache, labels, 20, batch)
    first["drop"] = DropoutDraws(node.DROPOUT_RATE, kt.proj_names,
                                 torch.Generator(device="cuda").manual_seed(22))
    _grad_agreement("lora", kt, pt, node, first)
    with torch.no_grad():
        for k in kt.params:
            if k.endswith(".1"):
                kt.params[k].zero_()
                pt.params[k].zero_()
    Lt, Lv = clip.cfg.transformer_layers, clip.cfg.vision_layers
    # both towers rematerialized: each layer's forward again in the backward
    per_step = {fa.KERNEL: 2 * (Lt + Lv), fa.KERNEL_DKV: Lt + Lv, fa.KERNEL_DQ: Lt + Lv}
    launches, step_ms, peak = _train_both("lora", kt, pt, per_step, "flash_attn", batch)
    _step_summary("lora", kt, batch, step_ms, peak)
    _fused_vs_eager("lora (dropout draws)", kt, 1, per_step, FLASH_GROUPS)
    return launches


def _maple_step(clip, cache, labels):
    """The MaPLe ViT-B/16 train step from MAPLE_RECIPE at batch MAPLE_BATCH
    through the kernels and through the plain attention."""
    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.trainers.maple import MaPLe

    cfg = _yaml_cfg(MAPLE_RECIPE, "DATALOADER.TRAIN_X.BATCH_SIZE", MAPLE_BATCH)
    classnames = [f"class {i}" for i in range(N_CLASSES)]
    kt = MaPLe(cfg, classnames, cache, labels, clip=clip, device="cuda",
               steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    pt = MaPLe(cfg, classnames, cache, labels, clip=clip, device="cuda",
               steps_per_epoch=TRAIN_STEPS_PER_EPOCH, attn_impl="plain")
    node = cfg.TRAINER.MAPLE
    log(f"maple: {MAPLE_RECIPE}: N_CTX {node.N_CTX}, PROMPT_DEPTH {node.PROMPT_DEPTH}, batch "
        f"{MAPLE_BATCH} (the recipe's {4}), LR {cfg.OPTIM.LR}; text L="
        f"{kt.frozen['base_embed'].shape[1]}, vision L="
        f"{clip.cfg.vision_seq_len + node.N_CTX}; params "
        f"{ {k: tuple(v.shape) for k, v in kt.params.items()} }")
    _grad_agreement("maple", kt, pt, node, _augmented_batch(cache, labels, 23, MAPLE_BATCH))
    Lt, Lv = clip.cfg.transformer_layers, clip.cfg.vision_layers
    per_step = {fa.KERNEL: Lt + Lv, fa.KERNEL_DKV: Lt + Lv, fa.KERNEL_DQ: Lt + Lv}  # no remat
    launches, step_ms, peak = _train_both("maple", kt, pt, per_step, "flash_attn", MAPLE_BATCH)
    _step_summary("maple", kt, MAPLE_BATCH, step_ms, peak)
    _fused_vs_eager("maple", kt, 1, per_step, FLASH_GROUPS)
    return launches


def _linear_probe_steps(clip, cache, labels):
    """LinearProbeCLIP from LP_RECIPE (batch 32): the head's first-step
    gradients kernel against plain attention in bf16 (the tower runs without
    gradient, so only its features' rounding reaches the head: cosine at
    least MIN_GRAD_COSINE), then phase 6's run and rules; #6 only."""
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.trainers.linear_probe import LinearProbeCLIP

    cfg = _yaml_cfg(LP_RECIPE)
    batch = cfg.DATALOADER.TRAIN_X.BATCH_SIZE
    classnames = [f"class {i}" for i in range(N_CLASSES)]
    kt = LinearProbeCLIP(cfg, classnames, cache, labels, clip=clip, device="cuda",
                         steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    pt = LinearProbeCLIP(cfg, classnames, cache, labels, clip=clip, device="cuda",
                         steps_per_epoch=TRAIN_STEPS_PER_EPOCH, attn_impl="plain")
    first = _augmented_batch(cache, labels, 24, batch)
    grads = []
    for t in (kt, pt):
        loss, _ = t.loss_fn(t.params, t.frozen, first)
        grads.append(dict(zip(t.params, torch.autograd.grad(loss, list(t.params.values())))))
    cos = {k: _cosine(grads[0][k], grads[1][k]) for k in kt.params}
    log(f"linear probe: {LP_RECIPE}: batch {batch}, USE_BIAS {cfg.TRAINER.LINEAR_PROBE.USE_BIAS}; "
        f"first-step gradient cosine, kernel against plain (bf16): {cos}")
    if min(cos.values()) < MIN_GRAD_COSINE:
        raise SystemExit("FAIL: linear probe: kernel and plain first-step gradients disagree")
    per_step = {fa.KERNEL: clip.cfg.vision_layers, fa.KERNEL_DKV: 0, fa.KERNEL_DQ: 0}
    launches, step_ms, peak = _train_both("linear probe", kt, pt, per_step, "flash_attn", batch)
    _step_summary("linear probe", kt, batch, step_ms, peak)
    _fused_vs_eager("linear probe", kt, 1, per_step, FLASH_GROUPS)
    return launches


def _zeroshot_test(clip, cache, classes=None, tag=""):
    """ZeroshotCLIP and ZeroshotCLIP2 test() on N_TEST cache images at TEST
    batch 100 (LP_RECIPE's INPUT and TEST settings), through the kernels,
    the plain attention and the plain attention in fp32: the class text
    features (built once, at construction: one template, or the 7 of the
    select set plus the dataset's) at cosine MIN_COSINE; then phase 8's eval
    rules on the logits.  Launches: the text passes at build, then the
    vision tower once per test batch (a ViT's; a ModifiedResNet launches
    none).  ``classes``: the trainers (default both); ``tag`` follows each
    one's name in the log."""
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.trainers.zsclip import ZeroshotCLIP, ZeroshotCLIP2

    labels = np.random.RandomState(1234).randint(0, N_CLASSES, N_TEST)
    classnames = [f"class {i}" for i in range(N_CLASSES)]
    Lt, Lv = clip.cfg.transformer_layers, clip.cfg.vision_layers
    for cls in classes or (ZeroshotCLIP, ZeroshotCLIP2):
        class _Fp32(cls):
            def compute_dtype(self):
                return torch.float32

        cfg = _yaml_cfg(LP_RECIPE)
        n_batches = -(-N_TEST // cfg.DATALOADER.TEST.BATCH_SIZE)
        runs = {}
        for name, klass, impl in (("kernel", cls, None), ("plain", cls, "plain"),
                                  ("plain fp32", _Fp32, "plain")):
            torch.cuda.synchronize()
            fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
            t0 = time.perf_counter()
            t = klass(cfg, classnames, clip=clip, device="cuda", steps_per_epoch=1, attn_impl=impl)
            torch.cuda.synchronize()
            build = (dict(fa.LAUNCHES), (time.perf_counter() - t0) * 1e3)
            seen = []
            fn = t.logits_fn
            t.logits_fn = lambda *a, f=fn: seen.append(f(*a)) or seen[-1]
            fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                acc = t.test(cache[:N_TEST], labels)
            torch.cuda.synchronize()
            runs[name] = (t, torch.cat(seen).float(), build, dict(fa.LAUNCHES), acc,
                          (time.perf_counter() - t0) * 1e3)
        (kt, k_log, k_build, k_test, k_acc, k_ms), (pt, p_log, *_) = runs["kernel"], runs["plain"]
        f_log = runs["plain fp32"][1]
        n_templates = len(kt.templates_for(cfg))
        cos_txt = torch.nn.functional.cosine_similarity(kt.frozen["text_features"],
                                                        pt.frozen["text_features"], dim=-1)
        dlog = (k_log - p_log).abs().amax(dim=-1)
        noise_k, noise_p = ((x - f_log).abs().max().item() for x in (k_log, p_log))
        top2 = p_log.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * dlog.max()
        flips = int((decided & (k_log.argmax(-1) != p_log.argmax(-1))).sum())
        want_build = {fa.KERNEL: n_templates * Lt}
        want_test = {fa.KERNEL: n_batches * Lv} if clip.cfg.is_vit else {}
        label = cls.__name__ + tag
        log(f"{label}: {n_templates} template(s); text features built in {k_build[1]:.1f} ms, "
            f"min cosine to the plain path's {cos_txt.min().item():.6f}; test() on {N_TEST} images "
            f"in {n_batches} batches {k_ms:.1f} ms, accuracy kernel {k_acc:.1f}%, plain "
            f"{runs['plain'][4]:.1f}%, fp32 {runs['plain fp32'][4]:.1f}%; max |dlogit| "
            f"{dlog.max().item():.4f}; to the fp32 logits: kernel {noise_k:.4f}, plain bf16 "
            f"{noise_p:.4f}; images past the margin {int(decided.sum())}, top-1 flips there "
            f"{flips}; launches at build {k_build[0]}, in test() {k_test}")
        got_build = {k: n for k, n in k_build[0].items() if n}
        got_test = {k: n for k, n in k_test.items() if n}
        if (got_build != want_build or got_test != want_test or k_log.shape != (N_TEST, N_CLASSES)
                or not torch.isfinite(k_log).all() or cos_txt.min().item() < MIN_COSINE
                or dlog.max().item() > MAX_DLOGIT or noise_k > BF16_NOISE_RATIO * noise_p
                or flips):
            raise SystemExit(f"FAIL: {label}: kernel and plain paths disagree, or the launches "
                             f"are not {want_build} at build and {want_test} in test()")
        del runs, kt, pt


def _lora_cli(clip):
    """``python -m fsvlm_tpu_torch.train --trainer LoRA`` (LORA_RECIPE) on
    Synthetic with DATASET.NUM_SHOTS LORA_CLI_SHOTS, bf16, best-val, 2
    epochs: lora/best.pkl and last.pkl written, the launches of #6-#8 as
    derived from the code, and an ``--eval-only`` rerun that loads best.pkl
    and gives the run's final test predictions exactly."""
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa

    work = tempfile.mkdtemp(prefix="chip_smoke_lora_")

    def argv(out, *flags):
        return ["--trainer", "LoRA", "--seed", "1", "--device", "cuda",
                "--dataset-config-file", "configs/datasets/synthetic.yaml",
                "--config-file", LORA_RECIPE, "--output-dir", out, *flags,
                "MODEL.FROZEN_DTYPE", "bf16", "DATASET.NUM_SHOTS", str(LORA_CLI_SHOTS),
                "DATALOADER.DEVICE_AUG", "True", "TEST.FINAL_MODEL", "best_val",
                "OPTIM.MAX_EPOCH", str(CLI_EPOCHS)]

    try:
        out = os.path.join(work, "run")
        torch.cuda.synchronize()
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        _zero_fused_steps()
        t0 = time.perf_counter()
        t = _run_cli(clip, argv(out))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        ds, Lt, Lv = t.dm.dataset, clip.cfg.transformer_layers, clip.cfg.vision_layers
        # fused (TRAIN.EPOCH_FUSE auto): the wrappers count the steps that
        # are not replays
        steps, fsteps = _wrapped_steps("lora cli", t.steps_per_epoch * CLI_EPOCHS)

        def test_pass(n):  # split eval: the text once, the vision tower per batch
            return Lt + -(-n // t.cfg.DATALOADER.TEST.BATCH_SIZE) * Lv

        # per step both towers forward, again in the backward (remat), and
        # backward; a val test() after each epoch (best-val), then the test
        # set twice (after_train with best.pkl deployed, and the CLI's report)
        want = {fa.KERNEL: steps * 2 * (Lt + Lv) + CLI_EPOCHS * test_pass(len(ds.val))
                + 2 * test_pass(len(ds.test)),
                fa.KERNEL_DKV: steps * (Lt + Lv), fa.KERNEL_DQ: steps * (Lt + Lv)}
        lora_dir = os.path.join(out, "Synthetic", "ViT-B-16", "lora")
        files = sorted(os.listdir(lora_dir)) if os.path.isdir(lora_dir) else []
        text = _read(os.path.join(out, "log.txt"))
        log(f"lora cli: {LORA_RECIPE} on Synthetic: train_x {len(ds.train_x)}, val {len(ds.val)}, "
            f"test {len(ds.test)}; {t.steps_per_epoch} steps of {t.batch_size} per epoch, "
            f"{CLI_EPOCHS} epochs; run {run_s:.1f} s; accuracies in log.txt "
            f"{[float(x) for x in re.findall(r'[*] accuracy: ([0-9.]+)%', text)]}; {lora_dir} "
            f"holds {files}; fused steps {fsteps}; wrapper calls {launches}, expected {want}")
        _others_silent(launches, "flash_attn", "the LoRA CLI run")
        for needle in ("=> result", "Finish training", "LoRA checkpoint saved to",
                       "Deploy the model with the best val performance", "Loaded LoRA weights"):
            if needle not in text:
                raise SystemExit(f"FAIL: lora cli: log.txt lacks {needle!r}")
        if (files != ["best.pkl", "last.pkl"] or any(launches[k] != n for k, n in want.items())
                or fsteps["replays"] == 0):
            raise SystemExit("FAIL: lora cli: checkpoint files or launches are not as expected")
        epoch_ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                t.run_epoch()
            torch.cuda.synchronize()
            epoch_ms.append((time.perf_counter() - t0) * 1e3)
        n_img = t.steps_per_epoch * t.batch_size
        t2 = _run_cli(clip, argv(os.path.join(work, "eval"), "--eval-only", "--model-dir", out))
        same = (t2.evaluator.y_pred == t.evaluator.y_pred
                and t2.evaluator.y_true == t.evaluator.y_true)
        log(f"lora cli: epoch ms {[round(x, 1) for x in epoch_ms]} ({n_img} images, "
            f"{n_img / min(epoch_ms) * 1e3:.1f} images/s); --eval-only on the run's directory "
            f"reproduced its final test predictions: {same}")
        if not same:
            raise SystemExit("FAIL: lora cli: --eval-only did not reproduce the predictions")
        del t, t2
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


@_timed
def phase_clip_trainers(clip):
    """Phase 10 (module docstring): the CLIP-LoRA, MaPLe, linear-probe and
    zero-shot paths on the d = 64 kernels, FSVLM_FORCE_PALLAS unset (the
    caller sets it).  Returns each train path's launches."""
    import torch

    cache, labels = _train_cache()
    out = {"lora": _lora_step(clip, cache, labels)}
    torch.cuda.empty_cache()
    out["maple"] = _maple_step(clip, cache, labels)
    torch.cuda.empty_cache()
    out["linear_probe"] = _linear_probe_steps(clip, cache, labels)
    _zeroshot_test(clip, cache)
    torch.cuda.empty_cache()
    out["lora_cli"] = _lora_cli(clip)
    return out

PLIP_RECIPE = "configs/trainers/PLIP/vit_b16_c4_ep10_batch4.yaml"
COOP_RN_RECIPE = "configs/trainers/CoOp/rn50.yaml"
RN50_GOLDEN = "tests/golden_pack/rn50_full_shape.npz"  # read as data; nothing of tests/ is imported
RN_WEIGHTS_SEED, RN_PERTURB_SEED = 0, 1  # the CoOp RN50 and zero-shot RN50 tower
# the golden's weights (seed 50, BN perturbed with seed 51) and images (seed 13)
GOLDEN_RN_SEEDS = (50, 51, 13)
FD_RTOL = 1e-2  # the penalty's gradient against its central difference
FD_EPS = 1e-3  # the difference's step, as a share of |ctx|


def _perturb_bn(params, seed):
    """Every BN of the RN tower random (scale U(0.5, 1.5), bias N(0, 0.05),
    mean N(0, 0.1), var U(0.5, 1.5)), drawn in tests/golden_pack_common.py's
    order: the stem's bn1-3, then each block's bn1-3 and its downsample's.
    The reference init zeroes every bn3 scale, which silences the residual
    branches and would hide a conv2/conv3 fault."""
    rng = np.random.RandomState(seed)

    def perturb(bn):
        c = bn["scale"].shape[0]
        bn["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        bn["bias"] = rng.normal(0, 0.05, c).astype(np.float32)
        bn["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    stem = params["visual"]["stem"]
    for i in (1, 2, 3):
        perturb(stem[f"bn{i}"])
    for stage in params["visual"]["layers"]:
        for block in stage:
            for name in ("bn1", "bn2", "bn3"):
                perturb(block[name])
            if "downsample" in block:
                perturb(block["downsample"]["bn"])
    return params


def _rn50_clip(seed, perturb_seed, dtype):
    """RN50 CLIP on the card: random weights from ``seed``, BN perturbed."""
    from fsvlm_tpu_torch.models.clip import ARCHS, random_clip_params
    from fsvlm_tpu_torch.trainers.backbone import clip_from_params

    params = _perturb_bn(random_clip_params(ARCHS["RN50"], seed=seed), perturb_seed)
    return clip_from_params(params, ARCHS["RN50"], dtype, "cuda")


def _plip_penalty_fd(kt, batch):
    """In fp32 on the kernel path: the gradient penalty's own ctx gradient
    (autograd through the double backward) is nonzero, and along its unit
    direction equals a central difference of the penalty (step FD_EPS *
    |ctx|) within FD_RTOL; along a fixed random unit direction the two are
    printed beside each other."""
    import torch

    node, ctx = kt.node, kt.params["ctx"]
    node.PREC = "fp32"

    def penalty(c):
        return kt.loss_fn({"ctx": c}, kt.frozen, batch)[1]["penalty"]

    try:
        grad, = torch.autograd.grad(penalty(ctx), ctx)
        eps = FD_EPS * ctx.detach().norm().item()
        gen = torch.Generator(device="cuda").manual_seed(31)
        out = {}
        for name, d in (("gradient", grad), ("random", torch.randn(ctx.shape, generator=gen,
                                                                  device="cuda"))):
            d = d / d.norm()
            with torch.no_grad():
                plus, minus = ctx + eps * d, ctx - eps * d
            fd = (penalty(plus.requires_grad_()).item()
                  - penalty(minus.requires_grad_()).item()) / (2 * eps)
            out[name] = ((grad * d).sum().item(), fd)
    finally:
        node.PREC = "bf16"
    (analytic, fd), (r_analytic, r_fd) = out["gradient"], out["random"]
    log(f"plip grad: penalty gradient in fp32, max |g| {grad.abs().max().item():.4e}; along its "
        f"unit direction autograd {analytic:.6e}, central difference (step {eps:.3e}) {fd:.6e}, "
        f"relative difference {abs(analytic - fd) / abs(fd):.3e} (limit {FD_RTOL:g}); along a "
        f"random unit direction autograd {r_analytic:.6e}, central difference {r_fd:.6e}")
    if not (grad.abs().max().item() > 0 and abs(analytic - fd) <= FD_RTOL * abs(fd)):
        raise SystemExit("FAIL: plip grad: the penalty's gradient is not its finite difference")


def _plip_grad(clip, cache, labels):
    """The PLIP ViT-B/16 grad-mode step from PLIP_RECIPE at batch
    TRAIN_BATCH (module docstring, phase 11): the text tower on the
    reference route (no kernel), the image tower on #6."""
    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.trainers.plip import PLIP

    cfg = _yaml_cfg(PLIP_RECIPE, "DATALOADER.TRAIN_X.BATCH_SIZE", TRAIN_BATCH)
    node = cfg.TRAINER.PLIP
    classnames = [f"class {i}" for i in range(N_CLASSES)]
    kt = PLIP(cfg, classnames, cache, labels, clip=clip, device="cuda",
              steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    pt = PLIP(cfg, classnames, cache, labels, clip=clip, device="cuda",
              steps_per_epoch=TRAIN_STEPS_PER_EPOCH, attn_impl="plain")
    log(f"plip: {PLIP_RECIPE}: REG_TYPE {node.REG_TYPE}, N_CTX_TEXT {node.N_CTX_TEXT} "
        f"({node.CTX_INIT!r}), K {node.K}, REG_COEFF {node.REG_COEFF}, batch {TRAIN_BATCH} (the "
        f"recipe's 4), LR {cfg.OPTIM.LR}; text L={kt.frozen['base_embed'].shape[1]} x "
        f"{N_CLASSES} prompts on the reference route, vision L={clip.cfg.vision_seq_len}")
    first = _augmented_batch(cache, labels, 30)
    _grad_agreement("plip grad", kt, pt, node, first)
    _plip_penalty_fd(kt, first)
    Lt, Lv = clip.cfg.transformer_layers, clip.cfg.vision_layers
    per_step = {fa.KERNEL: Lv, fa.KERNEL_DKV: 0, fa.KERNEL_DQ: 0}  # the text tower: no kernel
    launches, step_ms, peak = _train_both("plip grad", kt, pt, per_step, "flash_attn",
                                          aux=("penalty",))
    _step_summary("plip grad", kt, TRAIN_BATCH, step_ms, peak)
    n_batches = -(-N_TEST // cfg.DATALOADER.TEST.BATCH_SIZE)
    ms = _split_eval_test("plip test()", kt, pt, cache, node, {fa.KERNEL: Lt + n_batches * Lv},
                          "flash_attn")
    log(f"plip test(): {N_TEST} images in {ms:.1f} ms (text features once, on the kernels)")
    _fused_vs_eager("plip grad", kt, 1, per_step, FLASH_GROUPS)
    return launches


def _plip_one_step(clip, cache, labels, reg_type):
    """One PLIP step under ``reg_type`` (svd or spectral_norm; the text
    tower on the kernels) through the kernels and the plain attention:
    phase 6's first-step gradient rules (spectral_norm with one start vector
    handed to both), then one resident step each on the same index, boxes,
    flips and start-vector draw: loss and penalty within DLOSS, the update's
    cosine at least MIN_DELTA_COSINE, the launches as derived, no
    synchronizing call."""
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.trainers.plip import PLIP

    label = f"plip {reg_type}"
    cfg = _yaml_cfg(PLIP_RECIPE, "DATALOADER.TRAIN_X.BATCH_SIZE", TRAIN_BATCH,
                    "TRAINER.PLIP.REG_TYPE", reg_type)
    classnames = [f"class {i}" for i in range(N_CLASSES)]
    kt, pt = (PLIP(cfg, classnames, cache, labels, clip=clip, device="cuda",
                   steps_per_epoch=TRAIN_STEPS_PER_EPOCH, attn_impl=impl) for impl in (None, "plain"))
    first = _augmented_batch(cache, labels, 32)
    if reg_type == "spectral_norm":
        gen = torch.Generator(device="cuda").manual_seed(33)
        first["v0"] = torch.randn(clip.cfg.transformer_width, generator=gen, device="cuda")
    _grad_agreement(label, kt, pt, cfg.TRAINER.PLIP, first)
    init = {k: v.detach().clone() for k, v in kt.params.items()}
    index = kt.epoch_schedule()[0][0]
    pt.epoch_schedule()
    torch.cuda.synchronize()
    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
    km = kt.train_step_resident(index)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    pm = pt.train_step_resident(index)
    d = {k: abs(km[k].item() - pm[k].item()) / (1 + abs(pm[k].item())) for k in ("loss", "penalty")}
    cos = {k: _cosine(kt.params[k].detach() - init[k], pt.params[k].detach() - init[k])
           for k in kt.params}
    Lt, Lv = clip.cfg.transformer_layers, clip.cfg.vision_layers
    want = {fa.KERNEL: Lt + Lv, fa.KERNEL_DKV: Lt, fa.KERNEL_DQ: Lt}
    log(f"{label}: one step: loss kernel {km['loss'].item():.6f} plain {pm['loss'].item():.6f}, "
        f"penalty kernel {km['penalty'].item():.6f} plain {pm['penalty'].item():.6f}; "
        f"|d|/(1+|x|) {d} (limit {DLOSS:g}); update cosine {cos}; params "
        f"{ {k: tuple(v.shape) for k, v in kt.params.items()} }; launches {launches}, "
        f"expected {want}")
    _others_silent(launches, "flash_attn", f"the {label} step")
    if (max(d.values()) > DLOSS or min(cos.values()) < MIN_DELTA_COSINE
            or not torch.equal(kt.generator.get_state(), pt.generator.get_state())
            or any(launches[k] != n for k, n in want.items())):
        raise SystemExit(f"FAIL: {label}: kernel and plain steps disagree, or the launches are "
                         f"not {want}")
    _no_sync_step(label, kt.train_step_resident, index)
    _fused_vs_eager(label, kt, 1, want, FLASH_GROUPS)
    return launches


def _coop_rn50(rn, cache, labels):
    """CoOp from COOP_RN_RECIPE (16 ctx, batch 32, bf16) on the RN50 tower
    (module docstring, phase 11): phase 6's run and rules, #6-#8 in the
    text tower only, then test() under phase 8's eval rules."""
    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.trainers.coop import CoOp

    cfg = _yaml_cfg(COOP_RN_RECIPE)
    node, batch = cfg.TRAINER.COOP, cfg.DATALOADER.TRAIN_X.BATCH_SIZE
    classnames = [f"class {i}" for i in range(N_CLASSES)]
    kt, pt = (CoOp(cfg, classnames, cache, labels, clip=rn, device="cuda",
                   steps_per_epoch=TRAIN_STEPS_PER_EPOCH, attn_impl=impl) for impl in (None, "plain"))
    log(f"coop rn50: {COOP_RN_RECIPE}: N_CTX {node.N_CTX}, batch {batch}, LR {cfg.OPTIM.LR}; "
        f"text L={kt.frozen['base_embed'].shape[1]} x {N_CLASSES} prompts; the RN50 tower "
        f"(layers {rn.cfg.vision_layers}, width {rn.cfg.vision_width}, pool heads "
        f"{rn.cfg.vision_heads}) through cuDNN without gradient")
    _grad_agreement("coop rn50", kt, pt, node, _augmented_batch(cache, labels, 34, batch))
    Lt = rn.cfg.transformer_layers
    per_step = {fa.KERNEL: Lt, fa.KERNEL_DKV: Lt, fa.KERNEL_DQ: Lt}  # the vision tower: none
    launches, step_ms, peak = _train_both("coop rn50", kt, pt, per_step, "flash_attn", batch)
    _step_summary("coop rn50", kt, batch, step_ms, peak)
    ms = _split_eval_test("coop rn50 test()", kt, pt, cache, node, {fa.KERNEL: Lt}, "flash_attn")
    log(f"coop rn50 test(): {N_TEST} images in {ms:.1f} ms")
    return launches


def _check_subsampled(pack, name, ours, rtol):
    """tests/golden_pack_common.py's check_subsampled (the port's own copy):
    the stored positions and the mean and std within rtol of the tensor's
    scale (its largest |moment|) plus 2e-3.  Returns the worst error over
    its limit."""
    ours = np.asarray(ours, np.float32)
    if ours.shape != tuple(pack[f"{name}.shape"]):
        raise SystemExit(f"FAIL: rn50 golden: {name} has shape {ours.shape}")
    moments = pack[f"{name}.moments"]
    atol = rtol * max(abs(float(moments[2])), abs(float(moments[3])), 1e-6) + 2e-3
    err = max(np.abs(ours.ravel()[pack[f"{name}.idx"]] - pack[f"{name}.val"].astype(np.float32)).max(),
              np.abs(np.array([ours.mean(), ours.std()]) - moments[:2]).max())
    return err / atol


def _rn50_golden():
    """The RN50 tower in fp32 on the card (TF32 off since phase 1) against
    the frozen reference activations of RN50_GOLDEN: the seed-50 weights
    with BN perturbed by seed 51, 2 images from seed 13; the four stages at
    their sub-sampled positions and moments (rtol 2e-3), the features at
    5e-3 of their largest entry (tests/test_golden_pack_full_shape.py)."""
    import torch

    from fsvlm_tpu_torch.models.clip import encode_image

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("FAIL: rn50 golden: TF32 is on")
    w_seed, p_seed, img_seed = GOLDEN_RN_SEEDS
    clip = _rn50_clip(w_seed, p_seed, torch.float32)
    images = torch.from_numpy(np.random.RandomState(img_seed).randn(2, 224, 224, 3)
                              .astype(np.float32)).cuda()
    with torch.no_grad():
        feat, stages = encode_image(clip, images, collect_stages=True)
    torch.cuda.synchronize()
    pack = dict(np.load(RN50_GOLDEN, allow_pickle=False))
    ratios = {f"stage{i}": _check_subsampled(pack, f"stage{i}", st.cpu().numpy(), 2e-3)
              for i, st in enumerate(stages, start=1)}
    ref = pack["image_features"]
    ratios["features"] = float(np.abs(feat.cpu().numpy() - ref).max() / (5e-3 * np.abs(ref).max()))
    log(f"rn50 golden: fp32 on the card against {RN50_GOLDEN}: stage shapes "
        f"{[tuple(st.shape) for st in stages]}; worst error over its limit "
        f"{ {k: round(v, 4) for k, v in ratios.items()} }")
    if max(ratios.values()) > 1 or not torch.isfinite(feat).all():
        raise SystemExit("FAIL: rn50 golden: the card's RN50 tower left the reference")
    del clip


def _plip_cli(clip):
    """``--trainer PLIP`` through the CLI on Synthetic with phase 9's
    configuration (PER_CLASS_SHOTS, WeightedClassSampler, DEVICE_AUG,
    best_val, a checkpoint every epoch, 2 epochs) on PLIP_RECIPE: the log
    contract, the checkpoint files, #6's launches as derived (the text
    tower trains on the reference route: #7/#8 none), and ``--eval-only``
    reproducing the run's final test predictions."""
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa

    work = tempfile.mkdtemp(prefix="chip_smoke_plip_")

    def argv(out, *flags):
        return ["--trainer", "PLIP", "--seed", "1", "--device", "cuda",
                "--dataset-config-file", "configs/datasets/synthetic.yaml",
                "--config-file", PLIP_RECIPE, "--output-dir", out, *flags,
                "MODEL.FROZEN_DTYPE", "bf16", "DATASET.NUM_SHOTS", "-1",
                "DATASET.PER_CLASS_SHOTS", str(CLI_PER_CLASS_SHOTS),
                "DATALOADER.TRAIN_X.SAMPLER", "WeightedClassSampler",
                "DATALOADER.DEVICE_AUG", "True", "TEST.FINAL_MODEL", "best_val",
                "TRAIN.CHECKPOINT_FREQ", "1", "OPTIM.MAX_EPOCH", str(CLI_EPOCHS)]

    try:
        out = os.path.join(work, "run")
        torch.cuda.synchronize()
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        _zero_fused_steps()
        t0 = time.perf_counter()
        t = _run_cli(clip, argv(out))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        ds, Lt, Lv = t.dm.dataset, clip.cfg.transformer_layers, clip.cfg.vision_layers
        # fused (TRAIN.EPOCH_FUSE auto): the wrappers count the steps that
        # are not replays
        steps, fsteps = _wrapped_steps("plip cli", t.steps_per_epoch * CLI_EPOCHS)

        def test_pass(n):  # split eval: the text once, the vision tower per batch
            return Lt + -(-n // t.cfg.DATALOADER.TEST.BATCH_SIZE) * Lv

        # per step the vision tower forward; a val test() after each epoch,
        # then the test set twice (after_train, and the CLI's report)
        want = {fa.KERNEL: steps * Lv + CLI_EPOCHS * test_pass(len(ds.val))
                + 2 * test_pass(len(ds.test)), fa.KERNEL_DKV: 0, fa.KERNEL_DQ: 0}
        mdir = os.path.join(out, "prompt_learner")
        files = sorted(os.listdir(mdir)) if os.path.isdir(mdir) else []
        text = _read(os.path.join(out, "log.txt"))
        log(f"plip cli: {PLIP_RECIPE} on Synthetic: train_x {len(ds.train_x)}, val {len(ds.val)}, "
            f"test {len(ds.test)}; {t.steps_per_epoch} steps of {t.batch_size} per epoch, "
            f"{CLI_EPOCHS} epochs; run {run_s:.1f} s; accuracies in log.txt "
            f"{[float(x) for x in re.findall(r'[*] accuracy: ([0-9.]+)%', text)]}; {mdir} holds "
            f"{files}; fused steps {fsteps}; wrapper calls {launches}, expected {want}")
        _others_silent(launches, "flash_attn", "the PLIP CLI run")
        for needle in ("=> result", "Finish training", "REG_COEFF: 0.01",
                       "Deploy the model with the best val performance"):
            if needle not in text:
                raise SystemExit(f"FAIL: plip cli: log.txt lacks {needle!r}")
        if (not {"checkpoint", "model-best.pkl", "model.pkl-1", "model.pkl-2"} <= set(files)
                or any(launches[k] != n for k, n in want.items()) or fsteps["replays"] == 0):
            raise SystemExit("FAIL: plip cli: checkpoint files or launches are not as expected")
        t2 = _run_cli(clip, argv(os.path.join(work, "eval"), "--eval-only", "--model-dir", out))
        same = (t2.evaluator.y_pred == t.evaluator.y_pred
                and t2.evaluator.y_true == t.evaluator.y_true)
        log(f"plip cli: --eval-only on the run's directory reproduced its final test "
            f"predictions: {same}")
        if not same:
            raise SystemExit("FAIL: plip cli: --eval-only did not reproduce the predictions")
        del t, t2
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


@_timed
def phase_plip_resnet(clip):
    """Phase 11 (module docstring): PLIP on ``clip`` (ViT-B/16) in its three
    REG_TYPEs, CoOp and ZeroshotCLIP on an RN50 tower, the RN50 golden in
    fp32, and the PLIP CLI; FSVLM_FORCE_PALLAS unset (the caller sets it).
    Returns each path's launches."""
    import torch

    from fsvlm_tpu_torch.trainers.zsclip import ZeroshotCLIP

    cache, labels = _train_cache()
    out = {"plip_grad": _plip_grad(clip, cache, labels)}
    for reg_type in ("svd", "spectral_norm"):
        torch.cuda.empty_cache()
        out[f"plip_{reg_type}"] = _plip_one_step(clip, cache, labels, reg_type)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rn = _rn50_clip(RN_WEIGHTS_SEED, RN_PERTURB_SEED, torch.bfloat16)
    log(f"rn50: random weights from seed {RN_WEIGHTS_SEED}, BN perturbed with seed "
        f"{RN_PERTURB_SEED}, bf16 on the card in {time.perf_counter() - t0:.1f} s")
    out["coop_rn50"] = _coop_rn50(rn, cache, labels)
    _zeroshot_test(rn, cache, classes=(ZeroshotCLIP,), tag=" RN50")
    del rn
    torch.cuda.empty_cache()
    _rn50_golden()
    torch.cuda.empty_cache()
    out["plip_cli"] = _plip_cli(clip)
    return out


FIXTURE_DIR = os.path.join("tests", "torch_fixtures", "jpeg")
RECOG_CLASSES = 100
# Setting A's shape (50 head classes, then 50 tail classes at a quarter of
# their shots) at half of tail 4's shots, 50 x 8 then 50 x 2: 500 train
# images, 300 val (16 and 4 until phase 20 came in: the call's time limit)
RECOG_SHOTS = [8] * 50 + [2] * 50
RECOG_TRAIN, RECOG_VAL = sum(RECOG_SHOTS), sum(min(s, 4) for s in RECOG_SHOTS)
RECOG_EPOCHS = 1  # the recipe's 20, cut to 1


def _digest(a):
    import hashlib

    a = np.ascontiguousarray(a, np.uint8)
    return {"shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest(),
            "sum": int(a.sum(dtype=np.int64))}


def _libjpeg_finding():
    """Whether this machine has libjpeg's header and library (route A needs
    both; the port takes route B, its own decoder, either way)."""
    import glob

    headers = [h for h in ["/usr/include/jpeglib.h", *glob.glob("/usr/include/*/jconfig.h")]
               if os.path.isfile(h)]
    try:
        ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                                  timeout=60).stdout
    except OSError:
        ldconfig = ""
    libs = sorted({ln.split("=>")[-1].strip() for ln in ldconfig.splitlines()
                   if re.search(r"libjpeg\.so", ln)})
    return {"headers": headers, "libjpeg": libs}


def _check_fixtures():
    """(a) Every committed fixture decoded by the port against the digests
    computed from the JAX package's means (make_fixtures.py): the full
    decode (Pillow's), decode_file at 256 (the libjpeg build's), the loader's
    cache view and the eval view before normalizing."""
    from fsvlm_tpu_torch import native
    from fsvlm_tpu_torch.data import imageops
    from fsvlm_tpu_torch.data.base_dataset import Datum
    from fsvlm_tpu_torch.data.loader import RawDatasetWrapper

    with open(os.path.join(FIXTURE_DIR, "expected.json")) as f:
        expected = json.load(f)
    bad = []
    for name, want in sorted(expected.items()):
        path = os.path.join(FIXTURE_DIR, name)
        full = native.read_image(path)
        raw = native.decode_file(path, 256)
        got = {"full": _digest(full), "raw256": None if raw is None else _digest(raw),
               "cache256": _digest(RawDatasetWrapper([Datum(impath=path)], 256)[0]["img"]),
               "eval224": _digest(imageops.resize_center_crop(full, (224, 224), "bicubic"))}
        bad += [f"{name} {k}: got {got[k]}, expected {want[k]}" for k in want if got[k] != want[k]]
    log(f"recognition: {len(expected)} committed JPEG fixtures x 4 views (full decode, "
        f"decode_file 256, cache view, eval view 224) against their digests: "
        f"{4 * len(expected) - len(bad)} equal, {len(bad)} differ")
    if bad:
        raise SystemExit("FAIL: recognition: decoded bytes differ from the fixtures' digests:\n"
                         + "\n".join(bad))
    return sorted(expected)


def _caltech_tree(root, fixtures):
    """A Caltech101-layout tree (docs/DATASETS.md) of 100 class folders whose
    files are hard links to the fixtures, and a split_zhou_Caltech101.json
    of Caltech101's split sizes: 41 train per class (4100), 16-17 val
    (1650), 24-25 test (2465)."""
    image_dir = os.path.join(root, "caltech-101", "101_ObjectCategories")
    split = {"train": [], "val": [], "test": []}
    k = 0
    for c in range(RECOG_CLASSES):
        cname = f"category_{c:03d}"
        os.makedirs(os.path.join(image_dir, cname))
        counts = {"train": 41, "val": 17 if c < 50 else 16, "test": 25 if c < 65 else 24}
        for part, n in counts.items():
            for j in range(n):
                rel = f"{cname}/image_{part}_{j:04d}.jpg"
                src = os.path.abspath(os.path.join(FIXTURE_DIR, fixtures[k % len(fixtures)]))
                try:
                    os.link(src, os.path.join(image_dir, rel))
                except OSError:
                    shutil.copy(src, os.path.join(image_dir, rel))
                split[part].append([rel, c, cname.replace("_", " ")])
                k += 1
    with open(os.path.join(root, "caltech-101", "split_zhou_Caltech101.json"), "w") as f:
        json.dump(split, f)
    return {part: len(v) for part, v in split.items()}


def _decode_rates(paths, threads):
    """Images/s of the full decode and of decode_file at 256 over ``paths``
    in a pool of ``threads``, and the device-aug cache's materialize ms."""
    from concurrent.futures import ThreadPoolExecutor

    from fsvlm_tpu_torch import native

    out = {}
    with ThreadPoolExecutor(max_workers=threads) as pool:
        for name, fn in (("full", native.read_image),
                         ("decode_file", lambda p: native.decode_file(p, 256))):
            t0 = time.perf_counter()
            list(pool.map(fn, paths))
            out[name] = len(paths) / (time.perf_counter() - t0)
    return out


@_timed
def phase_recognition(clip, keep=None):
    """Phase 12 (module docstring): the decoder's fixtures, then PromptSRC
    ViT-B/16 through the CLI on a 100-class Caltech101-layout JPEG tree;
    FSVLM_FORCE_PALLAS unset (the caller sets it).  Returns the run's
    launches and its ``{"recognition": ...}`` numbers (the epoch's
    "epoch_ms", its "launches").  ``keep``: a dict that receives the tree
    ("work"), the run's output directory ("out"), its command ("argv"), the
    test split ("test_items", "lab2cname") and ``--eval-only``'s
    predictions ("y_true", "y_pred"); the caller then removes the tree."""
    import resource

    import torch

    from fsvlm_tpu_torch import native
    from fsvlm_tpu_torch.data.loader import RawDatasetWrapper
    from fsvlm_tpu_torch.engine.trainer import SimpleTrainer
    from fsvlm_tpu_torch.ops import flash_attention as fa

    finding = _libjpeg_finding()
    info = native.build_info()
    log(f"recognition: libjpeg on this machine: headers {finding['headers']}, libraries "
        f"{finding['libjpeg']}; the decoder takes route {info['route']} (the repo's own "
        f"{info['source']}, no library), built by g++ in {info['seconds']:.2f} s")
    fixtures = _check_fixtures()
    work = tempfile.mkdtemp(prefix="chip_smoke_recognition_")

    def argv(out, *flags):
        return ["--trainer", "PromptSRC", "--seed", "1", "--device", "cuda", "--root", work,
                "--dataset-config-file", "configs/datasets/caltech101.yaml",
                "--config-file", CLI_RECIPE, "--output-dir", out, *flags,
                "MODEL.FROZEN_DTYPE", "bf16", "TRAINER.PROMPTSRC.PREC", "bf16",
                "DATASET.NUM_SHOTS", "-1", "DATASET.PER_CLASS_SHOTS", str(RECOG_SHOTS),
                "DATALOADER.TRAIN_X.SAMPLER", "WeightedClassSampler",
                "DATALOADER.DEVICE_AUG", "True", "TRAINER.PROMPTSRC.CACHED_TEACHER", "True",
                "TEST.FINAL_MODEL", "best_val", "OPTIM.MAX_EPOCH", str(RECOG_EPOCHS)]

    try:
        sizes = _caltech_tree(work, fixtures)
        out = os.path.join(work, "run")
        torch.cuda.synchronize()
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        _zero_fused_steps()
        t0 = time.perf_counter()
        with _epochs_timed(SimpleTrainer, []) as epochs:
            t = _run_cli(clip, argv(out))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        ds = t.dm.dataset
        text = _read(os.path.join(out, "log.txt"))
        losses = [float(x) for x in re.findall(r"\bloss ([-+.\deE]+|nan|inf)", text)]
        log(f"recognition: {CLI_RECIPE} on a Caltech101-layout tree (split {sizes}): train_x "
            f"{len(ds.train_x)} (50 x 8 + 50 x 2), val {len(ds.val)}, test {len(ds.test)}; "
            f"{t.steps_per_epoch} steps of {t.batch_size}, {RECOG_EPOCHS} epoch; run "
            f"{run_s:.1f} s; losses logged {losses}; accuracies in log.txt "
            f"{[float(x) for x in re.findall(r'[*] accuracy: ([0-9.]+)%', text)]}")
        for needle in ("=> result", "* accuracy:", "Classification Report", "Finish training",
                       "Base class accuracy", "New  class accuracy",
                       "[PromptSRC] cached teacher image features",
                       f"* device-resident train set: {RECOG_TRAIN} images"):
            if needle not in text:
                raise SystemExit(f"FAIL: recognition: log.txt lacks {needle!r}")
        if (len(ds.train_x), len(ds.val), len(ds.test)) != (RECOG_TRAIN, RECOG_VAL,
                                                             sizes["test"]):
            raise SystemExit("FAIL: recognition: the split sizes are not the protocol's")
        # (c) the loss is finite
        if not losses or not all(np.isfinite(losses)):
            raise SystemExit(f"FAIL: recognition: non-finite or no loss in log.txt: {losses}")
        # (b) #6-#8 at the counts derived from the code, over the steps that
        # are not a fused epoch's replays (TRAIN.EPOCH_FUSE auto)
        wrapped, fsteps = _wrapped_steps("recognition", t.steps_per_epoch * RECOG_EPOCHS)
        expected = _cli_expected_launches(t, clip.cfg, epochs=RECOG_EPOCHS, steps=wrapped)
        _others_silent(launches, "flash_attn", "the recognition CLI run")
        log(f"recognition: fused steps {fsteps}; wrapper calls {launches}, expected {expected}")
        if any(launches[k] != n for k, n in expected.items()) or fsteps["replays"] == 0:
            raise SystemExit("FAIL: recognition: #6-#8 launches differ from the derived counts")

        # (c) --eval-only from the run's best model: the run's own final
        # test() predictions; its wall time is a cold test() (decode, eval
        # view, model) on the test set
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t2 = _run_cli(clip, argv(os.path.join(work, "eval"), "--eval-only", "--model-dir", out))
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        same = (t2.evaluator.y_pred == t.evaluator.y_pred
                and t2.evaluator.y_true == t.evaluator.y_true)
        cache = t2.dm.test_loader.wrapper
        peak_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss << 10
        log(f"recognition: --eval-only from model-best.pkl reproduced the run's final test "
            f"predictions: {same} ({len(t2.evaluator.y_pred)} images)")
        if not same:
            raise SystemExit("FAIL: recognition: --eval-only did not reproduce the predictions")

        # the host's numbers: decode rates, the cache build, epoch and test()
        threads = t.cfg.DATALOADER.NUM_WORKERS
        train_paths = [d.impath for d in ds.train_x]
        rates = _decode_rates(train_paths, threads)
        t0 = time.perf_counter()
        RawDatasetWrapper(ds.train_x, pre_size=t.cfg.DATALOADER.PRE_SIZE).materialize(threads)
        materialize_ms = (time.perf_counter() - t0) * 1e3
        epoch_ms = epochs[0]  # the run's epoch, its device cache build included
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            t.test()
        torch.cuda.synchronize()
        test_ms = (time.perf_counter() - t0) * 1e3
        n_img = t.steps_per_epoch * t.batch_size
        result = {
            "route": info["route"], "decoder": info["source"], "libjpeg": finding,
            "threads": threads, "full_decode_images_per_s": rates["full"],
            "decode_file_images_per_s": rates["decode_file"], "decode_images": len(train_paths),
            "materialize_ms": materialize_ms, "materialize_images": len(ds.train_x),
            "epoch_ms": epoch_ms, "epoch_images": n_img, "run_s": run_s,
            "test_ms_cached": test_ms, "eval_only_s": eval_s, "test_images": len(ds.test),
            "eval_cache_bytes": cache.cached_bytes, "peak_rss_bytes": peak_rss,
        }
        log(f"recognition: decode over {len(train_paths)} tree files at {threads} threads: full "
            f"{rates['full']:.1f} images/s, decode_file(256) {rates['decode_file']:.1f} images/s; "
            f"materialize {len(ds.train_x)} images {materialize_ms:.1f} ms; the run's epoch "
            f"{epoch_ms:.1f} ms ({n_img} images, {n_img / epoch_ms * 1e3:.1f} images/s); test() "
            f"on {len(ds.test)} cached eval views {test_ms:.1f} ms; --eval-only run (cold: "
            f"decode, eval view, model) {eval_s:.1f} s; eval cache {cache.cached_bytes / 2**20:.1f}"
            f" MiB; process peak RSS {peak_rss / 2**30:.2f} GiB")
        print(json.dumps({"recognition": result}), flush=True)
        if keep is not None:
            keep.update(work=work, out=out, argv=argv, test_items=list(ds.test),
                        lab2cname=dict(t2.lab2cname), y_true=list(t2.evaluator.y_true),
                        y_pred=list(t2.evaluator.y_pred))
        del t, t2
        torch.cuda.empty_cache()
    finally:
        if keep is None or "work" not in keep:  # kept only after the phase passed
            shutil.rmtree(work, ignore_errors=True)
    return launches, dict(result, launches=launches)


TRANSFORM_FIXTURES = os.path.join("tests", "torch_fixtures", "transforms", "expected.json")
COOP_SIMCLR_EPOCHS = 1
SIMCLR_STEPS, SIMCLR_BATCH = 3, 48  # PromptSRC with SIMCLR_ALPHA: steps at bench.py's batch
HOST_PROFILE_STEPS = 5
LOADER_STEPS = 10  # steps per side of the loader's-share comparison (60 before phase 20)


def _check_transform_fixtures():
    """(1) The port's TrainTransform (or, under INPUT.NO_TRANSFORM, the eval
    view normalized as the trainer normalizes it) on the committed JPEG
    fixtures for every pipeline of the transforms' expected.json, at its
    seeds, against the digests of the JAX package's outputs: sha256 for
    the exact pipelines, the samples and the sum within 1e-6 for
    gaussian_noise and instance_norm."""
    import hashlib
    import random

    from fsvlm_tpu_torch import native
    from fsvlm_tpu_torch.config import get_cfg_base
    from fsvlm_tpu_torch.data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, build_transform

    with open(TRANSFORM_FIXTURES) as f:
        expected = json.load(f)
    bad, n, worst = [], 0, 0.0
    for name, spec in sorted(expected["pipelines"].items()):
        cfg = get_cfg_base()
        cfg.INPUT.TRANSFORMS = tuple(spec["transforms"])
        cfg.INPUT.INTERPOLATION = spec["interpolation"]
        cfg.INPUT.SIZE = tuple(spec["size"])
        cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD = list(CLIP_PIXEL_MEAN), list(CLIP_PIXEL_STD)
        cfg.INPUT.NO_TRANSFORM = spec["no_transform"]
        tfm = build_transform(cfg, is_train=True)
        mean, std = np.float32(CLIP_PIXEL_MEAN), np.float32(CLIP_PIXEL_STD)
        for i, (fixture, want) in enumerate(sorted(expected["digests"][name].items())):
            img = native.read_image(os.path.join(FIXTURE_DIR, fixture))
            if spec["no_transform"]:
                x = ((tfm(img).astype(np.float32) / 255.0 - mean) / std).astype(np.float32)
            else:
                x = tfm(img, rng=random.Random(spec["seed"] + i))
            n += 1
            if list(x.shape) != want["shape"]:
                bad.append(f"{name} {fixture}: shape {x.shape}, expected {want['shape']}")
            elif spec["exact"]:
                if hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest() != want["sha256"]:
                    bad.append(f"{name} {fixture}: bytes differ")
            else:
                err = float(np.abs(x.ravel()[::expected["sample_stride"]]
                                   - np.float32(want["sample"])).max())
                dsum = abs(float(x.sum(dtype=np.float64)) - want["sum"])
                worst = max(worst, err)
                if err > 1e-6 or dsum > 1e-6 * x.size:
                    bad.append(f"{name} {fixture}: samples off by {err:.3g}, sum by {dsum:.3g}")
    log(f"host_aug: {len(expected['pipelines'])} pipelines x {n // len(expected['pipelines'])} "
        f"committed JPEG fixtures through the port's TrainTransform against the JAX package's "
        f"digests: {n - len(bad)} equal, {len(bad)} differ (gaussian_noise / instance_norm "
        f"samples within {worst:.3g})")
    if bad:
        raise SystemExit("FAIL: host_aug: transform outputs differ from the fixtures' digests:\n"
                         + "\n".join(bad))
    return n


def _host_launches(t, clip_cfg, per_step, epochs):
    """#6-#8 over a CLI run of a trainer without a build-time tower pass,
    from the code: ``per_step`` = (#6, #7/#8) per step; per test() one text
    pass and one vision pass per batch: the val set after each epoch under
    best_val, then the test set twice (after_train, and the CLI's report)."""
    from fsvlm_tpu_torch.ops import flash_attention as fa

    Lt, Lv = clip_cfg.transformer_layers, clip_cfg.vision_layers
    ds, cfg = t.dm.dataset, t.cfg
    B = cfg.DATALOADER.TEST.BATCH_SIZE
    steps = t.steps_per_epoch * epochs
    vals = epochs if cfg.TEST.FINAL_MODEL == "best_val" and ds.val else 0
    fwd = (steps * per_step[0] + vals * (Lt + -(-len(ds.val) // B) * Lv)
           + 2 * (Lt + -(-len(ds.test) // B) * Lv))
    return {fa.KERNEL: fwd, fa.KERNEL_DKV: steps * per_step[1], fa.KERNEL_DQ: steps * per_step[1]}


def _views_per_s(wrapper, threads):
    """Train views per second of ``wrapper`` over its whole set in a pool of
    ``threads`` (its decoded-image cache warmed first)."""
    from concurrent.futures import ThreadPoolExecutor

    idx = list(range(len(wrapper)))
    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(wrapper.image, idx))
        t0 = time.perf_counter()
        items = list(pool.map(wrapper.__getitem__, idx))
        seconds = time.perf_counter() - t0
    return len(items) * (2 if "img2" in items[0] else 1) / seconds


@_timed
def phase_host_aug(clip, recognition):
    """Phase 13 (module docstring): the host train transforms' fixtures,
    then PromptSRC and CoOp SimCLR through the CLI without DEVICE_AUG on a
    Caltech101-layout tree, and PromptSRC's SIMCLR_ALPHA step;
    FSVLM_FORCE_PALLAS unset (the caller sets it).  ``recognition``: phase
    12's numbers.  Returns each path's launches."""
    import torch

    from fsvlm_tpu_torch.config import get_cfg_base
    from fsvlm_tpu_torch.data.loader import DatasetWrapper
    from fsvlm_tpu_torch.data.transforms import TrainTransform
    from fsvlm_tpu_torch.engine.trainer import SimpleTrainer, build_trainer
    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.train import maybe_override_simclr_loader
    from fsvlm_tpu_torch.trainers.simclr_utils import make_simclr_loader

    n_fixture_views = _check_transform_fixtures()
    fixtures = sorted(f for f in os.listdir(FIXTURE_DIR) if f.endswith(".jpg"))
    work = tempfile.mkdtemp(prefix="chip_smoke_host_aug_")
    data = ["--root", work, "--dataset-config-file", "configs/datasets/caltech101.yaml",
            "MODEL.FROZEN_DTYPE", "bf16", "DATASET.NUM_SHOTS", "-1",
            "DATASET.PER_CLASS_SHOTS", str(RECOG_SHOTS)]
    launches = {}
    try:
        sizes = _caltech_tree(work, fixtures)

        # (2) PromptSRC through the CLI on the host pipeline (phase 12's
        # command without DATALOADER.DEVICE_AUG True)
        def promptsrc_argv(out, *flags):
            return ["--trainer", "PromptSRC", "--seed", "1", "--device", "cuda", *data[:4],
                    "--config-file", CLI_RECIPE, "--output-dir", out, *flags, *data[4:],
                    "TRAINER.PROMPTSRC.PREC", "bf16", "DATALOADER.TRAIN_X.SAMPLER",
                    "WeightedClassSampler", "TRAINER.PROMPTSRC.CACHED_TEACHER", "True",
                    "TEST.FINAL_MODEL", "best_val", "OPTIM.MAX_EPOCH", str(RECOG_EPOCHS)]

        out = os.path.join(work, "promptsrc")
        torch.cuda.synchronize()
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        t0 = time.perf_counter()
        with _epochs_timed(SimpleTrainer, []) as epochs:
            t = _run_cli(clip, promptsrc_argv(out))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches["host_aug_cli"] = dict(fa.LAUNCHES)
        text = _read(os.path.join(out, "log.txt"))
        losses = [float(x) for x in re.findall(r"\bloss ([-+.\deE]+|nan|inf)", text)]
        for needle in ("=> result", "* accuracy:", "Classification Report", "Finish training",
                       "Base class accuracy", "[PromptSRC] cached teacher image features",
                       "DEVICE_AUG: False"):
            if needle not in text:
                raise SystemExit(f"FAIL: host_aug: log.txt lacks {needle!r}")
        if "device-resident train set" in text or t.cache is not None:
            raise SystemExit("FAIL: host_aug: the host pipeline took the device-resident path")
        if not losses or not all(np.isfinite(losses)):
            raise SystemExit(f"FAIL: host_aug: non-finite or no loss in log.txt: {losses}")
        if not t.train_loader_x.wrapper.uint8:
            raise SystemExit("FAIL: host_aug: the recipe's views did not ship as uint8")
        want = _cli_expected_launches(t, clip.cfg, epochs=RECOG_EPOCHS)
        _others_silent(launches["host_aug_cli"], "flash_attn", "the host-aug CLI run")
        got = {k: launches["host_aug_cli"][k] for k in want}
        log(f"host_aug: PromptSRC {CLI_RECIPE} through the CLI without DEVICE_AUG on the tree "
            f"(split {sizes}): {t.steps_per_epoch} steps of {t.batch_size}, run {run_s:.1f} s, "
            f"losses {losses}; launches {got}, expected {want}; phase 12 (DEVICE_AUG) launched "
            f"{ {k: recognition['launches'][k] for k in want} }")
        if got != want:
            raise SystemExit("FAIL: host_aug: #6-#8 launches differ from the derived counts")
        t2 = _run_cli(clip, promptsrc_argv(os.path.join(work, "eval"), "--eval-only",
                                           "--model-dir", out))
        if (t2.evaluator.y_pred != t.evaluator.y_pred
                or t2.evaluator.y_true != t.evaluator.y_true):
            raise SystemExit("FAIL: host_aug: --eval-only did not reproduce the predictions")
        log(f"host_aug: --eval-only from model-best.pkl reproduced the run's "
            f"{len(t2.evaluator.y_pred)} test predictions")
        del t2

        # (3) CoOp with LOSS_TYPE simclr through the CLI (scripts/coop/train.sh's
        # command with SUB=all, on the same tree), spying on each step's batch
        out_coop = os.path.join(work, "coop")
        seen = []
        step = SimpleTrainer.train_step

        def spy(self, batch, *a, **kw):
            two = "img2" in batch
            seen.append((two, (batch["img"] != batch["img2"]).flatten(1).any(1).all()
                         if two else None))
            return step(self, batch, *a, **kw)

        coop_argv = ["--trainer", "CoOp", "--seed", "1", "--device", "cuda", *data[:4],
                     "--config-file", COOP_RECIPE, "--output-dir", out_coop, *data[4:],
                     "TRAINER.COOP.N_CTX", "16", "TRAINER.COOP.CSC", "False",
                     "TRAINER.COOP.CLASS_TOKEN_POSITION", "end", "TRAINER.COOP.LOSS_TYPE",
                     "simclr", "TRAINER.COOP.USE_FOCAL_LOSS", "False",
                     "DATASET.SUBSAMPLE_CLASSES", "all", "TRAINER.COOP.PREC", "bf16",
                     "OPTIM.MAX_EPOCH", str(COOP_SIMCLR_EPOCHS)]
        torch.cuda.synchronize()
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        SimpleTrainer.train_step = spy
        try:
            t0 = time.perf_counter()
            tc = _run_cli(clip, coop_argv)
            torch.cuda.synchronize()
            coop_run_s = time.perf_counter() - t0
        finally:
            SimpleTrainer.train_step = step
        launches["coop_simclr_cli"] = dict(fa.LAUNCHES)
        text = _read(os.path.join(out_coop, "log.txt"))
        coop_losses = [float(x) for x in re.findall(r"\bloss ([-+.\deE]+|nan|inf)", text)]
        if ">> SimCLR objective active => overriding train_loader_x with a two-view loader!" \
                not in text:
            raise SystemExit("FAIL: host_aug: the CoOp SimCLR run did not print the override")
        if len(seen) != tc.steps_per_epoch * COOP_SIMCLR_EPOCHS or not all(
                two and bool(differ) for two, differ in seen):
            raise SystemExit(f"FAIL: host_aug: CoOp SimCLR steps without two distinct views "
                             f"({len(seen)} steps)")
        if not coop_losses or not all(np.isfinite(coop_losses)):
            raise SystemExit(f"FAIL: host_aug: CoOp NT-Xent losses {coop_losses}")
        Lt, Lv = clip.cfg.transformer_layers, clip.cfg.vision_layers
        want = _host_launches(tc, clip.cfg, (2 * Lt + 2 * Lv, 2 * Lt), COOP_SIMCLR_EPOCHS)
        _others_silent(launches["coop_simclr_cli"], "flash_attn", "the CoOp SimCLR CLI run")
        got = {k: launches["coop_simclr_cli"][k] for k in want}
        log(f"host_aug: CoOp LOSS_TYPE simclr {COOP_RECIPE} through the CLI: "
            f"{tc.steps_per_epoch} steps of {tc.batch_size} on the two-view loader, img2 in "
            f"every batch and unlike img; run {coop_run_s:.1f} s; NT-Xent losses {coop_losses}; "
            f"launches {got}, expected {want}")
        if got != want:
            raise SystemExit("FAIL: host_aug: CoOp SimCLR #6-#8 launches differ from the derived "
                             "counts")
        cfg_da = _recipe_cfg_from_argv(coop_argv + ["DATALOADER.DEVICE_AUG", "True"])
        try:
            maybe_override_simclr_loader(cfg_da, tc)
        except ValueError as e:
            log(f"host_aug: CoOp SimCLR under DATALOADER.DEVICE_AUG True raised ValueError: {e}")
        else:
            raise SystemExit("FAIL: host_aug: SimCLR under DEVICE_AUG did not raise")
        # CoOp SimCLR's step: one two-view batch on the card, stepped synced
        batch = next(iter(tc.device_batches(tc.train_loader_x)))
        coop_ms = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tc.train_step(batch)
            torch.cuda.synchronize()
            coop_ms.append((time.perf_counter() - t0) * 1e3)
        coop_step_ms = float(np.median(coop_ms[1:]))
        coop_batch = tc.batch_size
        del tc, batch

        # (4) PromptSRC with SIMCLR_ALPHA 0.1 on the two-view loader at batch
        # 48: no synchronizing call in a step, launches per step
        cfg = _recipe_cfg_from_argv(promptsrc_argv(os.path.join(work, "simclr")) + [
            "TRAINER.PROMPTSRC.SIMCLR_ALPHA", "0.1", "TRAINER.PROMPTSRC.CACHED_TEACHER", "False",
            "DATALOADER.TRAIN_X.BATCH_SIZE", str(SIMCLR_BATCH)])
        with contextlib.redirect_stdout(io.StringIO()):
            ts = build_trainer(cfg, device="cuda", clip=clip)
            maybe_override_simclr_loader(cfg, ts)
        batches = ts.device_batches(ts.train_loader_x)
        b = next(batches)
        ts.train_step(b)  # warm-up
        torch.cuda.synchronize()
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        for i in range(SIMCLR_STEPS):
            b = next(batches)
            if i == 0:
                _no_sync_step(f"host_aug: PromptSRC SIMCLR_ALPHA 0.1 step at batch {SIMCLR_BATCH}",
                              ts.train_step, b)
            else:
                ts.train_step(b)
        torch.cuda.synchronize()
        batches.close()
        launches["promptsrc_simclr"] = dict(fa.LAUNCHES)
        per = {fa.KERNEL: Lt + 3 * Lv, fa.KERNEL_DKV: Lt + 2 * Lv, fa.KERNEL_DQ: Lt + 2 * Lv}
        want = {k: SIMCLR_STEPS * n for k, n in per.items()}
        got = {k: launches["promptsrc_simclr"][k] for k in want}
        _others_silent(launches["promptsrc_simclr"], "flash_attn", "the SIMCLR_ALPHA steps")
        log(f"host_aug: PromptSRC SIMCLR_ALPHA 0.1, {SIMCLR_STEPS} steps at batch {SIMCLR_BATCH} "
            f"(student text, vision on img and img2, teacher vision on img): launches {got}, "
            f"expected {want}")
        if got != want:
            raise SystemExit("FAIL: host_aug: SIMCLR_ALPHA launches differ from the derived counts")
        del ts, batches, b

        # (5) the host's numbers
        threads = t.cfg.DATALOADER.NUM_WORKERS
        train_x = t.dm.dataset.train_x
        recipe_wrapper = DatasetWrapper(train_x, TrainTransform(t.cfg), train=True, seed=1,
                                        uint8=True)
        simclr_wrapper = make_simclr_loader(t.cfg, train_x).wrapper
        recipe_vps = _views_per_s(recipe_wrapper, threads)
        simclr_vps = _views_per_s(simclr_wrapper, threads)
        recipe_vps_1 = _views_per_s(recipe_wrapper, 1)
        epoch_ms = epochs[0]  # the run's epoch, its files decoded on first use

        # the loader's share of a step: LOADER_STEPS steps fed from batches
        # built beforehand against as many fed by the loader as it runs, in
        # turns (built, live, live, built)
        it = iter(t.train_loader_x)
        built = [next(it) for _ in range(LOADER_STEPS)]
        it.close()

        def live():
            it = iter(t.train_loader_x)
            try:
                for _ in range(LOADER_STEPS):
                    yield next(it)
            finally:
                it.close()

        def step_ms(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in t.device_batches(batches):
                t.train_step(b)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / LOADER_STEPS

        per_step = {"built": [], "live": []}
        for side in ("built", "live", "live", "built"):
            per_step[side].append(step_ms(built if side == "built" else live()))

        # the profiled window: steps 3-7 of an epoch's loader, in its steady
        # state (producer thread and pool started, batches prefetched)
        it = t.device_batches(t.train_loader_x)
        for _, b in zip(range(2), it):
            t.train_step(b)

        def profiled_steps():
            for _, b in zip(range(HOST_PROFILE_STEPS), it):
                t.train_step(b)

        wall, busy = _profile(f"{HOST_PROFILE_STEPS} PromptSRC steps on the host pipeline "
                              f"(batch {t.batch_size}, loader to step, steady state)",
                              profiled_steps, top=6, groups=FLASH_GROUPS)
        it.close()
        n_img = t.steps_per_epoch * t.batch_size
        result = {
            "threads": threads, "fixture_views_checked": n_fixture_views,
            "recipe_views_per_s": recipe_vps, "simclr_views_per_s": simclr_vps,
            "recipe_views_per_s_one_thread": recipe_vps_1,
            "views_images": len(train_x), "epoch_ms": epoch_ms, "epoch_images": n_img,
            "device_aug_epoch_ms": recognition["epoch_ms"],
            "device_aug_epoch_images": recognition["epoch_images"], "run_s": run_s,
            "coop_simclr_step_ms": coop_step_ms, "coop_simclr_step_ms_all": coop_ms,
            "coop_simclr_batch": coop_batch, "coop_run_s": coop_run_s,
            "profiled_steps": HOST_PROFILE_STEPS, "profiled_wall_ms": wall,
            "profiled_busy_ms": busy, "idle_share": max(0.0, 1 - busy / wall),
            "step_ms_prebuilt_batches": per_step["built"], "step_ms_live_loader": per_step["live"],
        }
        log(f"host_aug: at {threads} threads over {len(train_x)} tree files (decoded cache warm): "
            f"recipe list {recipe_vps:.1f} views/s ({recipe_vps_1:.1f} on one thread), SimCLR "
            f"list {simclr_vps:.1f} views/s; host-aug "
            f"epoch {epoch_ms:.1f} ms ({n_img} images, {epoch_ms / n_img:.2f} ms each) beside "
            f"phase 12's DEVICE_AUG epoch {recognition['epoch_ms']:.1f} ms "
            f"({recognition['epoch_images']} images, "
            f"{recognition['epoch_ms'] / recognition['epoch_images']:.2f} ms each); CoOp SimCLR "
            f"step {coop_step_ms:.2f} ms (batch "
            f"{coop_batch}, synced, {[round(x, 2) for x in coop_ms]}); device idle share over "
            f"{HOST_PROFILE_STEPS} profiled host-aug steps {result['idle_share']:.3f}; ms per step "
            f"over {LOADER_STEPS} steps from batches built beforehand {per_step['built']}, from "
            f"the loader as it runs {per_step['live']}")
        print(json.dumps({"host_aug": result}), flush=True)
        del t
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


# ------------------------------------------------------------------ phase 14
INT8_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))  # (K, N): qkv, out, fc, proj
INT8_M = 100 * 197  # a serving batch of 100 images at L = 197
INT8_OPS_PER_S = 1979e12  # int8 dense tensor-core peak (H100 SXM data sheet, 700 W)
# the image features' cosine to the bf16 tower's: tests/test_quant.py:77 (dynamic), :279 (static)
MIN_INT8_COSINE = {"dynamic": 0.99, "static": 0.985}
INT8_CAL_BATCHES = 4  # MODEL.QUANT_INT8_CALIB_BATCHES' default
INT8_TIMED = 3  # timed repeats per side, in turns (5 before phase 20)
IVLP_INT8_STEPS = 3
PREDICT_FILES = 100


def _bf16_ulps(a, b):
    """Largest |a - b| in units of one bf16 ulp at max(|a|, |b|)."""
    import torch

    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(torch.finfo(torch.bfloat16).tiny)
    return float(((a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


# a name fragment of the int8 GEMM kernels cuBLASLt takes (CUTLASS's
# "..._i16832gemm_s8_...", its own "..._gemm_s8s8..."), beside the names a
# lone torch._int_mm shows the profiler
INT8_GEMM_FRAGMENT = "gemm_s8"


def _kernel_names(fn):
    """The names of the CUDA kernels one call of ``fn`` launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # three calls: late in a long run the profiler can drop a profile's only
    # kernel record (its CPU events show the launch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    names = {e.key for e in events if e.device_type == DeviceType.CUDA}
    if not names:
        log(f"profile: a lone call showed no device kernel ({len(events)} events on "
            f"{sorted({str(e.device_type) for e in events})}: {[e.key for e in events][:8]})")
    return names


def _int8_product():
    """``int8_linear`` at the ViT-B/16 tower's four GEMM shapes, M = 100 x
    197, bf16, dynamic and static: q8 and scale, the int8 activations and the
    int32 accumulators byte-equal to the same function on the CPU, the output
    within one bf16 ulp of the CPU's; timed (CUDA events, in turns) beside
    the bf16 product ``x @ w`` of the float tower, the bare ``torch._int_mm``
    on the stored (column-major) q8 and on a row-major copy, and the dynamic
    activation quantization alone.  Returns (rows, int8 GEMM kernel names)."""
    import torch

    from fsvlm_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(14)
    rows, names = [], set()
    for K, N in INT8_SHAPES:
        x = torch.randn((INT8_M, K), generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn((K, N), generator=gen, device="cuda") * 0.02
        rec, rec_c = quant.quantize_weight(w), quant.quantize_weight(w.cpu())
        exact = {"q8": torch.equal(rec.q8.cpu(), rec_c.q8),
                 "scale": torch.equal(rec.scale.cpu(), rec_c.scale)}
        ulps = {}
        xs = quant._over_127(x.float().abs().amax())
        for mode, s in (("dynamic", None), ("static", xs)):
            xq, _ = quant.quantize_activation(x, s)
            xq_c, _ = quant.quantize_activation(x.cpu(), None if s is None else s.cpu())
            exact[f"{mode} xq"] = torch.equal(xq.cpu(), xq_c)
            exact[f"{mode} int32"] = torch.equal(torch._int_mm(xq, rec.q8).cpu(),
                                                 torch._int_mm(xq_c, rec_c.q8))
            rec.xs, rec_c.xs = s, None if s is None else s.cpu()
            ulps[mode] = _bf16_ulps(quant.int8_linear(x, rec).cpu(),
                                    quant.int8_linear(x.cpu(), rec_c))
        rec.xs = None
        static = quant.Int8Weight(rec.q8, rec.scale, xs)
        xq, _ = quant.quantize_activation(x)
        q8_rowmajor = rec.q8.contiguous()
        w_bf16 = w.to(torch.bfloat16)
        names |= _kernel_names(lambda: torch._int_mm(xq, rec.q8))
        fns = {"int8_linear": lambda: quant.int8_linear(x, rec),
               "int8_linear_static": lambda: quant.int8_linear(x, static),
               "bf16": lambda: x @ w_bf16,
               "int_mm": lambda: torch._int_mm(xq, rec.q8),
               "int_mm_rowmajor": lambda: torch._int_mm(xq, q8_rowmajor),
               "act_quant": lambda: quant.quantize_activation(x)}
        ms = {k: [] for k in fns}
        for _ in range(2):
            for k, fn in fns.items():
                ms[k].append(_time_ms(fn))
        ms = {k: float(np.median(v)) for k, v in ms.items()}
        ops = 2.0 * INT8_M * K * N
        int8_bytes = INT8_M * K * 2 + K * N + N * 4 + INT8_M * N * 2
        bf16_bytes = INT8_M * K * 2 + K * N * 2 + INT8_M * N * 2
        row = {"shape": [INT8_M, K, N], "exact": exact, "max_ulps": ulps, "ms": ms,
               "bound_ms": max(int8_bytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3,
               "bound_by": ("bytes" if int8_bytes / HBM_BYTES_PER_S > ops / INT8_OPS_PER_S
                            else "operations"),
               "bf16_bound_ms": max(bf16_bytes / HBM_BYTES_PER_S,
                                    ops / PEAK_FLOPS["bfloat16"]) * 1e3}
        rows.append(row)
        log(f"int8: product M={INT8_M} K={K} N={N}: byte-equal to the CPU {exact}; max bf16 "
            f"ulps to the CPU {ulps}; ms int8_linear {ms['int8_linear']:.4f} (static "
            f"{ms['int8_linear_static']:.4f}; _int_mm alone {ms['int_mm']:.4f}, with a row-major "
            f"q8 {ms['int_mm_rowmajor']:.4f}; act quant {ms['act_quant']:.4f}), bf16 x @ w "
            f"{ms['bf16']:.4f}; bound {row['bound_ms']:.4f} ({row['bound_by']}), bf16's "
            f"{row['bf16_bound_ms']:.4f}")
        if not all(exact.values()) or max(ulps.values()) > 1.0:
            raise SystemExit(f"FAIL: int8: the product at K={K} N={N} differs from the CPU's")
        del x, w, rec, rec_c, static, xq, q8_rowmajor, w_bf16
    log(f"int8: the GEMM kernels of torch._int_mm: {sorted(names)}; counted with those whose "
        f"names hold {INT8_GEMM_FRAGMENT!r}")
    return rows, names | {INT8_GEMM_FRAGMENT}


def _gemm_bytes(blocks):
    """Bytes of the four GEMM weights of every block (an int8 record's q8,
    scale and xs)."""
    from fsvlm_tpu_torch.ops import quant

    total = 0
    for b in blocks:
        for group, name in quant._TOWER_GEMMS:
            w = getattr(getattr(b, group), name)
            parts = [w.q8, w.scale, w.xs] if quant.is_quantized(w) else [w]
            total += sum(t.numel() * t.element_size() for t in parts if t is not None)
    return total


def _int8_serving(clip, int8_names):
    """ZeroshotCLIP ViT-B/16 test() on phase 8's N_TEST cache images with
    the image tower in bf16, and in int8: attn + mlp dynamic, mlp only, and
    static scales calibrated over the 288-image cache in 4 batches of 72
    (its eval views, the loader's place): image features' cosine to the bf16
    tower's, top-1 agreement, #6 exactly 12 per batch of 100 in test() (and
    12 per calibration batch), the int8 products 12 x 4 per batch (12 x 2
    for mlp only), the int8 GEMM kernels by name in one profiled batch, ms
    per batch of 100 in turns, the towers' GEMM weight bytes."""
    import torch

    from fsvlm_tpu_torch.models.clip import encode_image
    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.ops import quant
    from fsvlm_tpu_torch.trainers.zsclip import ZeroshotCLIP

    cache, _ = _train_cache()
    labels = np.random.RandomState(1234).randint(0, N_CLASSES, N_TEST)
    t = ZeroshotCLIP(_yaml_cfg(LP_RECIPE), [f"class {i}" for i in range(N_CLASSES)], clip=clip,
                     device="cuda", steps_per_epoch=1)
    t.test_loader = [{"img": cache[i::INT8_CAL_BATCHES].cpu().numpy()}
                     for i in range(INT8_CAL_BATCHES)]
    m = t.cfg.MODEL
    Lv = clip.cfg.vision_layers
    x = t.eval_images(cache[:N_TEST])
    variants = {"bf16": {}, "int8 attn+mlp": {"QUANT_INT8": True},
                "int8 mlp": {"QUANT_INT8": True, "QUANT_INT8_FAMILIES": ["mlp"]},
                "int8 static": {"QUANT_INT8": True, "QUANT_INT8_STATIC": True}}
    out, frozen = {}, {}
    for name, opts in variants.items():
        m.QUANT_INT8, m.QUANT_INT8_FAMILIES, m.QUANT_INT8_STATIC = False, ["attn", "mlp"], False
        for k, v in opts.items():
            setattr(m, k, v)
        t._frozen_eval = None
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        console = io.StringIO()
        with contextlib.redirect_stdout(console):
            fe = frozen[name] = t.frozen_eval()
        cal = {k: n for k, n in fa.LAUNCHES.items() if n}
        seen = []
        inner = t.logits_fn
        t.logits_fn = lambda *a, f=inner: seen.append(f(*a)) or seen[-1]
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        quant.LAUNCHES["int8_gemm"] = 0
        with contextlib.redirect_stdout(io.StringIO()):
            acc = t.test(cache[:N_TEST], labels)
        torch.cuda.synchronize()
        launches = {k: n for k, n in fa.LAUNCHES.items() if n}
        int8_gemms = quant.LAUNCHES["int8_gemm"]
        t.logits_fn = inner
        with torch.no_grad():
            feats = torch.cat([encode_image(fe["clip"], x[i:i + 100], compute_dtype=torch.bfloat16)
                               for i in range(0, N_TEST, 100)]).float()
        counts = {}
        _profile(f"ZeroshotCLIP {name} serving batch of 100",
                 lambda: t.logits_fn(t.params, fe, x[:100]), top=8,
                 groups={"int8 GEMM": tuple(int8_names), "#6": FLASH_FWD}, counts=counts)
        out[name] = {"acc": acc, "logits": torch.cat(seen).float(), "feats": feats,
                     "launches": launches, "calibration_launches": cal, "profile": counts,
                     "int8_gemms": int8_gemms,
                     "gemm_bytes": _gemm_bytes(fe["clip"].visual.blocks),
                     "log": console.getvalue().strip()}
    ref = out["bf16"]
    # int8 products per batch of 100 (12 layers x 4 GEMMs, or x 2 for mlp only)
    want_gemms = {"bf16": 0, "int8 attn+mlp": 4 * Lv, "int8 mlp": 2 * Lv, "int8 static": 4 * Lv}
    for name, r in out.items():
        cos = torch.nn.functional.cosine_similarity(r["feats"], ref["feats"], dim=-1).min().item()
        top1 = (r["logits"].argmax(-1) == ref["logits"].argmax(-1)).float().mean().item()
        r.update(min_cosine=cos, top1_agreement=top1)
        limit = MIN_INT8_COSINE["static" if "static" in name else "dynamic"]
        want_cal = {fa.KERNEL: INT8_CAL_BATCHES * Lv} if "static" in name else {}
        log(f"int8: ZeroshotCLIP test() {name}: {r['log'] or '(float tower)'}; accuracy "
            f"{r['acc']:.1f}%; image features' min cosine to bf16 {cos:.6f} (limit {limit}); top-1 "
            f"agreement with bf16 {top1:.4f} (random weights); launches in test() "
            f"{r['launches']}, int8 products {r['int8_gemms']}, calibration "
            f"{r['calibration_launches']}; one profiled batch's kernels: {r['profile']}; GEMM "
            f"weight bytes {r['gemm_bytes']}")
        if (r["launches"] != {fa.KERNEL: 2 * Lv} or r["calibration_launches"] != want_cal
                or r["int8_gemms"] != -(-N_TEST // 100) * want_gemms[name]
                or (r["profile"].get("int8 GEMM", 0) > 0) != (want_gemms[name] > 0)
                or not torch.isfinite(r["logits"]).all() or (name != "bf16" and cos < limit)):
            raise SystemExit(f"FAIL: int8: ZeroshotCLIP {name} serving disagrees with the bf16 "
                             f"tower, or its launches are not as derived")
    ms = {name: [] for name in out}
    with torch.no_grad():
        for _ in range(INT8_TIMED):
            for name in out:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t.logits_fn(t.params, frozen[name], x[:100])
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
    summary = {name: {"ms_per_batch_100": float(np.median(ms[name])), "accuracy": r["acc"],
                      "min_cosine": r["min_cosine"], "top1_agreement": r["top1_agreement"],
                      "gemm_weight_bytes": r["gemm_bytes"], "int8_gemm_launches": r["int8_gemms"],
                      "profiled_int8_gemm_kernels": r["profile"].get("int8 GEMM"),
                      "profiled_flash_fwd_kernels": r["profile"].get("#6")}
               for name, r in out.items()}
    log(f"int8: ms per batch of 100, {INT8_TIMED} each in turns: "
        + ", ".join(f"{name} {[round(v, 3) for v in ms[name]]}" for name in ms))
    del t, frozen, out
    return summary, {fa.KERNEL: 2 * Lv}


def _int8_teacher(clip, int8_names):
    """PromptSRC at phase 6's settings with the per-step teacher in bf16,
    in int8 dynamic and in int8 static (scales calibrated over 4 augmented
    batches of the cache: the host path's normalized views; the trainer
    itself refuses static scales under DEVICE_AUG, checked first): 6 steps
    over 2 epochs each on the same cache and draws, the teacher's features
    on one batch, #6-#8 as phase 6 derived, the int8 products 48 per step, one
    step under sync debug mode 'error', steps timed in turns, one profiled
    step each, peak memory."""
    import torch

    from fsvlm_tpu_torch.models.clip import encode_image
    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.ops import quant
    from fsvlm_tpu_torch.trainers.ivlp_family import vlp_image_features
    from fsvlm_tpu_torch.trainers.promptsrc import PromptSRC

    classnames = [f"class {i}" for i in range(N_CLASSES)]
    cache, labels = _train_cache()
    n = clip.cfg.vision_layers
    cfg_s = _train_cfg("PROMPTSRC")
    cfg_s.TRAINER.PROMPTSRC.INT8_TEACHER = cfg_s.MODEL.QUANT_INT8_STATIC = True
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            PromptSRC(cfg_s, classnames, cache, labels, clip=clip, device="cuda",
                      steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
        raise SystemExit("FAIL: int8: static teacher scales under DEVICE_AUG did not raise")
    except ValueError as e:
        log(f"int8: static teacher scales under DEVICE_AUG raise: {e}")
    trainers, logs = {}, {}
    for name in ("bf16", "int8 dynamic", "int8 static"):
        cfg = _train_cfg("PROMPTSRC")
        cfg.TRAINER.PROMPTSRC.INT8_TEACHER = name != "bf16"
        console = io.StringIO()
        with contextlib.redirect_stdout(console):
            t = PromptSRC(cfg, classnames, cache, labels, clip=clip, device="cuda",
                          steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
        logs[name] = [ln for ln in console.getvalue().splitlines() if "int8" in ln]
        trainers[name] = t
    cal = [_augmented_batch(cache, labels, seed)["img"] for seed in (21, 22, 23, 24)]
    amax = quant.calibrate_visual_amax(clip, cal)
    trainers["int8 static"].frozen["clip_teacher"] = quant.quantize_clip(
        clip, static_amax={"visual": amax})
    log(f"int8: teacher towers: {logs}; static scales from 4 augmented batches, amax per layer "
        f"(qkv, out, fc, proj) {[[round(float(v), 3) for v in row] for row in amax]}")

    img = _augmented_batch(cache, labels, 7)["img"]
    with torch.no_grad():
        ref = vlp_image_features({}, trainers["bf16"].frozen, img, torch.bfloat16).float()
        cos = {name: torch.nn.functional.cosine_similarity(
            encode_image(t.frozen["clip_teacher"], img, compute_dtype=torch.bfloat16).float(), ref,
            dim=-1).min().item() for name, t in trainers.items() if name != "bf16"}
    per_step = {fa.KERNEL: 3 * n, fa.KERNEL_DKV: 2 * n, fa.KERNEL_DQ: 2 * n}
    steps = TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH
    runs = {}
    for name, t in trainers.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        quant.LAUNCHES["int8_gemm"] = 0
        _zero_fused_steps()
        hist = t.train()  # fused (TRAIN.EPOCH_FUSE auto)
        launches = dict(fa.LAUNCHES)
        wrapped, fsteps = _wrapped_steps(f"int8: PromptSRC {name} teacher", steps)
        runs[name] = {"losses": [m["loss"] for h in hist for m in h], "launches": launches,
                      "int8_gemm_launches": quant.LAUNCHES["int8_gemm"],
                      "peak_bytes": torch.cuda.max_memory_allocated(), "wrapped": wrapped,
                      "fused_steps": fsteps}
        _others_silent(launches, "flash_attn", f"the PromptSRC {name} teacher path")
    base = runs["bf16"]["losses"]
    for name, r in runs.items():
        gaps = [abs(a - b) for a, b in zip(r["losses"], base)]
        r["loss_gap_max"] = max(gaps)
        log(f"int8: PromptSRC, {name} teacher: losses {[round(v, 5) for v in r['losses']]}; "
            f"max |loss - bf16 teacher's| {max(gaps):.3e}; {steps} steps fused "
            f"{r['fused_steps']}: wrapper calls over the {r['wrapped']} steps that are not "
            f"replays { {k: v for k, v in r['launches'].items() if v} }, int8 products "
            f"{r['int8_gemm_launches']}; peak memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB"
            + (f"; teacher features' min cosine to bf16 {cos[name]:.6f}" if name in cos else ""))
        if (len(r["losses"]) != steps or not all(np.isfinite(r["losses"]))
                or r["fused_steps"]["replays"] == 0
                or any(r["launches"][k] != v * r["wrapped"] for k, v in per_step.items())
                or r["int8_gemm_launches"] != (0 if name == "bf16" else 4 * n * r["wrapped"])
                or (name in cos and cos[name] < MIN_INT8_COSINE[name.split()[1]])):
            raise SystemExit(f"FAIL: int8: the PromptSRC {name} teacher steps")
    index = trainers["bf16"].epoch_schedule()[0][0]
    for name in ("int8 dynamic", "int8 static"):
        _no_sync_step(f"int8: PromptSRC {name} teacher", trainers[name].train_step_resident, index)
    _fused_vs_eager("int8: PromptSRC int8 dynamic teacher", trainers["int8 dynamic"], 1, per_step,
                    FLASH_GROUPS)
    ms = {name: [] for name in trainers}
    for _ in range(INT8_TIMED):
        for name, t in trainers.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.train_step_resident(index)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    for name, t in trainers.items():
        counts = {}
        wall, busy = _profile(f"one PromptSRC step, {name} teacher, batch {TRAIN_BATCH}",
                              lambda: t.train_step_resident(index), top=10,
                              groups={"int8 GEMM": tuple(int8_names), **FLASH_GROUPS},
                              counts=counts)
        runs[name].update(step_ms=float(np.median(ms[name])), wall_ms=wall, busy_ms=busy,
                          idle=max(0.0, 1 - busy / wall),
                          profiled_int8_gemm_kernels=counts["int8 GEMM"])
        if (counts["int8 GEMM"] > 0) != (name != "bf16"):
            raise SystemExit(f"FAIL: int8: the {name} teacher step's profile shows "
                             f"{counts['int8 GEMM']} int8 GEMM kernels")
    log(f"int8: PromptSRC step ms, {INT8_TIMED} each in turns: "
        + ", ".join(f"{name} {[round(v, 2) for v in ms[name]]}" for name in ms))
    out = {name: {k: r[k] for k in ("loss_gap_max", "peak_bytes", "step_ms", "busy_ms", "idle",
                                     "int8_gemm_launches", "profiled_int8_gemm_kernels")}
           for name, r in runs.items()}
    for name, c in cos.items():
        out[name]["teacher_min_cosine"] = c
    launches = runs["int8 dynamic"]["launches"]
    del trainers
    torch.cuda.empty_cache()
    return out, launches


def _int8_teacher_ivlp(clip):
    """Under FSVLM_FORCE_PALLAS=1 (the caller sets it): IVLP KD at KD_ALPHA
    0.5 with the int8 KD teacher, against the bf16 teacher on one batch
    (features' cosine; the logits' gap beside phase 7's rule, reported), then
    IVLP_INT8_STEPS steps with #3-#5 at phase 7's counts."""
    import torch

    from fsvlm_tpu_torch.models.clip import encode_image
    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.trainers.ivlp import IVLP
    from fsvlm_tpu_torch.trainers.ivlp_family import vlp_image_features

    classnames = [f"class {i}" for i in range(N_CLASSES)]
    cache, labels = _train_cache()
    n = clip.cfg.vision_layers
    trainers = {}
    for name in ("bf16", "int8"):
        cfg = _train_cfg("IVLP")
        cfg.TRAINER.IVLP.KD_ALPHA = 0.5
        cfg.TRAINER.IVLP.INT8_TEACHER = name == "int8"
        with contextlib.redirect_stdout(io.StringIO()):
            trainers[name] = IVLP(cfg, classnames, cache, labels, clip=clip, device="cuda",
                                  steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    kq, kf = trainers["int8"], trainers["bf16"]
    img = _augmented_batch(cache, labels, 8)["img"]
    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
    tq = kq.teacher_logits(kq.frozen, img)
    teacher_launches = {k: v for k, v in fa.LAUNCHES.items() if v}
    tf = kf.teacher_logits(kf.frozen, img)
    with torch.no_grad():
        cos = torch.nn.functional.cosine_similarity(
            encode_image(kq.frozen["clip_teacher"], img, compute_dtype=torch.bfloat16).float(),
            vlp_image_features({}, kf.frozen, img, torch.bfloat16).float(), dim=-1).min().item()
    dlog = (tq - tf).abs().amax(dim=-1)
    rel = (dlog / tf.std(dim=-1)).max().item()
    per_step = {fa.BW_KERNEL: 3 * n, fa.BW_KERNEL_DKV: 2 * n, fa.BW_KERNEL_DQ: 2 * n}
    losses = []
    torch.cuda.synchronize()
    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
    for step in range(IVLP_INT8_STEPS):
        idx = torch.arange(step * TRAIN_BATCH, (step + 1) * TRAIN_BATCH, device="cuda")
        losses.append(kq.train_step_resident(idx)["loss"])
    losses = [v.item() for v in losses]
    launches = dict(fa.LAUNCHES)
    log(f"int8: IVLP KD (KD_ALPHA 0.5) int8 teacher under FSVLM_FORCE_PALLAS=1: teacher features' "
        f"min cosine to bf16 {cos:.6f} (limit {MIN_INT8_COSINE['dynamic']}); teacher logits' max "
        f"|dlogit| {dlog.max().item():.4f}, max |dlogit|/spread {rel:.4f} (phase 7's limits "
        f"{MAX_DLOGIT:g}, {MAX_DLOGIT_OVER_SPREAD:g} hold the kernels to the plain attention, "
        f"not int8 to bf16: reported); launches of the teacher pass {teacher_launches}; "
        f"{IVLP_INT8_STEPS} steps: losses {[round(v, 5) for v in losses]}, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    _others_silent(launches, "blockwise", "the IVLP int8 teacher steps")
    if (cos < MIN_INT8_COSINE["dynamic"] or teacher_launches != {fa.BW_KERNEL: n}
            or not all(np.isfinite(losses))
            or any(launches[k] != v * IVLP_INT8_STEPS for k, v in per_step.items())):
        raise SystemExit("FAIL: int8: the IVLP int8 KD teacher")
    _fused_vs_eager("int8: IVLP KD int8 teacher", kq, 1, per_step, BW_GROUPS)
    del trainers, kq, kf
    return ({"teacher_min_cosine": cos, "teacher_max_dlogit": dlog.max().item(),
             "teacher_max_dlogit_over_spread": rel, "losses": losses}, launches)


def _start_tool(module, *args):
    """``python -m fsvlm_tpu_torch.tools.<module> args`` from the checkout,
    started; ``_finish_tool`` waits for it."""
    return module, subprocess.Popen(
        [sys.executable, "-m", f"fsvlm_tpu_torch.tools.{module}", *args],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), time.perf_counter()


def _finish_tool(started, timeout=600):
    """(stdout, seconds from start to exit) of a ``_start_tool`` process
    (raises with the end of its output if it fails)."""
    module, proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(stdout[-3000:], stderr[-3000:], flush=True)
        raise SystemExit(f"FAIL: tools: python -m fsvlm_tpu_torch.tools.{module} exited "
                         f"{proc.returncode}")
    return stdout, wall


def _finish_tools(started, timeout=600):
    """``_finish_tool`` of each process of a dict, each awaited by a thread
    of its own, so that each wall time ends at its own process's exit."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(len(started)) as pool:
        futures = {k: pool.submit(_finish_tool, p, timeout) for k, p in started.items()}
        return {k: f.result() for k, f in futures.items()}


def _run_tool(module, *args, timeout=600):
    """``python -m fsvlm_tpu_torch.tools.<module> args`` from the checkout;
    returns its stdout (raises with the end of its output if it fails)."""
    return _finish_tool(_start_tool(module, *args), timeout)[0]


def _tools_on_tree(clip, tree):
    """Phase 12's tree and its PromptSRC model: ``predict`` as a subprocess
    over the first PREDICT_FILES test files (top-1 equal to --eval-only's on
    the same files; again under MODEL.QUANT_INT8), images/s of predict() in
    this process for both; export_torch_checkpoint then
    ``import_torch_prompts`` as a subprocess then ``--eval-only``
    (predictions exact); ``interpret_prompt`` as a subprocess (every context
    vector's line).  The four subprocesses run at once (each spends most of
    its ~30 s building a random ViT-B/16 on the host), before the rest."""
    import torch

    from fsvlm_tpu_torch.engine.checkpoint import load_checkpoint
    from fsvlm_tpu_torch.engine.trainer import build_trainer
    from fsvlm_tpu_torch.tools import predict
    from fsvlm_tpu_torch.train import build_argparser, setup_cfg
    from fsvlm_tpu_torch.trainers.import_torch import export_torch_checkpoint

    work, out = tree["work"], tree["out"]
    items = tree["test_items"][:PREDICT_FILES]
    files = [d.impath for d in items]
    want = [tree["lab2cname"][int(c)] for c in tree["y_pred"][:PREDICT_FILES]]
    # phase 12's command for the model, with the clip it ran (phase 4's:
    # random from seed 0, bf16) rebuilt from that seed; no teacher cache
    flags = ["--root", work, "--dataset-config-file", "configs/datasets/caltech101.yaml",
             "--config-file", CLI_RECIPE, "--trainer", "PromptSRC", "--seed", "0", "--device",
             "cuda", "--model-dir", out]
    opts = ["MODEL.BACKBONE.PRETRAINED", "False", "MODEL.FROZEN_DTYPE", "bf16",
            "TRAINER.PROMPTSRC.PREC", "bf16", "DATASET.NUM_SHOTS", "-1",
            "DATASET.PER_CLASS_SHOTS", str(RECOG_SHOTS)]
    modes = (("bf16", []), ("int8", ["MODEL.QUANT_INT8", "True"]))
    ref = os.path.join(work, "model.pth.tar-1")
    best = os.path.join(out, "VLPromptLearner", "model-best.pkl")
    export_torch_checkpoint(best, "PromptSRC", ref)
    imported = os.path.join(work, "imported")
    started = {mode: _start_tool("predict", *flags, "--images", *files, "--topk", "5",
                                 "--pred-batch", "100", "--out",
                                 os.path.join(work, f"predict_{mode}.jsonl"), *opts, *quant_opts)
               for mode, quant_opts in modes}
    started["import"] = _start_tool("import_torch_prompts", ref, "--trainer", "PromptSRC",
                                    "--best", "--output-dir", imported)
    started["interpret"] = _start_tool("interpret_prompt", best, "--backbone", "ViT-B/16",
                                       "--topk", "4")
    done = _finish_tools(started)
    said = {k: out for k, (out, _) in done.items()}
    wall = {k: s for k, (_, s) in done.items()}
    result = {}
    for mode, quant_opts in modes:
        jsonl = os.path.join(work, f"predict_{mode}.jsonl")
        rows = [json.loads(ln) for ln in _read(jsonl).splitlines()]
        got = [r["topk"][0]["label"] for r in rows]
        result[mode] = {"rows": len(rows), "subprocess_s": wall[mode],
                        "top1_equal_test": got == want,
                        "top1_agreement_test": float(np.mean([a == b for a, b in zip(got, want)]))}
        if len(rows) != PREDICT_FILES or [r["path"] for r in rows] != files or any(
                len(r["topk"]) != 5 for r in rows):
            raise SystemExit(f"FAIL: tools: predict ({mode}) did not give one row per file")
        if mode == "bf16" and got != want:
            raise SystemExit("FAIL: tools: predict's top-1 differs from --eval-only's test()")
        # predict() in this process on the same model: images/s (decode, eval
        # view, towers), after one untimed pass
        cfg = setup_cfg(build_argparser().parse_args(flags + opts + quant_opts))
        with contextlib.redirect_stdout(io.StringIO()):
            t = build_trainer(cfg, device="cuda", clip=clip)
            t.load_model(out)
            list(predict.predict(t, cfg, files, pred_batch=100))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inproc = [tk[0][0] for _, tk in predict.predict(t, cfg, files, pred_batch=100)]
            torch.cuda.synchronize()
            result[mode]["images_per_s"] = PREDICT_FILES / (time.perf_counter() - t0)
        result[mode]["top1_equal_subprocess"] = inproc == got
        del t
    log(f"tools: predict over {PREDICT_FILES} test files of phase 12's tree (subprocess_s: "
        f"this call's wall from start to exit, the four tool processes run at once): {result}; "
        f"import_torch_prompts {wall['import']:.1f} s, interpret_prompt "
        f"{wall['interpret']:.1f} s")

    t3 = _run_cli(clip, tree["argv"](os.path.join(work, "eval_imported"), "--eval-only",
                                     "--model-dir", imported))
    exact = t3.evaluator.y_pred == tree["y_pred"] and t3.evaluator.y_true == tree["y_true"]
    log(f"tools: export -> import_torch_prompts -> --eval-only: "
        f"{said['import'].strip().splitlines()[-1]}; "
        f"predictions on {len(t3.evaluator.y_pred)} test images equal to phase 12's: {exact}")
    if not exact:
        raise SystemExit("FAIL: tools: the import round trip changed the predictions")
    del t3

    lines = [ln for ln in said["interpret"].splitlines() if ln.startswith("ctx[")]
    state = load_checkpoint(best)["state_dict"]
    n_vec = len(state["ctx"]) * (1 + len(state.get("text_deep", ())))
    log(f"tools: interpret_prompt: {len(lines)} context vectors (expected {n_vec}); first "
        f"{lines[:2]}")
    if len(lines) != n_vec or any(ln.count("(") != 4 for ln in lines):
        raise SystemExit("FAIL: tools: interpret_prompt did not print top-4 words per vector")
    return dict(result, round_trip_exact=exact, interpret_vectors=len(lines))


@_timed
def phase_int8_tools(clip, tree):
    """Phase 14 (module docstring).  Returns (the ``{"int8": ...}`` numbers,
    #6-#8's launches on the int8 serving and teacher paths, #3-#5's on the
    IVLP int8 teacher path)."""
    t0 = time.perf_counter()
    part_s = {}

    def part(name, fn, route=None):
        t1 = time.perf_counter()
        with force_pallas(route):
            out = fn()
        part_s[name] = round(time.perf_counter() - t1, 1)
        return out

    product, int8_names = part("product", _int8_product)
    serving, launches_serving = part("serving", lambda: _int8_serving(clip, int8_names))
    teacher, launches_teacher = part("teacher", lambda: _int8_teacher(clip, int8_names))
    ivlp, launches_ivlp = part("ivlp_teacher", lambda: _int8_teacher_ivlp(clip), "1")
    tools = part("tools", lambda: _tools_on_tree(clip, tree))
    log(f"int8: seconds by part {json.dumps(part_s)}")
    result = {"product": product, "int8_gemm_kernels": sorted(int8_names), "serving": serving,
              "promptsrc_teacher": teacher, "ivlp_teacher": ivlp, "tools": tools,
              "part_s": part_s, "phase_s": time.perf_counter() - t0}
    print(json.dumps({"int8": result}), flush=True)
    return result, launches_serving, launches_teacher, launches_ivlp


# the tool's default --num-shots 16 cut to 8 for the call's time when phase 20
# came in: 800 train images, 400 val; the search 34.5 s against 50.0 s at 16,
# each card fit within 0.17 of the objective-gap bound (measured on an H100
# 80GB HBM3 at 700 W).  At 4 shots a card fit left the CPU's objective by more
# than the CPU's own spread in two calls: the tied fits of a 400-row problem
LPCLIP_SHOTS = 8
LPCLIP_SEED = 1  # the tool's default --seed; the fp32 ViT-B/16 is random from it
FEATURE_MIN_COSINE = 0.999  # the card's fp32 features against the plain attention's
LR_MAX_ITER = 1000  # the tool's fits' max_iter (sklearn's default)
LR_OBJ_RTOL = 1e-5  # the floor of the card/CPU objective gap's bound (relative)
EXPORT_CLASSES, EXPORT_BATCH = 100, 96  # the export tool's defaults
EXPORT_VARIANTS = [  # (label, dtype, int8, int8_static, logits' relative tolerance)
    ("fp32", "float32", False, False, 1e-5), ("bf16", "bfloat16", False, False, 1e-3),
    ("int8", "float32", True, False, 1e-3), ("int8_static", "float32", True, True, 1e-3)]
EXPORT_TURNS = 3  # timed calls per side, live and loaded in turns, after a warm-up (5 before phase 20)
# what a plain attention traced in the kernels' place would add to the graph
NOT_KERNEL_ATTENTION = ("scaled_dot_product", "softmax", "logsumexp", "fsvlm.blockwise",
                        "fsvlm.fused", "flash_attn_bwd")

_CPU_FITS = r"""
import json, sys, time
import numpy as np
from fsvlm_tpu_torch.tools.logreg import LogisticRegression
out = sys.argv[1]
cs = [(int(ic.split(":")[0]), float(ic.split(":")[1])) for ic in sys.argv[2].split(",") if ic]
train, val = np.load(out + "/train.npz"), np.load(out + "/val.npz")
X, y = train["feature_list"], train["label_list"]
perm = np.random.RandomState(0).permutation(len(y))
fits = {}
for i, c in cs:
    got = {}
    for side, rows in (("cpu", slice(None)), ("cpu_permuted", perm)):
        t0 = time.perf_counter()
        clf = LogisticRegression(C=c, device="cpu").fit(X[rows], y[rows])
        np.savez(f"{out}/{side}_{i}.npz", coef=clf.coef_, intercept=clf.intercept_)
        got[side] = {"s": time.perf_counter() - t0, "n_iter": int(clf.n_iter_[0]),
                     "acc": clf.score(val["feature_list"], val["label_list"]),
                     "pred": clf.predict(val["feature_list"]).tolist()}
    fits[i] = got
print(json.dumps(fits))
"""
CPU_FIT_PROCS = 3  # one-thread CPU processes sharing the converged C (round robin)

_LOAD_SERVING = r"""
import json, os, sys, time
import numpy as np
import torch
from fsvlm_tpu_torch.ops import flash_attention as fa
from fsvlm_tpu_torch.tools.export_serving import graph_ops, load_serving
work, labels = sys.argv[1], sys.argv[2].split(",")
torch.cuda.init()
deadline = time.monotonic() + 900
while not os.path.exists(work + "/ready"):  # the caller writes it after the artifacts
    if time.monotonic() > deadline:
        sys.exit("no artifacts")
    time.sleep(0.1)
images = torch.from_numpy(np.load(work + "/images.npy")).cuda()
result = {}
for label in labels:
    prog = load_serving(work + "/" + label + ".pt2")
    params = torch.load(work + "/" + label + "_params.pt", map_location="cuda")
    ops = graph_ops(prog.program)
    per_call = []
    for _ in range(2):
        torch.cuda.synchronize()
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        top1, logits = prog(params, images)
        torch.cuda.synchronize()
        per_call.append(dict(fa.LAUNCHES))
    np.savez(work + "/" + label + "_loaded.npz", top1=top1.cpu().numpy(),
             logits=logits.float().cpu().numpy())
    result[label] = {"launches_per_call": per_call, "ops": dict(ops)}
    del prog, params
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "fsvlm_tpu", "sklearn", "chip_smoke"))
print(json.dumps({"loaded": result, "forbidden_modules": bad}))
"""


def _lpclip_on_tree(tree):
    """Phase 15's lpclip part on phase 12's tree (module docstring).
    Returns (its numbers, #6's launches over the extraction, and the CPU
    fits' process with what ``_lpclip_cpu_check`` needs)."""
    import torch

    from fsvlm_tpu_torch.data import DataManager
    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.tools import lpclip
    from fsvlm_tpu_torch.trainers.backbone import load_clip_backbone

    work = tree["work"]
    out = os.path.join(work, "lpclip")
    argv = ["--root", work, "--dataset-config-file", "configs/datasets/caltech101.yaml",
            "--backbone", "ViT-B/16", "--num-shots", str(LPCLIP_SHOTS), "--seed",
            str(LPCLIP_SEED), "--output-dir", out, "--device", "cuda"]
    with contextlib.redirect_stdout(io.StringIO()):
        clip = load_clip_backbone("ViT-B/16", False, "fp32", LPCLIP_SEED, "cuda")
    console = io.StringIO()
    torch.cuda.synchronize()
    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(console):
            res = lpclip.main(argv, clip=clip)
    except BaseException:
        print(console.getvalue()[-4000:], flush=True)
        raise
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    said = console.getvalue().splitlines()
    lines = [ln for ln in said if ln.startswith(("C=", "Best C:"))]
    cfg = lpclip.build_cfg(lpclip.build_argparser().parse_args(argv))
    splits = res["splits"]
    batches = {"train": len(splits["train"][1]) // cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
               "val": -(-len(splits["val"][1]) // cfg.DATALOADER.TEST.BATCH_SIZE),
               "test": -(-len(splits["test"][1]) // cfg.DATALOADER.TEST.BATCH_SIZE)}
    expected = 12 * sum(batches.values())
    _others_silent(launches, fa.KERNEL, "lpclip's extraction")
    log(f"lpclip: ViT-B/16 fp32 (random, seed {LPCLIP_SEED}) on phase 12's tree, "
        f"{LPCLIP_SHOTS} shots: features {({k: v[0].shape for k, v in splits.items()})}, "
        f"batches {batches}; #6 launched {launches[fa.KERNEL]} (expected 12 x "
        f"{sum(batches.values())} = {expected}); run {run_s:.1f} s; printed "
        f"{said[-2:]}")
    if launches[fa.KERNEL] != expected:
        raise SystemExit("FAIL: lpclip: #6's launches differ from the splits' batch count x 12")
    for name in ("train", "val", "test"):
        with np.load(os.path.join(out, f"{name}.npz")) as z:
            if not (np.array_equal(z["feature_list"], splits[name][0])
                    and np.array_equal(z["label_list"], splits[name][1])):
                raise SystemExit(f"FAIL: lpclip: {name}.npz differs from the extraction")
        if not np.isfinite(splits[name][0]).all():
            raise SystemExit(f"FAIL: lpclip: non-finite {name} features")
    if "=> result" not in said or not any(ln.startswith("* accuracy:") for ln in said):
        raise SystemExit("FAIL: lpclip: no result line")
    images_per_s = {k: len(splits[k][1]) / res["extract_s"][k] for k in splits}

    # the card's features against the plain attention's on the same images
    # (the val split, in the same order)
    dm = DataManager(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        plain, plain_y = lpclip.extract_split(dm.val_loader, clip, attn_impl="plain")
    got, got_y = splits["val"]
    cos = float(np.min(np.sum(got * plain, 1) / (np.linalg.norm(got, axis=1)
                                                   * np.linalg.norm(plain, axis=1))))
    log(f"lpclip: val features ({len(got)} images) against the plain attention's: min cosine "
        f"{cos:.9f} (limit {FEATURE_MIN_COSINE}), max |d| "
        f"{np.abs(got - plain).max():.3e} of max |f| {np.abs(plain).max():.3e}")
    if not np.array_equal(got_y, plain_y) or not cos >= FEATURE_MIN_COSINE:
        raise SystemExit("FAIL: lpclip: the card's features disagree with the plain attention's")

    # the card's converged fits again on this machine's CPU, over the npz
    # files, in CPU_FIT_PROCS processes of one thread each started now (they
    # run beside the rest of the phase; on a busy host, torch's and the
    # BLAS's thread pools spin against each other over the fits' small
    # operations; one process took 150 s for the 11 C at 16 shots)
    converged = sorted({f["C"] for f in res["fits"] if f["n_iter"] < LR_MAX_ITER})
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = [subprocess.Popen(
        [sys.executable, "-c", _CPU_FITS, out,
         ",".join(f"{i}:{float(c)!r}" for i, c in enumerate(converged) if i % CPU_FIT_PROCS == k)],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k in range(CPU_FIT_PROCS)]
    del clip
    torch.cuda.empty_cache()
    models = {}  # the search's fitted model at each C
    for f in res["fits"]:
        models.setdefault(f["C"], f.pop("model"))
    result = {"images_per_s": images_per_s, "extract_s": res["extract_s"], "fits": res["fits"],
              "search_s": res["search_s"], "best_c": res["best_c"], "accuracy": res["accuracy"],
              "run_s": run_s, "val_min_cosine_to_plain": cos, "lines": lines,
              "batches": batches}
    return result, launches, (proc, out, converged, models)


def _lr_objective(coef, intercept, X, y, C):
    """sklearn's logistic-regression objective in float64 (mean multinomial
    cross-entropy plus 0.5 / (C n) ||coef||^2), classes sorted as y's."""
    X, W, b = X.astype(np.float64), coef.astype(np.float64), intercept.astype(np.float64)
    s = X @ W.T + b
    top = s.max(axis=1, keepdims=True)
    lse = np.log(np.exp(s - top).sum(axis=1)) + top[:, 0]
    ce = np.mean(lse - s[np.arange(len(y)), np.searchsorted(np.unique(y), y)])
    return ce + 0.5 / (C * len(y)) * np.sum(W * W)


def _lpclip_cpu_check(result, pending):
    """The CPU process's fits against the card search's own, at every C
    where the card's search converged (n_iter < max_iter): the card's
    solution must reach the float64 objective of the CPU's to within twice
    the CPU's own spread (its fit on the samples permuted moves the
    objective; the largest move over the search's C) or 1e-5.  On phase
    12's tree the train rows are 17 distinct images under 100 random
    labels: the optimum's class scores tie, so the val predictions and
    the printed lines hinge on where each fit stops, and are reported."""
    procs, out, converged, models = pending
    t0 = time.perf_counter()
    cpu_fits = {}
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode != 0:
            print(stdout[-3000:], stderr[-3000:], flush=True)
            raise SystemExit("FAIL: lpclip: a CPU fits' process failed")
        cpu_fits.update(json.loads(stdout.strip().splitlines()[-1]))
    wait_s = time.perf_counter() - t0
    cpu_fits = [cpu_fits[str(i)] for i in range(len(converged))]
    with np.load(os.path.join(out, "train.npz")) as z:
        train_f, train_y = z["feature_list"], z["label_list"]
    with np.load(os.path.join(out, "val.npz")) as z:
        val_f, val_y = z["feature_list"], z["label_list"]
    compared = []
    for i, (c, cpu) in enumerate(zip(converged, cpu_fits)):
        card = models[c]
        obj = {"card": _lr_objective(card.coef_, card.intercept_, train_f, train_y, c)}
        for side in ("cpu", "cpu_permuted"):
            with np.load(os.path.join(out, f"{side}_{i}.npz")) as z:
                obj[side] = _lr_objective(z["coef"], z["intercept"], train_f, train_y, c)
        pred = card.predict(val_f)
        compared.append({
            "C": c, "n_iter": [int(card.n_iter_[0]), cpu["cpu"]["n_iter"],
                               cpu["cpu_permuted"]["n_iter"]],
            "objective": [obj["card"], obj["cpu"], obj["cpu_permuted"]],
            "gap": abs(obj["card"] - obj["cpu"]) / obj["cpu"],
            "cpu_spread": abs(obj["cpu_permuted"] - obj["cpu"]) / obj["cpu"],
            "line_equal": f"{cpu['cpu']['acc'] * 100:.2f}" == f"{card.score(val_f, val_y) * 100:.2f}",
            "val_flips": int((np.asarray(cpu["cpu"]["pred"]) != pred).sum()),
            "cpu_val_flips": int((np.asarray(cpu["cpu"]["pred"])
                                  != np.asarray(cpu["cpu_permuted"]["pred"])).sum()),
            "cpu_fit_s": cpu["cpu"]["s"]})
    stopped = sorted({f["C"] for f in result["fits"] if f["n_iter"] >= LR_MAX_ITER})
    bound = max(LR_OBJ_RTOL, 2 * max((r["cpu_spread"] for r in compared), default=0.0))
    log(f"lpclip: search on the card {result['search_s']:.2f} s: "
        f"{[(f['C'], round(f['ms'], 1), f['n_iter'], f['acc']) for f in result['fits']]} (C, ms, "
        f"n_iter, val acc), best C {result['best_c']:g}; the converged C again on the CPU "
        f"({CPU_FIT_PROCS} one-thread processes, and on permuted samples; waited {wait_s:.1f} s "
        f"for them): {compared}; objective "
        f"gap bound {bound:.3e}; stopped at max_iter on the card, not compared: {stopped}")
    if not compared or any(not r["gap"] <= bound for r in compared):
        raise SystemExit("FAIL: lpclip: a card fit's objective is further from the CPU's than "
                         "the CPU's own spread allows")
    result.update(cpu_compared=compared, objective_gap_bound=bound, stopped_at_max_iter=stopped)


def _fp32_extraction_timing():
    """#6 in fp32 at lpclip's extraction shape (32, 12, 197, 64), no mask:
    kernel, plain version and SDPA by CUDA events, with its bound."""
    import torch
    import torch.nn.functional as F

    from fsvlm_tpu_torch.ops.flash_attention import _kernel_fwd, reference_attention_fwd

    B, H, L = 32, 12, 197
    gen = torch.Generator(device="cuda").manual_seed(15)
    q, k, v = _qkv(B, H, L, torch.float32, gen)
    o, lse = _kernel_fwd(q, k, v, None)
    o_ref, lse_ref = reference_attention_fwd(q, k, v, None)
    err = max((o - o_ref).abs().max().item(), (lse - lse_ref).abs().max().item())
    if not err <= TOL["float32"]["o"]:
        raise SystemExit(f"FAIL: #6 fp32 at ({B}, {H}, {L}) disagrees with its plain version")
    ms = _time_ms(lambda: _kernel_fwd(q, k, v, None))
    plain_ms = _time_ms(lambda: reference_attention_fwd(q, k, v, None))
    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    bound_ms, bound_by = _bound(B, H, L, False, "float32", 4)
    log(f"time flash_attn_fwd_d64 fp32 lpclip extraction ({B},{H},{L},64) nomask: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}); max abs err {err:.3e}")
    return {"shape": [B, H, L, 64], "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}


def _export_variants(tool, fa, arch, weights, images, work, live):
    """Each EXPORT_VARIANTS artifact written under ``work``, with its serving
    params; ``live`` gets each live function's top-1 and logits.  Returns
    {label: (path, serve, params, top1, logits, bytes, export s, #6 in the
    text pass, the tool's last line or None)}."""
    import torch

    built = {}
    for label, dtype_name, int8, static, _ in EXPORT_VARIANTS:
        path = os.path.join(work, f"{label}.pt2")
        torch.cuda.synchronize()
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        t0 = time.perf_counter()
        if label == "fp32":  # the tool's command line, in this process
            console = io.StringIO()
            with contextlib.redirect_stdout(console):
                tool.main(["--arch", arch, "--classes", str(EXPORT_CLASSES), "--batch",
                           str(EXPORT_BATCH), "--out", path])
            said = console.getvalue().strip().splitlines()[-1]
            nbytes = os.path.getsize(path)
        else:
            _, nbytes = tool.export_serving(arch, EXPORT_CLASSES, EXPORT_BATCH, path, int8=int8,
                                            dtype_name=dtype_name, params=weights,
                                            int8_static=static)
            said = None
        torch.cuda.synchronize()
        export_s = time.perf_counter() - t0
        build_launches = fa.LAUNCHES[fa.KERNEL]
        serve, params, _ = tool.build_serving_fn(arch, EXPORT_CLASSES, dtype_name=dtype_name,
                                                 int8=int8, params=weights, int8_static=static)
        with torch.no_grad():
            top1, logits = serve(params, images)
        live[label] = (top1.cpu().numpy(), logits.float().cpu().numpy())
        torch.save(params, os.path.join(work, f"{label}_params.pt"))
        built[label] = (path, serve, params, top1, logits, nbytes, export_s, build_launches, said)
    return built


def _export_serving(work):
    """Phase 15's export part (module docstring).  Returns (its numbers,
    #6's launches per loaded call in the fresh process)."""
    import torch

    from fsvlm_tpu_torch.models.clip import ARCHS, random_clip_params
    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.tools import export_serving as tool

    arch = "ViT-B/16"
    res = ARCHS[arch].image_resolution
    weights = random_clip_params(ARCHS[arch], seed=0)  # the tool's default weights
    images_np = np.random.RandomState(0).randint(0, 256, (EXPORT_BATCH, res, res, 3), np.uint8)
    np.save(os.path.join(work, "images.npy"), images_np)
    images = torch.from_numpy(images_np).cuda()
    torch.cuda.reset_peak_memory_stats()
    out, live = {}, {}
    # a fresh process that imports torch, numpy and the port alone: it starts
    # CUDA while this one exports, then loads the artifacts while this one
    # checks each program; the programs are timed after it has ended
    proc = subprocess.Popen(
        [sys.executable, "-c", _LOAD_SERVING, work, ",".join(v[0] for v in EXPORT_VARIANTS)],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        built = _export_variants(tool, fa, arch, weights, images, work, live)
    except BaseException:
        proc.kill()
        raise
    with open(os.path.join(work, "ready"), "w"):
        pass
    t_fresh = time.perf_counter()
    checked = {}
    for label, dtype_name, int8, static, _ in EXPORT_VARIANTS:
        path, serve, params, top1, logits, nbytes, export_s, build_launches, said = built.pop(label)
        prog = tool.load_serving(path)
        ops = tool.graph_ops(prog.program)
        stray = {k: n for k, n in ops.items() if any(w in k for w in NOT_KERNEL_ATTENTION)}
        n_attn = ops.get("fsvlm.flash_attn_fwd_d64.default", 0)
        q8 = [k for k in params if k.endswith(".q8")]
        q8_layout = all(prog.expected[k].stride() == params[k].stride()
                        and params[k].transpose(-1, -2).is_contiguous() for k in q8)
        refused = None
        if q8:
            bad = dict(params, **{q8[0]: params[q8[0]].contiguous()})
            try:
                prog(bad, images)
                refused = False
            except ValueError:
                refused = True
        with torch.no_grad():
            a_top1, a_logits = prog(params, images)
        torch.cuda.synchronize()
        in_process_equal = bool(torch.equal(top1, a_top1) and torch.equal(logits, a_logits))
        out[label] = {"artifact_bytes": nbytes, "export_s": export_s,
                      "text_pass_launches": build_launches, "attention_nodes": n_attn,
                      "other_attention_nodes": stray, "q8_layout_kept": q8_layout if q8 else None,
                      "row_major_q8_refused": refused, "in_process_equal": in_process_equal,
                      "printed": said}
        log(f"export_serving {label}: {nbytes} bytes in {export_s:.2f} s (text pass #6 "
            f"{build_launches}); graph: {n_attn} fsvlm.flash_attn_fwd_d64 nodes, other "
            f"attention {stray}, int8 GEMMs {ops.get('aten._int_mm.default', 0)}; q8 layout "
            f"kept {q8_layout if q8 else None}, row-major q8 refused {refused}; loaded here equal "
            f"to live {in_process_equal}" + (f"; printed {said!r}" if said else ""))
        if n_attn != 12 or stray:
            proc.kill()
            raise SystemExit(f"FAIL: export {label}: the graph's attention is not 12 "
                             f"fsvlm.flash_attn_fwd_d64 nodes alone")
        if q8 and not (q8_layout and refused):
            proc.kill()
            raise SystemExit(f"FAIL: export {label}: the q8 layout was not kept or refused")
        if said is not None and not said.startswith(f"wrote {path} ("):
            proc.kill()
            raise SystemExit(f"FAIL: export {label}: the tool printed {said!r}")
        checked[label] = (serve, params, prog)
    stdout, stderr = proc.communicate(timeout=600)
    fresh_s = time.perf_counter() - t_fresh
    # ms per batch, live and loaded in turns after a warm-up, with the card
    # to this process alone
    for label, (serve, params, prog) in checked.items():
        times = {"live": [], "loaded": []}
        with torch.no_grad():
            for _ in range(EXPORT_TURNS):
                for side, fn in (("live", serve), ("loaded", prog)):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    fn(params, images)
                    torch.cuda.synchronize()
                    times[side].append((time.perf_counter() - t1) * 1e3)
        out[label].update(live_ms=float(np.median(times["live"])),
                          loaded_ms=float(np.median(times["loaded"])))
        log(f"export_serving {label}: ms per batch of {EXPORT_BATCH}, {EXPORT_TURNS} in turns: "
            f"live {times['live']}, loaded {times['loaded']}")
    del checked, serve, params, prog
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    if proc.returncode != 0:
        print(stdout[-3000:], stderr[-3000:], flush=True)
        raise SystemExit("FAIL: export: loading the artifacts in a fresh process failed")
    fresh = json.loads(stdout.strip().splitlines()[-1])
    if fresh["forbidden_modules"]:
        raise SystemExit(f"FAIL: export: the fresh process imported {fresh['forbidden_modules']}")
    launches = {}
    for label, _, _, _, rtol in EXPORT_VARIANTS:
        got = fresh["loaded"][label]
        with np.load(os.path.join(work, f"{label}_loaded.npz")) as z:
            a_top1, a_logits = z["top1"], z["logits"]
        top1, logits = live[label]
        rel = float(np.abs(a_logits - logits).max() / np.abs(logits).max())
        per_call = [c[fa.KERNEL] for c in got["launches_per_call"]]
        others = [{k: n for k, n in c.items() if n and k != fa.KERNEL}
                  for c in got["launches_per_call"]]
        launches[label] = per_call[0]
        out[label].update(fresh_top1_equal=bool(np.array_equal(a_top1, top1)),
                          fresh_logits_rel=rel,
                          fresh_byte_equal=bool(np.array_equal(a_logits, logits)),
                          fresh_launches_per_call=per_call,
                          fresh_attention_nodes=got["ops"].get(
                              "fsvlm.flash_attn_fwd_d64.default", 0))
        log(f"export_serving {label} in a fresh process: top-1 equal "
            f"{out[label]['fresh_top1_equal']}, logits max |d| / max |l| {rel:.3e} (limit "
            f"{rtol:g}), byte-equal {out[label]['fresh_byte_equal']}, #6 per call {per_call}, "
            f"other kernels {others}")
        if (not out[label]["fresh_top1_equal"] or not rel <= rtol or per_call != [12, 12]
                or any(others) or out[label]["fresh_attention_nodes"] != 12):
            raise SystemExit(f"FAIL: export {label}: the loaded program in a fresh process "
                             f"disagrees with the live function")
    log(f"export_serving: fresh process {fresh_s:.1f} s from the artifacts' readiness to its "
        f"exit (started with the exports); peak device memory of the exports "
        f"{peak / 2**30:.2f} GiB")
    return dict(variants=out, fresh_process_s=fresh_s, peak_bytes=peak), launches


@_timed
def phase_lpclip_export(tree):
    """Phase 15 (module docstring), FSVLM_FORCE_PALLAS unset (the caller
    sets it), on phase 12's tree.  Returns (the ``{"lpclip_export": ...}``
    numbers, #6's launches over lpclip's extraction, #6's per loaded call)."""
    t0 = time.perf_counter()
    lp, launches_lp, pending = _lpclip_on_tree(tree)
    part_s = {"lpclip": round(time.perf_counter() - t0, 1)}
    work = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        t1 = time.perf_counter()
        fp32 = _fp32_extraction_timing()
        export, launches_export = _export_serving(work)
        part_s["fp32_timing_and_export"] = round(time.perf_counter() - t1, 1)
        t1 = time.perf_counter()
        _lpclip_cpu_check(lp, pending)
        part_s["wait_for_the_cpu_search"] = round(time.perf_counter() - t1, 1)
    finally:
        for proc in pending[0]:
            proc.kill()
        shutil.rmtree(work, ignore_errors=True)
    log(f"lpclip_export: seconds by part {json.dumps(part_s)}")
    result = {"lpclip": lp, "flash_attn_fwd_d64_fp32": fp32, "export": export,
              "part_s": part_s, "phase_s": time.perf_counter() - t0}
    print(json.dumps({"lpclip_export": result}), flush=True)
    return result, launches_lp, launches_export


DRIVER = "scripts/imbalance/run_setting_a.sh"
DRIVER_CFG = "vit_b16_c2_ep20_batch4_4+4ctx"
# twice bench.py's batch (the recipe's 4): 8 steps, a trace of ~50 MB (48 and 17
# steps until phase 20 came in: the call's time limit)
DRIVER_BATCH = 96
# the run's cuts and settings, all through FSVLM_EXTRA_OPTS (the driver stays as it is):
# 1 epoch of the recipe's 20, random weights (none on the machine), bf16 towers;
# the recipe's host augmentation, as the driver runs it, so no resident cache
# and no fused epoch (phase 9's trace holds a fused run's replays)
DRIVER_OPTS = (f"OPTIM.MAX_EPOCH 1 DATALOADER.TRAIN_X.BATCH_SIZE {DRIVER_BATCH} "
               "MODEL.BACKBONE.PRETRAINED False MODEL.FROZEN_DTYPE bf16")
OPTIMIZERS = ("adam", "amsgrad", "adamw", "rmsprop", "radam")
OPT_STEPS = 3  # steps held against the same optimizer on the CPU
OPT_RTOL = 1e-6  # per tensor: max |card - cpu| over max |cpu|
# C.5: the search on seeded features with class structure (no ties)
UNTIED_CLASSES, UNTIED_TRAIN, UNTIED_VAL, UNTIED_WIDTH, UNTIED_SEP = 100, 16, 4, 512, 0.3

_UNTIED_CPU = r"""
import contextlib, io, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from fsvlm_tpu_torch.tools.lpclip import search_logreg
z = np.load(sys.argv[1])
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    best = search_logreg(z["train_f"], z["train_y"], z["val_f"], z["val_y"], device="cpu")
print(json.dumps({"lines": buf.getvalue().splitlines(), "best_c": float(best)}))
"""


def _untied_features(path):
    """Seeded features with class means far apart against unit noise:
    UNTIED_CLASSES classes x (UNTIED_TRAIN train, UNTIED_VAL val) rows,
    UNTIED_WIDTH wide, saved to ``path``; returns them."""
    rng = np.random.RandomState(0)
    means = rng.randn(UNTIED_CLASSES, UNTIED_WIDTH).astype(np.float32) * UNTIED_SEP
    z = {}
    for split, n in (("train", UNTIED_TRAIN), ("val", UNTIED_VAL)):
        y = np.repeat(np.arange(UNTIED_CLASSES), n)
        z[f"{split}_f"] = (means[y] + rng.randn(len(y), UNTIED_WIDTH)).astype(np.float32)
        z[f"{split}_y"] = y
    np.savez(path, **z)
    return z


def _run_runner(args, env, timeout=900):
    """``python -m fsvlm_tpu_torch.run_script args`` from the repo's root;
    returns its stdout (the end of it is printed if it fails)."""
    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-m", "fsvlm_tpu_torch.run_script", *args], cwd=here,
                       env=env, capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        print(r.stdout[-4000:], r.stderr[-4000:], flush=True)
        raise SystemExit(f"FAIL: drivers: the runner exited {r.returncode} on {args[:2]}")
    return r.stdout


def _trace_kernel_counts(path, groups):
    """Launches of each group of ``groups`` ({label: name fragments}) among
    the kernel events of a Chrome trace, the number of kernel events, and
    the number of CUDA graph launches (cudaGraphLaunch runtime calls)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    graphs = sum(e.get("name") == "cudaGraphLaunch" for e in events)
    return {label: sum(any(f in n for f in frags) for n in names)
            for label, frags in groups.items()}, len(names), graphs


def _driver_on_card(tree, work):
    """The Setting A driver through the runner on phase 12's tree (module
    docstring); returns (#6-#8 from the trace, its numbers)."""
    from fsvlm_tpu_torch.ops import flash_attention as fa

    out_root, prof = os.path.join(work, "out"), os.path.join(work, "profile")
    env = dict(os.environ, TAIL_SWEEP="1", OUT_ROOT=out_root, FSVLM_PROFILE_DIR=prof,
               FSVLM_EXTRA_OPTS=DRIVER_OPTS)
    env.pop("FSVLM_FORCE_PALLAS", None)
    t0 = time.perf_counter()
    stdout = _run_runner(["--device", "cuda", DRIVER, "PromptSRC", "caltech101", "1", DRIVER_CFG,
                          "50", "50", "ce", tree["work"]], env)
    run_s = time.perf_counter() - t0
    summary = [ln for ln in stdout.splitlines() if ln.startswith("run_script:")]
    log(f"drivers: {DRIVER} through the runner in {run_s:.1f} s: {summary}")
    if "run_script: 1 python call(s), 0 failed; the driver exited 0" not in summary:
        raise SystemExit("FAIL: drivers: the runner did not make exactly one routed call, or it "
                         "failed")
    seed_dir = os.path.join(out_root, "setting_a", "caltech101", "PromptSRC", DRIVER_CFG, "ce",
                            "tail1", "seed1")
    text = _read(os.path.join(seed_dir, "log.txt"))
    mdir = os.path.join(seed_dir, "VLPromptLearner")
    if not {"checkpoint", "model.pkl-1"} <= set(os.listdir(mdir)):
        raise SystemExit(f"FAIL: drivers: {mdir} holds {os.listdir(mdir)}")
    after = text[text.find("=> result"):] if "=> result" in text else ""
    accs = re.findall(r"[*] accuracy: ([0-9.]+)%", after)
    lines = re.findall(r"epoch \[1/1\]\[(\d+)/(\d+)\]\ttime ([0-9.]+) \(([0-9.]+)\)", text)
    losses = [float(x) for x in re.findall(r"\bloss ([-+.\deE]+|nan|inf)", text)]
    if (not accs or "Finish training" not in text or not lines or not losses
            or not all(np.isfinite(losses))):
        raise SystemExit("FAIL: drivers: log.txt lacks the end signal, the accuracy, the train "
                         "lines or finite losses")
    steps = int(lines[-1][1])
    n_train = 50 * 16 + 50 * 1  # PER_CLASS_SHOTS at TAIL_SWEEP=1
    if steps != n_train // DRIVER_BATCH or "PER_CLASS_SHOTS=[16," not in stdout:
        raise SystemExit(f"FAIL: drivers: {steps} steps, expected {n_train // DRIVER_BATCH}")
    epoch_ms = float(lines[-1][3]) * steps * 1e3

    # #6-#8 from FSVLM_PROFILE_DIR's trace: its window runs from before_train
    # to the start of after_train, so it holds the train steps (TEST.FINAL_MODEL
    # last_step: no val pass) and not the final test
    traces = os.listdir(prof)
    if len(traces) != 1:
        raise SystemExit(f"FAIL: drivers: FSVLM_PROFILE_DIR holds {traces}, not one trace")
    trace_bytes = os.path.getsize(os.path.join(prof, traces[0]))
    counts, n_kernels, n_graphs = _trace_kernel_counts(os.path.join(prof, traces[0]),
                                                       {**FLASH_GROUPS, **FUSED_GROUPS})
    if counts.pop("#1") or counts.pop("#2"):
        raise SystemExit("FAIL: drivers: the whole-sequence kernels ran on the default route")
    Lt = Lv = 12  # ViT-B/16's text and vision layers
    per_step = {"#6": Lv + Lt + Lv, "#7": Lt + Lv, "#8": Lt + Lv}  # teacher + student; student
    expected = {k: steps * n for k, n in per_step.items()}
    log(f"drivers: the trace ({trace_bytes / 2**20:.1f} MiB, {n_kernels} kernel events, "
        f"{n_graphs} CUDA graph launches: host-augmented steps, none): #6-#8 {counts}, expected "
        f"{expected} ({steps} steps of {DRIVER_BATCH}); epoch "
        f"{epoch_ms:.1f} ms under the profiler ({steps * DRIVER_BATCH / epoch_ms * 1e3:.1f} "
        f"images/s); accuracies in log.txt {accs}")
    if counts != expected:
        raise SystemExit("FAIL: drivers: #6-#8 in the trace differ from the derived counts")
    if n_graphs:  # host-augmented batches: no resident cache, so no fused epoch
        raise SystemExit(f"FAIL: drivers: {n_graphs} graph launches in the trace of a "
                         f"host-augmented run")

    # parse_test_res.py through the shim's pass-through, on the run's seeds
    agg = os.path.join(work, "aggregate.sh")
    with open(agg, "w") as f:
        f.write('#!/bin/bash\npython parse_test_res.py "$1"\n')
    # (--device cpu: the call routes nothing to a device, and skips CUDA's start)
    table = _run_runner(["--device", "cpu", agg, os.path.dirname(seed_dir)], dict(os.environ))
    want = f"* accuracy: {float(accs[-1]):.2f}%"
    log(f"drivers: parse_test_res.py through the runner: "
        f"{[ln for ln in table.splitlines() if ln.startswith('* ')]}")
    if want not in table or "1 python call(s), 0 failed" not in table:
        raise SystemExit(f"FAIL: drivers: parse_test_res.py's table does not name {want!r}")
    launches = {fa.KERNEL: counts["#6"], fa.KERNEL_DKV: counts["#7"], fa.KERNEL_DQ: counts["#8"]}
    return launches, {"run_s": run_s, "steps": steps, "batch": DRIVER_BATCH, "epoch_ms": epoch_ms,
                      "trace_bytes": trace_bytes, "accuracy": float(accs[-1]), "launches": counts}


def _rel_gap(card, cpu):
    card, cpu = card.detach().cpu().double(), cpu.double()
    scale = cpu.abs().max().item()
    return (card - cpu).abs().max().item() / scale if scale else (card - cpu).abs().max().item()


def _optimizer_family(clip):
    """The five optimizers on phase 6's PromptSRC step (batch 48): one step
    of the trainer under sync debug mode 'error'; OPT_STEPS steps whose
    parameters and moment buffers match the same optimizer on the card's CPU
    fed the same gradients; a non-finite gradient that changes nothing."""
    import torch

    from fsvlm_tpu_torch.engine.optim import build_optimizer
    from fsvlm_tpu_torch.trainers.promptsrc import PromptSRC

    cfg = _train_cfg("PROMPTSRC")
    cache, labels = _train_cache()
    kt = PromptSRC(cfg, [f"class {i}" for i in range(N_CLASSES)], cache, labels, clip=clip,
                   device="cuda", steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    init = {k: v.detach().clone() for k, v in kt.params.items()}
    batches = [_augmented_batch(cache, labels, 40 + i) for i in range(OPT_STEPS)]
    index = kt.epoch_schedule()[0][0]

    def fresh(name):
        cfg.OPTIM.NAME = name
        with torch.no_grad():
            for k, v in kt.params.items():
                v.copy_(init[k])
        kt.optim, kt.lr_schedule = build_optimizer(cfg, kt.params.values(), kt.steps_per_epoch)

    result = {}
    for name in OPTIMIZERS:
        fresh(name)
        _no_sync_step(f"optim {name}", kt.train_step_resident, index)
        fresh(name)
        cpu = {k: v.detach().cpu().clone() for k, v in kt.params.items()}
        copt, _ = build_optimizer(cfg, cpu.values(), kt.steps_per_epoch)
        gaps = []
        for b in batches:
            loss, _ = kt.loss_fn(kt.params, kt.frozen, b)
            grads = torch.autograd.grad(loss, list(kt.params.values()))
            kt.optim.step(grads)
            copt.step([g.cpu() for g in grads])
            gaps.append(max([_rel_gap(kt.params[k], cpu[k]) for k in cpu]
                            + [_rel_gap(x, y) for bname in copt.buffers
                               for x, y in zip(getattr(kt.optim, bname), getattr(copt, bname))]))
        counts_equal = int(kt.optim.count) == int(copt.count) == OPT_STEPS
        before = ([v.clone() for v in kt.params.values()],
                  [x.clone() for bname in kt.optim.buffers for x in getattr(kt.optim, bname)],
                  int(kt.optim.count))
        bad = [g.clone() for g in grads]
        bad[0].view(-1)[0] = float("inf")
        kt.optim.step(bad)
        unchanged = (all(torch.equal(a, b) for a, b in zip(before[0], kt.params.values()))
                     and all(torch.equal(a, b) for a, b in zip(
                         before[1], [x for bname in kt.optim.buffers
                                     for x in getattr(kt.optim, bname)]))
                     and int(kt.optim.count) == before[2] and int(kt.optim.notfinite_count) == 1)
        log(f"drivers: optimizer {name} (buffers {kt.optim.buffers}): largest gap to the CPU per "
            f"step {[f'{g:.2e}' for g in gaps]} (limit {OPT_RTOL:g}), counts equal "
            f"{counts_equal}; a non-finite step changed nothing: {unchanged}")
        if max(gaps) > OPT_RTOL or not counts_equal or not unchanged:
            raise SystemExit(f"FAIL: drivers: optimizer {name} on the card differs from the CPU, "
                             f"or its non-finite step changed its state")
        result[name] = {"gaps": gaps, "buffers": list(kt.optim.buffers)}
    cfg.OPTIM.NAME = "sgd"
    del kt
    torch.cuda.empty_cache()
    return result


def _untied_search(work, pending):
    """C.5: ``search_logreg`` on the card on the untied features, against
    the one-thread CPU process started at the phase's start: the same
    printed lines and best C."""
    from fsvlm_tpu_torch.tools.lpclip import search_logreg

    proc, z = pending
    buf, fits = io.StringIO(), []
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        best = search_logreg(z["train_f"], z["train_y"], z["val_f"], z["val_y"], device="cuda",
                             fits=fits)
    card_s = time.perf_counter() - t0
    stdout, stderr = proc.communicate(timeout=600)
    if proc.returncode != 0:
        print(stdout[-3000:], stderr[-3000:], flush=True)
        raise SystemExit("FAIL: drivers: the CPU search's process failed")
    cpu = json.loads(stdout.strip().splitlines()[-1])
    lines = buf.getvalue().splitlines()
    log(f"drivers: untied lpclip search ({UNTIED_CLASSES} classes, {UNTIED_TRAIN}/{UNTIED_VAL} "
        f"rows each, {UNTIED_WIDTH} wide) on the card in {card_s:.2f} s: {lines}, best C "
        f"{float(best):g}, n_iter {[f['n_iter'] for f in fits]}; the CPU's best C "
        f"{cpu['best_c']:g}, lines equal: {lines == cpu['lines']}")
    if lines != cpu["lines"] or float(best) != cpu["best_c"]:
        raise SystemExit("FAIL: drivers: the card's lpclip search differs from the CPU's")
    return {"lines": lines, "best_c": float(best), "card_s": card_s}


@_timed
def phase_drivers(clip, tree):
    """Phase 16 (module docstring), FSVLM_FORCE_PALLAS unset (the caller
    sets it), on phase 12's tree.  Returns (#6-#8 over the driver run's
    profiled window, the ``{"drivers": ...}`` numbers)."""
    import torch

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_drivers_")
    proc = None
    try:
        z = _untied_features(os.path.join(work, "untied.npz"))
        env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
        proc = subprocess.Popen([sys.executable, "-c", _UNTIED_CPU,
                                 os.path.join(work, "untied.npz")],
                                cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        torch.cuda.empty_cache()  # the driver's own process shares the card
        launches, driver = _driver_on_card(tree, work)
        optimizers = _optimizer_family(clip)
        untied = _untied_search(work, (proc, z))
    finally:
        if proc is not None:
            proc.kill()
        shutil.rmtree(work, ignore_errors=True)
    result = {"driver": driver, "optimizers": optimizers, "lpclip_untied": untied,
              "phase_s": time.perf_counter() - t0}
    log(f"drivers: phase 16 in {result['phase_s']:.1f} s")
    print(json.dumps({"drivers": result}), flush=True)
    return launches, result


PNG_FIXTURE_DIR = os.path.join("tests", "torch_fixtures", "png")
# PACS's published per-class counts (Li et al., 2017), classes in Dassl's order
PACS_CLASSES = ("dog", "elephant", "giraffe", "guitar", "horse", "house", "person")
PACS_COUNTS = {"art_painting": (379, 255, 285, 184, 201, 295, 449),
               "cartoon": (389, 457, 346, 135, 324, 288, 405),
               "photo": (189, 202, 182, 186, 199, 280, 432),
               "sketch": (772, 740, 753, 608, 816, 80, 160)}
PACS_ERROR = "sketch/dog/n02103406_4068-1.png"  # data/datasets/legacy.py's _error_paths
PACS_SOURCES, PACS_TARGET = ("art_painting", "cartoon", "photo"), "sketch"
PACS_BATCH, PACS_EPOCHS = 48, 1
CIFAR10_CLASSES = ("airplane", "automobile", "bird", "cat", "deer", "dog", "frog", "horse",
                   "ship", "truck")
SSL_U_BATCHES = 10  # 50 until phase 20 came in (the call's time limit)
# sha256 of the sorted (relative path, label) list of each split that the JAX
# package's CIFAR10 gives on _ssl_tree's tree with configs/datasets/zoo/ssl_cifar10.yaml
# at SEED 1 (fsvlm_tpu.data.datasets.legacy.CIFAR10, computed on the CPU)
SSL_JAX_DIGESTS = {
    "train_x": "e4157950f52f5034bdc12fd7ef21d893ed4c6599b69968cd8cc5f96cc57cba88",
    "train_u": "469373b06fb9981d2b268aec03ae2da6e41745d49043c339fd464b80aa98e948",
    "val": "094270d8cb3b09049c2a5c5c1c5268bfff1f058fba6d2e3975d1e11f7c0a85d6",
    "test": "d2935f4117159a68cb2caa102f1429234b4fe45f7b184780431cd966e8fa3dcf",
}


def _zlib_finding():
    """Whether this machine has zlib's header and library (the port's PNG
    decoder uses neither: its inflate is in csrc/png_decoder.cpp)."""
    try:
        ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                                  timeout=60).stdout
    except OSError:
        ldconfig = ""
    libs = sorted({ln.split("=>")[-1].strip() for ln in ldconfig.splitlines()
                   if re.search(r"libz\.so", ln)})
    return {"header": os.path.isfile("/usr/include/zlib.h"), "libz": libs}


def _check_png_fixtures():
    """(a) Every committed PNG fixture decoded by the port against the digests
    computed from Pillow and the JAX package's views (make_fixtures.py): the
    full decode, the loader's cache view at 256 and the eval view at 224;
    the truncated file must raise."""
    from fsvlm_tpu_torch import native
    from fsvlm_tpu_torch.data import imageops
    from fsvlm_tpu_torch.data.base_dataset import Datum
    from fsvlm_tpu_torch.data.loader import RawDatasetWrapper

    with open(os.path.join(PNG_FIXTURE_DIR, "expected.json")) as f:
        expected = json.load(f)
    bad, raised = [], []
    for name, want in sorted(expected["digests"].items()):
        path = os.path.join(PNG_FIXTURE_DIR, name)
        full = native.read_image(path)
        got = {"full": _digest(full),
               "cache256": _digest(RawDatasetWrapper([Datum(impath=path)], 256)[0]["img"]),
               "eval224": _digest(imageops.resize_center_crop(full, (224, 224), "bicubic"))}
        bad += [f"{name} {k}: got {got[k]}, expected {want[k]}" for k in want if got[k] != want[k]]
    for name in expected["truncated"]:
        try:
            native.read_image(os.path.join(PNG_FIXTURE_DIR, name))
        except ValueError:
            raised.append(name)
    n = len(expected["digests"])
    log(f"zoo_data: {n} committed PNG fixtures x 3 views (full decode, cache view 256, eval view "
        f"224) against their digests: {3 * n - len(bad)} equal, {len(bad)} differ; truncated "
        f"files raising ValueError: {len(raised)} of {len(expected['truncated'])}")
    bad += [f"{name}: decoded, expected a ValueError" for name in expected["truncated"]
            if name not in raised]
    if bad:
        raise SystemExit("FAIL: zoo_data: PNG decodes differ from the fixtures' digests:\n"
                         + "\n".join(bad))
    return expected


def _link_all(pairs, threads=8):
    """Hard-link each (source, destination) pair (a copy where linking
    fails), the directories first, the links from a thread pool: metadata
    calls are slow on the card machine's file system (60,000 links took
    18 s from one thread on an H100 host)."""
    from concurrent.futures import ThreadPoolExecutor

    for d in sorted({os.path.dirname(dst) for _, dst in pairs}):
        os.makedirs(d, exist_ok=True)

    def link(pair):
        try:
            os.link(*pair)
        except OSError:
            shutil.copy(*pair)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(link, pairs))


def _pacs_tree(root, jpegs, sketches):
    """PACS's layout (data/datasets/legacy.py PACS): ``pacs/images/<domain>/
    <class>/<file>`` at PACS's published sizes, and ``pacs/splits/<domain>_
    {train,crossval}_kfold.txt`` (1-based labels) at 9:1 per class.  The
    photo-like domains are hard links to the JPEG fixtures, sketch to the PNG
    sketch fixtures, and PACS_ERROR a truncated PNG listed in sketch's train
    split.  Returns {relative path: fixture} for the sketch files."""
    sketch_of, pairs = {}, []
    k = 0
    for dom, counts in PACS_COUNTS.items():
        files, src_dir, ext = ((sketches, PNG_FIXTURE_DIR, ".png") if dom == "sketch" else
                               (jpegs, FIXTURE_DIR, ".jpg"))
        lines = {"train": [], "crossval": []}
        for c, (cls, n) in enumerate(zip(PACS_CLASSES, counts)):
            n_val = n // 10
            for i in range(n):
                split = "crossval" if i < n_val else "train"
                rel = f"{dom}/{cls}/pic_{i:04d}{ext}"
                src = files[k % len(files)]
                if dom == "sketch" and cls == "dog" and i == n - 1:
                    rel, src = PACS_ERROR, "truncated_n02103406_4068-1.png"
                else:
                    k += 1
                pairs.append((os.path.abspath(os.path.join(src_dir, src)),
                              os.path.join(root, "pacs", "images", rel)))
                if dom == "sketch":
                    sketch_of[rel] = src
                lines[split].append(f"{rel} {c + 1}")
        for split, ls in lines.items():
            os.makedirs(os.path.join(root, "pacs", "splits"), exist_ok=True)
            with open(os.path.join(root, "pacs", "splits", f"{dom}_{split}_kfold.txt"), "w") as f:
                f.write("\n".join(ls) + "\n")
    _link_all(pairs)
    return sketch_of


def _ssl_tree(root, png):
    """SSL CIFAR-10's layout (data/datasets/legacy.py CIFAR10) at CIFAR-10's
    sizes: ``cifar10/{train,test}/<class>/<nnnn>.png``, 5000 train and 1000
    test images per class, hard links to one 32x32 PNG fixture."""
    src = os.path.abspath(os.path.join(PNG_FIXTURE_DIR, png))
    _link_all([(src, os.path.join(root, "cifar10", split, cls, f"{i:04d}.png"))
               for split, n in (("train", 5000), ("test", 1000)) for cls in CIFAR10_CLASSES
               for i in range(n)])


def _read_bytes(path):
    with open(path, "rb") as f:
        return len(f.read())


def _split_digests(ds, root):
    """sha256 of each split's sorted (relative path, label) list."""
    import hashlib

    out = {}
    for split in ("train_x", "train_u", "val", "test"):
        rows = sorted((os.path.relpath(d.impath, root), d.label) for d in getattr(ds, split))
        out[split] = hashlib.sha256(json.dumps(rows).encode()).hexdigest()
    return out


def _pacs_launches(t, clip_cfg, epochs):
    """#6-#8 over the PACS run, from the code: the teacher text features
    (PromptSRC.build_model); per step the student text and vision towers
    and the frozen teacher's vision pass forward (no CACHED_TEACHER), the
    student towers backward; per test() one text pass and one vision pass
    per batch (_host_launches)."""
    from fsvlm_tpu_torch.ops import flash_attention as fa

    Lt, Lv = clip_cfg.transformer_layers, clip_cfg.vision_layers
    want = _host_launches(t, clip_cfg, (Lt + 2 * Lv, Lt + Lv), epochs)
    want[fa.KERNEL] += Lt
    return want


def _pacs_run(clip, work, threads):
    """(b) PromptSRC leave-one-domain-out on PACS through the port's CLI."""
    import resource

    import torch

    from fsvlm_tpu_torch.engine.trainer import SimpleTrainer
    from fsvlm_tpu_torch.ops import flash_attention as fa

    def argv(out, *flags):
        return ["--trainer", "PromptSRC", "--seed", "1", "--device", "cuda", "--root", work,
                "--dataset-config-file", "configs/datasets/zoo/pacs.yaml",
                "--source-domains", *PACS_SOURCES, "--target-domains", PACS_TARGET,
                "--config-file", CLI_RECIPE, "--output-dir", out, *flags,
                "MODEL.FROZEN_DTYPE", "bf16", "TRAINER.PROMPTSRC.PREC", "bf16",
                "OPTIM.MAX_EPOCH", str(PACS_EPOCHS),
                "DATALOADER.TRAIN_X.BATCH_SIZE", str(PACS_BATCH)]

    out = os.path.join(work, "run")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
    t0 = time.perf_counter()
    with _epochs_timed(SimpleTrainer, []) as epochs:
        t = _run_cli(clip, argv(out))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ds = t.dm.dataset
    text = _read(os.path.join(out, "log.txt"))
    losses = [float(x) for x in re.findall(r"\bloss ([-+.\deE]+|nan|inf)", text)]
    n_src = {d: sum(PACS_COUNTS[d]) for d in PACS_SOURCES}
    val = sum(n // 10 for d in PACS_SOURCES for n in PACS_COUNTS[d])
    want_sizes = (sum(n_src.values()) - val, val, sum(PACS_COUNTS[PACS_TARGET]) - 1)
    got_sizes = (len(ds.train_x), len(ds.val), len(ds.test))
    summary = {k: int(v.replace(",", "")) for k, v in re.findall(
        r"# (train_x|val|test)\s+([\d,]+)", text)}
    log(f"zoo_data: PACS leave-one-domain-out ({'+'.join(PACS_SOURCES)} -> {PACS_TARGET}) "
        f"through the CLI: train_x/val/test {got_sizes} (expected {want_sizes}; "
        f"{PACS_ERROR} skipped), summary {summary}, {t.num_classes} classes, "
        f"{t.dm.num_source_domains} source domains; {t.steps_per_epoch} steps of "
        f"{t.batch_size}; run {run_s:.1f} s; losses logged {losses}; accuracy in log.txt "
        f"{re.findall(r'[*] accuracy: ([0-9.]+)%', text)}")
    for needle in ("=> result", "* accuracy:", "Finish training", "DEVICE_AUG: False",
                   "Using GPA model for final inference"):
        if needle not in text:
            raise SystemExit(f"FAIL: zoo_data: the PACS run's log.txt lacks {needle!r}")
    if got_sizes != want_sizes or summary != dict(zip(("train_x", "val", "test"), want_sizes)):
        raise SystemExit("FAIL: zoo_data: the PACS splits are not the tree's")
    if t.num_classes != 7 or t.dm.num_source_domains != 3 or any(
            os.path.relpath(d.impath, os.path.join(work, "pacs", "images")) == PACS_ERROR
            for d in ds.test):
        raise SystemExit("FAIL: zoo_data: PACS's classes, domains or error path are wrong")
    if not losses or not all(np.isfinite(losses)):
        raise SystemExit(f"FAIL: zoo_data: non-finite or no loss in the PACS run: {losses}")
    want = _pacs_launches(t, clip.cfg, PACS_EPOCHS)
    _others_silent(launches, "flash_attn", "the PACS CLI run")
    got = {k: launches[k] for k in want}
    log(f"zoo_data: PACS launches {got}, expected {want}")
    if got != want:
        raise SystemExit("FAIL: zoo_data: #6-#8 launches differ from the derived counts")

    # --eval-only from the run's last model: its wall time is a cold test() of
    # the sketch target (PNG decode, eval view, model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t2 = _run_cli(clip, argv(os.path.join(work, "eval"), "--eval-only", "--model-dir", out))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    if t2.evaluator.y_pred != t.evaluator.y_pred or t2.evaluator.y_true != t.evaluator.y_true:
        raise SystemExit("FAIL: zoo_data: --eval-only did not reproduce the PACS predictions")
    log(f"zoo_data: --eval-only reproduced the run's {len(t2.evaluator.y_pred)} sketch "
        f"predictions")
    del t2
    epoch_ms = epochs[0]  # the run's epoch, its files decoded on first use
    n_img = t.steps_per_epoch * t.batch_size
    result = {"run_s": run_s, "epoch_ms": epoch_ms, "epoch_images": n_img,
              "epoch_images_per_s": n_img / epoch_ms * 1e3, "eval_only_s": eval_s,
              "test_images": len(ds.test), "sizes": dict(zip(("train_x", "val", "test"),
                                                             got_sizes)),
              "steps": t.steps_per_epoch, "batch": t.batch_size, "threads": threads,
              "peak_device_bytes": peak,
              "peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss << 10}
    log(f"zoo_data: PACS epoch (the run's) {epoch_ms:.1f} ms ({n_img} images, "
        f"{result['epoch_images_per_s']:.1f} images/s, host transforms at {threads} threads); "
        f"--eval-only (cold: {len(ds.test)} sketch PNGs decoded, eval view, model) {eval_s:.1f} s; "
        f"peak device memory {peak / 2**30:.2f} GiB, process peak RSS "
        f"{result['peak_rss_bytes'] / 2**30:.2f} GiB")
    del t
    torch.cuda.empty_cache()
    return launches, result


def _pacs_device_aug(work, sketch_of, expected, threads):
    """(c) A DataManager with sketch among the sources under DEVICE_AUG: the
    materialized train cache's sketch rows against their fixtures' cache256
    digests."""
    from fsvlm_tpu_torch.data.data_manager import DataManager

    sources = ("art_painting", "cartoon", "sketch")
    cfg = _recipe_cfg_from_argv([
        "--trainer", "PromptSRC", "--seed", "1", "--device", "cuda", "--root", work,
        "--dataset-config-file", "configs/datasets/zoo/pacs.yaml",
        "--source-domains", *sources, "--target-domains", "photo", "--config-file", CLI_RECIPE,
        "DATALOADER.DEVICE_AUG", "True"])
    cfg.VERBOSE = False
    dm = DataManager(cfg)
    items = dm.dataset.train_x
    t0 = time.perf_counter()
    cache = dm.train_loader_x.wrapper.materialize(threads)
    materialize_ms = (time.perf_counter() - t0) * 1e3
    image_dir = os.path.join(work, "pacs", "images")
    rows = [(i, os.path.relpath(d.impath, image_dir)) for i, d in enumerate(items)
            if d.domain == sources.index("sketch")]
    bad = [rel for i, rel in rows
           if _digest(cache[i]) != expected["digests"][sketch_of[rel]]["cache256"]]
    log(f"zoo_data: DEVICE_AUG DataManager ({'+'.join(sources)} -> photo): materialized "
        f"{cache.shape} in {materialize_ms:.1f} ms at {threads} threads; {len(rows)} sketch "
        f"rows against their fixtures' cache256 digests: {len(rows) - len(bad)} equal, "
        f"{len(bad)} differ; {dm.num_source_domains} source domains")
    if bad or not rows or PACS_ERROR in {rel for _, rel in rows}:
        raise SystemExit(f"FAIL: zoo_data: device-aug sketch rows differ: {bad[:5]}")
    return {"materialize_ms": materialize_ms, "rows": len(items), "sketch_rows": len(rows)}


def _ssl_loader(work, threads):
    """(d) SSL CIFAR-10 at CIFAR-10's sizes through configs/datasets/zoo/
    ssl_cifar10.yaml at SEED 1: the counts, each split's digest against the
    JAX package's, then SSL_U_BATCHES batches of the train_u loader at the
    FixMatch recipe's loader settings (configs/trainers/zoo/fixmatch_cifar10.yaml:
    train_u batch 448, its INPUT)."""
    from fsvlm_tpu_torch.config import get_cfg_base
    from fsvlm_tpu_torch.data.data_manager import DataManager

    cfg = get_cfg_base()
    cfg.merge_from_file("configs/datasets/zoo/ssl_cifar10.yaml")
    cfg.merge_from_list([
        "SEED", 1, "VERBOSE", False, "DATASET.ROOT", work,
        "DATALOADER.NUM_WORKERS", threads, "DATALOADER.TRAIN_X.BATCH_SIZE", 64,
        "DATALOADER.TRAIN_U.SAME_AS_X", False, "DATALOADER.TRAIN_U.BATCH_SIZE", 448,
        "INPUT.SIZE", [32, 32], "INPUT.TRANSFORMS", ["random_flip", "random_crop", "normalize"]])
    t0 = time.perf_counter()
    dm = DataManager(cfg)
    build_s = time.perf_counter() - t0
    ds = dm.dataset
    sizes = {k: len(getattr(ds, k)) for k in ("train_x", "train_u", "val", "test")}
    digests = _split_digests(ds, work)
    log(f"zoo_data: SSL CIFAR-10 (NUM_LABELED {cfg.DATASET.NUM_LABELED}, VAL_PERCENT "
        f"{cfg.DATASET.VAL_PERCENT}, SEED 1): {sizes} in {build_s:.2f} s; split digests equal to "
        f"the JAX package's: {[k for k in digests if digests[k] == SSL_JAX_DIGESTS[k]]}")
    if sizes != {"train_x": 4000, "train_u": 41000, "val": 5000, "test": 10000}:
        raise SystemExit("FAIL: zoo_data: the SSL CIFAR-10 counts are not the protocol's")
    if digests != SSL_JAX_DIGESTS:
        raise SystemExit(f"FAIL: zoo_data: SSL split digests {digests} differ from the JAX "
                         f"package's {SSL_JAX_DIGESTS}")
    loader_u = dm.train_loader_u
    n, views, t0 = 0, 0, time.perf_counter()
    for batch in loader_u:
        want = [ds.train_u[i].label for i in batch["index"]]
        if batch["label"].tolist() != want or batch["img"].shape[0] != 448:
            raise SystemExit("FAIL: zoo_data: a train_u batch's labels or size are wrong")
        views += int(batch["valid"].sum())
        n += 1
        if n == SSL_U_BATCHES:
            break
    seconds = time.perf_counter() - t0
    log(f"zoo_data: train_u loader: {n} batches of {loader_u.batch_size} ({views} views, "
        f"{batch['img'].dtype} {tuple(batch['img'].shape[1:])}) in {seconds:.2f} s: "
        f"{views / seconds:.1f} views/s at {threads} threads (first visits: each PNG decoded)")
    return {"sizes": sizes, "digests_equal_jax": True, "build_s": build_s,
            "u_batches": n, "u_batch": loader_u.batch_size, "u_views_per_s": views / seconds}


@_timed
def phase_zoo_data(clip, work, ssl_work=None):
    """Phase 17 (module docstring), FSVLM_FORCE_PALLAS unset (the caller sets
    it).  The PACS tree goes to ``work``, which the caller keeps for phase 18
    and removes; the SSL tree to ``ssl_work``, which the caller keeps for
    phase 20 and removes (by default a directory of its own, removed here).
    Returns (#6-#8 over the PACS run, the ``{"zoo_data": ...}`` numbers)."""
    from concurrent.futures import ThreadPoolExecutor

    from fsvlm_tpu_torch import native
    from fsvlm_tpu_torch.data.loader import RawDatasetWrapper
    from fsvlm_tpu_torch.data.base_dataset import Datum

    t_phase = time.perf_counter()
    zlib = _zlib_finding()
    log(f"zoo_data: zlib on this machine: header /usr/include/zlib.h {zlib['header']}, "
        f"libraries {zlib['libz']}; the port's PNG decoder (csrc/png_decoder.cpp) uses neither")
    expected = _check_png_fixtures()
    jpegs = sorted(f for f in os.listdir(FIXTURE_DIR) if f.endswith(".jpg"))
    sketches = sorted(n for n in expected["digests"] if n.startswith("sketch_"))
    threads = 8  # the recipe's DATALOADER.NUM_WORKERS
    keep_ssl = ssl_work is not None
    ssl_work = ssl_work or tempfile.mkdtemp(prefix="chip_smoke_ssl_")
    try:
        t0 = time.perf_counter()
        sketch_of = _pacs_tree(work, jpegs, sketches)
        tree_s = time.perf_counter() - t0
        # the decode rates over the sketch domain's readable files, each file
        # read once before: the first open of a path is slow on the card
        # machine's file system (a cold full-decode pass read 813.6 files/s
        # where a warm one read 1545.5)
        image_dir = os.path.join(work, "pacs", "images")
        paths = [os.path.join(image_dir, r) for r in sorted(sketch_of) if r != PACS_ERROR]
        rates = {}
        with ThreadPoolExecutor(max_workers=threads) as pool:
            list(pool.map(_read_bytes, paths))
            for name, fn in (("full", native.read_image),
                             ("cache256", lambda p: RawDatasetWrapper([Datum(impath=p)],
                                                                      256)[0]["img"])):
                t0 = time.perf_counter()
                list(pool.map(fn, paths))
                rates[name] = len(paths) / (time.perf_counter() - t0)
        log(f"zoo_data: PACS tree ({sum(map(sum, PACS_COUNTS.values()))} files, hard links) in "
            f"{tree_s:.2f} s; PNG decode over the {len(paths)} sketch files at {threads} threads: "
            f"full {rates['full']:.1f} images/s, cache view 256 {rates['cache256']:.1f} images/s")
        launches, pacs = _pacs_run(clip, work, threads)
        device_aug = _pacs_device_aug(work, sketch_of, expected, threads)
        shutil.rmtree(os.path.join(work, "run"), ignore_errors=True)
        shutil.rmtree(os.path.join(work, "eval"), ignore_errors=True)
        t0 = time.perf_counter()
        _ssl_tree(ssl_work, "cifar_rgb8_32.png")
        ssl_tree_s = time.perf_counter() - t0
        ssl = dict(_ssl_loader(ssl_work, threads), tree_s=ssl_tree_s)
    finally:
        if not keep_ssl:
            shutil.rmtree(ssl_work, ignore_errors=True)
    result = {"zlib": zlib, "png_fixtures": len(expected["digests"]),
              "png_full_images_per_s": rates["full"],
              "png_cache256_images_per_s": rates["cache256"], "png_decode_images": len(paths),
              "pacs": pacs, "pacs_launches": launches, "device_aug": device_aug, "ssl": ssl,
              "phase_s": time.perf_counter() - t_phase}
    log(f"zoo_data: phase 17 in {result['phase_s']:.1f} s")
    print(json.dumps({"zoo_data": result}), flush=True)
    return launches, result


ZOO_DG_RECIPE = "configs/trainers/zoo/vanilla_mixstyle_pacs.yaml"
# the recipe's 50 epochs cut to 1 (85 steps of 64 over PACS's 5467 source
# images), and TEST.NO_TEST: the CLI tests once after training, not twice
ZOO_DG_EPOCHS = 1
ZOO_DG_PROFILE_STEPS = 3  # 5 until the fused-epoch checks came in
# (b): each DG trainer on resnet18 at 224x224, ZOO_B_BATCH images (a multiple of
# the 3 source domains), ZOO_B_STEPS steps on the card and on its CPU from the
# same weights, batches and draws, with TF32 off; every step from the card's
# state before it (the trajectories part chaotically from rounding: the CPU
# tests' finding).  Per step |dloss| over max(|loss|, 1), and per tensor max
# |card - cpu| over its largest magnitude, for the weights, the weights that
# start at zero (BatchNorm biases, the generator's regress bias, LocNet's fc:
# their largest magnitude is a few updates, and a BatchNorm bias's gradient is
# a sum over batch x height x width terms that nearly cancel) and the BN
# statistics, each within ZOO_B_BOUND.  Measured on an H100 80GB HBM3 (700 W),
# batch 6: losses 3.8e-6, weights 1.2e-4 (F's 7x7 stem conv: a sum over
# 6 x 112 x 112 positions), zero-init 0.039, statistics 2.1e-5.  The STN
# generator (fcn_3x64_gctx_stn) is held to ZOO_B_BOUND_STN: its FCN's
# gradient moves by 1% for a 1e-5 change of its warped input (the CPU tests'
# finding against JAX, ROADMAP C.2), so G's update and every later tensor of
# the step move more (measured: losses 4.1e-5, weights 0.042, zero-init 0.37,
# statistics 0.039)
# ZOO_B_STEPS cut from 3 to 2 when phase 19 came in, and to 1 when phase 20
# came in (the call's time limit); every step started from the card's state
ZOO_B_BATCH, ZOO_B_STEPS = 6, 1
ZOO_B_BOUND = {"loss": 1e-4, "weights": 5e-4, "weights_zero_init": 0.2, "statistics": 1e-4,
               "weights_rounding_noise": 1e-6}
ZOO_B_BOUND_STN = {"loss": 1e-4, "weights": 0.2, "weights_zero_init": 1.0, "statistics": 0.2,
                   "weights_rounding_noise": 1e-6}
# a tensor that starts at zero and stays below ZOO_NOISE of its network's
# largest weight on the card is rounding noise: a bias that feeds a BatchNorm
# (cnn_digit5_m3sda's conv and fc biases) has a zero gradient, and its
# card/CPU values (12.6 of its own size apart, measured) carry no signal.
# Such a tensor is held instead to stay below ZOO_NOISE on the CPU as well
# (``weights_rounding_noise``: the larger side over the network's largest weight)
ZOO_NOISE = 1e-6
ZOO_B_CASES = [
    ("CrossGrad", {}),
    ("DDAIG", {"TRAINER.DDAIG.G_ARCH": "fcn_3x32_gctx", "TRAINER.DDAIG.CLAMP": True}),
    ("DDAIG", {"TRAINER.DDAIG.G_ARCH": "fcn_3x64_gctx_stn", "TRAINER.DDAIG.CLAMP": True}),
    ("DomainMix", {"TRAINER.DOMAINMIX.TYPE": "crossdomain"}),
    ("DomainMix", {"TRAINER.DOMAINMIX.TYPE": "random"}),
    ("DAELDG", {"DATALOADER.TRAIN_X.SAMPLER": "RandomDomainSampler",
                "TRAINER.DAELDG.STRONG_TRANSFORMS": ("random_flip", "cutout", "normalize")}),
]


def _zoo_argv(work, out, *flags):
    return ["--trainer", "Vanilla", "--seed", "1", "--device", "cuda", "--root", work,
            "--dataset-config-file", "configs/datasets/zoo/pacs.yaml",
            "--source-domains", *PACS_SOURCES, "--target-domains", PACS_TARGET,
            "--config-file", ZOO_DG_RECIPE, "--output-dir", out, *flags,
            "OPTIM.MAX_EPOCH", str(ZOO_DG_EPOCHS), "TEST.NO_TEST", "True"]


def _zoo_trees_equal(a, b):
    """Names whose arrays differ between two nested numpy trees."""
    from fsvlm_tpu_torch.models.convert import flatten

    fa, fb = flatten(a), flatten(b)
    return sorted(k for k in fa.keys() | fb.keys()
                  if k not in fa or k not in fb or not np.array_equal(fa[k], fb[k]))


def _zoo_vanilla(work):
    """(a) Vanilla MixStyle leave-one-domain-out on PACS through the CLI."""
    import torch

    from fsvlm_tpu_torch.engine.checkpoint import load_checkpoint
    from fsvlm_tpu_torch.engine.trainer import build_trainer
    from fsvlm_tpu_torch.models.convert import zoo_trees
    from fsvlm_tpu_torch.models.draws import Draws, Record
    from fsvlm_tpu_torch.engine.trainer import SimpleTrainer
    from fsvlm_tpu_torch.train import build_argparser, setup_cfg

    out = os.path.join(work, "zoo_run")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _epochs_timed(SimpleTrainer, []) as epochs:
        t = _run_cli(None, _zoo_argv(work, out))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    epoch_ms = epochs[0]
    peak = torch.cuda.max_memory_allocated()
    text = _read(os.path.join(out, "log.txt"))
    losses = [float(x) for x in re.findall(r"\bloss ([-+.\deE]+|nan|inf)", text)]
    log(f"zoo_dg: Vanilla {t.cfg.MODEL.BACKBONE.NAME} ({ZOO_DG_RECIPE}) on PACS "
        f"{'+'.join(PACS_SOURCES)} -> {PACS_TARGET} through the CLI: {t.steps_per_epoch} steps "
        f"of {t.batch_size} ({len(t.dm.dataset.train_x)} images), {t.num_classes} classes, "
        f"{len(t.dm.dataset.test)} test images; run {run_s:.1f} s; losses logged {losses}; "
        f"accuracy in log.txt {re.findall(r'[*] accuracy: ([0-9.]+)%', text)}")
    for needle in ("no weights found", "Finish training", "* accuracy:", "=> result",
                   "NAME: resnet18_ms_l12", "colorjitter"):
        if needle not in text:
            raise SystemExit(f"FAIL: zoo_dg: the Vanilla run's log.txt lacks {needle!r}")
    if (t.cfg.MODEL.BACKBONE.NAME != "resnet18_ms_l12" or t.batch_size != 64
            or t.steps_per_epoch != 85 or len(t.dm.dataset.test) != 3928):
        raise SystemExit("FAIL: zoo_dg: the run is not the recipe's on PACS")
    if not losses or not all(np.isfinite(losses)):
        raise SystemExit(f"FAIL: zoo_dg: non-finite or no loss: {losses}")

    # --eval-only from the epoch's checkpoint: the same 3928 predictions
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t2 = _run_cli(None, _zoo_argv(work, os.path.join(work, "zoo_eval"), "--eval-only",
                                  "--model-dir", out))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    if t2.evaluator.y_pred != t.evaluator.y_pred or len(t2.evaluator.y_pred) != 3928:
        raise SystemExit("FAIL: zoo_dg: --eval-only did not reproduce the PACS predictions")
    del t2
    log(f"zoo_dg: --eval-only reproduced the run's {len(t.evaluator.y_pred)} predictions "
        f"in {eval_s:.1f} s (cold: sketch PNGs decoded, eval view, model)")

    # a resume from the epoch's checkpoint loads weights, BN statistics,
    # optimizer state and generator bit for bit
    ckpt = load_checkpoint(os.path.join(out, "model", f"model.pkl-{ZOO_DG_EPOCHS}"))
    cfg = setup_cfg(build_argparser().parse_args(_zoo_argv(work, out)))
    cfg.VERBOSE = False
    with contextlib.redirect_stdout(io.StringIO()):
        t3 = build_trainer(cfg, device="cuda")
        start = t3.resume_model_if_exist(out)
    params, state = zoo_trees(t3)
    saved = t3.optim_state()
    bad = (_zoo_trees_equal(params, ckpt["state_dict"])
           + _zoo_trees_equal(state, ckpt["extra"]["model_state"])
           + _zoo_trees_equal({"o": saved}, {"o": {k: v for k, v in ckpt["optimizer"].items()
                                                   if k != "name"}})
           + ([] if np.array_equal(t3.generator.get_state().numpy(), ckpt["extra"]["rng_state"])
              else ["generator"]))
    log(f"zoo_dg: resume from model.pkl-{ZOO_DG_EPOCHS}: start epoch {start}, weights, BN "
        f"statistics, optimizer (count {int(saved['count'])}) and generator bit-equal: "
        f"{not bad} {bad[:5]}")
    if bad or start != ZOO_DG_EPOCHS:
        raise SystemExit("FAIL: zoo_dg: the resume did not restore the checkpoint exactly")
    del t3

    # MixStyle's gate and Beta draws come from the trainer's generator, on
    # the card: from one generator state, a step draws the same values twice
    # and advances the generator as the step left to itself does
    it = t.device_batches(t.train_loader_x)
    batch = next(it)
    gen_state = t.generator.get_state()
    t.train_step(batch)
    after = [t.generator.get_state()]
    draws = []
    for _ in range(2):
        t.generator.set_state(gen_state)
        rec = Record(Draws(t.generator))
        t.train_step(batch, draws=rec)
        draws.append(rec.values)
        after.append(t.generator.get_state())
    same = len(draws[0]) == len(draws[1]) == 6 and all(
        a.device.type == "cuda" and torch.equal(a, b) for a, b in zip(*draws)) and all(
        torch.equal(after[0], a) for a in after[1:])
    gates = [float(v) for v in draws[0][0::3]]
    log(f"zoo_dg: MixStyle draws of one step on the card from the trainer's generator "
        f"({len(draws[0])} values: gate, Beta(0.1, 0.1) weights and partners after layer1 and "
        f"layer2; gates {gates}, weights in [{float(draws[0][1].min()):.3g}, "
        f"{float(draws[0][1].max()):.3g}]): bit-equal from one generator state, which advances "
        f"as in the step left to itself: {same}")
    if not same:
        raise SystemExit("FAIL: zoo_dg: MixStyle's draws are not the generator's")

    # no host sync in a step
    batch = next(it)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t.train_step(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("zoo_dg: one Vanilla step under sync debug mode 'error': no synchronizing call")
    # the device's idle share over profiled steps fed by the loader
    for _, b in zip(range(2), it):
        t.train_step(b)

    def profiled_steps():
        for _, b in zip(range(ZOO_DG_PROFILE_STEPS), it):
            t.train_step(b)

    wall, busy = _profile(f"{ZOO_DG_PROFILE_STEPS} Vanilla resnet18_ms_l12 steps on the host "
                          f"pipeline (batch 64, loader to step, steady state)", profiled_steps,
                          top=8)
    it.close()
    n_img = t.steps_per_epoch * t.batch_size
    result = {"run_s": run_s, "epoch_ms": epoch_ms, "epoch_images": n_img,
              "epoch_images_per_s": n_img / epoch_ms * 1e3, "eval_only_s": eval_s,
              "test_images": len(t.evaluator.y_pred), "peak_device_bytes": peak,
              "profiled_steps": ZOO_DG_PROFILE_STEPS, "profiled_wall_ms": wall,
              "profiled_busy_ms": busy, "idle_share": max(0.0, 1 - busy / wall),
              "host_syncs_per_step": 0, "losses": losses,
              "accuracy": float(re.findall(r"[*] accuracy: ([0-9.]+)%", text)[-1])}
    log(f"zoo_dg: PACS epoch (the run's) {epoch_ms:.1f} ms ({n_img} images, "
        f"{result['epoch_images_per_s']:.1f} images/s, host transforms at "
        f"{t.cfg.DATALOADER.NUM_WORKERS} threads); peak device memory {peak / 2**30:.2f} GiB; "
        f"idle share of {ZOO_DG_PROFILE_STEPS} profiled steps {result['idle_share']:.3f}")
    del t
    return result


def _copy_zoo_state(src, dst):
    """dst's weights, BN statistics, method state (ADDA's source model, SE's
    teacher) and optimizer state := src's."""
    import torch

    with torch.no_grad():
        for g, m in list(src.nets.items()) + list(src.extra_nets.items()):
            other = dst.nets[g] if g in dst.nets else dst.extra_nets[g]
            for a, b in zip(m.parameters(), other.parameters()):
                b.copy_(a.to(b.device))

        def move(tree):
            return {k: move(v) if isinstance(v, dict) else v.to(dst.device).clone()
                    for k, v in tree.items()}

        dst.model_state = move(src.model_state)
        dst.extra = move(src.extra)
        for g, opt in src.optims.items():
            other = dst.optims[g]
            for name in opt.buffers:
                for a, b in zip(getattr(opt, name), getattr(other, name)):
                    b.copy_(a.to(b.device))
            other.count = opt.count.to(dst.device).clone()
            other.notfinite_count = opt.notfinite_count.to(dst.device).clone()


def _zoo_tensors(t, extra=False):
    """A zoo trainer's weights and BN statistics as two {dotted name: CPU
    tensor} dicts, named as ``zoo_trees`` names them (the module paths),
    in the port's layouts: a gap is the same in either layout.  With
    ``extra``, also its ``extra_nets``' weights and ``extra``'s tensors
    (MeanTeacher's teacher and its statistics), under "extra."."""
    from fsvlm_tpu_torch.models.convert import flatten

    weights = {f"{g}.{n}": p.detach().cpu() for g, m in t.nets.items()
               for n, p in m.named_parameters()}
    stats = {f"{g}.{k}": v.detach().cpu() for g, s in t.model_state.items()
             for k, v in flatten(s).items()}
    if extra:
        weights.update({f"extra.{g}.{n}": p.detach().cpu() for g, m in t.extra_nets.items()
                        for n, p in m.named_parameters()})
        stats.update({f"extra.{k}": v.detach().cpu() for k, v in flatten(t.extra).items()})
    return weights, stats


def _zoo_rel(card, cpu):
    """max |card - cpu| over max |card| of each tensor of two {name: tensor}."""
    return {k: float((a.double() - cpu[k].double()).abs().max())
            / max(float(a.abs().max()), 1e-30) for k, a in card.items()}


def _zoo_card_vs_cpu(work, name, opts):
    """(b) One DG trainer: ZOO_B_STEPS steps on the card and on its CPU."""
    from fsvlm_tpu_torch.train import build_argparser, setup_cfg

    argv = _zoo_argv(work, os.path.join(work, "zoo_b"), "MODEL.BACKBONE.NAME", "resnet18",
                     "MODEL.BACKBONE.PRETRAINED", "False", "DATALOADER.TRAIN_X.BATCH_SIZE",
                     str(ZOO_B_BATCH), "TEST.NO_TEST", "True",
                     *[str(x) for kv in opts.items() for x in kv])
    argv[argv.index("Vanilla")] = name
    cfg = setup_cfg(build_argparser().parse_args(argv))
    cfg.VERBOSE = False
    label = f"{name} {list(opts.values())[0] if opts and name != 'DAELDG' else ''}".strip()
    return _card_vs_cpu_steps(cfg, label, ZOO_B_STEPS, "zoo_dg", "resnet18 224x224",
                              ZOO_B_BATCH)


def _take(loader, n):
    """``n`` batches of ``loader``, cycled as the XU base cycles the shorter one."""
    out = []
    while len(out) < n:
        it = iter(loader)
        out += [b for _, b in zip(range(n - len(out)), it)]
        it.close()
    return out


def _card_vs_cpu_steps(cfg, label, n_steps, phase, what, batch, sync_check=False, extra=False,
                       keep=None):
    """``n_steps`` steps of one zoo trainer of ``cfg`` on the card and on the
    card's CPU from the same weights, batches (and train_u batches) and
    recorded draws, TF32 off, each step from the card's state: the worst
    loss, weight, zero-init weight and BN statistic gaps (``_zoo_rel``; with
    ``extra``, the method's extra networks and statistics too).  With
    ``sync_check``, one more card step under sync debug mode 'error'.  With
    ``keep`` (a list), the card trainer is appended to it."""
    import torch

    from fsvlm_tpu_torch.engine.trainer import build_trainer
    from fsvlm_tpu_torch.models.draws import Draws, Record, Replay

    with contextlib.redirect_stdout(io.StringIO()):
        card = build_trainer(cfg, device="cuda")
        cpu = build_trainer(cfg, device="cpu")

    n_take = n_steps + (1 if sync_check else 0)
    batches = _take(card.train_loader_x, n_take)
    batches_u = (_take(card.train_loader_u, n_take) if card.train_loader_u is not None
                 else [None] * n_take)
    worst = {"loss": 0.0, "weights": 0.0, "weights_zero_init": 0.0, "statistics": 0.0,
             "weights_rounding_noise": 0.0}
    worst_at = {}
    step_ms = []
    zero_init = {k for k, v in _zoo_tensors(card, extra)[0].items() if not v.any()}

    def group_scale(weights):
        scale = {}
        for k, v in weights.items():
            g = k.split(".")[0]
            scale[g] = max(scale.get(g, 0.0), float(v.abs().max()))
        return scale

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        saved_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for step in range(n_steps):
                _copy_zoo_state(card, cpu)
                card.batch_idx = cpu.batch_idx = step
                rec = Record(Draws(card.generator))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mc = card.train_step(batches[step], draws=rec, batch_u=batches_u[step])
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                mp = cpu.train_step(batches[step], draws=Replay(rec.values, "cpu"),
                                    batch_u=batches_u[step])
                for k in mc:
                    a, b = float(mc[k]), float(mp[k])
                    if k.startswith("loss"):  # relative, absolute below 1 (DDAIG's loss_g)
                        r = abs(a - b) / max(abs(a), 1.0)
                        if r > worst["loss"]:
                            worst["loss"], worst_at["loss"] = r, f"{k} step {step}"
                (pc, sc), (pp, sp) = _zoo_tensors(card, extra), _zoo_tensors(cpu, extra)
                scale = group_scale(pc)
                for kind, rel in (("weights", _zoo_rel(pc, pp)), ("statistics", _zoo_rel(sc, sp))):
                    for k, r in rel.items():
                        kind_k = "weights_zero_init" if kind == "weights" and k in zero_init else kind
                        g = k.split(".")[0]
                        if (kind_k == "weights_zero_init"
                                and float(pc[k].abs().max()) <= ZOO_NOISE * scale[g]):
                            kind_k = "weights_rounding_noise"
                            r = max(float(pc[k].abs().max()), float(pp[k].abs().max())) / scale[g]
                        if r > worst[kind_k]:
                            worst[kind_k], worst_at[kind_k] = r, f"{k} step {step}"
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved_tf32
    syncs = None
    if sync_check:  # the step's batches already on the card: no copy in the step
        on_card = [None if b is None else
                   next(card.device_batches([b])) for b in (batches[-1], batches_u[-1])]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            card.train_step(on_card[0], batch_u=on_card[1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        syncs = 0
    log(f"{phase}: {label} on {what} batch {batch}, {n_steps} steps card vs CPU (TF32 off, "
        f"each step from the card's state): worst loss {worst['loss']:.3g} "
        f"({worst_at.get('loss')}), weights {worst['weights']:.3g} ({worst_at.get('weights')}), "
        f"weights that start at zero {worst['weights_zero_init']:.3g} "
        f"({worst_at.get('weights_zero_init')}), rounding noise {worst['weights_rounding_noise']:.3g}"
        f" ({worst_at.get('weights_rounding_noise')}), BN statistics {worst['statistics']:.3g} "
        f"({worst_at.get('statistics')}); card step ms {[round(x, 2) for x in step_ms]}"
        + ("; one more step under sync debug mode 'error': no synchronizing call"
           if sync_check else ""))
    if keep is not None:
        keep.append(card)
    del card, cpu
    torch.cuda.empty_cache()
    out = {"case": label, **worst, "worst_at": worst_at, "card_step_ms": step_ms}
    if sync_check:
        out["host_syncs_per_step"] = syncs
    return out


@_timed
def phase_zoo_dg(work):
    """Phase 18 (module docstring) on phase 17's PACS tree in ``work``.
    Returns the ``{"zoo_dg": ...}`` numbers."""
    from fsvlm_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
    vanilla = _zoo_vanilla(work)
    cases = [_zoo_card_vs_cpu(work, name, opts) for name, opts in ZOO_B_CASES]
    launched = {k: n for k, n in fa.LAUNCHES.items() if n}
    log(f"zoo_dg: attention kernel launches over the phase: {launched or 'none'}")
    if launched:
        raise SystemExit(f"FAIL: zoo_dg: the zoo launched attention kernels: {launched}")
    over = [c for c in cases if any(
        c[k] > (ZOO_B_BOUND_STN if "stn" in c["case"] else ZOO_B_BOUND)[k] for k in ZOO_B_BOUND)]
    result = {"vanilla": vanilla, "card_vs_cpu": cases, "card_vs_cpu_bound": ZOO_B_BOUND,
              "card_vs_cpu_bound_stn": ZOO_B_BOUND_STN,
              "attention_launches": 0, "phase_s": time.perf_counter() - t_phase}
    log(f"zoo_dg: phase 18 in {result['phase_s']:.1f} s")
    print(json.dumps({"zoo_dg": result}), flush=True)
    if over:
        raise SystemExit(f"FAIL: zoo_dg: card and CPU steps differ past their bounds: "
                         f"{[(c['case'], c['worst_at']) for c in over]}")
    return result


# Office-31's 31 classes and its published domain sizes (Saenko et al., 2010)
OFFICE31_CLASSES = (
    "back_pack", "bike", "bike_helmet", "bookcase", "bottle", "calculator", "desk_chair",
    "desk_lamp", "desktop_computer", "file_cabinet", "headphones", "keyboard",
    "laptop_computer", "letter_tray", "mobile_phone", "monitor", "mouse", "mug",
    "paper_notebook", "pen", "phone", "printer", "projector", "punchers", "ring_binder", "ruler",
    "scissors", "speaker", "stapler", "tape_dispenser", "trash_can")
OFFICE31_SIZES = {"amazon": 2817, "webcam": 795, "dslr": 498}
ZOO_DA_RECIPE = "configs/trainers/zoo/dann_resnet18.yaml"
# the recipe's 20 epochs cut to 1: COUNT_ITER smaller_one, webcam's 795 // 32 = 24
# steps of 32; the CLI's own test after training (795 webcam images) is the one test
ZOO_DA_EPOCHS = 1
ZOO_DA_PROFILE_STEPS = 3  # 5 until the fused-epoch checks came in
# (c): each DA trainer on SyntheticDA with the 3 source domains (d2 also the
# target), cnn_digit5_m3sda (Digit-5's backbone in Dassl's M3SDA and DAEL
# protocols: BN, dropout) at 32x32, ZOO_C_BATCH source and ZOO_C_BATCH_U target
# images, ZOO_C_STEPS steps card vs CPU, each from the card's state, at
# ZOO_C_BOUND; one more card step under sync debug mode 'error'.  The
# settings of tests/test_torch_zoo_da_trainers.py (CDAC at its LR 0.005)
# ZOO_C_STEPS cut from 3 to 2, then to 1, when phase 20 came in (the call's
# time limit); every step started from the card's state anyway
ZOO_C_BATCH, ZOO_C_BATCH_U, ZOO_C_STEPS = 24, 8, 1
ZOO_C_THREE = {"DATALOADER.TRAIN_X.SAMPLER": "RandomDomainSampler",
               "DATALOADER.TRAIN_X.N_DOMAIN": 3}
ZOO_C_CASES = [
    ("SourceOnly", {}), ("DANN", {}), ("ADDA", {}), ("AdaBN", {}),
    ("MCD", {"TRAINER.MCD.N_STEP_F": 2}), ("MME", {}),
    ("SE", {"DATALOADER.K_TRANSFORMS": 2, "TRAINER.SE.CONF_THRE": 0.3}),
    ("M3SDA", dict(ZOO_C_THREE, **{"TRAINER.M3SDA.N_STEP_F": 2})),
    ("CDAC", {"DATALOADER.K_TRANSFORMS": 2, "TRAINER.CDAC.STRONG_TRANSFORMS": ["normalize"],
              "TRAINER.CDAC.RAMPUP_ITRS": 4, "TRAINER.CDAC.P_THRESH": 0.5, "OPTIM.LR": 0.005}),
    ("DAEL", dict(ZOO_C_THREE, **{"TRAINER.DAEL.STRONG_TRANSFORMS": ["normalize"],
                                  "TRAINER.DAEL.CONF_THRE": 0.3})),
]
# (d): each new backbone's train-mode forward and backward (a random cotangent
# on the features) at (input size, batch) on the card and its CPU, TF32 off, the
# card's dropout / drop-connect masks replayed on the CPU: features and input
# gradient as max |card - cpu| over their largest magnitude, the new BN means
# over their largest standard deviation (a batch mean that is zero up to
# rounding has no relative error: 1.7 of its own size measured on the
# EfficientNets) and variances over their largest.  vgg16 and preact_resnet18
# in float64: in float32 a max-pool window whose two largest inputs tie to
# rounding sends its gradient to either (the CPU tests' finding against JAX:
# 4e-2 of the gradient at 224x224), and preact_resnet18's float32 train-mode
# input gradient is ill-conditioned at batch 4 (card vs CPU 4.6e-2, measured;
# the CPU's own float32 against float64 1e-3)
# (c)'s bound: the worst card-vs-CPU gaps measured on cnn_digit5_m3sda
# (four calls): weights 9.9e-3 (M3SDA's fc1.w), statistics 8.9e-3 (M3SDA's
# bnf1.var; 4.1e-3 in the three calls before), losses 1.6e-4 (M3SDA's
# loss_step_B), each at one step, and in
# other trainers on other calls (MCD 3.5e-3, MME 1.6e-3, SE 1.3e-3 at
# fc1.w, DANN 1.0e-3 at the critic's fc1.w).  compare_zoo_f64.py holds each
# fp32 step against a float64 step from the same state: the card's MCD
# step 1 sits 3.5e-3 from it while the CPU's sits 3.1e-7, and the CPU's
# M3SDA step 1 sits 1.7e-3 from it while the card's sits 1.5e-4.  So either
# side strays: an fc activation after BN over 8-24 rows, ReLU and dropout
# that sits within rounding of zero flips between fp32 implementations, and
# one flip moves its sample's whole row of the fc gradient
ZOO_C_BOUND = {"loss": 1e-3, "weights": 5e-2, "weights_zero_init": 0.2, "statistics": 5e-2,
               "weights_rounding_noise": 1e-6}
ZOO_D_CASES = {"alexnet": (64, 4, "float32"), "vgg16": (32, 4, "float64"),
               "preact_resnet18": (32, 4, "float64"),
               **{f"efficientnet_b{i}": (64, 4, "float32") for i in range(8)}}
ZOO_D_BOUND = {"features": 1e-4, "input_grad": 1e-3, "statistics": 1e-4}


def _office31_tree(root, fixtures):
    """Office-31's layout (data/datasets/legacy.py Office31): ``office31/
    <domain>/<class>/<file>`` at the published domain sizes, each domain's
    images split over the 31 classes in turn, hard links to the fixtures."""
    pairs, k = [], 0
    for dom, n in OFFICE31_SIZES.items():
        for i in range(n):
            cls = OFFICE31_CLASSES[i % len(OFFICE31_CLASSES)]
            pairs.append((os.path.abspath(os.path.join(FIXTURE_DIR, fixtures[k % len(fixtures)])),
                          os.path.join(root, "office31", dom, cls, f"frame_{i:04d}.jpg")))
            k += 1
    _link_all(pairs)


def _da_argv(work, out, trainer, *flags):
    return ["--trainer", trainer, "--seed", "1", "--device", "cuda", "--root", work,
            "--dataset-config-file", "configs/datasets/zoo/office31.yaml",
            "--source-domains", "amazon", "--target-domains", "webcam",
            "--config-file", ZOO_DA_RECIPE, "--output-dir", out, *flags,
            "OPTIM.MAX_EPOCH", str(ZOO_DA_EPOCHS)]


def _zoo_dann(work):
    """(a) DANN amazon -> webcam on the Office-31 tree through the CLI."""
    import torch

    from fsvlm_tpu_torch.engine.checkpoint import load_checkpoint
    from fsvlm_tpu_torch.engine.trainer import build_trainer
    from fsvlm_tpu_torch.models.convert import zoo_trees
    from fsvlm_tpu_torch.train import build_argparser, setup_cfg
    from fsvlm_tpu_torch.trainers.zoo.base import NetTrainerXU

    out = os.path.join(work, "dann_run")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _epochs_timed(NetTrainerXU, []) as epochs:
        t = _run_cli(None, _da_argv(work, out, "DANN"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    epoch_ms = epochs[0]
    peak = torch.cuda.max_memory_allocated()
    text = _read(os.path.join(out, "log.txt"))
    losses = [float(x) for x in re.findall(r"\bloss ([-+.\deE]+|nan|inf)", text)]
    log(f"zoo_da: DANN {t.cfg.MODEL.BACKBONE.NAME} ({ZOO_DA_RECIPE}) on Office-31 amazon -> "
        f"webcam through the CLI: {t.steps_per_epoch} steps of {t.batch_size} "
        f"({len(t.dm.dataset.train_x)} source, {len(t.dm.dataset.train_u)} target images), "
        f"{t.num_classes} classes, {len(t.dm.dataset.test)} test images; run {run_s:.1f} s; "
        f"losses logged {losses}; accuracy in log.txt "
        f"{re.findall(r'[*] accuracy: ([0-9.]+)%', text)}")
    for needle in ("no weights found", "Finish training", "* accuracy:", "=> result",
                   "NAME: resnet18", "random_translation", "loss_d"):
        if needle not in text:
            raise SystemExit(f"FAIL: zoo_da: the DANN run's log.txt lacks {needle!r}")
    if (t.cfg.MODEL.BACKBONE.NAME != "resnet18" or t.batch_size != 32 or t.num_classes != 31
            or t.steps_per_epoch != 24 or len(t.dm.dataset.test) != 795):
        raise SystemExit("FAIL: zoo_da: the run is not the recipe's on Office-31")
    if not losses or not all(np.isfinite(losses)):
        raise SystemExit(f"FAIL: zoo_da: non-finite or no loss: {losses}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t2 = _run_cli(None, _da_argv(work, os.path.join(work, "dann_eval"), "DANN", "--eval-only",
                                 "--model-dir", out))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    if t2.evaluator.y_pred != t.evaluator.y_pred or len(t2.evaluator.y_pred) != 795:
        raise SystemExit("FAIL: zoo_da: --eval-only did not reproduce the webcam predictions")
    del t2
    log(f"zoo_da: --eval-only reproduced the run's {len(t.evaluator.y_pred)} predictions in "
        f"{eval_s:.1f} s")

    # a resume: both groups' weights and optimizer states, the net's and the
    # critic's BN statistics and the generator, bit for bit
    ckpt = load_checkpoint(os.path.join(out, "model", f"model.pkl-{ZOO_DA_EPOCHS}"))
    cfg = setup_cfg(build_argparser().parse_args(_da_argv(work, out, "DANN")))
    cfg.VERBOSE = False
    with contextlib.redirect_stdout(io.StringIO()):
        t3 = build_trainer(cfg, device="cuda")
        start = t3.resume_model_if_exist(out)
    params, state = zoo_trees(t3)
    saved = t3.optim_state()
    bad = (_zoo_trees_equal(params, ckpt["state_dict"])
           + _zoo_trees_equal(state, ckpt["extra"]["model_state"])
           + _zoo_trees_equal({"o": saved}, {"o": {g: {k: v for k, v in o.items() if k != "name"}
                                                   for g, o in ckpt["optimizer"].items()}})
           + ([] if np.array_equal(t3.generator.get_state().numpy(), ckpt["extra"]["rng_state"])
              else ["generator"]))
    log(f"zoo_da: resume from model.pkl-{ZOO_DA_EPOCHS}: start epoch {start}, both groups' "
        f"weights and optimizer states (counts {[int(o['count']) for o in saved.values()]}), "
        f"the net's and the critic's BN statistics and the generator bit-equal: {not bad} "
        f"{bad[:5]}")
    if bad or start != ZOO_DA_EPOCHS or set(saved) != {"net", "critic"}:
        raise SystemExit("FAIL: zoo_da: the resume did not restore the checkpoint exactly")
    del t3

    # no host sync in a step; the idle share of loader-fed steps
    pairs = zip(t.device_batches(t.train_loader_x), t.device_batches(t.train_loader_u))
    bx, bu = next(pairs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t.train_step(bx, batch_u=bu)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("zoo_da: one DANN step under sync debug mode 'error': no synchronizing call")
    for _, (bx, bu) in zip(range(2), pairs):
        t.train_step(bx, batch_u=bu)

    def profiled_steps():
        for _, (bx_, bu_) in zip(range(ZOO_DA_PROFILE_STEPS), pairs):
            t.train_step(bx_, batch_u=bu_)

    wall, busy = _profile(f"{ZOO_DA_PROFILE_STEPS} DANN resnet18 steps on the host pipeline "
                          f"(batch 32 + 32, loaders to step, steady state)", profiled_steps, top=8)
    n_img = t.steps_per_epoch * t.batch_size
    result = {"run_s": run_s, "epoch_ms": epoch_ms, "epoch_source_images": n_img,
              "epoch_images_per_s": 2 * n_img / epoch_ms * 1e3, "eval_only_s": eval_s,
              "test_images": len(t.evaluator.y_pred), "peak_device_bytes": peak,
              "profiled_steps": ZOO_DA_PROFILE_STEPS, "profiled_wall_ms": wall,
              "profiled_busy_ms": busy, "idle_share": max(0.0, 1 - busy / wall),
              "host_syncs_per_step": 0, "losses": losses,
              "accuracy": float(re.findall(r"[*] accuracy: ([0-9.]+)%", text)[-1])}
    log(f"zoo_da: Office-31 DANN epoch (the run's) {epoch_ms:.1f} ms ({n_img} source + {n_img} "
        f"target images, {result['epoch_images_per_s']:.1f} images/s, host transforms at "
        f"{t.cfg.DATALOADER.NUM_WORKERS} threads); peak device memory {peak / 2**30:.2f} GiB; "
        f"idle share of {ZOO_DA_PROFILE_STEPS} profiled steps {result['idle_share']:.3f}")
    del t
    return result


def _zoo_adda_adabn(work):
    """(b) SourceOnly amazon -> webcam through the CLI, then ADDA and AdaBN
    from its checkpoint through MODEL.INIT_WEIGHTS, 1 epoch each."""
    import torch

    from fsvlm_tpu_torch.engine.checkpoint import load_checkpoint
    from fsvlm_tpu_torch.models.convert import zoo_trees

    src = os.path.join(work, "source_only")
    del_t = _run_cli(None, _da_argv(work, src, "SourceOnly"))
    del del_t
    init = os.path.join(src, "model", f"model.pkl-{ZOO_DA_EPOCHS}")
    ckpt = load_checkpoint(init)
    text = {}
    for name in ("ADDA", "AdaBN"):
        out = os.path.join(work, name.lower())
        t = _run_cli(None, _da_argv(work, out, name, "MODEL.INIT_WEIGHTS", init))
        text[name] = _read(os.path.join(out, "log.txt"))
        params, state = zoo_trees(t)
        if name == "ADDA":
            moved = _zoo_trees_equal(params["net"]["classifier"],
                                     ckpt["state_dict"]["net"]["classifier"])
            backbone_moved = bool(_zoo_trees_equal(params["net"]["backbone"],
                                                   ckpt["state_dict"]["net"]["backbone"]))
            log(f"zoo_da: ADDA from SourceOnly's checkpoint, {t.steps_per_epoch} steps: the "
                f"classifier unchanged: {not moved}; the backbone moved: {backbone_moved}")
            if moved or not backbone_moved:
                raise SystemExit("FAIL: zoo_da: ADDA's classifier moved, or its backbone did not")
        else:
            moved = _zoo_trees_equal(params, ckpt["state_dict"])
            same_stats = not _zoo_trees_equal(state, ckpt["extra"]["model_state"])
            log(f"zoo_da: AdaBN from SourceOnly's checkpoint, {t.steps_per_epoch} steps: weights "
                f"unchanged: {not moved}; statistics re-estimated (differ from the "
                f"checkpoint's): {not same_stats}")
            if moved or same_stats:
                raise SystemExit("FAIL: zoo_da: AdaBN moved a weight or kept the statistics")
        del t
        torch.cuda.empty_cache()
    acc = {"SourceOnly": _read(os.path.join(src, "log.txt")), **text}
    result = {"webcam_accuracy": {k: float(re.findall(r"[*] accuracy: ([0-9.]+)%", v)[-1])
                                  for k, v in acc.items()}}
    log(f"zoo_da: webcam test accuracy after 1 epoch (random resnet18, fixture images): "
        f"{result['webcam_accuracy']}")
    return result


def _zoo_da_card_vs_cpu(work):
    """(c) Each DA trainer, card against the card's CPU, on SyntheticDA."""
    from fsvlm_tpu_torch.config import get_cfg_base
    from fsvlm_tpu_torch.engine.trainer import build_trainer

    base = {"SEED": 1, "VERBOSE": False, "DATASET.NAME": "SyntheticDA",
            "DATASET.SOURCE_DOMAINS": ["d0", "d1", "d2"], "DATASET.TARGET_DOMAINS": ["d2"],
            "INPUT.SIZE": [32, 32], "INPUT.TRANSFORMS": ["normalize"],
            "MODEL.BACKBONE.NAME": "cnn_digit5_m3sda", "MODEL.BACKBONE.PRETRAINED": False,
            "DATALOADER.TRAIN_X.BATCH_SIZE": ZOO_C_BATCH,
            "DATALOADER.TRAIN_U.BATCH_SIZE": ZOO_C_BATCH_U, "DATALOADER.TRAIN_U.SAME_AS_X": False,
            "DATALOADER.NUM_WORKERS": 2, "OPTIM.NAME": "sgd", "OPTIM.LR": 0.01,
            "OPTIM.MOMENTUM": 0.9, "OPTIM.WEIGHT_DECAY": 5e-4, "OPTIM.MAX_EPOCH": 4,
            "TEST.NO_TEST": True, "TRAIN.COUNT_ITER": "smaller_one"}

    def cfg_of(name, opts):
        cfg = get_cfg_base()
        kv = dict(base, **opts, **{"TRAINER.NAME": name,
                                   "OUTPUT_DIR": os.path.join(work, "zoo_c", name)})
        cfg.merge_from_list([x for pair in kv.items() for x in pair])
        return cfg

    with contextlib.redirect_stdout(io.StringIO()):  # the source model of ADDA and AdaBN
        src = build_trainer(cfg_of("SourceOnly", {}), device="cuda")
        src.save_model(0, os.path.join(work, "zoo_c", "source"))
    init = os.path.join(work, "zoo_c", "source", "model", "model.pkl-1")
    del src
    cases = []
    for name, opts in ZOO_C_CASES:
        if name in ("ADDA", "AdaBN"):
            opts = dict(opts, **{"MODEL.INIT_WEIGHTS": init})
        cases.append(_card_vs_cpu_steps(cfg_of(name, opts), name, ZOO_C_STEPS, "zoo_da",
                                        "cnn_digit5_m3sda 32x32", f"{ZOO_C_BATCH} + {ZOO_C_BATCH_U}",
                                        sync_check=True))
    return cases


def _zoo_backbones_card_vs_cpu(cases=None, phase="zoo_da"):
    """(d) Each new backbone's train-mode forward and backward, card vs CPU
    (``cases``: ZOO_D_CASES by default)."""
    import copy

    import torch

    from fsvlm_tpu_torch.models.backbones import build_backbone
    from fsvlm_tpu_torch.models.convert import flatten, state_tree
    from fsvlm_tpu_torch.models.draws import Draws, Record, Replay

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-30)

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for name, (size, batch, dtype) in (cases or ZOO_D_CASES).items():
            dtype = getattr(torch, dtype)
            cpu = build_backbone(name, seed=3).to(dtype)
            card = copy.deepcopy(cpu).cuda()
            rng = np.random.RandomState(0)
            x = torch.from_numpy(rng.randn(batch, 3, size, size)).to(dtype)
            g = torch.from_numpy(rng.randn(batch, cpu.out_features)).to(dtype)
            res = {}
            for where, net in (("card", card), ("cpu", cpu)):
                dev = "cuda" if where == "card" else "cpu"
                xi = x.to(dev).requires_grad_(True)
                state = _to_device(net.init_state(), dev, dtype)
                draws = Record(Draws(gen)) if where == "card" else Replay(res["draws"], "cpu")
                t0 = time.perf_counter()
                f, ns = net(xi, state, train=True, draws=draws)
                (gx,) = torch.autograd.grad(f, xi, g.to(dev))
                if where == "card":
                    torch.cuda.synchronize()
                    res["card_ms"] = (time.perf_counter() - t0) * 1e3
                    res["draws"] = draws.values
                res[where] = (f.detach().cpu(), gx.cpu(), flatten(state_tree(ns)))
            (fc, gc, sc), (fp, gp, sp) = res["card"], res["cpu"]
            stats = [float(np.abs(np.asarray(sc[k], np.float64) - sp[k]).max()) / max(
                float(np.sqrt(np.abs(sc[k[:-4] + "var"]).max())), 1e-30)
                if k.endswith("mean") else rel(sc[k], sp[k]) for k in sc]
            row = {"case": name, "dtype": str(dtype).split(".")[-1], "size": size,
                   "batch": batch, "features": rel(fc, fp), "input_grad": rel(gc, gp),
                   "statistics": max(stats or [0.0]),
                   "draws": len(res["draws"]), "card_ms_first_call": res["card_ms"]}
            log(f"{phase}: {name} {row['dtype']} {size}x{size} batch {batch} train forward + "
                f"backward card vs CPU (TF32 off, {row['draws']} masks replayed): features "
                f"{row['features']:.3g}, input gradient {row['input_grad']:.3g}, statistics "
                f"{row['statistics']:.3g}")
            out.append(row)
            del card
    torch.cuda.empty_cache()
    return out


def _to_device(tree, dev, dtype):
    return {k: _to_device(v, dev, dtype) if isinstance(v, dict) else v.to(dev, dtype)
            for k, v in tree.items()}


@_timed
def phase_zoo_da():
    """Phase 19 (module docstring).  Returns the ``{"zoo_da": ...}`` numbers."""
    from fsvlm_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
    with open(os.path.join(FIXTURE_DIR, "expected.json")) as f:
        fixtures = sorted(json.load(f))
    work = tempfile.mkdtemp(prefix="chip_smoke_office31_")
    try:
        t0 = time.perf_counter()
        _office31_tree(work, fixtures)
        log(f"zoo_da: an Office-31 tree ({sum(OFFICE31_SIZES.values())} hard links to "
            f"{len(fixtures)} JPEG fixtures, {OFFICE31_SIZES}) in {time.perf_counter() - t0:.1f} s")
        parts, part_s = {}, {}
        for part, fn in (("a", lambda: _zoo_dann(work)), ("b", lambda: _zoo_adda_adabn(work)),
                         ("c", lambda: _zoo_da_card_vs_cpu(work)),
                         ("d", _zoo_backbones_card_vs_cpu)):
            t0 = time.perf_counter()
            parts[part] = fn()
            part_s[part] = time.perf_counter() - t0
        log(f"zoo_da: seconds by part {json.dumps(part_s)}")
        dann, adda, cases, backbones = (parts[k] for k in "abcd")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launched = {k: n for k, n in fa.LAUNCHES.items() if n}
    log(f"zoo_da: attention kernel launches over the phase: {launched or 'none'}")
    if launched:
        raise SystemExit(f"FAIL: zoo_da: the zoo launched attention kernels: {launched}")
    over = [c["case"] for c in cases if any(c[k] > ZOO_C_BOUND[k] for k in ZOO_C_BOUND)]
    over += [b["case"] for b in backbones if any(b[k] > ZOO_D_BOUND[k] for k in ZOO_D_BOUND)]
    result = {"dann": dann, "adda_adabn": adda, "card_vs_cpu": cases,
              "card_vs_cpu_bound": ZOO_C_BOUND, "backbones": backbones,
              "backbones_bound": ZOO_D_BOUND, "attention_launches": 0, "part_s": part_s,
              "phase_s": time.perf_counter() - t_phase}
    log(f"zoo_da: phase 19 in {result['phase_s']:.1f} s")
    print(json.dumps({"zoo_da": result}), flush=True)
    if over:
        raise SystemExit(f"FAIL: zoo_da: card and CPU differ past their bounds: {over}")
    return result


ZOO_SSL_RECIPE = "configs/trainers/zoo/fixmatch_cifar10.yaml"
ZOO_SSL_DATASET = "configs/datasets/zoo/ssl_cifar10.yaml"
# (a): the recipe's 100 epochs cut to 1, and its epoch of 41000 // 448 = 91
# train_u steps cut to ZOO_SSL_STEPS: each step's 64 + 448 weak and 64 + 448
# strong views come from the host's transforms at 8 threads, 1.79 s a step
# measured (host-bound; an H100 80GB HBM3 at 700 W), so 24 steps took phase 20
# to 117 s of its 90, and 10 to 58.8-64.7 s; 8 for the whole call's time, 4
# since the fused-epoch checks came in (phases 6-10), 2 since phase 21 came in.
# TEST.NO_TEST: the CLI's own test after training (10,000 images) is the one
# test
ZOO_SSL_STEPS = 2
ZOO_SSL_PROFILE_STEPS = 2  # 5 until the fused-epoch checks came in, 3 until phase 21
# (b): each SSL trainer on SyntheticDA (target d2 unlabeled) on wide_resnet_28_2
# at 32x32, ZOO_E_BATCH labeled and ZOO_E_BATCH_U unlabeled images, MixMatch at
# K = 2, ZOO_E_STEPS steps card vs CPU as phase 18's (b), each from the card's
# state, MeanTeacher's teacher and its statistics among the compared tensors
ZOO_E_BATCH, ZOO_E_BATCH_U, ZOO_E_STEPS = 16, 16, 2
ZOO_E_CASES = [
    ("SupBaseline", {}), ("EntMin", {}),
    ("MeanTeacher", {"TRAINER.MEANTEACHER.RAMPUP": 2}),
    ("MixMatch", {"DATALOADER.K_TRANSFORMS": 2, "TRAINER.MIXMATCH.RAMPUP": 2}),
    ("FixMatch", {"TRAINER.FIXMATCH.STRONG_TRANSFORMS": ["random_flip", "random_crop",
                                                         "randaugment_fixmatch", "cutout",
                                                         "normalize"],
                  "TRAINER.FIXMATCH.CONF_THRE": 0.3}),
]
# (b)'s bound, each entry over the worst card-vs-CPU gap measured on an H100
# 80GB HBM3 at 700 W (three calls): losses 2.2e-7 (MixMatch's loss); weights
# 1.8e-4 (the stem conv, whose gradient sums over 16 x 32 x 32 positions per
# output, in every trainer); weights that start at zero 2.8e-2 (BatchNorm
# biases, whose gradient sums near-cancelling terms over the batch and the
# image, as phase 18's); statistics 6.2e-7; no zero-init tensor below the noise
# floor.  The bound leaves each a factor of 5-45 over its measurement
ZOO_E_BOUND = {"loss": 1e-5, "weights": 1e-3, "weights_zero_init": 0.2, "statistics": 1e-5,
               "weights_rounding_noise": 1e-6}
# wide_resnet_28_2 in float64: its float32 train-mode input gradient at batch
# 4, 32x32 is ill-conditioned (card vs CPU 3.3e-2; the CPU's own float32
# against float64 3.0e-2, measured), as preact_resnet18's in phase 19;
# wide_resnet_16_4's float32 one sits at 1.6e-6
ZOO_E_BACKBONES = {"wide_resnet_28_2": (32, 4, "float64"), "wide_resnet_16_4": (32, 4, "float32")}


@contextlib.contextmanager
def _steps_per_epoch_cut(cls, n):
    """``cls``'s epochs cut to at most ``n`` steps (its ``_num_batches``,
    which sets both the epoch's steps and the schedule's steps per epoch)."""
    num_batches = cls._num_batches
    cls._num_batches = lambda self: min(num_batches(self), n)
    try:
        yield
    finally:
        cls._num_batches = num_batches


def _ssl_argv(work, out, *flags):
    return ["--trainer", "FixMatch", "--seed", "1", "--device", "cuda", "--root", work,
            "--dataset-config-file", ZOO_SSL_DATASET, "--config-file", ZOO_SSL_RECIPE,
            "--output-dir", out, *flags, "OPTIM.MAX_EPOCH", "1", "TEST.NO_TEST", "True"]


def _strip_name(optim_state):
    return {k: v for k, v in optim_state.items() if k != "name"}


def _zoo_fixmatch(work):
    """(a) FixMatch wide_resnet_28_2 on SSL CIFAR-10 through the CLI."""
    import torch

    from fsvlm_tpu_torch.engine.checkpoint import load_checkpoint
    from fsvlm_tpu_torch.engine.trainer import build_trainer
    from fsvlm_tpu_torch.models.convert import zoo_trees
    from fsvlm_tpu_torch.train import build_argparser, setup_cfg
    from fsvlm_tpu_torch.trainers.zoo.base import NetTrainerXU

    out = os.path.join(work, "fixmatch_run")
    with _steps_per_epoch_cut(NetTrainerXU, ZOO_SSL_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _epochs_timed(NetTrainerXU, []) as epochs:
            t = _run_cli(None, _ssl_argv(work, out))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        epoch_ms = epochs[0]
        peak = torch.cuda.max_memory_allocated()
        text = _read(os.path.join(out, "log.txt"))
        losses = [float(x) for x in re.findall(r"\bloss ([-+.\deE]+|nan|inf)", text)]
        ds = t.dm.dataset
        bu = t.cfg.DATALOADER.TRAIN_U.BATCH_SIZE
        log(f"zoo_ssl: FixMatch {t.cfg.MODEL.BACKBONE.NAME} ({ZOO_SSL_RECIPE}) on SSL CIFAR-10 "
            f"through the CLI: {t.steps_per_epoch} steps of {t.batch_size} labeled + {bu} "
            f"unlabeled ({len(ds.train_x)} labeled, {len(ds.train_u)} unlabeled, "
            f"{len(ds.test)} test images), {t.num_classes} classes; run {run_s:.1f} s; losses "
            f"logged {losses}; accuracy in log.txt {re.findall(r'[*] accuracy: ([0-9.]+)%', text)}")
        for needle in ("no weights found", "Finish training", "* accuracy:", "=> result",
                       "NAME: wide_resnet_28_2", "randaugment_fixmatch", "y_u_pred_keep"):
            if needle not in text:
                raise SystemExit(f"FAIL: zoo_ssl: the FixMatch run's log.txt lacks {needle!r}")
        if (t.batch_size != 64 or bu != 448 or t.num_classes != 10 or len(ds.train_x) != 4000
                or len(ds.train_u) != 41000 or len(ds.test) != 10000
                or t.steps_per_epoch != ZOO_SSL_STEPS):
            raise SystemExit("FAIL: zoo_ssl: the run is not the recipe's on SSL CIFAR-10")
        if not losses or not all(np.isfinite(losses)):
            raise SystemExit(f"FAIL: zoo_ssl: non-finite or no loss: {losses}")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t2 = _run_cli(None, _ssl_argv(work, os.path.join(work, "fixmatch_eval"), "--eval-only",
                                      "--model-dir", out))
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        if t2.evaluator.y_pred != t.evaluator.y_pred or len(t2.evaluator.y_pred) != 10000:
            raise SystemExit("FAIL: zoo_ssl: --eval-only did not reproduce the test predictions")
        del t2
        log(f"zoo_ssl: --eval-only (cold: 10000 test PNGs decoded, eval view, model) reproduced "
            f"the run's {len(t.evaluator.y_pred)} predictions in {eval_s:.1f} s")

        # a resume: weights, BN statistics, optimizer and generator, bit for bit
        ckpt = load_checkpoint(os.path.join(out, "model", "model.pkl-1"))
        cfg = setup_cfg(build_argparser().parse_args(_ssl_argv(work, out)))
        cfg.VERBOSE = False
        with contextlib.redirect_stdout(io.StringIO()):
            t3 = build_trainer(cfg, device="cuda")
            start = t3.resume_model_if_exist(out)
        params, state = zoo_trees(t3)
        saved = t3.optim_state()
        bad = (_zoo_trees_equal(params, ckpt["state_dict"])
               + _zoo_trees_equal(state, ckpt["extra"]["model_state"])
               + _zoo_trees_equal({"o": _strip_name(saved)},
                                  {"o": _strip_name(ckpt["optimizer"])})
               + ([] if np.array_equal(t3.generator.get_state().numpy(),
                                       ckpt["extra"]["rng_state"]) else ["generator"]))
        log(f"zoo_ssl: resume from model.pkl-1: start epoch {start}, weights, BN statistics, "
            f"optimizer (count {int(saved['count'])}) and generator bit-equal: {not bad} "
            f"{bad[:5]}")
        if bad or start != 1:
            raise SystemExit("FAIL: zoo_ssl: the resume did not restore the checkpoint exactly")
        del t3

    # no host sync in a step; the idle share of loader-fed steps
    pairs = zip(t.device_batches(t.train_loader_x), t.device_batches(t.train_loader_u))
    bx, bu_ = next(pairs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t.train_step(bx, batch_u=bu_)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("zoo_ssl: one FixMatch step under sync debug mode 'error': no synchronizing call")
    bx, bu_ = next(pairs)
    t.train_step(bx, batch_u=bu_)

    def profiled_steps():
        for _, (bx_, bu2) in zip(range(ZOO_SSL_PROFILE_STEPS), pairs):
            t.train_step(bx_, batch_u=bu2)

    wall, busy = _profile(f"{ZOO_SSL_PROFILE_STEPS} FixMatch wide_resnet_28_2 steps on the host "
                          f"pipeline (64 + 448, weak and strong views, loaders to step, steady "
                          f"state)", profiled_steps, top=8)
    n_img = t.steps_per_epoch * (t.batch_size + bu)
    result = {"run_s": run_s, "epoch_ms": epoch_ms, "epoch_steps": t.steps_per_epoch,
              "epoch_images": n_img, "epoch_images_per_s": n_img / epoch_ms * 1e3,
              "eval_only_s": eval_s, "test_images": len(t.evaluator.y_pred),
              "peak_device_bytes": peak, "profiled_steps": ZOO_SSL_PROFILE_STEPS,
              "profiled_wall_ms": wall, "profiled_busy_ms": busy,
              "step_busy_ms": busy / ZOO_SSL_PROFILE_STEPS,
              "idle_share": max(0.0, 1 - busy / wall), "host_syncs_per_step": 0,
              "losses": losses,
              "accuracy": float(re.findall(r"[*] accuracy: ([0-9.]+)%", text)[-1])}
    log(f"zoo_ssl: SSL CIFAR-10 FixMatch epoch (the run's, {t.steps_per_epoch} steps) "
        f"{epoch_ms:.1f} ms ({n_img} labeled + unlabeled images, each with a weak and a strong "
        f"view: {result['epoch_images_per_s']:.1f} images/s, host transforms at "
        f"{t.cfg.DATALOADER.NUM_WORKERS} threads); peak device memory {peak / 2**30:.2f} GiB; "
        f"step busy {result['step_busy_ms']:.2f} ms, idle share of {ZOO_SSL_PROFILE_STEPS} "
        f"profiled steps {result['idle_share']:.3f}")
    del t
    return result


def _zoo_ssl_cfg(work, name, opts):
    from fsvlm_tpu_torch.config import get_cfg_base

    base = {"SEED": 1, "VERBOSE": False, "DATASET.NAME": "SyntheticDA",
            "DATASET.SOURCE_DOMAINS": ["d0", "d1"], "DATASET.TARGET_DOMAINS": ["d2"],
            "INPUT.SIZE": [32, 32], "INPUT.TRANSFORMS": ["normalize"],
            "MODEL.BACKBONE.NAME": "wide_resnet_28_2", "MODEL.BACKBONE.PRETRAINED": False,
            "DATALOADER.TRAIN_X.BATCH_SIZE": ZOO_E_BATCH,
            "DATALOADER.TRAIN_U.BATCH_SIZE": ZOO_E_BATCH_U, "DATALOADER.TRAIN_U.SAME_AS_X": False,
            "DATALOADER.NUM_WORKERS": 2, "DATALOADER.TEST.BATCH_SIZE": 32, "OPTIM.NAME": "sgd",
            "OPTIM.LR": 0.03, "OPTIM.MOMENTUM": 0.9, "OPTIM.WEIGHT_DECAY": 5e-4,
            "OPTIM.MAX_EPOCH": 4, "TEST.NO_TEST": True, "TRAIN.COUNT_ITER": "smaller_one"}
    cfg = get_cfg_base()
    kv = dict(base, **opts, **{"TRAINER.NAME": name,
                               "OUTPUT_DIR": os.path.join(work, "zoo_e", name)})
    cfg.merge_from_list([x for pair in kv.items() for x in pair])
    return cfg


def _zoo_ssl_card_vs_cpu(work):
    """(b) Each SSL trainer, card against the card's CPU, on SyntheticDA; then
    MeanTeacher's checkpoint resumed into a new trainer."""
    import torch

    from fsvlm_tpu_torch.engine.trainer import build_trainer

    cases, kept = [], []
    for name, opts in ZOO_E_CASES:
        cases.append(_card_vs_cpu_steps(
            _zoo_ssl_cfg(work, name, opts), name, ZOO_E_STEPS, "zoo_ssl",
            "wide_resnet_28_2 32x32", f"{ZOO_E_BATCH} + {ZOO_E_BATCH_U}", sync_check=True,
            extra=name == "MeanTeacher", keep=kept if name == "MeanTeacher" else None))
    # MeanTeacher's checkpoint: weights, statistics, teacher, optimizer, generator
    mt = kept[0]
    ckpt_dir = os.path.join(work, "zoo_e", "mt_ckpt")
    with contextlib.redirect_stdout(io.StringIO()):
        mt.save_model(0, ckpt_dir)
        t2 = build_trainer(_zoo_ssl_cfg(work, "MeanTeacher", dict(ZOO_E_CASES)["MeanTeacher"]),
                           device="cuda")
        start = t2.resume_model_if_exist(ckpt_dir)
    (wa, sa), (wb, sb) = _zoo_tensors(mt, True), _zoo_tensors(t2, True)
    bad = [k for k in wa if not torch.equal(wa[k], wb[k])]
    bad += [k for k in sa if not torch.equal(sa[k], sb[k])]
    bad += _zoo_trees_equal({"o": _strip_name(mt.optim_state())},
                            {"o": _strip_name(t2.optim_state())})
    bad += [] if torch.equal(mt.generator.get_state(), t2.generator.get_state()) else ["generator"]
    n_teacher = sum(k.startswith("extra.") for k in list(wa) + list(sa))
    log(f"zoo_ssl: MeanTeacher checkpoint after {ZOO_E_STEPS} card steps resumed into a new "
        f"trainer: start epoch {start}; weights, statistics, the teacher's {n_teacher} weights "
        f"and statistics, optimizer and generator bit-equal: {not bad} {bad[:5]}")
    if bad or start != 1 or not n_teacher:
        raise SystemExit("FAIL: zoo_ssl: MeanTeacher's resume did not restore its state exactly")
    del mt, t2, kept
    torch.cuda.empty_cache()
    return cases


def _zoo_ssl_nccl(work):
    """(c) FixMatch at world size 1 under a NCCL process group against the
    same run without one: two steps and the gathered eval, bit for bit."""
    import socket

    import torch
    import torch.distributed as dist

    from fsvlm_tpu_torch.engine.trainer import build_trainer
    from fsvlm_tpu_torch.parallel import mesh

    cfg = _zoo_ssl_cfg(work, "FixMatch", dict(ZOO_E_CASES)["FixMatch"])
    with contextlib.redirect_stdout(io.StringIO()):
        host = build_trainer(cfg, device="cuda")
    batches = list(zip(_take(host.train_loader_x, 2), _take(host.train_loader_u, 2)))
    x_test = torch.from_numpy(next(iter(host.test_loader))["img"])
    del host

    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            t = build_trainer(cfg, device="cuda")
            metrics = []
            for bx, bu in batches:
                (dx,), (du,) = list(t.device_batches([bx])), list(t.device_batches([bu]))
                metrics.append({k: v.clone() for k, v in t.train_step(dx, batch_u=du).items()})
            y_true, y_pred = t.test(return_pred=True)
            with torch.no_grad():
                x = t.eval_images(mesh.shard_rows(x_test).cuda()).movedim(-1, -3)
                logits = mesh.gather_rows(t.infer(x))
        weights, stats = _zoo_tensors(t)
        return metrics, weights, stats, y_pred, logits.cpu(), mesh.world_size(), mesh.active()

    def differ(a, b):
        ma, wa, sa, pa, la = a[:5]
        mb, wb, sb, pb, lb = b[:5]
        out = [f"m{i}.{k}" for i, (x, y) in enumerate(zip(ma, mb)) for k in x
               if not torch.equal(x[k], y[k])]
        out += [k for k in wa if not torch.equal(wa[k], wb[k])]
        out += [k for k in sa if not torch.equal(sa[k], sb[k])]
        out += [] if pa == pb else ["test predictions"]
        return out + ([] if torch.equal(la, lb) else ["eval logits"])

    with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False):
        ref, again = run(), run()
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                                rank=0)
        try:
            got = run()
        finally:
            dist.destroy_process_group()
    repeat, pg = differ(ref, again), differ(ref, got)
    log(f"zoo_ssl: FixMatch wide_resnet_28_2, 2 steps of {ZOO_E_BATCH} + {ZOO_E_BATCH_U} and "
        f"the eval ({len(ref[3])} test images, logits gathered): without a process group twice "
        f"bit-equal: {not repeat} {repeat[:5]}; under NCCL at world size {got[5]} (active "
        f"{got[6]}) bit-equal to without: {not pg} {pg[:5]}")
    if repeat or pg or got[5] != 1 or not got[6] or ref[6]:
        raise SystemExit("FAIL: zoo_ssl: world size 1 under NCCL differs from no process group")
    return {"steps": len(batches), "test_images": len(ref[3]), "bit_equal": True,
            "backend": "nccl", "world_size": 1}


@_timed
def phase_zoo_ssl(ssl_work=None):
    """Phase 20 (module docstring), on phase 17's SSL CIFAR-10 tree in
    ``ssl_work`` (built here when None).  Returns the ``{"zoo_ssl": ...}``
    numbers."""
    from fsvlm_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
    work = ssl_work or tempfile.mkdtemp(prefix="chip_smoke_ssl_")
    try:
        t0 = time.perf_counter()
        if ssl_work is None:
            _ssl_tree(work, "cifar_rgb8_32.png")
        tree_s = time.perf_counter() - t0
        where = "phase 17's" if ssl_work else f"built in {tree_s:.1f} s"
        log(f"zoo_ssl: an SSL CIFAR-10 tree (60000 hard links to one 32x32 PNG): {where}")
        parts, part_s = {}, {}
        for part, fn in (("a", lambda: _zoo_fixmatch(work)),
                         ("b", lambda: _zoo_ssl_card_vs_cpu(work)),
                         ("backbones", lambda: _zoo_backbones_card_vs_cpu(ZOO_E_BACKBONES,
                                                                          "zoo_ssl")),
                         ("c", lambda: _zoo_ssl_nccl(work))):
            t0 = time.perf_counter()
            parts[part] = fn()
            part_s[part] = time.perf_counter() - t0
        log(f"zoo_ssl: seconds by part {json.dumps(part_s)}")
    finally:
        if ssl_work is None:
            shutil.rmtree(work, ignore_errors=True)
        else:  # the phase's own outputs; the tree is the caller's
            for d in ("fixmatch_run", "fixmatch_eval", "zoo_e"):
                shutil.rmtree(os.path.join(work, d), ignore_errors=True)
    launched = {k: n for k, n in fa.LAUNCHES.items() if n}
    log(f"zoo_ssl: attention kernel launches over the phase: {launched or 'none'}")
    if launched:
        raise SystemExit(f"FAIL: zoo_ssl: the SSL zoo launched attention kernels: {launched}")
    cases, backbones = parts["b"], parts["backbones"]
    over = [c["case"] for c in cases if any(c[k] > ZOO_E_BOUND[k] for k in ZOO_E_BOUND)]
    over += [b["case"] for b in backbones if any(b[k] > ZOO_D_BOUND[k] for k in ZOO_D_BOUND)]
    result = {"fixmatch": parts["a"], "card_vs_cpu": cases, "card_vs_cpu_bound": ZOO_E_BOUND,
              "backbones": backbones, "backbones_bound": ZOO_D_BOUND,
              "world_size_1_nccl": parts["c"], "attention_launches": 0, "tree_s": tree_s,
              "part_s": part_s, "phase_s": time.perf_counter() - t_phase}
    log(f"zoo_ssl: phase 20 in {result['phase_s']:.1f} s")
    print(json.dumps({"zoo_ssl": result}), flush=True)
    if over:
        raise SystemExit(f"FAIL: zoo_ssl: card and CPU differ past their bounds: {over}")
    return result


RANKS_EPOCHS = 2  # (a): PromptSRC's epochs each way (IVLP: 1)
RANKS_B_STEPS, RANKS_B_TEST = 2, 200  # (b): steps of the global batch; test() images
# (b): two ranks against one process, fp32 with TF32 off: per step
# |dloss| <= RANKS_DLOSS * (1 + |loss|); each trained tensor's max |d| <=
# RANKS_DPARAM of its largest magnitude (the two ranks sum their rows'
# gradients apart and add the sums: rounding, ~1e-7 relative)
RANKS_DLOSS, RANKS_DPARAM = 1e-5, 1e-4
LORA_MASK_RANKS, LORA_MASK_BATCH = 8, 32  # the global-shape dropout draws' cost, per rank


def _ranks_worker(world, rank, port, out):
    """Phase 21 (b), one process: PromptSRC ViT-B/16 in fp32 (TF32 off) at
    the global batch TRAIN_BATCH, this rank's rows of it (all of it at
    world 1), RANKS_B_STEPS steps on the phase-6 cache with host-given
    boxes and flips for the global batch, then test() on RANKS_B_TEST cache
    images; under a gloo process group of ``world`` ranks on cuda:0 when
    world > 1.  Writes the metrics, the prompts, the predictions and the
    step's kernel launches to ``out`` (rank 0)."""
    import torch
    import torch.distributed as dist

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.ops.preprocess import sample_crop_boxes, sample_flips
    from fsvlm_tpu_torch.parallel import mesh
    from fsvlm_tpu_torch.trainers.backbone import load_clip_backbone
    from fsvlm_tpu_torch.trainers.promptsrc import PromptSRC

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    if world > 1:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                                rank=rank)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            clip = load_clip_backbone("ViT-B/16", frozen="fp32", seed=0, device="cuda")
            cfg = _train_cfg("PROMPTSRC")
            cfg.MODEL.FROZEN_DTYPE = "fp32"
            cfg.TRAINER.PROMPTSRC.PREC = "fp32"
            cfg.TRAIN.EPOCH_FUSE = "off"  # a gloo collective cannot be captured
            cache, labels = _train_cache()
            t = PromptSRC(cfg, [f"class {i}" for i in range(N_CLASSES)], cache, labels, clip=clip,
                          device="cuda", steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
        gen = torch.Generator(device="cuda").manual_seed(21)
        b = TRAIN_BATCH // world
        rows = slice(rank * b, (rank + 1) * b)
        res = {"world": np.asarray(mesh.world_size())}
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        for step in range(RANKS_B_STEPS):
            index = torch.arange(step * TRAIN_BATCH, (step + 1) * TRAIN_BATCH, device="cuda")
            aug = (sample_crop_boxes(TRAIN_BATCH, 224, 224, (0.08, 1.0), gen),
                   sample_flips(TRAIN_BATCH, gen))
            t.epoch, t.batch_idx = divmod(step, TRAIN_STEPS_PER_EPOCH)
            m = t.train_step_resident(index[rows], aug=(aug[0][rows], aug[1][rows]))
            res.update({f"m{step}/{k}": np.asarray(float(v)) for k, v in m.items()})
        torch.cuda.synchronize()
        res["launches"] = np.asarray(json.dumps(dict(fa.LAUNCHES)))
        res.update({f"p/{k}": v.detach().cpu().numpy() for k, v in t.params.items()})
        with contextlib.redirect_stdout(io.StringIO()):
            _, pred = t.test(cache[:RANKS_B_TEST], labels[:RANKS_B_TEST].cpu().numpy(),
                             return_pred=True)
        res["pred"] = np.asarray(pred)
        launches = json.loads(str(res["launches"]))
        log(f"ranks: (b) rank {rank} of {world}: {RANKS_B_STEPS} steps of {b} rows, kernel "
            f"launches {({k: n for k, n in launches.items() if n})}")
        if rank == 0:
            np.savez(out, **res)
    finally:
        if world > 1:
            dist.destroy_process_group()


def _start_ranks_b(work):
    """Phase 21 (b)'s three processes, started together: two gloo ranks and
    one process alone."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    me = os.path.abspath(__file__)
    runs = [(2, r, os.path.join(work, "two.npz")) for r in range(2)] + [
        (1, 0, os.path.join(work, "one.npz"))]
    return [subprocess.Popen([sys.executable, me, "--ranks-worker", str(w), str(r), str(port),
                              out], cwd=os.path.dirname(me), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for w, r, out in runs]


def _finish_ranks_b(procs, work, per_step):
    """Wait for (b)'s processes and hold the two ranks to the one process."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        for line in out.splitlines():
            if line.startswith("ranks:"):
                log(line)
        if p.returncode != 0:
            raise SystemExit(f"FAIL: ranks: (b) process {p.args[3:6]} exited {p.returncode}: "
                             f"{out[-3000:]}")
    two = dict(np.load(os.path.join(work, "two.npz")))
    one = dict(np.load(os.path.join(work, "one.npz")))
    dmetric = {k: abs(float(two[k]) - float(one[k])) / (1 + abs(float(one[k])))
               for k in one if k.startswith("m")}
    dloss = max(v for k, v in dmetric.items() if k.endswith("/loss"))
    dparam = {k[2:]: float(np.abs(two[k] - one[k]).max() / np.abs(one[k]).max())
              for k in one if k.startswith("p/")}
    same_keys = two.keys() == one.keys()
    same_pred = bool(np.array_equal(two["pred"], one["pred"]))
    launches = [json.loads(str(r["launches"])) for r in (two, one)]
    want = {k: n * RANKS_B_STEPS for k, n in per_step.items()}
    log(f"ranks: (b) PromptSRC ViT-B/16 fp32, TF32 off, global batch {TRAIN_BATCH}: 2 gloo ranks "
        f"on cuda:0 ({TRAIN_BATCH // 2} + {TRAIN_BATCH // 2}) against one process, "
        f"{RANKS_B_STEPS} steps: max |dloss|/(1+|loss|) {dloss:.3e} (bound {RANKS_DLOSS:g}; "
        f"every metric {({k: f'{v:.1e}' for k, v in dmetric.items()})}), "
        f"max |dparam|/max|param| {max(dparam.values()):.3e} (bound {RANKS_DPARAM:g}) "
        f"{ {k: f'{v:.2e}' for k, v in dparam.items()} }; test() on {RANKS_B_TEST} images, "
        f"predictions equal: {same_pred}; rank 0's step launches {launches[0]}")
    if (not same_keys or int(two["world"]) != 2 or int(one["world"]) != 1
            or dloss > RANKS_DLOSS or max(dparam.values()) > RANKS_DPARAM or not same_pred):
        raise SystemExit("FAIL: ranks: (b) two ranks and one process differ past the bounds")
    for got in launches:
        if any(got.get(k, 0) != n for k, n in want.items()):
            raise SystemExit(f"FAIL: ranks: (b) the steps launched {got}, expected {want}")
    return {"dloss": dloss, "dloss_bound": RANKS_DLOSS, "dmetric": dmetric, "dparam": dparam,
            "dparam_bound": RANKS_DPARAM, "predictions_equal": same_pred,
            "test_images": RANKS_B_TEST, "steps": RANKS_B_STEPS, "backend": "gloo",
            "device": "cuda:0", "launches_rank0": launches[0]}


def _ranks_runs(label, build, epochs, per_step, groups):
    """Phase 21 (a) for one trainer: ``epochs`` epochs step by step and
    fused (each from a new trainer, ``build(mode)``, so from the seed's
    state), without a process group and under a NCCL one of world size 1;
    the fused runs under torch.profiler.  Everything bit-equal across the
    four runs (metrics, trained tensors, optimizer counts and moments,
    generator, mixup rng, GPA); the wrappers' calls per_step x steps step
    by step, per_step x 2 fused (the warm-up and the captured step); the
    fused trace's kernel events of ``groups`` per_step x steps and one
    cudaGraphLaunch per replay; the replay loop under NCCL without a sync."""
    import gc
    import socket

    import torch
    import torch.distributed as dist

    from fsvlm_tpu_torch.engine import fused
    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.parallel import mesh

    def run(mode):
        t = build(mode)
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        _zero_fused_steps()

        def epochs_():
            hist = []
            for t.epoch in range(epochs):
                with contextlib.redirect_stdout(io.StringIO()):
                    hist.append(t.run_epoch())
                    t.after_epoch()  # PromptSRC: GPA (no DataManager: no checkpoint)
            return hist

        if mode == "on":
            hist, traced, graphs = _traced(epochs_, groups)
        else:
            hist, traced, graphs = epochs_(), None, None
        state = _trainer_state(t)
        state["gpa"] = {k: v.clone() for k, v in (getattr(t, "gpa_params", None) or {}).items()}
        return {"t": t, "hist": hist, "state": state, "launches": dict(fa.LAUNCHES),
                "traced": traced, "graphs": graphs, "steps": dict(fused.STEPS),
                "world": mesh.world_size(), "active": mesh.active()}

    runs = {}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for pg in ("none", "nccl"):
        if pg == "nccl":
            dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                                    rank=0)
        try:
            for mode in ("off", "on"):
                runs[pg, mode] = run(mode)
            if pg == "nccl":
                _no_sync_replays(f"ranks: {label} under NCCL", runs[pg, "on"]["t"])
        finally:
            for r in runs.values():  # the graphs go before the process group
                t = r.pop("t", None)
                if t is not None:
                    t._fused = None
            gc.collect()
            torch.cuda.synchronize()
            if pg == "nccl":
                dist.destroy_process_group()
    ref = runs["none", "off"]
    steps = sum(len(h) for h in ref["hist"])

    def same(a, b):
        return (a["hist"] == b["hist"] and _states_equal(a["state"], b["state"])
                and a["state"]["gpa"].keys() == b["state"]["gpa"].keys()
                and all(torch.equal(v, b["state"]["gpa"][k]) for k, v in a["state"]["gpa"].items()))

    equal = {f"{pg}/{mode}": same(r, ref) for (pg, mode), r in runs.items()}
    want_traced = _group_launches(groups, per_step, steps)
    log(f"ranks: (a) {label}, {epochs} epoch(s) of {steps // epochs} steps, step by step and fused, "
        f"without a process group and under NCCL at world size {runs['nccl', 'on']['world']} "
        f"(active {runs['nccl', 'on']['active']}): bit-equal to the first run (metrics, trained "
        f"tensors, optimizer, generator, mixup rng, GPA) {equal}; wrapper calls "
        f"{ {f'{pg}/{m}': {k: r['launches'][k] for k in per_step} for (pg, m), r in runs.items()} }; "
        f"fused steps {runs['nccl', 'on']['steps']}; the fused runs' traces: kernel events "
        f"{runs['none', 'on']['traced']} / {runs['nccl', 'on']['traced']} (expected {want_traced}), "
        f"cudaGraphLaunch {runs['none', 'on']['graphs']} / {runs['nccl', 'on']['graphs']}")
    if not all(equal.values()) or runs["nccl", "on"]["world"] != 1 or not runs["nccl", "on"]["active"]:
        raise SystemExit(f"FAIL: ranks: (a) {label}: the runs differ: {equal}")
    for (pg, mode), r in runs.items():
        n = steps if mode == "off" else 2
        if any(r["launches"][k] != c * n for k, c in per_step.items()):
            raise SystemExit(f"FAIL: ranks: (a) {label} {pg}/{mode}: wrapper calls "
                             f"{r['launches']}, expected per step {per_step} x {n}")
        if mode == "on" and (r["traced"] != want_traced or r["graphs"] != steps - 1
                             or r["steps"] != {"eager": 1, "captured": 1, "replays": steps - 1}):
            raise SystemExit(f"FAIL: ranks: (a) {label} {pg}/on: trace {r['traced']}, "
                             f"{r['graphs']} graph launches, steps {r['steps']}; expected "
                             f"{want_traced} and {steps - 1}")
    return {"steps": steps, "bit_equal": equal, "traced": runs["nccl", "on"]["traced"],
            "graph_replays": runs["nccl", "on"]["graphs"],
            "launches": runs["nccl", "on"]["launches"]}


def _lora_mask_cost():
    """LoRA's dropout keep masks across ranks: each rank draws the image
    tower's masks for the global batch (LORA_MASK_RANKS ranks of
    LORA_MASK_BATCH // LORA_MASK_RANKS rows) and keeps its rows.  One step's
    draws (ViT-B/16's 12 layers x q, k, v at (rows, 197, 768)) at the global
    shape and at the local one, by CUDA events: launched eagerly (a step
    by step epoch), and as replays of a captured graph (a fused epoch: the
    device's time alone), median of 5."""
    import torch

    def draw(rows):
        return [torch.rand((rows, 197, 768), device="cuda") < 0.75 for _ in range(12 * 3)]

    def ms_of(fn):
        times = []
        for _ in range(6):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times[1:]))

    g, l = LORA_MASK_BATCH, LORA_MASK_BATCH // LORA_MASK_RANKS
    out = {"ranks": LORA_MASK_RANKS, "global_batch": g}
    for name, rows in (("global", g), ("local", l)):
        eager = ms_of(lambda: draw(rows))
        graph = torch.cuda.CUDAGraph()
        draw(rows)
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            draw(rows)
        out[name] = {"rows": rows, "eager_ms": eager, "replay_ms": ms_of(graph.replay),
                     # the float draws written and read, the bool masks written
                     "mib": rows * 12 * 3 * 197 * 768 * 9 / 2**20}
        del graph
    log(f"ranks: LoRA dropout masks of the image tower per step and rank at {LORA_MASK_RANKS} "
        f"ranks, global batch {g}, on {CARD[0]}: drawn at the global shape "
        f"({g} rows, {out['global']['mib']:.1f} MiB moved) {out['global']['eager_ms']:.3f} ms "
        f"eager, {out['global']['replay_ms']:.3f} ms replayed; at the local ({l} rows, "
        f"{out['local']['mib']:.1f} MiB) {out['local']['eager_ms']:.3f} / "
        f"{out['local']['replay_ms']:.3f} ms")
    return out


@_timed
def phase_ranks(clip):
    """Phase 21 (module docstring).  Returns the ``{"ranks": ...}`` numbers."""
    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa
    from fsvlm_tpu_torch.trainers.ivlp import IVLP
    from fsvlm_tpu_torch.trainers.promptsrc import PromptSRC

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    n = clip.cfg.vision_layers
    per_step = {fa.KERNEL: 3 * n, fa.KERNEL_DKV: 2 * n, fa.KERNEL_DQ: 2 * n}
    procs = _start_ranks_b(work)  # (b) runs beside (a)
    try:
        classnames = [f"class {i}" for i in range(N_CLASSES)]
        cache, labels = _train_cache()

        def promptsrc(mode):
            cfg = _train_cfg("PROMPTSRC")
            cfg.TRAIN.EPOCH_FUSE = mode
            with contextlib.redirect_stdout(io.StringIO()):
                return PromptSRC(cfg, classnames, cache, labels, clip=clip, device="cuda",
                                 steps_per_epoch=TRAIN_STEPS_PER_EPOCH)

        def ivlp(mode):
            cfg = _train_cfg("IVLP")
            node = cfg.TRAINER.IVLP
            node.USE_MIXUP, node.USE_KD, node.KD_ALPHA = True, True, 0.5
            cfg.TRAIN.EPOCH_FUSE = mode
            with contextlib.redirect_stdout(io.StringIO()):
                return IVLP(cfg, classnames, cache, labels, clip=clip, device="cuda",
                            steps_per_epoch=TRAIN_STEPS_PER_EPOCH)

        with force_pallas(None):
            a_promptsrc = _ranks_runs("PromptSRC", promptsrc, RANKS_EPOCHS, per_step,
                                      FLASH_GROUPS)
        with force_pallas("1"):  # every attention through the blockwise kernels #3-#5
            bw = {fa.BW_KERNEL: 3 * n, fa.BW_KERNEL_DKV: 2 * n, fa.BW_KERNEL_DQ: 2 * n}
            a_ivlp = _ranks_runs("IVLP mixup + KD", ivlp, 1, bw, BW_GROUPS)
        mask_cost = _lora_mask_cost()
        b = _finish_ranks_b(procs, work, per_step)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(work, ignore_errors=True)
    result = {"a_promptsrc": a_promptsrc, "a_ivlp": a_ivlp, "b": b, "lora_masks": mask_cost,
              "card": CARD[0], "phase_s": time.perf_counter() - t_phase}
    log(f"ranks: phase 21 in {result['phase_s']:.1f} s")
    print(json.dumps({"ranks": result}), flush=True)
    return a_promptsrc["launches"]


def _recipe_cfg_from_argv(argv):
    """The CLI's config for ``argv`` (setup_cfg), without running it."""
    from fsvlm_tpu_torch.train import build_argparser, setup_cfg

    return setup_cfg(build_argparser().parse_args(argv))


def main():
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    worst, timings = phase_kernels()
    worst_bwd, timings_bwd = phase_kernels_bwd()
    worst_bw, timings_bw = phase_kernels_blockwise()
    worst_fused, timings_fused = phase_kernels_fused()
    with force_pallas(None):  # the default route: the d = 64 kernels
        pred, batch = phase_main()
        phase_profile(pred, batch)
        main_flash, launches = phase_train(pred.clip)
    with force_pallas("1"):  # every attention through the blockwise kernels
        main_bw, launches_bw = phase_train_ivlp(pred.clip)
    with force_pallas("legacy"):  # every attention through the whole-sequence kernels
        main_fused, launches_coop = phase_coop_cocoop(pred.clip)
    with force_pallas(None):  # the CLI on the default route: the d = 64 kernels
        launches_cli = phase_cli(pred.clip)
    with force_pallas(None):  # the CLIP-path trainers on the d = 64 kernels
        launches_clip = phase_clip_trainers(pred.clip)
    with force_pallas(None):  # PLIP and the RN towers on the d = 64 kernels
        launches_plip = phase_plip_resnet(pred.clip)
    tree = {}  # phase 12's tree and model, for phase 14's tools
    try:
        with force_pallas(None):  # the CLI on a JPEG tree, on the d = 64 kernels
            launches_recognition, recognition = phase_recognition(pred.clip, keep=tree)
        with force_pallas(None):  # the host train transforms and SimCLR, on the d = 64 kernels
            launches_host = phase_host_aug(pred.clip, recognition)
        # int8 serving and teachers, the tools (sets FSVLM_FORCE_PALLAS per part)
        _, launches_int8_serving, launches_int8_teacher, launches_int8_ivlp = phase_int8_tools(
            pred.clip, tree)
        with force_pallas(None):  # lpclip and the serving export on the d = 64 kernels
            _, launches_lpclip, launches_export = phase_lpclip_export(tree)
        with force_pallas(None):  # the drivers through the runner, on the d = 64 kernels
            launches_driver, _ = phase_drivers(pred.clip, tree)
    finally:
        if tree:
            shutil.rmtree(tree["work"], ignore_errors=True)
    pacs_work = tempfile.mkdtemp(prefix="chip_smoke_pacs_")  # phases 17 and 18
    ssl_work = tempfile.mkdtemp(prefix="chip_smoke_ssl_")  # phases 17 and 20
    try:
        try:
            with force_pallas(None):  # the Dassl datasets and PNG, PACS on the d = 64 kernels
                launches_pacs, _ = phase_zoo_data(pred.clip, pacs_work, ssl_work)
            phase_zoo_dg(pacs_work)  # the DG zoo: no attention
        finally:
            shutil.rmtree(pacs_work, ignore_errors=True)
        phase_zoo_da()  # the DA zoo on its Office-31 tree: no attention
        phase_zoo_ssl(ssl_work)  # the SSL zoo and one rank under NCCL: no attention
    finally:
        shutil.rmtree(ssl_work, ignore_errors=True)
    launches_ranks = phase_ranks(pred.clip)  # the CLIP trainers across ranks

    import torch

    from fsvlm_tpu_torch.ops import flash_attention as fa

    # each row's main path is a fused run (TRAIN.EPOCH_FUSE auto, the
    # default): ``launches`` its wrappers' calls (the warm-up step's and the
    # captured step's), ``launches_traced`` its kernel events in the
    # profiler's trace (every step's), ``graph_replays`` its replays
    src = "fsvlm_tpu_torch/ops/kernels/"
    rows = [(fa.KERNEL, "flash_attn_fwd.cu", 544, worst, timings["vision"], main_flash, "#6"),
            (fa.KERNEL_DKV, "flash_attn_bwd.cu", 599, worst_bwd[fa.KERNEL_DKV],
             timings_bwd["vision"][fa.KERNEL_DKV], main_flash, "#7"),
            (fa.KERNEL_DQ, "flash_attn_bwd.cu", 648, worst_bwd[fa.KERNEL_DQ],
             timings_bwd["vision"][fa.KERNEL_DQ], main_flash, "#8")]
    rows += [(name, source, line, worst_bw[name], timings_bw["vision"][name], main_bw, group)
             for name, source, line, group in (
                 (fa.BW_KERNEL, "blockwise_attn_fwd.cu", 232, "#3"),
                 (fa.BW_KERNEL_DKV, "blockwise_attn_bwd.cu", 324, "#4"),
                 (fa.BW_KERNEL_DQ, "blockwise_attn_bwd.cu", 372, "#5"))]
    rows.append((fa.FUSED_KERNEL, "fused_attn_fwd.cu", 32, worst_fused[fa.FUSED_KERNEL],
                 timings_fused["vision"][fa.FUSED_KERNEL], main_fused, "#1"))
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": src + source,
        "replaces": f"fsvlm_tpu/ops/flash_attention.py:{line}",
        "launches": run["launches"][name],
        "max_abs_err": err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "launches_traced": run["traced"][group],
        "graph_replays": run["graphs"],
    } for name, source, line, err, t, run, group in rows]
    launches_fused = main_fused["launches"]
    # #2 is three CUDA kernels (row pre-pass, dK/dV, dQ), each launched once
    # per backward: one row, its time the three launches in a row, its parts
    # with their own launch counts and times
    bwd = timings_fused["vision"]["bwd"]
    parts = (fa.FUSED_KERNEL_STATS, fa.FUSED_KERNEL_DKV, fa.FUSED_KERNEL_DQ)
    if len({launches_fused[k] for k in parts}) != 1:
        raise SystemExit(f"FAIL: #2's kernels launched unequal counts: {launches_fused}")
    # #6-#8's launches on every path that runs them (wrapper calls; a fused
    # run's leave out its replays)
    by_path = {"promptsrc_fused": main_flash["launches"], "promptsrc_step_by_step": launches,
               "promptsrc_cli": launches_cli, **launches_clip,
               **launches_plip, "recognition_cli": launches_recognition, **launches_host,
               "zsclip_int8_test": launches_int8_serving,
               "promptsrc_int8_teacher": launches_int8_teacher,
               "lpclip_extract": launches_lpclip, "driver_setting_a": launches_driver,
               "pacs_dg_cli": launches_pacs, "promptsrc_fused_nccl": launches_ranks,
               **{f"export_{label}_loaded_call": {fa.KERNEL: n}
                  for label, n in launches_export.items()}}
    for row in kernels[:3]:
        row["launches_by_path"] = {path: n.get(row["name"], 0) for path, n in by_path.items()}
    # #3-#5's: phase 7's IVLP mixup epoch fused and KD steps step by step, and
    # phase 14's with the int8 KD teacher
    for row in kernels[3:6]:
        row["launches_by_path"] = {"ivlp_mixup_fused": row["launches"],
                                   "ivlp_kd_step_by_step": launches_bw[row["name"]],
                                   "ivlp_kd_int8_teacher": launches_int8_ivlp[row["name"]]}
    # device times (profiler) beside the event times: the forwards', #7/#8's
    # and #4/#5's
    for row, t in ((kernels[0], timings["vision"]),
                   (kernels[1], timings_bwd["vision"][fa.KERNEL_DKV]),
                   (kernels[2], timings_bwd["vision"][fa.KERNEL_DQ]),
                   (kernels[3], timings_bw["vision"][fa.BW_KERNEL]),
                   (kernels[4], timings_bw["vision"][fa.BW_KERNEL_DKV]),
                   (kernels[5], timings_bw["vision"][fa.BW_KERNEL_DQ]),
                   (kernels[-1], timings_fused["vision"][fa.FUSED_KERNEL])):
        row.update(device_ms=t["device_ms"], library_device_ms=t["library_device_ms"])
    kernels.append({
        "name": "fused_attn_bwd", "route": "cuda", "source": src + "fused_attn_bwd.cu",
        "replaces": "fsvlm_tpu/ops/flash_attention.py:116",
        "launches": launches_fused[fa.FUSED_KERNEL_DQ], "max_abs_err": worst_fused["bwd"],
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"], "library_ms": bwd["library_ms"],
        "parts": [{"name": k, "launches": launches_fused[k], "ms": bwd["parts"][k]} for k in parts],
        "launches_traced": main_fused["traced"]["#2"], "graph_replays": main_fused["graphs"],
        "launches_step_by_step": {k: launches_coop[k] for k in parts},
        "device_ms": bwd["device_ms"], "library_device_ms": bwd["library_device_ms"],
    })
    log(f"chip_smoke: seconds by phase {json.dumps(PHASE_S)}")
    log(f"chip_smoke: all 21 phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ranks-worker"]:  # phase 21 (b)'s processes
        _ranks_worker(*(int(x) for x in sys.argv[2:5]), sys.argv[5])
    else:
        main()
