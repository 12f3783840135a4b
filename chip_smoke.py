#!/usr/bin/env python3
"""Drives the PyTorch port (big_vision_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(`python3 chip_smoke.py --checks` stops after phase 2: a quick check of
every kernel and of the JPEG decoder after a change to one;
`python3 chip_smoke.py --serving` builds and runs phase 3 alone, with
the plain paths' decode times and the decode profiles of the bf16 and
the int8 KV cache that the full script leaves out for its time limit;
`python3 chip_smoke.py --recipes` builds and runs phase 9 alone;
`python3 chip_smoke.py --quality` builds and runs phase 10 alone, with
the quality_digits run that the full script leaves out for its time
limit;
`python3 chip_smoke.py --siglip` builds and runs phase 11 alone;
`python3 chip_smoke.py --paligemma` builds and runs phase 12 alone, with
its fixed-batch steps in turns and their profiles;
`python3 chip_smoke.py --imagetext` builds and runs phase 14 alone and
prints its kernels line and the last line; `--naflex` and `--jet` do the
same for phases 15 and 16.)

Phases, each of which raises (and so exits non-zero) on failure:
  1. builds every CUDA kernel from big_vision_torch/csrc (one nvcc each, in
     parallel), and the JPEG decoder big_vision_torch/native/dataio.cc with
     g++, linking the libjpeg that `big_vision_torch.native` finds (on the
     card, Pillow's bundled copy), whose path it prints;
  2. holds each kernel against its plain PyTorch version in bf16 (K1 and K2
     also in f32), at the shapes of the serving and training paths and at
     the edge cases (masks, Tq != Tkv, int8 cache, softcap, fully masked
     rows, which must give exact zeros; for K1 and K2 also D=20, which the
     bf16 tensor-core kernels load without 16-byte copies), with the bar
     max|kernel - plain| / max|plain| <= 1e-2 (docs/flash_parity.md) in
     bf16 (bf16 inputs run K1's and K2's bf16 tensor-core kernels); f32
     inputs run K1's and K2's 3xTF32 kernels, held to F32_BAR = 1e-4
     (their semantics are f32, only the order of sums differs) at
     FlexiViT-B's seqhw 5, 15 and 24, the quality phase's D = 16 (B=256,
     H=6) and D = 32 (B=64, H=4) at T=64, LiT's T = 197 (B=64, H=12,
     D=64), causal, seg (padding rows: o
     exact zeros, LSE exactly -1e30), Tq != Tkv and D = 18, 72, 128, 256;
     for K1
     o and the row LSE, for K2 each of dq, dk and dv is held to the bar;
     the blocked kernels K3, K4a
     and K4b (o, LSE, dq, dk, dv; K4a and K4b on K3's o and LSE) at the
     FlexiViT-B shapes (B=32, H=12, D=64, T=901 and 1601) in f32 (bar 1e-4:
     their semantics are f32, only the order of sums differs) and bf16,
     on the docs/flash_parity.md grid (T in {197, 577, 1056} x D in {64,
     128} x seg, the blocked path chosen by block sizes below T=1056), and
     at causal, Tq != Tkv, seg with an all-padding row, D=256 and D=18;
     K5 (dq, dk, dv on K3's o and LSE) against its plain version on the
     same cases and bars, against K4a + K4b in f32 (bar 1e-4), and through
     `flash_attention`'s backward with `FUSED_BLOCKED_BWD` set (one K5
     launch, the same gradients);
     K6 (split over the SMs, `decode_attention.plan`) at the serving
     shape in bf16 and int8 (with and without softcap), with live spans
     that end mid-split and leave leading and trailing splits wholly
     masked, S = 1, S shorter than a split, S not a multiple of it, H = 72
     and 20 (element loads), bf16 q, two tiles a split, B=64 at S=352 and
     S=1120 in bf16, int8 and f32 and at S=1121, and B=32 at H=72 in
     int8 with softcap: each launch repeated and asserted
     bit-equal, every example with no visible slot exact zeros;
     and the JPEG decoder: its full decode of 9 JPEGs of 256x320 bit-equal
     to PIL's, and the YUV path (planes cropped on the host, RGB made by
     `yuv420_to_rgb` on the card) against the RGB decode of the smooth
     image of the JAX package's tests/test_native.py, mean |diff| under
     3.0 and 99th percentile under 12.0, the JAX package's bar;
  3. serves PaliGemma-3B (So400m/14 at 224px + gemma_2b, random bf16
     weights from SEED) to a batch of 8 requests through predict_fns,
     checks that the image tower launched K1's tensor-core kernel once per
     layer and every AR
     step launched K6 once per layer, and holds the prefill logits and 4
     teacher-forced AR steps against the plain path (math attention,
     einsum decode) on the same card within 2e-2 of max|logit|, the bar
     of tests/test_decode_attention.py; then the same with the int8 KV
     cache (the same weights, INT8_DECODE tokens, K6 on the int8 store
     with its per-slot scales) against the int8 plain path; then
     (3b) int8 LLM weights: the model's weights written as one `.npz` in
     the JAX layout (tower bf16, LLM quantized on the card by
     `gemma.quantize_params`), loaded through `paligemma.load` into a
     `quant=True` model and served as above with the bf16 and the int8 KV
     cache, against its plain path; its prefill logits beside the
     bf16-weight model's (a report), its times, the weight conversions of
     one AR step timed alone, and a profiled decode with the share of the
     kernels that read int8; (3c) beam search (beam 2) and best-of-n
     (n 2, greedy) on the serving batch, BEAM_DECODE tokens: every K6
     launch on 2 x BATCH cache rows, one per layer per AR step, tokens
     equal to the plain path's, beam 1 equal to greedy, and the beam rows
     teacher-forced after random parent reorders of the cache against the
     plain path recomputing each step from scratch; (3d) video:
     VIDEO_B clips of VIDEO_FRAMES frames at 224px through the tower in
     one forward (27 K1 launches), VIDEO_DECODE greedy tokens over the
     2064-slot prefix, K6 at every step where `decode_attention.fits`
     holds, kernel vs plain path as above; (3e) the interactive runner
     `trainers/proj/paligemma/run.py` through `main`, on the `.npz` of 3b
     (LLM int8), a synthetic JPEG, a hand-written unigram vocab of 256000
     pieces and two prompts on stdin: two answers, K1 and K6 launched,
     the answers equal to a plain-path decode of the same pp output; the
     `.npz` is deleted at the end;
  4. measures the host decode rate: images per second of the ViT config's
     host pp phase, decode_jpeg_and_inception_crop_yuv(224), over its
     synthetic JPEGs on the input pipeline's thread map, on the config's
     threads and on one (with os.cpu_count()); then trains ViT-B/16 at
     224px, batch 256, through `big_vision_torch.train` and
     configs/vit_b16_synthetic.py (random init from the config's seed, the
     real input pipeline on bench.py's input: synthetic JPEGs decoded on
     the host into YUV 4:2:0 planes with an inception crop, made RGB on the
     card) for TRAIN_STEPS steps, after the config's classification eval
     at step 0 (1024 JPEGs: decode, resize_small(256), central_crop(224) on
     the host; 4 batches; val/prec@1, val/loss and z/secs/eval/val in the
     metrics file, eval img/s printed): every loss finite, K1's
     tensor-core kernel launched 12 times per step and per eval batch,
     K2's 12 times per step, no other kernel; whether the step is bound by
     the host (more than HOST_BOUND_SHARE slower than the step on a fixed
     batch below, and how much of that is input stall); then 10 more
     steps on one fixed
     batch, whose loss must fall (timed with CUDA events: the step without
     the input pipeline), a profile of one step (device busy time), and
     the kernel path against the plain path (attn_impl="xla") from the
     trained state on a batch no update has seen: the loss and the
     encoder's output within 2e-2 in f32 and bf16; each K2 launch of the
     bf16 backward, on its own inputs, within 1.25 times the plain
     version's distance from the f32 backward (floor 1e-2); in f32 every
     attention-projection gradient within 2e-2 of max|plain|; in bf16 each
     such gradient within 1.5 times the bf16 plain path's distance from
     the f32 plain path's, floor 2e-2 (see `kernel_vs_plain_training`);
  5. trains FlexiViT-B (f32, batch 32, random init from the config's seed)
     through `big_vision_torch.trainers.proj.flexi.train` and
     configs/proj/flexivit/i21k_sup.py with attn=flash (the config's
     default "auto" follows the JAX package's gate, which takes the plain
     path at seqhw 30 and 40): the config's evals at step 0 on FLEXI_NEVAL
     synthetic JPEGs a split (classification at seqhw 5, 10, 15 and 30;
     the few-shot linear probe at 15 on the 37-class pets stand-in, 224px),
     every eval batch launching 12 K1 (f32) at seqhw 5, 10 and 15 and 12
     K3 at 30 (eval img/s and the few-shot seconds printed), then
     FLEXI_STEPS steps of its own loop
     and seqhw draws (15, 15, 15, 40, 30), then steps at seqhw 40, 30, 15,
     twice, through `update(batch, seqhw=...)`, each timed with CUDA
     events, with its peak memory, and with 12 launches of K3, K4a and K4b
     (none of K1, K2) at seqhw 30 and 40 and 12 of K1's and K2's f32
     kernels at 15 (none of their bf16 tensor-core kernels); a
     profile of one step at seqhw 40 (device busy time); the loss falling
     over FLEXI_FIXED_STEPS steps on one batch at seqhw 40; and the kernel
     path against the plain path at seqhw 40 on 8 unseen images (loss,
     encoder output and attention-projection gradients within 2e-2; each
     K3 launch of the forward (o, and the LSE of a repeat launch) and each
     K4a and K4b launch of the backward, on its own inputs, within 1e-4 of
     its plain version); each K1 and K2 launch (their f32 kernels) of a
     forward and backward at seqhw 15 on 32 unseen images, on its own
     inputs, within 1e-4 of its plain version (K1: o and the LSE of a
     repeat launch); each eval's `pre_logits` on one of its batches against
     the plain path (attn=xla) within 1e-4; then the same state under
     attn=auto: two steps each at seqhw 40 and 30 (CUDA events, peak
     memory) with no kernel launched, and an eval batch at each seqhw (K1
     at 5, 10, 15; the plain path, no kernel, at 30);
  6. distils FlexiViT-B from a ViT-B/8 teacher (f32, batch 32) through
     `big_vision_torch.trainers.proj.flexi.distill` and
     configs/proj/flexivit/i21k_distill.py with attn=flash and
     `FUSED_BLOCKED_BWD` set:
     the teacher has random weights from SEED and a seeded nonzero head,
     written with `npz_save` in the oldest published layout (a posemb with
     a [cls] row, for 224px) and loaded through `prof_init` and `vit.load`
     (the row folded into [cls], 28x28 resampled to 30x30); DISTILL_STEPS
     steps of the trainer's own loop and draws, with a checkpoint at the
     last, from which a new trainer resumes to equal params, optimizer
     state, next seqhw and next loss; then steps at seqhw 40, 30, 15,
     twice, through `update(batch, seqhw=...)` (CUDA events, peak memory,
     and per step 24 K3 and 12 K5 launches at seqhw 30 and 40, none of K4a
     and K4b; 12 K3 and 12 each of K1's and K2's f32 kernels at 15); a
     profile of
     one step at
     seqhw 40; the loss falling over 10 steps on one batch at seqhw 40;
     and the kernel path against the plain path at seqhw 40 on 8 unseen
     images (loss, student encoder output and attention-projection
     gradients within 2e-2; each K5 launch of the backward, on its own
     inputs, within 1e-4 of its plain version);
  7. distils FlexiViT-B/16 from DeiT-III B/16 through the same trainer and
     configs/proj/flexivit/i1k_deit3_distill.py with attn=flash: a random
     ViT-B/16 at 384px from SEED, in the DeiT-III checkpoint's layout, is
     written as an `.npz` and loaded into the student (posemb 24x24 to
     7x7) and the teacher (to 15x15 at 240px); its minival evals at step 0
     (DEIT3_NEVAL images a split: 12 K1 at seqhw 5, 10, 15, 12 K3 at 30 a
     batch), DEIT3_STEPS loop steps, then steps at seqhw 40, 30, 15, twice
     (CUDA events; 12 K1 for the teacher, 12 K3, K4a, K4b at 30 and 40, 12
     K1, K2 at 15), finite losses; each eval's `pre_logits` against the
     plain path within 1e-4;
  8. runs configs/proj/distill/smoke.py through the generic distill
     trainer (`trainers/proj/distill/distill.py`) at its own size
     (ViT-mu/16 at 32px, 10 steps, a random teacher from SEED): finite
     distill losses and the `val` and `distance` rows at steps 0 and 10;
     at T = 4 the JAX package's gate takes the plain path: no launch;
  9. trains the ImageNet recipes through `big_vision_torch.train` at full
     width, each at its config's per-card batch with the randaug of its pp
     (RECIPES): configs/vit_s16_i1k.py (ViT-S/16, batch 1024, its five
     evals at step 0 on 256 JPEGs a split), configs/vit_i1k.py (AugReg
     ViT-B/16, `medium2`, batch 256), configs/mlp_mixer_i1k.py (Mixer-B/16,
     batch 512), configs/transfer.py (vit-s16 at 384px, batch 256, from
     a random ViT-S/16 `.npz` loaded through `model_init`),
     configs/vit_i21k.py (AugReg ViT-B/16 `light2`, 21,843 classes, batch
     256) and configs/proj/gsam/vit_i1k_gsam_no_aug.py (ViT-B/32 through
     the GSAM trainer, batch 1024), RECIPE_STEPS
     steps each after their evals at step 0: launches exact (per step 12
     of K1's and 12 of K2's f32 kernels for a ViT, 24 of each under GSAM,
     12 of K1's per eval batch, none for the Mixer), losses finite, step
     ms, img/s, input
     stall and peak memory printed; the loss on a fixed batch falling over
     RECIPE_FIXED_STEPS steps; for a ViT the kernel path against the plain
     path (attn=xla) on RECIPE_CHECK_B unseen images (loss, encoder output,
     attention-projection gradients within F32_BAR), and for ViT-S/16
     every in-place K1 and K2 launch of a full-batch step (B*H = 6144)
     against its plain version within F32_BAR; the ms of each randaug per
     batch and its share of the step; first the 16 RandAugment ops on the
     card against the CPU (uint8-equal, but for RANDAUG_OP_SHARE of the
     pixels of sharpness and rotate); for GSAM the GSAM gradient of the
     kernel path against the plain path's (both passes, within GSAM_BAR);
     for vit_i21k and GSAM an update tried at twice the batch (out of
     memory: the batch is the largest power of two that fits); and last
     RECIPE_OPT_STEPS steps of
     ViT-S/16 under `big_vision.scale_by_adafactor` and under
     `big_vision.momentum_hp` (finite states, bf16 where the JAX package
     keeps them in bf16);
 10. (`--quality` only, left out of the full script for its time limit:
     2000 steps bound by the host) trains configs/quality_digits.py through
     `train.main` at its own
     size (ViT width 96, depth 6, 6 heads: T=64, D=16; batch 256, 2000
     steps on the 1437 training digits written from
     big_vision_torch/datasets/digits.npz, its eval of the 360 test digits
     every 200 steps): launches exact (6 of K1's and 6 of K2's f32
     kernels a step, 6 of K1's an eval batch), val/prec@1 at step 2000 at
     least the config's EXPECTED (0.96), the step on a fixed batch, a
     profile of one step and the input pipeline alone timed; then (in the
     full script too) configs/twin_dynamics.py at its full size (width 128, depth 2, 4
     heads: D=32; batch 64, 200 steps on the data of the JAX package's
     tools/dynamics_twin.py, drawn here in numpy) from one random init,
     under attn "auto" (2 K1 and 2 K2 f32 launches a step) and attn=xla
     (none): every step's training_loss within TWIN_BAR (1e-3) relative;
 11. trains configs/proj/image_text/siglip_lit_coco.py (LiT: a frozen
     ViT-B/16 at 224px with [cls], T = 197, and BERT-base at 16 tokens,
     both from random `.npz` inits read through the config's `model_init`
     and `model_load`; the stand-in `vocab.txt` of 30,522 rows) through
     the SigLIP trainer's command line at batch 256 for SIGLIP_STEPS
     steps, with a checkpoint and the retrieval eval (256 images, 1280
     captions) at the last step and the eval at step 0: launches exact
     (12 K1f and 12 K2f a step, the frozen tower's backward included; 12
     K1f a batch of images, none a batch of captions), the frozen tower's
     params equal to the init's, recalls in [0, 1], step ms, img/s, stall,
     peak memory and the eval's img/s; SIGLIP_FIXED_STEPS steps on one
     batch; the kernel path against attn=xla on an unseen batch (loss,
     zimg, ztxt within E2E_BAR) and each K1f and K2f launch of its forward
     and backward in place within F32_BAR; an update at twice the batch
     (out of memory: 256 is the largest power of two that fits); then
     `tools/eval_only` on `load_and_eval:name=proj.image_text.siglip_lit_coco`
     from the trainer's checkpoint (recalls equal to the trainer's last
     eval) and on `load_and_eval:name=vit_i1k` from a random AugReg
     ViT-B/16 `.npz` (EVAL_ONLY_NEVAL images a split, 12 K1f a batch, eval
     img/s);
 12. fine-tunes PaliGemma-3B on configs/proj/paligemma/transfers/cococap.py
     (So400m/14 at 224px + gemma_2b, T = 256 + 33, f32, remat, from the
     seed, the stand-in Gemma tokenizer written in place) through the
     PaliGemma trainer's command line at the config's batch PG_B, PG_STEPS
     steps as configured (the tower's `auto`: K1f and K2f; the LLM's
     einsum attention) and PG_STEPS with `attn=flash` (the LLM's 18 layers
     on K1f and K2f with the prefix-LM `seg`), each after the config's
     step-0 evals on PG_NEVAL stand-in images a split (three beam-decode
     `coco_caption` evals, three perplexity evals): launches exact (per
     step twice per layer K1f, the forward and the remat recompute, and
     K2f once: 54 and 27 as configured, 90 and 45 under flash; per eval
     batch the tower's 27 K1f, plus the LLM's 18 in a flash "logits"
     forward), every metric finite, step ms, img/s and peak memory; an
     update at twice the batch (out of memory: PG_B is the largest power
     of two that fits); the LLM's flash path against its einsum path on
     PG_CHECK_B unseen examples (loss, text logits, every attention-
     projection gradient within E2E_BAR); each LLM K1f and K2f launch of a
     forward and backward on PG_INPLACE_B examples in place within
     F32_BAR; K1f and K2f at the LLM's shape with `seg` timed beside their
     plain versions and SDPA with the boolean mask (two entries of the
     kernels line); with `--paligemma` also the update on a fixed batch
     under both paths in turns and a profile of each;
 14. (run before 13) trains CapPa on configs/proj/cappa/pretrain.py (a
     ViT-B/16 encoder at 224px, T = 196, and a 6-layer decoder of 64
     tokens over a vocab of 32,000 and [MASK], parallel prediction at
     0.75, f32, from the seed, the stand-in `c4_en` tokenizer written in
     place) through the generative trainer's command line at its batch
     CAPPA_B, CAPPA_STEPS steps after its step-0 evals (`val_pplx` on
     CAPPA_NEVAL stand-in images; the scoring classifier over the 1000
     CLIP ImageNet class names on CAPPA_SCORING stand-in images):
     launches exact (12 K1f and 12 K2f a step, 12 K1f an eval batch), the
     first loss ln(32000) within 1e-4, every metric finite, step ms, img/s,
     peak memory, eval seconds; the encoder's kernel path against
     attn=xla on CAPPA_CHECK_B unseen examples (loss, logits and every
     attention-projection gradient within E2E_BAR), the launches under
     the remat of `scan=True` (24 K1f, 12 K2f; the loss unchanged) and
     each K1f and K2f launch of a forward and backward on the unseen batch
     in place within F32_BAR; FIXED_UPDATES updates on that batch (CUDA events); an update
     at twice the batch (out of memory: CAPPA_B is the largest power of
     two that fits); then CLIPPO on configs/proj/clippo/train_clippo.py
     (one ViT-B/16 with a MAP head for the images and their PIL-rendered
     captions, from a random `.npz` with a random head) through the SigLIP
     trainer's command line at CLIPPO_B, CLIPPO_STEPS steps and the
     retrieval eval at steps 0 and CLIPPO_STEPS on CLIPPO_NEVAL images
     (24 K1f and 24 K2f a step, 12 K1f an eval batch of images or
     rendered captions), its fixed-batch step and an update at twice its
     batch; then `tools/eval_only` on siglip_lit_coco (random `.npz`
     inits) with the discriminative classifier (`zeroshot`: 81 CLIP-paper
     templates x 1000 class names embedded by BERT-base, ZEROSHOT_N
     stand-in images; 12 K1f an image batch, none a text batch), the
     host's and the card's seconds; and K1f, K2f at CapPa's shape timed
     beside their plain versions and SDPA (two entries of the kernels
     line);
 15. (run before 13) trains SigLIP 2's NaFlex B/16 (`naflex_config`:
     siglip_lit_coco's BERT-base text tower and loss, the image tower
     `proj.image_text.naflex_vit` at 256 tokens with a MAP head, trained;
     JPEGs with sides in NAFLEX_SIDES, so every example carries its own
     padding) through the SigLIP trainer's loop at NAFLEX_B for
     NAFLEX_STEPS steps: launches exact (12 K1f with segment ids and 12
     K2f a step), the first loss; the kernel path (`flash`, seg) against
     attn=xla (a [B, T, T] boolean mask) on an unseen batch (loss and zimg
     within NAFLEX_BAR, every gradient within NAFLEX_GRAD_BAR of its max);
     each K1f and K2f launch in place within F32_BAR, the padded query
     rows of o and dq exact zeros; the step on a fixed batch, img/s, peak
     memory; K1f and K2f at its shape with seg timed (two entries);
 16. (run before 13) trains Jet on configs/proj/jet/imagenet64.py at full
     width and depth (32 couplings of 2 ViT blocks, emb 512, 8 heads, ps
     4: T = 256, D = 64) at JET_B for JET_STEPS steps with the val eval at
     step 0 and at the end: launches exact (128 K1f and 64 K2f a step
     under the couplings' remat, 64 K1f an eval batch), the first bits/dim
     against its closed form (the flow is the identity at init) within
     JET_BAR; forward then inverse (within JET_ROUNDTRIP); the conditioners'
     auto path against attn=xla (bits/dim within JET_BAR, gradients
     within JET_GRAD_BAR); the fixed-batch step; then JetFormer-350M on
     configs/proj/jetformer/jetformer_imagenet2012.py (256px, the Jet
     adaptor of 32 couplings x 4 blocks; the decoder's attention is the
     plain path, as in JAX) at JF_B for JF_STEPS steps with its val eval
     at step 0: launches exact (256 K1f and 128 K2f a step, 128 K1f an
     eval batch), the first loss against its closed form from the
     zero-init image head within JF_BAR, the adaptor's auto path against
     xla, the fixed-batch step, and JF_SAMPLES class-conditional samples
     (256 AR steps with the KV cache and CFG, the adaptor's inverse, the
     patches), timed; K1f and K2f at Jet's conditioner shape and at the
     adaptor's timed (four entries);
 13. times prefill, the AR step, the training step (end to end: median of
     windows, input stall; on a fixed batch; device busy under the
     profiler; MFU against a bf16 8192^3 matmul measured here) and each
     kernel (CUDA events, inputs rotated through more than the 50 MB L2)
     beside its plain version and F.scaled_dot_product_attention on the
     same inputs, in the kernel's own dtype (forward, or its autograd
     backward for K2, K4a, K4b and K5), which the port never calls; K1's
     and K2's bf16 kernels and their plain versions in turns; K1's
     tensor-core kernel also at the serving shape; K1's and K2's f32
     kernels at seqhw 15 and 24 and K3, K4a, K4b and K5 at seqhw 40 and
     30, with their bounds at the 3xTF32 rate; and K5 against K4a + K4b
     on the same inputs; K6 also at B=64, S=1120 in bf16 and int8.
The line before the last is {"kernels": [...]}: K1's and K2's bf16
tensor-core kernels are reported at the ViT training shape (B=256, T=196,
H=12, D=64; launches per training step, the step-0 eval's 12 K1 launches
per batch left out), K1's and K2's f32 kernels at FlexiViT-B's
seqhw 15 (B=32, T=226, H=12, D=64, f32; launches per step of the FlexiViT
phase), K3,
K4a, K4b and K5 at the FlexiViT-B shape of seqhw 40 (B=32, T=1601, H=12,
D=64, f32; launches per step of the FlexiViT phase, and for K5 of the
distillation phase), K6 at the serving shape with a bf16 and with an int8
cache (launches per request batch of the bf16 and the int8 pass; its
"ms" from CUDA events around the wrapper's calls, with "graph_ms", the
same calls in a CUDA graph, "profiled_ms", its two kernels' device time,
and "host_us", the wrapper's host time a call; no SDPA on an int8
cache); max_abs_err and max_rel_err are at those shapes, and
rel_tolerance is the bar the relative error was held to; K1's and K2's f32
kernels also at the PaliGemma LLM's shape (B=PG_B, T=289, H=8, D=256,
f32, seg; launches of the LLM on phase 12's flash path) and at CapPa's
encoder shape (B=CAPPA_B, T=196, H=12, D=64, f32; launches on its main
path), and the f32 rows carry `paligemma_launches`, phase 12's counts of
each path, and `imagetext_launches`, phase 14's counts of CapPa, CLIPPO
and the zero-shot eval. The last line is {"ok": true,
"device": {...}}. Without a CUDA device it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import io
import json
import math
import os
import shutil
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from big_vision_torch.tools import kernel_timing
from big_vision_torch.tools.kernel_timing import blocked_inputs
from big_vision_torch.tools.kernel_timing import bound
from big_vision_torch.tools.kernel_timing import F32_FLOPS
from big_vision_torch.tools.kernel_timing import flexi_bwd_sets
from big_vision_torch.tools.kernel_timing import k1_inputs
from big_vision_torch.tools.kernel_timing import k1_work
from big_vision_torch.tools.kernel_timing import k2_work
from big_vision_torch.tools.kernel_timing import k4a_work
from big_vision_torch.tools.kernel_timing import k4b_work
from big_vision_torch.tools.kernel_timing import k5_work
from big_vision_torch.tools.kernel_timing import k6_inputs
from big_vision_torch.tools.kernel_timing import nvidia_smi
from big_vision_torch.tools.kernel_timing import sdpa_bwd_ms
from big_vision_torch.tools.kernel_timing import sdpa_fwd_ms
from big_vision_torch.tools.kernel_timing import TF32X3_FLOPS
from big_vision_torch.tools.kernel_timing import time_blocked_bwd
from big_vision_torch.tools.kernel_timing import time_k6
from big_vision_torch.tools.kernel_timing import time_ms

SEED = 0
BATCH, RES, PROMPT, DECODE = 8, 224, 32, 64
INT8_DECODE = 16  # greedy tokens of the int8 KV cache's pass
BEAM_DECODE = 16  # tokens of the beam-search and best-of-n passes
BEAM_CHECK_STEPS = 4  # teacher-forced AR steps of the beam reorder check
# Video: clips of 8 frames (the JAX package's msrvtt_cap transfer config),
# 16 greedy tokens.
VIDEO_B, VIDEO_FRAMES, VIDEO_DECODE = 2, 8, 16
RUNNER_DECODE = 16  # the runner's --max_decode_len
IMG_TOKENS = (RES // 14) ** 2  # So400m/14 at 224px: 256
CACHE = IMG_TOKENS + PROMPT + DECODE  # KV cache slots of the serving run
BEAM_CACHE = IMG_TOKENS + PROMPT + BEAM_DECODE  # ... of beam and best-of-n
K1_BAR, K2_BAR, K6_BAR, E2E_BAR = 1e-2, 1e-2, 1e-2, 2e-2
# Kernels with f32 semantics (K2's f32 kernel, K3-K5 in f32), where only the
# order of sums may differ from the plain version.
F32_BAR = 1e-4
# In the bf16 training backward, where the one-shot semantics themselves
# (ds rounded to bf16) differ from f32 by more than K2_BAR, each K2 output
# may be at most K2_INPLACE_FACTOR times as far from the f32 backward as
# the plain version's is, and each bf16 attention-projection gradient of
# the kernel path BF16_GRAD_FACTOR times as far from the f32 plain path's
# as the bf16 plain path's is; an error below the floor (K2_BAR,
# BF16_GRAD_FLOOR) passes either way (see kernel_vs_plain_training).
K2_INPLACE_FACTOR, BF16_GRAD_FACTOR, BF16_GRAD_FLOOR = 1.25, 1.5, E2E_BAR
# The YUV path against the RGB decode (JAX tests/test_native.py's bar).
YUV_MEAN_BAR, YUV_P99_BAR = 3.0, 12.0
ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_CONFIG = os.path.join(ROOT, "big_vision_torch", "configs",
                            "vit_b16_synthetic.py")
TRAIN_STEPS, TRAIN_LOG, FIXED_STEPS = 20, 5, 10
TRAIN_B, TRAIN_T, TRAIN_H, TRAIN_D = 256, 196, 12, 64  # B/16 at 224px
TRAIN_DEPTH = 12
# An end-to-end training step more than this share slower than the step on
# a fixed batch, without the input pipeline, is reported as bound by the
# host: by waiting for batches (the input stall) or by the input threads
# slowing the thread that dispatches the step.
HOST_BOUND_SHARE = 0.10
# Examples timed for the host decode rate, after as many to warm up (which
# encode the config's 512 unique JPEGs).
DECODE_RATE_N = 2048
FLEXI_CONFIG = os.path.join(ROOT, "big_vision_torch", "configs", "proj",
                            "flexivit", "i21k_sup.py")
FLEXI_B, FLEXI_T = 32, (1601, 901)  # FlexiViT-B at 240px, seqhw 40 and 30
# The trainer's own loop draws seqhw 15, 15, 15, 40, 30 at steps 1-5.
FLEXI_STEPS, FLEXI_CYCLE, FLEXI_CHECK_B = 5, (40, 30, 15) * 2, 8
# Fixed-batch steps at seqhw 40 of the FlexiViT phase (the distillation
# phase runs FIXED_STEPS): each is 1.3 s, and the loss falls at every one.
FLEXI_FIXED_STEPS = 4
# Examples in each eval split of the FlexiViT phase (test_05 ... test_30,
# and the few-shot probe's training and test splits on the 37-class pets
# stand-in: at least 25 images of every class), in batches of FLEXI_B.
FLEXI_NEVAL, FLEXI_FEWSHOT = 960, "pets"
DEIT3_CONFIG = os.path.join(ROOT, "big_vision_torch", "configs", "proj",
                            "flexivit", "i1k_deit3_distill.py")
# Steps of the DeiT-III distillation's own loop (its draws: seqhw 15, 15,
# 15), and examples in each of its minival splits.
DEIT3_STEPS, DEIT3_NEVAL = 3, 256
SMOKE_DISTILL_CONFIG = os.path.join(ROOT, "big_vision_torch", "configs",
                                    "proj", "distill", "smoke.py")
# Phase 9, the ImageNet recipes: each config through `train.main` at its
# full width and its own (per-card) batch, with the args given.
RECIPE_DIR = os.path.join(ROOT, "big_vision_torch", "configs")
RECIPES = [
    dict(name="vit_s16_i1k", what="ViT-S/16, 224px, randaug(2,10)",
         config=os.path.join(RECIPE_DIR, "vit_s16_i1k.py"), args="neval=256,",
         model="vit", batch=1024, randaug=True),
    dict(name="vit_i1k", what="AugReg ViT-B/16 medium2, randaug(2,15)",
         config=os.path.join(RECIPE_DIR, "vit_i1k.py"), args="neval=64,",
         model="vit", batch=256, randaug=True),
    dict(name="mlp_mixer_i1k", what="Mixer-B/16, randaug(2,15)",
         config=os.path.join(RECIPE_DIR, "mlp_mixer_i1k.py"),
         args="neval=64,", model="mlp_mixer", batch=512, randaug=True),
    dict(name="transfer", what="ViT-S/16 at 384px from an .npz, cifar10",
         config=os.path.join(RECIPE_DIR, "transfer.py"),
         args="model=vit-s16,init={init},neval=64,", model="vit", batch=256,
         randaug=False),
    # These two also try an update at twice their batch (`headroom`); GSAM
    # takes two forwards and backwards a step (`passes`), through its own
    # trainer's command line (`trainer`).
    dict(name="vit_i21k", what="AugReg ViT-B/16 i21k light2, randaug(2,10)",
         config=os.path.join(RECIPE_DIR, "vit_i21k.py"),
         args="neval=64,fewshot=none,", model="vit", batch=256,
         randaug=True, headroom=True),
    dict(name="vit_i1k_gsam_no_aug", what="ViT-B/32 under GSAM",
         config=os.path.join(RECIPE_DIR, "proj", "gsam",
                             "vit_i1k_gsam_no_aug.py"),
         args="neval=64,fewshot=none,", model="vit", batch=1024,
         randaug=False, passes=2, headroom=True,
         trainer="big_vision_torch.trainers.proj.gsam.gsam"),
]
# Loop steps, fixed-batch steps, unseen images of the kernel-vs-plain
# check, steps of each other optimizer, images of the RandAugment op check.
RECIPE_STEPS, RECIPE_FIXED_STEPS, RECIPE_CHECK_B = 4, 3, 64
RECIPE_OPT_STEPS, RECIPE_OP_N = 3, 32
# The quality phase: configs/quality_digits.py at its own size, and the
# dynamics twin at tools/dynamics_twin.py's defaults, held to its bar.
QUALITY_CONFIG = os.path.join(RECIPE_DIR, "quality_digits.py")
TWIN_CONFIG = os.path.join(RECIPE_DIR, "twin_dynamics.py")
QUALITY_PARTS_STEPS = 20  # fixed-batch steps and input batches timed
TWIN_STEPS, TWIN_BATCH, TWIN_WIDTH, TWIN_DEPTH = 200, 64, 128, 2
TWIN_BAR = 1e-3
# The share of pixels that may differ between the card and the CPU for
# the two ops whose arithmetic could round differently there.
RANDAUG_OP_SHARE = 1e-3
BLOCKED_BAR = {torch.bfloat16: 1e-2, torch.float32: F32_BAR}
# K1's and K2's f32 cases at the head dims of the quality phase's models:
# quality_digits (B=256, 6 heads of D=16 at T=64) and the dynamics twin
# (B=64, 4 heads of D=32 at T=64).
SMALL_D = [("digits D=16 f32", dict(b=256, tq=64, h=6, d=16)),
           ("twin D=32 f32", dict(b=64, tq=64, h=4, d=32))]
K2_BARS = {torch.bfloat16: K2_BAR, torch.float32: F32_BAR}
# K1's and K2's f32 cases on the PaliGemma training path at its batch
# (cococap's PG_B): the LLM's 8 heads of D=256 at T = 256 + 33 with the
# prefix-LM segment ids, and the So400m/14 tower's 16 heads of D=72.
PG_B = 64
PALIGEMMA_CASES = [
    ("PaliGemma LLM T=289 D=256 seg f32",
     dict(b=PG_B, tq=IMG_TOKENS + 33, h=8, d=256, dtype=torch.float32),
     dict(prefix_lm=True)),
    ("So400m/14 f32", dict(b=PG_B, tq=IMG_TOKENS, h=16, d=72,
                           dtype=torch.float32), {}),
]
# Phase 11, LiT: siglip_lit_coco (a frozen ViT-B/16 at 224px with `tok`
# pooling, T = 197, and BERT-base at 16 tokens) through the SigLIP trainer:
# loop steps (a checkpoint and the retrieval eval at the last), fixed-batch
# steps, images of the retrieval eval's val split (five captions each), the
# config's batch, and the images of each eval split of eval_only on vit_i1k.
SIGLIP_CONFIG = os.path.join(ROOT, "big_vision_torch", "configs", "proj",
                             "image_text", "siglip_lit_coco.py")
LOAD_AND_EVAL = os.path.join(ROOT, "big_vision_torch", "configs",
                             "load_and_eval.py")
SIGLIP_STEPS, SIGLIP_FIXED_STEPS, SIGLIP_NEVAL, SIGLIP_B = 10, 3, 256, 256
EVAL_ONLY_NEVAL = 512
# GSAM's gradient on the kernel path against the plain path, its l2
# distance over its l2 norm: the second pass starts from weights moved by
# the first pass's gradient, so the f32 kernels' differences pass through
# both (the dynamics twin's bar).
GSAM_BAR = 1e-3
# Phase 12, PaliGemma fine-tuning: cococap through the PaliGemma trainer
# (its batch PG_B), loop steps of each path, stand-in images of each eval
# split at step 0, unseen examples of the flash-vs-einsum check and of the
# in-place kernel check.
PALIGEMMA_CONFIG = os.path.join(ROOT, "big_vision_torch", "configs", "proj",
                                "paligemma", "transfers", "cococap.py")
PG_STEPS, PG_NEVAL, PG_CHECK_B, PG_INPLACE_B = 2, 8, 8, 4
# Phase 14, image-text: CapPa pre-training through the generative trainer
# (its batch CAPPA_B; loop steps; stand-in images of the perplexity eval
# and of the scoring classifier at step 0; fixed-batch steps; unseen
# examples of the kernel-vs-plain check), CLIPPO through the SigLIP trainer
# (its batch CLIPPO_B; loop steps; images of its retrieval eval), and the
# discriminative classifier on LiT through eval_only (stand-in ImageNet
# images; images of the config's retrieval eval beside it).
CAPPA_CONFIG = os.path.join(ROOT, "big_vision_torch", "configs", "proj",
                            "cappa", "pretrain.py")
CLIPPO_CONFIG = os.path.join(ROOT, "big_vision_torch", "configs", "proj",
                             "clippo", "train_clippo.py")
CAPPA_B, CAPPA_STEPS, CAPPA_NEVAL, CAPPA_SCORING = 256, 3, 8, 8
FIXED_UPDATES, CAPPA_CHECK_B = 3, 64
CLIPPO_B, CLIPPO_STEPS, CLIPPO_NEVAL = 256, 3, 16
ZEROSHOT_N, ZEROSHOT_RETRIEVAL = 64, 16
# Phase 15 (NaFlex B/16 through the SigLIP trainer): its token budget, the
# COCO stand-in's JPEG sides (px), the batch (half of siglip_lit_coco's:
# the host's NaFlex pp sets the step), loop steps, the shuffle buffer; the
# kernel path against attn=xla: loss and zimg, and gradients.
NAFLEX_SEQ, NAFLEX_SIDES, NAFLEX_B, NAFLEX_STEPS = 256, (96, 512), 128, 3
NAFLEX_SHUFFLE = 4096
NAFLEX_BAR, NAFLEX_GRAD_BAR = 1e-5, 1e-4
# Phase 16: Jet imagenet64 at full width and depth (its batch cut from the
# config's 1024 for the script's time: a step is about 4.6e11 FLOP an
# image, 3.2 s at 256), loop steps, eval images, the images of the
# auto-vs-xla check;
# JetFormer-350M (the config's BATCH), its eval images and samples.
JET_CONFIG = os.path.join(ROOT, "big_vision_torch", "configs", "proj",
                          "jet", "imagenet64.py")
JET_B, JET_STEPS, JET_NEVAL, JET_CHECK_B = 128, 3, 256, 64
JET_BAR, JET_GRAD_BAR, JET_ROUNDTRIP = 1e-5, 1e-4, 1e-4
JF_CONFIG = os.path.join(ROOT, "big_vision_torch", "configs", "proj",
                         "jetformer", "jetformer_imagenet2012.py")
JF_B, JF_STEPS, JF_NEVAL, JF_CHECK_B, JF_SAMPLES = 32, 3, 32, 16, 4
JF_BAR = 1e-5
# Phase 17, BiT (no kernel of the port on its path: convolutions on cuDNN
# in IEEE f32): R50x1 of both flavours on the card against the CPU at
# BIT_PARITY_B images of 224px within BIT_BAR; the configs through their
# trainers at full width and their per-card batch (`batch`, the configs'
# BATCH), BIT_STEPS loop steps alone (--bit) and BIT_FULL_STEPS in the full
# script; BIT_NEVAL examples an eval split; the distillation's CKA eval
# on BIT_CKA_N images in batches of BIT_CKA_B (no padded batch).
BIT_PARITY_B, BIT_BAR = 8, 1e-4
BIT_RECIPES = [
    dict(name="bit_i1k", what="BiT-R50x1 (bit), 224px",
         config=os.path.join(RECIPE_DIR, "bit_i1k.py"), args="neval={n},",
         model="bit", batch=256, randaug=False, res=224),
    dict(name="bit_i21k", what="BiT-R50x1 (bit_paper), 21843 classes",
         config=os.path.join(RECIPE_DIR, "bit_i21k.py"),
         args="neval={n},fewshot=none,", model="bit_paper", batch=512,
         randaug=False, res=224),
    dict(name="transfer_bit_m", what="BiT-M-R50x1 at 384px, cifar10",
         config=os.path.join(RECIPE_DIR, "transfer.py"),
         args="model=bit-m-r50x1,init={init},neval={n},",
         model="bit_paper", batch=128, randaug=False, res=384),
]
BIT_DISTILL_CONFIG = os.path.join(RECIPE_DIR, "proj", "distill",
                                  "bit_i1k.py")
BIT_DISTILL_B = 512
BIT_STEPS, BIT_FULL_STEPS, BIT_NEVAL, BIT_CKA_N, BIT_CKA_B = 4, 2, 64, 64, 32
# Substrings of the device kernels that compute convolutions (cuDNN's).
CONV_KERNELS = ("conv", "fprop", "dgrad", "wgrad", "implicit", "cudnn",
                "xmma")
DISTILL_CONFIG = os.path.join(ROOT, "big_vision_torch", "configs", "proj",
                              "flexivit", "i21k_distill.py")
# The distill trainer's loop draws the FlexiViT trainer's seqhw (15, 15, 15,
# 40, 30 at steps 1-5) and checkpoints at its last step.
DISTILL_STEPS = 5
TEACHER_HEAD_STD = 0.02  # logits of std ~0.5 over 21843 classes
FLOPS_PER_IMG_TRAIN = 3 * 35.2e9  # bench.py:31-32: 3x the forward's FLOPs


# Each kernel's launch counter: an attribute of its wrapper. K1's and K2's
# wrappers run two kernels each, by dtype: "K1" and "K2" are their bf16
# tensor-core kernels (`tc_launches`), "K1f" and "K2f" their f32 ones on
# 3xTF32 products (the rest of `launches`).
TC_SPLIT = {"K1": "K1f", "K2": "K2f"}
COUNTERS = {"K1": "flash_attention_forward",
            "K1f": "flash_attention_forward", "K2": "flash_attention_bwd",
            "K2f": "flash_attention_bwd",
            "K3": "flash_attention_blocked_forward",
            "K4a": "flash_attention_blocked_dq",
            "K4b": "flash_attention_blocked_dkv",
            "K5": "flash_attention_blocked_bwd_fused"}


def reset_launches(fa):
  for wrapper in set(COUNTERS.values()):
    getattr(fa, wrapper).launches = 0
  for tc in TC_SPLIT:
    getattr(fa, COUNTERS[tc]).tc_launches = 0


def launches(fa):
  counts = {k: getattr(fa, wrapper).launches
            for k, wrapper in COUNTERS.items()}
  for tc, f32 in TC_SPLIT.items():
    counts[tc] = getattr(fa, COUNTERS[tc]).tc_launches
    counts[f32] -= counts[tc]
  return counts


def rel_err(got, want):
  got, want = got.float(), want.float()
  return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


# ----------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ----------------------------------------------------------------------------


def seg_ids(q):
  """[B, T] segment ids for B >= 3: row 0 two segments, row 1 segments of 7
  with its last 20 slots padding (seg=0), row 2 all padding."""
  b, t = q.shape[:2]
  seg = torch.zeros((b, t), dtype=torch.int32, device="cuda")
  seg[0] = 1 + (torch.arange(t, device="cuda") >= t // 3).int()
  seg[1, : t - 20] = 1 + torch.arange(t - 20, device="cuda") // 7
  return seg


def prefix_lm_seg(q, n_prefix=IMG_TOKENS + 3):
  """[B, T] segment ids of the PaliGemma trainer's prefix-LM batches (no
  input mask, so no zeros): 1 over the image tokens and the prompt (its
  length varying by row, from `n_prefix`), then one segment per suffix
  token, padding included (`mask_ar` pads with 1)."""
  b, t = q.shape[:2]
  pos = torch.arange(t, device=q.device)[None, :]
  prefix = n_prefix + torch.arange(b, device=q.device)[:, None] % 5
  return torch.where(pos < prefix, 1, 2 + pos - prefix).int()


def check_k1(fa):
  """bf16 cases run the tensor-core kernel (bar K1_BAR), f32 ones the f32
  kernel (bar F32_BAR, for o and for the row LSE that K2's f32 kernel
  takes: its semantics are f32, only the order of sums differs), at
  FlexiViT-B's seqhw 5, 15 and 24, causal, seg with an all-padding row
  (o exact zeros, LSE exactly -1e30), Tq != Tkv and D = 18, 72, 128, 256;
  returns (max abs, max rel error) at the B/16 training shape."""
  cases = [
      ("B/16 B=256", dict(b=TRAIN_B, tq=TRAIN_T, h=TRAIN_H, d=TRAIN_D), {}),
      ("So400m/14 B=8", dict(b=8, tq=256, h=16, d=72), {}),
      ("So400m/14 f32", dict(b=8, tq=256, h=16, d=72, dtype=torch.float32),
       {}),
      ("B/16 B=8", dict(b=8, tq=196, h=12, d=64), {}),
      ("D=256 T=288", dict(b=2, tq=288, h=8, d=256), {}),
      ("causal", dict(b=2, tq=200, h=4, d=64), dict(causal=True)),
      ("seg", dict(b=3, tq=150, h=4, d=72), dict(seg=True)),
      ("Tq!=Tkv", dict(b=2, tq=100, h=4, d=64, tkv=300), {}),
      ("Tq!=Tkv causal", dict(b=2, tq=100, h=4, d=128, tkv=300),
       dict(causal=True)),
      # D % 8 != 0: the tensor-core kernel's element loads, no cp.async.
      ("D=20", dict(b=2, tq=130, h=3, d=20), {}),
  ]
  # f32 (K1's f32 kernel, bar F32_BAR): the grid of K2's f32 kernel.
  f32 = torch.float32
  cases += [(f"FlexiViT seqhw {s} f32", dict(b=FLEXI_B, tq=s * s + 1,
                                              h=TRAIN_H, d=TRAIN_D, dtype=f32),
             {}) for s in (5, 15, 24)]
  cases += [(name, dict(shape, dtype=f32), {}) for name, shape in SMALL_D]
  cases += [("LiT B/16 tok T=197 f32", dict(b=64, tq=197, h=TRAIN_H,
                                            d=TRAIN_D, dtype=f32), {})]
  cases += PALIGEMMA_CASES
  cases += [
      ("causal f32", dict(b=2, tq=200, h=4, d=64, dtype=f32),
       dict(causal=True)),
      ("seg f32", dict(b=3, tq=150, h=4, d=72, dtype=f32), dict(seg=True)),
      ("Tq!=Tkv f32", dict(b=2, tq=100, h=4, d=64, tkv=300, dtype=f32), {}),
      ("Tq!=Tkv causal f32", dict(b=2, tq=300, h=4, d=64, tkv=100,
                                  dtype=f32), dict(causal=True)),
  ] + [(f"D={d} f32", dict(b=2, tq=t, h=4, d=d, dtype=f32), {})
       for d, t in ((18, 130), (72, 256), (128, 300), (256, 288))]
  path_err = None
  for i, (name, shape, opts) in enumerate(cases):
    q, k, v = k1_inputs(**shape, seed=60 + i)
    kw = {"causal": opts.get("causal", False)}
    if opts.get("seg"):
      kw["seg"] = seg_ids(q)  # row 2's output must be exact 0
    if opts.get("prefix_lm"):
      kw["seg"] = prefix_lm_seg(q)
    reset_launches(fa)
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    kernel = "K1" if q.dtype == torch.bfloat16 else "K1f"
    assert launches(fa)[kernel] == 1, (name, launches(fa))
    errs = {"o": rel_err(got, want)}
    bar = K1_BAR
    if q.dtype == f32:
      bar = F32_BAR
      # The forward alone, for its LSE; the same o (no atomics, a fixed
      # order of sums).
      o, lse = fa.flash_attention_forward(q, k, v, **kw)
      want_lse = fa.flash_attention_lse_reference(q, k, v, **kw)
      torch.cuda.synchronize()
      assert torch.equal(o, got), name
      visible = want_lse > fa.NEG_INF  # rows with at least one key
      assert torch.equal(lse[~visible], want_lse[~visible]), name
      errs["lse"] = rel_err(lse[visible], want_lse[visible])
      if opts.get("seg"):  # padding rows: o exact zeros, LSE exactly -1e30
        h = q.shape[2]
        assert (lse[2 * h:3 * h] == fa.NEG_INF).all().item(), name
        assert got[kw["seg"] == 0].abs().max().item() == 0.0, name
    print(f"K1 {name:16s} {tuple(q.shape)} kv {tuple(k.shape)} "
          f"{fa.fwd_kernel(q.dtype)} rel err "
          + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (bar {bar})")
    assert all(math.isfinite(e) and e <= bar for e in errs.values()), (
        name, errs)
    if opts.get("seg"):
      assert got[2].abs().max().item() == 0.0, "all-zero seg row not zero"
    if i == 0:
      path_err = (got.float() - want.float()).abs().max().item(), errs["o"]
  return path_err


def check_k2(fa):
  """bf16 cases run the tensor-core kernel (bar K2_BAR), f32 ones the f32
  kernel (bar F32_BAR), each of dq, dk and dv held to the bar; returns (max
  abs, max rel error over dq, dk, dv) at the B/16 shape."""
  cases = [
      ("B/16 B=256", dict(b=TRAIN_B, tq=TRAIN_T, h=TRAIN_H, d=TRAIN_D), {}),
      ("B/16 B=256 f32", dict(b=TRAIN_B, tq=TRAIN_T, h=TRAIN_H, d=TRAIN_D,
                              dtype=torch.float32), {}),
      ("B/16 near-equal v", dict(b=8, tq=TRAIN_T, h=TRAIN_H, d=TRAIN_D),
       dict(cancel=True)),
      ("So400m/14 B=8", dict(b=8, tq=256, h=16, d=72), {}),
      ("D=256 T=288", dict(b=2, tq=288, h=8, d=256), {}),
      ("causal", dict(b=2, tq=200, h=4, d=64), dict(causal=True)),
      ("seg", dict(b=3, tq=150, h=4, d=72), dict(seg=True)),
      ("Tq!=Tkv", dict(b=2, tq=100, h=4, d=64, tkv=300), {}),
      ("Tq!=Tkv causal", dict(b=2, tq=100, h=4, d=128, tkv=300),
       dict(causal=True)),
      # D % 8 != 0: the tensor-core kernel's element loads, no cp.async.
      ("D=20", dict(b=2, tq=130, h=3, d=20), {}),
  ]
  # f32 (K2's f32 kernel, bar F32_BAR): FlexiViT-B at seqhw 5, 15 and 24,
  # the edge cases, and the head dims the kernel pads.
  f32 = torch.float32
  cases += [(f"FlexiViT seqhw {s} f32", dict(b=FLEXI_B, tq=s * s + 1,
                                              h=TRAIN_H, d=TRAIN_D, dtype=f32),
             {}) for s in (5, 15, 24)]
  cases += [(name, dict(shape, dtype=f32), {}) for name, shape in SMALL_D]
  cases += [("LiT B/16 tok T=197 f32", dict(b=64, tq=197, h=TRAIN_H,
                                            d=TRAIN_D, dtype=f32), {})]
  cases += PALIGEMMA_CASES
  cases += [
      ("causal f32", dict(b=2, tq=200, h=4, d=64, dtype=f32),
       dict(causal=True)),
      ("seg f32", dict(b=3, tq=150, h=4, d=72, dtype=f32), dict(seg=True)),
      ("Tq!=Tkv f32", dict(b=2, tq=100, h=4, d=64, tkv=300, dtype=f32), {}),
      ("Tq!=Tkv causal f32", dict(b=2, tq=300, h=4, d=64, tkv=100,
                                  dtype=f32), dict(causal=True)),
  ] + [(f"D={d} f32", dict(b=2, tq=t, h=4, d=d, dtype=f32), {})
       for d, t in ((18, 130), (72, 256), (128, 300), (256, 288))]
  path_err = None
  for i, (name, shape, opts) in enumerate(cases):
    q, k, v = k1_inputs(**shape, seed=30 + i)
    g = torch.Generator(device="cuda").manual_seed(40 + i)
    do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    kw = {"causal": opts.get("causal", False)}
    if opts.get("seg"):
      kw["seg"] = seg_ids(q)
    if opts.get("prefix_lm"):
      kw["seg"] = prefix_lm_seg(q)
    if opts.get("cancel"):  # dp - delta cancels to 1% of dp, as in training
      v = (1 + 0.01 * v.float()).to(v.dtype)
    _, lse = fa.flash_attention_forward(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, lse, do, **kw)
    want = fa.flash_attention_bwd_reference(q, k, v, do, **kw)
    torch.cuda.synchronize()
    errs = [rel_err(x, y) for x, y in zip(got, want)]
    bar = K2_BARS[q.dtype]
    print(f"K2 {name:16s} {tuple(q.shape)} kv {tuple(k.shape)} "
          f"{fa.bwd_kernel(q.dtype)} rel err dq {errs[0]:.3e} dk "
          f"{errs[1]:.3e} dv {errs[2]:.3e} (bar {bar})")
    assert all(math.isfinite(e) and e <= bar for e in errs), (name, errs)
    if opts.get("seg"):
      dq, dk, dv = got
      assert dq[2].abs().max().item() == 0.0, "all-zero seg row: dq not 0"
      for x in (dk, dv):
        assert x[2].abs().max().item() == 0.0, "seg=0 keys: grad not 0"
        assert x[1, -20:].abs().max().item() == 0.0, "seg=0 keys"
    if i == 0:
      path_err = (max((x.float() - y.float()).abs().max().item()
                      for x, y in zip(got, want)), max(errs))
  return path_err


def blocked_cases():
  """[(name, shape, options)] of the blocked kernels' checks: the FlexiViT-B
  shapes first (seqhw 40 in f32 first of all), the parity grid, the edge
  cases."""
  f32 = torch.float32
  cases = [(f"FlexiViT T={t} {dt}", dict(b=FLEXI_B, t=t, h=TRAIN_H, d=TRAIN_D,
                                          dtype=getattr(torch, dt)), {})
           for t in FLEXI_T for dt in ("float32", "bfloat16")]
  # docs/flash_parity.md's grid in bf16; below T=1056 the blocked path is
  # chosen by passing block sizes, as the JAX package's callers do.
  cases += [(f"T={t} D={d}{' seg' if seg else ''}", dict(b=4, t=t, h=4, d=d),
             dict(seg=seg)) for t in (197, 577, 1056) for d in (64, 128)
            for seg in (False, True)]
  cases += [
      ("causal", dict(b=2, t=300, h=4, d=64, dtype=f32), dict(causal=True)),
      ("Tq!=Tkv", dict(b=2, t=100, h=4, d=64, tkv=300, dtype=f32), {}),
      ("Tq!=Tkv causal", dict(b=2, t=300, h=4, d=128, tkv=100, dtype=f32),
       dict(causal=True)),
      ("seg f32", dict(b=3, t=150, h=4, d=72, dtype=f32), dict(seg=True)),
      ("D=256 causal", dict(b=2, t=200, h=4, d=256), dict(causal=True)),
      ("D=18 f32", dict(b=2, t=130, h=3, d=18, dtype=f32), {}),
  ]
  return cases


def check_blocked(fa):
  """K3, K4a and K4b against their plain versions on the same inputs (K4a
  and K4b take K3's o and LSE); returns {kernel: (max abs, max rel error)}
  at the FlexiViT-B shape of seqhw 40 in f32, the main path's."""
  path_err = {}
  for i, (name, shape, opts) in enumerate(blocked_cases()):
    b, t, h, d = shape["b"], shape["t"], shape["h"], shape["d"]
    dtype = shape.get("dtype", torch.bfloat16)
    q, k, v, do = blocked_inputs(b, t, h, d, tkv=shape.get("tkv"),
                                 seed=80 + 2 * i, dtype=dtype)
    kw = {"causal": opts.get("causal", False)}
    if opts.get("seg"):
      kw["seg"] = seg_ids(q)  # row 2 is all padding: exact zeros
    # The public entry point takes the blocked path: K3 launched once.
    blocks = ({} if not fa.oneshot_fits(t, k.shape[1], d)
              else dict(block_q=128, block_kv=128))
    before = fa.flash_attention_blocked_forward.launches
    o_path = fa.flash_attention(q, k, v, **kw, **blocks)
    assert fa.flash_attention_blocked_forward.launches == before + 1, name
    o, lse = fa.flash_attention_blocked_forward(q, k, v, **kw)
    delta = fa.blocked_delta(o, do)
    got = {"o": o, "lse": lse,
           "dq": fa.flash_attention_blocked_dq(q, k, v, do, lse, delta, **kw)}
    got["dk"], got["dv"] = fa.flash_attention_blocked_dkv(q, k, v, do, lse,
                                                           delta, **kw)
    want = dict(zip(("o", "lse"), fa.flash_attention_blocked_reference(
        q, k, v, **kw)))
    want["dq"] = fa.flash_attention_blocked_dq_reference(q, k, v, do, lse,
                                                         delta, **kw)
    want["dk"], want["dv"] = fa.flash_attention_blocked_dkv_reference(
        q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o_path, o), name
    visible = want["lse"] > fa.NEG_INF  # rows with at least one key
    assert torch.equal(got["lse"][~visible], want["lse"][~visible]), name
    got["lse"], want["lse"] = got["lse"][visible], want["lse"][visible]
    bar = BLOCKED_BAR[dtype]
    assert all(want[n].abs().max().item() > 0 for n in want), name
    errs = {n: rel_err(got[n], want[n]) for n in got}
    print(f"K3/K4 {name:16s} {tuple(q.shape)} kv {tuple(k.shape)} rel err " +
          " ".join(f"{n} {e:.3e}" for n, e in errs.items()) + f" (bar {bar})")
    assert all(math.isfinite(e) and e <= bar for e in errs.values()), (
        name, errs)
    if opts.get("seg"):
      zero = kw["seg"] == 0  # [B, T]: padding rows and keys
      for n in ("o", "dq", "dk", "dv"):
        assert got[n][zero].abs().max().item() == 0.0, (name, n)
    if i == 0:
      for kern, names in (("K3", ("o",)), ("K4a", ("dq",)),
                          ("K4b", ("dk", "dv"))):
        path_err[kern] = (max((got[n].float() - want[n].float()).abs().max()
                              .item() for n in names),
                          max(errs[n] for n in names))
  return path_err


@contextlib.contextmanager
def fused_blocked_bwd(fa):
  """The blocked backward is K5 (where `fused_bwd_fits` holds) inside."""
  old, fa.FUSED_BLOCKED_BWD = fa.FUSED_BLOCKED_BWD, True
  try:
    yield
  finally:
    fa.FUSED_BLOCKED_BWD = old


def check_fused(fa):
  """K5 against its plain version on the cases of `check_blocked` (on K3's
  o and LSE), against K4a + K4b in f32, and through the public
  `flash_attention`'s backward with `FUSED_BLOCKED_BWD` set; returns (max
  abs, max rel error) at the FlexiViT-B shape of seqhw 40 in f32."""
  path_err = None
  for i, (name, shape, opts) in enumerate(blocked_cases()):
    b, t, h, d = shape["b"], shape["t"], shape["h"], shape["d"]
    dtype = shape.get("dtype", torch.bfloat16)
    q, k, v, do = blocked_inputs(b, t, h, d, tkv=shape.get("tkv"),
                                 seed=180 + 2 * i, dtype=dtype)
    kw = {"causal": opts.get("causal", False)}
    if opts.get("seg"):
      kw["seg"] = seg_ids(q)  # row 2 is all padding: exact zeros
    blocks = ({} if not fa.oneshot_fits(t, k.shape[1], d)
              else dict(block_q=128, block_kv=128))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = fa.flash_attention_blocked_bwd_fused.launches
    with fused_blocked_bwd(fa):
      fa.flash_attention(*leaves, **kw, **blocks).backward(do)
    assert fa.flash_attention_blocked_bwd_fused.launches == before + 1, name
    o, lse = fa.flash_attention_blocked_forward(q, k, v, **kw)
    got = fa.flash_attention_blocked_bwd_fused(q, k, v, o, lse, do, **kw)
    want = fa.flash_attention_blocked_bwd_fused_reference(q, k, v, o, lse, do,
                                                          **kw)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv")
    for n, x, leaf in zip(names, got, leaves):
      assert torch.equal(x, leaf.grad), (name, n)
    bar = BLOCKED_BAR[dtype]
    assert all(w.abs().max().item() > 0 for w in want), name
    errs = [rel_err(x, y) for x, y in zip(got, want)]
    line = " ".join(f"{n} {e:.3e}" for n, e in zip(names, errs))
    if dtype == torch.float32:
      delta = fa.blocked_delta(o, do)
      two = (fa.flash_attention_blocked_dq(q, k, v, do, lse, delta, **kw),
             *fa.flash_attention_blocked_dkv(q, k, v, do, lse, delta, **kw))
      two_errs = [rel_err(x, y) for x, y in zip(got, two)]
      line += "; vs K4a+K4b " + " ".join(
          f"{n} {e:.3e}" for n, e in zip(names, two_errs))
      assert all(math.isfinite(e) and e <= bar for e in two_errs), (
          name, two_errs)
    print(f"K5 {name:16s} {tuple(q.shape)} kv {tuple(k.shape)} rel err "
          f"{line} (bar {bar})")
    assert all(math.isfinite(e) and e <= bar for e in errs), (name, errs)
    if opts.get("seg"):
      zero = kw["seg"] == 0  # [B, T]: padding rows and keys
      for n, x in zip(names, got):
        assert x[zero].abs().max().item() == 0.0, (name, n)
    if i == 0:
      path_err = (max((x.float() - y.float()).abs().max().item()
                      for x, y in zip(got, want)), max(errs))
  return path_err


def check_k6(da):
  """Holds K6 against its plain version in every case below, each launch
  repeated and asserted bit-equal, every example with no visible slot
  exact zeros; returns (max abs, max rel error) at the serving shape with
  a bf16 and with an int8 cache."""
  serving = dict(b=8, kh=1, g=8, s=CACHE, h=256)
  # Live spans of the serving shape's 22 splits of 16 slots: ending
  # mid-split, leading and trailing splits wholly masked, one slot, none.
  spans = [(0, CACHE), (0, CACHE - 9), (3, 300), (40, 291), (96, 200),
           (17, 18), (CACHE - 16, CACHE), (0, 0)]
  cases = [
      ("gemma_2b B=8", serving, {}),
      ("int8", dict(serving, cache="int8"), {}),
      ("int8 softcap", dict(serving, cache="int8"), dict(logits_softcap=50.0)),
      ("spans", dict(serving, spans=spans), {}),
      ("spans int8", dict(serving, cache="int8", spans=spans), {}),
      ("q bf16", dict(serving, q_dtype=torch.bfloat16), {}),
      ("S=10 < a split", dict(serving, s=10), {}),
      ("S=1", dict(serving, s=1), {}),
      ("S=353", dict(serving, s=353), {}),
      ("H=72", dict(serving, h=72), {}),
      ("H=72 int8", dict(serving, h=72, cache="int8"), {}),
      ("H=20 f32", dict(b=4, kh=2, g=4, s=100, h=20, cache="f32"), {}),
      ("K=4 G=2", dict(b=4, kh=4, g=2, s=300, h=128), {}),
      ("K=2 G=3", dict(b=3, kh=2, g=3, s=129, h=64), {}),
      ("K=2 G=3 f32", dict(b=3, kh=2, g=3, s=129, h=64, cache="f32"), {}),
      ("int8 softcap K=4", dict(b=4, kh=4, g=2, s=200, h=128, cache="int8"),
       dict(logits_softcap=0.5)),
      ("masked row", dict(b=3, kh=1, g=8, s=96, h=256, masked_row=True), {}),
      ("2 tiles a split", dict(b=2, kh=1, g=8, s=5000, h=64,
                               spans=[(100, 4321), (4200, 4262)]), {}),
      ("B=16 S=304", dict(serving, b=16, s=BEAM_CACHE), {}),
      ("B=16 S=304 int8", dict(serving, b=16, s=BEAM_CACHE, cache="int8"),
       {}),
      ("B=64 S=352", dict(serving, b=64), {}),
      ("B=64 S=1120", dict(serving, b=64, s=1120), {}),
      ("B=64 S=1120 int8", dict(serving, b=64, s=1120, cache="int8"), {}),
      ("B=64 S=1120 f32", dict(serving, b=64, s=1120, cache="f32"), {}),
      ("B=64 S=1121", dict(serving, b=64, s=1121), {}),
      ("B=32 S=1121 H=72 int8", dict(serving, b=32, s=1121, h=72,
                                     cache="int8"),
       dict(logits_softcap=50.0)),
  ]
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  errs = {"gemma_2b B=8": None, "int8": None}
  for i, (name, shape, opts) in enumerate(cases):
    q, k, v, mask, scales = k6_inputs(**shape, seed=i)
    got = da.decode_attention(q, k, v, mask, **scales, **opts)
    again = da.decode_attention(q, k, v, mask, **scales, **opts)
    want = da.decode_attention_reference(q, k, v, mask, **scales, **opts)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    grid = da.plan(q.shape[0] * q.shape[1], k.shape[2], sms)
    print(f"K6 {name:18s} q {tuple(q.shape)} {q.dtype} cache "
          f"{tuple(k.shape)} {k.dtype} grid {grid} rel err {err:.3e} "
          f"(bar {K6_BAR})")
    assert math.isfinite(err) and err <= K6_BAR, (name, err)
    assert torch.equal(got, again), f"{name}: a repeat launch differs"
    empty = ~mask.any(dim=1)
    assert (got[empty] == 0).all(), f"{name}: a row with no visible slot"
    if name in errs:
      errs[name] = (got.float() - want.float()).abs().max().item(), err
  return errs["gemma_2b B=8"], errs["int8"]


def smooth_jpeg():
  """The smooth 256x320 image of the JAX package's YUV test
  (tests/test_native.py), as JPEG bytes of quality 95."""
  import numpy as np
  from PIL import Image
  base = np.random.RandomState(0).randint(0, 255, (8, 10, 3), np.uint8)
  img = Image.fromarray(base).resize((320, 256), Image.BILINEAR)
  buf = io.BytesIO()
  img.save(buf, format="JPEG", quality=95)
  return buf.getvalue()


def check_native(gpu):
  """The JPEG decoder built from big_vision_torch/native: its full decode
  bit-equal to PIL's (which decodes with the same bundled libjpeg), and the
  YUV path (planes cropped on the host, RGB made on the card) against the
  RGB decode of a smooth image within the JAX package's bar: mean |diff|
  under YUV_MEAN_BAR, 99th percentile under YUV_P99_BAR."""
  import numpy as np
  from PIL import Image
  from big_vision_torch import input_pipeline
  from big_vision_torch import native
  from big_vision_torch.datasets import synthetic
  from big_vision_torch.pp import builder
  print(f"JPEG decoder: {native.linked_library()}")
  source = synthetic.DataSource(n=8, h=256, w=320, unique_images=8)
  images = [ex["image"] for ex in source.get_examples(ordered=True)]
  images.append(smooth_jpeg())
  for raw in images:
    want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
    got = native.decode_crop_resize(raw)
    assert got.shape == want.shape and (got == want).all(), "decode != PIL"
  print(f"full decode bit-equal to PIL {Image.__version__} on "
        f"{len(images)} JPEGs of 256x320")
  box = "area_min=100, area_max=100, ratio_min=1.0, ratio_max=1.0"
  yuv = builder.get_preprocess_fn(
      f"decode_jpeg_and_inception_crop_yuv(128, {box})|yuv420_to_rgb")
  ex = yuv.host({"image": images[-1]}, np.random.default_rng(3))
  batch = {k: torch.from_numpy(v[None]).cuda() for k, v in ex.items()}
  got = yuv.device(batch, input_pipeline.step_generator(0, 0, "cuda"))
  got = got["image"][0].cpu().numpy()
  want = builder.get_preprocess_fn(
      f"decode_jpeg_and_inception_crop(128, {box})").host(
          {"image": images[-1]}, np.random.default_rng(3))["image"]
  diff = np.abs(got - want.astype(np.float32))
  mean, p99 = float(diff.mean()), float(np.percentile(diff, 99))
  print(f"[{gpu}] YUV path (yuv420_to_rgb on the card) vs RGB decode, "
        f"smooth 256x320 JPEG at 128px: mean |diff| {mean:.4f} (bar "
        f"{YUV_MEAN_BAR}), 99th percentile {p99:.4f} (bar {YUV_P99_BAR})")
  assert got.shape == want.shape == (128, 128, 3)
  assert mean < YUV_MEAN_BAR and p99 < YUV_P99_BAR, (mean, p99)


def host_decode_rate(gpu):
  """Images per second of the ViT config's host pp phase
  (decode_jpeg_and_inception_crop_yuv(224)) over its synthetic source, on
  the input pipeline's thread map with the config's threads, and on one
  thread."""
  from big_vision_torch import input_pipeline
  from big_vision_torch import train
  from big_vision_torch.datasets import core
  from big_vision_torch.pp import builder
  cfg = train.load_config(TRAIN_CONFIG)["input"]
  pfn = builder.get_preprocess_fn(cfg["pp"])
  assert [op.name for op in pfn.host_ops] == [
      "decode_jpeg_and_inception_crop_yuv(224)"], pfn.host_ops
  source = core.get(**cfg["data"])
  pp_threaded = input_pipeline._pp_threaded  # pylint: disable=protected-access
  rates = {}
  for threads in (cfg["num_threads"], 1):
    n = DECODE_RATE_N if threads > 1 else DECODE_RATE_N // 8
    for _ in range(2):  # the first pass warms up, the second is timed
      examples = (ex for _, ex in zip(range(n), source.get_examples(
          ordered=True)))
      t0 = time.perf_counter()
      count = sum(1 for _ in pp_threaded(examples, pfn, threads, seed=0))
      rates[threads] = count / (time.perf_counter() - t0)
  print(f"[{gpu}] host decode rate of {pfn.specs[0]} over the config's "
        f"synthetic JPEGs (256x320, quality 90): "
        f"{rates[cfg['num_threads']]:.1f} img/s on {cfg['num_threads']} "
        f"threads, {rates[1]:.1f} img/s on 1; os.cpu_count() = "
        f"{os.cpu_count()}")
  return rates


# ----------------------------------------------------------------------------
# Phase 3: serving.
# ----------------------------------------------------------------------------


def serve(model, plain, batch, fa, da, decode=DECODE, what="serving"):
  """The main path with its launch counts, then kernel vs plain path."""
  from big_vision_torch.models.proj.paligemma import predict_fns
  fns = predict_fns.make_predict_fns(model, max_decode_len=decode,
                                     eos_token=-1)
  reset_launches(fa)
  da.decode_attention.launches = 0
  tokens, logp = fns["decode_with_logp"](batch)
  torch.cuda.synchronize()
  k1 = launches(fa)
  counts = {"K1": k1["K1"], "K6": da.decode_attention.launches}
  depth_img = len(model.img.encoder.blocks)
  depth_llm = len(model.llm.model.layers)
  attn = model.llm.model.layers[0].attn
  b = batch["text"].shape[0]
  # K6 where the JAX package's gate holds at the cache the decode fills,
  # the einsum path past it.
  frames = batch["image"].shape[1] if batch["image"].dim() == 5 else 1
  slots = IMG_TOKENS * frames + batch["text"].shape[1] + decode
  itemsize = 1 if attn.cache_dtype == torch.int8 else 4
  fits = da.fits(slots, attn.head_dim, itemsize)
  print(f"{what}, {attn.cache_dtype} KV cache: {b} requests, {decode} "
        f"greedy tokens, {slots} cache slots (every AR step takes "
        f"{'K6' if fits else 'the einsum path: past fits'}); launches K1 "
        f"{counts['K1']} in bf16 (want {depth_img}), f32 K1 {k1['K1f']} "
        f"(want 0), K6 {counts['K6']} (want "
        f"{depth_llm if fits else 0} x {decode})")
  assert counts["K1"] == depth_img and k1["K1f"] == 0, k1
  assert counts["K6"] == (depth_llm if fits else 0) * decode, counts
  assert tokens.shape == (b, decode) and torch.isfinite(logp).all()

  # Kernel path vs plain path on the same card: prefill logits, then 4 AR
  # steps teacher-forced with the kernel path's tokens.
  errs, agree = [], []
  with torch.inference_mode():
    states = []
    for m in (model, plain):
      mask_input, mask_ar = batch["mask_input"], batch["mask_ar"]
      (x, full_mask, full_ar), _ = m.embed_image_and_text(
          batch["image"], batch["text"], input_mask=mask_input,
          mask_ar=mask_ar)
      states.append(m.prefill_cache(x, full_mask, full_ar,
                                    cache_size=x.shape[1] + 8))
    for step in range(5):
      (lk, ck), (lp, cp) = states
      errs.append(rel_err(lk, lp))
      agree.append((lk.argmax(-1) == lp.argmax(-1)).float().mean().item())
      if step == 4:
        break
      tok = tokens[:, step:step + 1]
      states = [m.extend_cache(m.embed_text(tok)[0], c)
                for m, c in ((model, ck), (plain, cp))]
  for i, (e, a) in enumerate(zip(errs, agree)):
    step = "prefill" if i == 0 else f"AR step {i}"
    print(f"kernel vs plain path, {step}: logits rel err {e:.3e} "
          f"(bar {E2E_BAR}), greedy agreement {a:.3f}")
    assert math.isfinite(e) and e <= E2E_BAR, (what, step, e)
  plain_tokens = predict_fns.make_predict_fns(
      plain, max_decode_len=decode, eos_token=-1)["decode"](batch)
  print(f"greedy tokens equal to the plain path's: "
        f"{(plain_tokens == tokens).float().mean().item():.3f}")
  return counts


def write_serving_ckpt(model, path):
  """PaliGemma-3B's weights as one `.npz` in the JAX layout, as the runner
  reads them: the image tower in bf16, the LLM in int8 with its scales
  (`gemma.quantize_params` on the card; the layout that
  `tools/quantize_ckpt.py --subtree llm` writes). Returns its GB."""
  from big_vision_torch.models.ppp import gemma
  from big_vision_torch.utils import checkpoints, convert, trees
  img = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in
         trees.flatten(convert.vit_params(model.img)).items()}
  llm = {k: v.cpu() for k, v in trees.flatten(gemma.quantize_params(
      convert.gemma_params(model.llm.model))).items()}
  checkpoints.npz_save({"img": img, "llm": llm}, path)
  return os.path.getsize(path) / 1e9


def load_int8_model(path, cache_dtype="bfloat16"):
  """PaliGemma-3B with int8 LLM weights from the `.npz` at `path`, through
  `paligemma.load` (the serving path's kernels on)."""
  from big_vision_torch.models.proj.paligemma import paligemma
  from big_vision_torch.utils import convert
  img = dict(variant="So400m/14", pool_type="none")
  llm = dict(variant="gemma_2b", quant=True)
  params = paligemma.load(None, path, dict(img=img, llm=llm))
  model = paligemma.Model(
      img=dict(img, dtype_mm="bfloat16", image_size=RES, attn_impl="auto"),
      llm=dict(llm, cache_dtype=cache_dtype, decode_impl="flash"),
      device="meta", param_dtype=torch.bfloat16)
  convert.load(model, convert.paligemma(params), device="cuda",
               dtype=torch.bfloat16)
  return model.eval()


def weight_conversions(model):
  """A fn doing one AR step's weight conversions alone: each LLM matmul
  weight made f32 as the step makes it (`_dequant` of an int8 weight, the
  cast of a bf16 one; the embedding table is cast, its int8 row scales
  applied after the product)."""
  from big_vision_torch.models.ppp import gemma
  llm = model.llm.model
  casts = [llm.embedder.input_embedding]
  dequants = []
  for mod in llm.layers.modules():
    for name in ("qkv", "q", "kv", "o", "gating", "linear"):
      w = getattr(mod, name, None)
      if not isinstance(w, torch.Tensor):
        continue
      scale = getattr(mod, f"{name}_scale", None)
      if scale is None:
        casts.append(w)
      else:
        dequants.append((w, scale))

  def convert_all():
    for w in casts:
      w.float()
    for w, scale in dequants:
      gemma._dequant(w, scale, torch.float32)  # pylint: disable=protected-access

  def copy_then_scale():  # a yardstick: the same values in two kernels
    for w in casts:
      w.float()
    for w, scale in dequants:
      w.float().mul_(scale)
  return convert_all, copy_then_scale


def int8_weights_phase(model, batch, fa, da, gpu, path):
  """Phase 3b: PaliGemma-3B with int8 LLM weights, loaded from the `.npz`
  written from `model`, served with the bf16 and then the int8 KV cache,
  each against its plain path; its logits beside the bf16-weight model's,
  its times, and the weight conversions' share of its AR step."""
  from big_vision_torch.tools import bench_decode
  t0 = time.perf_counter()
  gb = write_serving_ckpt(model, path)
  t1 = time.perf_counter()
  int8w = load_int8_model(path)
  print(f"wrote PaliGemma-3B (LLM int8, tower bf16) as {gb:.3f} GB in "
        f"{t1 - t0:.1f} s; loaded it through paligemma.load in "
        f"{time.perf_counter() - t1:.1f} s")
  plain = bench_decode.build_model("gemma_2b", "So400m/14", RES,
                                   kernels=False, like=int8w)
  counts = {"K6 int8 weights": serve(int8w, plain, batch, fa, da,
                                     what="int8 weights")["K6"]}
  int8c = bench_decode.build_model("gemma_2b", "So400m/14", RES,
                                   cache_dtype="int8", like=int8w)
  int8c_plain = bench_decode.build_model(
      "gemma_2b", "So400m/14", RES, cache_dtype="int8", kernels=False,
      like=int8w)
  counts["K6 int8 weights, int8 cache"] = serve(
      int8c, int8c_plain, batch, fa, da, decode=INT8_DECODE,
      what="int8 weights")["K6"]
  del plain, int8c, int8c_plain
  # A report, not a kernel check: what int8 weights change in the logits.
  with torch.inference_mode():
    logits = [bench_decode._prefill_fn(m, batch, 8)()[0]  # pylint: disable=protected-access
              for m in (model, int8w)]
  print(f"int8-weight vs bf16-weight prefill logits: rel err "
        f"{rel_err(logits[1], logits[0]):.3e}, greedy agreement "
        f"{(logits[0].argmax(-1) == logits[1].argmax(-1)).float().mean():.3f}")
  # Times in turns: bf16 weights, int8, int8, bf16.
  for name, m in (("bf16 weights", model), ("int8 weights", int8w),
                  ("int8 weights", int8w), ("bf16 weights", model)):
    x = bench_decode.measure(m, batch, DECODE, 1, "cuda")
    print(f"[{gpu}] serving, {name}, B={BATCH} prompt {PROMPT} decode "
          f"{DECODE}: prefill {x['prefill_s'] * 1e3:.3f} ms, AR step "
          f"{x['step_s'] * 1e3:.3f} ms, {BATCH / x['step_s']:.1f} tok/s")
  convert = {}
  for name, m in (("bf16 weights", model), ("int8 weights", int8w)):
    convert[name], two_kernels = weight_conversions(m)
    print(f"[{gpu}] {name}: one AR step's weight conversions to f32 alone "
          f"{time_ms(convert[name], [()], iters=3):.3f} ms")
  print(f"[{gpu}] int8 weights, the same conversions as a copy to f32 then "
        f"an in-place scale (a yardstick, not the port's path): "
        f"{time_ms(two_kernels, [()], iters=3):.3f} ms")
  # One profiled decode: every kernel's device time, the top ten printed,
  # and the share of the kernels that the weight conversions alone launch.
  names = {k for k, _, _ in kernel_timing.device_profile(
      {"c": convert["int8 weights"]}, top=10 ** 6)["c"][0]}
  rows, busy, wall = kernel_timing.device_profile(
      {"decode": bench_decode._decode_fn(int8w, batch, DECODE)},  # pylint: disable=protected-access
      top=10 ** 6)["decode"]
  bench_decode.print_profile({"decode": (rows[:10], busy, wall)},
                             prefix=f"[{gpu}] int8 weights, ")
  dequant = [r for r in rows if r[0] in names]
  ms = sum(r[1] for r in dequant)
  print(f"[{gpu}] int8 weights, profiled decode of {DECODE} tokens: the "
        f"weight conversions' kernels ({len(dequant)} names, "
        f"{sum(r[2] for r in dequant)} launches) {ms:.3f} of {busy:.3f} ms "
        f"busy ({100 * ms / busy:.1f}%):")
  for k, kms, n in dequant[:4]:
    print(f"  {kms:10.3f} ms {n:6d}x  {k[:160]}")
  return counts


def counted_k6_rows(da):
  """Wraps K6's launch (`_launch`, behind the wrapper's checks) to record
  the cache rows (q.shape[0]) of every launch; returns (rows, undo)."""
  rows, launch = [], da._launch  # pylint: disable=protected-access

  def spy(q, *args):
    rows.append(q.shape[0])
    return launch(q, *args)
  da._launch = spy  # pylint: disable=protected-access
  return rows, lambda: setattr(da, "_launch", launch)


def beam_phase(model, plain, batch, fa, da, gpu):
  """Phase 3c: beam search (beam 2) and best-of-n (n 2, greedy) on the
  serving batch: B*2 cache rows at every K6 launch, one launch per layer
  per step, tokens beside the plain path's; beam 1 equal to greedy."""
  from big_vision_torch.models.proj.paligemma import predict_fns
  from big_vision_torch.tools import bench_decode
  depth_img = len(model.img.encoder.blocks)
  depth = len(model.llm.model.layers)
  fns = {m: predict_fns.make_predict_fns(m, max_decode_len=BEAM_DECODE,
                                         eos_token=-1)
         for m in (model, plain)}
  runs = (("beam 2", "beam_decode", dict(beam_size=2), BEAM_DECODE - 1),
          ("best-of-2", "decode", dict(best_of_n=2), BEAM_DECODE))
  counts = {}
  for name, fn, kw, steps in runs:
    fns[model][fn](batch, **kw)  # warm
    reset_launches(fa)
    wrapper = da.decode_attention
    wrapper.launches = 0
    rows, undo = counted_k6_rows(da)
    try:
      start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
      start.record()
      tokens = fns[model][fn](batch, **kw)
      end.record()
      end.synchronize()
    finally:
      undo()
    ms = start.elapsed_time(end)
    k1, k6 = launches(fa)["K1"], wrapper.launches
    rep = {k: v.repeat_interleave(kw.get("best_of_n", 1), 0)
           for k, v in batch.items()}
    prefill_ms = bench_decode.Timer("cuda")(
        bench_decode._prefill_fn(model, rep, BEAM_DECODE), 2) * 1e3  # pylint: disable=protected-access
    print(f"{name}: {BATCH} requests, {BEAM_DECODE} tokens, {steps} AR "
          f"steps on {set(rows)} cache rows; launches K1 {k1} (want "
          f"{depth_img}), K6 {k6} (want {depth} x {steps})")
    assert k1 == depth_img, k1
    assert k6 == depth * steps == len(rows), k6
    assert set(rows) == {2 * BATCH}, set(rows)
    plain_tokens = fns[plain][fn](batch, **kw)
    print(f"[{gpu}] {name}: {ms:.3f} ms for the request batch, of which "
          f"prefill {prefill_ms:.3f} ms ({len(rep['text'])} rows), "
          f"{(ms - prefill_ms) / steps:.3f} ms per AR step of {2 * BATCH} "
          f"rows; tokens equal to the plain path's: "
          f"{(plain_tokens == tokens).float().mean().item():.3f}")
    assert torch.equal(plain_tokens, tokens), name
    counts[f"K6 {name}"] = k6
  beam1 = fns[model]["beam_decode"](batch, beam_size=1)
  greedy = fns[model]["decode"](batch)
  print(f"beam 1 equal to greedy: {bool((beam1 == greedy).all())}")
  assert torch.equal(beam1, greedy)
  beam_reorder_vs_plain(model, plain, batch)
  return counts


def beam_reorder_vs_plain(model, plain, batch, k=2):
  """The kernel path on k rows an example as beam search runs it: prefill,
  the expansion, then BEAM_CHECK_STEPS teacher-forced AR steps, each after
  a parent reorder of the whole cache (`_gather_beams`, every row taking a
  random beam of its example). Held within E2E_BAR against the plain path
  recomputing each step's logits from scratch over the sequence each row
  holds by then: no cache and no reorder."""
  from big_vision_torch.models.proj.paligemma import predict_fns
  gather = predict_fns._gather_beams  # pylint: disable=protected-access
  b, dev = batch["text"].shape[0], batch["text"].device
  gen = torch.Generator(device="cpu").manual_seed(SEED)
  with torch.inference_mode():
    prefix = [m.embed_image_and_text(
        batch["image"], batch["text"], input_mask=batch["mask_input"],
        mask_ar=batch["mask_ar"])[0] for m in (model, plain)]
    x, mask, ar = prefix[0]
    _, cache = model.prefill_cache(x, mask, ar,
                                   cache_size=x.shape[1] + BEAM_DECODE)
    src = torch.arange(b, device=dev).repeat_interleave(k)  # prefix rows
    cache = gather(cache, src)
    hist = torch.zeros((b * k, 0), dtype=torch.long, device=dev)
    vocab = model.llm.model.embedder.input_embedding.shape[0]
    for step in range(BEAM_CHECK_STEPS):
      parent = (torch.arange(b).repeat_interleave(k) * k
                + torch.randint(k, (b * k,), generator=gen)).to(dev)
      cache, src, hist = gather(cache, parent), src[parent], hist[parent]
      tok = torch.randint(2, vocab, (b * k, 1), generator=gen).to(dev)
      hist = torch.cat([hist, tok], dim=1)
      got, cache = model.extend_cache(model.embed_text(tok)[0], cache)
      # Each row's live prefix, then its tokens, then padding: a prefill
      # reads the logits of its last live slot.
      px, pmask, par = (torch.cat([t[src], torch.zeros_like(
          t[src][:, :hist.shape[1]])], dim=1) for t in prefix[1])
      rows = torch.arange(b * k, device=dev)[:, None]
      slots = (prefix[1][1][src].sum(1, keepdim=True)
               + torch.arange(hist.shape[1], device=dev))
      px[rows, slots] = plain.embed_text(hist)[0]
      pmask[rows, slots], par[rows, slots] = True, 1
      want, _ = plain.prefill_cache(px, pmask, par, cache_size=px.shape[1])
      err = rel_err(got, want)
      moved = (parent != torch.arange(b * k, device=dev)).sum().item()
      print(f"beam rows vs plain recompute, AR step {step + 1} after a "
            f"reorder moving {moved} of {b * k} rows: logits rel err "
            f"{err:.3e} (bar {E2E_BAR}), greedy agreement "
            f"{(got.argmax(-1) == want.argmax(-1)).float().mean():.3f}")
      assert math.isfinite(err) and err <= E2E_BAR, (step, err)


def video_phase(model, plain, fa, da, gpu):
  """Phase 3d: VIDEO_B clips of VIDEO_FRAMES frames at 224px: one tower
  forward over all frames (27 K1 launches), their tokens joined along the
  sequence, VIDEO_DECODE greedy tokens; kernel vs plain path."""
  from big_vision_torch.tools import bench_decode
  batch = bench_decode.make_batch(VIDEO_B, RES, PROMPT, 256_000, "cuda",
                                  SEED)
  gen = torch.Generator(device="cuda").manual_seed(SEED)
  batch["image"] = torch.rand((VIDEO_B, VIDEO_FRAMES, RES, RES, 3),
                              generator=gen, device="cuda") * 2 - 1
  counts = serve(model, plain, batch, fa, da, decode=VIDEO_DECODE,
                 what=f"video, {VIDEO_FRAMES} frames a clip")
  x = bench_decode.measure(model, batch, VIDEO_DECODE, 2, "cuda")
  print(f"[{gpu}] video B={VIDEO_B} x {VIDEO_FRAMES} frames, prompt "
        f"{PROMPT}, decode {VIDEO_DECODE}: prefill "
        f"{x['prefill_s'] * 1e3:.3f} ms, AR step {x['step_s'] * 1e3:.3f} ms")
  return {"K1 video": counts["K1"], "K6 video": counts["K6"]}


class _Lines(io.StringIO):
  """stdout that notes when its first line was written."""
  first = None

  def write(self, text):
    if self.first is None and "\n" in text:
      self.first = time.perf_counter()
    return super().write(text)


def runner_phase(fa, da, gpu, path):
  """Phase 3e: the interactive runner (`trainers/proj/paligemma/run.py`)
  on the int8-weight checkpoint at `path`, a synthetic JPEG and two
  prompts on stdin, with a hand-written unigram vocab of 256000 pieces.
  Its answers must equal `to_str` of a plain-path greedy decode (kernels
  off, the runner's weights) of the same pp output."""
  import numpy as np
  from big_vision_torch.models.proj.paligemma import paligemma
  from big_vision_torch.pp import sentencepiece_native as spn
  from big_vision_torch.trainers.proj.paligemma import predict_fns
  from big_vision_torch.trainers.proj.paligemma import run
  workdir = os.path.dirname(path)
  vocab = os.path.join(workdir, "vocab.model")
  # Only "\u2581w<i>" pieces besides the specials: "w7 w8 w9" has ids,
  # "caption en" is all <unk>. Which ids the separator "\n" gets depends on
  # the SentencePiece backend (the native reader drops it); it is printed.
  pieces = [("<pad>", 0.0, spn.CONTROL), ("</s>", 0.0, spn.CONTROL),
            ("<s>", 0.0, spn.CONTROL), ("<unk>", 0.0, spn.UNKNOWN)]
  pieces += [(f"\u2581w{i}", -5.0, spn.NORMAL)
             for i in range(256_000 - len(pieces))]
  with open(vocab, "wb") as f:
    f.write(spn.serialize_model_proto(pieces, unk_id=3, bos_id=2, eos_id=1,
                                      pad_id=0))
  image = os.path.join(workdir, "image.jpg")
  with open(image, "wb") as f:
    f.write(smooth_jpeg())
  prompts = ["caption en", "w7 w8 w9"]
  run.TOKENIZER = f"gemma(tokensets=['loc', 'seg'], model={vocab!r})"
  run.MODEL_CFG = dict(
      img=dict(variant="So400m/14", pool_type="none", scan=True),
      llm=dict(variant="gemma_2b", vocab_size=256_000, decode_impl="flash",
               quant=True))
  sessions, session_cls = [], run.Session

  class Session(session_cls):  # keeps the runner's session for the check
    def __init__(self, *args, **kw):
      super().__init__(*args, **kw)
      sessions.append(self)

  reset_launches(fa)
  da.decode_attention.launches = 0
  out, stdin = _Lines(), sys.stdin
  sys.stdin = io.StringIO("\n".join(prompts) + "\n")
  run.Session = Session
  t0 = time.perf_counter()
  try:
    with contextlib.redirect_stdout(out):
      run.main(["--ckpt", path, "--image", image, "--res", str(RES),
                "--max_decode_len", str(RUNNER_DECODE)])
  finally:
    sys.stdin, run.Session = stdin, session_cls
  total = time.perf_counter() - t0
  answers = out.getvalue().splitlines()
  k1 = launches(fa)
  k6 = da.decode_attention.launches
  print(f"runner: {len(answers)} answers to {prompts}: {answers}; launches "
        f"K1 {k1['K1'] + k1['K1f']} (f32 tower: {k1['K1f']}), K6 {k6}")
  assert len(answers) == len(prompts) and all(answers), answers
  assert k1["K1"] + k1["K1f"] > 0 and k6 > 0
  print(f"[{gpu}] runner: first answer {out.first - t0:.1f} s after main "
        f"started (loading, the warm-up prompt), all {total:.1f} s")

  # The same pp output through the plain path, on the runner's weights.
  session = sessions[0]
  cfg = run.MODEL_CFG
  plain = paligemma.Model(
      img=dict(cfg["img"], image_size=RES, attn_impl="xla"),
      llm=dict(cfg["llm"], decode_impl="xla"), device="meta").eval()
  plain.load_state_dict(session.model.state_dict(), assign=True)
  decode = predict_fns.get_all(plain, max_decode_len=RUNNER_DECODE,
                               sampler="greedy")["decode"]
  with open(image, "rb") as f:
    image_bytes = f.read()
  print(f"runner's SentencePiece backend: "
        f"{type(session.tokzr.sp).__module__}")
  want = []
  for prompt in prompts:
    ex = session.pp_fn({"image": image_bytes, "prefix": np.array(prompt)})
    tokens = decode({k: torch.from_numpy(v[None]).cuda()
                     for k, v in ex.items()})[0].cpu().numpy()
    want.append(session.tokzr.to_str(tokens))
    print(f"  {prompt!r}: prompt ids {ex['text'][ex['mask_input'] > 0]}, "
          f"plain-path answer ids {tokens}")
  same = out.getvalue() == "".join(w + "\n" for w in want)
  print(f"runner's answers equal to the plain path's: {same}")
  assert same, want
  os.remove(vocab)
  os.remove(image)
  return {"K6 runner": k6}


# ----------------------------------------------------------------------------
# Phase 4: training.
# ----------------------------------------------------------------------------


def train_main_path(fa, workdir, gpu):
  """Trains through the entry point, with the config's step-0 eval;
  returns (trainer, launches per step, end-to-end numbers from the metric
  rows, eval img/s among them)."""
  from big_vision_torch import train
  shutil.rmtree(workdir, ignore_errors=True)
  n_eval = train.load_config(TRAIN_CONFIG)["evals"]["val"]["data"]["n"]
  eval_batches = -(-n_eval // TRAIN_B)
  reset_launches(fa)
  trainer = train.main(["--config", f"{TRAIN_CONFIG}:stop={TRAIN_STEPS},"
                        f"log={TRAIN_LOG}", "--workdir", workdir])
  torch.cuda.synchronize()
  counts = launches(fa)
  depth = len(trainer.model.encoder.blocks)
  print(f"training: {TRAIN_STEPS} steps of batch {trainer.batch_size} and "
        f"an eval of {eval_batches} batches at step 0; launches {counts} "
        f"(want K1, the tensor-core forward, {depth} x ({TRAIN_STEPS} + "
        f"{eval_batches}), K2, the tensor-core backward, {depth} x "
        f"{TRAIN_STEPS}, no other)")
  assert counts == {**dict.fromkeys(COUNTERS, 0),
                    "K1": depth * (TRAIN_STEPS + eval_batches),
                    "K2": depth * TRAIN_STEPS}, counts
  assert trainer.batch_size == TRAIN_B and depth == TRAIN_DEPTH
  with open(os.path.join(workdir, "big_vision_metrics.txt")) as f:
    all_rows = list(map(json.loads, f))
  evals = [r for r in all_rows if "val/prec@1" in r]
  assert [r["step"] for r in evals] == [0], evals  # stop= skips the final
  ev = evals[0]
  assert 0 <= ev["val/prec@1"] <= 1 and math.isfinite(ev["val/loss"]), ev
  eval_ips = n_eval / ev["z/secs/eval/val"]
  print(f"[{gpu}] eval at step 0 (decode, resize_small(256) and "
        f"central_crop(224) on the host; {n_eval} JPEGs of 256x320 in "
        f"{eval_batches} batches of {TRAIN_B}): val/prec@1 "
        f"{ev['val/prec@1']:.6f}, val/loss {ev['val/loss']:.6f}, "
        f"{ev['z/secs/eval/val']:.3f} s, {eval_ips:.1f} img/s")
  rows = [r for r in all_rows if "training_loss" in r]
  assert [r["step"] for r in rows] == list(
      range(TRAIN_LOG, TRAIN_STEPS + 1, TRAIN_LOG)), rows
  for r in rows:
    print(f"  step {r['step']}: loss {r['training_loss']:.6f}, "
          f"{r['img/sec']:.1f} img/s, {r['step_ms']:.3f} ms/step, input "
          f"stall {r['input_stall_pct']:.2f}%")
    assert math.isfinite(r["training_loss"]), r
  windows = rows[1:]  # the first window holds the start-up
  e2e = {k: statistics.median(r[k] for r in windows)
         for k in ("img/sec", "step_ms", "input_stall_pct")}
  e2e["eval img/s"] = eval_ips
  # Per training step (the eval's K1 launches left out).
  per_step = {"K1": (counts["K1"] - depth * eval_batches) // TRAIN_STEPS,
              "K2": counts["K2"] // TRAIN_STEPS}
  return trainer, per_step, e2e


def fixed_batch_steps(trainer):
  """FIXED_STEPS updates on one batch: (batch, the next batch, which no
  update sees, losses, ms per step between CUDA events with the input
  pipeline left out)."""
  it = trainer.input_iter()
  batch, unseen = next(it), next(it)
  it.close()
  trainer.update(batch)  # warm
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  losses = [trainer.update(batch)["training_loss"]
            for _ in range(FIXED_STEPS)]
  end.record()
  end.synchronize()
  losses = [x.item() for x in losses]
  print(f"fixed batch, {FIXED_STEPS} steps: loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}")
  assert all(math.isfinite(x) for x in losses), losses
  assert losses[-1] < losses[0], losses
  return batch, unseen, losses, start.elapsed_time(end) / FIXED_STEPS


def _attn_projection(name):
  # key/bias is left out: zero in exact arithmetic (the softmax ignores it).
  return ("MultiHeadDotProductAttention_0/" in name
          and not name.endswith("key/bias"))


@contextlib.contextmanager
def capture_attention(records):
  """Appends to `records`, for each attention call of the model, its q, k,
  v and output o and, once the backward has run, the do it received and
  the dq, dk and dv that reached q, k and v."""
  from big_vision_torch.ops import attention
  orig = attention.dot_product_attention

  def recorded(q, k, v, **kw):
    if not q.requires_grad:  # a frozen teacher's: no backward to record
      return orig(q, k, v, **kw)
    rec = {"q": q.detach(), "k": k.detach(), "v": v.detach()}
    records.append(rec)
    for name, x in (("dq", q), ("dk", k), ("dv", v)):
      x.register_hook(functools.partial(rec.__setitem__, name))
    out = orig(q, k, v, **kw)
    rec["o"] = out.detach()
    out.register_hook(functools.partial(rec.__setitem__, "do"))
    return out

  attention.dot_product_attention = recorded
  try:
    yield
  finally:
    attention.dot_product_attention = orig


def kernel_vs_plain_training(fa, trainer, batch):
  """The kernel path against the plain path (attn_impl="xla") from the
  trainer's state, on a batch that no update has seen, in f32 and in the
  config's bf16.

  Both dtypes: the loss and the encoder's output tokens within E2E_BAR
  (the loss alone is set mostly by the head's bias this early in
  training; the tokens depend on every attention layer). f32: every
  attention-projection gradient within E2E_BAR of max|plain|.

  bf16 differs from f32 by several percent wherever the softmax gradient
  cancels, on either path: dp - delta is a fraction of a percent of dp,
  and the tokens' keys share a common part many times larger than their
  spread, so the rounding of ds to bf16 (which breaks sum_j ds_ij = 0)
  moves dq along the mean key. So each of the backward's K2 launches is
  held, on the q, k, v and do it was given, against the f32 backward
  within K2_INPLACE_FACTOR times the plain version's own distance from it
  (or K2_BAR), and each bf16 attention-projection gradient of the kernel
  path against the f32 plain path's within BF16_GRAD_FACTOR times the
  bf16 plain path's distance from it (or BF16_GRAD_FLOOR).
  """
  from big_vision_torch import train
  state = trainer.model.state_dict()

  def run(t, records=None):
    tokens = []
    hook = t.model.encoder.register_forward_hook(
        lambda mod, args, out: tokens.append(out.detach().clone()))
    with (contextlib.nullcontext() if records is None
          else capture_attention(records)):
      loss, grads = t.loss_and_grads(batch)
    hook.remove()
    return loss.item(), tokens[0], {n: g.clone() for n, g in grads.items()
                                    if _attn_projection(n)}

  records = []
  runs = {("flash", "bfloat16"): run(trainer, records)}
  depth = len(trainer.model.encoder.blocks)
  assert len(records) == depth, len(records)
  k2_rows = []
  for layer, r in enumerate(records):
    q, k, v, do = r["q"], r["k"], r["v"], r["do"]
    plain = fa.flash_attention_bwd_reference(q, k, v, do)
    exact = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(),
                                             do.float())
    for name, p, e in zip(("dq", "dk", "dv"), plain, exact):
      ek, ep = rel_err(r[name], e), rel_err(p, e)
      k2_rows.append((ek / max(ep, K2_BAR), ek, ep, rel_err(r[name], p),
                      max(K2_BAR, K2_INPLACE_FACTOR * ep),
                      f"layer {layer} {name}"))
  del records, plain, exact
  k2_rows.sort(reverse=True)
  print(f"K2 in the bf16 training backward, {depth} launches on their own "
        f"inputs against the f32 backward (kernel, plain version, kernel "
        f"vs plain version; bar = max({K2_BAR}, {K2_INPLACE_FACTOR} x "
        f"plain)), the 4 of {len(k2_rows)} where the kernel is worst "
        f"relative to the plain version:")
  for _, ek, ep, ekp, bar, n in k2_rows[:4]:
    print(f"  {n}: {ek:.3e} {ep:.3e} {ekp:.3e} bar {bar:.3e}")
  for _, ek, ep, _, bar, n in k2_rows:
    assert ek <= bar, (n, ek, ep, bar)
  for attn, dtype in (("xla", "bfloat16"), ("flash", "float32"),
                      ("xla", "float32")):
    t = train.Trainer(train.load_config(
        f"{TRAIN_CONFIG}:attn={attn},dtype={dtype}"))
    t.model.load_state_dict(state)
    runs[attn, dtype] = run(t)
    del t
    torch.cuda.empty_cache()
  # For scale: the one-shot semantics computed by the plain versions of K1
  # and K2 (autograd through `flash_attention_reference`) in bf16.
  kernel_fn = fa.flash_attention
  fa.flash_attention = lambda q, k, v, **kw: fa.flash_attention_reference(
      q, k, v, **kw)
  try:
    xo = run(trainer)[1]
  finally:
    fa.flash_attention = kernel_fn
  xk, xp = runs["flash", "bfloat16"][1], runs["xla", "bfloat16"][1]
  mean = lambda a, b: ((a - b).abs().mean() / b.abs().mean()).item()
  print(f"bfloat16 encoder output, for scale: the one-shot plain versions' "
        f"path vs the plain path rel err {rel_err(xo, xp):.3e}, the kernel "
        f"path vs the one-shot plain versions' {rel_err(xk, xo):.3e}; mean "
        f"abs err over mean |plain path|: kernel path {mean(xk, xp):.3e}, "
        f"one-shot plain versions {mean(xo, xp):.3e}")
  del xo
  for dtype in ("float32", "bfloat16"):
    (lk, xk, _), (lp, xp, _) = runs["flash", dtype], runs["xla", dtype]
    loss_err, tok_err = abs(lk - lp) / abs(lp), rel_err(xk, xp)
    print(f"kernel vs plain path, {dtype}, unseen batch: training loss "
          f"{lk:.6f} vs {lp:.6f}, rel err {loss_err:.3e}; encoder output "
          f"{tuple(xk.shape)} rel err {tok_err:.3e} (bar {E2E_BAR})")
    assert loss_err <= E2E_BAR and tok_err <= E2E_BAR, (dtype, loss_err,
                                                        tok_err)
  exact = runs["xla", "float32"][2]
  gk, gp = runs["flash", "float32"][2], runs["xla", "bfloat16"][2]
  worst = max((rel_err(gk[n], exact[n]), n) for n in exact)
  print(f"kernel vs plain path, float32: {len(exact)} attention-projection "
        f"gradients, worst rel err {worst[0]:.3e} ({worst[1]}, bar "
        f"{E2E_BAR})")
  assert worst[0] <= E2E_BAR, worst
  kb = runs["flash", "bfloat16"][2]
  rows = []
  for n in exact:
    ek, ep = rel_err(kb[n], exact[n]), rel_err(gp[n], exact[n])
    rows.append((ek / max(ep, BF16_GRAD_FLOOR), ek, ep,
                 max(BF16_GRAD_FLOOR, BF16_GRAD_FACTOR * ep), n))
  rows.sort(reverse=True)
  kvp = max((rel_err(kb[n], gp[n]), n) for n in exact)
  print(f"bfloat16 attention-projection gradients against the float32 "
        f"plain path: the 5 of {len(rows)} where the kernel path is worst "
        f"relative to the plain path (kernel path, plain path, bar = "
        f"max({BF16_GRAD_FLOOR}, {BF16_GRAD_FACTOR} x plain)):")
  for _, ek, ep, bar, n in rows[:5]:
    print(f"  {n}: {ek:.3e} {ep:.3e} bar {bar:.3e}")
  print(f"  kernel path worst {max(r[1] for r in rows):.3e}, plain path "
        f"worst {max(r[2] for r in rows):.3e}; kernel vs plain path worst "
        f"{kvp[0]:.3e} ({kvp[1]}), median "
        f"{statistics.median(rel_err(kb[n], gp[n]) for n in exact):.3e}")
  for _, ek, ep, bar, n in rows:
    assert ek <= bar, (n, ek, ep, bar)
  assert len(exact) == depth * 7


# ----------------------------------------------------------------------------
# Phase 5: FlexiViT-B training.
# ----------------------------------------------------------------------------


def flexi_want(depth, seqhw):
  """The launches of one FlexiViT-B step at `seqhw` with attn=flash: T =
  seqhw^2 + 1 is 901 and 1601 at seqhw 30 and 40, past the one-shot
  boundary at D=64 (blocked: K3, K4a, K4b), and at most 577 below
  (one-shot: K1's and K2's f32 kernels)."""
  kernels = ("K3", "K4a", "K4b") if seqhw in (30, 40) else ("K1f", "K2f")
  return {**dict.fromkeys(COUNTERS, 0), **dict.fromkeys(kernels, depth)}


@contextlib.contextmanager
def counted_predict_fns(fa, calls):
  """While open, every predict fn that the trainers give their evaluators
  appends the launches of each of its calls (one eval batch) to
  calls[its name]."""
  from big_vision_torch.evaluators import common as eval_common
  original = eval_common.from_config

  def counted(name, fn):
    def call(*args, **kw):
      before = launches(fa)
      out = fn(*args, **kw)
      after = launches(fa)
      calls.setdefault(name, []).append(
          {k: n - before[k] for k, n in after.items()})
      return out
    return call

  def from_config(config, predict_fns, **kw):
    return original(config, {name: counted(name, fn)
                             for name, fn in predict_fns.items()}, **kw)

  eval_common.from_config = from_config
  try:
    yield calls
  finally:
    eval_common.from_config = original


def eval_want(depth, name):
  """The launches of one eval batch of FlexiViT-B with attn=flash through
  the predict fn `name` (`<prefix>_seqhw=<s>`): a forward at T = s^2 + 1
  (at 240px; 257 at the few-shot eval's 224px and seqhw 15), K3 at seqhw
  30, K1's f32 kernel below."""
  seqhw = int(name.rsplit("=", 1)[1])
  return {**dict.fromkeys(COUNTERS, 0), ("K3" if seqhw == 30 else "K1f"):
          depth}


def check_eval_launches(calls, depth, gpu, rows, n_images, what):
  """Every eval batch launched `eval_want` of its predict fn; prints the
  launches per batch and each eval's img/s from the metric row `rows`
  (`z/secs/eval/<name>` over `n_images[name]`)."""
  for name, per_call in sorted(calls.items()):
    want = eval_want(depth, name)
    assert all(c == want for c in per_call), (name, per_call[:2], want)
    print(f"  {what} predict fn {name}: {len(per_call)} eval batches, "
          f"launches per batch {({k: n for k, n in want.items() if n})}")
  for name, n in n_images.items():
    secs = rows[f"z/secs/eval/{name}"]
    print(f"[{gpu}] {what} eval {name} at step 0: {n} images in "
          f"{secs:.3f} s, {n / secs:.1f} img/s")


def flexi_main_path(fa, workdir, gpu):
  """FLEXI_STEPS steps of the FlexiViT trainer's own loop, with its seqhw
  draws, after the config's evals at step 0 (FLEXI_NEVAL images a split,
  few-shot on FLEXI_FEWSHOT); returns the trainer."""
  from big_vision_torch.trainers.proj.flexi import train as flexi_train
  shutil.rmtree(workdir, ignore_errors=True)
  calls = {}
  reset_launches(fa)
  with counted_predict_fns(fa, calls):
    trainer = flexi_train.main([
        "--config", f"{FLEXI_CONFIG}:stop={FLEXI_STEPS},log=1,attn=flash,"
        f"neval={FLEXI_NEVAL},fewshot={FLEXI_FEWSHOT}", "--workdir",
        workdir])
  torch.cuda.synchronize()
  counts = launches(fa)
  depth = len(trainer.model.encoder.blocks)
  draws = [trainer.step_kwargs(s)["seqhw"] for s in range(1, FLEXI_STEPS + 1)]
  want = {k: sum(flexi_want(depth, s)[k] for s in draws)
          + sum(c[k] for per_call in calls.values() for c in per_call)
          for k in COUNTERS}
  print(f"FlexiViT-B training: {FLEXI_STEPS} steps of batch "
        f"{trainer.batch_size}, seqhw drawn {draws}, after the evals at "
        f"step 0; launches {counts} (want {want})")
  assert counts == want and {30, 40} <= set(draws), (counts, want, draws)
  assert trainer.batch_size == FLEXI_B and depth == TRAIN_DEPTH
  batches = -(-FLEXI_NEVAL // FLEXI_B)
  assert sorted(calls) == [f"predict_seqhw={s}" for s in (10, 15, 30, 5)]
  assert [len(calls[f"predict_seqhw={s}"]) for s in (5, 10, 15, 30)] == [
      batches, batches, 3 * batches, batches]  # 15: test_15 and few-shot
  with open(os.path.join(workdir, "big_vision_metrics.txt")) as f:
    all_rows = list(map(json.loads, f))
  [ev] = [r for r in all_rows if "test_05/prec@1" in r]
  assert ev["step"] == 0
  for s in ("05", "10", "15", "30"):
    assert 0 <= ev[f"test_{s}/prec@1"] <= 1, ev
    assert math.isfinite(ev[f"test_{s}/loss"]), ev
  shots = {k: v for k, v in ev.items() if k.startswith("fewshot/")}
  assert len(shots) == 4 and all(0 <= v <= 1 for v in shots.values()), ev
  print("  step 0: " + ", ".join(
      f"test_{s}/prec@1 {ev[f'test_{s}/prec@1']:.6f} loss "
      f"{ev[f'test_{s}/loss']:.6f}" for s in ("05", "10", "15", "30"))
        + "; " + ", ".join(f"{k} {v:.6f}" for k, v in shots.items()))
  n_images = {f"test_{s}": FLEXI_NEVAL for s in ("05", "10", "15", "30")}
  n_images["fewshot"] = 2 * FLEXI_NEVAL
  check_eval_launches(calls, depth, gpu, ev, n_images, "FlexiViT-B")
  rows = [r for r in all_rows if "training_loss" in r]
  assert [r["step"] for r in rows] == list(range(1, FLEXI_STEPS + 1)), rows
  for r, seqhw in zip(rows, draws):
    print(f"  step {r['step']} (seqhw {seqhw}): loss "
          f"{r['training_loss']:.6f}, l2_grads {r['l2_grads']:.6f}, "
          f"{r['step_ms']:.3f} ms")
    assert math.isfinite(r["training_loss"]), r
  return trainer


def eval_batches(config):
  """{eval name: (its predict fn's name, its first batch)} for each eval of
  `config` (the few-shot eval's training split), on the card."""
  from big_vision_torch.evaluators import common as eval_common
  batches = {}
  for eval_name, spec in config["evals"].items():
    spec = dict(spec)
    if spec["type"] == "fewshot_lsr":
      [ds] = spec["datasets"].values()
      spec["data"], spec["pp_fn"] = ds["data_train"], ds["pp"]
    get_iter, _ = eval_common.eval_input_pipeline(
        spec["data"], spec["pp_fn"], config["input"]["batch_size"], "cuda",
        cache="none")
    it = get_iter()
    batch, _ = eval_common.split_batch(next(it))
    it.close()
    batches[eval_name] = (spec["pred"], {"image": batch["image"]})
  return batches


def eval_pre_logits_vs_plain(fa, trainer, plain, batches, what):
  """Each eval's batch of `batches` through its predict fn on the kernel
  path (`trainer`) and on the plain path (`plain`, attn=xla, the same
  weights): the kernel path's launches as `eval_want` says, none on the
  plain path, and the `pre_logits` within F32_BAR of the plain path's."""
  depth = len(trainer.model.encoder.blocks)
  kernel_fns, plain_fns = trainer.predict_fns(), plain.predict_fns()
  for eval_name, (name, batch) in batches.items():
    with torch.no_grad():
      reset_launches(fa)
      _, out = kernel_fns[name](None, batch)
      torch.cuda.synchronize()
      counts = launches(fa)
      _, want = plain_fns[name](None, batch)
      assert launches(fa) == counts, name
    assert counts == eval_want(depth, name), (name, counts)
    got, want = out["pre_logits"], want["pre_logits"]
    err = rel_err(got, want)
    print(f"{what} {eval_name} ({name}) on {tuple(batch['image'].shape)}: "
          f"pre_logits "
          f"{tuple(got.shape)} kernel vs plain path rel err {err:.3e} (bar "
          f"{F32_BAR}), max|plain| {want.abs().max().item():.4f}")
    assert err <= F32_BAR and want.abs().max().item() > 0, (name, err)


def flexi_steps(fa, trainer, gpu):
  """Steps at seqhw 40, 30, 15, twice, on one batch (CUDA events, launches
  and peak memory of each step), a profile of one step at seqhw 40, then
  FLEXI_FIXED_STEPS steps at seqhw 40 whose loss must fall. Returns (the
  next batch, which no update sees, the launches read after the last step
  at each seqhw, and {seqhw: (step ms, peak bytes)})."""
  it = trainer.input_iter()
  batch, unseen = next(it), next(it)
  it.close()
  depth = len(trainer.model.encoder.blocks)
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  times, memory, per_step = {}, {}, {}
  for seqhw in FLEXI_CYCLE:
    reset_launches(fa)
    torch.cuda.reset_peak_memory_stats()
    start.record()
    trainer.update(batch, seqhw=seqhw)
    end.record()
    end.synchronize()
    counts = launches(fa)
    assert counts == flexi_want(depth, seqhw), (seqhw, counts)
    per_step[seqhw] = counts
    times.setdefault(seqhw, []).append(start.elapsed_time(end))
    memory[seqhw] = max(memory.get(seqhw, 0), torch.cuda.max_memory_allocated())
  for seqhw, ms in times.items():
    used = {k: n for k, n in flexi_want(depth, seqhw).items() if n}
    print(f"[{gpu}] FlexiViT-B seqhw {seqhw} (T={seqhw * seqhw + 1}) batch "
          f"{FLEXI_B}: step {', '.join(f'{x:.3f}' for x in ms)} ms, "
          f"{1e3 * FLEXI_B / ms[-1]:.1f} img/s (last step); launches per "
          f"step {used}; max memory allocated {memory[seqhw] / 2**30:.2f} GiB")
  from big_vision_torch.tools import bench_decode
  bench_decode.print_profile(kernel_timing.device_profile(
      {"FlexiViT-B step at seqhw 40": lambda: trainer.update(batch,
                                                             seqhw=40)},
      top=12), prefix=f"[{gpu}] ")
  losses = [trainer.update(batch, seqhw=40)["training_loss"]
            for _ in range(FLEXI_FIXED_STEPS)]
  losses = [x.item() for x in losses]
  print(f"fixed batch, seqhw 40, {FLEXI_FIXED_STEPS} steps: loss "
        + " ".join(f"{x:.6f}" for x in losses))
  assert all(math.isfinite(x) for x in losses), losses
  assert losses[-1] < losses[0], losses
  return unseen, per_step, {s: (times[s], memory[s]) for s in times}


def flexi_kernel_vs_plain(fa, trainer, batch):
  """The kernel path against the plain path (attn_impl="xla") from the
  trainer's state at seqhw 40, on FLEXI_CHECK_B images no update saw
  (the plain path holds [B, 12, 1601, 1601] f32 scores per layer): loss,
  encoder output and every attention-projection gradient within E2E_BAR
  of max|plain|; each K3 launch of the kernel path's forward (its o, and
  the LSE of a repeat launch) and each K4a and K4b launch of its backward,
  on the inputs it was given, within BLOCKED_BAR of its plain version."""
  from big_vision_torch import train
  from big_vision_torch.trainers.proj.flexi import train as flexi_train
  batch = {k: v[:FLEXI_CHECK_B] for k, v in batch.items()}

  def run(t, records=None):
    for p in t.params.values():
      p.grad = None
    tokens = []
    hook = t.model.encoder.register_forward_hook(
        lambda mod, args, out: tokens.append(out.detach().clone()))
    with (contextlib.nullcontext() if records is None
          else capture_attention(records)):
      logits, _ = t.model(batch["image"], seqhw=40)
      loss = t.loss_fn(logits=logits, labels=batch["labels"])
      loss.backward()
    hook.remove()
    return loss.item(), tokens[0], {n: p.grad.clone() for n, p in
                                    t.params.items() if _attn_projection(n)}

  records = []
  reset_launches(fa)
  lk, xk, gk = run(trainer, records)
  torch.cuda.synchronize()
  depth = len(trainer.model.encoder.blocks)
  assert launches(fa) == flexi_want(depth, 40), launches(fa)
  assert len(records) == depth, len(records)
  rows, k3_rows = [], []
  for layer, r in enumerate(records):
    q, k, v, do = r["q"], r["k"], r["v"], r["do"]
    # K3 is deterministic (no atomics, a fixed order of sums), so this is
    # the o and LSE that the backward was given.
    o, lse = fa.flash_attention_blocked_forward(q, k, v)
    assert torch.equal(o, r["o"]), layer
    for name, x, w in zip(("o", "lse"), (o, lse),
                          fa.flash_attention_blocked_reference(q, k, v)):
      k3_rows.append((rel_err(x, w), f"layer {layer} {name}"))
    delta = fa.blocked_delta(o, do)
    want = dict(zip(("dk", "dv"), fa.flash_attention_blocked_dkv_reference(
        q, k, v, do, lse, delta)))
    want["dq"] = fa.flash_attention_blocked_dq_reference(q, k, v, do, lse,
                                                         delta)
    for name, w in want.items():
      assert w.abs().max().item() > 0, (layer, name)
      rows.append((rel_err(r[name], w), f"layer {layer} {name}"))
  del records
  bar = BLOCKED_BAR[torch.float32]
  for what, found in (("K3 in the seqhw-40 forward", k3_rows),
                      ("K4a/K4b in the seqhw-40 backward", rows)):
    found.sort(reverse=True)
    print(f"{what}: {len(found)} outputs of {depth} launches against the "
          f"plain version on their own inputs, the 4 worst (bar {bar}): "
          + ", ".join(f"{n} {e:.3e}" for e, n in found[:4]))
    assert all(e <= bar for e, _ in found), found[:4]

  plain = flexi_train.Trainer(train.load_config(f"{FLEXI_CONFIG}:attn=xla"))
  plain.model.load_state_dict(trainer.model.state_dict())
  lp, xp, gp = run(plain)
  del plain
  torch.cuda.empty_cache()
  loss_err, tok_err = abs(lk - lp) / abs(lp), rel_err(xk, xp)
  worst = max((rel_err(gk[n], gp[n]), n) for n in gp)
  print(f"FlexiViT kernel vs plain path, seqhw 40, {FLEXI_CHECK_B} unseen "
        f"images: loss {lk:.6f} vs {lp:.6f}, rel err {loss_err:.3e}; encoder "
        f"output {tuple(xk.shape)} rel err {tok_err:.3e}; {len(gp)} "
        f"attention-projection gradients, worst rel err {worst[0]:.3e} "
        f"({worst[1]}) (bar {E2E_BAR})")
  assert len(gp) == depth * 7
  assert loss_err <= E2E_BAR and tok_err <= E2E_BAR and worst[0] <= E2E_BAR


def flexi_k2_in_place(fa, trainer, batch):
  """Each K1 launch of the FlexiViT-B forward at seqhw 15 (T=226, its f32
  kernel; o, and the LSE of a repeat launch) and each K2 launch of the
  backward (its f32 kernel; dq, dk and dv), on the inputs it was given,
  against its plain version within F32_BAR; on a batch no update saw."""
  records = []
  for p in trainer.params.values():
    p.grad = None
  reset_launches(fa)
  with capture_attention(records):
    logits, _ = trainer.model(batch["image"], seqhw=15)
    trainer.loss_fn(logits=logits, labels=batch["labels"]).backward()
  torch.cuda.synchronize()
  depth = len(trainer.model.encoder.blocks)
  assert launches(fa) == flexi_want(depth, 15), launches(fa)
  assert len(records) == depth, len(records)
  rows, k1_rows = [], []
  for layer, r in enumerate(records):
    q, k, v = r["q"], r["k"], r["v"]
    # K1's f32 kernel is deterministic: a repeat launch gives r["o"] and
    # the LSE that K2 was given.
    o, lse = fa.flash_attention_forward(q, k, v)
    assert torch.equal(o, r["o"]), layer
    k1_rows.append((rel_err(o, fa.flash_attention_reference(q, k, v)),
                    f"layer {layer} o"))
    k1_rows.append((rel_err(lse, fa.flash_attention_lse_reference(q, k, v)),
                    f"layer {layer} lse"))
    want = fa.flash_attention_bwd_reference(q, k, v, r["do"])
    for name, w in zip(("dq", "dk", "dv"), want):
      assert w.abs().max().item() > 0, (layer, name)
      rows.append((rel_err(r[name], w), f"layer {layer} {name}"))
  del records
  for p in trainer.params.values():
    p.grad = None
  for what, found in (("K1 (f32) in the seqhw-15 forward", k1_rows),
                      ("K2 (f32) in the seqhw-15 backward", rows)):
    found.sort(reverse=True)
    print(f"{what}, batch {batch['image'].shape[0]}: {len(found)} outputs "
          f"of {depth} launches against the plain version on their own "
          f"inputs, the 4 worst (bar {F32_BAR}): "
          + ", ".join(f"{n} {e:.3e}" for e, n in found[:4]))
    assert all(e <= F32_BAR for e, _ in found), found[:4]


def flexi_auto_steps(fa, auto, batch, flash, gpu):
  """The trainer `auto` of the config's default attn=auto, which follows
  the JAX package's gate: at batch 32 its scores are under
  XLA_SCORES_BYTES_LIMIT at seqhw 40 and 30, so the plain path runs there
  (under a checkpoint) and no kernel is launched. Two steps at each (CUDA
  events, peak memory), printed beside the attn=flash steps `flash`."""
  assert auto.model.encoder.blocks[0].attn.attn_impl == "auto"
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  for seqhw in (40, 30):
    times = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
      reset_launches(fa)
      start.record()
      loss = auto.update(batch, seqhw=seqhw)["training_loss"]
      end.record()
      end.synchronize()
      assert math.isfinite(loss.item()), (seqhw, loss)
      counts = launches(fa)
      assert counts == dict.fromkeys(COUNTERS, 0), (seqhw, counts)
      times.append(start.elapsed_time(end))
    mem = torch.cuda.max_memory_allocated()
    f_ms, f_mem = flash[seqhw]
    print(f"[{gpu}] FlexiViT-B seqhw {seqhw} (T={seqhw * seqhw + 1}) batch "
          f"{FLEXI_B}, attn=auto (plain path, no kernel launched): step "
          f"{', '.join(f'{x:.3f}' for x in times)} ms, max memory allocated "
          f"{mem / 2**30:.2f} GiB; attn=flash: step "
          f"{', '.join(f'{x:.3f}' for x in f_ms)} ms, {f_mem / 2**30:.2f} GiB")


def flexi_auto_eval_launches(fa, auto, batches):
  """One eval batch through each predict fn of the trainer `auto` (attn=
  auto, the JAX package's gate): at batch 32 K1's f32 kernel at seqhw 5, 10
  and 15, and the plain path at 30 (its scores are under
  XLA_SCORES_BYTES_LIMIT), no kernel."""
  depth = len(auto.model.encoder.blocks)
  fns = auto.predict_fns()
  for eval_name, (name, batch) in batches.items():
    reset_launches(fa)
    with torch.no_grad():
      fns[name](None, batch)
    counts = launches(fa)
    want = eval_want(depth, name)
    if want["K3"]:
      want["K3"] = 0
    print(f"FlexiViT-B attn=auto {eval_name} ({name}), batch "
          f"{batch['image'].shape[0]}: launches "
          f"{({k: n for k, n in counts.items() if n})}")
    assert counts == want, (name, counts, want)


def flexi_phase(fa, gpu):
  """Phase 5 and the FlexiViT-B step times; returns the launches of the
  last step at seqhw 40 (K3, K4a, K4b) and at 15 (K1's and K2's f32
  kernels), as the counters read them."""
  from big_vision_torch import train
  from big_vision_torch.trainers.proj.flexi import train as flexi_train
  workdir = os.path.join(ROOT, "build", "chip_smoke_flexi")
  trainer = flexi_main_path(fa, workdir, gpu)
  unseen, per_step, flash = flexi_steps(fa, trainer, gpu)
  flexi_kernel_vs_plain(fa, trainer, unseen)
  flexi_k2_in_place(fa, trainer, unseen)
  args = f"neval={FLEXI_NEVAL},fewshot={FLEXI_FEWSHOT}"
  batches = eval_batches(train.load_config(f"{FLEXI_CONFIG}:{args}"))
  plain = flexi_train.Trainer(train.load_config(
      f"{FLEXI_CONFIG}:attn=xla,{args}"))
  plain.model.load_state_dict(trainer.model.state_dict())
  eval_pre_logits_vs_plain(fa, trainer, plain, batches, "FlexiViT-B eval")
  del plain
  # The same state under the config's default attn=auto, alone on the card.
  t0 = time.perf_counter()
  auto = flexi_train.Trainer(train.load_config(FLEXI_CONFIG))
  auto.model.load_state_dict(trainer.model.state_dict())
  del trainer
  flexi_auto_steps(fa, auto, unseen, flash, gpu)
  flexi_auto_eval_launches(fa, auto, batches)
  print(f"FlexiViT-B attn=auto steps: {time.perf_counter() - t0:.1f} s wall")
  del auto, unseen, batches
  torch.cuda.empty_cache()
  return {**{k: n for k, n in per_step[40].items() if n},
          "K1f": per_step[15]["K1f"], "K2f": per_step[15]["K2f"]}


# ----------------------------------------------------------------------------
# Phase 6: FlexiViT-B distillation from a ViT-B/8 teacher, with K5.
# ----------------------------------------------------------------------------


def write_teacher(path):
  """Writes a random ViT-B/8 (21843 classes, [cls] readout) from SEED with
  a seeded nonzero head, as the oldest published checkpoints lay it out:
  224px, the posemb under Transformer/posembed_input with a [cls] row (785
  rows). Returns (the 224px tree's cls + posemb row 0, its posemb)."""
  import numpy as np
  from big_vision_torch.models import vit
  from big_vision_torch.utils import checkpoints
  from big_vision_torch.utils import convert
  teacher = vit.Model(21843, variant="B/8", pool_type="tok", image_size=224,
                      device="cuda")
  gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
  teacher.initialize(gen)
  with torch.no_grad():
    teacher.head.weight.normal_(0.0, TEACHER_HEAD_STD, generator=gen)
  tree = convert.vit_params(teacher)
  del teacher
  pe = tree.pop("pos_embedding")
  row = np.random.RandomState(SEED).randn(1, 1, pe.shape[-1]).astype(
      np.float32) * 0.02
  tree["Transformer"]["posembed_input"] = {
      "pos_embedding": np.concatenate([row, pe], axis=1)}
  checkpoints.npz_save(tree, path)
  return tree["cls"] + row, pe


def distill_want(depth, seqhw):
  """The launches of one distillation step at `seqhw`: the teacher's
  forward at T=901 (K3), and the student's at seqhw 30, 40 (K3, then K5 as
  its backward) or below (K1's and K2's f32 kernels)."""
  want = dict.fromkeys(COUNTERS, 0)
  want["K3"] = depth
  kernels = ("K3", "K5") if seqhw in (30, 40) else ("K1f", "K2f")
  for k in kernels:
    want[k] += depth
  return want


def distill_main_path(fa, workdir, teacher_npz):
  """DISTILL_STEPS steps of the distill trainer's own loop, draws and
  checkpoint; returns the trainer."""
  from big_vision_torch.trainers.proj.flexi import distill
  reset_launches(fa)
  trainer = distill.main([
      "--config", f"{DISTILL_CONFIG}:stop={DISTILL_STEPS},log=1,"
      f"ckpt={DISTILL_STEPS},prof_init={teacher_npz},attn=flash",
      "--workdir", workdir])
  torch.cuda.synchronize()
  counts = launches(fa)
  depth = len(trainer.model.encoder.blocks)
  draws = [trainer.step_kwargs(s)["seqhw"]
           for s in range(1, DISTILL_STEPS + 1)]
  want = {k: sum(distill_want(depth, s)[k] for s in draws) for k in COUNTERS}
  print(f"FlexiViT-B distillation: {DISTILL_STEPS} steps of batch "
        f"{trainer.batch_size}, seqhw drawn {draws}; launches {counts} (want "
        f"{want})")
  assert counts == want and {30, 40} <= set(draws), (counts, want, draws)
  assert trainer.batch_size == FLEXI_B and depth == TRAIN_DEPTH
  assert len(trainer.teachers["prof"].encoder.blocks) == TRAIN_DEPTH
  with open(os.path.join(workdir, "big_vision_metrics.txt")) as f:
    rows = [r for r in map(json.loads, f) if "training_loss" in r]
  assert [r["step"] for r in rows] == list(range(1, DISTILL_STEPS + 1)), rows
  for r, seqhw in zip(rows, draws):
    print(f"  step {r['step']} (seqhw {seqhw}): loss "
          f"{r['training_loss']:.6f}, task loss student "
          f"{r['task_loss_student']:.6f} teacher {r['task_loss_prof']:.6f}, "
          f"l2_grads {r['l2_grads']:.6f}, {r['step_ms']:.3f} ms")
    assert math.isfinite(r["training_loss"]) and r["training_loss"] > 0, r
  return trainer


def distill_resume(trainer, workdir):
  """A new trainer on the workdir resumes from the checkpoint of the last
  step: params (student and teacher) and optimizer state equal, and the
  next step's seqhw and loss equal to the first trainer's."""
  from big_vision_torch.trainers.proj.flexi import distill
  resumed = distill.Trainer(trainer.config, workdir=workdir)
  assert resumed.first_step == trainer.first_step + DISTILL_STEPS, (
      resumed.first_step)
  for name, p in trainer.params.items():
    assert torch.equal(p, resumed.params[name]), name
  for part in ("mu", "nu"):
    for name, x in trainer.opt_state[part].items():
      assert torch.equal(x, resumed.opt_state[part][name]), (part, name)
  assert trainer.opt_state["count"] == resumed.opt_state["count"]
  teacher = dict(trainer.teachers["prof"].named_parameters())
  for name, p in resumed.teachers["prof"].named_parameters():
    assert torch.equal(p, teacher[name]), name
  step = resumed.first_step + 1
  it = resumed.input_iter(resumed.first_step)
  batch = next(it)
  it.close()
  kw = resumed.step_kwargs(step)
  assert kw == trainer.step_kwargs(step)
  losses = [t.update(batch, **kw)["training_loss"].item()
            for t in (trainer, resumed)]
  print(f"resumed at step {resumed.first_step} from "
        f"{os.path.basename(resumed.ckpt_prefix)}-LAST: params, optimizer "
        f"state and teacher equal; step {step} (seqhw {kw['seqhw']}) loss "
        f"{losses[0]:.6f} continued, {losses[1]:.6f} resumed")
  assert losses[0] == losses[1], losses
  del resumed


def distill_steps(fa, trainer, gpu):
  """Steps at seqhw 40, 30, 15, twice, on one batch (CUDA events, launches
  and peak memory of each step), a profile of one step at seqhw 40, then
  FIXED_STEPS steps at seqhw 40 whose loss must fall. Returns (the next
  batch, which no update sees, the launches read after the last step at
  seqhw 40)."""
  it = trainer.input_iter()
  batch, unseen = next(it), next(it)
  it.close()
  depth = len(trainer.model.encoder.blocks)
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  times, memory, per_step = {}, {}, {}
  for seqhw in FLEXI_CYCLE:
    reset_launches(fa)
    torch.cuda.reset_peak_memory_stats()
    start.record()
    trainer.update(batch, seqhw=seqhw)
    end.record()
    end.synchronize()
    counts = launches(fa)
    assert counts == distill_want(depth, seqhw), (seqhw, counts)
    per_step[seqhw] = counts
    times.setdefault(seqhw, []).append(start.elapsed_time(end))
    memory[seqhw] = max(memory.get(seqhw, 0), torch.cuda.max_memory_allocated())
  for seqhw, ms in times.items():
    used = {k: n for k, n in distill_want(depth, seqhw).items() if n}
    print(f"[{gpu}] distillation FlexiViT-B seqhw {seqhw} "
          f"(T={seqhw * seqhw + 1}) from ViT-B/8 (T=901) batch {FLEXI_B}: "
          f"step {', '.join(f'{x:.3f}' for x in ms)} ms, "
          f"{1e3 * FLEXI_B / ms[-1]:.1f} img/s (last step); launches per "
          f"step {used}; max memory allocated {memory[seqhw] / 2**30:.2f} GiB")
  from big_vision_torch.tools import bench_decode
  bench_decode.print_profile(kernel_timing.device_profile(
      {"distillation step at seqhw 40": lambda: trainer.update(
          batch, seqhw=40)}, top=12), prefix=f"[{gpu}] ")
  losses = [trainer.update(batch, seqhw=40)["training_loss"]
            for _ in range(FIXED_STEPS)]
  losses = [x.item() for x in losses]
  print(f"distillation, fixed batch, seqhw 40, {FIXED_STEPS} steps: loss "
        + " ".join(f"{x:.6f}" for x in losses))
  assert all(math.isfinite(x) for x in losses), losses
  assert losses[-1] < losses[0], losses
  return unseen, per_step[40]


def distill_kernel_vs_plain(fa, trainer, batch, teacher_npz):
  """The kernel path (K5 backward) against the plain path (attn_impl="xla"
  for student and teacher) from the trainer's state at seqhw 40, on
  FLEXI_CHECK_B images no update saw: loss, student encoder output and
  every attention-projection gradient within E2E_BAR of max|plain|; each
  K5 launch of the kernel path's backward, on the inputs it was given,
  within BLOCKED_BAR of its plain version."""
  from big_vision_torch import train
  from big_vision_torch.trainers.proj.flexi import distill
  batch = {k: v[:FLEXI_CHECK_B] for k, v in batch.items()}

  def run(t, records=None):
    tokens = []
    hook = t.model.encoder.register_forward_hook(
        lambda mod, args, out: tokens.append(out.detach().clone()))
    with (contextlib.nullcontext() if records is None
          else capture_attention(records)):
      loss, grads, _ = t.loss_and_grads(batch, seqhw=40)
    hook.remove()
    return loss.item(), tokens[0], {n: g.clone() for n, g in grads.items()
                                    if _attn_projection(n)}

  records = []
  reset_launches(fa)
  lk, xk, gk = run(trainer, records)
  torch.cuda.synchronize()
  depth = len(trainer.model.encoder.blocks)
  assert launches(fa) == distill_want(depth, 40), launches(fa)
  assert len(records) == depth, len(records)  # the student's layers
  rows = []
  for layer, r in enumerate(records):
    q, k, v, do = r["q"], r["k"], r["v"], r["do"]
    # K3 is deterministic (no atomics, a fixed order of sums), so this is
    # the o and LSE that the backward was given.
    o, lse = fa.flash_attention_blocked_forward(q, k, v)
    want = fa.flash_attention_blocked_bwd_fused_reference(q, k, v, o, lse, do)
    for name, w in zip(("dq", "dk", "dv"), want):
      assert w.abs().max().item() > 0, (layer, name)
      rows.append((rel_err(r[name], w), f"layer {layer} {name}"))
  del records
  rows.sort(reverse=True)
  bar = BLOCKED_BAR[torch.float32]
  print(f"K5 in the seqhw-40 distillation backward: {len(rows)} outputs of "
        f"{depth} launches against the plain version on their own inputs, "
        f"the 4 worst (bar {bar}): "
        + ", ".join(f"{n} {e:.3e}" for e, n in rows[:4]))
  assert all(e <= bar for e, _ in rows), rows[:4]

  plain = distill.Trainer(train.load_config(
      f"{DISTILL_CONFIG}:attn=xla,prof_init={teacher_npz}"))
  plain.model.load_state_dict(trainer.model.state_dict())
  lp, xp, gp = run(plain)
  del plain
  torch.cuda.empty_cache()
  loss_err, tok_err = abs(lk - lp) / abs(lp), rel_err(xk, xp)
  worst = max((rel_err(gk[n], gp[n]), n) for n in gp)
  print(f"distillation kernel vs plain path, seqhw 40, {FLEXI_CHECK_B} "
        f"unseen images: loss {lk:.6f} vs {lp:.6f}, rel err {loss_err:.3e}; "
        f"student encoder output {tuple(xk.shape)} rel err {tok_err:.3e}; "
        f"{len(gp)} attention-projection gradients, worst rel err "
        f"{worst[0]:.3e} ({worst[1]}) (bar {E2E_BAR})")
  assert len(gp) == depth * 7
  assert loss_err <= E2E_BAR and tok_err <= E2E_BAR and worst[0] <= E2E_BAR


def distill_phase(fa, gpu):
  """Phase 6 with `FUSED_BLOCKED_BWD` set; returns the K5 launches of the
  last step at seqhw 40, as its counter read them."""
  workdir = os.path.join(ROOT, "build", "chip_smoke_distill")
  shutil.rmtree(workdir, ignore_errors=True)
  os.makedirs(workdir)
  teacher_npz = os.path.join(workdir, "vit_b8_random.npz")
  t0 = time.perf_counter()
  cls, pe = write_teacher(teacher_npz)
  print(f"teacher: random ViT-B/8 written to {os.path.basename(teacher_npz)}"
        f" ({os.path.getsize(teacher_npz) / 2**20:.1f} MiB, posemb "
        f"{(1, pe.shape[1] + 1, pe.shape[2])} at 224px) in "
        f"{time.perf_counter() - t0:.1f} s")
  with fused_blocked_bwd(fa):
    trainer = distill_main_path(fa, workdir, teacher_npz)
    teacher = trainer.teachers["prof"]
    assert torch.equal(teacher.cls.cpu(), torch.from_numpy(cls))
    assert tuple(teacher.pos_embedding.shape) == (1, 900, 768)
    assert teacher.head.weight.abs().max().item() > 0
    distill_resume(trainer, workdir)
    unseen, counts = distill_steps(fa, trainer, gpu)
    distill_kernel_vs_plain(fa, trainer, unseen, teacher_npz)
  del trainer, unseen
  torch.cuda.empty_cache()
  return {"K5": counts["K5"]}


# ----------------------------------------------------------------------------
# Phase 7: FlexiViT-B distilled from DeiT-III B/16, with its evals.
# ----------------------------------------------------------------------------


def write_deit3(path):
  """Writes a random ViT-B/16 from SEED in the layout of the DeiT-III B/16
  384px checkpoint: a 24x24 posemb, [cls], a 1000-class head with seeded
  nonzero weights (so that the student's logits differ between images)."""
  from big_vision_torch.models import vit
  from big_vision_torch.utils import checkpoints
  from big_vision_torch.utils import convert
  model = vit.Model(1000, variant="B/16", pool_type="tok", image_size=384,
                    device="cuda")
  gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
  model.initialize(gen)
  with torch.no_grad():
    model.head.weight.normal_(0.0, TEACHER_HEAD_STD, generator=gen)
  checkpoints.npz_save(convert.vit_params(model), path)


def deit3_want(depth, seqhw):
  """The launches of one DeiT-III distillation step at `seqhw` with attn=
  flash: the ViT-B/16 teacher's forward at 240px (T = 226, K1's f32
  kernel), and the student's forward and backward: at seqhw 30 and 40 K3,
  K4a and K4b, below K1's and K2's f32 kernels."""
  want = dict.fromkeys(COUNTERS, 0)
  want["K1f"] = depth
  for k in (("K3", "K4a", "K4b") if seqhw in (30, 40) else ("K1f", "K2f")):
    want[k] += depth
  return want


def deit3_phase(fa, gpu):
  """Phase 7: DEIT3_STEPS steps of the distill trainer's loop on
  i1k_deit3_distill.py (attn=flash), after its minival evals at step 0,
  then steps at seqhw 40, 30 and 15, twice (CUDA events, launches); the
  student's eval `pre_logits` against the plain path."""
  from big_vision_torch import train
  from big_vision_torch.trainers.proj.flexi import distill
  workdir = os.path.join(ROOT, "build", "chip_smoke_deit3")
  shutil.rmtree(workdir, ignore_errors=True)
  os.makedirs(workdir)
  npz = os.path.join(workdir, "deit3_B_384_1k_random.npz")
  t0 = time.perf_counter()
  write_deit3(npz)
  print(f"DeiT-III: random ViT-B/16 at 384px written to "
        f"{os.path.basename(npz)} ({os.path.getsize(npz) / 2**20:.1f} MiB) "
        f"in {time.perf_counter() - t0:.1f} s")
  args = f"init={npz},neval={DEIT3_NEVAL}"
  calls = {}
  reset_launches(fa)
  with counted_predict_fns(fa, calls):
    trainer = distill.main([
        "--config", f"{DEIT3_CONFIG}:{args},stop={DEIT3_STEPS},log=1,"
        "attn=flash", "--workdir", workdir])
  torch.cuda.synchronize()
  counts = launches(fa)
  depth = len(trainer.model.encoder.blocks)
  assert depth == len(trainer.teachers["prof"].encoder.blocks) == TRAIN_DEPTH
  assert tuple(trainer.model.pos_embedding.shape) == (1, 49, 768)
  assert tuple(trainer.teachers["prof"].pos_embedding.shape) == (1, 225, 768)
  draws = [trainer.step_kwargs(s)["seqhw"] for s in range(1, DEIT3_STEPS + 1)]
  want = {k: sum(deit3_want(depth, s)[k] for s in draws)
          + sum(c[k] for per_call in calls.values() for c in per_call)
          for k in COUNTERS}
  print(f"DeiT-III distillation: {DEIT3_STEPS} steps of batch "
        f"{trainer.batch_size}, seqhw drawn {draws}, after the minival evals "
        f"at step 0; launches {counts} (want {want})")
  assert counts == want, (counts, want)
  batches = -(-DEIT3_NEVAL // FLEXI_B)
  assert sorted(calls) == [f"student_seqhw={s}" for s in (10, 15, 30, 5)]
  assert all(len(c) == batches for c in calls.values()), calls.keys()
  with open(os.path.join(workdir, "big_vision_metrics.txt")) as f:
    all_rows = list(map(json.loads, f))
  [ev] = [r for r in all_rows if "minival_05/prec@1" in r]
  assert ev["step"] == 0
  for s in ("05", "10", "15", "30"):
    assert 0 <= ev[f"minival_{s}/prec@1"] <= 1, ev
    assert math.isfinite(ev[f"minival_{s}/loss"]), ev
  print("  step 0: " + ", ".join(
      f"minival_{s}/prec@1 {ev[f'minival_{s}/prec@1']:.6f} loss "
      f"{ev[f'minival_{s}/loss']:.6f}" for s in ("05", "10", "15", "30")))
  check_eval_launches(calls, depth, gpu, ev, {
      f"minival_{s}": DEIT3_NEVAL for s in ("05", "10", "15", "30")},
                      "DeiT-III student")
  rows = [r for r in all_rows if "training_loss" in r]
  assert [r["step"] for r in rows] == list(range(1, DEIT3_STEPS + 1)), rows
  for r in rows:
    print(f"  step {r['step']}: distill_loss {r['distill_loss']:.6f}, task "
          f"loss student {r['task_loss_student']:.6f} teacher "
          f"{r['task_loss_prof']:.6f}, {r['step_ms']:.3f} ms")
    assert math.isfinite(r["distill_loss"]) and r["distill_loss"] > 0, r

  it = trainer.input_iter()
  batch = next(it)
  it.close()
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  times = {}
  for seqhw in FLEXI_CYCLE:
    reset_launches(fa)
    start.record()
    loss = trainer.update(batch, seqhw=seqhw)["training_loss"]
    end.record()
    end.synchronize()
    assert math.isfinite(loss.item()) and loss.item() > 0, (seqhw, loss)
    assert launches(fa) == deit3_want(depth, seqhw), (seqhw, launches(fa))
    times.setdefault(seqhw, []).append(start.elapsed_time(end))
  for seqhw, ms in times.items():
    used = {k: n for k, n in deit3_want(depth, seqhw).items() if n}
    print(f"[{gpu}] DeiT-III distillation, FlexiViT-B/16 student at seqhw "
          f"{seqhw} (T={seqhw * seqhw + 1}) from ViT-B/16 (T=226), batch "
          f"{FLEXI_B}: step {', '.join(f'{x:.3f}' for x in ms)} ms; "
          f"launches per step {used}")
  evals = eval_batches(train.load_config(f"{DEIT3_CONFIG}:{args}"))
  plain = distill.Trainer(train.load_config(f"{DEIT3_CONFIG}:{args},"
                                            "attn=xla"))
  plain.model.load_state_dict(trainer.model.state_dict())
  eval_pre_logits_vs_plain(fa, trainer, plain, evals, "DeiT-III student")
  del trainer, plain, batch, evals
  torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# Phase 8: the generic distill trainer on its smoke config.
# ----------------------------------------------------------------------------


def distill_smoke_phase(fa):
  """Phase 8: configs/proj/distill/smoke.py through the generic distill
  trainer at its own size (ViT-mu/16 at 32px, batch 16, 10 steps), from a
  random teacher written with its seed: finite distill losses, and the
  `val` and `distance` rows at steps 0 and 10."""
  from big_vision_torch.models import vit
  from big_vision_torch.trainers.proj.distill import distill
  from big_vision_torch.utils import checkpoints
  from big_vision_torch.utils import convert
  workdir = os.path.join(ROOT, "build", "chip_smoke_distill_smoke")
  shutil.rmtree(workdir, ignore_errors=True)
  os.makedirs(workdir)
  teacher = vit.Model(10, variant="mu/16", posemb="sincos2d",
                      head_zeroinit=False, image_size=32, device="cuda")
  teacher.initialize(torch.Generator(device="cuda").manual_seed(SEED + 13))
  npz = os.path.join(workdir, "teacher.npz")
  checkpoints.npz_save(convert.vit_params(teacher), npz)
  reset_launches(fa)
  trainer = distill.main(["--config",
                          f"{SMOKE_DISTILL_CONFIG}:teacher_init={npz}",
                          "--workdir", workdir])
  torch.cuda.synchronize()
  counts = {k: n for k, n in launches(fa).items() if n}
  with open(os.path.join(workdir, "big_vision_metrics.txt")) as f:
    all_rows = list(map(json.loads, f))
  steps = [r for r in all_rows if "training_loss" in r]
  assert [r["step"] for r in steps] == [5, 10], steps
  for r in steps:
    assert math.isfinite(r["distill_loss"]) and r["distill_loss"] > 0, r
  evals = [r for r in all_rows if "val/prec@1" in r]
  assert [r["step"] for r in evals] == [0, 10], evals
  for r in evals:
    dist = {k: v for k, v in r.items() if k.startswith("distance/")}
    assert len(dist) == 9 and all(map(math.isfinite, dist.values())), r
    print(f"  step {r['step']}: val/prec@1 {r['val/prec@1']:.6f}, "
          + ", ".join(f"{k} {v:.6f}" for k, v in dist.items()
                      if k.endswith("/avg")))
  # T = 4 tokens: the JAX package's gate (`flash_attention.supports`, T >=
  # 16) takes the plain path, so no kernel runs on this path.
  print(f"generic distillation smoke: ViT-mu/16 at 32px, "
        f"{trainer.total_steps} steps of batch {trainer.batch_size}, "
        f"distill_loss {steps[0]['distill_loss']:.6f} -> "
        f"{steps[-1]['distill_loss']:.6f}; launches {counts} (T = 4: the "
        f"plain path, as the JAX package's gate decides)")
  assert not counts, counts


# ----------------------------------------------------------------------------
# Phase 9: the ImageNet recipes, RandAugment, the other optimizers.
# ----------------------------------------------------------------------------


def randaug_ops_vs_cpu(gpu):
  """Each of the 16 RandAugment ops (`pp.autoaugment.apply_op`, the drawn
  signs and centres given) on RECIPE_OP_N images of 224x224 on the card
  against the same op on the CPU, at magnitudes 10 and 15: uint8-equal,
  but for `sharpness` and `rotate`, where at most RANDAUG_OP_SHARE of the
  pixels may differ (by one level of the smoothing, times |1 - factor|
  after the blend, for sharpness)."""
  from big_vision_torch.pp import autoaugment as aa
  gen = torch.Generator().manual_seed(SEED)
  n = RECIPE_OP_N
  lo = torch.randint(0, 128, (n, 1, 1, 1), generator=gen)
  span = torch.randint(1, 129, (n, 1, 1, 1), generator=gen)
  images = (lo + torch.rand((n, 224, 224, 3), generator=gen) * span).to(
      torch.uint8)
  images[0, ..., 1] = 77  # a flat channel
  worst = {}
  for magnitude in (10, 15):
    negate = torch.randint(2, (n,), generator=gen).bool()
    cy, cx = (torch.randint(224, (n,), generator=gen) for _ in range(2))
    for op in aa.OP_NAMES:
      kw = dict(negate=negate, cy=cy, cx=cx)
      want = aa.apply_op(images, op, magnitude, **kw)
      got = aa.apply_op(images.cuda(), op, magnitude, **kw).cpu()
      diff = (got.int() - want.int()).abs()
      share = (diff > 0).float().mean().item()
      worst[op] = max(worst.get(op, 0.0), share)
      if op in ("Sharpness", "Rotate"):
        levels = max(1, math.ceil(abs(1 - aa.levels(magnitude)["enhance"])))
        assert share <= RANDAUG_OP_SHARE, (op, magnitude, share)
        assert op == "Rotate" or diff.max().item() <= levels, (op, diff.max())
      else:
        assert share == 0.0, (op, magnitude, share)
  print(f"[{gpu}] RandAugment: the 16 ops on {n} images of 224x224 on the "
        f"card vs the CPU at magnitudes 10 and 15: uint8-equal but for "
        f"Sharpness and Rotate (at most {RANDAUG_OP_SHARE} of the pixels): "
        f"share of pixels that differ, Sharpness {worst['Sharpness']:.3e}, "
        f"Rotate {worst['Rotate']:.3e}; the other 14 ops 0")


def write_vit(path, variant, rep_size, seed):
  """Writes a random ViT (224px, GAP, sincos2d posemb, 1000 classes, the
  tanh pre-logits layer with `rep_size`) from `seed` as an `.npz` in the
  JAX layout: the stand-in for a published checkpoint."""
  from big_vision_torch.models import vit
  from big_vision_torch.utils import checkpoints
  from big_vision_torch.utils import convert
  model = vit.Model(1000, variant=variant, pool_type="gap", posemb="sincos2d",
                    rep_size=rep_size, device="cuda")
  model.initialize(torch.Generator(device="cuda").manual_seed(seed))
  checkpoints.npz_save(convert.vit_params(model), path)
  return path


def recipe_module(recipe):
  """The module whose `main` and `Trainer` train the recipe: `train`, or
  the recipe's own trainer."""
  import importlib
  return importlib.import_module(recipe.get("trainer",
                                            "big_vision_torch.train"))


def recipe_main_path(fa, recipe, workdir, gpu, steps=RECIPE_STEPS):
  """`steps` steps of `train.main` on the recipe's config after its
  evals at step 0; asserts the launches of every step and eval batch.
  Returns (trainer, {"step_ms", "img/sec", "input_stall_pct": medians of
  the rows after the first; "peak": max memory allocated})."""
  main = recipe_module(recipe).main
  shutil.rmtree(workdir, ignore_errors=True)
  calls = {}
  reset_launches(fa)
  torch.cuda.reset_peak_memory_stats()
  with counted_predict_fns(fa, calls):
    trainer = main(["--config", f"{recipe['config']}:"
                    f"{recipe['args']}stop={steps},log=1",
                    "--workdir", workdir])
  torch.cuda.synchronize()
  peak = torch.cuda.max_memory_allocated()
  counts = launches(fa)
  vit = recipe["model"] == "vit"
  depth = len(trainer.model.encoder.blocks) if vit else 0
  n_eval = sum(len(c) for c in calls.values())
  per_step = depth * recipe.get("passes", 1)
  want = {**dict.fromkeys(COUNTERS, 0),
          "K1f": per_step * steps + depth * n_eval,
          "K2f": per_step * steps}
  per_batch = {**dict.fromkeys(COUNTERS, 0), "K1f": depth}
  assert all(c == per_batch for cs in calls.values() for c in cs), calls
  print(f"{recipe['name']}: {steps} steps of batch "
        f"{trainer.batch_size}, {trainer.config['input']['pp']!r}, after "
        f"{n_eval} eval batches at step 0 ({sorted(trainer.config['evals'])}"
        f"); launches {({k: n for k, n in counts.items() if n})} (want "
        f"{({k: n for k, n in want.items() if n})}: per step "
        f"{per_step} K1f and {per_step} K2f, per eval batch {depth} K1f)")
  assert counts == want, (counts, want)
  assert trainer.batch_size == recipe["batch"], trainer.batch_size
  assert "randaug" in trainer.config["input"]["pp"] or not recipe["randaug"]
  with open(os.path.join(workdir, "big_vision_metrics.txt")) as f:
    all_rows = list(map(json.loads, f))
  [ev] = [r for r in all_rows if any(k.endswith("/prec@1") for k in r)]
  assert ev["step"] == 0, ev
  for name in trainer.config["evals"]:
    assert 0 <= ev[f"{name}/prec@1"] <= 1, ev
    assert math.isfinite(ev[f"{name}/loss"]), ev
  rows = [r for r in all_rows if "training_loss" in r]
  assert [r["step"] for r in rows] == list(range(1, steps + 1)), rows
  for r in rows:
    assert math.isfinite(r["training_loss"]), r
  e2e = {k: statistics.median(r[k] for r in rows[1:])
         for k in ("step_ms", "img/sec", "input_stall_pct")}
  e2e["peak"] = peak
  print(f"  step 0 evals: " + ", ".join(
      f"{n}/prec@1 {ev[f'{n}/prec@1']:.6f}" for n in trainer.config["evals"])
        + "; losses " + " ".join(f"{r['training_loss']:.6f}" for r in rows))
  return trainer, e2e


def recipe_fixed_steps(trainer, gpu, what, steps=RECIPE_FIXED_STEPS):
  """`steps` updates on one batch, timed with CUDA events (the
  step without the input pipeline); the loss on that batch (no mixup, no
  stochastic depth) must fall. Returns (the batch, the next batch, which
  no update saw, ms per step)."""
  it = trainer.input_iter()
  batch, unseen = next(it), next(it)
  it.close()

  def loss():
    with torch.no_grad():
      logits, _ = trainer.model(batch["image"])
      return trainer.loss_fn(logits=logits, labels=batch["labels"]).item()

  before = loss()
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  for _ in range(steps):
    trainer.update(batch)
  end.record()
  end.synchronize()
  after = loss()
  ms = start.elapsed_time(end) / steps
  print(f"[{gpu}] {what}: fixed batch, {steps} steps of "
        f"{ms:.3f} ms (CUDA events); its loss {before:.6f} -> {after:.6f}")
  assert math.isfinite(after) and after < before, (before, after)
  return batch, unseen, ms


@contextlib.contextmanager
def attention_checked_in_place(fa, k1_rows, k2_rows):
  """While open, each attention call of a model (on the one-shot f32
  kernels) is held against the plain versions on its own inputs, one layer
  at a time so that no layer's tensors are kept: K1's o (a repeat launch,
  equal to the one the model took) and LSE, and once the backward has
  given the layer its do, K2's dq, dk and dv."""
  from big_vision_torch.ops import attention
  orig = attention.dot_product_attention

  def checked(q, k, v, **kw):
    layer = len(k1_rows) // 2
    out = orig(q, k, v, **kw)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    o, lse = fa.flash_attention_forward(qd, kd, vd)
    assert torch.equal(o, out.detach()), layer
    k1_rows.append((rel_err(o, fa.flash_attention_reference(qd, kd, vd)),
                    f"layer {layer} o"))
    k1_rows.append((rel_err(lse, fa.flash_attention_lse_reference(
        qd, kd, vd)), f"layer {layer} lse"))
    del o, lse
    grads = {}

    def keep(name, g):
      grads[name] = g
      if len(grads) == 4:  # do, dq, dk, dv
        want = fa.flash_attention_bwd_reference(qd, kd, vd, grads["do"])
        for n, w in zip(("dq", "dk", "dv"), want):
          assert w.abs().max().item() > 0, (layer, n)
          k2_rows.append((rel_err(grads[n], w), f"layer {layer} {n}"))
        grads.clear()

    out.register_hook(functools.partial(keep, "do"))
    for name, x in (("dq", q), ("dk", k), ("dv", v)):
      x.register_hook(functools.partial(keep, name))
    return out

  attention.dot_product_attention = checked
  try:
    yield
  finally:
    attention.dot_product_attention = orig


def recipe_in_place(fa, trainer, batch, what):
  """Every K1 and K2 launch (their f32 kernels) of one forward and
  backward on `batch`, at the config's full batch, against the plain
  versions on its own inputs within F32_BAR."""
  k1_rows, k2_rows = [], []
  for p in trainer.params.values():
    p.grad = None
  with attention_checked_in_place(fa, k1_rows, k2_rows):
    logits, _ = trainer.model(batch["image"])
    trainer.loss_fn(logits=logits, labels=batch["labels"]).backward()
  torch.cuda.synchronize()
  for p in trainer.params.values():
    p.grad = None
  depth = len(trainer.model.encoder.blocks)
  heads = trainer.model.encoder.blocks[0].attn.num_heads
  b = batch["image"].shape[0]
  for what_k, rows, n in (("K1 (f32) forward", k1_rows, 2 * depth),
                          ("K2 (f32) backward", k2_rows, 3 * depth)):
    assert len(rows) == n, (what_k, len(rows))
    rows.sort(reverse=True)
    print(f"{what}: {what_k} in place, batch {b} x {heads} heads "
          f"(B*H = {b * heads}): {len(rows)} outputs of {depth} "
          f"launches against the plain version, the 3 worst (bar "
          f"{F32_BAR}): " + ", ".join(f"{nm} {e:.3e}" for e, nm in rows[:3]))
    assert all(e <= F32_BAR for e, _ in rows), rows[:3]


def recipe_kernel_vs_plain(fa, trainer, recipe, batch, what):
  """The kernel path against the plain path (the config's attn=xla, the
  same weights) on RECIPE_CHECK_B images no update saw: the loss, the
  encoder output and every attention-projection gradient (key/bias left
  out: zero in exact arithmetic) within F32_BAR of the plain path's."""
  from big_vision_torch import train
  batch = {k: v[:RECIPE_CHECK_B] for k, v in batch.items()}

  def run(t):
    for p in t.params.values():
      p.grad = None
    tokens = []
    hook = t.model.encoder.register_forward_hook(
        lambda mod, args, out: tokens.append(out.detach().clone()))
    logits, _ = t.model(batch["image"])
    loss = t.loss_fn(logits=logits, labels=batch["labels"])
    loss.backward()
    hook.remove()
    return loss.item(), tokens[0], {n: p.grad.clone() for n, p in
                                    t.params.items() if _attn_projection(n)}

  reset_launches(fa)
  lk, xk, gk = run(trainer)
  torch.cuda.synchronize()
  depth = len(trainer.model.encoder.blocks)
  assert launches(fa) == {**dict.fromkeys(COUNTERS, 0), "K1f": depth,
                          "K2f": depth}, launches(fa)
  plain = recipe_module(recipe).Trainer(train.load_config(
      f"{recipe['config']}:{recipe['args']}attn=xla"))
  plain.model.load_state_dict(trainer.model.state_dict())
  reset_launches(fa)
  lp, xp, gp = run(plain)
  assert launches(fa) == dict.fromkeys(COUNTERS, 0), launches(fa)
  del plain
  loss_err, tok_err = abs(lk - lp) / abs(lp), rel_err(xk, xp)
  worst = max((rel_err(gk[n], gp[n]), n) for n in gp)
  print(f"{what} kernel vs plain path (attn=xla), {RECIPE_CHECK_B} unseen "
        f"images: loss {lk:.6f} vs {lp:.6f}, rel err {loss_err:.3e}; "
        f"encoder output {tuple(xk.shape)} rel err {tok_err:.3e}; "
        f"{len(gp)} attention-projection gradients, worst rel err "
        f"{worst[0]:.3e} ({worst[1]}) (bar {F32_BAR})")
  assert len(gp) == depth * 7
  assert loss_err <= F32_BAR and tok_err <= F32_BAR and worst[0] <= F32_BAR


def gsam_kernel_vs_plain(fa, trainer, recipe, batch, what):
  """The GSAM gradient of the kernel path against the plain path's
  (attn=xla, the same weights and step) on RECIPE_CHECK_B images no update
  saw: its 2 x depth launches of K1's and K2's f32 kernels (both passes),
  the clean loss within F32_BAR and the gradient (its l2 distance over its
  l2 norm) within GSAM_BAR."""
  from big_vision_torch import optim
  from big_vision_torch import train
  from big_vision_torch.trainers.proj.gsam import gsam
  x, y = batch["image"][:RECIPE_CHECK_B], batch["labels"][:RECIPE_CHECK_B]
  step = optim.get_count(trainer.opt_state)
  lr = trainer.learning_rate(step)

  def run(t):
    return gsam.gsam_gradient(lambda p, a, b: t.loss_at(p, a, b, step),
                              t.params, x, y, lr=lr, **t.gsam_kw)

  reset_launches(fa)
  lk, gk = run(trainer)
  torch.cuda.synchronize()
  depth = len(trainer.model.encoder.blocks)
  assert launches(fa) == {**dict.fromkeys(COUNTERS, 0), "K1f": 2 * depth,
                          "K2f": 2 * depth}, launches(fa)
  plain = gsam.Trainer(train.load_config(
      f"{recipe['config']}:{recipe['args']}attn=xla"))
  plain.model.load_state_dict(trainer.model.state_dict())
  reset_launches(fa)
  lp, gp = run(plain)
  torch.cuda.synchronize()
  assert launches(fa) == dict.fromkeys(COUNTERS, 0), launches(fa)
  del plain
  diff = sum(torch.sum((gk[n] - gp[n]) ** 2) for n in gp)
  err = torch.sqrt(diff / sum(torch.sum(g ** 2) for g in gp.values())).item()
  loss_err = abs(lk.item() - lp.item()) / abs(lp.item())
  print(f"{what} GSAM gradient at step {step} (lr {lr:.3e}), kernel vs "
        f"plain path (attn=xla), {RECIPE_CHECK_B} unseen images: clean "
        f"loss {lk.item():.6f} vs {lp.item():.6f}, rel err {loss_err:.3e} "
        f"(bar {F32_BAR}); gradient rel l2 err {err:.3e} (bar {GSAM_BAR}); "
        f"{2 * depth} K1f and {2 * depth} K2f launches")
  assert loss_err <= F32_BAR and err <= GSAM_BAR, (loss_err, err)


def batch_headroom(trainer, gpu, what, make_batch=None):
  """One update at twice the trainer's batch, on random inputs
  (`make_batch(b)`; by default images and one-hot labels of the config's
  classes): whether the card holds it (its peak memory) or runs out of
  memory, which makes the config's batch the largest power of two that
  fits. Returns whether it fit."""
  b = 2 * trainer.batch_size
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()

  def classification_batch(b):
    n = trainer.config["num_classes"]
    return {"image": torch.randn((b, 224, 224, 3), device="cuda"),
            "labels": torch.nn.functional.one_hot(
                torch.arange(b, device="cuda") % n, n).float()}

  try:
    batch = (make_batch or classification_batch)(b)
    trainer.update(batch)
    torch.cuda.synchronize()
    print(f"[{gpu}] {what}: an update at batch {b} fits, max memory "
          f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB: "
          f"the batch could be {b}")
    return True
  except torch.OutOfMemoryError:
    print(f"[{gpu}] {what}: an update at batch {b} runs out of memory "
          f"(max memory allocated before it failed "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB): "
          f"{trainer.batch_size} is the largest power of two that fits")
    return False
  finally:
    batch = None
    gc.collect()
    torch.cuda.empty_cache()


def randaug_time(recipe, batch_size, step_ms, gpu):
  """ms per batch of the recipe's `randaug` on batch_size uint8 images of
  224x224 on the card (CUDA events around the device op, its one copy of
  the draws to the host included), and its share of the end-to-end step."""
  import re
  from big_vision_torch.pp import builder as pp_builder
  from big_vision_torch import input_pipeline
  spec = re.search(r"randaug\([^)]*\)", recipe["pp"]).group(0)
  pfn = pp_builder.get_preprocess_fn(spec)
  images = torch.randint(0, 256, (batch_size, 224, 224, 3),
                         dtype=torch.uint8, device="cuda")
  pfn.device({"image": images}, input_pipeline.step_generator(0, 0, "cuda"))
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  times = []
  for step in range(1, 4):
    gen = input_pipeline.step_generator(0, step, "cuda")
    start.record()
    pfn.device({"image": images}, gen)
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  ms = statistics.median(times)
  print(f"[{gpu}] {recipe['name']}: {spec} on {batch_size} images of "
        f"224x224: {', '.join(f'{x:.3f}' for x in times)} ms per batch "
        f"(median {ms:.3f}), {100 * ms / step_ms:.2f}% of the end-to-end "
        f"step ({step_ms:.3f} ms)")
  return ms


def optimizer_states(batch, gpu):
  """RECIPE_OPT_STEPS steps of ViT-S/16 (vit_s16_i1k.py) under
  `big_vision.scale_by_adafactor` and under `big_vision.momentum_hp` on
  one batch: finite losses and states, the states in bf16 where the JAX
  package keeps them in bf16 (the momentum_hp trace, Adafactor's ema) and
  in f32 elsewhere (Adafactor's factored second moments)."""
  from big_vision_torch import train
  config_file = RECIPES[0]["config"]
  want = {"big_vision.scale_by_adafactor": {
              "v_row": torch.float32, "v_col": torch.float32,
              "v": torch.float32, "ema": torch.bfloat16},
          "big_vision.momentum_hp": {"trace": torch.bfloat16}}
  for name, dtypes in want.items():
    config = train.load_config(config_file)
    config.update(optax_name=name, optax={})
    trainer = train.Trainer(config)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    losses = [trainer.update(batch)["training_loss"]
              for _ in range(RECIPE_OPT_STEPS)]
    end.record()
    end.synchronize()
    losses = [x.item() for x in losses]
    state = trainer.opt_state
    assert all(math.isfinite(x) for x in losses), (name, losses)
    assert sorted(k for k in state if k != "count") == sorted(dtypes), state
    sizes = {}
    for key, dtype in dtypes.items():
      tensors = list(state[key].values())
      assert tensors and all(x.dtype == dtype for x in tensors), (name, key)
      assert all(torch.isfinite(x).all() for x in tensors), (name, key)
      sizes[key] = (len(tensors), sum(x.numel() * x.element_size()
                                      for x in tensors))
    assert state["count"] == RECIPE_OPT_STEPS
    print(f"[{gpu}] ViT-S/16 under {name}, batch {batch['image'].shape[0]}: "
          f"{RECIPE_OPT_STEPS} steps of "
          f"{start.elapsed_time(end) / RECIPE_OPT_STEPS:.3f} ms, losses "
          + " ".join(f"{x:.6f}" for x in losses) + "; state "
          + ", ".join(f"{k} {dtypes[k]} ({n} tensors, {b / 2**20:.1f} MiB)"
                      for k, (n, b) in sizes.items()) + ", all finite")
    del trainer, state
    torch.cuda.empty_cache()


def recipes_phase(fa, gpu):
  """Phase 9: the 16 RandAugment ops on the card, then each recipe of
  RECIPES through `train.main` at full width with its randaug (launches
  exact, step ms, img/s, input stall, peak memory, randaug ms), the loss
  falling on a fixed batch, the kernel path against attn=xla, K1's and
  K2's f32 kernels in place at ViT-S/16's B*H = 6144; then the other
  optimizers on ViT-S/16."""
  t0 = time.perf_counter()
  # ViT-S/16 at its JAX batch of 1024 peaks at about 76 of the card's 79
  # GiB: nothing of the earlier phases may stay on the card.
  gc.collect()
  torch.cuda.empty_cache()
  randaug_ops_vs_cpu(gpu)
  os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
  # The stand-in for the JAX config's "i1k-s16-300ep".
  init = write_vit(os.path.join(ROOT, "build", "chip_smoke_vit_s16.npz"),
                   "S/16", rep_size=True, seed=SEED + 17)
  opt_batch = None
  for recipe in RECIPES:
    t1 = time.perf_counter()
    recipe = dict(recipe, args=recipe["args"].format(init=init))
    workdir = os.path.join(ROOT, "build", f"chip_smoke_{recipe['name']}")
    trainer, e2e = recipe_main_path(fa, recipe, workdir, gpu)
    what = f"{recipe['name']} ({recipe['what']})"
    batch, unseen, fixed_ms = recipe_fixed_steps(trainer, gpu, what)
    from big_vision_torch.tools import bench_decode
    bench_decode.print_profile(kernel_timing.device_profile(
        {f"{recipe['name']} step": lambda: trainer.update(batch)}, top=8),
        prefix=f"[{gpu}] ")
    print(f"[{gpu}] {what}, batch {trainer.batch_size}: end to end "
          f"{e2e['step_ms']:.3f} ms/step, {e2e['img/sec']:.1f} img/s, input "
          f"stall {e2e['input_stall_pct']:.3f}% (median of steps 2-"
          f"{RECIPE_STEPS}); fixed batch {fixed_ms:.3f} ms/step; max memory "
          f"allocated {e2e['peak'] / 2**30:.2f} GiB (of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f})")
    if recipe["randaug"]:
      recipe["pp"] = trainer.config["input"]["pp"]
      randaug_time(recipe, trainer.batch_size, e2e["step_ms"], gpu)
    if recipe["model"] == "vit":
      recipe_kernel_vs_plain(fa, trainer, recipe, unseen, what)
      if recipe["name"] == "vit_s16_i1k":
        recipe_in_place(fa, trainer, unseen, what)
        opt_batch = batch
    if recipe.get("passes") == 2:
      gsam_kernel_vs_plain(fa, trainer, recipe, unseen, what)
    del batch, unseen
    if recipe.get("headroom"):
      batch_headroom(trainer, gpu, what)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{recipe['name']}: {time.perf_counter() - t1:.1f} s wall")
  optimizer_states(opt_batch, gpu)
  os.remove(init)
  print(f"ImageNet recipes phase: {time.perf_counter() - t0:.1f} s wall")


def twin_data(steps, batch, seed=7):
  """The dynamics twin's data, as the JAX package's tools/dynamics_twin.py
  (`make_data`) draws it: a learnable 10-class set, class prototype plus
  noise, f32 images [steps * batch, 32, 32, 3] and one-hot labels."""
  n = steps * batch
  rng = np.random.default_rng(seed)
  protos = rng.normal(0, 1, (10, 32, 32, 3)).astype(np.float32)
  labels = rng.integers(0, 10, n)
  images = (0.5 * protos[labels]
            + rng.normal(0, 1, (n, 32, 32, 3))).astype(np.float32)
  onehot = np.zeros((n, 10), np.float32)
  onehot[np.arange(n), labels] = 1.0
  return {"image": images, "labels": onehot}


def metric_rows(workdir):
  with open(os.path.join(workdir, "big_vision_metrics.txt")) as f:
    return list(map(json.loads, f))


def quality_digits_run(fa, gpu):
  """configs/quality_digits.py through `train.main` at its own size (2000
  steps of batch 256 on the 1437 training scans, its eval of the 360 test
  scans every 200 steps, checkpoints every 500): launches exact (6 of K1's
  and 6 of K2's f32 kernels a step, 6 of K1's an eval batch), and
  val/prec@1 at step 2000 at least the config's EXPECTED."""
  from big_vision_torch import train
  from big_vision_torch.configs import quality_digits
  workdir = os.path.join(ROOT, "build", "chip_smoke_quality")
  npz_dir = os.path.join(ROOT, "build", "chip_smoke_digits")
  for d in (workdir, npz_dir):
    shutil.rmtree(d, ignore_errors=True)
  calls = {}
  reset_launches(fa)
  t0 = time.perf_counter()
  with counted_predict_fns(fa, calls):
    trainer = train.main(["--config", f"{QUALITY_CONFIG}:npz_dir={npz_dir}",
                          "--workdir", workdir])
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  counts = launches(fa)
  depth, steps = len(trainer.model.encoder.blocks), trainer.total_steps
  n_eval = sum(len(c) for c in calls.values())
  want = {**dict.fromkeys(COUNTERS, 0), "K1f": depth * (steps + n_eval),
          "K2f": depth * steps}
  per_batch = {**dict.fromkeys(COUNTERS, 0), "K1f": depth}
  assert all(c == per_batch for cs in calls.values() for c in cs), calls
  assert counts == want, (counts, want)
  rows = metric_rows(workdir)
  evals = [r for r in rows if "val/prec@1" in r]
  final = evals[-1]
  train_rows = [r for r in rows if "training_loss" in r]
  step_ms = statistics.median(r["step_ms"] for r in train_rows[1:])
  print(f"quality_digits: {steps} steps of batch {trainer.batch_size}, "
        f"{n_eval} eval batches; launches "
        f"{({k: n for k, n in counts.items() if n})} (want {depth} K1f and "
        f"{depth} K2f a step, {depth} K1f an eval batch)")
  print(f"  val/prec@1 at steps " + ", ".join(
      f"{r['step']}: {r['val/prec@1']:.6f}" for r in evals))
  print(f"[{gpu}] quality_digits at step {final['step']}: val/prec@1 "
        f"{final['val/prec@1']:.6f} (EXPECTED >= "
        f"{quality_digits.EXPECTED['val/prec@1']}), val/loss "
        f"{final['val/loss']:.6f}, training_loss "
        f"{train_rows[-1]['training_loss']:.6f}; step {step_ms:.3f} ms "
        f"(median of the logged windows), img/s "
        f"{statistics.median(r['img/sec'] for r in train_rows[1:]):.1f}, "
        f"input stall "
        f"{statistics.median(r['input_stall_pct'] for r in train_rows[1:]):.3f}"
        f"%; {wall:.1f} s wall")
  assert final["step"] == steps == 2000, final
  for k, bar in quality_digits.EXPECTED.items():
    assert final[k] >= bar, (k, final[k], bar)
  digits_step_parts(trainer, gpu)


def digits_step_parts(trainer, gpu):
  """Where quality_digits' step goes: QUALITY_PARTS_STEPS updates on one
  batch (CUDA events: the step without the input pipeline), as many
  batches of the input pipeline alone (host clock, after its first), and
  one update under the profiler (device busy)."""
  from big_vision_torch.tools import bench_decode
  it = trainer.input_iter()
  batch = next(it)
  it.close()  # its threads would compete with the step for the host
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  for _ in range(QUALITY_PARTS_STEPS):
    trainer.update(batch)
  end.record()
  end.synchronize()
  fixed_ms = start.elapsed_time(end) / QUALITY_PARTS_STEPS
  it = trainer.input_iter()
  next(it)
  t0 = time.perf_counter()
  for _ in range(QUALITY_PARTS_STEPS):
    next(it)
  torch.cuda.synchronize()
  input_ms = 1e3 * (time.perf_counter() - t0) / QUALITY_PARTS_STEPS
  it.close()
  bench_decode.print_profile(kernel_timing.device_profile(
      {"quality_digits step": lambda: trainer.update(batch)}, top=6),
      prefix=f"[{gpu}] ")
  print(f"[{gpu}] quality_digits: fixed batch {fixed_ms:.3f} ms/step (CUDA "
        f"events, {QUALITY_PARTS_STEPS} steps); the input pipeline alone "
        f"{input_ms:.3f} ms/batch ({QUALITY_PARTS_STEPS} batches, "
        f"{trainer.config['input']['num_threads']} pp threads)")


def twin_run(fa, gpu):
  """configs/twin_dynamics.py at its full size (width 128, depth 2, batch
  64, TWIN_STEPS steps) twice from one random init, under attn "auto" (K1's
  and K2's f32 kernels at T=64, D=32: depth of each a step) and under
  attn=xla (no kernel): every step's training_loss within TWIN_BAR
  relative."""
  from big_vision_torch import train
  from big_vision_torch.models import vit
  from big_vision_torch.utils import checkpoints
  from big_vision_torch.utils import convert
  base = os.path.join(ROOT, "build", "chip_smoke_twin")
  shutil.rmtree(base, ignore_errors=True)
  os.makedirs(base)
  npz, init = os.path.join(base, "data.npz"), os.path.join(base, "init.npz")
  np.savez(npz, **twin_data(TWIN_STEPS, TWIN_BATCH))
  model = vit.Model(10, width=TWIN_WIDTH, depth=TWIN_DEPTH,
                    mlp_dim=4 * TWIN_WIDTH, num_heads=4, patch_size=(4, 4),
                    posemb="learn", pool_type="gap", rep_size=False,
                    image_size=32, device="cuda")
  model.initialize(torch.Generator(device="cuda").manual_seed(SEED + 23))
  checkpoints.npz_save(convert.vit_params(model), init)
  del model
  legs = {}
  for attn, kernels in (("auto", ("K1f", "K2f")), ("xla", ())):
    workdir = os.path.join(base, attn)
    config = train.load_config(
        f"{TWIN_CONFIG}:npz={npz},steps={TWIN_STEPS},batch={TWIN_BATCH},"
        f"width={TWIN_WIDTH},depth={TWIN_DEPTH},attn={attn}")
    config["model_init"] = init
    reset_launches(fa)
    t0 = time.perf_counter()
    train.train(config, workdir)
    torch.cuda.synchronize()
    counts = launches(fa)
    want = {**dict.fromkeys(COUNTERS, 0),
            **dict.fromkeys(kernels, TWIN_DEPTH * TWIN_STEPS)}
    assert counts == want, (attn, counts, want)
    legs[attn] = [r for r in metric_rows(workdir) if "training_loss" in r]
    print(f"[{gpu}] twin_dynamics attn={attn}: {TWIN_STEPS} steps in "
          f"{time.perf_counter() - t0:.1f} s wall, launches "
          f"{({k: n for k, n in counts.items() if n}) or 'none'}; loss "
          f"{legs[attn][0]['training_loss']:.6f} -> "
          f"{legs[attn][-1]['training_loss']:.6f}")
  kernel, plain = legs["auto"], legs["xla"]
  assert [r["step"] for r in kernel] == [r["step"] for r in plain] == list(
      range(1, TWIN_STEPS + 1))
  worst = {}
  for m in ("training_loss", "l2_grads", "l2_params", "l2_updates",
            "global_schedule"):
    rel = [abs(k[m] - p[m]) / max(abs(p[m]), 1e-12)
           for k, p in zip(kernel, plain)]
    worst[m] = max(zip(rel, range(1, TWIN_STEPS + 1)))
  print(f"twin_dynamics kernel path (auto) vs plain path (xla), worst "
        f"relative difference over {TWIN_STEPS} steps (step): " + ", ".join(
            f"{m} {e:.3e} ({s})" for m, (e, s) in worst.items())
        + f"; training_loss held to {TWIN_BAR} at every step")
  assert worst["training_loss"][0] <= TWIN_BAR, worst
  assert plain[-1]["training_loss"] < plain[0]["training_loss"]
  shutil.rmtree(base, ignore_errors=True)


def quality_phase(fa, gpu):
  """The quality phase: quality_digits trained to its pin on the card, then
  the dynamics twin, kernel path against plain path."""
  t0 = time.perf_counter()
  gc.collect()
  torch.cuda.empty_cache()
  quality_digits_run(fa, gpu)
  twin_run(fa, gpu)
  print(f"quality phase: {time.perf_counter() - t0:.1f} s wall")


def matmul_peak_tflops(n=8192, iters=20):
  """bf16 [n, n] x [n, n] TFLOP/s between CUDA events (the MFU yardstick)."""
  a = torch.randn((n, n), device="cuda").to(torch.bfloat16)
  b = torch.randn((n, n), device="cuda").to(torch.bfloat16)
  return 2 * n ** 3 / (time_ms(torch.matmul, [(a, b)], iters=iters) * 1e9)


def serving_phase(fa, da, gpu, profiles=True):
  """Phase 3 and the serving times: the bf16 KV cache, then the int8 one
  with the same weights (with `profiles`, also the plain paths' times and
  a profiled decode of each kernel path); then int8 weights, beam search
  and best-of-n, video and the runner. Returns the launch counts."""
  from big_vision_torch.tools import bench_decode
  t0 = time.perf_counter()
  build = functools.partial(bench_decode.build_model, "gemma_2b",
                            "So400m/14", RES)
  model = build(seed=SEED)
  plain = build(kernels=False, like=model)
  n_params = sum(p.numel() for p in model.parameters())
  batch = bench_decode.make_batch(BATCH, RES, PROMPT, 256_000, "cuda", SEED)
  print(f"PaliGemma-3B: {n_params / 1e9:.3f} B params (bf16), built in "
        f"{time.perf_counter() - t0:.1f} s")
  counts = serve(model, plain, batch, fa, da)
  int8 = build(cache_dtype="int8", like=model)
  int8_plain = build(cache_dtype="int8", kernels=False, like=model)
  counts["K6 int8"] = serve(int8, int8_plain, batch, fa, da,
                            decode=INT8_DECODE)["K6"]
  t1 = phase_end("serving, the main path and its checks", t0)
  paths = (("kernel path", model), ("plain path", plain),
           ("kernel path, int8 KV cache", int8),
           ("plain path, int8 KV cache", int8_plain))
  for name, m in paths if profiles else paths[::2]:
    x = bench_decode.measure(m, batch, DECODE, 3, "cuda")
    print(f"[{gpu}] serving {name} B={BATCH} prompt {PROMPT} decode "
          f"{DECODE}: prefill {x['prefill_s'] * 1e3:.3f} ms, AR step "
          f"{x['step_s'] * 1e3:.3f} ms, {BATCH / x['step_s']:.1f} tok/s, "
          f"e2e {x['t_full'] * 1e3:.3f} ms")
  t1 = phase_end("serving, the times", t1)
  if profiles:
    for name, m in (("kernel path", model),
                    ("kernel path, int8 KV cache", int8)):
      bench_decode.print_profile(bench_decode.profile(m, batch, DECODE),
                                 prefix=f"[{gpu}] {name}, ")
    phase_end("serving, the profiles", t1)
  del int8, int8_plain
  t0 = phase_end("serving, bf16 weights", t0)

  # The checkpoint of phases 3b and 3e, written once and deleted after.
  path = os.path.join(ROOT, "build", "chip_smoke_serving", "pg3b-int8.npz")
  try:
    counts.update(int8_weights_phase(model, batch, fa, da, gpu, path))
    torch.cuda.empty_cache()
    t0 = phase_end("serving, int8 weights", t0)
    counts.update(beam_phase(model, plain, batch, fa, da, gpu))
    t0 = phase_end("beam search and best-of-n", t0)
    counts.update(video_phase(model, plain, fa, da, gpu))
    t0 = phase_end("video", t0)
    del model, plain
    torch.cuda.empty_cache()
    counts.update(runner_phase(fa, da, gpu, path))
    phase_end("the runner", t0)
  finally:
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
  return counts


def training_phase(fa, gpu):
  """Phase 4 and the training times; returns K1 and K2 launches per step."""
  from big_vision_torch.tools import bench_decode
  workdir = os.path.join(ROOT, "build", "chip_smoke_train")
  trainer, per_step, e2e = train_main_path(fa, workdir, gpu)
  batch, unseen, _, fixed_ms = fixed_batch_steps(trainer)
  peak = matmul_peak_tflops()
  mfu = e2e["img/sec"] * FLOPS_PER_IMG_TRAIN / (peak * 1e12)
  print(f"[{gpu}] training ViT-B/16 224px batch {TRAIN_B} on JPEGs decoded "
        f"on the host: end to end "
        f"{e2e['step_ms']:.3f} ms/step, {e2e['img/sec']:.1f} img/s, input "
        f"stall {e2e['input_stall_pct']:.3f}% (median of "
        f"{(TRAIN_STEPS - TRAIN_LOG) // TRAIN_LOG} windows of {TRAIN_LOG} "
        f"steps); step on a fixed batch without the input pipeline "
        f"{fixed_ms:.3f} ms; "
        f"bf16 8192^3 matmul {peak:.1f} TFLOP/s; MFU {100 * mfu:.2f}%; "
        f"eval {e2e['eval img/s']:.1f} img/s")
  extra = e2e["step_ms"] - fixed_ms
  waiting = e2e["step_ms"] * e2e["input_stall_pct"] / 100
  host_bound = extra > HOST_BOUND_SHARE * fixed_ms
  print(f"[{gpu}] the end-to-end step is {e2e['step_ms'] / fixed_ms:.3f} x "
        f"the fixed-batch step ({extra:.3f} ms more, {waiting:.3f} ms of it "
        f"waiting for batches): the step is "
        f"{'' if host_bound else 'not '}bound by the host (more than "
        f"{100 * HOST_BOUND_SHARE:.0f}% slower)")
  bench_decode.print_profile(kernel_timing.device_profile(
      {"training step": lambda: trainer.update(batch)}, top=14),
      prefix=f"[{gpu}] ")
  kernel_vs_plain_training(fa, trainer, unseen)
  del trainer, batch, unseen
  torch.cuda.empty_cache()
  return per_step


def blocked_entries(fa, counts, gpu):
  """K3, K4a, K4b and K5 at the FlexiViT-B shape of seqhw 40 in f32 (B=32,
  T=1601, H=12, D=64; launches per step), each beside its plain version,
  SDPA on the same f32 inputs (its forward for K3, its autograd backward,
  which computes dq, dk and dv together, for K4a, K4b and K5) and its
  bound at the 3xTF32 rate of its products; and K5 against K4a + K4b on
  the same inputs, in turns; then K3, K4a, K4b and K5 at seqhw 30. SDPA on
  bf16 copies, a different function, is printed beside for comparison with
  earlier records."""
  k3 = kernel_timing.time_fwd(fa, gpu, "K3", 40)
  assert k3["max_rel_err"] <= F32_BAR, k3
  entries = [dict(
      name="flash_blocked_fwd", route="cuda",
      source="big_vision_torch/csrc/flash_blocked_fwd.cu",
      replaces="big_vision_tpu/ops/flash_attention.py:145",
      launches=counts["K3"], max_abs_err=counts["K3 err"][0],
      max_rel_err=counts["K3 err"][1],
      rel_tolerance=BLOCKED_BAR[torch.float32], ms=k3["ms"],
      plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
      bound_by=k3["bound_by"], library_ms=k3["library_ms"])]
  b, t, h, d = FLEXI_B, FLEXI_T[0], TRAIN_H, TRAIN_D
  sets = [blocked_inputs(b, t, h, d, seed=100 + 2 * i) for i in range(2)]
  k4_sets, k5_sets = [], []
  for q, k, v, do in sets:
    o, lse = fa.flash_attention_blocked_forward(q, k, v)
    k4_sets.append((q, k, v, do, lse, fa.blocked_delta(o, do)))
    k5_sets.append((q, k, v, o, lse, do))
  print(f"[{gpu}] SDPA at B={b} T={t} H={h} D={d} on bf16 copies of the "
        f"f32 inputs (not the blocked kernels' function): forward "
        f"{sdpa_fwd_ms(sets, torch.bfloat16):.4f} ms, autograd backward "
        f"{sdpa_bwd_ms(sets, torch.bfloat16):.4f} ms")
  bwd_ms = sdpa_bwd_ms(sets)
  timed = [
      ("flash_blocked_dq", "K4a", "flash_blocked_bwd.cu", 632,
       fa.flash_attention_blocked_dq, fa.flash_attention_blocked_dq_reference,
       bwd_ms, k4a_work),
      ("flash_blocked_dkv", "K4b", "flash_blocked_bwd.cu", 653,
       fa.flash_attention_blocked_dkv,
       fa.flash_attention_blocked_dkv_reference, bwd_ms, k4b_work),
      ("flash_blocked_bwd_fused", "K5", "flash_blocked_bwd_fused.cu", 482,
       fa.flash_attention_blocked_bwd_fused,
       fa.flash_attention_blocked_bwd_fused_reference, bwd_ms, k5_work),
  ]
  for name, key, src, line, fn, plain, lib_ms, work in timed:
    arg_sets = k5_sets if key == "K5" else k4_sets
    bms, by = bound(*work(b, t, h, d), TF32X3_FLOPS)
    print(f"{name}: bound {bms:.4f} ms ({by}) at the 3xTF32 rate; "
          f"{bound(*work(b, t, h, d), F32_FLOPS)[0]:.4f} ms at the f32 rate, "
          f"{bound(*work(b, t, h, d))[0]:.4f} ms at the bf16 tensor-core "
          "rate")
    entries.append(dict(
        name=name, route="cuda", source=f"big_vision_torch/csrc/{src}",
        replaces=f"big_vision_tpu/ops/flash_attention.py:{line}",
        launches=counts[key], max_abs_err=counts[f"{key} err"][0],
        max_rel_err=counts[f"{key} err"][1],
        rel_tolerance=BLOCKED_BAR[torch.float32],
        ms=time_ms(fn, arg_sets, iters=10),
        plain_ms=time_ms(plain, arg_sets, iters=3), bound_ms=bms,
        bound_by=by, library_ms=lib_ms))
  # The whole blocked backward, one way and the other, in turns.
  k5 = [time_ms(fa.flash_attention_blocked_bwd_fused, k5_sets, iters=10)]
  two = [time_ms(fa.flash_attention_blocked_bwd, k5_sets, iters=10)
         for _ in range(2)]
  k5.append(time_ms(fa.flash_attention_blocked_bwd_fused, k5_sets, iters=10))
  print(f"[{gpu}] blocked backward at B={b} T={t} H={h} D={d} f32, delta "
        f"included: K5 {k5[0]:.4f}, {k5[1]:.4f} ms; K4a + K4b {two[0]:.4f}, "
        f"{two[1]:.4f} ms (K5, K4, K4, K5)")
  del sets, k4_sets, k5_sets
  k3 = kernel_timing.time_fwd(fa, gpu, "K3", 30)
  assert k3["max_rel_err"] <= F32_BAR, k3
  time_blocked_bwd(fa, gpu, 30)
  return entries


def k2_f32_entry(fa, counts, gpu, seqhw):
  """K2's f32 kernel at FlexiViT-B's `seqhw` (B=32, T=seqhw^2+1, H=12, D=64,
  f32; launches per step of the FlexiViT phase at seqhw 15), beside its
  plain version, SDPA's autograd backward on the same f32 inputs, and its
  bound (at the 3xTF32 rate of its products, and at the f32 rate outside
  the tensor cores); its error against the plain version on these inputs."""
  b, t, h, d = FLEXI_B, seqhw * seqhw + 1, TRAIN_H, TRAIN_D
  sets = flexi_bwd_sets(fa, seqhw, fused=False)
  assert fa.bwd_kernel(torch.float32) == "flash_bwd"
  q, k, v, lse, do = sets[0]
  got = fa.flash_attention_bwd(q, k, v, lse, do)
  want = fa.flash_attention_bwd_reference(q, k, v, do)
  abs_err = max((x - y).abs().max().item() for x, y in zip(got, want))
  rel = max(rel_err(x, y) for x, y in zip(got, want))
  del got, want
  assert rel <= F32_BAR, rel
  plain = lambda q, k, v, lse, do: fa.flash_attention_bwd_reference(
      q, k, v, do)
  work = k2_work(b, t, h, d, itemsize=4)
  bms, by = bound(*work, TF32X3_FLOPS)
  entry = dict(
      name="flash_bwd", route="cuda",
      source="big_vision_torch/csrc/flash_bwd.cu",
      replaces="big_vision_tpu/ops/flash_attention.py:329",
      launches=counts["K2f"], paligemma_launches=counts["PG K2f"],
      imagetext_launches={path: counts[f"IT {path}"]["K2f"]
                          for path in ("cappa", "clippo", "zeroshot")},
      max_abs_err=abs_err, max_rel_err=rel,
      rel_tolerance=F32_BAR, ms=time_ms(fa.flash_attention_bwd, sets),
      plain_ms=time_ms(plain, sets, iters=10), bound_ms=bms, bound_by=by,
      library_ms=sdpa_bwd_ms([(q, k, v, do) for q, k, v, _, do in sets]))
  print(f"[{gpu}] K2 flash_bwd (f32) at seqhw {seqhw} B={b} T={t} H={h} "
        f"D={d}: {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, SDPA "
        f"{entry['library_ms']:.4f} ms; bound {bms:.4f} ms ({by}) at the "
        f"3xTF32 rate, {bound(*work, F32_FLOPS)[0]:.4f} ms at the f32 rate; "
        f"rel err {rel:.3e} (bar {F32_BAR})")
  return entry


def k1_f32_entry(fa, counts, gpu):
  """K1's f32 kernel (csrc/flash_fwd.cu) at FlexiViT-B's seqhw 15 (B=32,
  T=226, H=12, D=64, f32; launches per step of the FlexiViT phase), beside
  its plain version, SDPA on the same f32 inputs, and its bound at the
  3xTF32 rate of its products (`kernel_timing.time_fwd`); its errors (o
  and the LSE) against the plain version on these inputs within F32_BAR.
  Then the same at seqhw 24 (T=577), printed only."""
  r = kernel_timing.time_fwd(fa, gpu, "K1f", 15)
  assert r["max_rel_err"] <= F32_BAR, r
  assert kernel_timing.time_fwd(fa, gpu, "K1f", 24)["max_rel_err"] <= F32_BAR
  return dict(
      name="flash_fwd", route="cuda",
      source="big_vision_torch/csrc/flash_fwd.cu",
      replaces="big_vision_tpu/ops/flash_attention.py:306",
      launches=counts["K1f"], paligemma_launches=counts["PG K1f"],
      imagetext_launches={path: counts[f"IT {path}"]["K1f"]
                          for path in ("cappa", "clippo", "zeroshot")},
      max_abs_err=r["max_abs_err"],
      max_rel_err=r["max_rel_err"], rel_tolerance=F32_BAR, ms=r["ms"],
      plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
      library_ms=r["library_ms"])


def kernel_entries(fa, da, counts, gpu):
  """The {"kernels": [...]} entries: K1's and K2's bf16 kernels at the ViT
  training shape, their f32 kernels at FlexiViT-B's seqhw 15, K3-K5 at its
  seqhw 40, K6 at the serving shape, each beside its plain version, SDPA
  and bound; K1's bf16 kernel also at the serving shape."""
  kernels = []
  # K1's tensor-core kernel at the serving shape (the image tower's 27
  # launches per request batch), 8 input sets (113 MB) past the L2.
  b, t, h, d = BATCH, IMG_TOKENS, 16, 72
  sets = [k1_inputs(b, t, h, d, seed=90 + i) for i in range(8)]
  ms = time_ms(lambda q, k, v: fa.flash_attention_forward(q, k, v), sets)
  lib_ms = sdpa_fwd_ms(sets)
  print(f"[{gpu}] K1 flash_fwd_tc at the serving shape B={b} T={t} H={h} "
        f"D={d} bf16: {ms:.4f} ms (bound {bound(*k1_work(b, t, h, d))[0]:.4f}"
        f" ms), SDPA {lib_ms:.4f} ms")
  b, t, h, d = TRAIN_B, TRAIN_T, TRAIN_H, TRAIN_D
  # K1 as training launches it (with the LSE); 2 input sets (460 MB)
  # exceed the L2. The kernel and its plain version in turns.
  sets = [k1_inputs(b, t, h, d, seed=10 + i) for i in range(2)]
  assert fa.fwd_kernel(torch.bfloat16) == "flash_fwd_tc"
  fwd = lambda q, k, v: fa.flash_attention_forward(q, k, v)
  turns = [time_ms(fa.flash_attention_reference, sets, iters=10),
           time_ms(fwd, sets), time_ms(fwd, sets),
           time_ms(fa.flash_attention_reference, sets, iters=10)]
  print(f"[{gpu}] K1 flash_fwd_tc at B={b} T={t} H={h} D={d} bf16, in turns "
        f"(plain, kernel, kernel, plain): "
        + ", ".join(f"{x:.4f}" for x in turns) + " ms")
  bms, by = bound(*k1_work(b, t, h, d))
  kernels.append(dict(
      name="flash_fwd_tc", route="cuda",
      source="big_vision_torch/csrc/flash_fwd_tc.cu",
      replaces="big_vision_tpu/ops/flash_attention.py:306",
      launches=counts["K1"], max_abs_err=counts["K1 err"][0],
      max_rel_err=counts["K1 err"][1], rel_tolerance=K1_BAR,
      ms=(turns[1] + turns[2]) / 2, plain_ms=(turns[0] + turns[3]) / 2,
      bound_ms=bms, bound_by=by,
      library_ms=sdpa_fwd_ms(sets)))
  kernels.append(k1_f32_entry(fa, counts, gpu))
  # K2 on the same inputs with K1's o and LSE; SDPA's autograd backward
  # alone (its forward is recorded once per set, outside the timing).
  k2_sets, inputs = [], []
  for i, (q, k, v) in enumerate(sets):
    _, lse = fa.flash_attention_forward(q, k, v)
    g = torch.Generator(device="cuda").manual_seed(50 + i)
    do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    k2_sets.append((q, k, v, lse, do))
    inputs.append((q, k, v, do))
  plain = lambda q, k, v, lse, do: fa.flash_attention_bwd_reference(
      q, k, v, do)
  assert fa.bwd_kernel(torch.bfloat16) == "flash_bwd_tc"
  turns = [time_ms(plain, k2_sets, iters=10),
           time_ms(fa.flash_attention_bwd, k2_sets),
           time_ms(fa.flash_attention_bwd, k2_sets),
           time_ms(plain, k2_sets, iters=10)]
  print(f"[{gpu}] K2 flash_bwd_tc at B={b} T={t} H={h} D={d} bf16, in turns "
        f"(plain, kernel, kernel, plain): "
        + ", ".join(f"{x:.4f}" for x in turns) + " ms")
  lib_ms = sdpa_bwd_ms(inputs)
  bms, by = bound(*k2_work(b, t, h, d))
  kernels.append(dict(
      name="flash_bwd_tc", route="cuda",
      source="big_vision_torch/csrc/flash_bwd_tc.cu",
      replaces="big_vision_tpu/ops/flash_attention.py:329",
      launches=counts["K2"], max_abs_err=counts["K2 err"][0],
      max_rel_err=counts["K2 err"][1], rel_tolerance=K2_BAR,
      ms=(turns[1] + turns[2]) / 2, plain_ms=(turns[0] + turns[3]) / 2,
      bound_ms=bms, bound_by=by, library_ms=lib_ms))
  del sets, k2_sets, inputs
  kernels.append(k2_f32_entry(fa, counts, gpu, 15))
  k2_f32_entry(fa, counts, gpu, 24)  # printed only: T=577, 12 per step
  kernels += blocked_entries(fa, counts, gpu)
  # K6 at gemma_2b's AR shape over the serving run's cache (bf16 and int8),
  # and at B=64, S=1120 (printed only).
  for cache, name in (("bf16", "decode_attention"),
                      ("int8", "decode_attention (int8 cache)")):
    r = time_k6(da, gpu, BATCH, CACHE, cache)
    kernels.append(dict(
        name=name, route="cuda",
        source="big_vision_torch/csrc/decode_attention.cu",
        replaces="big_vision_tpu/ops/decode_attention.py:113",
        launches=counts["K6" if cache == "bf16" else "K6 int8"],
        max_abs_err=counts[f"K6 {cache} err"][0],
        max_rel_err=counts[f"K6 {cache} err"][1], rel_tolerance=K6_BAR,
        ms=r["ms"], graph_ms=r["graph_ms"], profiled_ms=r["profiled_ms"],
        host_us=r["host_us"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"]))
  for cache in ("bf16", "int8"):
    time_k6(da, gpu, 64, 1120, cache)
  return (kernels + counts["PG kernels"] + counts["IT kernels"]
          + counts["NX kernels"] + counts["JT kernels"])


# ----------------------------------------------------------------------------
# Phase 11: SigLIP/LiT image-text training and the eval-only path.
# ----------------------------------------------------------------------------


def write_siglip_inits(directory):
  """Random inits of the LiT towers from SEED, as `.npz` files in the JAX
  layout: a ViT-B/16 at 224px with `tok` pooling and no head (the stand-in
  for "howto-i21k-B/16") and a BERT-base without a head (for
  "bert_base"). Returns (image path, text path)."""
  from big_vision_torch.models import vit
  from big_vision_torch.models.proj.flaxformer import bert
  from big_vision_torch.utils import checkpoints
  from big_vision_torch.utils import convert
  os.makedirs(directory, exist_ok=True)
  paths = (os.path.join(directory, "img.npz"),
           os.path.join(directory, "txt.npz"))
  for path, model in zip(paths, (
      vit.Model(0, variant="B/16", pool_type="tok", device="cuda"),
      bert.Model(config="base", device="cuda"))):
    model.initialize(torch.Generator(device="cuda").manual_seed(SEED + 23))
    checkpoints.npz_save(convert.params(model), path)
    del model
  return paths


def siglip_args(inits, vocab, extra=""):
  img, txt = inits
  return (f"img_init={img},txt_init={txt},vocab={vocab},"
          f"neval={SIGLIP_NEVAL}{extra}")


def siglip_main_path(fa, workdir, inits, vocab, gpu):
  """SIGLIP_STEPS steps of the SigLIP trainer's command line on
  siglip_lit_coco at full width from the random inits, its retrieval eval
  at step 0 and at the last step (with a checkpoint there); asserts the
  launches of every step (12 K1f, 12 K2f) and eval batch (12 K1f a batch
  of images, none a batch of captions), the recalls finite and the frozen
  image tower unchanged. Returns (trainer, {"step_ms", "img/sec",
  "input_stall_pct": medians of the rows after the first; "peak"}, the
  last eval's metrics, the checkpoint)."""
  from big_vision_torch.trainers.proj.image_text import siglip
  from big_vision_torch.utils import checkpoints
  from big_vision_torch.utils import trees
  shutil.rmtree(workdir, ignore_errors=True)
  calls = {}
  reset_launches(fa)
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  args = siglip_args(inits, vocab, f",stop={SIGLIP_STEPS},log=1,"
                     f"ckpt={SIGLIP_STEPS},eval_every={SIGLIP_STEPS}")
  with counted_predict_fns(fa, calls):
    trainer = siglip.main(["--config", f"{SIGLIP_CONFIG}:{args}",
                           "--workdir", workdir])
  torch.cuda.synchronize()
  peak = torch.cuda.max_memory_allocated()
  counts = launches(fa)
  depth = len(trainer.model.img.encoder.blocks)
  [per_call] = calls.values()
  per_img = {**dict.fromkeys(COUNTERS, 0), "K1f": depth}
  per_txt = dict.fromkeys(COUNTERS, 0)
  n_img = sum(c == per_img for c in per_call)
  assert all(c in (per_img, per_txt) for c in per_call), per_call[:4]
  want = {**dict.fromkeys(COUNTERS, 0),
          "K1f": depth * (SIGLIP_STEPS + n_img), "K2f": depth * SIGLIP_STEPS}
  print(f"siglip_lit_coco: {SIGLIP_STEPS} steps of batch "
        f"{trainer.batch_size}, {trainer.config['input']['pp']!r}, the "
        f"retrieval eval at steps 0 and {SIGLIP_STEPS} ({n_img} image "
        f"batches, {len(per_call) - n_img} caption batches); launches "
        f"{({k: n for k, n in counts.items() if n})} (want "
        f"{({k: n for k, n in want.items() if n})}: per step {depth} K1f "
        f"and {depth} K2f, per image batch {depth} K1f, per caption batch "
        f"none)")
  assert counts == want, (counts, want)
  with open(os.path.join(workdir, "big_vision_metrics.txt")) as f:
    all_rows = list(map(json.loads, f))
  evals = {r["step"]: {k: v for k, v in r.items()
                       if k.startswith("retrieval_coco/")}
           for r in all_rows if "retrieval_coco/txt2img/recall@1" in r}
  assert sorted(evals) == [0, SIGLIP_STEPS], sorted(evals)
  for step, ev in evals.items():
    assert len(ev) == 6 and all(0 <= v <= 1 for v in ev.values()), ev
    print(f"  retrieval eval at step {step}: " + ", ".join(
        f"{k.split('/', 1)[1]} {v:.6f}" for k, v in sorted(ev.items())))
  rows = [r for r in all_rows if "training_loss" in r]
  assert [r["step"] for r in rows] == list(range(1, SIGLIP_STEPS + 1)), rows
  for r in rows:
    for k in ("training_loss", "t", "b", "l2_grads", "l2_params"):
      assert math.isfinite(r[k]), r
  secs = [r["z/secs/eval/retrieval_coco"] for r in all_rows
          if "z/secs/eval/retrieval_coco" in r]
  e2e = {k: statistics.median(r[k] for r in rows[1:])
         for k in ("step_ms", "img/sec", "input_stall_pct")}
  e2e.update(peak=peak, eval_secs=secs[-1])
  print("  losses " + " ".join(f"{r['training_loss']:.6f}" for r in rows)
        + f"; t {rows[-1]['t']:.6f}, b {rows[-1]['b']:.6f}, l2_grads "
        f"{rows[-1]['l2_grads']:.6f}")
  print(f"[{gpu}] retrieval eval of {SIGLIP_NEVAL} images and "
        f"{5 * SIGLIP_NEVAL} captions: {secs[-1]:.3f} s, "
        f"{SIGLIP_NEVAL / secs[-1]:.1f} img/s")
  # The frozen tower: its params are the init's, bit for bit.
  from big_vision_torch.utils import convert
  img = trees.flatten(checkpoints.load_params(inits[0]))
  now = trees.flatten(convert.params(trainer.model.img))
  assert sorted(now) == sorted(img), sorted(set(now) ^ set(img))
  assert all(np.array_equal(now[n], x) for n, x in img.items()), (
      "the frozen image tower moved")
  print(f"  the frozen image tower: its {len(img)} params equal the init's "
        f"after {SIGLIP_STEPS} steps")
  ckpt = checkpoints.last_checkpoint_dir(os.path.join(workdir, "ckpt.bv"))
  assert ckpt and ckpt.endswith(f"{SIGLIP_STEPS:09d}-tmp"), ckpt
  return trainer, e2e, evals[SIGLIP_STEPS], ckpt


def siglip_loss(trainer, batch, **kw):
  """(loss, zimg, ztxt) of the SigLIP loss on `batch` (eval mode: no
  dropout)."""
  zimg, ztxt, out = trainer.model(batch["image"], batch["labels"], **kw)
  loss = trainer.siglip_loss(zimg, ztxt, out["t"][0], out["b"][0])
  return loss, zimg, ztxt


def siglip_fixed_steps(trainer, gpu):
  """SIGLIP_FIXED_STEPS updates on one batch, timed with CUDA events (the
  step without the input pipeline); the loss on that batch before and
  after (finite). Returns (the batch, the next batch, which no update saw,
  ms per step)."""
  it = trainer.input_iter()
  batch, unseen = next(it), next(it)
  it.close()
  with torch.no_grad():
    before = siglip_loss(trainer, batch)[0].item()
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  for _ in range(SIGLIP_FIXED_STEPS):
    trainer.update(batch)
  end.record()
  end.synchronize()
  with torch.no_grad():
    after = siglip_loss(trainer, batch)[0].item()
  ms = start.elapsed_time(end) / SIGLIP_FIXED_STEPS
  print(f"[{gpu}] siglip_lit_coco: fixed batch, {SIGLIP_FIXED_STEPS} steps "
        f"of {ms:.3f} ms (CUDA events); its loss {before:.6f} -> "
        f"{after:.6f}")
  assert math.isfinite(after), after
  return batch, unseen, ms


def siglip_kernel_vs_plain(fa, trainer, inits, vocab, batch):
  """The kernel path against the plain path (the image tower's attn=xla,
  the same weights) on `batch`: the loss, zimg and ztxt within E2E_BAR of
  max|plain|; then every K1f and K2f launch of one forward and backward of
  the kernel path, in place, against its plain version within F32_BAR."""
  from big_vision_torch import train
  from big_vision_torch.trainers.proj.image_text import siglip
  reset_launches(fa)
  with torch.no_grad():
    lk, ik, tk = siglip_loss(trainer, batch)
  torch.cuda.synchronize()
  depth = len(trainer.model.img.encoder.blocks)
  assert launches(fa) == {**dict.fromkeys(COUNTERS, 0), "K1f": depth}
  plain = siglip.Trainer(train.load_config(
      f"{SIGLIP_CONFIG}:{siglip_args(inits, vocab, ',attn=xla')}"))
  plain.model.load_state_dict(trainer.model.state_dict())
  reset_launches(fa)
  with torch.no_grad():
    lp, ip, tp = siglip_loss(plain, batch)
  assert launches(fa) == dict.fromkeys(COUNTERS, 0), launches(fa)
  del plain
  errs = {"loss": abs(lk.item() - lp.item()) / abs(lp.item()),
          "zimg": rel_err(ik, ip), "ztxt": rel_err(tk, tp)}
  b = batch["image"].shape[0]
  print(f"siglip_lit_coco kernel vs plain path (attn=xla), batch {b}: loss "
        f"{lk.item():.6f} vs {lp.item():.6f}; rel err " + ", ".join(
            f"{k} {e:.3e}" for k, e in errs.items()) + f" (bar {E2E_BAR})")
  assert all(e <= E2E_BAR for e in errs.values()), errs
  k1_rows, k2_rows = [], []
  for p in trainer.params.values():
    p.grad = None
  with attention_checked_in_place(fa, k1_rows, k2_rows):
    siglip_loss(trainer, batch)[0].backward()
  torch.cuda.synchronize()
  for p in trainer.params.values():
    p.grad = None
  heads = trainer.model.img.encoder.blocks[0].attn.num_heads
  for what_k, rows, n in (("K1 (f32) forward", k1_rows, 2 * depth),
                          ("K2 (f32) backward", k2_rows, 3 * depth)):
    assert len(rows) == n, (what_k, len(rows))
    rows.sort(reverse=True)
    print(f"siglip_lit_coco image tower: {what_k} in place, batch {b} x "
          f"{heads} heads (B*H = {b * heads}, T = 197): {len(rows)} outputs "
          f"of {depth} launches against the plain version, the 3 worst "
          f"(bar {F32_BAR}): " + ", ".join(f"{nm} {e:.3e}"
                                           for e, nm in rows[:3]))
    assert all(e <= F32_BAR for e, _ in rows), rows[:3]


def eval_only_run(fa, arg, gpu, what):
  """`tools.eval_only` on `load_and_eval.py:<arg>` through its command
  line; returns (its metrics, [launches of each predict fn call])."""
  from big_vision_torch.tools import eval_only
  calls = {}
  reset_launches(fa)
  with counted_predict_fns(fa, calls):
    metrics = eval_only.main(["--config", f"{LOAD_AND_EVAL}:{arg}"])
  torch.cuda.synchronize()
  per_call = [c for cs in calls.values() for c in cs]
  print(f"{what}: eval_only, {len(per_call)} predict fn calls, launches "
        f"{({k: n for k, n in launches(fa).items() if n})}")
  return metrics, per_call


def siglip_phase(fa, gpu):
  """Phase 11: LiT (siglip_lit_coco) at full width through the SigLIP
  trainer's command line (launches exact, step ms, img/s, input stall,
  peak memory, the frozen tower unchanged, the retrieval eval's recalls
  and img/s); its step on a fixed batch; the kernel path against
  attn=xla and K1f/K2f in place at B*H = 3072, T = 197; an update at twice
  the batch; then `tools.eval_only` on the trainer's checkpoint (recalls
  equal to the trainer's last eval) and on a random AugReg ViT-B/16 through
  `load_and_eval:name=vit_i1k` (12 K1f a batch, eval img/s)."""
  t0 = time.perf_counter()
  gc.collect()
  torch.cuda.empty_cache()
  from big_vision_torch.configs.proj.image_text import common
  directory = os.path.join(ROOT, "build", "chip_smoke_siglip")
  inits = write_siglip_inits(directory)
  vocab = common.stand_in_vocab(os.path.join(directory, "vocab.txt"))
  trainer, e2e, last_eval, ckpt = siglip_main_path(
      fa, os.path.join(directory, "wd"), inits, vocab, gpu)
  batch, unseen, fixed_ms = siglip_fixed_steps(trainer, gpu)
  print(f"[{gpu}] siglip_lit_coco (ViT-B/16 frozen + BERT-base, 224px, 16 "
        f"tokens), batch {trainer.batch_size}: end to end "
        f"{e2e['step_ms']:.3f} ms/step, {e2e['img/sec']:.1f} img/s, input "
        f"stall {e2e['input_stall_pct']:.3f}% (median of steps 2-"
        f"{SIGLIP_STEPS}); fixed batch {fixed_ms:.3f} ms/step; max memory "
        f"allocated {e2e['peak'] / 2**30:.2f} GiB (of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f})")
  del batch
  siglip_kernel_vs_plain(fa, trainer, inits, vocab, unseen)
  del unseen
  batch_headroom(trainer, gpu, "siglip_lit_coco", lambda b: {
      "image": torch.randn((b, 224, 224, 3), device="cuda"),
      "labels": torch.randint(1, 1000, (b, 16), device="cuda")})
  del trainer
  gc.collect()
  torch.cuda.empty_cache()

  # eval_only on the trainer's checkpoint: the recalls of its last eval.
  metrics, per_call = eval_only_run(
      fa, f"name=proj.image_text.siglip_lit_coco,init={ckpt},"
      f"batch_size={SIGLIP_B},vocab={vocab},neval={SIGLIP_NEVAL}", gpu,
      "siglip_lit_coco")
  secs = metrics.pop("z/secs/eval/retrieval_coco")
  assert metrics == last_eval, (metrics, last_eval)
  assert {tuple(sorted(c.items())) for c in per_call} == {
      tuple(sorted({**dict.fromkeys(COUNTERS, 0), "K1f": k}.items()))
      for k in (0, 12)}, per_call[:4]
  print(f"[{gpu}] eval_only of the siglip_lit_coco checkpoint: its recalls "
        f"equal the trainer's eval at step {SIGLIP_STEPS}; {SIGLIP_NEVAL} "
        f"images in {secs:.3f} s, {SIGLIP_NEVAL / secs:.1f} img/s")

  # eval_only of a random AugReg ViT-B/16 through load_and_eval:vit_i1k.
  # A random AugReg ViT-B/16 (no pre-logits layer): what vit_i1k reads.
  init = write_vit(os.path.join(directory, "vit_b16_i1k.npz"), "B/16",
                   rep_size=False, seed=SEED + 29)
  metrics, per_call = eval_only_run(
      fa, f"name=vit_i1k,init={init},neval={EVAL_ONLY_NEVAL}", gpu,
      "vit_i1k")
  want = {**dict.fromkeys(COUNTERS, 0), "K1f": 12}
  assert per_call and all(c == want for c in per_call), per_call[:2]
  names = sorted(k.split("/")[0] for k in metrics if k.endswith("prec@1"))
  assert names == ["minival", "train", "v2", "val"], names
  for n in names:
    assert 0 <= metrics[f"{n}/prec@1"] <= 1, metrics
    assert math.isfinite(metrics[f"{n}/loss"]), metrics
    secs = metrics[f"z/secs/eval/{n}"]
    print(f"[{gpu}] eval_only vit_i1k eval {n}: {EVAL_ONLY_NEVAL} images in "
          f"{secs:.3f} s, {EVAL_ONLY_NEVAL / secs:.1f} img/s, prec@1 "
          f"{metrics[f'{n}/prec@1']:.6f}; {len(per_call) // len(names)} "
          f"batches of 12 K1f launches")
  shutil.rmtree(directory, ignore_errors=True)
  phase_end("siglip", t0)


# ----------------------------------------------------------------------------
# Phase 12: PaliGemma-3B fine-tuning (cococap) as configured and with the
# LLM's fused attention.
# ----------------------------------------------------------------------------


def paligemma_args(vocab, extra=""):
  return (f"vocab={vocab},neval={PG_NEVAL},stop={PG_STEPS},log=1,"
          f"batch_size={PG_B}{extra}")


def paligemma_want(attn, calls, depth_img, depth_llm):
  """The launches of PG_STEPS training steps and of the eval batches
  `calls` ({predict fn: [launches per call]}): per step K1f twice per
  layer (the forward and the remat recompute) and K2f once, for the
  tower's layers and under "flash" also the LLM's; per eval batch the
  tower's forward, and under "flash" the "logits" forward's LLM too."""
  layers = depth_img + (depth_llm if attn == "flash" else 0)
  want = {**dict.fromkeys(COUNTERS, 0), "K1f": 2 * layers * PG_STEPS,
          "K2f": layers * PG_STEPS}
  for name, per_call in calls.items():
    per = depth_img + (depth_llm if attn == "flash" and name == "logits"
                       else 0)
    assert all(c == {**dict.fromkeys(COUNTERS, 0), "K1f": per}
               for c in per_call), (name, per_call[:2], per)
    want["K1f"] += per * len(per_call)
  return want


def paligemma_main_path(fa, workdir, vocab, attn, gpu):
  """PG_STEPS steps of the PaliGemma trainer's command line on cococap at
  full width from the seed, LLM attn_impl `attn` ("" as configured), its
  evals at step 0 on PG_NEVAL stand-in images a split (the beam-decode
  caption evals and the perplexity evals): launches exact, every metric
  finite. Returns (trainer, {"step_ms", "img/sec": of the last step;
  "peak"; "evals": {name: seconds}})."""
  from big_vision_torch.trainers.proj.paligemma import train as pg_train
  shutil.rmtree(workdir, ignore_errors=True)
  calls = {}
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  reset_launches(fa)
  extra = f",attn={attn}" if attn else ""
  with counted_predict_fns(fa, calls):
    trainer = pg_train.main(["--config", f"{PALIGEMMA_CONFIG}:"
                             f"{paligemma_args(vocab, extra)}",
                             "--workdir", workdir])
  torch.cuda.synchronize()
  peak = torch.cuda.max_memory_allocated()
  counts = launches(fa)
  depth_img = len(trainer.model.img.encoder.blocks)
  depth_llm = len(trainer.model.llm.model.layers)
  want = paligemma_want(attn, calls, depth_img, depth_llm)
  what = f"cococap ({attn or 'as configured'})"
  print(f"{what}: {PG_STEPS} steps of batch {trainer.batch_size} and the "
        f"evals at step 0 ({ {n: len(c) for n, c in calls.items()} } eval "
        f"batches); launches {({k: n for k, n in counts.items() if n})} "
        f"(want {({k: n for k, n in want.items() if n})})")
  assert counts == want, (counts, want)
  with open(os.path.join(workdir, "big_vision_metrics.txt")) as f:
    rows = list(map(json.loads, f))
  steps = [r for r in rows if "training_loss" in r]
  assert [r["step"] for r in steps] == list(range(1, PG_STEPS + 1)), steps
  for r in steps:
    for k in ("training_loss", "avg_sup_seqlen", "max_sup_seqlen",
              "l2_grads", "l2_params"):
      assert math.isfinite(r[k]), r
  step0 = {k: v for r in rows if r["step"] == 0 for k, v in r.items()}
  evals = {}
  for name in trainer.config["evals"]:
    metrics = {k: v for k, v in step0.items()
               if k.startswith(f"{name}/") and not k[len(name) + 1:]
               .startswith("pplx")}
    assert metrics and all(math.isfinite(v) for v in metrics.values()), (
        name, metrics)
    evals[name] = step0[f"z/secs/eval/{name}"]
    print(f"[{gpu}] {what} eval {name} at step 0: {PG_NEVAL} images in "
          f"{evals[name]:.3f} s; " + ", ".join(
              f"{k.split('/')[-1]} {v:.6f}" for k, v in sorted(
                  metrics.items())))
  print("  losses " + " ".join(f"{r['training_loss']:.6f}" for r in steps)
        + f"; l2_grads {steps[-1]['l2_grads']:.6f}, sup seqlen "
        f"{steps[-1]['avg_sup_seqlen']:.3f}")
  e2e = {"step_ms": steps[-1]["step_ms"], "img/sec": steps[-1]["img/sec"],
         "peak": peak, "evals": evals}
  print(f"[{gpu}] {what}: step {PG_STEPS} {e2e['step_ms']:.3f} ms, "
        f"{e2e['img/sec']:.2f} img/s (step 1, with the first launches, "
        f"{steps[0]['step_ms']:.3f} ms); max memory allocated "
        f"{peak / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}")
  return trainer, e2e


def set_llm_attn(model, impl):
  for block in model.llm.model.layers:
    block.attn.attn_impl = impl


def paligemma_loss_grads(trainer, batch):
  """(loss, text logits, {name: gradient} of the LLM's attention
  projections) of one training forward and backward on `batch`."""
  from big_vision_torch.trainers.proj.paligemma import train as pg_train
  for p in trainer.params.values():
    p.grad = None
  logits, _ = trainer.model(batch["image"], batch["text"], batch["mask_ar"],
                            train=True)
  loss, _ = pg_train.next_token_loss(logits, batch["text"],
                                     batch["mask_loss"])
  loss.backward()
  grads = {n: p.grad.clone() for n, p in trainer.params.items()
           if n.startswith("llm/layers/") and "/attn/" in n}
  for p in trainer.params.values():
    p.grad = None
  return loss.item(), logits.detach(), grads


def paligemma_kernel_vs_plain(fa, trainer, batch):
  """On PG_CHECK_B examples no update saw, with the trained weights: the
  LLM's flash path (its trainer's) against its einsum path (attn_impl
  "xla", the same weights): the loss, the text logits and every
  attention-projection gradient of the LLM within E2E_BAR of max|plain|,
  and the launches of each (remat on, as in training)."""
  batch = {k: v[:PG_CHECK_B] for k, v in batch.items()}
  depth_img = len(trainer.model.img.encoder.blocks)
  depth_llm = len(trainer.model.llm.model.layers)
  runs = {}
  for impl, layers in (("flash", depth_img + depth_llm),
                       ("xla", depth_img)):
    set_llm_attn(trainer.model, impl)
    reset_launches(fa)
    runs[impl] = paligemma_loss_grads(trainer, batch)
    torch.cuda.synchronize()
    assert launches(fa) == {**dict.fromkeys(COUNTERS, 0), "K1f": 2 * layers,
                            "K2f": layers}, (impl, launches(fa))
  set_llm_attn(trainer.model, "flash")
  (lk, xk, gk), (lp, xp, gp) = runs["flash"], runs["xla"]
  errs = {"loss": abs(lk - lp) / abs(lp), "text logits": rel_err(xk, xp)}
  worst = max((rel_err(gk[n], gp[n]), n) for n in gp)
  assert len(gp) == 3 * depth_llm, sorted(gp)
  print(f"cococap LLM flash vs einsum path, {PG_CHECK_B} unseen examples: "
        f"loss {lk:.6f} vs {lp:.6f}; rel err " + ", ".join(
            f"{k} {e:.3e}" for k, e in errs.items())
        + f"; {len(gp)} attention-projection gradients, worst rel err "
        f"{worst[0]:.3e} ({worst[1]}) (bar {E2E_BAR})")
  assert all(e <= E2E_BAR for e in errs.values()) and worst[0] <= E2E_BAR


@contextlib.contextmanager
def llm_attention_checked_in_place(fa, k1_rows, k2_rows):
  """While open, each call of `flash_attention` with `seg` (the LLM's) is
  held against the plain versions on its own inputs: K1's o (a repeat
  launch, equal to the model's) and LSE, and once the backward has given
  the layer its do, K2's dq, dk and dv."""
  orig = fa.flash_attention

  def checked(q, k, v, seg=None, **kw):
    out = orig(q, k, v, seg=seg, **kw)
    if seg is None:  # the image tower's
      return out
    layer = len(k1_rows) // 2
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    o, lse = fa.flash_attention_forward(qd, kd, vd, seg=seg)
    assert torch.equal(o, out.detach()), layer
    k1_rows.append((rel_err(o, fa.flash_attention_reference(
        qd, kd, vd, seg=seg)), f"layer {layer} o"))
    k1_rows.append((rel_err(lse, fa.flash_attention_lse_reference(
        qd, kd, vd, seg=seg)), f"layer {layer} lse"))
    grads = {}

    def keep(name, g):
      grads[name] = g
      if len(grads) == 4:  # do, dq, dk, dv
        want = fa.flash_attention_bwd_reference(qd, kd, vd, grads["do"],
                                                seg=seg)
        for n, w in zip(("dq", "dk", "dv"), want):
          assert w.abs().max().item() > 0, (layer, n)
          k2_rows.append((rel_err(grads[n], w), f"layer {layer} {n}"))
        grads.clear()

    out.register_hook(functools.partial(keep, "do"))
    for name, x in (("dq", q), ("dk", k), ("dv", v)):
      x.register_hook(functools.partial(keep, name))
    return out

  fa.flash_attention = checked
  try:
    yield
  finally:
    fa.flash_attention = orig


def paligemma_in_place(fa, trainer, batch):
  """Every K1f and K2f launch of the LLM in one forward and backward on
  PG_INPLACE_B examples (remat off, so each layer launches once), on its
  own inputs against the plain versions within F32_BAR."""
  batch = {k: v[:PG_INPLACE_B] for k, v in batch.items()}
  llm = trainer.model.llm.model
  k1_rows, k2_rows = [], []
  llm.remat_policy = "none"
  try:
    with llm_attention_checked_in_place(fa, k1_rows, k2_rows):
      paligemma_loss_grads(trainer, batch)
    torch.cuda.synchronize()
  finally:
    llm.remat_policy = "nothing_saveable"
  depth = len(llm.layers)
  for what_k, rows, n in (("K1 (f32) forward", k1_rows, 2 * depth),
                          ("K2 (f32) backward", k2_rows, 3 * depth)):
    assert len(rows) == n, (what_k, len(rows))
    rows.sort(reverse=True)
    print(f"cococap LLM: {what_k} with seg in place, {PG_INPLACE_B} "
          f"examples x 8 heads, T = {IMG_TOKENS + 33}, D = 256: {len(rows)} "
          f"outputs of {depth} launches against the plain version, the 3 "
          f"worst (bar {F32_BAR}): " + ", ".join(f"{nm} {e:.3e}"
                                                 for e, nm in rows[:3]))
    assert all(e <= F32_BAR for e, _ in rows), rows[:3]


def paligemma_step_turns(trainer, batch, gpu):
  """The update on one fixed batch (CUDA events, no input pipeline) with
  the LLM's attention on the fused kernels and on the einsum path, in
  turns (flash, xla, xla, flash), then one more step of each under the
  profiler (device busy, the top kernels). Returns {impl: mean ms}."""
  from big_vision_torch.tools import bench_decode
  gc.collect()
  torch.cuda.empty_cache()
  times = {"flash": [], "xla": []}
  for impl in ("flash", "xla", "xla", "flash"):
    set_llm_attn(trainer.model, impl)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    trainer.update(batch)
    end.record()
    end.synchronize()
    times[impl].append(start.elapsed_time(end))
  print(f"[{gpu}] cococap fixed batch of {batch['image'].shape[0]}, in "
        f"turns (flash, xla, xla, flash): {times['flash'][0]:.3f}, "
        f"{times['xla'][0]:.3f}, {times['xla'][1]:.3f}, "
        f"{times['flash'][1]:.3f} ms/step (CUDA events)")
  for impl in ("flash", "xla"):
    set_llm_attn(trainer.model, impl)
    bench_decode.print_profile(kernel_timing.device_profile(
        {f"cococap step, LLM attention {impl}":
         lambda: trainer.update(batch)}, top=8,
        keep=("flash_fwd", "flash_bwd"), warm=False), prefix=f"[{gpu}] ")
  set_llm_attn(trainer.model, "flash")
  return {k: statistics.mean(v) for k, v in times.items()}


def f32_entries(fa, gpu, label, shape, launches, seg=None, seed=210,
                where="its main path"):
  """K1f and K2f at `shape` (B, T, H, D) in f32 with the segment ids
  `seg(q)` (or none; two input sets, past the L2) beside their plain
  versions, SDPA on the same inputs (with the segment ids' boolean mask
  where there are some), and their bounds at the 3xTF32 rate for the
  products of the visible scores only; the kernels-line entries, with the
  (K1f, K2f) `launches` of `where`. Where the ids hold padding (0), the
  padded rows of o and dq must be exact zeros."""
  b, t, h, d = shape
  sets = [k1_inputs(b, t, h, d, seed=seed + i, dtype=torch.float32)
          for i in range(2)]
  s = None if seg is None else seg(sets[0][0])
  kw = {} if s is None else {"seg": s}
  mask = None if s is None else (
      (s[:, None, None, :] > 0) & (s[:, None, None, :] <= s[:, None, :, None]))
  visible = 1.0 if mask is None else mask.float().mean().item()
  fwd = lambda q, k, v: fa.flash_attention_forward(q, k, v, **kw)
  plain_fwd = lambda q, k, v: fa.flash_attention_reference(q, k, v, **kw)
  q, k, v = sets[0]
  o, lse = fwd(q, k, v)
  want_o = plain_fwd(q, k, v)
  want_lse = fa.flash_attention_lse_reference(q, k, v, **kw)
  err = max(rel_err(o, want_o), rel_err(lse, want_lse))
  abs_err = max((o - want_o).abs().max().item(),
                (lse - want_lse).abs().max().item())
  assert err <= F32_BAR, err
  if s is not None:
    assert torch.all(o[s == 0] == 0), "padded rows of o"
  del o, want_o
  sdpa_sets = [(*x, mask) for x in kernel_timing.sdpa_layout(sets)]
  nbytes, flops = k1_work(b, t, h, d, itemsize=4)
  bms, by = bound(nbytes, flops * visible, TF32X3_FLOPS)
  k1 = dict(name=f"flash_fwd ({label})", route="cuda",
            source="big_vision_torch/csrc/flash_fwd.cu",
            replaces="big_vision_tpu/ops/flash_attention.py:306",
            launches=launches[0], max_abs_err=abs_err, max_rel_err=err,
            rel_tolerance=F32_BAR, ms=time_ms(fwd, sets),
            plain_ms=time_ms(plain_fwd, sets, iters=10), bound_ms=bms,
            bound_by=by, library_ms=time_ms(
                lambda q, k, v, m: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=m), sdpa_sets))
  k2_sets = []
  for i, (q, k, v) in enumerate(sets):
    _, lse = fwd(q, k, v)
    g = torch.Generator(device=q.device).manual_seed(seed + 10 + i)
    k2_sets.append((q, k, v, lse, torch.randn(q.shape, generator=g,
                                               device=q.device)))
  bwd = lambda q, k, v, lse, do: fa.flash_attention_bwd(q, k, v, lse, do,
                                                        **kw)
  plain_bwd = lambda q, k, v, lse, do: fa.flash_attention_bwd_reference(
      q, k, v, do, **kw)
  got, want = bwd(*k2_sets[0]), plain_bwd(*k2_sets[0])
  err = max(rel_err(x, y) for x, y in zip(got, want))
  abs_err = max((x - y).abs().max().item() for x, y in zip(got, want))
  assert err <= F32_BAR, err
  if s is not None:
    assert torch.all(got[0][s == 0] == 0), "padded rows of dq"
  del got, want
  graphs = []
  for (q, k, v, m), (*_, do) in zip(sdpa_sets, k2_sets):
    ins = [x.requires_grad_() for x in (q, k, v)]
    graphs.append((F.scaled_dot_product_attention(*ins, attn_mask=m), ins,
                   do.transpose(1, 2).contiguous()))
  library_ms = time_ms(lambda out, ins, do: torch.autograd.grad(
      out, ins, do, retain_graph=True), graphs)
  del graphs, sdpa_sets
  nbytes, flops = k2_work(b, t, h, d, itemsize=4)
  bms, by = bound(nbytes, flops * visible, TF32X3_FLOPS)
  k2 = dict(name=f"flash_bwd ({label})", route="cuda",
            source="big_vision_torch/csrc/flash_bwd.cu",
            replaces="big_vision_tpu/ops/flash_attention.py:329",
            launches=launches[1], max_abs_err=abs_err, max_rel_err=err,
            rel_tolerance=F32_BAR, ms=time_ms(bwd, k2_sets),
            plain_ms=time_ms(plain_bwd, k2_sets, iters=10), bound_ms=bms,
            bound_by=by, library_ms=library_ms)
  for e in (k1, k2):
    print(f"[{gpu}] {e['name']} B={b} H={h}: {e['ms']:.4f} ms, plain "
          f"{e['plain_ms']:.4f} ms, SDPA"
          f"{'' if s is None else ' (boolean mask)'} "
          f"{e['library_ms']:.4f} ms; bound {e['bound_ms']:.4f} ms "
          f"({e['bound_by']}, 3xTF32, {visible:.1%} of the scores "
          f"visible); rel err {e['max_rel_err']:.3e} (bar {F32_BAR}); "
          f"{e['launches']} launches on {where}")
  return [k1, k2]


def paligemma_batch(b, text):
  """A training batch of `b` random images and the text rows `text`
  [n, 33] (repeated to b rows)."""
  reps = -(-b // text["text"].shape[0])
  out = {k: v.repeat(reps, 1)[:b] for k, v in text.items()}
  out["image"] = torch.randn((b, RES, RES, 3), device="cuda")
  return out


def paligemma_phase(fa, gpu, detail=True):
  """Phase 12: cococap (PaliGemma-3B, So400m/14 + gemma_2b, T = 289, f32,
  remat) at full width from the seed through the PaliGemma trainer's
  command line, as configured (the tower's `auto`: K1f, K2f; the LLM's
  einsum attention) and with `attn=flash` (the LLM's 18 layers on K1f,
  K2f with `seg` too): launches exact, the step-0 evals finite, step ms,
  img/s and peak memory; an update at twice the batch; the flash path
  against the einsum path on an unseen batch; each LLM K1f/K2f launch in
  place; K1f, K2f timed at the LLM's shape; with `detail`, the fixed-batch
  steps in turns and their profiles. Returns the launch counts and the
  kernels-line entries."""
  t0 = time.perf_counter()
  from big_vision_torch.configs.proj.paligemma.transfers import common
  directory = os.path.join(ROOT, "build", "chip_smoke_paligemma")
  vocab = common.stand_in_tokenizer(os.path.join(directory,
                                                 "tokenizer.model"))
  counts, results = {}, {}
  for attn in ("", "flash"):
    trainer, e2e = paligemma_main_path(
        fa, os.path.join(directory, f"wd_{attn or 'configured'}"), vocab,
        attn, gpu)
    results[attn or "configured"] = e2e
    counts[attn or "configured"] = launches(fa)
    it = trainer.input_iter(PG_STEPS)
    unseen = next(it)
    it.close()
    if not attn:
      text = {k: unseen[k] for k in ("text", "mask_ar", "mask_loss")}
      if batch_headroom(trainer, gpu, "cococap",
                        lambda b: paligemma_batch(b, text)):
        print(f"  (the config keeps {PG_B}: updates at {2 * PG_B} in a row "
              "have run out of memory to the allocator's fragments; "
              "PERF.md section 6)")
      del trainer
      gc.collect()
      torch.cuda.empty_cache()
  # The full-batch steps first, while the allocator's pool is as the
  # training loop left it.
  fixed = paligemma_step_turns(trainer, unseen, gpu) if detail else {}
  paligemma_kernel_vs_plain(fa, trainer, unseen)
  paligemma_in_place(fa, trainer, unseen)
  del trainer, unseen
  gc.collect()
  torch.cuda.empty_cache()
  counts = {"PG K1f": {n: c["K1f"] for n, c in counts.items()},
            "PG K2f": {n: c["K2f"] for n, c in counts.items()}}
  counts["PG kernels"] = f32_entries(
      fa, gpu, "PaliGemma LLM T=289 D=256 seg",
      (PG_B, IMG_TOKENS + 33, 8, 256),
      [counts[n]["flash"] - counts[n]["configured"]
       for n in ("PG K1f", "PG K2f")], seg=prefix_lm_seg, seed=170,
      where="the flash main path")
  for name, e2e in results.items():
    print(f"[{gpu}] cococap ({name}), PaliGemma-3B f32 at batch {PG_B}: "
          f"{e2e['step_ms']:.3f} ms/step, {e2e['img/sec']:.2f} img/s, max "
          f"memory allocated {e2e['peak'] / 2**30:.2f} GiB; fixed batch "
          f"{fixed.get('xla' if name == 'configured' else 'flash', 0):.3f} "
          "ms/step (0: not timed); evals at step 0 "
          + ", ".join(f"{n} {t:.3f} s" for n, t in e2e["evals"].items()))
  shutil.rmtree(directory, ignore_errors=True)
  phase_end("paligemma", t0)
  return counts


# ----------------------------------------------------------------------------
# Phase 14: CapPa pre-training, CLIPPO, and zero-shot classification of LiT.
# ----------------------------------------------------------------------------


def cappa_main_path(fa, workdir, vocab, gpu):
  """CAPPA_STEPS steps of the CapPa trainer's command line on
  cappa/pretrain.py at full width from the seed, after its evals at step
  0: `val_pplx` on CAPPA_NEVAL stand-in images and the scoring classifier
  over the 1000 CLIP class names on CAPPA_SCORING stand-in images.
  Asserts the launches (per step 12 K1f and 12 K2f, per eval batch 12
  K1f), the first step's loss ln(32000) within 1e-4 (LogitsDense starts at
  zero) and every metric finite. Returns (trainer, {"step_ms", "img/sec":
  medians of the steps after the first; "peak"; "evals": {name:
  seconds}; "first_loss"}, the launches)."""
  from big_vision_torch.trainers.proj.cappa import generative
  shutil.rmtree(workdir, ignore_errors=True)
  calls = {}
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  reset_launches(fa)
  args = (f"vocab={vocab},neval={CAPPA_NEVAL},scoring={CAPPA_SCORING},"
          f"stop={CAPPA_STEPS},log=1")
  with counted_predict_fns(fa, calls):
    trainer = generative.main(["--config", f"{CAPPA_CONFIG}:{args}",
                               "--workdir", workdir])
  torch.cuda.synchronize()
  peak = torch.cuda.max_memory_allocated()
  counts = launches(fa)
  depth = len(trainer.model.encoder.encoder.blocks)
  per_batch = {**dict.fromkeys(COUNTERS, 0), "K1f": depth}
  n_batches = {name: len(c) for name, c in calls.items()}
  for name, per_call in calls.items():
    assert all(c == per_batch for c in per_call), (name, per_call[:2])
  want = {**dict.fromkeys(COUNTERS, 0),
          "K1f": depth * (CAPPA_STEPS + sum(n_batches.values())),
          "K2f": depth * CAPPA_STEPS}
  print(f"cappa/pretrain: {CAPPA_STEPS} steps of batch {trainer.batch_size} "
        f"and the evals at step 0 ({n_batches} eval batches); launches "
        f"{({k: n for k, n in counts.items() if n})} (want "
        f"{({k: n for k, n in want.items() if n})}: per step {depth} K1f and "
        f"{depth} K2f, per eval batch {depth} K1f)")
  assert counts == want, (counts, want)
  with open(os.path.join(workdir, "big_vision_metrics.txt")) as f:
    rows = list(map(json.loads, f))
  steps = [r for r in rows if "training_loss" in r]
  assert [r["step"] for r in steps] == list(range(1, CAPPA_STEPS + 1)), steps
  for r in steps:
    assert all(math.isfinite(r[k]) for k in ("training_loss", "l2_grads")), r
  first = steps[0]["training_loss"]
  assert abs(first - math.log(32_000)) <= 1e-4, first
  step0 = {k: v for r in rows if r["step"] == 0 for k, v in r.items()}
  pplx, prec = step0["val_pplx/perplexity"], step0["zeroshot_i1k/prec@1"]
  assert math.isfinite(pplx) and 0 <= prec <= 1, step0
  evals = {n: step0[f"z/secs/eval/{n}"] for n in ("val_pplx", "zeroshot_i1k")}
  print(f"  losses " + " ".join(f"{r['training_loss']:.6f}" for r in steps)
        + f" (the first: ln 32000 = {math.log(32_000):.6f}, off by "
        f"{abs(first - math.log(32_000)):.3e}); l2_grads "
        f"{steps[-1]['l2_grads']:.6f}")
  print(f"[{gpu}] cappa/pretrain evals at step 0: val_pplx/perplexity "
        f"{pplx:.6f} on {CAPPA_NEVAL} images in {evals['val_pplx']:.3f} s; "
        f"zeroshot_i1k/prec@1 {prec:.6f}, the scoring classifier over 1000 "
        f"class captions on {CAPPA_SCORING} images in "
        f"{evals['zeroshot_i1k']:.3f} s")
  e2e = {k: statistics.median(r[k] for r in steps[1:])
         for k in ("step_ms", "img/sec")}
  e2e.update(peak=peak, evals=evals, first_loss=first)
  return trainer, e2e, counts


def cappa_loss_grads(trainer, batch):
  """(loss, logits, {name: gradient} of the encoder's attention
  projections) of one training forward and backward on `batch`, with the
  parallel-prediction draws of one fixed generator."""
  from big_vision_torch.trainers.proj.cappa import generative
  for p in trainer.params.values():
    p.grad = None
  rng = torch.Generator(device="cuda").manual_seed(SEED + 41)
  logits = trainer.model(batch["image"], batch["labels"], train=True,
                         rng=rng)
  loss = generative.caption_loss(logits, batch["labels"])
  loss.backward()
  grads = {n: p.grad.clone() for n, p in trainer.params.items()
           if n.startswith("encoder/") and _attn_projection(n)}
  for p in trainer.params.values():
    p.grad = None
  return loss.item(), logits.detach(), grads


def cappa_kernel_vs_plain(fa, trainer, batch):
  """On CAPPA_CHECK_B examples no update saw, with the trained weights: the
  encoder's kernel path (`auto`: K1f, K2f) against its plain path
  (attn_impl "xla", the same weights): the loss, the logits and every
  attention-projection gradient of the encoder within E2E_BAR of
  max|plain|, and the launches of each."""
  batch = {k: v[:CAPPA_CHECK_B] for k, v in batch.items()}
  blocks = trainer.model.encoder.encoder.blocks
  runs = {}
  for impl, layers in (("auto", len(blocks)), ("xla", 0)):
    for block in blocks:
      block.attn.attn_impl = impl
    reset_launches(fa)
    runs[impl] = cappa_loss_grads(trainer, batch)
    torch.cuda.synchronize()
    assert launches(fa) == {**dict.fromkeys(COUNTERS, 0), "K1f": layers,
                            "K2f": layers}, (impl, launches(fa))
  for block in blocks:
    block.attn.attn_impl = "auto"
  (lk, xk, gk), (lp, xp, gp) = runs["auto"], runs["xla"]
  errs = {"loss": abs(lk - lp) / abs(lp), "logits": rel_err(xk, xp)}
  worst = max((rel_err(gk[n], gp[n]), n) for n in gp)
  assert len(gp) == 7 * len(blocks), sorted(gp)
  print(f"cappa/pretrain encoder kernel vs plain path (attn=xla), "
        f"{CAPPA_CHECK_B} unseen examples: loss {lk:.6f} vs {lp:.6f}; rel err "
        + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f"; {len(gp)} attention-projection gradients, worst rel err "
        f"{worst[0]:.3e} ({worst[1]}) (bar {E2E_BAR})")
  assert all(e <= E2E_BAR for e in errs.values()) and worst[0] <= E2E_BAR
  return max(max(errs.values()), worst[0])


def cappa_remat_launches(fa, trainer, batch):
  """With the remat of `scan=True` (each encoder and decoder block under a
  checkpoint), one training forward and backward launches 24 K1f (the
  forward and the recompute) and 12 K2f; its loss equals the step's
  without remat."""
  batch = {k: v[:CAPPA_CHECK_B] for k, v in batch.items()}
  model = trainer.model
  runs = {}
  for remat in (False, True):
    model.encoder.encoder.remat = model.decoder.remat = remat
    reset_launches(fa)
    runs[remat] = cappa_loss_grads(trainer, batch)[0]
    torch.cuda.synchronize()
    runs[remat, "launches"] = launches(fa)
  model.encoder.encoder.remat = model.decoder.remat = False
  depth = len(model.encoder.encoder.blocks)
  want = {**dict.fromkeys(COUNTERS, 0), "K1f": 2 * depth, "K2f": depth}
  print(f"cappa/pretrain under remat (scan=True), {CAPPA_CHECK_B} examples: "
        f"launches {({k: n for k, n in runs[True, 'launches'].items() if n})}"
        f" (want {({k: n for k, n in want.items() if n})}); loss "
        f"{runs[True]:.6f}, without remat {runs[False]:.6f}")
  assert runs[True, "launches"] == want, runs
  assert runs[True] == runs[False], runs


def cappa_in_place(fa, trainer, batch):
  """Every K1f and K2f launch of one training forward and backward of
  CapPa's encoder on `batch` (the main path's shape), in place, against its
  plain version within F32_BAR. Returns the worst relative error."""
  k1_rows, k2_rows = [], []
  with attention_checked_in_place(fa, k1_rows, k2_rows):
    cappa_loss_grads(trainer, batch)
  torch.cuda.synchronize()
  depth = len(trainer.model.encoder.encoder.blocks)
  b = batch["image"].shape[0]
  for what_k, rows, n in (("K1 (f32) forward", k1_rows, 2 * depth),
                          ("K2 (f32) backward", k2_rows, 3 * depth)):
    assert len(rows) == n, (what_k, len(rows))
    rows.sort(reverse=True)
    print(f"cappa/pretrain encoder: {what_k} in place, batch {b} x 12 heads "
          f"(B*H = {12 * b}, T = 196): {len(rows)} outputs of {depth} "
          f"launches against the plain version, the 3 worst (bar {F32_BAR}): "
          + ", ".join(f"{nm} {e:.3e}" for e, nm in rows[:3]))
    assert all(e <= F32_BAR for e, _ in rows), rows[:3]
  return max(k1_rows[0][0], k2_rows[0][0])


def fixed_steps(trainer, batch, gpu, what):
  """FIXED_UPDATES updates on `batch` after one to warm, timed with CUDA
  events (the step without the input pipeline); their losses finite.
  Returns ms per step."""
  trainer.update(batch)
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  losses = [trainer.update(batch)["training_loss"]
            for _ in range(FIXED_UPDATES)]
  end.record()
  end.synchronize()
  losses = [x.item() for x in losses]
  ms = start.elapsed_time(end) / FIXED_UPDATES
  print(f"[{gpu}] {what}: fixed batch, {FIXED_UPDATES} steps of {ms:.3f} ms "
        f"(CUDA events); losses " + " ".join(f"{x:.6f}" for x in losses))
  assert all(math.isfinite(x) for x in losses), losses
  return ms


def write_clippo_init(path):
  """A CLIPPO one tower (ViT-B/16, MAP pooling, a 768 head) drawn from
  SEED as an `.npz` in the JAX layout, its head N(0, 0.02^2): the stand-in
  for the published `howto-i21k-B/16` (the seed's zero head would embed
  every image at 0, and nothing would train)."""
  from big_vision_torch.configs.proj.clippo import train_clippo
  from big_vision_torch.models.proj.clippo import one_tower
  from big_vision_torch.utils import checkpoints
  from big_vision_torch.utils import convert
  model = one_tower.Model(**train_clippo.get_config()["model"],
                          device="cuda")
  gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
  model.initialize(gen)
  with torch.no_grad():
    model.img.head.weight.normal_(0.0, 0.02, generator=gen)
  checkpoints.npz_save(convert.params(model), path)
  return path


def clippo_main_path(fa, workdir, init, gpu):
  """CLIPPO_STEPS steps of the SigLIP trainer's command line on
  clippo/train_clippo.py at full width from `init`, its retrieval eval at
  steps 0 and CLIPPO_STEPS on CLIPPO_NEVAL stand-in images (and their
  rendered captions): launches exact (per step 24 K1f and 24 K2f, the
  tower's two passes; per eval batch of images or of rendered captions 12
  K1f), recalls in [0, 1], losses finite. Returns (trainer, {"step_ms",
  "img/sec": medians of the steps after the first; "peak", "eval_secs"},
  the launches)."""
  from big_vision_torch.trainers.proj.image_text import siglip
  shutil.rmtree(workdir, ignore_errors=True)
  calls = {}
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  reset_launches(fa)
  args = (f"init={init},neval={CLIPPO_NEVAL},stop={CLIPPO_STEPS},log=1,"
          f"eval_every={CLIPPO_STEPS}")
  with counted_predict_fns(fa, calls):
    trainer = siglip.main(["--config", f"{CLIPPO_CONFIG}:{args}",
                           "--workdir", workdir])
  torch.cuda.synchronize()
  peak = torch.cuda.max_memory_allocated()
  counts = launches(fa)
  depth = len(trainer.model.img.encoder.blocks)
  [per_call] = calls.values()
  per_batch = {**dict.fromkeys(COUNTERS, 0), "K1f": depth}
  assert all(c == per_batch for c in per_call), per_call[:2]
  want = {**dict.fromkeys(COUNTERS, 0),
          "K1f": depth * (2 * CLIPPO_STEPS + len(per_call)),
          "K2f": depth * 2 * CLIPPO_STEPS}
  print(f"clippo/train_clippo: {CLIPPO_STEPS} steps of batch "
        f"{trainer.batch_size} (images and rendered captions through one "
        f"tower), the retrieval eval at steps 0 and {CLIPPO_STEPS} "
        f"({len(per_call)} eval batches); launches "
        f"{({k: n for k, n in counts.items() if n})} (want "
        f"{({k: n for k, n in want.items() if n})}: per step {2 * depth} "
        f"K1f and {2 * depth} K2f, per eval batch {depth} K1f)")
  assert counts == want, (counts, want)
  with open(os.path.join(workdir, "big_vision_metrics.txt")) as f:
    rows = list(map(json.loads, f))
  evals = {r["step"]: {k: v for k, v in r.items()
                       if k.startswith("retrieval_coco/")}
           for r in rows if "retrieval_coco/txt2img/recall@1" in r}
  assert sorted(evals) == [0, CLIPPO_STEPS], sorted(evals)
  for step, ev in evals.items():
    assert len(ev) == 6 and all(0 <= v <= 1 for v in ev.values()), ev
    print(f"  retrieval eval at step {step}: " + ", ".join(
        f"{k.split('/', 1)[1]} {v:.6f}" for k, v in sorted(ev.items())))
  steps = [r for r in rows if "training_loss" in r]
  assert [r["step"] for r in steps] == list(range(1, CLIPPO_STEPS + 1))
  for r in steps:
    assert all(math.isfinite(r[k]) for k in ("training_loss", "t",
                                             "l2_grads", "l2_params")), r
  assert steps[0]["l2_grads"] > 0, steps[0]
  secs = [r["z/secs/eval/retrieval_coco"] for r in rows
          if "z/secs/eval/retrieval_coco" in r]
  print("  losses " + " ".join(f"{r['training_loss']:.6f}" for r in steps)
        + f"; t {steps[-1]['t']:.6f}, l2_grads {steps[-1]['l2_grads']:.6f}")
  e2e = {k: statistics.median(r[k] for r in steps[1:])
         for k in ("step_ms", "img/sec")}
  e2e.update(peak=peak, eval_secs=secs[-1])
  return trainer, e2e, counts


@contextlib.contextmanager
def discriminative_classifiers(found):
  """While open, each discriminative classifier that runs is appended to
  `found` (for the seconds of its parts)."""
  from big_vision_torch.evaluators.proj.image_text import (
      discriminative_classifier as dc)
  original = dc.Evaluator.run

  def run(self, train_state):
    found.append(self)
    return original(self, train_state)

  dc.Evaluator.run = run
  try:
    yield found
  finally:
    dc.Evaluator.run = original


def zeroshot_run(fa, directory, gpu):
  """`tools.eval_only` on LiT (siglip_lit_coco from random `.npz` inits of
  its towers) with the discriminative classifier (`zeroshot`: 81 CLIP-paper
  templates over the 1000 CLIP ImageNet class names, on ZEROSHOT_N stand-in
  images) beside the config's retrieval eval: per image batch 12 K1f, none
  per text batch (BERT); prec@1 in [0, 1]; the seconds of the host
  tokenization, the text embedding on the card and the images. Returns
  ({"secs", "parts"}, the launches)."""
  from big_vision_torch.configs.proj.image_text import common
  inits = write_siglip_inits(directory)
  vocab = common.stand_in_vocab(os.path.join(directory, "vocab.txt"))
  found = []
  with discriminative_classifiers(found):
    metrics, per_call = eval_only_run(
        fa, f"name=proj.image_text.siglip_lit_coco,img_init={inits[0]},"
        f"txt_init={inits[1]},vocab={vocab},neval={ZEROSHOT_RETRIEVAL},"
        f"zeroshot={ZEROSHOT_N},batch_size={ZEROSHOT_N}", gpu,
        "siglip_lit_coco zero-shot")
  counts = launches(fa)
  with_kernel = {**dict.fromkeys(COUNTERS, 0), "K1f": 12}
  n_img = sum(c == with_kernel for c in per_call)
  assert all(c in (with_kernel, dict.fromkeys(COUNTERS, 0))
             for c in per_call), per_call[:4]
  # One image batch of each eval (ZEROSHOT_RETRIEVAL images of the
  # retrieval eval and ZEROSHOT_N of the classifier fit one batch each).
  assert n_img == 2, n_img
  assert counts == {**dict.fromkeys(COUNTERS, 0), "K1f": 12 * n_img}, counts
  prec = metrics["zeroshot_i1k/prec@1"]
  assert 0 <= prec <= 1, metrics
  [evaluator] = found
  parts = evaluator.seconds
  secs = metrics["z/secs/eval/zeroshot_i1k"]
  n_prompts = len(evaluator.class_names) * len(evaluator.templates)
  assert (len(evaluator.class_names), len(evaluator.templates)) == (1000, 81)
  print(f"[{gpu}] eval_only siglip_lit_coco zero-shot (discriminative "
        f"classifier, clip_paper): prec@1 {prec:.6f} on {ZEROSHOT_N} images "
        f"in {secs:.3f} s: {n_prompts} prompts tokenized on the host in "
        f"{parts['tokenize']:.3f} s, embedded by BERT-base on the card in "
        f"{parts['embed_texts']:.3f} s; the images in "
        f"{parts['images']:.3f} s; {len(per_call)} predict fn calls, "
        f"{n_img} of them image batches of 12 K1f launches")
  return {"secs": secs, "parts": parts}, counts


def imagetext_phase(fa, gpu):
  """Phase 14: CapPa pre-training (cappa/pretrain.py: ViT-B/16 encoder,
  6-layer decoder, vocab 32,000, parallel prediction) through the
  generative trainer's command line with its perplexity and scoring
  classifier evals at step 0; its step on a fixed batch; an update at
  twice the batch; the encoder's kernel path against attn=xla and every
  K1f/K2f launch in place; CLIPPO (clippo/train_clippo.py, one ViT-B/16
  tower for images and rendered captions) through the SigLIP trainer with
  its retrieval eval, and an update at twice its batch; the discriminative
  classifier on LiT through eval_only; K1f, K2f timed at CapPa's shape.
  Returns the launch counts and the kernels-line entries."""
  t0 = time.perf_counter()
  from big_vision_torch.configs.proj.cappa import pretrain
  directory = os.path.join(ROOT, "build", "chip_smoke_imagetext")
  vocab = pretrain.stand_in_tokenizer(os.path.join(directory,
                                                   "c4_en_standin.model"))
  trainer, cappa, cappa_counts = cappa_main_path(
      fa, os.path.join(directory, "wd_cappa"), vocab, gpu)
  it = trainer.input_iter(CAPPA_STEPS)
  unseen = next(it)
  it.close()
  cappa_kernel_vs_plain(fa, trainer, unseen)
  cappa_remat_launches(fa, trainer, unseen)
  cappa_in_place(fa, trainer, unseen)
  fixed_ms = fixed_steps(trainer, unseen, gpu, "cappa/pretrain")
  labels = unseen["labels"]
  batch_headroom(trainer, gpu, "cappa/pretrain", lambda b: {
      "image": torch.randn((b, 224, 224, 3), device="cuda"),
      "labels": labels.repeat(-(-b // labels.shape[0]), 1)[:b]})
  del trainer, unseen, labels
  gc.collect()
  torch.cuda.empty_cache()
  t1 = phase_end("imagetext: CapPa", t0)

  init = write_clippo_init(os.path.join(directory, "clippo.npz"))
  trainer, clippo, clippo_counts = clippo_main_path(
      fa, os.path.join(directory, "wd_clippo"), init, gpu)
  it = trainer.input_iter(CLIPPO_STEPS)
  clippo["fixed_ms"] = fixed_steps(trainer, next(it), gpu,
                                   "clippo/train_clippo")
  it.close()
  batch_headroom(trainer, gpu, "clippo/train_clippo", lambda b: {
      "image": torch.randn((b, 224, 224, 3), device="cuda"),
      "labels": torch.randn((b, 224, 224, 3), device="cuda")})
  del trainer
  gc.collect()
  torch.cuda.empty_cache()
  t1 = phase_end("imagetext: CLIPPO", t1)

  zeroshot, zeroshot_counts = zeroshot_run(fa, directory, gpu)
  t1 = phase_end("imagetext: zero-shot", t1)
  counts = {"IT cappa": cappa_counts, "IT clippo": clippo_counts,
            "IT zeroshot": zeroshot_counts}
  counts["IT kernels"] = f32_entries(
      fa, gpu, "CapPa ViT-B/16 T=196", (CAPPA_B, 196, 12, 64),
      [cappa_counts["K1f"], cappa_counts["K2f"]], seed=190,
      where="the CapPa main path")
  total = torch.cuda.get_device_properties(0).total_memory / 2**30
  print(f"[{gpu}] cappa/pretrain (ViT-B/16 + 6-layer decoder, f32), batch "
        f"{CAPPA_B}: end to end {cappa['step_ms']:.3f} ms/step, "
        f"{cappa['img/sec']:.1f} img/s (median of steps 2-{CAPPA_STEPS}); "
        f"fixed batch {fixed_ms:.3f} ms/step; max memory allocated "
        f"{cappa['peak'] / 2**30:.2f} GiB of {total:.1f}; evals at step 0 "
        + ", ".join(f"{n} {s:.3f} s" for n, s in cappa["evals"].items()))
  print(f"[{gpu}] clippo/train_clippo (one ViT-B/16, MAP head, f32), batch "
        f"{CLIPPO_B}: end to end {clippo['step_ms']:.3f} ms/step, "
        f"{clippo['img/sec']:.1f} img/s (median of steps 2-{CLIPPO_STEPS}); "
        f"fixed batch {clippo['fixed_ms']:.3f} ms/step; max memory allocated {clippo['peak'] / 2**30:.2f} GiB; retrieval "
        f"eval of {CLIPPO_NEVAL} images {clippo['eval_secs']:.3f} s")
  print(f"[{gpu}] siglip_lit_coco zero-shot eval: {zeroshot['secs']:.3f} s "
        f"(host tokenization {zeroshot['parts']['tokenize']:.3f} s, text "
        f"embedding {zeroshot['parts']['embed_texts']:.3f} s, images "
        f"{zeroshot['parts']['images']:.3f} s)")
  shutil.rmtree(directory, ignore_errors=True)
  phase_end("imagetext", t0)
  return counts


# ----------------------------------------------------------------------------
# Phase 15: NaFlex B/16 through the SigLIP trainer.
# ----------------------------------------------------------------------------


def naflex_config(directory, *, batch=NAFLEX_B, attn="flash", steps=0):
  """SigLIP 2's NaFlex B/16 at 256 tokens through the SigLIP trainer:
  `siglip_lit_coco.py` (BERT-base text tower, its tokenizer and loss) with
  the image tower `proj.image_text.naflex_vit` (variant B, a 16x16
  posemb table resized per example, bound `learn_2d(256)`; MAP head;
  trained, not frozen) on the COCO stand-in's JPEGs with sides in
  NAFLEX_SIDES px, through the NaFlex pp chain padded to 256 tokens. No
  JAX config exists for this path; the JAX trainer cannot take the tuple
  image."""
  from big_vision_torch import train
  seq, p = NAFLEX_SEQ, 16
  config = train.load_config(
      f"{SIGLIP_CONFIG}:vocab={os.path.join(directory, 'vocab.txt')},"
      f"batch_size={batch},log=1,ckpt=0" + (f",stop={steps}" if steps
                                             else ""))
  config["input"]["data"]["side_range"] = NAFLEX_SIDES
  text_pp = config["input"]["pp"].split("|flatten|", 1)[1]
  config["input"]["pp"] = (
      f"decode|resize_to_sequence({p}, {seq})|value_range(-1, 1)"
      f"|patchify({p})|flatten"
      f"|pad_to_shape(({seq}, {p * p * 3}), key='image/patches')"
      + "".join(f"|pad_to_shape(({seq},), key='image/{k}')"
                for k in ("type", "yidx", "xidx"))
      + "|tuplify(['image/patches', 'image/type', 'image/yidx', "
      "'image/xidx'], 'image')|" + text_pp)
  config["pp_modules"] = config["pp_modules"] + [
      "proj.image_text.ops_naflex"]
  config["init_shapes"] = [(1, seq, p * p * 3), (1, 16)]
  config["model"]["image_model"] = "proj.image_text.naflex_vit"
  config["model"]["image"] = dict(
      variant="B", posemb=f"learn_2d({seq})", nposemb=16, pool_type="map",
      attn_impl=attn, head_zeroinit=False)
  config["model_load"] = {}
  config["schedule"] = [(".*", dict(config["schedule"][1][1]))]
  config["evals"] = {}
  config.pop("ckpt_steps")
  # The first batch waits for the shuffle buffer to fill: siglip_lit_coco's
  # 250,000 raw examples take half a minute of the script's time.
  config["input"]["shuffle_buffer_size"] = NAFLEX_SHUFFLE
  return config


def naflex_loss_grads(trainer, batch):
  """(loss, zimg, {name: gradient}) of the SigLIP loss on `batch`."""
  for p in trainer.params.values():
    p.grad = None
  loss, zimg, _ = siglip_loss(trainer, batch)
  loss.backward()
  grads = {n: p.grad.detach().clone() for n, p in trainer.params.items()
           if p.grad is not None}
  for p in trainer.params.values():
    p.grad = None
  return loss.detach(), zimg.detach(), grads


@contextlib.contextmanager
def seg_attention_checked_in_place(fa, rows, pad_rows):
  """While open, each attention call with segment ids is held against the
  plain versions on its own inputs: K1's o and LSE, then K2's dq, dk and
  dv; the padded query rows (seg 0) of the model's o and of dq must be
  exact zeros."""
  from big_vision_torch.ops import attention
  orig = attention.dot_product_attention

  def checked(q, k, v, seg=None, **kw):
    out = orig(q, k, v, seg=seg, **kw)
    if seg is None:
      return out
    layer = len(rows) // 5
    pad = seg == 0
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    o, lse = fa.flash_attention_forward(qd, kd, vd, seg=seg)
    assert torch.equal(o, out.detach()), layer
    pad_rows.append(int(pad.sum()))
    assert torch.all(out.detach()[pad] == 0), f"layer {layer}: padded o"
    rows.append((rel_err(o, fa.flash_attention_reference(qd, kd, vd,
                                                         seg=seg)),
                 f"layer {layer} o"))
    rows.append((rel_err(lse, fa.flash_attention_lse_reference(
        qd, kd, vd, seg=seg)), f"layer {layer} lse"))
    del o, lse
    grads = {}

    def keep(name, g):
      grads[name] = g
      if len(grads) == 4:
        assert torch.all(grads["dq"][pad] == 0), f"layer {layer}: padded dq"
        want = fa.flash_attention_bwd_reference(qd, kd, vd, grads["do"],
                                                seg=seg)
        for n, w in zip(("dq", "dk", "dv"), want):
          rows.append((rel_err(grads[n], w), f"layer {layer} {n}"))
        grads.clear()

    out.register_hook(functools.partial(keep, "do"))
    for name, x in (("dq", q), ("dk", k), ("dv", v)):
      x.register_hook(functools.partial(keep, name))
    return out

  attention.dot_product_attention = checked
  try:
    yield
  finally:
    attention.dot_product_attention = orig


def grads_close(got, want, bar):
  """max over params of max|got - want| / max|want| (params whose
  gradient is zero in exact arithmetic, the attention key biases, against
  the largest gradient); asserts it is within `bar`."""
  top = max(w.abs().max().item() for w in want.values())
  worst, name = 0.0, None
  for n, w in want.items():
    scale = top if n.endswith(("key/bias", "key.bias")) else max(
        w.abs().max().item(), 1e-30)
    e = (got[n] - w).abs().max().item() / scale
    if e > worst:
      worst, name = e, n
  assert worst <= bar, (name, worst)
  return worst, name


def naflex_phase(fa, gpu):
  """Phase 15: NaFlex B/16 at 256 tokens through the SigLIP trainer's loop
  (NAFLEX_STEPS steps of batch NAFLEX_B): launches per step exact (12 K1f
  with segment ids, 12 K2f), the first loss; the kernel path (`flash`,
  seg) against `attn_impl="xla"` (a [B, T, T] mask) on one batch: loss
  and zimg within NAFLEX_BAR, every gradient within NAFLEX_GRAD_BAR; every
  K1f/K2f launch in place within F32_BAR, the padded rows of o and dq
  exact zeros; the step on a fixed batch, img/s and peak memory. Returns
  the launch counts and the kernels-line entries."""
  t0 = time.perf_counter()
  from big_vision_torch import train
  from big_vision_torch.configs.proj.image_text import common as it_common
  from big_vision_torch.trainers.proj.image_text import siglip
  directory = os.path.join(ROOT, "build", "chip_smoke_naflex")
  os.makedirs(directory, exist_ok=True)
  it_common.stand_in_vocab(os.path.join(directory, "vocab.txt"))
  workdir = os.path.join(directory, "wd")
  shutil.rmtree(workdir, ignore_errors=True)
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  reset_launches(fa)
  trainer = train.train(naflex_config(directory, steps=NAFLEX_STEPS),
                        workdir, trainer_cls=siglip.Trainer)
  torch.cuda.synchronize()
  peak = torch.cuda.max_memory_allocated()
  counts = launches(fa)
  depth = len(trainer.model.img.encoder.blocks)
  want = {**dict.fromkeys(COUNTERS, 0), "K1f": depth * NAFLEX_STEPS,
          "K2f": depth * NAFLEX_STEPS}
  with open(os.path.join(workdir, "big_vision_metrics.txt")) as f:
    rows = [r for r in map(json.loads, f) if "training_loss" in r]
  assert [r["step"] for r in rows] == list(range(1, NAFLEX_STEPS + 1))
  assert all(math.isfinite(r["training_loss"]) for r in rows), rows
  print(f"naflex (SigLIP 2 NaFlex B/16, {NAFLEX_SEQ} tokens, f32): "
        f"{NAFLEX_STEPS} steps of batch {trainer.batch_size} through the "
        f"SigLIP trainer; launches "
        f"{({k: n for k, n in counts.items() if n})} (want "
        f"{({k: n for k, n in want.items() if n})}); first loss "
        f"{rows[0]['training_loss']:.6f}; losses " + " ".join(
            f"{r['training_loss']:.6f}" for r in rows))
  assert counts == want, (counts, want)
  e2e = {k: statistics.median(r[k] for r in rows[1:])
         for k in ("step_ms", "img/sec", "input_stall_pct")}

  it = trainer.input_iter(NAFLEX_STEPS)
  batch = next(it)
  it.close()
  ptype = batch["image"][1]
  tokens = ptype.sum(1).float()
  print(f"  a batch's valid tokens per example: min {tokens.min().item():.0f}"
        f", mean {tokens.mean().item():.1f}, max {tokens.max().item():.0f} "
        f"of {NAFLEX_SEQ}")
  assert (ptype == 0).any(), "no padding in the batch"

  reset_launches(fa)
  lk, zk, gk = naflex_loss_grads(trainer, batch)
  torch.cuda.synchronize()
  assert launches(fa) == {**dict.fromkeys(COUNTERS, 0), "K1f": depth,
                          "K2f": depth}, launches(fa)
  plain = siglip.Trainer(naflex_config(directory, attn="xla"))
  plain.model.load_state_dict(trainer.model.state_dict())
  reset_launches(fa)
  lp, zp, gp = naflex_loss_grads(plain, batch)
  assert launches(fa) == dict.fromkeys(COUNTERS, 0), launches(fa)
  del plain
  loss_err = abs(lk.item() - lp.item()) / abs(lp.item())
  z_err = rel_err(zk, zp)
  g_err, g_name = grads_close(gk, gp, NAFLEX_GRAD_BAR)
  print(f"naflex kernel path (flash, seg) vs attn=xla (bool mask), batch "
        f"{ptype.shape[0]}: loss {lk.item():.6f} vs {lp.item():.6f} (rel "
        f"{loss_err:.3e}), zimg rel {z_err:.3e} (bar {NAFLEX_BAR}); "
        f"gradients: worst {g_err:.3e} at {g_name} (bar {NAFLEX_GRAD_BAR})")
  assert loss_err <= NAFLEX_BAR and z_err <= NAFLEX_BAR, (loss_err, z_err)
  del gk, gp

  rows_k, pad_rows = [], []
  with seg_attention_checked_in_place(fa, rows_k, pad_rows):
    loss, _, _ = siglip_loss(trainer, batch)
    loss.backward()
  torch.cuda.synchronize()
  for p in trainer.params.values():
    p.grad = None
  assert len(rows_k) == 5 * depth, len(rows_k)
  rows_k.sort(reverse=True)
  print(f"naflex image tower: K1f and K2f in place, batch {ptype.shape[0]} "
        f"x 12 heads (T = {NAFLEX_SEQ}, seg): {len(rows_k)} outputs of "
        f"{depth} launches each against the plain version, the 3 worst (bar "
        f"{F32_BAR}): " + ", ".join(f"{nm} {e:.3e}" for e, nm in rows_k[:3])
        + f"; the {pad_rows[0]} padded query rows of every layer's o and dq "
        "exact zeros")
  assert all(e <= F32_BAR for e, _ in rows_k), rows_k[:3]

  fixed_ms = fixed_steps(trainer, batch, gpu, "naflex B/16")
  total = torch.cuda.get_device_properties(0).total_memory / 2**30
  print(f"[{gpu}] naflex B/16 + BERT-base (SigLIP trainer, f32), batch "
        f"{trainer.batch_size}: end to end {e2e['step_ms']:.3f} ms/step, "
        f"{e2e['img/sec']:.1f} img/s, input stall "
        f"{e2e['input_stall_pct']:.3f}% (median of steps 2-{NAFLEX_STEPS});"
        f" fixed batch {fixed_ms:.3f} ms/step, "
        f"{trainer.batch_size / fixed_ms * 1e3:.1f} img/s; max memory "
        f"allocated {peak / 2**30:.2f} GiB of {total:.1f}")
  del trainer, batch
  gc.collect()
  torch.cuda.empty_cache()
  out = {"NX": counts}
  out["NX kernels"] = f32_entries(
      fa, gpu, "NaFlex B/16 T=256, seg", (NAFLEX_B, NAFLEX_SEQ, 12, 64),
      [counts["K1f"], counts["K2f"]], seg=naflex_seg)
  shutil.rmtree(directory, ignore_errors=True)
  phase_end("naflex", t0)
  return out


def naflex_seg(q):
  """[B, T] segment ids of NaFlex padding: example i keeps its first
  T - 16 * (i % 9) tokens (1), the rest padding (0)."""
  b, t = q.shape[:2]
  keep = t - 16 * (torch.arange(b, device=q.device) % 9)
  return (torch.arange(t, device=q.device)[None] < keep[:, None]).int()


# ----------------------------------------------------------------------------
# Phase 16: Jet on ImageNet 64x64 and JetFormer-350M.
# ----------------------------------------------------------------------------


def jet_trainer_rows(workdir):
  with open(os.path.join(workdir, "big_vision_metrics.txt")) as f:
    return list(map(json.loads, f))


def jet_first_bits(trainer, batch):
  """The first step's bits/dim in closed form: at init every coupling is
  the identity (zero-init `final_proj`), so z = x + noise (the step's
  dequantization noise, replayed) and log|det| = 0."""
  from big_vision_torch.trainers.proj.jet import train as jet_train
  x = batch["image"]
  gen = jet_train.input_pipeline.step_generator(trainer.seed + 1, 0,
                                                trainer.device)
  z = (x + trainer.dequant_noise(x, gen)).double()
  ndims = z[0].numel()
  nll = 0.5 * (z ** 2 + math.log(2 * math.pi)).sum((1, 2, 3)) - (
      ndims * math.log(trainer.bin_width))
  return (nll / (ndims * math.log(2))).mean().item()


def jet_loss_grads(trainer, batch):
  """(bits/dim, {name: gradient}) of the half-bin-dequantized batch."""
  from big_vision_torch.trainers.proj.jet import train as jet_train
  for p in trainer.params.values():
    p.grad = None
  x = batch["image"] + 0.5 * trainer.bin_width
  z, logdet = trainer.model(x)
  bits = jet_train.nll_bits_per_dim(z, logdet, trainer.bin_width)[0].mean()
  bits.backward()
  grads = {n: p.grad.detach().clone() for n, p in trainer.params.items()
           if p.grad is not None}
  for p in trainer.params.values():
    p.grad = None
  return bits.detach(), grads


def jet_run(fa, gpu, directory):
  """Jet imagenet64 at full width and depth, batch JET_B: JET_STEPS loop
  steps with the val eval at step 0 and at the end; launches exact; the
  first bits/dim against its closed form; round trip; auto vs xla; the
  step on a fixed batch. Returns (counts, the trainer)."""
  from big_vision_torch import train
  from big_vision_torch.trainers.proj.jet import train as jet_train
  workdir = os.path.join(directory, "wd_jet")
  shutil.rmtree(workdir, ignore_errors=True)
  arg = f"batch_size={JET_B},neval={JET_NEVAL},stop={JET_STEPS},log=1"
  config = train.load_config(f"{JET_CONFIG}:{arg}")
  config["evals"]["val"]["log_steps"] = JET_STEPS
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  reset_launches(fa)
  calls = {}
  with counted_predict_fns(fa, calls):
    trainer = train.train(config, workdir, trainer_cls=jet_train.Trainer)
  torch.cuda.synchronize()
  peak = torch.cuda.max_memory_allocated()
  counts = launches(fa)
  couplings = trainer.model.couplings.depth
  blocks = couplings * len(trainer.model.couplings.layer.dnn.encoder.blocks)
  [per_call] = calls.values()
  per_eval = {**dict.fromkeys(COUNTERS, 0), "K1f": blocks}
  assert all(c == per_eval for c in per_call), per_call[:2]
  want = {**dict.fromkeys(COUNTERS, 0),
          "K1f": 2 * blocks * JET_STEPS + blocks * len(per_call),
          "K2f": blocks * JET_STEPS}
  rows = jet_trainer_rows(workdir)
  train_rows = [r for r in rows if "training_loss" in r]
  evals = {r["step"]: r["val/bits_per_dim"] for r in rows
           if "val/bits_per_dim" in r}
  print(f"jet imagenet64 (depth {couplings}, block_depth "
        f"{blocks // couplings}, emb 512, 8 heads, ps 4: T = 256, D = 64; "
        f"f32), batch {JET_B}: {JET_STEPS} steps and the val eval at steps "
        f"{sorted(evals)} ({len(per_call)} batches); launches "
        f"{({k: n for k, n in counts.items() if n})} (want "
        f"{({k: n for k, n in want.items() if n})}: per step {2 * blocks} "
        f"K1f (the remat'ed forward and its recompute) and {blocks} K2f, "
        f"per eval batch {blocks} K1f)")
  assert counts == want, (counts, want)
  assert [r["step"] for r in train_rows] == list(range(1, JET_STEPS + 1))
  it = trainer.input_iter(0)
  first = next(it)
  it.close()
  closed = jet_first_bits(trainer, first)
  got = train_rows[0]["training_loss"]
  print(f"  first bits/dim {got:.6f}, closed form of the batch (identity "
        f"flow, log|det| 0) {closed:.6f}, rel {abs(got - closed) / closed:.3e}"
        f" (bar {JET_BAR}); bits/dim " + " ".join(
            f"{r['training_loss']:.6f}" for r in train_rows)
        + "; val bits/dim " + ", ".join(f"step {s}: {v:.6f}"
                                        for s, v in sorted(evals.items())))
  assert abs(got - closed) <= JET_BAR * closed, (got, closed)
  assert all(math.isfinite(v) for v in evals.values()), evals
  e2e = {k: statistics.median(r[k] for r in train_rows[1:])
         for k in ("step_ms", "img/sec")}

  it = trainer.input_iter(JET_STEPS)
  batch = next(it)
  it.close()
  with torch.no_grad():
    reset_launches(fa)
    z, ld = trainer.model(batch["image"])
    back, ld_inv = trainer.model.inverse(z)
    torch.cuda.synchronize()
    assert launches(fa) == {**dict.fromkeys(COUNTERS, 0), "K1f": 2 * blocks}
  rt = (back - batch["image"]).abs().max().item()
  ld_err = ((ld + ld_inv).abs().max() / ld.abs().max()).item()
  print(f"  forward then inverse on the card (trained weights): max|x' - x| "
        f"{rt:.3e} (bar {JET_ROUNDTRIP}), log|det| forward "
        f"{ld.mean().item():.4f}, inverse's negation rel {ld_err:.3e}")
  assert rt <= JET_ROUNDTRIP and ld_err <= 1e-4, (rt, ld_err)
  del z, back

  sub = {"image": batch["image"][:JET_CHECK_B]}
  lk, gk = jet_loss_grads(trainer, sub)
  plain = jet_train.Trainer(train.load_config(
      f"{JET_CONFIG}:batch_size={JET_B},attn=xla"))
  plain.model.load_state_dict(trainer.model.state_dict())
  reset_launches(fa)
  lp, gp = jet_loss_grads(plain, sub)
  assert launches(fa) == dict.fromkeys(COUNTERS, 0), launches(fa)
  del plain
  l_err = abs(lk.item() - lp.item()) / abs(lp.item())
  g_err, g_name = grads_close(gk, gp, JET_GRAD_BAR)
  print(f"jet auto (K1f/K2f) vs attn=xla, {JET_CHECK_B} images: bits/dim "
        f"{lk.item():.6f} vs {lp.item():.6f} (rel {l_err:.3e}, bar {JET_BAR})"
        f"; gradients: worst {g_err:.3e} at {g_name} (bar {JET_GRAD_BAR})")
  assert l_err <= JET_BAR, l_err
  del gk, gp
  fixed_ms = fixed_steps(trainer, batch, gpu, "jet imagenet64")
  total = torch.cuda.get_device_properties(0).total_memory / 2**30
  print(f"[{gpu}] jet imagenet64 (f32), batch {JET_B}: end to end "
        f"{e2e['step_ms']:.3f} ms/step, {e2e['img/sec']:.1f} img/s (median "
        f"of steps 2-{JET_STEPS}); fixed batch {fixed_ms:.3f} ms/step, "
        f"{JET_B / fixed_ms * 1e3:.1f} img/s; max memory allocated "
        f"{peak / 2**30:.2f} GiB of {total:.1f}; val bits/dim at step "
        f"{JET_STEPS}: {evals[JET_STEPS]:.6f} on {JET_NEVAL} images")
  del trainer
  gc.collect()
  torch.cuda.empty_cache()
  return counts


def jetformer_zero_head_loss(trainer, batch):
  """The first step's loss in closed form: with the zero-init image head
  every mixture component is N(0, I), and at init the adaptor is the
  identity with log|det| 0, so (text first, the loss on the image suffix)
  the loss is the batch mean of 0.5 * sum(z^2 + log 2 pi) over all 768
  channels of every token, per subpixel in bits, plus log2(127.5); z is
  the patches of the noised image with the step's draws replayed (the RGB
  curriculum at step 0, dequantization, the input noise on the first
  out_dim channels)."""
  from big_vision_torch.trainers.proj.jetformer import train as jf
  gen = jf.input_pipeline.step_generator(trainer.seed + 1, 0, trainer.device)
  draws = trainer.draws(batch, gen)
  scale = jf.cosine_noise_scale(trainer.config, 0, trainer.total_steps)
  images = jf.quantized_noise(batch["image"], scale, draws["rgb"])
  z = trainer.patch_pca.encode(images, noise=draws["dequant"])[0].double()
  out_dim = trainer.model.model.out_dim
  tf = draws["order"][:, None, None]
  z[..., :out_dim] += torch.where(tf, draws["in_std"], 0.0) * (
      draws["in_noise"])
  subpix = batch["image"][0].numel()
  nll = 0.5 * (z ** 2 + math.log(2 * math.pi)).sum((1, 2)) / subpix
  return (nll / math.log(2)).mean().item() + math.log2(127.5)


def jetformer_run(fa, gpu, directory):
  """JetFormer-350M (imagenet2012 config, 256px, adaptor Jet depth 32 x 4
  blocks), batch JF_B: JF_STEPS loop steps with the val eval at step 0;
  launches exact (the adaptor's K1f/K2f; the decoder's attention is the
  plain path, as in JAX); the first loss against its closed form; the
  adaptor's auto path against xla; the step; a class-conditional sample
  of JF_SAMPLES images with CFG. Returns the launch counts."""
  from big_vision_torch import train
  from big_vision_torch.trainers.proj.jetformer import train as jf
  from big_vision_torch.trainers.proj.jetformer import predict_fns as pf
  workdir = os.path.join(directory, "wd_jetformer")
  shutil.rmtree(workdir, ignore_errors=True)
  config = train.load_config(
      f"{JF_CONFIG}:batch_size={JF_B},neval={JF_NEVAL},stop={JF_STEPS},"
      "log=1")
  config["evals"]["val"]["log_steps"] = 10 * JF_STEPS  # step 0 only
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  reset_launches(fa)
  calls = {}
  with counted_predict_fns(fa, calls):
    trainer = train.train(config, workdir, trainer_cls=jf.Trainer)
  torch.cuda.synchronize()
  peak = torch.cuda.max_memory_allocated()
  counts = launches(fa)
  adaptor = trainer.model.adaptor
  blocks = adaptor.couplings.depth * len(
      adaptor.couplings.layer.dnn.encoder.blocks)
  per_call = calls.get("validation", [])
  per_eval = {**dict.fromkeys(COUNTERS, 0), "K1f": blocks}
  assert per_call and all(c == per_eval for c in per_call), per_call[:2]
  want = {**dict.fromkeys(COUNTERS, 0),
          "K1f": 2 * blocks * JF_STEPS + blocks * len(per_call),
          "K2f": blocks * JF_STEPS}
  rows = jet_trainer_rows(workdir)
  train_rows = [r for r in rows if "training_loss" in r]
  print(f"jetformer_imagenet2012 350M (width 1024, depth 24, MQA, head "
        f"bf16; adaptor Jet depth {adaptor.couplings.depth} x "
        f"{blocks // adaptor.couplings.depth} blocks, T = 256, D = 64), batch "
        f"{JF_B}: {JF_STEPS} steps and the val eval at step 0 "
        f"({len(per_call)} batches); launches "
        f"{({k: n for k, n in counts.items() if n})} (want "
        f"{({k: n for k, n in want.items() if n})}: per step {2 * blocks} "
        f"K1f and {blocks} K2f in the adaptor, per eval batch {blocks} K1f)")
  assert counts == want, (counts, want)
  it = trainer.input_iter(0)
  first = next(it)
  it.close()
  closed = jetformer_zero_head_loss(trainer, first)
  got = train_rows[0]["training_loss"]
  print(f"  first loss {got:.6f}, closed form of the zero-init heads "
        f"{closed:.6f} (rel {abs(got - closed) / closed:.3e}, bar "
        f"{JF_BAR}); losses " + " ".join(f"{r['training_loss']:.6f}"
                                        for r in train_rows)
        + "; train/nll_text " + " ".join(
            f"{r['train/nll_text']:.4f}" for r in train_rows)
        + "; val/nll_image_suffix " + ", ".join(
            f"{r['val/nll_image_suffix']:.6f}" for r in rows
            if "val/nll_image_suffix" in r))
  assert abs(got - closed) <= JF_BAR * closed, (got, closed)
  e2e = statistics.median(r["step_ms"] for r in train_rows[1:])

  it = trainer.input_iter(JF_STEPS)
  batch = next(it)
  it.close()
  tokens = trainer.patch_pca.encode(batch["image"][:JF_CHECK_B],
                                    noise=torch.zeros_like(
                                        batch["image"][:JF_CHECK_B]))[0]
  x = pf.unflatten_latents(tokens)

  def adaptor_loss_grads(model):
    for p in model.parameters():
      p.grad = None
    z, ld = model(x)
    loss = (0.5 * (z ** 2).mean() - ld.mean() / z[0].numel())
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    for p in model.parameters():
      p.grad = None
    return loss.detach(), z.detach(), grads

  lk, zk, gk = adaptor_loss_grads(adaptor)
  from big_vision_torch.models.proj.jet import jet
  plain = jet.Model(**dict(config["adaptor"]["model"]),
                    image_shape=tuple(x.shape[1:]), attn_impl="xla")
  plain.load_state_dict(adaptor.state_dict())
  reset_launches(fa)
  lp, zp, gp = adaptor_loss_grads(plain)
  assert launches(fa) == dict.fromkeys(COUNTERS, 0), launches(fa)
  del plain
  z_err = rel_err(zk, zp)
  l_err = abs(lk.item() - lp.item()) / abs(lp.item())
  g_err, g_name = grads_close(gk, gp, JET_GRAD_BAR)
  print(f"jetformer adaptor auto (K1f/K2f) vs attn=xla, {JF_CHECK_B} images:"
        f" loss rel {l_err:.3e}, latents rel {z_err:.3e} (bar {JET_BAR}); "
        f"gradients: worst {g_err:.3e} at {g_name} (bar {JET_GRAD_BAR})")
  assert z_err <= JET_BAR and l_err <= JET_BAR, (z_err, l_err)
  del gk, gp, zk, zp

  fixed_ms = fixed_steps(trainer, batch, gpu, "jetformer 350M")
  total = torch.cuda.get_device_properties(0).total_memory / 2**30
  print(f"[{gpu}] jetformer_imagenet2012 350M (f32, head bf16), batch "
        f"{JF_B}: end to end {e2e:.3f} ms/step; fixed batch {fixed_ms:.3f} "
        f"ms/step, {JF_B / fixed_ms * 1e3:.1f} img/s; max memory allocated "
        f"{peak / 2**30:.2f} GiB of {total:.1f}")

  reset_launches(fa)
  torch.cuda.synchronize()
  t1 = time.perf_counter()
  sample = trainer.predict_fns()["sample_images"](
      None, {"text": torch.arange(JF_SAMPLES, device="cuda") * 7})
  torch.cuda.synchronize()
  secs = time.perf_counter() - t1
  images = sample["images"]
  sc = launches(fa)
  assert sc == {**dict.fromkeys(COUNTERS, 0), "K1f": blocks}, sc
  assert tuple(images.shape) == (JF_SAMPLES, 256, 256, 3), images.shape
  assert torch.isfinite(images).all() and images.abs().max() <= 1.0
  assert torch.isfinite(sample["logp"]).all()
  print(f"[{gpu}] jetformer sample: {JF_SAMPLES} class-conditional images "
        f"(CFG weight {trainer.config['sample_images']['cfg_inference_weight']}"
        f", temperature {trainer.config['sample_images']['temperature']}), "
        f"256 AR steps on the KV cache, the adaptor's inverse ({blocks} K1f) "
        f"and the patches: {secs:.3f} s; images in [-1, 1], mean "
        f"{images.mean().item():.4f}")
  del trainer
  gc.collect()
  torch.cuda.empty_cache()
  return counts


def jet_phase(fa, gpu):
  """Phase 16: Jet imagenet64 and JetFormer-350M (`jet_run`,
  `jetformer_run`); the K1f/K2f entries at Jet's conditioner shape and at
  the JetFormer adaptor's.
  Returns the launch counts and the kernels-line entries."""
  t0 = time.perf_counter()
  directory = os.path.join(ROOT, "build", "chip_smoke_jet")
  os.makedirs(directory, exist_ok=True)
  jet_counts = jet_run(fa, gpu, directory)
  t1 = phase_end("jet: imagenet64", t0)
  jf_counts = jetformer_run(fa, gpu, directory)
  phase_end("jet: jetformer", t1)
  out = {"JT": jet_counts, "JF": jf_counts}
  out["JT kernels"] = (
      f32_entries(fa, gpu, "Jet conditioner T=256", (JET_B, 256, 8, 64),
                  [jet_counts["K1f"], jet_counts["K2f"]])
      + f32_entries(fa, gpu, "JetFormer adaptor T=256", (JF_B, 256, 8, 64),
                    [jf_counts["K1f"], jf_counts["K2f"]]))
  shutil.rmtree(directory, ignore_errors=True)
  phase_end("jet", t0)
  return out


def bit_model(module, seed, device, **kw):
  """A BiT model from `seed`, with its GN params and head drawn around
  their inits, so that no branch and no logit is zero."""
  model = module.Model(device=device, **kw)
  model.initialize(torch.Generator(device=device).manual_seed(seed))
  gen = torch.Generator(device=device).manual_seed(seed + 1)
  from big_vision_torch.models import convnets
  with torch.no_grad():
    for name, p in model.named_parameters():
      if isinstance(model.get_submodule(name.rsplit(".", 1)[0]),
                    convnets.GroupNorm):
        p.add_(0.3 * torch.randn(p.shape, generator=gen, device=device))
    model.head.weight.normal_(0.0, 0.02, generator=gen)
  return model


@contextlib.contextmanager
def bit_branches(record=None, replay=None):
  """While open, the BiT models' relus and max-pools either record their
  branch (each relu's mask, each pool's argmax) in the list `record`, or
  take the recorded ones from `replay` in the same order. Two runs then
  compute one piecewise-linear function and differ only by rounding: in
  f32 a relu input within rounding of 0 (there are about 1e8 of them at
  R50x1, batch 8) would otherwise flip its mask on one side and move a
  gradient by a whole position's term."""
  from big_vision_torch.models import convnets
  relu, max_pool = torch.relu, convnets.max_pool
  replayed = iter(replay or [])

  def branch_relu(x):
    if record is not None:
      record.append(x > 0)
      return relu(x)
    return x * next(replayed).to(x.device, x.dtype)

  def branch_pool(x, window, strides, padding):
    (top, bottom), (left, right) = convnets.paddings(padding, x.shape[1:3],
                                                     window, strides)
    xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom),
               value=float("-inf"))
    if record is not None:
      y, idx = F.max_pool2d(xc, window, strides, return_indices=True)
      record.append(idx)
    else:
      idx = next(replayed).to(x.device)
      n, c = xc.shape[:2]
      y = xc.reshape(n, c, -1).gather(2, idx.reshape(n, c, -1)).reshape(
          idx.shape)
    return y.permute(0, 2, 3, 1)

  torch.relu, convnets.max_pool = branch_relu, branch_pool
  try:
    yield
  finally:
    torch.relu, convnets.max_pool = relu, max_pool


def bit_run(model, images, weights, branches):
  """(logits, pre_logits, {param: gradient}) of sum(logits * weights) on
  the model's device, on the CPU; the relu and pool branches recorded
  into `branches` where it is empty, replayed from it where it is not
  (`bit_branches`), the model's own where it is None."""
  model.zero_grad(set_to_none=True)
  if branches is None:
    ctx = contextlib.nullcontext()
  elif branches:
    ctx = bit_branches(replay=branches)
  else:
    ctx = bit_branches(record=branches)
  with ctx:
    logits, out = model(images)
    (logits * weights).sum().backward()
  return (logits.detach().cpu(), out["pre_logits"].detach().cpu(),
          {n: p.grad.cpu() for n, p in model.named_parameters()})


def bit_errors(got, want):
  """{"logits", "pre_logits", "grads": worst relative error over the
  params, "worst": that param's name}: max|got - want| / max|want|."""
  errs = {k: rel_err(g, w) for k, g, w in zip(("logits", "pre_logits"),
                                               got[:2], want[:2])}
  grads = {n: rel_err(got[2][n], w) for n, w in want[2].items()}
  errs["worst"] = max(grads, key=grads.get)
  errs["grads"] = grads[errs["worst"]]
  return errs


def bit_conv_kernels(prof):
  """[(kernel name, ms)] of the profile's convolution kernels."""
  (rows, _, _), = prof.values()
  return [(k, ms) for k, ms, _ in rows
          if any(c in k.lower() for c in CONV_KERNELS)]


def bit_parity(gpu, detail):
  """Phase 17a: R50x1 of `bit` and of `bit_paper` (1000 classes, random
  GN params and head) forward and backward on the card against the CPU at
  BIT_PARITY_B images of 224px, with cuDNN's TF32 flag left at PyTorch's
  default (on): logits, pre_logits and every param's gradient within
  BIT_BAR, on the same relu and pool branches (`bit_branches`). With
  `detail`, the run with free branches is printed beside it, the same
  with the model's TF32 guard taken away must miss the bar (the margin
  printed), and the conv kernels of a profiled step are named: none is a
  TF32 kernel."""
  import copy
  from big_vision_torch.models import bit, bit_paper, convnets
  assert torch.backends.cudnn.allow_tf32  # PyTorch's default
  gen = torch.Generator().manual_seed(SEED + 41)
  images = torch.rand((BIT_PARITY_B, 224, 224, 3), generator=gen) * 2 - 1
  weights = torch.randn((BIT_PARITY_B, 1000), generator=gen)
  for module in (bit, bit_paper):
    name = module.__name__.rsplit(".", 1)[1]
    cpu = bit_model(module, SEED + 42, "cpu", num_classes=1000)
    card = copy.deepcopy(cpu).cuda()
    x, w = images.cuda(), weights.cuda()
    branches = []
    t0 = time.perf_counter()
    got = bit_run(card, x, w, branches)
    want = bit_run(cpu, images, weights, branches)
    errs = bit_errors(got, want)
    print(f"[{gpu}] {name} R50x1, {BIT_PARITY_B} images of 224px, card vs "
          f"CPU in f32 (cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}"
          f", as PyTorch leaves it): logits {errs['logits']:.3e}, "
          f"pre_logits {errs['pre_logits']:.3e}, gradients "
          f"{errs['grads']:.3e} at worst ({errs['worst']}) on the same "
          f"branches (bar {BIT_BAR}); {time.perf_counter() - t0:.1f} s")
    assert max(errs[k] for k in ("logits", "pre_logits", "grads")) <= (
        BIT_BAR), errs
    if not detail:
      continue
    free = bit_errors(got, bit_run(cpu, images, weights, None))
    print(f"  on free branches the gradients differ by {free['grads']:.3e} "
          f"at worst ({free['worst']}), where an f32 relu mask flips")
    prof = kernel_timing.device_profile(
        {f"{name} step": lambda: bit_run(card, x, w, branches)},
        top=10_000, warm=False)
    convs = bit_conv_kernels(prof)
    assert convs and not any("tf32" in k.lower() for k, _ in convs), convs
    print(f"  its conv kernels in one profiled step, none TF32 ({len(convs)}"
          f" names): " + "; ".join(f"{k[:70]} {ms:.3f} ms"
                                   for k, ms in convs[:6]))
    ieee = convnets._ieee_f32
    convnets._ieee_f32 = contextlib.nullcontext
    try:
      tf32 = bit_errors(bit_run(card, x, w, branches), want)
      prof = kernel_timing.device_profile(
          {f"{name} TF32 step": lambda: bit_run(card, x, w, branches)},
          top=10_000, warm=False)
    finally:
      convnets._ieee_f32 = ieee
    worst = max(tf32[k] for k in ("logits", "pre_logits", "grads"))
    tf32_names = [k for k, _ in bit_conv_kernels(prof) if "tf32" in k.lower()]
    print(f"  without the model's TF32 guard: logits {tf32['logits']:.3e}, "
          f"pre_logits {tf32['pre_logits']:.3e}, gradients "
          f"{tf32['grads']:.3e} ({tf32['worst']}): {worst / BIT_BAR:.1f}x "
          f"the bar; {len(tf32_names)} TF32 conv kernels, e.g. "
          f"{tf32_names[0][:70] if tf32_names else 'none'}")
    assert worst > BIT_BAR, tf32
    del card, got, want, branches
    gc.collect()
    torch.cuda.empty_cache()


def write_bit_m(path):
  """A random BiT-M-R50x1 (21843-class head) from a seed, written as an
  `.npz` in the BiT release's TF layout: the stand-in for the published
  BiT-M file."""
  from big_vision_torch.models import bit_paper
  from big_vision_torch.utils import checkpoints
  from big_vision_torch.utils import convert
  model = bit_model(bit_paper, SEED + 43, "cuda", num_classes=21843)
  checkpoints.npz_save(bit_paper.to_big_transfer_format(
      convert.params(model)), path)
  return path


def conv_share(trainer, batch, gpu, what):
  """One profiled update: the top-8 device kernels, and the convolutions'
  share of the device's busy time."""
  from big_vision_torch.tools import bench_decode
  prof = kernel_timing.device_profile(
      {f"{what} step": lambda: trainer.update(batch)}, top=10_000)
  (rows, busy, wall), = prof.values()
  conv_ms = sum(ms for _, ms in bit_conv_kernels(prof))
  bench_decode.print_profile({f"{what} step": (rows[:8], busy, wall)},
                             prefix=f"[{gpu}] ")
  print(f"[{gpu}] {what}: convolutions {conv_ms:.3f} of {busy:.3f} ms "
        f"busy ({100 * conv_ms / busy:.1f}%)")
  return conv_ms / busy


def conv_layouts(trainer, batch, gpu, what, steps=2):
  """The update on a fixed batch with the convs in `channels_last` (the
  port's: NHWC memory end to end) and with each conv fed NCHW memory (its
  input made contiguous NCHW, so cuDNN runs its NCHW kernels and the layers
  after it see NCHW memory), in turns (port, NCHW, NCHW, port); CUDA
  events, `steps` updates each."""
  from big_vision_torch.models import convnets
  port = convnets.conv2d

  def nchw(x, w, strides, pads):
    return port(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), w,
                strides, pads)

  times = {"channels_last": [], "NCHW": []}
  for name in ("channels_last", "NCHW", "NCHW", "channels_last"):
    convnets.conv2d = port if name == "channels_last" else nchw
    try:
      trainer.update(batch)
      start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
      start.record()
      for _ in range(steps):
        trainer.update(batch)
      end.record()
      end.synchronize()
    finally:
      convnets.conv2d = port
    times[name].append(start.elapsed_time(end) / steps)
  print(f"[{gpu}] {what}: the update on a fixed batch with the convs in "
        + "; ".join(f"{k} " + ", ".join(f"{t:.3f}" for t in v) + " ms"
                    for k, v in times.items()) + " (in turns)")


def bit_recipe(fa, recipe, gpu, steps, detail):
  """Phase 17b/c: the recipe through `train.main` at full width and its
  per-card batch (no kernel launched), the loss falling on a fixed batch;
  with `detail` the profiled step and an update at twice the batch."""
  workdir = os.path.join(ROOT, "build", f"chip_smoke_{recipe['name']}")
  trainer, e2e = recipe_main_path(fa, recipe, workdir, gpu, steps=steps)
  what = f"{recipe['name']} ({recipe['what']})"
  batch, _, fixed_ms = recipe_fixed_steps(trainer, gpu, what)
  share = conv_share(trainer, batch, gpu, what) if detail else None
  print(f"[{gpu}] {what}, batch {trainer.batch_size}: end to end "
        f"{e2e['step_ms']:.3f} ms/step, {e2e['img/sec']:.1f} img/s, input "
        f"stall {e2e['input_stall_pct']:.3f}% (median of steps 2-{steps}); "
        f"fixed batch {fixed_ms:.3f} ms/step, "
        f"{trainer.batch_size * 1e3 / fixed_ms:.1f} img/s; max memory "
        f"allocated {e2e['peak'] / 2**30:.2f} GiB"
        + (f"; convolutions {100 * share:.1f}% of busy" if detail else ""))
  if detail and recipe["name"] == "bit_i1k":
    conv_layouts(trainer, batch, gpu, what)
  if detail:
    res, n = recipe["res"], trainer.config["num_classes"]
    batch_headroom(trainer, gpu, what, make_batch=lambda b: {
        "image": torch.randn((b, res, res, 3), device="cuda"),
        "labels": F.one_hot(torch.arange(b, device="cuda") % n, n).float()})
  shutil.rmtree(workdir, ignore_errors=True)
  del trainer, batch
  gc.collect()
  torch.cuda.empty_cache()


def write_r152x2(path):
  """A random BiT-M R152x2 teacher (1000 classes) from a seed as an `.npz`
  in the JAX layout: the stand-in for the published teacher."""
  from big_vision_torch.models import bit_paper
  from big_vision_torch.utils import checkpoints
  from big_vision_torch.utils import convert
  model = bit_model(bit_paper, SEED + 44, "cuda", num_classes=1000,
                    depth=152, width=2)
  checkpoints.npz_save(convert.params(model), path)
  return path


def bit_distill(gpu, directory, steps, detail):
  """Phase 17d: configs/proj/distill/bit_i1k.py (R152x2 teacher from an
  `.npz`, R50x1 student, both bit_paper) through the generic distill
  trainer at its per-card batch: its step-0 evals (the student's
  classification, the teacher's, the distances), `steps` steps, then on a
  fixed batch the student's step and the teacher's forward timed (its
  share of the step), the distillation loss on the unmixed batch falling,
  and a CKA eval of the student's and teacher's logits on BIT_CKA_N
  images; with `detail` an update at twice the batch."""
  from big_vision_torch.configs import common
  from big_vision_torch.evaluators import common as eval_common
  from big_vision_torch.trainers.proj.distill import distill
  teacher = write_r152x2(os.path.join(directory, "r152x2.npz"))
  workdir = os.path.join(directory, "distill")
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  trainer = distill.main([
      "--config", f"{BIT_DISTILL_CONFIG}:teacher_init={teacher},"
      f"neval={BIT_NEVAL},fewshot=none,stop={steps},log=1",
      "--workdir", workdir])
  wall = time.perf_counter() - t0
  assert trainer.batch_size == BIT_DISTILL_B, trainer.batch_size
  with open(os.path.join(workdir, "big_vision_metrics.txt")) as f:
    rows = list(map(json.loads, f))
  ev = rows[0]
  for name in ("student_minival", "student_val", "student_v2",
               "teacher_val"):
    assert 0 <= ev[f"{name}/prec@1"] <= 1, ev
  dist = {k: v for k, v in ev.items() if k.startswith("distance_val/")}
  assert len(dist) == 9 and all(map(math.isfinite, dist.values())), ev
  steps_rows = [r for r in rows if "training_loss" in r]
  assert [r["step"] for r in steps_rows] == list(range(1, steps + 1))
  assert all(math.isfinite(r["training_loss"]) for r in steps_rows)
  print(f"bit distill (R152x2 -> R50x1): {steps} steps of batch "
        f"{trainer.batch_size} after the step-0 evals ({wall:.1f} s); "
        f"distance_val " + ", ".join(f"{k[13:]} {v:.6f}"
                                     for k, v in dist.items() if "avg" in k)
        + "; losses " + " ".join(f"{r['training_loss']:.6f}"
                                 for r in steps_rows))

  it = trainer.input_iter()
  batch = next(it)
  it.close()
  teacher_model = trainer.teachers["prof_m"]

  def unmixed_loss():
    with torch.no_grad():
      logits = {"student": trainer.model(batch["image"])[0],
                "prof_m": teacher_model(batch["image"])[0]}
      return distill.distill_loss(trainer.config, logits)[0].item()

  before = unmixed_loss()
  fixed = RECIPE_FIXED_STEPS if detail else 2
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  for _ in range(fixed):
    trainer.update(batch)
  end.record()
  end.synchronize()
  step_ms = start.elapsed_time(end) / fixed
  after = unmixed_loss()
  with torch.no_grad():
    start.record()
    for _ in range(fixed):
      teacher_model(batch["image"])
    end.record()
    end.synchronize()
  teacher_ms = start.elapsed_time(end) / fixed
  peak = torch.cuda.max_memory_allocated()
  print(f"[{gpu}] bit distill, batch {trainer.batch_size}: end to end "
        f"{statistics.median(r['step_ms'] for r in steps_rows[1:]):.3f} "
        f"ms/step (steps 2-{steps}); fixed batch {step_ms:.3f} ms/step, the "
        f"teacher's forward {teacher_ms:.3f} ms ({100 * teacher_ms / step_ms:.1f}"
        f"% of the step); max memory allocated {peak / 2**30:.2f} GiB; the "
        f"unmixed distillation loss {before:.6f} -> {after:.6f}")
  assert math.isfinite(after) and after < before, (before, after)

  val = trainer.config["evals"]["distance_val"]
  [(_, cka, _, _)] = eval_common.from_config(
      {"evals": {"cka": dict(
          type="proj.distill.cka", pred="student_prof_m_fwd",
          data=common.stand_in("imagenet2012", "validation", n=BIT_CKA_N),
          pp_fn=val["pp_fn"], batch_size=BIT_CKA_B, log_steps=1)}},
      trainer.predict_fns(), get_steps=lambda key, cfg: 1)
  value = dict(cka.run(None))["cka"]
  print(f"[{gpu}] CKA of the student's and the teacher's logits on "
        f"{BIT_CKA_N} images in batches of {BIT_CKA_B}: {value:.6f} (the "
        f"unbiased estimator may fall below 0 for unrelated features)")
  assert math.isfinite(value) and abs(value) <= 1 + 1e-6, value
  if detail:
    batch_headroom(trainer, gpu, "bit distill (R152x2 -> R50x1)")
  os.remove(teacher)
  shutil.rmtree(workdir, ignore_errors=True)


def bit_phase(fa, gpu, detail=True):
  """Phase 17: BiT (`bit_parity`, `bit_recipe` on BIT_RECIPES,
  `bit_distill`), with cuDNN's TF32 flag at PyTorch's default (on) for its
  duration: the models turn TF32 off themselves. With `detail` (--bit)
  BIT_STEPS loop steps, the profiled steps and the batch headroom; in the
  full script BIT_FULL_STEPS and neither. Returns no kernel entries: no
  kernel of the port is on BiT's path."""
  t0 = time.perf_counter()
  gc.collect()
  torch.cuda.empty_cache()
  directory = os.path.join(ROOT, "build", "chip_smoke_bit")
  os.makedirs(directory, exist_ok=True)
  torch.backends.cudnn.allow_tf32 = True
  try:
    bit_parity(gpu, detail)
    t1 = phase_end("bit: parity", t0)
    steps = BIT_STEPS if detail else BIT_FULL_STEPS
    init = write_bit_m(os.path.join(directory, "bit_m_r50x1.npz"))
    for recipe in BIT_RECIPES:
      recipe = dict(recipe, args=recipe["args"].format(init=init,
                                                       n=BIT_NEVAL))
      bit_recipe(fa, recipe, gpu, steps, detail)
      t1 = phase_end(f"bit: {recipe['name']}", t1)
    os.remove(init)
    bit_distill(gpu, directory, steps, detail)
    phase_end("bit: distillation", t1)
  finally:
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(directory, ignore_errors=True)
  phase_end("bit", t0)
  return {"BT kernels": []}


def phase_end(name, t0):
  """Prints the wall time since `t0` of a phase; returns the time now."""
  now = time.perf_counter()
  print(f"phase {name}: {now - t0:.1f} s wall")
  return now


def main(argv):
  if argv not in ([], ["--checks"], ["--serving"], ["--recipes"],
                  ["--quality"], ["--siglip"], ["--paligemma"],
                  ["--imagetext"], ["--naflex"], ["--jet"], ["--bit"]):
    print(f"usage: chip_smoke.py [--checks | --serving | --recipes | "
          f"--quality | --siglip | --paligemma | --imagetext | --naflex | "
          f"--jet | --bit]; got {argv}", file=sys.stderr)
    return 2
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 1
  from big_vision_torch.ops import _build
  from big_vision_torch.ops import decode_attention as da
  from big_vision_torch.ops import flash_attention as fa

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  gpu = nvidia_smi()
  print(f"gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")

  # 1. Build.
  t0 = time.perf_counter()
  logs = _build.build_all(["flash_fwd", "flash_fwd_tc", "flash_bwd",
                           "flash_bwd_tc",
                           "flash_blocked_fwd",
                           "flash_blocked_bwd", "flash_blocked_bwd_fused",
                           "decode_attention"])
  print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
  from big_vision_torch import native
  print(f"built the JPEG decoder (big_vision_torch/native/dataio.cc with "
        f"g++), linking {native.linked_library()}")
  for name, log in logs.items():
    for line in log.splitlines():
      if "Compiling entry function" in line:  # the mangled kernel name
        print(f"  {name}: {line.split(chr(39))[1][:80]}")
      elif "Used" in line or "spill" in line:
        print(f"  {name}: {line.strip()}")

  t0 = phase_end("build", t0)
  if argv == ["--serving"]:  # the build and phase 3 alone
    serving_phase(fa, da, gpu)
    print(f"{nvidia_smi()}: the serving phases passed")
    return 0
  if argv == ["--recipes"]:  # the build and phase 9 alone
    recipes_phase(fa, gpu)
    print(f"{nvidia_smi()}: the ImageNet recipes phase passed")
    return 0
  if argv == ["--quality"]:  # the build and phase 10 alone
    quality_phase(fa, gpu)
    print(f"{nvidia_smi()}: the quality phase passed")
    return 0
  if argv == ["--siglip"]:  # the build and phase 11 alone
    siglip_phase(fa, gpu)
    print(f"{nvidia_smi()}: the SigLIP phase passed")
    return 0
  if argv == ["--paligemma"]:  # the build and phase 12 alone
    paligemma_phase(fa, gpu)
    print(f"{nvidia_smi()}: the PaliGemma fine-tuning phase passed")
    return 0
  alone = {"--imagetext": (imagetext_phase, "IT kernels"),  # phase 14
           "--naflex": (naflex_phase, "NX kernels"),  # phase 15
           "--jet": (jet_phase, "JT kernels"),  # phase 16
           "--bit": (bit_phase, "BT kernels")}  # phase 17: none
  if argv and argv[0] in alone:  # the build and that phase alone
    phase, key = alone[argv[0]]
    counts = phase(fa, gpu)
    print(nvidia_smi())
    print(json.dumps({"kernels": counts[key]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

  # 2. Kernels vs plain versions.
  counts = {"K1 err": check_k1(fa), "K2 err": check_k2(fa)}
  counts["K6 bf16 err"], counts["K6 int8 err"] = check_k6(da)
  counts.update({f"{k} err": e for k, e in check_blocked(fa).items()})
  counts["K5 err"] = check_fused(fa)
  torch.cuda.empty_cache()
  t0 = phase_end("kernels vs plain versions", t0)
  check_native(gpu)
  t0 = phase_end("JPEG decoder vs PIL and the RGB path", t0)
  if argv:  # --checks: the build and the checks alone
    print(f"{nvidia_smi()}: every kernel and the JPEG decoder built and "
          f"within their bars")
    return 0

  # 3. Serving PaliGemma-3B, without the decode profiles and the plain
  # paths' times, which `--serving` runs: the script's time limit.
  counts.update(serving_phase(fa, da, gpu, profiles=False))
  torch.cuda.empty_cache()
  t0 = phase_end("serving", t0)
  # 4. Training ViT-B/16; 5. training FlexiViT-B; 6. distilling
  # FlexiViT-B (launches per step); 7. distilling DeiT-III into
  # FlexiViT-B; 8. the generic distill trainer; 9. the ImageNet recipes.
  host_decode_rate(gpu)
  t0 = phase_end("host decode rate", t0)
  counts.update(training_phase(fa, gpu))
  t0 = phase_end("ViT-B/16 training", t0)
  counts.update(flexi_phase(fa, gpu))
  t0 = phase_end("FlexiViT-B training", t0)
  counts.update(distill_phase(fa, gpu))
  t0 = phase_end("FlexiViT-B distillation", t0)
  deit3_phase(fa, gpu)
  t0 = phase_end("DeiT-III distillation", t0)
  distill_smoke_phase(fa)
  t0 = phase_end("generic distillation smoke", t0)
  recipes_phase(fa, gpu)
  t0 = phase_end("ImageNet recipes", t0)
  # 10. The dynamics twin; quality_digits' 2000 host-bound steps, which
  # `--quality` runs, are left out: the script's time limit.
  gc.collect()
  torch.cuda.empty_cache()
  twin_run(fa, gpu)
  t0 = phase_end("the dynamics twin", t0)
  siglip_phase(fa, gpu)
  # Without the fixed-batch steps in turns and their profiles, which
  # `--paligemma` runs: the script's time limit.
  counts.update(paligemma_phase(fa, gpu, detail=False))
  counts.update(imagetext_phase(fa, gpu))
  counts.update(naflex_phase(fa, gpu))
  counts.update(jet_phase(fa, gpu))
  bit_phase(fa, gpu, detail=False)
  t0 = time.perf_counter()

  # 13. Kernel times.
  kernels = kernel_entries(fa, da, counts, gpu)
  phase_end("kernel times", t0)
  for kern in kernels:
    lib = kern["library_ms"]
    print(f"[{gpu}] {kern['name']}: {kern['ms']:.4f} ms (bound "
          f"{kern['bound_ms']:.4f} ms by {kern['bound_by']}), plain "
          f"{kern['plain_ms']:.4f} ms, SDPA "
          f"{'none' if lib is None else f'{lib:.4f} ms'}, "
          f"{kern['launches']} launches")

  print(nvidia_smi())  # the card's name and power limit, as nvidia-smi reads
  print(json.dumps({"kernels": kernels}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main(sys.argv[1:]))
