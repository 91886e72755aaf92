#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU and check them.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  0. device: the card's name and power limit; TF32 off for fp32 matmuls and
     convolutions, so fp32 comparisons are exact-math comparisons.
  1. build every kernel from diffbir_tpu_torch/csrc, one nvcc per source, all
     started together: K1/K3 (flash forward: the tensor-core entries for
     bf16 at d = 64 and 128, the wide tensor-core K1_wide for bf16 at d =
     512, the CUDA-core entries K1_cc/K3_cc for fp32, d = 256 and K3 at d =
     512), K2a/K2b (flash backward: the tensor-core entries for bf16
     at d = 64 and 128, the wide tensor-core K2a_wide/K2b_wide with their
     delta pre-pass K2_delta for bf16 at d = 512, the CUDA-core entries
     K2a_cc/K2b_cc for fp32 and d = 256), K4 (int8 matmul: the tensor-core tile form, the GEMV form
     K4_gemv, the CUDA-core entry K4_cc), K5 (packed-int4 matmul: the same
     three, K5, K5_gemv, K5_cc), K6 (fused ResBlock: the tensor-core entry
     for bf16, the CUDA-core entry K6_cc for fp32), K7 (fused GEGLU FFN: the
     tensor-core entry, the CUDA-core entry K7_cc for fp32); the count of
     HGMMA/HMMA instructions in the tensor-core kernels (cuobjdump -sass,
     where the toolkit has it).
  2. K1 against its plain PyTorch version at the serving shapes, the
     training shapes (with lse), the VAE's d = 512 shapes (on K1_wide: from
     FLASH_MIN_WIDE = 4096 tokens, where the dispatch sends them to flash,
     and a ragged one below), the captioner's vision tower ([1,577,16,64]),
     ragged, Sq != Skv, d = 128, fp32 and strided cases, each saying by
     counter which entry ran (``fwd_entries``); a tensor-core K1 that skips
     the last kv tile must fail the o and lse limits; median times of the
     entry, the plain version and the library call beside the bound (at d =
     512 the reading behind FLASH_MIN_WIDE: K1_wide against plain); at
     [2,4096,5,64], [8,4096,5,64] with lse and [1,577,16,64] the CUDA-core
     entry on the same inputs too, with TFLOP/s; then K1_wide where the
     untiled VAE's d = 512 mid-block runs it at 1024x1024 ([1,16384,1,512]
     bf16) and at 1024x512 ([1,8192,1,512]): one K1_wide launch each, o and
     lse against the plain version, beside SDPA (the backend it took named),
     the bound and, at 16384 tokens, the CUDA-core entry on the same inputs;
     the entry run without its last kv tile must fail the o and lse limits.
  3. K1 with its logsumexp, K2a (dq) and K2b (dk, dv) against their plain
     versions at the training shapes (batch 8), ragged cases (Sq and Skv
     multiples of neither tile, Sq != Skv, less than one tile), a strided
     case (views of one projection, a strided dO), fp32 cases and d =
     128/256/512, each saying by counter which entry ran; the backward run
     twice must give bit-identical gradients; a kernel that skips a kv tile
     must fail the limits (their power); median times of kernel, plain
     version and the library call (scaled_dot_product_attention forward, and
     its backward through autograd), beside the bound; at [8,4096,5,64] the
     tensor-core entries beside the CUDA-core ones, with TFLOP/s.
     [d512_backward]: the VAE's d = 512 mid-block attention under a gradient
     (RGB guidance's), bf16, at [1,4096,1,512], [1,8192,1,512], the band
     [1,8192,1,512] x 16384 kv rows, [1,16384,1,512] and [1,65536,1,512]:
     the wide backward (K2_delta, K2a_wide, K2b_wide) one launch each,
     bit-identical on a rerun, against the plain versions (over q-row
     chunks past 16384^2), a skipped kv tile failing the limits; each entry
     timed alone beside its plain version, SDPA's backward and the bound;
     forward plus backward three ways (K1_wide + the wide backward, the
     plain version under autograd with its peak memory, SDPA) at 4096, 8192
     and 16384 tokens; the dispatch's threshold under a gradient
     (FLASH_MIN_WIDE_GRAD) held to the reading; K2a_cc and K2b_cc at
     [1,4096,1,512] against their plain versions and timed alone.
  4. the serving modes' and the captioner's kernels at their paths' shapes,
     each against its plain version, each with a planted fault that must
     fail the limits, and with median times of kernel, plain version and a
     library yardstick beside the bound: K3 at the 4 self-attention shapes
     of the 512x512 path (batch 2, on its tensor-core entry, with the
     CUDA-core entry K3_cc on the same inputs; fault: q scaled twice), K4 at
     its 18 dense shapes and at the int8 captioner's 6, each on the entry
     that quant_entries names (by counter), K4_cc on the same inputs, device
     times (the GEMV form's over weights rotated past the L2 cache) beside
     one host call (faults: the tile form's last 64-deep K stage dropped;
     one K split of the GEMV form dropped; a GEMV rerun must be
     bit-identical), K5 at the LLaVA-1.5-7B prefill (M = 624: the tile form)
     and decode (M = 1: the GEMV form) shapes of the 7 big linears, ragged
     and fp32 cases, each on the entry that int4_entries names (by counter),
     K5_cc on the same inputs, device times (the GEMV's weights rotated past
     L2) beside one host call (fault: the two scale groups of every window
     swapped, in both forms; a GEMV rerun must be bit-identical), K6 float
     and int8 at the 14 ResBlock sites on its tensor-core entry (by
     counter), K6_cc on the same inputs, device times beside one host call,
     the launches of one call apart (profiler), the unfused module and the
     site's two bf16 cuDNN convolutions as yardsticks, the K split against
     none at three sites (faults: the last tap of conv2 skipped; conv2's
     first K split dropped; reruns bit-identical), K7 at the 4 FFN shapes on
     its tensor-core entry (by counter),
     K7_cc on the same inputs, device times beside one host call (fault:
     the value and gate halves swapped).
  5. model call: one full-width SD2.1 ControlLDM forward (random bf16 weights)
     at batch 2 on a 64x64 latent, through K1 and through plain attention;
     then [hoist]: the same model's call at t = 999 through the hoisted
     tables of the CLI's EDM grid (the cross-attention k/v of the default
     prompts, every ResBlock's timestep rows) against its in-loop call
     (limit BF16_TOL x max|ref|), the launches of the tables and of the
     call, and a planted fault (the next grid timestep's rows) that must
     fail the limit.
  6. serving path: SwinIRPipeline.run on 512x512 uint8 LQs, 50 spaced steps,
     CFG 4.0, the v2.1 schedule, hoisting on (the pipeline's default), the
     JAX CLI's default prompts through a seeded stand-in tokenizer (cond and
     uncond on distinct ids), distinct seeds, then one seed again; K1's
     launch count per request, latency, stage split and peak memory.
  7. the serving modes: one full-width model call in the "fused" mode
     (fused ResBlock + fused FFN + packed flash: K6, K7, K3) against the
     unfused float path on the same weights, its [hoist] check, then
     SwinIRPipeline.run on 512x512 LQs in that mode; then a copy of the
     model with its UNet and ControlNet quantised ("int8": int8 dense +
     fused ResBlock on int8 convs + packed: K4, K6, K3), one model call
     against the unfused path on the dequantised weights, its [hoist] check
     (the tables: 55 K4 launches; a hoisted step: 230), and requests in
     that mode (50 x 230 + 55 K4 tile launches each, no GEMV). Each model
     call records every kernel call's shape and checks it against the site
     tables below; each request checks its launch counts, latency, stage
     split and peak memory. Then [samplers]: every other sampler of the CLI
     on a 256x256 condition (stage 2, SAMPLER_STEPS steps, CFG 4.0, eta 1),
     twice from one seed: finite, bit-identical, K1 only. [turbo] at the
     model call: through each of the five samplers that take the turbo model
     function, the cached model at interval 1 bit-equal to the plain model
     function with and without the UNet encoder cache (interval 2 not).
     [fast_gelu] at the model call: the tanh GELU within MODEL_REL_TOL of
     erf; under --fused_ffn bit-equal to --fused_ffn alone, K7 unchanged.
  8. the LLaVA-1.5-7B captioner at full width (CLIP ViT-L/14-336 +
     projector + Llama-7B, random bf16 weights from seed 0 generated on the
     card), a seeded 512x512
     LQ, a 624-row prompt of stand-in ids, 60 greedy tokens with an EOS that
     never matches, in the modes int4 (K5: 224 tile and 13216 GEMV
     launches), int8 (K4) and bf16: exact launch counts, stage times,
     tokens/s and peak memory per mode; for int4 and
     int8, teacher forcing of the generated ids through the same model on
     the plain products (logits within a relative limit, ids equal to the
     plain argmax wherever its top-2 margin exceeds it). Then one captioned
     request: the int4 caption of the LQ, then SwinIRPipeline.run on it,
     the caption's ids as the positive prompt's text.
  9. [cli_request]: ``python -m diffbir_tpu_torch.inference --task sr
     --upscale 4`` run in this process on a seeded 128x128 PNG with the
     CLI's defaults (v2.1, 10 steps of edm_dpm++_3m_sde at CFG 6.0, the
     default prompts through a stand-in merges file the smoke writes under
     build/), random full-width weights; seconds per stage, exact launches
     (K1 230; with --quant_dense --fused_resblock --quant_conv, K3 230, K6
     320 and K4 2355 tile launches), the PNG equal to a direct
     ``pipeline.run`` of the request, a rerun bit-identical. The same for
     the other tasks and versions (CLI_PATHS, each K1 230 + K1_wide 2):
     [cli_request_v2] (--version v2: the BSRNet x4 cleaner on the PNG, eps
     schedule), [cli_denoise_v2] (--task denoise --version v2: SCUNet),
     [cli_denoise] (--task denoise, v2.1 SwinIR), [cli_face] (--task face
     on a 512x512 PNG at --upscale 1), [cli_custom] (--version custom: a
     train config holding train_stage2_v2.1.yaml's model section, the SD
     base and the ControlNet written in bf16 from a random full-width model
     under build/, the seconds of the writing printed). [cleaner_bsrnet]:
     the full-width BSRNet cleaner alone on a 256x256 LQ, tiled 128/64 and
     untiled: shape, finiteness, seconds, peak memory.
     [guidance]: the same request at --guidance --g_scale 0.5 with latent
     mse, RGB w_mse, and RGB w_mse at --g_repeat 2 --g_start 600 --g_stop
     200 (GUIDANCE_PATHS): exact launches (those of the default request, and
     for RGB one K1_wide with lse, K2_delta, K2a_wide and K2b_wide a guided
     decode), the PNG equal to pipeline.run's, a rerun bit-identical, and
     the final latent (or decoded image) closer to the guidance target than
     the unguided request's; w_mse on the latent and guidance with dpm++_m2
     raise ValueError. [guidance_1024]: RGB guidance on a 256x256 PNG at
     --upscale 4, untiled, --steps 2 (16384 tokens in the decoder's
     mid-block): the same checks against the unguided request on that PNG,
     one guidance step through the full-width decoder on the flash and the
     plain route (the step and the attention's dq, dk, dv agreeing, a
     skipped kv tile failing), peak memory beside the request with the
     plain route forced. [turbo]: the request at --control_interval 2 and 3, each
     with and without --turbo_encoder, and with the int8 flags at 2
     (TURBO_PATHS): exact launches from the site tables (K1 195, 188, 160,
     146; int8: K3 195, K6 270, K4 2005), PSNR/SSIM against interval 1 and
     the request and denoise seconds beside it; --cldm_tiled with turbo
     raises ValueError. One request with --fast_gelu (FAST_GELU_PATHS).
     [tiled_request]: first at full width on the model of phase 5, one
     denoise step's tiled model call (9 latent tiles of 64x64 over 128x128,
     3 a call, three seeds) against a per-tile loop written here (limit
     TILED_CALL_TOL x max|ref|) and each tile's rows of one call bit-equal
     to a call that repeats that tile (planted fault for both: every tile
     handed tile 0's hint), the streamed sync_gn decode of a 128x128 latent against
     Decoder(gn_cross=True) on the stacked tiles (limit BF16_TOL x
     max|ref|; planted fault: per-tile GroupNorm statistics), and the
     sync_gn VAE's peak memory streamed against the gn_cross modules on the
     stacked tiles at 1024^2 and 2048^2 (streamed below stacked); then the CLI
     on a seeded 256x256 PNG at --upscale 4 (a 1024x1024 condition) at
     --steps TILED_STEPS in six
     variants (TILED_VARIANTS: every tiling, once more bit-identical; 3
     tiles a call; the sync_gn VAE; the diffusion alone tiled; untiled;
     the int8 flags): exact launches (K1_wide 2 where the VAE is untiled),
     seconds per stage, peak device memory (the tiled one below the
     untiled), the PNG's size.
     The unaligned face path and the serving front ends: [face_detect] the
     full-width RetinaFace (ResNet-50, random frozen-BatchNorm weights from
     a seed, its heads scaled by 1/20) on a seeded 640x640 image: loc, conf
     and landms against the same module on the CPU at fp32, with cuDNN's
     TF32 on (a process's default; limit TF32_TOL x max|ref|) and off
     (FACE_FP32_TOL), then detect_faces' ms warm; [face_parse] ParseNet at
     512x512 the same way, parse's ms; [face_blur] the helper's Gaussian
     blur (grouped convolutions) on the card with TF32 on in the process
     against the CPU (BLUR_TOL), its ms; [cli_unaligned_face] ``python -m
     diffbir_tpu_torch.inference --task unaligned_face --upscale 2`` on a
     seeded 256x256 PNG, RetinaFace and ParseNet read strictly from
     facexlib-layout files written from those random weights, the
     landmarks fixed to two faces through the loop's face_helper: exact
     launches (three 512x512 requests: K1 690, K1_wide 6), seconds per
     stage (detect/align and paste apart), the files and the merged PNG, a
     rerun bit-identical; [http_serve] diffbir_tpu_torch.serve's
     BatchingServer and handler on 127.0.0.1 (an ephemeral port) over the
     v2.1 sr pipeline at --upscale 4: 4 concurrent same-key 128x128 PNGs ->
     one pipeline call at batch 4 (K1 230, K1_wide 2), 2 of another seed ->
     another call, a --batch 1 server's response bit-equal to pipeline.run,
     latency p50/p95 at batch 1 and 4, peak memory; [demo_http] one run_gradio
     request through its _Handler equal to process() called directly. Each
     time and memory figure of these phases is printed beside the card's
     name and power limit.
 10. training path: stage-2 IRControlNet train steps at full width (SD2.1 +
     IRControlNet with gradient checkpointing, ControlNet initialised from the
     UNet, frozen realesrgan SwinIR cleaner, v2.1 schedule, noise aug at 200,
     lr 1e-5), batch 8 at 512x512 from seeded numpy, empty prompts: 2 warm-up
     and 5 timed steps; finite losses, only the ControlNet changes, K1/K2a/K2b
     launches per step (all on the tensor-core entries, none on the CUDA-core
     ones); then at batch 2 one step's ControlNet gradient through
     K1+K2 against the same through plain attention, and the same with the
     attention sites' q/k/v gradients dropped must fail the limits.
 11. RAM++ and the file-driven trainer. [ram]: RAM++ at full width (swin-L
     at 384x384, 4585 classes x 51 descriptors, bf16, random weights) on a
     seeded image: logits against the same weights in fp32 on the CPU (limit
     RAM_REL_TOL x max|ref|), each stage's error and the same weights' in
     fp32 on the card, two planted faults that must fail the limit, ms per
     image, peak memory, no kernel of the port (its attention is plain
     math). [cli_ram_caption]: one --captioner
     ram CLI request, RAM++ read from a checkpoint of those weights and a
     stand-in tag list whose thresholds pass every RAM_EVERY-th tag: the
     caption equal to those tags, prompt.csv holding it, K1 230 + K1_wide 2.
     [train_data]: realesrgan_dataset on 16 synthetic 512x512 PNGs plus the
     v2.1 batch transform at batch 8: seconds per batch, gt and lq ranges.
     [train_cli]: ``python -m diffbir_tpu_torch.train_stage2`` in this
     process on a copy of train_stage2_v2.1.yaml (the txt list of the
     folder, batch 8, queue 16, 2 steps, a log line and launch counts each
     step, a checkpoint at 2, the SD base and SwinIR from random bf16
     files): K1 39, K1_wide 2, K2a 16 and K2b 16 a step, none on the
     CUDA-core entries; step and data-wait seconds beside [train]'s bare
     step; the checkpoint files; a resume from step 2 whose restored fp32
     masters and AdamW moments are bit-equal to the saved ones, on for two
     steps and then TRAIN_STEADY_STEPS more with no checkpoint inside (one
     at the end): their waits on the data, the step's own work and the
     worker's transform seconds; the preview at 4 images (K1 1150, K1_wide
     2). [train_custom]: one --version custom request with the trained
     controlnet_2.pth (K1 230 + K1_wide 2, the PNG equal to pipeline.run's).
 12. the other training paths. [train_ddp]: the stage-2 trainer under the
     multi-process environment (DIFFBIR_COORDINATOR on 127.0.0.1, one
     process: nccl at world size 1) with train.fsdp off and on, DDP_STEPS
     steps on [train_cli]'s recorded batches: losses and fp32 masters
     bit-equal to [train_cli]'s, K1 39, K1_wide 2, K2a 16, K2b 16 a step,
     the step seconds beside the plain ones, the process group destroyed
     after; a run with the reduced gradients zeroed must fail that check.
     [train_native]: the codeformer dataset through the C++ loader (``make
     -C native`` at first use) where it builds: its centre crops equal to
     the Python path's, seconds a batch of each; else the reason and the
     Python path. [train_stage1]:
     ``python -m diffbir_tpu_torch.train_stage1`` on a copy of
     train_stage1.yaml at full width, at the first batch of STAGE1_BATCHES
     that fits (the config's 96 first), on that many synthetic 512x512
     PNGs: s/step, images/s, the data wait, the step's own work, peak
     memory, the validation, a checkpoint and a resume bit-equal, 0
     launches of any kernel of the port. [degrade_batch]: diff_jpeg and the
     batch noise and filter functions at batch 8, 512x512, on the card
     against the CPU (a transposed quantisation table must fail), ms a
     batch.
 13. multi-process inference (``parallel/inference.py``, ``parallel/tp.py``)
     on the full-width SD2.1 ControlLDM in bf16, random from seed 0.
     [parallel_inference]: two processes on this card (gloo: nccl refuses
     two ranks on one device; the DIFFBIR_* launch contract), rank 1 built
     from seed 1 until the broadcast of (d) gives it rank 0's weights; the
     parent computes one process's run of each case on the same weights and
     inputs, and its spread: (a) the spatial-parallel denoiser on a 128x128
     latent (the 1024x1024 request's; the condition ramped along H), one
     64-row band a process, against the unsharded forward; (b) the
     tensor-parallel denoiser (tp_shard_, hoisted tables made after it) at
     batch 2 on 64x64 against the plain hoisted forward; (c)
     make_tile_sharded_fn over the tiled 1024x1024 request's 9 diffusion
     tiles (pipeline.tile_model_function, 5 a process, one padded) against
     make_tiled_fn; (d) batch_parallel on two CLI-size requests (128x128
     LQs pre-upscaled to 512x512, 10 steps of edm_dpm++_3m_sde, CFG 6.0),
     one a process, against one process on both rows; (e)-(i), every model
     of the restoration path banded: (e) SwinIR on the 1024x1024 request's
     pre-upscaled input, (f) the VAE at 1024x1024 (the moments, a posterior
     sample on the whole latent's noise, the decode; K1_wide at
     [1,8192,1,512] x 16384 kv rows, once a process each), (g) SCUNet at
     512x512 and BSRNet on a 256x256 LQ, (h) SwinIR tensor-parallel at
     512x512, (i) the whole 1024x1024 sr request banded
     (spatial_parallel_request, 2 steps) against SwinIRPipeline.run; (j)
     the "fused" and the "int8" serving modes, each on a copy of the model
     (set_mode: the int8 weights quantised in place), as (a) under SP and
     as (b) under TP, against one process in the same mode. Each within
     PAR_TOL x max|ref| (each limit above its spread); seven planted faults
     (SP with zeroed halos, SP with GroupNorm statistics kept local, TP
     without the row layers' all-reduce, SwinIR's roll without its wrap,
     every band masked as the last, the Downsample's halo row from above,
     SP in the fused mode with K6 on the band alone) must fail them; exact
     launches per process (K1; in the modes K3, K4, K4_gemv, K6, K7) and
     K1's and K3's shapes (under SP at Sq != Skv), none on another entry;
     per-process seconds and peak memory above the resident weights beside
     one process's, marked as two processes sharing one card; each mode's
     weights a process. The workers build their models while this process
     computes the references; K1, K3 and K1_wide are timed at the band
     shapes once they are done.
     [parallel_nccl]: the same four APIs at world size 1 on nccl in this
     process, bit-equal to the plain runs where the code path is the same
     (TP, both tile APIs, the request) and (a) within its limit.
Each phase group's seconds print as "[clock]" lines.
The second-to-last line is a JSON list of the kernels, every "ms" and
"library_ms" the median of single host calls timed by CUDA events (K1_wide's
at [1,16384,1,512], the untiled 1024x1024 VAE's mid-block); K4-K7
add "device_ms" and "library_device_ms", the device time per call of
launches run back to back (K6 also "conv_library_device_ms", the site's two
bf16 cuDNN convolutions alone). The last line is {"ok": true, "device":
{...}}.
"""

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

STEPS, CFG, SIZE = 50, 4.0, 512
SEEDS = (1, 2)
# Kernel vs plain version, error limit = TOL * max|ref| (the reference's own
# size, so small gradients get a small limit). bf16: both sides accumulate in
# fp32 and round p, ds and the output to bf16; they differ where the fp32 sums
# fall on either side of a rounding step, by one bf16 ulp of an element, at
# most 2^-7 of the largest one: the limit is two such ulps. fp32 (and the
# logsumexp, fp32 on both sides for either input dtype): the same math with
# sums in another order, ~1e-6 relative.
BF16_TOL, FP32_TOL, MODEL_REL_TOL = 2.0 ** -6, 1e-4, 5e-2
# self-attention sites per denoise step: UNet 6 in + 1 mid + 9 out,
# ControlNet 6 in + 1 mid, each called once at batch 2 under folded CFG.
K1_SITES_PER_STEP = 23
K1_PER_REQUEST = K1_SITES_PER_STEP * STEPS
# The VAE's d = 512 mid-block attention, once in the encoder and once in the
# decoder of a request, goes to flash from FLASH_MIN_WIDE = 4096 latent
# tokens (a 512x512 condition and larger) and runs on the wide tensor-core
# K1 (K1_wide); a tiled VAE's tiles (1024-2916 tokens) take plain math.
K1_WIDE_PER_REQUEST = 2
# Training step: gradients reach the 7 ControlNet sites and the 9 UNet
# output-block sites, not the UNet's 6 input and 1 middle sites (control is
# added after the middle block). K1 runs at all 23 sites in the forward, and
# again at the 16 sites with gradients when checkpointing recomputes them;
# the frozen VAE encodes the batch's gt and its cleaned lq, [8,4096,1,512]
# each, on K1_wide without a gradient.
K2_SITES_PER_TRAIN_STEP = 7 + 9
K1_PER_TRAIN_STEP = K1_SITES_PER_STEP + K2_SITES_PER_TRAIN_STEP
K1_WIDE_PER_TRAIN_STEP = 2
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_TIMED = 8, 2, 3
# kernel vs plain attention, one step's ControlNet gradient at batch 2 in
# bf16: both paths round every activation and gradient to bf16 and differ
# only where attention rounds (one bf16 ulp of an element, see BF16_TOL).
# Measured on an H100: norms 1.8e-4 apart, 1 - cosine 7e-6; the limits are
# ~10x those. The same step with the attention sites' q/k/v gradients dropped
# must fail them (the check's power is shown in the run).
GRAD_COS_MIN, GRAD_NORM_REL_TOL = 0.9999, 2e-3
# [train]'s timed step seconds, read by [train_cli] beside its own steps
TRAIN_STEP_S = []
# RAM++ at full width (swin-L at 384^2, 4585 classes x 51 descriptors, bf16,
# random weights from RAM_SEED): its logits against the same weights in fp32
# on the CPU, limit RAM_REL_TOL x max|ref|, and its sigmoids (what the tag
# thresholds read) within RAM_PROB_TOL. At random_init_'s fan-in scale a
# class's query is ~1 % of the tagging head's input, so the logits spread
# over the classes by 1 % of their mean (std 0.0032 about -0.34), below
# bf16's rounding, and no limit on them could tell one class from another.
# The label rows are therefore scaled by RAM_LABEL_SCALE and wordvec_proj's
# weights by RAM_QUERY_SCALE (N(0, 1)): the logits spread by std 0.39
# about -0.34, as a trained head's vary from class to class. Measured on an
# H100 over two images: 9.5e-3-9.8e-3 x max|ref| and 5.0e-3-5.2e-3 (the
# limits ~2.5x and ~2x those); the same weights in fp32 on the card read
# within RAM_FP32_TOL, so the gap is bf16's rounding; two planted faults
# (the label rows rolled by one class, the last tagging layer skipped)
# read 1.0 and must read above RAM_REL_TOL. The
# --captioner ram request reads those weights from a file, and a stand-in
# tag list of 4585 tags whose every RAM_EVERY-th threshold sits RAM_MARGIN
# below that class's probability on the request's PNG (the rest at 2.0,
# which no probability passes), so the caption is known.
RAM_SEED, RAM_REL_TOL, RAM_PROB_TOL, RAM_EVERY, RAM_MARGIN = 41, 2.5e-2, 1e-2, 50, 0.02
RAM_FP32_TOL = 1e-5
RAM_LABEL_SCALE, RAM_QUERY_SCALE = 3.0, 512 ** 0.5
# the training data and the file-driven trainer: a folder of TRAIN_IMAGES
# synthetic 512x512 PNGs, the v2.1 train config at batch TRAIN_BATCH with a
# pool of TRAIN_QUEUE pairs, TRAIN_CLI_STEPS steps, a checkpoint every
# TRAIN_CKPT_EVERY, the preview at PREVIEW_N images
TRAIN_ROOT = os.path.join("build", "train_cli")
TRAIN_IMAGES, TRAIN_QUEUE, TRAIN_CLI_STEPS, TRAIN_CKPT_EVERY, PREVIEW_N = 16, 16, 2, 2, 4
# then TRAIN_STEADY_STEPS more steps with no checkpoint inside, to read the
# loop's waits on the data in its steady state; [train_data]'s transform
# seconds, read beside them
TRAIN_STEADY_STEPS = 2
TRAIN_DATA_S = []
# [train_ddp]: the stage-2 trainer under the multi-process environment
# (nccl, one process) for DDP_STEPS steps with fsdp off and on, each step on
# the batch that [train_cli]'s first run took at that step (recorded there,
# with its losses), so its masters are held against [train_cli]'s
# checkpoint DDP_STEPS.pt. The one process's reduction is an identity (a
# sum over one rank), so losses and masters must be bit-equal to
# [train_cli]'s (read bit-equal, fsdp off and on, in every run since it was
# written); a run whose reduced gradients are zeroed (the state left as it
# was) must fail that check
DDP_STEPS = TRAIN_CKPT_EVERY
TRAIN_CLI_BATCHES, TRAIN_CLI_RUN = [], {}
# [train_stage1]: the stage-1 trainer at full width on STAGE1_ROOT's PNGs,
# at the first batch of STAGE1_BATCHES (the config's 96 first) whose step
# runs with a peak below STAGE1_MEMORY_SHARE of the card; STAGE1_WARMUP +
# STAGE1_TIMED steps, a validation over STAGE1_VAL batches and a checkpoint
# at the last step, then a resume from it
STAGE1_ROOT = os.path.join("build", "train_stage1")
STAGE1_BATCHES = (96, 64, 48, 40, 32, 24, 16, 8)
STAGE1_MEMORY_SHARE = 0.9
STAGE1_WARMUP, STAGE1_TIMED, STAGE1_VAL = 1, 1, 1
# [train_native]: the codeformer dataset at batch NATIVE_BATCH, NATIVE_BATCHES
# batches through each path
NATIVE_BATCH, NATIVE_BATCHES = 8, 2
# [degrade_batch]: diff_jpeg and the batch noise and filter functions at
# batch DEGRADE_BATCH on SIZE x SIZE fp32 (TF32 off), the card against the
# CPU within DEGRADE_TOL x max|ref|. Two steps are discontinuous, and fp32
# summation order can put an element on either side: JPEG's rounding of a
# DCT coefficient (an 8x8 block moves a whole quantisation step where a
# coefficient lies within JPEG_AMBIGUOUS steps of a half on the CPU; such
# blocks are counted and left out: fp32 puts a coefficient within 3.8e-6
# steps of float64's at these inputs, measured on the CPU, and 1e-4 leaves
# out ~300 of 3.1 M coefficients), and the unsharp mask's threshold (the
# card's output is held against the CPU's arithmetic on the card's mask;
# the elements where the masks differ are counted). The Poisson draws
# differ on the two devices: each image's noise std within POISSON_STD_TOL
# of the CPU's.
DEGRADE_BATCH, DEGRADE_TOL, JPEG_AMBIGUOUS, POISSON_STD_TOL = 8, 1e-5, 1e-4, 0.02
JPEG_QUALITIES = (30.0, 45.0, 60.0, 75.0, 90.0, 35.0, 50.0, 85.0)
# The serving modes, per model call at batch 2 (folded CFG) on a 64x64 latent:
# K6 runs at every ResBlock, 32: the UNet's 8 input, 2 middle and 12 output
# blocks (whose inputs concatenate the skips, hence Cin up to 2560) and the
# ControlNet's 8 + 2, keyed (Cin, Cout, H = W);
K6_SITES = {(320, 320, 64): 4, (960, 320, 64): 1, (640, 320, 64): 2, (320, 640, 32): 2,
            (640, 640, 32): 2, (1920, 640, 32): 1, (1280, 640, 32): 1, (960, 640, 32): 1,
            (640, 1280, 16): 2, (1280, 1280, 16): 2, (2560, 1280, 16): 2,
            (1920, 1280, 16): 1, (1280, 1280, 8): 8, (2560, 1280, 8): 3}
# the 23 transformers (7 at each of the levels 64^2, 32^2, 16^2: UNet 2 input
# + 3 output, ControlNet 2; 2 in the middles at 8^2) hold one FFN (K7, keyed
# tokens per image, width) and one self-attention site (K3, keyed tokens,
# heads of 64) each;
K7_SITES = {(4096, 320): 7, (1024, 640): 7, (256, 1280): 7, (64, 1280): 2}
K3_SITES = {(4096, 5): 7, (1024, 10): 7, (256, 20): 7, (64, 20): 2}
K6_PER_CALL, K7_PER_CALL, K3_PER_CALL = 32, 23, 23
# K4 (int8 dense), keyed (M rows, K, N). A model call on its own (no
# hoisting): per transformer 8 width-square products on the 2*tokens rows
# (proj_in, self q/k/v/out, cross q/out, proj_out), the cross k/v as one
# product over cat(to_k, to_v) on the 2 x 77 text rows (N = 2 C), GEGLU proj
# (N = 8 C) and net.2 (K = 4 C); per ResBlock emb_layers.1 on the 2 timestep
# rows (Cout 320 at 7 blocks, 640 at 7, 1280 at 18): 23 x 11 + 32 = 285.
# A hoisted denoise step drops the k/v and emb_layers.1 products (23 x 10 =
# 230 a step); a request makes them once instead: the 23 k/v products and
# the 32 timestep tables on the T model timesteps of the sampler's grid.
LEVELS = ((4096, 320, 7), (1024, 640, 7), (256, 1280, 7), (64, 1280, 2))
EMB_SITES = ((320, 7), (640, 7), (1280, 18))
K4_PER_CALL, K4_PER_STEP, KV_SITES = 285, 230, 23


def _add(sites: dict, key, n: int) -> None:
    sites[key] = sites.get(key, 0) + n


def hoist_sites(rows: int) -> dict:
    """The K4 products that hoisting takes out of the step: each
    transformer's cross k/v on the 2 x 77 text rows, each ResBlock's
    emb_layers.1 on ``rows`` timestep rows (2 in a model call, the grid's T
    in a request's tables)."""
    sites = {}
    for _, c, n in LEVELS:
        _add(sites, (154, 1024, 2 * c), n)
    for c, n in EMB_SITES:
        _add(sites, (rows, 1280, c), n)
    return sites


def step_sites() -> dict:
    """The K4 products of a hoisted denoise step."""
    sites = {}
    for tokens, c, n in LEVELS:
        m = 2 * tokens
        _add(sites, (m, c, c), 8 * n)
        _add(sites, (m, c, 8 * c), n)
        _add(sites, (m, 4 * c, c), n)
    return sites


K4_STEP_SITES = step_sites()
K4_SITES = dict(K4_STEP_SITES)
for _key, _n in hoist_sites(2).items():
    _add(K4_SITES, _key, _n)
assert sum(K4_SITES.values()) == K4_PER_CALL and sum(K4_STEP_SITES.values()) == K4_PER_STEP
# K4's entries (ops/quant_matmul.py::quant_entries): the GEMV form at M <= 8
# (the 32 timestep-embedding sites of an in-loop call), the tensor-core tile
# form elsewhere (the timestep tables too: 11 or 50 rows)
GEMV_MAX_ROWS = 8
K4_GEMV_PER_CALL = sum(c for (m, _, _), c in K4_SITES.items() if m <= GEMV_MAX_ROWS)
K4_TILE_PER_CALL = K4_PER_CALL - K4_GEMV_PER_CALL
# a request's hoisting: the k/v products and one table per ResBlock
K4_PER_HOIST = KV_SITES + sum(n for _, n in EMB_SITES)
# Per request (STEPS hoisted model calls): "fused" (fused ResBlock + fused
# FFN + packed flash) and "int8" (int8 dense + fused ResBlock on int8 convs +
# packed flash).
PER_REQUEST = {
    "serve": {"K1": K1_PER_REQUEST, "K1_wide": K1_WIDE_PER_REQUEST},
    "serve_fused": {"K3": K3_PER_CALL * STEPS, "K6": K6_PER_CALL * STEPS,
                    "K7": K7_PER_CALL * STEPS, "K1_wide": K1_WIDE_PER_REQUEST},
    "serve_int8": {"K3": K3_PER_CALL * STEPS, "K4": K4_PER_STEP * STEPS + K4_PER_HOIST,
                   "K6": K6_PER_CALL * STEPS, "K1_wide": K1_WIDE_PER_REQUEST},
}
# The CLI's default request (python -m diffbir_tpu_torch.inference --task sr
# --upscale 4 on a 128x128 PNG: 10 steps of edm_dpm++_3m_sde at CFG 6.0, a
# 512x512 condition, v2.1, random weights), and the same with the int8 flags
# (--quant_dense --fused_resblock --quant_conv): its timestep tables hold the
# 11 timesteps of the EDM grid.
CLI_STEPS, CLI_LQ, CLI_UPSCALE = 10, 128, 4
CLI_DEFAULT = {"K1": K1_SITES_PER_STEP * CLI_STEPS, "K1_wide": K1_WIDE_PER_REQUEST}
# The other tasks and versions (PR 13), each on a 512x512 condition and so
# with the default request's launches: the v2 BSRNet sr path (x4 on the
# 128x128 PNG itself), the v2 SCUNet denoise path and the v2.1 SwinIR one
# (pre-upscaled x4), the v2.1 face path on a 512x512 PNG at --upscale 1,
# and --version custom (a train config beside the PNG holding
# configs/train/train_stage2_v2.1.yaml's model section; the SD base and the
# ControlNet written in bf16 from a random full-width model, CUSTOM_SEED).
CUSTOM_ROOT = os.path.join("build", "cli_request", "cli_custom")
CUSTOM_SEED = 231
CLI_PATHS = {
    "cli_request": (CLI_DEFAULT, []),
    "cli_request_int8": ({"K3": K3_PER_CALL * CLI_STEPS, "K6": K6_PER_CALL * CLI_STEPS,
                          "K4": K4_PER_STEP * CLI_STEPS + K4_PER_HOIST,
                          "K1_wide": K1_WIDE_PER_REQUEST},
                         ["--quant_dense", "--fused_resblock", "--quant_conv"]),
    "cli_request_v2": (CLI_DEFAULT, ["--version", "v2"]),
    "cli_denoise_v2": (CLI_DEFAULT, ["--task", "denoise", "--version", "v2"]),
    "cli_denoise": (CLI_DEFAULT, ["--task", "denoise"]),
    "cli_face": (CLI_DEFAULT, ["--task", "face", "--upscale", "1"]),
    "cli_custom": (CLI_DEFAULT, [
        "--version", "custom", "--train_cfg", os.path.join(CUSTOM_ROOT, "train.yaml"),
        "--ckpt", os.path.join(CUSTOM_ROOT, "controlnet.pt")]),
}
# the PNG's side where it is not CLI_LQ
CLI_LQ_SIZE = {"cli_face": 512, "cli_guidance_rgb_1024": 256, "cli_unguided_1024": 256,
               "cli_guidance_rgb_1024_plain": 256}
# [cleaner_bsrnet]: the full-width BSRNet x4 cleaner alone, tiled at the
# CLI's --cleaner_tile_size 128 --cleaner_tile_stride 64 on a 256x256 LQ
CLEANER_LQ, CLEANER_TILE, CLEANER_STRIDE = 256, 128, 64
# [tiled_request]: the CLI on a seeded 256x256 PNG at --upscale 4, a 1024x1024
# condition (the JAX package's scripts/bench_highres.py workload), the CLI's
# tile sizes (cleaner 512/256, VAE 256, diffusion 512/256): 9 cleaner tiles,
# 49 + 49 blend VAE tiles (sync_gn: 16 + 16), 9 latent tiles of 64x64 per
# step, each group of tiles one model call at batch 2 x tiles_per_batch (not
# hoisted: 23 K1 a call). An untiled VAE runs its d = 512 mid-block on the
# 128x128 latent's 16384 tokens: flash, on K1_wide, once in the encoder and
# once in the decoder. Variant f: b with the int8
# flags, 285 K4 a call (in-loop: the 32 timestep rows of batch 6 on the
# GEMV form, the rest on the tile form), 32 K6 and 23 K3.
TILED_LQ = 256
TILED_SIZE = TILED_LQ * CLI_UPSCALE
TILED_ALL = ["--cleaner_tiled", "--vae_encoder_tiled", "--vae_decoder_tiled", "--cldm_tiled"]
CLDM_TILES = 9
# the tiled model call's check, one step at each seed; at three tiles a
# call (batch 6) against one tile a call (batch 2) it read 0.78-0.89 of
# BF16_TOL x max|ref| on the H100 over these seeds, its planted fault 41x.
# A row's value depends on its batch position, not on the other rows: the
# bf16 3x3 convolutions at the 8x8 level (cuDNN) round the same image
# another way at another position (python3 -m diffbir_tpu_torch.batch_rows);
# so the call is also held, bit for bit, to calls that repeat one tile, at
# the same position.
TILED_CALL_SEEDS = (13, 14, 15)
TILED_CALL_TOL = 4 * BF16_TOL
# outputs at which the sync_gn VAE's memory is read, streamed and stacked
SYNC_GN_SIZES = (1024, 2048)
# the variants run TILED_STEPS steps of the CLI's sampler (--steps; the
# CLI's default is CLI_STEPS): one tile a call costs ~0.1 s of host
# enqueue a tile a step, so the depth is cut to keep the smoke inside its
# call; every variant and check stays
TILED_STEPS = 2
TILED_CALLS = CLDM_TILES * TILED_STEPS
INT8_FLAGS = ["--quant_dense", "--fused_resblock", "--quant_conv"]
STEPS_FLAG = ["--steps", str(TILED_STEPS)]
TILED_VARIANTS = {
    "a": (TILED_ALL + STEPS_FLAG, {"K1": TILED_CALLS * K1_SITES_PER_STEP}),
    "b": (TILED_ALL + ["--cldm_tiles_per_batch", "3"] + STEPS_FLAG,
          {"K1": TILED_CALLS // 3 * K1_SITES_PER_STEP}),
    "c": (TILED_ALL + ["--vae_tile_mode", "sync_gn"] + STEPS_FLAG,
          {"K1": TILED_CALLS * K1_SITES_PER_STEP}),
    "d": (["--cldm_tiled"] + STEPS_FLAG, {"K1": TILED_CALLS * K1_SITES_PER_STEP,
                                          "K1_wide": K1_WIDE_PER_REQUEST}),
    "e": (STEPS_FLAG, {"K1": TILED_STEPS * K1_SITES_PER_STEP, "K1_wide": K1_WIDE_PER_REQUEST}),
    "f": (TILED_ALL + ["--cldm_tiles_per_batch", "3"] + INT8_FLAGS + STEPS_FLAG,
          {"K3": TILED_CALLS // 3 * K3_PER_CALL, "K6": TILED_CALLS // 3 * K6_PER_CALL,
           "K4": TILED_CALLS // 3 * K4_TILE_PER_CALL,
           "K4_gemv": TILED_CALLS // 3 * K4_GEMV_PER_CALL}),
}
# [guidance]: the CLI request guided at --g_scale 0.5, toward the cleaned
# condition image's latent (mse) or the image itself through the decoder
# (RGB, w_mse). Each RGB guidance step decodes its x0 under a gradient: the
# decoder's mid-block attention at 4096 tokens (FLASH_MIN_WIDE_GRAD) takes
# K1_wide with lse, then the delta pre-pass, K2a_wide and K2b_wide, once per
# decode: every step of the 10 (guided_launches), and with --g_repeat 2
# twice at each of the 4 steps whose model t lies in [200, 600] (599, 499,
# 399, 299). w_mse on the latent fails, as in JAX.
GUIDANCE = ["--guidance", "--g_scale", "0.5"]


def guided_launches(base: dict, decodes: int) -> dict:
    """The launches of a request with ``decodes`` RGB guidance decodes at or
    above FLASH_MIN_WIDE_GRAD tokens on top of ``base``."""
    return {**base, "K1_wide": base["K1_wide"] + decodes, "K1_wide_lse": decodes,
            "K2_delta": decodes, "K2a_wide": decodes, "K2b_wide": decodes}


GUIDANCE_PATHS = {
    "cli_guidance_latent_mse": (CLI_PATHS["cli_request"][0], GUIDANCE + ["--g_loss", "mse"]),
    "cli_guidance_rgb": (guided_launches(CLI_PATHS["cli_request"][0], CLI_STEPS),
                         GUIDANCE + ["--g_space", "rgb"]),
    "cli_guidance_rgb_window": (guided_launches(CLI_PATHS["cli_request"][0], 8), GUIDANCE + [
        "--g_space", "rgb", "--g_repeat", "2", "--g_start", "600", "--g_stop", "200"]),
}
# [guidance_1024]: RGB guidance on a 256x256 PNG at --upscale 4, untiled (a
# 128x128 latent: 16384 tokens in the decoder's mid-block), at the tiled
# variants' --steps 2: K1 46, K1_wide 2 without lse (the encode and the
# final decode) and 2 with lse (one guided decode a step), delta, K2a_wide
# and K2b_wide 2 each; with the plain route forced (FLASH_MIN_WIDE_GRAD past
# the tokens) the default request's launches
GUIDED_1024 = "cli_guidance_rgb_1024"
GUIDED_1024_FLAGS = GUIDANCE + ["--g_space", "rgb"] + STEPS_FLAG
GUIDED_1024_PLAIN = {"K1": TILED_STEPS * K1_SITES_PER_STEP, "K1_wide": K1_WIDE_PER_REQUEST}
GUIDED_1024_PATHS = {GUIDED_1024: (guided_launches(GUIDED_1024_PLAIN, 2), GUIDED_1024_FLAGS)}
# [turbo]: a model call's self-attention sites (each with 10 K4 products in
# the int8 mode) and ResBlocks, by part: the UNet's encoder (input blocks and
# middle: 6 + 1 sites, 8 + 2 ResBlocks) and decoder (9, 12), the ControlNet
# (7, 10). A request at --control_interval k refreshes the ControlNet on
# ceil(10 / k) of its 10 calls; with --turbo_encoder the UNet's encoder too.
UNET_ENC_SITES, UNET_DEC_SITES, CN_SITES = 7, 9, 7
UNET_ENC_RES, UNET_DEC_RES, CN_RES = 10, 12, 10
K4_PER_SITE = K4_PER_STEP // K1_SITES_PER_STEP


def turbo_launches(k: int, encoder: bool, int8: bool = False) -> dict:
    """Exact launches of the CLI request at --control_interval k."""
    refreshes = -(-CLI_STEPS // k)
    every, refreshed = (UNET_DEC_SITES, CN_SITES + UNET_ENC_SITES) if encoder else (
        UNET_DEC_SITES + UNET_ENC_SITES, CN_SITES)
    sites = every * CLI_STEPS + refreshed * refreshes
    if not int8:
        return {"K1": sites, "K1_wide": K1_WIDE_PER_REQUEST}
    res = (UNET_DEC_RES * CLI_STEPS + (CN_RES + UNET_ENC_RES) * refreshes if encoder
           else (UNET_DEC_RES + UNET_ENC_RES) * CLI_STEPS + CN_RES * refreshes)
    return {"K3": sites, "K6": res, "K4": K4_PER_SITE * sites + K4_PER_HOIST,
            "K1_wide": K1_WIDE_PER_REQUEST}


TURBO_PATHS = {
    f"cli_turbo_k{k}{'_encoder' if enc else ''}": (
        turbo_launches(k, enc), ["--control_interval", str(k)] + ["--turbo_encoder"] * enc)
    for k in (2, 3) for enc in (False, True)}
TURBO_PATHS["cli_turbo_k2_int8"] = (turbo_launches(2, False, int8=True),
                                    ["--control_interval", "2"] + INT8_FLAGS)
assert [TURBO_PATHS[p][0]["K1"] for p in ("cli_turbo_k2", "cli_turbo_k3", "cli_turbo_k2_encoder",
                                           "cli_turbo_k3_encoder")] == [195, 188, 160, 146]
assert (K1_SITES_PER_STEP == UNET_ENC_SITES + UNET_DEC_SITES + CN_SITES
        and K6_PER_CALL == UNET_ENC_RES + UNET_DEC_RES + CN_RES
        and TURBO_PATHS["cli_turbo_k2_int8"][0]["K6"] == 270
        and turbo_launches(1, False, int8=True) == CLI_PATHS["cli_request_int8"][0])
TURBO_SAMPLER_STEPS = 4  # DDIM takes no 3-step uniform grid over 1000 steps
# [fast_gelu]: the tanh GELU changes no launch
FAST_GELU_PATHS = {"cli_fast_gelu": (CLI_PATHS["cli_request"][0], ["--fast_gelu"])}
# the VAE's mid-block attention of an untiled request at 1024x1024 and at
# 1024x512 (8192 latent tokens)
VAE_MID_SHAPES = ((1, TILED_SIZE ** 2 // 64, 1, 512), (1, 8192, 1, 512))
# the decoder's mid-block attention under RGB guidance's gradient, (B, Sq,
# Skv) at d = 512: a 512x512 request, 1024x512, the band of a 1024x1024
# decode on two processes (8192 queries against 16384 gathered kv rows), an
# untiled 1024x1024 request and a 2048x2048 one
D512_GRAD_SHAPES = ((1, 4096, 4096), (1, 8192, 8192), (1, 8192, 16384), (1, 16384, 16384),
                    (1, 65536, 65536))
# the guidance step through the full-width decoder and its mid-block
# attention's gradients, flash route against the plain route, x max|plain|
GUIDED_GRAD_TOL = BF16_TOL
# the token counts whose forward plus backward readings set
# FLASH_MIN_WIDE_GRAD: the smallest at which flash beats plain under
# autograd there and at every larger one
D512_GRAD_THRESHOLDS = (4096, 8192, 16384)
# Sq x Skv past which plain's [Sq, Skv] fp32 tensors do not fit beside each
# other: the plain versions are then evaluated over q-row chunks, and plain
# under autograd is not timed (SDPA is the only yardstick)
D512_PLAIN_MAX = 16384 * 16384
D512_REF_ROWS = 2048
# the other samplers of the CLI, one 256x256 request each, twice
SAMPLER_SIZE, SAMPLER_STEPS = 256, 2
MODE_SEEDS = (1,)
# The LLaVA-1.5-7B captioner: 35 prompt ids before the image (BOS first), its
# 576 patch embeddings, 13 ids after (the 624 prefill rows of
# scripts/bench_llava.py), 60 new tokens; the EOS id never matches, so every
# caption runs the prefill and 59 decode steps (the 60th token's step is
# skipped). K5 (int4) or K4 (int8) runs at the 7 big linears of the 32
# layers in each of those 60 passes; K1 at the tower's 23 layers that run.
CAPTION_PRE, CAPTION_POST, CAPTION_NEW, NEVER_EOS = 35, 13, 60, -1
CAPTION_ROWS = CAPTION_PRE + 576 + CAPTION_POST
LLAMA_LAYERS = 32
QUANT_PER_CAPTION = 7 * LLAMA_LAYERS * CAPTION_NEW
K1_PER_CAPTION = 23
QUANT_PREFILL_PER_CAPTION = 7 * LLAMA_LAYERS  # the prefill's 624 rows: the tile forms
CAPTION_PATHS = {
    "caption_int4": {"K1": K1_PER_CAPTION, "K5": QUANT_PREFILL_PER_CAPTION,
                     "K5_gemv": QUANT_PER_CAPTION - QUANT_PREFILL_PER_CAPTION},
    "caption_int8": {"K1": K1_PER_CAPTION, "K4": QUANT_PREFILL_PER_CAPTION,
                     "K4_gemv": QUANT_PER_CAPTION - QUANT_PREFILL_PER_CAPTION},
    "caption_bf16": {"K1": K1_PER_CAPTION},
    "captioned_request": {"K1": K1_PER_CAPTION + K1_PER_REQUEST,
                          "K1_wide": K1_WIDE_PER_REQUEST,
                          "K5": QUANT_PREFILL_PER_CAPTION,
                          "K5_gemv": QUANT_PER_CAPTION - QUANT_PREFILL_PER_CAPTION},
}
# (M, K, N) of the 7 linears per layer and pass: q/k/v/o, gate/up, down;
# M = 624 in the prefill, 1 in each of the 59 decode steps
LLAVA_SITES = {(4096, 4096): 4, (4096, 11008): 2, (11008, 4096): 1}
# the teacher-forced check: the kernel path's logits at the 60 generated
# positions against the plain products' on the same ids, error limit
# CAPTION_REL_TOL x max|plain logits|. Both paths round every activation to
# bf16 and differ in sum order (and decode against prefill), so a
# difference grows through 32 layers: measured 1.85e-2 on an H100 in both
# quantised modes. The float model's logits on the same ids must fail the
# limit against the int4 path's plain products (the check's power).
CAPTION_REL_TOL = 3e-2
# H100 SXM peaks (NVIDIA's data sheet): dense bf16 tensor cores, fp32 on the
# CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# device_ms's head start for the host: ~10 ms of the card's clock
SLEEP_CYCLES = 20_000_000
# the GEMV form's weights are cold in a decode step (7 GiB of int8 weights
# pass per token): its timings rotate through copies of more than the 50 MB
# L2 cache
L2_BYTES = 50 * 2**20


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn(i)``, i = 0, 1, ..., run back to back:
    the card sleeps while the host enqueues the calls, so the host's time
    per call (the wrapper's Python) does not show, as it does in
    ``median_ms`` for calls below ~0.1 ms."""
    import torch

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    e0.record()
    for i in range(iters):
        fn(i)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def bound_ms(products: int, b: int, h: int, sq: int, skv: int, d: int, dtype,
             n_bytes: int):
    """The least time for ``products`` matrix products of 2*Sq*Skv*d flops
    per (batch, head) and ``n_bytes`` moved: (ms, "operations" or "bytes")."""
    flops = products * 2.0 * b * h * sq * skv * d
    t_ops = flops / PEAK_FLOPS[str(dtype)[6:]]
    t_bytes = n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def gemm_bound(m: int, k: int, n: int, *tensors):
    """(ms, "operations" or "bytes") of an M x K x N product that reads and
    writes ``tensors`` once, against the bf16 tensor-core peak."""
    t_ops = 2.0 * m * k * n / PEAK_FLOPS["bfloat16"]
    t_bytes = nbytes(*tensors) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def per_caption_ms(times: dict) -> float:
    """Kernel ms per caption from per-shape ms keyed (M, K, N): the prefill
    once and 59 decode steps, 32 layers each."""
    return LLAMA_LAYERS * sum(
        c * (times[(CAPTION_ROWS, k, n)] + (CAPTION_NEW - 1) * times[(1, k, n)])
        for (k, n), c in LLAVA_SITES.items())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# the card's name and power limit, as nvidia-smi gives them: printed beside
# the face and serving phases' times and memory
CARD = []


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    for line in smi.stdout.strip().splitlines():
        print(line)
    CARD.append(smi.stdout.strip().splitlines()[0].strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[device] torch", torch.__version__, "cuda", torch.version.cuda,
          "| TF32 off for fp32 matmuls and cuDNN convolutions")


# name -> CudaKernel of every kernel the port has, filled by main() once the
# port is imported
KERNELS = {}
# K1_wide's launches with lse (tally_wide_lse)
WIDE_LSE = {"K1_wide_lse": 0}


def fill_kernels() -> None:
    from diffbir_tpu_torch.ops import flash_attention as fa
    from diffbir_tpu_torch.ops import fused_ffn as ff
    from diffbir_tpu_torch.ops import fused_resblock as fr
    from diffbir_tpu_torch.ops import quant_matmul as qm

    KERNELS.update(K1=fa.KERNEL_TC, K1_wide=fa.KERNEL_WIDE_TC, K1_cc=fa.KERNEL,
                   K2a=fa.KERNEL_DQ_TC, K2b=fa.KERNEL_DKV_TC, K2_delta=fa.KERNEL_DELTA,
                   K2a_wide=fa.KERNEL_DQ_WIDE_TC, K2b_wide=fa.KERNEL_DKV_WIDE_TC,
                   K2a_cc=fa.KERNEL_DQ, K2b_cc=fa.KERNEL_DKV,
                   K3=fa.KERNEL_PRESCALED_TC, K3_cc=fa.KERNEL_PRESCALED, K4=qm.KERNEL_TC,
                   K4_gemv=qm.KERNEL_GEMV, K4_cc=qm.KERNEL, K5=qm.KERNEL_INT4_TC,
                   K5_gemv=qm.KERNEL_INT4_GEMV, K5_cc=qm.KERNEL_INT4, K6=fr.KERNEL_TC,
                   K6_cc=fr.KERNEL, K7=ff.KERNEL_TC, K7_cc=ff.KERNEL)


def phase_build():
    """One nvcc per source, all started together, then every entry point
    loaded (K1/K3 and K2a/K2b and their CUDA-core entries share a library
    each); the tensor-core instructions of the flash kernels."""
    from diffbir_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.load_all(list(KERNELS.values()))
    sources = sorted({k.source.name for k in KERNELS.values()})
    print(f"[build] {', '.join(sources)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    seen = set()
    for kernel in KERNELS.values():
        if kernel.source in seen:
            continue
        seen.add(kernel.source)
        for line in kernel.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {kernel.source.name}:", line.strip())
    specs = (("K1", ("flash_fwd_tc_kernel", "flash_fwd_wide_kernel")),
             ("K2a", ("flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel",
                      "flash_bwd_dq_wide_kernel", "flash_bwd_dkv_wide_kernel")),
             ("K4", ("quant_matmul_tc_kernel",)), ("K5", ("int4_tc_kernel",)),
             ("K6", ("conv_tc_kernel",)), ("K7", ("geglu_tc_kernel", "down_tc_kernel")))
    tool = os.path.join(os.path.dirname(_cuda.find_nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        print("[build] cuobjdump not in the toolkit: SASS not counted")
        return
    # one cuobjdump per library, all started together
    libs = [_cuda.build(KERNELS[key].source)[0] for key, _ in specs]
    procs = [subprocess.Popen([tool, "-sass", str(lib)], stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True) for lib in libs]
    for (_, names), lib, proc in zip(specs, libs, procs):
        tensor_core_sass(lib, proc.communicate(timeout=120)[0], names)


def tensor_core_sass(lib, sass: str, names) -> None:
    """HGMMA (wgmma) and HMMA (mma.sync) instructions per kernel function of
    the library ``lib``, from its ``cuobjdump -sass`` output; the
    tensor-core kernels ``names`` must have some."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += "HMMA" in line
    for name in names:
        found = {f: c for f, c in counts.items() if name in f}
        check(bool(found), f"no {name} in {lib.name}'s SASS")
        for f, (hgmma, hmma) in sorted(found.items()):
            # the template arguments, mangled as I Li64E Lb0E ... E, with the
            # types 13__nv_bfloat16 and f among them
            args = re.match(r"I((?:L[ib]\d+E|13__nv_bfloat16|f)+)E", f.split(name)[1])
            inst = ", ".join(
                {"13__nv_bfloat16": "bf16", "f": "fp32"}.get(a, a[2:-1])
                for a in re.findall(r"L[ib]\d+E|13__nv_bfloat16|f", args.group(1))
            ) if args else ""
            print(f"[build] SASS {name}<{inst}>: {hgmma} HGMMA, {hmma} HMMA")
            check(hgmma > 0, f"{f} has no wgmma instruction")
    cores = [c for f, c in counts.items()
             if "_tc_" not in f and not any(name in f for name in names)]
    print(f"[build] SASS of the {len(cores)} CUDA-core instances in {lib.name}: "
          f"{sum(c[0] for c in cores)} HGMMA, {sum(c[1] for c in cores)} HMMA")


def sdpa_fwd(q, k, v, scale=None):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), scale=scale)


def limit_of(ref, tol: float) -> float:
    """The error limit against a reference: ``tol`` times its largest |value|."""
    return tol * ref.float().abs().max().item()


def qkv_case(gen, shape, dtype):
    """q, k, v of one attention case: (B, Sq, Skv, H, D), or "strided": views
    of one [2, 4096, 3*320] projection, read in place."""
    import torch

    if shape == "strided":
        qkv = torch.randn(2, 4096, 960, generator=gen, device="cuda").to(dtype)
        return tuple(t.reshape(2, 4096, 5, 64) for t in qkv.chunk(3, dim=-1))
    b, sq, skv, h, d = shape
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype)
    return (q, *(torch.randn(b, skv, h, d, generator=gen, device="cuda").to(dtype)
                 for _ in range(2)))


def fwd_errors(outs, refs, tol):
    """{name: (max abs error, limit)} of o (tol x max|ref|) and of lse, when
    there is one (FP32_TOL x max|ref|)."""
    return {n: ((o.float() - r.float()).abs().max().item(),
                limit_of(r, FP32_TOL if n == "lse" else tol))
            for n, o, r in zip(("o", "lse"), outs, refs)}


def phase_kernel(fa):
    """K1 against its plain version at the serving and training shapes (with
    lse), the VAE's d = 512 shapes, the captioner's vision tower
    ([1,577,16,64]), ragged, Sq != Skv, d = 128, fp32 and strided cases,
    each on the entry that ``fwd_entries`` names (by counter); at the three
    headline shapes the CUDA-core entry on the same inputs and the planted
    fault too. Returns the kernel lines' numbers of K1 and K1_cc at
    [2,4096,5,64] bf16 and the largest o error of K1_wide."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    # (B, Sq, Skv, H, D) or "strided", dtype, with lse
    cases = [((2, 4096, 4096, 5, 64), bf, False), ((8, 4096, 4096, 5, 64), bf, True),
             ((2, 1024, 1024, 10, 64), bf, False), ((2, 256, 256, 20, 64), bf, False),
             ((2, 64, 64, 20, 64), bf, False), ((2, 4000, 4000, 5, 64), bf, False),
             ((2, 1000, 300, 5, 64), bf, True), ((2, 1024, 1024, 8, 128), bf, True),
             ((1, 577, 577, 16, 64), bf, False), ((1, 4096, 4096, 1, 512), bf, False),
             ((8, 4096, 4096, 1, 512), bf, False), ((1, 1000, 1000, 1, 512), bf, False),
             ((1, 8192, 8192, 1, 512), bf, False), ((2, 1024, 1024, 10, 64), f32, False),
             ("strided", bf, False)]
    # the UNet's serving and training shapes and the vision tower's
    headline_shapes = ((2, 4096, 4096, 5, 64), (8, 4096, 4096, 5, 64), (1, 577, 577, 16, 64))
    entries = {fa.KERNEL_TC: "K1", fa.KERNEL_WIDE_TC: "K1_wide", fa.KERNEL: "K1_cc"}
    max_err, numbers = {key: 0.0 for key in entries.values()}, {}
    wide = []  # (label, Sq, K1_wide ms, plain ms) at d = 512
    for shape, dtype, with_lse in cases:
        q, k, v = qkv_case(gen, shape, dtype)
        b, sq, h, d = q.shape
        skv = k.shape[1]
        label = "x".join(map(str, q.shape)) + (f" vs {skv} kv rows" if skv != sq else "")
        label += (" strided" if shape == "strided" else "") + (" with lse" if with_lse else "")
        tol = BF16_TOL if dtype == bf else FP32_TOL

        def run(kernel=None):
            if kernel is None:
                return fa.flash_attention_fwd(q, k, v, with_lse=with_lse)
            return fa.launch_fwd(kernel, q, k, v, with_lse)

        def plain():
            if with_lse:
                return fa.flash_attention_lse_ref(q, k, v)
            return fa.flash_attention_ref(q, k, v)

        before = {n: KERNELS[n].launches for n in entries.values()}
        outs = run()
        torch.cuda.synchronize()
        moved = {n: KERNELS[n].launches - before[n] for n in entries.values()}
        key = entries[fa.fwd_entries(q)]
        check(moved == {n: int(n == key) for n in entries.values()},
              f"K1 at {label} launched {moved}, expected one launch of {key}")
        outs = outs if with_lse else (outs,)
        refs = plain() if with_lse else (plain(),)
        errs = fwd_errors(outs, refs, tol)
        for n, (err, limit) in errs.items():
            check(err <= limit, f"{key} {n} disagrees with its plain version at {label}: "
                  f"{err} > {limit}")
        if dtype == bf:
            max_err[key] = max(max_err[key], errs["o"][0])
        iters = 5 if b * sq * h * d > 2 ** 22 else 20
        ms = median_ms(run, iters)
        plain_ms = median_ms(plain, iters)
        bms, by = bound_ms(2, b, h, sq, skv, d, dtype, nbytes(q, k, v, *outs))
        print(f"[kernel] K1 {label} {str(dtype)[6:]} (on {key}): " +
              ", ".join(f"{n} max_abs_err {e:.3e}, limit {lim:.3e}" for n, (e, lim) in errs.items())
              + f" ({tol:g} x max|ref|, lse {FP32_TOL:g}); {key} {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        if key == "K1_wide":
            wide.append((label, sq, ms, plain_ms))
        if shape in headline_shapes:
            cc = run(fa.KERNEL)
            cc_errs = fwd_errors(cc if with_lse else (cc,), refs, tol)
            for n, (err, limit) in cc_errs.items():
                check(err <= limit, f"K1_cc {n} disagrees with its plain version at {label}: "
                      f"{err} > {limit}")
            max_err["K1_cc"] = max(max_err["K1_cc"], cc_errs["o"][0])
            cc_ms = median_ms(lambda: run(fa.KERNEL), iters)
            lib_ms = median_ms(lambda: sdpa_fwd(q, k, v), iters)
            tflops = 4.0 * b * h * sq * skv * d / 1e9
            print(f"[kernel] headline {label} bf16: K1 tensor cores {ms:.4f} ms "
                  f"({tflops / ms:.1f} TFLOP/s) vs CUDA cores (K1_cc on the same inputs, "
                  f"o err {cc_errs['o'][0]:.3e}) {cc_ms:.4f} ms ({tflops / cc_ms:.1f} TFLOP/s); "
                  f"library (SDPA) {lib_ms:.4f} ms; plain {plain_ms:.4f} ms; bound {bms:.4f} ms "
                  f"({by})")
            check(ms < cc_ms, f"the tensor-core K1 ({ms} ms) is not faster than the CUDA-core "
                  f"entry ({cc_ms} ms) at {label}")
            if sq == 4096:
                check_power_fwd(fa, label, q, k, v, with_lse)
            if shape == (2, 4096, 4096, 5, 64):
                common = {"plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                          "library_ms": lib_ms}
                numbers = {"K1": {"ms": ms, **common}, "K1_cc": {"ms": cc_ms, **common}}
        del q, k, v, outs, refs
        torch.cuda.empty_cache()
    from diffbir_tpu_torch.ops.attention import FLASH_MIN_WIDE

    faster = all(ms < plain_ms for _, sq, ms, plain_ms in wide if sq >= FLASH_MIN_WIDE)
    print(f"[kernel] d = 512 goes to flash from FLASH_MIN_WIDE = {FLASH_MIN_WIDE} tokens; "
          "K1_wide / plain ms: " + "; ".join(f"{label} {ms:.4f} / {plain_ms:.4f}"
                                              for label, _, ms, plain_ms in wide)
          + f"; K1_wide faster at every size from there: {'yes' if faster else 'no'}")
    for key in ("K1", "K1_cc"):
        numbers[key]["max_abs_err"] = max_err[key]
    return numbers, max_err["K1_wide"]


def sdpa_backends(q, k, v, out) -> list:
    """The names of the SDPA backends that give ``out``, the default call's
    output, bit for bit when run alone: the backend the default call took."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    names = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                alone = sdpa_fwd(q, k, v)
        except RuntimeError:
            continue
        if torch.equal(alone, out):
            names.append(backend.name)
        del alone
    return names


def phase_k1_wide(fa):
    """K1_wide where the untiled VAE's d = 512 mid-block attention runs it,
    at each shape of VAE_MID_SHAPES: one launch of that entry (by counter),
    o within BF16_TOL and lse within FP32_TOL x max|ref| of the plain
    version (its fp32 logits take 1 GiB at 16384 tokens), the entry run
    without its last kv tile failing both limits, and its time beside the
    plain version's, the library call's (SDPA; the backend it took named),
    the bound and, at the first shape, the CUDA-core entry's on the same
    inputs. Returns K1_wide's kernel-line numbers at the first shape."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(11)
    numbers = None
    for b, s, h, d in VAE_MID_SHAPES:
        q, k, v = qkv_case(gen, (b, s, s, h, d), torch.bfloat16)
        label = "x".join(map(str, q.shape))
        check(fa.fwd_entries(q) is fa.KERNEL_WIDE_TC, f"K1 at {label} is not on K1_wide")
        before = counts()
        outs = fa.flash_attention_fwd(q, k, v, with_lse=True)
        torch.cuda.synchronize()
        moved = launched_since(before)
        check(moved == {"K1_wide": 1, "K1_wide_lse": 1},
              f"K1 at {label} launched {moved}, expected one K1_wide with lse")
        refs = fa.flash_attention_lse_ref(q, k, v)
        errs = fwd_errors(outs, refs, BF16_TOL)
        for n, (err, limit) in errs.items():
            check(err <= limit, f"K1_wide {n} disagrees with its plain version at {label}: "
                  f"{err} > {limit}")
        faulty = fa.launch_fwd(fa.KERNEL_WIDE_TC, q, k[:, :-64], v[:, :-64], True)
        torch.cuda.synchronize()
        ratios = {n: e / lim for n, (e, lim) in fwd_errors(faulty, refs, BF16_TOL).items()}
        print(f"[kernel] K1_wide {label} bf16: " + ", ".join(
            f"{n} max_abs_err {e:.3e}, limit {lim:.3e}" for n, (e, lim) in errs.items())
            + f" ({BF16_TOL:g} x max|ref|, lse {FP32_TOL:g}); the entry without its last kv "
            "tile: max err / limit " + ", ".join(f"{n} {r:.1f}" for n, r in ratios.items()))
        check(all(r > 1.0 for r in ratios.values()),
              f"the limits do not catch a skipped kv tile at {label}: {ratios}")
        del refs, faulty
        torch.cuda.empty_cache()
        ms = median_ms(lambda: fa.flash_attention_fwd(q, k, v), 10, 2)
        plain_ms = median_ms(lambda: fa.flash_attention_ref(q, k, v), 3, 1)
        lib = sdpa_fwd(q, k, v)
        backends = sdpa_backends(q, k, v, lib)
        lib_ms = median_ms(lambda: sdpa_fwd(q, k, v), 10, 2)
        bms, by = bound_ms(2, b, h, s, s, d, torch.bfloat16, nbytes(q, k, v, outs[0]))
        tflops = 4.0 * b * h * s * s * d / 1e9
        cc = ""
        if numbers is None:
            cc_ms = median_ms(lambda: fa.launch_fwd(fa.KERNEL, q, k, v), 3, 1)
            cc = f", the CUDA-core entry on the same inputs {cc_ms:.4f} ms"
        print(f"[kernel] K1_wide {label} bf16 (an untiled VAE's mid-block at {s} latent "
              f"tokens): {ms:.4f} ms ({tflops / ms:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, library (SDPA, backend "
              f"{'/'.join(backends) or 'not identified'}) {lib_ms:.4f} ms, bound {bms:.4f} ms "
              f"({by}; {bms / ms:.1%} of it){cc}")
        if numbers is None:
            numbers = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
                       "bound_by": by, "max_abs_err": errs["o"][0], "shape": label,
                       "library": "SDPA " + ("/".join(backends) or "backend not identified")}
        del q, k, v, outs, lib
        torch.cuda.empty_cache()
    return numbers


def check_power_fwd(fa, label, q, k, v, with_lse):
    """The limits catch a tensor-core K1 that skips the last 64-row kv tile:
    the entry run on k and v without it must fail the o (and lse) limit."""
    import torch

    outs = fa.launch_fwd(fa.KERNEL_TC, q, k[:, :-64], v[:, :-64], with_lse)
    outs = outs if with_lse else (outs,)
    refs = fa.flash_attention_lse_ref(q, k, v) if with_lse else (fa.flash_attention_ref(q, k, v),)
    torch.cuda.synchronize()
    ratios = {n: e / lim for n, (e, lim) in fwd_errors(outs, refs, BF16_TOL).items()}
    print(f"[kernel] a tensor-core K1 that skips the last kv tile at {label}: max err / limit "
          + ", ".join(f"{n} {r:.1f}" for n, r in ratios.items()))
    check(all(r > 1.0 for r in ratios.values()),
          f"the limits do not catch a skipped kv tile at {label}: {ratios}")


NAMES = ("o", "lse", "dq", "dk", "dv")


def check_power(fa, q, k, v, g, o, lse, refs, limits):
    """The limits catch a kernel that skips the last 64-row kv tile: K1 and
    K2 run without it (K2 with the full lse, as a kernel that drops the tile
    would) and each of o, lse, dq, dk and dv must then fail its limit."""
    import torch

    kt, vt = k[:, :-64], v[:, :-64]
    o_f, lse_f = fa.flash_attention_fwd(q, kt, vt, with_lse=True)
    dq_f, dk_f, dv_f = fa.flash_attention_bwd(q, kt, vt, o, lse, g)
    pad = torch.zeros_like(k[:, -64:])
    faulty = dict(zip(NAMES, (o_f, lse_f, dq_f, torch.cat([dk_f, pad], 1),
                              torch.cat([dv_f, pad], 1))))
    ratios = {n: (faulty[n].float() - refs[n].float()).abs().max().item() / limits[n]
              for n in NAMES}
    print("[bwd] a kernel that skips the last kv tile: max err / limit " +
          ", ".join(f"{n} {r:.1f}" for n, r in ratios.items()))
    check(all(r > 1.0 for r in ratios.values()),
          f"the limits do not catch a skipped kv tile: {ratios}")


def phase_backward_kernels(fa):
    """K1 with lse, K2a and K2b against their plain versions, each case on
    the entries that ``bwd_entries`` names (by counter); returns the kernel
    lines' numbers for K2a and K2b at [8,4096,5,64] bf16."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    # (B, Sq, Skv, H, D): the training shapes, ragged (multiples of neither
    # 128-row tile; Sq != Skv; less than one tile), d = 128 to 512, fp32
    cases = [((8, 4096, 4096, 5, 64), bf), ((8, 1024, 1024, 10, 64), bf),
             ((8, 256, 256, 20, 64), bf), ((8, 64, 64, 20, 64), bf),
             ((2, 4000, 4000, 5, 64), bf), ((2, 1000, 1000, 5, 64), bf),
             ((1, 130, 77, 2, 64), bf), ("strided", bf), ((2, 300, 300, 4, 128), bf),
             ((2, 1024, 1024, 8, 128), bf), ((1, 300, 300, 2, 256), bf),
             ((1, 600, 600, 1, 512), bf), ((2, 1024, 1024, 10, 64), f32),
             ((1, 300, 300, 1, 512), f32)]
    entries = ("K2a", "K2b", "K2_delta", "K2a_wide", "K2b_wide", "K2a_cc", "K2b_cc")
    max_err = {"dq": 0.0, "dkv": 0.0}
    headline = None
    for shape, dtype in cases:
        if shape == "strided":  # q, k, v views of one projection; dO a strided view too
            qkv = torch.randn(2, 4096, 960, generator=gen, device="cuda").to(dtype)
            q, k, v = (t.reshape(2, 4096, 5, 64) for t in qkv.chunk(3, dim=-1))
            g = torch.randn(2, 4096, 5, 128, generator=gen, device="cuda").to(dtype)[..., :64]
        else:
            b, sq, skv, h, d = shape
            q, g = (torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            k, v = (torch.randn(b, skv, h, d, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
        b, sq, h, d = q.shape
        skv = k.shape[1]
        label = "x".join(map(str, q.shape)) + (f" vs {skv} kv rows" if skv != sq else "")
        label += " strided" if shape == "strided" else ""
        tol = BF16_TOL if dtype == bf else FP32_TOL

        o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        o_ref, lse_ref = fa.flash_attention_lse_ref(q, k, v)
        before = {n: KERNELS[n].launches for n in entries}
        grads = fa.flash_attention_bwd(q, k, v, o, lse, g)
        moved = {n: KERNELS[n].launches - before[n] for n in entries}
        tensor_cores = dtype == bf and d in fa.TC_HEAD_DIMS
        wide = dtype == bf and d in fa.WIDE_TC_HEAD_DIMS
        want = dict.fromkeys(entries, 0)
        want.update({"K2a": 1, "K2b": 1} if tensor_cores else
                    {"K2_delta": 1, "K2a_wide": 1, "K2b_wide": 1} if wide else
                    {"K2a_cc": 1, "K2b_cc": 1})
        check(moved == want, f"K2 at {label} launched {moved}, expected {want}")
        again = fa.flash_attention_bwd(q, k, v, o, lse, g)
        torch.cuda.synchronize()
        check(all(torch.equal(a, c) for a, c in zip(grads, again)),
              f"K2 is not bit-deterministic at {label}")
        refs = dict(zip(NAMES, (o_ref, lse_ref, *fa.flash_attention_bwd_ref(q, k, v, o, lse, g))))
        limits = {n: limit_of(r, FP32_TOL if n == "lse" else tol) for n, r in refs.items()}
        errs = {}
        for name, out in zip(NAMES, (o, lse, *grads)):
            errs[name] = (out.float() - refs[name].float()).abs().max().item()
            check(errs[name] <= limits[name], f"{name} disagrees with its plain version at "
                  f"{label}: {errs[name]} > {limits[name]}")
        if shape == (8, 4096, 4096, 5, 64):
            check_power(fa, q, k, v, g, o, lse, refs, limits)
        if tensor_cores:
            max_err["dq"] = max(max_err["dq"], errs["dq"])
            max_err["dkv"] = max(max_err["dkv"], errs["dk"], errs["dv"])

        big = sq >= 4000
        iters = 5 if big else 20
        t = {
            "K1+lse": median_ms(lambda: fa.flash_attention_fwd(q, k, v, with_lse=True), iters),
            "K2a": median_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, g),
                             iters),
            "K2b": median_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, o, lse, g),
                             iters),
            "plain K2a": median_ms(lambda: fa.flash_attention_bwd_dq_ref(q, k, v, o, lse, g),
                                   iters),
            "plain K2b": median_ms(lambda: fa.flash_attention_bwd_dkv_ref(q, k, v, o, lse, g),
                                   iters),
        }
        lib_ms = None
        if shape in ((8, 4096, 4096, 5, 64), (8, 1024, 1024, 10, 64)):
            qt, kt, vt = (x.detach().clone().requires_grad_() for x in (q, k, v))
            out_lib = sdpa_fwd(qt, kt, vt)
            g_lib = g.transpose(1, 2)
            lib_ms = median_ms(lambda: torch.autograd.grad(out_lib, (qt, kt, vt), g_lib,
                                                           retain_graph=True), iters)
            t["library bwd"] = lib_ms
        in_bytes = nbytes(q, k, v, o, g, lse)
        b_dq = bound_ms(3, b, h, sq, skv, d, dtype, in_bytes + nbytes(grads[0]))
        b_dkv = bound_ms(4, b, h, sq, skv, d, dtype, in_bytes + nbytes(*grads[1:]))
        b_all = bound_ms(5, b, h, sq, skv, d, dtype, in_bytes + nbytes(*grads))
        entry = ("tensor-core entries" if tensor_cores else
                 "wide tensor-core entries" if wide else "CUDA-core entries")
        print(f"[bwd] {label} {str(dtype)[6:]} ({entry}, launches "
              + ", ".join(f"{n} {x}" for n, x in moved.items() if x) + "): max err / limit "
              + ", ".join(f"{n} {e:.3e} / {limits[n]:.3e}" for n, e in errs.items()) +
              f" (limit {tol:g} x max|ref|, lse {FP32_TOL:g} x max|ref|); "
              "backward bit-identical on a second run")
        print(f"[bwd] {label} {str(dtype)[6:]}: ms " +
              ", ".join(f"{n} {x:.4f}" for n, x in t.items()) +
              f"; bound K2a {b_dq[0]:.4f} ({b_dq[1]}, 3 products), K2b {b_dkv[0]:.4f} "
              f"({b_dkv[1]}, 4 products), whole backward {b_all[0]:.4f} ({b_all[1]}, 5 products)")
        if shape == (8, 4096, 4096, 5, 64):
            cc_dq = median_ms(lambda: fa.launch_dq(fa.KERNEL_DQ, q, k, v, o, lse, g), iters)
            cc_dkv = median_ms(lambda: fa.launch_dkv(fa.KERNEL_DKV, q, k, v, o, lse, g), iters)
            flops = 2.0 * b * h * sq * skv * d
            rate = {n: p * flops / ms / 1e9 for n, p, ms in (
                ("K2a", 3, t["K2a"]), ("K2b", 4, t["K2b"]), ("K2a_cc", 3, cc_dq),
                ("K2b_cc", 4, cc_dkv))}
            print(f"[bwd] headline {label} bf16: K2a tensor cores {t['K2a']:.4f} ms "
                  f"({rate['K2a']:.1f} TFLOP/s) vs CUDA cores {cc_dq:.4f} ms "
                  f"({rate['K2a_cc']:.1f} TFLOP/s), bound {b_dq[0]:.4f} ms; K2b tensor cores "
                  f"{t['K2b']:.4f} ms ({rate['K2b']:.1f} TFLOP/s) vs CUDA cores {cc_dkv:.4f} ms "
                  f"({rate['K2b_cc']:.1f} TFLOP/s), bound {b_dkv[0]:.4f} ms; library "
                  f"backward (dq, dk, dv) {lib_ms:.4f} ms")
            headline = {
                "dq": {"ms": t["K2a"], "plain_ms": t["plain K2a"], "bound_ms": b_dq[0],
                       "bound_by": b_dq[1], "library_ms": lib_ms,
                       "cuda_core_entry": "flash_attention_bwd_dq", "cuda_core_ms": cc_dq},
                "dkv": {"ms": t["K2b"], "plain_ms": t["plain K2b"], "bound_ms": b_dkv[0],
                        "bound_by": b_dkv[1], "library_ms": lib_ms,
                        "cuda_core_entry": "flash_attention_bwd_dkv", "cuda_core_ms": cc_dkv},
            }
        del q, k, v, g, o, lse, grads, again, refs
        torch.cuda.empty_cache()
    headline["dq"]["max_abs_err"] = max_err["dq"]
    headline["dkv"]["max_abs_err"] = max_err["dkv"]
    return headline


def wide_refs(fa, q, k, v, o, lse, g):
    """The plain versions' (dq, dk, dv) of a d = 512 case; past
    D512_PLAIN_MAX over q-row chunks of D512_REF_ROWS: the same math, dq
    exact per chunk, dk and dv summed in fp32 over the chunks and rounded
    once, as the plain einsum over all rows does."""
    import torch

    if q.shape[1] * k.shape[1] <= D512_PLAIN_MAX:
        return fa.flash_attention_bwd_ref(q, k, v, o, lse, g)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for r0 in range(0, q.shape[1], D512_REF_ROWS):
        rows = slice(r0, r0 + D512_REF_ROWS)
        qc, gc = q[:, rows], g[:, rows]
        p, ds = fa._bwd_probs_ref(qc, k, v, o[:, rows], lse[:, :, rows], gc)
        dq[:, rows] = fa._dq_from_ds(ds, k, q.dtype)
        dk += torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qc.float())
        dv += torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), gc.float())
        del p, ds
    return dq, dk.to(q.dtype), dv.to(q.dtype)


def hold_pair(fa, tag, label, entries, q, k, v, o, lse, g, refs, delta=None) -> dict:
    """One K2a and one K2b entry (``entries``; the wide ones read ``delta``)
    on a case: dq, dk and dv within BF16_TOL x max|ref| of the plain
    versions' ``refs``; the same entries run without the last 64-row kv
    tile (K2 with the full lse, as a kernel that drops the tile would) must
    fail each limit. Returns {name: max abs error}."""
    import torch

    dq_entry, dkv_entry = entries
    outs = (fa.launch_dq(dq_entry, q, k, v, o, lse, g, delta),
            *fa.launch_dkv(dkv_entry, q, k, v, o, lse, g, delta))
    kt, vt = k[:, :-64], v[:, :-64]
    pad = torch.zeros_like(k[:, -64:])
    dk_f, dv_f = fa.launch_dkv(dkv_entry, q, kt, vt, o, lse, g, delta)
    faulty = (fa.launch_dq(dq_entry, q, kt, vt, o, lse, g, delta), torch.cat([dk_f, pad], 1),
              torch.cat([dv_f, pad], 1))
    torch.cuda.synchronize()
    errs, ratios = {}, {}
    for name, out, bad, ref in zip(("dq", "dk", "dv"), outs, faulty, refs):
        limit = limit_of(ref, BF16_TOL)
        errs[name] = (out.float() - ref.float()).abs().max().item()
        ratios[name] = (bad.float() - ref.float()).abs().max().item() / limit
        check(errs[name] <= limit, f"{tag}: {name} disagrees with its plain version at {label}: "
              f"{errs[name]} > {limit}")
    print(f"[{tag}] {label} bf16: max err / limit " + ", ".join(
        f"{n} {e:.3e} / {limit_of(r, BF16_TOL):.3e}" for (n, e), r in zip(errs.items(), refs))
          + f" (limit {BF16_TOL:g} x max|ref|); without the last kv tile: max err / limit "
          + ", ".join(f"{n} {r:.1f}" for n, r in ratios.items()))
    check(all(r > 1.0 for r in ratios.values()),
          f"{tag}: the limits do not catch a skipped kv tile at {label}: {ratios}")
    return errs


def phase_d512_backward(fa):
    """[d512_backward]: the VAE's d = 512 mid-block attention under a
    gradient (RGB guidance differentiates through the decoder) at
    D512_GRAD_SHAPES. At each: the wide backward (the delta pre-pass,
    K2a_wide, K2b_wide; ``bwd_entries`` names them for bf16 at d = 512) one
    launch each, bit-identical on a rerun, dq, dk and dv against the plain
    versions (over q-row chunks past D512_PLAIN_MAX) and delta against its
    own, a skipped kv tile failing the limits (``hold_pair``); each entry
    timed alone beside its plain version (up to D512_PLAIN_MAX), SDPA's
    backward (dq, dk and dv at once) and its bound (3 and 4 products of 2 Sq
    Skv d; delta the bytes of o, dO and delta). At the square shapes of
    D512_GRAD_THRESHOLDS, one forward plus backward three ways: K1_wide with
    lse + the wide backward, the plain version under autograd (with its
    peak memory), SDPA; FLASH_MIN_WIDE_GRAD
    must be the smallest of D512_GRAD_THRESHOLDS at which flash is faster
    there and at every larger one (65536 if none). At 4096 tokens K2a_cc and
    K2b_cc (``d512_cc``). Returns the kernel lines' numbers: the wide
    entries at [1,16384,1,512], the CUDA-core ones at [1,4096,1,512]."""
    import torch

    from diffbir_tpu_torch.ops.attention import FLASH_MIN_WIDE_GRAD, plain_attention

    gen = torch.Generator(device="cuda").manual_seed(12)
    bf = torch.bfloat16
    numbers, readings, worst = {}, {}, {"dq": 0.0, "dkv": 0.0, "delta": 0.0}
    for b, sq, skv in D512_GRAD_SHAPES:
        q, g = (torch.randn(b, sq, 1, 512, generator=gen, device="cuda").to(bf)
                for _ in range(2))
        k, v = (torch.randn(b, skv, 1, 512, generator=gen, device="cuda").to(bf)
                for _ in range(2))
        label = "x".join(map(str, q.shape)) + (f" x {skv} kv rows" if skv != sq else "")
        check(fa.bwd_entries(q) == fa.WIDE_BWD,
              f"bf16 d = 512 backward is not on the wide tensor-core entries at {label}")
        o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        before = counts()
        grads = fa.flash_attention_bwd(q, k, v, o, lse, g)
        torch.cuda.synchronize()
        moved = launched_since(before)
        check(moved == {"K2_delta": 1, "K2a_wide": 1, "K2b_wide": 1},
              f"the d = 512 backward at {label} launched {moved}")
        again = fa.flash_attention_bwd(q, k, v, o, lse, g)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(grads, again)),
              f"the wide backward is not bit-deterministic at {label}")
        refs = wide_refs(fa, q, k, v, o, lse, g)
        delta = fa.launch_delta(o, g)
        delta_ref = fa.flash_attention_bwd_delta_ref(o, g)
        delta_err = (delta - delta_ref).abs().max().item()
        check(delta_err <= limit_of(delta_ref, FP32_TOL), f"delta disagrees with its plain "
              f"version at {label}: {delta_err}")
        errs = hold_pair(fa, "d512_backward", label, fa.WIDE_BWD, q, k, v, o, lse, g, refs,
                         delta)
        worst.update(dq=max(worst["dq"], errs["dq"]),
                     dkv=max(worst["dkv"], errs["dk"], errs["dv"]),
                     delta=max(worst["delta"], delta_err))
        big = sq * skv > D512_PLAIN_MAX
        iters = 2 if big else 10
        t = {"K2_delta": median_ms(lambda: fa.launch_delta(o, g), iters, 1),
             "K2a_wide": median_ms(lambda: fa.launch_dq(fa.KERNEL_DQ_WIDE_TC, q, k, v, o, lse, g,
                                                        delta), iters, 1),
             "K2b_wide": median_ms(lambda: fa.launch_dkv(fa.KERNEL_DKV_WIDE_TC, q, k, v, o, lse,
                                                         g, delta), iters, 1)}
        plain_t = {} if big else {
            "K2_delta": median_ms(lambda: fa.flash_attention_bwd_delta_ref(o, g), iters, 1),
            "K2a_wide": median_ms(lambda: fa.flash_attention_bwd_dq_ref(q, k, v, o, lse, g),
                                  iters, 1),
            "K2b_wide": median_ms(lambda: fa.flash_attention_bwd_dkv_ref(q, k, v, o, lse, g),
                                  iters, 1)}
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        out_lib = sdpa_fwd(*leaves)
        lib_ms = median_ms(lambda: torch.autograd.grad(out_lib, leaves, g.transpose(1, 2),
                                                       retain_graph=True), iters, 1)
        del out_lib
        lib_delta_ms = median_ms(lambda: (g.float() * o.float()).sum(-1), iters, 1)
        in_bytes = nbytes(q, k, v, delta, lse, g)
        bounds = {"K2_delta": bound_ms(0, b, 1, sq, skv, 512, bf, nbytes(o, g, delta)),
                  "K2a_wide": bound_ms(3, b, 1, sq, skv, 512, bf, in_bytes + nbytes(grads[0])),
                  "K2b_wide": bound_ms(4, b, 1, sq, skv, 512, bf,
                                       in_bytes + nbytes(*grads[1:]))}
        print(f"[d512_backward] {label} bf16, each entry alone: " + "; ".join(
            f"{n} {t[n]:.4f} ms (plain "
            + (f"{plain_t[n]:.4f}" if n in plain_t else "not timed: its scores do not fit")
            + f", bound {bounds[n][0]:.4f} {bounds[n][1]}, {bounds[n][0] / t[n]:.1%} of it)"
            for n in t) + f"; SDPA backward (dq, dk, dv) {lib_ms:.4f} ms; the library's delta "
              f"((dO.float() * O.float()).sum(-1)) {lib_delta_ms:.4f} ms; K2a_wide + K2b_wide "
              f"{(bounds['K2a_wide'][0] + bounds['K2b_wide'][0]) / (t['K2a_wide'] + t['K2b_wide']):.1%}"
              " of their bounds")
        if (b, sq, skv) == (1, 16384, 16384):
            for n in t:
                numbers[n] = {"ms": t[n], "plain_ms": plain_t[n], "bound_ms": bounds[n][0],
                              "bound_by": bounds[n][1],
                              "library_ms": lib_delta_ms if n == "K2_delta" else lib_ms,
                              "shape": label, "library": "(dO.float() * O.float()).sum(-1)"
                              if n == "K2_delta" else "SDPA backward (dq, dk, dv)"}
        if sq == skv and sq in D512_GRAD_THRESHOLDS:

            def flash():
                o2, lse2 = fa.flash_attention_fwd(q, k, v, with_lse=True)
                return fa.flash_attention_bwd(q, k, v, o2, lse2, g)

            def sdpa():
                return torch.autograd.grad(sdpa_fwd(*leaves), leaves, g.transpose(1, 2))

            f = {"flash": median_ms(flash, iters, 1), "SDPA": median_ms(sdpa, iters, 1),
                 "plain": median_ms(lambda: torch.autograd.grad(plain_attention(*leaves),
                                                                leaves, g), iters, 1)}
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            torch.autograd.grad(plain_attention(*leaves), leaves, g)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
            readings[sq] = f
            # S and P.V, then dV, dP, dQ and dK with P kept
            bms, by = bound_ms(6, b, 1, sq, skv, 512, bf, 2 * nbytes(q, k, v, g))
            print(f"[d512_backward] {label} bf16 forward + backward: K1_wide + delta + K2a_wide "
                  f"+ K2b_wide {f['flash']:.4f} ms, plain under autograd {f['plain']:.4f} ms "
                  f"(its peak {peak:.3f} GiB above its inputs), SDPA {f['SDPA']:.4f} ms; bound "
                  f"{bms:.4f} ms ({by}, 6 products); flash / plain {f['flash'] / f['plain']:.3f}, "
                  f"flash / SDPA {f['flash'] / f['SDPA']:.3f}")
        if (b, sq, skv) == (1, 4096, 4096):
            numbers.update(d512_cc(fa, label, q, k, v, o, lse, g, refs, lib_ms, iters))
        del q, k, v, g, o, lse, grads, again, refs, delta, delta_ref, leaves
        torch.cuda.empty_cache()
    numbers["K2a_wide"]["max_abs_err"] = worst["dq"]
    numbers["K2b_wide"]["max_abs_err"] = worst["dkv"]
    numbers["K2_delta"]["max_abs_err"] = worst["delta"]
    wins = [s for s in D512_GRAD_THRESHOLDS
            if all(readings[x]["flash"] < readings[x]["plain"]
                   for x in D512_GRAD_THRESHOLDS if x >= s)]
    reading = min(wins) if wins else 65536
    print(f"[d512_backward] the reading: flash beats plain under autograd from {reading} tokens "
          f"(of {D512_GRAD_THRESHOLDS}, there and at every larger one); FLASH_MIN_WIDE_GRAD = "
          f"{FLASH_MIN_WIDE_GRAD}: d = 512 under a gradient goes to plain math below it, to "
          "K1_wide + delta + K2a_wide + K2b_wide from there")
    check(FLASH_MIN_WIDE_GRAD == reading,
          f"FLASH_MIN_WIDE_GRAD = {FLASH_MIN_WIDE_GRAD} is not the reading {reading}")
    return numbers


def d512_cc(fa, label, q, k, v, o, lse, g, refs, library_ms: float, iters: int) -> dict:
    """K2a_cc and K2b_cc (the CUDA-core entries, which no path launches) on
    one d = 512 case: dq, dk and dv against the plain versions ``refs`` and
    a skipped kv tile failing the limits (``hold_pair``), each entry timed
    alone beside its plain version and its bound (3 and 4 products);
    ``library_ms``: SDPA's backward on the same inputs."""
    errs = hold_pair(fa, "d512_backward", f"{label} on K2a_cc + K2b_cc",
                     (fa.KERNEL_DQ, fa.KERNEL_DKV), q, k, v, o, lse, g, refs)
    b, s, h, d = q.shape
    in_bytes = nbytes(q, k, v, o, g, lse)
    out = {}
    for key, kernel, launch, ref, products, n_out in (
            ("K2a_cc", fa.KERNEL_DQ, fa.launch_dq, fa.flash_attention_bwd_dq_ref, 3,
             nbytes(refs[0])),
            ("K2b_cc", fa.KERNEL_DKV, fa.launch_dkv, fa.flash_attention_bwd_dkv_ref, 4,
             nbytes(*refs[1:]))):
        ms = median_ms(lambda: launch(kernel, q, k, v, o, lse, g), iters, 1)
        plain_ms = median_ms(lambda: ref(q, k, v, o, lse, g), iters, 1)
        bms, by = bound_ms(products, b, h, s, s, d, q.dtype, in_bytes + n_out)
        err = errs["dq"] if key == "K2a_cc" else max(errs["dk"], errs["dv"])
        print(f"[d512_backward] {key} {label} bf16: {ms:.4f} ms "
              f"({products * 2.0 * b * h * s * s * d / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}; {bms / ms:.2%} of it)")
        out[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                    "library_ms": library_ms, "max_abs_err": err, "shape": label,
                    "library": "SDPA backward (dq, dk, dv)"}
    return out


def build_models(seed: int = 0):
    import torch

    from diffbir_tpu_torch.models.cldm import ControlLDM
    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.swinir import SwinIR

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cldm = ControlLDM.sd21(dtype=torch.bfloat16, device="meta").to_empty(device="cuda")
    random_init_(cldm, gen).eval()
    swinir = SwinIR(dtype=torch.bfloat16, device="meta").to_empty(device="cuda")
    random_init_(swinir, gen).eval()
    torch.cuda.synchronize()
    n = sum(p.numel() for p in cldm.parameters())
    ns = sum(p.numel() for p in swinir.parameters())
    print(f"[models] sd21 ControlLDM {n / 1e6:.1f} M params, SwinIR {ns / 1e6:.2f} M, "
          f"bf16, random from seed {seed}, built in "
          f"{time.perf_counter() - t0:.2f} s")
    return cldm, swinir


def empty_tokens(bs: int):
    import torch

    tokens = torch.zeros(bs, 77, dtype=torch.long, device="cuda")
    tokens[:, 0], tokens[:, 1] = 49406, 49407
    return tokens


def phase_model_call(cldm):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2, 64, 64, 4, generator=gen, device="cuda")
    c_img = torch.randn(2, 64, 64, 4, generator=gen, device="cuda")
    t = torch.tensor([999.0, 500.0], device="cuda")
    outs = {}
    with torch.no_grad():
        cond = {"c_txt": cldm.encode_text(empty_tokens(2)), "c_img": c_img}
        for impl in ("auto", "plain"):
            cldm.set_attention_impl(impl)
            before = counts()
            outs[impl] = cldm(x, t, cond).float()
            torch.cuda.synchronize()
            n = launched_since(before)
            print(f"[model] attention {impl}: launches {n}")
            check(n == ({"K1": K1_SITES_PER_STEP} if impl == "auto" else {}),
                  f"model call with {impl} attention launched {n}")
    cldm.set_attention_impl("auto")
    a, p = outs["auto"], outs["plain"]
    check(bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all()),
          "non-finite model output")
    rel = ((a - p).abs().max() / p.abs().max()).item()
    print(f"[model] ControlLDM forward [2,64,64,4]: K1 vs plain attention relative "
          f"max err {rel:.3e} (tol {MODEL_REL_TOL:g}), output max |x| {p.abs().max().item():.3f}")
    check(rel <= MODEL_REL_TOL, f"model call through K1 disagrees: {rel}")


def reset_counts():
    for kernel in KERNELS.values():
        kernel.launches = 0
    WIDE_LSE["K1_wide_lse"] = 0


def counts() -> dict:
    """Launches per kernel, and "K1_wide_lse": those of K1_wide's with lse
    (a forward under a gradient) among K1_wide's."""
    return {**{name: kernel.launches for name, kernel in KERNELS.items()}, **WIDE_LSE}


def tally_wide_lse(fa) -> None:
    """Counts K1_wide's launches with lse in WIDE_LSE (``fa.launch_fwd``
    wrapped; the kernel's own count is K1_wide's)."""
    launch = fa.launch_fwd

    def launch_fwd(kernel, q, k, v, with_lse=False):
        out = launch(kernel, q, k, v, with_lse)
        WIDE_LSE["K1_wide_lse"] += kernel is fa.KERNEL_WIDE_TC and with_lse
        return out

    fa.launch_fwd = launch_fwd


def launched_since(before: dict) -> dict:
    """Launches per kernel since ``before`` (kernels with none left out)."""
    now = counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def phase_slice(path: str, cldm, swinir, seeds, repeat: bool = True):
    """The serving path in one mode: SwinIRPipeline.run on SIZE x SIZE LQs,
    one request per seed (and the first seed again with ``repeat``); every
    request must launch exactly PER_REQUEST[path]. Returns the launch counts
    of the path's run."""
    import numpy as np
    import torch

    from diffbir_tpu_torch.pipeline import SwinIRPipeline
    from diffbir_tpu_torch.profile_step import NEG_PROMPT, POS_PROMPT, stand_in_tokenizer
    from diffbir_tpu_torch.schedule import Schedule

    pipe = SwinIRPipeline(swinir, cldm, Schedule.v21(), torch.device("cuda"),
                          tokenizer=stand_in_tokenizer())
    pos, neg = pipe.tokenize(POS_PROMPT, 1), pipe.tokenize(NEG_PROMPT, 1)
    check(not torch.equal(pos, neg), "the stand-in ids of the two prompts are equal")
    print(f"[{path}] prompts: the CLI's defaults, stand-in ids pos {pos[0, :6].tolist()}... "
          f"({int((pos > 0).sum())} ids), neg {neg[0, :6].tolist()}... "
          f"({int((neg > 0).sum())} ids)")
    lqs = {s: np.random.default_rng(100 + s).integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
           for s in seeds}
    expected = PER_REQUEST[path]
    outs, lat = {}, []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # count only this path from here
    for seed in tuple(seeds) + (seeds[:1] if repeat else ()):
        timings = {}
        before = counts()
        t0 = time.perf_counter()
        out = pipe.run(lqs[seed], steps=STEPS, cfg_scale=CFG, seed=seed, timings=timings,
                       pos_prompt=POS_PROMPT, neg_prompt=NEG_PROMPT)
        dt = time.perf_counter() - t0
        n = launched_since(before)
        split = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        print(f"[{path}] seed {seed}: {dt:.3f} s ({split} s); launches "
              + ", ".join(f"{k} {v}" for k, v in n.items()))
        check(n == expected, f"{path}: expected launches {expected} per request, got {n}")
        check(out.shape == (1, SIZE, SIZE, 3) and out.dtype == np.uint8,
              f"bad output {out.shape} {out.dtype}")
        check(float(out.std()) > 1.0, f"constant output for seed {seed}")
        if seed in outs:
            check(np.array_equal(out, outs[seed]), "repeated seed gave a different output")
            print(f"[{path}] seed {seed} again: identical output")
        else:
            outs[seed] = out
            lat.append(dt)
    launches = counts()
    if len(seeds) > 1:
        check(not np.array_equal(outs[seeds[0]], outs[seeds[1]]), "distinct seeds gave one output")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{path}] per-request latency {', '.join(f'{x:.3f}' for x in lat)} s "
          f"(median {statistics.median(lat):.3f} s); peak device memory {peak:.2f} GiB")
    return launches


# --------------------------------------------------------------------------- #
# the serving modes' kernels: K3, K4, K6, K7
# --------------------------------------------------------------------------- #
def err_limit(out, ref, tol: float):
    """(max abs error of out against ref, the limit tol * max|ref|)."""
    return (out.float() - ref.float()).abs().max().item(), limit_of(ref, tol)


def show(out, ref, tol: float = BF16_TOL) -> str:
    err, limit = err_limit(out, ref, tol)
    return f"max_abs_err {err:.3e}, limit {limit:.3e} ({tol:g} x max|ref|)"


def hold(label: str, out, ref, tol: float) -> float:
    err, limit = err_limit(out, ref, tol)
    check(err <= limit, f"{label} disagrees with its plain version: {err} > {limit}")
    return err


def planted(label: str, faulty, ref, tol: float) -> None:
    """A planted fault must fail the limit the kernel is held to."""
    err, limit = err_limit(faulty, ref, tol)
    print(f"[{label.split()[0]}] planted fault ({label}): max err / limit {err / limit:.1f}")
    check(err > limit, f"the limits do not catch {label}: {err} <= {limit}")


def randomize_(module, gen):
    """random_init_ (N(0, 1/fan_in) weights), then biases N(0, 0.1^2) and
    norm scales 1 + N(0, 0.1^2), so every term of the block carries signal."""
    import torch

    from diffbir_tpu_torch.models.layers import random_init_

    random_init_(module, gen)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1:
                noise = 0.1 * torch.randn(p.shape, generator=gen, device=gen.device)
                p.copy_(noise + 1.0 if name.endswith("weight") else noise)
    return module.eval()


def k3_scaled_twice(fa, q, k, v):
    """The tensor-core K3 with its fault planted: q rounded as bf16(q *
    d^-1/2) and the logits scaled by d^-1/2 again."""
    import torch

    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        fa.KERNEL_PRESCALED_TC.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      None, 1, b, h, sq, k.shape[1], d, *fa._strides(q, k, v),
                                      d ** -0.5, d ** -0.5,
                                      torch.cuda.current_stream().cuda_stream)
    return out


def phase_k3(fa):
    """K3 against its plain version at the four self-attention shapes of the
    serving path (bf16), on its tensor-core entry (by counter), and the
    CUDA-core entry K3_cc on the same inputs; returns the kernel lines'
    numbers of K3 and K3_cc at [2,4096,5,64]."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    max_err, numbers, per_call = {"K3": 0.0, "K3_cc": 0.0}, {}, {"K3": 0.0, "K3_cc": 0.0}
    for (tokens, heads), sites in K3_SITES.items():
        q, k, v = (torch.randn(2, tokens, heads, 64, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        before = (KERNELS["K3"].launches, KERNELS["K3_cc"].launches)
        out = fa.flash_attention_fwd(q, k, v, prescale_q=True)
        moved = (KERNELS["K3"].launches - before[0], KERNELS["K3_cc"].launches - before[1])
        cc = fa.launch_fwd(fa.KERNEL_PRESCALED, q, k, v)
        ref = fa.flash_attention_ref(q, k, v, prescale_q=True)
        label = f"2x{tokens}x{heads}x64"
        check(moved == (1, 0), f"K3 at {label} launched (K3, K3_cc) {moved}, expected (1, 0)")
        max_err["K3"] = max(max_err["K3"], hold(f"K3 at {label}", out, ref, BF16_TOL))
        max_err["K3_cc"] = max(max_err["K3_cc"], hold(f"K3_cc at {label}", cc, ref, BF16_TOL))
        iters = 5 if tokens >= 4096 else 20
        ms = median_ms(lambda: fa.flash_attention_fwd(q, k, v, prescale_q=True), iters)
        cc_ms = median_ms(lambda: fa.launch_fwd(fa.KERNEL_PRESCALED, q, k, v), iters)
        plain_ms = median_ms(lambda: fa.flash_attention_ref(q, k, v, prescale_q=True), iters)
        lib_ms = median_ms(lambda: sdpa_fwd(q, k, v, scale=64 ** -0.5), iters)
        bms, by = bound_ms(2, 2, heads, tokens, tokens, 64, torch.bfloat16, nbytes(q, k, v, out))
        per_call["K3"] += sites * ms
        per_call["K3_cc"] += sites * cc_ms
        tflops = 4.0 * 2 * heads * tokens * tokens * 64 / 1e9
        print(f"[K3] {label} bf16 ({sites} sites per call): "
              f"{show(out, ref)}; K3_cc {show(cc, ref)}; K3 tensor cores "
              f"{ms:.4f} ms ({tflops / ms:.1f} TFLOP/s), K3_cc {cc_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library (SDPA, same scale) {lib_ms:.4f} ms, bound "
              f"{bms:.4f} ms ({by})")
        if tokens == 4096:
            planted("K3 scaling q twice", k3_scaled_twice(fa, q, k, v), ref, BF16_TOL)
            common = {"plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}
            numbers = {"K3": {"ms": ms, **common}, "K3_cc": {"ms": cc_ms, **common}}
        del q, k, v, out, cc, ref
    print(f"[K3] per model call ({K3_PER_CALL} sites): tensor cores {per_call['K3']:.3f} ms, "
          f"CUDA cores {per_call['K3_cc']:.3f} ms")
    for key in numbers:
        numbers[key]["max_abs_err"] = max_err[key]
    return numbers


def k4_case(qm, gen, m, k, n, copies: int = 1):
    """x [m, k] bf16 and ``copies`` int8 weights [k, n] with their scales
    and dequantised bf16 twins (the library call's operand)."""
    import torch

    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    weights = []
    for _ in range(copies):
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        w_q, scale = qm.quantize_weight(w.to(torch.bfloat16))
        weights.append((w_q, scale, (w_q.float() * scale).to(torch.bfloat16)))
    return x, weights


def phase_k4(qm):
    """K4 against its plain version at the dense shapes of the int8 path
    (an in-loop model call's, and a request's hoisting: the k/v products
    and the timestep tables on the 11 and 50 rows of the EDM and spaced
    grids) and the 6 of the int8 captioner (bf16 activations), each on the entry
    that ``quant_entries`` names (by counter: the tensor-core tile form
    above 8 rows, the GEMV form at 1 and 2), the CUDA-core entry K4_cc on
    the same inputs; device times of both beside the plain version, the
    library call and the bound (the GEMV form's and its library call's over
    weights rotated past the L2 cache, as a decode step finds them); a
    planted fault per form. Returns the kernel lines' numbers of K4 and
    K4_cc at the GEGLU projection of the 64^2 level, (8192, 320, 2560), and
    of K4_gemv at the decode shape (1, 4096, 4096): ``ms`` and
    ``library_ms`` one host call each, as for every kernel of the line,
    ``device_ms`` and ``library_device_ms`` the device times."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    max_err = dict.fromkeys(("K4", "K4_gemv", "K4_cc"), 0.0)
    numbers, per_call, caption = {}, {"K4": 0.0, "K4_cc": 0.0}, {}
    hoist = {**hoist_sites(CLI_STEPS + 1), **hoist_sites(STEPS)}
    per_hoist = {CLI_STEPS + 1: 0.0, STEPS: 0.0}
    cases = [(shape, f"{sites} per call") for shape, sites in K4_SITES.items()]
    cases += [(shape, f"{sites} per request's hoisting") for shape, sites in hoist.items()
              if shape not in K4_SITES]
    cases += [((m, k, n), "captioner") for m in (CAPTION_ROWS, 1) for k, n in LLAVA_SITES]
    for (m, k, n), where in cases:
        gemv = m <= GEMV_MAX_ROWS
        copies = -(-2 * L2_BYTES // (k * n)) if gemv else 1
        x, weights = k4_case(qm, gen, m, k, n, copies)
        w_q, scale, w_deq = weights[0]
        key = "K4_gemv" if gemv else "K4"
        check(KERNELS[key] is qm.quant_entries(x), f"quant_entries names another entry at {m} rows")
        before = counts()
        out = qm.quant_matmul(x, w_q, scale)
        moved = launched_since(before)
        label = f"({m}, {k}, {n})"
        check(moved == {key: 1}, f"K4 at {label} launched {moved}, expected {key} once")
        cc = qm.launch_quant(qm.KERNEL, x, w_q, scale)
        ref = qm.quant_matmul_ref(x, w_q, scale)
        max_err[key] = max(max_err[key], hold(f"{key} at {label}", out, ref, BF16_TOL))
        max_err["K4_cc"] = max(max_err["K4_cc"], hold(f"K4_cc at {label}", cc, ref, BF16_TOL))
        if gemv:
            check(torch.equal(out, qm.quant_matmul(x, w_q, scale)),
                  f"K4_gemv at {label}: a rerun differs")

        def entry(i):
            return qm.quant_matmul(x, *weights[i % copies][:2])

        ms = device_ms(entry)
        host_ms = median_ms(lambda: entry(0))
        cc_ms = device_ms(lambda i: qm.launch_quant(qm.KERNEL, x, *weights[i % copies][:2]),
                          5 if m * k * n > 2 ** 32 else 20)
        plain_ms = median_ms(lambda: qm.quant_matmul_ref(x, w_q, scale), 10)
        lib_ms = device_ms(lambda i: x @ weights[i % copies][2])
        bms, by = gemm_bound(m, k, n, x, w_q, scale, out)
        rate = (f"{nbytes(x, w_q, scale, out) / ms / 1e9:.3f} TB/s" if gemv
                else f"{2e-9 * m * k * n / ms:.1f} TFLOP/s")
        if where == "captioner":
            caption[(m, k, n)] = ms
        for grid in per_hoist:
            per_hoist[grid] += hoist_sites(grid).get((m, k, n), 0) * ms
        per_call["K4"] += K4_STEP_SITES.get((m, k, n), 0) * ms
        per_call["K4_cc"] += K4_STEP_SITES.get((m, k, n), 0) * cc_ms
        print(f"[K4] (M, K, N) {label} ({where}, {key}): {show(out, ref)}; K4_cc "
              f"{show(cc, ref)}; device ms: {key} {ms:.4f} ({rate}; one host call "
              f"{host_ms:.4f}), K4_cc {cc_ms:.4f}, library (x @ dequantised bf16 W) "
              f"{lib_ms:.4f}; plain {plain_ms:.4f} ms; bound {bms:.4f} ms ({by})")
        if (m, k, n) in ((8192, 320, 2560), (1, 4096, 4096)):
            common = {"plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                      "library_ms": median_ms(lambda: x @ w_deq),
                      "library_device_ms": lib_ms}
        if (m, k, n) == (8192, 320, 2560):
            planted("K4 dropping its last 64-deep K stage",
                    qm.quant_matmul(x[:, :-64].contiguous(), w_q[:-64].contiguous(), scale),
                    ref, BF16_TOL)
            numbers["K4"] = {"ms": host_ms, "device_ms": ms, **common}
            numbers["K4_cc"] = {"ms": median_ms(lambda: qm.launch_quant(qm.KERNEL, x, w_q, scale)),
                                "device_ms": cc_ms, **common}
        if (m, k, n) == (1, 4096, 4096):
            splits = qm.gemv_splits(m, n, k, torch.cuda.get_device_properties(0)
                                    .multi_processor_count)
            rows = (-(-k // splits) + 31) // 32 * 32  # a split's rows, as the kernel cuts them
            dropped = w_q.clone()
            dropped[:rows] = 0
            planted(f"K4_gemv dropping one K split (rows 0-{rows - 1})",
                    qm.quant_matmul(x, dropped, scale), ref, BF16_TOL)
            numbers["K4_gemv"] = {"ms": host_ms, "device_ms": ms, **common}
        del x, weights, w_q, scale, w_deq, out, cc, ref
    print(f"[K4] per hoisted denoise step ({K4_PER_STEP} tile launches), device time: "
          f"{per_call['K4']:.3f} ms (K4_cc {per_call['K4_cc']:.3f} ms); per request's "
          f"hoisting ({K4_PER_HOIST} tile launches): {per_hoist[CLI_STEPS + 1]:.3f} ms on the "
          f"{CLI_STEPS + 1}-row EDM grid, {per_hoist[STEPS]:.3f} ms on the {STEPS}-row "
          f"spaced grid; "
          f"per int8 caption ({QUANT_PREFILL_PER_CAPTION} tile, "
          f"{QUANT_PER_CAPTION - QUANT_PREFILL_PER_CAPTION} GEMV launches): "
          f"{per_caption_ms(caption):.3f} ms")
    for key in numbers:
        numbers[key]["max_abs_err"] = max_err[key]
    return numbers


def int8_params(fr, p: dict) -> dict:
    """The int8 twin of a float K6 parameter dict (OIHW -> HWIO, quantised)."""
    q = {k: v for k, v in p.items() if not k.startswith("w")}
    for name, scale in (("w1", "s1"), ("w2", "s2"), ("w_skip", "s_skip")):
        if name in p:
            q[name + "_q"], q[scale] = fr.quantize_conv_weight(p[name].permute(2, 3, 1, 0))
    return q


def without_last_tap(p: dict) -> dict:
    """conv2 without its last tap (ky = kx = 2), in either weight mode (the
    float weight's HWIO copy dropped, so the kernel reads the edited w2)."""
    p = dict(p)
    if "w2_q" in p:
        p["w2_q"] = p["w2_q"].clone()
        p["w2_q"][2, 2] = 0
    else:
        p["w2"] = p["w2"].clone()
        p["w2"][:, :, 2, 2] = 0
        p.pop("w2_t", None)
    return p


def without_split(p: dict, stages: int) -> dict:
    """conv2 without the products of its first ``stages`` 64-deep K stages
    (the first K split of the tensor-core entry: stage g is the 64-channel
    slice g // 9 at tap g % 9), in either weight mode."""
    p = dict(p)
    key = "w2_q" if "w2_q" in p else "w2"
    w = p[key].clone()
    for g in range(stages):
        tap, c0 = g % 9, 64 * (g // 9)
        if key == "w2_q":  # HWIO
            w[tap // 3, tap % 3, c0:c0 + 64] = 0
        else:  # OIHW
            w[:, c0:c0 + 64, tap // 3, tap % 3] = 0
    p[key] = w
    p.pop("w2_t", None)  # the HWIO copy of the float weight: made from w2 again
    return p


def k6_launches_apart(fr, x, e, pm, calls: int = 5) -> dict:
    """Device ms per call of each kind of launch of one tensor-core K6 call
    (torch.profiler): the GroupNorm statistics and apply launches, the
    convs, their reduces."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fr.fused_resblock(x, e, pm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fr.fused_resblock(x, e, pm)
        torch.cuda.synchronize()
    names = {"GN stats": "gn_stats_kernel", "GN apply": "gn_apply_kernel",
             "conv": "conv_tc_kernel", "reduce": "conv_reduce_kernel"}
    out = dict.fromkeys(names, 0.0)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            for key, sym in names.items():
                if sym in ev.name:
                    out[key] += ev.time_range.elapsed_us() / 1e3 / calls
    return out


def phase_k6(fr):
    """K6, float and int8 weights, against its plain version at the 14
    ResBlock sites of the serving path (bf16, batch 2), on the tensor-core
    entry that ``resblock_entries`` names (by counter), and the CUDA-core
    entry K6_cc on the same inputs; device times of both (and of the
    tensor-core call's launches apart, by the profiler) beside one host
    call, the plain version, the library yardsticks (the unfused ResBlock
    module: several calls; the two bf16 cuDNN 3x3 convolutions of the site
    alone) and the bound; at three sites the K split of ``resblock_splits``
    against none. Faults: the last tap of conv2 dropped; conv2's first K
    split dropped. Returns the kernel lines' numbers of K6 and K6_cc at
    (320, 320, 64^2) in float mode."""
    import torch
    import torch.nn.functional as F

    from diffbir_tpu_torch.models.unet import ResBlock

    gen = torch.Generator(device="cuda").manual_seed(4)
    max_err, numbers = {"K6": 0.0, "K6_cc": 0.0}, {}
    per_call = {(k, mode): 0.0 for k in ("K6", "K6_cc", "conv") for mode in ("float", "int8")}
    apart = {"GN stats": 0.0, "GN apply": 0.0, "conv": 0.0, "reduce": 0.0}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (cin, cout, hw), sites in K6_SITES.items():
        block = randomize_(ResBlock(cin, cout, 1280, torch.bfloat16, device="cuda"), gen)
        block.fused = True
        x = torch.randn(2, cin, hw, hw, generator=gen, device="cuda").to(torch.bfloat16)
        emb = torch.randn(2, 1280, generator=gen, device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            e = block.emb_layers(emb)
            p = block.fused_params()
            block.fused = False
            lib_ms = median_ms(lambda: block(x, emb), 10)
            lib_dev = device_ms(lambda i: block(x, emb), 10)
            # the site's two 3x3 convolutions alone, bf16 cuDNN, on SiLU(GN(.))-sized operands
            y1 = torch.randn(2, cin, hw, hw, generator=gen, device="cuda").to(torch.bfloat16)
            y2 = torch.randn(2, cout, hw, hw, generator=gen, device="cuda").to(torch.bfloat16)
            conv_ms = device_ms(lambda i: (F.conv2d(y1, p["w1"], padding=1),
                                           F.conv2d(y2, p["w2"], padding=1)), 10)
        params = {"float": p, "int8": int8_params(fr, p)}
        label = f"({cin}, {cout}, {hw}^2)"
        m = 2 * hw * hw
        gflop = 2.0 * m * cout * (9 * cin + 9 * cout + (cin if cin != cout else 0)) / 1e9
        t_ops = 1e9 * gflop / PEAK_FLOPS["bfloat16"]
        splits = (fr.resblock_splits(m, cout, cin, sms), fr.resblock_splits(m, cout, cout, sms))
        for mode, pm in params.items():
            check(fr.resblock_entries(x) is KERNELS["K6"], "resblock_entries names another entry")
            before = counts()
            out = fr.fused_resblock(x, e, pm)
            moved = launched_since(before)
            check(moved == {"K6": 1}, f"K6 at {label} launched {moved}, expected K6 once")
            cc = fr.launch_resblock(fr.KERNEL, x, e, pm)
            ref = fr.fused_resblock_ref(x, e, pm)
            max_err["K6"] = max(max_err["K6"], hold(f"K6 {mode} at {label}", out, ref, BF16_TOL))
            max_err["K6_cc"] = max(max_err["K6_cc"], hold(f"K6_cc {mode} at {label}", cc, ref,
                                                          BF16_TOL))
            check(torch.equal(out, fr.fused_resblock(x, e, pm)), f"K6 at {label}: a rerun differs")
            ms = device_ms(lambda i: fr.fused_resblock(x, e, pm), 10)
            host_ms = median_ms(lambda: fr.fused_resblock(x, e, pm), 10)
            cc_ms = device_ms(lambda i: fr.launch_resblock(fr.KERNEL, x, e, pm), 3)
            plain_ms = median_ms(lambda: fr.fused_resblock_ref(x, e, pm), 5)
            moved_bytes = nbytes(x, e, out, *[v for k, v in pm.items() if not k.endswith("_t")])
            t_bytes = moved_bytes / PEAK_BYTES
            bms, by = 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
            per_call[("K6", mode)] += sites * ms
            per_call[("K6_cc", mode)] += sites * cc_ms
            per_call[("conv", mode)] += sites * conv_ms
            parts = ""
            if mode == "float":
                launches = k6_launches_apart(fr, x, e, pm)
                for k, v in launches.items():
                    apart[k] += sites * v
                parts = "; launches apart (device ms per call): " + ", ".join(
                    f"{k} {v:.4f}" for k, v in launches.items())
            print(f"[K6] {mode} {label} ({sites} per call; K splits {splits}): "
                  f"{show(out, ref)}; K6_cc {show(cc, ref)}; device ms: K6 {ms:.4f} "
                  f"({gflop / ms:.1f} TFLOP/s; one host call {host_ms:.4f}), K6_cc {cc_ms:.4f}, "
                  f"library (unfused ResBlock module, several calls) {lib_dev:.4f} (one host "
                  f"call {lib_ms:.4f}), the two bf16 cuDNN 3x3 convs alone {conv_ms:.4f}; plain "
                  f"{plain_ms:.4f} ms; bound {bms:.4f} ms ({by}){parts}")
            if (cin, cout, hw) in ((320, 320, 64), (1280, 1280, 16), (2560, 1280, 8)):
                unsplit = device_ms(lambda i: fr.launch_resblock(fr.KERNEL_TC, x, e, pm,
                                                                 splits=(1, 1)), 10)
                print(f"[K6] {mode} {label}: K splits {splits} {ms:.4f} ms, none {unsplit:.4f} ms")
            if (cin, cout, hw) == (320, 320, 64):
                planted(f"K6 {mode} skipping the last tap of conv2",
                        fr.fused_resblock(x, e, without_last_tap(pm)), ref, BF16_TOL)
                if mode == "float":
                    common = {"plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                              "library_ms": lib_ms, "library_device_ms": lib_dev,
                              "conv_library_device_ms": conv_ms}
                    numbers["K6"] = {"ms": host_ms, "device_ms": ms, **common}
                    numbers["K6_cc"] = {"ms": median_ms(lambda: fr.launch_resblock(
                        fr.KERNEL, x, e, pm), 5), "device_ms": cc_ms, **common}
            if (cin, cout, hw) == (2560, 1280, 8):
                total = 9 * -(-cout // 64)
                per = -(-total // splits[1])
                check(splits[1] > 1, f"K6 at {label}: conv 2 is not split")
                planted(f"K6 {mode} dropping conv 2's first K split ({per} stages)",
                        fr.fused_resblock(x, e, without_split(pm, per)), ref, BF16_TOL)
            del out, cc, ref
        del block, x, params, p, y1, y2
    print(f"[K6] per model call ({K6_PER_CALL} ResBlocks), device time: float K6 "
          f"{per_call[('K6', 'float')]:.3f} ms (K6_cc {per_call[('K6_cc', 'float')]:.3f}), int8 "
          f"K6 {per_call[('K6', 'int8')]:.3f} ms (K6_cc {per_call[('K6_cc', 'int8')]:.3f}); the "
          f"sites' bf16 cuDNN 3x3 convs alone {per_call[('conv', 'float')]:.3f} ms; float K6's "
          f"launches apart: " + ", ".join(f"{k} {v:.3f} ms" for k, v in apart.items()))
    for key in numbers:
        numbers[key]["max_abs_err"] = max_err[key]
    return numbers


def swapped_halves(w1, b1):
    """W1 and b1 with the value (a) and gate (g) halves swapped: K7 run on
    them computes g * gelu(a)."""
    import torch

    inner = w1.shape[0] // 2
    return (torch.cat([w1[inner:], w1[:inner]]).contiguous(),
            torch.cat([b1[inner:], b1[:inner]]).contiguous())


def phase_k7(ff):
    """K7 against its plain version at the four FFN shapes of the serving
    path (bf16, batch 2) on the entry that ``ffn_entries`` names (by
    counter: the tensor-core one), and the CUDA-core entry K7_cc on the same
    inputs; device times beside the plain version, the library yardstick
    (the unfused FeedForward module) and the bound. Returns the kernel
    lines' numbers of K7 and K7_cc at (8192 rows, d = 320), timed as
    ``phase_k4``'s."""
    import torch

    from diffbir_tpu_torch.models.unet import FeedForward

    gen = torch.Generator(device="cuda").manual_seed(5)
    max_err, numbers = {"K7": 0.0, "K7_cc": 0.0}, {}
    per_call = {"K7": 0.0, "K7_cc": 0.0}
    for (tokens, d), sites in K7_SITES.items():
        ffm = randomize_(FeedForward(d, torch.bfloat16, device="cuda"), gen)
        x = torch.randn(2 * tokens, d, generator=gen, device="cuda").to(torch.bfloat16)
        proj, down = ffm.net[0].proj, ffm.net[2]
        args = (x, proj.weight, proj.bias, down.weight, down.bias)
        label = f"({2 * tokens}, {d})"
        with torch.no_grad():
            check(ff.ffn_entries(x) is KERNELS["K7"], f"ffn_entries names another entry at {label}")
            before = counts()
            out = ff.fused_ffn(*args)
            moved = launched_since(before)
            check(moved == {"K7": 1}, f"K7 at {label} launched {moved}, expected K7 once")
            cc = ff.launch_ffn(ff.KERNEL, *args)
            ref = ff.fused_ffn_ref(*args)
            max_err["K7"] = max(max_err["K7"], hold(f"K7 at {label}", out, ref, BF16_TOL))
            max_err["K7_cc"] = max(max_err["K7_cc"], hold(f"K7_cc at {label}", cc, ref, BF16_TOL))
            ms = device_ms(lambda i: ff.fused_ffn(*args))
            host_ms = median_ms(lambda: ff.fused_ffn(*args))
            cc_ms = device_ms(lambda i: ff.launch_ffn(ff.KERNEL, *args), 5)
            plain_ms = median_ms(lambda: ff.fused_ffn_ref(*args), 10)
            lib_ms = device_ms(lambda i: ffm(x))
        n, inner = 2 * tokens, 4 * d
        t_ops = 6.0 * n * d * inner / PEAK_FLOPS["bfloat16"]
        t_bytes = nbytes(out, *args) / PEAK_BYTES
        bms, by = 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
        per_call["K7"] += sites * ms
        per_call["K7_cc"] += sites * cc_ms
        print(f"[K7] (rows, d) {label} ({sites} per call): {show(out, ref)}; K7_cc "
              f"{show(cc, ref)}; device ms: K7 {ms:.4f} "
              f"({6e-9 * n * d * inner / ms:.1f} TFLOP/s; one host call {host_ms:.4f}), "
              f"K7_cc {cc_ms:.4f}, library (unfused FeedForward module) {lib_ms:.4f}; plain "
              f"{plain_ms:.4f} ms; bound {bms:.4f} ms ({by})")
        if d == 320:
            with torch.no_grad():
                faulty = ff.fused_ffn(x, *swapped_halves(proj.weight, proj.bias), down.weight,
                                      down.bias)
                common = {"plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                          "library_ms": median_ms(lambda: ffm(x)), "library_device_ms": lib_ms}
                numbers = {"K7": {"ms": host_ms, "device_ms": ms, **common},
                           "K7_cc": {"ms": median_ms(lambda: ff.launch_ffn(ff.KERNEL, *args), 5),
                                     "device_ms": cc_ms, **common}}
            planted("K7 with the value and gate halves swapped", faulty, ref, BF16_TOL)
        del ffm, x, args, out, cc, ref
    print(f"[K7] per model call ({K7_PER_CALL} FFNs), device time: {per_call['K7']:.3f} ms "
          f"(K7_cc {per_call['K7_cc']:.3f} ms)")
    for key in numbers:
        numbers[key]["max_abs_err"] = max_err[key]
    return numbers


# --------------------------------------------------------------------------- #
# the serving modes end to end
# --------------------------------------------------------------------------- #
def record_sites(cldm):
    """Forward hooks on the UNet and ControlNet that record the shape of each
    K3, K4, K6 and K7 call of a model call, keyed as the site tables (a
    cross-attention's k/v product of its own context as K4 (rows, K, 2
    inner)); returns (records, the hooks' handles)."""
    from collections import Counter

    from diffbir_tpu_torch.models.layers import QuantLinear
    from diffbir_tpu_torch.models.unet import CrossAttention, FeedForward, ResBlock

    rec = {name: Counter() for name in ("K3", "K4", "K6", "K7")}

    def hook(name, key):
        return lambda mod, inp, out: rec[name].update([key(mod, inp, out)])

    def attention(m, i, o):
        if len(i) == 1:  # self-attention
            if m.flash_layout == "packed":
                rec["K3"].update([(i[0].shape[1], m.heads)])
        elif i[2] is None and isinstance(m.to_k, QuantLinear):  # k/v of the context
            ctx = i[1]
            rec["K4"].update([(ctx.numel() // ctx.shape[-1], ctx.shape[-1],
                               2 * m.to_k.weight_q.shape[1])])

    handles = []
    for root in (cldm.unet, cldm.controlnet):
        for m in root.modules():
            if isinstance(m, ResBlock) and m.fused:
                handles.append(m.register_forward_hook(hook(
                    "K6", lambda m, i, o: (i[0].shape[1], o.shape[1], i[0].shape[2]))))
            elif isinstance(m, FeedForward) and m.fused:
                handles.append(m.register_forward_hook(hook(
                    "K7", lambda m, i, o: tuple(i[0].shape[1:]))))
            elif isinstance(m, CrossAttention):
                handles.append(m.register_forward_hook(attention))
            elif isinstance(m, QuantLinear):
                handles.append(m.register_forward_hook(hook(
                    "K4", lambda m, i, o: (i[0].numel() // i[0].shape[-1], *m.weight_q.shape))))
    return rec, handles


def mode_call(label: str, model, inputs, ref, expected: dict, tables: dict):
    """One model call of ``model`` in a serving mode on ``inputs`` (x, t,
    cond): its launches, the shape of every kernel call against the site
    tables, and its output against ``ref`` (the unfused float path)."""
    import torch

    x, t, cond = inputs
    rec, handles = record_sites(model)
    try:
        with torch.no_grad():
            before = counts()
            out = model(x, t, cond).float()
            torch.cuda.synchronize()
            n = launched_since(before)
    finally:
        for h in handles:
            h.remove()
    rec = {k: {site: c for site, c in v.items() if site is not None} for k, v in rec.items()}
    print(f"[{label}] model call launches " + ", ".join(f"{k} {v}" for k, v in n.items()))
    check(n == expected, f"{label}: expected launches {expected} per model call, got {n}")
    for name, table in tables.items():
        check(rec[name] == table, f"{label}: {name} sites {rec[name]} != the table {table}")
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite model output")
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    print(f"[{label}] ControlLDM forward [2,64,64,4]: against the unfused float path, "
          f"relative max err {rel:.3e} (tol {MODEL_REL_TOL:g}); every kernel call at a site "
          f"of the tables")
    check(rel <= MODEL_REL_TOL, f"{label}: the model call disagrees: {rel}")


def unfused_call(cldm, inputs):
    import torch

    cldm.set_mode("default")
    with torch.no_grad():
        return cldm(*inputs).float()


def dequantise_into(float_cldm, int8_cldm) -> None:
    """Overwrite the float model's weights at every int8 site of the int8
    model with the dequantised values (w_q * scale, in the float dtype)."""
    import torch

    from diffbir_tpu_torch.models.layers import QuantConv, QuantLinear

    with torch.no_grad():
        for fr_root, q_root in ((float_cldm.unet, int8_cldm.unet),
                                (float_cldm.controlnet, int8_cldm.controlnet)):
            for name, m in q_root.named_modules():
                if isinstance(m, QuantLinear):
                    w = (m.weight_q.float() * m.weight_scale).T  # [in, out] -> [out, in]
                elif isinstance(m, QuantConv):
                    w = (m.weight_q.float() * m.weight_scale).permute(3, 2, 0, 1)  # -> OIHW
                else:
                    continue
                target = fr_root.get_submodule(name).weight
                target.copy_(w.to(target.dtype))


def phase_modes(cldm, swinir):
    """The two serving modes: a model call each against the unfused float
    path, then requests; returns {path: launch counts of its requests}."""
    import copy

    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2, 64, 64, 4, generator=gen, device="cuda")
    c_img = torch.randn(2, 64, 64, 4, generator=gen, device="cuda")
    with torch.no_grad():
        cond = {"c_txt": cldm.encode_text(empty_tokens(2)), "c_img": c_img}
    inputs = (x, torch.tensor([999.0, 500.0], device="cuda"), cond)
    launches = {}

    # "fused": fused ResBlock + fused FFN + packed flash, on the float weights
    ref = unfused_call(cldm, inputs)
    cldm.set_mode("fused")
    mode_call("serve_fused", cldm, inputs, ref,
              {"K3": K3_PER_CALL, "K6": K6_PER_CALL, "K7": K7_PER_CALL},
              {"K3": K3_SITES, "K6": K6_SITES, "K7": K7_SITES})
    phase_hoist("fused", cldm, {"K3": K3_PER_CALL, "K6": K6_PER_CALL, "K7": K7_PER_CALL}, {})
    launches["serve_fused"] = phase_slice("serve_fused", cldm, swinir, MODE_SEEDS, repeat=False)

    # "int8": the UNet and ControlNet quantised in place (dense, then convs)
    cldm.set_mode("default")
    t0 = time.perf_counter()
    int8 = copy.deepcopy(cldm).set_mode("int8")
    torch.cuda.synchronize()
    print(f"[serve_int8] copied and quantised in {time.perf_counter() - t0:.2f} s")
    dequantise_into(cldm, int8)
    ref = unfused_call(cldm, inputs)
    mode_call("serve_int8", int8, inputs, ref,
              {"K3": K3_PER_CALL, "K4": K4_TILE_PER_CALL, "K4_gemv": K4_GEMV_PER_CALL,
               "K6": K6_PER_CALL},
              {"K3": K3_SITES, "K4": K4_SITES, "K6": K6_SITES})
    phase_hoist("int8", int8, {"K3": K3_PER_CALL, "K4": K4_PER_STEP, "K6": K6_PER_CALL},
                {"K4": K4_PER_HOIST})
    launches["serve_int8"] = phase_slice("serve_int8", int8, swinir, MODE_SEEDS, repeat=False)
    del int8
    return launches


# --------------------------------------------------------------------------- #
# hoisting, the CLI's entry point, the other samplers
# --------------------------------------------------------------------------- #
def default_prompt_context(cldm):
    """[2, 77, 1024]: the CLI's default prompts (cond, then uncond) through
    the stand-in tokenizer and CLIP."""
    import torch

    from diffbir_tpu_torch.profile_step import NEG_PROMPT, POS_PROMPT, stand_in_tokenizer

    ids = torch.as_tensor(stand_in_tokenizer()([POS_PROMPT, NEG_PROMPT]), device="cuda")
    with torch.no_grad():
        return cldm.encode_text(ids)


def phase_hoist(mode: str, model, step_launches: dict, hoist_launches: dict) -> None:
    """[hoist]: one full-width model call in ``mode`` at batch 2 (folded CFG
    on the default prompts) at t = 999, through the hoisted tables of the
    CLI's EDM grid against the model's own in-loop call, within BF16_TOL x
    max|ref|; the launches of the tables and of the hoisted call; a planted
    fault (the rows of the grid's next timestep, 899) must fail the limit."""
    import torch

    from diffbir_tpu_torch.pipeline import build_sampler
    from diffbir_tpu_torch.schedule import Schedule

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(2, 64, 64, 4, generator=gen, device="cuda")
    cond = {"c_txt": default_prompt_context(model),
            "c_img": torch.randn(2, 64, 64, 4, generator=gen, device="cuda")}
    grid = build_sampler("edm_dpm++_3m_sde", Schedule.v21(), False).model_ts(CLI_STEPS)
    t = float(grid.max())
    tv = torch.full((2,), t, device="cuda")
    with torch.no_grad():
        before = counts()
        tables = model.make_hoist_tables(cond["c_txt"], grid)
        torch.cuda.synchronize()
        made = launched_since(before)
        ref = model(x, tv, cond).float()
        before = counts()
        out = model(x, tv, cond, hoisted=tables.lookup(t)).float()
        torch.cuda.synchronize()
        n = launched_since(before)
        faulty = model(x, tv, cond, hoisted=tables.lookup(float(grid[1]))).float()
    print(f"[hoist] {mode}: the tables of the {len(tables.ts)}-timestep grid launched {made}; "
          f"the hoisted call {n}; against the in-loop call {show(out, ref)}")
    check(made == hoist_launches, f"[hoist] {mode}: the tables launched {made}, "
          f"expected {hoist_launches}")
    check(n == step_launches, f"[hoist] {mode}: the hoisted call launched {n}, "
          f"expected {step_launches}")
    check(bool(torch.isfinite(out).all()), f"[hoist] {mode}: non-finite output")
    hold(f"the hoisted {mode} call", out, ref, BF16_TOL)
    planted(f"hoist {mode}: a step handed the next grid timestep's rows", faulty, ref, BF16_TOL)


@contextlib.contextmanager
def cli_environment(root: str):
    """The CLI's environment for an in-process run: random full-width
    weights (DIFFBIR_TPU_RANDOM_INIT) and a stand-in merges file of the
    default prompts written under ``root`` (DIFFBIR_TPU_BPE_PATH), restored
    afterwards."""
    from diffbir_tpu_torch.inference.__main__ import DEFAULT_NEG_PROMPT, DEFAULT_POS_PROMPT
    from diffbir_tpu_torch.models import tokenizer

    bpe = os.path.join(root, tokenizer.BPE_NAME)
    tokenizer.write_stand_in_merges(bpe, [DEFAULT_POS_PROMPT, DEFAULT_NEG_PROMPT])
    saved = {k: os.environ.get(k) for k in ("DIFFBIR_TPU_BPE_PATH", "DIFFBIR_TPU_RANDOM_INIT")}
    os.environ.update(DIFFBIR_TPU_BPE_PATH=bpe, DIFFBIR_TPU_RANDOM_INIT="1")
    tokenizer.get_tokenizer.cache_clear()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tokenizer.get_tokenizer.cache_clear()


def stages(t: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in t.items())


def cli_request_argv(path: str, flags) -> tuple:
    """(root, argv) of a CLI request under build/cli_request/``path``: a
    seeded PNG (CLI_LQ square, or CLI_LQ_SIZE[path]) in ``root``/in, the
    output to ``root``/out (both made anew), --task sr and --upscale 4 unless
    ``flags`` name others, and ``flags``."""
    import shutil

    import numpy as np

    from diffbir_tpu_torch.utils.image_io import write_png

    root = os.path.join("build", "cli_request", path)
    in_dir, out_dir = os.path.join(root, "in"), os.path.join(root, "out")
    for d in (in_dir, out_dir):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(in_dir)
    side = CLI_LQ_SIZE.get(path, CLI_LQ)
    write_png(os.path.join(in_dir, "lq.png"), np.random.default_rng(7).integers(
        0, 256, (side, side, 3), dtype=np.uint8))
    task = [] if "--task" in flags else ["--task", "sr"]
    upscale = [] if "--upscale" in flags else ["--upscale", str(CLI_UPSCALE)]
    return root, [*task, "--input", in_dir, "--output", out_dir, *upscale, *flags]


def write_custom_model(root: str) -> None:
    """--version custom's files under ``root``: train.yaml (the model section
    of configs/train/train_stage2_v2.1.yaml, as written there, and a train
    section naming the SD base), and, from a full-width ControlLDM with
    random weights from CUSTOM_SEED, the SD base (sd.ckpt: the UNet, VAE and
    CLIP under the SD checkpoint's prefixes) and the ControlNet
    (controlnet.pt), both bf16. Prints the seconds the writing took."""
    import torch

    from diffbir_tpu_torch.models.cldm import ControlLDM
    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.weights.convert import SD_MODULE_MAP

    os.makedirs(root, exist_ok=True)
    with open(os.path.join("configs", "train", "train_stage2_v2.1.yaml")) as f:
        lines = f.read().splitlines()
    start = lines.index("model:")
    end = next(i for i in range(start + 1, len(lines))
               if lines[i][:1] not in ("", " ", "#"))
    sd_path = os.path.join(root, "sd.ckpt")
    with open(os.path.join(root, "train.yaml"), "w") as f:
        f.write("\n".join(lines[start:end]) + f"\ntrain:\n  sd_path: {sd_path}\n"
                "  swinir_path: swinir_realesrgan\n")
    t0 = time.perf_counter()
    cldm = ControlLDM.sd21(dtype=torch.bfloat16, device="meta").to_empty(device="cuda")
    random_init_(cldm, torch.Generator(device="cuda").manual_seed(CUSTOM_SEED))
    sd = {prefix + k: v.cpu() for name, prefix in SD_MODULE_MAP.items()
          for k, v in getattr(cldm, name).state_dict().items()}
    cn = {k: v.cpu() for k, v in cldm.controlnet.state_dict().items()}
    del cldm
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    torch.save({"state_dict": sd}, sd_path)
    torch.save(cn, os.path.join(root, "controlnet.pt"))
    t2 = time.perf_counter()
    size = sum(os.path.getsize(os.path.join(root, n)) for n in ("sd.ckpt", "controlnet.pt"))
    print(f"[cli_custom] wrote the SD base ({sum(v.numel() for v in sd.values()) / 1e6:.1f} M "
          f"params) and the ControlNet ({sum(v.numel() for v in cn.values()) / 1e6:.1f} M), "
          f"bf16, {size / 2**30:.3f} GiB: built on the card and copied to the host in "
          f"{t1 - t0:.3f} s, written in {t2 - t1:.3f} s; train.yaml holds "
          f"train_stage2_v2.1.yaml's model section")


def cli_refuses(label: str, flags, error, match: str) -> None:
    """The CLI request with ``flags`` raises ``error`` naming ``match``."""
    from diffbir_tpu_torch.inference.__main__ import main

    root, argv = cli_request_argv("refused", flags)
    with cli_environment(root):
        try:
            main(argv)
        except error as e:
            check(match in str(e), f"{label}: {type(e).__name__} does not say {match!r}: {e}")
            print(f"[{label}] {' '.join(flags)}: {type(e).__name__}: {e}")
            return
    check(False, f"{label}: {' '.join(flags)} ran; expected {error.__name__}")


def phase_cli_request(path: str, spec=None, with_loop=None):
    """[cli_request]: ``python -m diffbir_tpu_torch.inference`` run in this
    process (``main``) on a seeded 128x128 PNG with --upscale 4 and the
    CLI's defaults (v2.1, 10 steps of edm_dpm++_3m_sde at CFG 6.0, the
    default prompts through a stand-in merges file written here), random
    full-width weights (DIFFBIR_TPU_RANDOM_INIT), plus the path's flags
    (``spec`` = (expected launches, flags), CLI_PATHS[path] by default):
    exact launches, seconds per stage, the PNG equal to a direct
    ``pipeline.run`` of the request (the loop's pipeline: its guidance, its
    model's serving flags), and a rerun bit-identical. Returns the launch
    counts of the entry point's run and {"png", "seconds", "stages",
    "peak"} of it and of the rerun of its loop ("rerun_seconds",
    "rerun_stages"). ``with_loop``: called on the loop after the rerun."""
    import numpy as np
    import torch

    from diffbir_tpu_torch.inference.__main__ import main
    from diffbir_tpu_torch.utils.image_io import read_png, read_rgb

    expected, flags = spec or CLI_PATHS[path]
    root, argv = cli_request_argv(path, flags)
    in_dir, out_dir = os.path.join(root, "in"), os.path.join(root, "out")
    if path == "cli_custom":
        write_custom_model(CUSTOM_ROOT)
    with cli_environment(root):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()  # count only this path from here
        t0 = time.perf_counter()
        loop = main(argv)
        dt = time.perf_counter() - t0
        launches = counts()
        n = {k: v for k, v in launches.items() if v}
        first = dict(loop.timings)
        out = read_png(os.path.join(out_dir, "lq.png"))
        size = int(CLI_LQ_SIZE.get(path, CLI_LQ) * loop.args.upscale)
        check(out.shape == (size, size, 3) and float(out.std()) > 1.0,
              f"{path}: bad output {out.shape}, std {out.std()}")
        check(n == expected, f"{path}: expected launches {expected}, got {n}")
        lq = loop.after_load_lq(read_rgb(os.path.join(in_dir, "lq.png")))
        a = loop.args
        direct = loop.pipeline.run(
            lq[None], steps=a.steps, pos_prompt=a.pos_prompt, neg_prompt=a.neg_prompt,
            cfg_scale=a.cfg_scale, sampler_type=a.sampler, seed=a.seed, eta=a.eta,
            s_tmax=a.s_tmax, order=a.order, control_interval=a.control_interval,
            turbo_encoder=a.turbo_encoder)
        check(np.array_equal(direct[0], out), f"{path}: the PNG differs from pipeline.run")
        loop.timings = {}
        before = counts()
        t1 = time.perf_counter()
        loop.run()
        dt2 = time.perf_counter() - t1
        check(launched_since(before) == expected, f"{path}: the rerun launched another count")
        check(np.array_equal(read_png(os.path.join(out_dir, "lq.png")), out),
              f"{path}: the rerun differs")
        peak = torch.cuda.max_memory_allocated() / 2**30
        if with_loop is not None:
            with_loop(loop)
    print(f"[{path}] python -m diffbir_tpu_torch.inference {' '.join(argv)}: {dt:.3f} s "
          f"({stages(first)} s); {type(loop).__name__}, cleaner "
          f"{type(loop.cleaner).__name__}, {type(loop.pipeline).__name__}, "
          f"{loop.schedule.parameterization} schedule; launches "
          + ", ".join(f"{k} {v}" for k, v in n.items()))
    print(f"[{path}] the PNG ({size}x{size}) read back equal to pipeline.run's output; a rerun "
          f"of the loop: {dt2:.3f} s ({stages(loop.timings)} s), bit-identical; peak device "
          f"memory {peak:.2f} GiB")
    info = {"png": out, "seconds": dt, "stages": first, "rerun_seconds": dt2,
            "rerun_stages": dict(loop.timings), "peak": peak}
    del loop
    torch.cuda.empty_cache()
    return launches, info


def phase_cleaner_bsrnet():
    """[cleaner_bsrnet]: the full-width BSRNet cleaner (RRDBNet: nf 64, 23
    RRDBs, gc 32; bf16, random weights from seed 0) through
    ``BSRNetPipeline.apply_cleaner`` on a seeded 256x256 LQ at --upscale 4,
    tiled at CLEANER_TILE / CLEANER_STRIDE (9 tiles, x4, blended) and
    untiled, twice each: the 1024x1024 output's shape, finiteness and
    spread, seconds (the second run warm), peak device memory; none of the
    port's kernels runs (cuDNN convolutions)."""
    import numpy as np
    import torch

    from diffbir_tpu_torch.models.bsrnet import RRDBNet
    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.pipeline import BSRNetPipeline

    cleaner = RRDBNet(dtype=torch.bfloat16, device="meta").to_empty(device="cuda")
    random_init_(cleaner, torch.Generator(device="cuda").manual_seed(0)).eval()
    pipe = BSRNetPipeline(cleaner, None, None, torch.device("cuda"), upscale=CLI_UPSCALE)
    pipe.set_output_size((CLEANER_LQ, CLEANER_LQ))
    lq = torch.as_tensor(np.random.default_rng(19).random(
        (1, CLEANER_LQ, CLEANER_LQ, 3), dtype=np.float32), device="cuda")
    size = CLEANER_LQ * CLI_UPSCALE
    before, outs = counts(), {}
    for tiled in (True, False):
        secs = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            t0 = time.perf_counter()
            with torch.no_grad():
                out = pipe.apply_cleaner(lq, tiled, CLEANER_TILE, CLEANER_STRIDE)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        label = f"tiled {CLEANER_TILE}/{CLEANER_STRIDE}" if tiled else "untiled"
        check(tuple(out.shape) == (1, size, size, 3), f"cleaner_bsrnet {label}: shape "
              f"{tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"cleaner_bsrnet {label}: non-finite output")
        outs[label] = out
        print(f"[cleaner_bsrnet] {label}: {CLEANER_LQ}x{CLEANER_LQ} -> {tuple(out.shape)} "
              f"fp32, finite, std {float(out.std()):.4f}; {secs[0]:.4f} s, warm "
              f"{secs[1]:.4f} s; peak device memory {peak:.3f} GiB")
    check(not any(launched_since(before).values()), "cleaner_bsrnet launched a port kernel")
    a, b = outs.values()
    print(f"[cleaner_bsrnet] tiled against untiled (blended seams; not gated): max "
          f"{float((a - b).abs().max()):.4f}, mean {float((a - b).abs().mean()):.6f}")
    del cleaner, pipe, outs, a, b
    torch.cuda.empty_cache()


@contextlib.contextmanager
def recording_vae():
    """Records the last VAE encode of ``ControlLDM`` (its image in and latent
    out: a request's RGB and latent guidance targets) and the last decode
    (its latent in and image out: the request's final ones), detached."""
    from diffbir_tpu_torch.models.cldm import ControlLDM

    encode, decode = ControlLDM.vae_encode, ControlLDM.vae_decode
    rec = {}

    def vae_encode(self, image, *args, **kw):
        out = encode(self, image, *args, **kw)
        rec["image"], rec["latent"] = image.detach().float(), out.detach().float()
        return out

    def vae_decode(self, z, *args, **kw):
        out = decode(self, z, *args, **kw)
        rec["z"], rec["x"] = z.detach().float(), out.detach().float()
        return out

    ControlLDM.vae_encode, ControlLDM.vae_decode = vae_encode, vae_decode
    try:
        yield rec
    finally:
        ControlLDM.vae_encode, ControlLDM.vae_decode = encode, decode


def phase_guidance(baseline: dict) -> dict:
    """[guidance]: the CLI request under each of GUIDANCE_PATHS
    (``phase_cli_request``: exact launches, the PNG equal to pipeline.run's,
    a rerun bit-identical), each closer to its guidance target than the
    unguided request (``baseline``, the default [cli_request]'s record of
    ``recording_vae``) on the same seed: the final latent to the condition's
    latent (mse), or the final decoded image to the condition image (RGB),
    in mean squared distance; then w_mse on the latent and guidance with a
    sampler outside spaced, ddim and edm_* must raise ValueError. Returns
    each path's launch counts."""
    import torch

    paths = {}
    for path, spec in GUIDANCE_PATHS.items():
        with recording_vae() as rec:
            paths[path], _ = phase_cli_request(path, spec)
        rgb = "rgb" in spec[1]
        out, target = ("x", "image") if rgb else ("z", "latent")
        d = torch.mean((rec[out] - rec[target]) ** 2).item()
        d0 = torch.mean((baseline[out] - baseline[target]) ** 2).item()
        print(f"[guidance] {path}: mean squared distance of the request's "
              f"{'decoded image' if rgb else 'final latent'} to its guidance target "
              f"{d:.6f}, the unguided request's {d0:.6f}")
        check(d < d0, f"{path}: guidance did not move the output toward its target "
              f"({d} >= {d0})")
    cli_refuses("guidance", GUIDANCE, ValueError, "--g_space rgb")
    cli_refuses("guidance", GUIDANCE + ["--g_space", "rgb", "--sampler", "dpm++_m2"],
                ValueError, "dpm++_m2")
    return paths


def cli_once(path: str, flags):
    """One CLI request (``main``) in this process, without
    ``phase_cli_request``'s checks: (its launches, {"seconds", "peak",
    "png"}, its ``recording_vae`` record)."""
    import torch

    from diffbir_tpu_torch.inference.__main__ import main
    from diffbir_tpu_torch.utils.image_io import read_png

    root, argv = cli_request_argv(path, flags)
    with cli_environment(root), recording_vae() as rec:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        loop = main(argv)
        dt = time.perf_counter() - t0
        launches = {k: v for k, v in counts().items() if v}
        info = {"seconds": dt, "peak": torch.cuda.max_memory_allocated() / 2**30,
                "png": read_png(os.path.join(root, "out", "lq.png"))}
        print(f"[guidance_1024] {path}: python -m diffbir_tpu_torch.inference {' '.join(argv)}: "
              f"{dt:.3f} s ({stages(loop.timings)} s); launches "
              + ", ".join(f"{k} {v}" for k, v in launches.items())
              + f"; peak device memory {info['peak']:.2f} GiB ({CARD[0]})")
        del loop
    torch.cuda.empty_cache()
    return launches, info, rec


def guidance_gradient(fa, loop) -> None:
    """One RGB guidance step (-grad x scale of the request's w_mse loss)
    through the request's full-width decoder at 16384 tokens (a seeded
    128x128 latent x0, a seeded 1024x1024 target), on the flash route
    (K1_wide with lse, delta, K2a_wide, K2b_wide), with the plain route
    forced (FLASH_MIN_WIDE_GRAD past the tokens: no kernel), and with the
    plain route at batch 2 (z twice): its row 1 against batch 1 is the
    decoder's own bf16 spread (cuDNN picks other algorithms). The step and
    the mid-block attention's gradients (dq, dk, dv, by hooks) of the flash
    route must lie within GUIDED_GRAD_TOL of the plain route's (x max|plain|);
    the flash route with the wide backward skipping the last kv tile must
    fail the attention's limits."""
    import torch

    from diffbir_tpu_torch.models import vae as vae_mod
    from diffbir_tpu_torch.ops import attention as attention_mod
    from diffbir_tpu_torch.utils.cond_fn import RGBSpaceGuidance

    guide = RGBSpaceGuidance(loop.cond_fn, loop.pipeline.cldm.vae_decode)
    gen = torch.Generator(device="cuda").manual_seed(21)
    z = torch.randn(1, 128, 128, 4, generator=gen, device="cuda")
    target = torch.rand(1, TILED_SIZE, TILED_SIZE, 3, generator=gen, device="cuda") * 2 - 1
    site, runs = {}, {}
    attend, backward = vae_mod.attention, fa.flash_attention_bwd
    threshold = attention_mod.FLASH_MIN_WIDE_GRAD

    def recording(q, k, v, **kw):  # the mid-block attention's input gradients, last row
        for name, t in zip(("dq", "dk", "dv"), (q, k, v)):
            t.register_hook(lambda grad, name=name: site.__setitem__(name, grad[-1:].float()))
        return attend(q, k, v, **kw)

    def skipping(q, k, v, o, lse, g):  # the wide backward without the last kv tile
        dq, dk, dv = backward(q, k[:, :-64], v[:, :-64], o, lse, g)
        pad = torch.zeros_like(k[:, -64:])
        return dq, torch.cat([dk, pad], 1), torch.cat([dv, pad], 1)

    vae_mod.attention = recording
    try:
        for route, limit, bwd, rows in (("flash", threshold, backward, 1),
                                        ("plain", 2**31, backward, 1),
                                        ("plain at batch 2", 2**31, backward, 2),
                                        ("faulty", threshold, skipping, 1)):
            attention_mod.FLASH_MIN_WIDE_GRAD, fa.flash_attention_bwd = limit, bwd
            before = counts()
            step, _ = guide(target.repeat(rows, 1, 1, 1), z.repeat(rows, 1, 1, 1))
            torch.cuda.synchronize()
            runs[route] = ({"step": step[-1:].float(), **site}, launched_since(before))
    finally:
        vae_mod.attention, fa.flash_attention_bwd = attend, backward
        attention_mod.FLASH_MIN_WIDE_GRAD = threshold
    check(runs["flash"][1] == {"K1_wide": 1, "K1_wide_lse": 1, "K2_delta": 1, "K2a_wide": 1,
                               "K2b_wide": 1}, f"the flash route launched {runs['flash'][1]}")
    check(runs["plain"][1] == {}, f"the plain route launched {runs['plain'][1]}")
    ref = runs["plain"][0]
    rel = {route: {n: (x - ref[n]).abs().max().item() / ref[n].abs().max().item()
                   for n, x in runs[route][0].items()}
           for route in ("flash", "plain at batch 2", "faulty")}
    print(f"[guidance_1024] one guidance step through the full-width decoder at "
          f"{z.shape[1] * z.shape[2]} tokens, max err / max|plain route's| of the step and of "
          "the mid-block attention's dq, dk, dv: " + "; ".join(
              f"{route} " + ", ".join(f"{n} {e:.3e}" for n, e in r.items())
              for route, r in rel.items()) + f" (limit {GUIDED_GRAD_TOL:g})")
    check(all(e <= GUIDED_GRAD_TOL for e in rel["flash"].values()),
          f"the flash route's guidance gradient disagrees with the plain route's: {rel['flash']}")
    check(all(rel["faulty"][n] > GUIDED_GRAD_TOL for n in ("dk", "dv")),
          f"the limit does not catch a skipped kv tile: {rel['faulty']}")


def phase_guidance_1024(fa) -> dict:
    """[guidance_1024]: the CLI request with RGB guidance at 1024x1024
    (GUIDED_1024_PATHS: a 256x256 PNG at --upscale 4, untiled, --steps 2):
    exact launches (the wide backward once a guided decode at 16384 tokens),
    the PNG equal to pipeline.run's, a rerun bit-identical
    (``phase_cli_request``), the decoded image closer to the condition than
    the unguided request's on the same PNG and seed, the guidance gradient
    on both routes (``guidance_gradient``), and the peak memory beside the
    same request with the plain route forced (its launches: the unguided
    request's). Returns the guided request's launches."""
    import numpy as np
    import torch

    from diffbir_tpu_torch.ops import attention as attention_mod

    launches0, _, rec0 = cli_once("cli_unguided_1024", STEPS_FLAG)
    check(launches0 == GUIDED_1024_PLAIN, f"cli_unguided_1024 launched {launches0}")
    with recording_vae() as rec:
        launches, info = phase_cli_request(
            GUIDED_1024, GUIDED_1024_PATHS[GUIDED_1024],
            with_loop=lambda loop: guidance_gradient(fa, loop))
    d = torch.mean((rec["x"] - rec["image"]) ** 2).item()
    d0 = torch.mean((rec0["x"] - rec0["image"]) ** 2).item()
    print(f"[guidance_1024] mean squared distance of the decoded image to the condition image "
          f"{d:.6f}, the unguided request's {d0:.6f}")
    check(d < d0, f"{GUIDED_1024}: guidance did not move the image toward its target "
          f"({d} >= {d0})")
    threshold = attention_mod.FLASH_MIN_WIDE_GRAD
    attention_mod.FLASH_MIN_WIDE_GRAD = 2**31
    try:
        launches_p, info_p, _ = cli_once(GUIDED_1024 + "_plain", GUIDED_1024_FLAGS)
    finally:
        attention_mod.FLASH_MIN_WIDE_GRAD = threshold
    check(launches_p == GUIDED_1024_PLAIN, f"the plain route launched {launches_p}")
    diff = np.abs(info_p["png"].astype(int) - info["png"].astype(int))
    print(f"[guidance_1024] peak device memory: flash route {info['peak']:.3f} GiB, plain route "
          f"forced {info_p['peak']:.3f} GiB ({CARD[0]}); request {info['seconds']:.3f} s against "
          f"{info_p['seconds']:.3f} s; the two PNGs (not gated): max {diff.max()} uint8 levels, "
          f"{float((diff > 4).mean()):.4%} of values more than 4 apart")
    return {GUIDED_1024: launches}


def phase_turbo_model(cldm):
    """[turbo], at the model call: through each sampler that takes the turbo
    model function, TURBO_SAMPLER_STEPS steps at SAMPLER_SIZE on the default
    prompts' hoisted tables, the cached model at interval 1 gives the plain
    model function's output bit for bit, with and without the encoder
    cache; at interval 2 it does not."""
    import torch

    from diffbir_tpu_torch.pipeline import TURBO_SAMPLERS, build_sampler, model_function
    from diffbir_tpu_torch.profile_step import NEG_PROMPT, POS_PROMPT, stand_in_tokenizer
    from diffbir_tpu_torch.schedule import Schedule

    tokenizer = stand_in_tokenizer()
    gen = torch.Generator(device="cuda").manual_seed(21)
    lat = SAMPLER_SIZE // 8
    with torch.no_grad():
        img = torch.rand(1, SAMPLER_SIZE, SAMPLER_SIZE, 3, generator=gen, device="cuda")
        pos, neg = (torch.as_tensor(tokenizer([t]), device="cuda")
                    for t in (POS_PROMPT, NEG_PROMPT))
        cond = cldm.prepare_condition(img, pos)
        uncond = {"c_txt": cldm.encode_text(neg), "c_img": cond["c_img"]}
    x_T = torch.randn(1, lat, lat, 4, generator=gen, device="cuda")
    table = torch.randn(TURBO_SAMPLER_STEPS, *x_T.shape, generator=gen, device="cuda")
    for name in TURBO_SAMPLERS:
        sampler = build_sampler(name, Schedule.v21(), False, eta=1.0)
        tables = cldm.make_hoist_tables(torch.cat([cond["c_txt"], uncond["c_txt"]]),
                                        sampler.model_ts(TURBO_SAMPLER_STEPS))

        def sample(model_fn):
            kw = ({} if name == "ddim" else {"noise_table": table})
            return sampler.sample(model_fn, x_T, cond, uncond, CFG, TURBO_SAMPLER_STEPS, **kw)

        plain = sample(model_function(cldm, 1.0, tables))
        same = [torch.equal(sample(cldm.make_cached_control_model(1.0, 1, enc, tables)), plain)
                for enc in (False, True)]
        moved = not torch.equal(sample(cldm.make_cached_control_model(1.0, 2, False, tables)),
                                plain)
        print(f"[turbo] {name}, {TURBO_SAMPLER_STEPS} steps at {SAMPLER_SIZE}x{SAMPLER_SIZE}: "
              f"interval 1 bit-equal to the plain model function: {same[0]} (control cached), "
              f"{same[1]} (control and UNet encoder); interval 2 moves off it: {moved}")
        check(all(same) and moved, f"[turbo] {name}: interval 1 {same}, interval 2 moved {moved}")
        torch.cuda.empty_cache()


def phase_turbo_cli(baseline: dict) -> dict:
    """[turbo], at the CLI: each request of TURBO_PATHS (``phase_cli_request``:
    exact launches from the site tables, the PNG equal to pipeline.run's, a
    rerun bit-identical), its PSNR and SSIM against the interval-1 request's
    PNG (``baseline``: the default [cli_request], or the int8 one; reported,
    not gated: the weights are random) and its request and denoise seconds
    beside that request's, in a fresh process and in the rerun of its loop;
    then --control_interval 2 with --cldm_tiled must raise ValueError.
    Returns each path's launch counts."""
    import torch

    from diffbir_tpu_torch.utils.common import psnr, ssim

    def image(png):
        return torch.as_tensor(png, dtype=torch.float32)[None] / 255.0

    paths = {}
    for path, spec in TURBO_PATHS.items():
        paths[path], info = phase_cli_request(path, spec)
        ref = baseline["cli_request_int8" if "int8" in path else "cli_request"]
        a, b = image(info["png"]), image(ref["png"])
        print(f"[turbo] {path} ({' '.join(spec[1])}): against interval 1, PSNR "
              f"{psnr(a, b).item():.2f} dB, SSIM {ssim(a, b).item():.4f}; request "
              f"{info['seconds']:.3f} s (denoise {info['stages']['denoise']:.3f} s) against "
              f"{ref['seconds']:.3f} s (denoise {ref['stages']['denoise']:.3f} s); rerun "
              f"{info['rerun_seconds']:.3f} s (denoise {info['rerun_stages']['denoise']:.3f} s) "
              f"against {ref['rerun_seconds']:.3f} s (denoise "
              f"{ref['rerun_stages']['denoise']:.3f} s)")
    cli_refuses("turbo", ["--control_interval", "2", "--cldm_tiled"], ValueError, "cldm_tiled")
    return paths


def phase_fast_gelu(cldm):
    """[fast_gelu], at the model call (batch 2, a 64x64 latent, the default
    prompts' context): the tanh GELU within MODEL_REL_TOL of exact erf and
    not equal to it; under --fused_ffn (the "fused" mode) --fast_gelu leaves
    the call bit-equal and K7's launches unchanged (K7 keeps erf)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(31)
    x, c_img = (torch.randn(2, 64, 64, 4, generator=gen, device="cuda") for _ in range(2))
    t = torch.tensor([999.0, 500.0], device="cuda")
    ctx = default_prompt_context(cldm)
    cond = {"c_txt": ctx, "c_img": c_img}

    def call(**flags):
        cldm.set_serving(**flags)
        before = counts()
        with torch.no_grad():
            out = cldm(x, t, cond).float()
        torch.cuda.synchronize()
        return out, launched_since(before)

    exact, n_exact = call()
    fast, n_fast = call(fast_gelu=True)
    rel = ((fast - exact).abs().max() / exact.abs().max()).item()
    print(f"[fast_gelu] model call [2,64,64,4]: tanh GELU against exact erf, relative max err "
          f"{rel:.3e} (tol {MODEL_REL_TOL:g}); launches {n_fast} (erf: {n_exact})")
    check(0 < rel <= MODEL_REL_TOL and n_fast == n_exact,
          f"[fast_gelu] the tanh GELU: rel err {rel}, launches {n_fast} vs {n_exact}")
    fused, n_fused = call(fused_resblock=True, fused_ffn=True)
    fused_fast, n_fused_fast = call(fused_resblock=True, fused_ffn=True, fast_gelu=True)
    print(f"[fast_gelu] --fused_ffn --fast_gelu against --fused_ffn: bit-equal "
          f"{torch.equal(fused, fused_fast)}; launches {n_fused_fast} (without: {n_fused})")
    check(torch.equal(fused, fused_fast) and n_fused == n_fused_fast
          and n_fused.get("K7") == K7_PER_CALL, "[fast_gelu] --fused_ffn does not keep erf")
    cldm.set_mode("default")


def blend_weights(n: int):
    """The reference's Gaussian tile weights [n, n] (variance 0.01 of the
    tile; columns centred at (n - 1) / 2, rows at n / 2), written out here
    apart from the port's ``tiling.gaussian_weights``."""
    import math

    import torch

    i = torch.arange(n, dtype=torch.float64)

    def bump(mid):
        return torch.exp(-((i - mid) ** 2) / (n * n) / 0.02) / math.sqrt(2 * math.pi * 0.01)

    return torch.outer(bump(n / 2), bump((n - 1) / 2)).float()


def per_tile_loop(cldm, x, t, cond, tile, starts):
    """The tiled diffusion's model call written out: one model call per
    ``tile`` latent tile at ``starts`` x ``starts``, its hint sliced by
    hand, and a Gaussian accumulation of its own."""
    import torch

    w = blend_weights(tile).to(x.device)[None, :, :, None]
    acc = torch.zeros(x.shape, device=x.device)
    wsum = torch.zeros(1, x.shape[1], x.shape[2], 1, device=x.device)
    tv = torch.full((x.shape[0],), t, device=x.device)
    for hi in starts:
        for wi in starts:
            hint = cond["c_img"][:, hi: hi + tile, wi: wi + tile].contiguous()
            o = cldm(x[:, hi: hi + tile, wi: wi + tile].contiguous(), tv,
                     {"c_txt": cond["c_txt"], "c_img": hint}).float()
            acc[:, hi: hi + tile, wi: wi + tile] += o * w
            wsum[:, hi: hi + tile, wi: wi + tile] += w
    return acc / wsum


def phase_tiled_model_call(cldm):
    """[tiled_request] the tiled diffusion's model call at full width: one
    denoise step on a 128x128 latent (batch 2, folded CFG on the default
    prompts, t = 999) at each seed of TILED_CALL_SEEDS, through the
    pipeline's ``tiled_model_function`` against ``per_tile_loop`` (one call
    per 64x64 tile at stride 32): at tiles_per_batch 3 (three calls at
    batch 6, whose rows a cuDNN convolution rounds by their batch position,
    see TILED_CALL_TOL) within TILED_CALL_TOL x max|ref|; at tiles_per_batch 1 (the loop's own
    calls; only the blend's fp32 sums differ) within FP32_TOL x max|ref|.
    Each tile's rows of one three-tile call must equal, bit for bit, the
    same rows of a call that repeats that tile (no op reads across the
    batch). A planted fault (every tile handed tile 0's hint) must fail the
    limit and the bit-for-bit check."""
    import torch

    from diffbir_tpu_torch.pipeline import tile_model_function, tiled_model_function
    from diffbir_tpu_torch.tiling import make_tiled_fn

    lat, tile, stride, per = TILED_SIZE // 8, 64, 32, 3
    t = 999.0
    starts = range(0, lat - tile + 1, stride)
    check((lat - tile) % stride == 0 and len(starts) ** 2 == CLDM_TILES, "tile geometry")
    for seed in TILED_CALL_SEEDS:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(2, lat, lat, 4, generator=gen, device="cuda")
        cond = {"c_txt": default_prompt_context(cldm),
                "c_img": torch.randn(2, lat, lat, 4, generator=gen, device="cuda")}
        with torch.no_grad():
            before = counts()
            out = tiled_model_function(cldm, 1.0, 8 * tile, 8 * stride, tiles_per_batch=per)(
                x, t, cond)
            torch.cuda.synchronize()
            n = launched_since(before)
            out1 = tiled_model_function(cldm, 1.0, 8 * tile, 8 * stride)(x, t, cond)
            ref = per_tile_loop(cldm, x, t, cond, tile, starts)
        print(f"[tiled_request] model call over {CLDM_TILES} latent tiles, seed {seed}: at "
              f"tiles_per_batch {per} launches {n}, against the per-tile loop "
              f"{show(out, ref, TILED_CALL_TOL)}; at tiles_per_batch 1 "
              f"{show(out1, ref, FP32_TOL)}")
        check(n == {"K1": per * K1_SITES_PER_STEP}, f"the tiled model call launched {n}")
        check(bool(torch.isfinite(out).all()), "the tiled model call: non-finite output")
        hold("the tiled model call", out, ref, TILED_CALL_TOL)
        hold("the tiled model call at tiles_per_batch 1", out1, ref, FP32_TOL)
    model_tile = tile_model_function(cldm, 1.0, tile)
    corners = [(hi, wi) for hi in starts for wi in starts][:per]

    def group(cs, hints=None):
        tiles = torch.cat([x[:, hi: hi + tile, wi: wi + tile] for hi, wi in cs])
        with torch.no_grad():
            return model_tile(tiles, t, cond, tile_coords=tuple(hints or cs))

    mixed = group(corners)
    for j, corner in enumerate(corners):
        check(torch.equal(mixed[2 * j: 2 * j + 2], group([corner] * per)[2 * j: 2 * j + 2]),
              f"the tiled model call: tile {j}'s rows differ from a call that repeats it")
    faulty = group(corners, hints=[corners[0]] * per)
    check(not torch.equal(faulty[2: 4], mixed[2: 4]), "the bit-for-bit check misses tile 0's "
          "hint handed to tile 1")
    print(f"[tiled_request] model call of tiles {corners}: each tile's rows bit-equal to a "
          f"call that repeats that tile (batch {2 * per}, same position); with tile 0's hint "
          f"handed to every tile, tile 1's rows differ")

    def tile_zero_hint(x_tiles, t, c, tile_coords=()):
        return model_tile(x_tiles, t, c, tile_coords=((0, 0),) * len(tile_coords))

    with torch.no_grad():
        faulty = make_tiled_fn(tile_zero_hint, tile, stride, channel=4, tiles_per_batch=per)(
            x, t, cond)
    planted("tiled_request model call, every tile handed tile 0's hint", faulty, ref,
            TILED_CALL_TOL)


def phase_sync_gn_decode(cldm):
    """[tiled_request] the seam-free tiled decode at full width:
    ``cldm._vae_decode_sync`` on a 128x128 latent (tile 32, halo 11: 16
    tiles of 54x54), streamed 2 tiles at a time, against the full-width
    ``Decoder(gn_cross=True)`` on the 16 tiles stacked at once (tiles cut
    and stitched here), within BF16_TOL x max|ref|; the latent carries
    ramps, so its tiles differ in their statistics. A planted fault (the
    same tiles through the Decoder with per-tile GroupNorm statistics) must
    fail the limit."""
    import torch
    import torch.nn.functional as F

    from diffbir_tpu_torch.models.vae import Decoder

    lat, ts, halo = TILED_SIZE // 8, 32, 11
    gen = torch.Generator(device="cuda").manual_seed(17)
    ramp = torch.linspace(-1.0, 1.0, lat, device="cuda")
    z = (0.5 * torch.randn(1, lat, lat, 4, generator=gen, device="cuda")
         + ramp[None, :, None, None] + torch.stack([ramp, -ramp, ramp, -ramp], -1)[None, None])
    cross = Decoder(dtype=torch.bfloat16, device="meta", gn_cross=True).to_empty(device="cuda")
    cross.load_state_dict(cldm.vae.decoder.state_dict())
    span = ts + 2 * halo
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cldm._vae_decode_sync(z, ts, chunk=2)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        zp = F.pad(z.permute(0, 3, 1, 2) / cldm.scale_factor, (halo,) * 4, mode="replicate")
        corners = [(i, j) for i in range(0, lat, ts) for j in range(0, lat, ts)]
        tiles = cldm.vae.post_quant_conv(
            torch.cat([zp[:, :, i: i + span, j: j + span] for i, j in corners]))

        def stitched(decoder):
            dec = decoder(tiles)
            img = torch.empty(1, 3, 8 * lat, 8 * lat, device="cuda")
            for n_tile, (i, j) in enumerate(corners):
                img[:, :, 8 * i: 8 * (i + ts), 8 * j: 8 * (j + ts)] = \
                    dec[n_tile, :, 8 * halo: 8 * (halo + ts), 8 * halo: 8 * (halo + ts)]
            return img.permute(0, 2, 3, 1)

        ref = stitched(cross)
        faulty = stitched(cldm.vae.decoder)
    del cross
    torch.cuda.empty_cache()
    print(f"[tiled_request] sync_gn decode of a {lat}x{lat} latent ({len(corners)} tiles of "
          f"{span}x{span}, 2 at a time): {dt:.3f} s; against Decoder(gn_cross=True) on the "
          f"stacked tiles {show(out, ref)}")
    check(out.shape == (1, 8 * lat, 8 * lat, 3) and bool(torch.isfinite(out).all()),
          f"sync_gn decode: bad output {tuple(out.shape)}")
    hold("the streamed sync_gn decode", out, ref, BF16_TOL)
    planted("tiled_request decode, per-tile GroupNorm statistics", faulty, ref, BF16_TOL)


def peak_above_resident(fn):
    """(fn's result, GiB of device memory its run peaked at above what was
    allocated before it), or (None, None) when the card's memory ran out."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None, None
    return out, (torch.cuda.max_memory_allocated() - base) / 2**30


def phase_sync_gn_memory(cldm):
    """[tiled_request] what streaming saves the sync_gn VAE: the peak device
    memory above the resident of ``cldm._vae_decode_sync`` and
    ``_vae_encode_sync`` (streamed, their default chunk of 8 tiles; the
    pipeline's tiles: 32 latent pixels + an 11-pixel halo, 256 image pixels
    + a 32-pixel halo) against ``Decoder`` / ``Encoder(gn_cross=True)`` on
    all the same halo tiles at once, at each output size of SYNC_GN_SIZES.
    The streamed peak must lie below the stacked one (a stacked run that
    exhausts the card counts as above); the stacked outputs are held to
    the streamed ones within BF16_TOL x max|ref|."""
    import torch

    from diffbir_tpu_torch.models.cldm import _halo_tiles
    from diffbir_tpu_torch.models.vae import Decoder, Encoder

    dec = Decoder(dtype=torch.bfloat16, device="meta", gn_cross=True).to_empty(device="cuda")
    dec.load_state_dict(cldm.vae.decoder.state_dict())
    enc = Encoder(dtype=torch.bfloat16, device="meta", gn_cross=True).to_empty(device="cuda")
    enc.load_state_dict(cldm.vae.encoder.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(19)

    def stacked_moments(h):
        mean, logvar = cldm.vae.quant_conv(h).chunk(2, dim=1)
        return torch.cat([mean, logvar.clamp(-30.0, 20.0)], dim=1)

    for size in SYNC_GN_SIZES:
        lat = size // 8
        z = torch.randn(1, lat, lat, 4, generator=gen, device="cuda")
        img = torch.rand(1, size, size, 3, generator=gen, device="cuda") * 2 - 1
        z_tiles = _halo_tiles(z, 32, 11)[0].permute(0, 3, 1, 2) / cldm.scale_factor
        img_tiles = _halo_tiles(img, 256, 32)[0].permute(0, 3, 1, 2)
        n_dec, n_enc = z_tiles.shape[0], img_tiles.shape[0]
        line = []
        for what, streamed, stacked in (
                (f"decode ({n_dec} tiles of 54^2 latents)",
                 lambda: cldm._vae_decode_sync(z, 32),
                 lambda: dec(cldm.vae.post_quant_conv(z_tiles))[:, :, 88: 344, 88: 344]),
                (f"encode ({n_enc} tiles of 320^2 pixels)",
                 lambda: torch.cat(cldm._vae_encode_sync(img, 256), dim=-1),
                 lambda: stacked_moments(enc(img_tiles))[:, :, 4: 36, 4: 36])):
            out, gib = peak_above_resident(streamed)
            check(gib is not None, f"sync_gn {what} at {size}^2 streamed: out of memory")
            ref, gib_stacked = peak_above_resident(stacked)
            line.append(f"{what}: streamed {gib:.3f} GiB, stacked " + (
                "out of memory" if gib_stacked is None else f"{gib_stacked:.3f} GiB"))
            check(gib_stacked is None or gib < gib_stacked,
                  f"sync_gn {what} at {size}^2: streamed {gib} GiB, not below stacked "
                  f"{gib_stacked} GiB")
            if ref is not None:
                # the tiles' centres, tile-major, against the stitched stream
                tiles = out.reshape(1, size // 256, ref.shape[2], -1, ref.shape[3], ref.shape[1])
                tiles = tiles.permute(0, 1, 3, 5, 2, 4).reshape(ref.shape)
                hold(f"sync_gn {what} at {size}^2, streamed against stacked", tiles, ref,
                     BF16_TOL)
            del out, ref
        print(f"[tiled_request] sync_gn VAE at {size}x{size}, peak memory above the "
              f"resident: " + "; ".join(line))
    del dec, enc
    torch.cuda.empty_cache()


def phase_tiled_request():
    """[tiled_request]: the CLI in process on a seeded 256x256 PNG at
    --upscale 4 (a 1024x1024 condition), random full-width weights, the
    CLI's defaults but TILED_STEPS steps, in the variants of TILED_VARIANTS:
    (a) every tiling
    (run twice: the rerun must be bit-identical), (b) a with 3 latent tiles
    a model call, (c) a with the sync_gn VAE, (d) the diffusion tiled alone,
    (e) untiled, (f) b with the int8 flags. Per variant: exact launches,
    seconds per stage, peak device memory (a below e) and the PNG's size.
    Returns the launch counts of each variant's run."""
    import shutil

    import numpy as np
    import torch

    from diffbir_tpu_torch.inference.__main__ import main
    from diffbir_tpu_torch.utils.image_io import read_png, write_png

    root = os.path.join("build", "tiled_request")
    shutil.rmtree(root, ignore_errors=True)
    in_dir = os.path.join(root, "in")
    os.makedirs(in_dir)
    write_png(os.path.join(in_dir, "lq.png"), np.random.default_rng(17).integers(
        0, 256, (TILED_LQ, TILED_LQ, 3), dtype=np.uint8))
    paths, peaks, outs = {}, {}, {}
    with cli_environment(root):
        for name, (flags, expected) in TILED_VARIANTS.items():
            path = f"tiled_{name}"
            out_dir = os.path.join(root, f"out_{name}")
            argv = ["--task", "sr", "--input", in_dir, "--output", out_dir,
                    "--upscale", str(CLI_UPSCALE), *flags]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()  # count only this path from here
            t0 = time.perf_counter()
            loop = main(argv)
            dt = time.perf_counter() - t0
            paths[path] = counts()
            n = {k: v for k, v in paths[path].items() if v}
            peaks[name] = torch.cuda.max_memory_allocated() / 2**30
            out = outs[name] = read_png(os.path.join(out_dir, "lq.png"))
            print(f"[tiled_request] {name}: {' '.join(flags)}: {dt:.3f} s "
                  f"({stages(loop.timings)} s); launches "
                  + ", ".join(f"{k} {v}" for k, v in n.items())
                  + f"; peak device memory {peaks[name]:.3f} GiB; PNG "
                  f"{out.shape[1]}x{out.shape[0]}")
            check(out.shape == (TILED_SIZE, TILED_SIZE, 3) and float(out.std()) > 1.0,
                  f"{path}: bad output {out.shape}, std {out.std()}")
            check(n == expected, f"{path}: expected launches {expected}, got {n}")
            check(peaks[name] > 0.0, f"{path}: no peak memory reading")
            if name == "a":
                loop.timings = {}
                before = counts()
                t1 = time.perf_counter()
                loop.run()
                dt2 = time.perf_counter() - t1
                check(launched_since(before) == expected, f"{path}: the rerun launched another "
                      "count")
                check(np.array_equal(read_png(os.path.join(out_dir, "lq.png")), out),
                      f"{path}: the rerun differs")
                print(f"[tiled_request] a again (the loop rerun): {dt2:.3f} s "
                      f"({stages(loop.timings)} s), bit-identical")
            del loop
    torch.cuda.empty_cache()
    check(peaks["a"] < peaks["e"], f"the tiled request's peak memory {peaks['a']:.3f} GiB is "
          f"not below the untiled one's {peaks['e']:.3f} GiB")
    diff = np.abs(outs["a"].astype(int) - outs["b"].astype(int))
    print(f"[tiled_request] b against a (3 latent tiles a call against 1; not gated): max "
          f"{diff.max()} uint8 levels, {float((diff > 4).mean()):.4%} of values more than 4 "
          f"apart")
    return paths


def phase_samplers(cldm):
    """Every other sampler of the CLI: one 256x256 request's stage 2
    (``apply_cldm``, SAMPLER_STEPS steps, CFG 4.0, eta 1, the default
    prompts), twice from one seed: finite and bit-identical."""
    import torch

    from diffbir_tpu_torch.pipeline import SAMPLER_CHOICES, Pipeline
    from diffbir_tpu_torch.profile_step import NEG_PROMPT, POS_PROMPT, stand_in_tokenizer
    from diffbir_tpu_torch.schedule import Schedule

    pipe = Pipeline(cldm, Schedule.v21(), torch.device("cuda"), tokenizer=stand_in_tokenizer())
    gen = torch.Generator(device="cuda").manual_seed(9)
    cond_img = torch.rand(1, SAMPLER_SIZE, SAMPLER_SIZE, 3, generator=gen, device="cuda")
    for sampler in SAMPLER_CHOICES:
        if sampler == "edm_dpm++_3m_sde":
            continue  # the CLI requests run it
        outs = []
        for _ in range(2):
            before = counts()
            t0 = time.perf_counter()
            outs.append(pipe.apply_cldm(
                cond_img, SAMPLER_STEPS, 1.0, POS_PROMPT, NEG_PROMPT, CFG,
                sampler_type=sampler, eta=1.0, order=4,
                generator=torch.Generator(device="cuda").manual_seed(3)))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n = launched_since(before)
        check(set(n) == {"K1"} and n["K1"] % K1_SITES_PER_STEP == 0,
              f"[samplers] {sampler} launched {n}")
        check(bool(torch.isfinite(outs[0]).all()), f"[samplers] {sampler}: non-finite output")
        check(torch.equal(outs[0], outs[1]), f"[samplers] {sampler}: a rerun differs")
        print(f"[samplers] {sampler}: {SAMPLER_STEPS} steps at {SAMPLER_SIZE}x{SAMPLER_SIZE}, "
              f"{n['K1'] // K1_SITES_PER_STEP} model calls, {dt:.3f} s; finite, bit-identical "
              f"on a rerun")


# --------------------------------------------------------------------------- #
# the LLaVA-1.5-7B captioner: K5 at its shapes, then captions
# --------------------------------------------------------------------------- #
def swapped_groups(scale):
    """scale_g [K/128, N] with the two groups of every 256-row window
    swapped: K5 run on it is a group-index fault."""
    k2, n = scale.shape
    return scale.reshape(k2 // 2, 2, n).flip(1).reshape(k2, n).contiguous()


def k5_case(qm, gen, m, k, n, dtype, copies: int = 1):
    """x [m, k] and ``copies`` packed int4 weights [k, n] with their scales."""
    import torch

    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    weights = []
    for _ in range(copies):
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        weights.append(qm.quantize_weight_int4(w))
        del w
    return x, weights


def dequantised(qm, packed, scale):
    """The bf16 weight K5 multiplies by (the library call's operand)."""
    import torch

    k, n = 2 * packed.shape[0], packed.shape[1]
    return qm.unpack_int4(packed).reshape(k // 128, 128, n).float().mul_(
        scale[:, None]).reshape(k, n).to(torch.bfloat16)


def phase_k5(qm):
    """K5 against its plain version at the captioner's six shapes (bf16 x),
    ragged cases in each form and fp32 x, each on the entry that
    ``int4_entries`` names (by counter: the tensor-core tile form above 8
    rows, the GEMV form at 1 and 3), the CUDA-core entry K5_cc on the same
    inputs; device times of both (the GEMV form's over weights rotated past
    the L2 cache, as a decode step finds them) beside one host call, the
    plain version, the library call (x @ the dequantised bf16 weight) and the
    bound; a GEMV rerun must be bit-identical; the planted fault (the two
    scale groups of every window swapped) on both forms. Returns the kernel
    lines' numbers of K5 and K5_cc at the prefill shape (624, 4096, 4096)
    and of K5_gemv at the decode shape (1, 4096, 4096), timed as
    ``phase_k4``'s."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(6)
    shapes = [(m, k, n) for m in (CAPTION_ROWS, 1) for k, n in LLAVA_SITES]
    cases = ([(s, torch.bfloat16) for s in shapes] + [((77, 4096, 4001), torch.bfloat16),
             ((3, 4096, 4001), torch.bfloat16), ((CAPTION_ROWS, 4096, 4096), torch.float32),
             ((1, 4096, 4096), torch.float32)])
    max_err = dict.fromkeys(("K5", "K5_gemv", "K5_cc"), 0.0)
    numbers, times = {}, {"K5": {}, "K5_cc": {}}
    for (m, k, n), dtype in cases:
        gemv = m <= GEMV_MAX_ROWS
        copies = -(-2 * L2_BYTES // (k * n // 2)) if gemv else 1
        x, weights = k5_case(qm, gen, m, k, n, dtype, copies)
        packed, scale = weights[0]
        key = "K5_gemv" if gemv else "K5"
        label = f"({m}, {k}, {n}) {str(dtype)[6:]}"
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        check(KERNELS[key] is qm.int4_entries(x), f"int4_entries names another entry at {m} rows")
        before = counts()
        out = qm.quant_matmul_int4(x, packed, scale)
        moved = launched_since(before)
        check(moved == {key: 1}, f"K5 at {label} launched {moved}, expected {key} once")
        cc = qm.launch_int4(qm.KERNEL_INT4, x, packed, scale)
        ref = qm.quant_matmul_int4_ref(x, packed, scale)
        err = hold(f"{key} at {label}", out, ref, tol)
        err_cc = hold(f"K5_cc at {label}", cc, ref, tol)
        if gemv:
            check(torch.equal(out, qm.quant_matmul_int4(x, packed, scale)),
                  f"K5_gemv at {label}: a rerun differs")

        def entry(i):
            return qm.quant_matmul_int4(x, *weights[i % copies])

        ms = device_ms(entry)
        host_ms = median_ms(lambda: entry(0))
        cc_ms = device_ms(lambda i: qm.launch_int4(qm.KERNEL_INT4, x, *weights[i % copies]),
                          5 if m > GEMV_MAX_ROWS else 20)
        plain_ms = median_ms(lambda: qm.quant_matmul_int4_ref(x, packed, scale), 10)
        lib_copies = -(-2 * L2_BYTES // (2 * k * n)) if gemv else 1
        w_deq = [dequantised(qm, *weights[i]) for i in range(lib_copies)]
        xb = x.to(torch.bfloat16)
        lib_ms = device_ms(lambda i: xb @ w_deq[i % lib_copies])
        bms, by = gemm_bound(m, k, n, x, packed, scale, out)
        rate = (f"{nbytes(x, packed, scale, out) / ms / 1e9:.3f} TB/s" if gemv
                else f"{2e-9 * m * k * n / ms:.1f} TFLOP/s")
        print(f"[K5] (M, K, N) {label} ({key}): {show(out, ref, tol)}; K5_cc "
              f"{show(cc, ref, tol)}; device ms: {key} {ms:.4f} ({rate}; one host call "
              f"{host_ms:.4f}), K5_cc {cc_ms:.4f}, library (x @ dequantised bf16 W) "
              f"{lib_ms:.4f}; plain {plain_ms:.4f} ms; bound {bms:.4f} ms ({by})")
        if dtype == torch.bfloat16:
            max_err[key] = max(max_err[key], err)
            max_err["K5_cc"] = max(max_err["K5_cc"], err_cc)
            if (m, k, n) in shapes:
                times["K5"][(m, k, n)] = ms
                times["K5_cc"][(m, k, n)] = cc_ms
        if (m, k, n) in ((CAPTION_ROWS, 4096, 4096), (1, 4096, 4096)) and dtype == torch.bfloat16:
            planted(f"{key} at M = {m} with the scale groups of each window swapped",
                    qm.quant_matmul_int4(x, packed, swapped_groups(scale)), ref, tol)
            common = {"plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                      "library_ms": median_ms(lambda: xb @ w_deq[0]), "library_device_ms": lib_ms}
            numbers[key] = {"ms": host_ms, "device_ms": ms, **common}
            if not gemv:
                numbers["K5_cc"] = {"ms": median_ms(lambda: qm.launch_int4(
                    qm.KERNEL_INT4, x, packed, scale), 5), "device_ms": cc_ms, **common}
        del x, weights, packed, scale, w_deq, xb, out, cc, ref
    print(f"[K5] per int4 caption ({QUANT_PREFILL_PER_CAPTION} tile and "
          f"{QUANT_PER_CAPTION - QUANT_PREFILL_PER_CAPTION} GEMV launches), device time: "
          f"{per_caption_ms(times['K5']):.3f} ms (K5_cc {per_caption_ms(times['K5_cc']):.3f} ms)")
    for key in numbers:
        numbers[key]["max_abs_err"] = max_err[key]
    return numbers


def build_llava():
    """LLaVA-1.5-7B in bf16 with random weights from seed 0, generated on
    the card parameter by parameter (N(0, 1/fan_in), norms 1, biases 0);
    then an int4 and an int8 copy (``quantize_llama_`` in place)."""
    import copy

    import torch

    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.llava import Llava, quantize_llama_

    t0 = time.perf_counter()
    model = Llava.llava15_7b(dtype=torch.bfloat16, device="meta").to_empty(device="cuda")
    random_init_(model, torch.Generator(device="cuda").manual_seed(0)).eval()
    models = {"caption_bf16": model}
    for bits in (4, 8):
        models[f"caption_int{bits}"] = quantize_llama_(copy.deepcopy(model), bits)
    torch.cuda.synchronize()
    sizes = ", ".join(f"{path[8:]} {nbytes(*m.parameters(), *m.buffers()) / 2**30:.2f} GiB"
                      for path, m in models.items())
    n = sum(p.numel() for p in model.parameters())
    print(f"[llava] LLaVA-1.5-7B {n / 1e9:.3f} B params, random bf16 from seed 0, built, "
          f"copied and quantised in {time.perf_counter() - t0:.2f} s ({sizes})")
    return models


def caption_inputs():
    """The seeded 512x512 LQ and the stand-in prompt ids (BOS = 1 first)."""
    import numpy as np

    rng = np.random.default_rng(300)
    lq = rng.integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
    pre = [1] + rng.integers(3, 32000, CAPTION_PRE - 1).tolist()
    return lq, pre, rng.integers(3, 32000, CAPTION_POST).tolist()


class plain_products:
    """Within it, every K4 and K5 site of the port runs its plain version."""

    def __init__(self, qm):
        self.qm = qm

    def __enter__(self):
        self.saved = self.qm.quant_matmul, self.qm.quant_matmul_int4
        self.qm.quant_matmul = self.qm.quant_matmul_ref
        self.qm.quant_matmul_int4 = self.qm.quant_matmul_int4_ref

    def __exit__(self, *exc):
        self.qm.quant_matmul, self.qm.quant_matmul_int4 = self.saved


def teacher_forced(path, qm, cap, lq, tokens, step_logits, float_lm):
    """The generated ids through the same model on the plain products in one
    prefill: logits at the 60 generated positions against the kernel path's
    within CAPTION_REL_TOL x max|plain logits|, and each id equal to the
    plain argmax wherever the plain top-2 margin exceeds that limit. The
    float model (``float_lm``) on the same ids must fail the limit in the
    int4 mode."""
    import torch

    lm = cap.model.language_model
    with torch.no_grad(), plain_products(qm):
        embeds = cap.prompt_embeds(lq)
        seq = torch.cat([embeds, lm.model.embed_tokens(tokens[:, :-1])], dim=1)
        plain = lm(seq)[0, embeds.shape[1] - 1:].float()
        unquantised = float_lm(seq)[0, embeds.shape[1] - 1:].float()
    kernel = torch.cat(step_logits).float()
    limit = CAPTION_REL_TOL * plain.abs().max().item()
    err = (kernel - plain).abs().max().item()
    err_float = (unquantised - plain).abs().max().item()
    top2 = plain.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > limit
    same = bool(torch.equal(tokens[0][clear], plain.argmax(-1)[clear]))
    agree = int((tokens[0] == plain.argmax(-1)).sum())
    print(f"[{path}] teacher forcing on the plain products: logits max err {err:.3e}, limit "
          f"{limit:.3e} ({CAPTION_REL_TOL:g} x max|plain|); ids equal to the plain argmax at "
          f"{agree}/{CAPTION_NEW} positions, at all {int(clear.sum())} with a top-2 margin above "
          f"the limit: {same}; the float model on the same ids: max err {err_float:.3e} "
          f"({err_float / limit:.1f} x the limit)")
    check(err <= limit, f"{path}: kernel logits disagree with the plain products: {err} > {limit}")
    check(same, f"{path}: an id differs from the plain argmax where the margin is clear")
    if path == "caption_int4":
        check(err_float > limit, f"the limit does not see int4 quantisation: {err_float} <= {limit}")


def phase_caption(path, qm, model, lq, pre, post, float_lm):
    """One caption of the LQ in one mode (after a warm-up caption): launch
    counts, stage times, tokens/s, memory; teacher forcing for the quantised
    modes. Returns (launch counts, ids)."""
    import torch

    from diffbir_tpu_torch.captioners.llava import LLaVACaptioner

    cap = LLaVACaptioner(model, pre, post, max_new_tokens=CAPTION_NEW, eos_id=NEVER_EOS)
    cap.generate(lq[0])  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    timings, step_logits = {}, []
    reset_counts()  # count only this caption from here
    t0 = time.perf_counter()
    tokens = cap.generate(lq[0], timings=timings, step_logits=step_logits)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counts()
    ran = {k: v for k, v in launches.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    weights = nbytes(*model.parameters(), *model.buffers()) / 2**30
    steps = timings["decode_steps"]
    print(f"[{path}] caption {dt:.3f} s: vision {1e3 * timings['vision']:.2f} ms, prefill "
          f"({CAPTION_ROWS} rows) {1e3 * timings['prefill']:.2f} ms, decode "
          f"{1e3 * timings['decode'] / steps:.3f} ms per token over {steps} steps; "
          f"{CAPTION_NEW / (timings['prefill'] + timings['decode']):.2f} tokens/s after the "
          f"tower; device memory: this mode's weights {weights:.2f} GiB + the caption's "
          f"{peak - resident:.2f} GiB above what was resident ({resident:.2f} GiB, every mode's "
          f"model and the SD models), peak {peak:.2f} GiB; launches "
          + ", ".join(f"{k} {v}" for k, v in ran.items()))
    check(steps == CAPTION_NEW - 1, f"{path}: {steps} decode steps")
    check(ran == CAPTION_PATHS[path], f"{path}: expected launches {CAPTION_PATHS[path]}, got {ran}")
    check(tokens.shape == (1, CAPTION_NEW) and int(tokens.min()) >= 0
          and int(tokens.max()) < 32000, f"{path}: bad ids {tokens}")
    check(all(bool(torch.isfinite(lg).all()) for lg in step_logits), f"{path}: non-finite logits")
    print(f"[{path}] ids {tokens[0].tolist()}")
    if path != "caption_bf16":
        teacher_forced(path, qm, cap, lq[0], tokens, step_logits, float_lm)
    return launches, tokens


def phase_captioned_request(model, cldm, swinir, lq, pre, post):
    """The int4 caption of the LQ, then the default SwinIRPipeline.run on the
    same LQ, both models resident. The caption's ids, written as text, are
    the positive prompt (through the stand-in tokenizer: the caption cannot
    be detokenised and tokenised for CLIP without the two vocabularies), the
    CLI's default the negative one."""
    import numpy as np
    import torch

    from diffbir_tpu_torch.captioners.llava import LLaVACaptioner
    from diffbir_tpu_torch.pipeline import SwinIRPipeline
    from diffbir_tpu_torch.profile_step import NEG_PROMPT, stand_in_tokenizer
    from diffbir_tpu_torch.schedule import Schedule

    cap = LLaVACaptioner(model, pre, post, max_new_tokens=CAPTION_NEW, eos_id=NEVER_EOS)
    pipe = SwinIRPipeline(swinir, cldm, Schedule.v21(), torch.device("cuda"),
                          tokenizer=stand_in_tokenizer())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # count only this request from here
    t0 = time.perf_counter()
    ids = cap(lq[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    timings = {}
    out = pipe.run(lq, steps=STEPS, cfg_scale=CFG, seed=1, timings=timings,
                   pos_prompt=" ".join(map(str, ids)), neg_prompt=NEG_PROMPT)
    t2 = time.perf_counter()
    launches = counts()
    ran = {k: v for k, v in launches.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[captioned_request] caption {t1 - t0:.3f} s ({len(ids)} ids), restore "
          f"{t2 - t1:.3f} s, total {t2 - t0:.3f} s; peak device memory {peak:.2f} GiB; "
          f"launches " + ", ".join(f"{k} {v}" for k, v in ran.items()))
    print(f"[captioned_request] caption ids {ids}")
    check(ran == CAPTION_PATHS["captioned_request"],
          f"captioned_request: expected launches {CAPTION_PATHS['captioned_request']}, got {ran}")
    check(len(ids) == CAPTION_NEW, f"captioned_request: {len(ids)} ids")
    check(out.shape == (1, SIZE, SIZE, 3) and out.dtype == np.uint8 and float(out.std()) > 1.0,
          f"captioned_request: bad output {out.shape} {out.dtype}")
    return launches


def phase_llava(qm, cldm, swinir):
    """The three caption modes and the captioned request; returns {path:
    launch counts}."""
    import torch

    models = build_llava()
    lq, pre, post = caption_inputs()
    launches, ids = {}, {}
    for path in ("caption_int4", "caption_int8", "caption_bf16"):
        launches[path], ids[path] = phase_caption(path, qm, models[path], lq, pre, post,
                                                  models["caption_bf16"].language_model)
    same = {p: int((ids[p] == ids["caption_bf16"]).sum()) for p in ("caption_int4", "caption_int8")}
    print(f"[llava] ids equal to the bf16 caption's: int4 {same['caption_int4']}/{CAPTION_NEW}, "
          f"int8 {same['caption_int8']}/{CAPTION_NEW} (random weights: no quality claim)")
    del models["caption_int8"], models["caption_bf16"]
    torch.cuda.empty_cache()
    launches["captioned_request"] = phase_captioned_request(
        models["caption_int4"], cldm, swinir, lq, pre, post)
    return launches



# --------------------------------------------------------------------------- #
# the unaligned face path and the serving front ends
# --------------------------------------------------------------------------- #
# RetinaFace against the same module on the CPU at fp32. cuDNN's default
# TF32 rounds each convolution's operands to 10 mantissa bits (~5e-4 of a
# product); through the ~70 convolutions of a random ResNet-50 + FPN + SSH
# the outputs drift by up to ~1e-2 of the largest: the limit is 5e-2. With
# TF32 off both sides are fp32 sums in another order: 1e-3. The helper's
# Gaussian blur on the card against the CPU: BLUR_TOL, the limit the CPU
# tests hold it to against cv2.
TF32_TOL, FACE_FP32_TOL, BLUR_TOL = 5e-2, 1e-3, 1e-5
DETECT_SIZE, PARSE_SIZE = 640, 512
# [cli_unaligned_face]: a seeded 256x256 PNG at --upscale 2 (512x512), two
# faces fixed through the loop's face_helper hook: three 512x512 stage-2
# requests (two face crops, the background), each K1 230 + K1_wide 2.
UNALIGNED_LQ, UNALIGNED_UPSCALE, UNALIGNED_FACES = 256, 2, 2
UNALIGNED = {"K1": (UNALIGNED_FACES + 1) * K1_SITES_PER_STEP * CLI_STEPS,
             "K1_wide": (UNALIGNED_FACES + 1) * K1_WIDE_PER_REQUEST}
# [http_serve]: the v2.1 sr pipeline behind serve.BatchingServer at --upscale 4
# on 128x128 PNGs (512x512 conditions, 10 steps of the default sampler): a
# batch of any size is one pipeline call, K1 230 + K1_wide 2.
SERVE_BATCH, SERVE_LATENCY_ROUNDS = 4, 2


def card() -> str:
    return f"[{CARD[0] if CARD else 'card not read'}]"


def face_weights_file(module, path: str) -> None:
    """``module``'s weights in facexlib's layout: ``module.`` prefixes and
    every BatchNorm's ``num_batches_tracked``, as the published files."""
    import torch

    sd = {}
    for k, v in module.state_dict().items():
        sd["module." + k] = v.detach().cpu().clone()
        if k.endswith("running_var"):
            sd["module." + k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    torch.save(sd, path)


def random_face_models(seed: int):
    """A full-width RetinaFace (heads scaled by 1/20, so that scores and
    boxes fall in a detector's range) and ParseNet with seeded random
    weights (``random_init_``: the BatchNorms at identity), on the card."""
    import torch

    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.parsenet import ParseNet
    from diffbir_tpu_torch.models.retinaface import RetinaFace

    gen = torch.Generator(device="cuda").manual_seed(seed)
    det = random_init_(RetinaFace(device="cuda"), gen).eval()
    with torch.no_grad():
        for heads in (det.BboxHead, det.ClassHead, det.LandmarkHead):
            for h in heads:
                h.conv1x1.weight.div_(20)
                h.conv1x1.bias.div_(20)
    parse = random_init_(ParseNet(device="cuda"), gen).eval()
    return det, parse


def against_cpu(label: str, module, x, tol_tf32: float, tol_fp32: float) -> dict:
    """``module``'s outputs on ``x`` on the card, with cuDNN's TF32 on (a
    process's default) and off, each against the same module on the CPU at
    fp32 (limits tol x max|ref|); returns {"tf32": err, "fp32": err}."""
    import copy

    import torch

    with torch.no_grad():
        refs = module_outputs(copy.deepcopy(module).cpu(), x.cpu())
        errs = {}
        for mode, tol in (("tf32", tol_tf32), ("fp32", tol_fp32)):
            torch.backends.cudnn.allow_tf32 = mode == "tf32"
            outs = module_outputs(module, x)
            err = max(float((o.cpu() - r).abs().max() / r.abs().max()) for o, r in
                      zip(outs, refs))
            errs[mode] = err
            check(all(bool(torch.isfinite(o).all()) for o in outs), f"{label}: non-finite")
            check(err <= tol, f"{label} ({mode}) against the CPU: {err:.3e} x max|ref| > {tol}")
        torch.backends.cudnn.allow_tf32 = False
    print(f"[{label}] against the same module on the CPU at fp32: cuDNN TF32 on (the "
          f"default) {errs['tf32']:.3e} x max|ref| (limit {tol_tf32:g}: TF32 rounds conv "
          f"operands to 10 mantissa bits), TF32 off {errs['fp32']:.3e} (limit {tol_fp32:g})")
    return errs


def module_outputs(module, x):
    out = module(x)
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def phase_face_detect(det) -> None:
    """[face_detect]: the full-width RetinaFace on a seeded 640x640 image:
    loc/conf/landms against the CPU, then ``detect_faces`` (pad, mean,
    network, decode, NMS) warm; no kernel of the port."""
    import numpy as np
    import torch

    from diffbir_tpu_torch.models.retinaface import RetinaFaceDetector

    img = np.random.default_rng(21).integers(0, 256, (DETECT_SIZE, DETECT_SIZE, 3),
                                             dtype=np.uint8)
    x = (torch.from_numpy(img).float().cuda() - torch.tensor([104.0, 117.0, 123.0],
                                                              device="cuda"))[None]
    before = counts()
    against_cpu("face_detect", det, x, TF32_TOL, FACE_FP32_TOL)
    detector = RetinaFaceDetector(det)
    torch.backends.cudnn.allow_tf32 = True
    faces = detector.detect_faces(img, 0.8)
    ms = median_ms(lambda: detector.detect_faces(img, 0.8), iters=10, warmup=1)
    torch.backends.cudnn.allow_tf32 = False
    check(faces.shape[1] == 15 and bool(torch.isfinite(faces).all()), "detect_faces: bad output")
    check(not launched_since(before), "face_detect launched a kernel of the port")
    print(f"[face_detect] RetinaFace-ResNet50 {sum(p.numel() for p in det.parameters()) / 1e6:.1f}"
          f" M params, fp32, {DETECT_SIZE}x{DETECT_SIZE}: detect_faces {ms:.3f} ms warm (median "
          f"of 10 host calls, TF32 on), {faces.shape[0]} faces kept above 0.8 {card()}")


def phase_face_parse(parse) -> None:
    """[face_parse]: the full-width ParseNet on a seeded 512x512 face:
    logits and image against the CPU, ``parse`` warm."""
    import torch

    from diffbir_tpu_torch.models.parsenet import FaceParser

    gen = torch.Generator(device="cuda").manual_seed(22)
    face = torch.rand(PARSE_SIZE, PARSE_SIZE, 3, generator=gen, device="cuda")
    before = counts()
    against_cpu("face_parse", parse, face[None] * 2 - 1, TF32_TOL, FACE_FP32_TOL)
    parser = FaceParser(parse)
    torch.backends.cudnn.allow_tf32 = True
    classes = parser.parse(face)
    ms = median_ms(lambda: parser.parse(face), iters=10, warmup=1)
    torch.backends.cudnn.allow_tf32 = False
    check(classes.shape == (PARSE_SIZE, PARSE_SIZE) and classes.dtype == torch.int32,
          f"parse: bad class map {tuple(classes.shape)} {classes.dtype}")
    check(not launched_since(before), "face_parse launched a kernel of the port")
    print(f"[face_parse] ParseNet {sum(p.numel() for p in parse.parameters()) / 1e6:.2f} M "
          f"params, fp32, {PARSE_SIZE}x{PARSE_SIZE}: parse {ms:.3f} ms warm (median of 10 host "
          f"calls, TF32 on), {int(classes.unique().numel())} classes in the map {card()}")


def phase_face_blur() -> None:
    """[face_blur]: ``utils.warp.gaussian_blur`` (grouped convolutions) on
    the card at the face helper's sizes and on a batch of colour images,
    with cuDNN's TF32 on in the process (the function turns it off for its
    convolutions and back on), against the same call on the CPU (limit
    BLUR_TOL x max|ref|, what the CPU tests hold it to against cv2); ms
    warm."""
    import torch

    from diffbir_tpu_torch.utils import warp

    gen = torch.Generator(device="cuda").manual_seed(31)
    cases = {"parse mask 512^2, 101 taps, sigma 11": ((1, 512, 512, 1), 101, 11.0),
             "soft mask 1024^2, 51 taps": ((1, 1024, 1024, 1), 51, 0.0),
             "batch 8x512^2x3, 51 taps": ((8, 512, 512, 3), 51, 0.0)}
    torch.backends.cudnn.allow_tf32 = True
    try:
        rows = []
        for name, (shape, k, sigma) in cases.items():
            x = torch.rand(shape, generator=gen, device="cuda") * 255
            out = warp.gaussian_blur(x, k, sigma)
            check(torch.backends.cudnn.allow_tf32, "gaussian_blur left cuDNN's TF32 off")
            err = rel_err(out, warp.gaussian_blur(x.cpu(), k, sigma).numpy())
            check(err <= BLUR_TOL, f"[face_blur] {name}: {err:.3e} x max|ref| > {BLUR_TOL:g}")
            ms = median_ms(lambda: warp.gaussian_blur(x, k, sigma), iters=10, warmup=1)
            rows.append(f"{name} {err:.3e} x max|ref|, {ms:.3f} ms")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    print(f"[face_blur] {card()} gaussian_blur on the card (cuDNN TF32 on in the process) "
          f"against the CPU (limit {BLUR_TOL:g} x max|ref|): " + "; ".join(rows))


def two_faces(img):
    """The landmarks of two faces placed by the image's size (the smoke's
    fixed detection: a random detector finds arbitrary faces)."""
    import numpy as np

    from diffbir_tpu_torch.utils.face import FFHQ_TEMPLATE_512

    h, w = img.shape[:2]
    out = []
    for cx, cy, a, s in ((0.3 * w, 0.35 * h, 0.2, 0.3), (0.68 * w, 0.62 * h, -0.1, 0.4)):
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]) * s * w / 512
        out.append((FFHQ_TEMPLATE_512 - 256) @ rot.T + [cx, cy])
    return np.asarray(out, np.float32)


def phase_cli_unaligned_face(det, parse) -> dict:
    """[cli_unaligned_face]: ``python -m diffbir_tpu_torch.inference --task
    unaligned_face --upscale 2`` in process on a seeded 256x256 PNG, random
    full-width weights, the CLI's defaults; RetinaFace and ParseNet read
    strictly from facexlib-layout files written from ``det`` and ``parse``
    into the run's weights folder; the landmarks fixed to two faces through
    the loop's ``face_helper``. Exact launches (three 512x512 requests),
    seconds per stage (detect/align and paste apart), the files and the
    merged PNG, a rerun bit-identical. Returns the launch counts."""
    import shutil

    import numpy as np
    import torch

    from diffbir_tpu_torch.inference import unaligned_bfr_loop as ua
    from diffbir_tpu_torch.inference.__main__ import main
    from diffbir_tpu_torch.inference.pretrained_models import MODELS
    from diffbir_tpu_torch.utils.face import FaceRestoreHelper
    from diffbir_tpu_torch.utils.image_io import read_png, write_png

    root = os.path.join("build", "cli_request", "cli_unaligned_face")
    shutil.rmtree(root, ignore_errors=True)
    in_dir, out_dir, weights = (os.path.join(root, d) for d in ("in", "out", "weights"))
    for d in (in_dir, weights):
        os.makedirs(d)
    write_png(os.path.join(in_dir, "lq.png"), np.random.default_rng(23).integers(
        0, 256, (UNALIGNED_LQ, UNALIGNED_LQ, 3), dtype=np.uint8))
    for name, module in (("retinaface_resnet50", det), ("parsenet", parse)):
        face_weights_file(module, os.path.join(weights, os.path.basename(MODELS[name])))
    argv = ["--task", "unaligned_face", "--input", in_dir, "--output", out_dir,
            "--upscale", str(UNALIGNED_UPSCALE)]
    hook = ua.UnAlignedBFRInferenceLoop.face_helper
    ua.UnAlignedBFRInferenceLoop.face_helper = lambda self: FaceRestoreHelper(
        landmarks_fn=two_faces, detector=self.detector, face_parser=self.face_parser,
        device=self.device)
    saved = os.environ.get("DIFFBIR_TPU_WEIGHTS")
    os.environ["DIFFBIR_TPU_WEIGHTS"] = weights
    try:
        with cli_environment(root):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()  # count only this path from here
            t0 = time.perf_counter()
            loop = main(argv)
            dt = time.perf_counter() - t0
            launches = counts()
            n = {k: v for k, v in launches.items() if v}
            first = dict(loop.timings)
            check(loop.face_parser is not None, "cli_unaligned_face: the parser did not load")
            check(n == UNALIGNED, f"cli_unaligned_face: expected launches {UNALIGNED}, got {n}")
            names = sorted(os.path.relpath(os.path.join(d, f), out_dir)
                           for d, _, fs in os.walk(out_dir) for f in fs)
            want = sorted(["lq.png", "prompt.csv", "restored_backgrounds/lq_0.png"] + [
                f"{d}/lq_face{i}{s}.png" for i in range(UNALIGNED_FACES)
                for d, s in (("cropped_faces", ""), ("restored_faces", "_0"))])
            check(names == want, f"cli_unaligned_face: files {names}, expected {want}")
            merged = read_png(os.path.join(out_dir, "lq.png"))
            size = UNALIGNED_LQ * UNALIGNED_UPSCALE
            check(merged.shape == (size, size, 3) and float(merged.std()) > 1.0,
                  f"cli_unaligned_face: bad merged PNG {merged.shape}")
            pngs = {name: read_png(os.path.join(out_dir, name)) for name in names
                    if name.endswith(".png")}
            loop.timings = {}
            before = counts()
            t1 = time.perf_counter()
            loop.run()
            dt2 = time.perf_counter() - t1
            check(launched_since(before) == UNALIGNED, "cli_unaligned_face: the rerun launched "
                  "another count")
            for name, png in pngs.items():
                check(np.array_equal(read_png(os.path.join(out_dir, name)), png),
                      f"cli_unaligned_face: the rerun's {name} differs")
    finally:
        ua.UnAlignedBFRInferenceLoop.face_helper = hook
        if saved is None:
            os.environ.pop("DIFFBIR_TPU_WEIGHTS", None)
        else:
            os.environ["DIFFBIR_TPU_WEIGHTS"] = saved
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[cli_unaligned_face] python -m diffbir_tpu_torch.inference {' '.join(argv)}: "
          f"{dt:.3f} s ({stages(first)} s); the detector and parser read strictly from "
          f"facexlib-layout files; launches " + ", ".join(f"{k} {v}" for k, v in n.items())
          + f"; peak device memory {peak:.2f} GiB {card()}")
    print(f"[cli_unaligned_face] {len(names)} files ({', '.join(names)}), merged "
          f"{merged.shape[1]}x{merged.shape[0]}; a rerun of the loop: {dt2:.3f} s "
          f"({stages(loop.timings)} s), bit-identical {card()}")
    del loop
    torch.cuda.empty_cache()
    return launches


def percentile(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values), q))


def http_post(port: int, payload: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/restore",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def concurrent(fn, args_list) -> list:
    """``fn(*args)`` for each in threads started together; the results in
    order (an exception re-raised)."""
    import threading

    out = [None] * len(args_list)

    def run(i, a):
        try:
            out[i] = fn(*a)
        except Exception as e:  # noqa: BLE001 - re-raised below
            out[i] = e

    threads = [threading.Thread(target=run, args=(i, a)) for i, a in enumerate(args_list)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in out:
        if isinstance(r, Exception):
            raise r
    return out


@contextlib.contextmanager
def http_server(handler):
    """A threaded HTTP server of ``handler`` on 127.0.0.1 and an ephemeral
    port (yielded), shut down afterwards."""
    import threading
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()


def phase_http_serve() -> dict:
    """[http_serve]: ``diffbir_tpu_torch.serve``'s BatchingServer and handler
    on 127.0.0.1 over the v2.1 sr pipeline (``build_pipelines``, random
    full-width weights, --upscale 4): 4 concurrent same-key 128x128 PNGs
    make one pipeline call at batch 4 (K1 230 + K1_wide 2), 2 of another
    seed a separate call; a --batch 1 server's response bit-equal to
    ``pipeline.run`` of the same request; per-request latency p50/p95 of
    the --batch 1 server one request at a time and of the --batch 4 one 4
    at a time, peak memory. Returns the launch counts of the batch-4 call."""
    import base64

    import numpy as np
    import torch

    from diffbir_tpu_torch import serve
    from diffbir_tpu_torch.utils.image_io import decode_png, encode_png

    root = os.path.join("build", "http_serve")
    os.makedirs(root, exist_ok=True)
    with cli_environment(root):
        args = serve.build_parser().parse_args(["--upscale", str(CLI_UPSCALE)])
        pipe = serve.build_pipelines(args, ["sr"])["sr"]
        calls = []
        run = pipe.run

        def counted(lq, **kw):
            calls.append(len(lq))
            return run(lq, **kw)

        pipe.run = counted
        # --batch 4 (its window wide enough that 4 threads started together
        # land in it), and --batch 1 (no window: the collector never waits)
        srv = serve.BatchingServer(pipe, SERVE_BATCH, max_wait_ms=500.0)
        srv1 = serve.BatchingServer(pipe, 1, max_wait_ms=500.0)
        imgs = [np.random.default_rng(30 + i).integers(0, 256, (CLI_LQ, CLI_LQ, 3),
                                                       dtype=np.uint8) for i in range(4)]

        def request(port, img, seed):
            t0 = time.perf_counter()
            out = http_post(port, {"image": base64.b64encode(encode_png(img)).decode(),
                                   "seed": seed})
            return decode_png(base64.b64decode(out["image"])), time.perf_counter() - t0

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with http_server(serve.make_handler(srv, float(CLI_UPSCALE))) as port, \
                http_server(serve.make_handler(srv1, float(CLI_UPSCALE))) as port1:
            request(port, imgs[0], 231)  # warm
            calls.clear()
            reset_counts()
            four = concurrent(request, [(port, im, 231) for im in imgs])
            launches = counts()
            n = {k: v for k, v in launches.items() if v}
            check(calls == [4], f"http_serve: 4 same-key requests made pipeline calls {calls}")
            check(n == CLI_DEFAULT, f"http_serve: the batch-4 call launched {n}, expected "
                  f"{CLI_DEFAULT}")
            size = CLI_LQ * CLI_UPSCALE
            check(all(o.shape == (size, size, 3) for o, _ in four), "http_serve: bad shapes")
            calls.clear()
            two = concurrent(request, [(port, im, 7) for im in imgs[:2]])
            check(calls == [2], f"http_serve: 2 requests of seed 7 made calls {calls}")
            calls.clear()
            lat1 = [request(port1, imgs[0], 231)[1] for _ in range(SERVE_LATENCY_ROUNDS)]
            check(calls == [1] * SERVE_LATENCY_ROUNDS, f"http_serve: batch-1 calls {calls}")
            lat4 = []
            for _ in range(SERVE_LATENCY_ROUNDS):
                lat4 += [t for _, t in concurrent(request, [(port, im, 231) for im in imgs])]
            one = request(port1, imgs[0], 231)[0]
        peak = torch.cuda.max_memory_allocated() / 2**30
        up = serve.upscale_image(imgs[0], float(CLI_UPSCALE))
        direct = run(up[None], steps=10, cfg_scale=6.0, pos_prompt="", neg_prompt="",
                     sampler_type="edm_dpm++_3m_sde", seed=231, size_bucket=64)[0]
        check(np.array_equal(one, direct), "http_serve: the batch-1 response differs from "
              "pipeline.run of the same request")
        check(not np.array_equal(two[0][0], one), "http_serve: seeds 7 and 231 gave one image")
        srv.stop()
        srv1.stop()
    del pipe, srv, srv1, run
    torch.cuda.empty_cache()
    print(f"[http_serve] BatchingServer (batch {SERVE_BATCH}, wait 500 ms, bucket 64) on "
          f"127.0.0.1:{port}, v2.1 sr, {CLI_LQ}x{CLI_LQ} PNGs at --upscale {CLI_UPSCALE}: 4 "
          f"same-key requests -> one call at batch 4 (launches "
          + ", ".join(f"{k} {v}" for k, v in n.items()) + "); 2 of another seed -> one call "
          "at batch 2; the batch-1 response bit-equal to pipeline.run")
    print(f"[http_serve] per-request latency, a --batch 1 server, one request at a time: p50 "
          f"{percentile(lat1, 50):.3f} s, p95 {percentile(lat1, 95):.3f} s ({len(lat1)} "
          f"requests); the --batch 4 server, 4 at a time: p50 {percentile(lat4, 50):.3f} s, p95 "
          f"{percentile(lat4, 95):.3f} s ({len(lat4)} requests); peak device memory "
          f"{peak:.2f} GiB {card()}")
    return launches


def phase_demo_http() -> dict:
    """[demo_http]: one ``diffbir_tpu_torch.run_gradio`` request (a 128x128
    PNG, the demo's defaults at --upscale 4) through its ``_Handler`` equal
    to ``process()`` called directly. Returns the launch counts of the
    handler's request."""
    import base64
    from argparse import Namespace

    import numpy as np
    import torch

    from diffbir_tpu_torch import run_gradio
    from diffbir_tpu_torch.utils.image_io import decode_png, encode_png

    root = os.path.join("build", "demo_http")
    os.makedirs(root, exist_ok=True)
    img = np.random.default_rng(40).integers(0, 256, (CLI_LQ, CLI_LQ, 3), dtype=np.uint8)
    with cli_environment(root):
        process = run_gradio.build_runner(Namespace(
            upscale=float(CLI_UPSCALE), steps=10, precision="bf16", version="v2.1", tasks="sr",
            device="cuda"))
        run_gradio._Handler.process = staticmethod(process)
        with http_server(run_gradio._Handler) as port:
            reset_counts()
            t0 = time.perf_counter()
            out = http_post(port, {"image": base64.b64encode(encode_png(img)).decode(),
                                   "seed": 5, "a_field_the_demo_ignores": 1})
            dt = time.perf_counter() - t0
            launches = counts()
        got = decode_png(base64.b64decode(out["image"]))
        direct = process(img, seed=5)
    n = {k: v for k, v in launches.items() if v}
    check(np.array_equal(got, direct), "demo_http: the response differs from process()")
    check(n == CLI_DEFAULT, f"demo_http: launched {n}, expected {CLI_DEFAULT}")
    del process
    run_gradio._Handler.process = None
    torch.cuda.empty_cache()
    print(f"[demo_http] run_gradio._Handler POST /restore ({CLI_LQ}x{CLI_LQ} PNG, an unknown "
          f"key ignored): {dt:.3f} s, launches " + ", ".join(f"{k} {v}" for k, v in n.items())
          + f"; equal to process() called directly {card()}")
    return launches


def controlnet_grad(cldm, loss_fn, batch, draws):
    """The ControlNet's flattened gradient of one loss (zeros for a tensor
    that got none) and the number of its tensors that got none."""
    import torch

    loss_fn(batch, draws=draws).backward()
    params = list(cldm.controlnet.parameters())
    flat = torch.cat([p.grad.float().flatten() if p.grad is not None
                      else torch.zeros(p.numel(), device=p.device) for p in params])
    missing = sum(p.grad is None for p in params)
    cldm.controlnet.zero_grad(set_to_none=True)
    return flat.double(), missing  # float64 sums over 363 M terms


def compare_grads(a, p):
    """(relative norm difference, cosine similarity) of a against p."""
    na, np_ = a.norm().item(), p.norm().item()
    return abs(na - np_) / np_, (a @ p).item() / (na * np_)


def phase_train(fa):
    """The training path; returns the launch counts of its timed and warm-up
    steps."""
    import numpy as np
    import torch

    from diffbir_tpu_torch.profile_step import NOISE_AUG, TRAIN_LR, build_train_setup
    from diffbir_tpu_torch.train import stage2

    t0 = time.perf_counter()
    setup = build_train_setup(0, torch.device("cuda"), TRAIN_BATCH, SIZE)
    cldm, swinir, opt = setup.cldm, setup.swinir, setup.optimizer
    n_cn = sum(p.numel() for p in cldm.controlnet.parameters())
    print(f"[train] sd21 ControlLDM with checkpointing, ControlNet from the UNet, SwinIR "
          f"cleaner, random bf16 weights from seed 0, built in {time.perf_counter() - t0:.2f} s; "
          f"ControlNet {n_cn / 1e6:.1f} M trainable params (fp32 masters, AdamW "
          f"lr {TRAIN_LR:g}, weight decay 0), UNet/VAE/CLIP/SwinIR frozen")

    frozen = {name: [p.detach().clone() for p in mod.parameters()]
              for name, mod in (("UNet", cldm.unet), ("VAE", cldm.vae), ("CLIP", cldm.clip),
                                ("SwinIR", swinir))}
    masters0 = [m.clone() for m in opt.masters]
    module0 = [p.detach().clone() for p in cldm.controlnet.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # count only the training path from here
    step_s = []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        before = counts()
        t0 = time.perf_counter()
        m = setup.train_step(setup.batch, gen)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = launched_since(before)
        kind = "warm-up" if i < TRAIN_WARMUP else "timed"
        print(f"[train] step {i} ({kind}): loss {loss:.5f}, grad norm {gnorm:.5f}, "
              f"{dt:.3f} s; launches " + ", ".join(f"{k} {v}" for k, v in n.items()))
        check(np.isfinite(loss) and np.isfinite(gnorm), f"non-finite loss or grad norm at {i}")
        # K1, K1_wide and K2 on the tensor-core entries, none on the
        # CUDA-core ones (K1_cc, K2a_cc, K2b_cc: left out of n when 0)
        expected = {"K1": K1_PER_TRAIN_STEP, "K1_wide": K1_WIDE_PER_TRAIN_STEP,
                    "K2a": K2_SITES_PER_TRAIN_STEP, "K2b": K2_SITES_PER_TRAIN_STEP}
        check(n == expected, f"expected launches {expected} per step, got {n}")
        if i >= TRAIN_WARMUP:
            step_s.append(dt)
    launches = counts()
    print(f"[train] {TRAIN_WARMUP + TRAIN_TIMED} steps: K1 {launches['K1']}, K1_wide "
          f"{launches['K1_wide']}, K2a {launches['K2a']} and K2b {launches['K2b']} launches on "
          f"the tensor-core entries, {launches['K1_cc']}, {launches['K2a_cc']} and "
          f"{launches['K2b_cc']} on the CUDA-core entries")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(step_s)
    TRAIN_STEP_S.extend(step_s)
    print(f"[train] batch {TRAIN_BATCH} at {SIZE}x{SIZE}: timed steps "
          f"{', '.join(f'{x:.3f}' for x in step_s)} s (median {med:.3f} s, "
          f"{TRAIN_BATCH / med:.2f} images/s); peak device memory {peak:.2f} GiB")

    for name, before in frozen.items():
        mod = {"UNet": cldm.unet, "VAE": cldm.vae, "CLIP": cldm.clip, "SwinIR": swinir}[name]
        check(all(torch.equal(a, p) for a, p in zip(before, mod.parameters())),
              f"the frozen {name} changed")
    moved_masters = sum(not torch.equal(a, m) for a, m in zip(masters0, opt.masters))
    moved = sum(int((a != p).sum()) for a, p in zip(module0, cldm.controlnet.parameters()))
    print(f"[train] ControlNet: {moved_masters}/{len(masters0)} fp32 master tensors and "
          f"{moved}/{n_cn} module elements changed; UNet, VAE, CLIP, SwinIR unchanged")
    check(moved_masters == len(masters0), "some ControlNet master tensors did not move")
    check(moved > 0, "the ControlNet's module weights did not change")
    del frozen, masters0, module0

    # one step's ControlNet gradient at batch 2: through K1+K2, then plain
    loss_fn = stage2.make_loss_fn(cldm, setup.schedule, setup.cleaner, NOISE_AUG)
    small = {k: v[:2] for k, v in setup.batch.items()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    latent = (2, SIZE // 8, SIZE // 8, 4)
    draws = {"posterior": torch.randn(latent, generator=gen, device="cuda"),
             "aug": torch.randn(latent, generator=gen, device="cuda"),
             "t": torch.randint(0, setup.schedule.num_timesteps, (2,), generator=gen,
                                device="cuda"),
             "noise": torch.randn(latent, generator=gen, device="cuda")}
    flat = {}
    for impl in ("auto", "plain"):
        cldm.set_attention_impl(impl)
        flat[impl], missing = controlnet_grad(cldm, loss_fn, small, draws)
        check(missing == 0, f"{missing} ControlNet tensors got no gradient ({impl} attention)")
    cldm.set_attention_impl("auto")
    rel, cos = compare_grads(flat["auto"], flat["plain"])
    print(f"[train] batch-2 ControlNet gradient, K1+K2 vs plain attention: grad norms "
          f"{flat['auto'].norm().item():.5f} / {flat['plain'].norm().item():.5f}, relative "
          f"difference {rel:.3e} (tol {GRAD_NORM_REL_TOL:g}), cosine similarity {cos:.7f} "
          f"(min {GRAD_COS_MIN:g})")
    check(rel <= GRAD_NORM_REL_TOL and cos >= GRAD_COS_MIN,
          "the ControlNet gradient through K1+K2 disagrees with plain attention")

    # the check's power: K1 without its autograd Function drops the gradients
    # of q, k and v at every flash site; that gradient must fail the limits
    flash = fa.flash_attention
    fa.flash_attention = lambda q, k, v: fa.flash_attention_fwd(q.detach(), k.detach(),
                                                                v.detach())
    try:
        dropped, missing = controlnet_grad(cldm, loss_fn, small, draws)
    finally:
        fa.flash_attention = flash
    rel_d, cos_d = compare_grads(dropped, flat["plain"])
    print(f"[train] the same with q/k/v gradients dropped at the flash sites: {missing} "
          f"ControlNet tensors got no gradient, relative difference {rel_d:.3e}, cosine "
          f"similarity {cos_d:.7f}")
    check(rel_d > GRAD_NORM_REL_TOL or cos_d < GRAD_COS_MIN,
          "the gradient limits do not catch dropped attention gradients")
    return launches



# --------------------------------------------------------------------------- #
# RAM++ and the training data and loop
def build_ram():
    """RAM++ at full width in bf16 on the card, random weights from
    RAM_SEED (``random_init_``; reweight_scale at RAM++'s init log(1/0.07);
    the label rows and the class queries scaled by RAM_LABEL_SCALE and
    RAM_QUERY_SCALE)."""
    import numpy as np
    import torch

    from diffbir_tpu_torch.captioners.ram import RAMPlus
    from diffbir_tpu_torch.models.layers import random_init_

    model = RAMPlus(dtype=torch.bfloat16, device="meta").to_empty(device="cuda")
    random_init_(model, torch.Generator(device="cuda").manual_seed(RAM_SEED))
    with torch.no_grad():
        model.reweight_scale.fill_(float(np.log(1 / 0.07)))
        model.label_embed.mul_(RAM_LABEL_SCALE)
        model.wordvec_proj.weight.mul_(RAM_QUERY_SCALE)
    return model.eval()


def phase_ram(model):
    """[ram]: RAM++'s logits of a seeded 512x384 image on the card against
    the same weights in fp32 on the CPU; ms per image and peak memory; no
    kernel of the port launched (its attention is plain math, XLA's in
    JAX)."""
    import numpy as np
    import torch

    from diffbir_tpu_torch.captioners.ram import RAMPlus, preprocess

    n_params = sum(p.numel() for p in model.parameters())
    img = np.random.default_rng(8).integers(0, 256, (512, 384, 3), dtype=np.uint8)
    x = torch.from_numpy(preprocess(img)[None]).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    with torch.no_grad():
        out = model(x)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    launched = {k: v for k, v in counts().items() if v}
    check(not launched, f"RAM++ launched kernels of the port: {launched}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    act = (torch.cuda.max_memory_allocated() - base) / 2**30
    cpu = RAMPlus(dtype=torch.float32)
    cpu.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()}, strict=True)
    t0 = time.perf_counter()
    refs = ram_stages(cpu, x.cpu())
    cpu_s = time.perf_counter() - t0
    ref = refs["logits"]
    got = out.float().cpu().numpy()
    err = float(np.abs(got - ref).max())
    limit = RAM_REL_TOL * float(np.abs(ref).max())
    dp = float(np.abs(1 / (1 + np.exp(-got)) - 1 / (1 + np.exp(-ref))).max())
    print(f"[ram] RAM++ at full width (swin-L 384^2, {model.num_class} classes x "
          f"{model.des_per_class} descriptors, {n_params / 1e6:.1f} M params, bf16, random "
          f"weights from seed {RAM_SEED}) on a 512x384 image: logits {tuple(got.shape)}, "
          f"max|err| {err:.4e} = {err / float(np.abs(ref).max()):.4e} x max|ref| against the "
          f"same weights in fp32 on the CPU (limit {RAM_REL_TOL:g} x max|ref| = {limit:.4e}); "
          f"sigmoids {dp:.4e} apart (limit {RAM_PROB_TOL:g}); the reference's logits "
          f"{float(ref.mean()):.4f} +- {float(ref.std()):.4f} over the classes; the CPU run "
          f"{cpu_s:.2f} s")
    check(np.isfinite(got).all() and err <= limit and dp <= RAM_PROB_TOL,
          "RAM++'s logits disagree with the CPU")

    # where the error comes from: each stage of the bf16 model, and the same
    # weights in fp32 on the card (TF32 off), against the CPU's fp32 stages
    stage_err = {k: rel_err(v, refs[k]) for k, v in ram_stages(model, x).items()}
    card32 = cpu.cuda()
    err32 = {k: rel_err(v, refs[k]) for k, v in ram_stages(card32, x).items()}
    del card32, cpu
    torch.cuda.empty_cache()
    print("[ram] error x max|ref| of each stage against the CPU's fp32: bf16 on the card "
          + ", ".join(f"{k} {v:.4e}" for k, v in stage_err.items())
          + "; fp32 on the card " + ", ".join(f"{k} {v:.4e}" for k, v in err32.items()))
    check(err32["logits"] <= RAM_FP32_TOL, f"RAM++ in fp32 on the card: {err32['logits']:.3e} "
          f"x max|ref| from the CPU > {RAM_FP32_TOL:g}")

    # the limit's power: planted faults in the card's model must fail it
    faults = {}
    with torch.no_grad():
        rows = model.label_embed.data
        try:
            model.label_embed.data = rows.roll(model.des_per_class, 0)
            faults["label rows rolled by one class"] = rel_err(model(x), ref)
        finally:
            model.label_embed.data = rows
        layers = model.tagging_head.encoder.layer
        try:
            model.tagging_head.encoder.layer = layers[:-1]
            faults["the last tagging layer skipped"] = rel_err(model(x), ref)
        finally:
            model.tagging_head.encoder.layer = layers
    print("[ram] planted faults against the same limit: " + ", ".join(
        f"{k} {v:.4e} x max|ref|" for k, v in faults.items()))
    for k, v in faults.items():
        check(v > RAM_REL_TOL, f"[ram] the limit {RAM_REL_TOL:g} passes a fault: {k} ({v:.3e})")
    print(f"[ram] {card()} {statistics.median(times):.3f} ms per image (median of 5 after a "
          f"warm-up: {', '.join(f'{t:.3f}' for t in times)}); peak device memory "
          f"{peak:.3f} GiB ({act:.3f} GiB above the weights); no kernel of the port")
    return got


def rel_err(out, ref) -> float:
    """max|out - ref| / max|ref| of two arrays or tensors, on the host."""
    import numpy as np
    import torch

    out = out.float().cpu().numpy() if torch.is_tensor(out) else out
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def ram_stages(model, x) -> dict:
    """RAM++'s image embeddings (``image_proj``), the tagging head's output
    and the logits on ``x``, as fp32 numpy arrays (forward hooks)."""
    import torch

    outs = {}
    hooks = [getattr(model, name).register_forward_hook(
        lambda mod, args, out, name=name: outs.__setitem__(name, out.float().cpu().numpy()))
        for name in ("image_proj", "tagging_head")]
    try:
        with torch.no_grad():
            outs["logits"] = model(x).float().cpu().numpy()
    finally:
        for h in hooks:
            h.remove()
    return outs


def phase_cli_ram_caption(model) -> dict:
    """[cli_ram_caption]: one ``--captioner ram`` CLI request (the default
    sr request on a 128x128 PNG) with RAM++ read from a checkpoint of
    ``model`` and a stand-in tag list written here (RAM_EVERY, RAM_MARGIN):
    the caption equal to the known tags and not empty, prompt.csv holding
    it ahead of the positive prompt, K1 230 and K1_wide 2; the caption's
    seconds. Returns the launch counts."""
    import csv

    import numpy as np
    import torch

    from diffbir_tpu_torch.captioners import ram
    from diffbir_tpu_torch.inference.__main__ import main
    from diffbir_tpu_torch.utils.image_io import read_rgb

    root, argv = cli_request_argv("cli_ram_caption", ["--captioner", "ram"])
    data = os.path.join(root, "ram_data")
    os.makedirs(data, exist_ok=True)
    ckpt = os.path.join(root, ram.CKPT_NAME)
    t0 = time.perf_counter()
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
    write_s = time.perf_counter() - t0
    lq = read_rgb(os.path.join(root, "in", "lq.png"))
    with torch.no_grad():
        probs = torch.sigmoid(model(torch.from_numpy(ram.preprocess(lq)[None]).cuda())[0])
    probs = probs.float().cpu().numpy()
    chosen = np.arange(model.num_class) % RAM_EVERY == 0
    thresholds = np.where(chosen, probs - RAM_MARGIN, 2.0)
    tags = [f"tag{i:04d}" for i in range(model.num_class)]
    with open(os.path.join(data, ram.TAG_FILES[0]), "w") as f:
        f.write("\n".join(tags) + "\n")
    with open(os.path.join(data, ram.TAG_FILES[1]), "w") as f:
        f.write("\n".join(f"{t:.6f}" for t in thresholds) + "\n")
    expected = ", ".join(t for t, c in zip(tags, chosen) if c)
    saved = {k: os.environ.get(k) for k in ("DIFFBIR_TPU_RAM_CKPT", "DIFFBIR_TPU_RAM_DATA")}
    os.environ.update(DIFFBIR_TPU_RAM_CKPT=ckpt, DIFFBIR_TPU_RAM_DATA=data)
    try:
        with cli_environment(root):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            loop = main(argv)
            dt = time.perf_counter() - t0
            launches = counts()
            n = {k: v for k, v in launches.items() if v}
            cap_s = []
            for _ in range(3):
                t1 = time.perf_counter()
                caption = loop.captioner(lq)
                cap_s.append(time.perf_counter() - t1)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(n == CLI_DEFAULT, f"cli_ram_caption: expected launches {CLI_DEFAULT}, got {n}")
    check(caption == expected and caption, f"cli_ram_caption: caption {caption[:200]!r}, "
          f"expected {expected[:200]!r}")
    with open(os.path.join(root, "out", "prompt.csv")) as f:
        rows = list(csv.DictReader(f))
    prompt = rows[-1]["prompt"]
    check(rows[-1]["file_name"] == "lq.png" and prompt == f"{expected}, {loop.args.pos_prompt}",
          f"cli_ram_caption: prompt.csv holds {prompt[:200]!r}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[cli_ram_caption] python -m diffbir_tpu_torch.inference {' '.join(argv)} "
          f"(DIFFBIR_TPU_RAM_CKPT: RAM++'s weights written in {write_s:.3f} s; "
          f"DIFFBIR_TPU_RAM_DATA: {model.num_class} stand-in tags, every {RAM_EVERY}th "
          f"threshold {RAM_MARGIN} below its probability): {dt:.3f} s "
          f"({stages(loop.timings)} s); launches " + ", ".join(f"{k} {v}" for k, v in n.items()))
    print(f"[cli_ram_caption] {card()} caption of {chosen.sum()} tags as expected "
          f"({caption[:40]!r}...), ahead of the positive prompt in prompt.csv; the caption "
          f"{statistics.median(cap_s):.3f} s (median of 3: "
          f"{', '.join(f'{t:.3f}' for t in cap_s)}); peak device memory {peak:.2f} GiB")
    del loop
    torch.cuda.empty_cache()
    return launches


def write_train_folder(root: str = TRAIN_ROOT, n: int = TRAIN_IMAGES) -> str:
    """``n`` synthetic 512x512 PNGs under ``root``/images (seeded smooth
    colour fields with noise) and a txt list with a prompt a line; returns
    the list's path."""
    import shutil

    import numpy as np
    import torch
    import torch.nn.functional as F

    from diffbir_tpu_torch.utils.image_io import write_png

    shutil.rmtree(root, ignore_errors=True)
    folder = os.path.join(root, "images")
    os.makedirs(folder)
    gen = torch.Generator().manual_seed(12)
    lines = []
    for i in range(n):
        base = torch.rand(1, 3, 34, 34, generator=gen)
        img = F.interpolate(base, size=(512, 512), mode="bicubic", align_corners=False)[0]
        img = img + 0.03 * torch.randn(img.shape, generator=gen)
        u8 = (img.clamp(0, 1) * 255).round().to(torch.uint8).permute(1, 2, 0).numpy()
        path = os.path.join(folder, f"{i:03d}.png")
        write_png(path, np.ascontiguousarray(u8))
        lines.append(f"{path}\ta synthetic photo number {i}")
    flist = os.path.join(root, "train.txt")
    with open(flist, "w") as f:
        f.write("\n".join(lines) + "\n")
    return flist


def phase_train_data(flist: str) -> dict:
    """[train_data]: the data pipeline alone on the card's host:
    ``realesrgan_dataset`` on the PNG folder plus
    ``realesrgan_batch_transform`` (train_stage2_v2.1.yaml's, with a pool
    of TRAIN_QUEUE) at batch TRAIN_BATCH, four batches (the pool fills in
    the first two): seconds per batch apart, the shapes and ranges of gt
    and lq. Returns the seconds."""
    import numpy as np

    from diffbir_tpu_torch import config as cfglib
    from diffbir_tpu_torch import dataset  # noqa: F401  (the registry names)

    cfg = cfglib.load_yaml(os.path.join("configs", "train", "train_stage2_v2.1.yaml"))
    dcfg = dict(cfg["dataset"]["train"]["params"])
    del dcfg["file_metas"]
    ds = cfglib.instantiate({"target": "realesrgan_dataset",
                             "params": {**dcfg, "file_list": flist}})
    bt = cfglib.instantiate(cfg["batch_transform"], queue_size=TRAIN_QUEUE)
    it = ds.as_iterator(TRAIN_BATCH, seed=231)
    load_s, transform_s = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        batch = next(it)
        t1 = time.perf_counter()
        out = bt(batch)
        load_s.append(t1 - t0)
        transform_s.append(time.perf_counter() - t1)
    gt, lq = out["gt"], out["lq"]
    check(gt.shape == lq.shape == (TRAIN_BATCH, SIZE, SIZE, 3) and np.isfinite(lq).all()
          and -1 <= gt.min() and gt.max() <= 1 and 0 <= lq.min() and lq.max() <= 1,
          f"[train_data] bad batch: gt {gt.shape} [{gt.min()}, {gt.max()}], lq {lq.shape}")
    print(f"[train_data] realesrgan_dataset ({TRAIN_IMAGES} PNGs of {SIZE}x{SIZE}, "
          f"crop_type none) + realesrgan_batch_transform (train_stage2_v2.1.yaml's, "
          f"queue_size {TRAIN_QUEUE}) at batch {TRAIN_BATCH}: gt {gt.shape} in "
          f"[{gt.min():.4f}, {gt.max():.4f}], lq {lq.shape} in [{lq.min():.4f}, "
          f"{lq.max():.4f}], {len(set(out['txt']))} distinct prompts")
    TRAIN_DATA_S.append(f"{min(transform_s):.3f}-{max(transform_s):.3f}")
    print(f"[train_data] {card()} host seconds per batch: dataset (read, decode, kernels) "
          f"{', '.join(f'{t:.3f}' for t in load_s)}; transform "
          f"{', '.join(f'{t:.3f}' for t in transform_s)} (the torch CPU threads: "
          f"{__import__('torch').get_num_threads()})")
    return {"load": load_s, "transform": transform_s}


def edit_config(src: str, dst: str, changes: dict, label: str = "train_cli",
                repeated=(), added=None) -> None:
    """``src``'s YAML text with each key's value replaced (the key's one
    line, found once; every line of a key in ``repeated``) and the keys of
    ``added`` appended to its last block, which must be ``train:``, written
    to ``dst``; each change printed."""
    with open(src) as f:
        text = f.read()
    for key, value in changes.items():
        pattern = re.compile(rf"^(\s*(?:- )?{re.escape(key)}:)[^\n]*$", re.M)
        found = len(pattern.findall(text))
        check(found == 1 or (key in repeated and found > 1),
              f"{src}: {key} is on {found} lines")
        text = pattern.sub(lambda m: f"{m.group(1)} {value}", text)
        print(f"[{label}] {os.path.basename(dst)}: {key}: {value}")
    if added:
        blocks = re.findall(r"^(\w+):", text, re.M)
        check(blocks[-1] == "train", f"{src}: the last block is {blocks[-1]}, not train")
        for key, value in added.items():
            check(not re.search(rf"^\s+{key}:", text, re.M), f"{src}: {key} is there already")
            text = text.rstrip("\n") + f"\n  {key}: {value}\n"
            print(f"[{label}] {os.path.basename(dst)}: {key}: {value} (added)")
    with open(dst, "w") as f:
        f.write(text)


@contextlib.contextmanager
def timing_transform(seconds: list):
    """Each call of the Real-ESRGAN batch transform (in the prefetch
    worker) timed into ``seconds`` while in this context."""
    from diffbir_tpu_torch.dataset.batch_transform import RealESRGANBatchTransform

    call = RealESRGANBatchTransform.__call__

    def timed(self, batch):
        t0 = time.perf_counter()
        out = call(self, batch)
        seconds.append(time.perf_counter() - t0)
        return out

    RealESRGANBatchTransform.__call__ = timed
    try:
        yield
    finally:
        RealESRGANBatchTransform.__call__ = call


@contextlib.contextmanager
def counting_train_steps(per_step: list, record: list = None, replay: list = None):
    """Each train step's launches (``launched_since``) appended to
    ``per_step`` while the trainer builds its steps in this context; the
    first DDP_STEPS steps' batches copied into ``record``, or each step's
    batch replaced by ``replay``'s at its index."""
    from diffbir_tpu_torch.train import stage2

    make = stage2.make_train_step

    def counting(*args, **kw):
        step = make(*args, **kw)
        taken = []

        def counted(batch, *a, **k):
            if replay is not None:
                batch = replay[len(taken)]
            elif record is not None and len(record) < DDP_STEPS:
                record.append({key: v.clone() for key, v in batch.items()})
            taken.append(1)
            before = counts()
            out = step(batch, *a, **k)
            per_step.append(launched_since(before))
            return out

        return counted

    stage2.make_train_step = counting
    try:
        yield
    finally:
        stage2.make_train_step = make


def phase_train_cli(flist: str) -> dict:
    """[train_cli]: ``python -m diffbir_tpu_torch.train_stage2`` (``main``,
    in this process) on a copy of train_stage2_v2.1.yaml (the changes
    printed), the SD base and a SwinIR written in bf16 from random
    full-width models: per-step launches, losses, step and data-wait
    seconds beside [train]'s bare step; the checkpoint files; then a
    resume from step 2 (the masters and AdamW moments bit-equal to the
    saved ones) that runs on for two steps and TRAIN_STEADY_STEPS more with
    no checkpoint inside (one at the end), their waits on the data beside
    the worker's transform seconds; the preview at PREVIEW_N images.
    Returns the launch counts of the trainer's runs."""
    import numpy as np
    import torch

    from diffbir_tpu_torch import config as cfglib
    from diffbir_tpu_torch import train_stage2
    from diffbir_tpu_torch.models import tokenizer
    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.swinir import SwinIR

    if not os.path.isfile(os.path.join(CUSTOM_ROOT, "sd.ckpt")):
        write_custom_model(CUSTOM_ROOT)
    swin_path = os.path.join(TRAIN_ROOT, "swinir.pth")
    swinir = SwinIR(dtype=torch.bfloat16, device="meta").to_empty(device="cuda")
    random_init_(swinir, torch.Generator(device="cuda").manual_seed(7))
    torch.save({k: v.cpu() for k, v in swinir.state_dict().items()}, swin_path)
    del swinir
    exp = os.path.join(TRAIN_ROOT, "exp")
    src = os.path.join("configs", "train", "train_stage2_v2.1.yaml")
    cfg_path = os.path.join(TRAIN_ROOT, "train_stage2_v2.1.yaml")
    changes = {"file_list": flist, "batch_size": TRAIN_BATCH, "queue_size": TRAIN_QUEUE,
               "train_steps": TRAIN_CLI_STEPS, "log_every": 1, "ckpt_every": TRAIN_CKPT_EVERY,
               "exp_dir": exp, "sd_path": os.path.join(CUSTOM_ROOT, "sd.ckpt"),
               "swinir_path": swin_path}
    edit_config(src, cfg_path, changes)
    resume_path = os.path.join(TRAIN_ROOT, "resume.yaml")
    edit_config(cfg_path, resume_path, {"resume": TRAIN_CKPT_EVERY})
    with open(flist) as f:
        prompts = [line.rstrip("\n").split("\t", 1)[1] for line in f if line.strip()]
    bpe = os.path.join(TRAIN_ROOT, tokenizer.BPE_NAME)
    tokenizer.write_stand_in_merges(bpe, prompts)
    saved_bpe = os.environ.get("DIFFBIR_TPU_BPE_PATH")
    os.environ["DIFFBIR_TPU_BPE_PATH"] = bpe
    tokenizer.get_tokenizer.cache_clear()
    expected = {"K1": K1_PER_TRAIN_STEP, "K1_wide": K1_WIDE_PER_TRAIN_STEP,
                "K2a": K2_SITES_PER_TRAIN_STEP, "K2b": K2_SITES_PER_TRAIN_STEP}
    per_step = []
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with counting_train_steps(per_step, record=TRAIN_CLI_BATCHES):
            trainer = train_stage2.main(["--config", cfg_path])
        run_s = time.perf_counter() - t0
        TRAIN_CLI_RUN.update(losses=trainer.losses[:DDP_STEPS],
                             step_s=trainer.step_seconds[:DDP_STEPS],
                             wait_s=trainer.wait_seconds[:DDP_STEPS])
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(trainer.step == TRAIN_CLI_STEPS and len(per_step) == TRAIN_CLI_STEPS,
              f"[train_cli] ran {trainer.step} steps")
        for i, n in enumerate(per_step):
            n = {k: v for k, v in n.items() if v}
            check(n == expected, f"[train_cli] step {i + 1}: expected launches {expected}, "
                  f"got {n}")
        check(all(np.isfinite(trainer.losses)), f"[train_cli] losses {trainer.losses}")
        ckpts = sorted(os.listdir(os.path.join(exp, "checkpoints")))
        deploy = sorted(n for n in os.listdir(exp) if n.startswith("controlnet_"))
        check(ckpts == [f"{TRAIN_CKPT_EVERY}.pt"]
              and deploy == [f"controlnet_{TRAIN_CKPT_EVERY}.pth"],
              f"[train_cli] files {ckpts} {deploy}")
        sizes = {n: os.path.getsize(os.path.join(exp, "checkpoints", n)) / 2**30 for n in ckpts}
        bare = statistics.median(TRAIN_STEP_S) if TRAIN_STEP_S else float("nan")
        med = statistics.median(trainer.step_seconds[1:])
        busy = [s - w for s, w in zip(trainer.step_seconds, trainer.wait_seconds)]
        print(f"[train_cli] python -m diffbir_tpu_torch.train_stage2 --config {cfg_path}: "
              f"{run_s:.3f} s (models built and loaded, {TRAIN_CLI_STEPS} steps, "
              f"checkpoints); per step K1 {K1_PER_TRAIN_STEP}, K1_wide "
              f"{K1_WIDE_PER_TRAIN_STEP}, K2a and K2b {K2_SITES_PER_TRAIN_STEP} each, no "
              f"CUDA-core entry; losses {', '.join(f'{v:.5f}' for v in trainer.losses)}")
        print(f"[train_cli] {card()} step seconds without the checkpoints' saves "
              f"{', '.join(f'{v:.3f}' for v in trainer.step_seconds)} (median after the "
              f"first {med:.3f} s, {TRAIN_BATCH / med:.2f} images/s; [train]'s bare step "
              f"{bare:.3f} s, {TRAIN_BATCH / bare:.2f} images/s): waiting on next(it) "
              f"{', '.join(f'{v:.3f}' for v in trainer.wait_seconds)} s, the rest "
              f"{', '.join(f'{v:.3f}' for v in busy)} s; checkpoints "
              + ", ".join(f"{n} {v:.3f} GiB" for n, v in sizes.items())
              + f" plus controlnet_<step>.pth, saved in "
              f"{', '.join(f'{v:.3f}' for v in trainer.save_seconds)} s; peak device memory "
              f"{peak:.2f} GiB")
        launches = counts()
        del trainer
        torch.cuda.empty_cache()

        # resume from step 2: the full state restored bit for bit, then on
        # through the loop's first two steps and TRAIN_STEADY_STEPS more with
        # no checkpoint inside (one at the end), the worker's transform timed
        saved = torch.load(os.path.join(exp, "checkpoints", f"{TRAIN_CKPT_EVERY}.pt"),
                           map_location="cpu", weights_only=True)
        end = TRAIN_CLI_STEPS + 2 + TRAIN_STEADY_STEPS
        before = counts()
        transform_s = []
        with counting_train_steps(per_step), timing_transform(transform_s):
            t0 = time.perf_counter()
            resumed = train_stage2.Stage2Trainer(cfglib.load_yaml(resume_path), "cuda")
            build_s = time.perf_counter() - t0
            opt = resumed.optimizer
            check(resumed.step == TRAIN_CKPT_EVERY, f"[train_cli] resumed at {resumed.step}")
            check(all(torch.equal(m.cpu(), s) for m, s in zip(opt.masters, saved["masters"])),
                  "[train_cli] the restored masters differ from the saved ones")
            state = opt.optimizer.state_dict()["state"]
            moments = 0
            for i, s in saved["optimizer"]["state"].items():
                for key in ("exp_avg", "exp_avg_sq", "step"):
                    check(torch.equal(state[i][key].cpu(), s[key]),
                          f"[train_cli] the restored {key} of tensor {i} differs")
                    moments += key != "step"
            del saved
            resumed.tcfg.update(train_steps=end, ckpt_every=end)
            t0 = time.perf_counter()
            resumed.run()
            run_s = time.perf_counter() - t0 - sum(resumed.save_seconds)
        check(resumed.step == end, f"[train_cli] the resumed run ended at {resumed.step}")
        for n in per_step[TRAIN_CLI_STEPS:]:
            n = {k: v for k, v in n.items() if v}
            check(n == expected, f"[train_cli] resumed step: expected {expected}, got {n}")
        check(len(per_step) == end, f"[train_cli] {len(per_step)} steps counted, not {end}")
        for k, v in launched_since(before).items():
            launches[k] += v
        print(f"[train_cli] resume: {TRAIN_CKPT_EVERY}: built in {build_s:.3f} s, "
              f"{len(opt.masters)} fp32 masters and {moments} AdamW moments bit-equal to "
              f"{TRAIN_CKPT_EVERY}.pt, then steps {TRAIN_CKPT_EVERY + 1}-{end} in {run_s:.3f} s "
              f"and a checkpoint at {end} in {resumed.save_seconds[-1]:.3f} s (losses "
              f"{', '.join(f'{v:.5f}' for v in resumed.losses)})")
        steps = resumed.step_seconds[2:]
        waits = resumed.wait_seconds[2:]
        busy = [a - b for a, b in zip(steps, waits)]
        waited = sum(w > 0.01 for w in waits)
        first = TRAIN_CKPT_EVERY + 3
        print(f"[train_cli] {card()} steady window, steps {first}-{end} (after the resumed "
              f"loop's first two) with no checkpoint inside: "
              f"{TRAIN_STEADY_STEPS * TRAIN_BATCH / sum(steps):.2f} images/s ({sum(steps):.3f} s "
              f"of steps; [train]'s bare step {TRAIN_BATCH / bare:.2f}); waiting on next(it): "
              f"total {sum(waits):.3f} s, median {statistics.median(waits):.3f} s, {waited} of "
              f"{len(waits)} steps waited over 10 ms; the step's own work median "
              f"{statistics.median(busy):.3f} s (bare {bare:.3f}); the worker's transform median "
              f"{statistics.median(transform_s):.3f} s a batch "
              f"({min(transform_s):.3f}-{max(transform_s):.3f}; alone in [train_data] "
              f"{TRAIN_DATA_S[0]})")
        print("[train_cli] steady window per step (wait/rest s): " + ", ".join(
            f"{w:.3f}/{b:.3f}" for w, b in zip(waits, busy)) + "; transform s: "
            + ", ".join(f"{t:.3f}" for t in transform_s))

        # the preview at PREVIEW_N images of a batch from the pipeline
        it = resumed.data()
        try:
            batch = next(it)
        finally:
            it.close()
        lq = batch["lq"][:PREVIEW_N]
        tokens = resumed.tokens(batch)[:PREVIEW_N]
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        before = counts()
        t0 = time.perf_counter()
        grid = train_stage2.preview(resumed.cldm, resumed.schedule, resumed.cleaner(lq),
                                    tokens, gen)
        torch.cuda.synchronize()
        prev_s = time.perf_counter() - t0
        n = {k: v for k, v in launched_since(before).items() if v}
        want = {"K1": K1_SITES_PER_STEP * train_stage2.PREVIEW_STEPS,
                "K1_wide": K1_WIDE_PER_REQUEST}
        check(tuple(grid.shape) == (PREVIEW_N, SIZE, SIZE, 3) and bool(torch.isfinite(grid).all())
              and n == want, f"[train_cli] preview {tuple(grid.shape)}, launches {n}")
        for k, v in n.items():
            launches[k] += v
        print(f"[train_cli] {card()} preview ({train_stage2.PREVIEW_STEPS} spaced steps at CFG "
              f"1.0, batch {PREVIEW_N}, decoded): {prev_s:.3f} s, {tuple(grid.shape)} in "
              f"[{grid.min().item():.4f}, {grid.max().item():.4f}], launches "
              + ", ".join(f"{k} {v}" for k, v in n.items()))
        del batch, lq, tokens, grid
        del resumed
        torch.cuda.empty_cache()
    finally:
        if saved_bpe is None:
            os.environ.pop("DIFFBIR_TPU_BPE_PATH", None)
        else:
            os.environ["DIFFBIR_TPU_BPE_PATH"] = saved_bpe
        tokenizer.get_tokenizer.cache_clear()
    return launches


def phase_train_custom() -> dict:
    """[train_custom]: ``--version custom --train_cfg <the trainer's config>
    --ckpt controlnet_2.pth`` through phase_cli_request (K1 230, K1_wide 2,
    the PNG equal to pipeline.run's); then TRAIN_ROOT is removed."""
    import shutil

    exp = os.path.join(TRAIN_ROOT, "exp")
    flags = ["--version", "custom", "--train_cfg",
             os.path.join(TRAIN_ROOT, "train_stage2_v2.1.yaml"),
             "--ckpt", os.path.join(exp, f"controlnet_{TRAIN_CLI_STEPS}.pth")]
    launches, _ = phase_cli_request("train_custom", (CLI_DEFAULT, flags))
    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    return launches


# --------------------------------------------------------------------------- #
# the other training paths: the stage-2 trainer under torch.distributed,
# the native loader, the stage-1 trainer, the batch degradation ops
def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def launch_environment(port: int):
    """The multi-process launch contract for one process (rank 0 of 1) on
    127.0.0.1:``port`` while in this context."""
    env = {"DIFFBIR_COORDINATOR": f"127.0.0.1:{port}", "DIFFBIR_NUM_PROCESSES": "1",
           "DIFFBIR_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def ddp_mismatch(trainer, saved: dict) -> dict:
    """How ``trainer``'s run differs from [train_cli]'s on the same batches,
    under the keys "losses" (not == [train_cli]'s) and "masters" (the fp32
    masters not bit-equal to ``saved``, the checkpoint DDP_STEPS.pt); empty
    where it does not."""
    import torch

    out = {}
    if trainer.losses != TRAIN_CLI_RUN["losses"]:
        out["losses"] = f"losses {trainer.losses} against {TRAIN_CLI_RUN['losses']}"
    masters = [m.cpu() for m in trainer.optimizer.full_masters()]
    differ = [i for i, (m, s) in enumerate(zip(masters, saved["masters"]))
              if not torch.equal(m, s)]
    if differ:
        err = max(float((masters[i] - saved["masters"][i]).abs().max()) for i in differ)
        out["masters"] = f"{len(differ)} of {len(masters)} fp32 masters differ (at most {err:.3e})"
    return out


def phase_train_ddp() -> dict:
    """[train_ddp]: ``python -m diffbir_tpu_torch.train_stage2`` (``main``,
    in this process) under DIFFBIR_COORDINATOR / NUM_PROCESSES 1 /
    PROCESS_ID 0 (nccl, world size 1) on a copy of [train_cli]'s config,
    DDP_STEPS steps, with train.fsdp off and on; each step on [train_cli]'s
    recorded batch of that step: the losses and the fp32 masters bit-equal
    to [train_cli]'s (its checkpoint DDP_STEPS.pt), the launches per step,
    the step seconds beside [train_cli]'s, the process group destroyed
    after. Then a planted fault, one run (fsdp off) with
    ``DataParallel.reduce``'s gradients zeroed, must fail that check.
    Returns the launch counts of the two true runs."""
    import torch
    import torch.distributed as dist

    from diffbir_tpu_torch import train_stage2
    from diffbir_tpu_torch.models import tokenizer
    from diffbir_tpu_torch.parallel import mesh

    check(len(TRAIN_CLI_BATCHES) == DDP_STEPS, "[train_ddp] [train_cli] recorded no batches")
    saved = torch.load(os.path.join(TRAIN_ROOT, "exp", "checkpoints", f"{DDP_STEPS}.pt"),
                       map_location="cpu", weights_only=True)
    base = os.path.join(TRAIN_ROOT, "train_stage2_v2.1.yaml")
    expected = {"K1": K1_PER_TRAIN_STEP, "K1_wide": K1_WIDE_PER_TRAIN_STEP,
                "K2a": K2_SITES_PER_TRAIN_STEP, "K2b": K2_SITES_PER_TRAIN_STEP}
    saved_bpe = os.environ.get("DIFFBIR_TPU_BPE_PATH")
    os.environ["DIFFBIR_TPU_BPE_PATH"] = os.path.join(TRAIN_ROOT, tokenizer.BPE_NAME)
    tokenizer.get_tokenizer.cache_clear()
    launches = {k: 0 for k in KERNELS}

    def run(fsdp: str, label: str):
        exp = os.path.join(TRAIN_ROOT, f"ddp_{label}")
        cfg = exp + ".yaml"
        edit_config(base, cfg, {"train_steps": DDP_STEPS, "ckpt_every": 10 * DDP_STEPS,
                                "exp_dir": exp}, label="train_ddp", added={"fsdp": fsdp})
        per_step = []
        port = free_port()
        with launch_environment(port), counting_train_steps(per_step,
                                                            replay=TRAIN_CLI_BATCHES):
            t0 = time.perf_counter()
            trainer = train_stage2.main(["--config", cfg])
            run_s = time.perf_counter() - t0
        check(not dist.is_initialized(), "[train_ddp] the process group is still up")
        check(trainer.parallel.active and trainer.n_data == 1,
              f"[train_ddp] not under a process group: {trainer.n_data}")
        return trainer, per_step, port, run_s

    try:
        for fsdp in ("false", "true"):
            before = counts()
            trainer, per_step, port, run_s = run(fsdp, f"fsdp_{fsdp}")
            for k, v in launched_since(before).items():
                launches[k] += v
            for i, n in enumerate(per_step):
                n = {k: v for k, v in n.items() if v}
                check(n == expected, f"[train_ddp] step {i + 1}: expected {expected}, got {n}")
            mismatch = ddp_mismatch(trainer, saved)
            check(not mismatch, f"[train_ddp] fsdp {fsdp}: " + "; ".join(mismatch.values()))
            print(f"[train_ddp] {card()} train.fsdp {fsdp}, process group nccl at "
                  f"127.0.0.1:{port}, world size 1 (sharded leaves: "
                  f"{sum(d is not None for d in trainer.optimizer.dims)}): {run_s:.3f} s for "
                  f"build, {DDP_STEPS} steps and the last full checkpoint (gathered, rank 0 "
                  f"writes, a barrier); per step K1 {K1_PER_TRAIN_STEP}, "
                  f"K1_wide {K1_WIDE_PER_TRAIN_STEP}, K2a and K2b {K2_SITES_PER_TRAIN_STEP} "
                  "each, no CUDA-core entry; losses "
                  f"{', '.join(f'{v:.6f}' for v in trainer.losses)} (bit-equal to [train_cli]'s); {len(saved['masters'])} fp32 masters "
                  f"bit-equal to [train_cli]'s {DDP_STEPS}.pt; step seconds (wait on the data "
                  "/ the rest) "
                  + ", ".join(f"{w:.3f}/{t - w:.3f}" for t, w in zip(trainer.step_seconds,
                                                                 trainer.wait_seconds))
                  + " ([train_cli]'s plain steps on the same batches " + ", ".join(
                      f"{w:.3f}/{t - w:.3f}" for t, w in zip(TRAIN_CLI_RUN["step_s"],
                                                             TRAIN_CLI_RUN["wait_s"]))
                  + "); the process group destroyed")
            del trainer
            torch.cuda.empty_cache()
        reduce = mesh.DataParallel.reduce

        def zeroed(self, grads, dims):
            return [torch.zeros_like(g) for g in reduce(self, grads, dims)]

        mesh.DataParallel.reduce = zeroed
        try:
            trainer, _, _, _ = run("false", "fault")
        finally:
            mesh.DataParallel.reduce = reduce
        mismatch = ddp_mismatch(trainer, saved)
        check("masters" in mismatch, "[train_ddp] the run with its reduced gradients "
              f"zeroed passed the masters' check: {mismatch}")
        print(f"[train_ddp] {card()} planted fault, the reduced gradients zeroed: "
              + "; ".join(mismatch.values()) + " (fails, as it must)")
        del trainer
        torch.cuda.empty_cache()
    finally:
        if saved_bpe is None:
            os.environ.pop("DIFFBIR_TPU_BPE_PATH", None)
        else:
            os.environ["DIFFBIR_TPU_BPE_PATH"] = saved_bpe
        tokenizer.get_tokenizer.cache_clear()
    return launches


def stage1_dataset(flist: str):
    """train_stage1.yaml's codeformer dataset on ``flist``."""
    from diffbir_tpu_torch import config as cfglib
    from diffbir_tpu_torch import dataset  # noqa: F401  (the registry names)

    cfg = cfglib.load_yaml(os.path.join("configs", "train", "train_stage1.yaml"))
    params = {**cfg["dataset"]["train"]["params"], "file_list": flist}
    return cfglib.instantiate({"target": "codeformer_dataset", "params": params})


def phase_train_native(flist: str) -> dict:
    """[train_native]: the codeformer dataset (train_stage1.yaml's) on the
    PNG folder with ``native=True`` where the C++ loader builds (``make -C
    native``): its centre crops equal to the Python path's, image for image,
    and the seconds a batch of each path; else the reason, and that the
    Python path ran. Returns the launch counts (none)."""
    import numpy as np

    from diffbir_tpu_torch.dataset.native_loader import (
        NativeImageLoader,
        native_available,
        native_status,
    )

    before = counts()
    t0 = time.perf_counter()
    available = native_available()
    build_s = time.perf_counter() - t0
    paths = [line.split("\t")[0] for line in open(flist).read().splitlines() if line]
    runs = {}
    for native in ((False, True) if available else (False,)):
        it = stage1_dataset(flist).as_iterator(NATIVE_BATCH, seed=231, native=native)
        seconds = []
        for _ in range(NATIVE_BATCHES):
            t0 = time.perf_counter()
            batch = next(it)
            seconds.append(time.perf_counter() - t0)
        it.close()
        check(batch["gt"].shape == batch["lq"].shape == (NATIVE_BATCH, SIZE, SIZE, 3),
              f"[train_native] native {native}: gt {batch['gt'].shape}")
        runs[native] = seconds
    if not available:
        print(f"[train_native] the native loader is unavailable here ({native_status()}): "
              f"train.native_loader falls back to the Python path, which ran: "
              f"{', '.join(f'{v:.3f}' for v in runs[False])} s a batch of {NATIVE_BATCH}")
    else:
        ds = stage1_dataset(flist)
        loader = NativeImageLoader(paths, NATIVE_BATCH, SIZE, crop="center", hflip=False,
                                   rot90=False, seed=231)
        imgs, idx = loader.next_with_idx()
        loader.close()
        for img, j in zip(imgs, idx):
            check(np.array_equal(img, ds._load_gt(paths[int(j)])),
                  f"[train_native] the native crop of {paths[int(j)]} differs from the Python "
                  "path's")
        print(f"[train_native] {card()} the native loader ({native_status()}, loaded or built "
              f"in {build_s:.2f} s): {NATIVE_BATCH} centre crops equal to the Python path's; "
              f"s a batch of {NATIVE_BATCH} (decode and crop, then the codeformer degradation "
              f"on the host): native {', '.join(f'{v:.3f}' for v in runs[True])}, Python "
              f"{', '.join(f'{v:.3f}' for v in runs[False])}")
    n = launched_since(before)
    check(not n, f"[train_native] launched {n}")
    return {k: 0 for k in KERNELS}


def stage1_step_peak(bs: int) -> float:
    """Peak GiB of one full-width stage-1 step at batch ``bs`` (bf16 SwinIR,
    fp32 masters, random data on the card)."""
    import torch

    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.swinir import SwinIR
    from diffbir_tpu_torch.train import stage1

    model = SwinIR(dtype=torch.bfloat16, device="meta").to_empty(device="cuda")
    random_init_(model, torch.Generator(device="cuda").manual_seed(0))
    step = stage1.make_train_step(model, stage1.init_train_state(model, 1e-4))
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {k: torch.rand(bs, SIZE, SIZE, 3, generator=gen, device="cuda")
             for k in ("gt", "lq")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    float(step(batch)["loss"])
    return torch.cuda.max_memory_allocated() / 2**30


def stage1_batch() -> tuple:
    """The first batch of STAGE1_BATCHES whose step fits below
    STAGE1_MEMORY_SHARE of the card, and what each try read."""
    import gc

    import torch

    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    tried = []
    for bs in STAGE1_BATCHES:
        try:
            peak = stage1_step_peak(bs)
        except torch.cuda.OutOfMemoryError:
            peak = None
        gc.collect()
        torch.cuda.empty_cache()
        tried.append(f"{bs}: " + ("out of memory" if peak is None else f"peak {peak:.2f} GiB"))
        if peak is not None and peak <= STAGE1_MEMORY_SHARE * total:
            return bs, tried, total
    check(False, f"[train_stage1] no batch fits: {tried}")


def phase_train_stage1() -> dict:
    """[train_stage1]: ``python -m diffbir_tpu_torch.train_stage1`` (``main``,
    in this process) on a copy of train_stage1.yaml at full width (SwinIR
    embed 180, depths 8x6, heads 6, window 8; the codeformer dataset at
    512^2), at the first batch of STAGE1_BATCHES that fits, on that many
    synthetic PNGs: STAGE1_WARMUP + STAGE1_TIMED steps, a validation over
    STAGE1_VAL batches and a checkpoint at the last step, then a resume from
    it (masters and AdamW moments bit-equal to the saved ones). Prints
    s/step, images/s, the wait on the data, the step's own work and peak
    memory; no kernel of the port may launch. Returns the launch counts."""
    import numpy as np
    import torch

    from diffbir_tpu_torch import train_stage1

    t0 = time.perf_counter()
    bs, tried, total = stage1_batch()
    probe_s = time.perf_counter() - t0
    print(f"[train_stage1] {card()} batch {bs} (one step of the full-width SwinIR at batch "
          + "; ".join(tried) + f", of {total:.1f} GiB; limit {STAGE1_MEMORY_SHARE:g} of it; "
          f"probed in {probe_s:.1f} s)")
    flist = write_train_folder(STAGE1_ROOT, bs)
    exp = os.path.join(STAGE1_ROOT, "exp")
    steps = STAGE1_WARMUP + STAGE1_TIMED
    cfg = os.path.join(STAGE1_ROOT, "train_stage1.yaml")
    edit_config(os.path.join("configs", "train", "train_stage1.yaml"), cfg,
                {"file_list": flist, "batch_size": bs, "train_steps": steps, "log_every": 1,
                 "val_every": steps, "ckpt_every": steps, "exp_dir": exp},
                label="train_stage1", repeated=("file_list",), added={"val_batches": STAGE1_VAL})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer = train_stage1.main(["--config", cfg])
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = counts()
    check(all(v == 0 for v in launches.values()), f"[train_stage1] launched {launches}")
    check(trainer.step == steps and np.isfinite(trainer.losses).all()
          and len(trainer.val_psnr) == 1 and np.isfinite(trainer.val_psnr[0]),
          f"[train_stage1] step {trainer.step}, losses {trainer.losses}, val {trainer.val_psnr}")
    ckpts = sorted(os.listdir(os.path.join(exp, "checkpoints")))
    check(ckpts == [f"{steps}.pt"], f"[train_stage1] checkpoints {ckpts}")
    timed = trainer.step_seconds[STAGE1_WARMUP:]
    waits = trainer.wait_seconds[STAGE1_WARMUP:]
    own = [a - b for a, b in zip(timed, waits)]
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"[train_stage1] python -m diffbir_tpu_torch.train_stage1 --config {cfg}: "
          f"{run_s:.3f} s (SwinIR {n_params / 1e6:.2f} M params, bf16 with fp32 masters, AdamW "
          f"weight decay 1e-4; {steps} steps, the validation, the checkpoint); losses "
          f"{', '.join(f'{v:.1f}' for v in trainer.losses)}; val psnr "
          f"{trainer.val_psnr[0]:.3f} dB over {STAGE1_VAL} batches; 0 launches of every "
          f"kernel of the port (window attention is plain math)")
    print(f"[train_stage1] {card()} batch {bs} at {SIZE}x{SIZE}: steps "
          f"{STAGE1_WARMUP + 1}-{steps} {', '.join(f'{v:.3f}' for v in timed)} s (median "
          f"{statistics.median(timed):.3f} s/step, {bs * len(timed) / sum(timed):.2f} images/s); "
          f"waiting on the data {', '.join(f'{v:.3f}' for v in waits)} s (median "
          f"{statistics.median(waits):.3f}); the step's own work "
          f"{', '.join(f'{v:.3f}' for v in own)} s (median {statistics.median(own):.3f}, "
          f"{bs / statistics.median(own):.2f} images/s); warm-up steps "
          f"{', '.join(f'{v:.3f}' for v in trainer.step_seconds[:STAGE1_WARMUP])} s; checkpoint "
          f"{os.path.getsize(os.path.join(exp, 'checkpoints', ckpts[0])) / 2**20:.1f} MiB in "
          f"{trainer.save_seconds[0]:.3f} s; peak device memory {peak:.2f} GiB")
    del trainer
    torch.cuda.empty_cache()

    saved = torch.load(os.path.join(exp, "checkpoints", ckpts[0]), map_location="cpu",
                       weights_only=True)
    resume_cfg = os.path.join(STAGE1_ROOT, "resume.yaml")
    edit_config(cfg, resume_cfg, {"resume": steps}, label="train_stage1")
    t0 = time.perf_counter()
    resumed = train_stage1.Stage1Trainer(train_stage1.cfglib.load_yaml(resume_cfg), "cuda")
    build_s = time.perf_counter() - t0
    opt = resumed.optimizer
    check(resumed.step == steps, f"[train_stage1] resumed at {resumed.step}")
    check(all(torch.equal(m.cpu(), s) for m, s in zip(opt.masters, saved["masters"])),
          "[train_stage1] the restored masters differ from the saved ones")
    moments = 0
    state = opt.optimizer.state_dict()["state"]
    for i, s in saved["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            check(torch.equal(state[i][key].cpu(), s[key]),
                  f"[train_stage1] the restored {key} of tensor {i} differs")
            moments += key != "step"
    print(f"[train_stage1] resume: {steps}: built in {build_s:.3f} s, {len(opt.masters)} fp32 "
          f"masters and {moments} AdamW moments bit-equal to {steps}.pt")
    del resumed, opt, saved
    torch.cuda.empty_cache()
    import shutil

    shutil.rmtree(STAGE1_ROOT, ignore_errors=True)
    return launches


def jpeg_ambiguous_pixels(x, quality):
    """Pixels [B, H, W] of the 8x8 luma blocks (16x16 for chroma) in which a
    DCT coefficient of ``diff_jpeg``'s arithmetic lies within JPEG_AMBIGUOUS
    quantisation steps of a rounding half (on ``x``'s device)."""
    import torch

    from diffbir_tpu_torch.ops import diffjpeg as dj

    b, h, w, _ = x.shape
    out = torch.zeros((b, h, w), dtype=torch.bool, device=x.device)
    for (steps, _, (hh, ww)), up in zip(dj.quantised_coefficients(x, quality), (1, 2, 2)):
        near = ((steps - steps.floor() - 0.5).abs() < JPEG_AMBIGUOUS).flatten(2).any(-1)
        near = near.reshape(b, hh // 8, ww // 8).repeat_interleave(8 * up, 1)
        out |= near.repeat_interleave(8 * up, 2)
    return out


def phase_degrade_batch() -> dict:
    """[degrade_batch]: ``ops/diffjpeg.py``'s diff_jpeg (hard and soft
    rounding) and ``dataset/degradation.py``'s add_gaussian_noise_batch,
    add_poisson_noise_batch, filter2d_batch and usm_sharp_batch at batch
    DEGRADE_BATCH, SIZE x SIZE, fp32 with TF32 off, on the card against the
    CPU (see DEGRADE_TOL's notes); diff_jpeg with the luma table transposed
    must fail the limit; ms a batch. Returns the launch counts (none)."""
    import torch

    from diffbir_tpu_torch.dataset import degradation as deg
    from diffbir_tpu_torch.ops import diffjpeg

    before = counts()
    gen = torch.Generator().manual_seed(16)
    b = DEGRADE_BATCH
    img = torch.rand(b, SIZE, SIZE, 3, generator=gen)
    quality = torch.tensor(JPEG_QUALITIES[:b])
    sigma = torch.linspace(0.01, 0.2, b)
    gray = torch.arange(b) % 2 == 1
    draws = {"rgb": torch.randn(img.shape, generator=gen),
             "gray": torch.randn((b, SIZE, SIZE, 1), generator=gen)}
    kernels = torch.rand(b, 21, 21, generator=gen)
    kernels /= kernels.sum(dim=(1, 2), keepdim=True)
    scale = torch.linspace(0.5, 3.0, b)

    def cuda(*ts):
        return [t.cuda() for t in ts]

    def limit(ref):
        return DEGRADE_TOL * float(ref.abs().max())

    rows = []
    ambiguous = jpeg_ambiguous_pixels(img, quality)
    for soft in (False, True):
        ref = diffjpeg.diff_jpeg(img, quality, soft)
        out = diffjpeg.diff_jpeg(*cuda(img, quality), soft).cpu()
        err = float(((out - ref).abs().amax(-1))[~ambiguous].max())
        table = diffjpeg.Y_TABLE
        diffjpeg.Y_TABLE = table.T.copy()
        try:
            faulty = diffjpeg.diff_jpeg(*cuda(img, quality), soft).cpu()
        finally:
            diffjpeg.Y_TABLE = table
        fault = float(((faulty - ref).abs().amax(-1))[~ambiguous].max())
        check(err <= limit(ref), f"[degrade_batch] diff_jpeg(differentiable={soft}): {err:.3e}")
        check(fault > limit(ref), f"[degrade_batch] the transposed luma table reads {fault:.3e}")
        x, q = cuda(img, quality)
        rows.append((f"diff_jpeg(differentiable={soft})", err / float(ref.abs().max()),
                     median_ms(lambda: diffjpeg.diff_jpeg(x, q, soft), iters=10),
                     f"transposed luma table {fault / float(ref.abs().max()):.3e}"))
    blocks = int(ambiguous[:, ::8, ::8].sum())
    ref = deg.add_gaussian_noise_batch(img, sigma, gray, draws=draws)
    args = cuda(img, sigma, gray)
    dd = {k: v.cuda() for k, v in draws.items()}
    out = deg.add_gaussian_noise_batch(*args, draws=dd).cpu()
    err = float((out - ref).abs().max())
    check(err <= limit(ref), f"[degrade_batch] add_gaussian_noise_batch: {err:.3e}")
    rows.append(("add_gaussian_noise_batch (the same draws)", err / float(ref.abs().max()),
                 median_ms(lambda: deg.add_gaussian_noise_batch(*args, draws=dd), iters=10), ""))
    ref = deg.add_poisson_noise_batch(img, scale, gray, generator=torch.Generator().manual_seed(1))
    cgen = torch.Generator(device="cuda").manual_seed(1)
    pargs = cuda(img, scale, gray)
    out = deg.add_poisson_noise_batch(*pargs, generator=cgen).cpu()
    ratio = [float((out[i] - img[i]).std() / (ref[i] - img[i]).std()) for i in range(b)]
    check(all(abs(r - 1) <= POISSON_STD_TOL for r in ratio) and 0 <= float(out.min())
          and float(out.max()) <= 1, f"[degrade_batch] add_poisson_noise_batch std ratios {ratio}")
    rows.append(("add_poisson_noise_batch (the card's draws)", float("nan"),
                 median_ms(lambda: deg.add_poisson_noise_batch(*pargs, generator=cgen), iters=10),
                 f"noise std / the CPU's {min(ratio):.4f}-{max(ratio):.4f}"))
    ref = deg.filter2d_batch(img, kernels)
    fargs = cuda(img, kernels)
    out = deg.filter2d_batch(*fargs).cpu()
    err = float((out - ref).abs().max())
    check(err <= limit(ref), f"[degrade_batch] filter2d_batch: {err:.3e}")
    rows.append(("filter2d_batch (21x21)", err / float(ref.abs().max()),
                 median_ms(lambda: deg.filter2d_batch(*fargs), iters=10), ""))
    (x,) = cuda(img)
    out = deg.usm_sharp_batch(x).cpu()
    ref = deg.usm_sharp_batch(img)
    # the CPU's arithmetic on the card's mask: where |residual| x 255 ties
    # the threshold, summation order decides the mask
    kern = deg.usm_kernel().expand(b, -1, -1)
    res_cpu = img - deg.filter2d_batch(img, kern)
    res_card = (x - deg.filter2d_batch(x, deg.usm_kernel(device=x.device).expand(b, -1, -1))
                ).cpu()
    mask_card = (res_card.abs() * 255.0 > 10.0).float()
    flips = int((mask_card != (res_cpu.abs() * 255.0 > 10.0).float()).sum())
    soft_mask = deg.filter2d_batch(mask_card, kern)
    on_mask = soft_mask * torch.clamp(img + 0.5 * res_cpu, 0, 1) + (1 - soft_mask) * img
    err = float((out - on_mask).abs().max())
    check(err <= limit(ref), f"[degrade_batch] usm_sharp_batch: {err:.3e}")
    rows.append(("usm_sharp_batch (51 taps)", err / float(ref.abs().max()),
                 median_ms(lambda: deg.usm_sharp_batch(x), iters=10),
                 f"{flips} mask elements of {mask_card.numel()} on the other side of the "
                 f"threshold on the CPU"))
    n = launched_since(before)
    check(not n, f"[degrade_batch] launched {n}")
    print(f"[degrade_batch] {card()} batch {b} at {SIZE}x{SIZE} fp32, TF32 off, the card "
          f"against the CPU (limit {DEGRADE_TOL:g} x max|ref|; diff_jpeg without the {blocks} "
          f"luma blocks where a coefficient of the CPU's lies within {JPEG_AMBIGUOUS:g} steps "
          f"of a rounding half); 0 launches of the port's kernels:")
    for name, rel, ms, note in rows:
        print(f"[degrade_batch]   {name}: {rel:.3e} x max|ref|, {ms:.3f} ms a batch"
              + (f"; {note}" if note else ""))
    return {k: 0 for k in KERNELS}


# --------------------------------------------------------------------------- #
# [parallel_inference], [parallel_nccl]: parallel/inference.py and tp.py
# --------------------------------------------------------------------------- #
# PAR_WORLD processes on this card over gloo (nccl refuses two ranks on one
# device; gloo stages CUDA tensors through the host), the DIFFBIR_* launch
# contract, each done within PAR_TIMEOUT s. Inputs and outputs pass through
# PAR_ROOT. (a) SP: the denoiser on PAR_SP_HW^2 (the 1024x1024 request's
# latent), one band a process; (b) TP: the hoisted denoiser at batch 2 on
# PAR_TP_HW^2 (the 512x512 request's, cond and uncond rows); (c) the tiled
# 1024x1024 request's 9 diffusion tiles (PAR_TILE at PAR_STRIDE), 5 a
# process, one of them padded; (d) two CLI-size requests (128x128 LQs
# pre-upscaled x4 to 512x512, CLI_STEPS of edm_dpm++_3m_sde at PAR_CFG, the
# default prompts through the stand-in tokenizer), one a process.
PAR_WORLD, PAR_TIMEOUT = 2, 300
PAR_ROOT = os.path.join("build", "parallel_inference")
PAR_SP_HW, PAR_TP_HW = TILED_SIZE // 8, SIZE // 8
PAR_TILE, PAR_STRIDE = 64, 32
PAR_CFG, PAR_T, PAR_SEED = 6.0, 500.0, 17
# (a)'s condition latent ramps from +PAR_RAMP at the top row to -PAR_RAMP at
# the bottom one, as a photo's sky and ground differ: with i.i.d. inputs the
# two bands' GroupNorm statistics agree to ~1 % and a band that kept its own
# would hide in bf16's rounding
PAR_RAMP = 2.0
# Limits x max|ref|, each set from the port's own bf16 rounding-order spread
# on the same weights and inputs in one process (printed beside every
# reading): (a) the forward as row 1 of a batch of 2, (b) its rows swapped,
# (c) the tiles 3 a call instead of 1, (d) the two requests with their rows
# swapped. cuDNN's bf16 convolutions round a row by its batch position and
# batch size, and the processes sum band statistics, partial products and
# canvases in another order. Measured on an H100 80GB HBM3 at 700 W: the
# spreads 1.15e-2-1.33e-2 for (a)-(c) and 5.1e-2 for (d) (13 of 255); the
# two processes 1.3e-2-1.5e-2 and 4.7e-2; (a) at one process on nccl 2.8e-2.
# The limits are ~5x the spreads; the planted faults read 2.3-8.8x them.
PAR_TOL = {"sp": 4 * BF16_TOL, "tp": 4 * BF16_TOL, "tiles": 4 * BF16_TOL, "batch": 0.25}
# (e)-(i): every model of the restoration path banded. (e) SwinIR
# (v2.1 widths) on the 1024x1024 request's pre-upscaled input (a seeded
# TILED_LQ^2 LQ, bicubic x4): two bands of 512 rows; (f) the VAE at
# TILED_SIZE^2: the moments ("encode"), a posterior sample whose eps is
# drawn for the whole latent ("sample") and the decode of a 128x128 latent,
# K1_wide once a process each at PAR_WIDE; (g) SCUNet on a SIZE^2 input,
# BSRNet on a CLEANER_LQ^2 LQ (x4: 1024^2 out); (h) SwinIR tensor-parallel
# at SIZE^2 (3 heads a process); (i) the whole 1024x1024 sr request banded
# from end to end (spatial_parallel_request): SwinIR, encode,
# PAR_REQ_STEPS steps of edm_dpm++_3m_sde at PAR_CFG (the CLI's default is
# CLI_STEPS), decode, gather, colour fix, against SwinIRPipeline.run on the
# same x_T and noise table. One process's spread: the larger of the run as
# row 1 of a batch of 2 and the run on its input in the other memory layout
# (see par_model_references); the request's, as row 1 of 2. Measured on an
# H100 80GB HBM3 at 700 W: the spreads 6.4e-3-2.6e-2 for (e)-(h) and 0.102
# for (i) (26 of 255: 2 steps of random weights); the two processes
# 6.4e-3-2.6e-2 and 9.8e-2. The limits are 2.4-10x the spreads (4 x BF16_TOL,
# as above; (i) ~5x); the planted faults read 3.0-8.0x them.
PAR_REQ_STEPS = 2
PAR_MODELS = ("swinir", "encode", "sample", "decode", "scunet", "bsrnet", "tp_swinir")
PAR_WIDE = ((1, TILED_SIZE ** 2 // 64 // PAR_WORLD, 1, 512), (1, TILED_SIZE ** 2 // 64, 1, 512))
PAR_TOL.update({name: 4 * BF16_TOL for name in PAR_MODELS}, request=0.5)
# (j): the serving modes, (a)'s SP call and (b)'s TP call in each, against
# one process in the same mode, each spread as (a)'s and (b)'s. A process's
# launches: K3 at every self-attention site (the whole image's tokens pick
# the packed route, a band's queries against every band's k and v under
# SP; this process's heads under TP), K6 at every ResBlock (whole: gathered
# under SP, unsharded under TP), K7 at every FFN in the fused mode; K4 in
# the int8 mode at every dense site of an unhoisted call under SP (the 32
# timestep rows of batch 1 on the GEMV form), a hoisted step and its
# tables under TP (the tile form throughout). Measured on an H100 80GB HBM3
# at 700 W: one process's spreads 9.9e-3-1.10e-2; the two processes
# 1.18e-2-1.42e-2, and TP int8 0 (bit-equal: the int8 mode shards only the
# CLIP tower, and the call takes its text context whole). The limits
# (4 x BF16_TOL) are 5.7-6.3x the spreads; the planted fault (K6 on the band
# alone) reads 3.5x its limit.
PAR_MODES = ("fused", "int8")
PAR_MODE_LAUNCHES = {
    "sp_fused": {"K3": K3_PER_CALL, "K6": K6_PER_CALL, "K7": K7_PER_CALL},
    "tp_fused": {"K3": K3_PER_CALL, "K6": K6_PER_CALL, "K7": K7_PER_CALL},
    "sp_int8": {"K3": K3_PER_CALL, "K4": K4_TILE_PER_CALL, "K4_gemv": K4_GEMV_PER_CALL,
                "K6": K6_PER_CALL},
    "tp_int8": {"K3": K3_PER_CALL, "K4": K4_PER_STEP + K4_PER_HOIST, "K6": K6_PER_CALL},
}
PAR_TOL.update({name: 4 * BF16_TOL for name in PAR_MODE_LAUNCHES})


def par_k1_shapes(kind: str) -> dict:
    """(q shape, k shape) -> launches of K1 in one process's model call of
    ``kind``: "sp" (the bands of PAR_SP_HW^2 against every band's k/v),
    "request" ((i): the same at batch 2 for each step, and K1_wide's two),
    "tp" (batch 2 at PAR_TP_HW^2, a level's heads split where they
    divide; "tp_int8": every head, the int8 mode's attention is whole),
    "tiles" (5 tiles of PAR_TILE^2)."""
    from collections import Counter

    out = Counter()
    if kind == "request":  # (i): the bands at batch 2 (CFG), PAR_REQ_STEPS steps
        out[PAR_WIDE] = 2
    for tokens, width, sites in LEVELS:
        heads = width // 64
        if kind in ("sp", "request"):
            s = tokens * (PAR_SP_HW // 64) ** 2
            b, n = (1, sites) if kind == "sp" else (2, sites * PAR_REQ_STEPS)
            out[((b, s // PAR_WORLD, heads, 64), (b, s, heads, 64))] += n
        elif kind in ("tp", "tp_int8"):
            h = heads // PAR_WORLD if kind == "tp" and heads % PAR_WORLD == 0 else heads
            s = tokens * (PAR_TP_HW // 64) ** 2
            out[((2, s, h, 64), (2, s, h, 64))] += sites
        else:
            per = -(-CLDM_TILES // PAR_WORLD)
            s = tokens * (PAR_TILE // 64) ** 2
            out[((per, s, heads, 64), (per, s, heads, 64))] += sites
    return dict(out)


def par_request(pipe, rows):
    """The CLI-size request of [parallel_inference] (d) on ``rows``."""
    from diffbir_tpu_torch.profile_step import NEG_PROMPT, POS_PROMPT

    return pipe.run(rows["lq"], steps=CLI_STEPS, cfg_scale=PAR_CFG,
                    sampler_type="edm_dpm++_3m_sde", pos_prompt=POS_PROMPT,
                    neg_prompt=NEG_PROMPT, x_T=rows["x_T"], noise_table=rows["noise"])


def par_swapped(tree: dict, axes: dict = None) -> dict:
    """The two rows of every entry of ``tree`` swapped (along ``axes``)."""
    axes = axes or {}
    return {k: v[:, [1, 0]] if axes.get(k) == 1 else v[[1, 0]] for k, v in tree.items()}


def par_cuda(tree: dict) -> dict:
    return {k: v.cuda() if hasattr(v, "cuda") else v for k, v in tree.items()}


def par_sp_call(cldm, sp: dict):
    """(a): the spatial-parallel denoiser on this process's bands of the
    inputs, gathered."""
    from diffbir_tpu_torch.parallel import inference

    fn = inference.spatial_parallel(cldm)
    cond = {"c_txt": sp["c_txt"], "c_img": inference.spatial_shard(sp["c_img"])}
    return inference.gather(fn(inference.spatial_shard(sp["x"]), sp["t"], cond)).float()


def par_tiles_call(cldm, sp: dict, sharded: bool, per: int = 1):
    """(c): the 9 tiles of the tiled request's diffusion model call over
    the SP inputs, tile-sharded or (``sharded`` False) by make_tiled_fn at
    ``per`` tiles a call."""
    from diffbir_tpu_torch import pipeline, tiling
    from diffbir_tpu_torch.parallel import inference

    fn = pipeline.tile_model_function(cldm, 1.0, PAR_TILE)
    tiled = (inference.make_tile_sharded_fn(fn, PAR_TILE, PAR_STRIDE, channel=4) if sharded
             else tiling.make_tiled_fn(fn, PAR_TILE, PAR_STRIDE, channel=4, tiles_per_batch=per))
    return tiled(sp["x"], PAR_T, {"c_txt": sp["c_txt"], "c_img": sp["c_img"]})


def par_tp_call(cldm, d: dict, tables=None):
    """(b): the denoiser through its hoisted tables (made now unless given)."""
    from diffbir_tpu_torch.pipeline import model_function

    if tables is None:
        tables = cldm.make_hoist_tables(d["c_txt"], d["grid"])
    return model_function(cldm, 1.0, tables)(
        d["x"], d["t"], {"c_txt": d["c_txt"], "c_img": d["c_img"]}).float()


def par_k6_band_alone(m, group, x, emb, emb_out=None):
    """The fused ResBlock's K6 on this band's rows, without the gather."""
    from diffbir_tpu_torch.models.unet import ResBlock

    return ResBlock.forward(m, x, emb, emb_out)


def par_weights(model) -> int:
    """Weights a process holds: parameters and int8 weight buffers."""
    return sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for name, b in model.named_buffers()
        if name.endswith(("weight_q", "weight_scale")))


def par_zero_halos(x, group, below):
    zero = x.new_zeros(x[:, :, :1].shape)
    return zero, zero if below else None


def par_local_moments(xf, group):
    axes = tuple(range(2, xf.dim()))
    mean = xf.mean(dim=axes, keepdim=True)
    return mean, ((xf - mean) ** 2).mean(dim=axes, keepdim=True)


def par_cleaners(seed: int = 0) -> dict:
    """Full-width SCUNet and BSRNet (RRDBNet x4), bf16, random from ``seed``."""
    import torch

    from diffbir_tpu_torch.models.bsrnet import RRDBNet
    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.scunet import SCUNet

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {name: random_init_(cls(dtype=torch.bfloat16, device="meta").to_empty(
        device="cuda"), gen).eval() for name, cls in (("scunet", SCUNet), ("bsrnet", RRDBNet))}


def par_model_call(name: str, models: dict, d: dict):
    """(e)-(h): ``name``'s model on this process's band of its input (the
    whole input for "tp_swinir"), gathered, fp32 NHWC; without a process
    group the plain model."""
    import torch

    from diffbir_tpu_torch.parallel import inference

    shard, gather = inference.spatial_shard, inference.gather
    cldm = models["cldm"]
    if name == "tp_swinir":
        return models["swinir"](d["tp_swinir"]).float()
    if name in ("swinir", "scunet", "bsrnet"):
        return gather(inference.spatial_parallel(models[name])(shard(d[name]))).float()
    if name == "encode":
        band = shard(d["image"]).permute(0, 3, 1, 2)
        moments = inference.spatial_parallel(cldm.vae).encode_moments(band)
        return gather(torch.cat(moments, dim=1).permute(0, 2, 3, 1)).float()
    fn = inference.spatial_parallel(cldm)
    if name == "sample":
        return gather(fn.vae_encode(shard(d["image"]), eps=d["eps"])).float()
    return gather(fn.vae_decode(shard(d["z"]))).float()


def par_big_request(pipe, d: dict, group_run: bool):
    """(i): the 1024x1024 request, banded (``group_run``) or by
    ``pipe.run``."""
    from diffbir_tpu_torch.parallel import inference
    from diffbir_tpu_torch.profile_step import NEG_PROMPT, POS_PROMPT

    kw = dict(steps=PAR_REQ_STEPS, cfg_scale=PAR_CFG, sampler_type="edm_dpm++_3m_sde",
              pos_prompt=POS_PROMPT, neg_prompt=NEG_PROMPT, x_T=d["x_T"],
              noise_table=d["noise"])
    if group_run:
        return inference.spatial_parallel_request(pipe, d["lq"], **kw)
    return pipe.run(d["lq"], **kw)


def par_open_roll(real):
    """The cyclic exchange without its wrap: zeros where the rows of the
    image's other end should enter."""
    def roll(y, group, shift):
        import torch
        import torch.distributed as dist

        out, s = real(y, group, shift), abs(shift)
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        if shift < 0 and rank == n - 1:
            return torch.cat([out[:, :-s], out[:, -s:] * 0], dim=1)
        if shift > 0 and rank == 0:
            return torch.cat([out[:, :s] * 0, out[:, s:]], dim=1)
        return out

    return roll


def par_last_band(real):
    """Every band's window rows of the mask taken as the last band's."""
    import torch.distributed as dist

    return lambda h, group: real(h, group)._replace(row0=(dist.get_world_size(group) - 1) * h)


def par_row_above(x, group):
    """The VAE Downsample's halo row from the band above (zeros over the
    first) in place of the row below."""
    from diffbir_tpu_torch.parallel import inference

    return inference._halo_rows(x, group, below=False)[0]


@contextlib.contextmanager
def par_planted(module, name: str, fault):
    """``module.name`` replaced by ``fault`` while in this context."""
    real = getattr(module, name)
    setattr(module, name, fault)
    try:
        yield
    finally:
        setattr(module, name, real)


def parallel_worker(rank: int, port: int) -> None:
    """One process of [parallel_inference]: the DIFFBIR_* launch contract on
    127.0.0.1:``port``, gloo on this card; its models built while the main
    process writes PAR_ROOT/inputs.pt and computes the references; the runs
    on those inputs, each with its launches, K1's shapes, seconds and
    peak memory, then the planted faults; (e)-(i) before TP shards the
    models; the results to
    PAR_ROOT/rank<rank>.pt. Rank 1 builds its models from another seed:
    (d)'s broadcast makes them rank 0's, which the later runs use."""
    import copy
    from collections import Counter

    import torch

    from diffbir_tpu_torch.ops import flash_attention as fa
    from diffbir_tpu_torch.parallel import distributed, inference, tp
    from diffbir_tpu_torch.pipeline import SwinIRPipeline
    from diffbir_tpu_torch.profile_step import stand_in_tokenizer
    from diffbir_tpu_torch.schedule import Schedule

    os.environ.update(DIFFBIR_COORDINATOR=f"127.0.0.1:{port}",
                      DIFFBIR_NUM_PROCESSES=str(PAR_WORLD), DIFFBIR_PROCESS_ID=str(rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fill_kernels()
    check(distributed.maybe_initialize_distributed("cuda", backend="gloo"),
          "[parallel_inference] no process group from the launch environment")
    shapes = Counter()
    launch_fwd = fa.launch_fwd

    def recording_launch(kernel, q, k, v, with_lse=False):
        shapes.update([(tuple(q.shape), tuple(k.shape))])
        return launch_fwd(kernel, q, k, v, with_lse)

    fa.launch_fwd = recording_launch
    out = {}

    def run(name: str, fn):
        reset_counts()
        shapes.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t0,
                     "peak": torch.cuda.max_memory_allocated() / 2**30,
                     "above": (torch.cuda.max_memory_allocated() - resident) / 2**30,
                     "launches": {k: n for k, n in counts().items() if n},
                     "shapes": dict(shapes)}
        return res

    try:
        cldm, swinir = build_models(seed=rank)
        inp = par_inputs()
        sp, tpd = par_cuda(inp["sp"]), par_cuda(inp["tp"])
        both = torch.nn.ModuleList([cldm, swinir])
        rows = run("broadcast", lambda: inference.shard_for_batch_parallel(
            both, par_cuda(inp["batch"]), batch_axes={"noise": 1})[1])
        pipe = SwinIRPipeline(swinir, cldm, Schedule.v21(), torch.device("cuda"),
                              tokenizer=stand_in_tokenizer())
        out["batch_out"] = run("batch", lambda: inference.batch_parallel(
            lambda r: par_request(pipe, r))(rows))
        with torch.no_grad():
            out["sp_out"] = run("sp", lambda: par_sp_call(cldm, sp)).cpu()
            with par_planted(inference, "_halo_rows", par_zero_halos):
                out["sp_zero_halos"] = par_sp_call(cldm, sp).cpu()
            with par_planted(inference, "_band_moments", par_local_moments):
                out["sp_local_gn"] = par_sp_call(cldm, sp).cpu()
            out["tiles_out"] = run("tiles", lambda: par_tiles_call(cldm, sp, True)).cpu()
            models = {"cldm": cldm, "swinir": swinir, **par_cleaners()}
            big = par_cuda(inp["models"])
            for name in PAR_MODELS[:-1]:
                out[f"{name}_out"] = run(name, lambda: par_model_call(name, models, big)).cpu()
            for key, attr, fault, name in (
                    ("swinir_open_roll", "_roll_rows", par_open_roll, "swinir"),
                    ("swinir_last_band", "_band", par_last_band, "swinir"),
                    ("encode_row_above", "_row_below", lambda real: par_row_above, "encode")):
                with par_planted(inference, attr, fault(getattr(inference, attr))):
                    out[key] = par_model_call(name, models, big).cpu()
            out["request_out"] = run("request", lambda: par_big_request(pipe, par_cuda(
                inp["request"]), True))
            for mode in PAR_MODES:  # (j): copies, since set_mode("int8") and TP work in place
                model = copy.deepcopy(cldm).set_mode(mode)
                if mode == "fused":  # first: K6's HWIO weight copies are made here
                    with par_planted(inference, "_band_fused_resblock", par_k6_band_alone):
                        out["sp_fused_band_alone"] = par_sp_call(model, sp).cpu()
                out[f"sp_{mode}_out"] = run(f"sp_{mode}", lambda: par_sp_call(model, sp)).cpu()
                run(f"tp_shard_{mode}", lambda: tp.tp_shard_(model))
                out[f"tp_{mode}_out"] = run(f"tp_{mode}", lambda: par_tp_call(model, tpd)).cpu()
                out[f"tp_{mode}_weights"] = par_weights(model)
                del model
            run("tp_shard", lambda: tp.tp_shard_(cldm))
            out["tp_out"] = run("tp", lambda: par_tp_call(cldm, tpd)).cpu()
            with par_planted(tp, "_reduce_partial", lambda t, group: t):
                out["tp_no_reduce"] = par_tp_call(cldm, tpd).cpu()
            run("tp_swinir_shard", lambda: tp.tp_shard_(swinir))
            out["tp_swinir_out"] = run("tp_swinir", lambda: par_model_call(
                "tp_swinir", models, big)).cpu()
        out["tp_weights"] = par_weights(cldm)
        out["tp_swinir_weights"] = sum(p.numel() for p in swinir.parameters())
        torch.save(out, os.path.join(PAR_ROOT, f"rank{rank}.pt"))
    finally:
        fa.launch_fwd = launch_fwd
        distributed.shutdown_distributed()


def par_inputs() -> dict:
    """PAR_ROOT/inputs.pt once the main process has written it (within
    PAR_TIMEOUT s)."""
    import torch

    path = os.path.join(PAR_ROOT, "inputs.pt")
    deadline = time.monotonic() + PAR_TIMEOUT
    while not os.path.exists(path):
        check(time.monotonic() < deadline, f"[parallel_inference] no {path} in {PAR_TIMEOUT} s")
        time.sleep(0.2)
    return torch.load(path, weights_only=False)


def kill_workers(procs: list) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()


def start_workers(target, world: int) -> list:
    """``target(rank, port)`` started in ``world`` fresh processes."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, port)) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_workers(procs: list, timeout: float, label: str) -> None:
    """Each of ``procs`` must exit 0 within ``timeout`` s, else every one is
    killed and the phase fails."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    check(not alive, f"{label} {len(alive)} of {len(procs)} processes not done in {timeout} s")
    codes = [p.exitcode for p in procs]
    check(codes == [0] * len(procs), f"{label} the processes exited {codes}")


def spread(label: str, out, ref) -> float:
    """max |out - ref| / max |ref|: the rounding-order spread of one
    process's run, printed."""
    rel = (out.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
    print(f"[parallel_inference] spread of {label}: {rel:.3e} x max|ref|")
    return rel


def par_k1_bands() -> None:
    """K1 at the SP bands' shapes (q one band, k and v every band's): one
    launch of K1 each, o against the plain version (BF16_TOL x max|ref|),
    median ms of K1, the plain version and SDPA beside the bound."""
    import torch

    from diffbir_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    for ((b, sq, h, d), (_, skv, _, _)), sites in par_k1_shapes("sp").items():
        q, k, v = qkv_case(gen, (b, sq, skv, h, d), torch.bfloat16)
        before = counts()
        o = fa.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        n = launched_since(before)
        check(n == {"K1": 1}, f"[parallel_inference] K1 at a band shape launched {n}")
        label = f"[parallel_inference] K1 {b}x{sq}x{h}x{d} vs {skv} kv rows bf16"
        err = hold(label, o, fa.flash_attention_ref(q, k, v), BF16_TOL)
        ms = median_ms(lambda: fa.flash_attention_fwd(q, k, v), 10)
        plain_ms = median_ms(lambda: fa.flash_attention_ref(q, k, v), 5)
        lib_ms = median_ms(lambda: sdpa_fwd(q, k, v), 10)
        bms, by = bound_ms(2, b, h, sq, skv, d, torch.bfloat16, nbytes(q, k, v, o))
        print(f"{label} (the SP band, {sites} sites a call): max_abs_err {err:.3e}; "
              f"{card()} K1 {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({by})")


def par_k3_band() -> None:
    """K3 at (a)'s first band shape in the packed layout (q one band, k and
    v every band's): one launch of K3, o against the plain version
    (``flash_attention_ref(..., prescale_q=True)``, BF16_TOL x max|ref|),
    median ms of K3, the plain version and SDPA beside the bound."""
    import torch

    from diffbir_tpu_torch.ops import flash_attention as fa

    ((b, sq, h, d), (_, skv, _, _)), sites = next(iter(par_k1_shapes("sp").items()))
    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    q, k, v = qkv_case(gen, (b, sq, skv, h, d), torch.bfloat16)
    before = counts()
    o = fa.flash_attention_fwd(q, k, v, prescale_q=True)
    torch.cuda.synchronize()
    n = launched_since(before)
    check(n == {"K3": 1}, f"[parallel_inference] K3 at a band shape launched {n}")
    label = f"[parallel_inference] K3 {b}x{sq}x{h}x{d} vs {skv} kv rows bf16"
    err = hold(label, o, fa.flash_attention_ref(q, k, v, prescale_q=True), BF16_TOL)
    ms = median_ms(lambda: fa.flash_attention_fwd(q, k, v, prescale_q=True), 10)
    plain_ms = median_ms(lambda: fa.flash_attention_ref(q, k, v, prescale_q=True), 5)
    lib_ms = median_ms(lambda: sdpa_fwd(q, k, v), 10)
    bms, by = bound_ms(2, b, h, sq, skv, d, torch.bfloat16, nbytes(q, k, v, o))
    print(f"{label} (the SP band in the packed layout, {sites} sites a call): max_abs_err "
          f"{err:.3e}; {card()} K3 {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
          f"bound {bms:.4f} ms ({by})")


def par_k1_wide_band() -> None:
    """K1_wide at the VAE's banded shape (PAR_WIDE: a band's queries against
    the gathered kv rows): one launch of K1_wide, o against the plain
    version (BF16_TOL x max|ref|), median ms of K1_wide, the plain version
    and SDPA (its backend named) beside the bound."""
    import torch

    from diffbir_tpu_torch.ops import flash_attention as fa

    (b, sq, h, d), (_, skv, _, _) = PAR_WIDE
    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    q, k, v = qkv_case(gen, (b, sq, skv, h, d), torch.bfloat16)
    before = counts()
    o = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    n = launched_since(before)
    check(n == {"K1_wide": 1}, f"[parallel_inference] K1_wide at the band launched {n}")
    label = f"[kernel] K1_wide {b}x{sq}x{h}x{d} vs {skv} kv rows bf16"
    err = hold(label, o, fa.flash_attention_ref(q, k, v), BF16_TOL)
    ms = median_ms(lambda: fa.flash_attention_fwd(q, k, v), 10, 2)
    plain_ms = median_ms(lambda: fa.flash_attention_ref(q, k, v), 3, 1)
    lib = sdpa_fwd(q, k, v)
    backends = sdpa_backends(q, k, v, lib)
    lib_ms = median_ms(lambda: sdpa_fwd(q, k, v), 10, 2)
    bms, by = bound_ms(2, b, h, sq, skv, d, torch.bfloat16, nbytes(q, k, v, o))
    print(f"{label} (a band of the 1024x1024 VAE's mid-block, (f) and (i)): max_abs_err "
          f"{err:.3e} ({BF16_TOL:g} x max|ref|); {card()} {ms:.4f} ms "
          f"({4.0 * b * h * sq * skv * d / 1e9 / ms:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
          f"library (SDPA, backend {'/'.join(backends) or 'not identified'}) {lib_ms:.4f} ms, "
          f"bound {bms:.4f} ms ({by}; {bms / ms:.1%} of it)")
    del q, k, v, o, lib
    torch.cuda.empty_cache()


def par_model_inputs(gen) -> tuple:
    """The inputs of (e)-(h) and of (i) (CPU tensors; (i)'s LQ uint8)."""
    import numpy as np
    import torch

    from diffbir_tpu_torch.utils.common import pil_bicubic_resize

    lq = np.random.default_rng(PAR_SEED + 1).integers(0, 256, (TILED_LQ, TILED_LQ, 3),
                                                      dtype=np.uint8)
    big = pil_bicubic_resize(torch.from_numpy(lq), (TILED_SIZE, TILED_SIZE))[None]
    lat = TILED_SIZE // 8
    models = {"swinir": big.float() / 255.0, "image": big.float() / 127.5 - 1.0,
              "eps": torch.randn(1, lat, lat, 4, generator=gen),
              "z": torch.randn(1, lat, lat, 4, generator=gen),
              "scunet": torch.rand(1, SIZE, SIZE, 3, generator=gen),
              "bsrnet": torch.rand(1, CLEANER_LQ, CLEANER_LQ, 3, generator=gen),
              "tp_swinir": torch.rand(1, SIZE, SIZE, 3, generator=gen)}
    request = {"lq": big.numpy(), "x_T": torch.randn(1, lat, lat, 4, generator=gen),
               "noise": torch.randn(PAR_REQ_STEPS, 1, lat, lat, 4, generator=gen)}
    return models, request


def par_model_references(st: dict, models: dict, big: dict, request: dict) -> None:
    """(e)-(i) in one process: the results, their spreads and the peak
    memory, into ``st``. A model's spread is the larger of two: the run as
    row 1 of a batch of 2, and the run on its input in the other memory
    layout (NCHW where the model permutes NHWC, so cuDNN takes other
    kernels; the VAE's encoder rounds a row alike at batch 1 and 2)."""
    import torch

    two = {k: v.repeat(2, *[1] * (v.dim() - 1)) for k, v in big.items()}
    other = {k: v.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1) for k, v in big.items()}
    for name in PAR_MODELS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ref = st[f"{name}_ref"] = par_model_call(name, models, big)
            st[f"{name}_peak"] = torch.cuda.max_memory_allocated() / 2**30
            st[f"{name}_spread"] = max(
                spread(f"({name}), the run as row 1 of 2",
                       par_model_call(name, models, two)[1:], ref),
                spread(f"({name}), the input in the other memory layout",
                       par_model_call(name, models, other), ref))
    pipe = st["pipe"]
    st["request_ref"] = torch.from_numpy(par_big_request(pipe, request, False))
    rows = {"lq": request["lq"].repeat(2, 0), "x_T": request["x_T"].repeat(2, 1, 1, 1),
            "noise": request["noise"].repeat(1, 2, 1, 1, 1)}
    st["request_spread"] = spread("(request), the request as row 1 of 2", torch.from_numpy(
        par_big_request(pipe, rows, False))[1:], st["request_ref"])


def parallel_references() -> dict:
    """PAR_WORLD parallel_worker processes started (``st["procs"]``, joined
    by ``phase_parallel_inference``), and beside them: the parent's models
    (seed 0), the inputs of the runs (written to PAR_ROOT/inputs.pt, which
    the workers wait for), one process's results on them and their
    spreads."""
    os.makedirs(PAR_ROOT, exist_ok=True)
    for name in [f"rank{r}.pt" for r in range(PAR_WORLD)] + ["inputs.pt"]:
        with contextlib.suppress(FileNotFoundError):  # nothing of an earlier run is read
            os.remove(os.path.join(PAR_ROOT, name))
    procs = start_workers(parallel_worker, PAR_WORLD)
    try:
        st = par_references()
    except BaseException:
        kill_workers(procs)
        raise
    st["procs"] = procs
    return st


def par_timed(st: dict, name: str, fn):
    """``fn()`` in this process, as st[name + "_ref"]; its seconds and its
    peak memory above the resident as st[name + "_s"] and
    st[name + "_above"]."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ref = st[f"{name}_ref"] = fn()
    torch.cuda.synchronize()
    st[f"{name}_s"] = time.perf_counter() - t0
    st[f"{name}_above"] = (torch.cuda.max_memory_allocated() - resident) / 2**30
    return ref


def par_sp_tp_references(st: dict, model, suffix: str) -> None:
    """(a) and (b) (with ``suffix``, (j)'s in a mode) in one process: the
    results, seconds, peak memory above the resident and spreads into
    ``st``: (a)'s the forward as row 1 of a batch of 2, (b)'s its rows
    swapped. The spreads' runs go first: the timed runs find the model
    warm (K6's HWIO weight copies made)."""
    spd, tp_ = st["sp"], st["tp"]
    two = {"x": spd["x"].repeat(2, 1, 1, 1), "t": spd["t"].repeat(2),
           "c_txt": spd["c_txt"].repeat(2, 1, 1), "c_img": spd["c_img"].repeat(2, 1, 1, 1)}
    row = par_sp_call(model, two)[1:]
    ref = par_timed(st, f"sp{suffix}", lambda: par_sp_call(model, spd))
    st[f"sp{suffix}_spread"] = spread(f"(sp{suffix}), the forward as row 1 of 2", row, ref)
    swapped = {**tp_, **par_swapped({k: tp_[k] for k in ("x", "c_img", "c_txt")})}
    rows = par_tp_call(model, swapped)[[1, 0]]
    ref = par_timed(st, f"tp{suffix}", lambda: par_tp_call(model, tp_))
    st[f"tp{suffix}_spread"] = spread(f"(tp{suffix}), the rows swapped", rows, ref)


def par_references() -> dict:
    import copy

    import numpy as np
    import torch

    from diffbir_tpu_torch.pipeline import SwinIRPipeline, build_sampler
    from diffbir_tpu_torch.profile_step import NEG_PROMPT, POS_PROMPT, stand_in_tokenizer
    from diffbir_tpu_torch.schedule import Schedule
    from diffbir_tpu_torch.utils.common import pil_bicubic_resize

    t0 = time.perf_counter()
    cldm, swinir = build_models()
    pipe = SwinIRPipeline(swinir, cldm, Schedule.v21(), torch.device("cuda"),
                          tokenizer=stand_in_tokenizer())
    gen = torch.Generator().manual_seed(PAR_SEED)
    with torch.no_grad():
        c_txt = torch.cat([cldm.encode_text(pipe.tokenize(p, 1))
                           for p in (POS_PROMPT, NEG_PROMPT)]).cpu()
    hw, thw = PAR_SP_HW, PAR_TP_HW
    ramp = torch.linspace(PAR_RAMP, -PAR_RAMP, hw)[None, :, None, None]
    sp = {"x": torch.randn(1, hw, hw, 4, generator=gen),
          "c_img": torch.randn(1, hw, hw, 4, generator=gen) + ramp,
          "c_txt": c_txt[:1], "t": torch.tensor([PAR_T])}
    grid = build_sampler("edm_dpm++_3m_sde", Schedule.v21(), False).model_ts(CLI_STEPS)
    tpd = {"x": torch.randn(2, thw, thw, 4, generator=gen),
           "c_img": torch.randn(2, thw, thw, 4, generator=gen), "c_txt": c_txt,
           "t": float(grid[CLI_STEPS // 2]), "grid": grid}
    lq = np.random.default_rng(PAR_SEED).integers(0, 256, (2, CLI_LQ, CLI_LQ, 3), dtype=np.uint8)
    lat = CLI_LQ * CLI_UPSCALE // 8
    batch = {"lq": np.stack([pil_bicubic_resize(torch.from_numpy(im), (SIZE, SIZE)).numpy()
                            for im in lq]),
             "x_T": torch.randn(2, lat, lat, 4, generator=gen),
             "noise": torch.randn(CLI_STEPS, 2, lat, lat, 4, generator=gen)}
    big, request = par_model_inputs(gen)
    path = os.path.join(PAR_ROOT, "inputs.pt")
    torch.save({"sp": sp, "tp": tpd, "batch": batch, "models": big, "request": request},
               path + ".part")
    os.replace(path + ".part", path)
    st = {"cldm": cldm, "swinir": swinir, "pipe": pipe, "sp": par_cuda(sp),
          "tp": par_cuda(tpd), "batch": par_cuda(batch)}
    spd = st["sp"]
    with torch.no_grad():
        par_sp_tp_references(st, cldm, "")  # no process group: the plain forwards
        st["tiles_ref"] = par_tiles_call(cldm, spd, False)
        st["tiles_spread"] = spread("(c), 3 tiles a call",
                                    par_tiles_call(cldm, spd, False, per=3), st["tiles_ref"])
    st["batch_ref"] = torch.from_numpy(par_request(pipe, st["batch"]))
    st["batch_spread"] = spread("(d), the rows swapped", torch.from_numpy(par_request(
        pipe, par_swapped(st["batch"], {"noise": 1})))[[1, 0]], st["batch_ref"])
    models = {"cldm": cldm, "swinir": swinir, **par_cleaners()}
    par_model_references(st, models, par_cuda(big), par_cuda(request))
    st["tp_swinir_weights"] = sum(p.numel() for p in swinir.parameters())
    del models
    st["tp_weights"] = par_weights(cldm)
    for mode in PAR_MODES:  # (j), each mode on a copy
        model = copy.deepcopy(cldm).set_mode(mode)
        with torch.no_grad():
            par_sp_tp_references(st, model, f"_{mode}")
        st[f"tp_{mode}_weights"] = par_weights(model)
        del model
    print(f"[parallel_inference] {card()} one process's references and spreads in "
          f"{time.perf_counter() - t0:.1f} s beside the workers (models built, inputs written "
          f"to {PAR_ROOT})")
    return st


def phase_parallel_inference(st: dict) -> dict:
    """[parallel_inference]: (a)-(j) in the PAR_WORLD processes that
    ``parallel_references`` started, joined here, against one process,
    within PAR_TOL x max|ref|, each limit above its spread; seven planted
    faults that must fail; exact launches and K1's, K3's and K1_wide's
    shapes per process (Sq != Skv under SP), none on any other entry; then
    K1, K3 and K1_wide timed at the band shapes. Returns the launches of
    the runs, summed over the processes."""
    import torch

    t0 = time.perf_counter()
    join_workers(st.pop("procs"), PAR_TIMEOUT, "[parallel_inference]")
    ranks = [torch.load(os.path.join(PAR_ROOT, f"rank{r}.pt"), weights_only=False)
             for r in range(PAR_WORLD)]
    print(f"[parallel_inference] {PAR_WORLD} processes on this card over gloo done "
          f"{time.perf_counter() - t0:.1f} s after the references")
    step = K1_SITES_PER_STEP
    wide = {"K1_wide": 1}
    expected = {"broadcast": {}, "batch": CLI_DEFAULT, "sp": {"K1": step},
                "tiles": {"K1": step}, "swinir": {}, "encode": wide, "sample": wide,
                "decode": wide, "scunet": {}, "bsrnet": {},
                "request": {"K1": step * PAR_REQ_STEPS, "K1_wide": 2}, **PAR_MODE_LAUNCHES,
                **{f"tp_shard_{mode}": {} for mode in PAR_MODES}, "tp_shard": {},
                "tp": {"K1": step}, "tp_swinir_shard": {}, "tp_swinir": {}}
    shapes = {"sp": par_k1_shapes("sp"), "tp": par_k1_shapes("tp"),
              "tiles": par_k1_shapes("tiles"), "request": par_k1_shapes("request"),
              **{name: {PAR_WIDE: 1} for name in ("encode", "sample", "decode")},
              **{name: par_k1_shapes("tp_int8" if name == "tp_int8" else name[:2])
                 for name in PAR_MODE_LAUNCHES}}
    outs = ("sp", "tp", "tiles", "batch") + PAR_MODELS + ("request", *PAR_MODE_LAUNCHES)
    total = {k: 0 for k in KERNELS}
    for name in outs:
        check(st[f"{name}_spread"] <= PAR_TOL[name],
              f"[parallel_inference] ({name}) the spread {st[f'{name}_spread']} is above the "
              f"limit {PAR_TOL[name]}")
    for rank, r in enumerate(ranks):
        for name, want in expected.items():
            got = r[name]["launches"]
            check(got == want, f"[parallel_inference] rank {rank} {name}: launches {got}, "
                               f"expected {want}")
            for k, n in got.items():
                total[k] += n
        for name, kind in shapes.items():
            want = {str(k): n for k, n in kind.items()}
            got = {str(k): n for k, n in r[name]["shapes"].items()}
            check(got == want, f"[parallel_inference] rank {rank} {name}: K1/K3 shapes {got}, "
                               f"expected {want}")
        errs = {}
        for name in outs:
            ref = st[f"{name}_ref"]
            out = r[f"{name}_out"]
            out = torch.from_numpy(out) if not isinstance(out, torch.Tensor) else out
            check(tuple(out.shape) == tuple(ref.shape) and bool(torch.isfinite(out.float()).all()),
                  f"[parallel_inference] rank {rank} {name}: output {tuple(out.shape)}")
            err, limit = err_limit(out, ref.cpu(), PAR_TOL[name])
            errs[name] = err / ref.float().abs().max().item()
            check(err <= limit, f"[parallel_inference] rank {rank} ({name}) against one "
                                f"process: {err} > {limit}")
        print(f"[parallel_inference] rank {rank} against one process, x max|ref| (limit; "
              f"one process's spread): " + "; ".join(
                  f"({n}) {errs[n]:.3e} ({PAR_TOL[n]:.3g}; {st[f'{n}_spread']:.3e})"
                  for n in outs))
        print(f"[parallel_inference] {card()} rank {rank}, two processes sharing one card "
              f"(these times measure no speed of the method): " + "; ".join(
                  f"{name} {r[name]['s']:.3f} s, peak {r[name]['peak']:.2f} GiB"
                  for name in expected))
        print(f"[parallel_inference] rank {rank} K1 shapes (q, k): SP "
              + ", ".join(f"{q}x{k[1]} {n}" for (q, k), n in r["sp"]["shapes"].items())
              + "; TP " + ", ".join(f"{q} {n}" for (q, k), n in r["tp"]["shapes"].items())
              + "; (i) " + ", ".join(f"{q}x{k[1]} {n}"
                                     for (q, k), n in r["request"]["shapes"].items())
              + "; K3 in the modes: (a)'s and (b)'s, TP int8 every head ("
              + ", ".join(f"{q} {n}" for (q, k), n in r["tp_int8"]["shapes"].items()) + ")")
        print(f"[parallel_inference] {card()} rank {rank} (j) seconds and peak memory above the "
              f"resident weights a process (one process's): " + "; ".join(
                  f"{name} {r[name]['s']:.3f} s, {r[name]['above']:.2f} GiB "
                  f"({st[f'{name}_s']:.3f} s, {st[f'{name}_above']:.2f} GiB)"
                  for name in ("sp", "tp", *PAR_MODE_LAUNCHES)))
        print(f"[parallel_inference] {card()} rank {rank} (f) peak memory a process against "
              f"one process's: " + "; ".join(
                  f"{name} {r[name]['peak']:.2f} GiB ({st[f'{name}_peak']:.2f})"
                  for name in ("encode", "sample", "decode")))
    for key in ("batch_out", "request_out"):
        check(torch.equal(torch.as_tensor(ranks[0][key]), torch.as_tensor(ranks[1][key])),
              f"[parallel_inference] the processes hold different gathered {key}")
    for label, key, name in (("SP with zeroed halos", "sp_zero_halos", "sp"),
                             ("SP with GroupNorm statistics kept local", "sp_local_gn", "sp"),
                             ("TP without the row layers' all-reduce", "tp_no_reduce", "tp"),
                             ("(e) SwinIR's shift without its wrap", "swinir_open_roll",
                              "swinir"),
                             ("(e) every band masked as the last", "swinir_last_band",
                              "swinir"),
                             ("(f) the Downsample's halo row from above", "encode_row_above",
                              "encode"),
                             ("(j) SP in the fused mode with K6 on the band alone",
                              "sp_fused_band_alone", "sp_fused")):
        planted(f"parallel_inference {label}", ranks[0][key], st[f"{name}_ref"].cpu(),
                PAR_TOL[name])
    print(f"[parallel_inference] the TP processes hold (weights and int8 weights, one "
          f"process's): " + "; ".join(
              f"{mode} {ranks[0][f'tp{sfx}_weights'] / 1e6:.1f} M ({st[f'tp{sfx}_weights'] / 1e6:.1f} M)"
              for mode, sfx in (("default", ""), *((m, f"_{m}") for m in PAR_MODES)))
          + f"; TP SwinIR {ranks[0]['tp_swinir_weights'] / 1e6:.2f} M of "
          f"{st['tp_swinir_weights'] / 1e6:.2f} M")
    par_k1_bands()  # timed once the workers are done: the card is this process's
    par_k3_band()
    par_k1_wide_band()
    return total


def phase_parallel_nccl(st: dict) -> dict:
    """[parallel_nccl]: the same four APIs at world size 1 on nccl, in this
    process, against the plain runs of ``parallel_references``: bit-equal
    where the code path is the same (tensor parallelism, which shards
    nothing at one process, as JAX's tensor axis of 1; the tiles, one call
    of all 9 against make_tiled_fn at 9 a call; tile_parallel_model_fn; the
    request), and (a) within PAR_TOL["sp"]: its 3x3 convolutions read the
    zero halo rows as input rows (another input shape, so cuDNN may round
    otherwise) and its GroupNorm divides all-reduced sums where the module
    takes a mean."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from diffbir_tpu_torch import pipeline, tiling
    from diffbir_tpu_torch.parallel import distributed, inference, tp

    cldm, sp, tp_ = st["cldm"], st["sp"], st["tp"]
    total = {k: 0 for k in KERNELS}

    def run(name: str, fn, want: dict):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        n = launched_since(before)
        check(n == want, f"[parallel_nccl] {name}: launches {n}, expected {want}")
        for k, v in n.items():
            total[k] += v
        print(f"[parallel_nccl] {card()} {name}: {time.perf_counter() - t0:.3f} s, "
              f"launches {n}")
        return res

    step = {"K1": K1_SITES_PER_STEP}
    with launch_environment(free_port()):
        check(distributed.maybe_initialize_distributed("cuda"),
              "[parallel_nccl] no process group from the launch environment")
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"[parallel_nccl] {dist.get_backend()} at {dist.get_world_size()}")
        with torch.no_grad():
            out = run("spatial_parallel", lambda: par_sp_call(cldm, sp), step)
            err, limit = err_limit(out, st["sp_ref"], PAR_TOL["sp"])
            print(f"[parallel_nccl] (a) spatial_parallel at one process against the plain "
                  f"forward: {err:.3e} (limit {limit:.3e}, {PAR_TOL['sp']:g} x max|ref|; "
                  f"bit-equal: {torch.equal(out, st['sp_ref'])})")
            check(err <= limit, f"[parallel_nccl] (a) {err} > {limit}")
            fn = pipeline.tile_model_function(cldm, 1.0, PAR_TILE)
            args = (sp["x"], PAR_T, {"c_txt": sp["c_txt"], "c_img": sp["c_img"]})
            sharded = run("make_tile_sharded_fn", lambda: inference.make_tile_sharded_fn(
                fn, PAR_TILE, PAR_STRIDE, channel=4)(*args), step)
            plain = tiling.make_tiled_fn(fn, PAR_TILE, PAR_STRIDE, channel=4,
                                         tiles_per_batch=CLDM_TILES)(*args)
            check(torch.equal(sharded, plain), "[parallel_nccl] make_tile_sharded_fn is not "
                                               "bit-equal to make_tiled_fn")
            par = run("tile_parallel_model_fn", lambda: tiling.make_tiled_fn(
                inference.tile_parallel_model_fn(fn), PAR_TILE, PAR_STRIDE, channel=4,
                tiles_per_batch=3)(*args), {"K1": 3 * K1_SITES_PER_STEP})
            plain = tiling.make_tiled_fn(fn, PAR_TILE, PAR_STRIDE, channel=4,
                                         tiles_per_batch=3)(*args)
            check(torch.equal(par, plain), "[parallel_nccl] tile_parallel_model_fn is not "
                                           "bit-equal to the plain function")
            before = {k: v.data_ptr() for k, v in cldm.state_dict().items()}
            tp.tp_shard_(cldm)
            check(before == {k: v.data_ptr() for k, v in cldm.state_dict().items()},
                  "[parallel_nccl] tp_shard_ at one process changed the weights")
            out = run("tp_shard_", lambda: par_tp_call(cldm, tp_), step)
            check(torch.equal(out, st["tp_ref"]), "[parallel_nccl] (b) is not bit-equal")
        both = torch.nn.ModuleList([cldm, st["swinir"]])
        _, rows = inference.shard_for_batch_parallel(both, st["batch"], batch_axes={"noise": 1})
        imgs = run("batch_parallel", lambda: inference.batch_parallel(
            lambda r: par_request(st["pipe"], r))(rows), CLI_DEFAULT)
        check(np.array_equal(imgs, st["batch_ref"].numpy()),
              "[parallel_nccl] (d) is not bit-equal")
        print("[parallel_nccl] nccl at world size 1: tp_shard_, make_tile_sharded_fn, "
              "tile_parallel_model_fn and batch_parallel bit-equal to the plain runs")
    finally:
        distributed.shutdown_distributed()
    check(not dist.is_initialized(), "[parallel_nccl] the process group is still up")
    return total


# --------------------------------------------------------------------------- #
# [parallel_train]: tensor and spatial parallelism under autograd, the grid
# --------------------------------------------------------------------------- #
# PTR_WORLD processes on this card over gloo, laid out by make_mesh(2, 2),
# inputs through PTR_ROOT, the models full-width SD2.1 + IRControlNet with
# gradient checkpointing, random bf16 weights from seed 0. On each tensor
# group (two processes): (a) TP, the stage-2 loss of a batch of 2 at
# PTR_SIZE^2 (no cleaner, empty prompts, noise augmentation at NOISE_AUG)
# and its ControlNet gradient; (b) SP, the denoiser's forward and backward
# on the bands of a PTR_SP_HW^2 latent (the 512^2 request's, its condition
# ramped along H as [parallel_inference]'s), gradients with respect to x,
# c_img and the ControlNet. On the grid: (c) two stage-2 steps at
# PTR_SIZE^2, one row a data group, the ControlNet tensor-sharded and
# data-sharded (fsdp), each data group's draws from
# process_seed(PTR_SEED, grid). Each against one process on the same
# inputs and draws (the concatenated batch for (c)).
PTR_WORLD, PTR_TIMEOUT = 4, 300
PTR_ROOT = os.path.join("build", "parallel_train")
PTR_SIZE, PTR_SP_HW, PTR_SEED, PTR_LR = 256, SIZE // 8, 23, 1e-5
# the ControlNet's gradients, masters and moments (363 M elements) are held
# at every PTR_STRIDE-th element of each tensor as it lies on the process
# (a tensor slice, a data shard), 6 M of them
PTR_STRIDE = 61
# Limits, each set from the port's own bf16 rounding-order spread on the
# same weights and inputs in one process (printed beside every reading):
# the batch doubled, every row twice ((b): the call as row 1 of a batch of
# 2); the rows swapped read up to ~10x less than the processes' reordered
# sums. Errors are max|got - ref| / max|ref| over each compared tensor (the
# ControlNet's sampled gradient and first moment as one); (c)'s masters
# read the share of sampled elements whose two updates land more than
# PTR_LR from one process's (an update moves a master by ~PTR_LR whatever
# its gradient, so where a gradient is rounding noise its sign, and its
# step, can flip). Measured on an H100 80GB HBM3 at 700 W: the spreads
# 4.05e-3 (a), 1.82e-2 (b), 4.44e-3 (c) and 3.28e-3 of the masters; the
# processes 8.10e-3, 2.05e-2, 1.31e-2-1.59e-2 and 5.06e-3-5.15e-3. The
# limits are ~5x the spreads; the planted faults read 2.3-23x them.
PTR_TOL = {"tp": 2e-2, "sp": 9e-2, "grid": 2.5e-2, "masters": 1.6e-2}


def ptr_model():
    """Full-width SD2.1 + IRControlNet with gradient checkpointing, frozen,
    random weights from seed 0 drawn in place as random_init_ draws them
    (N(0, 1/fan_in) for weights of rank >= 2, ones for the other weights,
    zeros for biases), one launch a parameter: four processes build it at
    once on the card, where random_init_'s three launches and fp32 copy a
    parameter took ~12 s."""
    import torch

    from diffbir_tpu_torch.models.cldm import ControlLDM

    gen = torch.Generator(device="cuda").manual_seed(0)
    cldm = ControlLDM.sd21(dtype=torch.bfloat16, use_checkpoint=True,
                           device="meta").to_empty(device="cuda")
    with torch.no_grad():
        for name, p in cldm.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
            else:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
    return cldm.requires_grad_(False)


def ptr_draws(gen, bs: int) -> dict:
    """One step's draws at PTR_SIZE^2 from ``gen``, in make_loss_fn's order."""
    import torch

    shape = (bs, PTR_SIZE // 8, PTR_SIZE // 8, 4)
    return {"posterior": torch.randn(shape, generator=gen, device="cuda"),
            "aug": torch.randn(shape, generator=gen, device="cuda"),
            "t": torch.randint(0, 1000, (bs,), generator=gen, device="cuda"),
            "noise": torch.randn(shape, generator=gen, device="cuda")}


def ptr_sample(tensors) -> "torch.Tensor":
    """Every PTR_STRIDE-th element of each tensor, fp32, concatenated."""
    import torch

    return torch.cat([t.detach().flatten()[::PTR_STRIDE].float() for t in tensors])


def ptr_sp_grads(cldm, sp: dict, group=None) -> dict:
    """(b) on this process's band (the whole call without a process group):
    the whole gradients of x and c_img of sum(out * cot), the ControlNet's
    sampled and summed over the bands."""
    import torch.distributed as dist

    from diffbir_tpu_torch.parallel import inference

    cldm.controlnet.requires_grad_(True)
    x = inference.spatial_shard(sp["x"], group).clone().requires_grad_()
    c_img = inference.spatial_shard(sp["c_img"], group).clone().requires_grad_()
    fn = inference.spatial_parallel(cldm, group)
    with fn:
        out = fn(x, sp["t"], {"c_txt": sp["c_txt"], "c_img": c_img})
        (out.float() * inference.spatial_shard(sp["cot"], group)).sum().backward()
    cn = ptr_sample(p.grad for p in cldm.controlnet.parameters())
    if dist.is_initialized():
        dist.all_reduce(cn, group=group)
    cldm.controlnet.zero_grad(set_to_none=True)
    return {"x": inference.gather(x.grad, group).float(),
            "c_img": inference.gather(c_img.grad, group).float(), "controlnet": cn}


def ptr_loss_grads(cldm, tpd: dict) -> tuple:
    """(a): the stage-2 loss of ``tpd``'s batch and draws, and the
    ControlNet's gradients as they lie on this process."""
    from diffbir_tpu_torch.profile_step import NOISE_AUG
    from diffbir_tpu_torch.schedule import Schedule
    from diffbir_tpu_torch.train import stage2

    cldm.controlnet.requires_grad_(True)
    loss = stage2.make_loss_fn(cldm, Schedule.v21(), None, NOISE_AUG)(
        tpd["batch"], draws=tpd["draws"])
    loss.backward()
    grads = [p.grad.detach().clone() for p in cldm.controlnet.parameters()]
    cldm.controlnet.zero_grad(set_to_none=True)
    return loss.item(), grads


def ptr_grid_steps(inp: dict, grid=None, cldm=None, steps: int = 2) -> dict:
    """(c): ``steps`` stage-2 steps of ``cldm`` (a fresh ``ptr_model()``
    unless given) on the grid (this process's data row, its draws from
    process_seed(PTR_SEED, grid)) or, without a grid, one process on both
    rows and both data indices' draws; the losses, grad norms, and the
    ControlNet's masters and first moments (as they lie on the process;
    one process's after the first step too, "after_1")."""
    import torch

    from diffbir_tpu_torch.parallel import distributed
    from diffbir_tpu_torch.parallel.mesh import DataParallel
    from diffbir_tpu_torch.profile_step import NOISE_AUG
    from diffbir_tpu_torch.schedule import Schedule
    from diffbir_tpu_torch.train import stage2

    cldm = ptr_model() if cldm is None else cldm
    parallel = None if grid is None else DataParallel("mean", fsdp=True, grid=grid)
    opt = stage2.init_train_state(cldm, PTR_LR, parallel=parallel)
    step = stage2.make_train_step(cldm, Schedule.v21(), opt, None, NOISE_AUG)
    if grid is None:
        batch, gens = par_cuda(inp["batch"]), [torch.Generator(device="cuda").manual_seed(
            PTR_SEED + d * 1_000_003) for d in range(2)]
    else:
        d = grid.data_index
        batch = par_cuda({k: v[d:d + 1] for k, v in inp["batch"].items()})
        gens = [torch.Generator(device="cuda").manual_seed(
            distributed.process_seed(PTR_SEED, grid))]
    out = {"losses": [], "norms": []}
    for i in range(steps):
        parts = [ptr_draws(gen, 1) for gen in gens]
        parts += parts if inp.get("doubled") else []
        draws = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        m = step(batch, draws=draws)
        out["losses"].append(float(m["loss"]))
        out["norms"].append(float(m["grad_norm"]))
        if grid is None and i == 0:
            out["after_1"] = {"masters": [m.clone() for m in opt.masters],
                              "exp_avg": [opt.optimizer.state[m]["exp_avg"].clone()
                                          for m in opt.masters]}
    out["layout"] = list(zip(opt.tp, opt.dims))
    out["masters"] = list(opt.masters)
    out["exp_avg"] = [opt.optimizer.state[m]["exp_avg"] for m in opt.masters]
    if grid is not None:
        out["index"] = (grid.data_index, grid.tensor_index)
        out["masters"], out["exp_avg"] = ptr_sample(out["masters"]), ptr_sample(out["exp_avg"])
    return out


def ptr_local(whole, tp, dim, index) -> "torch.Tensor":
    """The part of a whole tensor that process ``index`` (data, tensor)
    holds: its tensor slice (``tp``: (dim, splits), or None), its data shard
    along ``dim`` (or None) of that."""
    from diffbir_tpu_torch.parallel.tp import tp_local

    d, t = index
    if tp is not None:
        whole = tp_local(whole, tp[0], tp[1], t, 2)
    return whole if dim is None else whole.chunk(2, dim)[d]


def rel(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    return (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()


def flipped(got, ref) -> float:
    """The share of masters whose two updates land more than PTR_LR from
    one process's."""
    return ((got - ref).abs() > PTR_LR).float().mean().item()


def parallel_train_worker(rank: int, port: int) -> None:
    """One process of [parallel_train]: the DIFFBIR_* launch contract on
    127.0.0.1:``port``, gloo on this card, make_mesh(2, 2); (b), (a) on its
    tensor group and (c) on the grid, each with its launches and the shapes
    of K1 and K2, then the planted faults; the results to
    PTR_ROOT/rank<rank>.pt."""
    from collections import Counter

    import torch

    from diffbir_tpu_torch.ops import flash_attention as fa
    from diffbir_tpu_torch.parallel import collectives, distributed, tp
    from diffbir_tpu_torch.parallel.mesh import make_mesh

    # when this process got past each step of its start (wall clock)
    stamps = [("imports", time.time())]

    def stamp(what: str) -> None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        stamps.append((what, time.time()))

    os.environ.update(DIFFBIR_COORDINATOR=f"127.0.0.1:{port}",
                      DIFFBIR_NUM_PROCESSES=str(PTR_WORLD), DIFFBIR_PROCESS_ID=str(rank))
    # grow the caching allocator's segments in place: four processes that
    # each allocate a model's ~1700 tensors at once on one card wait on one
    # another's cudaMalloc calls
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.set_num_threads(2)  # the eight cores are shared by five processes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fill_kernels()
    check(distributed.maybe_initialize_distributed("cuda", backend="gloo"),
          "[parallel_train] no process group from the launch environment")
    stamp("the process group")
    shapes = Counter()
    launch_fwd, launch_dq = fa.launch_fwd, fa.launch_dq

    def recording_fwd(kernel, q, k, v, with_lse=False):
        shapes.update([("K1", tuple(q.shape), tuple(k.shape))])
        return launch_fwd(kernel, q, k, v, with_lse)

    def recording_dq(kernel, q, k, v, o, lse, g, delta=None):
        shapes.update([("K2", tuple(q.shape), tuple(k.shape))])
        return launch_dq(kernel, q, k, v, o, lse, g, delta)

    fa.launch_fwd, fa.launch_dq = recording_fwd, recording_dq
    out = {"ready": stamps}

    def run(name: str, fn):
        reset_counts()
        shapes.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t0,
                     "peak": torch.cuda.max_memory_allocated() / 2**30,
                     "above": (torch.cuda.max_memory_allocated() - resident) / 2**30,
                     "launches": {k: n for k, n in counts().items() if n},
                     "shapes": dict(shapes)}
        return res

    def identity_backward(ctx, g):
        return g, None

    def dropped_halo_backward(ctx, g):
        return g.new_zeros(ctx.shape), None, None

    def seeded_by_process(seed, grid=None):
        return seed + distributed.process_index() * 1_000_003

    try:
        inp = torch.load(os.path.join(PTR_ROOT, "inputs.pt"), weights_only=False)
        sp, tpd = par_cuda(inp["sp"]), {"batch": par_cuda(inp["tp"]["batch"]),
                                        "draws": par_cuda(inp["tp"]["draws"])}
        stamp("the card (its context, the inputs)")
        grid = make_mesh(2, 2)
        pair = grid.tensor_group
        stamp("the grid")
        cldm = ptr_model()
        stamp("the model")
        if grid.data_index == 0:  # the first tensor group: (b), (a) and f's fault
            out["sp_out"] = run("sp", lambda: ptr_sp_grads(cldm, sp, pair))
            tp.tp_shard_(cldm, pair)
            out["tp_layout"] = [(p.tp_dim, p.tp_splits) if hasattr(p, "tp_dim") else None
                                for p in cldm.controlnet.parameters()]
            loss, grads = run("tp", lambda: ptr_loss_grads(cldm, tpd))
            out["tp_out"] = {"loss": loss, "controlnet": ptr_sample(grads).cpu()}
            with par_planted(collectives.CopyToTensorParallel, "backward",
                             staticmethod(identity_backward)):
                loss, grads = ptr_loss_grads(cldm, tpd)
            out["tp_no_f"] = {"loss": loss, "controlnet": ptr_sample(grads).cpu()}
            del grads
        else:  # the second: (b)'s two faults
            with par_planted(collectives.AllReduceSum, "backward",
                             staticmethod(identity_backward)):
                out["sp_local_gn"] = ptr_sp_grads(cldm, sp, pair)
            with par_planted(collectives.HaloRows, "backward",
                             staticmethod(dropped_halo_backward)):
                out["sp_dropped_halos"] = ptr_sp_grads(cldm, sp, pair)
        # (c) on the same model, its weights as built ((a) and (b) changed
        # none), tensor-sharded as init_train_state shards it (then a no-op
        # there); the fault's run starts again from them
        tp.tp_shard_(cldm, pair)
        start = [p.detach().clone() for p in cldm.controlnet.parameters()]
        out["grid_out"] = run("grid", lambda: ptr_grid_steps(inp["grid"], grid, cldm))
        with torch.no_grad():
            for p, w in zip(cldm.controlnet.parameters(), start):
                p.copy_(w)
        with par_planted(distributed, "process_seed", seeded_by_process):
            out["grid_seeds_apart"] = ptr_grid_steps(inp["grid"], grid, cldm, steps=1)
        del cldm, start
        out = {k: ({n: t.cpu() if isinstance(t, torch.Tensor) else t for n, t in v.items()}
                   if isinstance(v, dict) else v) for k, v in out.items()}
        out["index"] = (grid.data_index, grid.tensor_index)
        torch.save(out, os.path.join(PTR_ROOT, f"rank{rank}.pt"))
    finally:
        fa.launch_fwd, fa.launch_dq = launch_fwd, launch_dq
        distributed.shutdown_distributed()


def ptr_inputs() -> dict:
    """The inputs of (a)-(c), saved to PTR_ROOT/inputs.pt."""
    import torch

    gen = torch.Generator().manual_seed(PTR_SEED)
    hw = PTR_SP_HW
    ramp = torch.linspace(PAR_RAMP, -PAR_RAMP, hw)[None, :, None, None]
    tokens = empty_tokens(2).cpu()
    sp = {"x": torch.randn(1, hw, hw, 4, generator=gen),
          "c_img": torch.randn(1, hw, hw, 4, generator=gen) + ramp,
          "c_txt": torch.randn(1, 77, 1024, generator=gen),
          "t": torch.tensor([PAR_T]), "cot": torch.randn(1, hw, hw, 4, generator=gen)}

    def batch():
        return {"gt": torch.rand(2, PTR_SIZE, PTR_SIZE, 3, generator=gen) * 2 - 1,
                "lq": torch.rand(2, PTR_SIZE, PTR_SIZE, 3, generator=gen), "tokens": tokens}

    tp_draws = ptr_draws(torch.Generator(device="cuda").manual_seed(PTR_SEED), 2)
    inp = {"sp": sp, "tp": {"batch": batch(), "draws": {k: v.cpu() for k, v in tp_draws.items()}},
           "grid": {"batch": batch()}}
    os.makedirs(PTR_ROOT, exist_ok=True)
    for r in range(PTR_WORLD):  # no result of an earlier run is read
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(PTR_ROOT, f"rank{r}.pt"))
    torch.save(inp, os.path.join(PTR_ROOT, "inputs.pt"))
    return inp


def ptr_references(inp: dict) -> dict:
    """One process's (a)-(c) on the inputs, and its spreads: the whole
    gradients, loss and state, on the card."""
    import torch

    t0 = time.perf_counter()
    sp = par_cuda(inp["sp"])
    tpd = {"batch": par_cuda(inp["tp"]["batch"]), "draws": par_cuda(inp["tp"]["draws"])}
    st = {}
    cldm = ptr_model()
    st["sp"] = ptr_sp_grads(cldm, sp)
    two = {k: v.repeat(2, *([1] * (v.dim() - 1))) for k, v in sp.items()}
    two["cot"] = torch.cat([torch.zeros_like(sp["cot"]), sp["cot"]])
    row1 = ptr_sp_grads(cldm, two)
    st["sp_spread"] = max(rel(row1[k][1:], st["sp"][k]) for k in ("x", "c_img"))
    st["sp_spread"] = max(st["sp_spread"], rel(row1["controlnet"], st["sp"]["controlnet"]))
    st["tp_loss"], st["tp_grads"] = ptr_loss_grads(cldm, tpd)
    doubled = {part: {k: torch.cat([v, v]) for k, v in tpd[part].items()}
               for part in ("batch", "draws")}
    loss, grads = ptr_loss_grads(cldm, doubled)
    st["tp_spread"] = max(abs(loss - st["tp_loss"]) / abs(st["tp_loss"]),
                          rel(ptr_sample(grads), ptr_sample(st["tp_grads"])))
    del cldm, grads
    st["grid"] = ptr_grid_steps(inp["grid"])
    spread = ptr_grid_steps({"batch": {k: torch.cat([v, v])
                                       for k, v in inp["grid"]["batch"].items()},
                             "doubled": True})
    ref = st["grid"]
    st["grid_spread"] = max(max(abs(a - b) / abs(b) for a, b in zip(spread["losses"],
                                                                      ref["losses"])),
                            rel(ptr_sample(spread["exp_avg"]), ptr_sample(ref["exp_avg"])))
    st["masters_spread"] = flipped(ptr_sample(spread["masters"]), ptr_sample(ref["masters"]))
    del spread
    torch.cuda.empty_cache()
    print(f"[parallel_train] {card()} one process's references and spreads in "
          f"{time.perf_counter() - t0:.1f} s")
    return st


def ptr_kernel_timing() -> dict:
    """K1 with lse, K2a and K2b at (b)'s first banded shape and (a)'s
    head-sharded one: one launch each against its plain version (BF16_TOL x
    max|ref|), device ms (back to back) beside the plain versions, SDPA's
    forward and backward and the bound."""
    import torch

    from diffbir_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(PTR_SEED)
    out = {}
    for label, (b, sq, skv, h, d) in (("banded", (1, PTR_SP_HW ** 2 // 2, PTR_SP_HW ** 2, 5, 64)),
                                      ("head-sharded", (2, (PTR_SIZE // 16) ** 2,
                                                        (PTR_SIZE // 16) ** 2, 5, 64))):
        q, g = (torch.randn(b, sq, h, d, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        k, v = (torch.randn(b, skv, h, d, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        before = counts()
        o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, g)
        torch.cuda.synchronize()
        n = launched_since(before)
        check(n == {"K1": 1, "K2a": 1, "K2b": 1},
              f"[parallel_train] K1 and K2 at {label} launched {n}")
        shape = f"{b}x{sq}x{h}x{d} vs {skv} kv rows"
        errs = [hold(f"[parallel_train] {label} {name} {shape}", got, ref,
                     FP32_TOL if name == "lse" else BF16_TOL)
                for name, got, ref in zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *grads),
                                          (*fa.flash_attention_lse_ref(q, k, v),
                                           *fa.flash_attention_bwd_ref(q, k, v, o, lse, g)))]
        t = {"K1+lse": device_ms(lambda i: fa.flash_attention_fwd(q, k, v, with_lse=True)),
             "plain K1+lse": device_ms(lambda i: fa.flash_attention_lse_ref(q, k, v), 5),
             "SDPA fwd": device_ms(lambda i: sdpa_fwd(q, k, v)),
             "K2a": device_ms(lambda i: fa.flash_attention_bwd_dq(q, k, v, o, lse, g)),
             "K2b": device_ms(lambda i: fa.flash_attention_bwd_dkv(q, k, v, o, lse, g)),
             "plain K2a": device_ms(lambda i: fa.flash_attention_bwd_dq_ref(q, k, v, o, lse, g),
                                    5),
             "plain K2b": device_ms(lambda i: fa.flash_attention_bwd_dkv_ref(q, k, v, o, lse, g),
                                    5)}
        qt, kt, vt = (x.detach().clone().requires_grad_() for x in (q, k, v))
        out_lib = sdpa_fwd(qt, kt, vt)
        t["SDPA bwd"] = device_ms(lambda i: torch.autograd.grad(
            out_lib, (qt, kt, vt), g.transpose(1, 2), retain_graph=True))
        in_bytes = nbytes(q, k, v, o, g, lse)
        b_fwd = bound_ms(2, b, h, sq, skv, d, torch.bfloat16, nbytes(q, k, v, o, lse))
        b_dq = bound_ms(3, b, h, sq, skv, d, torch.bfloat16, in_bytes + nbytes(grads[0]))
        b_dkv = bound_ms(4, b, h, sq, skv, d, torch.bfloat16, in_bytes + nbytes(*grads[1:]))
        print(f"[parallel_train] {card()} K1+lse, K2 at the {label} shape {shape} bf16: max "
              f"err o/lse/dq/dk/dv " + "/".join(f"{e:.3e}" for e in errs) + "; device ms "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in t.items())
              + f"; bound K1+lse {b_fwd[0]:.4f} ({b_fwd[1]}), K2a {b_dq[0]:.4f} ({b_dq[1]}), "
              f"K2b {b_dkv[0]:.4f} ({b_dkv[1]})")
        out[label] = {**t, "bound K1": b_fwd[0], "bound K2a": b_dq[0], "bound K2b": b_dkv[0]}
    return out


def ptr_k_shapes(kind: str) -> dict:
    """(kernel, q shape, k shape) -> launches a process of ``kind``: "sp"
    (the bands of PTR_SP_HW^2, every site with a gradient and recomputed),
    "tp" (batch 2 at PTR_SIZE^2, a level's heads split where they divide;
    gradients at the ControlNet's 7 sites and the UNet's 9 output sites,
    those recomputed), "grid" (two steps at batch 1, as "tp")."""
    from collections import Counter

    out = Counter()
    for level, (tokens, width, sites) in enumerate(LEVELS):
        heads = width // 64
        mid = level == len(LEVELS) - 1
        if kind == "sp":
            s = tokens * (PTR_SP_HW // 64) ** 2
            q, k, grad_sites = (1, s // 2, heads, 64), (1, s, heads, 64), sites
        else:
            h = heads // 2 if heads % 2 == 0 else heads
            s = tokens * (PTR_SIZE // 8) ** 2 // 64 ** 2
            b = 2 if kind == "tp" else 1
            q = k = (b, s, h, 64)
            grad_sites = 1 if mid else 5  # the ControlNet's and the UNet's outputs
        steps = 2 if kind == "grid" else 1
        out[("K1", q, k)] += steps * (sites + grad_sites)
        out[("K2", q, k)] += steps * grad_sites
    return dict(out)


def phase_parallel_train() -> dict:
    """[parallel_train]: (a)-(c) in PTR_WORLD processes on this card against
    one process (``ptr_references``, computed while they run), within
    PTR_TOL, each limit above its spread; four planted faults that must fail
    them; exact launches and K1/K2 shapes per process and run, none on any
    other entry; K2a/K2b at a banded and a head-sharded shape. The first
    tensor group runs (a), (b) and f's fault, the second (b)'s two faults,
    then all four (c) and its fault. Returns the launches of the runs (not
    the faults), summed over the processes."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    inp = ptr_inputs()
    spawned_at = time.time()
    procs = start_workers(parallel_train_worker, PTR_WORLD)
    try:
        st = ptr_references(inp)
    finally:
        join_workers(procs, PTR_TIMEOUT, "[parallel_train]")
    ranks = [torch.load(os.path.join(PTR_ROOT, f"rank{r}.pt"), weights_only=False)
             for r in range(PTR_WORLD)]
    print(f"[parallel_train] {PTR_WORLD} processes on this card over gloo done in "
          f"{time.perf_counter() - t0:.1f} s (the references beside them)")
    for name, spread in (("tp", st["tp_spread"]), ("sp", st["sp_spread"]),
                         ("grid", st["grid_spread"]), ("masters", st["masters_spread"])):
        check(spread <= PTR_TOL[name], f"[parallel_train] ({name}) the spread {spread} is above "
                                       f"the limit {PTR_TOL[name]}")
    expected = {
        kind: {"K1": sum(n for (kn, _, _), n in ptr_k_shapes(kind).items() if kn == "K1"),
               "K2a": sum(n for (kn, _, _), n in ptr_k_shapes(kind).items() if kn == "K2"),
               "K2b": sum(n for (kn, _, _), n in ptr_k_shapes(kind).items() if kn == "K2")}
        for kind in ("sp", "tp", "grid")}
    total = {k: 0 for k in KERNELS}
    grid = st["grid"]
    spreads = {"tp": st["tp_spread"], "sp": st["sp_spread"], "grid": st["grid_spread"],
               "masters": st["masters_spread"]}
    for rank, r in enumerate(ranks):
        d, t = r["index"]
        check(r["index"] == divmod(rank, 2), f"[parallel_train] rank {rank} at {r['index']}")
        # the first tensor group ran (a) and (b), the second (b)'s faults
        runs = [name for name in expected if name in r]
        check(runs == (["sp", "tp", "grid"] if d == 0 else ["grid"]),
              f"[parallel_train] rank {rank} ran {runs}")
        errs, faults = {}, {}
        for name in runs:
            want = expected[name]
            got = r[name]["launches"]
            check(got == want, f"[parallel_train] rank {rank} {name}: launches {got}, "
                               f"expected {want}")
            for k, n in got.items():
                total[k] += n
            want_shapes = {str(k): n for k, n in ptr_k_shapes(name).items()}
            got_shapes = {str(k): n for k, n in r[name]["shapes"].items()}
            check(got_shapes == want_shapes, f"[parallel_train] rank {rank} {name}: shapes "
                                             f"{got_shapes}, expected {want_shapes}")
        if d == 0:
            # (a): the loss, and this process's slices of the gradient
            local = ptr_sample([ptr_local(g, lay, None, (0, t))
                                for g, lay in zip(st["tp_grads"], r["tp_layout"])]).cpu()
            errs["tp"] = max(abs(r["tp_out"]["loss"] - st["tp_loss"]) / abs(st["tp_loss"]),
                             rel(r["tp_out"]["controlnet"], local))
            faults["TP with f's backward an identity"] = (
                "tp", rel(r["tp_no_f"]["controlnet"], local))
            errs["sp"] = max(rel(r["sp_out"][k], st["sp"][k].cpu())
                             for k in ("x", "c_img", "controlnet"))
        else:
            for label, key in (("SP with the GroupNorm sums' backward local", "sp_local_gn"),
                               ("SP with the halo gradients dropped", "sp_dropped_halos")):
                faults[label] = ("sp", max(rel(r[key][k], st["sp"][k].cpu())
                                           for k in ("x", "c_img", "controlnet")))
        # (c): the loss, this process's shards of the first moments and masters
        lay = r["grid_out"]["layout"]
        ref_m = ptr_sample([ptr_local(m, tp_, dim, (d, t))
                            for m, (tp_, dim) in zip(grid["masters"], lay)]).cpu()
        ref_e = ptr_sample([ptr_local(e, tp_, dim, (d, t))
                            for e, (tp_, dim) in zip(grid["exp_avg"], lay)]).cpu()
        g_out = r["grid_out"]
        check(all(np.isfinite(g_out["losses"])), f"[parallel_train] rank {rank}: a non-finite "
                                                 f"loss {g_out['losses']}")
        errs["grid"] = max(max(abs(a - b) / abs(b) for a, b in zip(g_out["losses"],
                                                                     grid["losses"])),
                           rel(g_out["exp_avg"], ref_e))
        errs["masters"] = flipped(g_out["masters"], ref_m)
        # the fault's one step against one process's first
        bad, first = r["grid_seeds_apart"], grid["after_1"]
        faults["the grid with the tensor ranks seeded apart, one step"] = (
            "grid", max(abs(bad["losses"][0] - grid["losses"][0]) / abs(grid["losses"][0]),
                        rel(bad["exp_avg"], ptr_sample(
                            [ptr_local(e, tp_, dim, (d, t))
                             for e, (tp_, dim) in zip(first["exp_avg"], lay)]).cpu())))
        faults["the grid's masters, the tensor ranks seeded apart, one step"] = (
            "masters", flipped(bad["masters"], ptr_sample(
                [ptr_local(m, tp_, dim, (d, t))
                 for m, (tp_, dim) in zip(first["masters"], lay)]).cpu()))
        for name, err in errs.items():
            check(err <= PTR_TOL[name], f"[parallel_train] rank {rank} ({name}) against one "
                                        f"process: {err} > {PTR_TOL[name]}")
        print(f"[parallel_train] rank {rank} (data {d}, tensor {t}) against one process "
              f"(limit; one process's spread): " + "; ".join(
                  f"({n}) {e:.3e} ({PTR_TOL[n]:.3g}; {spreads[n]:.3e})" for n, e in errs.items()))
        print(f"[parallel_train] rank {rank} planted faults (limit): " + "; ".join(
            f"{label} {err:.3e} ({PTR_TOL[n]:.3g})" for label, (n, err) in faults.items()))
        for label, (n, err) in faults.items():
            check(err > PTR_TOL[n], f"[parallel_train] rank {rank}: {label} passes the limit "
                                    f"{PTR_TOL[n]}: {err}")
        print(f"[parallel_train] {card()} rank {rank}, four processes sharing one card "
              f"(these times measure no speed of the method): s after the spawn: " + ", ".join(
                  f"{what} {at - spawned_at:.1f}" for what, at in r["ready"]) + "; " + "; ".join(
                  f"{name} {r[name]['s']:.3f} s, peak {r[name]['peak']:.2f} GiB" for name in runs))
        print(f"[parallel_train] rank {rank} launches: " + "; ".join(
            f"{name} {r[name]['launches']}" for name in runs))
    losses = [r["grid_out"]["losses"] for r in ranks]
    check(all(x == losses[0] for x in losses), f"[parallel_train] the processes report "
                                               f"different losses {losses}")
    print(f"[parallel_train] (c) losses {losses[0]} (one process {grid['losses']}), grad norms "
          f"{ranks[0]['grid_out']['norms']} (one process {grid['norms']})")
    del st
    torch.cuda.empty_cache()
    ptr_kernel_timing()  # the card alone
    return total


def main() -> int:
    # one card: the first that the caller shows, or the first of the machine
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0] if visible is not None else "0"
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    try:
        from diffbir_tpu_torch.ops import flash_attention as fa
        from diffbir_tpu_torch.ops import fused_ffn as ff
        from diffbir_tpu_torch.ops import fused_resblock as fr
        from diffbir_tpu_torch.ops import quant_matmul as qm
    except ImportError as e:
        print(f"chip_smoke: FAIL: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 1
    fill_kernels()
    tally_wide_lse(fa)
    t_start = time.perf_counter()
    laps = [t_start]

    def lap(name: str) -> None:
        """The seconds of the phases since the last lap, and since the start."""
        now = time.perf_counter()
        print(f"[clock] {name}: {now - laps[-1]:.1f} s ({now - t_start:.1f} s since the start)",
              flush=True)
        laps.append(now)

    try:
        check(torch.cuda.device_count() == 1,
              f"expected one visible card, got {torch.cuda.device_count()}")
        phase_device()
        lap("device")
        phase_build()
        lap("build")
        numbers, wide_err = phase_kernel(fa)
        lap("kernel")
        wide = phase_k1_wide(fa)
        lap("k1_wide")
        numbers["K1_wide"] = {**wide, "max_abs_err": max(wide["max_abs_err"], wide_err)}
        k2 = phase_backward_kernels(fa)
        lap("backward_kernels")
        numbers.update(K2a=k2["dq"], K2b=k2["dkv"], **phase_d512_backward(fa))
        lap("d512_backward")
        for name, phase, lib in (("k3", phase_k3, fa), ("k4", phase_k4, qm), ("k5", phase_k5, qm),
                                 ("k6", phase_k6, fr), ("k7", phase_k7, ff)):
            numbers.update(phase(lib))
            lap(name)
        torch.cuda.empty_cache()
        cldm, swinir = build_models()
        lap("build_models")
        phase_model_call(cldm)
        lap("model_call")
        phase_hoist("default", cldm, {"K1": K1_SITES_PER_STEP}, {})
        lap("hoist")
        paths = {"serve": phase_slice("serve", cldm, swinir, SEEDS)}
        lap("slice")
        paths.update(phase_modes(cldm, swinir))
        lap("modes")
        cldm.set_mode("default")
        phase_samplers(cldm)
        lap("samplers")
        phase_turbo_model(cldm)
        lap("turbo_model")
        phase_fast_gelu(cldm)
        lap("fast_gelu")
        phase_tiled_model_call(cldm)
        lap("tiled_model_call")
        phase_sync_gn_decode(cldm)
        lap("sync_gn_decode")
        phase_sync_gn_memory(cldm)
        lap("sync_gn_memory")
        paths.update(phase_llava(qm, cldm, swinir))
        lap("llava")
        del cldm, swinir
        torch.cuda.empty_cache()
        cli_runs, records = {}, {}
        for path in CLI_PATHS:
            with recording_vae() as records[path]:
                paths[path], cli_runs[path] = phase_cli_request(path)
        lap("cli_paths")
        phase_cleaner_bsrnet()
        lap("cleaner_bsrnet")
        paths.update(phase_guidance(records["cli_request"]))
        lap("guidance")
        paths.update(phase_guidance_1024(fa))
        lap("guidance_1024")
        paths.update(phase_turbo_cli(cli_runs))
        lap("turbo_cli")
        for path, spec in FAST_GELU_PATHS.items():
            paths[path], _ = phase_cli_request(path, spec)
        lap("fast_gelu_cli")
        paths.update(phase_tiled_request())
        lap("tiled_request")
        det, parse = random_face_models(20)
        phase_face_detect(det)
        lap("face_detect")
        phase_face_parse(parse)
        lap("face_parse")
        phase_face_blur()
        lap("face_blur")
        paths["cli_unaligned_face"] = phase_cli_unaligned_face(det, parse)
        lap("cli_unaligned_face")
        del det, parse
        paths["http_serve"] = phase_http_serve()
        lap("http_serve")
        paths["demo_http"] = phase_demo_http()
        lap("demo_http")
        paths["train"] = phase_train(fa)
        lap("train")
        ram_model = build_ram()
        phase_ram(ram_model)
        lap("ram")
        paths["cli_ram_caption"] = phase_cli_ram_caption(ram_model)
        lap("cli_ram_caption")
        del ram_model
        torch.cuda.empty_cache()
        flist = write_train_folder()
        phase_train_data(flist)
        lap("train_data")
        paths["train_cli"] = phase_train_cli(flist)
        lap("train_cli")
        paths["train_ddp"] = phase_train_ddp()
        lap("train_ddp")
        paths["train_native"] = phase_train_native(flist)
        lap("train_native")
        paths["train_custom"] = phase_train_custom()
        lap("train_custom")
        paths["train_stage1"] = phase_train_stage1()
        lap("train_stage1")
        paths["degrade_batch"] = phase_degrade_batch()
        lap("degrade_batch")
        torch.cuda.empty_cache()
        st = parallel_references()
        lap("parallel_references")
        paths["parallel_inference"] = phase_parallel_inference(st)
        lap("parallel_inference")
        paths["parallel_nccl"] = phase_parallel_nccl(st)
        lap("parallel_nccl")
        del st
        torch.cuda.empty_cache()
        paths["parallel_train"] = phase_parallel_train()
        lap("parallel_train")
        cli = {path: expected for path, (expected, _) in {
            **CLI_PATHS, **GUIDANCE_PATHS, **GUIDED_1024_PATHS, **TURBO_PATHS,
            **FAST_GELU_PATHS}.items()}
        tiled = {f"tiled_{name}": expected for name, (_, expected) in TILED_VARIANTS.items()}
        served = {"cli_unaligned_face": UNALIGNED, "http_serve": CLI_DEFAULT,
                  "demo_http": CLI_DEFAULT, "cli_ram_caption": CLI_DEFAULT,
                  "train_custom": CLI_DEFAULT,
                  "train_cli": {"K1": 1, "K1_wide": 1, "K2a": 1, "K2b": 1},
                  "train_ddp": {"K1": 1, "K1_wide": 1, "K2a": 1, "K2b": 1},
                  "train_native": {}, "train_stage1": {}, "degrade_batch": {},
                  "parallel_inference": {**CLI_DEFAULT, "K3": 1, "K4": 1, "K4_gemv": 1,
                                         "K6": 1, "K7": 1},
                  "parallel_nccl": CLI_DEFAULT,
                  "parallel_train": {"K1": 1, "K2a": 1, "K2b": 1}}
        for path, expected in {**PER_REQUEST, **CAPTION_PATHS, **cli, **tiled,
                               **served}.items():
            # no other kernel
            check(all(n == 0 for k, n in paths[path].items() if k not in expected),
                  f"{path} launched other kernels: {paths[path]}")
        print("[done] launches of the CUDA-core entries per path: " + "; ".join(
            f"{path} " + ", ".join(f"{k} {n[k]}" for k in ("K1_cc", "K2a_cc", "K2b_cc", "K3_cc",
                                                           "K4_cc", "K5_cc", "K6_cc", "K7_cc"))
            for path, n in paths.items()))
    except (SmokeFailure, RuntimeError) as e:
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    src, ref = "diffbir_tpu_torch/csrc/", "diffbir_tpu/ops/"
    entries = (
        ("K1", "flash_attention_fwd_tc", "flash_attention_fwd.cu", "flash_attention.py:81"),
        ("K1_wide", "flash_attention_fwd_wide_tc", "flash_attention_fwd.cu",
         "flash_attention.py:81"),
        ("K1_cc", "flash_attention_fwd", "flash_attention_fwd.cu", "flash_attention.py:81"),
        ("K2a", "flash_attention_bwd_dq_tc", "flash_attention_bwd.cu", "flash_attention.py:371"),
        ("K2b", "flash_attention_bwd_dkv_tc", "flash_attention_bwd.cu",
         "flash_attention.py:410"),
        ("K2_delta", "flash_attention_bwd_delta", "flash_attention_bwd.cu",
         "flash_attention.py:396"),
        ("K2a_wide", "flash_attention_bwd_dq_wide_tc", "flash_attention_bwd.cu",
         "flash_attention.py:371"),
        ("K2b_wide", "flash_attention_bwd_dkv_wide_tc", "flash_attention_bwd.cu",
         "flash_attention.py:410"),
        ("K2a_cc", "flash_attention_bwd_dq", "flash_attention_bwd.cu", "flash_attention.py:371"),
        ("K2b_cc", "flash_attention_bwd_dkv", "flash_attention_bwd.cu",
         "flash_attention.py:410"),
        ("K3", "flash_attention_fwd_prescaled_tc", "flash_attention_fwd.cu",
         "flash_attention.py:229"),
        ("K3_cc", "flash_attention_fwd_prescaled", "flash_attention_fwd.cu",
         "flash_attention.py:229"),
        ("K4", "quant_matmul_tc", "quant_matmul.cu", "quant_matmul.py:45"),
        ("K4_gemv", "quant_matmul_gemv", "quant_matmul.cu", "quant_matmul.py:45"),
        ("K4_cc", "quant_matmul", "quant_matmul.cu", "quant_matmul.py:45"),
        ("K5", "quant_matmul_int4_tc", "quant_matmul_int4.cu", "quant_matmul.py:232"),
        ("K5_gemv", "quant_matmul_int4_gemv", "quant_matmul_int4.cu", "quant_matmul.py:232"),
        ("K5_cc", "quant_matmul_int4", "quant_matmul_int4.cu", "quant_matmul.py:232"),
        ("K6", "fused_resblock_tc", "fused_resblock.cu", "fused_resblock.py:141"),
        ("K6_cc", "fused_resblock", "fused_resblock.cu", "fused_resblock.py:141"),
        ("K7", "fused_ffn_tc", "fused_ffn.cu", "fused_ffn.py:91"),
        ("K7_cc", "fused_ffn", "fused_ffn.cu", "fused_ffn.py:91"),
    )
    kernels = []
    for key, name, source, replaces in entries:
        by_path = {path: n[key] for path, n in paths.items()}
        kernels.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": ref + replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **numbers[key]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
