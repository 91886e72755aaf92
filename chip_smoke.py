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
     at d = 64 and 128, the CUDA-core entries K2a_cc/K2b_cc for fp32 and d =
     256/512), K4 (int8 matmul: the tensor-core tile form, the GEMV form
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
     twice from one seed: finite, bit-identical, K1 only.
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
     ``pipeline.run`` of the request, a rerun bit-identical.
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
     on a seeded 256x256 PNG at --upscale 4 (a 1024x1024 condition) in six
     variants (TILED_VARIANTS: every tiling, once more bit-identical; 3
     tiles a call; the sync_gn VAE; the diffusion alone tiled; untiled;
     the int8 flags): exact launches (K1_wide 2 where the VAE is untiled),
     seconds per stage, peak device memory (the tiled one below the
     untiled), the PNG's size.
 10. training path: stage-2 IRControlNet train steps at full width (SD2.1 +
     IRControlNet with gradient checkpointing, ControlNet initialised from the
     UNet, frozen realesrgan SwinIR cleaner, v2.1 schedule, noise aug at 200,
     lr 1e-5), batch 8 at 512x512 from seeded numpy, empty prompts: 2 warm-up
     and 5 timed steps; finite losses, only the ControlNet changes, K1/K2a/K2b
     launches per step (all on the tensor-core entries, none on the CUDA-core
     ones); then at batch 2 one step's ControlNet gradient through
     K1+K2 against the same through plain attention, and the same with the
     attention sites' q/k/v gradients dropped must fail the limits.
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
SEEDS = (1, 2, 3)
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
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_TIMED = 8, 2, 5
# kernel vs plain attention, one step's ControlNet gradient at batch 2 in
# bf16: both paths round every activation and gradient to bf16 and differ
# only where attention rounds (one bf16 ulp of an element, see BF16_TOL).
# Measured on an H100: norms 1.8e-4 apart, 1 - cosine 7e-6; the limits are
# ~10x those. The same step with the attention sites' q/k/v gradients dropped
# must fail them (the check's power is shown in the run).
GRAD_COS_MIN, GRAD_NORM_REL_TOL = 0.9999, 2e-3
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
CLI_PATHS = {
    "cli_request": ({"K1": K1_SITES_PER_STEP * CLI_STEPS, "K1_wide": K1_WIDE_PER_REQUEST}, []),
    "cli_request_int8": ({"K3": K3_PER_CALL * CLI_STEPS, "K6": K6_PER_CALL * CLI_STEPS,
                          "K4": K4_PER_STEP * CLI_STEPS + K4_PER_HOIST,
                          "K1_wide": K1_WIDE_PER_REQUEST},
                         ["--quant_dense", "--fused_resblock", "--quant_conv"]),
}
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
TILED_CALLS = CLDM_TILES * CLI_STEPS
INT8_FLAGS = ["--quant_dense", "--fused_resblock", "--quant_conv"]
TILED_VARIANTS = {
    "a": (TILED_ALL, {"K1": TILED_CALLS * K1_SITES_PER_STEP}),
    "b": (TILED_ALL + ["--cldm_tiles_per_batch", "3"],
          {"K1": TILED_CALLS // 3 * K1_SITES_PER_STEP}),
    "c": (TILED_ALL + ["--vae_tile_mode", "sync_gn"], {"K1": TILED_CALLS * K1_SITES_PER_STEP}),
    "d": (["--cldm_tiled"], {"K1": TILED_CALLS * K1_SITES_PER_STEP,
                             "K1_wide": K1_WIDE_PER_REQUEST}),
    "e": ([], {"K1": CLI_STEPS * K1_SITES_PER_STEP, "K1_wide": K1_WIDE_PER_REQUEST}),
    "f": (TILED_ALL + ["--cldm_tiles_per_batch", "3"] + INT8_FLAGS,
          {"K3": TILED_CALLS // 3 * K3_PER_CALL, "K6": TILED_CALLS // 3 * K6_PER_CALL,
           "K4": TILED_CALLS // 3 * K4_TILE_PER_CALL,
           "K4_gemv": TILED_CALLS // 3 * K4_GEMV_PER_CALL}),
}
# the VAE's mid-block attention of an untiled request at 1024x1024 and at
# 1024x512 (8192 latent tokens)
VAE_MID_SHAPES = ((1, TILED_SIZE ** 2 // 64, 1, 512), (1, 8192, 1, 512))
# the other samplers of the CLI, one 256x256 request each, twice
SAMPLER_SIZE, SAMPLER_STEPS = 256, 4
MODE_SEEDS = (1, 2)
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


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    for line in smi.stdout.strip().splitlines():
        print(line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[device] torch", torch.__version__, "cuda", torch.version.cuda,
          "| TF32 off for fp32 matmuls and cuDNN convolutions")


# name -> CudaKernel of every kernel the port has, filled by main() once the
# port is imported
KERNELS = {}


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
    tensor_core_sass(_cuda, "K1", ("flash_fwd_tc_kernel", "flash_fwd_wide_kernel"))
    tensor_core_sass(_cuda, "K2a", ("flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel"))
    tensor_core_sass(_cuda, "K4", ("quant_matmul_tc_kernel",))
    tensor_core_sass(_cuda, "K5", ("int4_tc_kernel",))
    tensor_core_sass(_cuda, "K6", ("conv_tc_kernel",))
    tensor_core_sass(_cuda, "K7", ("geglu_tc_kernel", "down_tc_kernel"))


def tensor_core_sass(_cuda, key: str, names) -> None:
    """HGMMA (wgmma) and HMMA (mma.sync) instructions per kernel function of
    the library of KERNELS[key], from cuobjdump -sass; the tensor-core
    kernels ``names`` must have some."""
    nvcc = _cuda.find_nvcc()
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(tool):
        print("[build] cuobjdump not in the toolkit: SASS not counted")
        return
    lib = _cuda.build(KERNELS[key].source)[0]
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120).stdout
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
        check(moved == {"K1_wide": 1}, f"K1 at {label} launched {moved}, expected one K1_wide")
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
    entries = ("K2a", "K2b", "K2a_cc", "K2b_cc")
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
        want = ({"K2a": 1, "K2b": 1, "K2a_cc": 0, "K2b_cc": 0} if tensor_cores
                else {"K2a": 0, "K2b": 0, "K2a_cc": 1, "K2b_cc": 1})
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
        entry = "tensor-core entries" if tensor_cores else "CUDA-core entries"
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


def build_models():
    import torch

    from diffbir_tpu_torch.models.cldm import ControlLDM
    from diffbir_tpu_torch.models.layers import random_init_
    from diffbir_tpu_torch.models.swinir import SwinIR

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cldm = ControlLDM.sd21(dtype=torch.bfloat16, device="meta").to_empty(device="cuda")
    random_init_(cldm, gen).eval()
    swinir = SwinIR(dtype=torch.bfloat16, device="meta").to_empty(device="cuda")
    random_init_(swinir, gen).eval()
    torch.cuda.synchronize()
    n = sum(p.numel() for p in cldm.parameters())
    ns = sum(p.numel() for p in swinir.parameters())
    print(f"[models] sd21 ControlLDM {n / 1e6:.1f} M params, SwinIR {ns / 1e6:.2f} M, "
          f"bf16, random from seed 0, built in "
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


def counts() -> dict:
    return {name: kernel.launches for name, kernel in KERNELS.items()}


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


def phase_cli_request(path: str):
    """[cli_request]: ``python -m diffbir_tpu_torch.inference`` run in this
    process (``main``) on a seeded 128x128 PNG with --upscale 4 and the
    CLI's defaults (v2.1, 10 steps of edm_dpm++_3m_sde at CFG 6.0, the
    default prompts through a stand-in merges file written here), random
    full-width weights (DIFFBIR_TPU_RANDOM_INIT), plus the path's flags:
    exact launches, seconds per stage, the PNG equal to a direct
    ``pipeline.run`` of the request, and a rerun bit-identical. Returns the
    launch counts of the entry point's run."""
    import shutil

    import numpy as np
    import torch

    from diffbir_tpu_torch.inference.__main__ import main
    from diffbir_tpu_torch.utils.image_io import read_png, read_rgb, write_png

    expected, flags = CLI_PATHS[path]
    root = os.path.join("build", "cli_request", path)
    shutil.rmtree(root, ignore_errors=True)
    in_dir, out_dir = os.path.join(root, "in"), os.path.join(root, "out")
    os.makedirs(in_dir)
    write_png(os.path.join(in_dir, "lq.png"), np.random.default_rng(7).integers(
        0, 256, (CLI_LQ, CLI_LQ, 3), dtype=np.uint8))
    argv = ["--task", "sr", "--input", in_dir, "--output", out_dir,
            "--upscale", str(CLI_UPSCALE), *flags]
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
        size = CLI_LQ * CLI_UPSCALE
        check(out.shape == (size, size, 3) and float(out.std()) > 1.0,
              f"{path}: bad output {out.shape}, std {out.std()}")
        check(n == expected, f"{path}: expected launches {expected}, got {n}")
        lq = loop.after_load_lq(read_rgb(os.path.join(in_dir, "lq.png")))
        a = loop.args
        direct = loop.pipeline.run(
            lq[None], steps=a.steps, pos_prompt=a.pos_prompt, neg_prompt=a.neg_prompt,
            cfg_scale=a.cfg_scale, sampler_type=a.sampler, seed=a.seed, eta=a.eta,
            s_tmax=a.s_tmax, order=a.order)
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
    print(f"[{path}] python -m diffbir_tpu_torch.inference {' '.join(argv)}: {dt:.3f} s "
          f"({stages(first)} s); launches " + ", ".join(f"{k} {v}" for k, v in n.items()))
    print(f"[{path}] the PNG ({size}x{size}) read back equal to pipeline.run's output; a rerun "
          f"of the loop: {dt2:.3f} s ({stages(loop.timings)} s), bit-identical; peak device "
          f"memory {peak:.2f} GiB")
    del loop
    torch.cuda.empty_cache()
    return launches


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
    CLI's defaults, in the variants of TILED_VARIANTS: (a) every tiling
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
            print(f"[tiled_request] {name}: {' '.join(flags) or '(untiled)'}: {dt:.3f} s "
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
    KERNELS.update(K1=fa.KERNEL_TC, K1_wide=fa.KERNEL_WIDE_TC, K1_cc=fa.KERNEL,
                   K2a=fa.KERNEL_DQ_TC,
                   K2b=fa.KERNEL_DKV_TC, K2a_cc=fa.KERNEL_DQ, K2b_cc=fa.KERNEL_DKV,
                   K3=fa.KERNEL_PRESCALED_TC, K3_cc=fa.KERNEL_PRESCALED, K4=qm.KERNEL_TC,
                   K4_gemv=qm.KERNEL_GEMV, K4_cc=qm.KERNEL, K5=qm.KERNEL_INT4_TC,
                   K5_gemv=qm.KERNEL_INT4_GEMV, K5_cc=qm.KERNEL_INT4, K6=fr.KERNEL_TC,
                   K6_cc=fr.KERNEL, K7=ff.KERNEL_TC, K7_cc=ff.KERNEL)
    t_start = time.perf_counter()
    try:
        check(torch.cuda.device_count() == 1,
              f"expected one visible card, got {torch.cuda.device_count()}")
        phase_device()
        phase_build()
        numbers, wide_err = phase_kernel(fa)
        wide = phase_k1_wide(fa)
        numbers["K1_wide"] = {**wide, "max_abs_err": max(wide["max_abs_err"], wide_err)}
        k2 = phase_backward_kernels(fa)
        numbers.update(K2a=k2["dq"], K2b=k2["dkv"], **phase_k3(fa), **phase_k4(qm),
                       **phase_k5(qm), **phase_k6(fr), **phase_k7(ff))
        torch.cuda.empty_cache()
        cldm, swinir = build_models()
        phase_model_call(cldm)
        phase_hoist("default", cldm, {"K1": K1_SITES_PER_STEP}, {})
        paths = {"serve": phase_slice("serve", cldm, swinir, SEEDS)}
        paths.update(phase_modes(cldm, swinir))
        cldm.set_mode("default")
        phase_samplers(cldm)
        phase_tiled_model_call(cldm)
        phase_sync_gn_decode(cldm)
        phase_sync_gn_memory(cldm)
        paths.update(phase_llava(qm, cldm, swinir))
        del cldm, swinir
        torch.cuda.empty_cache()
        for path in CLI_PATHS:
            paths[path] = phase_cli_request(path)
        paths.update(phase_tiled_request())
        paths["train"] = phase_train(fa)
        cli = {path: expected for path, (expected, _) in CLI_PATHS.items()}
        tiled = {f"tiled_{name}": expected for name, (_, expected) in TILED_VARIANTS.items()}
        for path, expected in {**PER_REQUEST, **CAPTION_PATHS, **cli, **tiled}.items():
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
