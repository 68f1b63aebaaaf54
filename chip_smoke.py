#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases group_norm,resize   # a subset

Phases, each printing JSON lines:

1. **device** — the card (``nvidia-smi`` name and power limit), the torch
   and CUDA versions, and the build of every kernel source under
   ``mmlspark_tpu_torch/ops/csrc`` (one ``nvcc`` per source, all started
   together) with the registers and spills ``ptxas`` reports and the
   count of tensor-core instructions (``HMMA``/``HGMMA``, from
   ``cuobjdump -sass``) in each kernel function; the bf16 flash-attention
   kernel, K3's forward kernel and both of K3's backward kernels must have
   some, and K3's forward kernel must not spill;
2. **attention** — the flash-attention kernel against its plain PyTorch
   version on the card, at the shapes the serving path gives it (ViT-B/16
   attention: B in {1, 8, 32}, H=12, T=196, D=64, bf16 and f32, on the
   strided ``[B,T,H,D] → [B,H,T,D]`` view the model passes) and at the
   edge cases (fully masked rows, causal, ragged T=77, Tq ≠ Tk, T=1,
   T=17, D in {32, 128}), with its time with L2 warm and with L2 flushed,
   the plain version's, one PyTorch library call's and the bound;
3. **decode_attention** — the decode-attention kernel against its plain
   version at the generation path's geometry (32 slots, H=12, a 1024-token
   f32 cache horizon, D=64, on the strided layer slice of the cache and the
   q view of the fused projection), with valid lengths drawn in 16–320 and
   one empty slot (exact zeros), and at the edge cases (valid lengths 0,
   1, 31, 32, 33, 320 and 1024 at the kernel's chunk and stage
   boundaries, masks with holes and long gaps, the full horizon, D in
   {32, 128}, a ragged Tk=37), every case launched twice and equal bit
   for bit; one slot-independence check (three slots' outputs unchanged
   bit for bit when every other slot's q, K, V and mask rows are
   replaced); its time with L2 warm and flushed, over the valid keys and
   over the full horizon, against the bound over each, the plain
   version's and ``scaled_dot_product_attention``'s, and its time over a
   sweep of equal valid lengths (0 keys: its fixed cost);
4. **generate** — a causal TransformerTagger at GPT-2 small's widths
   (weights from a seed) served through ``ModelServer.add_generator``: a
   burst of 64 streaming requests (prompts of 16–256 tokens, 64 new tokens
   each) through ``Client.generate(stream=True)``; the decode-attention
   kernel launched exactly 12 times per decode step; every stream equal bit
   for bit to its ``generate_oneshot``; the first decode step's logits
   through the kernel held against the plain attention on the same
   prefilled cache; tokens/s, TTFT, ITL, slot occupancy, one decode step's
   device time, idle share and the kernel's share (``torch.profiler``);
5. **group_norm** — the GroupNorm forward and backward kernels against
   their plain versions at the 12 distinct GroupNorm shapes of ResNet-50
   at 224² (N=64, bf16 and f32, with and without the fused ReLU as the
   network uses it) and at the edge cases (mean 200 / spread 0.02, C=64
   in 32 groups, a ragged H·W, C=96, N=1, a base pointer off 16 bytes,
   an f32 sample past the largest cluster, a group of zeros with bias 0
   on the ReLU's tie); every case launched twice and equal bit for bit
   (the backward once with ``dy`` strided, which its wrapper copies),
   with the body each direction took (the forward's cluster body with its
   plan and the clusters the card holds at once, or its tiled body; the
   backward's cluster body with its plan, k, clusters and CTAs an SM, or
   its five-launch body); every bf16 site of ResNet-50 must take the
   cluster body both ways, and an f32 sample whose x and dy pass 16 × 227
   KB the backward's five-launch body; per shape in bf16 the forward's
   time with L2 warm and flushed, the plain version's, ``F.group_norm``'s
   and the bound, the backward's with L2 warm and flushed, its plain
   closed form's, the autograd route's, ``F.group_norm``'s backward and
   its bound, and their sums over the 53 sites of one forward; and, for
   scale, one launch's time by the same timing (a one-element fill);
6. **resize** — the fused crop → resize → scale kernel against its plain
   version at the training geometry (N=64, 256² source, 240² window,
   224² out, C=3, offsets at 0, at the maximum and out of range) and at
   the edge cases (crop == source, one output row, C=1, a non-square
   window), with its time, the plain version's and the bound;
7. **serve** — ViT-B/16 at full width (weights from a seed) served through
   ``ModelServer(ServeConfig(buckets=(1, 8, 32)))``: concurrent requests
   of 1–20 uint8 224×224×3 images; every answer held against the same rows
   through the plain-attention path on the card; the kernel's launch count
   over the run must be exactly 12 per forward, warmup included; then one
   forward at B=32 timed by CUDA events and one traced by
   ``torch.profiler`` (device busy and idle time, K1's share of it);
8. **train** — ResNet-50 (GroupNorm) at full width trained through
   ``Trainer.fit_arrays`` for 7 steps of 64 rows with on-device
   preprocessing (random 240² window of a 256² uint8 source, bilinear
   resize to 224², flips, ImageNet standardisation): every loss finite,
   the GroupNorm forward and backward kernels launched 53 times and the
   resize kernel once per step (and the copies of a strided ``dy`` the
   backward made); the first step held against the same weights, batch
   and draws through the plain versions, in float32 and in bf16; then
   one step split by CUDA events and traced by ``torch.profiler``
   (device busy and idle time, wall time and images/s, the kernels' and
   the GroupNorm backward's share; the traced step must hold exactly 53
   GroupNorm forward kernels, one a site, 53 calls of the backward
   kernel, each on its cluster body (each of its two kernels 53 times,
   the five-launch body's kernels not at all), and no call of a plain
   GroupNorm route);
9. **block_update** — the ring-hop block-update kernel against its plain
   version at every hop of a ring over the sequence-parallel training
   geometry (N = sp·B = 32, H=12, Tq = Tk = 256, D=64, f32, the first
   training batch's pad mask, causal, each hop's carry from the real
   previous hop), on the same block with every key kept, and at the edge
   cases (a pad-only block on a real carry, which must leave it unchanged
   bit for bit, and on the initial carry, which must stay (-inf, 0, 0);
   the causal diagonal block, pad holes, D in {128, 32}, a ragged
   37 × 200), with its time, the plain version's, the bound over the
   (query, key) pairs the mask keeps, over the 64 × 64 tiles the kernel
   works through and over every key, and SDPA's time over the same block
   without the carry (for reference); then K3's backward kernel against
   its closed form at every hop, with the ring's own cotangents (a loss on
   its output) and with seeded random ones, at the same edge cases and at
   two integer cases whose scores are exact on both sides (duplicated
   keys; the carried m equal to the row max), each launched twice and
   equal bit for bit, each gradient within
   ``block_update_backward_error_bound``, with its time per hop in all
   and by launch (``torch.profiler``) and on hop 1's block with every key
   kept, the closed form's, the autograd route's, SDPA's backward over the
   same block without the carry (for reference), the bound on the CUDA
   cores and the floor on the tensor cores in 3xTF32;
10. **sp_train** — the causal TransformerTagger at GPT-2 small's widths
    (weights from a seed, pad token 0) trained through
    ``Trainer.fit_arrays`` with ``mesh_spec={"sp": 4}`` for 5 steps of 8
    next-token sequences of 512–1024 tokens: every loss finite, the
    block-update kernel launched 48 times a step (12 layers × 4 hops) and
    its backward kernel called 48 times a step (and the cotangents it
    copied); on the first batch the ring's logits held against the
    unsharded forward, and the loss and gradients through the kernels
    against the plain block update; real tokens/s, step time, peak
    memory, and one step under ``torch.profiler`` (device busy and idle,
    K3's forward and backward kernels' share; the traced step must hold
    48 backward calls with each of its two kernels 48 times and no call
    of a plain block-update route);
11. **cifar** — the CIFAR-10 ConvNet (``ConvNet_CIFAR10`` at full
    width, bf16) at the repo's headline setup: (a) trained through
    ``Trainer.fit_arrays`` at batch 1024 on uint8 32×32×3 rows (crop_pad
    4, flips, brightness, contrast; momentum SGD) for 1 + 8 steps: every
    loss finite, no kernel of the port launched (its convs, GEMMs and
    pooling are PyTorch's); images/s, step ms, ``mfu_bf16``,
    input-bound fraction, peak memory, and one synchronised and traced
    step (device busy and idle, top kernels); (b) the float32 model on
    the card against the same weights on the CPU (both nodes), bf16
    against float32, and the first step's loss in bf16
    against float32; (c) 8192 uint8 rows featurized and scored through
    ``TorchModel`` at minibatch 1024 (rows/s, one traced minibatch);
    (d) trained on a learnable class-blob task through the input scoring
    gives it and scored on held-out rows (the loss must fall; accuracy
    and confusion matrix); (e) that bundle served through
    ``ModelServer.add_model`` to single-row requests from 4 clients,
    each answer held against ``TorchModel``'s;
12. **featurize** — columnar pipelines (ROADMAP A6): 2048 uint8 BGR
    images of 240×320 (numpy seed 0) through ``Pipeline([ImageTransformer
    resize 256² → crop 224² → flip, ImageFeaturizer(cut_output_layers=1,
    minibatch_size=64)])`` over full-width ResNet-50 GroupNorm (bf16,
    seed-0 weights), fitted and transformed as one fused segment: one
    upload of the raw uint8 batch and one fetch round (the resized image
    column and the 2048-d features) a minibatch, 53 K5 launches a
    minibatch and no plain GroupNorm call on the card; the fused features
    against ImageFeaturizer alone over the same resized images, the K5
    route against the plain GroupNorm and 8 rows in float32 on the card
    against the CPU; rows/s fused and stage by stage, one traced
    minibatch (busy by kind, K5's share, idle) and peak memory; then
    example 302's pipeline (resize, crop, flip, UnrollImage) on uniform
    64×96 images as one segment, against the host route;
13. **kernels** — one line listing every ported kernel (K5's entry with
    its launches on the featurize path as ``featurize_launches``).

Phases run in the order attention, serve, decode_attention, generate,
group_norm, resize, train, block_update, sp_train, cifar, featurize. Then
the card's name and power limit, and last, when every phase ran, the
result line
``{"ok": true, "device": {...}}``. Any failure exits non-zero
without it, as does a machine without CUDA or a directory without the
package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

PHASES = ("attention", "serve", "decode_attention", "generate",
          "group_norm", "resize", "train", "block_update", "sp_train",
          "cifar", "featurize")
DEV = "cuda"

# the card's published peaks (H100 SXM data sheet, dense): bytes/s of
# device memory and operations/s by operand type
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}

# flash attention, kernel vs plain version, both accumulating in float32.
# The f32 instance multiplies the same float32 operands; they differ in
# summation order and in expf against torch.exp. The bf16 instance runs
# both products on the tensor cores: each product of two bf16 values is
# exact in float32, the probabilities are carried as bf16 hi + lo (about
# 2^-17 of each), the exponentials are ex2.approx, and the sums run in
# another order; each of these is a few float32 steps of outputs of
# order 1. Rounding the probabilities to bf16 once would be about 1e-3
KERNEL_TOL = 1e-4

# served (kernel attention) vs the plain-attention path, on logits: both
# run every layer in bfloat16, so a last-bit difference in one attention
# output can flip a bfloat16 rounding, which the residual stream carries
# through 12 blocks; the two paths also pack rows into different batch
# shapes, so the GEMMs may round differently. Measured 1.6e-2 on logits
# of magnitude up to 3.7 (one bfloat16 step in [2, 4)); the tolerance is
# three such steps
SERVE_TOL = 5e-2

# GroupNorm kernel vs plain version. Both take float32 statistics with the
# centred variance, summed in other orders, and the kernel contracts the
# scale-and-bias into an FMA: float32 outputs of unit spread differ in the
# last bits (GN_TOL_F32). At mean 200 and spread 0.02 one float32 step of
# the mean (1.5e-5) is 7.6e-4 of the spread, and the two sum a group in
# other orders (GN_TOL_OFFSET). In bfloat16 both round one float32 result,
# so a value at a rounding boundary lands one bfloat16 step apart: at most
# 2^-7 of its magnitude (GN_TOL_BF16_REL), plus GN_TOL_F32 for values that
# round to 0
GN_TOL_F32 = 1e-4
GN_TOL_OFFSET = 5e-3
GN_TOL_BF16_REL = 2.0 ** -7
# operations per element of one GroupNorm call: the sum, the centred
# square (sub, mul, add), the normalise (sub, mul, FMA) and the ReLU
GN_OPS_PER_ELEMENT = 9
# the GroupNorm forward kernels' names in a profiler trace that end a
# forward call, one a call: the cluster body's only kernel and the tiled
# body's last (its gn_merge the backward launches too)
GN_KERNEL_NAMES = ("gn_cluster", "gn_apply")
# GroupNorm backward kernel vs its plain version (the closed form), both
# float32 from the same operands: the kernel sums over rows, tiles,
# channels and samples in its own order, takes the statistics from
# shifted sums over tiles of rows merged with Chan's formula, and
# contracts products into FMAs. Each output is held to ops/group_norm.py
# backward_error_bound at GN_BWD_REL of each term's own size (dx:
# r·|gy·s|, and r·mean|s·gy| and r·(|x̂| + 1)·mean|s·gy·x̂| over the
# group for c1 and c2; dscale: Σ|gy|·(|x̂| + 1); dbias: Σ|gy|): float32
# sums of up to 800K terms in another order, and x̂'s relative error, lie
# near 1e-6 of those sizes. An element whose y lies
# that close to 0 may take the other side of the ReLU; the bound grants
# it and its group and channel that (a group of zeros with bias 0 is
# exactly 0 on both sides and is granted nothing: the tie must give 0.5).
# At mean 200 and spread 0.02 the two sides' means differ by a few
# float32 steps of 200 (7.6e-4 of the spread each), which shifts x̂ of a
# whole group: GN_BWD_REL_OFFSET, the forward's pin. A bfloat16 dx adds
# one bfloat16 step of the value (GN_TOL_BF16_REL), both sides rounding
# one float32 result
GN_BWD_REL = 1e-5
GN_BWD_REL_OFFSET = GN_TOL_OFFSET
# operations per element of the function: the statistics (the sum, the
# centred square: 4), x̂ (2), the ReLU's y and its mask (2), the sums of gy
# and gy·x̂ (3), dx (4)
GN_BWD_OPS_PER_ELEMENT = 15
# the backward's five-launch body's kernels in a profiler trace, one each
# a call
GN_BWD_KERNEL_NAMES = ("gn_bwd_stats", "gn_merge", "gn_bwd_reduce",
                       "gn_bwd_merge", "gn_bwd_apply")
# the backward's cluster body's two kernels, one each a call
GN_BWD_CLUSTER_KERNEL_NAMES = ("gn_bwd_cluster", "gn_bwd_fold")

# the resize kernel runs the plain version's float32 operations in the
# same order, each rounded on its own (no FMA): equal bit for bit
RESIZE_TOL = 0.0
# operations per output value: four products, three sums, the scale
RESIZE_OPS_PER_OUTPUT = 8

VIT_HEADS, VIT_TOKENS, VIT_HEAD_DIM = 12, 196, 64
SERVE_BUCKETS = (1, 8, 32)
SERVE_CLIENTS = 6
SERVE_REQUESTS_PER_CLIENT = 8

# the training run: 424 rows = 7 steps of 64, the last with 40 real rows
TRAIN_ROWS, TRAIN_BATCH, TRAIN_SRC = 424, 64, 256
TRAIN_CROP, TRAIN_SIDE, TRAIN_CLASSES = 240, 224, 1000
GN_SITES_RESNET50 = 53
# first step, GroupNorm and resize kernels vs their plain versions on the
# same weights, batch and draws. The step's update (parameters after the
# step minus before) is compared whole: the norm of the difference of two
# updates over the norm of the reference update.
# * float32 model: both routes compute in float32 and differ in the
#   GroupNorm statistics' summation order (and one FMA), ~3e-6 of each
#   output, which 50 layers' forward and backward at random weights grow:
#   measured 1.8e-3 (7.6e-3 for the worst tensor, the stage-0 projection's
#   GroupNorm bias). A wrong statistic or a wrong layout moves the update
#   by order 1;
# * bf16 model: the resize outputs are equal bit for bit, but a GroupNorm
#   output one bf16 step apart changes what the following bf16 convs round,
#   and the layers after it carry that on, so the two routes' updates lie
#   well apart (13%, measured). Each is held against the float32 step: the
#   kernel route may lie at most TRAIN_BF16_RATIO_TOL times as far from it
#   as the plain route does. The loss is a mean over 64 rows of about
#   ln(1000) = 6.9: TRAIN_LOSS_TOL is 1e-3 of it
TRAIN_LOSS_TOL = 7e-3
TRAIN_UPDATE_TOL_F32 = 1e-2
TRAIN_BF16_RATIO_TOL = 1.5


# decode attention: kernel vs plain version, both float32 from the same
# operands; they differ in the order of the sums over D and over the keys
# and in expf against torch.exp. Outputs are weighted means of unit-normal
# values, so 1e-5 is some 100 float32 steps of them
DECODE_TOL = 1e-5
DECODE_SLOTS, DECODE_HEADS, DECODE_HORIZON, DECODE_HEAD_DIM = 32, 12, 1024, 64
DECODE_LENGTHS = (16, 320)
# valid lengths at the kernel's chunk and stage boundaries (8 warps, stages
# of 8 keys), and the equal lengths of the timed sweep
DECODE_EDGE_LENGTHS = (0, 1, 31, 32, 33, 320, 1024, 0)
DECODE_SWEEP_LENGTHS = (0, 8, 32, 64, 128, 192, 256, 320, 1024)

# generation: the repo's causal TransformerTagger at the published widths of
# GPT-2 small (Radford et al. 2019; the Hugging Face gpt2 config: n_embd
# 768, n_head 12, n_layer 12, n_inner 3072, vocab_size 50257, n_positions
# 1024), weights from seed 0. Cut: 64 requests of 64 new tokens each
GEN_MODEL = dict(vocab_size=50257, embed_dim=768, num_heads=12,
                 num_layers=12, mlp_dim=3072, num_tags=50257, max_len=1024,
                 causal=True)
GEN_CONFIG = dict(slots=32, t_max=1024, prefill_buckets=(64, 256),
                  prefill_rows=4, max_new_tokens=64, max_queue=256)
GEN_REQUESTS = 64
GEN_PROMPT_LENGTHS = (16, 256)
# the first decode step's logits through the kernel against the plain
# attention on the same prefilled cache: float32 throughout; the two
# attentions differ by float32 rounding (DECODE_TOL at most), which 12
# layers and a 50257-wide head carry to logits of magnitude up to about 6
# (measured 4.8e-6 apart on an H100)
GEN_LOGIT_TOL = 1e-4

# the ring-hop block update (K3): kernel vs plain version, float32 from the
# same operands. The kernel merges 64-key stripes one after another where
# the plain version takes the whole block in one softmax, and sums the dot
# products in another order: m and acc/denom differ by float32 rounding,
# some 10 steps of values of order 1; 1e-5 is about 100 such steps. The
# kernel runs both products on the tensor cores in 3xTF32 (as K3's
# backward, below), which adds about 6 float32 epsilons of each product:
# on the CPU the plain update with its products so emulated lies 1.2e-6 to
# 1.7e-6 from the JAX package's at a small ring's hops, and with one TF32
# product each about 1.4e-3 (tests/test_torch_block_update.py). Small
# integers are exact in the TF32 high part, so with integer q and k the
# kernel's m must equal the plain version's exactly
BLOCK_TOL = 1e-5
# K3's backward kernel vs its plain version (the closed form), float32 from
# the same operands: the kernel sums the products over D, the keys and the
# query rows in its own order, takes the block max from its own scores and
# takes p by ex2.approx. Each gradient is held to ops/attention.py
# block_update_backward_error_bound at BLOCK_BWD_REL of the sizes of its
# terms. The kernel runs its five products on the tensor cores in 3xTF32
# (each operand split into a TF32 high part and the TF32 rounding of the
# rest; lo.hi + hi.lo + hi.hi): the dropped lo.lo and the rounding of lo
# leave about 3·2^-22 = 6 float32 epsilons of each product, and the tensor
# core truncates as it adds each group of 8 products to the accumulator
# (about one epsilon of the partial sum a step); small integers are exact
# in the high part, so integer scores stay exact. On the CPU the closed
# form with its products so emulated lies within 0.013 of the bound and
# with one TF32 product each 12 to 33 times past it
# (tests/test_torch_block_update_backward.py). A float32 sum of n
# terms taken in another order moves by at most
# (n − 1)·2^-24 of the sum of its terms' sizes and in practice by about
# √n·2^-24; the longest sums run over Tk = 256 keys or D ≤ 128 products,
# √256·2^-24 = 8 float32 epsilons, and 64 epsilons is 8 times that (the
# float32 closed form lies within 0.023 of the bound from its float64
# evaluation at 256 × 256, D = 64, on the CPU). Where the two sides may see
# a tie at the block max differently (a second key or the carried m within
# rounding of it) the bound grants that row the max's whole term; the two
# integer cases, whose scores are exact on both sides, are granted nothing,
# so their ties (the even split over tied keys, the half at m == max) are
# checked
BLOCK_BWD_REL = 64 * 2.0 ** -23
# float32 operations per kept (query, key) pair and head column of the
# backward: five products (s, dp, dq, dk, dv), two operations each
BLOCK_BWD_OPS_PER_PAIR = 10
# TF32 tensor-core products per float32 product of K3's forward and
# backward kernels (3xTF32: lo.hi, hi.lo, hi.hi)
BLOCK_TF32_PRODUCTS = 3
# the backward's two kernels in a profiler trace, one each a call
BLOCK_BWD_KERNEL_NAMES = ("bu_bwd_dq", "bu_bwd_dkdv")
# sequence-parallel training: the generation path's model (GPT-2 small's
# widths, GEN_MODEL) with pad token 0, trained through Trainer.fit_arrays on
# a mesh of SP_RANKS virtual ranks (ring attention, K3 at every hop of every
# layer). Data: SP_ROWS next-token sequences of n+1 tokens, n uniform in
# SP_LENGTHS, right-padded with 0 to max_len; batch SP_BATCH, one epoch
SP_MODEL = dict(GEN_MODEL, pad_token_id=0)
SP_RANKS, SP_BATCH, SP_ROWS, SP_LENGTHS = 4, 8, 40, (512, 1024)
# ring logits through K3 against the same model's unsharded forward (plain
# attention over the whole sequence): float32 throughout; K3 and the
# softmax differ by rounding (BLOCK_TOL at most), which 12 layers and the
# 50257-wide head carry to logits of magnitude up to about 6
SP_LOGIT_TOL = 1e-4
# the first step through K3 against the plain block update on the card,
# same weights and batch: the loss (about ln 50257 = 10.8) within 1e-5 of
# itself, and the gradient: the norm of the difference over the norm of
# the plain route's gradient, over all parameters and in the tensor where
# it is largest (so that a fault confined to the attention weights cannot
# hide behind the head's gradient). The kernel route's backward is K3's
# backward kernel and the plain route's autograd of the plain update: they
# differ by rounding (BLOCK_BWD_REL of each term), at forward values that
# differ by rounding too; a wrong mask, hop or gradient term moves the
# gradient by order 1 (measured on an H100 when both routes ran the plain
# update recomputed under autograd: loss gap 0, gradient gap 1.3e-6 over
# all parameters, 1.8e-6 in the worst tensor)
SP_LOSS_TOL = 1e-4
SP_GRAD_TOL = 1e-4

# the CIFAR-10 ConvNet (ConvNet_CIFAR10 at full width, bf16; ROADMAP A5),
# trained at the repo's headline setup (bench.py:899-941, :1226-1240):
# batch 1024, momentum SGD at 0.01, uint8 32x32x3 rows with on-device
# crop_pad 4, flips, brightness and contrast (no resize, so no kernel of
# the port). Data from numpy's seed 0. Cut: 1 warm-up step and 8 timed
# ones, random labels
CIFAR_BATCH = 1024
CIFAR_STEPS = 9
CIFAR_SPEC = dict(crop_pad=4, flip_lr=True, brightness=0.1,
                  contrast=(0.9, 1.1))
CIFAR_CLASSES = 10
# scoring through TorchModel as bench.py:1016-1030 does: 8192 flat uint8
# rows of 3072 values at minibatch 1024, best of 2 after a warm call
CIFAR_SCORE_ROWS = 8192
# train, then evaluate: a learnable task (the class-blob images of
# tools/build_model_repo.py rounded to uint8), trained through the input
# that scoring gives the model (center_128: input_scale 1 and a mean of
# 128) with Adam, as that tool's _train_eval trains, and scored on the
# held-out rows. Its 1e-3 diverged at full width on these ±128 inputs (a
# loss of 236 at step 2, 59% held out on an H100), 1e-4 did not.
# Cut: CIFAR_EVAL_EPOCHS epochs
CIFAR_EVAL_TRAIN, CIFAR_EVAL_TEST = 8192, 2048
CIFAR_EVAL_BATCH, CIFAR_EVAL_EPOCHS, CIFAR_EVAL_LR = 256, 2, 1e-4
# held-out accuracy floor: chance is 0.1; Adam at 1e-4 and 3e-4 over 2 and
# 4 epochs all scored 1.0 on an H100
CIFAR_EVAL_MIN_ACCURACY = 0.9
# serving: single-row requests through ModelServer from a few clients
CIFAR_SERVE_CLIENTS, CIFAR_SERVE_REQUESTS = 4, 48
CIFAR_SERVE_BUCKETS = (1, 8, 32)
# errors are taken over a whole output, relative to its largest
# magnitude: a float32 sum-order error scales with the sums, not with
# each value (tests/test_torch_convnet.py). Float32 on the card against
# the same weights on the CPU, TF32 off (device.py): both sum each conv's
# 3·3·C products in their own order, over 7 layers (measured 2.3e-6 on
# features and 3.1e-6 on logits on an H100)
CIFAR_F32_TOL = 1e-5
# bf16 against float32 on the card, the same weights: bf16 keeps 8 bits
# (a step of 2^-8 to 2^-7 of a value), every conv and dense output is
# rounded, and 7 layers carry the roundings on (measured 7.8e-3 on
# features, 1.3e-2 on logits)
CIFAR_BF16_TOL = 3e-2
# the first step's loss in bf16 against float32: about ln 10 = 2.3 from
# logits near 0 (inputs scaled to [0, 1]), so the logits' bf16 roundings
# barely reach it (measured 1.3e-5)
CIFAR_LOSS_TOL = 1e-3
# served bf16 logits against TorchModel's for the same row: the two pack
# the row into batches of other sizes, so the convs may take other
# algorithms and round other sums; 1e-2 is one to two bf16 steps of the
# largest logit (measured 1.3e-3)
CIFAR_SERVE_TOL = 1e-2

# featurize (ROADMAP A6): a table of FEAT_ROWS uint8 BGR images of
# FEAT_SRC from numpy seed 0 through the pipeline resize → crop → flip →
# ImageFeaturizer (ResNet-50 GroupNorm at full width, bf16, seed-0
# weights, cut_output_layers 1: the 2048-d pooled features), fitted and
# transformed, at minibatch FEAT_MINIBATCH: one fused segment, so a
# minibatch is one upload of the raw pixels and one fetch round (the
# resized image column and the features). Cut: 2048 rows
FEAT_MODEL = "ResNet50"
FEAT_ROWS, FEAT_SRC, FEAT_MINIBATCH = 2048, (240, 320), 64
FEAT_RESIZE = (256, 256)
FEAT_CROP = dict(x=16, y=16, height=224, width=224)
# bf16 features through two routes that compute the same thing: the fused
# run against ImageFeaturizer alone over the fused run's own resized
# images (the same minibatches, so the same operations), and the K5 route
# against the plain GroupNorm (gn_impl="torch"), where a GroupNorm output
# one bf16 step apart changes what the following bf16 convs round and 49
# later layers carry that on. Each over the largest feature magnitude
FEAT_TOL = 2e-2
# FEAT_F32_ROWS of the resized images through the float32 ResNet-50 on the
# card and through the same weights on the CPU: both float32 with TF32
# off (device.py), differing in the convs' summation order and in K5's
# against the plain GroupNorm's (GN_TOL_F32 of unit-spread outputs at
# most), which 53 normalised sites carry to the pooled features; 1e-3 of
# the largest magnitude is ten times GN_TOL_F32
FEAT_F32_ROWS, FEAT_F32_TOL = 8, 1e-3
# rows through the plain GroupNorm route, for the kernel-vs-plain check
FEAT_PLAIN_ROWS = 512
# example 302's pipeline (examples/image_transforms_302.py:38-50) on
# FEAT_302_ROWS uniform 64x96 images: resize 60x60, crop 48x48, flip,
# UnrollImage(scale=1/255), one fused segment at the default minibatch
FEAT_302_ROWS, FEAT_302_SRC = 256, (64, 96)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# bytes written before each sample of an L2-cold timing: well past the
# card's 50 MB L2
L2_FLUSH_BYTES = 256 * 2 ** 20
_l2_flush = []


def time_ms(fn, reps: int = 25, warm: int = 3,
            flush_l2: bool = False) -> float:
    """Median device time of ``fn`` in ms, from CUDA events around each
    call. A busy-wait kernel ahead of each sample keeps the stream
    backed up, so the events time the device work and not the host's
    launch gap. ``flush_l2`` writes L2_FLUSH_BYTES before each sample
    (outside the events), so ``fn`` finds its operands in device memory
    and not in L2."""
    import torch
    if flush_l2 and not _l2_flush:
        _l2_flush.append(torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                     device="cuda"))
    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(reps):
        if flush_l2:
            _l2_flush[0].zero_()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """The least time in ms for work that moves ``nbytes`` and does
    ``ops`` operations of type ``dtype``: the larger of the two at the
    card's peaks. Returns (ms, "bytes" | "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_bound(b, h, tq, tk, d, dtype) -> tuple[float, str]:
    """Flash attention on these operands: each input read once (q/k/v in
    their type, the int8 mask), the f32 output written once, and
    4·B·H·Tq·Tk·D operations at the peak for the operand type."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = (b * h * (tq + 2 * tk) * d * elt + b * h * tq * d * 4
              + b * tq * tk)
    return bound(nbytes, 4 * b * h * tq * tk * d, dtype)


def group_norm_bound(n, h, w, c, dtype) -> tuple[float, str]:
    """GroupNorm over ``[N, H, W, C]``: x read once, the output written
    once in x's type, scale and bias read once (f32), and
    GN_OPS_PER_ELEMENT float32 operations an element."""
    elt = 2 if dtype == "bfloat16" else 4
    elems = n * h * w * c
    return bound(2 * elems * elt + 2 * c * 4, GN_OPS_PER_ELEMENT * elems,
                 "float32")


def group_norm_backward_bound(n, h, w, c, dtype) -> tuple[float, str]:
    """The GroupNorm backward over ``[N, H, W, C]``: x and dy read once and
    dx written once in x's type, scale and bias read and dscale and dbias
    written once (f32), and GN_BWD_OPS_PER_ELEMENT float32 operations an
    element."""
    elt = 2 if dtype == "bfloat16" else 4
    elems = n * h * w * c
    return bound(3 * elems * elt + 4 * c * 4,
                 GN_BWD_OPS_PER_ELEMENT * elems, "float32")


def resize_bound(n, ch, cw, oh, ow, c) -> tuple[float, str]:
    """Fused crop → resize → scale: each sample's uint8 window read once,
    the f32 output written once, the int32 offsets read once, and
    RESIZE_OPS_PER_OUTPUT float32 operations an output value."""
    outs = n * oh * ow * c
    return bound(n * ch * cw * c + 4 * outs + 8 * n,
                 RESIZE_OPS_PER_OUTPUT * outs, "float32")


def decode_bound(h, d, lengths, horizon) -> dict:
    """Decode attention's least time, over the keys these inputs need (the
    kernel skips key tiles with no valid key) and over the full horizon:
    K and V rows read once (f32), q read and the f32 output written once,
    the int8 mask read once, 4·H·D operations a key at the f32 peak."""
    s_ = len(lengths)
    fixed = 2 * s_ * h * d * 4 + s_ * horizon
    valid = int(np.sum(lengths))
    out = {}
    for name, keys in (("valid", valid), ("full", s_ * horizon)):
        ms, by = bound(fixed + 2 * h * d * 4 * keys, 4 * h * d * keys,
                       "float32")
        out[name] = {"bound_ms": ms, "bound_us": ms * 1e3, "bound_by": by,
                     "keys": keys}
    return out


# the tensor-core instructions of sm_90: warp-level mma and warpgroup mma
TENSOR_CORE_OPS = ("HMMA", "HGMMA")


def sass_tensor_ops(sass: str) -> dict:
    """Count the tensor-core instructions of each kernel function in
    ``cuobjdump -sass`` output: {function: {"HMMA": n, "HGMMA": m}}."""
    import re
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = dict.fromkeys(TENSOR_CORE_OPS, 0)
            continue
        ins = re.search(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if fn and ins and ins.group(1) in TENSOR_CORE_OPS:
            counts[fn][ins.group(1)] += 1
    return counts


def kernel_tensor_ops(name: str) -> dict:
    """Tensor-core instruction counts per function of kernel library
    ``name`` (built), from ``cuobjdump -sass`` beside nvcc."""
    from mmlspark_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return sass_tensor_ops(sass)


def phase_device() -> dict:
    import torch

    from mmlspark_tpu_torch.ops import _build
    card = nvidia_smi()
    t0 = time.perf_counter()
    build_s = _build.build_all()
    wall = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in build_s}
    tensor_ops = {name: kernel_tensor_ops(name) for name in build_s}
    out = {"phase": "device", "nvidia_smi": card,
           "name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0],
           "build_wall_s": wall, "build_s": build_s, "ptxas": ptxas,
           "tensor_core_ops": tensor_ops}
    emit(out)
    bf16 = {fn: c for fn, c in tensor_ops["flash_attention"].items()
            if "flash_fwd_bf16" in fn}
    check(len(bf16) > 0 and all(sum(c.values()) > 0 for c in bf16.values()),
          f"the bf16 flash-attention kernel has no tensor-core "
          f"instructions: {bf16}")
    for lib, name in (("block_update", "block_update_kernel"),
                      *(("block_update_bwd", n)
                        for n in BLOCK_BWD_KERNEL_NAMES)):
        fns = {fn: c for fn, c in tensor_ops[lib].items() if name in fn}
        check(len(fns) > 0 and all(sum(c.values()) > 0
                                   for c in fns.values()),
              f"K3's kernel {name} has no tensor-core instructions: {fns}")
    spills = [ln for ln in ptxas["block_update"] if "spill" in ln
              and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    check(not spills, f"K3's forward kernel spills: {spills}")
    return out


def _attention_inputs(b, h, tq, tk, d, dtype, gen, strided):
    import torch
    qkv = [torch.randn((b, t, h, d) if strided else (b, h, t, d),
                       generator=gen, device="cuda").to(dtype)
           for t in (tq, tk, tk)]
    # the model's view: [B, T, H, D] projections seen as [B, H, T, D]
    return [x.transpose(1, 2) if strided else x for x in qkv]


def phase_attention() -> dict:
    """Every flash-attention case against the plain version; timings at
    the ViT-B/16 shapes. Returns the figures of the main path's shape
    (B=32, bf16) plus the largest error over every case."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.ops import attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    for b in (1, 8, 32):
        for dt in (bf16, f32):
            cases.append(dict(b=b, h=VIT_HEADS, t=VIT_TOKENS,
                              d=VIT_HEAD_DIM, dtype=dt, lens=None,
                              causal=False, strided=True, timed=True))
    cases += [
        dict(b=4, h=12, t=196, d=64, dtype=bf16, lens=(196, 0, 100, 1),
             causal=False, strided=True, timed=False),
        dict(b=2, h=12, t=196, d=64, dtype=f32, lens=None, causal=True,
             strided=False, timed=False),
        dict(b=4, h=8, t=77, d=64, dtype=bf16, lens=(77, 40, 77, 3),
             causal=True, strided=False, timed=False),
        dict(b=4, h=12, t=196, d=32, dtype=f32, lens=None, causal=False,
             strided=True, timed=False),
        dict(b=4, h=12, t=196, d=128, dtype=bf16, lens=None, causal=False,
             strided=False, timed=False),
        dict(b=4, h=12, t=196, d=32, dtype=bf16, lens=None, causal=False,
             strided=True, timed=False),
        dict(b=2, h=12, t=196, tq=50, d=64, dtype=bf16, lens=(196, 111),
             causal=False, strided=True, timed=False),
        dict(b=3, h=4, t=1, d=64, dtype=bf16, lens=None, causal=False,
             strided=False, timed=False),
        dict(b=3, h=4, t=17, d=64, dtype=bf16, lens=(17, 9, 1),
             causal=True, strided=False, timed=False),
    ]
    worst = 0.0
    main = None
    for c in cases:
        tq = c.get("tq", c["t"])
        q, k, v = _attention_inputs(c["b"], c["h"], tq, c["t"], c["d"],
                                    c["dtype"], gen, c["strided"])
        kv = None
        if c["lens"] is not None:
            kv = (torch.arange(c["t"], device="cuda")[None, :]
                  < torch.tensor(c["lens"], device="cuda")[:, None])
        got = fa.flash_attention(q, k, v, kv_mask=kv, causal=c["causal"])
        torch.cuda.synchronize()
        want = fa.flash_attention(q, k, v, kv_mask=kv, causal=c["causal"],
                                  impl="torch")
        check(got.dtype == torch.float32 and got.shape == want.shape,
              f"kernel output {got.dtype} {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), "kernel output not finite")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        dtype_name = str(c["dtype"]).replace("torch.", "")
        row = {"phase": "kernel", "kernel": "flash_attention",
               "B": c["b"], "H": c["h"], "Tq": tq, "T": c["t"], "D": c["d"],
               "dtype": dtype_name, "kv_lens": c["lens"],
               "causal": c["causal"], "strided": c["strided"],
               "max_abs_err": err, "tol": KERNEL_TOL}
        if c["lens"] is not None and 0 in c["lens"]:
            dead = c["lens"].index(0)
            check(bool((got[dead] == 0).all()),
                  "fully masked rows are not exact zeros")
            row["masked_rows_exact_zero"] = True
        if c["timed"]:
            keep = fa.mask3(c["b"], c["t"], c["t"], None, False, q.device)
            scale = fa.resolve_scale(None, c["d"])

            def kernel():
                return fa._flash_cuda(q, k, v, keep, scale)

            attn_mask = keep[:, None].bool()

            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=attn_mask, scale=scale)

            row["ms"] = time_ms(kernel)
            row["ms_cold_l2"] = time_ms(kernel, flush_l2=True)
            row["plain_ms"] = time_ms(
                lambda: fa.flash_attention_reference(q, k, v, keep, scale))
            row["library_ms"] = time_ms(library)
            row["library_ms_cold_l2"] = time_ms(library, flush_l2=True)
            bound_ms, bound_by = attention_bound(
                c["b"], c["h"], c["t"], c["t"], c["d"], dtype_name)
            row["bound_ms"] = bound_ms
            row["bound_us"] = bound_ms * 1e3
            row["bound_by"] = bound_by
            row["x_bound"] = row["ms"] / bound_ms
            row["x_library"] = row["ms"] / row["library_ms"]
            if c["b"] == max(SERVE_BUCKETS) and c["dtype"] == bf16:
                main = row
        emit(row)
        check(err <= KERNEL_TOL,
              f"flash_attention kernel differs from its plain version by "
              f"{err} > {KERNEL_TOL} on {row}")
    return {**main, "max_abs_err": worst}


def resnet50_gn_sites() -> list[tuple]:
    """``((H, W, C), groups, relu)`` of every GroupNorm call of one
    ResNet-50 forward at 224², in order, read off the model itself."""
    import torch

    from mmlspark_tpu_torch.models.resnet import GroupNorm, resnet50
    model = resnet50(gn_impl="torch")
    sites: list[tuple] = []

    def hook(mod, args, kwargs):
        sites.append((tuple(args[0].shape[1:]), mod.groups,
                      bool(kwargs.get("relu", False))))

    for m in model.modules():
        if isinstance(m, GroupNorm):
            m.register_forward_pre_hook(hook, with_kwargs=True)
    with torch.no_grad():
        model(torch.zeros(1, TRAIN_SIDE, TRAIN_SIDE, 3, device="cuda"))
    return sites


def _gn_body(x, groups) -> dict:
    """The body the GroupNorm kernel takes for ``x``: the cluster plan and
    how many such clusters the card holds at once, or the tiled body."""
    import torch

    from mmlspark_tpu_torch.ops import group_norm as gn
    n, h, w, c = x.shape
    with torch.cuda.device(x.device):
        cp = gn._device_plan(n, h * w, c, x.dtype, groups,
                             gn._pointer_align(x), x.device.index)
    if cp is None:
        return {"body": "tiled"}
    return {"body": "cluster", "plan": cp,
            "clusters_resident": gn.cluster_occupancy(x.dtype, cp)}


def _gn_case(shape, groups, relu, dtype, gen, center=0.0, spread=1.0,
             offset=0, zero_group=False):
    """One GroupNorm case: the kernel launched twice on the same input
    (equal bit for bit) against the plain version. ``offset`` elements
    shift x's base pointer off its allocation's alignment; ``zero_group``
    sets the second group of every sample and its bias to 0 (the group
    normalises to exactly 0, the ReLU's tie)."""
    import torch

    from mmlspark_tpu_torch.ops import group_norm as gn
    numel = int(np.prod(shape))
    x = (center + spread * torch.randn(numel + offset, generator=gen,
                                       device="cuda")).to(dtype)
    x = x[offset:].view(shape)
    scale = torch.randn(shape[-1], generator=gen, device="cuda")
    bias = torch.randn(shape[-1], generator=gen, device="cuda")
    if zero_group:
        cg = shape[-1] // groups
        x[..., cg:2 * cg] = 0
        bias[cg:2 * cg] = 0
    body = _gn_body(x, groups)
    before = gn.cluster_launches
    got = gn.group_norm(x, scale, bias, groups, relu=relu)
    again = gn.group_norm(x, scale, bias, groups, relu=relu)
    torch.cuda.synchronize()
    clustered = gn.cluster_launches - before
    check(clustered == (2 if body["body"] == "cluster" else 0),
          f"{clustered} cluster launches of 2 for {shape} {dtype}, "
          f"expected the {body['body']} body")
    repeat = bool(torch.equal(got, again))
    check(repeat, f"two launches on the same input differ: {shape} {dtype}")
    want = gn.group_norm(x, scale, bias, groups, relu=relu, impl="torch")
    check(got.dtype == dtype and got.shape == want.shape,
          f"kernel output {got.dtype} {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    diff = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        tol = "one bf16 step: 2^-7·|plain| + 1e-4"
        ok = bool((diff <= GN_TOL_BF16_REL * want.float().abs()
                   + GN_TOL_F32).all())
    else:
        atol = GN_TOL_F32 if spread >= 1 else GN_TOL_OFFSET
        tol = atol
        ok = bool((diff <= atol).all())
    row = {"phase": "kernel", "kernel": "group_norm", "shape": list(shape),
           "groups": groups, "relu": relu,
           "dtype": str(dtype).replace("torch.", ""), "center": center,
           "spread": spread, "storage_offset": offset,
           "zero_group": zero_group, **body,
           "bitwise_repeat": repeat, "max_abs_err": float(diff.max()),
           "tol": tol}
    return row, ok, (x, scale, bias)


def _gn_bwd_body(x, dy, groups) -> dict:
    """The body the GroupNorm backward takes for ``x`` and ``dy``: the
    cluster plan, how many such clusters the card holds at once and the
    CTAs that makes an SM (the mean over the SMs), or the five-launch
    body."""
    import torch

    from mmlspark_tpu_torch.ops import group_norm as gn
    n, h, w, c = x.shape
    with torch.cuda.device(x.device):
        cp = gn._device_backward_cluster_plan(
            n, h * w, c, x.dtype, groups, gn._pointer_align(x, dy),
            x.device.index)
    if cp is None:
        return {"body": "five_launch"}
    resident = gn.backward_cluster_occupancy(x.dtype, cp)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return {"body": "cluster", "plan": cp, "k": cp["k"],
            "clusters_resident": resident,
            "ctas_per_sm": resident * cp["k"] / sms}


def _gn_bwd_case(x, scale, bias, groups, relu, gen, rel, zero_group=False):
    """The backward kernel on one case's inputs against its plain version
    (the closed form): launched with ``dy`` contiguous and again with
    ``dy`` as a strided view (which the wrapper copies), equal bit for bit;
    each output within ``backward_error_bound`` at ``rel`` (plus one bf16
    step for a bf16 dx). The row names the body the backward took. Returns
    (row, ok, dy)."""
    import torch

    from mmlspark_tpu_torch.ops import group_norm as gn
    dtype = x.dtype
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    # dy as autograd may hand it over: NCHW-contiguous, seen as NHWC
    strided = dy.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    body = _gn_bwd_body(x, dy, groups)
    before = (gn.backward_launches, gn.backward_dy_copies,
              gn.backward_cluster_launches)
    got = gn._group_norm_bwd_cuda(dy, x, scale, bias, groups,
                                  gn.DEFAULT_EPS, relu)
    again = gn._group_norm_bwd_cuda(strided, x, scale, bias, groups,
                                    gn.DEFAULT_EPS, relu)
    torch.cuda.synchronize()
    clustered = 2 if body["body"] == "cluster" else 0
    after = (gn.backward_launches, gn.backward_dy_copies,
             gn.backward_cluster_launches)
    check(after == (before[0] + 2, before[1] + 1, before[2] + clustered),
          f"backward launches, dy copies and cluster launches {before} -> "
          f"{after}, expected +2, +1, +{clustered} ({body['body']} body)")
    repeat = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    check(repeat, f"two backward launches on the same input differ: "
                  f"{tuple(x.shape)} {dtype}")
    want = gn.group_norm_backward_reference(dy, x, scale, bias, groups,
                                            relu=relu)
    exact = None
    if zero_group:
        cg = x.shape[-1] // groups
        exact = torch.zeros(x.shape, dtype=torch.bool, device="cuda")
        exact[..., cg:2 * cg] = True
    bounds = gn.backward_error_bound(dy, x, scale, bias, groups, rel,
                                     relu=relu, exact=exact)
    ok, errs, ratios = True, {}, {}
    for name, a, b, bnd in zip(("dx", "dscale", "dbias"), got, want,
                               bounds):
        check(a.dtype == (dtype if name == "dx" else torch.float32)
              and a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"backward {name}: {a.dtype} {tuple(a.shape)}, finite "
              f"{bool(torch.isfinite(a).all())}")
        if name == "dx" and dtype == torch.bfloat16:
            bnd = bnd + GN_TOL_BF16_REL * b.float().abs()
        diff = (a.float() - b.float()).abs()
        ok = ok and bool((diff <= bnd).all())
        errs[name] = float(diff.max())
        ratios[name] = float((diff / bnd.clamp_min(1e-30)).max())
    row = {"phase": "kernel", "kernel": "group_norm_backward",
           "shape": list(x.shape), "groups": groups, "relu": relu,
           "dtype": str(dtype).replace("torch.", ""), **body,
           "zero_group": zero_group, "bitwise_repeat": repeat,
           "max_abs_err": max(errs.values()), "abs_err": errs,
           "err_over_bound": ratios, "rel": rel,
           "tol": "backward_error_bound(rel) + one bf16 step of a bf16 dx"}
    return row, ok, dy


def _gn_bwd_expected_body(shape, dtype) -> str | None:
    """The backward body a shape must take: the five-launch body for a
    sample whose x and dy pass 16 × 227 KB; None where either may."""
    import torch

    from mmlspark_tpu_torch.ops import group_norm as gn
    elt = torch.empty((), dtype=dtype).element_size()
    if 2 * int(np.prod(shape[1:])) * elt > gn._MAX_CLUSTER * gn._MAX_SMEM:
        return "five_launch"
    return None


def phase_group_norm() -> dict:
    """The GroupNorm forward and backward kernels against their plain
    versions at every ResNet-50 shape and the edge cases; times at N=64
    bf16 (L2 warm and flushed). Every bf16 site must take the cluster
    body. Returns the per-forward sums over the 53 sites and the largest
    error, forward and (under ``backward``) backward."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.ops import group_norm as gn
    sites = resnet50_gn_sites()
    check(len(sites) == GN_SITES_RESNET50,
          f"{len(sites)} GroupNorm sites in ResNet-50, expected 53")
    shapes: dict[tuple, dict] = {}
    for hwc, groups, relu in sites:
        entry = shapes.setdefault((hwc, groups),
                                  {"sites": 0, "relu": set()})
        entry["sites"] += 1
        entry["relu"].add(relu)
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = TRAIN_BATCH
    worst = worst_bwd = worst_ratio = 0.0
    per_shape, per_shape_bwd = {}, {}

    def backward_case(x, scale, bias, groups, relu, spread, zero=False):
        nonlocal worst_bwd, worst_ratio
        rel = GN_BWD_REL if spread >= 1 else GN_BWD_REL_OFFSET
        row, ok, dy = _gn_bwd_case(x, scale, bias, groups, relu, gen, rel,
                                   zero)
        worst_bwd = max(worst_bwd, row["max_abs_err"])
        worst_ratio = max(worst_ratio, *row["err_over_bound"].values())
        return row, ok, dy

    for (hwc, groups), entry in shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            for relu in sorted(entry["relu"]):
                row, ok, (x, scale, bias) = _gn_case(
                    (n,) + hwc, groups, relu, dtype, gen)
                worst = max(worst, row["max_abs_err"])
                row["sites"] = entry["sites"]
                if dtype == torch.bfloat16:
                    check(row["body"] == "cluster",
                          f"a ResNet-50 bf16 site took the {row['body']} "
                          f"body, not the cluster body: {row}")
                brow, bok, dy = backward_case(x, scale, bias, groups, relu,
                                              1.0)
                brow["sites"] = entry["sites"]
                want_body = "cluster" if dtype == torch.bfloat16 else \
                    _gn_bwd_expected_body((n,) + hwc, dtype)
                check(want_body in (None, brow["body"]),
                      f"a ResNet-50 {dtype} site's backward took the "
                      f"{brow['body']} body, not the {want_body} body: "
                      f"{brow}")
                timed = dtype == torch.bfloat16 and (hwc, groups) \
                    not in per_shape
                if timed:
                    row["ms"] = time_ms(lambda: gn._group_norm_cuda(
                        x, scale, bias, groups, gn.DEFAULT_EPS, relu))
                    row["ms_cold_l2"] = time_ms(
                        lambda: gn._group_norm_cuda(
                            x, scale, bias, groups, gn.DEFAULT_EPS, relu),
                        flush_l2=True)
                    row["plain_ms"] = time_ms(
                        lambda: gn.group_norm_reference(x, scale, bias,
                                                        groups, relu=relu))
                    # the same function without the fused ReLU, on the
                    # channels-last NCHW view, scale and bias in x's type
                    xc = x.permute(0, 3, 1, 2)
                    sc, bc = scale.to(dtype), bias.to(dtype)
                    row["library_ms"] = time_ms(
                        lambda: F.group_norm(xc, groups, sc, bc,
                                             gn.DEFAULT_EPS))
                    # the autograd route: the plain version recomputed
                    # and differentiated
                    row["backward_ms"] = time_ms(
                        lambda: gn.group_norm_backward(dy, x, scale, bias,
                                                       groups, relu=relu))
                    row["bound_ms"], row["bound_by"] = group_norm_bound(
                        n, *hwc, "bfloat16")
                    row["x_bound"] = row["ms"] / row["bound_ms"]
                    per_shape[(hwc, groups)] = row

                    def bwd():
                        gn._group_norm_bwd_cuda(dy, x, scale, bias, groups,
                                                gn.DEFAULT_EPS, relu)
                    brow["ms"] = time_ms(bwd)
                    brow["ms_cold_l2"] = time_ms(bwd, flush_l2=True)
                    brow["plain_ms"] = time_ms(
                        lambda: gn.group_norm_backward_reference(
                            dy, x, scale, bias, groups, relu=relu))
                    brow["autograd_ms"] = row["backward_ms"]
                    # F.group_norm's autograd backward on the same view
                    # (no ReLU), the graph kept so only the backward runs
                    xg = xc.detach().requires_grad_()
                    sg = sc.detach().requires_grad_()
                    bg = bc.detach().requires_grad_()
                    out = F.group_norm(xg, groups, sg, bg, gn.DEFAULT_EPS)
                    dyc = dy.permute(0, 3, 1, 2)
                    brow["library_ms"] = time_ms(
                        lambda: torch.autograd.grad(out, (xg, sg, bg), dyc,
                                                    retain_graph=True))
                    del out, xg, sg, bg
                    brow["bound_ms"], brow["bound_by"] = \
                        group_norm_backward_bound(n, *hwc, "bfloat16")
                    brow["x_bound"] = brow["ms"] / brow["bound_ms"]
                    brow["x_library"] = brow["ms"] / brow["library_ms"]
                    per_shape_bwd[(hwc, groups)] = brow
                emit(row)
                emit(brow)
                check(ok, f"group_norm kernel differs from its plain "
                          f"version past tolerance on {row}")
                check(bok, f"group_norm backward kernel differs from its "
                           f"plain version past tolerance on {brow}")
                del x, scale, bias, dy
    # shape, groups, relu, dtype, center, spread, storage offset, and a
    # group of zeros with bias 0 (the ReLU's tie)
    edge = [((4, 28, 28, 256), 32, True, torch.float32, 200.0, 0.02, 0),
            ((2, 9, 9, 64), 32, True, torch.bfloat16, 0.0, 1.0, 0),
            ((n, 13, 11, 96), 32, False, torch.bfloat16, 0.0, 1.0, 0),
            ((n, 7, 7, 2048), 32, True, torch.float32, 0.0, 1.0, 0),
            ((1, 56, 56, 256), 32, True, torch.bfloat16, 0.0, 1.0, 0),
            ((1, 7, 7, 512), 32, False, torch.float32, 0.0, 1.0, 0),
            ((n, 14, 14, 256), 32, True, torch.bfloat16, 0.0, 1.0, 1),
            ((n, 28, 28, 128), 32, False, torch.float32, 0.0, 1.0, 1),
            ((4, 112, 112, 128), 32, True, torch.float32, 0.0, 1.0, 0)]
    edge = [e + (False,) for e in edge] + [
        ((n, 28, 28, 128), 32, True, torch.bfloat16, 0.0, 1.0, 0, True),
        ((8, 56, 56, 64), 32, True, torch.float32, 0.0, 1.0, 0, True)]
    for shape, groups, relu, dtype, center, spread, offset, zero in edge:
        row, ok, (x, scale, bias) = _gn_case(shape, groups, relu, dtype,
                                             gen, center, spread, offset,
                                             zero)
        worst = max(worst, row["max_abs_err"])
        row["edge"] = True
        emit(row)
        check(ok, f"group_norm kernel differs from its plain version past "
                  f"tolerance on {row}")
        brow, bok, _ = backward_case(x, scale, bias, groups, relu, spread,
                                     zero)
        brow.update(edge=True, center=center, spread=spread,
                    storage_offset=offset)
        want_body = _gn_bwd_expected_body(shape, dtype)
        check(want_body in (None, brow["body"]),
              f"the backward took the {brow['body']} body, not the "
              f"{want_body} body: {brow}")
        emit(brow)
        check(bok, f"group_norm backward kernel differs from its plain "
                   f"version past tolerance on {brow}")
        del x, scale, bias
    total = {key: sum(r[key] * r["sites"] for r in per_shape.values())
             for key in ("ms", "ms_cold_l2", "plain_ms", "library_ms",
                         "bound_ms", "backward_ms")}
    # what one launch costs by the same timing: a one-element fill
    one = torch.empty(1, device="cuda")
    launch_floor = time_ms(one.zero_)
    out = {"phase": "kernel", "kernel": "group_norm",
           "per_forward": "sum over the 53 sites of one ResNet-50 "
                          "forward, N=64, bf16",
           "launch_floor_ms": launch_floor,
           "distinct_shapes": len(per_shape),
           "elements_per_sample": sum(int(np.prod(s[0])) for s in sites),
           **total, "x_bound": total["ms"] / total["bound_ms"],
           "x_bound_cold_l2": total["ms_cold_l2"] / total["bound_ms"],
           "cuda_launches_per_forward": sum(
               r["sites"] * (1 if r["body"] == "cluster" else 3)
               for r in per_shape.values()),
           "max_abs_err": worst}
    emit(out)
    total_bwd = {key: sum(r[key] * r["sites"]
                          for r in per_shape_bwd.values())
                 for key in ("ms", "ms_cold_l2", "plain_ms", "autograd_ms",
                             "library_ms", "bound_ms")}
    emit({"phase": "kernel", "kernel": "group_norm_backward",
          "per_forward": "sum over the 53 sites of one ResNet-50 "
                         "backward, N=64, bf16",
          **total_bwd, "x_bound": total_bwd["ms"] / total_bwd["bound_ms"],
          "x_bound_cold_l2": total_bwd["ms_cold_l2"]
          / total_bwd["bound_ms"],
          "x_library": total_bwd["ms"] / total_bwd["library_ms"],
          "x_autograd": total_bwd["ms"] / total_bwd["autograd_ms"],
          "cuda_launches_per_forward": sum(
              r["sites"] * len(GN_BWD_CLUSTER_KERNEL_NAMES
                               if r["body"] == "cluster"
                               else GN_BWD_KERNEL_NAMES)
              for r in per_shape_bwd.values()),
          "max_abs_err": worst_bwd, "max_err_over_bound": worst_ratio})
    return {**total, "bound_by": "bytes", "max_abs_err": worst,
            "backward": {**total_bwd, "bound_by": "bytes",
                         "max_abs_err": worst_bwd}}


def _resize_case(n, h, w, c, crop, out_hw, gen, offsets=None):
    import torch

    from mmlspark_tpu_torch.ops import resize as rs
    x = torch.randint(0, 256, (n, h, w, c), generator=gen, device="cuda",
                      dtype=torch.uint8)
    if offsets is None:
        oy = torch.randint(0, h - crop[0] + 1, (n,), generator=gen,
                           device="cuda", dtype=torch.int32)
        ox = torch.randint(0, w - crop[1] + 1, (n,), generator=gen,
                           device="cuda", dtype=torch.int32)
    else:
        oy, ox = (torch.tensor(o, dtype=torch.int32, device="cuda")
                  for o in offsets)
    scale = 1.0 / 255.0
    got = rs.fused_resize_norm(x, oy, ox, crop, out_hw, scale)
    torch.cuda.synchronize()
    want = rs.fused_resize_norm(x, oy, ox, crop, out_hw, scale,
                                impl="torch")
    check(got.dtype == torch.float32 and got.shape == want.shape
          and tuple(got.shape) == (n, *out_hw, c),
          f"kernel output {got.dtype} {tuple(got.shape)}")
    err = float((got - want).abs().max())
    row = {"phase": "kernel", "kernel": "fused_resize_norm",
           "N": n, "src": [h, w, c], "crop": list(crop),
           "out": list(out_hw), "max_abs_err": err, "tol": RESIZE_TOL}
    return row, (x, oy, ox, scale)


def phase_resize() -> dict:
    """The resize kernel against its plain version at the training
    geometry and the edge cases; times at the training geometry."""
    import torch

    from mmlspark_tpu_torch.ops import resize as rs
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, src, crop, side = TRAIN_BATCH, TRAIN_SRC, TRAIN_CROP, TRAIN_SIDE
    hi = src - crop
    rng = np.random.default_rng(0)
    oy = rng.integers(0, hi + 1, n)
    ox = rng.integers(0, hi + 1, n)
    # 0 and the maximum on both axes, then starts out of range: a negative
    # one counts from the end of the axis, then both clamp into the image
    oy[:4], ox[:4] = (0, hi, -5, src + 40), (hi, 0, src + 40, -300)
    cases = [(n, src, src, 3, (crop, crop), (side, side), (oy, ox), True),
             (n, src, src, 3, (crop, crop), (side, side), None, False),
             (4, 64, 48, 3, (64, 48), (32, 40), None, False),
             (3, 20, 16, 3, (14, 9), (1, 11), None, False),
             (3, 20, 16, 1, (14, 9), (6, 11), None, False),
             (4, 100, 80, 3, (90, 50), (64, 48), None, False)]
    worst = 0.0
    main = None
    for nn_, h, w, c, cr, out_hw, offs, timed in cases:
        row, (x, oy_t, ox_t, scale) = _resize_case(nn_, h, w, c, cr,
                                                   out_hw, gen, offs)
        worst = max(worst, row["max_abs_err"])
        if timed:
            row["offsets"] = "0, max, and out of range at rows 0-3"
            row["ms"] = time_ms(lambda: rs._resize_cuda(
                x, oy_t, ox_t, cr, out_hw, scale))
            row["plain_ms"] = time_ms(lambda: rs.fused_resize_norm_reference(
                x, oy_t, ox_t, cr, out_hw, scale))
            row["library_ms"] = None
            row["bound_ms"], row["bound_by"] = resize_bound(
                nn_, *cr, *out_hw, c)
            row["x_bound"] = row["ms"] / row["bound_ms"]
            main = row
        emit(row)
        check(row["max_abs_err"] <= RESIZE_TOL,
              f"fused_resize_norm kernel differs from its plain version on "
              f"{row}")
    return {**main, "max_abs_err": worst}


def _set_attention_impl(module, impl: str) -> None:
    from mmlspark_tpu_torch.models.vit import BhtdSelfAttention
    for m in module.modules():
        if isinstance(m, BhtdSelfAttention):
            m.impl = impl


def _stage_forward(model, x):
    """The model stage's device op on ``x`` (a batch on the card), as the
    planner runs it: a callable for one forward."""
    import torch

    from mmlspark_tpu_torch.core import plan
    from mmlspark_tpu_torch.core.stage import ArrayMeta
    op = model.device_fn(ArrayMeta(tuple(x.shape[1:]),
                                   str(x.dtype).split(".")[-1]))
    params = plan.place(op.params, x.device)

    def forward():
        with torch.inference_mode():
            return op.fn(params, x)

    return forward


def _vit_forward_profile(forward) -> dict:
    """One ViT forward (``forward()``) under ``torch.profiler``, after a
    warm one: host wall (synchronised), the device's busy time and its
    idle share of the wall, K1's kernels (time and count) and their share
    of the busy time, and the busiest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    forward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forward()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    device = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in device)
    k1 = [(ms, n) for key, ms, n in device if "flash_fwd" in key]
    k1_ms = sum(ms for ms, _ in k1)
    k1_calls = sum(n for _, n in k1)
    check(k1_calls == 12, f"{k1_calls} K1 kernels in one profiled forward, "
                          "expected 12")
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share_of_wall": 1 - busy / wall,
            "flash_attention_ms": k1_ms, "flash_attention_launches": k1_calls,
            "flash_attention_share_of_busy": k1_ms / busy,
            "kernels_launched": sum(n for _, _, n in device),
            "top_kernels": [[key[:80], ms, n] for key, ms, n in
                            sorted(device, key=lambda d: -d[1])[:8]]}


def phase_serve(card: str, kernel_ms: float | None) -> int:
    """Serve full-width ViT-B/16; returns the kernel launches of the
    run. ``kernel_ms`` is the kernel's time at the largest bucket (when
    the attention phase ran), for the share of a forward it takes."""
    import torch

    from mmlspark_tpu_torch.data.table import DataTable
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.models.zoo import get_model
    from mmlspark_tpu_torch.ops import attention as fa
    from mmlspark_tpu_torch.serve.config import ServeConfig
    from mmlspark_tpu_torch.serve.server import ModelServer

    t0 = time.perf_counter()
    bundle = get_model("ViT_B16", seed=0)
    model = TorchModel(model=bundle, input_col="image", output_col="scores")
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 21, SERVE_CLIENTS * SERVE_REQUESTS_PER_CLIENT)
    images = rng.integers(0, 256, (int(sizes.sum()), 224, 224, 3),
                          dtype=np.uint8)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    setup_s = time.perf_counter() - t0
    answers: dict[int, np.ndarray] = {}
    latencies: list[float] = []
    errors: list[BaseException] = []
    lock = threading.Lock()

    def client(idx: int, server: ModelServer) -> None:
        try:
            for r in range(idx, len(sizes), SERVE_CLIENTS):
                rows = list(images[offsets[r]:offsets[r] + sizes[r]])
                t = time.perf_counter()
                out = server.predict("vit", DataTable({"image": rows}),
                                     timeout=300)
                lat = (time.perf_counter() - t) * 1e3
                with lock:
                    answers[r] = np.stack(out["scores"])
                    latencies.append(lat)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    # the main path: launch counts from 0 just before, read just after
    fa.launches = 0
    t_load = time.perf_counter()
    server = ModelServer(ServeConfig(buckets=SERVE_BUCKETS))
    try:
        server.add_model("vit", model,
                         example=DataTable({"image": [images[0]]}))
        load_s = time.perf_counter() - t_load
        t_serve = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i, server))
                   for i in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        serve_s = time.perf_counter() - t_serve
        snap = server.snapshot()["vit"]
    finally:
        server.close()
    launches = fa.launches
    if errors:
        raise errors[0]
    forwards = len(SERVE_BUCKETS) + snap["batches"]
    check(launches == 12 * forwards,
          f"{launches} kernel launches for {forwards} forwards "
          f"({len(SERVE_BUCKETS)} warmup + {snap['batches']} batches); "
          "expected 12 per forward")
    check(snap["completed"] == len(sizes) and snap["failed"] == 0,
          f"serving stats {snap}")

    # one forward at the largest bucket, timed on the device, with the
    # kernel and then with the plain attention; and one traced, with the
    # kernel (the events around a forward also see the host's launch gaps
    # once it has more launches to make than the busy-wait covers)
    x = torch.from_numpy(images[:max(SERVE_BUCKETS)]).cuda()
    forward = _stage_forward(model, x)
    forward_ms = time_ms(forward, reps=20)
    launched = fa.launches
    profiled = _vit_forward_profile(forward)
    check(fa.launches == launched + 36,
          "the three forwards of the profile did not launch K1 12 times "
          "each")

    # the same rows through the same weights with the plain attention
    _set_attention_impl(bundle.module, "flash_torch")
    launched = fa.launches
    plain_forward_ms = time_ms(forward, reps=20)
    ref = np.stack(model.transform(
        DataTable({"image": list(images)}))["scores"])
    check(fa.launches == launched, "the plain path launched the kernel")
    worst = 0.0
    for r, got in answers.items():
        check(got.shape == (sizes[r], 1000), f"answer shape {got.shape}")
        check(bool(np.isfinite(got).all()), "non-finite answer")
        want = ref[offsets[r]:offsets[r] + sizes[r]]
        worst = max(worst, float(np.abs(got - want).max()))
    lat = np.asarray(latencies)
    emit({"phase": "serve", "model": "ViT_B16", "card": card,
          "buckets": list(SERVE_BUCKETS), "clients": SERVE_CLIENTS,
          "requests": int(len(sizes)), "rows": int(sizes.sum()),
          "request_sizes": sizes.tolist(),
          "forwards": forwards, "batches": snap["batches"],
          "occupancy_by_bucket": snap["occupancy_by_bucket"],
          "kernel_launches": launches, "launches_per_forward":
          launches / forwards, "setup_s": setup_s, "load_warm_s": load_s,
          "serve_wall_s": serve_s,
          "requests_per_s": len(sizes) / serve_s,
          "rows_per_s": float(sizes.sum()) / serve_s,
          "latency_p50_ms": float(np.percentile(lat, 50)),
          "latency_p99_ms": float(np.percentile(lat, 99)),
          "device_ms_per_batch": snap["device_ms"],
          "forward_ms": {"batch": max(SERVE_BUCKETS), "kernel": forward_ms,
                         "plain_attention": plain_forward_ms,
                         "attention_kernel_share":
                         None if kernel_ms is None
                         else 12 * kernel_ms / forward_ms},
          "forward_profile": profiled,
          "max_abs_err_vs_plain_attention": worst,
          "logit_max_abs": float(np.abs(ref).max()), "tol": SERVE_TOL,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    check(worst <= SERVE_TOL,
          f"served logits differ from the plain-attention path by {worst} "
          f"> {SERVE_TOL}")
    return launches


def _decode_case(s_, h, tk, d, keep_np, gen):
    """q as the model passes it (a view of the fused qkv projection) and
    k/v as layer slices of a two-layer slot-major cache. The kernel runs
    twice on the same inputs and must repeat bit for bit."""
    import torch

    from mmlspark_tpu_torch.ops import attention as fa
    ck = torch.randn(s_, 2, h, tk, d, generator=gen, device=DEV)
    cv = torch.randn(s_, 2, h, tk, d, generator=gen, device=DEV)
    qkv = torch.randn(s_, 1, 3 * h * d, generator=gen, device=DEV)
    q = qkv[..., :h * d].reshape(s_, h, d)
    k, v = ck[:, 1], cv[:, 1]
    keep = torch.from_numpy(keep_np).to(DEV)
    got = fa.decode_attention(q, k, v, kv_mask=keep)
    again = fa.decode_attention(q, k, v, kv_mask=keep)
    torch.cuda.synchronize()
    want = fa.decode_attention(q, k, v, kv_mask=keep, impl="torch")
    check(got.dtype == torch.float32 and got.shape == want.shape,
          f"kernel output {got.dtype} {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    check(torch.equal(got, again),
          f"two decode_attention launches on the same inputs differ "
          f"(S={s_}, H={h}, Tk={tk}, D={d})")
    err = float((got - want).abs().max())
    empty = [i for i in range(s_) if not keep_np[i].any()]
    for i in empty:
        check(bool((got[i] == 0).all()), "an empty slot is not exact zeros")
    row = {"phase": "kernel", "kernel": "decode_attention", "S": s_, "H": h,
           "Tk": tk, "D": d, "valid_keys": int(keep_np.sum()),
           "lengths": [int(x) for x in keep_np.sum(axis=1)],
           "empty_slots": empty, "max_abs_err": err, "tol": DECODE_TOL,
           "bitwise_repeat": True}
    return row, (q, k, v, keep)


def _decode_slot_independence(q, k, v, keep, gen, slots) -> dict:
    """Every slot but ``slots`` gets new q, K, V and mask rows; the kernel's
    outputs of ``slots`` must not change by a bit."""
    import torch

    from mmlspark_tpu_torch.ops import attention as fa
    base = fa.decode_attention(q, k, v, kv_mask=keep)
    others = [i for i in range(q.shape[0]) if i not in slots]
    q2, k2, v2, keep2 = (t.clone() for t in (q, k, v, keep))
    q2[others] = torch.randn(q2[others].shape, generator=gen, device=DEV)
    k2[others] = torch.randn(k2[others].shape, generator=gen, device=DEV)
    v2[others] = torch.randn(v2[others].shape, generator=gen, device=DEV)
    keep2[others] = torch.rand(keep2[others].shape, generator=gen,
                               device=DEV) < 0.5
    got = fa.decode_attention(q2, k2, v2, kv_mask=keep2)
    torch.cuda.synchronize()
    same = bool(torch.equal(base[slots], got[slots]))
    check(same, f"decode_attention output of slots {slots} changed when the "
          "other slots' q, K, V and mask rows were replaced")
    return {"slots": list(slots), "neighbours_replaced": len(others),
            "bitwise_equal": same}


def phase_decode_attention() -> dict:
    """The decode-attention kernel against its plain version at the
    generation geometry and the edge cases, each launched twice (bit for
    bit), with one slot-independence check; times at the geometry with L2
    warm and flushed, over the full horizon, and over a sweep of equal
    valid lengths (the kernel's fixed cost and the cost of its stages)."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.ops import attention as fa
    gen = torch.Generator(device=DEV).manual_seed(0)
    rng = np.random.default_rng(0)
    s_, h, tk, d = (DECODE_SLOTS, DECODE_HEADS, DECODE_HORIZON,
                    DECODE_HEAD_DIM)
    lengths = rng.integers(DECODE_LENGTHS[0], DECODE_LENGTHS[1] + 1, s_)
    lengths[s_ // 2] = 0
    prefix = np.arange(tk)[None, :] < lengths[:, None]
    holes = rng.random((3, 200)) < 0.3
    holes[1] = False
    # the kernel's chunk and stage boundaries: a slot's valid range is cut
    # into 8 warp chunks walked in stages of 8 keys
    edges = np.arange(tk)[None, :] < np.array(DECODE_EDGE_LENGTHS)[:, None]
    gaps = rng.random((4, tk)) < 0.3
    gaps[0, 40:1000] = False
    gaps[1] = False
    gaps[1, [3, 517, 1023]] = True
    gaps[3, :] = False
    gaps[3, 700] = True
    cases = [(s_, h, tk, d, prefix, True),
             (s_, h, tk, d, np.ones((s_, tk), bool), False),
             (len(DECODE_EDGE_LENGTHS), h, tk, d, edges, False),
             (4, h, tk, d, gaps, False),
             (3, h, 200, d, holes, False),
             (4, 4, 300, 128, np.arange(300)[None, :]
              < np.array([300, 1, 0, 129])[:, None], False),
             (4, 2, 37, 32, np.arange(37)[None, :]
              < np.array([37, 17, 0, 33])[:, None], False)]
    worst = 0.0
    main = None
    for cs, ch, ctk, cd, keep_np, timed in cases:
        row, (q, k, v, keep) = _decode_case(cs, ch, ctk, cd, keep_np, gen)
        worst = max(worst, row["max_abs_err"])
        if timed:
            # the longest slot, the empty one and a mid-length one
            row["slot_independence"] = _decode_slot_independence(
                q, k, v, keep, gen, sorted({int(np.argmax(lengths)),
                                            s_ // 2, 0}))
            mask2 = fa.decode_mask2(cs, ctk, keep, q.device)
            scale = fa.resolve_scale(None, cd)

            def kernel(m2=mask2):
                return fa._decode_cuda(q, k, v, m2, scale)

            row["ms"] = time_ms(kernel)
            row["ms_cold_l2"] = time_ms(kernel, flush_l2=True)
            row["plain_ms"] = time_ms(lambda: fa.decode_attention_reference(
                q, k, v, mask2, scale))
            # the library call needs a valid key in every row: the empty
            # slot attends to position 0
            lib_keep = keep.clone()
            lib_keep[:, 0] = True
            lib_mask = lib_keep[:, None, None, :]
            q4 = q[:, :, None, :]
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    q4, k, v, attn_mask=lib_mask, scale=scale))
            bounds = decode_bound(ch, cd, lengths, ctk)
            row["bound_valid_keys"] = bounds["valid"]
            row["bound_full_horizon"] = bounds["full"]
            row["bound_ms"] = bounds["valid"]["bound_ms"]
            row["bound_by"] = bounds["valid"]["bound_by"]
            row["x_bound"] = row["ms"] / row["bound_ms"]
            row["x_bound_cold_l2"] = row["ms_cold_l2"] / row["bound_ms"]
            row["mean_valid_length"] = float(np.mean(lengths))
            # every key valid: the kernel against the full-horizon bound
            full = fa.decode_mask2(cs, ctk, None, q.device)
            row["ms_full_horizon"] = time_ms(lambda: kernel(full))
            row["ms_full_horizon_cold_l2"] = time_ms(lambda: kernel(full),
                                                     flush_l2=True)
            full_ms = bounds["full"]["bound_ms"]
            row["x_bound_full_horizon"] = row["ms_full_horizon"] / full_ms
            row["x_bound_full_horizon_cold_l2"] = (
                row["ms_full_horizon_cold_l2"] / full_ms)
            # every slot at one valid length, L2 warm: 0 keys is the fixed
            # cost (launch, q, the mask scan, the merge), 8 one key a warp,
            # 64 one full stage a warp, 128 two (both in flight from the
            # start), 192 three; from 256 the keys' bytes pass the L2
            sweep = {}
            for n in DECODE_SWEEP_LENGTHS:
                eq = fa.decode_mask2(cs, ctk, torch.arange(
                    ctk, device=q.device)[None, :].expand(cs, ctk) < n,
                    q.device)
                sweep[str(n)] = {
                    "ms": time_ms(lambda: kernel(eq)),
                    "bound_ms": decode_bound(ch, cd, [n] * cs,
                                             ctk)["valid"]["bound_ms"]}
            row["length_sweep"] = sweep
            # one launch's floor by the same timing: a one-element fill
            one = torch.empty(1, device=DEV)
            row["launch_floor_ms"] = time_ms(one.zero_)
            main = row
        emit(row)
        check(row["max_abs_err"] <= DECODE_TOL,
              f"decode_attention kernel differs from its plain version by "
              f"{row['max_abs_err']} > {DECODE_TOL} on {row}")
        del q, k, v, keep
    return {**main, "max_abs_err": worst}


def _gen_prompts() -> list[list[int]]:
    rng = np.random.default_rng(0)
    lo, hi = GEN_PROMPT_LENGTHS
    lengths = rng.integers(lo, hi + 1, GEN_REQUESTS)
    return [rng.integers(1, GEN_MODEL["vocab_size"], n).tolist()
            for n in lengths]


def _decode_step_figures(model, prompts: list[list[int]]) -> dict:
    """Prefill ``slots`` prompts into a fresh cache, then one decode step
    with every slot active: its logits through the kernel against the
    plain attention on the same cache; its device time by CUDA events and
    its host wall (median of 20, each ended by a synchronise); and one step
    under ``torch.profiler``: device busy time, idle share of the wall,
    and the kernel's device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.ops import attention as fa
    from mmlspark_tpu_torch.serve.generate import build_prefill_step
    slots, t_max = GEN_CONFIG["slots"], GEN_CONFIG["t_max"]
    rows = prompts[:slots]
    shape = (slots, GEN_MODEL["num_layers"], GEN_MODEL["num_heads"], t_max,
             GEN_MODEL["embed_dim"] // GEN_MODEL["num_heads"])
    bufs = {"k": torch.zeros(shape, device=DEV),
            "v": torch.zeros(shape, device=DEV)}
    width = max(len(p) for p in rows)
    toks = np.zeros((slots, width), np.int64)
    am = np.zeros((slots, width), bool)
    lengths = np.array([len(p) for p in rows], np.int64)
    for r, p in enumerate(rows):
        toks[r, :len(p)] = p
        am[r, :len(p)] = True
    with torch.no_grad():
        first = build_prefill_step(model)(bufs, toks, am, lengths,
                                          np.arange(slots))
    active = torch.ones(slots, dtype=torch.bool)
    positions = torch.from_numpy(lengths).to(DEV)

    def plain(q, k, v, keep):
        return fa.decode_attention(q, k, v, kv_mask=keep, impl="torch")

    def step(fn=None):
        with torch.no_grad():
            return model.decode_step(first[:, None], (bufs["k"], bufs["v"]),
                                     positions, update_mask=active,
                                     decode_attention_fn=fn)[0]

    logits_kernel = step()
    logits_plain = step(plain)
    err = float((logits_kernel - logits_plain).abs().max())
    out = {"logits_max_abs_err_vs_plain_attention": err,
           "logit_max_abs": float(logits_plain.abs().max()),
           "tol": GEN_LOGIT_TOL,
           "step_ms_events": time_ms(step, reps=20)}
    walls = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["step_ms_wall"] = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    device = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in device)
    k2 = sum(ms for key, ms, _ in device if "decode_fwd_kernel" in key)
    k2_calls = sum(n for key, _, n in device if "decode_fwd_kernel" in key)
    check(k2_calls == GEN_MODEL["num_layers"],
          f"{k2_calls} decode kernels in the profiled step, expected "
          f"{GEN_MODEL['num_layers']}")
    out["profile"] = {
        "device_busy_ms": busy,
        "device_idle_share_of_wall": 1 - busy / out["step_ms_wall"],
        "decode_attention_ms": k2,
        "decode_attention_share_of_busy": k2 / busy,
        "decode_attention_share_of_wall": k2 / out["step_ms_wall"],
        "kernels_launched": sum(n for _, _, n in device),
        "top_kernels": [[key[:80], ms, n] for key, ms, n in
                        sorted(device, key=lambda d: -d[1])[:8]]}
    del bufs
    check(err <= GEN_LOGIT_TOL,
          f"first decode step through the kernel differs from the plain "
          f"attention by {err} > {GEN_LOGIT_TOL} on logits")
    return out


def phase_generate(card: str) -> int:
    """Serve the GPT-2-small-width TransformerTagger through
    ``ModelServer.add_generator``; returns the decode-attention kernel's
    launches over the burst."""
    import torch

    from mmlspark_tpu_torch.models.sequence import (
        TransformerTagger, init_sequence_,
    )
    from mmlspark_tpu_torch.ops import attention as fa
    from mmlspark_tpu_torch.serve.config import GenerateConfig
    from mmlspark_tpu_torch.serve.server import Client, ModelServer

    t0 = time.perf_counter()
    model = init_sequence_(TransformerTagger(device=DEV, **GEN_MODEL),
                           torch.Generator(device=DEV).manual_seed(0))
    params = sum(p.numel() for p in model.parameters())
    prompts = _gen_prompts()
    new_tokens = GEN_CONFIG["max_new_tokens"]
    server = ModelServer()
    try:
        server.add_generator("lm", model, config=GenerateConfig(**GEN_CONFIG),
                             device=DEV)
        setup_s = time.perf_counter() - t0
        client = Client(server)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path: launch counts from 0 just before, read just after
        fa.decode_launches = 0
        t_burst = time.perf_counter()
        streams = [client.generate("lm", p, stream=True) for p in prompts]
        outs = [list(s) for s in streams]
        burst_s = time.perf_counter() - t_burst
        launches = fa.decode_launches
        snap = server.snapshot()["lm"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(launches == GEN_MODEL["num_layers"] * snap["decode_steps"],
              f"{launches} decode kernel launches for "
              f"{snap['decode_steps']} decode steps; expected "
              f"{GEN_MODEL['num_layers']} per step")
        check(snap["completed"] == GEN_REQUESTS and snap["failed"] == 0,
              f"generation stats {snap}")
        for o in outs:
            check(len(o) == new_tokens and all(
                0 <= t < GEN_MODEL["num_tags"] for t in o),
                f"a stream of {len(o)} tokens, expected {new_tokens} ids")
        t_ref = time.perf_counter()
        refs = [server.generate_oneshot("lm", p) for p in prompts]
        oneshot_s = time.perf_counter() - t_ref
    finally:
        server.close()
    differ = [i for i, (o, r) in enumerate(zip(outs, refs)) if o != r]
    check(not differ, f"streams {differ} differ from their one-shot decode")
    figures = _decode_step_figures(model, prompts)
    tokens = sum(len(o) for o in outs)
    emit({"phase": "generate", "model": "TransformerTagger, GPT-2 small "
          "widths", "card": card, "parameters": params,
          "config": {k: list(v) if isinstance(v, tuple) else v
                     for k, v in GEN_CONFIG.items()},
          "requests": GEN_REQUESTS, "prompt_lengths": [len(p) for p in
                                                       prompts],
          "new_tokens_per_request": new_tokens, "setup_s": setup_s,
          "burst_wall_s": burst_s, "tokens": tokens,
          "tokens_per_s": tokens / burst_s,
          "ttft_ms": snap["ttft_ms"], "itl_ms": snap["itl_ms"],
          "decode_steps": snap["decode_steps"],
          "slot_occupancy_mean": snap["slot_occupancy_mean"],
          "kernel_launches": launches,
          "launches_per_decode_step": launches / snap["decode_steps"],
          "streams_equal_oneshot": True, "oneshot_wall_s": oneshot_s,
          "peak_memory_gb": peak_gb,
          "decode_step_32_active": figures})
    return launches


def _train_config(impl: str):
    from mmlspark_tpu_torch.train.loop import TrainConfig
    from mmlspark_tpu_torch.train.preprocess import DevicePreprocess
    return TrainConfig(
        batch_size=TRAIN_BATCH, optimizer="momentum", learning_rate=0.01,
        log_every=1, prefetch_depth=2,
        preprocess=DevicePreprocess(
            src_crop=(TRAIN_CROP, TRAIN_CROP),
            resize=(TRAIN_SIDE, TRAIN_SIDE), flip_lr=True,
            mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
            impl=impl))


def _first_step(gn_impl: str, impl: str, init: dict, batch,
                dtype=None) -> tuple:
    """One step from ``init`` on ``batch`` through the given routes, in
    the model's compute ``dtype`` (default bf16); returns (loss,
    parameters after the step)."""
    import torch

    from mmlspark_tpu_torch.models.zoo import get_model
    from mmlspark_tpu_torch.train.loop import Trainer
    kw = {} if dtype is None else {"dtype": dtype}
    module = get_model("ResNet50", seed=0, gn_impl=gn_impl, **kw).module
    trainer = Trainer(module, _train_config(impl), initial_state_dict=init)
    dx, dy, dw = (torch.from_numpy(a).cuda() for a in batch)
    loss = float(trainer.train_step(dx, dy, dw))
    params = {k: v.detach().clone() for k, v in trainer.state_dict().items()}
    del trainer, module
    return loss, params


def _update_gap(a: dict, b: dict, init: dict) -> dict:
    """How far two runs' updates (parameters after a step minus ``init``)
    lie apart: the norm of their difference over the norm of ``b``'s
    update, over all parameters and for the worst tensor, and the largest
    elementwise gap."""
    diff = norm = 0.0
    worst = (0.0, "")
    for k in a:
        d = float((a[k] - b[k]).float().norm()) ** 2
        u = float((b[k] - init[k]).float().norm()) ** 2
        diff, norm = diff + d, norm + u
        if u > 0:
            worst = max(worst, ((d / u) ** 0.5, k))
    return {"relative": (diff / norm) ** 0.5, "worst_tensor": worst,
            "max_abs": max(float((a[k] - b[k]).abs().max()) for k in a)}


def _step_breakdown(batch) -> dict:
    """Where one training step at N=64 through the kernels spends its
    time. ``wall``: host clock around 5 steps, each ended by a
    synchronise (and images/s from it). ``forward``/``forward_backward``:
    CUDA events (median of 10), which count the device waiting on the
    host too. Then one step under ``torch.profiler``: the device's busy
    time (kernels and copies), its idle share of ``wall``, the device time
    of the GroupNorm forward kernels, of the GroupNorm backward kernels
    (in all and by kernel) and of the resize kernel, and the busiest
    kernels. The traced step must call the backward kernel's wrapper 53
    times, launch each of its cluster body's two kernels 53 times and
    none of its five-launch body's, and call no plain or autograd
    GroupNorm route."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from mmlspark_tpu_torch.models.zoo import get_model
    from mmlspark_tpu_torch.ops import group_norm as gn_op
    from mmlspark_tpu_torch.train.loop import Trainer
    module = get_model("ResNet50", seed=0).module
    trainer = Trainer(module, _train_config("auto"))
    dx, dy, dw = (torch.from_numpy(a).cuda() for a in batch)
    xp = trainer._prep_x(dx, 0)

    def forward():
        with torch.no_grad():
            module(xp)

    def forward_backward():
        per = trainer.loss_fn(module(xp), dy)
        ((per * dw).sum() / dw.sum()).backward()

    out = {"forward": time_ms(forward, reps=10),
           "forward_backward": time_ms(forward_backward, reps=10)}
    for _ in range(2):
        trainer.train_step(dx, dy, dw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        trainer.train_step(dx, dy, dw)
        torch.cuda.synchronize()
    out["wall"] = (time.perf_counter() - t0) / 5 * 1e3

    out["images_per_s"] = TRAIN_BATCH / out["wall"] * 1e3

    inner = gn_op._group_norm_bwd_cuda
    gn_bwd = "chip_smoke.group_norm_backward_kernel"

    def marked_backward(*args, **kwargs):
        with record_function(gn_bwd):
            return inner(*args, **kwargs)

    # the plain routes, which the kernel route must not reach
    plain = {name: getattr(gn_op, name)
             for name in ("group_norm_backward",
                          "group_norm_backward_reference",
                          "group_norm_reference")}
    plain_calls = dict.fromkeys(plain, 0)

    def counted(name):
        def call(*args, **kwargs):
            plain_calls[name] += 1
            return plain[name](*args, **kwargs)
        return call

    gn_op._group_norm_bwd_cuda = marked_backward
    for name in plain:
        setattr(gn_op, name, counted(name))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.train_step(dx, dy, dw)
            torch.cuda.synchronize()
    finally:
        gn_op._group_norm_bwd_cuda = inner
        for name, fn in plain.items():
            setattr(gn_op, name, fn)
    events = prof.key_averages()
    # device work: the kernel and copy events (a host op's own device
    # time repeats its kernels'; the range's device-side annotation spans
    # kernels and gaps). The range's host event sums the device time of
    # the kernels launched inside it
    marked = [e for e in events
              if e.key == gn_bwd and e.device_type == DeviceType.CPU]
    check(len(marked) == 1 and marked[0].count == GN_SITES_RESNET50,
          f"GroupNorm backward kernel calls in the profiled step: "
          f"{[(str(e.device_type), e.count) for e in marked]}")
    check(not any(plain_calls.values()),
          f"the profiled step reached a plain GroupNorm route: "
          f"{plain_calls}")
    device = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in events
              if e.device_type == DeviceType.CUDA and e.key != gn_bwd
              and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in device)
    gn_fwd = [(ms, count) for key, ms, count in device
              if any(k in key for k in GN_KERNEL_NAMES)]
    bwd_kernels = {name: [sum(ms for key, ms, _ in device if name in key),
                          sum(c for key, _, c in device if name in key)]
                   for name in GN_BWD_CLUSTER_KERNEL_NAMES
                   + GN_BWD_KERNEL_NAMES}
    out["profile"] = {
        "device_busy": busy,
        "device_idle_share_of_wall": 1 - busy / out["wall"],
        "wall": out["wall"], "images_per_s": out["images_per_s"],
        "group_norm_forward_kernels": sum(ms for ms, _ in gn_fwd),
        "group_norm_forward_kernel_launches": sum(c for _, c in gn_fwd),
        # the backward's kernels (both bodies) by name: the wrapper's host
        # range gets no device time for kernels launched through ctypes
        "group_norm_backward": sum(ms for ms, _ in bwd_kernels.values()),
        "group_norm_backward_by_kernel": bwd_kernels,
        "plain_group_norm_calls": plain_calls,
        "resize_kernel": sum(ms for key, ms, _ in device
                             if "resize_kernel" in key),
        "top_kernels": [[key[:80], ms, n] for key, ms, n in
                        sorted(device, key=lambda d: -d[1])[:8]]}
    check(out["profile"]["group_norm_forward_kernel_launches"]
          == GN_SITES_RESNET50,
          f"{out['profile']['group_norm_forward_kernel_launches']} GroupNorm "
          "forward kernels in the profiled step, expected one a site (53)")
    check(all(bwd_kernels[name][1] == GN_SITES_RESNET50
              for name in GN_BWD_CLUSTER_KERNEL_NAMES)
          and not any(bwd_kernels[name][1] for name in GN_BWD_KERNEL_NAMES),
          f"GroupNorm backward kernels in the profiled step: {bwd_kernels}, "
          "expected each of the cluster body's once a site (53) and none "
          "of the five-launch body's")
    del trainer, module
    return out


def phase_train(card: str, gn: dict | None, rs: dict | None) -> dict:
    """Train full-width ResNet-50 through ``Trainer.fit_arrays``; returns
    the launch counts of the run. ``gn``/``rs`` are the kernel phases'
    figures (when they ran), for each kernel's share of a step."""
    import torch

    from mmlspark_tpu_torch.models.resnet import gn_sites
    from mmlspark_tpu_torch.models.zoo import get_model
    from mmlspark_tpu_torch.ops import group_norm as gn_op
    from mmlspark_tpu_torch.ops import resize as rs_op
    from mmlspark_tpu_torch.train.loop import Trainer, _batches

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (TRAIN_ROWS, TRAIN_SRC, TRAIN_SRC, 3),
                     dtype=np.uint8)
    y = rng.integers(0, TRAIN_CLASSES, TRAIN_ROWS).astype(np.int64)
    module = get_model("ResNet50", seed=0).module
    check(gn_sites(module) == GN_SITES_RESNET50,
          f"{gn_sites(module)} GroupNorm sites, expected 53")
    init = {k: v.detach().clone() for k, v in module.state_dict().items()}
    cfg = _train_config("auto")
    trainer = Trainer(module, cfg)
    steps = -(-TRAIN_ROWS // TRAIN_BATCH)
    setup_s = time.perf_counter() - t0

    # the main path: launch counts from 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gn_op.launches = gn_op.backward_launches = 0
    gn_op.backward_cluster_launches = gn_op.backward_dy_copies = 0
    rs_op.launches = 0
    t_fit = time.perf_counter()
    trainer.fit_arrays(x, y)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    launches = {"group_norm": gn_op.launches,
                "group_norm_backward": gn_op.backward_launches,
                "group_norm_backward_cluster":
                    gn_op.backward_cluster_launches,
                "fused_resize_norm": rs_op.launches}
    dy_copies = gn_op.backward_dy_copies
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(trainer.global_step == steps, f"{trainer.global_step} steps, "
                                        f"expected {steps}")
    check(len(trainer.history) == steps and all(
        np.isfinite(v) for v in trainer.history),
        f"losses {trainer.history}")
    check(launches["group_norm"] == GN_SITES_RESNET50 * steps,
          f"{launches['group_norm']} group_norm launches in {steps} steps, "
          "expected 53 per step")
    check(launches["group_norm_backward"] == GN_SITES_RESNET50 * steps
          == launches["group_norm_backward_cluster"],
          f"{launches['group_norm_backward']} group_norm backward launches "
          f"({launches['group_norm_backward_cluster']} of the cluster body) "
          f"in {steps} steps, expected 53 per step, all of the cluster body")
    check(launches["fused_resize_norm"] == steps,
          f"{launches['fused_resize_norm']} resize launches in {steps} "
          "steps, expected 1 per step")
    step_ms = trainer.step_ms
    after_first = step_ms[1:]
    step_med = statistics.median(after_first)
    losses = list(trainer.history)
    stats = trainer.input_stats
    del trainer, module
    torch.cuda.empty_cache()

    # the first step again, from the same weights on the same batch with
    # the same draws, through the kernels and through the plain versions:
    # in float32, where the two must agree closely, and in bf16, where a
    # GroupNorm output one bf16 step apart is carried on by every layer
    # after it, so each bf16 route is held against the float32 step
    first = next(_batches(x, y, TRAIN_BATCH, cfg.seed))
    gn_op.launches = gn_op.backward_launches = rs_op.launches = 0
    loss_k32, params_k32 = _first_step("auto", "auto", init, first,
                                       torch.float32)
    loss_k, params_k = _first_step("auto", "auto", init, first)
    launched = (gn_op.launches, gn_op.backward_launches, rs_op.launches)
    check(launched == (2 * GN_SITES_RESNET50, 2 * GN_SITES_RESNET50, 2),
          f"the kernel route of the first step missed a kernel: "
          f"{launched}")
    loss_p32, params_p32 = _first_step("torch", "torch", init, first,
                                       torch.float32)
    loss_p, params_p = _first_step("torch", "torch", init, first)
    check((gn_op.launches, gn_op.backward_launches, rs_op.launches)
          == launched, "the plain route launched a kernel")
    gap32 = _update_gap(params_k32, params_p32, init)
    gap_k = _update_gap(params_k, params_p32, init)
    gap_p = _update_gap(params_p, params_p32, init)
    gap = _update_gap(params_k, params_p, init)
    del params_k, params_p, params_k32, params_p32
    breakdown = _step_breakdown(first)
    out = {"phase": "train", "model": "ResNet50", "card": card,
           "rows": TRAIN_ROWS, "batch": TRAIN_BATCH, "steps": steps,
           "source": [TRAIN_SRC, TRAIN_SRC, 3],
           "preprocess": "src_crop 240, resize 224, flip_lr, ImageNet "
                         "mean/std",
           "losses": losses, "setup_s": setup_s, "fit_wall_s": fit_s,
           "step_ms": step_ms, "step_ms_median_after_first": step_med,
           "images_per_s_after_first": TRAIN_BATCH * len(after_first)
           / (sum(after_first) / 1e3),
           "input_bound_fraction": stats["input_bound_fraction"],
           "input_wait_s": stats["input_wait_s"],
           "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "group_norm_backward_dy_copies_per_step": dy_copies / steps,
           "group_norm_share_of_step": None if gn is None
           else gn["ms"] / step_med,
           "group_norm_backward_share_of_step": None if gn is None
           else gn["backward"]["ms"] / step_med,
           "resize_share_of_step": None if rs is None
           else rs["ms"] / step_med,
           "peak_memory_gb": peak_gb,
           "first_step": {
               "loss_kernels": loss_k, "loss_plain": loss_p,
               "loss_gap": abs(loss_k - loss_p), "loss_tol": TRAIN_LOSS_TOL,
               "loss_fit_arrays": losses[0],
               "float32": {"loss_kernels": loss_k32, "loss_plain": loss_p32,
                           "update_gap": gap32,
                           "update_tol": TRAIN_UPDATE_TOL_F32},
               "bf16_kernels_vs_float32": gap_k,
               "bf16_plain_vs_float32": gap_p,
               "bf16_ratio_tol": TRAIN_BF16_RATIO_TOL,
               "bf16_kernels_vs_plain": gap},
           "breakdown_ms": breakdown}
    emit(out)
    check(abs(loss_k - loss_p) <= TRAIN_LOSS_TOL,
          f"first-step loss through the kernels {loss_k} vs the plain "
          f"versions {loss_p}: gap past {TRAIN_LOSS_TOL}")
    check(gap32["relative"] <= TRAIN_UPDATE_TOL_F32,
          f"float32 first step: the kernel and plain routes' updates differ "
          f"by {gap32}, past {TRAIN_UPDATE_TOL_F32} (relative norm)")
    check(gap_k["relative"]
          <= TRAIN_BF16_RATIO_TOL * gap_p["relative"],
          f"bf16 first step: the kernel route's update lies {gap_k} from "
          f"the float32 step, the plain route's {gap_p}; past "
          f"{TRAIN_BF16_RATIO_TOL}x")
    return launches

def block_update_bound(n, h, tq, tk, d, keep=None,
                       tensor_cores: bool = False) -> tuple[float, str]:
    """The block update on these operands: q, k and v read once, the carry
    (m, denom [N,H,Tq,1] and acc [N,H,Tq,D], f32) read and written once,
    the int8 mask read once, 4·N·H·Tq·Tk·D float32 operations. With
    ``keep`` (the ``[N, Tq, Tk]`` mask of this run) only the work the
    function needs is counted: 4·H·D operations per kept (query, key) pair,
    the q rows that keep some key and the K/V rows of the keys that some
    query keeps. With ``tensor_cores`` the floor on the units the kernel
    uses: each float32 operation as BLOCK_TF32_PRODUCTS TF32 operations at
    the TF32 peak."""
    fixed = n * tq * tk + 2 * 4 * n * h * tq * (d + 2)
    per_op, dtype = ((BLOCK_TF32_PRODUCTS, "tf32") if tensor_cores
                     else (1, "float32"))
    if keep is None:
        return bound(fixed + 4 * n * h * (tq + 2 * tk) * d,
                     per_op * 4 * n * h * tq * tk * d, dtype)
    kept = keep != 0
    pairs = int(kept.sum())
    q_rows = int(kept.any(dim=2).sum())
    kv_rows = int(kept.any(dim=1).sum())
    return bound(fixed + 4 * h * d * (q_rows + 2 * kv_rows),
                 per_op * 4 * h * d * pairs, dtype)


def block_update_backward_bound(n, h, tq, tk, d, keep=None,
                                tensor_cores: bool = False
                                ) -> tuple[float, str]:
    """K3's backward on these operands: q, k, v, the carry (m, denom
    [N,H,Tq,1] and acc [N,H,Tq,D]), the three cotangents of the carry and
    the int8 mask read once; dq, dk, dv and the carry's three gradients
    written once; BLOCK_BWD_OPS_PER_PAIR·N·H·Tq·Tk·D float32 operations.
    With ``keep`` (this run's ``[N, Tq, Tk]`` mask) only the work the
    function needs: the kept (query, key) pairs' operations, the q rows
    that keep some key and the K/V rows of the keys that some query keeps
    (every output is written all the same). With ``tensor_cores`` the
    floor on the units the kernel uses: each float32 operation as
    BLOCK_TF32_PRODUCTS TF32 operations at the TF32 peak."""
    carry = n * h * tq * (d + 2)
    outputs = n * h * (tq + 2 * tk) * d
    fixed = n * tq * tk + 4 * (3 * carry + outputs)
    per_op, dtype = ((BLOCK_TF32_PRODUCTS, "tf32") if tensor_cores
                     else (1, "float32"))
    if keep is None:
        return bound(fixed + 4 * outputs,
                     per_op * BLOCK_BWD_OPS_PER_PAIR * n * h * tq * tk * d,
                     dtype)
    kept = keep != 0
    pairs = int(kept.sum())
    q_rows = int(kept.any(dim=2).sum())
    kv_rows = int(kept.any(dim=1).sum())
    return bound(fixed + 4 * h * d * (q_rows + 2 * kv_rows),
                 per_op * BLOCK_BWD_OPS_PER_PAIR * h * d * pairs, dtype)


def kernel_tile_keep(keep):
    """``keep`` widened to whole (64-row tile, 64-key stripe) pairs: the
    work K3 does, since it skips only the pairs that keep no key. Its bound
    is the kernel's own skip-level work, not the function's."""
    import torch
    n, tq, tk = keep.shape
    t64, s64 = -(-tq // 64), -(-tk // 64)
    pad = torch.zeros((n, t64 * 64, s64 * 64), dtype=torch.bool,
                      device=keep.device)
    pad[:, :tq, :tk] = keep != 0
    kept = pad.reshape(n, t64, 64, s64, 64).any(dim=4).any(dim=2)
    wide = kept.repeat_interleave(64, dim=1).repeat_interleave(64, dim=2)
    return wide[:, :tq, :tk]


def _sp_data() -> tuple[np.ndarray, np.ndarray]:
    """SP_ROWS next-token sequences from numpy seed 0: n+1 tokens in
    [1, vocab) with n uniform in SP_LENGTHS; x the first n, y the last n,
    both right-padded with 0 to max_len."""
    rng = np.random.default_rng(0)
    width = SP_MODEL["max_len"]
    x = np.zeros((SP_ROWS, width), np.int64)
    y = np.zeros((SP_ROWS, width), np.int64)
    for i, n in enumerate(rng.integers(SP_LENGTHS[0], SP_LENGTHS[1] + 1,
                                       SP_ROWS)):
        seq = rng.integers(1, SP_MODEL["vocab_size"], n + 1)
        x[i, :n], y[i, :n] = seq[:-1], seq[1:]
    return x, y


def _ring_hops(kv_mask) -> list[tuple]:
    """The inputs K3 gets at every hop of one ring over the training
    geometry: random q/k/v ``[B, L, H, D]`` with the first training
    batch's pad mask through ``ring_attention`` (plain block update), each
    hop's ``(q, k, v, keep, m, denom, acc)`` recorded, the carry from the
    real previous hop."""
    import torch

    from mmlspark_tpu_torch.parallel import ring_attention as ring
    from mmlspark_tpu_torch.parallel.mesh import make_mesh
    gen = torch.Generator(device=DEV).manual_seed(1)
    b, n = kv_mask.shape
    h = SP_MODEL["num_heads"]
    d = SP_MODEL["embed_dim"] // h
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device=DEV)
               for _ in range(3))
    hops = []
    inner = ring.attention_block_update

    def record(*args, impl="auto"):
        hops.append(args[:7])
        return inner(*args, impl="torch")

    ring.attention_block_update = record
    try:
        with torch.no_grad():
            ring.ring_attention(q, k, v, make_mesh({"sp": SP_RANKS}, DEV),
                                causal=True, kv_mask=kv_mask)
    finally:
        ring.attention_block_update = inner
    return hops


def _block_case(args, scale, name) -> tuple[dict, tuple]:
    """K3 against its plain version on one input; both outputs checked, and
    a second launch equal to the first bit for bit."""
    import torch

    from mmlspark_tpu_torch.ops import attention as fa
    got = fa.attention_block_update(*args, scale, impl="cuda")
    again = fa._block_update_cuda(*args, scale)
    torch.cuda.synchronize()
    repeat = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                 for a, b in zip(got, again))
    check(repeat, f"two launches of K3 on the same input differ: {name}")
    want = fa.attention_block_update(*args, scale, impl="torch")
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == torch.float32,
              f"kernel output {tuple(g.shape)} {g.dtype}")
    gm, wm = got[0], want[0]
    check(bool((torch.isneginf(gm) == torch.isneginf(wm)).all()),
          f"{name}: the kernel's unseen rows (m = -inf) differ")
    fin = torch.isfinite(wm)
    err_m = float((gm[fin] - wm[fin]).abs().max()) if bool(fin.any()) \
        else 0.0
    out_g = got[2] / torch.clamp(got[1], min=1e-30)
    out_w = want[2] / torch.clamp(want[1], min=1e-30)
    check(bool(torch.isfinite(out_g).all()), f"{name}: output not finite")
    err = max(err_m, float((out_g - out_w).abs().max()))
    n, h, tq, d = args[0].shape
    row = {"phase": "kernel", "kernel": "attention_block_update",
           "case": name, "N": n, "H": h, "Tq": tq, "Tk": args[1].shape[2],
           "D": d, "kept_fraction": float((args[3] != 0).float().mean()),
           "max_abs_err_m": err_m, "max_abs_err": err, "tol": BLOCK_TOL,
           "bitwise_repeat": repeat}
    check(err <= BLOCK_TOL,
          f"attention_block_update kernel differs from its plain version "
          f"by {err} > {BLOCK_TOL} on {row}")
    return row, got


def _ring_cotangents(hops, scale) -> list[tuple]:
    """The cotangents each hop's fresh carry gets in one ring: a loss on
    the ring's output (acc / max(denom, 1e-30), weighted by seeded noise)
    differentiated through the plain updates from the first hop's carry
    over the hops' recorded q, k, v and masks. The last hop's m, which
    nothing reads, gets zeros."""
    import torch

    from mmlspark_tpu_torch.ops import attention as fa
    gen = torch.Generator(device=DEV).manual_seed(3)
    carry = tuple(t.detach().requires_grad_() for t in hops[0][4:])
    outs = []
    with torch.enable_grad():
        for q, k, v, keep, *_ in hops:
            carry = fa.block_update_reference(q, k, v, keep, *carry, scale)
            for t in carry:
                t.retain_grad()
            outs.append(carry)
        out = carry[2] / torch.clamp(carry[1], min=1e-30)
        w = torch.randn(out.shape, generator=gen, device=DEV)
        (out * w).sum().backward()
    return [tuple(torch.zeros_like(t) if t.grad is None
                  else t.grad.detach() for t in c) for c in outs]


def _random_cotangents(args, gen) -> tuple:
    """Seeded normal cotangents of the carry ``args`` updates: the max's
    term is then of order 1."""
    import torch
    n, h, tq, d = args[0].shape
    return tuple(torch.randn(shape, generator=gen, device=DEV)
                 for shape in ((n, h, tq, 1), (n, h, tq, 1), (n, h, tq, d)))


def _block_bwd_case(args, grads, scale, name, exact=False) -> dict:
    """K3's backward kernel against its plain version (the closed form) on
    one input and one set of cotangents: launched twice, equal bit for bit
    (NaN payloads included); finite at the same places (dm is NaN on dead
    rows); each gradient within ``block_update_backward_error_bound`` at
    BLOCK_BWD_REL, with no allowance for a tie seen differently where
    ``exact``. Emits and returns the row."""
    import torch

    from mmlspark_tpu_torch.ops import attention as fa
    before = fa.block_update_backward_launches
    got = fa._block_update_bwd_cuda(grads, *args, scale)
    again = fa._block_update_bwd_cuda(grads, *args, scale)
    torch.cuda.synchronize()
    check(fa.block_update_backward_launches == before + 2,
          f"backward launches {before} -> "
          f"{fa.block_update_backward_launches}, expected +2")
    repeat = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                 for a, b in zip(got, again))
    want = fa.block_update_backward_reference(grads, *args, scale)
    bounds = fa.block_update_backward_error_bound(
        grads, *args, scale, BLOCK_BWD_REL, exact=exact)
    errs, ratios, same_finite = {}, {}, True
    for key, g, w, bnd in zip(("dq", "dk", "dv", "dm", "ddenom", "dacc"),
                              got, want, bounds):
        check(g.shape == w.shape and g.dtype == torch.float32,
              f"backward {key}: {tuple(g.shape)} {g.dtype}")
        fin = torch.isfinite(w)
        same_finite = same_finite and bool(torch.equal(torch.isfinite(g),
                                                       fin))
        diff = (g[fin].double() - w[fin].double()).abs()
        errs[key] = float(diff.max()) if diff.numel() else 0.0
        ratios[key] = float((diff / bnd[fin].clamp_min(1e-300)).max()) \
            if diff.numel() else 0.0
    n, h, tq, d = args[0].shape
    row = {"phase": "kernel", "kernel": "attention_block_update_backward",
           "case": name, "N": n, "H": h, "Tq": tq, "Tk": args[1].shape[2],
           "D": d, "kept_fraction": float((args[3] != 0).float().mean()),
           "dead_rows": int((~torch.isfinite(want[3])).sum()),
           "exact_scores": exact, "bitwise_repeat": repeat,
           "same_finite": same_finite, "max_abs_err": max(errs.values()),
           "abs_err": errs, "err_over_bound": ratios,
           "max_err_over_bound": max(ratios.values()), "rel": BLOCK_BWD_REL}
    emit(row)
    check(repeat, f"two backward launches on the same input differ: {name}")
    check(same_finite, f"{name}: the backward kernel's non-finite entries "
                       "differ from the plain version's")
    check(row["max_err_over_bound"] <= 1,
          f"attention_block_update backward kernel differs from its plain "
          f"version past block_update_backward_error_bound on {row}")
    return row


def _integer_tie_inputs(kind, gen) -> tuple:
    """Inputs whose scores are exact on both sides (q and k in {-1, 0,
    1}): ``duplicated_keys`` (the second half of the keys repeats the
    first: ties at the block max) or ``m_at_row_max`` (the carried m set
    to each row's largest kept score: the max's half-and-half split)."""
    import torch

    from mmlspark_tpu_torch.ops import attention as fa
    n, h, tq, tk, d = 8, 12, 256, 256, 64
    q, k = (torch.randint(-1, 2, (n, h, t, d), generator=gen,
                          device=DEV).float() for t in (tq, tk))
    v = torch.randn((n, h, tk, d), generator=gen, device=DEV)
    keep = torch.rand((n, tq, tk), generator=gen, device=DEV) > 0.3
    scale = fa.resolve_scale(None, d)
    k0, v0 = (torch.randn((n, h, tk, d), generator=gen, device=DEV)
              for _ in range(2))
    keep0 = torch.rand((n, tq, tk), generator=gen, device=DEV) > 0.5
    keep0[:, :3] = False
    m, den, acc = fa.attention_block_update(
        q, k0, v0, keep0, torch.full((n, h, tq, 1), float("-inf"),
                                     device=DEV),
        torch.zeros((n, h, tq, 1), device=DEV),
        torch.zeros((n, h, tq, d), device=DEV), scale, impl="torch")
    if kind == "duplicated_keys":
        k[:, :, tk // 2:] = k[:, :, :tk // 2]
    else:
        s = torch.where(keep[:, None], torch.matmul(q, k.transpose(-1, -2))
                        * scale, float("-inf"))
        b = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(b), b, m)
    return (q, k, v, keep.to(torch.int8), m, den, acc), scale


def phase_block_update() -> dict:
    """K3 against its plain version at every hop of a ring over the
    training geometry (N = sp·B = 32, H=12, Tq = Tk = 256, D=64, f32, the
    first training batch's pad mask, causal), on a block with every key
    kept, at the edge cases (operands off 16 bytes among them) and on
    integer scores (m exact), every case launched twice and equal bit for
    bit; times per hop and bounds on the CUDA cores (the function's f32
    work) and on the tensor cores in 3xTF32 (the units the kernel uses). The same for
    K3's backward kernel against its closed form, at every hop with the
    ring's own cotangents and with seeded random ones, and at the edge
    cases and two integer tie cases; its time per hop beside the closed
    form's, the autograd route's and SDPA's backward over the same block
    without the carry."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.ops import attention as fa
    from mmlspark_tpu_torch.train.loop import _batches
    x, y = _sp_data()
    first = next(_batches(x, y, SP_BATCH, 0))[0]
    kv_mask = torch.from_numpy(first != 0).to(DEV)
    hops = _ring_hops(kv_mask)
    check(len(hops) == SP_RANKS, f"{len(hops)} hops, expected {SP_RANKS}")
    scale = fa.resolve_scale(None, hops[0][0].shape[3])
    worst = 0.0
    timed = []
    for step, args in enumerate(hops):
        row, _ = _block_case(args, scale, f"ring hop {step}")
        q, k, v, keep, m, den, acc = args     # keep: the ring's int8 mask
        row["ms"] = time_ms(lambda: fa._block_update_cuda(
            q, k, v, keep, m, den, acc, scale))
        row["plain_ms"] = time_ms(lambda: fa.block_update_reference(
            q, k, v, keep, m, den, acc, scale))
        row["bound_ms"], row["bound_by"] = block_update_bound(
            *q.shape[:3], k.shape[2], q.shape[3], keep)
        row["tc_bound_ms"], row["tc_bound_by"] = block_update_bound(
            *q.shape[:3], k.shape[2], q.shape[3], keep, tensor_cores=True)
        row["bound_kernel_tiles_ms"] = block_update_bound(
            *q.shape[:3], k.shape[2], q.shape[3], kernel_tile_keep(keep))[0]
        row["bound_all_keys_ms"] = block_update_bound(
            *q.shape[:3], k.shape[2], q.shape[3])[0]
        # reference only: SDPA over the same block with the same mask and
        # no carry (rows with no kept key give NaN there)
        sdpa_mask = (keep != 0)[:, None]
        row["sdpa_ms_no_carry"] = time_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask, scale=scale))
        row["x_bound"] = row["ms"] / row["bound_ms"]
        row["x_tc_bound"] = row["ms"] / row["tc_bound_ms"]
        row["x_sdpa"] = row["ms"] / row["sdpa_ms_no_carry"]
        worst = max(worst, row["max_abs_err"])
        timed.append(row)
        emit(row)

    # every key kept, the carry of the real hop 1: no stripe to skip
    q, k, v, keep, m, den, acc = hops[1]
    ones = torch.ones_like(keep, dtype=torch.int8)
    row, _ = _block_case((q, k, v, ones, m, den, acc), scale,
                         "every key kept")
    row["ms"] = time_ms(lambda: fa._block_update_cuda(
        q, k, v, ones, m, den, acc, scale))
    row["plain_ms"] = time_ms(lambda: fa.block_update_reference(
        q, k, v, ones, m, den, acc, scale))
    row["bound_ms"], row["bound_by"] = block_update_bound(
        *q.shape[:3], k.shape[2], q.shape[3])
    row["tc_bound_ms"], row["tc_bound_by"] = block_update_bound(
        *q.shape[:3], k.shape[2], q.shape[3], tensor_cores=True)
    row["sdpa_ms_no_carry"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    row["x_bound"] = row["ms"] / row["bound_ms"]
    row["x_tc_bound"] = row["ms"] / row["tc_bound_ms"]
    row["x_sdpa"] = row["ms"] / row["sdpa_ms_no_carry"]
    worst = max(worst, row["max_abs_err"])
    dense = row
    emit(row)
    gen_b = torch.Generator(device=DEV).manual_seed(4)
    bwd_rows = [_block_bwd_case(
        (q, k, v, ones, m, den, acc), _random_cotangents(hops[1], gen_b),
        scale, "every key kept, random cotangents")]

    # edge cases: a pad-only block on the real carry (which must pass
    # through bit for bit) and on the initial carry (exact (-inf, 0, 0))
    zeros = torch.zeros_like(ones)
    row, got = _block_case((q, k, v, zeros, m, den, acc), scale,
                           "pad-only block, carry of hop 1")
    check(all(torch.equal(g, a) for g, a in zip(got, (m, den, acc))),
          "a pad-only block changed the carry")
    row["carry_unchanged_bit_for_bit"] = True
    # the kernel's cost with no product to take: the carry in and out
    row["ms"] = time_ms(lambda: fa._block_update_cuda(
        q, k, v, zeros, m, den, acc, scale))
    row["bound_ms"], row["bound_by"] = block_update_bound(
        *q.shape[:3], k.shape[2], q.shape[3], zeros)
    row["x_bound"] = row["ms"] / row["bound_ms"]
    pad_only = row
    emit(row)
    bwd_rows.append(_block_bwd_case(
        (q, k, v, zeros, m, den, acc), _random_cotangents(hops[1], gen_b),
        scale, "pad-only block, carry of hop 1"))
    m0 = torch.full_like(m, float("-inf"))
    d0, a0 = torch.zeros_like(den), torch.zeros_like(acc)
    row, got = _block_case((q, k, v, zeros, m0, d0, a0), scale,
                           "pad-only block, initial carry")
    check(bool(torch.isneginf(got[0]).all()) and not bool(got[1].any())
          and not bool(got[2].any()),
          "a pad-only block from the initial carry is not (-inf, 0, 0)")
    row["initial_carry_exact"] = True
    emit(row)
    bwd_rows.append(_block_bwd_case(
        (q, k, v, zeros, m0, d0, a0), _random_cotangents(hops[1], gen_b),
        scale, "pad-only block, initial carry"))
    gen = torch.Generator(device=DEV).manual_seed(2)

    def inputs(n, h, tq, tk, d, keep_fn):
        qq, kk, vv = (torch.randn((n, h, t, d), generator=gen, device=DEV)
                      for t in (tq, tk, tk))
        kk0, vv0 = (torch.randn((n, h, tk, d), generator=gen, device=DEV)
                    for _ in range(2))
        keep0 = torch.rand((n, tq, tk), generator=gen, device=DEV) > 0.5
        keep0[:, :3] = False          # rows 0-2 unseen before this block
        mm, dd, aa = fa.attention_block_update(
            qq, kk0, vv0, keep0,
            torch.full((n, h, tq, 1), float("-inf"), device=DEV),
            torch.zeros((n, h, tq, 1), device=DEV),
            torch.zeros((n, h, tq, d), device=DEV),
            fa.resolve_scale(None, d), impl="torch")
        return qq, kk, vv, keep_fn(n, tq, tk), mm, dd, aa

    def causal(n, tq, tk):
        return torch.ones((tq, tk), dtype=torch.bool,
                          device=DEV).tril()[None].expand(n, tq, tk)

    def holes(n, tq, tk):
        keep = torch.rand((n, tq, tk), generator=gen, device=DEV) > 0.3
        keep[0, 5] = False            # one query row with no key here
        return keep

    for name, shape, keep_fn in (
            ("causal diagonal block", (8, 12, 256, 256, 64), causal),
            ("pad holes", (8, 12, 256, 256, 64), holes),
            ("D=128", (4, 4, 256, 256, 128), holes),
            ("D=32", (4, 4, 128, 128, 32), causal),
            ("ragged 37x200", (4, 3, 37, 200, 64), holes)):
        args = inputs(*shape, keep_fn)
        row, _ = _block_case(args, fa.resolve_scale(None, shape[-1]), name)
        worst = max(worst, row["max_abs_err"])
        emit(row)
        bwd_rows.append(_block_bwd_case(
            args, _random_cotangents(args, gen_b),
            fa.resolve_scale(None, shape[-1]), name))
        del args
    # q, k and v off 16 bytes (the kernel stages them by 4-byte copies),
    # ragged tiles and a mask row of 77 bytes (byte loads of the mask)
    args = list(inputs(2, 3, 70, 77, 64, holes))
    for i in range(3):
        off = torch.empty(args[i].numel() + 1, device=DEV)[1:]
        args[i] = off.view(args[i].shape).copy_(args[i])
    row, _ = _block_case(tuple(args), fa.resolve_scale(None, 64),
                         "q, k, v off 16 bytes, ragged 70x77")
    worst = max(worst, row["max_abs_err"])
    emit(row)
    del args
    for kind in ("duplicated_keys", "m_at_row_max"):
        args, sc = _integer_tie_inputs(kind, gen_b)
        if kind == "duplicated_keys":
            # integer scores are exact in the TF32 high part: m exactly
            row, _ = _block_case(args, sc, f"{kind}, integer scores")
            emit(row)
            check(row["max_abs_err_m"] == 0,
                  f"K3's m differs from the plain version's on integer "
                  f"scores by {row['max_abs_err_m']}")
            worst = max(worst, row["max_abs_err"])
        bwd_rows.append(_block_bwd_case(
            args, _random_cotangents(args, gen_b), sc,
            f"{kind}, integer scores", exact=True))
        del args

    total = {key: sum(r[key] for r in timed)
             for key in ("ms", "plain_ms", "bound_ms", "tc_bound_ms",
                         "bound_kernel_tiles_ms", "bound_all_keys_ms",
                         "sdpa_ms_no_carry")}
    hops_n = len(timed)
    out = {"phase": "kernel", "kernel": "attention_block_update",
           "per_ring": f"sum over the {hops_n} hops of one layer's ring, "
                       "first training batch", **total,
           "x_bound": total["ms"] / total["bound_ms"],
           "x_tc_bound": total["ms"] / total["tc_bound_ms"],
           "x_sdpa": total["ms"] / total["sdpa_ms_no_carry"],
           "by_hop_ms": [r["ms"] for r in timed],
           "every_key_kept": {k: dense[k] for k in (
               "ms", "plain_ms", "bound_ms", "bound_by", "tc_bound_ms",
               "tc_bound_by", "x_bound", "x_tc_bound", "sdpa_ms_no_carry",
               "x_sdpa")},
           "pad_only": {k: pad_only[k] for k in ("ms", "bound_ms",
                                                 "x_bound")},
           "max_abs_err": worst}
    emit(out)
    # per launch: the mean over the ring's hops; bound_by is the limit that
    # sets the larger share of the hops' summed bound
    by_share = {by: sum(r["bound_ms"] for r in timed if r["bound_by"] == by)
                for by in ("bytes", "operations")}
    bwd = _block_update_backward_hops(hops, scale, gen_b, bwd_rows)
    return {"ms": total["ms"] / hops_n, "plain_ms": total["plain_ms"] / hops_n,
            "bound_ms": total["bound_ms"] / hops_n,
            "tc_bound_ms": total["tc_bound_ms"] / hops_n,
            "bound_by": max(by_share, key=by_share.get),
            "max_abs_err": worst, "backward": bwd}


def kernel_ms_by_name(fn, names, reps: int = 10) -> dict:
    """Device time in ms per launch of each kernel whose name holds one of
    ``names``: the mean over the launches of ``reps`` calls of ``fn``
    traced by ``torch.profiler`` after 3 warm calls (L2 warm, launches back
    to back). Each launches once a call, but a trace may miss some (after
    other traced phases in the same process it missed 3 of 11), so the
    mean is over those it holds, at least one of each."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    out = {}
    for name in names:
        mine = [e for e in events if name in e.key]
        count = sum(e.count for e in mine)
        check(0 < count <= reps,
              f"{name}: {count} launches traced in {reps} calls")
        out[name] = sum(e.self_device_time_total for e in mine) / 1e3 / count
    return out


def _time_block_backward(args, cots, scale, case) -> dict:
    """K3's backward kernel timed on one input (L2 warm): in all and by
    launch, beside the closed form, the autograd route and, for reference,
    SDPA's backward over the same block without the carry (the graph
    kept, the backward only; rows with no kept key give NaN there); the
    bound over the kept pairs on the CUDA cores (the function's work) and
    on the tensor cores in 3xTF32 (the units the kernel uses), and over
    every key. Emits and returns the row."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.ops import attention as fa
    q, k, v, keep = args[:4]
    shape = (*q.shape[:3], k.shape[2], q.shape[3])
    row = {"phase": "kernel", "kernel": "attention_block_update_backward",
           "case": f"{case}, timed",
           "kept_fraction": float((keep != 0).float().mean())}

    def kernel():
        return fa._block_update_bwd_cuda(cots, *args, scale)

    row["ms"] = time_ms(kernel)
    row["ms_by_launch"] = kernel_ms_by_name(kernel, BLOCK_BWD_KERNEL_NAMES)
    row["plain_ms"] = time_ms(
        lambda: fa.block_update_backward_reference(cots, *args, scale))
    row["autograd_ms"] = time_ms(
        lambda: fa.block_update_backward(cots, *args, scale))
    row["bound_ms"], row["bound_by"] = block_update_backward_bound(
        *shape, keep)
    row["tc_bound_ms"], row["tc_bound_by"] = block_update_backward_bound(
        *shape, keep, tensor_cores=True)
    row["bound_all_keys_ms"] = block_update_backward_bound(*shape)[0]
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=(keep != 0)[:, None], scale=scale)
    row["sdpa_backward_ms_no_carry"] = time_ms(
        lambda: torch.autograd.grad(out, (qg, kg, vg), cots[2],
                                    retain_graph=True))
    del out, qg, kg, vg
    row["x_bound"] = row["ms"] / row["bound_ms"]
    row["x_tc_bound"] = row["ms"] / row["tc_bound_ms"]
    row["x_plain"] = row["ms"] / row["plain_ms"]
    row["x_autograd"] = row["ms"] / row["autograd_ms"]
    row["x_sdpa_backward"] = row["ms"] / row["sdpa_backward_ms_no_carry"]
    emit(row)
    return row


def _block_update_backward_hops(hops, scale, gen, rows) -> dict:
    """K3's backward kernel at every hop of the ring with the ring's own
    cotangents (a loss on its output) and with seeded random ones, and its
    times per hop with the ring's (``_time_block_backward``), and on hop
    1's block with every key kept. ``rows`` holds the edge cases' rows.
    Returns the per-hop means of one ring (the kernels line's figures) and
    the worst error and ratio."""
    import torch

    layers = SP_MODEL["num_layers"]
    cots = _ring_cotangents(hops, scale)
    timed = []
    for step, (args, ring_g) in enumerate(zip(hops, cots)):
        rows.append(_block_bwd_case(
            args, _random_cotangents(args, gen), scale,
            f"ring hop {step}, random cotangents"))
        rows.append(_block_bwd_case(args, ring_g, scale,
                                    f"ring hop {step}, the ring's "
                                    "cotangents"))
        timed.append(_time_block_backward(args, ring_g, scale,
                                          f"ring hop {step}"))
    q, k, v, keep, m, den, acc = hops[1]
    dense = _time_block_backward(
        (q, k, v, torch.ones_like(keep), m, den, acc), cots[1], scale,
        "every key kept, hop 1's carry and cotangents")
    keys = ("ms", "plain_ms", "autograd_ms", "bound_ms", "tc_bound_ms",
            "bound_all_keys_ms", "sdpa_backward_ms_no_carry")
    ring = {key: sum(r[key] for r in timed) for key in keys}
    ring["ms_by_launch"] = {name: sum(r["ms_by_launch"][name] for r in timed)
                            for name in BLOCK_BWD_KERNEL_NAMES}
    hops_n = len(timed)
    by_share = {by: sum(r["bound_ms"] for r in timed if r["bound_by"] == by)
                for by in ("bytes", "operations")}
    out = {"phase": "kernel", "kernel": "attention_block_update_backward",
           "per_ring": f"sum over the {hops_n} hops of one layer's ring, "
                       "first training batch, the ring's cotangents",
           **ring, "x_bound": ring["ms"] / ring["bound_ms"],
           "x_tc_bound": ring["ms"] / ring["tc_bound_ms"],
           "by_hop_ms": [r["ms"] for r in timed],
           "every_key_kept": {key: dense[key] for key in (
               *keys, "ms_by_launch", "x_bound", "x_tc_bound")},
           "per_step": {key: layers * ring[key] for key in keys},
           "per_step_note": f"{layers} layers x one ring",
           "cases": len(rows),
           "max_abs_err": max(r["max_abs_err"] for r in rows),
           "max_err_over_bound": max(r["max_err_over_bound"] for r in rows),
           "every_case_bitwise_repeat": all(r["bitwise_repeat"]
                                            for r in rows)}
    emit(out)
    return {**{key: ring[key] / hops_n for key in keys},
            "per_step": out["per_step"],
            "bound_by": max(by_share, key=by_share.get),
            "max_abs_err": out["max_abs_err"],
            "max_err_over_bound": out["max_err_over_bound"]}


def _sp_loss_and_grads(model, mesh, batch, impl: str) -> tuple:
    """The first step's loss and gradients through the ring with the given
    block-update route, from the model's current weights."""
    import torch

    from mmlspark_tpu_torch.parallel.ring_attention import ring_attention
    from mmlspark_tpu_torch.train.loop import make_loss

    def attention_fn(q, k, v, kv_mask, causal):
        return ring_attention(q, k, v, mesh, causal=causal, kv_mask=kv_mask,
                              impl=impl)

    bx, by, bw = (torch.from_numpy(a).to(DEV) for a in batch)
    model.zero_grad(set_to_none=True)
    logits = model(bx, attention_fn=attention_fn)
    per = make_loss("softmax_xent")(logits, by, token_mask=(bx != 0).float())
    loss = (per * bw).sum() / torch.clamp(bw.sum(), min=1e-6)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _grad_gap(a: dict, b: dict) -> dict:
    """How far gradients ``a`` lie from ``b``: the norm of the difference
    over the norm of ``b``, over all parameters and for the worst tensor,
    and the largest elementwise gap; whether every entry is finite."""
    import torch
    diff = norm = 0.0
    worst = (0.0, "")
    for k in a:
        d = float((a[k] - b[k]).norm()) ** 2
        u = float(b[k].norm()) ** 2
        diff, norm = diff + d, norm + u
        if u > 0:
            worst = max(worst, ((d / u) ** 0.5, k))
    return {"relative": (diff / norm) ** 0.5, "worst_tensor": worst,
            "max_abs": max(float((a[k] - b[k]).abs().max()) for k in a),
            "finite": all(bool(torch.isfinite(a[k]).all()) for k in a)}


def _sp_step_profile(model, cfg, batch) -> dict:
    """One training step through the kernel route, after one warm step:
    host wall (synchronised) and, under ``torch.profiler``, the device's
    busy time, its idle share of the wall, K3's forward kernels, its
    backward kernels (in all and by kernel) and the busiest kernels. The
    traced step must launch K3's forward kernel 48 times, call the
    backward kernel's wrapper 48 times with each of its two kernels 48
    times, and call no plain block-update route."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from mmlspark_tpu_torch.ops import attention as fa
    from mmlspark_tpu_torch.train.loop import Trainer
    trainer = Trainer(model, cfg)
    dx, dy, dw = (torch.from_numpy(a).to(DEV) for a in batch)
    trainer.train_step(dx, dy, dw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_step(dx, dy, dw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    inner = fa._block_update_bwd_cuda
    marked_name = "chip_smoke.block_update_backward_kernel"

    def marked_backward(*args, **kwargs):
        with record_function(marked_name):
            return inner(*args, **kwargs)

    # the plain routes, which the kernel route must not reach
    plain = {name: getattr(fa, name)
             for name in ("block_update_backward",
                          "block_update_backward_reference",
                          "block_update_reference")}
    plain_calls = dict.fromkeys(plain, 0)

    def counted(name):
        def call(*args, **kwargs):
            plain_calls[name] += 1
            return plain[name](*args, **kwargs)
        return call

    fa._block_update_bwd_cuda = marked_backward
    for name in plain:
        setattr(fa, name, counted(name))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.train_step(dx, dy, dw)
            torch.cuda.synchronize()
    finally:
        fa._block_update_bwd_cuda = inner
        for name, fn in plain.items():
            setattr(fa, name, fn)
    events = prof.key_averages()
    hops = SP_RANKS * SP_MODEL["num_layers"]
    marked = [e for e in events
              if e.key == marked_name and e.device_type == DeviceType.CPU]
    check(len(marked) == 1 and marked[0].count == hops,
          f"block-update backward kernel calls in the profiled step: "
          f"{[(str(e.device_type), e.count) for e in marked]}")
    check(not any(plain_calls.values()),
          f"the profiled step reached a plain block-update route: "
          f"{plain_calls}")
    # device work: the kernel and copy events; the wrapper's host range
    # gets no device time for kernels launched through ctypes
    device = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in events
              if e.device_type == DeviceType.CUDA and e.key != marked_name
              and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in device)
    k3 = sum(ms for key, ms, _ in device if "block_update_kernel" in key)
    k3_calls = sum(n for key, _, n in device if "block_update_kernel" in key)
    check(k3_calls == hops, f"{k3_calls} K3 kernels in the profiled step, "
                            f"expected {hops}")
    bwd_kernels = {name: [sum(ms for key, ms, _ in device if name in key),
                          sum(c for key, _, c in device if name in key)]
                   for name in BLOCK_BWD_KERNEL_NAMES}
    check(all(c == hops for _, c in bwd_kernels.values()),
          f"K3 backward kernels in the profiled step: {bwd_kernels}, "
          f"expected each {hops} times")
    bwd = sum(ms for ms, _ in bwd_kernels.values())
    del trainer
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share_of_wall": 1 - busy / wall,
            "block_update_forward_ms": k3,
            "block_update_forward_share_of_busy": k3 / busy,
            "block_update_backward_kernel_ms": bwd,
            "block_update_backward_kernel_share_of_busy": bwd / busy,
            "block_update_backward_by_kernel": bwd_kernels,
            "plain_block_update_calls": plain_calls,
            "kernels_launched": sum(n for _, _, n in device),
            "top_kernels": [[key[:80], ms, n] for key, ms, n in
                            sorted(device, key=lambda d: -d[1])[:8]]}


def phase_sp_train(card: str, bu: dict | None) -> dict:
    """Train the GPT-2-small-width TransformerTagger through
    ``Trainer.fit_arrays`` on a mesh of ``sp`` virtual ranks (ring
    attention, K3 and its backward kernel per hop); returns the launches
    of K3's forward and backward kernels over the run."""
    import torch

    from mmlspark_tpu_torch.models.sequence import (
        TransformerTagger, init_sequence_,
    )
    from mmlspark_tpu_torch.ops import attention as fa
    from mmlspark_tpu_torch.parallel.mesh import make_mesh
    from mmlspark_tpu_torch.train.loop import Trainer, TrainConfig, _batches

    t0 = time.perf_counter()
    x, y = _sp_data()
    model = init_sequence_(TransformerTagger(device=DEV, **SP_MODEL),
                           torch.Generator(device=DEV).manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    cfg = TrainConfig(mesh_spec={"sp": SP_RANKS}, batch_size=SP_BATCH,
                      optimizer="adamw", learning_rate=3e-4,
                      weight_decay=0.01, log_every=1, prefetch_depth=2,
                      device=DEV)
    trainer = Trainer(model, cfg)
    steps = -(-SP_ROWS // SP_BATCH)
    batches = list(_batches(x, y, SP_BATCH, cfg.seed))
    real_tokens = [int((bx != 0).sum()) for bx, _, _ in batches]
    setup_s = time.perf_counter() - t0

    # the main path: launch counts from 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.block_update_launches = 0
    fa.block_update_backward_launches = 0
    fa.block_update_backward_copies = 0
    t_fit = time.perf_counter()
    trainer.fit_arrays(x, y)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    launches = fa.block_update_launches
    bwd_launches = fa.block_update_backward_launches
    bwd_copies = fa.block_update_backward_copies
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hops = SP_RANKS * SP_MODEL["num_layers"]
    check(trainer.global_step == steps, f"{trainer.global_step} steps, "
                                        f"expected {steps}")
    losses = list(trainer.history)
    check(len(losses) == steps and all(np.isfinite(v) for v in losses),
          f"losses {losses}")
    check(launches == hops * steps,
          f"{launches} block-update launches in {steps} steps, expected "
          f"{hops} per step")
    check(bwd_launches == hops * steps,
          f"{bwd_launches} block-update backward kernel calls in {steps} "
          f"steps, expected {hops} per step")
    step_ms = trainer.step_ms
    tokens_per_s = sum(real_tokens[1:]) / (sum(step_ms[1:]) / 1e3)
    stats = trainer.input_stats
    del trainer
    model.load_state_dict(init)
    torch.cuda.empty_cache()

    # the first batch from the initial weights: the ring's logits through
    # K3 against the unsharded forward, then the loss and the gradients
    # through K3 against the plain block update on the card
    mesh = make_mesh({"sp": SP_RANKS}, DEV)
    first = batches[0]
    bx = torch.from_numpy(first[0]).to(DEV)
    hooks = model.mesh_hooks(mesh)
    fa.block_update_launches = 0
    with torch.no_grad():
        ring_logits = model(bx, **hooks["apply_kwargs"])
        plain_logits = model(bx)
    check(fa.block_update_launches == hops,
          f"the ring forward launched K3 {fa.block_update_launches} times")
    valid = bx != 0
    logit_err = float((ring_logits - plain_logits).abs()[valid].max())
    logit_err_all = float((ring_logits - plain_logits).abs().max())
    logit_max = float(plain_logits.abs().max())
    check(bool(torch.isfinite(ring_logits).all()), "ring logits not finite")
    del ring_logits, plain_logits
    bwd_before = fa.block_update_backward_launches
    loss_k, grads_k = _sp_loss_and_grads(model, mesh, first, "cuda")
    check(fa.block_update_backward_launches == bwd_before + hops,
          f"the kernel route's first step called the backward kernel "
          f"{fa.block_update_backward_launches - bwd_before} times, "
          f"expected {hops}")
    launched = (fa.block_update_launches, fa.block_update_backward_launches)
    loss_p, grads_p = _sp_loss_and_grads(model, mesh, first, "torch")
    check((fa.block_update_launches, fa.block_update_backward_launches)
          == launched, "the plain route launched a kernel")
    gap = _grad_gap(grads_k, grads_p)
    del grads_k, grads_p
    torch.cuda.empty_cache()
    profile_ = _sp_step_profile(model, cfg, first)
    step_med = statistics.median(step_ms[1:])
    out = {"phase": "sp_train", "model": "TransformerTagger, GPT-2 small "
           "widths, causal, pad token 0", "card": card,
           "parameters": sum(p.numel() for p in model.parameters()),
           "mesh": {"sp": SP_RANKS}, "rows": SP_ROWS, "batch": SP_BATCH,
           "steps": steps, "sequence_lengths": list(SP_LENGTHS),
           "optimizer": "adamw lr 3e-4 wd 0.01",
           "real_tokens_per_step": real_tokens, "losses": losses,
           "setup_s": setup_s, "fit_wall_s": fit_s, "step_ms": step_ms,
           "step_ms_median_after_first": step_med,
           "real_tokens_per_s_after_first": tokens_per_s,
           "input_bound_fraction": stats["input_bound_fraction"],
           "block_update_launches": launches,
           "block_update_launches_per_step": launches / steps,
           "block_update_share_of_step": None if bu is None
           else hops * bu["ms"] / step_med,
           "block_update_backward_launches": bwd_launches,
           "block_update_backward_launches_per_step": bwd_launches / steps,
           "block_update_backward_copies_per_step": bwd_copies / steps,
           "block_update_backward_share_of_step": None if bu is None
           else hops * bu["backward"]["ms"] / step_med,
           # the autograd route (the plain update recomputed and
           # differentiated, the backward before the kernel) over one
           # step's hops, from the block_update phase's timings
           "block_update_plain_backward_ms": None if bu is None
           else bu["backward"]["per_step"]["autograd_ms"],
           "peak_memory_gb": peak_gb,
           "first_batch": {
               "ring_logits_max_abs_err_vs_unsharded": logit_err,
               "ring_logits_max_abs_err_incl_pad_positions": logit_err_all,
               "logit_max_abs": logit_max, "logit_tol": SP_LOGIT_TOL,
               "loss_kernel": loss_k, "loss_plain": loss_p,
               "loss_fit_arrays": losses[0],
               "loss_gap": abs(loss_k - loss_p), "loss_tol": SP_LOSS_TOL,
               "grad_gap": gap, "grad_tol": SP_GRAD_TOL},
           "step_profile": profile_}
    emit(out)
    check(logit_err <= SP_LOGIT_TOL,
          f"ring logits through K3 differ from the unsharded forward by "
          f"{logit_err} > {SP_LOGIT_TOL} at real tokens")
    check(abs(loss_k - loss_p) <= SP_LOSS_TOL,
          f"first-step loss through K3 {loss_k} vs the plain update "
          f"{loss_p}: gap past {SP_LOSS_TOL}")
    check(gap["finite"], "a gradient through K3 is not finite")
    check(gap["relative"] <= SP_GRAD_TOL
          and gap["worst_tensor"][0] <= SP_GRAD_TOL,
          f"first-step gradients through K3 differ from the plain update's "
          f"by {gap}, past {SP_GRAD_TOL} (relative norm, over all "
          f"parameters or in one tensor)")
    return {"forward": launches, "backward": bwd_launches}


def convnet_forward_flops(widths, dense_width, num_classes,
                          input_spec=(32, 32, 3)) -> float:
    """Analytic forward FLOPs an example of the ConvNet (2 × the
    multiply-adds of its convs and dense layers), as bench.py:29
    ``conv_flops_per_example`` counts them: 1.223 G at full width."""
    h, w, cin = input_spec
    flops = 0.0
    for width in widths:
        for _ in range(2):  # two convs per block
            flops += 2 * h * w * 3 * 3 * cin * width
            cin = width
        h, w = h // 2, w // 2
    flops += 2 * h * w * cin * dense_width
    return flops + 2 * dense_width * num_classes


def _port_kernel_launches() -> dict:
    """Every launch counter of the port's kernels (the path under test
    must leave them all at 0)."""
    from mmlspark_tpu_torch.ops import attention as fa
    from mmlspark_tpu_torch.ops import group_norm as gn_op
    from mmlspark_tpu_torch.ops import resize as rs_op
    return {"flash_attention": fa.launches,
            "decode_attention": fa.decode_launches,
            "attention_block_update": fa.block_update_launches,
            "attention_block_update_backward":
                fa.block_update_backward_launches,
            "group_norm": gn_op.launches,
            "group_norm_backward": gn_op.backward_launches,
            "fused_resize_norm": rs_op.launches}


def _reset_port_kernel_launches() -> None:
    from mmlspark_tpu_torch.ops import attention as fa
    from mmlspark_tpu_torch.ops import group_norm as gn_op
    from mmlspark_tpu_torch.ops import resize as rs_op
    fa.launches = fa.decode_launches = fa.block_update_launches = 0
    fa.block_update_backward_launches = 0
    gn_op.launches = gn_op.backward_launches = rs_op.launches = 0


# kinds of device work in a trace, by a word of the kernel's name (the
# first that matches); what matches none is "other"
TRACE_KINDS = (("conv_gemm", ("gemm", "xmma", "cutlass", "conv", "cudnn")),
               ("pooling", ("max_pool",)), ("reduce", ("reduce_kernel",)),
               ("elementwise", ("elementwise",)), ("copy", ("Memcpy",
                                                             "Memset")))


def _trace_kind(key: str) -> str:
    return next((kind for kind, words in TRACE_KINDS
                 if any(w in key for w in words)), "other")


def _device_trace(fn, names: tuple = ()) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the device's busy time
    (kernels and copies) in all and by kind (TRACE_KINDS), the kernels
    launched and the busiest ones; with ``names``, the time and count of
    the kernels whose name holds each."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    check(bool(device), "the trace holds no device time")
    by_kind = {kind: 0.0 for kind, _ in TRACE_KINDS + (("other", ()),)}
    for key, ms, _ in device:
        by_kind[_trace_kind(key)] += ms
    out = {"device_busy_ms": sum(ms for _, ms, _ in device),
           "busy_ms_by_kind": by_kind,
           "kernels_launched": sum(n for _, _, n in device),
           "top_kernels": [[key[:80], ms, n] for key, ms, n in
                           sorted(device, key=lambda d: -d[1])[:8]]}
    if names:
        out["kernels_by_name"] = {
            name: [sum(ms for key, ms, _ in device if name in key),
                   sum(n for key, _, n in device if name in key)]
            for name in names}
    return out


def _synced_ms(fn, reps: int) -> float:
    """Mean host time of ``fn`` in ms, each call ended by a synchronise."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _relative_gap(got, want) -> float:
    """max |got − want| over max |want|: an error relative to the
    output's scale."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _class_blobs(n, shape, n_classes, seed=0):
    """Deterministic learnable image task (copied from
    tools/build_model_repo.py): class-dependent mean shift."""
    r = np.random.default_rng(seed)
    y = r.integers(0, n_classes, n)
    x = r.normal(size=(n,) + shape).astype(np.float32) * 20 + 128
    shift = (y[:, None].astype(np.float32) - n_classes / 2) * 8
    x = np.clip(x + shift[..., None, None], 0, 255)
    return x.astype(np.float32), y


def _cifar_trainer(module, **kw):
    from mmlspark_tpu_torch.train.loop import Trainer, TrainConfig
    from mmlspark_tpu_torch.train.preprocess import DevicePreprocess
    cfg = dict(batch_size=CIFAR_BATCH, optimizer="momentum",
               learning_rate=0.01, log_every=1, prefetch_depth=2,
               preprocess=DevicePreprocess(**CIFAR_SPEC))
    return Trainer(module, TrainConfig(**{**cfg, **kw}))


def _cifar_checks(card: str, init: dict, batch) -> None:
    """Correctness on the card: the float32 ConvNet against the same
    weights on the CPU (both nodes, 16 rows through
    center_128), the bf16 forward against the float32 one, and the first
    training step's loss in bf16 against float32."""
    import torch

    from mmlspark_tpu_torch.models.convnet import ConvNetCifar
    from mmlspark_tpu_torch.models.zoo import get_model
    rows = np.random.default_rng(1).integers(0, 256, (16, 32, 32, 3),
                                             dtype=np.uint8)
    x_cpu = torch.from_numpy(rows).float() - 128.0
    x = x_cpu.cuda()
    f32_vs_cpu = {}
    card_model = get_model("ConvNet_CIFAR10", seed=0,
                           dtype=torch.float32).module.eval()
    cpu_model = ConvNetCifar(widths=card_model.widths,
                             dense_width=card_model.dense_width,
                             dtype=torch.float32, device="cpu").eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               card_model.state_dict().items()})
    with torch.no_grad():
        for node in ("features", "logits"):
            got = card_model(x, output=node).cpu()
            want = cpu_model(x_cpu, output=node)
            width = (card_model.dense_width if node == "features"
                     else CIFAR_CLASSES)
            check(tuple(got.shape) == (16, width), f"{node} shape")
            f32_vs_cpu[node] = _relative_gap(got, want)
    del card_model, cpu_model
    f32 = get_model("ConvNet_CIFAR10", seed=0, dtype=torch.float32).module
    bf16 = get_model("ConvNet_CIFAR10", seed=0).module
    f32.load_state_dict(init)
    bf16.load_state_dict(init)
    with torch.no_grad():
        bf16_vs_f32 = {node: _relative_gap(bf16.eval()(x, output=node),
                                           f32.eval()(x, output=node))
                       for node in ("features", "logits")}
    dx, dy, dw = (torch.from_numpy(a).cuda() for a in batch)
    loss_f32 = float(_cifar_trainer(f32).train_step(dx, dy, dw))
    loss_bf16 = float(_cifar_trainer(bf16).train_step(dx, dy, dw))
    del f32, bf16
    out = {"phase": "cifar", "part": "checks", "card": card,
           "f32_card_vs_cpu": f32_vs_cpu, "f32_tol": CIFAR_F32_TOL,
           "bf16_vs_f32": bf16_vs_f32, "bf16_tol": CIFAR_BF16_TOL,
           "first_step_loss": {"float32": loss_f32, "bf16": loss_bf16,
                               "gap": abs(loss_bf16 - loss_f32),
                               "tol": CIFAR_LOSS_TOL},
           "tolerances": "max |error| over max |reference| of each output"}
    emit(out)
    check(max(f32_vs_cpu.values()) <= CIFAR_F32_TOL,
          f"float32 ConvNet on the card vs the CPU: {f32_vs_cpu}")
    check(max(bf16_vs_f32.values()) <= CIFAR_BF16_TOL,
          f"bf16 ConvNet vs float32 on the card: {bf16_vs_f32}")
    check(np.isfinite(loss_bf16) and abs(loss_bf16 - loss_f32)
          <= CIFAR_LOSS_TOL,
          f"first-step loss bf16 {loss_bf16} vs float32 {loss_f32}")


def _cifar_score(card: str, bundle) -> None:
    """Featurize and score CIFAR_SCORE_ROWS flat uint8 rows through
    TorchModel at minibatch CIFAR_BATCH: rows/s (best of 2 after a warm
    call) for each node, and one traced minibatch's busy and idle."""
    import torch

    from mmlspark_tpu_torch.data.table import DataTable
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    flat = np.random.default_rng(2).integers(
        0, 256, (CIFAR_SCORE_ROWS, 32 * 32 * 3), dtype=np.uint8)
    table = DataTable({"image": list(flat)})
    out = {"phase": "cifar", "part": "score", "card": card,
           "rows": CIFAR_SCORE_ROWS, "minibatch": CIFAR_BATCH}
    _reset_port_kernel_launches()
    for node in ("features", "logits"):
        model = TorchModel(model=bundle, input_col="image",
                           output_col="out", output_node=node,
                           minibatch_size=CIFAR_BATCH)
        model.transform(table)                      # warm
        best, result = None, None
        for _ in range(2):
            t0 = time.perf_counter()
            result = model.transform(table)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        got = np.stack(result["out"])
        width = (bundle.module.dense_width if node == "features"
                 else CIFAR_CLASSES)
        check(got.shape == (CIFAR_SCORE_ROWS, width),
              f"{node} shape {got.shape}")
        check(bool(np.isfinite(got).all()), f"non-finite {node}")
        out[node] = {"shape": list(got.shape), "best_s": best,
                     "rows_per_s": CIFAR_SCORE_ROWS / best}
    one = DataTable({"image": list(flat[:CIFAR_BATCH])})
    wall = min(_synced_ms(lambda: model.transform(one), 1)
               for _ in range(3))
    traced = _device_trace(lambda: model.transform(one))
    traced["wall_ms"] = wall
    traced["device_idle_share_of_wall"] = 1 - traced["device_busy_ms"] / wall
    out["one_minibatch_logits"] = traced
    out["port_kernel_launches"] = _port_kernel_launches()
    emit(out)
    check(not any(out["port_kernel_launches"].values()),
          f"scoring launched a kernel of the port: "
          f"{out['port_kernel_launches']}")
    torch.cuda.empty_cache()


def _cifar_eval_and_serve(card: str) -> None:
    """Train the ConvNet on a learnable task through the input scoring
    gives it, score the held-out rows through TorchModel (accuracy and
    confusion matrix), then serve the same bundle through ModelServer."""
    import torch

    from mmlspark_tpu_torch.data.table import DataTable
    from mmlspark_tpu_torch.ml.metrics import confusion_matrix
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.models.zoo import get_model
    from mmlspark_tpu_torch.serve.config import ServeConfig
    from mmlspark_tpu_torch.serve.server import ModelServer
    from mmlspark_tpu_torch.train.preprocess import DevicePreprocess

    n = CIFAR_EVAL_TRAIN + CIFAR_EVAL_TEST
    x, y = _class_blobs(n, (32, 32, 3), CIFAR_CLASSES, seed=0)
    x = np.round(x).astype(np.uint8)
    bundle = get_model("ConvNet_CIFAR10", seed=0)
    trainer = _cifar_trainer(
        bundle.module, batch_size=CIFAR_EVAL_BATCH, epochs=CIFAR_EVAL_EPOCHS,
        optimizer="adam", learning_rate=CIFAR_EVAL_LR, input_scale=1.0,
        preprocess=DevicePreprocess(mean=(128.0,) * 3))
    t0 = time.perf_counter()
    trainer.fit_arrays(x[:CIFAR_EVAL_TRAIN], y[:CIFAR_EVAL_TRAIN])
    fit_s = time.perf_counter() - t0
    losses = trainer.history
    del trainer
    flat = x[CIFAR_EVAL_TRAIN:].reshape(CIFAR_EVAL_TEST, -1)
    yte = y[CIFAR_EVAL_TRAIN:]
    model = TorchModel(model=bundle, input_col="image", output_col="out",
                       minibatch_size=CIFAR_BATCH)
    logits = np.stack(model.transform(DataTable({"image": list(flat)}))
                      ["out"])
    pred = logits.argmax(-1)
    cm = confusion_matrix(yte, pred, CIFAR_CLASSES)
    quarter = max(1, len(losses) // 4)
    first_q = float(np.mean(losses[:quarter]))
    last_q = float(np.mean(losses[-quarter:]))
    emit({"phase": "cifar", "part": "train_then_evaluate", "card": card,
          "train_rows": CIFAR_EVAL_TRAIN, "test_rows": CIFAR_EVAL_TEST,
          "batch": CIFAR_EVAL_BATCH, "epochs": CIFAR_EVAL_EPOCHS,
          "optimizer": f"adam {CIFAR_EVAL_LR}",
          "input": "input_scale 1, mean 128 "
          "(center_128)", "fit_s": fit_s, "losses": losses,
          "loss_first_quarter": first_q, "loss_last_quarter": last_q,
          "accuracy": float((pred == yte).mean()),
          "min_accuracy": CIFAR_EVAL_MIN_ACCURACY,
          "confusion_matrix": cm.tolist()})
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(last_q < first_q, f"the loss did not fall: {first_q} -> {last_q}")
    check(int(cm.sum()) == CIFAR_EVAL_TEST, f"confusion matrix {cm}")
    accuracy = float((pred == yte).mean())
    check(accuracy >= CIFAR_EVAL_MIN_ACCURACY,
          f"held-out accuracy {accuracy} < {CIFAR_EVAL_MIN_ACCURACY}")

    # serving: single-row requests from a few clients, each answer held
    # against TorchModel's row (minibatch CIFAR_BATCH) for the same image
    rows = list(flat[:CIFAR_SERVE_REQUESTS])
    answers: dict[int, np.ndarray] = {}
    latencies: list[float] = []
    errors: list[BaseException] = []
    lock = threading.Lock()

    def client(idx: int, server: ModelServer) -> None:
        try:
            for r in range(idx, len(rows), CIFAR_SERVE_CLIENTS):
                t = time.perf_counter()
                got = server.predict("cifar", DataTable({"input": [rows[r]]}),
                                     timeout=120)
                with lock:
                    answers[r] = np.stack(got["scores"])[0]
                    latencies.append((time.perf_counter() - t) * 1e3)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    server = ModelServer(ServeConfig(buckets=CIFAR_SERVE_BUCKETS))
    try:
        server.add_model("cifar", bundle,
                         example=DataTable({"input": rows[:1]}))
        t_serve = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i, server))
                   for i in range(CIFAR_SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        serve_s = time.perf_counter() - t_serve
        snap = server.snapshot()["cifar"]
    finally:
        server.close()
    if errors:
        raise errors[0]
    check(len(answers) == len(rows), f"{len(answers)} answers for "
                                     f"{len(rows)} requests")
    want = logits[:len(rows)]
    got = np.stack([answers[r] for r in range(len(rows))])
    gap = _relative_gap(torch.from_numpy(got), torch.from_numpy(want))
    lat = np.asarray(latencies)
    emit({"phase": "cifar", "part": "serve", "card": card,
          "requests": len(rows), "clients": CIFAR_SERVE_CLIENTS,
          "buckets": list(CIFAR_SERVE_BUCKETS), "batches": snap["batches"],
          "occupancy_by_bucket": snap["occupancy_by_bucket"],
          "requests_per_s": len(rows) / serve_s,
          "latency_p50_ms": float(np.percentile(lat, 50)),
          "latency_p99_ms": float(np.percentile(lat, 99)),
          "max_err_vs_torch_model": gap, "tol": CIFAR_SERVE_TOL,
          "tolerance": "max |error| over max |TorchModel logit|",
          "same_argmax": float((got.argmax(-1) == want.argmax(-1)).mean())})
    check(snap["completed"] == len(rows) and snap["failed"] == 0,
          f"serving stats {snap}")
    check(gap <= CIFAR_SERVE_TOL,
          f"served logits vs TorchModel's: {gap} > {CIFAR_SERVE_TOL}")
    del bundle, model
    torch.cuda.empty_cache()


def phase_cifar(card: str) -> None:
    """The CIFAR-10 ConvNet: (a) the headline training run through
    ``Trainer.fit_arrays`` with one traced step, (b) its correctness on
    the card, (c) featurize and score through TorchModel, (d) train then
    evaluate, (e) serve. The path launches none of the port's kernels
    (its convs, GEMMs and pooling are PyTorch's); the run fails if it
    launches one."""
    import torch

    from mmlspark_tpu_torch.models.zoo import get_model
    from mmlspark_tpu_torch.train.loop import _batches

    t0 = time.perf_counter()
    rows = CIFAR_STEPS * CIFAR_BATCH
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (rows, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, CIFAR_CLASSES, rows).astype(np.int64)
    bundle = get_model("ConvNet_CIFAR10", seed=0)
    module = bundle.module
    init = {k: v.detach().clone() for k, v in module.state_dict().items()}
    trainer = _cifar_trainer(module)
    setup_s = time.perf_counter() - t0
    flops = convnet_forward_flops(module.widths, module.dense_width,
                                  module.num_classes)

    # the main path: launch counts from 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_port_kernel_launches()
    t_fit = time.perf_counter()
    trainer.fit_arrays(x, y)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    launches = _port_kernel_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(trainer.global_step == CIFAR_STEPS,
          f"{trainer.global_step} steps, expected {CIFAR_STEPS}")
    check(len(trainer.history) == CIFAR_STEPS
          and all(np.isfinite(v) for v in trainer.history),
          f"losses {trainer.history}")
    check(launches["fused_resize_norm"] == 0 and not any(launches.values()),
          f"the CIFAR step launched a kernel of the port: {launches}")
    step_ms = trainer.step_ms
    after_first = step_ms[1:]
    step_med = statistics.median(after_first)

    # one step's wall (host clock, synchronised) and one traced step
    first = next(_batches(x, y, CIFAR_BATCH, trainer.cfg.seed))
    dx, dy, dw = (torch.from_numpy(a).cuda() for a in first)
    wall = _synced_ms(lambda: trainer.train_step(dx, dy, dw), 5)
    traced = _device_trace(lambda: trainer.train_step(dx, dy, dw))
    traced["wall_ms"] = wall
    traced["device_idle_share_of_wall"] = 1 - traced["device_busy_ms"] / wall
    traced["images_per_s"] = CIFAR_BATCH / wall * 1e3
    stats = trainer.input_stats
    emit({"phase": "cifar", "part": "train", "model": "ConvNet_CIFAR10",
          "card": card, "widths": list(module.widths),
          "dense_width": module.dense_width, "dtype": "bfloat16",
          "rows": rows, "batch": CIFAR_BATCH, "steps": CIFAR_STEPS,
          "preprocess": CIFAR_SPEC, "optimizer": "momentum 0.01",
          "losses": list(trainer.history), "setup_s": setup_s,
          "fit_wall_s": fit_s, "step_ms": step_ms,
          "step_ms_median_after_first": step_med,
          "images_per_s_after_first": CIFAR_BATCH * len(after_first)
          / (sum(after_first) / 1e3),
          "forward_gflop_per_image": flops / 1e9,
          "mfu_bf16": 3 * flops * CIFAR_BATCH / (step_med / 1e3)
          / PEAK_OPS_S["bfloat16"],
          "input_bound_fraction": stats["input_bound_fraction"],
          "input_wait_s": stats["input_wait_s"],
          "peak_memory_gb": peak_gb, "port_kernel_launches": launches,
          "one_step": traced})
    del trainer
    torch.cuda.empty_cache()

    _cifar_checks(card, init, first)
    torch.cuda.empty_cache()
    _cifar_score(card, bundle)
    del bundle, module
    _cifar_eval_and_serve(card)


def _plain_group_norm_counter():
    """Count the calls of the plain GroupNorm routes on CUDA tensors (the
    kernel route must make none); returns ``(counts, restore)``."""
    import torch

    from mmlspark_tpu_torch.ops import group_norm as gn_op
    plain = {name: getattr(gn_op, name)
             for name in ("group_norm_reference", "group_norm_backward",
                          "group_norm_backward_reference")}
    counts = dict.fromkeys(plain, 0)

    def counted(name):
        def call(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                counts[name] += 1
            return plain[name](*args, **kwargs)
        return call

    for name in plain:
        setattr(gn_op, name, counted(name))

    def restore() -> None:
        for name, fn in plain.items():
            setattr(gn_op, name, fn)

    return counts, restore


def _image_stack(col) -> np.ndarray:
    return np.stack([v["data"] for v in col])


def _feature_gap(got: np.ndarray, want: np.ndarray) -> float:
    import torch
    return _relative_gap(torch.from_numpy(got), torch.from_numpy(want))


def _one_segment(plan, stages: list, table, want: list):
    """The fused segment ``plan.describe_plan`` must show as
    ``[("device", want)]``; fails with the planner's reasons when the
    stages do not form it."""
    segments = [(kind, [type(s).__name__ for s in ss])
                for kind, ss in plan.describe_plan(stages, table)]
    reasons: list = []
    seg = plan.collect_segment(stages, 0,
                               lambda col: plan._entry_meta(table, col),
                               explain=reasons)
    check(seg is not None and segments == [("device", want)],
          f"plan {segments}, expected one device segment of {want}: "
          f"{reasons}")
    return seg, segments


def _example_302(card: str) -> None:
    """Example 302's pipeline on uniform images: one fused segment, one
    upload a minibatch, and the host route's answers (crop and flip
    exact, resize within one count)."""
    from mmlspark_tpu_torch.core import plan
    from mmlspark_tpu_torch.core.pipeline import Pipeline
    from mmlspark_tpu_torch.core.schema import make_image
    from mmlspark_tpu_torch.data.table import DataTable
    from mmlspark_tpu_torch.stages.image import ImageTransformer, UnrollImage
    pixels = np.random.default_rng(1).integers(
        0, 256, (FEAT_302_ROWS,) + FEAT_302_SRC + (3,), dtype=np.uint8)
    table = DataTable({"image": [make_image(f"img{i:04d}.png", p)
                                 for i, p in enumerate(pixels)]})
    stages = [ImageTransformer(device=DEV).resize(height=60, width=60)
              .crop(x=0, y=0, height=48, width=48).flip(flip_code=1),
              UnrollImage(input_col="image", output_col="features",
                          scale=1 / 255.0)]
    model = Pipeline(stages).fit(table)
    seg, segments = _one_segment(plan, model.stages, table,
                                 ["ImageTransformer", "UnrollImage"])
    with plan.count_crossings() as crossings:
        fused = model.transform(table)
    host = stages[1].transform(stages[0].transform(table))
    image_gap = int(np.abs(_image_stack(fused["image"]).astype(int)
                           - _image_stack(host["image"]).astype(int)).max())
    feature_gap = float(np.abs(np.stack(fused["features"])
                               - np.stack(host["features"])).max())
    n_mb = plan.predict_segment_minibatches(seg, FEAT_302_ROWS)
    emit({"phase": "featurize", "part": "example_302", "card": card,
          "rows": FEAT_302_ROWS, "source": list(FEAT_302_SRC),
          "plan": segments, "minibatches": n_mb,
          "uploads": crossings.uploads, "fetches": crossings.fetches,
          "max_image_gap_vs_host": image_gap,
          "max_feature_gap_vs_host": feature_gap,
          "tolerance": "images within 1 count of the host route (resize "
          "rounding), features within 1/255 + 1e-6"})
    check(n_mb == -(-FEAT_302_ROWS // plan.DEFAULT_MINIBATCH),
          f"example 302: {n_mb} minibatches predicted")
    check(crossings.uploads == n_mb and crossings.fetches == n_mb,
          f"example 302: {crossings.uploads} uploads, {crossings.fetches} "
          f"fetches for {n_mb} minibatches")
    check(image_gap <= 1 and feature_gap <= 1 / 255.0 + 1e-6,
          f"example 302 vs the host route: images {image_gap}, features "
          f"{feature_gap}")


def phase_featurize(card: str) -> int:
    """Featurize FEAT_ROWS images through Pipeline([ImageTransformer,
    ImageFeaturizer]) over ResNet-50 GroupNorm as one fused segment;
    returns K5's launches on that run. Checks one segment, one upload of
    the raw uint8 batch and one fetch round a minibatch, 53 K5 launches a
    minibatch and no plain GroupNorm call on the card; the fused features
    against ImageFeaturizer alone over the same resized images, the K5
    route against the plain GroupNorm, and float32 on the card against
    the CPU; then rows/s fused and stage by stage, one traced minibatch
    and peak memory; then example 302's pipeline."""
    import torch

    from mmlspark_tpu_torch.core import plan
    from mmlspark_tpu_torch.core.pipeline import Pipeline
    from mmlspark_tpu_torch.core.schema import make_image
    from mmlspark_tpu_torch.data.table import DataTable
    from mmlspark_tpu_torch.models.bundle import ModelBundle, meta_copy
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.resnet import gn_sites
    from mmlspark_tpu_torch.models.zoo import get_model
    from mmlspark_tpu_torch.ops import group_norm as gn_op
    from mmlspark_tpu_torch.stages.image import ImageTransformer

    t_phase = time.perf_counter()
    pixels = np.random.default_rng(0).integers(
        0, 256, (FEAT_ROWS,) + FEAT_SRC + (3,), dtype=np.uint8)
    table = DataTable({"image": [make_image(f"img{i:05d}.jpg", p)
                                 for i, p in enumerate(pixels)]})
    featurizer = ImageFeaturizer(
        cut_output_layers=1, minibatch_size=FEAT_MINIBATCH,
        device=DEV).set_model_by_name(FEAT_MODEL, seed=0)
    bundle = featurizer.model
    sites = gn_sites(bundle.module)
    transformer = (ImageTransformer(device=DEV).resize(*FEAT_RESIZE)
                   .crop(**FEAT_CROP).flip(1))
    model = Pipeline([transformer, featurizer]).fit(table)
    seg, segments = _one_segment(plan, model.stages, table,
                                 ["ImageTransformer", "ImageFeaturizer"])
    n_mb = plan.predict_segment_minibatches(seg, FEAT_ROWS)
    check(n_mb == -(-FEAT_ROWS // FEAT_MINIBATCH),
          f"{n_mb} minibatches predicted for {FEAT_ROWS} rows at "
          f"{FEAT_MINIBATCH}")
    setup_s = time.perf_counter() - t_phase

    # the main path: launch counts from 0 just before, read just after
    counts, restore = _plain_group_norm_counter()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_port_kernel_launches()
        with plan.count_crossings() as crossings:
            t_main = time.perf_counter()
            fused = model.transform(table)
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t_main
        launches = _port_kernel_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        restore()
    features = np.stack(fused["features"])
    images = _image_stack(fused["image"])
    width = bundle.module.head.in_features
    check(features.shape == (FEAT_ROWS, width)
          and bool(np.isfinite(features).all()),
          f"features {features.shape}, finite {np.isfinite(features).all()}")
    check(images.shape == (FEAT_ROWS, FEAT_CROP["height"],
                           FEAT_CROP["width"], 3)
          and fused["image"][1]["path"] == "img00001.jpg",
          f"resized image column {images.shape}")
    check(crossings.uploads == n_mb and crossings.fetches == n_mb,
          f"{crossings.uploads} uploads and {crossings.fetches} fetch "
          f"rounds for {n_mb} minibatches")
    check(crossings.upload_shapes == {(FEAT_MINIBATCH,) + FEAT_SRC + (3,)},
          f"uploaded shapes {crossings.upload_shapes}: expected the raw "
          "uint8 batch")
    check(launches["group_norm"] == sites * n_mb,
          f"{launches['group_norm']} K5 launches for {n_mb} minibatches, "
          f"expected {sites} a minibatch")
    check(not any(v for k, v in launches.items() if k != "group_norm"),
          f"the featurize path launched another kernel: {launches}")
    check(not any(counts.values()),
          f"the featurize path reached a plain GroupNorm route on the "
          f"card: {counts}")

    # rows/s: fused (best of 2, warm), and stage by stage (the host
    # ImageTransformer, then ImageFeaturizer over its output)
    fused_s = min(_synced_ms(lambda: model.transform(table), 1)
                  for _ in range(2)) / 1e3
    t0 = time.perf_counter()
    host = transformer.transform(table)
    host_s = time.perf_counter() - t0
    featurizer.transform(host.take(np.arange(FEAT_MINIBATCH)))  # warm
    by_stage_s = _synced_ms(lambda: featurizer.transform(host), 1) / 1e3
    image_gap = int(np.abs(images.astype(int)
                           - _image_stack(host["image"]).astype(int)).max())

    # correctness on the card, each over the same resized images
    resized = DataTable({"image": list(fused["image"])})
    alone = np.stack(featurizer.transform(resized)["features"])
    plain_bundle = get_model(FEAT_MODEL, seed=0, gn_impl="torch",
                             device=DEV)
    plain_bundle.module.load_state_dict(bundle.module.state_dict())
    launched = gn_op.launches
    plain = np.stack(ImageFeaturizer(
        cut_output_layers=1, minibatch_size=FEAT_MINIBATCH, device=DEV,
        model=plain_bundle).transform(
            DataTable({"image": list(fused["image"][:FEAT_PLAIN_ROWS])}))
        ["features"])
    check(gn_op.launches == launched, "the plain GroupNorm route "
                                      "launched K5")
    del plain_bundle
    f32 = get_model(FEAT_MODEL, seed=0, dtype=torch.float32, device=DEV)
    cpu_module = meta_copy(f32.module).to_empty(device="cpu")
    cpu_module.load_state_dict({k: v.cpu() for k, v in
                                f32.module.state_dict().items()})
    cpu = ModelBundle(cpu_module.eval(), f32.input_spec, f32.output_names,
                      preprocess=f32.preprocess, name=f32.name)
    few = DataTable({"image": list(fused["image"][:FEAT_F32_ROWS])})
    f32_card = np.stack(ImageFeaturizer(
        cut_output_layers=1, device=DEV, model=f32).transform(few)
        ["features"])
    f32_cpu = np.stack(ImageFeaturizer(
        cut_output_layers=1, device="cpu", model=cpu).transform(few)
        ["features"])
    del f32, cpu, cpu_module
    torch.cuda.empty_cache()
    gaps = {"fused_vs_featurizer_alone": _feature_gap(features, alone),
            "kernel_vs_plain_group_norm": _feature_gap(
                features[:FEAT_PLAIN_ROWS], plain),
            "f32_card_vs_cpu": _feature_gap(f32_card, f32_cpu)}

    # one minibatch through the fused pipeline, traced
    one = DataTable({"image": list(table["image"][:FEAT_MINIBATCH])})
    wall = min(_synced_ms(lambda: model.transform(one), 1)
               for _ in range(3))
    traced = _device_trace(lambda: model.transform(one), GN_KERNEL_NAMES)
    traced["wall_ms"] = wall
    traced["device_idle_share_of_wall"] = (
        1 - traced["device_busy_ms"] / traced["wall_ms"])
    k5_ms, k5_n = traced["kernels_by_name"]["gn_cluster"]
    traced["group_norm_share_of_busy"] = k5_ms / traced["device_busy_ms"]
    emit({"phase": "featurize", "part": "pipeline", "card": card,
          "model": FEAT_MODEL, "dtype": "bfloat16", "rows": FEAT_ROWS,
          "source": list(FEAT_SRC), "minibatch": FEAT_MINIBATCH,
          "stages": f"resize {FEAT_RESIZE}, crop {FEAT_CROP}, flip 1; "
          "ImageFeaturizer cut_output_layers 1", "plan": segments,
          "minibatches": n_mb, "uploads": crossings.uploads,
          "fetches": crossings.fetches,
          "upload_bytes": crossings.upload_bytes,
          "upload_shapes": sorted(crossings.upload_shapes),
          "group_norm_sites": sites,
          "group_norm_launches": launches["group_norm"],
          "group_norm_launches_per_minibatch": launches["group_norm"] / n_mb,
          "plain_group_norm_calls_on_card": counts,
          "port_kernel_launches": launches, "setup_s": setup_s,
          "first_call_s": main_s, "fused_s": fused_s,
          "rows_per_s_fused": FEAT_ROWS / fused_s,
          "stage_by_stage": {"image_transformer_host_s": host_s,
                             "image_featurizer_s": by_stage_s,
                             "rows_per_s": FEAT_ROWS
                             / (host_s + by_stage_s)},
          "peak_memory_gb": peak_gb, "one_minibatch": traced})
    emit({"phase": "featurize", "part": "checks", "card": card,
          "gaps": gaps, "tol": FEAT_TOL, "f32_tol": FEAT_F32_TOL,
          "plain_rows": FEAT_PLAIN_ROWS, "f32_rows": FEAT_F32_ROWS,
          "max_image_gap_fused_vs_host": image_gap,
          "tolerances": "max |error| over max |reference| of the "
          "features; images within 1 count of the host resize"})
    check(k5_n == sites, f"{k5_n} gn_cluster kernels in one traced "
                         f"minibatch, expected {sites}")
    check(gaps["fused_vs_featurizer_alone"] <= FEAT_TOL
          and gaps["kernel_vs_plain_group_norm"] <= FEAT_TOL,
          f"bf16 features: {gaps}")
    check(gaps["f32_card_vs_cpu"] <= FEAT_F32_TOL,
          f"float32 features on the card vs the CPU: {gaps}")
    check(image_gap <= 1, f"fused images vs the host route: {image_gap}")
    del model, featurizer, bundle, fused, host
    torch.cuda.empty_cache()
    _example_302(card)
    emit({"phase": "featurize", "part": "time", "card": card,
          "phase_s": time.perf_counter() - t_phase})
    return launches["group_norm"]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    args = parser.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}; choose from {PHASES}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from mmlspark_tpu_torch.device import resolve_device
    resolve_device()  # the float32 precision policy, before any compute
    dev = phase_device()
    card = dev["nvidia_smi"]
    kernels = []
    gn_entry = None
    attn = phase_attention() if "attention" in phases else None
    if "serve" in phases:
        launches = phase_serve(card, attn["ms"] if attn else None)
        torch.cuda.empty_cache()
        if attn:
            kernels.append({
                "name": "flash_attention", "route": "cuda",
                "source": "mmlspark_tpu_torch/ops/csrc/flash_attention.cu",
                "replaces": "mmlspark_tpu/ops/pallas/attention.py:183",
                "launches": launches, "max_abs_err": attn["max_abs_err"],
                "ms": attn["ms"], "ms_cold_l2": attn["ms_cold_l2"],
                "plain_ms": attn["plain_ms"],
                "bound_ms": attn["bound_ms"], "bound_by": attn["bound_by"],
                "library_ms": attn["library_ms"]})
    dec = (phase_decode_attention() if "decode_attention" in phases
           else None)
    torch.cuda.empty_cache()
    if "generate" in phases:
        launches = phase_generate(card)
        torch.cuda.empty_cache()
        if dec:
            kernels.append({
                "name": "decode_attention", "route": "cuda",
                "source": "mmlspark_tpu_torch/ops/csrc/decode_attention.cu",
                "replaces": "mmlspark_tpu/ops/pallas/attention.py:370",
                "launches": launches, "max_abs_err": dec["max_abs_err"],
                "ms": dec["ms"], "ms_cold_l2": dec["ms_cold_l2"],
                "plain_ms": dec["plain_ms"],
                "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
                "library_ms": dec["library_ms"]})
    gn = phase_group_norm() if "group_norm" in phases else None
    rs = phase_resize() if "resize" in phases else None
    torch.cuda.empty_cache()
    if "train" in phases:
        launches = phase_train(card, gn, rs)
        if gn:
            gn_entry = {
                "name": "group_norm", "route": "cuda",
                "source": "mmlspark_tpu_torch/ops/csrc/group_norm.cu",
                "replaces": "mmlspark_tpu/ops/group_norm.py:95",
                "launches": launches["group_norm"],
                "max_abs_err": gn["max_abs_err"], "ms": gn["ms"],
                "ms_cold_l2": gn["ms_cold_l2"],
                "plain_ms": gn["plain_ms"], "bound_ms": gn["bound_ms"],
                "bound_by": gn["bound_by"], "library_ms": gn["library_ms"]}
            kernels.append(gn_entry)
            bwd = gn["backward"]
            kernels.append({
                "name": "group_norm_backward", "route": "cuda",
                "source": "mmlspark_tpu_torch/ops/csrc/group_norm.cu",
                "replaces": "mmlspark_tpu/ops/group_norm.py:168",
                "launches": launches["group_norm_backward"],
                "max_abs_err": bwd["max_abs_err"], "ms": bwd["ms"],
                "ms_cold_l2": bwd["ms_cold_l2"],
                "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
                "bound_by": bwd["bound_by"],
                "library_ms": bwd["library_ms"]})
        if rs:
            kernels.append({
                "name": "fused_resize_norm", "route": "cuda",
                "source": "mmlspark_tpu_torch/ops/csrc/resize.cu",
                "replaces": "mmlspark_tpu/ops/pallas/resize.py:155",
                "launches": launches["fused_resize_norm"],
                "max_abs_err": rs["max_abs_err"], "ms": rs["ms"],
                "plain_ms": rs["plain_ms"], "bound_ms": rs["bound_ms"],
                "bound_by": rs["bound_by"], "library_ms": None})
    bu = phase_block_update() if "block_update" in phases else None
    torch.cuda.empty_cache()
    if "sp_train" in phases:
        launches = phase_sp_train(card, bu)
        torch.cuda.empty_cache()
        if bu:
            kernels.append({
                "name": "attention_block_update", "route": "cuda",
                "source": "mmlspark_tpu_torch/ops/csrc/block_update.cu",
                "replaces": "mmlspark_tpu/ops/pallas/attention.py:432",
                "launches": launches["forward"],
                "max_abs_err": bu["max_abs_err"],
                "ms": bu["ms"], "plain_ms": bu["plain_ms"],
                "bound_ms": bu["bound_ms"], "bound_by": bu["bound_by"],
                "tc_bound_ms": bu["tc_bound_ms"], "library_ms": None})
            bwd = bu["backward"]
            # the JAX package differentiates _online_update with jax.vjp
            # through XLA; the kernel is that vjp in closed form. plain_ms
            # is the closed form, autograd_ms the plain update recomputed
            # and differentiated (per hop, the mean over one ring)
            kernels.append({
                "name": "attention_block_update_backward", "route": "cuda",
                "source": "mmlspark_tpu_torch/ops/csrc/block_update_bwd.cu",
                "replaces": "mmlspark_tpu/ops/pallas/attention.py:59",
                "launches": launches["backward"],
                "max_abs_err": bwd["max_abs_err"],
                "max_err_over_bound": bwd["max_err_over_bound"],
                "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
                "autograd_ms": bwd["autograd_ms"],
                "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
                "tc_bound_ms": bwd["tc_bound_ms"], "library_ms": None})
    if "cifar" in phases:
        phase_cifar(card)
        torch.cuda.empty_cache()
    if "featurize" in phases:
        launches = phase_featurize(card)
        torch.cuda.empty_cache()
        if gn_entry is not None:
            # K5 in inference mode inside the fused featurize segment
            gn_entry["featurize_launches"] = launches
    if kernels:
        emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    if set(phases) != set(PHASES):
        print(f"chip_smoke: partial run ({','.join(phases)}); no result "
              "line", flush=True)
        return 0
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
