#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each fatal on failure:
1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the hand-written CUDA kernels from csrc/ (nvcc, sm_90a).
3. Kernels: at every WRN-28-10 stage shape (C = 160, 320, 640 at 32x32,
   16x16, 8x8; batch 128) hold each kernel against its plain PyTorch
   version on the same CUDA tensors, every epilogue mode of the int8
   kernel included, and time the kernel, the plain version and cuDNN's
   bf16 ``F.conv2d`` (channels-last) at the same shape. Both convs are a
   prepass into the padded slab and a wgmma GEMM: each op must give the
   same bits in two calls and equal its GEMM run alone on its checked
   slab, each slab must equal its plain version byte for byte, and each
   part is timed apart (CUDA events) and in device time (torch.profiler).
   The augment kernel (ops/cuda/csrc/augment.cu) against its plain version
   at batch 128 and 512, mirror and zero padding, with and without
   whitening (bit-equal), timed beside the plain version and the port's
   torch transform chain with the same draws.
4. Serving, the first main path: a run directory with the WRN-28-10 recipe
   (models_dir/wrn-28-10-dropout_cifar10/config.yaml at full width, random
   weights from the config's seed, Synthetic CIFAR-shaped data), served
   through ``load_predictor(config)`` and ``load_predictor(config,
   quantize="int8")``, answering requests that include ragged batches.
   The launch counts, zeroed just before, must show 22 launches of each
   bf16-conv part (prepass, GEMM) per calibration batch and 22 of each
   int8-conv part per serving batch.
   Logits must be finite; int8 serving through the kernels must match the
   same int8 walk through the plain versions with the same scales; the
   float walk through the bf16 kernel must match the float model.
5. Training, the second main path: a run directory with the recipe
   models_dir/wrn-28-10-dropout_synthspectral-hard/config.yaml (full width,
   50,000 SyntheticSpectral images resident on the card, batch 128, SGD
   Nesterov) plus ``use_pallas_augment: True``, built by ``setup(config)``
   and trained for 10 steps through the train step. With the launch counts
   zeroed just before, each step must launch the augment kernel once and
   no other kernel of the port; losses must be finite, every parameter
   must change and every BatchNorm count must equal the steps. One step's
   augmented batch through the kernel must equal the plain version's with
   the same draws. Prints the step time and img/s after warm-up, the
   augment kernel's share of the step, and a torch.profiler breakdown of
   three more steps.
6. Int8 FQT kernels: at every WRN-28-10 stage shape (batch 128) hold the
   fused block-half kernels (ops/cuda/csrc/fused_block.cu) against their
   plain versions on the same CUDA tensors: the forward in all four
   (residual, BatchNorm sums) modes, the backward's shared quantization
   and dgrad and the wgrad with and without stats cotangents (the wgrad on
   csrc/fused_wgrad_s8.cu: the TMA + s8 wgmma mainloop of
   csrc/wgrad_wgmma_s8.cuh at the nine stride-1 taps, its scale groups
   split into runs whose slots are added in group order where its plan
   says so); and the stem kernels (ops/cuda/csrc/stem.cu, the weight
   gradient a tensor-core GEMM over positions, its blocks' slots added in
   a fixed order) at 3 -> 160 channels, 32x32.
   Int8 codes, group absmaxes, bf16 outputs and the weight gradient must
   be equal, f32 sums over positions within 1e-5 of their largest value;
   both weight gradients must give the same bits in two calls and are also
   timed in device time (torch.profiler).
   Each is timed beside its plain version and cuDNN's bf16 forward, input
   gradient and weight gradient (channels-last) at the same shape. The
   forward (the amax pass, the prepass that writes the codes into the
   padded slab, then csrc/fwd_wgmma_s8.cuh's TMA-fed s8 wgmma GEMM and
   the ordered sum) must give the same y and sums bit for bit in two
   calls, its slab must equal the plain prepass's byte for byte, and its
   parts are timed apart beside their bounds: the amax pass + prepass and
   the GEMM + sum (CUDA events), and each kernel's device time
   (torch.profiler); the prepass is also a kernel row of its own. The
   dgrad (the backward's amax pass and quantizer, then the prepass that
   copies g's codes into the padded slab, csrc/dgrad_wgmma_s8.cuh's s8
   wgmma GEMM on that mainloop with a dequantizing, masking epilogue, and
   the ordered sum) must give the same dx and sums bit for bit in two
   calls; its slab must equal the plain prepass's byte for byte and its
   GEMM on that slab the plain GEMM's (dx equal, sums within 1e-5); each
   part's device time (amax, quant, pre, GEMM, sum) is printed beside its
   bound and cuDNN's bf16 input gradient; the prepass is a kernel row of
   its own.
7. Training, the third main path: the recipe
   models_dir/wrn-28-10-dropout_synthspectral-hard-int8/config.yaml (int8
   fully quantized training) plus ``use_pallas_augment: True``, through
   ``setup(config)`` as in phase 5. With the launch counts zeroed just
   before, each step must launch the stem forward and weight gradient
   once, the fused half's forward, backward quantization, dgrad (its
   prepass, GEMM and sum) and wgrad 22 times each (FQT_PER_STEP), the
   augment kernel once and no serving
   kernel; losses finite, every parameter changed, every BatchNorm count
   equal to the steps. The first fused half of the first step, on its live
   inputs and cotangents, must reproduce its output and equal its plain
   versions. The first step's halves, counted by (width, residual,
   BatchNorm sums), weigh phase 6's per-call times into per-step figures.
8. NV kernels: at every ResNet-50 stage shape at batch 128 (identity
   56x56/256/64, 28x28/512/128, 14x14/1024/256, 7x7/2048/512; transition
   56x56 64->64->256 at stride 1, then 56->28, 28->14 and 14->7 at
   stride 2) and at WRN-50-2's widest, stage 4 at width 1024, hold
   ``bneck_block_nv`` / ``bneck_transition_nv`` (ops/cuda/csrc/
   bneck_nv.cu) against their plain versions on the same CUDA tensors,
   int8 and bf16 outputs (equal), and time each beside its plain version
   and the same block in bf16 on cuDNN (channels-last convs, f32 BN
   affines: the JAX tools/bench_bneck.py yardstick); each block's three
   launches apart in device time, each beside its own bound.
9. Serving, the fourth main path: a run directory with the ResNet-50
   recipe (models_dir/resnet-50_ilsvrc2012/config.yaml at full width,
   random weights from the config's seed, Synthetic 224x224x3 data with
   1000 classes, the test transforms cut to ToTensor + Standardize,
   batch 128), served through ``load_predictor(config)`` and
   ``load_predictor(config, quantize="int8")`` (``fused_bneck="nv"``),
   with a ragged request. With the launch counts zeroed just before,
   each serving batch must launch the identity block's three kernels 12
   times and the transition's 4 times, and no other port kernel; logits
   finite; the int8 walk through the kernels must equal the same walk
   through the plain versions. Prints float and int8 img/s (uint8 in,
   logits out) and a torch.profiler split of one int8 batch.
10. NV training kernels: at every ResNet-50 identity-block geometry the
   NV training gate admits (stages 1-3 at batch 128, stage 4 at batch 64)
   and every kind of half (conv1 in identity and entry mode, conv2 3x3,
   conv3), hold the forward, dgrad and wgrad of ops/cuda/csrc/
   bneck_nv_train.cu against their plain versions on the same CUDA
   tensors, with non-zero stats cotangents (and dx_res in entry mode), at
   the JAX pickers' row chunks: row absmaxes, y, x_res, dx, dres and dW
   equal, the f32 sums within 1e-5 of their largest value. Each stage is
   timed beside its plain version and cuDNN's bf16 forward, input gradient
   and weight gradient (channels-last) at the same shape. The forward (the
   prepass that quantizes each chunk's activation once into a
   position-major int8 slab, then csrc/fwd_staged_s8.cuh's cp.async ring
   into ldmatrix and s8 mma.sync with a staged epilogue, then the ordered
   sum) must give the same y and sums bit for bit in two calls, its
   prepass's slabs must equal its plain version's byte for byte, and its
   three parts (the row-max pass, the prepass, the mainloop + sum) are
   timed apart beside their plain versions and byte bounds; the prepass is
   also a kernel row of its own. The input gradient (the prepass that
   quantizes each chunk's cotangent once into the forward's slab layout,
   then csrc/nv_dgrad_wgmma_s8.cuh's TMA-fed s8 wgmma GEMM at the mirrored
   taps with the prologue's backward in its epilogue, then the tiles' sum)
   must give the same dx, dres and sums bit for bit in two calls, its
   prepass's slabs must equal its plain version's byte for byte, and its
   parts (the row-max pass, the prepass, the GEMM + sum, the sum alone)
   are timed apart beside their plain versions and bounds; the prepass is
   also a kernel row of its own. The weight
   gradient (the prepass that writes each chunk's int8 slabs K-contiguous,
   then csrc/wgrad_staged_s8.cuh's cp.async ring into ldmatrix and s8
   mma.sync, then the ordered sum) must give the same dW bit for bit in two
   calls, its prepass's slabs must equal its plain version's byte for byte,
   and the prepass and the mainloop + sum are timed apart; the prepass is
   also a kernel row of its own.
11. Training, the fifth main path: the ResNet-50 recipe at full width
   (Synthetic 224x224x3 data, 1,024 resident images, the training
   transforms cut to ToTensor + Flip + Standardize, batch 128) with
   ``use_int8_train_bwd``, through ``setup(config)`` as in phase 5. With the
   launch counts zeroed just before, each step must launch 30 NV halves
   (3 identity-mode conv1, 7 entry-mode conv1, 10 conv2, 10 conv3), each
   one forward, dgrad and wgrad (each with its prepass and sum, the
   identity-mode dgrads without d(s)/d(t) and their sum;
   NV_TRAIN_PER_STEP), and no other port kernel; losses finite, every
   parameter changed, every BatchNorm count equal to the steps. The first
   half of each kind in the first step, on its live inputs and cotangents,
   must reproduce its outputs and equal its plain versions. The same
   recipe without the flag (bf16 on cuDNN) runs as the yardstick; both
   print step time, img/s, peak memory and a profile, and the halves'
   per-step time from phase 10's per-call times is printed beside the
   profiled one, the int8 wgrad's per-step time with its prepass and
   mainloop + sum apart, and the FQT step's wall and device time and peak
   memory beside the bf16 run's.
12. Fused bf16 half kernels: at every WRN-28-10 stage shape (batch 128)
   hold the bf16 forward, dgrad and wgrad (ops/cuda/csrc/
   fused_block_bf16.cu) against their plain versions on the same CUDA
   tensors, with and without residual and BatchNorm sums, with materialized
   dropout bits and with a seed (the hash of csrc/seed_bits.cuh rebuilt in
   registers): bf16 outputs within 2 bf16 ulps of the tensor's largest
   value, dres equal, f32 sums over the tensor cores' accumulators within
   1e-4 of their largest value (``_agree_bf16`` says why) and the
   BatchNorm sums within 1e-5 of the sums of the kernel's own y. The int8
   core's quantizers and dgrad in seed mode equal their plain versions and
   themselves fed the expanded bits; ``seed_bits_expand`` is bit-equal to
   the plain ``seed_bits`` for seeds across the int32 range. The dgrad
   (its prepass ``fused_half_bf16_dgrad.pre``, then csrc/
   dgrad_wgmma_bf16.cuh's wgmma GEMM with its masking epilogue and the
   ordered sum) and the wgrad (its prepass ``fused_half_bf16_wgrad.pre``,
   then csrc/wgrad_staged.cuh's mainloop and ordered sum) are also
   bit-equal over two calls, and each prepass has rows of its own, equal
   to its plain version byte for byte. Each is timed beside its plain
   version and cuDNN's bf16 forward, input gradient and weight gradient
   (channels-last) at the same shape; the dgrad's and the wgrad's prepass
   and mainloop + sum also apart.
13. Training, the sixth main path: the bf16 recipe of phase 5 with
   ``use_fused_block: True`` through ``setup(config)``. With the launch
   counts zeroed just before, each step must launch the stem, the augment
   kernel and 8 fused bf16 halves (the 4 identity blocks of stage 1), each
   one forward, dgrad and wgrad (each its prepass, GEMM or mainloop and
   sum; FUSED_PER_STEP); losses finite, every
   parameter changed, every BatchNorm count equal to the steps.
14. Training, the seventh main path: the ``-int8`` recipe with
   ``use_int8_train: True``, ``use_int8_train_bwd: False`` (QAT) and
   ``use_inkernel_dropout: True``: 22 halves per step on the int8 forward
   and the bf16 backward (QAT_PER_STEP), 15 of them (stages 1 and 2)
   rebuilding their dropout masks from a seed (in the forward's quantizer
   and kernel, the dgrad's GEMM and the wgrad's prepass), so no uint8 bits
   tensor
   is drawn for them, and the 7 at C=640 on drawn bits. In phases 13 and 14
   the first half of each bits mode in the first step, on its live inputs
   and cotangents, must reproduce its output and equal its plain versions.
   Phase 12 also holds ``fused_half`` at C = 48 without dropout (the gate's
   C % 16 case, zero-padded to 64 channels for the kernels) against the
   plain versions of the unpadded half.
15. Transition kernels: at WRN-28-10's two stage transitions at batch 128
   (160 -> 320 channels, 32x32 -> 16x16; 320 -> 640, 16x16 -> 8x8) hold
   the transition half's kernels (ops/cuda/csrc/transition.cu) against
   their plain versions on the same CUDA tensors: the forward (the fused
   half's amax pass at the transition's scale groups, the prepass that
   quantizes each group's parity planes once into a position-major int8
   slab and writes the raw even-even plane into a bf16 slab, then
   csrc/fwd_staged_s8.cuh's cp.async ring into ldmatrix and s8 mma.sync at
   nine tap shifts and its bf16 instantiation for the projection, with a
   channel-major epilogue, then the ordered sum) with dropout bits,
   without, and with the option-A shortcut at stage 2; the FQT operands
   in one launch (a thread-block cluster per scale group of the folded
   cotangent; the activation's codes as four parity planes at the
   forward's group absmax, which must equal the plain version's own) and
   the straight-through fold (the rounded cotangent, the bf16 prologue's
   four parity planes and, from both, x's even-even plane; the fold also
   with every output lane loading its own input pair, as the FQT pass
   always loads and both load at output rows off 8 pixels), both also at
   a 24x24 input (Cin 32, Cout 64, three scale groups: output rows of 12
   pixels); the dgrad of both
   bodies (its prepass writing g, and dres where a projection runs, once
   into the fused forward's padded slab at the output geometry, then each
   parity class of input pixel a tap range on csrc/fwd_wgmma_s8.cuh's
   TMA-fed s8 wgmma mainloop or csrc/fwd_wgmma_bf16.cuh's bf16 one, both
   column classes of a row parity in one block, the projection's shortcut
   on the bf16 mainloop, a masking epilogue in whole runs of input lanes,
   then the tiles' sum: bit-equal over two calls, the prepass byte for
   byte, its three parts apart in device time); the FQT wgrad on the TMA + s8 wgmma mainloop of
   csrc/wgrad_wgmma_s8.cuh (csrc/transition_wgrad.cu: one launch, each
   tap a parity plane moved by a shifter warpgroup, the scale groups
   folded in order in each tile); the straight-through wgrad and dWp
   apart, on the TMA + wgmma mainloop of csrc/wgrad_wgmma_bf16.cuh (each
   tap a parity plane at its row and column shift); each wgrad bit-equal
   over two calls and also in device time and TFLOP/s (TOP/s). Int8
   codes, group absmaxes, the
   forward's slabs (byte for byte), z, the fold's and the quantizer's
   outputs and the FQT dW equal; res and dx within 2 bf16 ulps; f32 sums
   within 1e-5 (1e-4 over bf16 tensor-core accumulators: the bf16 dW and
   dWp); the forward's z, res and sums bit-equal over two calls. Each is
   timed beside its plain version and cuDNN's bf16 stride-2 3x3 conv plus
   the 1x1 stride-2 projection (forward, input gradient, weight gradient;
   channels-last; the wgrads beside the 3x3's or the 1x1's weight
   gradient alone), the forward's three parts (amax pass, prepass,
   mainloop + sum) apart beside their bounds; the prepass is also a
   kernel row of its own.
16. Training, the eighth main path: the ``-int8`` recipe of phase 7 with
   ``use_lane_transition: True``. With the launch counts zeroed just
   before, each step must launch the transition kernels twice each (the
   two stage transitions), the 22 fused halves' kernels as in phase 7, the stem
   and the augment kernel (LANE_FQT_PER_STEP); in the first step the lane
   run must stay open from the stem to the head (one NHWC -> lane entry at
   the stem, one close before the head, no block converting). Losses
   finite, every parameter changed, every BatchNorm count equal to the
   steps; the first transition half of the first step, on its live inputs
   and cotangents, must reproduce its outputs and equal its plain
   versions. Then the same in QAT with in-kernel dropout, as phase 14
   (``use_int8_train`` and ``use_inkernel_dropout``, 6 steps:
   LANE_QAT_PER_STEP, the 15 halves at C <= 320 seeded as in phase 14; the
   transitions' bits stay drawn, as in the reference), whose transitions'
   dW and dWp run on the TMA wgrad (both runs' dWp do). Both print step
   time, img/s, peak memory and the profile beside phase 7's FQT and phase
   14's QAT step, which differ from them in the one flag.
17. conv3x3_same (``use_pallas_conv``): at the three WRN-28-10 stage shapes
   and ResNet-v1-20's first (C = 16 at 32x32, zero-padded to 32 channels
   for the kernels), batch 128, hold the op's forward and dgrad
   (``conv3x3_bf16``: its prepass's slab byte for byte, then the wgmma
   GEMM, bf16 within 2 ulps, the same bits in two calls, the two parts
   timed apart in device time) and its weight gradient
   (``conv3x3_wgrad``: TMA reads x and dy in place, a shifter warpgroup
   moves x by each tap's column, a wgmma mainloop,
   ops/cuda/csrc/wgrad_wgmma_bf16.cuh, then the ordered sum; HWIO f32
   within 1e-4, the same bits in two calls) against their plain versions
   on the op's own operands, each timed beside its plain version and
   cuDNN's bf16 forward, input gradient and weight gradient
   (channels-last); the wgrad also in device time and TFLOP/s of useful
   work, and the shared-memory route the kernel reads by (x staged
   unswizzled and shifted in shared memory, dy in the 128-byte swizzle:
   the card test ``test_tma_swizzle_probe`` holds both layouts). Then the
   whole op, value and both gradients, against the plain versions of the
   unpadded conv.
18. The int8 1x1 conv (``conv1x1_lanes_requant``,
   ops/cuda/csrc/conv1x1.cu), a tested op no main path runs: at
   ResNet-50's 1x1 shapes at batch 128 (four stages, down and up), in the
   int8-out, bf16-out and bf16 + residual + dual modes, int8 and bf16
   outputs equal to the plain version's, timed beside the plain version,
   ``torch._int_mm`` with the epilogue in torch ops, and cuDNN's bf16 1x1
   conv.
19. Training, the ninth main path: the bf16 recipe of phase 5 with
   ``use_pallas_conv: True``. With the launch counts zeroed just before,
   each step must make 22 conv3x3_same calls, each one forward and one
   dgrad on ``conv3x3_bf16`` (each its prepass and its GEMM) and one wgrad
   with its ordered sum
   (PALLAS_PER_STEP, PALLAS_CALLS_PER_STEP: 8 at C = 160, 7 at 320, 7 at
   640); the first step leaves only the stem, the two stride-2 conv1s and
   the two projections on ``F.conv2d``. The first conv's live forward and
   the dgrad and wgrad of the first conv the backward reaches, on their
   live operands, reproduce their outputs and agree with their plain
   versions (the conv passes' slabs byte for byte). Losses finite, every
   parameter changed, every BatchNorm count equal to the steps; the
   profile files the bf16 conv's kernels under conv3x3_same's forward and
   dgrad; prints the step time, img/s, peak memory and the profile beside
   phase 5's.
20. NV training bf16 bodies: at every geometry and kind of half of phase
   10, with the same non-zero stats cotangents and dx_res, hold the bf16
   forward, dgrad and wgrad of ops/cuda/csrc/bneck_nv_train.cu against
   their plain versions on the same CUDA tensors (the backward on the
   kernel's y): bf16 outputs (y, dx, dres) within 2 bf16 ulps of the
   tensor's largest value, x_res equal, the f32 sums and dW over the
   tensor cores' accumulators within 1e-4 of their largest value (the
   BatchNorm sums also within 1e-5 of the sums of the kernel's own y).
   Each is timed beside its plain version, cuDNN's bf16 forward, input
   gradient and weight gradient (channels-last) and phase 10's int8 kernel
   at the same shape. The input gradient (the prepass rounding the folded
   cotangent once into a bf16 slab, csrc/nv_dgrad_wgmma_bf16.cuh's wgmma
   GEMM at the mirrored taps, the tiles' sum) must give the same bits in
   two calls and its slab must equal its plain version bit for bit; the
   prepass, the GEMM and the sum are timed apart beside their bounds (the
   slab counted as its values, not its pads), and the prepass is a kernel
   row of its own. The weight gradient (csrc/wgrad_staged.cuh's cp.async
   ring after the prepass that rounds its operands once) must give the
   same dW bit for bit in two calls, its prepass must equal its plain
   version, and the prepass and the mainloop + ordered sum are timed
   apart; the prepass is also a kernel row of its own.
21. Training, the tenth main path: the ResNet-50 recipe of phase 11 with
   ``use_int8_train`` alone (QAT), through ``setup(config)``. With the
   launch counts zeroed just before, each step must launch the 30 halves'
   int8 forward (with its row absmax, prepass and sums) and their bf16
   dgrad (its prepass, GEMM and, but for the 3 identity halves, its sum)
   and wgrad (with the wgrad's prepass and both sums; NV_QAT_PER_STEP): no
   cotangent absmax, no int8 dgrad or wgrad, no other port kernel. The
   first half of each kind in the first step, on its live inputs and
   cotangents, must reproduce its outputs and agree with its plain
   versions (phase 20's tolerances for the bf16 backward), the dgrad's
   slab of the live cotangent must equal its plain version bit for bit and
   two dgrad calls must give the same bits. Losses finite, every parameter
   changed, every BatchNorm count equal to the steps. Prints the step
   time, img/s, peak memory and the profile by kind of kernel, the
   halves' per-step time from phases 10 and 20 beside the profiled one,
   and the bf16 dgrad's per-step parts, next to phase 11's FQT and bf16
   runs (not rerun).
22. Print one JSON line of per-kernel numbers, then the result line.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WRN_CONFIG = os.path.join(REPO, "models_dir", "wrn-28-10-dropout_cifar10",
                          "config.yaml")
TRAIN_CONFIG = os.path.join(REPO, "models_dir",
                            "wrn-28-10-dropout_synthspectral-hard",
                            "config.yaml")
FQT_CONFIG = os.path.join(REPO, "models_dir",
                          "wrn-28-10-dropout_synthspectral-hard-int8",
                          "config.yaml")
R50_CONFIG = os.path.join(REPO, "models_dir", "resnet-50_ilsvrc2012",
                          "config.yaml")
BATCH = 128
TRAIN_STEPS, WARM_STEPS, PROFILE_STEPS = 10, 3, 3
AUG_KEYS = ("b", "mirror", "whiten", "ms", "call_ms", "plain_ms",
            "plain_call_ms", "chain_ms", "chain_call_ms", "bound_ms",
            "bound_by", "max_abs_err")
STAGES = [(160, 32, 32), (320, 16, 16), (640, 8, 8)]  # (C, H, W)
SOURCE = "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/conv3x3.cu"
AUG_SOURCE = "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/augment.cu"
FQT_SOURCE = "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/fused_block.cu"
FQT_WGRAD_SOURCE = ("pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/"
                    "fused_wgrad_s8.cu")
STEM_SOURCE = "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/stem.cu"
NV_SOURCE = "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/bneck_nv.cu"
NVT_SOURCE = "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/bneck_nv_train.cu"
# kernels whose code lives in a header of their own
SOURCES = {"nv_half_fwd":
           "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/fwd_staged_s8.cuh",
           "nv_half_dgrad":
           "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/nv_dgrad_wgmma_s8.cuh",
           "nv_half_dgrad_bf16":
           "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/nv_dgrad_wgmma_bf16.cuh",
           "nv_half_wgrad_bf16":
           "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/wgrad_staged.cuh",
           "nv_half_wgrad":
           "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/wgrad_staged_s8.cuh",
           "fused_half_bf16_wgrad":
           "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/wgrad_staged.cuh",
           "fused_half_bf16_fwd":
           "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/fwd_wgmma_bf16.cuh",
           "fused_half_bf16_dgrad":
           "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/dgrad_wgmma_bf16.cuh",
           "fused_half_fwd":
           "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/fused_block.cu",
           "fused_half_dgrad":
           "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/dgrad_wgmma_s8.cuh",
           "fused_half_dgrad.pre":
           "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/fused_half.cuh",
           "fused_half_wgrad": FQT_WGRAD_SOURCE,
           "conv3x3_int8_requant":
           "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/requant_wgmma_s8.cuh",
           "conv3x3_int8_requant.pre":
           "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/fused_half.cuh",
           "conv3x3_bf16":
           "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/conv3x3_wgmma_bf16.cuh",
           "conv3x3_bf16.pre":
           "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/fused_half.cuh"}
BF16_SOURCE = ("pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/"
               "fused_block_bf16.cu")
_PALLAS = "pytorch_ddp_resnet_tpu/ops/pallas/"
REPLACES = {"conv3x3_bf16": _PALLAS + "conv.py:185",
            "conv3x3_bf16.pre": _PALLAS + "conv.py:185",
            "conv3x3_int8_requant": _PALLAS + "conv.py:314",
            "conv3x3_int8_requant.pre": _PALLAS + "conv.py:314",
            "augment_batch": _PALLAS + "augment.py:156",
            "stem_fwd": _PALLAS + "stem.py:119",
            "stem_wgrad": _PALLAS + "stem.py:149",
            "fused_half_fwd": _PALLAS + "fused_block.py:380",
            "fused_half_fwd.pre": _PALLAS + "fused_block.py:380",
            "fused_half_dgrad": _PALLAS + "fused_block.py:588, "
                                + _PALLAS + "fused_block.py:992",
            "fused_half_dgrad.pre": _PALLAS + "fused_block.py:588, "
                                    + _PALLAS + "fused_block.py:992",
            "fused_half_wgrad": _PALLAS + "fused_block.py:763, "
                                + _PALLAS + "fused_block.py:992",
            "bneck_block_nv": _PALLAS + "bneck_nv.py:321",
            "bneck_transition_nv": _PALLAS + "bneck_nv.py:600",
            "nv_half_fwd": _PALLAS + "bneck_nv_train.py:797",
            "nv_half_fwd.pre": _PALLAS + "bneck_nv_train.py:797",
            "nv_half_dgrad": _PALLAS + "bneck_nv_train.py:866",
            "nv_half_dgrad.pre": _PALLAS + "bneck_nv_train.py:866",
            "nv_half_wgrad": _PALLAS + "bneck_nv_train.py:928",
            "nv_half_wgrad.pre": _PALLAS + "bneck_nv_train.py:928",
            "nv_half_fwd_bf16": _PALLAS + "bneck_nv_train.py:797",
            "nv_half_dgrad_bf16": _PALLAS + "bneck_nv_train.py:866",
            "nv_half_dgrad_bf16.pre": _PALLAS + "bneck_nv_train.py:866",
            "nv_half_wgrad_bf16": _PALLAS + "bneck_nv_train.py:928",
            "nv_half_wgrad_bf16.pre": _PALLAS + "bneck_nv_train.py:928",
            "fused_half_bf16_fwd": _PALLAS + "fused_block.py:380",
            "fused_half_bf16_fwd.pre": _PALLAS + "fused_block.py:380",
            "fused_half_bf16_dgrad": _PALLAS + "fused_block.py:588",
            "fused_half_bf16_dgrad.pre": _PALLAS + "fused_block.py:588",
            "fused_half_bf16_wgrad": _PALLAS + "fused_block.py:763",
            "fused_half_bf16_wgrad.pre": _PALLAS + "fused_block.py:763",
            "conv3x3_wgrad": _PALLAS + "conv.py:412",
            "conv1x1_lanes_requant": _PALLAS + "conv1x1.py:158"}
BF16_NAMES = ("fused_half_bf16_fwd", "fused_half_bf16_dgrad",
              "fused_half_bf16_wgrad")
# the int8 serving conv's two kernels by part, for the device-time split
# (its prepass is csrc/fused_half.cuh's slab copy, shared with the FQT
# dgrad's)
REQUANT_KERNELS = {"pre": "slab_copy_kernel", "gemm": "requant_s8_kernel"}
# the bf16 conv's two kernels by part (its prepass: the same slab copy's
# bf16 instantiation; its GEMM on the fused bf16 forward's wgmma mainloop)
BF16_KERNELS = {"pre": "slab_copy_kernel", "gemm": "conv3x3_bf16_kernel"}
# the bf16 conv's launches of one WRN-28-10 calibration batch
CALIB_PER_BATCH = {"conv3x3_bf16.pre": 22, "conv3x3_bf16": 22}
# the int8 serving conv's launches of one WRN-28-10 serving batch
REQUANT_PER_BATCH = {"conv3x3_int8_requant.pre": 22,
                     "conv3x3_int8_requant": 22}
SAME_SOURCE = "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/wgrad_wgmma_bf16.cuh"
# how conv3x3_wgrad's kernel lays its operands in shared memory (its
# header's note; tests/test_torch_cuda_kernels.py test_tma_swizzle_probe)
SAME_WGRAD_ROUTE = {"x": "TMA box of the step's positions, unswizzled, "
                         "then shifted by each tap's column into the "
                         "128-byte-swizzled A tile",
                    "dy": "TMA box of 64 positions in the 128-byte swizzle"}
C1_SOURCE = "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/conv1x1.cu"
# (C, H, W) of conv3x3_same's kernel phase: the WRN-28-10 stages, then
# ResNet-v1-20's first stage (C = 16, zero-padded to 32 for the kernels)
SAME_SHAPES = STAGES + [(16, 32, 32)]
# launches of one use_pallas_conv WRN-28-10 step: 22 conv3x3_same calls
# (the blocks' stride-1 3x3 convs), each a forward and a dgrad on
# conv3x3_bf16 (its prepass and its GEMM) and one wgrad with its ordered
# sum
PALLAS_PER_STEP = {"augment_batch": 1, "conv3x3_bf16.pre": 44,
                   "conv3x3_bf16": 44, "conv3x3_wgrad": 22,
                   "conv3x3_wgrad.sum": 22}
PALLAS_CALLS_PER_STEP = {"forward": 22, "backward": 22}
PALLAS_MIX = {160: 8, 320: 7, 640: 7}  # conv3x3_same calls per step by C
# ResNet-50's 1x1 convs at batch 128 (tools/bench_conv1x1.py "r50"): (h,
# w, block channels, inner width); each runs down (channels -> width) and
# up (width -> channels)
C1_STAGES = [(56, 56, 256, 64), (28, 28, 512, 128), (14, 14, 1024, 256),
             (7, 7, 2048, 512)]
C1_MODES = ("int8", "bf16", "bf16+res+dual")
# launches of one fused-bf16 WRN-28-10 step: the stem, and 8 bf16 halves
# (the 4 identity blocks of stage 1), 4 of them emitting BatchNorm sums;
# each forward is its prepass, the wgmma GEMM and (with sums) the ordered
# sum; each dgrad its prepass, the wgmma GEMM and the ordered sum; each
# wgrad its prepass, the staged mainloop and the ordered sum
FUSED_PER_STEP = {
    "augment_batch": 1, "stem_fwd": 1, "stem_wgrad": 1, "stem_wgrad.sum": 1,
    "fused_half_bf16_fwd.pre": 8, "fused_half_bf16_fwd": 8,
    "fused_half_bf16_fwd.sum": 4,
    "fused_half_bf16_dgrad.pre": 8, "fused_half_bf16_dgrad": 8,
    "fused_half_bf16_dgrad.sum": 8,
    "fused_half_bf16_wgrad.pre": 8, "fused_half_bf16_wgrad": 8,
    "fused_half_bf16_wgrad.sum": 8}
# launches of one QAT step: 22 halves on the int8 forward and the bf16
# backward; with in-kernel dropout the 15 halves at C = 160 and 320 rebuild
# their masks from a seed (QAT_SEED_PER_STEP; in the dgrad its GEMM's
# epilogue does, its prepass writes g, which no mask touches; in the wgrad
# its prepass does, and the mainloop reads the rounded d_b)
QAT_PER_STEP = {
    "augment_batch": 1, "stem_fwd": 1, "stem_wgrad": 1, "stem_wgrad.sum": 1,
    "fused_half_fwd.amax": 22, "fused_half_fwd.pre": 22,
    "fused_half_fwd": 22, "fused_half_fwd.sum": 10,
    "fused_half_bf16_dgrad.pre": 22, "fused_half_bf16_dgrad": 22,
    "fused_half_bf16_dgrad.sum": 22,
    "fused_half_bf16_wgrad.pre": 22, "fused_half_bf16_wgrad": 22,
    "fused_half_bf16_wgrad.sum": 22}
QAT_SEED_PER_STEP = {"fused_half_fwd.amax": 15, "fused_half_fwd.pre": 15,
                     "fused_half_bf16_dgrad": 15,
                     "fused_half_bf16_wgrad.pre": 15}
# (kind, h, w, cin, width, cout, stride) at batch 128: the ResNet-50
# stages, then WRN-50-2's stage 4 (its widest operands)
NV_SHAPES = [("identity", 56, 56, 256, 64, 256, 1),
             ("identity", 28, 28, 512, 128, 512, 1),
             ("identity", 14, 14, 1024, 256, 1024, 1),
             ("identity", 7, 7, 2048, 512, 2048, 1),
             ("transition", 56, 56, 64, 64, 256, 1),
             ("transition", 56, 56, 256, 128, 512, 2),
             ("transition", 28, 28, 512, 256, 1024, 2),
             ("transition", 14, 14, 1024, 512, 2048, 2),
             ("identity", 7, 7, 2048, 1024, 2048, 1),
             ("transition", 14, 14, 1024, 1024, 2048, 2)]
NV_NAMES = ("bneck_block_nv", "bneck_transition_nv")
# the identity block's three kernels by part (csrc/bneck_nv.cu, namespace
# bneck_wgmma), for the device-time split
NV_ID_PARTS = {"conv1": "bneck_wgmma::conv1_kernel",
               "conv2": "bneck_wgmma::conv2_kernel",
               "out": "bneck_wgmma::out_kernel"}
# the transition's (conv1 is conv1_kernel at stride 1, conv1_planes_kernel
# at stride 2)
NV_TR_PARTS = {"conv1": "bneck_wgmma::conv1",
               "conv2": "bneck_wgmma::conv2_kernel",
               "out": "bneck_wgmma::out_proj_kernel"}
NV_TR_DESIGN = ("conv1 writes a1 into the padded slab, at stride 2 into four "
                "parity planes of serve_slab_layout at the output size (every "
                "pad byte zero in the same launch) and copies x[:, ::2, ::2] "
                "for the projection; conv2 at nine plane row offsets and the "
                "output (conv3 and the projection as two mainloops on one "
                "ring, BN 64) on fwd_wgmma_s8.cuh's TMA-fed s8 wgmma "
                "mainloop; 16-byte NHWC epilogues")
NV_ID_DESIGN = ("conv1 writes a1 straight into the padded slab "
                "(serve_slab_layout, every pad byte zero in the same launch); "
                "conv2 at nine slab row offsets and the output on "
                "fwd_wgmma_s8.cuh's TMA-fed s8 wgmma mainloop; 16-byte NHWC "
                "epilogues")
# ResNet-50: 12 identity and 4 transition blocks per serving batch
NV_PER_BATCH = {"bneck_block_nv": 12, "bneck_transition_nv": 4}
# (batch, h, w, cin, width, cout): the identity bottleneck blocks of
# ResNet-50 that the NV training gate admits, stages 1-3 at batch 128 (the
# main path's) and stage 4 at batch 64 (the largest batch it admits there)
NVT_GEOMETRIES = [(128, 56, 56, 256, 64, 256), (128, 28, 28, 512, 128, 512),
                  (128, 14, 14, 1024, 256, 1024), (64, 7, 7, 2048, 512, 2048)]
NVT_NAMES = ("nv_half_fwd", "nv_half_dgrad", "nv_half_wgrad")
# launches of one ResNet-50 FQT train step at batch 128: 30 NV halves (3
# identity-mode conv1, 7 entry-mode conv1, 10 conv2, 10 conv3), each one
# forward, one dgrad and one wgrad; identity-mode dgrads have no d(s)/d(t);
# the forward's, the dgrad's and the wgrad's prepasses write their int8
# slabs once
NVT_HALVES_PER_STEP = {("1x1", "identity"): 3, ("1x1", "entry"): 7,
                       ("3x3", "affine"): 10, ("1x1", "affine"): 10}
NV_TRAIN_PER_STEP = {
    "nv_half_fwd.amax": 30, "nv_half_fwd.pre": 30, "nv_half_fwd": 30,
    "nv_half_fwd.sum": 30,
    "nv_half_bwd.amax": 30, "nv_half_dgrad.pre": 30, "nv_half_dgrad": 30,
    "nv_half_dgrad.sum": 27,
    "nv_half_wgrad.pre": 30, "nv_half_wgrad": 30, "nv_half_wgrad.sum": 30}
NVT_BF16_NAMES = ("nv_half_fwd_bf16", "nv_half_dgrad_bf16",
                  "nv_half_wgrad_bf16")
# launches of one ResNet-50 QAT train step at batch 128: the same 30 halves
# on the int8 forward (with its row absmax and its prepass) and the bf16
# dgrad and wgrad, which need no absmax of the cotangent; the dgrad's
# prepass rounds the folded cotangent once into its slab, the wgrad's its
# operands; identity-mode dgrads have no sum
NV_QAT_PER_STEP = {
    "nv_half_fwd.amax": 30, "nv_half_fwd.pre": 30, "nv_half_fwd": 30,
    "nv_half_fwd.sum": 30,
    "nv_half_dgrad_bf16.pre": 30, "nv_half_dgrad_bf16": 30,
    "nv_half_dgrad_bf16.sum": 27,
    "nv_half_wgrad_bf16.pre": 30, "nv_half_wgrad_bf16": 30,
    "nv_half_wgrad_bf16.sum": 30}
# launches of one WRN-28-10 FQT train step: 22 fused halves, 10 of them
# emitting BatchNorm sums (conv1 of the 10 identity blocks); the int8
# wgrad's plan splits the scale groups of the 15 halves at C = 160 and 320
# (a sum over their slots each) and folds them in the block at C = 640
# (FQT_WGRAD_SPLIT; phase 6 asserts the plan agrees)
FQT_WGRAD_SPLIT = {160: True, 320: True, 640: False}
FQT_PER_STEP = {
    "augment_batch": 1, "stem_fwd": 1, "stem_wgrad": 1, "stem_wgrad.sum": 1,
    "fused_half_fwd.amax": 22, "fused_half_fwd.pre": 22,
    "fused_half_fwd": 22, "fused_half_fwd.sum": 10,
    "fused_half_bwd.amax": 22, "fused_half_bwd.quant": 22,
    "fused_half_dgrad.pre": 22, "fused_half_dgrad": 22,
    "fused_half_dgrad.sum": 22,
    "fused_half_wgrad": 22, "fused_half_wgrad.sum": 15}
# launches of one lane-transition step: the 22 halves as above, plus the
# two transition halves (each one forward: its amax pass, prepass, staged
# mainloop and ordered sum; one backward fold or quantizer, dgrad, wgrad
# and dWp, with their ordered sums: the dgrad's prepass into its slabs,
# its wgmma GEMM and its tiles' sum; the FQT wgrad on the TMA + s8 wgmma
# kernel, one launch and no sum; the straight-through one and dWp on the
# TMA wgrad)
_TR_STEP = {"transition_fwd.amax": 2, "transition_fwd.pre": 2,
            "transition_fwd": 2, "transition_fwd.sum": 2,
            "transition_dgrad.pre": 2, "transition_dgrad": 2,
            "transition_dgrad.sum": 2,
            "transition_wgrad_tma.proj": 2,
            "transition_wgrad_tma.proj_sum": 2}
LANE_FQT_PER_STEP = {
    **FQT_PER_STEP, **_TR_STEP, "transition_bwd.quant": 2,
    "transition_wgrad_s8": 2}
LANE_QAT_PER_STEP = {
    **QAT_PER_STEP, **_TR_STEP, "transition_bwd.fold": 2,
    "transition_wgrad_tma": 2, "transition_wgrad_tma.sum": 2}
LANE_QAT_STEPS = 6
F32_SUMS = ("ysum", "yssq", "zsum", "zssq", "ds", "dt", "db", "dw_stem")
# dense peak rates (bf16 FLOP/s, int8 OP/s, memory B/s, f32 FLOP/s outside
# the tensor cores), NVIDIA data sheets
PEAKS = {"SXM": (989e12, 1979e12, 3.35e12, 67e12),
         "PCIe": (756e12, 1513e12, 2.0e12, 51e12),
         "NVL": (835e12, 1671e12, 3.9e12, 60e12)}


def ptxas_entries(log: str, pattern: str):
    """nvcc -Xptxas -v's report of each entry function whose name holds
    ``pattern``: (mangled name, registers, static shared bytes, spill
    stores + loads in bytes)."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = dict(name=name, registers=None, smem=0, spill_bytes=0)
            if pattern in name:
                out.append(cur)
        elif cur is not None and "spill stores" in line:
            words = line.replace(",", "").split()
            cur["spill_bytes"] = (int(words[words.index("spill") - 2])
                                  + int(words[-4]))
        elif cur is not None and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            cur["registers"] = int(words[words.index("registers") - 1])
            if "smem" in words:
                cur["smem"] = int(words[words.index("smem") - 2])
            cur = None  # the entry's report ends with its registers
    return out


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _dev_us(event) -> float:
    """Self device time of a profiler event, in us (the attribute's name
    changed across torch versions)."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def _cuda_events(prof):
    return [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and _dev_us(e) > 0]


def kernel_split_ms(fn, reps: int, keys, need=(), tries: int = 3):
    """Device time per call of ``fn`` by kernel: {key: ms} summed over the
    kernels whose name holds ``key`` (torch.profiler, ``reps`` calls after
    one warm-up call). The profiler can lose a kernel's events in a
    window, so a window with no device time, or none for a key of ``need``
    (kernels that every call launches), is profiled again, up to ``tries``
    windows. None when the profiler reports no device time, or still
    misses a kernel of ``need``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {key: 0.0 for key in keys}
        for e in _cuda_events(prof):
            for key in keys:
                if key in e.key:
                    out[key] += _dev_us(e) / 1e3 / reps
        if any(out.values()) and all(out[key] > 0 for key in need):
            return out
        missing = [key for key in need if not out[key]] or "any kernel"
        print(f"kernel_split_ms: profiler window {attempt} of {tries} held "
              f"no device time for {missing}", file=sys.stderr)
    return None


def device_ms(fn, reps: int):
    """Mean device time per call of ``fn``: the summed device time of every
    kernel it launches (``kernel_split_ms`` over all kernels). None when
    the profiler reports no device time."""
    split = kernel_split_ms(fn, reps, ("",))
    return split[""] if split else None


def port_modules():
    """The port's kernel modules, each with its own launch counter."""
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import (
        augment,
        bneck_nv,
        bneck_nv_train,
        conv1x1,
        conv3x3,
        fused_block,
        stem,
        transition,
    )

    return (augment, bneck_nv, bneck_nv_train, conv1x1, conv3x3,
            fused_block, stem, transition)


def reset_launches() -> None:
    for mod in port_modules():
        mod.reset_launches()


def all_launches() -> dict:
    out = {}
    for mod in port_modules():
        out.update({k: v for k, v in mod.launches.items() if v})
    return out


def bf16_ulp(ref):
    import torch

    mag = ref.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# --- phase 3: kernels ---------------------------------------------------------

def kernel_phase(peaks):
    """Per (kernel, stage, mode): max error against the plain version and
    the kernel / plain / cuDNN / bound times of one launch."""
    import torch
    import torch.nn.functional as F

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k

    flops_bf16, ops_int8, bw, _ = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for c, h, w in STAGES:
        n = BATCH * h * w
        macs = 9 * c * c * n

        def cudnn_ms():
            x4 = torch.randn(BATCH, c, h, w, device=dev, generator=g,
                             dtype=torch.bfloat16).to(
                memory_format=torch.channels_last)
            w4 = torch.randn(c, c, 3, 3, device=dev, generator=g,
                             dtype=torch.bfloat16).to(
                memory_format=torch.channels_last)
            return time_ms(lambda: F.conv2d(x4, w4, padding=1), 20)

        lib_ms = cudnn_ms()

        # bf16 conv: bf16 in, f32 accumulate, bf16 out; the op (its
        # prepass, then its wgmma GEMM) against the plain version, two
        # calls bit-equal, the prepass's slab byte for byte; each part
        # timed apart (CUDA events) and in device time
        x = torch.randn(c, n, device=dev, generator=g).to(torch.bfloat16)
        wp = (torch.randn(c, 9 * c, device=dev, generator=g)
              / (9 * c) ** 0.5).to(torch.bfloat16)
        lay = k.conv3x3_bf16_plan(n, h, w, c, c)

        def run_bf16():
            return k.conv3x3_bf16(x, wp, h=h, w_img=w)

        got = run_bf16()
        assert torch.equal(got, run_bf16()), (c, "bf16 two calls")
        ref = k.conv3x3_bf16_plain(x, wp, h=h, w_img=w)
        _bf16_err(got, ref, ("conv3x3_bf16", c))
        slab16 = k.conv3x3_bf16_pre(x, lay=lay)
        assert torch.equal(slab16, k.conv3x3_bf16_pre_plain(x, lay=lay)), \
            ("conv3x3_bf16.pre", c)
        assert torch.equal(k.conv3x3_bf16_gemm(slab16, wp, lay=lay), got)
        got, ref = got.float(), ref.float()
        d = (got - ref).abs()
        beyond = (d > bf16_ulp(ref)).float().mean().item()
        assert beyond <= 1e-3, (c, beyond, d.max().item())
        byts = 2 * (2 * c * n + 9 * c * c)
        split = kernel_split_ms(run_bf16, 5, BF16_KERNELS.values(),
                                need=BF16_KERNELS.values())
        rows.append(dict(
            name="conv3x3_bf16", c=c, h=h, w=w, n=n, mode="bf16",
            max_abs_err=d.max().item(), share_beyond_1ulp=beyond,
            bn=lay.bn, tiles=lay.tiles, ms=time_ms(run_bf16, 20),
            gemm_ms=time_ms(
                lambda: k.conv3x3_bf16_gemm(slab16, wp, lay=lay), 20),
            **{f"{part}_dev_ms": (split[key] if split else None)
               for part, key in BF16_KERNELS.items()},
            dev_ms=(sum(split.values()) if split else None),
            plain_ms=time_ms(
                lambda: k.conv3x3_bf16_plain(x, wp, h=h, w_img=w), 3),
            library_ms=lib_ms,
            ops_ms=2 * macs / flops_bf16 * 1e3, bytes_ms=byts / bw * 1e3))
        # its prepass: bound by its bytes (x read, the slab written)
        rows.append(dict(
            name="conv3x3_bf16.pre", c=c, h=h, w=w, n=n, mode="",
            max_abs_err=0.0, bn=lay.bn, tiles=lay.tiles,
            ms=time_ms(lambda: k.conv3x3_bf16_pre(x, lay=lay), 20),
            plain_ms=time_ms(
                lambda: k.conv3x3_bf16_pre_plain(x, lay=lay), 3),
            library_ms=None, ops_ms=0.0,
            bytes_ms=2 * (c * n + lay.slab_len * c) / bw * 1e3))
        del slab16

        # int8 conv + requant epilogue, every mode: the op (its prepass,
        # then its GEMM) against the plain version, two calls bit-equal;
        # each part timed apart (CUDA events) and in device time
        xq = torch.randint(-127, 128, (c, n), device=dev, generator=g,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (c, 9 * c), device=dev, generator=g,
                           dtype=torch.int8)
        sigma = (127.0 ** 2 / 3) * (9 * c) ** 0.5  # std of the s32 sums

        def vec(lo, hi):
            return torch.rand(c, device=dev, generator=g) * (hi - lo) + lo

        scale = vec(0.5, 1.5) / sigma
        shift = vec(-0.5, 0.5)
        res = torch.randn(c, n, device=dev, generator=g).to(torch.bfloat16)
        dual = (vec(0.5, 1.5) * 127 / 4, vec(-5.0, 5.0))
        modes = {
            "int8": ((None, None), dict(relu=True, inv_out_scale=127 / 4)),
            "bf16": ((None, None), dict(relu=True)),
            "bf16+res": ((res, None), dict(relu=False)),
            "bf16+res+dual": ((res, dual), dict(relu=False)),
        }
        plan = k.requant_plan(n, h, w, c, c)
        slab = k.conv3x3_int8_requant_pre(xq, plan=plan)
        assert torch.equal(slab, k.conv3x3_int8_requant_pre_plain(
            xq, plan=plan)), ("conv3x3_int8_requant.pre", c)
        slab_b = plan.lay.slab_len * c
        # the prepass: bound by its bytes (x_q read, the slab written)
        rows.append(dict(
            name="conv3x3_int8_requant.pre", c=c, h=h, w=w, n=n, mode="",
            max_abs_err=0.0, bn=plan.bn, tiles=plan.lay.tiles,
            ms=time_ms(lambda: k.conv3x3_int8_requant_pre(xq, plan=plan),
                       20),
            plain_ms=time_ms(
                lambda: k.conv3x3_int8_requant_pre_plain(xq, plan=plan), 3),
            library_ms=None, ops_ms=0.0, bytes_ms=(c * n + slab_b) / bw * 1e3))
        for mode, ((r, du), kw) in modes.items():
            def run(fn=k.conv3x3_int8_requant):
                return fn(xq, wq, scale, shift, r, du, h=h, w_img=w, **kw)

            def gemm():
                return k.conv3x3_int8_requant_gemm(slab, wq, scale, shift, r,
                                                   du, plan=plan, **kw)

            outs = run()
            refs = run(k.conv3x3_int8_requant_plain)
            outs = outs if isinstance(outs, tuple) else (outs,)
            refs = refs if isinstance(refs, tuple) else (refs,)
            again = run()
            again = again if isinstance(again, tuple) else (again,)
            # the GEMM on the checked slab: the op's outputs bit for bit
            parts = gemm()
            parts = parts if isinstance(parts, tuple) else (parts,)
            err = 0.0
            for o, rf, o2, og in zip(outs, refs, again, parts):
                assert o.dtype == rf.dtype and o.shape == rf.shape
                assert torch.equal(o, o2), (c, mode, "two calls")
                assert torch.equal(o, og), (c, mode, "the GEMM alone")
                d = (o.float() - rf.float()).abs()
                if o.dtype == torch.int8:
                    flips = (d > 0).float().mean().item()
                    assert d.max().item() <= 1 and flips <= 1e-3, \
                        (c, mode, d.max().item(), flips)
                    assert rf.unique().numel() > 50, (c, mode)
                else:
                    assert torch.equal(o, rf), (c, mode, d.max().item())
                err = max(err, d.max().item())
            byts = (c * n + 9 * c * c + 4 * c * (4 if du else 2)
                    + c * n * (1 if "int8" in mode else 2)
                    + (2 * c * n if r is not None else 0)
                    + (c * n if du else 0))
            split = kernel_split_ms(run, 5, REQUANT_KERNELS.values(),
                                    need=REQUANT_KERNELS.values())
            rows.append(dict(
                name="conv3x3_int8_requant", c=c, h=h, w=w, n=n, mode=mode,
                max_abs_err=err, ms=time_ms(run, 20),
                gemm_ms=time_ms(gemm, 20),
                **{f"{part}_dev_ms": (split[key] if split else None)
                   for part, key in REQUANT_KERNELS.items()},
                dev_ms=(sum(split.values()) if split else None),
                plain_ms=time_ms(
                    lambda: run(k.conv3x3_int8_requant_plain), 3),
                library_ms=lib_ms,
                ops_ms=2 * macs / ops_int8 * 1e3, bytes_ms=byts / bw * 1e3))
        del x, xq, wq, res, slab
        torch.cuda.empty_cache()
    for r in rows:
        r["bound_ms"] = max(r["ops_ms"], r["bytes_ms"])
        r["bound_by"] = ("operations" if r["ops_ms"] >= r["bytes_ms"]
                         else "bytes")
    return rows


def augment_phase(peaks):
    """Per (batch, padding, whitening): the augment kernel against its plain
    version (bit-equal) and against the port's torch transform chain with
    the same draws, and the kernel / plain / chain / bound times."""
    import numpy as np
    import torch

    from pytorch_ddp_resnet_tpu_torch.data import transforms as T
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import augment as aug

    _, _, bw, flops_f32 = peaks
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n, hw, c, pad, crop = 50000, 32, 3, 4, 32  # the recipe's geometry
    shape = (hw, hw, c)
    data = torch.from_numpy(rng.integers(0, 256, (n,) + shape,
                                         dtype=np.uint8)).to(dev)
    stats = (rng.uniform(0.3, 0.7, shape).astype(np.float32),
             rng.uniform(0.2, 0.3, shape).astype(np.float32))
    rows = []
    for b in (BATCH, 4 * BATCH):
        idx, top, left, flip = (torch.from_numpy(v.astype(np.int32)).to(dev)
                                for v in (rng.integers(0, n, b),
                                          rng.integers(0, 2 * pad + 1, b),
                                          rng.integers(0, 2 * pad + 1, b),
                                          rng.integers(0, 2, b)))
        for mirror in (True, False):
            for whiten in (True, False):
                mean, std = stats if whiten else (
                    np.zeros(shape, np.float32), np.ones(shape, np.float32))
                mean_t = torch.from_numpy(mean).to(dev)
                inv_t = torch.from_numpy(np.float32(1.0) / std).to(dev)
                args = (data, idx, top, left, flip, mean_t, inv_t)
                kw = dict(pad=pad, crop=crop, mirror=mirror)
                got = aug.augment_batch(*args, **kw)
                ref = aug.augment_batch_plain(*args, **kw)
                assert torch.equal(got, ref), (b, mirror, whiten)

                st = T.StandardizeWhiteningTransform(shape)
                st.mean = mean_t
                st.stddev = torch.from_numpy(std).to(dev)
                st.fitted = True
                steps = [T.ToTensorTransform(shape)] + (
                    [st] if whiten else [])
                flip_t = T.FlipTransform(shape, 0.5)
                pad_t = T.PaddingTransform(shape, pad,
                                           "mirror" if mirror else "zero")
                crop_t = T.RandomCropTransform(pad_t.output_shape, crop)

                def chain():  # the transform chain with the same draws
                    x = data[idx.long()]
                    for t in steps:
                        x = t.apply_batch(x)
                    x = pad_t.apply_batch(flip_t.apply_batch(x, flip=flip))
                    return crop_t.apply_batch(x, tops=top, lefts=left)

                # the chain divides by the stddev where the kernel
                # multiplies by its reciprocal: one bf16 rounding apart
                ch = chain()
                chain_err = (ch - got.float()).abs().max().item()
                assert chain_err <= 2.0 ** -7 * ch.abs().max().item(), \
                    (b, mirror, whiten, chain_err)
                byts = (b * hw * hw * c + 2 * 4 * hw * hw * c + 4 * 4 * b
                        + 2 * b * crop * crop * c)
                fns = {"": lambda: aug.augment_batch(*args, **kw),
                       "plain_": lambda: aug.augment_batch_plain(*args,
                                                                 **kw),
                       "chain_": chain}
                row = dict(
                    name="augment_batch", b=b, mirror=mirror, whiten=whiten,
                    max_abs_err=(got.float() - ref.float()).abs().max()
                    .item(),
                    chain_max_abs_diff=chain_err,
                    bytes_ms=byts / bw * 1e3,
                    ops_ms=2 * b * crop * crop * c / flops_f32 * 1e3)
                for pre, fn in fns.items():
                    # device time of the kernels a call launches, and the
                    # time per call of back-to-back calls (CUDA events),
                    # which the host's dispatch bounds at this size
                    row[f"{pre}call_ms"] = time_ms(fn, 50)
                    row[f"{pre}ms"] = device_ms(fn, 20)
                rows.append(row)
    for r in rows:
        r["bound_ms"] = max(r["ops_ms"], r["bytes_ms"])
        r["bound_by"] = ("operations" if r["ops_ms"] >= r["bytes_ms"]
                         else "bytes")
    return rows


# --- phase 4: serving -----------------------------------------------------------

def write_run(workdir: str, run_name: str, recipe: str, **overrides):
    """A run directory under ``workdir`` holding a copy of ``recipe`` with
    ``overrides``, read back as the port reads a run. The keys keep their
    order: a transform pipeline is an ordered mapping."""
    import yaml

    from pytorch_ddp_resnet_tpu_torch.utils.config import get_config

    with open(recipe) as f:
        cfg = yaml.safe_load(f)
    cfg.update(overrides)
    run = os.path.join(workdir, "models_dir", run_name)
    os.makedirs(run)
    with open(os.path.join(run, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return get_config(os.path.join(workdir, "models_dir"), run_name,
                      data_dir=os.path.join(workdir, "data"), verbose=False)


def serving_phase(workdir):
    import numpy as np
    import torch

    from pytorch_ddp_resnet_tpu_torch.algos.predict import load_predictor
    from pytorch_ddp_resnet_tpu_torch.data.datasets import load_synthetic
    from pytorch_ddp_resnet_tpu_torch.models.quantize import Int8Inference
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3

    # CIFAR is not on the machine
    config = write_run(workdir, "wrn-28-10", WRN_CONFIG,
                       dataset_cls_name="Synthetic")
    assert config["batch_size"] == BATCH
    test_x = load_synthetic(None, train=False).x  # 256 images
    calib = load_synthetic(None, train=True).x    # 512, as load_predictor
    requests = [test_x[:128], test_x[:200], test_x[200:237]]  # 2 ragged
    n_serve = sum(-(-len(r) // BATCH) for r in requests)
    n_calib = -(-len(calib) // BATCH)

    # the main path, with the launch counts zeroed just before
    reset_launches()
    t0 = time.perf_counter()
    fp = load_predictor(config)
    fl = [fp.logits(r) for r in requests]
    qp = load_predictor(config, quantize="int8")
    ql = [qp.logits(r) for r in requests]
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = all_launches()
    shapes = dict(conv3x3.launch_shapes)

    assert qp.n_quantized == 22, qp.n_quantized
    assert set(launches) == set(CALIB_PER_BATCH) | set(REQUANT_PER_BATCH), \
        launches
    for name, per in CALIB_PER_BATCH.items():
        assert launches.get(name) == per * n_calib, launches
    for name, per in REQUANT_PER_BATCH.items():
        assert launches.get(name) == per * n_serve, launches
    for a, b, r in zip(fl, ql, requests):
        assert a.shape == b.shape == (len(r), 10)
        assert np.isfinite(a).all() and np.isfinite(b).all()

    # the same int8 walk through the plain versions, same scales: the
    # int8 codes agree up to rare 1-level tie flips (kernel phase), so the
    # logits may move by a small fraction of their range
    xp = qp._prep(test_x[:BATCH])
    with torch.no_grad():
        q_kernel = qp._fwd(xp).float()
        q_plain = Int8Inference(qp._model, plain=True).serve_fn(
            qp.act_scales)(xp).float()
        # the float walk through the bf16 kernel vs the float model (cuDNN)
        f_kernel, _ = Int8Inference(qp._model).calibrate_fn()(xp)
        f_model = qp._model(xp).float()
    int8_err = (q_kernel - q_plain).abs().max().item()
    float_err = (f_kernel.float() - f_model).abs().max().item()
    assert int8_err <= 1e-2 * q_plain.abs().max().item(), int8_err
    assert float_err <= 5e-2 * f_model.abs().max().item() + 2e-2, float_err

    all_f = fp.logits(test_x)
    all_q = qp.logits(test_x)
    agree = float((all_f.argmax(-1) == all_q.argmax(-1)).mean())

    bench = np.concatenate([test_x] * 4)  # 1024 images, 8 batches

    def img_per_s(pred):
        pred.logits(bench[:BATCH])  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred.logits(bench)
        return len(bench) / (time.perf_counter() - t)

    return dict(
        launches=launches, shapes=shapes, n_calib=n_calib, n_serve=n_serve,
        main_path_s=main_s, int8_vs_plain_max_abs=int8_err,
        float_walk_vs_model_max_abs=float_err, top1_agreement=agree,
        logit_absmax=float(np.abs(all_f).max()),
        float_img_per_s=img_per_s(fp), int8_img_per_s=img_per_s(qp),
        n_folded=fp.n_folded)


# --- phase 5: training ------------------------------------------------------

# kernel-name patterns of the train step's kinds of device work
KERNEL_KINDS = [
    # the bf16 conv's GEMM (its argument type is the fused bf16 forward's)
    # and the bf16 instantiation of the slab copy (the int8 one is the
    # fused int8 half's), first
    ("conv3x3_same fwd + dgrad (port)", ("conv3x3_bf16_kernel",
                                         "slab_copy_kernel<__nv_bfloat16>")),
    ("augment", ("augment",)),
    ("bneck nv (port)", ("bneck_wgmma",)),
    # (the int8 dgrad's tile sum is common::tile_sum under its own tag)
    ("nv train halves (port)", ("nvt_", "NvtDgradSum", "wgrad_staged",
                                "fwd_staged")),
    ("stem (port)", ("stem_", "StemWgradSum")),
    # the lane transition's TMA wgrads (the bf16 one shares
    # conv3x3_same's mainloop): their instantiations and the sum carry the
    # transition's tag
    ("transition (port)", ("TransitionWgrad", "TransitionDgradSum")),
    ("conv3x3_same wgrad (port)", ("wgrad_tma_kernel", "WgradTmaSum")),
    ("fused bf16 half (port)", ("fused_fwd_", "fused_dgrad_",
                                "FusedDgrad", "fused_wgrad_pre")),
    ("transition (port)", ("fwd_pre_kernel", "fwd_gemm_kernel",
                           "dgrad_kernel<", "dgrad_pre_kernel",
                           "bwd_quant_kernel", "bwd_fold_kernel")),
    # the FQT dgrad's prepass (csrc/fused_half.cuh's slab copy, which the
    # int8 serving conv also launches) and GEMM
    ("fused int8 half (port)", ("amax_kernel", "quant_kernel",
                                "FusedWgradS8", "partial_sum",
                                "fwd_slab_kernel", "fwd_s8_kernel",
                                "slab_copy_kernel", "dgrad_s8_kernel",
                                "tile_sum_kernel")),
    ("conv (cuDNN)", ("xmma", "cudnn", "conv", "implicit_gemm")),
    ("matmul", ("gemm", "cublas")),
    ("reduction", ("reduce_kernel",)),
    ("optimizer", ("multi_tensor", "foreach")),
    ("copy / cast", ("copy",)),
    ("elementwise", ("elementwise", "Functor")),
]
# the WRN-28-10 steps run no NV half: there the staged bf16 wgrad mainloop
# and its sum (csrc/wgrad_staged.cuh, shared with the NV halves) are the
# fused bf16 half's
WRN_KERNEL_KINDS = [
    (kind, pats + ("wgrad_staged",) if kind == "fused bf16 half (port)"
     else pats) for kind, pats in KERNEL_KINDS
    if kind != "nv train halves (port)"]


def kernel_kind(name: str, kinds=KERNEL_KINDS) -> str:
    """The kind of a kernel by its (demangled) name: the first kind one of
    whose patterns the name holds, else "other"."""
    return next((k for k, pats in kinds if any(p in name for p in pats)),
                "other")


def _profile_steps(run_steps, steps: int, kinds=KERNEL_KINDS):
    """Device time per step by kind of kernel (``kinds``: name patterns)
    over ``run_steps()`` (torch.profiler), or None when the profiler
    reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_steps()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = _cuda_events(prof)
    if not events:
        return None
    dev_ms = sum(_dev_us(e) for e in events) / 1e3
    by_kind = {}
    for e in events:
        kind = kernel_kind(e.key, kinds)
        by_kind[kind] = by_kind.get(kind, 0.0) + _dev_us(e) / 1e3 / steps
    top = sorted(events, key=lambda e: -_dev_us(e))[:12]
    host = sorted((e for e in prof.key_averages()
                   if e.device_type.name == "CPU"),
                  key=lambda e: -e.self_cpu_time_total)[:12]
    return dict(
        host_top=[dict(op=e.key[:60], self_ms=e.self_cpu_time_total / 1e3
                       / steps, calls=e.count / steps) for e in host],
        steps=steps, wall_ms_per_step=wall_ms / steps,
        device_ms_per_step=dev_ms / steps, busy_share=dev_ms / wall_ms,
        kernels_per_step=sum(e.count for e in events) / steps,
        device_ms_per_step_by_kind=dict(
            sorted(by_kind.items(), key=lambda kv: -kv[1])),
        top=[dict(kernel=e.key[:80], ms=_dev_us(e) / 1e3, calls=e.count)
             for e in top])


def training_phase(workdir, aug_rows, recipe=TRAIN_CONFIG,
                   run_name="wrn-28-10-train", per_step=None,
                   first_step=None, seed_per_step=None, steps=TRAIN_STEPS,
                   calls_per_step=None, **overrides):
    """Train the full-width recipe (with the config ``overrides``) for
    ``steps`` steps through setup and the train step. ``per_step``: the
    launches each step must make (default the augment kernel only);
    ``seed_per_step``: those of them that must rebuild their dropout masks
    from a seed (default none); ``calls_per_step``: the conv3x3_same
    passes each step must make (default none); ``first_step``: a context
    manager wrapped around the first step (phases 7, 13, 14, 16 and 19
    record there)."""
    import contextlib
    import math

    import torch

    from pytorch_ddp_resnet_tpu_torch.algos.steps import make_train_step
    from pytorch_ddp_resnet_tpu_torch.algos.train import setup
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import augment
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
    from pytorch_ddp_resnet_tpu_torch.utils.rng import Key

    per_step = per_step or {"augment_batch": 1}
    config = write_run(workdir, run_name, recipe, use_pallas_augment=True,
                       **overrides)
    assert config["batch_size"] == BATCH

    t0 = time.perf_counter()
    ls = setup(config, verbose=False)
    setup_s = time.perf_counter() - t0
    model, pipeline, ts = ls["model"], ls["pipeline"], ls["train_state"]
    fused = ls["augment_fn"]
    assert isinstance(fused, augment.FusedAugment), type(fused)
    assert ls["augment_pass_indices"]
    assert model.param_count() == 36688330, model.param_count()
    step = pipeline.bind_train_step(
        make_train_step(model, ls["optimizer"], ls["num_microbatches"],
                        augment_fn=fused),
        pass_indices=True)
    root = Key(config.get("seed", 0))
    feeds = [idx for _, (idx,) in pipeline.train_feed(
        0, budget=steps + PROFILE_STEPS)]
    lr = ls["scheduler"].get_lr()
    before = {k: v.detach().clone() for k, v in ts["params"].items()}
    torch.cuda.reset_peak_memory_stats()

    # the main path, with the launch counts zeroed just before
    reset_launches()
    metrics = []
    for gs in range(WARM_STEPS):
        with (first_step if gs == 0 and first_step is not None
              else contextlib.nullcontext()):
            ts, m = step(ts, feeds[gs], lr, root.fold_in(gs))
        metrics.append(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for gs in range(WARM_STEPS, steps):
        ts, m = step(ts, feeds[gs], lr, root.fold_in(gs))
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (steps - WARM_STEPS)
    launches = all_launches()
    seeded = dict(fb.seed_launches)
    same_calls = dict(conv3x3.same_calls)
    peak_mem = torch.cuda.max_memory_allocated() / 2 ** 30

    losses = [float(m["loss"]) for m in metrics]
    assert launches == {k: v * steps for k, v in per_step.items()}, \
        launches
    assert seeded == {k: v * steps
                      for k, v in (seed_per_step or {}).items()}, seeded
    assert same_calls == {k: v * steps
                          for k, v in (calls_per_step or {}).items()}, \
        same_calls
    assert all(math.isfinite(v) for v in losses), losses
    for k, v in ts["params"].items():
        assert not torch.equal(v, before[k]), f"{k} did not change"
    counts = {int(b) for n, b in ts["model_state"].items()
              if n.endswith("count")}
    assert counts == {steps}, counts

    # the first step's augmented batch, kernel vs plain, same draws
    key = root.fold_in(0).fold_in(0)  # the step's augment key (M = 1)
    batch = fused(feeds[0][0], key)
    assert torch.equal(batch, fused(feeds[0][0], key,
                                    fn=augment.augment_batch_plain))
    assert batch.shape == (BATCH, 32, 32, 3)

    def more_steps():
        nonlocal ts
        for gs in range(steps, steps + PROFILE_STEPS):
            ts, _ = step(ts, feeds[gs], lr, root.fold_in(gs))

    profile = _profile_steps(more_steps, PROFILE_STEPS, WRN_KERNEL_KINDS)
    main = next(r for r in aug_rows if r["b"] == BATCH and r["mirror"]
                and r["whiten"])
    aug_ms = main["ms"] if main["ms"] is not None else main["call_ms"]
    return dict(
        launches=launches, seed_launches=seeded, same_calls=same_calls,
        steps=steps,
        losses=losses, lr=lr, setup_s=setup_s, step_ms=step_ms,
        img_per_s=BATCH / step_ms * 1e3, augment_kernel_ms=aug_ms,
        augment_share_of_step=aug_ms / step_ms, peak_mem_gib=peak_mem,
        profile=profile)


# --- phases 6 and 7: int8 fully quantized training ------------------------------

def _half_fwd(fb, x, wq, ws, scale, shift, bits, res, thresh, tile, h, w,
              want_stats, plain):
    """The fused half's int8 forward through its kernels (the amax pass,
    the prepass into the slab, the s8 wgmma GEMM and its ordered sum) or
    its plain versions (the channel-major quantizer and conv)."""
    if plain:
        d_q, amax = fb.fwd_quantize_plain(x, scale, shift, bits,
                                          thresh=thresh, tile=tile)
        y, ysum, yssq = fb.fwd_conv_plain(d_q, amax, wq, ws, res, tile=tile,
                                          h=h, w_img=w,
                                          want_stats=want_stats)
    else:
        y, ysum, yssq = fb.fwd_int8(x, wq, ws, scale, shift, bits, res,
                                    thresh=thresh, tile=tile, h=h, w_img=w,
                                    want_stats=want_stats)
    return dict(y=y, ysum=ysum, yssq=yssq)


# the int8 forward's kernels by name: the amax pass, the prepass, the GEMM
# and the tiles' ordered sum
FWD_INT8_KERNELS = {"amax": "amax_kernel", "prepass": "fwd_slab_kernel",
                    "gemm": "fwd_s8_kernel", "sum": "tile_sum_kernel"}


def _fused_fwd_int8_parts(fb, args, thresh, tile, h, w, stats, peaks):
    """The int8 forward's second call equal to its first bit for bit, its
    slab and group absmax equal to the plain prepass's byte for byte, and
    its parts timed apart beside their bounds: the amax pass + prepass
    (CUDA events; the function's bytes: x and the bits read once, the slab
    written; ``pre_traffic_ms`` is the two passes' own traffic, x and the
    bits read by each),
    the GEMM + ordered sum (CUDA events; its operations, or its bytes: the
    slab, the weights and y, res), and each kernel's device time
    (torch.profiler)."""
    import torch

    _, ops_int8, bw, _ = peaks
    x, wq, ws, scale, shift, bits, res = args
    c, n = x.shape
    cout = wq.shape[0]
    kw = dict(thresh=thresh, tile=tile, h=h, w_img=w, want_stats=stats)
    first = fb.fwd_int8(x, wq, ws, scale, shift, bits, res, **kw)
    for a, b in zip(first, fb.fwd_int8(x, wq, ws, scale, shift, bits, res,
                                       **kw)):
        assert (a is None and b is None) or torch.equal(a, b), (
            "fused_half_fwd", c, h, stats)
    plan = fb.fused_fwd_int8_plan(n, h, w, c, cout)
    pre = dict(thresh=thresh, tile=tile, plan=plan)
    slab, amax = fb.fwd_int8_pre(x, scale, shift, bits, **pre)
    for a, b in zip((slab, amax), fb.fwd_int8_pre_plain(x, scale, shift,
                                                        bits, **pre)):
        assert torch.equal(a, b), ("fused_half_fwd.pre", c, h)
    bits_b = c * n if bits is not None and not fb.is_seed(bits) else 0
    slab_b = plan.lay.slab_len * c
    split = kernel_split_ms(
        lambda: fb.fwd_int8(x, wq, ws, scale, shift, bits, res, **kw), 5,
        FWD_INT8_KERNELS.values(),
        need=[FWD_INT8_KERNELS[k] for k in ("amax", "prepass", "gemm")])
    return dict(
        deterministic=True, bn=plan.bn, tiles=plan.lay.tiles,
        boxes=[b[1] for b in plan.boxes],
        pre_ms=time_ms(lambda: fb.fwd_int8_pre(x, scale, shift, bits,
                                               **pre), 10),
        gemm_ms=time_ms(lambda: fb.fwd_int8_gemm(
            slab, amax, wq, ws, res, tile=tile, plan=plan,
            want_stats=stats), 10),
        **{f"{part}_dev_ms": (split[key] if split else None)
           for part, key in FWD_INT8_KERNELS.items()},
        amax_bound_ms=(2 * c * n + bits_b) / bw * 1e3,
        pre_bound_ms=(2 * c * n + bits_b + slab_b) / bw * 1e3,
        pre_traffic_ms=(4 * c * n + 2 * bits_b + slab_b) / bw * 1e3,
        gemm_bound_ms=max(
            2 * 9 * c * cout * n / ops_int8,
            (slab_b + 9 * c * cout + 2 * cout * n
             + (2 * cout * n if res is not None else 0)) / bw) * 1e3)


# the int8 forward's part keys a phase 6 row carries, summed per step
FWD_INT8_PART_KEYS = ("pre_ms", "gemm_ms", "amax_dev_ms", "prepass_dev_ms",
                      "gemm_dev_ms", "sum_dev_ms", "amax_bound_ms",
                      "pre_bound_ms", "pre_traffic_ms", "gemm_bound_ms")
# the FQT dgrad's kernels by part (the backward's amax pass and quantizer,
# the slab copy, the s8 wgmma GEMM, the tiles' ordered sum), and the keys
# its rows carry beyond the forward's
DGRAD_INT8_KERNELS = {"amax": "amax_kernel", "quant": "quant_kernel",
                      "pre": "slab_copy_kernel", "gemm": "dgrad_s8_kernel",
                      "sum": "tile_sum_kernel"}
DGRAD_INT8_PART_KEYS = ("quant_dev_ms", "pre_dev_ms", "quant_bound_ms")
INT8_PART_KEYS = FWD_INT8_PART_KEYS + DGRAD_INT8_PART_KEYS


def _fused_dgrad_int8_parts(fb, args, thresh, tile, h, w, peaks):
    """The FQT dgrad (the backward's quantization, then ``dgrad_conv``):
    its second call equal to its first bit for bit; its slab equal to the
    plain prepass's byte for byte and its GEMM on that slab equal to the
    plain GEMM's (dx equal, sums within 1e-5); its parts in device time
    (torch.profiler), each beside its bound: the amax pass (dy, y and the
    stats cotangents where the call folds them, x and the bits read), the
    quantizer (those again, g_q and d_q written), the prepass (g_q read,
    the slab's live rows written), the GEMM (its operations, or the codes,
    the weights, x, the bits, dx and the sums once); and the prepass and
    GEMM + sum wrappers timed apart (CUDA events)."""
    import torch

    _, ops_int8, bw, _ = peaks
    dy, y, dysum, dyssq, x, wdg, wsin, scale, shift, bits = args
    c, n = dy.shape
    cin = x.shape[0]
    qkw = dict(thresh=thresh, tile=tile, emit_res=False)

    def call():
        g_q, g_amax = fb.bwd_quantize(dy, y, dysum, dyssq, x, scale, shift,
                                      bits, **qkw)[:2]
        return fb.dgrad_conv(g_q, g_amax, wdg, wsin, x, scale, shift, bits,
                             thresh=thresh, tile=tile, h=h, w_img=w)

    for a, b in zip(call(), call()):
        assert torch.equal(a, b), ("fused_half_dgrad", c, h)
    g_q, g_amax = fb.bwd_quantize(dy, y, dysum, dyssq, x, scale, shift,
                                  bits, **qkw)[:2]
    plan = fb.fused_fwd_int8_plan(n, h, w, c, cin)
    slab = fb.dgrad_int8_pre(g_q, plan=plan)
    assert torch.equal(slab, fb.dgrad_int8_pre_plain(g_q, plan=plan)), (
        "fused_half_dgrad.pre", c, h)
    gkw = dict(thresh=thresh, tile=tile, plan=plan)
    gargs = (slab, g_amax, wdg, wsin, x, scale, shift, bits)
    _agree(dict(zip(("dx", "ds", "dt"), fb.dgrad_int8_gemm(*gargs, **gkw))),
           dict(zip(("dx", "ds", "dt"),
                    fb.dgrad_int8_gemm_plain(*gargs, **gkw))),
           ("fused_half_dgrad gemm", c, h))
    split = kernel_split_ms(call, 5, DGRAD_INT8_KERNELS.values(),
                            need=list(DGRAD_INT8_KERNELS.values()))
    bits_b = cin * n if bits is not None and not fb.is_seed(bits) else 0
    ins = 2 * c * n + 2 * cin * n + bits_b + (
        2 * c * n + 8 * c if y is not None else 0)
    return dict(
        deterministic=True, bn=plan.bn, tiles=plan.lay.tiles,
        boxes=[b[1] for b in plan.boxes],
        pre_ms=time_ms(lambda: fb.dgrad_int8_pre(g_q, plan=plan), 10),
        gemm_ms=time_ms(lambda: fb.dgrad_int8_gemm(*gargs, **gkw), 10),
        **{f"{part}_dev_ms": (split[key] if split else None)
           for part, key in DGRAD_INT8_KERNELS.items()},
        dev_ms=sum(split.values()) if split else None,
        amax_bound_ms=ins / bw * 1e3,
        quant_bound_ms=(ins + c * n + cin * n) / bw * 1e3,
        pre_bound_ms=2 * c * n / bw * 1e3,
        gemm_bound_ms=max(
            2 * 9 * c * cin * n / ops_int8,
            (c * n + 9 * c * cin + 4 * cin * n + bits_b + 8 * cin) / bw)
        * 1e3)


def _half_dgrad(fb, dy, y, dysum, dyssq, x, wdg, wsin, scale, shift, bits,
                thresh, tile, h, w, emit_res, plain):
    """The shared backward quantization and the input gradient."""
    quant, dgrad = ((fb.bwd_quantize_plain, fb.dgrad_conv_plain) if plain
                    else (fb.bwd_quantize, fb.dgrad_conv))
    g_q, g_amax, d_q, d_amax, dres = quant(
        dy, y, dysum, dyssq, x, scale, shift, bits, thresh=thresh, tile=tile,
        emit_res=emit_res)
    dx, ds, dt = dgrad(g_q, g_amax, wdg, wsin, x, scale, shift, bits,
                       thresh=thresh, tile=tile, h=h, w_img=w)
    return dict(g_q=g_q, g_amax=g_amax, d_q=d_q, d_amax=d_amax, dres=dres,
                dx=dx, ds=ds, dt=dt)


def _half_wgrad(fb, ops, tile, h, w, plain):
    fn = fb.wgrad_plain if plain else fb.wgrad
    return dict(dw=fn(ops["g_q"], ops["g_amax"], ops["d_q"], ops["d_amax"],
                      tile=tile, h=h, w_img=w))


def _agree(got: dict, want: dict, what) -> float:
    """Kernel outputs against the plain version's: equal, except f32 sums
    over positions (1e-5 of the largest value). Returns the max abs
    difference."""
    import torch

    err = 0.0
    for k, ref in want.items():
        out = got[k]
        if ref is None:
            assert out is None, (what, k)
            continue
        assert out.dtype == ref.dtype and out.shape == ref.shape, (what, k)
        d = (out.float() - ref.float()).abs().max().item()
        if k in F32_SUMS:
            assert d <= 1e-5 * ref.float().abs().max().item(), (what, k, d)
        else:
            assert torch.equal(out, ref), (what, k, d)
        err = max(err, d)
    return err


def cudnn_times(g, c_in, c_out, h, w, k):
    """cuDNN bf16 channels-last forward, input and weight gradient of a
    k x k SAME conv at batch BATCH: ms per call."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    dev = torch.device("cuda")

    def rn(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(
            torch.bfloat16).to(memory_format=torch.channels_last)

    x4, w4, dy4 = rn(BATCH, c_in, h, w), rn(c_out, c_in, k, k), rn(
        BATCH, c_out, h, w)
    p = k // 2
    return (time_ms(lambda: F.conv2d(x4, w4, padding=p), 10),
            time_ms(lambda: conv2d_input(x4.shape, w4, dy4, padding=p), 10),
            time_ms(lambda: conv2d_weight(x4, w4.shape, dy4, padding=p), 10))


def fqt_kernel_phase(peaks):
    """Rows per (kernel, shape, mode): max error against the plain version,
    and the kernel / plain / cuDNN-bf16 / bound times of one call."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import stem as st
    from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import pack_weights

    flops_bf16, ops_int8, bw, _ = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    rows = []

    def randn(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    def cudnn(c_in, c_out, h, w, k):
        return cudnn_times(g, c_in, c_out, h, w, k)

    def row(name, c, h, w, mode, err, fn, plain_fn, lib, ops, byts,
            ops_peak):
        rows.append(dict(
            name=name, c=c, h=h, w=w, n=BATCH * h * w, mode=mode,
            max_abs_err=err, ms=time_ms(fn, 10), plain_ms=time_ms(plain_fn, 2),
            library_ms=lib, ops_ms=ops / ops_peak * 1e3,
            bytes_ms=byts / bw * 1e3))

    for c, h, w in STAGES:
        n = BATCH * h * w
        x = randn(c, n).to(torch.bfloat16)
        wt = randn(c, c, 3, 3, s=(9 * c) ** -0.5)
        scale, shift = randn(c).abs() + 0.5, randn(c, s=0.3)
        bits = torch.randint(0, 256, (c, n), device=dev, generator=g,
                             dtype=torch.uint8)
        thresh = fb.dropout_thresh(0.3)
        res = randn(c, n).to(torch.bfloat16)
        tile, btile = fb.lane_tile(h, w, n, c, c), fb.bwd_tile(h, w, n, c, c)
        wq, ws = fb.quantize_pack_weights(wt)
        wdg, wsin = fb.quantize_pack_weights_dgrad(wt)
        lib_f, lib_d, lib_w = cudnn(c, c, h, w, 3)
        macs = 9 * c * c * n
        cn = c * n
        for use_res, stats in ((False, True), (True, False), (False, False),
                               (True, True)):
            r = res if use_res else None
            args = (x, wq, ws, scale, shift, bits, r, thresh, tile, h, w,
                    stats)
            err = _agree(_half_fwd(fb, *args, plain=False),
                         _half_fwd(fb, *args, plain=True), ("fwd", c))
            row("fused_half_fwd", c, h, w,
                ("res" if use_res else "") + ("+stats" if stats else ""),
                err, lambda: _half_fwd(fb, *args, plain=False),
                lambda: _half_fwd(fb, *args, plain=True), lib_f, 2 * macs,
                5 * cn + 9 * c * c + 4 * c + (2 * cn if use_res else 0),
                ops_int8)
            rows[-1].update(_fused_fwd_int8_parts(
                fb, (x, wq, ws, scale, shift, bits, r), thresh, tile, h, w,
                stats, peaks))
        # the prepass (with its amax pass) as a kernel row of its own: its
        # slab equal to the plain version's byte for byte; bound by the
        # function's bytes (x and the bits read once, the slab written)
        plan = fb.fused_fwd_int8_plan(n, h, w, c, c)
        pre = dict(thresh=thresh, tile=tile, plan=plan)
        err = _agree(
            dict(zip(("slab", "amax"),
                     fb.fwd_int8_pre(x, scale, shift, bits, **pre))),
            dict(zip(("slab", "amax"),
                     fb.fwd_int8_pre_plain(x, scale, shift, bits, **pre))),
            ("fwd pre", c))
        row("fused_half_fwd.pre", c, h, w, "", err,
            lambda: fb.fwd_int8_pre(x, scale, shift, bits, **pre),
            lambda: fb.fwd_int8_pre_plain(x, scale, shift, bits, **pre),
            None, 3 * cn, 3 * cn + plan.lay.slab_len * c, ops_int8)
        y = _half_fwd(fb, x, wq, ws, scale, shift, bits, None, thresh, tile,
                      h, w, True, plain=True)["y"]
        dy = randn(c, n, s=1e-3).to(torch.bfloat16)
        for ct in (True, False):
            cts = ((y, randn(c, s=1e-4), randn(c, s=1e-4)) if ct
                   else (None, None, None))
            args = (dy, *cts, x, wdg, wsin, scale, shift, bits, thresh, btile,
                    h, w, ct)
            ops_p = _half_dgrad(fb, *args, plain=True)
            err = _agree(_half_dgrad(fb, *args, plain=False), ops_p,
                         ("dgrad", c, ct))
            ins = 5 * cn + (2 * cn if ct else 0)  # dy, x, bits (+ y)
            row("fused_half_dgrad", c, h, w, "stats" if ct else "", err,
                lambda: _half_dgrad(fb, *args, plain=False),
                lambda: _half_dgrad(fb, *args, plain=True), lib_d, 2 * macs,
                ins + 2 * cn + 36 * c * c + (2 * cn if ct else 0), ops_int8)
            rows[-1].update(_fused_dgrad_int8_parts(
                fb, (dy, *cts, x, wdg, wsin, scale, shift, bits), thresh,
                btile, h, w, peaks))
            wargs = (ops_p, btile, h, w)
            first = _half_wgrad(fb, *wargs, plain=False)
            assert torch.equal(first["dw"], _half_wgrad(
                fb, *wargs, plain=False)["dw"]), ("wgrad bits", c, ct)
            err = _agree(first, _half_wgrad(fb, *wargs, plain=True),
                         ("wgrad", c, ct))
            # the wgrad reads the int8 operands the dgrad row's
            # quantization wrote (charged there once) and writes f32 dW
            row("fused_half_wgrad", c, h, w, "stats" if ct else "", err,
                lambda: _half_wgrad(fb, *wargs, plain=False),
                lambda: _half_wgrad(fb, *wargs, plain=True), lib_w, 2 * macs,
                2 * cn + 36 * c * c, ops_int8)
            wplan = fb.fused_wgrad_s8_plan(c, c, n, h, w, btile)
            assert (wplan.runs > 1) == FQT_WGRAD_SPLIT[c], (c, wplan)
            rows[-1].update(
                bn=wplan.bn, runs=wplan.runs, bits_equal_two_calls=True,
                dev_ms=device_ms(
                    lambda: _half_wgrad(fb, *wargs, plain=False), 10))
        # the dgrad's prepass as a kernel row of its own: its slab equal to
        # the plain version's byte for byte; bound by its bytes (g_q read,
        # the slab written)
        g_q = fb.bwd_quantize(dy, None, None, None, x, scale, shift, bits,
                              thresh=thresh, tile=btile, emit_res=False)[0]
        dplan = fb.fused_fwd_int8_plan(n, h, w, c, c)
        err = _agree({"slab": fb.dgrad_int8_pre(g_q, plan=dplan)},
                     {"slab": fb.dgrad_int8_pre_plain(g_q, plan=dplan)},
                     ("dgrad pre", c))
        row("fused_half_dgrad.pre", c, h, w, "", err,
            lambda: fb.dgrad_int8_pre(g_q, plan=dplan),
            lambda: fb.dgrad_int8_pre_plain(g_q, plan=dplan), None, 0,
            cn + dplan.lay.slab_len * c, ops_int8)
        del x, bits, res, y, dy, g_q
        torch.cuda.empty_cache()

    # the stem: 3 -> 160 channels at 32x32
    c_in, c, h, w = 3, 160, 32, 32
    n = BATCH * h * w
    x = randn(c_in, n).to(torch.bfloat16)
    wp = pack_weights(randn(c, c_in, 3, 3, s=0.3).to(torch.bfloat16))
    b = randn(c, s=0.1)
    dy = randn(c, n).to(torch.bfloat16)
    lib_f, _, lib_w = cudnn(c_in, c, h, w, 3)
    ops = 2 * 9 * c_in * c * n
    err = _agree({"y": st.stem_fwd(x, wp, b, h=h, w_img=w)},
                 {"y": st.stem_fwd_plain(x, wp, b, h=h, w_img=w)}, "stem")
    row("stem_fwd", c, h, w, "cin=3", err,
        lambda: st.stem_fwd(x, wp, b, h=h, w_img=w),
        lambda: st.stem_fwd_plain(x, wp, b, h=h, w_img=w), lib_f, ops,
        2 * (c_in + c) * n + 2 * 27 * c, flops_bf16)
    got, want = (st.stem_wgrad(dy, x, h=h, w_img=w),
                 st.stem_wgrad_plain(dy, x, h=h, w_img=w))
    assert all(torch.equal(a, b_) for a, b_ in zip(
        got, st.stem_wgrad(dy, x, h=h, w_img=w))), "stem wgrad bits"
    err = _agree({"dw_stem": got[0], "db": got[1]},
                 {"dw_stem": want[0], "db": want[1]}, "stem wgrad")
    row("stem_wgrad", c, h, w, "cin=3", err,
        lambda: st.stem_wgrad(dy, x, h=h, w_img=w),
        lambda: st.stem_wgrad_plain(dy, x, h=h, w_img=w), lib_w, ops,
        2 * (c_in + c) * n + 4 * 28 * c, flops_bf16)
    rows[-1].update(
        blocks=st.stem_wgrad_plan(n, c, h, w).blocks,
        bits_equal_two_calls=True,
        dev_ms=device_ms(lambda: st.stem_wgrad(dy, x, h=h, w_img=w), 10))
    for r in rows:
        r["bound_ms"] = max(r["ops_ms"], r["bytes_ms"])
        r["bound_by"] = ("operations" if r["ops_ms"] >= r["bytes_ms"]
                         else "bytes")
    return rows


class RecordHalves:
    """Around the first train step: count the step's fused halves of
    ``fb.<op>`` by (width, residual, BatchNorm sums, bits mode), and record
    the first half of each bits mode: its live inputs and, through gradient
    hooks, its live cotangents (phases 7, 13 and 14)."""

    def __init__(self, op: str):
        self.op = op
        self.rec = {}
        self.halves = {}

    def __enter__(self):
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb

        self.fb, self.orig = fb, getattr(fb, self.op)
        rec, orig, halves = self.rec, self.orig, self.halves

        def clone(t):
            return None if t is None else t.detach().clone()

        def recording(x_cs, w, scale, shift, bits=None, res=None, **kw):
            out = orig(x_cs, w, scale, shift, bits, res, **kw)
            kind = ("seed" if fb.is_seed(bits) else
                    "none" if bits is None else "bits")
            key = (x_cs.shape[0], res is not None, kw["want_stats"], kind)
            halves[key] = halves.get(key, 0) + 1
            if kind not in rec:
                # copies: the optimizer updates the weight in place
                r = rec[kind] = dict(
                    args=[clone(t) for t in (x_cs, w, scale, shift, bits,
                                             res)], kw=kw,
                    out=[clone(t) for t in out])
                for name, t in zip(("dy", "dysum", "dyssq"), out):
                    if t is not None:
                        t.register_hook(lambda gr, name=name, r=r:
                                        r.__setitem__(name, clone(gr)))
            return out

        setattr(fb, self.op, recording)
        return self

    def __exit__(self, *exc):
        setattr(self.fb, self.op, self.orig)
        return False


def live_half_check(rec):
    """The recorded half, forward and backward, kernels against the plain
    versions on the live tensors; the kernels also reproduce the live
    output."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb

    x, wt, scale, shift, bits, res = rec["args"]
    kw = rec["kw"]
    h, w, stats = kw["h"], kw["w_img"], kw["want_stats"]
    thresh = fb.dropout_thresh(kw["dropout_rate"]) if bits is not None \
        else None
    c, n = x.shape
    tile, btile = fb.lane_tile(h, w, n, c, c), fb.bwd_tile(h, w, n, c, c)
    wq, ws = fb.quantize_pack_weights(wt)
    args = (x, wq, ws, scale, shift, bits, res, thresh, tile, h, w, stats)
    got = _half_fwd(fb, *args, plain=False)
    assert torch.equal(got["y"], rec["out"][0])
    err = _agree(got, _half_fwd(fb, *args, plain=True), "live fwd")
    wdg, wsin = fb.quantize_pack_weights_dgrad(wt)
    cts = ((rec["out"][0], rec["dysum"], rec["dyssq"]) if stats
           else (None, None, None))
    args = (rec["dy"].contiguous(), *cts, x, wdg, wsin, scale, shift, bits,
            thresh, btile, h, w, stats and res is not None)
    ops = _half_dgrad(fb, *args, plain=True)
    err = max(err, _agree(_half_dgrad(fb, *args, plain=False), ops,
                          "live dgrad"))
    err = max(err, _agree(_half_wgrad(fb, ops, btile, h, w, plain=False),
                          _half_wgrad(fb, ops, btile, h, w, plain=True),
                          "live wgrad"))
    return dict(c=c, n=n, h=h, w=w, want_stats=stats, max_abs_err=err,
                g_amax=ops["g_amax"].tolist())


def augment_summary(aug_rows, training):
    """The augment kernel's entry: the training run's launches and the times
    at the recipe's configuration (batch 128, mirror pad, whitening)."""
    main = next(r for r in aug_rows if r["b"] == BATCH and r["mirror"]
                and r["whiten"])
    return dict(
        name="augment_batch", route="cuda", source=AUG_SOURCE,
        replaces=REPLACES["augment_batch"],
        launches=training["launches"].get("augment_batch", 0),
        max_abs_err=max(r["max_abs_err"] for r in aug_rows),
        ms=main["ms"], kernel_ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None, chain_ms=main["chain_ms"],
        call_ms=main["call_ms"], plain_call_ms=main["plain_call_ms"],
        chain_call_ms=main["chain_call_ms"],
        per=f"training batch of {BATCH}; ms = device time per launch",
        cases=[{k: r[k] for k in AUG_KEYS} for r in aug_rows])


def kernel_summary(rows, serving):
    """One entry per conv kernel: the serving path's launches, and
    per-batch times (calibration batch for the bf16 conv's prepass and
    GEMM, serving batch for the int8 conv's) summed over the (shape, mode)
    mix that path launched. Each conv's ``ms`` is the op's (its two
    launches), ``gemm_ms`` its GEMM's alone, ``*_dev_ms`` the device time
    by part (torch.profiler)."""
    names = ("conv3x3_bf16", "conv3x3_bf16.pre", "conv3x3_int8_requant.pre",
             "conv3x3_int8_requant")
    per_batch = {name: serving["n_serve"] for name in names}
    for name in CALIB_PER_BATCH:
        per_batch[name] = serving["n_calib"]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms",
            "bytes_ms", "gemm_ms", "pre_dev_ms", "gemm_dev_ms", "dev_ms")
    out = []
    for name in names:
        mine = [r for r in rows if r["name"] == name]
        mix = []
        for (kname, cin, cout, n, mode), count in serving["shapes"].items():
            if kname == name:
                mix.append((next(r for r in mine if r["c"] == cin
                                 and r["n"] == n and r["mode"] == mode),
                            count / per_batch[name]))
        # a key summed where every row of the mix has a number for it
        tot = {key: sum(r[key] * cnt for r, cnt in mix) for key in keys
               if all(r.get(key) is not None for r, _ in mix)}
        out.append(dict(
            name=name, route="cuda", source=SOURCES.get(name, SOURCE),
            replaces=REPLACES[name],
            launches=serving["launches"].get(name, 0),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=tot["ms"], kernel_ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=tot["bound_ms"],
            bound_by=("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                      else "bytes"),
            library_ms=tot.get("library_ms"),
            **{key: tot.get(key) for key in keys[6:] if key in mine[0]},
            per=("calibration batch" if name in CALIB_PER_BATCH
                 else "serving batch") + f" of {BATCH}",
            stages=[{k: r[k] for k in ("c", "h", "w", "mode", "ms",
                                       "plain_ms", "library_ms", "bound_ms",
                                       "bound_by", "max_abs_err") + tuple(
                                           key for key in keys[6:]
                                           if key in r)}
                    for r in mine]))
    return out


def fqt_summary(rows, training, halves):
    """One entry per FQT kernel: the int8 training run's launches and the
    device time per train step: phase 6's per-call times summed over the
    halves one step of the main path ran (``halves``: count per (width,
    residual, BatchNorm sums, bits mode), recorded by RecordHalves)."""
    def mode(name, res, stats):
        if name == "fused_half_fwd":
            return ("res" if res else "") + ("+stats" if stats else "")
        if name in ("fused_half_fwd.pre", "fused_half_dgrad.pre"):
            return ""
        return "stats" if stats else ""

    out = []
    for name in ("stem_fwd", "stem_wgrad", "fused_half_fwd",
                 "fused_half_fwd.pre", "fused_half_dgrad",
                 "fused_half_dgrad.pre", "fused_half_wgrad"):
        mine = [r for r in rows if r["name"] == name]
        mix = [(mine[0], 1)] if name.startswith("stem") else [
            (next(r for r in mine
                  if r["c"] == c and r["mode"] == mode(name, res, stats)),
             count)
            for (c, res, stats, _), count in halves.items()]
        # keys every row has a number for (no library call for the
        # prepasses; the forward's and the dgrad's parts only on theirs)
        tot = {k: sum(r[k] * cnt for r, cnt in mix)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "ops_ms", "bytes_ms", "dev_ms") + INT8_PART_KEYS
               if all(r.get(k) is not None for r, _ in mix)}
        out.append(dict(
            name=name, route="cuda",
            source=(STEM_SOURCE if name.startswith("stem")
                    else SOURCES.get(name, FQT_SOURCE)),
            replaces=REPLACES[name], launches=training["launches"].get(
                name, 0),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by=("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                      else "bytes"),
            library_ms=tot.get("library_ms"),
            **{k: tot[k] for k in INT8_PART_KEYS + ("dev_ms",) if k in tot},
            per=f"training step of {BATCH} (ms per call summed over the "
                "step's calls; launches over the run)",
            stages=[{k: r.get(k) for k in (
                "c", "h", "w", "mode", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "max_abs_err") + INT8_PART_KEYS
                + ("bn", "boxes", "tiles", "runs", "blocks", "dev_ms",
                   "bits_equal_two_calls") if k in r}
                    for r in mine]))
    return out


# --- phases 12 to 14: fused bf16 halves, QAT, in-kernel dropout --------------

SEED_VALUES = (0, -1, 2 ** 31 - 1, -2 ** 31, 123456789, -987654321)
BF16_SUMS = ("ysum", "yssq", "ds", "dt", "dw")


def _agree_bf16(got: dict, want: dict, what) -> float:
    """A bf16 kernel's outputs against the plain version's: bf16 tensors
    within 2 bf16 ulps of the tensor's largest value (f32 against float64
    accumulation), dres equal; the f32 sums over the tensor cores' f32
    accumulators within 1e-4 of their largest value (that accumulation
    does not round to nearest: at K = 5,760 it left y's squares 1.6e-5 low
    of the float64 plain version's), and the BatchNorm sums within 1e-5 of
    the sums of the kernel's own y. Returns the max abs difference."""
    import torch

    err = 0.0
    for k, ref in want.items():
        out = got[k]
        if ref is None:
            assert out is None, (what, k)
            continue
        assert out.dtype == ref.dtype and out.shape == ref.shape, (what, k)
        d = (out.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        if k in ("ysum", "yssq"):
            yd = got["y"].double()
            own = yd.sum(1) if k == "ysum" else (yd * yd).sum(1)
            assert (out.double() - own).abs().max().item() <= \
                1e-5 * own.abs().max().item(), (what, k)
        if k in BF16_SUMS:
            assert d <= 1e-4 * top, (what, k, d, top)
        elif k == "dres":
            assert torch.equal(out, ref), (what, k, d)
        else:
            ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
            assert d <= 2 * ulp, (what, k, d, top)
        err = max(err, d)
    return err


def _bf16_fns(fb, x, wp, wdg, scale, shift, bits, res, stats, ct, thresh,
              h, w, plain):
    """The bf16 half's three stages as callables returning dicts."""
    fwd, dgrad, wgrad = ((fb.fwd_bf16_plain, fb.dgrad_bf16_plain,
                          fb.wgrad_bf16_plain) if plain
                         else (fb.fwd_bf16, fb.dgrad_bf16, fb.wgrad_bf16))
    kw = dict(thresh=thresh, h=h, w_img=w)
    dy, cts = ct[0], ct[1:]

    def f():
        y, ys, yq = fwd(x, wp, scale, shift, bits, res, want_stats=stats,
                        **kw)
        return dict(y=y, ysum=ys, yssq=yq)

    def d():
        dx, ds, dt, dres = dgrad(dy, *cts, wdg, x, scale, shift, bits,
                                 emit_res=cts[0] is not None
                                 and res is not None, **kw)
        return dict(dx=dx, ds=ds, dt=dt, dres=dres)

    def wg():
        return dict(dw=wgrad(dy, *cts, x, scale, shift, bits, **kw))

    return f, d, wg


def _fused_wgrad_parts(fb, args, thresh, h, w):
    """The fused wgrad's second call equal to its first bit for bit (its
    splits are added in a fixed order), and its two parts timed apart: the
    prepass, then the mainloop + ordered sum on its operands."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt

    kw = dict(thresh=thresh, h=h, w_img=w)
    first = fb.wgrad_bf16(*args, **kw)
    assert torch.equal(first, fb.wgrad_bf16(*args, **kw)), (
        "fused_half_bf16_wgrad", h, thresh)
    d_b, g_b = fb.wgrad_bf16_pre(*args, thresh=thresh)
    n, cin = d_b.shape
    plan = nvt.wgrad_bf16_plan(n // (h * w), h, w, cin, g_b.shape[1], 9, h)
    return dict(
        deterministic=True, plan=list(plan[:-1]),
        pre_ms=time_ms(lambda: fb.wgrad_bf16_pre(*args, thresh=thresh), 10),
        gemm_ms=time_ms(lambda: fb.wgrad_bf16_gemm(d_b, g_b, h=h, w_img=w),
                        10))


def _fused_wgrad_pre_row(fb, args, thresh, geo, flops_f32, bw):
    """The fused wgrad's prepass as a kernel row: d_b and g_b equal to its
    plain version's byte for byte; bound by its bytes (x and dy, with y
    and the bits where the call has them, in; d_b and g_b out) or its f32
    operations (three an element)."""
    import torch

    got = fb.wgrad_bf16_pre(*args, thresh=thresh)
    want = fb.wgrad_bf16_pre_plain(*args, thresh=thresh)
    for a, b in zip(got, want):
        assert torch.equal(a, b), ("fused_half_bf16_wgrad.pre", geo)
    c, n = geo["c"], geo["n"]
    y, bits = args[1], args[7]
    byts = (8 * c * n + 8 * c + (2 * c * n + 8 * c if y is not None else 0)
            + (c * n if bits is not None and not fb.is_seed(bits) else 0))
    return dict(
        name="fused_half_bf16_wgrad.pre", **geo, max_abs_err=0.0,
        ms=time_ms(lambda: fb.wgrad_bf16_pre(*args, thresh=thresh), 10),
        plain_ms=time_ms(lambda: fb.wgrad_bf16_pre_plain(*args,
                                                         thresh=thresh), 1),
        library_ms=None, ops_ms=3 * 2 * c * n / flops_f32 * 1e3,
        bytes_ms=byts / bw * 1e3)


def _fused_dgrad_parts(fb, args, thresh, h, w, emit_res, peaks):
    """The bf16 dgrad's second call equal to its first bit for bit (its
    tiles' sums are added in a fixed order), and its two parts timed apart,
    each beside its bound: the prepass (its bytes: dy, with y and the stats
    cotangents where the call has them, in; g unpadded and dres out) and
    the wgmma GEMM + masking epilogue + ordered sum (its operations on the
    unpadded operands, or its bytes: g, the weights, x, a bits tensor,
    scale and shift in, dx and the sums out)."""
    import torch

    flops_bf16, _, bw, flops_f32 = peaks
    dy, y, dysum, dyssq, wdg, x, scale, shift, bits = args
    cout, n = dy.shape
    cin = x.shape[0]
    kw = dict(thresh=thresh, h=h, w_img=w, emit_res=emit_res)
    first = fb.dgrad_bf16(*args, **kw)
    for a, b in zip(first, fb.dgrad_bf16(*args, **kw)):
        assert (a is None and b is None) or torch.equal(a, b), (
            "fused_half_bf16_dgrad", cin, h, emit_res)
    lay = fb.fused_fwd_layout(n, h, w, cout, cin)
    slab, _ = fb.dgrad_bf16_pre(dy, y, dysum, dyssq, lay=lay,
                                emit_res=emit_res)
    bits_b = cin * n if bits is not None and not fb.is_seed(bits) else 0
    ct_b = 2 * cout * n + 8 * cout if y is not None else 0
    return dict(
        deterministic=True, bn=lay.bn, tiles=lay.tiles,
        pre_ms=time_ms(lambda: fb.dgrad_bf16_pre(
            dy, y, dysum, dyssq, lay=lay, emit_res=emit_res), 10),
        gemm_ms=time_ms(lambda: fb.dgrad_bf16_gemm(
            slab, wdg, x, scale, shift, bits, thresh=thresh, lay=lay), 10),
        pre_bound_ms=max((4 * cout * n + ct_b
                          + (2 * cout * n if emit_res else 0)) / bw,
                         3 * cout * n / flops_f32) * 1e3,
        gemm_bound_ms=max(
            2 * 9 * cin * cout * n / flops_bf16,
            (2 * cout * n + 18 * cin * cout + 4 * cin * n + bits_b
             + 16 * cin) / bw) * 1e3)


def _fused_dgrad_pre_row(fb, cts, emit_res, geo, peaks):
    """The bf16 dgrad's prepass as a kernel row: its slab and dres equal
    to the plain version's byte for byte; bound by its bytes (dy, with y
    and the stats cotangents where the call has them, in; g unpadded and
    dres out) or its f32 operations (three an element)."""
    import torch

    _, _, bw, flops_f32 = peaks
    dy, y = cts[0], cts[1]
    c, n = dy.shape
    lay = fb.fused_fwd_layout(n, geo["h"], geo["w"], c, c)
    kw = dict(lay=lay, emit_res=emit_res)
    for a, b in zip(fb.dgrad_bf16_pre(*cts, **kw),
                    fb.dgrad_bf16_pre_plain(*cts, **kw)):
        assert (a is None and b is None) or torch.equal(a, b), (
            "fused_half_bf16_dgrad.pre", geo)
    byts = (4 * c * n + (2 * c * n + 8 * c if y is not None else 0)
            + (2 * c * n if emit_res else 0))
    return dict(
        name="fused_half_bf16_dgrad.pre", **geo, max_abs_err=0.0,
        ms=time_ms(lambda: fb.dgrad_bf16_pre(*cts, **kw), 10),
        plain_ms=time_ms(lambda: fb.dgrad_bf16_pre_plain(*cts, **kw), 1),
        library_ms=None, ops_ms=3 * c * n / flops_f32 * 1e3,
        bytes_ms=byts / bw * 1e3)


def _fused_fwd_parts(fb, args, thresh, h, w, stats, peaks):
    """The bf16 forward's second call equal to its first bit for bit, and
    its two parts timed apart, each beside its bound: the prepass (its
    bytes: x, a bits tensor, scale and shift in, d out, counted unpadded)
    and the wgmma GEMM + ordered sum (its operations on the unpadded
    operands); with the MACs the GEMM issues (pad rows, N tiles, the last
    K step's tail) against the useful ones, and the N columns it issues
    against Cout."""
    import torch

    flops_bf16, _, bw, flops_f32 = peaks
    x, wp, scale, shift, bits, res = args
    c, n = x.shape
    cout = wp.shape[0]
    kw = dict(thresh=thresh, h=h, w_img=w, want_stats=stats)
    first = fb.fwd_bf16(*args, **kw)
    for a, b in zip(first, fb.fwd_bf16(*args, **kw)):
        assert (a is None and b is None) or torch.equal(a, b), (
            "fused_half_bf16_fwd", c, h, stats)
    lay = fb.fused_fwd_layout(n, h, w, c, cout)
    slab = fb.fused_fwd_pre(x, scale, shift, bits, thresh=thresh, lay=lay)
    bits_b = c * n if bits is not None and not fb.is_seed(bits) else 0
    n_cols = -(-cout // lay.bn) * lay.bn
    return dict(
        deterministic=True, bn=lay.bn, tiles=lay.tiles,
        pre_ms=time_ms(lambda: fb.fused_fwd_pre(x, scale, shift, bits,
                                                thresh=thresh, lay=lay), 10),
        gemm_ms=time_ms(lambda: fb.fused_fwd_gemm(slab, wp, res, lay=lay,
                                                  want_stats=stats), 10),
        pre_bound_ms=max((4 * c * n + bits_b + 8 * c) / bw,
                         3 * c * n / flops_f32) * 1e3,
        gemm_bound_ms=max(
            2 * 9 * c * cout * n / flops_bf16,
            (2 * c * n + 18 * c * cout + 2 * cout * n
             + (2 * cout * n if res is not None else 0)
             + (8 * cout if stats else 0)) / bw) * 1e3,
        issued_macs=lay.tiles * lay.bm * n_cols * (-(-18 * c // 128) * 64),
        useful_macs=n * cout * 9 * c, issued_n=n_cols, cout=cout)


def _fused_fwd_pre_row(fb, x, scale, shift, bits, thresh, geo, peaks):
    """The bf16 forward's prepass as a kernel row: its slab equal to the
    plain version's byte for byte; bound by its bytes (x, the bits where
    the call has a tensor, scale and shift in; d out, unpadded) or its f32
    operations (three an element)."""
    import torch

    _, _, bw, flops_f32 = peaks
    c, n = x.shape
    lay = fb.fused_fwd_layout(n, geo["h"], geo["w"], c, c)
    kw = dict(thresh=thresh, lay=lay)
    assert torch.equal(fb.fused_fwd_pre(x, scale, shift, bits, **kw),
                       fb.fused_fwd_pre_plain(x, scale, shift, bits, **kw)), (
        "fused_half_bf16_fwd.pre", geo)
    bits_b = c * n if bits is not None and not fb.is_seed(bits) else 0
    return dict(
        name="fused_half_bf16_fwd.pre", **geo, max_abs_err=0.0,
        ms=time_ms(lambda: fb.fused_fwd_pre(x, scale, shift, bits, **kw),
                   10),
        plain_ms=time_ms(lambda: fb.fused_fwd_pre_plain(x, scale, shift,
                                                        bits, **kw), 1),
        library_ms=None, ops_ms=3 * c * n / flops_f32 * 1e3,
        bytes_ms=(4 * c * n + bits_b + 8 * c) / bw * 1e3)


def bf16_kernel_phase(peaks):
    """Rows per (bf16 kernel, stage, mode): max error against the plain
    version and the kernel / plain / cuDNN bf16 / bound times of one call
    (the forward and the wgrad also bit-equal over two calls, each with
    its prepass and its mainloop + sum timed apart, the forward's with
    its issued and useful MACs; each prepass has rows of its own); seed
    rows: the int8 core's kernels in seed mode against bits mode."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
    from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import pack_weights

    flops_bf16, _, bw, flops_f32 = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    rows, seed_rows = [], []

    def randn(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    for c, h, w in STAGES:
        n = BATCH * h * w
        for v in SEED_VALUES:
            seed = torch.tensor(v, dtype=torch.int32, device=dev)
            assert torch.equal(fb.seed_bits_expand(seed, c, n),
                               fb.seed_bits(seed, c, n, 0, n)), (c, v)

    for c, h, w in STAGES:
        n = BATCH * h * w
        cn = c * n
        x = randn(c, n).to(torch.bfloat16)
        wt = randn(c, c, 3, 3, s=(9 * c) ** -0.5)
        wp = pack_weights(wt.to(torch.bfloat16))
        wdg = fb.pack_weights_dgrad(wt.to(torch.bfloat16))
        scale, shift = randn(c).abs() + 0.5, randn(c, s=0.3)
        thresh = fb.dropout_thresh(0.3)
        res = randn(c, n).to(torch.bfloat16)
        drops = {"bits": torch.randint(0, 256, (c, n), device=dev,
                                       generator=g, dtype=torch.uint8),
                 "seed": torch.tensor(-1234567, dtype=torch.int32,
                                      device=dev)}
        lib_f, lib_d, lib_w = cudnn_times(g, c, c, h, w, 3)
        ops_ms = 2 * 9 * c * c * n / flops_bf16 * 1e3
        y0 = fb.fwd_bf16_plain(x, wp, scale, shift, drops["bits"], None,
                               thresh=thresh, h=h, w_img=w,
                               want_stats=True)[0]
        dy = randn(c, n, s=1e-3).to(torch.bfloat16)
        cts = {True: (dy, y0, randn(c, s=1e-4), randn(c, s=1e-4)),
               False: (dy, None, None, None)}

        def add(name, mode, kern, plain, lib, byts):
            err = _agree_bf16(kern(), plain(), (name, c, mode))
            rows.append(dict(
                name=name, c=c, h=h, w=w, n=n, mode=mode, max_abs_err=err,
                ms=time_ms(kern, 10), plain_ms=time_ms(plain, 1),
                library_ms=lib, ops_ms=ops_ms, bytes_ms=byts / bw * 1e3))

        for kind, bits in drops.items():
            bits_b = cn if kind == "bits" else 0
            for use_res, stats in ((False, True), (True, False),
                                   (False, False), (True, True)):
                r = res if use_res else None
                fns = [_bf16_fns(fb, x, wp, wdg, scale, shift, bits, r,
                                 stats, cts[stats], thresh, h, w, plain)
                       for plain in (False, True)]
                mode = kind + ("+res" if use_res else "") + (
                    "+stats" if stats else "")
                add("fused_half_bf16_fwd", mode, fns[0][0], fns[1][0], lib_f,
                    4 * cn + 18 * c * c + 8 * c + bits_b
                    + (2 * cn if use_res else 0) + (8 * c if stats else 0))
                rows[-1].update(_fused_fwd_parts(
                    fb, (x, wp, scale, shift, bits, r), thresh, h, w, stats,
                    peaks))
                if not use_res and stats:
                    rows.append(_fused_fwd_pre_row(
                        fb, x, scale, shift, bits, thresh,
                        dict(c=c, h=h, w=w, n=n, mode=kind), peaks))
                if not use_res:
                    continue
                # the backward of a half with a residual (dres = g when the
                # stats cotangents are folded in)
                ct = 2 * cn + 8 * c if stats else 0
                add("fused_half_bf16_dgrad", kind + ("+stats" if stats
                                                    else ""),
                    fns[0][1], fns[1][1], lib_d,
                    6 * cn + 18 * c * c + 16 * c + bits_b + ct
                    + (2 * cn if stats else 0))
                rows[-1].update(_fused_dgrad_parts(
                    fb, (*cts[stats], wdg, x, scale, shift, bits), thresh,
                    h, w, stats, peaks))
                rows.append(_fused_dgrad_pre_row(
                    fb, cts[stats], stats, dict(c=c, h=h, w=w, n=n,
                                                mode=rows[-1]["mode"]),
                    peaks))
                add("fused_half_bf16_wgrad", kind + ("+stats" if stats
                                                    else ""),
                    fns[0][2], fns[1][2], lib_w,
                    4 * cn + 36 * c * c + 8 * c + bits_b + ct)
                wargs = (*cts[stats], x, scale, shift, bits)
                rows[-1].update(_fused_wgrad_parts(fb, wargs, thresh, h, w))
                rows.append(_fused_wgrad_pre_row(
                    fb, wargs, thresh, dict(c=c, h=h, w=w, n=n,
                                            mode=rows[-1]["mode"]),
                    flops_f32, bw))

        # the int8 core's kernels in seed mode: equal to their plain versions
        # and to themselves on the expanded bits; timed in both modes
        tile, btile = fb.lane_tile(h, w, n, c, c), fb.bwd_tile(h, w, n, c, c)
        plan = fb.fused_fwd_int8_plan(n, h, w, c, c)
        wdq, wsin = fb.quantize_pack_weights_dgrad(wt)
        expanded = fb.seed_bits(drops["seed"], c, n, 0, n)
        outs = {}
        for kind, bits in (("seed", drops["seed"]), ("bits", expanded)):
            def fq(bits=bits):
                return fb.fwd_int8_pre(x, scale, shift, bits, thresh=thresh,
                                       tile=tile, plan=plan)

            def bq(bits=bits):
                return fb.bwd_quantize(dy, None, None, None, x, scale, shift,
                                       bits, thresh=thresh, tile=btile,
                                       emit_res=False)

            g_q, g_amax = bq()[:2]

            def dg(bits=bits):
                return fb.dgrad_conv(g_q, g_amax, wdq, wsin, x, scale, shift,
                                     bits, thresh=thresh, tile=btile, h=h,
                                     w_img=w)

            outs[kind] = [*fq(), *bq()[:4], *dg()]
            plain = [*fb.fwd_int8_pre_plain(x, scale, shift, bits,
                                            thresh=thresh, tile=tile,
                                            plan=plan),
                     *fb.dgrad_conv_plain(g_q, g_amax, wdq, wsin, x, scale,
                                          shift, bits, thresh=thresh,
                                          tile=btile, h=h, w_img=w)]
            mine = outs[kind][:2] + outs[kind][6:]
            for i, (a, b) in enumerate(zip(mine, plain)):
                if i >= 3:  # d(scale), d(shift): f32 sums in another order
                    d = (a - b).abs().max().item()
                    assert d <= 1e-5 * b.abs().max().item(), (c, kind, i)
                else:
                    assert torch.equal(a, b), (c, kind, i)
            seed_rows.append(dict(
                name="int8 quantizers + dgrad", c=c, mode=kind,
                fwd_int8_pre_ms=time_ms(fq, 10),
                bwd_quantize_ms=time_ms(bq, 10), dgrad_conv_ms=time_ms(dg,
                                                                       10)))
        for a, b in zip(outs["seed"], outs["bits"]):
            assert torch.equal(a, b), c
        del x, res, drops, y0, dy, cts, expanded, outs
        torch.cuda.empty_cache()
    rows.append(_padded_half_row(fb, g, flops_bf16, bw))
    for r in rows:
        r["bound_ms"] = max(r["ops_ms"], r["bytes_ms"])
        r["bound_by"] = ("operations" if r["ops_ms"] >= r["bytes_ms"]
                         else "bytes")
    return rows, seed_rows


def _padded_half_row(fb, g, flops_bf16, bw):
    """The gate's C % 16 case, C = 48 without dropout at 32x32, batch 128:
    the differentiable ``fused_half`` zero-pads to 64 channels for the
    kernels; its output and gradients against the plain versions of the
    unpadded half on the same CUDA tensors."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import pack_weights

    dev = torch.device("cuda")
    c, h, w = 48, 32, 32
    n = BATCH * h * w

    def randn(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    x = randn(c, n).to(torch.bfloat16)
    wt = randn(c, c, 3, 3, s=(9 * c) ** -0.5)
    scale, shift = randn(c).abs() + 0.5, randn(c, s=0.3)
    res = randn(c, n).to(torch.bfloat16)
    dy = randn(c, n, s=1e-3).to(torch.bfloat16)
    dysum, dyssq = randn(c, s=1e-4), randn(c, s=1e-4)
    kw = dict(thresh=None, h=h, w_img=w)

    def kern():
        ins = [t.clone().requires_grad_() for t in (x, wt, scale, shift)]
        y, ys, yq = fb.fused_half(*ins, None, res, h=h, w_img=w)
        grads = torch.autograd.grad((y, ys, yq), ins, (dy, dysum, dyssq))
        return dict(y=y.detach(), ysum=ys.detach(), yssq=yq.detach(),
                    dx=grads[0], dw=grads[1], ds=grads[2], dt=grads[3])

    def plain():
        y, ys, yq = fb.fwd_bf16_plain(x, pack_weights(wt.to(torch.bfloat16)),
                                      scale, shift, None, res,
                                      want_stats=True, **kw)
        ct = (dy, y, dysum, dyssq)
        dx, ds, dt, _ = fb.dgrad_bf16_plain(
            *ct, fb.pack_weights_dgrad(wt.to(torch.bfloat16)), x, scale,
            shift, None, emit_res=False, **kw)
        dw = fb.wgrad_bf16_plain(*ct, x, scale, shift, None, **kw)
        return dict(y=y, ysum=ys, yssq=yq, dx=dx,
                    dw=dw.reshape(c, 3, 3, c).permute(0, 3, 1, 2), ds=ds,
                    dt=dt)

    err = _agree_bf16(kern(), plain(), ("padded half", c))
    return dict(name="fused_half (C=48, zero-padded to 64)", c=c, h=h, w=w,
                n=n, mode="none+res+stats", max_abs_err=err,
                ms=time_ms(kern, 5), plain_ms=time_ms(plain, 1),
                library_ms=None,
                ops_ms=3 * 2 * 9 * c * c * n / flops_bf16 * 1e3,
                bytes_ms=(12 * c * n) / bw * 1e3)


def live_bf16_check(rec, quant: bool):
    """Each recorded half through the kernels on its live tensors: the
    forward reproduces the live output and equals its plain version (the
    bf16 forward, or with ``quant`` the int8 one), and the bf16 backward
    equals its plain version on the live cotangents."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
    from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import pack_weights

    out = []
    for kind, r in sorted(rec.items()):
        x, wt, scale, shift, bits, res = r["args"]
        kw = r["kw"]
        h, w, stats = kw["h"], kw["w_img"], kw["want_stats"]
        thresh = (fb.dropout_thresh(kw["dropout_rate"]) if bits is not None
                  else None)
        c, n = x.shape
        if quant:
            tile = fb.lane_tile(h, w, n, c, c)
            wq, ws = fb.quantize_pack_weights(wt)
            args = (x, wq, ws, scale, shift, bits, res, thresh, tile, h, w,
                    stats)
            got = _half_fwd(fb, *args, plain=False)
            err = _agree(got, _half_fwd(fb, *args, plain=True),
                         ("live fwd", kind))
        else:
            wp = pack_weights(wt.to(torch.bfloat16))
            fns = [_bf16_fns(fb, x, wp, None, scale, shift, bits, res, stats,
                             (None,) * 4, thresh, h, w, plain)
                   for plain in (False, True)]
            got = fns[0][0]()
            err = _agree_bf16(got, fns[1][0](), ("live fwd", kind))
        assert torch.equal(got["y"], r["out"][0]), kind
        ct = ((r["dy"].contiguous(), r["out"][0], r["dysum"], r["dyssq"])
              if stats else (r["dy"].contiguous(), None, None, None))
        wdg = fb.pack_weights_dgrad(wt.to(torch.bfloat16))
        fns = [_bf16_fns(fb, x, None, wdg, scale, shift, bits, res, stats,
                         ct, thresh, h, w, plain) for plain in (False, True)]
        for i, what in ((1, "live dgrad"), (2, "live wgrad")):
            err = max(err, _agree_bf16(fns[0][i](), fns[1][i](),
                                       (what, kind)))
        out.append(dict(kind=kind, c=c, n=n, h=h, w=w, want_stats=stats,
                        residual=res is not None, max_abs_err=err))
    return out


# the bf16 forward's part keys summed over a step (``_fused_fwd_parts``)
FWD_PART_KEYS = ("pre_bound_ms", "gemm_bound_ms", "issued_macs",
                 "useful_macs")


def _bf16_mix(rows, name, halves):
    """Phase 12's per-call numbers of kernel ``name`` summed over
    ``halves`` (count per (width, residual, BatchNorm sums, bits mode));
    the backward rows were taken with a residual."""
    def mode(res, stats, kind):
        if name == "fused_half_bf16_fwd":
            return kind + ("+res" if res else "") + (
                "+stats" if stats else "")
        if name == "fused_half_bf16_fwd.pre":
            return kind
        return kind + ("+stats" if stats else "")

    mine = [r for r in rows if r["name"] == name]
    mix = [(next(r for r in mine if r["c"] == c
                 and r["mode"] == mode(res, stats, kind)), cnt)
           for (c, res, stats, kind), cnt in halves.items()]
    # keys every row has a number for (the forward's and the wgrad's
    # parts; no library call for a prepass)
    return {k: sum(r[k] * cnt for r, cnt in mix)
            for k in ("ms", "plain_ms", "library_ms", "ops_ms", "bytes_ms",
                      "pre_ms", "gemm_ms") + FWD_PART_KEYS
            if all(r.get(k) is not None for r, _ in mix)}


def bf16_summary(rows, fused, qat, fused_halves, qat_halves):
    """One entry per bf16 kernel: the launches of the two training runs
    that use it (phases 13 and 14), and the device time per train step:
    phase 12's per-call times summed over the halves one step ran (the
    forward over the fused-bf16 step's, the backward over the QAT step's)."""
    out = []
    for name in BF16_NAMES + ("fused_half_bf16_fwd.pre",
                              "fused_half_bf16_dgrad.pre",
                              "fused_half_bf16_wgrad.pre"):
        fwd = name.startswith("fused_half_bf16_fwd")
        tot = _bf16_mix(rows, name, fused_halves if fwd else qat_halves)
        runs = {"fused_bf16": fused["launches"].get(name, 0),
                "qat_inkernel_dropout": qat["launches"].get(name, 0)}
        if name in ("fused_half_bf16_dgrad", "fused_half_bf16_wgrad"):
            runs.update({f"{run}{part}": r["launches"].get(name + part, 0)
                         for run, r in (("fused_bf16", fused),
                                        ("qat_inkernel_dropout", qat))
                         for part in (".pre", ".sum")})
        mine = [r for r in rows if r["name"] == name]
        out.append(dict(
            name=name, route="cuda", source=SOURCES.get(name, BF16_SOURCE),
            replaces=REPLACES[name], launches=sum(
                v for k, v in runs.items() if "." not in k),
            split_launches=runs,
            seed_launches=qat["seed_launches"].get(name, 0),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=max(tot["ops_ms"], tot["bytes_ms"]),
            bound_by=("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                      else "bytes"),
            library_ms=tot.get("library_ms"),
            **{k: tot[k] for k in ("pre_ms", "gemm_ms") + FWD_PART_KEYS
               if k in tot},
            per=("fused-bf16" if fwd else "QAT + in-kernel dropout")
            + f" train step at batch {BATCH} (ms per call summed over the "
              "step's halves; launches over both runs)",
            stages=[{k: r[k] for k in ("c", "h", "w", "mode", "ms",
                                       "plain_ms", "library_ms", "bound_ms",
                                       "bound_by", "max_abs_err")}
                    for r in mine]))
    return out


# --- phases 15 and 16: lane-through stage transitions --------------------------

TR_SOURCE = "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/transition.cu"
TR_NAMES = ("transition_fwd", "transition_fwd.pre", "transition_bwd",
            "transition_dgrad", "transition_wgrad_s8", "transition_wgrad_tma")
# both bodies' wgrads and dWp: their own binding file
TR_WGRAD_SOURCE = ("pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/"
                   "transition_wgrad.cu")
# the forward GEMM's mainloop, shared with the NV halves' int8 forward; the
# FQT wgrad's; the TMA wgrad's, shared with conv3x3_same's wgrad
TR_MAINLOOP = {"transition_fwd":
               "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/fwd_staged_s8.cuh",
               "transition_dgrad":
               "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/fwd_wgmma_s8.cuh",
               "transition_wgrad_s8":
               "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/wgrad_wgmma_s8.cuh",
               "transition_wgrad_tma": SAME_SOURCE}
# (stage, cin, cout, h, w): the inputs of WRN-28-10's two stage transitions
TR_SHAPES = [(2, 160, 320, 32, 32), (3, 320, 640, 16, 16)]
# the lane step (FQT or QAT) whose rows each kernel's summary sums: the
# recipe's case (projection, bits); the FQT wgrad is dW alone, the TMA
# wgrad the straight-through dW and dWp
TR_STEP_MODE = {"transition_fwd": ("FQT", ("proj+bits",)),
                "transition_fwd.pre": ("FQT", ("proj+bits",)),
                "transition_bwd": ("FQT", ("fqt",)),
                "transition_dgrad": ("FQT", ("fqt+proj",)),
                "transition_wgrad_s8": ("FQT", ("fqt",)),
                "transition_wgrad_tma": ("QAT", ("qat", "proj"))}


def _agree_tr(got: dict, want: dict, tol: dict, what) -> float:
    """Kernel outputs against the plain version's, key by key: ``"eq"``
    equal, ``"ulp"`` within 2 bf16 ulps of the tensor's largest value (bf16
    products summed by the tensor cores in f32 against float64), a float
    within that fraction of the largest value (f32 sums: 1e-5, or 1e-4
    over bf16 tensor-core accumulators). Returns the max abs difference."""
    import torch

    err = 0.0
    for k, ref in want.items():
        out = got[k]
        assert out.dtype == ref.dtype and out.shape == ref.shape, (what, k)
        d = (out.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        if tol[k] == "eq":
            assert torch.equal(out, ref), (what, k, d)
        elif tol[k] == "ulp":
            assert d <= 2 * 2.0 ** (math.floor(math.log2(top)) - 7), \
                (what, k, d, top)
        else:
            assert d <= tol[k] * top, (what, k, d, top)
        err = max(err, d)
    return err


def cudnn_s2_times(g, cin, cout, h, w, batch=BATCH):
    """cuDNN bf16 channels-last stride-2 3x3 conv plus the 1x1 stride-2
    projection at batch ``batch``: ms per call of the forward, the input
    gradient and the weight gradient, and the weight gradient of each
    alone (``wgrad3``, ``wgrad1``)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    dev = torch.device("cuda")

    def rn(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(
            torch.bfloat16).to(memory_format=torch.channels_last)

    x4, w4, wp4 = rn(batch, cin, h, w), rn(cout, cin, 3, 3), rn(cout, cin,
                                                                  1, 1)
    dy4 = rn(batch, cout, h // 2, w // 2)
    return dict(
        fwd=time_ms(lambda: (F.conv2d(x4, w4, stride=2, padding=1),
                             F.conv2d(x4, wp4, stride=2)), 10),
        dgrad=time_ms(lambda: (
            conv2d_input(x4.shape, w4, dy4, stride=2, padding=1),
            conv2d_input(x4.shape, wp4, dy4, stride=2)), 10),
        wgrad=time_ms(lambda: (
            conv2d_weight(x4, w4.shape, dy4, stride=2, padding=1),
            conv2d_weight(x4, wp4.shape, dy4, stride=2)), 10),
        wgrad3=time_ms(lambda: conv2d_weight(x4, w4.shape, dy4, stride=2,
                                             padding=1), 10),
        wgrad1=time_ms(lambda: conv2d_weight(x4, wp4.shape, dy4, stride=2),
                       10))


def dgrad_parts(tr, dargs, tol, quant, thresh, tile, h, w, bw):
    """The transition dgrad's parts on its layout: dx and the sums
    bit-equal over two calls; the prepass (g and, with a projection, dres
    into their slabs) byte for byte and the GEMM + sum against their plain
    versions, each timed beside its plain version and bound; the dgrad's
    device time split by kernel (prepass, GEMM, sum) and the GEMM's
    TOP/s."""
    import torch

    g, g_amax, w_dg, ws_in, x, scale, shift, bits, dres, wpt = dargs
    kw = dict(thresh=thresh, tile=tile, h=h, w_img=w)
    first, second = tr.dgrad(*dargs, **kw), tr.dgrad(*dargs, **kw)
    for k, a, b_ in zip(("dx", "ds", "dt"), first, second):
        assert torch.equal(a, b_), ("transition_dgrad", k)
    cin, n = x.shape
    cout, n_out = g.shape
    lay = tr.transition_dgrad_layout(n, h, w, cin, cout, tile, quant)
    d_in = dres if wpt is not None else None
    slabs = tr.dgrad_pre(g, d_in, lay)
    want = tr.dgrad_pre_plain(g, d_in, lay)
    for a, b_ in zip(slabs, want):
        assert (a is None and b_ is None) or torch.equal(a, b_), (
            "transition_dgrad.pre", quant)
    gargs = (*slabs, g_amax, w_dg, ws_in, x, scale, shift, bits, dres, wpt)
    _agree_tr(dict(zip(("dx", "ds", "dt"), tr.dgrad_gemm(
        *gargs, thresh=thresh, lay=lay))), dict(zip(
            ("dx", "ds", "dt"), tr.dgrad_gemm_plain(
                *gargs, thresh=thresh, lay=lay))), tol,
        ("transition_dgrad gemm", quant))
    el = g.element_size()
    out = dict(
        pre_ms=time_ms(lambda: tr.dgrad_pre(g, d_in, lay), 10),
        pre_plain_ms=time_ms(lambda: tr.dgrad_pre_plain(g, d_in, lay), 1),
        # g (and dres) read, their live slab rows written
        pre_bound_ms=2 * (el + (2 if d_in is not None else 0)) * cout
        * n_out / bw * 1e3,
        gemm_ms=time_ms(lambda: tr.dgrad_gemm(*gargs, thresh=thresh,
                                              lay=lay), 10),
        gemm_plain_ms=time_ms(lambda: tr.dgrad_gemm_plain(
            *gargs, thresh=thresh, lay=lay), 1),
        tiles=lay.tiles, cp=lay.cp,
        dev_ms=device_ms(lambda: tr.dgrad(*dargs, **kw), 10))
    parts = ("dgrad_pre_kernel", "dgrad_kernel<", "TransitionDgradSum")
    split = kernel_split_ms(lambda: tr.dgrad(*dargs, **kw), 10, parts,
                            need=parts)
    if split:
        out.update(pre_dev_ms=split["dgrad_pre_kernel"],
                   gemm_dev_ms=split["dgrad_kernel<"],
                   sum_dev_ms=split["TransitionDgradSum"])
        out["gemm_tops"] = (2 * (9 + (wpt is not None)) * cin * cout
                            * n_out / out["gemm_dev_ms"] / 1e9)
    del first, second, slabs, want
    return out


# (batch, h, w, Cin, Cout) of the operand passes' row at output rows off 8
# pixels: a 24x24 input (rows of 12), three scale groups
TR_OPERAND_OFF8 = (24, 24, 24, 32, 64)


def operand_rows(tr, stage, cin, cout, h, w, batch, ct, scb, amax_f, thresh,
                 tile, bw, mode_sfx=""):
    """Rows of the backward's two operand passes at one shape: the FQT
    operands (``bwd_quantize``, one launch, the activation at the
    forward's group absmax ``amax_f``) and the straight-through fold
    (``bwd_fold``), each against its plain version (every output equal),
    bit-equal over two calls, timed beside its plain version and its
    bound (bytes: each operand read once, each output written once), also
    in device time; the fold, where output rows hold whole units of 8
    lanes, also with each lane loading its own input pair (``lanes``,
    equal and timed; the FQT pass always loads so)."""
    import torch

    n = batch * h * w
    n_out = n // 4
    kw = dict(h=h, w_img=w)
    q_keys = ("g_q", "g_amax", "d_q", "d_amax", "x_ee")
    f_keys = ("g", "d", "x_ee")
    passes = (
        ("fqt", q_keys,
         lambda: tr.bwd_quantize(*ct, *scb, amax_f, thresh=thresh, tile=tile,
                                 **kw),
         lambda: tr.bwd_quantize_plain(*ct, *scb, thresh=thresh, tile=tile,
                                       **kw),
         # dz, z, x and the bits in; g_q, d_q's planes and x_ee out
         4 * cout * n_out + 3 * cin * n + cout * n_out + cin * n
         + cin * n // 2),
        ("qat", f_keys,
         lambda: tr.bwd_fold(*ct, *scb, thresh=thresh, **kw),
         lambda: tr.bwd_fold_plain(*ct, *scb, thresh=thresh, **kw),
         # dz, z, x and the bits in; g, d's planes and x_ee out
         6 * cout * n_out + 5 * cin * n + cin * n // 2))
    out = []
    for mode, keys, kern, plain, byts in passes:
        want = dict(zip(keys, plain()))
        got = kern()
        err = _agree_tr(dict(zip(keys, got)), want, dict.fromkeys(keys, "eq"),
                        ("transition_bwd", stage, mode))
        for a, b_ in zip(got, kern()):
            assert torch.equal(a, b_), ("transition_bwd", stage, mode)
        if mode == "fqt":
            assert got[3] is amax_f, "bwd_quantize returns the forward's amax"
        row = dict(name="transition_bwd", stage=stage, cin=cin, cout=cout,
                   h=h, w=w, n=n, mode=mode + mode_sfx, tile=tile,
                   max_abs_err=err, ms=time_ms(kern, 10),
                   plain_ms=time_ms(plain, 1), library_ms=None, ops_ms=0.0,
                   bytes_ms=byts / bw * 1e3, dev_ms=device_ms(kern, 10),
                   rows=mode == "qat" and tr.operand_rows(w))
        if mode == "qat" and tr.operand_rows(w):
            tr._fold_rows = False   # each lane loads its own pair
            try:
                _agree_tr(dict(zip(keys, kern())), want,
                          dict.fromkeys(keys, "eq"),
                          ("transition_bwd lanes", stage, mode))
                row["lanes_ms"] = time_ms(kern, 10)
            finally:
                tr._fold_rows = None
        out.append(row)
        del want, got
    return out


def operand_rows_off8(tr, fb, bw):
    """The operand passes' rows at TR_OPERAND_OFF8 (output rows of 12
    pixels: each lane loads its own input pair), at least three scale
    groups, the dropout bits on; modes ``fqt@24x24`` and ``qat@24x24``
    (the step sums leave them out)."""
    import torch

    b, h, w, cin, cout = TR_OPERAND_OFF8
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(24)
    n, n_out = b * h * w, b * h * w // 4

    def randn(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    x = randn(cin, n).to(torch.bfloat16)
    scale, shift = randn(cin).abs() + 0.5, randn(cin, s=0.3)
    bits = torch.randint(0, 256, (cin, n), device=dev, generator=g,
                         dtype=torch.uint8)
    thresh = fb.dropout_thresh(0.3)
    tile = tr.transition_tile(h // 2, w // 2, n_out, cin, cout)
    assert n_out // tile >= 3 and not tr.operand_rows(w)
    lay = tr.transition_fwd_layout(n, h, w, cin, cout, tile)
    scb = (x, scale, shift, bits)
    amax_f = tr.fwd_pre(*scb, tr.fwd_amax(*scb, thresh=thresh, tile=tile),
                        thresh=thresh, lay=lay)[2]
    ct = (randn(cout, n_out, s=1e-3).to(torch.bfloat16),
          randn(cout, n_out).to(torch.bfloat16), randn(cout, s=1e-4),
          randn(cout, s=1e-4))
    return operand_rows(tr, f"{h}x{w}", cin, cout, h, w, b, ct, scb, amax_f,
                        thresh, tile, bw, mode_sfx=f"@{h}x{w}")


def transition_kernel_phase(peaks, shapes=TR_SHAPES, batch=BATCH):
    """Rows per (transition kernel, stage, mode): max error against the
    plain version on the same CUDA tensors, and the kernel / plain / cuDNN
    bf16 / bound times of one call."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr

    flops_bf16, ops_int8, bw, flops_f32 = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []
    bf = torch.bfloat16

    def randn(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    for stage, cin, cout, h, w in shapes:
        oh, ow = h // 2, w // 2
        n, n_out = batch * h * w, batch * oh * ow
        x = randn(cin, n).to(bf)
        w1 = randn(cout, cin, 3, 3, s=(9 * cin) ** -0.5)
        wp = randn(cout, cin, s=cin ** -0.5).to(bf)
        wpt = wp.t().contiguous()
        scale, shift = randn(cin).abs() + 0.5, randn(cin, s=0.3)
        bits = tr.parity_unpack(torch.randint(
            0, 256, (4 * cin, n_out), device=dev, generator=g,
            dtype=torch.uint8), h, w)
        thresh = fb.dropout_thresh(0.3)
        tile = tr.transition_tile(oh, ow, n_out, cin, cout)
        wq, ws = fb.quantize_pack_weights(w1)
        wdq, wsin = tr.quant_pack_w_dgrad(w1)
        wdb = tr.pack_w_dgrad(w1.to(bf))
        lib = cudnn_s2_times(g, cin, cout, h, w, batch)
        macs, pmacs = 9 * cin * cout * n_out, cin * cout * n_out
        kw = dict(h=h, w_img=w)
        optas = (True, False) if cout >= cin and stage == shapes[0][0] \
            else (False,)

        def add(name, mode, kern, plain, tol, lib_ms, byts, ops_ms):
            err = _agree_tr(kern(), plain(), tol, (name, stage, mode))
            rows.append(dict(
                name=name, stage=stage, cin=cin, cout=cout, h=h, w=w,
                n=n, mode=mode, tile=tile, max_abs_err=err,
                ms=time_ms(kern, 10), plain_ms=time_ms(plain, 1),
                library_ms=lib_ms, ops_ms=ops_ms,
                bytes_ms=byts / bw * 1e3))

        lay = tr.transition_fwd_layout(n, h, w, cin, cout, tile)
        # the bytes the forward's function needs between its prepass and
        # its mainloop: the int8 codes of d and the bf16 even-even plane,
        # unpadded (the slabs' pad rows, columns, guards, tail and pad
        # channels are this design's)
        need_sb = cin * n + 2 * cin * n // 4

        def fwd(bits_, wp_, plain):
            """The forward's outputs; plain: the layout-independent
            reference (the quantizer, then the direct stride-2 conv)."""
            th = thresh if bits_ is not None else None
            if plain:
                d_q, amax = fb.fwd_quantize_plain(x, scale, shift, bits_,
                                                  thresh=th, tile=4 * tile)
                z, zs, zq, res = tr.fwd_conv_plain(d_q, amax, wq, ws, x, wp_,
                                                   tile=tile, **kw)
                return dict(amax=amax, z=z, zsum=zs, zssq=zq, res=res)
            part = tr.fwd_amax(x, scale, shift, bits_, thresh=th, tile=tile)
            slab, ee, amax = tr.fwd_pre(x, scale, shift, bits_, part,
                                        thresh=th, lay=lay)
            z, zs, zq, res = tr.fwd_gemm(slab, ee, amax, wq, ws, wp_, lay)
            return dict(slab=slab, ee=ee, amax=amax, z=z, zsum=zs, zssq=zq,
                        res=res)

        def fwd_parts(bits_, wp_):
            """The forward's z, res and sums bit-equal over two calls; its
            three parts timed apart beside their plain versions and
            bounds: the amax pass (x and the bits in), the prepass (x and
            the bits in, the codes and the even-even plane out), the
            mainloop + ordered sum (those and the weights in, z and res
            out, or its operations)."""
            first, second = fwd(bits_, wp_, False), fwd(bits_, wp_, False)
            for k in ("z", "zsum", "zssq", "res"):
                assert torch.equal(first[k], second[k]), (
                    "transition_fwd", stage, k)
            th = thresh if bits_ is not None else None
            slab, ee, amax = first["slab"], first["ee"], first["amax"]
            part = tr.fwd_amax(x, scale, shift, bits_, thresh=th, tile=tile)
            xb = 2 * cin * n + (cin * n if bits_ is not None else 0)
            sb = slab.numel() + 2 * ee.numel()
            wb = 9 * cin * cout + (2 * cin * cout if wp_ is not None else 0)
            out = {}
            for key, (kern, plain) in dict(
                    amax=(lambda: tr.fwd_amax(x, scale, shift, bits_,
                                              thresh=th, tile=tile),
                          lambda: tr.fwd_amax_plain(x, scale, shift, bits_,
                                                    thresh=th, tile=tile)),
                    pre=(lambda: tr.fwd_pre(x, scale, shift, bits_, part,
                                            thresh=th, lay=lay),
                         lambda: tr.fwd_pre_plain(x, scale, shift, bits_,
                                                  part, thresh=th, lay=lay)),
                    gemm=(lambda: tr.fwd_gemm(slab, ee, amax, wq, ws, wp_,
                                              lay),
                          lambda: tr.fwd_gemm_plain(slab, ee, amax, wq, ws,
                                                    wp_, lay))).items():
                out[f"{key}_ms"] = time_ms(kern, 10)
                out[f"{key}_plain_ms"] = time_ms(plain, 1)
            out["amax_bound_ms"] = xb / bw * 1e3
            out["pre_bound_ms"] = (xb + need_sb) / bw * 1e3
            out["gemm_bound_ms"] = max(
                (need_sb + wb + 4 * cout * n_out) / bw,
                2 * macs / ops_int8 + (2 * pmacs / flops_bf16
                                       if wp_ is not None else 0)) * 1e3
            out["layout"] = dict(cp=lay.cp, bk=lay.bk, cpb=lay.cpb,
                                 groups=lay.groups, tiles=lay.tiles,
                                 m_rows=lay.tiles * lay.bm, live_rows=n_out,
                                 slab_mb=sb / 1e6, need_mb=need_sb / 1e6)
            return out

        fwd_tol = dict(amax="eq", z="eq", zsum=1e-5, zssq=1e-5, res="ulp")
        for opt_a in optas:
            for b_ in ((bits, None) if not opt_a else (bits,)):
                wp_ = None if opt_a else wp
                mode = ("optA" if opt_a else "proj") + (
                    "+bits" if b_ is not None else "")
                add("transition_fwd", mode,
                    lambda b_=b_, wp_=wp_: fwd(b_, wp_, False),
                    lambda b_=b_, wp_=wp_: fwd(b_, wp_, True),
                    dict(fwd_tol, res="eq" if opt_a else "ulp"),
                    lib["fwd"] if not opt_a else None,
                    2 * cin * n + (cin * n if b_ is not None else 0)
                    + 4 * cout * n_out + 9 * cin * cout
                    + (2 * cin * cout if wp_ is not None else 0),
                    2 * macs / ops_int8 * 1e3
                    + (2 * pmacs / flops_bf16 * 1e3 if wp_ is not None
                       else 0))
                rows[-1].update(fwd_parts(b_, wp_))
                th = thresh if b_ is not None else None
                part = tr.fwd_amax(x, scale, shift, b_, thresh=th, tile=tile)
                pre_out = tr.fwd_pre(x, scale, shift, b_, part, thresh=th,
                                     lay=lay)
                add("transition_fwd.pre", mode,
                    lambda b_=b_, th=th, part=part: dict(zip(
                        ("slab", "ee", "amax"), tr.fwd_pre(
                            x, scale, shift, b_, part, thresh=th, lay=lay))),
                    lambda b_=b_, th=th, part=part: dict(zip(
                        ("slab", "ee", "amax"), tr.fwd_pre_plain(
                            x, scale, shift, b_, part, thresh=th, lay=lay))),
                    dict(slab="eq", ee="eq", amax="eq"), None,
                    2 * cin * n + (cin * n if b_ is not None else 0)
                    + need_sb, 4 * cin * n / flops_f32 * 1e3)
                del part, pre_out

        z = fwd(bits, wp, True)["z"]
        dz = randn(cout, n_out, s=1e-3).to(bf)
        dzsum, dzssq = randn(cout, s=1e-4), randn(cout, s=1e-4)
        dres = randn(cout, n_out, s=1e-3).to(bf)
        ct = (dz, z, dzsum, dzssq)
        scb = (x, scale, shift, bits)

        # FQT: the operands in one launch, the activation at the forward
        # kernel's group absmax (returned as d_amax, which must equal the
        # plain version's own); then the int8 dgrad and wgrad on the plain
        # version's operands (equal to the kernel's, checked first); x_ee,
        # x's even-even plane, is dWp's operand
        amax_f = fwd(bits, wp, False)["amax"]
        ops_p = tr.bwd_quantize_plain(*ct, *scb, thresh=thresh, tile=tile,
                                      **kw)
        rows.extend(operand_rows(tr, stage, cin, cout, h, w, batch, ct, scb,
                                 amax_f, thresh, tile, bw))
        g_q, g_amax, d_q, d_amax, _ = ops_p
        gb, db, xee = tr.bwd_fold_plain(*ct, *scb, thresh=thresh, **kw)
        for opt_a in optas:
            wpt_ = None if opt_a else wpt
            sfx = "+optA" if opt_a else "+proj"
            for body, args, ops_ms, gbytes in (
                    ("fqt", (g_q, g_amax, wdq, wsin), 2 * macs / ops_int8,
                     cout * n_out + 9 * cin * cout),
                    ("qat", (gb, None, wdb, None), 2 * macs / flops_bf16,
                     2 * cout * n_out + 18 * cin * cout)):
                dargs = (*args, *scb, dres, wpt_)
                dtol = dict(dx="ulp", ds=1e-5 if body == "fqt" else 1e-4,
                            dt=1e-5 if body == "fqt" else 1e-4)
                add("transition_dgrad", body + sfx,
                    lambda dargs=dargs: dict(zip(("dx", "ds", "dt"), tr.dgrad(
                        *dargs, thresh=thresh, tile=tile, **kw))),
                    lambda dargs=dargs: dict(zip(
                        ("dx", "ds", "dt"), tr.dgrad_plain(
                            *dargs, thresh=thresh, tile=tile, **kw))),
                    dtol, lib["dgrad"] if not opt_a else None,
                    gbytes + 5 * cin * n + 2 * cout * n_out
                    + (2 * cin * cout if wpt_ is not None else 0),
                    (ops_ms + (2 * pmacs / flops_bf16 if wpt_ is not None
                               else 0)) * 1e3)
                rows[-1].update(dgrad_parts(
                    tr, dargs, dtol, body == "fqt", thresh, tile, h, w,
                    bw))
            if opt_a:
                continue
            # the FQT dW on the TMA + s8 wgmma wgrad: one launch, equal to
            # the plain version and bit-equal over two calls, also in
            # device time and TOP/s; bytes: g_q and d_q's planes in, dW out
            def fqt_dw():
                return tr.wgrad(g_q, g_amax, d_q, d_amax, tile=tile, **kw)

            add("transition_wgrad_s8", "fqt", lambda: dict(dw=fqt_dw()),
                lambda: dict(dw=tr.wgrad_plain(g_q, g_amax, d_q, d_amax,
                                               tile=tile, **kw)),
                dict(dw="eq"), lib["wgrad3"],
                cout * n_out + cin * n + 36 * cin * cout,
                2 * macs / ops_int8 * 1e3)
            first = fqt_dw()
            assert torch.equal(first, fqt_dw()), (
                "transition_wgrad_s8", stage)
            r = rows[-1]
            r["dev_ms"] = device_ms(fqt_dw, 10)
            r["tops"] = 2 * macs / r["ms"] / 1e9
            r["plan"] = list(tr.wgrad_s8_plan(cin, cout, n_out, h, w, tile))
            del first
            # the straight-through dW and dWp on the TMA wgrad: each
            # bit-equal over two calls, also in device time and TFLOP/s
            for mode, key, fn, plain, args, work, lib_ms, byts in (
                    ("qat", "dw", tr.wgrad_bf16, tr.wgrad_bf16_plain,
                     (gb, db), macs, lib["wgrad3"],
                     2 * cout * n_out + 2 * cin * n + 36 * cin * cout),
                    ("proj", "dwp", tr.wgrad_proj, tr.wgrad_proj_plain,
                     (dres, xee), pmacs, lib["wgrad1"],
                     2 * cout * n_out + 2 * cin * n_out + 4 * cin * cout)):
                add("transition_wgrad_tma", mode,
                    lambda fn=fn, key=key, args=args: {key: fn(*args, **kw)},
                    lambda plain=plain, key=key, args=args: {
                        key: plain(*args, **kw)},
                    {key: 1e-4}, lib_ms, byts, 2 * work / flops_bf16 * 1e3)
                first = fn(*args, **kw)
                assert torch.equal(first, fn(*args, **kw)), (
                    "transition_wgrad_tma", stage, mode)
                r = rows[-1]
                r["dev_ms"] = device_ms(lambda fn=fn, args=args: fn(
                    *args, **kw), 10)
                r["tflops"] = 2 * work / r["ms"] / 1e9
                r["plan"] = list(tr.wgrad_tma_plan(
                    9 if mode == "qat" else 1, cin, cout, n_out, h, w))
                del first
        del x, bits, z, dz, dres, ops_p, gb, db, xee, g_q, d_q, amax_f
        torch.cuda.empty_cache()
    rows.extend(operand_rows_off8(tr, fb, bw))
    for r in rows:
        r["bound_ms"] = max(r["ops_ms"], r["bytes_ms"])
        r["bound_by"] = ("operations" if r["ops_ms"] >= r["bytes_ms"]
                         else "bytes")
    return rows


class RecordTransition:
    """Around the first train step of a lane-transition run: count the
    step's transition halves and the trunk's layout conversions (the stem's
    NHWC -> lane entry, a closing run, a block's own conversions), and
    record the first transition half: its live inputs and, through
    gradient hooks, its live cotangents (phase 16)."""

    def __init__(self):
        self.rec = None
        self.calls = 0
        self.layouts = {}

    def __enter__(self):
        from pytorch_ddp_resnet_tpu_torch.models import blocks, layers
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr

        self.patched = []

        def patch(mod, name, wrap):
            orig = getattr(mod, name)
            self.patched.append((mod, name, orig))
            setattr(mod, name, wrap(orig))

        def counting(key):
            def wrap(orig):
                def fn(*a, **k):
                    self.layouts[key] = self.layouts.get(key, 0) + 1
                    return orig(*a, **k)
                return fn
            return wrap

        def clone(t):
            return None if t is None else t.detach().clone()

        def recording(orig):
            def fn(x_cs, w1, wp, scale, shift, bits=None, **kw):
                out = orig(x_cs, w1, wp, scale, shift, bits, **kw)
                self.calls += 1
                if self.rec is None:
                    r = self.rec = dict(
                        args=[clone(t) for t in (x_cs, w1, wp, scale, shift,
                                                 bits)], kw=kw,
                        out=[clone(t) for t in out])
                    for name, t in zip(("dz", "dzsum", "dzssq", "dres"), out):
                        t.register_hook(lambda gr, name=name, r=r:
                                        r.__setitem__(name, clone(gr)))
                return out
            return fn

        patch(layers, "to_lane", counting("layers.to_lane"))
        patch(layers, "_delane", counting("layers._delane"))
        patch(blocks, "to_lane", counting("blocks.to_lane"))
        patch(blocks, "from_lane", counting("blocks.from_lane"))
        patch(tr, "transition_half_int8", recording)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self.patched):
            setattr(mod, name, orig)
        return False


def _tr_stages(tr, fb, x, w1, wp, scale, shift, bits, thresh, h, w, ct,
               quant_bwd, plain):
    """The transition half's stages as dicts: the forward (amax pass,
    prepass, mainloop; plain: the prepass's slabs, and z, res and the sums
    from the quantizer and the direct stride-2 conv, which do not depend
    on the slabs' layout) and the backward of one body (quantizers or
    fold, dgrad, wgrad and dWp), through the kernels or the plain
    versions."""
    cin, n = x.shape
    cout = w1.shape[0]
    tile = tr.transition_tile(h // 2, w // 2, n // 4, cin, cout)
    kw = dict(h=h, w_img=w)
    wq, ws = fb.quantize_pack_weights(w1)
    wp_c = None if wp is None else wp.reshape(cout, cin).to(
        x.dtype).contiguous()
    lay = tr.transition_fwd_layout(n, h, w, cin, cout, tile)
    if plain:   # the slabs, and the layout-independent z, res and sums
        slab, ee, _ = tr.fwd_pre_plain(
            x, scale, shift, bits, tr.fwd_amax_plain(
                x, scale, shift, bits, thresh=thresh, tile=tile),
            thresh=thresh, lay=lay)
        d_q, amax = fb.fwd_quantize_plain(x, scale, shift, bits,
                                          thresh=thresh, tile=4 * tile)
        z, zs, zq, res = tr.fwd_conv_plain(d_q, amax, wq, ws, x, wp_c,
                                           tile=tile, **kw)
        del d_q
    else:
        part = tr.fwd_amax(x, scale, shift, bits, thresh=thresh, tile=tile)
        slab, ee, amax = tr.fwd_pre(x, scale, shift, bits, part,
                                    thresh=thresh, lay=lay)
        z, zs, zq, res = tr.fwd_gemm(slab, ee, amax, wq, ws, wp_c, lay)
    out = dict(slab=slab, ee=ee, amax=amax, z=z, zsum=zs, zssq=zq, res=res)
    wpt = None if wp is None else wp_c.t().contiguous()
    dz, dzsum, dzssq, dres = ct
    cts = (dz, z, dzsum, dzssq)
    if quant_bwd:   # the card's quantizer takes the forward's absmax
        g, g_amax, d_q2, d_amax, x_ee = (
            tr.bwd_quantize_plain(*cts, x, scale, shift, bits,
                                  thresh=thresh, tile=tile, **kw) if plain
            else tr.bwd_quantize(*cts, x, scale, shift, bits, amax,
                                 thresh=thresh, tile=tile, **kw))
        out.update(g_q=g, g_amax=g_amax, d_q2=d_q2, d_amax=d_amax, x_ee=x_ee)
        w_dg, ws_in = tr.quant_pack_w_dgrad(w1)
    else:
        g, d, x_ee = (tr.bwd_fold_plain if plain else tr.bwd_fold)(
            *cts, x, scale, shift, bits, thresh=thresh, **kw)
        out.update(g=g, d=d, x_ee=x_ee)
        g_amax, w_dg, ws_in = None, tr.pack_w_dgrad(w1.to(x.dtype)), None
    dx, ds, dt = (tr.dgrad_plain if plain else tr.dgrad)(
        g, g_amax, w_dg, ws_in, x, scale, shift, bits, dres, wpt,
        thresh=thresh, tile=tile, **kw)
    out.update(dx=dx, ds=ds, dt=dt)
    if quant_bwd:
        out["dw"] = (tr.wgrad_plain if plain else tr.wgrad)(
            g, g_amax, d_q2, d_amax, tile=tile, **kw)
    else:
        out["dw"] = (tr.wgrad_bf16_plain if plain else tr.wgrad_bf16)(
            g, d, **kw)
    if wp is not None:
        out["dwp"] = (tr.wgrad_proj_plain if plain else tr.wgrad_proj)(
            dres, x_ee, **kw)
    return out


def live_transition_check(rec, quant_bwd: bool):
    """The recorded transition half through the kernels on its live
    tensors: the forward reproduces the live outputs, and every stage
    equals its plain version (``_agree_tr``'s tolerances)."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr

    x, w1, wp, scale, shift, bits = rec["args"]
    kw = rec["kw"]
    h, w = kw["h"], kw["w_img"]
    thresh = fb.dropout_thresh(kw["dropout_rate"])
    bits = tr.parity_unpack(bits, h, w)
    ct = (rec["dz"].contiguous(), rec["dzsum"], rec["dzssq"],
          rec["dres"].contiguous())
    got, want = (_tr_stages(tr, fb, x, w1, wp, scale, shift, bits, thresh,
                            h, w, ct, quant_bwd, plain)
                 for plain in (False, True))
    for name, live in zip(("z", "zsum", "zssq", "res"), rec["out"]):
        assert torch.equal(got[name], live), name
    tol = dict(slab="eq", ee="eq", amax="eq", z="eq", zsum=1e-5, zssq=1e-5,
               res="ulp",
               g_q="eq", g_amax="eq", d_q2="eq", d_amax="eq", g="eq", d="eq",
               x_ee="eq",
               dx="ulp", ds=1e-5 if quant_bwd else 1e-4,
               dt=1e-5 if quant_bwd else 1e-4,
               dw="eq" if quant_bwd else 1e-4, dwp=1e-4)
    err = _agree_tr(got, want, tol, ("live transition", quant_bwd))
    return dict(cin=x.shape[0], cout=w1.shape[0], n=x.shape[1], h=h, w=w,
                quant_bwd=quant_bwd, max_abs_err=err)


def _measured_sum(rows, key):
    """The rows' ``key`` summed, or None where a row lacks a measurement
    of it (a step's sum is reported only where every shape was
    measured)."""
    vals = [r.get(key) for r in rows]
    return None if None in vals else sum(vals)


def transition_summary(rows, lane_fqt, lane_qat):
    """One entry per transition kernel: the launches of the two
    lane-transition runs (phase 16, FQT and QAT), and the device time per
    train step (FQT, or QAT for the TMA wgrad): phase 15's per-call times
    of the recipe's case summed over the step's two transitions."""
    launch_names = {
        "transition_fwd": ("transition_fwd",),
        "transition_fwd.pre": ("transition_fwd.pre",),
        "transition_bwd": ("transition_bwd.quant", "transition_bwd.fold"),
        "transition_dgrad": ("transition_dgrad",),
        "transition_wgrad_s8": ("transition_wgrad_s8",),
        "transition_wgrad_tma": ("transition_wgrad_tma",
                                 "transition_wgrad_tma.proj")}
    out = []
    for name in TR_NAMES:
        mine = [r for r in rows if r["name"] == name]
        step_run, modes = TR_STEP_MODE[name]
        step = [r for r in mine if r["mode"] in modes]
        tot = {k: sum(r[k] for r in step)
               for k in ("ms", "plain_ms", "ops_ms", "bytes_ms")}
        runs = {label: sum(run["launches"].get(k, 0)
                           for k in launch_names[name])
                for label, run in (("lane_fqt", lane_fqt),
                                   ("lane_qat", lane_qat))}
        fwd = name.startswith("transition_fwd")
        out.append(dict(
            name=name, route="cuda",
            source=(TR_WGRAD_SOURCE if name.startswith(
                "transition_wgrad") else TR_SOURCE),
            replaces=_PALLAS + ("transition.py:357" if fwd
                                else "transition.py:619"),
            launches=sum(runs.values()), split_launches=runs,
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=max(tot["ops_ms"], tot["bytes_ms"]),
            bound_by=("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                      else "bytes"),
            library_ms=_measured_sum(step, "library_ms"),
            per=f"{step_run} train step at batch {BATCH} (ms per call of the "
                f"{' + '.join(modes)} case summed over the step's two "
                "transitions; launches over both lane runs)",
            stages=[{k: r[k] for k in ("stage", "cin", "cout", "mode", "ms",
                                       "plain_ms", "library_ms", "bound_ms",
                                       "bound_by", "max_abs_err")}
                    for r in mine]))
        if name in TR_MAINLOOP:
            out[-1]["mainloop"] = TR_MAINLOOP[name]
        if name == "transition_wgrad_tma":
            out[-1].update(dev_ms=_measured_sum(step, "dev_ms"),
                           tflops={r["mode"]: [x["tflops"] for x in mine
                                               if x["mode"] == r["mode"]]
                                   for r in step})
        if name == "transition_wgrad_s8":
            out[-1].update(dev_ms=_measured_sum(step, "dev_ms"),
                           tops=[r["tops"] for r in step],
                           plans=[r["plan"] for r in step])
        if name == "transition_bwd":   # each body's step, in device time
            body = {m: [r for r in mine if r["mode"] == m]
                    for m in ("fqt", "qat")}
            out[-1].update(
                fqt_step={k: _measured_sum(body["fqt"], k)
                          for k in ("ms", "dev_ms", "bound_ms")},
                qat_step={k: _measured_sum(body["qat"], k)
                          for k in ("ms", "dev_ms", "lanes_ms", "bound_ms")})
        if name == "transition_dgrad":   # its parts, in device time
            out[-1].update(
                **{k: _measured_sum(step, k) for k in (
                    "dev_ms", "pre_dev_ms", "gemm_dev_ms", "sum_dev_ms",
                    "pre_ms", "pre_bound_ms", "gemm_ms")},
                qat_step={k: _measured_sum(
                    [r for r in mine if r["mode"] == "qat+proj"], k)
                    for k in ("ms", "dev_ms", "library_ms", "bound_ms")},
                gemm_tops=[r.get("gemm_tops") for r in mine],
                part_launches={label: {k: run["launches"].get(k, 0) for k in (
                    "transition_dgrad.pre", "transition_dgrad",
                    "transition_dgrad.sum")}
                    for label, run in (("lane_fqt", lane_fqt),
                                       ("lane_qat", lane_qat))})
        if name == "transition_fwd":   # its parts
            out[-1].update(
                **{k: sum(r[k] for r in step) for k in PART_KEYS},
                part_launches={label: {k: run["launches"].get(k, 0) for k in (
                    "transition_fwd.amax", "transition_fwd.pre",
                    "transition_fwd", "transition_fwd.sum")}
                    for label, run in (("lane_fqt", lane_fqt),
                                       ("lane_qat", lane_qat))})
    return out


# --- phases 8 and 9: int8 bottleneck serving ----------------------------------

def nv_kernel_phase(peaks):
    """Rows per (NV kernel, shape, output type): max error against the
    plain version, and the kernel / plain / cuDNN-bf16-block / bound times
    of one block; also its three launches' device times apart
    (``NV_ID_PARTS``, ``NV_TR_PARTS``), each beside its own bound."""
    import torch
    import torch.nn.functional as F

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv as nv

    _, ops_int8, bw, _ = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    rows = []

    def i8(*shape):
        return torch.randint(-127, 128, shape, device=dev, generator=g,
                             dtype=torch.int8)

    def vec(c, lo, hi):
        return torch.rand(c, device=dev, generator=g) * (hi - lo) + lo

    def sc(c, fan):  # about 40 int8 levels per std of an s32 sum
        return vec(c, 0.5, 1.5) * 40 / (fan ** 0.5 * 127 ** 2 / 3)

    def bf16_block(x4, w1, w2, w3, wp, aff, stride):
        """The block in bf16 on cuDNN, channels-last; BN affines and
        relus in f32 (tools/bench_bneck.py's yardstick)."""
        def conv(a, w, s=1, p=0):
            return F.conv2d(a.to(torch.bfloat16), w, stride=s,
                            padding=p).float()

        xf = x4.float()
        a1 = torch.relu(conv(xf, w1) * aff[0] + aff[1])
        a2 = torch.relu(conv(a1, w2, stride, 1) * aff[2] + aff[3])
        z3 = conv(a2, w3) * aff[4] + aff[5]
        sc_ = xf if wp is None else conv(xf[:, :, ::stride, ::stride], wp)
        return torch.relu(sc_ + z3).to(torch.bfloat16)

    for kind, h, w, cin, wdt, cout, stride in NV_SHAPES:
        oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
        proj = kind == "transition"
        name = "bneck_transition_nv" if proj else "bneck_block_nv"
        x = i8(BATCH, h, w, cin)
        ws = [i8(wdt, cin), i8(wdt, 9 * wdt), i8(cout, wdt)] + (
            [i8(cout, cin)] if proj else [])
        vecs = [sc(wdt, cin), vec(wdt, -2, 2), sc(wdt, 9 * wdt),
                vec(wdt, -2, 2), sc(cout, wdt), vec(cout, -2, 2)]
        res = sc(cout, cin) if proj else 0.37
        macs = BATCH * (h * w * cin * wdt + oh * ow * (
            9 * wdt * wdt + wdt * cout + (cin * cout if proj else 0)))
        wbytes = sum(t.numel() for t in ws) + 4 * (4 * wdt + 3 * cout)

        # the yardstick: the same block in bf16 on cuDNN
        def cl(t):
            return t.to(memory_format=torch.channels_last)

        x4 = cl(torch.randn(BATCH, cin, h, w, device=dev, generator=g)
                .to(torch.bfloat16))
        w4 = [cl((torch.randn(o, i, k, k, device=dev, generator=g)
                  * (i * k * k) ** -0.5).to(torch.bfloat16))
              for o, i, k in [(wdt, cin, 1), (wdt, wdt, 3), (cout, wdt, 1)]
              + ([(cout, cin, 1)] if proj else [])]
        aff = [v.view(1, -1, 1, 1) for v in
               (vec(wdt, 0.5, 1.5), vec(wdt, -0.1, 0.1), vec(wdt, 0.5, 1.5),
                vec(wdt, -0.1, 0.1), vec(cout, 0.5, 1.5),
                vec(cout, -0.1, 0.1))]
        lib_ms = time_ms(lambda: bf16_block(
            x4, *w4[:3], w4[3] if proj else None, aff, stride), 10)
        del x4, w4

        for out_int8 in (True, False):
            def run(fn):
                if proj:
                    return fn(x, *ws, *vecs, res, stride=stride,
                              out_int8=out_int8)
                return fn(x, *ws, *vecs, res, out_int8=out_int8)

            kernel = getattr(nv, name)
            plain = getattr(nv, name + "_plain")
            got, ref = run(kernel), run(plain)
            torch.cuda.synchronize()
            assert got.dtype == ref.dtype and got.shape == ref.shape == (
                BATCH, oh, ow, cout), (name, h, out_int8)
            err = (got.float() - ref.float()).abs().max().item()
            assert torch.equal(got, ref), (name, h, cin, wdt, out_int8, err)
            assert ref.unique().numel() > 50, (name, h, out_int8)
            byts = (x.numel() + BATCH * oh * ow * cout * (1 if out_int8
                                                         else 2) + wbytes)
            rows.append(dict(
                name=name, kind=kind, h=h, w=w, cin=cin, wdt=wdt, cout=cout,
                stride=stride, out_int8=out_int8, max_abs_err=err,
                ms=time_ms(lambda: run(kernel), 10),
                plain_ms=time_ms(lambda: run(plain), 2),
                library_ms=lib_ms, ops_ms=2 * macs / ops_int8 * 1e3,
                bytes_ms=byts / bw * 1e3))
            if not proj:
                rows[-1].update(nv_identity_parts(
                    lambda: run(kernel), nv.identity_plan(
                        BATCH, h, w, cin, wdt, cout), cin, wdt, cout,
                    out_int8, ops_int8, bw))
            else:
                rows[-1].update(nv_transition_parts(
                    lambda: run(kernel), nv.transition_plan(
                        BATCH, h, w, cin, wdt, cout, stride), cin, wdt,
                    cout, out_int8, ops_int8, bw))
            del got, ref
        del x, ws
        torch.cuda.empty_cache()
    for r in rows:
        r["bound_ms"] = max(r["ops_ms"], r["bytes_ms"])
        r["bound_by"] = ("operations" if r["ops_ms"] >= r["bytes_ms"]
                         else "bytes")
    return rows


def nv_identity_parts(call, plan, cin, wdt, cout, out_int8, ops_int8, bw):
    """The identity block's launches apart, in device time per call
    (torch.profiler; None where it sees no device time), each beside its
    own bound: conv1 by bytes (x read, a1's codes written), conv2 by
    operations or bytes (a1's codes read once, a2 written), the output by
    bytes (a2 and x read, the output written); weights and vectors once.
    a1 counts its n*h*w*W codes (``lay.codes``), not the slab's pads."""
    split = kernel_split_ms(call, 10, tuple(NV_ID_PARTS.values()),
                            need=tuple(NV_ID_PARTS.values()))
    m, a1 = plan.m, plan.lay.codes
    conv2_ops = 2 * m * 9 * wdt * wdt / ops_int8 * 1e3
    conv2_bytes = (a1 + m * wdt + 9 * wdt * wdt + 8 * wdt) / bw * 1e3
    out = dict(
        dev_ms=sum(split.values()) if split else None,
        conv1_bound_ms=(m * cin + a1 + wdt * cin + 8 * wdt) / bw * 1e3,
        conv2_bound_ms=max(conv2_ops, conv2_bytes),
        conv2_bound_by="operations" if conv2_ops >= conv2_bytes else "bytes",
        out_bound_ms=(m * wdt + m * cout * (2 if out_int8 else 3)
                      + cout * wdt + 8 * cout) / bw * 1e3)
    for part, key in NV_ID_PARTS.items():
        out[f"{part}_dev_ms"] = split[key] if split else None
    return out


def nv_transition_parts(call, plan, cin, wdt, cout, out_int8, ops_int8,
                        bw):
    """The transition's launches apart, in device time per call
    (torch.profiler; None where it sees no device time), each beside its
    own bound, the larger of its operations and its bytes: conv1 (x read,
    a1's m*W codes written, not the slab's or planes' pads, and at stride 2
    xs, x's m_out even-even rows, written), conv2 (a1's codes read, a2
    written), the output (a2 and x or xs read, the output written);
    weights and vectors once."""
    split = kernel_split_ms(call, 10, tuple(NV_TR_PARTS.values()),
                            need=tuple(NV_TR_PARTS.values()))
    m, m_out = plan.m, plan.m_out
    xs = m_out * cin if plan.planes == 4 else 0
    ob = 1 if out_int8 else 2
    parts = dict(
        conv1=(2 * m * cin * wdt,
               m * cin + m * wdt + xs + wdt * cin + 8 * wdt),
        conv2=(2 * m_out * 9 * wdt * wdt,
               m * wdt + m_out * wdt + 9 * wdt * wdt + 8 * wdt),
        out=(2 * m_out * cout * (wdt + cin),
             m_out * (wdt + cin + cout * ob) + cout * (wdt + cin) + 12 * cout))
    out = dict(dev_ms=sum(split.values()) if split else None)
    for part, (ops, byts) in parts.items():
        o, b = ops / ops_int8 * 1e3, byts / bw * 1e3
        out[f"{part}_bound_ms"] = max(o, b)
        out[f"{part}_bound_by"] = "operations" if o >= b else "bytes"
        out[f"{part}_dev_ms"] = split[NV_TR_PARTS[part]] if split else None
    return out


def bneck_serving_phase(workdir):
    """Full-width ResNet-50 served through load_predictor, float and int8
    on the NV trunk."""
    import numpy as np
    import torch

    from pytorch_ddp_resnet_tpu_torch.algos.predict import load_predictor
    from pytorch_ddp_resnet_tpu_torch.data.datasets import load_synthetic
    from pytorch_ddp_resnet_tpu_torch.models.quantize import Int8Inference
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv

    shape = [224, 224, 3]
    # ImageNet is not on the machine; the streaming transforms are not
    # ported (RandomScale is host-only in JAX): ToTensor + Standardize
    config = write_run(
        workdir, "resnet-50", R50_CONFIG, dataset_cls_name="Synthetic",
        dataset_args={"shape": shape, "num_classes": 1000, "n_train": 512},
        data_aug_test={"ToTensorTransform": {},
                       "StandardizeWhiteningTransform": {}},
        batch_size=BATCH)
    test_x = load_synthetic(None, train=False, shape=tuple(shape),
                            num_classes=1000).x  # 256 images
    requests = [test_x[:128], test_x[128:237]]  # the second ragged
    n_serve = sum(-(-len(r) // BATCH) for r in requests)

    # the main path, with the launch counts zeroed just before
    reset_launches()
    t0 = time.perf_counter()
    fp = load_predictor(config)
    fl = [fp.logits(r) for r in requests]
    qp = load_predictor(config, quantize="int8")
    ql = [qp.logits(r) for r in requests]
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = all_launches()
    shapes = dict(bneck_nv.launch_shapes)

    assert qp._model.param_count() == 25549416
    assert fp.n_folded == 49, fp.n_folded  # stem BN + 3 in each block
    assert qp.n_quantized == 48, qp.n_quantized
    want = {}
    for name, k in NV_PER_BATCH.items():
        for part in (".conv1", ".conv2", ""):
            want[name + part] = k * n_serve
    assert launches == want, launches
    for a, b, r in zip(fl, ql, requests):
        assert a.shape == b.shape == (len(r), 1000)
        assert np.isfinite(a).all() and np.isfinite(b).all()

    # the same int8 walk through the plain versions, same scales
    xp = qp._prep(test_x[:BATCH])
    with torch.no_grad():
        q_kernel = qp._fwd(xp).float()
        q_plain = Int8Inference(qp._model, fused_bneck="nv",
                                plain=True).serve_fn(qp.act_scales)(xp)
    int8_err = (q_kernel - q_plain.float()).abs().max().item()
    assert torch.equal(q_kernel, q_plain.float()), int8_err
    f_all, q_all = fp.logits(test_x), qp.logits(test_x)
    agree = float((f_all.argmax(-1) == q_all.argmax(-1)).mean())

    bench = np.concatenate([test_x] * 4)  # 1024 images, 8 batches

    def img_per_s(pred):
        pred.logits(bench[:BATCH])  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred.logits(bench)
        return len(bench) / (time.perf_counter() - t)

    torch.cuda.reset_peak_memory_stats()
    float_ips, int8_ips = img_per_s(fp), img_per_s(qp)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    profile = _profile_steps(lambda: qp.logits(test_x[:BATCH]), 1)
    return dict(
        launches=launches, shapes=shapes, n_serve=n_serve,
        main_path_s=main_s, int8_vs_plain_max_abs=int8_err,
        top1_agreement=agree, logit_absmax=float(np.abs(f_all).max()),
        float_img_per_s=float_ips, int8_img_per_s=int8_ips,
        peak_mem_gib=peak, n_folded=fp.n_folded,
        n_quantized=qp.n_quantized, profile=profile)


def add_scaled(tot, row, scale):
    """tot[key] += row[key] * scale for every key of ``tot``; a key that a
    row lacks a measurement of (None) stays None: a sum over shapes is
    reported only where every shape was measured."""
    for key in tot:
        tot[key] = (None if tot[key] is None or row[key] is None
                    else tot[key] + row[key] * scale)


NV_ID_ROW_KEYS = ("dev_ms", "conv1_dev_ms", "conv2_dev_ms", "out_dev_ms",
                  "conv1_bound_ms", "conv1_bound_by", "conv2_bound_ms",
                  "conv2_bound_by", "out_bound_ms", "out_bound_by")


def nv_summary(rows, serving):
    """One entry per NV kernel: the serving path's launches of its output
    kernel (its conv1 and conv2 launches beside), and per-batch times:
    the kernel phase's per-block times summed over the (shape, output
    type) mix the main path launched, per serving batch."""
    out = []
    part_keys = [f"{p}_{k}" for p in NV_ID_PARTS for k in ("dev_ms",
                                                            "bound_ms")]
    for name in NV_NAMES:
        mine = [r for r in rows if r["name"] == name]
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0,
                   bytes_ms=0.0)
        tot.update({k: 0.0 for k in ["dev_ms"] + part_keys})
        for (kname, _, h, w, cin, wdt, cout, stride, out_int8), count in \
                serving["shapes"].items():
            if kname != name:
                continue
            row = next(r for r in mine if (r["h"], r["cin"], r["wdt"],
                                           r["stride"], r["out_int8"])
                       == (h, cin, wdt, stride, out_int8))
            add_scaled(tot, row, count / serving["n_serve"])
        out.append(dict(
            name=name, route="cuda", source=NV_SOURCE,
            replaces=REPLACES[name],
            launches=serving["launches"].get(name, 0),
            split_launches={k: v for k, v in serving["launches"].items()
                            if k.startswith(name)},
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=max(tot["ops_ms"], tot["bytes_ms"]),
            bound_by=("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                      else "bytes"),
            library_ms=tot["library_ms"],
            per=f"ResNet-50 serving batch of {BATCH} (ms per block summed "
                "over the batch's blocks; launches over the run)",
            stages=[{k: r[k] for k in ("kind", "h", "cin", "wdt", "cout",
                                       "stride", "out_int8", "ms",
                                       "plain_ms", "library_ms", "bound_ms",
                                       "bound_by", "max_abs_err")
                     + NV_ID_ROW_KEYS if k in r}
                    for r in mine]))
        out[-1].update(design=NV_ID_DESIGN if name == "bneck_block_nv"
                       else NV_TR_DESIGN, parts_per_batch={
                           k: tot[k] for k in ["dev_ms"] + part_keys})
    return out


# --- phases 10 and 11: int8 bottleneck FQT training -------------------------

def _nvt_halves(cin, cb, cout):
    """(conv, mode, Cin, Cout) of the four kinds of half in a block."""
    return [("1x1", "identity", cin, cb), ("1x1", "entry", cin, cb),
            ("3x3", "affine", cb, cb), ("1x1", "affine", cb, cout)]


def _nvt_operands(g, n, h, w, ci, co, conv, mode):
    import torch

    dev = torch.device("cuda")

    def rn(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    k = 3 if conv == "3x3" else 1
    x = rn(n, h, w, ci).to(torch.bfloat16)
    return dict(
        x=x.abs() if mode == "identity" else x,
        w=rn(co, ci, k, k, s=(k * k * ci) ** -0.5),
        s=rn(ci, s=0.5) + 1.0 if mode != "identity" else None,
        t=rn(ci, s=0.2) if mode != "identity" else None,
        res=rn(n, h, w, ci).to(torch.bfloat16) if mode == "entry" else None,
        dy=rn(n, h, w, co, s=1e-3).to(torch.bfloat16),
        dzsum=rn(co, s=1e-4), dzssq=rn(co, s=1e-5),
        dxout=(rn(n, h, w, ci, s=1e-3).to(torch.bfloat16)
               if mode == "entry" else None))


def _nvt_stage_fns(nvt, o, conv, mode, rch, plain):
    """The three stages of one half as separate callables (forward: row
    absmax + conv; dgrad: the cotangent's row absmax + conv; wgrad), on
    the operands of ``o`` and the y of one forward."""
    pick = (lambda name: getattr(nvt, name + "_plain")) if plain else (
        lambda name: getattr(nvt, name))
    three = conv == "3x3"
    wq, ws = (nvt.quantize_w_3x3 if three else nvt.quantize_w_1x1)(o["w"])
    wdg, wsin = (nvt.quantize_w_3x3_dgrad if three
                 else nvt.quantize_w_1x1_dgrad)(o["w"])
    x, s, t, res = o["x"], o["s"], o["t"], o["res"]
    kw = dict(conv=conv, mode=mode)
    wargs = _nvt_wgrad_args(nvt, o, conv, mode, rch)
    cts, rowmax_g, rowmax_a = wargs[:4], wargs[4], wargs[9]

    def fwd():
        ra = pick("fwd_rowmax")(x, s, t, res, mode=mode)[0]
        return pick("fwd_conv")(x, s, t, res, ra, wq, ws, rch=rch[0], **kw)

    def dgrad():
        rg = pick("bwd_rowmax")(*cts)
        return pick("dgrad_conv")(*cts, rg, wdg, wsin, x, s, t, res,
                                  o["dxout"], rch=rch[1], **kw)

    def wgrad():
        return pick("wgrad")(*cts, rowmax_g, x, s, t, res, rowmax_a,
                             rch=rch[2], **kw)

    return dict(nv_half_fwd=fwd, nv_half_dgrad=dgrad, nv_half_wgrad=wgrad)


def _nvt_wgrad_args(nvt, o, conv, mode, rch):
    """The int8 wgrad's arguments (dy, y, dzsum, dzssq, rowmax_g, x, s, t,
    res, rowmax_a) on the kernels' forward y and row maxima."""
    x, s, t, res = o["x"], o["s"], o["t"], o["res"]
    wq, ws = (nvt.quantize_w_3x3 if conv == "3x3"
              else nvt.quantize_w_1x1)(o["w"])
    rowmax_a = nvt.fwd_rowmax(x, s, t, res, mode=mode)[0]
    y = nvt.fwd_conv(x, s, t, res, rowmax_a, wq, ws, conv=conv, mode=mode,
                     rch=rch[0])[0]
    cts = (o["dy"], y, o["dzsum"], o["dzssq"])
    return cts + (nvt.bwd_rowmax(*cts), x, s, t, res, rowmax_a)


def _wgrad_int8_parts(nvt, wargs, conv, mode, rch):
    """The int8 wgrad's second call equal to its first bit for bit (exact
    s32 per chunk, the chunks added in a fixed order), and its two parts
    timed apart: the prepass, then the mainloop + ordered sum on its
    slabs."""
    import torch

    kw = dict(conv=conv, mode=mode, rch=rch)
    first = nvt.wgrad(*wargs, **kw)
    assert torch.equal(first, nvt.wgrad(*wargs, **kw)), (conv, mode, rch)
    slabs = nvt.wgrad_pre(*wargs, **kw)
    n, h, w, cin = wargs[5].shape
    taps = 9 if conv == "3x3" else 1
    lay = nvt.wgrad_int8_layout(n, h, w, taps, rch)
    plan = nvt.wgrad_int8_plan(n, h, w, cin, wargs[0].shape[-1], taps, rch)
    return dict(
        deterministic=True, plan=list(plan[:-1]),
        pre_ms=time_ms(lambda: nvt.wgrad_pre(*wargs, **kw), 10),
        gemm_ms=time_ms(lambda: nvt.wgrad_gemm(*slabs, wargs[9], wargs[4],
                                               lay), 10))


def _wgrad_int8_pre_row(nvt, wargs, mode, rch, flops_f32, bw, geo):
    """The int8 wgrad's prepass as a kernel row: its slabs equal to its
    plain version's byte for byte; bound by its bytes (dy, y and x (and
    res) in; the codes out: g's once, a's chunk rows as the forward's
    ``FwdInt8Layout.codes``, not the slabs' pads) or its f32 operations
    (three an element of a and g)."""
    import torch

    kw = dict(conv=geo["conv"], mode=mode, rch=rch)
    got = nvt.wgrad_pre(*wargs, **kw)
    want = nvt.wgrad_pre_plain(*wargs, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b), ("nv_half_wgrad.pre", geo)
    p = geo["n"] * geo["h"] * geo["w"]
    cin, cout = geo["cin"], geo["cout"]
    lay = nvt.fwd_int8_layout(geo["n"], geo["h"], geo["w"], cin,
                              9 if geo["conv"] == "3x3" else 1, rch)
    byts = (2 * p * (2 * cout + cin + (cin if mode == "entry" else 0))
            + lay.codes + p * cout)
    return dict(
        name="nv_half_wgrad.pre", **geo, max_abs_err=0.0,
        ms=time_ms(lambda: nvt.wgrad_pre(*wargs, **kw), 10),
        plain_ms=time_ms(lambda: nvt.wgrad_pre_plain(*wargs, **kw), 1),
        library_ms=None, ops_ms=3 * p * (cin + cout) / flops_f32 * 1e3,
        bytes_ms=byts / bw * 1e3)


def _fwd_int8_parts(nvt, o, conv, mode, rch, bw, ops_int8):
    """The int8 forward's second call equal to its first bit for bit (y
    exact, the sums in a fixed order), and its three parts timed apart
    beside their plain versions and bounds: the row-max pass (x (and res)
    in, x_res out), the prepass (x (and res) in, the codes out) and the
    mainloop + ordered sum (the codes and weights in, y out, or its int8
    operations); the codes are ``FwdInt8Layout.codes``, not the slab's
    pads."""
    import torch

    x, s, t, res = o["x"], o["s"], o["t"], o["res"]
    wq, ws = (nvt.quantize_w_3x3 if conv == "3x3"
              else nvt.quantize_w_1x1)(o["w"])
    kw = dict(conv=conv, mode=mode, rch=rch)
    rowmax = nvt.fwd_rowmax(x, s, t, res, mode=mode)[0]
    first = nvt.fwd_conv(x, s, t, res, rowmax, wq, ws, **kw)
    second = nvt.fwd_conv(x, s, t, res, rowmax, wq, ws, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b), ("nv_half_fwd", conv, mode, rch)
    slab = nvt.fwd_pre(x, s, t, res, rowmax, **kw)
    n, h, w, ci = x.shape
    co, taps = wq.shape[0], 9 if conv == "3x3" else 1
    lay = nvt.fwd_int8_layout(n, h, w, ci, taps, rch)
    p, entry = n * h * w, mode == "entry"
    act = 2 * p * ci * (2 if entry else 1)
    return dict(
        deterministic=True,
        amax_ms=time_ms(lambda: nvt.fwd_rowmax(x, s, t, res, mode=mode), 10),
        amax_plain_ms=time_ms(lambda: nvt.fwd_rowmax_plain(
            x, s, t, res, mode=mode), 1),
        amax_bound_ms=(act + (2 * p * ci if entry else 0)) / bw * 1e3,
        pre_ms=time_ms(lambda: nvt.fwd_pre(x, s, t, res, rowmax, **kw), 10),
        pre_plain_ms=time_ms(lambda: nvt.fwd_pre_plain(
            x, s, t, res, rowmax, **kw), 1),
        pre_bound_ms=(act + lay.codes) / bw * 1e3,
        gemm_ms=time_ms(lambda: nvt.fwd_gemm(slab, rowmax, wq, ws, lay), 10),
        gemm_plain_ms=time_ms(lambda: nvt.fwd_gemm_plain(
            slab, rowmax, wq, ws, lay), 1),
        gemm_bound_ms=max((lay.codes + taps * ci * co + 2 * p * co) / bw,
                          2 * p * taps * ci * co / ops_int8) * 1e3,
        layout=dict(cp=lay.cp, bk=lay.bk, tiles=lay.tiles,
                    chunks=lay.chunks))


def _fwd_int8_pre_row(nvt, o, mode, rch, flops_f32, bw, geo):
    """The int8 forward's prepass as a kernel row: its slabs equal to its
    plain version's byte for byte; bound by its bytes (x (and res) in, the
    codes out: ``FwdInt8Layout.codes``, not the slab's pads) or its f32
    operations (three an element of a)."""
    import torch

    x, s, t, res = o["x"], o["s"], o["t"], o["res"]
    kw = dict(conv=geo["conv"], mode=mode, rch=rch)
    rowmax = nvt.fwd_rowmax(x, s, t, res, mode=mode)[0]
    got = nvt.fwd_pre(x, s, t, res, rowmax, **kw)
    assert torch.equal(got, nvt.fwd_pre_plain(x, s, t, res, rowmax, **kw)), (
        "nv_half_fwd.pre", geo)
    p, cin = geo["n"] * geo["h"] * geo["w"], geo["cin"]
    codes = nvt.fwd_int8_layout(geo["n"], geo["h"], geo["w"], cin,
                                9 if geo["conv"] == "3x3" else 1, rch).codes
    byts = 2 * p * cin * (2 if mode == "entry" else 1) + codes
    return dict(
        name="nv_half_fwd.pre", **geo, max_abs_err=0.0,
        ms=time_ms(lambda: nvt.fwd_pre(x, s, t, res, rowmax, **kw), 10),
        plain_ms=time_ms(lambda: nvt.fwd_pre_plain(x, s, t, res, rowmax,
                                                   **kw), 1),
        library_ms=None, ops_ms=3 * p * cin / flops_f32 * 1e3,
        bytes_ms=byts / bw * 1e3)


def _dgrad_int8_parts(nvt, o, wargs, conv, mode, rch, bw, ops_int8):
    """The int8 input gradient's second call equal to its first bit for bit
    (dx and dres exact, the sums in a fixed order), and its parts timed
    apart beside their plain versions and bounds: the row-max pass (dy and
    y in), the prepass (dy and y in, the codes out: ``FwdInt8Layout.codes``,
    not the slab's pads), the GEMM with its tiles' sum (the codes, weights,
    x (and res, dx_res) in, dx (and dres) out, or its int8 operations) and the tiles' sum alone (the tiles'
    partial sums in, d(s) and d(t) out; none in identity mode)."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda.checks import check_rc

    cts, rowmax = wargs[:4], wargs[4]
    x, s, t, res, dxout = o["x"], o["s"], o["t"], o["res"], o["dxout"]
    wq_dg, ws_in = (nvt.quantize_w_3x3_dgrad if conv == "3x3"
                    else nvt.quantize_w_1x1_dgrad)(o["w"])
    args = (rowmax, wq_dg, ws_in, x, s, t, res, dxout)
    kw = dict(conv=conv, mode=mode, rch=rch)
    first = nvt.dgrad_conv(*cts, *args, **kw)
    second = nvt.dgrad_conv(*cts, *args, **kw)
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b), (
            "nv_half_dgrad", conv, mode, rch)
    slab = nvt.dgrad_pre(*cts, rowmax, conv=conv, rch=rch)
    n, h, w, ci = x.shape
    co, taps = cts[0].shape[-1], 9 if conv == "3x3" else 1
    lay = nvt.fwd_int8_layout(n, h, w, co, taps, rch)
    p, entry, affine = n * h * w, mode == "entry", mode != "identity"
    cot = 4 * p * co
    act = 2 * p * ci * ((1 if affine else 0) + (2 if entry else 0))
    out = 2 * p * ci * (2 if entry else 1)
    sum_ms = sum_bound_ms = 0.0
    if affine:
        slots = lay.chunks * lay.tiles
        part = torch.zeros((slots, 2 * ci), device=x.device)
        sums = torch.empty(2 * ci, device=x.device)
        lib = nvt._library()

        def tile_sum():
            check_rc("nv_half_dgrad.sum", lib.nvt_dgrad_sum_launch(
                part.data_ptr(), sums.data_ptr(), slots, 2 * ci,
                torch.cuda.current_stream().cuda_stream))

        sum_ms = time_ms(tile_sum, 10)
        sum_bound_ms = (part.numel() + sums.numel()) * 4 / bw * 1e3
    return dict(
        deterministic=True,
        amax_ms=time_ms(lambda: nvt.bwd_rowmax(*cts), 10),
        amax_plain_ms=time_ms(lambda: nvt.bwd_rowmax_plain(*cts), 1),
        amax_bound_ms=cot / bw * 1e3,
        pre_ms=time_ms(lambda: nvt.dgrad_pre(*cts, rowmax, conv=conv,
                                             rch=rch), 10),
        pre_plain_ms=time_ms(lambda: nvt.dgrad_pre_plain(
            *cts, rowmax, conv=conv, rch=rch), 1),
        pre_bound_ms=(cot + lay.codes) / bw * 1e3,
        gemm_ms=time_ms(lambda: nvt.dgrad_gemm(slab, *args, lay, mode=mode),
                        10),
        gemm_plain_ms=time_ms(lambda: nvt.dgrad_gemm_plain(
            slab, *args, lay, mode=mode), 1),
        gemm_bound_ms=max((lay.codes + taps * ci * co + act + out) / bw,
                          2 * p * taps * ci * co / ops_int8) * 1e3,
        sum_ms=sum_ms, sum_bound_ms=sum_bound_ms,
        layout=dict(cp=lay.cp, tiles=lay.tiles, chunks=lay.chunks,
                    bn=nvt.dgrad_tile(ci)))


def _dgrad_int8_pre_row(nvt, wargs, rch, flops_f32, bw, geo):
    """The int8 input gradient's prepass as a kernel row: its slabs equal to
    its plain version's byte for byte; bound by its bytes (dy and y in, the
    codes out: ``FwdInt8Layout.codes``, not the slab's pads) or its f32
    operations (four an element of g: the fold and the quantization)."""
    import torch

    cts, rowmax = wargs[:4], wargs[4]
    kw = dict(conv=geo["conv"], rch=rch)
    got = nvt.dgrad_pre(*cts, rowmax, **kw)
    assert torch.equal(got, nvt.dgrad_pre_plain(*cts, rowmax, **kw)), (
        "nv_half_dgrad.pre", geo)
    p, cout = geo["n"] * geo["h"] * geo["w"], geo["cout"]
    codes = nvt.fwd_int8_layout(geo["n"], geo["h"], geo["w"], cout,
                                9 if geo["conv"] == "3x3" else 1, rch).codes
    return dict(
        name="nv_half_dgrad.pre", **geo, max_abs_err=0.0,
        ms=time_ms(lambda: nvt.dgrad_pre(*cts, rowmax, **kw), 10),
        plain_ms=time_ms(lambda: nvt.dgrad_pre_plain(*cts, rowmax, **kw), 1),
        library_ms=None, ops_ms=4 * p * cout / flops_f32 * 1e3,
        bytes_ms=(4 * p * cout + codes) / bw * 1e3)


def _nvt_bytes(p, ci, co, taps, mode, w_size, names):
    """Bytes of each stage of a half (forward, dgrad, wgrad, named by
    ``names``) over ``p`` positions: each input read once, each output
    written once; weights of ``w_size`` bytes, dW in f32."""
    entry, affine = mode == "entry", mode != "identity"
    wn = taps * ci * co
    return dict(zip(names, (
        2 * p * (ci + co) + w_size * wn + (4 * p * ci if entry else 0),
        2 * p * (2 * co + ci) + w_size * wn + (2 * p * ci if affine else 0)
        + (6 * p * ci if entry else 0),
        2 * p * (2 * co + ci) + 4 * wn + (2 * p * ci if entry else 0))))


def _cudnn_half_times(g, n, h, w, ci, co, k, names):
    """cuDNN's bf16 channels-last forward, input gradient and weight
    gradient of the half's conv (ms per call), keyed by ``names``."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    dev = torch.device("cuda")
    cl = dict(memory_format=torch.channels_last)
    x4 = torch.randn(n, ci, h, w, device=dev, generator=g).to(
        torch.bfloat16).to(**cl)
    w4 = torch.randn(co, ci, k, k, device=dev, generator=g).to(
        torch.bfloat16).to(**cl)
    dy4 = torch.randn(n, co, h, w, device=dev, generator=g).to(
        torch.bfloat16).to(**cl)
    pad = k // 2
    return dict(zip(names, (
        time_ms(lambda: F.conv2d(x4, w4, padding=pad), 10),
        time_ms(lambda: conv2d_input(x4.shape, w4, dy4, padding=pad), 10),
        time_ms(lambda: conv2d_weight(x4, w4.shape, dy4, padding=pad), 10))))


def nv_train_kernel_phase(peaks):
    """Rows per (NV training stage, geometry, half): max error of the half
    against its plain version, and the kernel / plain / cuDNN-bf16 / bound
    times of one call of the stage."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt

    _, ops_int8, bw, flops_f32 = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for n, h, w, cin, cb, cout in NVT_GEOMETRIES:
        p = n * h * w
        for conv, mode, ci, co in _nvt_halves(cin, cb, cout):
            o = _nvt_operands(g, n, h, w, ci, co, conv, mode)
            rch = nvt.pick_chunk_rows(h, w, n, ci, co, conv, mode)
            err = _agree(
                nvt.half_stages(**o, conv=conv, mode=mode, rch=rch),
                nvt.half_stages(**o, conv=conv, mode=mode, rch=rch,
                                plain=True), (h, conv, mode))
            k = 3 if conv == "3x3" else 1
            taps = k * k
            lib = _cudnn_half_times(g, n, h, w, ci, co, k, NVT_NAMES)
            kern = _nvt_stage_fns(nvt, o, conv, mode, rch, plain=False)
            plain = _nvt_stage_fns(nvt, o, conv, mode, rch, plain=True)
            byts = _nvt_bytes(p, ci, co, taps, mode, 1, NVT_NAMES)
            for name in NVT_NAMES:
                rows.append(dict(
                    name=name, n=n, h=h, w=w, cin=ci, cout=co, conv=conv,
                    mode=mode, rch=list(rch), max_abs_err=err,
                    ms=time_ms(kern[name], 10),
                    plain_ms=time_ms(plain[name], 1),
                    library_ms=lib[name],
                    ops_ms=2 * p * taps * ci * co / ops_int8 * 1e3,
                    bytes_ms=byts[name] / bw * 1e3))
            geo = dict(n=n, h=h, w=w, cin=ci, cout=co, conv=conv, mode=mode,
                       rch=list(rch))
            fwd_row, dgrad_row, wgrad_row = rows[-3:]
            fwd_row.update(_fwd_int8_parts(nvt, o, conv, mode, rch[0], bw,
                                           ops_int8))
            rows.append(_fwd_int8_pre_row(nvt, o, mode, rch[0], flops_f32,
                                          bw, geo))
            wargs = _nvt_wgrad_args(nvt, o, conv, mode, rch)
            dgrad_row.update(_dgrad_int8_parts(nvt, o, wargs, conv, mode,
                                               rch[1], bw, ops_int8))
            rows.append(_dgrad_int8_pre_row(nvt, wargs, rch[1], flops_f32,
                                            bw, geo))
            wgrad_row.update(_wgrad_int8_parts(nvt, wargs, conv, mode,
                                               rch[2]))
            rows.append(_wgrad_int8_pre_row(
                nvt, wargs, mode, rch[2], flops_f32, bw, geo))
            del o, kern, plain, wargs
            torch.cuda.empty_cache()
    for r in rows:
        r["bound_ms"] = max(r["ops_ms"], r["bytes_ms"])
        r["bound_by"] = ("operations" if r["ops_ms"] >= r["bytes_ms"]
                         else "bytes")
    return rows


# --- phases 20 and 21: the NV halves' bf16 bodies, ResNet-50 QAT --------------

NVT_FWD_KEYS = ("rowmax_a", "x_res", "y", "zsum", "zssq")


def _agree_nv_train(got: dict, want: dict, what, quant=True,
                    quant_bwd=True) -> float:
    """A half's stage outputs against the plain versions', each by its
    body: an int8 body's as ``_agree`` (equal, sums over positions 1e-5);
    a bf16 body's bf16 tensors (y, dx, dres) within 2 bf16 ulps of the
    tensor's largest value (dres = bf16(du), du carrying the f32 product),
    x_res equal (the same f32 prologue, rounded once), the f32 sums (zsum,
    zssq, ds, dt) and dW over the tensor cores' accumulators within 1e-4,
    and the BatchNorm sums within 1e-5 of the sums of the kernel's own y.
    Returns the max abs difference."""
    import torch

    err = 0.0
    for k, ref in want.items():
        out = got[k]
        if ref is None:
            assert out is None, (what, k)
            continue
        if (quant if k in NVT_FWD_KEYS else quant_bwd):
            err = max(err, _agree({k: out}, {k: ref}, what))
            continue
        if k == "x_res":
            assert torch.equal(out, ref), (what, k)
            d = 0.0
        elif ref.dtype == torch.bfloat16:
            d = _bf16_err(out, ref, (what, k))
        else:
            d = _sum_err(out, ref, (what, k))
        if k in ("zsum", "zssq"):
            yd = got["y"].double().reshape(-1, ref.shape[0])
            own = yd.sum(0) if k == "zsum" else (yd * yd).sum(0)
            assert (out.double() - own).abs().max().item() <= \
                1e-5 * own.abs().max().item(), (what, k)
        err = max(err, d)
    return err


def _nvt_bf16_fns(nvt, o, conv, mode, rch, plain, y_bwd):
    """The bf16 forward, dgrad and wgrad of one half as callables returning
    dicts, through the kernels or the plain versions; the backward takes
    ``y_bwd`` (the kernel's y), so both sides see the same inputs."""
    def pick(name):
        return getattr(nvt, f"{name}_plain" if plain else name)

    x, s, t, res = o["x"], o["s"], o["t"], o["res"]
    kw = dict(conv=conv, mode=mode)
    wb, wdg = nvt.pack_w_bf16(o["w"]), nvt.pack_w_bf16_dgrad(o["w"])
    cts = (o["dy"], y_bwd, o["dzsum"], o["dzssq"])

    def fwd():
        return dict(zip(("y", "zsum", "zssq", "x_res"), pick(
            "fwd_conv_bf16")(x, s, t, res, wb, rch=rch[0], **kw)))

    def dgrad():
        return dict(zip(("dx", "ds", "dt", "dres"), pick("dgrad_conv_bf16")(
            *cts, wdg, x, s, t, res, o["dxout"], rch=rch[1], **kw)))

    def wgrad():
        return {"dw": pick("wgrad_bf16")(*cts, x, s, t, res, rch=rch[2],
                                         **kw)}

    return dict(zip(NVT_BF16_NAMES, (fwd, dgrad, wgrad)))


def nv_train_bf16_kernel_phase(peaks, nvt_rows):
    """Rows per (bf16 stage, geometry, half) as phase 10's: max error of
    the kernel against its plain version on the same CUDA tensors, and the
    kernel / plain / cuDNN-bf16 / bound times of one call, beside phase
    10's int8 kernel at the same shape (``int8_ms``). The wgrad's rows also
    carry its prepass's and its mainloop + sum's times (``pre_ms``,
    ``gemm_ms``) and its bit-equal second call; its prepass has rows of
    its own (``nv_half_wgrad_bf16.pre``, equal to its plain version)."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt

    flops_bf16, _, bw, flops_f32 = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    rows = []
    for n, h, w, cin, cb, cout in NVT_GEOMETRIES:
        p = n * h * w
        for conv, mode, ci, co in _nvt_halves(cin, cb, cout):
            o = _nvt_operands(g, n, h, w, ci, co, conv, mode)
            rch = nvt.pick_chunk_rows(h, w, n, ci, co, conv, mode)
            k = 3 if conv == "3x3" else 1
            taps = k * k
            y = nvt.fwd_conv_bf16(o["x"], o["s"], o["t"], o["res"],
                                  nvt.pack_w_bf16(o["w"]), conv=conv,
                                  mode=mode, rch=rch[0])[0]
            kern = _nvt_bf16_fns(nvt, o, conv, mode, rch, False, y)
            plain = _nvt_bf16_fns(nvt, o, conv, mode, rch, True, y)
            lib = _cudnn_half_times(g, n, h, w, ci, co, k, NVT_BF16_NAMES)
            byts = _nvt_bytes(p, ci, co, taps, mode, 2, NVT_BF16_NAMES)
            for name in NVT_BF16_NAMES:
                err = _agree_nv_train(kern[name](), plain[name](),
                                      (name, h, conv, mode), False, False)
                int8 = next(r for r in nvt_rows if (
                    r["name"], r["n"], r["h"], r["conv"], r["mode"],
                    r["cin"], r["cout"]) == (name[:-5], n, h, conv, mode,
                                             ci, co))
                rows.append(dict(
                    name=name, n=n, h=h, w=w, cin=ci, cout=co, conv=conv,
                    mode=mode, rch=list(rch), max_abs_err=err,
                    ms=time_ms(kern[name], 10),
                    plain_ms=time_ms(plain[name], 1),
                    library_ms=lib[name], int8_ms=int8["ms"],
                    ops_ms=2 * p * taps * ci * co / flops_bf16 * 1e3,
                    bytes_ms=byts[name] / bw * 1e3))
            geo = dict(n=n, h=h, w=w, cin=ci, cout=co, conv=conv, mode=mode,
                       rch=list(rch))
            _, dgrad_row, wgrad_row = rows[-3:]
            dgrad_row.update(_dgrad_bf16_parts(nvt, o, y, conv, mode, rch[1],
                                               bw, flops_bf16))
            wgrad_row.update(_wgrad_parts(nvt, o, y, conv, mode, rch[2]))
            rows.append(_wgrad_pre_row(nvt, o, y, mode, flops_f32, bw, geo))
            rows.append(_dgrad_bf16_pre_row(nvt, o, y, flops_f32, bw, geo))
            del o, y, kern, plain
            torch.cuda.empty_cache()
    for r in rows:
        r["bound_ms"] = max(r["ops_ms"], r["bytes_ms"])
        r["bound_by"] = ("operations" if r["ops_ms"] >= r["bytes_ms"]
                         else "bytes")
    return rows


def _dgrad_bf16_args(nvt, o, y):
    """The bf16 input gradient's arguments (dy, y, dzsum, dzssq, wb_dg, x,
    s, t, res, dxout) on the kernel's forward y."""
    return (o["dy"], y, o["dzsum"], o["dzssq"],
            nvt.pack_w_bf16_dgrad(o["w"]), o["x"], o["s"], o["t"], o["res"],
            o["dxout"])


def _dgrad_bf16_parts(nvt, o, y, conv, mode, rch, bw, flops_bf16):
    """The bf16 input gradient's second call equal to its first bit for
    bit, its slab equal to its plain version's bit for bit, and its parts
    timed apart beside their plain versions and bounds: the prepass (dy
    and y in, the slab's values out: ``FwdInt8Layout.codes`` bf16
    elements, not its pads), the GEMM with its tiles' sum (the slab's
    values, the weights, x (and res, dx_res) in, dx (and dres) out, or its
    bf16 operations) and the tiles' sum alone (the tiles' partial sums in,
    d(s) and d(t) out; none in identity mode)."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda.checks import check_rc

    args = _dgrad_bf16_args(nvt, o, y)
    cts, rest = args[:4], args[4:]
    kw = dict(conv=conv, mode=mode, rch=rch)
    first = nvt.dgrad_conv_bf16(*args, **kw)
    second = nvt.dgrad_conv_bf16(*args, **kw)
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b), (
            "nv_half_dgrad_bf16", conv, mode)
    slab = nvt.dgrad_bf16_pre(*cts, conv=conv)
    assert torch.equal(slab, nvt.dgrad_bf16_pre_plain(*cts, conv=conv)), (
        "nv_half_dgrad_bf16.pre", conv, mode)
    x = o["x"]
    n, h, w, ci = x.shape
    co, taps = cts[0].shape[-1], 9 if conv == "3x3" else 1
    lay = nvt.dgrad_bf16_layout(n, h, w, co, taps)
    p, entry, affine = n * h * w, mode == "entry", mode != "identity"
    cot, vals = 4 * p * co, 2 * lay.codes
    act = 2 * p * ci * ((1 if affine else 0) + (2 if entry else 0))
    out = 2 * p * ci * (2 if entry else 1)
    sum_ms = sum_bound_ms = 0.0
    if affine:
        part = torch.zeros((lay.tiles, 2 * ci), device=x.device)
        sums = torch.empty(2 * ci, device=x.device)
        lib = nvt._library()

        def tile_sum():
            check_rc("nv_half_dgrad_bf16.sum", lib.nvt_dgrad_bf16_sum_launch(
                part.data_ptr(), sums.data_ptr(), lay.tiles, 2 * ci,
                torch.cuda.current_stream().cuda_stream))

        sum_ms = time_ms(tile_sum, 10)
        sum_bound_ms = (part.numel() + sums.numel()) * 4 / bw * 1e3
    return dict(
        deterministic=True,
        pre_ms=time_ms(lambda: nvt.dgrad_bf16_pre(*cts, conv=conv), 10),
        pre_plain_ms=time_ms(lambda: nvt.dgrad_bf16_pre_plain(
            *cts, conv=conv), 1),
        pre_bound_ms=(cot + vals) / bw * 1e3,
        gemm_ms=time_ms(lambda: nvt.dgrad_bf16_gemm(slab, *rest, lay,
                                                    mode=mode), 10),
        gemm_plain_ms=time_ms(lambda: nvt.dgrad_bf16_gemm_plain(
            slab, *rest, lay, mode=mode), 1),
        gemm_bound_ms=max((vals + 2 * taps * ci * co + act + out) / bw,
                          2 * p * taps * ci * co / flops_bf16) * 1e3,
        sum_ms=sum_ms, sum_bound_ms=sum_bound_ms,
        layout=dict(cp=lay.cp, tiles=lay.tiles, bn=nvt.dgrad_tile(ci),
                    slab_mb=slab.numel() * 2 / 1e6))


def _dgrad_bf16_pre_row(nvt, o, y, flops_f32, bw, geo):
    """The bf16 input gradient's prepass as a kernel row: its slab equal to
    its plain version's bit for bit; bound by its bytes (dy and y in, the
    slab's values out: ``FwdInt8Layout.codes`` bf16 elements, not its pads)
    or its f32 operations (four an element of g: the fold's add and
    multiply and its fused multiply-add)."""
    import torch

    cts = _dgrad_bf16_args(nvt, o, y)[:4]
    conv = geo["conv"]
    got = nvt.dgrad_bf16_pre(*cts, conv=conv)
    assert torch.equal(got, nvt.dgrad_bf16_pre_plain(*cts, conv=conv)), (
        "nv_half_dgrad_bf16.pre", geo)
    p, cout = geo["n"] * geo["h"] * geo["w"], geo["cout"]
    vals = nvt.dgrad_bf16_layout(geo["n"], geo["h"], geo["w"], cout,
                                 9 if conv == "3x3" else 1).codes
    return dict(
        name="nv_half_dgrad_bf16.pre", **geo, max_abs_err=0.0,
        ms=time_ms(lambda: nvt.dgrad_bf16_pre(*cts, conv=conv), 10),
        plain_ms=time_ms(lambda: nvt.dgrad_bf16_pre_plain(*cts, conv=conv),
                         1),
        library_ms=None, ops_ms=4 * p * cout / flops_f32 * 1e3,
        bytes_ms=(4 * p * cout + 2 * vals) / bw * 1e3)


def _wgrad_cts(o, y):
    return (o["dy"], y, o["dzsum"], o["dzssq"], o["x"], o["s"], o["t"],
            o["res"])


def _wgrad_parts(nvt, o, y, conv, mode, rch):
    """The bf16 wgrad's second call equal to its first bit for bit (the
    splits and chunks are added in a fixed order), and its two parts timed
    apart: the prepass, then the mainloop + ordered sum on its operands."""
    import torch

    cts = _wgrad_cts(o, y)
    first = nvt.wgrad_bf16(*cts, conv=conv, mode=mode, rch=rch)
    assert torch.equal(first, nvt.wgrad_bf16(*cts, conv=conv, mode=mode,
                                             rch=rch)), (conv, mode, rch)
    a_b, g_b = nvt.wgrad_bf16_pre(*cts, mode=mode)
    plan = nvt.wgrad_bf16_plan(*o["x"].shape, y.shape[-1],
                               9 if conv == "3x3" else 1, rch)
    return dict(
        deterministic=True, plan=list(plan[:-1]),
        pre_ms=time_ms(lambda: nvt.wgrad_bf16_pre(*cts, mode=mode), 10),
        gemm_ms=time_ms(lambda: nvt.wgrad_bf16_gemm(a_b, g_b, conv=conv,
                                                    rch=rch), 10))


def _wgrad_pre_row(nvt, o, y, mode, flops_f32, bw, geo):
    """The wgrad's prepass as a kernel row: equal to its plain version;
    bound by its bytes (dy, y and, unless identity, x (and res) in; g_b and
    a_b out) or its f32 operations (three an element)."""
    import torch

    cts = _wgrad_cts(o, y)
    got = nvt.wgrad_bf16_pre(*cts, mode=mode)
    want = nvt.wgrad_bf16_pre_plain(*cts, mode=mode)
    for a, b in zip(got, want):
        assert torch.equal(a, b), ("nv_half_wgrad_bf16.pre", geo)
    p = geo["n"] * geo["h"] * geo["w"]
    ca = 0 if mode == "identity" else geo["cin"]
    elems = p * (geo["cout"] + ca)
    byts = 2 * p * (3 * geo["cout"] + 2 * ca
                    + (geo["cin"] if mode == "entry" else 0))
    return dict(
        name="nv_half_wgrad_bf16.pre", **geo, max_abs_err=0.0,
        ms=time_ms(lambda: nvt.wgrad_bf16_pre(*cts, mode=mode), 10),
        plain_ms=time_ms(lambda: nvt.wgrad_bf16_pre_plain(*cts, mode=mode),
                         1),
        library_ms=None, ops_ms=3 * elems / flops_f32 * 1e3,
        bytes_ms=byts / bw * 1e3)


class RecordNVHalves:
    """Around the first train step: record the first NV half of each kind
    (conv, mode), its live inputs and, through gradient hooks, its live
    cotangents."""

    def __init__(self):
        self.rec = {}

    def __enter__(self):
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train

        self.mod = bneck_nv_train
        self.orig = (bneck_nv_train.nv_half_1x1, bneck_nv_train.nv_half_3x3)
        rec = self.rec

        def clone(t):
            return None if t is None else t.detach().clone()

        def wrap(orig, conv):
            def recording(x, w, s=None, t=None, res=None, **kw):
                out = (orig(x, w, s, t, res, **kw) if conv == "1x1"
                       else orig(x, w, s, t, **kw))
                key = (conv, kw["mode"])
                if key not in rec:
                    # copies: the optimizer updates the weight in place
                    r = rec[key] = dict(
                        x=clone(x), w=clone(w), s=clone(s), t=clone(t),
                        res=clone(res), out=[clone(o) for o in out])
                    for name, o in zip(("dy", "dzsum", "dzssq", "dxout"),
                                       out):
                        o.register_hook(lambda gr, name=name, r=r:
                                        r.__setitem__(name, clone(gr)))
                return out
            return recording

        bneck_nv_train.nv_half_1x1 = wrap(self.orig[0], "1x1")
        bneck_nv_train.nv_half_3x3 = wrap(self.orig[1], "3x3")
        return self

    def __exit__(self, *exc):
        self.mod.nv_half_1x1, self.mod.nv_half_3x3 = self.orig
        return False


def live_nv_check(rec, quant_bwd=True):
    """Each recorded half, forward and backward through the kernels on its
    live tensors (the int8 forward; the FQT or, without ``quant_bwd``, the
    bf16 backward): reproduces the live outputs and agrees with the plain
    versions."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt

    out = []
    for (conv, mode), r in sorted(rec.items()):
        n, h, w, ci = r["x"].shape
        co = r["out"][0].shape[-1]
        rch = nvt.pick_chunk_rows(h, w, n, ci, co, conv, mode)
        ops = {k: r[k] for k in ("x", "w", "s", "t", "res", "dy", "dzsum",
                                 "dzssq")}
        ops["dy"] = ops["dy"].contiguous()
        ops["dxout"] = (r["dxout"].contiguous() if mode == "entry"
                        else None)
        kw = dict(conv=conv, mode=mode, rch=rch, quant_bwd=quant_bwd)
        got = nvt.half_stages(**ops, **kw)
        assert torch.equal(got["y"], r["out"][0]), (conv, mode)
        if mode == "entry":
            assert torch.equal(got["x_res"], r["out"][3])
        err = _agree_nv_train(got, nvt.half_stages(**ops, **kw, plain=True),
                              ("live", conv, mode), True, quant_bwd)
        if quant_bwd:   # the dgrad's slab of the live cotangent, byte for byte
            cts = (ops["dy"], got["y"], ops["dzsum"], ops["dzssq"],
                   got["rowmax_g"])
            pre = dict(conv=conv, rch=rch[1])
            assert torch.equal(nvt.dgrad_pre(*cts, **pre),
                               nvt.dgrad_pre_plain(*cts, **pre)), (conv, mode)
        else:   # the bf16 dgrad's slab bit for bit, two calls the same bits
            cts = (ops["dy"], got["y"], ops["dzsum"], ops["dzssq"])
            assert torch.equal(nvt.dgrad_bf16_pre(*cts, conv=conv),
                               nvt.dgrad_bf16_pre_plain(*cts, conv=conv)), (
                                   conv, mode)
            dargs = cts + (nvt.pack_w_bf16_dgrad(ops["w"]), ops["x"],
                           ops["s"], ops["t"], ops["res"], ops["dxout"])
            dkw = dict(conv=conv, mode=mode, rch=rch[1])
            for a, b in zip(nvt.dgrad_conv_bf16(*dargs, **dkw),
                            nvt.dgrad_conv_bf16(*dargs, **dkw)):
                assert (a is None and b is None) or torch.equal(a, b), (
                    conv, mode)
        out.append(dict(conv=conv, mode=mode, n=n, h=h, w=w, cin=ci,
                        cout=co, rch=list(rch), max_abs_err=err))
    return out


# the ResNet-50 training runs: mode -> (config flags, launches per step)
R50_MODES = {"fqt": ({"use_int8_train_bwd": True}, NV_TRAIN_PER_STEP),
             "qat": ({"use_int8_train": True}, NV_QAT_PER_STEP),
             "bf16": ({}, {})}


def bneck_training_phase(workdir, mode: str):
    """Full-width ResNet-50 training through setup and the train step,
    Synthetic 224x224 data, batch 128: with ``use_int8_train_bwd`` (FQT on
    the NV training halves), with ``use_int8_train`` alone (QAT: their int8
    forward and bf16 backward) or with neither (bf16 on cuDNN, the
    yardstick)."""
    import contextlib
    import math

    import torch

    from pytorch_ddp_resnet_tpu_torch.algos.steps import make_train_step
    from pytorch_ddp_resnet_tpu_torch.algos.train import setup
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt
    from pytorch_ddp_resnet_tpu_torch.utils.rng import Key

    shape = [224, 224, 3]
    # ImageNet is not on the machine; the training transforms cut to those
    # the port has (RandomScale is host-only in JAX, Color not ported;
    # RandomCrop at 224 of a 224 image is the identity)
    flags, per_step = R50_MODES[mode]
    nv = bool(flags)
    config = write_run(
        workdir, f"resnet-50-train-{mode}", R50_CONFIG,
        dataset_cls_name="Synthetic",
        dataset_args={"shape": shape, "num_classes": 1000, "n_train": 1024,
                      "n_test": 128},
        data_aug_train={"ToTensorTransform": {}, "FlipTransform": {"p": 0.5},
                        "StandardizeWhiteningTransform": {}},
        data_aug_test={"ToTensorTransform": {},
                       "StandardizeWhiteningTransform": {}},
        batch_size=BATCH, **flags)
    t0 = time.perf_counter()
    ls = setup(config, verbose=False)
    setup_s = time.perf_counter() - t0
    model, pipeline, ts = ls["model"], ls["pipeline"], ls["train_state"]
    assert model.param_count() == 25549416, model.param_count()
    step = pipeline.bind_train_step(
        make_train_step(model, ls["optimizer"], ls["num_microbatches"],
                        augment_fn=ls["augment_fn"]),
        pass_indices=ls["augment_pass_indices"])
    root = Key(config.get("seed", 0))
    # 1024 images are 8 steps an epoch: two epochs' feeds
    feeds = [b for e in (0, 1) for _, b in pipeline.train_feed(e)][
        :TRAIN_STEPS + PROFILE_STEPS]
    lr = ls["scheduler"].get_lr()
    before = {k: v.detach().clone() for k, v in ts["params"].items()}
    record = RecordNVHalves() if nv else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path, with the launch counts zeroed just before
    reset_launches()
    metrics = []
    for gs in range(TRAIN_STEPS):
        if gs == WARM_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        with (record if gs == 0 and record is not None
              else contextlib.nullcontext()):
            ts, m = step(ts, *feeds[gs], lr, root.fold_in(gs))
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (TRAIN_STEPS - WARM_STEPS)
    launches = all_launches()
    shapes = dict(nvt.launch_shapes)
    peak_mem = torch.cuda.max_memory_allocated() / 2 ** 30

    losses = [float(m["loss"]) for m in metrics]
    assert launches == {k: v * TRAIN_STEPS for k, v in per_step.items()}, \
        launches
    if nv:   # every half one int8 forward, one backward of the mode's body
        body = "" if mode == "fqt" else "_bf16"
        for stage in ("fwd", "dgrad" + body, "wgrad" + body):
            halves = {}
            for (st, conv, kind, *_), c in shapes.items():
                if st == stage:
                    halves[(conv, kind)] = halves.get((conv, kind), 0) + c
            assert halves == {k: v * TRAIN_STEPS for k, v in
                              NVT_HALVES_PER_STEP.items()}, (stage, halves)
        assert {st for st, *_ in shapes} == {"fwd", "dgrad" + body,
                                             "wgrad" + body}, shapes
    assert all(math.isfinite(v) for v in losses), losses
    for k, v in ts["params"].items():
        assert not torch.equal(v, before[k]), f"{k} did not change"
    counts = {int(b) for n, b in ts["model_state"].items()
              if n.endswith("count")}
    assert counts == {TRAIN_STEPS}, counts
    live = (live_nv_check(record.rec, quant_bwd=mode == "fqt") if nv
            else None)

    def more_steps():
        nonlocal ts
        for gs in range(TRAIN_STEPS, TRAIN_STEPS + PROFILE_STEPS):
            ts, _ = step(ts, *feeds[gs], lr, root.fold_in(gs))

    profile = _profile_steps(more_steps, PROFILE_STEPS)
    return dict(
        launches=launches, shapes=shapes, steps=TRAIN_STEPS, losses=losses,
        lr=lr, setup_s=setup_s, step_ms=step_ms,
        img_per_s=BATCH / step_ms * 1e3, peak_mem_gib=peak_mem,
        live_halves=live, profile=profile)


# the per-part times of a staged NV kernel's rows (phases 10 and 20; the
# transition forward's, phase 15), and the int8 dgrad's sum alone
PART_KEYS = ("amax_ms", "amax_plain_ms", "amax_bound_ms", "pre_ms",
             "pre_plain_ms", "pre_bound_ms", "gemm_ms", "gemm_plain_ms",
             "gemm_bound_ms")
NV_PART_KEYS = PART_KEYS + ("sum_ms", "sum_bound_ms")


def nv_train_summary(rows, training, names=NVT_NAMES, run="FQT"):
    """One entry per NV training stage kernel: the run's launches, and the
    device time per train step: the kernel phase's per-call times summed
    over the halves the main path ran (``training["shapes"]``). A stage the
    run did not launch (the bf16 forward in QAT) is summed over the halves
    of the run's forward."""
    out = []
    for name in names:
        stage = name[len("nv_half_"):].split(".")[0]
        if not any(k[0] == stage for k in training["shapes"]):
            stage = stage.split("_")[0]
        mine = [r for r in rows if r["name"] == name]
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0,
                   bytes_ms=0.0)
        tot.update({k: 0.0 for k in NV_PART_KEYS if k in mine[0]})
        for (st, conv, mode, n, h, w, cin, cout), count in \
                training["shapes"].items():
            if st != stage:
                continue
            row = next(r for r in mine if (r["n"], r["h"], r["conv"],
                                           r["mode"], r["cin"], r["cout"])
                       == (n, h, conv, mode, cin, cout))
            add_scaled(tot, row, count / training["steps"])
        out.append(dict(
            name=name, route="cuda", source=SOURCES.get(name, NVT_SOURCE),
            replaces=REPLACES[name],
            launches=training["launches"].get(name, 0),
            split_launches={k: v for k, v in training["launches"].items()
                            if k.split(".")[0] == name or k == name
                            or (stage in ("dgrad", "wgrad")
                                and k == "nv_half_bwd.amax")},
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=max(tot["ops_ms"], tot["bytes_ms"]),
            bound_by=("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                      else "bytes"),
            library_ms=tot["library_ms"],
            **{k: tot[k] for k in NV_PART_KEYS if k in tot},
            per=f"ResNet-50 {run} train step at batch {BATCH} (ms per "
                "call summed over the step's halves; launches over the run)",
            stages=[{k: r[k] for k in ("n", "h", "conv", "mode", "cin",
                                       "cout", "rch", "ms", "plain_ms",
                                       "library_ms", "bound_ms", "bound_by",
                                       "max_abs_err")} for r in mine]))
    return out


# --- phases 17 to 19: use_pallas_conv's conv3x3_same, the int8 1x1 conv ------

def _bf16_err(got, want, what) -> float:
    """bf16 outputs: within 2 bf16 ulps of the tensor's largest value (the
    tensor cores sum in f32, the plain version in float64)."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    d = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    assert d <= 2 * 2.0 ** (math.floor(math.log2(top)) - 7), (what, d, top)
    return d


def _sum_err(got, want, what) -> float:
    """f32 sums over the tensor cores' f32 accumulators: within 1e-4 of the
    largest value (that accumulation does not round to nearest)."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    d = (got - want).abs().max().item()
    assert d <= 1e-4 * want.abs().max().item(), (what, d)
    return d


def _same_passes(k, x_cs, dy_cs, w_pad, h, w, plain):
    """conv3x3_same's three passes on its lane operands (the op's own
    padding), through the kernels or the plain versions."""
    conv, wgrad = ((k.conv3x3_bf16_plain, k.conv3x3_wgrad_plain) if plain
                   else (k.conv3x3_bf16, k.conv3x3_wgrad))
    wp, wdg = k.pack_weights(w_pad), k.pack_weights_dgrad(w_pad)
    return {"fwd": lambda: conv(x_cs, wp, h=h, w_img=w),
            "dgrad": lambda: conv(dy_cs, wdg, h=h, w_img=w),
            "wgrad": lambda: wgrad(x_cs, dy_cs, h=h, w_img=w)}


def same_kernel_phase(peaks):
    """Rows per (pass, shape) of conv3x3_same at batch 128: the forward and
    dgrad (conv3x3_bf16) and the wgrad (conv3x3_wgrad) on the op's own
    operands against their plain versions, bit-equal over two calls, timed
    beside the plain version, cuDNN's bf16 forward, input gradient and
    weight gradient (channels-last) and the bound of the unpadded conv (the
    forward and dgrad also by part in device time, their prepass's slab
    byte for byte; the wgrad also in device time and TFLOP/s of useful
    work); and the whole op, value and both gradients, against the plain
    versions of the unpadded conv. Returns the rows and the op's errors."""
    import torch
    import torch.nn.functional as F

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k

    flops_bf16, _, bw, _ = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    rows, ops = [], []

    def randn(*shape, s=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * s).to(
            torch.bfloat16)

    for c, h, w in SAME_SHAPES:
        n = BATCH * h * w
        x, dy = randn(BATCH, h, w, c), randn(BATCH, h, w, c)
        wt = randn(c, c, 3, 3, s=(9 * c) ** -0.5)
        pad = -c % 32  # the op's zero channels
        w_pad = F.pad(wt, (0, 0, 0, 0, 0, pad, 0, pad))
        x_cs = k.pad_rows(k.nhwc_to_lanes(x), pad)
        dy_cs = k.pad_rows(k.nhwc_to_lanes(dy), pad)
        kern = _same_passes(k, x_cs, dy_cs, w_pad, h, w, plain=False)
        plain = _same_passes(k, x_cs, dy_cs, w_pad, h, w, plain=True)
        lib = dict(zip(("fwd", "dgrad", "wgrad"),
                       cudnn_times(g, c, c, h, w, 3)))
        ops_ms = 2 * 9 * c * c * n / flops_bf16 * 1e3
        byts = {"fwd": 2 * (2 * c * n + 9 * c * c),
                "dgrad": 2 * (2 * c * n + 9 * c * c),
                "wgrad": 2 * 2 * c * n + 4 * 9 * c * c}
        for name in ("fwd", "dgrad", "wgrad"):
            check = _sum_err if name == "wgrad" else _bf16_err
            got = kern[name]()
            err = check(got, plain[name](), (name, c))
            rows.append(dict(
                name="conv3x3_wgrad" if name == "wgrad" else "conv3x3_bf16",
                pass_=name, c=c, h=h, w=w, n=n, padded_c=x_cs.shape[0],
                max_abs_err=err, ms=time_ms(kern[name], 10),
                plain_ms=time_ms(plain[name], 1), library_ms=lib[name],
                ops_ms=ops_ms, bytes_ms=byts[name] / bw * 1e3))
            assert torch.equal(got, kern[name]()), (name, "bits", c)
            r = rows[-1]
            if name == "wgrad":
                r["dev_ms"] = device_ms(kern[name], 10)
                # useful work: the padded channels' MACs do not count
                r["tflops"] = 2 * 9 * c * c * n / r["ms"] / 1e9
                r["plan"] = list(k.wgrad_tma_plan(
                    x_cs.shape[0], x_cs.shape[0], n, h, w))
            else:
                # the conv's route: its prepass's slab byte for byte, then
                # the prepass and the GEMM apart in device time
                src = x_cs if name == "fwd" else dy_cs
                cp = src.shape[0]
                lay = k.conv3x3_bf16_plan(n, h, w, cp, cp)
                assert torch.equal(k.conv3x3_bf16_pre(src, lay=lay),
                                   k.conv3x3_bf16_pre_plain(src, lay=lay)), \
                    (name, "slab", c)
                split = kernel_split_ms(kern[name], 5, BF16_KERNELS.values(),
                                        need=BF16_KERNELS.values())
                for part, key in BF16_KERNELS.items():
                    r[f"{part}_dev_ms"] = split[key] if split else None
                r["dev_ms"] = sum(split.values()) if split else None
                r["pre_bound_ms"] = 2 * (cp * n + lay.slab_len * cp) / bw * 1e3

        # the op itself, padding and slicing included, against the plain
        # versions of the unpadded conv
        xr, wr = x.clone().requires_grad_(), wt.clone().requires_grad_()
        y = k.conv3x3_same(xr, wr)
        y.backward(dy)
        xu, dyu = k.nhwc_to_lanes(x), k.nhwc_to_lanes(dy)
        want_y = k.conv3x3_bf16_plain(xu, k.pack_weights(wt), h=h, w_img=w)
        want_dx = k.conv3x3_bf16_plain(dyu, k.pack_weights_dgrad(wt), h=h,
                                       w_img=w)
        want_dw = k.conv3x3_wgrad_plain(xu, dyu, h=h, w_img=w).permute(
            3, 2, 0, 1).to(torch.bfloat16)
        ops.append(dict(c=c, h=h, w=w, max_abs_err=max(
            _bf16_err(k.nhwc_to_lanes(y.detach()), want_y, ("op y", c)),
            _bf16_err(k.nhwc_to_lanes(xr.grad), want_dx, ("op dx", c)),
            _bf16_err(wr.grad, want_dw, ("op dw", c)))))
        del x, dy, x_cs, dy_cs, kern, plain, xr, wr, y
        torch.cuda.empty_cache()
    for r in rows:
        r["bound_ms"] = max(r["ops_ms"], r["bytes_ms"])
        r["bound_by"] = ("operations" if r["ops_ms"] >= r["bytes_ms"]
                         else "bytes")
    return rows, ops


def conv1x1_phase(peaks):
    """Rows per (shape, direction, epilogue mode): the int8 1x1 kernel at
    ResNet-50's 1x1 shapes (batch 128) against its plain version (int8 and
    bf16 outputs equal), timed beside the plain version, one
    ``torch._int_mm`` with the same epilogue in torch ops, cuDNN's bf16 1x1
    conv (channels-last) and the bound."""
    import torch
    import torch.nn.functional as F

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv1x1 as c1

    _, ops_int8, bw, _ = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    rows = []

    def uniform(m, lo, hi):
        return torch.rand(m, device=dev, generator=g) * (hi - lo) + lo

    for h, w, ch, wd in C1_STAGES:
        n = BATCH * h * w
        for cin, cout in ((ch, wd), (wd, ch)):
            xq = torch.randint(-127, 128, (cin, n), device=dev, generator=g,
                               dtype=torch.int8)
            wq = torch.randint(-127, 128, (cout, cin), device=dev,
                               generator=g, dtype=torch.int8)
            sigma = (127.0 ** 2 / 3) * cin ** 0.5  # std of the s32 sums
            scale, shift = uniform(cout, 0.5, 1.5) / sigma, uniform(
                cout, -0.5, 0.5)
            res = torch.randn(cout, n, device=dev, generator=g).to(
                torch.bfloat16)
            sb, tb = uniform(cout, 10.0, 40.0), uniform(cout, -5.0, 5.0)
            x4 = torch.randn(BATCH, cin, h, w, device=dev, generator=g).to(
                torch.bfloat16).to(memory_format=torch.channels_last)
            w4 = torch.randn(cout, cin, 1, 1, device=dev, generator=g).to(
                torch.bfloat16).to(memory_format=torch.channels_last)
            cudnn_ms = time_ms(lambda: F.conv2d(x4, w4), 10)
            del x4, w4
            # the yardstick's layout: positions major, as cuBLASLt's int8
            # product takes it (x^T row-major, W^T column-major)
            x_t, res_t = xq.t().contiguous(), res.t().contiguous()
            for mode in C1_MODES:
                args = [xq, wq, scale, shift]
                kw = dict(relu=mode != "bf16+res+dual")
                if mode == "int8":
                    kw["inv_out_scale"] = 127 / 4
                if mode == "bf16+res+dual":
                    args += [res, (sb, tb)]

                def run(fn=c1.conv1x1_lanes_requant, args=args, kw=kw):
                    return fn(*args, **kw)

                def library(mode=mode, kw=kw):
                    y = torch._int_mm(x_t, wq.t()).float() * scale + shift
                    if mode == "bf16+res+dual":
                        y = y + res_t.float()
                        q = torch.clamp(torch.round(torch.clamp_min(
                            y * sb + tb, 0.0)), -127, 127).to(torch.int8)
                        return y.to(torch.bfloat16), q
                    y = torch.clamp_min(y, 0.0)
                    if mode == "int8":
                        return torch.clamp(torch.round(
                            y * kw["inv_out_scale"]), -127, 127).to(
                                torch.int8)
                    return y.to(torch.bfloat16)

                got = run()
                want = run(c1.conv1x1_lanes_requant_plain)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                for o, r in zip(got, want):
                    assert o.dtype == r.dtype and o.shape == r.shape
                    assert torch.equal(o, r), (cin, cout, mode, (
                        o.float() - r.float()).abs().max().item())
                    assert r.unique().numel() > 50, (cin, cout, mode)
                byts = (cin * n + cin * cout + 8 * cout
                        + cout * n * (1 if mode == "int8" else 2)
                        + (3 * cout * n + 8 * cout if mode.endswith("dual")
                           else 0))
                rows.append(dict(
                    name="conv1x1_lanes_requant", h=h, w=w, cin=cin,
                    cout=cout, n=n, mode=mode, max_abs_err=0.0,
                    ms=time_ms(run, 10),
                    plain_ms=time_ms(
                        lambda: run(c1.conv1x1_lanes_requant_plain), 1),
                    library_ms=time_ms(library, 10), cudnn_bf16_ms=cudnn_ms,
                    ops_ms=2 * cin * cout * n / ops_int8 * 1e3,
                    bytes_ms=byts / bw * 1e3))
            del xq, wq, res, x_t, res_t
            torch.cuda.empty_cache()
    for r in rows:
        r["bound_ms"] = max(r["ops_ms"], r["bytes_ms"])
        r["bound_by"] = ("operations" if r["ops_ms"] >= r["bytes_ms"]
                         else "bytes")
    return rows


class RecordSame:
    """Around the first use_pallas_conv train step (phase 19): the operands
    and outputs of the step's first conv3x3_same forward, and of the dgrad
    and wgrad of the first conv the backward reaches (the op builds fresh
    operands for every call and the kernels write fresh outputs, so
    references suffice); and the convs the step still leaves on
    ``F.conv2d``, by (kernel size, stride, Cin)."""

    def __enter__(self):
        import torch.nn.functional as F

        from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k

        self.k, self.orig = k, (k.conv3x3_bf16, k.conv3x3_wgrad)
        orig_conv, orig_wgrad = self.orig
        rec, last = {}, {}
        self.rec = rec

        def conv(x_cs, w_packed, *, h, w_img):
            out = orig_conv(x_cs, w_packed, h=h, w_img=w_img)
            last["conv"] = dict(args=(x_cs, w_packed), out=out, h=h,
                                w=w_img)
            rec.setdefault("fwd", last["conv"])
            return out

        def wgrad(x_cs, dy_cs, *, h, w_img):
            out = orig_wgrad(x_cs, dy_cs, h=h, w_img=w_img)
            if "wgrad" not in rec:
                rec["wgrad"] = dict(args=(x_cs, dy_cs), out=out, h=h,
                                    w=w_img)
                rec["dgrad"] = last["conv"]
            return out

        k.conv3x3_bf16, k.conv3x3_wgrad = conv, wgrad
        # the convs the step leaves on the library: (kernel, stride, Cin)
        self.library = {}
        self.conv2d = F.conv2d

        def counting(x, weight, *args, stride=1, **kw):
            key = (weight.shape[-1], stride, weight.shape[1])
            self.library[key] = self.library.get(key, 0) + 1
            return self.conv2d(x, weight, *args, stride=stride, **kw)

        F.conv2d = counting
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F

        self.k.conv3x3_bf16, self.k.conv3x3_wgrad = self.orig
        F.conv2d = self.conv2d
        return False


def live_same_check(rec):
    """The recorded passes through the kernels on their live operands: each
    reproduces its live output and agrees with its plain version (the
    conv passes' prepass slab byte for byte)."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k

    out = {}
    for name in ("fwd", "dgrad", "wgrad"):
        r = rec[name]
        kw = dict(h=r["h"], w_img=r["w"])
        kern, plain = ((k.conv3x3_wgrad, k.conv3x3_wgrad_plain)
                       if name == "wgrad"
                       else (k.conv3x3_bf16, k.conv3x3_bf16_plain))
        got = kern(*r["args"], **kw)
        assert torch.equal(got, r["out"]), name
        if name != "wgrad":  # the conv's prepass on the live operand
            src, wp = r["args"]
            lay = k.conv3x3_bf16_plan(src.shape[1], r["h"], r["w"],
                                      src.shape[0], wp.shape[0])
            assert torch.equal(k.conv3x3_bf16_pre(src, lay=lay),
                               k.conv3x3_bf16_pre_plain(src, lay=lay)), name
        check = _sum_err if name == "wgrad" else _bf16_err
        out[name] = dict(c=r["args"][0].shape[0], n=r["args"][0].shape[1],
                         max_abs_err=check(got, plain(*r["args"], **kw),
                                           ("live", name)))
    return out


def same_summary(rows, pallas, mix):
    """The entries of conv3x3_wgrad (new) and of conv3x3_bf16 on the
    use_pallas_conv path: phase 17's per-call times summed over the step's
    22 calls (``mix``: calls per step by width; the bf16 conv's forward and
    dgrad also in device time by part), launches of phase 19."""
    def step_sum(name, passes):
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0,
                   bytes_ms=0.0, dev_ms=0.0, pre_dev_ms=0.0, gemm_dev_ms=0.0)
        for r in rows:
            if r["name"] == name and r["pass_"] in passes and r["c"] in mix:
                for key in tot:
                    if tot[key] is not None:
                        tot[key] = (None if r.get(key, 0.0) is None
                                    else tot[key] + r.get(key, 0.0)
                                    * mix[r["c"]])
        tot["bound_ms"] = max(tot["ops_ms"], tot["bytes_ms"])
        tot["bound_by"] = ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                           else "bytes")
        return tot

    keys = ("pass_", "c", "h", "w", "padded_c", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "max_abs_err")
    wg_keys = keys + ("dev_ms", "tflops")
    wg = step_sum("conv3x3_wgrad", ("wgrad",))
    conv = step_sum("conv3x3_bf16", ("fwd", "dgrad"))
    per = (f"use_pallas_conv train step at batch {BATCH} (ms per call "
           "summed over the step's 22 calls; launches over the run)")
    wgrad_entry = dict(
        name="conv3x3_wgrad", route="cuda", source=SAME_SOURCE,
        replaces=REPLACES["conv3x3_wgrad"],
        launches=pallas["launches"].get("conv3x3_wgrad", 0),
        max_abs_err=max(r["max_abs_err"] for r in rows
                        if r["name"] == "conv3x3_wgrad"),
        ms=wg["ms"], plain_ms=wg["plain_ms"], bound_ms=wg["bound_ms"],
        bound_by=wg["bound_by"], library_ms=wg["library_ms"], per=per,
        dev_ms=(None if any(r["dev_ms"] is None for r in rows
                            if r["name"] == "conv3x3_wgrad")
                else sum(r["dev_ms"] * mix[r["c"]] for r in rows
                         if r["name"] == "conv3x3_wgrad" and r["c"] in mix)),
        stages=[{key: r[key] for key in wg_keys} for r in rows
                if r["name"] == "conv3x3_wgrad"])
    conv_path = dict(
        launches=pallas["launches"].get("conv3x3_bf16", 0), per=per,
        ms=conv["ms"], plain_ms=conv["plain_ms"], bound_ms=conv["bound_ms"],
        bound_by=conv["bound_by"], library_ms=conv["library_ms"],
        dev_ms=conv["dev_ms"], pre_dev_ms=conv["pre_dev_ms"],
        gemm_dev_ms=conv["gemm_dev_ms"],
        stages=[{key: r[key] for key in keys + (
            "dev_ms", "pre_dev_ms", "gemm_dev_ms", "pre_bound_ms")}
                for r in rows if r["name"] == "conv3x3_bf16"])
    return wgrad_entry, conv_path


def conv1x1_summary(rows):
    """The int8 1x1 conv's entry: a tested op that no main path runs (0
    launches there); ms summed over ResNet-50's eight 1x1 shapes in the
    int8-out mode."""
    mine = [r for r in rows if r["mode"] == "int8"]
    tot = {key: sum(r[key] for r in mine)
           for key in ("ms", "plain_ms", "library_ms", "cudnn_bf16_ms",
                       "ops_ms", "bytes_ms")}
    return dict(
        name="conv1x1_lanes_requant", route="cuda", source=C1_SOURCE,
        replaces=REPLACES["conv1x1_lanes_requant"], launches=0,
        main_path=None,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=tot["ms"], plain_ms=tot["plain_ms"],
        bound_ms=max(tot["ops_ms"], tot["bytes_ms"]),
        bound_by=("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                  else "bytes"),
        library_ms=tot["library_ms"], cudnn_bf16_ms=tot["cudnn_bf16_ms"],
        per=(f"ResNet-50's eight 1x1 shapes at batch {BATCH}, int8 out "
             "(summed); no main path calls the op, so no launches there; "
             "library = torch._int_mm + the epilogue in torch ops"),
        stages=[{key: r[key] for key in (
            "h", "cin", "cout", "mode", "ms", "plain_ms", "library_ms",
            "cudnn_bf16_ms", "bound_ms", "bound_by", "max_abs_err")}
            for r in rows])


def print_training(label, training):
    print(f"{label}: " + json.dumps(
        {k: v for k, v in training.items() if k != "profile"}))
    prof = training["profile"]
    if prof is None:
        print(f"{label} profile: not measured (no device time reported)")
        return
    print(f"{label} profile: " + json.dumps(
        {k: v for k, v in prof.items() if k not in ("top", "host_top")}))
    for row in prof["top"]:
        print("  " + json.dumps(row))
    print(f"{label} host ops by self time per step:")
    for row in prof["host_top"]:
        print("  " + json.dumps(row))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run.", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

    card = nvidia_smi()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name in libs:
        log = build.build_log(name)
        regs = [int(t.split()[0]) for t in log.split("Used ")[1:]
                if t.split()[1].startswith("registers")]
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        print(f"  ptxas {name}: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, "
              f"{len(spills)} with spills")

    # the bf16 forward's kernels: the GEMM's dynamic shared memory is its
    # ring, (128 + BN) * 128 bytes a stage, three stages, and 1 KB to align
    for e in ptxas_entries(build.build_log("fused_block_bf16"), "fused_fwd_"):
        bn = next((b for b in (64, 128, 160) if f"ILi{b}E" in e["name"]),
                  None)
        dyn = 3 * (128 + bn) * 128 + 1024 if bn else 0
        kernel = (f"fused_fwd_gemm_kernel<{bn}>" if bn
                  else "fused_fwd_pre_kernel")
        print(f"  ptxas {kernel}: {e['registers']} registers, {e['smem']} B "
              f"static + {dyn} B dynamic shared memory, "
              f"{e['spill_bytes']} B spilled")

    # the int8 forward's GEMM: 256 threads (two warpgroups, thread 0 also
    # starting the TMA loads), two blocks an SM; ptxas's note where it
    # serializes the wgmmas
    log = build.build_log("fused_block")
    for e in (ptxas_entries(log, "fwd_s8_kernel")
              + ptxas_entries(log, "fwd_slab_kernel")
              + ptxas_entries(log, "dgrad_s8_kernel")):
        print(f"  ptxas fused_block {e['name']}: {e['registers']} "
              f"registers, {e['smem']} B static shared memory, "
              f"{e['spill_bytes']} B spilled")
    for line in log.splitlines():
        if "serialized" in line:
            print(f"  ptxas fused_block: {line.strip()}")

    # the TMA wgrads' kernels: one block of 416 threads an SM (a producer
    # warp, a shifter warpgroup, two consumer warpgroups), bf16 and the
    # transition's s8 one; ptxas's note where it serializes the wgmmas
    for lib_name in ("conv3x3_wgrad", "transition_wgrad", "fused_wgrad_s8"):
        log = build.build_log(lib_name)
        for pattern in ("wgrad_tma_kernel", "wgrad_s8_kernel"):
            for e in ptxas_entries(log, pattern):
                print(f"  ptxas {lib_name} {e['name']}: {e['registers']} "
                      f"registers, {e['spill_bytes']} B spilled")
        for line in log.splitlines():
            if "serialized" in line:
                print(f"  ptxas {lib_name}: {line.strip()}")

    # the NV blocks' kernels on the s8 wgmma mainloop
    for e in ptxas_entries(build.build_log("bneck_nv"), "bneck_wgmma"):
        print(f"  ptxas bneck_nv {e['name']}: {e['registers']} registers, "
              f"{e['spill_bytes']} B spilled")

    # the stem's weight gradient: mma.sync bf16 over a cp.async ring
    for e in ptxas_entries(build.build_log("stem"), "stem_wgrad_tc_kernel"):
        print(f"  ptxas stem {e['name']}: {e['registers']} registers, "
              f"{e['spill_bytes']} B spilled")

    peaks = card_peaks(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    rows = kernel_phase(peaks)
    aug_rows = augment_phase(peaks)
    fqt_rows = fqt_kernel_phase(peaks)
    nv_rows = nv_kernel_phase(peaks)
    nvt_rows = nv_train_kernel_phase(peaks)
    nvt_bf16_rows = nv_train_bf16_kernel_phase(peaks, nvt_rows)
    bf16_rows, seed_rows = bf16_kernel_phase(peaks)
    tr_rows = transition_kernel_phase(peaks)
    same_rows, same_ops = same_kernel_phase(peaks)
    c1_rows = conv1x1_phase(peaks)
    print(f"kernel phases: {time.perf_counter() - t0:.1f} s", flush=True)
    print("conv3x3_wgrad shared-memory route: " + json.dumps(
        SAME_WGRAD_ROUTE))
    for r in same_rows:
        print("  " + json.dumps({k: r[k] for k in (
            "name", "pass_", "c", "padded_c", "h", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "max_abs_err") + tuple(
                k for k in ("dev_ms", "pre_dev_ms", "gemm_dev_ms",
                            "pre_bound_ms", "tflops", "plan") if k in r)}))
    print("conv3x3_same, the op against the unpadded plain conv: "
          + json.dumps(same_ops))
    for r in c1_rows:
        print("  " + json.dumps({k: r[k] for k in (
            "name", "h", "cin", "cout", "mode", "ms", "plain_ms",
            "library_ms", "cudnn_bf16_ms", "bound_ms", "bound_by",
            "max_abs_err")}))
    for r in tr_rows:
        print("  " + json.dumps({k: r[k] for k in (
            "name", "stage", "cin", "cout", "mode", "tile", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "max_abs_err") + tuple(
                k for k in ("dev_ms", "tflops", "tops", "plan") if k in r)}))
    print("seed_bits_expand: bit-equal to the plain seed_bits at "
          f"C x N = {[(c, BATCH * h * w) for c, h, w in STAGES]} for seeds "
          f"{list(SEED_VALUES)}")
    for r in bf16_rows:
        print("  " + json.dumps({k: r[k] for k in (
            "name", "c", "mode", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err") + tuple(k for k in (
                "pre_ms", "gemm_ms", "pre_bound_ms", "gemm_bound_ms",
                "issued_macs", "useful_macs", "issued_n", "bn", "plan",
                "deterministic") if k in r)}))
    for r in seed_rows:
        print("  " + json.dumps(r))
    for r in rows + fqt_rows:
        print("  " + json.dumps({k: r[k] for k in (
            "name", "c", "mode", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err") + tuple(
                k for k in FWD_INT8_PART_KEYS + ("bn", "boxes",
                                                 "tiles", "deterministic")
                if k in r)}))
    for r in nv_rows:
        print("  " + json.dumps({k: r[k] for k in (
            "name", "h", "cin", "wdt", "cout", "stride", "out_int8", "ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err") + NV_ID_ROW_KEYS if k in r}))
    for r in nvt_rows + nvt_bf16_rows:
        print("  " + json.dumps({k: r[k] for k in (
            "name", "n", "h", "conv", "mode", "cin", "cout", "rch", "ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err") + tuple(k for k in (
                ("int8_ms",) + NV_PART_KEYS + ("plan", "layout",
                                               "deterministic")) if k in r)}))
    for r in aug_rows:
        print("  " + json.dumps({k: r[k] for k in ("name",) + AUG_KEYS
                                 + ("chain_max_abs_diff",)}))

    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=REPO)
    try:
        t0 = time.perf_counter()
        serving = serving_phase(workdir)
        print(f"serving phase: {time.perf_counter() - t0:.1f} s", flush=True)
        print("serving: " + json.dumps(
            {k: v for k, v in serving.items() if k != "shapes"}), flush=True)
        t0 = time.perf_counter()
        training = training_phase(workdir, aug_rows)
        print(f"training phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        record = RecordHalves("fused_half_int8")
        fqt = training_phase(workdir, aug_rows, FQT_CONFIG,
                             "wrn-28-10-int8-train", FQT_PER_STEP, record)
        fqt["live_half"] = live_half_check(record.rec["bits"])
        assert sum(record.halves.values()) == 22, record.halves
        fqt["halves_per_step"] = [list(k) + [v] for k, v in
                                  sorted(record.halves.items())]
        print(f"int8 training phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        rec_fused = RecordHalves("fused_half")
        fused = training_phase(workdir, aug_rows, TRAIN_CONFIG,
                               "wrn-28-10-fused", FUSED_PER_STEP, rec_fused,
                               use_fused_block=True)
        fused["live_halves"] = live_bf16_check(rec_fused.rec, quant=False)
        assert sum(rec_fused.halves.values()) == 8, rec_fused.halves
        assert {k[0] for k in rec_fused.halves} == {160}, rec_fused.halves
        fused["halves_per_step"] = [list(k) + [v] for k, v in
                                    sorted(rec_fused.halves.items())]
        print(f"fused bf16 training phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        rec_qat = RecordHalves("fused_half_int8")
        qat = training_phase(
            workdir, aug_rows, FQT_CONFIG, "wrn-28-10-qat", QAT_PER_STEP,
            rec_qat, QAT_SEED_PER_STEP, use_int8_train=True,
            use_int8_train_bwd=False, use_inkernel_dropout=True)
        qat["live_halves"] = live_bf16_check(rec_qat.rec, quant=True)
        by_kind = {}
        for (c, _, _, kind), v in rec_qat.halves.items():
            by_kind[kind] = by_kind.get(kind, 0) + v
            assert (kind == "seed") == (c <= 320), rec_qat.halves
        assert by_kind == {"seed": 15, "bits": 7}, rec_qat.halves
        qat["halves_per_step"] = [list(k) + [v] for k, v in
                                  sorted(rec_qat.halves.items())]
        print(f"QAT + in-kernel dropout training phase: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        rec_lane = RecordTransition()
        lane = training_phase(workdir, aug_rows, FQT_CONFIG,
                              "wrn-28-10-lane-fqt", LANE_FQT_PER_STEP,
                              rec_lane, use_lane_transition=True)
        rec_lane_qat = RecordTransition()
        lane_qat = training_phase(
            workdir, aug_rows, FQT_CONFIG, "wrn-28-10-lane-qat",
            LANE_QAT_PER_STEP, rec_lane_qat, QAT_SEED_PER_STEP,
            steps=LANE_QAT_STEPS, use_int8_train=True,
            use_int8_train_bwd=False, use_inkernel_dropout=True,
            use_lane_transition=True)
        for run, rec, quant_bwd in ((lane, rec_lane, True),
                                    (lane_qat, rec_lane_qat, False)):
            # the run stays open from the stem to the head: the stem's
            # entry, one close before the head, no block converting
            assert rec.calls == 2, rec.calls
            assert rec.layouts == {"layers.to_lane": 1,
                                   "layers._delane": 1}, rec.layouts
            run["layout_conversions_first_step"] = rec.layouts
            run["live_transition"] = live_transition_check(rec.rec,
                                                           quant_bwd)
        print(f"lane-transition training phases: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3

        rec_same = RecordSame()
        pallas = training_phase(
            workdir, aug_rows, TRAIN_CONFIG, "wrn-28-10-pallas-conv",
            PALLAS_PER_STEP, rec_same, calls_per_step=PALLAS_CALLS_PER_STEP,
            use_pallas_conv=True)
        mix = {}
        for (name, cin, _, _, _), v in conv3x3.launch_shapes.items():
            if name == "conv3x3_wgrad":
                mix[cin] = mix.get(cin, 0) + v // (TRAIN_STEPS
                                                   + PROFILE_STEPS)
        assert mix == PALLAS_MIX, mix
        # on the library: the stem (3 -> 160), the two stride-2 conv1s and
        # the two 1x1 projections; no stride-1 3x3 conv of a block
        assert rec_same.library == {(3, 1, 3): 1, (3, 2, 160): 1,
                                    (3, 2, 320): 1, (1, 1, 160): 1,
                                    (1, 1, 320): 1}, rec_same.library
        pallas["library_convs_first_step"] = [
            list(key) + [v] for key, v in sorted(rec_same.library.items())]
        pallas["live_conv"] = live_same_check(rec_same.rec)
        if pallas["profile"] is not None:
            kinds = pallas["profile"]["device_ms_per_step_by_kind"]
            assert kinds.get("conv3x3_same fwd + dgrad (port)", 0) > 0, kinds
            assert "fused int8 half (port)" not in kinds, kinds
            assert "fused bf16 half (port)" not in kinds, kinds
        print(f"pallas-conv training phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        r50 = bneck_serving_phase(workdir)
        print(f"bottleneck serving phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        r50_fqt = bneck_training_phase(workdir, "fqt")
        r50_bf16 = bneck_training_phase(workdir, "bf16")
        print(f"bottleneck training phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        r50_qat = bneck_training_phase(workdir, "qat")
        print(f"bottleneck QAT training phase: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print_training("training", training)
    print_training("int8 training", fqt)
    print_training("fused bf16 training", fused)
    print_training("QAT + in-kernel dropout training", qat)
    print_training("lane-transition FQT training", lane)
    print_training("lane-transition QAT training", lane_qat)
    for label, run, base in (("FQT", lane, fqt), ("QAT", lane_qat, qat)):
        line = dict(step_ms=(run["step_ms"], base["step_ms"]),
                    img_per_s=(run["img_per_s"], base["img_per_s"]),
                    peak_mem_gib=(run["peak_mem_gib"],
                                  base["peak_mem_gib"]))
        if run["profile"] is not None and base["profile"] is not None:
            a = run["profile"]["device_ms_per_step_by_kind"]
            b = base["profile"]["device_ms_per_step_by_kind"]
            line["device_ms_per_step"] = (
                run["profile"]["device_ms_per_step"],
                base["profile"]["device_ms_per_step"])
            line["by_kind"] = {k: (a.get(k, 0.0), b.get(k, 0.0))
                               for k in sorted(set(a) | set(b))}
        print(f"lane transitions vs phase {7 if label == 'FQT' else 14} "
              f"({label}; with, without the flag): " + json.dumps(line))
    print_training("pallas-conv training", pallas)
    line = dict(step_ms=(pallas["step_ms"], training["step_ms"]),
                img_per_s=(pallas["img_per_s"], training["img_per_s"]),
                peak_mem_gib=(pallas["peak_mem_gib"],
                              training["peak_mem_gib"]))
    if pallas["profile"] is not None and training["profile"] is not None:
        a = pallas["profile"]["device_ms_per_step_by_kind"]
        b = training["profile"]["device_ms_per_step_by_kind"]
        for key in ("device_ms_per_step", "busy_share", "kernels_per_step"):
            line[key] = (pallas["profile"][key], training["profile"][key])
        line["by_kind"] = {k: (a.get(k, 0.0), b.get(k, 0.0))
                           for k in sorted(set(a) | set(b))}
    print("use_pallas_conv vs phase 5 (bf16; with, without the flag): "
          + json.dumps(line))
    print_training("resnet-50 serving", {
        k: v for k, v in r50.items() if k != "shapes"})
    for label, run in (("resnet-50 int8 training", r50_fqt),
                       ("resnet-50 bf16 training", r50_bf16),
                       ("resnet-50 QAT training", r50_qat)):
        print_training(label, {k: v for k, v in run.items()
                               if k != "shapes"})
    nvt_kernels = nv_train_summary(
        nvt_rows, r50_fqt,
        NVT_NAMES + ("nv_half_fwd.pre", "nv_half_dgrad.pre",
                     "nv_half_wgrad.pre"))
    if r50_fqt["profile"] is not None:
        kinds = r50_fqt["profile"]["device_ms_per_step_by_kind"]
        summed = sum(k["ms"] for k in nvt_kernels if k["name"] in NVT_NAMES)
        print("resnet-50 int8 training: NV halves per step, phase 10 "
              f"per-call times summed {summed} "
              f"ms, profiled {kinds.get('nv train halves (port)', 0.0)} ms")
    fw8 = next(k for k in nvt_kernels if k["name"] == "nv_half_fwd")
    print("resnet-50 FQT: int8 forward per step, phase 10 per-call times "
          "summed (amax + prepass + mainloop/sum parts): " + json.dumps(
              {k: fw8[k] for k in ("ms", "library_ms", "bound_ms")
               + PART_KEYS + ("launches", "split_launches")}))
    dg8 = next(k for k in nvt_kernels if k["name"] == "nv_half_dgrad")
    print("resnet-50 FQT: int8 dgrad per step, phase 10 per-call times "
          "summed (amax + prepass + GEMM/sum parts, the sum alone): "
          + json.dumps({k: dg8[k] for k in ("ms", "library_ms", "bound_ms")
                        + NV_PART_KEYS + ("launches", "split_launches")}))
    wg8 = next(k for k in nvt_kernels if k["name"] == "nv_half_wgrad")
    print("resnet-50 FQT: int8 wgrad per step, phase 10 per-call times "
          "summed: " + json.dumps({k: wg8[k] for k in (
              "ms", "pre_ms", "gemm_ms", "library_ms", "bound_ms",
              "launches", "split_launches")}))
    fqt_line = dict(step_ms=(r50_fqt["step_ms"], r50_bf16["step_ms"]),
                    img_per_s=(r50_fqt["img_per_s"], r50_bf16["img_per_s"]),
                    peak_mem_gib=(r50_fqt["peak_mem_gib"],
                                  r50_bf16["peak_mem_gib"]))
    if r50_fqt["profile"] is not None and r50_bf16["profile"] is not None:
        for key in ("device_ms_per_step", "busy_share", "kernels_per_step"):
            fqt_line[key] = (r50_fqt["profile"][key],
                             r50_bf16["profile"][key])
    print("resnet-50 FQT vs phase 11's bf16 run (FQT, bf16): "
          + json.dumps(fqt_line))
    nvt_bf16_kernels = nv_train_summary(
        nvt_bf16_rows, r50_qat, NVT_BF16_NAMES + (
            "nv_half_dgrad_bf16.pre", "nv_half_wgrad_bf16.pre"), "QAT")
    dg = next(k for k in nvt_bf16_kernels if k["name"] == "nv_half_dgrad_bf16")
    print("resnet-50 QAT: bf16 dgrad per step, phase 20 per-call times "
          "summed (prepass, GEMM + sum, the sum alone, each beside its "
          "bound): " + json.dumps({k: dg[k] for k in (
              "ms", "library_ms", "bound_ms", "pre_ms", "pre_bound_ms",
              "gemm_ms", "gemm_bound_ms", "sum_ms", "sum_bound_ms",
              "launches", "split_launches")}))
    wg = next(k for k in nvt_bf16_kernels if k["name"] == "nv_half_wgrad_bf16")
    print("resnet-50 QAT: bf16 wgrad per step, phase 20 per-call times "
          "summed: " + json.dumps({k: wg[k] for k in (
              "ms", "pre_ms", "gemm_ms", "library_ms", "bound_ms",
              "launches", "split_launches")}))
    # the QAT step's halves: phase 10's int8 forward, phase 20's bf16
    # dgrad and wgrad (its prepass included), each summed over the halves
    # the QAT run launched
    qat_halves = nv_train_summary(nvt_rows, r50_qat, NVT_NAMES[:1], "QAT")
    qat_line = dict(
        halves_per_step_summed_ms=qat_halves[0]["ms"] + sum(
            k["ms"] for k in nvt_bf16_kernels
            if k["name"] in NVT_BF16_NAMES[1:]),
        step_ms=(r50_qat["step_ms"], r50_fqt["step_ms"],
                 r50_bf16["step_ms"]),
        img_per_s=(r50_qat["img_per_s"], r50_fqt["img_per_s"],
                   r50_bf16["img_per_s"]),
        peak_mem_gib=(r50_qat["peak_mem_gib"], r50_fqt["peak_mem_gib"],
                      r50_bf16["peak_mem_gib"]))
    runs = (r50_qat, r50_fqt, r50_bf16)
    if all(r["profile"] is not None for r in runs):
        kinds = [r["profile"]["device_ms_per_step_by_kind"] for r in runs]
        qat_line["halves_profiled_ms"] = kinds[0].get(
            "nv train halves (port)", 0.0)
        for key in ("device_ms_per_step", "busy_share", "kernels_per_step"):
            qat_line[key] = tuple(r["profile"][key] for r in runs)
        qat_line["by_kind"] = {k: tuple(d.get(k, 0.0) for d in kinds)
                               for k in sorted(set().union(*kinds))}
    print("resnet-50 QAT vs phase 11's FQT and bf16 runs (QAT, FQT, bf16): "
          + json.dumps(qat_line))
    fqt_kernels = fqt_summary(fqt_rows, fqt, record.halves)
    if fqt["profile"] is not None:
        kinds = fqt["profile"]["device_ms_per_step_by_kind"]
        profiled = (kinds.get("fused int8 half (port)", 0.0)
                    + kinds.get("stem (port)", 0.0))
        print("int8 training: port kernels per step, phase 6 per-call "
              f"times summed {sum(k['ms'] for k in fqt_kernels)} ms, "
              f"profiled {profiled} ms")
    dg = next(k for k in fqt_kernels if k["name"] == "fused_half_dgrad")
    print("FQT: fused int8 dgrad per step, phase 6 per-call times summed "
          "(device time by part: amax pass, quantizer, prepass, s8 wgmma "
          "GEMM, sum; each beside its bound; cuDNN's bf16 input gradient): "
          + json.dumps({k: dg.get(k) for k in (
              "ms", "dev_ms", "amax_dev_ms", "quant_dev_ms", "pre_dev_ms",
              "gemm_dev_ms", "sum_dev_ms", "amax_bound_ms",
              "quant_bound_ms", "pre_bound_ms", "gemm_bound_ms", "pre_ms",
              "gemm_ms", "library_ms", "bound_ms", "launches")}))
    bf16_kernels = bf16_summary(bf16_rows, fused, qat, rec_fused.halves,
                                rec_qat.halves)
    wg = next(k for k in bf16_kernels if k["name"] == "fused_half_bf16_wgrad")
    print("QAT: fused bf16 wgrad per step, phase 12 per-call times summed "
          "(prepass, mainloop + sum): " + json.dumps({k: wg[k] for k in (
              "ms", "pre_ms", "gemm_ms", "library_ms", "bound_ms",
              "launches", "split_launches", "seed_launches")}))
    dg = next(k for k in bf16_kernels if k["name"] == "fused_half_bf16_dgrad")
    print("QAT: fused bf16 dgrad per step, phase 12 per-call times summed "
          "(prepass, wgmma GEMM + sum, each beside its bound): "
          + json.dumps({k: dg[k] for k in (
              "ms", "pre_ms", "gemm_ms", "pre_bound_ms", "gemm_bound_ms",
              "library_ms", "bound_ms", "launches", "split_launches",
              "seed_launches")}))
    fw = next(k for k in bf16_kernels if k["name"] == "fused_half_bf16_fwd")
    print("fused bf16: bf16 forward per step, phase 12 per-call times "
          "summed (prepass, wgmma GEMM + sum, each beside its bound; MACs "
          "issued and useful, N columns issued and Cout): " + json.dumps(
              {k: fw[k] for k in ("ms", "pre_ms", "gemm_ms", "library_ms",
                                  "bound_ms") + FWD_PART_KEYS
               + ("launches",)}) + " " + json.dumps(
              {k: [r[k] for r in bf16_rows
                   if r["name"] == "fused_half_bf16_fwd"][0]
               for k in ("issued_n", "cout", "bn", "tiles")}))
    for label, run, halves in (("fused bf16 training", fused,
                                rec_fused.halves),
                               ("QAT + in-kernel dropout training", qat,
                                rec_qat.halves)):
        if run["profile"] is not None:
            kinds = run["profile"]["device_ms_per_step_by_kind"]
            names = BF16_NAMES if run is fused else BF16_NAMES[1:]
            summed = sum(_bf16_mix(bf16_rows, nm, halves)["ms"]
                         for nm in names)
            print(f"{label}: bf16 half kernels per step, phase 12 per-call "
                  f"times summed {summed} ms, profiled "
                  f"{kinds.get('fused bf16 half (port)', 0.0)} ms")
    conv_kernels = kernel_summary(rows, serving)
    wgrad_entry, conv_path = same_summary(same_rows, pallas, mix)
    if pallas["profile"] is not None:
        kinds = pallas["profile"]["device_ms_per_step_by_kind"]
        print("pallas-conv training: conv3x3_same kernels per step, phase 17 "
              f"per-call times summed {conv_path['ms']} + "
              f"{wgrad_entry['ms']} ms, profiled "
              f"{kinds.get('conv3x3_same fwd + dgrad (port)', 0.0)} + "
              f"{kinds.get('conv3x3_same wgrad (port)', 0.0)} ms")
    # the bf16 conv's prepass and GEMM run in serving's calibration and in
    # the pallas-conv step
    for entry in conv_kernels:
        if entry["name"] in CALIB_PER_BATCH:
            entry["split_launches"] = {
                "serving": entry["launches"],
                "pallas_conv_training": pallas["launches"].get(
                    entry["name"], 0)}
            entry["launches"] = sum(entry["split_launches"].values())
    conv_kernels[0]["pallas_conv_step"] = conv_path
    assert conv_kernels[0]["name"] == "conv3x3_bf16"
    print(f"card: {nvidia_smi()}")
    print(json.dumps({"kernels": conv_kernels
                      + [augment_summary(aug_rows, training)]
                      + fqt_kernels + nv_summary(nv_rows, r50)
                      + nvt_kernels + nvt_bf16_kernels + bf16_kernels
                      + transition_summary(tr_rows, lane, lane_qat)
                      + [wgrad_entry, conv1x1_summary(c1_rows)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
