#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (kaldi_lstm_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; imports nothing of JAX. Phases, in order
(any failure exits nonzero before the result lines are printed):

1. environment: torch and CUDA versions, the card's name and power limit;
2. build every kernel from kaldi_lstm_tpu_torch/csrc/ (one nvcc each,
   started together) and print nvcc's register/shared-memory report;
3. hold the inference kernel (K5, one persistent cooperative launch per
   call) against its plain PyTorch version on the card at the serving
   path's widths (S=8, T=128 and 1000, clipped, ragged), at the
   cross-validation shape (S=256, T=20), at the deep config's layer-2
   width (I=512), at inputs too wide for the weights to stay in shared
   memory (I=1024, 1501) and at the streaming shapes (S=1 and S=64,
   T=20); time the entry point `lstm_infer` and the plain version, both
   on batch-major x, with CUDA events at S=8 (T=128, 1000), S=256
   (T=20) and I=512 (T=1000), and print the time per step at S=8; then
   K5's advance-mask entry point (the sticky server's ragged ticks)
   against the masked scan at S=4 and S=64, T=20 (lengths 0 to 20 from
   a seed, a skipped middle frame), at S=1, on the 4-byte-copy instance
   and with the weights in device memory: the valid rows of r and the
   final (c, r), a stream of length 0 unchanged, a mask set everywhere
   bit for bit the unmasked kernel; masked and unmasked timed at S=4
   and S=64;
3b. hold the training kernels K1-K4 (LSTMP forward with residuals, BPTT,
   fused senone affine + xent forward and backward, all four with their
   products on the 3xTF32 tensor-core mainloop) against their plain
   versions at the
   flagship training width (S=256, T=20, I=40, C=800, R=512, K=8000), at
   the deep config's new shapes (K1/K2 with dx at I=512, K3/K4 at
   K=16624, K2 also with dropout at I=512) and on ragged, clipped,
   dropout, no-dx, final-state-cotangent and argmax-tie cases (K3/K4:
   ties across a 64-class tile edge and across K3's class-chunk edge),
   K1's launch count against `fwd_launches`; time kernel and plain
   (K1/K2 at the flagship shape and at I=512 with dx) and K1's launches
   by kernel
   (profiler: the hoisted xw, the gates and the projection per step);
   print bounds (both the f32 CUDA-core and the 3xTF32 tensor-core bound)
   and, as context, cuBLAS f32 times of K1's three products, K2's four
   and K3/K4's three;
3c. hold the wavefront two-layer kernels K6 (K1's tensor-core tiles
   over both layers) and K7 (K5's persistent kernel over both layers)
   against their plain versions at the deep config's width (S=512,
   T=20, tb 5/4/2/1, nonzero states), on a ragged clipped case and K7 at
   the serving shape (S=8, T=1000), every call's launches gated exactly
   against `wavefront_launches` (no other kernel, no plain call), K6's
   `phases` ablation; K6's residuals through K2 against K1's (held at
   TRAIN_TOL, bit equality printed); time K6 at S=64, 256 and 512 (every
   tb) against K1 x 2 and K7 at S=8, T=1000 and S=512, T=20 against
   K5 x 2, each kernel and its serial schedule in turns (CUDA events,
   median of 5), the plain versions apart, with the f32 CUDA-core,
   3xTF32 and bf16 bounds; then drive the port's `tools/bench_wavefront`
   (A/B in f32 and bf16, ablation, profile) with every count zeroed
   before its A/B and read after;
3d. hold the bf16 variants of K1-K5 (the --bf16 path: K1's and K2's
   products on tc_gemm.cuh's bf16 tiles from operands rounded once into
   bf16, K1's xw on them or on wgmma as its plan picks, K3's and K4's on
   wgmma fed by TMA (wg_gemm.cuh) with dz in bf16, K1's gate residual in
   bf16, K5's weights in shared memory as bf16) against their bf16 plain
   versions, each
   output's RMS error within a tenth of the RMS bf16-vs-f32 distance of
   the plain version on the same inputs (or twice the plain version's
   own f32-vs-f64 noise, BF16_NOISE): K1/K2 at the flagship shape, at
   I=512 with dx, with dropout, at T=2, ragged at T=2 and at the
   per-utterance S=1, T=64 (K1 there also step by step, and its noise
   the larger of the f64 sum's and the plain version's run on the CPU;
   K1's plan printed);
   K3/K4 at
   N=5120, R=512, K=8000, at K=16624 and ragged (their plan printed,
   launches against `xent_launches`, two calls bitwise equal, their f32
   twins' times beside); K5 at S=8, T=1000 and
   S=256, T=20 at I=40 and I=512, at I=1024 (resident in bf16, not in
   f32), at I=2400 (the bf16 weights leave shared memory), at T=2 and
   ragged at T=2 (every ragged case on the 4-byte-copy instances), and
   K5's masked bf16 entry point at S=64, T=20; time
   kernel and plain and print bounds at 989 TFLOP/s and 3.35 TB/s and,
   as context, cuBLAS bf16 times of the products; then K6/K7's bf16
   entry points at S=512, T=20 (tb 5/4/2/1), K7's at S=8, T=1000, both
   on a ragged T=2 case and in ROADMAP C.4's regime (S=8, T=4, clip
   0.4, I=40 and 1024, weights +-0.3 and +-0.04), by the same rule, each
   call's launches gated, and timed as in 3c against K1 x 2 and K5 x 2
   in bf16. Every bf16 kernel of K1, K2, K5, K6 and K7 is also held to
   its tc-exact mirror (ops/tc_sum.py: its tiles, its tensor cores' sums
   by the model that 3e checks, its cell math fused as nvcc compiles
   it; K5 where S T <= 512, K7 where S <= 8 and T <= 20), within TC_SHARE
   of the distance, and the mirror's distance from the plain version
   joins the noise;
3e. (run before 3d) the tensor core's bf16 sums against their model:
   find_params settles block, align_bits and rounding of mma.sync
   m16n8k16 and wgmma m64n128k16 on the card from crafted vectors
   (csrc/tc_probe.cu runs them) and they must be the model's constants;
   then tc_dot must equal the instructions bit for bit on 2^20 random
   dot products each (mma.sync from a zero and from a given
   accumulator, wgmma chains of 1, 4 and 64), weights +-0.04 and +-0.3
   against phase 3d's activations;
4. drive the serving path: `nnet_forward` scoring of the full-width
   standard decode net (TimeShift(5) -> LstmProjected 40->800c/512r ->
   AffineTransform 512->8000 -> Softmax, random weights from a seed) over
   a synthetic feature ark, with the K5 launch count zeroed just before
   and read just after, then check the output and compare three
   utterances with the port's own CPU path; time steady scoring without
   and with the pipeline, and print the side-stream score copy's ms, its
   share of a batch and whether batch k's copy overlapped batch k+1's
   input copy and forward (CUDA events; with the pipeline, true in some
   pair and in every pair whose batch k+1's forward was queued before
   batch k's ended; false in every pair without);
5. drive the training path: `train_lstm_streams --device cuda` trains
   the flagship net (Transmit -> LstmProjectedStreams 40->800c/512r ->
   AffineTransform 512->8000 -> Softmax) for one epoch of a synthetic
   corpus (256 utterances, 256 streams, Tbptt 20), with the K1-K4 counts
   zeroed just before and read just after; check two cross-validation
   runs of one model give the same AvgLoss to the last digit, the counts
   against the design's prediction, no plain call, the model file, a lower
   cross-validation AvgLoss after the epoch than before, and two steps
   on the card against the same two steps on the port's CPU path; print
   train throughput and a profile of one step;
5b. drive the grouped training path on phase 5's corpus and model:
   `train_lstm_streams --step-group 4 --profile-dir` (an eager warm-up
   group, CUDA-graph replays, a plain tail), with the counts zeroed just
   before and read just after; hold its model file (byte for byte, or
   within 1e-6 relative with the reason printed) and its report against
   phase 5's, its counts against phase 5's prediction and against the
   kernel events in the trace it wrote, and the graph replays against
   the group count; the grouped CV pass (K5 and K3 replayed) against
   phase 5's; `--verbose 1` prints the three moment-dump blocks and
   `--debug-dump` writes the LSTM layer's finite per-frame tensors;
5c. drive the bf16 training path on phase 5's corpus and model:
   `train_lstm_streams --bf16 true` trains one epoch and runs its
   cross-validation pass at --step-group 1, 4 and 16 (the recipes'
   default), the counts zeroed just before and read just after each:
   only the bf16 entry points of K1-K5, in the predicted counts, no f32
   launch of K1-K5 and no plain call; the epoch's trace against the
   counters (by name, and by the precision tag tc::F32 that the f32
   kernels carry in their names); a finite
   CV AvgLoss, printed beside phase 5's f32 one; the bf16 model not
   equal to the f32 one, and the grouped bf16 models byte-identical to
   group 1's; then ms per step, frames/s, the idle share of two steady
   calls (with the top kernels at group 1), capture ms and graph-pool MB
   at group 1, 4 and 16 over 32 steps, f32 and bf16 in turns;
6. drive the deep path (2 x LSTMP 800c/512r -> 16624 senones) through
   the layer-stacking recipe at full width: `run_recipe` trains the
   one-layer net, `nnet_edit` stacks a fresh LSTMP-2 and senone affine
   on the frozen trunk, `run_recipe` trains that (the trunk stays
   bit-identical), `nnet_edit` unfreezes, `run_recipe` fine-tunes
   (cross-validation AvgLoss falls), `nnet_info` prints the net,
   `nnet_copy --to-standard` converts it and `nnet_forward` scores with
   class counts; K1-K5 counts against the prediction for every step and
   batch, no plain call; one deep step and three utterances' scores on
   the card against the port's CPU path; print the warm deep step, the
   deep scoring rate, a profile of one deep step, and the deep step at
   group 4 in f32 and in bf16 (ms, idle share, capture ms, pool MB);
7. drive the fused score->decode path at the LVCSR recipe's operating
   point (examples/lvcsr_experiment.sh): the port's make_word_synth_data
   writes the 10k-word, 7998-pdf corpus with its counted trigram, the
   port's train_lstm_streams trains the full-width AM briefly and
   nnet_copy converts it; the decoding graph is built once (states,
   arcs, build and CSR seconds, host RSS); `nnet_decode` decodes as a
   user runs it, with the K5 count zeroed just before and read just
   after (one launch per batch of 8, no plain call); then on the
   prebuilt graph: the dense fused decode (decoded audio-s/s, RTF, the
   card's scoring ms and idle share, host search and float64 conversion
   ms, the score copy's ms and overlap with the next batch, peak host
   RSS) held byte for byte to the CLI's and to the two-stage flow
   (nnet_forward -> ark -> decode_faster), lattices fused against
   two-stage byte for byte, the `--top-p 64` and `--fetch-dtype bf16`
   fetches against the dense one, the card against `--device cpu` and
   the native core against the numpy decoder (shares printed, not
   gated), and the WER against the corpus text (printed);
8. drive streaming serving in phase 7's work directory on its AM (no
   model or graph built twice): a second corpus of 500 words over phase
   7's phones and emission means (its final.mdl gated byte-identical to
   phase 7's) decoded with a uniform unigram; `online_serve_batch` with
   64 lock-step sessions, chunk 20, first with the dense fetch (every
   streamed score within SCORE_ATOL of offline nnet_forward's, the
   transcript agreement with offline decode_faster printed), then
   `--pipeline true --top-p 128 --fetch-bf16 true` (agreement printed);
   `online_decode` (K5 at S=1) on 4 of its utterances, gated as the
   dense pass; `online_serve_sticky` with 4 slots and ragged Poisson
   chunks (arrival hazard 0.2, mean chunk 20) on phase 7's decoded
   utterances over its 1.52M-state graph, after an in-process replay of
   the same trace (one masked K5 launch per tick with frames; the CLI's
   transcripts equal the replay's), and an endpointing pass (silence
   pdfs 0,1,2). Every decoder's words and score equal decode_faster on
   the rows it was fed; unmasked K5 launches of the lock-step and
   single-stream runs and masked ones of the sticky run against their
   predictions, none of the other kind and no plain call. Each run prints
   audio-s per wall-s, ticks, per tick the card's ms, the score copy's ms
   and bytes and the host search ms, tick-wall p50/p90/p99, the card's
   idle share, peak RSS against the backpointer estimate, and occupancy
   for the sticky run;
9. realign and post-process in phase 7's work directory, on its AM and
   corpus (no model built twice): `nnet_align` as the recipe runs it
   (examples/flagship_experiment.sh:271-284: class counts,
   --apply-log=true, --acoustic-scale 1.0, beam 200) on the first 64
   training utterances, with the K5 count zeroed just before and read
   just after (one launch per batch of 8, no other launch, no plain
   call), then its body on a prebuilt scorer, traced (aligned audio-s
   per wall-s, the card's scoring ms and idle share, the host's graph
   and Viterbi ms); the fused alignments held byte for byte to the
   two-stage flow (nnet_forward -> ark -> align_mapped), every
   utterance aligned and each alignment as long as its utterance;
   printed: the frame-pdf agreement (ali_to_pdf) with the corpus's
   ali.ark, card against --device cpu on 4 utterances, ali_to_phones
   --ctm-output on 2; then on phase 7's 16 determinized lattices:
   lattice_best_path equal to phase 7's one-best, lattice_copy binary
   -> binary byte-equal and binary -> text -> binary -> text text-equal
   (structure equal, weights within the text's 6 decimals),
   lattice_prune --beam 6 keeping every best path, lattice_to_ctm
   writing the best paths' words in order; printed: the WER of the
   one-best, lattice_mbr_decode and lattice_oracle against the corpus
   text, and the share of best paths an identity lattice_lmrescore
   keeps;
10. per-utterance and frame-shuffled training. 10a: K1/K2 against
   their plain versions at the per-utterance shapes (S=1, T=128 and
   1024 at I=40, C=800, R=512; a second layer with dx at I=1024; a
   ragged clipped dropout case), a BLSTM layer's two directions (one K1
   and one K2 call each, the backward one on the time-flipped input) at
   T=1024 and, with dx, at I=1024; K3/K4 at the BLSTM's R=1024 (N=1024)
   and the DNN's minibatch (N=256), K=8000; K5 on the BLSTM's flipped
   half at S=8, T=1000; K1 and K2 timed at S=1, T=1024 (ms, launches,
   us a launch). 10b: the standard variant's trainer: nnet_initialize
   builds phase 4's decode net from a seed and `nnet_train_perutt
   --device cuda` trains it one epoch on phase 5's corpus (buckets
   128/256/384), the counts zeroed just before and read just after
   (K1-K4 against the sum over utterances of the prediction, no plain
   call, no K5); two CV passes agree to the last digit, the CV AvgLoss
   falls, two utterances on the card against the CPU path, the model
   reads back; warm steps by bucket and the idle share of one step.
   10c: the flagship widths in bidirectional form (BLSTM 40 -> 2 x
   800c/512r -> 8000) through the same trainer on the first 64
   utterances (two K1 and two K2 calls a step), the same gates; scored
   by nnet_forward (two K5 launches a batch of 8) against the CPU path
   on 3 utterances; OnlineBatchScorer and OnlineRecognizer refuse it on
   the card with the JAX package's messages. 10d: Kaldi
   steps/nnet/train.sh's default DNN (CMVN from cmvn_to_nnet and Splice
   +-5 joined by nnet_concat as the feature transform; 4 x 1024 sigmoid
   -> 8000) through `nnet_train_frmshuff` for one epoch at minibatch 256
   and randomizer 32768: K3/K4 once a minibatch, the minibatches drained
   as predicted, the CV AvgLoss falls, and with --randomize false the
   card drains the same minibatches in the same order as the CPU path
   and trains the same model;
11. sequence training in phase 7's work directory (after phase 10, on
   phase 7's AM, final.mdl and corpus, with phase 9's realignments; no
   model or graph built again). 11a: `nnet_train_smbr --device cuda` as
   the recipe runs it (examples/flagship_experiment.sh:286-294:
   --learn-rate 1e-5 --acoustic-scale 1.0 --length-bucket 64, no feature
   transform: phase 7's AM has none) for one iteration on the first 32
   of the 64 realigned utterances (a time cut, printed on the `cuts:`
   line), with a --cross-validate=true pass before and after;
   `den_graph_for` must pick the structured phone loop with Ns 7998; the
   counts zeroed just before and read just after each run: training one
   K1 and one K2 call (no dx) per utterance, i.e. sum(2T_b + 2) and
   sum(2T_b + 5) launches over the buckets T_b, a CV pass one K5 launch
   per utterance, no other kernel (no K3/K4: the senone affine and
   log-softmax are torch ops) and no plain call; the model reads back; 2
   utterances on the card against the CPU path (the per-utterance E[A]
   within 1e-4 of max(E[A], frames), each utterance's gradients within
   1e-2 of their largest entry, the params after the updates within the
   step tolerance); warm steps at buckets 128, 256 and 512 split into
   the net (K1+K2, affine, log-softmax) and the den-graph recursion with
   its backward and second-order pass, and a profile of one step at 512
   (launches, idle share). Predicted: the den graph takes >= 0.85 of an
   sMBR step at T >= 256 (some 60 small launches a frame against the
   net's 2T + 2 + 2T + 5), the step 150-400 ms at T = 256 against the
   net's 15-20 ms, the card idle > 0.7 of it (host dispatch). 11b: the
   same for lattice-free MMI (`nnet_train_mmi`, AvgMMI(den-num)/frame);
   predicted: first order only, den-graph share >= 0.75. 11c: priors
   from the ported ali_to_pdf -> ali_to_post -> compute_class_counts on
   phase 7's training part (--counts-offset 1: equal to phase 7's
   counts.vec), then `nnet_train_mmi_sequential` and
   `nnet_train_mpe_sequential` on phase 7's 16 determinized lattices
   with the corpus's ali.ark as numerator: one K5 launch (the loglik)
   and one K1 and one K2 call (the update) per utterance, no plain call,
   every utterance counted as done or skipped with a reason; the loglik
   and the MMI diff rows on the card against the CPU on 2 lattices
   (within 1e-3). 11d: den_logprob, num_logprob and expected_accuracy
   with their gradients on the card against the CPU for the structured,
   dense and split graphs at small sizes;
12. the flagship recipe's front end from wav (examples/
   flagship_experiment.sh:72-95) in phase 7's work directory, on its
   final.mdl and ali.ark, through the port's tools only, as a user runs
   them: the first FROMWAV_UTTS alignments -> `synth_wavs` ->
   `wav_to_duration` (hours printed) -> `compute_fbank_feats
   --num-mel-bins 40` into ark,scp (synthesis seconds and the host's
   fbank frames/s printed; every utterance's frame count equal to its
   alignment length, dim 40, all finite) -> `compute_cmvn_transform` on
   the training part (the last FROMWAV_CV utterances are CV) ->
   `ali_to_pdf` -> `ali_to_post`; then on the card `train_lstm_streams
   --device cuda --feature-transform` trains the flagship net at full
   width (Transmit -> LSTMP 40 -> 800c/512r -> 7998 -> Softmax, Tbptt 20,
   64 streams) for one epoch between two CV passes, the counts zeroed
   just before and read just after each run: K1-K4 as phase 5's formulas
   predict for the epoch, K5 and K3 once and twice a step for CV, no
   other kernel and no plain call; the CV AvgLoss falls (both printed);
   `nnet_forward --device cuda --feature-transform` scores the CV
   utterances from fbank of their wavs (one K5 launch per batch of 8,
   nothing else), 3 utterances against `--device cpu` within
   SCORE_ATOL; printed: audio-s/s from wav to scores and the phase's
   wall;
13. the native I/O half and the sharded step, in a work directory of
   their own on phase 5's corpus and initial model (the same seeds).
   13a: phase 5's training ark through the native scan
   (csrc/kltio.cc) key for key and byte for byte against the Python
   parse, its posteriors likewise, an epoch's batches of the native
   fill byte for byte against the numpy fill (the scheduler's host
   seconds with each printed), and the `-v 2` epoch profile of a CV
   pass with each fill. 13b: K3/K4 against their plain versions at a
   class shard's shape (N=2560, R=512, K=4000, and the odd K=3999 of
   7998 classes over model=2; every other row's target id -1, i.e. in
   another shard), timed. 13c: train_lstm_streams with --mesh model=2
   (the TP loss: K3/K4 on 4000 classes a rank; --step-group 2) and
   --mesh data=2, two ranks on cuda:0 joined by gloo through
   --coordinator-address/--num-processes/--process-id (`chip_smoke.py
   --mesh-rank`; NCCL refuses two ranks on one card), at the flagship
   widths on the first 128 utterances of phase 5's corpus (model=2:
   both ranks on all of them, 128 streams; data=2: a half each, 64
   streams), then each mode's --cross-validate pass: both ranks'
   gathered parameters bit-identical and equal to rank 0's written
   model, within the step tolerance of one process's CLI run over the
   same global batches, the global statistics equal on both ranks and
   to that run's, every rank's K1-K5 launches as predicted with no
   plain call; ms per step and the collectives' ms a step printed;
14. print one JSON line with every kernel (the bf16 variants as
   entries of their own; K5's adds its masked entry point's launches,
   times and error, the realignment's, the BLSTM scoring's, the
   sequence trainers', phase 12's and phase 13's CV launches; K1-K4 add
   the per-utterance, frame-shuffled, sequence-training, phase 12's and
   phase 13's launches per rank, their times at the per-utterance shapes
   and their device ms in one sMBR step; K3/K4 their times at the class
   shard shapes), then the device line last.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

PROTO = """<NnetProto>
<TimeShift> <InputDim> 40 <OutputDim> 40 <Shift> 5
<LstmProjected> <InputDim> 40 <OutputDim> 512 <CellDim> 800 <ParamScale> 0.01
<AffineTransform> <InputDim> 512 <OutputDim> 8000 <ParamStddev> 0.04
<Softmax> <InputDim> 8000 <OutputDim> 8000
</NnetProto>
"""
FRAMES_PER_AUDIO_SECOND = 100.0
# Published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, TF32 in the tensor cores (dense), and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain, float32 on both sides (TF32 off). The two sum the
# 552-term gate dots and the 800-term projection in different orders
# (sequential fma vs cuBLAS's blocked sums): ~1e-7 relative per step. The
# forget gate keeps the recurrence contractive, so the difference stays
# near that level over T=1000 instead of compounding; 1e-4 abs + 1e-4 rel
# leaves two orders of magnitude of margin.
KERNEL_ATOL = 1e-4
KERNEL_RTOL = 1e-4
# Training kernels vs plain, float32 on both sides (TF32 off): every
# output within 1e-4 * (1 + the largest |entry| of the plain result).
# K2's weight gradients sum N = T*S = 5120 frame rows, K3/K4 sum R = 512
# products and K = 8000 classes, in other orders than cuBLAS; on an H100
# this script measured at most 3.4e-6 of that scale, so 1e-4 leaves a
# 30x margin while a wrong index or a missed term (errors of the order of
# the entries themselves) still fails. K2's products and K3/K4 compute on
# the tensor cores in the 3xTF32 split, float32-accurate; the same
# tolerance holds them. Argmax indices must agree
# except on near-ties, where the kernel's pick must be within the same
# tolerance of the row's max.
TRAIN_TOL = 1e-4
# Two training steps at full width, card (K1-K4, fused loss) vs the
# port's CPU path (plain scan, unfused log-softmax loss): both float32,
# gradients summed over 5120 frames in other orders; after two updates
# at lr 2e-5 every parameter agrees within 1e-5 + 1e-4 * |value|, the
# loss sums within 1e-5 relative, the frame counts exactly, and the
# correct-frame counts within 2 frames (argmax near-ties).
STEP_ATOL = 1e-5
STEP_RTOL = 1e-4
# The bf16 kernels vs their bf16 plain versions (the --bf16 path): both
# round the same operands to bf16 and sum the exact bf16 products in f32,
# so they differ by f32 summation order and by the bf16 roundings that an
# operand computed in f32 takes the other way ("flips"); a kernel that
# rounded one operand more or fewer, or ran in f32, would differ by a
# good part of the bf16 effect itself. Each output's RMS error must stay
# within BF16_SHARE of the RMS bf16-vs-f32 distance of the plain version
# on the same inputs (tests/test_torch_bf16.py holds the plain versions
# to the JAX package's bf16 kernels by that rule), or within BF16_NOISE
# times the plain version's own noise where that is larger: the RMS
# distance between the plain version summing in f32 and the same plain
# version summing in f64 (the same rounding points). Over a recurrence
# the flips are not rare: at the flagship shape about 1e-3 of the
# rounded values flip between two f32 orders, and the recurrence carries
# each one on, so two correct plain versions (f32 and f64 sums) already
# differ by 0.07-0.24 of the bf16 distance in K1's r and K2's weight
# gradients (measured on the CPU with ops/lstm_train.py's plain
# versions). The T=2 cases, where no long recurrence carries flips, hold
# the rounding points to BF16_SHARE; the ragged ones are T=2 too, since
# at S=3 a single flip carried over 20 steps moves a third of the
# streams (measured: K2 at 0.05-0.19 of the distance after one).
BF16_SHARE = 0.1
BF16_NOISE = 2.0
# A bf16 kernel against its tc-exact mirror (ops/tc_sum.py: the kernel's
# tiles and order, its tensor cores' own sums by the model that phase 3e
# holds to the card bit for bit, its epilogues' multiply-adds fused as
# nvcc fuses them, K2's column sums in its order): the two take the same
# roundings (equal bit for bit on an H100 80GB HBM3 at 700.00 W in every
# case of this phase), so the kernel must lie within TC_SHARE of the
# bf16-vs-f32 distance from its mirror; and the mirror's distance from
# the plain version joins the noise, since it is the order the card's
# sums take (ROADMAP C.4).
TC_SHARE = 0.02
# phase 3e: random dot products per instruction and accumulator mode
TC_DOTS = 1 << 20
TRAIN_PROTO = """<NnetProto>
<Transmit> <InputDim> 40 <OutputDim> 40
<LstmProjectedStreams> <InputDim> 40 <OutputDim> 512 <CellDim> 800 <ParamScale> 0.01 <NumStream> 4
<AffineTransform> <InputDim> 512 <OutputDim> 8000 <BiasMean> 0.0 <BiasRange> 0.0 <ParamStddev> 0.04
<Softmax> <InputDim> 8000 <OutputDim> 8000
</NnetProto>
"""
TRAIN_S, TRAIN_T = 256, 20
TRAIN_LR = 2e-5
# Scores (log-posterior minus log-prior, magnitude ~10) on the card vs the
# port's CPU path: the LSTM difference above passes through a 512-deep
# affine and an 8000-wide log-softmax, and the CPU and cuBLAS GEMMs sum
# in different orders; 1e-3 abs is ~1e-4 relative at that magnitude.
SCORE_ATOL = 1e-3
# The deep config (bench.py:91-100, BASELINE config 4: the reference's
# own decode-example model), trained through the layer-stacking recipe
# of examples/flagship_experiment.sh:127-200: the one-layer net, then a
# fresh LSTMP-2 + senone affine on the frozen trunk, then the whole
# stack.
DEEP_K = 16624
DEEP_PRE_PROTO = """<NnetProto>
<Transmit> <InputDim> 40 <OutputDim> 40
<LstmProjectedStreams> <InputDim> 40 <OutputDim> 512 <CellDim> 800 <ParamScale> 0.01 <NumStream> 4
<AffineTransform> <InputDim> 512 <OutputDim> 16624 <ParamStddev> 0.04
<Softmax> <InputDim> 16624 <OutputDim> 16624
</NnetProto>
"""
DEEP_STACK_LINES = (
    "<LstmProjectedStreams> <InputDim> 512 <OutputDim> 512 <CellDim> 800 "
    "<ParamScale> 0.01 <NumStream> 4\n"
    "<AffineTransform> <InputDim> 512 <OutputDim> 16624 <ParamStddev> 0.04")
# one deep step, card vs the port's CPU path, on 64 streams (bounds the
# CPU's time); tolerances as phase 5's
DEEP_CHECK_S = 64

# Phase 7: the fused score->decode path at the LVCSR recipe's operating
# point. The corpus flags are examples/lvcsr_experiment.sh:26-41,79-83's
# (10k words, 2666 phones x 3 states = 7998 pdfs, a counted trigram from
# 60000 sentences of a 16-successor word process), with 40-dim synthetic
# frames in place of fbank from rendered audio; the search flags are its
# fused stage's (:260-275: acwt 0.1, beam 13, max-active 7000, 2 decoder
# threads) and the lattice beam tests/test_nnet_decode.py's.
LVCSR_PDFS = 2666 * 3
LVCSR_CORPUS = ["--num-words", "10000", "--num-phones", "2666",
                "--states-per-phone", "3", "--feat-dim", "40",
                "--lm-order", "3", "--lm-branch", "16",
                "--lm-train-sents", "60000", "--self-loop-prob", "0.7",
                "--max-words", "12", "--eos-prob", "0.1", "--sil-prob", "0.1",
                "--min-pron", "3", "--max-pron", "6", "--seed", "0"]
LVCSR_PROTO = TRAIN_PROTO.replace("8000", str(LVCSR_PDFS))
LVCSR_SEARCH = ["--acoustic-scale", "0.1", "--beam", "13",
                "--max-active", "7000", "--num-threads", "2"]
LVCSR_LATTICE = ["--lattice-beam", "6"]
# cut to the time limit: a brief AM training, 16 utterances decoded (all
# of them also by the CLI and into lattices, 4 also on the CPU, the 2
# shortest also by the numpy decoder); the host search takes 0.4-1.0
# core-s an audio-s on the card's machines (their hosts differ 2.3x), so
# a 32-utterance pass took 25-60 s on the 2 decoder threads and the
# whole script 1037 s on the slowest host seen: 16 keeps it well inside
# the time limit
DECODE_TRAIN_UTTS = 2048
DECODE_EPOCHS = 4
# the recipe's rate, targets delay and gradient clip (lvcsr_experiment.sh
# :47,140-153); without the clip the rate diverged in epoch 5 on the card
DECODE_LR = 1e-4
DECODE_DELAY = 0
DECODE_UTTS = 16
DECODE_LAT_UTTS = 16
DECODE_CPU_UTTS = 4
DECODE_PY_UTTS = 2
DECODE_TOP_P = 64
# Phase 8: streaming serving on phase 7's AM. The lock-step run is the
# JAX package's round-4 product shape (BENCH_NOTES.md:240-265: 64
# sessions, 200 ms chunks, a pipelined top-128 bf16 fetch, a 500-word
# graph) on a second corpus of phase 7's phones, pdfs and emission means
# (its final.mdl is phase 7's byte for byte), decoded with a uniform
# unigram over its 500 words so that 64 sessions' dense backpointers
# (sessions x frames x states x 4 B) stay under 1 GB; the sticky run is
# round 5's LVCSR shape (BENCH_NOTES.md:3-35: 4-8 slots on the 1.5M-state
# graph) with ragged Poisson chunks, on phase 7's search flags.
STREAM_CORPUS = ["--num-words", "500", "--lm-order", "2", "--seed", "1",
                 "--num-phones", "2666", "--states-per-phone", "3",
                 "--feat-dim", "40", "--mean-seed", "42",
                 "--self-loop-prob", "0.7", "--max-words", "12",
                 "--eos-prob", "0.1", "--sil-prob", "0.1", "--min-pron", "3",
                 "--max-pron", "6"]
STREAM_SEARCH = ["--acoustic-scale", "0.1", "--beam", "13",
                 "--max-active", "7000"]
STREAM_SESSIONS = 64
STREAM_UTTS = 96
STREAM_CHUNK = 20
STREAM_TOP_P = 128
SINGLE_UTTS = 4
STICKY_SLOTS = 4
STICKY_UTTS = 16
STICKY_ENDPOINT_UTTS = 4
# Phase 9: realignment (examples/flagship_experiment.sh:271-284: nnet_align
# with the class counts, --apply-log=true, --acoustic-scale 1.0 and the
# default beam 200) on the first training utterances of phase 7's corpus
# (the recipe realigns KLT_NSEQ = 400); the lattice tools on phase 7's
# determinized lattices
ALIGN_UTTS = 64
ALIGN_CPU_UTTS = 4
ALIGN_CTM_UTTS = 2
ALIGN_FLAGS = ["--apply-log=true", "--acoustic-scale", "1.0"]
PRUNE_BEAM = "6"
# Phase 10: per-utterance and frame-shuffled training. The standard
# variant's trainer (SURVEY.md:13-14,69,86: standard/nnet.proto trained
# by nnet-train-perutt, epoch-wise BPTT over whole utterances, the
# element-wise gradient clip of +-50) on phase 4's decode net and phase
# 5's corpus, at the JAX tool's defaults (--learn-rate 8e-5, momentum
# 0.9, --length-bucket 128); the flagship widths in bidirectional form
# (40 -> 2 x 800c/512r -> 8000) on the corpus's first 64 utterances; and
# Kaldi steps/nnet/train.sh's default DNN (--splice 5 on 40 dims, 4 x
# 1024 sigmoid layers, minibatch 256, randomizer 32768, learn rate
# 0.008; the initial weights after utils/nnet/make_nnet_proto.py's
# defaults: hidden biases -2 +- 2, stddev 0.1, output stddev 0.05)
PERUTT_BUCKET = 128
BLSTM_PROTO = """<NnetProto>
<BLstmProjectedStreams> <InputDim> 40 <OutputDim> 1024 <CellDim> 800 <ParamScale> 0.01 <NumStream> 1
<AffineTransform> <InputDim> 1024 <OutputDim> 8000 <ParamStddev> 0.04
<Softmax> <InputDim> 8000 <OutputDim> 8000
</NnetProto>
"""
BLSTM_UTTS = 64
DNN_HIDDEN = ("<AffineTransform> <InputDim> {i} <OutputDim> 1024 "
              "<BiasMean> -2.0 <BiasRange> 4.0 <ParamStddev> 0.1\n"
              "<Sigmoid> <InputDim> 1024 <OutputDim> 1024\n")
DNN_PROTO = ("<NnetProto>\n" + DNN_HIDDEN.format(i=440)
             + DNN_HIDDEN.format(i=1024) * 3
             + "<AffineTransform> <InputDim> 1024 <OutputDim> 8000 "
               "<ParamStddev> 0.05\n"
               "<Softmax> <InputDim> 8000 <OutputDim> 8000\n</NnetProto>\n")
DNN_SPLICE = 5
DNN_MINIBATCH = 256
DNN_RANDOMIZER = 32768
# the frames of the --randomize false check, card against the CPU path
DNN_CHECK_UTTS = 6


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 1, reps: int = 5) -> float:
    """Median of `reps` CUDA-event timings of fn(), after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def lstm_case(S, T, I, C, R, seed, param_scale=0.04, x_scale=1.0,
              state_scale=0.5, device="cuda"):
    import torch
    from kaldi_lstm_tpu_torch.ops.lstm_cell import (
        LstmState,
        init_lstm_params,
    )
    g = torch.Generator().manual_seed(seed)
    params = init_lstm_params(g, I, C, R, param_scale, device=device)
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(S, T, I).astype(np.float32) * x_scale,
                     device=device)
    state = LstmState(
        c=torch.tensor(rng.randn(S, C).astype(np.float32) * state_scale,
                       device=device),
        r=torch.tensor(rng.randn(S, R).astype(np.float32) * state_scale,
                       device=device))
    return params, x, state


def errors(got, ref):
    d = (got - ref).abs()
    rel = d / ref.abs().clamp_min(1e-6)
    ok = bool((d <= KERNEL_ATOL + KERNEL_RTOL * ref.abs()).all())
    return float(d.max()), float(rel.max()), ok


def lstm_bound_ms(S, T, I, C, R, mask=None) -> tuple[float, str]:
    """Least time for the inference forward on this card: each input
    read once and each output written once over HBM bandwidth, against
    the three weight products' f32 operations over the f32 peak. With an
    advance `mask` ([S, T] 0/1), the operations of the frames it
    advances and one byte a frame of mask."""
    inputs = T * S * I + (I + R) * 4 * C + 4 * C + 3 * C + C * R \
        + S * C + S * R
    outputs = T * S * R + S * C
    frames = T * S if mask is None else float(mask.sum())
    t_bytes = (4.0 * (inputs + outputs) + (0 if mask is None else T * S)) \
        / PEAK_BYTES_PER_S
    t_ops = 2.0 * frames * (4 * C * (I + R) + C * R) / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def phase_kernels():
    """Kernel vs plain on the card. Returns the timing record of the
    main-path shape (S=8, T=1000), with the cross-validation shape's
    (S=256, T=20) times and the time per step beside it."""
    import torch
    from kaldi_lstm_tpu_torch.ops import lstm_infer as li
    from kaldi_lstm_tpu_torch.ops.lstm_cell import lstm_scan

    cases = [
        # name, (S, T, I, C, R), cell_clip, extra, timed
        ("full T=128 nonzero state", (8, 128, 40, 800, 512), 50.0, {},
         True),
        ("full T=1000 nonzero state", (8, 1000, 40, 800, 512), 50.0, {},
         True),
        ("full T=128 clip active", (8, 128, 40, 800, 512), 1.0,
         {"x_scale": 20.0, "param_scale": 0.2}, False),
        ("ragged S=3 I=37 C=200 R=130", (3, 128, 37, 200, 130), 50.0, {},
         False),
        ("cross-validation S=256 T=20", (256, 20, 40, 800, 512), 50.0, {},
         True),
        ("deep layer 2, I=512 T=1000", (8, 1000, 512, 800, 512), 50.0, {},
         True),
        ("deep layer 2 cross-validation, I=512 S=256 T=20",
         (256, 20, 512, 800, 512), 50.0, {}, False),
        # weight slices too wide for a CTA's shared memory: the same
        # kernel reads them from device memory
        ("weights in device memory, S=8 T=16 I=1024",
         (8, 16, 1024, 800, 512), 50.0, {"resident": False}, False),
        ("weights in device memory, ragged S=3 T=9 I=1501 R=130",
         (3, 9, 1501, 800, 130), 50.0, {"resident": False}, False),
        # the streaming shapes: online_decode's single stream and the
        # lock-step batch of 64 sessions, one chunk of 20 frames (the
        # plan depends on S)
        ("single stream S=1 T=20", (1, 20, 40, 800, 512), 50.0, {}, False),
        ("lock-step S=64 T=20", (64, 20, 40, 800, 512), 50.0, {}, False),
    ]
    worst = 0.0
    times = {}
    for i, (name, dims, clip, extra, timed) in enumerate(cases):
        resident = extra.pop("resident", True)   # what the plan must say
        params, x, state = lstm_case(*dims, seed=10 + i, **extra)

        def kernel():
            return li.lstm_infer(params, x, state, clip)

        li.reset_counts()
        with torch.inference_mode():
            out_k, fin_k = kernel()
            out_p, fin_p = lstm_scan(params, x, state, clip)
            torch.cuda.synchronize()
        if (li.LAUNCHES, li.PLAIN_CALLS) != (1, 0):
            fail(f"{name}: {li.LAUNCHES} launches and {li.PLAIN_CALLS} "
                 f"plain calls for one call (expected 1 and 0)")
        plan = li.device_plan(*dims[:1], *dims[2:])
        if plan["resident"] != int(resident):
            fail(f"{name}: the plan {plan} does not keep the weights "
                 f"{'resident' if resident else 'in device memory'}")
        if clip == 1.0 and not bool((fin_p.c.abs() == 1.0).any()):
            fail(f"{name}: the clip never engaged")
        for what, a, b in (("r", out_k, out_p), ("final c", fin_k.c, fin_p.c),
                           ("final r", fin_k.r, fin_p.r)):
            mx, rel, ok = errors(a, b)
            worst = max(worst, mx)
            log(f"  [{name}] {what}: max_abs_err {mx:.3e} "
                f"max_rel_err {rel:.3e} (tol {KERNEL_ATOL:g} abs + "
                f"{KERNEL_RTOL:g} rel)")
            if not ok or not bool(torch.isfinite(a).all()):
                fail(f"{name}: {what} disagrees with the plain version")
        if not timed:
            continue
        with torch.inference_mode():
            k_ms = cuda_ms(kernel)
            p_ms = cuda_ms(lambda: lstm_scan(params, x, state, clip),
                           reps=3)
        bound, by = lstm_bound_ms(*dims)
        log(f"  [{name}] kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"bound {bound:.4f} ms ({by}); plan {plan}; library: n/a (no "
            f"single PyTorch call computes LSTMP with peepholes and the "
            f"clip)")
        times[dims] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                       "bound_by": by}
    record = dict(times[(8, 1000, 40, 800, 512)])
    us_step = 1e3 * (record["ms"] - times[(8, 128, 40, 800, 512)]["ms"]) \
        / (1000 - 128)
    log(f"  K5 per step at S=8: {us_step:.3f} us "
        f"((t(T=1000) - t(T=128)) / 872)")
    cv = times[(256, 20, 40, 800, 512)]
    record.update(max_abs_err=worst, us_per_step_s8=us_step,
                  cv_ms=cv["ms"], cv_plain_ms=cv["plain_ms"],
                  cv_bound_ms=cv["bound_ms"])
    return record


def ragged_mask(S: int, T: int, seed: int, middle: bool):
    """A [S, T] 0/1 advance mask of lengths drawn from `seed`, with a
    length 0 and a length T among them (a single stream stops 7 frames
    short of T); with `middle`, the last stream also skips its middle
    frame."""
    lengths = np.random.RandomState(seed).randint(0, T + 1, S)
    lengths[0], lengths[-1] = 0, T
    if S == 1:
        lengths[0] = T - 7
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    if middle:
        mask[-1, T // 2] = 0.0
    return mask


def phase_kernels_masked():
    """K5's advance-mask entry point against its plain version (the
    masked scan) on the card, at the streaming shapes: the sticky
    server's S=4, the lock-step batch's S=64 and a single stream at T=20
    (chunk 20) with ragged lengths (0 and 20 among them), a skipped
    middle frame, a mask set everywhere (bit for bit the unmasked
    kernel), the 4-byte-copy instance and the weights in device memory. Compares the valid rows of
    r and the final (c, r); a stream of length 0 keeps its state exactly.
    Times masked against unmasked at S=4 and S=64. Returns the record."""
    import torch
    from kaldi_lstm_tpu_torch.ops import lstm_infer as li
    from kaldi_lstm_tpu_torch.ops.lstm_cell import lstm_scan
    cases = [
        # name, (S, T, I, C, R), middle frame skipped, timed
        ("sticky S=4 T=20, ragged", (4, 20, 40, 800, 512), False, True),
        ("lock-step width S=64 T=20, ragged, a middle frame skipped",
         (64, 20, 40, 800, 512), True, True),
        ("ragged S=3 T=9 I=37 C=200 R=130 (4-byte copies), middle frame",
         (3, 9, 37, 200, 130), True, False),
        ("weights in device memory S=3 T=5 I=1024, middle frame",
         (3, 5, 1024, 800, 512), True, False),
        ("single stream S=1 T=20, short, a middle frame skipped",
         (1, 20, 40, 800, 512), True, False),
    ]
    worst, rec = 0.0, {}
    for i, (name, dims, middle, timed) in enumerate(cases):
        S, T, I, C, R = dims
        params, x, state = lstm_case(*dims, seed=200 + i)
        mask_np = ragged_mask(S, T, 210 + i, middle)
        mask = torch.tensor(mask_np, device="cuda")
        valid = mask.bool()
        # the serving path's form: bytes, batch-major, read in place
        mask_u8 = mask.to(torch.uint8)

        def kernel():
            return li.lstm_infer(params, x, state, 50.0,
                                 advance_mask=mask_u8)

        li.reset_counts()
        with torch.inference_mode():
            out_k, fin_k = kernel()
            out_p, fin_p = lstm_scan(params, x, state, 50.0,
                                     advance_mask=mask)
            torch.cuda.synchronize()
        if (li.MASKED_LAUNCHES, li.LAUNCHES, li.PLAIN_CALLS) != (1, 0, 0):
            fail(f"K5 masked {name}: {li.MASKED_LAUNCHES} masked, "
                 f"{li.LAUNCHES} unmasked launches, {li.PLAIN_CALLS} plain "
                 f"calls for one call (expected 1, 0, 0)")
        log(f"  [K5 masked, {name}] lengths {mask_np.sum(1).astype(int)}")
        for what, a, b in (("r (valid rows)", out_k[valid], out_p[valid]),
                           ("final c", fin_k.c, fin_p.c),
                           ("final r", fin_k.r, fin_p.r)):
            mx, rel, ok = errors(a, b)
            worst = max(worst, mx)
            log(f"    {what}: max_abs_err {mx:.3e} max_rel_err {rel:.3e} "
                f"(tol {KERNEL_ATOL:g} abs + {KERNEL_RTOL:g} rel)")
            if not ok or not bool(torch.isfinite(a).all()):
                fail(f"K5 masked {name}: {what} disagrees with the plain "
                     f"version")
        if mask_np[0].sum() == 0 and not (
                torch.equal(fin_k.c[0], state.c[0])
                and torch.equal(fin_k.r[0], state.r[0])):
            fail(f"K5 masked {name}: a stream of length 0 changed its state")
        if not timed:
            continue
        ones = torch.ones_like(mask)
        with torch.inference_mode():
            all_k, all_fin = li.lstm_infer(params, x, state, 50.0,
                                           advance_mask=ones)
            un_k, un_fin = li.lstm_infer(params, x, state, 50.0)
            torch.cuda.synchronize()
        same = torch.equal(all_k, un_k) and torch.equal(all_fin.c, un_fin.c)
        log(f"    mask set everywhere vs the unmasked kernel: bit for bit "
            f"{same}")
        if not same:
            fail(f"K5 masked {name}: a mask set everywhere differs from "
                 f"the unmasked kernel")
        with torch.inference_mode():
            m_ms = cuda_ms(kernel, reps=20)
            u_ms = cuda_ms(lambda: li.lstm_infer(params, x, state, 50.0),
                           reps=20)
            p_ms = cuda_ms(lambda: lstm_scan(params, x, state, 50.0,
                                             advance_mask=mask), reps=5)
        bound, by = lstm_bound_ms(*dims, mask=mask_np)
        ubound, uby = lstm_bound_ms(*dims)
        log(f"    masked kernel {m_ms:.3f} ms, unmasked {u_ms:.3f} ms "
            f"({100 * (m_ms / u_ms - 1):+.1f}%), plain (masked scan) "
            f"{p_ms:.3f} ms; bound {bound:.4f} ms ({by}; "
            f"{int(mask_np.sum())} of {S * T} frames advance; the unmasked "
            f"bound {ubound:.4f} ms, {uby}); library: n/a")
        rec[S] = {"ms": m_ms, "unmasked_ms": u_ms, "plain_ms": p_ms,
                  "bound_ms": bound, "bound_by": by,
                  "unmasked_bound_ms": ubound}
    # chunked against whole at the same S: the step's sums do not depend
    # on T, so 5 chunks of 20 with the carried state give one call over
    # 100 frames bit for bit (unmasked, and through the masked entry
    # point with every frame set)
    from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmState
    params, x, state = lstm_case(64, 100, 40, 800, 512, seed=230)
    with torch.inference_mode():
        whole, wfin = li.lstm_infer(params, x, state, 50.0)
        for mask in (None, torch.ones(64, 20, dtype=torch.uint8,
                                      device="cuda")):
            st, parts = LstmState(state.c.clone(), state.r.clone()), []
            for t0 in range(0, 100, 20):
                o, st = li.lstm_infer(params, x[:, t0:t0 + 20], st, 50.0,
                                      advance_mask=mask)
                parts.append(o)
            same = torch.equal(torch.cat(parts, 1), whole) and \
                torch.equal(st.c, wfin.c) and torch.equal(st.r, wfin.r)
            log(f"  K5 at S=64 over 5 chunks of 20 (carried state"
                f"{', masked entry point' if mask is not None else ''}) vs "
                f"one call over 100 frames: bit for bit {same}")
            if not same:
                fail("chunked K5 differs from whole-utterance K5 at the "
                     "same S")
    s4, s64 = rec[4], rec[64]
    return {"masked_ms": s4["ms"], "masked_plain_ms": s4["plain_ms"],
            "masked_bound_ms": s4["bound_ms"],
            "masked_unmasked_ms": s4["unmasked_ms"],
            "masked_max_abs_err": worst,
            "masked_s64_ms": s64["ms"], "masked_s64_plain_ms": s64["plain_ms"],
            "masked_s64_bound_ms": s64["bound_ms"],
            "masked_s64_unmasked_ms": s64["unmasked_ms"]}


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    """Least time on this card: the larger of the f32 operations over the
    f32 peak and the compulsory bytes over the HBM rate."""
    t_ops = ops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def k1_bound(T, S, I, C, R, mask):
    ops = 2.0 * T * S * (4 * C * (I + R) + C * R)
    n_in = T * S * I + (I + R) * 4 * C + 7 * C + C * R + S * (C + R)
    n_out = T * S * (4 * C + C + R)
    return bound_ms(ops, 4.0 * (n_in + n_out) + (T * S * 4 * C if mask
                                                 else 0))


def k1_tc_bound(simt, T, S, I, C, R):
    """K1's float32-accurate tensor-core bound: its three products (the
    hoisted x Wx^T, r Wr^T and m Wrm^T per step) three times over at the
    TF32 peak; the compulsory bytes are those of the f32 bound `simt`
    (ms, by). Returns (ms, by)."""
    t_ops = 1e3 * 3 * 2.0 * T * S * (4 * C * (I + R) + C * R) \
        / PEAK_TF32_FLOPS
    t_bytes = simt[0] if simt[1] == "bytes" else 0.0
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def k1_bytes_ms(T, S, I, C, R, mask):
    """K1's compulsory bytes over the HBM rate, ms."""
    n_in = T * S * I + (I + R) * 4 * C + 7 * C + C * R + S * (C + R)
    n_out = T * S * (4 * C + C + R)
    return 1e3 * (4.0 * (n_in + n_out) + (T * S * 4 * C if mask else 0)) \
        / PEAK_BYTES_PER_S


K1_KERNELS = {"interleave": "interleave_gate_rows", "xw": "xw_tc_kernel",
              "gates": "gates_tc_kernel", "projection": "contract_tc_kernel"}


K6_BF16_KERNELS = {"prologue": "stack16_prep", "xw (Gemm16)":
                   "stack16_xw_kernel", "xw (wgmma)": "stack16_xw_wg",
                   "gates": "stack16_gates", "projection": "stack16_proj"}


def k1_launch_split(fn, T, calls=3, kernels=K1_KERNELS):
    """Device ms per launch of each of K1's kernels (or of `kernels`:
    {what: name key}) over `calls` calls of fn() (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for what, name in kernels.items():
        us, n = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    name in e.key:
                t = getattr(e, "self_device_time_total", None)
                us += t if t is not None else e.self_cuda_time_total
                n += e.count
        split[what] = {"launches": n / calls,
                       "ms_per_launch": us / 1e3 / n if n else None}
    return split


def k2_bound(T, S, I, C, R, mask, need_dx):
    N = T * S
    ops = 2.0 * N * (2 * R * C + 8 * C * R + (8 if need_dx else 4) * C * I)
    n_in = (N * (I + 4 * C + C + 2 * R) + 4 * C * (I + R) + R * C + 3 * C
            + S * (2 * C + R))
    n_out = 4 * C * (I + R + 1) + R * C + 3 * C + S * (C + R) \
        + (N * I if need_dx else 0)
    return bound_ms(ops, 4.0 * (n_in + n_out) + (N * 4 * C if mask else 0))


def k2_tc_bound(simt, T, S, I, C, R, need_dx):
    """K2's float32-accurate tensor-core bound: the products it runs on
    the tensor cores (the per-step dr = dgifo Wr, dWr, dWrm, dWx and,
    with dx, dx = dxw Wx) three times over at the TF32 peak, plus the
    one it keeps on the CUDA cores (bwd_cell's dm = dr_total Wrm) at the
    f32 peak; the compulsory bytes are those of the f32 bound `simt`
    (ms, by). Returns (ms, by)."""
    N = T * S
    tc_ops = 2.0 * N * (8 * C * R + R * C + (8 if need_dx else 4) * C * I)
    t_ops = 1e3 * (3 * tc_ops / PEAK_TF32_FLOPS
                   + 2.0 * N * R * C / PEAK_F32_FLOPS)
    t_bytes = simt[0] if simt[1] == "bytes" else 0.0
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def k3_bound(N, R, K, Km):
    return bound_ms(2.0 * N * K * R,
                    4.0 * (N * R + K * R + K + 2 * N * Km + 4 * N))


def k4_bound(N, R, K, Km):
    # the function needs the logits once, dr and dW: 3 x 2NKR
    return bound_ms(3 * 2.0 * N * K * R,
                    4.0 * (2 * N * R + 2 * K * R + 2 * K + 2 * N * Km
                           + 3 * N))


def tc_bound(simt, products, N, R, K):
    """The float32-accurate tensor-core bound of K3 (1 product) or K4 (3
    products): 3xTF32 does each product's 2NKR operations three times at
    the TF32 peak; the compulsory bytes are those of the f32 bound
    `simt` (ms, by). Returns (ms, by)."""
    t_ops = 1e3 * 3 * products * 2.0 * N * K * R / PEAK_TF32_FLOPS
    t_bytes = simt[0] if simt[1] == "bytes" else 0.0
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def compare(what, got, ref, worst):
    """Fail unless |got - ref| <= TRAIN_TOL * (1 + max|ref|); returns the
    new worst absolute error."""
    d = float((got - ref).abs().max()) if got.numel() else 0.0
    scale = 1.0 + (float(ref.abs().max()) if ref.numel() else 0.0)
    log(f"    {what}: max_abs_err {d:.3e}, scaled {d / scale:.3e} "
        f"(tol {TRAIN_TOL:g} x (1 + max|ref| = {scale:.4g}))")
    if not d <= TRAIN_TOL * scale:
        fail(f"{what} disagrees with the plain version")
    if not bool(got.isfinite().all()):
        fail(f"{what} has non-finite entries")
    return max(worst, d)


def lstm_train_case(name, S, T, I, C, R, clip, keep, need_dx, seed,
                    param_scale=0.04, x_scale=1.0, timed=False):
    """K1 and K2 against their plain versions on one input; returns
    (worst abs error, timing record or None)."""
    import torch
    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    params, x, state = lstm_case(S, T, I, C, R, seed, param_scale, x_scale)
    x_tm = x.transpose(0, 1).contiguous()
    rng = np.random.RandomState(seed + 100)
    mask = None
    if keep is not None:
        mask = torch.tensor(rng.rand(T, S, 4 * C) < keep,
                            device="cuda").to(torch.int8)
    ik = 1.0 if keep is None else 1.0 / keep
    g_r = torch.tensor(rng.randn(T, S, R).astype(np.float32), device="cuda")
    gcT = torch.tensor(rng.randn(S, C).astype(np.float32), device="cuda")
    fwd_args = (params, x_tm, state.c, state.r, mask, ik, clip)
    log(f"  [{name}] S={S} T={T} I={I} C={C} R={R} clip {clip:g} "
        f"keep {keep} dx {need_dx}")
    plan = lt.fwd_plan(T, S, I, C, R, torch.cuda.get_device_properties(
        0).multi_processor_count)
    lt.reset_counts()
    fk = lt.lstm_fwd_residuals_cuda(*fwd_args)
    torch.cuda.synchronize()
    log(f"    K1 plan {plan}: FWD_LAUNCHES {lt.FWD_LAUNCHES} == "
        f"fwd_launches({T}) = {lt.fwd_launches(T)}")
    if (lt.FWD_LAUNCHES, lt.PLAIN_CALLS) != (lt.fwd_launches(T), 0):
        fail(f"{name}: K1 made {lt.FWD_LAUNCHES} launches and "
             f"{lt.PLAIN_CALLS} plain calls (expected {lt.fwd_launches(T)} "
             f"and 0)")
    fp = lt.lstm_fwd_residuals_plain(*fwd_args)
    torch.cuda.synchronize()
    worst = 0.0
    for what, a, b in zip(("K1 gifo", "K1 c", "K1 r"), fk, fp):
        worst = compare(what, a, b, worst)
    if clip < 10 and not bool((fp[1].abs() == clip).any()):
        fail(f"{name}: the clip never engaged")
    bwd_args = (params, x_tm, state.c, state.r, *fp, mask, ik, g_r, gcT,
                need_dx)
    bk = lt.lstm_bwd_cuda(*bwd_args)
    bp = lt.lstm_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    for f, a, b in zip(type(params)._fields, bk[0], bp[0]):
        worst = compare(f"K2 d{f}", a, b, worst)
    worst = compare("K2 dc0", bk[2], bp[2], worst)
    worst = compare("K2 dr0", bk[3], bp[3], worst)
    if need_dx:
        worst = compare("K2 dx", bk[1], bp[1], worst)
    elif bk[1] is not None:
        fail("K2 computed dx although need_input_grad is false")
    if not timed:
        return worst, None
    rec = {}
    for key, kfn, pfn, bnd in (
            ("K1", lambda: lt.lstm_fwd_residuals_cuda(*fwd_args),
             lambda: lt.lstm_fwd_residuals_plain(*fwd_args),
             k1_bound(T, S, I, C, R, mask is not None)),
            ("K2", lambda: lt.lstm_bwd_cuda(*bwd_args),
             lambda: lt.lstm_bwd_plain(*bwd_args),
             k2_bound(T, S, I, C, R, mask is not None, need_dx))):
        k_ms = cuda_ms(kfn)
        p_ms = cuda_ms(pfn, reps=3)
        rec[key] = {"ms": k_ms, "plain_ms": p_ms}
        if key == "K1":
            simt = bnd
            tc = k1_tc_bound(simt, T, S, I, C, R)
            bnd = min(simt, tc)
            what = (f"bounds: f32 CUDA cores {simt[0]:.4f} ms ({simt[1]}), "
                    f"3xTF32 tensor cores {tc[0]:.4f} ms ({tc[1]}; 3 x "
                    f"the products' operations at "
                    f"{PEAK_TF32_FLOPS / 1e12:g} TFLOP/s); compulsory "
                    f"bytes {k1_bytes_ms(T, S, I, C, R, mask is not None):.4f}"
                    f" ms")
            rec[key].update(bound_f32_simt_ms=simt[0],
                            bound_3xtf32_ms=tc[0])
        elif key == "K2":
            simt = bnd
            tc = k2_tc_bound(simt, T, S, I, C, R, need_dx)
            bnd = min(simt, tc)
            what = (f"bounds: f32 CUDA cores {simt[0]:.4f} ms ({simt[1]}), "
                    f"3xTF32 tensor cores {tc[0]:.4f} ms ({tc[1]}; 3 x "
                    f"the products' operations at "
                    f"{PEAK_TF32_FLOPS / 1e12:g} TFLOP/s, dm at "
                    f"{PEAK_F32_FLOPS / 1e12:g})")
            rec[key].update(bound_f32_simt_ms=simt[0],
                            bound_3xtf32_ms=tc[0])
        log(f"  [{name}] {key}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"{what}; library: n/a (no single PyTorch call computes the "
            f"LSTMP recurrence with peepholes, clip and its residuals)")
        rec[key].update(bound_ms=bnd[0], bound_by=bnd[1])
    # K1: its launches by kernel
    split = k1_launch_split(lambda: lt.lstm_fwd_residuals_cuda(*fwd_args), T)
    log(f"  [{name}] K1 launches per call by kernel (profiler, ms per "
        f"launch): " + ", ".join(
            f"{k} x{v['launches']:g} " + (
                f"{v['ms_per_launch']:.4f}" if v["ms_per_launch"] is not None
                else "not measured") for k, v in split.items()))
    rec["K1"].update(launch_split=split)
    # context: cuBLAS f32 on K1's three products and K2's four at these
    # shapes (random operands; the port never calls these)
    N = T * S
    xs2, r_c, m_c = (torch.randn(n, k, device="cuda")
                     for n, k in ((N, I), (S, R), (S, C)))

    def k1_products():
        xs2 @ params.w_gifo_x.T
        for _ in range(T):
            r_c @ params.w_gifo_r.T
            m_c @ params.w_r_m.T
    k1_ctx = {"x Wx^T": cuda_ms(lambda: xs2 @ params.w_gifo_x.T),
              f"r Wr^T x{T}": cuda_ms(lambda: [r_c @ params.w_gifo_r.T
                                               for _ in range(T)]),
              f"m Wrm^T x{T}": cuda_ms(lambda: [m_c @ params.w_r_m.T
                                                for _ in range(T)]),
              "all three": cuda_ms(k1_products)}
    log(f"  [{name}] K1 context (cuBLAS f32, not used by the port): " +
        ", ".join(f"{k} {v:.3f} ms" for k, v in k1_ctx.items()))
    rec["K1"]["cublas_products_ms"] = k1_ctx
    del xs2, r_c, m_c
    dg, ho, rp, xs = (torch.randn(N, n, device="cuda")
                      for n in (4 * C, C, R, I))
    drt = torch.randn(N, R, device="cuda")
    ctx = {what: cuda_ms(fn) for what, fn in (
        ("dWr", lambda: dg.T @ rp), ("dWrm", lambda: drt.T @ ho),
        ("dWx", lambda: dg.T @ xs), ("dx", lambda: dg @ params.w_gifo_x))}
    log(f"  [{name}] context (cuBLAS f32, not used by the port): " +
        ", ".join(f"{k} {v:.3f} ms" for k, v in ctx.items()) +
        f"; sum {sum(ctx.values()):.3f} ms")
    rec["K2"]["cublas_products_ms"] = ctx
    del dg, ho, rp, xs, drt
    return worst, rec


def lstm_function_case():
    """The autograd Function on the card (K1 + K2) against the same
    Function on the CPU (plain versions), with nonzero cotangents of the
    output and of the final c and r."""
    import torch
    from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams, LstmState
    from kaldi_lstm_tpu_torch.ops.lstm_train import lstm_train
    S, T, I, C, R = 5, 9, 37, 200, 130
    params, x, state = lstm_case(S, T, I, C, R, 31, 0.05, 2.0, device="cpu")
    rng = np.random.RandomState(32)
    cots = [torch.tensor(rng.randn(*shape).astype(np.float32))
            for shape in ((S, T, R), (S, C), (S, R))]
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).requires_grad_() for t in (x, state.c, state.r,
                                                       *params)]
        out, fin = lstm_train(LstmParams(*leaves[3:]), leaves[0],
                              LstmState(leaves[1], leaves[2]), 50.0)
        torch.autograd.backward([out, fin.c, fin.r],
                                [c.to(dev) for c in cots])
        grads[dev] = [out.detach(), fin.c.detach(), fin.r.detach()] + \
            [t.grad for t in leaves]
    log(f"  [Function, S={S} T={T} I={I} C={C} R={R}, nonzero final-state "
        f"cotangent] card vs CPU")
    worst = 0.0
    names = ["out", "c_T", "r_T", "dx", "dc0", "dr0"] + \
        [f"d{f}" for f in LstmParams._fields]
    for n, a, b in zip(names, grads["cuda"], grads["cpu"]):
        worst = compare(n, a.cpu(), b, worst)
    return worst


def xent_case(name, N, R, K, Km, seed, bias_scale=0.1, mask_p=0.8,
              tie_at=None, timed=False, foreign=False):
    """K3 and K4 against their plain versions on one input; returns
    (worst abs error, timing record or None). Timed cases also print
    cuBLAS f32 times of the three products (context, not used by the
    port). With `foreign` every other row's targets are -1, an id of
    another class shard (the tensor-parallel loss's input)."""
    import torch
    from kaldi_lstm_tpu_torch.ops import xent_affine as xa
    g = torch.Generator().manual_seed(seed)
    r = torch.randn(N, R, generator=g)
    w = torch.randn(K, R, generator=g) * 0.04
    b = torch.randn(K, generator=g) * bias_scale
    if tie_at is not None:
        # exact tie straddling a tile or chunk edge: small integers and
        # powers of two make every sum exact in any order
        r = torch.randint(-2, 3, (N, R), generator=g).float()
        w = torch.randint(-4, 5, (K, R), generator=g).float() / 8.0
        b = torch.zeros(K)
        w[tie_at] = w[tie_at + 1] = 8.0 * r.abs().amax(0) * torch.sign(r[0])
    ids = torch.randint(0, K, (N, Km), generator=g).to(torch.int32)
    if foreign:
        ids[::2] = -1
    tw = torch.rand(N, Km, generator=g)
    mask = (torch.rand(N, generator=g) < mask_p).float()
    r, w, b, ids, tw, mask = (t.cuda() for t in (r, w, b, ids, tw, mask))
    log(f"  [{name}] N={N} R={R} K={K} Km={Km}")
    fk = xa.xent_fwd_cuda(r, w, b, ids, tw)
    fp = xa.xent_fwd_plain(r, w, b, ids, tw)
    torch.cuda.synchronize()
    worst = 0.0
    for what, a, c in zip(("K3 lse", "K3 picked", "K3 max"), fk[:3], fp[:3]):
        worst = compare(what, a, c, worst)
    diff = (fk[3] != fp[3]).nonzero().flatten()
    if diff.numel():
        z = r[diff] @ w.T + b
        picked_z = z.gather(1, fk[3][diff].long()[:, None])[:, 0]
        tol = TRAIN_TOL * (1.0 + fp[2][diff].abs())
        if not bool((picked_z >= fp[2][diff] - tol).all()):
            fail(f"{name}: K3 argmax differs beyond near-ties")
    log(f"    K3 argmax: {diff.numel()} of {N} rows differ (near-ties only)")
    if tie_at is not None and int(fk[3][0]) != tie_at:
        fail(f"{name}: K3 did not keep the first of tied maxima "
             f"({int(fk[3][0])} != {tie_at})")
    scale, wtot = mask, tw.sum(-1)
    bargs = (r, w, b, ids, tw, fp[0], scale, wtot)
    bk = xa.xent_bwd_cuda(*bargs)
    bp = xa.xent_bwd_plain(*bargs)
    torch.cuda.synchronize()
    for what, a, c in zip(("K4 dr", "K4 dW", "K4 db"), bk, bp):
        worst = compare(what, a, c, worst)
    if bool(bk[0][mask == 0].any()):
        fail(f"{name}: masked rows contributed to dr")
    if not timed:
        return worst, None
    rec = {}
    for key, kfn, pfn, simt, products in (
            ("K3", lambda: xa.xent_fwd_cuda(r, w, b, ids, tw),
             lambda: xa.xent_fwd_plain(r, w, b, ids, tw),
             k3_bound(N, R, K, Km), 1),
            ("K4", lambda: xa.xent_bwd_cuda(*bargs),
             lambda: xa.xent_bwd_plain(*bargs), k4_bound(N, R, K, Km), 3)):
        k_ms = cuda_ms(kfn)
        p_ms = cuda_ms(pfn)
        tc = tc_bound(simt, products, N, R, K)
        bnd = min(simt, tc)
        log(f"  [{name}] {key}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms; "
            f"bounds: f32 CUDA cores {simt[0]:.4f} ms ({simt[1]}), 3xTF32 "
            f"tensor cores {tc[0]:.4f} ms ({tc[1]}; 3 x the product's "
            f"operations at {PEAK_TF32_FLOPS / 1e12:g} TFLOP/s); library: "
            f"n/a (no single PyTorch call computes the affine + softmax + "
            f"sparse-target xent or its fused gradient)")
        rec[key] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
                    "bound_by": bnd[1], "bound_f32_simt_ms": simt[0],
                    "bound_3xtf32_ms": tc[0]}
    dz = torch.exp(r @ w.T + b - fp[0][:, None]) * (scale * wtot)[:, None]
    times = [cuda_ms(fn) for fn in (lambda: r @ w.T, lambda: dz @ w,
                                    lambda: dz.T @ r)]
    log(f"  [{name}] context (cuBLAS f32, not used by the port): r @ W.T "
        f"{times[0]:.3f} ms, dz @ W {times[1]:.3f} ms, dz.T @ r "
        f"{times[2]:.3f} ms")
    del dz
    return worst, rec


def phase_train_kernels():
    """K1-K4 vs plain on the card. Returns {kernel: record} with the
    timings at the main path's shape and the worst abs error."""
    S, T, I, C, R, K = TRAIN_S, TRAIN_T, 40, 800, 512, 8000
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    recs = {}
    lstm_cases = [
        # name, dims, clip, keep, need_dx, extra, timed
        ("flagship, main path (no dropout, no dx)", (S, T, I, C, R), 50.0,
         None, False, {}, True),
        ("flagship, keep 0.8, dx", (S, T, I, C, R), 50.0, 0.8, True, {},
         False),
        ("ragged S=3 I=37 C=200 R=130, clip active", (3, T, 37, 200, 130),
         1.0, 0.8, True, {"x_scale": 20.0, "param_scale": 0.2}, False),
        ("deep layer 2, I=512, dx", (S, T, 512, C, R), 50.0, None, True, {},
         "deep"),
        ("deep layer 2, I=512, keep 0.8, dx", (S, T, 512, C, R), 50.0, 0.8,
         True, {}, False),
    ]
    # timed: True = the main path's record; "deep" = its I=512 times
    deep = {}
    for i, (name, dims, clip, keep, dx, extra, timed) in \
            enumerate(lstm_cases):
        w, rec = lstm_train_case(name, *dims, clip, keep, dx, 40 + i,
                                 timed=bool(timed), **extra)
        worst["K1"] = worst["K2"] = max(worst["K1"], w)
        if rec and timed is True:
            recs.update(rec)
        elif rec:
            deep = rec
    for k in ("K1", "K2"):
        recs[k].update({f"i512_{f}": deep[k][f] for f in
                        ("ms", "plain_ms", "bound_ms", "bound_3xtf32_ms",
                         "bound_f32_simt_ms")})
    recs["K1"]["i512_launch_split"] = deep["K1"]["launch_split"]
    w = lstm_function_case()
    worst["K1"] = worst["K2"] = max(worst["K1"], w)
    from kaldi_lstm_tpu_torch.ops.xent_affine import FWD_CHUNK
    log(f"  K3/K4 design: every product (r W^T, dz W, dz^T r) on the tensor "
        f"cores as mma.sync m16n8k8 TF32 in the 3xTF32 split (x = hi + lo, "
        f"a_lo b_hi + a_hi b_lo + a_hi b_hi in f32, one zeroed fragment "
        f"per 32-deep stage), cp.async-fed shared-memory tiles; K3 = "
        f"(128-frame tile x {FWD_CHUNK}-class chunk) partials + a merge "
        f"launch, K4 = dz stored once + dr + dW/db; held to TRAIN_TOL as "
        f"the f32 kernels were")
    xent_cases = [
        ("flagship, main path", (S * T, R, K, 1), {}, True),
        ("ragged N=1001 R=130 K=1000 Km=3", (1001, 130, 1000, 3), {}, False),
        ("large bias 200, half the rows masked", (70, 64, 300, 2),
         {"bias_scale": 200.0, "mask_p": 0.5}, False),
        ("argmax tie at classes 63/64", (40, 16, 200, 1), {"tie_at": 63},
         False),
        (f"argmax tie at classes {FWD_CHUNK - 1}/{FWD_CHUNK} (K3 chunk "
         f"edge)", (40, 16, 2 * FWD_CHUNK + 100, 1),
         {"tie_at": FWD_CHUNK - 1}, False),
        ("ragged N=1001 R=136 K=1003 Km=2 (off every tile, K % 4 != 0)",
         (1001, 136, 1003, 2), {}, False),
        ("deep config K=16624", (S * T, R, DEEP_K, 1), {}, "deep"),
    ]
    for i, (name, dims, extra, timed) in enumerate(xent_cases):
        w, rec = xent_case(name, *dims, 60 + i, timed=bool(timed), **extra)
        worst["K3"] = worst["K4"] = max(worst["K3"], w)
        if rec and timed is True:
            recs.update(rec)
        elif rec:
            for k in ("K3", "K4"):
                recs[k].update({f"k16624_{f}": rec[k][f] for f in
                                ("ms", "plain_ms", "bound_ms")})
    for k in recs:
        recs[k]["max_abs_err"] = worst[k]
    return recs


# ---------------------------------------------------------------------------
# phase 3d: the bf16 variants of K1-K5 (the --bf16 path)
# ---------------------------------------------------------------------------

def rms(t) -> float:
    return float(t.double().pow(2).mean().sqrt()) if t.numel() else 0.0


def bf16_compare(what, got, ref, ref_f32, ref_f64, worst, witness=None,
                 tc=None):
    """The bf16 kernel `got` against its bf16 plain version `ref`: fail
    unless rms(got - ref) <= max(BF16_SHARE * distance, BF16_NOISE *
    noise), with distance = rms(ref - ref_f32) (the plain version in bf16
    against itself in f32) real (above 1e-6 of the plain result's RMS,
    some eight f32 ulps: lse carries a large offset, log K)
    and noise = rms(ref_f64 - ref) (the plain version in bf16 summing in
    f64 against it summing in f32), or rms(witness - ref) where a
    `witness` (the plain version in bf16 summing in another f32 order) is
    given and that is larger. With `tc`, the kernel's tc-exact mirror
    (its tiles, its tensor cores' sums by ops/tc_sum.py's model, its
    fused cell math): the kernel must lie within TC_SHARE of the distance
    from it, and its distance from the plain version is a third noise
    witness. Returns the new worst absolute error."""
    got, ref, ref_f32, ref_f64 = (a.double() for a in (got, ref, ref_f32,
                                                       ref_f64))
    err, dist, noise = rms(got - ref), rms(ref - ref_f32), rms(ref_f64 - ref)
    if witness is not None:
        w = rms(witness.double().to(ref.device) - ref)
        log(f"    {what}: f64 noise / distance "
            f"{noise / dist if dist else float('inf'):.4f}, other-order "
            f"witness / distance {w / dist if dist else float('inf'):.4f}")
        noise = max(noise, w)
    if tc is not None:
        tc = tc.double().to(ref.device)
        tc_err, tc_noise = rms(got - tc), rms(tc - ref)
        log(f"    {what}: kernel against its tc-exact mirror / distance "
            f"{tc_err / dist if dist else float('inf'):.4f} (gate "
            f"{TC_SHARE:g}; bit for bit in "
            f"{float((got == tc).double().mean()):.5f} of entries); the "
            f"mirror against the plain version / distance "
            f"{tc_noise / dist if dist else float('inf'):.4f}")
        if not tc_err <= TC_SHARE * dist:
            fail(f"{what} departs from its tc-exact mirror")
        noise = max(noise, tc_noise)
    mx = float((got - ref).abs().max()) if got.numel() else 0.0
    tol = max(BF16_SHARE * dist, BF16_NOISE * noise)
    log(f"    {what}: max_abs_err {mx:.3e}, rms err {err:.3e}; bf16-vs-f32 "
        f"distance rms {dist:.3e}; err / distance "
        f"{err / dist if dist else float('inf'):.4f}; the plain version's "
        f"f32-vs-f64 noise / distance "
        f"{noise / dist if dist else float('inf'):.4f} (tol "
        f"max({BF16_SHARE:g}, {BF16_NOISE:g} x noise) x distance)")
    if not bool(got.isfinite().all()):
        fail(f"{what} has non-finite entries")
    if not dist > 1e-6 * rms(ref):
        fail(f"{what}: the bf16-vs-f32 distance is too small to test")
    if not err <= tol:
        fail(f"{what} disagrees with its bf16 plain version")
    return max(worst, mx)


def on_cpu(tree):
    """Every tensor of a tuple (or LstmParams, LstmState) on the CPU,
    anything else as it is."""
    import torch
    if isinstance(tree, tuple):
        items = [on_cpu(t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def f64(tree):
    """Every f32 tensor of a tuple (or LstmParams, LstmState) in f64,
    anything else as it is."""
    import torch
    if isinstance(tree, tuple):
        items = [f64(t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.double()
    return tree


def bf16_bound(ops: float, nbytes: float) -> tuple[float, str]:
    """Least time on this card for a function whose products take bf16
    operands: the operations at the bf16 tensor-core peak against the
    compulsory bytes at the HBM rate. Returns (ms, by)."""
    t_ops = ops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def k1_bf16_bound(T, S, I, C, R, mask):
    """K1 in bf16: its three products at 989 TFLOP/s; the bytes of the
    f32 inputs and c, r out, gifo out in bf16 (2 bytes) and the int8
    mask."""
    ops = 2.0 * T * S * (4 * C * (I + R) + C * R)
    n_in = T * S * I + (I + R) * 4 * C + 7 * C + C * R + S * (C + R)
    nbytes = 4.0 * (n_in + T * S * (C + R)) + 2.0 * T * S * 4 * C \
        + (T * S * 4 * C if mask else 0)
    return bf16_bound(ops, nbytes)


def k2_bf16_bound(T, S, I, C, R, mask, need_dx):
    """K2 in bf16: every product (dm, dr, dWx, dWr, dWrm, dx) at 989
    TFLOP/s; the bytes of k2_bound with gifo read in bf16."""
    N = T * S
    ops = 2.0 * N * (2 * R * C + 8 * C * R + (8 if need_dx else 4) * C * I)
    n_in = (N * (I + C + 2 * R) + 4 * C * (I + R) + R * C + 3 * C
            + S * (2 * C + R))
    n_out = 4 * C * (I + R + 1) + R * C + 3 * C + S * (C + R) \
        + (N * I if need_dx else 0)
    return bf16_bound(ops, 4.0 * (n_in + n_out) + 2.0 * N * 4 * C
                      + (N * 4 * C if mask else 0))


def k1_plain_steps(fa, ck, rk, compute_dtype=None):
    """K1's plain version step by step from the kernel's own state: step t
    from c_{t-1}, r_{t-1} of the kernel's outputs ck, rk (the inputs' c0,
    r0 at t = 0), for every t; (gifo, c_seq, r_seq) as the plain version
    returns them."""
    import torch
    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    params, x_tm, c0, r0, mask, ik, clip = fa
    steps = [lt.lstm_fwd_residuals_plain(
        params, x_tm[t:t + 1], c0 if t == 0 else ck[t - 1],
        r0 if t == 0 else rk[t - 1], None if mask is None else mask[t:t + 1],
        ik, clip, compute_dtype=compute_dtype) for t in range(len(x_tm))]
    return tuple(torch.cat([st[i] for st in steps]) for i in range(3))


def lstm_train_bf16_case(name, S, T, I, C, R, keep, need_dx, seed,
                         timed=False, stepwise=False):
    """K1 and K2 in bf16 against their bf16 plain versions on one input;
    returns (worst abs error, timing record or None). With `stepwise`
    (a lone stream), K1's free-running noise is the larger of the f64
    sum's and the distance of the plain version run on the CPU (another
    valid f32 summation order) from the card's: in a lone stream a bf16
    rounding that another order takes the other way is carried through
    every later step and moves the whole tensor (tools/bf16_seed_sweep.py:
    at S=1, T=64 the CPU-order plain version itself misses the tenth of
    the distance at some seeds while the f64 sum sees little); and K1 is
    also held to its plain version step by step (k1_plain_steps: each
    step from the kernel's own state) by the unchanged rule."""
    import torch
    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    bf = torch.bfloat16
    params, x, state = lstm_case(S, T, I, C, R, seed)
    x_tm = x.transpose(0, 1).contiguous()
    rng = np.random.RandomState(seed + 100)
    mask = None
    if keep is not None:
        mask = torch.tensor(rng.rand(T, S, 4 * C) < keep,
                            device="cuda").to(torch.int8)
    ik = 1.0 if keep is None else 1.0 / keep
    g_r = torch.tensor(rng.randn(T, S, R).astype(np.float32), device="cuda")
    gcT = torch.tensor(rng.randn(S, C).astype(np.float32), device="cuda")
    fa = (params, x_tm, state.c, state.r, mask, ik, 50.0)
    plan = lt.fwd_plan(T, S, I, C, R, torch.cuda.get_device_properties(
        0).multi_processor_count, bf16=True)
    log(f"  [{name}] S={S} T={T} I={I} C={C} R={R} keep {keep} dx "
        f"{need_dx}; K1 plan: gate tile {plan['gate_bm']} x "
        f"{plan['gate_bn']} ({plan['gate_ctas']} CTAs), "
        f"xw on {plan['xw_route']} ({plan['xw_ctas']} CTAs), projection "
        f"{plan['proj_ctas']} CTAs")
    lt.reset_counts()
    fk = lt.lstm_fwd_residuals_cuda(*fa, compute_dtype=bf)
    torch.cuda.synchronize()
    if (lt.FWD_BF16_LAUNCHES, lt.FWD_LAUNCHES, lt.PLAIN_CALLS) != \
            (lt.fwd_launches(T), 0, 0) or fk[0].dtype != bf:
        fail(f"{name}: K1 bf16 made {lt.FWD_BF16_LAUNCHES} bf16 and "
             f"{lt.FWD_LAUNCHES} f32 launches (expected "
             f"{lt.fwd_launches(T)} and 0), gifo {fk[0].dtype}")
    fp = lt.lstm_fwd_residuals_plain(*fa, compute_dtype=bf)
    f32 = lt.lstm_fwd_residuals_plain(*fa)
    fd = lt.lstm_fwd_residuals_plain(*f64(fa), compute_dtype=bf)
    ftc = lt.lstm_fwd_tc_plain(*fa, compute_dtype=bf, tc=True)
    worst = 0.0
    wit = (None,) * 3
    if stepwise:
        cpu = lt.lstm_fwd_residuals_plain(*on_cpu(fa), compute_dtype=bf)
        wit = cpu
    for what, a, b, c, d, w, m in zip(("K1 gifo", "K1 c", "K1 r"), fk, fp,
                                      f32, fd, wit, ftc):
        worst = bf16_compare(what, a, b, c, d, worst, witness=w, tc=m)
    del ftc
    if stepwise:
        del cpu, wit
        steps = (k1_plain_steps(fa, fk[1], fk[2], bf),
                 k1_plain_steps(fa, fk[1], fk[2]),
                 k1_plain_steps(f64(fa), fk[1].double(), fk[2].double(),
                                bf))
        for what, a, b, c, d in zip(("K1 gifo", "K1 c", "K1 r"), fk, *steps):
            worst = bf16_compare(what + " (step by step)", a, b, c, d, worst)
        del steps
    del fd
    ba = (params, x_tm, state.c, state.r)
    bk = lt.lstm_bwd_cuda(*ba, *fp, mask, ik, g_r, gcT, need_dx,
                          compute_dtype=bf)
    torch.cuda.synchronize()
    if (lt.BWD_BF16_LAUNCHES, lt.BWD_LAUNCHES) != \
            (lt.bwd_launches(T, need_dx, bf16=True), 0):
        fail(f"{name}: K2 bf16 made {lt.BWD_BF16_LAUNCHES} bf16 and "
             f"{lt.BWD_LAUNCHES} f32 launches")
    bp = lt.lstm_bwd_plain(*ba, *fp, mask, ik, g_r, gcT, need_dx,
                           compute_dtype=bf)
    b32 = lt.lstm_bwd_plain(*ba, *f32, mask, ik, g_r, gcT, need_dx)
    bd = lt.lstm_bwd_plain(*f64((*ba, *fp, mask, ik, g_r, gcT)), need_dx,
                           compute_dtype=bf)
    btc = lt.lstm_bwd_split_plain(
        *ba, *fp, mask, ik, g_r, gcT, need_dx,
        sms=torch.cuda.get_device_properties(0).multi_processor_count,
        compute_dtype=bf, tc=True)
    for f, a, b, c, d, m in zip(type(params)._fields, bk[0], bp[0], b32[0],
                                bd[0], btc[0]):
        worst = bf16_compare(f"K2 d{f}", a, b, c, d, worst, tc=m)
    worst = bf16_compare("K2 dc0", bk[2], bp[2], b32[2], bd[2], worst,
                         tc=btc[2])
    worst = bf16_compare("K2 dr0", bk[3], bp[3], b32[3], bd[3], worst,
                         tc=btc[3])
    if need_dx:
        worst = bf16_compare("K2 dx", bk[1], bp[1], b32[1], bd[1], worst,
                             tc=btc[1])
    elif bk[1] is not None:
        fail("K2 bf16 computed dx although need_input_grad is false")
    del f32, b32, bd, btc
    if not timed:
        return worst, None
    rec = {}
    for key, kfn, pfn, bnd in (
            ("K1", lambda: lt.lstm_fwd_residuals_cuda(*fa, compute_dtype=bf),
             lambda: lt.lstm_fwd_residuals_plain(*fa, compute_dtype=bf),
             k1_bf16_bound(T, S, I, C, R, mask is not None)),
            ("K2", lambda: lt.lstm_bwd_cuda(*ba, *fp, mask, ik, g_r, gcT,
                                            need_dx, compute_dtype=bf),
             lambda: lt.lstm_bwd_plain(*ba, *fp, mask, ik, g_r, gcT,
                                       need_dx, compute_dtype=bf),
             k2_bf16_bound(T, S, I, C, R, mask is not None, need_dx))):
        k_ms = cuda_ms(kfn)
        p_ms = cuda_ms(pfn, reps=3)
        log(f"  [{name}] {key} bf16: kernel {k_ms:.3f} ms, plain "
            f"{p_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}; the products "
            f"at {PEAK_BF16_FLOPS / 1e12:g} TFLOP/s, the bytes at "
            f"{PEAK_BYTES_PER_S / 1e12:g} TB/s); library: n/a")
        rec[key] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
                    "bound_by": bnd[1]}
    # context: cuBLAS bf16 on K1's three products and K2's four at these
    # shapes (random operands; the port never calls these)
    N = T * S
    w16 = [p.to(bf) for p in (params.w_gifo_x, params.w_gifo_r,
                              params.w_r_m)]
    xs2, r_c, m_c = (torch.randn(n, k, device="cuda", dtype=bf)
                     for n, k in ((N, I), (S, R), (S, C)))
    k1_ctx = {"x Wx^T": cuda_ms(lambda: xs2 @ w16[0].T),
              f"r Wr^T x{T}": cuda_ms(lambda: [r_c @ w16[1].T
                                               for _ in range(T)]),
              f"m Wrm^T x{T}": cuda_ms(lambda: [m_c @ w16[2].T
                                                for _ in range(T)])}
    dg, ho, rp, xs, drt = (torch.randn(N, n, device="cuda", dtype=bf)
                           for n in (4 * C, C, R, I, R))
    k2_ctx = {f"dm x{T}": cuda_ms(
                  lambda: [drt[:S] @ w16[2] for _ in range(T)]),
              f"dr x{T}": cuda_ms(lambda: [dg[:S] @ w16[1]
                                           for _ in range(T)]),
              "dWr": cuda_ms(lambda: dg.T @ rp),
              "dWrm": cuda_ms(lambda: drt.T @ ho),
              "dWx": cuda_ms(lambda: dg.T @ xs)}
    if need_dx:
        k2_ctx["dx"] = cuda_ms(lambda: dg @ w16[0])
    for key, ctx in (("K1", k1_ctx), ("K2", k2_ctx)):
        log(f"  [{name}] {key} context (cuBLAS bf16, not used by the "
            f"port): " + ", ".join(f"{k} {v:.3f} ms" for k, v in ctx.items())
            + f"; sum {sum(ctx.values()):.3f} ms")
        rec[key]["cublas_bf16_products_ms"] = ctx
    del xs2, r_c, m_c, dg, ho, rp, xs, drt
    return worst, rec


def xent_bf16_case(name, N, R, K, Km, seed, mask_p=0.8, timed=False):
    """K3 and K4 in bf16 against their bf16 plain versions; returns
    (worst abs error, timing record or None)."""
    import torch
    from kaldi_lstm_tpu_torch.ops import xent_affine as xa
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(seed)
    r = torch.randn(N, R, generator=g)
    w = torch.randn(K, R, generator=g) * 0.04
    b = torch.randn(K, generator=g) * 0.1
    ids = torch.randint(0, K, (N, Km), generator=g).to(torch.int32)
    tw = torch.rand(N, Km, generator=g)
    mask = (torch.rand(N, generator=g) < mask_p).float()
    r, w, b, ids, tw, mask = (t.cuda() for t in (r, w, b, ids, tw, mask))
    plan = xa.xent_bf16_plan(N, R, K, torch.cuda.get_device_properties(
        0).multi_processor_count)
    log(f"  [{name}] N={N} R={R} K={K} Km={Km}; plan: chunk "
        f"{plan['chunk']} ({plan['logits_items']} items on "
        f"{plan['logits_grid']} CTAs), dr {plan['dr_items']} tiles, dW "
        f"{plan['dw_items']} tiles")
    xa.reset_counts()
    fk = xa.xent_fwd_cuda(r, w, b, ids, tw, compute_dtype=bf)
    fp = xa.xent_fwd_plain(r, w, b, ids, tw, compute_dtype=bf)
    f32 = xa.xent_fwd_plain(r, w, b, ids, tw)
    fd = xa.xent_fwd_plain(*f64((r, w, b, ids, tw)), compute_dtype=bf)
    torch.cuda.synchronize()
    fwd_n, bwd_n = xa.xent_launches(bf16=True)
    if (xa.FWD_BF16_LAUNCHES, xa.FWD_LAUNCHES) != (fwd_n, 0):
        fail(f"{name}: K3 bf16 launches {xa.FWD_BF16_LAUNCHES}, f32 "
             f"{xa.FWD_LAUNCHES}")
    worst = 0.0
    for what, a, c, d, e in zip(("K3 lse", "K3 picked", "K3 max"), fk[:3],
                                fp[:3], f32[:3], fd[:3]):
        worst = bf16_compare(what, a, c, d, e, worst)
    diff = (fk[3] != fp[3]).nonzero().flatten()
    if diff.numel():
        z = (r[diff].to(bf).float() @ w.to(bf).float().T) + b
        picked_z = z.gather(1, fk[3][diff].long()[:, None])[:, 0]
        tol = TRAIN_TOL * (1.0 + fp[2][diff].abs())
        if not bool((picked_z >= fp[2][diff] - tol).all()):
            fail(f"{name}: K3 bf16 argmax differs beyond near-ties")
    log(f"    K3 argmax: {diff.numel()} of {N} rows differ (near-ties only)")
    scale, wtot = mask, tw.sum(-1)
    bargs = (r, w, b, ids, tw, fp[0], scale, wtot)
    bk = xa.xent_bwd_cuda(*bargs, compute_dtype=bf)
    bp = xa.xent_bwd_plain(*bargs, compute_dtype=bf)
    b32 = xa.xent_bwd_plain(r, w, b, ids, tw, f32[0], scale, wtot)
    bd = xa.xent_bwd_plain(*f64(bargs), compute_dtype=bf)
    torch.cuda.synchronize()
    if (xa.BWD_BF16_LAUNCHES, xa.BWD_LAUNCHES) != (bwd_n, 0):
        fail(f"{name}: K4 bf16 launches {xa.BWD_BF16_LAUNCHES}, f32 "
             f"{xa.BWD_LAUNCHES}")
    for what, a, c, d, e in zip(("K4 dr", "K4 dW", "K4 db"), bk, bp, b32,
                                bd):
        worst = bf16_compare(what, a, c, d, e, worst)
    del fd, bd
    if bool(bk[0][mask == 0].any()):
        fail(f"{name}: masked rows contributed to dr in bf16")
    again = (*xa.xent_fwd_cuda(r, w, b, ids, tw, compute_dtype=bf),
             *xa.xent_bwd_cuda(*bargs, compute_dtype=bf))
    if not all(torch.equal(u, v) for u, v in zip((*fk, *bk), again)):
        fail(f"{name}: two bf16 calls of K3/K4 differ")
    del again
    if not timed:
        return worst, None
    rec = {}
    for key, kfn, pfn, products in (
            ("K3", lambda: xa.xent_fwd_cuda(r, w, b, ids, tw,
                                            compute_dtype=bf),
             lambda: xa.xent_fwd_plain(r, w, b, ids, tw, compute_dtype=bf),
             1),
            ("K4", lambda: xa.xent_bwd_cuda(*bargs, compute_dtype=bf),
             lambda: xa.xent_bwd_plain(*bargs, compute_dtype=bf), 3)):
        k_ms = cuda_ms(kfn)
        p_ms = cuda_ms(pfn)
        # the compulsory bytes are k3_bound's / k4_bound's: the bf16
        # kernels read and write the f32 tensors the f32 ones do
        nbytes = 4.0 * ((N * R + K * R + K + 2 * N * Km + 4 * N)
                        if key == "K3" else
                        (2 * N * R + 2 * K * R + 2 * K + 2 * N * Km
                         + 3 * N))
        bnd = bf16_bound(products * 2.0 * N * K * R, nbytes)
        log(f"  [{name}] {key} bf16: kernel {k_ms:.3f} ms, plain "
            f"{p_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}; "
            f"{products} x 2NKR at {PEAK_BF16_FLOPS / 1e12:g} TFLOP/s); "
            f"library: n/a")
        rec[key] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
                    "bound_by": bnd[1]}
    r16, w16 = r.to(bf), w.to(bf)
    dz16 = torch.randn(N, K, device="cuda", dtype=bf)
    ctx = {"r @ W.T": cuda_ms(lambda: r16 @ w16.T),
           "dz @ W": cuda_ms(lambda: dz16 @ w16),
           "dz.T @ r": cuda_ms(lambda: dz16.T @ r16)}
    log(f"  [{name}] context (cuBLAS bf16, not used by the port): " +
        ", ".join(f"{k} {v:.3f} ms" for k, v in ctx.items()))
    rec["K3"]["cublas_bf16_products_ms"] = {"r @ W.T": ctx["r @ W.T"]}
    rec["K4"]["cublas_bf16_products_ms"] = ctx
    del dz16
    return worst, rec


def phase_tc_sums() -> None:
    """Phase 3e: the tensor core's bf16 sums against their model
    (ops/tc_sum.py). find_params settles each instruction's block,
    align_bits and rounding on the card from crafted vectors (Fasi et
    al.), which must be the constants the mirrors use; then tc_dot must
    equal probe_mma (a zero and a chained accumulator) and probe_wgmma
    (chains of 1, 4 and 64) bit for bit on TC_DOTS random dot products
    each, half with weights in +-0.04 and half in +-0.3 against
    activations as phase 3d makes them. Fails on any bit that differs,
    after printing the count and the largest ulp gap."""
    import torch
    from kaldi_lstm_tpu_torch.ops import tc_sum as ts
    t0 = time.perf_counter()
    found = ts.find_params(device="cuda")
    consts = {"mma": ts.MMA_M16N8K16_BF16, "wgmma": ts.WGMMA_M64NNK16_BF16}
    for name, f in found.items():
        params = {k: f[k] for k in ("block", "align_bits", "rounding")}
        log(f"  {name} (bf16 -> f32): block {f['block']}, align_bits "
            f"{f['align_bits']}, rounding {f['rounding']}; the model with "
            f"them: {f['conventions']} of the conventions' vectors and "
            f"{f['random'][0]} random entries differ")
        for q, ans in f["seen"].items():
            log(f"    {q}: {ans}")
        if params != consts[name]:
            fail(f"{name}: the card's parameters {params} are not the "
                 f"model's constants {consts[name]}")
        if f["conventions"] or f["random"][0]:
            fail(f"{name}: the model with the found parameters differs "
                 f"from the card")
    gen = torch.Generator().manual_seed(2021)
    for what, shape, depth, with_c in (
            ("mma.sync m16n8k16, zero accumulator", ts.MMA_SHAPE, 1, False),
            ("mma.sync m16n8k16, chained accumulator", ts.MMA_SHAPE, 1,
             True),
            ("wgmma m64n128k16, chain of 1", ts.WGMMA_SHAPE, 1, False),
            ("wgmma m64n128k16, chain of 4", ts.WGMMA_SHAPE, 4, False),
            ("wgmma m64n128k16, chain of 64", ts.WGMMA_SHAPE, 64, False)):
        mma = shape == ts.MMA_SHAPE
        probe = ts.probe_mma if mma else ts.probe_wgmma
        params = consts["mma" if mma else "wgmma"]
        count = TC_DOTS // 2 // (shape[0] * shape[1])
        bad, gap = 0, 0
        for w in (0.04, 0.3):
            b, g = ts.check(probe, shape, params, depth, count, w, with_c,
                            gen, "cuda")
            bad, gap = bad + b, max(gap, g)
        log(f"  {what}: {2 * count * shape[0] * shape[1]} dot products of "
            f"depth {16 * depth}, {bad} differ from the model "
            f"(largest gap {gap} ulps)")
        if bad:
            fail(f"{what}: the model differs from the card in {bad} dot "
                 f"products, by up to {gap} ulps")
    # what the cut toward zero costs a product as the kernels chain it:
    # x [256, 1024] (phase 3d's activations) against W [1024, 512]
    # (+-0.04), against the exact sum: every 16-deep slice from zero
    # (K5, K7), 64-deep stages (K1), the whole contraction in one chain
    # (K1's wgmma xw, K3, K4), and cuBLAS in f32 (the plain versions)
    wts, acts, _ = ts.operands(ts.MMA_SHAPE, 64, 32, 0.04, gen, "cuda",
                               False)
    x = acts.reshape(-1, 1024)[:256].float()
    wt = wts.reshape(-1, 1024)[:512].float().T
    exact = x.double() @ wt.double()
    scale = float(exact.pow(2).mean().sqrt())
    for what, got in (("16-deep slices from zero, f32 adds",
                       ts.tc_matmul(x, wt, 1)),
                      ("64-deep stages (4 chained), f32 adds",
                       ts.tc_matmul(x, wt, 4)),
                      ("one chain over K=1024", ts.tc_matmul(x, wt, None)),
                      ("cuBLAS f32", x @ wt)):
        err = got.double() - exact
        log(f"  [{what}] RMS error / RMS value "
            f"{float(err.pow(2).mean().sqrt()) / scale:.3e}, mean error "
            f"away from zero / RMS value "
            f"{float((err * exact.sign()).mean()) / scale:.3e}")
    log(f"  phase 3e: {time.perf_counter() - t0:.1f} s")


def phase_bf16_kernels():
    """K1-K5's bf16 variants vs their bf16 plain versions on the card.
    Returns {kernel: record} at the bf16 main path's shapes (the flagship
    training step; K5 at the cross-validation shape S=256, T=20)."""
    import torch
    from kaldi_lstm_tpu_torch.ops import lstm_infer as li
    from kaldi_lstm_tpu_torch.ops.lstm_cell import lstm_scan
    bf = torch.bfloat16
    S, T, I, C, R, K = TRAIN_S, TRAIN_T, 40, 800, 512, 8000
    recs, worst = {}, {k: 0.0 for k in ("K1", "K2", "K3", "K4", "K5")}
    log(f"  design: K1 rounds the gate-interleaved Wr, Wrm, Wx, x and r0 "
        f"once a call in one prologue launch and runs its products on "
        f"tc_gemm.cuh's bf16 tiles (Gemm16: bf16 staged in 64-deep stages, "
        f"mma.sync m16n8k16 bf16 with f32 accumulation; the hoisted xw on "
        f"Gemm16 or on wgmma fed by TMA, as fwd_plan picks), its gates "
        f"epilogue writing gifo in bf16, c in f32 and m in bf16 only, its "
        f"projection's r in f32 and the next step's bf16 copy; K3 "
        f"and K4 round r and W once a call into bf16 copies and run every "
        f"product on wgmma m64n128k16 fed by TMA (wg_gemm.cuh: 128 x 128 "
        f"tiles, 64-deep stages, persistent CTAs), K4 stores dz in bf16 "
        f"and sums db from the f32 dz by frame tile; K2 "
        f"runs on the bf16 tiles (Gemm16: each operand rounded once where "
        f"it is made, dm with the gate gradients, dr unsplit); K5 runs both "
        f"products on the bf16 tensor cores from bf16 weight slices and "
        f"bf16 staged rows (lstmp_infer_tc_kernel); each held to "
        f"max({BF16_SHARE:g} x the bf16-vs-f32 distance (RMS) of its plain "
        f"version, {BF16_NOISE:g} x that plain version's f32-vs-f64 noise)")
    for i, (name, dims, keep, dx, timed) in enumerate([
            ("flagship, main path (no dropout, no dx)", (S, T, I, C, R),
             None, False, True),
            ("deep layer 2, I=512, dx", (S, T, 512, C, R), None, True,
             "deep"),
            ("flagship, keep 0.8, dx", (S, T, I, C, R), 0.8, True, False),
            ("flagship width, T=2, keep 0.8, dx (no long recurrence)",
             (S, 2, I, C, R), 0.8, True, False),
            ("ragged S=3 T=2 I=37 C=200 R=130 (4-byte copies; a flip "
             "carried over T=20 would move a third of S=3's streams), keep "
             "0.8, dx", (3, 2, 37, 200, 130), 0.8, True, False),
            ("per-utterance S=1 T=64 (one stream in a row tile of 64; K1 "
             "also held step by step)", (1, 64, I, C, R), None, False,
             "s1")]):
        w, rec = lstm_train_bf16_case(name, *dims, keep, dx, 140 + i,
                                      timed=bool(timed),
                                      stepwise=timed == "s1")
        worst["K1"] = worst["K2"] = max(worst["K1"], w)
        if rec and timed is True:
            recs.update(rec)
        elif rec:
            tag = {"deep": "i512", "s1": "s1_t64"}[timed]
            for k in ("K1", "K2"):
                recs[k].update({f"{tag}_{f}": rec[k][f] for f in
                                ("ms", "plain_ms", "bound_ms")})
    for i, (name, dims, extra, timed) in enumerate([
            ("flagship, main path", (S * T, R, K, 1), {}, True),
            ("deep config K=16624", (S * T, R, DEEP_K, 1), {}, "deep"),
            ("ragged N=1001 R=136 K=1003 Km=2, half masked",
             (1001, 136, 1003, 2), {"mask_p": 0.5}, False),
            ("ragged N=1001 R=130 K=1000 Km=3 (4-byte copies)",
             (1001, 130, 1000, 3), {}, False)]):
        w, rec = xent_bf16_case(name, *dims, 160 + i, timed=bool(timed),
                                **extra)
        worst["K3"] = worst["K4"] = max(worst["K3"], w)
        if rec and timed is True:
            recs.update(rec)
        elif rec:
            for k in ("K3", "K4"):
                recs[k].update({f"k16624_{f}": rec[k][f] for f in
                                ("ms", "plain_ms", "bound_ms")})
    times = {}
    for i, (name, dims, resident, timed) in enumerate([
            ("S=8 T=1000 I=40 (serving shape)", (8, 1000, 40, 800, 512),
             True, True),
            ("S=256 T=20 I=40 (the cross-validation pass)",
             (256, 20, 40, 800, 512), True, True),
            ("S=8 T=1000 I=512", (8, 1000, 512, 800, 512), True, True),
            ("S=256 T=20 I=512", (256, 20, 512, 800, 512), True, True),
            ("S=8 T=16 I=1024 (f32 weights leave shared memory, bf16 stay)",
             (8, 16, 1024, 800, 512), True, False),
            ("S=8 T=16 I=2400 (bf16 weights leave shared memory)",
             (8, 16, 2400, 800, 512), False, False),
            ("S=256 T=2 I=40 (no long recurrence)", (256, 2, 40, 800, 512),
             True, False),
            ("ragged S=3 T=2 I=37 C=200 R=130 (4-byte copies)",
             (3, 2, 37, 200, 130), True, False)]):
        params, x, state = lstm_case(*dims, seed=180 + i)
        plan = li.device_plan(dims[0], *dims[2:], bf16=True)
        log(f"  [K5 bf16, {name}] plan {plan}")
        if plan != li.k5_bf16_plan(dims[0], *dims[2:], plan["sms"]):
            fail(f"K5 bf16 {name}: the card's plan differs from "
                 f"k5_bf16_plan's {li.k5_bf16_plan(dims[0], *dims[2:])}")
        if plan["smem"] > 232448:
            fail(f"K5 bf16 {name}: the plan takes {plan['smem']} bytes of "
                 f"shared memory")
        if plan["resident"] != int(resident):
            fail(f"K5 bf16 {name}: the plan does not keep the weights "
                 f"{'resident' if resident else 'in device memory'}")

        def kernel():
            return li.lstm_infer(params, x, state, 50.0, compute_dtype=bf)

        li.reset_counts()
        with torch.inference_mode():
            out_k, fin_k = kernel()
            out_p, fin_p = lstm_scan(params, x, state, 50.0,
                                     compute_dtype=bf)
            out_32, fin_32 = lstm_scan(params, x, state, 50.0)
            out_64, fin_64 = lstm_scan(*f64((params, x, state)), 50.0,
                                       compute_dtype=bf)
            torch.cuda.synchronize()
        if (li.BF16_LAUNCHES, li.LAUNCHES, li.PLAIN_CALLS) != (1, 0, 0):
            fail(f"K5 bf16 {name}: {li.BF16_LAUNCHES} bf16, {li.LAUNCHES} "
                 f"f32 launches, {li.PLAIN_CALLS} plain calls")
        # the tc-exact mirror walks the plan CTA by CTA and step by step
        # (minutes at S=256, T=20): the cases of at most 512
        # stream-steps here, the CV shape in tests/test_torch_bf16_tc.py's
        # gpu tests
        tc = (None, None)
        if dims[0] * dims[1] <= 512:
            with torch.inference_mode():
                r_tc, c_tc = li.lstm_infer_tc_plain(
                    params, x.transpose(0, 1).contiguous(), state.c,
                    state.r, 50.0, sms=plan["sms"], tc=True)
            tc = (r_tc.transpose(0, 1), c_tc)
        else:
            log(f"    K5 bf16 {name}: no tc-exact mirror at S={dims[0]}, "
                f"T={dims[1]}")
        for what, a, b, c, d, m in (
                ("r", out_k, out_p, out_32, out_64, tc[0]),
                ("final c", fin_k.c, fin_p.c, fin_32.c, fin_64.c, tc[1])):
            worst["K5"] = bf16_compare(f"K5 {what}", a, b, c, d,
                                       worst["K5"], tc=m)
        if not timed:
            continue
        with torch.inference_mode():
            k_ms = cuda_ms(kernel)
            p_ms = cuda_ms(lambda: lstm_scan(params, x, state, 50.0,
                                             compute_dtype=bf), reps=3)
        Sx, Tx, Ix, Cx, Rx = dims
        f32b = lstm_bound_ms(*dims)
        ops = 2.0 * Tx * Sx * (4 * Cx * (Ix + Rx) + Cx * Rx)
        nbytes = 4.0 * (Tx * Sx * Ix + (Ix + Rx) * 4 * Cx + 7 * Cx
                        + Cx * Rx + Sx * Cx + Sx * Rx + Tx * Sx * Rx
                        + Sx * Cx)
        bnd = bf16_bound(ops, nbytes)
        log(f"  [K5 bf16, {name}] kernel {k_ms:.3f} ms, plain {p_ms:.3f} "
            f"ms, bound {bnd[0]:.4f} ms ({bnd[1]}; the products at "
            f"{PEAK_BF16_FLOPS / 1e12:g} TFLOP/s; the f32 CUDA-core bound "
            f"{f32b[0]:.4f} ms); library: n/a")
        times[dims] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
                       "bound_by": bnd[1]}
    # the masked bf16 entry point: the kernel's precision template gives
    # the advance mask to both entry points
    dims = (64, 20, 40, 800, 512)
    params, x, state = lstm_case(*dims, seed=190)
    mask = torch.tensor(ragged_mask(64, 20, 191, True), device="cuda")
    valid = mask.bool()
    li.reset_counts()
    with torch.inference_mode():
        out_k, fin_k = li.lstm_infer(params, x, state, 50.0,
                                     compute_dtype=bf, advance_mask=mask)
        out_p, fin_p = lstm_scan(params, x, state, 50.0, compute_dtype=bf,
                                 advance_mask=mask)
        out_32, fin_32 = lstm_scan(params, x, state, 50.0,
                                   advance_mask=mask)
        out_64, fin_64 = lstm_scan(*f64((params, x, state)), 50.0,
                                   compute_dtype=bf,
                                   advance_mask=mask.double())
        torch.cuda.synchronize()
    if (li.MASKED_BF16_LAUNCHES, li.BF16_LAUNCHES, li.MASKED_LAUNCHES,
            li.PLAIN_CALLS) != (1, 0, 0, 0):
        fail("K5 bf16 masked: not one launch of lstmp_infer_masked_bf16")
    log("  [K5 bf16, masked S=64 T=20 I=40, ragged lengths and a skipped "
        "middle frame]")
    for what, a, b, c, d in (
            ("r (valid rows)", out_k[valid], out_p[valid], out_32[valid],
             out_64[valid]),
            ("final c", fin_k.c, fin_p.c, fin_32.c, fin_64.c)):
        worst["K5"] = bf16_compare(f"K5 masked {what}", a, b, c, d,
                                   worst["K5"])
    rec = dict(times[(256, 20, 40, 800, 512)])
    for dims, tag in (((8, 1000, 40, 800, 512), "s8_t1000"),
                      ((8, 1000, 512, 800, 512), "s8_t1000_i512"),
                      ((256, 20, 512, 800, 512), "s256_t20_i512")):
        rec.update({f"{tag}_{k}": v for k, v in times[dims].items()
                    if k != "bound_by"})
    recs["K5"] = rec
    for k in recs:
        recs[k]["max_abs_err"] = worst[k]
    return recs


def phase_stack_bf16():
    """K6/K7's bf16 entry points vs their bf16 plain versions on the card
    (the phase's bf16 rule, bf16_compare), their launch counts, then
    their times against K1 x 2 and K5 x 2 in bf16. Returns {"K6": record,
    "K7": record}."""
    import torch
    from kaldi_lstm_tpu_torch.ops import lstm_stack as ls
    bf = torch.bfloat16
    worst = {"K6": 0.0, "K7": 0.0}
    for i, (name, dims, tbs, clip, extra) in enumerate([
            ("deep, full width", (512, 20, 40, 800, 512), STACK_TBS, 50.0,
             {}),
            ("serving S=8 T=1000 (K7)", (8, 1000, 40, 800, 512), (5,),
             50.0, {}),
            ("ragged S=3 T=2 I=37 C=200 R=130 (4-byte copies), clip "
             "active", (3, 2, 37, 200, 130), (1, 2), 1.0,
             {"x_scale": 20.0, "param_scale": 0.2}),
            ("S=200 T=10, K7 bf16 staging 13 tiles of 16 streams a step",
             (200, 10, 40, 800, 512), (5, 2), 50.0, {}),
            # ROADMAP C.4's regime: weights wide enough to saturate the
            # gates, the clip engaged, so the bf16-vs-f32 distance is small
            ("C.4 regime S=8 T=4 I=40, weights +-0.3, clip 0.4",
             (8, 4, 40, 800, 512), (2,), 0.4, {"param_scale": 0.3}),
            ("C.4 regime S=8 T=4 I=1024 (xw1 on wgmma), weights +-0.04, "
             "clip 0.4", (8, 4, 1024, 800, 512), (2,), 0.4, {}),
            ("C.4 regime S=8 T=4 I=1024, weights +-0.3, clip 0.4",
             (8, 4, 1024, 800, 512), (2,), 0.4, {"param_scale": 0.3})]):
        args = stack_case(*dims, seed=170 + i, **extra)
        T = dims[1]
        k7_plan = ls.infer2_plan(dims[0], *dims[2:], bf16=True)
        if k7_plan != ls.k7_bf16_plan(dims[0], *dims[2:],
                                      k7_plan["sms"]):
            fail(f"K7 bf16's plan on the card {k7_plan} is not its "
                 f"mirror's")
        k6_plan = ls.fwd2_plan(dims[0], dims[3], sms=k7_plan["sms"],
                               bf16=True, T=T, I=dims[2], R=dims[4],
                               tb=tbs[0])
        log(f"  [K6/K7 bf16, {name}] tb {tbs}; K6 bf16 plan at tb"
            f"{tbs[0]} {k6_plan}; K7 bf16 plan {k7_plan}")
        with torch.inference_mode():
            k6 = T <= 20
            if k6:
                want = ls.lstm_stack_fwd2_plain(*args, clip, compute_dtype=bf)
                want32 = ls.lstm_stack_fwd2_plain(*args, clip)
                want64 = ls.lstm_stack_fwd2_plain(*f64(args), clip,
                                                  compute_dtype=bf)
                want_tc = ls.lstm_stack_fwd2_tc_plain(*args, clip, tc=True)
            ref = ls.lstm_stack_infer2_plain(*args, clip, compute_dtype=bf)
            ref32 = ls.lstm_stack_infer2_plain(*args, clip)
            ref64 = ls.lstm_stack_infer2_plain(*f64(args), clip,
                                               compute_dtype=bf)
            # K7's tc-exact mirror walks its plan CTA by CTA and step by
            # step: the small cases only
            ref_tc = None
            if dims[0] <= 8 and T <= 20:
                ref_tc = ls.lstm_stack_infer2_tc_plain(
                    *args, clip, sms=k7_plan["sms"], tc=True)
            else:
                log(f"    K7 bf16 {name}: no tc-exact mirror at S="
                    f"{dims[0]}, T={T}")
            for tb in tbs:
                if k6:
                    got = stack_counted(
                        f"K6 bf16 {name} tb{tb}",
                        lambda: ls.lstm_stack_fwd2_cuda(
                            *args, clip, tb=tb, compute_dtype=bf),
                        "lstmp_stack_fwd2_bf16", ls.wavefront_launches(T, tb))
                    if got[0].dtype != bf or got[3].dtype != bf:
                        fail("K6 bf16 did not write gifo in bf16")
                    for what, a, b, c, d, m in zip(
                            ("gifo1", "c1", "r1", "gifo2", "c2", "r2"), got,
                            want, want32, want64, want_tc):
                        worst["K6"] = bf16_compare(f"K6 tb{tb} {what}", a,
                                                   b, c, d, worst["K6"],
                                                   tc=m)
                r2, f1, f2 = stack_counted(
                    f"K7 bf16 {name} tb{tb}",
                    lambda: ls.lstm_stack_infer2_cuda(
                        *args, clip, tb=tb, compute_dtype=bf),
                    "lstmp_stack_infer2_bf16",
                    ls.wavefront_launches(T, tb, kernel="infer2"))
                for what, a, pick in (("r2", r2, lambda o: o[0]),
                                      ("c1T", f1.c, lambda o: o[1].c),
                                      ("r1T", f1.r, lambda o: o[1].r),
                                      ("c2T", f2.c, lambda o: o[2].c)):
                    worst["K7"] = bf16_compare(
                        f"K7 tb{tb} {what}", a, pick(ref), pick(ref32),
                        pick(ref64), worst["K7"],
                        tc=None if ref_tc is None else pick(ref_tc))
        log("    launch counts met for every call above "
            "(wavefront_launches; no other kernel, no plain call)")
    return stack_timings(bf, worst)


def stack_case(S, T, I, C, R, seed, param_scale=0.04, x_scale=1.0,
               device="cuda"):
    """Two stack-compatible layers, x [T, S, I] and nonzero initial
    states of both, from one seed."""
    import torch
    from kaldi_lstm_tpu_torch.ops.lstm_cell import (
        LstmState,
        init_lstm_params,
    )
    g = torch.Generator().manual_seed(seed)
    p1 = init_lstm_params(g, I, C, R, param_scale, device=device)
    p2 = init_lstm_params(g, R, C, R, param_scale, device=device)
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(T, S, I).astype(np.float32) * x_scale,
                     device=device)
    st = [torch.tensor(rng.randn(S, d).astype(np.float32) * 0.5,
                       device=device) for d in (C, R, C, R)]
    return p1, p2, x, LstmState(st[0], st[1]), LstmState(st[2], st[3])


def stack_bounds(T, S, I, C, R, train: bool, bf16: bool = False) -> dict:
    """Least times of K6 (train) or K7 on this card, each the larger of
    the operations and the compulsory bytes (each input read once, each
    output written once: K6 both layers' residuals, gifo in bf16 under
    bf16; K7 r2 and the final c1, r1, c2): the operations of both layers'
    products on the f32 CUDA cores (67 TFLOP/s), as 3xTF32 (3 passes at
    495 TFLOP/s) and in bf16 (989 TFLOP/s). Returns {unit: (ms, by)}."""
    ops = 2.0 * T * S * ((4 * C * (I + R) + C * R) + (4 * C * 2 * R + C * R))
    n_in = (T * S * I + (I + R) * 4 * C + 2 * R * 4 * C
            + 2 * (7 * C + C * R) + 2 * S * (C + R))
    if train:
        nbytes = 4.0 * (n_in + 2 * T * S * (C + R)) \
            + (2.0 if bf16 else 4.0) * 2 * T * S * 4 * C
    else:
        nbytes = 4.0 * (n_in + T * S * R + S * (2 * C + R))
    t_bytes = nbytes / PEAK_BYTES_PER_S
    out = {}
    for unit, t_ops in (("f32", ops / PEAK_F32_FLOPS),
                        ("3xtf32", 3 * ops / PEAK_TF32_FLOPS),
                        ("bf16", ops / PEAK_BF16_FLOPS)):
        out[unit] = (1e3 * max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def bounds_text(b: dict, own: str) -> str:
    """The bound in the design's own unit first, the others beside it."""
    names = {"f32": "f32 CUDA-core", "3xtf32": "3xTF32", "bf16": "bf16"}
    rest = ", ".join(f"{names[u]} {b[u][0]:.4f}" for u in b if u != own)
    return (f"bound {b[own][0]:.4f} ms ({names[own]}, {b[own][1]}; {rest} "
            f"ms)")


def turns_ms(fns: dict, reps: int = 5) -> dict:
    """CUDA-event times of each fn() taken in turns (a, b, a, b, ...)
    after one warm-up call each: {name: median ms of reps}."""
    import torch
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times[k].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in times.items()}


def stack_counted(what, fn, key, predicted):
    """fn() with every kernel count zeroed just before and read just
    after; fail unless the count `key` equals `predicted` and no other
    kernel and no plain version ran. Returns fn's result."""
    import torch
    from kaldi_lstm_tpu_torch.ops import counts
    counts.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in counts.launch_counts().items() if v}
    if got != {key: predicted}:
        fail(f"{what}: counts {got}, predicted {{{key!r}: {predicted}}}")
    return out


STACK_TBS = (5, 4, 2, 1)
STACK_TIMED_S = (64, 256, 512)


def stack_timings(cd, worst_recs: dict) -> dict:
    """K6 at S=64, 256, 512 (T=20, every tb) against K1 x 2, K7 at S=512,
    T=20 and S=8, T=1000 against K5 x 2, in the precision `cd`, each
    kernel and its serial schedule in turns (CUDA events, median of 5);
    the plain versions timed apart. Returns {"K6": record, "K7": record}
    with the S=512 (K6: best tb) and S=8, T=1000 (K7) times first."""
    import torch
    from kaldi_lstm_tpu_torch.ops import lstm_infer as li
    from kaldi_lstm_tpu_torch.ops import lstm_stack as ls
    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    tag = "bf16" if cd is not None else "f32"
    I, C, R, clip = 40, 800, 512, 50.0
    recs = {"K6": {}, "K7": {}}
    for S in STACK_TIMED_S:
        args = stack_case(S, 20, I, C, R, seed=300 + S)
        p1, p2, x, s1, s2 = args
        fns = {f"tb{tb}": (lambda tb=tb: ls.lstm_stack_fwd2_cuda(
            *args, clip, tb=tb, compute_dtype=cd)) for tb in STACK_TBS}
        fns["serial"] = lambda: lt.lstm_fwd_residuals_cuda(
            p2, lt.lstm_fwd_residuals_cuda(p1, x, s1.c, s1.r,
                                           cell_clip=clip,
                                           compute_dtype=cd)[2],
            s2.c, s2.r, cell_clip=clip, compute_dtype=cd)
        with torch.inference_mode():
            t = turns_ms(fns)
        best = min(STACK_TBS, key=lambda tb: t[f"tb{tb}"])
        b = stack_bounds(20, S, I, C, R, True, cd is not None)
        own = "bf16" if cd is not None else "3xtf32"
        log(f"  [K6 {tag} S={S} T=20] " + ", ".join(
            f"tb{tb} {t[f'tb{tb}']:.3f}" for tb in STACK_TBS)
            + f" ms; serial K1 x 2 {t['serial']:.3f} ms; best tb{best}: "
            f"the serial schedule takes {t['serial'] / t[f'tb{best}']:.3f}x "
            f"its time; {bounds_text(b, own)}")
        rec = {"ms": t[f"tb{best}"], "best_tb": best,
               "serial_ms": t["serial"], "bound_ms": b[own][0],
               "bound_by": b[own][1], "f32_bound_ms": b["f32"][0],
               "tf32x3_bound_ms": b["3xtf32"][0],
               "bf16_bound_ms": b["bf16"][0],
               **{f"tb{tb}_ms": t[f"tb{tb}"] for tb in STACK_TBS}}
        if cd is not None:
            # where K6 bf16's call goes: device ms a launch by kernel
            with torch.inference_mode():
                split = k1_launch_split(lambda: ls.lstm_stack_fwd2_cuda(
                    *args, clip, tb=best, compute_dtype=cd), 20,
                    kernels=K6_BF16_KERNELS)
            busy = sum(v["launches"] * v["ms_per_launch"]
                       for v in split.values() if v["launches"])
            log(f"  [K6 bf16 S={S} T=20 tb{best}] device ms a launch: "
                + ", ".join(f"{k} {v['ms_per_launch']:.4f} x "
                            f"{v['launches']:g}" for k, v in split.items()
                            if v["launches"])
                + f"; busy {busy:.3f} of {t[f'tb{best}']:.3f} ms")
            rec["split"] = split
            rec["busy_ms"] = busy
        if S == 512:
            with torch.inference_mode():
                rec["plain_ms"] = cuda_ms(lambda: ls.lstm_stack_fwd2_plain(
                    *args, clip, compute_dtype=cd), reps=3)
            log(f"  [K6 {tag} S=512 T=20] plain {rec['plain_ms']:.3f} ms; "
                f"library: n/a (no single PyTorch call computes a stacked "
                f"LSTMP with peepholes and the clip)")
            recs["K6"].update(rec)
        else:
            recs["K6"].update({f"s{S}_{k}": v for k, v in rec.items()})
    for S, T in ((8, 1000), (512, 20)):
        args = stack_case(S, T, I, C, R, seed=400 + S)
        p1, p2, x, s1, s2 = args
        fns = {"kernel": lambda: ls.lstm_stack_infer2_cuda(
            *args, clip, compute_dtype=cd),
            "serial": lambda: li.lstm_infer(
                p2, li.lstm_infer(p1, x, s1, clip, time_major=True,
                                  compute_dtype=cd)[0], s2, clip,
                time_major=True, compute_dtype=cd)}
        with torch.inference_mode():
            t = turns_ms(fns)
            p_ms = cuda_ms(lambda: ls.lstm_stack_infer2_plain(
                *args, clip, compute_dtype=cd), reps=3)
        b = stack_bounds(T, S, I, C, R, False)
        own = "bf16" if cd is not None else "f32"
        log(f"  [K7 {tag} S={S} T={T}] kernel {t['kernel']:.3f} ms, serial "
            f"K5 x 2 {t['serial']:.3f} ms (the serial schedule takes "
            f"{t['serial'] / t['kernel']:.3f}x the kernel's time), plain "
            f"{p_ms:.3f} ms; {bounds_text(b, own)}; {1e3 * t['kernel'] / (T + 1):.2f} "
            f"us a wavefront step; library: n/a")
        rec = {"ms": t["kernel"], "serial_ms": t["serial"], "plain_ms": p_ms,
               "bound_ms": b[own][0], "bound_by": b[own][1],
               "f32_bound_ms": b["f32"][0],
               "tf32x3_bound_ms": b["3xtf32"][0],
               "bf16_bound_ms": b["bf16"][0]}
        if S == 8:
            recs["K7"].update(rec)
        else:
            recs["K7"].update({f"s512_t20_{k}": v for k, v in rec.items()})
    for k in recs:
        recs[k]["max_abs_err"] = worst_recs[k]
    return recs


def phase_stack_kernels():
    """K6/K7 vs plain on the card with their launch counts, K6's
    residuals through K2, timings against the serial schedules, then the
    bench with the K6/K7 counts. Returns {"K6": record, "K7": record,
    "launches": {...}}."""
    import torch
    from kaldi_lstm_tpu_torch.ops import counts
    from kaldi_lstm_tpu_torch.ops import lstm_stack as ls
    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    from kaldi_lstm_tpu_torch.tools import bench_wavefront as bw

    log("  design: K6 runs K1's tensor-core tiles (3xTF32) over both layers "
        "(one gates and one projection launch a wavefront step, layer 2's "
        "input projection hoisted per time block); K7 is K5's persistent "
        "cooperative kernel over both layers (one launch a call)")
    worst = {"K6": 0.0, "K7": 0.0}
    cases = [
        # name, (S, T, I, C, R), time blocks, clip, extra, kernels
        ("deep, full width", (512, 20, 40, 800, 512), STACK_TBS, 50.0,
         {}, "K6 K7"),
        ("ragged S=3 I=37 C=200 R=130 T=23, clip active",
         (3, 23, 37, 200, 130), (1,), 1.0,
         {"x_scale": 20.0, "param_scale": 0.2}, "K6 K7"),
        ("serving S=8 T=1000", (8, 1000, 40, 800, 512), (5,), 50.0, {},
         "K7"),
    ]
    for i, (name, dims, tbs, clip, extra, which) in enumerate(cases):
        args = stack_case(*dims, seed=70 + i, **extra)
        T = dims[1]
        log(f"  [{name}] S={dims[0]} T={T} I={dims[2]} C={dims[3]} "
            f"R={dims[4]} clip {clip:g} tb {tbs}; K7 plan "
            f"{ls.infer2_plan(dims[0], *dims[2:])}")
        want_f = ls.lstm_stack_fwd2_plain(*args, clip) if "K6" in which \
            else None
        want_i = ls.lstm_stack_infer2_plain(*args, clip)
        if clip < 10 and not bool((want_f[1].abs() == clip).any()):
            fail(f"{name}: the clip never engaged")
        for tb in tbs:
            if want_f is not None:
                got = stack_counted(
                    f"K6 {name} tb{tb}",
                    lambda: ls.lstm_stack_fwd2_cuda(*args, clip, tb=tb),
                    "lstmp_stack_fwd2", ls.wavefront_launches(T, tb))
                for what, a, b in zip(("gifo1", "c1", "r1", "gifo2", "c2",
                                       "r2"), got, want_f):
                    worst["K6"] = compare(f"K6 tb{tb} {what}", a, b,
                                          worst["K6"])
            r2, f1, f2 = stack_counted(
                f"K7 {name} tb{tb}",
                lambda: ls.lstm_stack_infer2_cuda(*args, clip, tb=tb),
                "lstmp_stack_infer2",
                ls.wavefront_launches(T, tb, kernel="infer2"))
            for what, a, b in (("r2", r2, want_i[0]),
                               ("c1T", f1.c, want_i[1].c),
                               ("r1T", f1.r, want_i[1].r),
                               ("c2T", f2.c, want_i[2].c),
                               ("r2T", f2.r, want_i[2].r)):
                worst["K7"] = compare(f"K7 tb{tb} {what}", a, b,
                                      worst["K7"])
        log(f"    launch counts met for every call above "
            f"(wavefront_launches; no other kernel, no plain call)")
        if i == 0:
            worst["K6"] = stack_residuals_through_k2(args, clip,
                                                     worst["K6"])
        if want_f is not None:
            for phases in ("l1", "l2"):
                got = stack_counted(
                    f"K6 {name} phases={phases}",
                    lambda: ls.lstm_stack_fwd2_cuda(
                        *args, clip, tb=tbs[0], phases=phases),
                    "lstmp_stack_fwd2",
                    ls.wavefront_launches(T, tbs[0], phases))
                want = ls.lstm_stack_fwd2_plain(*args, clip, phases=phases)
                live = range(3) if phases == "l1" else range(3, 6)
                for j in live:
                    worst["K6"] = compare(f"K6 {phases} output {j}", got[j],
                                          want[j], worst["K6"])
    recs = stack_timings(None, worst)

    G, reps = 8, 3
    calls = bw.calls_per_bench(G, reps)
    predicted = {}
    for suffix in ("", "_bf16"):
        predicted.update({
            f"lstmp_stack_fwd2{suffix}": calls * sum(
                ls.wavefront_launches(bw.T, tb) for tb in bw.FWD_TBS),
            f"lstmp_stack_infer2{suffix}": calls * sum(
                ls.wavefront_launches(bw.T, tb, kernel="infer2")
                for tb in bw.INFER_TBS),
            f"lstmp_train_fwd{suffix}": calls * 2 * lt.fwd_launches(bw.T),
            f"lstmp_infer{suffix}": calls * 2})
    counts.reset_counts()
    torch.cuda.synchronize()
    rc = bw.main(["512", str(G), str(reps), "ab"])
    torch.cuda.synchronize()
    launches = {k: v for k, v in counts.launch_counts().items()
                if k in predicted}
    others = {k: v for k, v in counts.launch_counts().items()
              if v and k not in predicted}
    if rc != 0:
        fail(f"bench_wavefront exited {rc}")
    for k in predicted:
        log(f"    bench {k}: launches {launches[k]} (predicted "
            f"{predicted[k]})")
    log(f"    other counts (plain-version calls included): {others}")
    if launches != predicted:
        fail("the bench did not launch K6/K7 (and K1/K5) as predicted")
    if others:
        fail("the bench ran another kernel or a plain version on the card")
    recs["launches"] = launches
    for mode in ("ablate", "profile"):
        if bw.main(["512", str(G), str(reps), mode]) != 0:
            fail(f"bench_wavefront {mode} failed")
    return recs


def stack_residuals_through_k2(args, clip, worst):
    """K6's residuals of each layer through K2 against K1's residuals of
    the same layer through K2 (layer 2 with dx, its x being r1)."""
    import torch
    from kaldi_lstm_tpu_torch.ops import lstm_stack as ls
    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    p1, p2, x, s1, s2 = args
    T, S = x.shape[:2]
    rng = np.random.RandomState(80)
    g_r = torch.tensor(rng.randn(T, S, p1.recur_dim).astype(np.float32),
                       device="cuda")
    gcT = torch.tensor(rng.randn(S, p1.cell_dim).astype(np.float32),
                       device="cuda")
    wave = ls.lstm_stack_fwd2_cuda(*args, clip, tb=5)
    k1a = lt.lstm_fwd_residuals_cuda(p1, x, s1.c, s1.r, cell_clip=clip)
    k1b = lt.lstm_fwd_residuals_cuda(p2, k1a[2], s2.c, s2.r, cell_clip=clip)
    log("    K6 residuals through K2 vs K1 residuals through K2 (K6 runs "
        "K1's tiles, so they may agree bit for bit; held at TRAIN_TOL):")
    same = all(bool(torch.equal(u, v)) for u, v in zip((*k1a, *k1b), wave))
    log(f"    K6's residuals bit-equal to K1 x 2's: {same}")
    for n, p, xw, xk, s, res_w, res_k, dx in (
            (1, p1, x, x, s1, wave[:3], k1a, False),
            (2, p2, wave[2], k1a[2], s2, wave[3:], k1b, True)):
        a = lt.lstm_bwd_cuda(p, xw, s.c, s.r, *res_w, None, 1.0, g_r, gcT,
                             dx)
        b = lt.lstm_bwd_cuda(p, xk, s.c, s.r, *res_k, None, 1.0, g_r, gcT,
                             dx)
        torch.cuda.synchronize()
        for f, u, v in zip(type(p)._fields, a[0], b[0]):
            worst = compare(f"layer {n} d{f}", u, v, worst)
        for f, u, v in zip(("dx", "dc0", "dr0"), a[1:], b[1:]):
            if v is not None:
                worst = compare(f"layer {n} {f}", u, v, worst)
    return worst


def write_train_corpus(work: str, label_stride: int = 200):
    """256 utterances of 100-300 frames x 40 dims (numpy seed 7) and
    1-best posteriors that depend on the frame (the index of its largest
    feature, times `label_stride`: classes below 8000 at 200, below 16624
    at 415), so one epoch can learn."""
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    rng = np.random.RandomState(7)
    feats = f"ark:{work}/train_feats.ark"
    post = f"ark:{work}/train_post.ark"
    with kio.MatrixWriter(feats) as fw, kio.PosteriorWriter(post) as pw:
        for i in range(256):
            x = rng.randn(int(rng.randint(100, 301)), 40).astype(np.float32)
            fw.write(f"utt{i:03d}", x)
            pw.write(f"utt{i:03d}",
                     [[(int(k) * label_stride, 1.0)] for k in x.argmax(1)])
    return feats, post


def phase_train(work: str) -> dict:
    """The training main path; returns the K1-K4 launch counts and, for
    phase 5b, the corpus, the model files and the statistics."""
    import torch
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.ops.lstm_train import (
        bwd_launches,
        fwd_launches,
    )
    from kaldi_lstm_tpu_torch.tools import train_lstm_streams
    from kaldi_lstm_tpu_torch.train.streams import StreamScheduler
    from kaldi_lstm_tpu_torch.train.trainer import (
        TrainOptions,
        make_train_step,
        place_batch,
    )
    from kaldi_lstm_tpu_torch.train.optim import init_momentum
    from kaldi_lstm_tpu_torch.utils.tree import tree_leaves

    feats, post = write_train_corpus(work)
    model_in = os.path.join(work, "flagship.init")
    model_out = os.path.join(work, "flagship.iter1")
    nnet, params = Nnet.init_from_proto(
        TRAIN_PROTO, torch.Generator().manual_seed(0), "cuda")
    nnet.write(model_in, params, binary=True)
    common = [f"--num-stream={TRAIN_S}", f"--batch-size={TRAIN_T}",
              "--targets-delay=0", "--device", "cuda"]

    cvs = []
    for _ in range(2):
        rc, cv = train_lstm_streams.run_main(
            [feats, post, model_in, "--cross-validate=true"] + common)
        if rc != 0:
            fail(f"cross-validation before training exited {rc}")
        cvs.append(cv)
    cv0 = cvs[0]
    log(f"  cross-validation twice on one model: AvgLoss "
        f"{cvs[0].avg_loss()!r} and {cvs[1].avg_loss()!r}")
    if cvs[0].avg_loss() != cvs[1].avg_loss():
        fail("two cross-validation runs of one model disagree (the kernels "
             "must sum in a fixed order)")

    sched = StreamScheduler(kio.SequentialMatrixReader(feats),
                            kio.RandomAccessPosteriorReader(post), 40,
                            TRAIN_S, TRAIN_T, 0)
    batches = list(sched)
    steps = len(batches)
    T = TRAIN_T
    predicted = {"lstmp_train_fwd": fwd_launches(T) * steps,
                 "lstmp_train_bwd": bwd_launches(T, False) * steps,
                 "xent_affine_fwd": 2 * steps,
                 "xent_affine_bwd": 3 * steps}

    res = {}

    def train():
        rc, res["stats"] = train_lstm_streams.run_main(
            [feats, post, model_in, model_out, f"--learn-rate={TRAIN_LR}",
             "--momentum=0.9"] + common)
        return rc

    launches, wall = counted(
        f"train_lstm_streams, {steps} steps of {TRAIN_S}x{T} (incl. model "
        f"read, ark I/O, CUDA warm-up)", predicted, train)
    stats = res["stats"]
    if not os.path.getsize(model_out) > 0:
        fail("no trained model was written")
    frames = stats.frames
    log(f"  epoch: {frames:.0f} frames in {wall:.3f} s -> "
        f"{frames / wall:.1f} frames/s, "
        f"{frames / FRAMES_PER_AUDIO_SECOND / wall:.2f} audio-s/s "
        f"(whole CLI run); {stats.report().splitlines()[0]}")

    rc, cv1 = train_lstm_streams.run_main(
        [feats, post, model_out, "--cross-validate=true"] + common)
    if rc != 0:
        fail(f"cross-validation after training exited {rc}")
    log(f"  cross-validation AvgLoss: before {cv0.avg_loss():.6f}, after "
        f"{cv1.avg_loss():.6f}")
    if not cv1.avg_loss() < cv0.avg_loss():
        fail("cross-validation AvgLoss did not fall after the epoch")

    # two steps on the card against the same two steps on the CPU path
    opts = TrainOptions(learn_rate=TRAIN_LR, momentum=0.9)
    res = {}
    for dev in ("cuda", "cpu"):
        nnet_d, params_d = Nnet.read(model_in, dev)
        step = make_train_step(nnet_d, opts, device=dev)
        opt, states = init_momentum(params_d), nnet_d.init_states(TRAIN_S,
                                                                  dev)
        lr = torch.tensor(TRAIN_LR, device=dev)
        auxs = []
        for b in batches[:2]:
            params_d, opt, states, aux = step(
                params_d, opt, states, (), *place_batch(b, dev), lr)
            auxs.append([float(a) for a in aux])
        res[dev] = (tree_leaves(params_d), auxs)
    worst = 0.0
    for a, b in zip(res["cuda"][0], res["cpu"][0]):
        d = (a.cpu() - b).abs()
        worst = max(worst, float(d.max()))
        if not bool((d <= STEP_ATOL + STEP_RTOL * b.abs()).all()):
            fail("two steps on the card disagree with the CPU path")
    for (xk, ek, ck, fk), (xc, ec, cc, fc) in zip(res["cuda"][1],
                                                  res["cpu"][1]):
        if not (abs(xk - xc) <= 1e-5 * abs(xc)
                and abs(ek - ec) <= 1e-5 * abs(ec)
                and fk == fc and abs(ck - cc) <= 2):
            fail(f"LossAux on the card {(xk, ek, ck, fk)} vs CPU "
                 f"{(xc, ec, cc, fc)}")
    log(f"  two steps card vs CPU path: params max_abs_err {worst:.3e} "
        f"(tol {STEP_ATOL:g} + {STEP_RTOL:g} x |p|); LossAux card "
        f"{res['cuda'][1]} vs CPU {res['cpu'][1]}")

    # steady state: warm steps on placed batches
    nnet_g, params_g = Nnet.read(model_in, "cuda")
    step = make_train_step(nnet_g, opts, device="cuda")
    opt, states = init_momentum(params_g), nnet_g.init_states(TRAIN_S,
                                                              "cuda")
    lr = torch.tensor(TRAIN_LR, device="cuda")
    placed = [place_batch(b, "cuda") for b in batches[:6]]

    def run_steps(group):
        nonlocal params_g, opt, states
        for p in group:
            params_g, opt, states, _ = step(params_g, opt, states, (), *p,
                                            lr)

    run_steps(placed[:1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps(placed[1:])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / (len(placed) - 1)
    valid = sum(float(b.mask.sum()) for b in batches[1:6]) / 5
    log(f"  steady training step: {1e3 * dt:.3f} ms per step of "
        f"{TRAIN_S}x{T} -> {TRAIN_S * T / dt:.1f} frames/s "
        f"({TRAIN_S * T / FRAMES_PER_AUDIO_SECOND / dt:.2f} audio-s/s) "
        f"with every slot counted, {valid / dt:.1f} valid frames/s")
    profile(lambda: run_steps(placed[:1]), "one training step")
    return {"launches": launches, "feats": feats, "post": post,
            "common": common, "model_in": model_in, "model_out": model_out,
            "stats": stats, "cv": cv1, "batches": batches,
            "predicted": predicted}


# kernel names of each counted entry point, as the profiler lists them:
# K1's projection is the only contract with both operands K-major; the
# bf16 K1's kernels are fwd16_*
KERNEL_NAMES = {
    "lstmp_train_fwd": ("interleave_gate_rows_kernel", "xw_tc_kernel",
                        "gates_tc_kernel",
                        "contract_tc_kernel<32, 32, true, true", "fwd16_"),
    "lstmp_train_bwd": ("bwd_cell_kernel", "col_reduce_kernel",
                        "reduce_parts_kernel", "contract_tc_kernel<",
                        "bwd16_prep_kernel",
                        "bwd16_dm_kernel", "bwd16_dr_kernel",
                        "contract16_kernel"),
    "xent_affine_fwd": ("xent_fwd_chunk_kernel", "xent_fwd_combine_kernel",
                        "xent16_fwd"),
    "xent_affine_bwd": ("xent_bwd_dz_kernel", "xent_bwd_dr_kernel",
                        "xent_bwd_dw_kernel", "xent16_bwd"),
    "lstmp_infer": ("lstmp_infer_kernel", "lstmp_infer_tc_kernel"),
}
GROUP = 4
BENCH_GROUPS = (1, 4, 16)
BENCH_STEPS = 32


def kernel_counts_in_trace(path: str, bf16: bool = False) -> dict:
    """Kernel events of a Chrome trace, counted by entry point (a name
    matches the first entry point whose key it contains; K1's keys come
    before K2's generic contract). A kernel templated on the f32
    precision tag carries tc::F32 in its name (csrc/precision.cuh) and
    counts under "<entry>"; the others (the gate interleave, the column
    and partial sums, K3's merge, and the bf16 kernels of K1-K5) count
    under the run's precision, "<entry>_bf16" with `bf16`."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {k + sfx: 0 for k in KERNEL_NAMES for sfx in ("", "_bf16")}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = e.get("name", "")
        for k, keys in KERNEL_NAMES.items():
            if any(key in name for key in keys):
                is16 = bf16 and "tc::F32" not in name
                out[k + ("_bf16" if is16 else "")] += 1
                break
    return out


def params_rel_diff(path_a: str, path_b: str) -> float:
    """Largest |a - b| / (1 + |b|) over the two model files' params."""
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.utils.tree import tree_leaves
    _, pa = Nnet.read(path_a, "cpu")
    _, pb = Nnet.read(path_b, "cpu")
    return max(float(((a - b).abs() / (1 + b.abs())).max())
               for a, b in zip(tree_leaves(pa), tree_leaves(pb)))


def grouped_bench(model: str, batches: list, group: int,
                  steps: int = BENCH_STEPS, bf16: bool = False,
                  rows: int = 0) -> dict:
    """`steps` warm steps of `group` per call (1 = the plain step), each
    call uploading its batches from host memory that was stacked and
    pinned before the timing (the epoch loop does that on its staging
    thread, for both paths); then the idle share of two calls from the
    profiler (with its top `rows` kernels). `bf16`: the net's matmul
    dtype is bfloat16 (--bf16 true)."""
    import torch
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.train.optim import init_momentum
    from kaldi_lstm_tpu_torch.train.trainer import (
        TrainOptions,
        _batch_arrays,
        _host_tensors,
        _stage_group,
        _to_device,
        make_grouped_train_step,
        make_train_step,
    )
    nnet, params = Nnet.read(model, "cuda")
    if bf16:
        nnet.set_matmul_dtype(torch.bfloat16)
    opts = TrainOptions(learn_rate=TRAIN_LR, momentum=0.9)
    S = batches[0].feats.shape[0]
    st = {"p": params, "o": init_momentum(params),
          "s": nnet.init_states(S, "cuda")}
    lr = torch.tensor(TRAIN_LR, device="cuda")
    n = len(batches)
    if group == 1:
        step = make_train_step(nnet, opts, device="cuda")
        hosts = [_host_tensors(_batch_arrays(b), True) for b in batches]

        def call(k):
            st["p"], st["o"], st["s"], _ = step(
                st["p"], st["o"], st["s"], (),
                *_to_device(hosts[k % n], "cuda"), lr)
        g = None
    else:
        g = make_grouped_train_step(nnet, opts, device="cuda", group=group)
        hosts = [_stage_group([batches[(k * group + i) % n]
                               for i in range(group)], True)
                 for k in range(max(2, steps // group))]

        def call(k):
            st["p"], st["o"], st["s"], _ = g(
                st["p"], st["o"], st["s"], (), *hosts[k % len(hosts)], lr)
    call(0)                      # warm-up (the eager group when grouped)
    call(1)                      # the capture and first replay
    torch.cuda.synchronize()
    calls_n = max(1, steps // group)
    t0 = time.perf_counter()
    for k in range(calls_n):
        call(k)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / (calls_n * group)
    prof = profile(lambda: [call(k) for k in range(2)],
                   f"two calls of group {group}{', bf16' if bf16 else ''} "
                   f"(steady)", rows=rows)
    valid = np.mean([float(b.mask.sum()) for b in batches])
    # each counted entry point's share of the kernels' busy time
    shares = None if prof is None else {
        k + ("_bf16" if bf16 else ""):
        entry_ms(prof["table"], k) / prof["busy_ms"] for k in KERNEL_NAMES}
    return {"ms": 1e3 * dt, "frames_s": S * TRAIN_T / dt,
            "valid_frames_s": valid / dt, "shares": shares,
            "idle": None if prof is None else prof["idle"],
            "capture_ms": None if g is None else g.capture_ms,
            "pool_mb": None if g is None else g.pool_bytes / 2**20}


def phase_grouped(work: str, p5: dict) -> None:
    """Phase 5b: the grouped training path (train_lstm_streams --step-group
    4) at the flagship's full width on phase 5's corpus and model."""
    import contextlib
    import io
    import torch
    from kaldi_lstm_tpu_torch.utils.timer import PROFILE
    from kaldi_lstm_tpu_torch.tools import train_lstm_streams
    feats, post, common = p5["feats"], p5["post"], p5["common"]
    steps = len(p5["batches"])
    full, tail = divmod(steps, GROUP)
    log(f"  prediction: {steps} steps at group {GROUP} = 1 eager warm-up "
        f"group (real steps of the epoch) + {full - 1} replays + a "
        f"{tail}-step plain tail, so the launch counts equal phase 5's "
        f"(steps x per-step, no extra warm-up launches); the same bytes "
        f"out; device busy time per step unchanged, idle share below "
        f"phase 5's")
    out_g = os.path.join(work, "flagship.iter1.grouped")
    prof_dir = os.path.join(work, "prof")
    res = {}

    def train():
        rc, res["stats"] = train_lstm_streams.run_main(
            [feats, post, p5["model_in"], out_g, f"--learn-rate={TRAIN_LR}",
             "--momentum=0.9", f"--step-group={GROUP}", "--profile-dir",
             prof_dir] + common)
        return rc

    counted(f"train_lstm_streams --step-group {GROUP} --profile-dir "
            f"({steps} steps)", p5["predicted"], train)
    # counted() zeroes the counters, step.replays with them
    replays = PROFILE.counters["step.replays"]
    if replays != full - 1:
        fail(f"grouped training replayed {replays} graphs, "
             f"not {full - 1}")
    traces = os.listdir(prof_dir) if os.path.isdir(prof_dir) else []
    if len(traces) != 1 or not traces[0].endswith(".pt.trace.json"):
        fail(f"--profile-dir wrote {traces}, not one trace file")
    in_trace = kernel_counts_in_trace(os.path.join(prof_dir, traces[0]))
    log(f"  --profile-dir wrote {traces[0]} "
        f"({os.path.getsize(os.path.join(prof_dir, traces[0]))} bytes); "
        f"its kernel events by entry point: {in_trace}")
    for k, v in p5["predicted"].items():
        if in_trace[k] != v:
            fail(f"the profiler saw {in_trace[k]} {k} kernels, the "
                 f"counters {v}")
    stats = res["stats"]
    with open(out_g, "rb") as f, open(p5["model_out"], "rb") as g:
        same = f.read() == g.read()
    if same:
        log("  grouped model file: byte-identical to phase 5's")
    else:
        diff = params_rel_diff(out_g, p5["model_out"])
        log(f"  grouped model file differs from phase 5's: largest "
            f"|a-b|/(1+|b|) {diff:.3e}; the replayed kernels are phase "
            f"5's, so any difference is in summation order")
        if diff > 1e-6:
            fail("the grouped epoch's model differs beyond 1e-6")
    log(f"  AvgLoss grouped {stats.avg_loss()!r} vs phase 5 "
        f"{p5['stats'].avg_loss()!r}; {stats.report().splitlines()[-1]}")
    if stats.report() != p5["stats"].report():
        fail("the grouped epoch's statistics differ from phase 5's")

    # the grouped CV pass (K5 and K3 in the graph) on phase 5's model
    def cv_run():
        rc, res["cv"] = train_lstm_streams.run_main(
            [feats, post, p5["model_out"], "--cross-validate=true",
             f"--step-group={GROUP}"] + common)
        return rc

    counted(f"train_lstm_streams --cross-validate=true --step-group {GROUP}",
            {"lstmp_infer": steps, "xent_affine_fwd": 2 * steps}, cv_run)
    replays = PROFILE.counters["step.replays"]
    if replays != full - 1:
        fail(f"the grouped CV pass replayed {replays} graphs, "
             f"not {full - 1}")
    log(f"  grouped CV AvgLoss {res['cv'].avg_loss()!r} vs phase 5 "
        f"{p5['cv'].avg_loss()!r}")
    if res["cv"].report() != p5["cv"].report():
        fail("the grouped CV pass differs from phase 5's")

    # --verbose 1: the three moment-dump blocks; --debug-dump: the
    # per-frame LSTM dumps of the first minibatch
    err = io.StringIO()
    dbg = os.path.join(work, "dbg")
    with contextlib.redirect_stderr(err):
        rc = train_lstm_streams.main(
            [feats, post, p5["model_in"], os.path.join(work, "v1.nnet"),
             f"--learn-rate={TRAIN_LR}", f"--step-group={GROUP}",
             "--verbose=1", "--debug-dump", dbg] + common)
    text = err.getvalue()
    blocks = ("### Forward propagation buffer content :",
              "w_gifo_x_corr_", "### Backward propagation buffer content :")
    if rc != 0 or not all(b in text for b in blocks):
        fail(f"--verbose 1 (rc {rc}) did not print the moment dumps")
    dumped = sorted(os.listdir(dbg)) if os.path.isdir(dbg) else []
    if dumped != ["layer1.<LstmProjectedStreams>.npz"] or \
            "backward-pass frame 0 (variant 1)" not in text:
        fail(f"--debug-dump wrote {dumped}")
    with np.load(os.path.join(dbg, dumped[0])) as z:
        shapes = {k: z[k].shape for k in ("y_c", "d_r", "grad_w_gifo_x")}
        if not all(np.isfinite(z[k]).all() for k in z.files):
            fail("--debug-dump wrote non-finite tensors")
    log(f"  --verbose 1 printed the three moment-dump blocks; --debug-dump "
        f"wrote {dumped[0]} {shapes}")
    for line in text.splitlines():
        if ("[output of AffineTransform]" in line
                or "[diff at input of LstmProjectedStreams]" in line):
            log(f"    {line.strip()}")



def phase_bf16_path(work: str, p5: dict) -> dict:
    """Phase 5c: `train_lstm_streams --bf16 true` on phase 5's corpus and
    model, an epoch and its cross-validation pass at --step-group 1, 4
    and 16 (the recipes' default), each with the counts zeroed just
    before and read just after; returns the group-1 run's counts."""
    import torch
    from kaldi_lstm_tpu_torch.utils.timer import PROFILE
    from kaldi_lstm_tpu_torch.ops.lstm_train import (
        bwd_launches,
        fwd_launches,
    )
    from kaldi_lstm_tpu_torch.ops.xent_affine import xent_launches
    from kaldi_lstm_tpu_torch.tools import train_lstm_streams
    feats, post, common = p5["feats"], p5["post"], p5["common"]
    steps = len(p5["batches"])
    T = TRAIN_T
    k3, k4 = xent_launches(bf16=True)
    train_pred = {"lstmp_train_fwd_bf16": fwd_launches(T) * steps,
                  "lstmp_train_bwd_bf16": bwd_launches(T, False, bf16=True)
                  * steps,
                  "xent_affine_fwd_bf16": k3 * steps,
                  "xent_affine_bwd_bf16": k4 * steps}
    predicted = dict(train_pred, lstmp_infer_bf16=steps)
    predicted["xent_affine_fwd_bf16"] += k3 * steps
    f32_keys = ("lstmp_train_fwd", "lstmp_train_bwd", "xent_affine_fwd",
                "xent_affine_bwd", "lstmp_infer")
    log(f"  prediction: the epoch's {steps} steps launch only the bf16 "
        f"entry points, as many launches as phase 5's f32 ones, and its "
        f"CV pass {steps} K5 and {k3 * steps} K3 bf16 launches; 0 f32 "
        f"launches of K1-K5 and 0 plain calls at every group; the grouped "
        f"models byte-identical to group 1's")
    runs = {}
    for group in BENCH_GROUPS:
        out = os.path.join(work, f"flagship.iter1.bf16.g{group}")
        prof_dir = os.path.join(work, f"prof_bf16_g{group}")
        res = {}

        def run():
            rc, res["train"] = train_lstm_streams.run_main(
                [feats, post, p5["model_in"], out,
                 f"--learn-rate={TRAIN_LR}", "--momentum=0.9", "--bf16",
                 "true", f"--step-group={group}", "--profile-dir",
                 prof_dir] + common)
            if rc != 0:
                return rc
            rc, res["cv"] = train_lstm_streams.run_main(
                [feats, post, out, "--cross-validate=true", "--bf16",
                 "true", f"--step-group={group}"] + common)
            return rc

        got, wall = counted(f"train_lstm_streams --bf16 true --step-group "
                            f"{group}: the epoch, then its CV pass",
                            predicted, run)
        f32 = {k: got[k] for k in f32_keys}
        log(f"    f32 launches of K1-K5: {f32}; graph replays "
            f"{got['step.replays']}")
        if any(f32.values()):
            fail(f"the bf16 run at group {group} launched f32 kernels")
        traces = os.listdir(prof_dir) if os.path.isdir(prof_dir) else []
        if len(traces) != 1:
            fail(f"--profile-dir wrote {traces}, not one trace file")
        in_trace = kernel_counts_in_trace(os.path.join(prof_dir, traces[0]),
                                          bf16=True)
        seen = {k: v for k, v in in_trace.items() if v}
        log(f"    the training epoch's trace, kernel events by entry "
            f"point: {seen}")
        for k, v in train_pred.items():
            if in_trace[k] != v:
                fail(f"the profiler saw {in_trace[k]} {k} kernels, the "
                     f"counters {v}")
        if any(in_trace[k] for k in f32_keys):
            fail(f"the bf16 epoch's trace holds f32 kernels: {seen}")
        cv = res["cv"].avg_loss()
        if not np.isfinite(cv):
            fail(f"the bf16 CV AvgLoss is {cv}")
        log(f"    {res['train'].report().splitlines()[0]}; CV AvgLoss "
            f"{cv!r} (f32, phase 5: {p5['cv'].avg_loss()!r})")
        runs[group] = (out, got, res)
    with open(runs[1][0], "rb") as f:
        base = f.read()
    with open(p5["model_out"], "rb") as f:
        if f.read() == base:
            fail("the bf16 model equals the f32 one byte for byte: bf16 "
                 "did not run")
    log(f"  bf16 vs f32 model (phase 5): largest |a-b|/(1+|b|) "
        f"{params_rel_diff(runs[1][0], p5['model_out']):.3e}")
    for group in BENCH_GROUPS[1:]:
        with open(runs[group][0], "rb") as f:
            if f.read() != base:
                fail(f"the bf16 model at group {group} differs from group "
                     f"1's: largest |a-b|/(1+|b|) "
                     f"{params_rel_diff(runs[group][0], runs[1][0]):.3e}")
        if runs[group][2]["cv"].report() != runs[1][2]["cv"].report():
            fail(f"the bf16 CV pass at group {group} differs from group "
                 f"1's")
    log(f"  bf16 models at group {', '.join(map(str, BENCH_GROUPS[1:]))}: "
        f"byte-identical to group 1's; CV reports identical")
    # steady time per step at group 1, 4 and 16, f32 and bf16 in turns
    for group in BENCH_GROUPS:
        for bf16 in (False, True):
            r = grouped_bench(p5["model_in"], p5["batches"], group,
                              bf16=bf16, rows=12 if group == 1 else 0)
            cap = ("" if r["capture_ms"] is None else
                   f", capture {r['capture_ms']:.1f} ms, pool "
                   f"{r['pool_mb']:.1f} MB")
            idle = "not measured" if r["idle"] is None \
                else f"{r['idle']:.3f}"
            log(f"  group {group:2d} {'bf16' if bf16 else 'f32 '}: "
                f"{r['ms']:.3f} ms per step of {TRAIN_S}x{TRAIN_T} over "
                f"{BENCH_STEPS} steps -> {r['frames_s']:.1f} frames/s "
                f"({r['valid_frames_s']:.1f} valid), idle share {idle}"
                f"{cap}")
            if r["shares"] is not None:
                log("    share of the kernels' busy time by entry point "
                    "(profiler): " + ", ".join(
                        f"{k} {v:.3f}" for k, v in r["shares"].items()))
    return runs[1][1]


def recipe_prediction(layers: int, steps: int) -> dict:
    """Launches of one newbob iteration from a fresh directory: a CV
    epoch, a training epoch and a CV epoch of `steps` steps each.
    Training step: K1 `fwd_launches` per layer, K2 `bwd_launches` per
    layer (with dx on every layer above the first), K3 2, K4 3; CV step:
    K5 1 per layer, K3 2."""
    from kaldi_lstm_tpu_torch.ops.lstm_train import (
        bwd_launches,
        fwd_launches,
    )
    T = TRAIN_T
    return {"lstmp_train_fwd": fwd_launches(T) * layers * steps,
            "lstmp_train_bwd": sum(bwd_launches(T, layer > 0)
                                   for layer in range(layers)) * steps,
            "xent_affine_fwd": 3 * 2 * steps,
            "xent_affine_bwd": 3 * steps,
            "lstmp_infer": 2 * layers * steps}


def counted(what: str, predicted: dict, fn) -> tuple[dict, float]:
    """Run fn() (it returns an exit code) with every kernel count zeroed
    just before and read just after; fail unless each predicted count
    is positive and met and no plain version ran. Returns (the counts,
    the wall seconds)."""
    import torch
    from kaldi_lstm_tpu_torch.ops.counts import reset_counts, snapshot_counts
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = snapshot_counts()
    plain = {k: v for k, v in got.items() if k.startswith("plain.")}
    if rc != 0:
        fail(f"{what} exited {rc}")
    log(f"  {what}: rc 0 in {wall:.3f} s")
    for k in predicted:
        log(f"    {k}: launches {got[k]} (predicted {predicted[k]})")
    log(f"    plain-version calls: {plain}")
    if any(got[k] != predicted[k] or got[k] <= 0 for k in predicted):
        fail(f"{what} did not launch the kernels as predicted")
    if any(plain.values()):
        fail(f"{what} took a plain version on the card")
    return got, wall


def phase_deep(work: str):
    """The deep path through the layer-stacking recipe, at full width."""
    import contextlib
    import io
    import json as _json
    import torch
    from kaldi_lstm_tpu_torch.decode.scoring import (
        AmScorer,
        log_priors_from_counts,
    )
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.tools import (
        nnet_copy,
        nnet_edit,
        nnet_forward,
        nnet_info,
        run_recipe,
        train_lstm_streams,
    )
    from kaldi_lstm_tpu_torch.train.optim import init_momentum
    from kaldi_lstm_tpu_torch.train.streams import StreamScheduler
    from kaldi_lstm_tpu_torch.train.trainer import (
        TrainOptions,
        make_train_step,
        place_batch,
    )
    from kaldi_lstm_tpu_torch.utils.tree import tree_leaves

    feats, post = write_train_corpus(work, label_stride=415)
    proto = os.path.join(work, "pre.proto")
    with open(proto, "w") as f:
        f.write(DEEP_PRE_PROTO)
    pre, stack, exp = (os.path.join(work, d) for d in ("pre", "stack", "exp"))
    common = ["--tr-feats", feats, "--tr-targets", post, "--cv-feats", feats,
              "--cv-targets", post, "--scheduler", "newbob",
              f"--learn-rate={TRAIN_LR}", "--momentum=0.9", "--max-iters=1",
              f"--num-stream={TRAIN_S}", f"--batch-size={TRAIN_T}",
              "--targets-delay=0", "--verbose=0", "--device=cuda"]

    def batches(S):
        return list(StreamScheduler(kio.SequentialMatrixReader(feats),
                                    kio.RandomAccessPosteriorReader(post),
                                    40, S, TRAIN_T, 0))
    steps = len(batches(TRAIN_S))
    log(f"  corpus: 256 utterances, {steps} steps of {TRAIN_S}x{TRAIN_T} "
        f"per epoch, targets in [0, {DEEP_K})")

    # 1. the one-layer net
    counted("run_recipe (one-layer net, 1 newbob iteration)",
            recipe_prediction(1, steps),
            lambda: run_recipe.main(common + ["--dir", pre, "--proto", proto,
                                              "--min-iters=1"]))
    # 2. stack a fresh LSTMP-2 and senone affine on the frozen trunk
    os.makedirs(stack)
    if nnet_edit.main([f"{pre}/final.nnet", f"{stack}/nnet.init",
                       "--remove-at", "2", "--insert-at", "2",
                       "--proto-line", DEEP_STACK_LINES,
                       "--set-learn-rate-coef", "1=0"]) != 0:
        fail("nnet_edit (stack) failed")
    counted("run_recipe (stacked net, frozen trunk)",
            recipe_prediction(2, steps),
            lambda: run_recipe.main(common + ["--dir", stack,
                                              "--min-iters=1"]))
    _, p0 = Nnet.read(f"{stack}/nnet.init")
    _, p1 = Nnet.read(f"{stack}/nnet/nnet.iter1")
    frozen = all(torch.equal(a, b) for a, b in zip(p0[1], p1[1]))
    moved = sum(not torch.equal(a, b) for a, b in zip(p0[2], p1[2]))
    log(f"  frozen trunk (LearnRateCoef 0) bit-identical after the "
        f"iteration: {frozen}; new LSTMP-2 tensors changed: {moved} of 7")
    if not frozen or moved == 0:
        fail("the frozen trunk changed, or the new layer did not train")
    # 3. unfreeze and fine-tune the whole stack
    os.makedirs(exp)
    if nnet_edit.main([f"{stack}/final.nnet", f"{exp}/nnet.init",
                       "--set-learn-rate-coef", "1=1"]) != 0:
        fail("nnet_edit (unfreeze) failed")
    rc, cv0 = train_lstm_streams.run_main(
        [feats, post, f"{exp}/nnet.init", "--cross-validate=true",
         f"--num-stream={TRAIN_S}", f"--batch-size={TRAIN_T}",
         "--targets-delay=0", "--device=cuda"])
    if rc != 0:
        fail("cross-validation before the fine-tune failed")
    counted("run_recipe (fine-tune of the whole stack)",
            recipe_prediction(2, steps),
            lambda: run_recipe.main(common + ["--dir", exp]))
    with open(f"{exp}/nnet/newbob.state") as f:
        st = _json.load(f)
    log(f"  fine-tune CV AvgLoss: before {cv0.avg_loss():.6f}, after "
        f"{st['loss']:.6f} ({os.path.basename(st['final'])} accepted)")
    if not (st["final"].endswith("nnet.iter1")
            and st["loss"] < cv0.avg_loss()):
        fail("cross-validation AvgLoss did not fall in the fine-tune")
    # 4. nnet_info
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = nnet_info.main([f"{exp}/final.nnet"])
    info = buf.getvalue()
    if rc != 0 or info.count("LstmProjectedStreams") != 2:
        fail("nnet_info did not print the deep net")
    for line in info.splitlines():
        if not line.startswith("  "):
            log(f"    {line}")
    # 5. convert and score with class counts
    std = os.path.join(work, "deep_std.nnet")
    if nnet_copy.main([f"{exp}/final.nnet", std, "--to-standard",
                       "--time-shift=5", "--device", "cuda"]) != 0:
        fail("nnet_copy --to-standard failed")
    rng = np.random.RandomState(9)
    utts = {f"utt{i:03d}": rng.randn(int(rng.randint(200, 1001)), 40)
            .astype(np.float32) for i in range(8)}
    feats_ark = os.path.join(work, "deep_feats.ark")
    with kio.MatrixWriter(f"ark:{feats_ark}") as w:
        for k, m in utts.items():
            w.write(k, m)
    counts = rng.randint(1, 1000, size=DEEP_K).astype(np.float32)
    counts_path = os.path.join(work, "deep_counts.vec")
    with open(counts_path, "wb") as f:
        kio.write_vector(kio.KaldiOutput(f), counts)
    out_ark = os.path.join(work, "deep_loglik.ark")
    counted("nnet_forward (deep standard net, 1 batch of 8: one K5 launch "
            "per layer)", {"lstmp_infer": 2},
            lambda: nnet_forward.main(
                [std, f"ark:{feats_ark}", f"ark:{out_ark}",
                 "--apply-log=true", "--class-frame-counts", counts_path,
                 "--device", "cuda"]))
    got = dict(kio.SequentialMatrixReader(f"ark:{out_ark}"))
    if list(got) != list(utts):
        fail("deep scoring: output keys differ")
    for k, y in got.items():
        if y.shape != (utts[k].shape[0], DEEP_K) or not np.isfinite(y).all():
            fail(f"deep scoring: {k} has shape {y.shape} or non-finite "
                 f"values")
    lp = log_priors_from_counts(counts)
    nnet_c, params_c = Nnet.read(std, "cpu")
    cpu = AmScorer(nnet_c, params_c, log_prior=lp, apply_log=True,
                   device="cpu")
    keys = list(utts)[:3]
    worst = max(float(np.abs(got[k] - y).max())
                for k, y in cpu.score_stream((k, utts[k]) for k in keys))
    log(f"  deep scores, card vs CPU path on 3 utterances: max_abs_err "
        f"{worst:.3e} (tol {SCORE_ATOL:g})")
    if worst > SCORE_ATOL:
        fail("deep card scores disagree with the CPU path")
    nnet_g, params_g = Nnet.read(std, "cuda")
    scorer = AmScorer(nnet_g, params_g, log_prior=lp, apply_log=True,
                      device="cuda")
    frames = sum(m.shape[0] for m in utts.values())
    for _ in scorer.score_stream(utts.items()):
        pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(1 for _ in scorer.score_stream(utts.items()))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"  steady deep scoring: {n} utterances, {frames} frames in "
        f"{dt:.3f} s -> {frames / dt:.1f} frames/s, "
        f"{frames / FRAMES_PER_AUDIO_SECOND / dt:.2f} audio-s/s")

    # 6. one deep step on the card against the same step on the CPU path
    opts = TrainOptions(learn_rate=TRAIN_LR, momentum=0.9)
    b0 = batches(DEEP_CHECK_S)[0]
    res = {}
    for dev in ("cuda", "cpu"):
        nnet_d, params_d = Nnet.read(f"{exp}/nnet.init", dev)
        step = make_train_step(nnet_d, opts, device=dev)
        params_d, _, _, aux = step(
            params_d, init_momentum(params_d),
            nnet_d.init_states(DEEP_CHECK_S, dev), (),
            *place_batch(b0, dev), torch.tensor(TRAIN_LR, device=dev))
        res[dev] = (tree_leaves(params_d), [float(a) for a in aux])
    worst = 0.0
    for a, b in zip(res["cuda"][0], res["cpu"][0]):
        d = (a.cpu() - b).abs()
        worst = max(worst, float(d.max()))
        if not bool((d <= STEP_ATOL + STEP_RTOL * b.abs()).all()):
            fail("the deep step on the card disagrees with the CPU path")
    (xk, ek, ck, fk), (xc, ec, cc, fc) = res["cuda"][1], res["cpu"][1]
    if not (abs(xk - xc) <= 1e-5 * abs(xc) and abs(ek - ec) <= 1e-5 * abs(ec)
            and fk == fc and abs(ck - cc) <= 2):
        fail(f"deep LossAux on the card {res['cuda'][1]} vs CPU "
             f"{res['cpu'][1]}")
    log(f"  one deep step ({DEEP_CHECK_S} streams) card vs CPU path: "
        f"params max_abs_err {worst:.3e} (tol {STEP_ATOL:g} + "
        f"{STEP_RTOL:g} x |p|); LossAux card {res['cuda'][1]} vs CPU "
        f"{res['cpu'][1]}")

    # 7. the warm deep step at S=256, and its profile
    nnet_g, params_g = Nnet.read(f"{exp}/nnet.init", "cuda")
    step = make_train_step(nnet_g, opts, device="cuda")
    opt, states = init_momentum(params_g), nnet_g.init_states(TRAIN_S, "cuda")
    lr = torch.tensor(TRAIN_LR, device="cuda")
    placed = [place_batch(b, "cuda") for b in batches(TRAIN_S)[:6]]

    def run_steps(group):
        nonlocal params_g, opt, states
        for p in group:
            params_g, opt, states, _ = step(params_g, opt, states, (), *p,
                                            lr)

    run_steps(placed[:1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps(placed[1:])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / (len(placed) - 1)
    log(f"  steady deep training step: {1e3 * dt:.3f} ms per step of "
        f"{TRAIN_S}x{TRAIN_T} -> {TRAIN_S * TRAIN_T / dt:.1f} frames/s "
        f"({TRAIN_S * TRAIN_T / FRAMES_PER_AUDIO_SECOND / dt:.2f} "
        f"audio-s/s) with every slot counted")
    profile(lambda: run_steps(placed[:1]), "one deep training step")

    # 8. the deep step grouped by GROUP (CUDA-graph replays)
    for bf16 in (False, True):
        r = grouped_bench(f"{exp}/nnet.init", batches(TRAIN_S), GROUP,
                          bf16=bf16)
        idle = "not measured" if r["idle"] is None else f"{r['idle']:.3f}"
        log(f"  deep step at group {GROUP}{', bf16' if bf16 else ''}: "
            f"{r['ms']:.3f} ms per step of {TRAIN_S}x{TRAIN_T} over "
            f"{BENCH_STEPS} steps -> {r['frames_s']:.1f} frames/s, idle "
            f"share {idle}, capture {r['capture_ms']:.1f} ms, pool "
            f"{r['pool_mb']:.1f} MB")


def rss_bytes() -> int:
    """This process's resident set now (/proc/self/statm)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class RssPeak:
    """Samples this process's resident set every 20 ms on a thread, from
    entry to exit: `.start` and `.peak` in bytes."""

    def __enter__(self):
        import threading
        self.start = self.peak = rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, rss_bytes())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())


def decode_pass(what: str, args, tm, graph, n_utts: int, frames: int,
                traced: bool = False) -> dict:
    """One fused decode, nnet_decode's body on a graph built once, with
    the K5 count zeroed just before and read just after (one launch per
    batch of 8 utterances, no plain call). Records each batch's CUDA
    events (input copy + forward on the compute stream; the score copy
    on the scorer's side stream) and whether its scores were on the host
    before the decoder asked for them, times each decoder call with its
    float64 conversion apart from the search, samples the resident set,
    and with `traced` takes the card's idle share from torch.profiler.
    Fails unless every copy whose next batch was queued in time overlaps
    that batch's compute and every batch after the first reached the host
    before the decoder asked for it. Returns the measurements."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    import kaldi_lstm_tpu_torch.tools.decode_faster as dft
    from kaldi_lstm_tpu_torch.decode.scoring import copy_overlaps
    from kaldi_lstm_tpu_torch.tools import nnet_decode

    scorer = nnet_decode.make_scorer(args)
    pend, queued, calls = [], [], []
    dispatch, forward = scorer._dispatch, scorer._forward

    def tracked(group):
        pend.append(dispatch(group))
        return pend[-1]

    def tracked_forward(x):
        # is batch k+1's forward queued while batch k's still runs?
        queued.append(bool(pend) and not pend[-1].ready.query())
        return forward(x)
    fetch, fetched = scorer._fetch, []

    def tracked_fetch(y):
        # was the batch's copy done before the decoder asked for it?
        hidden = y.done.query()
        t0 = time.perf_counter()
        out = fetch(y)
        fetched.append((hidden, 1e3 * (time.perf_counter() - t0)))
        return out
    scorer._dispatch, scorer._forward = tracked, tracked_forward
    scorer._fetch = tracked_fetch
    search = dft.decode_faster

    def timed(graph, mat, *rest):
        t0 = time.perf_counter()
        em = np.ascontiguousarray(mat, np.float64)
        t1 = time.perf_counter()
        res = search(graph, em, *rest)
        calls.append((t1 - t0, time.perf_counter() - t1))
        return res
    dft.decode_faster = timed
    prof = contextlib.nullcontext()
    if traced:
        prof = tprofile(activities=[ProfilerActivity.CUDA])
    try:
        with RssPeak() as rss, prof:
            _, wall = counted(
                what, {"lstmp_infer": -(-n_utts // 8)},
                lambda: nnet_decode.decode_stream(args, scorer, tm, graph))
    finally:
        dft.decode_faster = search
    audio_s = frames / FRAMES_PER_AUDIO_SECOND
    r = {"wall_s": wall, "audio_s_per_s": audio_s / wall,
         "rtf": wall / audio_s,
         "scoring_ms": sum(p.begin.elapsed_time(p.ready) for p in pend),
         "copy_ms": [p.start.elapsed_time(p.done) for p in pend],
         "copy_bytes": [sum(h.nbytes for h in p.host) for p in pend],
         "overlap": [copy_overlaps(pend[k], pend[k + 1])
                     for k in range(len(pend) - 1)],
         "queued": queued[1:],
         "hidden": [f[0] for f in fetched],
         "fetch_ms": [f[1] for f in fetched],
         "convert_ms": 1e3 * sum(c[0] for c in calls),
         "search_ms": 1e3 * sum(c[1] for c in calls),
         "rss_start": rss.start, "rss_peak": rss.peak}
    log(f"    {frames} frames ({audio_s:.2f} audio-s) in {wall:.3f} s: "
        f"{r['audio_s_per_s']:.2f} decoded audio-s/s, RTF {r['rtf']:.4f}")
    log(f"    card: scoring (input copy + forward, CUDA events) "
        f"{r['scoring_ms']:.3f} ms over {len(pend)} batches; score copy "
        f"{statistics.median(r['copy_ms']):.3f} ms and "
        f"{int(statistics.median(r['copy_bytes']))} bytes a batch (median; "
        f"{', '.join(f'{c:.3f}' for c in r['copy_ms'])} ms); batch k+1's "
        f"forward queued before batch k's ended: {r['queued']}; batch "
        f"k's copy ran while batch k+1's input copy and forward did: "
        f"{r['overlap']}")
    log(f"    scores on the host before the decoder asked for them: "
        f"{r['hidden']}; fetch (copy wait + host conversion) "
        f"{', '.join(f'{f:.3f}' for f in r['fetch_ms'])} ms a batch")
    if calls:
        log(f"    host: {len(calls)} decoder calls on "
            f"{args.num_threads} threads, search {r['search_ms']:.3f} ms "
            f"and float64 conversion {r['convert_ms']:.3f} ms summed over "
            f"the threads ({r['search_ms'] / 1e3 / audio_s:.4f} core-s of "
            f"search per audio-s)")
    log(f"    host RSS {rss.start / 2**30:.3f} GiB at the start, peak "
        f"{rss.peak / 2**30:.3f} GiB (+{(rss.peak - rss.start) / 2**20:.1f}"
        f" MiB)")
    if traced:
        busy, copies = profiled_busy_ms(prof)
        r["idle"] = None if busy <= 0 else max(0.0, 1 - busy / (1e3 * wall))
        log(f"    card idle share over the decode (torch.profiler, kernel "
            f"time {busy:.3f} ms of {1e3 * wall:.3f} ms wall; copies and "
            f"sets {copies:.3f} ms): "
            + ("not measured (no kernel time recorded)" if busy <= 0
               else f"{r['idle']:.4f}"))
    if not all(o for o, q in zip(r["overlap"], r["queued"]) if q) \
            or not all(r["hidden"][1:]):
        fail(f"{what}: a score copy whose next batch was queued in time did "
             f"not overlap it (queued {r['queued']}, overlapped "
             f"{r['overlap']}), or a batch after the first was not on the "
             f"host when the decoder asked for it ({r['hidden']})")
    return r


def phase_decode(work: str) -> dict:
    """Phase 7: the fused score->decode path (nnet_decode) at the LVCSR
    recipe's operating point; returns the K5 launches of the CLI run."""
    import argparse
    import itertools
    import torch
    from kaldi_lstm_tpu_torch.decode.faster import compile_graph, decode_faster
    from kaldi_lstm_tpu_torch.decode.wer import EditStats, edit_distance, \
        wer_report
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.io.lang import read_text_table
    from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.tools import (
        make_word_synth_data,
        nnet_copy,
        nnet_decode,
        nnet_forward,
        train_lstm_streams,
    )
    from kaldi_lstm_tpu_torch.tools.decode_faster import (
        decode_source,
        graph_from_args,
    )
    from kaldi_lstm_tpu_torch.tools.latgen_faster import latgen_source

    if os.environ.get("KLT_DECODE_IMPL", "auto") == "python":
        fail("KLT_DECODE_IMPL=python is set; phase 7 times the native core")
    n_all = DECODE_TRAIN_UTTS + DECODE_UTTS
    log(f"  cuts: 40-dim synthetic frames (the corpus generator's Gaussian "
        f"emissions), not fbank of rendered audio; {n_all} utterances "
        f"({DECODE_TRAIN_UTTS} to train, {DECODE_UTTS} to decode; the "
        f"recipe has 10240); the AM trained {DECODE_EPOCHS} epochs "
        f"(the recipe: newbob, 4-14); lattices on the first "
        f"{DECODE_LAT_UTTS} decoded utterances, the CPU decode on the first "
        f"{DECODE_CPU_UTTS}, the numpy decoder on the {DECODE_PY_UTTS} "
        f"shortest")
    lang = os.path.join(work, "lang")
    t0 = time.perf_counter()
    if make_word_synth_data.main(["--dir", lang, "--num-utts", str(n_all)]
                                 + LVCSR_CORPUS) != 0:
        fail("make_word_synth_data failed")
    log(f"  corpus (10k words, counted trigram, {LVCSR_PDFS} pdfs): "
        f"{time.perf_counter() - t0:.3f} s")

    with open(f"{lang}/feats.scp") as f:
        lines = f.read().splitlines()

    def scp(name, rows):
        path = os.path.join(work, name)
        with open(path, "w") as f:
            f.write("\n".join(rows) + "\n")
        return f"scp:{path}"
    train_keys = {ln.split()[0] for ln in lines[:DECODE_TRAIN_UTTS]}
    dec_lines = lines[DECODE_TRAIN_UTTS:]
    dec_keys = [ln.split()[0] for ln in dec_lines]
    train_scp = scp("train.scp", lines[:DECODE_TRAIN_UTTS])
    dec_scp = scp("decode.scp", dec_lines)
    lat_scp = scp("lattice.scp", dec_lines[:DECODE_LAT_UTTS])
    cpu_scp = scp("cpu.scp", dec_lines[:DECODE_CPU_UTTS])

    # 1-best pdf targets from ali.ark through the transition model; pdf
    # counts of the training part, each + 1, for the priors
    t0 = time.perf_counter()
    tm = TransitionModel.load(f"{lang}/final.mdl")
    counts = np.ones(tm.num_pdfs)
    lens = {}
    post = f"ark:{work}/post.ark"
    with kio.PosteriorWriter(post) as pw:
        for key, ali in kio.SequentialIntVectorReader(f"ark:{lang}/ali.ark"):
            pdf = tm.transition_ids_to_pdfs(ali)
            lens[key] = len(pdf)
            if key in train_keys:
                counts += np.bincount(pdf, minlength=tm.num_pdfs)
                pw.write(key, [[(int(p), 1.0)] for p in pdf])
    counts_path = os.path.join(work, "counts.vec")
    with open(counts_path, "wb") as f:
        kio.write_vector(kio.KaldiOutput(f), counts.astype(np.float32))
    frames = sum(lens[k] for k in dec_keys)
    log(f"  targets and priors: {time.perf_counter() - t0:.3f} s; "
        f"{sum(lens[k] for k in train_keys)} training frames, {frames} "
        f"frames to decode ({frames / FRAMES_PER_AUDIO_SECOND:.2f} "
        f"audio-s); pdfs never seen in training: "
        f"{int((counts == 1).sum())}")

    model = os.path.join(work, "am.iter0")
    nnet, params = Nnet.init_from_proto(
        LVCSR_PROTO, torch.Generator().manual_seed(0), "cuda")
    nnet.write(model, params, binary=True)
    for e in range(DECODE_EPOCHS):
        nxt = os.path.join(work, f"am.iter{e + 1}")
        t0 = time.perf_counter()
        rc, st = train_lstm_streams.run_main(
            [train_scp, post, model, nxt, f"--learn-rate={DECODE_LR}",
             "--num-stream=256", "--batch-size=20", "--grad-clip=50",
             f"--targets-delay={DECODE_DELAY}", "--bf16", "true",
             "--step-group", "16", "--device", "cuda"])
        if rc != 0:
            fail(f"training epoch {e + 1} exited {rc}")
        log(f"  AM epoch {e + 1} (train_lstm_streams --bf16 true "
            f"--step-group 16 --grad-clip 50): AvgLoss "
            f"{st.avg_loss():.4f}, frame accuracy "
            f"{100 * st.correct / st.frames:.2f}% in "
            f"{time.perf_counter() - t0:.3f} s")
        model = nxt
    final = os.path.join(work, "final.nnet")
    if nnet_copy.main(["--to-standard", f"--time-shift={DECODE_DELAY}",
                       model, final, "--device", "cuda"]) != 0:
        fail("nnet_copy --to-standard failed")

    base = [final, f"{lang}/final.mdl", f"{lang}/lexicon.txt",
            f"{lang}/lm.arpa"]
    common = ["--word-symbol-table", f"{lang}/words.txt", "--apply-log=true",
              f"--class-frame-counts={counts_path}", "--device", "cuda",
              *LVCSR_SEARCH]
    parser = nnet_decode.build_parser()

    def parse(feats, hyp, *extra):
        return parser.parse_args(base + [feats, f"ark,t:{work}/{hyp}"]
                                 + common + list(extra))

    def read(name):
        with open(os.path.join(work, name), "rb") as f:
            return f.read()

    def text(name):
        return read_text_table(os.path.join(work, name))

    args = parse(dec_scp, "hyp_dense.txt")
    rss0 = rss_bytes()
    t0 = time.perf_counter()
    tm_g, graph = graph_from_args(args)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    compile_graph(graph)
    csr_s = time.perf_counter() - t0
    rss1 = rss_bytes()
    log(f"  graph: {graph.num_states} states, {graph.num_arcs()} arcs; "
        f"built in {build_s:.3f} s, CSR compile {csr_s:.3f} s (one host "
        f"core); host RSS {rss0 / 2**30:.3f} -> {rss1 / 2**30:.3f} GiB")

    got, cli_wall = counted(
        f"nnet_decode, the CLI as a user runs it, on the first "
        f"{DECODE_LAT_UTTS} utterances (model read, graph build, scoring, "
        f"search)", {"lstmp_infer": -(-DECODE_LAT_UTTS // 8)},
        lambda: nnet_decode.main(base + [lat_scp, f"ark,t:{work}/hyp_cli.txt"]
                                 + common))
    launches = got["lstmp_infer"]

    log("  fused decode, dense f32 fetch (graph built once, traced):")
    dense = decode_pass("nnet_decode body, dense fetch", args, tm_g, graph,
                        DECODE_UTTS, frames, traced=True)
    n_cli = len(read("hyp_cli.txt").splitlines())
    if n_cli != DECODE_LAT_UTTS or read("hyp_cli.txt") != b"".join(
            read("hyp_dense.txt").splitlines(True)[:DECODE_LAT_UTTS]):
        fail("the fused decode on the prebuilt graph differs from the CLI's")
    log(f"  the CLI's {n_cli} transcripts: byte-identical to the fused "
        f"decode's on the prebuilt graph")
    n_batches = -(-DECODE_UTTS // 8)

    # two-stage on the card: nnet_forward -> ark -> the decoders' cores
    loglik = os.path.join(work, "loglik.ark")
    counted("nnet_forward (two-stage flow, stage 1)",
            {"lstmp_infer": n_batches},
            lambda: nnet_forward.main([final, dec_scp, f"ark:{loglik}",
                                       "--apply-log=true",
                                       f"--class-frame-counts={counts_path}",
                                       "--device", "cuda"]))
    t0 = time.perf_counter()
    if decode_source(tm_g, graph, kio.SequentialMatrixReader(f"ark:{loglik}"),
                     acoustic_scale=args.acoustic_scale, beam=args.beam,
                     max_active=args.max_active,
                     trans_wspecifier=f"ark,t:{work}/hyp_two.txt",
                     word_strings=True, num_threads=args.num_threads) != 0:
        fail("two-stage decode_faster failed")
    log(f"  two-stage decode_faster over the ark: "
        f"{time.perf_counter() - t0:.3f} s")
    if read("hyp_two.txt") != read("hyp_dense.txt"):
        fail("fused and two-stage transcripts differ")
    log("  fused and two-stage transcripts: byte-identical")

    lat_frames = sum(lens[k] for k in dec_keys[:DECODE_LAT_UTTS])
    lat_args = parse(lat_scp, "lhyp_fused.txt", "--lattice-wspecifier",
                     f"ark:{work}/lat_fused.ark", *LVCSR_LATTICE)
    log(f"  fused lattice generation ({DECODE_LAT_UTTS} utterances, "
        f"determinized):")
    decode_pass("nnet_decode body, --lattice-wspecifier", lat_args, tm_g,
                graph, DECODE_LAT_UTTS, lat_frames)
    two = argparse.Namespace(**vars(lat_args))
    two.lattice_wspecifier = f"ark:{work}/lat_two.ark"
    two.transcript_wspecifier = f"ark,t:{work}/lhyp_two.txt"
    t0 = time.perf_counter()
    if latgen_source(tm_g, graph, itertools.islice(
            kio.SequentialMatrixReader(f"ark:{loglik}"), DECODE_LAT_UTTS),
            two) != 0:
        fail("two-stage latgen_faster failed")
    log(f"  two-stage latgen_faster over the ark: "
        f"{time.perf_counter() - t0:.3f} s")
    if read("lat_two.ark") != read("lat_fused.ark") or \
            read("lhyp_two.txt") != read("lhyp_fused.txt"):
        fail("fused and two-stage lattices or their transcripts differ")
    log(f"  fused and two-stage lattices ({len(read('lat_two.ark'))} bytes) "
        f"and best paths: byte-identical")

    ref = text("hyp_dense.txt")
    corpus_text = read_text_table(f"{lang}/text")

    def wer(hyp) -> str:
        total = EditStats()
        for k in dec_keys:
            total.add(edit_distance(corpus_text[k], hyp[k]))
        ser = sum(corpus_text[k] != hyp[k] for k in dec_keys) / len(dec_keys)
        return f"{wer_report(total)}; %SER {100 * ser:.2f}"
    fetch = {}
    for tag, extra in (("top_p", ["--top-p", str(DECODE_TOP_P)]),
                       ("bf16", ["--fetch-dtype", "bf16"])):
        log(f"  fused decode, {' '.join(extra)}:")
        r = decode_pass(f"nnet_decode body, {' '.join(extra)}",
                        parse(dec_scp, f"hyp_{tag}.txt", *extra), tm_g,
                        graph, DECODE_UTTS, frames)
        hyp = text(f"hyp_{tag}.txt")
        r["same"] = sum(hyp[k] == ref[k] for k in dec_keys) / len(dec_keys)
        log(f"    copy {int(statistics.median(r['copy_bytes']))} bytes a "
            f"batch (dense {int(statistics.median(dense['copy_bytes']))}), "
            f"{statistics.median(r['copy_ms']):.3f} ms (dense "
            f"{statistics.median(dense['copy_ms']):.3f}); "
            f"{r['audio_s_per_s']:.2f} audio-s/s (dense "
            f"{dense['audio_s_per_s']:.2f}); transcripts equal to the "
            f"dense fetch's: {r['same']:.4f}; {wer(hyp)}")
        fetch[tag] = r

    # the card against the CPU (the port's plain path) on a few utterances
    cpu_args = parse(cpu_scp, "hyp_cpu.txt")
    cpu_args.device = "cpu"
    t0 = time.perf_counter()
    if nnet_decode.decode_stream(cpu_args, nnet_decode.make_scorer(cpu_args),
                                 tm_g, graph) != 0:
        fail("the --device cpu decode failed")
    hyp = text("hyp_cpu.txt")
    same_cpu = sum(hyp[k] == ref[k] for k in dec_keys[:DECODE_CPU_UTTS])
    log(f"  --device cpu on {DECODE_CPU_UTTS} utterances "
        f"({time.perf_counter() - t0:.3f} s): transcripts equal to the "
        f"card's {same_cpu}/{DECODE_CPU_UTTS} (not gated)")
    shortest = sorted(dec_keys, key=lens.get)[:DECODE_PY_UTTS]
    errs = ref_words = 0
    for key, mat in kio.SequentialMatrixReader(f"ark:{loglik}"):
        if key not in shortest:
            continue
        nat = decode_faster(graph, mat, args.acoustic_scale, args.beam,
                            args.max_active)
        os.environ["KLT_DECODE_IMPL"] = "python"
        try:
            t0 = time.perf_counter()
            py = decode_faster(graph, mat, args.acoustic_scale, args.beam,
                               args.max_active)
        finally:
            del os.environ["KLT_DECODE_IMPL"]
        e = edit_distance(nat.words, py.words)
        errs += e.errors
        ref_words += len(nat.words)
        log(f"    {key} ({mat.shape[0]} frames): numpy decoder "
            f"{time.perf_counter() - t0:.3f} s, words {py.words == nat.words}"
            f", score {py.score!r} vs native {nat.score!r}")
    log(f"  words of the numpy decoder (KLT_DECODE_IMPL=python) equal to "
        f"the native core's on the card's scores of the {DECODE_PY_UTTS} "
        f"shortest utterances: {1 - errs / max(ref_words, 1):.4f} (not "
        f"gated)")

    log(f"  WER of the trained AM against the corpus text (dense fetch, "
        f"{DECODE_UTTS} utterances, not gated): {wer(ref)}")
    return {"launches": launches, "dense": dense, "fetch": fetch,
            "cli_wall_s": cli_wall, "lang": lang, "final": final,
            "counts": counts_path, "graph": graph, "dec_lines": dec_lines,
            "lens": lens, "ref": ref}


# ---------------------------------------------------------------------------
# phase 8: streaming serving (online_serve_batch, online_serve_sticky,
# online_decode) in phase 7's work directory, on its AM and graph
# ---------------------------------------------------------------------------

class StreamTrace:
    """What the streaming classes record during one run: each tick's
    PendingFetch (CUDA events, pinned host copies), the host clock and
    the summed search seconds at each `score` call, the decoders in the
    order they finalized (with the rows each was fed), and the sticky
    server's frames per tick."""

    def __init__(self):
        self.pend, self.calls, self.finished, self.totals = [], [], [], []
        self.search_s = 0.0
        self.server = None


TRACE = StreamTrace()


@contextlib.contextmanager
def traced_stream():
    """Patch the streaming modules' scorer, decoder and server classes
    with recording subclasses for the length of the block; each block
    starts a fresh TRACE."""
    global TRACE
    from kaldi_lstm_tpu_torch.decode import online, serve
    from kaldi_lstm_tpu_torch.tools import online_serve_batch as osb
    from kaldi_lstm_tpu_torch.tools import online_serve_sticky as oss

    class TracedScorer(online.OnlineBatchScorer):
        def _dispatch(self, feats, lengths):
            y = super()._dispatch(feats, lengths)
            TRACE.pend.append(y)
            return y

        def score(self, feats, lengths=None):
            TRACE.calls.append((time.perf_counter(), TRACE.search_s))
            return super().score(feats, lengths)

    class RecordingDecoder(online.OnlineDecoder):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.rows = []

        def advance(self, loglik):
            # exactly what the search saw (every caller passes a fresh
            # array or a view of a fresh block, never rewritten)
            self.rows.append(loglik)
            t0 = time.perf_counter()
            super().advance(loglik)
            TRACE.search_s += time.perf_counter() - t0

        def finalize(self):
            self.result = super().finalize()
            self.bps = None   # as the callers drop a finished decoder
            TRACE.finished.append(self)
            return self.result

    class TracedServer(serve.StickySessionServer):
        def tick(self):
            n = super().tick()
            TRACE.totals.append(n)
            TRACE.server = self
            return n

    saved = [(online, "OnlineBatchScorer"), (online, "OnlineDecoder"),
             (serve, "OnlineBatchScorer"), (serve, "OnlineDecoder"),
             (osb, "OnlineBatchScorer"), (osb, "OnlineDecoder"),
             (oss, "StickySessionServer")]
    saved = [(m, n, getattr(m, n)) for m, n in saved]
    for m, n, _ in saved:
        setattr(m, n, {"OnlineBatchScorer": TracedScorer,
                       "OnlineDecoder": RecordingDecoder,
                       "StickySessionServer": TracedServer}[n])
    TRACE = StreamTrace()
    try:
        yield TRACE
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def lockstep_dispatches(lengths, n: int, chunk: int, pipeline: bool) -> int:
    """online_serve_batch's `score` calls (one K5 launch each) for
    utterances of these lengths in reader order: each tick every bound
    slot takes up to `chunk` frames; a slot that finished is rebound
    when its tick's block is processed, right after its own dispatch, or
    with the pipeline one dispatch later."""
    it = iter(lengths)
    slots = [None] * n

    def assign(i):
        nxt = next(it, None)
        slots[i] = None if nxt is None else [nxt, 0]
    for i in range(n):
        assign(i)
    pending, inflight, calls = [], False, 0
    while any(x is not None for x in slots) or pending:
        if any(x is not None for x in slots):
            done = []
            for i, sl in enumerate(slots):
                if sl is None:
                    continue
                sl[1] += min(chunk, sl[0] - sl[1])
                if sl[1] >= sl[0]:
                    done.append(i)
                    slots[i] = None
            calls += 1
            pending.append(done)
            if pipeline and not inflight:
                inflight = True
                continue
        else:
            inflight = False
        for i in pending.pop(0):
            assign(i)
    return calls


def stream_report(what: str, tr: StreamTrace, frames: int, wall: float,
                  rss, bp_bytes: float, prof=None) -> dict:
    """Print a streaming run's measurements: decoded audio-s per wall-s,
    ticks, per tick the card's ms (input copy + forward: the CUDA events'
    span, and the profiler's kernel time), the score copy's ms (events'
    span) and bytes and the host search ms (medians), the tick walls'
    p50/p90/p99, the card's idle share (profiler), and the peak RSS
    against the backpointer estimate, with the bytes of the rows that
    this script keeps for its gates."""
    import torch
    torch.cuda.synchronize()
    pend = [p for p in tr.pend if hasattr(p, "begin")]
    card = [p.begin.elapsed_time(p.ready) for p in pend]
    copy = [p.start.elapsed_time(p.done) for p in pend]
    nbytes = [sum(h.nbytes for h in p.host) for p in pend]
    stamps = [c[0] for c in tr.calls]
    walls = 1e3 * np.diff(stamps) if len(stamps) > 1 else np.zeros(1)
    search = 1e3 * np.diff([c[1] for c in tr.calls] + [tr.search_s])
    audio_s = frames / FRAMES_PER_AUDIO_SECOND
    r = {"wall_s": wall, "audio_s_per_s": audio_s / wall,
         "ticks": len(tr.calls), "card_ms": statistics.median(card),
         "copy_ms": statistics.median(copy),
         "copy_bytes": int(statistics.median(nbytes)),
         "search_ms": float(np.median(search)),
         "p50": float(np.percentile(walls, 50)),
         "p90": float(np.percentile(walls, 90)),
         "p99": float(np.percentile(walls, 99)),
         "rss_peak": rss.peak - rss.start, "bp_bytes": bp_bytes}
    log(f"    {what}: {frames} frames ({audio_s:.2f} audio-s) in "
        f"{wall:.3f} s: {r['audio_s_per_s']:.2f} audio-s/s over "
        f"{r['ticks']} ticks")
    log(f"    per tick (median): card {r['card_ms']:.3f} ms (input copy + "
        f"K5 + affine + log-softmax, CUDA events; sum {sum(card):.1f} ms), "
        f"score copy {r['copy_ms']:.3f} ms of {r['copy_bytes']} bytes, "
        f"host search {r['search_ms']:.3f} ms (sum {1e3 * tr.search_s:.1f}"
        f" ms); tick wall p50 / p90 / p99 {r['p50']:.3f} / "
        f"{r['p90']:.3f} / {r['p99']:.3f} ms")
    if prof is not None:
        busy, copies = profiled_busy_ms(prof)
        r["idle"] = None if busy <= 0 else max(0.0, 1 - busy / (1e3 * wall))
        r["kernel_ms_tick"] = busy / max(r["ticks"], 1)
        r["copy_ms_tick"] = copies / max(r["ticks"], 1)
        log(f"    card idle share (torch.profiler, kernel time {busy:.3f} "
            f"ms of {1e3 * wall:.3f} ms wall, {r['kernel_ms_tick']:.3f} ms "
            f"a tick; copies and sets {copies:.3f} ms, "
            f"{r['copy_ms_tick']:.3f} ms a tick): "
            + ("not measured (no kernel time recorded)" if busy <= 0
               else f"{r['idle']:.4f}"))
    kept = sum(x.nbytes for d in tr.finished for x in d.rows)
    log(f"    host RSS peak +{r['rss_peak'] / 2**30:.3f} GiB over the start, "
        f"{kept / 2**30:.3f} GiB of it the rows this script keeps for its "
        f"gates; backpointer estimate (sessions x frames x states x 4 B) "
        f"{bp_bytes / 2**30:.3f} GiB")
    return r


def check_streamed(what: str, tr: StreamTrace, keys: list, graph, offline,
                   threads: int = 4) -> dict:
    """Gate the decoders of a run (in TRACE.finished order, which is the
    order of `keys`): decode_faster on each decoder's own rows gives
    exactly its words and score; with `offline` ({key: (rows, result)}),
    the streamed rows agree with the offline ones within SCORE_ATOL (the
    gate) and the words' agreement is returned."""
    from concurrent.futures import ThreadPoolExecutor
    from kaldi_lstm_tpu_torch.decode.faster import decode_faster
    decs = tr.finished
    if len(decs) != len(keys):
        fail(f"{what}: {len(decs)} decoders finalized for {len(keys)} "
             f"utterances")

    def redo(dec):
        rows = np.concatenate(dec.rows)
        return rows, decode_faster(graph, rows, dec.acoustic_scale,
                                   dec.beam, dec.max_active)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        redone = list(pool.map(redo, decs))
    worst, same = 0.0, 0
    for key, dec, (rows, ref) in zip(keys, decs, redone):
        if ref.words != dec.result.words or ref.score != dec.result.score:
            fail(f"{what}: {key}: decode_faster on the streamed rows gives "
                 f"{ref.words} ({ref.score!r}), the stream "
                 f"{dec.result.words} ({dec.result.score!r})")
        if offline is not None:
            off_rows, off_res = offline[key]
            if rows.shape != off_rows.shape:
                fail(f"{what}: {key}: streamed rows {rows.shape} vs "
                     f"offline {off_rows.shape}")
            worst = max(worst, float(np.abs(rows - off_rows).max()))
            same += off_res.words == dec.result.words
    log(f"    decode_faster on each session's own streamed rows: words and "
        f"score equal for all {len(keys)} ({time.perf_counter() - t0:.1f} s "
        f"on {threads} threads)")
    out = {}
    if offline is not None:
        out = {"max_abs_err": worst, "agree": same / len(keys)}
        log(f"    streamed vs offline scores: max_abs_err {worst:.3e} (tol "
            f"{SCORE_ATOL:g}); transcripts equal to offline "
            f"{out['agree']:.4f}")
        if worst > SCORE_ATOL:
            fail(f"{what}: streamed scores disagree with the offline ones")
    return out


def phase_stream(work: str, p7: dict) -> dict:
    """Phase 8: streaming serving on phase 7's AM. Lock-step
    (online_serve_batch, 64 sessions) on a second, 500-word corpus of
    the same phones and emission means, dense and then pipelined with a
    top-P bf16 fetch; the single stream (online_decode) on 4 of its
    utterances; sticky sessions (online_serve_sticky, 4 slots, ragged
    Poisson chunks) on phase 7's decoded utterances over its graph, with
    an in-process replay of the same trace and an endpointing pass."""
    import argparse
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from kaldi_lstm_tpu_torch.decode.faster import decode_faster
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.io.lang import read_lexicon, read_text_table
    from kaldi_lstm_tpu_torch.tools import (
        make_word_synth_data,
        nnet_forward,
        online_decode,
        online_serve_batch,
        online_serve_sticky,
    )
    from kaldi_lstm_tpu_torch.tools.decode_faster import graph_from_args

    dev = torch.device("cuda")
    log(f"  cuts: lock-step on {STREAM_UTTS} utterances ({STREAM_SESSIONS} "
        f"sessions and {STREAM_UTTS - STREAM_SESSIONS} rebinds; round 4 ran "
        f"120); the single stream on {SINGLE_UTTS}; sticky on {STICKY_UTTS} "
        f"of phase 7's decoded utterances, the endpointing pass on "
        f"{STICKY_ENDPOINT_UTTS} (each live session keeps 6 MB of "
        f"backpointers a frame at 1.52M states and the dense stream core "
        f"searches a frame in milliseconds)")
    lang = os.path.join(work, "lang500")
    t0 = time.perf_counter()
    if make_word_synth_data.main(["--dir", lang, "--num-utts",
                                  str(STREAM_UTTS)] + STREAM_CORPUS) != 0:
        fail("make_word_synth_data (500 words) failed")
    with open(f"{lang}/final.mdl", "rb") as a, \
            open(f"{p7['lang']}/final.mdl", "rb") as b:
        if a.read() != b.read():
            fail("the 500-word corpus's final.mdl differs from phase 7's")
    log(f"  500-word corpus ({time.perf_counter() - t0:.3f} s): final.mdl "
        f"byte-identical to phase 7's, so phase 7's AM applies")
    lex = read_lexicon(f"{lang}/lexicon.txt")
    est_states = sum(len(p) for prons in lex.values() for p in prons) * 3
    feats = dict(kio.SequentialMatrixReader(f"scp:{lang}/feats.scp"))
    keys = list(feats)
    lengths = [len(feats[k]) for k in keys]
    frames = sum(lengths)
    mean_len = frames / len(keys)
    log(f"  graph size before building: about {est_states} emitting states "
        f"(pronunciation phones x 3); backpointers of {STREAM_SESSIONS} "
        f"sessions x {mean_len:.0f} frames: about "
        f"{STREAM_SESSIONS * mean_len * est_states * 4 / 2**30:.3f} GiB")

    base = [p7["final"], f"{lang}/final.mdl", f"{lang}/lexicon.txt", "none",
            f"scp:{lang}/feats.scp"]
    common = ["--word-symbol-table", f"{lang}/words.txt",
              f"--class-frame-counts={p7['counts']}", "--device", "cuda",
              *STREAM_SEARCH, "--chunk-frames", str(STREAM_CHUNK)]
    bparser = online_serve_batch.build_parser()
    args = bparser.parse_args(base + [f"ark,t:{work}/hyp_lock.txt"] + common
                              + ["--num-sessions", str(STREAM_SESSIONS)])
    t0 = time.perf_counter()
    _, graph = graph_from_args(args)
    ns = graph.num_states
    log(f"  graph: {ns} states, {graph.num_arcs()} arcs in "
        f"{time.perf_counter() - t0:.3f} s")

    # offline: nnet_forward's scorer -> decode_faster over the same graph
    fargs = argparse.Namespace(
        feature_transform="", apply_log="true", no_softmax="false",
        class_frame_counts=p7["counts"], prior_scale=1.0, prior_floor=1e-10,
        length_bucket=128, batch_utts=8, device="cuda")
    t0 = time.perf_counter()
    scorer = nnet_forward.scorer_from_args(fargs, p7["final"])
    offline = {}
    for key, y in scorer.score_stream(feats.items()):
        offline[key] = (y, decode_faster(graph, y, args.acoustic_scale,
                                         args.beam, args.max_active))
    log(f"  offline nnet_forward -> decode_faster: {len(offline)} "
        f"utterances in {time.perf_counter() - t0:.3f} s")

    def text(name):
        return read_text_table(os.path.join(work, name))
    out = {}
    # 1. lock-step, dense fetch, then pipelined top-P bf16
    for tag, extra, pipe in (
            ("dense", [], False),
            ("pipe_topp_bf16", ["--pipeline", "true", "--top-p",
                                str(STREAM_TOP_P), "--fetch-bf16", "true"],
             True)):
        a = bparser.parse_args(base + [f"ark,t:{work}/hyp_lock_{tag}.txt"]
                               + common + ["--num-sessions",
                                           str(STREAM_SESSIONS)] + extra)
        pred = lockstep_dispatches(lengths, STREAM_SESSIONS, STREAM_CHUNK,
                                   pipe)
        log(f"  lock-step online_serve_batch, {tag} ({' '.join(extra)}):")
        prof = tprofile(activities=[ProfilerActivity.CUDA])
        with traced_stream() as tr, RssPeak() as rss, prof:
            got, wall = counted(f"online_serve_batch {tag}",
                                {"lstmp_infer": pred},
                                lambda: online_serve_batch.serve(a, dev,
                                                                 graph))
        if got["lstmp_infer_masked"]:
            fail("lock-step ticks launched the masked K5")
        done = list(text(f"hyp_lock_{tag}.txt"))
        r = stream_report(tag, tr, frames, wall, rss,
                          STREAM_SESSIONS * mean_len * ns * 4, prof)
        r.update(check_streamed(f"lock-step {tag}", tr, done, graph,
                                offline if tag == "dense" else None))
        r["launches"] = got["lstmp_infer"]
        if tag != "dense":
            hyp, dense = text(f"hyp_lock_{tag}.txt"), text(
                "hyp_lock_dense.txt")
            sym = graph.words.id2sym
            r["agree"] = sum(
                hyp[k] == [sym[w] for w in offline[k][1].words]
                for k in keys) / len(keys)
            r["agree_dense"] = sum(hyp[k] == dense[k] for k in keys) \
                / len(keys)
            log(f"    transcripts equal to offline {r['agree']:.4f}, to the "
                f"dense stream {r['agree_dense']:.4f}")
        out[tag] = r

    # 2. the single stream: online_decode on the first utterances
    single = os.path.join(work, "single.scp")
    with open(f"{lang}/feats.scp") as f:
        head = f.read().splitlines()[:SINGLE_UTTS]
    with open(single, "w") as f:
        f.write("\n".join(head) + "\n")
    skeys = keys[:SINGLE_UTTS]
    a = online_decode.build_parser().parse_args(
        base[:4] + [f"scp:{single}", f"ark,t:{work}/hyp_single.txt"]
        + common)
    pred = sum(-(-lengths[i] // STREAM_CHUNK) for i in range(SINGLE_UTTS))
    sframes = sum(lengths[:SINGLE_UTTS])
    log(f"  single stream online_decode (K5 at S=1, {SINGLE_UTTS} "
        f"utterances):")
    prof = tprofile(activities=[ProfilerActivity.CUDA])
    with traced_stream() as tr, RssPeak() as rss, prof:
        got, wall = counted("online_decode", {"lstmp_infer": pred},
                            lambda: online_decode.decode_utterances(
                                a, dev, graph))
    r = stream_report("single", tr, sframes, wall, rss,
                      max(lengths[:SINGLE_UTTS]) * ns * 4, prof)
    r.update(check_streamed("single stream", tr, skeys, graph, offline))
    r["launches"] = got["lstmp_infer"]
    out["single"] = r

    # 3. sticky sessions over phase 7's graph on its decoded utterances
    g7 = p7["graph"]
    sticky = os.path.join(work, "sticky.scp")
    with open(sticky, "w") as f:
        f.write("\n".join(p7["dec_lines"][:STICKY_UTTS]) + "\n")
    endp = os.path.join(work, "sticky_ep.scp")
    with open(endp, "w") as f:
        f.write("\n".join(p7["dec_lines"][:STICKY_ENDPOINT_UTTS]) + "\n")
    tkeys = [ln.split()[0] for ln in p7["dec_lines"][:STICKY_UTTS]]
    tframes = sum(p7["lens"][k] for k in tkeys)
    l7 = p7["lang"]
    sparser = online_serve_sticky.build_parser()
    sbase = [p7["final"], f"{l7}/final.mdl", f"{l7}/lexicon.txt",
             f"{l7}/lm.arpa"]
    scommon = ["--word-symbol-table", f"{l7}/words.txt",
               f"--class-frame-counts={p7['counts']}", "--device", "cuda",
               *STREAM_SEARCH, "--chunk-frames", str(STREAM_CHUNK),
               "--num-slots", str(STICKY_SLOTS), "--arrival-hazard", "0.2",
               "--mean-chunk", "20", "--trace-seed", "0"]
    a = sparser.parse_args(sbase + [f"scp:{sticky}",
                                    f"ark,t:{work}/hyp_sticky.txt"]
                           + scommon)
    bp7 = STICKY_SLOTS * tframes / STICKY_UTTS * g7.num_states * 4
    bp7_max = sum(sorted(p7["lens"][k] for k in tkeys)[-STICKY_SLOTS:]) \
        * g7.num_states * 4
    log(f"  sticky sessions over phase 7's graph ({g7.num_states} states; "
        f"backpointers of {STICKY_SLOTS} live sessions: about "
        f"{bp7 / 2**30:.2f} GiB at the mean length, {bp7_max / 2**30:.2f} "
        f"GiB for the {STICKY_SLOTS} longest):")
    from kaldi_lstm_tpu_torch.ops.counts import reset_counts, snapshot_counts
    with traced_stream() as tr, RssPeak() as rss:
        reset_counts()
        t0 = time.perf_counter()
        srv = online_serve_sticky.make_server(a, dev, g7)
        if online_serve_sticky.drive_trace(a, srv) is None:
            fail("the in-process sticky replay ran away")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cnt = snapshot_counts()
    busy_ticks = sum(1 for n in tr.totals if n)
    log(f"  in-process replay of the trace: {len(tr.totals)} ticks, "
        f"{busy_ticks} with frames; masked K5 launches "
        f"{cnt['lstmp_infer_masked']}, unmasked {cnt['lstmp_infer']}, plain "
        f"{cnt['plain.lstm_infer']}; occupancy {srv.occupancy:.4f}")
    if (cnt["lstmp_infer_masked"], cnt["lstmp_infer"],
            cnt["plain.lstm_infer"]) != (busy_ticks, 0, 0):
        fail("the sticky replay did not launch one masked K5 per tick with "
             "frames")
    order = [r.sid for r in srv.results]
    stream_report("sticky replay", tr, tframes, wall, rss, bp7)
    check_streamed("sticky replay", tr, order, g7, None)
    inproc = {r.sid: [g7.words.id2sym[w] for w in r.result.words]
              for r in srv.results}
    del srv, tr
    prof = tprofile(activities=[ProfilerActivity.CUDA])
    with traced_stream() as tr, RssPeak() as rss, prof:
        got, wall = counted("online_serve_sticky",
                            {"lstmp_infer_masked": busy_ticks},
                            lambda: online_serve_sticky.serve(a, dev, g7))
    if got["lstmp_infer"]:
        fail("sticky ticks launched the unmasked K5")
    r = stream_report("sticky CLI", tr, tframes, wall, rss, bp7, prof)
    r["occupancy"] = tr.server.occupancy
    log(f"    occupancy (bound slots over slot-ticks) {r['occupancy']:.4f}")
    hyp = text("hyp_sticky.txt")
    if hyp != inproc:
        fail("the sticky CLI's transcripts differ from the in-process "
             "server's")
    r["agree"] = sum(hyp[k] == p7["ref"][k] for k in tkeys) / len(tkeys)
    r["launches"] = got["lstmp_infer_masked"]
    log(f"    the CLI's {len(hyp)} transcripts equal the in-process "
        f"server's; equal to phase 7's offline transcripts {r['agree']:.4f}")
    out["sticky"] = r
    del tr
    a = sparser.parse_args(sbase + [f"scp:{endp}",
                                    f"ark,t:{work}/hyp_sticky_ep.txt"]
                           + scommon + ["--endpoint-silence-pdfs", "0,1,2",
                                        "--endpoint-trailing-silence", "8"])
    with traced_stream() as tr:
        t0 = time.perf_counter()
        srv = online_serve_sticky.make_server(a, dev, g7)
        if online_serve_sticky.drive_trace(a, srv) is None:
            fail("the endpointing pass ran away")
        n_ep = online_serve_sticky.write_results(a, srv, g7)
    log(f"  endpointing pass (--endpoint-silence-pdfs 0,1,2, phone 1 being "
        f"silence; --endpoint-trailing-silence 8, under one silence phone's "
        f"~10 frames), {STICKY_ENDPOINT_UTTS} utterances in "
        f"{time.perf_counter() - t0:.3f} s: {n_ep} of {len(srv.results)} "
        f"sessions endpointed")
    out["endpointed"] = n_ep
    return out


# ---------------------------------------------------------------------------
# phase 9: realign and post-process (nnet_align, align_mapped, ali_to_pdf,
# ali_to_phones and the lattice tools) in phase 7's work directory
# ---------------------------------------------------------------------------

def phase_align(work: str, p7: dict) -> dict:
    """Phase 9: nnet_align as the recipe runs it on phase 7's AM and
    corpus, held to the two-stage flow byte for byte; then the lattice
    tools on phase 7's fused lattices. Returns the K5 launches of the
    CLI run."""
    import contextlib as ctx
    from torch.profiler import ProfilerActivity, profile as tprofile
    import kaldi_lstm_tpu_torch.tools.align_mapped as am
    from kaldi_lstm_tpu_torch.decode.wer import EditStats, edit_distance, \
        wer_report
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.io.lang import read_text_table
    from kaldi_lstm_tpu_torch.io.lattice import (
        SequentialLatticeReader,
        lattice_best_path,
    )
    from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
    from kaldi_lstm_tpu_torch.tools import (
        ali_to_pdf,
        ali_to_phones,
        lattice_best_path as lbp,
        lattice_copy,
        lattice_lmrescore,
        lattice_mbr_decode,
        lattice_oracle,
        lattice_prune,
        lattice_to_ctm,
        nnet_align,
        nnet_forward,
    )

    lang, final, counts = p7["lang"], p7["final"], p7["counts"]
    log(f"  cuts: the first {ALIGN_UTTS} training utterances of phase 7's "
        f"corpus realigned (the recipe: KLT_NSEQ = 400); the card against "
        f"--device cpu on the first {ALIGN_CPU_UTTS}; ali_to_phones "
        f"--ctm-output on {ALIGN_CTM_UTTS}; the lattice tools on phase 7's "
        f"{DECODE_LAT_UTTS} lattices")
    with open(f"{lang}/feats.scp") as f:
        lines = f.read().splitlines()[:ALIGN_UTTS]
    keys = [ln.split()[0] for ln in lines]
    texts = read_text_table(f"{lang}/text")

    def write(name, rows):
        path = os.path.join(work, name)
        with open(path, "w") as f:
            f.write("\n".join(rows) + "\n")
        return path
    seq_scp = "scp:" + write("seq.scp", lines)
    cpu_scp = "scp:" + write("seq_cpu.scp", lines[:ALIGN_CPU_UTTS])
    seq_text = write("text.seq", [f"{k} {' '.join(texts[k])}" for k in keys])
    frames = {k: m.shape[0] for k, m in kio.SequentialMatrixReader(seq_scp)}
    n_frames = sum(frames.values())
    audio_s = n_frames / FRAMES_PER_AUDIO_SECOND
    graph_args = [f"{lang}/final.mdl", f"{lang}/lexicon.txt"]

    def argv(feats, out, device="cuda"):
        return [final, *graph_args, feats, seq_text, f"ark:{out}",
                f"--class-frame-counts={counts}", *ALIGN_FLAGS,
                "--device", device]

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    def alis(path):
        return dict(kio.SequentialIntVectorReader(f"ark:{path}"))
    n_batches = -(-ALIGN_UTTS // 8)
    only_k5 = {"lstmp_infer": n_batches}

    def k5_only(what, got):
        from kaldi_lstm_tpu_torch.ops.counts import launch_counts
        others = {k: got[k] for k in launch_counts()
                  if k not in only_k5 and got[k]}
        if others:
            fail(f"{what} launched other kernels or plain versions: {others}")

    # 1. the CLI as the recipe runs it (model read, scoring, alignment)
    fused = os.path.join(work, "ali_fused.ark")
    got, cli_wall = counted(
        f"nnet_align, the CLI as the recipe runs it, {ALIGN_UTTS} "
        f"utterances ({n_frames} frames, {audio_s:.2f} audio-s)", only_k5,
        lambda: nnet_align.main(argv(seq_scp, fused)))
    k5_only("nnet_align", got)
    launches = got["lstmp_infer"]
    log(f"    {audio_s / cli_wall:.2f} aligned audio-s per wall-s")

    # 2. the same body on a prebuilt scorer, instrumented and traced
    args = nnet_align.build_parser().parse_args(
        argv(seq_scp, os.path.join(work, "ali_body.ark")))
    scorer = nnet_align.make_scorer(args)
    pend, graph_s, align_s = [], [], []
    dispatch = scorer._dispatch

    def tracked(group):
        pend.append(dispatch(group))
        return pend[-1]
    scorer._dispatch = tracked
    build, viterbi = am.build_alignment_graph, am.align_mapped

    def timed(fn, acc):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc.append(time.perf_counter() - t0)
        return run
    am.build_alignment_graph = timed(build, graph_s)
    am.align_mapped = timed(viterbi, align_s)
    prof = tprofile(activities=[ProfilerActivity.CUDA])
    try:
        with prof:
            got, wall = counted(
                "nnet_align body on a prebuilt scorer (traced)", only_k5,
                lambda: nnet_align.align_features(args, scorer))
    finally:
        am.build_alignment_graph, am.align_mapped = build, viterbi
    k5_only("nnet_align body", got)
    scoring_ms = sum(p.begin.elapsed_time(p.ready) for p in pend)
    busy, copies = profiled_busy_ms(prof)
    idle = None if busy <= 0 else max(0.0, 1 - busy / (1e3 * wall))
    log(f"    {audio_s / wall:.2f} aligned audio-s per wall-s ({wall:.3f} s)"
        f"; card: scoring (input copy + forward, CUDA events) "
        f"{scoring_ms:.3f} ms over {len(pend)} batches "
        f"({', '.join(f'{p.begin.elapsed_time(p.ready):.3f}' for p in pend)}"
        f" ms); host: alignment graphs {1e3 * sum(graph_s):.3f} ms, Viterbi "
        f"{1e3 * sum(align_s):.3f} ms ({len(align_s)} utterances)")
    log("    card idle share over the run (torch.profiler, kernel time "
        f"{busy:.3f} ms of {1e3 * wall:.3f} ms wall; copies and sets "
        f"{copies:.3f} ms): "
        + ("not measured (no kernel time recorded)" if idle is None
           else f"{idle:.4f}"))
    if read(fused) != read(os.path.join(work, "ali_body.ark")):
        fail("the instrumented nnet_align body wrote other alignments "
             "than the CLI")

    # 3. the two-stage flow: nnet_forward -> ark -> align_mapped
    loglik = os.path.join(work, "seq_loglik.ark")
    two = os.path.join(work, "ali_two.ark")
    got, _ = counted("nnet_forward (two-stage flow, stage 1)", only_k5,
                     lambda: nnet_forward.main(
                         [final, seq_scp, f"ark:{loglik}",
                          f"--class-frame-counts={counts}",
                          "--apply-log=true", "--device", "cuda"]))
    k5_only("nnet_forward", got)
    t0 = time.perf_counter()
    if am.main([*graph_args, f"ark:{loglik}", seq_text, f"ark:{two}",
                "--acoustic-scale", "1.0"]) != 0:
        fail("two-stage align_mapped failed")
    log(f"  two-stage align_mapped over the ark: "
        f"{time.perf_counter() - t0:.3f} s")
    if read(two) != read(fused):
        fail("fused and two-stage alignments differ")
    ali = alis(fused)
    if list(ali) != keys:
        fail(f"{ALIGN_UTTS - len(ali)} utterances failed to align "
             f"({len(ali)} of {ALIGN_UTTS} written)")
    bad = [k for k in keys if len(ali[k]) != frames[k]]
    if bad:
        fail(f"alignment lengths differ from the frame counts: {bad[:4]}")
    log(f"  fused and two-stage alignments ({len(read(fused))} bytes): "
        f"byte-identical; {len(ali)} of {ALIGN_UTTS} utterances aligned, "
        f"each alignment as long as its utterance")

    # 4. printed, not gated: the truth, the CPU, ali_to_phones
    pdf_ark = os.path.join(work, "ali_pdf.ark")
    if ali_to_pdf.main([f"{lang}/final.mdl", f"ark:{fused}",
                        f"ark:{pdf_ark}"]) != 0:
        fail("ali_to_pdf failed")
    tm = TransitionModel.load(f"{lang}/final.mdl")
    truth = {k: tm.transition_ids_to_pdfs(a) for k, a in
             kio.SequentialIntVectorReader(f"ark:{lang}/ali.ark")
             if k in frames}
    same = sum(int((p == truth[k]).sum())
               for k, p in kio.SequentialIntVectorReader(f"ark:{pdf_ark}"))
    log(f"  frames whose ali_to_pdf pdf equals the corpus's ali.ark pdf: "
        f"{same / n_frames:.4f} (not gated)")
    cpu_ali = os.path.join(work, "ali_cpu.ark")
    t0 = time.perf_counter()
    if nnet_align.main(argv(cpu_scp, cpu_ali, "cpu")) != 0:
        fail("nnet_align --device cpu failed")
    cpu = alis(cpu_ali)
    same_cpu = sum(np.array_equal(cpu[k], ali[k]) for k in cpu)
    log(f"  --device cpu on {ALIGN_CPU_UTTS} utterances "
        f"({time.perf_counter() - t0:.3f} s): alignments equal to the "
        f"card's {same_cpu}/{ALIGN_CPU_UTTS} (not gated)")
    two_ark = os.path.join(work, "ali_ctm.ark")
    with kio.TableWriter(f"ark:{two_ark}", kio.write_int_vector) as w:
        for k in keys[:ALIGN_CTM_UTTS]:
            w.write(k, ali[k])
    ctm = os.path.join(work, "phones.ctm")
    if ali_to_phones.main([f"{lang}/final.mdl", f"ark:{two_ark}", ctm,
                           "--ctm-output", "true"]) != 0:
        fail("ali_to_phones --ctm-output failed")
    with open(ctm) as f:
        ctm_lines = f.read().splitlines()
    log(f"  ali_to_phones --ctm-output on {ALIGN_CTM_UTTS} utterances: "
        f"{len(ctm_lines)} phone lines; the first 6 of each:")
    for k in keys[:ALIGN_CTM_UTTS]:
        for ln in [ln for ln in ctm_lines if ln.split()[0] == k][:6]:
            log(f"    {ln}")

    # 5. the lattice tools on phase 7's fused lattices
    lats = os.path.join(work, "lat_fused.ark")
    words = ["--word-symbol-table", f"{lang}/words.txt"]
    one_best = read_text_table(os.path.join(work, "lhyp_fused.txt"))
    lat_keys = list(one_best)
    t0 = time.perf_counter()
    bp = os.path.join(work, "lat_bp.txt")
    if lbp.main([f"ark:{lats}", f"ark,t:{bp}", *words]) != 0:
        fail("lattice_best_path failed")
    if read_text_table(bp) != one_best:
        fail("lattice_best_path differs from phase 7's lattice one-best")
    copies = [os.path.join(work, n) for n in
              ("lat_copy.ark", "lat_t1.txt", "lat_t1.ark", "lat_t2.txt")]
    steps = [(lats, copies[0], "ark"), (lats, copies[1], "ark,t"),
             (copies[1], copies[2], "ark"), (copies[2], copies[3], "ark,t")]
    for src, dst, spec in steps:
        if lattice_copy.main([f"ark:{src}", f"{spec}:{dst}"]) != 0:
            fail(f"lattice_copy {src} -> {spec}:{dst} failed")
    if read(copies[0]) != read(lats) or read(copies[1]) != read(copies[3]):
        fail("lattice_copy did not reproduce the binary bytes, or binary "
             "-> text -> binary -> text changed the text")
    orig = dict(SequentialLatticeReader(f"ark:{lats}"))
    back = dict(SequentialLatticeReader(f"ark:{copies[2]}"))
    worst = 0.0
    for k in orig:
        a, b = orig[k], back[k]
        if (a.start, [[(x.label, x.tids, x.dst) for x in arcs]
                      for arcs in a.arcs]) != \
                (b.start, [[(x.label, x.tids, x.dst) for x in arcs]
                           for arcs in b.arcs]) or \
                sorted(a.final) != sorted(b.final):
            fail(f"{k}: binary -> text -> binary changed the structure")
        for arcs_a, arcs_b in zip(a.arcs, b.arcs):
            for x, y in zip(arcs_a, arcs_b):
                worst = max(worst, abs(x.graph_cost - y.graph_cost),
                            abs(x.acoustic_cost - y.acoustic_cost))
    if worst > 1e-3:
        fail(f"binary -> text -> binary moved a weight by {worst:.3e}")
    pruned = os.path.join(work, "lat_pruned.ark")
    if lattice_prune.main([f"ark:{lats}", f"ark:{pruned}", "--beam",
                           PRUNE_BEAM]) != 0:
        fail("lattice_prune failed")
    p_words = {k: lattice_best_path(v)[0] for k, v in
               SequentialLatticeReader(f"ark:{pruned}")}
    o_words = {k: lattice_best_path(v)[0] for k, v in orig.items()}
    if p_words != o_words:
        fail(f"lattice_prune --beam {PRUNE_BEAM} changed a best path")
    ctm_w = os.path.join(work, "lat.ctm")
    if lattice_to_ctm.main([f"ark:{lats}", ctm_w, *words]) != 0:
        fail("lattice_to_ctm failed")
    by_utt = {k: [] for k in lat_keys}
    with open(ctm_w) as f:
        for ln in f:
            by_utt[ln.split()[0]].append(ln.split()[4])
    if by_utt != one_best:
        fail("lattice_to_ctm's words differ from the best path's")
    log(f"  lattice tools on {len(lat_keys)} lattices "
        f"({time.perf_counter() - t0:.3f} s): lattice_best_path equals "
        f"phase 7's one-best; lattice_copy binary -> binary reproduces the "
        f"bytes, binary -> text -> binary -> text the text (the text form "
        f"keeps 6 decimals: largest weight change {worst:.3e}, structure "
        f"equal); lattice_prune --beam {PRUNE_BEAM} keeps every best path "
        f"({sum(v.num_arcs() for v in orig.values())} -> "
        f"{sum(v.num_arcs() for k, v in SequentialLatticeReader(f'ark:{pruned}'))}"
        f" arcs); lattice_to_ctm writes the best paths' words in order")

    corpus = read_text_table(f"{lang}/text")

    def wer(hyp) -> str:
        total = EditStats()
        for k in lat_keys:
            total.add(edit_distance(corpus[k], hyp[k]))
        return wer_report(total)
    t0 = time.perf_counter()
    mbr = os.path.join(work, "lat_mbr.txt")
    if lattice_mbr_decode.main([f"ark:{lats}", f"ark,t:{mbr}", *words]) != 0:
        fail("lattice_mbr_decode failed")
    oracle = os.path.join(work, "lat_oracle.txt")
    with ctx.redirect_stdout(sys.stderr):
        rc = lattice_oracle.main([f"ark:{lats}", f"{lang}/text", *words,
                                  "--oracle-wspecifier", f"ark,t:{oracle}"])
    if rc != 0:
        fail("lattice_oracle failed")
    resc = os.path.join(work, "lat_resc.ark")
    if lattice_lmrescore.main([f"ark:{lats}", f"{lang}/lm.arpa",
                               f"{lang}/lm.arpa", f"ark:{resc}",
                               *words]) != 0:
        fail("lattice_lmrescore failed")
    r_words = {k: lattice_best_path(v)[0] for k, v in
               SequentialLatticeReader(f"ark:{resc}")}
    same_resc = sum(r_words[k] == o_words[k] for k in lat_keys)
    log(f"  ({time.perf_counter() - t0:.3f} s, not gated) against the "
        f"corpus text: lattice one-best {wer(one_best)}; lattice_mbr_decode "
        f"{wer(read_text_table(mbr))}; lattice_oracle "
        f"{wer(read_text_table(oracle))}; lattice_lmrescore (old and new "
        f"LM phase 7's trigram) keeps the best path's words in "
        f"{same_resc}/{len(lat_keys)}")
    return {"launches": launches, "wall_s": wall, "cli_wall_s": cli_wall,
            "scoring_ms": scoring_ms, "idle": idle, "feats": seq_scp,
            "ali": fused}


# ---------------------------------------------------------------------------
# phase 10: per-utterance and frame-shuffled training
# ---------------------------------------------------------------------------

def blstm_layer_case(name, T, I, C, R, seed, need_dx):
    """One BLSTM layer on the card, trained as per-utterance training
    calls it (S=1, zero initial state, one K1 and one K2 call per
    direction through the autograd Function, the backward direction's
    on the time-flipped input), against the plain versions on the same
    inputs: the forward half of the output against K1's plain version
    on x, the backward half against it on flip(x) flipped back, and the
    gradients against K2's plain version per direction on the cotangent
    split and flipped the same way. Returns the worst abs error."""
    import torch
    from kaldi_lstm_tpu_torch.models.components import BLstmProjectedStreams
    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    bl = BLstmProjectedStreams(I, 2 * R, cell_dim=C, param_scale=0.04)
    params = bl.init_params(torch.Generator().manual_seed(seed), "cuda")
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(1, T, I).astype(np.float32), device="cuda")
    cot = torch.tensor(rng.randn(1, T, 2 * R).astype(np.float32),
                       device="cuda")
    live = {d: type(p)(*(t.detach().requires_grad_() for t in p))
            for d, p in params.items()}
    xg = x.clone().requires_grad_(need_dx)
    log(f"  [{name}] BLSTM layer S=1 T={T} I={I} C={C} R={R} dx {need_dx}")
    lt.reset_counts()
    y, _ = bl.apply(live, xg, input_grad=need_dx)
    torch.autograd.backward(y, cot)
    torch.cuda.synchronize()
    want = (2 * lt.fwd_launches(T), 2 * lt.bwd_launches(T, need_dx), 0)
    got = (lt.FWD_LAUNCHES, lt.BWD_LAUNCHES, lt.PLAIN_CALLS)
    log(f"    K1/K2 launches {got[:2]} (predicted {want[:2]}: one call per "
        f"direction), plain calls {got[2]}")
    if got != want:
        fail(f"{name}: K1/K2 launches and plain calls {got}, predicted "
             f"{want}")
    zc = torch.zeros(1, C, device="cuda")
    zr = torch.zeros(1, R, device="cuda")
    worst = 0.0
    dx_sum = torch.zeros(T, 1, I, device="cuda")
    for d, half in (("fw", slice(0, R)), ("bw", slice(R, 2 * R))):
        flip = d == "bw"
        xin = torch.flip(x, (1,)) if flip else x
        gin = cot[..., half]
        gin = torch.flip(gin, (1,)) if flip else gin
        x_tm = xin.transpose(0, 1).contiguous()
        gifo, c_seq, r_seq = lt.lstm_fwd_residuals_plain(
            params[d], x_tm, zc, zr, None, 1.0, 50.0)
        out = r_seq.transpose(0, 1)
        out = torch.flip(out, (1,)) if flip else out
        worst = compare(f"K1 {d} r", y[..., half].detach(), out, worst)
        dp, dx, _, _ = lt.lstm_bwd_plain(
            params[d], x_tm, zc, zr, gifo, c_seq, r_seq, None, 1.0,
            gin.transpose(0, 1).contiguous(), zc, need_dx)
        for f, a, b in zip(type(dp)._fields, live[d], dp):
            worst = compare(f"K2 {d} d{f}", a.grad, b, worst)
        if need_dx:
            dx_sum += torch.flip(dx, (0,)) if flip else dx
    if need_dx:
        worst = compare("K2 dx (both directions)", xg.grad,
                        dx_sum.transpose(0, 1), worst)
    return worst


def phase_perutt_kernels() -> dict:
    """Phase 10a: K1-K5 against their plain versions at the per-utterance
    training shapes (S=1, T up to 1024; a second BLSTM layer at I=1024),
    K3/K4 at the BLSTM's R=1024 and the DNN's minibatch, K5 on the
    BLSTM's flipped half at S=8, T=1000; K1 and K2 timed at S=1, T=1024.
    Returns {kernel: record}."""
    import torch
    from kaldi_lstm_tpu_torch.ops import lstm_infer as li
    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    from kaldi_lstm_tpu_torch.ops.lstm_cell import lstm_scan, zero_state
    I, C, R, K = 40, 800, 512, 8000
    worst = {k: 0.0 for k in ("K1", "K2", "K3", "K4", "K5")}
    recs = {}
    for i, (name, dims, clip, keep, dx, extra, timed) in enumerate((
            ("per-utterance S=1 T=128, no dx", (1, 128, I, C, R), 50.0,
             None, False, {}, False),
            ("per-utterance S=1 T=1024, no dx", (1, 1024, I, C, R), 50.0,
             None, False, {}, True),
            ("second layer S=1 T=128 I=1024, dx", (1, 128, 2 * R, C, R),
             50.0, None, True, {}, False),
            ("ragged S=1 T=131 I=37 C=200 R=130, clip active, keep 0.8, dx",
             (1, 131, 37, 200, 130), 1.0, 0.8, True,
             {"x_scale": 20.0, "param_scale": 0.2}, False))):
        w, rec = lstm_train_case(name, *dims, clip, keep, dx, 80 + i,
                                 timed=timed, **extra)
        worst["K1"] = worst["K2"] = max(worst["K1"], w)
        if rec:
            recs.update(rec)
    for name, T, I_, dx in (("BLSTM layer 1, T=1024", 1024, I, False),
                            ("BLSTM layer 2, T=128, I=1024", 128, 2 * R,
                             True)):
        w = blstm_layer_case(name, T, I_, C, R, 90, dx)
        worst["K1"] = worst["K2"] = max(worst["K1"], w)
    T = 1024
    for key, launches in (("K1", lt.fwd_launches(T)),
                          ("K2", lt.bwd_launches(T, False))):
        r = recs[key]
        r["launches_per_call"] = launches
        r["us_per_launch"] = 1e3 * r["ms"] / launches
        log(f"  K{key[1]} at S=1, T={T}: {r['ms']:.3f} ms a call, "
            f"{launches} launches ({'fwd' if key == 'K1' else 'bwd'}"
            f"_launches({T}{'' if key == 'K1' else ', False'})), "
            f"{r['us_per_launch']:.2f} us a launch; plain "
            f"{r['plain_ms']:.3f} ms; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    for name, dims, timed in (
            ("BLSTM per-utterance N=1024 R=1024", (1024, 2 * R, K, 1),
             True),
            ("DNN minibatch N=256 R=1024", (256, 1024, K, 1), "dnn")):
        w, rec = xent_case(name, *dims, 95, timed=bool(timed))
        worst["K3"] = worst["K4"] = max(worst["K3"], w)
        tag = "n1024" if timed is True else "n256"
        for k in ("K3", "K4"):
            recs.setdefault(k, {}).update(
                {f"{tag}_{f}": rec[k][f] for f in ("ms", "plain_ms",
                                                   "bound_ms",
                                                   "bound_by")})
    # K5 on the BLSTM's backward half: zero state, time-flipped input
    g = torch.Generator().manual_seed(97)
    from kaldi_lstm_tpu_torch.ops.lstm_cell import init_lstm_params
    params = init_lstm_params(g, I, C, R, 0.04, device="cuda")
    x = torch.tensor(np.random.RandomState(97).randn(8, 1000, I)
                     .astype(np.float32), device="cuda")
    xf = torch.flip(x, (1,))
    st = zero_state(8, C, R, device="cuda")
    li.reset_counts()
    with torch.inference_mode():
        out_k, fin_k = li.lstm_infer(params, xf, st, 50.0)
        out_p, fin_p = lstm_scan(params, xf, st, 50.0)
        torch.cuda.synchronize()
    if (li.LAUNCHES, li.PLAIN_CALLS) != (1, 0):
        fail(f"K5 on the flipped half: {li.LAUNCHES} launches and "
             f"{li.PLAIN_CALLS} plain calls (expected 1 and 0)")
    for what, a, b in (("r", out_k, out_p), ("final c", fin_k.c, fin_p.c),
                       ("final r", fin_k.r, fin_p.r)):
        mx, rel, ok = errors(a, b)
        worst["K5"] = max(worst["K5"], mx)
        log(f"  [K5, BLSTM backward half S=8 T=1000, flipped input] {what}: "
            f"max_abs_err {mx:.3e} max_rel_err {rel:.3e} (tol "
            f"{KERNEL_ATOL:g} abs + {KERNEL_RTOL:g} rel)")
        if not ok or not bool(torch.isfinite(a).all()):
            fail(f"K5 on the flipped half: {what} disagrees with the plain "
                 f"version")
    with torch.inference_mode():
        k_ms = cuda_ms(lambda: li.lstm_infer(params, xf, st, 50.0))
        p_ms = cuda_ms(lambda: lstm_scan(params, xf, st, 50.0), reps=3)
    bound, by = lstm_bound_ms(8, 1000, I, C, R)
    log(f"  [K5, BLSTM backward half] kernel {k_ms:.3f} ms, plain "
        f"{p_ms:.3f} ms, bound {bound:.4f} ms ({by})")
    recs["K5"] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                  "bound_by": by}
    for k in recs:
        recs[k]["max_abs_err"] = worst[k]
    return recs


def utterance_buckets(feats: str, n: int, bucket: int = PERUTT_BUCKET
                      ) -> list:
    """The padded length of each of the first n utterances."""
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    out = []
    for _, m in kio.SequentialMatrixReader(feats):
        out.append(-(-m.shape[0] // bucket) * bucket)
        if len(out) == n:
            break
    return out


def perutt_prediction(buckets: list, directions: int) -> dict:
    """Launches of one perutt training epoch: per utterance and LSTM
    direction one K1 call (fwd_launches(T_b)) and one K2 call without dx
    (the first layer over the features), one K3 call (2 launches) and one
    K4 call (3)."""
    from kaldi_lstm_tpu_torch.ops.lstm_train import (
        bwd_launches,
        fwd_launches,
    )
    return {"lstmp_train_fwd": directions * sum(map(fwd_launches, buckets)),
            "lstmp_train_bwd": directions * sum(bwd_launches(T, False)
                                                for T in buckets),
            "xent_affine_fwd": 2 * len(buckets),
            "xent_affine_bwd": 3 * len(buckets)}


def perutt_cv(what: str, feats, post, model, n: int, directions: int):
    """Two perutt cross-validation passes of one model (one K5 launch
    per utterance and direction, one K3 call); they must agree to the
    last digit. Returns the LossStats."""
    from kaldi_lstm_tpu_torch.tools import nnet_train_perutt
    predicted = {"lstmp_infer": directions * n, "xent_affine_fwd": 2 * n}
    res = []
    for _ in range(2):
        out = {}

        def cv():
            rc, out["stats"] = nnet_train_perutt.run_main(
                [feats, post, model, "--cross-validate=true", "--device",
                 "cuda"])
            return rc
        counted(f"nnet_train_perutt --cross-validate ({what})", predicted,
                cv)
        res.append(out["stats"])
    log(f"  cross-validation twice on {what}: AvgLoss "
        f"{res[0].avg_loss()!r} and {res[1].avg_loss()!r}")
    if res[0].avg_loss() != res[1].avg_loss():
        fail(f"two cross-validation runs of {what} disagree")
    return res[0]


def padded_utterances(feats: str, post: str):
    """(feats, ids, weights, mask) of each utterance as nnet_train_perutt
    pads it: a [1, T] batch, T a multiple of PERUTT_BUCKET."""
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.tools.nnet_train_perutt import pad_utterance
    targets = kio.RandomAccessPosteriorReader(post)
    for key, m in kio.SequentialMatrixReader(feats):
        ids, w = targets.value_dense(key, 1)
        yield pad_utterance(m, ids, w, PERUTT_BUCKET)


def perutt_card_vs_cpu(what: str, model: str, feats: str, post: str,
                       n: int = 2) -> None:
    """The first n utterances trained on the card (K1-K4) against the
    same n on the port's CPU path (plain versions, unfused loss), from
    the same model: every parameter within STEP_ATOL + STEP_RTOL x |p|,
    the loss sums within 1e-5 relative, the frame counts exactly and the
    correct-frame counts within 2 frames."""
    import itertools
    import torch
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.train.optim import init_momentum
    from kaldi_lstm_tpu_torch.train.trainer import (
        TrainOptions,
        make_train_step,
    )
    from kaldi_lstm_tpu_torch.utils.tree import tree_leaves
    utts = list(itertools.islice(padded_utterances(feats, post), n))
    opts = TrainOptions(learn_rate=8e-5, momentum=0.9, grad_clip=50.0)
    res = {}
    for dev in ("cuda", "cpu"):
        nnet, params = Nnet.read(model, dev)
        step = make_train_step(nnet, opts, device=dev)
        opt = init_momentum(params)
        lr = torch.tensor(8e-5, device=dev)
        reset = torch.ones((1,), dtype=torch.int32, device=dev)
        auxs = []
        for u in utts:
            params, opt, _, aux = step(
                params, opt, nnet.init_states(1, dev), None,
                *(torch.from_numpy(a).to(dev) for a in u), reset, lr)
            auxs.append([float(a) for a in aux])
        res[dev] = (tree_leaves(params), auxs)
    worst = 0.0
    for a, b in zip(res["cuda"][0], res["cpu"][0]):
        d = (a.cpu() - b).abs()
        worst = max(worst, float(d.max()))
        if not bool((d <= STEP_ATOL + STEP_RTOL * b.abs()).all()):
            fail(f"{what}: {n} utterances on the card disagree with the "
                 f"CPU path (max_abs_err {float(d.max()):.3e})")
    for (xk, ek, ck, fk), (xc, ec, cc, fc) in zip(res["cuda"][1],
                                                  res["cpu"][1]):
        if not (abs(xk - xc) <= 1e-5 * abs(xc)
                and abs(ek - ec) <= 1e-5 * max(abs(ec), 1e-6)
                and fk == fc and abs(ck - cc) <= 2):
            fail(f"{what}: LossAux on the card {(xk, ek, ck, fk)} vs CPU "
                 f"{(xc, ec, cc, fc)}")
    log(f"  {what}: {n} utterances card vs CPU path: params max_abs_err "
        f"{worst:.3e} (tol {STEP_ATOL:g} + {STEP_RTOL:g} x |p|); LossAux "
        f"card {res['cuda'][1]} vs CPU {res['cpu'][1]}")


def perutt_step_times(model: str, feats: str, post: str) -> dict:
    """Warm per-utterance training steps on the card, timed one by one
    (host clock around a synchronized step), by bucket: {T_b: [ms]}; and
    a profile of one step at the largest bucket."""
    import torch
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.train.optim import init_momentum
    from kaldi_lstm_tpu_torch.train.trainer import (
        TrainOptions,
        make_train_step,
    )
    nnet, params = Nnet.read(model, "cuda")
    step = make_train_step(nnet, TrainOptions(learn_rate=8e-5,
                                              grad_clip=50.0),
                           device="cuda")
    opt = init_momentum(params)
    lr = torch.tensor(8e-5, device="cuda")
    reset = torch.ones((1,), dtype=torch.int32, device="cuda")
    by_bucket: dict = {}
    for u in padded_utterances(feats, post):
        if len(by_bucket.setdefault(u[0].shape[1], [])) < 4:
            by_bucket[u[0].shape[1]].append(
                [torch.from_numpy(a).cuda() for a in u])
        if len(by_bucket) == 3 and all(len(v) == 4
                                       for v in by_bucket.values()):
            break

    def run(u):
        nonlocal params, opt
        params, opt, _, _ = step(params, opt, nnet.init_states(1, "cuda"),
                                 None, *u, reset, lr)

    times = {}
    for T_b, us in sorted(by_bucket.items()):
        run(us[0])
        torch.cuda.synchronize()
        ms = []
        for u in us[1:]:
            t0 = time.perf_counter()
            run(u)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        times[T_b] = ms
    big = max(by_bucket)
    prof = profile(lambda: run(by_bucket[big][1]),
                   f"one per-utterance step at T={big}")
    return {"ms": times, "profile": prof}


def phase_perutt(work: str, feats: str, post: str) -> dict:
    """Phases 10b-10d: per-utterance training of the standard net and of
    the BLSTM through nnet_train_perutt, the BLSTM scored through
    nnet_forward and refused by the streaming classes, and nnet1's DNN
    through nnet_train_frmshuff. Returns the launches of each run."""
    from kaldi_lstm_tpu_torch.decode.online import (
        OnlineBatchScorer,
        OnlineRecognizer,
    )
    from kaldi_lstm_tpu_torch.decode.scoring import AmScorer
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.tools import (
        nnet_forward,
        nnet_initialize,
        nnet_train_perutt,
    )
    out = {}
    n_all = 256

    # 10b: the standard variant's trainer
    log("phase 10b: the standard variant's trainer (nnet_train_perutt "
        "--device cuda) on the full-width standard net")
    with open(f"{work}/standard.proto", "w") as f:
        f.write(PROTO)
    std0, std1 = f"{work}/standard.init", f"{work}/standard.iter1"
    if nnet_initialize.main([f"{work}/standard.proto", std0, "--seed", "0",
                             "--device", "cuda"]) != 0:
        fail("nnet_initialize of the standard net failed")
    buckets = utterance_buckets(feats, n_all)
    counts = {T: buckets.count(T) for T in sorted(set(buckets))}
    log(f"  corpus: {n_all} utterances, {sum(buckets)} padded frames, "
        f"buckets {counts}")
    cv0 = perutt_cv("the standard net, before", feats, post, std0, n_all, 1)
    predicted = perutt_prediction(buckets, 1)
    res = {}

    def train():
        rc, res["stats"] = nnet_train_perutt.run_main(
            [feats, post, std0, std1, "--device", "cuda"])
        return rc
    launches, wall = counted(
        f"nnet_train_perutt, {n_all} utterances of the standard net (incl. "
        f"model read, ark I/O, CUDA warm-up)", predicted, train)
    if launches["lstmp_infer"]:
        fail("the training pass launched K5")
    frames = res["stats"].frames
    log(f"  epoch: {frames:.0f} frames in {wall:.3f} s -> "
        f"{frames / wall:.1f} frames/s (whole CLI run); "
        f"{res['stats'].report().splitlines()[0]}")
    cv1 = perutt_cv("the standard net, after", feats, post, std1, n_all, 1)
    log(f"  cross-validation AvgLoss: before {cv0.avg_loss():.6f}, after "
        f"{cv1.avg_loss():.6f}")
    if not cv1.avg_loss() < cv0.avg_loss():
        fail("the standard net's CV AvgLoss did not fall after the epoch")
    nnet_r, params_r = Nnet.read(std1, "cpu")
    if [c.token for c in nnet_r.components] != [
            "<TimeShift>", "<LstmProjected>", "<AffineTransform>",
            "<Softmax>"]:
        fail("the trained standard model does not read back")
    perutt_card_vs_cpu("the standard net", std0, feats, post)
    st = perutt_step_times(std0, feats, post)
    for T_b, ms in st["ms"].items():
        log(f"  warm step at T={T_b}: {', '.join(f'{m:.3f}' for m in ms)} "
            f"ms -> median {statistics.median(ms):.3f} ms, "
            f"{T_b / statistics.median(ms) * 1e3:.1f} padded frames/s")
    out["standard"] = {"launches": launches, "wall": wall, "frames": frames,
                       "step_ms": {T: statistics.median(v)
                                   for T, v in st["ms"].items()},
                       "idle": (st["profile"] or {}).get("idle")}

    # 10c: the BLSTM
    log("phase 10c: the BLSTM (40 -> 2 x 800c/512r -> 8000) through "
        "nnet_train_perutt and nnet_forward")
    bfeats, bpost = f"ark:{work}/blstm_feats.ark", f"ark:{work}/blstm_post.ark"
    tgt = kio.RandomAccessPosteriorReader(post)
    with kio.MatrixWriter(bfeats) as fw, kio.PosteriorWriter(bpost) as pw:
        for i, (key, m) in enumerate(kio.SequentialMatrixReader(feats)):
            if i == BLSTM_UTTS:
                break
            fw.write(key, m)
            pw.write(key, tgt.value(key))
    with open(f"{work}/blstm.proto", "w") as f:
        f.write(BLSTM_PROTO)
    bl0, bl1 = f"{work}/blstm.init", f"{work}/blstm.iter1"
    if nnet_initialize.main([f"{work}/blstm.proto", bl0, "--seed", "0",
                             "--device", "cuda"]) != 0:
        fail("nnet_initialize of the BLSTM failed")
    bbuckets = buckets[:BLSTM_UTTS]
    bcv0 = perutt_cv("the BLSTM, before", bfeats, bpost, bl0, BLSTM_UTTS, 2)

    def btrain():
        rc, res["bstats"] = nnet_train_perutt.run_main(
            [bfeats, bpost, bl0, bl1, "--device", "cuda"])
        return rc
    blaunches, bwall = counted(
        f"nnet_train_perutt, {BLSTM_UTTS} utterances of the BLSTM (two K1 "
        f"and two K2 calls a step)", perutt_prediction(bbuckets, 2), btrain)
    bframes = res["bstats"].frames
    log(f"  epoch: {bframes:.0f} frames in {bwall:.3f} s -> "
        f"{bframes / bwall:.1f} frames/s (whole CLI run); "
        f"{res['bstats'].report().splitlines()[0]}")
    bcv1 = perutt_cv("the BLSTM, after", bfeats, bpost, bl1, BLSTM_UTTS, 2)
    log(f"  cross-validation AvgLoss: before {bcv0.avg_loss():.6f}, after "
        f"{bcv1.avg_loss():.6f}")
    if not bcv1.avg_loss() < bcv0.avg_loss():
        fail("the BLSTM's CV AvgLoss did not fall after the epoch")
    perutt_card_vs_cpu("the BLSTM", bl0, bfeats, bpost)
    bst = perutt_step_times(bl0, bfeats, bpost)
    for T_b, ms in bst["ms"].items():
        log(f"  BLSTM warm step at T={T_b}: median "
            f"{statistics.median(ms):.3f} ms ({len(ms)} steps)")
    # scoring: two K5 launches a batch of 8 (one per direction)
    scores = f"{work}/blstm_loglik.ark"
    n_batches = -(-BLSTM_UTTS // 8)
    blaunch_fwd, _ = counted(
        f"nnet_forward of the BLSTM ({BLSTM_UTTS} utterances, batches of 8)",
        {"lstmp_infer": 2 * n_batches},
        lambda: nnet_forward.main([bl1, bfeats, f"ark:{scores}",
                                   "--apply-log=true", "--device", "cuda"]))
    got = dict(kio.SequentialMatrixReader(f"ark:{scores}"))
    utts = dict(kio.SequentialMatrixReader(bfeats))
    if list(got) != list(utts) or any(
            got[k].shape != (utts[k].shape[0], 8000)
            or not np.isfinite(got[k]).all() for k in utts):
        fail("nnet_forward of the BLSTM wrote bad scores")
    nnet_c, params_c = Nnet.read(bl1, "cpu")
    cpu = AmScorer(nnet_c, params_c, apply_log=True, device="cpu")
    keys = list(utts)[:3]
    worst = max(float(np.abs(got[k] - y).max())
                for k, y in cpu.score_stream((k, utts[k]) for k in keys))
    log(f"  BLSTM scores card vs CPU path on 3 utterances: max_abs_err "
        f"{worst:.3e} (tol {SCORE_ATOL:g})")
    if worst > SCORE_ATOL:
        fail("the BLSTM's card scores disagree with the CPU path")
    nnet_g, params_g = Nnet.read(bl1, "cuda")
    for cls, args, msg in (
            (OnlineBatchScorer, (2,), "bidirectional nets cannot stream"),
            (OnlineRecognizer, (None,), "bidirectional nets cannot stream "
             "(the backward pass needs the whole utterance)")):
        try:
            cls(nnet_g, params_g, *args)
        except ValueError as e:
            if str(e) != msg:
                fail(f"{cls.__name__} refused the BLSTM with {e!r}")
            log(f"  {cls.__name__} refuses the BLSTM on the card: {e}")
        else:
            fail(f"{cls.__name__} accepted a BLSTM")
    out["blstm"] = {"launches": blaunches, "wall": bwall, "frames": bframes,
                    "score_launches": blaunch_fwd["lstmp_infer"],
                    "step_ms": {T: statistics.median(v)
                                for T, v in bst["ms"].items()},
                    "idle": (bst["profile"] or {}).get("idle")}

    log("phase 10d: nnet1's DNN (Splice +-5 -> 4 x 1024 sigmoid -> 8000) "
        "through nnet_train_frmshuff")
    out["dnn"] = phase_frmshuff(work, feats, post)
    return out


def phase_frmshuff(work: str, feats: str, post: str) -> dict:
    """Phase 10d: Kaldi steps/nnet/train.sh's default DNN through
    nnet_train_frmshuff with its CMVN + Splice feature transform
    (cmvn_to_nnet, nnet_initialize, nnet_concat)."""
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.tools import (
        cmvn_to_nnet,
        nnet_concat,
        nnet_initialize,
        nnet_train_frmshuff,
    )
    from kaldi_lstm_tpu_torch.train import randomizer
    from kaldi_lstm_tpu_torch.utils.tree import tree_leaves
    # the feature transform: global CMVN of the corpus, then the splice
    tot = np.zeros((2, 41))
    lengths = []
    for _, m in kio.SequentialMatrixReader(feats):
        m = m.astype(np.float64)
        tot[0, :40] += m.sum(0)
        tot[1, :40] += (m * m).sum(0)
        tot[0, 40] += m.shape[0]
        lengths.append(m.shape[0])
    with kio.MatrixWriter(f"ark:{work}/cmvn.ark") as w:
        w.write("global", tot.astype(np.float32))
    with open(f"{work}/splice.proto", "w") as f:
        f.write(f"<NnetProto>\n<Splice> <InputDim> 40 <OutputDim> "
                f"{40 * (2 * DNN_SPLICE + 1)} <LeftContext> {DNN_SPLICE} "
                f"<RightContext> {DNN_SPLICE}\n</NnetProto>\n")
    with open(f"{work}/dnn.proto", "w") as f:
        f.write(DNN_PROTO)
    transf, dnn0, dnn1 = (f"{work}/transf.nnet", f"{work}/dnn.init",
                          f"{work}/dnn.iter1")
    for what, rc in (
            ("cmvn_to_nnet", cmvn_to_nnet.main([f"ark:{work}/cmvn.ark",
                                                f"{work}/cmvn.nnet"])),
            ("nnet_initialize (splice)", nnet_initialize.main(
                [f"{work}/splice.proto", f"{work}/splice.nnet", "--device",
                 "cuda"])),
            ("nnet_concat", nnet_concat.main([f"{work}/cmvn.nnet",
                                              f"{work}/splice.nnet",
                                              transf])),
            ("nnet_initialize (DNN)", nnet_initialize.main(
                [f"{work}/dnn.proto", dnn0, "--seed", "0", "--device",
                 "cuda"]))):
        if rc != 0:
            fail(f"{what} failed")
    common = [f"--feature-transform={transf}",
              f"--minibatch-size={DNN_MINIBATCH}",
              f"--randomizer-size={DNN_RANDOMIZER}", "--device", "cuda"]
    frames = sum(lengths)
    windows = [min(DNN_RANDOMIZER, frames - lo)
               for lo in range(0, frames, DNN_RANDOMIZER)]
    steps = sum(-(-w // DNN_MINIBATCH) for w in windows)
    predicted = {"xent_affine_fwd": 2 * steps, "xent_affine_bwd": 3 * steps}
    log(f"  corpus: {frames} frames in windows {windows} -> {steps} "
        f"minibatches of {DNN_MINIBATCH}")

    def cv(model):
        out = {}

        def run():
            rc, out["stats"] = nnet_train_frmshuff.run_main(
                [feats, post, model, "--cross-validate=true"] + common)
            return rc
        counted(f"nnet_train_frmshuff --cross-validate ({model})",
                {"xent_affine_fwd": 2 * steps}, run)
        return out["stats"]
    cv0 = cv(dnn0)
    # record every drained minibatch, in order (a digest of its arrays)
    drained: list = []
    orig = randomizer.FrameRandomizer.drain

    def recording(self):
        for b in orig(self):
            drained.append(hashlib.sha256(b"".join(
                a.tobytes() for a in b)).hexdigest())
            yield b
    res = {}

    def train():
        rc, res["stats"] = nnet_train_frmshuff.run_main(
            [feats, post, dnn0, dnn1] + common)
        return rc
    randomizer.FrameRandomizer.drain = recording
    try:
        launches, wall = counted(
            f"nnet_train_frmshuff, one epoch ({steps} minibatches)",
            predicted, train)
    finally:
        randomizer.FrameRandomizer.drain = orig
    stats = res["stats"]
    log(f"  epoch: {stats.frames:.0f} frames in {wall:.3f} s -> "
        f"{stats.frames / wall:.1f} frames/s (whole CLI run); "
        f"{stats.report().splitlines()[0]}")
    if len(drained) != steps:
        fail(f"{len(drained)} minibatches drained, {steps} predicted")
    cv1 = cv(dnn1)
    log(f"  cross-validation AvgLoss: before {cv0.avg_loss():.6f}, after "
        f"{cv1.avg_loss():.6f}")
    if not cv1.avg_loss() < cv0.avg_loss():
        fail("the DNN's CV AvgLoss did not fall after the epoch")
    # --randomize false on the first utterances: the same minibatches in
    # the same order on the card and on the CPU path, and the same model
    sub = f"ark:{work}/dnn_check.ark"
    with kio.MatrixWriter(sub) as w:
        for i, (k, m) in enumerate(kio.SequentialMatrixReader(feats)):
            if i == DNN_CHECK_UTTS:
                break
            w.write(k, m)
    orders, models = {}, {}
    for dev in ("cuda", "cpu"):
        drained.clear()
        randomizer.FrameRandomizer.drain = recording
        try:
            rc = nnet_train_frmshuff.main(
                [sub, post, dnn0, f"{work}/dnn.{dev}", "--randomize=false"]
                + common[:-1] + [dev])
        finally:
            randomizer.FrameRandomizer.drain = orig
        if rc != 0:
            fail(f"nnet_train_frmshuff --randomize false on {dev} exited "
                 f"{rc}")
        orders[dev] = list(drained)
        models[dev] = tree_leaves(Nnet.read(f"{work}/dnn.{dev}", "cpu")[1])
    if orders["cuda"] != orders["cpu"] or not orders["cpu"]:
        fail("--randomize false: the card's minibatches differ from the "
             "CPU path's")
    worst = 0.0
    for a, b in zip(models["cuda"], models["cpu"]):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        if not bool((d <= STEP_ATOL + STEP_RTOL * b.abs()).all()):
            fail("--randomize false: the card's DNN disagrees with the CPU "
                 "path's")
    log(f"  --randomize false on {DNN_CHECK_UTTS} utterances: "
        f"{len(orders['cpu'])} minibatches, the same digests in the same "
        f"order on the card and the CPU path; params max_abs_err "
        f"{worst:.3e} (tol {STEP_ATOL:g} + {STEP_RTOL:g} x |p|)")
    return {"launches": launches, "wall": wall, "frames": stats.frames,
            "minibatches": steps}


# ---------------------------------------------------------------------------
# phase 11: sequence training in phase 7's work directory, on its AM,
# transition model and corpus, with phase 9's realignments
# ---------------------------------------------------------------------------

# the recipe's sMBR stage (examples/flagship_experiment.sh:286-294); the
# lattice-free MMI trainer takes the same flags
SEQ_BUCKET = 64
SEQ_FLAGS = ["--learn-rate", "1e-5", "--acoustic-scale", "1.0",
             "--length-bucket", str(SEQ_BUCKET)]
SEQ_LR = 1e-5
SEQ_UTTS = 32          # of phase 9's 64 realignments (a time cut)
SEQ_CPU_UTTS = 2
SEQ_TIMED = 2          # warm steps timed per bucket, after one warm-up
SEQ_TIME_BUCKETS = (128, 256, 512)   # the buckets whose steps are timed
# card vs CPU: per-utterance statistic within SEQ_STAT_RTOL of max(its
# value, the utterance's frames);
# each utterance's gradients within SEQ_GRAD_RTOL of their largest entry
# and each parameter after the updates within STEP_ATOL + STEP_RTOL x |p|
# (K1/K2 and the card's logsumexp sum in other orders than the plain
# versions; the den graph's 7998-state sums round ~1e-7 apart, and E[A]'s
# gradient gamma * (acc - E[A]) cancels where acc is near E[A])
SEQ_STAT_RTOL = 1e-4
SEQ_GRAD_RTOL = 1e-2
# the lattice trainers' loglik and diff rows, card vs CPU
SEQ_LAT_ATOL = 1e-3


def first_number(pattern: str, text: str) -> float:
    import re
    m = re.search(pattern + r"\s*(-?[0-9.]+(?:e[-+]?\d+)?)", text)
    if m is None:
        fail(f"no {pattern!r} in the tool's log")
    return float(m.group(1))


def run_logged(main, argv) -> tuple[int, str]:
    """main(argv) with its stderr captured; its LOG and ERROR lines are
    echoed into this log."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        rc = main(argv)
    text = buf.getvalue()
    for ln in text.splitlines():
        if ln.startswith(("LOG", "ERROR")):
            log(f"    | {ln}")
    return rc, text


def counted_only(what: str, predicted: dict, main, argv
                 ) -> tuple[dict, float, str]:
    """`counted` on main(argv), and no kernel outside `predicted`
    launched. Returns (the counts, the wall seconds, the tool's log)."""
    out = {}

    def call():
        rc, out["log"] = run_logged(main, argv)
        return rc
    from kaldi_lstm_tpu_torch.ops.counts import launch_counts
    got, wall = counted(what, predicted, call)
    # the launch counters only: the program's own (epoch.*, score.*, ...)
    # count work, not kernels
    others = {k: got[k] for k in launch_counts() if got[k]
              and k not in predicted and not k.startswith("plain.")}
    if others:
        fail(f"{what} launched kernels outside the prediction: {others}")
    return got, wall, out["log"]


def seq_prediction(buckets: list, k5: int = 0) -> dict:
    """Launches of a sequence-training pass: per utterance one K1 call
    (fwd_launches(T_b)) and one K2 call without dx (the LSTM sits on the
    features); `k5` K5 launches besides (the lattice trainers' loglik)."""
    from kaldi_lstm_tpu_torch.ops.lstm_train import (
        bwd_launches,
        fwd_launches,
    )
    out = {"lstmp_train_fwd": sum(map(fwd_launches, buckets)),
           "lstmp_train_bwd": sum(bwd_launches(T, False) for T in buckets)}
    if k5:
        out["lstmp_infer"] = k5
    return out


def seq_batches(feats: str, targets, n: int | None = None) -> list:
    """(key, [feats, targets, mask] padded as the lattice-free trainers
    pad them) of the first n utterances; targets(key, tids) gives each
    utterance's per-frame targets."""
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.tools.nnet_train_mmi import pad_utterance
    out = []
    for key, m in kio.SequentialMatrixReader(feats):
        out.append((key, pad_utterance(m, targets(key), SEQ_BUCKET)))
        if len(out) == n:
            break
    return out


def seq_card_vs_cpu(what: str, model: str, tm, objective_for,
                    batches: list) -> dict:
    """The first utterances trained on the card and on the port's CPU
    path from the same model (one update each, momentum 0): the
    per-utterance statistic, each utterance's gradients (the update
    itself sits below the weights' float32 resolution at lr 1e-5) and
    the parameters after the updates."""
    import torch
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.tools.nnet_train_mmi import make_sequence_step
    from kaldi_lstm_tpu_torch.train.optim import init_momentum, \
        momentum_update
    from kaldi_lstm_tpu_torch.train.sequence import den_graph_for
    from kaldi_lstm_tpu_torch.utils.tree import tree_leaves
    res = {}
    for dev in ("cuda", "cpu"):
        nnet, params = Nnet.read(model, dev)
        step = make_sequence_step(nnet, None, None, None,
                                  objective_for(den_graph_for(tm, device=dev)),
                                  False)
        opt = init_momentum(params)
        stats, grads_seen = [], []
        t0 = time.perf_counter()
        for _, b in batches:
            _, stat, grads = step(params, *(torch.from_numpy(a).to(dev)
                                            for a in b))
            grads_seen.append([g.cpu() for g in tree_leaves(grads)])
            momentum_update(params, grads, opt, SEQ_LR, 0.0, 0.0)
            stats.append(float(stat[0]))
        res[dev] = (tree_leaves(params), stats, grads_seen,
                    time.perf_counter() - t0)
    (p_g, s_g, g_g, t_g), (p_c, s_c, g_c, t_c) = res["cuda"], res["cpu"]
    worst = grad_err = grad_max = 0.0
    for pg, pc in zip(p_g, p_c):
        d = (pg.cpu() - pc).abs()
        worst = max(worst, float(d.max()))
        if not bool((d <= STEP_ATOL + STEP_RTOL * pc.abs()).all()):
            fail(f"{what}: parameters on the card disagree with the CPU "
                 f"path (max_abs_err {float(d.max()):.3e})")
    for gg, gc in zip(g_g, g_c):
        for a, b in zip(gg, gc):
            grad_err = max(grad_err, float((a - b).abs().max()))
            grad_max = max(grad_max, float(b.abs().max()))
    # MMI's den - num cancels two sums of the utterance's frames, so the
    # scale of the statistic is the utterance's frames, not its value
    stat_err = max(abs(a - b) / max(abs(b), float(bt[2].sum()))
                   for a, b, (_, bt) in zip(s_g, s_c, batches))
    log(f"  {what}: {len(batches)} utterances on the card ({t_g:.3f} s) "
        f"against the CPU path ({t_c:.3f} s): statistic card {s_g} vs CPU "
        f"{s_c} (largest difference over max(|value|, frames) "
        f"{stat_err:.3e}, tol {SEQ_STAT_RTOL:g}); gradients max_abs_err "
        f"{grad_err:.3e} of a "
        f"largest entry {grad_max:.3e} (tol {SEQ_GRAD_RTOL:g} of it); "
        f"params after the updates max_abs_err {worst:.3e} (tol "
        f"{STEP_ATOL:g} + {STEP_RTOL:g} x |p|)")
    if not all(np.isfinite(s_g)) or stat_err > SEQ_STAT_RTOL:
        fail(f"{what}: the card's per-utterance statistic disagrees with "
             f"the CPU path's")
    if grad_max <= 0 or grad_err > SEQ_GRAD_RTOL * grad_max:
        fail(f"{what}: the card's gradients disagree with the CPU path's")
    return {"stat_rel_err": stat_err, "param_err": worst,
            "grad_err": grad_err, "grad_max": grad_max}


def seq_step_split(what: str, model: str, tm, objective_for,
                   batches: list) -> dict:
    """Warm steps on the card at SEQ_TIME_BUCKETS, split into the net
    (K1 + K2, the affine and the log-softmax: the forward and a backward
    from a fixed cotangent) and the den-graph part (the objective on a
    fixed loglik and its gradient, the second-order pass for sMBR); a
    profile of one step at the largest of them (launches, idle share)."""
    import torch
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.tools.nnet_train_mmi import make_sequence_step
    from kaldi_lstm_tpu_torch.train.optim import init_momentum, \
        momentum_update
    from kaldi_lstm_tpu_torch.train.sequence import den_graph_for
    from kaldi_lstm_tpu_torch.utils.tree import tree_leaves, tree_map
    nnet, params = Nnet.read(model, "cuda")
    objective = objective_for(den_graph_for(tm, device="cuda"))
    step = make_sequence_step(nnet, None, None, None, objective, False)
    opt = init_momentum(params)
    by_bucket: dict = {}
    for _, b in batches:
        T = b[0].shape[1]
        if T in SEQ_TIME_BUCKETS and \
                len(by_bucket.setdefault(T, [])) < SEQ_TIMED + 1:
            by_bucket[T].append([torch.from_numpy(a).to("cuda") for a in b])

    def full(b):
        _, _, grads = step(params, *b)
        momentum_update(params, grads, opt, SEQ_LR, 0.0, 0.0)

    def net(b):
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            logits, _ = nnet.propagate(live, b[0],
                                       nnet.init_states(1, "cuda"),
                                       logits=True)
            ll = torch.log_softmax(logits, dim=-1)
            torch.autograd.grad(ll, tree_leaves(live),
                                grad_outputs=torch.full_like(ll, 1e-3),
                                allow_unused=True)
        return ll.detach()

    def den(b, ll):
        x = ll.clone().requires_grad_(True)
        with torch.enable_grad():
            obj, _ = objective(x, b[1], b[2])
            torch.autograd.grad(obj, x)

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*a)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    rows = {}
    for T, bs in sorted(by_bucket.items()):
        if len(bs) < 2:
            continue
        full(bs[0])
        den(bs[0], net(bs[0]))
        ms = {"step": [], "net": [], "den": []}
        for b in bs[1:]:
            ms["step"].append(timed(full, b))
            ll = net(b)
            ms["net"].append(timed(net, b))
            ms["den"].append(timed(den, b, ll))
        med = {k: statistics.median(v) for k, v in ms.items()}
        rows[T] = med
        log(f"  {what} warm step at T={T} ({len(bs) - 1} timed): "
            f"{med['step']:.3f} ms; the net (K1+K2, affine, log-softmax) "
            f"{med['net']:.3f} ms, the den-graph recursion with its "
            f"backward{' and second-order pass' if 'sMBR' in what else ''}"
            f" {med['den']:.3f} ms: den-graph share "
            f"{med['den'] / (med['net'] + med['den']):.3f}")
    if not rows:
        fail(f"{what}: no bucket held two utterances to time")
    big = max(rows)
    prof = profile(lambda: full(by_bucket[big][1]),
                   f"one {what} step at T={big}", rows=6)
    if prof is not None:
        log(f"    {prof['kernels']} kernel launches in the step, "
            f"{1e3 * prof['busy_ms'] / max(prof['kernels'], 1):.2f} us of "
            f"kernel time each")
    return {"ms": rows, "profile": prof}


def phase_sequence(work: str, p7: dict, p9: dict) -> dict:
    """Phase 11: the sequence trainers on phase 7's AM and transition
    model: 11a `nnet_train_smbr` as the recipe runs it on phase 9's
    realignments, 11b `nnet_train_mmi` on the same, 11c the lattice
    trainers on phase 7's determinized lattices with priors from the
    ported posterior and count tools, 11d the den-graph functions on the
    card against the CPU. Returns the launches and times."""
    import torch
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.train.sequence import (
        PhoneLoopDenGraph,
        alignment_to_states,
        den_graph_for,
        mmi_objective,
        smbr_objective,
    )
    from kaldi_lstm_tpu_torch.tools import nnet_train_mmi, nnet_train_smbr
    from kaldi_lstm_tpu_torch.utils.tree import tree_leaves

    lang, final = p7["lang"], p7["final"]
    mdl = f"{lang}/final.mdl"
    feats, ali_path = p9["feats"], p9["ali"]
    tm = TransitionModel.load(mdl)
    graph = den_graph_for(tm, device="cuda")
    ns = int(graph.state_pdf.shape[0])
    log(f"  den_graph_for picked {type(graph).__name__}, Ns {ns} (the "
        f"transition model's {len(tm.tuples)} tuples, {tm.num_pdfs} pdfs)")
    if not isinstance(graph, PhoneLoopDenGraph) or ns != LVCSR_PDFS:
        fail(f"expected the structured phone loop with Ns {LVCSR_PDFS}")
    alis = dict(kio.SequentialIntVectorReader(f"ark:{ali_path}"))
    with open(feats.split(":", 1)[1]) as f:
        lines = f.read().splitlines()
    feats = "scp:" + os.path.join(work, "seq_train.scp")
    with open(feats[4:], "w") as f:
        f.write("\n".join(lines[:SEQ_UTTS]) + "\n")
    lens = [m.shape[0] for _, m in kio.SequentialMatrixReader(feats)]
    buckets = [-(-L // SEQ_BUCKET) * SEQ_BUCKET for L in lens]
    n = len(lens)
    log(f"  cuts: 11a/11b train on the first {n} of phase 9's {len(lines)} "
        f"realigned utterances (the recipe: KLT_NSEQ = 400; a time cut: "
        f"a 64-utterance sMBR pass took 51 s) for one iteration; the card "
        f"against the CPU on {SEQ_CPU_UTTS}; 11c on phase 7's "
        f"{DECODE_LAT_UTTS} lattices; {sum(lens)} frames, buckets "
        f"{ {T: buckets.count(T) for T in sorted(set(buckets))} }")
    out = {}

    tools = (
        ("11a", "sMBR", nnet_train_smbr.main, r"ExpectedSMBRAccuracy/frame:",
         lambda key: tm.transition_ids_to_pdfs(alis[key]),
         lambda g: lambda ll, refs, mask: smbr_objective(
             g, ll, refs, mask, 1.0)),
        ("11b", "MMI", nnet_train_mmi.main, r"AvgMMI\(den-num\)/frame:",
         lambda key: alignment_to_states(tm, alis[key]),
         lambda g: lambda ll, states, mask: mmi_objective(
             g, ll, states, mask, 1.0)))
    for tag, name, main, stat_re, targets, objective_for in tools:
        log(f"phase {tag}: {name} (nnet_train_{name.lower()} --device cuda"
            f" {' '.join(SEQ_FLAGS)}) on phase 7's AM")
        base = [feats, f"ark:{ali_path}", mdl]
        model = os.path.join(work, f"nnet.{name.lower()}")
        rec = out[name] = {}
        cv = {}
        for when, m in (("before", final), ("after", model)):
            if when == "after":
                got, wall, text = counted_only(
                    f"nnet_train_{name.lower()}, one iteration on {n} "
                    f"utterances", seq_prediction(buckets), main,
                    base + [final, model] + SEQ_FLAGS + ["--device", "cuda"])
                rec.update(launches=got, wall_s=wall,
                           fps=sum(lens) / wall,
                           train_stat=first_number(stat_re, text))
                log(f"    {sum(lens) / wall:.1f} frames/s")
            got, _, text = counted_only(
                f"nnet_train_{name.lower()} --cross-validate=true ({when})",
                {"lstmp_infer": n}, main, base + [m, "--cross-validate=true"]
                + SEQ_FLAGS + ["--device", "cuda"])
            cv[when] = first_number(stat_re, text)
            rec[f"cv_launches_{when}"] = got["lstmp_infer"]
        log(f"  {name}: cross-validation {stat_re.replace(chr(92), '')} "
            f"before {cv['before']!r}, after {cv['after']!r} (not gated: "
            f"one iteration at lr {SEQ_LR:g})")
        if not (np.isfinite(cv["before"]) and np.isfinite(cv["after"])):
            fail(f"{name}: a cross-validation figure is not finite")
        nnet, params = Nnet.read(model, "cpu")
        if nnet.output_dim != tm.num_pdfs or not all(
                bool(torch.isfinite(p).all()) for p in tree_leaves(params)):
            fail(f"{name}: the trained model does not read back whole")
        rec["cv"] = cv
        batches = seq_batches(feats, targets)
        rec["card_vs_cpu"] = seq_card_vs_cpu(
            f"{name}, card vs CPU", final, tm, objective_for,
            batches[:SEQ_CPU_UTTS])
        rec["steps"] = seq_step_split(name, final, tm, objective_for,
                                      batches)

    out["lattice"] = phase_sequence_lattice(work, p7, tm)
    log("phase 11d: the den-graph functions on the card against the CPU "
        "(three graph types, small sizes)")
    seq_graph_functions()
    return out


def phase_sequence_lattice(work: str, p7: dict, tm) -> dict:
    """Phase 11c: priors through the ported ali_to_pdf -> ali_to_post ->
    compute_class_counts (the recipe's way), then nnet_train_mmi_sequential
    and nnet_train_mpe_sequential on phase 7's determinized lattices."""
    import argparse
    import itertools
    import torch
    from kaldi_lstm_tpu_torch.decode.scoring import read_class_frame_counts
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.io.lattice import SequentialLatticeReader
    from kaldi_lstm_tpu_torch.train.sequence_lattice import mmi_errors
    from kaldi_lstm_tpu_torch.tools import (
        ali_to_pdf,
        ali_to_post,
        compute_class_counts,
        nnet_train_mmi_sequential as mmi_seq,
        nnet_train_mpe_sequential as mpe_seq,
    )
    lang, final = p7["lang"], p7["final"]
    mdl = f"{lang}/final.mdl"
    log("phase 11c: lattice-based MMI and MPE (nnet_train_mmi_sequential, "
        "nnet_train_mpe_sequential --device cuda) on phase 7's lattices")
    with open(f"{lang}/feats.scp") as f:
        train_keys = {ln.split()[0] for ln in
                      f.read().splitlines()[:DECODE_TRAIN_UTTS]}
    ali_tr = os.path.join(work, "ali_train.ark")
    with kio.TableWriter(f"ark:{ali_tr}", kio.write_int_vector) as w:
        for k, a in kio.SequentialIntVectorReader(f"ark:{lang}/ali.ark"):
            if k in train_keys:
                w.write(k, a)
    pdf_tr, post_tr = (os.path.join(work, n) for n in
                       ("pdf_train.ark", "post_train.ark"))
    counts = os.path.join(work, "counts_seq.vec")
    t0 = time.perf_counter()
    for what, rc in (
            ("ali_to_pdf", ali_to_pdf.main([mdl, f"ark:{ali_tr}",
                                            f"ark:{pdf_tr}"])),
            ("ali_to_post", ali_to_post.main([f"ark:{pdf_tr}",
                                              f"ark:{post_tr}"])),
            ("compute_class_counts", compute_class_counts.main(
                [f"ark:{post_tr}", counts, "--num-classes",
                 str(tm.num_pdfs), "--counts-offset", "1"]))):
        if rc != 0:
            fail(f"{what} exited {rc}")
    mine = read_class_frame_counts(counts)
    if not np.array_equal(mine, read_class_frame_counts(p7["counts"])):
        fail("the ported count tools' priors differ from phase 7's counts")
    log(f"  priors: ali_to_pdf -> ali_to_post -> compute_class_counts "
        f"--counts-offset 1 on the {len(train_keys)} training utterances "
        f"({time.perf_counter() - t0:.3f} s): equal to phase 7's counts.vec "
        f"({int(mine.sum())} frames + one per pdf)")

    feats = f"scp:{work}/lattice.scp"
    lats = f"ark:{work}/lat_fused.ark"
    lens = {k: m.shape[0] for k, m in kio.SequentialMatrixReader(feats)}
    buckets = [-(-L // SEQ_BUCKET) * SEQ_BUCKET for L in lens.values()]
    arcs = sum(v.num_arcs() for _, v in SequentialLatticeReader(lats))
    log(f"  {len(lens)} utterances, {sum(lens.values())} frames, "
        f"{arcs} compact-lattice arcs")
    base = [feats, lats, f"ark:{lang}/ali.ark", mdl]
    flags = ["--class-frame-counts", counts, "--learn-rate", str(SEQ_LR),
             "--length-bucket", str(SEQ_BUCKET)]
    out = {}
    for name, main, extra, overall in (
            ("mmi_sequential", mmi_seq.main, [],
             r"Overall MMI-objective/frame:"),
            ("mpe_sequential", mpe_seq.main, [],
             r"Overall expected-MPE-accuracy/frame:")):
        model = os.path.join(work, f"nnet.{name}")
        got, wall, text = counted_only(
            f"nnet_train_{name}, one iteration on {len(lens)} lattices",
            seq_prediction(buckets, k5=len(lens)), main,
            base + [final, model] + flags + extra + ["--device", "cuda"])
        import re
        done = re.search(r"Done (\d+) files, (\d+) with no alignment, "
                         r"(\d+) with no lattice, (\d+) with other errors",
                         text)
        if done is None or sum(map(int, done.groups())) != len(lens):
            fail(f"{name}: not every utterance was counted as done or "
                 f"skipped: {done and done.group(0)}")
        obj = first_number(overall, text)
        line = re.search(r"Overall .*", text).group(0)
        log(f"  {name}: {line.split(': ', 1)[1]}; {done.group(0)}; "
            f"{wall:.3f} s")
        if not np.isfinite(obj):
            fail(f"{name}: the objective is not finite")
        out[name] = {"launches": got, "wall_s": wall, "objective": obj}

    # the card against the CPU: the loglik and the MMI diff rows
    p = argparse.ArgumentParser()
    mmi_seq.add_common_args(p)
    res = {}
    for dev in ("cuda", "cpu"):
        args = p.parse_args(base + [final, "--cross-validate=true"] + flags
                            + ["--device", dev])
        r = mmi_seq.SequentialRunner(args, torch.device(dev))
        rows = []
        for key, m, tids, lat in itertools.islice(r.utterances(),
                                                  SEQ_CPU_UTTS):
            ll = r.loglik(r.pad(m), m.shape[0])
            _, diff, _, _ = mmi_errors(lat, r.tm, tids, ll, 0.1)
            rows.append((ll, diff))
        res[dev] = rows
    ll_err = max(float(np.abs(a[0] - b[0]).max())
                 for a, b in zip(res["cuda"], res["cpu"]))
    diff_err = max(float(np.abs(a[1] - b[1]).max())
                   for a, b in zip(res["cuda"], res["cpu"]))
    log(f"  card vs CPU on {SEQ_CPU_UTTS} lattices: loglik max_abs_err "
        f"{ll_err:.3e}, MMI diff rows max_abs_err {diff_err:.3e} (tol "
        f"{SEQ_LAT_ATOL:g} each)")
    if ll_err > SEQ_LAT_ATOL or diff_err > SEQ_LAT_ATOL:
        fail("the lattice trainers' loglik or diff on the card disagree "
             "with the CPU path")
    out["card_vs_cpu"] = {"loglik_err": ll_err, "diff_err": diff_err}
    return out


# phase 12: the flagship recipe's front end (examples/flagship_experiment.sh
# :72-95) from wav, in phase 7's work directory on its final.mdl (7998
# pdfs) and ali.ark: the port's synth_wavs -> wav_to_duration ->
# compute_fbank_feats --num-mel-bins 40 -> compute_cmvn_transform (train
# part) -> ali_to_pdf -> ali_to_post -> train_lstm_streams --device cuda
# --feature-transform (one epoch, CV before and after) -> nnet_forward
# --device cuda --feature-transform on the CV part. Most of the phase is
# host work: 256 utterances (853 audio-s) took 11.2 s to synthesize and
# 2.2 s of fbank on one of the card's machines, 20 s for the phase. The
# rate is the recipe's (flagship_experiment.sh:153, 3e-4 at 256 streams;
# here 64 streams, so a quarter of its frames a step); at phase 5's 2e-5
# an epoch on 160 utterances moved the CV AvgLoss only 8.9869 -> 8.9822.
FROMWAV_UTTS = 256
FROMWAV_CV = 32
FROMWAV_S = 64
FROMWAV_LR = 3e-4
FROMWAV_CPU_UTTS = 3


def phase_from_wav(work: str) -> dict:
    """Phase 12: the front end on the host and the AM on the card, from
    wav to scores; returns the K1-K5 launches of its CV, training and
    scoring runs."""
    import torch
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.ops.lstm_train import (
        bwd_launches,
        fwd_launches,
    )
    from kaldi_lstm_tpu_torch.tools import (
        ali_to_pdf,
        ali_to_post,
        compute_cmvn_transform,
        compute_fbank_feats,
        nnet_forward,
        synth_wavs,
        train_lstm_streams,
        wav_to_duration,
    )
    from kaldi_lstm_tpu_torch.train.streams import StreamScheduler

    t_phase = time.perf_counter()
    lang = os.path.join(work, "lang")
    d = os.path.join(work, "fromwav")
    os.makedirs(d)
    mdl = f"{lang}/final.mdl"
    lens = {}
    with kio.TableWriter(f"ark:{d}/ali.ark", kio.write_int_vector) as w:
        for key, ali in kio.SequentialIntVectorReader(f"ark:{lang}/ali.ark"):
            w.write(key, ali)
            lens[key] = len(ali)
            if len(lens) == FROMWAV_UTTS:
                break
    log(f"  cuts: the first {len(lens)} of phase 7's utterances "
        f"({FROMWAV_UTTS - FROMWAV_CV} to train, the last {FROMWAV_CV} for "
        f"CV and scoring; the recipe renders all 10240), one epoch")

    def step(what, main, argv):
        t0 = time.perf_counter()
        rc = main(argv)
        dt = time.perf_counter() - t0
        if rc != 0:
            fail(f"{what} exited {rc}")
        return dt

    t_synth = step("synth_wavs", synth_wavs.main,
                   [mdl, f"ark:{d}/ali.ark", f"{d}/wav"])
    step("wav_to_duration", wav_to_duration.main,
         [f"scp:{d}/wav/wav.scp", f"ark,t:{d}/dur.txt"])
    with open(f"{d}/dur.txt") as f:
        dur = {ln.split()[0]: float(ln.split()[1]) for ln in f if ln.strip()}
    audio_s = sum(dur.values())
    t_fbank = step("compute_fbank_feats", compute_fbank_feats.main,
                   [f"scp:{d}/wav/wav.scp",
                    f"ark,scp:{d}/fbank.ark,{d}/fbank.scp",
                    "--num-mel-bins", "40"])
    feats = dict(kio.SequentialMatrixReader(f"scp:{d}/fbank.scp"))
    frames = sum(m.shape[0] for m in feats.values())
    log(f"  synth_wavs: {len(dur)} wavs, {audio_s:.1f} audio-s "
        f"({audio_s / 3600:.4f} h) in {t_synth:.3f} s; compute_fbank_feats "
        f"(host numpy): {frames} frames in {t_fbank:.3f} s -> "
        f"{frames / t_fbank:.1f} frames/s")
    if list(feats) != list(lens):
        fail(f"fbank keys differ from the alignments': {len(feats)} of "
             f"{len(lens)}")
    for k, m in feats.items():
        if m.shape != (lens[k], 40) or not np.isfinite(m).all():
            fail(f"{k}: fbank {m.shape} against {lens[k]} alignment "
                 f"frames x 40, or non-finite values")
    log(f"  every utterance's fbank frames equal its alignment length; "
        f"dim 40, all finite")

    with open(f"{d}/fbank.scp") as f:
        lines = f.readlines()
    with open(f"{d}/tr.scp", "w") as f:
        f.writelines(lines[:-FROMWAV_CV])
    with open(f"{d}/cv.scp", "w") as f:
        f.writelines(lines[-FROMWAV_CV:])
    transf = f"{d}/feature_transform.nnet"
    step("compute_cmvn_transform", compute_cmvn_transform.main,
         [f"scp:{d}/tr.scp", transf])
    step("ali_to_pdf", ali_to_pdf.main,
         [mdl, f"ark:{d}/ali.ark", f"ark:{d}/pdf.ark"])
    step("ali_to_post", ali_to_post.main,
         [f"ark:{d}/pdf.ark", f"ark:{d}/post.ark"])
    post = f"ark:{d}/post.ark"

    model_in, model_out = f"{d}/am.init", f"{d}/am.iter1"
    nnet, params = Nnet.init_from_proto(
        LVCSR_PROTO, torch.Generator().manual_seed(0), "cuda")
    nnet.write(model_in, params, binary=True)
    common = [f"--num-stream={FROMWAV_S}", f"--batch-size={TRAIN_T}",
              "--targets-delay=0", f"--feature-transform={transf}",
              "--device", "cuda"]

    def steps_of(scp):
        return len(list(StreamScheduler(
            kio.SequentialMatrixReader(scp),
            kio.RandomAccessPosteriorReader(post), 40, FROMWAV_S, TRAIN_T,
            0)))
    tr_steps, cv_steps = steps_of(f"scp:{d}/tr.scp"), steps_of(
        f"scp:{d}/cv.scp")
    T = TRAIN_T
    train_pred = {"lstmp_train_fwd": fwd_launches(T) * tr_steps,
                  "lstmp_train_bwd": bwd_launches(T, False) * tr_steps,
                  "xent_affine_fwd": 2 * tr_steps,
                  "xent_affine_bwd": 3 * tr_steps}
    cv_pred = {"lstmp_infer": cv_steps, "xent_affine_fwd": 2 * cv_steps}
    launches = {}

    def only(what, got, predicted):
        extra = {k: got[k] for k in ("lstmp_train_fwd", "lstmp_train_bwd",
                                     "xent_affine_fwd", "xent_affine_bwd",
                                     "lstmp_infer") if k not in predicted
                 and got[k]}
        if extra:
            fail(f"{what} launched kernels outside the prediction: {extra}")
        for k, v in got.items():
            if not k.startswith("plain."):
                launches[k] = launches.get(k, 0) + v

    res = {}

    def cv(model, tag):
        def run():
            rc, res[tag] = train_lstm_streams.run_main(
                [f"scp:{d}/cv.scp", post, model, "--cross-validate=true"]
                + common)
            return rc
        got, _ = counted(f"train_lstm_streams --cross-validate=true "
                         f"--feature-transform ({tag}, {cv_steps} steps)",
                         cv_pred, run)
        only(f"the CV pass {tag}", got, cv_pred)

    def train():
        rc, res["train"] = train_lstm_streams.run_main(
            [f"scp:{d}/tr.scp", post, model_in, model_out,
             f"--learn-rate={FROMWAV_LR}", "--momentum=0.9"] + common)
        return rc

    cv(model_in, "before")
    got, t_train = counted(
        f"train_lstm_streams --feature-transform, {tr_steps} steps of "
        f"{FROMWAV_S}x{T} (incl. model read, ark I/O)", train_pred, train)
    only("the training epoch", got, train_pred)
    cv(model_out, "after")
    st = res["train"]
    log(f"  epoch on fbank features: {st.frames:.0f} frames in "
        f"{t_train:.3f} s -> {st.frames / t_train:.1f} frames/s; AvgLoss "
        f"{st.avg_loss():.6f}, frame accuracy "
        f"{100 * st.correct / st.frames:.2f}%")
    before, after = res["before"].avg_loss(), res["after"].avg_loss()
    log(f"  cross-validation AvgLoss: before {before:.6f}, after {after:.6f}")
    if not after < before:
        fail("cross-validation AvgLoss did not fall after the epoch")

    # from wav to scores as a user runs it on the CV part: fbank of its
    # wavs on the host (the dither stream restarts, so these features are
    # not the epoch's CV features bit for bit), then scoring on the card
    cv_keys = [ln.split()[0] for ln in lines[-FROMWAV_CV:]]
    cv_audio = sum(dur[k] for k in cv_keys)
    with open(f"{d}/wav/wav.scp") as f, open(f"{d}/cv_wav.scp", "w") as out:
        out.writelines(f.readlines()[-FROMWAV_CV:])
    t_cvfb = step("compute_fbank_feats (CV wavs)", compute_fbank_feats.main,
                  [f"scp:{d}/cv_wav.scp",
                   f"ark,scp:{d}/cv_fbank.ark,{d}/cv_fbank.scp",
                   "--num-mel-bins", "40"])
    argv = ["--apply-log=true", f"--feature-transform={transf}", model_out]
    fwd_pred = {"lstmp_infer": -(-len(cv_keys) // 8)}
    got, t_fwd = counted(
        f"nnet_forward --feature-transform on {len(cv_keys)} CV utterances",
        fwd_pred, lambda: nnet_forward.main(
            argv + [f"scp:{d}/cv_fbank.scp", f"ark:{d}/scores.ark",
                    "--device", "cuda"]))
    only("nnet_forward", got, fwd_pred)
    scores = dict(kio.SequentialMatrixReader(f"ark:{d}/scores.ark"))
    if list(scores) != cv_keys:
        fail(f"scores for {len(scores)} of {len(cv_keys)} CV utterances")
    for k in cv_keys:
        if scores[k].shape != (lens[k], LVCSR_PDFS) or not np.isfinite(
                scores[k]).all():
            fail(f"{k}: scores {scores[k].shape} or non-finite values")
    with open(f"{d}/cv_fbank.scp") as f, open(f"{d}/cpu.scp", "w") as out:
        out.writelines(f.readlines()[:FROMWAV_CPU_UTTS])
    if nnet_forward.main(argv + [f"scp:{d}/cpu.scp", f"ark:{d}/cpu.ark",
                                 "--device", "cpu"]) != 0:
        fail("nnet_forward --device cpu exited nonzero")
    worst = max(float(np.abs(scores[k] - m).max())
                for k, m in kio.SequentialMatrixReader(f"ark:{d}/cpu.ark"))
    log(f"  card vs --device cpu on {FROMWAV_CPU_UTTS} utterances: "
        f"max_abs_err {worst:.3e} (tol {SCORE_ATOL:g})")
    if worst > SCORE_ATOL:
        fail("card scores disagree with the CPU path")
    wall = time.perf_counter() - t_phase
    rate = cv_audio / (t_cvfb + t_fwd)
    log(f"  from wav to scores (compute_fbank_feats on the host, then "
        f"nnet_forward on the card, two CLI runs): {cv_audio:.1f} audio-s "
        f"in {t_cvfb:.3f} + {t_fwd:.3f} s -> {rate:.2f} audio-s/s; phase "
        f"wall {wall:.1f} s")
    return {"launches": launches, "synth_s": t_synth,
            "fbank_frames_per_s": frames / t_fbank, "audio_s": audio_s,
            "wav_to_scores_audio_s_per_s": rate, "wall_s": wall,
            "cv_before": before, "cv_after": after}


def chain_transition_model(num_phones: int):
    """A chain-style <Tuples> model: one emitting state per phone with a
    forward pdf 2(p-1) and a self-loop pdf 2(p-1)+1 (split pdfs)."""
    from kaldi_lstm_tpu_torch.io.transition_model import (
        K_NO_PDF,
        HmmState,
        HmmTopology,
        TransitionModel,
    )
    states = [HmmState(0, 1, [(0, 0.5), (1, 0.5)]),
              HmmState(K_NO_PDF, K_NO_PDF, [])]
    topo = HmmTopology(list(range(1, num_phones + 1)),
                       [-1] + [0] * num_phones, [states])
    tuples = [(p, 0, 2 * (p - 1), 2 * (p - 1) + 1)
              for p in range(1, num_phones + 1)]
    return TransitionModel(topo, tuples,
                           np.log(np.full(2 * num_phones + 1, 0.5,
                                          np.float32)))


def graph_walk(tm, T: int, rng) -> np.ndarray:
    """A [T] graph-state path the phone loop allows (a random walk over
    its arcs from an entry state to one with a final arc)."""
    from kaldi_lstm_tpu_torch.decode.viterbi import PhoneLoopGraph
    g = PhoneLoopGraph.from_transition_model(tm)
    while True:
        path = [rng.choice(np.flatnonzero(g.start_logp > -1e29))]
        for _ in range(T - 1):
            path.append(rng.choice(np.flatnonzero(g.logA[path[-1]] > -1e29)))
        if g.final_logp[path[-1]] > -1e29:
            return np.asarray(path, np.int32)


def seq_graph_functions() -> None:
    """den_logprob, num_logprob and expected_accuracy with their
    gradients w.r.t. loglik, on the card against the CPU, for the
    structured, dense and split graphs (B=3 ragged utterances, T=24)."""
    import torch
    from kaldi_lstm_tpu_torch.io.transition_model import \
        make_monophone_transition_model
    from kaldi_lstm_tpu_torch.train import sequence as sq
    dense = make_monophone_transition_model(3, 3)
    dense.topo.entries[0][0].transitions.append((2, 0.1))
    rng = np.random.RandomState(11)
    for tm in (make_monophone_transition_model(4, 3), dense,
               chain_transition_model(4)):
        graphs = {dev: sq.den_graph_for(tm, device=dev)
                  for dev in ("cpu", "cuda")}
        ns = int(graphs["cpu"].state_pdf.shape[0])
        B, T, K = 3, 24, tm.num_pdfs
        ll = rng.randn(B, T, K).astype(np.float32)
        mask = np.zeros((B, T), np.float32)
        for b, L in enumerate((T, 17, 9)):
            mask[b, :L] = 1
        states = np.stack([graph_walk(tm, T, rng) for _ in range(B)])
        refs = rng.randint(0, K, (B, T)).astype(np.int32)
        worst = {}
        for fname, fn, extra in (
                ("den_logprob", sq.den_logprob, ()),
                ("num_logprob", sq.num_logprob, (states,)),
                ("expected_accuracy", sq.expected_accuracy, (refs,))):
            outs = []
            for dev in ("cpu", "cuda"):
                x = torch.tensor(ll, device=dev, requires_grad=True)
                v = fn(graphs[dev], x, *[torch.tensor(e, device=dev)
                                         for e in extra],
                       torch.tensor(mask, device=dev))
                g = torch.autograd.grad(v.sum(), x)[0]
                outs.append((v.detach().cpu(), g.cpu()))
            (vc, gc), (vg, gg) = outs
            worst[fname] = (float(((vg - vc).abs() / vc.abs().clamp_min(
                1.0)).max()), float((gg - gc).abs().max()
                                     / max(float(gc.abs().max()), 1e-30)))
            if worst[fname][0] > SEQ_STAT_RTOL or \
                    worst[fname][1] > SEQ_STAT_RTOL:
                fail(f"{type(graphs['cpu']).__name__} {fname}: card vs "
                     f"CPU {worst[fname]}")
        log(f"  {type(graphs['cpu']).__name__} (Ns {ns}): card vs CPU "
            f"(value rel err, gradient err / largest gradient) "
            + ", ".join(f"{k} {v[0]:.2e}/{v[1]:.2e}"
                        for k, v in worst.items())
            + f" (tol {SEQ_STAT_RTOL:g})")


def phase_main_path(work: str):
    import torch
    from kaldi_lstm_tpu_torch.decode.scoring import (
        AmScorer,
        copy_overlaps,
        log_priors_from_counts,
    )
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.tools import nnet_forward

    model = os.path.join(work, "final.nnet")
    feats_ark = os.path.join(work, "feats.ark")
    counts_path = os.path.join(work, "counts.vec")
    out_ark = os.path.join(work, "loglik.ark")

    nnet, params = Nnet.init_from_proto(
        PROTO, torch.Generator().manual_seed(0), "cuda")
    nnet.write(model, params, binary=True)
    rng = np.random.RandomState(1)
    utts = {f"utt{i:03d}": rng.randn(int(rng.randint(200, 1001)), 40)
            .astype(np.float32) for i in range(24)}
    with kio.MatrixWriter(f"ark:{feats_ark}") as w:
        for k, m in utts.items():
            w.write(k, m)
    counts = rng.randint(1, 1000, size=8000).astype(np.float32)
    with open(counts_path, "wb") as f:
        kio.write_vector(kio.KaldiOutput(f), counts)

    argv = [model, f"ark:{feats_ark}", f"ark:{out_ark}", "--apply-log=true",
            "--class-frame-counts", counts_path, "--device", "cuda"]
    keys = list(utts)
    # one K5 launch per batch of 8 utterances
    expected = -(-len(keys) // 8)
    got, _ = counted("nnet_forward (incl. model read, CUDA warm-up and ark "
                     "I/O)", {"lstmp_infer": expected},
                     lambda: nnet_forward.main(argv))
    launches = got["lstmp_infer"]

    got = dict(kio.SequentialMatrixReader(f"ark:{out_ark}"))
    if list(got) != keys:
        fail(f"output keys differ: {len(got)} written of {len(keys)}")
    for k in keys:
        y = got[k]
        if y.shape != (utts[k].shape[0], 8000) or not np.isfinite(y).all():
            fail(f"{k}: bad output shape {y.shape} or non-finite values")

    lp = log_priors_from_counts(counts)
    nnet_c, params_c = Nnet.read(model, "cpu")
    cpu = AmScorer(nnet_c, params_c, log_prior=lp, apply_log=True,
                   device="cpu")
    worst = 0.0
    for k, y in cpu.score_stream((k, utts[k]) for k in keys[:3]):
        worst = max(worst, float(np.abs(got[k] - y).max()))
    log(f"  card vs CPU path on 3 utterances: max_abs_err {worst:.3e} "
        f"(tol {SCORE_ATOL:g})")
    if worst > SCORE_ATOL:
        fail("card scores disagree with the CPU path")

    # steady-state throughput: the same scorer, warm, features in memory,
    # without and with the pipeline; every batch's scores come back on the
    # scorer's side stream into fresh pinned memory (CUDA events around it)
    nnet_g, params_g = Nnet.read(model, "cuda")
    frames = sum(m.shape[0] for m in utts.values())
    digests = {}
    serving = {}
    for pipe in (False, True):
        scorer = AmScorer(nnet_g, params_g, log_prior=lp, apply_log=True,
                          device="cuda", pipeline=pipe)
        pend, queued = [], []
        dispatch, forward = scorer._dispatch, scorer._forward

        def tracked(group, dispatch=dispatch, pend=pend):
            pend.append(dispatch(group))
            return pend[-1]

        def tracked_forward(x, forward=forward, pend=pend,
                            queued=queued):
            # is batch k+1's forward queued while batch k's still runs?
            queued.append(bool(pend) and not pend[-1].ready.query())
            return forward(x)
        scorer._dispatch, scorer._forward = tracked, tracked_forward
        rows = {k: hashlib.sha256(y.tobytes()).hexdigest()
                for k, y in scorer.score_stream(utts.items())}
        if digests and rows != digests:
            fail("pipeline=True scores differ from pipeline=False's bytes")
        digests = rows
        torch.cuda.synchronize()
        pend.clear()
        queued.clear()
        t0 = time.perf_counter()
        n = sum(1 for _ in scorer.score_stream(utts.items()))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        copy_ms = [p.start.elapsed_time(p.done) for p in pend]
        batch_ms = 1e3 * dt / len(pend)
        overlap = [copy_overlaps(pend[k], pend[k + 1])
                   for k in range(len(pend) - 1)]
        early = queued[1:]
        log(f"  steady scoring, pipeline={pipe}: {n} utterances, {frames} "
            f"frames in {dt:.3f} s -> {frames / dt:.1f} frames/s, "
            f"{frames / FRAMES_PER_AUDIO_SECOND / dt:.2f} audio-s/s")
        log(f"    score copy (side stream, pinned): "
            f"{statistics.median(copy_ms):.3f} ms per batch (median of "
            f"{len(copy_ms)}: {', '.join(f'{c:.3f}' for c in copy_ms)}), "
            f"{statistics.median(copy_ms) / batch_ms:.3f} of a batch's "
            f"{batch_ms:.3f} ms wall; batch k+1's forward queued before "
            f"batch k's ended: {early}; batch k's copy ran while batch "
            f"k+1's input copy and forward did: {overlap}")
        serving[pipe] = {"audio_s_per_s": frames / FRAMES_PER_AUDIO_SECOND
                         / dt, "copy_ms": statistics.median(copy_ms),
                         "batch_ms": batch_ms, "queued": early,
                         "overlap": overlap}
        if pipe and (not any(overlap) or not all(
                o for o, e in zip(overlap, early) if e)):
            fail(f"with the pipeline no score copy overlapped the next "
                 f"batch's compute, or one whose next batch was queued in "
                 f"time did not: queued {early}, overlapped {overlap}")
        if not pipe and any(overlap):
            fail(f"without the pipeline a score copy overlapped the next "
                 f"batch: {overlap}")
    log("  pipeline=True and pipeline=False scores are byte-identical")
    group = list(utts.items())[:8]
    profile(lambda: [None for _ in scorer.score_stream(group)],
            f"one batch ({len(group)} utterances, pipeline)")
    profile(lambda: [None for _ in scorer.score_stream(utts.items())],
            f"three batches ({len(utts)} utterances, pipeline)")
    return launches


K1_PROFILE_KEYS = ("interleave_gate_rows", "xw_tc_kernel", "gates_tc_kernel",
                   "contract_tc_kernel<32, 32, true, true", "fwd16_")


# ---------------------------------------------------------------------------
# phase 13: the native I/O half and the sharded step on the card
# ---------------------------------------------------------------------------
# the sharded CLI runs train on the first MESH_S utterances of phase 5's
# corpus: --mesh model=2 both ranks on all of them with MESH_S streams,
# --mesh data=2 each rank on its half with MESH_S / 2 streams (one
# utterance a stream either way, so the global batches are those of one
# process with MESH_S streams over all of them)
MESH_S = 128
MESH_TIMEOUT_S = 300
# the trainer's default --sync-every (continue-flag agreement cadence)
MESH_SYNC = 8


def python_matrix_table(path: str) -> dict:
    """{key: matrix} of a binary ark by the Python parse (the reference
    for the native scan)."""
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    out = {}
    with open(path, "rb") as f:
        stream = kio._buffered(f)
        while (key := kio._read_key(stream)) is not None:
            out[key] = kio.read_matrix(kio._read_value_header(stream))
    return out


def phase_native_io(work: str, feats: str, post: str, model: str) -> dict:
    """13a: phase 5's training ark through the native scan against the
    Python parse, an epoch's batches of the native fill against the numpy
    fill, and the epoch profile's times with each fill."""
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.tools import train_lstm_streams
    from kaldi_lstm_tpu_torch.train.streams import StreamScheduler

    from kaldi_lstm_tpu_torch.io import native
    path = feats.split(":", 1)[1]
    t0 = time.perf_counter()
    native.get_io_lib()
    log(f"  the native I/O library (csrc/kltio.cc) built or loaded in "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    scanned = list(kio.SequentialMatrixReader(feats))
    t_scan = time.perf_counter() - t0
    t0 = time.perf_counter()
    parsed = python_matrix_table(path)
    t_parse = time.perf_counter() - t0
    if [k for k, _ in scanned] != list(parsed):
        fail("the native scan's keys differ from the Python parse's")
    if any(m.tobytes() != parsed[k].tobytes() or m.shape != parsed[k].shape
           for k, m in scanned):
        fail("a scanned matrix differs from the Python parse")
    targets = kio.RandomAccessPosteriorReader(post)
    for k, p in kio.SequentialPosteriorReader(post):
        ids, w = targets.value_dense(k)
        ref = np.array([[f[0][0]] for f in p], np.int32)
        if ids.tobytes() != ref.tobytes() or not np.all(w == 1.0) \
                or targets.value(k) != p:
            fail(f"the posterior scan differs from the Python parse at {k}")
    log(f"  readers: {len(scanned)} matrices scanned natively in "
        f"{t_scan:.3f} s (Python parse {t_parse:.3f} s), key for key and "
        f"byte for byte equal; posteriors equal")

    class PlainFill(StreamScheduler):
        _fill_native = StreamScheduler._fill_plain

    times, epochs = {}, {}
    for tag, cls in (("numpy", PlainFill), ("native", StreamScheduler)):
        sched = cls(kio.SequentialMatrixReader(feats),
                    kio.RandomAccessPosteriorReader(post), 40, TRAIN_S,
                    TRAIN_T, 0)
        t0 = time.perf_counter()
        epochs[tag] = list(sched)
        times[tag] = time.perf_counter() - t0
    if len(epochs["native"]) != len(epochs["numpy"]) or any(
            np.asarray(x).tobytes() != np.asarray(y).tobytes()
            for a, b in zip(epochs["native"], epochs["numpy"])
            for x, y in zip(a, b)):
        fail("the native fill's batches differ from the numpy fill's")
    log(f"  fill: {len(epochs['native'])} batches of {TRAIN_S}x{TRAIN_T} "
        f"byte for byte equal; scheduler epoch {times['numpy']:.3f} s with "
        f"the numpy fill, {times['native']:.3f} s with the native fill "
        f"(host clock; {nvidia_smi_line()})")
    profiles = {}
    common = [feats, post, model, "--cross-validate=true",
              f"--num-stream={TRAIN_S}", f"--batch-size={TRAIN_T}",
              "--targets-delay=0", "--device", "cuda", "--verbose=2"]
    saved = StreamScheduler._fill_native
    # a first pass warms the card up; then one pass with each fill
    for tag in ("warm-up", "numpy", "native"):
        if tag == "numpy":
            StreamScheduler._fill_native = StreamScheduler._fill_plain
        try:
            rc, text = run_logged(train_lstm_streams.main, common)
        finally:
            StreamScheduler._fill_native = saved
        if rc != 0:
            fail(f"the -v 2 cross-validation pass ({tag} fill) exited {rc}")
        line = [ln for ln in text.splitlines() if "epoch profile" in ln]
        profiles[tag] = line[-1] if line else ""
        log(f"  -v 2 epoch profile, {tag} fill: {profiles[tag]}")
    return {"scan_s": t_scan, "parse_s": t_parse,
            "fill_numpy_s": times["numpy"], "fill_native_s": times["native"]}


def mesh_prediction(steps: int) -> dict:
    """K1-K4 launches of `steps` sharded training steps on one rank (one
    LSTMP layer, no dx below it; K3/K4 once a step on the rank's classes)."""
    from kaldi_lstm_tpu_torch.ops.lstm_train import bwd_launches, fwd_launches
    return {"lstmp_train_fwd": fwd_launches(TRAIN_T) * steps,
            "lstmp_train_bwd": bwd_launches(TRAIN_T, False) * steps,
            "xent_affine_fwd": 2 * steps, "xent_affine_bwd": 3 * steps}


def mesh_argv(work: str, part: str, streams: int) -> list:
    """train_lstm_streams' arguments on one part of the sharded runs'
    corpus (all, shard0, shard1), without the output model."""
    return [f"ark:{work}/mesh_{part}_feats.ark",
            f"ark:{work}/mesh_{part}_post.ark",
            os.path.join(work, "flagship.init"), "--device", "cuda",
            f"--num-stream={streams}", f"--batch-size={TRAIN_T}",
            "--targets-delay=0", f"--learn-rate={TRAIN_LR}"]


def stats_list(stats) -> list:
    return [stats.loss, stats.entropy, stats.correct, stats.frames]


def mesh_rank(mode: str, rank: int, port: int, work: str) -> int:
    """One of two ranks of a sharded run on cuda:0, started by
    `spawn_mesh`: train_lstm_streams with --mesh {mode}=2 and the
    multi-process flags on this rank's part of the corpus (model=2 with
    --step-group 2, so the grouped sharded step runs too), then its
    cross-validation pass on the model rank 0 wrote, the launch counts
    zeroed just before and read just after each. The probes only
    observe: each step call and each all-reduce is timed with the card
    synced around it, and the parameters gather_params hands this rank
    are kept. Writes those parameters, the counts, the statistics and
    the times."""
    import torch
    import torch.distributed as dist
    from kaldi_lstm_tpu_torch.ops.counts import launch_counts, reset_counts
    from kaldi_lstm_tpu_torch.parallel import mesh as mesh_mod
    from kaldi_lstm_tpu_torch.parallel import sharded_trainer
    from kaldi_lstm_tpu_torch.tools import train_lstm_streams
    from kaldi_lstm_tpu_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    part, streams = (("all", MESH_S) if mode == "model"
                     else (f"shard{rank}", MESH_S // 2))
    base = mesh_argv(work, part, streams)
    model_out = os.path.join(work, f"mesh_{mode}.nnet")
    multi = ["--mesh", f"{mode}=2", "--coordinator-address",
             f"localhost:{port}", "--num-processes", "2", "--process-id",
             str(rank)] + (["--step-group", "2"] if mode == "model" else [])

    coll = {"ms": 0.0, "calls": 0}
    calls = []  # (ms, collectives' ms, steps) of each step call
    reduce = dist.all_reduce

    def timed_all_reduce(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce(*a, **k)
        torch.cuda.synchronize()
        coll["ms"] += 1e3 * (time.perf_counter() - t0)
        coll["calls"] += 1
        return out

    def timed(make, grouped):
        def factory(*a, **k):
            fn = make(*a, **k)

            def call(*args, **kw):
                torch.cuda.synchronize()
                t0, c0 = time.perf_counter(), coll["ms"]
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                calls.append((1e3 * (time.perf_counter() - t0),
                              coll["ms"] - c0,
                              int(args[4].shape[0]) if grouped else 1))
                return out
            return call
        return factory

    gathered = {}
    gather = mesh_mod.MeshPlan.gather_params

    def kept_gather(self, p):
        gathered["params"] = gather(self, p)
        return gathered["params"]

    dist.all_reduce = timed_all_reduce
    sharded_trainer.make_sharded_train_step = timed(
        sharded_trainer.make_sharded_train_step, False)
    sharded_trainer.make_sharded_grouped_train_step = timed(
        sharded_trainer.make_sharded_grouped_train_step, True)
    mesh_mod.MeshPlan.gather_params = kept_gather

    reset_counts()
    rc, tr = train_lstm_streams.run_main(base[:3] + [model_out] + base[3:]
                                         + multi)
    torch.cuda.synchronize()
    train_counts = launch_counts()
    if rc != 0:
        return rc
    train_calls, train_coll = list(calls), coll["calls"]
    reset_counts()
    rc, cv = train_lstm_streams.run_main(
        [base[0], base[1], model_out] + base[3:] + multi
        + ["--cross-validate=true"])
    torch.cuda.synchronize()
    cv_counts = launch_counts()
    if rc != 0:
        return rc
    flat = np.concatenate([t.detach().cpu().numpy().ravel()
                           for t in tree_leaves(gathered["params"])])
    np.save(os.path.join(work, f"mesh_{mode}_{rank}.npy"), flat)
    with open(os.path.join(work, f"mesh_{mode}_{rank}.json"), "w") as f:
        json.dump({"backend": dist.get_backend(), "train": train_counts,
                   "cv": cv_counts, "calls": train_calls,
                   "coll_calls": train_coll, "stats": stats_list(tr),
                   "cv_stats": stats_list(cv)}, f)
    dist.destroy_process_group()
    return 0


def spawn_mesh(mode: str, work: str) -> list:
    """Run the two ranks of `mode` to the end; kill both and fail if one
    fails or the time runs out. Returns their outputs."""
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, KLT_DIST_TIMEOUT=str(MESH_TIMEOUT_S),
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", mode,
         str(r), str(port), work], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_TIMEOUT_S)[0].decode(
                errors="replace"))
    except subprocess.TimeoutExpired:
        fail(f"the {mode}=2 ranks did not finish in {MESH_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = out.strip().splitlines()
        for ln in [x for x in lines if "process group:" in x or
                   "sharded training on mesh" in x][:2] + lines[-3:]:
            log(f"    rank {r} | {ln}")
        if p.returncode != 0:
            log(out[-4000:])
            fail(f"rank {r} of the {mode}=2 run exited {p.returncode}")
    return outs


def write_mesh_corpus(work: str, feats: str, post: str) -> list:
    """The first MESH_S utterances of phase 5's corpus, whole (mesh_all)
    and in halves (mesh_shard0, mesh_shard1); returns their lengths."""
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    targets = kio.RandomAccessPosteriorReader(post)
    items = [kv for _, kv in zip(range(MESH_S),
                                 kio.SequentialMatrixReader(feats))]
    half = MESH_S // 2
    for part, sub in (("all", items), ("shard0", items[:half]),
                      ("shard1", items[half:])):
        with kio.MatrixWriter(f"ark:{work}/mesh_{part}_feats.ark") as fw, \
                kio.PosteriorWriter(f"ark:{work}/mesh_{part}_post.ark") as pw:
            for key, m in sub:
                fw.write(key, m)
                pw.write(key, targets.value(key))
    return [len(m) for _, m in items]


def phase_sharded(work: str, feats: str, post: str) -> dict:
    """13c: train_lstm_streams --mesh model=2 (K3/K4 on 4000 classes a
    rank, --step-group 2) and --mesh data=2 at the flagship widths, two
    gloo ranks of cuda:0 through the multi-process flags, each followed
    by its --cross-validate pass; rank 0's model against one process's
    CLI run over the same global batches."""
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.parallel.multihost import count_batches
    from kaldi_lstm_tpu_torch.tools import train_lstm_streams
    from kaldi_lstm_tpu_torch.utils.tree import tree_leaves

    def flat_model(path):
        return np.concatenate([t.detach().cpu().numpy().ravel()
                               for t in tree_leaves(Nnet.read(path,
                                                              "cpu")[1])])

    lengths = write_mesh_corpus(work, feats, post)
    # one process with MESH_S streams over the same utterances
    base = mesh_argv(work, "all", MESH_S)
    ref_model = os.path.join(work, "mesh_ref.nnet")
    t0 = time.perf_counter()
    rc, ref_tr = train_lstm_streams.run_main(base[:3] + [ref_model]
                                             + base[3:])
    if rc != 0:
        fail(f"the one-process reference run exited {rc}")
    rc, ref_cv = train_lstm_streams.run_main(
        [base[0], base[1], ref_model] + base[3:] + ["--cross-validate=true"])
    if rc != 0:
        fail(f"the one-process reference CV pass exited {rc}")
    ref = flat_model(ref_model)
    ref_tr, ref_cv = stats_list(ref_tr), stats_list(ref_cv)
    log(f"  one process, {MESH_S} streams over {len(lengths)} utterances: "
        f"{count_batches(lengths, MESH_S, TRAIN_T)} steps, AvgLoss "
        f"{ref_tr[0] / ref_tr[3]!r}, CV AvgLoss {ref_cv[0] / ref_cv[3]!r} "
        f"({time.perf_counter() - t0:.1f} s)")

    half = MESH_S // 2
    local = {"model": [count_batches(lengths, MESH_S, TRAIN_T)] * 2,
             "data": [count_batches(lengths[:half], half, TRAIN_T),
                      count_batches(lengths[half:], half, TRAIN_T)]}
    out = {}
    for mode in ("model", "data"):
        # the ranks agree every MESH_SYNC steps, so they run the longer
        # shard's batches rounded up to it (the rest are no-op fillers)
        steps = -(-max(local[mode]) // MESH_SYNC) * MESH_SYNC
        pred = mesh_prediction(steps)
        cv_pred = {"lstmp_infer": steps, "xent_affine_fwd": 2 * steps}
        t0 = time.perf_counter()
        spawn_mesh(mode, work)
        wall = time.perf_counter() - t0
        flats = [np.load(os.path.join(work, f"mesh_{mode}_{r}.npy"))
                 for r in range(2)]
        recs = []
        for r in range(2):
            with open(os.path.join(work, f"mesh_{mode}_{r}.json")) as f:
                recs.append(json.load(f))
        if not np.array_equal(flats[0], flats[1]):
            fail(f"{mode}=2: the two ranks' parameters differ")
        written = flat_model(os.path.join(work, f"mesh_{mode}.nnet"))
        if not np.array_equal(written, flats[0]):
            fail(f"{mode}=2: rank 0's written model differs from its "
                 f"gathered parameters")
        d = np.abs(written - ref)
        worst = float(d.max())
        if not bool(np.all(d <= STEP_ATOL + STEP_RTOL * np.abs(ref))):
            fail(f"{mode}=2: the parameters differ from one process's "
                 f"beyond {STEP_ATOL:g} + {STEP_RTOL:g} x |p| (max "
                 f"{worst:.3e})")
        for r, rec in enumerate(recs):
            for what, got, want in (("training", rec["train"], pred),
                                    ("cross-validation", rec["cv"],
                                     cv_pred)):
                plain = {k: v for k, v in got.items()
                         if k.startswith("plain.") and v}
                others = {k: v for k, v in got.items() if v and k not in
                          want and not k.startswith("plain.")}
                log(f"  {mode}=2 rank {r} {what}: "
                    f"{ {k: got[k] for k in want} } (predicted {want}); "
                    f"plain calls {plain}, others {others}")
                if any(got[k] != want[k] for k in want) or plain or others:
                    fail(f"{mode}=2 rank {r}: {what} launches differ from "
                         f"the prediction")
            for what, got, want in (("training", rec["stats"], ref_tr),
                                    ("CV", rec["cv_stats"], ref_cv)):
                if got != recs[0]["stats" if what == "training"
                                  else "cv_stats"]:
                    fail(f"{mode}=2: the ranks' global {what} statistics "
                         f"differ")
                if not (abs(got[0] - want[0]) <= 1e-4 * abs(want[0])
                        and got[3] == want[3]):
                    fail(f"{mode}=2 rank {r}: {what} statistics {got} "
                         f"differ from one process's {want}")
        # the first call pays gloo's and the kernels' warm-up
        per = [[(ms / n, c / n) for ms, c, n in rec["calls"][1:]]
               for rec in recs]
        ms = [statistics.median(x[0] for x in p) for p in per]
        coll = [statistics.median(x[1] for x in p) for p in per]
        log(f"  {mode}=2 ({recs[0]['backend']} on cuda:0, two ranks, "
            f"{steps} steps): parameters bit-identical on both ranks and in "
            f"rank 0's model, max abs diff from one process "
            f"{worst:.3e} (tol {STEP_ATOL:g} + {STEP_RTOL:g} x |p|); "
            f"AvgLoss {recs[0]['stats'][0] / recs[0]['stats'][3]!r}, CV "
            f"AvgLoss {recs[0]['cv_stats'][0] / recs[0]['cv_stats'][3]!r} "
            f"(global, both ranks); ms per step (median of "
            f"{len(per[0])} step calls after the first; ranks 0 / 1) "
            f"{ms[0]:.3f} / {ms[1]:.3f}, of which in the collectives "
            f"{coll[0]:.3f} / {coll[1]:.3f} ms ({recs[0]['coll_calls']} "
            f"all-reduce calls in training); wall {wall:.1f} s; "
            f"{nvidia_smi_line()}")
        out[mode] = {"launches": recs[0]["train"], "cv": recs[0]["cv"],
                     "ms": ms[0], "coll_ms": coll[0], "max_abs_diff": worst,
                     "steps": steps}
    return out


def phase_native_and_sharded() -> dict:
    """Phase 13 in its own work directory on phase 5's corpus and model
    (the same seeds)."""
    import torch
    from kaldi_lstm_tpu_torch.models import Nnet
    with tempfile.TemporaryDirectory(prefix="klt_chip_smoke_") as work:
        t0 = time.perf_counter()
        feats, post = write_train_corpus(work)
        model = os.path.join(work, "flagship.init")
        nnet, params = Nnet.init_from_proto(
            TRAIN_PROTO, torch.Generator().manual_seed(0), "cuda")
        nnet.write(model, params, binary=True)
        del params
        log("phase 13a: the native I/O half on phase 5's corpus")
        io_rec = phase_native_io(work, feats, post, model)
        log("phase 13b: K3/K4 at a class shard's shape (N=2560, K=4000, "
            "and K=3999, the odd shard of 7998 classes over model=2; every "
            "other row's target in another shard)")
        _, shard = xent_case("shard", MESH_S * TRAIN_T, 512, 4000, 1, 21,
                             timed=True, foreign=True)
        _, odd = xent_case("odd shard", MESH_S * TRAIN_T, 512, 3999, 1, 22,
                           timed=True, foreign=True)
        log("phase 13c: train_lstm_streams --mesh model=2 / data=2, two "
            "gloo ranks on cuda:0")
        mesh = phase_sharded(work, feats, post)
        log(f"phase 13: {time.perf_counter() - t0:.1f} s")
    return {"io": io_rec, "shard": shard, "odd": odd, "mesh": mesh}


def entry_ms(table: list, entry: str) -> float:
    """Device ms of the rows of a `device_table` that belong to a counted
    entry point (a row belongs to the first entry of KERNEL_NAMES whose
    key its name contains, as in kernel_counts_in_trace)."""
    us = 0.0
    for t, _, key in table:
        for k, keys in KERNEL_NAMES.items():
            if any(x in key for x in keys):
                us += t if k == entry else 0.0
                break
    return us / 1e3


def device_table(prof) -> list:
    """(self device us, count, name) of every device event of a finished
    torch.profiler run."""
    import torch
    table = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        table.append((us, e.count, e.key))
    return table


def profiled_busy_ms(prof) -> tuple[float, float]:
    """(kernel ms, copy and set ms) of a finished torch.profiler run."""
    table = device_table(prof)
    copies = [r for r in table if r[2].startswith(("Memcpy", "Memset"))]
    return (sum(r[0] for r in table if r not in copies) / 1e3,
            sum(r[0] for r in copies) / 1e3)


def profile(fn, what: str, rows: int = 10):
    """Device time by kernel and by copy over one call of fn(), and the
    share of its wall time in which no kernel ran (torch.profiler; the
    copy engines' time is reported apart and counts as idle, since the
    SMs may compute meanwhile: every kernel here runs on one stream);
    then the top `rows` kernels and K1's rows (its projection is the
    only K-major-by-K-major contract). Returns {wall_ms, busy_ms, idle,
    kernels (launches), table (device_table's rows)}, or None when the
    profiler recorded no kernel time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tprofile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    table = device_table(prof)
    copies = [r for r in table if r[2].startswith(("Memcpy", "Memset"))]
    busy = sum(r[0] for r in table if r not in copies)
    copy_us = sum(r[0] for r in copies)
    if busy <= 0:
        log(f"  profile of {what}: the profiler recorded no kernel time "
            f"(not measured)")
        return None
    idle = max(0.0, 1 - busy / wall_us)
    log(f"  profile of {what}: wall {wall_us / 1e3:.3f} ms, kernels busy "
        f"{busy / 1e3:.3f} ms, idle share {idle:.3f}"
        f"; copies and sets {copy_us / 1e3:.3f} ms (x"
        f"{sum(r[1] for r in copies)})")
    for us, count, key in sorted(table, reverse=True)[:rows]:
        log(f"    {us / 1e3:10.3f} ms {100 * us / (busy + copy_us):5.1f}% "
            f"x{count:<6d} {key[:90]}")
    k1 = [r for r in table if any(k in r[2] for k in K1_PROFILE_KEYS)]
    if k1 and rows:
        log(f"    K1 rows: {sum(r[0] for r in k1) / 1e3:.3f} ms, "
            f"{100 * sum(r[0] for r in k1) / busy:.1f}% of kernels busy")
        for us, count, key in sorted(k1, reverse=True):
            log(f"      {us / 1e3:10.3f} ms x{count:<6d} {key[:90]}")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "idle": idle,
            "kernels": sum(r[1] for r in table if r not in copies),
            "table": table}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this test needs a card")
    import kaldi_lstm_tpu_torch.ops._build as build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    log(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    log(smi)

    t0 = time.perf_counter()
    build.build_all()
    log(f"phase 2: built {build.kernel_names()} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, (sec, out) in build.BUILD_LOG.items():
        log(f"  nvcc {name} ({sec:.2f} s):")
        for line in out.strip().splitlines():
            log(f"    {line}")

    log("phase 3: K5 vs its plain version on the card")
    rec = phase_kernels()
    log("phase 3: K5's advance-mask entry point vs the masked scan on the "
        "card")
    rec.update(phase_kernels_masked())

    log("phase 3b: K1-K4 vs their plain versions on the card")
    train_recs = phase_train_kernels()

    log("phase 3c: K6/K7 (wavefront two-layer stack) vs their plain "
        "versions, and the wavefront bench")
    stack_recs = phase_stack_kernels()

    log("phase 3e: the tensor core's bf16 sums against their model")
    phase_tc_sums()

    log("phase 3d: the bf16 variants of K1-K7 vs their bf16 plain versions")
    bf16_recs = phase_bf16_kernels()
    # the redesigned bf16 kernels against their f32 twins, this run
    for key, what, b16, f32 in (
            ("K5", "S=8 T=1000", bf16_recs["K5"]["s8_t1000_ms"], rec["ms"]),
            ("K5", "S=256 T=20", bf16_recs["K5"]["ms"], rec["cv_ms"]),
            ("K1", "flagship", bf16_recs["K1"]["ms"],
             train_recs["K1"]["ms"]),
            ("K2", "flagship", bf16_recs["K2"]["ms"],
             train_recs["K2"]["ms"]),
            ("K3", "flagship", bf16_recs["K3"]["ms"],
             train_recs["K3"]["ms"]),
            ("K4", "flagship", bf16_recs["K4"]["ms"],
             train_recs["K4"]["ms"]),
            ("K3", "K=16624", bf16_recs["K3"]["k16624_ms"],
             train_recs["K3"]["k16624_ms"]),
            ("K4", "K=16624", bf16_recs["K4"]["k16624_ms"],
             train_recs["K4"]["k16624_ms"])):
        tag = {"S=8 T=1000": "s8_t1000_", "K=16624": "k16624_"}.get(what,
                                                                   "")
        bf16_recs[key][f"{tag}f32_ms"] = f32
        bf16_recs[key][f"{tag}bf16_over_f32"] = b16 / f32
        log(f"  {key} {what}: bf16 {b16:.3f} ms, f32 {f32:.3f} ms, "
            f"bf16 / f32 {b16 / f32:.3f}")
    bf16_recs.update({f"{k} stack": v for k, v in phase_stack_bf16().items()})

    log("phase 4: serving path (nnet_forward, full-width standard net)")
    with tempfile.TemporaryDirectory(prefix="klt_chip_smoke_") as work:
        launches = phase_main_path(work)

    log("phase 5: training path (train_lstm_streams, full-width flagship)")
    with tempfile.TemporaryDirectory(prefix="klt_chip_smoke_") as work:
        p5 = phase_train(work)
        train_launches = p5["launches"]
        log(f"phase 5b: grouped training path (train_lstm_streams "
            f"--step-group {GROUP}: CUDA-graph replays), full-width "
            f"flagship")
        phase_grouped(work, p5)
        log("phase 5c: the bf16 training path (train_lstm_streams --bf16 "
            "true, an epoch and its CV pass at --step-group 1, 4, 16), "
            "full-width flagship")
        bf16_launches = phase_bf16_path(work, p5)

    log("phase 6: deep path (2 x LSTMP -> 16624) through the layer-stacking "
        "recipe, full width")
    with tempfile.TemporaryDirectory(prefix="klt_chip_smoke_") as work:
        phase_deep(work)

    log("phase 7: fused score->decode (nnet_decode) at the LVCSR recipe's "
        "operating point")
    with tempfile.TemporaryDirectory(prefix="klt_chip_smoke_") as work7:
        decode = phase_decode(work7)
        log("phase 8: streaming serving (online_serve_batch, online_decode, "
            "online_serve_sticky) on phase 7's AM")
        stream = phase_stream(work7, decode)
        del decode["graph"]
        log("phase 9: realign and post-process (nnet_align, align_mapped, "
            "ali_to_pdf, ali_to_phones, the lattice tools) on phase 7's AM, "
            "corpus and lattices")
        align = phase_align(work7, decode)

        log("phase 10a: K1-K5 vs their plain versions at the per-utterance "
            "training shapes (S=1, T up to 1024; R=1024; the flipped half)")
        perutt_recs = phase_perutt_kernels()
        with tempfile.TemporaryDirectory(prefix="klt_chip_smoke_") as work:
            feats, post = write_train_corpus(work)
            perutt = phase_perutt(work, feats, post)

        log("phase 11: sequence training (nnet_train_smbr, nnet_train_mmi, "
            "nnet_train_{mmi,mpe}_sequential) in phase 7's work directory, "
            "on its AM and transition model, with phase 9's realignments")
        t0 = time.perf_counter()
        seq = phase_sequence(work7, decode, align)
        log(f"phase 11: {time.perf_counter() - t0:.1f} s")

        log("phase 12: from wav in phase 7's work directory (synth_wavs, "
            "wav_to_duration, compute_fbank_feats, compute_cmvn_transform on "
            "the host; train_lstm_streams and nnet_forward "
            "--feature-transform on the card)")
        fromwav = phase_from_wav(work7)

    log("phase 13: the native I/O half and the sharded step (two gloo "
        "ranks on the card, --mesh model=2 and data=2)")
    p13 = phase_native_and_sharded()
    mesh = p13["mesh"]
    smbr_prof = seq["sMBR"]["steps"]["profile"] or {"table": []}

    kernels = [{
        "name": "lstmp_infer", "route": "cuda",
        "source": "kaldi_lstm_tpu_torch/csrc/lstmp_infer.cu",
        "replaces": "kaldi_lstm_tpu/ops/lstm_pallas.py:243 (_infer_kernel)",
        "launches": launches, "decode_launches": decode["launches"],
        "stream_launches": stream["dense"]["launches"],
        "single_stream_launches": stream["single"]["launches"],
        "masked_launches": stream["sticky"]["launches"],
        "align_launches": align["launches"],
        "blstm_score_launches": perutt["blstm"]["score_launches"],
        "seq_cv_launches": sum(seq[t][f"cv_launches_{w}"]
                               for t in ("sMBR", "MMI")
                               for w in ("before", "after")),
        "seq_lattice_launches": sum(
            seq["lattice"][t]["launches"]["lstmp_infer"]
            for t in ("mmi_sequential", "mpe_sequential")),
        "fromwav_launches": fromwav["launches"]["lstmp_infer"],
        "mesh_model2_cv_launches": mesh["model"]["cv"]["lstmp_infer"],
        "mesh_data2_cv_launches": mesh["data"]["cv"]["lstmp_infer"],
        "max_abs_err": max(rec["max_abs_err"],
                           perutt_recs["K5"]["max_abs_err"]),
        "ms": rec["ms"], "kernel_ms": rec["ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": None,
        **{k: rec[k] for k in ("us_per_step_s8", "cv_ms", "cv_plain_ms",
                               "cv_bound_ms")},
        **{k: v for k, v in rec.items() if k.startswith("masked_")},
        **{f"blstm_half_{k}": perutt_recs["K5"][k]
           for k in ("ms", "plain_ms", "bound_ms")},
    }]
    for key, name, source, replaces in (
            ("K1", "lstmp_train_fwd", "lstmp_train.cu",
             "kaldi_lstm_tpu/ops/lstm_pallas.py:120 (_fwd_kernel)"),
            ("K2", "lstmp_train_bwd", "lstmp_train.cu",
             "kaldi_lstm_tpu/ops/lstm_pallas.py:337 (_bwd_kernel)"),
            ("K3", "xent_affine_fwd", "xent_affine.cu",
             "kaldi_lstm_tpu/ops/xent_pallas.py:51 (_fwd_kernel)"),
            ("K4", "xent_affine_bwd", "xent_affine.cu",
             "kaldi_lstm_tpu/ops/xent_pallas.py:148 (_bwd_kernel)")):
        r, pr = train_recs[key], perutt_recs[key]
        # per-utterance shapes: K1/K2 at S=1, T=1024; K3/K4 at R=1024
        shapes = {f"s1_t1024_{k}": pr[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "launches_per_call",
            "us_per_launch") if k in pr}
        shapes.update({f"r1024_{k}": v for k, v in pr.items()
                       if k.startswith(("n1024_", "n256_"))})
        if key in ("K3", "K4"):
            # a model rank's class shard: N=2560, K=4000, foreign ids
            shapes.update({f"shard_k4000_{k}": v
                           for k, v in p13["shard"][key].items()})
            shapes.update({f"shard_k3999_{k}": v
                           for k, v in p13["odd"][key].items()})
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"kaldi_lstm_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": train_launches[name],
            "perutt_launches": perutt["standard"]["launches"][name],
            "blstm_perutt_launches": perutt["blstm"]["launches"][name],
            "frmshuff_launches": perutt["dnn"]["launches"][name],
            "seq_smbr_launches": seq["sMBR"]["launches"][name],
            "seq_mmi_launches": seq["MMI"]["launches"][name],
            "seq_lattice_launches": sum(
                seq["lattice"][t]["launches"][name]
                for t in ("mmi_sequential", "mpe_sequential")),
            "seq_smbr_step_ms": entry_ms(smbr_prof["table"], name),
            "fromwav_launches": fromwav["launches"][name],
            "mesh_model2_launches": mesh["model"]["launches"][name],
            "mesh_data2_launches": mesh["data"]["launches"][name],
            "max_abs_err": max(r["max_abs_err"], pr["max_abs_err"]),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, **shapes,
            **{k: v for k, v in r.items() if k not in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}})
    for key, name, replaces in (
            ("K6", "lstmp_stack_fwd2",
             "kaldi_lstm_tpu/ops/lstm_stack_pallas.py:70 (_fwd2_kernel)"),
            ("K7", "lstmp_stack_infer2",
             "kaldi_lstm_tpu/ops/lstm_stack_pallas.py:247 (_infer2_kernel)")):
        for suffix, r in (("", stack_recs[key]),
                          ("_bf16", bf16_recs[f"{key} stack"])):
            # the bf16 designs' shared code: K1 bf16's tiles (K6), K5
            # bf16's tensor-core recurrence (K7)
            shared = {"_bf16": {
                "K6": "kaldi_lstm_tpu_torch/csrc/lstmp_tc16.cuh",
                "K7": "kaldi_lstm_tpu_torch/csrc/persistent.cuh"}[key],
                "": {"K6": "kaldi_lstm_tpu_torch/csrc/lstmp_tc.cuh",
                     "K7": "kaldi_lstm_tpu_torch/csrc/persistent.cuh"}[key]}
            kernels.append({
                "name": name + suffix, "route": "cuda",
                "source": "kaldi_lstm_tpu_torch/csrc/lstmp_stack.cu",
                "shared_source": shared[suffix],
                "replaces": replaces,
                "launches": stack_recs["launches"][name + suffix],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                **{k: v for k, v in r.items() if k not in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "max_abs_err")}})
    for key, name, source, replaces in (
            ("K1", "lstmp_train_fwd_bf16", "lstmp_train.cu",
             "kaldi_lstm_tpu/ops/lstm_pallas.py:120 (_fwd_kernel)"),
            ("K2", "lstmp_train_bwd_bf16", "lstmp_train.cu",
             "kaldi_lstm_tpu/ops/lstm_pallas.py:337 (_bwd_kernel)"),
            ("K3", "xent_affine_fwd_bf16", "xent_affine.cu",
             "kaldi_lstm_tpu/ops/xent_pallas.py:51 (_fwd_kernel)"),
            ("K4", "xent_affine_bwd_bf16", "xent_affine.cu",
             "kaldi_lstm_tpu/ops/xent_pallas.py:148 (_bwd_kernel)"),
            ("K5", "lstmp_infer_bf16", "lstmp_infer.cu",
             "kaldi_lstm_tpu/ops/lstm_pallas.py:243 (_infer_kernel)")):
        r = bf16_recs[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"kaldi_lstm_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": bf16_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            **{k: v for k, v in r.items() if k not in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}})
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--mesh-rank":
        # one rank of phase 13c's sharded run (started by spawn_mesh)
        sys.exit(mesh_rank(sys.argv[2], int(sys.argv[3]),
                           int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
