#!/usr/bin/env python3
"""Drive recboard_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --kernels vocab_ce[,sampled_softmax,...] [--seed 0]
    python3 chip_smoke.py --store-seeds 20 [--seed 0] [--plain] [--device cpu]

The second form runs only the device line, the build and the named
kernels_* phases (mha_fwd, mha_dropout, vocab_ce, sampled_softmax,
rel_bias, sampled_softmax_cand, dropout), with their checks, and exits 0
without the kernels and ok lines: a kernel's check and times in a minute.
The third form runs only the toy store's per-position HSTU protocol for
that many seeds and prints each seed's best NDCG@10 and their mean, through
the kernels or (--plain) through K4's and K6's plain versions: a study of
the quality band on the card, or on the CPU (--device cpu).

Phases, one JSON line each; any failure exits non-zero:

1. device  — the card's name and power limit (nvidia-smi).
2. build   — compiles every CUDA source in recboard_tpu_torch/ops/csrc.
3. kernels — each kernel against its plain PyTorch version on the card
   (float32, TF32 off), with its max |error| against a stated tolerance
   and CUDA-event times beside the plain version and a library call:
   the attention forward (mha_fwd), and the training attention's
   forward and backward (mha_dropout) with dropout active, its kept
   share and per-row masks. Both forwards run on the tensor cores
   (``ops/csrc/attn_fwd_tc.cuh``), and so does K2's backward
   (``attn_bwd_tc_kernel`` in ``ops/csrc/mha_dropout.cu``): each case
   also reruns for the same bits (out and lse; the backward's dq, dk and
   dv, not dbias, which takes atomics), covers head dims that are not a
   multiple of 8 or of 4, causal with L > S and rows masked by the bias,
   and the first prints ptxas' registers and spills of the kernels'
   instances and SDPA's kernel names. Their times are also taken on the
   device clock alone (CUDA graphs, ``graph_ms``), which the kernels line
   reports; SDPA's backward, the yardstick of K2's, is timed that way
   too, beside the old host-paced figure.
4. slice   — ``recommend`` for SASRec at full width (D 64, 2 blocks,
   1 head, maxlen 50) over a dataset of SynBeautyXL's shape (22,363
   users, 12,101 items) with random weights made from --seed: checks
   every list, that each served batch launched the attention kernel
   once per block, and that the GPU lists agree with ``--device cpu``;
   then the ``--bench`` latency line.
5. profile — device time by kernel over one ``--bench`` call, from
   torch.profiler, and the device's idle share.
6. train   — ``run`` at the reference SASRec config on that dataset for
   two epochs: finite losses, the training kernels launched twice per
   step each and the forward kernel twice per evaluated batch, the best
   checkpoint in the flax layout, and the trained run served on the GPU
   with the CPU's lists.
7. train_time — ms per step (the first STAGED_STEPS steps of an epoch,
   each alone), examples/s of a whole epoch and its host pipe alone; then
   the first PROFILE_STEPS steps of the next epoch under torch.profiler:
   device time by kernel per step and the device's idle share.
8. quality — the toy store's SASRec protocol for 5 seeds on the card;
   the mean best NDCG@10 must lie in the store's band.
9. kernels_vocab_ce — the full-vocabulary CE kernels (vocab_ce_fwd,
   vocab_ce_bwd, both on the tensor cores in split-precision TF32)
   against their plain version at BERT4Rec's training shape and at
   ragged, widest-D and large-logit shapes (loss and logz; dh exactly 0
   on rows whose loss gradient is 0), the gradients within 1e-5 relative
   of a float64 run of the plain version, the forward rerun for the same
   bits; at the training shape a rerun of the gradients with the same
   bits, the library call's float64 error beside, the forward's ptxas
   lines, and times by CUDA events and on the device clock (CUDA graphs)
   beside the plain version, F.cross_entropy over torch.addmm and the
   bounds (each at the TF32 and the float32 rate); labels outside
   [0, V), in the band JAX's kernel pads to 128 columns too, pick no
   logit (loss = logz, gradients those of the logsumexp). (Phase
   3 also checks K1 and K2 at BERT4Rec's attention shape: 4 heads of 16,
   key padding, rows with every key padded.)
10. bert4rec_slice, bert4rec_profile — phases 4 and 5 for BERT4Rec at
   full width (D 64, 2 blocks, 4 heads, maxlen 50) with random
   flax-layout weights, whose packed qkv kernels go through from_flax.
11. bert4rec_train, bert4rec_train_time — phases 6 and 7 at the reference
   BERT4Rec config: K2 forward and backward twice per step each, K3
   forward and backward once per step each, K1 twice per evaluated batch.
12. bert4rec_quality — the toy store's BERT4Rec protocol for 5 seeds.
13. kernels_sampled_softmax, kernels_rel_bias — K5 (sampled_softmax_shared
   forward and backward, the forward over the rows of weight != 0 alone
   and the backward over those of s != 0, both on the tensor cores) at
   HSTU's training shape with its pad share, its last batch, the JAX
   test's shape, large logits, every row weighted, no row weighted, D 13
   and D 128: the forward against its plain weighted version, logz and
   pos_logit exactly 0 on rows of weight 0; the backward called directly
   against its plain listed-rows version and through the loss's
   autograd, du and dpos exactly 0 on rows of weight 0 (every output 0
   with no row weighted), the same bits on a rerun of either pass; at
   one negative whose logit the positive's cannot reach, dneg exactly
   s sum(u) / tau (the backward takes the forward's logits bit for bit);
   at the training shape both passes also on the device clock, by part
   (listing, tiles, merge or finishing sums) with their ptxas lines and
   with every row weighted, the bounds on the weighted rows and on all,
   the library on both; K6
   (stacked_rel_bias_bwd) at HSTU's shape, all 129 buckets, a ragged
   batch, L 200, an odd L (L * L not a multiple of 4) and one bias
   block; each against its plain version, the same bits on a rerun; at
   the training shape its times by CUDA events and on the device clock,
   by part (binning pass, finishing sums), with its ptxas lines, beside
   the plain version, the library call (index_add_, also on the device
   clock) and the bound.
14. hstu_train, hstu_profile, hstu_train_time, hstu_quality — phases 6, 5,
   7 and 8 for HSTU at the reference config with shared negatives, its
   training cut to one epoch: K5 forward and backward and K6 once per
   step each, no other kernel; the
   trained run served with the CPU's lists and its ``--bench`` line; the
   toy store's 5-seed shared-negative band.
15. kernels_sampled_softmax_cand, kernels_dropout — K4
   (sampled_softmax_cand forward and backward, both over the weighted
   rows alone) at HSTU's training shape, its last batch, the JAX test's
   shape (ids repeated in rows and out of range), D 128, large logits at
   tau 0.01, the toy store's protocol (300 items, tau 0.05), every row
   weighted and one candidate: against its plain versions (the forward's
   weighted) and the loss's autograd, logz and pos_logit exactly 0 and du
   exactly 0 on rows of weight 0, dtable on table rows no weighted row
   drew, the same bits on a rerun, the backward's transpose equal to a
   stable sort of the live ids, at one candidate du and dtable exactly 0
   (the backward recomputes the forward's logits bit for bit); at the
   training shape forward and backward also by part
   (the listing, the row kernel; transpose, segments), on the device
   clock, with the backward's launches per call and both gathers' L2
   rates; K7
   (dropout_mask) at (1024, 50, 64) and a ragged length, bit-equal to its
   plain version, its kept share and values, seeds; each with CUDA-event
   times beside the plain version, a library call and the bound. Then
   K7's own path (no model calls it): ``ops.dropout.dropout`` forward and
   backward a few times, its launches counted from 0.
16. hstu_pp_train, hstu_pp_profile, hstu_pp_train_time, hstu_pp_grads,
   hstu_pp_quality — phases 6, 5, 7 and 8 for HSTU at the reference config
   as written (per-position negatives, no ``negs_mode``): K4 forward and
   backward and K6 once per step each, no other kernel; one step of the
   toy store's protocol through the kernels against the same step through
   their plain versions, every parameter's gradient; the toy store's
   5-seed per-position band.
17. device_samplers, {sasrec,bert4rec,hstu_pp}_ods_{train,train_time,
   train_profile}, resume_check, pool_check, sasrec_ods_quality,
   hstu_pp_ods_quality — training on batches drawn on the card
   (``--on-device-sampling``, ``data/device.py``): each sampler at the
   training shape, one epoch drawn with no host synchronisation (sync
   debug mode "error"), windows, targets, times and negatives against the
   dataset, the same bits per (seed, epoch, step), the card's draws
   through the CPU sampler's gathers; the syncs of a whole step counted.
   Phases 6 and 7 for SASRec, BERT4Rec and per-position HSTU with the
   device sampler (launches from its steps_per_epoch), printed beside the
   host-pipe run of the same model. A resume checkpoint read back bit for
   bit, and 2 epochs straight (twice) against 1 plus ``--resume``. Pool
   ranking of each trained run on the card against the CPU. The toy
   store's SASRec and per-position HSTU bands with the device samplers.
18. bsarec_*, fmlp_*, unisrec_* (train, train_serve, bench, train_time,
   train_profile, quality) and bsarec_ods_*, fmlp_ods_* — the roll-window
   models: BSARec and FMLP-Rec at their reference configs as written and
   UniSRec at its config's widths, single-corpus with the synthesized item
   features (``data/synthetic.make_item_features``), one epoch each:
   exact launches (BSARec K2 forward and backward once per block and step,
   UniSRec twice (two encodes), K1 once per block and evaluated batch;
   FMLP-Rec none), the trained run served GPU = CPU, its ``--bench`` line,
   the toy store's 5-seed bands; BSARec and FMLP-Rec also device-sampled
   (``DeviceRollSeqSampler``: every drawn row one of the dataset's (user,
   end) windows, none twice in an epoch) beside their host pipes. Phase 3
   also checks K1 and K2 with BSARec's and UniSRec's additive -1e4 mask, a
   bias per batch row: rows with a visible key at TOL and GRAD_TOL, rows
   whose every key carries -1e4 at MASKED_ROW_TOL and there the plain
   softmax over the raw scores, not zeros; a per-row bias that needs a
   gradient is refused before any launch.
19. gru4rec_*, narm_*, glint_ru_*, stamp_*, fpmc_* (train, train_serve,
   bench, train_time (not NARM, STAMP, FPMC), train_profile, quality) and
   gru4rec_ods_* — the
   recurrent and session models at their reference configs as written,
   one epoch each: no launch of K1-K7 (their counters read 0; the GRU is
   cuDNN's, named in the profiles), the trained run served GPU = CPU, its
   ``--bench`` line, the toy store's 5-seed bands; GRU4Rec also
   device-sampled (right-padded windows without the target) beside its
   host pipe. Phase 17's device_samplers also checks GRU4Rec's
   right-padded sampler and FPMC's left-padded one at NUM_PADS 0 (the pad
   value is item 0 there).

Each quality phase runs its seeds in processes of their own side by side
(the protocol's steps are host-bound), one intra-op thread each:
``store_quality``, last, runs every band of phases 8, 12, 14, 16, 17, 18
and 19 (``STORE_BANDS``), 70 seeds in 40 processes, the longest first.
Each phase prints its seconds. Then a ``{"kernels": [...]}`` line, the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``. Without a
CUDA device it exits 1 before printing any result. Scratch files go to
build/chip_smoke/.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

TOL = 1e-5  # max |kernel - plain| for float32 attention outputs of O(1)
TIE_TOL = 1e-4  # scores closer than this may rank in either order
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12  # H100 SXM, TF32 on the tensor cores, dense (NVIDIA's data sheet)

# BSARec's and UniSRec's additive -1e4 mask as a case's bias: a bias per
# batch row (B, 1, L, L) from ``additive_causal_mask`` over left pads, batch
# row 0 all pads. Query rows whose every key carries -1e4 get the plain
# softmax over their raw scores; there x = s * scale - 1e4 is rounded to a
# float32 ulp of 2**-10, and two correct implementations whose products
# differ by 1e-7 can land one ulp apart, moving a probability by about
# 0.1 %. Those rows are held to MASKED_ROW_TOL of max |v| (outputs) or of the
# gradient's largest magnitude; every other row to TOL and GRAD_TOL.
ROW_MASK = "row_mask"
MASKED_ROW_TOL = 2e-3

# (name, B, L, S, H, hd, causal, key_pad, bias, fully-masked rows)
ATTN_SHAPES = [
    ("sasrec_serving", 512, 50, 50, 1, 64, True, False, False, False),
    ("long_keypad", 256, 200, 200, 2, 32, False, True, False, False),
    ("bias_masked_rows", 64, 6, 50, 4, 16, False, False, True, True),
    ("bert4rec_serving", 512, 50, 50, 4, 16, False, True, False, False),
    # BSARec's and UniSRec's serving batches: the mask per row
    ("bsarec_serving", 512, 50, 50, 1, 64, False, False, ROW_MASK, True),
    ("unisrec_serving", 512, 50, 50, 2, 32, False, False, ROW_MASK, True),
]
# correctness-only cases for the paths the timed shapes leave out:
# causal with L != S, causal with pad and bias, rows with no visible key,
# and the 128-wide head that needs more than 48 KB of shared memory
ATTN_EXTRA = [
    ("causal_pad_bias_hd128", 8, 37, 70, 2, 128, True, True, True, False),
    ("causal_L_gt_S", 4, 70, 40, 3, 24, True, True, False, False),
    # head dims the tensor-core tiles pad with zeros: not a multiple of 8
    # (16-byte copies), and not a multiple of 4 (4-byte copies)
    ("hd20_causal_pad", 16, 45, 45, 3, 20, True, True, False, False),
    ("hd13_bias_masked_rows", 8, 70, 70, 2, 13, False, True, True, True),
    # the per-row mask over two key tiles
    ("row_mask_L70_hd64", 8, 70, 70, 1, 64, False, False, ROW_MASK, True),
    ("row_mask_L70_2x32", 8, 70, 70, 2, 32, False, False, ROW_MASK, True),
]

# the training kernels: (name, B, L, S, H, hd, causal, key_pad, bias with
# dbias, dropout rate); the first is SASRec's training shape
DROP_SHAPES = [
    ("sasrec_train", 512, 50, 50, 1, 64, True, False, False, 0.5),
    ("long_keypad", 256, 200, 200, 2, 32, False, True, False, 0.1),
    ("bias_dbias", 64, 37, 37, 4, 32, True, True, True, 0.1),
    ("bert4rec_train", 512, 50, 50, 4, 16, False, True, False, 0.2),
    # BSARec's config (attention dropout 0) and UniSRec's (0.6), the mask per row
    ("bsarec_train", 256, 50, 50, 1, 64, False, False, ROW_MASK, 0.0),
    ("unisrec_train", 512, 50, 50, 2, 32, False, False, ROW_MASK, 0.6),
]
DROP_EXTRA = [  # correctness only
    ("large_S", 8, 300, 300, 4, 64, True, True, False, 0.1),
    ("rate0_vs_mha_reference", 32, 50, 50, 2, 32, True, True, True, 0.0),
    ("hd20_causal_bias", 16, 45, 45, 3, 20, True, True, True, 0.2),
    ("hd10_keypad", 8, 70, 70, 2, 10, False, True, False, 0.3),
    # the backward's cases: causal with L > S (rows that see no key, dq
    # rows no key tile visits), query rows masked by the bias, and the
    # widest head over two query tiles, causal
    ("causal_L_gt_S", 16, 70, 40, 3, 24, True, True, False, 0.2),
    ("hd13_bias_masked_rows", 8, 70, 70, 2, 13, False, True, True, 0.3),
    ("hd128_causal_L96", 8, 96, 96, 2, 128, True, False, False, 0.1),
    # the per-row mask at BSARec's toy-store rate, and over two key tiles
    ("row_mask_hd64_rate05", 32, 50, 50, 1, 64, False, False, ROW_MASK, 0.5),
    ("row_mask_L70_2x32_rate06", 8, 70, 70, 2, 32, False, False, ROW_MASK, 0.6),
]
# dq/dk/dv/dbias: max |kernel - plain| over the largest |plain| of that
# gradient; sums over up to L*S products in other orders (and dbias's
# atomics in a run-dependent order) round differently at float32
GRAD_TOL = 1e-4
KEEP_TOL = 0.005  # |kept share - (1 - rate)| over SASRec's training shape

SASREC = dict(maxlen=50, embedding_dim=64, num_blocks=2, num_heads=1)
DATASET = dict(  # benchmark/SynBeautyXL_000_LOU/meta.json build_command
    name="SynBeautyXL_000_LOU", num_users=22_363, num_items=12_101,
    avg_len=8.9, seed=7, markov_strength=0.45, group_strength=0.45,
    num_groups=96, group_markov=True, splitting="LOU",
)
TOPK = 10
BATCH = 512

# training at the reference config (maxlen 50, D 64, 2 blocks, 1 head,
# dropout 0.5, BCE, batch 512, Adam lr 5e-4, weight decay 1e-6) on the
# dataset above, cut to two epochs
TRAIN_CONFIG = os.path.join(ROOT, "configs", "SASRec_Amazon2014Beauty_550_LOU.yaml")
TRAIN_BATCH = 512
TRAIN_EPOCHS = 2

# the toy store's SASRec row (benchmark/SynBeauty_000_LOU/SASRec.json: 5
# seeds, NDCG@10 0.3176 ± 0.0177): its dataset from meta.json's
# build_command with tools/seed_sweep.py's defaults for the omitted flags,
# and the sweep's arguments for SASRec (seed_sweep.py:58, :676-684)
STORE_DATASET = dict(
    name="SynBeauty_000_LOU", num_users=800, num_items=300, avg_len=14.0, seed=7,
    markov_strength=0.45, group_strength=0.45, num_groups=6, group_markov=False,
    splitting="LOU",
)
STORE_PROTOCOL = dict(epochs=15, lr=0.005, batch_size=128, eval_freq=3, maxlen=20)
STORE_NDCG10 = 0.3176
# a 5-seed mean has ~0.008 of noise at the store's per-seed std; a broken
# gradient or a mask shared across rows lands far below the band
STORE_BAND = 0.03
STORE_SEEDS = 5

# BERT4Rec at the reference widths (configs/BERT4Rec_Amazon2014Beauty_550_LOU.yaml:
# maxlen 50, D 64, 2 blocks, 4 heads, dropout 0.2, mask_ratio 0.2, batch
# 512, Adam lr 0.005, weight decay 1e-4), trained two epochs for its
# mechanics: at this lr and vocabulary the loss does not fall
BERT4REC = dict(maxlen=50, embedding_dim=64, num_blocks=2, num_heads=4)
B4R_CONFIG = os.path.join(ROOT, "configs", "BERT4Rec_Amazon2014Beauty_550_LOU.yaml")
# the toy store's BERT4Rec row (benchmark/SynBeauty_000_LOU/BERT4Rec.json,
# metric best: 5 seeds, NDCG@10 0.3945, std 0.0069) with
# tools/seed_sweep.py's BERT4Rec arguments (:82, :676-684) and the model's
# defaults (mask_ratio 0.3: a budget of 12 positions of 20, so K3 runs)
B4R_STORE_PROTOCOL = dict(epochs=250, lr=0.005, batch_size=128, eval_freq=3, maxlen=20)
B4R_STORE_NDCG10 = 0.3945

# HSTU at the reference widths (configs/HSTU_Amazon2014Beauty_550_LOU.yaml:
# maxlen 50, D 64, 4 blocks, 2 heads, linear and attention dims 4, 128
# buckets, 512 negatives, tau 0.1, dropout 0.5 / 0.1, batch 256, AdamW lr
# 1e-3, weight decay 1e-6) with one shared negative set per step; its
# training phase is cut to one epoch to keep the whole run within its
# minutes (the per-position phases below keep TRAIN_EPOCHS)
HSTU_SHARED_EPOCHS = 1
HSTU = dict(maxlen=50, embedding_dim=64, num_blocks=4, num_heads=2, linear_hidden_dim=4,
            attention_dim=4, num_buckets=128)
HSTU_CONFIG = os.path.join(ROOT, "configs", "HSTU_Amazon2014Beauty_550_LOU.yaml")
HSTU_BATCH = 256
# the JAX package's 5-seed shared-negative A/B on the toy store
# (docs/PERF.md:126, NDCG@10 0.3453 +- 0.0074) with tools/seed_sweep.py's
# HSTU arguments (:62, :676-684) and the model's defaults otherwise
HSTU_STORE_PROTOCOL = dict(epochs=15, lr=0.005, batch_size=128, eval_freq=3, maxlen=20,
                           num_blocks=2, negs_mode="shared")
HSTU_STORE_NDCG10 = 0.3453
# the reference config as written (per-position negatives, no negs_mode)
# and the toy store's HSTU row, which is per-position
# (benchmark/SynBeauty_000_LOU/HSTU.json: 5 seeds, NDCG@10 0.3575 +- 0.0070)
HSTU_PP_STORE_PROTOCOL = dict(epochs=15, lr=0.005, batch_size=128, eval_freq=3, maxlen=20,
                              num_blocks=2)
HSTU_PP_STORE_NDCG10 = 0.3575

# The roll-window models, each cut to one epoch of training (a roll epoch
# is every (user, window end) pair: about 133k windows on the dataset above):
# BSARec at configs/BSARec_Amazon2014Beauty_550_LOU.yaml as written (maxlen
# 50, D 64, 2 blocks, 1 head, hidden dropout 0.5, attention dropout 0, c 5,
# alpha 0.7, CE, batch 256, Adam lr 1e-4, weight decay 1e-4); FMLP-Rec at
# configs/FMLP-Rec_Amazon2014Beauty_550_LOU.yaml as written (maxlen 50, D
# 64, 4 blocks, dropout 0.2, BPR, batch 512, Adam lr 1e-4); UniSRec at
# configs/UniSRec_BHCCM.yaml's widths (maxlen 50, D 64, 1 block, 2 heads, 16
# experts, dropout 0.2, attention dropout 0.6, adaptor dropout 0, T 0.1,
# mask 0.3, batch 512, AdamW lr 1e-3, weight decay 0.01), cut to one corpus,
# the dataset above, with the 24-wide synthesized item features
# (data/synthetic.make_item_features) for its five corpora and their MiniLM
# table, which cannot be downloaded
ROLL_EPOCHS = 1
ROLL_SLICES = ("BSARec", "FMLP-Rec", "UniSRec", "GRU4Rec", "NARM", "GLINT-RU", "STAMP", "FPMC")
# the slices whose toy-store band the whole run checks, in the order the
# band pool hands their seeds out: the longest first by a seed's seconds
# in a whole run on an H100 80GB at 700 W (BERT4Rec's 250 epochs 183 s ...
# FPMC 30 s; the device-sampled SASRec and per-position HSTU beside their
# host-pipe twins), so the short ones fill the processes that free up
STORE_BANDS = ("BERT4Rec", "UniSRec", "BSARec", "FMLP-Rec", "GRU4Rec", "GLINT-RU",
               "HSTU_pp_ods", "HSTU_pp", "HSTU", "SASRec_ods", "SASRec", "NARM", "STAMP",
               "FPMC")
# the band processes at once: 45 fit beside each other on one H100 80GB,
# 70 did not (cuBLAS could not allocate its handle)
STORE_PROCESSES = 40
BSAREC = dict(maxlen=50, embedding_dim=64, num_blocks=2, num_heads=1)
BSAREC_CONFIG = os.path.join(ROOT, "configs", "BSARec_Amazon2014Beauty_550_LOU.yaml")
BSAREC_BATCH = 256
FMLP = dict(maxlen=50, embedding_dim=64, num_blocks=4)
FMLP_CONFIG = os.path.join(ROOT, "configs", "FMLP-Rec_Amazon2014Beauty_550_LOU.yaml")
FMLP_BATCH = 512
UNISREC = dict(maxlen=50, embedding_dim=64, num_blocks=1, num_heads=2, num_moe_experts=16)
UNISREC_CONFIG = os.path.join(ROOT, "configs", "UniSRec_BHCCM.yaml")
UNISREC_BATCH = 512
FEATURE_WIDTH = 24  # make_item_features' k
FEATURES = dict(tfile="sweep_feats.pkl")  # data/synthetic.FEATURE_FILE
# the toy store's rows (benchmark/SynBeauty_000_LOU/{BSARec,FMLP-Rec,UniSRec}.json,
# metric best: 5-seed means, std 0.0023 / 0.0114 / 0.0074) with
# tools/seed_sweep.py's arguments for each (maxlen 20; UniSRec --tfile) and
# the models' defaults
BSAREC_STORE_NDCG10 = 0.42635
FMLP_STORE_NDCG10 = 0.33140
UNISREC_STORE_NDCG10 = 0.31743

# The recurrent and session models, each at its
# configs/<M>_Amazon2014Beauty_550_LOU.yaml as written and cut to one epoch
# like the roll-window models above (same rows: one per (user, window end)):
# GRU4Rec (D 64, H 128, 1 layer, no dropout, BCE, batch 512, Adam lr 1e-3,
# weight decay 1e-6; the inputs the last 50 items before the target,
# right-padded), NARM (D 64, H 64, dropouts 0.2 / 0 / 0.3, BCE, batch 512),
# GLINT-RU (D = H = 128, 8 heads, dropouts 0.1 / 0.2, BCE, batch 2048, Adam
# lr 1e-4), STAMP (D 64, CE over the catalog, batch 512, lr 5e-3, weight
# decay 1e-4; left-padded windows that hold their target, as BSARec's) and
# FPMC (D 64, BPR, batch 512, AdamW lr 5e-4; the last transition only).
# No kernel of K1-K7 on these paths; the GRU is cuDNN's.
GRU4REC = dict(maxlen=50, embedding_dim=64, hidden_size=128, num_blocks=1)
GRU4REC_CONFIG = os.path.join(ROOT, "configs", "GRU4Rec_Amazon2014Beauty_550_LOU.yaml")
NARM = dict(maxlen=50, embedding_dim=64, hidden_size=64, num_blocks=1)
NARM_CONFIG = os.path.join(ROOT, "configs", "NARM_Amazon2014Beauty_550_LOU.yaml")
GLINT_RU = dict(maxlen=50, embedding_dim=128, hidden_size=128, num_heads=8, num_layers=1)
GLINT_RU_CONFIG = os.path.join(ROOT, "configs", "GLINT-RU_Amazon2014Beauty_550_LOU.yaml")
STAMP = dict(maxlen=50, embedding_dim=64, hidden_size=64)
STAMP_CONFIG = os.path.join(ROOT, "configs", "STAMP_Amazon2014Beauty_550_LOU.yaml")
FPMC = dict(maxlen=50, embedding_dim=64)
FPMC_CONFIG = os.path.join(ROOT, "configs", "FPMC_Amazon2014Beauty_550_LOU.yaml")
# the toy store's rows (benchmark/SynBeauty_000_LOU/<M>.json, metric best:
# 5-seed means, std 0.0077 / 0.0186 / 0.0066 / 0.0214 / 0.0068) with
# tools/seed_sweep.py's arguments (maxlen 20) and the models' defaults
GRU4REC_STORE_NDCG10 = 0.2434
NARM_STORE_NDCG10 = 0.2537
GLINT_RU_STORE_NDCG10 = 0.3771
STAMP_STORE_NDCG10 = 0.4104
FPMC_STORE_NDCG10 = 0.4277

# K3 (full-vocabulary CE): (name, M, D, V, large logits); the first is
# BERT4Rec's training shape (512 rows x a budget of ceil(50 * 0.2 * 2) = 20
# positions, D 64, 12,101 items + 2 specials)
CE_SHAPES = [("bert4rec_train", 10_240, 64, 12_103, False)]
CE_EXTRA = [  # correctness only
    ("bert4rec_last_batch", 6_940, 64, 12_103, False),  # 347 users x 20
    ("jax_test", 70, 16, 300, False),
    ("widest_D", 333, 128, 1_000, False),
    ("large_logits", 1_000, 64, 12_103, True),
]
# max |loss - plain| for losses of O(10): sums of D products and
# logsumexps of V terms in other orders, at float32
CE_TOL = 1e-4
# max relative gradient error against a float64 run of the plain version:
# what float32 products keep (the backward's tensor cores work in
# split-precision TF32 to keep it)
CE_F64_TOL = 1e-5
CE_BIG = 100.0  # bias added to every 97th entry: exp() overflows float32 there

# K5 (shared-negative sampled softmax): (name, M, K, D, temperature,
# l2-normalised inputs, share of rows of weight 0); the first is HSTU's
# training shape (256 rows x 50 positions, 512 negatives, D 64, tau 0.1)
# with the pad share of its batches (87.9 %, as the hstu_train phase
# reports): the backward computes the rows of nonzero gradient alone
HSTU_PAD_SHARE = 0.879
SS_ZERO_SHARE = 0.4  # rows of weight 0 in the correctness cases
SS_SHAPES = [("hstu_train", 12_800, 512, 64, 0.1, True, HSTU_PAD_SHARE)]
SS_EXTRA = [  # correctness only
    # 21,892 rows mod 256 = 132, x 50
    ("hstu_last_batch", 6_600, 512, 64, 0.1, True, SS_ZERO_SHARE),
    ("jax_test", 70, 12, 8, 0.3, False, SS_ZERO_SHARE),
    # |logits| past 88: exp() overflows float32
    ("large_logits", 1_000, 512, 64, 0.01, False, SS_ZERO_SHARE),
    ("all_rows", 2_048, 512, 64, 0.1, True, 0.0),  # no row of weight 0
    ("no_live_row", 2_048, 512, 64, 0.1, True, 1.0),  # every weight 0: du, dpos, dneg exactly 0
    ("ragged_D_13", 1_000, 300, 13, 0.3, False, SS_ZERO_SHARE),  # 4-byte staging, a ragged tile
    ("widest_D", 2_000, 512, 128, 0.1, True, SS_ZERO_SHARE),
]
# logz and pos_logit: max |kernel - plain| over max(1, max |plain|); sums
# of D products and logsumexps of K + 1 terms in other orders
SS_TOL = 1e-5
# gradients at the large-logits shape: logits of a few hundred carry
# ~1e-4 of float32 rounding in either version, which exp() turns into a
# relative error of the same size in every probability
SS_LARGE_GRAD_TOL = 1e-3

# K6 (relative-bias backward): (name, NB, B, L, active buckets K, bucket
# columns); the first is HSTU's training shape: 4 blocks, batch 256,
# maxlen 50, 128 buckets, and the K the dataset's timestamps reach (the
# hstu_train phase checks the model derives the same)
HSTU_ACTIVE_K = 32
RB_SHAPES = [("hstu_train", 4, 256, 50, HSTU_ACTIVE_K, 129)]
RB_EXTRA = [  # correctness only
    ("all_buckets", 4, 256, 50, 129, 129),
    ("ragged_B", 4, 37, 50, HSTU_ACTIVE_K, 129),
    ("long_L", 4, 64, 200, HSTU_ACTIVE_K, 129),
    ("odd_L", 3, 45, 37, HSTU_ACTIVE_K, 129),  # L * L not a multiple of 4: 4-byte loads
    ("one_block", 1, 29, 7, 23, 40),  # tests/test_ops.py's L and K, one bias block
]


# K4 (per-position sampled softmax): (name, M, C, D, N, temperature, inputs,
# share of rows of weight 0); inputs "l2" are l2-normalised rows with
# HSTU's ids (pad rows' positive is item 0), "normal" standard normal rows,
# "large" unnormalised rows whose logits at tau 0.01 reach a few hundred,
# where exp() overflows float32. The first is HSTU's training shape (256
# rows x 50 positions, 1 + 512 candidates, D 64, 12,101 items, tau 0.1)
# with the pad share of its batches (HSTU_PAD_SHARE, as K5's)
SSC_SHAPES = [("hstu_train", 12_800, 513, 64, 12_101, 0.1, "l2", HSTU_PAD_SHARE)]
SSC_EXTRA = [  # correctness only
    ("hstu_last_batch", 6_600, 513, 64, 12_101, 0.1, "l2", HSTU_PAD_SHARE),
    ("jax_test", 64, 5, 8, 16, 1.0, "normal", 0.3),  # tests/test_ops.py:80: ids repeat in rows
    ("widest_D", 2_000, 513, 128, 12_101, 0.1, "l2", 0.5),
    ("large_logits", 1_000, 513, 64, 12_101, 0.01, "large", 0.3),
    # the toy store's per-position protocol: 128 rows x 20 positions, 300
    # items, tau 0.05, its pad share; about 2,600 entries per table row,
    # each id about 1.7 times in every row
    ("toy_store", 2_560, 513, 64, 300, 0.05, "l2", 0.449),
    ("all_rows", 2_048, 513, 64, 12_101, 0.1, "l2", 0.0),  # every row through the one entry
    # one candidate: logz is the logit itself, so the backward's coefficients
    # exp(logit - logz) - 1, and du and dtable, are exactly 0 if and only if
    # the backward recomputes the forward's logits bit for bit
    ("one_candidate", 2_048, 1, 64, 12_101, 0.1, "l2", HSTU_PAD_SHARE),
]
# logz and pos_logit: max |kernel - plain| over max(1, max |plain|) (SS_TOL);
# du and dtable: over each gradient's largest |plain| (GRAD_TOL): sums of D
# products and of C candidates' terms in other orders, at float32

# K7 (dropout mask): (name, shape, rate); the first is the JAX kernel's
# test shape (tests/test_ops.py:234), the second a ragged length
DROP_MASK_SHAPES = [("jax_test", (1024, 50, 64), 0.2)]
DROP_MASK_EXTRA = [("ragged", (1_000_003,), 0.5)]
# forward and backward passes of ops.dropout.dropout, K7's own path
DROP_PATH_STEPS = 4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 50) -> float:
    """Device time of one call with the host's launch cost out of the way:
    ``calls`` calls captured in one CUDA graph, whose replays are timed by
    CUDA events. For kernels shorter than their wrapper's host time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, iters=20, warmup=2) / calls


def ptxas_lines(source: str, kernel: str) -> list:
    """``source``'s build log cut to ``kernel``'s instances: for each, its
    mangled name, then ptxas' spill and register lines."""
    from recboard_tpu_torch.ops import _build

    log = _build.library_path(source).with_suffix(".log")
    out, current = [], None
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "Compiling entry function" in line:
            current = line.split("'")[1] if kernel in line else None
            if current:
                out.append(current)
        elif current and ("spill" in line or "registers" in line):
            out.append(line.strip())
    return out


def library_kernels(fn) -> list:
    """The names of the device kernels one call of ``fn`` launches."""
    return sorted({name[:120] for name, _, _ in device_kernels(fn, calls=1)})


def device_kernels(fn, calls: int) -> list:
    """(name, device ms per call, launches per call) of each device kernel
    that ``calls`` calls of ``fn`` run, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(name, us / 1e3, n)
            for name, us, n in profiled_ops(profile_totals(prof), calls, device=True)]


# K4's and K5's kernels by part, forward and backward: each
# lists its rows with cand_live_kernel, so a part is told by the call it is
# timed in
SSC_FWD_PARTS = {"cand_live_kernel": "live", "cand_fwd_kernel": "rows"}
SS_FWD_PARTS = {"cand_live_kernel": "live", "shared_fwd_tile_kernel": "tiles",
                "shared_fwd_merge_kernel": "merge"}
SS_BWD_PARTS = {"cand_live_kernel": "live", "shared_bwd_tile_kernel": "tiles",
                "shared_bwd_finish_kernel": "finish"}
SSC_BWD_PARTS = {"cand_live_kernel": "live", "cand_rows_kernel": "rows",
                 "cand_chunk_kernel": "transpose", "cand_segment_kernel": "segments"}
RB_BWD_PARTS = {"rel_bias_hist_kernel": "hist", "rel_bias_sum_kernel": "sum"}


def kernel_parts(fn, parts_of: dict, what: str, calls: int) -> tuple:
    """({part: device ms per call}, launches per call) of the kernels one
    call of ``fn`` runs, by ``parts_of`` (a kernel name's substring to its
    part); raises if it ran a kernel not named there."""
    parts, launches = {}, 0.0
    for name, ms, n in device_kernels(fn, calls):
        part = next((p for k, p in parts_of.items() if k in name), None)
        if part is None:
            raise SystemExit(f"{what} ran a kernel not its own: {name}")
        parts[part] = parts.get(part, 0.0) + ms
        launches += n
    return parts, launches


def attention_inputs(case, rng):
    """Inputs of one attention case, made with numpy and moved to the card."""
    import torch

    name, B, L, S, H, hd, causal, key_pad, bias, masked_rows = case
    D = H * hd
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    q = t(rng.normal(size=(B, L, D)).astype(np.float32))
    k = t(rng.normal(size=(B, S, D)).astype(np.float32))
    v = t(rng.normal(size=(B, S, D)).astype(np.float32))
    pad = t(rng.random((B, S)) < 0.3) if key_pad else None
    if pad is not None:
        pad[0] = True  # one batch row with every key padded
    b = None
    if bias == ROW_MASK:
        from recboard_tpu_torch.ops.attention import additive_causal_mask

        lengths = rng.integers(1, L + 1, size=B)
        lengths[0] = 0  # a batch row of pads only
        b = additive_causal_mask(t(np.arange(L)[None, :] < (L - lengths)[:, None]))
    elif bias:
        b = rng.normal(size=(1, H, L, S)).astype(np.float32)
        if masked_rows:
            b[0, :, 0, :] = -1e30  # query row 0 masked in every head
            b[0, 1 % H, 2, :] = -1e30
        b = t(b)
    return dict(q=q, k=k, v=v, num_heads=H, causal=causal,
                key_padding_mask=pad, bias=b)


def masked_rows(inp):
    """(B, L) True at the query rows whose every key carries the -1e4 mask
    of a per-row bias, or None for any other case."""
    from recboard_tpu_torch.ops.attention import per_row_bias

    if not per_row_bias(inp["bias"]):
        return None
    return (inp["bias"] <= -5e3).all(-1).any(1)


def masked_row_errors(got, want, rows, scale) -> tuple:
    """(max |got - want| over the rows with a visible key, the same over the
    fully masked rows divided by ``scale``)."""
    diff = (got - want).abs()
    return float(diff[~rows].max()), float(diff[rows].max() / scale)


def visible_pairs(inp) -> int:
    """The (batch row, head, query, key) entries these inputs leave
    unmasked: the work an attention kernel has to do for them."""
    import torch

    from recboard_tpu_torch.ops.attention import NEG_INF, _merge_masks

    q, k = inp["q"], inp["k"]
    B, L, _ = q.shape
    S, H = k.shape[1], inp["num_heads"]
    add = _merge_masks(L, S, inp["causal"], inp["key_padding_mask"], q.dtype, q.device)
    scores = torch.zeros((B, H, L, S), device=q.device)
    if add is not None:
        scores = scores + add[:, None]
    if inp["bias"] is not None:
        scores = scores + inp["bias"].detach()
    return int((scores > NEG_INF / 2).sum())


def bound(nbytes: int, flops: int, flop_rate: float = F32_FLOP_PER_S) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes at the HBM
    rate and the operations at ``flop_rate`` (float32's by default)."""
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return 1e3 * max(bytes_s, ops_s), "bytes" if bytes_s >= ops_s else "operations"


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1.0))


def grad_rel_err(got, want) -> float:
    """max over tensors of max |got - want| / max |want|."""
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(got, want))


def attention_bound(inp) -> tuple:
    """The least time for the work these inputs need: each input read once
    and the output written once, and 4*hd FLOP (QK and PV FMAs) per
    unmasked (query, key) pair."""
    q = inp["q"]
    hd = q.shape[-1] // inp["num_heads"]
    moved = nbytes(q, inp["k"], inp["v"], q, inp["key_padding_mask"], inp["bias"])
    return bound(moved, 4 * hd * visible_pairs(inp))


def library_attention(inp):
    """One PyTorch call computing the same function (a yardstick only:
    it gives NaN where a row has no unmasked key)."""
    import torch
    import torch.nn.functional as F

    q, k, v, H = inp["q"], inp["k"], inp["v"], inp["num_heads"]
    B, L, D = q.shape
    S = k.shape[1]
    heads = lambda x, n: x.view(B, n, H, D // H).transpose(1, 2)  # noqa: E731
    mask = None
    if inp["causal"] and not (L == S and inp["key_padding_mask"] is None
                              and inp["bias"] is None):
        raise ValueError("library_attention: causal only at L == S without masks")
    if inp["key_padding_mask"] is not None:
        mask = ~inp["key_padding_mask"][:, None, None, :]
    if inp["bias"] is not None:
        mask = inp["bias"] if mask is None else inp["bias"].masked_fill(~mask, -math.inf)
    qh, kh, vh = heads(q, L), heads(k, S), heads(v, S)
    return lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, is_causal=inp["causal"]
    )


def check_attention(rng):
    """Kernel against the plain version on the card; times the timed shapes."""
    import torch

    from recboard_tpu_torch.ops import attention as A

    rows, worst = [], 0.0
    for case in ATTN_SHAPES + ATTN_EXTRA:
        inp = attention_inputs(case, rng)
        want = A.mha_reference(**inp)
        got = A.mha_fwd(**inp)
        same_bits = torch.equal(got, A.mha_fwd(**inp))  # no atomics: a rerun is exact
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        finite = bool(torch.isfinite(got).all())
        rows_ok, extra = True, {}
        masked = masked_rows(inp)
        if masked is not None:
            # rows with a visible key at TOL; fully masked rows at MASKED_ROW_TOL,
            # and there the plain softmax over the raw scores (no mask), not zeros
            vmax = inp["v"].detach().abs().max()
            err, masked_err = masked_row_errors(got, want, masked, vmax)
            no_mask = A.mha_reference(**dict(inp, bias=None))
            _, plain_softmax_err = masked_row_errors(got, no_mask, masked, vmax)
            extra = dict(masked_rows=int(masked.sum()), masked_row_err=masked_err,
                         masked_row_tol=MASKED_ROW_TOL, plain_softmax_err=plain_softmax_err)
            rows_ok = masked_err <= MASKED_ROW_TOL and plain_softmax_err <= MASKED_ROW_TOL
        worst = max(worst, err)
        row = dict(shape=case[0], B=case[1], L=case[2], S=case[3], H=case[4],
                   hd=case[5], bias=case[8], max_abs_err=err, tol=TOL, finite=finite,
                   rerun_same_bits=same_bits, **extra)
        if case is ATTN_SHAPES[0]:
            row.update(ptxas=ptxas_lines("mha_fwd", "attn_fwd_tc_kernel"),
                       library_kernels=library_kernels(library_attention(inp)))
        if case in ATTN_SHAPES:
            bound_ms, bound_by = attention_bound(inp)
            row.update(
                ms=cuda_ms(lambda: A.mha_fwd(**inp)),
                plain_ms=cuda_ms(lambda: A.mha_reference(**inp)),
                library_ms=cuda_ms(library_attention(inp)),
                # the device clock alone, the wrappers' host time out of the way
                graph_ms=graph_ms(lambda: A.mha_fwd(**inp)),
                library_graph_ms=graph_ms(library_attention(inp)),
                bound_ms=bound_ms, bound_by=bound_by,
            )
        emit("kernels", kernel="mha_fwd", **row)
        if not finite or not err <= TOL or not same_bits or not rows_ok:
            raise SystemExit(f"mha_fwd disagrees with mha_reference at {case[0]}: {err}, "
                             f"rerun same bits {same_bits}, {extra}")
        rows.append(row)
    return rows, worst


def dropout_inputs(case, rng):
    """Inputs of one training-attention case, with a seed, an output
    gradient, and a bias that requires its gradient when the case has one."""
    import torch

    name, B, L, S, H, hd, causal, key_pad, bias, rate = case
    row_mask = ROW_MASK if bias == ROW_MASK else False  # a constant: no gradient
    inp = attention_inputs((name, B, L, S, H, hd, causal, key_pad, row_mask, False), rng)
    if bias is True:
        b = rng.normal(size=(H, L, S)).astype(np.float32)
        if name.endswith("masked_rows"):
            b[:, 0, :] = -1e30  # query row 0 masked in every head
            b[1 % H, 2, :] = -1e30
        inp["bias"] = torch.from_numpy(b).cuda().requires_grad_()
    for key in ("q", "k", "v"):
        inp[key].requires_grad_()
    inp.update(dropout_rate=rate, seed=torch.tensor(
        [int(rng.integers(-(2**31), 2**31 - 1))], dtype=torch.int32).cuda())
    dout = torch.from_numpy(rng.normal(size=tuple(inp["q"].shape)).astype(np.float32)).cuda()
    return inp, dout


def _grads(fn, inp, dout):
    """(output, [dq, dk, dv(, dbias)]) of fn(**inp) for the output gradient dout."""
    import torch

    wrt = [inp[k] for k in ("q", "k", "v", "bias")
           if inp[k] is not None and inp[k].requires_grad]
    out = fn(**inp)
    return out.detach(), list(torch.autograd.grad(out, wrt, dout))


def dropout_bound(inp, with_dbias: bool) -> dict:
    """Bounds of the training kernels for these inputs: the forward reads
    q, k, v (and pad, bias) and writes out, 4*hd FLOP per visible (query,
    key) pair; the backward reads q, k, v, out, dO (and pad, bias) and
    writes dq, dk, dv (and dbias), 10*hd FLOP per visible pair (QK and
    dO V^T recomputed, then dV, dK and dQ)."""
    q = inp["q"]
    hd = q.shape[-1] // inp["num_heads"]
    pairs = visible_pairs(inp)
    masks = nbytes(inp["key_padding_mask"], inp["bias"])
    qkv = nbytes(q, inp["k"], inp["v"])
    dbias = nbytes(inp["bias"]) if with_dbias else 0
    return dict(fwd=bound(qkv + nbytes(q) + masks, 4 * hd * pairs),
                bwd=bound(2 * qkv + 2 * nbytes(q) + masks + dbias, 10 * hd * pairs))


def library_dropout_attention(inp):
    """(forward call, forward+backward call) of scaled_dot_product_attention
    with the same dropout rate: a yardstick only (its own random mask)."""
    import torch
    import torch.nn.functional as F

    q, k, v, H = inp["q"], inp["k"], inp["v"], inp["num_heads"]
    B, L, D = q.shape
    S = k.shape[1]
    heads = lambda x, n: x.view(B, n, H, D // H).transpose(1, 2)  # noqa: E731
    mask, causal = None, inp["causal"]
    if inp["key_padding_mask"] is not None:
        mask = ~inp["key_padding_mask"][:, None, None, :]
        if causal:  # SDPA takes is_causal only without a mask
            tril = torch.ones((L, S), dtype=torch.bool, device=q.device).tril(S - L)
            mask, causal = mask & tril, False
    elif masked_rows(inp) is not None:  # the -1e4 mask as a float (B, 1, L, S) mask
        mask = inp["bias"]
    qh, kh, vh = (heads(t.detach(), n).requires_grad_() for t, n in
                  ((q, L), (k, S), (v, S)))
    g = torch.ones((B, H, L, D // H), device=q.device)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, is_causal=causal,
                dropout_p=inp["dropout_rate"])

    def fwd_bwd():
        out = F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=causal, dropout_p=inp["dropout_rate"])
        torch.autograd.grad(out, (qh, kh, vh), g)

    return fwd, fwd_bwd


def kept_fraction(B: int, L: int, H: int, hd: int, rate: float, seed) -> float:
    """The share of visible (query, key) pairs the forward kernel keeps,
    read from its output: with q = 0 every visible key of a causal row l
    gets probability 1/(l+1), and with v = 1 the output is
    kept(l) / (l+1) / (1 - rate)."""
    import torch

    from recboard_tpu_torch.ops import attention as A

    D = H * hd
    zeros = torch.zeros((B, L, D), device="cuda")
    ones = torch.ones((B, L, D), device="cuda")
    out, _ = A.mha_dropout_fwd(zeros, zeros, ones, H, True, None, None, None, rate, seed)
    visible = torch.arange(1, L + 1, device="cuda", dtype=torch.float32)
    per_head = out.view(B, L, H, hd)[..., 0] * visible[None, :, None] * (1 - rate)
    return float(per_head.sum() / (B * H * visible.sum()))


def check_dropout_attention(rng):
    """The training kernels against mha_dropout_reference on the card,
    forward and backward, dropout active, the same seed; rate 0 against
    mha_reference; the keep share and per-row masks; times of the timed
    shapes."""
    import torch

    from recboard_tpu_torch.ops import attention as A

    rows, worst = [], dict(fwd=0.0, bwd=0.0)
    for case in DROP_SHAPES + DROP_EXTRA:
        inp, dout = dropout_inputs(case, rng)
        with_dbias = case[8] is True
        plain = A.mha_dropout_reference if case[-1] > 0 else (
            lambda dropout_rate, seed, **kw: A.mha_reference(**kw))
        want, want_g = _grads(plain, inp, dout)
        got, got_g = _grads(A.mha_dropout, inp, dout)
        fwd_args = ([inp[k].detach() for k in ("q", "k", "v")]
                    + [inp["num_heads"], inp["causal"], inp["key_padding_mask"],
                       None if inp["bias"] is None else inp["bias"].detach(), None,
                       inp["dropout_rate"], inp["seed"]])
        first, again = A.mha_dropout_fwd(*fwd_args), A.mha_dropout_fwd(*fwd_args)
        same_bits = all(torch.equal(a, b) for a, b in zip(first, again))
        # the backward adds no atomics into dq, dk and dv: a rerun is exact
        bwd_args = (*fwd_args[:3], *first, dout, *fwd_args[3:], with_dbias)
        bwd_first, bwd_again = A.mha_dropout_bwd(*bwd_args), A.mha_dropout_bwd(*bwd_args)
        bwd_same_bits = all(torch.equal(a, b) for a, b in zip(bwd_first[:3], bwd_again[:3]))
        torch.cuda.synchronize()
        out_err = float((got - want).abs().max())
        grad_err = max(float((a - b).abs().max()) for a, b in zip(got_g, want_g))
        grad_rel = grad_rel_err(got_g, want_g)
        finite = all(bool(torch.isfinite(t).all()) for t in [got] + got_g)
        rows_ok, extra = True, {}
        masked = masked_rows(inp)
        if masked is not None:
            out_err, extra = check_masked_rows(A, inp, dout, masked, got, want, got_g, want_g)
            grad_rel, rows_ok = extra["grad_rel_err_quiet"], extra["ok"]
            grad_err = extra["grad_max_abs_err_quiet"]
        worst["fwd"] = max(worst["fwd"], out_err)
        worst["bwd"] = max(worst["bwd"], grad_err)
        row = dict(shape=case[0], B=case[1], L=case[2], S=case[3], H=case[4],
                   hd=case[5], rate=case[-1], bias=case[8], max_abs_err=out_err,
                   tol=TOL, grad_max_abs_err=grad_err, grad_rel_err=grad_rel,
                   grad_rel_tol=GRAD_TOL, finite=finite, rerun_same_bits=same_bits,
                   bwd_rerun_same_bits=bwd_same_bits, **extra)
        if with_dbias:
            row.update(dbias_rerun="not compared: dbias takes atomicAdd")
        if case is DROP_SHAPES[0]:
            row.update(ptxas=ptxas_lines("mha_dropout", "attn_fwd_tc_kernel"),
                       bwd_ptxas=ptxas_lines("mha_dropout", "attn_bwd_tc_kernel"))
        if case in DROP_SHAPES:
            row.update(time_dropout(inp, dout))
        emit("kernels", kernel="mha_dropout", **row)
        if (not finite or not out_err <= TOL or not grad_rel <= GRAD_TOL or not same_bits
                or not bwd_same_bits or not rows_ok):
            raise SystemExit(f"mha_dropout disagrees with its plain version at "
                             f"{case[0]}: out {out_err}, grads {grad_rel}, rerun same "
                             f"bits {same_bits}, backward rerun same bits {bwd_same_bits}, "
                             f"{extra}")
        rows.append(row)

    # a bias that differs by batch row takes no gradient: refused before any launch
    inp, _ = dropout_inputs(DROP_SHAPES[4], rng)
    launches = (A.mha_dropout_fwd.launches, A.mha_dropout_bwd.launches)
    try:
        A.mha_dropout(**dict(inp, bias=inp["bias"].clone().requires_grad_()))
        refused = False
    except NotImplementedError:
        refused = True
    unlaunched = launches == (A.mha_dropout_fwd.launches, A.mha_dropout_bwd.launches)
    emit("kernels", check="per_row_bias_gradient_refused", refused=refused,
         no_launch=unlaunched)
    if not refused or not unlaunched:
        raise SystemExit("mha_dropout took a per-row bias that needs a gradient")

    name, B, L, S, H, hd, causal, _, _, rate = DROP_SHAPES[0]
    seed = torch.tensor([12345], dtype=torch.int32, device="cuda")
    share = kept_fraction(B, L, H, hd, rate, seed)
    same = [torch.from_numpy(np.repeat(rng.normal(size=(1, L, H * hd)).astype(np.float32),
                                       8, axis=0)).cuda() for _ in range(3)]
    out, _ = A.mha_dropout_fwd(*same, H, True, None, None, None, rate, seed)
    rows_differ = all(not torch.equal(out[0], out[b]) for b in range(1, 8))
    emit("kernels", check="dropout_mask", shape=name, kept_fraction=share,
         expected=1 - rate, tol=KEEP_TOL, identical_rows_differ=rows_differ)
    if abs(share - (1 - rate)) > KEEP_TOL or not rows_differ:
        raise SystemExit(f"dropout mask: kept {share} (want {1 - rate}), "
                         f"identical rows differ: {rows_differ}")
    return rows, worst


def check_masked_rows(A, inp, dout, masked, got, want, got_g, want_g) -> tuple:
    """(the output's max error on rows with a visible key, the per-row mask's
    figures) of a training case: the fully masked rows' output within
    MASKED_ROW_TOL of max |v| of the plain version and of the plain softmax
    over the raw scores (the same keep mask, no bias), not zeros; dq on the
    rows with a visible key within GRAD_TOL and every gradient within
    MASKED_ROW_TOL, relative; with the output gradient zeroed on the masked
    rows, every gradient within GRAD_TOL."""
    import torch

    vmax = inp["v"].detach().abs().max()
    out_err, masked_err = masked_row_errors(got, want, masked, vmax)
    plain = A.mha_dropout_reference if inp["dropout_rate"] > 0 else (
        lambda dropout_rate, seed, **kw: A.mha_reference(**kw))
    with torch.no_grad():
        no_mask = plain(**dict(inp, bias=None))
    _, plain_softmax_err = masked_row_errors(got, no_mask, masked, vmax)
    dq_err = float((got_g[0][~masked] - want_g[0][~masked]).abs().max()
                   / want_g[0].abs().max())
    grad_masked = grad_rel_err(got_g, want_g)
    quiet = dout.masked_fill(masked[..., None], 0.0)
    _, quiet_g = _grads(A.mha_dropout, inp, quiet)
    _, quiet_want = _grads(plain, inp, quiet)
    grad_quiet = grad_rel_err(quiet_g, quiet_want)
    grad_quiet_abs = max(float((a - b).abs().max()) for a, b in zip(quiet_g, quiet_want))
    extra = dict(masked_rows=int(masked.sum()), masked_row_err=masked_err,
                 plain_softmax_err=plain_softmax_err, masked_row_tol=MASKED_ROW_TOL,
                 dq_rel_err_visible_rows=dq_err, grad_rel_err_with_masked_rows=grad_masked,
                 grad_rel_err_quiet=grad_quiet, grad_max_abs_err_quiet=grad_quiet_abs)
    extra["ok"] = (masked_err <= MASKED_ROW_TOL and plain_softmax_err <= MASKED_ROW_TOL
                   and dq_err <= GRAD_TOL and grad_masked <= MASKED_ROW_TOL)
    return out_err, extra


def time_dropout(inp, dout) -> dict:
    """CUDA-event times of the training kernels, their plain version and
    scaled_dot_product_attention at one shape, with the bounds. SDPA's
    backward is timed on the device clock: its forward+backward and its
    forward alone, each captured in a CUDA graph (``graph_ms``); the
    difference of the two eager loops, which the host paces, stands beside
    it as ``library_bwd_host_ms``."""
    import torch

    from recboard_tpu_torch.ops import attention as A

    args = [inp[k].detach() for k in ("q", "k", "v")]
    bias = None if inp["bias"] is None else inp["bias"].detach()
    rest = (inp["num_heads"], inp["causal"], inp["key_padding_mask"], bias, None,
            inp["dropout_rate"], inp["seed"])
    need_dbias = bias is not None and inp["bias"].requires_grad
    out, lse = A.mha_dropout_fwd(*args, *rest)

    def bwd():
        return A.mha_dropout_bwd(*args, out, lse, dout, *rest[:2], inp["key_padding_mask"],
                                 bias, None, inp["dropout_rate"], inp["seed"], need_dbias)

    def plain_fwd():
        with torch.no_grad():
            return A.mha_dropout_reference(**inp)

    def plain_fwd_bwd():
        _grads(A.mha_dropout_reference, inp, dout)

    lib_fwd, lib_fwd_bwd = library_dropout_attention(inp)
    bounds = dropout_bound(inp, need_dbias)
    fwd_ms = cuda_ms(lambda: A.mha_dropout_fwd(*args, *rest))
    fwd_graph_ms = graph_ms(lambda: A.mha_dropout_fwd(*args, *rest))
    lib_graph_ms = graph_ms(lib_fwd)
    plain_ms = cuda_ms(plain_fwd)
    lib_ms = cuda_ms(lib_fwd)
    return dict(
        fwd_ms=fwd_ms,
        fwd_graph_ms=fwd_graph_ms,
        bwd_ms=cuda_ms(bwd),
        bwd_graph_ms=graph_ms(bwd),
        plain_fwd_ms=plain_ms,
        plain_bwd_ms=cuda_ms(plain_fwd_bwd, iters=50) - plain_ms,
        library_fwd_ms=lib_ms,
        library_fwd_graph_ms=lib_graph_ms,
        library_bwd_ms=graph_ms(lib_fwd_bwd) - lib_graph_ms,
        library_bwd_host_ms=cuda_ms(lib_fwd_bwd) - lib_ms,
        fwd_bound_ms=bounds["fwd"][0], fwd_bound_by=bounds["fwd"][1],
        bwd_bound_ms=bounds["bwd"][0], bwd_bound_by=bounds["bwd"][1],
    )


def ce_inputs(case, rng):
    """(h, weight, b, labels, g) of one CE case on the card: h (M, D),
    weight (V, D) as fc.weight holds it, b (V,) and h requiring their
    gradients; labels with the pad id 0 and the last id among them; g the
    weighted mean's row gradient, 0 on a third of the rows."""
    import torch

    name, M, D, V, big = case
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    h = t(rng.normal(size=(M, D)).astype(np.float32)).requires_grad_()
    weight = t((rng.normal(size=(V, D)) / math.sqrt(D)).astype(np.float32)).requires_grad_()
    bias = (rng.normal(size=V) * 0.1).astype(np.float32)
    labels = rng.integers(0, V, M)
    labels[:2] = [0, V - 1]
    if big:
        bias[::97] += CE_BIG
        labels[2::3] = 97 * rng.integers(0, (V - 1) // 97 + 1, len(labels[2::3]))
    b = t(bias).requires_grad_()
    w = (rng.random(M) >= 1 / 3).astype(np.float32)
    g = t(w / max(w.sum(), 1.0))
    return h, weight, b, t(labels.astype(np.int64)), g


def _ce_grads(fn, h, weight, b, labels, g):
    """(losses, [dh, dweight, db]) of fn(h, weight.T, b, labels) for the
    row gradient g."""
    import torch

    rows = fn(h, weight.T, b, labels)
    return rows.detach(), list(torch.autograd.grad(rows, (h, weight, b), g))


def _ce_float64_grads(h, weight, b, labels, g):
    """[dh, dweight, db] of the plain version run in float64 on the card."""
    from recboard_tpu_torch.ops import vocab_ce as K

    up = lambda x: x.detach().double().requires_grad_()  # noqa: E731
    return _ce_grads(K.fullvocab_ce_rows_reference, up(h), up(weight), up(b), labels,
                     g.double())[1]


def _ce_library(h, weight, b, labels):
    """F.cross_entropy over torch.addmm: one PyTorch call for K3's function."""
    import torch
    import torch.nn.functional as F

    return F.cross_entropy(torch.addmm(b, h, weight), labels, reduction="none")


def check_vocab_ce(rng):
    """K3 against its plain version on the card, forward (loss, and logz
    against the logits' logsumexp) and backward, and its gradients against
    a float64 run of the plain version; every case reruns the forward for
    the same bits; at the timed shape, a rerun of the gradients with the
    same bits, the library call's float64 error beside the kernel's, and
    times."""
    import torch

    from recboard_tpu_torch.ops import vocab_ce as K

    rows, worst = [], dict(fwd=0.0, bwd=0.0)
    for case in CE_SHAPES + CE_EXTRA:
        inp = ce_inputs(case, rng)
        h, weight, b, labels, g = inp
        want, want_g = _ce_grads(K.fullvocab_ce_rows_reference, *inp)
        got, got_g = _ce_grads(K.fullvocab_ce_rows, *inp)
        f64_g = _ce_float64_grads(*inp)
        loss, logz = K.vocab_ce_fwd(h.detach(), weight.detach().T, b.detach(), labels)
        again = K.vocab_ce_fwd(h.detach(), weight.detach().T, b.detach(), labels)
        with torch.no_grad():
            want_logz = torch.logsumexp(torch.addmm(b, h, weight.T), -1)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        logz_err = float((logz - want_logz).abs().max())
        fwd_same_bits = torch.equal(loss, again[0]) and torch.equal(logz, again[1])
        grad_err = max(float((a - b).abs().max()) for a, b in zip(got_g, want_g))
        grad_rel = grad_rel_err(got_g, want_g)
        grad_f64 = grad_rel_err(got_g, f64_g)
        finite = all(bool(torch.isfinite(x).all()) for x in [got, logz] + got_g)
        # rows whose loss gradient is 0 contribute exactly nothing
        zero_rows_exact = not bool(got_g[0][g == 0].any())
        worst["fwd"] = max(worst["fwd"], err, logz_err)
        worst["bwd"] = max(worst["bwd"], grad_err)
        row = dict(shape=case[0], M=case[1], D=case[2], V=case[3], max_abs_err=err,
                   logz_max_abs_err=logz_err, tol=CE_TOL, fwd_rerun_same_bits=fwd_same_bits,
                   grad_max_abs_err=grad_err, grad_rel_err=grad_rel,
                   grad_rel_tol=GRAD_TOL, grad_f64_rel_err=grad_f64,
                   grad_f64_rel_tol=CE_F64_TOL, plain_grad_f64_rel_err=grad_rel_err(
                       want_g, f64_g),
                   finite=finite, zero_rows_exact=zero_rows_exact,
                   max_loss=float(want.abs().max()))
        same_bits = True
        if case in CE_SHAPES:
            again_g = _ce_grads(K.fullvocab_ce_rows, *inp)[1]
            same_bits = all(torch.equal(a, b) for a, b in zip(got_g, again_g))
            lib_g = list(torch.autograd.grad(_ce_library(h, weight.T, b, labels),
                                             (h, weight, b), g))
            row.update(rerun_same_bits=same_bits,
                       library_grad_f64_rel_err=grad_rel_err(lib_g, f64_g),
                       fwd_ptxas=ptxas_lines("vocab_ce", "vocab_ce_fwd_kernel"))
            row.update(time_vocab_ce(*inp))
            del again_g, lib_g
        emit("kernels", kernel="vocab_ce", **row)
        if (not finite or not zero_rows_exact or not err <= CE_TOL or not logz_err <= CE_TOL
                or not grad_rel <= GRAD_TOL or not grad_f64 <= CE_F64_TOL or not same_bits
                or not fwd_same_bits):
            raise SystemExit(f"vocab_ce disagrees with its plain version at {case[0]}: "
                             f"loss {err}, logz {logz_err}, grads {grad_rel} (float64 "
                             f"{grad_f64}), zero rows exact {zero_rows_exact}, rerun same "
                             f"bits {same_bits} (forward {fwd_same_bits})")
        rows.append(row)
        del inp, want, want_g, got, got_g, f64_g, loss, logz, again
    check_vocab_ce_labels_outside(rng)
    return rows, worst


def check_vocab_ce_labels_outside(rng) -> None:
    """K3 with every label outside [0, V): in [V, round_up(V, 128)),
    where JAX's kernel picks a padded column of bias -1e30 (not
    reproduced), past that band, and negative. Each picks no logit: the
    forward's loss is exactly its logz, which holds the logits'
    logsumexp within CE_TOL, and the gradients are the logsumexp's
    within GRAD_TOL."""
    import torch

    from recboard_tpu_torch.ops import vocab_ce as K

    case = ("labels_outside", 70, 16, 300, False)
    h, weight, b, _, g = ce_inputs(case, rng)
    V = case[3]
    Vp = -(-V // K.VOCAB_TILE) * K.VOCAB_TILE
    outside = np.resize([V, V + 1, Vp - 1, Vp, 10 * V, -1, -V, -10 * V], case[1])
    labels = torch.from_numpy(outside.astype(np.int64)).cuda()
    loss, logz = K.vocab_ce_fwd(h.detach(), weight.detach().T, b.detach(), labels)
    got_g = _ce_grads(K.fullvocab_ce_rows, h, weight, b, labels, g)[1]
    want, want_g = _ce_grads(lambda h, W, b, y: torch.logsumexp(torch.addmm(b, h, W), -1),
                             h, weight, b, labels, g)
    torch.cuda.synchronize()
    row = dict(shape=case[0], M=case[1], D=case[2], V=V, padded_V=Vp,
               loss_is_logz=torch.equal(loss, logz),
               logz_max_abs_err=float((logz - want).abs().max()), tol=CE_TOL,
               grad_rel_err=grad_rel_err(got_g, want_g), grad_rel_tol=GRAD_TOL)
    emit("kernels", kernel="vocab_ce", **row)
    if (not row["loss_is_logz"] or not row["logz_max_abs_err"] <= CE_TOL
            or not row["grad_rel_err"] <= GRAD_TOL):
        raise SystemExit(f"vocab_ce: a label outside [0, V) must pick no logit: {row}")


def time_vocab_ce(h, weight, b, labels, g) -> dict:
    """Times of K3's forward and backward, by CUDA events and on the device
    clock (CUDA-graph replays, which also show that neither wrapper waits
    on the host), of its plain version and of F.cross_entropy over
    torch.addmm (forward, also from a graph, and autograd backward). The
    bounds: each input read
    once and each output written once; the forward 2*M*D*V FLOP and the
    backward 6*M*D*V (the logits again, dh and dW, the TPU kernel's work),
    as the least time three times that at the TF32 rate (split precision
    keeps float32's accuracy) and beside it at the float32 rate."""
    import torch

    from recboard_tpu_torch.ops import vocab_ce as K

    hd, W, bd = h.detach(), weight.detach().T, b.detach()
    M, D = hd.shape
    V = W.shape[1]
    loss, logz = K.vocab_ce_fwd(hd, W, bd, labels)
    slots = K._sm_count(hd.device.index) * K.fwd_blocks_per_sm(D)

    def fwd():
        return K.vocab_ce_fwd(hd, W, bd, labels)

    def bwd():
        return K.vocab_ce_bwd(hd, W, bd, labels, logz, g)

    def plain_fwd():
        with torch.no_grad():
            return K.fullvocab_ce_rows_reference(hd, W, bd, labels)

    def library_fwd():
        with torch.no_grad():
            return _ce_library(hd, W, bd, labels)

    def library_fwd_bwd():
        torch.autograd.grad(_ce_library(h, weight.T, b, labels), (h, weight, b), g)

    fwd_bytes = nbytes(hd, W, bd, labels, loss, logz)
    fwd_f32 = bound(fwd_bytes, 2 * M * D * V)
    fwd_tf32 = bound(fwd_bytes, 3 * 2 * M * D * V, TF32_FLOP_PER_S)
    bwd_bytes = nbytes(hd, W, bd, labels, logz, g) + nbytes(hd, W, bd)
    bwd_f32 = bound(bwd_bytes, 6 * M * D * V)
    bwd_tf32 = bound(bwd_bytes, 3 * 6 * M * D * V, TF32_FLOP_PER_S)
    plain_ms = cuda_ms(plain_fwd, iters=20, warmup=3)
    lib_ms = cuda_ms(library_fwd, iters=20, warmup=3)
    return dict(
        fwd_ms=cuda_ms(fwd, iters=50, warmup=5),
        fwd_graph_ms=graph_ms(fwd, calls=20),
        fwd_blocks_per_sm=K.fwd_blocks_per_sm(D),
        fwd_splits=K.splits(-(-V // K.VOCAB_TILE), -(-M // K.ROW_TILE), slots),
        bwd_ms=cuda_ms(bwd, iters=20, warmup=3),
        bwd_graph_ms=graph_ms(bwd, calls=10),
        plain_fwd_ms=plain_ms,
        plain_bwd_ms=cuda_ms(lambda: _ce_grads(K.fullvocab_ce_rows_reference,
                                               h, weight, b, labels, g),
                             iters=10, warmup=3) - plain_ms,
        library_fwd_ms=lib_ms,
        library_fwd_graph_ms=graph_ms(library_fwd, calls=10),
        library_bwd_ms=cuda_ms(library_fwd_bwd, iters=10, warmup=3) - lib_ms,
        fwd_bound_ms=fwd_tf32[0], fwd_bound_by=fwd_tf32[1],
        fwd_f32_bound_ms=fwd_f32[0], fwd_f32_bound_by=fwd_f32[1],
        bwd_bound_ms=bwd_tf32[0], bwd_bound_by=bwd_tf32[1],
        bwd_f32_bound_ms=bwd_f32[0], bwd_f32_bound_by=bwd_f32[1],
    )


def ss_inputs(case, rng):
    """(user, pos, neg, weights) of one K5 case on the card, the three
    embeddings requiring their gradients; the case's share of rows of
    weight 0."""
    import torch

    name, M, K, D, tau, normalised, zero_share = case
    scale = 1.0 if normalised else 3.0 / math.sqrt(D)
    out = []
    for n in (M, M, K):
        x = rng.normal(size=(n, D)) * scale
        if normalised:
            x /= np.linalg.norm(x, axis=1, keepdims=True)
        out.append(torch.from_numpy(x.astype(np.float32)).cuda().requires_grad_())
    w = (rng.random(M) >= zero_share).astype(np.float32)
    return (*out, torch.from_numpy(w).cuda())


def check_sampled_softmax(rng):
    """K5 against its plain versions on the card: logz and pos_logit
    against ``sampled_softmax_shared_fwd_reference`` (the rows of weight
    != 0 alone), exactly 0 on rows of weight 0; the backward called
    directly against ``sampled_softmax_shared_bwd_reference`` on the
    forward's outputs (the rows of s != 0 alone), du and dpos exactly 0 on
    rows of s = 0; the same bits on a rerun of either pass; with no
    weighted row (``no_live_row``) every output exactly 0; the loss's
    gradients in user, pos and neg against autograd of the plain loss;
    everything finite; times at the timed shape; then
    ``check_shared_same_logits``."""
    import torch

    from recboard_tpu_torch.ops import losses as S

    rows, worst = [], dict(fwd=0.0, bwd=0.0)
    for case in SS_SHAPES + SS_EXTRA:
        name, M, K, D, tau, _, zero_share = case
        user, pos, neg, w = ss_inputs(case, rng)
        u, p, n = user.detach(), pos.detach(), neg.detach()
        logz, pos_logit = S.sampled_softmax_shared_fwd(u, p, n, w, tau)
        fwd_again = S.sampled_softmax_shared_fwd(u, p, n, w, tau)
        want_logz, want_pl = S.sampled_softmax_shared_fwd_reference(u, p, n, w, tau)
        want = S.sampled_softmax_loss_shared_reference(user, pos, neg, w, tau)
        want_g = torch.autograd.grad(want, (user, pos, neg))
        got = S.SampledSoftmaxShared.apply(user, pos, neg, w, tau)
        got_g = torch.autograd.grad(got, (user, pos, neg))
        s = (w / w.sum().clamp_min(1.0)).contiguous()
        bwd = S.sampled_softmax_shared_bwd(u, p, n, logz, pos_logit, s, tau)
        again = S.sampled_softmax_shared_bwd(u, p, n, logz, pos_logit, s, tau)
        plain_bwd = S.sampled_softmax_shared_bwd_reference(u, p, n, logz, pos_logit, s, tau)
        torch.cuda.synchronize()
        err = max(rel_err(logz, want_logz), rel_err(pos_logit, want_pl))
        abs_err = max(float((logz - want_logz).abs().max()),
                      float((pos_logit - want_pl).abs().max()))
        g_rel = grad_rel_err(got_g, want_g)
        g_abs = max(float((a - b).abs().max()) for a, b in zip(got_g, want_g))
        bwd_rel = grad_rel_err(bwd, plain_bwd)
        bwd_abs = max(float((a - b).abs().max()) for a, b in zip(bwd, plain_bwd))
        g_tol = SS_LARGE_GRAD_TOL if name == "large_logits" else GRAD_TOL
        zero = w == 0
        zero_rows_exact = not any(bool(x[zero].any()) for x in (
            logz, pos_logit, got_g[0], got_g[1], *bwd[:2]))
        all_zero = not any(bool(x.any()) for x in (logz, pos_logit, *got_g, *bwd))
        same_bits = all(torch.equal(a, b) for a, b in zip(
            (logz, pos_logit, *bwd), (*fwd_again, *again)))
        finite = all(bool(torch.isfinite(x).all())
                     for x in (logz, pos_logit, got, *got_g, *bwd))
        worst["fwd"] = max(worst["fwd"], abs_err)
        worst["bwd"] = max(worst["bwd"], g_abs, bwd_abs)
        row = dict(shape=name, M=M, K=K, D=D, tau=tau, zero_share=zero_share,
                   live_rows=int((s != 0).sum()), max_abs_err=abs_err, max_rel_err=err,
                   tol=SS_TOL, loss_err=abs(float(got.detach()) - float(want.detach())),
                   grad_max_abs_err=g_abs, grad_rel_err=g_rel, grad_rel_tol=g_tol,
                   bwd_max_abs_err=bwd_abs, bwd_rel_err=bwd_rel, same_bits=same_bits,
                   finite=finite, zero_rows_exact=zero_rows_exact, all_zero=all_zero,
                   max_logit=float(want_logz.abs().max()))
        if case in SS_SHAPES:
            row.update(time_sampled_softmax(user, pos, neg, w, tau))
        emit("kernels", kernel="sampled_softmax_shared", **row)
        if (not finite or not zero_rows_exact or not same_bits or not err <= SS_TOL
                or not g_rel <= g_tol or not bwd_rel <= g_tol
                or (name == "no_live_row" and not all_zero)):
            raise SystemExit(f"sampled_softmax_shared disagrees with its plain versions at "
                             f"{name}: fwd {err}, grads {g_rel}, backward {bwd_rel}, zero "
                             f"rows exact {zero_rows_exact}, same bits {same_bits}, all "
                             f"zero {all_zero}")
        rows.append(row)
        del user, pos, neg, w, got_g, want_g, bwd, again, plain_bwd, fwd_again
    check_shared_same_logits(rng)
    return rows, worst


def check_shared_same_logits(rng) -> None:
    """K5's backward takes the forward's logits bit for bit. At K = 1 with
    the positive's logit 28 or more below the negative's, the forward's
    logz is the negative's logit x exactly (1 + exp(-28) rounds to 1 in
    float32), so the backward's P = s exp(x' - logz), from its own
    recomputed logit x', is s exactly if and only if x' = x. u's entries
    are +-1/8, s a power of 2 (1,024 rows of weight 1 of 2,048) and 1 /
    tau 4: every product and sum of P^T u is exact, so dneg = s sum(u) / tau
    exactly, whatever order the tensor cores add in; the negative, a unit
    vector of normal entries, is not a TF32 value, so its logits round.
    Fails unless dneg is exactly that."""
    import torch

    from recboard_tpu_torch.ops import losses as S

    M, D, tau = 2_048, 64, 0.25
    neg = rng.normal(size=(1, D))
    neg /= np.linalg.norm(neg)
    # rows mostly of neg's signs, so that their logits are far from 0
    signs = np.sign(neg) * np.where(rng.random((M, D)) < 0.25, -1.0, 1.0)
    w = np.zeros(M)
    w[rng.permutation(M)[:M // 2]] = 1.0
    u, p, n, w = (torch.from_numpy(x.astype(np.float32)).cuda()
                  for x in (signs / 8, -signs, neg, w))
    logz, pos_logit = S.sampled_softmax_shared_fwd(u, p, n, w, tau)
    s = (w / w.sum()).contiguous()
    _, _, dneg = S.sampled_softmax_shared_bwd(u, p, n, logz, pos_logit, s, tau)
    live = w != 0
    want = (u[live].double().sum(0) * float(s[live][0])).float()[None] * (1.0 / tau)
    gap = float((pos_logit - logz)[live].max())
    exact = bool(torch.equal(dneg, want))
    emit("kernels", kernel="sampled_softmax_shared", shape="one_negative", M=M, K=1, D=D,
         tau=tau, live_rows=int(live.sum()), positive_gap=gap,
         dneg_max_abs_err=float((dneg - want).abs().max()), same_logits_both_ways=exact)
    if not exact or not gap <= -28.0:
        raise SystemExit(f"sampled_softmax_shared: the backward does not take the forward's "
                         f"logits at one negative (dneg exact {exact}, positive gap {gap})")


def time_sampled_softmax(user, pos, neg, w, tau) -> dict:
    """Times of K5's forward and backward, by CUDA events and on the device
    clock (CUDA-graph replays, which also show neither pass waits on the
    host), both by part from torch.profiler (live, the list of rows of
    w != 0 or s != 0; tiles, the tensor-core products; merge or finish,
    the partials' fixed-order merges or sums) with their launches per call
    and ptxas lines, and with every row weighted on the device clock;
    beside them the plain versions (the forward's own,
    ``sampled_softmax_shared_fwd_reference``; the backward's own,
    ``sampled_softmax_shared_bwd_reference``; the plain loss on every row,
    ``plain_loss_ms``, and its autograd backward) and F.cross_entropy over
    the concatenated positive and torch.addmm logits (forward, and
    autograd backward: on the rows of weight != 0, taken by index before
    the timing, and on every row; on the device clock, the backward a
    graph's forward and backward less its forward, and by CUDA events,
    ``library_bwd_host_ms`` and ``library_bwd_all_rows_host_ms``, which
    the host paces). The bounds: each input read once and each output
    written once. The forward reads w, neg and the weighted rows of u and
    p, writes logz and pos_logit for every row, and does 2*K*D FLOP a
    weighted row; the backward reads s and neg and the live rows of u, p,
    logz and pos_logit, writes du and dpos for every row and dneg, and
    does 6*K*D FLOP a live row (the logits again, du and dneg); each as
    three TF32 products at the tensor-core rate (``fwd_bound_ms``,
    ``bwd_bound_ms``) and at the float32 rate (``fwd_f32_bound_ms``,
    ``bwd_f32_bound_ms``); ``fwd_all_rows_bound_ms`` and
    ``bwd_all_rows_bound_ms`` are the bounds of the all-row passes they
    replaced (every row's inputs, 2*M*K*D and 6*M*K*D FLOP at the float32
    rate)."""
    import torch
    import torch.nn.functional as F

    from recboard_tpu_torch.ops import losses as S

    u, p, n = user.detach(), pos.detach(), neg.detach()
    M, D = u.shape
    K = n.shape[0]
    logz, pos_logit = S.sampled_softmax_shared_fwd(u, p, n, w, tau)
    W = w.sum().clamp_min(1.0)
    s = (w / W).contiguous()
    every_s = torch.full_like(s, 1.0 / M)
    ones = torch.ones_like(w)
    on = torch.nonzero(s).flatten()
    live = len(on)
    zero = torch.zeros((), device=u.device)

    def library(uu, pp, nn_, ww):
        logits = torch.cat([((uu * pp).sum(-1) / tau)[:, None],
                            torch.addmm(zero, uu, nn_.T, beta=0, alpha=1 / tau)], 1)
        labels = torch.zeros(uu.shape[0], dtype=torch.long, device=uu.device)
        return (F.cross_entropy(logits, labels, reduction="none") * ww).sum() / W

    def plain(uu, pp, nn_, ww):
        return S.sampled_softmax_loss_shared_reference(uu, pp, nn_, ww, tau)

    # fresh leaves: the caller's hold autograd nodes made on the default
    # stream, on which a captured backward may not wait
    u_all, p_all, n_all = (x.clone().requires_grad_() for x in (u, p, n))
    u_on, p_on = (x[on].clone().requires_grad_() for x in (u, p))
    w_on = w[on].contiguous()
    every = (u_all, p_all, n_all, w)
    live_rows = (u_on, p_on, n_all, w_on)

    def no_grad(fn, args):
        def call():
            with torch.no_grad():
                return fn(*(x.detach() for x in args[:3]), args[3])
        return call

    def fwd_bwd(fn, args):
        return lambda: torch.autograd.grad(fn(*args), args[:3])

    def fwd():
        return S.sampled_softmax_shared_fwd(u, p, n, w, tau)

    def bwd():
        return S.sampled_softmax_shared_bwd(u, p, n, logz, pos_logit, s, tau)

    fwd_bytes = nbytes(w, n, logz, pos_logit) + live * 2 * D * u.element_size()
    fwd_bound = bound(fwd_bytes, 3 * 2 * live * K * D, TF32_FLOP_PER_S)
    fwd_f32 = bound(fwd_bytes, 2 * live * K * D)
    fwd_all_rows = bound(nbytes(u, p, n, logz, pos_logit), 2 * M * K * D)
    bwd_bytes = nbytes(s, n) + nbytes(u, p, n) + live * (2 * D + 2) * u.element_size()
    bwd_bound = bound(bwd_bytes, 3 * 6 * live * K * D, TF32_FLOP_PER_S)
    bwd_f32 = bound(bwd_bytes, 6 * live * K * D)
    bwd_all_rows = bound(nbytes(u, p, n, logz, pos_logit, s) + nbytes(u, p, n), 6 * M * K * D)
    plain_ms = cuda_ms(no_grad(plain, every), iters=50, warmup=5)
    lib_ms = cuda_ms(no_grad(library, every), iters=50, warmup=5)
    lib_on_ms = cuda_ms(no_grad(library, live_rows), iters=50, warmup=5)
    lib_graph_ms = graph_ms(no_grad(library, every), calls=10)
    lib_on_graph_ms = graph_ms(no_grad(library, live_rows), calls=10)
    fwd_parts, fwd_launches = kernel_parts(fwd, SS_FWD_PARTS, "sampled_softmax_shared_fwd", 20)
    parts, bwd_launches = kernel_parts(bwd, SS_BWD_PARTS, "sampled_softmax_shared_bwd", 20)
    return dict(
        fwd_ms=cuda_ms(fwd),
        fwd_graph_ms=graph_ms(fwd, calls=20),
        fwd_every_row_graph_ms=graph_ms(
            lambda: S.sampled_softmax_shared_fwd(u, p, n, ones, tau), calls=20),
        fwd_parts_ms=fwd_parts,
        fwd_launches_per_call=fwd_launches,
        fwd_ptxas=ptxas_lines("sampled_softmax", "shared_fwd_tile_kernel"),
        bwd_ms=cuda_ms(bwd),
        bwd_graph_ms=graph_ms(bwd, calls=20),
        bwd_every_row_graph_ms=graph_ms(
            lambda: S.sampled_softmax_shared_bwd(u, p, n, logz, pos_logit, every_s, tau),
            calls=20),
        bwd_parts_ms=parts,
        bwd_launches_per_call=bwd_launches,
        bwd_ptxas=ptxas_lines("sampled_softmax", "shared_bwd_tile_kernel"),
        live_rows=live,
        plain_fwd_ms=cuda_ms(lambda: S.sampled_softmax_shared_fwd_reference(u, p, n, w, tau),
                             iters=50, warmup=5),
        plain_loss_ms=plain_ms,
        plain_bwd_ms=cuda_ms(lambda: S.sampled_softmax_shared_bwd_reference(
            u, p, n, logz, pos_logit, s, tau), iters=50, warmup=5),
        plain_bwd_autograd_ms=cuda_ms(fwd_bwd(plain, every), iters=50, warmup=5) - plain_ms,
        library_fwd_ms=lib_ms,
        library_fwd_graph_ms=lib_graph_ms,
        library_fwd_on_rows_ms=lib_on_ms,
        library_fwd_on_rows_graph_ms=lib_on_graph_ms,
        library_bwd_ms=graph_ms(fwd_bwd(library, live_rows), calls=10) - lib_on_graph_ms,
        library_bwd_all_rows_ms=graph_ms(fwd_bwd(library, every), calls=10) - lib_graph_ms,
        library_bwd_host_ms=cuda_ms(fwd_bwd(library, live_rows), iters=50, warmup=5) - lib_on_ms,
        library_bwd_all_rows_host_ms=(
            cuda_ms(fwd_bwd(library, every), iters=50, warmup=5) - lib_ms),
        fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
        fwd_f32_bound_ms=fwd_f32[0], fwd_f32_bound_by=fwd_f32[1],
        fwd_all_rows_bound_ms=fwd_all_rows[0], fwd_all_rows_bound_by=fwd_all_rows[1],
        bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1],
        bwd_f32_bound_ms=bwd_f32[0], bwd_f32_bound_by=bwd_f32[1],
        bwd_all_rows_bound_ms=bwd_all_rows[0], bwd_all_rows_bound_by=bwd_all_rows[1],
    )


def ssc_inputs(case, rng):
    """(user, ids, table, weights) of one K4 case on the card: user and table
    requiring their gradients, int32 ids (M, C) with the positive in column
    0, a share of rows of weight 0. Outside HSTU's shapes the weighted rows
    draw from the first three quarters of the table only, so that some
    table rows are drawn by rows of weight 0 alone, and the JAX test's
    shape has two ids out of the table's range."""
    import torch

    name, M, C, D, N, tau, kind, zero_share = case

    def rows(n):
        x = rng.normal(size=(n, D))
        if kind == "l2":
            x /= np.linalg.norm(x, axis=1, keepdims=True)
        elif kind == "large":
            x *= 3.0 / math.sqrt(D)
        return torch.from_numpy(x.astype(np.float32)).cuda().requires_grad_()

    w = (rng.random(M) >= zero_share).astype(np.float32)
    ids = rng.integers(0, N, size=(M, C))
    if kind == "l2":
        ids[w == 0, 0] = 0  # HSTU's pad positions: item 0, weight 0
    else:
        ids[w > 0] = rng.integers(0, 3 * N // 4, size=(int((w > 0).sum()), C))
    if name == "jax_test":
        ids[0, 1], ids[1, 2] = -1, N + 7  # taken as JAX's gather takes them
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return rows(M), t(ids.astype(np.int32)), rows(N), t(w)


def transpose_is_stable_sort(scratch, C: int, N: int) -> bool:
    """Whether K4 backward's transpose, as its segment kernel walks it (each
    table row's runs in chunk order), visits the compact entries exactly
    in the order of ``torch.sort(stable=True)`` of their ids, and each
    chunk's run table holds exactly its ids' counts. A check: torch.sort
    runs here only."""
    import torch

    from recboard_tpu_torch.ops.losses import CAND_CHUNK

    entries = int(scratch["n_live"]) * C
    keys = scratch["keys"][:entries].long()
    order = scratch["order"][:entries].long()
    chunks = -(-entries // CAND_CHUNK)
    runs = scratch["runs"][:chunks].long()
    start, count = runs & 0xFFFF, runs >> 16
    slot = torch.arange(entries, device=keys.device)
    k, local = slot // CAND_CHUNK, slot % CAND_CHUNK
    key = keys[order]  # the id at each sorted slot of each chunk
    st = start[k, key]
    inside = bool(((local >= st) & (local < st + count[k, key])).all())
    hist = torch.zeros_like(count).index_put_((k, key), torch.ones_like(k), accumulate=True)
    # each (table row, chunk) group's first position in the walk
    per_row = count.T.reshape(-1)
    first = (torch.cumsum(per_row, 0) - per_row).reshape(N, chunks)
    walk = torch.empty_like(order)
    walk[first[key, k] + local - st] = order
    return inside and torch.equal(hist, count) and torch.equal(
        walk, torch.sort(keys, stable=True).indices)


def check_sampled_softmax_cand(rng):
    """K4 against its plain versions on the card: logz and pos_logit against
    the weighted plain forward, exactly 0 on rows of weight 0; du and
    dtable against the backward's formula; the loss and its gradients
    through SampledSoftmaxCandidates against autograd of the plain loss; du
    exactly 0 on rows of weight 0 and dtable on the table rows no weighted
    row drew; the same bits on a rerun; the backward's transpose against a
    stable sort, exactly; at one candidate, du and dtable exactly 0 (the
    backward takes the forward's logits); times at the timed shape."""
    import torch

    from recboard_tpu_torch.ops import losses as S

    rows, worst = [], dict(fwd=0.0, bwd=0.0)
    for case in SSC_SHAPES + SSC_EXTRA:
        name, M, C, D, N, tau, kind, _ = case
        user, ids, table, w = ssc_inputs(case, rng)
        u, e = user.detach(), table.detach()
        s = (w / w.sum().clamp_min(1.0)).contiguous()
        out = S.sampled_softmax_cand_fwd(u, ids, e, w, tau)
        du, dtable, scratch = S._cand_bwd(u, ids, e, out[0], s, tau)
        out += (du, dtable)
        again = S.sampled_softmax_cand_fwd(u, ids, e, w, tau)
        again += S.sampled_softmax_cand_bwd(u, ids, e, again[0], s, tau)
        want = S.sampled_softmax_cand_rows_reference(u, ids, e, tau, weights=w)
        # the backward's formula takes every row's logz: a row of s = 0 then
        # gives 0, where the weighted forward's 0 could give 0 x inf
        every_z = S.sampled_softmax_cand_rows_reference(u, ids, e, tau)[0]
        want += S.sampled_softmax_cand_bwd_reference(u, ids, e, every_z, s, tau)
        loss = S.SampledSoftmaxCandidates.apply(user, ids, table, w, tau)
        loss_g = torch.autograd.grad(loss, (user, table))
        want_loss = S.sampled_softmax_loss_reference(user, ids, table, w, tau)
        want_loss_g = torch.autograd.grad(want_loss, (user, table))
        torch.cuda.synchronize()
        same_bits = all(torch.equal(a, b) for a, b in zip(out, again))
        err = max(rel_err(out[0], want[0]), rel_err(out[1], want[1]))
        abs_err = max(float((a - b).abs().max()) for a, b in zip(out[:2], want[:2]))
        g_rel = max(grad_rel_err(out[2:], want[2:]), grad_rel_err(loss_g, want_loss_g))
        g_abs = max(float((a - b).abs().max())
                    for a, b in zip(out[2:] + loss_g, want[2:] + want_loss_g))
        zero = w == 0
        drawn = torch.zeros(N, dtype=torch.bool, device=ids.device)
        drawn[S._take_ids(ids[~zero], N).reshape(-1)] = True
        zeros_exact = not bool(out[0][zero].any() or out[1][zero].any() or out[2][zero].any()
                               or out[3][~drawn].any() or loss_g[0][zero].any()
                               or loss_g[1][~drawn].any())
        finite = all(bool(torch.isfinite(x).all()) for x in out + loss_g + (loss,))
        same_logits = C > 1 or not bool(out[2].any() or out[3].any())
        transpose_exact = transpose_is_stable_sort(scratch, C, N)
        worst["fwd"] = max(worst["fwd"], abs_err)
        worst["bwd"] = max(worst["bwd"], g_abs)
        row = dict(shape=name, M=M, C=C, D=D, N=N, tau=tau, inputs=kind,
                   weighted_rows=int((~zero).sum()), undrawn_table_rows=int((~drawn).sum()),
                   max_abs_err=abs_err, max_rel_err=err, tol=SS_TOL,
                   loss_err=abs(float(loss.detach()) - float(want_loss.detach())),
                   grad_max_abs_err=g_abs, grad_rel_err=g_rel, grad_rel_tol=GRAD_TOL,
                   finite=finite, zeros_exact=zeros_exact, same_bits=same_bits,
                   same_logits_both_ways=same_logits, transpose_exact=transpose_exact,
                   live_entries=int(scratch["n_live"]) * C,
                   max_logit=float(want[0].abs().max()))
        if case in SSC_SHAPES:
            row.update(time_sampled_softmax_cand(user, ids, table, w, tau, every_z, s))
        emit("kernels", kernel="sampled_softmax_cand", **row)
        if (not finite or not zeros_exact or not same_bits or not transpose_exact
                or not same_logits or not err <= SS_TOL or not g_rel <= GRAD_TOL):
            raise SystemExit(f"sampled_softmax_cand disagrees with its plain version at "
                             f"{name}: fwd {err}, grads {g_rel}, zeros exact {zeros_exact}, "
                             f"same bits {same_bits}, transpose exact {transpose_exact}, "
                             f"same logits both ways {same_logits}")
        rows.append(row)
        del user, ids, table, w, out, again, want, every_z, loss_g, want_loss_g, scratch
    return rows, worst


def time_sampled_softmax_cand(user, ids, table, w, tau, logz, s) -> dict:
    """CUDA-event times of K4's forward and backward, both also on the
    device clock (CUDA-graph replays, which also show they never wait on
    the host) and by part from torch.profiler (the forward: live, the list
    of rows of weight != 0, and rows; the backward: live, the list of rows
    of nonzero gradient, rows, transpose (the chunk sorts) and segments);
    the backward's launches per call against those of the backward it
    replaced (row kernel, the stable torch.sort of all M * C ids, segment
    kernel; the sort timed alone as ``sort_ms``); each pass's weighted
    entries and the L2 bytes and rate of its gathers of D-wide rows; the
    plain versions, and torch.logsumexp over torch.bmm of the F.embedding
    gather: the forward on the weighted rows (taken by index before the
    timing; on every row as ``library_fwd_all_rows_ms``), and the autograd
    backward. The forward also with every row weighted, on the device
    clock (``fwd_every_row_graph_ms``). The bounds: each input the
    function needs read once and each output written once. The forward reads w, the weighted rows'
    user rows and ids and the table, writes logz and pos_logit, and does
    2*C*D FLOP per weighted row (``fwd_all_rows_bound_ms``: every row's
    inputs and FLOP, the bound before the forward took the weights); the
    backward 6*C*D FLOP per row of nonzero gradient (the logits again, du
    and dtable), the only rows whose user row, ids and logz it reads (a
    row of s = 0 gives du = 0 and adds nothing to dtable)."""
    import torch
    import torch.nn.functional as F

    from recboard_tpu_torch.ops import losses as S

    u, e = user.detach(), table.detach()
    M, D = u.shape
    C = ids.shape[1]
    ids_long = S._take_ids(ids, e.shape[0])
    W = w.sum().clamp_min(1.0)
    weighted = int((s != 0).sum())
    on = torch.nonzero(w).flatten()
    u_on, ids_on = u[on].contiguous(), ids_long[on].contiguous()

    def library(uu, ee, rows_ids):
        logits = torch.bmm(F.embedding(rows_ids, ee), uu[:, :, None])[..., 0] / tau
        return torch.logsumexp(logits, -1), logits[:, 0]

    def library_fwd():
        with torch.no_grad():
            return library(u_on, e, ids_on)

    def library_fwd_all_rows():
        with torch.no_grad():
            return library(u, e, ids_long)

    def library_fwd_bwd():
        lz, pl = library(user, table, ids_long)
        torch.autograd.grad(((lz - pl) * w).sum() / W, (user, table))

    def plain_fwd():
        with torch.no_grad():
            return S.sampled_softmax_cand_rows_reference(u, ids, e, tau, weights=w)

    def fwd():
        return S.sampled_softmax_cand_fwd(u, ids, e, w, tau)

    def bwd():
        return S.sampled_softmax_cand_bwd(u, ids, e, logz, s, tau)

    flat = ids.reshape(-1)
    row_bytes = u[0].nbytes + ids[0].nbytes
    fwd_bound = bound(nbytes(w, e, logz, logz) + weighted * row_bytes, 2 * weighted * C * D)
    fwd_all_rows_bound = bound(nbytes(u, ids, e, logz, logz), 2 * M * C * D)
    # s and the table in, du and dtable out, and the weighted rows' inputs
    bwd_bound = bound(nbytes(s, e) + nbytes(u, e) + weighted * (row_bytes + logz[0].nbytes),
                      6 * weighted * C * D)
    lib_all_ms = cuda_ms(library_fwd_all_rows, iters=20, warmup=3)
    fwd_parts, fwd_launches = kernel_parts(fwd, SSC_FWD_PARTS, "sampled_softmax_cand_fwd", 20)
    parts, bwd_launches = kernel_parts(bwd, SSC_BWD_PARTS, "sampled_softmax_cand_bwd", 20)
    sort_launches = sum(n for _, _, n in device_kernels(
        lambda: torch.sort(flat, stable=True), calls=1))
    live_entries = weighted * C
    fwd_gather_gb = live_entries * D * 4 / 1e9
    gather_gb = 2 * fwd_gather_gb
    fwd_graph = graph_ms(fwd, calls=20)
    bwd_graph = graph_ms(bwd, calls=20)
    ones = torch.ones_like(w)
    return dict(
        fwd_ms=cuda_ms(fwd, iters=50, warmup=5),
        fwd_graph_ms=fwd_graph,
        fwd_every_row_graph_ms=graph_ms(lambda: S.sampled_softmax_cand_fwd(u, ids, e, ones, tau),
                                        calls=20),
        fwd_parts_ms=fwd_parts,
        fwd_launches_per_call=fwd_launches,
        fwd_ptxas=ptxas_lines("sampled_softmax_cand", "cand_fwd_kernel"),
        fwd_gather_gb=fwd_gather_gb,
        fwd_gather_tb_per_s=fwd_gather_gb / fwd_graph,
        bwd_ms=cuda_ms(bwd, iters=50, warmup=5),
        bwd_graph_ms=bwd_graph,
        bwd_parts_ms=parts,
        bwd_launches_per_call=bwd_launches,
        replaced_bwd_launches_per_call=2 + sort_launches,
        live_entries=live_entries,
        bwd_gather_gb=gather_gb,
        bwd_gather_tb_per_s=gather_gb / bwd_graph,
        sort_ms=cuda_ms(lambda: torch.sort(flat, stable=True), iters=50, warmup=5),
        plain_fwd_ms=cuda_ms(plain_fwd, iters=20, warmup=3),
        plain_bwd_ms=cuda_ms(lambda: S.sampled_softmax_cand_bwd_reference(u, ids, e, logz, s, tau),
                             iters=10, warmup=2),
        library_fwd_ms=cuda_ms(library_fwd, iters=20, warmup=3),
        library_fwd_all_rows_ms=lib_all_ms,
        library_bwd_ms=cuda_ms(library_fwd_bwd, iters=10, warmup=2) - lib_all_ms,
        fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
        fwd_all_rows_bound_ms=fwd_all_rows_bound[0],
        fwd_all_rows_bound_by=fwd_all_rows_bound[1],
        bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1],
        gathered_gb_per_pass=M * C * D * 4 / 1e9,
    )


def check_dropout_mask(rng):
    """K7 against its plain version on the card: the masks bit-equal, the
    kept share within KEEP_TOL of 1 - rate, the values exactly {0, 1 / (1 -
    rate)}, the same seed the same mask and another seed another; times at
    the timed shape. Then K7's own path, ``ops.dropout.dropout`` as a caller
    uses it (no model calls it): DROP_PATH_STEPS forward and backward passes
    at the timed shape, counted from 0. Returns the rows and that path's
    launches."""
    import torch

    from recboard_tpu_torch.ops import dropout as Dr

    rows = []
    for case in DROP_MASK_SHAPES + DROP_MASK_EXTRA:
        name, shape, rate = case
        seed = torch.tensor([int(rng.integers(-(2**31), 2**31 - 1))], dtype=torch.int32,
                            device="cuda")
        got = Dr.dropout_mask(seed, shape, rate)
        want = Dr.dropout_mask_reference(seed, shape, rate)
        same_seed = torch.equal(got, Dr.dropout_mask(seed, shape, rate))
        other_seed = not torch.equal(got, Dr.dropout_mask(seed ^ 1, shape, rate))
        torch.cuda.synchronize()
        kept = float((got != 0).float().mean())
        values = sorted(torch.unique(got).tolist())
        scale = float(np.float32(1.0 / (1.0 - rate)))
        row = dict(shape=name, dims=list(shape), rate=rate, bit_equal=torch.equal(got, want),
                   max_abs_err=float((got - want).abs().max()), same_seed_equal=same_seed,
                   other_seed_differs=other_seed, kept_fraction=kept, expected=1 - rate,
                   tol=KEEP_TOL, values=values)
        if case in DROP_MASK_SHAPES:
            row.update(time_dropout_mask(seed, shape, rate))
        emit("kernels", kernel="dropout_mask", **row)
        if (not row["bit_equal"] or not same_seed or not other_seed
                or abs(kept - (1 - rate)) > KEEP_TOL or values != [0.0, scale]):
            raise SystemExit(f"dropout_mask at {name}: {row}")
        rows.append(row)
        del got, want

    _, shape, rate = DROP_MASK_SHAPES[0]
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().requires_grad_()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.integers(2**31)))
    scale = float(np.float32(1.0 / (1.0 - rate)))
    Dr.dropout_mask.launches = 0
    kept, exact = [], True
    for _ in range(DROP_PATH_STEPS):
        x.grad = None
        y = Dr.dropout(x, rate, gen)
        y.backward(torch.ones_like(y))
        # y = x * mask and dy/dx = mask, mask in {0, 1 / (1 - rate)}
        exact &= bool(torch.equal(y.detach(), x.detach() * x.grad)) and bool(
            ((x.grad == 0) | (x.grad == scale)).all())
        kept.append(float((x.grad != 0).float().mean()))
    torch.cuda.synchronize()
    launches = Dr.dropout_mask.launches
    emit("kernels", kernel="dropout_mask", path="ops.dropout.dropout", dims=list(shape),
         rate=rate, steps=DROP_PATH_STEPS, launches=launches, kept_fraction=kept,
         exact=exact)
    if (launches != DROP_PATH_STEPS or not exact
            or max(abs(k - (1 - rate)) for k in kept) > KEEP_TOL):
        raise SystemExit(f"dropout path: {launches} launches for {DROP_PATH_STEPS} steps, "
                         f"exact {exact}, kept {kept}")
    return rows, launches


def time_dropout_mask(seed, shape, rate) -> dict:
    """Device times of K7, its plain version and F.dropout of a tensor of
    ones, each from a CUDA graph of many calls (one call of the kernel is
    shorter than its wrapper's host time), beside K7's time per eager call
    and the bound: the mask written once (a dozen integer operations per
    element take less)."""
    import torch
    import torch.nn.functional as F

    from recboard_tpu_torch.ops import dropout as Dr

    ones = torch.ones(shape, device="cuda")
    mask_bound = bound(nbytes(seed, ones), 0)
    kernel = lambda: Dr.dropout_mask(seed, shape, rate)  # noqa: E731
    return dict(
        ms=graph_ms(kernel),
        eager_ms=cuda_ms(kernel),
        plain_ms=graph_ms(lambda: Dr.dropout_mask_reference(seed, shape, rate), calls=10),
        library_ms=graph_ms(lambda: F.dropout(ones, rate)),
        bound_ms=mask_bound[0], bound_by=mask_bound[1],
    )


def rb_inputs(case, rng):
    """(timestamps, ts_w, pos_w, g) of one K6 case on the card: increasing
    timestamps with left pads of 0, their differences spread over the
    case's K buckets; weights requiring their gradients; a cotangent."""
    import torch

    name, NB, B, L, K, columns = case
    top = math.exp(0.301 * (K - 1)) * 1.5  # the largest difference reaches bucket K - 1
    steps = np.exp(rng.uniform(0, math.log(top / L), (B, L)))  # log-uniform: every bucket
    ts = np.cumsum(steps, axis=1).astype(np.int64)
    lengths = rng.integers(1, L + 1, B)
    ts[np.arange(L)[None, :] < (L - lengths)[:, None]] = 0
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    ts_w = t(rng.normal(size=(NB, columns)).astype(np.float32)).requires_grad_()
    pos_w = t(rng.normal(size=(NB, 2 * L - 1)).astype(np.float32)).requires_grad_()
    g = t(rng.normal(size=(NB, B, L, L)).astype(np.float32))
    return t(ts), ts_w, pos_w, g


def check_rel_bias(rng):
    """K6 against the plain autograd on the card: dts (zero past K) and
    dpos; times at the timed shape."""
    import torch

    from recboard_tpu_torch.ops import rel_bias as R

    rows, worst = [], 0.0
    for case in RB_SHAPES + RB_EXTRA:
        name, NB, B, L, K, columns = case
        ts, ts_w, pos_w, g = rb_inputs(case, rng)
        want_out = R.stacked_rel_bias_reference(ts, ts_w, pos_w, K)
        want = torch.autograd.grad(want_out, (ts_w, pos_w), g)
        got_out = R.stacked_rel_bias(ts, ts_w, pos_w, K)
        got = torch.autograd.grad(got_out, (ts_w, pos_w), g)
        bucket = R._bucketize(ts, L, K)
        again = R.stacked_rel_bias_bwd(bucket, g, K, columns)
        torch.cuda.synchronize()
        same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
        g_rel = grad_rel_err(got, want)
        g_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
        out_same = bool(torch.equal(got_out, want_out))
        beyond_zero = not bool(got[0][:, K:].any())
        buckets = int(bucket.unique().numel())
        worst = max(worst, g_abs)
        row = dict(shape=name, NB=NB, B=B, L=L, K=K, columns=columns, buckets_hit=buckets,
                   grad_max_abs_err=g_abs, grad_rel_err=g_rel, grad_rel_tol=GRAD_TOL,
                   forward_equal=out_same, zero_beyond_K=beyond_zero, same_bits=same_bits)
        if case in RB_SHAPES:
            row.update(time_rel_bias(ts, ts_w, pos_w, g, K))
        emit("kernels", kernel="stacked_rel_bias_bwd", **row)
        if not out_same or not beyond_zero or not same_bits or not g_rel <= GRAD_TOL:
            raise SystemExit(f"stacked_rel_bias_bwd disagrees with its plain version at "
                             f"{name}: grads {g_rel}, forward equal {out_same}, zero "
                             f"beyond K {beyond_zero}, same bits on a rerun {same_bits}")
        rows.append(row)
        del ts, ts_w, pos_w, g, want_out, got_out, bucket, again
    return rows, worst


def time_rel_bias(ts, ts_w, pos_w, g, K) -> dict:
    """Times of K6 by CUDA events and on the device clock (whole and by
    part), the plain version's backward (autograd of the gathers) and
    index_add_ of the cotangent into both histograms (also on the device
    clock), with the bound: the cotangent and the bucket ids read once,
    the two gradients written once, one add per entry and histogram."""
    import torch

    from recboard_tpu_torch.ops import rel_bias as R

    NB, B, L, _ = g.shape
    bucket = R._bucketize(ts, L, K)
    columns = ts_w.shape[1]
    dts, dpos = R.stacked_rel_bias_bwd(bucket, g, K, columns)
    flat_bucket = bucket.reshape(-1).long()
    flat_rel = R._toeplitz(L, g.device).reshape(1, -1).expand(B, -1).reshape(-1)
    g2 = g.reshape(NB, -1)

    def plain_fwd():
        with torch.no_grad():
            return R.stacked_rel_bias_reference(ts, ts_w, pos_w, K)

    def plain_fwd_bwd():
        torch.autograd.grad(R.stacked_rel_bias_reference(ts, ts_w, pos_w, K), (ts_w, pos_w), g)

    def library():
        return (torch.zeros_like(dts).index_add_(1, flat_bucket, g2),
                torch.zeros_like(dpos).index_add_(1, flat_rel, g2))

    def bwd():
        return R.stacked_rel_bias_bwd(bucket, g, K, columns)

    elements = NB * B * L * L
    bwd_bound = bound(nbytes(g, bucket, dts, dpos), 2 * elements)
    plain_ms = cuda_ms(plain_fwd, iters=50, warmup=5)
    parts, launches = kernel_parts(bwd, RB_BWD_PARTS, "stacked_rel_bias_bwd", 20)
    return dict(
        bwd_ms=cuda_ms(bwd),
        bwd_graph_ms=graph_ms(bwd),
        bwd_parts_ms=parts,
        bwd_launches_per_call=launches,
        bwd_ptxas=ptxas_lines("rel_bias", "rel_bias_"),
        plain_bwd_ms=cuda_ms(plain_fwd_bwd, iters=50, warmup=5) - plain_ms,
        library_bwd_ms=cuda_ms(library, iters=50, warmup=5),
        library_bwd_graph_ms=graph_ms(library, calls=10),
        bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1],
    )


def xavier(rng, fan_in, fan_out, shape=None):
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return (rng.normal(size=shape or (fan_in, fan_out)) * std).astype(np.float32)


def sasrec_flax_params(rng, num_items, maxlen, embedding_dim, num_blocks, **_):
    """SASRec params in recboard_tpu's flax layout (what its Coach
    pickles), made with numpy: xavier weights, small random biases and
    LayerNorm affines."""
    D = embedding_dim
    small = lambda: (rng.normal(size=D) * 0.02).astype(np.float32)  # noqa: E731
    ln = lambda: {"scale": 1.0 + small(), "bias": small()}  # noqa: E731
    dense = lambda: {"kernel": xavier(rng, D, D), "bias": small()}  # noqa: E731
    params = {
        "item_embeddings": {"embedding": xavier(rng, num_items + 1, D)},
        "position_embeddings": {"embedding": xavier(rng, maxlen, D)},
        "last_ln": ln(),
    }
    for i in range(num_blocks):
        params[f"blocks_{i}"] = {
            "LayerNorm_0": ln(), "q_proj": dense(), "k_proj": dense(),
            "v_proj": dense(), "out_proj": dense(), "LayerNorm_1": ln(),
            "PointWiseFFN_0": {"Dense_0": dense(), "Dense_1": dense()},
        }
    return params


def bert4rec_flax_params(rng, num_items, maxlen, embedding_dim, num_blocks, **_):
    """BERT4Rec params in recboard_tpu's flax layout, made with numpy: the
    packed qkv as a DenseGeneral kernel (D, 3, D) with a (3, D) bias, and
    the fc head over the items and the two specials (pad, MASK)."""
    D, V = embedding_dim, num_items + 2
    small = lambda *shape: (rng.normal(size=shape or (D,)) * 0.02).astype(np.float32)  # noqa: E731
    ln = lambda: {"scale": 1.0 + small(), "bias": small()}  # noqa: E731
    dense = lambda i, o: {"kernel": xavier(rng, i, o), "bias": small(o)}  # noqa: E731
    params = {
        "item_embeddings": {"embedding": xavier(rng, V, D)},
        "position_embeddings": {"embedding": xavier(rng, maxlen, D)},
        "layernorm": ln(),
        "fc": dense(D, V),
    }
    for i in range(num_blocks):
        params[f"encoder_{i}"] = {
            "qkv": {"kernel": xavier(rng, D, 3 * D).reshape(D, 3, D), "bias": small(3, D)},
            "out_proj": dense(D, D), "LayerNorm_0": ln(),
            "Dense_0": dense(D, 4 * D), "Dense_1": dense(4 * D, D), "LayerNorm_1": ln(),
        }
    return params


def hstu_flax_params(rng, num_items, maxlen, embedding_dim, num_blocks, num_heads,
                     linear_hidden_dim, attention_dim, num_buckets, **_):
    """HSTU params in recboard_tpu's flax layout, made with numpy: the bare
    rel_bias weights and the bias-less uvqk_linear kernel."""
    D, H = embedding_dim, num_heads
    uvqk, hv = 2 * H * (linear_hidden_dim + attention_dim), H * linear_hidden_dim
    small = lambda *shape: (rng.normal(size=shape) * 0.02).astype(np.float32)  # noqa: E731
    ln = lambda n: {"scale": 1.0 + small(n), "bias": small(n)}  # noqa: E731
    params = {
        "item_embeddings": {"embedding": small(num_items + 1, D)},
        "pos_embeddings": {"embedding": small(maxlen, D)},
        "rel_bias": {"timestamp_weights": small(num_blocks, num_buckets + 1),
                     "position_weights": small(num_blocks, 2 * maxlen - 1)},
    }
    for i in range(num_blocks):
        params[f"hstu_{i}"] = {
            "LayerNorm_0": ln(D), "uvqk_linear": {"kernel": xavier(rng, D, uvqk)},
            "attn_ln": ln(hv), "output_linear": {"kernel": xavier(rng, hv, D), "bias": small(D)},
        }
    return params


def bsarec_flax_params(rng, num_items, maxlen, embedding_dim, num_blocks, **_):
    """BSARec params in recboard_tpu's flax layout, made with numpy: the
    separate query/key/value/dense layers and each block's sqrt_beta."""
    D = embedding_dim
    small = lambda *shape: (rng.normal(size=shape) * 0.02).astype(np.float32)  # noqa: E731
    ln = lambda: {"scale": 1.0 + small(D), "bias": small(D)}  # noqa: E731
    dense = lambda i, o: {"kernel": xavier(rng, i, o), "bias": small(o)}  # noqa: E731
    params = {
        "item_embeddings": {"embedding": xavier(rng, num_items + 1, D)},
        "position_embeddings": {"embedding": xavier(rng, maxlen, D)},
        "in_ln": ln(),
    }
    for i in range(num_blocks):
        params[f"block_{i}"] = {
            "FrequencyLayer_0": {"sqrt_beta": rng.normal(size=(1, 1, D)).astype(np.float32),
                                 "LayerNorm_0": ln()},
            "BSAAttention_0": {"query": dense(D, D), "key": dense(D, D), "value": dense(D, D),
                               "dense": dense(D, D), "LayerNorm_0": ln()},
            "Dense_0": dense(D, 4 * D), "Dense_1": dense(4 * D, D), "LayerNorm_0": ln(),
        }
    return params


def fmlp_flax_params(rng, num_items, maxlen, embedding_dim, num_blocks, **_):
    """FMLP-Rec params in recboard_tpu's flax layout, made with numpy: each
    filter's complex weight as (1, maxlen // 2 + 1, D, 2) real/imag pairs."""
    D = embedding_dim
    small = lambda *shape: (rng.normal(size=shape) * 0.02).astype(np.float32)  # noqa: E731
    ln = lambda: {"scale": 1.0 + small(D), "bias": small(D)}  # noqa: E731
    dense = lambda i, o: {"kernel": small(i, o), "bias": small(o)}  # noqa: E731
    params = {
        "item_embeddings": {"embedding": small(num_items + 1, D)},
        "position_embeddings": {"embedding": small(maxlen, D)},
        "in_ln": ln(),
    }
    for i in range(num_blocks):
        params[f"filters_{i}"] = {"complex_weight": small(1, maxlen // 2 + 1, D, 2),
                                  "LayerNorm_0": ln()}
        params[f"intermediates_{i}"] = {"Dense_0": dense(D, 4 * D), "Dense_1": dense(4 * D, D),
                                        "LayerNorm_0": ln()}
    return params


def unisrec_flax_params(rng, num_items, maxlen, embedding_dim, num_blocks, num_moe_experts,
                        **_):
    """UniSRec params in recboard_tpu's flax layout, made with numpy: the
    adaptor's gates (F, experts), each expert's bare bias and bias-free
    Dense, the post-LN blocks' separate query/key/value/dense layers."""
    D, F = embedding_dim, FEATURE_WIDTH
    small = lambda *shape: (rng.normal(size=shape) * 0.02).astype(np.float32)  # noqa: E731
    ln = lambda: {"scale": 1.0 + small(D), "bias": small(D)}  # noqa: E731
    dense = lambda i, o: {"kernel": small(i, o), "bias": small(o)}  # noqa: E731
    adaptor = {"w_gate": small(F, num_moe_experts), "w_noise": small(F, num_moe_experts)}
    for i in range(num_moe_experts):
        adaptor[f"expert_{i}"] = {"bias": small(F), "Dense_0": {"kernel": small(F, D)}}
    params = {"position_embeddings": {"embedding": small(maxlen, D)}, "input_ln": ln(),
              "moe_adaptor": adaptor}
    for i in range(num_blocks):
        params[f"blocks_{i}"] = {
            "query": dense(D, D), "key": dense(D, D), "value": dense(D, D), "dense": dense(D, D),
            "LayerNorm_0": ln(), "Dense_0": dense(D, 4 * D), "Dense_1": dense(4 * D, D),
            "LayerNorm_1": ln(),
        }
    return params


def gru_cell_params(rng, fan_in: int, H: int) -> dict:
    """A flax GRUCell under nn.RNN, made with numpy: biased input gates,
    the hidden gates unbiased but for hn."""
    small = lambda *shape: (rng.normal(size=shape) * 0.02).astype(np.float32)  # noqa: E731
    cell = {f"i{g}": {"kernel": xavier(rng, fan_in, H), "bias": small(H)} for g in "rzn"}
    cell.update({f"h{g}": {"kernel": xavier(rng, H, H)} for g in "rzn"})
    cell["hn"]["bias"] = small(H)
    return {"cell": cell}


def gru4rec_flax_params(rng, num_items, maxlen, embedding_dim, hidden_size, num_blocks, **_):
    """GRU4Rec params in recboard_tpu's flax layout, made with numpy: a
    GRU cell per layer, the projection to D."""
    D, H = embedding_dim, hidden_size
    params = {"item_embeddings": {"embedding": xavier(rng, num_items + 1, D)},
              "dense": {"kernel": xavier(rng, H, D),
                        "bias": (rng.normal(size=D) * 0.02).astype(np.float32)}}
    for i in range(num_blocks):
        params[f"gru_{i}"] = gru_cell_params(rng, D if i == 0 else H, H)
    return params


def narm_flax_params(rng, num_items, maxlen, embedding_dim, hidden_size, num_blocks, **_):
    """NARM params in recboard_tpu's flax layout, made with numpy: the GRU
    cells and the bias-free attention (a_1, a_2, v_t) and projection b."""
    D, H = embedding_dim, hidden_size
    params = {"item_embeddings": {"embedding": xavier(rng, num_items + 1, D)},
              "a_1": {"kernel": xavier(rng, H, H)}, "a_2": {"kernel": xavier(rng, H, H)},
              "v_t": {"kernel": xavier(rng, H, 1)}, "b": {"kernel": xavier(rng, 2 * H, D)}}
    for i in range(num_blocks):
        params[f"gru_{i}"] = gru_cell_params(rng, D if i == 0 else H, H)
    return params


def glint_ru_flax_params(rng, num_items, maxlen, embedding_dim, hidden_size, num_layers, **_):
    """GLINT-RU params in recboard_tpu's flax layout, made with numpy: the
    Conv kernels (3, H, H), the GRU cells, the linear attention's layers and
    LayerNorm, the bare expert ``weights`` (2,)."""
    D, H = embedding_dim, hidden_size
    small = lambda *shape: (rng.normal(size=shape) * 0.02).astype(np.float32)  # noqa: E731
    dense = lambda i, o: {"kernel": xavier(rng, i, o), "bias": small(o)}  # noqa: E731
    ln = lambda n: {"scale": 1.0 + small(n), "bias": small(n)}  # noqa: E731
    conv = lambda: {"kernel": xavier(rng, 3 * H, H).reshape(3, H, H), "bias": small(H)}  # noqa: E731
    params = {
        "item_embeddings": {"embedding": xavier(rng, num_items + 1, D)},
        "dense1": dense(D, H), "dense2": dense(D, H), "conv1d": conv(), "conv1dforgru": conv(),
        "linearattention": {"query": dense(D, D), "key": dense(D, D), "value": dense(D, D),
                            "dense": dense(D, D), "LayerNorm_0": ln(D)},
        "weights": (0.5 + small(2)).astype(np.float32),
        "dense_mix": dense(H, H), "dense3": dense(H, H), "dense4": dense(H, H),
        "denseout": dense(H, D), "ln": ln(H), "proj": dense(H, H),
        "gate_down": dense(H, H // 2), "gate_up": dense(H // 2, H),
    }
    for i in range(num_layers):
        params[f"gru_{i}"] = gru_cell_params(rng, H, H)
    return params


def stamp_flax_params(rng, num_items, maxlen, embedding_dim, hidden_size, **_):
    """STAMP params in recboard_tpu's flax layout, made with numpy: the
    bias-free w0-w3, the bare ``ba`` (1, 1, D), the two MLPs."""
    D, H = embedding_dim, hidden_size
    normal = lambda std, *shape: (rng.normal(size=shape) * std).astype(np.float32)  # noqa: E731
    return {"item_embeddings": {"embedding": normal(0.05, num_items + 1, D)},
            "w1": {"kernel": normal(0.05, D, D)}, "w2": {"kernel": normal(0.05, D, D)},
            "w3": {"kernel": normal(0.05, D, D)}, "w0": {"kernel": normal(0.05, D, 1)},
            "ba": normal(0.05, 1, 1, D),
            "mlp_a": {"kernel": normal(0.05, D, H), "bias": normal(0.02, H)},
            "mlp_b": {"kernel": normal(0.05, D, H), "bias": normal(0.02, H)}}


def fpmc_flax_params(rng, num_items, maxlen, embedding_dim, num_users, **_):
    """FPMC params in recboard_tpu's flax layout, made with numpy: the user
    table and the three item tables, none with a pad row."""
    D = embedding_dim
    return {"user_embeddings": {"embedding": xavier(rng, num_users, D)},
            **{name: {"embedding": xavier(rng, num_items, D)} for name in ("i2u", "i2l", "l2i")}}


def layout(tree, path=()) -> dict:
    """{leaf path: shape} of nested params."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(layout(value, path + (key,)))
        else:
            out["/".join(path + (key,))] = np.shape(value)
    return out


# each slice: its model (the key where not given), widths, random weights,
# training config, flags and epochs (TRAIN_EPOCHS where not given), toy-store
# protocol and quality anchor, the prefix of its phase names, for a
# device-sampled slice the host-pipe slice it is printed beside, for a
# roll-window slice its inputs (``train_slice``), and ``timings=False`` where
# time_training times no step or epoch, only profiles (NARM, STAMP, FPMC:
# cut since a whole run with them went over its limit)
ODS = dict(on_device_sampling=True)
SLICES = {
    "SASRec": dict(widths=SASREC, params=sasrec_flax_params, config=TRAIN_CONFIG,
                   batch=TRAIN_BATCH, protocol=STORE_PROTOCOL, store=STORE_NDCG10, tag=""),
    "BERT4Rec": dict(widths=BERT4REC, params=bert4rec_flax_params, config=B4R_CONFIG,
                     batch=TRAIN_BATCH, protocol=B4R_STORE_PROTOCOL, store=B4R_STORE_NDCG10,
                     tag="bert4rec_"),
    "HSTU": dict(widths=HSTU, params=hstu_flax_params, config=HSTU_CONFIG, batch=HSTU_BATCH,
                 flags=dict(negs_mode="shared"), epochs=HSTU_SHARED_EPOCHS,
                 protocol=HSTU_STORE_PROTOCOL,
                 store=HSTU_STORE_NDCG10, tag="hstu_"),
    "HSTU_pp": dict(model="HSTU", widths=HSTU, params=hstu_flax_params, config=HSTU_CONFIG,
                    batch=HSTU_BATCH, protocol=HSTU_PP_STORE_PROTOCOL,
                    store=HSTU_PP_STORE_NDCG10, tag="hstu_pp_"),
    # the same runs with every batch drawn on the card (data/device.py)
    "SASRec_ods": dict(model="SASRec", widths=SASREC, params=sasrec_flax_params,
                       config=TRAIN_CONFIG, batch=TRAIN_BATCH, flags=ODS,
                       protocol=dict(STORE_PROTOCOL, **ODS), store=STORE_NDCG10,
                       tag="sasrec_ods_", host="SASRec"),
    "BERT4Rec_ods": dict(model="BERT4Rec", widths=BERT4REC, params=bert4rec_flax_params,
                         config=B4R_CONFIG, batch=TRAIN_BATCH, flags=ODS,
                         tag="bert4rec_ods_", host="BERT4Rec"),
    "HSTU_pp_ods": dict(model="HSTU", widths=HSTU, params=hstu_flax_params,
                        config=HSTU_CONFIG, batch=HSTU_BATCH, flags=ODS,
                        protocol=dict(HSTU_PP_STORE_PROTOCOL, **ODS),
                        store=HSTU_PP_STORE_NDCG10, tag="hstu_pp_ods_", host="HSTU_pp"),
    # the roll-window models; UniSRec trains on its multiplexed host
    # pipe only, as recboard_tpu's runner does
    "BSARec": dict(widths=BSAREC, params=bsarec_flax_params, config=BSAREC_CONFIG,
                   batch=BSAREC_BATCH, epochs=ROLL_EPOCHS, protocol=STORE_PROTOCOL,
                   store=BSAREC_STORE_NDCG10, tag="bsarec_"),
    "BSARec_ods": dict(model="BSARec", widths=BSAREC, params=bsarec_flax_params,
                       config=BSAREC_CONFIG, batch=BSAREC_BATCH, flags=ODS,
                       epochs=ROLL_EPOCHS, tag="bsarec_ods_", host="BSARec"),
    "FMLP-Rec": dict(widths=FMLP, params=fmlp_flax_params, config=FMLP_CONFIG,
                     batch=FMLP_BATCH, epochs=ROLL_EPOCHS, protocol=STORE_PROTOCOL,
                     store=FMLP_STORE_NDCG10, tag="fmlp_"),
    "FMLP-Rec_ods": dict(model="FMLP-Rec", widths=FMLP, params=fmlp_flax_params,
                         config=FMLP_CONFIG, batch=FMLP_BATCH, flags=ODS,
                         epochs=ROLL_EPOCHS, tag="fmlp_ods_", host="FMLP-Rec"),
    "UniSRec": dict(widths=UNISREC, params=unisrec_flax_params, config=UNISREC_CONFIG,
                    batch=UNISREC_BATCH, flags=FEATURES, epochs=ROLL_EPOCHS,
                    protocol=dict(STORE_PROTOCOL, **FEATURES), store=UNISREC_STORE_NDCG10,
                    tag="unisrec_"),
    # the recurrent and session models; GRU4Rec also device-sampled, and
    # FPMC's sampler (NUM_PADS 0) checked in device_samplers
    "GRU4Rec": dict(widths=GRU4REC, params=gru4rec_flax_params, config=GRU4REC_CONFIG,
                    batch=512, epochs=ROLL_EPOCHS, protocol=STORE_PROTOCOL,
                    store=GRU4REC_STORE_NDCG10, tag="gru4rec_", inputs="uncapped"),
    "GRU4Rec_ods": dict(model="GRU4Rec", widths=GRU4REC, params=gru4rec_flax_params,
                        config=GRU4REC_CONFIG, batch=512, flags=ODS, epochs=ROLL_EPOCHS,
                        tag="gru4rec_ods_", host="GRU4Rec"),
    "NARM": dict(widths=NARM, params=narm_flax_params, config=NARM_CONFIG, batch=512,
                 epochs=ROLL_EPOCHS, protocol=STORE_PROTOCOL, store=NARM_STORE_NDCG10,
                 tag="narm_", inputs="uncapped", timings=False),
    "GLINT-RU": dict(widths=GLINT_RU, params=glint_ru_flax_params, config=GLINT_RU_CONFIG,
                     batch=2048, epochs=ROLL_EPOCHS, protocol=STORE_PROTOCOL,
                     store=GLINT_RU_STORE_NDCG10, tag="glint_ru_", inputs="uncapped"),
    "STAMP": dict(widths=STAMP, params=stamp_flax_params, config=STAMP_CONFIG, batch=512,
                  epochs=ROLL_EPOCHS, protocol=STORE_PROTOCOL, store=STAMP_STORE_NDCG10,
                  tag="stamp_", timings=False),
    "FPMC": dict(widths=FPMC, params=fpmc_flax_params, config=FPMC_CONFIG, batch=512,
                 epochs=ROLL_EPOCHS, protocol=STORE_PROTOCOL, store=FPMC_STORE_NDCG10,
                 tag="fpmc_", inputs="last", timings=False),
}


def read_scored_tsv(path):
    """``user \\t item:score ...`` → {user: (ids, scores)}."""
    out = {}
    with open(path) as fh:
        for line in fh:
            user, *cells = line.rstrip("\n").split("\t")
            pairs = [c.split(":") for c in cells]
            out[int(user)] = (
                np.asarray([int(i) for i, _ in pairs]),
                np.asarray([float(s) for _, s in pairs]),
            )
    return out


def compare_topk(a, b, tol=TIE_TOL):
    """Tie-tolerant agreement of two scored top-K tables: the same users,
    scores equal to ``tol`` position by position, and wherever the i-th
    and (i+1)-th scores differ by more than ``tol`` the first i ids are
    the same set. Returns a list of disagreements (empty when they agree)."""
    bad = []
    if a.keys() != b.keys():
        return [f"users differ: {len(a)} vs {len(b)}"]
    for user, (ids_a, vals_a) in a.items():
        ids_b, vals_b = b[user]
        if len(ids_a) != len(ids_b) or not np.allclose(vals_a, vals_b, rtol=0, atol=tol):
            bad.append(f"user {user}: scores {vals_a} vs {vals_b}")
            continue
        for i in range(1, len(ids_a)):
            if vals_a[i - 1] - vals_a[i] > tol and set(ids_a[:i]) != set(ids_b[:i]):
                bad.append(f"user {user}: top-{i} {ids_a[:i]} vs {ids_b[:i]}")
                break
    return bad


def serve_float64(argv: list) -> None:
    """``recommend`` with the model held in float64 on the CPU: the scores
    that float32 rounding on either device is judged against."""
    from recboard_tpu_torch import run, serve

    build = run.build_model
    run.build_model = lambda *a, **k: build(*a, **k).double()
    try:
        serve.main(argv + ["--device", "cpu"])
    finally:
        run.build_model = build


def agree_or_float64(gpu: dict, cpu: dict, argv: list, f64_tsv: str) -> tuple:
    """(disagreements, arbitrated users) of GPU lists against CPU lists.
    Users whose lists differ beyond TIE_TOL are scored again in float64:
    where float32 itself cannot resolve a user's scores to TIE_TOL (a
    trained model can amplify rounding), the GPU's list must agree with
    the float64 list within twice the CPU float32's own distance from it
    (at least TIE_TOL). More than 0.1 % of users (at least 10) differing
    fails outright; a GPU path that computed something else lands far
    outside either way."""
    bad = compare_topk(gpu, cpu)
    if not bad or gpu.keys() != cpu.keys():
        return bad, []
    users = [u for u in gpu if compare_topk({u: gpu[u]}, {u: cpu[u]})]
    if len(users) > max(10, len(gpu) // 1000):  # more than rounding would touch
        return bad, []
    serve_float64(argv + ["--output", f64_tsv])
    f64 = read_scored_tsv(f64_tsv)
    bad, arbitrated = [], []
    for u in users:
        tol = max(TIE_TOL, 2 * float(np.abs(cpu[u][1] - f64[u][1]).max()))
        bad += compare_topk({u: gpu[u]}, {u: f64[u]}, tol)
        arbitrated.append(dict(user=u, tol=tol,
                               gpu_cpu=float(np.abs(gpu[u][1] - cpu[u][1]).max()),
                               gpu_f64=float(np.abs(gpu[u][1] - f64[u][1]).max())))
    return bad, arbitrated


def make_dataset():
    """The dataset of SynBeautyXL's shape, under a fresh WORK."""
    from recboard_tpu_torch.data import synthetic
    from recboard_tpu_torch.data.datasets import NextItemRecDataSet

    shutil.rmtree(WORK, ignore_errors=True)
    data_root = os.path.join(WORK, "data")
    spec = dict(DATASET)
    synthetic.make_synthetic_dataset(data_root, spec.pop("name"), **spec)
    dataset = NextItemRecDataSet(data_root, DATASET["name"])
    synthetic.write_item_features(dataset)  # UniSRec's --tfile
    return dataset


def write_run(seed: int, model: str, num_items: int) -> str:
    """A run directory for ``model`` over make_dataset's data: a config
    snapshot and a random flax-layout params pickle."""
    import yaml

    from recboard_tpu_torch import utils

    widths, params_fn = SLICES[model]["widths"], SLICES[model]["params"]
    run_dir = os.path.join(WORK, f"run_{model}")
    ckpt_dir = os.path.join(run_dir, "ckpt")
    cfg = dict(model=model, root=os.path.join(WORK, "data"), dataset=DATASET["name"],
               tasktag="NEXTITEM", seed=seed, CHECKPOINT_PATH=ckpt_dir,
               BEST_FILENAME="best.safetensors", **widths)
    utils.mkdirs(ckpt_dir)
    with open(os.path.join(run_dir, "config.yaml"), "w") as fh:
        yaml.safe_dump(cfg, fh, sort_keys=True)
    params = params_fn(np.random.default_rng(seed), num_items, **widths)
    utils.export_pickle({"params": params}, os.path.join(ckpt_dir, "best.safetensors"))
    return run_dir


def serve_slice(seed: int, dataset, model: str) -> dict:
    """``recommend`` for ``model`` with random weights: every list, the
    forward kernel once per block per batch, the GPU lists equal to
    ``--device cpu``'s; then the ``--bench`` line."""
    from recboard_tpu_torch import serve
    from recboard_tpu_torch.ops import attention as A

    widths, tag = SLICES[model]["widths"], SLICES[model]["tag"]
    num_items = dataset.fields["ITEM", "ID"].count
    t0 = time.perf_counter()
    run_dir = write_run(seed, model, num_items)
    setup_s = time.perf_counter() - t0
    # K + 1 ids per user: the (K+1)-th score bounds ties at the K-th
    common = ["--run", run_dir, "--topk", str(TOPK + 1), "--with-scores",
              "--batch-size", str(BATCH)]
    gpu_tsv = os.path.join(WORK, f"{model}_gpu.tsv")
    cpu_tsv = os.path.join(WORK, f"{model}_cpu.tsv")

    A.mha_fwd.launches = 0
    t0 = time.perf_counter()
    serve.main(common + ["--output", gpu_tsv])
    gpu_s = time.perf_counter() - t0
    launches = A.mha_fwd.launches

    gpu = read_scored_tsv(gpu_tsv)
    batches = math.ceil(len(gpu) / BATCH)
    if launches != widths["num_blocks"] * batches:
        raise SystemExit(
            f"{model}: mha_fwd launched {launches} times for {batches} batches "
            f"of {widths['num_blocks']} blocks"
        )
    train, valid = dataset.train().user_seqs(), dataset.valid().user_seqs()
    for user, (ids, vals) in gpu.items():
        top = ids[:TOPK]
        seen = set(train[user]) | set(valid[user])
        if (len(set(top)) != TOPK or top.min() < 0 or top.max() >= num_items
                or seen & set(top.tolist()) or not np.isfinite(vals).all()):
            raise SystemExit(f"{model}, user {user}: bad list {top} (seen {sorted(seen)})")

    t0 = time.perf_counter()
    serve.main(common + ["--output", cpu_tsv, "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    bad = compare_topk(gpu, read_scored_tsv(cpu_tsv))
    if bad:
        raise SystemExit(f"{model}: GPU and CPU lists disagree:\n" + "\n".join(bad[:10]))

    emit(f"{tag}slice", model=model, users=len(gpu), items=num_items, batches=batches,
         mha_fwd_launches=launches, topk=TOPK, cpu_agree=True,
         setup_s=setup_s, serve_gpu_s=gpu_s, serve_cpu_s=cpu_s, **widths)

    bench = run_bench(run_dir)
    emit(f"{tag}bench", **bench)
    return dict(launches=launches, run_dir=run_dir, bench=bench)


def run_bench(run_dir: str) -> dict:
    """``recommend --bench`` at the slice's settings; its JSON line."""
    from recboard_tpu_torch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--run", run_dir, "--topk", str(TOPK), "--bench",
                    "--batch-size", str(BATCH)])
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def profile_totals(prof) -> dict:
    """{True: the device's, False: the host's} {name: [self µs, calls]} of
    a torch.profiler run, counted as its ``key_averages()`` counts them but
    in one pass over the raw events (``key_averages`` first makes a Python
    object of every event: 3-19 s for a 40-step window): a span's self time
    is its length less that of the spans nested directly in it on its
    thread (a device runtime call on the thread of the operator that made
    it); an operator nested alone in one of its own name is merged into it,
    as the profiler's tree does; a span that ends on another thread than it
    began counts no time; user annotations (ranges such as
    ``Optimizer.step`` that enclose other work) are left out, so the times
    add up without counting twice."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    spans, op_thread, names = [], {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if _filter_name(name) or getattr(e, "is_hidden_event", lambda: False)():
            continue
        if name not in names:
            names[name] = _rewrite_name(name=name, with_wildcard=True)
        cpu = e.device_type() == DeviceType.CPU
        synced = not e.is_async() and e.start_thread_id() == e.end_thread_id()
        link = e.linked_correlation_id()
        if cpu and synced and link == 0:
            op_thread[e.correlation_id()] = e.start_thread_id()
        spans.append((names[name], cpu, synced,
                      e.is_user_annotation(), e.start_ns(), e.end_ns(), e.start_thread_id(),
                      link))
    totals = {True: {}, False: {}}
    threads = {}
    for name, cpu, synced, annotation, start, end, thread, link in spans:
        if not cpu:
            if not annotation:
                row = totals[True].setdefault(name, [0.0, 0])
                row[0] += (end - start) / 1e3 if synced else 0.0
                row[1] += 1
        elif synced:
            node = [name, start, end, annotation, 0, []]  # nested time, children
            threads.setdefault(op_thread.get(link, thread) if link else thread, []).append(node)
    for nodes in threads.values():
        nodes.sort(key=lambda n: (n[1], -n[2]))
        stack = []
        for node in nodes:
            while stack and (node[1] >= stack[-1][2] or node[2] > stack[-1][2]):
                stack.pop()
            if stack:
                stack[-1][4] += node[2] - node[1]
                stack[-1][5].append(node)
            stack.append(node)
        for node in nodes:
            if node[3]:
                continue
            row = totals[False].setdefault(node[0], [0.0, 0])
            row[0] += (node[2] - node[1] - node[4]) / 1e3
            row[1] += 1
            for child in node[5]:  # merged into its parent: its time stays, its call goes
                if len(node[5]) == 1 and child[0] == node[0] and not child[3]:
                    row[1] -= 1
    return totals


def profiled_ops(totals: dict, per: int, device: bool) -> list:
    """(name, self µs per unit, calls per unit) from ``profile_totals``,
    largest first: the device's kernels, or the host's operators."""
    rows = [(name, us / per, n / per) for name, (us, n) in totals[device].items()]
    return sorted(rows, key=lambda row: -row[1])


def profile_bench(run_dir: str, p50_ms: float, phase: str) -> None:
    """Device time by kernel over one ``--bench`` call under torch.profiler
    (its warm-up and timed passes each serve every staged batch), and the
    device's idle share of the unprofiled p50 batch time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bench = run_bench(run_dir)
    kernels = profiled_ops(profile_totals(prof), 2 * bench["batches"], device=True)
    device_us = sum(us for _, us, _ in kernels)
    emit(phase, device_us_per_batch=device_us,
         launches_per_batch=sum(n for _, _, n in kernels),
         unprofiled_p50_ms=p50_ms,
         idle_share=1.0 - device_us / (1e3 * p50_ms),
         kernels=[dict(name=name[:90], us_per_batch=us, per_batch=n)
                  for name, us, n in kernels[:12]])


def train_argv(model: str, data_root: str, dataset: str, seed: int, **flags) -> list:
    """``run`` arguments for ``model`` on ``dataset`` with these flags, its
    logs and checkpoints under WORK."""
    argv = ["--model", model, "--root", data_root, "--dataset", dataset,
            "--seed", str(seed), "--log2console", "false",
            "--log-path", os.path.join(WORK, "logs"),
            "--checkpoint-path", os.path.join(WORK, "infos", f"{dataset}-s{seed}")]
    for key, value in flags.items():
        argv += ["--" + key.replace("_", "-"), str(value)]
    return argv


def latest_run(model: str, dataset: str) -> str:
    root = os.path.join(WORK, "logs", model, dataset)
    return os.path.join(root, sorted(os.listdir(root))[-1])


def counted_kernels() -> tuple:
    """The kernel wrappers, each counting its launches in ``.launches``."""
    from recboard_tpu_torch.ops import attention as A
    from recboard_tpu_torch.ops import dropout as Dr
    from recboard_tpu_torch.ops import losses as S
    from recboard_tpu_torch.ops import rel_bias as R
    from recboard_tpu_torch.ops import vocab_ce as K

    return (A.mha_fwd, A.mha_dropout_fwd, A.mha_dropout_bwd, K.vocab_ce_fwd, K.vocab_ce_bwd,
            S.sampled_softmax_cand_fwd, S.sampled_softmax_cand_bwd,
            S.sampled_softmax_shared_fwd, S.sampled_softmax_shared_bwd, R.stacked_rel_bias_bwd,
            Dr.dropout_mask)


# the ported models whose paths reach none of K1-K7
KERNEL_FREE = ("FMLP-Rec", "GRU4Rec", "NARM", "GLINT-RU", "STAMP", "FPMC")


def expected_launches(model: str, blocks: int, trained: int, evaluated: int,
                      negs_mode: str = "") -> dict:
    """Each counted kernel's launches for ``trained`` steps and ``evaluated``
    batches of ``model``: SASRec, BERT4Rec and BSARec run K2 forward and
    backward once per block and step and K1 once per block and evaluated
    batch, UniSRec K2 twice per block and step (two encodes) and K1 once,
    BERT4Rec K3 forward and backward once per step; HSTU runs K6 once per
    step and the forward and backward of its loss's kernel, K5 with shared
    negatives and K4 with per-position ones (no ``negs_mode``), and no
    kernel in evaluation; the models of KERNEL_FREE (FMLP-Rec, GRU4Rec, NARM,
    GLINT-RU, STAMP, FPMC) run none. No model calls K7."""
    if model == "HSTU":
        loss = "shared" if negs_mode == "shared" else "cand"
        per_step = {f"sampled_softmax_{loss}_fwd": 1, f"sampled_softmax_{loss}_bwd": 1,
                    "stacked_rel_bias_bwd": 1}
        per_eval = {}
    elif model in KERNEL_FREE:
        per_step, per_eval = {}, {}
    else:
        encodes = 2 if model == "UniSRec" else 1
        per_step = dict(mha_dropout_fwd=encodes * blocks, mha_dropout_bwd=encodes * blocks)
        if model == "BERT4Rec":
            per_step.update(vocab_ce_fwd=1, vocab_ce_bwd=1)
        per_eval = dict(mha_fwd=blocks)
    return {fn.__name__: per_step.get(fn.__name__, 0) * trained
            + per_eval.get(fn.__name__, 0) * evaluated for fn in counted_kernels()}


def train_slice(seed: int, dataset, name: str) -> dict:
    """``run`` at the slice ``name``'s reference config on the SynBeautyXL-shaped
    dataset for its epochs, validated every epoch: the loss is
    finite, every kernel launched exactly as ``expected_launches`` says
    (steps from the host pipe, or from the device sampler's
    ``steps_per_epoch``), the best checkpoint is in the flax layout, and
    the run serves on the GPU with the CPU's lists (for HSTU through the
    host pipe, which has no serving phase of its own, then the ``--bench``
    line)."""
    import torch

    from recboard_tpu_torch import run, serve
    from recboard_tpu_torch.data.pipes import Size

    spec = SLICES[name]
    model, widths, tag = spec.get("model", name), spec["widths"], spec["tag"]
    flags, epochs = spec.get("flags", {}), spec.get("epochs", TRAIN_EPOCHS)
    argv = train_argv(model, os.path.join(WORK, "data"), DATASET["name"], seed,
                      config=spec["config"], epochs=epochs, eval_freq=1,
                      checkpoint_path=os.path.join(WORK, "infos", name), **flags)
    counter = run.build_model(model, dataset, dict(widths, seed=seed, **flags), "cpu")
    on_device = bool(flags.get("on_device_sampling"))
    if on_device:
        sampler = run.device_sampler(counter, widths["maxlen"], spec["batch"], "cpu")
        steps = sampler.steps_per_epoch
        sizes = [spec["batch"]] * steps
        pad_share = device_pad_share(sampler, widths["maxlen"])
    elif model in ROLL_SLICES:
        # the roll pipe's rows, counted from the sequences rather than drawn
        # (133k windows): one per window end 2..n of a user with n >= 2 items,
        # min(end - 1, cap) input items of ``width`` each: cap maxlen - 1 where
        # the window holds its target (BSARec's), maxlen where it is uncapped
        # (GRU4Rec's), one item of one for FPMC's last transition
        L = widths["maxlen"]
        cap, width = {"capped": (L - 1, L), "uncapped": (L, L), "last": (1, 1)}[
            spec.get("inputs", "capped")]
        items = np.concatenate([np.minimum(np.arange(1, len(seq)), cap)
                                for seq in dataset.train().user_seqs() if len(seq) >= 2])
        B = spec["batch"]
        sizes = [B] * (len(items) // B) + ([len(items) % B] if len(items) % B else [])
        steps = len(sizes)
        pad_share = float(1.0 - items.mean() / width)
    else:
        batches = list(counter.sure_trainpipe(widths["maxlen"], spec["batch"]))
        sizes = [int(b[Size]) for b in batches]
        steps = len(sizes)
        pads = sum(int((b[counter.ISeq] == counter.PADDING_VALUE).sum()) for b in batches)
        pad_share = pads / sum(b[counter.ISeq].size for b in batches)
    n_valid = len(list(counter.sure_validpipe(widths["maxlen"])))
    n_test = len(list(counter.sure_testpipe(widths["maxlen"])))
    if model == "HSTU" and on_device:
        # every device-sampled step is full: the kernels' training shape
        if spec["batch"] * widths["maxlen"] != SSC_SHAPES[0][1] or (
                counter.rel_bias.active_buckets != HSTU_ACTIVE_K):
            raise SystemExit(f"HSTU: {spec['batch']} x {widths['maxlen']} rows a step; the "
                             f"kernel phases checked {SSC_SHAPES[0][1]}")
    elif model == "HSTU":
        # the shapes the kernel phases checked: K6's active buckets, the
        # loss kernel's last batch (K5's and K4's)
        active = counter.rel_bias.active_buckets
        last_m = sizes[-1] * widths["maxlen"]
        if active != HSTU_ACTIVE_K or not last_m == SS_EXTRA[0][1] == SSC_EXTRA[0][1]:
            raise SystemExit(f"HSTU: {active} active buckets and a last batch of {last_m} "
                             f"rows; the kernel phases checked {HSTU_ACTIVE_K} and "
                             f"{SS_EXTRA[0][1]}, {SSC_EXTRA[0][1]}")

    for fn in counted_kernels():
        fn.launches = 0
    t0 = time.perf_counter()
    best = run.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted_kernels()}

    run_dir = latest_run(model, DATASET["name"])
    with open(os.path.join(run_dir, "monitors.pkl"), "rb") as fh:
        history = pickle.load(fh)
    losses = [row["LOSS"] for row in history["train"]]
    trained = steps * epochs
    # valid after every epoch and at the end; test at the end and at the best
    evaluated = (epochs + 1) * n_valid + 2 * n_test
    want = expected_launches(model, widths.get("num_blocks", 0), trained, evaluated,
                             flags.get("negs_mode", ""))
    emit(f"{tag}train", model=model, config=spec["config"], flags=flags,
         dataset=DATASET["name"], epochs=epochs, steps_per_epoch=steps,
         rows_per_epoch=sum(sizes), last_batch=sizes[-1], pad_share=pad_share, losses=losses,
         best=best, launches=launches, expected_launches=want, run_s=run_s)
    if len(losses) != epochs or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{model} train: losses {losses}")
    if launches != want:
        raise SystemExit(f"{model} train: launches {launches}, expected {want}")
    if not best or not all(math.isfinite(v) for v in best.values()):
        raise SystemExit(f"{model} train: best {best}")

    cfg = serve.load_run_config(run_dir)
    with open(os.path.join(cfg.CHECKPOINT_PATH, cfg.BEST_FILENAME), "rb") as fh:
        params = pickle.load(fh)["params"]
    flax_layout = layout(spec["params"](np.random.default_rng(0),
                                        dataset.fields["ITEM", "ID"].count,
                                        num_users=dataset.fields["USER", "ID"].count, **widths))
    if layout(params) != flax_layout:
        raise SystemExit(f"{model} train: the best checkpoint is not in the flax layout")

    common = ["--run", run_dir, "--topk", str(TOPK + 1), "--with-scores",
              "--batch-size", str(BATCH)]
    gpu_tsv = os.path.join(WORK, f"{name}_train_gpu.tsv")
    cpu_tsv = os.path.join(WORK, f"{name}_train_cpu.tsv")
    serve.main(common + ["--output", gpu_tsv])
    serve.main(common + ["--output", cpu_tsv, "--device", "cpu"])
    gpu = read_scored_tsv(gpu_tsv)
    bad, arbitrated = agree_or_float64(gpu, read_scored_tsv(cpu_tsv), common,
                                       os.path.join(WORK, f"{name}_train_f64.tsv"))
    if bad:
        raise SystemExit(f"{model} trained run: GPU and CPU lists disagree:\n"
                         + "\n".join(bad[:10]))
    emit(f"{tag}train_serve", users=len(gpu), cpu_agree=True, tie_tol=TIE_TOL,
         float64_arbitrated=arbitrated)
    out = dict(launches=launches, run_dir=run_dir, steps=steps)
    if model not in ("SASRec", "BERT4Rec") and not on_device:  # no serving phase of its own
        out["bench"] = run_bench(run_dir)
        emit(f"{tag}bench", **out["bench"])
    return out


def device_pad_share(sampler, maxlen: int) -> float:
    """The pad share of a device sampler's inputs: over the valid users'
    windows less their last target, or for the roll-window sampler over
    every (user, end) window (min(end - 1, maxlen - 1) items of maxlen, or
    min(end - 1, maxlen) for windows without their target)."""
    if hasattr(sampler, "_pairs"):
        cap = maxlen - 1 if sampler.window_includes_target else maxlen
        items = (sampler._pairs[:, 1].double() - 1).clamp(max=cap)
        return float(1.0 - items.mean() / maxlen)
    inputs = sampler._packed[sampler._valid_users][:, :maxlen]
    return float((inputs == 0).double().mean())


# time_training's cuts: steps timed one by one, and the profiled window (the
# first steps of an epoch; the roll-window models' epochs are 260-520 steps,
# whose profiles alone took 2-4 minutes to read back each)
STAGED_STEPS = 100
PROFILE_STEPS = 40


class FirstSteps:
    """The first ``n`` batches of a host pipe's epoch, for the Coach: the
    pipe seeded and its first batch drawn ahead, so a window timed from the
    first step leaves out building the epoch's rows."""

    def __init__(self, pipe, n: int, seed: int, epoch: int):
        self.it = iter(pipe.set_seed(seed).set_epoch(epoch))
        self.first, self.n = next(self.it), n

    def set_seed(self, seed: int) -> "FirstSteps":
        return self

    def set_epoch(self, epoch: int) -> "FirstSteps":
        return self

    def __iter__(self):
        yield self.first
        yield from itertools.islice(self.it, self.n - 1)


def time_training(run_dir: str, phase: str, beside: dict = None, timings: bool = True) -> dict:
    """Per-step and per-epoch times of the trained run's configuration on
    the card: the host pipe alone for one epoch (or, for a device sampler,
    drawing the epoch's batches on the card, synchronised), each of that
    epoch's first STAGED_STEPS steps alone on batches already on the card
    (synchronised), one whole epoch as the Coach runs it, and the first
    PROFILE_STEPS steps of one more epoch as the Coach runs them (batches
    made inside the window; the host pipe's first batch and a device
    sampler's permutation, the epoch's set-up, made ahead of it) under
    torch.profiler for the device time by kernel and the device's idle
    share. Without ``timings`` no step or epoch is timed: the pipe's epoch
    and three steps of warm-up, then the profile. Returns the headline
    numbers; ``beside`` (another run's) is printed next to them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from recboard_tpu_torch import run, serve
    from recboard_tpu_torch.data.pipes import Size
    from recboard_tpu_torch.launcher import Coach

    cfg = serve.load_run_config(run_dir)
    device = torch.device(CARD)
    dataset = run.load_dataset(cfg)
    model = run.build_model(cfg.model, dataset, cfg, device)
    trainpipe, validpipe, testpipe = run.build_pipes(model, cfg, device)
    coach = Coach(dataset, trainpipe, validpipe, testpipe, model, cfg, device)

    trainpipe.set_seed(int(cfg.seed)).set_epoch(0)
    on_device = getattr(trainpipe, "is_device_sampler", False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if on_device:
        perm = trainpipe.prepare()
        staged = [trainpipe.sample_prepared(perm, step)
                  for step in range(trainpipe.steps_per_epoch)]
        torch.cuda.synchronize()
        examples = trainpipe.steps_per_epoch * trainpipe.batch_size
    else:
        batches = list(trainpipe)
        examples = sum(int(b[Size]) for b in batches)
    pipe_s = time.perf_counter() - t0
    steps = trainpipe.steps_per_epoch if on_device else len(batches)
    staged = staged[:STAGED_STEPS] if on_device else [
        coach.to_device(b) for b in batches[:STAGED_STEPS]]
    for batch in staged[:3]:
        coach.train_step(batch)
    out = dict(device_draw_s=pipe_s) if on_device else dict(host_pipe_s=pipe_s)
    epoch_s = None
    if timings:
        step_ms = []
        for batch in staged:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            coach.train_step(batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coach.train(1)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        out["examples_per_s"] = examples / epoch_s
        emit(f"{phase}_time", model=cfg.model, steps=steps, examples=examples,
             timed_steps=len(staged), step_p50_ms=float(np.percentile(step_ms, 50)),
             step_p95_ms=float(np.percentile(step_ms, 95)),
             timed_steps_s=sum(step_ms) / 1e3, epoch_s=epoch_s, **out,
             **({"beside": beside} if beside else {}))

    window = min(steps, PROFILE_STEPS)
    if on_device:  # the epoch's permutation made ahead, as FirstSteps draws ahead
        perm = trainpipe.set_seed(int(cfg.seed)).set_epoch(2).prepare()
        trainpipe.prepare = lambda: perm
        trainpipe.steps_per_epoch = window
    else:
        coach.trainpipe = FirstSteps(trainpipe, window, int(cfg.seed), 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        coach.train(2)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    totals = profile_totals(prof)
    kernels = profiled_ops(totals, window, device=True)
    host = profiled_ops(totals, window, device=False)
    parse_s = time.perf_counter() - t0
    device_us = sum(us for _, us, _ in kernels)
    out.update(idle_share=1.0 - device_us * window / (1e6 * profiled_s),
               host_us_per_step=sum(us for _, us, _ in host))
    emit(f"{phase}_profile", device_us_per_step=device_us,
         launches_per_step=sum(n for _, _, n in kernels), profiled_steps=window,
         profiled_s=profiled_s, unprofiled_epoch_s=epoch_s,
         idle_share=out["idle_share"],
         kernels=[dict(name=name[:90], us_per_step=us, per_step=n)
                  for name, us, n in kernels[:15]],
         host_us_per_step=out["host_us_per_step"],
         host_ops=[dict(name=name[:60], self_us_per_step=us, per_step=n)
                   for name, us, n in host[:12]], profiler_parse_s=parse_s,
         **({"beside": beside} if beside else {}))
    return out


def store_dataset() -> tuple:
    """The toy store's dataset, SynBeauty_000_LOU, rebuilt under WORK from
    its meta.json build_command (tools/seed_sweep.py's defaults for the
    flags it omits): (root, name)."""
    from recboard_tpu_torch.data import synthetic

    from recboard_tpu_torch.data.datasets import NextItemRecDataSet

    data_root = os.path.join(WORK, "store_data")
    data = dict(STORE_DATASET)
    name = data.pop("name")
    synthetic.make_synthetic_dataset(data_root, name, **data)
    # UniSRec's --tfile, as tools/seed_sweep.py writes it beside the data
    synthetic.write_item_features(NextItemRecDataSet(data_root, name))
    return data_root, name


@contextlib.contextmanager
def plain_hstu_ops():
    """HSTU's per-position loss and relative bias through the plain versions
    of K4 and K6 on whatever device their tensors lie: the yardstick that
    training through the kernels is held against."""
    from recboard_tpu_torch.models.zoo import hstu as H
    from recboard_tpu_torch.ops import losses as S
    from recboard_tpu_torch.ops import rel_bias as R

    saved = S.sampled_softmax_loss, H.stacked_rel_bias
    S.sampled_softmax_loss = S.sampled_softmax_loss_reference
    H.stacked_rel_bias = R.stacked_rel_bias_reference
    try:
        yield
    finally:
        S.sampled_softmax_loss, H.stacked_rel_bias = saved


def store_run(name: str, data_root: str, store_name: str, seed: int, flags: dict) -> tuple:
    """One seed of the toy store's protocol for the slice ``name``: (best
    NDCG@10, seconds). Float32 throughout, as ``main`` sets it."""
    import torch

    from recboard_tpu_torch import run

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = SLICES[name]
    t0 = time.perf_counter()
    # a checkpoint tree per slice and seed: runs of one model in other
    # slices may run beside this one
    ckpt = os.path.join(WORK, "infos", f"{spec['tag']}{store_name}-s{seed}")
    best = run.main(train_argv(spec.get("model", name), data_root, store_name, seed,
                               id=f"{spec['tag']}seed{seed}", checkpoint_path=ckpt,
                               **spec["protocol"], **flags))
    return best["NDCG@10"], time.perf_counter() - t0


def one_thread() -> None:
    import torch

    torch.set_num_threads(1)


def store_runs(names, seeds, concurrent: bool = False, **flags) -> dict:
    """The toy store's protocol for each slice of ``names`` (tools/seed_sweep.py's
    arguments for the model, and ``flags``) for each of ``seeds``, one after
    another or (``concurrent``) in up to STORE_PROCESSES processes side by
    side, each taking the next seed in the order of ``names`` when it is
    done (the protocol's steps are host-bound, so the card runs them side
    by side): {name: (best NDCG@10s, seconds)}."""
    import multiprocessing

    import torch

    data_root, store_name = store_dataset()
    jobs = [(name, data_root, store_name, seed, flags) for name in names for seed in seeds]
    if concurrent:
        torch.cuda.empty_cache()  # the card's memory for the processes' contexts
        # the processes share the host's cores: one intra-op thread each
        with multiprocessing.get_context("spawn").Pool(min(len(jobs), STORE_PROCESSES),
                                                       one_thread) as pool:
            results = pool.starmap(store_run, jobs, chunksize=1)
    else:
        results = [store_run(*job) for job in jobs]
    out = {}
    for (name, _, _, seed, _), (value, seconds) in zip(jobs, results):
        spec = SLICES[name]
        emit(f"{spec['tag']}quality_seed", model=spec.get("model", name), seed=seed,
             ndcg10=value, seconds=seconds, **flags)
        values, times = out.setdefault(name, ([], []))
        values.append(value)
        times.append(seconds)
    return out


def quality(seeds: int, *names: str) -> dict:
    """The toy store's protocol for each slice of ``names`` on the card for
    ``seeds`` seeds, up to STORE_PROCESSES seeds at once; each mean best
    NDCG@10 must lie in its store's band."""
    t0 = time.perf_counter()
    runs = store_runs(names, range(seeds), concurrent=True)
    out, outside = {}, []
    for name, (values, seconds) in runs.items():
        spec = SLICES[name]
        mean = float(np.mean(values))
        emit(f"{spec['tag']}quality", model=spec.get("model", name),
             dataset=STORE_DATASET["name"], seeds=seeds, ndcg10=values, mean=mean,
             std=float(np.std(values)), store_mean=spec["store"], band=STORE_BAND,
             protocol=spec["protocol"], seconds=sum(seconds),
             processes=min(len(names) * seeds, STORE_PROCESSES), wall_s=time.perf_counter() - t0)
        if not abs(mean - spec["store"]) <= STORE_BAND:
            outside.append(f"{name}: mean NDCG@10 {mean} outside {spec['store']} ± {STORE_BAND}")
        out[name] = dict(mean=mean, values=values)
    if outside:
        raise SystemExit("quality: " + "; ".join(outside))
    return out


def store_study(first: int, seeds: int, device: str, plain: bool) -> None:
    """The toy store's per-position HSTU protocol for seeds first ..
    first + seeds - 1 on ``device``, through the kernels or (``plain``)
    through K4's and K6's plain versions: each seed's best NDCG@10, then
    their mean, standard deviation and the mean's standard error."""
    with plain_hstu_ops() if plain else contextlib.nullcontext():
        values, seconds = store_runs(("HSTU_pp",), range(first, first + seeds),
                                     device=device)["HSTU_pp"]
    std = float(np.std(values, ddof=1)) if len(values) > 1 else 0.0
    emit("hstu_pp_quality_study", device=device, plain=plain, seeds=[first, first + seeds - 1],
         ndcg10=values, mean=float(np.mean(values)), std=std,
         sem=std / math.sqrt(len(values)), store_mean=HSTU_PP_STORE_NDCG10,
         seconds=sum(seconds))


def check_hstu_pp_grads(seed: int, device: str = "cuda") -> dict:
    """One per-position HSTU step on the first batch of the toy store's
    protocol (maxlen 20, 2 blocks, batch 128 and the model's defaults: 300
    items, 1 + 512 candidates per position, so ids repeat many times in
    every row, tau 0.05), through the kernels and through their plain
    versions (plain_hstu_ops), on the same weights, batch and negatives:
    the losses within SS_TOL relative, every parameter's gradient within
    GRAD_TOL of its largest |plain| value."""
    import torch

    from recboard_tpu_torch import run
    from recboard_tpu_torch.data.datasets import NextItemRecDataSet
    from recboard_tpu_torch.data.pipes import Size

    protocol = SLICES["HSTU_pp"]["protocol"]
    data_root, store_name = store_dataset()
    dataset = NextItemRecDataSet(data_root, store_name)
    model = run.build_model("HSTU", dataset, dict(protocol, seed=seed), torch.device(device))
    pipe = model.sure_trainpipe(protocol["maxlen"], protocol["batch_size"])
    data = next(iter(pipe.set_seed(seed).set_epoch(0)))
    batch = {f: torch.from_numpy(v).to(device) for f, v in data.items()
             if isinstance(v, np.ndarray) and f != Size}
    names, params = zip(*model.named_parameters())

    def step():
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        loss, _ = model.fit(batch, gen)
        return loss.detach(), torch.autograd.grad(loss, params)

    loss, grads = step()
    with plain_hstu_ops():
        want_loss, want = step()
    errs = {n: grad_rel_err([a], [b]) for n, a, b in zip(names, grads, want)}
    worst = max(errs, key=errs.get)
    loss_err = abs(float(loss) - float(want_loss)) / max(1.0, abs(float(want_loss)))
    weights = batch[model.ISeq] != model.PADDING_VALUE
    row = dict(M=int(weights.numel()), weighted_rows=int(weights.sum()), C=1 + model.num_negs,
               N=model.Item.count, tau=model.temperature, loss=float(loss),
               loss_rel_err=loss_err, tol=SS_TOL, worst_param=worst, grad_rel_err=errs[worst],
               grad_rel_tol=GRAD_TOL)
    emit("hstu_pp_grads", **row)
    if not loss_err <= SS_TOL or not errs[worst] <= GRAD_TOL:
        raise SystemExit(f"HSTU per-position step: kernels against plain versions {row}")
    return row


# the device-sampled slices; their samplers' checks; the slice resumed
ODS_SLICES = ("SASRec_ods", "BERT4Rec_ods", "HSTU_pp_ods", "BSARec_ods", "FMLP-Rec_ods",
              "GRU4Rec_ods")
SAMPLER_SLICES = ODS_SLICES + ("FPMC",)
RESUME_SLICE = "HSTU_pp_ods"
CARD = "cuda"  # the device the checks below hold against the CPU
POOL_TOL = 1e-4  # |card - CPU| of a pool-ranking metric (a rank flip moves 1 / rows)


def reference_cfg(name: str, seed: int, **extra):
    """The slice ``name``'s run config as ``run`` compiles it (its reference
    config and flags, ``extra`` on top), logs and checkpoints under WORK."""
    from recboard_tpu_torch.parser import Parser

    spec = SLICES[name]
    model = spec.get("model", name)
    argv = train_argv(model, os.path.join(WORK, "data"), DATASET["name"], seed,
                      config=spec["config"], **spec.get("flags", {}), **extra)
    return Parser().compile(argv + ["--description", model])


def expected_windows(seqs, width: int, offset: int = 1) -> np.ndarray:
    """(users, width): each user's last ``width`` values + offset,
    right-aligned, 0 elsewhere (numpy, from the dataset's sequences)."""
    out = np.zeros((len(seqs), width), dtype=np.int64)
    for u, s in enumerate(seqs):
        tail = np.asarray(list(s)[-width:], dtype=np.int64)
        if tail.size:
            out[u, width - tail.size:] = tail + offset
    return out


def expected_roll_rows(seqs, maxlen: int, num_pads: int, right_padded: bool = False
                       ) -> np.ndarray:
    """(windows, 2 + maxlen) rows (user, target, input) of every (user, end)
    window of the roll protocol, from the dataset's sequences in numpy: the
    up to maxlen - 1 items before the target, offset and left-padded with 0
    (BSARec's), or (``right_padded``) the up to maxlen items before it,
    offset and right-padded (GRU4Rec's); a user with one item keeps one
    window of pads."""
    rows = []
    for u, seq in enumerate(seqs):
        ends = range(2, len(seq) + 1) if len(seq) >= 2 else range(len(seq), len(seq) + 1)
        for end in ends if seq else ():
            row = np.zeros(2 + maxlen, dtype=np.int64)
            first = max(0, end - 1 - maxlen) if right_padded else max(0, end - maxlen)
            items = np.asarray(seq[first:end - 1], dtype=np.int64)
            row[0], row[1] = u, seq[end - 1]
            if items.size and right_padded:
                row[2:2 + items.size] = items + num_pads
            elif items.size:
                row[2 + maxlen - items.size:] = items + num_pads
            rows.append(row)
    return np.stack(rows)


def rows_within(got: np.ndarray, want: np.ndarray) -> bool:
    """Whether the rows of ``got`` are a sub-multiset of those of ``want``
    (every window drawn at most once)."""
    import collections

    have = collections.Counter(map(bytes, np.ascontiguousarray(want, dtype=np.int64)))
    have.subtract(map(bytes, np.ascontiguousarray(got, dtype=np.int64)))
    return min(have.values(), default=0) >= 0


def check_device_samplers(seed: int, dataset) -> list:
    """Each device sampler of SAMPLER_SLICES (the ``_ods`` slices' and
    FPMC's, whose NUM_PADS is 0) at the SynBeautyXL shape on the card:
    one epoch drawn under ``torch.cuda.set_sync_debug_mode ("error")``;
    every row's window the user's train tail (inputs offset,
    targets shifted by one; HSTU's times rebased and 0 exactly at pads;
    BERT4Rec's last maxlen items), or for the roll-window sampler one of
    the dataset's (user, end) windows with its target, none drawn twice;
    negatives in [0, N) with their collision share against the window (the
    whole history for roll) after the retry, beside seen²/N²;
    the same bits for the same (seed, epoch, step), another user order in
    another epoch; the card's permutation and raw draws through the CPU
    sampler's gathers give the same fields int for int. Also printed: the
    synchronising calls of one whole device-sampled training step,
    counted under ``"warn"`` (a number, not a gate)."""
    import warnings

    import torch

    from recboard_tpu_torch import run
    from recboard_tpu_torch.launcher import Coach

    cuda = torch.device(CARD)
    seqs = dataset.train().user_seqs()
    times = dataset.train().user_time_seqs()
    t0 = min(t[0] for t in times if t)
    N = dataset.fields["ITEM", "ID"].count
    rows = []
    for name in SAMPLER_SLICES:
        spec = SLICES[name]
        model, L, B = spec.get("model", name), spec["widths"]["maxlen"], spec["batch"]
        cfg = reference_cfg(name, seed)
        net = run.build_model(model, dataset, cfg, cuda)
        card = run.device_sampler(net, L, B, cuda).set_seed(seed)
        host = run.device_sampler(net, L, B, "cpu").set_seed(seed)
        roll = hasattr(card, "_pairs")
        steps = card.steps_per_epoch
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            card.set_epoch(0).sample(0)
            perm = card.prepare()
            draws = [card.draws(step) for step in range(steps)]
            batches = [card.sample_prepared(perm, step, d) for step, d in enumerate(draws)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t_start

        same_bits = all(
            torch.equal(a, b) for step in {0, steps // 2, steps - 1}
            for a, b in zip(card.sample(step).values(), batches[step].values()))
        other_order = not torch.equal(card.set_epoch(1).prepare(), perm)
        card.set_epoch(0)
        host.set_epoch(0)
        cpu = [{f: v.cpu() for f, v in b.items()} for b in batches]
        cpu_equal = all(
            all(torch.equal(v, cpu[step][f]) for f, v in host.sample_prepared(
                perm.cpu(), step, {k: d.cpu() for k, d in draws[step].items()}).items())
            for step in range(steps))
        users = torch.cat([b[card.User] for b in cpu]).numpy()
        iseq = torch.cat([b[card.ISeq] for b in cpu]).numpy()
        row = dict(sampler=type(card).__name__, slice=name, steps=steps, batch=B, maxlen=L,
                   distinct_users=int(np.unique(users).size), draw_s=draw_s,
                   sync_debug_mode="error", same_bits=same_bits, other_epoch_order=other_order,
                   cpu_gathers_equal=cpu_equal)
        ok = same_bits and other_order and cpu_equal
        if roll:
            # every row one of the dataset's (user, end) windows, none twice
            ipos = torch.cat([b[card.IPos] for b in cpu]).numpy()
            want = expected_roll_rows(seqs, L, net.NUM_PADS,
                                      right_padded=card.pad_side == "right")
            row.update(windows=card.num_windows, expected_windows=len(want),
                       pad_side=card.pad_side, num_pads=net.NUM_PADS)
            ok &= card.num_windows == len(want) and steps == max(1, len(want) // B)
            ok &= rows_within(np.concatenate([users[:, None], ipos, iseq], 1), want)
        else:
            row["valid_users"] = int(card._valid_users.shape[0])
            ok &= row["distinct_users"] == min(steps * B, row["valid_users"])
        if model == "BERT4Rec":
            want = expected_windows(seqs, L)
            ok &= bool(np.array_equal(iseq, np.where(want != 0, want - 1 + net.NUM_PADS,
                                                     0)[users]))
        elif not roll:
            window = expected_windows([s if len(s[-(L + 1):]) >= 2 else () for s in seqs],
                                      L + 1)
            want_in = np.where(window[:, :-1] != 0, window[:, :-1] - 1 + net.NUM_PADS, 0)
            want_pos = np.where(window[:, 1:] != 0, window[:, 1:] - 1, 0)
            ipos = torch.cat([b[card.IPos] for b in cpu]).numpy()
            ok &= bool(np.array_equal(iseq, want_in[users]))
            ok &= bool(np.array_equal(ipos, want_pos[users]))
        if model == "HSTU":
            ts = torch.cat([b[card.Time] for b in cpu]).numpy()
            t_win = expected_windows([t if len(t[-(L + 1):]) >= 2 else () for t in times],
                                     L + 1, offset=-t0)
            ok &= bool(np.array_equal(ts, np.where(window[:, :-1] != 0, t_win[:, :-1],
                                                   0)[users]))
            ok &= not ts[iseq == 0].any()
            row["zero_times_at_items"] = int(((ts == 0) & (iseq != 0)).sum())
        if card.INeg in batches[0]:
            negs = torch.cat([b[card.INeg] for b in cpu]).numpy()
            # (rows, L + 1) raw + 1: SASRec's window; the whole history for roll
            packed = card._packed.cpu().numpy()[users]
            ok &= bool(negs.min() >= 0 and negs.max() < N)
            row["collision_share"] = float((negs[..., None] + 1 == packed[:, None, :])
                                           .any(-1).mean())
            seen = np.asarray([np.unique(r[r != 0]).size for r in packed])
            row["seen2_over_N2"] = float(np.mean((seen / N) ** 2))

        coach = Coach(dataset, card, None, None, net, cfg, cuda)
        coach.train_step(batches[0])
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                coach.train_step(card.sample(1))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        row["syncs_per_train_step"] = sum("synchroniz" in str(w.message) for w in caught)
        row["ok"] = bool(ok)
        emit("device_samplers", **row)
        rows.append(row)
        if not ok:
            raise SystemExit(f"{row['sampler']} on the card: {row}")
    return rows


def resume_check(seed: int, dataset) -> dict:
    """Resume at the slice RESUME_SLICE on the card: the checkpoint written
    after epoch 0 loads back bit for bit into a fresh Coach (parameters,
    optimizer state on the model's device, generator state, history and
    best); then ``run`` for 2 epochs straight twice with the same seed, and
    once as 1 epoch plus ``--resume``: the resumed run's epoch-1 loss and
    NDCG@10 lie within twice the straight runs' own difference, plus 1e-6,
    of the first straight run's (PyTorch's embedding backward is not
    deterministic on CUDA, so bits are asked only on the CPU)."""
    import copy

    import torch

    from recboard_tpu_torch import run
    from recboard_tpu_torch.launcher import Coach

    spec = SLICES[RESUME_SLICE]
    model, cuda = spec["model"], torch.device(CARD)
    cfg = reference_cfg(RESUME_SLICE, seed, epochs=2,
                        checkpoint_path=os.path.join(WORK, "infos", "resume_roundtrip"))

    def coach_for(model_seed):
        net = run.build_model(model, dataset, dict(cfg, seed=model_seed), cuda)
        return Coach(dataset, *run.build_pipes(net, cfg, cuda), net, cfg, cuda)

    coach = coach_for(seed)
    coach.train(0)
    coach.evaluate(0, mode="valid")
    coach._check_best(coach._flush("valid", 0), 0)
    coach.save_checkpoint(0)
    want = (copy.deepcopy(coach.model.state_dict()), copy.deepcopy(coach.optimizer.state_dict()),
            coach.generator.get_state(), copy.deepcopy(coach.history),
            (coach._best, coach._best_epoch, coach._stopping_steps))
    coach._join_checkpoint_writer()
    fresh = coach_for(seed + 1)
    epoch = fresh.load_checkpoint()
    got_opt = fresh.optimizer.state_dict()
    moments = [v for state in got_opt["state"].values() for k, v in state.items() if k != "step"]
    reload = dict(
        epoch=epoch,
        params=all(torch.equal(v, want[0][k]) for k, v in fresh.model.state_dict().items()),
        optimizer=got_opt["param_groups"] == want[1]["param_groups"] and all(
            torch.equal(v, want[1]["state"][i][k]) for i, state in got_opt["state"].items()
            for k, v in state.items()),
        moments_on_card=bool(moments) and all(
            v.device == next(fresh.model.parameters()).device for v in moments),
        generator=torch.equal(fresh.generator.get_state(), want[2]),
        history=fresh.history == want[3],
        best=(fresh._best, fresh._best_epoch, fresh._stopping_steps) == want[4])

    def trained(run_id: str, epochs: int, ckpt: str, *more) -> tuple:
        """(the last epoch's loss, epoch 1's NDCG@10 or None) of a run to ``epochs``."""
        log_path = os.path.join(WORK, "resume_logs")
        run.main(train_argv(model, os.path.join(WORK, "data"), DATASET["name"], seed,
                            config=spec["config"], epochs=epochs, eval_freq=1,
                            log_path=log_path, id=run_id,
                            checkpoint_path=os.path.join(WORK, "infos", ckpt),
                            **spec["flags"]) + list(more))
        with open(os.path.join(log_path, model, DATASET["name"], run_id, "monitors.pkl"),
                  "rb") as fh:
            history = pickle.load(fh)
        ndcg = [r["NDCG@10"] for r in history["valid"] if r["epoch"] == 1]
        return history["train"][-1]["LOSS"], ndcg[0] if ndcg else None

    straight = [trained(f"straight{i}", 2, f"resume_straight{i}") for i in (0, 1)]
    trained("first", 1, "resume_pair")
    resumed = trained("resumed", 2, "resume_pair", "--resume")
    spread = [abs(a - b) for a, b in zip(*straight)]
    drift = [abs(a - b) for a, b in zip(resumed, straight[0])]
    row = dict(slice=RESUME_SLICE, reload=reload, straight=straight, resumed=resumed,
               straight_spread=spread, resumed_drift=drift,
               within=[d <= 2 * sp + 1e-6 for d, sp in zip(drift, spread)])
    emit("resume_check", **row)
    if not (all(v for k, v in reload.items() if k != "epoch") and epoch == 0
            and all(row["within"])):
        raise SystemExit(f"resume on the card: {row}")
    return row


def pool_check(dataset, trained: dict) -> list:
    """Each trained ``_ods`` run evaluated with ``ranking: pool`` (the valid
    split, 1 + 100 candidates a row) from its best checkpoint, on the card
    and on the CPU: every metric within POOL_TOL, and the card's kernels
    launched as ``expected_launches`` says (K1 once per block and batch for
    SASRec and BERT4Rec, nothing for HSTU)."""
    import torch

    from recboard_tpu_torch import run, serve
    from recboard_tpu_torch.launcher import Coach

    rows = []
    for name, out in trained.items():
        cfg = serve.load_run_config(out["run_dir"])
        cfg.ranking = "pool"
        spec = SLICES[name]
        results = []
        for device in (torch.device(CARD), torch.device("cpu")):
            net = run.build_model(cfg.model, dataset, cfg, device)
            pipe = net.sure_validpipe(int(cfg.maxlen), ranking="pool")
            coach = Coach(dataset, None, pipe, None, net, cfg, device)
            coach.load_best()
            for fn in counted_kernels():
                fn.launches = 0
            t0 = time.perf_counter()
            coach.evaluate(0, mode="valid")
            results.append((coach._flush("valid", 0), time.perf_counter() - t0,
                            {fn.__name__: fn.launches for fn in counted_kernels()}))
        batches = len(coach._eval_cache["valid"])
        (card, card_s, launches), (cpu, cpu_s, cpu_launches) = results
        want = expected_launches(cfg.model, spec["widths"].get("num_blocks", 0), 0, batches)
        err = max(abs(card[k] - v) for k, v in cpu.items())
        row = dict(slice=name, batches=batches, metrics=card, cpu_metrics=cpu,
                   max_abs_diff=err, tol=POOL_TOL, launches=launches, expected_launches=want,
                   card_s=card_s, cpu_s=cpu_s)
        emit("pool_check", **row)
        if (card.keys() != cpu.keys() or not err <= POOL_TOL or launches != want
                or any(cpu_launches.values())):
            raise SystemExit(f"{name} pool ranking: {row}")
        rows.append(row)
    return rows


def kernel_entry(name: str, source: str, replaces: str, launches: int, err: float,
                 row: dict, prefix: str = "") -> dict:
    """One entry of the ``{"kernels": [...]}`` line from a timed row."""
    return {
        "name": name, "route": "cuda", "source": f"recboard_tpu_torch/ops/csrc/{source}",
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": row[f"{prefix}ms"], "plain_ms": row[f"plain_{prefix}ms"],
        "bound_ms": row[f"{prefix}bound_ms"], "bound_by": row[f"{prefix}bound_by"],
        "library_ms": row[f"library_{prefix}ms"],
    }


def row_mask_entries(rows: list, drop_rows: list, trained: dict) -> list:
    """The ``{"kernels": [...]}`` entries of K1 and K2 with the per-row -1e4
    mask at BSARec's and UniSRec's shapes (device clock), launches from
    those models' training runs (K1 in their evaluation)."""
    serving = {r["shape"]: r for r in rows}
    training = {r["shape"]: r for r in drop_rows}
    out = []
    for model, tag in (("BSARec", "bsarec"), ("UniSRec", "unisrec")):
        k1 = serving[f"{tag}_serving"]
        k2 = training[f"{tag}_train"]
        launches = trained[model]["launches"]
        k1 = dict(k1, ms=k1["graph_ms"], library_ms=k1["library_graph_ms"])
        k2 = dict(k2, fwd_ms=k2["fwd_graph_ms"], library_fwd_ms=k2["library_fwd_graph_ms"],
                  bwd_ms=k2["bwd_graph_ms"])
        out += [
            dict(kernel_entry(f"mha_fwd@{tag}_serving", "mha_fwd.cu",
                              "recboard_tpu/ops/attention.py:143", launches["mha_fwd"],
                              k1["max_abs_err"], k1), masked_row_err=k1["masked_row_err"]),
            dict(kernel_entry(f"mha_dropout_fwd@{tag}_train", "mha_dropout.cu",
                              "recboard_tpu/ops/attention.py:316", launches["mha_dropout_fwd"],
                              k2["max_abs_err"], k2, "fwd_"),
                 masked_row_err=k2["masked_row_err"]),
            dict(kernel_entry(f"mha_dropout_bwd@{tag}_train", "mha_dropout.cu",
                              "recboard_tpu/ops/attention.py:354", launches["mha_dropout_bwd"],
                              k2["grad_max_abs_err"], k2, "bwd_"),
                 grad_rel_err_with_masked_rows=k2["grad_rel_err_with_masked_rows"]),
        ]
    return out


# the kernels_* phases: name -> (check, offset of its seed from --seed)
KERNEL_PHASES = {
    "mha_fwd": (check_attention, 0),
    "mha_dropout": (check_dropout_attention, 1),
    "vocab_ce": (check_vocab_ce, 2),
    "sampled_softmax": (check_sampled_softmax, 3),
    "rel_bias": (check_rel_bias, 4),
    "sampled_softmax_cand": (check_sampled_softmax_cand, 5),
    "dropout": (check_dropout_mask, 6),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and kernel inputs")
    ap.add_argument("--store-seeds", type=int, default=0,
                    help="run only the toy store's per-position HSTU protocol for this "
                         "many seeds from --seed, and print each seed's best NDCG@10")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="with --store-seeds: the device to train on")
    ap.add_argument("--plain", action="store_true",
                    help="with --store-seeds: K4's loss and K6's backward through their "
                         "plain versions")
    ap.add_argument("--kernels", default="",
                    help="run only the build and these kernels_* phases, comma-separated "
                         f"from {','.join(KERNEL_PHASES)}; no kernels or ok line")
    args = ap.parse_args(argv)
    only = [k for k in args.kernels.split(",") if k]
    if any(k not in KERNEL_PHASES for k in only):
        ap.error(f"--kernels takes names from {','.join(KERNEL_PHASES)}, got {args.kernels}")

    import torch

    if args.store_seeds and args.device == "cpu":
        store_study(args.seed, args.store_seeds, "cpu", args.plain)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # float32 everywhere: the plain versions are the references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from recboard_tpu_torch.ops import _build

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    if args.store_seeds:
        store_study(args.seed, args.store_seeds, "cuda", args.plain)
        return 0

    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        emit("phase_seconds", name=name, seconds=phase_s[name])
        return out

    logs = timed("build", _build.build)
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    emit("build", sources=list(_build.SOURCES), seconds=phase_s["build"], ptxas=ptxas)

    checked = {name: timed(f"kernels_{name}", check, np.random.default_rng(args.seed + k))
               for name, (check, k) in KERNEL_PHASES.items() if not only or name in only}
    if only:
        emit("phase_seconds", name="total", seconds=sum(phase_s.values()))
        print(smi)
        return 0
    rows, worst = checked["mha_fwd"]
    drop_rows, drop_worst = checked["mha_dropout"]
    ce_rows, ce_worst = checked["vocab_ce"]
    ss_rows, ss_worst = checked["sampled_softmax"]
    rb_rows, rb_worst = checked["rel_bias"]
    ssc_rows, ssc_worst = checked["sampled_softmax_cand"]
    mask_rows, mask_launches = checked["dropout"]
    dataset = timed("dataset", make_dataset)
    slice_ = timed("slice", serve_slice, args.seed, dataset, "SASRec")
    timed("profile", profile_bench, slice_["run_dir"], slice_["bench"]["p50"], "profile")
    trained = timed("train", train_slice, args.seed, dataset, "SASRec")
    host_times = {"SASRec": timed("train_time", time_training, trained["run_dir"], "train")}
    b_slice = timed("bert4rec_slice", serve_slice, args.seed, dataset, "BERT4Rec")
    timed("bert4rec_profile", profile_bench, b_slice["run_dir"], b_slice["bench"]["p50"],
          "bert4rec_profile")
    b_trained = timed("bert4rec_train", train_slice, args.seed, dataset, "BERT4Rec")
    host_times["BERT4Rec"] = timed("bert4rec_train_time", time_training, b_trained["run_dir"],
                                   "bert4rec_train")
    h_trained = timed("hstu_train", train_slice, args.seed, dataset, "HSTU")
    timed("hstu_profile", profile_bench, h_trained["run_dir"], h_trained["bench"]["p50"],
          "hstu_profile")
    timed("hstu_train_time", time_training, h_trained["run_dir"], "hstu_train")
    p_trained = timed("hstu_pp_train", train_slice, args.seed, dataset, "HSTU_pp")
    timed("hstu_pp_profile", profile_bench, p_trained["run_dir"], p_trained["bench"]["p50"],
          "hstu_pp_profile")
    host_times["HSTU_pp"] = timed("hstu_pp_train_time", time_training, p_trained["run_dir"],
                                  "hstu_pp_train")
    timed("hstu_pp_grads", check_hstu_pp_grads, args.seed)
    roll_trained = {}
    for name in ROLL_SLICES:
        tag = SLICES[name]["tag"]
        roll_trained[name] = timed(f"{tag}train", train_slice, args.seed, dataset, name)
        host_times[name] = timed(f"{tag}train_time", time_training,
                                 roll_trained[name]["run_dir"], f"{tag}train", None,
                                 SLICES[name].get("timings", True))
    timed("device_samplers", check_device_samplers, args.seed, dataset)
    ods = {}
    for name in ODS_SLICES:
        tag, host = SLICES[name]["tag"], SLICES[name]["host"]
        ods[name] = timed(f"{tag}train", train_slice, args.seed, dataset, name)
        timed(f"{tag}train_time", time_training, ods[name]["run_dir"], f"{tag}train",
              dict(host_times[host], slice=host))
    timed("resume_check", resume_check, args.seed, dataset)
    timed("pool_check", pool_check, dataset, ods)
    # every model's band: 70 seeds, 40 processes at once, beside each other on the card
    timed("store_quality", quality, STORE_SEEDS, *STORE_BANDS)

    serving, training, ce = rows[0], drop_rows[0], ce_rows[0]
    # K1 and K2 run near or below their wrappers' host time: their entries,
    # and SDPA's beside them, take the device clock (CUDA graphs), as do
    # K4 (two kernels behind one wrapper call forward, four backward), K3
    # (its forward beside the library's from a graph too), K5 (three
    # kernels behind one wrapper call each way; its forward beside the
    # library's on the weighted rows from a graph too) and K6 (two
    # kernels, beside index_add_ from a graph too)
    serving = dict(serving, ms=serving["graph_ms"], library_ms=serving["library_graph_ms"])
    cand = dict(ssc_rows[0], fwd_ms=ssc_rows[0]["fwd_graph_ms"],
                bwd_ms=ssc_rows[0]["bwd_graph_ms"])
    shared = dict(ss_rows[0], fwd_ms=ss_rows[0]["fwd_graph_ms"],
                  library_fwd_ms=ss_rows[0]["library_fwd_on_rows_graph_ms"],
                  bwd_ms=ss_rows[0]["bwd_graph_ms"])
    rel_bias = dict(rb_rows[0], bwd_ms=rb_rows[0]["bwd_graph_ms"],
                    library_bwd_ms=rb_rows[0]["library_bwd_graph_ms"])
    ce = dict(ce, fwd_ms=ce["fwd_graph_ms"], library_fwd_ms=ce["library_fwd_graph_ms"],
              bwd_ms=ce["bwd_graph_ms"])
    training = dict(training, fwd_ms=training["fwd_graph_ms"],
                    library_fwd_ms=training["library_fwd_graph_ms"],
                    bwd_ms=training["bwd_graph_ms"])
    print(json.dumps({"kernels": [
        kernel_entry("mha_fwd", "mha_fwd.cu", "recboard_tpu/ops/attention.py:143",
                     slice_["launches"], worst, serving),
        kernel_entry("mha_dropout_fwd", "mha_dropout.cu", "recboard_tpu/ops/attention.py:316",
                     trained["launches"]["mha_dropout_fwd"], drop_worst["fwd"], training,
                     "fwd_"),
        kernel_entry("mha_dropout_bwd", "mha_dropout.cu", "recboard_tpu/ops/attention.py:354",
                     trained["launches"]["mha_dropout_bwd"], drop_worst["bwd"], training,
                     "bwd_"),
        kernel_entry("vocab_ce_fwd", "vocab_ce.cu", "recboard_tpu/ops/vocab_ce.py:48",
                     b_trained["launches"]["vocab_ce_fwd"], ce_worst["fwd"], ce, "fwd_"),
        kernel_entry("vocab_ce_bwd", "vocab_ce.cu", "recboard_tpu/ops/vocab_ce.py:64",
                     b_trained["launches"]["vocab_ce_bwd"], ce_worst["bwd"], ce, "bwd_"),
        kernel_entry("sampled_softmax_shared_fwd", "sampled_softmax.cu",
                     "recboard_tpu/ops/losses.py:239",
                     h_trained["launches"]["sampled_softmax_shared_fwd"], ss_worst["fwd"],
                     shared, "fwd_"),
        kernel_entry("sampled_softmax_shared_bwd", "sampled_softmax.cu",
                     "recboard_tpu/ops/losses.py:255",
                     h_trained["launches"]["sampled_softmax_shared_bwd"], ss_worst["bwd"],
                     shared, "bwd_"),
        kernel_entry("stacked_rel_bias_bwd", "rel_bias.cu", "recboard_tpu/ops/rel_bias.py:69",
                     h_trained["launches"]["stacked_rel_bias_bwd"], rb_worst, rel_bias,
                     "bwd_"),
        kernel_entry("sampled_softmax_cand_fwd", "sampled_softmax_cand.cu",
                     "recboard_tpu/ops/losses.py:170",
                     p_trained["launches"]["sampled_softmax_cand_fwd"], ssc_worst["fwd"],
                     cand, "fwd_"),
        kernel_entry("sampled_softmax_cand_bwd", "sampled_softmax_cand.cu",
                     "recboard_tpu/ops/losses.py:186",
                     p_trained["launches"]["sampled_softmax_cand_bwd"], ssc_worst["bwd"],
                     cand, "bwd_"),
        # launches from K7's own path, ops.dropout.dropout; the model paths,
        # each checked against expected_launches, launched it no time
        dict(kernel_entry("dropout_mask", "dropout.cu", "recboard_tpu/ops/dropout.py:37",
                          mask_launches, mask_rows[0]["max_abs_err"], mask_rows[0]),
             path="ops.dropout.dropout", model_path_launches=sum(
                 t["launches"]["dropout_mask"] for t in (trained, b_trained, h_trained,
                                                          p_trained, *ods.values(),
                                                          *roll_trained.values()))),
        *row_mask_entries(rows, drop_rows, roll_trained),
    ]}))
    emit("phase_seconds", name="total", seconds=sum(phase_s.values()))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
